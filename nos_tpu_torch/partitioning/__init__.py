"""The partitioning planner, ``nos_tpu/partitioning`` for the port: a
device-agnostic core (``core/``), the MPS strategy (``timeshare/``) and
the MIG strategy (``slicepart/``)."""
