"""The partitioning planner, ``nos_tpu/partitioning`` for the port: a
device-agnostic core (``core/``) and the MPS strategy (``timeshare/``).
The MIG strategy (``slicepart/``) is the next slice."""
