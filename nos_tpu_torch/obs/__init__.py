"""Decision-plane observability, ``nos_tpu/obs`` for the port: spans and
counters over the planner and actuator (``trace``), and the decision
journal (``journal``)."""
