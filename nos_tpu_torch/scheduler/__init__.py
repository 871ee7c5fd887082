"""The scheduler framework the planner simulates placements with,
``nos_tpu/scheduler`` for the port."""
