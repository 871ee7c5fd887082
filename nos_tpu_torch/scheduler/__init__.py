"""The scheduler, ``nos_tpu/scheduler`` for the port: the framework the
planner simulates placements with, the single-pod scheduler over a
watch-driven cache, and the capacity plugin enforcing elastic quotas."""
