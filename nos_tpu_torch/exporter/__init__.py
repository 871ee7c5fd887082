"""In-process metrics the port's mains set."""
