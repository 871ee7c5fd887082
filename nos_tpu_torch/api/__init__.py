"""Component configs the port's mains load."""
