"""Building blocks shared by the port's architectures."""
