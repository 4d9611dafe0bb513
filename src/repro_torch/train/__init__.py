"""Step functions of the port (the serving half so far)."""
