"""Training steps and the resilient loop of the port."""
