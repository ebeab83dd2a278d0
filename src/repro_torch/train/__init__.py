"""Training and serving steps of the port, and the loss."""
