"""Serving steps of the port (the training half is not ported yet)."""
