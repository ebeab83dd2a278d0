"""Models of the port: shared layers and the decoder-only assembly."""
