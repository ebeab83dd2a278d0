"""Launchers of the port: the paged KV cache and the serving engine."""
