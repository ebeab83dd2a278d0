"""Data pipelines of the port."""
from .pipeline import DataConfig, SyntheticLM  # noqa: F401
