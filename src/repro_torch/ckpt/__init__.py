"""Checkpointing of the port."""
from .manager import CheckpointManager, restore_tree, save_tree  # noqa: F401
