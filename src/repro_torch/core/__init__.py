"""Core of the port: the machine model (``hw``) and the FTL planner."""
from . import hw  # noqa: F401  (hw has no ftl dependency)
