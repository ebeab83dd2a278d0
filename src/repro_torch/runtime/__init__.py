"""Training runtime of the port: the fault-tolerant loop and monitors."""
from .loop import LoopConfig, TrainLoop  # noqa: F401
