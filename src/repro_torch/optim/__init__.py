"""Optimizers of the port."""
from .adamw import (OptConfig, adamw_update, global_norm,  # noqa: F401
                    init_opt_state, lr_schedule)
