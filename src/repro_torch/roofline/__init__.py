"""Roofline analysis of the port's traced steps: the counterpart of
``repro.roofline``.  The reference's ``collective_bytes(hlo_text)`` has
no counterpart (eager PyTorch has no HLO): collective bytes come from
:mod:`repro_torch.roofline.op_cost`, and :class:`CollectiveStats` from
its records."""
from .analysis import (
    HW,
    CollectiveStats,
    RooflineReport,
    active_params,
    model_flops,
    roofline,
)

__all__ = ["HW", "CollectiveStats", "RooflineReport", "active_params",
           "model_flops", "roofline"]
