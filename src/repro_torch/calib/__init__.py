"""Measured calibration of :class:`~repro_torch.core.hw.Target` constants.

The port's copy of ``repro.calib``: measure what the device does
(:mod:`repro_torch.calib.measure` — isolated GEMM / elementwise /
DMA-proxy microbenchmarks plus whole-block wall-clock), fit effective
per-level bandwidth / DMA setup and per-engine FLOP/s by non-negative
least squares over the shared roofline model
(:mod:`repro_torch.calib.fit`, numpy, the reference's arithmetic), and
emit a preset-shaped calibrated target —
``Target.calibrated(measurements, base=...)`` — with per-measurement
residuals and a drift gate (:func:`drift_gate`).

Typical use on the card::

    import torch
    from repro_torch.calib import microbench_sweep, measure_block, calibrate
    from repro_torch.core import hw

    ms = microbench_sweep(base=hw.H100, dtype=torch.bfloat16,
                          dma_sizes=(1 << 20, 8 << 20, 32 << 20,
                                     128 << 20, 256 << 20))
    result = calibrate(ms, base=hw.H100)
    print(result.summary())
    target = result.target          # plan with the calibrated machine
"""
from .fit import (CalibrationResult, Residual, calibrate, drift_gate,
                  nnls)
from .measure import (COMPUTE, TRANSFER, Measurement, SegmentFeatures,
                      features_from_chain, measure_block,
                      measure_dma_proxy, measure_elementwise,
                      measure_gemms, measurement_from_chain,
                      microbench_sweep, modeled_measurement_s,
                      wallclock_s)

__all__ = [
    "COMPUTE", "TRANSFER", "Measurement", "SegmentFeatures",
    "modeled_measurement_s", "features_from_chain",
    "measurement_from_chain", "wallclock_s",
    "measure_gemms", "measure_elementwise", "measure_dma_proxy",
    "microbench_sweep", "measure_block",
    "nnls", "Residual", "CalibrationResult", "calibrate", "drift_gate",
]
