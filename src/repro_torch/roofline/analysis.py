"""Three-term roofline of one traced step: the port's counterpart of
``repro.roofline.analysis``.

    compute term    = FLOPs_per_chip / peak_FLOP/s
    memory term     = bytes_per_chip / memory bandwidth
    collective term = collective_bytes_per_chip / link bandwidth

The per-chip FLOPs, bytes and collective bytes come from
:mod:`repro_torch.roofline.op_cost`, which prices rank 0's eager step op
by op (the reference prices its compiled HLO).  There is no HLO text to
read, so :class:`CollectiveStats` is built from the cost model's
collective records (:meth:`CollectiveStats.from_cost`) where the
reference parses the HLO.

The machine is a planning :class:`repro_torch.core.hw.Target`
(:meth:`HW.from_target`), so the roofline and the FTL planner price the
same card.

MODEL_FLOPS uses the classic 6·N·D training estimate (2·N·D forward
only), with N = *active* params for MoE, plus the temporal mixers' terms;
MODEL_FLOPS / traced FLOPs then exposes remat recompute and redundant
work in the traced step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

from repro_torch.core import hw as hw_targets

# ---------------------------------------------------------------------------
# hardware constants, from the same Target the FTL planner prices with
# ---------------------------------------------------------------------------

# presets whose roofline view is not the reference's rule (levels[1] as
# memory, the deepest level's link as the collective link): the H100's
# levels are smem, L2 and HBM, so the rule would make L2 the memory and
# HBM the link.  Its view takes the level named here and the card's
# NVLink rate (core/hw.py:H100_NVLINK_BPS).
_CARD_VIEWS = {"h100": ("hbm", hw_targets.H100_NVLINK_BPS)}


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 197e12          # FLOP/s per chip
    hbm_bw: float = 819e9               # bytes/s per chip
    ici_bw: float = 50e9                # bytes/s per link
    hbm_bytes: float = 16e9             # capacity per chip
    vmem_bytes: float = 96 * 2**20
    target_name: str = "tpu_v5e"

    @classmethod
    def from_target(cls, t: hw_targets.Target) -> "HW":
        """Roofline view of a planning Target.  The reference's rule: the
        first backing level plays the HBM role, the deepest level's link
        the collective role (remote HBM over ICI on tpu_v5e).  A target
        built on the ``h100`` preset (its name before any ``@``) takes its
        ``hbm`` level as the memory and NVLink as the link; its fast level
        (``smem``) is the fast level either way."""
        view = _CARD_VIEWS.get(t.name.split("@")[0])
        if view is not None:
            level, link_bw = view
            mem = next(lv for lv in t.levels if lv.name == level)
            return cls(peak_flops=t.flops, hbm_bw=mem.bw_bytes_per_s,
                       ici_bw=link_bw, hbm_bytes=float(mem.capacity_bytes),
                       vmem_bytes=float(t.fast.capacity_bytes),
                       target_name=t.name)
        backing = t.levels[1]
        deep = t.levels[-1]
        return cls(
            peak_flops=t.flops,
            hbm_bw=backing.bw_bytes_per_s,
            ici_bw=deep.bw_bytes_per_s if deep is not backing
            else backing.bw_bytes_per_s,
            hbm_bytes=float(backing.capacity_bytes),
            vmem_bytes=float(t.fast.capacity_bytes),
            target_name=t.name,
        )

    def compute_time_s(self, flops: float) -> float:
        """The compute-time formula the FTL planner prices with
        (``hw.compute_time``)."""
        return hw_targets.compute_time(flops, self.peak_flops)


DEFAULT_HW = HW.from_target(hw_targets.TPU_V5E)

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")


@dataclasses.dataclass
class CollectiveStats:
    total_bytes: int
    by_kind: dict[str, int]
    count: int

    @classmethod
    def from_cost(cls, cost: dict[str, Any]) -> "CollectiveStats":
        """From :func:`repro_torch.roofline.op_cost.analyze_step`'s
        ``collectives_by_kind`` and ``collective_count``."""
        by_kind = {k: int(cost["collectives_by_kind"].get(k, 0))
                   for k in COLLECTIVE_KINDS}
        return cls(sum(by_kind.values()), by_kind,
                   int(cost["collective_count"]))

    def summary(self) -> str:
        per = ", ".join(f"{k}={v/2**20:.1f}MiB"
                        for k, v in sorted(self.by_kind.items()) if v)
        return f"{self.total_bytes/2**20:.1f} MiB over {self.count} ops ({per})"


# ---------------------------------------------------------------------------
# MODEL_FLOPS
# ---------------------------------------------------------------------------

def active_params(cfg) -> int:
    """Parameter count weighted by activation fraction (MoE top-k/E)."""
    from repro_torch.distributed.sharding import map_with_path
    from repro_torch.models.model import count_params, param_shapes

    total = count_params(cfg)
    if not cfg.is_moe:
        return total
    # routed expert weight fraction
    routed = 0

    def one(names, leaf):
        nonlocal routed
        if "moe" in names and any(n in ("w1", "w2", "wg") for n in names):
            routed += math.prod(leaf.shape)

    map_with_path(one, param_shapes(cfg))
    frac = cfg.n_experts_per_token / max(1, cfg.n_experts)
    return total - routed + int(routed * frac)


def _mixer_flops_fwd(cfg, shape) -> int:
    """Forward FLOPs of the temporal mixers (not captured by 2·N·D):
    attention score/value matmuls (causal halved, local capped at the
    window, cross against the context length) and recurrent state updates.
    An estimate, as the reference's."""
    b, s = shape.global_batch, shape.seq_len
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    decode = shape.kind == "decode"
    total = 0
    for i in range(cfg.n_layers):
        kind = cfg.block_kind(i)
        if kind == "attn":
            ctx = s if decode else s / 2
            tok = 1 if decode else s
            total += int(4 * b * h * dh * tok * ctx)
        elif kind == "local":
            w = cfg.local_window or s
            ctx = min(s, w)
            tok = 1 if decode else s
            total += int(4 * b * h * dh * tok * ctx)
        elif kind == "cross":
            tok = 1 if decode else s
            total += 4 * b * h * dh * tok * cfg.n_image_tokens
        elif kind == "mlstm":
            e = cfg.xlstm_expand * cfg.d_model
            dhe = e // cfg.n_heads
            tok = 1 if decode else s
            # C update (Dh²) + numerator matvec (Dh²) per step per head
            total += 6 * b * cfg.n_heads * dhe * dhe * tok
        elif kind == "slstm":
            d = cfg.d_model
            dhh = d // cfg.n_heads
            tok = 1 if decode else s
            total += 8 * b * d * dhh * tok
        elif kind == "rec":
            w = cfg.lru_width or cfg.d_model
            tok = 1 if decode else s
            total += 12 * b * w * tok
    if cfg.is_encoder_decoder and not decode:
        f = cfg.encoder_seq
        total += cfg.n_encoder_layers * 4 * b * h * dh * f * f // 2
        total += cfg.n_layers * 4 * b * h * dh * s * f      # cross-attn
    return total


def model_flops(cfg, shape) -> int:
    """6·N_active·D (train) / 2·N_active·D (forward), plus mixer terms."""
    n = active_params(cfg)
    mix = _mixer_flops_fwd(cfg, shape)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6 * n * tokens + 3 * mix
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2 * n * tokens + mix
    # decode: one token per sequence
    return 2 * n * shape.global_batch + mix


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: tuple[int, ...]
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_stats: CollectiveStats | None
    model_flops_total: float
    hw: HW = DEFAULT_HW

    @property
    def t_compute(self) -> float:
        return self.hw.compute_time_s(self.flops_per_chip)

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / self.hw.ici_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Roofline step time: the overlap rule of the FTL objective
        (``hw.modeled_runtime``) with the collective term folded in."""
        return max(hw_targets.modeled_runtime(self.t_compute, self.t_memory),
                   self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (traced FLOPs × chips): remat and redundancy."""
        total = self.flops_per_chip * self.chips
        return self.model_flops_total / max(1.0, total)

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization at the roofline bound."""
        ideal = self.model_flops_total / (self.chips * self.hw.peak_flops)
        return ideal / max(1e-12, self.t_bound)

    def row(self) -> dict[str, Any]:
        return {
            "arch": self.arch, "shape": self.shape,
            "target": self.hw.target_name,
            "mesh": "x".join(map(str, self.mesh)), "chips": self.chips,
            "t_compute_s": round(self.t_compute, 6),
            "t_memory_s": round(self.t_memory, 6),
            "t_collective_s": round(self.t_collective, 6),
            "dominant": self.dominant,
            "model_flops": f"{self.model_flops_total:.3e}",
            "useful_flops_ratio": round(self.useful_flops_ratio, 3),
            "mfu_bound": round(self.mfu_bound, 3),
        }


def roofline(
    *, arch: str, shape, mesh_shape: tuple[int, ...],
    cost: dict[str, Any], model_flops_total: float, hw: HW = DEFAULT_HW,
    coll_bytes: int | None = None,
    coll_stats: CollectiveStats | None = None,
) -> RooflineReport:
    """The report of one cell.  ``cost`` holds ``flops`` and ``bytes
    accessed`` per chip (the reference's ``cost_analysis`` keys);
    ``coll_bytes`` the collective bytes per chip, else ``coll_stats``'
    total (the reference parses them from HLO text, which eager PyTorch
    does not have), else 0."""
    chips = math.prod(mesh_shape)
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    if coll_bytes is None:
        coll_bytes = coll_stats.total_bytes if coll_stats is not None else 0
    return RooflineReport(
        arch=arch, shape=shape.name if hasattr(shape, "name") else str(shape),
        mesh=mesh_shape, chips=chips,
        flops_per_chip=flops, bytes_per_chip=byts,
        coll_bytes_per_chip=float(coll_bytes),
        coll_stats=coll_stats, model_flops_total=model_flops_total, hw=hw)
