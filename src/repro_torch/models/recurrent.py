"""Recurrent temporal-mixing blocks of the port: mLSTM + sLSTM (xLSTM)
and the RG-LRU recurrent block (Griffin / RecurrentGemma).

The counterpart of the reference ``repro.models.recurrent``, with its
casts kept exactly.  Sequence paths run the scans (the mLSTM and RG-LRU
kernels for CUDA tensors, their plain versions for CPU tensors); the
sLSTM scan and every decode step are plain PyTorch, as they are plain JAX
in the reference: single-step updates on constant-size state, kept in
fp32 (mLSTM ``C``/``n``/``m``, sLSTM ``h``/``c``/``n``/``m``, RG-LRU
``h`` and the causal conv's last ``conv_width - 1`` inputs).  Decode
steps update the state in place, where the reference returns new arrays.

Under a mesh step whose ``model`` axis is larger than 1 each mixer
computes on its weights' ``model`` shards, as the reference's rules lay
them out (``act_sharding.tp_split``), and only activations cross
``model``.  The RG-LRU runs on this rank's W / M channels: wx, wy and
the conv are column-parallel, wr and wi take the whole conv output
(gathered) for their columns, out is row-parallel.  The mLSTM gathers
up's output whole, computes q, k and v on its columns of each head,
runs the sequence scan whole on the gathered q, k and v (the scan needs
whole heads), and its decode step updates its columns of ``C`` and
``n``, summing the partial products over ``model``.  The sLSTM's gates
run on this rank's columns (wz, wi and wf column-parallel; wo, which the
rules split by rows, row-parallel) and its recurrence on the same ones,
gathering every rank's ``h`` each step where those columns split a
head.  The decode state stays on its shards (``cache_pspecs``): the
RG-LRU's and the sLSTM's state and the mLSTM's ``C`` and ``n`` are this
rank's slices, and the mLSTM's sequence scan, which runs whole, keeps
this rank's slices of its state.

Serving pads prompts on the right up to a bucket; every block's
``length=`` takes the state at the prompt's real end.  The RG-LRU's
padded steps scan with ``a = 1`` and ``u = 0`` (exact in bf16) and its
conv state is the inputs that end at ``length - 1``; the mLSTM's padded
steps get gates ``i = -inf`` and ``f = +inf``, so ``i' = 0``, ``f' = 1``
and ``m`` is unchanged: the carry passes through exactly; the sLSTM keeps
the state of step ``length - 1``.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as C
from repro_torch.distributed.act_sharding import placed, tp_split
from repro_torch.kernels import ops
from repro_torch.roofline.op_cost import pad_steps, steps

from .layers import init_linear, init_norm, linear, norm, row_linear

Params = dict[str, Any]

_LRU_C = 8.0
_GATES = ("z", "i", "f", "o")


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) with no linear cut-over."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _split(*asks):
    """The one ``model`` split (a ``sharding.TP``, or None where whole)
    that several of the rules' answers share: each of ``asks`` is the
    arguments of a ``tp_split`` question about the same width, so they
    must agree."""
    tps = [tp_split(*a) for a in asks]
    if any((t is None) != (tps[0] is None) for t in tps):
        raise ValueError(f"the rules split some of {[a[0] for a in asks]} "
                         f"over 'model' and not the others")
    return tps[0]


def _linear_f32(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``linear`` on fp32 ``x``: the weights promoted to fp32, as JAX
    promotes a bf16 weight against an fp32 input."""
    y = x @ p["w"].float()
    if "b" in p:
        y = y + p["b"].float()
    return y


# ===========================================================================
# mLSTM (xLSTM) block
# ===========================================================================

def init_mlstm_block(cfg, gen: torch.Generator, dtype: torch.dtype,
                     device: torch.device, lead: tuple[int, ...] = ()
                     ) -> Params:
    d = cfg.d_model
    e = cfg.xlstm_expand * d
    h = cfg.n_heads
    dh = e // h
    kw = dict(dtype=dtype, device=device, lead=lead)
    f32 = dict(dtype=torch.float32, device=device, lead=lead)

    # q/k/v are block-diagonal per head (xLSTM eq. 24's head-wise
    # projections): (H, dh, dh) instead of dense (e, e)
    def blockdiag():
        w = torch.randn((*lead, h, dh, dh), generator=gen, device=device,
                        dtype=torch.float32)
        return {"w": placed(w.mul_(dh ** -0.5).to(dtype))}

    return {
        "norm": init_norm(d, cfg.norm, dtype, device, lead),
        "up": init_linear(gen, d, 2 * e, bias=False, **kw),
        "wq": blockdiag(),
        "wk": blockdiag(),
        "wv": blockdiag(),
        "wi": init_linear(gen, e, h, bias=True, **f32),
        "wf": init_linear(gen, e, h, bias=True, **f32),
        "head_norm": init_norm(e, "rmsnorm", dtype, device, lead),
        "down": init_linear(gen, e, d, bias=False,
                            scale=e ** -0.5 / math.sqrt(2 * cfg.n_layers),
                            **kw),
    }


class _MSplit(NamedTuple):
    """How an mLSTM block splits over ``model`` (each None where whole):
    up's columns, over the whole 2E; q's, k's and v's output dh (wq's,
    wk's and wv's last dim, and the state's ``C`` and ``n``); the gates'
    heads (wi's and wf's columns, and the state's ``m``); down's rows."""
    up: Any
    qkv: Any
    heads: Any
    down: Any


def _mlstm_split(cfg, batch: int) -> _MSplit:
    d, h = cfg.d_model, cfg.n_heads
    e = cfg.xlstm_expand * d
    dh = e // h
    return _MSplit(tp_split(("up", "w"), (d, 2 * e), 1),
                   tp_split(("wq", "w"), (h, dh, dh), 2),
                   _split((("wi", "w"), (e, h), 1),
                          ("rec_state", (batch, h), 1)),
                   tp_split(("down", "w"), (e, d), 0))


def _mlstm_up(cfg, p: Params, x: torch.Tensor, sp: _MSplit):
    """The input norm and the up projection, gathered whole over
    ``model`` (a rank's columns of up may all be ``xin``'s or all
    ``z``'s): (xin, z), (B, S, E) each."""
    xn = norm(p["norm"], x, cfg.norm)
    up = C.gather_along(linear(p["up"], C.copy_in(xn, sp.up)), sp.up)
    return up.chunk(2, dim=-1)


def _mlstm_qkvif(cfg, p: Params, xin: torch.Tensor, sp: _MSplit,
                 whole_qk: bool = True):
    """q, k, v (B, H, S, Dh) and the gates' pre-activations (B, H, S).
    Under a split each rank computes its columns of q, k and v; v, and
    with ``whole_qk`` q and k, are gathered whole, and the gates are
    gathered to every head."""
    b, s, e = xin.shape
    h = cfg.n_heads
    xq = C.copy_in(xin, sp.qkv)
    xh = xq.reshape(b, s, h, e // h)
    q = torch.einsum("bshd,hde->bhse", xh, p["wq"]["w"])
    k = torch.einsum("bshd,hde->bhse", xh, p["wk"]["w"])
    v = C.gather_along(torch.einsum("bshd,hde->bhse", xh, p["wv"]["w"]),
                       sp.qkv)
    if whole_qk:
        q, k = C.gather_along(q, sp.qkv), C.gather_along(k, sp.qkv)
    xg = xq if sp.qkv is not None and sp.heads is not None \
        else C.copy_in(xin, sp.heads)
    i_pre = C.gather_along(linear(p["wi"], xg.float()), sp.heads)
    f_pre = C.gather_along(linear(p["wf"], xg.float()), sp.heads)
    return q, k, v, i_pre.transpose(1, 2), f_pre.transpose(1, 2) + 3.0


def _mlstm_out(cfg, p: Params, hcell: torch.Tensor, z: torch.Tensor,
               x: torch.Tensor, sp: _MSplit) -> torch.Tensor:
    """Head norm, the output gate ``silu(z)`` and the down projection of
    the cell output ``hcell`` (B, S, E), whole on every rank: down is
    row-parallel on this rank's slice of it."""
    hcell = norm(p["head_norm"], hcell, "rmsnorm")
    out = hcell * F.silu(z.float()).to(x.dtype)
    return row_linear(p["down"], C.split_along(out, sp.down), "down",
                      sp.down)


def mlstm_block(cfg, p: Params, x: torch.Tensor, *,
                return_state: bool = False, length: int | None = None):
    """x: (B, S, D) -> (B, S, D); residual added by caller.  ``length``
    (≤ S) is the prompt's real length when the sequence is padded on the
    right: the padded steps' gates carry the state through unchanged, so
    the returned state is the one after ``length`` tokens.

    ``cfg.mlstm_chunk > 0`` (the reference's time-chunked rematerialised
    scan, which keeps only chunk-boundary states for the backward pass)
    runs the plain chunked scan for a CPU tensor, exactly as the reference
    does, and the kernel's Function for a CUDA tensor: that Function
    already saves only the states at its own chunks' starts (the
    schedule's chunk length, not ``mlstm_chunk``).  With ``return_state``
    the scan is unchunked, as in the reference.

    Under a ``model`` split the scan runs whole on every rank, on q, k
    and v gathered from the ranks' columns, and the returned state is
    this rank's shard of the whole scan's: its columns of ``C`` and
    ``n``, and its heads of ``m`` where the heads split."""
    sp = _mlstm_split(cfg, x.shape[0])
    xin, z = _mlstm_up(cfg, p, x, sp)                   # (B, S, E) each
    q, k, v, i_pre, f_pre = _mlstm_qkvif(cfg, p, xin, sp)
    b, s = x.shape[0], x.shape[1]
    if length is not None and length < s:
        pad = torch.arange(s, device=x.device) >= length
        i_pre = i_pre.masked_fill(pad, float("-inf"))
        f_pre = f_pre.masked_fill(pad, float("inf"))
    state = None
    if return_state:
        hcell, state = ops.mlstm(q, k, v, i_pre, f_pre, return_state=True)
        state = {"C": C.split_along(state["C"], sp.qkv),
                 "n": C.split_along(state["n"], sp.qkv),
                 "m": C.split_along(state["m"], sp.heads)}
    else:
        hcell = ops.mlstm(q, k, v, i_pre, f_pre, chunk=cfg.mlstm_chunk)
    hcell = hcell.transpose(1, 2).reshape(b, s, -1)
    y = _mlstm_out(cfg, p, hcell, z, x, sp)
    return (y, state) if return_state else y


def init_mlstm_state(cfg, batch: int, device: torch.device,
                     lead: tuple[int, ...] = ()) -> Params:
    e = cfg.xlstm_expand * cfg.d_model
    h = cfg.n_heads
    dh = e // h
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((*lead, batch, h, dh, dh), **f32),
        "n": torch.zeros((*lead, batch, h, dh), **f32),
        "m": torch.zeros((*lead, batch, h), **f32),
    }


def mlstm_block_decode(cfg, p: Params, x: torch.Tensor, state: Params
                       ) -> tuple[torch.Tensor, Params]:
    """One-token step (x (B, 1, D)) on constant-size state, updated in
    place; the returned state is the same tensors.  Under a ``model``
    split ``state`` holds this rank's columns of ``C`` (B, H, Dh, Dh /
    M) and ``n`` (B, H, Dh / M), and its heads of ``m`` where the heads
    split: the step updates them with its columns of k and the whole v
    and sums the readout's partial products over ``model``."""
    sp = _mlstm_split(cfg, x.shape[0])
    xin, z = _mlstm_up(cfg, p, x, sp)
    q, k, v, i_pre, f_pre = _mlstm_qkvif(cfg, p, xin, sp, whole_qk=False)
    qt = q[:, :, 0].float()                             # (B, H, Dh / M)
    kt = k[:, :, 0].float()
    vt = v[:, :, 0].float()                             # (B, H, Dh)
    it = i_pre[:, :, 0]
    ft = f_pre[:, :, 0]
    scale = (xin.shape[-1] // cfg.n_heads) ** -0.5

    m = C.gather_along(state["m"], sp.heads)            # (B, H)
    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + m, it)
    i_ = torch.exp(it - m_new)[..., None]
    f_ = torch.exp(logf + m - m_new)[..., None]
    cst = state["C"].mul_(f_[..., None]).add_(
        i_[..., None] * (vt[..., :, None] * kt[..., None, :]))
    nvec = state["n"].mul_(f_).add_(i_ * kt)
    state["m"].copy_(C.split_along(m_new, sp.heads))
    qs = qt * scale
    num = C.all_reduce_((cst * qs[..., None, :]).sum(-1), sp.qkv)
    nq = C.all_reduce_((nvec * qs).sum(-1), sp.qkv)
    den = torch.maximum(nq.abs(), torch.exp(-m_new))
    hcell = (num / den[..., None]).reshape(x.shape[0], 1, -1).to(x.dtype)
    return _mlstm_out(cfg, p, hcell, z, x, sp), state


# ===========================================================================
# sLSTM block (scalar memory, per-head recurrent weights)
# ===========================================================================

def init_slstm_block(cfg, gen: torch.Generator, dtype: torch.dtype,
                     device: torch.device, lead: tuple[int, ...] = ()
                     ) -> Params:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    kw = dict(dtype=dtype, device=device, lead=lead)
    p: Params = {"norm": init_norm(d, cfg.norm, dtype, device, lead)}
    for g in _GATES:
        p[f"w{g}"] = init_linear(gen, d, d, bias=True, **kw)
        # block-diagonal recurrent weights: (H, dh, dh), kept in fp32
        p[f"r{g}"] = placed(torch.randn((*lead, h, dh, dh), generator=gen,
                                        device=device, dtype=torch.float32
                                        ).mul_(dh ** -0.5))
    p["down"] = init_linear(gen, d, d, bias=False,
                            scale=d ** -0.5 / math.sqrt(2 * cfg.n_layers),
                            **kw)
    return p


def init_slstm_state(cfg, batch: int, device: torch.device,
                     lead: tuple[int, ...] = ()) -> Params:
    return {g: torch.zeros((*lead, batch, cfg.d_model), dtype=torch.float32,
                           device=device) for g in ("h", "c", "n", "m")}


def _slstm_split(cfg, batch: int):
    """The sLSTM's split of D over ``model`` (None where whole): wz's,
    wi's and wf's columns, wo's and down's rows, and the state (B, D),
    all on D."""
    d = cfg.d_model
    return _split(*[((f"w{g}", "w"), (d, d), 1) for g in "zif"],
                  (("wo", "w"), (d, d), 0), (("down", "w"), (d, d), 0),
                  ("rec_state", (batch, d), 1))


def _slstm_pre(p: Params, xn: torch.Tensor, tp) -> Params:
    """The gates' input pre-activations ``W_g x + b_g`` (fp32) of this
    rank's columns, from the block's normed input ``xn`` (fp32).  The
    rules read the output gate's ``wo`` as a contraction-side matrix by
    its name, as attention's, and split its rows over ``model``: its
    product is row-parallel, and one reduce-scatter over ``model`` leaves
    each rank its columns of the sum (its bias's slice, as every
    bias's)."""
    xc = C.copy_in(xn, tp)
    pre = {g: _linear_f32(p[f"w{g}"], xc) for g in "zif"}
    o = C.split_along(xn, tp) @ p["wo"]["w"].float()
    pre["o"] = C.reduce_scatter_along(o, tp) + p["wo"]["b"].float()
    return pre


def _slstm_rec(cfg, p: Params, tp):
    """The recurrent terms ``r_g h`` of this rank's columns of each gate,
    as a function of its state ``h`` (B, D / M).  The rules replicate
    the block-diagonal ``r_g`` (H, dh, dh), and each rank uses its
    columns of it.  Where those are whole heads (H divides over
    ``model``) its own ``h`` is enough; else each step gathers every
    rank's ``h`` and multiplies each head's part of it by this rank's
    columns of that head."""
    d, nh = cfg.d_model, cfg.n_heads
    dh = d // nh
    n = d if tp is None else d // tp.size
    if n % dh == 0:
        r = {g: C.split_along(p[f"r{g}"], tp, 0) for g in _GATES}

        def rec(h):
            hh = h.reshape(h.shape[0], n // dh, dh)
            return {g: torch.einsum("bhi,hij->bhj", hh, r[g]).reshape(
                h.shape[0], n) for g in _GATES}

        return rec
    # column c of (dh, D) is head c // dh's output c % dh
    cols = {g: C.split_along(p[f"r{g}"].transpose(0, 1).reshape(dh, d), tp)
            for g in _GATES}
    c0 = tp.rank * n
    segs = [(j, max(c0, j * dh) - c0, min(c0 + n, (j + 1) * dh) - c0)
            for j in range(c0 // dh, (c0 + n - 1) // dh + 1)]

    def rec(h):
        hw = C.gather_along(h, tp, partial_grad=True)
        return {g: torch.cat([hw[:, j * dh:(j + 1) * dh] @ cols[g][:, lo:hi]
                              for j, lo, hi in segs], dim=-1)
                for g in _GATES}

    return rec


def _slstm_step(rec, state: Params, xt: Params) -> Params:
    """One sLSTM step; ``xt`` the gates' input pre-activations (B, D)
    (already W x + b), ``rec`` as :func:`_slstm_rec` gives it.  Returns
    new fp32 state tensors."""
    r = rec(state["h"])
    zt = torch.tanh(xt["z"] + r["z"])
    it = xt["i"] + r["i"]
    ft = xt["f"] + r["f"]
    ot = torch.sigmoid(xt["o"] + r["o"])

    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + state["m"], it)
    i_ = torch.exp(it - m_new)
    f_ = torch.exp(logf + state["m"] - m_new)
    c = f_ * state["c"] + i_ * zt
    n = f_ * state["n"] + i_
    h = ot * c / torch.clamp(n, min=1.0)
    return {"h": h, "c": c, "n": n, "m": m_new}


def slstm_block(cfg, p: Params, x: torch.Tensor, *,
                return_state: bool = False, length: int | None = None):
    """Full-sequence sLSTM block (a Python loop over time).  With
    ``length`` (≤ S) the returned state is the one after ``length``
    tokens; the steps past it are the bucket's padding.  Under a
    ``model`` split it runs on this rank's columns of D, and the state
    it returns is this rank's (B, D / M)."""
    tp = _slstm_split(cfg, x.shape[0])
    pre = _slstm_pre(p, norm(p["norm"], x, cfg.norm).float(), tp)
    rec = _slstm_rec(cfg, p, tp)
    b, s, _ = x.shape
    length = s if length is None else length
    state = {g: torch.zeros_like(pre["z"][:, 0]) for g in ("h", "c", "n",
                                                           "m")}
    kept = state if length == 0 else None
    hs = []
    for t in steps(s):
        state = _slstm_step(rec, state, {g: v[:, t] for g, v in
                                         pre.items()})
        hs.append(state["h"])
        if t == length - 1:
            kept = state
    if kept is None:            # a loop priced by trips ran 3 steps
        kept = state
    pad_steps(hs, s)
    out = torch.stack(hs, dim=1).to(x.dtype)
    y = row_linear(p["down"], out, "down", tp)
    return (y, kept) if return_state else y


def slstm_block_decode(cfg, p: Params, x: torch.Tensor, state: Params
                       ) -> tuple[torch.Tensor, Params]:
    """One-token step; the state (this rank's columns under a ``model``
    split) is updated in place."""
    tp = _slstm_split(cfg, x.shape[0])
    pre = _slstm_pre(p, norm(p["norm"], x, cfg.norm).float()[:, 0], tp)
    new = _slstm_step(_slstm_rec(cfg, p, tp), state, pre)
    for g, t in new.items():
        state[g].copy_(t)
    out = row_linear(p["down"], state["h"][:, None].to(x.dtype), "down", tp)
    return out, state


# ===========================================================================
# RG-LRU recurrent block (Griffin / RecurrentGemma)
# ===========================================================================

def init_rec_block(cfg, gen: torch.Generator, dtype: torch.dtype,
                   device: torch.device, lead: tuple[int, ...] = ()
                   ) -> Params:
    d = cfg.d_model
    w = cfg.lru_width or d
    kw = dict(dtype=dtype, device=device, lead=lead)
    # Λ so that a = exp(-c·softplus(Λ)·r) lands in (0.9, 0.999) at r≈0.5
    lam = torch.log(torch.expm1(
        -torch.log(torch.linspace(0.9, 0.999, w, dtype=torch.float32,
                                  device=device)) * 2.0 / _LRU_C))
    conv = torch.randn((*lead, cfg.conv_width, w), generator=gen,
                       device=device, dtype=torch.float32)
    return {
        "norm": init_norm(d, cfg.norm, dtype, device, lead),
        "wx": init_linear(gen, d, w, bias=False, **kw),
        "wy": init_linear(gen, d, w, bias=False, **kw),
        "conv": placed(conv.mul_(cfg.conv_width ** -0.5).to(dtype)),
        "conv_b": placed(torch.zeros((*lead, w), dtype=dtype,
                                     device=device)),
        "wr": init_linear(gen, w, w, bias=True, **kw),
        "wi": init_linear(gen, w, w, bias=True, **kw),
        "lam": placed(lam.expand(*lead, w).clone()),
        "out": init_linear(gen, w, d, bias=False,
                           scale=w ** -0.5 / math.sqrt(2 * cfg.n_layers),
                           **kw),
    }


def _causal_conv(xt: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv along time.  xt (B, T, W); w (K, W); ``prev``
    the K-1 inputs before ``xt`` (zeros when None)."""
    kw, t = w.shape[0], xt.shape[1]
    if prev is None:
        pad = torch.zeros((xt.shape[0], kw - 1, xt.shape[2]),
                          dtype=xt.dtype, device=xt.device)
    else:
        pad = prev.to(xt.dtype)
    xp = torch.cat([pad, xt], dim=1)
    out = sum(xp[:, i:i + t] * w[i][None, None] for i in range(kw))
    return out + b[None, None]


def _rec_split(cfg, batch: int):
    """The RG-LRU's split of its width W over ``model`` (None where
    whole): wx's, wy's, wr's and wi's columns, the conv's channels,
    out's rows and the state (B, W), all on W."""
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    return _split((("wx", "w"), (d, w), 1), (("wr", "w"), (w, w), 1),
                  (("out", "w"), (w, d), 0), ("rec_state", (batch, w), 1))


def _lru_gates(p: Params, xc: torch.Tensor, tp):
    """a and u of this rank's channels of the conv output ``xc``.  wr and
    wi contract over the whole W, so their columns take ``xc`` gathered
    from every rank; ``lam`` is replicated, and each rank takes its
    slice."""
    xw = C.gather_along(xc, tp, partial_grad=True)
    r = torch.sigmoid(linear(p["wr"], xw).float())
    i = torch.sigmoid(linear(p["wi"], xw).float())
    lam = C.split_along(p["lam"], tp)
    a = torch.exp(-_LRU_C * _softplus(lam)[None, None] * r)
    # input normalization: sqrt(1 - a^2), from the Griffin paper
    u = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i * xc.float()
    return a, u


def rec_block(cfg, p: Params, x: torch.Tensor, *,
              return_state: bool = False, length: int | None = None):
    """Full-sequence recurrent block.  ``length`` (≤ T) is the prompt's
    real length when the sequence is padded on the right: the returned
    state is taken there (the padded steps carry ``h`` unchanged).  Under
    a ``model`` split the scan runs on this rank's W / M channels, and
    the state it returns is this rank's."""
    tp = _rec_split(cfg, x.shape[0])
    xn = C.copy_in(norm(p["norm"], x, cfg.norm), tp)
    xb = linear(p["wx"], xn)                                   # (B, T, W)
    xc = _causal_conv(xb, p["conv"], C.split_along(p["conv_b"], tp))
    a, u = _lru_gates(p, xc, tp)
    a, u = a.to(x.dtype), u.to(x.dtype)
    t = x.shape[1]
    length = t if length is None else length
    if length < t:
        pad = torch.arange(t, device=x.device)[None, :, None] >= length
        a = a.masked_fill(pad, 1.0)
        u = u.masked_fill(pad, 0.0)
    h, h_t = ops.rg_lru(u, a)
    gate = _gelu(linear(p["wy"], xn).float())
    y = row_linear(p["out"], (h.float() * gate).to(x.dtype), "out", tp)
    if not return_state:
        return y
    k = cfg.conv_width - 1
    conv = xb[:, max(0, length - k):length].float()
    if conv.shape[1] < k:
        conv = F.pad(conv, (0, 0, k - conv.shape[1], 0))
    return y, {"h": h_t, "conv": conv}


def init_rec_state(cfg, batch: int, device: torch.device,
                   lead: tuple[int, ...] = ()) -> Params:
    w = cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros((*lead, batch, w), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((*lead, batch, cfg.conv_width - 1, w),
                            dtype=torch.float32, device=device),
    }


def rec_block_decode(cfg, p: Params, x: torch.Tensor, state: Params
                     ) -> tuple[torch.Tensor, Params]:
    """One-token step (x (B, 1, D)).  The state (this rank's channels
    under a ``model`` split) is updated in place, where the reference
    returns new arrays; the returned state is the same tensors."""
    tp = _rec_split(cfg, x.shape[0])
    xn = C.copy_in(norm(p["norm"], x, cfg.norm), tp)
    xb = linear(p["wx"], xn)                                   # (B, 1, W)
    xc = _causal_conv(xb, p["conv"], C.split_along(p["conv_b"], tp),
                      prev=state["conv"])
    a, u = _lru_gates(p, xc, tp)
    h = a[:, 0] * state["h"] + u[:, 0]
    conv_new = torch.cat([state["conv"][:, 1:], xb.float()], dim=1)
    gate = _gelu(linear(p["wy"], xn).float())
    out = (h[:, None] * gate).to(x.dtype)
    state["h"].copy_(h)
    state["conv"].copy_(conv_new)
    return row_linear(p["out"], out, "out", tp), state
