"""Paged (blocked) KV cache for the continuous-batching serving engine.

The counterpart of the reference ``repro.launch.kv_cache``:

* The physical pool is ``models.model.init_cache(cfg, num_blocks + 1,
  block_size)`` — the *batch* axis of every cache leaf plays the physical
  block index, so the pool reuses the model's cache structure (stacked
  ``layers`` leaves ``(L, NB+1, bs, Hk, Dh)``, remainder leaves
  ``(NB+1, bs, Hk, Dh)``).  Physical block 0 is a reserved scratch page:
  unmapped table entries and inactive slots point there.
* Each slot owns a block-table row (host-side numpy, ``(slots,
  blocks_per_slot)`` int32 physical block ids).  Pages are allocated on
  demand as a slot's position crosses a block boundary and returned to
  the free list on eviction.
* :func:`gather_dense` / :func:`scatter_token` are the two halves of a
  decode step: gather materializes the per-slot dense view ``(slots,
  max_seq, ...)`` from the pool, scatter writes each slot's new KV token
  back to its ``(block, offset)`` coordinate.

Where the reference rebuilds the pool arrays, :func:`scatter_token` and
:func:`_write_pages` update the pool tensors in place.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import model as M


def paged_supported(cfg) -> bool:
    """True when every decode-cache leaf is a plain full-attention KV
    tensor (pure-'attn' decoder-only stacks)."""
    if cfg.is_encoder_decoder:
        return False
    kinds, _, rem_kinds = M._layer_split(cfg)
    return all(k == "attn" for k in [*kinds, *rem_kinds])


def _leaves(tree):
    """(block axis, leaf) pairs of a pool/cache tree: stacked 'layers'
    leaves carry a leading layer dim → axis 1; remainder leaves → 0."""
    for top, sub in tree.items():
        ax = 1 if top == "layers" else 0
        for leaf in M.tree_leaves(sub):
            yield ax, leaf


def gather_dense(pool, tables: torch.Tensor):
    """Pool → per-slot dense cache view (new tensors).

    ``tables``: (slots, blocks_per_slot) physical block ids.  Each leaf
    ``(..., NB+1, bs, ...)`` gathers its mapped pages into ``(..., slots,
    blocks_per_slot * bs, ...)``.  Unmapped entries read the scratch
    page; decode masks them out."""
    slots, w = tables.shape
    flat = tables.reshape(-1).long()

    def g(leaf, ax):
        taken = leaf.index_select(ax, flat)
        sh = taken.shape
        return taken.reshape(*sh[:ax], slots, w * sh[ax + 1], *sh[ax + 2:])

    return {top: M.tree_map(lambda a, ax=(1 if top == "layers" else 0):
                            g(a, ax), sub)
            for top, sub in pool.items()}


def scatter_token(pool, dense, pos: torch.Tensor, wblk: torch.Tensor,
                  woff: torch.Tensor):
    """Write each slot's newly decoded KV token from the dense view back
    into the pool, in place.  ``pos`` (slots,) is each slot's write
    position in the dense view, ``wblk``/``woff`` (slots,) its physical
    (block, offset) coordinate; inactive slots point at the scratch
    page."""
    rows = torch.arange(pos.shape[0], device=pos.device)
    pos, wblk, woff = pos.long(), wblk.long(), woff.long()
    for (ax, pleaf), (_, dleaf) in zip(_leaves(pool), _leaves(dense)):
        if ax == 1:
            pleaf[:, wblk, woff] = dleaf[:, rows, pos]
        else:
            pleaf[wblk, woff] = dleaf[rows, pos]
    return pool


def _write_pages(pool, cache1, blocks: torch.Tensor):
    """Write one request's prefill cache (batch 1, seq = n_pages * bs)
    into its allocated pages, in place."""
    blocks = blocks.long()
    for (ax, pleaf), (_, cleaf) in zip(_leaves(pool), _leaves(cache1)):
        bs = pleaf.shape[ax + 1]
        c = cleaf.squeeze(ax)                     # drop request batch-1
        sh = c.shape
        c = c.reshape(*sh[:ax], blocks.shape[0], bs, *sh[ax + 1:])
        if ax == 1:
            pleaf[:, blocks] = c
        else:
            pleaf[blocks] = c
    return pool


class PagedKVCache:
    """Block-pool KV cache with per-slot page tables (single host).

    ``num_blocks`` bounds the physical pool (default: enough for every
    slot at ``max_seq``); one extra scratch page is always added.  Table
    and free-list bookkeeping is host-side numpy; only the pool lives on
    ``device``."""

    def __init__(self, cfg, *, slots: int, max_seq: int, block_size: int,
                 num_blocks: int | None = None,
                 device: torch.device | str | None = None):
        if not paged_supported(cfg):
            raise ValueError(
                "paged KV cache needs a pure-'attn' decoder-only config; "
                f"{cfg.name!r} has other cache kinds")
        if max_seq % block_size:
            raise ValueError(
                f"max_seq={max_seq} must be a multiple of "
                f"block_size={block_size}")
        self.cfg = cfg
        self.slots = slots
        self.max_seq = max_seq
        self.block_size = block_size
        self.blocks_per_slot = max_seq // block_size
        self.num_blocks = (num_blocks if num_blocks is not None
                           else slots * self.blocks_per_slot)
        if self.num_blocks < self.blocks_per_slot:
            raise ValueError(
                f"pool of {self.num_blocks} blocks cannot hold even one "
                f"slot at max_seq ({self.blocks_per_slot} blocks)")
        # +1: physical block 0 is the reserved scratch page
        self.pool = M.init_cache(cfg, self.num_blocks + 1, block_size,
                                 device=device)
        self.device = M.tree_leaves(self.pool)[0].device
        self.tables = np.zeros((slots, self.blocks_per_slot), np.int32)
        self.n_alloc = np.zeros(slots, np.int32)
        self._free = list(range(self.num_blocks, 0, -1))

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def can_allocate(self, slot: int, n_tokens: int) -> bool:
        need = self.blocks_for(n_tokens) - int(self.n_alloc[slot])
        return need <= len(self._free)

    def allocate(self, slot: int, n_tokens: int) -> bool:
        """Grow ``slot`` to cover ``n_tokens`` positions.  Returns False
        (allocating nothing) when the free list cannot cover the growth —
        the scheduler's admission-control signal."""
        need = self.blocks_for(n_tokens)
        have = int(self.n_alloc[slot])
        if need <= have:
            return True
        if need > self.blocks_per_slot:
            raise ValueError(
                f"slot {slot}: {n_tokens} tokens exceed max_seq "
                f"{self.max_seq}")
        if need - have > len(self._free):
            return False
        for j in range(have, need):
            self.tables[slot, j] = self._free.pop()
        self.n_alloc[slot] = need
        return True

    def release(self, slot: int) -> None:
        """Return the slot's pages to the free list (eviction)."""
        for j in range(int(self.n_alloc[slot])):
            self._free.append(int(self.tables[slot, j]))
        self.tables[slot, :] = 0
        self.n_alloc[slot] = 0

    def table_array(self) -> torch.Tensor:
        return torch.as_tensor(self.tables, device=self.device)

    def write_coords(self, slot: int, pos: int) -> tuple[int, int]:
        """Physical (block, offset) of dense position ``pos`` in ``slot``."""
        j = pos // self.block_size
        return int(self.tables[slot, j]), pos % self.block_size

    def write_prefill(self, slot: int, cache1, n_tokens: int) -> None:
        """Splice one request's prefill cache (batch 1, seq a multiple of
        ``block_size``) into the slot's pages, allocating them first."""
        if not self.allocate(slot, n_tokens):
            raise RuntimeError(
                f"KV pool exhausted admitting into slot {slot} "
                f"({self.free_blocks} free blocks)")
        nb = self.blocks_for(n_tokens)
        blocks = torch.as_tensor(self.tables[slot, :nb], device=self.device)
        _write_pages(self.pool, cache1, blocks)
