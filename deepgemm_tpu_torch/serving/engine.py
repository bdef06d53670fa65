"""Continuous batching over the paged indexer decode (the counterpart of
deepgemm_tpu/serving/engine.py).

  * Fixed decode slots: the engine owns ``max_slots`` batch rows; admission
    fills a free slot, completion frees it. Free slots ride along with
    ``context_len = 0``: the paged MQA kernel skips their tiles.
  * Paged cache: a host-side allocator hands cache pages to sequences; the
    block table is ``[max_slots, max_pages_per_seq]``.
  * Each step runs the lightning-indexer sparse decode (models/indexer.py):
    fp8 paged scoring, a top-k per slot, and attention over the selected
    rows, gathered first ('flat', the default) or read in place from the
    pages by the gather-fused kernel (``DGT_SPARSE_GATHER=pallas``). The
    cache writes below are in place on contiguous pages, so the flat views
    the indexer takes (``k_pages.view(-1, h, d)``) never copy them.

The JAX engine's split into a donated append jit and a read-only compute jit
is an XLA copy artefact (engine.py:224-267). Here the append and the prefill
write the caches in place with ``index_put_`` and the compute step reads
them, all under ``torch.no_grad()``. e4m3 pages are written through a uint8
view. Inactive slots write nothing (JAX's out-of-range ``mode='drop'``
scatter has no torch counterpart: torch raises out of range). CUDA graphs are
not used yet.
"""

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..kernels.common import select_rows
from ..models.indexer import indexer_sparse_decode
from ..runtime.config import resolve_device
from ..utils.math import ceil_div


class PageAllocator:
    """Host-side free list of cache pages, quad-aligned: a sequence's logical
    pages (4i .. 4i+3) are physically adjacent (4k .. 4k+3) whenever a whole
    aligned quad is free, degrading to aligned pairs, then singles. The JAX
    zero-copy kernel coalesces such runs into larger DMAs; correctness never
    depends on adjacency. A copy of deepgemm_tpu/serving/engine.py:37-147."""

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        # quad k = pages (4k .. 4k+3), handed out in ascending order; the tail
        # (num_blocks % 4) starts as a pair and/or a single
        self._free_quads: List[int] = list(range(num_blocks // 4 - 1, -1, -1))
        tail = (num_blocks // 4) * 4
        self._free_pairs: List[int] = [tail // 2] if num_blocks - tail >= 2 else []
        self._free_singles: List[int] = [num_blocks - 1] if num_blocks % 2 else []

    @property
    def num_free(self) -> int:
        return 4 * len(self._free_quads) + 2 * len(self._free_pairs) + len(self._free_singles)

    def _pop_pair(self) -> Optional[int]:
        """An aligned pair index k (pages 2k, 2k+1), splitting a quad if
        needed; None when neither exists."""
        if self._free_pairs:
            return self._free_pairs.pop()
        if self._free_quads:
            q = self._free_quads.pop()          # split: hand the low pair, keep the high
            self._free_pairs.append(2 * q + 1)
            return 2 * q
        return None

    def _pop_single(self) -> int:
        if self._free_singles:
            return self._free_singles.pop()
        k = self._pop_pair()                    # break a pair (rare)
        if k is None:
            raise MemoryError('paged cache exhausted')
        self._free_singles.append(2 * k + 1)
        return 2 * k

    def alloc(self, n: int) -> List[int]:
        """n pages; positions (4i..4i+3) of the result are physically adjacent
        whenever a whole quad was free (pairs when not)."""
        if n > self.num_free:
            raise MemoryError(f'paged cache exhausted: need {n}, free {self.num_free}')
        out: List[int] = []
        while n - len(out) >= 4 and self._free_quads:
            q = self._free_quads.pop()
            out.extend(range(4 * q, 4 * q + 4))
        while n - len(out) >= 2:
            k = self._pop_pair()
            if k is None:
                break
            out.extend((2 * k, 2 * k + 1))
        while len(out) < n:
            out.append(self._pop_single())
        return out

    def alloc_pair(self) -> Optional[List[int]]:
        """One whole aligned pair, or None if only singles remain."""
        k = self._pop_pair()
        return None if k is None else [2 * k, 2 * k + 1]

    def alloc_quad(self) -> Optional[List[int]]:
        """One whole aligned quad (4k..4k+3), or None."""
        if not self._free_quads:
            return None
        q = self._free_quads.pop()
        return list(range(4 * q, 4 * q + 4))

    def free(self, pages: List[int]):
        singles = set(self._free_singles)
        singles.update(pages)
        for k in list(self._free_pairs):
            singles.update((2 * k, 2 * k + 1))
        self._free_pairs = []
        quads, pairs = [], []
        for p in sorted(singles):
            q4 = p - (p % 4)
            if all(q4 + j in singles for j in range(4)) and p == q4:
                quads.append(q4 // 4)
                for j in range(4):
                    singles.discard(q4 + j)
        for p in sorted(singles):
            even = p - (p % 2)
            if even in singles and even + 1 in singles:
                pairs.append(even // 2)
                singles.discard(even)
                singles.discard(even + 1)
        # descending storage, so pop() hands out ascending page numbers
        self._free_quads = sorted(set(self._free_quads) | set(quads), reverse=True)
        self._free_pairs = sorted(pairs, reverse=True)
        self._free_singles = sorted(singles)


@dataclasses.dataclass
class SequenceState:
    seq_id: int
    slot: int
    ctx_len: int                  # tokens in the cache
    pages: List[int]
    steps: int = 0
    # the rest of a quad or pair that decode growth took at a 4- or 2-aligned
    # logical page, kept for this sequence's next pages
    reserved_pages: List[int] = dataclasses.field(default_factory=list)


class PagedCache:
    """The device caches: attention K/V pages [num_blocks, block_kv, h, d]
    bf16, and the indexer cache in the kernels' pre-split layout (e4m3
    values [num_blocks, block_kv, di], f32 scales [num_blocks, block_kv])."""

    def __init__(self, num_blocks: int, block_kv: int, num_heads: int, head_dim: int,
                 index_dim: int, device=None):
        self.device = resolve_device(device)
        self.block_kv = block_kv
        shape = (num_blocks, block_kv, num_heads, head_dim)
        self.k_pages = torch.zeros(shape, dtype=torch.bfloat16, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=torch.bfloat16, device=self.device)
        self.ik_pages = torch.zeros((num_blocks, block_kv, index_dim),
                                    dtype=torch.float8_e4m3fn, device=self.device)
        self.isf_pages = torch.full((num_blocks, block_kv), 1e-9, dtype=torch.float32,
                                    device=self.device)

    @torch.no_grad()
    def write(self, pages: torch.Tensor, offsets: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, ik: torch.Tensor, isf: torch.Tensor):
        """Row ``i`` of each stream goes to (pages[i], offsets[i]) in place:
        k/v [n, h, d], ik [n, di] e4m3 (through a uint8 view), isf [n]."""
        index = (pages.to(self.device, torch.long), offsets.to(self.device, torch.long))
        self.k_pages.index_put_(index, k)
        self.v_pages.index_put_(index, v)
        self.ik_pages.view(torch.uint8).index_put_(index, ik.view(torch.uint8))
        self.isf_pages.index_put_(index, isf.float())


class ContinuousBatcher:
    """Static-slot continuous batching over the indexer sparse decode.

    ``embed_fn(token_batch) -> (q, iq, iw, k_new, v_new, ik_new, isf_new)``
    makes one decode step's streams for all slots from the [max_slots] int32
    tokens on the engine's device (a server plugs the model's projections in
    here; the tests and chip_smoke.py use deterministic per-token streams):
    q [S, h, d] bf16, iq [S, hi, di], iw [S, hi] f32, k_new/v_new [S, h, d]
    bf16, ik_new [S, di] e4m3, isf_new [S] f32.
    """

    def __init__(self, *, max_slots: int, max_pages_per_seq: int, num_blocks: int,
                 block_kv: int, num_heads: int, head_dim: int, index_heads: int,
                 index_dim: int, topk: int, embed_fn: Callable, device=None):
        self.device = resolve_device(device)
        self.max_slots = max_slots
        self.max_pages = max_pages_per_seq
        self.block_kv = block_kv
        self.topk = topk
        self.embed_fn = embed_fn
        self.alloc = PageAllocator(num_blocks)
        self.cache = PagedCache(num_blocks, block_kv, num_heads, head_dim, index_dim,
                                self.device)
        self.block_table = np.zeros((max_slots, max_pages_per_seq), np.int32)
        self.context_lens = np.zeros(max_slots, np.int32)
        self._slots: List[Optional[SequenceState]] = [None] * max_slots
        self._next_id = 0
        self.max_context_len = max_pages_per_seq * block_kv

    # ----- admission / completion -------------------------------------------
    def admit(self, prompt_len: int) -> Optional[int]:
        """Claim a slot and pages for a sequence whose prompt the caller then
        writes with :meth:`prefill`. Returns its seq_id, or None when no slot
        or not enough pages are free (the request waits at the caller)."""
        try:
            slot = self._slots.index(None)
        except ValueError:
            return None
        pages_needed = max(1, ceil_div(prompt_len, self.block_kv))
        if pages_needed > self.alloc.num_free:
            return None
        pages = self.alloc.alloc(pages_needed)
        seq = SequenceState(self._next_id, slot, 0, pages)
        self._next_id += 1
        self._slots[slot] = seq
        self.block_table[slot, :] = 0
        self.block_table[slot, :len(pages)] = pages
        self.context_lens[slot] = 0
        return seq.seq_id

    def finish(self, seq_id: int):
        for slot, seq in enumerate(self._slots):
            if seq is not None and seq.seq_id == seq_id:
                self.alloc.free(seq.pages + seq.reserved_pages)
                self._slots[slot] = None
                self.context_lens[slot] = 0
                self.block_table[slot, :] = 0
                return
        raise KeyError(seq_id)

    def _seq(self, seq_id: int) -> SequenceState:
        for seq in self._slots:
            if seq is not None and seq.seq_id == seq_id:
                return seq
        raise KeyError(seq_id)

    # ----- cache writes -------------------------------------------------------
    def _grow(self, seq: SequenceState, new_len: int):
        pages_needed = max(1, ceil_div(new_len, self.block_kv))
        while len(seq.pages) < pages_needed:
            if len(seq.pages) >= self.max_pages:
                raise MemoryError(f'sequence {seq.seq_id} exceeded '
                                  f'max_pages_per_seq={self.max_pages}')
            # keep the (4i..4i+3) adjacency while growing a page at a time: at
            # a 4-aligned logical page take a whole quad (a pair at 2-aligned)
            # and keep the rest for the next growths
            if seq.reserved_pages:
                page = seq.reserved_pages.pop(0)
            else:
                run = None
                if len(seq.pages) % 4 == 0:
                    run = self.alloc.alloc_quad()
                if run is None and len(seq.pages) % 2 == 0:
                    run = self.alloc.alloc_pair()
                if run is None:
                    run = self.alloc.alloc(1)
                page, seq.reserved_pages = run[0], run[1:]
            seq.pages.append(page)
            self.block_table[seq.slot, len(seq.pages) - 1] = page

    def _positions(self, seq: SequenceState, start: int, n: int):
        """(page, offset) tensors of the sequence's positions start .. start+n-1."""
        pos = np.arange(start, start + n)
        pages = np.asarray(seq.pages, np.int64)[pos // self.block_kv]
        return torch.from_numpy(pages), torch.from_numpy(pos % self.block_kv)

    def prefill(self, seq_id: int, k: torch.Tensor, v: torch.Tensor, ik: torch.Tensor,
                isf: torch.Tensor):
        """Write a prompt chunk's streams (k/v [T, h, d] bf16, ik [T, di] e4m3,
        isf [T] f32) after the sequence's cached tokens: exactly T rows, from
        any offset in a page (chunked prefill across pages included)."""
        seq = self._seq(seq_id)
        t = k.shape[0]
        self._grow(seq, seq.ctx_len + t)
        pages, offs = self._positions(seq, seq.ctx_len, t)
        self.cache.write(pages, offs, k, v, ik, isf)
        seq.ctx_len += t
        self.context_lens[seq.slot] = seq.ctx_len

    # ----- one decode step over all slots -------------------------------------
    @torch.no_grad()
    def step(self, tokens: Dict[int, int]) -> Dict[int, torch.Tensor]:
        """One decode step: ``tokens`` maps seq_id -> next input token id.
        Every active slot appends its new token's streams and advances one
        position; free slots ride along with context 0. Returns seq_id ->
        output [h, d]."""
        token_batch = np.zeros(self.max_slots, np.int32)
        active = np.zeros(self.max_slots, bool)
        for seq_id, tok in tokens.items():
            seq = self._seq(seq_id)
            token_batch[seq.slot] = tok
            active[seq.slot] = True

        q, iq, iw, k_new, v_new, ik_new, isf_new = self.embed_fn(
            torch.from_numpy(token_batch).to(self.device))

        # the new token of each active slot goes to its tail; others write nothing
        slots = np.flatnonzero(active)
        pages = np.zeros(len(slots), np.int64)
        offs = np.zeros(len(slots), np.int64)
        for i, slot in enumerate(slots):
            seq = self._slots[slot]
            self._grow(seq, seq.ctx_len + 1)
            pages[i] = seq.pages[seq.ctx_len // self.block_kv]
            offs[i] = seq.ctx_len % self.block_kv
        for slot in slots:
            seq = self._slots[slot]
            seq.ctx_len += 1
            seq.steps += 1
            self.context_lens[slot] = seq.ctx_len
        if len(slots):
            rows = torch.from_numpy(slots).to(self.device)
            self.cache.write(torch.from_numpy(pages), torch.from_numpy(offs),
                             k_new.index_select(0, rows), v_new.index_select(0, rows),
                             select_rows(ik_new, rows), isf_new.index_select(0, rows))

        c = self.cache
        out = indexer_sparse_decode(
            q[:, None], (c.k_pages, c.v_pages), (c.ik_pages, c.isf_pages), iq[:, None], iw,
            torch.from_numpy(self.context_lens).to(self.device),
            torch.from_numpy(self.block_table).to(self.device), self.max_context_len,
            self.topk)
        return {seq.seq_id: out[seq.slot, 0] for seq in self._slots
                if seq is not None and active[seq.slot]}
