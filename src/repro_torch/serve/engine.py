"""Serving engines (port of ``repro.serve.engine``): batched LM prefill and
decode, and batched vision inference.

Three LM engines share :func:`~repro_torch.models.transformer.apply_model`:

* :class:`ServeEngine` — *waves*: up to ``slots`` prompts left-padded to
  a common length, prefilled in one batched call, decoded in lockstep;
* :class:`ContinuousServeEngine` — continuous batching: every slot
  decodes at its own cache position, a finished slot is refilled by a
  batch-1 bucketed prefill into its cache row;
* :class:`PagedContinuousServeEngine` — the continuous scheduler over a
  block-paged KV pool: a refcounted free-list :class:`BlockAllocator`
  under a byte budget, per-slot page tables, block-aligned chunked
  prefill, a prefix cache keyed by chained block hashes with copy-on-write
  of the tail block, LRU eviction and youngest-request preemption.

Every engine runs on ``device`` (``cuda`` unless given; the parameters must
already live there) under ``torch.inference_mode()``, reads each step's
greedy tokens back to the host as the reference does, and writes KV caches
in place. The wave and continuous engines also serve RWKV patterns: the
recurrent state of a slot is zeroed when the slot is refilled (a free slot
keeps stepping it in the batched decode); the paged engine refuses them
when it is built (there is no KV to page), as the reference's paged cache
does. With a LUT ACU on the kernels (``make_acu(..., use_kernels=True)``)
every GEMM runs ``fused_lut_dense`` (when ``fused``) on weight codes from
the quantize kernel, attention runs the approximate flash attention
kernel, contiguous or paged, and an RWKV time mix the WKV kernel. Pool
blocks are zeroed when they are allocated: a recycled block's stale K/V
would otherwise reach the K/V scales and, under a biased multiplier, the
masked keys' ``LUT[0, v]`` terms.

``mesh`` (a ``launch/mesh.py: RankMesh`` or a ``MeshContext``) activates
its context (the default rules for a mesh, a context verbatim) around
every model call, as the reference does: every ACU plan in the call runs its
sharded route (``parallel/acu_shard.py``) and returns the global result,
so every rank of the mesh, fed the same requests, takes the same tokens.
``mesh=None`` keeps the single-device behaviour.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.transformer import (apply_model,
                                            check_paged_kinds, init_cache,
                                            init_paged_cache, map_cache)
from repro_torch.parallel.sharding import mesh_context, use_mesh_context


def _mesh_scope(mesh) -> Callable:
    """A context factory for the engines' model calls: nothing, or the
    mesh's context (``parallel/sharding.py: mesh_context``; a context
    verbatim: its rules may omit keys on purpose)."""
    ctx = None if mesh is None else mesh_context(mesh)
    if ctx is None:
        return contextlib.nullcontext
    return lambda: use_mesh_context(ctx)


@dataclasses.dataclass
class Request:
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int = 16
    out: Optional[np.ndarray] = None


def _greedy(logits: torch.Tensor) -> np.ndarray:
    """First index of the largest logit of each row, on the host."""
    return torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int32)


class ServeEngine:
    """Wave serving: ``slots`` requests left-padded to a common length,
    prefilled together (``pos_offset`` shifts RoPE, ``pad_mask`` hides the
    pads), then decoded in lockstep until the longest budget drains."""

    def __init__(self, params, cfg: ModelConfig, *, slots: int = 4,
                 max_seq: int = 512, acfg=None, device=None, mesh=None):
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.max_seq = max_seq
        self.acfg = acfg
        self.device = resolve_device(device)
        self._mesh_scope = _mesh_scope(mesh)

    def _model(self, tokens: np.ndarray, cache, cache_pos, **kw):
        toks = torch.from_numpy(np.ascontiguousarray(tokens, np.int64))
        with self._mesh_scope():
            logits, _ = apply_model(self.params, toks.to(self.device),
                                    self.cfg, acfg=self.acfg, cache=cache,
                                    cache_pos=cache_pos, **kw)
        return logits[:, -1]

    def _wave(self, reqs: list[Request],
              on_token: Optional[Callable[[int, int], None]]) -> None:
        b, dev = self.slots, self.device
        plen = max(len(r.prompt) for r in reqs)
        toks = np.zeros((b, plen), np.int32)
        offs = np.zeros(b, np.int64)            # per-request left-pad counts
        valid = np.zeros((b, self.max_seq), bool)
        for i, r in enumerate(reqs):
            off = plen - len(r.prompt)
            toks[i, off:] = r.prompt
            offs[i] = off
            valid[i, off:] = True
        cache = init_cache(self.cfg, b, self.max_seq, device=dev)
        kw = dict(pos_offset=torch.from_numpy(offs).to(dev),
                  pad_mask=torch.from_numpy(valid).to(dev))
        cur = _greedy(self._model(toks, cache, 0, **kw))
        max_new = max(r.max_new_tokens for r in reqs)
        budget = max(0, min(max_new, self.max_seq - plen))
        out = np.zeros((b, budget), np.int32)
        n_out = np.zeros(b, np.int32)
        alive = np.ones(b, bool)
        for t in range(budget):
            for i in np.flatnonzero(alive):
                out[i, t] = cur[i]
                n_out[i] += 1
                if on_token:
                    on_token(int(i), int(cur[i]))
                if n_out[i] >= reqs[i].max_new_tokens:
                    alive[i] = False
            # no decode once every slot is done, nor for the step whose
            # logits nothing would consume
            if not alive.any() or t == budget - 1:
                break
            cur = _greedy(self._model(cur[:, None], cache, plen + t,
                                      decode=True, **kw))
        for i, r in enumerate(reqs):
            r.out = out[i, :n_out[i]].copy()

    def run(self, requests: list[Request],
            on_token: Optional[Callable[[int, int], None]] = None
            ) -> list[Request]:
        """Serve all requests in waves of ``slots``; returns them with
        ``.out``."""
        reqs = list(requests)
        with torch.inference_mode():
            for i in range(0, len(reqs), self.slots):
                wave = reqs[i:i + self.slots]
                while len(wave) < self.slots:     # pad the wave with dummies
                    wave.append(Request(prompt=np.zeros(1, np.int32),
                                        max_new_tokens=1))
                self._wave(wave, on_token)
        return requests


def _bucket(n: int, lo: int = 8) -> int:
    """Next power of two >= n (>= lo): at most log2 distinct prefill
    shapes."""
    b = lo
    while b < n:
        b *= 2
    return b


def poisson_arrivals(n: int, rate: float, seed: int = 0) -> np.ndarray:
    """Cumulative Poisson-process arrival times of ``n`` requests, in
    decode-step units (``rate`` = mean arrivals per decode step)."""
    rng = np.random.RandomState(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


class ContinuousServeEngine:
    """Continuous batching: slot-level admission and eviction.

    Each request is prefilled alone (left-padded to a power-of-two bucket)
    into its slot's cache row, which is zeroed first; from then on the slot
    decodes in the shared batched step at its own cache position. A slot
    that reaches its ``max_new_tokens`` is refilled the same step.
    ``run(requests, arrivals=None)`` replays arrival times in decode-step
    units; ``stats`` holds ``prefills``, ``decode_steps``, ``tokens``,
    ``occupancy`` (mean live slots per decode step) and ``rejected``
    (prompts longer than ``max_seq``)."""

    def __init__(self, params, cfg: ModelConfig, *, slots: int = 4,
                 max_seq: int = 512, acfg=None, device=None, mesh=None):
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.max_seq = max_seq
        self.acfg = acfg
        self.device = resolve_device(device)
        self._mesh_scope = _mesh_scope(mesh)
        self.stats: dict = {}

    def _admit(self, req: Request, slot: int, cache):
        """Prefill one request into row ``slot``. Returns (first_token,
        next_pos, pad_off, budget)."""
        dev = self.device
        plen = len(req.prompt)
        bucket = min(_bucket(plen), self.max_seq)
        off = bucket - plen
        toks = np.zeros((1, bucket), np.int64)
        toks[0, off:] = req.prompt
        valid = torch.zeros((1, self.max_seq), dtype=torch.bool, device=dev)
        valid[0, off:] = True
        # the row's cache as a batch-1 cache of its own, zeroed (K/V, or
        # the recurrent state that a free slot kept stepping): the
        # reference prefills a fresh row and inserts it
        row = map_cache(lambda t: t[:, slot:slot + 1].zero_(), cache)
        with self._mesh_scope():
            logits, _ = apply_model(
                self.params, torch.from_numpy(toks).to(dev), self.cfg,
                acfg=self.acfg, cache=row, cache_pos=0,
                pos_offset=torch.tensor([off], device=dev), pad_mask=valid,
                last_only=True)
        self.stats["prefills"] += 1
        tok = int(_greedy(logits[0, -1]))
        budget = max(0, min(req.max_new_tokens, self.max_seq - bucket))
        return tok, bucket, off, budget

    def run(self, requests: list[Request], arrivals=None,
            on_token: Optional[Callable[[int, int], None]] = None
            ) -> list[Request]:
        with torch.inference_mode():
            return self._run(requests, arrivals, on_token)

    def _run(self, requests, arrivals, on_token):
        dev = self.device
        reqs = list(requests)
        n = len(reqs)
        arr = (np.zeros(n) if arrivals is None
               else np.asarray(arrivals, np.float64))
        assert len(arr) == n
        order = sorted(range(n), key=lambda j: (arr[j], j))
        qi = 0
        slots = self.slots
        active = np.zeros(slots, bool)
        pos = np.zeros(slots, np.int64)
        offs = np.zeros(slots, np.int64)
        valid = np.zeros((slots, self.max_seq), bool)
        cur = np.zeros(slots, np.int32)
        n_out = np.zeros(slots, np.int64)
        budget = np.zeros(slots, np.int64)
        ridx = np.full(slots, -1, np.int64)
        outs: list[Optional[np.ndarray]] = [None] * slots
        cache = init_cache(self.cfg, slots, self.max_seq, device=dev)
        self.stats = {"prefills": 0, "decode_steps": 0, "tokens": 0,
                      "occupancy_sum": 0, "rejected": 0}
        step = 0.0
        done = 0
        while done < n:
            while qi < len(order) and arr[order[qi]] <= step:
                free = np.flatnonzero(~active)
                if not free.size:
                    break
                i, j = int(free[0]), order[qi]
                qi += 1
                if len(reqs[j].prompt) > self.max_seq:
                    # over-length prompt: rejected at admission
                    reqs[j].out = np.zeros(0, np.int32)
                    self.stats["rejected"] += 1
                    done += 1
                    continue
                tok, p0, off, bud = self._admit(reqs[j], i, cache)
                if bud <= 0:       # the prompt fills max_seq
                    reqs[j].out = np.zeros(0, np.int32)
                    done += 1
                    continue
                active[i] = True
                pos[i], offs[i], cur[i] = p0, off, tok
                valid[i] = False
                valid[i, off:] = True
                n_out[i], budget[i], ridx[i] = 0, bud, j
                outs[i] = np.zeros(bud, np.int32)
            if not active.any():
                if qi >= len(order):
                    break
                step = max(step, float(arr[order[qi]]))  # idle: jump clock
                continue
            # emit the token of the previous model call; free finished slots
            for i in np.flatnonzero(active):
                outs[i][n_out[i]] = cur[i]
                n_out[i] += 1
                self.stats["tokens"] += 1
                if on_token:
                    on_token(int(ridx[i]), int(cur[i]))
                if n_out[i] >= budget[i]:
                    reqs[ridx[i]].out = outs[i][:n_out[i]].copy()
                    active[i] = False
                    done += 1
            if not active.any():
                continue
            with self._mesh_scope():
                logits, _ = apply_model(
                    self.params,
                    torch.from_numpy(cur[:, None].astype(np.int64)).to(dev),
                    self.cfg, acfg=self.acfg, cache=cache,
                    cache_pos=torch.from_numpy(pos).to(dev), decode=True,
                    pos_offset=torch.from_numpy(offs).to(dev),
                    pad_mask=torch.from_numpy(valid).to(dev))
            nxt = _greedy(logits[:, -1])
            live = np.flatnonzero(active)
            cur[live] = nxt[live]
            pos[live] += 1
            self.stats["decode_steps"] += 1
            self.stats["occupancy_sum"] += int(live.size)
            step += 1.0
        self.stats["occupancy"] = (
            self.stats["occupancy_sum"] / max(1, self.stats["decode_steps"]))
        return requests


def kv_block_bytes(cfg: ModelConfig, block_size: int, dtype=None) -> int:
    """Bytes one physical KV block costs across the model: K and V, every
    KV head, every attention layer (a block id maps the same block in
    every layer's pool)."""
    dtype = dtype or cfg.param_dtype
    n_attn = sum(1 for k in cfg.pattern if k.startswith("attn")) \
        * cfg.n_groups
    itemsize = torch.empty(0, dtype=dtype).element_size()
    return (2 * n_attn * cfg.n_kv_heads * block_size * cfg.head_dim
            * itemsize)


class BlockAllocator:
    """Refcounted free list over ``n_blocks`` physical KV blocks.

    Block 0 is the *null* block (unallocated page-table entries point at
    it; never handed out, never written: always zeros); block 1 is the
    *scratch* block where inactive decode rows park. Shared prefix blocks
    carry one ref per sharer plus one for the prefix cache; a block goes
    back on the free list when its count drains to zero."""

    NULL = 0
    SCRATCH = 1
    RESERVED = 2

    def __init__(self, n_blocks: int):
        assert n_blocks > self.RESERVED, n_blocks
        self.n_blocks = n_blocks
        self._free = list(range(n_blocks - 1, self.RESERVED - 1, -1))
        self._rc = np.zeros(n_blocks, np.int32)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_blocks - self.RESERVED - len(self._free)

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        blk = self._free.pop()
        self._rc[blk] = 1
        return blk

    def ref(self, blk: int) -> int:
        assert self._rc[blk] > 0, blk
        self._rc[blk] += 1
        return blk

    def release(self, blk: int) -> bool:
        """Drop one ref; True when the block went back on the free list."""
        assert self._rc[blk] > 0, blk
        self._rc[blk] -= 1
        if self._rc[blk] == 0:
            self._free.append(blk)
            return True
        return False

    def refcount(self, blk: int) -> int:
        return int(self._rc[blk])


class PagedContinuousServeEngine:
    """Continuous batching over a block-paged KV pool with prefix reuse.

    The scheduler is :class:`ContinuousServeEngine`'s; the cache is a pool
    of ``block_size``-token blocks sized by ``hbm_budget`` (bytes; default
    the contiguous engine's footprint for the same slots and ``max_seq``):

    * **prefill** in block-aligned batch-1 chunks: each full block one call
      (``last_only``), the last partial chunk padded to a power-of-two
      bucket inside its block;
    * **prefix cache**: full prompt blocks keyed by a chained hash of their
      tokens are reused by reference, and only the chunks past the last
      hit are replayed; a full-prompt entry also snapshots the tail block
      and the first token, so an exact repeat admits with no prefill,
      copying the snapshot into a private block (copy-on-write);
    * **memory pressure**: LRU prefix-cache eviction first, then preemption
      of the youngest request, which keeps its tokens and re-enters the
      queue with ``prompt + emitted``.

    ``stats`` adds ``prefill_chunks``, ``prefix_hit_blocks``,
    ``prefix_lookup_blocks``, ``full_prompt_hits``, ``cache_evictions``,
    ``preemptions``, ``block_util``, ``peak_blocks`` and
    ``prefix_hit_rate``.
    """

    def __init__(self, params, cfg: ModelConfig, *, slots: int = 4,
                 max_seq: int = 512, block_size: int = 16, acfg=None,
                 hbm_budget: Optional[int] = None, prefix_cache: bool = True,
                 device=None, mesh=None):
        assert max_seq % block_size == 0, (max_seq, block_size)
        # a power of two >= the bucket floor: the tail chunk's bucket never
        # overflows its block
        assert block_size >= 8 and block_size & (block_size - 1) == 0, \
            block_size
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.max_seq = max_seq
        self.block_size = block_size
        self.acfg = acfg
        self.prefix_cache = prefix_cache
        self.device = resolve_device(device)
        self._mesh_scope = _mesh_scope(mesh)
        self.n_logical = max_seq // block_size
        # an rwkv model has no KV to page (and no block bytes to budget);
        # the reference's engine fails here dividing by them
        check_paged_kinds(cfg)
        bbytes = kv_block_bytes(cfg, block_size)
        if hbm_budget is None:
            hbm_budget = slots * self.n_logical * bbytes
        self.hbm_budget = hbm_budget
        self.n_blocks = max(BlockAllocator.RESERVED + self.n_logical,
                            hbm_budget // bbytes)
        self.stats: dict = {}

    # -- model calls and pool edits ------------------------------------------

    def _model(self, tokens: np.ndarray, pos, table: np.ndarray, **kw):
        dev = self.device
        toks = torch.from_numpy(np.ascontiguousarray(tokens, np.int64))
        pos_t = (pos if isinstance(pos, int)
                 else torch.from_numpy(np.asarray(pos, np.int64)).to(dev))
        with self._mesh_scope():
            logits, _ = apply_model(
                self.params, toks.to(dev), self.cfg, acfg=self.acfg,
                cache=self._cache, cache_pos=pos_t,
                page_table=torch.from_numpy(
                    np.ascontiguousarray(table)).to(dev), **kw)
        return logits

    def _pools(self):
        for blk in self._cache["groups"].values():
            yield from blk["attn"]

    def _copy_block(self, src: int, dst: int) -> None:
        for pool in self._pools():           # (g, Hkv, P, bk, hd)
            pool[:, :, dst] = pool[:, :, src]

    # -- prefix cache -------------------------------------------------------

    @staticmethod
    def _chain_hashes(prompt: np.ndarray, n: int, bk: int) -> list[str]:
        """Chained content hashes of the first ``n`` full blocks: block i's
        key commits to every token before it."""
        hs, h = [], "root"
        for c in range(n):
            h = hashlib.sha1(
                (h + "|" + prompt[c * bk:(c + 1) * bk].tobytes().hex())
                .encode()).hexdigest()
            hs.append(h)
        return hs

    def _evict_lru_entry(self) -> bool:
        """Drop the least recently used prefix-cache entry (either kind);
        False when both caches are empty."""
        cands = [(use, "blk", k) for k, (_, use) in self._prefix.items()]
        cands += [(use, "full", k)
                  for k, (_, _, _, use) in self._full.items()]
        if not cands:
            return False
        _, kind, key = min(cands)
        if kind == "blk":
            phys, _ = self._prefix.pop(key)
            self.alloc.release(phys)
        else:
            shared, tail, _, _ = self._full.pop(key)
            for phys in shared:
                self.alloc.release(phys)
            if tail is not None:
                self.alloc.release(tail)
        self.stats["cache_evictions"] += 1
        return True

    def _get_block(self) -> Optional[int]:
        """Allocate a zeroed block, evicting LRU prefix-cache entries under
        pressure; None when the pool is exhausted."""
        while True:
            blk = self.alloc.alloc()
            if blk is not None:
                for pool in self._pools():
                    pool[:, :, blk].zero_()
                return blk
            if not self._evict_lru_entry():
                return None

    # -- admission ----------------------------------------------------------

    def _admit(self, req: Request, slot: int, resume: np.ndarray):
        """Chunked block-aligned prefill of one request into ``slot``,
        reusing cached prefix blocks. Returns (first_token, plen, budget),
        or (None, 0, 0) when the pool cannot host the prompt now."""
        bk = self.block_size
        prompt = np.concatenate([np.asarray(req.prompt, np.int32), resume])
        plen = len(prompt)
        n_full = plen // bk
        t_real = plen - n_full * bk
        # the last chunk (partial, or the last full block of a block-aligned
        # prompt) is always replayed privately: decode writes there
        n_shared = n_full - (1 if t_real == 0 and n_full > 0 else 0)
        tail_lo = n_shared * bk
        tl = plen - tail_lo
        hashes = self._chain_hashes(prompt, n_shared, bk)
        full_key = ((hashes[-1] if n_shared else "root")
                    + "|" + prompt[tail_lo:].tobytes().hex())
        table = self._tables[slot]
        table[:] = BlockAllocator.NULL
        taken: list[int] = []

        def abort():
            for phys in taken:
                self.alloc.release(phys)
            table[:] = BlockAllocator.SCRATCH
            return None, 0, 0

        self._lru += 1
        full_ent = self._full.get(full_key) if self.prefix_cache else None
        if full_ent is not None:
            shared, tail_snap, first_tok, _ = full_ent
            self._full[full_key] = (shared, tail_snap, first_tok, self._lru)
            for c, phys in enumerate(shared):
                table[c] = self.alloc.ref(phys)
                taken.append(phys)
            dst = self._get_block()       # copy-on-write of the tail
            if dst is None:
                return abort()
            taken.append(dst)
            table[n_shared] = dst
            self._copy_block(tail_snap, dst)
            self.stats["full_prompt_hits"] += 1
            self.stats["prefix_hit_blocks"] += n_shared + 1
            self.stats["prefix_lookup_blocks"] += n_shared + 1
            tok = first_tok
        else:
            m = 0
            while self.prefix_cache and m < n_shared \
                    and hashes[m] in self._prefix:
                phys, _ = self._prefix[hashes[m]]
                self._prefix[hashes[m]] = (phys, self._lru)
                table[m] = self.alloc.ref(phys)
                taken.append(phys)
                m += 1
            self.stats["prefix_hit_blocks"] += m
            if self.prefix_cache:
                self.stats["prefix_lookup_blocks"] += n_shared
            for c in range(m, n_shared + 1):
                blk = self._get_block()
                if blk is None:
                    return abort()
                taken.append(blk)
                table[c] = blk
            for c in range(m, n_shared):
                self._model(prompt[None, c * bk:(c + 1) * bk], c * bk,
                            table[None], last_only=True)
                self.stats["prefill_chunks"] += 1
            padded = np.zeros((1, _bucket(tl)), np.int32)
            padded[0, :tl] = prompt[tail_lo:]
            logits = self._model(padded, tail_lo, table[None])
            self.stats["prefill_chunks"] += 1
            self.stats["prefills"] += 1
            tok = int(_greedy(logits[0, tl - 1]))
            if self.prefix_cache:
                # publish the new full blocks, and snapshot (tail block,
                # first token) for exact repeats
                for c in range(m, n_shared):
                    self._prefix[hashes[c]] = (self.alloc.ref(int(table[c])),
                                               self._lru)
                if full_key not in self._full:
                    snap = self.alloc.alloc()   # best effort: no eviction
                    if snap is not None:
                        self._copy_block(int(table[n_shared]), snap)
                        shared = tuple(self.alloc.ref(int(table[c]))
                                       for c in range(n_shared))
                        self._full[full_key] = (shared, snap, tok, self._lru)
        budget = max(0, min(req.max_new_tokens - len(resume),
                            self.max_seq - plen))
        return tok, plen, budget

    def _release_slot(self, slot: int) -> None:
        table = self._tables[slot]
        for phys in table[table >= BlockAllocator.RESERVED]:
            self.alloc.release(int(phys))
        table[:] = BlockAllocator.SCRATCH

    # -- main loop ----------------------------------------------------------

    def run(self, requests: list[Request], arrivals=None,
            on_token: Optional[Callable[[int, int], None]] = None
            ) -> list[Request]:
        with torch.inference_mode():
            return self._run(requests, arrivals, on_token)

    def _run(self, requests, arrivals, on_token):
        reqs = list(requests)
        n = len(reqs)
        arr = (np.zeros(n) if arrivals is None
               else np.asarray(arrivals, np.float64))
        assert len(arr) == n
        order = sorted(range(n), key=lambda j: (arr[j], j))
        qi = 0
        ready: list[int] = []                  # admission queue
        resume: dict[int, np.ndarray] = {}     # preempted: emitted so far
        slots = self.slots
        active = np.zeros(slots, bool)
        pos = np.zeros(slots, np.int64)
        cur = np.zeros(slots, np.int32)
        n_out = np.zeros(slots, np.int64)
        budget = np.zeros(slots, np.int64)
        ridx = np.full(slots, -1, np.int64)
        admit_seq = np.zeros(slots, np.int64)  # preemption picks the max
        outs: list[Optional[np.ndarray]] = [None] * slots
        self.alloc = BlockAllocator(self.n_blocks)
        self._tables = np.full((slots, self.n_logical),
                               BlockAllocator.SCRATCH, np.int32)
        self._prefix: dict[str, tuple[int, int]] = {}
        self._full: dict[str, tuple[tuple, Optional[int], int, int]] = {}
        self._lru = 0
        self._cache = init_paged_cache(self.cfg, self.n_blocks,
                                       self.block_size, device=self.device)
        self.stats = {"prefills": 0, "prefill_chunks": 0, "decode_steps": 0,
                      "tokens": 0, "occupancy_sum": 0, "rejected": 0,
                      "prefix_hit_blocks": 0, "prefix_lookup_blocks": 0,
                      "full_prompt_hits": 0, "cache_evictions": 0,
                      "preemptions": 0, "block_util_sum": 0.0,
                      "peak_blocks": 0}
        usable = self.n_blocks - BlockAllocator.RESERVED
        step = 0.0
        done = 0
        seq = 0

        def preempt_youngest() -> bool:
            live = np.flatnonzero(active)
            if not live.size:
                return False
            i = int(live[np.argmax(admit_seq[live])])
            j = int(ridx[i])
            resume[j] = np.asarray(outs[i][:n_out[i]], np.int32).copy()
            self._release_slot(i)
            active[i] = False
            pos[i] = 0
            ready.insert(0, j)
            self.stats["preemptions"] += 1
            return True

        while done < n:
            while qi < len(order) and arr[order[qi]] <= step:
                ready.append(order[qi])
                qi += 1
            while ready:
                free = np.flatnonzero(~active)
                if not free.size:
                    break
                i, j = int(free[0]), ready[0]
                res = resume.get(j, np.zeros(0, np.int32))
                if len(reqs[j].prompt) + len(res) > self.max_seq:
                    # over-length (or preempted past the horizon): reject,
                    # or finish with what was already emitted
                    ready.pop(0)
                    reqs[j].out = res
                    if not res.size:
                        self.stats["rejected"] += 1
                    resume.pop(j, None)
                    done += 1
                    continue
                tok, p0, bud = self._admit(reqs[j], i, res)
                if tok is None:
                    break           # pool exhausted: back-pressure
                ready.pop(0)
                if bud <= 0:
                    reqs[j].out = res
                    resume.pop(j, None)
                    self._release_slot(i)
                    done += 1
                    continue
                seq += 1
                active[i] = True
                pos[i], cur[i] = p0, tok
                ridx[i] = j
                admit_seq[i] = seq
                outs[i] = np.concatenate([res, np.zeros(bud, np.int32)])
                n_out[i] = len(res)
                budget[i] = len(res) + bud
            if not active.any():
                if not ready and qi >= len(order):
                    break
                if not ready:
                    step = max(step, float(arr[order[qi]]))
                    continue
                raise RuntimeError(
                    f"KV pool ({usable} blocks) cannot host request "
                    f"{ready[0]} even with every slot idle")
            for i in np.flatnonzero(active):
                outs[i][n_out[i]] = cur[i]
                n_out[i] += 1
                self.stats["tokens"] += 1
                if on_token:
                    on_token(int(ridx[i]), int(cur[i]))
                if n_out[i] >= budget[i]:
                    reqs[ridx[i]].out = outs[i][:n_out[i]].copy()
                    resume.pop(int(ridx[i]), None)
                    self._release_slot(i)
                    active[i] = False
                    done += 1
            if not active.any():
                continue
            # every live row needs its write-target block mapped first
            for i in np.flatnonzero(active):
                bi = int(pos[i]) // self.block_size
                while self._tables[i, bi] < BlockAllocator.RESERVED:
                    blk = self._get_block()
                    if blk is not None:
                        self._tables[i, bi] = blk
                        break
                    if not preempt_youngest():
                        raise RuntimeError("KV pool exhausted mid-decode "
                                           "with nothing left to preempt")
                    if not active[i]:
                        break               # preempted itself
            live = np.flatnonzero(active)
            if not live.size:
                continue
            logits = self._model(cur[:, None], pos, self._tables,
                                 decode=True)
            nxt = _greedy(logits[:, -1])
            cur[live] = nxt[live]
            pos[live] += 1
            self.stats["decode_steps"] += 1
            self.stats["occupancy_sum"] += int(live.size)
            self.stats["block_util_sum"] += self.alloc.n_used / usable
            self.stats["peak_blocks"] = max(self.stats["peak_blocks"],
                                            self.alloc.n_used)
            step += 1.0
        self.stats["occupancy"] = (
            self.stats["occupancy_sum"] / max(1, self.stats["decode_steps"]))
        self.stats["block_util"] = (
            self.stats["block_util_sum"] / max(1, self.stats["decode_steps"]))
        self.stats["prefix_hit_rate"] = (
            self.stats["prefix_hit_blocks"]
            / max(1, self.stats["prefix_lookup_blocks"]))
        return requests


class VisionServeEngine:
    """Fixed-size waves of ``slots`` images through one forward.

    ``forward_fn(params, images, acfg) -> logits`` is any vision forward
    (``repro_torch.models.vision.cnn_forward`` / ``resnet_forward``); every
    conv in it resolves a :func:`~repro_torch.core.acu.conv_plan`, so with
    a fused LUT ``acfg`` on the card the whole stack runs the fused CUDA
    kernels. Waves run under ``torch.inference_mode()`` on ``device``
    (``cuda`` unless given; ``params`` must already live there).
    """

    def __init__(self, params, forward_fn: Callable, *, slots: int = 8,
                 acfg=None, device=None, mesh=None):
        self.params = params
        self.slots = slots
        self.acfg = acfg
        self.device = resolve_device(device)
        self._forward = forward_fn
        self._mesh_scope = _mesh_scope(mesh)

    def plan_report(self, image_shape, w_shape, acfg, **geom) -> dict:
        """The conv route one layer takes under the engine's mesh (see
        :func:`repro_torch.core.approx_ops.conv_plan_report`)."""
        from repro_torch.core.approx_ops import conv_plan_report
        with self._mesh_scope():
            return conv_plan_report(image_shape, w_shape, acfg, **geom)

    def run(self, images: np.ndarray) -> np.ndarray:
        """images: (B, C, H, W) -> logits (B, n_classes), served in waves
        of ``slots`` (the last wave zero-padded and sliced)."""
        b = images.shape[0]
        outs = []
        for i in range(0, b, self.slots):
            wave = np.asarray(images[i:i + self.slots], np.float32)
            pad = self.slots - wave.shape[0]
            if pad:
                wave = np.concatenate(
                    [wave, np.zeros((pad, *wave.shape[1:]), wave.dtype)])
            x = torch.from_numpy(wave).to(self.device)
            with torch.inference_mode(), self._mesh_scope():
                logits = self._forward(self.params, x, self.acfg)
            outs.append(logits.cpu().numpy()[:self.slots - pad])
        return np.concatenate(outs, axis=0)
