"""Public wrappers of the flash attention kernels: the exact one
(``csrc/flash_attention.cu``, kernel 11) and the approximate one
(``csrc/approx_flash_attention.cu``) over contiguous KV (kernel 8) and
block-paged KV (kernel 9).

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version in ``ref.py``. Kernel 11 reads q, k and v through their strides
and writes its output in q's layout, so attention over (B, S, H, D)
tensors passes ``transpose(1, 2)`` views and copies nothing. The
approximate wrappers read the same geometry, default ``rowinfo`` and
pinned scales from ``prepare_approx_attention`` / ``_paged``. The kernel
pads nothing: it reads Q, K and V where they lie, through their strides, in
their own dtype (float32 or bfloat16, converted to float32 on staging), so
a ``(B, H, S, D)`` view of a ``(B, S, H, D)`` cache is taken as it is.

``BQ`` and ``BK`` are the largest q and KV tiles; each call shrinks them
for short sequences as the reference does (``prepare_approx_attention``).
``row_heads`` lets the heads of one batch row share one ``rowinfo`` (and
page-table) row, so a caller passes its (B, 3) extents as they are.

A call with at most 8 query rows per (batch row, KV head) runs one of the
kernel's two decode paths (:func:`decode_plan`): one work item per (batch
row, KV head) with its ``rep`` query heads, so each key is read and
quantized once per item. Paged calls stream 16-key pages; contiguous calls
stream 32 keys of K, then of V, a stage, for each of the reference's
``bk`` blocks. Each wrapper counts its launches (``launches``) and, of those, the
ones on the decode path (``decode_launches``); ``general=True`` pins the
general path.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Optional

import torch

from repro_torch.kernels import runtime
from .ref import (_rows, approx_attention_paged_ref, approx_attention_ref,
                  flash_attention_ref, flash_scale, prepare_approx_attention,
                  prepare_approx_attention_paged)

BQ = 128
BK = 128
FLASH_HEAD_DIMS = (64, 128)   # kernel 11's instantiations (every config's)
FLASH_KV_TILE = 64      # keys of one staged K/V tile (kernel 11's kBK)
FLASH_MAX_ROWS = 128    # query rows of one item: 8 warps of 16


DECODE_PAGE = 16        # the paged decode path's stage: one 16-key page
DECODE_CONTIG_KEYS = 32  # the contiguous one's: 32 keys (two 16-key
                         # tiles) of K or of V
DECODE_STAGES = 4       # their cp.async ring, in stages
DECODE_ITEM_WARPS = 8   # warps of one item: one a query row, the rest
                        # copy and quantize keys
DECODE_ITEMS = 2        # items of one block (512 threads), at most
SMEM_LIMIT = 232_448    # dynamic shared memory one block may use (H100)


def _r16(v: int) -> int:
    return (v + 15) // 16 * 16


@dataclass(frozen=True)
class DecodePlan:
    """A decode path for one call: items of ``heads`` query rows of the
    folded layout (``b = item * heads + t``), each row with its ``sq``
    query positions on a warp of the item's, ``per_block`` items in a
    block, ``grid`` blocks, ``smem`` bytes of shared memory.
    ``paged`` calls stream one 16-key page a stage; contiguous ones
    stream the 16-key tiles of K, then of V, of each ``bk`` block of keys
    (the reference's softmax step), two tiles a stage, on all 16 warps of
    a block that holds one item."""
    heads: int
    sq: int
    items: int
    per_block: int
    grid: int
    smem: int
    paged: bool = True
    bk: int = DECODE_PAGE

    def rows(self, item: int, rep: int, row_heads: int, kh: int):
        """(rowinfo row, KV row, query rows) of one item, as the kernel
        maps it: ``ir = b0 // row_heads`` and ``kvr = b0 // rep`` (``%
        kh``, the pool's heads, when paged) for its first row ``b0``,
        shared by all its rows."""
        b0 = item * self.heads
        kvr = b0 // rep
        return (b0 // row_heads, kvr % kh if self.paged else kvr,
                list(range(b0, b0 + self.heads)))


def decode_smem(n_codes: int, d: int, itemsize: int, per_block: int,
                n_kv: int, *, paged: bool = True,
                bk: int = DECODE_PAGE) -> int:
    """Shared memory of a decode path (``DecodeLayout`` and
    ``ContigLayout`` in the source): the int16 table, then per item a ring
    of 4 raw stages (a K and V page, or 32 keys of K or of V), code
    buffers for two stages (K rows of d + 8 bytes, transposed V rows of 20
    bytes, one of each a 16-key page or tile) and, paged, its page-table
    row of ``n_kv`` entries or, contiguous, 8 rows of ``bk`` float
    scores and of ``d`` Q codes (int table-row offsets)."""
    if paged:
        ring = DECODE_STAGES * 2 * DECODE_PAGE * d * itemsize
        slot = (ring + 2 * _r16(DECODE_PAGE * (d + 8))
                + 2 * _r16(d * (DECODE_PAGE + 4)) + _r16(4 * n_kv))
    else:
        ring = DECODE_STAGES * DECODE_CONTIG_KEYS * d * itemsize
        sub = _r16(max(DECODE_PAGE * (d + 8), d * (DECODE_PAGE + 4)))
        codes = DECODE_CONTIG_KEYS // DECODE_PAGE * sub
        slot = (ring + 2 * codes + _r16(DECODE_ITEM_WARPS * bk * 4)
                + _r16(DECODE_ITEM_WARPS * d * 4))
    return _r16(n_codes * n_codes * 2) + per_block * slot


def decode_plan(bh: int, sq: int, d: int, rep: int, row_heads: int,
                bk: int, itemsize: int, n_codes: int, n_kv: int,
                n_sm: int, *, paged: bool = True,
                bq: int = 8) -> Optional[DecodePlan]:
    """The decode path's plan for a call, or None when the call takes the
    general path: a head dim other than 64 or 128, more than 8 query rows
    per item, a paged call with pages of other than 16 keys, or a
    contiguous call whose ``bk`` is not a multiple of 32 or whose ``sq``
    rows span more than one q tile of ``bq``. The ``rep`` query heads of
    one KV head share an item when ``row_heads`` is a multiple of ``rep``
    (they then share a rowinfo and page-table row); otherwise each query
    row is an item of its own. Paged: two items a block where shared
    memory holds them, else one. Contiguous: one item a block, on all 16
    warps, while the items number no more than the SMs (each gets an SM
    of its own), else two of 8 warps where they fit."""
    heads = rep if row_heads % rep == 0 else 1
    if d not in (64, 128) or heads * sq > DECODE_ITEM_WARPS or bh % heads:
        return None
    if paged and bk != DECODE_PAGE:
        return None
    if not paged and (bk <= 0 or bk % DECODE_CONTIG_KEYS or sq > bq):
        return None
    items = bh // heads
    order = range(DECODE_ITEMS, 0, -1)
    if not paged and items <= n_sm:
        order = (1,)
    for per_block in order:
        smem = decode_smem(n_codes, d, itemsize, per_block, n_kv,
                           paged=paged, bk=bk)
        if smem <= SMEM_LIMIT:
            return DecodePlan(heads, sq, items, per_block,
                              min(n_sm, -(-items // per_block)), smem, paged,
                              bk)
    return None


def flash_smem(d: int, itemsize: int, rows: int) -> int:
    """Kernel 11's shared memory (``smem_bytes`` in the source): the
    scaled q of ``rows`` query rows split into TF32 hi and lo (float32
    each, in fragment order), then two stages of a K and a V tile of
    ``FLASH_KV_TILE`` keys in the operands' dtype, each row padded by 16
    bytes (ldmatrix's eight rows then fall in distinct banks)."""
    pitch = d + 16 // itemsize
    return rows * d * 8 + 4 * FLASH_KV_TILE * pitch * itemsize


@dataclass(frozen=True)
class FlashPlan:
    """Kernel 11's schedule for one call. A work item is one KV row with
    ``heads`` of its query heads (all ``rep`` where they fit) and a q tile
    of ``bq`` positions: ``(first query row, q0, first KV tile, end KV
    tile)`` in the folded layout (query row ``b`` reads KV row ``b //
    rep``), so each K/V tile is staged once for all of them; one block of
    ``heads * bq / 16`` warps an item, ``smem`` bytes of shared memory,
    items heaviest (most KV tiles) first."""
    heads: int
    bq: int
    smem: int
    items: tuple
    bk = FLASH_KV_TILE

    @property
    def warps(self) -> int:
        return self.heads * self.bq // 16

    def kv_range(self) -> tuple[list[int], list[int]]:
        """(first, end) KV tile of each q tile, in q tile order (every KV
        row's items of a q tile share it)."""
        rng = {q0 // self.bq: (lo, hi) for _, q0, lo, hi in self.items}
        return ([rng[i][0] for i in sorted(rng)],
                [rng[i][1] for i in sorted(rng)])

    def drop_last_tile(self, index: int = 0) -> "FlashPlan":
        """The same plan with item ``index``'s last KV tile dropped (a
        planted fault)."""
        items = list(self.items)
        b0, q0, lo, hi = items[index]
        items[index] = (b0, q0, lo, hi - 1)
        return replace(self, items=tuple(items))


def flash_shape(rep: int, d: int, itemsize: int) -> tuple[int, int]:
    """(heads, bq) of an item: the most of a KV row's ``rep`` query heads
    (a divisor of ``rep``, at most 8), then the longest q tile of 128, 64,
    32 or 16 positions, that give at most ``FLASH_MAX_ROWS`` rows and fit
    ``SMEM_LIMIT``."""
    for heads in range(min(rep, 8), 0, -1):
        if rep % heads:
            continue
        for bq in (128, 64, 32, 16):
            rows = heads * bq
            if (rows <= FLASH_MAX_ROWS
                    and flash_smem(d, itemsize, rows) <= SMEM_LIMIT):
                return heads, bq
    raise ValueError(f"no kernel 11 item fits head dim {d}")


@functools.lru_cache(maxsize=64)
def flash_plan(bh: int, sq: int, sk: int, rep: int, causal: bool,
               window: Optional[int], d: int, itemsize: int) -> FlashPlan:
    """Kernel 11's work items for ``bh`` folded query rows of ``sq``
    positions over ``sk`` keys, ``rep`` query rows a KV row, head dim
    ``d``, K and V of ``itemsize`` bytes.

    Each item walks KV tiles from the first that any of its rows can see
    to the causal bound (the tile of its last real row's own key; every
    tile without ``causal``). Skipping the leading tiles is exact: where
    the reference walks a tile that masks every key of a row, that row
    holds ``m = -1e30``, ``p = 1``, ``l = 64``, and the row's first
    visible tile wipes it out with ``alpha = exp(-1e30 - m') = 0``. So an
    item starts at tile 0 only where one of its rows sees no key at all
    (its output is the mean of the keys the reference walks). The
    reference's causal bound may add one tile past the diagonal; it masks
    every key of the item (``p = 0``, ``alpha = 1``), so stopping before it
    is exact too. Items are ordered heaviest first, so the card's block
    scheduler starts the longest walks first."""
    heads, bq = flash_shape(rep, d, itemsize)
    bk = FLASH_KV_TILE
    n_kv = -(-sk // bk)
    ranges = []
    for q0 in range(0, sq, bq):
        last = min(q0 + bq, sq) - 1
        end = min(n_kv, last // bk + 1) if causal else n_kv
        # row i sees keys [lo_i, hi_i]; lo_i - hi_i falls, holds, then
        # rises as i grows, so the first and last rows decide whether
        # every row sees one
        first = 0
        if window is not None and all(
                max(0, i - window + 1) <= (min(i, sk - 1) if causal
                                           else sk - 1) for i in (q0, last)):
            first = min(max(0, q0 - window + 1) // bk, end)
        ranges.append((q0, first, end))
    items = [(kv * rep + h0, q0, first, end)
             for q0, first, end in ranges
             for kv in range(bh // rep) for h0 in range(0, rep, heads)]
    items.sort(key=lambda it: it[2] - it[3])        # stable: heaviest first
    return FlashPlan(heads, bq, flash_smem(d, itemsize, heads * bq),
                     tuple(items))


@functools.lru_cache(maxsize=64)
def _plan_items(plan: FlashPlan, device: torch.device) -> torch.Tensor:
    """The plan's items as the (n, 4) int32 tensor the kernel reads."""
    return torch.tensor(plan.items, dtype=torch.int32,
                        device=device).reshape(-1, 4)


def _aligned16(t: torch.Tensor) -> bool:
    """K or V rows that the decode paths copy 16 bytes at a time: the
    base, every stride but the last and a row of ``d`` elements all
    multiples of 16 bytes."""
    es = t.element_size()
    return (t.data_ptr() % 16 == 0 and t.shape[-1] * es % 16 == 0
            and all(s * es % 16 == 0 for s in t.stride()[:-1]))


@functools.lru_cache(maxsize=256)
def visible_pairs(sq: int, sk: int, causal: bool, window: Optional[int],
                  q_start: int) -> int:
    """(query, key) pairs one query row sees: queries at positions
    ``q_start .. q_start + sq - 1``, keys ``0 .. sk - 1``, a key at or
    before its query when ``causal`` and within ``window`` of it."""
    total = 0
    for p in range(q_start, q_start + sq):
        hi = min(p, sk - 1) if causal else sk - 1
        lo = max(0, p - window + 1) if window is not None else 0
        total += max(0, hi - lo + 1)
    return total


def _meta_attention(name: str, q, kv_bytes: int, lut, seq_k: int, causal,
                    window, extra_bytes: int = 0) -> torch.Tensor:
    """Shape rule of kernels 8 and 9 on ``meta`` operands: a (B*Hq, Sq, D)
    float32 result; 2 D lookups per visible (query, key) pair, the rows
    end-aligned over the whole key sequence (the default ``rowinfo``: a
    cache filled to ``seq_k``, whose values a ``meta`` tensor does not
    hold)."""
    rows = q.shape[0] * (q.shape[1] if q.dim() == 4 else 1)
    sq, d = q.shape[-2], q.shape[-1]
    pairs = visible_pairs(sq, seq_k, causal, window, seq_k - sq)
    runtime.count_work(name, lookups=2 * d * rows * pairs,
                       bytes_=runtime.nbytes(q) + kv_bytes + lut.numel() * 2
                       + extra_bytes + rows * sq * d * 4)
    return runtime.meta_empty(rows, sq, d, dtype=torch.float32)


def _folded(t: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) -> (B*H, S, D) for the plain version (a copy where the
    view does not fold)."""
    return t.reshape(-1, *t.shape[-2:]) if t.dim() == 4 else t


def _addressing(t: torch.Tensor, name: str, paged: bool = False):
    """(heads per batch row, batch stride, head stride, position stride) of
    a (rows, S, D) or (B, H, S, D) operand, or of a (Hkv, P, bk, D) pool
    whose blocks lie back to back. The last dim must be dense."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must be dense along its last dim")
    if paged:
        if t.stride(1) != t.shape[2] * t.stride(2):
            raise ValueError(f"{name}'s blocks must lie back to back")
        return t.shape[0], 0, t.stride(0), t.stride(2)
    if t.dim() == 3:
        return 1, t.stride(0), 0, t.stride(1)
    if t.dim() == 4:
        return t.shape[1], t.stride(0), t.stride(1), t.stride(2)
    raise ValueError(f"{name} must be 3-D or 4-D, got {tuple(t.shape)}")


def _per_row(t, row_heads: int):
    """Rows shared by ``row_heads`` query rows, one per query row (for the
    plain versions, on the CPU)."""
    if t is None or row_heads == 1:
        return t
    return torch.as_tensor(t).repeat_interleave(row_heads, dim=0)


def _launch(q, k, v, lut_flat, info, page_table, scales, st: dict, counted,
            *, seq_k: int, n_kv: int, rep: int, row_heads: int, causal: bool,
            window: Optional[int], softcap: Optional[float],
            paged: bool, general: bool = False) -> torch.Tensor:
    """Launch the kernel (on the decode path where :func:`decode_plan`
    has one, unless ``general``) and add one to ``counted.launches`` (and
    to ``counted.decode_launches`` on the decode path)."""
    if not q.dtype == k.dtype == v.dtype or q.dtype not in (torch.float32,
                                                            torch.bfloat16):
        q, k, v = (t.to(torch.float32) for t in (q, k, v))   # exact
    dev = q.device
    table = runtime.lut_to_int16(lut_flat)
    runtime.check_cuda_operand(table, "lut", torch.int16, dev)
    runtime.check_cuda_operand(info, "rowinfo", torch.int32, dev)
    if page_table is not None:
        runtime.check_cuda_operand(page_table, "page_table", torch.int32, dev)
    for t, name in ((k, "k"), (v, "v")):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    qh, *q_addr = _addressing(q, "q")
    kh, *k_addr = _addressing(k, "k", paged)
    _, *v_addr = _addressing(v, "v", paged)
    bh, sq, d = _rows(q)
    out = torch.empty((bh, sq, d), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = runtime.kernel_library("approx_flash_attention")
    blocks, stream = runtime.launch_config(q)
    plan = None
    if not general and _aligned16(k) and _aligned16(v):
        plan = decode_plan(bh, sq, d, rep, row_heads, st["bk"],
                           k.element_size(), st["n_codes"], n_kv, blocks,
                           paged=paged, bq=st["bq"])
    lib.check(lib.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(),
        info.data_ptr(),
        None if page_table is None else page_table.data_ptr(),
        *(s.data_ptr() for s in scales), out.data_ptr(),
        int(q.dtype == torch.bfloat16), bh, sq, d, seq_k, st["bq"],
        st["bk"], n_kv, rep, qh, kh, row_heads, *q_addr, *k_addr, *v_addr,
        st["n_codes"], st["offset"], st["lo"], st["hi"], int(causal),
        -1 if window is None else int(window), int(softcap is not None),
        0.0 if softcap is None else float(softcap), int(paged),
        plan.heads if plan else 0, plan.per_block if plan else 0, blocks,
        stream))
    counted.launches += 1
    if plan is not None:
        counted.decode_launches += 1
    return out


def approx_flash_attention(q, k, v, lut, offset: int, q_scale, k_scale,
                           v_scale, *, bits: int = 8, causal: bool = True,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None, rowinfo=None,
                           row_heads: int = 1, bq: int = BQ,
                           bk: int = BK,
                           general: bool = False) -> torch.Tensor:
    """Approximate GQA flash attention on the ACU (kernel 8).

    ``q``: (B*Hq, Sq, D) or (B, Hq, Sq, D) float; ``k``/``v``: (B*Hkv, Sk,
    D) or (B, Hkv, Sk, D), ``Hq % Hkv == 0`` (query row ``b`` of the folded
    layout reads KV row ``b // rep``); ``lut`` the product table (int32, or
    int16 from :func:`runtime.lut_to_int16`) with shifted-code ``offset``;
    per-tensor symmetric scales (``inline_symmetric_scale``); ``rowinfo``
    optional (B*Hq / ``row_heads``, 3) int32 ``[q_base, kv_start,
    kv_len]``, default end-aligned over the whole key sequence;
    ``general=True`` pins the general path where :func:`decode_plan`
    would take the contiguous decode path (the CPU's plain version is the
    same function either way). Returns (B*Hq, Sq, D) float32.
    """
    if q.device.type == "cpu":
        return approx_attention_ref(
            _folded(q), _folded(k), _folded(v), lut, offset, q_scale,
            k_scale, v_scale, bits=bits, causal=causal, window=window,
            softcap=softcap, rowinfo=_per_row(rowinfo, row_heads), bq=bq,
            bk=bk)
    if q.device.type == "meta":
        return _meta_attention("approx_flash_attention", q,
                               runtime.nbytes(k, v, rowinfo), lut,
                               k.shape[-2], causal, window)
    ops, st = prepare_approx_attention(
        q, k, v, lut, offset, q_scale, k_scale, v_scale, bits=bits,
        rowinfo=rowinfo, bq=bq, bk=bk, pad=False, row_heads=row_heads)
    _, _, _, lut_flat, info, *scales = ops
    sk = st["seq_k_real"]
    return _launch(q, k, v, lut_flat, info, None, scales, st,
                   approx_flash_attention, seq_k=sk,
                   n_kv=-(-sk // st["bk"]), rep=st["rep"],
                   row_heads=row_heads, causal=causal, window=window,
                   softcap=softcap, paged=False, general=general)


approx_flash_attention.launches = 0
approx_flash_attention.decode_launches = 0


def approx_flash_attention_paged(q, k_pool, v_pool, lut, offset: int,
                                 q_scale, k_scale, v_scale, *, rowinfo,
                                 page_table, rep: int, bits: int = 8,
                                 causal: bool = True,
                                 window: Optional[int] = None,
                                 softcap: Optional[float] = None,
                                 row_heads: int = 1,
                                 bq: int = BQ) -> torch.Tensor:
    """Approximate GQA flash attention over block-paged KV (kernel 9).

    ``q``: (B*Hq, Sq, D) or (B, Hq, Sq, D) float; ``k_pool``/``v_pool``:
    (Hkv, P, bk, D), the physical block pool shared by every row (blocks
    back to back); ``page_table``: (B*Hq / ``row_heads``, n_logical) int32
    physical block of each logical block; ``rowinfo``: (B*Hq /
    ``row_heads``, 3) int32 logical ``[q_base, kv_start, kv_len]``,
    required. Query row ``b`` reads pool head ``(b //
    rep) % Hkv``. Returns (B*Hq, Sq, D) float32, equal to the contiguous
    kernel at ``bk`` = the block size on the gathered blocks.
    """
    if q.device.type == "cpu":
        return approx_attention_paged_ref(
            _folded(q), k_pool, v_pool, lut, offset, q_scale, k_scale,
            v_scale, rowinfo=_per_row(rowinfo, row_heads),
            page_table=_per_row(page_table, row_heads), rep=rep, bits=bits,
            causal=causal, window=window, softcap=softcap, bq=bq)
    if q.device.type == "meta":
        n_logical, bk = page_table.shape[1], k_pool.shape[2]
        rows_kv = q.shape[0] * (q.shape[1] if q.dim() == 4 else 1) // rep
        return _meta_attention(
            "approx_flash_attention_paged", q,
            2 * rows_kv * n_logical * bk * k_pool.shape[-1]
            * k_pool.element_size(), lut, n_logical * bk, causal, window,
            runtime.nbytes(page_table, rowinfo))
    ops, st = prepare_approx_attention_paged(
        q, k_pool, v_pool, lut, offset, q_scale, k_scale, v_scale,
        bits=bits, rowinfo=rowinfo, page_table=page_table, bq=bq, pad=False,
        row_heads=row_heads)
    _, _, _, lut_flat, info, pt, *scales = ops
    n_logical = pt.shape[1]
    return _launch(q, k_pool, v_pool, lut_flat, info, pt, scales, st,
                   approx_flash_attention_paged, seq_k=n_logical * st["bk"],
                   n_kv=n_logical, rep=rep, row_heads=row_heads,
                   causal=causal, window=window, softcap=softcap, paged=True)


approx_flash_attention_paged.launches = 0
approx_flash_attention_paged.decode_launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    plan: Optional[FlashPlan] = None) -> torch.Tensor:
    """Exact GQA flash attention (kernel 11), float32 inside.

    ``q``: (B*Hq, Sq, D) or (B, Hq, Sq, D); ``k``/``v``: (B*Hkv, Sk, D) or
    (B, Hkv, Sk, D), ``Hq % Hkv == 0`` (query row ``b`` of the folded
    layout reads KV row ``b // rep``), any strides with a dense last dim.
    Queries are aligned to key 0: query row ``i`` sits at position ``i``.
    Returns q's shape and dtype, laid out as q (``torch.empty_like``).
    ``plan`` pins a :class:`FlashPlan` (a planted fault); by default
    :func:`flash_plan` makes it. K and V rows that are not 16-byte aligned
    (the kernel copies them 16 bytes at a time) are copied contiguous
    first."""
    rows_q = q.shape[0] * (q.shape[1] if q.dim() == 4 else 1)
    rows_k = k.shape[0] * (k.shape[1] if k.dim() == 4 else 1)
    if v.shape != k.shape or rows_k == 0 or rows_q % rows_k:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: not a GQA grouping")
    rep = rows_q // rows_k
    if q.device.type == "cpu":
        return flash_attention_ref(
            _folded(q), _folded(k), _folded(v), causal=causal, window=window,
            softcap=softcap, rep=rep).reshape(q.shape)
    if q.device.type == "meta":
        sq, sk, d = q.shape[-2], k.shape[-2], q.shape[-1]
        pairs = visible_pairs(sq, sk, causal, window, 0)
        runtime.count_work("flash_attention", flops=4 * d * rows_q * pairs,
                           bytes_=runtime.nbytes(q, k, v, q))
        return torch.empty_like(q)
    dtype = q.dtype
    if not q.dtype == k.dtype == v.dtype or dtype not in (torch.float32,
                                                           torch.bfloat16):
        q, k, v = (t.to(torch.float32) for t in (q, k, v))   # exact
    d = q.shape[-1]
    if d not in FLASH_HEAD_DIMS or k.shape[-1] != d:
        raise ValueError(f"the flash attention kernel takes head dims "
                         f"{FLASH_HEAD_DIMS}, got q {d}, k {k.shape[-1]}")
    for t, name in ((k, "k"), (v, "v")):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
    k, v = (t if _aligned16(t) else t.contiguous() for t in (k, v))
    out = torch.empty_like(q)
    qh, *q_addr = _addressing(q, "q")
    kh, *k_addr = _addressing(k, "k")
    _, *v_addr = _addressing(v, "v")
    _, *o_addr = _addressing(out, "out")
    sq, sk = q.shape[-2], k.shape[-2]
    if out.numel() == 0:
        return out.to(dtype)
    if plan is None:
        plan = flash_plan(rows_q, sq, sk, rep, bool(causal), window, d,
                          k.element_size())
    items = _plan_items(plan, q.device)
    lib = runtime.kernel_library("flash_attention")
    _, stream = runtime.launch_config(q)
    lib.check(lib.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        items.data_ptr(), items.shape[0], int(q.dtype == torch.bfloat16),
        rows_q, sq, sk, d, rep, qh, kh, plan.bq, plan.warps, *q_addr,
        *k_addr, *v_addr, *o_addr, int(causal),
        -1 if window is None else int(window), int(softcap is not None),
        0.0 if softcap is None else float(softcap), float(flash_scale(d)),
        plan.smem, stream))
    flash_attention.launches += 1
    return out.to(dtype)


flash_attention.launches = 0
