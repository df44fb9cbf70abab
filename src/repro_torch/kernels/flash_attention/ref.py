"""Plain PyTorch versions of the attention kernels: the exact oracle, the
exact flash attention (kernel 11, ``csrc/flash_attention.cu``), and the
approximate flash attention over contiguous and paged KV (kernels 8 and 9),
which the CUDA kernel in ``csrc/approx_flash_attention.cu`` is held
against.

The exact flash attention (:func:`flash_attention_ref`) follows the
reference's ``repro.kernels.flash_attention.kernel``: float32 throughout,
``q * (1 / sqrt(D))`` before ``q @ k.T``, the softcap ``c * tanh(s / c)``,
the causal and window masks with queries aligned to key 0 (query row ``i``
sits at position ``i``), masked scores the finite ``NEG_INF``, an online
softmax over KV tiles and ``acc / max(l, 1e-30)`` in q's dtype. Where the
reference asserts whole tiles, a ragged edge is masked: query rows past
``Sq`` are dropped, keys past ``Sk`` get ``-inf`` (``p = 0``, as if absent).

The approximate versions follow the reference's semantics
(``repro.kernels.flash_attention.approx``) operation for operation:

* Q, K and V are quantized per-tensor symmetric, ``clip(round(x / s))``;
* QK^T is an int32 LUT-gather GEMM over the head dim padded to ``dp``
  (pad entries are code 0 and are corrected as ``(dp - d) * M00``),
  dequantized by the pinned ``score_scale``;
* softcap, the ``rowinfo = [q_base, kv_start, kv_len]`` extents, the causal
  and window masks (masked scores are the finite ``NEG_INF``);
* the online softmax over KV blocks of exactly ``bk`` keys: ``p`` is taken
  relative to the running max at the end of each block, the normalizer
  ``l`` sums the float ``p``, and ``p`` is quantized to
  ``clip(round(p * hi), 0, hi)``; PV is a second LUT-gather GEMM over the
  block, Sk-pad corrected, dequantized by ``pv_scale``;
* a masked key gets ``p = 0`` (code 0) and still adds ``LUT[0, v]``;
* the causal block bound of the padded q tile decides how many KV blocks a
  tile runs, even where its padding rows are the only ones that reach a
  block.

Where the reference loops over (row, q tile) on a grid, this version runs
every tile at once and walks KV blocks to the largest bound, freezing a
tile's state past its own bound. :func:`_online_block` is the one per-block
update both versions drive; they differ only in where block ``ki`` of a row
is read (``ki * bk`` in the row's own K/V, or ``page_table[ki] * bk`` in
the shared pool).

Float rounding: ``exp`` and ``tanh`` round differently from XLA's, which
may also contract ``a * b + c`` into an FMA, so a probability sitting on a
code boundary can round to the neighbouring code. The integer work (codes,
LUT accumulators, pad corrections, block bounds) is the reference's
exactly; the float output differs by at most one table step times
``pv_scale`` for each flipped code (the tests state the bound).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30            # finite: an all-masked block gives p = exp(0)

# int64 gather indices per chunk of a LUT GEMM: 4 Mi entries (32 MiB)
_CHUNK_ELEMS = 1 << 22


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None) -> torch.Tensor:
    """Exact attention. q: (BH, Sq, D), k/v: (BH, Sk, D); queries are
    aligned to the END of the key sequence when Sq != Sk (decode)."""
    sq, d = q.shape[1], q.shape[2]
    sk = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.to(torch.float32)) / (d ** 0.5)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p,
                        v.to(torch.float32)).to(q.dtype)


# the plain version's q and KV tiles; the CUDA kernel's KV tile (its q
# tile is its plan's, ``ops.py: flash_plan``)
FLASH_BQ = 64
FLASH_BK = 64


def flash_scale(d: int) -> torch.Tensor:
    """``float32(1 / sqrt(d))``: the reference multiplies float32 q by the
    Python float, which rounds it to float32 once."""
    return torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)


def _flash_walk(q, k, v, *, causal, window, softcap, rep, bq, bk, kv_range,
                qk, pv) -> torch.Tensor:
    """The online softmax of :func:`flash_attention_ref` over KV tiles, with
    the two products ``qk(q_scaled, k_tile)`` -> scores and ``pv(p,
    v_tile)`` -> the tile's ``p @ v`` given. ``kv_range``: per q tile its
    first and end KV tile (default 0 and the reference's causal bound); a
    tile's state is frozen outside its range."""
    from repro_torch.core.approx_ops import exact_f32
    bh, sq, d = q.shape
    sk = k.shape[1]
    if bh != k.shape[0] * rep or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not fit rep={rep}")
    dev = q.device
    sq_p, sk_p = _round_up(max(sq, 1), bq), _round_up(max(sk, 1), bk)
    qf = torch.zeros((bh, sq_p, d), dtype=torch.float32, device=dev)
    qf[:, :sq] = q.to(torch.float32) * flash_scale(d).to(dev)
    rows = torch.arange(bh, device=dev) // rep
    kf = torch.zeros((bh, sk_p, d), dtype=torch.float32, device=dev)
    vf = torch.zeros((bh, sk_p, d), dtype=torch.float32, device=dev)
    kf[:, :sk] = k.to(torch.float32)[rows]
    vf[:, :sk] = v.to(torch.float32)[rows]
    n_q, n_kv = sq_p // bq, sk_p // bk
    tiles = torch.arange(n_q, device=dev)
    if kv_range is None:
        start = torch.zeros((n_q,), dtype=torch.long, device=dev)
        bound = (torch.clamp_max((tiles + 1) * bq // bk + 1, n_kv) if causal
                 else torch.full((n_q,), n_kv, device=dev))
    else:
        start, bound = (torch.as_tensor(t, dtype=torch.long, device=dev)
                        for t in kv_range)
    q_pos = torch.arange(sq_p, device=dev)[:, None]
    m = torch.full((bh, sq_p), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((bh, sq_p), dtype=torch.float32, device=dev)
    acc = torch.zeros((bh, sq_p, d), dtype=torch.float32, device=dev)
    with exact_f32():
        for ki in range(int(bound.max()) if n_kv and n_q else 0):
            k_pos = ki * bk + torch.arange(bk, device=dev)[None, :]
            s = qk(qf, kf[:, ki * bk:(ki + 1) * bk])
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            mask = torch.ones((sq_p, bk), dtype=torch.bool, device=dev)
            if causal:
                mask &= k_pos <= q_pos
            if window is not None:
                mask &= k_pos > q_pos - window
            s = torch.where(mask, s, NEG_INF)
            s = torch.where(k_pos < sk, s, -math.inf)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l_new = alpha * l + p.sum(-1)
            acc_new = acc * alpha[..., None] + pv(
                p, vf[:, ki * bk:(ki + 1) * bk])
            live = ((ki >= start) & (ki < bound)).repeat_interleave(bq)
            m = torch.where(live, m_new, m)
            l = torch.where(live, l_new, l)
            acc = torch.where(live[:, None], acc_new, acc)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out[:, :sq].to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None, rep: int = 1,
                        bq: int = FLASH_BQ, bk: int = FLASH_BK,
                        kv_range=None) -> torch.Tensor:
    """Exact flash attention (kernel 11). q: (BH, Sq, D); k/v: (BH / rep,
    Sk, D); query row ``b`` reads KV row ``b // rep``. Returns (BH, Sq, D)
    in q's dtype.

    Every q tile runs at once; KV tiles of ``bk`` keys are walked to the
    largest causal block bound, ``min(n_kv, (qi + 1) * bq // bk + 1)`` as
    the reference computes it, and a tile's state is frozen past its own.
    (A causal row has seen its own key by its bound, so the blocks past it
    would add exactly nothing; the freeze mirrors the reference's loop.)
    ``kv_range`` = (first, end) KV tile per q tile walks those instead, as
    the kernel's plan does (``ops.py: flash_plan``)."""
    return _flash_walk(
        q, k, v, causal=causal, window=window, softcap=softcap, rep=rep,
        bq=bq, bk=bk, kv_range=kv_range,
        qk=lambda qf, kt: qf @ kt.transpose(1, 2), pv=lambda p, vt: p @ vt)


def flash_attention_tf32_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: Optional[int] = None,
                             softcap: Optional[float] = None, rep: int = 1,
                             passes: Optional[int] = None,
                             plan=None) -> torch.Tensor:
    """What kernel 11's tensor-core products compute, in float32 on the
    CPU: every operand of QK and PV split as the kernel splits it
    (``err_matmul/ref.py: tf32_split``, Veltkamp's hi and the rest read as
    TF32; a TF32 product is exact in float32), walked on the kernel's
    ``plan`` (default ``ops.py: flash_plan``'s): its q tile and each q
    tile's KV range.

    ``passes=2`` (bfloat16 k and v, exact in TF32): scores ``(q_hi . k) +
    (q_lo . k)`` of the scaled q, ``p_hi . v + p_lo . v``. ``passes=3``
    (float32 k and v): ``q_hi . k_hi + (q_hi . k_lo + q_lo . k_hi)``, and
    so for PV. ``passes=1``: one plain TF32 pass, the hi terms alone.
    Default: 2 for bfloat16 k and v, else 3. The emulation sums each
    product in its own order, as the tensor core does in another: it is
    held within ``flash_tolerance``, not bit for bit."""
    from repro_torch.kernels.err_matmul.ref import tf32_split
    from .ops import flash_plan
    if passes is None:
        passes = 2 if k.dtype == v.dtype == torch.bfloat16 else 3
    if plan is None:
        plan = flash_plan(q.shape[0], q.shape[1], k.shape[1], rep, causal,
                          window, q.shape[2], k.element_size())

    def product(a, b):
        """``a @ b`` on split operands: b (k or v) exact in TF32 at 2
        passes, split at 3."""
        ah, al = tf32_split(a)
        if passes == 1:
            return ah @ tf32_split(b)[0]
        if passes == 2:
            return ah @ b + al @ b
        bh_, bl = tf32_split(b)
        return ah @ bh_ + (ah @ bl + al @ bh_)

    return _flash_walk(
        q, k, v, causal=causal, window=window, softcap=softcap, rep=rep,
        bq=plan.bq, bk=plan.bk, kv_range=plan.kv_range(),
        qk=lambda qf, kt: product(qf, kt.transpose(1, 2)), pv=product)


def flash_tolerance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    want: torch.Tensor, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    rep: int = 1) -> torch.Tensor:
    """How far two float32 implementations of :func:`flash_attention_ref`
    may disagree, per output element ((BH, Sq, D), shapes as there), once
    each rounds its output to ``want``'s dtype.

    Both scale q the same way and walk the same key tiles; they differ in
    the order of each tile's sums and in the last ulp of ``exp`` and
    ``tanh``. Those rounding errors are independent, so they add like a
    random walk (the worst case, every error of one sign, is linear in
    the count and lies orders of magnitude above what occurs):

    * the scores: a D-term dot product in another order moves a score by
      about ``eps * |q_row * scale| * max|k|``, the softcap's ``tanh`` by
      a few ulp of ``|s|`` (its slope is at most 1); a score error ``e``
      moves the output by at most ``e * max|v|``;
    * the softmax: the numerator ``sum p v`` and the normalizer ``l`` over
      the row's ``n`` visible keys, about ``sqrt(n)`` ulp of ``max|v|``;
    * the output: one ulp of its dtype at the element.

    So ``eps * max|v| * 4 * (sqrt(n) + |q_row * scale| * max|k|) +
    eps_out * |want|``. The factor 4 is a margin: float32 against float64
    stays within a tenth of it, and one key less in a row's window, the
    first KV tile dropped or the softcap dropped each lie beyond it
    (``tests/test_torch_flash.py``, 512 keys, unit and 10x scores, softcap
    50; ``chip_smoke.py`` reads the same at gemma2-27b's 4352 keys). A row
    whose keys are all masked averages every key (``n = Sk``)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    dev = q.device
    eps = float(torch.finfo(torch.float32).eps)
    rows = torch.arange(bh, device=dev) // rep
    i = torch.arange(sq, device=dev)
    hi = torch.clamp_max(i + 1, sk) if causal else torch.full_like(i, sk)
    lo = torch.clamp_min(i - window + 1, 0) if window is not None \
        else torch.zeros_like(i)
    n = torch.clamp_min(hi - lo, 0)
    n = torch.where(n > 0, n, sk).to(torch.float64)
    qn = torch.linalg.vector_norm(q.double(), dim=-1) \
        * float(flash_scale(d))                                       # (BH, Sq)
    kmax = torch.linalg.vector_norm(k.double(), dim=-1).amax(-1)[rows]
    vmax = v.double().abs().amax((-2, -1))[rows]
    f32 = 4 * eps * vmax[:, None] * (n.sqrt() + qn * kmax[:, None])
    eps_out = float(torch.finfo(want.dtype).eps)
    return f32[..., None] + eps_out * want.double().abs()


def quantize_sym(x: torch.Tensor, scale: torch.Tensor, lo: int,
                 hi: int) -> torch.Tensor:
    """Per-tensor symmetric codes ``clip(round(x / s), lo, hi)`` (int64),
    in float32 with a true divide by a tensor."""
    return torch.clamp(torch.round(x.to(torch.float32) / scale), lo,
                       hi).to(torch.int64)


def attn_scales(q_scale: torch.Tensor, k_scale: torch.Tensor,
                v_scale: torch.Tensor, d_real: int, hi: int):
    """The two combined dequant scales, computed outside the kernel as the
    reference pins them: ``score = (sq * sk) * f32(1 / sqrt(d))`` and
    ``pv = sv * f32(1 / hi)``, each product rounded to float32."""
    from repro_torch.core.quantization import device_scalar
    dev = q_scale.device
    # float32(1 / sqrt(d)) and float32(1 / hi): the doubles rounded once
    inv_sqrt_d = device_scalar(
        torch.tensor(1.0 / math.sqrt(d_real), dtype=torch.float32).item(),
        dev)
    score = (q_scale * k_scale) * inv_sqrt_d
    pv = v_scale * device_scalar(
        torch.tensor(1.0 / hi, dtype=torch.float32).item(), dev)
    return score, pv


def causal_block_bound(q_base: torch.Tensor, qi, bq: int, bk: int,
                       n_kv: int) -> torch.Tensor:
    """One past the last KV block any query row of tile ``qi`` can see, for
    the whole padded tile (``q_base`` shifts it to its absolute cache
    position). Blocks past it never run, which is observable under a
    biased multiplier (``M[0, x] != 0``)."""
    return torch.clamp_max((q_base + (qi + 1) * bq - 1) // bk + 1, n_kv)


def code_flip_bound(lut, offset: int, hi: int, pv_scale) -> float:
    """How far one output element moves when one probability code moves
    by one step: ``max |LUT[c + 1, v] - LUT[c, v]| * pv_scale`` over the
    codes ``c`` in ``[0, hi)`` and every ``v``. Implementations whose
    ``exp`` rounds differently agree within this per flipped key."""
    t = torch.as_tensor(lut).reshape(-1).to(torch.int64)
    n = int(round(t.numel() ** 0.5))
    rows = t.reshape(n, n)[offset:offset + hi + 1]
    step = int((rows[1:] - rows[:-1]).abs().max())
    return step * float(torch.as_tensor(pv_scale).reshape(-1)[0])


def same_device_agreement(got: torch.Tensor, want: torch.Tensor, lut,
                          offset: int, hi: int, pv_scale, bk: int) -> dict:
    """How a kernel's output agrees with its plain version run on the same
    device (the same ``expf``, ``tanhf`` and half-to-even rounding, so the
    codes agree and only summation order differs). ``ulp_tol`` is ``4 * bk
    * eps * max|want|``: the normalizer and the accumulator each sum a
    block of ``bk`` terms in another order. ``flip_rows`` counts the query
    rows ((rows, Sq) of a (rows, Sq, D) output) holding an element beyond
    it; ``within_flip`` says whether every element is within ``ulp_tol``
    plus one probability-code flip (:func:`code_flip_bound`). A caller
    allows a small stated number of flipped rows and no more."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    ulp_tol = 4 * bk * float(torch.finfo(torch.float32).eps) \
        * float(want.abs().max())
    flip_tol = code_flip_bound(lut, offset, hi, pv_scale)
    return {"ulp_tol": ulp_tol, "flip_tol": flip_tol,
            "flip_rows": int((err > ulp_tol).any(-1).sum()),
            "within_flip": bool(err.max() <= ulp_tol + flip_tol),
            "max_err": float(err.max()),
            "mean_abs": float(want.abs().mean())}


def _scale(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32,
                           device=device).reshape(1)


def _rows(t: torch.Tensor) -> tuple[int, int, int]:
    """(rows, S, D) of a (rows, S, D) or (B, H, S, D) operand."""
    return (t.shape[0] * (t.shape[1] if t.dim() == 4 else 1),
            t.shape[-2], t.shape[-1])


def _codes_and_bits(lut: torch.Tensor, bits: int):
    n_codes = int(round(lut.numel() ** 0.5))
    return n_codes, -(1 << (bits - 1)), (1 << (bits - 1)) - 1


def prepare_approx_attention(q, k, v, lut, offset: int, q_scale, k_scale,
                             v_scale, *, bits: int, rowinfo, bq: int,
                             bk: int, pad: bool = True, row_heads: int = 1):
    """Operands and geometry shared by the plain version and the kernel's
    wrapper: ``bq = min(bq, round_up(Sq, 8))``, ``bk = min(bk,
    round_up(Sk, 128))``, ``dp = round_up(d, 16)``, the end-aligned default
    ``rowinfo``, and the pinned scales. With ``pad`` the (rows, S, D) q/k/v
    operands come back float32 and zero-padded to whole tiles and ``dp``,
    as the reference's kernel takes them; without, they come back as given,
    (B, H, S, D) views included (the CUDA kernel pads logically).
    ``row_heads`` consecutive query rows share one ``rowinfo`` row.

    Returns ``(operands, statics)``: ``(q, k, v, lut_flat, rowinfo, sqs,
    sks, svs, score_scale, pv_scale)`` and a dict of the geometry."""
    n_codes, lo, hi = _codes_and_bits(lut, bits)
    bh, sq, d = _rows(q)
    bh_kv, sk, _ = _rows(k)
    rep = bh // bh_kv
    if bh != bh_kv * rep:
        raise ValueError(f"query rows {bh} not a multiple of KV rows {bh_kv}")
    bq = min(bq, _round_up(sq, 8))
    bk = min(bk, _round_up(sk, 128))
    dp = _round_up(d, 16)
    dev = q.device
    n_info = bh // row_heads
    if rowinfo is None:
        # decode convention: queries end-aligned to the key sequence
        rowinfo = torch.tensor([sk - sq, 0, sk], dtype=torch.int32,
                               device=dev).expand(n_info, 3)
    rowinfo = torch.as_tensor(rowinfo, dtype=torch.int32,
                              device=dev).contiguous()
    if tuple(rowinfo.shape) != (n_info, 3) or bh % row_heads:
        raise ValueError(f"rowinfo must be ({bh} // {row_heads}, 3), got "
                         f"{tuple(rowinfo.shape)}")
    if pad:
        sq_p, sk_p = _round_up(sq, bq), _round_up(sk, bk)
        q = _pad_to(q, sq_p, dp)
        k = _pad_to(k, sk_p, dp)
        v = _pad_to(v, sk_p, dp)
    sqs, sks, svs = (_scale(s, dev) for s in (q_scale, k_scale, v_scale))
    score_scale, pv_scale = attn_scales(sqs, sks, svs, d, hi)
    operands = (q, k, v, lut.reshape(-1), rowinfo, sqs, sks, svs,
                score_scale, pv_scale)
    statics = dict(seq_k_real=sk, d_real=d, n_codes=n_codes, offset=offset,
                   lo=lo, hi=hi, bq=bq, bk=bk, dp=dp, rep=rep)
    return operands, statics


def prepare_approx_attention_paged(q, k_pool, v_pool, lut, offset: int,
                                   q_scale, k_scale, v_scale, *, bits: int,
                                   rowinfo, page_table, bq: int,
                                   pad: bool = True, row_heads: int = 1):
    """The paged counterpart of :func:`prepare_approx_attention`: ``bk`` is
    the pool's block size, ``seq_k_real`` the whole logical extent
    ``n_logical * bk`` (no Sk pad), and ``rowinfo`` and ``page_table``
    (B*Hq / ``row_heads`` rows each) are required. With ``pad`` the pools
    come back float32 as ``(Hkv, P * bk, dp)``."""
    n_codes, lo, hi = _codes_and_bits(lut, bits)
    bh, sq, d = _rows(q)
    hkv, n_phys, bk, _ = k_pool.shape
    dev = q.device
    rowinfo = torch.as_tensor(rowinfo, dtype=torch.int32,
                              device=dev).contiguous()
    page_table = torch.as_tensor(page_table, dtype=torch.int32,
                                 device=dev).contiguous()
    n_info = bh // row_heads
    if tuple(rowinfo.shape) != (n_info, 3) or page_table.shape[0] != n_info \
            or bh % row_heads:
        raise ValueError(f"rowinfo {tuple(rowinfo.shape)} and page_table "
                         f"{tuple(page_table.shape)} must have {bh} // "
                         f"{row_heads} rows")
    bq = min(bq, _round_up(sq, 8))
    dp = _round_up(d, 16)
    if pad:
        q = _pad_to(q, _round_up(sq, bq), dp)
        k_pool = _pad_to(k_pool.reshape(hkv, n_phys * bk, d), n_phys * bk,
                         dp)
        v_pool = _pad_to(v_pool.reshape(hkv, n_phys * bk, d), n_phys * bk,
                         dp)
    sqs, sks, svs = (_scale(s, dev) for s in (q_scale, k_scale, v_scale))
    score_scale, pv_scale = attn_scales(sqs, sks, svs, d, hi)
    operands = (q, k_pool, v_pool, lut.reshape(-1), rowinfo, page_table,
                sqs, sks, svs, score_scale, pv_scale)
    n_logical = page_table.shape[1]
    statics = dict(seq_k_real=n_logical * bk, d_real=d, n_codes=n_codes,
                   offset=offset, lo=lo, hi=hi, bq=bq, bk=bk, dp=dp)
    return operands, statics


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    t = t.to(torch.float32)
    if t.shape[1] == rows and t.shape[2] == cols:
        return t
    return torch.nn.functional.pad(t, (0, cols - t.shape[2],
                                       0, rows - t.shape[1]))


def lut_bmm(a_rows: torch.Tensor, b_cols: torch.Tensor,
            lut_flat: torch.Tensor) -> torch.Tensor:
    """Batched LUT-gather GEMM ``out[r, i, j] = sum_k lut[a_rows[r, i, k] +
    b_cols[r, k, j]]`` (int32), with ``a_rows`` already table row offsets
    (``code * n_codes``) and ``b_cols`` table columns; chunked over rows
    and the contraction so the index tensor stays under 4 Mi entries."""
    r, m, kk = a_rows.shape
    n = b_cols.shape[2]
    k_chunk = max(1, min(kk, _CHUNK_ELEMS // max(1, m * n)))
    r_chunk = max(1, _CHUNK_ELEMS // max(1, m * k_chunk * n))
    out = torch.zeros((r, m, n), dtype=torch.int32, device=a_rows.device)
    for r0 in range(0, r, r_chunk):
        for k0 in range(0, kk, k_chunk):
            idx = (a_rows[r0:r0 + r_chunk, :, k0:k0 + k_chunk, None]
                   + b_cols[r0:r0 + r_chunk, None, k0:k0 + k_chunk, :])
            out[r0:r0 + r_chunk] += lut_flat[idx].sum(dim=2,
                                                      dtype=torch.int32)
    return out


def _online_block(ki: int, carry, *, q_rows, q_pos, kf, vf, lut_flat, m00,
                  sks, svs, score_scale, pv_scale, kv_start, kv_len, bk: int,
                  seq_k_real: int, d_real: int, n_codes: int, offset: int,
                  lo: int, hi: int, causal: bool, window: Optional[int],
                  softcap: Optional[float]):
    """One KV block of the approximate online softmax for R tiles at once.

    ``carry`` = (m (R, bq), l (R, bq), acc (R, bq, dp)); ``q_rows`` (R, bq,
    dp) table row offsets of the Q codes; ``q_pos`` (R, bq, 1) absolute
    query positions; ``kf``/``vf`` (R, bk, dp) float32 block ``ki`` of each
    tile's K/V; ``kv_start``/``kv_len`` (R, 1, 1)."""
    m, l, acc = carry
    dp = kf.shape[-1]
    kq = quantize_sym(kf, sks, lo, hi) + offset
    vq = quantize_sym(vf, svs, lo, hi) + offset
    s_int = lut_bmm(q_rows, kq.transpose(1, 2), lut_flat)   # (R, bq, bk)
    s_int = s_int - (dp - d_real) * m00
    s = s_int.to(torch.float32) * score_scale
    if softcap is not None:
        cap = torch.tensor(softcap, dtype=torch.float32, device=s.device)
        s = cap * torch.tanh(s / cap)
    k_pos = ki * bk + torch.arange(bk, device=s.device)
    mask = (k_pos >= kv_start) & (k_pos < kv_len)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    # the normalizer sums the FLOAT probabilities; only PV runs on the ACU
    l_new = alpha * l + p.sum(dim=-1)
    pq = torch.clamp(torch.round(p * hi), 0, hi).to(torch.int64) + offset
    pv_int = lut_bmm(pq * n_codes, vq, lut_flat)              # (R, bq, dp)
    pv_int = pv_int - min(max((ki + 1) * bk - seq_k_real, 0), bk) * m00
    pv = pv_int.to(torch.float32) * pv_scale
    acc_new = acc * alpha[..., None] + pv
    return m_new, l_new, acc_new


def _approx_core(qp, block_kv, lut_flat, rowinfo, sqs, sks, svs,
                 score_scale, pv_scale, *, n_kv: int, seq_k_real: int,
                 d_real: int, n_codes: int, offset: int, lo: int, hi: int,
                 bq: int, bk: int, causal: bool, window: Optional[int],
                 softcap: Optional[float]) -> torch.Tensor:
    """Every (row, q tile) of the padded ``qp`` (BH, Sq_p, dp) through the
    online softmax; ``block_kv(ki, rows)`` returns block ``ki`` of K and V
    for query rows ``rows`` ((R,) int64) as float32 (R, bk, dp)."""
    bh, sq_p, dp = qp.shape
    n_qt = sq_p // bq
    dev = qp.device
    lut_flat = lut_flat.reshape(-1).to(torch.int32)
    m00 = int(lut_flat[offset * n_codes + offset])
    rows = torch.arange(bh, device=dev).repeat_interleave(n_qt)   # (R,)
    qi = torch.arange(n_qt, device=dev).repeat(bh)                # (R,)
    info = rowinfo.to(torch.int64)[rows]                          # (R, 3)
    q_base, kv_start, kv_len = (info[:, i, None, None] for i in range(3))
    q_rows = (quantize_sym(qp.reshape(bh * n_qt, bq, dp), sqs, lo, hi)
              + offset) * n_codes
    q_pos = q_base + (qi[:, None, None] * bq
                      + torch.arange(bq, device=dev)[None, :, None])
    if causal:
        n_eff = causal_block_bound(info[:, 0], qi, bq, bk, n_kv)
    else:
        n_eff = torch.full_like(qi, n_kv)
    r = rows.numel()
    m = torch.full((r, bq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((r, bq), dtype=torch.float32, device=dev)
    acc = torch.zeros((r, bq, dp), dtype=torch.float32, device=dev)
    kw = dict(q_rows=q_rows, q_pos=q_pos, lut_flat=lut_flat, m00=m00,
              sks=sks, svs=svs, score_scale=score_scale, pv_scale=pv_scale,
              kv_start=kv_start, kv_len=kv_len, bk=bk, seq_k_real=seq_k_real,
              d_real=d_real, n_codes=n_codes, offset=offset, lo=lo, hi=hi,
              causal=causal, window=window, softcap=softcap)
    for ki in range(int(n_eff.max()) if r else 0):
        kf, vf = block_kv(ki, rows)
        m_n, l_n, acc_n = _online_block(ki, (m, l, acc), kf=kf, vf=vf, **kw)
        live = (ki < n_eff)[:, None]
        m = torch.where(live, m_n, m)
        l = torch.where(live, l_n, l)
        acc = torch.where(live[..., None], acc_n, acc)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(bh, sq_p, dp)


def approx_attention_ref(q, k, v, lut, offset: int, q_scale, k_scale,
                         v_scale, *, bits: int = 8, causal: bool = True,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None, rowinfo=None,
                         bq: int = 128, bk: int = 128) -> torch.Tensor:
    """Plain version of kernel 8. ``q``: (B*Hq, Sq, D) float; ``k``/``v``:
    (B*Hkv, Sk, D) float (query row ``b`` reads KV row ``b // rep``);
    ``lut``: the product table (any shape, int); per-tensor symmetric
    scales; ``rowinfo``: optional (B*Hq, 3) int32 ``[q_base, kv_start,
    kv_len]`` (default: end-aligned decode over the whole key sequence).
    Returns (B*Hq, Sq, D) float32."""
    sq, d = q.shape[1], q.shape[2]
    ops, st = prepare_approx_attention(
        q, k, v, lut, offset, q_scale, k_scale, v_scale, bits=bits,
        rowinfo=rowinfo, bq=bq, bk=bk)
    qp, kp, vp, lut_flat, info, sqs, sks, svs, ss, pvs = ops
    bk_, rep = st["bk"], st["rep"]

    def block_kv(ki, rows):
        kv = rows // rep
        return (kp[kv, ki * bk_:(ki + 1) * bk_],
                vp[kv, ki * bk_:(ki + 1) * bk_])

    out = _approx_core(qp, block_kv, lut_flat, info, sqs, sks, svs, ss, pvs,
                       n_kv=kp.shape[1] // bk_, seq_k_real=st["seq_k_real"],
                       d_real=d, n_codes=st["n_codes"], offset=offset,
                       lo=st["lo"], hi=st["hi"], bq=st["bq"], bk=bk_,
                       causal=causal, window=window, softcap=softcap)
    return out[:, :sq, :d]


def _warp_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in a warp's order: lane ``i`` adds entries
    ``i, i + 32, ...`` from 0.0, then five butterfly steps add lanes
    ``i ^ 16, ..., i ^ 1`` (every add rounded to float32)."""
    n = p.shape[-1]
    lanes = torch.zeros(p.shape[:-1] + (32,), dtype=torch.float32,
                        device=p.device)
    for j0 in range(0, n, 32):
        part = p[..., j0:j0 + 32]
        lanes[..., :part.shape[-1]] = lanes[..., :part.shape[-1]] + part
    idx = torch.arange(32, device=p.device)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., idx ^ o]
    return lanes[..., 0]


def approx_decode_ref(q, k, v, lut, offset: int, q_scale, k_scale, v_scale,
                      *, heads: int, bits: int = 8, causal: bool = True,
                      window: Optional[int] = None,
                      softcap: Optional[float] = None, rowinfo=None,
                      row_heads: int = 1, bq: int = 128,
                      bk: int = 128) -> torch.Tensor:
    """Plain version of kernel 8's contiguous decode path, in its loop
    order (``csrc/approx_flash_attention.cu: approx_decode_contig_kernel``).

    Operands as :func:`approx_attention_ref`, with ``rowinfo`` (B*Hq /
    ``row_heads``, 3) shared by ``row_heads`` query rows, as the wrapper
    takes it. Items of ``heads`` consecutive query rows (the plan's) read
    the rowinfo row of their first row ``b0 // row_heads`` and the KV row
    ``b0 // rep``; their keys stream as 16-key tiles: for each of the
    reference's ``bk`` blocks up to the causal bound of the whole padded q
    tile, its K tiles (scores kept for the block), the block's softmax
    (``l`` summed in a warp's order, :func:`_warp_sum`), then its V tiles
    (int32 PV partials; the Sk-pad correction and the float update at the
    block's last tile). Keys past the cache are zeros. Integer sums equal
    the reference's; the floats differ only in the order ``l`` is summed.
    Returns (B*Hq, Sq, D) float32."""
    ops, st = prepare_approx_attention(
        q, k, v, lut, offset, q_scale, k_scale, v_scale, bits=bits,
        rowinfo=rowinfo, bq=bq, bk=bk, pad=False, row_heads=row_heads)
    q, k, v, lut_flat, info, sqs, sks, svs, ss, pvs = ops
    bh, sq, d = _rows(q)
    bk, bq, rep = st["bk"], st["bq"], st["rep"]
    n_codes, lo, hi, off = st["n_codes"], st["lo"], st["hi"], offset
    seq_k = st["seq_k_real"]
    if bk % 16 or bh % heads or sq > bq:
        raise ValueError(f"no decode path for bk {bk}, {bh} rows in items "
                         f"of {heads}, Sq {sq} over bq {bq}")
    dev = q.device
    lut_flat = lut_flat.reshape(-1).to(torch.int32)
    m00 = int(lut_flat[off * n_codes + off])
    n_kv = -(-seq_k // bk)
    items = bh // heads
    b0 = torch.arange(items, device=dev) * heads
    q_base, kv_start, kv_len = (info.to(torch.int64)[b0 // row_heads, i]
                                [:, None, None] for i in range(3))
    kf = k.reshape(-1, k.shape[-2], d).to(torch.float32)[b0 // rep]
    vf = v.reshape(-1, v.shape[-2], d).to(torch.float32)[b0 // rep]
    pad_keys = n_kv * bk - seq_k              # zeros past the cache's end
    kq = quantize_sym(torch.nn.functional.pad(kf, (0, 0, 0, pad_keys)), sks,
                      lo, hi) + off           # (items, n_kv * bk, d)
    vq = quantize_sym(torch.nn.functional.pad(vf, (0, 0, 0, pad_keys)), svs,
                      lo, hi) + off
    r_rows = heads * sq                       # item row t * sq + r
    q_rows = (quantize_sym(q.reshape(items, r_rows, d).to(torch.float32),
                           sqs, lo, hi) + off) * n_codes
    q_pos = q_base + torch.arange(sq, device=dev).repeat(heads)[None, :,
                                                                None]
    n_eff = (torch.clamp_max(torch.div(q_base[:, 0, 0] + bq - 1, bk,
                                       rounding_mode="floor") + 1, n_kv)
             if causal else torch.full((items,), n_kv, device=dev))
    m = torch.full((items, r_rows), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((items, r_rows), dtype=torch.float32, device=dev)
    acc = torch.zeros((items, r_rows, d), dtype=torch.float32, device=dev)
    for ki in range(int(n_eff.max()) if items else 0):
        s = torch.empty((items, r_rows, bk), dtype=torch.float32,
                        device=dev)
        for t0 in range(0, bk, 16):            # the block's K tiles
            kt = kq[:, ki * bk + t0:ki * bk + t0 + 16]
            sc = lut_bmm(q_rows, kt.transpose(1, 2), lut_flat).to(
                torch.float32) * ss
            if softcap is not None:
                cap = torch.tensor(softcap, dtype=torch.float32, device=dev)
                sc = cap * torch.tanh(sc / cap)
            k_pos = ki * bk + t0 + torch.arange(16, device=dev)
            live = (k_pos >= kv_start) & (k_pos < kv_len)
            if causal:
                live = live & (k_pos <= q_pos)
            if window is not None:
                live = live & (k_pos > q_pos - window)
            s[..., t0:t0 + 16] = torch.where(live, sc, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))   # the block's softmax
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l_new = alpha * l + _warp_sum(p)
        prow = (torch.clamp(torch.round(p * hi), 0, hi).to(torch.int64)
                + off) * n_codes
        pv_int = torch.zeros((items, r_rows, d), dtype=torch.int32,
                             device=dev)
        for t0 in range(0, bk, 16):            # the block's V tiles
            pv_int += lut_bmm(prow[..., t0:t0 + 16],
                              vq[:, ki * bk + t0:ki * bk + t0 + 16],
                              lut_flat)
        pv_int -= min(max((ki + 1) * bk - seq_k, 0), bk) * m00
        acc_new = acc * alpha[..., None] + pv_int.to(torch.float32) * pvs
        run = (ki < n_eff)[:, None]
        m = torch.where(run, m_new, m)
        l = torch.where(run, l_new, l)
        acc = torch.where(run[..., None], acc_new, acc)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(bh, sq, d)


def approx_attention_paged_ref(q, k_pool, v_pool, lut, offset: int, q_scale,
                               k_scale, v_scale, *, rowinfo, page_table,
                               rep: int, bits: int = 8, causal: bool = True,
                               window: Optional[int] = None,
                               softcap: Optional[float] = None,
                               bq: int = 128) -> torch.Tensor:
    """Plain version of kernel 9: as :func:`approx_attention_ref`, with K/V
    in a shared block pool ``(Hkv, P, bk, D)``; query row ``b`` reads pool
    row ``(b // rep) % Hkv``, and its logical block ``ki`` starts at
    ``page_table[b, ki] * bk``. ``rowinfo`` and ``page_table`` ((B*Hq,
    n_logical) int32) are required."""
    sq, d = q.shape[1], q.shape[2]
    hkv = k_pool.shape[0]
    ops, st = prepare_approx_attention_paged(
        q, k_pool, v_pool, lut, offset, q_scale, k_scale, v_scale,
        bits=bits, rowinfo=rowinfo, page_table=page_table, bq=bq)
    qp, kp, vp, lut_flat, info, pt, sqs, sks, svs, ss, pvs = ops
    bk = st["bk"]
    pt = pt.to(torch.int64)
    ar = torch.arange(bk, device=qp.device)

    def block_kv(ki, rows):
        kv = ((rows // rep) % hkv)[:, None]
        pos = pt[rows, ki][:, None] * bk + ar[None, :]
        return kp[kv, pos], vp[kv, pos]

    out = _approx_core(qp, block_kv, lut_flat, info, sqs, sks, svs, ss, pvs,
                       n_kv=pt.shape[1], seq_k_real=st["seq_k_real"],
                       d_real=d, n_codes=st["n_codes"], offset=offset,
                       lo=st["lo"], hi=st["hi"], bq=st["bq"], bk=bk,
                       causal=causal, window=window, softcap=softcap)
    return out[:, :sq, :d]
