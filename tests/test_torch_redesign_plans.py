"""The work plans that kernels 3 and 9 run on the card, checked on the CPU.

Kernel 3 (``fused_lut_dense``) runs the plan its wrapper makes
(``ops.dense_plan``): output tiles and K groups handed out as segments to
persistent blocks. Here every plan at every cell's GEMM shape covers each
(m, n, k) exactly once, fills the card at M = 32 with no tile row past M,
and the plain version summed segment by segment over the plan
(``ref.fused_lut_dense_plan_ref``) equals ``fused_lut_dense_ref`` bitwise on a
biased table, in float32 and as the raw accumulator. Kernel 9's decode
path (``ops.decode_plan``) maps each query row to one item, whose
page-table row and KV head are the ones the general path computes for
that row.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    SMEM_LIMIT, decode_plan)
from repro_torch.kernels.fused_lut_dense.ops import (  # noqa: E402
    DENSE_KG, DensePlan, dense_plan)
from repro_torch.kernels.fused_lut_dense.ref import (  # noqa: E402
    fused_lut_dense_plan_ref, fused_lut_dense_ref)

N_SM = 132      # H100 SXM
OFF = 128
_V = np.arange(-128, 128, dtype=np.int64)
# exact product + 7: every padded K slot adds LUT[off, off] = 7
BIASED = (_V[:, None] * _V[None, :] + 7).astype(np.int32)


def _lm_shapes(arch: str, m: int):
    cfg = get_config(arch)
    d, q = cfg.d_model, cfg.n_heads * cfg.head_dim
    kv = cfg.n_kv_heads * cfg.head_dim
    shapes = [(m, d, q), (m, q, d), (m, d, kv), (m, d, cfg.vocab_padded)]
    if getattr(cfg, "n_experts", 0) == 0 and arch != "rwkv6-3b":
        shapes += [(m, d, cfg.d_ff), (m, cfg.d_ff, d)]
    if arch == "rwkv6-3b":
        shapes = [(m, d, d), (m, d, cfg.d_ff), (m, cfg.d_ff, d),
                  (m, d, cfg.vocab_padded)]
    return shapes


DECODE_SHAPES = sorted({s for arch in ("smollm-135m", "granite-moe-3b-a800m",
                                       "rwkv6-3b")
                        for s in _lm_shapes(arch, 32)}
                       | {(32, 200_704, 512), (32, 512, 1000)})
SHAPES = sorted(set(DECODE_SHAPES)
                | {s for arch in ("smollm-135m", "granite-moe-3b-a800m",
                                  "rwkv6-3b")
                   for s in _lm_shapes(arch, 256)}
                | set(_lm_shapes("gemma2-27b", 4352))
                | {(4352, 36864, 4608), (4352, 4608, 36864),
                   (256, 64, 10), (1, 576, 576), (31, 576, 576),
                   (33, 576, 576), (32, 570, 200), (5, 130, 10),
                   (9, 70, 300), (3, 4, 1000)})


def covers_once(plan: DensePlan) -> bool:
    """Every (tile, K group) in exactly one segment, every segment inside
    its tile's groups and on a block, and the slots as the kernel needs
    them: -1 on a whole tile, one slot per split tile otherwise."""
    segs = plan.segments
    n_tiles = plan.tiles_m * plan.tiles_n
    if plan.offsets[0] != 0 or plan.offsets[-1] != len(segs) \
            or any(a > b for a, b in zip(plan.offsets, plan.offsets[1:])):
        return False
    if len(segs) == 0 or segs[:, 0].min() < 0 or segs[:, 0].max() >= n_tiles:
        return False
    if (segs[:, 1] >= segs[:, 2]).any() or segs[:, 1].min() < 0 \
            or segs[:, 2].max() > plan.groups:
        return False
    order = np.lexsort((segs[:, 1], segs[:, 0]))
    t, g0, g1, slot = (segs[order, i] for i in range(4))
    first = np.r_[True, t[1:] != t[:-1]]
    last = np.r_[t[1:] != t[:-1], True]
    # within a tile the ranges chain 0 -> groups without gap or overlap
    if not ((g0[first] == 0).all() and (g1[last] == plan.groups).all()
            and (g0[~first] == g1[np.r_[~first[1:], False]]).all()):
        return False
    if len(np.unique(t)) != n_tiles:
        return False
    whole = first & last
    slots = slot[~whole]
    return bool((slot[whole] == -1).all() and (slots >= 0).all()
                and len(np.unique(slots)) == len(np.unique(t[~whole]))
                == plan.n_slots)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_dense_plan_covers_every_product_once(shape):
    M, K, N = shape
    plan = dense_plan(M, K, N, N_SM)
    assert covers_once(plan)
    assert plan.tiles_m * plan.bm >= M and plan.tiles_n * plan.bn >= N
    assert plan.groups * DENSE_KG >= K > (plan.groups - 1) * DENSE_KG
    assert plan.grid <= N_SM and plan.bm == plan.tm * plan.wm
    assert 8 % plan.wm == 0 and plan.tm in (1, 2, 4, 8) and plan.tn in (4, 8)
    # no block without work; blocks' shares of the K groups differ by at
    # most one whole tile plus one group
    loads = [sum(int(g1 - g0) for _, g0, g1, _ in
                 plan.segments[a:b]) for a, b in zip(plan.offsets,
                                                     plan.offsets[1:])]
    assert min(loads) > 0
    assert max(loads) - min(loads) <= plan.groups + 1


@pytest.mark.parametrize("shape", DECODE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_dense_plan_fills_the_card_at_decode(shape):
    """At every M = 32 GEMM of SmolLM, granite, rwkv6-3b and CNN-224, all
    132 SMs get work and the tile has no row past M."""
    s = dense_plan(*shape, N_SM).summary()
    assert s["sms"] == N_SM and s["rows_past_m"] == 0, s


def test_dropped_split_is_caught():
    """A plan that leaves one K split of a tile out fails the coverage
    check, and the plain version over it differs from the reference."""
    plan = dense_plan(32, 570, 200, N_SM)
    split = np.flatnonzero(plan.segments[:, 3] >= 0)[3]
    segs = np.delete(plan.segments, split, axis=0)
    offsets = tuple(int(o - (o > split)) for o in plan.offsets)
    bad = DensePlan(**{**plan.__dict__, "segments": segs,
                       "offsets": offsets})
    assert covers_once(plan) and not covers_once(bad)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(32, 570)).astype(np.float32))
    wq = torch.from_numpy(rng.integers(-128, 128, (570, 200)).astype(
        np.int32))
    lut = torch.from_numpy(BIASED).reshape(-1)
    args = (lut, OFF, 256, torch.tensor(0.02), torch.tensor(0.0),
            torch.tensor(0.05))
    want = fused_lut_dense_ref(x, wq, *args, emit_acc=True)
    assert torch.equal(fused_lut_dense_plan_ref(x, wq, *args, plan=plan,
                                                emit_acc=True), want)
    assert not torch.equal(fused_lut_dense_plan_ref(
        x, wq, *args, plan=bad, emit_acc=True), want)


@pytest.mark.parametrize("mkn", [(1, 576, 96), (32, 570, 200), (33, 130, 300),
                                 (5, 9, 10), (64, 200, 130), (9, 4100, 40)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("emit_acc", [False, True])
def test_plain_sum_over_the_plan_is_bitwise(mkn, emit_acc):
    """Int32 partials over each segment's K range, the K pad corrected in
    integer space, one dequant on the full sum: bitwise the reference's
    accumulator and output, on a biased table with a zero point."""
    m, k, n = mkn
    rng = np.random.default_rng(m * 7 + k)
    x = torch.from_numpy((rng.normal(size=(m, k)) * 3).astype(np.float32))
    wq = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int32))
    ws = torch.from_numpy(rng.uniform(0.01, 0.1, n).astype(np.float32))
    lut = torch.from_numpy(BIASED).reshape(-1)
    args = (lut, OFF, 256, torch.tensor(0.03), torch.tensor(2.0), ws)
    plan = dense_plan(m, k, n, N_SM)
    assert plan.n_slots > 0 or plan.tiles_m * plan.tiles_n >= N_SM
    got = fused_lut_dense_plan_ref(x, wq, *args, plan=plan,
                                   emit_acc=emit_acc)
    want = fused_lut_dense_ref(x, wq, *args, emit_acc=emit_acc)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("rep", [1, 2, 3])
@pytest.mark.parametrize("sq", [1, 2])
@pytest.mark.parametrize("per_head", [False, True])
def test_decode_items_cover_each_query_row_once(rep, sq, per_head):
    """Every query row in exactly one item; the item's page-table row and
    KV head are the general path's ``ir = b // row_heads`` and ``kvr = (b
    // rep) % Hkv`` for each of its rows (approx_flash_attention.cu:160-
    168); a block's warps hold at most 8 rows."""
    batch, hkv, d = 5, 3, 64
    hq = hkv * rep
    bh = batch * hq
    row_heads = 1 if per_head else hq
    plan = decode_plan(bh, sq, d, rep, row_heads, 16, 2, 256, 32, N_SM)
    assert plan is not None
    assert plan.heads == (rep if row_heads % rep == 0 else 1)
    assert plan.heads * plan.sq <= 8 and plan.per_block in (1, 2)
    assert plan.smem <= SMEM_LIMIT
    assert plan.grid == min(N_SM, -(-plan.items // plan.per_block))
    seen = []
    for item in range(plan.items):
        ir, kvr, rows = plan.rows(item, rep, row_heads, hkv)
        for b in rows:
            assert (ir, kvr) == (b // row_heads, (b // rep) % hkv)
        seen += rows
    assert sorted(seen) == list(range(bh))


def test_decode_plan_routes():
    """SmolLM's paged decode takes the decode path with the rep = 3 heads
    of a KV head per item, 2 items a block; prefill chunks, other page
    sizes and head dims take the general path."""
    cfg = get_config("smollm-135m")
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rep = hq // hkv
    plan = decode_plan(32 * hq, 1, d, rep, hq, 16, 2, 256, 32, N_SM)
    assert (plan.heads, plan.items, plan.per_block, plan.grid) == \
        (3, 96, 2, 48)
    assert decode_plan(hq, 16, d, rep, hq, 16, 2, 256, 32, N_SM) is None
    assert decode_plan(32 * hq, 1, d, rep, hq, 32, 2, 256, 32, N_SM) is None
    assert decode_plan(32 * hq, 1, 80, rep, hq, 16, 2, 256, 32, N_SM) is None
    # float32 pools at head dim 128 fit one item a block
    big = decode_plan(8 * 16, 1, 128, 8, 16, 16, 4, 256, 256, N_SM)
    assert big.per_block == 1 and big.smem <= SMEM_LIMIT
