"""The work plans that the redesigned kernels run on the card, checked on
the CPU.

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

Kernel 6 (``fused_lut_conv_tiled``) runs the tiling its wrapper picks
(``pick_tiled_kernel_tiling``): its items cover every output pixel and
channel once and fit shared memory at every shape the card runs, and the
plain mirror of its loop (``fused_lut_conv_tiled_plan_ref``: the band per
item, channel groups of 4, the channel pad and its correction) is bitwise
the plain version, kernel 5's and the reference's interpret-mode kernel.
Kernel 8's contiguous decode path (``decode_plan(..., paged=False)``)
takes the calls it should, and the plain mirror of its loop
(``approx_decode_ref``: items of a KV head's query rows, 16-key tiles,
the reference's softmax per 128-key block) holds against the plain
version with its integer sums exact and against the reference's
interpret-mode kernel within one probability-code flip.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ref as aref  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    SMEM_LIMIT, approx_flash_attention, decode_plan, decode_smem)
from repro_torch.kernels.fused_lut_conv.ops import (  # noqa: E402
    SMEM_PER_BLOCK, TILED_PIXELS, _tiled_smem, conv_out_size,
    fused_lut_conv_tiled, pick_tiled_kernel_tiling)
from repro_torch.kernels.fused_lut_conv.ref import (  # noqa: E402
    fused_lut_conv_ref, fused_lut_conv_tiled_plan_ref,
    fused_lut_conv_tiled_ref)
from repro_torch.kernels.fused_lut_dense.ops import (  # noqa: E402
    DENSE_KG, DensePlan, dense_plan)
from repro_torch.kernels.fused_lut_dense.ref import (  # noqa: E402
    fused_lut_dense_plan_ref, fused_lut_dense_ref)
from test_torch_parity import load_reference  # noqa: E402

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


# ---------------------------------------------------------------------------
# kernel 6: the tiling and the plain mirror of its loop
# ---------------------------------------------------------------------------

# (c, hw, cout, k, stride, dilation, pinned band height): chip_smoke's
# TILED_CASES and test_torch_conv_tiled's tiling shapes, SAME padding
TILED_SHAPES = [(64, 224, 64, 3, 1, 1, 0), (128, 112, 128, 3, 1, 1, 0),
                (64, 112, 128, 3, 1, 1, 0), (64, 112, 128, 3, 2, 1, 0),
                (64, 56, 64, 3, 1, 2, 0), (64, 56, 64, 3, 1, 1, 5),
                (37, 56, 48, 3, 1, 1, 0), (3, 224, 64, 3, 1, 1, 0),
                (512, 14, 512, 3, 1, 1, 0), (16, 40, 8, 7, 2, 3, 0),
                (5, 7, 3, 11, 1, 1, 0)]


def _tiling(c, hw, cout, k, s, d, bh):
    ho = conv_out_size(hw, k, s, d, ((k - 1) * d // 2,) * 2)
    return ho, pick_tiled_kernel_tiling(c, ho, ho, cout, k, k, s, s, d, d,
                                        256, bh=bh)


@pytest.mark.parametrize("shape", TILED_SHAPES,
                         ids=lambda t: "c{}_{}_to{}_k{}s{}d{}bh{}".format(*t))
def test_tiled_items_cover_every_output_once(shape):
    """The kernel's item walk (image, band, strip, Cout tile; pixel p of a
    tile at row p // bw, column p % bw, the 64 slots of 8 warps; lane l's
    channels l * TN + j) stores each (pixel, channel) of the output exactly
    once, and the tiling fits one block's shared memory."""
    c, hw, cout, k, s, d, bh = shape
    ho, t = _tiling(*shape)
    assert t.bh * t.bw <= TILED_PIXELS and t.bn in (32, 64, 128)
    assert t.smem_bytes <= SMEM_PER_BLOCK
    assert t.smem_bytes == _tiled_smem(256, t.rows_in * t.cols_in, k * k,
                                       t.cc, t.bn)
    th, tw, tn = -(-ho // t.bh), -(-ho // t.bw), -(-cout // t.bn)
    assert t.tiles == th * tw * tn
    p = np.arange(TILED_PIXELS)
    pr, pc = p // t.bw, p % t.bw
    live = pr < t.bh
    oh = (np.arange(th)[:, None, None] * t.bh + pr[None, None, live])
    ow = (np.arange(tw)[None, :, None] * t.bw + pc[None, None, live])
    oh, ow = np.broadcast_arrays(oh, ow)
    keep = (oh < ho) & (ow < ho)
    counts = np.zeros((ho, ho), np.int64)
    np.add.at(counts, (oh[keep], ow[keep]), 1)
    assert (counts == 1).all()
    # Cout tile i, lane l, its j-th channel: i * bn + l * TN + j, each
    # channel below Cout once
    co = (np.arange(tn)[:, None, None] * t.bn
          + np.arange(32)[None, :, None] * t.tn
          + np.arange(t.tn)[None, None, :]).ravel()
    assert np.array_equal(np.sort(co[co < cout]), np.arange(cout))


def _conv_operands(x_shape, w_shape, seed, xz=0.0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=x_shape).astype(np.float32))
    wq = torch.from_numpy(rng.integers(-128, 128, w_shape).astype(np.int32))
    ws = torch.from_numpy(rng.uniform(0.01, 0.1, w_shape[0]).astype(
        np.float32))
    return x, wq, torch.tensor(float(x.abs().max()) / 120), \
        torch.tensor(xz), ws


# (x shape, w shape, stride, dilation, pad, pinned bh, Cout tile)
MIRROR = {
    "biased_c37_pad": ((1, 37, 12, 11), (24, 37, 3, 3), 1, 1, 1, 0, 0),
    "stride2_c5": ((2, 5, 13, 11), (40, 5, 3, 3), 2, 1, 1, 0, 0),
    "dilation2_bh3": ((1, 8, 14, 10), (70, 8, 3, 3), 1, 2, 2, 3, 0),
    "k5_valid_tile128": ((2, 3, 15, 13), (9, 3, 5, 5), 3, 1, 0, 0, 128),
}


@pytest.mark.parametrize("emit_acc", [False, True])
@pytest.mark.parametrize("name", sorted(MIRROR))
def test_tiled_mirror_is_bitwise(name, emit_acc):
    """The plain mirror of kernel 6's loop, under a biased table (LUT[off,
    off] = 7, so a channel-pad term that leaks or is corrected twice
    shows), equals the band-walking plain version and kernel 5's, bit for
    bit; a tiling with its last channel group dropped does not."""
    x_shape, w_shape, s, d, pad, bh, bn = MIRROR[name]
    x, wq, xs, xz, ws = _conv_operands(x_shape, w_shape, sum(x_shape))
    ho = conv_out_size(x_shape[2], w_shape[2], s, d, (pad, pad))
    wo = conv_out_size(x_shape[3], w_shape[3], s, d, (pad, pad))
    t = pick_tiled_kernel_tiling(x_shape[1], ho, wo, w_shape[0], w_shape[2],
                                 w_shape[3], s, s, d, d, 256, bh=bh, bn=bn)
    lut = torch.from_numpy(BIASED).reshape(-1)
    geo = dict(stride=(s, s), padding=((pad, pad), (pad, pad)),
               dilation=(d, d), emit_acc=emit_acc)
    args = (lut, OFF, 256, xs, xz, ws)
    got = fused_lut_conv_tiled_plan_ref(x, wq, *args, tiling=t, **geo)
    assert torch.equal(got, fused_lut_conv_tiled_ref(x, wq, *args, bh=1,
                                                     **geo))
    assert torch.equal(got, fused_lut_conv_ref(x, wq, *args, **geo))
    bad = dataclasses.replace(t, c4=t.c4 - 4)
    assert not torch.equal(fused_lut_conv_tiled_plan_ref(
        x, wq, *args, tiling=bad, **geo), got)


def test_tiled_mirror_matches_reference_kernel():
    """The mirror against the reference's interpret-mode
    ``fused_lut_conv_tiled`` (band height 3) at a small size, C % 4 != 0,
    a biased table and a nonzero zero point."""
    import jax.numpy as jnp
    load_reference()
    import repro.kernels.fused_lut_conv.ops as jops
    x, wq, xs, xz, ws = _conv_operands((1, 7, 9, 8), (10, 7, 3, 3), 5,
                                       xz=3.0)
    geo = dict(stride=(1, 1), padding=((1, 1), (1, 1)), dilation=(1, 1))
    want = np.asarray(jops.fused_lut_conv_tiled(
        jnp.asarray(x.numpy()), jnp.asarray(wq.numpy()), jnp.asarray(BIASED),
        OFF, xs.numpy(), np.float32(3.0), ws.numpy(), bh=3, emit_acc=True,
        **geo))
    t = pick_tiled_kernel_tiling(7, 9, 8, 10, 3, 3, 1, 1, 1, 1, 256)
    got = fused_lut_conv_tiled_plan_ref(
        x, wq, torch.from_numpy(BIASED).reshape(-1), OFF, 256, xs, xz, ws,
        tiling=t, emit_acc=True, **geo)
    assert np.array_equal(got.numpy(), want)


def test_tiled_pins_and_refusals():
    """``tiling=`` pins the tiling (the CPU runs the plain version at its
    band height); Cout tiles other than 32, 64 and 128 raise."""
    x, wq, xs, xz, ws = _conv_operands((1, 6, 9, 9), (20, 6, 3, 3), 2)
    lut = torch.from_numpy(BIASED).reshape(-1)
    geo = dict(padding=((1, 1), (1, 1)), emit_acc=True)
    t = pick_tiled_kernel_tiling(6, 9, 9, 20, 3, 3, 1, 1, 1, 1, 256, bh=2)
    assert (t.bh, t.bn, t.tn, t.c4) == (2, 32, 1, 8)
    assert torch.equal(
        fused_lut_conv_tiled(x, wq, lut, OFF, xs, xz, ws, tiling=t, **geo),
        fused_lut_conv_ref(x, wq, lut, OFF, 256, xs, xz, ws, **geo))
    with pytest.raises(ValueError, match="Cout tile"):
        pick_tiled_kernel_tiling(6, 9, 9, 20, 3, 3, 1, 1, 1, 1, 256, bn=16)


# ---------------------------------------------------------------------------
# kernel 8: the contiguous decode path's plan and the mirror of its loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm-135m", "granite-moe-3b-a800m"])
def test_contiguous_decode_plan_at_the_served_models(arch):
    """A decode step of 32 rows over a 512-key cache: items of the rep
    query heads of one KV head, 8 K and 8 V tiles of 16 keys per 128-key
    block, one item a block (on all 16 warps) while the items fit the
    SMs."""
    cfg = get_config(arch)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rep = hq // hkv
    plan = decode_plan(32 * hq, 1, d, rep, hq, 128, 2, 256, 4, N_SM,
                       paged=False)
    assert not plan.paged and plan.heads == rep and plan.items == 32 * hkv
    assert plan.bk // 16 == 8          # 16-key tiles of K (and of V) a block
    assert plan.per_block == (1 if plan.items <= N_SM else 2)
    assert plan.grid == min(N_SM, -(-plan.items // plan.per_block))
    assert plan.smem <= SMEM_LIMIT
    for item in (0, 1, plan.items - 1):
        ir, kvr, rows = plan.rows(item, rep, hq, hkv)
        assert rows == list(range(item * rep, (item + 1) * rep))
        assert all((ir, kvr) == (b // hq, b // rep) for b in rows)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_contiguous_decode_smem(d, itemsize):
    """Shared memory: the table, then per item a ring of 4 raw stages of
    32 keys, code buffers for two stages (two 16-key tiles each), 8 rows
    of bk float scores and 8 rows of d Q offsets; two items a block fit at
    head dim 64, one at head dim 128."""
    one = decode_smem(256, d, itemsize, 1, 4, paged=False, bk=128)
    r16 = lambda v: -(-v // 16) * 16
    slot = (4 * 32 * d * itemsize + 4 * r16(max(16 * (d + 8), d * 20))
            + 8 * 128 * 4 + 8 * d * 4)
    assert one == 131072 + slot <= SMEM_LIMIT
    two = decode_smem(256, d, itemsize, 2, 4, paged=False, bk=128)
    assert (two <= SMEM_LIMIT) == (d == 64)
    plan = decode_plan(1000 * 4, 1, d, 4, 4, 128, itemsize, 256, 4, N_SM,
                       paged=False)
    assert plan.per_block == (2 if d == 64 else 1)


def test_contiguous_decode_routes():
    """Which contiguous calls take the decode path: at most 8 query rows
    per item in one q tile, head dim 64 or 128, bk a multiple of 32;
    prefills and every other call keep the general path."""
    kw = dict(paged=False)
    assert decode_plan(32 * 9, 1, 64, 3, 9, 128, 2, 256, 4, N_SM, **kw)
    assert decode_plan(32 * 9, 2, 64, 3, 9, 128, 2, 256, 4, N_SM, **kw)
    assert decode_plan(32 * 9, 3, 64, 3, 9, 128, 2, 256, 4, N_SM, **kw) \
        is None                                  # 9 rows an item
    assert decode_plan(9, 200, 64, 3, 9, 128, 2, 256, 4, N_SM, **kw) is None
    assert decode_plan(32 * 9, 1, 80, 3, 9, 128, 2, 256, 4, N_SM, **kw) \
        is None
    assert decode_plan(32 * 9, 1, 64, 3, 9, 112, 2, 256, 4, N_SM, **kw) \
        is None
    assert decode_plan(32 * 8, 4, 64, 1, 1, 128, 2, 256, 4, N_SM, bq=2,
                       **kw) is None             # two q tiles
    # rows that do not share a rowinfo row: one query row an item
    one = decode_plan(32 * 9, 1, 64, 3, 1, 128, 2, 256, 4, N_SM, **kw)
    assert one.heads == 1 and one.items == 32 * 9
    # the same paged call keeps its 16-key pages and two items a block
    assert decode_plan(32 * 9, 1, 64, 3, 9, 16, 2, 256, 32,
                       N_SM).per_block == 2


def _decode_case(name, seed=0):
    """SmolLM-like heads (9 over 3, head dim 64), 4 batch rows, a 300-key
    cache read through its (B, Hkv, S, D) view; rowinfo per batch row."""
    b, hq, hkv, d, s = 4, 9, 3, 64, 300
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(b, 1, hq, d)).astype(
        np.float32)).transpose(1, 2)
    kc = torch.from_numpy(rng.normal(size=(b, s, hkv, d)).astype(np.float32))
    vc = torch.from_numpy(rng.normal(size=(b, s, hkv, d)).astype(np.float32))
    info = {
        # left pads (kv_start > 0), as the wave engine's rows have them
        "left_pads": [[40, 3, 41], [150, 7, 151], [17, 0, 18], [299, 5, 300]],
        # keys 0..139 masked: the whole first block is, p = 1 there, and
        # the next block's alpha = 0 scales it away
        "masked_first_block": [[200, 140, 201], [260, 130, 261],
                               [130, 129, 131], [90, 2, 91]],
        # q tiles 121..128 etc. cross a 128-key boundary: the bound runs a
        # block the real row never sees
        "tile_crosses_block": [[121, 0, 122], [127, 4, 128],
                               [249, 1, 250], [255, 0, 256]],
    }[name]
    sc = [torch.tensor(float(t.abs().max()) / 127) for t in (q, kc, vc)]
    return q, kc.transpose(1, 2), vc.transpose(1, 2), sc, \
        torch.tensor(info, dtype=torch.int32), hq, hkv, d, s


DECODE_CASES = ["left_pads", "masked_first_block", "tile_crosses_block"]


@pytest.mark.parametrize("table", ["std", "biased"])
@pytest.mark.parametrize("name", DECODE_CASES)
def test_decode_mirror_matches_plain_version(name, table):
    """The mirror of the decode loop against ``approx_attention_ref`` on the
    same device: the codes and integer sums agree (no row beyond the
    summation-order term: only the normalizer's float sum runs in another
    order)."""
    from repro_torch.core.lut import build_lut
    from repro_torch.core.multipliers import get_multiplier
    q, k, v, sc, info, hq, hkv, d, s = _decode_case(name)
    lut = torch.from_numpy(BIASED if table == "biased" else
                           build_lut(get_multiplier("mul8s_1L2H")))
    got = aref.approx_decode_ref(q, k, v, lut, OFF, *sc, heads=hq // hkv,
                                 rowinfo=info, row_heads=hq)
    want = aref.approx_attention_ref(
        q.reshape(-1, 1, d), k.reshape(-1, s, d), v.reshape(-1, s, d), lut,
        OFF, *sc, rowinfo=info.repeat_interleave(hq, 0))
    pv = aref.attn_scales(*[x.reshape(1) for x in sc], d, 127)[1]
    a = aref.same_device_agreement(got, want, lut, OFF, 127, pv, 128)
    assert got.shape == want.shape and a["flip_rows"] == 0, a
    # the wrapper's CPU path is the plain version, whatever path is pinned
    for general in (False, True):
        assert torch.equal(approx_flash_attention(
            q, k, v, lut, OFF, *sc, rowinfo=info, row_heads=hq,
            general=general), want)


@pytest.mark.parametrize("name", DECODE_CASES)
def test_decode_mirror_matches_reference_kernel(name):
    """The mirror against the reference's interpret-mode
    ``approx_flash_attention`` on a biased table: within one probability
    code flip (its ``exp`` is XLA's) plus the summation-order term; a
    planted fault, kv_start shifted by one 128-key block, lies beyond."""
    import jax.numpy as jnp
    load_reference()
    import repro.kernels.flash_attention.approx as approx
    q, k, v, sc, info, hq, hkv, d, s = _decode_case(name, seed=1)
    lut = torch.from_numpy(BIASED)
    qf, kf, vf = (t.reshape(-1, t.shape[-2], d).numpy() for t in (q, k, v))
    want = np.asarray(approx.approx_flash_attention(
        jnp.asarray(qf), jnp.asarray(kf), jnp.asarray(vf), BIASED, OFF,
        *[x.numpy() for x in sc],
        rowinfo=jnp.asarray(info.repeat_interleave(hq, 0).numpy())))
    pv = aref.attn_scales(*[x.reshape(1) for x in sc], d, 127)[1]
    tol = aref.code_flip_bound(lut, OFF, 127, pv) \
        + 4 * 128 * float(np.finfo(np.float32).eps) * float(
            np.abs(want).max())
    got = aref.approx_decode_ref(q, k, v, lut, OFF, *sc, heads=hq // hkv,
                                 rowinfo=info, row_heads=hq).numpy()
    assert np.abs(got - want).max() <= tol
    shifted = info + torch.tensor([0, 128, 0], dtype=torch.int32)
    bad = aref.approx_decode_ref(q, k, v, lut, OFF, *sc, heads=hq // hkv,
                                 rowinfo=shifted, row_heads=hq).numpy()
    assert np.abs(bad - want).max() > tol


# ---------------------------------------------------------------------------
# on a card: the two redesigned kernels against their mirrors
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    """Skips the test unless a CUDA device is present (decided at run
    time, never at collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU has only the plain versions")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_tiled_kernel_matches_its_mirror(cuda):
    """On a card: kernel 6 launches with each mirror case's tiling and
    equals the mirror of its loop and kernel 5, bitwise, f32 and int32,
    under both tables; a tiling with its last channel group dropped is
    caught."""
    from repro_torch.core.lut import build_lut
    from repro_torch.core.multipliers import get_multiplier
    from repro_torch.kernels.fused_lut_conv.ops import fused_lut_conv
    from repro_torch.kernels.runtime import lut_to_int16
    tables = [BIASED, build_lut(get_multiplier("mul8s_1L2H"))]
    for name, (x_shape, w_shape, s, d, pad, bh, bn) in sorted(MIRROR.items()):
        x, wq, xs, xz, ws = (t.to(cuda) for t in _conv_operands(
            x_shape, w_shape, sum(x_shape)))
        ho = conv_out_size(x_shape[2], w_shape[2], s, d, (pad, pad))
        wo = conv_out_size(x_shape[3], w_shape[3], s, d, (pad, pad))
        t = pick_tiled_kernel_tiling(x_shape[1], ho, wo, w_shape[0],
                                     w_shape[2], w_shape[3], s, s, d, d, 256,
                                     bh=bh, bn=bn)
        geo = dict(stride=(s, s), padding=((pad, pad), (pad, pad)),
                   dilation=(d, d))
        for table in tables:
            l32 = torch.from_numpy(table).reshape(-1).to(cuda)
            l16 = lut_to_int16(l32)
            for emit in (False, True):
                n0 = fused_lut_conv_tiled.launches
                got = fused_lut_conv_tiled(x, wq, l16, OFF, xs, xz, ws,
                                           tiling=t, emit_acc=emit, **geo)
                torch.cuda.synchronize()
                assert fused_lut_conv_tiled.launches == n0 + 1
                want = fused_lut_conv_tiled_plan_ref(
                    x, wq, l32, OFF, 256, xs, xz, ws, tiling=t,
                    emit_acc=emit, **geo)
                assert torch.equal(got, want), (name, emit)
                assert torch.equal(got, fused_lut_conv(
                    x, wq, l16, OFF, xs, xz, ws, emit_acc=emit, **geo))
            if t.c4 > 4:     # the kernel refuses a tiling of no channels
                bad = dataclasses.replace(t, c4=t.c4 - 4)
                assert not torch.equal(fused_lut_conv_tiled(
                    x, wq, l16, OFF, xs, xz, ws, tiling=bad, emit_acc=True,
                    **geo), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_contiguous_decode_path(cuda, dtype):
    """On a card: kernel 8's contiguous decode calls launch the decode
    path (``decode_launches`` rises) and agree with the plain version on
    the same device, on both tables, at every mirror case;
    ``general=True`` pins the general path, and a prefill takes it too."""
    from repro_torch.core.lut import build_lut
    from repro_torch.core.multipliers import get_multiplier
    dt = getattr(torch, dtype)
    for name in DECODE_CASES:
        q, k, v, sc, info, hq, hkv, d, s = (
            t.to(cuda) if torch.is_tensor(t) else t
            for t in _decode_case(name, seed=2))
        q, k, v = (t.to(dt) for t in (q, k, v))
        sc = [x.to(cuda) for x in sc]
        for table in (BIASED, build_lut(get_multiplier("mul8s_1L2H"))):
            l32 = torch.from_numpy(table).reshape(-1).to(cuda)
            want = aref.approx_attention_ref(
                q.reshape(-1, 1, d), k.reshape(-1, s, d),
                v.reshape(-1, s, d), l32, OFF, *sc,
                rowinfo=info.repeat_interleave(hq, 0))
            pv = aref.attn_scales(*[x.reshape(1) for x in sc], d, 127)[1]
            for general, on_decode in ((False, 1), (True, 0)):
                n0 = (approx_flash_attention.launches,
                      approx_flash_attention.decode_launches)
                got = approx_flash_attention(
                    q, k, v, l32.to(torch.int16), OFF, *sc, rowinfo=info,
                    row_heads=hq, general=general)
                torch.cuda.synchronize()
                assert (approx_flash_attention.launches - n0[0],
                        approx_flash_attention.decode_launches - n0[1]) == \
                    (1, on_decode)
                a = aref.same_device_agreement(got.cpu(), want.cpu(),
                                               l32.cpu(), OFF, 127, pv.cpu(),
                                               128)
                assert bool(torch.isfinite(got).all())
                assert a["within_flip"] and a["flip_rows"] <= 2, (name, a)
    n0 = approx_flash_attention.decode_launches
    approx_flash_attention(q.expand(-1, -1, 16, -1), k, v,
                           l32.to(torch.int16), OFF, *sc, rowinfo=info,
                           row_heads=hq)
    assert approx_flash_attention.decode_launches == n0
