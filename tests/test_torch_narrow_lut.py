"""Kernels 1 (``lut_matmul``) and 5 (``fused_lut_conv``) on the narrow-N
LUT core (``csrc/lut_narrow.cuh``), checked on the CPU.

Kernel 1 runs the work plan its wrapper makes (``lut_matmul.ops.lut_plan``:
16- to 256-column tiles on the core's lane map, whole tiles round-robin and
the rest stream-K); kernel 5 the tiling its wrapper picks
(``fused_lut_conv.ops.pick_conv_kernel_tiling``: whole images or bands of
whole output rows where every channel fits, else kernel 6's 64-pixel tiles
in channel steps). Here every plan covers each (m, n, k) once at every
ResNet-20, head, weight-gradient and CNN-224 shape, every tiling each
output pixel and channel once; a Python model of the lane map shows that
every gather instruction reads one table row at 32 columns and over, two
rows at distinct k at 16 and 10; shared memory is sized as the sources'
``Layout`` and a mismatched plan or tiling is refused; the plain mirrors
of both loops (``lut_matmul_plan_ref``, ``fused_lut_conv_plan_ref``) are
bitwise the plain versions and the reference's interpret-mode kernels on a
biased table; a dropped K slice and a dropped stream-K segment are caught.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.acu import resolve_conv_padding  # noqa: E402
from repro_torch.kernels.fused_lut_conv.ops import (  # noqa: E402
    SMEM_PER_BLOCK, TILED_PIXELS, _conv_smem, conv_out_size, fused_lut_conv,
    pick_conv_kernel_tiling)
from repro_torch.kernels.fused_lut_conv.ref import (  # noqa: E402
    fused_lut_conv_plan_ref, fused_lut_conv_ref)
from repro_torch.kernels.lut_matmul.ops import (  # noqa: E402
    _lut_smem, check_plan, lut_matmul, lut_matmul_planned, lut_plan)
from repro_torch.kernels.lut_matmul.ref import (  # noqa: E402
    lane_map, lut_matmul_plan_ref, lut_matmul_ref, slice_pairs)
from test_torch_parity import load_reference  # noqa: E402
from test_torch_redesign_plans import covers_once  # noqa: E402

N_SM = 132      # H100 SXM
OFF = 128
_V = np.arange(-128, 128, dtype=np.int64)
# exact product + 7: every padded slot adds LUT[off, off] = 7 (LUT[0, x]
# = 0 in mul8s_1L2H would hide a pad that leaks)
BIASED = (_V[:, None] * _V[None, :] + 7).astype(np.int32)

# every conv of a ResNet-20 wave (cin, hw, cout, k, stride, padding), CNN-224's
# c1 and c3, and chip_smoke's TILED_CASES: (n, c, hw, cout, k, s, d, padding)
RESNET = [(3, 32, 16, 3, 1, "SAME"), (16, 32, 16, 3, 1, "SAME"),
          (16, 32, 32, 3, 2, "SAME"), (16, 32, 32, 1, 2, "VALID"),
          (32, 16, 32, 3, 1, "SAME"), (32, 16, 64, 3, 2, "SAME"),
          (32, 16, 64, 1, 2, "VALID"), (64, 8, 64, 3, 1, "SAME")]
CONVS = ([(256, c, hw, co, k, s, 1, p) for c, hw, co, k, s, p in RESNET]
         + [(32, 3, 224, 64, 3, 1, 1, "SAME"),
            (32, 128, 56, 256, 3, 1, 1, "SAME"),
            (8, 64, 224, 64, 3, 1, 1, "SAME"),
            (8, 128, 112, 128, 3, 1, 1, "SAME"),
            (32, 64, 112, 128, 3, 1, 1, "SAME"),
            (8, 64, 112, 128, 3, 2, 1, "SAME"),
            (8, 64, 56, 64, 3, 1, 2, "SAME"),
            (4, 37, 56, 48, 3, 1, 1, "SAME")])


def _geometry(n, c, hw, cout, k, s, d, padding):
    pad = resolve_conv_padding(padding, (n, c, hw, hw), (cout, c, k, k),
                               (s, s), (d, d))
    ho = conv_out_size(hw, k, s, d, pad[0])
    return pad, ho


def _gemm_shapes():
    """Kernel 1's (M, K, N): the unfused ResNet-20 wave of 256 (forward),
    its head, one training step at batch 128 (weight and input gradients),
    CNN-224's unfused wave of 32."""
    shapes = set()
    for n in (256, 128):
        for c, hw, co, k, s, p in RESNET:
            _, ho = _geometry(n, c, hw, co, k, s, 1, p)
            m, kk = n * ho * ho, c * k * k
            shapes |= {(m, kk, co), (kk, m, co), (m, co, kk)}
    shapes |= {(256, 64, 10), (128, 64, 10), (64, 128, 10), (128, 10, 64)}
    shapes |= {(32 * 224 * 224, 27, 64), (32 * 112 * 112, 576, 128),
               (32 * 56 * 56, 1152, 256), (32, 200_704, 512),
               (32, 512, 1000)}
    return sorted(shapes)


GEMMS = _gemm_shapes()


def _codes(rng, shape):
    return torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int32))


# ---------------------------------------------------------------------------
# kernel 1: the plan and the lane map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", GEMMS, ids=lambda s: "x".join(map(str, s)))
def test_lut_plan_covers_every_product_once(shape):
    """Every (tile, K group) in exactly one segment and the slots as the
    kernel needs them (kernel 3's check); the tiles hold every row and
    column, no block past the card, the tile one the kernel is built for
    and its shared memory within the block's limit."""
    m, k, n = shape
    plan = lut_plan(m, k, n, N_SM)
    check_plan(plan, m, k, n)
    assert covers_once(plan)
    assert plan.tiles_m * plan.bm >= m > (plan.tiles_m - 1) * plan.bm
    assert plan.tiles_n * plan.bn >= n > (plan.tiles_n - 1) * plan.bn
    assert plan.grid <= N_SM and plan.groups * 4 >= k > plan.groups * 4 - 4
    assert plan.bn == 16 if n <= 16 else plan.bn >= 32
    assert _lut_smem(256, plan.tm, plan.bn) <= SMEM_PER_BLOCK


@pytest.mark.parametrize("ng", range(1, 9))
@pytest.mark.parametrize("taps", [1, 2, 9])
@pytest.mark.parametrize("n_slices", [1, 2, 4, 8])
def test_k_slices_partition_the_pairs(ng, taps, n_slices):
    """The K slices' walks (``slice_pairs``) take every (tap, group) pair
    of a chunk exactly once, each slice in tap-major order."""
    walks = [list(slice_pairs(taps, ng, n_slices, s))
             for s in range(n_slices)]
    pairs = sorted(p for w in walks for p in w)
    assert pairs == [(t, g) for t in range(taps) for g in range(ng)]
    assert all(w == sorted(w) for w in walks)


@pytest.mark.parametrize("n", [10, 16, 33, 64, 100, 256])
def test_lane_map_reads_one_row_or_two_at_distinct_k(n):
    """A model of one warp's gather instructions over a chunk of 8 groups:
    lane l reads table row a(m, k) at its column's weight code, row m the
    warp's i-th, k from its K slice's walk. At 32 columns and over every
    instruction's 32 lanes read one (m, k), so one table row; at 16 (N =
    10 and 16) the two half-warps read the same m at two distinct k. The
    lanes' columns cover the tile once per slice."""
    plan = lut_plan(4096, 64, n, N_SM)
    ks, tn, cols, slices = lane_map(plan.bn)
    assert ks == plan.ks == (2 if n <= 16 else 1)
    for s in range(ks):
        own = sorted(c + j for c, sl in zip(cols, slices) if sl == s
                     for j in range(tn))
        assert own == list(range(plan.bn))
    ng = 8
    walks = [list(slice_pairs(1, ng, ks, s)) for s in range(ks)]
    for step in range(max(map(len, walks))):
        for i in range(plan.tm):
            for q in range(4):
                reads = {(i, 4 * walks[slices[l]][step][1] + q)
                         for l in range(32) if step < len(walks[slices[l]])}
                assert len(reads) == ks
                assert len({k for _, k in reads}) == ks


def test_narrow_tiles_only_below_17_columns():
    """Column tiles: 16 (two K slices) for N <= 16, the least padding of
    32..256 above; 128-row tiles at 16 and 32 columns for the big
    unfused GEMMs."""
    assert [lut_plan(256, 64, n, N_SM).bn for n in (1, 10, 16, 17, 33, 64,
                                                    65, 144, 576, 1000)] \
        == [16, 16, 16, 32, 64, 64, 32, 32, 64, 256]
    assert lut_plan(262_144, 144, 16, N_SM).bm == 128
    assert lut_plan(16_384, 576, 64, N_SM).bm == 64


def test_lut_smem_and_refusals():
    """Shared memory as ``Layout<TM, BN>`` (table, two raw buffers each
    of A and W, their byte codes, the flag); a plan for other operands or
    a tile the kernel has no instance of is refused before any launch."""
    for tm, bn in ((4, 16), (8, 64), (8, 256), (16, 32)):
        bm = 8 * tm
        assert _lut_smem(256, tm, bn) == (131072 + 2 * bm * 32 * 4
                                          + 2 * 32 * bn * 4 + bm * 32
                                          + 32 * bn + 16)
    assert _lut_smem(256, 8, 256) <= SMEM_PER_BLOCK
    plan = lut_plan(40, 70, 10, 4)
    a, w = torch.zeros((40, 70), dtype=torch.int32), \
        torch.zeros((70, 10), dtype=torch.int32)
    with pytest.raises(ValueError, match="plan is for"):
        lut_matmul_planned(a, w[:, :9], torch.from_numpy(BIASED), OFF,
                           plan=plan)
    for bad in (dataclasses.replace(plan, tm=16),
                dataclasses.replace(plan, wm=1),
                dataclasses.replace(plan, bn=48)):
        with pytest.raises(ValueError):
            lut_matmul_planned(a, w, torch.from_numpy(BIASED), OFF, plan=bad)


# ---------------------------------------------------------------------------
# kernel 1: the mirror of its loop
# ---------------------------------------------------------------------------

# (M, K, N, SMs): N 10, 16 and 33; stream-K splits on few SMs; small M
MIRROR_GEMMS = [(40, 70, 10, 4), (130, 37, 16, 3), (70, 37, 33, 4),
                (9, 300, 64, 4), (3, 90, 16, 5), (33, 65, 300, 2)]


@pytest.mark.parametrize("mkn", MIRROR_GEMMS,
                         ids=lambda s: "x".join(map(str, s)))
def test_lut_mirror_is_bitwise(mkn):
    """The mirror of kernel 1's loop on a biased table equals the plain
    version; one K slice dropped (at 16 columns a half-warp's) does not."""
    m, k, n, sms = mkn
    rng = np.random.default_rng(m + k + n)
    a, w = _codes(rng, (m, k)), _codes(rng, (k, n))
    lut = torch.from_numpy(BIASED).reshape(-1)
    plan = lut_plan(m, k, n, sms)
    got = lut_matmul_plan_ref(a, w, lut, OFF, 256, plan=plan)
    assert torch.equal(got, lut_matmul_ref(a, w, lut, OFF, 256))
    assert not torch.equal(lut_matmul_plan_ref(
        a, w, lut, OFF, 256, plan=plan, drop_slice=min(1, plan.n_slices - 1)),
        got)


def test_dropped_segment_is_caught():
    """A plan with one stream-K segment of a split tile removed leaves
    that tile short of its K groups: the mirror leaves it 0 and differs
    from the plain version."""
    rng = np.random.default_rng(3)
    a, w = _codes(rng, (27, 2000)), _codes(rng, (2000, 16))
    lut = torch.from_numpy(BIASED).reshape(-1)
    plan = lut_plan(27, 2000, 16, 8)
    assert plan.n_slots == 1 and len(plan.segments) == 8
    bad = dataclasses.replace(plan, segments=plan.segments[1:],
                              offsets=(0,) + tuple(o - 1 for o in
                                                   plan.offsets[1:]))
    want = lut_matmul_ref(a, w, lut, OFF, 256)
    assert torch.equal(lut_matmul_plan_ref(a, w, lut, OFF, 256, plan=plan),
                       want)
    assert not torch.equal(lut_matmul_plan_ref(a, w, lut, OFF, 256,
                                               plan=bad), want)


def test_lut_mirror_matches_reference_kernel():
    """The mirror against the reference's interpret-mode ``lut_matmul``
    at N = 10 (two K slices) on the biased table."""
    import jax.numpy as jnp
    load_reference()
    import repro.kernels.lut_matmul.ops as jops
    lut = torch.from_numpy(BIASED).reshape(-1)
    for m, k, n, sms in MIRROR_GEMMS[:1]:
        rng = np.random.default_rng(m + k + n)
        a, w = _codes(rng, (m, k)), _codes(rng, (k, n))
        want = np.asarray(jops.lut_matmul(jnp.asarray(a.numpy()),
                                          jnp.asarray(w.numpy()),
                                          jnp.asarray(BIASED), OFF))
        got = lut_matmul_plan_ref(a, w, lut, OFF, 256,
                                  plan=lut_plan(m, k, n, sms))
        assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# kernel 5: the tiling and the mirror of its loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("conv", CONVS,
                         ids=lambda t: "n{}c{}_{}to{}k{}s{}d{}{}".format(*t))
def test_conv_items_cover_every_output_once(conv):
    """The kernel's item walk (image, band, strip, Cout tile; the item's
    pixels by 64-pixel tiles of 8 warps x 8, pixel p at row p // bw, column
    p % bw; lane l's channels on the lane map) stores each (pixel,
    channel) once; shared memory as the source's ``Layout``, within the
    block's limit; ResNet-20's convs take whole images with resident
    weight codes, every item of several pixel tiles holds every
    channel."""
    n, c, hw, cout, k, s, d, padding = conv
    _, ho = _geometry(*conv)
    t = pick_conv_kernel_tiling(n, c, ho, ho, cout, k, k, s, s, d, d, 256,
                                N_SM)
    assert t.smem_bytes == _conv_smem(256, t.rows_in * t.cols_in, k * k,
                                      t.cc, t.bn, t.wbufs)
    assert t.smem_bytes <= SMEM_PER_BLOCK
    assert t.c4 == -(-c // 4) * 4 and t.chunks == -(-t.c4 // t.cc)
    assert t.tile_px == 1 or t.chunks == 1
    if n == 256:                      # ResNet-20
        assert (t.bh, t.bw, t.chunks, t.wbufs) == (ho, ho, 1, 1)
    p = np.arange(t.tile_px * TILED_PIXELS)
    pr, pc = p // t.bw, p % t.bw
    live = pr < t.bh
    oh = np.arange(t.tiles_h)[:, None, None] * t.bh + pr[None, None, live]
    ow = np.arange(t.tiles_w)[None, :, None] * t.bw + pc[None, None, live]
    oh, ow = np.broadcast_arrays(oh, ow)
    keep = (oh < ho) & (ow < ho)
    counts = np.zeros((ho, ho), np.int64)
    np.add.at(counts, (oh[keep], ow[keep]), 1)
    assert (counts == 1).all()
    ks, tn, cols, slices = lane_map(t.bn)
    co = np.array([i * t.bn + cols[l] + j for i in range(t.tiles_n)
                   for l in range(32) if slices[l] == 0 for j in range(tn)])
    assert np.array_equal(np.sort(co[co < cout]), np.arange(cout))


def _conv_operands(x_shape, w_shape, seed, xz=0.0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=x_shape).astype(np.float32))
    wq = _codes(rng, w_shape)
    ws = torch.from_numpy(rng.uniform(0.01, 0.1, w_shape[0]).astype(
        np.float32))
    return x, wq, torch.tensor(float(x.abs().max()) / 120), \
        torch.tensor(xz), ws


# (x shape, w shape, stride, dilation, padding, SMs): Cout 10, 16 and 33,
# C 3 and 37, stride 2, dilation 2, a 1x1 VALID stride-2 shortcut, an item
# of several pixel tiles and kernel 6's single-tile items
CONV_MIRROR = {
    "stem_c3_cout16": ((2, 3, 9, 10), (16, 3, 3, 3), 1, 1, 1, N_SM),
    "c37_cout10": ((1, 37, 7, 6), (10, 37, 3, 3), 1, 1, 1, N_SM),
    "stride2_cout33": ((2, 5, 11, 9), (33, 5, 3, 3), 2, 1, 1, N_SM),
    "dilation2_cout16": ((1, 8, 12, 10), (16, 8, 3, 3), 1, 2, 2, N_SM),
    "shortcut_1x1_valid": ((2, 16, 10, 10), (32, 16, 1, 1), 2, 1, 0, N_SM),
    "tiles_of_64": ((1, 4, 24, 20), (16, 4, 3, 3), 1, 1, 1, 2),
}


def _mirror_case(name):
    x_shape, w_shape, s, d, pad, sms = CONV_MIRROR[name]
    ho = conv_out_size(x_shape[2], w_shape[2], s, d, (pad, pad))
    wo = conv_out_size(x_shape[3], w_shape[3], s, d, (pad, pad))
    t = pick_conv_kernel_tiling(x_shape[0], x_shape[1], ho, wo, w_shape[0],
                                w_shape[2], w_shape[3], s, s, d, d, 256, sms)
    geo = dict(stride=(s, s), padding=((pad, pad), (pad, pad)),
               dilation=(d, d))
    return x_shape, w_shape, t, geo


@pytest.mark.parametrize("emit_acc", [False, True])
@pytest.mark.parametrize("name", sorted(CONV_MIRROR))
def test_conv_mirror_is_bitwise(name, emit_acc):
    """The mirror of kernel 5's loop on the biased table (the channel pad's
    LUT[off, off] = 7 shows if it leaks or is corrected twice) equals the
    plain version; one K slice dropped (at Cout <= 16 a half-warp's) does
    not, nor does a tiling with its last channel group dropped."""
    x_shape, w_shape, t, geo = _mirror_case(name)
    x, wq, xs, xz, ws = _conv_operands(x_shape, w_shape, sum(x_shape))
    args = (torch.from_numpy(BIASED).reshape(-1), OFF, 256, xs, xz, ws)
    got = fused_lut_conv_plan_ref(x, wq, *args, tiling=t, emit_acc=emit_acc,
                                  **geo)
    assert torch.equal(got, fused_lut_conv_ref(x, wq, *args,
                                               emit_acc=emit_acc, **geo))
    if t.ks == 2:
        assert not torch.equal(fused_lut_conv_plan_ref(
            x, wq, *args, tiling=t, emit_acc=emit_acc, drop_slice=1, **geo),
            got)
    if t.c4 > 4:
        bad = dataclasses.replace(t, c4=t.c4 - 4)
        assert not torch.equal(fused_lut_conv_plan_ref(
            x, wq, *args, tiling=bad, emit_acc=emit_acc, **geo), got)


def test_conv_tiling_cases():
    """The mirror cases take the tilings they are there for: Cout 10 and
    16 two K slices, 33 a 64-wide tile, an item of several pixel tiles,
    and single 64-pixel tiles in channel steps on a tight table."""
    ts = {name: _mirror_case(name)[2] for name in CONV_MIRROR}
    assert ts["stem_c3_cout16"].ks == ts["c37_cout10"].ks == 2
    assert ts["stride2_cout33"].bn == 64
    assert ts["tiles_of_64"].tile_px > 1
    assert all(t.c4 % 4 == 0 for t in ts.values())


def test_conv_mirror_matches_reference_kernel():
    """The mirror against the reference's interpret-mode whole-image
    ``fused_lut_conv`` at C = 3 and Cout 16 (two K slices), a biased table
    and a nonzero zero point."""
    import jax.numpy as jnp
    load_reference()
    import repro.kernels.fused_lut_conv.ops as jops
    x, wq, xs, xz, ws = _conv_operands((1, 3, 8, 7), (16, 3, 3, 3), 5,
                                       xz=3.0)
    geo = dict(stride=(1, 1), padding=((1, 1), (1, 1)), dilation=(1, 1))
    want = np.asarray(jops.fused_lut_conv(
        jnp.asarray(x.numpy()), jnp.asarray(wq.numpy()), jnp.asarray(BIASED),
        OFF, xs.numpy(), np.float32(3.0), ws.numpy(), emit_acc=True, **geo))
    t = pick_conv_kernel_tiling(1, 3, 8, 7, 16, 3, 3, 1, 1, 1, 1, 256)
    got = fused_lut_conv_plan_ref(
        x, wq, torch.from_numpy(BIASED).reshape(-1), OFF, 256, xs, xz, ws,
        tiling=t, emit_acc=True, **geo)
    assert np.array_equal(got.numpy(), want)


def test_conv_tiling_refusals():
    """``tiling=`` is checked before any launch (and on the CPU, which
    then runs the plain version): shared memory not as the ``Layout``, an
    item of several pixel tiles in channel steps, resident weight codes
    over two Cout tiles, a Cout tile of 48 are refused."""
    x, wq, xs, xz, ws = _conv_operands((1, 8, 12, 12), (40, 8, 3, 3), 2)
    lut = torch.from_numpy(BIASED).reshape(-1)
    geo = dict(padding=((1, 1), (1, 1)), emit_acc=True)
    t = pick_conv_kernel_tiling(1, 8, 12, 12, 40, 3, 3, 1, 1, 1, 1, 256)
    assert (t.bn, t.tiles_n, t.wbufs, t.chunks) == (64, 1, 1, 1)
    assert torch.equal(
        fused_lut_conv(x, wq, lut, OFF, xs, xz, ws, tiling=t, **geo),
        fused_lut_conv_ref(x, wq, lut, OFF, 256, xs, xz, ws, **geo))
    smem = lambda **kw: _conv_smem(256, t.rows_in * t.cols_in, 9,
                                   kw.get("cc", t.cc), kw.get("bn", t.bn),
                                   kw.get("wbufs", t.wbufs))
    for bad in (dataclasses.replace(t, smem_bytes=t.smem_bytes + 16),
                dataclasses.replace(t, cc=4, smem_bytes=smem(cc=4)),
                dataclasses.replace(t, bn=32, smem_bytes=smem(bn=32)),
                dataclasses.replace(t, bn=48, smem_bytes=smem(bn=48))):
        with pytest.raises(ValueError, match="not built for"):
            fused_lut_conv(x, wq, lut, OFF, xs, xz, ws, tiling=bad, **geo)


# ---------------------------------------------------------------------------
# on a card: both kernels against their mirrors and plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    """Skips the test unless a CUDA device is present (decided at run
    time, never at collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU has only the plain versions")
    return torch.device("cuda")


def _tables(cuda):
    from repro_torch.core.lut import build_lut
    from repro_torch.core.multipliers import get_multiplier
    from repro_torch.kernels.runtime import lut_to_int16
    out = []
    for table in (BIASED, build_lut(get_multiplier("mul8s_1L2H"))):
        l32 = torch.from_numpy(np.ascontiguousarray(table, np.int32)) \
            .reshape(-1).to(cuda)
        out.append((lut_to_int16(l32), l32))
    return out


@pytest.mark.cuda
def test_cuda_lut_matmul_matches_its_mirror(cuda):
    """On a card: kernel 1 with each mirror case's plan equals the mirror
    and the plain version under both tables, its counter rising once a
    call; the plan with a split segment dropped is caught."""
    for l16, l32 in _tables(cuda):
        for m, k, n, sms in MIRROR_GEMMS + [(300, 27, 16, N_SM),
                                            (144, 20000, 16, N_SM)]:
            rng = np.random.default_rng(m + k + n)
            a, w = _codes(rng, (m, k)).to(cuda), _codes(rng, (k, n)).to(cuda)
            plan = lut_plan(m, k, n, sms)
            n0 = lut_matmul.launches
            got = lut_matmul_planned(a, w, l16, OFF, plan=plan)
            torch.cuda.synchronize()
            assert lut_matmul.launches == n0 + 1
            want = lut_matmul_ref(a, w, l32, OFF, 256)
            assert torch.equal(got, want), (m, k, n)
            assert torch.equal(lut_matmul(a, w, l16, OFF), want)
            if plan.n_slots:
                i = int(np.flatnonzero(plan.segments[:, 3] >= 0)[0])
                bad = dataclasses.replace(
                    plan, segments=np.delete(plan.segments, i, axis=0),
                    offsets=tuple(int(o - (o > i)) for o in plan.offsets))
                # the tile it leaves short is never stored: its block of
                # the output keeps what the allocator's block held, so
                # every free block of its size is first filled with a value
                # no sum gives
                del got
                junk = [torch.full_like(want, -(2 ** 31)) for _ in range(4)]
                del junk
                assert not torch.equal(
                    lut_matmul_planned(a, w, l16, OFF, plan=bad), want)


@pytest.mark.cuda
def test_cuda_fused_lut_conv_matches_its_mirror(cuda):
    """On a card: kernel 5 with each mirror case's tiling equals the
    mirror and the plain version, f32 and int32, under both tables; a
    tiling with its last channel group dropped is caught."""
    for name in sorted(CONV_MIRROR):
        x_shape, w_shape, t, geo = _mirror_case(name)
        x, wq, xs, xz, ws = (v.to(cuda) for v in _conv_operands(
            x_shape, w_shape, sum(x_shape)))
        for l16, l32 in _tables(cuda):
            for emit in (False, True):
                n0 = fused_lut_conv.launches
                got = fused_lut_conv(x, wq, l16, OFF, xs, xz, ws, tiling=t,
                                     emit_acc=emit, **geo)
                torch.cuda.synchronize()
                assert fused_lut_conv.launches == n0 + 1
                want = fused_lut_conv_plan_ref(x, wq, l32, OFF, 256, xs, xz,
                                               ws, tiling=t, emit_acc=emit,
                                               **geo)
                assert torch.equal(got, want), (name, emit)
                assert torch.equal(got, fused_lut_conv_ref(
                    x, wq, l32, OFF, 256, xs, xz, ws, emit_acc=emit, **geo))
            if t.c4 > 4:
                bad = dataclasses.replace(t, c4=t.c4 - 4)
                assert not torch.equal(fused_lut_conv(
                    x, wq, l16, OFF, xs, xz, ws, tiling=bad, emit_acc=True,
                    **geo), want)
