"""Kernels 4 (``fused_lut_bwd``) and 7 (``fused_lut_conv_bwd_w``) as
redesigned on the narrow-N LUT core, checked on the CPU.

Kernel 4 runs the plan its wrapper makes (``fused_lut_dense.ops.bwd_plan``:
items of a row tile with several column tiles where K is one chunk and B's
codes stay resident, else one column tile with B staged; whole items
round-robin, else stream-K); kernel 7 the tiling its wrapper picks
(``fused_lut_conv.ops.pick_bwd_w_tiling``: items of a band of output rows
x a channel group x a Cout tile, quantized once, at least two an SM). Here
every plan covers each (output, K group) once and every tiling each output
pixel, channel and column once at every ResNet-20 training-step shape (the
conv input and weight gradients, the head's gx and gw) and at chip_smoke's
``CONV_BWD``; shared memory is sized as the sources' ``Layout`` and a plan
or tiling the launch cannot take is refused; the plain mirrors of both
loops (``fused_lut_bwd_plan_ref``, ``fused_lut_conv_bwd_w_plan_ref``) are
bitwise the plain versions and the reference's interpret-mode kernels on a
biased table; a dropped K group, a dropped pixel slice and a dropped band
are caught.
"""
from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.acu import resolve_conv_padding  # noqa: E402
from repro_torch.kernels.fused_lut_conv.ops import (  # noqa: E402
    SMEM_PER_BLOCK, _bwd_w_smem, bwd_w_tiling_for, check_bwd_w_tiling,
    conv_out_size, fused_lut_conv_bwd_w, pick_bwd_w_tiling)
from repro_torch.kernels.fused_lut_conv.ref import (  # noqa: E402
    fused_lut_conv_bwd_w_plan_ref, fused_lut_conv_bwd_w_ref)
from repro_torch.kernels.fused_lut_dense.ops import (  # noqa: E402
    _bwd_smem, bwd_plan, bwd_plan_for, check_bwd_plan, fused_lut_bwd)
from repro_torch.kernels.fused_lut_dense.ref import (  # noqa: E402
    fused_lut_bwd_plan_ref, fused_lut_bwd_ref)
from repro_torch.kernels.lut_matmul.ref import lane_map  # noqa: E402
from test_torch_parity import load_reference  # noqa: E402
from test_torch_redesign_plans import covers_once  # noqa: E402

N_SM = 132      # H100 SXM
OFF = 128
_V = np.arange(-128, 128, dtype=np.int64)
# exact product + 7: every padded K slot adds LUT[off, off] = 7 and every
# out-of-image tap LUT[off, qg + off] = 7 (0 in mul8s_1L2H would hide a
# pad that leaks or a tap that is masked)
BIASED = (_V[:, None] * _V[None, :] + 7).astype(np.int32)
LUT = torch.from_numpy(BIASED).reshape(-1)

# every conv of ResNet-20 (cin, hw, cout, k, stride, padding) at the
# training step's batch of 128, and chip_smoke's CONV_BWD at 2 images
RESNET = [(3, 32, 16, 3, 1, "SAME"), (16, 32, 16, 3, 1, "SAME"),
          (16, 32, 32, 3, 2, "SAME"), (16, 32, 32, 1, 2, "VALID"),
          (32, 16, 32, 3, 1, "SAME"), (32, 16, 64, 3, 2, "SAME"),
          (32, 16, 64, 1, 2, "VALID"), (64, 8, 64, 3, 1, "SAME")]
CONVS = [(128,) + r for r in RESNET] + [(2, 64, 224, 64, 3, 1, "SAME")]


def _conv_geometry(n, c, hw, cout, k, s, padding):
    pad = resolve_conv_padding(padding, (n, c, hw, hw), (cout, c, k, k),
                               (s, s), (1, 1))
    return pad, conv_out_size(hw, k, s, 1, pad[0])


def _gx_shapes():
    """Kernel 4's (M, K, N) in one ResNet-20 training step: each conv's
    input gradient g (N*Ho*Wo, Cout) @ wf (Cout, Cin*k*k), the stem's
    excepted; the head's gx and gw; CONV_BWD's input gradient."""
    shapes = []
    for n, c, hw, cout, k, s, p in CONVS:
        if c == 3:
            continue
        _, ho = _conv_geometry(n, c, hw, cout, k, s, p)
        shapes.append((n * ho * ho, cout, c * k * k))
    return shapes + [(128, 10, 64), (64, 128, 10)]


GX = _gx_shapes()
# beyond the main path: B too large to keep (an LM layer), a long ragged K
GENERAL = [(32, 2560, 2560), (1000, 700, 33)]


def _covers(plan) -> bool:
    """:func:`covers_once` over kernel 4's items (row tiles x column
    groups)."""
    return covers_once(types.SimpleNamespace(
        offsets=plan.offsets, segments=plan.segments, tiles_m=plan.tiles_m,
        tiles_n=plan.tiles_c, groups=plan.groups, n_slots=plan.n_slots))


# ---------------------------------------------------------------------------
# kernel 4: the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", GX + GENERAL,
                         ids=lambda s: "x".join(map(str, s)))
def test_bwd_plan_covers_every_output_once(shape):
    """Every (item, K group) in exactly one segment, the items hold every
    row and column, no block past the card, shared memory as the source's
    ``Layout`` within the block's limit; at the conv input gradients B
    resident, K one chunk, every SM busy and no item split along K."""
    m, k, n = shape
    plan = bwd_plan(m, k, n, N_SM)
    check_bwd_plan(plan, m, k, n, 256)
    assert _covers(plan)
    assert plan.tiles_m * plan.bm >= m > (plan.tiles_m - 1) * plan.bm
    assert plan.tiles_n * plan.bn >= n > (plan.tiles_n - 1) * plan.bn
    assert plan.tiles_c * plan.nt >= plan.tiles_n
    assert plan.grid <= N_SM and plan.groups * 4 >= k > plan.groups * 4 - 4
    assert plan.smem_bytes == _bwd_smem(256, plan.tm, plan.bn, plan.kc,
                                        plan.resident, plan.groups,
                                        plan.tiles_n) <= SMEM_PER_BLOCK
    assert plan.bn == 16 if n <= 16 else plan.bn >= 32
    if shape in GX[:-2]:
        sm = plan.summary()
        assert plan.resident and plan.kc == 4 * plan.groups
        assert sm["sms"] == N_SM and sm["splits"] == 1
        assert plan.n_slots == 0 and sm["min_items_per_sm"] >= 1


def test_bwd_plan_shapes():
    """The items the plans take at the main shapes: 144 columns as five
    32-column tiles of one item, B resident beside the table; a B that
    does not fit is staged per item, K split stream-K over few tiles."""
    p = bwd_plan(131072, 16, 144, N_SM)
    assert (p.bn, p.nt, p.resident, p.n_slots) == (32, 5, True, 0)
    p = bwd_plan(32, 2560, 2560, N_SM)
    assert not p.resident and p.nt == 1 and p.kc == 32 and p.n_slots > 0
    p = bwd_plan(64, 128, 10, N_SM)
    assert p.bn == 16 and p.ks == 2 and p.n_slots > 0


def test_bwd_plan_refusals():
    """``plan=`` is checked before any launch (and on the CPU, which then
    runs the plain version): a plan for other operands, a row tile of 2
    rows, a 48-column tile, 128-row tiles at 128 columns, a chunk of 68,
    several column tiles an item over more than one chunk, shared memory
    not as the ``Layout`` are refused."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(40, 70)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(70, 100)).astype(np.float32))
    plan = bwd_plan(40, 70, 100, 4)
    assert torch.equal(fused_lut_bwd(a, b, LUT, OFF, 0.02, 0.02, plan=plan),
                       fused_lut_bwd_ref(a, b, LUT, OFF, 256, 0.02, 0.02))
    with pytest.raises(ValueError, match="plan is for"):
        fused_lut_bwd(a, b[:, :99], LUT, OFF, 0.02, 0.02, plan=plan)
    smem = lambda **kw: _bwd_smem(256, kw.get("tm", plan.tm),
                                  kw.get("bn", plan.bn),
                                  kw.get("kc", plan.kc), plan.resident,
                                  plan.groups, plan.tiles_n)
    for bad in (dataclasses.replace(plan, tm=2, smem_bytes=smem(tm=2)),
                dataclasses.replace(plan, bn=48),
                dataclasses.replace(plan, tm=16, bn=128,
                                    smem_bytes=smem(tm=16, bn=128)),
                dataclasses.replace(plan, kc=68, smem_bytes=smem(kc=68)),
                dataclasses.replace(plan, nt=2, tiles_c=1),
                dataclasses.replace(plan, smem_bytes=plan.smem_bytes + 16)):
        with pytest.raises(ValueError, match="not built for"):
            fused_lut_bwd(a, b, LUT, OFF, 0.02, 0.02, plan=bad)


# ---------------------------------------------------------------------------
# kernel 4: the mirror of its loop
# ---------------------------------------------------------------------------

# (M, K, N, SMs): K 10, 16 and 33 (one ragged chunk), 130 (chunks of 32,
# stream-K), N 10, 16, 33 and 144 (several column tiles an item), the
# 128-row tile, a B staged per item
MIRROR_GEMMS = [(40, 10, 10, 4), (70, 16, 16, 3), (9, 33, 33, 5),
                (300, 33, 144, 7), (33, 130, 100, 2), (260, 16, 40, 1)]


def _gemm_operands(m, k, n):
    rng = np.random.default_rng(m * k + n)
    a = torch.from_numpy((rng.normal(size=(m, k)) * 3).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(k, n)) * 0.01).astype(np.float32))
    return a, b, a.abs().max() / 127, b.abs().max() / 127


@pytest.mark.parametrize("emit_acc", [False, True])
@pytest.mark.parametrize("mkn", MIRROR_GEMMS,
                         ids=lambda s: "x".join(map(str, s)))
def test_bwd_mirror_is_bitwise(mkn, emit_acc):
    """The mirror of kernel 4's loop on the biased table equals the plain
    version, float32 and the raw accumulator; one K group left out does
    not, nor does a plan whose first segment stops a group short."""
    m, k, n, sms = mkn
    a, b, sa, sb = _gemm_operands(m, k, n)
    plan = bwd_plan(m, k, n, sms)
    want = fused_lut_bwd_ref(a, b, LUT, OFF, 256, sa, sb, emit_acc=emit_acc)
    got = fused_lut_bwd_plan_ref(a, b, LUT, OFF, 256, sa, sb, plan=plan,
                                 emit_acc=emit_acc)
    assert torch.equal(got, want)
    assert not torch.equal(fused_lut_bwd_plan_ref(
        a, b, LUT, OFF, 256, sa, sb, plan=plan, emit_acc=emit_acc,
        drop_slice=plan.groups - 1), want)
    segs = plan.segments.copy()
    segs[0, 2] -= 1
    if segs[0, 2] > segs[0, 1]:
        bad = dataclasses.replace(plan, segments=segs)
        assert not torch.equal(fused_lut_bwd_plan_ref(
            a, b, LUT, OFF, 256, sa, sb, plan=bad, emit_acc=emit_acc), want)


def test_bwd_mirror_other_tiles():
    """Every tile kernel 4 is built for sums the same bits: rows of 4, 8
    and 16 at column tiles of 16 to 256, one column tile or several an
    item."""
    a, b, sa, sb = _gemm_operands(150, 33, 300)
    want = fused_lut_bwd_ref(a, b, LUT, OFF, 256, sa, sb, emit_acc=True)
    for tm, bn, nt in ((4, 16, 1), (8, 32, 3), (16, 64, 5), (8, 128, 2),
                       (4, 256, 1)):
        plan = bwd_plan_for(150, 33, 300, 6, tm, bn, nt)
        check_bwd_plan(plan, 150, 33, 300, 256)
        assert torch.equal(fused_lut_bwd_plan_ref(
            a, b, LUT, OFF, 256, sa, sb, plan=plan, emit_acc=True), want)


def test_bwd_mirror_matches_reference_kernel():
    """The mirror against the reference's interpret-mode ``fused_lut_bwd``
    at K = 33 and N = 144 on the biased table, float32 and int32."""
    import jax.numpy as jnp
    load_reference()
    import repro.kernels.fused_lut_dense.ops as jops
    a, b, sa, sb = _gemm_operands(37, 33, 144)
    plan = bwd_plan(37, 33, 144, 3)
    for emit in (False, True):
        want = np.asarray(jops.fused_lut_bwd(
            jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
            jnp.asarray(BIASED), OFF, np.float32(sa), np.float32(sb),
            emit_acc=emit))
        got = fused_lut_bwd_plan_ref(a, b, LUT, OFF, 256, sa, sb, plan=plan,
                                     emit_acc=emit)
        assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# kernel 7: the tiling
# ---------------------------------------------------------------------------

def _row_list(t, taps, c, c0):
    """The kernel's row list of one item: entry e = cq * taps + t_ over
    tw-word sets, (first channel, tap) of each live entry."""
    n_words = taps * t.cg // 4
    out = []
    for e in range(t.n_sets(taps) * t.tw):
        if e < n_words:
            cq, tap = divmod(e, taps)
            out.append((c0 + 4 * cq, tap))
    return out


@pytest.mark.parametrize("conv", CONVS,
                         ids=lambda t: "n{}c{}_{}to{}k{}s{}{}".format(*t))
def test_bwd_w_items_cover_every_output_once(conv):
    """The kernel's item walk (image, band, strip, channel group, Cout
    tile) takes each output pixel once per channel group and Cout tile;
    each item's row list each (tap, channel < C) once, every K slice of
    the item's pixel groups a different set; the lanes' columns cover the
    Cout tile once per slice; shared memory as the source's ``Layout``,
    within the block's limit; at least two items an SM."""
    n, c, hw, cout, k, s, padding = conv
    _, ho = _conv_geometry(*conv)
    t = pick_bwd_w_tiling(n, c, ho, ho, cout, k, k, s, s, 1, 1, 256, N_SM)
    check_bwd_w_tiling(t, c, ho, ho, cout, k, k, s, s, 1, 1, 256)
    assert t.smem_bytes == _bwd_w_smem(
        256, t.rows_in * t.cols_in, t.cg, -(-t.bh * t.bw // 4), t.bn,
        t.n_sets(k * k), t.tw) <= SMEM_PER_BLOCK
    assert t.items(n) >= 2 * N_SM
    counts = np.zeros((ho, ho), np.int64)
    for band in range(t.tiles_h):
        for strip in range(t.tiles_w):
            rows = np.arange(band * t.bh, min(ho, band * t.bh + t.bh))
            cols = np.arange(strip * t.bw, min(ho, strip * t.bw + t.bw))
            counts[np.ix_(rows, cols)] += 1
    assert (counts == 1).all()
    pairs = [p for c0 in range(0, t.c4, t.cg)
             for p in _row_list(t, k * k, c, c0)]
    live = sorted((ch + i, tap) for ch, tap in pairs for i in range(4)
                  if ch + i < c)
    assert live == [(ch, tap) for ch in range(c) for tap in range(k * k)]
    ks, tn, lane_cols, slices = lane_map(t.bn)
    assert ks == t.ks
    co = sorted(ct * t.bn + lane_cols[l] + j for ct in range(t.tiles_n)
                for l in range(32) if slices[l] == 0 for j in range(tn))
    assert [x for x in co if x < cout] == list(range(cout))
    pg = -(-t.bh * t.bw // 4)
    walks = [set(range(sl, pg, t.n_slices)) for sl in range(t.n_slices)]
    assert sum(map(len, walks)) == pg and set().union(*walks) == set(
        range(pg))


def test_bwd_w_tiling_refusals():
    """``tiling=`` is checked before any launch: a Cout tile of 48, 5 row
    words, 9 row words at 128 columns, 3 warps across them, channel groups
    of 6, a strip wider than the image, a band that is not the halo,
    shared memory not as the ``Layout`` are refused; a tiling that leaves
    a band out is well formed."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 8, 12, 12)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 12, 12, 40)).astype(np.float32))
    geo = dict(ksize=(3, 3), padding=((1, 1), (1, 1)))
    t = pick_bwd_w_tiling(2, 8, 12, 12, 40, 3, 3, 1, 1, 1, 1, 256, 4)
    want = fused_lut_conv_bwd_w_ref(x, g, LUT, OFF, 256, 0.02, 0.02, **geo)
    assert torch.equal(fused_lut_conv_bwd_w(x, g, LUT, OFF, 0.02, 0.02,
                                            tiling=t, **geo), want)
    fused_lut_conv_bwd_w(x, g, LUT, OFF, 0.02, 0.02, **geo,
                         tiling=dataclasses.replace(t, tiles_h=1))
    smem = lambda **kw: _bwd_w_smem(
        256, t.rows_in * t.cols_in, kw.get("cg", t.cg),
        -(-t.bh * t.bw // 4), kw.get("bn", t.bn),
        -(-(9 * kw.get("cg", t.cg) // 4) // kw.get("tw", t.tw)),
        kw.get("tw", t.tw))
    for bad in (dataclasses.replace(t, bn=48, smem_bytes=smem(bn=48)),
                dataclasses.replace(t, tw=5, smem_bytes=smem(tw=5)),
                dataclasses.replace(t, bn=128, tiles_n=1, tw=9,
                                    smem_bytes=smem(bn=128, tw=9)),
                dataclasses.replace(t, wr=3),
                dataclasses.replace(t, cg=6, tiles_c=2, smem_bytes=smem(cg=6)),
                dataclasses.replace(t, bw=13, tiles_w=1),
                dataclasses.replace(t, rows_in=t.rows_in + 1),
                dataclasses.replace(t, smem_bytes=t.smem_bytes + 16)):
        with pytest.raises(ValueError, match="not built for"):
            fused_lut_conv_bwd_w(x, g, LUT, OFF, 0.02, 0.02, tiling=bad,
                                 **geo)


# ---------------------------------------------------------------------------
# kernel 7: the mirror of its loop
# ---------------------------------------------------------------------------

# (x shape, Cout, k, stride, dilation, padding, SMs): C 3, stride 2,
# dilation 2, a 1x1 VALID stride-2 shortcut, asymmetric padding, a
# rectangular window, column strips
BWD_W_MIRROR = {
    "c3_cout16": ((2, 3, 9, 10), 16, (3, 3), 1, 1, ((1, 1), (1, 1)), 2),
    "stride2_cout33": ((2, 16, 11, 9), 33, (3, 3), 2, 1, ((1, 1), (1, 1)),
                       2),
    "dilation2": ((1, 8, 12, 10), 16, (3, 3), 1, 2, ((2, 2), (2, 2)), 1),
    "shortcut_1x1_valid": ((2, 16, 10, 10), 32, (1, 1), 2, 1,
                           ((0, 0), (0, 0)), 1),
    "asym_pad_cout10": ((2, 5, 9, 8), 10, (3, 3), 1, 1, ((0, 1), (1, 0)), 4),
    "rect_3x2": ((1, 4, 12, 10), 7, (3, 2), 1, 1, ((1, 1), (0, 1)), 2),
    "strips": ((1, 4, 24, 20), 16, (3, 3), 1, 1, ((1, 1), (1, 1)), 2),
}


def _bwd_w_case(name, seed=0):
    xs, cout, (kh, kw), s, d, pad, sms = BWD_W_MIRROR[name]
    rng = np.random.default_rng(seed + sum(xs))
    x = torch.from_numpy(rng.normal(size=xs).astype(np.float32))
    ho = conv_out_size(xs[2], kh, s, d, pad[0])
    wo = conv_out_size(xs[3], kw, s, d, pad[1])
    g = torch.from_numpy(rng.normal(size=(xs[0], ho, wo, cout)).astype(
        np.float32))
    t = pick_bwd_w_tiling(xs[0], xs[1], ho, wo, cout, kh, kw, s, s, d, d,
                          256, sms)
    geo = dict(ksize=(kh, kw), stride=(s, s), padding=pad, dilation=(d, d))
    return x, g, x.abs().max() / 127, g.abs().max() / 127, t, geo


@pytest.mark.parametrize("name", sorted(BWD_W_MIRROR))
def test_bwd_w_mirror_is_bitwise(name):
    """The mirror of kernel 7's loop on the biased table (every
    out-of-image tap adds LUT[off, qg + off] != 0) equals the plain
    version; one pixel slice left out does not, nor does a tiling that
    leaves its last band out."""
    x, g, sx, sg, t, geo = _bwd_w_case(name)
    want = fused_lut_conv_bwd_w_ref(x, g, LUT, OFF, 256, sx, sg, **geo)
    assert torch.equal(fused_lut_conv_bwd_w_plan_ref(
        x, g, LUT, OFF, 256, sx, sg, tiling=t, **geo), want)
    assert not torch.equal(fused_lut_conv_bwd_w_plan_ref(
        x, g, LUT, OFF, 256, sx, sg, tiling=t, drop_slice=1, **geo), want)
    if t.tiles_h > 1:
        bad = dataclasses.replace(t, tiles_h=t.tiles_h - 1)
        assert not torch.equal(fused_lut_conv_bwd_w_plan_ref(
            x, g, LUT, OFF, 256, sx, sg, tiling=bad, **geo), want)


def test_bwd_w_mirror_other_tilings():
    """Every tiling kernel 7 is built for sums the same bits: bands of 1
    to all rows, column strips, channel groups of 4 and 8, 4 or 9 row
    words a warp, Cout tiles of 16 to 128."""
    x, g, sx, sg, _, geo = _bwd_w_case("rect_3x2")
    want = fused_lut_conv_bwd_w_ref(x, g, LUT, OFF, 256, sx, sg, **geo)
    ho, wo = g.shape[1], g.shape[2]
    for bh, bw, cg, bn, tw in ((1, wo, 4, 16, 9), (ho, 3, 4, 32, 4),
                               (5, 7, 4, 128, 4), (2, wo, 4, 64, 9)):
        t = bwd_w_tiling_for(4, ho, wo, 7, 3, 2, 1, 1, 1, 1, 256, bh, bw, cg,
                             bn, tw)
        check_bwd_w_tiling(t, 4, ho, wo, 7, 3, 2, 1, 1, 1, 1, 256)
        assert torch.equal(fused_lut_conv_bwd_w_plan_ref(
            x, g, LUT, OFF, 256, sx, sg, tiling=t, **geo), want)


def test_bwd_w_mirror_matches_reference_kernel():
    """The mirror against the reference's interpret-mode banded
    ``fused_lut_conv_bwd_w`` at C = 3, stride 2 and asymmetric padding on
    the biased table."""
    import jax.numpy as jnp
    load_reference()
    import repro.kernels.fused_lut_conv.ops as jops
    for name in ("c3_cout16", "asym_pad_cout10"):
        x, g, sx, sg, t, geo = _bwd_w_case(name)
        want = np.asarray(jops.fused_lut_conv_bwd_w(
            jnp.asarray(x.numpy()), jnp.asarray(g.numpy()),
            jnp.asarray(BIASED), OFF, np.float32(sx), np.float32(sg), **geo))
        got = fused_lut_conv_bwd_w_plan_ref(x, g, LUT, OFF, 256, sx, sg,
                                            tiling=t, **geo)
        assert np.array_equal(got.numpy(), want)
