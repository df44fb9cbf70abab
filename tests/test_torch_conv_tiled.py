"""Kernel 6, the banded fused conv (``fused_lut_conv_tiled``), and the conv
planner's routes, against the JAX reference on the CPU.

On a CPU tensor the wrapper runs ``fused_lut_conv_tiled_ref``, which walks
output-row bands and quantizes each band's halo'd rows once, as the
reference's ``_tiled_kernel`` does. It is held bitwise against the
reference's interpret-mode ``fused_lut_conv_tiled`` and against kernel 5's
plain version (the im2col oracle) at stride 2, dilation 2, VALID and SAME,
Ho not divisible by the band height, odd C, the raw int32 accumulator and a
biased table (M[0, 0] = 7, so a pad term that leaks in shows). The planner
must resolve every conv to the reference's route, the ImageNet-scale ones
to ``tiled``. The CUDA kernel itself is held against the plain version by
the test marked ``cuda`` (skipped without a card) and by ``chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hypothesis_compat import assume, given, settings, strategies as st  # noqa: E402
from repro_torch.core import (ApproxConfig, acu_operand, build_lut,  # noqa: E402
                              conv2d, conv_plan_report, get_multiplier,
                              make_acu, quantize, symmetric_qparams)
from repro_torch.core.acu import (ConvSpec, conv_plan,  # noqa: E402
                                  resolve_conv_padding)
from repro_torch.kernels.fused_lut_conv.ops import (  # noqa: E402
    conv_out_size, conv_vmem_bytes, fused_lut_conv, fused_lut_conv_tiled,
    pick_conv_spatial_tiling, pick_tiled_kernel_tiling)
from repro_torch.kernels.fused_lut_conv.ref import (  # noqa: E402
    fused_lut_conv_ref, fused_lut_conv_tiled_ref)
from test_torch_parity import load_reference  # noqa: E402

OFF = 128
LUT = build_lut(get_multiplier("mul8s_1L2H"))
_V = np.arange(-128, 128, dtype=np.int32)
BIASED_LUT = (_V[:, None] * _V[None, :] + 7).astype(np.int32)
TABLES = {"mul8s_1L2H": LUT, "biased": BIASED_LUT}


@pytest.fixture(scope="module")
def ref():
    return load_reference()


@pytest.fixture(scope="module")
def ref_ops(ref):
    import repro.kernels.fused_lut_conv.ops as conv_ops
    return conv_ops


def _port_acu(table: str = "mul8s_1L2H"):
    acu = make_acu("mul8s_1L2H", "lut", use_kernels=True, fused=True)
    if table == "biased":
        acu = dataclasses.replace(make_acu("mul8s_exact", "lut",
                                           use_kernels=True, fused=True),
                                  lut=BIASED_LUT, _tables={})
    return acu


def _ref_acu(ref, table: str = "mul8s_1L2H"):
    acu = ref.core.make_acu("mul8s_1L2H", "lut", use_pallas=True,
                            fused=True)
    if table == "biased":
        acu = dataclasses.replace(ref.core.make_acu(
            "mul8s_exact", "lut", use_pallas=True, fused=True),
            lut=BIASED_LUT)
    return acu


def _fwd_lines(report) -> list:
    """The reference's audit lines without its backward's VMEM fallback:
    the port's kernel 7 needs no budget, so its backward stays banded."""
    return [r for r in report if not r.startswith("approx backward")]


def _operands(x_shape, w_shape, seed):
    """Float input, per-output-channel weight codes and the scales."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=x_shape).astype(np.float32)
    w = rng.normal(size=w_shape).astype(np.float32)
    xqp = symmetric_qparams(torch.tensor(np.abs(x).max()), 8)
    wqp = symmetric_qparams(torch.from_numpy(np.abs(w).max(axis=(1, 2, 3))),
                            8, axis=0)
    wq = acu_operand(quantize(torch.from_numpy(w), wqp), wqp)
    return x, wq, xqp.scale, wqp.scale


# name: (x_shape, w_shape, stride, padding, dilation, table, emit_acc)
GEOMS = {
    "same_ho13": ((2, 5, 13, 11), (6, 5, 3, 3), (1, 1), "SAME", (1, 1),
                  "mul8s_1L2H", False),
    "stride2_acc": ((1, 8, 9, 9), (4, 8, 3, 3), (2, 2), "SAME", (1, 1),
                    "mul8s_1L2H", True),
    "dilation2_biased": ((2, 5, 10, 10), (6, 5, 3, 3), (1, 1), "SAME",
                         (2, 2), "biased", False),
    "valid_mixed_stride": ((1, 6, 11, 5), (9, 6, 3, 3), (2, 1), "VALID",
                           (1, 1), "mul8s_1L2H", False),
    "odd_c_biased_acc": ((2, 5, 9, 7), (4, 5, 3, 3), (1, 1), "SAME",
                         (1, 1), "biased", True),
    "k5_stride3": ((1, 3, 13, 13), (5, 3, 5, 5), (3, 3), "SAME", (1, 1),
                   "mul8s_1L2H", False),
}


@pytest.mark.parametrize("bh", [1, 3, 0], ids=["bh1", "bh3", "bh_auto"])
@pytest.mark.parametrize("name", sorted(GEOMS))
def test_tiled_plain_version_matches_reference(ref_ops, name, bh):
    """The banded plain version, bitwise, against the reference's
    interpret-mode tiled kernel and kernel 5's plain version."""
    import jax.numpy as jnp
    x_shape, w_shape, stride, padding, dil, table, emit = GEOMS[name]
    x, wq, xs, ws = _operands(x_shape, w_shape, sum(x_shape) + bh)
    pad = resolve_conv_padding(padding, x_shape, w_shape, stride, dil)
    lut = TABLES[table]
    geom = dict(stride=stride, padding=pad, dilation=dil, emit_acc=emit)
    want = np.asarray(ref_ops.fused_lut_conv_tiled(
        jnp.asarray(x), jnp.asarray(wq.numpy()), jnp.asarray(lut), OFF,
        xs.numpy(), np.float32(0), ws.numpy(), bh=bh, **geom))
    got = fused_lut_conv_tiled(torch.from_numpy(x), wq,
                               torch.from_numpy(lut), OFF, xs,
                               torch.tensor(0.0), ws, bh=bh, **geom)
    assert got.dtype == (torch.int32 if emit else torch.float32)
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    whole = fused_lut_conv(torch.from_numpy(x), wq, torch.from_numpy(lut),
                           OFF, xs, torch.tensor(0.0), ws, **geom)
    assert torch.equal(got, whole)


def test_band_heights_past_ho_and_each_cout_tile_are_invisible():
    """Bands taller than Ho, one-row bands and every Cout tile width (32,
    64 and 128, one to four channels a lane) give the same bits; the plain
    version drops the last band's rows past Ho."""
    x, wq, xs, ws = _operands((1, 7, 12, 10), (33, 7, 3, 3), 7)
    xt, lut = torch.from_numpy(x), torch.from_numpy(BIASED_LUT)
    geom = dict(stride=(2, 2), padding=((0, 1), (0, 1)), emit_acc=True)
    want = fused_lut_conv(xt, wq, lut, OFF, xs, torch.tensor(0.0), ws,
                          **geom)
    for bh in (1, 2, 5, 6, 40):
        for bn in (32, 64, 128):
            got = fused_lut_conv_tiled(xt, wq, lut, OFF, xs,
                                       torch.tensor(0.0), ws, bh=bh, bn=bn,
                                       **geom)
            assert torch.equal(got, want), (bh, bn)
    with pytest.raises(ValueError, match="Cout tile"):
        fused_lut_conv_tiled(xt, wq, lut, OFF, xs, torch.tensor(0.0), ws,
                             bn=48, **geom)


def test_kernel_tiling_fits_shared_memory():
    """Kernel 6's tiling: every tile fits one block's shared memory beside
    the 128 KiB table, covers at most 64 pixels (8 warps of 8), stages its
    channels (padded to a multiple of 4) in the fewest steps whose buffers
    fit, and at the ImageNet-scale shapes stages at least 32 channels a
    step."""
    from repro_torch.kernels.fused_lut_conv.ops import (SMEM_PER_BLOCK,
                                                        TILED_MAX_CHUNK,
                                                        TILED_PIXELS,
                                                        _tiled_smem)
    for c, hw, cout, k, s, d in [(64, 224, 64, 3, 1, 1),
                                 (64, 112, 128, 3, 1, 1),
                                 (128, 112, 128, 3, 1, 1),
                                 (3, 224, 64, 3, 1, 1), (512, 14, 512, 3, 1, 1),
                                 (16, 40, 8, 7, 2, 3), (5, 7, 3, 11, 1, 1)]:
        ho = conv_out_size(hw, k, s, d, ((k - 1) * d // 2,) * 2)
        t = pick_tiled_kernel_tiling(c, ho, ho, cout, k, k, s, s, d, d, 256)
        assert t.smem_bytes <= SMEM_PER_BLOCK
        assert t.bh * t.bw <= TILED_PIXELS and t.bh <= ho
        assert t.rows_in == (t.bh - 1) * s + (k - 1) * d + 1
        assert t.cols_in == (t.bw - 1) * s + (k - 1) * d + 1
        plane = t.rows_in * t.cols_in
        assert t.smem_bytes == _tiled_smem(256, plane, k * k, t.cc, t.bn)
        assert t.c4 == -(-c // 4) * 4 and t.cc % 4 == 0
        assert t.chunks * t.cc >= t.c4 > (t.chunks - 1) * t.cc
        if t.chunks > 1:     # one step fewer does not fit
            wider = min(TILED_MAX_CHUNK, -(-t.c4 // (t.chunks - 1) // 4) * 4)
            assert wider * (t.chunks - 1) < t.c4 or _tiled_smem(
                256, plane, k * k, wider, t.bn) > SMEM_PER_BLOCK
        if c >= 32 and k == 3:
            assert t.cc >= 32
    with pytest.raises(ValueError, match="cannot stage"):
        pick_tiled_kernel_tiling(1, 8, 8, 64, 61, 61, 1, 1, 1, 1, 256)


_PROP_ACUS = {}


@settings(max_examples=8, deadline=None)
@given(
    h=st.integers(6, 18),
    w=st.integers(5, 17),
    c=st.integers(1, 9),
    cout=st.integers(1, 9),
    k=st.sampled_from([1, 3, 5]),
    sh=st.integers(1, 3),
    sw=st.integers(1, 3),
    dh=st.integers(1, 2),
    dw=st.integers(1, 2),
    same=st.sampled_from([True, False]),
    bh=st.integers(1, 4),
    groups=st.sampled_from([1, 1, 1, 2]),
    biased=st.sampled_from([False, True]),
)
def test_property_tiled_whole_oracle_bitwise(h, w, c, cout, k, sh, sw, dh,
                                             dw, same, bh, groups, biased):
    """The reference's property harness: for each drawn geometry, band
    height and table, the banded plain version, kernel 5's plain version
    and the reference's interpret-mode tiled kernel agree bitwise; with the
    budget shrunk below the whole-image working set both planners pick the
    same route (tiled exactly when a banding fits) and the tiled plan's
    output is the same. Grouped draws: both packages' ``conv2d`` take a
    grouped route and agree bitwise."""
    import jax.numpy as jnp
    ref = load_reference()
    if groups != 1:
        assume(c % groups == 0 and cout % groups == 0)
    x_shape = (2, c, h, w)
    w_shape = (cout, c // groups, k, k)
    stride, dil = (sh, sw), (dh, dw)
    padding = "SAME" if same else "VALID"
    pad = resolve_conv_padding(padding, x_shape, w_shape, stride, dil)
    ho = conv_out_size(h, k, sh, dh, pad[0])
    wo = conv_out_size(w, k, sw, dw, pad[1])
    assume(ho >= 1 and wo >= 1)
    seed = (h * 31 + w * 17 + c * 13 + cout * 11 + k * 7 + sh * 5 + sw * 3
            + dh * 2 + dw + bh + groups + int(biased))
    table = "biased" if biased else "mul8s_1L2H"
    if table not in _PROP_ACUS:
        _PROP_ACUS[table] = (_port_acu(table), _ref_acu(ref, table))
    acu_t, acu_j = _PROP_ACUS[table]
    spec_kw = dict(x_shape=x_shape, w_shape=w_shape, stride=stride,
                   padding=pad, dilation=dil, groups=groups)

    if groups != 1:
        assert conv_plan(acu_t, ConvSpec(**spec_kw), fused=True).route \
            in ("im2col_grouped", "im2col_depthwise")
        rng = np.random.default_rng(seed)
        x = rng.normal(size=x_shape).astype(np.float32)
        wt = rng.normal(size=w_shape).astype(np.float32)
        kw_ = dict(stride=stride, padding=padding, dilation=dil,
                   groups=groups)
        got = conv2d(torch.from_numpy(x), torch.from_numpy(wt),
                     cfg=ApproxConfig(acu=acu_t), **kw_)
        want = ref.core.conv2d(jnp.asarray(x), jnp.asarray(wt),
                               cfg=ref.core.ApproxConfig(acu=acu_j), **kw_)
        assert np.array_equal(got.numpy(), np.asarray(want))
        return

    lut = TABLES[table]
    x, wq, xs, ws = _operands(x_shape, w_shape, seed)
    geom = dict(stride=stride, padding=pad, dilation=dil)
    args = (torch.from_numpy(x), wq, torch.from_numpy(lut), OFF, xs,
            torch.tensor(0.0), ws)
    tiled = fused_lut_conv_tiled(*args, bh=bh, **geom)
    assert torch.equal(tiled, fused_lut_conv(*args, **geom))
    want = np.asarray(ref.kernels.fused_lut_conv.ops.fused_lut_conv_tiled(
        jnp.asarray(x), jnp.asarray(wq.numpy()), jnp.asarray(lut), OFF,
        xs.numpy(), np.float32(0), ws.numpy(), bh=bh, **geom))
    assert np.array_equal(tiled.numpy(), want)

    gargs = (c, h, w, cout, k, k, sh, sw, dh, dw, pad, 256)
    budget = conv_vmem_bytes(*gargs) - 1
    spec_t = ConvSpec(**spec_kw)
    plan_t = conv_plan(acu_t, spec_t, fused=True, vmem_budget=budget)
    plan_j = ref.core.acu.conv_plan(acu_j, ref.core.acu.ConvSpec(**spec_kw),
                                    fused=True, vmem_budget=budget)
    assert plan_t.route == plan_j.route
    assert list(plan_t.report) == _fwd_lines(plan_j.report)
    if pick_conv_spatial_tiling(*gargs, budget=budget) is None:
        assert plan_t.route == "im2col"
    else:
        assert plan_t.route == "tiled"
        assert torch.equal(plan_t(*args[:1], wq, xs, torch.tensor(0.0), ws),
                           tiled)


# ---------------------------------------------------------------------------
# route parity: the port's planner resolves the reference's route
# ---------------------------------------------------------------------------

# (x_shape, w_shape, stride): the ImageNet-scale stages (VGG-16's, the
# reference's imagenet224/112 rows), the CNN at width 64 and 224^2, and
# ResNet-20's stem and first stage at 224^2
IMAGENET = [
    ((8, 64, 224, 224), (64, 64, 3, 3), 1),
    ((8, 128, 112, 112), (128, 128, 3, 3), 1),
    ((8, 256, 56, 56), (256, 256, 3, 3), 1),
    ((8, 512, 28, 28), (512, 512, 3, 3), 1),
    ((8, 512, 14, 14), (512, 512, 3, 3), 1),
    ((32, 3, 224, 224), (64, 3, 3, 3), 1),
    ((32, 64, 112, 112), (128, 64, 3, 3), 1),
    ((32, 128, 56, 56), (256, 128, 3, 3), 1),
    ((8, 3, 224, 224), (16, 3, 3, 3), 1),
    ((8, 16, 224, 224), (32, 16, 3, 3), 2),
]


@pytest.mark.parametrize("shape", IMAGENET,
                         ids=[f"{s[0][1]}x{s[0][2]}to{s[1][0]}"
                              for s in IMAGENET])
def test_imagenet_scale_routes_match_reference(ref, shape):
    xs, ws, s = shape
    cfg_t = ApproxConfig(acu=_port_acu())
    cfg_j = ref.core.ApproxConfig(acu=_ref_acu(ref))
    rt = conv_plan_report(xs, ws, cfg_t, stride=(s, s))
    rj = ref.core.conv_plan_report(xs, ws, cfg_j, stride=(s, s))
    assert rt["route"] == rj["route"]
    assert (rt["tiling"] is None) == (rj["tiling"] is None)
    assert rt["report"] == _fwd_lines(rj["report"])
    assert rt["bwd_route"] == "banded"


def test_cnn224_routes():
    """The served CNN at width 64 and 224^2: c2 alone is banded."""
    cfg = ApproxConfig(acu=_port_acu())
    routes = [conv_plan_report(x, w, cfg)["route"] for x, w, _ in IMAGENET[5:8]]
    assert routes == ["fused_conv", "tiled", "fused_conv"]
    rep = conv_plan_report((8, 64, 224, 224), (64, 64, 3, 3), cfg)
    assert rep["route"] == "tiled" and "channel chunk 32" in rep["tiling"]


def _both_plans(ref, spec_kw, **kw):
    """The describe() of each package's plan, or the exception type."""
    out = []
    for plan, acu, spec in ((conv_plan, _port_acu(), ConvSpec),
                            (ref.core.acu.conv_plan, _ref_acu(ref),
                             ref.core.acu.ConvSpec)):
        try:
            out.append(plan(acu, spec(**spec_kw), **kw).describe())
        except ValueError as e:
            out.append(type(e))
    return out


PIN_CASES = {  # name: (x_shape, w_shape, groups, conv_plan keywords)
    "imagenet_default": ((1, 64, 224, 224), (64, 64, 3, 3), 1, {}),
    "imagenet_pin_fused_conv": ((1, 64, 224, 224), (64, 64, 3, 3), 1,
                                dict(route="fused_conv")),
    "imagenet_pin_tiled": ((1, 64, 224, 224), (64, 64, 3, 3), 1,
                           dict(route="tiled")),
    "imagenet_pin_im2col": ((1, 64, 224, 224), (64, 64, 3, 3), 1,
                            dict(route="im2col")),
    "small_pin_tiled": ((2, 4, 11, 9), (5, 4, 3, 3), 1, dict(route="tiled")),
    "small_pin_fused_conv": ((2, 4, 11, 9), (5, 4, 3, 3), 1,
                             dict(route="fused_conv")),
    "shrunk_budget": ((2, 8, 20, 20), (8, 8, 3, 3), 1,
                      dict(vmem_budget=400 << 10)),
    "degenerate": ((1, 64, 224, 224), (64, 64, 3, 3), 1,
                   dict(vmem_budget=128 << 10)),
    "degenerate_pin_tiled": ((1, 64, 224, 224), (64, 64, 3, 3), 1,
                             dict(vmem_budget=128 << 10, route="tiled")),
    "unfused": ((1, 64, 224, 224), (64, 64, 3, 3), 1, dict(fused=False)),
    "groups2": ((2, 8, 8, 8), (8, 4, 3, 3), 2, {}),
    "groups4": ((2, 8, 8, 8), (8, 2, 3, 3), 4, {}),
    "depthwise": ((2, 8, 8, 8), (16, 1, 3, 3), 8, {}),
    "groups2_pin_tiled": ((2, 8, 8, 8), (8, 4, 3, 3), 2,
                          dict(route="tiled")),
    "depthwise_pin_fused_conv": ((2, 8, 8, 8), (8, 1, 3, 3), 8,
                                 dict(route="fused_conv")),
}


@pytest.mark.parametrize("name", list(PIN_CASES))
def test_conv_plan_pins_and_budgets_match_reference(ref, name):
    """Route, audit lines and where a pin raises, as the reference; the
    tiling is compared only as present or absent (the banding differs by
    design: VMEM there, shared memory here)."""
    x_shape, w_shape, groups, kw = PIN_CASES[name]
    spec_kw = dict(x_shape=x_shape, w_shape=w_shape, groups=groups,
                   padding=((1, 1), (1, 1)))
    got, want = _both_plans(ref, spec_kw, **kw)
    if isinstance(want, type):
        assert got is want
        return
    want["report"] = _fwd_lines(want["report"])
    for key in ("route", "mode", "fused", "gemm", "report", "partition"):
        assert got[key] == want[key], key
    assert (got["tiling"] is None) == (want["tiling"] is None)
    if got["route"] in ("fused_conv", "tiled"):
        assert got["bwd_route"] == "banded"


def test_mesh_still_refused():
    """What a conv plan still refuses under a mesh: an argument that is no
    mesh, and running over a shape-only production mesh, which has no
    ranks (its partition is resolved and reported all the same)."""
    from repro_torch.launch.mesh import make_production_mesh
    spec = ConvSpec((1, 4, 6, 6), (4, 4, 3, 3), padding=((1, 1), (1, 1)))
    with pytest.raises(TypeError, match="mesh must be"):
        conv_plan(_port_acu(), spec, mesh=object())
    plan = conv_plan(_port_acu(), spec, mesh=make_production_mesh())
    assert plan.describe()["partition"] == \
        "rows('data',)x cols('model',)x k() (16x16x1 way)"
    with pytest.raises(NotImplementedError, match="item 16c"):
        plan(*[None] * 5)


# ---------------------------------------------------------------------------
# conv2d through the tiled route
# ---------------------------------------------------------------------------

def test_conv2d_route_tiled_matches_every_route_and_reference(ref):
    """route="tiled" equals "fused_conv", "im2col" and the reference's
    conv2d bitwise, with a bias; fake_quant_only contradicts the pin."""
    import jax.numpy as jnp
    rng = np.random.default_rng(31)
    x = rng.normal(size=(2, 4, 11, 9)).astype(np.float32)
    w = rng.normal(size=(5, 4, 3, 3)).astype(np.float32)
    b = rng.normal(size=5).astype(np.float32)
    cfg = ApproxConfig(acu=_port_acu())
    xt, wt, bt = map(torch.from_numpy, (x, w, b))
    ys = {r: conv2d(xt, wt, bt, cfg=cfg, route=r)
          for r in ("tiled", "fused_conv", "im2col")}
    want = np.asarray(ref.core.conv2d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        cfg=ref.core.ApproxConfig(acu=_ref_acu(ref)), route="tiled"))
    for r, y in ys.items():
        assert np.array_equal(y.numpy(), want), r
    fq = ApproxConfig(acu=_port_acu(), fake_quant_only=True)
    with pytest.raises(ValueError, match="fake_quant_only"):
        conv2d(xt, wt, None, cfg=fq, route="tiled")


@pytest.mark.parametrize("approx_bwd", [False, True],
                         ids=["exact_bwd", "approx_bwd"])
def test_conv2d_tiled_ste_gradients_equal_fused_conv(approx_bwd):
    """The tiled route takes the fused route's STE: the same gradients,
    bitwise, exact and through kernels 7 and 4."""
    rng = np.random.default_rng(37)
    x = rng.normal(size=(2, 3, 10, 10)).astype(np.float32)
    w = rng.normal(size=(5, 3, 3, 3)).astype(np.float32)
    cfg = ApproxConfig(acu=_port_acu(), approx_bwd=approx_bwd)
    grads = {}
    for route in ("tiled", "fused_conv", "im2col"):
        xt = torch.from_numpy(x).requires_grad_(True)
        wt = torch.from_numpy(w).requires_grad_(True)
        (conv2d(xt, wt, None, cfg=cfg, route=route) ** 2).sum().backward()
        grads[route] = (xt.grad, wt.grad)
    for a, b in zip(grads["tiled"], grads["fused_conv"]):
        assert torch.equal(a, b)
    if not approx_bwd:      # the eager route's exact STE, the same GEMMs
        for a, b in zip(grads["tiled"], grads["im2col"]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# on a card: kernel 6 against its plain version and kernel 5
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_tiled_kernel_matches_plain_version_and_kernel5():
    """On a card: kernel 6 launches (its counter rises) and equals its
    plain version and kernel 5 bitwise, f32 and int32, under both tables,
    at pinned and picked band heights and Cout tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU has only the plain versions")
    from repro_torch.kernels import runtime
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    cases = [  # x_shape, w_shape, stride, padding, dilation, bh, bn
        ((2, 64, 56, 56), (128, 64, 3, 3), (1, 1), ((1, 1), (1, 1)), (1, 1),
         0, 0),
        ((1, 5, 13, 11), (6, 5, 3, 3), (1, 1), ((1, 1), (1, 1)), (1, 1), 3,
         0),
        ((2, 8, 19, 17), (40, 8, 3, 3), (2, 2), ((1, 1), (1, 1)), (1, 1), 0,
         128),
        ((1, 37, 20, 20), (24, 37, 3, 3), (1, 1), ((2, 2), (2, 2)), (2, 2),
         5, 32),
        ((2, 3, 30, 26), (70, 3, 5, 5), (3, 2), ((0, 0), (0, 0)), (1, 1), 0,
         0),
    ]
    for x_shape, w_shape, stride, pad, dil, bh, bn in cases:
        x = torch.randn(x_shape, generator=g, device=dev)
        wq = torch.randint(-128, 128, w_shape, generator=g, device=dev,
                           dtype=torch.int32)
        xs = x.abs().amax() / 127
        xz = torch.zeros((), device=dev)
        ws = torch.rand(w_shape[0], generator=g, device=dev)
        for table in (LUT, BIASED_LUT):
            l16 = runtime.lut_to_int16(torch.from_numpy(table)).to(dev)
            l32 = torch.from_numpy(table).reshape(-1).to(dev)
            for emit in (False, True):
                geom = dict(stride=stride, padding=pad, dilation=dil,
                            emit_acc=emit)
                n0 = fused_lut_conv_tiled.launches
                got = fused_lut_conv_tiled(x, wq, l16, OFF, xs, xz, ws,
                                           bh=bh, bn=bn, **geom)
                torch.cuda.synchronize()
                assert fused_lut_conv_tiled.launches == n0 + 1
                plain = fused_lut_conv_tiled_ref(
                    x, wq, l32, OFF, 256, xs, xz, ws, bits=8,
                    bh=max(bh, 1), **geom)
                assert torch.equal(got, plain), (x_shape, emit)
                assert torch.equal(got, fused_lut_conv(
                    x, wq, l16, OFF, xs, xz, ws, **geom))
                assert torch.equal(got, fused_lut_conv_ref(
                    x, wq, l32, OFF, 256, xs, xz, ws, **geom))
