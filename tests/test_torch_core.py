"""The port's core (multipliers, LUTs, quantizers, ACU planning) against
the JAX reference on the CPU, and the routes the port refuses."""
from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (ApproxConfig, acu_operand, affine_qparams,  # noqa: E402
                              build_error_table, build_lut, conv_plan_report,
                              dequantize, error_stats, fake_quantize,
                              get_multiplier, inline_symmetric_scale,
                              make_acu, quantize, symmetric_qparams)
from repro_torch.core import multipliers as tmul  # noqa: E402
from repro_torch.core.acu import (AcuMode, ConvSpec, conv_plan,  # noqa: E402
                                  matmul_plan)
from test_torch_parity import load_reference  # noqa: E402


@pytest.fixture(scope="module")
def ref():
    return load_reference()


EIGHT_BIT = sorted(n for n, m in tmul.REGISTRY.items() if m.bits == 8)
WIDE = sorted(n for n, m in tmul.REGISTRY.items() if m.bits > 8)


def test_registry_names_match(ref):
    assert sorted(tmul.REGISTRY) == sorted(ref.core.multipliers.REGISTRY)


@pytest.mark.parametrize("name", EIGHT_BIT)
def test_8bit_lut_bitwise(ref, name):
    lt = build_lut(get_multiplier(name))
    lj = ref.core.lut.build_lut(ref.core.get_multiplier(name))
    assert lt.dtype == np.int32 and np.array_equal(lt, lj)
    assert np.array_equal(
        build_error_table(get_multiplier(name)),
        ref.core.lut.build_error_table(ref.core.get_multiplier(name)))


@pytest.mark.parametrize("name", WIDE)
def test_12bit_closed_forms_on_sampled_grid(ref, name):
    import jax.numpy as jnp
    mt, mj = get_multiplier(name), ref.core.get_multiplier(name)
    rng = np.random.default_rng(12)
    a = rng.integers(mt.lo, mt.hi + 1, 4096)
    w = rng.integers(mt.lo, mt.hi + 1, 4096)
    edge = np.array([mt.lo, mt.lo + 1, -1, 0, 1, mt.hi - 1, mt.hi])
    a = np.concatenate([a, np.repeat(edge, len(edge))])
    w = np.concatenate([w, np.tile(edge, len(edge))])
    want = np.asarray(mj(jnp.asarray(a, jnp.int32), jnp.asarray(w, jnp.int32)))
    assert np.array_equal(mt(a, w), want.astype(np.int64))


def test_error_stats_match(ref):
    for name in ("mul8s_1L2H", "mul8s_drum4", "mul8s_mitchell"):
        assert error_stats(get_multiplier(name)) == \
            ref.core.error_stats(ref.core.get_multiplier(name))


def test_8bit_luts_fit_int16():
    """The kernels keep the table in shared memory as int16."""
    from repro_torch.kernels.runtime import lut_to_int16
    for name in EIGHT_BIT:
        lut = build_lut(get_multiplier(name))
        assert lut.min() >= -32768 and lut.max() <= 32767
        narrow = lut_to_int16(torch.from_numpy(lut))
        assert narrow.dtype == torch.int16
        assert np.array_equal(narrow.numpy().astype(np.int32),
                              lut.reshape(-1))


def test_lut_to_int16_refuses_wide_values():
    from repro_torch.kernels.runtime import lut_to_int16
    lut = torch.zeros((16, 16), dtype=torch.int32)
    lut[3, 4] = 40000
    with pytest.raises(ValueError, match="int16"):
        lut_to_int16(lut)
    with pytest.raises(ValueError, match="256"):
        lut_to_int16(torch.zeros((512, 512), dtype=torch.int32))


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [4, 8])
def test_scales_bitwise(ref, bits):
    import jax.numpy as jnp
    q = ref.core.quantization
    amax = np.abs(np.random.default_rng(bits).normal(size=257)
                  ).astype(np.float32) * 7
    amax[:3] = [0.0, 1e-13, 3.0]
    st = symmetric_qparams(torch.from_numpy(amax), bits, axis=0)
    sj = q.symmetric_qparams(jnp.asarray(amax), bits, axis=0)
    assert np.array_equal(st.scale.numpy(), np.asarray(sj.scale))
    it = inline_symmetric_scale(torch.from_numpy(amax), bits)
    ij = q.inline_symmetric_scale(jnp.asarray(amax), bits)
    assert np.array_equal(it.numpy(), np.asarray(ij))
    lo = -amax[:100]
    at = affine_qparams(torch.from_numpy(lo), torch.from_numpy(amax[100:200]),
                        bits)
    aj = q.affine_qparams(jnp.asarray(lo), jnp.asarray(amax[100:200]), bits)
    assert np.array_equal(at.scale.numpy(), np.asarray(aj.scale))
    assert np.array_equal(at.zero_point.numpy(), np.asarray(aj.zero_point))


def test_divide_and_reciprocal_spellings_differ(ref):
    """The two scale spellings are kept apart: somewhere they differ by an
    ulp, and the port's must differ exactly where the reference's do."""
    import jax.numpy as jnp
    q = ref.core.quantization
    amax = np.arange(1, 4001, dtype=np.float32) / np.float32(7)
    differ_t = (symmetric_qparams(torch.from_numpy(amax), 8).scale
                != inline_symmetric_scale(torch.from_numpy(amax), 8)).numpy()
    differ_j = np.asarray(q.symmetric_qparams(jnp.asarray(amax), 8).scale
                          != q.inline_symmetric_scale(jnp.asarray(amax), 8))
    assert differ_t.any() and np.array_equal(differ_t, differ_j)


def test_quantizers_bitwise(ref):
    import jax.numpy as jnp
    q = ref.core.quantization
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(6, 5, 4)) * 3).astype(np.float32)
    # per-tensor symmetric, per-channel (axis 1) symmetric, affine
    cases = [
        (symmetric_qparams(torch.tensor(2.5), 8),
         q.symmetric_qparams(jnp.float32(2.5), 8)),
        (symmetric_qparams(torch.from_numpy(np.abs(x).max(axis=(0, 2))), 8,
                           axis=1),
         q.symmetric_qparams(jnp.asarray(np.abs(x).max(axis=(0, 2))), 8,
                             axis=1)),
        (affine_qparams(torch.tensor(-4.0), torch.tensor(6.5), 8),
         q.affine_qparams(jnp.float32(-4.0), jnp.float32(6.5), 8)),
    ]
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for qt, qj in cases:
        ct, cj = quantize(xt, qt), q.quantize(xj, qj)
        assert ct.dtype == torch.int32
        assert np.array_equal(ct.numpy(), np.asarray(cj))
        assert np.array_equal(dequantize(ct, qt).numpy(),
                              np.asarray(q.dequantize(cj, qj)))
        assert np.array_equal(acu_operand(ct, qt).numpy(),
                              np.asarray(q.acu_operand(cj, qj)))
        assert np.array_equal(fake_quantize(xt, qt).numpy(),
                              np.asarray(q.fake_quantize(xj, qj)))


def test_rounding_is_half_to_even():
    qp = symmetric_qparams(torch.tensor(127.0), 8)        # scale 1.0
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 200.0, -300.0])
    assert quantize(x, qp).tolist() == [0, 2, 2, 0, -2, 127, -128]


# ---------------------------------------------------------------------------
# ACU planning
# ---------------------------------------------------------------------------

RESNET20_CONVS = [   # (x_shape, w_shape, stride, padding) at batch 256
    ((256, 3, 32, 32), (16, 3, 3, 3), 1, "SAME"),
    ((256, 16, 32, 32), (16, 16, 3, 3), 1, "SAME"),
    ((256, 16, 32, 32), (32, 16, 3, 3), 2, "SAME"),
    ((256, 16, 32, 32), (32, 16, 1, 1), 2, "VALID"),
    ((256, 32, 16, 16), (32, 32, 3, 3), 1, "SAME"),
    ((256, 32, 16, 16), (64, 32, 3, 3), 2, "SAME"),
    ((256, 32, 16, 16), (64, 32, 1, 1), 2, "VALID"),
    ((256, 64, 8, 8), (64, 64, 3, 3), 1, "SAME"),
]
KEYS = ("route", "bwd_route", "mode", "fused", "gemm", "tiling",
        "partition")


@pytest.mark.parametrize("kw", [dict(use_kernels=True, fused=True),
                                dict(use_kernels=True), dict(fused=True)],
                         ids=["fused", "unfused", "plain"])
def test_conv_plan_report_routes_match(ref, kw):
    cfg_t = ApproxConfig(acu=make_acu("mul8s_1L2H", "lut", **kw))
    cfg_j = ref.core.ApproxConfig(acu=ref.core.make_acu(
        "mul8s_1L2H", "lut", use_pallas=kw.get("use_kernels", False),
        fused=kw.get("fused", False)))
    for xs, ws, s, pad in RESNET20_CONVS:
        rt = conv_plan_report(xs, ws, cfg_t, stride=(s, s), padding=pad)
        rj = ref.core.conv_plan_report(xs, ws, cfg_j, stride=(s, s),
                                       padding=pad)
        assert {k: rt[k] for k in KEYS} == {k: rj[k] for k in KEYS}
        assert set(rt) == set(rj)
    assert rt["route"] == ("fused_conv" if kw.get("use_kernels") and
                           kw.get("fused") else "im2col")


def test_fused_conv_has_no_image_size_limit():
    """No shared-memory budget in the planner: a 224x224 map stays fused."""
    cfg = ApproxConfig(acu=make_acu("mul8s_1L2H", "lut", use_kernels=True,
                                    fused=True))
    rep = conv_plan_report((8, 64, 224, 224), (64, 64, 3, 3), cfg)
    assert rep["route"] == "fused_conv" and rep["report"] == []


def test_matmul_plan_routes():
    acu = make_acu("mul8s_1L2H", "lut")
    assert not matmul_plan(acu).fused
    assert not matmul_plan(acu, fused=True).fused      # no kernels: unfused
    k = make_acu("mul8s_1L2H", "lut", use_kernels=True, fused=True)
    assert matmul_plan(k).fused and not matmul_plan(k, fused=False).fused
    assert acu.m00() == 0 and acu.offset == 128 and acu.bits == 8


def test_unported_modes_and_routes_raise():
    spec = ConvSpec((1, 4, 6, 6), (4, 4, 3, 3), padding=((1, 1), (1, 1)))
    acu = make_acu("mul8s_1L2H", "lut", use_kernels=True, fused=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        conv_plan(acu, spec, route="tiled")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        conv_plan(acu, ConvSpec((1, 4, 6, 6), (4, 2, 3, 3), groups=2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        conv_plan(acu, spec, mesh=object())
    wide = make_acu("mul12s_2KM", "lut")          # > 10 bits: FUNCTIONAL
    assert wide.mode == AcuMode.FUNCTIONAL and wide.lut is None
    assert wide.m00() == 0
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        matmul_plan(wide)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        conv_plan(wide, spec)
    for mode in ("exact", "functional", "factored", "lowrank"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_acu("mul8s_trunc2", mode)


def test_fake_quant_only_matches_reference(ref):
    import jax.numpy as jnp
    rng = np.random.default_rng(5)
    x = rng.normal(size=(6, 9)).astype(np.float32)
    w = rng.normal(size=(9, 4)).astype(np.float32)
    b = rng.normal(size=4).astype(np.float32)
    from repro_torch.core import approx_dense
    got = approx_dense(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b), ApproxConfig(
                           acu=make_acu("mul8s_1L2H"), fake_quant_only=True))
    want = ref.core.approx_dense(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        ref.core.ApproxConfig(acu=ref.core.make_acu("mul8s_1L2H"),
                              fake_quant_only=True))
    # fake_quantize(x) @ fake_quantize(w) is a float GEMM: summation order
    # differs between the frameworks, so hold it to float32 rounding
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_entry_points_refuse_missing_gpu(monkeypatch):
    from repro_torch.kernels import runtime
    from repro_torch.models.vision import init_resnet
    from repro_torch.serve.engine import VisionServeEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_resnet(0, width=2, n_blocks=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VisionServeEngine({}, lambda *a: None)
    assert runtime.resolve_device("cpu").type == "cpu"


def test_port_imports_neither_jax_nor_reference():
    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "src" / "repro_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, n)
