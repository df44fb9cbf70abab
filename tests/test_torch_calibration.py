"""Calibration and the QAT site registry of the port against the JAX
reference on the CPU (mirrors ``tests/test_calibration.py``).

The observers and calibrators are numpy on the host in both packages, the
same operations in the same order: histograms, ranges and calibrated
bounds are equal exactly, and the qparams built from them bitwise.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.calibration import (HistogramObserver,  # noqa: E402
                                          PerChannelObserver,
                                          calibrate_activation,
                                          calibrate_weight)
from repro_torch.core.qat import (CalibrationRegistry,  # noqa: E402
                                  calibrate_weights_tree)
from repro_torch.core.quantization import dequantize, quantize  # noqa: E402
from test_torch_parity import load_reference  # noqa: E402


@pytest.fixture(scope="module")
def ref():
    ref = load_reference()
    import importlib
    return (importlib.import_module("repro.core.calibration"),
            importlib.import_module("repro.core.qat"))


def _batches(seed: int):
    """Batches whose range grows (forcing rebinning), with outliers and a
    negative side, as numpy and as tensors."""
    rng = np.random.default_rng(seed)
    out = []
    for scale in (1.0, 0.5, 8.0, 3.0):
        x = (rng.normal(size=3000) * scale + 0.3).astype(np.float32)
        x[:3] = scale * 40
        out.append(x)
    return out


def _same_qparams(t, j):
    assert np.array_equal(t.scale.numpy(), np.asarray(j.scale))
    assert np.array_equal(t.zero_point.numpy(), np.asarray(j.zero_point))
    assert t.bits == j.bits and t.axis == j.axis


# ---------------------------------------------------------------------------
# the reference's own checks, on the port
# ---------------------------------------------------------------------------

def test_percentile_excludes_outliers(rng):
    obs = HistogramObserver()
    x = rng.normal(size=20000).astype(np.float32)
    x[:5] = 1000.0
    obs.update(torch.from_numpy(x))
    cmax = obs.percentile_max(99.9)
    assert 2.5 < cmax < 10.0


def test_rebinning_consistency(rng):
    a = rng.normal(size=5000).astype(np.float32)
    b = (rng.normal(size=5000) * 8).astype(np.float32)
    one = HistogramObserver()
    one.update(np.concatenate([a, b]))
    two = HistogramObserver()
    two.update(a)
    two.update(b)
    p1, p2 = one.percentile_max(99.0), two.percentile_max(99.0)
    assert abs(p1 - p2) / p1 < 0.15


def test_mse_and_entropy_return_sane_bounds(rng):
    obs = HistogramObserver()
    obs.update(rng.normal(size=8000).astype(np.float32))
    for m in (obs.mse_max(8), obs.entropy_max(8)):
        assert 0 < m <= obs.range * 1.001


def test_calibrated_quantization_low_error(rng):
    x = torch.from_numpy(rng.normal(size=8000).astype(np.float32))
    obs = HistogramObserver()
    obs.update(x)
    qp = calibrate_activation(obs, 8, method="percentile")
    back = dequantize(quantize(x, qp), qp)
    assert float((back - x).abs().mean() / x.abs().mean()) < 0.02


def test_calibrate_weight_per_channel(rng):
    w = torch.from_numpy(rng.normal(size=(32, 6)).astype(np.float32))
    qp = calibrate_weight(w, 8, axis=1)
    assert qp.scale.shape == (6,) and qp.axis == 1


def test_observer_min_max_tracking():
    obs = HistogramObserver()
    obs.update(torch.tensor([-3.0, 7.0]))
    assert obs.xmin == -3.0 and obs.xmax == 7.0


def test_empty_observer_refuses():
    with pytest.raises(ValueError, match="no data"):
        HistogramObserver().percentile_max()


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def test_observers_equal_reference(ref):
    jcal, _ = ref
    ot, oj = HistogramObserver(), jcal.HistogramObserver()
    for x in _batches(0):
        ot.update(torch.from_numpy(x))
        oj.update(x)
        assert ot.range == oj.range
        assert np.array_equal(ot.counts, oj.counts)
        assert (ot.xmin, ot.xmax) == (oj.xmin, oj.xmax)
    for pct in (99.0, 99.9, 100.0):
        assert ot.percentile_max(pct) == oj.percentile_max(pct)
    for bits in (4, 8):
        assert ot.mse_max(bits) == oj.mse_max(bits)
        assert ot.entropy_max(bits) == oj.entropy_max(bits)
    w = np.random.default_rng(1).normal(size=(5, 3, 2)).astype(np.float32)
    for axis in (0, 1, 2):
        pt, pj = PerChannelObserver(axis=axis), jcal.PerChannelObserver(
            axis=axis)
        for s in (1.0, 2.0):
            pt.update(torch.from_numpy(w * s - 0.5))
            pj.update(w * s - 0.5)
        assert np.array_equal(pt.amax, pj.amax)


@pytest.mark.parametrize("method", ["percentile", "mse", "entropy", "max"])
@pytest.mark.parametrize("affine", [True, False])
def test_calibrate_activation_bitwise(ref, method, affine):
    jcal, _ = ref
    ot, oj = HistogramObserver(), jcal.HistogramObserver()
    for x in _batches(2):
        ot.update(x)
        oj.update(x)
    for bits in (4, 8):
        _same_qparams(calibrate_activation(ot, bits, method, affine),
                      jcal.calibrate_activation(oj, bits, method, affine))
    with pytest.raises(ValueError, match="unknown calibration method"):
        calibrate_activation(ot, 8, "median")


def test_calibrate_weight_bitwise(ref):
    import jax.numpy as jnp
    jcal, _ = ref
    w = np.random.default_rng(3).normal(size=(6, 4, 3, 3)).astype(np.float32)
    for axis in (0, 1):
        _same_qparams(calibrate_weight(torch.from_numpy(w), 8, axis=axis),
                      jcal.calibrate_weight(jnp.asarray(w), 8, axis=axis))


def test_registry_and_weights_tree_match_reference(ref):
    import jax.numpy as jnp
    _, jqat = ref
    rt, rj = CalibrationRegistry(), jqat.CalibrationRegistry()
    for i, x in enumerate(_batches(4)):
        site = f"layer{i % 2}"
        assert rt.observe(site, torch.from_numpy(x)) is not None
        rj.observe(site, jnp.asarray(x))
    for method in ("percentile", "entropy"):
        qt, qj = rt.finalize(8, method=method), rj.finalize(8, method=method)
        assert list(qt) == list(qj)
        for k in qj:
            _same_qparams(qt[k], qj[k])
            assert rt.sites[k].qparams is qt[k]
    rng = np.random.default_rng(5)
    tree = {"lstm": {"wx": rng.normal(size=(8, 12)), "wh": rng.normal(
        size=(3, 12)), "b": rng.normal(size=12)},
        "head": rng.normal(size=(3, 2)), "convs": [rng.normal(size=(2, 3)),
                                                   rng.normal(size=(2, 2, 2))]}
    tt = {"lstm": {k: torch.from_numpy(v.astype(np.float32))
                   for k, v in tree["lstm"].items()},
          "head": torch.from_numpy(tree["head"].astype(np.float32)),
          "convs": [torch.from_numpy(v.astype(np.float32))
                    for v in tree["convs"]]}
    tj = {"lstm": {k: jnp.asarray(v, jnp.float32)
                   for k, v in tree["lstm"].items()},
          "head": jnp.asarray(tree["head"], jnp.float32),
          "convs": [jnp.asarray(v, jnp.float32) for v in tree["convs"]]}
    for axis in (-1, 0):
        wt = calibrate_weights_tree(tt, 8, axis=axis)
        wj = jqat.calibrate_weights_tree(tj, 8, axis=axis)
        assert list(wt) == list(wj) == ["['convs']/[0]", "['head']",
                                        "['lstm']/['wh']", "['lstm']/['wx']"]
        for k in wj:
            _same_qparams(wt[k], wj[k])
