"""Approximate attention (kernels 8 and 9) and the MoE grouped GEMM
(kernel 10) on a mesh of ranks: the port's mirror of the mesh cases of
``tests/test_approx_attention.py`` (``test_sharded_attn_bit_exact``,
``test_sharded_paged_attn_bit_exact``) and ``tests/test_moe_grouped.py``
(``test_grouped_mesh_*``).

The module starts its 8 gloo ranks once (``tests/mesh_cases.py``, the 2 x 4
``(data, model)`` mesh). From every rank the sharded result equals the
port's one-rank result bitwise (what the reference's tests assert of
themselves), and that one-rank result is held against the reference's
single-device interpret-mode kernels: the grouped GEMM bitwise, its exact
STE gradients within ``GRAD_TOL`` of their largest entry, attention
within one probability-code flip (``tests/test_torch_attention.py``: the
online softmax goes through ``exp``). Kernel 10's ``emit_acc`` plain
version is held bitwise against the reference's interpret-mode kernel on
its six edge cases in ``tests/test_torch_moe.py``
(``test_grouped_kernel_matches_reference[True-*]``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mesh_cases as mc  # noqa: E402
from test_torch_attention import _assert_within_flip  # noqa: E402
from test_torch_parity import load_reference  # noqa: E402

GRAD_TOL = 1e-5


@pytest.fixture(scope="module")
def ref():
    load_reference()
    import repro.core as jcore
    import repro.core.acu as jacu
    import repro.core.approx_ops as jops
    return dict(core=jcore, acu=jacu, ops=jops)


@pytest.fixture(scope="module")
def ranks():
    return mc.spawn_cases("attn_moe")


def _each(ranks, name):
    """The case's sharded result from every rank, bitwise equal to the
    one-rank result (rank 0 computes it); returns rank 0's results."""
    r0 = ranks[0][name]
    for r in ranks:
        for o, lo in zip(_list(r[name]["out"]), _list(r0["local"])):
            assert o.dtype == lo.dtype and np.array_equal(o, lo), name
    return r0


def _list(x):
    return x if isinstance(x, list) else [x]


def _j(*arrays):
    import jax.numpy as jnp
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("b,hq,hkv", mc.ATTN_CASES_BHH)
def test_sharded_attn_bit_exact(ranks, ref, b, hq, hkv):
    """Batch rows over data, KV heads (whole GQA groups) over model,
    batch and head counts that do not divide included."""
    r = _each(ranks, f"attn-{(b, hq, hkv)}")
    assert r["describe"]["partition"] is not None
    q, k, v, s = mc.attn_inputs(b, hq, hkv)
    acu = ref["core"].make_acu(mc.MULT, "lut", use_pallas=True)
    spec = ref["acu"].AttnSpec(hq=hq, hkv=hkv, bq=32, bk=32)
    want = np.asarray(ref["acu"].attn_plan(acu, spec, mesh=False)(
        *_j(q, k, v), *s))
    _assert_within_flip(r["local"], want, acu.lut, s[2], 64)


@pytest.mark.parametrize("b,hq,hkv", mc.ATTN_CASES_BHH)
def test_sharded_paged_attn_bit_exact(ranks, ref, b, hq, hkv):
    """The paged plan: pools over model on their head axis, the page
    table and rowinfo with the batch rows."""
    r = _each(ranks, f"paged-{(b, hq, hkv)}")
    q, s, kp, vp, info, pt = mc.paged_inputs(b, hq, hkv, seed=b + hq)
    acu = ref["core"].make_acu(mc.MULT, "lut", use_pallas=True)
    spec = ref["acu"].AttnSpec(hq=hq, hkv=hkv, bq=32, bk=16,
                               kv_layout="paged")
    want = np.asarray(ref["acu"].attn_plan(acu, spec, mesh=False)(
        *_j(q, kp, vp), *s, *_j(info, pt)))
    _assert_within_flip(r["local"], want, acu.lut, s[2], 16)


def _ref_grouped(ref, case, seed, biased=False):
    nb, E, C, K, N = case
    x, w, counts, mask = mc.grouped_operands(nb * E, E, C, K, N, seed=seed)
    core = ref["core"]
    acu = core.make_acu(mc.MULT, "lut", use_pallas=True, fused=True)
    if biased:
        acu = dataclasses.replace(core.make_acu(
            "mul8s_exact", "lut", use_pallas=True, fused=True),
            lut=mc.BIASED_LUT)
    cfg = core.ApproxConfig(acu=acu)
    x, w, c = _j(x, w, counts)
    return np.asarray(ref["ops"].approx_grouped_dense(x, w, cfg, c)), mask


def test_grouped_mesh_expert_parallel_bitwise(ranks, ref):
    """Experts over model, dispatch blocks over data."""
    r = _each(ranks, "grouped_ep")
    assert r["describe"]["partition"].startswith("blocks('data',)")
    want, _ = _ref_grouped(ref, (2, 4, 24, 33, 14), 13)
    assert np.array_equal(r["out"], want)


@pytest.mark.parametrize("case", mc.GROUPED_SWEEP,
                         ids=["div", "nondiv_experts", "nondiv_blocks",
                              "ktile"])
def test_grouped_mesh_sweep_bitwise(ranks, ref, case):
    r = _each(ranks, f"grouped_sweep-{case}")
    want, _ = _ref_grouped(ref, case, sum(case))
    assert np.array_equal(r["out"], want)


def test_grouped_mesh_k_sharded_biased_m00(ranks, ref):
    """Contraction over model: int32 partials summed, the K-pad correction
    once (the biased table would show it twice), dead rows exactly 0
    after the correction un-zeroes them."""
    r = _each(ranks, "grouped_k_biased")
    assert r["k"] == ("model",)
    want, mask = _ref_grouped(ref, (2, 4, 24, 33, 14), 17, biased=True)
    assert np.array_equal(r["out"], want)
    assert not np.where(mask[..., None], 0.0, r["out"]).any()


def test_grouped_mesh_ste_grads_bitwise(ranks, ref):
    import jax
    import jax.numpy as jnp
    r = _each(ranks, "grouped_grads")
    x, w, counts, _ = mc.grouped_operands(8, 4, 24, 33, 14, seed=19)
    cfg = ref["core"].ApproxConfig(acu=ref["core"].make_acu(
        mc.MULT, "lut", use_pallas=True, fused=True))
    c = jnp.asarray(counts)
    want = jax.grad(lambda x, w: (ref["ops"].approx_grouped_dense(
        x, w, cfg, c) * jnp.arange(14)).sum(), argnums=(0, 1))(*_j(x, w))
    for got, wnt in zip(r["out"], want):
        wnt = np.asarray(wnt, np.float64)
        assert np.abs(got - wnt).max() <= GRAD_TOL * np.abs(wnt).max()
