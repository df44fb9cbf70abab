"""Kernels 8 and 9 (approximate flash attention, contiguous and paged KV)
and their planning layer, the port against the JAX reference on the CPU.

The plain PyTorch versions (``kernels/flash_attention/ref.py``, what a CPU
tensor runs) are held against the reference's Pallas kernels in interpret
mode on the same numpy inputs:

* the integer work exactly: Q/K/V codes, the int32 LUT-gather GEMMs, the
  pinned scales, the causal block bound and the geometry;
* the float output within ``TOL``: the reference's ``exp`` and ``tanh``
  are XLA's and it may contract ``a * b + c`` into an FMA, so a probability
  on a code boundary may round to the neighbouring code. One flipped code
  moves an output by at most ``max |LUT[c+1, v] - LUT[c, v]| * pv_scale``
  (``code_flip_bound``); on top, the normalizer ``l`` sums up to ``bk``
  float probabilities in another order, at most ``bk`` ulp of ``l``, so
  ``4 * bk * eps32`` of the output's scale covers the float glue.

The CUDA kernel itself is held against the same plain versions by the
test marked ``cuda``, which skips without a card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (ApproxConfig, AttnSpec, approx_attention,  # noqa: E402
                              approx_attention_paged, attn_plan, make_acu)
from repro_torch.kernels.flash_attention import ref as tref  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    approx_flash_attention, approx_flash_attention_paged)
from test_torch_parity import load_reference  # noqa: E402

MULT = "mul8s_1L2H"
EPS32 = float(np.finfo(np.float32).eps)
# on a card, kernel vs plain version: query rows allowed beyond the
# summation-order term (``chip_smoke.ATTN_FLIP_ROWS`` has the reason)
CARD_FLIP_ROWS = 2


@pytest.fixture(scope="module")
def ref():
    load_reference()
    import repro.kernels.flash_attention.approx as approx
    import repro.kernels.flash_attention.ref as jref
    return approx, jref


@pytest.fixture
def cuda():
    """Skips the test unless a CUDA device is present (decided at run
    time, never at collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU has only the plain versions")
    return torch.device("cuda")


def _lut(kind: str) -> np.ndarray:
    from repro_torch.core.lut import build_lut
    from repro_torch.core.multipliers import get_multiplier
    if kind == "biased":
        # exact product + 7: M[0, x] = 7, so masked keys, pad corrections
        # and the block bound all show in the result
        v = np.arange(-128, 128, dtype=np.int32)
        return (v[:, None] * v[None, :] + 7).astype(np.int32)
    return build_lut(get_multiplier(MULT))


def _qkv(bh, sq, sk, d, bh_kv, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(bh, sq, d)).astype(np.float32)
    k = rng.normal(size=(bh_kv, sk, d)).astype(np.float32)
    v = rng.normal(size=(bh_kv, sk, d)).astype(np.float32)
    s = [np.float32(np.abs(t).max() / np.float32(127.0)) for t in (q, k, v)]
    return q, k, v, s


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _assert_within_flip(got, want, lut, v_scale, bk):
    pv = np.float32(v_scale) * np.float32(1.0 / 127)
    tol = tref.code_flip_bound(torch.from_numpy(lut), 128, 127, pv) \
        + 4 * bk * EPS32 * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert got.shape == want.shape and err <= tol, (err, tol)


CASES = [
    # (sq, sk, d, rep, causal, window, softcap, bq, bk)
    (128, 128, 32, 1, True, None, None, 64, 64),
    (128, 256, 32, 1, False, None, None, 64, 64),     # several KV blocks
    (128, 128, 32, 4, True, None, None, 64, 64),      # GQA
    (96, 203, 24, 1, True, 17, 30.0, 64, 64),         # odd S, window, cap
    (1, 131, 32, 2, True, None, None, 64, 64),        # decode, odd Sk
    (64, 64, 20, 1, True, 9, None, 32, 32),           # odd head dim
    (40, 300, 64, 3, True, None, None, 128, 128),     # prefill, bq = 40
]


@pytest.mark.parametrize("table", ["mul8s_1L2H", "biased"])
@pytest.mark.parametrize("sq,sk,d,rep,causal,window,softcap,bq,bk", CASES)
def test_kernel8_plain_matches_reference(ref, table, sq, sk, d, rep, causal,
                                         window, softcap, bq, bk):
    import jax.numpy as jnp
    approx, _ = ref
    lut = _lut(table)
    q, k, v, s = _qkv(2 * rep, sq, sk, d, 2, seed=sq + sk)
    kw = dict(causal=causal, window=window, softcap=softcap, bq=bq, bk=bk)
    want = np.asarray(approx.approx_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lut, 128, *s, **kw))
    got = approx_flash_attention(*_t(q, k, v, lut), 128,
                                 *[torch.tensor(x) for x in s], **kw)
    assert got.dtype == torch.float32
    _assert_within_flip(got.numpy(), want, lut, s[2], min(bk, sk))


def test_integer_work_and_scales_exact(ref):
    """Codes, the LUT-gather GEMM, the pinned scales, the block bound and
    the geometry: the reference's bit for bit."""
    import jax.numpy as jnp
    approx, _ = ref
    lut = _lut("biased")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(48, 32)).astype(np.float32) * 3
    sc = np.float32(np.abs(x).max() / 127)
    want = np.asarray(approx._quantize_sym(jnp.asarray(x), sc, -128, 127, 128))
    got = tref.quantize_sym(torch.from_numpy(x), torch.tensor(sc), -128,
                            127) + 128
    assert np.array_equal(got.numpy(), want)
    a, b = want[:16], want[16:].T                 # (16, 32) x (32, 32)
    j = np.asarray(approx._lut_gemm(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(lut.reshape(-1)), 16, 256))
    t = tref.lut_bmm(torch.from_numpy(a[None]).long() * 256,
                     torch.from_numpy(b[None]).long(),
                     torch.from_numpy(lut.reshape(-1)))[0]
    assert np.array_equal(t.numpy(), j)
    for d in (16, 20, 64):
        s3 = [np.float32(v) for v in rng.uniform(1e-3, 0.1, 3)]
        js = approx.attn_scales(*[jnp.asarray([v]) for v in s3], d, 127)
        ts = tref.attn_scales(*[torch.tensor([v]) for v in s3], d, 127)
        for x_, y_ in zip(js, ts):
            assert np.array_equal(np.asarray(x_), y_.numpy())
    for q_base in (0, 5, 63, 64, 200):
        for qi in range(3):
            want_b = int(approx.causal_block_bound(q_base, qi, 8, 16, 9))
            assert int(tref.causal_block_bound(torch.tensor(q_base), qi, 8,
                                               16, 9)) == want_b
    q, k, v, s = _qkv(4, 1, 131, 20, 2, seed=1)
    _, jst = approx.prepare_approx_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lut, 128, *s,
        bits=8, rowinfo=None, bq=128, bk=128)
    _, tst = tref.prepare_approx_attention(
        *_t(q, k, v, lut), 128, *[torch.tensor(x) for x in s], bits=8,
        rowinfo=None, bq=128, bk=128)
    for key in ("seq_k_real", "d_real", "n_codes", "lo", "hi", "bq", "bk",
                "rep"):
        assert tst[key] == jst[key], key


def test_heterogeneous_rowinfo(ref):
    """Per-row [q_base, kv_start, kv_len] (continuous batching: every slot
    at its own offset with its own left pad), and keys past a row's kv_len
    are unreachable."""
    import jax.numpy as jnp
    approx, _ = ref
    lut = _lut("biased")
    q, k, v, s = _qkv(3, 1, 96, 16, 3, seed=5)
    info = np.array([[95, 13, 96], [40, 0, 41], [7, 3, 8]], np.int32)
    kw = dict(causal=True, rowinfo=info, bq=32, bk=32)
    want = np.asarray(approx.approx_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lut, 128, *s, **kw))
    st = [torch.tensor(x) for x in s]
    got = approx_flash_attention(*_t(q, k, v, lut), 128, *st,
                                 **{**kw, "rowinfo": torch.from_numpy(info)})
    _assert_within_flip(got.numpy(), want, lut, s[2], 32)
    k2, v2 = k.copy(), v.copy()
    k2[1, 41:], v2[1, 41:] = 99.0, -99.0
    got2 = approx_flash_attention(*_t(q, k2, v2, lut), 128, *st,
                                  **{**kw, "rowinfo": torch.from_numpy(info)})
    assert torch.equal(got[1], got2[1])


def _paged_setup(b, hkv, rep, sq, d, kv_lens, bk, seed):
    rng = np.random.default_rng(seed)
    hq = hkv * rep
    n_logical = max(-(-kl // bk) for kl in kv_lens)
    q, k, v, s = _qkv(b * hq, sq, n_logical * bk, d, b * hkv, seed=seed + 1)
    phys = 1 + rng.permutation(b * n_logical).reshape(b, n_logical)
    kp = np.zeros((hkv, 1 + b * n_logical, bk, d), np.float32)
    vp = np.zeros_like(kp)
    for bi in range(b):
        for h in range(hkv):
            for j in range(n_logical):
                kp[h, phys[bi, j]] = k[bi * hkv + h, j * bk:(j + 1) * bk]
                vp[h, phys[bi, j]] = v[bi * hkv + h, j * bk:(j + 1) * bk]
    info = np.stack([np.repeat([kl - sq for kl in kv_lens], hq),
                     np.zeros(b * hq, np.int64),
                     np.repeat(kv_lens, hq)], axis=1).astype(np.int32)
    pt = np.repeat(phys, hq, axis=0).astype(np.int32)
    return q, k, v, s, kp, vp, info, pt


PAGED_CASES = [
    # (b, hkv, rep, sq, d, kv_lens, causal, window, softcap, bq, bk)
    (2, 2, 1, 1, 32, (48, 33), True, None, None, 32, 16),   # decode
    (1, 2, 2, 64, 32, (64,), True, None, None, 32, 32),     # prefill, GQA
    (2, 1, 4, 1, 24, (17, 40), True, 9, 20.0, 32, 8),       # window, cap
    (3, 2, 2, 8, 16, (64, 23, 8), True, None, None, 32, 16),  # chunk rows
    (2, 2, 2, 1, 32, (31, 64), False, None, None, 32, 16),  # non-causal
]


@pytest.mark.parametrize("table", ["mul8s_1L2H", "biased"])
@pytest.mark.parametrize("b,hkv,rep,sq,d,kv_lens,causal,window,softcap,bq,bk",
                         PAGED_CASES)
def test_kernel9_plain_matches_reference_and_contiguous(
        ref, table, b, hkv, rep, sq, d, kv_lens, causal, window, softcap, bq,
        bk):
    """The paged plain version against the reference's paged kernel within
    TOL, and bitwise equal to the contiguous plain version on the gathered
    values (one shared block update, only the block start differs)."""
    import jax.numpy as jnp
    approx, _ = ref
    lut = _lut(table)
    q, k, v, s, kp, vp, info, pt = _paged_setup(b, hkv, rep, sq, d, kv_lens,
                                                bk, seed=sq + bk)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = np.asarray(approx.approx_flash_attention_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), lut, 128, *s,
        rowinfo=jnp.asarray(info), page_table=jnp.asarray(pt), rep=rep,
        bq=bq, **kw))
    st = [torch.tensor(x) for x in s]
    got = approx_flash_attention_paged(
        *_t(q, kp, vp, lut), 128, *st, rowinfo=torch.from_numpy(info),
        page_table=torch.from_numpy(pt), rep=rep, bq=bq, **kw)
    _assert_within_flip(got.numpy(), want, lut, s[2], bk)
    cont = approx_flash_attention(*_t(q, k, v, lut), 128, *st,
                                  rowinfo=torch.from_numpy(info), bq=bq,
                                  bk=bk, **kw)
    assert torch.equal(got, cont)


def test_paged_unreferenced_blocks_are_dead():
    """Pool blocks no page table points at, and pool content past a row's
    kv_len, cannot change a bit of the output."""
    lut = _lut("biased")
    b, hkv, rep, sq, d, bk = 2, 2, 2, 1, 32, 16
    q, _, _, s, kp, vp, info, pt = _paged_setup(b, hkv, rep, sq, d, (33, 48),
                                                bk, seed=9)
    kw = dict(rowinfo=torch.from_numpy(info), page_table=torch.from_numpy(pt),
              rep=rep, bq=32)
    st = [torch.tensor(x) for x in s]
    out = approx_flash_attention_paged(*_t(q, kp, vp, lut), 128, *st, **kw)
    tail = int(pt[0, 2])
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[:, 0], vp2[:, 0] = 99.0, -99.0
    kp2[:, tail, 1:], vp2[:, tail, 1:] = -77.0, 77.0
    out2 = approx_flash_attention_paged(*_t(q, kp2, vp2, lut), 128, *st,
                                        **kw)
    assert torch.equal(out[:hkv * rep], out2[:hkv * rep])


def test_four_d_views_equal_folded_operands():
    """The wrappers take (B, H, S, D) views of a (B, S, H, D) cache as
    they lie; the result equals the folded contiguous operands'."""
    lut = torch.from_numpy(_lut("mul8s_1L2H"))
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.normal(size=(2, 5, 6, 16)).astype(np.float32))
    kc = torch.from_numpy(rng.normal(size=(2, 40, 3, 16)).astype(np.float32))
    vc = torch.from_numpy(rng.normal(size=(2, 40, 3, 16)).astype(np.float32))
    s = [t.abs().amax() / 127 for t in (q, kc, vc)]
    info = torch.tensor([[35, 0, 40], [20, 4, 25]], dtype=torch.int32)
    info = info.repeat_interleave(6, dim=0)
    a = approx_flash_attention(q.transpose(1, 2), kc.transpose(1, 2),
                               vc.transpose(1, 2), lut, 128, *s,
                               rowinfo=info)
    b = approx_flash_attention(
        q.transpose(1, 2).reshape(12, 5, 16),
        kc.transpose(1, 2).reshape(6, 40, 16).contiguous(),
        vc.transpose(1, 2).reshape(6, 40, 16).contiguous(), lut, 128, *s,
        rowinfo=info)
    assert torch.equal(a, b)


def test_row_heads_share_extents():
    """One row of extents (and of the page table) per batch row, shared by
    its ``row_heads`` query rows, gives the per-head result bit for bit;
    the preparation keeps it as given for the kernel and checks its
    shape."""
    b, hkv, rep, bk = 3, 2, 2, 16
    hq = hkv * rep
    q, k, v, s, kp, vp, info, pt = _paged_setup(b, hkv, rep, 5, 16,
                                                (40, 9, 21), bk, seed=3)
    lut = torch.from_numpy(_lut(MULT))
    st = [torch.tensor(x) for x in s]
    q, k, v, kp, vp = (torch.from_numpy(a) for a in (q, k, v, kp, vp))
    info, pt = torch.from_numpy(info), torch.from_numpy(pt)
    kw = dict(rowinfo=info[::hq], row_heads=hq, bk=bk)
    assert torch.equal(
        approx_flash_attention(q, k, v, lut, 128, *st, **kw),
        approx_flash_attention(q, k, v, lut, 128, *st, rowinfo=info, bk=bk))
    assert torch.equal(
        approx_flash_attention_paged(q, kp, vp, lut, 128, *st,
                                     rowinfo=info[::hq], page_table=pt[::hq],
                                     rep=rep, row_heads=hq),
        approx_flash_attention_paged(q, kp, vp, lut, 128, *st, rowinfo=info,
                                     page_table=pt, rep=rep))
    ops, _ = tref.prepare_approx_attention(
        q, k, v, lut, 128, *st, bits=8, rowinfo=None, bq=128, bk=bk,
        pad=False, row_heads=hq)
    assert tuple(ops[4].shape) == (b, 3)
    with pytest.raises(ValueError, match="rowinfo"):
        tref.prepare_approx_attention(
            q, k, v, lut, 128, *st, bits=8, rowinfo=info, bq=128, bk=bk,
            pad=False, row_heads=hq)
    with pytest.raises(ValueError, match="rows"):
        tref.prepare_approx_attention_paged(
            q, kp, vp, lut, 128, *st, bits=8, rowinfo=info[::hq],
            page_table=pt, bq=128, pad=False, row_heads=hq)


# ---------------------------------------------------------------------------
# planning layer and the approx_ops helpers
# ---------------------------------------------------------------------------

def test_attn_plan_routes_and_audits():
    spec = AttnSpec(hq=8, hkv=2)
    fused = attn_plan(make_acu(MULT, use_kernels=True), spec)
    assert fused.route == "fused_attn" and fused.fn is not None
    d = fused.describe()
    assert d["heads"] == "hq=8 hkv=2 (rep=4)" and d["kv_layout"] == \
        "contiguous" and d["partition"] is None
    dense = attn_plan(make_acu(MULT), spec)
    assert dense.route == "dense" and dense.fn is None
    assert any("stays exact" in r for r in dense.report)
    with pytest.raises(ValueError, match="multiple"):
        attn_plan(make_acu(MULT), AttnSpec(hq=6, hkv=4))
    paged = AttnSpec(hq=8, hkv=2, kv_layout="paged", bk=16)
    acu = make_acu(MULT, use_kernels=True)
    plan = attn_plan(acu, paged)
    assert plan.route == "fused_attn_paged"
    assert plan.describe()["kv_layout"] == "paged (block=16)"
    assert any("gathers pool blocks" in r
               for r in attn_plan(make_acu(MULT), paged).report)
    with pytest.raises(ValueError, match="kv_layout"):
        attn_plan(make_acu(MULT, use_kernels=True),
                  AttnSpec(hq=8, hkv=2, kv_layout="ragged"))
    # resolved once per ACU and geometry; a replaced ACU resolves afresh
    assert attn_plan(acu, paged) is plan
    assert attn_plan(acu, paged, a_bits=4) is not plan
    off = dataclasses.replace(acu, use_kernels=False)
    assert attn_plan(off, paged).route == "dense"


def test_plan_describe_matches_reference(ref):
    load_reference()
    import repro.core.acu as jacu
    for kw in (dict(), dict(kv_layout="paged", bk=16),
               dict(window=8, softcap=30.0)):
        j = jacu.attn_plan(jacu.make_acu(MULT, use_pallas=True),
                           jacu.AttnSpec(hq=4, hkv=1, **kw), mesh=False)
        t = attn_plan(make_acu(MULT, use_kernels=True),
                      AttnSpec(hq=4, hkv=1, **kw))
        assert t.describe() == j.describe()


def test_approx_attention_helpers_match_reference(ref):
    """approx_ops.approx_attention / _paged: scales on the full tensors (the
    paged K/V ones over the referenced blocks only) and the plan, against
    the reference's helpers; None on the dense route."""
    import jax.numpy as jnp
    load_reference()
    import repro.core.acu as jacu
    import repro.core.approx_ops as jops
    lut = _lut("mul8s_1L2H")
    jcfg = jops.ApproxConfig(acu=jacu.make_acu(MULT, use_pallas=True,
                                               fused=True))
    tcfg = ApproxConfig(acu=make_acu(MULT, use_kernels=True, fused=True))
    b, hkv, rep, sq, d, bk = 2, 2, 2, 3, 16, 16
    hq = hkv * rep
    q, k, v, s, kp, vp, info, pt = _paged_setup(b, hkv, rep, sq, d, (20, 37),
                                                bk, seed=17)
    q4 = q.reshape(b, hq, sq, d)
    k4 = k.reshape(b, hkv, -1, d)
    v4 = v.reshape(b, hkv, -1, d)
    info_b, pt_b = info[::hq], pt[::hq]
    want = np.asarray(jops.approx_attention(
        jnp.asarray(q4), jnp.asarray(k4), jnp.asarray(v4), jcfg,
        rowinfo=jnp.asarray(info_b)))
    got = approx_attention(*_t(q4, k4, v4), tcfg,
                           rowinfo=torch.from_numpy(info_b))
    v_scale = np.abs(v).max() / np.float32(127)
    _assert_within_flip(got.numpy(), want, lut, v_scale, 128)
    # the pool holds other residents: the amaxes must not see them
    kp[:, 0], vp[:, 0] = 50.0, -50.0
    want = np.asarray(jops.approx_attention_paged(
        jnp.asarray(q4), jnp.asarray(kp), jnp.asarray(vp), jcfg,
        page_table=jnp.asarray(pt_b), rowinfo=jnp.asarray(info_b)))
    got = approx_attention_paged(*_t(q4, kp, vp), tcfg,
                                 page_table=torch.from_numpy(pt_b),
                                 rowinfo=torch.from_numpy(info_b))
    _assert_within_flip(got.numpy(), want, lut, v_scale, bk)
    dense = ApproxConfig(acu=make_acu(MULT))
    assert approx_attention(*_t(q4, k4, v4), dense) is None
    assert approx_attention_paged(*_t(q4, kp, vp), dense,
                                  page_table=torch.from_numpy(pt_b),
                                  rowinfo=torch.from_numpy(info_b)) is None


def test_cpu_tensors_never_launch():
    before = (approx_flash_attention.launches,
              approx_flash_attention_paged.launches)
    lut = torch.from_numpy(_lut("mul8s_1L2H"))
    q, k, v, s = _qkv(2, 3, 20, 16, 1, seed=0)
    approx_flash_attention(*_t(q, k, v), lut, 128,
                           *[torch.tensor(x) for x in s])
    assert (approx_flash_attention.launches,
            approx_flash_attention_paged.launches) == before


def _assert_same_device(got, want, lut, v_scale, bk):
    """A kernel against its plain version on the card: every element
    within the summation-order term, at most ``CARD_FLIP_ROWS`` rows beyond
    it by one code flip (``ref.same_device_agreement``)."""
    pv = np.float32(v_scale) * np.float32(1.0 / 127)
    a = tref.same_device_agreement(got.cpu(), want.cpu(),
                                   torch.from_numpy(lut), 128, 127, pv, bk)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert a["within_flip"] and a["flip_rows"] <= CARD_FLIP_ROWS, a


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_attention_kernels_match_plain_versions(cuda, dtype):
    """On a card: kernels 8 and 9 launch (their counters rise) and agree
    with their plain versions on the same device, at a decode and a
    prefill geometry, on both tables, reading bf16 K/V as given, with
    per-head extents and with one row of extents per batch row
    (``row_heads``)."""
    dt = getattr(torch, dtype)
    for table in ("mul8s_1L2H", "biased"):
        lut32 = torch.from_numpy(_lut(table)).to(cuda)
        lut16 = lut32.to(torch.int16)
        for (b, hkv, rep, sq, d, kv_lens, bq, bk) in (
                (4, 3, 3, 1, 64, (500, 17, 128, 260), 128, 16),
                (2, 3, 3, 130, 64, (130, 200), 128, 16)):
            q, k, v, s, kp, vp, info, pt = _paged_setup(
                b, hkv, rep, sq, d, kv_lens, bk, seed=sq)
            q, k, v, kp, vp = (torch.from_numpy(a).to(cuda, dt)
                               for a in (q, k, v, kp, vp))
            st = [torch.tensor(x, device=cuda) for x in s]
            info_t = torch.from_numpy(info).to(cuda)
            pt_t = torch.from_numpy(pt).to(cuda)
            want = tref.approx_attention_ref(q, k, v, lut32, 128, *st,
                                             rowinfo=info_t, bq=bq)
            want_p = tref.approx_attention_paged_ref(
                q, kp, vp, lut32, 128, *st, rowinfo=info_t, page_table=pt_t,
                rep=rep, bq=bq)
            hq = hkv * rep
            for rows, tab, heads in ((info_t, pt_t, 1),
                                     (info_t[::hq], pt_t[::hq], hq)):
                n0 = approx_flash_attention.launches
                got = approx_flash_attention(q, k, v, lut16, 128, *st,
                                             rowinfo=rows, row_heads=heads,
                                             bq=bq)
                assert approx_flash_attention.launches == n0 + 1
                _assert_same_device(got, want, _lut(table), s[2],
                                    min(128, -(-k.shape[1] // 128) * 128))
                n0 = approx_flash_attention_paged.launches
                got = approx_flash_attention_paged(
                    q, kp, vp, lut16, 128, *st, rowinfo=rows,
                    page_table=tab, rep=rep, row_heads=heads, bq=bq)
                assert approx_flash_attention_paged.launches == n0 + 1
                _assert_same_device(got, want_p, _lut(table), s[2], bk)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq", [1, 2])
def test_cuda_grouped_paged_decode(cuda, dtype, sq):
    """On a card: kernel 9's decode path (one item per batch row and KV
    head, its rep = 3 query heads sharing each page) against the plain
    version on a biased table, with unused page-table entries 0 and pool
    block 0 holding data (the causal bound of the padded q tile walks
    into them), a window and a softcap on one of the two geometries."""
    from repro_torch.kernels.flash_attention.ops import decode_plan
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(sq)
    b, hkv, rep, d, bk = 5, 3, 3, 64, 16
    hq = hkv * rep
    kv_lens = np.array([1, 17, 40, 100, 16]) + sq - 1
    n_log = -(-int(kv_lens.max() + 8) // bk)
    n_pool = 1 + b * n_log
    kp = rng.normal(size=(hkv, n_pool, bk, d)).astype(np.float32)
    vp = rng.normal(size=(hkv, n_pool, bk, d)).astype(np.float32)
    pt = np.zeros((b, n_log), np.int32)
    for i, kl in enumerate(kv_lens):
        used = -(-int(kl) // bk)
        pt[i, :used] = 1 + rng.permutation(b * n_log)[:used]
    info = np.stack([kv_lens - sq, np.zeros(b, np.int64), kv_lens],
                    1).astype(np.int32)
    q = rng.normal(size=(b, hq, sq, d)).astype(np.float32)
    s = [np.float32(np.abs(t).max() / 127) for t in (q, kp, vp)]
    lut32 = torch.from_numpy(_lut("biased")).reshape(-1).to(cuda)
    lut16 = lut32.to(torch.int16)
    qt, kt, vt = (torch.from_numpy(a).to(cuda, dt) for a in (q, kp, vp))
    st = [torch.tensor(x, device=cuda) for x in s]
    info_t, pt_t = (torch.from_numpy(a).to(cuda) for a in (info, pt))
    plan = decode_plan(b * hq, sq, d, rep, hq, bk, kt.element_size(), 256,
                       n_log, 132)
    assert plan is not None and plan.heads == rep
    for window, softcap in ((None, None), (24, 30.0)):
        want = tref.approx_attention_paged_ref(
            qt.reshape(-1, sq, d), kt, vt, lut32, 128, *st,
            rowinfo=info_t.repeat_interleave(hq, 0),
            page_table=pt_t.repeat_interleave(hq, 0), rep=rep,
            window=window, softcap=softcap)
        n0 = approx_flash_attention_paged.launches
        got = approx_flash_attention_paged(
            qt, kt, vt, lut16, 128, *st, rowinfo=info_t, page_table=pt_t,
            rep=rep, row_heads=hq, window=window, softcap=softcap)
        assert approx_flash_attention_paged.launches == n0 + 1
        _assert_same_device(got, want, _lut("biased"), s[2], bk)
    torch.cuda.synchronize()
