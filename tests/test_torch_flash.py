"""Kernel 11 (exact flash attention) and the ``impl="flash"`` route of
``gqa_attention``, the port against the JAX reference on the CPU.

The plain version (``kernels/flash_attention/ref.py: flash_attention_ref``,
what a CPU tensor runs) is held against the reference's Pallas kernel in
interpret mode on the same numpy inputs, at the port's own tiles (64 x 64)
against the reference's (32 x 32), so the tiling is shown not to matter:

* float32: within ``F32_TOL`` = 1e-5 (absolute and relative). Both compute
  in float32; the dot products, the normalizer and the accumulator sum in
  another order and ``exp``/``tanh`` round an ulp or two apart, a few
  hundred ulp of outputs of order 1 at these sizes;
* bfloat16: within one bfloat16 ulp of the larger value plus ``F32_TOL``
  (the two float32 results round to bfloat16 on either side of a rounding
  boundary at most one step apart).

The reference asserts whole tiles; a ragged S is held against a numpy
computation of the kernel's semantics (queries aligned to key 0).

``gqa_attention(impl="flash")`` takes kernel 11 exactly for calls with
``q_offset`` the int 0, no ``pad_mask`` and no gradient wanted; a spy
shows each route, and every route agrees with the reference's
``gqa_attention`` (whose ``flash`` is its chunked path) within 1e-5.

The CUDA kernel itself is held against the plain version by the test
marked ``cuda``, which skips without a card.
"""
from __future__ import annotations

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ref as tref  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention)
from repro_torch.models import layers as TL  # noqa: E402
from test_torch_parity import load_reference  # noqa: E402

F32_TOL = 1e-5

# (name, causal, window, softcap, rep, Sq, Sk, dtypes)
F32, BOTH = ("float32",), ("float32", "bfloat16")
CASES = [("causal", True, None, None, 1, 128, 128, F32),
         ("window", True, 24, None, 2, 128, 128, BOTH),
         ("softcap", True, None, 30.0, 4, 128, 128, F32),
         ("window_softcap", True, 40, 50.0, 2, 128, 128, BOTH),
         ("noncausal", False, None, None, 1, 128, 128, F32),
         ("noncausal_window", False, 40, None, 4, 128, 128, BOTH),
         ("sq_lt_sk", True, None, None, 2, 64, 128, F32),
         ("sq_lt_sk_window", True, 32, 50.0, 1, 64, 128, BOTH)]
DTYPE_CASES = [(c, dt) for c in CASES for dt in c[-1]]


@pytest.fixture(scope="module")
def ref():
    load_reference()
    import repro.kernels.flash_attention.kernel as jkernel
    import repro.models.layers as jlayers
    return jkernel, jlayers


@pytest.fixture
def cuda():
    """Skips the test unless a CUDA device is present (decided at run
    time, never at collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU has only the plain version")
    return torch.device("cuda")


def _inputs(seed, bh, rep, sq, sk, d=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(bh, sq, d)).astype(np.float32),
            rng.normal(size=(bh // rep, sk, d)).astype(np.float32),
            rng.normal(size=(bh // rep, sk, d)).astype(np.float32))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at ``|x|`` (8 significant bits)."""
    a = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _numpy_attention(q, k, v, *, causal, window, softcap, rep):
    """Kernel 11's function in float64 numpy: query row i at position i
    (key 0 aligned), masked keys excluded."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    kk, vv = (np.repeat(a.astype(np.float64), rep, 0) for a in (k, v))
    s = np.einsum("bqd,bkd->bqk", q.astype(np.float64), kk) / math.sqrt(d)
    if softcap is not None:
        s = softcap * np.tanh(s / softcap)
    i, j = np.arange(sq)[:, None], np.arange(sk)[None, :]
    mask = np.ones((sq, sk), bool)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= j > i - window
    s = np.where(mask, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bqk,bkd->bqd", p / p.sum(-1, keepdims=True), vv)


@pytest.mark.parametrize("case,dtype", DTYPE_CASES,
                         ids=[f"{c[0]}-{dt}" for c, dt in DTYPE_CASES])
def test_plain_version_matches_reference_kernel(ref, case, dtype):
    """The plain version against the reference's Pallas kernel in
    interpret mode: GQA (``rep`` 1, 2, 4), causal or not, window, softcap,
    Sq < Sk, within the module docstring's tolerances."""
    import jax.numpy as jnp
    _, causal, window, softcap, rep, sq, sk, _ = case
    q, k, v = _inputs(sq + sk + rep, 8, rep, sq, sk)
    jdt = jnp.dtype(dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    want = np.asarray(ref[0].flash_attention_kernel(
        jq, jk, jv, causal=causal, window=window, softcap=softcap, bq=32,
        bk=32, rep=rep, interpret=True).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in (jq, jk, jv))
    got = tref.flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                                   softcap=softcap, rep=rep)
    assert got.dtype == getattr(torch, dtype) and got.shape == tq.shape
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
        assert (np.abs(got - want) <= ulp + F32_TOL).all()


@pytest.mark.parametrize("sq,sk,window,softcap", [
    (100, 100, None, None), (100, 100, 24, 50.0), (50, 77, 30, None),
    (130, 65, None, 20.0)])
def test_plain_version_ragged_edges(sq, sk, window, softcap):
    """S not a multiple of the tiles: rows past Sq are dropped and keys
    past Sk are absent, so the result is the kernel's function on the
    real keys (numpy, float64), within ``F32_TOL``. Sq > Sk too: the rows
    past Sk see every key."""
    q, k, v = _inputs(sq * sk, 4, 2, sq, sk)
    want = _numpy_attention(q, k, v, causal=True, window=window,
                            softcap=softcap, rep=2)
    got = tref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                   causal=True, window=window,
                                   softcap=softcap, rep=2)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL,
                               atol=F32_TOL)


def test_wrapper_on_cpu_takes_the_plain_version():
    """A CPU tensor never launches: (B, H, S, D) strided views of (B, S,
    H, D) tensors give the plain version's result in q's shape."""
    q, k, v = _inputs(3, 8, 4, 40, 40)
    q4, k4, v4 = (torch.from_numpy(a).reshape(2, -1, 40, 16).transpose(1, 2)
                  .contiguous().transpose(1, 2) for a in (q, k, v))
    n0 = flash_attention.launches
    got = flash_attention(q4, k4, v4, window=8, softcap=50.0)
    assert flash_attention.launches == n0
    want = tref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                    window=8, softcap=50.0, rep=4)
    assert got.shape == q4.shape
    assert torch.equal(got.reshape(8, 40, 16), want)


def _tolerance_inputs(scale):
    """(q, k, v) with 64-dim heads, 4 query rows over 2 KV rows, 512 keys;
    q times ``scale`` (10 puts scores in the softcap's nonlinear range)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, 4, 2, 512, 512, d=64))
    return q * scale, k, v


def test_tolerance_holds_two_orders_apart():
    """``flash_tolerance`` covers the plain version at two tilings (the
    kernel's 64 x 64 and 16 x 16) with room to spare, element by element,
    and float32 against float64 stays within a tenth of it, at unit and
    10x scores."""
    kw = dict(window=200, softcap=50.0, rep=2)
    for scale in (1.0, 10.0):
        t = _tolerance_inputs(scale)
        a = tref.flash_attention_ref(*t, **kw)
        b = tref.flash_attention_ref(*t, bq=16, bk=16, **kw)
        tol = tref.flash_tolerance(*t, a, **kw)
        assert tol.shape == a.shape
        assert bool(((a - b).abs() <= tol / 2).all())
        want = torch.from_numpy(_numpy_attention(
            *(x.numpy() for x in t), causal=True, **kw))
        assert bool(((a.double() - want).abs() <= tol / 10).all())


@pytest.mark.parametrize("fault", ["window_minus_one", "softcap_dropped",
                                   "first_tile_dropped"])
def test_tolerance_rejects_planted_faults(fault):
    """A kernel with one of these faults would fail ``flash_tolerance``:
    one key less in each window (most rows past the window), the softcap
    dropped (scores at 10x) and the first KV tile dropped (most rows past
    it whose window reaches into it), each computed with the plain
    version."""
    t = _tolerance_inputs(10.0 if fault == "softcap_dropped" else 1.0)
    kw = dict(window=200, softcap=50.0, rep=2)
    a = tref.flash_attention_ref(*t, **kw)
    tol = tref.flash_tolerance(*t, a, **kw)
    if fault == "window_minus_one":
        bad = tref.flash_attention_ref(*t, **dict(kw, window=199))
        a, bad, tol = a[:, 200:], bad[:, 200:], tol[:, 200:]
    elif fault == "softcap_dropped":
        bad = tref.flash_attention_ref(*t, **dict(kw, softcap=None))
    else:
        bad = tref.flash_attention_ref(*(x[:, 64:] for x in t), **kw)
        # the rows past the tile whose window still reaches into it
        a, bad, tol = a[:, 64:264], bad[:, :200], tol[:, 64:264]
    beyond = ((a - bad).abs() > tol).any(-1)
    assert float(beyond.double().mean()) > 0.5


def _gemma_qkv(seed, s_len, dtype=torch.float32):
    """gemma2-27b reduced shapes: 4 query heads over 2 KV heads, head dim
    16; window 8 < S."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(2, s_len, h, 16)).astype(
        np.float32)).to(dtype) for h in (4, 2, 2)]


@pytest.mark.parametrize("call", ["flash", "q_offset", "vector_offset",
                                  "pad_mask", "grad"])
def test_gqa_flash_route(ref, monkeypatch, call):
    """``impl="flash"`` at gemma2-27b reduced shapes (window 8, softcap
    50): the kernel exactly for the cache-less call, the chunked path for
    an offset, per-row offsets, a pad mask or a gradient; each route
    within 1e-5 of the reference's ``gqa_attention``."""
    import jax.numpy as jnp
    calls = []
    inner = TL.flash_attention

    def spy(*a, **k):
        calls.append(a[0].shape)
        return inner(*a, **k)

    monkeypatch.setattr(TL, "flash_attention", spy)
    q, k, v = _gemma_qkv(7, 24)
    kw = dict(causal=True, window=8, softcap=50.0, chunk=8, impl="flash")
    jkw, tkw = {}, {}
    if call == "q_offset":
        jkw["q_offset"] = tkw["q_offset"] = 20
    if call == "vector_offset":
        off = np.array([23, 9])
        jkw["q_offset"], tkw["q_offset"] = jnp.asarray(off), \
            torch.from_numpy(off)
    if call == "pad_mask":
        pm = np.ones((2, 24), bool)
        pm[1, :5] = False
        jkw["pad_mask"], tkw["pad_mask"] = jnp.asarray(pm), \
            torch.from_numpy(pm)
    if call == "grad":
        q.requires_grad_(True)
    want = ref[1].gqa_attention(*(jnp.asarray(t.detach().numpy())
                                  for t in (q, k, v)), **kw, **jkw)
    got = TL.gqa_attention(q, k, v, **kw, **tkw)
    assert len(calls) == (1 if call == "flash" else 0)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    if call == "grad":
        got.sum().backward()
        assert q.grad is not None and bool(torch.isfinite(q.grad).all())
        with torch.no_grad():
            TL.gqa_attention(q, k, v, **kw)
        assert len(calls) == 1       # the same call without a gradient


@pytest.mark.cuda
def test_cuda_flash_attention_matches_plain_version(cuda):
    """On a card: kernel 11 launches (its counter rises) and agrees with
    its plain version on the same device within ``flash_tolerance``, in
    float32 and bfloat16, head dims 64 and 128, GQA, window and softcap,
    ragged S and Sq < Sk, on (B, H, S, D) views of (B, S, H, D) tensors
    and on folded (rows, S, D) tensors."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for (b, hq, hkv, sq, sk, d, causal, window, cap) in (
                (1, 8, 4, 300, 300, 128, True, 100, 50.0),
                (2, 9, 3, 129, 129, 64, True, None, None),
                (1, 4, 4, 70, 200, 128, True, 64, None),
                (1, 4, 2, 64, 64, 64, False, None, 30.0),
                (2, 4, 1, 1, 33, 64, True, None, None)):
            q = torch.randn((b, sq, hq, d), generator=gen, device=cuda)
            k, v = (torch.randn((b, sk, hkv, d), generator=gen, device=cuda)
                    for _ in range(2))
            q, k, v = (t.to(dtype) for t in (q, k, v))
            kw = dict(causal=causal, window=window, softcap=cap)
            fold = [t.transpose(1, 2).reshape(-1, t.shape[1], d)
                    for t in (q, k, v)]
            want = tref.flash_attention_ref(*fold, rep=hq // hkv, **kw)
            tol = tref.flash_tolerance(*fold, want, rep=hq // hkv, **kw)
            for views in ([t.transpose(1, 2) for t in (q, k, v)], fold):
                n0 = flash_attention.launches
                got = flash_attention(*views, **kw)
                assert flash_attention.launches == n0 + 1
                assert got.dtype == dtype and got.shape == views[0].shape
                got = got.reshape(want.shape)
                err = (got.double() - want.double()).abs()
                assert bool(torch.isfinite(got).all())
                assert bool((err <= tol).all()), float((err / tol).max())
    torch.cuda.synchronize()
