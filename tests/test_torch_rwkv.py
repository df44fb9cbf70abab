"""The RWKV-6 slice on the CPU: kernel 12's plain version
(``kernels/wkv/ref.py``) and its (B, T, H, hd) wrapper, the port's
``rwkv_block``, ``apply_model`` and the wave and continuous engines at
``reduced_config("rwkv6-3b")`` (2 layers, d 64, 4 wkv heads x 16, d_ff 256,
vocab 211), against the JAX reference; and, on a card, kernel 12 against
its plain version (marked ``cuda``).

The reference's init sets ``lora_B_*`` and ``bonus`` to 0 and every decay
to one value, which would leave the LoRA token shift and the ``u`` term
unexercised: :func:`perturb` draws them (and the ``mu_*`` mixes) from a
numpy seed, identically for both packages.

Tolerances, with their reasons:

* The recurrence, against ``wkv_ref`` run op by op (``jax.disable_jit``):
  the state bitwise (each multiply and add rounds on its own in both);
  ``out`` within ``out_bound``, ``hd * eps * sum_k |r_k a[k, v]|``, the
  room two summation orders of the k-sum have. Compiled, XLA contracts
  ``w*S + kv`` into one FMA, which moves each step's state by at most half
  an ulp of ``|w*S|``; over T steps (the decay shrinks older errors) that
  is within ``T * eps * max|S|``, and ``out`` within ``out_bound`` plus
  that state error through ``sum_k |r_k|``.
* The block and the model in float32, ``TOL`` of the largest value: the
  plain LoRA and decay products sum in another order than XLA's, and
  XLA's ``tanh``, ``exp``, ``rsqrt`` and logistic round an ulp or two
  apart from PyTorch's (``test_torch_lm.py``); two layers carry that to a
  few hundred ulp at most (measured: 4e-6 on the exact path, 2e-7 on the
  fused ACU), while one flipped activation code would move a value by a
  whole table step times two scales, about 1e-2 here, which the bound
  catches.
* bfloat16 logits: bitwise against the reference run op by op. Compiled,
  the reference's scan fuses bfloat16 roundings away (ROADMAP observation
  (b)); its logits then move by several percent and flip argmaxes, so the
  engines are held against it in float32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.core import ApproxConfig, make_acu  # noqa: E402
from repro_torch.kernels.wkv import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.wkv.ref import out_bound, wkv_ref  # noqa: E402
from repro_torch.models import rwkv as TR  # noqa: E402
from repro_torch.models.transformer import (apply_model,  # noqa: E402
                                            init_cache, init_paged_cache,
                                            init_params, load_jax_params)
from repro_torch.serve.engine import PagedContinuousServeEngine  # noqa: E402
from test_torch_lm_serve import engine_parity  # noqa: E402
from test_torch_parity import load_reference  # noqa: E402

ARCH = "rwkv6-3b"
MULT = "mul8s_1L2H"
TOL = 1e-5
EPS = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module")
def ref():
    load_reference()
    import repro.configs as jconfigs
    import repro.core as jcore
    import repro.kernels.wkv.ref as jwkv
    import repro.models.rwkv as jrwkv
    import repro.models.transformer as jtrans
    return dict(configs=jconfigs, core=jcore, wkv=jwkv, rwkv=jrwkv,
                trans=jtrans)


@pytest.fixture
def cuda():
    """Skips the test unless a CUDA device is present (decided at run
    time, never at collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU has only the plain version")
    return torch.device("cuda")


def perturb(tree, seed: int = 0):
    """The reference's parameter tree with every rwkv layer's ``lora_B_*``
    (N(0, 0.3)), ``bonus`` (N(0, 0.5)), ``decay_base`` (U(-2, 1), decays
    0.07 to 0.87) and ``mu_*`` (U(0, 1)) drawn from a numpy seed, in each
    leaf's dtype."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    draw = {"lora_B": lambda s: rng.normal(size=s) * 0.3,
            "bonus": lambda s: rng.normal(size=s) * 0.5,
            "decay_base": lambda s: rng.uniform(-2.0, 1.0, s),
            "mu_": lambda s: rng.uniform(0.0, 1.0, s),
            "cm_mu": lambda s: rng.uniform(0.0, 1.0, s)}

    def layer(p):
        out = dict(p)
        for name, leaf in p.items():
            for prefix, fn in draw.items():
                if name.startswith(prefix):
                    out[name] = jnp.asarray(fn(leaf.shape), leaf.dtype)
        return out

    groups = {k: {"rwkv": layer(v["rwkv"])}
              for k, v in tree["groups"].items()}
    return {**tree, "groups": groups}


def _cfgs(ref, dtype="float32"):
    return (dataclasses.replace(ref["configs"].reduced_config(ARCH),
                                dtype=dtype),
            dataclasses.replace(reduced_config(ARCH), dtype=dtype))


def _params(ref, jcfg):
    import jax
    jp = perturb(ref["trans"].init_params(jax.random.PRNGKey(0), jcfg))
    return jp, load_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _acfgs(ref, route):
    if route == "exact":
        return None, None
    jcore = ref["core"]
    return (jcore.ApproxConfig(acu=jcore.make_acu(
        MULT, "lut", use_pallas=True, interpret=True, fused=True)),
        ApproxConfig(acu=make_acu(MULT, "lut", use_kernels=True,
                                  fused=True)))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    import jax.numpy as jnp
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _recurrence(rng, bh, t, hd, h):
    r, k, v = (rng.normal(size=(bh, t, hd)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.05, 0.95, (bh, t, hd)).astype(np.float32)
    u = rng.normal(size=(h, hd)).astype(np.float32)
    s0 = rng.normal(size=(bh, hd, hd)).astype(np.float32)
    return r, k, v, w, u, s0


# ---------------------------------------------------------------------------
# kernel 12's plain version and wrapper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [1, 7, 16])
def test_wkv_plain_matches_reference_per_head(ref, t):
    """Rows of each head against the reference's ``wkv_ref`` (one bonus per
    call), with nonzero ``s0`` and ``u``: op by op, the state bitwise and
    ``out`` within ``out_bound``; compiled, within the FMA bound (module
    docstring)."""
    import jax
    import jax.numpy as jnp
    jwkv = ref["wkv"]
    h, hd = 3, 16
    arrs = _recurrence(np.random.default_rng(t), 2 * h, t, hd, h)
    tt = [torch.from_numpy(a) for a in arrs]
    out, s_t = wkv_ref(*tt)
    bound = out_bound(*tt).numpy()
    r, k, v, w, u, s0 = arrs
    for head in range(h):
        rows = np.arange(head, 2 * h, h)
        args = [jnp.asarray(a[rows]) for a in (r, k, v, w)] + [
            jnp.asarray(u[head]), jnp.asarray(s0[rows])]
        with jax.disable_jit():
            jo, js = jwkv.wkv_ref(*args)
        assert np.array_equal(s_t.numpy()[rows], np.asarray(js))
        assert (np.abs(out.numpy()[rows] - np.asarray(jo))
                <= bound[rows]).all()
        co, cs = jwkv.wkv_ref(*args)
        s_err = t * EPS * np.abs(np.asarray(cs)).max()
        assert np.abs(s_t.numpy()[rows] - np.asarray(cs)).max() <= s_err
        o_err = bound[rows] + np.abs(r[rows]).sum(-1, keepdims=True) * s_err
        assert (np.abs(out.numpy()[rows] - np.asarray(co)) <= o_err).all()


def test_wkv_wrapper_layout_and_state_in_place():
    """The (B, T, H, hd) wrapper folds heads h-major, row ``b*H + h`` taking
    ``u[h]``, and writes ``S_T`` into ``state_out`` (here ``s0`` itself);
    on the CPU it launches nothing."""
    b, t, h, hd = 2, 5, 3, 16
    r, k, v, w, u, s0 = _recurrence(np.random.default_rng(9), b * h, t, hd, h)
    want_out, want_s = wkv_ref(*(torch.from_numpy(a)
                                 for a in (r, k, v, w, u, s0)))

    def unfold(a):           # (B*H, T, hd) -> (B, T, H, hd)
        return torch.from_numpy(a).reshape(b, h, t, hd).transpose(1, 2)

    state = torch.from_numpy(s0.copy()).reshape(b, h, hd, hd)
    before = wkv_ops.wkv.launches
    out, s_t = wkv_ops.wkv(unfold(r), unfold(k), unfold(v), unfold(w),
                           torch.from_numpy(u), state, state_out=state)
    assert s_t is state and wkv_ops.wkv.launches == before
    assert torch.equal(s_t, want_s.reshape(b, h, hd, hd))
    assert torch.equal(out, want_out.reshape(b, h, t, hd).transpose(1, 2))
    with pytest.raises(ValueError):
        wkv_ops.wkv(unfold(r), unfold(k), unfold(v), unfold(w),
                    torch.from_numpy(u[:2]), state)


# ---------------------------------------------------------------------------
# block and model
# ---------------------------------------------------------------------------

def test_init_params_layout_matches_reference(ref):
    """Leaf names, shapes and dtypes of the rwkv layers, the caches' too,
    in bfloat16; the paged cache refuses rwkv in both packages."""
    import jax
    jcfg, cfg = _cfgs(ref, "bfloat16")
    jtrans = ref["trans"]
    jp = jtrans.init_params(jax.random.PRNGKey(0), jcfg)
    tp = init_params(0, cfg, device="cpu")
    for tree_j, tree_t in ((jp, tp), (jtrans.init_cache(jcfg, 2, 8),
                                      init_cache(cfg, 2, 8, device="cpu"))):
        jl = {tuple(getattr(k, "key", getattr(k, "name", k)) for k in path):
              leaf for path, leaf in
              jax.tree_util.tree_flatten_with_path(tree_j)[0]}
        flat = {}

        def walk(tree, path=()):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    walk(v, path + (k,))
            elif isinstance(tree, tuple):
                for k, v in zip(getattr(tree, "_fields", range(len(tree))),
                                tree):
                    walk(v, path + (k,))
            else:
                flat[path] = tree
        walk(tree_t)
        assert set(flat) == set(jl)
        for key, leaf in jl.items():
            assert tuple(flat[key].shape) == leaf.shape, key
            assert str(flat[key].dtype).split(".")[-1] == str(leaf.dtype), key
    for init in (jtrans.init_paged_cache,
                 lambda c, n, bs: init_paged_cache(c, n, bs, device="cpu")):
        with pytest.raises(NotImplementedError, match="attention-only"):
            init((jcfg if init is jtrans.init_paged_cache else cfg), 4, 8)


@pytest.mark.parametrize("route", ["exact", "fused"])
def test_rwkv_block_prefill_then_decode(ref, route):
    """One layer, float32: an 8-token prefill from no state, then three
    decode steps from the prefill's state, outputs and every state leaf
    within ``TOL`` of the reference's."""
    import jax
    import jax.numpy as jnp
    jcfg, cfg = _cfgs(ref)
    jp, tp = _params(ref, jcfg)
    jblk = jax.tree.map(lambda a: a[0], jp["groups"]["b0"]["rwkv"])
    tblk = {k: v[0] for k, v in tp["groups"]["b0"]["rwkv"].items()}
    jacfg, tacfg = _acfgs(ref, route)
    x = np.random.default_rng(4).normal(size=(2, 11, cfg.d_model)
                                        ).astype(np.float32)
    jrwkv = ref["rwkv"]
    with torch.inference_mode():
        jy, jst = jrwkv.rwkv_block(jnp.asarray(x[:, :8]), jblk, jcfg, jacfg)
        ty, tst = TR.rwkv_block(torch.from_numpy(x[:, :8]), tblk, cfg, tacfg)
        _close(ty, jy)
        for a, b in zip(tst, jst):
            _close(a, b)
        state = TR.RwkvState(*(t.clone() for t in tst))
        for t in range(8, 11):
            jy, jst = jrwkv.rwkv_block(jnp.asarray(x[:, t:t + 1]), jblk,
                                       jcfg, jacfg, state=jst, decode=True)
            ty, back = TR.rwkv_block(torch.from_numpy(x[:, t:t + 1]), tblk,
                                     cfg, tacfg, state=state)
            assert back is state          # written in place
            _close(ty, jy)
            for a, b in zip(state, jst):
                _close(a, b)


def _prefill_decode(apply, init, params, cfg, acfg, toks, **kw):
    cache = init(cfg, 2, 32, **kw)
    logits, cache = apply(params, toks[0], cfg, acfg=acfg, cache=cache,
                          cache_pos=0)
    step, cache = apply(params, toks[1], cfg, acfg=acfg, cache=cache,
                        cache_pos=toks[0].shape[1], decode=True)
    return logits, step, cache


def _model_pair(ref, dtype, route, op_by_op=False):
    import contextlib
    import jax
    import jax.numpy as jnp
    jcfg, cfg = _cfgs(ref, dtype)
    jp, tp = _params(ref, jcfg)
    jacfg, tacfg = _acfgs(ref, route)
    rng = np.random.default_rng(0)
    toks = [rng.integers(1, cfg.vocab_size, (2, n)) for n in (12, 1)]
    with jax.disable_jit() if op_by_op else contextlib.nullcontext():
        want = _prefill_decode(ref["trans"].apply_model,
                               ref["trans"].init_cache, jp, jcfg, jacfg,
                               [jnp.asarray(t, jnp.int32) for t in toks])
    with torch.inference_mode():
        got = _prefill_decode(apply_model, init_cache, tp, cfg, tacfg,
                              [torch.from_numpy(t) for t in toks],
                              device="cpu")
    return want, got


@pytest.mark.parametrize("route", ["exact", "fused"])
def test_apply_model_float32(ref, route):
    """Prefill (12 tokens) and a decode step: logits within ``TOL`` with
    the reference's argmax, and both layers' wkv states within ``TOL``."""
    want, got = _model_pair(ref, "float32", route)
    for w, g in zip(want[:2], got[:2]):
        _close(g, w)
        assert np.array_equal(_np(g).argmax(-1), _np(w).argmax(-1))
    for name in ("b0",):
        for gi in range(2):
            _close(got[2]["groups"][name]["rwkv"].wkv[gi],
                   want[2]["groups"][name]["rwkv"].wkv[gi])


def test_apply_model_bfloat16_bitwise_op_by_op(ref):
    """bfloat16, the exact path (the float glue this slice adds: LoRA
    mixes, decay, group norm, gates, every cast): prefill and decode logits
    equal the reference run op by op, bit for bit. The fused ACU's
    bfloat16 GEMMs are held bitwise by ``test_torch_lm.py`` and
    ``test_torch_quantize.py``; run op by op through interpret-mode
    Pallas they would cost this file half a minute more."""
    want, got = _model_pair(ref, "bfloat16", "exact", op_by_op=True)
    for w, g in zip(want[:2], got[:2]):
        assert g.dtype == torch.bfloat16
        assert np.array_equal(g.view(torch.int16).numpy(),
                              np.asarray(w).view(np.int16))


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["wave", "continuous"])
def test_engines_give_reference_tokens(engine, monkeypatch):
    """Five requests of mixed lengths through two slots (the continuous
    engine reuses slots whose free rows kept stepping their state), the
    reference's perturbed parameters, float32: the reference engine's
    tokens, request for request. Left pads enter the recurrence in both."""
    engine_parity(engine, "float32", ARCH, monkeypatch, perturb=perturb)


def test_paged_engine_refuses_rwkv(ref):
    """The paged engine pages attention KV only. The port refuses an rwkv
    model when the engine is built, with ``NotImplementedError`` (as its
    ``init_paged_cache`` does, like the reference's); the reference's
    engine fails at the same point, dividing its budget by zero block
    bytes."""
    import repro.serve.engine as jengine
    jcfg, cfg = _cfgs(ref)
    jp, tp = _params(ref, jcfg)
    with pytest.raises(ZeroDivisionError):
        jengine.PagedContinuousServeEngine(jp, jcfg, slots=2, max_seq=32,
                                           block_size=8)
    with pytest.raises(NotImplementedError, match="attention-only"):
        PagedContinuousServeEngine(tp, cfg, slots=2, max_seq=32,
                                   block_size=8, device="cpu")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_wkv_kernel_matches_plain_version(cuda):
    """Kernel 12 against its plain version at prefill (T = 33) and decode
    (T = 1), hd 64 and 16 (rwkv6-3b's and its reduced config's), strided
    r/v/w (views of the folded layout), the state written in place:
    ``S_T`` bitwise, ``out`` within ``out_bound``."""
    rng = np.random.default_rng(12)
    for b, t, h, hd in ((2, 33, 3, 64), (3, 1, 5, 64), (2, 9, 2, 16)):
        arrs = _recurrence(rng, b * h, t, hd, h)
        r, k, v, w, u, s0 = (torch.from_numpy(a).to(cuda) for a in arrs)
        want_out, want_s = wkv_ref(r, k, v, w, u, s0)
        bound = out_bound(r, k, v, w, u, s0)

        def unfold(a):
            return a.reshape(b, h, t, hd).transpose(1, 2)

        state = s0.clone().reshape(b, h, hd, hd)
        before = wkv_ops.wkv.launches
        out, s_t = wkv_ops.wkv(unfold(r), unfold(k).contiguous(),
                               unfold(v), unfold(w), u, state,
                               state_out=state)
        torch.cuda.synchronize()
        assert wkv_ops.wkv.launches == before + 1 and s_t is state
        assert torch.equal(s_t.reshape(b * h, hd, hd), want_s)
        diff = (out.transpose(1, 2).reshape(b * h, t, hd) - want_out).abs()
        assert bool((diff <= bound).all())
