"""Every ACU plan on a mesh of ranks, against the single-device reference
(the port's mirror of ``tests/test_sharded_acu.py``).

The module starts its 8 gloo ranks once (the ``mesh_run`` fixture,
``tests/mesh_cases.py``), while ``REF_WORKERS`` spawned processes compute
the reference's results (``want``): the 2 x 4 ``(data, model)`` mesh of
``launch/mesh.py: make_host_multi_mesh``, the counterpart of the
reference's 8 forced host devices. Every rank runs every case on the same
global inputs through ``use_mesh``, so every plan takes its sharded route
(``parallel/acu_shard.py``). Each test holds, from every rank:

* the sharded result bitwise equal to the port's own one-rank result
  (``mesh=False``), which is what the reference's test asserts of itself;
* that one-rank result against the reference's single-device result
  (interpret-mode kernels), bitwise wherever the work is integer and the
  float glue rounds as the reference's: the GEMM accumulators, every
  fused and unfused output, the approximate backward. Two kinds of result
  are float sums the two libraries order differently, and are held as the
  port's other tests hold them: the exact float32 STE gradients within
  ``GRAD_TOL`` of each gradient's largest entry, and LOWRANK within
  ``kernels/err_matmul/ref.py: summation_bound``.

The reference's slow-marked ImageNet-scale case runs on the card instead
(``chip_smoke.py: mesh_phase``). Also here: kernel 7's ``rmask`` plain
version bitwise against the reference's interpret-mode kernel, and
``make_host_multi_mesh`` refusing a group too small.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mesh_cases as mc  # noqa: E402
from test_torch_parity import load_reference  # noqa: E402

GRAD_TOL = 1e-5


_REF: dict = {}


def _ref_modules() -> dict:
    """The reference's modules, loaded once a process."""
    if not _REF:
        load_reference()
        import repro.core as jcore
        import repro.core.acu as jacu
        import repro.core.approx_ops as jops
        import repro.core.quantization as jq
        _REF.update(core=jcore, acu=jacu, ops=jops, q=jq)
    return _REF


@pytest.fixture(scope="module")
def ref():
    return _ref_modules()


def _ref_acu(ref, kind, fused=False):
    core = ref["core"]
    if kind == "lut_jnp":
        return core.make_acu(mc.MULT, "lut")
    if kind == "lut_pallas":
        return core.make_acu(mc.MULT, "lut", use_pallas=True, fused=fused)
    if kind == "functional":
        return core.make_acu(mc.MULT, "functional")
    if kind == "factored":
        return core.make_acu("mul8s_trunc2", "factored")
    if kind == "lowrank":
        return core.make_acu(mc.MULT, "lowrank")
    if kind == "exact":
        return core.make_acu("mul8s_exact", "exact")
    if kind == "biased":
        return dataclasses.replace(core.make_acu(
            "mul8s_exact", "lut", use_pallas=True, fused=fused),
            lut=mc.BIASED_LUT)
    raise KeyError(kind)


def _ref_cfg(ref, kind="lut_pallas", fused=True, **kw):
    return ref["core"].ApproxConfig(acu=_ref_acu(ref, kind, fused), **kw)


# ---------------------------------------------------------------------------
# the reference's single-device results, one function a case (numpy out)
# ---------------------------------------------------------------------------

def _want_unfused(ref, name, shape):
    a, w = mc.int_operands(*shape, seed=sum(shape))
    return ref["acu"].matmul_plan(_ref_acu(ref, name), mesh=False)(
        *_j(a, w))


def _want_fused(ref, shape):
    M, K, N = shape
    x, w = _j(*mc.normal(K, (M, K), (K, N)))
    xqp, wqp = _ref_qparams(ref, x, w)
    return ref["ops"].approx_matmul(x, w, _ref_cfg(ref), xqp, wqp)


def _want_dense(ref, fused):
    x, w = _j(*mc.normal(8, (4, 37, 96), (96, 48)))
    cfg = ref["core"].ApproxConfig(acu=_ref_acu(ref, "lut_pallas"),
                                   fused=fused)
    return ref["ops"].approx_dense(x, w, None, cfg)


def _want_kpad(ref, fused):
    x, w = _j(*mc.normal(7, (12, 70), (70, 9)))
    cfg = ref["core"].ApproxConfig(acu=_ref_acu(ref, "biased", fused),
                                   fused=fused)
    return ref["ops"].approx_dense(x, w, None, cfg)


def _want_ste(ref, fused):
    import jax
    x, w = _j(*mc.normal(4, (18, 40), (40, 11)))
    xqp, wqp = _ref_qparams(ref, x, w)
    cfg = ref["core"].ApproxConfig(acu=_ref_acu(ref, "lut_pallas"),
                                   fused=fused)
    return jax.grad(lambda x, w: (ref["ops"].approx_matmul(
        x, w, cfg, xqp, wqp) ** 2).sum(), argnums=(0, 1))(x, w)


def _want_grouped_conv(ref):
    x, w = _j(*mc.normal(2, (2, 8, 6, 6), (8, 4, 3, 3)))
    return ref["ops"].conv2d(x, w, groups=2, cfg=_ref_cfg(ref, "lut_jnp"))


def _want_serve_engine(ref):
    import jax
    from repro.configs import reduced_config
    from repro.models.transformer import init_params
    from repro.serve.engine import Request, ServeEngine
    cfg = dataclasses.replace(reduced_config("smollm-135m"), dtype="float32")
    params = init_params(jax.random.PRNGKey(0), cfg)
    want = ServeEngine(params, cfg, slots=2, max_seq=32).run(
        [Request(prompt=np.asarray([5, 17, 3], np.int32),
                 max_new_tokens=4)])
    return list(want[0].out)


def _want_acu_matmul(ref):
    a, w = mc.int_operands(10, 30, 6, seed=1)
    return _ref_acu(ref, "lut_jnp").matmul(*_j(a, w))


def _ref_conv(ref, x, w, b, kw, cfg=None):
    return ref["ops"].conv2d(x, w, b, cfg=cfg or _ref_cfg(ref), **kw)


def _want_conv(ref, geoms, geom, route):
    shape, wshape, kw = geoms[geom]
    x, w, b = _j(*mc.normal(sum(shape), shape, wshape, (wshape[0],)))
    kw = dict(kw, route=route) if route else kw
    return [_ref_conv(ref, x, w, b, kw), _ref_conv(ref, x, w, None, kw)]


def _want_conv_kpad(ref, seed, hw, route):
    x, w = _j(*mc.normal(seed, (2, 6, hw, hw), (5, 6, 3, 3)))
    return _ref_conv(ref, x, w, None, {"route": route} if route else {},
                     _ref_cfg(ref, "biased"))


def _want_conv_ste(ref, seed, xshape, wshape, route):
    import jax
    x, w = _j(*mc.normal(seed, xshape, wshape))
    cfg = _ref_cfg(ref)
    kw = {"route": route} if route else {}
    return jax.grad(lambda x, w: (ref["ops"].conv2d(
        x, w, None, cfg=cfg, **kw) ** 2).sum(), argnums=(0, 1))(x, w)


def _want_vision_engine(ref):
    import jax
    from repro.models.vision import cnn_forward, init_cnn
    from repro.serve.engine import VisionServeEngine
    params = init_cnn(jax.random.PRNGKey(0), width=8)
    imgs = np.random.default_rng(1).normal(size=(6, 3, 32, 32)).astype(
        np.float32)
    return VisionServeEngine(params, cnn_forward, slots=4,
                             acfg=_ref_cfg(ref)).run(imgs)


def _want_dense_approx_bwd(ref, shape):
    import jax
    import jax.numpy as jnp
    M, K, N = shape
    x, w = _j(*mc.normal(M + K, (M, K), (K, N)))
    xqp, wqp = _ref_qparams(ref, x, w)
    cfg = _ref_cfg(ref, approx_bwd=True)
    return jax.grad(lambda x, w: (ref["ops"].approx_matmul(
        x, w, cfg, xqp, wqp) * jnp.arange(N, dtype=jnp.float32)).sum(),
        argnums=(0, 1))(x, w)


def _want_conv_approx_bwd(ref, geom):
    import jax
    import jax.numpy as jnp
    g_ = mc.CONV_BWD_GEOMS[geom]
    _, stride, padding, dil = g_[1], g_[2], g_[3], g_[4]
    _, x, w = mc.conv_bwd_inputs(g_)
    cfg = _ref_cfg(ref, approx_bwd=True)
    _, vjp = jax.vjp(lambda x, w: ref["ops"].conv2d(
        x, w, stride=stride, padding=padding, dilation=dil, cfg=cfg),
        jnp.asarray(x), jnp.asarray(w))
    return vjp(jnp.asarray(_conv_g(g_)))


def _want_table() -> dict:
    """Result name -> (function, args), the slowest first. One result
    serves every case that needs it: the reference's dense backward does
    not depend on how the mesh splits K."""
    t = {}
    for i in range(len(mc.CONV_BWD_GEOMS)):
        t[f"conv_approx_bwd-{i}"] = (_want_conv_approx_bwd, (i,))
    t["fused_conv_ste"] = (_want_conv_ste, (4, (2, 3, 8, 8), (5, 3, 3, 3),
                                            None))
    t["tiled_conv_ste"] = (_want_conv_ste, (13, (1, 5, 12, 10),
                                            (6, 5, 3, 3), "tiled"))
    for s in mc.APPROX_BWD_SHAPES:
        t[f"dense_approx_bwd-{s}"] = (_want_dense_approx_bwd, (s,))
    t["grouped_conv"] = (_want_grouped_conv, ())
    for f in (False, True):
        t[f"ste-{f}"] = (_want_ste, (f,))
        t[f"dense-{f}"] = (_want_dense, (f,))
        t[f"kpad-{f}"] = (_want_kpad, (f,))
    for i in range(len(mc.FUSED_CONV_GEOMS)):
        t[f"fused_conv-{i}"] = (_want_conv, (mc.FUSED_CONV_GEOMS, i, None))
    for i in range(len(mc.TILED_CONV_GEOMS)):
        t[f"tiled_conv-{i}"] = (_want_conv, (mc.TILED_CONV_GEOMS, i,
                                             "tiled"))
    t["vision_engine"] = (_want_vision_engine, ())
    t["fused_conv_kpad"] = (_want_conv_kpad, (7, 7, None))
    t["tiled_conv_kpad"] = (_want_conv_kpad, (11, 9, "tiled"))
    for shape in mc.UNFUSED_SHAPES:
        for name in mc.UNFUSED_MODES:
            t[f"unfused-{name}-{shape}"] = (_want_unfused, (name, shape))
    for s in mc.FUSED_SHAPES:
        t[f"fused-{s}"] = (_want_fused, (s,))
    t["serve_engine"] = (_want_serve_engine, ())
    t["acu_matmul"] = (_want_acu_matmul, ())
    return t


def _want_one(name: str):
    """One reference result, as numpy, in a worker process."""
    import jax
    fn, args = _want_table()[name]
    return jax.tree.map(np.asarray, fn(_ref_modules(), *args))


REF_WORKERS = 4


@pytest.fixture(scope="module")
def mesh_run():
    """The two halves of every case at once: the 8 ranks run
    ``mesh_cases.ACU_CASES`` (``ranks``), while ``REF_WORKERS`` spawned
    processes compute the reference's single-device results (``want``).
    The ranks get the reference's parameters and the backward cases'
    incoming gradients (drawn from the reference test's generator after
    its inputs) as numpy arrays."""
    import multiprocessing
    import threading
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(REF_WORKERS, multiprocessing.get_context(
            "spawn")) as pool:
        futures = {name: pool.submit(_want_one, name)
                   for name in _want_table()}
        _ref_modules()
        import jax
        from repro.configs import reduced_config
        from repro.models.transformer import init_params
        from repro.models.vision import init_cnn
        cfg = dataclasses.replace(reduced_config("smollm-135m"),
                                  dtype="float32")
        extra = {
            "smollm": jax.tree.map(np.asarray,
                                   init_params(jax.random.PRNGKey(0), cfg)),
            "cnn": {k: np.asarray(v) for k, v in
                    init_cnn(jax.random.PRNGKey(0), width=8).items()},
            "conv_bwd_g": {str(g): _conv_g(g) for g in mc.CONV_BWD_GEOMS}}
        got: dict = {}

        def run_ranks():
            try:
                got["ranks"] = mc.spawn_cases("acu", extra=extra)
            except BaseException as e:        # re-raised below
                got["error"] = e
        th = threading.Thread(target=run_ranks)
        th.start()
        want = {name: f.result() for name, f in futures.items()}
        th.join()
    if "error" in got:
        raise got["error"]
    return got["ranks"], want


@pytest.fixture(scope="module")
def ranks(mesh_run):
    return mesh_run[0]


@pytest.fixture(scope="module")
def want(mesh_run):
    return mesh_run[1]


def _conv_g(geom):
    """The incoming gradient of a conv backward case: the reference test's
    generator, drawn after the inputs, at the output's shape (N, Cout, Ho,
    Wo)."""
    from repro_torch.core.approx_ops import _conv_spec
    x_shape, w_shape, stride, padding, dil = geom
    rng, _, _ = mc.conv_bwd_inputs(geom)
    ho, wo = _conv_spec(x_shape, w_shape, stride, padding, dil,
                        1).out_spatial
    return rng.standard_normal((x_shape[0], w_shape[0], ho, wo)).astype(
        np.float32)


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


def _bitwise(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(got, want.astype(got.dtype)), \
        float(np.abs(got.astype(np.float64) - want).max())


def _grad_close(got, want):
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= GRAD_TOL * np.abs(want).max()


def _j(*arrays):
    import jax.numpy as jnp
    return [jnp.asarray(a) for a in arrays]


def _ref_qparams(ref, x, w):
    import jax.numpy as jnp
    q = ref["q"]
    xqp = q.symmetric_qparams(jnp.max(jnp.abs(x)), 8)
    wqp = q.symmetric_qparams(jnp.maximum(jnp.max(jnp.abs(w), axis=0),
                                          1e-9), 8, axis=1)
    return xqp, wqp


@pytest.mark.parametrize("name", mc.UNFUSED_MODES)
@pytest.mark.parametrize("shape", mc.UNFUSED_SHAPES)
def test_unfused_modes_bit_exact(ranks, want, name, shape):
    """Every mode, M/N that divide the axes and that do not: the sharded
    accumulator (rows over data, columns over model) equals the one-rank
    one and the reference's."""
    r = _each(ranks, f"unfused-{name}-{shape}")
    wnt = want[f"unfused-{name}-{shape}"]
    if name != "lowrank":
        _bitwise(r["local"], wnt)
        return
    from repro_torch.kernels.err_matmul.ref import summation_bound
    a, w = mc.int_operands(*shape, seed=sum(shape))
    acu = mc.port_acu("lowrank")
    f, g = acu.device_factors("cpu")
    bound = summation_bound(torch.from_numpy(a), torch.from_numpy(w), f, g,
                            acu.offset).numpy()
    assert (np.abs(r["local"].astype(np.float64) - wnt) <= bound).all()


@pytest.mark.parametrize("shape", mc.FUSED_SHAPES)
def test_fused_sharded_bit_exact(ranks, want, shape):
    """The fused kernel 3 route on its row and column blocks, odd M/N and
    K-pad branches included."""
    _bitwise(_each(ranks, f"fused-{shape}")["out"], want[f"fused-{shape}"])


@pytest.mark.parametrize("fused", [False, True])
def test_jit_regime_parity(ranks, want, fused):
    """``approx_dense`` with its activation qparams computed inside the
    call (the port has no jit: its eager call is held against the
    reference's), fused and unfused."""
    _bitwise(_each(ranks, f"dense-{fused}")["out"], want[f"dense-{fused}"])


@pytest.mark.parametrize("fused", [False, True])
def test_contracting_shard_kpad_once(ranks, want, fused):
    """K over model (``acu_k``): int32 partials summed, the K shard-pad
    correction applied once (a per-rank or a missing one shows as an
    integer offset under the biased table, M[0, 0] = 7)."""
    _bitwise(_each(ranks, f"kpad-{fused}")["out"], want[f"kpad-{fused}"])


@pytest.mark.parametrize("fused", [False, True])
def test_ste_backward_bitwise(ranks, want, fused):
    """The exact STE gradients of activations and weights under the mesh
    (``acu_shard.bwd_gemms``) equal the one-rank ones bitwise, and the
    reference's within ``GRAD_TOL``."""
    r = _each(ranks, f"ste-{fused}")
    for got, wnt in zip(r["out"], want[f"ste-{fused}"]):
        _grad_close(got, wnt)


def test_grouped_conv_sharded(ranks, want):
    """The grouped conv's per-group dense GEMMs under the mesh."""
    _bitwise(_each(ranks, "grouped_conv")["out"], want["grouped_conv"])


def test_serve_engine_mesh_parity(ranks, want):
    """``ServeEngine(mesh=...)`` decodes the reference engine's tokens."""
    r = _each(ranks, "serve_engine")
    assert list(r["out"]) == want["serve_engine"]


def test_acu_matmul_mesh_aware(ranks, want):
    """``Acu.matmul`` resolves against the active mesh."""
    _bitwise(_each(ranks, "acu_matmul")["out"], want["acu_matmul"])


@pytest.mark.parametrize("geom", range(len(mc.FUSED_CONV_GEOMS)))
def test_fused_conv_sharded_bit_exact(ranks, want, geom):
    """Kernel 5 under the mesh: batch over data, output channels over
    model, with and without a bias; batch and Cout that do not divide."""
    r = _each(ranks, f"fused_conv-{geom}")
    _bitwise(r["out"][0], want[f"fused_conv-{geom}"][0])
    _bitwise(r["out"][1], want[f"fused_conv-{geom}"][1])


def test_fused_conv_channel_contraction_kpad_once(ranks, want):
    """Input channels over model (``acu_conv_k``): partials summed, the
    channel-pad correction applied once, under the biased table."""
    _bitwise(_each(ranks, "fused_conv_kpad")["out"], want["fused_conv_kpad"])


def test_fused_conv_ste_backward_bitwise(ranks, want):
    r = _each(ranks, "fused_conv_ste")
    for got, wnt in zip(r["out"], want["fused_conv_ste"]):
        _grad_close(got, wnt)


@pytest.mark.parametrize("geom", range(len(mc.TILED_CONV_GEOMS)))
def test_tiled_conv_sharded_bit_exact(ranks, want, geom):
    """Kernel 6 under the mesh: a batch of 1 splits into halo'd
    output-row bands over data (the plan's ``padding=`` override takes the
    pre-padded slabs), output channels over model."""
    r = _each(ranks, f"tiled_conv-{geom}")
    _bitwise(r["out"][0], want[f"tiled_conv-{geom}"][0])
    _bitwise(r["out"][1], want[f"tiled_conv-{geom}"][1])


def test_tiled_conv_channel_contraction_kpad_once(ranks, want):
    _bitwise(_each(ranks, "tiled_conv_kpad")["out"], want["tiled_conv_kpad"])


def test_tiled_conv_banded_ste_backward_bitwise(ranks, want):
    r = _each(ranks, "tiled_conv_ste")
    for got, wnt in zip(r["out"], want["tiled_conv_ste"]):
        _grad_close(got, wnt)


def test_vision_serve_engine_mesh_parity(ranks, want):
    """``VisionServeEngine(mesh=...)``: the reference engine's logits, and
    plan reports with the partition (224 x 224 on the tiled kernel, no
    fallback)."""
    r = _each(ranks, "vision_engine")
    _bitwise(r["out"], want["vision_engine"])
    assert r["report"]["route"] == "fused_conv"
    assert r["report"]["partition"] is not None
    assert r["report224"]["route"] == "tiled"
    assert r["report224"]["tiling"] is not None
    assert r["report224"]["partition"] is not None
    assert not any("falling back" in x for x in r["report224"]["report"])


@pytest.mark.parametrize("shape", mc.APPROX_BWD_SHAPES)
@pytest.mark.parametrize("k_sharded", [False, True])
def test_dense_approx_bwd_grads_bit_exact(ranks, want, shape, k_sharded):
    """The approximate dense backward (kernel 4) on the permuted
    partitions, int32 sums and the pad correction once, default rules and
    ``acu_k``: the reference's gradients bitwise."""
    r = _each(ranks, f"dense_approx_bwd-{shape}-{k_sharded}")
    for got, wnt in zip(r["out"], want[f"dense_approx_bwd-{shape}"]):
        _bitwise(got, wnt)


@pytest.mark.parametrize("geom", range(len(mc.CONV_BWD_GEOMS)))
def test_conv_approx_bwd_grads_bit_exact(ranks, want, geom):
    """The banded approximate conv backward on the mesh: kernel 7's band
    partials (with ``rmask``) summed over the rows axes, kernel 4's
    input-gradient GEMM over the cols axes with the pad once: the
    reference's gradients bitwise."""
    r = _each(ranks, f"conv_approx_bwd-{geom}")
    for got, wnt in zip(r["out"], want[f"conv_approx_bwd-{geom}"]):
        _bitwise(got, wnt)


def test_shard_is_a_checked_identity_under_rank_mesh(ranks):
    """Under a mesh of ranks ``shard`` returns its tensor (every rank holds
    the global tensor) after checking the axes fit; each rank sits at its
    row-major coordinates."""
    for rank, r in enumerate(ranks):
        res = r["shard_identity"]
        assert res["same"] and "logical axes" in res["bad"]
        assert res["rank"] == rank
        assert res["coords"] == {"data": rank // 4, "model": rank % 4}


def test_host_multi_mesh_needs_its_ranks():
    """Fewer ranks than the mesh's places raises, as the reference raises
    for fewer host devices."""
    from repro_torch.launch.mesh import make_host_multi_mesh
    with pytest.raises(RuntimeError, match="needs 8 ranks"):
        make_host_multi_mesh((2, 4))


def test_kernel7_rmask_matches_reference(ref):
    """Kernel 7's plain version with ``rmask`` bitwise against the
    reference's interpret-mode kernel, on the biased table (a masked row
    would still add ``LUT[x, 0] != 0``): a mask that kills the last band
    of rows of one image and every row of a padded image; and no mask
    equals an all-ones one."""
    import jax.numpy as jnp
    import repro.kernels.fused_lut_conv.ops as jconv
    from repro_torch.kernels.fused_lut_conv.ops import fused_lut_conv_bwd_w
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 5, 11, 9)).astype(np.float32)
    g = rng.normal(size=(3, 11, 9, 7)).astype(np.float32)
    rmask = np.ones((3, 11), np.int32)
    rmask[0, 8:] = 0          # a dead band of output rows
    rmask[2] = 0              # a padded image
    kw = dict(ksize=(3, 3), padding=((1, 1), (1, 1)))
    sx, sg = np.float32(0.03), np.float32(0.02)
    want = np.asarray(jconv.fused_lut_conv_bwd_w(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(mc.BIASED_LUT), 128, sx,
        sg, rmask=jnp.asarray(rmask), interpret=True, **kw))
    lut = torch.from_numpy(mc.BIASED_LUT)
    got = fused_lut_conv_bwd_w(torch.from_numpy(x), torch.from_numpy(g), lut,
                               128, torch.tensor(sx), torch.tensor(sg),
                               rmask=torch.from_numpy(rmask), **kw)
    _bitwise(got.numpy(), want)
    full = fused_lut_conv_bwd_w(torch.from_numpy(x), torch.from_numpy(g),
                                lut, 128, torch.tensor(sx), torch.tensor(sg),
                                **kw)
    ones = fused_lut_conv_bwd_w(torch.from_numpy(x), torch.from_numpy(g),
                                lut, 128, torch.tensor(sx), torch.tensor(sg),
                                rmask=torch.ones(3, 11, dtype=torch.int32),
                                **kw)
    assert torch.equal(full, ones) and not torch.equal(full, got)
