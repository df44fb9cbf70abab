"""Rank bodies of the CPU mesh tests (``tests/test_torch_sharded_acu.py``,
``test_torch_sharded_attn_moe.py``, ``test_torch_dp_train.py``).

Each test file starts its 8 gloo ranks once (:func:`spawn_cases`, a
module-scoped fixture): every rank builds the 2 x 4 ``(data, model)``
mesh, runs every case of the file on the same global inputs and returns
its results. The parent holds them against the reference's single-device
results, which it computes itself (the ranks import neither JAX nor the
reference). A case returns numpy arrays: ``"out"`` the sharded result and
``"local"`` the port's own one-rank result (rank 0's; None elsewhere).

Inputs are built here from numpy seeds, so the parent and the ranks build
the same ones. The one-rank result is computed on rank 0 alone.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

MESH_SHAPE = (2, 4)
N_RANKS = 8
MULT = "mul8s_1L2H"
_V = np.arange(-128, 128, dtype=np.int32)
BIASED_LUT = (_V[:, None] * _V[None, :] + 7).astype(np.int32)   # M[0, 0] = 7


# ---------------------------------------------------------------------------
# spawning
# ---------------------------------------------------------------------------

def spawn_cases(table: str, extra=None, timeout: float = 600.0
                ) -> list[dict]:
    """Run every case of ``CASE_TABLES[table]`` in 8 gloo ranks on the
    CPU; returns each rank's ``{name: result}``."""
    from repro_torch.launch.mesh import spawn_ranks
    return spawn_ranks(_rank_body, N_RANKS, args=(table, extra),
                       backend="gloo", device="cpu", timeout=timeout)


def _rank_body(table: str, extra) -> dict:
    from repro_torch.launch.mesh import make_host_multi_mesh
    mesh = make_host_multi_mesh(MESH_SHAPE)
    return {name: case(mesh, extra)
            for name, case in CASE_TABLES[table].items()}


def _one(mesh, fn):
    """``fn()`` on rank 0 only: the one-rank result every rank's sharded
    one is held against (the other ranks would compute the same)."""
    return fn() if mesh.rank == 0 else None


def _np(t):
    import torch
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return t


def _t(*arrays):
    import torch
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# inputs (numpy, seeded)
# ---------------------------------------------------------------------------

def int_operands(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(-120, 120, (M, K)).astype(np.int32),
            rng.integers(-120, 120, (K, N)).astype(np.int32))


def normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


UNFUSED_MODES = ["lut_jnp", "lut_pallas", "functional", "factored",
                 "lowrank", "exact"]
UNFUSED_SHAPES = [(32, 64, 16), (36, 70, 21)]
FUSED_SHAPES = [(32, 128, 16), (33, 70, 21), (1, 257, 3)]
FUSED_CONV_GEOMS = [
    ((3, 5, 9, 9), (9, 5, 3, 3), dict()),                       # odd N, Cout
    ((2, 8, 10, 10), (8, 8, 3, 3), dict(stride=(2, 2))),
    ((4, 6, 7, 7), (12, 6, 3, 3), dict(dilation=(2, 2))),
]
TILED_CONV_GEOMS = [
    ((1, 8, 17, 13), (9, 8, 3, 3), dict()),          # batch 1 -> 2-way bands
    ((1, 6, 11, 9), (5, 6, 3, 3), dict(stride=(2, 2))),
    ((1, 5, 14, 8), (7, 5, 3, 3), dict(dilation=(2, 2))),
    ((2, 8, 10, 10), (8, 8, 3, 3), dict()),          # batch fills rows axes
]
APPROX_BWD_SHAPES = [(32, 64, 16), (33, 70, 21)]
CONV_BWD_GEOMS = [
    ((8, 3, 9, 11), (8, 3, 3, 3), (1, 1), "SAME", (1, 1)),
    ((1, 4, 12, 10), (8, 4, 3, 2), (2, 1), "VALID", (1, 2)),
    ((2, 2, 16, 8), (12, 2, 2, 2), (2, 2), "SAME", (1, 1)),
]


@functools.lru_cache(maxsize=None)
def port_acu(kind: str, fused: bool = True):
    """The port's ACU for a reference ``make_acu`` of the same name:
    ``use_pallas`` is ``use_kernels``; ``"biased"`` is the exact table + 7.
    Built once a process (LOWRANK's factorisation takes seconds)."""
    from repro_torch.core import make_acu
    if kind == "lut_jnp":
        return make_acu(MULT, "lut")
    if kind == "lut_pallas":
        return make_acu(MULT, "lut", use_kernels=True, fused=fused)
    if kind == "functional":
        return make_acu(MULT, "functional")
    if kind == "factored":
        return make_acu("mul8s_trunc2", "factored")
    if kind == "lowrank":
        return make_acu(MULT, "lowrank")
    if kind == "exact":
        return make_acu("mul8s_exact", "exact")
    if kind == "biased":
        return dataclasses.replace(
            make_acu("mul8s_exact", "lut", use_kernels=True, fused=fused),
            lut=BIASED_LUT, _tables={})
    raise KeyError(kind)


def _cfg(kind="lut_pallas", fused=True, **kw):
    from repro_torch.core import ApproxConfig
    return ApproxConfig(acu=port_acu(kind, fused), **kw)


def _qparams(x, w):
    import torch
    from repro_torch.core.quantization import symmetric_qparams
    xqp = symmetric_qparams(torch.max(torch.abs(x)), 8)
    wqp = symmetric_qparams(torch.clamp_min(torch.max(torch.abs(w), dim=0)[0],
                                            1e-9), 8, axis=1)
    return xqp, wqp


def _grads(fn, *args):
    import torch
    ts = [a.clone().requires_grad_(True) for a in args]
    fn(*ts).backward()
    return [_np(t.grad) for t in ts]


# ---------------------------------------------------------------------------
# test_torch_sharded_acu.py
# ---------------------------------------------------------------------------

def _unfused(mode, shape):
    def case(mesh, extra):
        from repro_torch.core import matmul_plan
        from repro_torch.parallel.sharding import use_mesh
        acu = port_acu(mode, fused=False)
        a, w = _t(*int_operands(*shape, seed=sum(shape)))
        local = _one(mesh, lambda: matmul_plan(acu, mesh=False)(a, w))
        with use_mesh(mesh):
            plan = matmul_plan(acu)
            assert plan.partition is not None and plan.partition.total == 8
            out = plan(a, w)
        return {"out": _np(out), "local": _np(local)}
    return case


def _fused(shape):
    def case(mesh, extra):
        from repro_torch.core.approx_ops import approx_matmul
        from repro_torch.parallel.sharding import use_mesh
        M, K, N = shape
        x, w = _t(*normal(K, (M, K), (K, N)))
        xqp, wqp = _qparams(x, w)
        cfg = _cfg(fused=True)
        local = _one(mesh, lambda: approx_matmul(x, w, cfg, xqp, wqp))
        with use_mesh(mesh):
            out = approx_matmul(x, w, cfg, xqp, wqp)
        return {"out": _np(out), "local": _np(local)}
    return case


def _dense_parity(fused):
    def case(mesh, extra):
        from repro_torch.core import approx_dense
        from repro_torch.parallel.sharding import use_mesh
        x, w = _t(*normal(8, (4, 37, 96), (96, 48)))
        cfg = _cfg(fused=fused)
        cfg = dataclasses.replace(cfg, fused=fused)
        local = _one(mesh, lambda: approx_dense(x, w, None, cfg))
        with use_mesh(mesh):
            out = approx_dense(x, w, None, cfg)
        return {"out": _np(out), "local": _np(local)}
    return case


def _kpad_once(fused):
    def case(mesh, extra):
        from repro_torch.core import approx_dense, matmul_plan
        from repro_torch.parallel.sharding import use_mesh
        acu = port_acu("biased", fused)
        assert acu.m00() == 7
        cfg = dataclasses.replace(_cfg("biased", fused), fused=fused)
        x, w = _t(*normal(7, (12, 70), (70, 9)))   # K=70 pads to 72 over 4
        local = _one(mesh, lambda: approx_dense(x, w, None, cfg))
        with use_mesh(mesh, {"acu_k": ("model",), "acu_cols": ()}):
            assert matmul_plan(acu, fused=fused).partition.k == ("model",)
            out = approx_dense(x, w, None, cfg)
        return {"out": _np(out), "local": _np(local)}
    return case


def _ste_bwd(fused):
    def case(mesh, extra):
        from repro_torch.core.approx_ops import approx_matmul
        from repro_torch.parallel.sharding import use_mesh
        x, w = _t(*normal(4, (18, 40), (40, 11)))
        xqp, wqp = _qparams(x, w)
        cfg = dataclasses.replace(_cfg(fused=fused), fused=fused)

        def loss(x, w):
            return (approx_matmul(x, w, cfg, xqp, wqp) ** 2).sum()
        local = _one(mesh, lambda: _grads(loss, x, w))
        with use_mesh(mesh):
            out = _grads(loss, x, w)
        return {"out": out, "local": local}
    return case


def _grouped_conv(mesh, extra):
    from repro_torch.core import conv2d
    from repro_torch.parallel.sharding import use_mesh
    x, w = _t(*normal(2, (2, 8, 6, 6), (8, 4, 3, 3)))
    cfg = _cfg("lut_jnp")
    local = _one(mesh, lambda: conv2d(x, w, groups=2, cfg=cfg))
    with use_mesh(mesh):
        out = conv2d(x, w, groups=2, cfg=cfg)
    return {"out": _np(out), "local": _np(local)}


def _serve_engine(mesh, extra):
    import torch
    from repro_torch.configs import reduced_config
    from repro_torch.models.transformer import load_jax_params
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = dataclasses.replace(reduced_config("smollm-135m"), dtype="float32")
    params = load_jax_params(extra["smollm"], device="cpu")
    prompt = np.asarray([5, 17, 3], np.int32)
    def serve(mesh_):
        with torch.inference_mode():
            return np.asarray(ServeEngine(
                params, cfg, slots=2, max_seq=32, device="cpu",
                mesh=mesh_).run([Request(prompt=prompt,
                                         max_new_tokens=4)])[0].out)
    return {"out": serve(mesh), "local": _one(mesh, lambda: serve(None))}


def _acu_matmul(mesh, extra):
    from repro_torch.parallel.sharding import use_mesh
    acu = port_acu("lut_jnp")
    a, w = _t(*int_operands(10, 30, 6, seed=1))
    local = _one(mesh, lambda: acu.matmul(a, w))
    with use_mesh(mesh):
        out = acu.matmul(a, w)
    return {"out": _np(out), "local": _np(local)}


def conv_pad(shape, wshape, kw_):
    from repro_torch.core.acu import resolve_conv_padding
    return resolve_conv_padding(kw_.get("padding", "SAME"), shape, wshape,
                                kw_.get("stride", (1, 1)),
                                kw_.get("dilation", (1, 1)))


def _conv_sharded(geom, route):
    def case(mesh, extra):
        import torch
        from repro_torch.core import conv2d
        from repro_torch.core.acu import ConvSpec, conv_plan
        from repro_torch.parallel.sharding import use_mesh
        shape, wshape, kw_ = geom
        x, w, b = _t(*normal(sum(shape), shape, wshape, (wshape[0],)))
        cfg = _cfg()
        acu = cfg.acu
        kw = dict(kw_, **({"route": route} if route else {}))
        with torch.no_grad():
            local = _one(mesh, lambda: [
                _np(conv2d(x, w, bb, cfg=cfg, **kw)) for bb in (b, None)])
            with use_mesh(mesh):
                plan = conv_plan(acu, ConvSpec(
                    x_shape=shape, w_shape=wshape,
                    padding=conv_pad(shape, wshape, kw_),
                    stride=kw_.get("stride", (1, 1)),
                    dilation=kw_.get("dilation", (1, 1))), route=route)
                assert plan.route == (route or "fused_conv"), plan.route
                assert plan.partition is not None
                assert plan.partition.total == 8
                out = conv2d(x, w, b, cfg=cfg, **kw)
                out_nb = conv2d(x, w, None, cfg=cfg, **kw)
        return {"out": [_np(out), _np(out_nb)], "local": local}
    return case


def _conv_kpad_once(route, seed, hw):
    def case(mesh, extra):
        import torch
        from repro_torch.core import conv2d
        from repro_torch.core.acu import ConvSpec, conv_plan
        from repro_torch.parallel.sharding import use_mesh
        cfg = _cfg("biased")
        assert cfg.acu.m00() == 7
        x, w = _t(*normal(seed, (2, 6, hw, hw), (5, 6, 3, 3)))  # C=6 pads 2
        kw = {"route": route} if route else {}
        with torch.no_grad():
            local = _one(mesh, lambda: conv2d(x, w, None, cfg=cfg, **kw))
            with use_mesh(mesh, {"acu_conv_k": ("model",),
                                 "acu_conv_cols": ()}):
                plan = conv_plan(cfg.acu, ConvSpec(
                    x_shape=(2, 6, hw, hw), w_shape=(5, 6, 3, 3),
                    padding=((1, 1), (1, 1))), route=route)
                assert plan.partition.k == ("model",)
                out = conv2d(x, w, None, cfg=cfg, **kw)
        return {"out": _np(out), "local": _np(local)}
    return case


def _conv_ste(route, seed, xs, ws):
    def case(mesh, extra):
        from repro_torch.core import conv2d
        from repro_torch.parallel.sharding import use_mesh
        cfg = _cfg()
        x, w = _t(*normal(seed, xs, ws))
        kw = {"route": route} if route else {}

        def loss(x, w):
            return (conv2d(x, w, None, cfg=cfg, **kw) ** 2).sum()
        local = _one(mesh, lambda: _grads(loss, x, w))
        with use_mesh(mesh):
            out = _grads(loss, x, w)
        return {"out": out, "local": local}
    return case


def _vision_engine(mesh, extra):
    from repro_torch.models.vision import cnn_forward, load_jax_params
    from repro_torch.serve.engine import VisionServeEngine
    params = load_jax_params(extra["cnn"], device="cpu")
    cfg = _cfg()
    imgs = np.random.default_rng(1).normal(size=(6, 3, 32, 32)).astype(
        np.float32)
    local = _one(mesh, lambda: VisionServeEngine(
        params, cnn_forward, slots=4, acfg=cfg, device="cpu").run(imgs))
    eng = VisionServeEngine(params, cnn_forward, slots=4, acfg=cfg,
                            device="cpu", mesh=mesh)
    out = eng.run(imgs)
    rep = eng.plan_report((4, 3, 32, 32), (8, 3, 3, 3), cfg)
    rep224 = eng.plan_report((4, 64, 224, 224), (64, 64, 3, 3), cfg)
    return {"out": out, "local": local, "report": rep, "report224": rep224}


def _dense_approx_bwd(shape, k_sharded):
    def case(mesh, extra):
        import torch
        from repro_torch.core.approx_ops import approx_matmul
        from repro_torch.parallel.sharding import use_mesh
        M, K, N = shape
        x, w = _t(*normal(M + K, (M, K), (K, N)))
        xqp, wqp = _qparams(x, w)
        cfg = _cfg(approx_bwd=True)
        scale = torch.arange(N, dtype=torch.float32)

        def loss(x, w):
            return (approx_matmul(x, w, cfg, xqp, wqp) * scale).sum()
        local = _one(mesh, lambda: _grads(loss, x, w))
        rules = {"acu_k": ("model",), "acu_cols": ()} if k_sharded else None
        with use_mesh(mesh, rules):
            out = _grads(loss, x, w)
        return {"out": out, "local": local}
    return case


def conv_bwd_inputs(geom):
    x_shape, w_shape = geom[0], geom[1]
    rng = np.random.default_rng(x_shape[0] + w_shape[0])
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = rng.standard_normal(w_shape).astype(np.float32)
    return rng, x, w


def _conv_approx_bwd(geom):
    def case(mesh, extra):
        import torch
        from repro_torch.core import conv2d
        from repro_torch.parallel.sharding import use_mesh
        _, stride, padding, dil = geom[1], geom[2], geom[3], geom[4]
        cfg = _cfg(approx_bwd=True)
        x, w = _t(*conv_bwd_inputs(geom)[1:])
        g = torch.from_numpy(extra["conv_bwd_g"][str(geom)])

        def run():
            xs, ws = x.clone().requires_grad_(True), \
                w.clone().requires_grad_(True)
            y = conv2d(xs, ws, stride=stride, padding=padding, dilation=dil,
                       cfg=cfg)
            y.backward(g)
            return [_np(xs.grad), _np(ws.grad)]
        local = _one(mesh, run)
        with use_mesh(mesh):
            out = run()
        return {"out": out, "local": local}
    return case


def _shard_identity(mesh, extra):
    import torch
    from repro_torch.parallel.sharding import shard, use_mesh
    x = torch.ones(4, 6)
    with use_mesh(mesh):
        same = shard(x, "batch", "mlp") is x
        try:
            shard(x, "batch")
            bad = "no error"
        except ValueError as e:
            bad = str(e)
    return {"same": same, "bad": bad, "coords": dict(mesh.coords),
            "rank": mesh.rank}


ACU_CASES = {}
for _m in UNFUSED_MODES:
    for _s in UNFUSED_SHAPES:
        ACU_CASES[f"unfused-{_m}-{_s}"] = _unfused(_m, _s)
for _s in FUSED_SHAPES:
    ACU_CASES[f"fused-{_s}"] = _fused(_s)
for _f in (False, True):
    ACU_CASES[f"dense-{_f}"] = _dense_parity(_f)
    ACU_CASES[f"kpad-{_f}"] = _kpad_once(_f)
    ACU_CASES[f"ste-{_f}"] = _ste_bwd(_f)
ACU_CASES["grouped_conv"] = _grouped_conv
ACU_CASES["serve_engine"] = _serve_engine
ACU_CASES["acu_matmul"] = _acu_matmul
for _i, _g in enumerate(FUSED_CONV_GEOMS):
    ACU_CASES[f"fused_conv-{_i}"] = _conv_sharded(_g, None)
ACU_CASES["fused_conv_kpad"] = _conv_kpad_once(None, 7, 7)
ACU_CASES["fused_conv_ste"] = _conv_ste(None, 4, (2, 3, 8, 8), (5, 3, 3, 3))
for _i, _g in enumerate(TILED_CONV_GEOMS):
    ACU_CASES[f"tiled_conv-{_i}"] = _conv_sharded(_g, "tiled")
ACU_CASES["tiled_conv_kpad"] = _conv_kpad_once("tiled", 11, 9)
ACU_CASES["tiled_conv_ste"] = _conv_ste("tiled", 13, (1, 5, 12, 10),
                                        (6, 5, 3, 3))
ACU_CASES["vision_engine"] = _vision_engine
for _s in APPROX_BWD_SHAPES:
    for _k in (False, True):
        ACU_CASES[f"dense_approx_bwd-{_s}-{_k}"] = _dense_approx_bwd(_s, _k)
for _i, _g in enumerate(CONV_BWD_GEOMS):
    ACU_CASES[f"conv_approx_bwd-{_i}"] = _conv_approx_bwd(_g)
ACU_CASES["shard_identity"] = _shard_identity


# ---------------------------------------------------------------------------
# test_torch_sharded_attn_moe.py
# ---------------------------------------------------------------------------

ATTN_CASES_BHH = [(4, 8, 4), (2, 4, 1), (3, 8, 2)]


def attn_inputs(b, hq, hkv):
    rng = np.random.default_rng(b + hq)
    q = rng.normal(size=(b, hq, 32, 16)).astype(np.float32)
    k = rng.normal(size=(b, hkv, 96, 16)).astype(np.float32)
    v = rng.normal(size=(b, hkv, 96, 16)).astype(np.float32)
    s = [np.float32(np.abs(t).max() / np.float32(127.0)) for t in (q, k, v)]
    return q, k, v, s


def paged_inputs(b, hq, hkv, seed):
    """The reference test's ``_paged_setup`` at sq 1, d 16, bk 16."""
    rng = np.random.default_rng(seed)
    rep, bk, sq, d = hq // hkv, 16, 1, 16
    kv_lens = tuple(17 + 11 * i for i in range(b))
    n_logical = max(-(-kl // bk) for kl in kv_lens)
    sk = n_logical * bk
    r2 = np.random.default_rng(seed + 1)
    q = r2.normal(size=(b * hq, sq, d)).astype(np.float32)
    k = r2.normal(size=(b * hkv, sk, d)).astype(np.float32)
    v = r2.normal(size=(b * hkv, sk, d)).astype(np.float32)
    s = [np.float32(np.abs(t).max() / np.float32(127.0)) for t in (q, k, v)]
    phys = 1 + rng.permutation(b * n_logical).reshape(b, n_logical)
    kp = np.zeros((hkv, 1 + b * n_logical, bk, d), np.float32)
    vp = np.zeros_like(kp)
    for bi in range(b):
        for h in range(hkv):
            for j in range(n_logical):
                kp[h, phys[bi, j]] = k[bi * hkv + h, j * bk:(j + 1) * bk]
                vp[h, phys[bi, j]] = v[bi * hkv + h, j * bk:(j + 1) * bk]
    info = np.stack([np.asarray([kl - sq for kl in kv_lens]),
                     np.zeros(b, np.int64), np.asarray(kv_lens)],
                    axis=1).astype(np.int32)
    return q.reshape(b, hq, sq, d), s, kp, vp, info, phys.astype(np.int32)


def _attn(bhh, paged):
    def case(mesh, extra):
        import torch
        from repro_torch.core import attn_plan
        from repro_torch.core.acu import AttnSpec
        from repro_torch.parallel.sharding import use_mesh
        b, hq, hkv = bhh
        acu = port_acu("lut_pallas")
        if paged:
            q, s, kp, vp, info, pt = paged_inputs(b, hq, hkv, seed=b + hq)
            args = _t(q, kp, vp) + [torch.tensor(x) for x in s] + \
                _t(info, pt)
            spec = AttnSpec(hq=hq, hkv=hkv, bk=16, kv_layout="paged")
        else:
            q, k, v, s = attn_inputs(b, hq, hkv)
            args = _t(q, k, v) + [torch.tensor(x) for x in s]
            spec = AttnSpec(hq=hq, hkv=hkv)
        local = _one(mesh, lambda: attn_plan(acu, spec,
                                             mesh=False)(*args))
        with use_mesh(mesh):
            plan = attn_plan(acu, spec)
            assert plan.partition is not None
            out = plan(*args)
        return {"out": _np(out), "local": _np(local),
                "describe": plan.describe()}
    return case


GROUPED_SWEEP = [(2, 4, 24, 33, 14), (2, 6, 24, 33, 14), (3, 4, 16, 40, 9),
                 (2, 8, 16, 300, 9)]


def grouped_operands(G, E, C, K, N, seed=0):
    """The reference test's ``_grouped_operands``: dead rows zeroed."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(G, C, K)).astype(np.float32)
    w = rng.normal(size=(E, K, N)).astype(np.float32)
    counts = rng.integers(0, C + 1, size=(G,)).astype(np.int32)
    mask = np.arange(C)[None, :] < counts[:, None]
    return (x * mask[..., None]).astype(np.float32), w, counts, mask


def _grouped(case_, seed, kind="lut_pallas", rules=None, describe=False):
    def case(mesh, extra):
        import torch
        from repro_torch.core import grouped_plan
        from repro_torch.core.acu import GroupedSpec
        from repro_torch.core.approx_ops import approx_grouped_dense
        from repro_torch.parallel.sharding import use_mesh
        nb, E, C, K, N = case_
        x, w, counts, _ = grouped_operands(nb * E, E, C, K, N, seed=seed)
        cfg = _cfg(kind)
        x, w, counts = _t(x, w, counts)
        with torch.no_grad():
            local = _one(mesh, lambda: approx_grouped_dense(x, w, cfg,
                                                            counts))
            with use_mesh(mesh, rules):
                plan = grouped_plan(cfg.acu, GroupedSpec(
                    n_experts=E, cap=C, d_in=K, d_out=N, n_blocks=nb))
                out = approx_grouped_dense(x, w, cfg, counts)
        return {"out": _np(out), "local": _np(local),
                "describe": plan.describe(),
                "k": None if plan.partition is None else plan.partition.k}
    return case


def _grouped_grads(mesh, extra):
    import torch
    from repro_torch.core.approx_ops import approx_grouped_dense
    from repro_torch.parallel.sharding import use_mesh
    x, w, counts, _ = grouped_operands(8, 4, 24, 33, 14, seed=19)
    cfg = _cfg()
    counts = torch.from_numpy(counts)
    scale = torch.arange(14, dtype=torch.float32)

    def loss(x, w):
        return (approx_grouped_dense(x, w, cfg, counts) * scale).sum()
    xt, wt = _t(x, w)
    local = _one(mesh, lambda: _grads(loss, xt, wt))
    with use_mesh(mesh):
        out = _grads(loss, xt, wt)
    return {"out": out, "local": local}


ATTN_MOE_CASES = {}
for _c in ATTN_CASES_BHH:
    ATTN_MOE_CASES[f"attn-{_c}"] = _attn(_c, False)
    ATTN_MOE_CASES[f"paged-{_c}"] = _attn(_c, True)
ATTN_MOE_CASES["grouped_ep"] = _grouped((2, 4, 24, 33, 14), 13,
                                        describe=True)
for _c in GROUPED_SWEEP:
    ATTN_MOE_CASES[f"grouped_sweep-{_c}"] = _grouped(_c, sum(_c))
ATTN_MOE_CASES["grouped_k_biased"] = _grouped(
    (2, 4, 24, 33, 14), 17, kind="biased",
    rules={"acu_grouped_k": ("model",), "acu_grouped_experts": (),
           "acu_grouped_rows": ("data",)})
ATTN_MOE_CASES["grouped_grads"] = _grouped_grads


# ---------------------------------------------------------------------------
# test_torch_dp_train.py
# ---------------------------------------------------------------------------

def regression_problem(noise: float = 2.0, dim: int = 8, seed: int = 0):
    """The reference test's ``_regression_problem`` (``tests/
    test_damping.py``): noisy linear regression, params ``{"w": (dim,),
    "b": ()}`` at zero, numpy batches."""
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(dim,)).astype(np.float32)
    params = {"w": np.zeros(dim, np.float32), "b": np.zeros((), np.float32)}

    def batches(batch, seed=1):
        r = np.random.default_rng(seed)
        while True:
            x = r.normal(size=(batch, dim)).astype(np.float32)
            y = (x @ w_true + noise * r.normal(size=batch)).astype(
                np.float32)
            yield {"x": x, "y": y}

    return params, batches


def port_loss(p, batch):
    import torch
    pred = batch["x"] @ p["w"] + p["b"]
    return torch.mean(torch.square(pred - batch["y"]))


def _stats_pair(mesh, extra):
    import torch
    from repro_torch.optim.compression import EFState, compressed_psum
    g = np.random.default_rng(0).normal(size=(2, 16)).astype(np.float32)
    i = mesh.coords["data"]
    gs = {"g": torch.from_numpy(g[i])}
    summed, ef, stats = compressed_psum(
        gs, EFState(residual={"g": torch.zeros(16)}), "data", mesh=mesh,
        with_stats=True)
    from repro_torch.optim.damping import shard_noise_stats
    pair = shard_noise_stats(gs, summed, "data", 4, 2, mesh=mesh)
    return {"summed": _np(summed["g"]), "resid": _np(ef.residual["g"]),
            "stats": {k: float(v) for k, v in stats.items()},
            "pair": (float(pair.gsq_small), float(pair.gsq_big),
                     pair.b_small, pair.b_big)}


def _one_worker_roundtrip(mesh, extra):
    """``compressed_psum`` over a group of one rank (the ``model`` axis has
    4, ``data`` 2: a group of one is the pair ``(data,)`` of a 1-wide
    axis, so take the ranks' own value alone through an axis-free call)."""
    import torch
    from repro_torch.optim.compression import EFState, compressed_psum
    g = torch.from_numpy(np.random.default_rng(3).normal(size=(64,)).astype(
        np.float32) * 3)
    out, ef = compressed_psum({"w": g}, EFState(residual={"w": torch.zeros(
        64)}), (), mesh=mesh)
    return {"sent": _np(out["w"]), "resid": _np(ef.residual["w"])}


def _dp_step(mesh, extra):
    import torch
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.trainer import Trainer, TrainerConfig
    params0, batches = regression_problem(noise=4.0)
    opt = AdamW(lr=1e-2)
    batch = next(batches(8, seed=5))
    params = {k: torch.from_numpy(v.copy()) for k, v in params0.items()}
    tr = Trainer(port_loss, opt, TrainerConfig(mesh=mesh))
    p, o, loss, stats = tr._run_step(
        params, opt.init(params),
        {k: torch.from_numpy(v) for k, v in batch.items()}, n_micro=1)
    from repro_torch.tree import leaves
    return {"params": [_np(t) for t in leaves(p)],
            "opt": [_np(t) for t in leaves(o)], "loss": float(loss),
            "local_sq": stats["local_sq"]}


def _dp_damped_fit(mesh, extra):
    import torch
    from repro_torch.optim import damping as D
    from repro_torch.optim.adamw import SGD
    from repro_torch.train.trainer import Trainer, TrainerConfig
    params0, batches = regression_problem(noise=8.0)
    params = {k: torch.from_numpy(v.copy()) for k, v in params0.items()}
    cfg = TrainerConfig(mesh=mesh, log_every=1, damping=D.DampingConfig(
        accum_max=4, warmup_updates=1, ema=0.5))
    opt = SGD(lr=0.01)
    tr = Trainer(port_loss, opt, cfg)
    tr.fit(params, opt.init(params), (
        {k: torch.from_numpy(v) for k, v in b.items()}
        for b in batches(8, seed=2)), n_steps=10)
    return {"updates": tr.damp_state.updates,
            "b_noise": tr.damp_state.b_noise,
            "losses": [h["loss"] for h in tr.history if "loss" in h]}


def _dp_resume(mesh, extra):
    """A damped data-parallel fit of 6 steps with a checkpoint every 2,
    against the same fit cut after 4 steps and resumed in a fresh trainer
    from its checkpoint (EF residual included), and against a run whose
    step 3 fails once and rolls back in process."""
    import os
    import torch
    from repro_torch.optim import damping as D
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaves
    params0, batches = regression_problem(noise=4.0)
    root = extra["ckpt_root"]

    def data():
        return ({k: torch.from_numpy(v) for k, v in b.items()}
                for b in batches(8, seed=7))

    def run(tag, n_steps, params=None, opt_state=None, fail_at=None):
        opt = AdamW(lr=1e-2)
        if params is None:
            params = {k: torch.from_numpy(v.copy())
                      for k, v in params0.items()}
            opt_state = opt.init(params)
        cfg = TrainerConfig(
            mesh=mesh, ckpt_dir=os.path.join(root, tag), ckpt_every=2,
            async_ckpt=False, damping=D.DampingConfig(
                accum_max=2, warmup_updates=1, ema=0.5))
        tr = Trainer(port_loss, opt, cfg)
        failed = []

        def fail(step):
            if step == fail_at and not failed:
                failed.append(step)
                raise RuntimeError("planted failure")
        p, o = tr.fit(params, opt_state, data(), n_steps,
                      fail_hook=fail if fail_at is not None else None)
        return p, o, tr

    p_full, o_full, tr_full = run("full", 6)
    p_cut, o_cut, tr_cut = run("cut", 4)
    resid_at_cut = [_np(r) for r in leaves(tr_cut._ef_resid)]
    fresh = {k: torch.from_numpy(v.copy()) for k, v in params0.items()}
    p_res, o_res, tr_res = run("cut", 6, fresh, AdamW(lr=1e-2).init(fresh))
    p_fail, o_fail, _ = run("fail", 6, fail_at=3)
    import json
    with open(os.path.join(root, "cut", "step_00000004",
                           "manifest.json")) as f:
        names = json.load(f)["leaves"]
    return {"names": names,"full": [_np(t) for t in leaves((p_full, o_full))],
            "resumed": [_np(t) for t in leaves((p_res, o_res))],
            "failed": [_np(t) for t in leaves((p_fail, o_fail))],
            "resid_full": [_np(r) for r in leaves(tr_full._ef_resid)],
            "resid_resumed": [_np(r) for r in leaves(tr_res._ef_resid)],
            "resid_at_cut": resid_at_cut,
            "consumed": (tr_full.consumed, tr_res.consumed)}


DP_CASES = {"stats_pair": _stats_pair, "one_worker": _one_worker_roundtrip,
            "dp_step": _dp_step, "dp_damped_fit": _dp_damped_fit,
            "dp_resume": _dp_resume}

CASE_TABLES = {"acu": ACU_CASES, "attn_moe": ATTN_MOE_CASES, "dp": DP_CASES}
