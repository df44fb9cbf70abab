"""The port's shapes, mesh shapes, logical-axis rules and sharding planner
(``configs/shapes.py``, ``launch/mesh.py``, ``parallel/sharding.py``,
``parallel/planner.py``) against the JAX reference on the CPU.

The cases of ``tests/test_sharding.py`` are mirrored on the port's
:class:`MeshShape` (the reference's ``FakeMesh`` made a type). The parity
cases pass one duck-typed mesh to both planners and compare exactly: every
parameter, cache and optimizer leaf's spec by its ``keystr`` name, every
report line letter for letter, the eligibility matrix, the microbatch
policy, the ACU partitions and the MoE dispatch geometry. JAX normalises a
one-axis tuple entry of a ``PartitionSpec`` to the axis name, so the port's
specs are compared after the same normalisation. The reference is loaded
inside fixtures and test bodies only.
"""
from __future__ import annotations

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import (ARCH_NAMES, SHAPES, all_configs,  # noqa: E402
                                 cells, get_config)
from repro_torch.launch.mesh import (MeshShape, make_host_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.launch.specs import (abstract_params,  # noqa: E402
                                      pick_microbatches)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models import whisper as W  # noqa: E402
from repro_torch.parallel import planner  # noqa: E402
from repro_torch.parallel.sharding import (DEFAULT_RULES,  # noqa: E402
                                           MeshContext, P,
                                           current_mesh_context, shard,
                                           use_mesh, use_mesh_context)
from repro_torch.tree import leaves, leaves_with_names  # noqa: E402

MESH = MeshShape({"data": 16, "model": 16})
MESH_MP = MeshShape({"pod": 2, "data": 16, "model": 16})
MESHES = {"16x16": MESH, "2x16x16": MESH_MP}


@pytest.fixture(scope="module")
def ref():
    from test_torch_parity import load_reference
    load_reference()
    import jax
    from jax.sharding import PartitionSpec
    import repro.configs as RC
    import repro.launch.specs as RS
    import repro.models.moe as RM
    import repro.models.transformer as RT
    import repro.models.whisper as RW
    import repro.parallel.planner as RP
    import repro.parallel.sharding as RSH
    return dict(jax=jax, P=PartitionSpec, configs=RC, specs=RS, moe=RM,
                T=RT, W=RW, planner=RP, sharding=RSH)


def _norm(spec) -> tuple:
    """A spec's entries as JAX stores them (a one-axis tuple -> its name)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _ref_specs(ref, tree) -> list[tuple[str, tuple]]:
    jax, JP = ref["jax"], ref["P"]
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return [(jax.tree_util.keystr(p), tuple(s)) for p, s in flat]


def _port_specs(tree) -> list[tuple[str, tuple]]:
    return [(n, _norm(s)) for n, s in leaves_with_names(tree)]


# --------------------------------------------------------------------------
# shapes and meshes
# --------------------------------------------------------------------------

def test_cells_match_reference(ref):
    """The 40-cell matrix: same cells, eligibility and reasons (mirrors
    ``tests/test_models.py::test_eligibility_matrix``)."""
    mine = cells(all_configs())
    theirs = ref["configs"].cells(ref["configs"].all_configs())
    assert mine == theirs
    assert len(mine) == 40
    skipped = [c for c in mine if not c[2]]
    assert len(skipped) == 8
    assert all(c[1] == "long_500k" for c in skipped)
    assert {n: (s.seq_len, s.global_batch, s.kind) for n, s in SHAPES.items()} \
        == {n: (s.seq_len, s.global_batch, s.kind)
            for n, s in ref["configs"].SHAPES.items()}


def test_mesh_shapes():
    """The production meshes' axes and sizes (the reference's
    ``make_production_mesh``/``make_host_mesh``); nothing touches a
    device."""
    assert (MESH.shape, MESH.axis_names, MESH.size) == \
        (make_production_mesh().shape, ("data", "model"), 256)
    mp = make_production_mesh(multi_pod=True)
    assert (mp.shape, mp.axis_names, mp.size) == \
        ({"pod": 2, "data": 16, "model": 16}, ("pod", "data", "model"), 512)
    host = make_host_mesh()
    assert (host.shape, host.axis_names, host.size) == \
        ({"data": 1, "model": 1}, ("data", "model"), 1)


# --------------------------------------------------------------------------
# the cases of tests/test_sharding.py
# --------------------------------------------------------------------------

def _check_divisibility(specs, params):
    for sp, leaf in zip(leaves(specs), leaves(params)):
        for i, part in enumerate(sp):
            if part is None:
                continue
            axes = (part,) if isinstance(part, str) else part
            n = math.prod(MESH.shape.get(a, MESH_MP.shape.get(a, 1))
                          for a in axes)
            assert leaf.shape[i] % n == 0, (sp, leaf.shape, i)


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("mode", ["train", "serve"])
def test_param_specs_divisible(arch, mode):
    """Every sharded dim divides the axis product — for all 10 archs."""
    cfg = get_config(arch)
    params = abstract_params(cfg)
    plan = planner.param_specs(cfg, params, MESH, mode=mode)
    _check_divisibility(plan.specs, params)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen2.5-14b",
                                  "smollm-135m", "whisper-small"])
def test_nondivisible_heads_reported(arch):
    cfg = get_config(arch)
    plan = planner.param_specs(cfg, abstract_params(cfg), MESH, mode="train")
    assert any("heads" in r for r in plan.report)


def test_batch_spec_fallbacks():
    assert planner.batch_spec(MESH, 256) == P(("data",), None)
    assert planner.batch_spec(MESH_MP, 256) == P(("pod", "data"), None)
    assert planner.batch_spec(MESH, 1) == P(None, None)       # long_500k
    assert planner.batch_spec(MESH_MP, 32) == P(("pod", "data"), None)


def test_mesh_context_dedupes_axes():
    """One mesh axis may appear at most once per spec (MoE regression)."""
    mesh = MeshShape({"data": 4, "model": 4})
    ctx = MeshContext(mesh=mesh, rules=dict(DEFAULT_RULES))
    sp = ctx.spec("experts", None, "expert_mlp", dim_sizes=(8, 3, 8))
    flat = [a for part in sp if part for a in
            ((part,) if isinstance(part, str) else part)]
    assert len(flat) == len(set(flat))


def test_mesh_context_divisibility_fallback():
    mesh = MeshShape({"data": 4, "model": 4})
    ctx = MeshContext(mesh=mesh, rules=dict(DEFAULT_RULES))
    assert ctx.spec("heads", dim_sizes=(9,)) == P(None)   # 9 % 4 != 0
    assert ctx.spec("heads", dim_sizes=(8,)) == P("model")


def test_microbatch_policy():
    cfg = get_config("qwen2-vl-72b")
    n = pick_microbatches(cfg, 256, 4096, MESH)
    assert n >= 8                       # 80L x 8192d needs accumulation
    assert 256 % n == 0
    small = pick_microbatches(get_config("smollm-135m"), 256, 4096, MESH)
    assert small == 1                   # tiny model: no accumulation


def test_acu_gemm_partition_defaults():
    """Default ACU rules: rows over (pod,)data, cols over model, K
    replicated — and the specs a sharded GEMM would consume."""
    ctx = MeshContext(mesh=MESH, rules=dict(DEFAULT_RULES))
    part, report = planner.acu_gemm_partition(ctx)
    assert (part.rows, part.cols, part.k) == (("data",), ("model",), ())
    assert (part.n_rows, part.n_cols, part.n_k) == (16, 16, 1)
    assert part.a_spec() == P("data", None)
    assert part.w_spec() == P(None, "model")
    assert part.out_spec() == P("data", "model")
    assert not report
    mp, _ = planner.acu_gemm_partition(
        MeshContext(mesh=MESH_MP, rules=dict(DEFAULT_RULES)))
    assert mp.rows == ("pod", "data") and mp.n_rows == 32


def test_acu_gemm_partition_contracting_claims_model():
    """acu_k wins the model axis; cols fall back with an audited report."""
    rules = dict(DEFAULT_RULES, acu_k=("model",))
    part, report = planner.acu_gemm_partition(
        MeshContext(mesh=MESH, rules=rules))
    assert part.k == ("model",) and part.cols == ()
    assert part.a_spec() == P("data", "model")
    assert part.w_spec() == P("model", None)
    assert any("contraction" in r for r in report)


def test_acu_gemm_partition_lowrank_drops_k():
    """Float accumulators (LOWRANK) cannot psum bit-exactly -> K replicated."""
    rules = dict(DEFAULT_RULES, acu_k=("model",))
    part, report = planner.acu_gemm_partition(
        MeshContext(mesh=MESH, rules=rules), float_accum=True)
    assert part.k == () and part.cols == ("model",)
    assert any("LOWRANK" in r for r in report)
    assert part.report == tuple(report)


def test_use_mesh_context_verbatim():
    """use_mesh_context must not re-merge DEFAULT_RULES: a context whose
    rules omit a key means 'replicated there'."""
    ctx = MeshContext(mesh=MESH, rules={"acu_rows": ("data",)})
    with use_mesh_context(ctx):
        active = current_mesh_context()
        assert active is ctx
        assert active.axes_for("acu_cols") == ()   # omitted -> replicated
    assert current_mesh_context() is None


def test_serve_fsdp_threshold():
    big = get_config("command-r-plus-104b")
    plan = planner.param_specs(big, abstract_params(big), MESH, mode="serve")
    assert any("ZeRO-inference" in r for r in plan.report)
    small = get_config("gemma2-27b")
    plan2 = planner.param_specs(small, abstract_params(small), MESH,
                                mode="serve")
    assert not any("ZeRO-inference" in r for r in plan2.report)


def test_shard_identity_and_refusal():
    """``shard`` is the identity without a mesh and on one device, and
    refuses a larger shape-only mesh (a ``MeshShape`` has no ranks; under
    a mesh of ranks it is a checked identity,
    ``tests/test_torch_sharded_acu.py``)."""
    x = torch.ones(4, 8)
    assert shard(x, "batch", "mlp") is x
    with use_mesh(make_host_mesh()):
        assert shard(x, "batch", "mlp") is x
    with use_mesh(MESH):
        with pytest.raises(NotImplementedError,
                           match="shape-only mesh.*ROADMAP.md, queue 1, "
                                 "item 16c"):
            shard(x, "batch", "mlp")


def test_abstract_params_on_meta():
    """``abstract_params`` and ``init_cache`` build on ``meta``: shapes and
    dtypes of the real init, nothing allocated."""
    cfg = get_config("smollm-135m")
    params = abstract_params(cfg)
    real = T.init_params(0, dict_replace(cfg, n_layers=2), device="cpu")
    assert all(t.device.type == "meta" for t in leaves(params))
    assert [(n, t.dtype) for n, t in leaves_with_names(params)] == \
        [(n, t.dtype) for n, t in leaves_with_names(real)]
    cache = T.init_cache(cfg, 4, 1024, device="meta")
    assert all(t.device.type == "meta" for t in leaves(cache))
    wc = W.init_cache(get_config("whisper-small"), 2, 64, device="meta")
    assert all(t.device.type == "meta" for t in leaves(wc))


def dict_replace(cfg, **kw):
    import dataclasses
    return dataclasses.replace(cfg, **kw)


# --------------------------------------------------------------------------
# parity with the reference's planner
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_and_opt_specs_match_reference(ref, arch):
    """``param_specs`` (leaf by leaf, report line by line) and
    ``opt_state_specs`` for train and serve on 16x16 and 2x16x16."""
    cfg, rcfg = get_config(arch), ref["configs"].get_config(arch)
    params = abstract_params(cfg)
    rparams = ref["specs"].abstract_params(rcfg)
    from repro_torch.launch.specs import make_optimizer
    opt_state = make_optimizer(cfg).init(params)
    ropt = ref["jax"].eval_shape(ref["specs"].make_optimizer(rcfg).init,
                                 rparams)
    for mesh in MESHES.values():
        for mode in ("train", "serve"):
            plan = planner.param_specs(cfg, params, mesh, mode=mode)
            rplan = ref["planner"].param_specs(rcfg, rparams, mesh, mode=mode)
            assert _port_specs(plan.specs) == _ref_specs(ref, rplan.specs)
            assert plan.report == rplan.report
            ospecs = planner.opt_state_specs(plan, opt_state)
            rospecs = ref["planner"].opt_state_specs(rplan, ropt)
            assert _port_specs(ospecs) == _ref_specs(ref, rospecs)


def test_cache_specs_match_reference(ref):
    """``cache_specs`` for every eligible serving cell on both meshes."""
    jax = ref["jax"]
    n = 0
    for arch, shape_name, ok, _ in cells(all_configs()):
        shape = SHAPES[shape_name]
        if not ok or shape.kind == "train":
            continue
        cfg, rcfg = get_config(arch), ref["configs"].get_config(arch)
        b, s = shape.global_batch, shape.seq_len
        fam, rfam = (W, ref["W"]) if cfg.enc_dec else (T, ref["T"])
        cache = fam.init_cache(cfg, b, s, device="meta")
        rcache = jax.eval_shape(lambda: rfam.init_cache(rcfg, b, s))
        long_ctx = shape_name.startswith("long")
        for mesh in MESHES.values():
            plan = planner.cache_specs(cfg, cache, mesh, global_batch=b,
                                       long_context=long_ctx)
            rplan = ref["planner"].cache_specs(rcfg, rcache, mesh,
                                               global_batch=b,
                                               long_context=long_ctx)
            assert _port_specs(plan.specs) == _ref_specs(ref, rplan.specs), \
                (arch, shape_name)
            assert plan.report == rplan.report
            n += 1
    assert n == 2 * 22     # 10 archs x 2 serving shapes + 2 long_500k


def test_pick_microbatches_and_batch_spec_match_reference(ref):
    meshes = [make_host_mesh(), MESH, MESH_MP]
    for arch in ARCH_NAMES:
        cfg, rcfg = get_config(arch), ref["configs"].get_config(arch)
        for shape in SHAPES.values():
            for mesh in meshes:
                assert pick_microbatches(cfg, shape.global_batch,
                                         shape.seq_len, mesh) == \
                    ref["specs"].pick_microbatches(
                        rcfg, shape.global_batch, shape.seq_len, mesh)
                for extra in (1, 2):
                    assert _norm(planner.batch_spec(
                        mesh, shape.global_batch, extra)) == tuple(
                        ref["planner"].batch_spec(mesh, shape.global_batch,
                                                  extra))


def _rule_sets():
    return {"default": {},
            "contraction": {"acu_k": ("model",), "acu_conv_k": ("model",),
                            "acu_grouped_k": ("model",)},
            "contraction_data": {"acu_k": ("data",),
                                 "acu_conv_k": ("pod", "data"),
                                 "acu_grouped_k": ("data",)}}


def _part(p) -> tuple:
    return (p.rows, p.cols, p.k, p.n_rows, p.n_cols, p.n_k, p.report,
            p.total, _norm(p.a_spec()), _norm(p.w_spec()),
            _norm(p.out_spec()))


def test_acu_partitions_match_reference(ref):
    """Every ``acu_*_partition`` and ``bwd_gemm_partitions`` on the default
    and the contraction-sharding rules, report strings included."""
    RP, RSH = ref["planner"], ref["sharding"]
    meshes = [MESH, MESH_MP, MeshShape({"data": 4, "model": 4}),
              make_host_mesh()]
    for mesh in meshes:
        for extra in _rule_sets().values():
            ctx = MeshContext(mesh=mesh, rules={**DEFAULT_RULES, **extra})
            rctx = RSH.MeshContext(mesh=mesh,
                                   rules={**RSH.DEFAULT_RULES, **extra})
            for fa in (False, True):
                for fn in ("acu_gemm_partition", "acu_conv_partition"):
                    mine, rep = getattr(planner, fn)(ctx, float_accum=fa)
                    theirs, rrep = getattr(RP, fn)(rctx, float_accum=fa)
                    assert _part(mine) == _part(theirs) and rep == rrep
                    if fn == "acu_gemm_partition":
                        for a, b in zip(planner.bwd_gemm_partitions(mine),
                                        RP.bwd_gemm_partitions(theirs)):
                            assert _part(a) == _part(b)
            for hq, hkv in ((9, 3), (32, 8), (64, 16), (24, 8), (12, 12)):
                mine, rep = planner.acu_attn_partition(ctx, hq=hq, hkv=hkv)
                theirs, rrep = RP.acu_attn_partition(rctx, hq=hq, hkv=hkv)
                assert _part(mine) == _part(theirs) and rep == rrep
            for e, nb in ((40, 16), (64, 32), (16, 256), (8, 3), (40, 1)):
                mine, rep = planner.acu_grouped_partition(
                    ctx, n_experts=e, n_blocks=nb)
                theirs, rrep = RP.acu_grouped_partition(
                    rctx, n_experts=e, n_blocks=nb)
                assert _part(mine) == _part(theirs) and rep == rrep


def test_mesh_context_spec_matches_reference(ref):
    """``MeshContext.spec``, ``axes_for``, ``axis_prod`` and ``size`` on
    every default rule and a sweep of dim sizes."""
    RSH = ref["sharding"]
    rng = np.random.default_rng(0)
    names = [None] + sorted(DEFAULT_RULES)
    for mesh in (MESH, MESH_MP, MeshShape({"data": 4, "model": 4})):
        ctx = MeshContext(mesh=mesh, rules=dict(DEFAULT_RULES))
        rctx = RSH.MeshContext(mesh=mesh, rules=dict(RSH.DEFAULT_RULES))
        assert ctx.size == rctx.size
        for name in names[1:]:
            assert ctx.axes_for(name) == rctx.axes_for(name)
            assert ctx.axis_prod(ctx.axes_for(name)) == \
                rctx.axis_prod(rctx.axes_for(name))
        for _ in range(200):
            nd = int(rng.integers(1, 5))
            logical = [names[i] for i in rng.integers(0, len(names), nd)]
            dims = [int(d) for d in rng.choice([1, 3, 8, 9, 16, 32, 40, 512],
                                               nd)]
            for ds in (None, dims):
                assert _norm(ctx.spec(*logical, dim_sizes=ds)) == \
                    tuple(rctx.spec(*logical, dim_sizes=ds))


def test_dispatch_geometry_under_mesh_matches_reference(ref):
    """``moe.dispatch_geometry`` under ``use_mesh`` (blocks = pod x data
    ways) and without a context (16 blocks), as the reference's."""
    from repro_torch.models.moe import dispatch_geometry
    RM, RSH = ref["moe"], ref["sharding"]
    for arch in ("granite-moe-3b-a800m", "olmoe-1b-7b", "jamba-v0.1-52b"):
        cfg, rcfg = get_config(arch), ref["configs"].get_config(arch)
        for t in (1, 7, 128, 4096, 32 * 32768, 256 * 4096):
            assert dispatch_geometry(cfg, t) == RM.dispatch_geometry(rcfg, t)
            for mesh in (MESH, MESH_MP, make_host_mesh(),
                         MeshShape({"data": 4, "model": 2})):
                with use_mesh(mesh):
                    mine = dispatch_geometry(cfg, t)
                with RSH.use_mesh(mesh):
                    theirs = RM.dispatch_geometry(rcfg, t)
                assert mine == theirs, (arch, t, mesh)
