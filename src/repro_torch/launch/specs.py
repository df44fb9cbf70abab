"""Abstract arguments + step functions for every (arch x shape) (port of
``repro.launch.specs``).

``build_step`` returns the step function, its arguments as ``meta``
tensors (shapes and dtypes, nothing allocated: the counterpart of
``jax.ShapeDtypeStruct``), and the planner's partition spec of every
argument in place of a sharding. ``launch/roofline.py`` counts a step on
those arguments and ``launch/dryrun.py`` sweeps the cells; only a mesh of
one device runs the step, on arguments from :func:`materialize`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.configs import ModelConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.kernels.runtime import meta_empty
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.parallel import planner
from repro_torch.parallel.sharding import P, use_mesh
from repro_torch.tree import leaves, unflatten


def make_acfg(acu_spec):
    """``'mult:mode[:rank]'`` -> the kernel ApproxConfig (e.g.
    ``mul8s_1L2H:lut``, ``mul8s_trunc2:factored``, ``mul8s_1L2H:lowrank:8``),
    or None. The ACU is built with ``use_kernels=True, fused=True``."""
    if not acu_spec:
        return None
    from repro_torch.core import ApproxConfig, make_acu
    parts = acu_spec.split(":")
    name, mode = parts[0], parts[1] if len(parts) > 1 else "lut"
    rank = int(parts[2]) if len(parts) > 2 else 8
    return ApproxConfig(acu=make_acu(name, mode, rank=rank, use_kernels=True,
                                     fused=True))


@dataclasses.dataclass
class StepBundle:
    fn: Callable                 # the step
    args: tuple                  # meta tensors (trees of them)
    specs: tuple                 # planner specs per argument (trees of P)
    out_specs: Any
    donate_argnums: tuple        # arguments the step updates in place
    meta: dict
    cfg: ModelConfig
    shape: ShapeSpec
    mesh: Any
    arg_names: tuple             # what each argument is (materialize)


def abstract_params(cfg: ModelConfig):
    init = W.init_params if cfg.enc_dec else T.init_params
    return init(0, cfg, device="meta")


def pick_microbatches(cfg: ModelConfig, global_batch: int, seq: int,
                      mesh) -> int:
    """Gradient-accumulation factor: keep per-microbatch saved activations
    (scan carries + attention temps) within ~4 GiB/device."""
    shards = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names and global_batch % (shards * mesh.shape[a]) == 0:
            shards *= mesh.shape[a]
    b_local = max(global_batch // shards, 1)
    # saved carry per group per microbatch-row: S x d x 2 bytes
    bytes_full = b_local * seq * cfg.d_model * 2 * max(cfg.n_groups, 1)
    n_micro = 1
    while n_micro < b_local and bytes_full / n_micro > 4e9:
        n_micro *= 2
    while b_local % n_micro != 0:
        n_micro //= 2
    return max(n_micro, 1)


def make_optimizer(cfg: ModelConfig) -> AdamW:
    return AdamW(lr=cosine_schedule(3e-4, 200, 10000), weight_decay=0.01,
                 clip_norm=1.0)


def _check_runnable(mesh) -> None:
    if mesh.size != 1:
        from repro_torch.core.acu import not_ported
        raise not_ported(f"a step over a mesh of {mesh.size} devices",
                         "queue 1, item 16c")


@dataclasses.dataclass
class TrainStep:
    """One optimizer step: the mean loss and gradients over ``n_micro``
    equal microbatches (each batch argument split along dim 0), summed into
    float32 as the reference does (``loss + l_i / n``, ``acc + g_i / n``,
    ``n`` a float32 tensor), then ``opt.update``, which writes the
    parameters and the optimizer state in place. With one microbatch the
    gradients go to the optimizer as they come. ``__call__`` is
    :meth:`begin`, :meth:`micro` per microbatch, :meth:`end`; the roofline
    counter counts :meth:`micro` once and multiplies."""

    loss: Callable               # loss(params, *batch) -> scalar
    opt: AdamW
    n_micro: int
    mesh: Any

    def begin(self, params) -> dict:
        live = [p.detach().requires_grad_(True) for p in leaves(params)]
        st = {"live": live, "tree": unflatten(params, live)}
        if self.n_micro > 1:
            dev = live[0].device
            st["loss"] = torch.zeros((), dtype=torch.float32, device=dev)
            st["acc"] = [torch.zeros(p.shape, dtype=torch.float32,
                                     device=dev) for p in live]
            st["n"] = torch.tensor(float(self.n_micro), device=dev)
        return st

    def micro(self, st: dict, *batch) -> None:
        with use_mesh(self.mesh):
            li = self.loss(st["tree"], *batch)
        gs = torch.autograd.grad(li, st["live"], allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g
              for p, g in zip(st["live"], gs)]
        if self.n_micro == 1:
            st["loss"], st["grads"] = li.detach(), gs
            return
        with torch.no_grad():
            st["loss"] = st["loss"] + li.detach() / st["n"]
            for a, g in zip(st["acc"], gs):
                a.add_(g.to(torch.float32) / st["n"])

    def end(self, st: dict, opt_state, params):
        grads = st["grads"] if self.n_micro == 1 else st["acc"]
        new_params, new_state = self.opt.update(unflatten(params, grads),
                                                opt_state, params)
        return new_params, new_state, st["loss"]

    def __call__(self, params, opt_state, *batch):
        _check_runnable(self.mesh)
        st = self.begin(params)
        mb = batch[0].shape[0] // self.n_micro
        for i in range(self.n_micro):
            self.micro(st, *(t[i * mb:(i + 1) * mb] for t in batch))
        return self.end(st, opt_state, params)


def _serve_step(fn, mesh):
    """``fn`` under the mesh context, with no gradient recorded."""
    @torch.no_grad()
    def step(*args):
        _check_runnable(mesh)
        with use_mesh(mesh):
            return fn(*args)
    return step


def build_step(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
               acfg=None) -> StepBundle:
    """Construct (fn, meta args, specs) for one cell."""
    b, s = shape.global_batch, shape.seq_len
    params = abstract_params(cfg)
    pplan = planner.param_specs(cfg, params, mesh,
                                mode="train" if shape.kind == "train" else "serve")
    tok_spec = planner.batch_spec(mesh, b, extra_dims=1)
    enc_spec = planner.batch_spec(mesh, b, extra_dims=2)
    meta = {"plan_report": pplan.report, "kind": shape.kind}
    if cfg.n_experts:
        # static MoE dispatch geometry under this mesh (resolved block
        # count, per-block capacity) — the dry-run surfaces it per cell
        from repro_torch.models.moe import dispatch_geometry
        with use_mesh(mesh):
            meta["moe_dispatch"] = dispatch_geometry(
                cfg, b * (1 if shape.kind == "decode" else s))
    bundle = dict(meta=meta, cfg=cfg, shape=shape, mesh=mesh)
    toks = meta_empty(b, s, dtype=torch.int32)
    enc_in = meta_empty(b, cfg.enc_ctx, cfg.d_model, dtype=cfg.param_dtype)

    if shape.kind == "train":
        opt = make_optimizer(cfg)
        opt_state = opt.init(params)
        ospecs = planner.opt_state_specs(pplan, opt_state)
        out_specs = (pplan.specs, ospecs, P())
        if cfg.enc_dec:
            step = TrainStep(
                lambda p, fr, tk, lb: W.loss_fn(p, fr, tk, lb, cfg, acfg),
                opt, 1, mesh)
            return StepBundle(
                fn=step, args=(params, opt_state, enc_in, toks, toks),
                specs=(pplan.specs, ospecs, enc_spec, tok_spec, tok_spec),
                out_specs=out_specs, donate_argnums=(0, 1),
                arg_names=("params", "opt_state", "frames", "tokens",
                           "labels"), **bundle)
        n_micro = pick_microbatches(cfg, b, s, mesh)
        meta["n_microbatches"] = n_micro
        step = TrainStep(lambda p, tk, lb: T.loss_fn(p, tk, lb, cfg, acfg),
                         opt, n_micro, mesh)
        return StepBundle(
            fn=step, args=(params, opt_state, toks, toks),
            specs=(pplan.specs, ospecs, tok_spec, tok_spec),
            out_specs=out_specs, donate_argnums=(0, 1),
            arg_names=("params", "opt_state", "tokens", "labels"), **bundle)

    # ---- serving shapes ---------------------------------------------------
    long_ctx = shape.name.startswith("long")
    cache = (W.init_cache if cfg.enc_dec else T.init_cache)(
        cfg, b, s, device="meta")
    cplan = planner.cache_specs(cfg, cache, mesh, global_batch=b,
                                long_context=long_ctx)
    meta["cache_report"] = cplan.report
    logit_spec = planner.batch_spec(mesh, b)
    out_specs = (logit_spec, cplan.specs)

    if shape.kind == "prefill":
        if cfg.enc_dec:
            def prefill(params, cache, frames, tokens):
                enc = W.encode(params, frames, cfg, acfg)
                logits, cache = W.decode(params, tokens, enc, cfg, acfg=acfg,
                                         cache=cache, cache_pos=0,
                                         last_only=True)
                return logits[:, -1], cache

            return StepBundle(
                fn=_serve_step(prefill, mesh),
                args=(params, cache, enc_in, toks),
                specs=(pplan.specs, cplan.specs, enc_spec, tok_spec),
                out_specs=out_specs, donate_argnums=(1,),
                arg_names=("params", "cache", "frames", "tokens"), **bundle)

        def prefill(params, cache, tokens):
            logits, cache = T.apply_model(params, tokens, cfg, acfg=acfg,
                                          cache=cache, cache_pos=0,
                                          last_only=True)
            return logits[:, -1], cache

        return StepBundle(
            fn=_serve_step(prefill, mesh), args=(params, cache, toks),
            specs=(pplan.specs, cplan.specs, tok_spec),
            out_specs=out_specs, donate_argnums=(1,),
            arg_names=("params", "cache", "tokens"), **bundle)

    # decode: one new token against a seq_len-deep cache
    tok1 = meta_empty(b, 1, dtype=torch.int32)
    pos = meta_empty(dtype=torch.int32)
    if cfg.enc_dec:
        def decode(params, cache, enc_out, tokens, pos):
            logits, cache = W.decode(params, tokens, enc_out, cfg, acfg=acfg,
                                     cache=cache, cache_pos=pos)
            return logits[:, -1], cache

        return StepBundle(
            fn=_serve_step(decode, mesh),
            args=(params, cache, enc_in, tok1, pos),
            specs=(pplan.specs, cplan.specs, enc_spec, tok_spec, P()),
            out_specs=out_specs, donate_argnums=(1,),
            arg_names=("params", "cache", "enc_out", "tokens", "pos"),
            **bundle)

    def decode(params, cache, tokens, pos):
        logits, cache = T.apply_model(params, tokens, cfg, acfg=acfg,
                                      cache=cache, cache_pos=pos, decode=True)
        return logits[:, -1], cache

    return StepBundle(
        fn=_serve_step(decode, mesh), args=(params, cache, tok1, pos),
        specs=(pplan.specs, cplan.specs, tok_spec, P()),
        out_specs=out_specs, donate_argnums=(1,),
        arg_names=("params", "cache", "tokens", "pos"), **bundle)


def materialize(bundle: StepBundle, device=None, seed: int = 0,
                params: Optional[dict] = None) -> tuple:
    """The bundle's arguments on a real device (``cuda`` unless given),
    from ``seed``: parameters from ``init_params`` (or ``params``, used as
    they are), the optimizer state from ``make_optimizer(cfg).init``, a
    zero cache, token ids uniform over the vocabulary and frames N(0, 1)
    (a ``torch.Generator`` on the device), and ``pos`` the cache's last
    slot, so a decode step sees the whole cache."""
    from repro_torch.kernels.runtime import resolve_device
    cfg, shape = bundle.cfg, bundle.shape
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    fam = W if cfg.enc_dec else T
    if params is None:
        params = fam.init_params(seed, cfg, device=dev)
    out = []
    for name, arg in zip(bundle.arg_names, bundle.args):
        if name == "params":
            out.append(params)
        elif name == "opt_state":
            out.append(make_optimizer(cfg).init(params))
        elif name == "cache":
            out.append(fam.init_cache(cfg, shape.global_batch, shape.seq_len,
                                      device=dev))
        elif name in ("tokens", "labels"):
            out.append(torch.randint(0, cfg.vocab_size, tuple(arg.shape),
                                     generator=gen, device=dev,
                                     dtype=arg.dtype))
        elif name in ("frames", "enc_out"):
            out.append(torch.randn(tuple(arg.shape), generator=gen,
                                   device=dev).to(arg.dtype))
        elif name == "pos":
            out.append(torch.tensor(shape.seq_len - 1, dtype=arg.dtype,
                                    device=dev))
        else:
            raise ValueError(f"unknown step argument {name!r}")
    return tuple(out)
