"""Roofline terms of one step on one NVIDIA H100 (port of
``repro.launch.roofline``).

Terms per (arch x shape), per device:
  T_compute    = max(FLOPs / peak bf16 FLOP/s, LUT lookups / gather rate)
  T_memory     = bytes / HBM bandwidth
  T_collective = collective bytes / NVLink bandwidth (0 on one device)

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` and its
collectives from the compiled HLO. The port has neither: :func:`count_step`
runs the step on its ``meta`` arguments under a dispatch mode that counts
every ATen op, and adds the work each kernel's ``meta`` shape rule reports
(``kernels/runtime.py: count_work``). The constants are data-sheet peaks,
not measured ceilings, so a measured step's share of its bound cannot pass
1 unless the count is wrong.

Two bounds, kept apart:
  step_time_lb  = max of the three terms above: the floor of the step's
                  eager op graph as the port runs it. Its bytes include
                  every intermediate the graph materialises (the float32
                  attention scores most), so a change that fuses ops or
                  drops an intermediate lowers this bound too.
  step_time_min = max(model_flops / peak bf16, lookups / gather rate,
                  min_bytes / HBM bandwidth): the algorithmic floor, which
                  no implementation of the step moves. ``min_bytes`` is
                  :func:`algorithmic_bytes`: weights, optimizer state,
                  cache and batch read or written once, activations left
                  out.

Analytic correction: ``recurrence_correction`` (the RWKV WKV recurrence,
which XLA under-counts inside nested scans) is kept for the cells whose
count lacks the recurrence; kernel 12's shape rule counts it, so on the
port it is added only where no ``wkv`` launch was counted.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import runtime
from repro_torch.tree import leaves

# NVIDIA H100 80GB HBM3 (SXM, 700 W), NVIDIA's H100 data sheet, dense rates
PEAK_BF16 = 989e12          # FLOP/s, bf16 tensor cores, without sparsity
HBM_BW = 3.35e12            # B/s, HBM3
NVLINK_BW = 900e9           # B/s, NVLink 4 (18 links), one GPU's total
# LUT gathers: 132 SMs x 32 lanes x 1980 MHz, one lookup a lane a cycle
# (the SM count and boost clock of the same card; PERF.md's gather bound)
GATHER_RATE = 132 * 32 * 1980e6


@dataclasses.dataclass
class CellCost:
    flops: float                 # per device
    bytes_accessed: float        # per device
    coll_bytes: float            # per device (result-bytes convention)
    coll_breakdown: dict
    peak_memory: float           # per device bytes (args + live temps)
    arg_bytes: float
    lookups: float = 0.0         # LUT gathers of the kernels' shape rules
    kernels: dict = dataclasses.field(default_factory=dict)
    min_bytes: float = 0.0       # algorithmic_bytes: the floor's bytes
    model_flops: float = 0.0     # per device

    @property
    def t_compute(self) -> float:
        return max(self.flops / PEAK_BF16, self.lookups / GATHER_RATE)

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Lower-bound step time of the eager op graph = max of the three
        terms (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def t_memory_min(self) -> float:
        return self.min_bytes / HBM_BW

    @property
    def step_time_min(self) -> float:
        """The algorithmic floor: model FLOPs at the peak, the lookups at
        the gather rate, or ``min_bytes`` at the HBM rate, the longest."""
        return max(self.model_flops / PEAK_BF16, self.lookups / GATHER_RATE,
                   self.t_memory_min)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "bytes": self.bytes_accessed,
            "lookups": self.lookups,
            "coll_bytes": self.coll_bytes, "coll_breakdown": self.coll_breakdown,
            "peak_memory": self.peak_memory, "arg_bytes": self.arg_bytes,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "bottleneck": self.bottleneck,
            "step_time_lb": self.step_time, "kernels": self.kernels,
            "min_bytes": self.min_bytes, "t_memory_min": self.t_memory_min,
            "step_time_min": self.step_time_min,
        }


def two_point(cost_u1: CellCost, cost_u2: CellCost, n_groups: int) -> CellCost:
    """total = outside + n_groups * (group delta); memory stats from u1."""
    def comb(a, b):
        delta = max(b - a, 0.0)
        return a + (n_groups - 1) * delta

    coll = {}
    keys = set(cost_u1.coll_breakdown) | set(cost_u2.coll_breakdown)
    for k in keys:
        coll[k] = comb(cost_u1.coll_breakdown.get(k, 0),
                       cost_u2.coll_breakdown.get(k, 0))
    return CellCost(
        flops=comb(cost_u1.flops, cost_u2.flops),
        bytes_accessed=comb(cost_u1.bytes_accessed, cost_u2.bytes_accessed),
        coll_bytes=float(sum(coll.values())),
        coll_breakdown=coll,
        peak_memory=cost_u1.peak_memory,
        arg_bytes=cost_u1.arg_bytes,
        lookups=comb(cost_u1.lookups, cost_u2.lookups),
    )


def model_flops(cfg, shape, n_devices: int) -> float:
    """MODEL_FLOPS per device: 6*N*D train, 2*N*D forward-only (D = tokens
    processed; decode D = global_batch tokens). MoE uses active params."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        total = 6.0 * n * toks
    elif shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        total = 2.0 * n * toks
    else:  # decode: one token per sequence
        total = 2.0 * n * shape.global_batch
    return total / n_devices


def recurrence_correction(cfg, shape, n_devices: int) -> tuple[float, float]:
    """Analytic FLOPs/bytes for nested-scan recurrences (RWKV WKV)."""
    if not cfg.pattern or cfg.pattern[0] != "rwkv":
        return 0.0, 0.0
    if shape.kind == "decode":
        toks = shape.global_batch
    else:
        toks = shape.global_batch * shape.seq_len
    h, hd = cfg.rwkv_n_heads, cfg.rwkv_head_dim
    # per token per layer: kv outer (h*hd*hd) + state update (2x) + readout (2x)
    fl = 5.0 * h * hd * hd * toks * cfg.n_layers
    by = 2.0 * 4.0 * h * hd * hd * toks * cfg.n_layers  # state r/w fp32
    return fl / n_devices, by / n_devices


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
# ops that move no bytes: allocation without a write, aliasing, metadata
_NO_TRAFFIC = {_aten._unsafe_view, _aten.empty, _aten.empty_strided,
               _aten.empty_like, _aten.new_empty, _aten.new_empty_strided,
               _aten.lift_fresh, _aten.sym_size, _aten.sym_stride,
               _aten.sym_numel, _aten.sym_storage_offset}
# ops that write their first argument without reading it
_WRITE_ONLY = {_aten.fill_, _aten.zero_, _aten.copy_}
# gathers read the rows they return, not the whole source
_GATHERS = {_aten.embedding, _aten.index_select, _aten.gather, _aten.index}


def _tensors(tree) -> list:
    out = []
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            out.extend(_tensors(t))
    elif isinstance(tree, dict):
        for t in tree.values():
            out.extend(_tensors(t))
    return out


def tree_bytes(tree) -> float:
    return float(sum(t.numel() * t.element_size() for t in leaves(tree)))


def algorithmic_bytes(bundle, out) -> float:
    """The bytes any implementation of ``bundle``'s step must move, given
    its results ``out``: every argument read once (a prefill's cache is
    only written), the new result written once (the loss; the logits), a
    training step's parameters and optimizer state written once (every
    leaf changes), and a prefill's cache written once (it fills every
    slot). A serving step reads only the rows it looks up of a table that
    is nothing but a lookup (an untied ``embed``, whisper's ``dec_pos``):
    one a token, at most the table. Every MoE expert counts as read: each
    cell routes ``tokens * top_k`` assignments, at least the experts'
    number. Left out, so that it stays a floor: activations (an
    implementation may recompute them) and a decode step's writes into its
    cache (one slot a layer). No choice of kernels or fusion moves it."""
    cfg, kind = bundle.cfg, bundle.shape.kind
    size = {n: tree_bytes(a) for n, a in zip(bundle.arg_names, bundle.args)}
    read = sum(v for n, v in size.items()
               if not (n == "cache" and kind == "prefill"))
    if kind != "train":
        params = bundle.args[bundle.arg_names.index("params")]
        looked_up = [] if cfg.tie_embed else ["embed"]
        looked_up += ["dec_pos"] if cfg.enc_dec else []
        tokens = bundle.shape.global_batch * (
            1 if kind == "decode" else bundle.shape.seq_len)
        for name in looked_up:
            table = params[name]
            rows = min(tokens, table.shape[0])
            read -= (table.shape[0] - rows) * table[0].numel() \
                * table.element_size()
    if kind == "train":
        written = size["params"] + size["opt_state"] + tree_bytes(out[2])
    elif kind == "prefill":
        written = size["cache"] + tree_bytes(out[0])
    else:
        written = tree_bytes(out[0])
    return read + written


def _bytes(ts) -> int:
    seen, total = set(), 0
    for t in ts:
        if id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


class _Counter(TorchDispatchMode):
    """Counts every ATen op run under it: matmul/conv/attention FLOPs by
    ``torch.utils.flop_counter``'s formulas; bytes as each op's operands
    read once and its results written once (XLA's "bytes accessed"
    convention), except that views and allocations move nothing, a fill or
    a copy only writes (a copy reads its source), and a gather reads what
    it returns; live bytes, from the storages the ops create and Python's
    release of them."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.scale = 1
        self.live = 0
        self.peak = 0
        self._tracked: set[int] = set()

    def _free(self, key: int, n: int) -> None:
        self._tracked.discard(key)
        self.live -= n

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._tracked:
            return
        n = st.nbytes()
        self._tracked.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += self.scale * flop_registry[packet](
                *args, **kwargs, out_val=out)
        outs = _tensors(out)
        if func.is_view or packet in _NO_TRAFFIC:
            moved = 0
        elif packet in _WRITE_ONLY:
            moved = _bytes(_tensors(args[1:])) + _bytes(outs)
        elif packet in _GATHERS:
            idx = [t for t in _tensors((args[1:], kwargs))
                   if not t.is_floating_point()]
            moved = _bytes(idx) + 2 * _bytes(outs)
        else:
            moved = _bytes(_tensors((args, kwargs)) + outs)
        self.bytes += self.scale * moved
        if not func.is_view:
            arg_ids = {id(t.untyped_storage()) for t in _tensors(args)}
            for t in outs:
                if id(t.untyped_storage()) not in arg_ids:
                    self._track(t)
        return out


class _Phase:
    """One stretch of a step counted ``scale`` times (the kernels' tally
    too); memory is tracked once, whatever the scale."""

    def __init__(self, counter: _Counter, kernels: dict, scale: int = 1):
        self.counter, self.kernels, self.scale = counter, kernels, scale

    def __enter__(self):
        self.counter.scale = self.scale
        self.tally = runtime.WorkTally()
        self._ctx = runtime.tally_work(self.tally)
        self._ctx.__enter__()
        self.counter.__enter__()
        return self

    def __exit__(self, *exc):
        self.counter.__exit__(*exc)
        self._ctx.__exit__(*exc)
        self.counter.scale = 1
        for name, w in self.tally.by_kernel.items():
            k = self.kernels.setdefault(name, runtime.KernelWork())
            k.calls += self.scale * w.calls
            k.lookups += self.scale * w.lookups
            k.flops += self.scale * w.flops
            k.bytes += self.scale * w.bytes
        return False


def count_step(bundle) -> CellCost:
    """Counts one step of ``bundle``: :func:`count_with_outputs`'s cost."""
    return count_with_outputs(bundle)[0]


def count_with_outputs(bundle) -> tuple[CellCost, tuple]:
    """Counts one step of ``bundle`` (``launch/specs.py``) on its ``meta``
    arguments, on a mesh of one device.

    FLOPs are the ATen matmul/conv FLOPs plus the kernels' (``flash_attention``,
    ``err_matmul``, ``wkv``, the EXACT integer GEMM); lookups are the LUT
    kernels'; bytes are every ATen op's (see ``_Counter``) plus every
    kernel's operands and results. ``arg_bytes`` are the arguments' bytes.
    ``peak_memory`` is ``arg_bytes`` plus the most bytes that storages
    created during the step held at once, an op at a time: a live-bytes
    estimate of one step run op by op as PyTorch runs it (the allocator's
    rounding and fragmentation are not in it). A training step of ``n``
    microbatches (all of one shape) counts :meth:`TrainStep.micro` once
    and multiplies its counts by ``n``. ``coll_bytes`` is 0: one device
    has no collectives. For a :class:`StepBundle`, ``min_bytes`` and
    ``model_flops`` give the algorithmic floor (``CellCost.step_time_min``);
    any other ``fn`` and ``args`` leave them 0. Returns the cost and the
    step's (``meta``) outputs."""
    from repro_torch.launch.specs import StepBundle, TrainStep
    counter = _Counter()
    kernels: dict = {}
    args = bundle.args
    fn = bundle.fn
    if isinstance(fn, TrainStep) and fn.n_micro > 1:
        from repro_torch.launch.specs import _check_runnable
        _check_runnable(fn.mesh)
        params, opt_state, *batch = args
        mb = batch[0].shape[0] // fn.n_micro
        with _Phase(counter, kernels):
            st = fn.begin(params)
        micro = [t[:mb] for t in batch]
        with _Phase(counter, kernels, scale=fn.n_micro):
            fn.micro(st, *micro)
        with _Phase(counter, kernels):
            out = fn.end(st, opt_state, params)
        del st, micro
    else:
        with _Phase(counter, kernels):
            out = fn(*args)
    arg_bytes = tree_bytes(list(args))
    floor = {}
    if isinstance(bundle, StepBundle):
        floor = dict(min_bytes=algorithmic_bytes(bundle, out),
                     model_flops=model_flops(bundle.cfg, bundle.shape, 1))
    return CellCost(
        flops=counter.flops + sum(k.flops for k in kernels.values()),
        bytes_accessed=counter.bytes + sum(k.bytes for k in kernels.values()),
        coll_bytes=0.0, coll_breakdown={},
        peak_memory=arg_bytes + counter.peak, arg_bytes=arg_bytes,
        lookups=sum(k.lookups for k in kernels.values()),
        kernels={n: dataclasses.asdict(k) for n, k in sorted(kernels.items())},
        **floor), out


def spec_bytes(tree, specs, mesh) -> float:
    """Per-device bytes of a tree of ``meta`` tensors laid out by a tree of
    partition specs over ``mesh``: each dim divided by the product of its
    mesh axes (the planner only shards dims those products divide)."""
    total = 0.0
    for t, sp in zip(leaves(tree), leaves(specs)):
        n = t.numel() * t.element_size()
        for part in sp:
            if part is not None:
                for a in ((part,) if isinstance(part, str) else part):
                    n /= mesh.shape[a]
        total += n
    return total


def per_device_arg_bytes(bundle) -> float:
    """A step's argument bytes on each device of its mesh."""
    return sum(spec_bytes(a, s, bundle.mesh)
               for a, s in zip(bundle.args, bundle.specs))
