"""The port's roofline (``launch/roofline.py``), the kernels' ``meta``
shape rules and the dry-run (``launch/dryrun.py``) on the CPU.

Against the JAX reference (loaded in fixtures and test bodies only):
``two_point``, the terms, ``bottleneck`` and ``step_time`` on the H100
constants (the reference's ``CellCost`` with its module constants set to
the port's), ``model_flops`` and ``recurrence_correction`` for every arch
x shape x device count — all equal, as they are arithmetic on the same
configs. The mirrors of ``tests/test_roofline.py`` cover the cases that
parse no HLO.

Each kernel's ``meta`` shape rule must give the shapes and dtypes that its
plain version gives on the CPU at a small size, and report the work it
stands for: lookups M·K·N for the LUT GEMMs (kernels 1, 3, 4, 10), 2·D
per visible (query, key) pair for kernels 8 and 9, FLOPs for 11, 12, 13
and the EXACT integer GEMM, and bytes for all. The counter itself is held
on a step of one matmul, where every count is known, and the dry-run runs
in-process on ``meta``: no device, no 512-device subprocess.
"""
from __future__ import annotations

import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import (ARCH_NAMES, SHAPES, get_config,  # noqa: E402
                                 reduced_config)
from repro_torch.core import make_acu  # noqa: E402
from repro_torch.core.acu import int_matmul  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.kernels.err_matmul.ops import err_matmul  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    approx_flash_attention, approx_flash_attention_paged, flash_attention)
from repro_torch.kernels.fused_lut_dense.ops import (  # noqa: E402
    fused_lut_bwd, fused_lut_dense)
from repro_torch.kernels.fused_lut_grouped.ops import (  # noqa: E402
    fused_lut_grouped)
from repro_torch.kernels.lut_matmul.ops import lut_matmul  # noqa: E402
from repro_torch.kernels.quantize.ops import quantize  # noqa: E402
from repro_torch.kernels.wkv.ops import wkv  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.roofline import (CellCost, model_flops,  # noqa: E402
                                         recurrence_correction, two_point)

H100 = {"PEAK_BF16": roofline.PEAK_BF16, "HBM_BW": roofline.HBM_BW,
        "ICI_BW": roofline.NVLINK_BW}


@pytest.fixture(scope="module")
def ref():
    from test_torch_parity import load_reference
    load_reference()
    import repro.configs as RC
    import repro.launch.roofline as RR
    return SimpleNamespace(configs=RC, roofline=RR)


def make_cost(flops, by, coll, cls=CellCost):
    return cls(flops=flops, bytes_accessed=by, coll_bytes=coll,
               coll_breakdown={"all-reduce": coll}, peak_memory=1e9,
               arg_bytes=5e8)


# --------------------------------------------------------------------------
# tests/test_roofline.py's cases that parse no HLO, and parity
# --------------------------------------------------------------------------

def test_two_point_scaling():
    u1 = make_cost(100.0, 1000.0, 10.0)   # outside + 1 group
    u2 = make_cost(160.0, 1500.0, 14.0)   # outside + 2 groups
    total = two_point(u1, u2, n_groups=10)
    assert total.flops == 100 + 9 * 60
    assert total.bytes_accessed == 1000 + 9 * 500
    assert total.coll_bytes == 10 + 9 * 4
    assert total.peak_memory == u1.peak_memory


def test_bottleneck_and_terms():
    """The terms on the H100's data-sheet peaks; the lookup term joins
    ``t_compute``."""
    c = make_cost(989e12 * 0.5, 3.35e12 * 0.1, 900e9 * 0.2)
    assert abs(c.t_compute - 0.5) < 1e-9
    assert abs(c.t_memory - 0.1) < 1e-9
    assert abs(c.t_collective - 0.2) < 1e-9
    assert c.bottleneck == "compute"
    assert c.step_time == c.t_compute
    lut = dataclasses.replace(c, lookups=132 * 32 * 1980e6 * 0.7)
    assert abs(lut.t_compute - 0.7) < 1e-9 and lut.step_time == lut.t_compute
    assert roofline.GATHER_RATE == 132 * 32 * 1980e6


def test_model_flops_dense_vs_moe():
    dense = get_config("qwen2.5-14b")
    moe = get_config("olmoe-1b-7b")
    sh = SHAPES["train_4k"]
    f_dense = model_flops(dense, sh, 256)
    assert abs(f_dense - 6 * dense.n_params() * sh.global_batch
               * sh.seq_len / 256) < 1e6
    f_moe = model_flops(moe, sh, 256)
    assert f_moe < 6 * moe.n_params() * sh.global_batch * sh.seq_len \
        / 256 * 0.5


def test_terms_and_two_point_match_reference(ref, monkeypatch):
    for name, value in H100.items():
        monkeypatch.setattr(ref.roofline, name, value)
    rng = np.random.default_rng(0)
    for _ in range(50):
        f, b, c = (float(x) for x in rng.uniform(0, 1e13, 3))
        mine = make_cost(f, b, c)
        theirs = make_cost(f, b, c, ref.roofline.CellCost)
        for attr in ("t_compute", "t_memory", "t_collective", "bottleneck",
                     "step_time"):
            assert getattr(mine, attr) == getattr(theirs, attr), attr
        f2, b2, c2 = (float(x) for x in rng.uniform(0, 1e13, 3))
        n = int(rng.integers(1, 90))
        mt = two_point(mine, make_cost(f2, b2, c2), n)
        rt = ref.roofline.two_point(
            theirs, make_cost(f2, b2, c2, ref.roofline.CellCost), n)
        assert (mt.flops, mt.bytes_accessed, mt.coll_bytes, mt.coll_breakdown,
                mt.peak_memory, mt.arg_bytes) == \
            (rt.flops, rt.bytes_accessed, rt.coll_bytes, rt.coll_breakdown,
             rt.peak_memory, rt.arg_bytes)


def test_model_flops_and_recurrence_match_reference(ref):
    for arch in ARCH_NAMES:
        cfg, rcfg = get_config(arch), ref.configs.get_config(arch)
        for sname, shape in SHAPES.items():
            rshape = ref.configs.SHAPES[sname]
            for n_dev in (1, 256, 512):
                assert model_flops(cfg, shape, n_dev) == \
                    ref.roofline.model_flops(rcfg, rshape, n_dev)
                assert recurrence_correction(cfg, shape, n_dev) == \
                    ref.roofline.recurrence_correction(rcfg, rshape, n_dev)


# --------------------------------------------------------------------------
# the kernels' meta shape rules
# --------------------------------------------------------------------------

ACU = make_acu("mul8s_1L2H", "lut")
OFF = ACU.offset
LUT = ACU.device_lut("cpu")
N_CODES = ACU.multiplier.n_codes


def _codes(gen, *shape):
    return torch.randint(-8, 8, shape, generator=gen, dtype=torch.int32)


def _meta(tree):
    return [t.to("meta") if isinstance(t, torch.Tensor) else t
            for t in tree]


def _run_both(fn, args, kwargs=None):
    """(CPU result, meta result, the meta call's tally)."""
    kwargs = kwargs or {}
    cpu = fn(*args, **kwargs)
    tally = runtime.WorkTally()
    with runtime.tally_work(tally):
        meta = fn(*_meta(args), **{k: v.to("meta") if isinstance(
            v, torch.Tensor) else v for k, v in kwargs.items()})
    return cpu, meta, tally


def _same_layout(cpu, meta):
    cpu = cpu if isinstance(cpu, tuple) else (cpu,)
    meta = meta if isinstance(meta, tuple) else (meta,)
    assert [(tuple(t.shape), t.dtype) for t in cpu] == \
        [(tuple(t.shape), t.dtype) for t in meta]
    assert all(t.device.type == "meta" for t in meta)


def _work(tally, name):
    (got,) = tally.by_kernel.items()
    assert got[0] == name and got[1].calls == 1
    return got[1]


def test_meta_rule_lut_gemms():
    """Kernels 1, 3 and 4: lookups M·K·N; operands and result bytes."""
    gen = torch.Generator().manual_seed(0)
    M, K, N = 5, 40, 7
    a, w = _codes(gen, M, K), _codes(gen, K, N)
    cpu, meta, t = _run_both(lut_matmul, (a, w, LUT, OFF))
    _same_layout(cpu, meta)
    wk = _work(t, "lut_matmul")
    assert wk.lookups == M * K * N
    assert wk.bytes == (M * K + K * N + M * N) * 4 + N_CODES ** 2 * 2
    x = torch.randn(M, K, generator=gen)
    sx, zx, sw = torch.tensor(0.05), torch.tensor(0.0), torch.full((N,), 0.02)
    for emit in (False, True):
        cpu, meta, t = _run_both(fused_lut_dense, (x, w, LUT, OFF, sx, zx, sw),
                                 {"emit_acc": emit})
        _same_layout(cpu, meta)
        assert _work(t, "fused_lut_dense").lookups == M * K * N
    b = torch.randn(K, N, generator=gen)
    cpu, meta, t = _run_both(fused_lut_bwd, (x, b, LUT, OFF, 0.05, 0.02))
    _same_layout(cpu, meta)
    assert _work(t, "fused_lut_bwd").lookups == M * K * N


def test_meta_rule_quantize_and_grouped():
    """Kernel 2 (bytes only) and kernel 10 (lookups over every capacity
    row: the live counts are data a meta tensor does not hold)."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(6, 10, generator=gen).to(torch.bfloat16)
    s, z = torch.full((1, 10), 0.03), torch.zeros((1, 10))
    cpu, meta, t = _run_both(quantize, (x, s, z))
    _same_layout(cpu, meta)
    assert _work(t, "quantize").bytes == 60 * 2 + 10 * 4 * 2 + 60 * 4
    E, G, C, K, N = 2, 4, 3, 16, 5
    xg = torch.randn(G, C, K, generator=gen)
    wq = _codes(gen, E, K, N)
    counts = torch.tensor([3, 1, 0, 2], dtype=torch.int32)
    cpu, meta, t = _run_both(fused_lut_grouped, (
        xg, wq, LUT, OFF, torch.tensor(0.05), torch.tensor(0.0),
        torch.full((E, N), 0.02), counts))
    _same_layout(cpu, meta)
    assert _work(t, "fused_lut_grouped").lookups == G * C * K * N


@pytest.mark.parametrize("sq,sk,causal,window", [(1, 48, True, None),
                                                 (16, 16, True, None),
                                                 (8, 24, True, 5),
                                                 (4, 12, False, None)])
def test_meta_rule_attention(sq, sk, causal, window):
    """Kernels 8 and 9: 2·D lookups per visible (query, key) pair, the rows
    end-aligned over the whole key sequence; kernel 11: 4·D FLOPs per pair,
    queries aligned to key 0."""
    gen = torch.Generator().manual_seed(2)
    b, hkv, rep, d = 2, 2, 2, 16
    q = torch.randn(b * hkv * rep, sq, d, generator=gen)
    k = torch.randn(b * hkv, sk, d, generator=gen)
    v = torch.randn(b * hkv, sk, d, generator=gen)
    scales = [torch.tensor(x) for x in (0.05, 0.04, 0.03)]
    kw = dict(causal=causal, window=window)

    def pairs(q_start):
        n = 0
        for p in range(q_start, q_start + sq):
            for j in range(sk):
                vis = (j <= p or not causal) and \
                    (window is None or j > p - window)
                n += vis
        return n

    cpu, meta, t = _run_both(approx_flash_attention,
                             (q, k, v, LUT, OFF, *scales), kw)
    _same_layout(cpu, meta)
    assert _work(t, "approx_flash_attention").lookups == \
        2 * d * q.shape[0] * pairs(sk - sq)
    bk = 4 if sk % 4 == 0 else 1
    n_log = sk // bk
    kp = k.reshape(b, hkv, n_log, bk, d).transpose(0, 1).reshape(
        hkv, b * n_log, bk, d).contiguous()
    vp = v.reshape(b, hkv, n_log, bk, d).transpose(0, 1).reshape(
        hkv, b * n_log, bk, d).contiguous()
    rows = q.shape[0]
    pt = torch.stack([torch.arange(n_log, dtype=torch.int32) + (r // (hkv * rep))
                      * n_log for r in range(rows)])
    info = torch.tensor([[sk - sq, 0, sk]] * rows, dtype=torch.int32)
    cpu, meta, t = _run_both(approx_flash_attention_paged,
                             (q, kp, vp, LUT, OFF, *scales),
                             dict(kw, rowinfo=info, page_table=pt, rep=rep))
    _same_layout(cpu, meta)
    assert _work(t, "approx_flash_attention_paged").lookups == \
        2 * d * rows * pairs(sk - sq)
    if sq <= sk:
        cpu, meta, t = _run_both(flash_attention, (q, k, v), kw)
        _same_layout(cpu, meta)
        assert _work(t, "flash_attention").flops == \
            4 * d * q.shape[0] * pairs(0)


def test_meta_rule_wkv_err_matmul_int_mm():
    """Kernel 12 (7·hd² operations per token and head; ``state_out`` is
    returned as given), kernel 13 (2·M·K·N·(r + 1)) and the EXACT integer
    GEMM (2·M·K·N)."""
    gen = torch.Generator().manual_seed(3)
    b, t_, h, hd = 2, 5, 3, 16
    r, k, v = (torch.randn(b, t_, h, hd, generator=gen) for _ in range(3))
    w = torch.rand(b, t_, h, hd, generator=gen)
    u = torch.randn(h, hd, generator=gen)
    s0 = torch.randn(b, h, hd, hd, generator=gen)
    cpu, meta, t = _run_both(wkv, (r, k, v, w, u, s0))
    _same_layout(cpu, meta)
    assert _work(t, "wkv").flops == 7 * b * t_ * h * hd * hd
    st = torch.empty(b, h, hd, hd, device="meta")
    with runtime.tally_work(runtime.WorkTally()):
        _, s_t = wkv(*_meta((r, k, v, w, u, s0)), state_out=st)
    assert s_t is st
    lr = make_acu("mul8s_1L2H", "lowrank", rank=4)
    f, g = lr.device_factors("cpu")
    M, K, N = 6, 20, 9
    a, wc = _codes(gen, M, K), _codes(gen, K, N)
    cpu, meta, t = _run_both(err_matmul, (a, wc, f, g, OFF))
    _same_layout(cpu, meta)
    assert _work(t, "err_matmul").flops == 2 * M * K * N * 5
    cpu, meta, t = _run_both(lambda x, y: int_matmul(x, y, as_int8=True),
                             (a, wc))
    _same_layout(cpu, meta)
    assert _work(t, "int_mm").flops == 2 * M * K * N


def test_meta_rule_counts_nothing_without_a_tally():
    """Outside :func:`runtime.tally_work` a meta call counts nowhere."""
    a = torch.empty(4, 8, dtype=torch.int32, device="meta")
    w = torch.empty(8, 3, dtype=torch.int32, device="meta")
    assert lut_matmul(a, w, LUT.to("meta"), OFF).shape == (4, 3)


# --------------------------------------------------------------------------
# the counter and the dry-run
# --------------------------------------------------------------------------

def test_count_step_one_matmul():
    """A step of one float32 matmul: 2·M·K·N FLOPs, operands read and the
    result written once, peak = arguments + the result."""
    M, K, N = 64, 32, 48
    a = torch.empty(M, K, device="meta")
    b = torch.empty(K, N, device="meta")
    step = SimpleNamespace(fn=lambda x, y: (x.t().t() @ y,), args=(a, b))
    c = roofline.count_step(step)
    assert c.flops == 2 * M * K * N
    assert c.bytes_accessed == (M * K + K * N + M * N) * 4
    assert c.arg_bytes == (M * K + K * N) * 4
    assert c.peak_memory == c.arg_bytes + M * N * 4
    assert c.lookups == 0 and c.kernels == {} and c.coll_bytes == 0
    assert c.t_compute == c.flops / roofline.PEAK_BF16


def test_count_step_microbatches_and_kernels():
    """A training step of n equal microbatches counts one and multiplies;
    an ACU decode step's tally holds kernels 2, 3 and 8."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import build_step, make_acfg
    cfg = reduced_config("smollm-135m")
    sh = ShapeSpec("t", 16, 8, "train")
    b1 = build_step(cfg, sh, make_host_mesh())
    c1 = roofline.count_step(b1)
    b4 = build_step(cfg, sh, make_host_mesh())
    b4.fn.n_micro = 4
    c4 = roofline.count_step(b4)
    # the matmul FLOPs do not depend on the split; the per-microbatch
    # accumulation adds bytes
    assert c4.flops == c1.flops
    assert c4.bytes_accessed > c1.bytes_accessed
    dec = build_step(cfg, ShapeSpec("d", 32, 4, "decode"), make_host_mesh(),
                     acfg=make_acfg("mul8s_1L2H:lut"))
    c = roofline.count_step(dec)
    n_gemm = cfg.n_layers * 7 + 1
    assert {k: v["calls"] for k, v in c.kernels.items()} == {
        "quantize": n_gemm, "fused_lut_dense": n_gemm,
        "approx_flash_attention": cfg.n_layers}
    assert c.lookups == sum(v["lookups"] for v in c.kernels.values()) > 0


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2.5-14b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_algorithmic_floor(arch, kind):
    """``min_bytes`` is the arguments read once plus what the step must
    write (a training step's parameters, optimizer state and loss; a
    prefill's cache, which it does not read, and logits; a decode's
    logits), an untied embedding's rows read only as looked up when
    serving; ``step_time_min`` is the longest of its three terms, lies
    under the eager graph's ``step_time_lb``, and stays put when the
    attention's chunk changes the graph's traffic."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import build_step
    cfg = reduced_config(arch)
    sh = ShapeSpec("x", 64, 4, kind)
    bundle = build_step(cfg, sh, make_host_mesh())
    c, out = roofline.count_with_outputs(bundle)
    size = {n: roofline.tree_bytes(a)
            for n, a in zip(bundle.arg_names, bundle.args)}
    if kind == "train":
        want = sum(size.values()) + size["params"] + size["opt_state"] + 4
    else:                             # (B, padded vocab) float32 logits
        assert out[0].shape[0] == 4 and out[0].dtype == torch.float32
        want = sum(size.values()) + out[0].numel() * 4
        if not cfg.tie_embed:         # 4 or 4 x 64 rows, at most all
            emb = bundle.args[0]["embed"]
            rows = min(4 if kind == "decode" else 4 * 64, emb.shape[0])
            want -= (emb.shape[0] - rows) * emb.shape[1] * emb.element_size()
    assert c.min_bytes == want
    assert c.model_flops == model_flops(cfg, sh, 1) > 0
    assert c.step_time_min == max(c.model_flops / roofline.PEAK_BF16,
                                  c.min_bytes / roofline.HBM_BW)
    assert c.step_time_min < c.step_time
    other = roofline.count_step(build_step(
        dataclasses.replace(cfg, attn_chunk=16), sh, make_host_mesh()))
    if kind != "decode":
        assert other.bytes_accessed != c.bytes_accessed
    assert (other.min_bytes, other.step_time_min) == (c.min_bytes,
                                                      c.step_time_min)


def test_dryrun_main_in_process(tmp_path):
    """``dryrun.main`` on ``meta`` for one cell: the reference's record
    keys; the wkv count replaces ``recurrence_correction``; the production
    meshes record plans with null costs; an ineligible cell is reported,
    not counted, and a variant the port cannot run is refused."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import build_step
    out = tmp_path / "r.json"
    assert dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                        "--out", str(out)]) == 0
    (rec,) = json.loads(out.read_text())
    ref_keys = {"arch", "shape", "variant", "acu", "mesh", "n_devices",
                "kind", "n_groups", "flops", "bytes", "coll_bytes",
                "coll_breakdown", "peak_memory", "arg_bytes", "t_compute",
                "t_memory", "t_collective", "bottleneck", "step_time_lb",
                "model_flops", "useful_ratio", "roofline_frac",
                "memory_analysis", "plan_report", "compile_s"}
    assert {"min_bytes", "t_memory_min", "step_time_min"} <= set(rec)
    assert ref_keys <= set(rec)
    assert set(rec["memory_analysis"]) == {"argument_bytes", "output_bytes",
                                           "temp_bytes", "alias_bytes"}
    assert rec["mesh"] == "1x1" and rec["n_devices"] == 1
    assert rec["flops"] > 0 and rec["bottleneck"] == "memory"
    assert rec["step_time_lb"] == max(rec["t_compute"], rec["t_memory"])

    rw = dryrun.count_cell("rwkv6-3b", "long_500k", verbose=False)
    cfg = get_config("rwkv6-3b")
    assert rw["kernels"]["wkv"]["calls"] == cfg.n_layers
    counted = roofline.count_step(build_step(cfg, SHAPES["long_500k"],
                                             make_host_mesh()))
    assert (rw["flops"], rw["bytes"]) == (counted.flops,
                                          counted.bytes_accessed)

    pods = tmp_path / "p.json"
    assert dryrun.main(["--arch", "smollm-135m", "--shape", "train_4k",
                        "--mesh", "both", "--out", str(pods)]) == 0
    recs = json.loads(pods.read_text())
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    for r in recs:
        assert r["flops"] is None and r["step_time_lb"] is None
        assert r["step_time_min"] is None
        assert "item 16c" in r["note"] and r["plan_report"]
        assert 0 < r["arg_bytes"]
    skip = dryrun.count_cell("smollm-135m", "long_500k")
    assert skip["skipped"].startswith("long_500k skipped")
    # the reference's remat and RWKV-chunk variants set fields the port's
    # models do not read: the command line refuses them
    for v in ("remat_dots", "no_remat", "remat_dots_causal", "rwkv_chunk1k"):
        assert v not in dryrun.VARIANTS
        with pytest.raises(SystemExit):
            dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                         "--variant", v])
