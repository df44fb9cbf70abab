"""Each kernel module of the port against the JAX reference on the CPU.

On a CPU tensor a wrapper runs its kernel's plain PyTorch version, so these
tests hold that version (and the wrapper's shape handling) against the
reference's Pallas kernel in interpret mode, bitwise: K not a multiple of
128, N below 128, stride 2, 1x1 VALID, dilation, asymmetric padding,
channel counts that are not multiples of 32, the raw int32 accumulator
(``emit_acc``), and a biased table (``M[0, x] != 0``) under which padded
and out-of-image entries are not free. The CUDA kernels themselves are
held against the same plain versions by the tests marked ``cuda``
(skipped without a card) and by ``chip_smoke.py``.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (ApproxConfig, acu_operand, build_lut,  # noqa: E402
                              get_multiplier, make_acu, quantize,
                              symmetric_qparams)
from repro_torch.core.acu import resolve_conv_padding  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.kernels.fused_lut_conv.ops import (  # noqa: E402
    conv_out_size, fused_lut_conv, fused_lut_conv_bwd_w)
from repro_torch.kernels.fused_lut_conv.ref import (  # noqa: E402
    fused_lut_conv_bwd_w_ref, fused_lut_conv_ref)
from repro_torch.kernels.fused_lut_dense.ops import (  # noqa: E402
    fused_lut_bwd, fused_lut_dense)
from repro_torch.kernels.fused_lut_dense.ref import (  # noqa: E402
    fused_lut_bwd_ref, fused_lut_dense_ref)
from repro_torch.kernels.lut_matmul.ops import lut_matmul  # noqa: E402
from repro_torch.kernels.lut_matmul.ref import lut_matmul_ref  # noqa: E402
from test_torch_parity import load_reference  # noqa: E402

MULT = "mul8s_1L2H"
LUT = build_lut(get_multiplier(MULT))
OFF = 128
# exact product + 7: M[0, x] = 7, so every padded K entry and every
# out-of-image tap adds 7 to an accumulator (the reference's _BIASED_LUT)
_V = np.arange(-128, 128, dtype=np.int32)
BIASED_LUT = (_V[:, None] * _V[None, :] + 7).astype(np.int32)
TABLES = {"mul8s_1L2H": LUT, "biased": BIASED_LUT}


@pytest.fixture(scope="module")
def ref():
    load_reference()
    import repro.kernels.fused_lut_conv.ops as conv_ops
    import repro.kernels.fused_lut_dense.ops as dense_ops
    import repro.kernels.lut_matmul.ops as mm_ops
    return mm_ops, dense_ops, conv_ops


@pytest.fixture
def cuda():
    """Skips the test unless a CUDA device is present (decided at run
    time, never at collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU has only the plain versions")
    return torch.device("cuda")


def _codes(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int32)


@pytest.mark.parametrize("mkn", [(5, 27, 16), (40, 144, 10), (7, 130, 33)])
def test_lut_matmul_matches_reference(ref, mkn):
    import jax.numpy as jnp
    m, k, n = mkn
    rng = np.random.default_rng(m)
    a, w = _codes(rng, (m, k)), _codes(rng, (k, n))
    want = np.asarray(ref[0].lut_matmul(jnp.asarray(a), jnp.asarray(w),
                                        jnp.asarray(LUT), OFF))
    got = lut_matmul(torch.from_numpy(a), torch.from_numpy(w),
                     torch.from_numpy(LUT), OFF)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    # chunking over rows and K is invisible in the int32 sum
    tiny = lut_matmul_ref(torch.from_numpy(a), torch.from_numpy(w),
                          torch.from_numpy(LUT).reshape(-1), OFF, 256,
                          k_chunk=3)
    assert np.array_equal(tiny.numpy(), want)


@pytest.mark.parametrize("mkn", [(6, 27, 16), (33, 64, 10), (4, 200, 130)])
@pytest.mark.parametrize("emit_acc", [False, True])
def test_fused_lut_dense_matches_reference(ref, mkn, emit_acc):
    import jax.numpy as jnp
    m, k, n = mkn
    rng = np.random.default_rng(k)
    x = (rng.normal(size=(m, k)) * 2).astype(np.float32)
    wq = _codes(rng, (k, n))
    xs = np.float32(np.abs(x).max() / 127)
    ws = rng.uniform(0.01, 0.1, n).astype(np.float32)
    want = np.asarray(ref[1].fused_lut_dense(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(LUT), OFF, xs,
        np.float32(0), jnp.asarray(ws), emit_acc=emit_acc))
    got = fused_lut_dense(torch.from_numpy(x), torch.from_numpy(wq),
                          torch.from_numpy(LUT), OFF, torch.tensor(xs),
                          torch.tensor(0.0), torch.from_numpy(ws),
                          emit_acc=emit_acc)
    assert np.array_equal(got.numpy(), want)


CONV_GEOMS = [  # (x_shape, w_shape, stride, padding, dilation)
    ((2, 3, 8, 8), (5, 3, 3, 3), (1, 1), "SAME", (1, 1)),      # stem-like
    ((1, 6, 9, 9), (4, 6, 3, 3), (2, 2), "SAME", (1, 1)),      # stride 2
    ((2, 5, 8, 8), (7, 5, 1, 1), (2, 2), "VALID", (1, 1)),     # 1x1 shortcut
    ((1, 40, 6, 6), (3, 40, 3, 3), (1, 1), "SAME", (1, 1)),    # C=40
    ((1, 4, 10, 10), (6, 4, 3, 3), (1, 1), "SAME", (2, 2)),    # dilation 2
]


@pytest.mark.parametrize("geom", CONV_GEOMS,
                         ids=["stem", "stride2", "shortcut1x1", "c40",
                              "dilation2"])
def test_fused_lut_conv_matches_reference(ref, geom):
    import jax.numpy as jnp
    xs_, ws_, stride, padding, dilation = geom
    rng = np.random.default_rng(sum(xs_))
    x = rng.normal(size=xs_).astype(np.float32)
    w = rng.normal(size=ws_).astype(np.float32)
    xqp = symmetric_qparams(torch.tensor(np.abs(x).max()), 8)
    wqp = symmetric_qparams(torch.from_numpy(np.abs(w).max(axis=(1, 2, 3))),
                            8, axis=0)
    wq = acu_operand(quantize(torch.from_numpy(w), wqp), wqp)
    pad = resolve_conv_padding(padding, xs_, ws_, stride, dilation)
    args = (xqp.scale.numpy(), np.float32(0), wqp.scale.numpy())
    for emit_acc in (False, True):
        want = np.asarray(ref[2].fused_lut_conv(
            jnp.asarray(x), jnp.asarray(wq.numpy()), jnp.asarray(LUT), OFF,
            *args, stride=stride, padding=pad, dilation=dilation,
            emit_acc=emit_acc))
        got = fused_lut_conv(torch.from_numpy(x), wq, torch.from_numpy(LUT),
                             OFF, xqp.scale, torch.tensor(0.0), wqp.scale,
                             stride=stride, padding=pad, dilation=dilation,
                             emit_acc=emit_acc)
        assert got.shape == want.shape
        assert np.array_equal(got.numpy(), want), emit_acc


def _sym_scale(v: np.ndarray) -> np.float32:
    from repro_torch.core import inline_symmetric_scale
    return np.float32(inline_symmetric_scale(
        torch.tensor(np.abs(v).max()), 8).item())


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("mkn", [(5, 10, 64), (64, 128, 10), (37, 130, 33)],
                         ids=["head_gx", "head_gw", "ragged"])
def test_fused_lut_bwd_matches_reference(ref, mkn, table):
    """Both float operands quantized symmetric in-kernel, f32 and int32
    outputs, ragged M/K/N (the reference pads K to 128 and corrects
    ``k_pad * LUT[off, off]``; the port pads nothing)."""
    import jax.numpy as jnp
    m, k, n = mkn
    lut = TABLES[table]
    rng = np.random.default_rng(m * k + n)
    a = (rng.normal(size=(m, k)) * 3).astype(np.float32)
    b = (rng.normal(size=(k, n)) * 0.01).astype(np.float32)
    sa, sb = _sym_scale(a), _sym_scale(b)
    for emit_acc in (False, True):
        want = np.asarray(ref[1].fused_lut_bwd(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(lut), OFF, sa, sb,
            emit_acc=emit_acc))
        got = fused_lut_bwd(torch.from_numpy(a), torch.from_numpy(b),
                            torch.from_numpy(lut), OFF, torch.tensor(sa),
                            torch.tensor(sb), emit_acc=emit_acc)
        assert got.dtype == (torch.int32 if emit_acc else torch.float32)
        assert np.array_equal(got.numpy(), want), emit_acc


BWD_W_GEOMS = [  # the reference's own: (n, c, h, w, cout, ksize, stride,
    # dilation, padding), stride, dilation and asymmetric padding
    (2, 3, 9, 11, 5, (3, 3), (1, 1), (1, 1), ((1, 1), (1, 1))),
    (1, 4, 12, 10, 7, (3, 2), (2, 1), (1, 2), ((0, 0), (1, 0))),
    (2, 2, 8, 8, 3, (2, 2), (2, 2), (1, 1), ((0, 0), (0, 0))),
    (1, 5, 14, 9, 6, (3, 3), (1, 2), (2, 1), ((2, 2), (1, 1))),
]


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("geom", BWD_W_GEOMS,
                         ids=["same3x3", "rect_dil", "valid2x2", "pad2"])
def test_fused_lut_conv_bwd_w_matches_reference(ref, geom, table):
    """The weight-gradient plain version (im2col of codes, pads code 0)
    against the reference's banded kernel, bitwise on the int32 (kh*kw, C,
    Cout) accumulator; under the biased table every out-of-image tap adds
    ``LUT[off, qg + off] != 0``."""
    import jax.numpy as jnp
    n, c, h, w, cout, ksize, stride, dil, pad = geom
    lut = TABLES[table]
    rng = np.random.default_rng(sum(ksize) + n + c + h)
    x = rng.standard_normal((n, c, h, w)).astype(np.float32)
    ho = conv_out_size(h, ksize[0], stride[0], dil[0], pad[0])
    wo = conv_out_size(w, ksize[1], stride[1], dil[1], pad[1])
    g = rng.standard_normal((n, ho, wo, cout)).astype(np.float32)
    sx, sg = _sym_scale(x), _sym_scale(g)
    want = np.asarray(ref[2].fused_lut_conv_bwd_w(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(lut), OFF, sx, sg,
        ksize=ksize, stride=stride, padding=pad, dilation=dil))
    got = fused_lut_conv_bwd_w(torch.from_numpy(x), torch.from_numpy(g),
                               torch.from_numpy(lut), OFF, torch.tensor(sx),
                               torch.tensor(sg), ksize=ksize, stride=stride,
                               padding=pad, dilation=dil)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


def test_conv_geometry_helpers_match_reference(ref):
    from repro_torch.kernels.fused_lut_conv.ops import (conv_out_size,
                                                        conv_padded_geometry)
    for args in [(32, 3, 1, 1, (1, 1)), (32, 3, 2, 1, (0, 1)),
                 (16, 1, 2, 1, (0, 0)), (10, 3, 1, 2, (2, 2))]:
        assert conv_out_size(*args) == ref[2].conv_out_size(*args)
    g = (13, 11, 3, 3, 2, 1, 1, 2, ((1, 1), (2, 2)), 4)
    assert conv_padded_geometry(*g) == ref[2].conv_padded_geometry(*g)


# ---------------------------------------------------------------------------
# build helpers (CPU) and the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------

def test_source_hash_tracks_sources_and_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text("// a")
    (tmp_path / "h.cuh").write_text("// h")
    monkeypatch.setattr(runtime, "CSRC", tmp_path)
    h0 = runtime.source_hash("k")
    (tmp_path / "h.cuh").write_text("// h2")
    h1 = runtime.source_hash("k")
    (tmp_path / "k.cu").write_text("// b")
    assert len({h0, h1, runtime.source_hash("k")}) == 3
    assert runtime.library_path("k").name == f"k-{runtime.source_hash('k')}.so"


def test_every_kernel_source_has_a_signature():
    names = {p.stem for p in runtime.CSRC.glob("*.cu")}
    assert names == set(runtime.SIGNATURES) == {
        "lut_matmul", "fused_lut_dense", "fused_lut_conv", "fused_lut_bwd",
        "fused_lut_conv_bwd_w"}


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        runtime.nvcc_path()


def test_cpu_tensors_never_launch():
    ops = (lut_matmul, fused_lut_dense, fused_lut_conv, fused_lut_bwd,
           fused_lut_conv_bwd_w)
    before = [op.launches for op in ops]
    cfg = ApproxConfig(acu=make_acu(MULT, "lut", use_kernels=True,
                                    fused=True), approx_bwd=True)
    from repro_torch.core import approx_dense, conv2d
    x = torch.randn(1, 3, 6, 6, requires_grad=True)
    w = torch.randn(4, 3, 3, 3, requires_grad=True)
    y = conv2d(x, w, cfg=cfg)
    approx_dense(y.mean(dim=(2, 3)), torch.randn(4, 2, requires_grad=True),
                 None, cfg).sum().backward()
    assert x.grad is not None and w.grad is not None
    assert [op.launches for op in ops] == before


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(cuda):
    """On a card: each kernel launches (its counter rises) and equals its
    plain version bitwise, f32 and int32 outputs."""
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    l16 = runtime.lut_to_int16(torch.from_numpy(LUT)).to(cuda)
    l32 = torch.from_numpy(LUT).reshape(-1).to(cuda)
    a = torch.randint(-128, 128, (300, 27), generator=g, device=cuda,
                      dtype=torch.int32)
    w = torch.randint(-128, 128, (27, 16), generator=g, device=cuda,
                      dtype=torch.int32)
    n0 = lut_matmul.launches
    assert torch.equal(lut_matmul(a, w, l16, OFF),
                       lut_matmul_ref(a, w, l32, OFF, 256))
    assert lut_matmul.launches == n0 + 1
    # one output tile, long K: the K split with int32 atomics
    ag = torch.randint(-128, 128, (144, 20000), generator=g, device=cuda,
                       dtype=torch.int32)
    wg = torch.randint(-128, 128, (20000, 16), generator=g, device=cuda,
                       dtype=torch.int32)
    assert torch.equal(lut_matmul(ag, wg, l16, OFF),
                       lut_matmul_ref(ag, wg, l32, OFF, 256))
    x = torch.randn((300, 27), generator=g, device=cuda)
    xs, xz = torch.tensor(0.02, device=cuda), torch.tensor(0.0, device=cuda)
    ws = torch.rand(16, generator=g, device=cuda)
    for emit in (False, True):
        assert torch.equal(
            fused_lut_dense(x, w, l16, OFF, xs, xz, ws, emit_acc=emit),
            fused_lut_dense_ref(x, w, l32, OFF, 256, xs, xz, ws,
                                emit_acc=emit))
    img = torch.randn((2, 16, 9, 9), generator=g, device=cuda)
    wq = torch.randint(-128, 128, (8, 16, 3, 3), generator=g, device=cuda,
                       dtype=torch.int32)
    ws8 = torch.rand(8, generator=g, device=cuda)
    for emit in (False, True):
        kw = dict(stride=(2, 2), padding=((0, 1), (0, 1)), emit_acc=emit)
        assert torch.equal(
            fused_lut_conv(img, wq, l16, OFF, xs, xz, ws8, **kw),
            fused_lut_conv_ref(img, wq, l32, OFF, 256, xs, xz, ws8, **kw))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("table", sorted(TABLES))
def test_cuda_backward_kernels_match_plain_versions(cuda, table):
    """On a card: fused_lut_bwd (f32 and emit_acc) and fused_lut_conv_bwd_w
    launch and equal their plain versions bitwise, at two shapes each."""
    g = torch.Generator(device=cuda)
    g.manual_seed(1)
    lut = torch.from_numpy(TABLES[table])
    l16 = runtime.lut_to_int16(lut).to(cuda)
    l32 = lut.reshape(-1).to(cuda)
    for m, k, n in ((128, 10, 64), (2000, 16, 144)):
        a = torch.randn((m, k), generator=g, device=cuda)
        b = torch.randn((k, n), generator=g, device=cuda) * 0.01
        sa = a.abs().amax() / 127
        sb = b.abs().amax() / 127
        for emit in (False, True):
            n0 = fused_lut_bwd.launches
            assert torch.equal(
                fused_lut_bwd(a, b, l16, OFF, sa, sb, emit_acc=emit),
                fused_lut_bwd_ref(a, b, l32, OFF, 256, sa, sb,
                                  emit_acc=emit))
            assert fused_lut_bwd.launches == n0 + 1
    for n, c, hw, cout, k, s, pad in ((4, 16, 32, 16, 3, 1, ((1, 1),) * 2),
                                      (3, 32, 16, 64, 3, 2, ((0, 1),) * 2)):
        x = torch.randn((n, c, hw, hw), generator=g, device=cuda)
        ho = conv_out_size(hw, k, s, 1, pad[0])
        gr = torch.randn((n, ho, ho, cout), generator=g, device=cuda)
        sx, sg = x.abs().amax() / 127, gr.abs().amax() / 127
        kw = dict(ksize=(k, k), stride=(s, s), padding=pad)
        n0 = fused_lut_conv_bwd_w.launches
        assert torch.equal(
            fused_lut_conv_bwd_w(x, gr, l16, OFF, sx, sg, **kw),
            fused_lut_conv_bwd_w_ref(x, gr, l32, OFF, 256, sx, sg, **kw))
        assert fused_lut_conv_bwd_w.launches == n0 + 1
    torch.cuda.synchronize()
