"""Kernel 2's plan on the CPU: which path ``csrc/quantize.cu`` takes for a
geometry (``kernels/quantize/ops.py: quantize_plan``) and a plain mirror
of that path's walk (``kernels/quantize/ref.py: quantize_plan_ref``).

Every weight the served and scored models quantize (rwkv6-3b, granite,
SmolLM-135M, gemma2-27b, ResNet-20) takes a vector path: ``strip`` where
its rows are whole 16-byte vectors, ``flat`` where they are ragged; a
transposed view or a non-unit inner stride takes the strided path. The
mirror walks each plan's blocks, threads, steps and vectors as the kernel
does and reads every operand at the plan's offsets: it writes each output
element exactly once and equals ``quantize_ref`` bit for bit, in float32
and bfloat16, across tails of 1-7 elements and starts off a 16-byte
boundary; a plan with its last vector dropped leaves that vector
unwritten. Kernel 2 uses no shared memory.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.quantize.ops import (  # noqa: E402
    THREADS, quantize_plan)
from repro_torch.kernels.quantize.ref import (  # noqa: E402
    quantize_plan_ref, quantize_ref)

N_SM = 132
DTYPES = (torch.float32, torch.bfloat16)
# ResNet-20's conv weights (Cout, Cin, k, k), quantized per output channel
RESNET_CONVS = [(16, 3, 3, 3), (16, 16, 3, 3), (32, 16, 3, 3),
                (32, 16, 1, 1), (32, 32, 3, 3), (64, 32, 3, 3),
                (64, 32, 1, 1), (64, 64, 3, 3)]


def _weight_shapes():
    """(label, shape, form) of every weight geometry: form 1 a (1, N)
    scale, 0 a (Cout, 1, ...) one, "grouped" the (E, 1, N) one."""
    out = []
    for arch in ("rwkv6-3b", "smollm-135m", "granite-moe-3b-a800m",
                 "gemma2-27b"):
        c = get_config(arch)
        d, f, v = c.d_model, c.d_ff, c.vocab_padded
        q, kv = c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
        shapes = [(d, q), (d, kv), (q, d), (d, f), (f, d), (d, v)]
        if arch == "granite-moe-3b-a800m":
            out += [(f"{arch} experts in", (c.n_experts, d, f), "grouped"),
                    (f"{arch} experts out", (c.n_experts, f, d), "grouped")]
        out += [(f"{arch} {s}", s, 1) for s in dict.fromkeys(shapes)]
    out += [(f"resnet conv {s}", s, 0) for s in RESNET_CONVS]
    out += [("resnet head", (64, 10), 1)]
    return out


WEIGHTS = _weight_shapes()


def _scale_shape(shape, form):
    if form == "grouped":
        return (shape[0], 1, shape[2])
    if form == "tensor":
        return ()
    return tuple(n if i == form else 1 for i, n in enumerate(shape))


def _plan(x, s, z):
    shape = tuple(x.shape)
    align = x.storage_offset() * x.element_size() % 16
    return quantize_plan(shape, x.stride(), s.expand(shape).stride(),
                         z.expand(shape).stride(), x.element_size(), align,
                         N_SM)


def _operands(shape, form, dtype, seed=0):
    """x with a third of its values on half-code boundaries and some past
    the clip, a per-channel scale (powers of two and not) and zero
    point."""
    g = torch.Generator().manual_seed(seed)
    ss = _scale_shape(shape, form)
    s = torch.pow(2.0, -torch.randint(3, 8, ss, generator=g).float())
    s = torch.where(torch.rand(ss, generator=g) < 0.5, s * 1.37, s)
    z = torch.randint(-3, 4, ss, generator=g).float()
    x = torch.randn(shape, generator=g) * 60 * s
    half = (torch.randint(-128, 128, shape, generator=g).float() + 0.5) * s
    pick = torch.rand(shape, generator=g)
    x = torch.where(pick < 0.33, half, x)
    x = torch.where(pick > 0.97, torch.sign(x) * 500 * s, x)
    return x.to(dtype), s, z


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("label,shape,form", WEIGHTS,
                         ids=[w[0] for w in WEIGHTS])
def test_weights_take_a_vector_path(label, shape, form, dtype):
    """Every weight geometry takes the vector path: ``strip`` where its
    rows are whole 16-byte vectors, ``flat`` for a ResNet stem's 27 and
    the head's 10 columns; the strip grid covers the geometry within the
    card's limits."""
    s = torch.ones(_scale_shape(shape, form))
    x = torch.empty(shape, dtype=dtype)
    plan = _plan(x, s, s)
    assert plan.vector
    sizes = [d[0] for d in plan.dims]
    G, R, C = sizes[1:]
    if plan.path == "strip":
        assert C % plan.vec == 0
        assert plan.grid[0] * plan.tx >= C // plan.vec
        assert plan.grid[1] * plan.rows >= R and plan.grid[2] == G
        assert max(plan.grid[1:]) <= 65535 and THREADS % plan.tx == 0
        assert plan.vectors * plan.vec == x.numel()
    else:
        assert shape in ((16, 3, 3, 3), (64, 10))
        assert plan.head == 0 and plan.tail == x.numel() - x.numel() % \
            plan.vec


def test_strided_path_for_what_the_vectors_cannot_read():
    """A transposed view (inner stride 8) and a non-unit inner stride
    take the strided path; so do four merged dims."""
    base = torch.randn((12, 10, 8))
    t = base.reshape(120, 8).t()
    assert _plan(t, torch.ones((8, 1)), torch.zeros(())).path == "strided"
    sl = base[:, 2:7, ::2]
    assert _plan(sl, torch.ones(()), torch.zeros(())).path == "strided"
    x4 = torch.randn((3, 4, 5, 6))[:, :, :, :5]
    s4 = torch.ones((3, 1, 5, 1))
    assert _plan(x4, s4, torch.zeros(())).path == "strided"


CASES = [  # label, shape, form
    ("row scale", (48, 40), 1),
    ("column scale", (48, 40), 0),
    ("grouped", (5, 33, 24), "grouped"),
    ("conv", (16, 16, 3, 3), 0),
    ("stem", (16, 3, 3, 3), 0),
    ("head", (64, 10), 1),
    ("per tensor", (37, 64), "tensor"),
    ("many rows", (2048, 8), 1),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("label,shape,form", CASES, ids=[c[0] for c in CASES])
def test_plan_walk_writes_once_and_matches(label, shape, form, dtype):
    """The mirror of the plan's walk writes every element once and gives
    ``quantize_ref``'s codes bit for bit; both clip edges are reached.
    Two SMs, so that the grid-stride loops and row bands wrap."""
    x, s, z = _operands(shape, form, dtype, seed=len(label))
    shp = tuple(x.shape)
    plan = quantize_plan(shp, x.stride(), s.expand(shp).stride(),
                         z.expand(shp).stride(), x.element_size(), 0, 2)
    assert plan.vector
    codes, writes = quantize_plan_ref(x, s, z, plan)
    want = quantize_ref(x, s, z)
    assert bool((writes == 1).all())
    assert torch.equal(codes, want)
    assert int(want.min()) == -128 and int(want.max()) == 127


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("tail", range(1, 8))
def test_flat_tail_and_misaligned_start(tail, offset, dtype):
    """A per-tensor x of ``k * 8 + tail`` elements that starts ``offset``
    elements past a 16-byte boundary: the flat path's head, whole vectors
    and tail together write every element once, bit for bit."""
    base, s, z = _operands((4096,), "tensor", dtype, seed=tail)
    n = 8 * 61 + tail
    x = base[offset:offset + n]
    plan = _plan(x, s, z)
    vec = 16 // x.element_size()
    head = (-offset) % vec
    if offset == 0 and n % vec == 0:
        assert plan.path == "strip"
    else:
        assert plan.path == "flat"
        assert plan.head == head
        assert plan.tail == head + (n - head) // vec * vec
    codes, writes = quantize_plan_ref(x, s, z, plan)
    assert bool((writes == 1).all())
    assert torch.equal(codes, quantize_ref(x, s, z))


@pytest.mark.parametrize("label,shape,form,offset", [
    ("strip", (48, 40), 1, 0), ("flat ragged", (16, 3, 3, 3), 0, 0),
    ("flat misaligned", (1001,), "tensor", 3)])
def test_dropped_last_vector_is_seen(label, shape, form, offset):
    """The planted fault that ``chip_smoke.py`` runs on the card: the plan
    with its last vector dropped leaves one vector of the output as it was
    (poisoned outside the code range), so the bitwise check fails."""
    x, s, z = _operands((int(torch.tensor(shape).prod()) + offset,)
                        if offset else shape, form, torch.bfloat16)
    if offset:
        x = x[offset:]
    plan = _plan(x, s, z)
    assert plan.vector
    codes, writes = quantize_plan_ref(x, s, z, plan.drop_last_vector())
    assert int((writes == 0).sum()) == plan.vec
    assert not torch.equal(codes, quantize_ref(x, s, z))
    assert int(codes.max()) > 127


@pytest.fixture
def cuda():
    """Skips the test unless a CUDA device is present (decided at run
    time, never at collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU has only the plain version")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_paths_match_plain_version(cuda):
    """On a card: each path of kernel 2 (strip, flat ragged, flat off a
    16-byte boundary, strided) bit for bit against the plain version,
    ``vector_launches`` counting the vector paths, and the plan with its
    last vector dropped caught on a poisoned output."""
    from repro_torch.kernels.quantize import ops
    cases = [((48, 40), 1, 0), ((5, 33, 24), "grouped", 0),
             ((16, 3, 3, 3), 0, 0), ((1001,), "tensor", 3)]
    for shape, form, offset in cases:
        for dtype in DTYPES:
            x, s, z = _operands((int(torch.tensor(shape).prod()) + offset,)
                                if offset else shape, form, dtype)
            x, s, z = (t.to(cuda) for t in (x, s, z))
            x = x[offset:] if offset else x
            plan = _plan(x, s, z)
            v0 = ops.quantize.vector_launches
            got = ops.quantize(x, s, z)
            assert ops.quantize.vector_launches == v0 + 1
            want = quantize_ref(x, s, z)
            assert torch.equal(got, want)
            poison = torch.full(x.shape, 1 << 20, dtype=torch.int32,
                                device=cuda)
            bad = ops.quantize(x, s, z, plan=plan.drop_last_vector(),
                               out=poison)
            assert int((bad != want).sum()) == plan.vec
    t = torch.randn((64, 48), device=cuda).t()
    v0 = ops.quantize.vector_launches
    assert torch.equal(ops.quantize(t, torch.tensor(0.02, device=cuda),
                                    torch.tensor(0.0, device=cuda)),
                       quantize_ref(t, 0.02, 0.0))
    assert ops.quantize.vector_launches == v0
    torch.cuda.synchronize()
