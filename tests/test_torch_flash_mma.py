"""Kernel 11's schedule and tensor-core arithmetic on the CPU.

``csrc/flash_attention.cu`` runs QK and PV as split-TF32 ``mma.sync``
products on a plan made in Python (``kernels/flash_attention/ops.py:
flash_plan``): items of (KV row with its query heads, q tile), heaviest
first, each walking KV tiles from the first that any of its rows can see
to the causal bound.

* The plan covers every (query row, q tile) once, heaviest first, each
  item's KV range as stated; skipping the leading tiles that a window
  masks whole gives ``flash_attention_ref``'s output bit for bit (the
  first visible tile's ``alpha = exp(-1e30 - m')`` is exactly 0).
* ``flash_attention_tf32_ref``, the emulation of the kernel's split sums
  (``kernels/err_matmul/ref.py: tf32_split``; two products for bfloat16 K
  and V, 3xTF32 for float32), lies within ``flash_tolerance`` of the JAX
  reference's ``flash_attention_kernel`` in interpret mode: Hq 4 over Hkv
  2, D 64 and 128, S 256-512, window, softcap 50, bfloat16 and float32,
  unit and 10x scores. One plain TF32 pass (the lo terms dropped) lies
  beyond it.
* Every plan's shared memory fits ``SMEM_LIMIT``.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    FLASH_KV_TILE, FLASH_MAX_ROWS, SMEM_LIMIT, flash_plan, flash_shape,
    flash_smem)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref, flash_attention_tf32_ref, flash_tolerance)
from test_torch_parity import load_reference  # noqa: E402

PLANS = [  # bh, sq, sk, rep, causal, window, d, itemsize
    (4, 512, 512, 2, True, 64, 128, 2),
    (4, 300, 300, 2, True, 100, 128, 4),
    (9, 129, 129, 3, True, None, 64, 2),
    (4, 70, 200, 1, True, 64, 128, 4),
    (4, 64, 64, 2, False, None, 64, 2),
    (8, 1, 33, 4, True, None, 64, 2),
    (4, 200, 60, 2, True, 16, 64, 4),       # rows that see no key at all
    (6, 256, 256, 3, False, 40, 64, 2),
]


def _visible(i: int, sk: int, causal: bool, window):
    """[lo, hi] of the keys row i sees (empty when lo > hi)."""
    hi = min(i, sk - 1) if causal else sk - 1
    lo = 0 if window is None else max(0, i - window + 1)
    return lo, hi


@pytest.mark.parametrize("args", PLANS, ids=[str(p[:6]) for p in PLANS])
def test_plan_covers_rows_once_heaviest_first(args):
    """Every (query row, q tile) belongs to exactly one item; the items'
    rows share a KV row; items run heaviest first; each item starts at
    the first tile any of its rows sees (tile 0 where a row sees none)
    and ends at the tile of its last row's own key (causal) or at the
    last tile."""
    bh, sq, sk, rep, causal, window, d, itemsize = args
    plan = flash_plan(bh, sq, sk, rep, causal, window, d, itemsize)
    bk = FLASH_KV_TILE
    n_kv = -(-sk // bk)
    assert plan.bq % 16 == 0 and plan.warps * 16 <= FLASH_MAX_ROWS
    assert rep % plan.heads == 0
    seen = {}
    weights = []
    for b0, q0, first, end in plan.items:
        assert b0 % plan.heads == 0 and q0 % plan.bq == 0
        for b in range(b0, b0 + plan.heads):
            assert b // rep == b0 // rep
            seen[(b, q0)] = seen.get((b, q0), 0) + 1
        rows = range(q0, min(q0 + plan.bq, sq))
        vis = [_visible(i, sk, causal, window) for i in rows]
        want_end = min(n_kv, rows[-1] // bk + 1) if causal else n_kv
        if all(lo <= hi for lo, hi in vis):
            want_first = min(min(lo for lo, _ in vis) // bk, want_end)
        else:
            want_first = 0
        assert (first, end) == (want_first, want_end)
        weights.append(end - first)
    assert seen == {(b, q0): 1 for b in range(bh)
                    for q0 in range(0, sq, plan.bq)}
    assert weights == sorted(weights, reverse=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_skipping_masked_tiles_is_exact(dtype):
    """A window of 64 over 512 keys: walking each q tile from the plan's
    first tile gives the plain version's output bit for bit, although
    most tiles skip the keys before their window."""
    g = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn((n, 512, 64), generator=g).to(dtype)
               for n in (4, 2, 2))
    plan = flash_plan(4, 512, 512, 2, True, 64, 64, k.element_size())
    first, _ = plan.kv_range()
    assert sum(f > 0 for f in first) >= len(first) // 2
    kw = dict(causal=True, window=64, softcap=50.0, rep=2, bq=plan.bq)
    got = flash_attention_ref(q, k, v, kv_range=plan.kv_range(), **kw)
    assert torch.equal(got, flash_attention_ref(q, k, v, **kw))


CASES = [  # label, d, s, window, softcap, dtype, q times
    ("bf16 d128 window x1", 128, 512, 64, 50.0, "bfloat16", 1.0),
    ("bf16 d64 global x10", 64, 256, None, 50.0, "bfloat16", 10.0),
    ("f32 d128 window x10", 128, 256, 100, 50.0, "float32", 10.0),
    ("f32 d64 global x1", 64, 512, None, None, "float32", 1.0),
    ("f32 d64 window softcap x1", 64, 384, 128, 50.0, "float32", 1.0),
]


@pytest.fixture(scope="module")
def reference_outputs():
    """The JAX reference's interpret-mode ``flash_attention_kernel`` on
    each case's numpy inputs (Hq 4 over Hkv 2, one batch row), with the
    inputs as torch tensors."""
    load_reference()
    import jax.numpy as jnp
    import repro.kernels.flash_attention.kernel as jkernel
    out = {}
    for i, (label, d, s, window, cap, dtype, qmul) in enumerate(CASES):
        rng = np.random.default_rng(100 + i)
        q = (rng.normal(size=(4, s, d)) * qmul).astype(np.float32)
        k, v = (rng.normal(size=(2, s, d)).astype(np.float32)
                for _ in range(2))
        jq, jk, jv = (jnp.asarray(a, jnp.dtype(dtype)) for a in (q, k, v))
        want = jkernel.flash_attention_kernel(
            jq, jk, jv, causal=True, window=window, softcap=cap, bq=128,
            bk=128, rep=2, interpret=True)
        tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            getattr(torch, dtype)) for a in (jq, jk, jv))
        out[label] = (tq, tk, tv, torch.from_numpy(
            np.array(want.astype(jnp.float32))).to(getattr(torch, dtype)))
    return out


def _share_of_tolerance(case, inputs, passes=None):
    label, _, _, window, cap, _, _ = case
    q, k, v, want = inputs[label]
    kw = dict(causal=True, window=window, softcap=cap, rep=2)
    got = flash_attention_tf32_ref(q, k, v, passes=passes, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = flash_tolerance(q, k, v, want, **kw)
    return float(((got.double() - want.double()).abs() / tol).max())


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_tf32_within_tolerance(reference_outputs, case):
    """The kernel's split sums (2 products at bfloat16 K and V, 3xTF32 at
    float32), emulated, against the reference kernel: every element
    within ``flash_tolerance``."""
    assert _share_of_tolerance(case, reference_outputs) <= 1.0


def test_one_plain_tf32_pass_is_not_enough(reference_outputs):
    """With the lo terms dropped (one plain TF32 pass, 11 significant
    bits a factor), the float32 cases lie beyond the tolerance; the
    bfloat16 outputs' own rounding hides it."""
    shares = {c[0]: _share_of_tolerance(c, reference_outputs, passes=1)
              for c in CASES if c[5] == "float32"}
    assert max(shares.values()) > 10.0, shares


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
def test_shared_memory_fits(d, itemsize):
    """Every item shape fits one block's shared memory, at most 8 warps;
    all of a KV row's query heads share an item up to rep 8 at bfloat16
    (the served models' rep is 2 and 3)."""
    for rep in range(1, 13):
        heads, bq = flash_shape(rep, d, itemsize)
        rows = heads * bq
        assert rep % heads == 0 and rows <= FLASH_MAX_ROWS
        assert flash_smem(d, itemsize, rows) <= SMEM_LIMIT
        if itemsize == 2 and rep <= 8:
            assert heads == rep
