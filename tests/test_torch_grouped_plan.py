"""Kernel 10's work plan (``kernels/fused_lut_grouped/ops.py:
grouped_plan``), the split of its tiles over the blocks
(``ops.split_segments``, the host mirror of the kernel's ``SplitCursor``)
and the plain version that walks it (``ref.fused_lut_grouped_plan_ref``),
on the CPU.

The plan is made from shapes only: tiles of (expert, row tile of packed
live rows, column tile), K in chunks of 32, a ring of cp.async stages. The
kernel splits the tiles' chunks over its persistent blocks from the live
counts, weighted by each tile's live rows. The tests hold, at
granite-moe-3b-a800m's decode and prefill shapes for 132 SMs, with routed
and synthetic counts, that every live (expert, row tile, column tile,
chunk of K) is covered exactly once and no dead one at all, that split
tiles get their workspace slot, and that every block gets the same share of
the cost (no JAX). The plan-walking version is held bitwise against the
reference's interpret-mode ``fused_lut_grouped`` (as
``tests/test_torch_moe.py`` runs it), dequantized and with ``emit_acc``, on
the registry table and a biased one, with empty groups; a split with one K
split dropped must differ.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import build_lut, get_multiplier  # noqa: E402
from repro_torch.kernels.fused_lut_dense.ops import (  # noqa: E402
    SMEM_PER_BLOCK)
from repro_torch.kernels.fused_lut_grouped.ops import (  # noqa: E402
    GROUPED_BK, GroupedPlan, check_grouped_plan, fused_lut_grouped,
    grouped_plan, grouped_smem, split_segments)
from repro_torch.kernels.fused_lut_grouped.ref import (  # noqa: E402
    fused_lut_grouped_plan_ref, fused_lut_grouped_ref, packed_rows)
from test_torch_parity import load_reference  # noqa: E402

N_SM = 132
LUT = build_lut(get_multiplier("mul8s_1L2H"))
_V = np.arange(-128, 128, dtype=np.int32)
BIASED_LUT = (_V[:, None] * _V[None, :] + 7).astype(np.int32)

# granite-moe-3b-a800m (40 experts top-8, d 1536, d_ff 512): nb = 16
# dispatch blocks with capacity 1 (decode, 32 tokens), 2 (prefill 128) and
# 8 (prefill 512); gate/up 1536 -> 512, down 512 -> 1536; bfloat16 and
# float32
GRANITE = [(40, 16, c, t, k, n, xb) for c, t in ((1, 32), (2, 128), (8, 512))
           for k, n in ((1536, 512), (512, 1536)) for xb in (2, 4)]
GRANITE_IDS = [f"C{c}-{k}x{n}-x{xb}" for _, _, c, _, k, n, xb in GRANITE]


def _routed_counts(rng, E, nb, C, tokens, top_k=8):
    """Per (block, expert) live rows of ``tokens`` tokens routed to
    ``top_k`` distinct experts each, clipped at the capacity."""
    cnt = np.zeros((nb, E), np.int64)
    for t in range(tokens):
        cnt[t * nb // tokens, rng.choice(E, top_k, replace=False)] += 1
    return np.minimum(cnt, C).reshape(-1)


def _hold_split(p, counts):
    """Every live tile's chunks in exactly one segment, no dead tile's;
    slot -1 for a whole tile, else the tile; each block's cost within one
    chunk's of the same share. Returns the blocks' costs."""
    offsets, segs = split_segments(p, counts)
    assert len(offsets) == p.grid + 1 and offsets[-1] == len(segs)
    rows = np.clip(np.asarray(counts).reshape(p.nb, p.E), 0, p.C).sum(0)
    tile_rows = np.clip(rows[:, None] - np.arange(p.row_tiles)[None]
                        * p.bm, 0, p.bm)
    unit = np.repeat(np.where(tile_rows > 0, p.alpha + tile_rows, 0)
                     .reshape(-1), p.tiles_n)
    cover = np.zeros((p.n_tiles, p.chunks), np.int32)
    cost = np.zeros(p.grid, np.int64)
    for b in range(p.grid):
        for t, c0, c1, slot in segs[offsets[b]:offsets[b + 1]].tolist():
            assert 0 <= c0 < c1 <= p.chunks and unit[t] > 0
            cover[t, c0:c1] += 1
            cost[b] += (c1 - c0) * unit[t]
            whole = (c0, c1) == (0, p.chunks)
            assert slot == (-1 if whole else t)
    assert (cover[unit > 0] == 1).all() and (cover[unit == 0] == 0).all()
    share = unit.sum() * p.chunks / p.grid
    assert np.abs(cost - share).max() <= unit.max()
    return cost


@pytest.mark.parametrize("shape", GRANITE, ids=GRANITE_IDS)
def test_split_covers_every_live_chunk_once(shape):
    """At granite's shapes on 132 SMs, with routed counts, experts left
    empty and every token on one expert: each live chunk of each tile in
    exactly one block's segments, no dead tile read, every block within a
    chunk of the same share of the cost; the tiles cover the packed rows,
    N and K; the ring fits a block's shared memory."""
    E, nb, C, tokens, K, N, xb = shape
    p = grouped_plan(E, nb, C, K, N, N_SM, 256, xb)
    assert p.grid == N_SM
    assert p.row_tiles * p.bm >= nb * C > (p.row_tiles - 1) * p.bm
    assert p.tiles_n * p.bn >= N > (p.tiles_n - 1) * p.bn
    assert p.chunks * GROUPED_BK >= K > (p.chunks - 1) * GROUPED_BK
    assert p.stages >= 2 and p.smem_bytes <= SMEM_PER_BLOCK
    assert p.smem_bytes == grouped_smem(256, E, nb, p.bm, p.bn, p.stages, xb)
    rng = np.random.default_rng(C + K)
    routed = _routed_counts(rng, E, nb, C, tokens)
    empty = np.where(np.arange(nb * E) % E % 5 == 0, 0, routed)
    one = np.where(np.arange(nb * E) % E == 0, C, 0)
    for counts in (routed, empty, one):
        cost = _hold_split(p, counts)
        assert (cost > 0).all()          # every SM has work
    assert f"{p.bm} packed rows" in p.describe()
    assert p.summary()["tiles"] == p.n_tiles


@pytest.mark.parametrize("C,bm,wm,alpha", [(1, 16, 1, 16), (2, 32, 2, 64),
                                           (8, 128, 8, 256)])
def test_plan_row_tile_holds_every_packed_row(C, bm, wm, alpha):
    """At granite's shapes one row tile holds every packed row an expert
    can have (nb * C = 16, 32, 128), so each chunk of weight codes is read
    once per column tile; the column tile is 128 (4 a lane); a chunk's
    fixed cost in the split is 16 live rows with one row group, else twice
    the row tile."""
    p = grouped_plan(40, 16, C, 1536, 512, N_SM, 256, 2)
    assert (p.bm, p.wm, p.row_tiles, p.bn, p.tn, p.alpha) == \
        (bm, wm, 1, 128, 4, alpha)


def test_split_balances_rows_where_a_shape_split_does_not():
    """At a decode step the experts' live rows differ (1 to 12 of 16): a
    split of the chunks alone would leave the busiest block with far more
    gathers than the mean; the split weighted by live rows keeps every
    block within one chunk's cost of the mean."""
    p = grouped_plan(40, 16, 1, 1536, 512, N_SM, 256, 2)
    rng = np.random.default_rng(3)
    counts = _routed_counts(rng, 40, 16, 1, 32)
    cost = _hold_split(p, counts)
    assert cost.max() / cost.mean() < 1.05
    rows = np.clip(counts.reshape(16, 40), 0, 1).sum(0)
    chunk_rows = np.repeat(rows, p.tiles_n * p.chunks)    # chunk by chunk
    per_sm = np.array_split(chunk_rows, N_SM)             # equal chunks
    by_chunks = np.array([c.sum() for c in per_sm])
    assert by_chunks.max() / by_chunks.mean() > 1.3


def test_plan_is_cached_and_checked():
    p = grouped_plan(4, 2, 24, 33, 14, 5)
    assert grouped_plan(4, 2, 24, 33, 14, 5) is p
    check_grouped_plan(p, 8, 24, 33, 14, 256, 4)
    for args in ((8, 24, 34, 14, 256, 4), (8, 24, 33, 14, 256, 2),
                 (12, 24, 33, 14, 256, 4)):
        with pytest.raises(ValueError, match="not built"):
            check_grouped_plan(p, *args)


def test_packed_rows_follow_the_dispatch_blocks():
    """An expert's packed rows are its live rows of block 0, then block
    1, ...: the order the kernel's prefix gives them."""
    counts = torch.tensor([2, 0, 1, 3, 0, 2], dtype=torch.int32)  # nb=3, E=2
    rows = packed_rows(counts, 2, 4)
    assert rows[0].tolist() == [0, 1, 8]
    assert rows[1].tolist() == [12, 13, 14, 20, 21]


# ---------------------------------------------------------------------------
# the plan-walking plain version against the reference
# ---------------------------------------------------------------------------

# (G, E, C, K, N, biased, counts)
CASES = {
    "blocks": (8, 4, 24, 33, 14, False, None),
    "biased_m00": (4, 4, 24, 33, 14, True, None),
    "ktile": (4, 2, 24, 130, 40, False, None),
    "empty_experts": (6, 3, 16, 40, 9, True, [0, 16, 3, 0, 16, 5]),
}


@pytest.fixture(scope="module")
def ref():
    load_reference()
    import repro.kernels.fused_lut_grouped.ops as jgops
    return SimpleNamespace(gops=jgops)


def _operands(G, E, C, K, N, seed, counts=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(G, C, K)).astype(np.float32)
    if counts is None:
        counts = rng.integers(0, C + 1, size=(G,))
    counts = np.asarray(counts, np.int32)
    x = x * (np.arange(C)[None, :] < counts[:, None])[..., None]
    wq = rng.integers(-128, 128, (E, K, N)).astype(np.int32)
    ws = (rng.random((E, N)) * 0.01 + 1e-3).astype(np.float32)
    xs = np.float32(np.abs(x).max() / 127)
    return x, wq, ws, xs, counts


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("emit_acc", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_plan_ref_matches_reference(ref, case, emit_acc):
    """Walked over the splits for 1, 3 and 132 blocks (whole tiles, splits
    of every tile, and the mix), the plain version is bitwise the
    reference's interpret-mode kernel and the port's one-pass plain
    version."""
    import jax.numpy as jnp
    G, E, C, K, N, biased, counts = CASES[case]
    x, wq, ws, xs, counts = _operands(G, E, C, K, N, seed=G + C + K + N,
                                      counts=counts)
    lut = BIASED_LUT if biased else LUT
    want = _bits(ref.gops.fused_lut_grouped(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(lut), 128, xs, 0.0,
        jnp.asarray(ws), jnp.asarray(counts), bits=8, interpret=True,
        emit_acc=emit_acc))
    t = [torch.from_numpy(np.array(v)) for v in (x, wq, lut, ws, counts)]
    one_pass = fused_lut_grouped_ref(t[0], t[1], t[2].reshape(-1), 128, 256,
                                     xs, 0.0, t[3], t[4], emit_acc=emit_acc)
    assert np.array_equal(_bits(one_pass.numpy()), want)
    for n_sm in (1, 3, N_SM):
        plan = grouped_plan(E, G // E, C, K, N, n_sm)
        got = fused_lut_grouped_plan_ref(t[0], t[1], t[2], 128, 256, xs, 0.0,
                                         t[3], t[4], plan=plan,
                                         emit_acc=emit_acc)
        assert np.array_equal(_bits(got.numpy()), want), n_sm


@pytest.mark.parametrize("emit_acc", [False, True])
def test_dropped_split_differs(emit_acc):
    """Segments with one K split of a live tile dropped leave that tile's
    rows 0: the plan-walking version then differs from the one-pass plain
    version (the planted fault chip_smoke launches on the card); the full
    segments give it bit for bit."""
    G, E, C, K, N = 8, 4, 24, 130, 40
    x, wq, ws, xs, counts = _operands(G, E, C, K, N, seed=7,
                                      counts=[24, 3, 0, 11, 5, 24, 1, 2])
    t = [torch.from_numpy(v) for v in (x, wq, LUT, ws, counts)]
    plan = grouped_plan(E, G // E, C, K, N, 7)
    segments = split_segments(plan, counts)
    split = [i for i, s in enumerate(segments[1].tolist()) if s[3] >= 0]
    assert split
    want = fused_lut_grouped_ref(t[0], t[1], t[2].reshape(-1), 128, 256, xs,
                                 0.0, t[3], t[4], emit_acc=emit_acc)
    got = fused_lut_grouped_plan_ref(t[0], t[1], t[2], 128, 256, xs, 0.0,
                                     t[3], t[4], plan=plan, segments=segments,
                                     drop_slice=split[0], emit_acc=emit_acc)
    assert not torch.equal(got, want)
    full = fused_lut_grouped_plan_ref(t[0], t[1], t[2], 128, 256, xs, 0.0,
                                      t[3], t[4], plan=plan,
                                      segments=segments, emit_acc=emit_acc)
    assert torch.equal(full, want)


def test_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the wrapper takes the plain version and launches
    nothing, whatever the plan would be."""
    x, wq, ws, xs, counts = _operands(6, 3, 8, 40, 12, seed=4)
    n0 = fused_lut_grouped.launches
    t = [torch.from_numpy(v) for v in (x, wq, LUT, ws, counts)]
    got = fused_lut_grouped(t[0], t[1], t[2], 128, xs, 0.0, t[3], t[4])
    assert fused_lut_grouped.launches == n0
    assert torch.equal(got, fused_lut_grouped_ref(
        t[0], t[1], t[2].reshape(-1), 128, 256, xs, 0.0, t[3], t[4]))
    assert isinstance(grouped_plan(3, 2, 8, 40, 12, N_SM), GroupedPlan)
