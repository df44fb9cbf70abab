"""The port's input pipeline (``repro_torch.data.pipeline``): ``MarkovLM``
batches equal to the reference's, ``shard_batch`` and the ``Prefetcher``'s
liveness contract, mirroring ``tests/test_pipeline.py``: order kept, a
producer exception re-raised on the consumer (and sticky), exhaustion a
persistent ``StopIteration``, ``close()`` unblocking a producer stuck on a
full queue. Everything on ``device="cpu"``.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data.pipeline import (MarkovLM, Prefetcher,  # noqa: E402
                                       shard_batch)
from test_torch_parity import load_reference  # noqa: E402


def test_markov_batches_match_the_reference():
    load_reference()
    from repro.data.pipeline import MarkovLM as RefMarkovLM
    a = next(MarkovLM(vocab=16, seed=3).batches(4, 8, seed=5))
    b = next(RefMarkovLM(vocab=16, seed=3).batches(4, 8, seed=5))
    for k in ("tokens", "labels"):
        assert np.array_equal(a[k], b[k])


def test_prefetcher_yields_in_order():
    src = ({"i": np.full((2,), i, np.int32)} for i in range(6))
    pf = Prefetcher(src, depth=2, device="cpu")
    got = [int(b["i"][0]) for b in pf]
    assert got == list(range(6))
    with pytest.raises(StopIteration):     # exhaustion is persistent
        next(pf)
    pf.close()


def test_prefetcher_places_batches_as_tensors():
    lm = MarkovLM(vocab=16, seed=0)
    pf = Prefetcher(lm.batches(3, 5), depth=2, device="cpu")
    b = next(pf)
    want = next(lm.batches(3, 5))
    pf.close()
    assert isinstance(b["tokens"], torch.Tensor)
    assert b["tokens"].device.type == "cpu"
    assert b["tokens"].dtype == torch.int32
    assert np.array_equal(b["tokens"].numpy(), want["tokens"])


def test_prefetcher_propagates_producer_error():
    def bad():
        yield {"x": np.zeros(1)}
        raise ValueError("producer exploded")

    pf = Prefetcher(bad(), depth=2, device="cpu")
    next(pf)
    with pytest.raises(ValueError, match="producer exploded"):
        next(pf)
    with pytest.raises(ValueError, match="producer exploded"):   # sticky
        next(pf)
    pf.close()


def test_prefetcher_close_unblocks_full_queue():
    def endless():
        i = 0
        while True:
            yield {"i": np.full((1,), i, np.int32)}
            i += 1

    pf = Prefetcher(endless(), depth=1, device="cpu")
    time.sleep(0.1)          # let the producer fill the queue and block
    assert pf.t.is_alive()
    done = threading.Event()

    def closer():
        pf.close()
        done.set()

    t = threading.Thread(target=closer, daemon=True)
    t.start()
    assert done.wait(timeout=5.0), "close() deadlocked on a full queue"
    assert not pf.t.is_alive()


def test_shard_batch_on_cpu():
    out = shard_batch({"x": np.ones((4, 2), np.float32),
                       "y": np.arange(4, dtype=np.int32)}, device="cpu")
    assert out["x"].shape == (4, 2) and out["x"].dtype == torch.float32
    assert out["y"].dtype == torch.int32 and out["y"].device.type == "cpu"


def test_shard_batch_defaults_to_cuda():
    """No device named means ``cuda``; without a card that raises."""
    if torch.cuda.is_available():
        assert shard_batch({"x": np.ones(2)})["x"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            shard_batch({"x": np.ones(2)})
