"""The port's DMA primitives (``serving/dma.py``), the twins of
tests/test_async_pipeline.py:290-321, on the CPU: the depth-1 ring is an
async FIFO whose entries never alias their source tensors, the depth-0
ring counts blocking pops, and the host staging buffers are reused."""
import numpy as np
import pytest
import torch

from repro.serving.dma import FetchRing as RFetchRing
from repro.serving.dma import TransferStats as RTransferStats
from repro_torch.serving.dma import FetchRing, HostStaging, TransferStats


def test_ring_depth1_is_async_fifo():
    stats = TransferStats()
    ring = FetchRing(stats, depth=1, device="cpu")
    ring.push({"n": 1}, {"x": torch.tensor([1, 2, 3])})
    ring.push({"n": 2}, {"x": torch.tensor([4, 5, 6])})
    assert len(ring) == 2
    meta, host = ring.pop()
    assert meta["n"] == 1 and host["x"].tolist() == [1, 2, 3]
    assert stats.async_d2h == 1 and stats.blocking_d2h == 0
    meta, host = ring.pop()
    assert meta["n"] == 2
    assert ring.pop() is None


def test_ring_depth1_entry_does_not_alias_its_source():
    """The decode step rewrites its state in place: a depth-1 entry holds
    the values at push time, not the tensor."""
    ring = FetchRing(TransferStats(), depth=1, device="cpu")
    src = torch.arange(4, dtype=torch.int32)
    ring.push({}, {"x": src, "y": np.asarray([7])})
    src.fill_(-1)
    _, host = ring.pop()
    assert host["x"].tolist() == [0, 1, 2, 3] and host["y"].tolist() == [7]


def test_ring_depth0_counts_blocking():
    stats = TransferStats()
    stats.begin_step()
    ring = FetchRing(stats, depth=0)
    ring.push({}, {"x": torch.zeros(4)})
    ring.pop()
    stats.end_step()
    assert stats.blocking_d2h == 1
    assert stats.blocked_steps == 1 and stats.steps == 1
    assert stats.host_blocked_fraction == 1.0


@pytest.mark.parametrize("depth", [0, 1])
def test_ring_accounting_matches_reference(depth):
    """Same pushes, same pops, same step brackets: the port's counters
    equal the reference ring's (bytes included)."""
    import jax.numpy as jnp
    arrays = [{"toks": np.arange(4, dtype=np.int32),
               "entropy": np.linspace(0, 1, 4).astype(np.float32)},
              {"tok": np.asarray([3], np.int32)}]
    snaps = []
    for ring_cls, stats_cls, conv in (
            (FetchRing, TransferStats, torch.from_numpy),
            (RFetchRing, RTransferStats, jnp.asarray)):
        stats = stats_cls()
        ring = ring_cls(stats, depth=depth)
        for a in arrays:
            stats.begin_step()
            ring.push({}, {k: conv(v) for k, v in a.items()})
            if depth == 0:
                ring.pop()
            stats.end_step()
        for _ in ring.drain():
            pass
        snap = stats.snapshot()
        snap.pop("blocked_s"), snap.pop("waited_s")
        snaps.append(snap)
    assert snaps[0] == snaps[1]


def test_ring_rejects_deeper_pipelines():
    with pytest.raises(ValueError):
        FetchRing(TransferStats(), depth=2)


def test_staging_buffers_are_reused():
    st = HostStaging()
    a = st.pull("x", torch.arange(6, dtype=torch.float32).reshape(2, 3))
    b = st.pull("x", torch.zeros((2, 3)))
    assert a is b                       # same allocation, new contents
    assert b.sum() == 0
    c = st.buf("x", (4, 3), np.float32)  # shape change -> realloc
    assert c is not b
    assert st["x"] is c


def test_staging_pull_keeps_bf16_bytes():
    """``pull`` lands a tensor in the named buffer; bf16 travels as the
    int16 view of its bytes, as ``device.host_view`` gives it."""
    st = HostStaging()
    t = torch.randn(3, 5).to(torch.bfloat16)
    a = st.pull("p", t)
    assert a.dtype == np.int16
    np.testing.assert_array_equal(a, t.view(torch.int16).numpy())
    b = st.pull("p", t * 2)
    assert b is a                       # reused
    np.testing.assert_array_equal(b, (t * 2).view(torch.int16).numpy())
    m = st.pull("m", torch.tensor([[True, False]]))
    assert m.dtype == np.bool_ and m.tolist() == [[True, False]]
