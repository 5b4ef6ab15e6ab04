"""PyTorch port: the first sync's buffers made ahead, off the blocking path.

``ForkedCheckpointer.prepare(state)`` allocates and faults every snapshot
buffer's first-sync buffers on a background thread; the first sync then
takes them (waiting for one still being faulted, making one not yet started
itself, refusing one of the wrong size). The image is the same bytes either
way.
"""
import concurrent.futures as cf
import threading

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import ChunkStore
from repro_torch.checkpoint.manifest import load_manifest
from repro_torch.core import ForkedCheckpointer, RestoreManager
from repro_torch.core.shadow import ShadowStateManager
from repro_torch.utils.tree import leaf_bytes


def _state(seed: int, *, wide: int = 1000) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"device": {"w": torch.randn(wide, generator=g),
                       "b": torch.randn(37, 3, generator=g).to(torch.bfloat16)},
            "host": {"step": np.int64(seed), "data": np.arange(5, dtype=np.int32)}}


LEAVES = 4  # w, b, step, data: one stream each


def _same(a, b) -> bool:
    return bytes(leaf_bytes(a)) == bytes(leaf_bytes(b))


def _digests(root: str, step: int) -> dict:
    m = load_manifest(root, step)
    return {p: [c.digest for s in lv.shards for c in s.chunks] for p, lv in m.leaves.items()}


@pytest.mark.parametrize("backend", ["thread", "fork"])
def test_prepared_first_syncs_take_the_buffers_and_write_the_same_image(tmp_path, backend):
    """Both buffers' first syncs (checkpoints 1 and 2) take every buffer
    made ahead; the images equal those of a checkpointer without prepare,
    and restore to the state."""
    roots = {}
    for prepared in (False, True):
        root = str(tmp_path / f"ck-{prepared}")
        ck = ForkedCheckpointer(ChunkStore(root), chunk_bytes=256, backend=backend)
        if prepared:
            ck.prepare(_state(1))
            # the one background thread takes tasks in order: once this one
            # ran, every buffer is made (a sync before then would make the
            # ones not yet started itself)
            ck._ahead_pool.submit(lambda: None).result()
        rs = [ck.save_async(step, _state(step)) for step in (1, 2, 3)]
        for r in rs:
            r.wait()
            assert r.error is None, r.error
        ck.close()
        want = [LEAVES, LEAVES, 0] if prepared else [0, 0, 0]
        assert [r.buffers_ahead for r in rs] == want
        roots[prepared] = root
    for step in (1, 2, 3):
        assert _digests(roots[True], step) == _digests(roots[False], step)
    state, _ = RestoreManager(ChunkStore(roots[True])).restore(step=3)
    want = _state(3)
    assert _same(state["device"]["w"], want["device"]["w"])
    assert _same(state["device"]["b"], want["device"]["b"])


def test_a_buffer_of_another_size_is_not_taken(tmp_path):
    ck = ForkedCheckpointer(ChunkStore(str(tmp_path / "ck")), chunk_bytes=256)
    ck.prepare(_state(1, wide=999))  # w is 4 bytes shorter than the sync's
    ck._ahead_pool.submit(lambda: None).result()
    r = ck.save_async(1, _state(1))
    r.wait()
    assert r.error is None and r.buffers_ahead == LEAVES - 1
    ck.close()
    state, _ = RestoreManager(ChunkStore(str(tmp_path / "ck"))).restore(step=1)
    assert _same(state["device"]["w"], _state(1)["device"]["w"])


def test_a_buffer_not_yet_started_is_made_by_the_sync():
    """With the background thread held busy, the sync cancels what was made
    ahead and faults its own buffers: nothing waits on the thread."""
    gate = threading.Event()
    pool = cf.ThreadPoolExecutor(max_workers=1)
    try:
        pool.submit(gate.wait)
        shadow = ShadowStateManager(chunk_bytes=256, shared_buffers=True)
        state = _state(2)
        shadow.prepare(state, pool)
        stats = shadow.sync(state)
        assert stats.buffers_ahead == 0 and stats.chunks_fetched == stats.chunks_total
        assert not shadow._ahead
        snap = shadow.snapshot()
        w = snap[("device/w", 0)]
        assert bytes(w["data"]) == state["device"]["w"].numpy().tobytes()
    finally:
        gate.set()
        pool.shutdown(wait=True)


def test_prepare_is_a_no_op_once_synced_and_for_segment_buffers():
    pool = cf.ThreadPoolExecutor(max_workers=1)
    try:
        shadow = ShadowStateManager(chunk_bytes=256)
        shadow.sync(_state(1))
        shadow.prepare(_state(1), pool)
        assert not shadow._ahead
        seg = ShadowStateManager(chunk_bytes=256,
                                 segment_factory=lambda key, n: np.zeros(n, np.uint8))
        seg.prepare(_state(1), pool)
        assert not seg._ahead
    finally:
        pool.shutdown(wait=True)
