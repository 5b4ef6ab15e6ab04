"""The port's managed space (``repro_torch.uvm``) against the reference's.

One seeded sequence of operations — register, device reads and writes,
host loads and peeks, prefetches, advice, whole-table evictions and dirty
chunk marks — runs through ``repro.uvm.ManagedSpace`` (numpy leaves) and
``repro_torch.uvm.ManagedSpace`` (tensor leaves, frames on the CPU). After
every operation both must agree exactly: the bytes each returns, the
paging counters (``stats_dict()``), every page-table array, the host
backing, the bytes of every resident frame, and the dirty marks. The
cases cover both eviction policies, two page sizes, promotion off and on,
and f32 and bf16 leaves — the transitions the reference's
``tests/uvm/test_pagetable*.py``, ``test_space.py`` and
``test_promotion.py`` pin one by one.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.uvm as ref_uvm
import repro_torch.uvm as port_uvm
from repro_torch.uvm import Advice, PageTableError, Residency

TABLE_ARRAYS = ("residency", "frame", "wb_dirty", "write_tick",
                "access_tick", "access_count")
DTYPES = {"f32": (np.float32, torch.float32), "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _leaves(rng, page, dtype):
    """Leaf shapes in elements: several pages, a partial tail page, one
    sub-page leaf, a 0-d leaf and an empty one."""
    np_t, torch_t = DTYPES[dtype]
    item = np.dtype(np_t).itemsize
    shapes = {"params/w": (5 * page // item + 3,), "params/b": (7,),
              "opt/m": (3, page // item), "opt/v": (2 * page // item,),
              "step": (), "empty": (0,)}
    out = {}
    for path, shape in shapes.items():
        n = int(np.prod(shape, dtype=np.int64)) * item
        raw = rng.integers(0, 256, n, dtype=np.uint8)
        if dtype == "bf16":  # keep the payloads finite: clear exponent-all-ones
            raw[1::2] &= 0x7F
        out[path] = raw, shape
    return out, np_t, torch_t


def _trees(leaves, np_t, torch_t):
    ref, port = {}, {}
    for path, (raw, shape) in leaves.items():
        node_r, node_p = ref, port
        *parents, name = path.split("/")
        for p in parents:
            node_r = node_r.setdefault(p, {})
            node_p = node_p.setdefault(p, {})
        node_r[name] = raw.view(np_t).reshape(shape).copy()
        node_p[name] = (torch.from_numpy(raw.copy()).view(torch_t).reshape(shape)
                        if raw.size else torch.empty(shape, dtype=torch_t))
    return ref, port


def _u8(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().reshape(-1)
        return t.view(torch.uint8).numpy() if t.numel() else np.empty(0, np.uint8)
    return np.ascontiguousarray(np.asarray(t)).reshape(-1).view(np.uint8)


def _same_space(ref, port):
    assert ref.stats_dict() == port.stats_dict()
    assert ref.tick() == port.tick()
    assert ref.paths() == port.paths()
    for path in ref.paths():
        rt, pt = ref.table(path), port.table(path)
        for name in TABLE_ARRAYS:
            np.testing.assert_array_equal(getattr(rt, name), getattr(pt, name),
                                          err_msg=f"{path}.{name}")
        assert rt.advice == pt.advice
        np.testing.assert_array_equal(ref._regions[path].host, port._regions[path].host)
        for p in rt.device_pages().tolist():  # resident frames hold the same bytes
            n, fid = rt.page_nbytes(p), int(rt.frame[p])
            np.testing.assert_array_equal(ref.arena.frames[fid, :n],
                                          port.arena.frames[fid, :n].numpy())
    port.check_invariants()


def _random_op(rng, spaces, paths, page, chunk):
    ref, port = spaces
    path = paths[int(rng.integers(len(paths)))]
    nbytes = ref._regions[path].host.nbytes
    lo = int(rng.integers(0, nbytes + 1))
    hi = int(rng.integers(lo, nbytes + 1))
    kind = rng.choice(["read", "read", "write", "write", "load_range", "load_leaf",
                       "peek", "prefetch", "advise", "marks", "evict_table",
                       "read_leaf", "write_leaf", "stream"])
    if kind == "read":
        np.testing.assert_array_equal(ref.read_range(path, lo, hi),
                                      _u8(port.read_range(path, lo, hi)))
    elif kind in ("write", "load_range"):
        data = rng.integers(0, 256, hi - lo, dtype=np.uint8)
        if kind == "write":
            ref.write_range(path, lo, data)
            port.write_range(path, lo, torch.from_numpy(data.copy()))
        else:
            ref.load_range(path, lo, data)
            port.load_range(path, lo, torch.from_numpy(data.copy()))
    elif kind == "load_leaf":
        data = rng.integers(0, 256, nbytes, dtype=np.uint8)
        ref.load_leaf(path, data)
        port.load_leaf(path, data.copy())
    elif kind == "peek":
        np.testing.assert_array_equal(ref.peek_range(path, lo, hi),
                                      _u8(port.peek_range(path, lo, hi)))
    elif kind == "prefetch":
        n_pages = ref.table(path).n_pages
        a = int(rng.integers(0, n_pages))
        b = int(rng.integers(a, n_pages + 2))
        assert ref.prefetch_pages(path, a, b) == port.prefetch_pages(path, a, b)
    elif kind == "advise":
        flag = [Advice.NONE, Advice.READ_MOSTLY, Advice.PREFERRED_HOST,
                Advice.PREFERRED_DEVICE][int(rng.integers(4))]
        ref.advise(path, ref_uvm.Advice(int(flag)))
        port.advise(path, flag)
    elif kind == "marks":
        tick = int(rng.integers(-1, ref.tick() + 1))
        for cb in (chunk, page // 2, 3 * page // 2):
            assert ref.dirty_chunk_marks_since(tick, cb) == \
                port.dirty_chunk_marks_since(tick, cb)
    elif kind == "evict_table":
        ref.pager.evict_table(ref.table(path))
        port.pager.evict_table(port.table(path))
    elif kind == "read_leaf":
        np.testing.assert_array_equal(_u8(ref.read_leaf(path)), _u8(port.read_leaf(path)))
    elif kind == "write_leaf":
        region = port._regions[path]
        data = rng.integers(0, 256, nbytes, dtype=np.uint8)
        new = (torch.from_numpy(data.copy()).view(region.dtype).reshape(region.shape)
               if nbytes else torch.empty(region.shape, dtype=region.dtype))
        ref.write_leaf(path, data.view(ref._regions[path].dtype).reshape(
            ref._regions[path].shape))
        port.write_leaf(path, new)
    else:  # a prefetch stream drained in small batches
        streams = [ref_uvm.PrefetchStream(batch_pages=2), port_uvm.PrefetchStream(batch_pages=2)]
        n_pages = ref.table(path).n_pages
        a = int(rng.integers(0, n_pages))
        for s in streams:
            s.enqueue(path, a)
        assert streams[0].drain(ref) == streams[1].drain(port)
    return kind


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("promote", [0, 3])
@pytest.mark.parametrize("page", [4096, 16384])
@pytest.mark.parametrize("policy", ["lru", "clock"])
def test_op_sequence_matches_reference(policy, page, promote, dtype):
    rng = np.random.default_rng([page, promote, len(policy), len(dtype)])
    leaves, np_t, torch_t = _leaves(rng, page, dtype)
    ref_state, port_state = _trees(leaves, np_t, torch_t)
    total = sum(raw.nbytes for raw, _ in leaves.values())
    kw = dict(page_bytes=page, eviction_policy=policy, fault_window_pages=3,
              promote_threshold=promote, promote_window=4 if promote else 0)
    cap = max(page, total // 2)  # oversubscribed x2
    ref = ref_uvm.ManagedSpace(cap, **kw)
    port = port_uvm.ManagedSpace(cap, device="cpu", **kw)
    ref.register(ref_state)
    port.register(port_state)
    _same_space(ref, port)
    paths = ref.paths()
    seen = set()
    for _ in range(120):
        seen.add(_random_op(rng, (ref, port), paths, page, chunk=page))
        _same_space(ref, port)
    # whole-tree device access both ways, then a re-registration
    got = port.read_state()
    want = ref.read_state()
    for path in paths:
        leaf = got
        for k in path.split("/"):
            leaf = leaf[k]
        assert isinstance(leaf, torch.Tensor) and leaf.dtype == torch_t
    port.write_state(got)
    ref.write_state(want)
    _same_space(ref, port)
    ref.register(ref_state)
    port.register(port_state)
    _same_space(ref, port)
    assert ref.stats.evictions > 0 and ref.stats.writebacks > 0
    assert {"read", "write", "load_range", "peek", "marks"} <= seen


def test_peek_and_read_return_leaf_types():
    """Tensor leaves read back as tensors (peeks on the CPU), numpy leaves
    as numpy; a meta leaf registers its shape with zero bytes."""
    sp = port_uvm.ManagedSpace(4096, page_bytes=1024, device="cpu")
    w = torch.arange(600, dtype=torch.float32)
    sp.register({"w": w, "n": np.arange(10, dtype=np.int64),
                 "m": torch.empty((3, 5), dtype=torch.bfloat16, device="meta")})
    got = sp.read_state()
    assert torch.equal(got["w"], w) and got["w"].device.type == "cpu"
    assert isinstance(got["n"], np.ndarray) and np.array_equal(got["n"], np.arange(10))
    assert got["m"].dtype == torch.bfloat16 and not got["m"].float().any()
    got["w"] += 1
    sp.write_state(got)
    peek = sp.peek_state()
    assert torch.equal(peek["w"], w + 1) and isinstance(peek["n"], np.ndarray)
    assert sp.stats.evictions > 0
    with pytest.raises(ValueError, match="re-register"):
        sp.write_leaf("w", torch.zeros(600, dtype=torch.int32))


@pytest.mark.parametrize("case", ["small_arena", "corrupt_table", "no_card"])
def test_space_refusals(case):
    if case == "small_arena":
        with pytest.raises(ValueError, match="smaller than one page"):
            port_uvm.ManagedSpace(100, page_bytes=1024, device="cpu")
    elif case == "corrupt_table":
        sp = port_uvm.ManagedSpace(4096, page_bytes=1024, device="cpu")
        sp.register({"x": np.zeros(4096, np.uint8)})
        sp.read_range("x", 0, 1024)
        sp.table("x").residency[0] = Residency.HOST  # drop a frame silently
        with pytest.raises(PageTableError):
            sp.check_invariants()
    else:
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present: the default device is usable")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_uvm.ManagedSpace(4096, page_bytes=1024)


@pytest.mark.parametrize("policy", ["lru", "clock"])
def test_unpinned_write_fault_window_matches_reference(policy):
    """``Pager.fault_in`` called directly with more unpinned write pages
    than frames: a page filled in this call is evicted dirty in the same
    call, so its queued fill must land before its write-back reads the
    frame. Host bytes, counters and tables equal the reference's."""
    page = 1024
    raw = np.random.default_rng(3).integers(0, 256, 10 * page, dtype=np.uint8)
    ref = ref_uvm.ManagedSpace(3 * page, page_bytes=page, eviction_policy=policy)
    port = port_uvm.ManagedSpace(3 * page, page_bytes=page, eviction_policy=policy,
                                 device="cpu")
    ref.register({"x": raw.copy()})
    port.register({"x": torch.from_numpy(raw.copy())})
    port.read_range("x", 0, 3 * page)  # frames hold other pages' bytes first
    ref.read_range("x", 0, 3 * page)
    for sp in (ref, port):
        sp.pager.fault_in(sp.table("x"), np.arange(10), write=True, tick=sp.tick() + 1)
        sp.pager.evict_table(sp.table("x"))
    _same_space(ref, port)
    np.testing.assert_array_equal(port._regions["x"].host, raw)
