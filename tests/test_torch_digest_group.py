"""PyTorch port: the grouped chunk digest (one call over many leaves).

On the card one kernel launch digests up to ``chunk_digest.CAPACITY``
leaves into one table, cutting every leaf into (chunk, segment) units whose
16-byte-aligned body is read with vector loads and whose head and tail
words are read as scalars. The kernel runs only on a card
(``tests/test_torch_card.py``); here the same split is checked through
``launch_plan`` and a numpy model of the kernel's fold, both against the
host oracle ``chunk_digest_np``, and the grouped dispatch and the shadow
manager that calls it are held against the JAX reference. Digests are
integers: every comparison is exact.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.chunking import chunk_digest_np
from repro.core.shadow import ShadowStateManager as RefShadow
from repro.kernels import ops as jops
from repro_torch.core.shadow import ShadowStateManager
from repro_torch.kernels import chunk_digest, ops, ref
from repro_torch.models.convert import array_to_tensor

SEED, PRIME, M32 = 2166136261, 16777619, 0xFFFFFFFF


def _rand(rng, dtype, shape):
    dt = np.dtype(dtype)
    if dt.kind == "f" or dt == np.dtype(ml_dtypes.bfloat16):
        return rng.standard_normal(shape).astype(np.float32).astype(dt)
    return rng.integers(0, 100, shape).astype(dt)


def _mixed_tree(rng):
    """Mixed dtypes and sizes, empty and 0-d leaves among them."""
    return {
        "w": _rand(rng, np.float32, (33, 17)),
        "e": np.zeros((0,), np.float32),
        "b": _rand(rng, ml_dtypes.bfloat16, (7, 5)),
        "s": np.asarray(3, np.int32),
        "i8": _rand(rng, np.int8, (1023,)),
        "e2": np.zeros((3, 0), np.int8),
        "h": _rand(rng, np.float16, (257, 3)),
        "big": _rand(rng, np.float32, (4096 + 3,)),
    }


def _host_digests(raw: np.ndarray, cb: int) -> list[int]:
    if raw.nbytes == 0:
        return [chunk_digest_np(raw)]
    return [chunk_digest_np(raw[i : i + cb]) for i in range(0, raw.nbytes, cb)]


@pytest.mark.parametrize("cb", [4, 12, 64, 4096])
def test_grouped_dispatch_equals_per_leaf_plain(rng, cb):
    tree = _mixed_tree(rng)
    xs = [array_to_tensor(v) for v in tree.values()]
    table, bounds = ops.chunk_digest_table(xs, cb)
    assert len(bounds) == len(xs) + 1 and bounds[-1] == table.shape[0]
    for k, x in enumerate(xs):
        assert torch.equal(table[bounds[k] : bounds[k + 1]], ref.chunk_digests_plain(x, cb))
    u64 = ops.host_chunk_digests(xs, cb)
    for d, v in zip(u64, tree.values()):
        assert d == _host_digests(np.ascontiguousarray(v).reshape(-1).view(np.uint8), cb)


@pytest.mark.parametrize("cb", [64, 256, 4096])
def test_tree_digests_match_reference_jnp_path(rng, cb):
    tree = _mixed_tree(rng)
    port = ops.tree_chunk_digests({k: array_to_tensor(v) for k, v in tree.items()}, cb)
    # the reference's device path (jnp on the CPU) for every non-empty leaf
    jnp_ref = jops.tree_chunk_digests({k: jnp.asarray(v) for k, v in tree.items()}, cb,
                                      use_pallas="ref")
    for k, v in tree.items():
        if v.size:
            assert port[k] == jnp_ref[k], k
        else:  # the known divergence: jnp seeds hi for an empty leaf
            assert port[k] == [0] and jnp_ref[k] == [SEED << 32], k
    # ... and its host path (the oracle the manifests hold) for all of them
    assert port == jops.tree_chunk_digests(tree, cb)


def test_grouped_dispatch_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="one device"):
        ops.chunk_digest_table([torch.zeros(4), torch.zeros(4, device="meta")], 64)
    with pytest.raises(ValueError, match="no chunk_digest kernel"):
        ops.chunk_digest_table([torch.zeros(4, device="meta")], 64)
    with pytest.raises(ValueError, match="CUDA"):
        chunk_digest.chunk_digest_table([torch.zeros(16)], 64)
    with pytest.raises(ValueError, match="at least one"):
        chunk_digest.chunk_digest_table([], 64)
    table, bounds = ops.chunk_digest_table([], 64)
    assert table.shape == (0, 2) and bounds == (0,)
    assert ops.host_chunk_digests([], 64) == []


def test_host_digests_take_one_grouped_call_per_device(rng, monkeypatch):
    """A state may mix devices (a CPU RNG state beside the card's leaves):
    one grouped call for each device off the host, the digests back in the
    input order. A ``meta`` tensor stands in for the card; the CPU tensors
    hash with the numpy oracle and make no grouped call."""
    cb = 64
    cpu = [array_to_tensor(_rand(rng, np.float32, (n,))) for n in (5, 40, 0)]
    meta = [torch.empty(n, dtype=torch.float32, device="meta") for n in (17, 3)]
    xs = [cpu[0], meta[0], cpu[1], cpu[2], meta[1]]
    calls = []

    def per_device(ts, cb):
        calls.append([t.device.type for t in ts])
        rows = [max(1, -(-t.numel() * t.element_size() // cb)) for t in ts]
        # leaf k's row r holds [k + 1, r]: it tells where each row went
        table = torch.tensor([[k + 1, r] for k, n in enumerate(rows) for r in range(n)])
        return table, tuple(np.cumsum([0] + rows).tolist())

    monkeypatch.setattr(ops, "chunk_digest_table", per_device)
    got = ops.host_chunk_digests(xs, cb)
    assert calls == [["meta"] * 2]
    for k, x in zip((0, 2, 3), cpu):
        assert got[k] == _host_digests(x.numpy().reshape(-1).view(np.uint8), cb)
    assert got[1] == [1 << 32, (1 << 32) | 1] and got[4] == [2 << 32]


# -- launch_plan: rows, launches and the split of every unit -----------------

def _c_unit_count(nb: int, cb: int, ub: int) -> int:
    """The launcher's count of one leaf's units (csrc/chunk_digest.cu)."""
    if nb == 0:
        return 0
    chunks = -(-nb // cb)
    return (chunks - 1) * -(-cb // ub) + -(-(nb - (chunks - 1) * cb) // ub)


@pytest.mark.parametrize("cb", [4, 12, 20, 64, 1028, 4096])
@pytest.mark.parametrize("ub", [16, 48, 64 << 10])
@pytest.mark.parametrize("align", [0, 4, 8, 12])
def test_plan_covers_every_byte_once(cb, ub, align):
    nbytes = [0, 1, 3, 4, 5, 17, 64, 1027, 4096, 9001, 0, 2]
    addrs = [0 if n == 0 else 4096 * (k + 1) + align for k, n in enumerate(nbytes)]
    plan = chunk_digest.launch_plan(nbytes, cb, addrs=addrs, unit_bytes=ub)
    rows = [max(1, -(-n // cb)) for n in nbytes]
    assert plan.bounds == tuple(np.cumsum([0] + rows).tolist())
    for k, nb in enumerate(nbytes):
        units = list(plan.units(k))
        assert len(units) == _c_unit_count(nb, cb, ub)
        at = 0
        for u in units:
            assert u.leaf == k and u.lo == at and u.hi > u.lo
            assert u.lo // cb == u.chunk == (u.hi - 1) // cb  # never across chunks
            assert u.lo == u.chunk * cb + u.segment * ub
            assert u.first_word == (u.lo - u.chunk * cb) // 4 + 1
            # head, 16-byte body and tail hold the unit's words, once each
            assert u.head + 4 * u.body + u.tail == -(-(u.hi - u.lo) // 4)
            assert 0 <= u.head <= 3 and 0 <= u.tail <= 4
            if u.body:
                assert u.head == ((16 - (addrs[k] + u.lo) % 16) % 16) // 4
                assert (addrs[k] + u.lo + 4 * u.head) % 16 == 0
            at = u.hi
        assert at == nb


def test_plan_respects_the_group_capacity():
    nbytes = [(k * 37) % 300 for k in range(2 * chunk_digest.CAPACITY + 7)]
    plan = chunk_digest.launch_plan(nbytes, 64)
    busy = [k for k, n in enumerate(nbytes) if n]
    assert [k for g in plan.groups for k in g] == busy
    assert len(plan.groups) == -(-len(busy) // chunk_digest.CAPACITY) == 3
    assert all(len(g) <= chunk_digest.CAPACITY for g in plan.groups)
    assert chunk_digest.launch_plan([0, 0], 64).groups == ()


def test_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="multiple of 4"):
        chunk_digest.launch_plan([8], 6)
    with pytest.raises(ValueError, match="multiple of 16"):
        chunk_digest.launch_plan([8], 64, unit_bytes=24)
    with pytest.raises(ValueError, match="aligned"):
        chunk_digest.launch_plan([8, 8], 64, addrs=[16, 18])
    chunk_digest.launch_plan([0, 8], 64, addrs=[3, 16])  # an empty leaf is never read


# -- a numpy model of the kernel's fold --------------------------------------

def _fold_model(raw: np.ndarray, plan, k: int) -> list[int]:
    """What the kernel leaves in leaf k's rows: per unit, partial sums over
    its head, body and tail words with chunk-relative word indices, SEED on
    segment 0, folded by xor (hi) and add (lo) into zeroed rows."""
    n = plan.bounds[k + 1] - plan.bounds[k]
    hi, lo = [0] * n, [0] * n
    for u in plan.units(k):
        b = raw[u.lo : u.hi]
        words = np.frombuffer(b.tobytes() + bytes(-len(b) % 4), "<u4").astype(np.uint64)
        head, body, tail = (words[: u.head], words[u.head : u.head + 4 * u.body],
                            words[u.head + 4 * u.body :])
        assert len(tail) == u.tail and len(body) == 4 * u.body
        p_hi, p_lo = 0, 0
        for off, part in ((0, head), (u.head, body), (u.head + 4 * u.body, tail)):
            i = np.arange(u.first_word + off, u.first_word + off + len(part),
                          dtype=np.uint64)
            p_hi ^= int(np.bitwise_xor.reduce((part * ((i << np.uint64(1)) | np.uint64(1)))
                                              & np.uint64(M32), initial=np.uint64(0)))
            p_lo += int(((part ^ ((i * np.uint64(PRIME)) & np.uint64(M32)))).sum())
        hi[u.chunk] ^= p_hi ^ (SEED if u.segment == 0 else 0)
        lo[u.chunk] = (lo[u.chunk] + p_lo) & M32
    return [(h << 32) | l for h, l in zip(hi, lo)]


@pytest.mark.parametrize("cb", [4, 12, 20, 64, 1028, 4096])
@pytest.mark.parametrize("align", [0, 4, 8, 12])
def test_fold_model_equals_host_oracle(rng, cb, align):
    nbytes = [1, 2, 3, 4, 7, 65, 1031, 4099, 9000, 0]
    raws = [rng.integers(0, 256, n).astype(np.uint8) for n in nbytes]
    addrs = [64 + align if n else 0 for n in nbytes]
    for ub in (16, 32, 64 << 10):
        plan = chunk_digest.launch_plan(nbytes, cb, addrs=addrs, unit_bytes=ub)
        for k, raw in enumerate(raws):
            assert _fold_model(raw, plan, k) == _host_digests(raw, cb), (ub, k)


# -- the shadow manager: one grouped digest call per sync ---------------------

def _states(rng, n_rounds, cb):
    """A seeded sequence of states, each dirtying a few random chunks."""
    state = {
        "params": {"w": _rand(rng, np.float32, (97, 13)),
                   "b": _rand(rng, ml_dtypes.bfloat16, (31,))},
        "opt": {"m": _rand(rng, np.float32, (700,)), "e": np.zeros((0,), np.float32)},
        "step": np.asarray(0, np.int32),
        "host": {"tokens": rng.integers(0, 9, 50).astype(np.int8)},
    }
    out = [state]
    for r in range(n_rounds):
        nxt = {k: ({kk: vv.copy() for kk, vv in v.items()} if isinstance(v, dict)
                   else v.copy()) for k, v in state.items()}
        nxt["step"] = np.asarray(r + 1, np.int32)
        for group in ("params", "opt", "host"):
            for leaf in nxt[group].values():
                raw = leaf.reshape(-1).view(np.uint8)
                for c in range(-(-raw.nbytes // cb)):
                    if rng.random() < 0.3:
                        raw[c * cb : min(raw.nbytes, c * cb + 4)] ^= 0x5A
        out.append(nxt)
        state = nxt
    return out


def _to_port(state):
    """Device leaves as CPU tensors; the ``host`` group stays numpy."""
    return {k: (v if k == "host" else
                {kk: array_to_tensor(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else array_to_tensor(v))
            for k, v in state.items()}


@pytest.mark.parametrize("defer", [False, True])
def test_shadow_sync_matches_reference(rng, defer):
    cb = 64
    ref_m = RefShadow(chunk_bytes=cb, defer_first_digests=defer)
    port_m = ShadowStateManager(chunk_bytes=cb, defer_first_digests=defer)
    fetched = 0
    for state in _states(rng, 5, cb):
        ref_m.mark_device_step()
        port_m.mark_device_step()
        want = ref_m.sync(state)
        got = port_m.sync(_to_port(state))
        for field in ("chunks_fetched", "bytes_fetched", "changed", "leaves",
                      "chunks_total", "bytes_total"):
            assert getattr(got, field) == getattr(want, field), field
        fetched += got.chunks_fetched
        ref_snap, port_snap = ref_m.snapshot(), port_m.snapshot()
        assert ref_snap.keys() == port_snap.keys()
        for key in ref_snap:
            assert np.array_equal(port_snap[key]["data"], ref_snap[key]["data"]), key
            assert port_snap[key]["digests"] == ref_snap[key]["digests"], key
    assert 0 < fetched < 6 * got.chunks_total  # some chunks were skipped as clean


def test_one_sync_makes_one_grouped_digest_call(rng, monkeypatch):
    calls = []
    grouped = ops.host_chunk_digests

    def counting(xs, cb):
        calls.append(len(xs))
        return grouped(xs, cb)

    monkeypatch.setattr(ops, "host_chunk_digests", counting)
    cb = 64
    states = _states(rng, 3, cb)
    tensors = sum(isinstance(v, torch.Tensor) for v in (
        _to_port(states[0])["params"] | _to_port(states[0])["opt"]).values()) + 1
    m = ShadowStateManager(chunk_bytes=cb, defer_first_digests=True)
    m.sync(_to_port(states[0]))
    assert calls == []  # the first digests are deferred to the persist
    for state in states[1:]:
        m.mark_device_step()
        m.sync(_to_port(state))
    # one call per sync, over every tensor leaf (all marked dirty)
    assert calls == [tensors] * 3
    m.sync(_to_port(states[-1]))  # nothing marked dirty: no digest at all
    assert calls == [tensors] * 3


def test_new_leaf_between_syncs_refetches_the_whole_state(rng):
    """A leaf that appears after the first sync re-registers the state
    before any stream syncs, so every stream is fetched whole and the shadow
    stays complete. The reference re-registers partway through its loop: it
    syncs the leaves before the new one incrementally, then drops their
    buffers, so its counts are smaller and its snapshot raises. The port
    keeps the complete shadow; this pins both sides of the divergence."""
    cb = 64
    a = _rand(rng, np.float32, (100,))
    c = _rand(rng, np.float32, (50,))
    a2 = a.copy()
    a2[0] += 1
    states = [{"a": a, "c": c}, {"a": a2, "b": np.arange(20, dtype=np.int32), "c": c}]
    ref_m, port_m = RefShadow(chunk_bytes=cb), ShadowStateManager(chunk_bytes=cb)
    got = []
    for state in states:
        ref_m.mark_device_step()
        port_m.mark_device_step()
        got.append((ref_m.sync(state),
                    port_m.sync({k: array_to_tensor(v) for k, v in state.items()})))
    (want1, port1), (want2, port2) = got
    assert (port1.chunks_fetched, port1.changed) == (want1.chunks_fetched, want1.changed)
    # 'a' (7 chunks) synced by chunk in the reference, whole in the port
    assert (want2.chunks_fetched, want2.bytes_fetched) == (1 + 2 + 4, 64 + 80 + 200)
    assert (port2.chunks_fetched, port2.bytes_fetched) == (7 + 2 + 4, 400 + 80 + 200)
    assert want2.changed[("a", 0)] == [0] and port2.changed[("a", 0)] == list(range(7))
    assert (port2.leaves, port2.chunks_total) == (want2.leaves, want2.chunks_total) == (3, 13)
    with pytest.raises(RuntimeError, match="never synced"):
        ref_m.snapshot()
    snap = port_m.snapshot()
    for k, v in states[1].items():
        assert np.array_equal(snap[(k, 0)]["data"], v.reshape(-1).view(np.uint8)), k
        assert snap[(k, 0)]["digests"] == _host_digests(v.reshape(-1).view(np.uint8), cb), k
