"""PyTorch port: the proxy's wire framing and data plane, against the reference.

The port's frames (``coord.protocol``), causal trace contexts
(``obs.trace``), state tables (``proxy.segments``) and chunk transport
(``remote.transport``) are held against the JAX reference: the same dict
packs to the same frame bytes and each side reads the other's frames; a
table's layout is the same, so either package attaches the other's
segments. The cases of ``tests/proxy/test_segments.py`` and the non-zstd
cases of ``tests/remote/test_transport.py`` run again on the port's
modules. Bytes are compared exactly.
"""
import socket

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.coord import protocol as ref_protocol
from repro.obs import trace as ref_trace
from repro.proxy.segments import SegmentTable as RefSegmentTable
from repro_torch.coord import protocol
from repro_torch.core import ShadowStateManager
from repro_torch.models.convert import array_to_tensor
from repro_torch.obs import trace
from repro_torch.proxy.segments import PrivateTable, SegmentTable
from repro_torch.remote import transport
from repro_torch.remote.transport import (
    FRAME_PAYLOAD_BYTES,
    apply_chunk_frame,
    encode_chunk_frames,
    endpoint_arg,
    make_proxy_table,
    make_transport,
    train_chunk_dict,
)
from repro_torch.utils.tree import tree_equal

CB = 1 << 8

FRAMES = [
    {"type": "STEP", "step": 7},
    {"type": "SYNC", "epoch": 3, "ctx": {"trace": "round:4", "span": (1 << 62) + 5,
                                         "parent": 11}},
    {"type": "SYNCED", "step": 12, "digest": "ab" * 8, "metrics": {"loss": 2.5},
     "chunks_synced": 3, "bytes_synced": 1 << 20, "epoch": 1,
     "phase_us": {"step": 10.5, "steps": 2, "prehashed_chunks": 0},
     "chunk_digests": {"w": [0, 1, (1 << 64) - 1, 1 << 33], "b": [-1]}},
    {"type": "CHUNKS", "codec": "raw", "items": [["w", 0, 70000], ["b", 1, 3]],
     "data": bytes(range(256)) * 273 + b"xyz"},
    {"type": "REGISTER", "layout": {f"leaf{i}": {"nbytes": i, "shape": [i], "dtype": "bfloat16"}
                                    for i in range(20)},
     "workdir": "d" * 300, "fused_digests": True, "device_capacity_bytes": None,
     "zdict": b"", "neg": [-1, -33, -200, -40000, -(1 << 40)], "flags": [True, False]},
]


def _frame_bytes(send, msg) -> bytes:
    a, b = socket.socketpair()
    try:
        send(a, msg)
        a.close()
        out = bytearray()
        while piece := b.recv(1 << 20):
            out += piece
        return bytes(out)
    finally:
        b.close()


@pytest.mark.parametrize("msg", FRAMES, ids=[f["type"] for f in FRAMES])
def test_frames_pack_to_the_reference_bytes(msg):
    got = _frame_bytes(protocol.send_frame, msg)
    assert got == _frame_bytes(ref_protocol.send_frame, msg)


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_connections_read_each_others_frames(direction):
    a, b = socket.socketpair()
    mods = (ref_protocol, protocol) if direction == "ref_to_port" else (protocol, ref_protocol)
    sender, receiver = mods[0].Connection(a), mods[1].Connection(b)
    try:
        for msg in FRAMES:
            fields = {k: v for k, v in msg.items() if k != "type"}
            sender.send(msg["type"], **fields)
            assert receiver.recv() == msg
        sender.close()
        assert receiver.recv() is None  # EOF
    finally:
        receiver.close()


def test_frame_size_limit_and_corrupt_header():
    assert protocol.MAX_FRAME == ref_protocol.MAX_FRAME
    a, b = socket.socketpair()
    try:
        with pytest.raises(ValueError, match="too large"):
            protocol.send_frame(a, {"data": b"x" * (protocol.MAX_FRAME + 1)})
        a.sendall((protocol.MAX_FRAME + 1).to_bytes(4, "little"))
        with pytest.raises(ValueError, match="corrupt"):
            protocol.Connection(b).recv()
    finally:
        a.close()
        b.close()


def test_trace_contexts_match_the_reference():
    assert trace.round_trace_id(12) == ref_trace.round_trace_id(12) == "round:12"
    for kw in ({}, {"parent": 3}, {"span": 7}, {"parent": 3, "span": 7}):
        got, want = trace.span_context("t", **kw), ref_trace.span_context("t", **kw)
        assert got.keys() == want.keys()
        if "span" in kw:
            assert got == want
    ctx = trace.span_context("round:1", parent=5, span=9)
    assert trace.child_span(None) is None and trace.child_span({}) is None
    child = trace.child_span(ctx)
    assert child["trace"] == "round:1" and child["parent"] == 9
    assert 0 < child["span"] < 1 << 63 and child["span"] % 2 == 1
    assert trace.new_span_id() % 2 == 1
    for c in (None, {}, {"trace": "x"}, ctx, {"trace": "y", "span": 4}):
        assert trace.ctx_args(c) == ref_trace.ctx_args(c)


def test_untraced_frames_carry_no_ctx():
    """A frame sent without a context has no ``ctx`` key: the bytes of the
    untraced wire format do not change."""
    msg = {"type": "STEP", "step": 3}
    assert _frame_bytes(protocol.send_frame, msg) == \
        _frame_bytes(ref_protocol.send_frame, {"type": "STEP", "step": 3})
    assert trace.child_span(None) is None


# -- segments (tests/proxy/test_segments.py, on the port) ----------------------

def _state():
    return {
        "w": np.arange(1024, dtype=np.float32),
        "nested": {"b": np.ones((16,), np.float32),
                   "step": np.zeros((), np.int32)},
    }


def _bf16_state(rng):
    """bfloat16 leaves as the port holds them (CPU tensors) beside numpy ones,
    and the same values as the reference holds them (ml_dtypes arrays)."""
    ref = {
        "p": rng.standard_normal((33, 7)).astype(np.float32).astype(ml_dtypes.bfloat16),
        "s": np.asarray(rng.standard_normal(), np.float32).astype(ml_dtypes.bfloat16),
        "m": rng.standard_normal((5, 3)).astype(np.float32),
        "e": np.zeros((0, 4), ml_dtypes.bfloat16),
        "k": np.asarray(4, np.int32),
    }
    port = {k: (array_to_tensor(v) if v.dtype == ml_dtypes.bfloat16 else v)
            for k, v in ref.items()}
    return ref, port


def test_create_read_roundtrip(tmp_path):
    s = _state()
    t = SegmentTable.create(s, workdir=str(tmp_path))
    out = t.read_state()
    assert tree_equal(s, out)
    t.close()


def test_bf16_leaves_round_trip_as_tensors_by_their_bytes(tmp_path, rng):
    _, s = _bf16_state(rng)
    t = SegmentTable.create(s, workdir=str(tmp_path))
    out = t.read_state()
    assert tree_equal(s, out)
    assert isinstance(out["p"], torch.Tensor) and out["p"].dtype == torch.bfloat16
    assert isinstance(out["m"], np.ndarray) and out["m"].dtype == np.float32
    assert t.layout["p"]["dtype"] == "bfloat16" and t.layout["s"]["shape"] == []
    # a copy, not a view: later writes to the table leave it alone
    t.view("p")[:] = 0
    assert tree_equal(s["p"], out["p"])
    t.close()


def test_layouts_and_bytes_match_the_reference_both_ways(tmp_path, rng):
    ref_state, port_state = _bf16_state(rng)
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref_t = RefSegmentTable.create(ref_state, workdir=str(tmp_path / "ref"))
    port_t = SegmentTable.create(port_state, workdir=str(tmp_path / "port"))
    assert port_t.layout == ref_t.layout
    # each package attaches the other's segments and sees the same bytes
    port_on_ref = SegmentTable.attach(str(tmp_path / "ref"), ref_t.layout)
    ref_on_port = RefSegmentTable.attach(str(tmp_path / "port"), port_t.layout)
    for path in ref_t.layout:
        assert np.array_equal(port_on_ref.view(path), ref_t.view(path)), path
        assert np.array_equal(ref_on_port.view(path), port_t.view(path)), path
    for t in (port_on_ref, ref_on_port, ref_t, port_t):
        t.close()


def test_attach_sees_writes_from_creator(tmp_path):
    s = _state()
    creator = SegmentTable.create(s, workdir=str(tmp_path))
    attached = SegmentTable.attach(str(tmp_path), creator.layout)
    assert np.array_equal(
        attached.view("w").view(np.float32), np.arange(1024, dtype=np.float32)
    )
    s2 = dict(s)
    s2["w"] = s["w"] * 2
    creator.write_state(s2)
    assert np.array_equal(attached.view("w").view(np.float32), np.asarray(s2["w"]))
    attached.close()
    creator.close()


def test_write_state_rejects_shape_changes(tmp_path):
    s = _state()
    t = SegmentTable.create(s, workdir=str(tmp_path))
    bad = dict(s)
    bad["w"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="re-register"):
        t.write_state(bad)
    t.close()


def test_shadow_segment_factory_shares_pages(tmp_path):
    """Shadow buffers allocated through the factory ARE the segments: a
    shadow sync on one side is visible to a plain attach on the other."""
    s = {"w": torch.arange(256, dtype=torch.float32)}
    table = SegmentTable.create(s, workdir=str(tmp_path))
    table.view("w")[:] = 0
    sh = ShadowStateManager(chunk_bytes=256, segment_factory=table.factory)
    sh.register(s)
    sh.sync(s)
    peer = SegmentTable.attach(str(tmp_path), table.layout)
    assert np.array_equal(peer.view("w").view(np.float32), s["w"].numpy())
    peer.close()
    table.close()


def test_factory_rejects_mismatched_sizes(tmp_path):
    s = {"w": np.arange(16, dtype=np.float32)}
    t = SegmentTable.create(s, workdir=str(tmp_path))
    with pytest.raises(ValueError):
        t.factory(("w", 0), 9999)
    with pytest.raises(ValueError):
        t.factory(("w", 1), 64)  # non-zero shard ordinal
    t.close()


def test_write_chunks_delta_and_bounds(tmp_path):
    s = {"w": np.arange(256, dtype=np.float32)}  # 1024B, 4 chunks of 256
    t = SegmentTable.create(s, workdir=str(tmp_path))
    base_bytes = t.bytes_written
    s2 = {"w": np.array(s["w"])}
    s2["w"][70] = -1.0  # chunk 1
    written = t.write_chunks(s2, {"w": [1]}, 256)
    assert written == 256
    assert t.bytes_written == base_bytes + 256
    got = t.view("w").view(np.float32)
    assert got[70] == -1.0
    assert np.array_equal(got[:64], s["w"][:64])  # chunk 0 untouched
    with pytest.raises(IndexError):
        t.write_chunks(s2, {"w": [-1]}, 256)
    with pytest.raises(IndexError):
        t.write_chunks(s2, {"w": [4]}, 256)
    with pytest.raises(KeyError):
        t.write_chunks(s2, {"nope": [0]}, 256)
    t.close()


# -- transport (tests/remote/test_transport.py, non-zstd, on the port) ---------

def _tstate(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((64, 16)).astype(np.float32),
        "b": rng.standard_normal((16,)).astype(np.float32),
    }


def test_frame_roundtrip_private_tables():
    state = _tstate()
    src = PrivateTable.create(state)
    dst = PrivateTable.attach(src.layout)
    frames, raw, wire = encode_chunk_frames(src, src.all_chunks(CB), CB)
    assert raw == src.total_bytes()
    for f in frames:
        apply_chunk_frame(dst, {"type": "CHUNKS", **f}, CB)
    for path in src.layout:
        np.testing.assert_array_equal(dst.view(path), src.view(path))


def test_delta_frames_carry_only_named_chunks():
    state = _tstate()
    src = PrivateTable.create(state)
    dst = PrivateTable.attach(src.layout)
    for f in encode_chunk_frames(src, src.all_chunks(CB), CB)[0]:
        apply_chunk_frame(dst, f, CB)
    w = np.asarray(state["w"]).copy()
    w.reshape(-1)[0] = 123.0
    src.write_state(dict(state, w=w))
    frames, raw, wire = encode_chunk_frames(src, {"w": [0]}, CB)
    assert raw == CB  # exactly one chunk's bytes
    for f in frames:
        apply_chunk_frame(dst, f, CB)
    np.testing.assert_array_equal(dst.view("w"), src.view("w"))
    np.testing.assert_array_equal(dst.view("b"), src.view("b"))


def test_frames_batch_under_payload_target():
    big = {"w": np.zeros(3 * FRAME_PAYLOAD_BYTES, np.uint8)}
    t = PrivateTable.create(big)
    cb = 1 << 16
    frames, raw, _ = encode_chunk_frames(t, t.all_chunks(cb), cb, compress=False)
    assert raw == 3 * FRAME_PAYLOAD_BYTES
    assert len(frames) >= 3
    for f in frames:
        assert len(f["data"]) <= FRAME_PAYLOAD_BYTES + cb
        assert sum(n for _, _, n in f["items"]) == len(f["data"])


def test_incompressible_frames_fall_back_to_raw():
    rng = np.random.default_rng(3)
    t = PrivateTable.create({"w": rng.integers(0, 256, 4 * CB).astype(np.uint8)})
    frames, raw, wire = encode_chunk_frames(t, t.all_chunks(CB), CB)
    assert wire <= raw


def test_apply_frame_length_mismatch_rejected():
    t = PrivateTable.create({"w": np.zeros(2 * CB, np.uint8)})
    with pytest.raises(ValueError, match="items claim"):
        apply_chunk_frame(
            t, {"codec": "raw", "items": [["w", 0, CB]], "data": b"x" * (CB + 1)}, CB,
        )


def test_write_range_bounds_checked():
    t = PrivateTable.create({"w": np.zeros(CB, np.uint8)})
    with pytest.raises(ValueError, match="outside leaf"):
        t.write_range("w", CB - 1, b"xx")
    with pytest.raises(KeyError):
        t.write_range("nope", 0, b"x")


def test_stream_transport_sync_ingest():
    state = _tstate()
    app = make_transport("stream", state, CB)
    proxy_table = make_proxy_table({"transport": "stream", "layout": app.table.layout})
    for f in encode_chunk_frames(app.table, app.table.all_chunks(CB), CB)[0]:
        apply_chunk_frame(proxy_table, f, CB)
    w = np.asarray(state["w"]).copy()
    w.reshape(-1)[7] = 42.0
    proxy_table.write_state(dict(state, w=w))
    frames, _, _ = encode_chunk_frames(proxy_table, {"w": [0]}, CB)
    for f in frames:
        app.on_chunks({"type": "CHUNKS", **f})
    got = app.read_state()
    np.testing.assert_array_equal(got["w"], w)
    assert app.wire_rx > 0


def test_segment_transport_rejects_chunks_frames():
    app = make_transport("segment", _tstate(), CB)
    try:
        with pytest.raises(RuntimeError, match="does not expect"):
            app.on_chunks({"codec": "raw", "items": [], "data": b""})
    finally:
        app.close(unlink=True)


def test_make_proxy_table_kinds(tmp_path):
    state = _tstate()
    seg = SegmentTable.create(state, workdir=str(tmp_path))
    t = make_proxy_table({"workdir": str(tmp_path), "layout": seg.layout})
    assert isinstance(t, SegmentTable)
    np.testing.assert_array_equal(t.view("w"), seg.view("w"))
    t2 = make_proxy_table({"transport": "stream", "layout": seg.layout})
    assert isinstance(t2, PrivateTable)
    with pytest.raises(ValueError, match="unknown transport"):
        make_proxy_table({"transport": "carrier-pigeon", "layout": {}})
    seg.close(unlink=True)


def test_endpoint_arg():
    assert endpoint_arg("10.0.0.2:7070") == ("10.0.0.2", 7070)
    with pytest.raises(ValueError):
        endpoint_arg("7070")
    with pytest.raises(ValueError):
        endpoint_arg("host:")


def test_zstd_stays_optional(monkeypatch):
    """Without ``zstandard`` frames travel raw, no dictionary is trained, a
    forced ``compress=True`` and a received zstd frame raise by name."""
    monkeypatch.setattr(transport, "_zstd", lambda: None)
    t = PrivateTable.create({"w": np.zeros(4 * CB, np.uint8)})
    assert train_chunk_dict(t, CB) is None
    frames, raw, wire = encode_chunk_frames(t, t.all_chunks(CB), CB)
    assert all(f["codec"] == "raw" for f in frames) and wire == raw
    with pytest.raises(RuntimeError, match="zstandard"):
        encode_chunk_frames(t, t.all_chunks(CB), CB, compress=True)
    with pytest.raises(RuntimeError, match="zstandard"):
        apply_chunk_frame(t, {"codec": "zstd", "items": [], "data": b""}, CB)
    app = make_transport("stream", {"w": np.zeros(4 * CB, np.uint8)}, CB, train_dict=True)
    assert app.zdict is None and "zdict" not in app.register_fields()


def test_stream_frames_of_either_package_apply_to_the_other(rng):
    """CHUNKS frames encoded by one package's table apply to the other's."""
    from repro.proxy.segments import PrivateTable as RefPrivateTable
    from repro.remote import transport as ref_transport

    ref_state, port_state = _bf16_state(rng)
    ref_src = RefPrivateTable.create(ref_state)
    port_src = PrivateTable.create(port_state)
    cb = 64
    port_frames, raw, _ = encode_chunk_frames(port_src, port_src.all_chunks(cb), cb,
                                              compress=False)
    ref_frames, ref_raw, _ = ref_transport.encode_chunk_frames(
        ref_src, ref_src.all_chunks(cb), cb, compress=False)
    assert port_frames == ref_frames and raw == ref_raw
    ref_dst = RefPrivateTable.attach(port_src.layout)
    port_dst = PrivateTable.attach(ref_src.layout)
    for f in port_frames:
        ref_transport.apply_chunk_frame(ref_dst, f, cb)
    for f in ref_frames:
        apply_chunk_frame(port_dst, f, cb)
    for path in port_src.layout:
        assert np.array_equal(ref_dst.view(path), port_src.view(path)), path
        assert np.array_equal(port_dst.view(path), ref_src.view(path)), path
