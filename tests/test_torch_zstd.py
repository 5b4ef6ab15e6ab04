"""PyTorch port: zstd on the streamed transport, against the reference.

The cases of ``tests/remote/test_zstd_gating.py`` and the zstd cases of
``tests/remote/test_transport.py`` run again on the port's
``remote.transport``: ``compress=True`` without ``zstandard`` is a clear
error, ``compress=None`` degrades to raw frames, a ``zstd-dict`` frame
without a registered dictionary fails loudly, and a trained dictionary
round-trips. ``zstd`` and ``zstd-dict`` frames encoded by either package
decode in the other to the same bytes, and the frames themselves are
equal. The cases that need the real codec skip where ``zstandard`` is
missing (the card's machine has none).
"""
import numpy as np
import pytest

from repro.proxy.segments import PrivateTable as RefPrivateTable
from repro.remote import transport as ref_transport
from repro_torch.proxy.segments import PrivateTable
from repro_torch.remote import transport as transport_mod
from repro_torch.remote.transport import (
    apply_chunk_frame,
    encode_chunk_frames,
    make_transport,
    train_chunk_dict,
)

CB = 1 << 8


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((64, 16)).astype(np.float32),
        "b": rng.standard_normal((16,)).astype(np.float32),
    }


def _repetitive():
    """Content a dictionary has something to learn from."""
    return {"w": np.tile(np.arange(64, dtype=np.uint8), 256)}


@pytest.fixture
def no_zstd(monkeypatch):
    monkeypatch.setattr(transport_mod, "_zstd", lambda: None)


# -- availability gating (tests/remote/test_zstd_gating.py, on the port) --------

def test_compress_true_without_zstd_is_a_clear_error(no_zstd):
    t = PrivateTable.create(_state())
    with pytest.raises(RuntimeError, match="zstandard is not installed"):
        encode_chunk_frames(t, t.all_chunks(CB), CB, compress=True)


def test_compress_auto_without_zstd_passes_raw(no_zstd):
    src = PrivateTable.create(_state())
    dst = PrivateTable.attach(src.layout)
    frames, raw, wire = encode_chunk_frames(
        src, src.all_chunks(CB), CB, compress=None
    )
    assert wire == raw  # nothing compressed, nothing inflated
    assert all(f["codec"] == "raw" for f in frames)
    for f in frames:
        apply_chunk_frame(dst, f, CB)
    np.testing.assert_array_equal(dst.view("w"), src.view("w"))


def test_zstd_frame_without_zstd_receiver_is_a_clear_error(no_zstd):
    t = PrivateTable.create(_state())
    with pytest.raises(RuntimeError, match="zstandard is not installed"):
        apply_chunk_frame(
            t, {"codec": "zstd", "items": [["w", 0, CB]], "data": b"x"}, CB
        )


def test_train_chunk_dict_without_zstd_returns_none(no_zstd):
    t = PrivateTable.create(_state())
    assert train_chunk_dict(t, CB) is None


def test_make_transport_train_dict_degrades_without_zstd(no_zstd):
    tr = make_transport("stream", _state(), CB, train_dict=True)
    assert tr.zdict is None
    assert "zdict" not in tr.register_fields()
    tr.close(unlink=True)


def test_stream_transport_counts_frames_and_chunks():
    tr = make_transport("stream", _state(), CB, compress=False)
    frames = tr.payload_frames(None)
    assert tr.frames_tx == len(frames)
    assert tr.chunks_tx == sum(len(f["items"]) for f in frames)
    # coalescing: far fewer frames than chunks for small-chunk states
    assert tr.frames_tx < tr.chunks_tx
    for f in frames:
        tr.on_chunks({"type": "CHUNKS", **f})
    assert tr.frames_rx == len(frames)
    assert tr.chunks_rx == tr.chunks_tx
    stats = tr.stats()
    assert stats["frames_tx"] == tr.frames_tx
    assert stats["chunks_rx"] == tr.chunks_rx
    tr.close(unlink=True)


# -- the real codec (tests/remote/test_{zstd_gating,transport}.py) --------------

def _trained(src):
    zdict = train_chunk_dict(src, CB)
    if zdict is None:
        pytest.skip("samples too small to train a dictionary")
    return zdict


def test_dict_codec_roundtrip():
    pytest.importorskip("zstandard")
    src = PrivateTable.create(_repetitive())
    zdict = _trained(src)
    frames, raw, wire = encode_chunk_frames(
        src, src.all_chunks(CB), CB, compress=True, dict_bytes=zdict
    )
    assert any(f["codec"] == "zstd-dict" for f in frames)
    assert wire < raw
    dst = PrivateTable.attach(src.layout)
    for f in frames:
        apply_chunk_frame(dst, f, CB, dict_bytes=zdict)
    np.testing.assert_array_equal(dst.view("w"), src.view("w"))


def test_dict_frame_without_registered_dict_is_a_clear_error():
    pytest.importorskip("zstandard")
    src = PrivateTable.create(_repetitive())
    zdict = _trained(src)
    frames, _, _ = encode_chunk_frames(
        src, src.all_chunks(CB), CB, compress=True, dict_bytes=zdict
    )
    frame = next(f for f in frames if f["codec"] == "zstd-dict")
    dst = PrivateTable.attach(src.layout)
    with pytest.raises(RuntimeError, match="no trained dictionary"):
        apply_chunk_frame(dst, frame, CB)


def test_zstd_per_frame_when_available():
    pytest.importorskip("zstandard")
    t = PrivateTable.create({"w": np.zeros(4 * CB, np.uint8)})
    frames, raw, wire = encode_chunk_frames(t, t.all_chunks(CB), CB, compress=True)
    assert wire < raw
    assert all(f["codec"] == "zstd" for f in frames)
    dst = PrivateTable.attach(t.layout)
    for f in frames:
        apply_chunk_frame(dst, f, CB)
    np.testing.assert_array_equal(dst.view("w"), t.view("w"))


def test_incompressible_frames_stay_raw_under_zstd():
    """With the codec on, a frame zstd would inflate rides raw."""
    pytest.importorskip("zstandard")
    rng = np.random.default_rng(3)
    t = PrivateTable.create({"w": rng.integers(0, 256, 4 * CB).astype(np.uint8)})
    frames, raw, wire = encode_chunk_frames(t, t.all_chunks(CB), CB, compress=True)
    assert wire == raw and all(f["codec"] == "raw" for f in frames)


# -- across packages -------------------------------------------------------------

_CODECS = ["zstd", "zstd-dict"]


@pytest.mark.parametrize("codec", _CODECS)
@pytest.mark.parametrize("encoder", ["port", "reference"])
def test_zstd_frames_of_either_package_decode_in_the_other(codec, encoder):
    pytest.importorskip("zstandard")
    state = dict(_repetitive(), z=np.zeros(4 * CB, np.uint8))
    port_src, ref_src = PrivateTable.create(state), RefPrivateTable.create(state)
    zdict = _trained(port_src) if codec == "zstd-dict" else None
    port_frames, port_raw, port_wire = encode_chunk_frames(
        port_src, port_src.all_chunks(CB), CB, compress=True, dict_bytes=zdict)
    ref_frames, ref_raw, ref_wire = ref_transport.encode_chunk_frames(
        ref_src, ref_src.all_chunks(CB), CB, compress=True, dict_bytes=zdict)
    assert port_frames == ref_frames and (port_raw, port_wire) == (ref_raw, ref_wire)
    assert any(f["codec"] == codec for f in port_frames) and port_wire < port_raw
    if encoder == "port":
        frames, dst, apply = port_frames, RefPrivateTable.attach(port_src.layout), \
            ref_transport.apply_chunk_frame
    else:
        frames, dst, apply = ref_frames, PrivateTable.attach(ref_src.layout), \
            apply_chunk_frame
    for f in frames:
        apply(dst, f, CB, dict_bytes=zdict)
    for path in state:
        np.testing.assert_array_equal(dst.view(path), port_src.view(path))
