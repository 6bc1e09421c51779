"""The port's wire protocol (repro_torch/engine/ingest.py) against the
reference's (repro/engine/ingest.py).

Twins of every test in tests/test_ingest.py, run on the port's module:
exact round-trips through bit-packing at awkward shapes, incremental
decoding across arbitrary chunk boundaries, and ProtocolErrors on every
kind of corruption.  Beside them, the two packages' frames are held
byte-identical for the same seeded inputs, and each side decodes what the
other encoded, so clients and servers of either package interoperate."""

import json
import math

import numpy as np
import pytest

from repro.engine import ingest as ref

from repro_torch.engine import ingest


def _raster(rng, t, n):
    return (rng.random((t, n)) < 0.3).astype(np.float32)


# ------------------------------------------------------------- round-trips

@pytest.mark.parametrize("t,n", [(1, 1), (3, 7), (13, 17), (30, 64), (8, 8)])
def test_request_roundtrip_bit_exact(rng, t, n):
    """[T, n_in] rasters survive bit-packing exactly, including shapes
    whose T*n_in is not a multiple of 8."""
    stream = _raster(rng, t, n)
    frame = ingest.FrameDecoder().feed(
        ingest.encode_request(7, stream, 0.25))[0]
    assert frame.kind == ingest.KIND_REQUEST
    req_id, out, slack, model = ingest.decode_request(frame.payload)
    assert req_id == 7 and slack == 0.25 and model is None
    assert out.shape == (t, n) and out.dtype == np.float32
    assert np.array_equal(out, stream)


def test_request_roundtrip_carries_model_name(rng):
    """v2 frames route to a named tenant; the name survives utf-8 intact."""
    stream = _raster(rng, 6, 10)
    frame = ingest.FrameDecoder().feed(
        ingest.encode_request(9, stream, 0.5, model="conv-µ"))[0]
    assert frame.version == ingest.VERSION
    req_id, out, slack, model = ingest.decode_request(frame.payload)
    assert (req_id, slack, model) == (9, 0.5, "conv-µ")
    assert np.array_equal(out, stream)
    assert ingest.peek_request(frame.payload) == (9, 6, 10, 0.5, "conv-µ")


def test_v1_request_roundtrip_still_accepted(rng):
    """Deployed v1 sensors keep working: no model id on the wire, decoded
    as model=None (the registry default)."""
    stream = _raster(rng, 5, 8)
    frame = ingest.FrameDecoder().feed(
        ingest.encode_request(4, stream, 2.0, version=1))[0]
    assert frame.version == 1
    req_id, out, slack, model = ingest.decode_request(frame.payload,
                                                      frame.version)
    assert (req_id, slack, model) == (4, 2.0, None)
    assert np.array_equal(out, stream)
    # v1 cannot carry a model id; asking for one is a caller bug.
    with pytest.raises(ingest.ProtocolError, match="v1"):
        ingest.encode_request(4, stream, model="mlp", version=1)


@pytest.mark.parametrize("bad", [
    dict(model="x" * 256),          # one byte past the u8 name length
    dict(model="µ" * 128),          # 256 utf-8 bytes from 128 characters
    dict(version=3),                # no such wire version
])
def test_request_encoder_refuses(rng, bad):
    with pytest.raises(ingest.ProtocolError, match="255|version 3"):
        ingest.encode_request(0, _raster(rng, 2, 2), **bad)


def test_model_name_of_255_bytes_accepted(rng):
    """The cap counts utf-8 bytes: 255 of them still fit the u8 length."""
    name = "a" + "µ" * 127
    assert len(name.encode()) == 255
    frame = ingest.FrameDecoder().feed(
        ingest.encode_request(1, _raster(rng, 2, 3), model=name))[0]
    assert ingest.peek_request(frame.payload)[4] == name


def test_request_default_slack_is_inf(rng):
    frame = ingest.FrameDecoder().feed(
        ingest.encode_request(0, _raster(rng, 4, 5)))[0]
    assert frame.kind == ingest.KIND_REQUEST
    _, _, slack, _ = ingest.decode_request(frame.payload)
    assert math.isinf(slack)


def test_peek_request_reads_header_without_unpacking(rng):
    """The server validates the claimed [T, n_in] against its model before
    committing to the decode; peek must agree with the full decode and
    still reject truncated headers."""
    frame = ingest.FrameDecoder().feed(
        ingest.encode_request(3, _raster(rng, 5, 9), 1.5))[0]
    assert ingest.peek_request(frame.payload) == (3, 5, 9, 1.5, None)
    with pytest.raises(ingest.ProtocolError):
        ingest.peek_request(frame.payload[:8])
    # A claimed name length past the end of the payload is corruption,
    # not an index error.
    with pytest.raises(ingest.ProtocolError, match="name truncated"):
        ingest.peek_request(frame.payload[:ingest._REQ_HEAD_V2.size - 1]
                            + b"\xff")


def test_result_roundtrip_bit_exact(rng):
    out = _raster(rng, 9, 10)
    frame = ingest.FrameDecoder().feed(ingest.encode_result(42, out))[0]
    assert frame.kind == ingest.KIND_RESULT
    req_id, got = ingest.decode_result(frame.payload)
    assert req_id == 42
    assert np.array_equal(got, out)


def test_rejection_roundtrip():
    frame = ingest.FrameDecoder().feed(
        ingest.encode_rejection(3, "queue_full: capacity 8"))[0]
    assert frame.kind == ingest.KIND_REJECT
    assert ingest.decode_rejection(frame.payload) == \
        (3, "queue_full: capacity 8")


def test_admin_roundtrip():
    """The control plane is JSON over an ADMIN frame, req_id echoed."""
    body = {"op": "swap", "model": "mlp", "seed": 3}
    frame = ingest.FrameDecoder().feed(ingest.encode_admin(11, body))[0]
    assert frame.kind == ingest.KIND_ADMIN
    assert ingest.decode_admin(frame.payload) == (11, body)


@pytest.mark.parametrize("payload,match", [
    (b"\x00\x00\x00\x01not json", "JSON"),
    (b"\x00\x00\x00\x01\xff\xfe", "JSON"),          # not utf-8 either
    (b"\x00\x00\x00\x01[1, 2]", "object"),
    (b"\x00\x00", "truncated"),
])
def test_admin_rejects_non_json_and_non_object(payload, match):
    with pytest.raises(ingest.ProtocolError, match=match):
        ingest.decode_admin(payload)


# ------------------------------------------------------ incremental decode

@pytest.mark.parametrize("chunk_size", [1, 2, 7, 64, None])
def test_decoder_handles_arbitrary_chunk_boundaries(rng, chunk_size):
    """Frames come out whole no matter how the transport splits the bytes
    — including a one-byte-at-a-time trickle (None: the whole wire in one
    chunk)."""
    blobs = [ingest.encode_request(i, _raster(rng, 3 + i, 11), float(i))
             for i in range(5)]
    wire = b"".join(blobs)
    step = chunk_size or len(wire)
    dec = ingest.FrameDecoder()
    frames = []
    for off in range(0, len(wire), step):
        frames.extend(dec.feed(wire[off:off + step]))
    assert len(frames) == 5
    assert dec.pending_bytes == 0
    for i, frame in enumerate(frames):
        req_id, stream, slack, _ = ingest.decode_request(frame.payload)
        assert req_id == i and slack == float(i)
        assert stream.shape == (3 + i, 11)


def test_decoder_holds_a_partial_frame(rng):
    """A frame cut anywhere stays buffered until its last byte arrives."""
    wire = ingest.encode_request(2, _raster(rng, 4, 6), 0.5, model="m")
    for cut in (1, ingest._HEADER.size - 1, ingest._HEADER.size,
                len(wire) - 1):
        dec = ingest.FrameDecoder()
        assert dec.feed(wire[:cut]) == []
        assert dec.pending_bytes == cut
        frames = dec.feed(wire[cut:])
        assert len(frames) == 1 and dec.pending_bytes == 0
        assert ingest.peek_request(frames[0].payload)[0] == 2


def test_decoder_emits_multiple_frames_per_chunk(rng):
    wire = (ingest.encode_rejection(1, "a") + ingest.encode_rejection(2, "b")
            + ingest.encode_rejection(3, "c"))
    frames = ingest.FrameDecoder().feed(wire)
    assert [ingest.decode_rejection(f.payload)[0] for f in frames] == \
        [1, 2, 3]


# ------------------------------------------------------------- corruption

def test_bad_magic_raises():
    with pytest.raises(ingest.ProtocolError, match="magic"):
        ingest.FrameDecoder().feed(b"XX" + b"\x00" * 10)


@pytest.mark.parametrize("version", [0, ingest.VERSION + 1, 255])
def test_bad_version_raises(version):
    wire = bytearray(ingest.encode_rejection(0, "ok"))
    wire[2] = version
    with pytest.raises(ingest.ProtocolError, match="version"):
        ingest.FrameDecoder().feed(bytes(wire))


def test_absurd_length_prefix_raises():
    wire = ingest._HEADER.pack(ingest.MAGIC, ingest.VERSION,
                               ingest.KIND_REQUEST, ingest.MAX_PAYLOAD + 1)
    with pytest.raises(ingest.ProtocolError, match="length"):
        ingest.FrameDecoder().feed(wire)


@pytest.mark.parametrize("case", ["header", "raster", "extra_raster",
                                  "result", "reject", "v1_header",
                                  "name_utf8"])
def test_truncated_payloads_raise(rng, case):
    full = ingest.FrameDecoder().feed(
        ingest.encode_request(0, _raster(rng, 4, 9)))[0].payload
    v1 = ingest.FrameDecoder().feed(
        ingest.encode_request(0, _raster(rng, 4, 9), version=1))[0].payload
    with pytest.raises(ingest.ProtocolError):
        if case == "header":
            ingest.decode_request(full[:8])          # header cut short
        elif case == "raster":
            ingest.decode_request(full[:-1])         # raster bytes missing
        elif case == "extra_raster":
            ingest.decode_request(full + b"\x00")    # one byte too many
        elif case == "result":
            ingest.decode_result(b"\x00\x00")
        elif case == "reject":
            ingest.decode_rejection(b"\x01")
        elif case == "v1_header":
            ingest.decode_request(v1[:ingest._REQ_HEAD_V1.size - 1], 1)
        else:                                        # a name that is not utf-8
            head = ingest._REQ_HEAD_V2.pack(0, 1, 1, 0.0, 1)
            ingest.decode_request(head + b"\xff" + b"\x00")


def test_decoder_reset_recovers_after_corruption(rng):
    """A length-prefixed stream cannot resync after corruption: the bad
    bytes stay buffered and every later feed re-raises — until reset()
    discards them, after which the decoder parses clean frames again."""
    dec = ingest.FrameDecoder()
    with pytest.raises(ingest.ProtocolError):
        dec.feed(b"XX" + b"\x00" * 10)
    good = ingest.encode_request(5, _raster(rng, 3, 4), 1.0)
    with pytest.raises(ingest.ProtocolError):
        dec.feed(good)                   # still poisoned by buffered bytes
    assert dec.reset() > 0               # reports how much it threw away
    frames = dec.feed(good)              # same decoder, clean slate
    assert len(frames) == 1
    assert ingest.peek_request(frames[0].payload)[0] == 5
    assert dec.reset() == 0              # idempotent on an empty buffer


def test_protocol_constants_equal_the_reference():
    for name in ("MAGIC", "VERSION", "SUPPORTED_VERSIONS", "KIND_REQUEST",
                 "KIND_RESULT", "KIND_REJECT", "KIND_ADMIN", "MAX_PAYLOAD"):
        assert getattr(ingest, name) == getattr(ref, name), name
    for name in ("_HEADER", "_REQ_HEAD_V1", "_REQ_HEAD_V2", "_RES_HEAD",
                 "_REJ_HEAD", "_ADM_HEAD"):
        assert getattr(ingest, name).format == getattr(ref, name).format
    assert issubclass(ingest.ProtocolError, ValueError)


# ------------------------------------------- byte identity, cross-decoding

def _frames(seed):
    """(label, encoder name, args, kwargs) of every frame kind, on seeded
    rasters at awkward shapes."""
    rng = np.random.default_rng(seed)
    t, n = int(rng.integers(1, 40)), int(rng.integers(1, 70))
    stream = _raster(rng, t, n)
    slack = float(rng.random())
    return [
        ("v1", "encode_request", (1, stream, slack), dict(version=1)),
        ("v1_inf", "encode_request", (2, stream), dict(version=1)),
        ("v2_default", "encode_request", (3, stream, slack), {}),
        ("v2_named", "encode_request", (4, stream, slack),
         dict(model="cifar")),
        ("v2_non_ascii", "encode_request", (5, stream, math.inf),
         dict(model="conv-µ-视觉")),
        ("v2_max_name", "encode_request", (6, stream, slack),
         dict(model="n" * 255)),
        ("result", "encode_result", (7, _raster(rng, t, 10)), {}),
        ("reject", "encode_rejection", (8, "bad_shape: µ width 3 != 4"), {}),
        ("admin_swap", "encode_admin",
         (9, {"op": "swap", "model": "cifar", "seed": 3}), {}),
        ("admin_reply", "encode_admin",
         (2 ** 32 - 1, {"ok": True, "metrics": {"z": 1.5, "a": [1, 2],
                                                "per_model": {"b": 0,
                                                              "a": 0.25}},
                        "models": {"µ": 2}}), {}),
    ]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frames_byte_identical_to_the_reference(seed):
    for label, fn, args, kw in _frames(seed):
        got = getattr(ingest, fn)(*args, **kw)
        want = getattr(ref, fn)(*args, **kw)
        assert isinstance(got, bytes)
        assert got == want, label


def test_admin_body_is_sorted_json():
    body = {"op": "metrics", "b": 1, "a": {"y": 2, "x": 1}}
    payload = ingest.encode_admin(0, body)[ingest._HEADER.size:]
    assert payload[ingest._ADM_HEAD.size:] == \
        json.dumps(body, sort_keys=True).encode()


def _decode(mod, frame):
    """Everything a frame carries, decoded by ``mod``'s functions."""
    if frame.kind == mod.KIND_REQUEST:
        req_id, stream, slack, model = mod.decode_request(frame.payload,
                                                          frame.version)
        return ("request", frame.version, req_id, stream.shape,
                stream.tobytes(), slack, model,
                mod.peek_request(frame.payload, frame.version))
    if frame.kind == mod.KIND_RESULT:
        req_id, out = mod.decode_result(frame.payload)
        return ("result", req_id, out.shape, out.tobytes())
    if frame.kind == mod.KIND_REJECT:
        return ("reject",) + mod.decode_rejection(frame.payload)
    return ("admin",) + mod.decode_admin(frame.payload)


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
@pytest.mark.parametrize("chunk", [1, 13, 1 << 16])
def test_cross_decoding(direction, chunk):
    """A stream of every frame kind encoded by one package, fed to the
    other's FrameDecoder at a chunk size, decodes to exactly what the
    encoder's own package decodes it to."""
    enc, dec = (ref, ingest) if direction == "reference_to_port" \
        else (ingest, ref)
    specs = _frames(7)
    wire = b"".join(getattr(enc, fn)(*args, **kw)
                    for _, fn, args, kw in specs)
    decoder = dec.FrameDecoder()
    frames = []
    for off in range(0, len(wire), chunk):
        frames.extend(decoder.feed(wire[off:off + chunk]))
    assert decoder.pending_bytes == 0
    own = enc.FrameDecoder().feed(wire)
    assert len(frames) == len(own) == len(specs)
    for (label, *_), got, want in zip(specs, frames, own):
        assert (got.kind, got.version, got.payload) == \
            (want.kind, want.version, want.payload), label
        assert _decode(dec, got) == _decode(enc, want), label


@pytest.mark.parametrize("wire", [
    b"XX" + b"\x00" * 10,
    b"MG\x07\x00" + b"\x00" * 8,
    b"MG\x02\x00" + (ingest.MAX_PAYLOAD + 1).to_bytes(4, "big"),
])
def test_both_decoders_refuse_the_same_corruption(wire):
    for mod in (ref, ingest):
        dec = mod.FrameDecoder()
        with pytest.raises(mod.ProtocolError):
            dec.feed(wire)
        assert dec.reset() == len(wire)
