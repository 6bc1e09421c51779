"""Length-prefixed wire protocol for live spike-stream ingest.

The socket front end (:mod:`repro_torch.launch.socket_serve`) feeds
:class:`~repro_torch.engine.stream_server.StreamServer` from real
connections; this module is the framing both ends speak.  It is
deliberately socket-free — pure ``bytes -> frames``, numpy and ``struct``
only, no torch and no device — so the tests exercise every byte of the
protocol without opening a port, and any transport (TCP, Unix socket,
serial link from the sensor) can carry it.  The frames are byte-identical
to those of the JAX package's ``repro.engine.ingest`` for the same inputs,
so clients and servers of either package talk to each other.

Frame layout (network byte order)::

    +----+----+---------+---------+====================+
    |'M' |'G' | ver u8  | kind u8 | len u32 | payload  |
    +----+----+---------+---------+====================+

Two wire versions are live.  **v2** (current) carries a model id on every
REQUEST, routing it to a tenant of the server's multi-tenant registry;
**v1** frames (the pre-registry protocol) are still accepted and route to
the registry's default model, so deployed edge sensors keep working
unmodified.  Encoders default to v2; :class:`FrameDecoder` accepts both and
stamps each :class:`Frame` with the version it arrived as, which is what
selects the REQUEST header layout downstream.

Kinds:

  * ``REQUEST`` — ``req_id u32, T u32, n_in u32, slack f64`` (v2 adds
    ``name_len u8`` + that many utf-8 model-name bytes; ``name_len == 0``
    means the default model) followed by the ``[T, n_in]`` 0/1 spike
    raster **bit-packed** (``np.packbits``): an event-driven edge link
    ships 1 bit per (step, neuron), 8x smaller than float32 and exactly
    round-trippable since spikes are binary.  ``slack`` is the per-request
    deadline slack in seconds (``inf`` = best-effort), mapping 1:1 onto
    ``StreamServer.submit(slack=...)``.
  * ``RESULT`` — ``req_id u32, T u32, n_out u32`` + bit-packed output
    spikes: the request's bit-exact ``RequestResult.out_spikes``.
  * ``REJECT`` — ``req_id u32`` + utf-8 reason (the server's
    :class:`~repro_torch.engine.stream_server.Rejection` reason/detail),
    so a client always learns the fate of every request it sent.
  * ``ADMIN`` (v2) — ``req_id u32`` + a utf-8 JSON object: the control
    plane.  ``{"op": "swap", "model": ..., ...}`` hot-swaps a tenant
    through the server's model factory; ``{"op": "list"}`` enumerates
    tenants; ``{"op": "metrics"}`` returns the full schema-locked
    ``ServerMetrics.snapshot()`` (``METRIC_KEYS``); ``{"op": "trace"}``
    exports the flight recorder — ``{"op": "trace", "rid": N}`` one
    request's span trace by server rid, ``{"op": "trace", "last": true}``
    the most recently completed trace, bare ``{"op": "trace"}`` the full
    recorder ``dump()`` (see ``docs/OBSERVABILITY.md``).  The server
    answers with an ADMIN frame echoing ``req_id`` and a JSON reply
    (``{"ok": true/false, ...}``).

``req_id`` is client-chosen correlation state (the server echoes it back);
it is unrelated to the server's internal rids.  :class:`FrameDecoder` is an
incremental parser: feed it arbitrary chunk boundaries (as TCP delivers
them) and complete frames come out.  After it raises
:class:`ProtocolError` the buffered bytes are corrupt beyond resync;
:meth:`FrameDecoder.reset` discards them so a caller that keeps the
decoder (or reuses a pooled one) does not re-raise forever.
"""

from __future__ import annotations

import dataclasses
import json
import math
import struct

import numpy as np

MAGIC = b"MG"
#: The version encoders emit.  v1 = the pre-multi-tenant protocol (no model
#: id); decoders accept every entry of SUPPORTED_VERSIONS.
VERSION = 2
SUPPORTED_VERSIONS = (1, 2)

KIND_REQUEST = 0
KIND_RESULT = 1
KIND_REJECT = 2
KIND_ADMIN = 3

_HEADER = struct.Struct(">2sBBI")           # magic, version, kind, payload len
_REQ_HEAD_V1 = struct.Struct(">IIId")       # req_id, T, n_in, slack
_REQ_HEAD_V2 = struct.Struct(">IIIdB")      # ... + model-name length
_RES_HEAD = struct.Struct(">III")           # req_id, T, n_out
_REJ_HEAD = struct.Struct(">I")             # req_id
_ADM_HEAD = struct.Struct(">I")             # req_id (JSON body follows)

# A [T, n_in] raster is T * n_in / 8 bytes bit-packed: a few KiB for the
# small demo models, but 100 KiB for a 25-step request at the native
# CIFAR10-DVS width (n_in = 32768), and 16 MiB at the socket server's
# 4096-step cap.  Anything near this bound is a corrupt length prefix, not
# a real request.
MAX_PAYLOAD = 1 << 26


class ProtocolError(ValueError):
    """Corrupt or incompatible framing — the connection should be closed."""


@dataclasses.dataclass(frozen=True)
class Frame:
    kind: int
    payload: bytes
    version: int = VERSION      # the wire version this frame arrived as


def _pack_bits(spikes: np.ndarray) -> bytes:
    return np.packbits((np.asarray(spikes) > 0).astype(np.uint8),
                       axis=None).tobytes()


def _unpack_bits(buf: bytes, t: int, n: int) -> np.ndarray:
    need = -(-t * n // 8)
    if len(buf) != need:
        raise ProtocolError(f"raster for [{t}, {n}] needs {need} bytes, "
                            f"got {len(buf)}")
    bits = np.unpackbits(np.frombuffer(buf, dtype=np.uint8), count=t * n)
    return bits.reshape(t, n).astype(np.float32)


def _frame(kind: int, payload: bytes, version: int = VERSION) -> bytes:
    return _HEADER.pack(MAGIC, version, kind, len(payload)) + payload


def encode_request(req_id: int, stream: np.ndarray,
                   slack: float = math.inf, *, model: str | None = None,
                   version: int = VERSION) -> bytes:
    """One client request: a ``[T, n_in]`` spike raster plus its deadline
    slack (and, on v2, the target model name — ``None`` routes to the
    server's default model), bit-packed into a single frame."""
    stream = np.asarray(stream)
    assert stream.ndim == 2, f"expected [T, n_in], got {stream.shape}"
    t, n_in = stream.shape
    if version == 1:
        if model is not None:
            raise ProtocolError("v1 frames carry no model id; "
                                "re-encode with version=2")
        head = _REQ_HEAD_V1.pack(req_id, t, n_in, float(slack))
    elif version == 2:
        name = (model or "").encode()
        if len(name) > 255:
            raise ProtocolError(f"model name {len(name)}B > 255B limit")
        head = _REQ_HEAD_V2.pack(req_id, t, n_in, float(slack),
                                 len(name)) + name
    else:
        raise ProtocolError(f"cannot encode protocol version {version}")
    return _frame(KIND_REQUEST, head + _pack_bits(stream), version=version)


def _req_head(payload: bytes, version: int):
    """Parse a REQUEST header; returns ``(req_id, t, n_in, slack, model,
    raster_offset)`` with ``model=None`` for v1 / empty-name v2 frames."""
    if version == 1:
        if len(payload) < _REQ_HEAD_V1.size:
            raise ProtocolError(
                f"request payload truncated at {len(payload)}B")
        req_id, t, n_in, slack = _REQ_HEAD_V1.unpack_from(payload)
        return req_id, t, n_in, slack, None, _REQ_HEAD_V1.size
    if len(payload) < _REQ_HEAD_V2.size:
        raise ProtocolError(f"request payload truncated at {len(payload)}B")
    req_id, t, n_in, slack, name_len = _REQ_HEAD_V2.unpack_from(payload)
    off = _REQ_HEAD_V2.size + name_len
    if len(payload) < off:
        raise ProtocolError(f"request model name truncated "
                            f"({name_len}B claimed, payload {len(payload)}B)")
    name = payload[_REQ_HEAD_V2.size:off]
    try:
        model = name.decode() or None
    except UnicodeDecodeError as e:
        raise ProtocolError(f"model name is not utf-8: {e}") from None
    return req_id, t, n_in, slack, model, off


def peek_request(payload: bytes, version: int = VERSION
                 ) -> tuple[int, int, int, float, str | None]:
    """Request header ``(req_id, T, n_in, slack, model)`` without unpacking
    the raster — what the server reads to resolve the tenant and validate
    the claimed shape against *that model* before committing to the
    ``[T, n_in]`` decode, so a well-framed request with an unknown model or
    a bogus width answers with a REJECT instead of reaching the engine."""
    return _req_head(payload, version)[:5]


def decode_request(payload: bytes, version: int = VERSION
                   ) -> tuple[int, np.ndarray, float, str | None]:
    req_id, t, n_in, slack, model, off = _req_head(payload, version)
    return req_id, _unpack_bits(payload[off:], t, n_in), slack, model


def encode_result(req_id: int, out_spikes: np.ndarray) -> bytes:
    out = np.asarray(out_spikes)
    assert out.ndim == 2, f"expected [T, n_out], got {out.shape}"
    t, n_out = out.shape
    return _frame(KIND_RESULT,
                  _RES_HEAD.pack(req_id, t, n_out) + _pack_bits(out))


def decode_result(payload: bytes) -> tuple[int, np.ndarray]:
    if len(payload) < _RES_HEAD.size:
        raise ProtocolError(f"result payload truncated at {len(payload)}B")
    req_id, t, n_out = _RES_HEAD.unpack_from(payload)
    return req_id, _unpack_bits(payload[_RES_HEAD.size:], t, n_out)


def encode_rejection(req_id: int, reason: str) -> bytes:
    return _frame(KIND_REJECT, _REJ_HEAD.pack(req_id) + reason.encode())


def decode_rejection(payload: bytes) -> tuple[int, str]:
    if len(payload) < _REJ_HEAD.size:
        raise ProtocolError(f"reject payload truncated at {len(payload)}B")
    (req_id,) = _REJ_HEAD.unpack_from(payload)
    return req_id, payload[_REJ_HEAD.size:].decode()


def encode_admin(req_id: int, body: dict) -> bytes:
    """A control-plane frame (v2-only): ``body`` is a JSON-serializable
    object — a request (``{"op": "swap", ...}``) or the server's reply."""
    payload = _ADM_HEAD.pack(req_id) + json.dumps(
        body, sort_keys=True).encode()
    return _frame(KIND_ADMIN, payload)


def decode_admin(payload: bytes) -> tuple[int, dict]:
    if len(payload) < _ADM_HEAD.size:
        raise ProtocolError(f"admin payload truncated at {len(payload)}B")
    (req_id,) = _ADM_HEAD.unpack_from(payload)
    try:
        body = json.loads(payload[_ADM_HEAD.size:].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"admin body is not JSON: {e}") from None
    if not isinstance(body, dict):
        raise ProtocolError(f"admin body must be an object, "
                            f"got {type(body).__name__}")
    return req_id, body


class FrameDecoder:
    """Incremental frame parser over an arbitrary byte stream.

    ``feed(chunk)`` buffers and returns every frame completed by that
    chunk (possibly none, possibly several) — chunk boundaries are
    whatever the transport delivered.  Corrupt magic, an unknown version,
    or an absurd length prefix raise :class:`ProtocolError`; the caller
    should drop the connection (there is no way to resynchronize a
    length-prefixed stream after corruption) and must call :meth:`reset`
    before reusing the decoder — the corrupt bytes stay buffered, so
    without a reset every later ``feed`` re-raises on them."""

    def __init__(self):
        self._buf = bytearray()

    @property
    def pending_bytes(self) -> int:
        return len(self._buf)

    def reset(self) -> int:
        """Discard the buffer (corrupt beyond resync after a
        :class:`ProtocolError`).  Returns how many bytes were dropped."""
        dropped = len(self._buf)
        self._buf.clear()
        return dropped

    def feed(self, chunk: bytes) -> list[Frame]:
        self._buf.extend(chunk)
        frames: list[Frame] = []
        while len(self._buf) >= _HEADER.size:
            magic, ver, kind, length = _HEADER.unpack_from(self._buf)
            if magic != MAGIC:
                raise ProtocolError(f"bad magic {magic!r}")
            if ver not in SUPPORTED_VERSIONS:
                raise ProtocolError(f"protocol version {ver}, "
                                    f"want one of {SUPPORTED_VERSIONS}")
            if length > MAX_PAYLOAD:
                raise ProtocolError(f"frame length {length} > {MAX_PAYLOAD}")
            if len(self._buf) < _HEADER.size + length:
                break
            payload = bytes(self._buf[_HEADER.size:_HEADER.size + length])
            del self._buf[:_HEADER.size + length]
            frames.append(Frame(kind=kind, payload=payload, version=ver))
        return frames
