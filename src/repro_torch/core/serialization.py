"""AVEC wire format: pytree <-> framed bytes, with data-transfer accounting.

Frame layout, v2 (the paper's Boost-ASIO forwarding, made explicit and
vectored for the zero-copy data plane).  The magic is versioned (``AVC2``)
so a peer still speaking the v1 8-byte-preamble format fails the magic
check loudly instead of misparsing the request id as a header length:

    offset  0:  4B   magic  b"AVC2"
    offset  4:  8B   u64 little-endian request id (0 = unpipelined)
    offset 12:  4B   u32 little-endian header length
    offset 16:       msgpack header
    offset 16+hlen:  leaf buffers, in flattened (insertion) order

The msgpack header carries the treedef (as a nested template), per-leaf
dtype/shape, the codec, per-buffer lengths, and arbitrary metadata.

**Well-known metadata keys** (optional; same protocol version): ``run``
requests may carry ``"tenant"`` (string identity for the destination's
fair-share drain and admission control) and ``"qos"``
(``{"weight": float, "priority": int}``, see ``repro.avec.QoS``);
throttled responses carry ``"throttled": True``, ``"tenant"`` and
``"retry_after_s"`` alongside ``"ok": False`` (typed backpressure — see
``repro_torch.core.executor.TenantThrottled``).  Peers that predate these keys
ignore them; nothing in the frame layout changed.

**Vectored frames.** ``pack_message`` does NOT join the frame into one
``bytes``: it returns a :class:`Frame` — a list of buffer segments
``[preamble+header, leaf0, leaf1, ...]`` where ``raw``-codec leaves are
``memoryview``s directly over the source arrays (no ``tobytes()`` copy).
``TCPChannel`` writes a Frame with ``socket.sendmsg`` scatter-gather, so the
only copy on the send path is the kernel's.  ``bytes(frame)`` joins (the
legacy single-buffer form) when a contiguous blob is genuinely needed.

**Request ids.** The fixed preamble carries a u64 request id so a pipelined
host can keep many RPCs in flight on one channel and match responses
out-of-order without parsing the msgpack header
(:func:`frame_request_id` peeks it in O(1)).

**Zero-copy unpack.** ``unpack_message`` returns, for ``raw``-codec leaves,
views over the received frame (read-only) instead of per-leaf copies; pass
``copy=True`` where the caller mutates results.  Unpacking a
:class:`Frame` directly (loopback / in-process channels) reads each leaf
from its own segment — fully zero-copy end to end.  When the frame arrived
in **pooled recv memory** (a ``repro_torch.core.memory.BufferLease`` from
``TCPChannel``/``TCPServer``), each raw leaf is decoded in place as a
``PooledView`` that *pins* the lease until the last array referencing it
is garbage-collected — the slab cannot be recycled under a live view, and
``copy=True`` detaches eagerly so the lease frees as soon as the receiving
layer releases its base reference.

``DataTransfer`` generalizes the paper's Eq. 1: DT = fixed header + sum of
argument bytes + result bytes.  ``eq1_bytes`` reproduces the exact paper
formula for an OpenPose frame (~3.75 MB at 1x3x368x656).

Codecs (beyond-paper, the slow-link levers):
  raw   — paper-faithful float32 forwarding (zero-copy on both ends)
  zstd  — lossless entropy compression (zstandard if available, else zlib;
          each leaf records the algorithm in its ``alg`` meta so nodes on
          different images interoperate)
  zlib  — lossless compression forced to stdlib zlib (for peers without
          zstandard; encoded as codec ``zstd`` + ``alg: zlib`` on the wire
          so any same-version peer decodes it)
  int8  — per-row symmetric quantization (the numpy helpers below, a copy
          of the JAX package's ``kernels/comm_quant.py`` leaf helpers),
          shipped uncompressed (quantized noise defeats entropy coding;
          the 4x is the quantization itself)
  fp16  — half-precision cast of float leaves (lossy ~2^-11 relative;
          leaves whose absmax overflows float16 fall through)

``codec`` may also be a **negotiated preference list** (see
``repro.avec.negotiate_codecs``): each leaf takes the first feasible codec
— quant codecs only for float leaves at least ``comm_quant_min_bytes``
long, compression for the rest — ending in ``raw``.  A single codec
*string* keeps the legacy forced semantics (explicit ``codec="int8"``
quantizes any eligible float leaf regardless of the knob floor).

This copy speaks the same AVC2 frames byte for byte without the third-party
packages the JAX package's copy uses: the header goes through a small
msgpack encoder/decoder of its own (:func:`packb` / :func:`unpackb`,
byte-identical to ``msgpack.packb(..., use_bin_type=True)`` for the header
types), and bfloat16 leaves travel as their raw 2-byte payload under the
dtype name ``"bfloat16"`` without ``ml_dtypes`` (see
``repro_torch.utils.BF16Array``).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Iterator

import numpy as np

import zlib

from repro_torch.analysis import sanitize as _sanitize
from repro_torch.core.memory import BufferLease
from repro_torch.utils import BF16Array, dtype_name

try:  # container images may lack zstandard; gate it (no new deps)
    import zstandard

    _ZSTD_C = zstandard.ZstdCompressor(level=1)
    _ZSTD_D = zstandard.ZstdDecompressor()
    _COMPRESS_ALG = "zstd"

    def _compress(data) -> bytes:
        return _ZSTD_C.compress(data)       # accepts buffers: no copy
except ImportError:  # pragma: no cover - depends on image
    zstandard = None
    _COMPRESS_ALG = "zlib"

    def _compress(data) -> bytes:
        return zlib.compress(data, 1)       # accepts buffers: no copy


def _decompress(data, alg: str) -> bytes:
    """Decode by the algorithm recorded in the leaf meta — host and
    destination may run different images, so the frame itself must say which
    compressor produced it."""
    if alg == "zlib":
        return zlib.decompress(data)
    if zstandard is None:
        raise RuntimeError(
            "frame compressed with zstd but zstandard is not installed on "
            "this node; install it or use codec='raw'")
    return _ZSTD_D.decompress(bytes(data))   # zstd one-shot needs len()able

MAGIC = b"AVC2"                     # versioned: v1 frames were b"AVEC"
PREAMBLE = 16                       # magic(4) + request_id(8) + header_len(4)
_PREAMBLE_FMT = "<4sQI"

# The AVEC wire protocol version spoken by this node (frame layout + op set).
# Advertised by the executor's ping capability handshake and checked by
# ``repro.avec.connect`` — peers on different versions must fail loudly at
# connect time, not misparse frames mid-stream.
PROTOCOL_VERSION = 2

# Codecs this node can encode AND decode (see module docstring).  zstd is
# always listed: the encoder falls back to zlib and records the algorithm in
# the leaf meta, so any peer of the same protocol version can decode it.
# This tuple is what the capability handshake advertises; codec selection is
# a single negotiated list (repro.avec.negotiate_codecs) shared by the
# compressors and the quant codecs, ending in "raw" for old peers.
SUPPORTED_CODECS = ("raw", "zstd", "zlib", "int8", "fp16")

#: quantizable wire dtypes (the codecs are float-only by construction)
_QUANT_DTYPES = (np.float32, np.float64)

# Typed wire errors: the complete serialization error table.  Every error
# class a destination can surface over the wire (RemoteError and its
# subclasses, plus ProtocolError for unframeable streams) declares here
# which response-meta flag marks it (``None`` = not meta-carried; raised
# from framing itself) and the client-side disposition:
#
#   retry     — transient; back off ``retry_after_s`` and resubmit
#   rehome    — destination is going away; re-place on another node
#   reraise   — application-level failure; surface to the caller
#   teardown  — the stream is unframeable; close the channel, re-dial
#
# ``executor._remote_exception`` maps the flags back to typed exceptions on
# the client; ``avecheck``'s wire rule checks this table stays complete,
# mapped, and handled (see repro/analysis/rules.py).
WIRE_ERRORS = {
    "RemoteError":         {"flag": "error",     "disposition": "reraise"},
    "TenantThrottled":     {"flag": "throttled", "disposition": "retry"},
    "DestinationDraining": {"flag": "draining",  "disposition": "rehome"},
    "ProtocolError":       {"flag": None,        "disposition": "teardown"},
}


# ---------------------------------------------------------------------------
# Vectored frame
# ---------------------------------------------------------------------------

class Frame:
    """A wire frame as a list of buffer segments (scatter-gather ready).

    ``segments[0]`` is the preamble + msgpack header; each subsequent
    segment is one encoded leaf buffer.  ``len(frame)`` is the total byte
    length; ``bytes(frame)`` joins into the contiguous legacy form.
    Segments referencing live numpy arrays keep them alive, so a Frame can
    be held or sent later without copying.
    """

    __slots__ = ("segments", "nbytes")

    def __init__(self, segments: list) -> None:
        self.segments = segments
        self.nbytes = sum(len(s) for s in segments)

    def __len__(self) -> int:
        return self.nbytes

    def __iter__(self) -> Iterator:
        return iter(self.segments)

    def __bytes__(self) -> bytes:
        return b"".join(self.segments)      # join accepts buffers: one copy

    def to_bytes(self) -> bytes:
        return bytes(self)


def _leaf_view(arr: np.ndarray) -> memoryview:
    """Byte view over an array with no copy when already contiguous."""
    arr = np.ascontiguousarray(arr)
    return arr.reshape(-1).view(np.uint8).data


# ---------------------------------------------------------------------------
# pytree <-> (template, leaves)
# ---------------------------------------------------------------------------

def _flatten(obj: Any, leaves: list) -> Any:
    """Replace array leaves with placeholder indices; return the template.

    Dict *insertion order* is preserved on the wire (msgpack maps keep key
    order), so pytree roundtrips are order-faithful — callers relying on
    ``dict`` iteration order get back exactly what they sent.  Model
    fingerprints are unaffected: ``core.cache.model_fingerprint`` hashes
    ``jax.tree_util`` paths, not this template.
    """
    if isinstance(obj, dict):
        return {k: _flatten(v, leaves) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_flatten(v, leaves) for v in obj]
        return {"__tuple__": t} if isinstance(obj, tuple) else t
    if isinstance(obj, (np.ndarray, np.generic)) or hasattr(obj, "__array__"):
        arr = obj if isinstance(obj, BF16Array) else np.asarray(obj)
        leaves.append(arr)
        return {"__leaf__": len(leaves) - 1, "dtype": dtype_name(arr),
                "shape": list(arr.shape)}
    return {"__value__": obj}


def _unflatten(tmpl: Any, leaves: list) -> Any:
    if isinstance(tmpl, dict):
        if "__leaf__" in tmpl:
            return leaves[tmpl["__leaf__"]]
        if "__value__" in tmpl:
            return tmpl["__value__"]
        if "__tuple__" in tmpl:
            return tuple(_unflatten(v, leaves) for v in tmpl["__tuple__"])
        return {k: _unflatten(v, leaves) for k, v in tmpl.items()}
    if isinstance(tmpl, list):
        return [_unflatten(v, leaves) for v in tmpl]
    return tmpl


# bfloat16 has no numpy dtype without ml_dtypes: its leaves are carried as
# uint16 storage of the raw bits (BF16Array), named "bfloat16" on the wire.
def _np_dtype(name: str):
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def _as_leaf(arr: np.ndarray, name: str) -> np.ndarray:
    return arr.view(BF16Array) if name == "bfloat16" else arr


# ---------------------------------------------------------------------------
# int8 wire codec: numpy copy of the JAX package's comm_quant leaf helpers
# (scale = max(absmax_row, 1e-12) / 127, q = clip(rint(x / scale), +-127))
# ---------------------------------------------------------------------------

def leaf_rows(x):
    """Canonical 2-D per-row view of a leaf (rank 0/1 becomes one row)."""
    return x.reshape(-1, x.shape[-1]) if x.ndim >= 2 else x.reshape(1, -1)


def quantize_int8_np(x) -> tuple[np.ndarray, np.ndarray]:
    """``x`` (any rank) -> ``(q int8 (rows, cols), scale f32 (rows, 1))``."""
    flat = np.ascontiguousarray(leaf_rows(np.asarray(x)), dtype=np.float32)
    absmax = np.max(np.abs(flat), axis=1, keepdims=True) if flat.size \
        else np.zeros((flat.shape[0], 1), np.float32)
    scale = np.maximum(absmax, 1e-12) / 127.0
    q = np.clip(np.rint(flat / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def dequantize_int8_np(q, scale, dtype=np.float32) -> np.ndarray:
    """Inverse of :func:`quantize_int8_np` (still (rows, cols))."""
    return (np.asarray(q).astype(np.float32) * np.asarray(scale)).astype(dtype)


# ---------------------------------------------------------------------------
# msgpack subset for the frame header (map, array, str, bin, int, float64,
# bool, nil), byte-identical to msgpack.packb(obj, use_bin_type=True)
# ---------------------------------------------------------------------------

def _pack_into(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        if 0 <= obj < 0x80:
            out.append(obj)
        elif -32 <= obj < 0:
            out.append(obj & 0xFF)
        elif obj >= 0:
            for tag, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                  (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
                if obj < lim:
                    out += bytes([tag]) + struct.pack(fmt, obj)
                    break
            else:
                raise OverflowError(f"int {obj} too large for msgpack")
        else:
            for tag, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                  (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
                if obj >= -lim:
                    out += bytes([tag]) + struct.pack(fmt, obj)
                    break
            else:
                raise OverflowError(f"int {obj} too small for msgpack")
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        n = len(data)
        if n < 32:
            out.append(0xA0 | n)
        elif n < 1 << 8:
            out += b"\xd9" + struct.pack(">B", n)
        elif n < 1 << 16:
            out += b"\xda" + struct.pack(">H", n)
        else:
            out += b"\xdb" + struct.pack(">I", n)
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        n = len(data)
        if n < 1 << 8:
            out += b"\xc4" + struct.pack(">B", n)
        elif n < 1 << 16:
            out += b"\xc5" + struct.pack(">H", n)
        else:
            out += b"\xc6" + struct.pack(">I", n)
        out += data
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(0x90 | n)
        elif n < 1 << 16:
            out += b"\xdc" + struct.pack(">H", n)
        else:
            out += b"\xdd" + struct.pack(">I", n)
        for item in obj:
            _pack_into(item, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(0x80 | n)
        elif n < 1 << 16:
            out += b"\xde" + struct.pack(">H", n)
        else:
            out += b"\xdf" + struct.pack(">I", n)
        for k, v in obj.items():
            _pack_into(k, out)
            _pack_into(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    out = bytearray()
    _pack_into(obj, out)
    return bytes(out)


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
          0xD2: ">i", 0xD3: ">q", 0xCB: ">d"}
_LEN = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xC4: ">B", 0xC5: ">H", 0xC6: ">I",
        0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}


def _unpack_from(buf, off: int):
    b = buf[off]
    off += 1
    if b < 0x80:
        return b, off
    if b >= 0xE0:
        return b - 0x100, off
    if b == 0xC0:
        return None, off
    if b in (0xC2, 0xC3):
        return b == 0xC3, off
    if b in _FIXED:
        fmt = _FIXED[b]
        return struct.unpack_from(fmt, buf, off)[0], off + struct.calcsize(fmt)
    if 0xA0 <= b <= 0xBF or b in (0xD9, 0xDA, 0xDB):
        n = b & 0x1F if b <= 0xBF else _read_len(buf, off, b)
        off += 0 if b <= 0xBF else struct.calcsize(_LEN[b])
        return bytes(buf[off:off + n]).decode("utf-8"), off + n
    if b in (0xC4, 0xC5, 0xC6):
        n = _read_len(buf, off, b)
        off += struct.calcsize(_LEN[b])
        return bytes(buf[off:off + n]), off + n
    if 0x90 <= b <= 0x9F or b in (0xDC, 0xDD):
        n = b & 0x0F if b <= 0x9F else _read_len(buf, off, b)
        off += 0 if b <= 0x9F else struct.calcsize(_LEN[b])
        items = []
        for _ in range(n):
            item, off = _unpack_from(buf, off)
            items.append(item)
        return items, off
    if 0x80 <= b <= 0x8F or b in (0xDE, 0xDF):
        n = b & 0x0F if b <= 0x8F else _read_len(buf, off, b)
        off += 0 if b <= 0x8F else struct.calcsize(_LEN[b])
        d = {}
        for _ in range(n):
            k, off = _unpack_from(buf, off)
            d[k], off = _unpack_from(buf, off)
        return d, off
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _read_len(buf, off: int, tag: int) -> int:
    return struct.unpack_from(_LEN[tag], buf, off)[0]


def unpackb(data):
    buf = bytes(data)
    obj, off = _unpack_from(buf, 0)
    if off != len(buf):
        raise ValueError("extra data after the msgpack object")
    return obj


# ---------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------

def _quantizable(arr: np.ndarray) -> bool:
    return arr.dtype in _QUANT_DTYPES and arr.ndim >= 1 and arr.size >= 64


def _select_codec(arr: np.ndarray, prefs, min_quant_bytes: int) -> str:
    """Resolve a negotiated preference list to one leaf's codec: first
    feasible entry wins (quant codecs need an eligible float leaf at least
    ``min_quant_bytes`` long; fp16 additionally a representable absmax)."""
    for c in prefs:
        if c in ("int8", "fp16"):
            if not _quantizable(arr) or arr.nbytes < min_quant_bytes:
                continue
            if c == "fp16" and float(np.max(np.abs(arr))) > 65504.0:
                continue                    # would overflow to inf on cast
            return c
        if c in ("zstd", "zlib", "raw"):
            return c
    return "raw"


def _encode_leaf(arr: np.ndarray, codec, min_quant_bytes: int = 0):
    """-> (buffer segment, leaf meta).  raw segments are zero-copy views.

    ``codec`` is a single codec name (legacy forced semantics) or a
    negotiated preference tuple resolved per leaf by :func:`_select_codec`.
    """
    meta = {"dtype": dtype_name(arr), "shape": list(arr.shape)}
    if not isinstance(codec, str):
        codec = _select_codec(arr, codec, min_quant_bytes)
    if codec == "int8" and _quantizable(arr):
        q, s = quantize_int8_np(arr)
        # deliberately NO entropy pass on top: quantized activations are
        # near-incompressible noise, and compressing them costs more CPU
        # per frame than the handful of bytes it shaves — the 4x is the
        # quantization itself (measured in comm_quant_narrow_link)
        meta["codec"] = "int8"
        meta["rows"] = int(q.shape[0])
        return q.tobytes() + s.tobytes(), meta
    if codec == "fp16" and _quantizable(arr):
        half = np.ascontiguousarray(arr, np.float16)
        meta["codec"] = "fp16"
        return half.reshape(-1).view(np.uint8).data, meta
    raw = _leaf_view(arr)
    if codec == "zlib":
        # forced stdlib compression; wire form is the decodable-anywhere
        # (codec=zstd, alg=zlib) pair old peers already understand
        meta["codec"] = "zstd"
        meta["alg"] = "zlib"
        return zlib.compress(raw, 1), meta
    if codec in ("zstd", "int8", "fp16"):
        meta["codec"] = "zstd"
        meta["alg"] = _COMPRESS_ALG
        return _compress(raw), meta
    meta["codec"] = "raw"
    return raw, meta


def _decode_leaf(buf, meta: dict, copy: bool,
                 lease: BufferLease | None = None) -> np.ndarray:
    name = meta["dtype"]
    dtype = _np_dtype(name)
    shape = tuple(meta["shape"])
    codec = meta.get("codec", "raw")
    if codec == "raw":
        if lease is not None and not copy:
            # decode in place over the pooled slab: the view pins the lease
            # (released when the last referencing array is collected)
            return _as_leaf(lease.pin_ndarray(buf, dtype, shape), name)
        out = np.frombuffer(buf, dtype).reshape(shape)
        return _as_leaf(out.copy() if copy else out, name)
    if codec == "fp16":
        return np.frombuffer(buf, np.float16).reshape(shape).astype(dtype)
    if codec == "int8":
        # uncompressed [q int8 rows*cols][scales f32 rows] (see encode)
        rows = meta["rows"]
        cols = int(np.prod(shape)) // rows
        raw = bytes(buf)
        q = np.frombuffer(raw[: rows * cols], np.int8).reshape(rows, cols)
        s = np.frombuffer(raw[rows * cols:], np.float32).reshape(rows, 1)
        return dequantize_int8_np(q, s, dtype).reshape(shape)
    raw = _decompress(buf, meta.get("alg", _COMPRESS_ALG))
    out = np.frombuffer(raw, dtype).reshape(shape)
    # the fresh decompress buffer is owning but immutable (bytes); the
    # copy=True escape hatch must still yield a writable array
    return _as_leaf(out.copy() if copy else out, name)


# ---------------------------------------------------------------------------
# Messages
# ---------------------------------------------------------------------------

def pack_message(meta: dict, tree: Any = None, codec="raw",
                 request_id: int = 0) -> Frame:
    """Pack (meta, pytree) into a vectored :class:`Frame`.

    ``raw``-codec leaf segments are memoryviews over the (contiguous) source
    arrays — no serialization copy.  Use ``bytes(frame)`` for the joined
    legacy form.  ``codec`` may be a single name or a negotiated preference
    list (resolved per leaf; see module docstring).
    """
    min_q = 0
    if not isinstance(codec, str):
        codec = tuple(codec)
        from repro_torch.obs.config import global_config
        min_q = int(global_config().resolve("comm_quant_min_bytes"))
    leaves: list[np.ndarray] = []
    tmpl = _flatten(tree, leaves) if tree is not None else None
    bufs, metas = [], []
    for arr in leaves:
        b, m = _encode_leaf(arr, codec, min_q)
        bufs.append(b)
        metas.append(m)
    header = packb({
        "meta": meta, "template": tmpl,
        "leaves": metas, "buf_lens": [len(b) for b in bufs],
    })
    head = struct.pack(_PREAMBLE_FMT, MAGIC, request_id, len(header)) + header
    return Frame([head, *bufs])


def _head_of(data):
    """The preamble-bearing buffer of any frame form: vectored
    :class:`Frame`, pooled ``BufferLease``, or plain bytes-like."""
    if isinstance(data, Frame):
        return data.segments[0]
    if isinstance(data, BufferLease):
        return data.view
    return data


def frame_request_id(data) -> int:
    """O(1) peek of the request id (no msgpack parse) — the pipelined
    reader's response-matching key."""
    return struct.unpack_from("<Q", _head_of(data), 4)[0]


def frame_preamble_ok(data) -> bool:
    """True when the fixed preamble is readable (long enough and carrying
    the right magic) — the bar an executor requires before echoing the
    request id back on a per-request error.  A frame that fails this check
    cannot be answered addressably at all: the connection must fail loudly
    instead (see ``DestinationExecutor.handle``)."""
    mv = memoryview(_head_of(data))
    return len(mv) >= PREAMBLE and bytes(mv[:4]) == MAGIC


def _parse_head(head) -> tuple[dict, int, int]:
    magic, rid, hlen = struct.unpack_from(_PREAMBLE_FMT, head, 0)
    assert magic == MAGIC, "bad frame magic"
    header = unpackb(head[PREAMBLE:PREAMBLE + hlen])
    return header, rid, hlen


def unpack_message(data, copy: bool = False) -> tuple[dict, Any]:
    """Unpack a frame (``bytes``/``bytearray``/``memoryview``, a vectored
    :class:`Frame`, or a pooled ``BufferLease``) into (meta, pytree).

    With ``copy=False`` (default), ``raw``-codec leaves are read-only views
    over the frame — the frame's buffer must outlive them.  For pooled
    leases that lifetime is *enforced*: each decoded leaf pins the lease
    (see module docstring), so the slab is only recycled once every view is
    gone.  Pass ``copy=True`` where the caller mutates leaves in place or
    wants the lease to free eagerly.
    """
    if isinstance(data, Frame):
        header, _, _ = _parse_head(data.segments[0])
        leaves = [_decode_leaf(seg, meta, copy)
                  for seg, meta in zip(data.segments[1:], header["leaves"])]
    else:
        lease = data if isinstance(data, BufferLease) else None
        mv = lease.view if lease is not None else memoryview(data)
        header, _, hlen = _parse_head(mv)
        off = PREAMBLE + hlen
        leaves = []
        for blen, meta in zip(header["buf_lens"], header["leaves"]):
            leaves.append(_decode_leaf(mv[off:off + blen], meta, copy,
                                       lease))
            off += blen
    tree = (_unflatten(header["template"], leaves)
            if header["template"] is not None else None)
    return header["meta"], tree


# ---------------------------------------------------------------------------
# Data-transfer accounting (paper Eq. 1, generalized)
# ---------------------------------------------------------------------------

@dataclass
class DataTransfer:
    """Tracks bytes crossing a link, per direction and per category.

    Thread-safe: pipelined runtimes and sharded ``map`` gathers record
    concurrently from multiple threads, and ``n += x`` on a plain attribute
    is a read-modify-write race that silently loses bytes."""
    sent: int = 0                                   # guarded-by: _lock
    received: int = 0                               # guarded-by: _lock
    by_category: dict = field(default_factory=dict)  # guarded-by: _lock

    def __post_init__(self) -> None:
        self._lock = _sanitize.make_lock("DataTransfer._lock")

    def record(self, n: int, direction: str = "sent", category: str = "args") -> None:
        with self._lock:
            if direction == "sent":
                self.sent += n
            else:
                self.received += n
            self.by_category[category] = self.by_category.get(category, 0) + n

    @property
    def total(self) -> int:
        with self._lock:
            return self.sent + self.received


def tree_wire_bytes(tree: Any) -> int:
    leaves: list[np.ndarray] = []
    _flatten(tree, leaves)
    return sum(a.nbytes for a in leaves)


def eq1_bytes(dims: int, c: float) -> float:
    """Paper Eq. 1: DT = (2*4) + (1*4) + Dims*4 + (Dims/c)*4 bytes/frame."""
    return (2 * 4) + (1 * 4) + dims * 4 + (dims / c) * 4
