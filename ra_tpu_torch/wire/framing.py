"""Wire framing: the byte protocol between real clients and the
ingress plane.

The design constraint is the RA08/RA09 discipline extended to the
socket path: the server's reader loop does ZERO per-command Python
work, so the steady-state client→server stream must parse as one
vectorized numpy sweep.  That forces a **fixed-stride** data stream:
after the HELLO handshake, a connection's ingress bytes are a pure
sequence of equal-size length-prefixed DATA records —

    <u32 len> <u8 type=DATA> <u8 flags> <u16 sess> <u64 seqno> <i32 payload x C>

— so a ring buffer holding N records is decoded by ONE ``frombuffer``
view plus column slices (``decode_data``), never a per-frame walk.
``len`` counts the bytes after the length prefix (the classic
length-prefix contract); ``sess`` is the session's offset within the
connection's session block (one TCP connection may multiplex up to
65,536 wire sessions — the unit of flow control is the SESSION, the
connection is just its transport).

Control frames are variable-length and rare (connect-time / credit
return), so they may be built and parsed per frame:

* ``HELLO``      client→server  ``<ver u8> <tenants u8> <keylen u16>
  <n_sessions u32> <payload_width u8> <key bytes>`` — resolves/creates
  the connection's session block (same key ⇒ same sessions, epoch
  bumped: a reconnect).  ``payload_width`` (v2+) declares the client's
  DATA column count C; the listener refuses a mismatch with an ERR
  frame BEFORE any data record is interpreted — a C=4 client talking
  to a C=3 sweep would otherwise misparse every frame boundary.
* ``HELLO_ACK``  server→client  ``<ver u8> <flags u8>
  <payload_width u16> <epoch u32> <handle_base u64> <nslots u32>
  <i32 slot x nslots>`` — the epoch is the at-least-once client's
  re-enqueue trigger (docs/INGRESS.md "Delivery guarantees"); the
  per-session dedup SLOTS are the machine-level identity a client
  embeds in payloads for exactly-once-observable workloads
  (wire/dedup.py); ``payload_width`` echoes the server's accepted C.
* ``ERR``        server→client  ``<code u8> <msglen u16> <utf-8 msg>``
  — a refused handshake's reason (version / payload-width mismatch),
  sent once before close so the client raises a protocol error
  instead of timing out on a silently dropped connection.
* ``CREDIT``     server→client  ``<level u8> <pad u8> <count u16>`` +
  ``count`` records ``<sess u16> <seqno u64> <status u8>`` — the
  CreditLadder verdict for every swept row, serialized back per
  connection.  This frame IS the generalized ``StopSending``: the
  status enum is the ingress plane's (ok/slow/defer/reject/dup/shed),
  one enum, one encoder (:func:`encode_credit`), shared with
  :class:`~ra_tpu_torch.models.fifo_client.FifoClient`.
* ``ACK``        server→client  ``<pad u16> <count u16>`` + ``count``
  records ``<sess u16> <acked u64>`` — per-session cumulative
  committed placed-row watermarks (flow-control grade: duplicate row
  commits can run a watermark ahead; exactness is machine-level — see
  docs/INGRESS.md).
* ``REHOME``     server→client  ``<generation u32> <revision u64>
  <namelen u16> <utf-8 engine>`` — a typed placement-staleness refusal
 : the frames the client just sent hit lanes whose home
  moved per the listener's PlacementCache view.  The named engine +
  generation + table revision are the hint a client follows (at most
  once per connection epoch) to the new home instead of silently
  misrouting into a dead engine's lanes (docs/PLACEMENT.md).

The version byte rides HELLO/HELLO_ACK; a mismatch refuses the
connection before any data record is interpreted.
"""
from __future__ import annotations

import struct

import numpy as np

# one verdict enum for the whole admission surface: the wire credit
# frame, the ingress ladder and the fifo client's ok→slow→StopSending
# protocol all speak these values
from ..ingress.backpressure import (DEFER, DUP, OK, REJECT, SHED, SLOW,
                                    STATUS_NAMES)

__all__ = [
    "WIRE_VERSION", "T_HELLO", "T_HELLO_ACK", "T_DATA", "T_CREDIT",
    "T_ACK", "T_ERR", "T_REHOME", "E_VERSION", "E_PAYLOAD_WIDTH",
    "data_dtype", "credit_dtype", "ack_dtype", "data_stride",
    "encode_hello", "decode_hello", "encode_hello_ack",
    "decode_hello_ack", "encode_error", "decode_error",
    "encode_data", "decode_data", "encode_credit",
    "decode_credit", "encode_ack", "decode_ack",
    "encode_rehome", "decode_rehome", "read_frame",
    "T_READ", "T_READ_REPLY", "read_reply_dtype",
    "encode_read", "encode_read_reply", "decode_read_reply",
    "OK", "SLOW", "DEFER", "REJECT", "DUP", "SHED", "STATUS_NAMES",
]

#: protocol version (HELLO/HELLO_ACK version byte).  v2 adds the
#: payload-width negotiation + the ERR refusal frame; a v1 HELLO still
#: parses (width reads as 0 = "not declared") but is refused with an
#: ERR so the client fails loudly instead of misparsing DATA frames.
WIRE_VERSION = 2

T_HELLO = 1
T_HELLO_ACK = 2
T_DATA = 3
T_CREDIT = 4
T_ACK = 5
T_ERR = 6
T_REHOME = 7
#: consistent read.  A READ record shares the DATA stride
#: and dtype — the type column distinguishes it — so the server's ONE
#: frombuffer sweep still holds for a mixed read/write stream; the
#: encoded query rides the leading ``pay`` columns (zero-padded to the
#: connection's C).  Reads never enter the log: they answer with a
#: READ_REPLY at a certified watermark instead of an ACK.
T_READ = 8
T_READ_REPLY = 9

#: ERR frame codes
E_VERSION = 1        # HELLO version byte != WIRE_VERSION
E_PAYLOAD_WIDTH = 2  # client's DATA column count != the listener's

_LEN = struct.Struct("<I")
_HELLO = struct.Struct("<BBBHI")       # type, ver, tenants, keylen, n_sessions
_HELLO_W = struct.Struct("<B")         # v2+: payload_width (after _HELLO)
_HELLO_ACK = struct.Struct("<BBBHIQ")  # type, ver, flags, width, epoch, base
_CREDIT_HDR = struct.Struct("<BBBH")   # type, level, pad, count
_ACK_HDR = struct.Struct("<BBHH")      # type, pad, pad, count
_ERR_HDR = struct.Struct("<BBH")       # type, code, msglen
_REHOME_HDR = struct.Struct("<BHIQH")  # type, pad, generation, rev, namelen


def data_dtype(payload_width: int) -> np.dtype:
    """Packed little-endian record dtype of one DATA frame (stride =
    16 + 4*C bytes)."""
    return np.dtype([("len", "<u4"), ("type", "u1"), ("flags", "u1"),
                     ("sess", "<u2"), ("seqno", "<u8"),
                     ("pay", "<i4", (int(payload_width),))])


def data_stride(payload_width: int) -> int:
    return data_dtype(payload_width).itemsize


#: CREDIT record: one verdict per swept row (11 bytes packed)
credit_dtype = np.dtype([("sess", "<u2"), ("seqno", "<u8"),
                         ("status", "u1")])

#: ACK record: per-session cumulative committed-row watermark
ack_dtype = np.dtype([("sess", "<u2"), ("acked", "<u8")])


# -- control frames (rare; per-frame Python is fine here) -------------------

def encode_hello(key: str, n_sessions: int, *, tenants: int = 1,
                 payload_width: int = 3) -> bytes:
    kb = key.encode()
    body = _HELLO.pack(T_HELLO, WIRE_VERSION, tenants, len(kb),
                       n_sessions) \
        + _HELLO_W.pack(payload_width) + kb
    return _LEN.pack(len(body)) + body


def decode_hello(body: bytes) -> dict:
    t, ver, tenants, keylen, n_sessions = _HELLO.unpack_from(body)
    if t != T_HELLO:
        raise ValueError(f"not a HELLO frame (type {t})")
    # v1 bodies have no width byte: report 0 ("not declared") so the
    # listener can refuse with a precise reason instead of a parse error
    off = _HELLO.size
    width = 0
    if ver >= 2:
        (width,) = _HELLO_W.unpack_from(body, off)
        off += _HELLO_W.size
    key = body[off:off + keylen].decode()
    return {"version": ver, "tenants": tenants, "key": key,
            "n_sessions": n_sessions, "payload_width": width}


def encode_hello_ack(epoch: int, handle_base: int,
                     slots=None, *, payload_width: int = 0) -> bytes:
    slots = np.zeros(0, np.int32) if slots is None else \
        np.asarray(slots, np.int32)
    body = _HELLO_ACK.pack(T_HELLO_ACK, WIRE_VERSION, 0, payload_width,
                           epoch, handle_base) \
        + struct.pack("<I", len(slots)) + slots.tobytes()
    return _LEN.pack(len(body)) + body


def decode_hello_ack(body: bytes) -> dict:
    t, ver, _fl, width, epoch, base = _HELLO_ACK.unpack_from(body)
    if t != T_HELLO_ACK:
        raise ValueError(f"not a HELLO_ACK frame (type {t})")
    (n,) = struct.unpack_from("<I", body, _HELLO_ACK.size)
    slots = np.frombuffer(body, "<i4", n, _HELLO_ACK.size + 4) \
        if n else None
    return {"version": ver, "epoch": epoch, "handle_base": base,
            "slots": slots, "payload_width": width}


def encode_error(code: int, message: str) -> bytes:
    mb = message.encode()[:65535]
    body = _ERR_HDR.pack(T_ERR, code, len(mb)) + mb
    return _LEN.pack(len(body)) + body


def decode_error(body: bytes) -> dict:
    t, code, msglen = _ERR_HDR.unpack_from(body)
    if t != T_ERR:
        raise ValueError(f"not an ERR frame (type {t})")
    msg = body[_ERR_HDR.size:_ERR_HDR.size + msglen].decode(
        errors="replace")
    return {"code": code, "message": msg}


def encode_rehome(engine: str, generation: int, rev: int) -> bytes:
    """The typed placement-staleness refusal: "your lanes'
    home is ``engine`` at ``generation`` per table revision ``rev`` —
    reconnect there".  Sent at most once per affected connection per
    sweep; a client honors it at most once per connection epoch."""
    nb = engine.encode()[:65535]
    body = _REHOME_HDR.pack(T_REHOME, 0, int(generation) & 0xFFFFFFFF,
                            int(rev) & 0xFFFFFFFFFFFFFFFF, len(nb)) + nb
    return _LEN.pack(len(body)) + body


def decode_rehome(body: bytes) -> dict:
    t, _pad, generation, rev, namelen = _REHOME_HDR.unpack_from(body)
    if t != T_REHOME:
        raise ValueError(f"not a REHOME frame (type {t})")
    engine = body[_REHOME_HDR.size:_REHOME_HDR.size + namelen].decode(
        errors="replace")
    return {"engine": engine, "generation": generation, "rev": rev}


# -- the data stream (vectorized both ways) ---------------------------------

def encode_data(sess, seqnos, payloads) -> bytes:
    """Encode a batch of commands as the fixed-stride DATA stream (one
    structured-array fill + ``tobytes`` — no per-record Python)."""
    payloads = np.asarray(payloads)
    if payloads.ndim == 1:
        payloads = payloads[:, None]
    n, c = payloads.shape
    rec = np.zeros(n, data_dtype(c))
    rec["len"] = rec.dtype.itemsize - 4
    rec["type"] = T_DATA
    rec["sess"] = np.asarray(sess)
    rec["seqno"] = np.asarray(seqnos)
    rec["pay"] = payloads
    return rec.tobytes()


def decode_data(buf, payload_width: int) -> np.ndarray:
    """View a byte block as DATA records (the sweep-side decode: one
    ``frombuffer``, zero copies).  ``buf`` length must be a whole
    number of strides."""
    return np.frombuffer(buf, data_dtype(payload_width))


# -- credit / ack (vectorized records, small per-frame headers) -------------

def encode_credit(level: int, sess, seqnos, statuses) -> bytes:
    """THE credit-frame encoder (one encoder for the whole verdict
    surface): per-row CreditLadder verdicts + the current ladder level,
    serialized as one frame."""
    rec = np.zeros(len(np.atleast_1d(np.asarray(sess))), credit_dtype)
    rec["sess"] = np.asarray(sess)
    rec["seqno"] = np.asarray(seqnos)
    rec["status"] = np.asarray(statuses)
    body = _CREDIT_HDR.pack(T_CREDIT, int(level), 0, len(rec)) \
        + rec.tobytes()
    return _LEN.pack(len(body)) + body


def decode_credit(body: bytes) -> tuple:
    """Returns ``(level, records)`` with ``records`` a credit_dtype
    array (vectorized client-side decode)."""
    t, level, _p, count = _CREDIT_HDR.unpack_from(body)
    if t != T_CREDIT:
        raise ValueError(f"not a CREDIT frame (type {t})")
    rec = np.frombuffer(body, credit_dtype, count, _CREDIT_HDR.size)
    return level, rec


def encode_ack(sess, acked) -> bytes:
    rec = np.zeros(len(np.atleast_1d(np.asarray(sess))), ack_dtype)
    rec["sess"] = np.asarray(sess)
    rec["acked"] = np.asarray(acked)
    body = _ACK_HDR.pack(T_ACK, 0, 0, len(rec)) + rec.tobytes()
    return _LEN.pack(len(body)) + body


def decode_ack(body: bytes) -> np.ndarray:
    t, _a, _b, count = _ACK_HDR.unpack_from(body)
    if t != T_ACK:
        raise ValueError(f"not an ACK frame (type {t})")
    return np.frombuffer(body, ack_dtype, count, _ACK_HDR.size)


# -- consistent reads --------------------------------------------

def read_reply_dtype(reply_width: int) -> np.dtype:
    """Packed READ_REPLY record: one served/refused read outcome.
    ``wm`` is the commit watermark the read was served at (-1 when the
    read was refused — ``status`` then carries the ladder verdict or
    the stale-refusal marker)."""
    return np.dtype([("sess", "<u2"), ("seqno", "<u8"), ("status", "u1"),
                     ("wm", "<i4"), ("pay", "<i4", (int(reply_width),))])


_READ_REPLY_HDR = struct.Struct("<BBHH")  # type, width, pad, count


def encode_read(sess, seqnos, queries, *, payload_width: int) -> bytes:
    """Encode a batch of consistent-read queries at the connection's
    DATA stride (type=T_READ; query columns zero-padded to C) — one
    structured-array fill, no per-record Python, and the server's
    single fixed-stride sweep stays intact."""
    queries = np.asarray(queries)
    if queries.ndim == 1:
        queries = queries[:, None]
    n, cq = queries.shape
    if cq > payload_width:
        raise ValueError(
            f"query width {cq} exceeds negotiated payload width "
            f"{payload_width}")
    rec = np.zeros(n, data_dtype(payload_width))
    rec["len"] = rec.dtype.itemsize - 4
    rec["type"] = T_READ
    rec["sess"] = np.asarray(sess)
    rec["seqno"] = np.asarray(seqnos)
    rec["pay"][:, :cq] = queries
    return rec.tobytes()


def encode_read_reply(sess, seqnos, statuses, wms, payloads) -> bytes:
    """Serialize served/refused read outcomes as one READ_REPLY frame
    (vectorized records under a small header, like CREDIT/ACK)."""
    payloads = np.asarray(payloads)
    if payloads.ndim == 1:
        payloads = payloads[:, None]
    n, w = payloads.shape
    rec = np.zeros(n, read_reply_dtype(w))
    rec["sess"] = np.asarray(sess)
    rec["seqno"] = np.asarray(seqnos)
    rec["status"] = np.asarray(statuses)
    rec["wm"] = np.asarray(wms)
    rec["pay"] = payloads
    body = _READ_REPLY_HDR.pack(T_READ_REPLY, w, 0, n) + rec.tobytes()
    return _LEN.pack(len(body)) + body


def decode_read_reply(body: bytes) -> np.ndarray:
    """READ_REPLY body -> records (vectorized client-side decode)."""
    t, width, _p, count = _READ_REPLY_HDR.unpack_from(body)
    if t != T_READ_REPLY:
        raise ValueError(f"not a READ_REPLY frame (type {t})")
    return np.frombuffer(body, read_reply_dtype(width), count,
                         _READ_REPLY_HDR.size)


def read_frame(buf: bytes, offset: int = 0):
    """Client-side frame walk over a received byte buffer: returns
    ``(type, body, next_offset)`` or ``None`` when the buffer holds no
    complete frame at ``offset`` (control-plane parsing — the server
    side never walks frames, it sweeps)."""
    if len(buf) - offset < _LEN.size:
        return None
    (length,) = _LEN.unpack_from(buf, offset)
    start = offset + _LEN.size
    if len(buf) - start < length or length < 1:
        return None
    body = buf[start:start + length]
    return body[0], body, start + length
