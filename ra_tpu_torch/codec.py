"""The command codec — one schema'd, versioned binary image from socket
to segment: the port's own copy of ``ra_tpu/codec.py``.

A command is encoded ONCE — at the wire client for remote traffic, or at
leader append for local traffic — and the resulting *payload image* is
relayed as raw bytes through every later hop: the TCP compact forms
(``__cmds2__`` / ``__aer__``), the WAL batch-run records, segment files,
follower append, apply, and recovery all carry the same byte layout and
never re-pickle.  Pickle survives only as a *tagged, versioned fallback
record type* for arbitrary-object machines (``encode_fallback``), and as
decode-only legacy branches so WAL/segment dirs written before this
format still recover.

Record types (first byte is the tag; pickle protocol >= 2 streams always
start with 0x80, so tags 0x01-0x03 are collision-free):

  0x02  USER v1 — fixed-layout UserCommand record::

          <B tag><B version><B reply_mode><B flags>
          <I data_len><H corr_len><H notify_len><H from_len><H reply_from_len>
          data | correlation | notify_to | from_ | reply_from

        flags bit0: the data section is raw bytes (no value-codec kind
        byte — the dominant shape on the bench path).  All other
        sections (and non-bytes data) use the value mini-codec below.

  0x03  FALLBACK v1 — ``<B tag><B version>`` + pickle of the
        handle-stripped command.  The ONLY sanctioned object-encode on a
        hot path (lint rule RA10's codec family points here).

  0x01  legacy fast-tuple frame (pre-codec durable image) — decode only.
  0x80+ legacy raw pickle — decode only.

Value mini-codec (one kind byte + body); anything unrepresentable
falls to a per-field pickle (kind 5), and a section that would overflow
its u16 length field demotes the whole record to FALLBACK:

  0 None · 1 i64 · 2 bytes · 3 utf-8 str · 4 tuple (u8 count,
  u32-length-prefixed elements, recursive) · 5 field pickle ·
  6 all-int tuple (u8 count, count x i64 — the (cid, seq) correlation
  fast path)
"""
from __future__ import annotations

import pickle
import struct
from typing import Any, Optional

from .convert import loads as _classic_loads
from .core.types import ReplyMode, UserCommand, strip_local_handles

#: bump whenever the byte layout of any record type changes; the golden
#: corpus pin in tests/test_codec.py fails if layout moves without it
CODEC_VERSION = 1

TAG_LEGACY_FAST = 0x01  # pre-codec fast-tuple frame (decode only)
TAG_USER = 0x02
TAG_FALLBACK = 0x03

_TAG_USER_B = bytes([TAG_USER])
_TAG_FALLBACK_B = bytes([TAG_FALLBACK])

#: tag, version, reply_mode, flags, data_len, corr/notify/from_/reply_from
_USER_HDR = struct.Struct("<BBBBIHHHH")
_USER_HDR_SIZE = _USER_HDR.size  # 16

_F_DATA_RAW = 0x01  # data section is raw bytes, no kind byte

#: ReplyMode <-> u8 wire codes.  Codes are part of the v1 layout — append
#: only, never renumber (the golden corpus pins them).
_RM_CODE = {
    ReplyMode.AFTER_LOG_APPEND: 0,
    ReplyMode.AWAIT_CONSENSUS: 1,
    ReplyMode.NOTIFY: 2,
    ReplyMode.NOREPLY: 3,
}
_RM_FROM_CODE = {v: k for k, v in _RM_CODE.items()}

_K_NONE = b"\x00"
_K_INT = 1
_K_BYTES = b"\x02"
_K_STR = b"\x03"
_K_TUPLE = 4
_K_PICKLE = b"\x05"
_K_ITUP = 6

_S_INT = struct.Struct("<Bq")
_S_ITUP2 = struct.Struct("<BBqq")   # kind, count=2, a, b
_S_Q2 = struct.Struct("<qq")
_S_U32 = struct.Struct("<I")
_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1

_dumps = pickle.dumps
#: every FALLBACK / legacy pickle decodes through the port's classic
#: reader, which also reads the reference's images (convert.py)
_loads = _classic_loads
_PROTO = pickle.HIGHEST_PROTOCOL

#: UserCommand assembly through the slot descriptors — the frozen
#: dataclass __init__ funnels every field through object.__setattr__
#: plus the default-argument machinery (~0.8us); the descriptors set
#: the same slots in ~0.4us.  This is the decode-side twin of the
#: ingress-side slots=True decision on UserCommand itself.
_UC_NEW = UserCommand.__new__
_UC_SET_DATA = UserCommand.data.__set__
_UC_SET_RM = UserCommand.reply_mode.__set__
_UC_SET_CORR = UserCommand.correlation.__set__
_UC_SET_NOTIFY = UserCommand.notify_to.__set__
_UC_SET_FROM = UserCommand.from_.__set__
_UC_SET_RFROM = UserCommand.reply_from.__set__
_UC_SET_TRACE = UserCommand.trace.__set__


def build_user(data: Any, reply_mode: Any, correlation: Any,
               notify_to: Any, from_: Any, reply_from: Any,
               trace: Any = None) -> UserCommand:
    """A UserCommand built via the slot descriptors — ~2x cheaper than
    the frozen-dataclass constructor; used on the decode hot path where
    one instance is minted per command per member."""
    c = _UC_NEW(UserCommand)
    _UC_SET_DATA(c, data)
    _UC_SET_RM(c, reply_mode)
    _UC_SET_CORR(c, correlation)
    _UC_SET_NOTIFY(c, notify_to)
    _UC_SET_FROM(c, from_)
    _UC_SET_RFROM(c, reply_from)
    _UC_SET_TRACE(c, trace)
    return c

#: value-keyed memo for hot tuple sections.  The wire client mints ONE
#: notify handle per batch and stamps it into every command's image, so
#: encode sees the same tuple object thousands of times and decode sees
#: the same section bytes — both sides collapse the recursive walk to a
#: dict hit.  Tuples are immutable, so caching by value is safe; bounded
#: and cleared on overflow so a churn of distinct handles can't leak.
_TUP_CACHE_MAX = 512
_tup_enc_cache: dict = {}
_tup_dec_cache: dict = {}


class CodecError(ValueError):
    """A payload image is malformed (truncated, bit-flipped, or from a
    codec version this build does not know)."""


# ---------------------------------------------------------------------------
# value mini-codec
# ---------------------------------------------------------------------------

def _enc_tuple(v: tuple) -> bytes:
    if len(v) == 2:
        a, b = v
        if type(a) is int and type(b) is int \
                and _I64_MIN <= a <= _I64_MAX \
                and _I64_MIN <= b <= _I64_MAX:
            return _S_ITUP2.pack(_K_ITUP, 2, a, b)
    try:
        cached = _tup_enc_cache.get(v)
    except TypeError:           # unhashable element somewhere inside
        cached = None
        cacheable = False
    else:
        cacheable = True
        if cached is not None:
            return cached
    if len(v) > 255:
        out = _K_PICKLE + _dumps(v, protocol=_PROTO)  # ra10-ok: kind-5 FIELD pickle INSIDE a versioned record (oversized tuple)
    elif v and all(type(e) is int and _I64_MIN <= e <= _I64_MAX
                   for e in v):
        out = struct.pack("<BB%dq" % len(v), _K_ITUP, len(v), *v)
    else:
        parts = [struct.pack("<BB", _K_TUPLE, len(v))]
        for e in v:
            eb = _enc_val(e)
            parts.append(_S_U32.pack(len(eb)))
            parts.append(eb)
        out = b"".join(parts)
    if cacheable:
        if len(_tup_enc_cache) >= _TUP_CACHE_MAX:
            _tup_enc_cache.clear()
        _tup_enc_cache[v] = out
    return out


def _enc_val(v: Any) -> bytes:
    if v is None:
        return _K_NONE
    t = type(v)
    if t is int:
        if _I64_MIN <= v <= _I64_MAX:
            return _S_INT.pack(_K_INT, v)
        return _K_PICKLE + _dumps(v, protocol=_PROTO)  # ra10-ok: kind-5 FIELD pickle INSIDE a versioned record (bignum)
    if t is bytes:
        return _K_BYTES + v
    if t is str:
        return _K_STR + v.encode("utf-8")
    if t is tuple:
        return _enc_tuple(v)
    return _K_PICKLE + _dumps(v, protocol=_PROTO)  # ra10-ok: kind-5 FIELD pickle INSIDE a versioned record (generic value)


def _dec_val(b: bytes) -> Any:
    kind = b[0]
    if kind == 0:
        if len(b) != 1:
            raise ValueError("oversized None section")
        return None
    if kind == _K_INT:
        return _S_INT.unpack(b)[1]
    if kind == 0x02:
        return b[1:]
    if kind == 0x03:
        return b[1:].decode("utf-8")
    if kind == _K_ITUP:
        n = b[1]
        if len(b) != 2 + 8 * n:
            raise ValueError("oversized int-tuple section")
        if n == 2:
            return _S_Q2.unpack_from(b, 2)
        return struct.unpack_from("<%dq" % n, b, 2) if n else ()
    if kind == _K_TUPLE:
        cached = _tup_dec_cache.get(b)
        if cached is not None:
            return cached
        n = b[1]
        out = []
        off = 2
        for _ in range(n):
            (elen,) = _S_U32.unpack_from(b, off)
            off += 4
            if off + elen > len(b):
                raise ValueError("truncated tuple element")
            out.append(_dec_val(b[off:off + elen]))
            off += elen
        if off != len(b):
            raise ValueError("trailing bytes in tuple section")
        val = tuple(out)
        try:
            if len(_tup_dec_cache) >= _TUP_CACHE_MAX:
                _tup_dec_cache.clear()
            _tup_dec_cache[b] = val
        except TypeError:
            pass
        return val
    if kind == 0x05:
        return _loads(b[1:])
    raise ValueError("unknown value kind %d" % kind)


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def _handle(v: Any) -> Any:
    """Process-local reply handles (futures/callables) never leave the
    process; remote (str/int/tuple) handles survive — a failed-over
    leader owes those notifications (see types.strip_local_handles)."""
    return v if isinstance(v, (str, int, tuple)) else None


def encode_user(data: Any, reply_mode: ReplyMode, correlation: Any,
                notify_to: Any, from_: Any, reply_from: Any,
                ) -> Optional[bytes]:
    """USER v1 image of the given command fields, or None when the shape
    does not fit the fixed layout (caller demotes to encode_fallback)."""
    rm = _RM_CODE.get(reply_mode)
    if rm is None:
        return None
    if type(data) is bytes:
        flags = _F_DATA_RAW
        db = data
    else:
        flags = 0
        db = _enc_val(data)
    # sections, common shapes inlined: correlation is None or a small
    # tuple ((cid, seq) on the wire path); notify_to is ONE handle tuple
    # per batch (the value-keyed cache hit); from_/reply_from are None
    # on virtually every hot-path command
    if correlation is None:
        cb = _K_NONE
    elif type(correlation) is tuple:
        cb = _enc_tuple(correlation)
    else:
        cb = _enc_val(correlation)
    if notify_to is None:
        nb = _K_NONE
    elif type(notify_to) is tuple:
        try:
            nb = _tup_enc_cache[notify_to]
        except (KeyError, TypeError):
            nb = _enc_tuple(notify_to)
    else:
        h = _handle(notify_to)
        nb = _K_NONE if h is None else _enc_val(h)
    if from_ is None:
        fb = _K_NONE
    else:
        h = _handle(from_)
        fb = _K_NONE if h is None else _enc_val(h)
    rb = _K_NONE if reply_from is None else _enc_val(reply_from)
    ld = len(db)
    lc = len(cb)
    ln = len(nb)
    lf = len(fb)
    lr = len(rb)
    if ld > 0xFFFFFFFF or lc > 0xFFFF or ln > 0xFFFF or lf > 0xFFFF \
            or lr > 0xFFFF:
        return None
    return b"".join((_USER_HDR.pack(TAG_USER, CODEC_VERSION, rm, flags,
                                    ld, lc, ln, lf, lr),
                     db, cb, nb, fb, rb))


def encode_fallback(obj: Any) -> bytes:
    """Tagged, versioned pickle record — the sanctioned escape hatch for
    arbitrary-object commands (noop/membership/cluster ops, machines
    with unpicklable-into-v1 shapes)."""
    return _TAG_FALLBACK_B + bytes([CODEC_VERSION]) \
        + _dumps(strip_local_handles(obj), protocol=_PROTO)  # ra10-ok: the codec's own tagged fallback record type — every hot-path object-encode is funneled through here by design


def encode_command(cmd: Any) -> bytes:
    """Durable/wire image of a log command: USER v1 when it fits the
    fixed layout, tagged fallback otherwise."""
    if type(cmd) is UserCommand:
        img = encode_user(cmd.data, cmd.reply_mode, cmd.correlation,
                          cmd.notify_to, cmd.from_, cmd.reply_from)
        if img is not None:
            return img
    return encode_fallback(cmd)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode_user_parts(payload: bytes) -> tuple:
    """(data, reply_mode, correlation, notify_to, from_, reply_from) of a
    USER record — the wire receiver uses this to attach a trace context
    in the same construction instead of rebuilding the dataclass."""
    tag, ver, rm, flags, dlen, clen, nlen, flen, rlen = \
        _USER_HDR.unpack_from(payload, 0)
    if ver > CODEC_VERSION:
        raise ValueError("USER record v%d from a newer codec" % ver)
    if _USER_HDR_SIZE + dlen + clen + nlen + flen + rlen != len(payload):
        raise ValueError("USER record length mismatch")
    reply_mode = _RM_FROM_CODE.get(rm)
    if reply_mode is None:
        raise ValueError("unknown reply_mode code %d" % rm)
    end = _USER_HDR_SIZE + dlen
    db = payload[_USER_HDR_SIZE:end]
    data = db if flags & _F_DATA_RAW else _dec_val(db)
    # sections unrolled, dominant shapes first: correlation is the
    # 18-byte (cid, seq) int-pair or None; notify_to is one handle tuple
    # per batch (dict hit on the section bytes); from_/reply_from None
    if clen == 18 and payload[end] == _K_ITUP and payload[end + 1] == 2:
        corr = _S_Q2.unpack_from(payload, end + 2)
        end += 18
    elif clen == 1 and payload[end] == 0:
        corr = None
        end += 1
    else:
        nxt = end + clen
        corr = _dec_val(payload[end:nxt])
        end = nxt
    if nlen == 1 and payload[end] == 0:
        notify = None
        end += 1
    else:
        nxt = end + nlen
        sect = payload[end:nxt]
        end = nxt
        notify = _tup_dec_cache.get(sect)
        if notify is None:
            notify = _dec_val(sect)
    if flen == 1 and payload[end] == 0:
        from_ = None
        end += 1
    else:
        nxt = end + flen
        from_ = _dec_val(payload[end:nxt])
        end = nxt
    if rlen == 1 and payload[end] == 0:
        reply_from = None
    else:
        reply_from = _dec_val(payload[end:end + rlen])
    return (data, reply_mode, corr, notify, from_, reply_from)


def decode_command(payload: bytes) -> Any:
    """Decode any payload image this repo has ever written: USER v1,
    tagged fallback, the pre-codec 0x01 fast-tuple frame, and raw-pickle
    images (the versioned read path that keeps r06 dirs recovering).
    Malformed images raise CodecError."""
    try:
        tag = payload[0]
        if tag == TAG_USER:
            return build_user(*decode_user_parts(payload))
        if tag == TAG_FALLBACK:
            if payload[1] > CODEC_VERSION:
                raise ValueError(
                    "FALLBACK record v%d from a newer codec" % payload[1])
            return _loads(payload[2:])
        if tag == TAG_LEGACY_FAST:
            fields = _loads(payload[1:])
            data, rm, corr, from_, notify = fields[:5]
            # frames written before the reply_from field carry five
            reply_from = fields[5] if len(fields) > 5 else None
            return UserCommand(data, ReplyMode(rm), corr, notify, from_,
                               reply_from)
        if tag >= 0x80:
            return _loads(payload)
        raise ValueError("unknown record tag 0x%02x" % tag)
    except CodecError:
        raise
    except Exception as exc:  # struct/pickle/unicode/index errors
        raise CodecError("corrupt payload image: %s" % (exc,)) from exc
