"""Versioned wire protocol for the monitor's socket transport.

Everything a :class:`~repro_torch.monitor.producer.ShardDelta` / ``Heartbeat``
needs to cross a real network, pure python + numpy (no pickle — frames
are explicit, versioned, and checksummed):

* **Framing** — every message travels as one length-prefixed frame::

      offset  size  field
      0       4     magic  b"SCAW"
      4       1     protocol version (1)
      5       1     message type (1=delta, 2=heartbeat, 3=ack)
      6       4     payload length (u32, little-endian)
      10      4     CRC32 of the payload
      14      N     payload

  :class:`FrameReader` reassembles frames from an arbitrary byte stream
  and RESYNCS after corruption: on a bad magic, bad version, oversized
  length or CRC mismatch it scans forward for the next magic and keeps
  count (``stats``), so injected garbage or a torn frame costs the
  frames it overlapped, never the connection's sanity.

* **Serialization** — numpy payloads travel as typed byte blocks
  (little-endian dtype + raw bytes); counters as (vid, value, mask)
  triples trimmed to entries that carry data.

* **Delta compression** — :class:`DeltaEncoder` keeps the last
  transmitted state of every row it has sent; a steady-state flush
  re-encodes only the CHANGED columns of each dirty row (time / var /
  samples / mask at changed column indices, plus changed counter
  (vid, value, mask) triples), falling back to the full row whenever
  the diff is denser.  :class:`DeltaDecoder` mirrors the cache and
  reconstructs the full row state, so the aggregator still ingests
  full-state :class:`~repro_torch.core.graph.RowBlock` deltas — the Monitor
  is unchanged and the exactness contract (bit-identical convergence)
  is preserved.

  Correctness under loss: every diff row names the ``seq`` its base row
  was last encoded at; if the decoder's cache disagrees (frames were
  lost to a resync), the delta is REJECTED rather than mis-applied —
  the producer's unacked buffer resends it, and because the encoder
  emits a FULL row whenever a delta's seq has not advanced past the
  last seq it encoded for that row (i.e. a resend), the replay re-seeds
  the decoder's cache even on a live connection whose earlier frames
  were eaten by a resync.  Encoder and decoder caches are
  per-connection and reset on reconnect, so a fresh connection always
  starts from full rows.
"""
from __future__ import annotations

import collections
import dataclasses
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.graph import RowBlock
from repro_torch.monitor.producer import Heartbeat, ShardDelta

MAGIC = b"SCAW"
VERSION = 1
MSG_DELTA = 1
MSG_HEARTBEAT = 2
MSG_ACK = 3

HEADER = struct.Struct("<4sBBII")          # magic, version, type, len, crc
_DELTA_HEAD = struct.Struct("<iqqII")      # host, seq, proc_start, cols, rows
_ROW_HEAD = struct.Struct("<IB")           # local row, mode
_HEARTBEAT = struct.Struct("<iqd")         # host, seq, time
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")

ROW_FULL = 0
ROW_DIFF = 1

DEFAULT_MAX_FRAME = 64 * 1024 * 1024


@dataclasses.dataclass
class Ack:
    """Aggregator -> producer: cumulative durable sequence per host."""
    acks: Dict[int, int]


class WireError(ValueError):
    """A payload that framed correctly but does not parse."""


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

def encode_frame(msg_type: int, payload: bytes, *,
                 max_frame: int = DEFAULT_MAX_FRAME) -> bytes:
    """One wire frame: header (magic, version, type, length, CRC32) +
    payload.

    Raises :class:`WireError` when the payload exceeds ``max_frame`` —
    the receiver's :class:`FrameReader` would discard such a frame as
    oversize on every delivery, so silently sending it guarantees an
    endless resend loop; failing loudly on the send side surfaces the
    misconfiguration instead."""
    if len(payload) > max_frame:
        raise WireError(
            f"{len(payload)}-byte payload exceeds max_frame={max_frame}; "
            f"the receiver would discard it as oversize")
    return HEADER.pack(MAGIC, VERSION, msg_type, len(payload),
                       zlib.crc32(payload) & 0xFFFFFFFF) + payload


class FrameReader:
    """Incremental frame reassembly with resynchronization.

    ``feed(data)`` returns every complete, checksum-valid frame the
    stream now covers as ``(msg_type, payload)`` pairs.  Corruption
    (garbage bytes, torn frames, flipped bits) never raises: the reader
    skips to the next magic and records what it survived in ``stats``
    (``frames``, ``resyncs``, ``skipped_bytes``, ``crc_errors``,
    ``bad_version``, ``oversize``).
    """

    def __init__(self, max_frame: int = DEFAULT_MAX_FRAME):
        self.max_frame = int(max_frame)
        self._buf = bytearray()
        self.stats: Dict[str, int] = collections.Counter()

    def _resync(self) -> None:
        """Drop bytes up to the next possible frame start: the next full
        magic at offset >= 1, else a trailing proper prefix of the magic
        (the rest of it may still be in flight — dropping it would tear
        the healthy frame straddling the chunk boundary)."""
        idx = self._buf.find(MAGIC, 1)
        if idx < 0:
            idx = len(self._buf)
            for k in range(len(MAGIC) - 1, 0, -1):
                if idx - k >= 1 and self._buf[idx - k:idx] == MAGIC[:k]:
                    idx -= k
                    break
        del self._buf[:idx]
        self.stats["resyncs"] += 1
        self.stats["skipped_bytes"] += idx

    def feed(self, data: bytes) -> List[Tuple[int, bytes]]:
        self._buf.extend(data)
        out: List[Tuple[int, bytes]] = []
        while True:
            if len(self._buf) < HEADER.size:
                # a buffered prefix that can no longer start a frame is
                # garbage — drop it so it cannot absorb the next magic
                if self._buf and not MAGIC.startswith(
                        bytes(self._buf[:len(MAGIC)])):
                    self._resync()
                    continue
                return out
            magic, version, msg_type, length, crc = \
                HEADER.unpack_from(self._buf)
            if magic != MAGIC:
                self._resync()
                continue
            if version != VERSION:
                self.stats["bad_version"] += 1
                self._resync()
                continue
            if length > self.max_frame:
                self.stats["oversize"] += 1
                self._resync()
                continue
            end = HEADER.size + length
            if len(self._buf) < end:
                return out
            payload = bytes(self._buf[HEADER.size:end])
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                self.stats["crc_errors"] += 1
                self._resync()
                continue
            del self._buf[:end]
            self.stats["frames"] += 1
            out.append((msg_type, payload))

    def pending_bytes(self) -> int:
        return len(self._buf)

    def close(self) -> None:
        """Connection closed: a buffered partial frame is torn, count it."""
        if self._buf:
            self.stats["truncated"] += 1
            self._buf.clear()


# ---------------------------------------------------------------------------
# primitive packers
# ---------------------------------------------------------------------------

def _pack_arr(out: bytearray, a: np.ndarray, dtype: str) -> None:
    out += np.ascontiguousarray(a, dtype=dtype).tobytes()


def _take(payload: bytes, off: int, n: int, dtype: str,
          count: int) -> Tuple[np.ndarray, int]:
    a = np.frombuffer(payload, dtype=dtype, count=count, offset=off)
    return a, off + n


def _pack_str(out: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    if len(b) > 0xFFFF:
        raise WireError(f"counter name too long for the wire: {s[:32]!r}...")
    out += _U16.pack(len(b))
    out += b


def _unpack_str(payload: bytes, off: int) -> Tuple[str, int]:
    (n,) = _U16.unpack_from(payload, off)
    off += _U16.size
    return payload[off:off + n].decode("utf-8"), off + n


# ---------------------------------------------------------------------------
# row state (the codec's unit of caching)
# ---------------------------------------------------------------------------

class _RowState:
    """Full transmitted state of one shard row: the core column arrays
    plus trimmed counter entries {name: {vid: (value, mask)}}."""

    __slots__ = ("seq", "n_cols", "time", "var", "samples", "mask",
                 "counters")

    def __init__(self, seq: int, n_cols: int, time: np.ndarray,
                 var: np.ndarray, samples: np.ndarray, mask: np.ndarray,
                 counters: Dict[str, Dict[int, Tuple[float, bool]]]):
        self.seq = seq
        self.n_cols = n_cols
        self.time = time
        self.var = var
        self.samples = samples
        self.mask = mask
        self.counters = counters


def _row_counters(block: RowBlock, i: int
                  ) -> Dict[str, Dict[int, Tuple[float, bool]]]:
    """Row ``i``'s counter entries, trimmed to (value != 0) or masked —
    the entries that can affect the reconstructed store."""
    out: Dict[str, Dict[int, Tuple[float, bool]]] = {}
    for name, (vids, values, mask) in block.counters.items():
        row: Dict[int, Tuple[float, bool]] = {}
        v, m = values[i], mask[i]
        keep = np.nonzero(m | (v != 0.0))[0]
        for j in keep:
            row[int(vids[j])] = (float(v[j]), bool(m[j]))
        if row:
            out[name] = row
    return out


def _row_state(delta: ShardDelta, i: int) -> _RowState:
    b = delta.block
    return _RowState(delta.seq, int(b.n_cols),
                     np.ascontiguousarray(b.time[i], "<f8"),
                     np.ascontiguousarray(b.time_var[i], "<f8"),
                     np.ascontiguousarray(b.samples[i], "<i8"),
                     np.ascontiguousarray(b.mask[i], "?"),
                     _row_counters(b, i))


def _encode_counter_entries(out: bytearray,
                            entries: Dict[str, List[Tuple[int, float, bool]]]
                            ) -> None:
    out += _U16.pack(len(entries))
    for name, triples in entries.items():
        _pack_str(out, name)
        out += _U32.pack(len(triples))
        vids = np.array([t[0] for t in triples], "<i8")
        vals = np.array([t[1] for t in triples], "<f8")
        msk = np.array([t[2] for t in triples], "?")
        out += vids.tobytes() + vals.tobytes() + msk.tobytes()


def _decode_counter_entries(payload: bytes, off: int
                            ) -> Tuple[Dict[str, List[Tuple[int, float,
                                                            bool]]], int]:
    (n_names,) = _U16.unpack_from(payload, off)
    off += _U16.size
    out: Dict[str, List[Tuple[int, float, bool]]] = {}
    for _ in range(n_names):
        name, off = _unpack_str(payload, off)
        (k,) = _U32.unpack_from(payload, off)
        off += _U32.size
        vids, off = _take(payload, off, 8 * k, "<i8", k)
        vals, off = _take(payload, off, 8 * k, "<f8", k)
        msk, off = _take(payload, off, k, "?", k)
        out[name] = [(int(vids[j]), float(vals[j]), bool(msk[j]))
                     for j in range(k)]
    return out, off


def _encode_full_row(state: _RowState) -> bytes:
    out = bytearray()
    _pack_arr(out, state.time, "<f8")
    _pack_arr(out, state.var, "<f8")
    _pack_arr(out, state.samples, "<i8")
    _pack_arr(out, state.mask, "u1")
    _encode_counter_entries(out, {
        name: [(vid, v, m) for vid, (v, m) in sorted(row.items())]
        for name, row in sorted(state.counters.items())})
    return bytes(out)


def _encode_diff_row(prev: _RowState, cur: _RowState) -> bytes:
    out = bytearray()
    out += _I64.pack(prev.seq)
    changed = np.nonzero((prev.time != cur.time) | (prev.var != cur.var)
                         | (prev.samples != cur.samples)
                         | (prev.mask != cur.mask))[0]
    out += _U32.pack(len(changed))
    _pack_arr(out, changed, "<u4")
    _pack_arr(out, cur.time[changed], "<f8")
    _pack_arr(out, cur.var[changed], "<f8")
    _pack_arr(out, cur.samples[changed], "<i8")
    _pack_arr(out, cur.mask[changed], "u1")
    entries: Dict[str, List[Tuple[int, float, bool]]] = {}
    for name in sorted(set(prev.counters) | set(cur.counters)):
        p = prev.counters.get(name, {})
        c = cur.counters.get(name, {})
        triples = []
        for vid in sorted(set(p) | set(c)):
            want = c.get(vid, (0.0, False))
            if p.get(vid, (0.0, False)) != want:
                triples.append((vid, want[0], want[1]))
        if triples:
            entries[name] = triples
    _encode_counter_entries(out, entries)
    return bytes(out)


# ---------------------------------------------------------------------------
# the delta codec
# ---------------------------------------------------------------------------

class DeltaEncoder:
    """Serialize :class:`ShardDelta`\\ s, diffing rows against the last
    state transmitted on this connection.

    One encoder per connection (its cache and the peer
    :class:`DeltaDecoder`'s advance in lockstep with the byte stream);
    call :meth:`reset` on reconnect so the fresh connection re-seeds
    from full rows.  A send that fails mid-frame MUST tear the
    connection down (the socket transport does) — the caches tolerate
    lost frames via the per-row base-seq check, not mid-frame rewinds.

    A RESEND — a delta whose seq is not past the last seq this
    connection encoded for a row — always carries that row in full
    (``stats["resend_full_rows"]``): the cached state may belong to a
    frame the peer lost, so diffing against it could never decode.

    ``compress=False`` always emits full rows (the wire-bytes baseline
    the benchmark reports against).
    """

    def __init__(self, *, compress: bool = True):
        self.compress = bool(compress)
        self._rows: Dict[Tuple[int, int], _RowState] = {}
        self.stats: Dict[str, int] = collections.Counter()
        self.last_bytes = 0

    def reset(self) -> None:
        self._rows.clear()
        self.stats["resets"] += 1

    def encode(self, delta: ShardDelta) -> bytes:
        """The delta's frame payload (pass to ``encode_frame(MSG_DELTA,
        ...)``)."""
        b = delta.block
        rows = np.asarray(b.rows, np.int64)
        out = bytearray()
        out += _DELTA_HEAD.pack(delta.host, delta.seq, delta.proc_start,
                                int(b.n_cols), len(rows))
        for i, row in enumerate(rows.tolist()):
            cur = _row_state(delta, i)
            full = _encode_full_row(cur)
            enc, mode = full, ROW_FULL
            prev = self._rows.get((delta.host, row))
            # a RESEND (seq not past the last seq encoded for this row)
            # must go out full: the frame that advanced the cache may be
            # the very one the peer lost, so a diff against it would be
            # rejected on every retry — the stream would never reconverge
            if self.compress and prev is not None \
                    and prev.n_cols == cur.n_cols \
                    and delta.seq > prev.seq:
                diff = _encode_diff_row(prev, cur)
                if len(diff) < len(full):      # fall back when denser
                    enc, mode = diff, ROW_DIFF
            elif prev is not None and delta.seq <= prev.seq:
                self.stats["resend_full_rows"] += 1
            out += _ROW_HEAD.pack(row, mode)
            out += enc
            self._rows[(delta.host, row)] = cur
            self.stats["diff_rows" if mode == ROW_DIFF else "full_rows"] += 1
        self.stats["deltas"] += 1
        self.last_bytes = len(out)
        self.stats["payload_bytes"] += len(out)
        return bytes(out)


class DeltaDecoder:
    """Reconstruct full-state :class:`ShardDelta`\\ s from
    :class:`DeltaEncoder` payloads.

    Mirrors the encoder's per-row cache.  A diff row whose base seq does
    not match the cache (frames lost between the peers) makes the WHOLE
    delta undecodable — :meth:`decode` returns None and counts it in
    ``stats["undecodable"]`` — because applying it would silently
    corrupt the row.  The producer's unacked-resend machinery redelivers
    it as (or after) full rows.
    """

    def __init__(self):
        self._rows: Dict[Tuple[int, int], _RowState] = {}
        self.stats: Dict[str, int] = collections.Counter()

    def reset(self) -> None:
        self._rows.clear()

    def decode(self, payload: bytes) -> Optional[ShardDelta]:
        try:
            return self._decode(payload)
        except (struct.error, WireError, IndexError, UnicodeDecodeError,
                ValueError):
            self.stats["malformed"] += 1
            return None

    def _decode(self, payload: bytes) -> Optional[ShardDelta]:
        host, seq, proc_start, n_cols, n_rows = \
            _DELTA_HEAD.unpack_from(payload)
        off = _DELTA_HEAD.size
        states: List[Tuple[int, _RowState]] = []
        for _ in range(n_rows):
            row, mode = _ROW_HEAD.unpack_from(payload, off)
            off += _ROW_HEAD.size
            if mode == ROW_FULL:
                time, off = _take(payload, off, 8 * n_cols, "<f8", n_cols)
                var, off = _take(payload, off, 8 * n_cols, "<f8", n_cols)
                smp, off = _take(payload, off, 8 * n_cols, "<i8", n_cols)
                msk, off = _take(payload, off, n_cols, "u1", n_cols)
                entries, off = _decode_counter_entries(payload, off)
                counters = {name: {vid: (v, m) for vid, v, m in triples}
                            for name, triples in entries.items()}
                states.append((row, _RowState(
                    seq, n_cols, time.copy(), var.copy(),
                    smp.copy(), msk.astype(bool), counters)))
            elif mode == ROW_DIFF:
                (base_seq,) = _I64.unpack_from(payload, off)
                off += _I64.size
                (k,) = _U32.unpack_from(payload, off)
                off += _U32.size
                idx, off = _take(payload, off, 4 * k, "<u4", k)
                time, off = _take(payload, off, 8 * k, "<f8", k)
                var, off = _take(payload, off, 8 * k, "<f8", k)
                smp, off = _take(payload, off, 8 * k, "<i8", k)
                msk, off = _take(payload, off, k, "u1", k)
                entries, off = _decode_counter_entries(payload, off)
                prev = self._rows.get((host, row))
                if prev is None or prev.seq != base_seq \
                        or prev.n_cols != n_cols:
                    # broken diff chain: reject the delta, never guess
                    self.stats["undecodable"] += 1
                    return None
                nxt = _RowState(seq, n_cols, prev.time.copy(),
                                prev.var.copy(), prev.samples.copy(),
                                prev.mask.copy(),
                                {n: dict(r)
                                 for n, r in prev.counters.items()})
                nxt.time[idx] = time
                nxt.var[idx] = var
                nxt.samples[idx] = smp
                nxt.mask[idx] = msk.astype(bool)
                for name, triples in entries.items():
                    rowc = nxt.counters.setdefault(name, {})
                    for vid, v, m in triples:
                        if v == 0.0 and not m:
                            rowc.pop(vid, None)
                        else:
                            rowc[vid] = (v, m)
                    if not rowc:
                        del nxt.counters[name]
                states.append((row, nxt))
            else:
                raise WireError(f"unknown row mode {mode}")
        if off != len(payload):
            raise WireError(f"{len(payload) - off} trailing payload bytes")
        # all rows decoded: commit the cache, then assemble the block
        for row, st in states:
            self._rows[(host, row)] = st
        self.stats["deltas"] += 1
        block = self._assemble(n_cols, states)
        return ShardDelta(host=host, seq=seq, proc_start=proc_start,
                          block=block)

    @staticmethod
    def _assemble(n_cols: int,
                  states: List[Tuple[int, _RowState]]) -> RowBlock:
        k = len(states)
        rows = np.array([r for r, _ in states], np.intp)
        time = np.zeros((k, n_cols))
        var = np.zeros((k, n_cols))
        samples = np.zeros((k, n_cols), np.int64)
        mask = np.zeros((k, n_cols), bool)
        names: Dict[str, set] = {}
        for i, (_, st) in enumerate(states):
            time[i] = st.time
            var[i] = st.var
            samples[i] = st.samples
            mask[i] = st.mask
            for name, rowc in st.counters.items():
                names.setdefault(name, set()).update(rowc)
        counters: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        for name in sorted(names):
            vids = np.array(sorted(names[name]), np.int64)
            slot = {int(v): j for j, v in enumerate(vids)}
            vals = np.zeros((k, len(vids)))
            msk = np.zeros((k, len(vids)), bool)
            for i, (_, st) in enumerate(states):
                for vid, (v, m) in st.counters.get(name, {}).items():
                    j = slot[vid]
                    vals[i, j] = v
                    msk[i, j] = m
            counters[name] = (vids, vals, msk)
        return RowBlock(rows=rows, n_cols=n_cols, time=time, time_var=var,
                        samples=samples, mask=mask, counters=counters)


# ---------------------------------------------------------------------------
# whole-message encode/decode
# ---------------------------------------------------------------------------

def encode_message(msg, encoder: Optional[DeltaEncoder] = None, *,
                   max_frame: int = DEFAULT_MAX_FRAME) -> bytes:
    """``msg`` (ShardDelta / Heartbeat / Ack) as one complete frame.
    Deltas need the connection's :class:`DeltaEncoder`.  Raises
    :class:`WireError` when the payload exceeds ``max_frame`` (see
    :func:`encode_frame`)."""
    if isinstance(msg, ShardDelta):
        if encoder is None:
            encoder = DeltaEncoder(compress=False)
        return encode_frame(MSG_DELTA, encoder.encode(msg),
                            max_frame=max_frame)
    if isinstance(msg, Heartbeat):
        return encode_frame(MSG_HEARTBEAT, _HEARTBEAT.pack(
            msg.host, msg.seq, msg.time), max_frame=max_frame)
    if isinstance(msg, Ack):
        out = bytearray(_U32.pack(len(msg.acks)))
        for host, seq in sorted(msg.acks.items()):
            out += struct.pack("<iq", host, seq)
        return encode_frame(MSG_ACK, bytes(out), max_frame=max_frame)
    raise TypeError(f"cannot put {type(msg).__name__} on the wire")


def decode_message(msg_type: int, payload: bytes,
                   decoder: Optional[DeltaDecoder] = None):
    """Inverse of :func:`encode_message` for one framed payload; returns
    None for an undecodable delta (see :class:`DeltaDecoder`) and raises
    :class:`WireError` for unknown types / malformed payloads."""
    if msg_type == MSG_DELTA:
        if decoder is None:
            decoder = DeltaDecoder()
        return decoder.decode(payload)
    if msg_type == MSG_HEARTBEAT:
        try:
            host, seq, t = _HEARTBEAT.unpack(payload)
        except struct.error as e:
            raise WireError(f"bad heartbeat payload: {e}") from None
        return Heartbeat(host=host, seq=seq, time=t)
    if msg_type == MSG_ACK:
        try:
            (n,) = _U32.unpack_from(payload)
            acks = {}
            off = _U32.size
            for _ in range(n):
                host, seq = struct.unpack_from("<iq", payload, off)
                off += 12
                acks[host] = seq
            if off != len(payload):
                raise WireError("trailing ack bytes")
        except struct.error as e:
            raise WireError(f"bad ack payload: {e}") from None
        return Ack(acks=acks)
    raise WireError(f"unknown message type {msg_type}")
