"""Per-host shard producers: dirty rows -> sequence-numbered deltas.

Each host owns one :class:`~repro_torch.core.shard.PerfShard` (its proc-range
block) that its profiler/replay writes into; :class:`ShardProducer`
periodically flushes the shard's DIRTY rows as a :class:`ShardDelta` —
the full current state of those rows (a ``PerfStore.extract_rows``
:class:`~repro_torch.core.graph.RowBlock`), stamped with a per-host monotone
sequence number.  Full row state + strictly in-order application on the
aggregator side make the protocol exactly idempotent: duplicates are
dropped by sequence, reordering is parked, and the replica converges
bit-identically to the source shard (see ``repro_torch.monitor.aggregator``).

Reliability is send-side: a failed send (:class:`~repro_torch.monitor.
transport.TransportError`) retries with exponential backoff; deltas stay
in the UNACKED buffer until the aggregator acknowledges their sequence
number (which it only does once they are safely snapshotted, when
snapshotting is on), so ``resend_unacked()`` replays everything a crashed
aggregator may have lost.  Both the clock and the backoff sleep are
injectable, keeping chaos tests deterministic and instant.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

from repro_torch.core.graph import RowBlock
from repro_torch.core.shard import PerfShard
from repro_torch.monitor.clock import as_clock
from repro_torch.monitor.transport import Transport, TransportError
from repro_torch.monitor.validate import backoff_bounds, non_negative_int


@dataclasses.dataclass
class ShardDelta:
    """One flush of a host's dirty rows.  ``block.rows`` are LOCAL shard
    rows (global proc = ``proc_start + row``); ``seq`` is per-host,
    starting at 1, with no gaps."""
    host: int
    seq: int
    proc_start: int
    block: RowBlock

    def nbytes(self) -> int:
        return self.block.nbytes()


@dataclasses.dataclass
class Heartbeat:
    """I-am-alive marker: refreshes the aggregator's staleness clock even
    when the host has nothing to flush.  ``seq`` is the last delta seq
    this host produced (0 before the first)."""
    host: int
    seq: int
    time: float


class ShardProducer:
    """One host's flush/retry/ack loop over the transport seam."""

    def __init__(self, host: int, shard: PerfShard, transport: Transport, *,
                 max_retries: int = 8, base_backoff: float = 0.01,
                 max_backoff: float = 1.0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Optional[Callable[[float], None]] = None):
        self.host = non_negative_int("host", host)
        self.shard = shard
        self.transport = transport
        self.max_retries = non_negative_int("max_retries", max_retries)
        self.base_backoff, self.max_backoff = backoff_bounds(
            "base_backoff", base_backoff, "max_backoff", max_backoff)
        # one Clock behind the legacy knob pair (see repro_torch.monitor.clock)
        self._clock = as_clock(clock, sleep)
        self.clock = self._clock.monotonic
        self.sleep = self._clock.sleep
        self.seq = 0                          # last produced delta seq
        self.acked = 0                        # last seq the aggregator owns
        self.unacked: Dict[int, ShardDelta] = {}
        self._unsent: List[int] = []          # seqs never sent successfully
        self.retries = 0
        self.send_failures = 0
        self.heartbeats_lost = 0

    # -- flushing ------------------------------------------------------
    def flush(self, *, heartbeat: bool = True) -> Optional[ShardDelta]:
        """Package the shard's dirty rows as the next delta and send it
        (with retry/backoff), then send a heartbeat.  Returns the delta,
        or None when nothing was dirty.  Previously-unsendable deltas are
        retried first, in sequence order, so a recovered link drains the
        backlog before new data."""
        for seq in list(self._unsent):
            delta = self.unacked.get(seq)
            if delta is None:                 # acked mid-drain (a socket
                if seq in self._unsent:       # send pumps acks inline)
                    self._unsent.remove(seq)
                continue
            if self._send_with_retry(delta) and seq in self._unsent:
                self._unsent.remove(seq)
        delta = None
        rows = self.shard.dirty_rows()
        if rows.size:
            block = self.shard.extract_rows(rows)
            self.shard.clear_dirty()
            self.seq += 1
            delta = ShardDelta(host=self.host, seq=self.seq,
                               proc_start=self.shard.proc_start, block=block)
            self.unacked[self.seq] = delta
            if not self._send_with_retry(delta):
                self._unsent.append(self.seq)
        if heartbeat:
            self.send_heartbeat()
        return delta

    def send_heartbeat(self) -> None:
        """Single-attempt (heartbeats are cheap and periodic; the next one
        covers for a lost one)."""
        try:
            self.transport.send(
                Heartbeat(host=self.host, seq=self.seq, time=self.clock()))
        except TransportError:
            self.heartbeats_lost += 1

    def _send_with_retry(self, msg) -> bool:
        delay = self.base_backoff
        for _ in range(self.max_retries + 1):
            try:
                self.transport.send(msg)
                return True
            except TransportError:
                self.retries += 1
                self.sleep(delay)
                delay = min(2.0 * delay, self.max_backoff)
        self.send_failures += 1
        return False

    # -- durability ----------------------------------------------------
    def ack(self, upto_seq: int) -> None:
        """The aggregator durably owns everything up to ``upto_seq``."""
        if upto_seq <= self.acked:
            return
        self.acked = int(upto_seq)
        for seq in [s for s in self.unacked if s <= upto_seq]:
            del self.unacked[seq]
            if seq in self._unsent:
                self._unsent.remove(seq)

    def resend_unacked(self) -> int:
        """Replay every unacked delta (aggregator crash recovery).  The
        restored aggregator's sequence windows drop whatever it already
        has.  Returns the number of deltas resent."""
        n = 0
        for seq in sorted(self.unacked):
            delta = self.unacked.get(seq)
            if delta is None:                 # acked mid-replay
                continue
            if self._send_with_retry(delta):
                n += 1
                if seq in self._unsent:
                    self._unsent.remove(seq)
            elif seq not in self._unsent:
                self._unsent.append(seq)
        return n
