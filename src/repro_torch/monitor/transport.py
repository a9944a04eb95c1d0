"""The monitor's transport seam: how shard deltas travel host -> aggregator.

:class:`Transport` is deliberately tiny — ``send`` one message, ``recv``
a batch — so the in-process queue used by tests and single-node runs, a
socket/RPC transport, and the fault-injection wrapper are interchangeable.
Messages are the producer dataclasses (:class:`~repro_torch.monitor.producer.
ShardDelta` / ``Heartbeat``); the transport never inspects them.

Delivery contract the aggregator is built against (and the ONLY one a
transport must honor): messages may be dropped at send time — signalled
by :class:`TransportError`, the producer's retry/backoff loop handles it
— and delivered messages may arrive late, duplicated, or out of order.
:class:`FaultyTransport` exercises exactly that contract with seeded,
reproducible fault schedules; it is both the chaos-test harness and a
user-facing tool for rehearsing fleet misbehavior.
"""
from __future__ import annotations

import collections
import random
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple


class TransportError(RuntimeError):
    """A send failed (message NOT delivered unless stated otherwise).

    Producers treat this as retryable: back off exponentially and resend.
    The ack-loss fault delivers the message AND raises — the resend then
    produces a duplicate, which the aggregator's sequence windows absorb.
    """


class Transport:
    """Abstract one-way message channel, producer(s) -> aggregator."""

    def send(self, msg: Any) -> None:
        raise NotImplementedError

    def recv(self, max_messages: Optional[int] = None) -> List[Any]:
        """Drain up to ``max_messages`` delivered messages (all, if None)."""
        raise NotImplementedError

    def pending(self) -> int:
        """Messages delivered but not yet received."""
        raise NotImplementedError


class QueueTransport(Transport):
    """In-process FIFO transport (thread-safe) — the reliable baseline."""

    def __init__(self):
        self._q: collections.deque = collections.deque()
        self._lock = threading.Lock()

    def send(self, msg: Any) -> None:
        with self._lock:
            self._q.append(msg)

    def recv(self, max_messages: Optional[int] = None) -> List[Any]:
        out: List[Any] = []
        with self._lock:
            while self._q and (max_messages is None
                               or len(out) < max_messages):
                out.append(self._q.popleft())
        return out

    def pending(self) -> int:
        with self._lock:
            return len(self._q)


class FaultyTransport(Transport):
    """Seeded fault-injection wrapper around another transport.

    Per-send faults, each drawn independently from one ``random.Random``
    seeded at construction (identical seeds replay identical schedules):

    * ``p_drop`` — the message is NOT delivered and ``send`` raises
      :class:`TransportError` (the producer retries).
    * ``p_ack_loss`` — the message IS delivered but ``send`` still raises
      (a lost acknowledgment): the producer's retry creates a duplicate.
    * ``p_dup`` — the message is delivered twice.
    * ``p_delay`` — delivery is held for 1..``max_delay`` ``recv`` calls,
      letting later sends overtake it (reordering).
    * ``outages`` — (start, stop) send-index windows in which every send
      raises (a dead link / crashed receiver window).

    ``stats`` counts every fault fired, so tests can assert the schedule
    actually exercised what it claims to.
    """

    def __init__(self, inner: Optional[Transport] = None, *, seed: int = 0,
                 p_drop: float = 0.0, p_ack_loss: float = 0.0,
                 p_dup: float = 0.0, p_delay: float = 0.0,
                 max_delay: int = 3,
                 outages: Sequence[Tuple[int, int]] = ()):
        self.inner = inner if inner is not None else QueueTransport()
        self.rng = random.Random(seed)
        self.p_drop = float(p_drop)
        self.p_ack_loss = float(p_ack_loss)
        self.p_dup = float(p_dup)
        self.p_delay = float(p_delay)
        self.max_delay = int(max_delay)
        self.outages = [(int(lo), int(hi)) for lo, hi in outages]
        self.stats: Dict[str, int] = collections.Counter()
        self._held: List[List[Any]] = []       # [countdown, msg]
        self._sends = 0
        # re-entrant: a socket inner transport's reconnect hook replays
        # unacked deltas through THIS send while it holds the lock
        self._lock = threading.RLock()

    # -- the faulty side -----------------------------------------------
    def send(self, msg: Any) -> None:
        with self._lock:
            i = self._sends
            self._sends += 1
            self.stats["sends"] += 1
            for lo, hi in self.outages:
                if lo <= i < hi:
                    self.stats["outage"] += 1
                    raise TransportError(
                        f"outage window [{lo}, {hi}) swallowed send {i}")
            if self.rng.random() < self.p_drop:
                self.stats["dropped"] += 1
                raise TransportError(f"send {i} dropped")
            copies = 1
            if self.rng.random() < self.p_dup:
                self.stats["duplicated"] += 1
                copies = 2
            for _ in range(copies):
                if self.rng.random() < self.p_delay:
                    self.stats["delayed"] += 1
                    self._held.append(
                        [self.rng.randint(1, self.max_delay), msg])
                else:
                    self.inner.send(msg)
            if self.rng.random() < self.p_ack_loss:
                self.stats["ack_lost"] += 1
                raise TransportError(f"ack for send {i} lost "
                                     f"(message delivered)")

    def recv(self, max_messages: Optional[int] = None) -> List[Any]:
        with self._lock:
            still: List[List[Any]] = []
            for h in self._held:
                h[0] -= 1
                if h[0] <= 0:
                    self.inner.send(h[1])      # released: arrives late
                else:
                    still.append(h)
            self._held = still
        return self.inner.recv(max_messages)

    def pending(self) -> int:
        with self._lock:
            return self.inner.pending() + len(self._held)

    def flush_held(self) -> None:
        """Release every held message now (end-of-run eventual delivery)."""
        with self._lock:
            for _, msg in self._held:
                self.inner.send(msg)
            self._held = []
