"""Always-on monitoring: streaming shard ingestion + resident detection.

The package turns the one-shot detect/backtrack pipeline into a
fault-tolerant service (ROADMAP: "always-on monitor"):

* :mod:`~repro_torch.monitor.transport` — the pluggable delivery seam
  (``Transport`` / ``QueueTransport``) and the seeded fault injector
  (``FaultyTransport``).
* :mod:`~repro_torch.monitor.producer` — per-host dirty-row flushing with
  sequence numbers, retry/backoff, and an unacked buffer
  (``ShardProducer`` / ``ShardDelta`` / ``Heartbeat``).
* :mod:`~repro_torch.monitor.aggregator` — the resident ``Monitor``:
  idempotent sequence-window ingestion, heartbeats/staleness, degraded
  (live-subfleet) detection, snapshot/restore, report streaming.
* :mod:`~repro_torch.monitor.degraded` — live-subfleet PPG compaction.
* :mod:`~repro_torch.monitor.chaos` — the end-to-end chaos harness
  (``chaos_run``), used by tests, ``tools_torch/chaos_smoke_torch.py``
  and ``chip_smoke.py``.
* :mod:`~repro_torch.monitor.wire` — the versioned wire protocol: CRC-checked
  length-prefixed frames plus the delta-compression codec
  (``DeltaEncoder`` / ``DeltaDecoder`` / ``FrameReader``).
* :mod:`~repro_torch.monitor.net` — the real-network transport:
  ``SocketTransport`` (reconnecting TCP client) / ``SocketServer``
  (aggregator accept/drain loop) / ``SocketChaosProxy`` (real-socket
  fault injection) and the end-to-end ``socket_chaos_run`` scenario.
* :mod:`~repro_torch.monitor.clock` — the injectable time seam
  (``Clock`` / ``SystemClock`` / ``ManualClock``).

The port's copy of the JAX package's ``repro.monitor``: the Monitor
detects on ``backend="torch"`` (``cuda`` unless ``device="cpu"``), through
the fused abnormal op on device-resident shard buffers.  Importing the
package does not import torch (detection backends resolve lazily).
"""
from repro_torch.monitor.aggregator import (FleetStatus, HostStatus, Monitor,
                                            MonitorReport)
from repro_torch.monitor.chaos import ChaosResult, build_chaos_psg, chaos_run
from repro_torch.monitor.clock import Clock, ManualClock, SystemClock, as_clock
from repro_torch.monitor.degraded import live_subppg, remap_paths
from repro_torch.monitor.net import (ProducerLink, SocketChaosProxy,
                                     SocketServer, SocketTransport,
                                     socket_chaos_run, stores_equal)
from repro_torch.monitor.producer import Heartbeat, ShardDelta, ShardProducer
from repro_torch.monitor.transport import (FaultyTransport, QueueTransport,
                                           Transport, TransportError)
from repro_torch.monitor.wire import (Ack, DeltaDecoder, DeltaEncoder,
                                      FrameReader, WireError, decode_message,
                                      encode_frame, encode_message)

__all__ = [
    "Ack", "ChaosResult", "Clock", "DeltaDecoder", "DeltaEncoder",
    "FaultyTransport", "FleetStatus", "FrameReader", "Heartbeat",
    "HostStatus", "ManualClock", "Monitor", "MonitorReport", "ProducerLink",
    "QueueTransport", "ShardDelta", "ShardProducer", "SocketChaosProxy",
    "SocketServer", "SocketTransport", "SystemClock", "Transport",
    "TransportError", "WireError", "as_clock", "build_chaos_psg",
    "chaos_run", "decode_message", "encode_frame", "encode_message",
    "live_subppg", "remap_paths", "socket_chaos_run", "stores_equal",
]
