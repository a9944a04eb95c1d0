"""Deterministic synthetic data pipeline with per-rank sharding.

The port's copy of the JAX package's ``repro.data.pipeline`` (pure numpy;
batches are bitwise equal to the reference's, ``tests/test_torch_data.py``).

Real-cluster shape: each host consumes only its shard of the global batch
(``shard(num_shards, index)``), batches are produced deterministically from
``(seed, step)`` so an elastic restart at step k regenerates exactly the
same stream on any number of hosts — data determinism is what makes
checkpoint/restart and elastic re-sharding exact rather than approximate.

Tokens are generated by a counter-based hash (SplitMix64) so there is no
RNG state to checkpoint: ``batch(step)`` is a pure function.  A Zipf-like
mixing step skews the marginal token distribution so losses/grad norms look
like text training rather than uniform noise (embedding gradient sparsity,
softmax tail behaviour).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Counter-based hash; uint64 in, uint64 out (vectorized, stateless)."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


@dataclasses.dataclass(frozen=True)
class SyntheticLMDataset:
    """Pure-function batches: ``batch(step)`` -> {tokens[, frames|patches]}."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_shards: int = 1
    shard_index: int = 0
    # modality frontend stubs (encdec/vlm): precomputed embeddings
    frontend_len: int = 0
    d_model: int = 0
    frontend_key: str = ""           # "frames" | "patches" | ""
    zipf_bits: int = 4               # top 2^-k mass concentration knob

    def __post_init__(self):
        assert self.global_batch % self.num_shards == 0, \
            (self.global_batch, self.num_shards)

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.num_shards

    def shard(self, num_shards: int, index: int) -> "SyntheticLMDataset":
        assert 0 <= index < num_shards
        return dataclasses.replace(self, num_shards=num_shards,
                                   shard_index=index)

    # ------------------------------------------------------------------
    def _row_counters(self, step: int, per_row: int, channel: int
                      ) -> np.ndarray:
        """Counters indexed by GLOBAL row id — a shard's rows are exactly
        the corresponding slice of the unsharded stream (partition
        property; tested by hypothesis in tests/test_torch_data.py)."""
        B = self.local_batch
        row0 = self.shard_index * B
        base = (np.uint64(self.seed) << np.uint64(48)) \
            + (np.uint64(step) << np.uint64(28)) \
            + (np.uint64(channel) << np.uint64(26))
        rows = (row0 + np.arange(B, dtype=np.uint64))[:, None]
        cols = np.arange(per_row, dtype=np.uint64)[None, :]
        return base + rows * np.uint64(per_row) + cols

    def tokens(self, step: int) -> np.ndarray:
        """(local_batch, seq_len + 1) int32; labels are tokens shifted."""
        B, S = self.local_batch, self.seq_len + 1
        h = _splitmix64(self._row_counters(step, S, channel=0))
        # Zipf-ish skew: with prob 1/2 fold the id into the low-id region
        fold = (h >> np.uint64(32)) & np.uint64((1 << self.zipf_bits) - 1)
        ids = h % np.uint64(self.vocab_size)
        low = h % np.uint64(max(self.vocab_size >> self.zipf_bits, 1))
        return np.where(fold == 0, ids, low).astype(np.int32)

    def frontend(self, step: int) -> Optional[np.ndarray]:
        """(local_batch, frontend_len, d_model) float32 embeddings stub."""
        if not self.frontend_key:
            return None
        B, L, D = self.local_batch, self.frontend_len, self.d_model
        h = _splitmix64(self._row_counters(step, L * D, channel=1))
        u = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        x = (u.astype(np.float32) * 2.0 - 1.0).reshape(B, L, D)
        return x / np.sqrt(D, dtype=np.float32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {"tokens": self.tokens(step)}
        fr = self.frontend(step)
        if fr is not None:
            out[self.frontend_key] = fr
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_dataset(cfg: ArchConfig, shape: ShapeConfig, *, seed: int = 0,
                 num_shards: int = 1, shard_index: int = 0,
                 global_batch: Optional[int] = None) -> SyntheticLMDataset:
    frontend_key = {"encdec": "frames", "vlm": "patches"}.get(cfg.family, "")
    return SyntheticLMDataset(
        vocab_size=cfg.vocab_size,
        seq_len=shape.seq_len,
        global_batch=global_batch or shape.global_batch,
        seed=seed,
        num_shards=num_shards,
        shard_index=shard_index,
        frontend_len=cfg.frontend_len if frontend_key else 0,
        d_model=cfg.d_model if frontend_key else 0,
        frontend_key=frontend_key,
    )
