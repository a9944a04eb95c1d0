"""Batched serving engine: slot-based continuous batching over a fixed
(batch_slots, max_seq) cache — the JAX package's ``serving/engine.py`` on
torch.

One decode step serves the whole slot batch; requests join and leave
slots without a change of shape.  Idle slots decode padding, masked out
at sampling time on the host.  The engine runs on the bundle's device:
``cuda`` unless the bundle was built with ``device="cpu"``.

Per-slot cache hygiene is generic across cache families (LM KV cache,
SSM state, hybrid): every cache leaf is either per-batch 1-D
(``length``-like, batch axis 0) or stacked (layers/sites first, batch
axis 1), so slot admission zeroes axis-0/1 rows and every decode call
overrides the length leaf with the host-tracked per-slot positions.

The port's ``decode_step`` writes each new K/V into the cache's buffers
in place (``attention_decode``), at the current position of every row,
the other slots' rows too.  That write lies past each other slot's
length and is written again, with that slot's own token, before it is
read; so a prefill leaves every other live slot's cached rows as they
were.  SSM states come back as new tensors, so :meth:`_merge_slot` keeps
the old states' rows for the other slots, as in the reference.

Sampling is reproducible under any batching order: greedy, or Gumbel
argmax with noise from a counter-based generator (numpy's Philox) keyed
on (request seed, uid) with the position as its counter.  The reference
draws its noise from ``jax.random`` (threefry), whose bits the port does
not reproduce: greedy streams equal the JAX engine's, sampled streams
are the port's own.

Two defenses keep token streams reproducible across engine instances:

* host-side bookkeeping arrays (``slot_pos``, ``last_token``) are copied
  into new tensors (``torch.tensor`` copies; ``torch.from_numpy`` and
  ``torch.as_tensor`` would alias them, so a later host write could
  reach a step still reading them).
* sampling uses a near-tie-stable argmax: every candidate within
  ``_TIE_TOL`` of the max is a tie, resolved to the lowest token id.  A
  request served alone and one served in a batch run products of other
  shapes, whose residual rounding skew the tie tolerance absorbs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch.models.api import ModelBundle

Cache = Any

# logits gaps below this are ties (resolved to the lowest token id); must
# sit well above cross-shape rounding skew (~1e-6 at logit scale ~3) and
# well below real logit gaps (~1e-1 for the smoke models)
_TIE_TOL = 1e-4


def _stable_argmax(z: np.ndarray, tol: float = _TIE_TOL) -> int:
    """Lowest index within ``tol`` of the max — invariant to sub-``tol``
    logit noise from products of other shapes."""
    return int(np.argmax(z >= z.max() - tol))


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0           # 0 => greedy
    seed: int = 0


@dataclasses.dataclass
class Result:
    uid: int
    tokens: List[int]
    prompt_len: int
    latency_s: float = 0.0


def _batch_axis(leaf: torch.Tensor, slots: int) -> Optional[int]:
    if leaf.ndim == 1 and leaf.shape[0] == slots:
        return 0
    if leaf.ndim >= 2 and leaf.shape[1] == slots:
        return 1
    return None


def _tree_map(fn: Callable, tree: Cache, *rest: Cache) -> Cache:
    """``fn`` over the tensors of a cache (NamedTuples of tensors) and the
    congruent ``rest``."""
    if isinstance(tree, tuple):
        return type(tree)(*(_tree_map(fn, *xs) for xs in zip(tree, *rest)))
    return fn(tree, *rest)


def _gumbel(seed: int, uid: int, position: int, n: int) -> np.ndarray:
    """``n`` standard Gumbel draws keyed on (seed, uid) with ``position``
    in the counter's second word, so no two positions share a draw."""
    key = np.array([seed % 2 ** 64, uid % 2 ** 64], dtype=np.uint64)
    counter = np.array([0, position, 0, 0], dtype=np.uint64)
    bits = np.random.Philox(key=key, counter=counter)
    return np.random.Generator(bits).gumbel(size=n)


class ServingEngine:
    def __init__(self, model: ModelBundle, params: Any, *,
                 batch_slots: int = 4, max_seq: int = 128):
        self.model = model
        self.params = params
        self.slots = batch_slots
        self.max_seq = max_seq
        self.cache = model.init_cache(batch_slots, max_seq)
        # slot bookkeeping (host side)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.slot_pos = np.zeros(batch_slots, np.int32)   # tokens consumed
        self.slot_done = np.ones(batch_slots, bool)
        self.slot_out: List[List[int]] = [[] for _ in range(batch_slots)]
        self.slot_t0 = np.zeros(batch_slots, np.float64)
        self.last_token = np.zeros(batch_slots, np.int32)
        self.completed: List[Result] = []
        self.decode_steps = 0

    # ------------------------------------------------------------------
    def _with_lengths(self, cache: Cache) -> Cache:
        """Override the per-slot length leaf with host-tracked positions
        (a copy of ``slot_pos``: ``torch.tensor`` copies)."""
        pos = torch.tensor(self.slot_pos, dtype=torch.int32,
                           device=self.model.device)

        def fix(leaf):
            if (leaf.dtype == torch.int32 and leaf.ndim == 1
                    and leaf.shape[0] == self.slots):
                return pos
            return leaf

        return _tree_map(fix, cache)

    def _clear_slot(self, cache: Cache, slot: int) -> Cache:
        """Zero one slot's rows in every cache leaf (state hygiene), in
        place: the engine owns its cache."""
        def clear(leaf):
            ax = _batch_axis(leaf, self.slots)
            if ax is not None:
                leaf.select(ax, slot).zero_()
            return leaf

        return _tree_map(clear, cache)

    def _merge_slot(self, new: Cache, old: Cache, slot: int) -> Cache:
        """Take ``new``'s rows for one slot, ``old``'s rows elsewhere.

        Prefill isolation: decoding a prompt token through the shared batch
        must not advance other slots' state.  A leaf the step wrote in
        place (the K/V buffers) is ``old`` itself and is kept whole; a new
        one (SSM states, the length) has its slot's row copied into
        ``old``'s, which the engine owns.
        """
        def merge(n, o):
            ax = _batch_axis(n, self.slots)
            if ax is None or n is o:
                return n
            o.select(ax, slot).copy_(n.select(ax, slot))
            return o

        return _tree_map(merge, new, old)

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Admit a request into a free slot (prefill now). False if full."""
        free = [i for i, d in enumerate(self.slot_done) if d]
        if not free:
            return False
        slot = free[0]
        self.slot_req[slot] = req
        self.slot_done[slot] = False
        self.slot_out[slot] = []
        self.slot_t0[slot] = time.perf_counter()
        self.slot_pos[slot] = 0
        self.cache = self._clear_slot(self.cache, slot)
        # token-by-token prefill through the decode path: identical cache
        # layout, exact causal semantics.
        toks = np.asarray(req.prompt, np.int32).reshape(-1)
        toks = toks[: self.max_seq - req.max_new_tokens - 1]
        logits = None
        for t in toks:
            tok_batch = np.asarray(self.last_token).reshape(-1, 1).copy()
            tok_batch[slot, 0] = t
            before = self.cache
            logits, after = self._step_model(tok_batch)
            self.cache = self._merge_slot(after, before, slot)
            self.slot_pos[slot] += 1
        if logits is not None:
            nxt = self._sample(slot, self._host_logits(logits),
                               int(self.slot_pos[slot]))
        else:
            nxt = int(toks[-1]) if len(toks) else 0
        self.last_token[slot] = nxt
        self.slot_out[slot].append(nxt)
        return True

    def _step_model(self, tok_batch: np.ndarray):
        cache = self._with_lengths(self.cache)
        tokens = torch.tensor(tok_batch, dtype=torch.long,
                              device=self.model.device)
        with torch.no_grad():
            logits, cache = self.model.decode_step(self.params, cache, tokens)
        self.decode_steps += 1
        return logits, cache

    @staticmethod
    def _host_logits(logits: torch.Tensor) -> np.ndarray:
        """The step's last-position logits of every slot, (slots, V), read
        to the host once."""
        return logits[:, -1].float().cpu().numpy()

    def _sample(self, slot: int, logits: np.ndarray, position: int) -> int:
        req = self.slot_req[slot]
        row = logits[slot]
        if req.temperature <= 0.0:
            return _stable_argmax(row)
        g = _gumbel(req.seed, req.uid, position, row.shape[0])
        return _stable_argmax(row / req.temperature + g)

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One decode step for every active slot. Returns #active."""
        active = [i for i, d in enumerate(self.slot_done) if not d]
        if not active:
            return 0
        logits, self.cache = self._step_model(self.last_token.reshape(-1, 1))
        host = self._host_logits(logits)
        for i in active:
            self.slot_pos[i] += 1
            nxt = self._sample(i, host, int(self.slot_pos[i]))
            self.last_token[i] = nxt
            self.slot_out[i].append(nxt)
            req = self.slot_req[i]
            if (len(self.slot_out[i]) >= req.max_new_tokens
                    or self.slot_pos[i] >= self.max_seq - 1):
                self._finish(i)
        return len(active)

    def _finish(self, slot: int) -> None:
        req = self.slot_req[slot]
        self.completed.append(Result(
            uid=req.uid, tokens=list(self.slot_out[slot]),
            prompt_len=len(req.prompt),
            latency_s=time.perf_counter() - self.slot_t0[slot]))
        self.slot_done[slot] = True
        self.slot_req[slot] = None
        self.slot_pos[slot] = 0

    # ------------------------------------------------------------------
    def run(self, requests: List[Request], *,
            max_steps: int = 10_000) -> List[Result]:
        """Serve requests to completion (continuous batching)."""
        pending = list(requests)
        steps = 0
        while (pending or not all(self.slot_done)) and steps < max_steps:
            while pending and self.submit(pending[0]):
                pending.pop(0)
            self.step()
            steps += 1
        return sorted(self.completed, key=lambda r: r.uid)
