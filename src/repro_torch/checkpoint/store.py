"""Fault-tolerant checkpointing of plain trees: atomic, keep-N, async.

The port's copy of the JAX package's ``repro.checkpoint.store``, reduced
to its plain-tree path — the one the always-on monitor's crash snapshots
and the run store persist through:

* **Atomicity** — write to ``step_K.tmp/`` then ``os.rename`` to ``step_K/``;
  a crash mid-write never corrupts the latest checkpoint, and auto-resume
  scans only committed directories.
* **Async** — ``save(...)`` snapshots to host memory synchronously (cheap)
  and writes in a background thread so the caller never blocks on I/O;
  ``wait()`` joins at shutdown.  A failed async write is re-raised at the
  next call site so failures are not silent.
* **Keep-N GC** — old committed checkpoints beyond ``keep`` are removed
  after a successful commit, never before.
* **Integrity** — every leaf's shape/dtype is recorded in ``manifest.json``
  and verified on load; partial/foreign directories are rejected.

A tree is plain when it nests dicts, lists and tuples of host values
(numpy arrays and scalars, Python numbers).  It flattens with sorted dict
keys, the order the JAX package's flattener uses, so the on-disk format is
byte-compatible both ways: a snapshot written by ``repro.checkpoint``
loads here, and one written here loads there.  Any other tree raises
``TypeError``, as the JAX package does where jax is not importable.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

Pytree = Any

_STEP_RE = re.compile(r"^step_(\d+)$")


def _is_plain(tree) -> bool:
    """Nested dict/list/tuple of host values: the only tree shape this
    module saves and loads (device tensors, custom nodes and None are
    refused)."""
    if isinstance(tree, dict):
        return all(_is_plain(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(_is_plain(v) for v in tree)
    return isinstance(tree, (np.ndarray, np.generic, int, float, bool))


def _to_host(leaf) -> np.ndarray:
    return np.asarray(leaf)


def _flatten_plain(tree: Pytree, prefix: List[str],
                   out: List[Tuple[str, Any]]) -> None:
    """dict/list/tuple flattening in the JAX package's path order (dict
    keys sorted), so both packages write the same manifest keys.

    Dict keys may not contain "/" — manifest keys are slash-joined
    paths, and a slashed key would silently restore as a nested dict in
    the template-free loader."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            if "/" in str(k):
                raise ValueError(f"checkpoint dict key {k!r} contains '/'")
            _flatten_plain(tree[k], prefix + [str(k)], out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten_plain(v, prefix + [str(i)], out)
    else:
        out.append(("/".join(prefix), tree))


def _empty_containers(tree: Pytree, prefix: List[str],
                      out: List[Tuple[str, str]]) -> None:
    """Paths of empty dict/list/tuple nodes in a plain tree.

    An empty container produces no leaves, so without recording it the
    template-free loader would rebuild the tree WITHOUT that node — a
    round-trip that silently drops e.g. a counter-less store's
    ``"counters": {}``."""
    if isinstance(tree, dict):
        if not tree:
            out.append(("/".join(prefix), "dict"))
        for k in sorted(tree):
            _empty_containers(tree[k], prefix + [str(k)], out)
    elif isinstance(tree, (list, tuple)):
        if not tree:
            out.append(("/".join(prefix), "list"))
        for i, v in enumerate(tree):
            _empty_containers(v, prefix + [str(i)], out)


def _flatten_with_paths(tree: Pytree) -> List[Tuple[str, Any]]:
    if not _is_plain(tree):
        raise TypeError("checkpoint tree has non-plain leaves (only nested "
                        "dict/list/tuple trees of host values are saved)")
    out: List[Tuple[str, Any]] = []
    _flatten_plain(tree, [], out)
    return out


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for name in os.listdir(directory)
             if (m := _STEP_RE.match(name))
             and os.path.isfile(os.path.join(directory, name,
                                             "manifest.json"))]
    return max(steps) if steps else None


def save_checkpoint(directory: str, step: int, tree: Pytree,
                    *, extra_meta: Optional[dict] = None) -> str:
    """Synchronous atomic save. Returns the committed path."""
    leaves = _flatten_with_paths(tree)      # refuses a non-plain tree
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest: Dict[str, Any] = {
        "step": step,
        "leaves": {},
        "meta": extra_meta or {},
    }
    empties: List[Tuple[str, str]] = []
    _empty_containers(tree, [], empties)
    if empties:
        manifest["empty"] = {path: kind for path, kind in empties}
    arrays: Dict[str, np.ndarray] = {}
    for i, (key, leaf) in enumerate(leaves):
        arr = _to_host(leaf)
        name = f"a{i}"
        arrays[name] = arr
        manifest["leaves"][key] = {
            "file": name, "shape": list(arr.shape), "dtype": str(arr.dtype)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def load_checkpoint(directory: str, step: int, like: Pytree,
                    *, shard_fn: Optional[Callable[[str, np.ndarray], Any]]
                    = None) -> Tuple[Pytree, dict]:
    """Load into the structure of the plain tree ``like``; each leaf goes
    through ``shard_fn(key, arr)`` when one is given (e.g. to move it to a
    device)."""
    if not _is_plain(like):
        raise TypeError("checkpoint template has non-plain leaves (only "
                        "nested dict/list/tuple trees of host values load)")
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    npz = np.load(os.path.join(path, "arrays.npz"))

    def pick(key: str, leaf) -> Any:
        ent = manifest["leaves"].get(key)
        if ent is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = npz[ent["file"]]
        want_shape = tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != want_shape:
            raise ValueError(
                f"shape mismatch for {key}: ckpt {arr.shape} vs {want_shape}")
        return shard_fn(key, arr) if shard_fn else arr

    def rebuild(node, prefix):
        if isinstance(node, dict):
            return {k: rebuild(node[k], prefix + [str(k)]) for k in node}
        if isinstance(node, (list, tuple)):
            vals = [rebuild(v, prefix + [str(i)])
                    for i, v in enumerate(node)]
            return type(node)(vals)
        return pick("/".join(prefix), node)
    return rebuild(like, []), manifest.get("meta", {})


def load_checkpoint_tree(directory: str, step: int) -> Tuple[Pytree, dict]:
    """Template-free restore: rebuild the nested-dict tree straight from
    the manifest keys (split on "/").  No ``like`` structure is needed —
    the monitor's crash recovery uses this, since a cold aggregator knows
    nothing about the fleet it is restoring.  Trees saved from lists come
    back as dicts keyed by the stringified index."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    npz = np.load(os.path.join(path, "arrays.npz"))
    tree: Dict[str, Any] = {}
    for key, ent in manifest["leaves"].items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = npz[ent["file"]]
    for key, kind in manifest.get("empty", {}).items():
        child: Any = {} if kind == "dict" else []
        if key == "":
            return child, manifest.get("meta", {})
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = child
    return tree, manifest.get("meta", {})


class CheckpointManager:
    """Async keep-N manager with auto-resume."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ----------------------------------------------------------
    def save(self, step: int, tree: Pytree, *, blocking: bool = False,
             extra_meta: Optional[dict] = None) -> None:
        self.wait()                      # one in flight at a time
        if not _is_plain(tree):
            raise TypeError("checkpoint tree has non-plain leaves (only "
                            "nested dict/list/tuple trees of host values "
                            "are saved)")

        def _map(node):
            if isinstance(node, dict):
                return {k: _map(v) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(_map(v) for v in node)
            return _to_host(node)
        snapshot = _map(tree)

        def work():
            try:
                save_checkpoint(self.directory, step, snapshot,
                                extra_meta=extra_meta)
                self._gc()
            except BaseException as e:       # surfaced at next wait()
                self._error = e

        if blocking:
            work()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err

    def _gc(self) -> None:
        steps = sorted(
            int(m.group(1)) for name in os.listdir(self.directory)
            if (m := _STEP_RE.match(name)))
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    # -- restore ---------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def restore_latest(self, like: Pytree, *,
                       shard_fn: Optional[Callable] = None
                       ) -> Optional[Tuple[int, Pytree, dict]]:
        step = self.latest_step()
        if step is None:
            return None
        tree, meta = load_checkpoint(self.directory, step, like,
                                     shard_fn=shard_fn)
        return step, tree, meta
