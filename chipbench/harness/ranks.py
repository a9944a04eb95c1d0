"""One process a card for a cell whose traffic sets ``ranks``: the
processes join one group (rendezvous on a free ``localhost`` port) with
the backend the program's ``launch/mesh.py::choose_backend`` picks, run
the same target, and rank 0's return value is the run's.  Every process
is waited for; any left at the time limit is ended."""
from __future__ import annotations

import importlib
import queue
import socket
import traceback
from typing import Any, Dict


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _target(path: str):
    mod, fn = path.split(":")
    return getattr(importlib.import_module(mod), fn)


def _worker(rank: int, world: int, init: str, target: str, payload: Dict,
            device: str, out) -> None:
    try:
        import torch.distributed as dist
        from repro_torch.launch.mesh import init_group
        backend = init_group(rank, world, init, device=device)
        try:
            value = _target(target)(payload, rank, world, backend)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, value if rank == 0 else None))
    except Exception:                       # reported to the launcher
        out.put((rank, False, traceback.format_exc()))


def launch(world: int, target: str, payload: Dict, device: str,
           timeout_s: float = 900.0) -> Any:
    """Run ``target(payload, rank, world, backend)`` in ``world`` spawned
    processes; rank 0's value.  Raises if any rank fails."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    init = f"tcp://localhost:{free_port()}"
    procs = [ctx.Process(target=_worker,
                         args=(r, world, init, target, payload, device, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results: Dict[int, Any] = {}
    errors = []
    try:
        for _ in range(world):        # after a failure the others get 30 s
            rank, ok, value = out.get(timeout=30 if errors else timeout_s)
            if ok:
                results[rank] = value
            else:
                errors.append((rank, value))
    except queue.Empty:
        if not errors:
            errors.append((-1, f"no answer from every rank in "
                               f"{timeout_s:.0f} s"))
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 5)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    if errors:
        raise RuntimeError("\n".join(f"rank {r}:\n{e}"
                                     for r, e in sorted(errors)))
    return results[0]
