"""Serving launcher: batched decode over the slot engine, on the card or,
with ``--device cpu``, on the CPU.

Example:
    python -m repro_torch.launch.serve --arch tinyllama-1.1b --full
    python -m repro_torch.launch.serve --arch mamba2-130m --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke, get as get_config
from repro_torch.models.api import build_model
from repro_torch.serving import Request, ServingEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--full", action="store_true",
                    help="published config (default: smoke config)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = get_config(args.arch) if args.full else get_smoke(args.arch)
    model = build_model(cfg, device=args.device)
    params = model.init(model.generator(args.seed))
    engine = ServingEngine(model, params, batch_slots=args.slots,
                           max_seq=args.max_seq)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(uid=i,
                    prompt=rng.integers(1, cfg.vocab_size,
                                        size=args.prompt_len),
                    max_new_tokens=args.max_new,
                    temperature=args.temperature, seed=args.seed)
            for i in range(args.requests)]
    t0 = time.time()
    results = engine.run(reqs)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    wall = time.time() - t0
    toks = sum(len(r.tokens) for r in results)
    lat = [r.latency_s for r in results]
    print(f"[serve] {args.arch}: {len(results)} requests, {toks} tokens in "
          f"{wall:.2f}s ({toks/wall:.1f} tok/s); "
          f"latency p50={np.median(lat)*1e3:.0f}ms "
          f"p99={np.percentile(lat, 99)*1e3:.0f}ms; "
          f"decode steps={engine.decode_steps}")
    for r in results[:3]:
        print(f"  uid={r.uid} tokens={r.tokens[:8]}...")


if __name__ == "__main__":
    main()
