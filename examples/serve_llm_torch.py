"""Serve a small model with batched requests through the slot engine, on
torch.

The twin of ``examples/serve_llm.py`` on the port's ``ServingEngine``:
mamba2-130m's smoke config, ten mixed greedy/sampled requests, four
slots, continuous batching and per-request latency accounting.

    python examples/serve_llm_torch.py               # the card
    python examples/serve_llm_torch.py --device cpu  # the CPU
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_smoke("mamba2-130m")          # O(1)-state decode family
    model = build_model(cfg, device=args.device)
    params = model.init(model.generator(0))
    engine = ServingEngine(model, params, batch_slots=4, max_seq=96)

    rng = np.random.default_rng(0)
    requests = [
        Request(uid=i,
                prompt=rng.integers(1, cfg.vocab_size, size=6 + i % 5),
                max_new_tokens=12,
                temperature=0.0 if i % 2 == 0 else 0.8,
                seed=42)
        for i in range(10)
    ]

    t0 = time.time()
    results = engine.run(requests)
    wall = time.time() - t0

    tokens = sum(len(r.tokens) for r in results)
    print(f"served {len(results)} requests / {tokens} tokens "
          f"in {wall:.2f}s ({tokens / wall:.1f} tok/s, "
          f"{engine.decode_steps} decode steps) on {model.device}")
    for r in results:
        kind = "greedy" if r.uid % 2 == 0 else "t=0.8"
        print(f"  uid={r.uid:2d} [{kind}] prompt={r.prompt_len:2d} "
              f"latency={r.latency_s * 1e3:6.0f}ms tokens={r.tokens}")
    assert sorted(r.uid for r in results) == list(range(10))
    assert all(len(r.tokens) == 12 for r in results)

    # determinism: re-serving the same greedy request yields the same text
    again = ServingEngine(model, params, batch_slots=1, max_seq=96).run(
        [requests[0]])
    assert again[0].tokens == results[0].tokens
    print("\ngreedy determinism under batching: OK")


if __name__ == "__main__":
    main()
