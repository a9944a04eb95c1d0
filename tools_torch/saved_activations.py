"""Bytes a train step keeps for its backward, per token, on the host.

Sizes a data-parallel cell before it goes to the card: one forward of
``train_loss`` at the published config with remat off (as the scaling
workers run it), the storages that autograd saves counted once each,
parameters excluded, divided by the tokens of the batch.  Attention's
scores grow with the sequence, so run it at the sequence the cell uses
or at two lengths.  Not part of the tests or of ``chip_smoke.py``:

    python3 tools_torch/saved_activations.py --arch mamba2-130m --seq 256
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def saved_bytes(arch: str, seq: int, batch: int = 1,
                layers: int = 0) -> int:
    """Bytes autograd saves in one forward of ``arch``'s published
    config (``layers`` > 0 cuts its depth) at ``batch`` x ``seq``."""
    import torch
    from repro_torch.configs import get
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_dataset
    from repro_torch.models import build_model
    from repro_torch.optim.tree import leaves, tree_map
    from repro_torch.training.trainer import to_device

    cfg = get(arch).replace(remat=False)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    model = build_model(cfg, device="cpu")
    params = tree_map(lambda p: p.detach().requires_grad_(True),
                      model.init(model.generator(0)))
    data = make_dataset(cfg, ShapeConfig("saved", seq, batch, "train"))
    batch_ = to_device(data.batch(0), "cpu")
    kept = {}

    def pack(t):
        s = t.untyped_storage()
        kept[s.data_ptr()] = s.nbytes()
        return t

    with torch.enable_grad(), \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model.train_loss(params, batch_)
    for p in leaves(params):
        kept.pop(p.untyped_storage().data_ptr(), None)
    return sum(kept.values())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: all)")
    args = ap.parse_args(argv)
    n = saved_bytes(args.arch, args.seq, args.batch, args.layers)
    tokens = args.seq * args.batch
    print(f"{args.arch} (remat off) at {args.batch} x {args.seq}: "
          f"{n} B saved for the backward, {n / tokens / 1e6:.3f} MB a "
          f"token")


if __name__ == "__main__":
    main()
