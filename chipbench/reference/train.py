"""The reference follows the first training steps of a cell: from the
benchmark's weights and token batches it computes each step's loss, the
gradients of the first step as the update uses them (clipped), and the
parameters after the last step, with its own model, autograd and AdamW.

``precision`` is the configuration's ("f32": float32 products, TF32 off)
or, for the control, the one below it ("tf32")."""
from __future__ import annotations

import contextlib
import importlib
import statistics
from types import SimpleNamespace
from typing import Callable, Dict, Iterator, List, Sequence, Tuple

import torch

from chipbench.reference import adamw


@contextlib.contextmanager
def precision(mode: str) -> Iterator[None]:
    """float32 products exactly ("f32") or in TF32 ("tf32") on a card."""
    if mode not in ("f32", "tf32"):
        raise ValueError(f"precision {mode!r}")
    tf32 = mode == "tf32"
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def flatten(tree: Dict, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) pairs in sorted key order, paths joined by '/'."""
    out: List[Tuple[str, torch.Tensor]] = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.extend(flatten(v, path + "/"))
        else:
            out.append((path, v))
    return out


def unflatten(pairs: Sequence[Tuple[str, torch.Tensor]]) -> Dict:
    tree: Dict = {}
    for path, leaf in pairs:
        node = tree
        *parents, last = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


def arch_of(config: Dict) -> SimpleNamespace:
    """The configuration's sizes as attributes, with the reference's own
    block size for the cross-entropy (about 1 GiB of logits)."""
    arch = dict(config["arch"])
    arch.setdefault("head_dim", 0)
    arch["loss_rows"] = max(256, (1 << 28) // arch["vocab_size"])
    return SimpleNamespace(**arch)


def family(config: Dict):
    return importlib.import_module(
        f"chipbench.reference.family_{config['reference']}")


def follow(make_weights: Callable[[], Dict], batches: Sequence[torch.Tensor],
           config: Dict, opt: Dict, mode: str = "f32", *,
           remat: bool = True, half_batch: bool = False,
           change_at: int = 0) -> Dict:
    """Run ``len(batches)`` steps from ``make_weights()``.  Returns
    ``losses`` (one a step), ``grad_norms`` (each leaf's norm of the first
    step's clipped gradient) and ``change_norms`` (each leaf's norm of its
    change over the first ``change_at`` steps, or over all of them).
    ``half_batch`` plants a fault: each step sees only the first half of
    its rows (or of its positions, for one row)."""
    change_at = change_at or len(batches)
    arch, fam = arch_of(config), family(config)
    with precision(mode):
        pairs = flatten(make_weights())
        names = [n for n, _ in pairs]
        params = [t for _, t in pairs]
        m = [torch.zeros_like(p) for p in params]
        v = [torch.zeros_like(p) for p in params]
        losses, grad_norms = [], {}
        for step, tokens in enumerate(batches):
            if half_batch:
                tokens = (tokens[:tokens.shape[0] // 2] if tokens.shape[0] > 1
                          else tokens[:, :tokens.shape[1] // 2 + 1])
            leaves = [p.detach().requires_grad_(True) for p in params]
            with torch.enable_grad():
                loss = fam.loss(unflatten(list(zip(names, leaves))), tokens,
                                arch, remat=remat)
                grads = torch.autograd.grad(loss, leaves)
            del leaves
            losses.append(float(loss.detach()))
            grads = adamw.clipped(list(grads), opt)
            if step == 0:
                grad_norms = {n: float(torch.linalg.vector_norm(g))
                              for n, g in zip(names, grads)}
            adamw.update(params, grads, m, v, step, opt)
            del grads, loss
            if step + 1 == change_at:
                start = flatten(make_weights())
                change_norms = {n: float(torch.linalg.vector_norm(p - p0))
                                for n, p, (_, p0) in zip(names, params,
                                                         start)}
                del start
        del m, v, params
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change_norms}


def kept_leaves(grad_norms: Dict[str, float], rel: float = 1e-3) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding:
    those at least ``rel`` of the median leaf's norm."""
    med = statistics.median(grad_norms.values())
    return [n for n, g in grad_norms.items() if g >= rel * med]
