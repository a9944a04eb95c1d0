"""Stub targets for the rank launcher's test."""


def stub(payload, rank, world, backend):
    import torch
    import torch.distributed as dist
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    return {"sum": float(t[0]), "world": world, "backend": backend,
            "payload": payload}


def fail_on_one(payload, rank, world, backend):
    if rank == 1:
        raise ValueError("rank 1 fails")
    return stub(payload, rank, world, backend)
