"""The CUDA kernels against their plain torch versions, on the card.

Needs a CUDA card and ``nvcc`` (the kernels build on first use); skips
where there is no card.  Imports neither jax nor the JAX package, so it
runs on a machine that has only the port:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.detect_fused import ops, ref

ARGS = dict(ideal_slope=0.0, slope_margin=0.05, min_share=0.01)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(dtype, seed=11, S=3, P=3000, V=40, dev="cuda"):
    rng = np.random.default_rng(seed)
    t = np.round(rng.uniform(0, 2, (S, P, V)), 2)
    t[t < 0.3] = 0.0
    var = rng.uniform(0, 0.1, (S, P, V))
    present = rng.random((S, V)) > 0.1
    top = np.array([2, 7, 3], np.int32)
    put = lambda a, dt=None: torch.from_numpy(a).to(dev, dt)  # noqa: E731
    logp = torch.log(torch.tensor([P // 4, P // 2, P], dtype=dtype,
                                  device=dev))
    return put(t, dtype), put(var, dtype), put(present), put(top), logp


def _ab_matrix(P, V, dtype, dev, seed):
    """A (P, V) time matrix on a coarse grid (heavy ties), ~3% stragglers,
    ~1% dead readings, and its last column all dead (zeros)."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.5, 1.5, (P, V)) * rng.uniform(0.5, 2.0, (1, V))
    t *= np.where(rng.random((P, V)) < 0.03, 3.0, 1.0)
    t = np.round(t, 1)
    t[rng.random((P, V)) < 0.01] = 0.0
    t[:, -1] = 0.0
    return torch.from_numpy(t).to(dev, dtype)


# (P, V): P of one row, either side of 1024, 3000 and the fleet's 65536 + 7
# (no multiple of the key tiles' 64 rows or the cluster's 8 blocks); V of
# one column, 40, the fleet's 56 and 130 (five 32-column key tiles)
AB_SHAPES = [(P, V) for P in (1, 1023, 1025, 3000, 65536 + 7)
             for V in (1, 40, 56, 130)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", AB_SHAPES)
def test_ab_fused_matches_plain_exactly(card, dtype, shape):
    """Order, scores, count and typical bit for bit against the plain
    version: flags far above k and none at all, k above P, candidate lists
    too long to rank in shared memory, the step-time override, and a
    ``valid`` mask with dead rows."""
    P, V = shape
    live = _ab_matrix(P, V, dtype, card, seed=P + V)
    top = torch.tensor([0, V // 2, V - 1], dtype=torch.int32, device=card)
    gen = torch.Generator().manual_seed(P)
    valid = torch.rand(P, generator=gen) > 0.1
    valid[0] = True
    pad = torch.cat([valid.nonzero()[:, 0],
                     torch.zeros(int((~valid).sum()), dtype=torch.long)])
    mask = (torch.arange(P) < int(valid.sum())).to(card)
    pad = pad.to(card)
    blocks = list(live.chunk(3))
    n = P * V
    cases = [   # (k, thd, op keywords, plain-version arguments)
        (64, 1.5, {}, (live, None, {})),
        (4, 1.2, {}, (live, None, {})),                   # flags >> k
        (64, 1e9, {}, (live, None, {})),                  # no flags
        (P + 5, 1.5, {}, (live, None, {})),               # k > P
        (2000, 1.5, {}, (live, None, {})),                # long lists
        (64, 1.5, dict(step_time=3.25),
         (live, None, dict(step_time=3.25))),
        (64, 1.5, dict(live=pad, valid=mask),
         (live.index_select(0, pad), mask, {})),
    ]
    for k, thd, kw, (tp, vp, rk) in cases:
        k = min(k, n)
        got = ops.fused_abnormal(blocks, top, thd, 0.001, k, **kw)
        want = ref.abnormal(tp, vp, top, thd, 0.001, k, **rk)
        for part, g, w in zip(("order", "scores", "count", "typical"),
                              got, want):
            assert torch.equal(g, w), (k, thd, sorted(kw), part)


@pytest.mark.cuda
def test_auto_backend_takes_the_card(card):
    from repro_torch.core.detect import _resolve_backend
    module, dev = _resolve_backend("auto")
    assert module is not None and dev.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ns_fused_matches_plain(card, dtype):
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    t, var, present, top, logp = _case(dtype)
    hist0 = torch.zeros((4, 0, t.shape[2]), dtype=dtype, device=card)
    got = ops.fused_non_scalable(t, var, logp, present, top_idx=top, **ARGS)
    want = ref.non_scalable(t, var, hist0, logp, present, top, **ARGS)
    for g, w in zip(got[:3], want[:3]):
        assert ((g - w).abs().max() <= tol * w.abs().max()).item()
    assert torch.equal(got[3], want[3])
    col = ops.merge_scale_column(list(t[0].chunk(4)), list(var[0].chunk(4)))
    w = ref.merge_blocks([t[0]], [var[0]])
    assert ((col - w).abs().max() <= tol * w.abs().max()).item()


def _rel_ok(got, want, tol):
    return ((got - want).abs().max() <= tol * want.abs().max()).item()


# (S, P, V): P of one row, the fleet's 65536 + 7 (not a multiple of the
# 256-row tile), V of one column and of 130 (wider than half a block)
NS_SHAPES = [(3, 1, 40), (2, 65536 + 7, 56), (3, 3000, 1), (2, 3000, 130)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", NS_SHAPES)
def test_ns_fused_shapes_match_plain(card, dtype, shape):
    """The stacked op and the merge stage (``tail=False``) against the
    plain version, flags exact, and two launches bit for bit equal."""
    from repro_torch.kernels.detect_fused import kernel
    S, P, V = shape
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    t, var, present, _, _ = _case(dtype, seed=P + V, S=S, P=P, V=V)
    logp = torch.log(torch.tensor([1000.0 * 2 ** i for i in range(S)],
                                  dtype=dtype, device=card))
    top = torch.tensor([0, V - 1], dtype=torch.int32, device=card)
    hist0 = torch.zeros((4, 0, V), dtype=dtype, device=card)
    before = kernel.ns_fused.launches
    got = ops.fused_non_scalable(t, var, logp, present, top_idx=top, **ARGS)
    again = ops.fused_non_scalable(t, var, logp, present, top_idx=top,
                                   **ARGS)
    assert kernel.ns_fused.launches == before + 2
    want = ref.non_scalable(t, var, hist0, logp, present, top, **ARGS)
    for g, w in zip(got[:3], want[:3]):
        assert _rel_ok(g, w, tol)
    assert torch.equal(got[3], want[3])
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    merged = kernel.ns_fused(t, var, hist0, None, None, None, tail=False)
    assert _rel_ok(merged, ref.merge_all_stack(t, var), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("sizes", [(1000, 7, 0, 1993), (500,) * 6,
                                   (100,) * 17])
def test_ns_fused_reads_shard_blocks_in_place(card, dtype, sizes):
    """The live op and the merge column over uneven shard blocks (an
    empty one among them), read in place, and over more blocks than the
    kernel's table holds (concatenated first), against the plain version
    of the concatenated scale; the in-place path and the stacked one
    agree bit for bit (the kernel sums each row in the same place
    whichever block holds it)."""
    from repro_torch.kernels.detect_fused import kernel
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    P = sum(sizes)
    t, var, present, top, logp = _case(dtype, seed=len(sizes), P=P)
    V = t.shape[2]
    live, lvar = t[-1].contiguous(), var[-1].contiguous()
    cut = np.cumsum((0,) + sizes)
    ts = [live[a:b] for a, b in zip(cut[:-1], cut[1:])]
    vs = [lvar[a:b] for a, b in zip(cut[:-1], cut[1:])]
    hist = ref.merge_all_stack(t[:-1], var[:-1])
    got = ops.fused_non_scalable_live(ts, vs, hist, logp, present, top,
                                      **ARGS)
    want = ref.non_scalable(live[None], lvar[None], hist, logp, present,
                            top, **ARGS)
    for g, w in zip(got[:3], want[:3]):
        assert _rel_ok(g, w, tol)
    assert torch.equal(got[3], want[3])
    stacked = kernel.ns_fused(live[None], lvar[None], hist, logp, present,
                              top, **ARGS)
    for g, a in zip(got, stacked):
        assert torch.equal(g, a)
    col = ops.merge_scale_column(ts, vs)
    assert col.shape == (4, V)
    assert _rel_ok(col, ref.merge_blocks([live], [lvar]), tol)


# -- flash attention: the CUDA kernel against its plain version ---------

# (B, nq, nkv, Sq, Sk, h, causal, dtype): the reference's sweep
# (tests/test_kernels.py), a ragged length the kernel masks itself, the
# full-width tinyllama and zamba2 layers, and h = 32 and 128 at S = 2048
FLASH_CASES = [
    (1, 2, 2, 64, 64, 32, True, torch.float32),
    (2, 4, 2, 128, 128, 64, True, torch.float32),
    (1, 8, 1, 128, 128, 64, True, torch.float32),
    (2, 4, 4, 64, 128, 32, False, torch.float32),
    (1, 2, 2, 128, 128, 128, True, torch.float32),
    (1, 4, 2, 64, 64, 64, True, torch.bfloat16),
    (1, 4, 2, 100, 100, 64, True, torch.float32),
    (4, 32, 4, 2048, 2048, 64, True, torch.float32),
    (4, 32, 4, 2048, 2048, 64, True, torch.bfloat16),
    # head dim 80 (zamba2-2.7b's 2560 / 32): small, then its full layer
    (1, 4, 2, 128, 128, 80, True, torch.float32),
    (1, 4, 2, 128, 128, 80, True, torch.bfloat16),
    (2, 32, 32, 2048, 2048, 80, True, torch.float32),
    (2, 32, 32, 2048, 2048, 80, True, torch.bfloat16),
    # the other compiled head dims at full length
    (2, 8, 2, 2048, 2048, 32, True, torch.float32),
    (1, 8, 8, 2048, 2048, 128, True, torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(card, case):
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref as fr
    B, nq, nkv, Sq, Sk, h, causal, dt = case
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(card, dt)
               for s in ((B, nq, Sq, h), (B, nkv, Sk, h), (B, nkv, Sk, h)))
    before = fk.flash_attention.launches
    got = fk.flash_attention(q, k, v, causal=causal, softmax_scale=h ** -0.5)
    want = fr.attention(q, k, v, causal=causal, softmax_scale=h ** -0.5)
    torch.cuda.synchronize()
    assert fk.flash_attention.launches == before + 1
    tol = 2e-5 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_attention_op_in_models_layout(card):
    from repro_torch.kernels.flash_attention import ops as fo
    from repro_torch.kernels.flash_attention import ref as fr
    rng = np.random.default_rng(4)
    B, S, nq, nkv, h = 2, 256, 8, 2, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(card)
               for s in ((B, S, nq, h), (B, S, nkv, h), (B, S, nkv, h)))
    got = fo.flash_attention(q, k, v, causal=True)
    want = fr.attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=True,
                        softmax_scale=h ** -0.5).transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="head dim"):
        fo.flash_attention(q[..., :48], k[..., :48], v[..., :48])
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError):
        fo.flash_attention(q, k, v).sum().backward()


@pytest.mark.cuda
def test_flash_attention_wrapper_refuses_what_it_does_not_take(card):
    from repro_torch.kernels.flash_attention import kernel as fk
    q = torch.zeros((1, 2, 64, 64), device=card)
    with pytest.raises(ValueError, match="head dim"):
        fk.flash_attention(q[..., :48], q[..., :48], q[..., :48],
                           causal=True, softmax_scale=1.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fk.flash_attention(q.half(), q.half(), q.half(), causal=True,
                           softmax_scale=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        fk.flash_attention(q, q.cpu(), q, causal=True, softmax_scale=1.0)


# -- ssd scan: the CUDA kernel against its plain version ------------------

# (B, S, H, P, N, chunk): the reference's sweep (tests/test_kernels.py),
# ragged S = 100 among them, and a sequence shorter than its chunk
SSD_CASES = [
    (1, 64, 2, 32, 16, 32),
    (2, 128, 4, 64, 32, 64),
    (1, 96, 2, 32, 16, 32),
    (2, 100, 3, 16, 8, 64),
    (1, 256, 1, 64, 64, 64),
    (1, 37, 2, 16, 16, 64),
]


def ssd_inputs(B, S, H, P, N, seed, dev):
    """The reference's ``_ssd_inputs`` (tests/test_kernels.py), as torch
    tensors on ``dev``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P))
    dt = np.abs(rng.standard_normal((B, S, H))) * 0.1
    A = -(np.abs(rng.standard_normal((H,))) + 0.1)
    Bm = rng.standard_normal((B, S, N))
    Cm = rng.standard_normal((B, S, N))
    return [torch.from_numpy(a.astype(np.float32)).to(dev)
            for a in (x, dt, A, Bm, Cm)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_kernel_matches_plain(card, case):
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan import ops as so
    from repro_torch.kernels.ssd_scan import ref as sr
    B, S, H, P, N, chunk = case
    args = ssd_inputs(B, S, H, P, N, sum(case), card)
    before = sk.ssd_scan.launches
    y, h = so.ssd_scan(*args, chunk=chunk, return_final=True)
    yr, hr = sr.ssd_ref(*args, chunk=chunk, return_final=True)
    torch.cuda.synchronize()
    assert sk.ssd_scan.launches == before + 1
    assert y.shape == (B, S, H, P) and h.shape == (B, H, N, P)
    torch.testing.assert_close(y, yr, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(h, hr, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_ssd_scan_wrapper_refuses_what_it_does_not_take(card):
    from repro_torch.kernels.ssd_scan import kernel as sk
    x, dt, A, Bm, Cm = ssd_inputs(1, 64, 2, 32, 16, 0, card)
    with pytest.raises(ValueError, match="not one of"):
        sk.ssd_scan(x[..., :8].contiguous(), dt, A, Bm, Cm, chunk=32)
    with pytest.raises(TypeError, match="float32"):
        sk.ssd_scan(x.double(), dt, A, Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match="CUDA"):
        sk.ssd_scan(x, dt, A.cpu(), Bm, Cm, chunk=32)
    with pytest.raises(ValueError, match="divide"):
        sk.ssd_scan(x, dt, A, Bm, Cm, chunk=48)
    with pytest.raises(ValueError, match="contiguous"):
        sk.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A,
                    Bm, Cm, chunk=32)


def _rel(got, want):
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


# (B, S, H, P, N, chunk, cluster).  None: the wrapper's own cluster_size,
# which on an H100's 132 SMs picks 8 blocks for mamba2-130m's 32768-token
# prefill and for one head at batch 1, 1 for 160 (head, batch row) pairs,
# 2 for 80, and 8 for six pairs of ten chunks (8 blocks take one or two
# each); Q = 37 has one chunk.  A number: the blocks forced on the launch
# (one head over 1 and 2 blocks; ten chunks over 3).
SSD_CLUSTER_CASES = [
    (1, 32768, 24, 64, 128, 64, None),
    (1, 4096, 1, 64, 128, 64, None),
    (1, 4096, 1, 64, 128, 64, 1),
    (1, 4096, 1, 64, 128, 64, 2),
    (2, 512, 80, 64, 64, 64, None),
    (1, 512, 80, 64, 64, 64, None),
    (2, 640, 3, 64, 64, 64, None),
    (2, 640, 3, 64, 64, 64, 3),
    (1, 37, 2, 16, 16, 64, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CLUSTER_CASES)
def test_ssd_scan_cluster_split_matches_plain(card, case, monkeypatch):
    """y and the final state within 2e-5 of their max (chip_smoke.py's
    SSD_FULL_TOL) whatever the blocks per (head, batch row)."""
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan import ref as sr
    B, S, H, P, N, chunk, cluster = case
    if cluster is not None:
        monkeypatch.setattr(sk, "cluster_size", lambda *_: cluster)
    args = ssd_inputs(B, S, H, P, N, S + H, card)
    Q = min(chunk, S)
    y, h = sk.ssd_scan(*args, chunk=Q)
    yr, hr = sr.ssd_ref(*args, chunk=Q, return_final=True)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    assert _rel(y, yr) <= 2e-5 and _rel(h, hr) <= 2e-5


@pytest.mark.cuda
def test_ssd_scan_wrapper_refuses_bad_clusters(card, monkeypatch):
    """The C entry refuses a cluster outside [1, min(8, chunks)] before
    it launches."""
    from repro_torch.kernels.ssd_scan import kernel as sk
    args = ssd_inputs(1, 256, 2, 64, 64, 0, card)
    before = sk.ssd_scan.launches
    for cluster in (0, 5, 9):        # 256 / 64 = 4 chunks
        monkeypatch.setattr(sk, "cluster_size", lambda *_: cluster)
        with pytest.raises(RuntimeError, match="invalid argument"):
            sk.ssd_scan(*args, chunk=64)
    assert sk.ssd_scan.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_smoke_model_loss_through_the_kernels(card, arch):
    """A smoke-size loss through the kernels equals the plain path's.  The
    hybrid smoke config's 16-wide heads are widened to 32 (two heads), a
    width the flash kernel is built for."""
    from repro_torch.configs import get_smoke
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.models import build_model
    from repro_torch.models.hybrid import n_attn_sites
    cfg = get_smoke(arch)
    if cfg.family == "hybrid":
        cfg = cfg.replace(n_heads=2, n_kv_heads=2)
    plain = build_model(cfg)
    kern = build_model(cfg.replace(use_kernels=True))
    params = plain.init(plain.generator(0))
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 65))).to(card)
    before = (sk.ssd_scan.launches, fk.flash_attention.launches)
    got = float(kern.train_loss(params, {"tokens": toks})[0])
    sites = n_attn_sites(cfg) if cfg.family == "hybrid" else 0
    assert (sk.ssd_scan.launches - before[0],
            fk.flash_attention.launches - before[1]) == (cfg.n_layers, sites)
    want = float(plain.train_loss(params, {"tokens": toks})[0])
    assert np.isfinite(got) and abs(got - want) <= 1e-5 * abs(want)
