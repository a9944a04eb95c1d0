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
from tools_torch.chaos_smoke_torch import Tee, report_key

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
    # the MoE layers at h = 128, S cut to 512: moonshot-v1-16b-a3b's MHA
    # (16/16) and dbrx-132b's GQA (48/8)
    (2, 16, 16, 512, 512, 128, True, torch.float32),
    (1, 48, 8, 512, 512, 128, True, torch.float32),
    # head dim 256 (gemma-7b): small, ragged GQA, full keys, then its
    # layer (2, 16/16, h = 256) with S cut to 512, f32 and bf16
    (1, 2, 2, 128, 128, 256, True, torch.float32),
    (1, 2, 2, 128, 128, 256, True, torch.bfloat16),
    (1, 4, 2, 100, 100, 256, True, torch.float32),
    (2, 2, 2, 64, 128, 256, False, torch.float32),
    (2, 2, 2, 64, 128, 256, False, torch.bfloat16),
    (2, 16, 16, 512, 512, 256, True, torch.float32),
    (2, 16, 16, 512, 512, 256, True, torch.bfloat16),
    # seamless-m4t-medium's encoder layer: non-causal, (4, 16/16, h = 64)
    (4, 16, 16, 1024, 1024, 64, False, torch.float32),
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


def smoke_batch(cfg, shape, seed, dev):
    """Seeded tokens of ``shape`` and, for encdec / vlm, the frontend's
    (B, frontend_len, d_model) embeddings, on ``dev``."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, shape)).to(dev)}
    key = {"encdec": "frames", "vlm": "patches"}.get(cfg.family)
    if key:
        batch[key] = torch.from_numpy(rng.standard_normal(
            (shape[0], cfg.frontend_len, cfg.d_model), np.float32)).to(dev)
    return batch


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b", "gemma-7b",
                                  "seamless-m4t-medium", "internvl2-2b"])
def test_smoke_model_loss_through_the_kernels(card, arch):
    """A smoke-size loss through the kernels equals the plain path's.  The
    hybrid, encdec and vlm smoke configs' 16-wide heads are widened to 32
    (half the heads), a width the flash kernel is built for; gemma's
    smoke heads are 32 wide already.  One flash launch per self-attention
    layer (the encoder's non-causal, the decoder's causal)."""
    from repro_torch.configs import get_smoke
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.models import build_model
    from repro_torch.models.hybrid import n_attn_sites
    cfg = get_smoke(arch)
    if cfg.family in ("hybrid", "encdec", "vlm"):
        cfg = cfg.replace(n_heads=cfg.n_heads // 2,
                          n_kv_heads=max(cfg.n_kv_heads // 2, 1))
    plain = build_model(cfg)
    kern = build_model(cfg.replace(use_kernels=True))
    params = plain.init(plain.generator(0))
    batch = smoke_batch(cfg, (2, 65), 5, card)
    before = (sk.ssd_scan.launches, fk.flash_attention.launches)
    got = float(kern.train_loss(params, batch)[0])
    ssd = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    if cfg.family == "ssm":
        flash = 0
    elif cfg.family == "hybrid":
        flash = n_attn_sites(cfg)
    else:
        flash = cfg.n_layers + (cfg.enc_layers if cfg.family == "encdec"
                                else 0)
    assert (sk.ssd_scan.launches - before[0],
            fk.flash_attention.launches - before[1]) == (ssd, flash)
    want = float(plain.train_loss(params, batch)[0])
    assert np.isfinite(got) and abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-130m",
                                  "zamba2-2.7b", "moonshot-v1-16b-a3b"])
def test_smoke_engine_on_the_card_equals_the_cpu(card, arch):
    """The serving engine on the card gives the CPU engine's greedy
    streams on the same weights and mixed traffic (the engine's argmax
    takes logits within its tie tolerance as ties)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model
    from repro_torch.optim.tree import tree_map
    from repro_torch.serving import Request, ServingEngine
    cfg = get_smoke(arch)
    cpu = build_model(cfg, device="cpu")
    params = cpu.init(cpu.generator(0))

    def reqs():
        rng = np.random.default_rng(2)
        return [Request(uid=i, max_new_tokens=6, seed=i,
                        prompt=rng.integers(1, cfg.vocab_size, 3 + 2 * i),
                        temperature=0.0 if i % 2 == 0 else 0.8)
                for i in range(5)]

    want = ServingEngine(cpu, params, batch_slots=3, max_seq=48).run(reqs())
    eng = ServingEngine(build_model(cfg, device=card),
                        tree_map(lambda t: t.to(card), params),
                        batch_slots=3, max_seq=48)
    assert getattr(eng.cache, "kv", eng.cache).length.is_cuda
    got = eng.run(reqs())
    assert [len(r.tokens) for r in got] == [len(r.tokens) for r in want]
    for g, w in zip(got, want):
        if g.uid % 2 == 0:
            assert g.tokens == w.tokens, g.uid


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-130m",
                                  "zamba2-2.7b", "seamless-m4t-medium",
                                  "internvl2-2b"])
def test_smoke_train_step_on_the_card_equals_the_cpu(card, arch):
    """One smoke train step on the card, eager and profiled (the traced
    graph through the fenced interpreter), equals the CPU's step on the
    same weights and tokens: metrics within 1e-5 relative; the profiled
    step's new params equal the eager card step's within 1e-5."""
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.profiler import GraphProfiler
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init, constant
    from repro_torch.optim.tree import leaves, tree_map
    from repro_torch.training import TrainState, make_train_step
    cfg = get_smoke(arch)
    host = smoke_batch(cfg, (4, 65), 9, "cpu")
    cpu = build_model(cfg, device="cpu")
    params = cpu.init(cpu.generator(0))
    runs = {}
    for dev in ("cpu", card):
        p = tree_map(lambda t: t.to(dev), params)
        state = TrainState(p, adamw_init(p), None,
                           torch.zeros((), dtype=torch.int32, device=dev))
        step = make_train_step(build_model(cfg, device=dev), RunConfig(),
                               constant(1e-3))
        batch = {k: v.to(dev) for k, v in host.items()}
        runs[str(dev)] = step(state, batch)
        if dev == card:
            prof = GraphProfiler(step, (state, batch), sample_every=1)
            runs["profiled"] = prof.step(state, batch)
            assert prof.sampled_steps == 1
            tops = prof.psg.children(prof.psg.root)
            perf = prof.perf_vectors()
            assert all(perf[v].samples == 1 and perf[v].time >= 0
                       for v in tops)
    want = runs["cpu"][1]
    for name in ("cuda", "profiled"):
        got = runs[name][1]
        for k in ("loss", "grad_norm", "param_norm", "lr"):
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-5, err_msg=f"{name} {k}")
    for a, b in zip(leaves(runs["profiled"][0].params),
                    leaves(runs["cuda"][0].params)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dead", [(), (3,)], ids=["full", "dead-host"])
def test_monitor_chaos_run_on_the_card_equals_numpy(card, dead, monkeypatch):
    # 1027 procs over 8 hosts: uneven shards, an odd live count (899) with
    # h3 dead
    from repro_torch.kernels.detect_fused import kernel
    from repro_torch.monitor import chaos_run
    kw = dict(n_procs=1027, n_hosts=8, seed=3, dead_hosts=dead,
              p_drop=0.25, p_dup=0.2, p_delay=0.35, p_ack_loss=0.15)
    launches = []
    monkeypatch.setattr(ops, "on_launch", launches.append)
    before = kernel.ab_fused.launches
    got = chaos_run(backend="torch", device="cuda", **kw)
    monkeypatch.setattr(ops, "on_launch", None)
    want = chaos_run(backend="numpy", **kw)
    assert got.converged and report_key(got.report) \
        == report_key(want.report)
    assert got.report.degraded == bool(dead)
    # one abnormal launch per detect: the one-shot reference's, and one
    # for each of the Monitor's reports (indices 0..index)
    assert launches == ["abnormal"] * (got.report.index + 2)
    assert kernel.ab_fused.launches - before == len(launches)


@pytest.mark.cuda
def test_monitor_steady_cycle_on_the_card(card):
    from repro_torch.core.inject import simulate
    from repro_torch.core.shard import ShardedStore, shard_ranges
    from repro_torch.monitor import (Monitor, QueueTransport, ShardProducer,
                                     build_chaos_psg)
    psg = build_chaos_psg()
    ranges = shard_ranges(4096, 8)
    truth = simulate(psg, 4096, lambda p, v: 0.0 if v == 13 else 1.0 + v,
                     inject={(77, 4): 4.0}, comm_time=lambda *a: 0.05,
                     jitter=0.0, shards=ranges).ppg
    qs = [QueueTransport(), QueueTransport()]
    mon = Monitor(psg, ranges, qs[0], comm=truth.comm, detect_every=1)
    assert mon.device.type == "cuda"          # the default is the card
    ref = Monitor(psg, ranges, qs[1], comm=truth.comm, detect_every=1,
                  backend="numpy")
    prod = ShardedStore(ranges, len(psg.vertices))
    producers = [ShardProducer(h, prod.shards[h], Tee(*qs),
                               sleep=lambda s: None) for h in range(8)]
    for h, p in enumerate(producers):
        prod.shards[h].apply_rows(truth.perf.shards[h].extract_rows(
            np.arange(512)))
        p.flush(heartbeat=False)
    assert report_key(mon.poll()) == report_key(ref.poll())
    view = mon.ppg.device_view(mon.device)
    for h in (0, 5):
        prod.shards[h].set_entries(np.arange(100, 116), 6, 9.0 + h)
        producers[h].flush(heartbeat=False)
        ops.reset_launch_counts()
        rep = mon.poll()
        assert view.last_upload_rows == 16
        assert dict(ops.launch_counts) == {"abnormal": 1}
        assert report_key(rep) == report_key(ref.poll())


def _smoke_trainer(dev, ckpt="", steps=4, scalana=True):
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.training import Trainer
    run = RunConfig(total_steps=8, warmup_steps=2, learning_rate=1e-3,
                    checkpoint_dir=ckpt, checkpoint_every=100,
                    scalana=scalana, scalana_sample_every=2)
    return Trainer(run, arch_cfg=get_smoke("tinyllama-1.1b"),
                   shape=ShapeConfig("smoke", 32, 4, "train"), device=dev)


@pytest.mark.cuda
def test_trainer_smoke_steps_on_the_card(card, tmp_path):
    """From the same initial state, the Trainer on the card with ScalAna on
    (every second step through the fenced replay) gives the losses of the
    card Trainer without it within 1e-5 relative over four steps, and its
    first loss is the CPU's within 1e-5 (later steps are not held to the CPU: AdamW's
    first step moves a weight by about lr whatever the size of its
    gradient, so a near-zero gradient computed in another order moves it
    differently; tests/test_torch_train.py); 4 + 4 steps across a
    checkpoint equal 8 uninterrupted within 1e-5; the report's abnormal
    detect on the card, over the measured times replayed at 8 processes
    with one loop slowed at one of them, is one ``ab_fused`` launch equal
    to numpy's that flags the slowed loop."""
    from repro_torch.core import detect_abnormal
    from repro_torch.core.inject import schedule, simulate
    from repro_torch.kernels.detect_fused import kernel
    from repro_torch.training.trainer import state_from_tree, state_to_tree
    runs = {"cpu": _smoke_trainer("cpu"), "card": _smoke_trainer(card),
            "eager": _smoke_trainer(card, scalana=False)}
    assert runs["card"].device.type == "cuda"
    # the CPU's initial state on every device (a card generator draws
    # other numbers than the CPU's)
    start = state_to_tree(runs["cpu"].init_state())
    losses = {}
    for name, tr in runs.items():
        tr.train(num_steps=4, state=state_from_tree(start, tr.init_state()))
        losses[name] = [m["loss"] for m in tr.metrics_log]
    np.testing.assert_allclose(losses["card"], losses["eager"], rtol=1e-5)
    np.testing.assert_allclose(losses["card"][0], losses["cpu"][0],
                               rtol=1e-5)
    assert runs["card"].profiler.sampled_steps == 2
    psg, perf, _ = runs["card"].scalana_artifacts()
    # the measured times over 8 processes, the first loop twice as slow
    # at p5 (one process alone can never be abnormal)
    target = next(v for v in schedule(psg) if psg.vertices[v].kind == "Loop")
    ppg = simulate(psg, 8, runs["card"].profiler.base_times(),
                   inject={(5, target): perf[target].time}).ppg
    kernel.reset_launches()
    got = detect_abnormal(ppg, backend="torch", device=card)
    assert kernel.ab_fused.launches == 1
    assert got == detect_abnormal(ppg, backend="numpy")
    assert (5, target) in [(a.proc, a.vid) for a in got]
    once = _smoke_trainer(card, str(tmp_path / "a"), scalana=False)
    once.train(num_steps=8)
    for _ in range(2):
        half = _smoke_trainer(card, str(tmp_path / "b"), scalana=False)
        half.train(num_steps=4)
    np.testing.assert_allclose([m["loss"] for m in half.metrics_log],
                               [m["loss"] for m in once.metrics_log][4:],
                               rtol=1e-5)


CARD_RANK = """
import sys
import torch
import torch.distributed as dist
from repro_torch.configs import get_smoke
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.core.profiler import GraphProfiler
from repro_torch.data import make_dataset
from repro_torch.distributed.axes import use_rules
from repro_torch.launch.mesh import init_group, make_host_mesh
from repro_torch.models import build_model
from repro_torch.optim import adamw_init
from repro_torch.optim.schedule import constant
from repro_torch.optim.tree import leaves
from repro_torch.training import TrainState, make_train_step
from repro_torch.training.trainer import to_device

rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
backend = init_group(rank, world, "file://" + init, device="cuda",
                     timeout_s=60)
try:
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_smoke("tinyllama-1.1b")
    model = build_model(cfg, device=dev)
    params = model.init(model.generator(0))
    state = TrainState(params, adamw_init(params), None,
                       torch.zeros((), dtype=torch.int32, device=dev))
    step = make_train_step(model, RunConfig(), constant(1e-3))
    data = make_dataset(cfg, ShapeConfig("dp", 16, 4, "train"))
    batch = to_device(data.shard(world, rank).batch(0), dev)
    with use_rules(make_host_mesh()):
        prof = GraphProfiler(step, (state, batch), sample_every=1)
        new, metrics = prof.step(state, batch)
    comm = prof.psg.by_kind("Comm")
    torch.save({"backend": backend, "loss": float(metrics["loss"]),
                "grad_norm": float(metrics["grad_norm"]),
                "mu": [m.cpu() for m in leaves(new.opt.mu)],
                "comm": [(v.comm_kind, v.comm_bytes,
                          v.meta["replica_groups"]) for v in comm]}, out)
finally:
    dist.destroy_process_group()
"""


@pytest.mark.cuda
def test_two_rank_data_parallel_step_on_the_card(card, tmp_path):
    """Two ranks on the card (NCCL with a card each, else Gloo on one
    card), each on its shard, through the profiler's replay: the loss and
    grad norm of the one-process card step on the whole batch within 1e-5
    relative, and its first moments (0.1 x the averaged gradients) within
    1e-5 relative and 1e-4 of each leaf's largest magnitude, the gradient
    tolerance of tests/test_torch_train.py (the new weights are not held
    element by element: AdamW's first step moves a weight by about lr
    whatever its gradient's size, so a near-zero gradient summed in
    another order moves it differently); one Comm all-reduce over
    [0, 1]."""
    import os
    import subprocess
    import sys
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.data import make_dataset
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init, constant
    from repro_torch.optim.tree import leaves
    from repro_torch.training import TrainState, make_train_step
    from repro_torch.training.trainer import to_device
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", CARD_RANK, str(r), "2",
                               str(tmp_path / "init"), outs[r]], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), logs
    cfg = get_smoke("tinyllama-1.1b")
    model = build_model(cfg, device=card)
    params = model.init(model.generator(0))
    state = TrainState(params, adamw_init(params), None,
                       torch.zeros((), dtype=torch.int32, device=card))
    batch = to_device(make_dataset(cfg, ShapeConfig("dp", 16, 4, "train"))
                      .batch(0), card)
    new, metrics = make_train_step(model, RunConfig(), constant(1e-3))(
        state, batch)
    for out in outs:
        got = torch.load(out, weights_only=False)
        assert got["backend"] == ("nccl" if torch.cuda.device_count() >= 2
                                  else "gloo")
        assert got["comm"] == [("all_reduce", 4 * (model.param_count() + 1),
                                [[0, 1]])]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[k], float(metrics[k]), rtol=1e-5)
        for a, b in zip(got["mu"], leaves(new.opt.mu)):
            b = b.cpu().numpy()
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                       atol=1e-4 * np.abs(b).max())
