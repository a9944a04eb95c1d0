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
