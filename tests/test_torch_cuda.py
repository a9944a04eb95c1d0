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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ab_fused_matches_plain_exactly(card, dtype):
    t, _, _, top, _ = _case(dtype)
    live = t[-1].contiguous()
    P = live.shape[0]
    valid = torch.rand(P, generator=torch.Generator().manual_seed(0)) > 0.1
    pad = torch.cat([valid.nonzero()[:, 0],
                     torch.zeros(int((~valid).sum()), dtype=torch.long)])
    mask = torch.arange(P) < int(valid.sum())
    blocks = list(live.chunk(3))
    for k, kw, want in [
            (64, {}, ref.abnormal(live, None, top, 1.5, 0.001, 64)),
            (64, dict(step_time=3.25),
             ref.abnormal(live, None, top, 1.5, 0.001, 64, step_time=3.25)),
            (64, dict(live=pad.to(card), valid=mask.to(card)),
             ref.abnormal(live.index_select(0, pad.to(card)), mask.to(card),
                          top, 1.5, 0.001, 64)),
            # lists longer than a block's threads, reaching the -inf tail
            (2000, {}, ref.abnormal(live, None, top, 1.5, 0.001, 2000))]:
        got = ops.fused_abnormal(blocks, top, 1.5, 0.001, k, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


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
# (tests/test_kernels.py), a ragged length the kernel masks itself, and
# the full-width tinyllama layer
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
