"""The port's data pipeline against the JAX package's.

The twins of the reference's data tests (``tests/test_data_optim.py``,
``tests/test_elastic.py``) on ``repro_torch.data``, and every config's
batches bitwise equal to ``repro.data``'s at several shard layouts
(frames and patches included): the pipeline is numpy in both packages,
so the same (seed, step, shard) must give the same bits.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.configs import get_smoke as jax_smoke
from repro.data import make_dataset as jax_make_dataset
from repro_torch.configs import ARCHS, SHAPES, get_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SyntheticLMDataset, make_dataset


def _ds(**kw):
    base = dict(vocab_size=1000, seq_len=16, global_batch=8, seed=3)
    base.update(kw)
    return SyntheticLMDataset(**base)


def test_batches_deterministic_and_distinct():
    ds = _ds()
    a, b = ds.batch(5)["tokens"], ds.batch(5)["tokens"]
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(ds.batch(5)["tokens"], ds.batch(6)["tokens"])
    assert a.dtype == np.int32
    assert a.shape == (8, 17)
    assert a.min() >= 0 and a.max() < 1000


@settings(max_examples=20, deadline=None)
@given(step=st.integers(0, 1000), shards=st.sampled_from([1, 2, 4, 8]))
def test_sharding_partitions_global_batch(step, shards):
    """Property: concatenated shards == the unsharded global batch."""
    ds = _ds()
    whole = ds.batch(step)["tokens"]
    parts = [ds.shard(shards, i).batch(step)["tokens"]
             for i in range(shards)]
    np.testing.assert_array_equal(np.concatenate(parts, axis=0), whole)


def test_restart_regenerates_stream():
    a = _ds(num_shards=2, shard_index=1).batch(77)["tokens"]
    b = _ds(num_shards=2, shard_index=1).batch(77)["tokens"]
    np.testing.assert_array_equal(a, b)


def test_zipf_skew():
    toks = _ds(vocab_size=4096, global_batch=64).batch(0)["tokens"]
    low = np.mean(toks < 256)       # top 1/16 of id space
    assert low > 0.3                # heavily skewed vs uniform (0.0625)


def test_frontend_stub_for_encdec_and_vlm():
    for arch in ("seamless-m4t-medium", "internvl2-2b"):
        cfg = get_smoke(arch)
        ds = make_dataset(cfg, SHAPES["train_4k"], global_batch=4)
        key = "frames" if cfg.family == "encdec" else "patches"
        b = ds.batch(0)
        assert b[key].shape == (4, cfg.frontend_len, cfg.d_model)
        assert np.isfinite(b[key]).all()


def test_global_stream_invariant_under_resharding():
    cfg = get_smoke("tinyllama-1.1b")
    shape = ShapeConfig("t", 32, 16, "train")
    for step in (0, 7, 123):
        global_batch = make_dataset(cfg, shape).batch(step)["tokens"]
        for shards in (2, 4, 8, 16):
            ds = make_dataset(cfg, shape)
            parts = [ds.shard(shards, i).batch(step)["tokens"]
                     for i in range(shards)]
            np.testing.assert_array_equal(np.concatenate(parts), global_batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_batches_bitwise_equal_to_the_reference(arch):
    """Every config's batches, tokens and frontend embeddings, equal the
    JAX package's bit for bit at several (shards, index) and steps."""
    shape = ShapeConfig("t", 24, 8, "train")
    for seed in (0, 5):
        mine = make_dataset(get_smoke(arch), shape, seed=seed)
        ref = jax_make_dataset(jax_smoke(arch), shape, seed=seed)
        assert mine.frontend_key == ref.frontend_key
        for shards, index in ((1, 0), (2, 1), (4, 0), (4, 3), (8, 5)):
            a, b = mine.shard(shards, index), ref.shard(shards, index)
            for step in (0, 3, 1000):
                got, want = a.batch(step), b.batch(step)
                assert sorted(got) == sorted(want)
                for k in want:
                    assert got[k].dtype == want[k].dtype, k
                    assert got[k].tobytes() == want[k].tobytes(), \
                        (arch, seed, shards, index, step, k)
