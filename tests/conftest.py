import os
import sys

# Tests must see the real single CPU device (the dry-run's 512 placeholder
# devices are set ONLY inside repro.launch.dryrun).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

try:
    import hypothesis  # noqa: F401  (the real library, when installed)
except ImportError:
    sys.path.insert(0, os.path.dirname(__file__))
    import _hypothesis_fallback as _hf
    _hyp = type(sys)("hypothesis")
    _hyp.given = _hf.given
    _hyp.settings = _hf.settings
    _hyp.strategies = _hf.strategies
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _hf.strategies

try:
    import jax
    HAS_JAX = True
except ImportError:                                # the jax-absent CI job
    jax = None
    HAS_JAX = False

import numpy as np
import pytest

# Modules whose imports need jax (models, configs with jnp dtypes, the
# profiler/launch/serving layers).  Without jax they are skipped at
# COLLECTION, so the rest of the suite — the pure-numpy analysis layer
# and its lazy-import seam — runs and must pass with jax uninstalled.
# A jax-free test file gaining a top-level jax dependency shows up in
# the jax-absent CI job as a collection error, which is the point.
_NEEDS_JAX = [
    "test_checkpoint_trainer.py",
    "test_commdep.py",
    "test_configs.py",
    "test_data_optim.py",
    "test_elastic.py",
    "test_hlo_shardings.py",
    "test_kernels.py",
    "test_launch.py",
    "test_models_smoke.py",
    "test_profiler_sim.py",
    "test_psg.py",
    "test_serving.py",
]
if not HAS_JAX:
    collect_ignore = list(_NEEDS_JAX)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


_BUNDLE_CACHE = {}


def smoke_bundle(arch: str):
    """Cached (cfg, model, params) at smoke scale (jax tests only —
    imports resolve lazily so this module loads without jax)."""
    from repro.configs import get_smoke
    from repro.models.api import build_model
    if arch not in _BUNDLE_CACHE:
        cfg = get_smoke(arch)
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        _BUNDLE_CACHE[arch] = (cfg, model, params)
    return _BUNDLE_CACHE[arch]


def smoke_batch(cfg, batch=2, seq=32, train=True):
    import jax.numpy as jnp
    toks = (jnp.arange(batch * (seq + (1 if train else 0)), dtype=jnp.int32)
            .reshape(batch, -1) * 7919) % cfg.vocab_size
    out = {"tokens": toks}
    if cfg.family == "encdec":
        out["frames"] = jnp.ones((batch, cfg.frontend_len, cfg.d_model),
                                 cfg.cdtype()) * 0.02
    if cfg.family == "vlm":
        out["patches"] = jnp.ones((batch, cfg.frontend_len, cfg.d_model),
                                  cfg.cdtype()) * 0.02
    return out


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where there is none")
