"""The port stands alone: it imports neither jax nor the JAX package.

Each check runs in a fresh interpreter whose import system refuses
``jax`` and ``repro`` (the JAX package), so a stray import anywhere in
``repro_torch`` fails loudly.  The port's entry points then run a small
diagnosis on the CPU.  Also: ``backend="torch"`` with no device means the
card, and raises where there is none.
"""
import os
import subprocess
import sys
import textwrap

import pytest
import torch

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

BLOCK = textwrap.dedent("""
    import sys

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                raise ImportError(f"blocked import: {name}")
            return None

    sys.meta_path.insert(0, Refuse())
""")


def _run(body: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    return subprocess.run([sys.executable, "-c", BLOCK + textwrap.dedent(body)],
                          capture_output=True, text=True, env=env,
                          timeout=300)


MODULES = ["repro_torch", "repro_torch.convert", "repro_torch.core",
           "repro_torch.core.graph", "repro_torch.core.shard",
           "repro_torch.core.hlo", "repro_torch.core.commdep",
           "repro_torch.core.ppg", "repro_torch.core.inject",
           "repro_torch.core.detect", "repro_torch.core.detect_torch",
           "repro_torch.core.backtrack", "repro_torch.core.report",
           "repro_torch.kernels", "repro_torch.kernels.detect_fused",
           "repro_torch.kernels.detect_fused.kernel",
           "repro_torch.kernels.detect_fused.ops",
           "repro_torch.kernels.detect_fused.ref", "repro_torch.scenarios",
           "repro_torch.kernels._build", "repro_torch.kernels.flash_attention",
           "repro_torch.kernels.flash_attention.kernel",
           "repro_torch.kernels.flash_attention.ops",
           "repro_torch.kernels.flash_attention.ref", "repro_torch.configs",
           "repro_torch.configs.base", "repro_torch.configs.tinyllama_1_1b",
           "repro_torch.models", "repro_torch.models.params",
           "repro_torch.models.layers", "repro_torch.models.attention",
           "repro_torch.models.transformer", "repro_torch.models.api",
           "repro_torch.configs.mamba2_130m", "repro_torch.configs.zamba2_2_7b",
           "repro_torch.models.mamba2", "repro_torch.models.ssm_lm",
           "repro_torch.models.hybrid", "repro_torch.kernels.ssd_scan",
           "repro_torch.kernels.ssd_scan.kernel",
           "repro_torch.kernels.ssd_scan.ops",
           "repro_torch.kernels.ssd_scan.ref", "repro_torch.optim",
           "repro_torch.optim.tree", "repro_torch.optim.schedule",
           "repro_torch.optim.adamw", "repro_torch.optim.compress",
           "repro_torch.training", "repro_torch.training.trainer",
           "repro_torch.core.contraction", "repro_torch.core.costs",
           "repro_torch.core.psg", "repro_torch.core.profiler",
           "repro_torch.checkpoint", "repro_torch.checkpoint.store",
           "repro_torch.monitor", "repro_torch.monitor.validate",
           "repro_torch.monitor.clock", "repro_torch.monitor.transport",
           "repro_torch.monitor.producer", "repro_torch.monitor.degraded",
           "repro_torch.monitor.aggregator", "repro_torch.monitor.wire",
           "repro_torch.monitor.net", "repro_torch.monitor.chaos",
           "repro_torch.runs", "repro_torch.runs.store",
           "repro_torch.runs.align", "repro_torch.runs.cluster",
           "repro_torch.runs.diff", "repro_torch.runs.report",
           "repro_torch.configs.moonshot_v1_16b_a3b",
           "repro_torch.configs.dbrx_132b", "repro_torch.models.moe",
           "repro_torch.serving", "repro_torch.serving.engine",
           "repro_torch.launch", "repro_torch.launch.serve",
           "repro_torch.configs.nemotron_4_15b", "repro_torch.configs.yi_6b",
           "repro_torch.configs.gemma_7b",
           "repro_torch.configs.seamless_m4t_medium",
           "repro_torch.configs.internvl2_2b", "repro_torch.models.encdec",
           "repro_torch.data", "repro_torch.data.pipeline",
           "repro_torch.distributed", "repro_torch.distributed.axes",
           "repro_torch.launch.mesh", "repro_torch.launch.train",
           "repro_torch.launch.scaling_profile",
           "repro_torch.launch.shardings", "repro_torch.core.fx_walk",
           "repro_torch.launch.dryrun", "repro_torch.launch.autotune"]


def test_every_module_imports_with_jax_and_repro_blocked():
    out = _run(f"""
        import importlib
        for name in {MODULES!r}:
            importlib.import_module(name)
        assert not any(m == "repro" or m.startswith("repro.")
                       for m in sys.modules)
        assert "jax" not in sys.modules
        print("ok")
    """)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_run_a_diagnosis_with_jax_and_repro_blocked():
    out = _run("""
        from repro_torch import backtrack, render_report, root_causes
        from repro_torch.scenarios import get_scenario, run_and_score
        sc = get_scenario("serving_batch_skew")
        res, score = run_and_score(sc, 512, backend="torch", device="cpu")
        assert res.abnormal and score.passes(sc.truth), score.row()
        text = render_report(res.ppg, res.non_scalable, res.abnormal,
                             res.paths)
        assert "abnormal" in text.lower()
        print("ok")
    """)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_model_entry_points_run_with_jax_and_repro_blocked():
    out = _run("""
        import torch
        from repro_torch import build_model
        from repro_torch.configs import get_smoke
        for arch in ("tinyllama-1.1b", "mamba2-130m", "zamba2-2.7b"):
            cfg = get_smoke(arch).replace(use_kernels=True)
            m = build_model(cfg, device="cpu")
            p = m.init(m.generator(0))
            toks = torch.randint(0, cfg.vocab_size, (2, 17),
                                 generator=torch.Generator().manual_seed(0))
            loss, _ = m.train_loss(p, {"tokens": toks})
            logits, cache = m.prefill(p, {"tokens": toks[:, :8]}, 16)
            logits, cache = m.decode_step(p, cache,
                                          logits[:, -1].argmax(-1)[:, None])
            assert torch.isfinite(loss)
            assert logits.shape == (2, 1, cfg.vocab_size)
        print("ok")
    """)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_zoo_entry_points_run_with_jax_and_repro_blocked():
    """The encoder-decoder and the VLM with their frontends' embeddings,
    and gemma's h = 32 smoke heads, through the kernel path on the CPU."""
    out = _run("""
        import torch
        from repro_torch import build_model
        from repro_torch.configs import ARCHS, get_smoke
        assert len(ARCHS) == 10
        g = torch.Generator().manual_seed(0)
        for arch, key in (("seamless-m4t-medium", "frames"),
                          ("internvl2-2b", "patches"), ("gemma-7b", None)):
            cfg = get_smoke(arch).replace(use_kernels=True)
            m = build_model(cfg, device="cpu")
            p = m.init(m.generator(0))
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 17),
                                             generator=g)}
            if key:
                batch[key] = torch.randn(2, cfg.frontend_len, cfg.d_model,
                                         generator=g)
            loss, _ = m.train_loss(p, batch)
            short = dict(batch, tokens=batch["tokens"][:, :8])
            logits, cache = m.prefill(p, short, 32)
            logits, cache = m.decode_step(p, cache,
                                          logits[:, -1].argmax(-1)[:, None])
            assert torch.isfinite(loss)
            assert logits.shape == (2, 1, cfg.vocab_size)
        print("ok")
    """)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_serving_engine_runs_with_jax_and_repro_blocked():
    out = _run("""
        import numpy as np
        from repro_torch import build_model
        from repro_torch.configs import get_smoke
        from repro_torch.serving import Request, ServingEngine
        for arch in ("tinyllama-1.1b", "zamba2-2.7b", "moonshot-v1-16b-a3b"):
            m = build_model(get_smoke(arch), device="cpu")
            eng = ServingEngine(m, m.init(m.generator(0)), batch_slots=2,
                                max_seq=24)
            res = eng.run([Request(uid=i, prompt=np.arange(1, 4 + i),
                                   max_new_tokens=3, temperature=0.5 * i,
                                   seed=i) for i in range(3)])
            assert [len(r.tokens) for r in res] == [3, 3, 3]
        assert "jax" not in sys.modules
        print("ok")
    """)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_train_step_example_runs_with_jax_and_repro_blocked():
    # the torch example end to end: a traced, profiled train step, the
    # replay, the detect and the backtrack, with the JAX package refused
    example = os.path.join(os.path.dirname(__file__), "..", "examples",
                           "diagnose_scaling_loss_torch.py")
    out = _run(f"""
        import runpy
        sys.argv = ["diagnose_scaling_loss_torch.py", "--device", "cpu"]
        try:
            runpy.run_path({os.path.abspath(example)!r}, run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        assert "jax" not in sys.modules
    """)
    assert out.returncode == 0, out.stderr
    assert "root cause recovered: True" in out.stdout


def test_training_launcher_and_quickstart_run_with_jax_and_repro_blocked():
    # the launcher with a checkpoint and the report, then the quickstart,
    # on the CPU
    example = os.path.join(os.path.dirname(__file__), "..", "examples",
                           "quickstart_torch.py")
    out = _run(f"""
        import os, runpy, tempfile
        from repro_torch.launch import train
        with tempfile.TemporaryDirectory() as d:
            train.main(["--arch", "mamba2-130m", "--smoke", "--steps", "4",
                        "--sample-every", "2", "--ckpt-dir", d, "--report",
                        "--device", "cpu"])
            assert sorted(os.listdir(d)) == ["step_2", "step_4"]
        sys.argv = ["quickstart_torch.py", "--device", "cpu"]
        runpy.run_path({os.path.abspath(example)!r}, run_name="__main__")
        assert "jax" not in sys.modules
    """)
    assert out.returncode == 0, out.stderr
    assert "[train] mamba2-130m (smoke) on cpu: 4 steps" in out.stdout
    assert out.stdout.count("ScalAna scaling-loss report") == 2


def test_importing_the_port_builds_nothing():
    # every module imported in a fresh interpreter whose process spawning
    # and library loading are recorded: no nvcc starts, nothing is loaded
    out = _run(f"""
        import ctypes, importlib, subprocess
        import torch
        spawned = []
        class Record(subprocess.Popen):
            def __init__(self, args, *a, **k):
                spawned.append(args)
                super().__init__(args, *a, **k)
        subprocess.Popen = Record
        real_cdll = ctypes.CDLL
        def cdll(name, *a, **k):
            spawned.append(name)
            return real_cdll(name, *a, **k)
        ctypes.CDLL = cdll
        for name in {MODULES!r}:
            importlib.import_module(name)
        from repro_torch.kernels import _build
        from repro_torch.kernels.detect_fused import kernel
        from repro_torch.kernels.flash_attention import kernel as flash
        from repro_torch.kernels.ssd_scan import kernel as ssd
        assert spawned == [], spawned
        assert _build._LIBS == {{}} and _build.BUILD_LOG == {{}}
        assert kernel.ab_fused.launches == 0 == kernel.ns_fused.launches
        assert flash.flash_attention.launches == 0 == ssd.ssd_scan.launches
        print("ok")
    """)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_torch_backend_without_device_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.core import detect_abnormal
    from repro_torch.scenarios import get_scenario
    res = get_scenario("serving_batch_skew").run(16, backend="numpy")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        detect_abnormal(res.ppg, backend="torch")
    # "auto" takes the card only where one exists: numpy here
    assert detect_abnormal(res.ppg, backend="auto") == \
        detect_abnormal(res.ppg, backend="numpy")
    # and so does the bank's default
    assert get_scenario("serving_batch_skew").run(16).key() == res.key()


def test_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.detect_fused import kernel
    t = torch.ones(4, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.ab_fused(t, None, torch.zeros(0, dtype=torch.int32), 1.3,
                        0.01, 2)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.ns_fused(t[None], t[None], torch.zeros(4, 0, 3), None, None,
                        None, tail=False)
    from repro_torch.kernels.ssd_scan import kernel as ssd
    x = torch.zeros(1, 64, 2, 64)
    bc = torch.zeros(1, 64, 128)
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_scan(x, torch.zeros(1, 64, 2), -torch.ones(2), bc, bc,
                     chunk=64)
    assert ssd.ssd_scan.launches == 0


def test_monitor_and_diff_without_device_mean_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import numpy as np
    from repro_torch.core.detect_torch import fit_slopes
    from repro_torch.monitor import (Monitor, QueueTransport,
                                     build_chaos_psg, chaos_run,
                                     socket_chaos_run)
    psg = build_chaos_psg(4)
    for kw in ({}, {"backend": "torch"}, {"backend": None}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Monitor(psg, [(0, 4), (4, 8)], QueueTransport(), **kw)
        # the chaos harnesses detect where the Monitor does
        with pytest.raises(RuntimeError, match="no CUDA device"):
            chaos_run(n_procs=16, n_hosts=2, **kw)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            socket_chaos_run(n_procs=16, n_hosts=2, **kw)
    with pytest.raises(ValueError, match="unknown detect backend"):
        Monitor(psg, [(0, 4)], QueueTransport(), backend="jax")
    # the CPU is asked for, either way
    assert Monitor(psg, [(0, 4)], QueueTransport(),
                   device="cpu").device == torch.device("cpu")
    assert Monitor(psg, [(0, 4)], QueueTransport(),
                   backend="numpy").backend == "numpy"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_slopes([8, 16], np.ones((2, 3)), np.ones((2, 3), bool))


def test_monitor_chaos_runs_with_jax_and_repro_blocked():
    out = _run("""
        import tempfile
        from repro_torch.monitor import chaos_run
        with tempfile.TemporaryDirectory() as d:
            r = chaos_run(n_procs=32, n_hosts=4, seed=1, dead_hosts=(2,),
                          snapshot_dir=d, crash_after_round=2,
                          backend="torch", device="cpu")
        assert r.converged and r.report.degraded
        print("ok")
    """)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
