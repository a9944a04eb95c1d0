"""The port's two remaining examples run on the CPU with the JAX package
refused: ``examples/serve_llm_torch.py`` (every request served, greedy
determinism under batching) and ``examples/train_100m_torch.py`` at a
few steps of its small config (the split run resumes and equals the
unbroken run within 1e-5, the ScalAna report renders)."""
import os
import subprocess
import sys
import textwrap

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
BLOCK = textwrap.dedent("""
    import runpy
    import sys

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                raise ImportError(f"blocked import: {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    sys.argv = sys.argv[1:]
    runpy.run_path(sys.argv[0], run_name="__main__")
    assert "jax" not in sys.modules
    assert not any(m == "repro" or m.startswith("repro.")
                   for m in sys.modules)
""")


def _example(name, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", BLOCK,
         os.path.join(ROOT, "examples", name), *args],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_serve_llm_example_on_cpu():
    text = _example("serve_llm_torch.py", "--device", "cpu")
    assert "served 10 requests / 120 tokens" in text
    assert "greedy determinism under batching: OK" in text


def test_train_100m_example_resumes_on_cpu():
    text = _example("train_100m_torch.py", "--device", "cpu", "--smoke",
                    "--steps", "4", "--batch", "4", "--seq", "32",
                    "--microbatch", "2", "--unbroken")
    assert "[half 2] resumed at step 2" in text
    assert "[unbroken] 4 steps in one run" in text
    assert "ScalAna scaling-loss report" in text
