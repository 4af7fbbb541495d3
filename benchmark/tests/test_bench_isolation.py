"""Nothing a run imports is JAX or the JAX package, and the reference
imports nothing of the program: each in a fresh interpreter where an
import finder refuses those top-level names (compared whole), once for a
whole tiny run of every driver and once for the reference alone."""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap

from tiny import REPO

BLOCKER = textwrap.dedent("""
    import sys

    class Refuse:
        def __init__(self, names):
            self.names = frozenset(names)

        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in self.names:
                raise ImportError(f"{{name}} may not be imported here")
            return None

    sys.meta_path.insert(0, Refuse({names!r}))
    sys.path[:0] = [{repo!r}, {tests!r}]
""")
JAX = ("jax", "jaxlib", "flax", "optax", "rcu_tpu")


def _python(code: str, names, tmp_path):
    prelude = BLOCKER.format(names=tuple(names), repo=REPO,
                             tests=os.path.dirname(__file__))
    return subprocess.run([sys.executable, "-c", prelude + code],
                          cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=600)


def test_bench_runs_load_no_jax(tmp_path):
    code = textwrap.dedent(f"""
        import pathlib, time, torch
        from benchmark import harness
        from tiny import CELLS, make_root
        root = make_root(pathlib.Path({str(tmp_path)!r}))
        for cell in sorted(CELLS):
            for trace in (0, 1):
                result = harness.run_cell(
                    root, cell, 3, 0.1, trace, torch.device("cpu"),
                    time.clock_gettime(time.CLOCK_BOOTTIME))
                assert result["correct"], (cell, result["checks"])
        import benchmark.calibrate
        assert not harness.forbidden_modules()
        print("ok")
    """)
    done = _python(code, JAX, tmp_path)
    assert done.returncode == 0 and done.stdout.strip() == "ok", done.stderr


def test_bench_reference_imports_nothing_of_the_program(tmp_path):
    code = textwrap.dedent("""
        import benchmark.reference.evalrows, benchmark.reference.streams
        import benchmark.reference.train, benchmark.reference.unet
        import benchmark.compare, benchmark.roofline, benchmark.inputs
        print("ok")
    """)
    done = _python(code, JAX + ("rcu_tpu_torch",), tmp_path)
    assert done.returncode == 0 and done.stdout.strip() == "ok", done.stderr


def test_bench_forbidden_names_are_compared_whole():
    from benchmark.harness import forbidden_modules
    assert forbidden_modules(["rcu_tpu_torch", "rcu_tpu_torch.eval",
                              "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["rcu_tpu.ops", "jax.numpy", "optax"]) == \
        ["jax", "optax", "rcu_tpu"]
