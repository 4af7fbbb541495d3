"""The port stands alone: every module of ``rcu_tpu_torch`` imports with JAX,
flax, optax and the JAX package blocked, and with the packages that the
card's machine may lack (h5py, msgpack, yaml, PIL, tensorboardX, which
only ``engine.hooks.TensorboardHook`` imports, sklearn, which only the
stratified split functions of ``data.split`` import, pandas, which no
module imports, and matplotlib, which only the analysis tools' drawing
functions import) or that only one function reads (scipy, in
``utils.labels.border_mask``); ``chip_smoke.py`` imports none of the
blocked packages."""
import ast
import os
import subprocess
import sys
import textwrap

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "rcu_tpu", "h5py", "msgpack",
           "yaml", "PIL", "tensorboardX", "scipy", "sklearn", "pandas",
           "matplotlib")
NEVER = ("jax", "jaxlib", "flax", "optax", "rcu_tpu")


def test_every_module_imports_with_jax_blocked():
    script = textwrap.dedent(f"""
        import importlib, importlib.abc, pkgutil, sys

        BLOCKED = {BLOCKED!r}

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"blocked import of {{name}}")
                return None

        sys.meta_path.insert(0, Block())
        import rcu_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            rcu_tpu_torch.__path__, "rcu_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not leaked, leaked
        print(" ".join(names))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": REPO_ROOT})
    assert proc.returncode == 0, proc.stderr
    walked = set(proc.stdout.split())
    assert len(walked) >= 70  # every module was walked, these among them
    assert {"rcu_tpu_torch.engine.test", "rcu_tpu_torch.eval.actions",
            "rcu_tpu_torch.eval.analysis", "rcu_tpu_torch.eval.kernels",
            "rcu_tpu_torch.eval.evaldata", "rcu_tpu_torch.utils.labels",
            "rcu_tpu_torch.utils.writerpool",
            "rcu_tpu_torch.cli.eval_uncertainty",
            "rcu_tpu_torch.cli.isic_test_auxiliary_segm",
            "rcu_tpu_torch.serve", "rcu_tpu_torch.cli.serve",
            "rcu_tpu_torch.analysis", "rcu_tpu_torch.analysis.frames",
            "rcu_tpu_torch.analysis.latex",
            "rcu_tpu_torch.analysis.resultdata",
            "rcu_tpu_torch.cli.table_ece_ue_bnf_dice",
            "rcu_tpu_torch.cli.table_supplmat_ece_dataset_vs_meansubject",
            "rcu_tpu_torch.cli.plot_calibration",
            "rcu_tpu_torch.cli.plot_supplmat_error_prec_recall",
            "rcu_tpu_torch.cli.save_images",
            "rcu_tpu_torch.cli.generate_configs"} <= walked


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(REPO_ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            imported.add(node.module or "")
    assert "rcu_tpu_torch.eval.direct" in imported
    assert not {m for m in imported if m.split(".")[0] in NEVER}, imported


def test_the_models_import_no_eval_module():
    """The layers stack one way: ``models.unet`` (and with it the state of
    the conv engine search, ``ops.precision``) loads no module of
    ``rcu_tpu_torch.eval``."""
    script = textwrap.dedent("""
        import sys
        import rcu_tpu_torch.models.unet
        print(" ".join(m for m in sys.modules
                       if m.startswith("rcu_tpu_torch.eval")))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": REPO_ROOT})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == []
