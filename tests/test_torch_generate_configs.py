"""The port's config generator (``rcu_tpu_torch.cli.generate_configs``)
writes the JAX script's files (``scripts/generate_configs.py``) byte for
byte, and the committed ``config/*.yaml``."""
import filecmp
import importlib.util
import os
import sys

import pytest

from rcu_tpu_torch.cli import generate_configs as port_tool

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def yaml_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files
                  if f.endswith(".yaml") and not d.endswith("splits"))


def same_files(a, b):
    names = yaml_files(a)
    assert names == yaml_files(b)
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert mismatch == [] and errors == []
    return names


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    root = tmp_path_factory.mktemp("configs")
    out = str(root / "port")
    assert port_tool.main(out) == 66
    return root, out


def test_equals_the_jax_script(written, monkeypatch, capsys):
    root, out = written
    spec = importlib.util.spec_from_file_location(
        "jax_generate_configs",
        os.path.join(REPO_ROOT, "scripts", "generate_configs.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    monkeypatch.setattr(jax_tool, "CONFIG_DIR", str(root / "jax"))
    capsys.readouterr()
    jax_tool.main()
    assert capsys.readouterr().out == \
        f"wrote 66 config yamls under {root / 'jax'}\n"
    assert len(same_files(str(root / "jax"), out)) == 66


def test_equals_the_committed_configs(written):
    _, out = written
    names = same_files(os.path.join(REPO_ROOT, "config"), out)
    assert "train_ensemble/train_brats_ensemble_9.yaml" in names
    assert "baseline_cv/test_isic_baseline_cv4.yaml" in names


def test_cli_takes_the_output_dir(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["generate_configs", str(tmp_path)])
    port_tool.cli()
    assert capsys.readouterr().out == \
        f"wrote 66 config yamls under {tmp_path}\n"
    assert len(yaml_files(str(tmp_path))) == 66


def test_defaults_to_the_config_dir(monkeypatch, tmp_path):
    from rcu_tpu_torch import directories as dirs
    monkeypatch.setattr(dirs, "CONFIG_DIR", str(tmp_path / "config"))
    assert port_tool.main() == 66
    assert os.path.isfile(tmp_path / "config" / "test_brats_baseline.yaml")
