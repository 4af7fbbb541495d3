"""Fused ensemble training (``bin/train_ensemble_fused.py`` counterpart): the
K members of ``config/train_ensemble/train_<ds>_ensemble_<k>.yaml`` in
lockstep (``rcu_tpu_torch.parallel.ensemble.train_ensemble_fused``), K
standard run dirs with per-member checkpoints that
``rcu_tpu_torch.cli.brats_test_ensemble`` reads.

  python -m rcu_tpu_torch.cli.train_ensemble_fused --ds brats          # all 10
  python -m rcu_tpu_torch.cli.train_ensemble_fused --ds isic -k 0 1 2  # a subset
      [--no-mesh] [-device cpu]

The members go over a ``("model", "data")`` mesh of every card when the
card count is a multiple of the member count and at least it (with
``-device cpu``: the CPU is one device); else, or with ``--no-mesh``,
they train one after another on ``-device``.
"""
import argparse
import logging
import os

import torch

from rcu_tpu_torch import directories as dirs
from rcu_tpu_torch.cli import _cli


def _device_count(device) -> int:
    return torch.cuda.device_count() \
        if torch.device(device or "cuda").type == "cuda" else 1


def main(dataset: str, ks=None, use_mesh: bool = True, device=None):
    from rcu_tpu_torch.parallel import ensemble as ens_lib
    from rcu_tpu_torch.parallel.mesh import make_mesh

    ks = list(ks) if ks else list(range(10))
    configs = [_cli.load_train_config(os.path.join(
        dirs.CONFIG_DIR, "train_ensemble",
        f"train_{dataset}_ensemble_{k}.yaml")) for k in ks]
    mesh = None
    if use_mesh:
        n = _device_count(device)
        if n % len(configs) == 0 and n >= len(configs):
            mesh = ens_lib.make_ensemble_mesh(
                len(configs), make_mesh(n_devices=n,
                                        device=device or "cuda").devices)
    members = ens_lib.train_ensemble_fused(configs, mesh=mesh, device=device)
    for m in members:
        print(f"{m.config.train_name}: best {m.best_score:.4f} -> "
              f"{m.model_files.model_dir}")
    return members


def cli():
    parser = argparse.ArgumentParser(description="fused ensemble training")
    parser.add_argument("--ds", type=str, default="brats")
    parser.add_argument("-k", type=int, nargs="*", default=None,
                        help="member indices (default: all 10)")
    parser.add_argument("--no-mesh", action="store_true")
    parser.add_argument("-device", type=str, default=None,
                        help="torch device (default cuda)")
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    main(args.ds, args.k, use_mesh=not args.no_mesh, device=args.device)


if __name__ == "__main__":
    cli()
