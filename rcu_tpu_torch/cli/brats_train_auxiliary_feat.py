"""BRATS train script (auxiliary_feat) (``bin/brats_train_auxiliary_feat.py`` counterpart): resolves a config id
to its default yaml and runs ``rcu_tpu_torch.strategies.train_auxiliary_feat``.

  python -m rcu_tpu_torch.cli.brats_train_auxiliary_feat [-config_file F | -config_id ID] [-device cpu]
      [-devices N]

``-devices N`` trains on a mesh of N cards (with ``-device cpu``, N
entries of the CPU: the virtual mesh); each step computes what one
device computes on the whole batch.
"""
from rcu_tpu_torch.cli import _cli

DEFAULT_CONFIGS = {'auxiliary_feat': 'train_brats_auxiliary_feat.yaml'}


def main(config_file, config_id=None, device=None, devices=None):
    mesh = _cli.mesh_from_devices(devices, device)
    config_file = _cli.resolve_config(config_file, config_id, DEFAULT_CONFIGS,
                                      'auxiliary_feat')
    from rcu_tpu_torch import strategies
    config = _cli.load_train_config(config_file)
    return strategies.train_auxiliary_feat(config, device=device, mesh=mesh)


def cli():
    _cli.run_main(main, 'BRATS train script (auxiliary_feat)')


if __name__ == "__main__":
    cli()
