"""ISIC train script (auxiliary_segm) (``bin/isic_train_auxiliary_segm.py`` counterpart): resolves a config id
to its default yaml and runs ``rcu_tpu_torch.strategies.train_auxiliary_segm``.

  python -m rcu_tpu_torch.cli.isic_train_auxiliary_segm [-config_file F | -config_id ID] [-device cpu]
      [-devices N]

``-devices N`` trains on a mesh of N cards (with ``-device cpu``, N
entries of the CPU: the virtual mesh); each step computes what one
device computes on the whole batch.
"""
from rcu_tpu_torch.cli import _cli

DEFAULT_CONFIGS = {'auxiliary_segm': 'train_isic_auxiliary_segm.yaml'}


def main(config_file, config_id=None, device=None, devices=None):
    mesh = _cli.mesh_from_devices(devices, device)
    config_file = _cli.resolve_config(config_file, config_id, DEFAULT_CONFIGS,
                                      'auxiliary_segm')
    from rcu_tpu_torch import strategies
    config = _cli.load_train_config(config_file)
    return strategies.train_auxiliary_segm(config, device=device, mesh=mesh)


def cli():
    _cli.run_main(main, 'ISIC train script (auxiliary_segm)')


if __name__ == "__main__":
    cli()
