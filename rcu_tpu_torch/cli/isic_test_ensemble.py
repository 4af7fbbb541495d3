"""ISIC test script (ensemble) (``bin/isic_test_ensemble.py`` counterpart): resolves a config id
to its default yaml and runs ``rcu_tpu_torch.strategies.test_ensemble``.

  python -m rcu_tpu_torch.cli.isic_test_ensemble [-config_file F | -config_id ID] [-device cpu]
      [-devices N]

``-devices N`` runs on a mesh of N cards (with ``-device cpu``, N
entries of the CPU: the virtual mesh).
"""
from rcu_tpu_torch.cli import _cli

DEFAULT_CONFIGS = {'ensemble': 'test_isic_ensemble.yaml'}


def main(config_file, config_id=None, device=None, devices=None):
    mesh = _cli.mesh_from_devices(devices, device)
    config_file = _cli.resolve_config(config_file, config_id, DEFAULT_CONFIGS,
                                      'ensemble')
    from rcu_tpu_torch import strategies
    config = _cli.load_test_config(config_file)
    return strategies.test_ensemble(config, device=device, mesh=mesh, symlink_inputs=True)


def cli():
    _cli.run_main(main, 'ISIC test script (ensemble)')


if __name__ == "__main__":
    cli()
