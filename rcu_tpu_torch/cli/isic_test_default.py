"""ISIC test script (default) (``bin/isic_test_default.py`` counterpart): resolves a config id
to its default yaml and runs ``rcu_tpu_torch.strategies.test_default``.

  python -m rcu_tpu_torch.cli.isic_test_default [-config_file F | -config_id ID] [-device cpu]
      [-devices N]

``-devices N`` runs on a mesh of N cards (with ``-device cpu``, N
entries of the CPU: the virtual mesh).
"""
from rcu_tpu_torch.cli import _cli

DEFAULT_CONFIGS = {'baseline': 'test_isic_baseline.yaml', 'baseline_mc': 'test_isic_baseline_mc.yaml', 'center': 'test_isic_center.yaml', 'center_mc': 'test_isic_center_mc.yaml', 'cv0': 'baseline_cv/test_isic_baseline_cv0.yaml', 'cv1': 'baseline_cv/test_isic_baseline_cv1.yaml', 'cv2': 'baseline_cv/test_isic_baseline_cv2.yaml', 'cv3': 'baseline_cv/test_isic_baseline_cv3.yaml', 'cv4': 'baseline_cv/test_isic_baseline_cv4.yaml'}


def main(config_file, config_id=None, device=None, devices=None):
    mesh = _cli.mesh_from_devices(devices, device)
    config_file = _cli.resolve_config(config_file, config_id, DEFAULT_CONFIGS,
                                      'baseline')
    from rcu_tpu_torch import strategies
    config = _cli.load_test_config(config_file)
    return strategies.test_default(config, device=device, mesh=mesh, symlink_inputs=True)


def cli():
    _cli.run_main(main, 'ISIC test script (default)')


if __name__ == "__main__":
    cli()
