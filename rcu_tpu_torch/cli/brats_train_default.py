"""BRATS train script (default) (``bin/brats_train_default.py`` counterpart): resolves a config id
to its default yaml and runs ``rcu_tpu_torch.strategies.train_default``.

  python -m rcu_tpu_torch.cli.brats_train_default [-config_file F | -config_id ID] [-device cpu]
      [-devices N]

``-devices N`` trains on a mesh of N cards (with ``-device cpu``, N
entries of the CPU: the virtual mesh); each step computes what one
device computes on the whole batch.
"""
from rcu_tpu_torch.cli import _cli

DEFAULT_CONFIGS = {'baseline': 'train_brats_baseline.yaml', 'center': 'train_brats_center.yaml', 'cv0': 'baseline_cv/train_brats_baseline_cv0.yaml', 'cv1': 'baseline_cv/train_brats_baseline_cv1.yaml', 'cv2': 'baseline_cv/train_brats_baseline_cv2.yaml', 'cv3': 'baseline_cv/train_brats_baseline_cv3.yaml', 'cv4': 'baseline_cv/train_brats_baseline_cv4.yaml', 'ensemble0': 'train_ensemble/train_brats_ensemble_0.yaml', 'ensemble1': 'train_ensemble/train_brats_ensemble_1.yaml', 'ensemble2': 'train_ensemble/train_brats_ensemble_2.yaml', 'ensemble3': 'train_ensemble/train_brats_ensemble_3.yaml', 'ensemble4': 'train_ensemble/train_brats_ensemble_4.yaml', 'ensemble5': 'train_ensemble/train_brats_ensemble_5.yaml', 'ensemble6': 'train_ensemble/train_brats_ensemble_6.yaml', 'ensemble7': 'train_ensemble/train_brats_ensemble_7.yaml', 'ensemble8': 'train_ensemble/train_brats_ensemble_8.yaml', 'ensemble9': 'train_ensemble/train_brats_ensemble_9.yaml'}


def main(config_file, config_id=None, device=None, devices=None):
    mesh = _cli.mesh_from_devices(devices, device)
    config_file = _cli.resolve_config(config_file, config_id, DEFAULT_CONFIGS,
                                      'baseline')
    from rcu_tpu_torch import strategies
    config = _cli.load_train_config(config_file)
    return strategies.train_default(config, device=device, mesh=mesh)


def cli():
    _cli.run_main(main, 'BRATS train script (default)')


if __name__ == "__main__":
    cli()
