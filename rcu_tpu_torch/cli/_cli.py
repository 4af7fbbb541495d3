"""Shared plumbing of the train and test entry points (``bin/_cli.py``
counterpart): ``-config_file`` or ``-config_id`` (a default yaml of
``config/``), ``-device`` (default cuda) and ``-devices`` (a test or a
training runs on a mesh of that many devices)."""
import argparse
import logging
import os

from rcu_tpu_torch import directories as dirs
from rcu_tpu_torch.engine import config as cfg_lib


def resolve_config(config_file, config_id, default_map: dict, default_id: str):
    """``config_file`` wins; else ``config_id`` (default ``default_id``)
    names a yaml of the config directory."""
    if config_file:
        return config_file
    cid = config_id or default_id
    if cid not in default_map:
        raise ValueError(f'unknown config id "{cid}"; known: {sorted(default_map)}')
    return os.path.join(dirs.CONFIG_DIR, default_map[cid])


def mesh_from_devices(devices, device=None):
    """``-devices N`` -> a 1-D data mesh of N devices of ``-device``'s
    kind (``parallel.make_mesh``: cuda takes cuda:0..N-1 and raises where
    there are fewer; cpu is the virtual mesh of N CPU entries); None or 1
    -> no mesh."""
    if not devices or devices <= 1:
        return None
    from rcu_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(n_devices=devices, device=device or "cuda")


def run_main(main_fn, description: str):
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("-config_file", type=str, nargs="?",
                        help="yaml file containing the configuration")
    parser.add_argument("-config_id", type=str, nargs="?",
                        help="config id resolving to a default yaml")
    parser.add_argument("-device", type=str, default=None,
                        help="torch device (default cuda)")
    parser.add_argument("-devices", type=int, nargs="?", default=None,
                        help="devices to run on: a mesh of N")
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    try:
        main_fn(args.config_file, args.config_id, device=args.device,
                devices=args.devices)
    except Exception:
        logging.exception("")
        raise


def load_train_config(path) -> cfg_lib.TrainConfiguration:
    return cfg_lib.load(path, expected_type="train-config")


def load_test_config(path) -> cfg_lib.TestConfiguration:
    return cfg_lib.load(path, expected_type="test-config")
