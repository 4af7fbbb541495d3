"""PyTorch/CUDA port of ``rcu_tpu`` (the JAX package stays the reference).

The package mirrors ``rcu_tpu``'s layout (``data/``, ``engine/``,
``models/``, ``ops/``, ``eval/``, ``cli/``, ``utils/``, ``strategies``) and
imports ``torch`` and numpy only — never JAX, flax, optax or any module of
``rcu_tpu``. ``h5py``, ``msgpack``, ``yaml``, ``PIL`` and ``tensorboardX``
are imported inside the functions that read H5 stores, msgpack
checkpoints, yaml configs and images, and by the tensorboard hook, so
``import rcu_tpu_torch`` works without them. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
