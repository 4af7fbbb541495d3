"""PyTorch/CUDA port of ``rcu_tpu`` (the JAX package stays the reference).

The package mirrors ``rcu_tpu``'s layout (``data/``, ``engine/``,
``models/``, ``ops/``, ``eval/``, ``cli/``) and imports ``torch`` and numpy
only — never JAX, flax, optax or any module of ``rcu_tpu``. ``h5py``,
``msgpack`` and ``yaml`` are imported inside the functions that read H5
stores, msgpack checkpoints and yaml configs, so ``import rcu_tpu_torch``
works without them. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
