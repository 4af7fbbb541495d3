"""The benchmark of ``rcu_tpu_torch`` on NVIDIA H100 cards: the harness
(``run.py``), its drivers, configurations, traffic, per-layer readers, the
yardstick's arithmetic and the plain reference that decides ``correct``.
It imports neither JAX nor the JAX package."""
