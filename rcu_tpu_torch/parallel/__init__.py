"""Several devices in one process (``rcu_tpu.parallel`` counterpart,
inference side): the mesh, the sharded eval reductions and the ensemble's
members over a model axis."""
from rcu_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, MODEL_AXIS, Mesh, Sharded, Split, make_mesh,
    pad_batch_size_to_mesh, replicate, split_batch)
