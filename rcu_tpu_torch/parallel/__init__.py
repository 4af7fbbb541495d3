"""Several devices (``rcu_tpu.parallel`` counterpart): the mesh, its train
step and ``torch.distributed`` bring-up (``mesh``), the sharded eval
reductions (``inference``) and the ensemble's members over a model axis,
for inference and fused training (``ensemble``)."""
from rcu_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, MODEL_AXIS, Mesh, Sharded, Split, make_mesh,
    pad_batch_size_to_mesh, replicate, split_batch)
