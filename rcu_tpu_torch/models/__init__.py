"""PyTorch models: the U-Net and PostNet, their registry, optax's optimizers,
the flax weights bridge and the inference variants' load-time steps."""
from rcu_tpu_torch.models.convert import fold_bn_params  # noqa: F401
from rcu_tpu_torch.models.registry import get_model, get_optimizer  # noqa: F401
from rcu_tpu_torch.models.unet import (FAST_DECODER_KWARGS, PostNet,  # noqa: F401
                                       UNet, UNetOutput, precast_params)
