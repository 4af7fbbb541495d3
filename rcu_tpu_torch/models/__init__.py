"""PyTorch models: the U-Net and PostNet, their registry and the flax
weights bridge."""
from rcu_tpu_torch.models.registry import get_model  # noqa: F401
from rcu_tpu_torch.models.unet import PostNet, UNet, UNetOutput  # noqa: F401
