"""PyTorch models: the U-Net, its registry and the flax weights bridge."""
from rcu_tpu_torch.models.registry import get_model  # noqa: F401
from rcu_tpu_torch.models.unet import UNet  # noqa: F401
