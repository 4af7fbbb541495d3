"""String -> model and optimizer registries, the config surface of
``rcu_tpu.models.registry`` (``model: {unet: {...}}``, ``model: {postnet:
{...}}``, ``optimizer: {adam: {lr: ...}}``), and the port's own
``model: {transunet: {...}}`` (``models.transunet``) and ``model:
{swin_unetr: {...}}`` (``models.swin_unetr``)."""
from __future__ import annotations

import torch
from torch import nn

from rcu_tpu_torch.models.optim import get_optimizer  # noqa: F401
from rcu_tpu_torch.models.swin_unetr import SwinUNETR
from rcu_tpu_torch.models.transunet import TransUNet
from rcu_tpu_torch.models.unet import PostNet, UNet

_KEYS = {"unet": {"nb_classes", "in_channels", "depth", "start_filters",
                  "dropout", "dropout_center", "residual", "sigma_out",
                  "provide_features", "bn", "dtype", "split_decoder_concat",
                  "fused_upsample", "fold_bn", "quant_scales",
                  "quant_skip_levels"},
         "postnet": {"nb_classes", "in_channels", "nb_convs", "dropout",
                     "dtype", "fold_bn"},
         "transunet": {"nb_classes", "in_channels", "img_size", "hidden",
                       "mlp_dim", "heads", "layers", "resnet_units", "width",
                       "decoder_channels", "head_channels", "n_skip",
                       "dropout", "attention_dropout", "dtype"},
         "swin_unetr": {"nb_classes", "in_channels", "img_size",
                        "feature_size", "depths", "heads", "window", "patch",
                        "mlp_ratio", "drop_rate", "attn_drop_rate",
                        "dropout_path_rate", "use_v2", "dtype"}}
_BUILD = {"unet": UNet, "postnet": PostNet, "transunet": TransUNet,
          "swin_unetr": SwinUNETR}
_DTYPES = {None: torch.float32, "float32": torch.float32,
           "bfloat16": torch.bfloat16}


def get_model(model_type: str, params: dict) -> nn.Module:
    """Build the port's model from a config/model.json node.

    ``dtype`` is None, ``"float32"`` or ``"bfloat16"``; a U-Net takes the
    int8 ``quant_scales`` and ``quant_skip_levels``, and ``residual`` and
    ``bn``, which the JAX package's PostNet has not (a key outside a
    model's fields raises ``ValueError``). A PostNet needs
    ``in_channels``, which flax infers and a model.json may leave out
    (``eval.direct.load_model`` reads it from the checkpoint). A TransUNet
    takes the published R50-ViT-B/16 widths where the node leaves them
    out, and float32 only; a Swin UNETR MONAI's BraTS 2021 widths, float32
    only, without stochastic depth, attention dropout or v2 blocks."""
    if model_type not in _BUILD:
        raise NotImplementedError(
            f'model type "{model_type}" is not ported to rcu_tpu_torch yet')
    kwargs = {}
    for key, value in params.items():
        if key not in _KEYS[model_type]:
            raise ValueError(f'unknown {model_type} param "{key}"')
        kwargs[key] = value
    if kwargs.get("dtype") not in _DTYPES:
        raise NotImplementedError(
            f"{model_type} dtype={kwargs['dtype']!r} is not ported to "
            f"rcu_tpu_torch: the compute dtype is float32 or bfloat16")
    kwargs["dtype"] = _DTYPES[kwargs.get("dtype")]
    if model_type == "postnet" and not kwargs.get("in_channels"):
        raise ValueError("postnet needs in_channels > 0 (flax infers it; take "
                         "it from the checkpoint's first kernel)")
    return _BUILD[model_type](**kwargs)
