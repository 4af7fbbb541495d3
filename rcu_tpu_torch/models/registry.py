"""String -> model and optimizer registries, the config surface of
``rcu_tpu.models.registry`` (``model: {unet: {...}}``, ``model: {postnet:
{...}}``, ``optimizer: {adam: {lr: ...}}``)."""
from __future__ import annotations

import torch
from torch import nn

from rcu_tpu_torch.models.optim import get_optimizer  # noqa: F401
from rcu_tpu_torch.models.unet import PostNet, UNet

_KEYS = {"unet": {"nb_classes", "in_channels", "depth", "start_filters",
                  "dropout", "dropout_center", "sigma_out",
                  "provide_features", "dtype", "split_decoder_concat",
                  "fused_upsample", "fold_bn", "quant_scales",
                  "quant_skip_levels"},
         "postnet": {"nb_classes", "in_channels", "nb_convs", "dropout",
                     "dtype", "fold_bn"}}
_BUILD = {"unet": UNet, "postnet": PostNet}
_DTYPES = {None: torch.float32, "float32": torch.float32,
           "bfloat16": torch.bfloat16}
# model.json records that the port reproduces only at these values
_NEUTRAL = {"residual": False, "bn": True}


def get_model(model_type: str, params: dict) -> nn.Module:
    """Build the port's model from a config/model.json node.

    ``dtype`` is None, ``"float32"`` or ``"bfloat16"``; a U-Net takes the
    int8 ``quant_scales`` and ``quant_skip_levels``. Options of later
    slices (residual blocks, bn=False) raise ``NotImplementedError``
    instead of being silently ignored. A PostNet needs ``in_channels``,
    which flax infers and a model.json may leave out
    (``eval.direct.load_model`` reads it from the checkpoint)."""
    if model_type not in _BUILD:
        raise NotImplementedError(
            f'model type "{model_type}" is not ported to rcu_tpu_torch yet')
    kwargs = {}
    for key, value in params.items():
        if key in _KEYS[model_type]:
            kwargs[key] = value
            continue
        if key not in _NEUTRAL:
            raise ValueError(f'unknown {model_type} param "{key}"')
        if value != _NEUTRAL[key]:
            raise NotImplementedError(
                f"{model_type} {key}={value!r} is not ported to "
                "rcu_tpu_torch yet")
    if kwargs.get("dtype") not in _DTYPES:
        raise NotImplementedError(
            f"{model_type} dtype={kwargs['dtype']!r} is not ported to "
            f"rcu_tpu_torch: the compute dtype is float32 or bfloat16")
    kwargs["dtype"] = _DTYPES[kwargs.get("dtype")]
    if model_type == "postnet" and not kwargs.get("in_channels"):
        raise ValueError("postnet needs in_channels > 0 (flax infers it; take "
                         "it from the checkpoint's first kernel)")
    return _BUILD[model_type](**kwargs)
