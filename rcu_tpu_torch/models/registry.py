"""String -> model registry, the config surface of ``rcu_tpu.models.registry``
(``model: {unet: {...}}``)."""
from __future__ import annotations

from rcu_tpu_torch.models.unet import UNet

_UNET_KEYS = {"nb_classes", "in_channels", "depth", "start_filters", "dropout",
              "dropout_center"}
# model.json records that the plain f32 port reproduces as they are
_NEUTRAL = {"residual": False, "sigma_out": False, "provide_features": False,
            "bn": True, "dtype": (None, "float32"),
            "split_decoder_concat": False, "fused_upsample": False,
            "quant_scales": None, "quant_skip_levels": 0, "fold_bn": False}


def get_model(model_type: str, params: dict) -> UNet:
    """Build the port's model from a config/model.json node.

    Options of later slices (residual blocks, sigma head, features, bf16,
    fast decoder, int8, BN fold, bn=False) raise ``NotImplementedError``
    instead of being silently ignored."""
    if model_type != "unet":
        raise NotImplementedError(
            f'model type "{model_type}" is not ported to rcu_tpu_torch yet')
    kwargs = {}
    for key, value in params.items():
        if key in _UNET_KEYS:
            kwargs[key] = value
            continue
        if key not in _NEUTRAL:
            raise ValueError(f'unknown unet param "{key}"')
        neutral = _NEUTRAL[key]
        if value not in (neutral if isinstance(neutral, tuple) else (neutral,)):
            raise NotImplementedError(
                f"unet {key}={value!r} is not ported to rcu_tpu_torch yet")
    return UNet(**kwargs)
