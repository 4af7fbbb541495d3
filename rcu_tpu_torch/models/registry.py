"""String -> model registry, the config surface of ``rcu_tpu.models.registry``
(``model: {unet: {...}}``, ``model: {postnet: {...}}``)."""
from __future__ import annotations

from torch import nn

from rcu_tpu_torch.models.unet import PostNet, UNet

_KEYS = {"unet": {"nb_classes", "in_channels", "depth", "start_filters",
                  "dropout", "dropout_center", "sigma_out",
                  "provide_features"},
         "postnet": {"nb_classes", "in_channels", "nb_convs", "dropout"}}
_BUILD = {"unet": UNet, "postnet": PostNet}
# model.json records that the plain f32 port reproduces as they are
_NEUTRAL = {"residual": False, "bn": True, "dtype": (None, "float32"),
            "split_decoder_concat": False, "fused_upsample": False,
            "quant_scales": None, "quant_skip_levels": 0, "fold_bn": False}


def get_model(model_type: str, params: dict) -> nn.Module:
    """Build the port's model from a config/model.json node.

    Options of later slices (residual blocks, bf16, fast decoder, int8, BN
    fold, bn=False) raise ``NotImplementedError`` instead of being silently
    ignored. A PostNet needs ``in_channels``, which flax infers and a
    model.json may leave out (``eval.direct.load_model`` reads it from the
    checkpoint)."""
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
        neutral = _NEUTRAL[key]
        if value not in (neutral if isinstance(neutral, tuple) else (neutral,)):
            raise NotImplementedError(
                f"{model_type} {key}={value!r} is not ported to rcu_tpu_torch yet")
    if model_type == "postnet" and not kwargs.get("in_channels"):
        raise ValueError("postnet needs in_channels > 0 (flax infers it; take "
                         "it from the checkpoint's first kernel)")
    return _BUILD[model_type](**kwargs)
