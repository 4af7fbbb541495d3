"""Direct one-pass test+eval: checkpoint -> per-volume inference +
calibration/uncertainty eval -> the eval CSV families, with no NIfTI
artifacts in between (``rcu_tpu.eval.direct`` counterpart).

Ported: the six protocols of :data:`STRATEGIES`, which cover the paper's
eight strategies (baseline and center run ``deterministic``, their MC
variants ``mc``), on volume stores, one device, the flat CSV layout, in
float32 and in the inference variants of the JAX package: the bf16
compute dtype, the fast decoder, the BN fold (``models.unet``) and int8
PTQ of the mc, deterministic and ensemble protocols (``ops.quant``).
Native-2D datasets and meshes are later slices and raise
``NotImplementedError``.

:func:`evaluate_direct` detects the strategy as ``rcu_tpu.eval.direct`` does and
builds the dataset and the models from a test config and its checkpoints;
:func:`evaluate_subjects` is the core, and takes any dataset object with
``subjects``, ``read_volume``, ``shape`` and ``files``.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time

import numpy as np
import torch

from rcu_tpu_torch import directories as dirs
from rcu_tpu_torch.data import nifti
from rcu_tpu_torch.data.split import load_split
from rcu_tpu_torch.engine import checkpoint as ckpt_lib
from rcu_tpu_torch.engine import config as cfg_lib
from rcu_tpu_torch.engine import databuild
from rcu_tpu_torch.eval import hooks as ev_hooks
from rcu_tpu_torch.eval import pipeline
from rcu_tpu_torch.models import (FAST_DECODER_KWARGS, fold_bn_params,
                                  get_model, precast_params)
from rcu_tpu_torch.models.convert import state_dict_from_flax
from rcu_tpu_torch.ops import quant as quant_ops

DEFAULT_THRESHOLDS = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95)
STRATEGIES = ("mc", "deterministic", "aleatoric", "ensemble",
              "auxiliary_feat", "auxiliary_segm")
# result-id suffix and minmax confidence entry of each strategy family
_ID_SUFFIX = {"mc": "", "deterministic": "", "ensemble": "",
              "aleatoric": "_globalrescale",
              "auxiliary_feat": "_rescale", "auxiliary_segm": "_rescale"}
_CONFIDENCE_ENTRY = {"mc": "probabilities", "deterministic": "probabilities",
                     "ensemble": "probabilities", "aleatoric": "sigma",
                     "auxiliary_feat": "confidence",
                     "auxiliary_segm": "confidence"}
_ECE_COLUMNS = ("ece", "dice", "tp", "tn", "fp", "fn", "n")


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device; never a silent
    fallback to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "(CLI: -device cpu) to run on the CPU")
    return device


class _EvalSinks:
    """The run's CSV families in ``out_dir``: calibration bins, the ece_dice
    row and one correction CSV per threshold under the result id (the run
    id and the strategy's suffix), and the run minmax summary under the
    bare run id with the strategy's confidence entry."""

    def __init__(self, out_dir, run_id, thresholds, strategy):
        os.makedirs(out_dir, exist_ok=True)
        self.result_id = result_id = run_id + _ID_SUFFIX[strategy]
        self.confidence_entry = _CONFIDENCE_ENTRY[strategy]
        self.calib = ev_hooks.WriteCsvHook(os.path.join(
            out_dir, dirs.CALIBRATION_PLACEHOLDER.format(result_id)))
        self.ece = ev_hooks.WriteCsvHook(
            os.path.join(out_dir, dirs.ECE_PLACEHOLDER.format(result_id)),
            entries=_ECE_COLUMNS)
        self.corr = [ev_hooks.WriteCsvHook(os.path.join(
            out_dir, dirs.UNCERTAINTY_PLACEHOLDER.format(
                result_id, f"{threshold:.2f}".replace(".", ""))))
            for threshold in thresholds]
        self.minmax_path = os.path.join(
            out_dir, dirs.MINMAX_PLACEHOLDER.format(run_id))
        self.bounds = {"min": [], "max": []}
        self.nonfinite = []  # subjects with NaN/inf ECE; finish() raises

    def write_subject(self, subject, row):
        """``row``: the host (numpy) eval dict of one subject; its
        ``conf_min``/``conf_max``, where it has them, join the run bounds."""
        ece = float(row["ece"])
        if not np.isfinite(ece):
            # a constant confidence map (the subject rescale divides 0/0) or
            # an empty eval mask: write the row anyway, keep going, and fail
            # in finish() once every CSV is written
            self.nonfinite.append(subject)
            logging.error("subject '%s': non-finite ECE (%s), finish() will "
                          "raise", subject, ece)
        corr = row["correction"]
        self.calib.on_subject({
            "bins_count": row["bins_count"].astype(np.int64),
            "bins_avg_confidence": row["bins_avg_confidence"],
            "bins_positive_fraction": row["bins_positive_fraction"],
            "bins_non_zero": row["bins_non_zero"],
            "ece": ece,
            "dice": float(row["dice"]),
        }, subject, self.result_id)
        self.ece.on_subject({k: ev_hooks.csv_value(k, row[k])
                             for k in _ECE_COLUMNS}, subject, self.result_id)
        for ti, hook in enumerate(self.corr):
            hook.on_subject({k: ev_hooks.csv_value(k, corr[k][ti])
                             for k in ev_hooks.CORRECTION_KEYS}, subject,
                            self.result_id)
        if "conf_min" in row:
            self.add_bounds(row["conf_min"], row["conf_max"])

    def add_bounds(self, mn, mx):
        self.bounds["min"].append(float(mn))
        self.bounds["max"].append(float(mx))

    def finish(self):
        for hook in (self.calib, self.ece, *self.corr):
            hook.on_run_end(self.result_id)
        if self.bounds["min"]:
            ev_hooks.write_summary_csv(self.minmax_path, self.bounds,
                                       self.confidence_entry)
        if self.nonfinite:
            raise ValueError(
                f"{len(self.nonfinite)} subject(s) produced a non-finite ECE: "
                f"{', '.join(self.nonfinite[:5])} — either the confidence map "
                "was constant (the subject min-max rescale divides 0/0) or "
                "the subject's eval mask selected zero voxels. Every CSV was "
                "still written (NaN rows mark the affected subjects).")


def _global_bounds(bounds):
    """The run's sigma (min, max); a constant range raises, since the
    global rescale would divide 0/0 into every cell."""
    gmin, gmax = min(bounds["min"]), max(bounds["max"])
    if not gmax > gmin:
        raise ValueError(
            f"degenerate sigma range [{gmin}, {gmax}] across the run — the "
            "sigma head produced a constant map; the global-rescale protocol "
            "cannot evaluate it")
    return gmin, gmax


def model_from_flax(model_type: str, record: dict, params: dict,
                    batch_stats: dict, device, dtype: str = None,
                    fast_decoder: bool = False, fold_bn: bool = False):
    """The port's model of a model.json ``record`` with the weights of a
    flax tree, on ``device``, in the variant that the options ask for
    (``rcu_tpu.eval.direct._load_model_state``): ``dtype`` the compute
    dtype (``"bfloat16"``; the weights stay f32 in the tree),
    ``fast_decoder`` the decoder rewrites (U-Nets only), ``fold_bn`` the
    BatchNorms folded into the convs in numpy f32 before the conversion.
    The conv weights are then cast once to the compute dtype and, where
    the record has ``quant_scales``, the int8 sites' weights quantized
    from the cast ones (``precast_params``)."""
    record = dict(record)
    if dtype:
        record["dtype"] = dtype
    if fast_decoder and model_type == "unet":
        record.update(FAST_DECODER_KWARGS)
    if fold_bn:
        params, batch_stats = fold_bn_params(params, batch_stats)
        record["fold_bn"] = True
    model = get_model(model_type, record)
    model.load_state_dict(state_dict_from_flax(params, batch_stats))
    return precast_params(model).to(device)


def load_model(model_dir: str, test_at, device,
               provide_features: bool = False, **variant) -> torch.nn.Module:
    """The checkpoint's model (U-Net or PostNet) with its weights, on
    ``device``, in the variant of :func:`model_from_flax` (``dtype``,
    ``fast_decoder``, ``fold_bn``). A PostNet whose model.json records no
    ``in_channels`` (flax infers it) takes it from its first kernel."""
    mf = ckpt_lib.ModelFiles.from_model_dir(model_dir)
    model_node, _ = ckpt_lib.load_model_parameters(mf)
    path = ckpt_lib.find_checkpoint_file(mf, test_at)
    if path is None:
        raise FileNotFoundError(f"no checkpoint '{test_at}' in {model_dir}")
    raw = ckpt_lib.load_checkpoint(path)
    params = dict(model_node.params)
    if provide_features:
        params["provide_features"] = True
    if model_node.type == "postnet" and not params.get("in_channels"):
        params["in_channels"] = int(
            raw["params"]["ConvBnRelu_0"]["Conv_0"]["kernel"].shape[2])
    return model_from_flax(model_node.type, params, raw["params"],
                           raw["batch_stats"], device, **variant)


def _primary_test_at(config):
    return "best" if config.test_at in (None, "") else config.test_at


def _centre_batch(dataset, subject, batch_size, dtype, device):
    """The centre ``min(len, batch_size)`` slices of a subject (BraTS edge
    slices are often empty and would under-estimate every site's range),
    NHWC in ``dtype`` on ``device``."""
    volume = np.asarray(dataset.read_volume(subject, "images"), np.float32)
    n = min(len(volume), max(1, batch_size))
    lo = max(0, (len(volume) - n) // 2)
    return torch.from_numpy(volume[lo:lo + n]).to(dtype).to(device)


def _seeded_generator(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _calibrated_quant_model(models, dataset, batch_size: int, seed: int,
                            ensemble: bool = False, skip_levels=None):
    """Make ``models`` (one U-Net, or with ``ensemble`` the list of
    members) the int8 models of a direct run, in place, and return them
    (``rcu_tpu.eval.direct._calibrated_quant_model``).

    The calibration batch is the centre slices of the first subject,
    through the plain model as loaded (dtype, decoder, fold). One model
    calibrates under one dropout sample drawn from a generator seeded with
    ``seed`` (a folded model deterministically); the ensemble
    union-calibrates: each member runs its own deterministic pass, the
    scales merge by max, and every member keeps its own int8 weights.
    ``skip_levels`` (None: ``ops.quant.DEFAULT_SKIP_LEVELS``) is clamped to
    the model's levels. With ``RCU_QUANT_CLIP_DEBUG`` set, the quantized
    model (member 0) runs the centre slices of the last subject and logs
    every site's clipped fraction, as a warning above 0.001."""
    members = list(models) if ensemble else [models]
    first = members[0]
    device = next(first.parameters()).device
    subjects = dataset.subjects
    batch = _centre_batch(dataset, subjects[0], batch_size, first.dtype,
                          device)
    if ensemble:
        scales = {}
        for member in members:
            member_scales = quant_ops.calibrate_scales(member, [batch],
                                                       mc_dropout=False)
            if scales and set(member_scales) != set(scales):
                raise ValueError(
                    "ensemble members sowed different quant sites — the "
                    "stacked members must share one architecture")
            for key, val in member_scales.items():
                scales[key] = max(scales.get(key, 0.0), val)
        logging.info("int8 union calibration: %d conv sites over %d members "
                     "from subject '%s' (%d items)", len(scales),
                     len(members), subjects[0], len(batch))
    else:
        scales = quant_ops.calibrate_scales(
            first, [batch], [_seeded_generator(seed, device)],
            mc_dropout=not first.fold_bn)
        logging.info("int8 calibration: %d conv sites from subject '%s' "
                     "(%d items)", len(scales), subjects[0], len(batch))
    skip_levels = quant_ops.clamp_skip_levels(first, skip_levels)
    for member in members:
        member.quantize(scales, skip_levels)
    if os.environ.get("RCU_QUANT_CLIP_DEBUG"):
        _clip_debug(first, dataset, batch_size, seed, ensemble, skip_levels)
    return members if ensemble else first


def _clip_debug(model, dataset, batch_size, seed, ensemble, skip_levels):
    """The clip report of the quantized ``model`` on the centre slices of
    the last subject, one the calibration never saw where there are two."""
    if skip_levels > model.depth:
        logging.info("int8 clip report skipped: quantize_skip=%d covers all "
                     "%d levels, no quantized sites", skip_levels,
                     model.depth + 1)
        return
    subjects = dataset.subjects
    if subjects[0] == subjects[-1]:
        logging.warning(
            "int8 clip report: dataset too small to hold out a "
            "never-calibrated subject — the probe batch overlaps the "
            "calibration batch and measures no distribution shift")
    device = next(model.parameters()).device
    shift = _centre_batch(dataset, subjects[-1], batch_size, model.dtype,
                          device)
    report = quant_ops.clip_report(
        model, [shift], mc_dropout=not ensemble and not model.fold_bn,
        generators=[_seeded_generator(seed + 1, device)])
    worst = sorted(report.items(), key=lambda kv: -kv[1])[:5]
    log = logging.warning if worst and worst[0][1] > 0.001 else logging.info
    log("int8 clip report (%d subject(s) '%s'%s): worst sites %s", 1,
        subjects[-1], " member 0" if ensemble else "",
        ", ".join(f"{k}={v:.2e}" for k, v in worst))


def _load_ensemble(config, device, variant) -> list:
    """The primary model (``model_dir`` at ``test_at``) first, then the
    ``others.model_dir`` members at ``others.test_at``."""
    model_dirs = config.others.get("model_dir")
    if isinstance(model_dirs, str):
        model_dirs = [model_dirs]
    if not model_dirs or "test_at" not in config.others:
        raise ValueError('missing "model_dir" or "test_at" entry in the '
                         'configuration (others): fill others.model_dir with '
                         'the trained member model dirs')
    member_at = config.others["test_at"]
    all_dirs = ([(config.model_dir, _primary_test_at(config))]
                if config.model_dir else []) \
        + [(d, member_at) for d in model_dirs]
    members = []
    for i, (model_dir, at) in enumerate(all_dirs):
        logging.info("load ensemble model [%d/%d] %s", i + 1, len(all_dirs),
                     os.path.basename(model_dir))
        members.append(load_model(model_dir, at, device, **variant))
    return members


def _load_aux_feat(config, device, variant) -> tuple:
    """(the frozen segmenter of ``others.model_dir``, giving its features;
    the PostNet of ``model_dir``)."""
    if not isinstance(config.others.get("model_dir"), str) \
            or "test_at" not in config.others:
        raise ValueError(
            'missing "model_dir" or "test_at" entry in the configuration '
            "(others): auxiliary_feat needs others.model_dir pointing at the "
            "trained frozen-segmenter dir and others.test_at naming its "
            "checkpoint")
    if not config.model_dir:
        raise ValueError(
            "auxiliary_feat needs config.model_dir pointing at the trained "
            "confidence net (PostNet) dir — others.model_dir names only the "
            "frozen segmenter")
    segmenter = load_model(config.others["model_dir"],
                           config.others["test_at"], device,
                           provide_features=True, **variant)
    return segmenter, load_model(config.model_dir, _primary_test_at(config),
                                 device, **variant)


def _load_models(config, strategy: str, device, variant: dict):
    """What :func:`evaluate_subjects` takes for ``strategy``: the members
    (ensemble), the (segmenter, PostNet) pair (auxiliary_feat), else the
    one model of ``model_dir``; every model in ``variant``
    (:func:`model_from_flax`'s options)."""
    if strategy == "ensemble":
        return _load_ensemble(config, device, variant)
    if strategy == "auxiliary_feat":
        return _load_aux_feat(config, device, variant)
    return load_model(config.model_dir, _primary_test_at(config), device,
                      **variant)


def foreground_mask(dataset, subject, shape) -> np.ndarray:
    """BraTS t2>0 head-support mask from the RAW t2 NIfTI recorded in the
    store's files metadata (the stored channels are z-scored, so
    thresholding them would select above-mean voxels)."""
    t2_path = (dataset.files(subject) or {}).get("images", {}).get("t2")
    if not t2_path or not os.path.exists(t2_path):
        raise ValueError(
            f"subject '{subject}' has no raw t2 source file recorded in the "
            "store, so the foreground mask cannot be derived. Pass "
            "masked=False to evaluate unmasked.")
    arr, _ = nifti.read(t2_path)
    fg = np.squeeze(np.asarray(arr)) > 0
    if fg.shape != tuple(shape):
        raise ValueError(
            f"subject '{subject}': raw-t2 mask shape {fg.shape} does not "
            f"match the target shape {tuple(shape)}")
    return fg


def _detect_strategy(config, dataset, strategy):
    """Explicit ``strategy`` wins; otherwise, in ``rcu_tpu.eval.direct``'s order:
    sigma head -> aleatoric, others.model_dir list -> ensemble,
    others.model_dir str -> auxiliary_feat (the frozen segmenter),
    2-channel labels -> auxiliary_segm, else mc."""
    if strategy is not None:
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy '{strategy}'; "
                             f"choose one of {STRATEGIES}")
        return strategy
    if config.model_dir:
        mf = ckpt_lib.ModelFiles.from_model_dir(config.model_dir)
        model_node, _ = ckpt_lib.load_model_parameters(mf)
        if model_node.params.get("sigma_out"):
            return "aleatoric"
    member_dirs = config.others.get("model_dir")
    if isinstance(member_dirs, (list, tuple)):
        return "ensemble"
    if isinstance(member_dirs, str):
        logging.warning(
            "others.model_dir is a string (%s) -> inferring strategy "
            "'auxiliary_feat' (frozen-segmenter confidence protocol). If it "
            "is a single ensemble member, pass strategy='ensemble' "
            "explicitly.", member_dirs)
        return "auxiliary_feat"
    labels_shape = tuple(dataset.shape(dataset.subjects[0], "labels"))
    if len(labels_shape) >= 3 and labels_shape[-1] == 2:
        return "auxiliary_segm"
    return "mc"


def evaluate_direct(config, out_dir: str, run_id: str = "baseline",
                    mc: int = None, thresholds=DEFAULT_THRESHOLDS,
                    masked: bool = True, strategy: str = None,
                    device=None, dtype: str = None,
                    fast_decoder: bool = False, fold_bn: bool = False,
                    quantize: bool = False,
                    quantize_skip_levels: int = None) -> dict:
    """Fused inference + eval for every test-split subject of ``config``;
    writes the ``eval_calibration_*``, ``eval_ece_*``,
    ``eval_uncertainty_*_th*`` and ``eval_summary_minmax_*`` CSVs into
    ``out_dir`` and returns the per-subject ECE dict.

    ``strategy`` is one of :data:`STRATEGIES`, detected from the checkpoint
    and the config by default (:func:`_detect_strategy`). ``mc`` counts
    the MC-dropout samples of the ``mc`` strategy (default ``others.mc`` or
    20; ``mc=0`` is the deterministic protocol). ``masked`` applies the
    BraTS t2>0 foreground mask to the ECE bins. Runs on ``cuda`` unless
    ``device`` says otherwise.

    ``dtype='bfloat16'`` (the JAX package's production configuration),
    ``fast_decoder`` and ``fold_bn`` load every model of the run in that
    variant (:func:`model_from_flax`); ``fold_bn`` covers the
    deterministic single-forward protocols, not ``mc``, and raises
    ``ValueError`` there. ``quantize=True`` (``mc``, ``deterministic`` and
    ``ensemble``; ``ValueError`` for the other families) runs the trunk
    convs in int8 after a one-batch calibration
    (:func:`_calibrated_quant_model`); ``quantize_skip_levels`` keeps the
    N finest resolution levels in the compute dtype (None:
    ``ops.quant.DEFAULT_SKIP_LEVELS``). By
    default the models run in full float32, held to the f32 parity bar:
    :func:`evaluate_subjects` switches TF32 off for its work and restores
    the caller's setting."""
    device = resolve_device(device)
    if mc is None:
        cfg_mc = config.others.get("mc")
        mc = 20 if cfg_mc is None else int(cfg_mc)
    subjects = None
    if config.split:
        _, _, subjects = load_split(config.split, config.others.get("split_k"))
        if not subjects:
            raise ValueError(f"no test subjects: split {config.split!r} has "
                             "an empty test set")
    databuild.build_transform(config.test_data.transform)
    dataset = databuild.build_data(config.test_data, subjects=subjects)
    try:
        if len(dataset.shape(dataset.subjects[0], "images")) != 4:
            raise NotImplementedError("native-2D datasets are not ported yet")
        strategy = _detect_strategy(config, dataset, strategy)
        if fold_bn and strategy == "mc" and int(mc) != 0:
            raise ValueError(
                "fold_bn covers the deterministic single-forward protocols "
                "(deterministic/ensemble/aleatoric/auxiliary_*); the mc "
                "protocol samples dropout, which the load-time BN fold "
                "cannot commute with")
        if quantize and strategy not in ("mc", "deterministic", "ensemble"):
            raise ValueError(
                "quantize=True covers the mc/deterministic/ensemble "
                f"protocols; strategy '{strategy}' keeps the f32/bf16 paths")
        models = _load_models(config, strategy, device, dict(
            dtype=dtype, fast_decoder=fast_decoder, fold_bn=fold_bn))
        if quantize:
            models = _calibrated_quant_model(
                models, dataset, config.test_data.batch_size, config.seed,
                ensemble=strategy == "ensemble",
                skip_levels=quantize_skip_levels)
        is_log_sigma = cfg_lib.require_log_sigma(config) \
            if strategy == "aleatoric" else False
        return evaluate_subjects(models, dataset, out_dir, strategy=strategy,
                                 run_id=run_id, mc=int(mc),
                                 is_log_sigma=is_log_sigma,
                                 batch_size=config.test_data.batch_size,
                                 seed=config.seed, thresholds=thresholds,
                                 masked=masked, device=device)
    finally:
        dataset.close()


@contextlib.contextmanager
def _full_float32():
    """cuDNN and matmul TF32 off within the block; the caller's flags come
    back afterwards, also on error."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.cpu().numpy()


def _check_models(strategy, models):
    """Raise where ``models`` is not what ``strategy`` runs."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy '{strategy}'; "
                         f"choose one of {STRATEGIES}")
    if strategy == "ensemble":
        if isinstance(models, torch.nn.Module) or not models:
            raise TypeError("ensemble takes a non-empty list of members")
    elif strategy == "auxiliary_feat":
        if isinstance(models, torch.nn.Module) or len(models) != 2 \
                or not getattr(models[0], "provide_features", False):
            raise TypeError("auxiliary_feat takes a (segmenter with "
                            "provide_features, PostNet) pair")
    elif not isinstance(models, torch.nn.Module):
        raise TypeError(f"{strategy} takes one model")
    elif strategy == "aleatoric" and not getattr(models, "sigma_out", False):
        raise ValueError("strategy 'aleatoric' needs a sigma-headed model")


def _input_dtype(strategy, models) -> torch.dtype:
    """The dtype the images travel in: the compute dtype of the models that
    read them where they share one, else float32. A model's first op casts
    its input to its compute dtype, so casting on the host first is the
    same rounding and halves the bytes of the host-to-device copy under
    bf16."""
    readers = models if strategy == "ensemble" else \
        models[:1] if strategy == "auxiliary_feat" else [models]
    dtypes = {getattr(m, "dtype", torch.float32) for m in readers}
    return dtypes.pop() if len(dtypes) == 1 else torch.float32


def _read_images(dataset, subject, device, dtype=torch.float32):
    volume = np.asarray(dataset.read_volume(subject, "images"), np.float32)
    if volume.ndim != 4:
        raise NotImplementedError("native-2D datasets are not ported yet")
    return torch.from_numpy(volume).to(dtype).to(device)


def _split_labels(labels, needs_baseline: bool):
    """-> (target bool, baseline uint8 or None). auxiliary_segm labels carry
    [gt, baseline prediction] on the trailing axis; otherwise a trailing
    channel axis drops to the gt channel."""
    labels = np.asarray(labels)
    if needs_baseline:
        if labels.shape[-1] != 2:
            raise ValueError("auxiliary_segm needs [gt, prediction] 2-channel "
                             f"labels; got label shape {labels.shape}")
        return labels[..., 0] > 0.5, (labels[..., 1] > 0.5).astype(np.uint8)
    if labels.ndim > 3:
        labels = labels[..., 0]
    return labels > 0.5, None


def evaluate_subjects(models, dataset, out_dir: str, *, strategy: str = "mc",
                      run_id: str = "baseline", mc: int = 20,
                      is_log_sigma: bool = False, batch_size: int = 32,
                      seed: int = 20, thresholds=DEFAULT_THRESHOLDS,
                      masked: bool = True, device=None) -> dict:
    """The direct eval's core over ``dataset.subjects`` (see module doc).

    ``models``: one model for mc, deterministic, aleatoric (sigma head)
    and auxiliary_segm (5 input channels); the list of members for
    ensemble; the (segmenter with ``provide_features``, PostNet) pair for
    auxiliary_feat; in float32 or any variant (``model_from_flax``). The
    volumes are cast to the models' compute dtype on the host. ``mc=0``
    runs the mc strategy as deterministic, and subject ``i``'s MC stream
    is ``(seed, i)`` (``eval.pipeline``). aleatoric runs two passes: the
    subjects' sigma bounds, then the eval with the run's global bounds (a
    constant range raises in between).

    The f32 models and the f32 heads of the others are held to the f32
    bar, so cuDNN and matmul TF32 are off while they run (torch's default
    lets cuDNN use TF32, which misses that bar); the caller's flags are
    restored afterwards, also on error."""
    _check_models(strategy, models)
    device = resolve_device(device)
    dtype = _input_dtype(strategy, models)
    with _full_float32():
        sinks = _EvalSinks(out_dir, run_id, thresholds, strategy)
        bounds = None
        if strategy == "aleatoric":
            for subject in dataset.subjects:
                sinks.add_bounds(*pipeline.volume_sigma_minmax(
                    models, batch_size,
                    _read_images(dataset, subject, device, dtype),
                    is_log_sigma))
            bounds = _global_bounds(sinks.bounds)
            logging.info("direct aleatoric: global sigma range [%.6f, %.6f]",
                         *bounds)
        eces = {}
        for si, subject in enumerate(dataset.subjects):
            t0 = time.time()
            volume = _read_images(dataset, subject, device, dtype)
            target, baseline = _split_labels(
                dataset.read_volume(subject, "labels"),
                strategy == "auxiliary_segm")
            mask = foreground_mask(dataset, subject, target.shape) if masked \
                else np.ones(target.shape, bool)
            target = torch.from_numpy(target).to(device)
            mask = torch.from_numpy(mask).to(device)
            common = (target, mask, thresholds)
            if strategy in ("mc", "deterministic"):
                out = pipeline.volume_mc_eval(
                    models, mc if strategy == "mc" else 0, batch_size, volume,
                    *common, rng=(seed, si))
            elif strategy == "aleatoric":
                out = pipeline.volume_aleatoric_eval(
                    models, batch_size, volume, *common, *bounds, is_log_sigma)
            elif strategy == "ensemble":
                out = pipeline.volume_ensemble_eval(models, batch_size, volume,
                                                    *common)
            elif strategy == "auxiliary_feat":
                out = pipeline.volume_aux_feat_eval(*models, batch_size,
                                                    volume, *common)
            else:
                out = pipeline.volume_aux_segm_eval(
                    models, batch_size, volume,
                    torch.from_numpy(baseline).to(device), *common)
            row = _to_host(out)
            sinks.write_subject(subject, row)
            eces[subject] = float(row["ece"])
            logging.info("direct eval %s ece=%.5f (%.2fs)", subject,
                         eces[subject], time.time() - t0)
        sinks.finish()
        return eces
