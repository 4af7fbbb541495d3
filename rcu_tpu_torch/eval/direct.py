"""Direct one-pass test+eval: checkpoint -> per-volume inference +
calibration/uncertainty eval -> the eval CSV families, with no NIfTI
artifacts in between (``rcu_tpu.eval.direct`` counterpart).

Ported: the six protocols of :data:`STRATEGIES`, which cover the paper's
eight strategies (baseline and center run ``deterministic``, their MC
variants ``mc``), on volume stores (BraTS) and native-2D datasets (ISIC
image folders, 2-D H5 stores), with the config's transforms, one device,
the flat CSV layout, in float32 and in the inference variants of the JAX
package: the bf16 compute dtype, the fast decoder, the BN fold
(``models.unet``) and int8 PTQ of the mc, deterministic and ensemble
protocols (``ops.quant``), on one device or on a mesh
(``parallel.Mesh``) in either of the JAX driver's two modes: latency
(each batch split over the mesh's data devices, an ensemble's members
over its model axis) and throughput (``subject_parallel``: whole
subjects, or native-2D chunk parts, round-robin onto the devices, each
with its own copy of the models). The JAX driver's ``dispatch_chunks``
is not ported: it amortizes the round trip of a remote TPU link over
several chunks a dispatch, and a local card has no such round trip.

:func:`evaluate_direct` detects the strategy as ``rcu_tpu.eval.direct`` does and
builds the dataset and the models from a test config and its checkpoints;
:func:`evaluate_subjects` is the core, and takes any dataset object with
``subjects``, ``read_volume``, ``shape`` and ``files``.
"""
from __future__ import annotations

import collections
import concurrent.futures
import functools
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
from rcu_tpu_torch.eval.device import (Fetch, full_float32,
                                       measured_conv_engines)
from rcu_tpu_torch.models import (FAST_DECODER_KWARGS, fold_bn_params,
                                  get_model, precast_params)
from rcu_tpu_torch.models.convert import state_dict_from_flax
from rcu_tpu_torch.ops import quant as quant_ops
from rcu_tpu_torch.parallel.mesh import pad_batch_size_to_mesh
from rcu_tpu_torch.utils import profiling

DEFAULT_THRESHOLDS = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95)
STRATEGIES = pipeline.STRATEGIES
# result-id suffix and minmax confidence entry of each strategy family
_ID_SUFFIX = {"mc": "", "deterministic": "", "ensemble": "",
              "aleatoric": "_globalrescale",
              "auxiliary_feat": "_rescale", "auxiliary_segm": "_rescale"}
_CONFIDENCE_ENTRY = {"mc": "probabilities", "deterministic": "probabilities",
                     "ensemble": "probabilities", "aleatoric": "sigma",
                     "auxiliary_feat": "confidence",
                     "auxiliary_segm": "confidence"}
_ECE_COLUMNS = ("ece", "dice", "tp", "tn", "fp", "fn", "n")
LAYOUTS = ("flat", "eval_tree")


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device; never a silent
    fallback to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "(CLI: -device cpu) to run on the CPU")
    return device


class _EvalSinks:
    """The run's CSV families: calibration bins, the ece_dice row and one
    correction CSV per threshold under the result id (the run id and the
    strategy's suffix), and the run minmax summary under the bare run id
    with the strategy's confidence entry.

    ``layout='flat'`` writes every file into ``out_dir``;
    ``layout='eval_tree'`` writes the staged eval engine's tree under it
    (``calibration/``, ``ece_foreground/`` (``masked``) or ``ece/``,
    ``uncertainty/``, ``minmax/``), so that the staged and the direct
    output compare file by file and the analysis layer reads either."""

    def __init__(self, out_dir, run_id, thresholds, strategy,
                 layout: str = "flat", masked: bool = True):
        if layout not in LAYOUTS:
            raise ValueError(f"unknown layout '{layout}'; choose one of "
                             f"{LAYOUTS}")

        def sub(name):
            d = out_dir if layout == "flat" else os.path.join(out_dir, name)
            os.makedirs(d, exist_ok=True)
            return d

        self.run_id = run_id
        self.result_id = result_id = run_id + _ID_SUFFIX[strategy]
        self.confidence_entry = _CONFIDENCE_ENTRY[strategy]
        self.calib = ev_hooks.WriteBinsCsvHook(os.path.join(
            sub(dirs.CALIB_NAME), dirs.CALIBRATION_PLACEHOLDER.format(result_id)))
        ece_dir = sub(dirs.ECE_FOREGROUND_NAME if masked else dirs.ECE_NAME)
        self.ece = ev_hooks.WriteCsvHook(
            os.path.join(ece_dir, dirs.ECE_PLACEHOLDER.format(result_id)),
            entries=_ECE_COLUMNS)
        corr_dir = sub(dirs.UNCERTAINTY_NAME)
        self.corr = [ev_hooks.WriteCsvHook(os.path.join(
            corr_dir, dirs.UNCERTAINTY_PLACEHOLDER.format(
                result_id, f"{threshold:.2f}".replace(".", ""))))
            for threshold in thresholds]
        self.minmax = ev_hooks.WriteSummaryCsvHook(
            os.path.join(sub(dirs.MINMAX_NAME),
                         dirs.MINMAX_PLACEHOLDER.format(run_id)),
            confidence_entry=self.confidence_entry)
        self.bounds = {"min": [], "max": []}
        self.nonfinite = []  # subjects with NaN/inf ECE; finish() raises

    def write_subject(self, subject, row):
        """``row``: the host (numpy) eval dict of one subject; its
        ``conf_min``/``conf_max``, where it has them, join the run bounds."""
        with profiling.span("direct.sink"):
            self._write(subject, row)

    def _write(self, subject, row):
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
        with profiling.span("direct.sink"):
            self._finish()

    def _finish(self):
        for hook in (self.calib, self.ece, *self.corr):
            hook.on_run_end({}, self.result_id)
        if self.bounds["min"]:
            self.minmax.on_run_end(self.bounds, self.run_id)
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


def _transformed_image(transform, image):
    """One image or slice (H, W, C) through the config's transform, as
    float32. Only the images entry goes in: a calibration or sigma-bounds
    batch needs no labels (the JAX package passes zero labels there, which
    a transform that rescales the labels refuses as constant)."""
    image = np.asarray(image, np.float32)
    if transform is None:
        return image
    return np.asarray(transform({"images": image})["images"], np.float32)


def _calibration_images(dataset, subjects, batch_size, transform):
    """The int8 calibration (and clip report) batch, float32 (N, H, W, C)
    on the host, each image or slice through the transform, and whether
    the dataset is native-2D: on a native-2D dataset the images of
    ``subjects``, on a volume store the centre ``min(len, batch_size)``
    slices of ``subjects[0]`` (BraTS edge slices are often empty and would
    under-estimate every site's range)."""
    first = np.asarray(dataset.read_volume(subjects[0], "images"), np.float32)
    if first.ndim == 3:
        images = [first] + [dataset.read_volume(s, "images")
                            for s in subjects[1:]]
        return np.stack([_transformed_image(transform, image)
                         for image in images]), True
    n = min(len(first), max(1, batch_size))
    lo = max(0, (len(first) - n) // 2)
    return np.stack([_transformed_image(transform, z)
                     for z in first[lo:lo + n]]), False


def _seeded_generator(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _calibrated_quant_model(models, dataset, batch_size: int, seed: int,
                            ensemble: bool = False, skip_levels=None,
                            transform=None):
    """Make ``models`` (one U-Net, or with ``ensemble`` the list of
    members) the int8 models of a direct run, in place, and return them
    (``rcu_tpu.eval.direct._calibrated_quant_model``).

    The calibration batch (:func:`_calibration_images`, through the
    config's ``transform``) is the centre slices of the first subject, or
    on a native-2D dataset its first ``batch_size`` images, through the
    plain model as loaded (dtype, decoder, fold), through
    ``ops.quant.calibrate_and_quantize``. One model calibrates under one
    dropout sample drawn from a generator seeded with ``seed`` (a folded
    model deterministically); the ensemble union-calibrates: each member
    runs its own deterministic pass, the scales merge by max, and every
    member keeps its own int8 weights. ``skip_levels`` (None:
    ``ops.quant.DEFAULT_SKIP_LEVELS``) is clamped to the model's levels.
    With ``RCU_QUANT_CLIP_DEBUG`` set, the quantized model (member 0) runs
    a batch the calibration did not see (:func:`_clip_debug`) and logs
    every site's clipped fraction, as a warning above 0.001."""
    members = list(models) if ensemble else [models]
    first = members[0]
    device = next(first.parameters()).device
    subjects = dataset.subjects
    batch, is_2d = _calibration_images(dataset, subjects[:max(1, batch_size)],
                                       batch_size, transform)
    batch = torch.from_numpy(batch).to(first.dtype).to(device)
    scales, skip_levels = quant_ops.calibrate_and_quantize(
        members, batch, None if ensemble or first.fold_bn else seed,
        skip_levels)
    if ensemble:
        logging.info("int8 union calibration: %d conv sites over %d members "
                     "from subject '%s' (%d items)", len(scales),
                     len(members), subjects[0], len(batch))
    else:
        logging.info("int8 calibration: %d conv sites from subject '%s' "
                     "(%d items)", len(scales), subjects[0], len(batch))
    if os.environ.get("RCU_QUANT_CLIP_DEBUG"):
        _clip_debug(first, dataset, batch_size, seed, ensemble, skip_levels,
                    transform, is_2d)
    return members if ensemble else first


def _clip_debug(model, dataset, batch_size, seed, ensemble, skip_levels,
                transform=None, is_2d=False):
    """The clip report of the quantized ``model`` on a batch that the
    calibration did not see where the dataset holds one: the centre slices
    of the last subject, or on a native-2D dataset the last
    ``batch_size`` images after the calibration's."""
    if skip_levels > model.depth:
        logging.info("int8 clip report skipped: quantize_skip=%d covers all "
                     "%d levels, no quantized sites", skip_levels,
                     model.depth + 1)
        return
    subjects = dataset.subjects
    k = max(1, batch_size)
    if is_2d:
        probe = subjects[k:][-k:] or subjects[:k]
        seen = probe[0] in subjects[:k]
    else:
        probe = [subjects[-1]]
        seen = subjects[0] == subjects[-1]
    if seen:
        logging.warning(
            "int8 clip report: dataset too small to hold out a "
            "never-calibrated subject — the probe batch overlaps the "
            "calibration batch and measures no distribution shift")
    device = next(model.parameters()).device
    shift = torch.from_numpy(_calibration_images(
        dataset, probe, batch_size, transform)[0]).to(model.dtype).to(device)
    report = quant_ops.clip_report(
        model, [shift], mc_dropout=not ensemble and not model.fold_bn,
        generators=[_seeded_generator(seed + 1, device)])
    worst = sorted(report.items(), key=lambda kv: -kv[1])[:5]
    log = logging.warning if worst and worst[0][1] > 0.001 else logging.info
    span = probe[0] if len(probe) == 1 else f"{probe[0]}..{probe[-1]}"
    log("int8 clip report (%d subject(s) '%s'%s): worst sites %s",
        len(probe), span, " member 0" if ensemble else "",
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
        return _family(strategy).name
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


def _family(strategy) -> pipeline.Family:
    """The family table's record of ``strategy``; an unknown name
    raises."""
    if strategy not in pipeline.FAMILIES:
        raise ValueError(f"unknown strategy '{strategy}'; "
                         f"choose one of {STRATEGIES}")
    return pipeline.FAMILIES[strategy]


def evaluate_direct(config, out_dir: str, run_id: str = "baseline",
                    mc: int = None, thresholds=DEFAULT_THRESHOLDS,
                    masked: bool = True, strategy: str = None,
                    device=None, dtype: str = None,
                    fast_decoder: bool = False, fold_bn: bool = False,
                    quantize: bool = False,
                    quantize_skip_levels: int = None,
                    layout: str = "flat", mesh=None,
                    subject_parallel: bool = False) -> dict:
    """Fused inference + eval for every test-split subject of ``config``;
    writes the ``eval_calibration_*``, ``eval_ece_*``,
    ``eval_uncertainty_*_th*`` and ``eval_summary_minmax_*`` CSVs into
    ``out_dir`` (``layout='eval_tree'``: the staged eval engine's tree,
    see :class:`_EvalSinks`) and returns the per-subject ECE dict.

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
    the caller's setting.

    ``mesh`` runs on a ``parallel.Mesh`` (the models load, and int8
    calibrates, on its first device, then go to the others) in latency
    mode, or with ``subject_parallel`` in throughput mode (see
    :func:`evaluate_subjects`); the CSVs are the single device's."""
    device = run_device(device, mesh)
    if mc is None:
        cfg_mc = config.others.get("mc")
        mc = 20 if cfg_mc is None else int(cfg_mc)
    subjects = None
    if config.split:
        _, _, subjects = load_split(config.split, config.others.get("split_k"))
        if not subjects:
            raise ValueError(f"no test subjects: split {config.split!r} has "
                             "an empty test set")
    # the staged test loop's source of an auxiliary_segm run's baseline
    # predictions on an image folder (the JAX direct eval reads none, so
    # there only an H5 store with [gt, baseline] labels runs that family)
    dataset = databuild.build_data(
        config.test_data, subjects=subjects,
        prediction_dir=config.others.get("prediction_dir")).dataset
    try:
        transform = databuild.build_transform(config.test_data.transform)
        strategy = _detect_strategy(config, dataset, strategy)
        family = _family(strategy)
        family.check_variant(int(mc), fold_bn, quantize)
        models = _load_models(config, strategy, device, dict(
            dtype=dtype, fast_decoder=fast_decoder, fold_bn=fold_bn))
        if quantize:
            models = _calibrated_quant_model(
                models, dataset, config.test_data.batch_size, config.seed,
                ensemble=strategy == "ensemble",
                skip_levels=quantize_skip_levels, transform=transform)
        is_log_sigma = cfg_lib.require_log_sigma(config) \
            if family.sigma else False
        return evaluate_subjects(models, dataset, out_dir, strategy=strategy,
                                 run_id=run_id, mc=int(mc),
                                 is_log_sigma=is_log_sigma,
                                 batch_size=config.test_data.batch_size,
                                 seed=config.seed, thresholds=thresholds,
                                 masked=masked, device=device,
                                 transform=transform, layout=layout,
                                 mesh=mesh, subject_parallel=subject_parallel)
    finally:
        dataset.close()


def run_device(device, mesh):
    """The run's device: ``device`` (default cuda), or on a mesh its first
    device (a ``device`` that names another raises)."""
    if mesh is None:
        return resolve_device(device)
    first = mesh.devices[0]
    if device is not None and torch.device(device).type != first.type:
        raise ValueError(f"device {device} is not the mesh's first device "
                         f"{first}")
    return resolve_device(first)


def _drive(pool, items, load_fn, dispatch_fn, fetch_fn, window: int = 2):
    """The direct eval's loop (``rcu_tpu.eval.direct._drive``): the pool's
    threads read ``window`` items ahead (``load_fn(i, item)``: decode,
    transform, cast, pin), the calling thread dispatches each item's
    device work (``dispatch_fn(i, item, loaded)``, which queues it and
    returns without waiting) and keeps up to ``window`` items in flight
    before it fetches the oldest (``fetch_fn(item, out, t0)``, which
    waits for that item's results only). Items finish in order. The
    loaded host tensors stay referenced until their item is fetched, so a
    pinned buffer outlives its non-blocking copy. The JAX package sizes
    its read-ahead as the pool's workers + 2 and clamps it to the window;
    with the one reader thread that is the window.

    Spans of item ``i`` (``utils.profiling``, while a profiler runs):
    ``direct.read`` on the reader thread, ``direct.wait_read`` for it
    here, ``direct.dispatch`` and ``direct.fetch``. ``t0`` is the item's
    start on the monotonic clock."""
    lookahead = max(1, window)
    futures = collections.deque(
        pool.submit(_read, load_fn, i, item) for i, item in
        enumerate(items[:lookahead]))
    pending = collections.deque()
    for i, item in enumerate(items):
        t0 = time.perf_counter()
        with profiling.span("direct.wait_read", i):
            loaded = futures.popleft().result()
        if i + lookahead < len(items):
            futures.append(pool.submit(_read, load_fn, i + lookahead,
                                       items[i + lookahead]))
        with profiling.span("direct.dispatch", i):
            out = dispatch_fn(i, item, loaded)
        pending.append((i, item, (loaded, out), t0))
        while len(pending) > window:
            _fetch(fetch_fn, *pending.popleft())
    while pending:
        _fetch(fetch_fn, *pending.popleft())


def _read(load_fn, i, item):
    with profiling.span("direct.read", i):
        return load_fn(i, item)


def _fetch(fetch_fn, i, item, loaded_out, t0):
    with profiling.span("direct.fetch", i):
        fetch_fn(item, loaded_out[1], t0)


def _result(out: Fetch) -> dict:
    """``out.result()``, the wait under the span ``direct.fetch_wait``."""
    with profiling.span("direct.fetch_wait"):
        return out.result()


def _split_labels(labels, needs_baseline: bool, is_2d: bool = False):
    """-> (target bool, baseline uint8 or None). auxiliary_segm labels carry
    [gt, baseline prediction] on the trailing axis; otherwise a channel
    axis past the spatial rank ((Z, H, W), native-2D (H, W)) drops to the
    gt channel."""
    labels = np.asarray(labels)
    if needs_baseline:
        if labels.shape[-1] != 2:
            raise ValueError("auxiliary_segm needs [gt, prediction] 2-channel "
                             f"labels; got label shape {labels.shape}")
        return labels[..., 0] > 0.5, (labels[..., 1] > 0.5).astype(np.uint8)
    if labels.ndim > (2 if is_2d else 3):
        labels = labels[..., 0]
    return labels > 0.5, None


class _Reader:
    """The host side of a run, on the reader threads: each item's images,
    labels and mask decoded, through the transform (per slice on a volume
    store), the images cast to the models' input dtype, every array a
    torch tensor in pinned memory when the run's device is a card. No CUDA
    stream is touched here: the dispatching thread makes the copies."""

    def __init__(self, dataset, transform, needs_baseline, masked, dtype,
                 device, is_2d):
        self.dataset, self.transform = dataset, transform
        self.needs_baseline = needs_baseline
        self.masked, self.dtype, self.is_2d = masked, dtype, is_2d
        self.pin = device.type == "cuda"

    def _tensor(self, array, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(array))
        if dtype is not None:
            t = t.to(dtype)
        return t.pin_memory() if self.pin else t

    def _transformed(self, image, labels):
        out = self.transform({"images": image, "labels": labels})
        return np.asarray(out["images"], np.float32), np.asarray(out["labels"])

    def item(self, subject, images_only=False) -> dict:
        """{images, and unless ``images_only``: target, mask, baseline}
        of one subject (volume) or image (native-2D); the voxels of an
        eval item count under ``eval.voxels``."""
        with profiling.span("direct.decode"):
            images = np.asarray(self.dataset.read_volume(subject, "images"),
                                np.float32)
            if images_only:
                if self.transform is None:
                    return {"images": images}
                if self.is_2d:
                    return {"images": _transformed_image(self.transform,
                                                         images)}
                return {"images": np.stack([
                    _transformed_image(self.transform, z) for z in images])}
            labels = np.asarray(self.dataset.read_volume(subject, "labels"))
            if self.transform is not None:
                if self.is_2d:
                    images, labels = self._transformed(images, labels)
                else:  # per slice (H, W, C), as the staged loader applies it
                    outs = [self._transformed(images[z], labels[z])
                            for z in range(images.shape[0])]
                    images = np.stack([o[0] for o in outs])
                    labels = np.stack([o[1] for o in outs])
            target, baseline = _split_labels(labels, self.needs_baseline,
                                             self.is_2d)
        with profiling.span("direct.mask"):
            mask = foreground_mask(self.dataset, subject, target.shape) \
                if self.masked else np.ones(target.shape, bool)
        profiling.count("eval.voxels", target.size)
        item = {"images": images, "target": target, "mask": mask}
        if baseline is not None:
            item["baseline"] = baseline
        return item

    def host(self, arrays: dict) -> dict:
        """numpy arrays -> host tensors, the images in the input dtype."""
        return {k: self._tensor(v, self.dtype if k == "images" else None)
                for k, v in arrays.items()}

    def parts(self, group, images_only=False) -> list:
        """An item's same-shape parts, in order, each ``(start in the
        item, subjects, host tensors)``: on a volume store the item is one
        subject and its volume the one part; on a native-2D dataset the
        item is a chunk of images and a part each run of consecutive
        images of one shape (``load_chunk``), stacked (n, ...)."""
        items = [self.item(s, images_only) for s in group]
        if not images_only:
            profiling.count("eval.items")
        if not self.is_2d:
            with profiling.span("direct.host_tensors"):
                return [(0, group, self.host(items[0]))]
        parts, start = [], 0
        for i in range(1, len(items) + 1):
            if i == len(items) or \
                    items[i]["images"].shape != items[start]["images"].shape:
                same = items[start:i]
                with profiling.span("direct.host_tensors"):
                    host = self.host({k: np.stack([it[k] for it in same])
                                      for k in same[0]})
                parts.append((start, group[start:i], host))
                start = i
        return parts


def _image_row(host, i):
    """Image ``i``'s eval row of a part's host results."""
    return {k: ({c: x[i] for c, x in v.items()} if isinstance(v, dict)
                else v[i]) for k, v in host.items()}


def evaluate_subjects(models, dataset, out_dir: str, *, strategy: str = "mc",
                      run_id: str = "baseline", mc: int = 20,
                      is_log_sigma: bool = False, batch_size: int = 32,
                      seed: int = 20, thresholds=DEFAULT_THRESHOLDS,
                      masked: bool = True, device=None,
                      transform=None, layout: str = "flat", mesh=None,
                      subject_parallel: bool = False) -> dict:
    """The direct eval's core over ``dataset.subjects`` (see module doc).

    ``models``: one model for mc, deterministic, aleatoric (sigma head)
    and auxiliary_segm (5 input channels); the list of members for
    ensemble; the (segmenter with ``provide_features``, PostNet) pair for
    auxiliary_feat; in float32 or any variant (``model_from_flax``).
    ``transform`` (``engine.databuild.build_transform``) applies per
    slice of a volume, or per image. ``layout`` places the CSVs
    (:class:`_EvalSinks`). The images are cast to the models'
    compute dtype on the host. ``mc=0`` runs the mc strategy as
    deterministic. aleatoric runs two passes: the sigma bounds of each
    subject (image), then the eval with the run's global bounds (a
    constant range raises in between).

    A volume store runs a subject at a time (its MC stream ``(seed,
    i)``). A native-2D dataset (images (H, W, C)) runs ``batch_size``
    images a chunk, a chunk split into runs of consecutive same-shape
    images, each run one batch and one eval kernel launch (its MC stream
    ``(seed, offset of its first image)``), with a CSV row per image.
    Either way one reader thread reads ahead of the device work
    (:func:`_drive`), and each item's results come back in one copy.

    ``mesh`` (a ``parallel.Mesh``; the models on its first device):
    - latency mode: ``batch_size`` rounds up to the data axis
      (``parallel.pad_batch_size_to_mesh``), each batch (a native-2D
      part) splits over the data devices, each holding its own copy of
      the models (``pipeline.Family.slots``; an ensemble's members over
      the model axis of a 2-D mesh), and the eval is one kernel launch per
      data device and item, the sums added on the first device;
    - throughput mode (``subject_parallel``): item ``i`` (a native-2D
      chunk ``c``'s part ``p``: ``c + p``) runs whole on device ``i % n``
      with that device's copy of the models, ``2 n`` items in flight.
    The MC stream does not depend on the mode or the mesh, so the CSVs
    are the single device's: byte for byte in throughput mode; in
    latency mode where the padded batch is the single run's, up to the
    order of the float sums.

    The f32 models and the f32 heads of the others are held to the f32
    bar, so cuDNN and matmul TF32 are off while they run (torch's default
    lets cuDNN use TF32, which misses that bar); f32 models take cuDNN's
    conv engines by measurement (``eval.device.measured_conv_engines``)
    outside a latency mesh. The caller's flags are restored afterwards,
    also on error."""
    family = _family(strategy)
    family.check(models)
    device = run_device(device, mesh)
    sinks = _EvalSinks(out_dir, run_id, thresholds, strategy, layout, masked)
    # native-2D: images (H, W, C) with no slice axis (ISIC)
    is_2d = len(dataset.shape(dataset.subjects[0], "images")) == 3
    if mesh is not None and not subject_parallel:
        batch_size = pad_batch_size_to_mesh(batch_size, mesh)
    slots = family.slots(models, device, mesh, subject_parallel)
    reader = _Reader(dataset, transform, family.baseline, masked,
                     family.input_dtype(models), device, is_2d)
    pool = concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix="direct")
    try:
        # a latency mesh's part threads are new every call: no search there
        with full_float32(), measured_conv_engines(
                models if mesh is None or subject_parallel else None):
            return _run(dataset, sinks, reader, pool, slots, family,
                        mc=mc, is_log_sigma=is_log_sigma,
                        batch_size=batch_size, seed=seed,
                        thresholds=thresholds)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


_WINDOW = 2  # items in flight on the device (a slot), and items read ahead


def _run(dataset, sinks, reader, pool, slots, family, *, mc, is_log_sigma,
         batch_size, seed, thresholds):
    """The run loop (:func:`evaluate_subjects`; ``rcu_tpu.eval.direct``'s
    volume loop and ``_evaluate_direct_2d``): each same-shape part of an
    item (:meth:`_Reader.parts`) is one dispatch, part ``p`` of item
    ``i`` on slot ``i + p``. A native-2D part runs at its own length: an
    eager program needs no padding to a static shape, and the JAX package
    drops its padded rows before the CSVs."""
    per_image = reader.is_2d
    names = list(dataset.subjects)
    chunk = max(1, int(batch_size)) if per_image else 1
    starts = list(range(0, len(names), chunk))
    groups = [names[s:s + chunk] for s in starts]
    window = _WINDOW * len(slots)

    def dispatcher(call):
        def dispatch(i, group, parts):
            outs = []
            for p, (start, subjects, data) in enumerate(parts):
                models, device, mesh = slots[(i + p) % len(slots)]
                if device is not None:  # a latency mesh's devices copy
                    with profiling.span("direct.copy_in"):
                        data = {k: v.to(device, non_blocking=True)
                                for k, v in data.items()}
                n = len(subjects) if per_image else batch_size
                outs.append((subjects, Fetch(call(
                    models, data, n, rng=(seed, starts[i] + start),
                    mesh=mesh))))
            return outs
        return dispatch

    bounds = None
    if family.sigma:
        def minmax(models, data, n, rng, mesh):
            mn, mx = pipeline.sigma_minmax(models, n, data["images"],
                                           is_log_sigma, per_image, mesh)
            return {"min": mn, "max": mx}

        def add_bounds(group, outs, t0):
            for _, out in outs:
                got = _result(out)
                for mn, mx in zip(np.atleast_1d(got["min"]),
                                  np.atleast_1d(got["max"])):
                    sinks.add_bounds(mn, mx)

        _drive(pool, groups, lambda i, g: reader.parts(g, images_only=True),
               dispatcher(minmax), add_bounds, window)
        bounds = _global_bounds(sinks.bounds)
        logging.info("direct %s: global sigma range [%.6f, %.6f]",
                     family.name, *bounds)

    evaluate = functools.partial(
        pipeline.evaluate, family.name, thresholds=thresholds, mc=mc,
        is_log_sigma=is_log_sigma, bounds=bounds, per_image=per_image)
    eces = {}

    def fetch(group, outs, t0):
        for subjects, out in outs:
            host = _result(out)
            for i, subject in enumerate(subjects):
                row = _image_row(host, i) if per_image else host
                sinks.write_subject(subject, row)
                eces[subject] = float(row["ece"])
        logging.info("direct eval %s ece=%.5f (%d item(s), %.2fs)",
                     group[0] if len(group) == 1
                     else f"[{group[0]}..{group[-1]}] mean",
                     float(np.mean([eces[s] for s in group])), len(group),
                     time.perf_counter() - t0)

    _drive(pool, groups, lambda i, g: reader.parts(g), dispatcher(evaluate),
           fetch, window)
    sinks.finish()
    return eces
