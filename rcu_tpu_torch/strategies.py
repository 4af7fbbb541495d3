"""The strategy runners (``rcu_tpu.strategies`` counterpart): the four train
entry functions of the paper's strategies with their validation metrics,
and the five test entry functions of the staged test loop.

- baseline, center, the cv folds and the ensemble members ->
  :func:`train_default` (CE loss, Dice + log loss validation);
- aleatoric -> :func:`train_aleatoric` (the sigma head's noisy-logit loss,
  Dice validation);
- auxiliary feat. -> :func:`train_auxiliary_feat` (a PostNet on the
  features of a frozen segmenter, ``others.model_dir`` at
  ``others.test_at``);
- auxiliary segm. -> :func:`train_auxiliary_segm` (an error net over the
  images and a baseline prediction, labels [gt, baseline]).

Each returns the finished :class:`engine.train.TrainLoop`. ``hooks``,
``device`` and ``mesh`` go to it (the default hooks need
``tensorboardX``); on a mesh the step and the validation run on its data
axis, with the result of one device on the whole batch
(``engine.steps.MeshTrainStep``).

Testing (each returns the finished :class:`engine.test.TestLoop`, whose
run dir holds the NIfTI artifacts; ``hooks``, ``device`` and ``mesh``
go to it; on a 2-D mesh the ensemble's members shard over the model
axis):
- baseline, center, cv -> :func:`test_default` (``others.mc: T`` runs the
  MC protocol, T dropout forwards a batch);
- aleatoric -> :func:`test_aleatoric` (``_sigma``: the predicted class's);
- the ensemble -> :func:`test_ensemble` (``model_dir`` at ``test_at`` and
  the ``others.model_dir`` members at ``others.test_at``; their mean
  softmax);
- auxiliary feat. / segm. -> :func:`test_auxiliary_feat` /
  :func:`test_auxiliary_segm` (``_confidence``, and the frozen
  segmenter's or the baseline's ``_prediction``).
``symlink_inputs`` links each subject's raw inputs into the run dir (the
ISIC CLIs).
"""
from __future__ import annotations

import os

import numpy as np

from rcu_tpu_torch.engine import config as cfg_lib
from rcu_tpu_torch.engine import steps as steps_lib
from rcu_tpu_torch.engine.test import TestLoop, write_artifact
from rcu_tpu_torch.engine.train import TrainLoop
from rcu_tpu_torch.eval.direct import _load_ensemble, load_model, resolve_device
from rcu_tpu_torch.ops import metrics as metrics_lib


def _binary_target(info: dict) -> np.ndarray:
    target = np.squeeze(np.asarray(info["labels"]))
    if target.ndim > 2 and target.shape[-1] == 2:  # [gt, baseline-pred] labels
        target = target[..., 0]
    return (target > 0.5).astype(np.uint8)


# which checkpoint becomes "best" depends on these metrics: each is its
# strategy's validation in the JAX package

def isic_eval_subject_fn(subject_data: dict, info: dict):
    """ISIC validation: smooth Dice ('dice') of the argmax and the NLL of
    the probabilities; the score is the smooth Dice."""
    probabilities = subject_data["probabilities"]
    prediction = np.argmax(probabilities, axis=-1)
    target = _binary_target(info)
    sdice = metrics_lib.smooth_dice(prediction, target)
    return {"dice": sdice, "nll": metrics_lib.nll(probabilities, target)}, sdice


def dice_eval_subject_fn(subject_data: dict, info: dict):
    """Dice-only validation (the BraTS aleatoric runs)."""
    prediction = np.argmax(subject_data["probabilities"], axis=-1)
    dice = metrics_lib.dice(prediction, _binary_target(info))
    return {"dice": dice}, dice


def isic_smooth_dice_eval_subject_fn(subject_data: dict, info: dict):
    """Smooth-Dice-only validation (the ISIC aleatoric runs)."""
    prediction = np.argmax(subject_data["probabilities"], axis=-1)
    sdice = metrics_lib.smooth_dice(prediction, _binary_target(info))
    return {"dice": sdice}, sdice


def _error_eval(probabilities, target):
    """Dice and log loss of an error net's prediction against the error
    mask ``target``."""
    prediction = np.argmax(probabilities, axis=-1)
    dice = metrics_lib.dice(prediction, target)
    ce = metrics_lib.log_loss(probabilities.reshape(-1, probabilities.shape[-1]),
                              target.astype(np.uint8))
    return {"dice": dice, "ce": ce}, dice


def _aux_feat_eval_subject_fn(subject_data: dict, info: dict):
    """The PostNet's error prediction against the frozen segmenter's actual
    error mask."""
    net_predictions = np.squeeze(subject_data["net_predictions"])
    target = net_predictions.astype(np.uint8) != _binary_target(info)
    return _error_eval(subject_data["probabilities"], target)


def _aux_segm_eval_subject_fn(subject_data: dict, info: dict):
    """The error net's prediction against (baseline != gt)."""
    labels = np.squeeze(np.asarray(info["labels"]))
    target = (labels[..., 1] > 0.5) != (labels[..., 0] > 0.5)
    return _error_eval(subject_data["probabilities"], target)


def train_default(config: cfg_lib.TrainConfiguration, mesh=None,
                  eval_subject_fn=None, hooks=None, device=None) -> TrainLoop:
    return TrainLoop(config, mesh=mesh, eval_subject_fn=eval_subject_fn,
                     hooks=hooks, device=device).run()


def train_aleatoric(config: cfg_lib.TrainConfiguration, mesh=None,
                    eval_subject_fn=None, hooks=None,
                    device=None) -> TrainLoop:
    is_log_sigma = cfg_lib.require_log_sigma(config)
    train_step = steps_lib.make_train_step("aleatoric",
                                           is_log_sigma=is_log_sigma,
                                           mesh=mesh)
    return TrainLoop(config, train_step=train_step, mesh=mesh,
                     eval_subject_fn=eval_subject_fn or dice_eval_subject_fn,
                     hooks=hooks, device=device).run()


def _frozen_segmenter(others: dict, device):
    if not others.get("model_dir") or "test_at" not in others:
        raise ValueError('missing "model_dir" or "test_at" entry in the '
                         'configuration (others)')
    model = load_model(others["model_dir"], others["test_at"], device,
                       provide_features=True)
    return model.requires_grad_(False)


def train_auxiliary_feat(config: cfg_lib.TrainConfiguration, mesh=None,
                         hooks=None, device=None) -> TrainLoop:
    segm_model = _frozen_segmenter(config.others, _home(device, mesh))
    train_step = steps_lib.make_auxiliary_train_step(segm_model, mesh=mesh)
    predict = steps_lib.make_auxiliary_feat_predict_fn(segm_model, mesh)
    return TrainLoop(config, train_step=train_step, predict_fn=predict,
                     eval_subject_fn=_aux_feat_eval_subject_fn,
                     validation_entries=("probabilities", "net_predictions"),
                     mesh=mesh, hooks=hooks, device=device).run()


def train_auxiliary_segm(config: cfg_lib.TrainConfiguration, mesh=None,
                         hooks=None, device=None) -> TrainLoop:
    train_step = steps_lib.make_auxiliary_train_step(mesh=mesh)
    predict = steps_lib.make_auxiliary_segm_predict_fn(mesh)
    return TrainLoop(config, train_step=train_step, predict_fn=predict,
                     eval_subject_fn=_aux_segm_eval_subject_fn, mesh=mesh,
                     hooks=hooks, device=device).run()


# ---------------------------------------------------------------------------
# testing
# ---------------------------------------------------------------------------

def _home(device, mesh):
    """The device the test models load on: the mesh's first, or
    ``device``."""
    return resolve_device(device if mesh is None else mesh.devices[0])


def test_default(config: cfg_lib.TestConfiguration, mesh=None,
                 symlink_inputs: bool = False, hooks=None,
                 device=None) -> TestLoop:
    mc = int(config.others.get("mc") or 0)
    if mc:
        return TestLoop(config,
                        predict_fn=steps_lib.make_mc_predict_fn(mc, mesh),
                        needs_rng=True, mesh=mesh,
                        symlink_inputs=symlink_inputs, hooks=hooks,
                        device=device).run()
    return TestLoop(config, mesh=mesh, symlink_inputs=symlink_inputs,
                    hooks=hooks, device=device).run()


def test_aleatoric(config: cfg_lib.TestConfiguration, mesh=None,
                   symlink_inputs: bool = False, hooks=None,
                   device=None) -> TestLoop:
    predict = steps_lib.make_aleatoric_predict_fn(
        cfg_lib.require_log_sigma(config), mesh)
    return TestLoop(config, predict_fn=predict,
                    entries=("probabilities", "sigma"), mesh=mesh,
                    symlink_inputs=symlink_inputs, hooks=hooks,
                    device=device).run()


def test_ensemble(config: cfg_lib.TestConfiguration, mesh=None,
                  symlink_inputs: bool = False, hooks=None,
                  device=None) -> TestLoop:
    """The primary model (``model_dir`` at ``test_at``, where set) and the
    ``others.model_dir`` members at ``others.test_at``; an empty member
    list raises. The run dir goes under the first model's train dir."""
    members = _load_ensemble(config, _home(device, mesh), {})
    anchor = config.model_dir or config.others["model_dir"]
    anchor = anchor if isinstance(anchor, str) else anchor[0]
    return TestLoop(config,
                    predict_fn=steps_lib.make_ensemble_predict_fn(members,
                                                                  mesh),
                    entries=("probabilities", "entropy"), external_state=True,
                    mesh=mesh,
                    run_dir_base=os.path.join(os.path.dirname(anchor), "test"),
                    symlink_inputs=symlink_inputs, hooks=hooks,
                    device=device).run()


def _aux_feat_test_eval_fn(subject_data: dict, info: dict) -> dict:
    """The test metric of auxiliary feat.: the Dice of the frozen
    segmenter."""
    prediction = np.argmax(subject_data["segm_probabilities"], axis=-1)
    return {"dice": metrics_lib.dice(prediction, _binary_target(info))}


def _aux_feat_artifact_fn(loop: TestLoop, subject: str, subject_data: dict,
                          info: dict):
    """``_confidence`` (the PostNet's foreground) and ``_prediction`` (the
    frozen segmenter's argmax)."""
    props = info["properties"]
    write_artifact(loop, np.squeeze(subject_data["probabilities"][..., 1])
                   .astype(np.float32), subject, "confidence", props)
    write_artifact(loop, np.squeeze(np.argmax(
        subject_data["segm_probabilities"], axis=-1)).astype(np.uint8),
        subject, "prediction", props)


def test_auxiliary_feat(config: cfg_lib.TestConfiguration, mesh=None,
                        symlink_inputs: bool = False, hooks=None,
                        device=None) -> TestLoop:
    segm_model = _frozen_segmenter(config.others, _home(device, mesh))
    return TestLoop(config,
                    predict_fn=steps_lib.make_auxiliary_feat_predict_fn(
                        segm_model, mesh),
                    entries=("probabilities", "segm_probabilities"),
                    eval_subject_fn=_aux_feat_test_eval_fn,
                    artifact_fn=_aux_feat_artifact_fn, mesh=mesh,
                    symlink_inputs=symlink_inputs, hooks=hooks,
                    device=device).run()


def _aux_segm_artifact_fn(loop: TestLoop, subject: str, subject_data: dict,
                          info: dict):
    """``_confidence`` (the error net's foreground) and the baseline's
    ``_prediction``, passed through."""
    props = info["properties"]
    labels = np.squeeze(np.asarray(info["labels"]))
    write_artifact(loop, np.squeeze(subject_data["probabilities"][..., 1])
                   .astype(np.float32), subject, "confidence", props)
    write_artifact(loop, (labels[..., 1] > 0.5).astype(np.uint8), subject,
                   "prediction", props)


def test_auxiliary_segm(config: cfg_lib.TestConfiguration, mesh=None,
                        symlink_inputs: bool = False, hooks=None,
                        device=None) -> TestLoop:
    return TestLoop(config,
                    predict_fn=steps_lib.make_auxiliary_segm_predict_fn(mesh),
                    eval_subject_fn=lambda sd, info:
                        _aux_segm_eval_subject_fn(sd, info)[0],
                    artifact_fn=_aux_segm_artifact_fn, mesh=mesh,
                    symlink_inputs=symlink_inputs, hooks=hooks,
                    device=device).run()


TRAIN_STRATEGIES = {
    "default": train_default,
    "aleatoric": train_aleatoric,
    "auxiliary_feat": train_auxiliary_feat,
    "auxiliary_segm": train_auxiliary_segm,
}

TEST_STRATEGIES = {
    "default": test_default,
    "aleatoric": test_aleatoric,
    "ensemble": test_ensemble,
    "auxiliary_feat": test_auxiliary_feat,
    "auxiliary_segm": test_auxiliary_segm,
}
