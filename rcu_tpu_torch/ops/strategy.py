"""The dict-in, dict-out evaluation-strategy API of ``rcu_tpu.ops.strategy``
(the reference metric library's), for users porting evaluation code of
their own.

Each strategy reads named entries of ``to_evaluate`` (numpy arrays, or
tensors on any device; a dict's tensors share one device) and writes its
results into ``results``, with the JAX package's keys and Python types:
``int`` counts, ``float`` scalars, the bins as numpy arrays (an ``int64``
``bins_count``, float32 averages and fractions, a bool ``bins_non_zero``).
The confusion counts, the ECE and the uncertainty metrics run on the
entries' device with the port's ``ops``; the smooth dice, NLL and log loss
are the port's host metrics (``ops.metrics``) on host copies.
"""
from __future__ import annotations

import abc

import numpy as np
import torch

from rcu_tpu_torch.ops import calibration as cal_ops
from rcu_tpu_torch.ops import metrics as m_ops
from rcu_tpu_torch.ops import uncertainty as u_ops


def _device(*values):
    for value in values:
        if isinstance(value, torch.Tensor):
            return value.device
    return torch.device("cpu")


def _tensors(*values):
    """The entries as tensors on the device of the first tensor among them
    (the CPU where all are numpy)."""
    device = _device(*values)
    return [v.to(device) if isinstance(v, torch.Tensor)
            else torch.as_tensor(np.asarray(v), device=device) for v in values]


def _host(value):
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) \
        else np.asarray(value)


class EvaluationStrategy(abc.ABC):
    def __init__(self, result_entry=None):
        self.result_entry = result_entry

    @abc.abstractmethod
    def __call__(self, to_evaluate: dict, results: dict) -> None:
        ...


class EmptyEvaluation(EvaluationStrategy):
    def __call__(self, to_evaluate, results):
        pass


class ComposeEvaluation(EvaluationStrategy):
    def __init__(self, eval_strategies):
        super().__init__()
        self.eval_strategies = list(eval_strategies)

    def __call__(self, to_evaluate, results):
        for strategy in self.eval_strategies:
            strategy(to_evaluate, results)


class LambdaEvaluation(EvaluationStrategy):
    def __init__(self, lambda_fn, entry_keys: tuple, result_entry):
        super().__init__(result_entry)
        self.lambda_fn = lambda_fn
        self.entry_keys = tuple(entry_keys)

    def __call__(self, to_evaluate, results):
        results[self.result_entry] = self.lambda_fn(
            *(to_evaluate[k] for k in self.entry_keys))


class SmoothDice(EvaluationStrategy):
    def __init__(self, result_entry="smooth_dice"):
        super().__init__(result_entry)

    def __call__(self, to_evaluate, results):
        results[self.result_entry] = m_ops.smooth_dice(
            _host(to_evaluate["prediction"]), _host(to_evaluate["target"]))


class Nll(EvaluationStrategy):
    def __init__(self, do_log=True, result_entry="nll"):
        super().__init__(result_entry)
        self.do_log = do_log

    def __call__(self, to_evaluate, results):
        results[self.result_entry] = m_ops.nll(
            _host(to_evaluate["probabilities"]), _host(to_evaluate["target"]),
            self.do_log)


class LogLoss(EvaluationStrategy):
    def __init__(self, result_entry="ce"):
        super().__init__(result_entry)

    def __call__(self, to_evaluate, results):
        results[self.result_entry] = m_ops.log_loss(
            _host(to_evaluate["probabilities"]), _host(to_evaluate["target"]))


class Dice(EvaluationStrategy):
    def __init__(self, result_entry="dice"):
        super().__init__(result_entry)

    def __call__(self, to_evaluate, results):
        prediction, target = _tensors(to_evaluate["prediction"],
                                      to_evaluate["target"])
        tp, _, fp, fn, _ = m_ops.confusion_counts(prediction, target)
        results[self.result_entry] = float(m_ops.dice_from_counts(tp, fp, fn))


class ConfusionMatrix(EvaluationStrategy):
    def __init__(self, result_entries=("tp", "tn", "fp", "fn", "n")):
        super().__init__(result_entries)

    def __call__(self, to_evaluate, results):
        counts = m_ops.confusion_counts(*_tensors(to_evaluate["prediction"],
                                                  to_evaluate["target"]))
        for key, value in zip(self.result_entry, counts):
            results[key] = int(value)


class EceBinary(EvaluationStrategy):
    def __init__(self, n_bins=10, result_entry="ece", threshold_range=None,
                 with_mask=False, return_bins=False,
                 bin_weighting="proportion"):
        super().__init__(result_entry)
        self.n_bins = n_bins
        self.threshold_range = threshold_range
        self.with_mask = with_mask
        self.return_bins = return_bins
        self.bin_weighting = bin_weighting

    def __call__(self, to_evaluate, results):
        entries = [to_evaluate["probabilities"], to_evaluate["target"]]
        if self.with_mask:
            entries.append(to_evaluate["mask"])
        probs, target, *mask = _tensors(*entries)
        mask = mask[0] if mask else None
        if self.threshold_range is not None:
            # a mask, so that the bins stay available
            mask = cal_ops.threshold_range_mask(probs, target,
                                                self.threshold_range, mask)
        ece, bins = cal_ops.ece_binary_with_bins(probs, target, mask,
                                                 self.n_bins,
                                                 self.bin_weighting)
        if self.return_bins:
            results["bins_count"] = _host(bins["bins_count"]).astype(np.int64)
            results["bins_avg_confidence"] = _host(
                bins["bins_avg_confidence"]).astype(np.float32)
            results["bins_positive_fraction"] = _host(
                bins["bins_positive_fraction"]).astype(np.float32)
            results["bins_non_zero"] = _host(bins["bins_non_zero"])
        results[self.result_entry] = float(ece)


class UncertaintyErrorDice(EvaluationStrategy):
    """Thresholded-uncertainty error precision, recall and dice. With
    ``with_mask`` the border mask is excluded: its key is
    ``target_boarder`` (the reference's spelling) or ``target_border``,
    cast to bool before it is inverted (``~`` of a uint8 0/1 mask would
    give 255/254)."""

    def __init__(self, uncertainty_threshold, result_prefix=None,
                 with_mask=False):
        super().__init__()
        self.uncertainty_threshold = uncertainty_threshold
        self.prefix = "" if result_prefix is None else result_prefix + "_"
        self.with_mask = with_mask

    def __call__(self, to_evaluate, results):
        entries = [to_evaluate["prediction"], to_evaluate["target"],
                   to_evaluate["uncertainty"]]
        if self.with_mask:
            key = "target_boarder" if "target_boarder" in to_evaluate \
                else "target_border"
            border = to_evaluate[key]
            entries.append(~(border.bool() if isinstance(border, torch.Tensor)
                             else np.asarray(border, dtype=bool)))
        prediction, target, uncertainty, *mask = _tensors(*entries)
        out = u_ops.uncertainty_error_metrics(
            prediction, target, uncertainty,
            np.asarray([self.uncertainty_threshold], np.float32),
            mask=mask[0] if mask else None)
        for key in ("precision", "recall", "dice"):
            results[f"{self.prefix}{key}"] = float(out[key][0])


class UncertaintyAndCorrectionEval(EvaluationStrategy):
    """The correction analysis at one threshold: the correction CSV's
    columns, typed as the CSV carries them."""

    def __init__(self, uncertainty_threshold):
        super().__init__()
        self.uncertainty_threshold = uncertainty_threshold

    def __call__(self, to_evaluate, results):
        out = u_ops.correction_eval(
            *_tensors(to_evaluate["prediction"], to_evaluate["target"],
                      to_evaluate["uncertainty"]),
            np.asarray([self.uncertainty_threshold], np.float32))
        from rcu_tpu_torch.eval.actions import CORRECTION_KEYS, csv_value
        for key in CORRECTION_KEYS:
            results[key] = csv_value(key, _host(out[key][0]))
