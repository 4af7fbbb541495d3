"""The per-subject eval reduction of the direct path: a hand-written CUDA
kernel (``rcu_tpu_torch/csrc/evalstats.cu``), its plain PyTorch version and
the glue that turns its sums into the eval CSV rows.

Port of ``rcu_tpu/ops/pallas/evalstats.py`` (``fused_eval_stats`` and
``fused_subject_eval``). :func:`fused_eval_stats` launches the kernel for
CUDA tensors and takes :func:`fused_eval_stats_reference` only for CPU
tensors; anything else raises. ``fused_eval_stats.launches`` counts kernel
launches and ``fused_eval_stats.plain_calls`` the CPU calls, so a run can
show which path it went through.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from rcu_tpu_torch.ops.calibration import (_bin_proportions, bin_edges,
                                           bin_statistics, binned_sums)
from rcu_tpu_torch.ops.metrics import dice_from_counts
from rcu_tpu_torch.ops.uncertainty import _correction_from_counts

N_BINS = 10
MAX_THRESHOLDS = 23
THREADS = 256  # the kernel's block size (checked against the library)
_INT_COLS = 2 * N_BINS + 4 + 4 * MAX_THRESHOLDS
_BLOCKS_PER_SM = 4
_MAX_BLOCK_VOXELS = 2 ** 30  # int32 per-block counts stay exact below 2^31


@functools.cache
def _library():
    from rcu_tpu_torch.ops.cuda import build
    lib = build.load("evalstats")
    layout = (ctypes.c_int * 4)()
    lib.rcu_fused_eval_stats_layout.argtypes = [ctypes.c_void_p]
    lib.rcu_fused_eval_stats_layout.restype = ctypes.c_int
    lib.rcu_fused_eval_stats_layout(layout)
    if tuple(layout) != (N_BINS, MAX_THRESHOLDS, _INT_COLS, THREADS):
        raise RuntimeError(f"evalstats.cu layout {tuple(layout)} does not "
                           "match the Python wrapper")
    ptr = ctypes.c_void_p
    lib.rcu_fused_eval_stats.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ctypes.c_longlong, ptr, ctypes.c_int, ptr,
        ctypes.c_int, ptr, ptr, ctypes.c_int, ptr]
    lib.rcu_fused_eval_stats.restype = ctypes.c_int
    return lib


def _stats_dict(counts, conf_sum, n_thresholds):
    """Name the kernel's int64 count row and float64 confidence sums."""
    tp, tn, fp, fn = counts[2 * N_BINS:2 * N_BINS + 4]
    off = 2 * N_BINS + 4
    return {"bins_count": counts[:N_BINS], "bins_conf_sum": conf_sum,
            "bins_true_sum": counts[N_BINS:2 * N_BINS],
            "tp": tp, "tn": tn, "fp": fp, "fn": fn,
            "thresh_counts": counts[off:off + 4 * n_thresholds]
            .reshape(n_thresholds, 4)}


def fused_eval_stats_reference(fg, target, prediction, uncertainty, weight,
                               thresholds):
    """Plain PyTorch version of the kernel: the same sums, by tensor ops.

    Returns ``bins_count``/``bins_true_sum`` (10,) int64, ``bins_conf_sum``
    (10,) float64, ``tp/tn/fp/fn`` int64 scalars and ``thresh_counts``
    (T, 4) int64 of (tpu, tnu, fpu, fnu) per threshold, ``u > threshold``.
    The weight counts for the bins only, not for the other counts."""
    t = target.reshape(-1).bool()
    p = prediction.reshape(-1).bool()
    u = uncertainty.reshape(-1).float()
    count, conf, true = binned_sums(fg, t, N_BINS, weight)
    classes = [t & p, ~t & ~p, ~t & p, t & ~p]  # tp, tn, fp, fn
    th = torch.as_tensor(thresholds, dtype=torch.float32, device=u.device)
    counts = torch.cat([
        count, true,
        torch.stack([m.sum() for m in classes]),
        torch.stack([(m & (u > th[j])).sum() for j in range(th.numel())
                     for m in classes]) if th.numel() else
        torch.zeros(0, dtype=torch.int64, device=u.device)])
    return _stats_dict(counts, conf, th.numel())


def _check_cuda_inputs(fg, target, prediction, uncertainty, weight):
    planes = {"fg": (fg, torch.float32, 16), "uncertainty": (uncertainty, torch.float32, 16),
              "target": (target, torch.uint8, 4),
              "prediction": (prediction, torch.uint8, 4),
              "weight": (weight, torch.uint8, 4)}
    for name, (x, dtype, align) in planes.items():
        if x.device != fg.device:
            raise ValueError(f"{name} is on {x.device}, fg on {fg.device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.numel() != fg.numel():
            raise ValueError(f"{name} has {x.numel()} elements, fg {fg.numel()}")
        if x.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned for the "
                             "kernel's vector loads")


def fused_eval_stats(fg, target, prediction, uncertainty, weight, thresholds):
    """One-pass eval sums of one subject (see the reference for the result).

    On CUDA: ``fg``/``uncertainty`` float32, ``target``/``prediction``/
    ``weight`` uint8 0/1 (a bool tensor's ``.view(torch.uint8)``), all
    contiguous with equal sizes; at most 23 thresholds."""
    if len(thresholds) > MAX_THRESHOLDS:
        raise ValueError(f"at most {MAX_THRESHOLDS} thresholds, got {len(thresholds)}")
    if fg.device.type == "cpu":
        fused_eval_stats.plain_calls += 1
        return fused_eval_stats_reference(fg, target, prediction, uncertainty,
                                          weight, thresholds)
    if fg.device.type != "cuda":
        raise ValueError(f"fused_eval_stats runs on cuda or cpu, not {fg.device}")
    _check_cuda_inputs(fg, target, prediction, uncertainty, weight)
    lib = _library()
    n = fg.numel()
    sms = torch.cuda.get_device_properties(fg.device).multi_processor_count
    quads = -(-n // 4)
    grid = max(1, min(_BLOCKS_PER_SM * sms, -(-quads // THREADS)),
               -(-n // _MAX_BLOCK_VOXELS))
    part_int = torch.empty((grid, _INT_COLS), dtype=torch.int32, device=fg.device)
    part_conf = torch.empty((grid, N_BINS), dtype=torch.float64, device=fg.device)
    edges = bin_edges(N_BINS)
    edge_hi = (ctypes.c_float * N_BINS)(*[float(hi) for hi, _ in edges])
    strict = sum(1 << k for k, (_, s) in enumerate(edges) if s)
    th = (ctypes.c_float * MAX_THRESHOLDS)(*[float(x) for x in thresholds])
    with torch.cuda.device(fg.device):
        err = lib.rcu_fused_eval_stats(
            fg.data_ptr(), uncertainty.data_ptr(), target.data_ptr(),
            prediction.data_ptr(), weight.data_ptr(), n, edge_hi, strict, th,
            len(thresholds), part_int.data_ptr(), part_conf.data_ptr(), grid,
            torch.cuda.current_stream(fg.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_eval_stats launch failed: cudaError {err}")
    fused_eval_stats.launches += 1
    # second pass: fixed-order sums over the per-block rows
    return _stats_dict(part_int.sum(0, dtype=torch.int64), part_conf.sum(0),
                       len(thresholds))


fused_eval_stats.launches = 0
fused_eval_stats.plain_calls = 0


def fused_subject_eval(fg, target, prediction, uncertainty, mask, thresholds):
    """Everything the eval CSVs need from one pass over a subject.

    Returns ``(bins, confusion, correction)`` like the JAX
    ``fused_subject_eval``: bins with the proportion-weighted ``ece``;
    confusion with ``n`` and ``dice``; correction a dict of
    ``(len(thresholds),)`` tensors. ``mask`` (None = all voxels) reaches the
    ECE bins only."""
    weight = mask if mask is not None else torch.ones_like(target)
    stats = fused_eval_stats(fg, target, prediction, uncertainty, weight,
                             thresholds)
    count = stats["bins_count"]
    pos_frac, mean_conf, nonzero = bin_statistics(
        count, stats["bins_conf_sum"], stats["bins_true_sum"])
    proportions = _bin_proportions("proportion", count, nonzero, 1)
    ece = torch.sum(torch.abs(mean_conf - pos_frac) * proportions)
    bins = {"bins_count": count, "bins_avg_confidence": mean_conf,
            "bins_positive_fraction": pos_frac, "bins_non_zero": nonzero,
            "ece": ece}
    tp, tn, fp, fn = stats["tp"], stats["tn"], stats["fp"], stats["fn"]
    confusion = {"tp": tp, "tn": tn, "fp": fp, "fn": fn, "n": tp + tn + fp + fn,
                 "dice": dice_from_counts(tp.float(), fp.float(), fn.float())}
    per_th = stats["thresh_counts"]  # (T, 4): tpu, tnu, fpu, fnu
    correction = _correction_from_counts(
        tuple(c.expand(per_th.shape[0]) for c in (tp, tn, fp, fn))
        + tuple(per_th.unbind(1)))
    return bins, confusion, correction
