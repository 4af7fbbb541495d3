"""The per-subject eval reduction of the direct path: a hand-written CUDA
kernel (``rcu_tpu_torch/csrc/evalstats.cu``), its plain PyTorch version and
the glue that turns its sums into the eval CSV rows.

``per_image=True`` reads the planes' leading axis as K images of one
shape (the native-2D eval's chunks) and gives every result a leading K
axis, in one launch; each image's row is bitwise what a launch of that
image alone gives. The default reads the planes as one subject.

Port of ``rcu_tpu/ops/pallas/evalstats.py`` (``fused_eval_stats`` and
``fused_subject_eval``). :func:`fused_eval_stats` launches the kernel for
CUDA tensors and takes :func:`fused_eval_stats_reference` only for CPU
tensors; anything else raises. ``fused_eval_stats.launches`` counts kernel
launches and ``fused_eval_stats.plain_calls`` the CPU calls, so a run can
show which path it went through.

The host side of the kernel is plain functions here, so the CPU tests
reach it: the bin edges in ``>=`` form (:func:`kernel_edges`), the sorted
thresholds and the caller's row of each (:func:`sort_thresholds`), the
algebra of the kernel's last step (:func:`counts_from_histogram`) and the
int32 guard (:func:`check_lane_counts`) and the cache key of the
threshold arguments (:func:`host_args_key`).
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from rcu_tpu_torch.ops.calibration import (_bin_proportions, bin_edges,
                                           bin_ids, bin_statistics)
from rcu_tpu_torch.ops.metrics import dice_from_counts
from rcu_tpu_torch.ops.uncertainty import _correction_from_counts
from rcu_tpu_torch.utils import profiling

N_BINS = 10
MAX_THRESHOLDS = 23
THREADS = 256  # the kernel's block size (checked against the library)
VOXELS_PER_THREAD = 8  # per grid-stride iteration (checked likewise)
_INT_COLS = 2 * N_BINS + 4 + 4 * MAX_THRESHOLDS
_LANE_LIMIT = 2 ** 31  # per-lane int32 counters stay exact below it
_ALIGN = {torch.float32: 16, torch.uint8: 8}  # the kernel's vector loads
# class c = 2 * target + prediction is tn, fp, fn, tp; the result's order
# tp, tn, fp, fn takes these classes
CLASS_ORDER = (3, 0, 1, 2)


@functools.cache
def _library():
    from rcu_tpu_torch.ops.cuda import build
    lib = build.load("evalstats")
    layout = (ctypes.c_int * 6)()
    lib.rcu_fused_eval_stats_layout.argtypes = [ctypes.c_void_p]
    lib.rcu_fused_eval_stats_layout.restype = ctypes.c_int
    lib.rcu_fused_eval_stats_layout(layout)
    want = (N_BINS, MAX_THRESHOLDS, _INT_COLS, THREADS, VOXELS_PER_THREAD,
            lane_cells(MAX_THRESHOLDS))
    if tuple(layout) != want:
        raise RuntimeError(f"evalstats.cu layout {tuple(layout)} does not "
                           "match the Python wrapper")
    ptr = ctypes.c_void_p
    lib.rcu_fused_eval_stats_occupancy.argtypes = [ctypes.c_int, ptr, ptr]
    lib.rcu_fused_eval_stats_occupancy.restype = ctypes.c_int
    lib.rcu_fused_eval_stats.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ctypes.c_longlong, ctypes.c_int, ptr, ptr,
        ptr, ctypes.c_int, ptr, ptr, ctypes.c_int, ptr]
    lib.rcu_fused_eval_stats.restype = ctypes.c_int
    return lib


def kernel_edges(n_bins: int = N_BINS) -> np.ndarray:
    """The inner bin edges as the kernel compares them: ``p`` lies above
    edge ``k`` when ``p >= edges[k]``. A strict edge (``p > hi``) becomes
    the next float32 up; the top edge is left out, since passing it keeps
    the last bin. Sums of these compares equal ``calibration.bin_ids``."""
    up = np.float32(np.inf)
    return np.asarray([np.nextafter(hi, up) if strict else hi
                       for hi, strict in bin_edges(n_bins)[:-1]], np.float32)


def sort_thresholds(thresholds):
    """-> (ascending float32 thresholds, ``order``): ``order[k]`` is the
    caller's index of the k-th smallest, the row the kernel writes its
    counts to. NaN becomes +inf: ``u > NaN`` and ``u > inf`` are false for
    every ``u``, so the counts are the same."""
    th = np.asarray(thresholds, np.float32).reshape(-1)
    th = np.where(np.isnan(th), np.float32(np.inf), th)
    order = np.argsort(th, kind="stable")
    return th[order], order


def counts_from_histogram(hist):
    """The kernel's last step, in numpy. ``hist[c, m]`` counts the voxels
    of class ``c = 2 * target + prediction`` whose uncertainty exceeds
    exactly ``m`` of the ascending thresholds. -> (tp, tn, fp, fn) and the
    (T, 4) (tpu, tnu, fpu, fnu) rows: ``u > th_j`` <=> ``m > j``, so row
    ``j`` sums ``hist[:, j + 1:]``."""
    hist = np.asarray(hist, np.int64)[list(CLASS_ORDER)]
    suffix = np.cumsum(hist[:, ::-1], axis=1)[:, ::-1]  # [c, m]: sum over >= m
    return suffix[:, 0], np.ascontiguousarray(suffix[:, 1:].T)


def lane_cells(n_thresholds: int) -> int:
    """A lane's counters, and a block's row of partial sums: the (bin,
    target) counts, the (class, m) histogram with m in 0..T, the
    confidence sums."""
    return 2 * N_BINS + 4 * (n_thresholds + 1) + N_BINS


def lane_voxels(n: int, grid: int) -> int:
    """The most voxels one lane counts: its share of the chunks of
    ``VOXELS_PER_THREAD`` voxels that the grid-stride loop hands out."""
    chunks = -(-n // VOXELS_PER_THREAD)
    return -(-chunks // (grid * THREADS)) * VOXELS_PER_THREAD


def check_lane_counts(n: int, grid: int) -> None:
    """Raise where a lane's int32 counters could reach 2^31."""
    if lane_voxels(n, grid) >= _LANE_LIMIT:
        raise ValueError(f"{n} voxels on {grid} blocks give one lane "
                         f"{lane_voxels(n, grid)} voxels; its int32 counters "
                         f"hold fewer than {_LANE_LIMIT}")


def grid_size(n: int, wave: int) -> int:
    """Blocks of one launch: one full wave, fewer where ``n`` is small."""
    return max(1, min(wave, -(-n // (VOXELS_PER_THREAD * THREADS))))


def _stats_dict(counts, conf_sum, n_thresholds):
    """Name the kernel's int64 count rows and float64 confidence sums (one
    row, or a leading image axis)."""
    off = 2 * N_BINS + 4
    tp, tn, fp, fn = counts[..., 2 * N_BINS:off].unbind(-1)
    return {"bins_count": counts[..., :N_BINS], "bins_conf_sum": conf_sum,
            "bins_true_sum": counts[..., N_BINS:2 * N_BINS],
            "tp": tp, "tn": tn, "fp": fp, "fn": fn,
            "thresh_counts": counts[..., off:off + 4 * n_thresholds]
            .reshape(*counts.shape[:-1], n_thresholds, 4)}


def fused_eval_stats_reference(fg, target, prediction, uncertainty, weight,
                               thresholds, per_image: bool = False):
    """Plain PyTorch version of the kernel: the same sums, by tensor ops.

    Returns ``bins_count``/``bins_true_sum`` (10,) int64, ``bins_conf_sum``
    (10,) float64, ``tp/tn/fp/fn`` int64 scalars and ``thresh_counts``
    (T, 4) int64 of (tpu, tnu, fpu, fnu) per threshold, ``u > threshold``;
    with ``per_image`` each with a leading image axis. The weight counts
    for the bins only, not for the other counts."""
    images = fg.shape[0] if per_image else 1
    t = target.reshape(images, -1).bool()
    p = prediction.reshape(images, -1).bool()
    u = uncertainty.reshape(images, -1).float()
    # each image's bins are its own ten of K * 10: binned_sums over ids
    # offset by ten an image
    fg = fg.reshape(images, -1).float()
    keep = weight.reshape(images, -1).bool()
    ids = bin_ids(fg, N_BINS) + N_BINS * torch.arange(
        images, device=fg.device)[:, None]
    count = torch.bincount(ids[keep], minlength=images * N_BINS)
    conf = torch.bincount(ids[keep], weights=fg[keep].double(),
                          minlength=images * N_BINS)
    true = torch.bincount(ids[keep & t], minlength=images * N_BINS)
    classes = [t & p, ~t & ~p, ~t & p, t & ~p]  # tp, tn, fp, fn
    th = torch.as_tensor(thresholds, dtype=torch.float32, device=u.device)
    counts = torch.cat(
        [count.view(images, N_BINS), true.view(images, N_BINS)]
        + [m.sum(1, keepdim=True) for m in classes]
        + [(m & (u > th[j])).sum(1, keepdim=True)
           for j in range(th.numel()) for m in classes], dim=1)
    stats = _stats_dict(counts, conf.view(images, N_BINS), th.numel())
    return stats if per_image else {k: v[0] for k, v in stats.items()}


def _check_cuda_inputs(fg, target, prediction, uncertainty, weight):
    planes = {"fg": (fg, torch.float32), "uncertainty": (uncertainty, torch.float32),
              "target": (target, torch.uint8),
              "prediction": (prediction, torch.uint8),
              "weight": (weight, torch.uint8)}
    for name, (x, dtype) in planes.items():
        if x.device != fg.device:
            raise ValueError(f"{name} is on {x.device}, fg on {fg.device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.numel() != fg.numel():
            raise ValueError(f"{name} has {x.numel()} elements, fg {fg.numel()}")
        if x.data_ptr() % _ALIGN[dtype]:
            raise ValueError(f"{name} must be {_ALIGN[dtype]}-byte aligned "
                             "for the kernel's vector loads")


@functools.cache
def occupancy(device_index: int, n_thresholds: int) -> tuple:
    """(resident blocks per SM, dynamic shared memory bytes a block) of the
    kernel for this threshold count on the device: the lane counters grow
    with the count, and they set the occupancy."""
    blocks, shared = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device_index):
        err = _library().rcu_fused_eval_stats_occupancy(
            n_thresholds, ctypes.byref(blocks), ctypes.byref(shared))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"fused_eval_stats occupancy query failed: "
                           f"cudaError {err}, {blocks.value} blocks per SM")
    return blocks.value, shared.value


def _wave(device_index: int, n_thresholds: int) -> int:
    """Blocks of one full wave on the device."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return occupancy(device_index, n_thresholds)[0] * sms


def host_args_key(thresholds) -> tuple:
    """The cache key of a threshold list: float values, every NaN as +inf
    (the same counts, see :func:`sort_thresholds`), so that NaN objects
    that compare unequal still share one entry."""
    return tuple(math.inf if math.isnan(x) else x
                 for x in map(float, thresholds))


@functools.lru_cache(maxsize=64)
def _host_args(key: tuple):
    """ctypes arguments for one threshold key: the edges, the sorted
    thresholds and the caller's row of each."""
    th, order = sort_thresholds(key)
    edge = (ctypes.c_float * (N_BINS - 1))(*kernel_edges())
    th_arg = (ctypes.c_float * MAX_THRESHOLDS)(*th)
    slots = (ctypes.c_int * MAX_THRESHOLDS)(*order)
    return edge, th_arg, slots, th.size


def ticket_words(images: int) -> int:
    """The 8-byte words of a launch's tickets, 4 bytes an image."""
    return (images + 1) // 2


def _check_images(fg, per_image):
    """-> (images, voxels an image)."""
    if not per_image:
        return 1, fg.numel()
    if fg.dim() < 2 or fg.shape[0] < 1:
        raise ValueError(f"per_image planes need a leading image axis and an "
                         f"image's voxels, got shape {tuple(fg.shape)}")
    if fg.shape[0] > 65535:
        raise ValueError(f"at most 65535 images a launch, got {fg.shape[0]}")
    return fg.shape[0], fg[0].numel()


def fused_eval_stats(fg, target, prediction, uncertainty, weight, thresholds,
                     per_image: bool = False):
    """One-pass eval sums of one subject, or with ``per_image`` of each of
    the K images of the planes' leading axis (see the reference for the
    result).

    On CUDA: ``fg``/``uncertainty`` float32, ``target``/``prediction``/
    ``weight`` uint8 0/1 (a bool tensor's ``.view(torch.uint8)``), all
    contiguous with equal sizes, the float32 planes 16-byte and the uint8
    planes 8-byte aligned; at most 23 thresholds in any order."""
    if len(thresholds) > MAX_THRESHOLDS:
        raise ValueError(f"at most {MAX_THRESHOLDS} thresholds, got {len(thresholds)}")
    if fg.device.type == "cpu":
        fused_eval_stats.plain_calls += 1
        return fused_eval_stats_reference(fg, target, prediction, uncertainty,
                                          weight, thresholds, per_image)
    if fg.device.type != "cuda":
        raise ValueError(f"fused_eval_stats runs on cuda or cpu, not {fg.device}")
    _check_cuda_inputs(fg, target, prediction, uncertainty, weight)
    images, n = _check_images(fg, per_image)
    lib = _library()
    edge, th_arg, slots, n_th = _host_args(host_args_key(thresholds))
    device = fg.device.index if fg.device.index is not None \
        else torch.cuda.current_device()
    grid = grid_size(n, _wave(device, n_th))  # blocks of each image
    check_lane_counts(n, grid)
    stream = torch.cuda.current_stream(device).cuda_stream
    # the one allocation: the result rows, then the tickets and the blocks'
    # partial rows
    width = _INT_COLS + N_BINS
    out = torch.empty(images * (width + lane_cells(n_th) * grid)
                      + ticket_words(images), dtype=torch.int64,
                      device=fg.device)
    with torch.cuda.device(device):
        err = lib.rcu_fused_eval_stats(
            fg.data_ptr(), uncertainty.data_ptr(), target.data_ptr(),
            prediction.data_ptr(), weight.data_ptr(), n, images, edge, th_arg,
            slots, n_th, out[images * width:].data_ptr(), out.data_ptr(),
            grid, stream)
    if err != 0:
        raise RuntimeError(f"fused_eval_stats launch failed: cudaError {err}")
    fused_eval_stats.launches += 1
    rows = out[:images * width].view(images, width)
    stats = _stats_dict(rows[:, :_INT_COLS],
                        rows[:, _INT_COLS:].view(torch.float64), n_th)
    return stats if per_image else {k: v[0] for k, v in stats.items()}


fused_eval_stats.launches = 0
fused_eval_stats.plain_calls = 0


def _plane(x, dtype):
    """``x`` as the kernel reads a plane: ``dtype`` (a bool plane as its
    uint8 view), contiguous, and on a card aligned for its vector loads
    (a view into another tensor may start anywhere)."""
    if dtype == torch.uint8 and x.dtype == torch.bool:
        x = x.contiguous().view(torch.uint8)
    if x.dtype != dtype:
        raise TypeError(f"expected a {dtype} plane"
                        f"{' or a bool one' if dtype == torch.uint8 else ''}, "
                        f"got {x.dtype}")
    x = x.contiguous()
    if x.device.type == "cuda" and x.data_ptr() % _ALIGN[dtype]:
        x = x.clone()
    return x


def kernel_planes(fg, target, prediction, uncertainty, mask):
    """The five planes of :func:`fused_subject_eval`'s arguments as
    :func:`fused_eval_stats` takes them; ``mask`` None is all ones."""
    target = _plane(target, torch.uint8)
    weight = torch.ones_like(target) if mask is None \
        else _plane(mask, torch.uint8)
    return (_plane(fg, torch.float32), target, _plane(prediction, torch.uint8),
            _plane(uncertainty, torch.float32), weight)


def fused_subject_eval(fg, target, prediction, uncertainty, mask, thresholds,
                       per_image: bool = False):
    """Everything the eval CSVs need from one pass over a subject, or with
    ``per_image`` over each image of the planes' leading axis.

    ``fg`` and ``uncertainty`` float32, ``target``, ``prediction`` and
    ``mask`` bool or uint8 0/1, of any strides (a plane is made what the
    kernel reads). Returns ``(bins, confusion, correction)`` like the JAX
    ``fused_subject_eval``: bins with the proportion-weighted ``ece``;
    confusion with ``n`` and ``dice``; correction a dict of
    ``(len(thresholds),)`` tensors; with ``per_image`` every entry gains a
    leading image axis. ``mask`` (None = all voxels) reaches the ECE bins
    only."""
    with profiling.span("evalstats.launch"):  # the host's enqueue
        stats = fused_eval_stats(
            *kernel_planes(fg, target, prediction, uncertainty, mask),
            thresholds, per_image)
    return subject_eval_from_stats(stats)


def subject_eval_from_stats(stats):
    """``(bins, confusion, correction)`` of :func:`fused_subject_eval`
    from the kernel's sums (:func:`fused_eval_stats`' dict; a mesh adds
    several launches' sums first)."""
    count = stats["bins_count"]
    pos_frac, mean_conf, nonzero = bin_statistics(
        count, stats["bins_conf_sum"], stats["bins_true_sum"])
    proportions = _bin_proportions("proportion", count, nonzero, 1)
    ece = torch.sum(torch.abs(mean_conf - pos_frac) * proportions, dim=-1)
    bins = {"bins_count": count, "bins_avg_confidence": mean_conf,
            "bins_positive_fraction": pos_frac, "bins_non_zero": nonzero,
            "ece": ece}
    tp, tn, fp, fn = stats["tp"], stats["tn"], stats["fp"], stats["fn"]
    confusion = {"tp": tp, "tn": tn, "fp": fp, "fn": fn, "n": tp + tn + fp + fn,
                 "dice": dice_from_counts(tp.float(), fp.float(), fn.float())}
    per_th = stats["thresh_counts"]  # (..., T, 4): tpu, tnu, fpu, fnu
    correction = _correction_from_counts(
        tuple(c[..., None].expand(per_th.shape[:-1]) for c in (tp, tn, fp, fn))
        + tuple(per_th.unbind(-1)))
    return bins, confusion, correction
