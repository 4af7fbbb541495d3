"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the hand-written
kernels, holds each against its plain PyTorch version, then drives the
main path, the BraTS MC-dropout direct eval, at full width.

  python3 chip_smoke.py

Phases (any failure is an uncaught exception and a non-zero exit):
1. device: a CUDA card is required; prints its name and power limit and
   switches TF32 off for the f32 path;
2. build: one ``nvcc`` per kernel source, all started together;
3. kernels: each kernel against its plain version at the main path's
   shapes (a seeded 155x240x240 subject with exact bin-edge and threshold
   values, plus a ragged size); counts must be equal; times with CUDA
   events;
4. main path: ``evaluate_subjects`` over 2 in-memory BraTS-shaped subjects
   with the flagship U-Net (config/train_brats_baseline.yaml: depth 4, 32
   start filters, 4 channels, dropout 0.05) at seeded random weights,
   MC=20 at batch 32 (config/test_brats_baseline_mc.yaml). Before it, one
   deterministic 8-slice batch on the card is held against the CPU;
5. breakdown (information): one MC batch's forward time and convolution
   TFLOP/s, in f32 and with TF32 on; one subject under torch.profiler for
   the device's busy share and its costliest kernels.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""
import copy
import json
import math
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from rcu_tpu_torch.data import nifti
from rcu_tpu_torch.eval.direct import DEFAULT_THRESHOLDS, evaluate_subjects
from rcu_tpu_torch.models import get_model
from rcu_tpu_torch.ops.cuda import build, evalstats

SEED = 20
FLAGSHIP = dict(nb_classes=2, in_channels=4, depth=4, start_filters=32,
                dropout=0.05)
BRATS = (155, 240, 240)
MC_STEPS, BATCH = 20, 32
KERNELS = ("evalstats",)
DEVICE = "cuda"
# H100 memory rates and the SXM part's 67 TFLOP/s f32 peak outside the
# tensor cores (NVIDIA data sheets); the latter bounds the kernel's
# compares and adds
HBM_BYTES_PER_S = {"PCIe": 2.0e12, "SXM": 3.35e12}
F32_OPS_PER_S = 67e12


def log(*args):
    print(*args, flush=True)


def device_phase():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; none is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    part = "PCIe" if "PCIe" in smi else "SXM"
    log(f"bound: H100 {part} memory rate {HBM_BYTES_PER_S[part] / 1e12} TB/s")
    return HBM_BYTES_PER_S[part]


def build_phase():
    t0 = time.perf_counter()
    reports = build.build_all(KERNELS)
    log(f"build: {time.perf_counter() - t0:.1f} s for {list(reports) or 'cached'}")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def seeded_subject(n_or_shape, seed, device):
    """fg/unc/target/prediction/weight planes with exact edge values."""
    rng = np.random.RandomState(seed)
    shape = (n_or_shape,) if isinstance(n_or_shape, int) else n_or_shape
    fg = rng.rand(*shape).astype(np.float32)
    unc = rng.rand(*shape).astype(np.float32)
    flat_fg, flat_unc = fg.reshape(-1), unc.reshape(-1)
    edges = np.float32(np.linspace(0.0, 1.0, 11))
    salt = np.concatenate([edges, np.nextafter(edges, np.float32(2)),
                           np.nextafter(edges, np.float32(-1))])
    idx = rng.choice(flat_fg.size, 1000, replace=False)
    flat_fg[idx] = np.resize(salt, idx.size)
    flat_unc[idx] = np.resize(np.float32(DEFAULT_THRESHOLDS), idx.size)
    target = rng.rand(*shape) < 0.2
    weight = rng.rand(*shape) < 0.6
    planes = (fg, target.view(np.uint8), (fg > 0.5).view(np.uint8), unc,
              weight.view(np.uint8))
    return tuple(torch.from_numpy(np.ascontiguousarray(p)).to(device)
                 for p in planes)


def cuda_ms(fn, reps):
    """Median ms of ``fn`` over ``reps`` calls, each between CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def profiled_kernel_ms(fn, kernel_name, reps=20):
    """Mean device time of the CUDA kernel ``kernel_name`` per call of
    ``fn``, from torch.profiler's CUPTI trace; None when the trace holds
    no such kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for event in prof.key_averages():
        if kernel_name in event.key:
            return event.device_time_total / event.count / 1e3
    return None


def kernel_phase(hbm_rate):
    """fused_eval_stats against its plain version; returns the JSON record
    without the main path's launch count."""
    max_err = 0.0
    for size, seed in ((BRATS, 1), (1_000_003, 2)):
        planes = seeded_subject(size, seed, DEVICE)
        got = evalstats.fused_eval_stats(*planes, DEFAULT_THRESHOLDS)
        again = evalstats.fused_eval_stats(*planes, DEFAULT_THRESHOLDS)
        want = evalstats.fused_eval_stats_reference(*planes, DEFAULT_THRESHOLDS)
        torch.cuda.synchronize()
        for key, value in want.items():
            if not torch.equal(got[key], again[key]):
                raise AssertionError(f"fused_eval_stats {key}: reruns differ")
            if key == "bins_conf_sum":
                # f32 per thread, f64 from the warp sums on, vs a f64 bincount
                err = float((got[key] - value).abs().max())
                torch.testing.assert_close(got[key], value, rtol=1e-5, atol=1e-3)
                max_err = max(max_err, err)
            elif not torch.equal(got[key], value):
                raise AssertionError(f"fused_eval_stats {key}: kernel "
                                     f"{got[key].tolist()} != plain "
                                     f"{value.tolist()} at size {size}")
        log(f"fused_eval_stats size {size}: counts equal, conf-sum max abs "
            f"err {max_err:.3e}")
    planes = seeded_subject(BRATS, 1, DEVICE)
    n = planes[0].numel()
    ms = cuda_ms(lambda: evalstats.fused_eval_stats(*planes, DEFAULT_THRESHOLDS), 30)
    plain_ms = cuda_ms(lambda: evalstats.fused_eval_stats_reference(
        *planes, DEFAULT_THRESHOLDS), 20)
    kernel_ms = profiled_kernel_ms(
        lambda: evalstats.fused_eval_stats(*planes, DEFAULT_THRESHOLDS),
        "fused_eval_stats_kernel")
    n_th = len(DEFAULT_THRESHOLDS)
    bytes_moved = n * (4 + 4 + 1 + 1 + 1)
    # per voxel: 10 edge compares, 1 add, 3 class predicates, 1 compare per
    # threshold; the outputs are a few hundred bytes
    ops = n * (10 + 1 + 3 + n_th)
    bytes_ms, ops_ms = bytes_moved / hbm_rate * 1e3, ops / F32_OPS_PER_S * 1e3
    log(f"fused_eval_stats {BRATS}: {ms:.4f} ms per wrapper call (median of "
        f"30), of which the kernel {kernel_ms} ms (profiler), plain "
        f"{plain_ms:.3f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
        f"({bytes_moved / 1e6:.1f} MB at {hbm_rate / 1e12:.2f} TB/s), "
        f"{bytes_moved / ms / 1e6:.0f} GB/s achieved")
    return {"name": "fused_eval_stats", "route": "cuda",
            "source": "rcu_tpu_torch/csrc/evalstats.cu",
            "replaces": "rcu_tpu/ops/pallas/evalstats.py:97",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


class BratsLikeDataset:
    """Two BraTS-shaped subjects in memory (the SubjectDataset read
    interface): an ellipsoid head with a raw t2 NIfTI for the mask, a
    spherical lesion as the target, four z-scored channels."""

    def __init__(self, tmp_dir, n_subjects=2, seed=SEED):
        self.subjects = [f"synthetic_{i}" for i in range(n_subjects)]
        self._data, self._t2 = {}, {}
        grid = np.ogrid[:BRATS[0], :BRATS[1], :BRATS[2]]
        centre = np.asarray(BRATS) / 2.0
        for i, name in enumerate(self.subjects):
            rng = np.random.RandomState(seed + i)
            head = sum(((g - c) / (f * s)) ** 2 for g, c, s, f in
                       zip(grid, centre, BRATS, (0.45, 0.4, 0.33))) < 1.0
            spot = centre + rng.uniform(-0.15, 0.15, 3) * np.asarray(BRATS)
            lesion = sum(((g - c) / (0.08 * BRATS[1])) ** 2
                         for g, c in zip(grid, spot)) < 1.0
            images = rng.standard_normal(BRATS + (4,)).astype(np.float32)
            images *= head[..., None]
            images[lesion] += 2.0
            t2 = np.where(head, 1.0 + rng.rand(*BRATS), 0.0).astype(np.float32)
            self._t2[name] = os.path.join(tmp_dir, f"{name}_t2.nii.gz")
            nifti.write(t2, self._t2[name])
            self._data[name] = {"images": images,
                                "labels": (lesion & head).astype(np.uint8)}

    def read_volume(self, subject, category):
        return self._data[subject][category]

    def shape(self, subject, category="images"):
        return self._data[subject][category].shape

    def files(self, subject):
        return {"images": {"t2": self._t2[subject]}}


def middle_batch(dataset):
    """The 8 middle slices of the first subject, NCHW on the CPU."""
    volume = dataset.read_volume(dataset.subjects[0], "images")
    mid = volume.shape[0] // 2
    images = volume[max(0, mid - 4):mid + 4]
    return torch.from_numpy(np.ascontiguousarray(images.transpose(0, 3, 1, 2)))


def spread_head(model, dataset):
    """Scale the seeded model's class conv so that the logit difference has
    std 2 on real-looking input: the fg map then spreads over the
    reliability bins instead of sitting at 0.5."""
    with torch.inference_mode():
        logits = model(middle_batch(dataset).to(DEVICE))
        scale = 2.0 / float((logits[:, 1] - logits[:, 0]).std())
        head = getattr(model, f"Conv_{FLAGSHIP['depth']}")
        head.weight.mul_(scale)
        head.bias.mul_(scale)


def gpu_vs_cpu_check(model, dataset):
    """One deterministic 8-slice batch on the card against the CPU; returns
    the batch and the CPU logits."""
    x = middle_batch(dataset)
    cpu_model = get_model("unet", FLAGSHIP)
    cpu_model.load_state_dict(model.state_dict())
    with torch.inference_mode():
        want = cpu_model(x)
        got = model(x.to(DEVICE)).cpu()
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=1e-3, atol=2e-4)
    log(f"deterministic batch {tuple(x.shape)}: card vs CPU logits max abs "
        f"err {err:.3e} (|logits| max {float(want.abs().max()):.3f})")
    return x, want


def main_path_phase(model, dataset, out_dir):
    evalstats.fused_eval_stats.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eces = evaluate_subjects(model, dataset, out_dir, run_id="smoke",
                             mc=MC_STEPS, batch_size=BATCH, seed=SEED,
                             device=DEVICE)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = evalstats.fused_eval_stats.launches
    n = len(dataset.subjects)
    if launches != n:
        raise AssertionError(f"fused_eval_stats launched {launches} times for "
                             f"{n} subjects")
    if not all(math.isfinite(e) for e in eces.values()):
        raise AssertionError(f"non-finite ECE: {eces}")
    names = sorted(os.listdir(out_dir))
    expected = ["eval_calibration_smoke.csv", "eval_ece_smoke.csv",
                "eval_summary_minmax_smoke.csv"] + [
        f"eval_uncertainty_smoke_th{t:.2f}".replace(".", "") + ".csv"
        for t in DEFAULT_THRESHOLDS]
    if sorted(expected) != names:
        raise AssertionError(f"CSV families {names} != {sorted(expected)}")
    for name in names:
        with open(os.path.join(out_dir, name)) as f:
            rows = f.read().strip().splitlines()[1:]
        if len(rows) != (1 if "minmax" in name else n):
            raise AssertionError(f"{name}: {len(rows)} rows")
    voxels = n * int(np.prod(BRATS))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"main path: MC{MC_STEPS} direct eval of {n} subjects {BRATS} in "
        f"{seconds:.2f} s = {seconds / n:.3f} s/subject, "
        f"{voxels / seconds / 1e6:.3f} M voxels/s, peak memory {peak_gb:.2f} GB, "
        f"eces {eces}")
    return launches


def conv_flops_per_image(model):
    """2 x the multiply-adds of every convolution in the forward of one
    BraTS slice, counted from the layers' output shapes."""
    flops = []

    def count(module, inputs, output):
        kh, kw = module.kernel_size
        flops.append(2 * output.numel() * module.in_channels // module.groups
                     * kh * kw)

    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    handles = [m.register_forward_hook(count) for m in convs]
    with torch.inference_mode():
        model(torch.zeros((1, FLAGSHIP["in_channels"]) + BRATS[1:],
                          device=DEVICE))
    for handle in handles:
        handle.remove()
    return sum(flops)


def forward_breakdown(model, dataset, cpu_batch, cpu_logits):
    """Time one MC forward (32 slices x 20 samples) and one deterministic
    forward with CUDA events, in f32 and, for information, with TF32 on
    (its logits error against the CPU beside it)."""
    from rcu_tpu_torch.engine import steps
    from rcu_tpu_torch.eval.pipeline import sample_generators
    images = torch.from_numpy(dataset.read_volume(dataset.subjects[0],
                                                  "images")[:BATCH]).to(DEVICE)

    def mc():
        steps.mc_forward(model, images,
                         sample_generators((SEED, 0), 0, MC_STEPS, DEVICE))

    flops = conv_flops_per_image(model) * MC_STEPS * BATCH
    with torch.inference_mode():
        mc_ms = cuda_ms(mc, 3)
        det_ms = cuda_ms(lambda: steps.predict(model, images), 5)
        torch.backends.cudnn.allow_tf32 = True
        tf32_ms = cuda_ms(mc, 3)
        tf32_err = float((model(cpu_batch.to(DEVICE)).cpu() - cpu_logits)
                         .abs().max())
        torch.backends.cudnn.allow_tf32 = False
    log(f"forward: MC{MC_STEPS} batch of {BATCH} slices ({MC_STEPS * BATCH} "
        f"images) {mc_ms:.1f} ms, {flops / 1e12:.2f} TFLOP of convolutions = "
        f"{flops / mc_ms / 1e9:.1f} TFLOP/s f32; deterministic batch "
        f"{det_ms:.2f} ms")
    log(f"forward with cudnn.allow_tf32=True (information only, not the "
        f"port's setting): MC batch {tf32_ms:.1f} ms = "
        f"{flops / tf32_ms / 1e9:.1f} TFLOP/s; deterministic logits vs CPU "
        f"f32 max abs err {tf32_err:.3e}")


def profile_phase(model, dataset, out_dir):
    """One subject's MC eval under torch.profiler: the device's busy share
    of the wall time and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    one = copy.copy(dataset)
    one.subjects = dataset.subjects[:1]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evaluate_subjects(model, one, out_dir, run_id="profile", mc=MC_STEPS,
                          batch_size=BATCH, seed=SEED, device=DEVICE)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        log("profile: the trace holds no device kernels; busy share not measured")
        return
    busy, reach, by_name = 0.0, -math.inf, {}
    for start, end, name in spans:  # union of the kernel intervals
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        by_name[name] = by_name.get(name, 0.0) + end - start
    log(f"profile: 1 subject MC{MC_STEPS} in {wall_us / 1e6:.3f} s under the "
        f"profiler, device busy {busy / 1e6:.3f} s = "
        f"{100 * busy / wall_us:.1f} %, {len(spans)} kernels")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"  {100 * us / busy:5.1f} %  {us / 1e3:9.2f} ms  {name[:90]}")


def main():
    hbm_rate = device_phase()
    build_phase()
    record = kernel_phase(hbm_rate)
    torch.manual_seed(SEED)
    model = get_model("unet", FLAGSHIP).to(DEVICE)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dataset = BratsLikeDataset(tmp)
        log(f"synthetic data: {time.perf_counter() - t0:.1f} s")
        spread_head(model, dataset)
        cpu_batch, cpu_logits = gpu_vs_cpu_check(model, dataset)
        record["launches"] = main_path_phase(model, dataset,
                                             os.path.join(tmp, "eval"))
        forward_breakdown(model, dataset, cpu_batch, cpu_logits)
        profile_phase(model, dataset, os.path.join(tmp, "profile"))
    log(json.dumps({"kernels": [record]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
