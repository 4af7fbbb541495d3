"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the two
hand-written kernels (``csrc/evalstats.cu``, the fused eval statistics;
``csrc/int8conv.cu``, the int8 convolution), holds each against its plain
PyTorch version, then drives the main path, the BraTS MC-dropout direct
eval, the four other strategy families of the direct eval, the
inference variants, int8 included, the native-2D (ISIC) direct eval,
training, the staged chain, serving, the inference paths on a device
mesh and training on a device mesh, at full width.

  python3 chip_smoke.py

Phases (any failure is an uncaught exception and a non-zero exit):
1. device: a CUDA card is required; prints its name and power limit and
   switches TF32 off for the direct comparisons of the f32 U-Net;
2. build: one ``nvcc`` per kernel source, all started together; the
   compiler's register, shared memory and spill report of each kernel;
   the int8 kernel's SASS must hold wgmma (IGMMA) and TMA loads (UTMALDG);
3. kernels: each kernel against its plain version at the main path's
   shapes (a seeded 155x240x240 subject with exact bin-edge and threshold
   values, the same with unsorted thresholds, and a ragged size); counts
   must be equal and reruns bit-identical; then, on that subject, the
   wrapper call's time (CUDA events; the record's ``ms``), the kernel's
   device time (torch.profiler; ``kernel_ms``, null when the trace holds
   no kernel) and the other device work of a call, the plain version's
   time, the bound, the bound's share of the kernel time
   (``bound_share``), achieved GB/s and occupancy; and the kernel's time
   at half the size and at one block's work, which part its time at the
   full size into a fixed cost and a streaming rate;
4. main path: ``evaluate_subjects`` over 2 in-memory BraTS-shaped subjects
   with the flagship U-Net (config/train_brats_baseline.yaml: depth 4, 32
   start filters, 4 channels, dropout 0.05) at seeded random weights
   (every model's BatchNorm statistics those of its input on the middle
   slices, its class head scaled, centred and antisymmetric), MC=20 at
   batch 32 (config/test_brats_baseline_mc.yaml), called under
   torch's default TF32 flags as a library caller would. Before it, one
   deterministic 8-slice batch on the card is held against the CPU. The
   first subject's eval planes are kept, and the kernel is checked and
   timed on them as in phase 3 (real fg maps pile into bin 0 and tn;
   ``real_planes_ms``, ``real_planes_kernel_ms`` and
   ``real_planes_bound_share`` in the record);
5. breakdown (information): one MC batch's forward time and convolution
   TFLOP/s, in f32 and with TF32 on; one subject under torch.profiler for
   the device's busy share and its costliest kernels;
6. strategies: ``evaluate_subjects`` over the same 2 subjects with each
   family at flagship width and seeded weights (heads scaled and centred
   so that the planes spread over the bins): aleatoric (a sigma-headed
   U-Net, ``is_log_sigma=False`` as in config/test_brats_aleatoric.yaml),
   ensemble (10 members, as config/train_ensemble/ has), auxiliary_feat
   (a segmenter giving its features and a PostNet on them) and
   auxiliary_segm (a 5-channel error net; the labels gain a baseline
   prediction, the lesion dilated). Each family prints seconds per
   subject (CUDA-synced), peak device memory, the kernel's launches and
   the first subject's ECE; its first subject's eval planes (for the
   confidence families the folded and rescaled maps) hold the kernel
   against its plain version and time it; one 2-slice batch on the card
   is held against the CPU (logits, sigma, features, member mean, PostNet
   confidence). Last, the kernel against its plain version on a folded
   plane that is all NaN: a constant confidence rescales 0/0;
7. variants: the JAX package's inference variants on the same weights,
   each loaded through ``eval.direct.model_from_flax`` (BN fold in numpy,
   conversion, precast), through ``evaluate_subjects`` on the same 2
   subjects: deterministic in f32, then MC20 in bf16 and in bf16 with the
   fast decoder, and deterministic, ensemble and auxiliary_feat in bf16
   with the fast decoder and the fold. Each prints s/subject, peak memory,
   launches, the first ECE and the ECE/Dice deltas against the f32 run of
   the same weights; a softmax family (mc, deterministic, ensemble) beyond
   1e-3 fails. The kernel is checked and timed on the bf16 MC planes (f32
   planes), and one bf16 fast-decoder MC20 subject is profiled. One 2-slice
   batch of two bf16 variants on the card is held against the CPU at the
   bar of tests/test_torch_variants.py; one MC batch's forward is timed in
   f32 and bf16 with each decoder rewrite, bf16 in both memory formats
   (TFLOP/s of each variant's own convolutions); a dropout_center=2 MC
   batch with the shared encoder prefix is held against the full forward;
8. int8 (``-quantize``, skip 1): the int8 conv kernel (``wgmma`` fed by
   TMA; the fused up-conv split by output phase) against its plain
   versions at every distinct quantized site shape of the flagship MC
   batch (640 images: each level's two 3x3 shapes, which the split halves
   share, and its fused 4x4 up-conv) and at Cin 4, 45x53, its up-conv at
   23x27 and Cout 29: the int32 mode (``int8_conv``) equal to the float64
   conv, the fused mode (``int8_conv_dequant``: dequantize and bias in the
   epilogue) bitwise its plain version in bf16, bf16 folded (hi and lo), a
   bf16 split pair and f32, reruns bit-identical; each shape's kernel time
   in the bf16 fused mode and the int32 mode (torch.profiler), TOPS, the
   bound with the output in bf16 (int8 in, weights and output at the
   memory rate, or its operations at 1979 TOPS) and the share of it
   reached, cuDNN's bf16 conv of the same shape and the kernel's earlier
   mma.sync design's time; at the level-1 64->64 shape ``F.unfold`` +
   ``torch._int_mm`` (the library figure). Then, through
   ``evaluate_subjects`` after ``_calibrated_quant_model``: MC20 in bf16
   with the fast decoder, deterministic and the 10-member ensemble in bf16
   with the fast decoder and the fold, on briefly trained weights
   (:func:`trained_unet`) against their own f32 runs, and MC20 on the
   seeded weights of the earlier phases (information, not gated): s/subject,
   M voxels/s, peak memory, both kernels' launches, ECE/Dice deltas; a
   path beyond 5e-3 fails the phase once all have run (each says whether
   it meets 1e-3); the int8 MC model on the card is held against the CPU
   on 2 slices, and, on the same slices, one site of each kind (a 3x3
   conv, a split pair, a fused up-conv, and a BN-folded site of the
   deterministic model) runs on the card and on the CPU with the same
   input, scales and weights: output bitwise equal. One int8 MC20 subject
   is profiled;
9. ISIC (native-2D): ``evaluate_subjects`` over 600 seeded 192x256 RGB
   images in memory through config/test_isic_baseline_mc.yaml's rescale,
   32 a chunk, with the ISIC flagship (config/train_isic_baseline.yaml)
   at seeded weights: MC20 and deterministic, aleatoric, the 10-member
   ensemble, auxiliary_feat and auxiliary_segm in f32, MC20 in bf16 with
   the fast decoder, deterministic in bf16 with the fast decoder and the
   fold, and MC20 in bf16 + fast + int8 (information). Each path must
   launch the eval kernel once a chunk (19), never once an image; each
   prints s, images/s, peak memory and the first ECE; the bf16 paths
   their ECE/Dice deltas against f32, whose means over the images past
   5e-3 fail, and their logits on 4 images on the card against the CPU at
   the bf16 bar. The eval kernel's image axis is held against its plain
   version and against one launch an image, and timed; the int8 kernel is
   held against its plain versions at every site shape of the ISIC MC
   chunk and of its tail chunk, and one site of each kind of the ISIC
   int8 model runs bitwise on the card and the CPU; the f32 logits of 4
   images are held against the CPU at the f32 bar;
10. training: ``rcu_tpu_torch.strategies.train_*`` on in-memory stores
   (``memory_stores``: the config's dataset name resolves to them), at
   the width, batch and optimizer of the shipped train configs, with the
   smoke's hooks (a step timer, best + 3 last checkpoints, the validation
   CSV): one epoch of BraTS default (config/train_brats_baseline.yaml; 2
   synthetic 155x240x240 subjects through the none-black selection, the
   third validated), then aleatoric, auxiliary_feat (on the default
   run's best checkpoint) and auxiliary_segm on the slices through the
   lesion, and ISIC default (config/train_isic_baseline.yaml, 96 + 32
   images through its rescale, ISIC validation). Each prints its ms per
   step on one batch after 3 warm-up steps (CUDA-synced), slices or
   images per second, peak memory, first and last loss, validation
   seconds per subject, checkpoint write seconds and MB. The default
   run's best checkpoint goes through ``evaluate_subjects``,
   deterministic and MC20, on the valid subject (the eval kernel once
   each); one train step of each kind at flagship width on 2 slices runs
   on the card and the CPU from the same weights (and in float64 on the
   card as the reference; the bars at ``TRAIN_LOSS_RTOL``); 10 BraTS
   default steps run under torch.profiler (busy share, the 8 costliest
   kernels);
11. staged: the staged chain on the same 2 BraTS subjects (phase 4's,
   in memory through ``memory_stores``; the raw t2 and the ground truth
   as NIfTIs in ``Brats17Collector``'s layout), with the seeded models
   of phases 4 and 6 saved as flax-schema checkpoints by
   ``engine.checkpoint.save_checkpoint``: the test loops of
   ``strategies.TEST_STRATEGIES`` through the shipped
   config/test_brats_{baseline,baseline_mc,aleatoric,ensemble,
   auxiliary_feat,auxiliary_segm}.yaml (batch 32; MC20; 10 members;
   auxiliary_segm's baselines the baseline run's ``_prediction``
   NIfTIs), each a "staged test <id>:" line (s/subject of the loop and
   of its forwards, the NIfTI writes left at ``flush()``, peak GB); then
   ``cli.eval_uncertainty.main`` over each run (minmax first, then
   ece_dice, calib and bnf_ue), each a "staged eval <id>:" line
   (s/subject, its NIfTI reads and device passes, the eval kernel's
   launches: one a pass and subject); the kernel against its plain
   version and timed on the MC run's ece_dice planes (no thresholds) and
   bnf_ue planes; baseline, ensemble and auxiliary_feat through the
   direct eval in its ``eval_tree`` layout on the same weights: the
   planes compared first (bitwise, or their largest difference), then
   the 14 CSVs, counts exact where the planes are bitwise equal and
   otherwise within the voxels that lie that close to a bin edge or a
   threshold or whose prediction differs;
12. serving: the staged phase's checkpoints behind
   ``rcu_tpu_torch.serve.make_http_server`` on 127.0.0.1 (a thread each),
   driven by a stdlib client (``np.savez_compressed`` bodies, urllib) with
   the 2 subjects: MC20 f32 unscored, then scored (target and the t2>0
   mask) from a fresh service at the same request index (the maps
   bitwise the unscored ones); deterministic f32 scored, whose ECE and 11
   correction rows must equal ``evaluate_subjects``' row of the subject,
   counts exact; MC20 in bf16 + fast decoder unscored and scored; MC20 in
   bf16 + fast + int8 (the first request calibrates; the ECE against the
   f32 service's for information); aleatoric scored with the subject's
   sigma range (``volume_sigma_minmax``) as its bounds; the 10-member
   ensemble in f32 and in bf16 + fast + fold, auxiliary_feat and
   auxiliary_segm (the dilated baseline) scored; one per_image request of 32 ISIC images with
   phase 9's ISIC flagship; 4 client threads of 2 deterministic f32
   requests, each answer bitwise the serial one (requests/s); the health
   keys, 400 for a corrupt body and a bad shape, 404 for an unknown path.
   Each request's "serve <path>:" line: the client's encode, round trip
   and decode seconds, the server's npz decode, device (CUDA events) and
   npz encode seconds (its ``Server-Timing`` header), request and response
   MB, peak GB, both kernels' launches (the eval kernel once a scored
   request, never an unscored one; the int8 conv once a quantized site
   and forward);
13. mesh (``rcu_tpu_torch.parallel``): a 2-entry mesh, the machine's first
   two cards where it has them, else ``cuda:0`` twice (a virtual mesh:
   one card and one stream, so its times are the split's overhead, not
   scaling; the "mesh devices" line says which), on the staged phase's
   checkpoints and phase 4's subjects, each path's "mesh <mode> <path>:"
   line (s/subject, peak GB per device, both kernels' launches, ECE/Dice
   against the single device's run of the same weights): MC20 f32 with no
   mesh (the reference), on a one-card mesh, in latency mode (each batch
   split over the devices: the eval kernel once per data device and
   subject) and in throughput mode (a subject a device: once per
   subject; the CSVs byte for byte the reference's); MC20 in bf16 + fast
   + int8 with no mesh and in latency mode (the int8 conv 20 a forward
   and device, 400 for the 2 subjects); the 10-member ensemble in bf16 +
   fast + fold with no mesh and on a 2 x 1 model x data mesh (5 members
   a row); each mesh path's eval planes and every CSV cell against the
   reference: the planes within 1e-5 (f32) or 1e-3 (bf16), the counts
   exact where the planes are bitwise equal, else within the voxels that
   close to a bin edge or threshold, the floats of rows with equal counts
   within 1e-8 past the planes' difference; the sharded eval (one launch per shard, the sums added)
   on the reference's planes against one launch, counts equal, both
   timed (the record's ``sharded``); a throughput-mode service (a pool of
   2) answering 4 client threads of 2 deterministic requests through
   ``predict_timed``, each bitwise the single-device service's;
14. mesh training (``parallel.mesh.shard_train_step``, ``TrainLoop(mesh=)``,
   ``parallel.ensemble.train_ensemble_fused``, ``utils.profiling``) on
   the same 2-entry mesh at flagship width (config/train_brats_baseline
   .yaml, batch 32) on the train phase's stores: one SGD step on the
   mesh against the single device from the same weights, batch and
   generator (the loss within 1e-5, every parameter and BatchNorm
   statistic within rtol 1e-4 / atol 1e-6); one epoch of
   ``strategies.train_default(mesh=)`` with Adam ("mesh train loop":
   ms/step after 3 warm-up steps and the host's enqueue time, slices/s,
   peak GB per device, against phase 10's single-device run; its losses
   and validation dice held to ``MESH_LOOP_LOSS_RTOL`` and
   ``MESH_LOOP_DICE_ATOL``) under a ``ProfilerHook`` of steps 2-4, whose
   Chrome trace must hold CUDA kernels, and 10 profiled mesh steps (busy
   share); the 10 members on a 2 x 1 model x data mesh: member 0's
   first lockstep step against its solo step at the SGD bar (and the
   solo step rerun, the control of cuDNN's order), a lockstep step of
   the 10 against 10 solo steps, then ``train_ensemble_fused`` for one
   epoch, each member's best checkpoint through ``eval.direct.load_model``
   bitwise its state; the practical HBM rate
   (``measure_practical_hbm``), which gives the eval kernel's record a
   second bound (``practical_bound_ms``), and the ring over the mesh
   devices (``measure_practical_ici``; on a virtual mesh an on-card
   copy). Training launches neither hand kernel.

Every path runs with both kernels' launch counts set to 0 before it and
read after it, and fails unless it launched the eval kernel once per
subject (a staged eval: once a pass and subject; a staged test loop:
never; a latency mesh: once per data device and subject; mesh training:
never) and the int8 conv once per quantized site and forward (a latency
mesh: and device; never on a path that quantizes nothing, never its
plain version). The last three lines are the training phases' numbers
(JSON: ``training``, ``mesh_training``), the kernels' JSON records
(``fused_eval_stats`` and ``int8_conv``; ``launches``: the sum over the
paths, ``by_path``: each path's launches and numbers, the mesh paths
as ``mesh_<mode>_<path>``; ``sharded``: the sharded eval's times;
``practical_bound_ms``: the eval kernel's bound at the measured HBM
rate; the int8 record's ``sites``: each site shape's numbers) and
``{"ok": true, "device": {...}}``.
"""
import concurrent.futures
import contextlib
import copy
import csv
import io
import json
import math
import os
import re
import subprocess
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

from rcu_tpu_torch.data import nifti
from rcu_tpu_torch.engine import hooks as train_hooks
from rcu_tpu_torch.engine import steps
from rcu_tpu_torch.eval.device import fp32_switches
from rcu_tpu_torch.eval.direct import (DEFAULT_THRESHOLDS,
                                       _calibrated_quant_model,
                                       evaluate_subjects, model_from_flax)
from rcu_tpu_torch.models import FAST_DECODER_KWARGS, get_model
from rcu_tpu_torch.models.convert import flax_from_state_dict
from rcu_tpu_torch.models.unet import ConvBnRelu, upsample_conv
from rcu_tpu_torch.eval import pipeline
from rcu_tpu_torch.eval.pipeline import sample_generators
from rcu_tpu_torch.ops import prepare
from rcu_tpu_torch.ops.cuda import build, evalstats, int8conv

SEED = 20
FLAGSHIP = dict(nb_classes=2, in_channels=4, depth=4, start_filters=32,
                dropout=0.05)
BRATS = (155, 240, 240)
MC_STEPS, BATCH = 20, 32
MEMBERS = 10  # config/train_ensemble/train_brats_ensemble_{0..9}.yaml
KERNELS = ("evalstats", "int8conv")
DEVICE = "cuda"
# H100 memory rates and the SXM part's 67 TFLOP/s f32 peak outside the
# tensor cores (NVIDIA data sheets); the latter bounds the kernel's
# compares and adds
HBM_BYTES_PER_S = {"PCIe": 2.0e12, "SXM": 3.35e12}
F32_OPS_PER_S = 67e12


def log(*args):
    print(*args, flush=True)


def full_float32():
    """Every switch that lets cuDNN or cuBLAS round float32 to TF32 off,
    for the rest of the run (``eval.device.full_float32`` within a
    block)."""
    for holder, name, value in fp32_switches():
        setattr(holder, name, value)


def device_phase():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; none is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    full_float32()
    conv = getattr(torch.backends.cudnn, "conv", None)
    log(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.conv.fp32_precision="
        f"{getattr(conv, 'fp32_precision', 'n/a')} "
        f"cuda.matmul.fp32_precision="
        f"{getattr(torch.backends.cuda.matmul, 'fp32_precision', 'n/a')} "
        f"torch {torch.__version__} cuda {torch.version.cuda} cudnn "
        f"{torch.backends.cudnn.version()}")
    part = "PCIe" if "PCIe" in smi else "SXM"
    log(f"bound: H100 {part} memory rate {HBM_BYTES_PER_S[part] / 1e12} TB/s")
    return HBM_BYTES_PER_S[part]


def ptxas_summaries(report):
    """{kernel function: "registers ...; spills ..."} from ``-Xptxas -v``."""
    summaries, function = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            function = line.split("'")[1]
        elif function and ("registers" in line or "spill" in line):
            text = line.split("ptxas info    : ", 1)[-1].strip()
            summaries[function] = "; ".join(
                filter(None, (summaries.get(function), text)))
    return summaries


def build_phase():
    """Builds the kernels; returns {name: {kernel function: ptxas summary}}."""
    t0 = time.perf_counter()
    built = build.build_all(KERNELS)
    log(f"build: {time.perf_counter() - t0:.1f} s for {list(built) or 'cached'}")
    summaries = {}
    for name in KERNELS:
        summaries[name] = ptxas_summaries(build.report(name))
        for function, summary in sorted(summaries[name].items()):
            log(f"  {name} {function[-60:]}: {summary}")
    hopper = sass_opcodes("int8conv", ("IGMMA", "UTMALDG", "SYNCS"))
    log(f"  int8conv SASS: {hopper} (wgmma, TMA loads, mbarrier operations)")
    if not (hopper["IGMMA"] and hopper["UTMALDG"]):
        raise AssertionError("int8conv.cu compiled without wgmma or TMA")
    return summaries


def sass_opcodes(name, prefixes):
    """{prefix: instructions whose opcode starts with it} in the SASS of
    the library built from ``csrc/<name>.cu`` (``cuobjdump`` beside
    ``nvcc``)."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", build.library_path(name)],
                          capture_output=True, text=True, check=True).stdout
    opcodes = re.findall(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", sass)
    return {prefix: sum(op.startswith(prefix) for op in opcodes)
            for prefix in prefixes}


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


def profiled_ms(fn, reps=20):
    """{device activity (kernel, memset): its mean device ms per run}, from
    torch.profiler's CUPTI trace of ``reps`` calls of ``fn``, each of which
    runs it once; the mean is over the runs that the trace holds, which
    may drop some."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {event.key: event.device_time_total / event.count / 1e3
            for event in prof.key_averages() if event.device_time_total > 0}


def kernel_ms(times, kernel_name="fused_eval_stats_kernel"):
    """The kernel's ms per call in ``profiled_ms``'s result; None when the
    trace holds no such kernel."""
    return next((ms for key, ms in times.items() if kernel_name in key), None)


def check_kernel(planes, thresholds, label):
    """fused_eval_stats against its plain version: equal counts, sums at
    rtol 1e-5 / atol 1e-3, bit-identical reruns; returns the sums' max abs
    error."""
    got = evalstats.fused_eval_stats(*planes, thresholds)
    again = evalstats.fused_eval_stats(*planes, thresholds)
    want = evalstats.fused_eval_stats_reference(*planes, thresholds)
    torch.cuda.synchronize()
    err = 0.0
    for key, value in want.items():
        bits = (lambda x: x.view(torch.int64)) if value.is_floating_point() \
            else (lambda x: x)
        if not torch.equal(bits(got[key]), bits(again[key])):
            raise AssertionError(f"fused_eval_stats {key}: reruns differ")
        if key == "bins_conf_sum":
            # f32 per lane, f64 from the block sums on, vs a f64 bincount;
            # a NaN confidence makes its bin's sum NaN on both sides
            diff = (got[key] - value).abs()[~(got[key].isnan() & value.isnan())]
            err = float(diff.max()) if diff.numel() else 0.0
            torch.testing.assert_close(got[key], value, rtol=1e-5, atol=1e-3,
                                       equal_nan=True)
        elif not torch.equal(got[key], value):
            raise AssertionError(f"fused_eval_stats {key}: kernel "
                                 f"{got[key].tolist()} != plain "
                                 f"{value.tolist()} on {label}")
    log(f"fused_eval_stats {label}: counts equal, reruns bit-identical, "
        f"conf-sum max abs err {err:.3e}")
    return err


def size_sweep(planes, th):
    """The kernel's time at the full size, at half of it and at one block's
    work: the streaming rate between the first two, and the fixed cost
    that no size removes."""
    flat = [p.reshape(-1) for p in planes]
    n = flat[0].numel()
    sizes = (n, n // 2, evalstats.THREADS * evalstats.VOXELS_PER_THREAD)
    ms = [kernel_ms(profiled_ms(
        lambda m=m: evalstats.fused_eval_stats(*[p[:m] for p in flat], th)))
        for m in sizes]
    if None in ms:
        log("fused_eval_stats size sweep: the trace holds no kernel; not measured")
        return
    rate = (sizes[0] - sizes[1]) * 11 / (ms[0] - ms[1]) / 1e6
    log(f"fused_eval_stats size sweep (torch.profiler, mean of 20): {ms[0]} ms "
        f"at {sizes[0]:,} voxels, {ms[1]} ms at {sizes[1]:,}: {rate:.0f} GB/s "
        f"between them; {ms[2]} ms for one block's {sizes[2]:,} voxels")


def time_kernel(planes, label, hbm_rate, ptxas, th=DEFAULT_THRESHOLDS):
    """Wrapper, kernel and plain times on one plane set, beside the bound:
    the record's ``ms`` (the wrapper call, CUDA events), ``kernel_ms``
    (torch.profiler) and ``bound_share`` (bound / kernel time)."""
    n = planes[0].numel()

    def call():
        evalstats.fused_eval_stats(*planes, th)

    wrapper_ms = cuda_ms(call, 30)
    plain_ms = cuda_ms(lambda: evalstats.fused_eval_stats_reference(*planes, th), 10)
    for _ in range(2):  # a trace may hold none of the kernel's launches
        device_ms = profiled_ms(call)
        kernel = kernel_ms(device_ms)
        if kernel is not None:
            break
    others = {key: ms for key, ms in device_ms.items()
              if "fused_eval_stats_kernel" not in key}
    bytes_moved = n * (4 + 4 + 1 + 1 + 1)
    # per voxel: 9 edge compares, 1 add, 3 class predicates, 1 compare per
    # threshold; the outputs are a thousand bytes
    ops = n * (9 + 1 + 3 + len(th))
    bytes_ms, ops_ms = bytes_moved / hbm_rate * 1e3, ops / F32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    device = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_sm, shared = evalstats.occupancy(device, len(th))
    (summary,) = ptxas.values()
    share = None if kernel is None else bound_ms / kernel
    rate = "not measured" if kernel is None else \
        f"{bytes_moved / kernel / 1e6:.0f} GB/s achieved, {share:.3f} of the bound"
    log(f"fused_eval_stats {label}: wrapper call {wrapper_ms:.4f} ms (CUDA "
        f"events, median of 30), kernel {kernel} ms (torch.profiler, mean of "
        f"20; other device work a call {others}), plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.4f} ms ({bytes_moved / 1e6:.1f} MB at "
        f"{hbm_rate / 1e12:.2f} TB/s), {rate}; {per_sm} blocks of "
        f"{evalstats.THREADS} per SM x {sms} SMs, {shared} B of dynamic shared "
        f"memory a block; ptxas: {summary}")
    return {"ms": wrapper_ms, "kernel_ms": kernel, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_share": share}


def kernel_phase(hbm_rate, ptxas):
    """fused_eval_stats against its plain version and timed on the seeded
    uniform subject; returns the JSON record without the main path's
    launch count and the real planes' numbers."""
    unsorted = DEFAULT_THRESHOLDS[::-1] + (0.5,)
    planes = seeded_subject(BRATS, 1, DEVICE)
    max_err = max(check_kernel(planes, DEFAULT_THRESHOLDS, f"uniform {BRATS}"),
                  check_kernel(planes, unsorted,
                               f"uniform {BRATS}, unsorted thresholds"),
                  check_kernel(seeded_subject(1_000_003, 2, DEVICE),
                               DEFAULT_THRESHOLDS, "uniform 1,000,003"))
    record = {"name": "fused_eval_stats", "route": "cuda",
              "source": "rcu_tpu_torch/csrc/evalstats.cu",
              "replaces": "rcu_tpu/ops/pallas/evalstats.py:97",
              "launches": None, "max_abs_err": max_err}
    record.update(time_kernel(planes, f"uniform {BRATS}", hbm_rate, ptxas))
    size_sweep(planes, DEFAULT_THRESHOLDS)
    record["library_ms"] = None
    return record


class BratsLikeDataset:
    """Two BraTS-shaped subjects in memory (the SubjectDataset read
    interface): an ellipsoid head with a raw t2 NIfTI for the mask, a
    spherical lesion as the target, four z-scored channels. The variant of
    :meth:`with_baseline` gives [target, baseline prediction] labels, the
    baseline a dilated lesion, as auxiliary_segm stores hold them."""

    def __init__(self, tmp_dir, n_subjects=2, seed=SEED):
        self.subjects = [f"synthetic_{i}" for i in range(n_subjects)]
        self._data, self._t2 = {}, {}
        self._labels_with_baseline = False
        grid = np.ogrid[:BRATS[0], :BRATS[1], :BRATS[2]]
        centre = np.asarray(BRATS) / 2.0
        for i, name in enumerate(self.subjects):
            rng = np.random.RandomState(seed + i)
            head = sum(((g - c) / (f * s)) ** 2 for g, c, s, f in
                       zip(grid, centre, BRATS, (0.45, 0.4, 0.33))) < 1.0
            spot = centre + rng.uniform(-0.15, 0.15, 3) * np.asarray(BRATS)
            lesion = sum(((g - c) / (0.08 * BRATS[1])) ** 2
                         for g, c in zip(grid, spot)) < 1.0
            dilated = sum(((g - c) / (0.1 * BRATS[1])) ** 2
                          for g, c in zip(grid, spot)) < 1.0
            images = rng.standard_normal(BRATS + (4,)).astype(np.float32)
            images *= head[..., None]
            images[lesion] += 2.0
            t2 = np.where(head, 1.0 + rng.rand(*BRATS), 0.0).astype(np.float32)
            self._t2[name] = os.path.join(tmp_dir, f"{name}_t2.nii.gz")
            nifti.write(t2, self._t2[name])
            self._data[name] = {"images": images,
                                "labels": (lesion & head).astype(np.uint8),
                                "baseline": (dilated & head).astype(np.uint8)}

    def with_baseline(self):
        """The same subjects with [target, baseline] labels."""
        view = copy.copy(self)
        view._labels_with_baseline = True
        return view

    def read_volume(self, subject, category):
        data = self._data[subject]
        if category == "labels" and self._labels_with_baseline:
            return np.stack([data["labels"], data["baseline"]], axis=-1)
        return data[category]

    def read_slice(self, subject, index, category):
        data = self._data[subject]
        if category == "labels" and self._labels_with_baseline:
            return np.stack([data["labels"][index], data["baseline"][index]],
                            axis=-1)
        return data[category][index]

    def shape(self, subject, category="images"):
        shape = self._data[subject][category].shape
        if category == "labels" and self._labels_with_baseline:
            return shape + (2,)
        return shape

    def dtype(self, subject, category="images"):
        return self._data[subject][category].dtype

    def categories(self, subject=None):
        return ["images", "labels"]

    def properties(self, subject):
        return nifti.ImageProperties(size=BRATS[::-1])

    def files(self, subject):
        return {"images": {"t2": self._t2[subject]}}

    def subset(self, names, path):
        """The subjects ``names`` as a store of their own at ``path``
        (the index cache's key and directory)."""
        view = copy.copy(self)
        view.subjects = view.subject_subset = list(names)
        view.dataset_path = path
        return view


def middle_batch(dataset):
    """The 8 middle slices of the first subject, NCHW on the CPU."""
    volume = dataset.read_volume(dataset.subjects[0], "images")
    mid = volume.shape[0] // 2
    images = volume[max(0, mid - 4):mid + 4]
    return torch.from_numpy(np.ascontiguousarray(images.transpose(0, 3, 1, 2)))


def calibrate_bn(model, x):
    """Set every BatchNorm's running statistics to those of its conv's
    output on the batch ``x``, layer by layer in one forward (no gradient
    step): the activations are then normalised as in a trained model, and
    the bf16 variants' rounding is measured against a signal of the size
    that a trained model's has."""
    def hook(layer, args):
        inputs = args[0]
        if isinstance(inputs, tuple):
            inputs = torch.cat(inputs, dim=1)
        conv = layer.Conv_0
        y = torch.nn.functional.conv2d(inputs, conv.weight, conv.bias,
                                       padding=conv.padding)
        layer.BatchNorm_0.running_mean.copy_(y.mean((0, 2, 3)))
        layer.BatchNorm_0.running_var.copy_(y.var((0, 2, 3), unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, ConvBnRelu)]
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for handle in handles:
            handle.remove()


def seeded_unet(seed, x, **options):
    """A flagship-width U-Net with seeded weights, its BatchNorms
    calibrated on ``x`` and its class head centred (:func:`centre_head`)."""
    torch.manual_seed(seed)
    model = get_model("unet", {**FLAGSHIP, **options}).to(DEVICE)
    calibrate_bn(model, x)
    centre_head(lambda v: model(v).logits,
                getattr(model, f"Conv_{FLAGSHIP['depth']}"), x)
    return model


def gpu_vs_cpu_check(model, dataset):
    """One deterministic 8-slice batch on the card against the CPU; returns
    the batch and the CPU logits."""
    x = middle_batch(dataset)
    cpu_model = get_model("unet", FLAGSHIP)
    cpu_model.load_state_dict(model.state_dict())
    with torch.inference_mode():
        want = cpu_model(x).logits
        got = model(x.to(DEVICE)).logits.cpu()
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=1e-3, atol=2e-4)
    log(f"deterministic batch {tuple(x.shape)}: card vs CPU logits max abs "
        f"err {err:.3e} (|logits| max {float(want.abs().max()):.3f})")
    return x, want


def run_path(dataset, out_dir, models, run_id, int8_launches=0,
             eval_launches=None, keep=None, **kwargs):
    """``evaluate_subjects`` with both kernels' launch counts set to 0
    before it and read after it; the path fails unless it launched the
    eval kernel once per subject (or ``eval_launches`` times: a latency
    mesh launches once per data device and subject) and the int8 conv
    ``int8_launches`` times (never its plain version), and every ECE is
    finite. Returns (launches, seconds, eces, the first subject's eval
    planes (ECE plane, target, prediction, uncertainty, mask); none on a
    mesh that splits the subject). With ``keep`` (a list) every subject's
    planes are appended to it: per device, its (ECE plane, prediction,
    uncertainty) as the eval read them."""
    planes = []
    subject_eval = pipeline.fused_subject_eval
    sharded_eval = pipeline.sharded_subject_eval

    def keep_planes(*args, **kwargs):
        if not planes:
            planes.extend(evalstats.kernel_planes(*args[:5]))
        if keep is not None:
            keep.append([(args[0], args[2], args[3])])
        return subject_eval(*args, **kwargs)

    def keep_shards(shards, *args, **kwargs):
        if keep is not None:
            keep.append([None if p is None else (p[0], p[2], p[3])
                         for p in shards])
        return sharded_eval(shards, *args, **kwargs)

    pipeline.fused_subject_eval = keep_planes
    pipeline.sharded_subject_eval = keep_shards
    evalstats.fused_eval_stats.launches = 0
    int8conv.int8_conv.launches = 0
    plain_int8 = int8conv.int8_conv.plain_calls
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        eces = evaluate_subjects(models, dataset, out_dir, run_id=run_id,
                                 batch_size=BATCH, seed=SEED, device=DEVICE,
                                 **kwargs)
        torch.cuda.synchronize()
    finally:
        pipeline.fused_subject_eval = subject_eval
        pipeline.sharded_subject_eval = sharded_eval
    seconds = time.perf_counter() - t0
    launches = evalstats.fused_eval_stats.launches
    n = len(dataset.subjects)
    if launches != (n if eval_launches is None else eval_launches):
        raise AssertionError(f"{run_id}: fused_eval_stats launched {launches} "
                             f"times for {n} subjects (expected "
                             f"{eval_launches or n})")
    if (int8conv.int8_conv.launches != int8_launches
            or int8conv.int8_conv.plain_calls != plain_int8):
        raise AssertionError(
            f"{run_id}: int8_conv launched {int8conv.int8_conv.launches} "
            f"times (expected {int8_launches}), its plain version "
            f"{int8conv.int8_conv.plain_calls - plain_int8} times")
    if not all(math.isfinite(e) for e in eces.values()):
        raise AssertionError(f"{run_id}: non-finite ECE: {eces}")
    return launches, seconds, eces, planes


def check_csvs(out_dir, run_id, result_id, n):
    """The CSV families of a run: result-id files with a row per subject,
    the minmax summary under the bare run id with one row."""
    names = sorted(os.listdir(out_dir))
    expected = [f"eval_calibration_{result_id}.csv", f"eval_ece_{result_id}.csv",
                f"eval_summary_minmax_{run_id}.csv"] + [
        f"eval_uncertainty_{result_id}_th{t:.2f}".replace(".", "") + ".csv"
        for t in DEFAULT_THRESHOLDS]
    if sorted(expected) != names:
        raise AssertionError(f"CSV families {names} != {sorted(expected)}")
    for name in names:
        with open(os.path.join(out_dir, name)) as f:
            rows = f.read().strip().splitlines()[1:]
        if len(rows) != (1 if "minmax" in name else n):
            raise AssertionError(f"{name}: {len(rows)} rows")


def main_path_phase(model, dataset, out_dir):
    """Returns the kernel's launches in the run and the first subject's
    eval planes (fg, target, prediction, entropy / ln 2, mask)."""
    # torch's defaults, as a library caller has them: evaluate_subjects
    # runs the f32 U-Net in full float32 all the same
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    launches, seconds, eces, planes = run_path(dataset, out_dir, model,
                                               "smoke", mc=MC_STEPS)
    if not (torch.backends.cudnn.allow_tf32
            and torch.backends.cuda.matmul.allow_tf32):
        raise AssertionError("evaluate_subjects did not restore the TF32 flags")
    full_float32()
    n = len(dataset.subjects)
    check_csvs(out_dir, "smoke", "smoke", n)
    voxels = n * int(np.prod(BRATS))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"main path: MC{MC_STEPS} direct eval of {n} subjects {BRATS} in "
        f"{seconds:.2f} s = {seconds / n:.3f} s/subject, "
        f"{voxels / seconds / 1e6:.3f} M voxels/s, peak memory {peak_gb:.2f} GB, "
        f"eces {eces}")
    return launches, planes


def conv_flops_per_image(model):
    """2 x the multiply-adds of every convolution (plain or transposed) in
    the forward of one BraTS slice, as torch's FLOP counter counts them."""
    from torch.utils.flop_counter import FlopCounterMode
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        model(torch.zeros((1, FLAGSHIP["in_channels"]) + BRATS[1:],
                          device=DEVICE))
    return counter.get_total_flops()


def forward_breakdown(model, dataset, cpu_batch, cpu_logits):
    """Time one MC forward (32 slices x 20 samples) and one deterministic
    forward with CUDA events, in f32 and, for information, with TF32 on
    (its logits error against the CPU beside it)."""
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
        tf32_err = float((model(cpu_batch.to(DEVICE)).logits.cpu() - cpu_logits)
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


def profile_phase(models, dataset, out_dir, label=f"MC{MC_STEPS}",
                  subjects=1, batch=BATCH, **options):
    """The eval of the first ``subjects`` subjects (or images) under
    torch.profiler (the MC path's unless ``options`` name another
    strategy): the device's busy share of the wall time and the kernels
    that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    one = copy.copy(dataset)
    one.subjects = dataset.subjects[:subjects]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evaluate_subjects(models, one, out_dir, run_id="profile",
                          batch_size=batch, seed=SEED, device=DEVICE,
                          **(options or {"mc": MC_STEPS}))
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
    log(f"profile: {subjects} {'subject' if subjects == 1 else 'subjects'} "
        f"{label} in {wall_us / 1e6:.3f} s under the "
        f"profiler, device busy {busy / 1e6:.3f} s = "
        f"{100 * busy / wall_us:.1f} %, {len(spans)} kernels")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"  {100 * us / busy:5.1f} %  {us / 1e3:9.2f} ms  {name[:90]}")


FAMILIES = (("aleatoric", "_globalrescale"), ("ensemble", ""),
            ("auxiliary_feat", "_rescale"), ("auxiliary_segm", "_rescale"))


def error_net_batch(dataset):
    """``middle_batch`` with the baseline prediction as a 5th channel."""
    labels = dataset.with_baseline().read_volume(dataset.subjects[0], "labels")
    mid = labels.shape[0] // 2
    base = labels[max(0, mid - 4):mid + 4, ..., 1].astype(np.float32)
    return torch.cat([middle_batch(dataset), torch.from_numpy(base[:, None])],
                     dim=1)


def centre_head(forward, head, x, std=2.0):
    """Scale and shift the 1x1 class conv ``head`` so that the logit
    difference of ``forward(x)`` has median 0 and standard deviation
    ``std`` (seeded weights give near-constant maps, which would fill a bin
    or two and predict one class), and make it antisymmetric: the two
    logits are minus and plus half the difference, the same softmax with
    no common part for bf16 to round at the logits' size."""
    with torch.inference_mode():
        logits = forward(x)
        diff = logits[:, 1] - logits[:, 0]
        scale = std / float(diff.std())
        shift = scale * float(diff.median())
        half_w = (head.weight[1] - head.weight[0]) * (scale / 2)
        half_b = ((head.bias[1] - head.bias[0]) * scale - shift) / 2
        head.weight.copy_(torch.stack([-half_w, half_w]))
        head.bias.copy_(torch.stack([-half_b, half_b]))


POSTNET = dict(nb_classes=2, in_channels=FLAGSHIP["start_filters"])


def strategy_models(dataset):
    """{family: what evaluate_subjects takes}, seeded, flagship width."""
    x = middle_batch(dataset).to(DEVICE)
    segmenter = seeded_unet(SEED + 30, x, provide_features=True)
    torch.manual_seed(SEED + 31)
    postnet = get_model("postnet", POSTNET).to(DEVICE)
    with torch.inference_mode():
        features = segmenter(x).features
    calibrate_bn(postnet, features)
    centre_head(lambda v: postnet(v).logits, postnet.Conv_0, features)
    return {"aleatoric": seeded_unet(SEED + 1, x, sigma_out=True),
            "ensemble": [seeded_unet(SEED + 10 + k, x) for k in range(MEMBERS)],
            "auxiliary_feat": (segmenter, postnet),
            "auxiliary_segm": seeded_unet(
                SEED + 40, error_net_batch(dataset).to(DEVICE), in_channels=5)}


def family_outputs(name, models, x):
    """What the family's models give for one batch: logits, sigma,
    features, the member-mean softmax, the PostNet's confidence."""
    if name == "ensemble":
        total = None
        for member in models:
            probs = torch.softmax(member(x).logits, dim=1)
            total = probs if total is None else total + probs
        return {"member mean": total / len(models)}
    if name == "auxiliary_feat":
        segmenter, postnet = models
        out = segmenter(x)
        return {"logits": out.logits, "features": out.features,
                "confidence": torch.softmax(postnet(out.features).logits,
                                            dim=1)[:, 1]}
    out = models(x)
    return {"logits": out.logits} if out.sigma is None else \
        {"logits": out.logits, "sigma": out.sigma}


def card_vs_cpu(name, models, x):
    """The family's outputs for a 2-slice batch on the card against the
    CPU at the f32 bar (TF32 off); returns the max abs error."""
    def to_cpu(m):
        if isinstance(m, torch.nn.Module):
            return copy.deepcopy(m).cpu()
        return type(m)(to_cpu(k) for k in m)

    with torch.inference_mode():
        want = family_outputs(name, to_cpu(models), x)
        got = family_outputs(name, models, x.to(DEVICE))
    errs = {}
    for key, value in want.items():
        errs[key] = float((got[key].cpu() - value).abs().max())
        torch.testing.assert_close(got[key].cpu(), value, rtol=1e-3, atol=2e-4)
    log(f"strategy {name}: card vs CPU on {tuple(x.shape)}, max abs err "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    return max(errs.values())


def nan_plane_check(planes):
    """A constant confidence rescales 0/0: the kernel against its plain
    version on the folded and rescaled planes, NaN at every voxel."""
    _, target, prediction, _, mask = planes
    rescaled = prepare.rescale_subject_min_max(
        torch.full(target.shape, 0.3, device=target.device))
    folded = prepare.uncertainty_to_foreground_probabilities(rescaled,
                                                             prediction)
    if not folded.isnan().all():
        raise AssertionError("a constant confidence did not rescale to NaN")
    return check_kernel((folded, target, prediction, rescaled, mask),
                        DEFAULT_THRESHOLDS, f"all-NaN folded plane {BRATS}")


def strategies_phase(dataset, tmp, hbm_rate, ptxas):
    """Each family's run, its kernel checks and timing, and its card
    against the CPU; returns ({family: its by_path record}, the kernel
    checks' max abs error, {family: its models})."""
    t0 = time.perf_counter()
    models = strategy_models(dataset)
    log(f"strategy models: {time.perf_counter() - t0:.1f} s")
    batches = {"plain": middle_batch(dataset)[3:5],
               "error net": error_net_batch(dataset)[3:5]}
    n = len(dataset.subjects)
    by_path, errs = {}, []
    for name, suffix in FAMILIES:
        data = dataset.with_baseline() if name == "auxiliary_segm" else dataset
        out_dir = os.path.join(tmp, name)
        options = {"is_log_sigma": False} if name == "aleatoric" else {}
        launches, seconds, eces, planes = run_path(
            data, out_dir, models[name], name, strategy=name, **options)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check_csvs(out_dir, name, name + suffix, n)
        first = eces[dataset.subjects[0]]
        log(f"strategy {name}: {n} subjects {BRATS} in {seconds:.2f} s = "
            f"{seconds / n:.3f} s/subject (CUDA-synced), peak memory "
            f"{peak_gb:.2f} GB, fused_eval_stats launches {launches}, first "
            f"subject's ECE {first:.6f}")
        label = f"{name} planes of {dataset.subjects[0]} {BRATS}"
        errs.append(check_kernel(planes, DEFAULT_THRESHOLDS, label))
        timed = time_kernel(planes, label, hbm_rate, ptxas)
        if name == "auxiliary_feat":
            errs.append(nan_plane_check(planes))
        del planes
        if name in ("ensemble", "auxiliary_segm"):
            profile_phase(models[name], data, os.path.join(tmp, "profile_" + name),
                          label=name, strategy=name)
        if name == "auxiliary_segm":
            # the second subject's read overlaps the first's device work
            profile_phase(models[name], data,
                          os.path.join(tmp, "profile2_" + name), label=name,
                          subjects=2, strategy=name)
        cpu_err = card_vs_cpu(name, models[name], batches[
            "error net" if name == "auxiliary_segm" else "plain"])
        by_path[name] = {"launches": launches, "s_per_subject": seconds / n,
                         "peak_gb": peak_gb, "first_ece": first,
                         "card_vs_cpu_max_abs_err": cpu_err,
                         **{k: timed[k] for k in ("ms", "kernel_ms",
                                                  "plain_ms", "bound_share")}}
    return by_path, max(errs), models


# the JAX package's production variants (``rcu_tpu.eval.direct``'s flags)
BF16 = dict(dtype="bfloat16")
BF16_FAST = dict(BF16, fast_decoder=True)
BF16_FAST_FOLD = dict(BF16_FAST, fold_bn=True)
GATE = 1e-3  # ECE/Dice of a softmax family against f32 (tests/test_bf16_parity.py)
BF16_STEP = 2.0 ** -8


def bf16_bar(depth, split, scale):
    """tests/test_torch_variants.py's bound on two bf16 forwards: one bf16
    step (2^-8 relative) of the output's scale for each rounding from the
    input to the logits (the input cast, each ConvBnRelu's conv and
    BatchNorm outputs, each up-conv and split add, the class conv)."""
    roundings = 1 + 2 * (4 * depth + 3) + depth * (2 if split else 1) + 1
    return roundings * BF16_STEP * scale


def variant_of(model, model_type, record, **flags):
    """The port's loader (``eval.direct.model_from_flax``) on the f32
    model's weights as a flax tree: the variant that a checkpoint of these
    weights loads as (fold in numpy f32, conversion, precast)."""
    return model_from_flax(model_type, record,
                           *flax_from_state_dict(model.state_dict()), DEVICE,
                           **flags)


def ece_dice(out_dir, result_id):
    """{subject: (ECE, Dice)} of a run's ece CSV."""
    with open(os.path.join(out_dir, f"eval_ece_{result_id}.csv")) as f:
        rows = list(csv.reader(f))
    ece, dice = rows[0].index("ece"), rows[0].index("dice")
    return {r[1]: (float(r[ece]), float(r[dice])) for r in rows[1:]}


class Unshared(torch.nn.Module):
    """A model with its dropout-free encoder prefix hidden: ``mc_forward``
    then runs the full T*B forward."""

    def __init__(self, model):
        super().__init__()
        self.model = model
        self.dtype = model.dtype

    def forward(self, x, generators=None):
        return self.model(x, generators)


def variant_breakdown(flagship, dataset):
    """One MC batch's forward (32 slices x 20 samples, the model call
    alone, CUDA events) and its convolution TFLOP/s (each variant's own
    FLOPs) in f32, and in bf16 with each decoder rewrite and in both
    memory formats, all in this call; one deterministic batch with and
    without the fold."""
    images = torch.from_numpy(dataset.read_volume(dataset.subjects[0],
                                                  "images")[:BATCH]).to(DEVICE)
    nchw = torch.cat([images.permute(0, 3, 1, 2).contiguous()] * MC_STEPS)
    layouts = {"NCHW": nchw, "channels-last": nchw.contiguous(
        memory_format=torch.channels_last)}
    configs = [("f32", {}, "NCHW"),
               ("f32 fast decoder", {"fast_decoder": True}, "NCHW"),
               ("bf16", BF16, "NCHW"), ("bf16", BF16, "channels-last"),
               ("bf16 split concat", dict(BF16, split_decoder_concat=True),
                "channels-last"),
               ("bf16 fused upsample", dict(BF16, fused_upsample=True),
                "channels-last"),
               ("bf16 fast decoder", BF16_FAST, "NCHW"),
               ("bf16 fast decoder", BF16_FAST, "channels-last")]
    ms = {}
    for label, flags, layout in configs:
        record = {**FLAGSHIP, **{k: v for k, v in flags.items()
                                 if k in FAST_DECODER_KWARGS}}
        model = variant_of(flagship, "unet", record, **{
            k: v for k, v in flags.items() if k not in FAST_DECODER_KWARGS})
        flops = conv_flops_per_image(model) * MC_STEPS * BATCH
        x = layouts[layout].to(model.dtype)
        with torch.inference_mode():
            ms[label, layout] = cuda_ms(lambda: model(x, sample_generators(
                (SEED, 0), 0, MC_STEPS, DEVICE)), 3)
        log(f"variant forward: MC{MC_STEPS} batch of {BATCH} slices, {label}, "
            f"{layout}: {ms[label, layout]:.1f} ms, {flops / 1e12:.2f} TFLOP "
            f"of convolutions = {flops / ms[label, layout] / 1e9:.1f} TFLOP/s")
        del model, x
    det = {}
    for label, flags in (("bf16 fast decoder", BF16_FAST),
                         ("bf16 fast decoder + fold", BF16_FAST_FOLD)):
        model = variant_of(flagship, "unet", FLAGSHIP, **flags)
        with torch.inference_mode():
            det[label] = cuda_ms(lambda: steps.predict(model, images), 5)
    log(f"variant forward: deterministic batch of {BATCH} slices "
        f"(channels-last) "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in det.items()))
    return ms


def input_breakdown(dataset):
    """One subject's volume onto the card in bf16 two ways (host clock,
    CUDA-synced, median of 5): cast on the host, then copied (what
    ``evaluate_subjects`` does for a bf16 model), and copied in f32, then
    cast on the card; and the f32 copy alone. The two bf16 results are
    bitwise equal."""
    volume = np.asarray(dataset.read_volume(dataset.subjects[0], "images"),
                        np.float32)

    def host_cast():
        return torch.from_numpy(volume).to(torch.bfloat16).to(DEVICE)

    def card_cast():
        return torch.from_numpy(volume).to(DEVICE).to(torch.bfloat16)

    def f32_copy():
        return torch.from_numpy(volume).to(DEVICE)

    if not torch.equal(host_cast(), card_cast()):
        raise AssertionError("the host's bf16 cast differs from the card's")
    ms = {}
    for label, fn in (("host cast + copy", host_cast),
                      ("f32 copy + card cast", card_cast),
                      ("f32 copy alone", f32_copy)):
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms[label] = float(np.median(times[1:]))
    log(f"input of one subject {volume.shape} in bf16 (host clock, median "
        f"of 5): " + ", ".join(f"{k} {v:.1f} ms" for k, v in ms.items()))
    return ms


def shared_encoder_check(flagship, dataset):
    """A dropout_center=2 model (the outer 2 down blocks dropout-free): its
    MC batch with the prefix run once against the full T*B forward under
    the same generators, in f32 (TF32 off), and both times."""
    center = variant_of(flagship, "unet", {**FLAGSHIP, "dropout_center": 2})
    if center.mc_shared_blocks != FLAGSHIP["depth"] - 2:
        raise AssertionError(f"mc_shared_blocks {center.mc_shared_blocks}")
    images = torch.from_numpy(dataset.read_volume(dataset.subjects[0],
                                                  "images")[:BATCH]).to(DEVICE)

    def forward(model):
        return steps.mc_forward(model, images, sample_generators(
            (SEED, 0), 0, MC_STEPS, DEVICE))

    with torch.inference_mode():
        shared, full = forward(center), forward(Unshared(center))
        err = float((shared - full).abs().max())
        bitwise = torch.equal(shared, full)
        torch.testing.assert_close(shared, full, rtol=1e-3, atol=2e-4)
        if torch.equal(shared[0], shared[1]):
            raise AssertionError("the MC samples of the shared path are equal")
        shared_ms = cuda_ms(lambda: forward(center), 3)
        full_ms = cuda_ms(lambda: forward(Unshared(center)), 3)
    log(f"shared encoder: dropout_center=2 MC{MC_STEPS} batch of {BATCH}, "
        f"shared prefix against the full forward: probabilities max abs err "
        f"{err:.3e}, bitwise equal {bitwise}; {shared_ms:.1f} ms shared, "
        f"{full_ms:.1f} ms full")
    return err


def bf16_card_vs_cpu(label, model, flagship, x, split,
                     depth=FLAGSHIP["depth"]):
    """A bf16 variant's logits for a small batch on the card against the
    same variant on the CPU, at :func:`bf16_bar` of the f32 logits."""
    cpu = copy.deepcopy(model).cpu()
    ref = copy.deepcopy(flagship).cpu()
    with torch.inference_mode():
        want = cpu(x).logits
        got = model(x.to(DEVICE).contiguous(
            memory_format=torch.channels_last)).logits.cpu()
        scale = float(ref(x).logits.abs().max())
    err = float((got - want).abs().max())
    bar = bf16_bar(depth, split, scale)
    if not err <= bar:
        raise AssertionError(f"{label}: card vs CPU logits {err} > {bar}")
    log(f"variant {label}: card vs CPU on {tuple(x.shape)}, logits max abs "
        f"err {err:.3e} (bar {bar:.3e} from |f32 logits| max {scale:.3f})")
    return err


def variants_phase(flagship, families, dataset, tmp, hbm_rate, ptxas):
    """The inference variants on the weights of the earlier phases, each
    through ``evaluate_subjects`` like the f32 runs: MC20 in bf16 and in
    bf16 with the fast decoder, deterministic (after its f32 run),
    ensemble and auxiliary_feat in bf16 with the fast decoder and the fold.
    Each prints s/subject, peak GB, the first ECE and the ECE/Dice deltas
    against the f32 run of the same weights; a softmax family beyond
    :data:`GATE` fails. Returns ({path: its by_path record}, the kernel
    check's max abs error)."""
    n = len(dataset.subjects)
    by_path = {}

    def run(label, models, run_id, result_id, f32=None, **kwargs):
        out_dir = os.path.join(tmp, label)
        launches, seconds, eces, planes = run_path(dataset, out_dir, models,
                                                   run_id, **kwargs)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check_csvs(out_dir, run_id, result_id, n)
        record = {"launches": launches, "s_per_subject": seconds / n,
                  "peak_gb": peak_gb, "first_ece": eces[dataset.subjects[0]]}
        text = ""
        if f32 is not None:
            got, want = ece_dice(out_dir, result_id), ece_dice(*f32)
            record["ece_delta"] = max(abs(got[k][0] - want[k][0]) for k in want)
            record["dice_delta"] = max(abs(got[k][1] - want[k][1]) for k in want)
            text = (f", against f32: ECE delta {record['ece_delta']:.2e}, "
                    f"Dice delta {record['dice_delta']:.2e}")
        extra = (f", M voxels/s {n * np.prod(BRATS) / seconds / 1e6:.3f}"
                 if kwargs.get("mc") else "")
        log(f"variant {label}: {n} subjects {BRATS} in {seconds:.2f} s = "
            f"{seconds / n:.3f} s/subject (CUDA-synced){extra}, peak memory "
            f"{peak_gb:.2f} GB, fused_eval_stats launches {launches}, first "
            f"subject's ECE {record['first_ece']:.6f}{text}")
        by_path[label] = record
        return record, planes

    mc_f32 = (os.path.join(tmp, "eval"), "smoke")
    det_f32 = (os.path.join(tmp, "deterministic"), "deterministic")
    run("deterministic", flagship, "deterministic", "deterministic", mc=0)
    paths = [
        ("mc_bf16", "unet", BF16, dict(mc=MC_STEPS), mc_f32, True),
        ("mc_bf16_fast", "unet", BF16_FAST, dict(mc=MC_STEPS), mc_f32, True),
        ("deterministic_bf16_fast_fold", "unet", BF16_FAST_FOLD, dict(mc=0),
         det_f32, True),
        ("ensemble_bf16_fast_fold", "ensemble", BF16_FAST_FOLD,
         dict(strategy="ensemble"), (os.path.join(tmp, "ensemble"),
                                     "ensemble"), True),
        ("auxiliary_feat_bf16_fast_fold", "auxiliary_feat", BF16_FAST_FOLD,
         dict(strategy="auxiliary_feat"),
         (os.path.join(tmp, "auxiliary_feat"), "auxiliary_feat_rescale"),
         False)]
    err = 0.0
    for label, kind, flags, kwargs, f32, gated in paths:
        if kind == "unet":
            models = variant_of(flagship, "unet", FLAGSHIP, **flags)
        elif kind == "ensemble":
            models = [variant_of(m, "unet", FLAGSHIP, **flags)
                      for m in families["ensemble"]]
        else:
            segmenter, postnet = families["auxiliary_feat"]
            models = (variant_of(segmenter, "unet",
                                 {**FLAGSHIP, "provide_features": True},
                                 **flags),
                      variant_of(postnet, "postnet", POSTNET, **flags))
        suffix = "_rescale" if kind == "auxiliary_feat" else ""
        record, planes = run(label, models, label, label + suffix, f32,
                             **kwargs)
        if gated and max(record["ece_delta"], record["dice_delta"]) > GATE:
            raise AssertionError(f"{label}: ECE/Dice against f32 beyond {GATE}:"
                                 f" {record}")
        if label == "mc_bf16_fast":
            if any(p.is_floating_point() and p.dtype != torch.float32
                   for p in planes):
                raise AssertionError("the eval planes of a bf16 model are "
                                     "not float32")
            plane_label = f"{label} planes of {dataset.subjects[0]} {BRATS}"
            err = check_kernel(planes, DEFAULT_THRESHOLDS, plane_label)
            timed = time_kernel(planes, plane_label, hbm_rate, ptxas)
            record.update({k: timed[k] for k in ("ms", "kernel_ms", "plain_ms",
                                                 "bound_share")})
            profile_phase(models, dataset, os.path.join(tmp, "profile_bf16"),
                          label=f"MC{MC_STEPS} bf16 fast decoder", mc=MC_STEPS)
        del planes, models
    x = middle_batch(dataset)[3:5]
    for path, flags in (("mc_bf16", BF16),
                        ("deterministic_bf16_fast_fold", BF16_FAST_FOLD)):
        by_path[path]["card_vs_cpu_max_abs_err"] = bf16_card_vs_cpu(
            path, variant_of(flagship, "unet", FLAGSHIP, **flags), flagship,
            x, split=flags.get("fast_decoder", False))
    variant_breakdown(flagship, dataset)
    input_breakdown(dataset)
    shared_encoder_check(flagship, dataset)
    return by_path, err


# int8 PTQ (``ops/quant.py``): the JAX package's default skip, and the
# H100 SXM's dense int8 tensor-core rate (NVIDIA data sheet)
INT8_SKIP = 1
INT8_OPS_PER_S = 1979e12
# int8 against f32, ECE/Dice: the JAX package's 1e-3 gate holds for the
# deterministic protocol on the trained weights here, not for MC or the
# ensemble (measured on an H100: PERF.md), and the JAX package's own int8 runs
# miss it too on weights that are not its trained ones, by up to 2.3e-3
# (tests/test_torch_quant_e2e.py prints JAX's deviation per run). Each
# path prints whether it meets the gate; beyond this envelope it fails.
INT8_ENVELOPE = 5e-3


def level_sites(n, hw, record):
    """The distinct int8 conv shapes of an ``n``-image forward of a U-Net
    of ``record`` on ``hw`` images at skip 1 with the fast decoder:
    (label, NHWC input shape, Cout, kernel side, padding, lhs dilation)."""
    depth, ch = record["depth"], record["start_filters"]
    sites = []
    for level in range(INT8_SKIP, depth + 1):
        h, w, cout = hw[0] >> level, hw[1] >> level, ch << level
        where = "bottom" if level == depth else f"level {level}"
        sites.append((f"{where} down conv 1", (n, h, w, cout // 2), cout,
                      3, 1, 1))
        sites.append((f"{where} {cout}->{cout} (down conv 2" + (
            ")" if level == depth else ", split halves a and b, up conv 2)"),
            (n, h, w, cout), cout, 3, 1, 1))
        if level < depth:
            sites.append((f"{where} fused up-conv", (n, h // 2, w // 2,
                                                     2 * cout), cout, 4, 2, 2))
    return sites


def flagship_sites():
    """The distinct int8 conv shapes of the flagship MC batch (T x B
    images) at skip 1 with the fast decoder, and the odd shapes."""
    ch = FLAGSHIP["start_filters"]
    return level_sites(MC_STEPS * BATCH, BRATS[1:], FLAGSHIP) + [
        ("Cin 4 (first conv at quantize_skip=0)",
         (BATCH, BRATS[1], BRATS[2], FLAGSHIP["in_channels"]), ch, 3, 1, 1),
        ("odd 45x53", (BATCH, 45, 53, 2 * ch), 2 * ch, 3, 1, 1),
        ("odd 45x53 fused up-conv", (BATCH, 23, 27, 4 * ch), 2 * ch, 4, 2, 2),
        ("Cout 29", (BATCH, 60, 60, 4 * ch), 29, 3, 1, 1)]


def int8_sites_per_forward():
    """Launches of one quantized forward at skip 1 with the fast decoder:
    6 a level above the bottom (the down pair, the up-conv, the split pair
    as two launches, the second adding into the first's output, the second
    up conv), 2 at the bottom."""
    return (FLAGSHIP["depth"] - INT8_SKIP) * 6 + 2


def int8_work(x_shape, cout, k, pad, dilation, out_bytes):
    """(bytes, operations) of one int8 conv: int8 in, weights and the
    output at ``out_bytes`` a value (4 int32, 2 bf16), each once; 2 x the
    multiply-adds that the data needs (the fused up-conv's 4x4 kernel meets
    2x2 non-zero inputs an output)."""
    n, h, w, cin = x_shape
    ho = int8conv.output_size(h, k, pad, dilation)
    wo = int8conv.output_size(w, k, pad, dilation)
    taps = 4 if dilation == 2 else k * k
    ops = 2 * n * ho * wo * cout * taps * cin
    bytes_moved = n * h * w * cin + cout * k * k * cin \
        + n * ho * wo * cout * out_bytes
    return bytes_moved, ops


def library_int8_ms(x, w_q, want):
    """``F.unfold`` (in bf16, exact for int8 values; it takes no int8) then
    ``torch._int_mm`` over the im2col matrix: a library route to the same
    3x3 int32 conv, timed for comparison only (the port never calls it).
    Returns its ms, or None where it does not run."""
    n, h, w, cin = x.shape
    cout = w_q.shape[0]
    b = w_q.permute(0, 3, 1, 2).reshape(cout, -1).t()  # (Cin*9, Cout)

    def call():
        cols = torch.nn.functional.unfold(
            x.permute(0, 3, 1, 2).to(torch.bfloat16), 3, padding=1)
        a = cols.transpose(1, 2).reshape(-1, cin * 9).to(torch.int8)
        del cols
        return torch._int_mm(a, b)

    try:
        got = call().view(n, h, w, cout)
        if not torch.equal(got, want):
            raise AssertionError("F.unfold + torch._int_mm differs from the "
                                 "plain version")
        del got
        return cuda_ms(call, 3)
    except (RuntimeError, torch.cuda.OutOfMemoryError) as err:
        log(f"int8 library route: not measured ({str(err)[:120]})")
        return None


# the kernel's earlier design (mma.sync m16n8k32 from registers, int32 out,
# 16 taps at the fused up-conv) at the shapes of flagship_sites(), in
# order: torch.profiler ms recorded in PERF.md (section 5) on an NVIDIA H100
# 80GB HBM3 at 700 W, not measured by this script. The log line prints them
# beside this run's times as recorded figures; the JSON line leaves them out
RECORDED_MMA_SYNC_MS = (2.491, 4.066, 11.79, 2.068, 3.743, 11.43, 1.867,
                        3.484, 11.49, 1.810, 3.532, 0.515, 0.0434, 0.122,
                        0.098)


def same_bits(a, b):
    """Equal shape, dtype and bits (NaN for NaN, -0 apart from 0)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        ints = {torch.float64: torch.int64, torch.float32: torch.int32,
                torch.bfloat16: torch.int16, torch.float16: torch.int16}
        a, b = a.view(ints[a.dtype]), b.view(ints[b.dtype])
    return torch.equal(a, b)


def fused_modes(x, w_q, g):
    """The fused entry point's modes at one site shape: {mode: (terms,
    bias, lo)} for bf16 (one input), bf16 folded (``bias_terms``' hi and
    lo), a bf16 split pair (a second input and weights) and f32, with
    seeded scales and biases."""
    from rcu_tpu_torch.models.unet import bias_terms
    cout = w_q.shape[0]

    def vector(lo, hi):
        return torch.rand(cout, generator=g, device=DEVICE) * (hi - lo) + lo

    bias = torch.randn(cout, generator=g, device=DEVICE)
    scale = vector(2e-5, 2e-3)
    bf16 = [(x, w_q, scale.to(torch.bfloat16))]
    x_b = torch.randint(-127, 128, x.shape, generator=g, device=DEVICE,
                        dtype=torch.int8)
    w_b = torch.randint(-127, 128, w_q.shape, generator=g, device=DEVICE,
                        dtype=torch.int8)
    pair = bf16 + [(x_b, w_b, vector(2e-5, 2e-3).to(torch.bfloat16))]
    hi, lo = bias_terms(bias, torch.bfloat16)
    return {"bf16": (bf16, bias.to(torch.bfloat16), None),
            "bf16 folded": (bf16, hi, lo),
            "bf16 split pair": (pair, bias.to(torch.bfloat16), None),
            "f32": ([(x, w_q, scale)], bias, None)}


def check_fused(label, x, w_q, pad, dil, g):
    """Each fused mode bitwise its plain version on the card, reruns
    bit-identical. Returns the bf16 mode's operands and the plain
    version's ms in it."""
    modes = fused_modes(x, w_q, g)
    plain_ms = None
    for mode, (terms, bias, lo) in modes.items():
        got = int8conv.int8_conv_dequant(terms, bias, pad, dil, lo=lo)
        again = int8conv.int8_conv_dequant(terms, bias, pad, dil, lo=lo)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        want = int8conv.int8_conv_dequant_reference(terms, bias, pad, dil, lo)
        end.record()
        torch.cuda.synchronize()
        if mode == "bf16":
            plain_ms = start.elapsed_time(end)
        if not same_bits(got, again):
            raise AssertionError(f"int8_conv_dequant {label} {mode}: reruns "
                                 "differ")
        if not same_bits(got, want):
            err = float((got.float() - want.float()).abs().max())
            raise AssertionError(f"int8_conv_dequant {label} {mode}: differs "
                                 f"from the plain version by up to {err}")
        del got, again, want
    return modes["bf16"], plain_ms


def check_int8_site(label, shape, cout, k, pad, dil, g):
    """Seeded int8 operands at one site shape: the int32 mode
    (``int8_conv``) equal to the float64 conv, reruns equal, and each
    fused mode bitwise its plain version (:func:`check_fused`). Returns
    (x, w_q, the plain int32 output, the bf16 mode's operands, the plain
    version's ms in it)."""
    x = torch.randint(-127, 128, shape, generator=g, device=DEVICE,
                      dtype=torch.int8)
    w_q = torch.randint(-127, 128, (cout, k, k, shape[3]), generator=g,
                        device=DEVICE, dtype=torch.int8)
    got = int8conv.int8_conv(x, w_q, pad, dil)
    again = int8conv.int8_conv(x, w_q, pad, dil)
    want = int8conv.int8_conv_reference(x, w_q, pad, dil)
    if not torch.equal(got, again):
        raise AssertionError(f"int8_conv {label}: reruns differ")
    if not torch.equal(got, want):
        err = int((got.long() - want.long()).abs().max())
        raise AssertionError(f"int8_conv {label} {shape}: differs from "
                             f"the plain version by up to {err}")
    del got, again
    bf16, plain_ms = check_fused(label, x, w_q, pad, dil, g)
    return x, w_q, want, bf16, plain_ms


def int8_kernel_phase(hbm_rate):
    """The int8 kernel against its plain versions at every distinct site
    shape of the flagship MC batch and the odd shapes: int32 mode
    (``int8_conv``) equal to the float64 conv, the fused mode
    (``int8_conv_dequant``) bitwise its plain version in bf16, bf16 folded,
    a bf16 split pair and f32, reruns bit-identical; each shape's kernel
    time in the bf16 fused mode and the int32 mode (torch.profiler), the
    fused wrapper call's ms, TOPS, the bound with the output in bf16 and
    the share of it reached, cuDNN's bf16 conv of the same shape
    (``F.conv2d``, or the fused up-conv's transposed conv) and the earlier
    design's recorded time (log only); at a 3x3 site the same kernel with
    one tap (the centre one, padding 0), which splits its time into fixed
    costs and the main loop; at the first level-1 shape the library
    route. Returns the JSON record."""
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED)
    record = {"name": "int8_conv", "route": "cuda",
              "source": "rcu_tpu_torch/csrc/int8conv.cu",
              "replaces": "rcu_tpu/ops/quant.py:106", "launches": None,
              "max_abs_err": 0, "sites": []}
    for i, (label, shape, cout, k, pad, dil) in enumerate(flagship_sites()):
        x, w_q, want, (terms, bias, _), plain_ms = check_int8_site(
            label, shape, cout, k, pad, dil, g)

        def fused():
            return int8conv.int8_conv_dequant(terms, bias, pad, dil)

        kernel = kernel_ms(profiled_ms(fused), "int8_conv_kernel")
        int32_kernel = kernel_ms(profiled_ms(
            lambda: int8conv.int8_conv(x, w_q, pad, dil)), "int8_conv_kernel")
        wrapper_ms = cuda_ms(fused, 5)
        one_tap = None
        if k == 3 and dil == 1:
            # the same tiles, blocks and epilogue over 1 tap instead of 9:
            # t1 = fixed + a tap, t9 = fixed + 9 taps
            w_1 = w_q[:, 1:2, 1:2].contiguous()
            one_tap = kernel_ms(profiled_ms(lambda: int8conv.int8_conv_dequant(
                [(x, w_1, terms[0][2])], bias, 0)), "int8_conv_kernel")
            del w_1
        bytes_moved, ops = int8_work(shape, cout, k, pad, dil, 2)
        bytes_ms = bytes_moved / hbm_rate * 1e3
        ops_ms = ops / INT8_OPS_PER_S * 1e3
        int32_bound = max(int8_work(shape, cout, k, pad, dil, 4)[0]
                          / hbm_rate * 1e3, ops_ms)
        xb = x.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        w3 = torch.randn(cout, shape[3], 3, 3, device=DEVICE,
                         dtype=torch.bfloat16)
        bf16_ms = cuda_ms(lambda: upsample_conv(xb, w3, None) if dil == 2
                          else torch.nn.functional.conv2d(xb, w3, padding=1),
                          5)
        bound = max(bytes_ms, ops_ms)
        site = {"site": label, "x": list(shape), "cout": cout, "k": k,
                "lhs_dilation": dil, "kernel_ms": kernel,
                "int32_kernel_ms": int32_kernel, "ms": wrapper_ms,
                "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bound_share": None if kernel is None else bound / kernel,
                "int32_bound_ms": int32_bound,
                "tops": None if kernel is None else ops / kernel / 1e9,
                "cudnn_bf16_ms": bf16_ms, "one_tap_kernel_ms": one_tap}
        if i == 1:  # the level-1 64->64 conv: the library route
            site["library_ms"] = library_int8_ms(x, w_q, want)
            record.update({k_: site[k_] for k_ in (
                "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by")})
            record["library_ms"] = site["library_ms"]
        del x, w_q, want, xb, w3, terms
        record["sites"].append(site)
        share = "not measured" if kernel is None else \
            f"{site['bound_share']:.3f}"
        tops = "not measured" if kernel is None else f"{site['tops']:.1f}"
        split = ""
        if one_tap is not None and kernel is not None:
            tap = (kernel - one_tap) / 8
            split = (f", one tap {one_tap:.4f} ms, so fixed costs "
                     f"{one_tap - tap:.4f} ms and the main loop "
                     f"{9 * tap:.4f} ms")
        log(f"int8_conv {label} {shape} -> {cout}, {k}x{k} lhs dilation "
            f"{dil}: int32 equal to the plain version, fused bitwise in bf16, "
            f"bf16 folded, bf16 split pair and f32, reruns bit-identical; "
            f"kernel bf16 {kernel} ms, int32 {int32_kernel} ms "
            f"(torch.profiler), wrapper {wrapper_ms:.4f} ms, {tops} TOPS, "
            f"bound {bound:.4f} ms ({site['bound_by']}, bf16 out; int32 out "
            f"{int32_bound:.4f}), share {share}, cuDNN bf16 conv "
            f"{bf16_ms:.4f} ms{split}, plain {plain_ms:.2f} ms; earlier "
            f"mma.sync design as recorded in PERF.md (not this run) "
            f"{RECORDED_MMA_SYNC_MS[i]} ms" + (
                f", library (F.unfold + torch._int_mm) {site['library_ms']} ms"
                if "library_ms" in site else ""))
    return record


def int8_sites_card_vs_cpu(label, model, x, kinds):
    """Site by site, on the int8 model's own activations of a 2-slice
    batch: the first site of each of ``kinds`` ("3x3", "split pair",
    "fused up-conv", "folded") runs ``models.unet.int8_conv_out`` on the
    card (the kernel) and on the CPU (the plain version) with the same
    input, scales and weights; the int8 inputs are equal and the outputs
    bitwise equal. Returns the number of sites held."""
    from rcu_tpu_torch.models import unet as unet_module
    seen = {}
    site_out = unet_module.int8_conv_out

    def record(inputs, scales, conv, fold=False, folded_bias=False):
        kind = "fused up-conv" if fold else "folded" if folded_bias else \
            "split pair" if len(inputs) == 2 else "3x3"
        if kind in kinds and kind not in seen:
            seen[kind] = ([t.clone() for t in inputs], scales, conv, fold,
                          folded_bias)
        return site_out(inputs, scales, conv, fold, folded_bias)

    unet_module.int8_conv_out = record
    try:
        with torch.inference_mode():
            model(x.to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last).to(DEVICE))
    finally:
        unet_module.int8_conv_out = site_out
    if sorted(seen) != sorted(kinds):
        raise AssertionError(f"int8 {label}: sites {sorted(seen)} ran, "
                             f"expected {sorted(kinds)}")
    for kind, (inputs, scales, conv, fold, folded_bias) in seen.items():
        cpu_conv = copy.deepcopy(conv).cpu()
        cpu_inputs = [t.cpu() for t in inputs]
        for t, c, a in zip(inputs, cpu_inputs, scales):
            if not torch.equal(unet_module.quantize_nhwc(t, a).cpu(),
                               unet_module.quantize_nhwc(c, a)):
                raise AssertionError(f"int8 {label} {kind}: the int8 inputs "
                                     "differ on the card and the CPU")
        with torch.inference_mode():
            got = site_out(inputs, scales, conv, fold, folded_bias).cpu()
            want = site_out(cpu_inputs, scales, cpu_conv, fold, folded_bias)
        if not same_bits(got, want):
            err = float((got.float() - want.float()).abs().max())
            raise AssertionError(f"int8 {label} {kind} site: card and CPU "
                                 f"differ by up to {err}")
        log(f"int8 site card vs CPU, {label} {kind} site "
            f"{tuple(inputs[0].shape)} x{len(inputs)} -> {tuple(got.shape)} "
            f"{got.dtype}: int8 inputs equal, output bitwise equal")
    return len(seen)


INT8_TRAIN_STEPS = (100, 400)  # at least, at most
INT8_TRAIN_LOSS = 0.02  # stop once the last 10 steps average below it
INT8_LESION_WEIGHT = 3.0


def trained_unet(seed, dataset):
    """A flagship U-Net as :func:`seeded_unet` starts it (BatchNorm
    statistics of the data), whose conv and BatchNorm affine weights then
    take Adam steps of class-weighted cross-entropy (lesion x
    :data:`INT8_LESION_WEIGHT`) on 8-slice batches of the synthetic
    subjects, half of them slices through the lesion, with channel dropout
    as the MC protocol samples it (BatchNorm on its fixed statistics; TF32
    on, since only the weights come out), until the loss of the last 10 steps averages below
    :data:`INT8_TRAIN_LOSS` (between the bounds of
    :data:`INT8_TRAIN_STEPS`). Its predictions follow the lesion, as a
    trained model's do (Dice ~0.9 where a seeded model's is ~0.02): the JAX
    package set its int8 gate on trained models, and on seeded weights
    int8 misses that gate in the JAX package too
    (``tests/test_torch_quant_e2e.py``; PERF.md).

    It does not use the ported trainer (:func:`train_phase` runs that):
    fixed BatchNorm statistics and the class-weighted loss reach a
    lesion-following model in these few steps, and the int8 numbers that
    PERF.md records were measured on this model."""
    torch.manual_seed(seed)
    model = get_model("unet", FLAGSHIP).to(DEVICE)
    calibrate_bn(model, middle_batch(dataset).to(DEVICE))
    volumes = []
    for subject in dataset.subjects:
        labels = torch.from_numpy(dataset.read_volume(subject, "labels"))
        volumes.append((
            torch.from_numpy(dataset.read_volume(subject, "images")).to(DEVICE),
            labels.to(DEVICE), torch.nonzero(labels.flatten(1).any(1))[:, 0]))
    g = torch.Generator().manual_seed(seed)
    dropout = torch.Generator(device=DEVICE)
    dropout.manual_seed(seed)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    weight = torch.tensor([1.0, INT8_LESION_WEIGHT], device=DEVICE)
    flags = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    losses = []
    try:
        while len(losses) < INT8_TRAIN_STEPS[1]:
            images, labels, lesion = volumes[len(losses) % len(volumes)]
            z = torch.cat([torch.randint(0, images.shape[0], (4,), generator=g),
                           lesion[torch.randint(len(lesion), (4,), generator=g)]])
            z = z.to(DEVICE)
            loss = torch.nn.functional.cross_entropy(
                model(images[z].permute(0, 3, 1, 2), [dropout]).logits,
                labels[z].long(),
                weight=weight)
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            if len(losses) >= INT8_TRAIN_STEPS[0] \
                    and np.mean(losses[-10:]) < INT8_TRAIN_LOSS:
                break
    finally:
        torch.backends.cudnn.allow_tf32 = flags
    log(f"trained_unet({seed}): cross-entropy {np.mean(losses[-10:]):.4f} "
        f"(mean of the last 10) after {len(losses)} steps")
    return model.requires_grad_(False)


def int8_card_vs_cpu(model, plain, x):
    """A quantized model's logits for a 2-slice batch on the card (the
    kernel) against the same model on the CPU (the plain version). The
    int32 sums are exact on both; the bf16 ops around them are cuDNN's and
    oneDNN's, and an input that they round apart may land on the other
    side of a rounding point of the int8 grid, one step away. So the bar
    is the int8 model's own distance from the unquantized bf16 model
    ``plain`` on the card, where every value moves by up to half a step: a
    fault of the card's path (a layout, a scale) lands far beyond it.
    Returns the max abs error against the CPU."""
    xb = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    cpu = copy.deepcopy(model).cpu()
    with torch.inference_mode():
        want = cpu(xb).logits
        got = model(xb.to(DEVICE)).logits.cpu()
        unquantized = plain(xb.to(DEVICE)).logits.cpu()
    err = float((got - want).abs().max())
    bar = float((got - unquantized).abs().max())
    if not err <= bar:
        raise AssertionError(f"int8 card vs CPU logits {err} > the int8 "
                             f"model's distance {bar} from bf16")
    log(f"int8 card vs CPU on {tuple(x.shape)}: logits max abs err "
        f"{err:.3e}, the int8 model's distance from the unquantized bf16 "
        f"model {bar:.3e} (the bar; |logits| max {float(want.abs().max()):.3f})")
    return err


def int8_phase(flagship, families, dataset, tmp, hbm_rate, evalstats_ptxas):
    """The int8 PTQ paths through ``evaluate_subjects`` after
    ``_calibrated_quant_model`` (skip 1): MC20 in bf16 with the fast
    decoder, deterministic and a 10-member ensemble in bf16 with the fast
    decoder and the fold, on briefly trained flagship weights
    (:func:`trained_unet`) after their f32 runs; and, for information, not
    gated, MC20 on the seeded weights of the earlier phases. Each prints
    s/subject, M voxels/s, peak GB, both kernels' launches and the ECE/Dice
    deltas against the f32 run of the same weights, and whether they meet
    :data:`GATE`; a held path beyond :data:`INT8_ENVELOPE` fails once all
    have run. The int8 MC model on the card is held against the CPU.
    Returns (the int8 kernel's record, {path: the eval
    kernel's by_path record})."""
    record = int8_kernel_phase(hbm_rate)
    n = len(dataset.subjects)
    forwards = -(-BRATS[0] // BATCH) * n
    by_path, eval_paths = {}, {}
    t0 = time.perf_counter()
    trained = trained_unet(SEED + 50, dataset)
    members = [trained_unet(SEED + 60 + k, dataset) for k in range(MEMBERS)]
    log(f"int8 trained weights: {MEMBERS + 1} models, "
        f"{time.perf_counter() - t0:.1f} s")
    for label, models, kwargs in (
            ("trained_mc", trained, dict(mc=MC_STEPS)),
            ("trained_deterministic", trained, dict(mc=0)),
            ("trained_ensemble", members, dict(strategy="ensemble"))):
        launches, seconds, eces, _ = run_path(
            dataset, os.path.join(tmp, label), models, label, **kwargs)
        dice = {k: v[1] for k, v in ece_dice(os.path.join(tmp, label),
                                             label).items()}
        eval_paths[label] = {"launches": launches, "s_per_subject": seconds / n,
                             "first_ece": eces[dataset.subjects[0]]}
        log(f"int8 reference {label} (f32): {seconds / n:.3f} s/subject, "
            f"ECE {eces}, Dice {dice}")
    paths = [
        ("mc_bf16_fast_int8", trained, BF16_FAST, dict(mc=MC_STEPS),
         "trained_mc", True),
        ("deterministic_bf16_fast_fold_int8", trained, BF16_FAST_FOLD,
         dict(mc=0), "trained_deterministic", True),
        ("ensemble_bf16_fast_fold_int8", members, BF16_FAST_FOLD,
         dict(strategy="ensemble"), "trained_ensemble", True),
        ("mc_bf16_fast_int8_seeded", flagship, BF16_FAST, dict(mc=MC_STEPS),
         "smoke", False)]
    beyond = []  # gated paths past the gate: the phase fails after all ran
    for label, weights, flags, kwargs, f32_id, gated in paths:
        f32 = (os.path.join(tmp, "eval" if f32_id == "smoke" else f32_id),
               f32_id)
        ensemble = isinstance(weights, list)
        if ensemble:
            models = [variant_of(m, "unet", FLAGSHIP, **flags)
                      for m in weights]
        else:
            models = variant_of(weights, "unet", FLAGSHIP, **flags)
        t0 = time.perf_counter()
        models = _calibrated_quant_model(models, dataset, BATCH, SEED,
                                         ensemble=ensemble,
                                         skip_levels=INT8_SKIP)
        calib_s = time.perf_counter() - t0
        expected = int8_sites_per_forward() * forwards * (
            len(models) if ensemble else 1)
        out_dir = os.path.join(tmp, label)
        launches, seconds, eces, planes = run_path(
            dataset, out_dir, models, label, int8_launches=expected, **kwargs)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check_csvs(out_dir, label, label, n)
        if any(p.is_floating_point() and p.dtype != torch.float32
               for p in planes):
            raise AssertionError(f"{label}: the eval planes are not float32")
        got, want = ece_dice(out_dir, label), ece_dice(*f32)
        ece_delta = max(abs(got[k][0] - want[k][0]) for k in want)
        dice_delta = max(abs(got[k][1] - want[k][1]) for k in want)
        common = {"s_per_subject": seconds / n,
                  "m_voxels_per_s": n * int(np.prod(BRATS)) / seconds / 1e6,
                  "peak_gb": peak_gb, "first_ece": eces[dataset.subjects[0]],
                  "ece_delta": ece_delta, "dice_delta": dice_delta,
                  "calibration_s": calib_s, "gated": gated,
                  "meets_gate": max(ece_delta, dice_delta) <= GATE}
        eval_paths[label] = {"launches": launches, **common}
        by_path[label] = {"launches": expected, **common}
        log(f"int8 {label}: calibration {calib_s:.2f} s; {n} subjects {BRATS} "
            f"in {seconds:.2f} s = {seconds / n:.3f} s/subject (CUDA-synced), "
            f"M voxels/s {common['m_voxels_per_s']:.3f}, peak memory "
            f"{peak_gb:.2f} GB, fused_eval_stats launches {launches}, "
            f"int8_conv launches {expected} ({int8_sites_per_forward()} a "
            f"forward), first subject's ECE {common['first_ece']:.6f}, "
            f"against f32: ECE delta {ece_delta:.2e}, Dice delta "
            f"{dice_delta:.2e}, {'within' if common['meets_gate'] else 'beyond'}"
            f" the {GATE} gate" + (f", held to {INT8_ENVELOPE}" if gated
                                   else " (information, not held)"))
        if gated and max(ece_delta, dice_delta) > INT8_ENVELOPE:
            beyond.append(f"{label}: {common}")
        if label == "mc_bf16_fast_int8":
            plane_label = f"{label} planes of {dataset.subjects[0]} {BRATS}"
            check_kernel(planes, DEFAULT_THRESHOLDS, plane_label)
            timed = time_kernel(planes, plane_label, hbm_rate, evalstats_ptxas)
            eval_paths[label].update({k: timed[k] for k in (
                "ms", "kernel_ms", "plain_ms", "bound_share")})
            del planes
            profile_phase(models, dataset, os.path.join(tmp, "profile_int8"),
                          label=f"MC{MC_STEPS} bf16 fast decoder int8",
                          mc=MC_STEPS)
            eval_paths[label]["card_vs_cpu_max_abs_err"] = int8_card_vs_cpu(
                models, variant_of(weights, "unet", FLAGSHIP, **flags),
                middle_batch(dataset)[3:5])
        kinds = {"mc_bf16_fast_int8": ("3x3", "split pair", "fused up-conv"),
                 "deterministic_bf16_fast_fold_int8": ("folded",)}.get(label)
        if kinds:
            eval_paths[label]["sites_card_vs_cpu_bitwise"] = \
                int8_sites_card_vs_cpu(label, models,
                                       middle_batch(dataset)[3:5], kinds)
        del models
    if beyond:
        raise AssertionError(f"ECE/Dice against f32 beyond {INT8_ENVELOPE}: "
                             f"{beyond}")
    record["by_path"] = by_path
    record["launches"] = sum(p["launches"] for p in by_path.values())
    return record, eval_paths


# the native-2D (ISIC) direct eval: config/test_isic_baseline_mc.yaml's
# chunks, transform and samples, the flagship of
# config/train_isic_baseline.yaml, the images of
# scripts/prepare_isic_data.py (192x256) as many as the ISIC-2017 test set
ISIC_CONFIG = "config/test_isic_baseline_mc.yaml"
ISIC_FLAGSHIP = dict(nb_classes=2, in_channels=3, depth=4, start_filters=32,
                     dropout=0.05)
ISIC = (192, 256)
ISIC_IMAGES = 600
# bf16 against f32 on the ISIC paths: per image, ECE and Dice move by up
# to 1.4e-2 on these seeded weights (an image is a few thousand lesion
# pixels), so the 1e-3 gate cannot hold image by image; the mean over the
# 600 images read 9.8e-4 to 3.2e-3 on an H100 (PERF.md), and a mean past
# this envelope fails the path
ISIC_BF16_MEAN_ENVELOPE = 5e-3


class IsicLikeDataset:
    """Seeded RGB images of 192x256 in memory with the ISIC folder
    dataset's read interface: raw 0-255 skin tones with noise and a darker
    elliptic lesion, {0, 255} masks; :meth:`with_baseline` gives [mask,
    baseline x 255] labels (the lesion dilated), as the folder dataset
    merges a baseline prediction."""

    def __init__(self, n=ISIC_IMAGES, seed=SEED):
        rng = np.random.RandomState(seed)
        h, w = ISIC
        self.subjects = [f"ISIC_{i:07d}" for i in range(n)]
        self._images = np.empty((n, h, w, 3), np.uint8)
        self._masks = np.empty((n, h, w), np.uint8)
        self._baselines = np.empty((n, h, w), np.uint8)
        self._with_baseline = False
        yy, xx = np.ogrid[:h, :w]
        for i in range(n):
            cy, cx = rng.uniform(0.3, 0.7, 2) * ISIC
            ry, rx = rng.uniform(0.1, 0.3, 2) * ISIC
            dist = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
            skin = rng.randint(150, 230, 3)
            spot = rng.randint(40, 130, 3)
            image = np.where((dist < 1.0)[..., None], spot, skin) \
                + rng.randint(0, 40, (h, w, 3))
            self._images[i] = np.clip(image, 0, 255)
            self._masks[i] = np.where(dist < 1.0, 255, 0)
            self._baselines[i] = dist < 1.3

    def with_baseline(self):
        view = copy.copy(self)
        view._with_baseline = True
        return view

    def read_volume(self, subject, category):
        i = int(subject[5:])
        if category == "images":
            return self._images[i]
        if self._with_baseline:
            return np.stack([self._masks[i], self._baselines[i] * 255], -1)
        return self._masks[i]

    def shape(self, subject, category="images"):
        if category == "images":
            return ISIC + (3,)
        return ISIC + (2,) if self._with_baseline else ISIC

    def read_slice(self, subject, index, category):
        return self.read_volume(subject, category)

    def categories(self, subject=None):
        return ["images", "labels"]

    def properties(self, subject):
        return nifti.ImageProperties(size=ISIC[::-1])

    def files(self, subject):
        return {}

    def subset(self, names, path):
        view = copy.copy(self)
        view.subjects = view.subject_subset = list(names)
        view.dataset_path = path
        return view


def isic_batch(dataset, transform, n, with_baseline=False):
    """The first ``n`` images through the transform, NCHW float32 on the
    card (with the baseline prediction as a 4th channel)."""
    images = []
    for subject in dataset.subjects[:n]:
        out = transform({"images": dataset.read_volume(subject, "images"),
                         "labels": dataset.with_baseline().read_volume(
                             subject, "labels")})
        image = out["images"]
        if with_baseline:
            image = np.concatenate([image, out["labels"][..., 1:] > 0.5], -1)
        images.append(image.astype(np.float32))
    return torch.from_numpy(np.stack(images).transpose(0, 3, 1, 2).copy()) \
        .to(DEVICE)


def prepared_unet(record, seed, x):
    """A seeded U-Net of ``record`` on the card, its BatchNorms calibrated
    on ``x`` and its class head centred (:func:`centre_head`)."""
    torch.manual_seed(seed)
    model = get_model("unet", record).to(DEVICE)
    calibrate_bn(model, x)
    centre_head(lambda v: model(v).logits,
                getattr(model, f"Conv_{record['depth']}"), x)
    return model


def isic_models(dataset, transform):
    """{family: what evaluate_subjects takes} at the ISIC flagship's width:
    the U-Net, a sigma-headed one, 10 members, a segmenter and a PostNet
    on its 32 feature channels, a 4-channel error net."""
    x = isic_batch(dataset, transform, 16)
    segmenter = prepared_unet({**ISIC_FLAGSHIP, "provide_features": True},
                              SEED + 130, x)
    torch.manual_seed(SEED + 131)
    postnet = get_model("postnet", POSTNET).to(DEVICE)
    with torch.inference_mode():
        features = segmenter(x).features
    calibrate_bn(postnet, features)
    centre_head(lambda v: postnet(v).logits, postnet.Conv_0, features)
    return {"mc": prepared_unet(ISIC_FLAGSHIP, SEED + 100, x),
            "aleatoric": prepared_unet({**ISIC_FLAGSHIP, "sigma_out": True},
                                       SEED + 101, x),
            "ensemble": [prepared_unet(ISIC_FLAGSHIP, SEED + 110 + k, x)
                         for k in range(MEMBERS)],
            "auxiliary_feat": (segmenter, postnet),
            "auxiliary_segm": prepared_unet(
                {**ISIC_FLAGSHIP, "in_channels": 4}, SEED + 140,
                isic_batch(dataset, transform, 16, with_baseline=True))}


def run_isic_path(dataset, out_dir, models, run_id, transform, batch,
                  int8_launches=0, **kwargs):
    """``evaluate_subjects`` over the images with both kernels' counts set
    to 0 before it and read after it: the eval kernel must launch once a
    same-shape part of a chunk (all the images share one shape here, so
    once a chunk) and never once an image, the int8 conv
    ``int8_launches`` times. Returns (launches, seconds, eces, the first
    chunk's eval planes, each (K, 192, 256))."""
    planes = []
    subject_eval = pipeline.fused_subject_eval

    def keep_planes(*args, **kw):
        if not planes:
            planes.extend(evalstats.kernel_planes(*args[:5]))
        return subject_eval(*args, **kw)

    pipeline.fused_subject_eval = keep_planes
    evalstats.fused_eval_stats.launches = 0
    int8conv.int8_conv.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        eces = evaluate_subjects(models, dataset, out_dir, run_id=run_id,
                                 batch_size=batch, seed=SEED, device=DEVICE,
                                 masked=False, transform=transform, **kwargs)
        torch.cuda.synchronize()
    finally:
        pipeline.fused_subject_eval = subject_eval
    seconds = time.perf_counter() - t0
    launches = evalstats.fused_eval_stats.launches
    parts = -(-len(dataset.subjects) // batch)
    if launches != parts:
        raise AssertionError(f"{run_id}: fused_eval_stats launched {launches} "
                             f"times for {parts} chunks of "
                             f"{len(dataset.subjects)} images")
    if int8conv.int8_conv.launches != int8_launches:
        raise AssertionError(f"{run_id}: int8_conv launched "
                             f"{int8conv.int8_conv.launches} times, expected "
                             f"{int8_launches}")
    if not all(math.isfinite(e) for e in eces.values()):
        raise AssertionError(f"{run_id}: non-finite ECE")
    return launches, seconds, eces, planes


def check_image_axis(planes, label):
    """The kernel's image axis on K images' planes: counts equal to the
    plain version's, confidence sums at rtol 1e-6 (lanes sum in f32, the
    plain version in f64), reruns bit-identical, every row bitwise the
    launch of that image alone, and one launch. Returns the sums' max abs
    error."""
    th = DEFAULT_THRESHOLDS
    before = evalstats.fused_eval_stats.launches
    got = evalstats.fused_eval_stats(*planes, th, per_image=True)
    again = evalstats.fused_eval_stats(*planes, th, per_image=True)
    if evalstats.fused_eval_stats.launches != before + 2:
        raise AssertionError("the image axis took more than one launch")
    want = evalstats.fused_eval_stats_reference(*planes, th, per_image=True)
    singles = [evalstats.fused_eval_stats(*(p[i] for p in planes), th)
               for i in range(len(planes[0]))]
    torch.cuda.synchronize()
    err = rel = 0.0
    for key, value in want.items():
        if not same_bits(got[key], again[key]):
            raise AssertionError(f"image axis {key}: reruns differ")
        for i, single in enumerate(singles):
            if not same_bits(got[key][i].contiguous(), single[key]):
                raise AssertionError(f"image axis {key}: image {i} differs "
                                     "from its single launch")
        if key == "bins_conf_sum":
            both = ~(got[key].isnan() & value.isnan())
            diff = (got[key] - value).abs()[both]
            err = float(diff.max()) if diff.numel() else 0.0
            rel = float((diff / value.abs()[both].clamp_min(1e-300)).max()) \
                if diff.numel() else 0.0
            torch.testing.assert_close(got[key], value, rtol=1e-6, atol=1e-6,
                                       equal_nan=True)
        elif not torch.equal(got[key], value):
            raise AssertionError(f"image axis {key}: kernel differs from the "
                                 f"plain version on {label}")
    log(f"fused_eval_stats image axis {label}: counts equal to the plain "
        f"version, conf-sum max abs err {err:.3e} (max rel {rel:.3e}), "
        f"reruns bit-identical, each of {len(singles)} rows bitwise its "
        "single launch, one launch")
    return err


def time_image_axis(planes, hbm_rate, ptxas):
    """The batched launch (wrapper, CUDA events; kernel, torch.profiler)
    beside the K single launches of the same images, the plain version and
    the bound: 11 bytes a pixel at the memory rate."""
    th = DEFAULT_THRESHOLDS
    k = len(planes[0])
    singles = [tuple(p[i] for p in planes) for i in range(k)]

    def batched():
        evalstats.fused_eval_stats(*planes, th, per_image=True)

    def one_by_one():
        for one in singles:
            evalstats.fused_eval_stats(*one, th)

    batched_ms = cuda_ms(batched, 30)
    singles_ms = cuda_ms(one_by_one, 10)
    plain_ms = cuda_ms(lambda: evalstats.fused_eval_stats_reference(
        *planes, th, per_image=True), 5)
    for _ in range(2):  # a trace may hold none of the kernel's launches
        kernel = kernel_ms(profiled_ms(batched))
        if kernel is not None:
            break
    single_kernels = kernel_ms(profiled_ms(one_by_one))
    n = planes[0].numel()
    bytes_moved = n * (4 + 4 + 1 + 1 + 1)
    bytes_ms = bytes_moved / hbm_rate * 1e3
    ops_ms = n * (9 + 1 + 3 + len(th)) / F32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    (summary,) = ptxas.values()
    log(f"fused_eval_stats image axis, {k} images {tuple(planes[0].shape[1:])}"
        f": one launch {batched_ms:.4f} ms (wrapper, CUDA events, median of "
        f"30), kernel {kernel} ms (torch.profiler); {k} single launches "
        f"{singles_ms:.4f} ms (wrapper), kernels {single_kernels} ms each "
        f"(torch.profiler mean); plain {plain_ms:.3f} ms; bound "
        f"{bound_ms * 1e3:.2f} us ({bytes_moved / 1e6:.1f} MB at "
        f"{hbm_rate / 1e12:.2f} TB/s); ptxas: {summary}")
    return {"ms": batched_ms, "kernel_ms": kernel, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "single_launches_ms": singles_ms,
            "single_kernel_ms": single_kernels}


def mixed_nan_planes(planes):
    """The folded and rescaled planes of a confidence chunk with three of
    its images' confidence constant: those rescale 0/0 to NaN."""
    folded, target, prediction, rescaled, mask = (p.clone() for p in planes)
    for i in (0, 5, len(folded) - 1):
        rescaled[i] = prepare.rescale_subject_min_max(
            torch.full_like(rescaled[i], 0.3))
        folded[i] = prepare.uncertainty_to_foreground_probabilities(
            rescaled[i], prediction[i])
    if not folded[0].isnan().all():
        raise AssertionError("a constant confidence did not rescale to NaN")
    return folded, target, prediction, rescaled, mask


def isic_forward(model, dataset, transform, batch, mc):
    """One MC chunk's forward (``batch`` images x ``mc`` samples, the
    model call alone, CUDA events) in f32 and its convolution TFLOP/s."""
    x = isic_batch(dataset, transform, batch).permute(0, 2, 3, 1) \
        .contiguous()
    from torch.utils.flop_counter import FlopCounterMode
    with torch.inference_mode(), FlopCounterMode(display=False) as flops:
        model(x[:1].permute(0, 3, 1, 2))
    total = flops.get_total_flops() * batch * mc
    with torch.inference_mode():
        ms = cuda_ms(lambda: steps.mc_forward(model, x, sample_generators(
            (SEED, 0), 0, mc, DEVICE)), 3)
    log(f"isic forward: MC{mc} chunk of {batch} images {ISIC} "
        f"({batch * mc} images) {ms:.1f} ms f32, {total / 1e12:.2f} TFLOP "
        f"of convolutions = {total / ms / 1e9:.1f} TFLOP/s")
    return ms


def isic_card_vs_cpu(model, x):
    """The ISIC flagship's logits for a 4-image chunk on the card against
    the CPU at the f32 bar (TF32 off); returns the max abs error."""
    cpu = copy.deepcopy(model).cpu()
    with torch.inference_mode():
        want = cpu(x.cpu()).logits
        got = model(x).logits.cpu()
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=1e-3, atol=2e-4)
    log(f"isic card vs CPU on {tuple(x.shape)}: logits max abs err "
        f"{err:.3e} (|logits| max {float(want.abs().max()):.3f})")
    return err


def isic_int8_sites(batch, mc, n):
    """The int8 kernel at the distinct site shapes of the ISIC int8 MC
    path: a full chunk (``batch`` x ``mc`` images) and the tail chunk
    (``n`` mod ``batch`` images x ``mc``) at 192x256, each held as
    :func:`check_int8_site` holds the flagship's. Returns the sites
    held."""
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED + 7)
    held = []
    for images in (batch * mc, (n % batch) * mc):
        for label, shape, cout, k, pad, dil in level_sites(
                images, ISIC, ISIC_FLAGSHIP):
            t0 = time.perf_counter()
            check = check_int8_site(f"isic {label}", shape, cout, k, pad,
                                    dil, g)
            del check
            held.append({"site": f"isic {label}", "x": list(shape),
                         "cout": cout, "k": k, "lhs_dilation": dil})
            log(f"int8_conv isic {label} {shape} -> {cout}, {k}x{k} lhs "
                f"dilation {dil}: int32 equal to the plain version, fused "
                f"bitwise in bf16, bf16 folded, bf16 split pair and f32, "
                f"reruns bit-identical ({time.perf_counter() - t0:.2f} s)")
    return held


def isic_phase(tmp, hbm_rate, ptxas):
    """The native-2D direct eval over 600 ISIC-shaped images through the
    config's rescale, 32 a chunk: MC20 in f32 and in bf16 with the fast
    decoder, deterministic in f32 and in bf16 with the fast decoder and
    the fold, aleatoric, the 10-member ensemble, auxiliary_feat and
    auxiliary_segm in f32, and MC20 in bf16 + fast + int8 (skip 1; for
    information). Each path prints s, images/s, peak GB, both kernels'
    launches and the first image's ECE, the bf16 ones their ECE/Dice
    deltas against the f32 run. The image axis of the eval kernel is held
    against its plain version and against single launches, and timed.
    Returns ({path: the eval kernel's by_path record}, the int8 path's
    record for the int8 kernel, the image axis's numbers, the max abs
    error of the kernel checks)."""
    from rcu_tpu_torch.engine import config as cfg_lib
    from rcu_tpu_torch.engine import databuild
    config = cfg_lib.load(ISIC_CONFIG)
    transform = databuild.build_transform(config.test_data.transform)
    batch, mc = config.test_data.batch_size, int(config.others["mc"])
    t0 = time.perf_counter()
    dataset = IsicLikeDataset()
    models = isic_models(dataset, transform)
    n = len(dataset.subjects)
    log(f"isic data and models: {n} images {ISIC}, "
        f"{time.perf_counter() - t0:.1f} s")
    by_path, errs, f32_dirs = {}, [], {}
    axis = {}

    def run(label, models_, result_id, data=dataset, f32=None,
            int8_launches=0, **kwargs):
        out_dir = os.path.join(tmp, label)
        launches, seconds, eces, planes = run_isic_path(
            data, out_dir, models_, label, transform, batch,
            int8_launches=int8_launches, **kwargs)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check_csvs(out_dir, label, result_id, n)
        record = {"launches": launches, "s": seconds,
                  "images_per_s": n / seconds, "peak_gb": peak_gb,
                  "first_ece": eces[dataset.subjects[0]]}
        text = ""
        if f32 is not None:
            got, want = ece_dice(out_dir, result_id), ece_dice(*f32)
            for j, name in ((0, "ece"), (1, "dice")):
                deltas = [abs(got[k][j] - want[k][j]) for k in want]
                record[f"{name}_delta"] = max(deltas)
                record[f"{name}_delta_mean"] = float(np.mean(deltas))
            means = max(record["ece_delta_mean"], record["dice_delta_mean"])
            record["held"] = not int8_launches
            text = (f", against f32: ECE delta max {record['ece_delta']:.2e} "
                    f"mean {record['ece_delta_mean']:.2e}, Dice delta max "
                    f"{record['dice_delta']:.2e} mean "
                    f"{record['dice_delta_mean']:.2e}" + (
                        f", means held to {ISIC_BF16_MEAN_ENVELOPE}"
                        if record["held"] else " (information, not held)"))
            if record["held"] and means > ISIC_BF16_MEAN_ENVELOPE:
                raise AssertionError(
                    f"isic {label}: mean ECE/Dice delta against f32 {means} "
                    f"beyond {ISIC_BF16_MEAN_ENVELOPE}")
        f32_dirs[label] = (out_dir, result_id)
        int8 = f", int8_conv launches {int8_launches}" if int8_launches else ""
        log(f"isic {label}: {n} images {ISIC} in {seconds:.2f} s = "
            f"{n / seconds:.1f} images/s (CUDA-synced), peak memory "
            f"{peak_gb:.2f} GB, fused_eval_stats launches {launches}{int8}, "
            f"first image's ECE {record['first_ece']:.6f}{text}")
        by_path["isic_" + label] = record
        return planes

    planes = run("mc", models["mc"], "mc", mc=mc)
    isic_forward(models["mc"], dataset, transform, batch, mc)
    profile_phase(models["mc"], dataset, os.path.join(tmp, "profile_isic"),
                  label=f"isic MC{mc} f32 (images)", subjects=2 * batch,
                  batch=batch, mc=mc, masked=False, transform=transform)
    label = f"MC{mc} chunk of {len(planes[0])} {ISIC}"
    errs.append(check_image_axis(planes, label))
    axis = time_image_axis(planes, hbm_rate, ptxas)
    del planes
    run("deterministic", models["mc"], "deterministic", mc=0)
    run("aleatoric", models["aleatoric"], "aleatoric_globalrescale",
        strategy="aleatoric", is_log_sigma=False)
    run("ensemble", models["ensemble"], "ensemble", strategy="ensemble")
    planes = run("auxiliary_feat", models["auxiliary_feat"],
                 "auxiliary_feat_rescale", strategy="auxiliary_feat")
    errs.append(check_image_axis(mixed_nan_planes(planes),
                                 f"folded chunk with NaN images {ISIC}"))
    del planes
    run("auxiliary_segm", models["auxiliary_segm"], "auxiliary_segm_rescale",
        data=dataset.with_baseline(), strategy="auxiliary_segm")
    flagship = models["mc"]
    x4 = isic_batch(dataset, transform, 4)
    for label, flags, f32_label, kwargs in (
            ("mc_bf16_fast", BF16_FAST, "mc", dict(mc=mc)),
            ("deterministic_bf16_fast_fold", BF16_FAST_FOLD,
             "deterministic", dict(mc=0))):
        variant = variant_of(flagship, "unet", ISIC_FLAGSHIP, **flags)
        run(label, variant, label, f32=f32_dirs[f32_label], **kwargs)
        by_path["isic_" + label]["card_vs_cpu_max_abs_err"] = \
            bf16_card_vs_cpu(f"isic {label}", variant, flagship, x4.cpu(),
                             split=True, depth=ISIC_FLAGSHIP["depth"])
        del variant
    t0 = time.perf_counter()
    sites = isic_int8_sites(batch, mc, n)
    log(f"isic int8 sites: {len(sites)} shapes held, "
        f"{time.perf_counter() - t0:.1f} s")
    int8_model = variant_of(flagship, "unet", ISIC_FLAGSHIP, **BF16_FAST)
    _calibrated_quant_model(int8_model, dataset, batch, SEED,
                            skip_levels=INT8_SKIP, transform=transform)
    expected = int8_sites_per_forward() * -(-n // batch)
    run("mc_bf16_fast_int8", int8_model, "mc_bf16_fast_int8",
        f32=f32_dirs["mc"], int8_launches=expected, mc=mc)
    by_path["isic_mc_bf16_fast_int8"]["int8_launches"] = expected
    by_path["isic_mc_bf16_fast_int8"]["sites_card_vs_cpu_bitwise"] = \
        int8_sites_card_vs_cpu("isic_mc_bf16_fast_int8", int8_model, x4[:2],
                               ("3x3", "split pair", "fused up-conv"))
    by_path["isic_mc"]["card_vs_cpu_max_abs_err"] = isic_card_vs_cpu(
        flagship, x4)
    int8_record = {k: by_path["isic_mc_bf16_fast_int8"][k]
                   for k in ("s", "images_per_s", "peak_gb", "ece_delta",
                             "dice_delta")}
    int8_record["launches"] = expected
    int8_record["isic_sites_held"] = sites
    return by_path, int8_record, axis, max(errs)


# ----------------------------------------------------------- training

TRAIN_CONFIGS = {"default": "config/train_brats_baseline.yaml",
                 "aleatoric": "config/train_brats_aleatoric.yaml",
                 "auxiliary_feat": "config/train_brats_auxiliary_feat.yaml",
                 "auxiliary_segm": "config/train_brats_auxiliary_segm.yaml",
                 "isic": "config/train_isic_baseline.yaml"}
TRAIN_WARMUP, TRAIN_TIMED = 3, 10  # steps before and in a step timing
TRAIN_PROFILED = 10
ISIC_TRAIN, ISIC_VALID = 96, 32  # images: 3 steps of 32, one valid batch
# card against CPU, one train step at flagship width on 2 slices (dropout
# 0, TF32 off): the loss's relative error; each gradient tensor against
# its own max abs value (a conv bias before a BatchNorm, whose gradient is
# zero in exact arithmetic and rounding noise on either device, against
# its conv kernel's). Where the card misses TRAIN_GRAD_SCALE, the two
# sides took some ReLU or pool choice otherwise (a unit whose input
# float32 rounds to the other side of 0 carries its whole gradient on one
# side and none on the other); then a card step that takes the CPU's
# choices (ForwardDecisions) must lie within the same bar of the CPU's
# gradient or, where the CPU's float32 lies the farther from it, of
# float64's on those choices. A TF32 convolution misses it, and the check
# shows it does. Then the BatchNorm running statistics relative to their
# tensor's max; adam's new parameters from identical gradients
TRAIN_LOSS_RTOL, TRAIN_GRAD_SCALE = 1e-5, 1e-3
TRAIN_STATS_RTOL, TRAIN_ADAM_RTOL = 1e-5, 1e-6


class TrainTimer(train_hooks.TrainLoopHook):
    """A train-loop hook: each step's time (CUDA-synced), its loss, the
    validation's seconds and score."""

    def __init__(self):
        self.times, self.losses, self.validation_s = [], [], None
        self.score, self._t = None, None

    def _now(self):
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter()

    def on_epoch_start(self, loop, epoch):
        self._t = self._now()

    def on_training_batch_end(self, loop, epoch, batch_index, nb_batches,
                              metrics):
        self.losses.append(float(metrics["loss"]))
        now = self._now()
        self.times.append(now - self._t)
        self._t = now

    def on_training_end(self, loop, epoch, metrics_mean):
        self._t = self._now()

    def on_validation_end(self, loop, epoch, score, is_best, subject_results):
        self.validation_s = self._now() - self._t
        self.score = score


@contextlib.contextmanager
def memory_stores(stores):
    """``engine.databuild.build_dataset`` resolves a config's dataset name
    to one of ``stores`` (the card's machine has no h5py, and the smoke's
    data live in memory); the loader, the selection and its index cache
    run as for a store on disk."""
    from rcu_tpu_torch.engine import databuild
    build = databuild.build_dataset
    databuild.build_dataset = \
        lambda data_config, subjects=None, prediction_dir=None: \
        stores[data_config.dataset]
    try:
        yield
    finally:
        databuild.build_dataset = build


def train_config(name, tmp, train, valid, **others):
    """A shipped train config with the smoke's run dir, one epoch, the
    in-memory stores ``train`` and ``valid``, and ``others`` merged."""
    from rcu_tpu_torch.engine import config as cfg_lib
    config = cfg_lib.load(TRAIN_CONFIGS[name], expected_type="train-config")
    config.train_dir, config.split, config.epochs = tmp, "", 1
    config.train_data.dataset, config.valid_data.dataset = train, valid
    config.others.update(others)
    return config


class CsvAtRunDir(train_hooks.TrainLoopHook):
    """The validation CSV hook in the run's own dir, which the loop names
    when it starts."""

    def __init__(self):
        self.hook = None

    def on_startup(self, loop):
        self.hook = train_hooks.WriteValidationMetricsCsvHook(
            os.path.join(loop.run_dir, "validation_metrics.csv"))
        self.hook.on_startup(loop)

    def on_validation_subject_end(self, loop, epoch, subject, results):
        self.hook.on_validation_subject_end(loop, epoch, subject, results)

    def on_validation_end(self, loop, epoch, score, is_best, subject_results):
        self.hook.on_validation_end(loop, epoch, score, is_best,
                                    subject_results)


def run_training(label, run, config, batch_size, extra_hooks=(),
                 devices=None, **kwargs):
    """One epoch of ``run`` (a ``strategies.train_*``) with the smoke's
    hooks (timer, best + 3 last checkpoints, validation CSV) and
    ``extra_hooks``; then, from the trained state, ``TRAIN_WARMUP`` steps
    and ``TRAIN_TIMED`` timed steps (CUDA-synced) on its first batch, and
    one more checkpoint write timed. With ``devices`` (a mesh's) the
    record also holds the timed steps' peak GB of each. Prints a line;
    returns (loop, the record)."""
    from rcu_tpu_torch.data.loader import prefetch
    timer = TrainTimer()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loop = run(config, device=DEVICE, hooks=[
        timer, train_hooks.SaveBestModelHook(),
        train_hooks.SaveNLastModelHook(3), CsvAtRunDir(), *extra_hooks],
        **kwargs)
    run_s = time.perf_counter() - t0
    run_peak = torch.cuda.max_memory_allocated() / 1e9
    names = sorted(os.listdir(loop.model_files.weight_checkpoint_dir))
    if names != ["checkpoint_ep000-best.ckpt", "checkpoint_ep000.ckpt"]:
        raise AssertionError(f"{label}: checkpoints {names}")
    with open(os.path.join(loop.run_dir, "validation_metrics.csv")) as f:
        rows = f.read().strip().splitlines()
    n_valid = len(loop.valid_data.dataset.subjects)
    if len(rows) != 1 + n_valid or not all(math.isfinite(x) for x in
                                          timer.losses):
        raise AssertionError(f"{label}: validation rows {rows[:3]}, losses "
                             f"{timer.losses}")
    batch = next(prefetch(iter(loop.train_data.loader), DEVICE))
    step = loop.train_step
    torch.cuda.reset_peak_memory_stats()
    if devices is not None:
        reset_peaks(devices)
    for i in range(TRAIN_WARMUP):
        step(loop.state, batch, steps.step_generator(SEED, 1, i, DEVICE))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TRAIN_TIMED):
        metrics = step(loop.state, batch,
                       steps.step_generator(SEED, 2, i, DEVICE))
    enqueue_ms = (time.perf_counter() - t0) / TRAIN_TIMED * 1e3
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / TRAIN_TIMED * 1e3
    step_peak = torch.cuda.max_memory_allocated() / 1e9
    device_peaks = None if devices is None else peaks_gb(devices)
    if not math.isfinite(float(metrics["loss"])):
        raise AssertionError(f"{label}: non-finite loss after the timed steps")
    path = loop.model_files.build_checkpoint_path(99)
    t0 = time.perf_counter()
    loop.save_checkpoint(99)
    ckpt_s = time.perf_counter() - t0
    ckpt_mb = os.path.getsize(path) / 1e6
    os.remove(path)
    record = {"steps": len(timer.times), "step_ms": step_ms,
              "enqueue_ms": enqueue_ms,
              "per_s": batch_size / step_ms * 1e3, "peak_gb": step_peak,
              "run_peak_gb": run_peak, "run_s": run_s,
              "first_loss": timer.losses[0], "last_loss": timer.losses[-1],
              "losses": timer.losses, "loop_step_ms": None,
              "validation_s_per_subject": timer.validation_s / n_valid,
              "score": timer.score, "checkpoint_s": ckpt_s,
              "checkpoint_mb": ckpt_mb}
    if device_peaks is not None:
        record["peak_gb_per_device"] = device_peaks
    loop_steps = timer.times[TRAIN_WARMUP:]
    if loop_steps:
        record["loop_step_ms"] = 1e3 * float(np.mean(loop_steps))
    loop_ms = f"{1e3 * np.mean(loop_steps):.1f}" if loop_steps else "n/a"
    log(f"train {label}: one epoch of {len(timer.times)} steps of "
        f"{batch_size} in {run_s:.2f} s (in the loop after {TRAIN_WARMUP} "
        f"steps {loop_ms} ms/step, synced), loss {timer.losses[0]:.4f} -> "
        f"{timer.losses[-1]:.4f}; {step_ms:.2f} ms/step on one batch after "
        f"{TRAIN_WARMUP} warm-up steps = {record['per_s']:.1f} "
        f"{'images' if 'isic' in label else 'slices'}/s, peak "
        f"{step_peak:.2f} GB (run {run_peak:.2f} GB); validation "
        f"{record['validation_s_per_subject']:.3f} s/subject, score "
        f"{timer.score:.4f}; checkpoint write {ckpt_s:.3f} s, "
        f"{ckpt_mb:.3f} MB")
    return loop, record


def profile_train_steps(loop, n=TRAIN_PROFILED, label="brats default"):
    """``n`` train steps on the loader's batches under torch.profiler: the
    device's busy share of the wall time and the 8 kernels with the most
    device time, names whole."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from rcu_tpu_torch.data.loader import prefetch
    batches = []
    for batch in prefetch(iter(loop.train_data.loader), DEVICE):
        batches.append(batch)
        if len(batches) == n:
            break
    batches = (batches * n)[:n]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, batch in enumerate(batches):
            loop.train_step(loop.state, batch,
                            steps.step_generator(SEED, 3, i, DEVICE))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        log("train profile: the trace holds no device kernels; busy share "
            "not measured")
        return None
    busy, reach, by_name = 0.0, -math.inf, {}
    for start, end, name in spans:
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        by_name[name] = by_name.get(name, 0.0) + end - start
    log(f"train profile: {n} steps of {label} in {wall_us / 1e6:.3f} s "
        f"under the profiler, device busy {busy / 1e6:.3f} s = "
        f"{100 * busy / wall_us:.1f} %, {len(spans)} kernels")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  {100 * us / busy:5.1f} %  {us / 1e3 / n:8.3f} ms/step  {name}")
    return busy / wall_us


def seeded_train_model(record, seed):
    from rcu_tpu_torch.engine.state import create_train_state
    from rcu_tpu_torch.models import get_optimizer
    model_type = "postnet" if "nb_convs" in record or "start_filters" not \
        in record else "unet"
    return create_train_state(get_model(model_type, record),
                              get_optimizer("adam", {}), seed, "cpu").model


class GradRecorder:
    """An optimizer that keeps the gradients and updates nothing."""

    def init(self, params):
        return {}

    def step(self, params, state):
        self.grads = {k: p.grad.detach().cpu() for k, p in params.items()}


class ForwardDecisions:
    """The discrete choices of a forward pass, in call order: each ReLU's
    mask and each max-pool's argmax (``rcu_tpu_torch.models.unet`` makes
    both through ``torch.nn.functional``). :meth:`recording` keeps a run's
    choices; :meth:`replaying` makes another run take them, and counts the
    units and windows where that run's own values would have chosen
    otherwise. Where rounding puts a ReLU's input on the other side of 0,
    the forward moves by that rounding but the unit's gradient by its
    whole value: a difference of the choice, not of the arithmetic."""

    def __init__(self):
        self.relu, self.pool, self.differ = [], [], 0

    @contextlib.contextmanager
    def recording(self):
        from unittest import mock
        relu_, pool = torch.nn.functional.relu_, torch.nn.functional.max_pool2d

        def record_relu(y):
            self.relu.append(y > 0)
            return relu_(y)

        def record_pool(x, *args, **kwargs):
            y, index = pool(x, *args, return_indices=True, **kwargs)
            self.pool.append(index)
            return y

        with mock.patch.object(torch.nn.functional, "relu_", record_relu), \
                mock.patch.object(torch.nn.functional, "max_pool2d",
                                  record_pool):
            yield

    @contextlib.contextmanager
    def replaying(self):
        from unittest import mock
        pool = torch.nn.functional.max_pool2d
        relus, pools = iter(self.relu), iter(self.pool)
        self.differ = 0

        def replay_relu(y):
            mask = next(relus).to(y.device)
            self.differ += int(((y > 0) != mask).sum())
            return torch.where(mask, y, 0.0)

        def replay_pool(x, *args, **kwargs):
            index = next(pools).to(x.device)
            own = pool(x.detach(), *args, return_indices=True, **kwargs)[1]
            self.differ += int((own != index).sum())
            return x.flatten(2).gather(2, index.flatten(2)).view(index.shape)

        with mock.patch.object(torch.nn.functional, "relu_", replay_relu), \
                mock.patch.object(torch.nn.functional, "max_pool2d",
                                  replay_pool):
            yield
        if next(relus, None) is not None or next(pools, None) is not None:
            raise AssertionError("the replayed forward took fewer choices "
                                 "than the recorded one")


@contextlib.contextmanager
def cudnn_tf32():
    """cuDNN's convolutions in TF32 within the block (the control of the
    train step's gradient check), the caller's flag back afterwards."""
    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = flag


def train_step_card_vs_cpu(label, model, make_step, batch, frozen=None,
                           noise=None, lr=1e-4, tf32_control=False):
    """One train step of ``make_step(frozen)`` from ``model``'s weights on
    the card and on the CPU in float32 (TF32 off): the loss, each
    gradient, the BatchNorm running statistics at the TRAIN_* bars. A
    gradient that misses its bar is held again from a card step that
    replays the CPU's forward choices (:class:`ForwardDecisions`),
    against the nearer of the CPU's and float64's on those choices. Then
    adam from both sides' weights fed the CPU's gradients: the new
    parameters at TRAIN_ADAM_RTOL. With ``tf32_control`` the replaying
    card step runs once more with cuDNN's TF32 on, and the check fails
    unless that run misses the bar: the check is shown to reject the
    precision it exists to exclude. Returns the largest card-vs-CPU
    gradient error relative to its tensor's max."""
    from rcu_tpu_torch.engine.state import TrainState
    from rcu_tpu_torch.models.optim import Adam
    pre_bn_bias = re.compile(r"ConvBnRelu_\d+\.Conv_0\.bias$")

    def step(device, dtype, choices=None, replay=False):
        m = copy.deepcopy(model).to(device)
        f = None if frozen is None else copy.deepcopy(frozen).to(device)
        if dtype == torch.float64:
            for net in filter(None, (m, f)):
                net.double().dtype = torch.float64
        state = TrainState(m, GradRecorder(), {})
        kwargs = {} if noise is None else {"noise": noise.to(device)}
        data = {k: (v.to(dtype) if v.is_floating_point() else v).to(device)
                for k, v in batch.items()}
        with (contextlib.nullcontext() if choices is None else
              choices.replaying() if replay else choices.recording()):
            metrics = make_step(f)(
                state, data, torch.Generator(device=device).manual_seed(SEED),
                **kwargs)
        return (float(metrics["loss"]), state.optimizer.grads,
                {k: v.detach().cpu() for k, v in m.state_dict().items()
                 if "running" in k}, m)

    choices = ForwardDecisions()
    l_cpu, g_cpu, s_cpu, m_cpu = step("cpu", torch.float32, choices)
    l_gpu, g_gpu, s_gpu, m_gpu = step(DEVICE, torch.float32)
    g_replay = step(DEVICE, torch.float32, choices, replay=True)[1]
    flips = choices.differ
    g64 = step(DEVICE, torch.float64, choices, replay=True)[1]

    def scale_of(name):
        return float(g_cpu[name[:-len("bias")] + "weight"
                           if pre_bn_bias.search(name) else name].abs().max())

    def replay_err(grads, name):
        """(vs the CPU, vs float64), on the CPU's choices."""
        got = grads[name].double()
        return (float((got - g_cpu[name].double()).abs().max()),
                float((got - g64[name]).abs().max()))

    failures, rows = [], []
    if not abs(l_gpu - l_cpu) <= TRAIN_LOSS_RTOL * abs(l_cpu):
        failures.append(f"loss card {l_gpu} vs CPU {l_cpu}")
    worst = 0.0
    for name, want in g_cpu.items():
        scale = scale_of(name)
        err = float((g_gpu[name] - want).abs().max())
        rows.append((err / scale, name) + tuple(
            e / scale for e in replay_err(g_replay, name)))
        if not (err <= TRAIN_GRAD_SCALE * scale
                or min(replay_err(g_replay, name)) <= TRAIN_GRAD_SCALE * scale):
            failures.append(f"gradient {name} card vs CPU {err}; on the "
                            f"CPU's choices vs CPU and vs float64 "
                            f"{replay_err(g_replay, name)} (max {scale})")
        worst = max(worst, err / scale)
    log(f"  {label}: {flips} ReLU units and pool windows of the card's "
        f"forward would choose otherwise than the CPU's")
    for rel, name, cpu, f64 in sorted(rows, reverse=True)[:4]:
        log(f"  {label} gradient {name}: card vs CPU {rel:.2e}; on the "
            f"CPU's choices vs CPU {cpu:.2e}, vs float64 {f64:.2e} x its max")
    for name, want in s_cpu.items():
        err = float((s_gpu[name] - want).abs().max())
        if not err <= TRAIN_STATS_RTOL * float(want.abs().max()):
            failures.append(f"{name} card vs CPU {err}")
    if tf32_control:
        with cudnn_tf32():
            g_tf32 = step(DEVICE, torch.float32, choices, replay=True)[1]
        control = max(min(replay_err(g_tf32, name)) / scale_of(name)
                      for name in g_tf32)
        log(f"  {label} control, cuDNN TF32 on, on the CPU's choices: the "
            f"farthest gradient lies {control:.2e} x its max from the "
            f"nearer of CPU and float64 (bar {TRAIN_GRAD_SCALE:.0e})")
        if not control > TRAIN_GRAD_SCALE:
            failures.append(f"the TF32 control's gradients lie within "
                            f"{control} of the CPU's or float64's: the bar "
                            f"cannot tell TF32 from float32")
    # adam on identical gradients, from identical weights
    params, start = {}, copy.deepcopy(m_cpu.state_dict())
    for device, m in (("cpu", m_cpu), (DEVICE, m_gpu)):
        m.load_state_dict(start)
        named = dict(m.named_parameters())
        for key, p in named.items():
            p.grad = g_cpu[key].to(device)
        state = TrainState(m, Adam(lr), Adam(lr).init(named))
        state.step()
        params[device] = {k: v.detach().cpu() for k, v in
                          m.named_parameters()}
    for key, want in params["cpu"].items():
        got = params[DEVICE][key]
        if not torch.allclose(got, want, rtol=TRAIN_ADAM_RTOL, atol=0):
            failures.append(f"adam {key}: {float((got - want).abs().max())}")
    if failures:
        raise AssertionError(f"{label}: {len(failures)} checks failed: "
                             + "; ".join(failures[:8]))
    log(f"train card vs CPU, {label}: loss {l_gpu:.6f} vs {l_cpu:.6f}, "
        f"gradients max err {worst:.2e} x their tensor's max, BatchNorm "
        f"statistics and adam's update at the bars")
    return worst


def train_card_vs_cpu(dataset):
    """One train step of each kind at flagship width on 2 slices through
    the lesion, dropout 0, card against CPU."""
    subject = dataset.subjects[0]
    labels = dataset.read_volume(subject, "labels")
    z = int(np.argmax(labels.reshape(labels.shape[0], -1).sum(1)))
    images = torch.from_numpy(np.ascontiguousarray(
        dataset.read_volume(subject, "images")[z:z + 2]))
    gt = torch.from_numpy(np.ascontiguousarray(labels[z:z + 2]))
    baseline = torch.from_numpy(np.ascontiguousarray(
        dataset._data[subject]["baseline"][z:z + 2]))
    batch = {"images": images, "labels": gt, "valid": torch.ones(2)}
    flagship = {**FLAGSHIP, "dropout": 0.0}
    errs = [train_step_card_vs_cpu(
        "ce", seeded_train_model(flagship, SEED), lambda f:
        steps.make_train_step(), batch, tf32_control=True)]
    sigma = seeded_train_model({**flagship, "sigma_out": True}, SEED + 1)
    noise = torch.randn((10, 2, 2) + BRATS[1:],
                        generator=torch.Generator().manual_seed(SEED))
    errs.append(train_step_card_vs_cpu(
        "aleatoric", sigma, lambda f: steps.make_train_step(
            "aleatoric", is_log_sigma=False), batch, noise=noise))
    segmenter = seeded_train_model({**flagship, "provide_features": True},
                                   SEED + 2).eval()
    errs.append(train_step_card_vs_cpu(
        "auxiliary_feat", seeded_train_model(
            {"nb_classes": 2, "in_channels": FLAGSHIP["start_filters"],
             "nb_convs": 3}, SEED + 3),
        lambda f: steps.make_auxiliary_train_step(f), batch,
        frozen=segmenter))
    errs.append(train_step_card_vs_cpu(
        "auxiliary_segm", seeded_train_model(
            {**flagship, "in_channels": 5}, SEED + 4),
        lambda f: steps.make_auxiliary_train_step(), dict(
            batch, labels=torch.stack([gt, baseline], -1))))
    return max(errs)


def _subdir(tmp, name):
    path = os.path.join(tmp, name)
    os.makedirs(path, exist_ok=True)
    return path


def train_phase(tmp, dataset=None):
    """Training on the card through ``rcu_tpu_torch.strategies``: BraTS
    default (config/train_brats_baseline.yaml at its width and batch, one
    epoch over 2 synthetic 155x240x240 subjects, validation on a third),
    whose best checkpoint then runs through the direct eval, deterministic
    and MC20, on the valid subject; aleatoric, auxiliary_feat (on that
    checkpoint) and auxiliary_segm on the slices through the lesion; ISIC
    default (config/train_isic_baseline.yaml, 192x256 through its
    rescale, ISIC validation); card against CPU steps; a profile of 10
    BraTS default steps. Returns ({eval path: by_path record}, the largest
    card-vs-CPU gradient error, {run: numbers}, the in-memory stores by
    dataset name, which the mesh training phase trains on)."""
    from rcu_tpu_torch import strategies
    from rcu_tpu_torch.engine.config import ParametricNode
    from rcu_tpu_torch.eval.direct import load_model
    t0 = time.perf_counter()
    # the raw t2 NIfTIs in a dir of their own: the main path's subjects
    # share these names, and the staged phase reads theirs
    data = dataset or BratsLikeDataset(_subdir(tmp, "train_data"),
                                       n_subjects=3, seed=SEED + 7)
    train, valid = data.subjects[:2], data.subjects[2:]
    stores = {"brats_train": data.subset(train, os.path.join(tmp, "brats_train")),
              "brats_valid": data.subset(valid, os.path.join(tmp, "brats_valid"))}
    wpred = data.with_baseline()
    stores["wpred_train"] = wpred.subset(train, os.path.join(tmp, "wpred_train"))
    stores["wpred_valid"] = wpred.subset(valid, os.path.join(tmp, "wpred_valid"))
    isic = IsicLikeDataset(ISIC_TRAIN + ISIC_VALID, seed=SEED + 8)
    stores["isic_train"] = isic.subset(isic.subjects[:ISIC_TRAIN],
                                       os.path.join(tmp, "isic_train"))
    stores["isic_valid"] = isic.subset(isic.subjects[ISIC_TRAIN:],
                                       os.path.join(tmp, "isic_valid"))
    log(f"train data: {len(train)} + {len(valid)} subjects {BRATS}, "
        f"{ISIC_TRAIN} + {ISIC_VALID} images {ISIC}, "
        f"{time.perf_counter() - t0:.1f} s")
    runs, by_path = {}, {}
    root = os.path.join(tmp, "train")
    lesion = ParametricNode("with-foreground", {})
    with memory_stores(stores):
        config = train_config("default", root, "brats_train", "brats_valid")
        default, runs["brats_default"] = run_training(
            "brats default", strategies.train_default, config,
            config.train_data.batch_size)
        runs["brats_default"]["busy_share"] = profile_train_steps(default)
        config = train_config("aleatoric", root, "brats_train", "brats_valid")
        config.train_data.selection_strategy = lesion
        _, runs["brats_aleatoric"] = run_training(
            "brats aleatoric", strategies.train_aleatoric, config,
            config.train_data.batch_size)
        config = train_config("auxiliary_feat", root, "brats_train",
                              "brats_valid",
                              model_dir=default.model_files.model_dir,
                              test_at="best")
        config.train_data.selection_strategy = lesion
        _, runs["brats_auxiliary_feat"] = run_training(
            "brats auxiliary_feat", strategies.train_auxiliary_feat, config,
            config.train_data.batch_size)
        config = train_config("auxiliary_segm", root, "wpred_train",
                              "wpred_valid")
        config.train_data.selection_strategy = lesion
        _, runs["brats_auxiliary_segm"] = run_training(
            "brats auxiliary_segm", strategies.train_auxiliary_segm, config,
            config.train_data.batch_size)
        config = train_config("isic", root, "isic_train", "isic_valid")
        _, runs["isic_default"] = run_training(
            "isic default", strategies.train_default, config,
            config.train_data.batch_size,
            eval_subject_fn=strategies.isic_eval_subject_fn)
    model = load_model(default.model_files.model_dir, "best", DEVICE)
    for run_id, mc in (("train_deterministic", 0), ("train_mc20", MC_STEPS)):
        out_dir = os.path.join(tmp, run_id)
        launches, seconds, eces, _ = run_path(stores["brats_valid"], out_dir,
                                              model, run_id, mc=mc)
        check_csvs(out_dir, run_id, run_id, len(valid))
        by_path[run_id] = {"launches": launches,
                           "s_per_subject": seconds / len(valid),
                           "first_ece": next(iter(eces.values()))}
        log(f"train best checkpoint, direct eval {'MC%d' % mc if mc else 'deterministic'}: "
            f"{seconds:.2f} s for {len(valid)} subject, launches {launches}, "
            f"eces {eces}")
    err = train_card_vs_cpu(data)
    log(f"train phase: {time.perf_counter() - t0:.1f} s")
    return by_path, err, runs, stores


# ----------------------------------------------------------- staged chain

# run id -> (shipped test config, test strategy, confidence entry,
# directories slot)
STAGED_RUNS = {
    "baseline": ("config/test_brats_baseline.yaml", "default",
                 "probabilities", "BASELINE"),
    "baseline_mc": ("config/test_brats_baseline_mc.yaml", "default",
                    "probabilities", "BASELINE_MC"),
    "aleatoric": ("config/test_brats_aleatoric.yaml", "aleatoric", "sigma",
                  "ALEATORIC"),
    "ensemble": ("config/test_brats_ensemble.yaml", "ensemble",
                 "probabilities", "ENSEMBLE"),
    "auxiliary_feat": ("config/test_brats_auxiliary_feat.yaml",
                       "auxiliary_feat", "confidence", "AUX_FEAT"),
    "auxiliary_segm": ("config/test_brats_auxiliary_segm.yaml",
                       "auxiliary_segm", "confidence", "AUX_SEGM"),
}
# the staged chain against the direct eval in its eval_tree layout: run id
# -> the direct eval's strategy
STAGED_VS_DIRECT = {"baseline": "deterministic", "ensemble": "ensemble",
                    "auxiliary_feat": "auxiliary_feat"}
STAGED_ACTIONS = ("minmax", "ece_dice", "calib", "bnf_ue")


def save_flax_checkpoint(model_dir, model_type, record, model):
    """``model``'s weights as a model dir of the JAX package's schema
    (model.json, the epoch-0 best checkpoint in flax's msgpack), written
    by ``engine.checkpoint``; returns the dir."""
    from rcu_tpu_torch.engine import checkpoint as ckpt_lib
    from rcu_tpu_torch.engine.config import ParametricNode
    mf = ckpt_lib.ModelFiles.from_model_dir(model_dir)
    ckpt_lib.backup_model_parameters(mf, ParametricNode(model_type, record),
                                     None)
    params, batch_stats = flax_from_state_dict(model.state_dict())
    ckpt_lib.save_checkpoint(mf, {"params": params, "batch_stats": batch_stats,
                                  "epoch": 0, "best_score": 0.0}, 0, best=True)
    return model_dir


def save_staged_checkpoints(tmp, model, families):
    """The MC flagship and the strategy families' seeded models as
    checkpoints for the staged phase: {name: model dir (the ensemble: the
    list of its members')}."""
    t0 = time.perf_counter()
    root = os.path.join(tmp, "checkpoints")
    segmenter, postnet = families["auxiliary_feat"]
    out = {
        "flagship": save_flax_checkpoint(os.path.join(root, "flagship"),
                                         "unet", FLAGSHIP, model),
        "aleatoric": save_flax_checkpoint(
            os.path.join(root, "aleatoric"), "unet",
            {**FLAGSHIP, "sigma_out": True}, families["aleatoric"]),
        "ensemble": [save_flax_checkpoint(os.path.join(root, f"member{k}"),
                                          "unet", FLAGSHIP, member)
                     for k, member in enumerate(families["ensemble"])],
        "segmenter": save_flax_checkpoint(os.path.join(root, "segmenter"),
                                          "unet", FLAGSHIP, segmenter),
        "postnet": save_flax_checkpoint(os.path.join(root, "postnet"),
                                        "postnet", POSTNET, postnet),
        "error_net": save_flax_checkpoint(
            os.path.join(root, "error_net"), "unet",
            {**FLAGSHIP, "in_channels": 5}, families["auxiliary_segm"]),
    }
    log(f"staged checkpoints: {3 + len(out['ensemble']) + 2} models in "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def gt_tree(root, dataset):
    """The subjects in the BraTS raw layout ``Brats17Collector`` reads:
    the raw t2 (the foreground mask's source) and the ground truth as
    NIfTIs (the other three images link to the t2: the eval reads none)."""
    for name in dataset.subjects:
        d = os.path.join(root, "HGG", name)
        os.makedirs(d)
        t2 = os.path.join(d, f"{name}_t2.nii.gz")
        os.symlink(dataset.files(name)["images"]["t2"], t2)
        for entry in ("flair", "t1", "t1ce"):
            os.symlink(t2, os.path.join(d, f"{name}_{entry}.nii.gz"))
        nifti.write(dataset.read_volume(name, "labels"),
                    os.path.join(d, f"{name}_seg.nii.gz"))
    return root


class StagedTestTimer(train_hooks.TestLoopHook):
    """A test-loop hook: the device time of each ``predict_fn`` call
    between CUDA events (no sync: the loop keeps its one batch in flight),
    and the run's metrics.csv in its own run dir."""

    def __init__(self):
        self.events, self.metrics = [], None

    def on_startup(self, loop):
        self.metrics = train_hooks.WriteTestMetricsCsvHook(
            os.path.join(loop.run_dir, "metrics.csv"))
        predict = loop.predict_fn

        def timed(*args):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = predict(*args)
            end.record()
            self.events.append((start, end))
            return out

        loop.predict_fn = timed

    def on_test_subject_end(self, loop, subject, subject_data, results):
        self.metrics.on_test_subject_end(loop, subject, subject_data, results)

    def on_test_end(self, loop, subject_results):
        self.metrics.on_test_end(loop, subject_results)

    def forward_s(self):
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events) / 1e3


@contextlib.contextmanager
def timed_flush():
    """``WriterPool.flush`` timed: the seconds the artifact writes still
    take when the loop has done its work."""
    from rcu_tpu_torch.utils import writerpool
    flush = writerpool.WriterPool.flush
    seconds = []

    def timed(pool):
        t0 = time.perf_counter()
        try:
            flush(pool)
        finally:
            seconds.append(time.perf_counter() - t0)

    writerpool.WriterPool.flush = timed
    try:
        yield seconds
    finally:
        writerpool.WriterPool.flush = flush


@contextlib.contextmanager
def module_attrs(module, **values):
    """Module attributes set within the block, the old values back after."""
    saved = {k: getattr(module, k) for k in values}
    for k, v in values.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def staged_test(run_id, checkpoints, pred_root, split):
    """One staged test run through ``strategies.TEST_STRATEGIES`` and the
    shipped config of ``run_id``: returns (the loop, the record)."""
    from rcu_tpu_torch import strategies
    from rcu_tpu_torch.engine import config as cfg_lib
    from rcu_tpu_torch.engine import hooks as hooks_lib
    path, strategy, _, _ = STAGED_RUNS[run_id]
    config = cfg_lib.load(path, expected_type="test-config")
    config.test_dir, config.split = pred_root, split
    if run_id == "ensemble":
        config.model_dir = checkpoints["ensemble"][0]
        config.others["model_dir"] = checkpoints["ensemble"][1:]
    elif run_id == "auxiliary_feat":
        config.model_dir = checkpoints["postnet"]
        config.others["model_dir"] = checkpoints["segmenter"]
    else:
        config.model_dir = checkpoints[{"aleatoric": "aleatoric",
                                        "auxiliary_segm": "error_net"}.get(
                                            run_id, "flagship")]
    timer = StagedTestTimer()
    evalstats.fused_eval_stats.launches = 0
    int8conv.int8_conv.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with timed_flush() as flush_s:
        loop = strategies.TEST_STRATEGIES[strategy](
            config, device=DEVICE, hooks=[hooks_lib.ConsoleTestLogHook(), timer])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if evalstats.fused_eval_stats.launches or int8conv.int8_conv.launches:
        raise AssertionError(f"staged test {run_id}: a test loop launched "
                             "an eval or int8 kernel")
    n = len(loop.test_data.dataset.subjects)
    files = sorted(os.listdir(loop.run_dir))
    extra = {"aleatoric": "sigma", "auxiliary_feat": "confidence",
             "auxiliary_segm": "confidence"}.get(run_id)
    want = sorted(["config.yaml", "log.txt", "metrics.csv"]
                  + [f"{s}_{p}.nii.gz" for s in loop.test_data.dataset.subjects
                     for p in ("prediction", extra or "probabilities")]
                  + ([f"{s}_probabilities.nii.gz"
                      for s in loop.test_data.dataset.subjects]
                     if run_id == "aleatoric" else []))
    if files != want:
        raise AssertionError(f"staged test {run_id}: files {files} != {want}")
    record = {"s_per_subject": seconds / n,
              "forward_s_per_subject": timer.forward_s() / n,
              "flush_s": flush_s[-1],
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"staged test {run_id}: {n} subjects {BRATS} in {seconds:.2f} s = "
        f"{record['s_per_subject']:.3f} s/subject (CUDA-synced), forwards "
        f"{record['forward_s_per_subject']:.3f} s/subject (CUDA events), "
        f"NIfTI writes left at flush() {record['flush_s']:.3f} s, peak "
        f"{record['peak_gb']:.2f} GB, batch {config.test_data.batch_size}")
    return loop, record


class PlaneLog:
    """Keeps the planes of each ``fused_subject_eval`` call of a module
    (on the card), in call order: (ECE plane, prediction, uncertainty,
    the thresholds), and the first call's five kernel planes of each
    threshold count."""

    def __init__(self, module):
        self.module, self.calls, self.kernel_planes = module, [], {}

    def __enter__(self):
        self.subject_eval = self.module.fused_subject_eval

        def keep(fg, target, prediction, uncertainty, mask, thresholds,
                 **kwargs):
            self.calls.append((fg, prediction, uncertainty, tuple(thresholds)))
            self.kernel_planes.setdefault(len(thresholds), evalstats.kernel_planes(
                fg, target, prediction, uncertainty, mask))
            return self.subject_eval(fg, target, prediction, uncertainty,
                                     mask, thresholds, **kwargs)

        self.module.fused_subject_eval = keep
        return self

    def __exit__(self, *exc):
        self.module.fused_subject_eval = self.subject_eval


def staged_eval(run_id, n):
    """``cli.eval_uncertainty.main`` over one run, the minmax pass first
    (the global rescale reads its CSV), then ece_dice, calib and bnf_ue
    with the eval kernel's counts set to 0: one launch each a subject.
    Returns (the record, the PlaneLog of the last three passes)."""
    from rcu_tpu_torch.cli import eval_uncertainty
    from rcu_tpu_torch.eval import kernels
    first = eval_uncertainty.main("brats", [run_id], STAGED_ACTIONS[:1],
                                  device=DEVICE)[run_id]
    evalstats.fused_eval_stats.launches = 0
    plain = evalstats.fused_eval_stats.plain_calls
    with PlaneLog(kernels) as planes:
        rest = eval_uncertainty.main("brats", [run_id], STAGED_ACTIONS[1:],
                                     device=DEVICE)[run_id]
    torch.cuda.synchronize()
    launches = evalstats.fused_eval_stats.launches
    if launches != 3 * n or evalstats.fused_eval_stats.plain_calls != plain:
        raise AssertionError(f"staged eval {run_id}: fused_eval_stats "
                             f"launched {launches} times for {n} subjects "
                             "and 3 passes")
    record = {"launches": launches,
              "s_per_subject": (first["seconds"] + rest["seconds"]) / n,
              "read_s_per_subject": (first["read_s"] + rest["read_s"]) / n,
              "passes_s_per_subject": (first["passes_s"]
                                       + rest["passes_s"]) / n}
    log(f"staged eval {run_id}: {n} subjects in "
        f"{first['seconds'] + rest['seconds']:.2f} s = "
        f"{record['s_per_subject']:.3f} s/subject; NIfTI reads "
        f"{record['read_s_per_subject']:.3f} s/subject (Loader, on the "
        f"read-ahead thread), device passes {record['passes_s_per_subject']:.3f}"
        f" s/subject (4 passes), fused_eval_stats launches {launches}")
    return record, planes


def run_csvs(root, run_id):
    """{relative path: rows} of the 14 CSVs of ``run_id`` in an eval tree
    (BraTS: the ECE on the foreground)."""
    result_id = run_id + ("_rescale" if run_id.startswith("auxiliary") else
                          "_globalrescale" if run_id == "aleatoric" else "")
    names = [f"calibration/eval_calibration_{result_id}.csv",
             f"ece_foreground/eval_ece_{result_id}.csv",
             f"minmax/eval_summary_minmax_{run_id}.csv"] + [
        f"uncertainty/eval_uncertainty_{result_id}_th"
        f"{t:.2f}".replace(".", "") + ".csv" for t in DEFAULT_THRESHOLDS]
    out = {}
    for name in names:
        with open(os.path.join(root, name)) as f:
            out[name] = list(csv.reader(f))
    return out


def plane_allowance(label, pairs, agree_only=True):
    """Per subject, the eval planes of two runs, ``pairs[subject] = ((fg,
    prediction, uncertainty) got, (...) want)``, each plane flat and in
    the same voxel order. -> (every plane bitwise equal, {subject: the
    voxels that lie as close to a bin edge (0.5 among them) or a
    threshold as the planes' largest difference, and those whose
    prediction differs}, the largest plane difference). With
    ``agree_only`` the difference is taken where the predictions agree
    (a confidence family's ECE plane folds by the prediction: where the
    predictions differ it flips, and those voxels count apart)."""
    edges = torch.tensor(np.linspace(0.0, 1.0, 11)[1:-1], device=DEVICE)
    ths = torch.tensor(DEFAULT_THRESHOLDS, device=DEVICE)
    allowance, exact, largest = {}, True, 0.0
    for subject, ((fg_s, pred_s, unc_s), (fg_d, pred_d, unc_d)) in \
            pairs.items():
        agree = pred_s.bool() == pred_d.bool()
        same = (torch.equal(fg_s, fg_d) and torch.equal(unc_s, unc_d)
                and bool(agree.all()))
        where = agree if agree_only else torch.ones_like(agree)
        d_fg = float(torch.where(where, (fg_s - fg_d).abs(), 0).max())
        d_unc = float(torch.where(where, (unc_s - unc_d).abs(), 0).max())
        near = int((((fg_d.double()[..., None] - edges).abs() <= d_fg)
                    .any(-1) & agree).sum()) if d_fg > 0 else 0
        near += int((((unc_d.double()[..., None] - ths).abs() <= d_unc)
                     .any(-1) & agree).sum()) if d_unc > 0 else 0
        near += int((~agree).sum())
        allowance[subject] = near
        exact &= same
        largest = max(largest, d_fg, d_unc)
        log(f"  {label} {subject}: planes "
            f"{'bitwise equal' if same else 'differ'}: "
            f"{'where the predictions agree, ' if agree_only else ''}"
            f"ECE plane max diff {d_fg:.3e}, uncertainty {d_unc:.3e}; "
            f"predictions differing {int((~agree).sum())}; voxels that close "
            f"to an edge or threshold, or differing: {near}")
    return exact, allowance, largest


def hold_csvs(label, got, want, exact, allowance, close):
    """CSVs (``{name: rows}``) of two runs, cell by cell: counts exact
    where the planes were bitwise equal (``exact``), else each within its
    subject's ``allowance``; a row whose counts all agree holds its
    booleans exactly and its floats to ``close(got, want)``. -> the
    largest count difference."""
    def as_int(x):
        try:
            return int(x)
        except ValueError:
            return None

    worst, misses = 0, []
    for name, rows in want.items():
        if got[name][0] != rows[0] or len(got[name]) != len(rows):
            raise AssertionError(f"{label} {name}: header or rows differ")
        for w_row, g_row in zip(rows[1:], got[name][1:]):
            subject = w_row[1] if "minmax" not in name else None
            cells = list(zip(rows[0], g_row, w_row))
            counts_moved = False
            for col, a, b in cells:
                if as_int(a) is not None and as_int(b) is not None:
                    diff = abs(as_int(a) - as_int(b))
                    worst, counts_moved = max(worst, diff), counts_moved or diff
                    if diff > (0 if exact else allowance[subject]):
                        misses.append((name, subject, col, a, b))
            if counts_moved:
                continue  # the row's floats and booleans follow its counts
            for col, a, b in cells:
                if a == b or as_int(a) is not None:
                    continue
                bools = {a, b} & {"True", "False"}
                if bools or not ((math.isnan(float(a)) and math.isnan(float(b)))
                                 or close(float(a), float(b))):
                    misses.append((name, subject, col, a, b))
    if misses:
        raise AssertionError(f"{label}: {len(misses)} cells miss: "
                             f"{misses[:5]}")
    return worst


def staged_vs_direct(run_id, staged_planes, direct_planes, got, want,
                     subjects):
    """The staged chain's 14 CSVs of ``run_id`` (``got``) against the
    direct eval's (``want``), each :func:`run_csvs`. Per subject,
    first the planes: the ECE plane, the uncertainty plane and the
    prediction of the staged passes (the ece_dice pass's and the bnf_ue
    pass's) against the direct eval's. Bitwise equal planes must give the
    same CSVs (counts exact, floats at rtol 1e-4). Otherwise the largest
    plane difference where the predictions agree is printed, and each
    count may differ by the voxels that lie that close to a bin edge (0.5
    among them) or a threshold, and those whose prediction differs; a row
    whose counts all agree holds its floats at rtol 1e-4 and its booleans
    exactly (:func:`plane_allowance`, :func:`hold_csvs`)."""
    staged_ece = [c for c in staged_planes.calls if not c[3]][::2]  # ece_dice
    staged_unc = [c for c in staged_planes.calls if c[3]]
    pairs = {subject: ((staged_ece[i][0], staged_ece[i][1], staged_unc[i][2]),
                       direct_planes.calls[i][:3])
             for i, subject in enumerate(subjects)}
    exact, allowance, _ = plane_allowance(f"staged vs direct {run_id}", pairs)
    worst = hold_csvs(f"staged vs direct {run_id}", got, want, exact,
                      allowance,
                      lambda a, b: abs(a - b) <= 1e-4 * abs(b) + 1e-12)
    log(f"staged vs direct {run_id}: 14 CSVs, counts "
        f"{'exact' if exact else f'within {allowance}'}, the floats and "
        f"booleans of rows with equal counts at rtol 1e-4 and exact; largest "
        f"count difference {worst}")
    return worst


def staged_phase(tmp, dataset, checkpoints, hbm_rate, ptxas):
    """The staged chain at full width on the 2 subjects: the test loops of
    the six protocols through ``strategies.TEST_STRATEGIES`` and the
    shipped test configs (batch 32; auxiliary_segm on the baseline run's
    predictions), the offline engine (``cli.eval_uncertainty``) over their
    NIfTI trees, the eval kernel on its staged planes, and baseline,
    ensemble and auxiliary_feat against the direct eval in its eval_tree
    layout. Returns ({staged_<id>: by_path record, the test run's
    numbers as ``test_*``}, the kernel checks' max abs error)."""
    from rcu_tpu_torch import directories as dirs
    from rcu_tpu_torch.eval.direct import load_model
    t0 = time.perf_counter()
    root = os.path.join(tmp, "staged")
    gt_dir = gt_tree(os.path.join(root, "Training"), dataset)
    split_dir = os.path.join(root, "splits")
    os.makedirs(split_dir)
    split = os.path.join(split_dir, "split_brats18_100-25-160.json")
    with open(split, "w") as f:
        json.dump({"train": [], "valid": [], "test": list(dataset.subjects)}, f)
    pred_root, eval_root = os.path.join(root, "pred"), os.path.join(root, "eval")
    n = len(dataset.subjects)
    stores = {"in/datasets/brats18_test_reduced_norm.h5":
              dataset.subset(dataset.subjects, os.path.join(root, "store"))}
    tests, names, by_path = {}, {}, {}
    with memory_stores(stores):
        for run_id in STAGED_RUNS:
            if run_id == "auxiliary_segm":
                wpred = dataset.with_baseline()
                wpred._data = {s: {**d, "baseline": nifti.read(os.path.join(
                    pred_root, names["baseline"],
                    f"{s}_prediction.nii.gz"))[0]}
                    for s, d in dataset._data.items()}
                stores["in/datasets/brats18_test_wpred_reduced_norm.h5"] = \
                    wpred.subset(wpred.subjects, os.path.join(root, "wpred"))
            loop, tests[run_id] = staged_test(run_id, checkpoints, pred_root,
                                              split)
            names[run_id] = os.path.basename(loop.run_dir)
    slots = {f"BRATS_{STAGED_RUNS[r][3]}_PREDICT": names[r] for r in names}
    errs, planes_of = [], {}
    with module_attrs(dirs, BRATS_PREDICT_DIR=pred_root,
                      BRATS_EVAL_DIR=eval_root, BRATS_ORIG_DATA_DIR=gt_dir,
                      SPLITS_DIR=split_dir, **slots):
        for run_id in STAGED_RUNS:
            record, planes_of[run_id] = staged_eval(run_id, n)
            by_path[f"staged_{run_id}"] = {**record, **{
                f"test_{k}": v for k, v in tests[run_id].items()}}
    # the kernel on the staged planes of the first subject of the MC run:
    # the ece_dice pass's (no thresholds) and the bnf_ue pass's
    mc_planes = planes_of["baseline_mc"].kernel_planes
    for th, label in (((), "staged ece_dice"),
                      (DEFAULT_THRESHOLDS, "staged bnf_ue")):
        full = f"{label} planes of {dataset.subjects[0]} {BRATS}"
        errs.append(check_kernel(mc_planes[len(th)], th, full))
        timed = time_kernel(mc_planes[len(th)], full, hbm_rate, ptxas, th)
        by_path[f"staged_baseline_mc"][label.split()[1] + "_kernel_ms"] = \
            timed["kernel_ms"]
    # the staged chain against the direct eval, eval_tree layout
    worst = {}
    for run_id, strategy in STAGED_VS_DIRECT.items():
        if strategy == "ensemble":
            models = [load_model(d, "best", DEVICE)
                      for d in checkpoints["ensemble"]]
        elif strategy == "auxiliary_feat":
            models = (load_model(checkpoints["segmenter"], "best", DEVICE,
                                 provide_features=True),
                      load_model(checkpoints["postnet"], "best", DEVICE))
        else:
            models = load_model(checkpoints["flagship"], "best", DEVICE)
        direct_dir = os.path.join(root, f"direct_{run_id}")
        with PlaneLog(pipeline) as direct_planes:
            evaluate_subjects(models, dataset, direct_dir, strategy=strategy,
                              run_id=run_id, mc=0, batch_size=BATCH,
                              seed=SEED, device=DEVICE, layout="eval_tree")
        worst[run_id] = staged_vs_direct(
            run_id, planes_of[run_id], direct_planes,
            run_csvs(eval_root, run_id), run_csvs(direct_dir, run_id),
            dataset.subjects)
        by_path[f"staged_{run_id}"]["vs_direct_max_count_diff"] = worst[run_id]
    log(f"staged phase: {time.perf_counter() - t0:.1f} s")
    return by_path, max(errs)


# ------------------------------------------------------------------ serving

# the /v1/health keys of rcu_tpu.serve's HTTP front
HEALTH_KEYS = {"status", "model_dir", "strategy", "mc", "members",
               "batch_size", "compiled_shapes"}
SERVE_CONCURRENT = (4, 2)  # client threads, requests each


def npz_body(**arrays):
    """A request body as the service's stdlib client makes it
    (``np.savez_compressed``); returns (bytes, encode seconds)."""
    t0 = time.perf_counter()
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue(), time.perf_counter() - t0


def http_call(url, path, body=None):
    """One stdlib HTTP call -> (status, headers, body bytes, seconds);
    an HTTP error status comes back as a result."""
    req = urllib.request.Request(url + path, data=body,
                                 method="GET" if body is None else "POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            status, headers, raw = resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as err:
        status, headers, raw = err.code, err.headers, err.read()
    return status, headers, raw, time.perf_counter() - t0


@contextlib.contextmanager
def http_front(service):
    """``make_http_server(service, "127.0.0.1", 0)`` serving from a thread
    within the block; yields its URL. The server stops after the block."""
    from rcu_tpu_torch.serve import make_http_server
    httpd = make_http_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)


def predict_over_http(url, body):
    """POST one request -> (its arrays, the client's and the server's
    times and sizes)."""
    status, headers, raw, round_trip = http_call(url, "/v1/predict", body)
    if status != 200:
        raise AssertionError(f"serve: HTTP {status}: {raw[:300]!r}")
    t0 = time.perf_counter()
    with np.load(io.BytesIO(raw)) as payload:
        arrays = {k: payload[k] for k in payload.files}
    server = {name.strip(): float(ms) / 1e3 for name, ms in
              (part.split(";dur=") for part in
               headers["Server-Timing"].split(","))}
    return arrays, {"round_trip_s": round_trip,
                    "client_decode_s": time.perf_counter() - t0,
                    "device_s": server["device"],
                    "server_decode_s": server["decode"],
                    "server_encode_s": server["encode"],
                    "request_mb": len(body) / 1e6,
                    "response_mb": len(raw) / 1e6}


def serve_path(label, url, body, eval_launches, int8_launches=0):
    """One request over HTTP with both kernels' counts set to 0 before it
    and read after it: the eval kernel must launch ``eval_launches`` times
    (1 scored, 0 unscored) and the int8 conv ``int8_launches`` times, and
    neither its plain version. Prints the ``serve <label>:`` line; returns
    (the arrays, the by_path record)."""
    body, encode_s = body
    evalstats.fused_eval_stats.launches = 0
    int8conv.int8_conv.launches = 0
    plain = (evalstats.fused_eval_stats.plain_calls,
             int8conv.int8_conv.plain_calls)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, record = predict_over_http(url, body)
    torch.cuda.synchronize()
    launches = (evalstats.fused_eval_stats.launches,
                int8conv.int8_conv.launches)
    if launches != (eval_launches, int8_launches) or plain != (
            evalstats.fused_eval_stats.plain_calls,
            int8conv.int8_conv.plain_calls):
        raise AssertionError(
            f"serve {label}: launches (eval, int8) {launches}, expected "
            f"{(eval_launches, int8_launches)}; plain versions called "
            f"{evalstats.fused_eval_stats.plain_calls - plain[0]}, "
            f"{int8conv.int8_conv.plain_calls - plain[1]} times")
    for key, value in out.items():
        if value.dtype.kind == "f" and not np.isfinite(value).all():
            raise AssertionError(f"serve {label}: non-finite {key}")
    record = {"launches": launches[0], "int8_launches": launches[1],
              "client_encode_s": encode_s, **record,
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if "ece" in out:
        record["ece"] = float(np.mean(out["ece"]))
    log(f"serve {label}: client encode {encode_s:.3f} s, round trip "
        f"{record['round_trip_s']:.3f} s, decode {record['client_decode_s']:.3f}"
        f" s; server: npz decode {record['server_decode_s']:.3f} s, device "
        f"{record['device_s']:.3f} s (CUDA events), npz encode "
        f"{record['server_encode_s']:.3f} s; request {record['request_mb']:.1f}"
        f" MB, response {record['response_mb']:.1f} MB, peak "
        f"{record['peak_gb']:.2f} GB; fused_eval_stats launches {launches[0]},"
        f" int8_conv launches {launches[1]}"
        + (f", ECE {record['ece']:.6f}" if "ece" in record else ""))
    return out, record


def same_arrays(label, got, want):
    """Every array of ``want`` bitwise in ``got``."""
    for key, value in want.items():
        if got[key].dtype != value.dtype or not np.array_equal(
                got[key], value, equal_nan=True):
            raise AssertionError(f"serve {label}: {key} differs")


def served_vs_direct(served, out_dir, run_id):
    """The served deterministic scored request against the direct eval's
    row of the same subject: the ECE and the 11 correction rows, counts
    exactly, the rest at rtol 1e-6."""
    from rcu_tpu_torch.eval.hooks import CORRECTION_KEYS

    def row(name):
        with open(os.path.join(out_dir, name)) as f:
            rows = list(csv.reader(f))
        return dict(zip(rows[0], rows[1]))

    pairs = [("ece", row(f"eval_ece_{run_id}.csv")["ece"], served["ece"])]
    for ti, th in enumerate(DEFAULT_THRESHOLDS):
        cells = row(f"eval_uncertainty_{run_id}_th"
                    f"{th:.2f}".replace(".", "") + ".csv")
        pairs += [(f"{key}@{th}", cells[key], served[f"correction_{key}"][ti])
                  for key in CORRECTION_KEYS]
    worst = 0.0
    for name, cell, value in pairs:
        if cell in ("True", "False"):
            ok = (cell == "True") == bool(value)
        elif name.split("@")[0] in ("tp", "tn", "fp", "fn", "tpu", "tnu",
                                    "fpu", "fnu"):
            ok = int(cell) == int(value)
        else:
            diff = abs(float(cell) - float(value))
            worst = max(worst, diff)
            ok = diff <= 1e-6 * abs(float(cell)) or (
                math.isnan(float(cell)) and math.isnan(float(value)))
        if not ok:
            raise AssertionError(f"serve vs direct: {name}: direct {cell}, "
                                 f"served {value}")
    log(f"serve deterministic vs evaluate_subjects: ECE and 11 correction "
        f"rows equal, counts exact ({len(pairs)} cells, largest float "
        f"difference {worst:.3e})")


def isic_per_image_request(tmp):
    """Phase 9's ISIC flagship (seeded as ``isic_models`` seeds it) as a
    checkpoint and a per_image request of its first 32 images through
    config/test_isic_baseline_mc.yaml's transform: (model dir, mc, the
    body)."""
    from rcu_tpu_torch.engine import config as cfg_lib
    from rcu_tpu_torch.engine import databuild
    config = cfg_lib.load(ISIC_CONFIG)
    transform = databuild.build_transform(config.test_data.transform)
    batch = config.test_data.batch_size
    dataset = IsicLikeDataset(n=batch)
    model = prepared_unet(ISIC_FLAGSHIP, SEED + 100,
                          isic_batch(dataset, transform, 16))
    model_dir = save_flax_checkpoint(os.path.join(tmp, "serve_isic"), "unet",
                                     ISIC_FLAGSHIP, model)
    images, targets = [], []
    for subject in dataset.subjects:
        out = transform({"images": dataset.read_volume(subject, "images"),
                         "labels": dataset.read_volume(subject, "labels")})
        images.append(np.asarray(out["images"], np.float32))
        targets.append(np.asarray(out["labels"]) > 0.5)
    body = npz_body(images=np.stack(images), target=np.stack(targets),
                    per_image=np.bool_(True))
    return model_dir, int(config.others["mc"]), body, batch


def serve_phase(tmp, dataset, checkpoints):
    """The serving phase: ``rcu_tpu_torch.serve`` services of the saved
    flagship checkpoints behind their HTTP fronts on 127.0.0.1, driven by
    a stdlib client with the subjects of phase 4: MC20 f32 unscored and
    scored (a fresh service at the same request index: the scored fg
    bitwise the unscored one), deterministic f32 scored (equal to the
    direct eval's row), MC20 in bf16 + fast decoder unscored and scored,
    MC20 in bf16 + fast + int8 (the first request calibrates; ECE against
    f32 for information), aleatoric scored with its bounds, the 10-member
    ensemble in f32 and in bf16 + fast + fold, auxiliary_feat
    and auxiliary_segm scored, a per_image request of 32 ISIC images, 4
    client threads of 2 deterministic f32 requests each (equal to the
    serial answers), and the HTTP front's health, 400s and 404. Returns
    ({serve_<path>: the eval kernel's by_path record}, the int8 path's
    record for the int8 kernel)."""
    from rcu_tpu_torch.eval.direct import foreground_mask, load_model
    from rcu_tpu_torch.serve import VolumeInferenceService
    t_phase = time.perf_counter()
    s0, s1 = dataset.subjects[:2]

    def subject_arrays(s):
        target = dataset.read_volume(s, "labels")
        return {"images": dataset.read_volume(s, "images"), "target": target,
                "mask": foreground_mask(dataset, s, target.shape)}

    def service(model_dir, **kw):
        return VolumeInferenceService(model_dir, batch_size=BATCH, seed=SEED,
                                      device=DEVICE, **kw)

    a0, a1 = subject_arrays(s0), subject_arrays(s1)
    # the aleatoric request's global bounds: pass A of the protocol (the
    # subject's predicted-class sigma range), as a client's minmax run
    # over its subjects gives them
    sigma_range = pipeline.volume_sigma_minmax(
        load_model(checkpoints["aleatoric"], "best", DEVICE), BATCH,
        torch.from_numpy(a0["images"]).to(DEVICE), False)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(5) as pool:
        jobs = {"unscored": pool.submit(npz_body, images=a0["images"]),
                "scored": pool.submit(npz_body, **a0),
                "scored_1": pool.submit(npz_body, **a1),
                "baseline": pool.submit(npz_body, baseline=dataset.read_volume(
                    s0, "baseline"), **a0),
                "bounds": pool.submit(
                    npz_body, sigma_min=np.float32(sigma_range[0].item()),
                    sigma_max=np.float32(sigma_range[1].item()), **a0)}
        bodies = {k: f.result() for k, f in jobs.items()}
    log(f"serve request bodies: {len(bodies)} in "
        f"{time.perf_counter() - t0:.1f} s (np.savez_compressed, 5 threads)")
    by_path, int8_record = {}, None
    flagship = checkpoints["flagship"]
    n_batches = -(-BRATS[0] // BATCH)

    # MC20 f32: unscored, then scored at the same request index
    with http_front(service(flagship, mc=MC_STEPS)) as url:
        unscored, by_path["serve_mc"] = serve_path("mc", url,
                                                   bodies["unscored"], 0)
    fresh = service(flagship, mc=MC_STEPS)
    with http_front(fresh) as url:
        scored, by_path["serve_mc_scored"] = serve_path(
            "mc_scored", url, bodies["scored"], 1)
    for key in ("probabilities", "entropy", "prediction"):
        if not np.array_equal(scored[key], unscored[key]):
            raise AssertionError(f"serve mc: the scored {key} is not the "
                                 "unscored one at the same request index")
    log("serve mc: scored and unscored maps bitwise equal at request 1")
    mc_ece = float(scored["ece"])
    del fresh, scored, unscored

    # deterministic f32: the direct eval's protocol, row for row
    det = service(flagship, mc=0)
    with http_front(det) as url:
        serial = {}
        serial[s0], by_path["serve_deterministic"] = serve_path(
            "deterministic", url, bodies["scored"], 1)
        serial[s1], _ = serve_path("deterministic_1", url, bodies["scored_1"],
                                   1)
        direct_dir = os.path.join(tmp, "serve_direct")
        run_path(dataset.subset([s0], os.path.join(tmp, "serve_store")),
                 direct_dir, load_model(flagship, "best", DEVICE),
                 "serve_direct", mc=0)
        served_vs_direct(serial[s0], direct_dir, "serve_direct")
        # concurrency: the answers of 4 client threads equal the serial ones
        threads, each = SERVE_CONCURRENT
        order = [(s0 if (k + i) % 2 == 0 else s1) for k in range(threads)
                 for i in range(each)]

        def client(k):
            return [(s, predict_over_http(
                url, bodies["scored" if s == s0 else "scored_1"][0])[0])
                for s in order[k * each:(k + 1) * each]]

        evalstats.fused_eval_stats.launches = 0
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(threads) as pool:
            answers = [a for r in pool.map(client, range(threads)) for a in r]
        seconds = time.perf_counter() - t0
        if evalstats.fused_eval_stats.launches != len(answers):
            raise AssertionError(
                f"serve concurrent: fused_eval_stats launched "
                f"{evalstats.fused_eval_stats.launches} times for "
                f"{len(answers)} scored requests")
        for s, out in answers:
            same_arrays("concurrent", out, serial[s])
        by_path["serve_concurrent"] = {
            "launches": len(answers), "requests": len(answers),
            "seconds": seconds, "requests_per_s": len(answers) / seconds}
        log(f"serve concurrent: {threads} client threads x {each} "
            f"deterministic f32 scored requests in {seconds:.2f} s = "
            f"{len(answers) / seconds:.3f} requests/s, every answer bitwise "
            "the serial one")
        # the HTTP front
        status, _, raw, _ = http_call(url, "/v1/health")
        health = json.loads(raw)
        if status != 200 or set(health) != HEALTH_KEYS \
                or health["strategy"] != "mc" or health["mc"] != 0:
            raise AssertionError(f"serve health: {status} {health}")
        small = np.zeros((2, 8, 8, 4), np.float32)
        codes = {
            "corrupt body": http_call(url, "/v1/predict",
                                      b"PK\x03\x04 not a real zip")[0],
            "bad shape": http_call(url, "/v1/predict", npz_body(
                images=small, target=np.zeros((2, 4, 4), np.uint8))[0])[0],
            "bad channels": http_call(url, "/v1/predict", npz_body(
                images=small[..., :3])[0])[0],
            "unknown path": http_call(url, "/v1/nothing")[0]}
        if codes != {"corrupt body": 400, "bad shape": 400,
                     "bad channels": 400, "unknown path": 404}:
            raise AssertionError(f"serve HTTP codes: {codes}")
        log(f"serve http: health keys {sorted(health)}, served shapes "
            f"{health['compiled_shapes']}; codes {codes}")
    del det

    # the production configuration, and its int8 trunk
    with http_front(service(flagship, mc=MC_STEPS, **BF16_FAST)) as url:
        _, by_path["serve_mc_bf16_fast"] = serve_path(
            "mc_bf16_fast", url, bodies["unscored"], 0)
        _, by_path["serve_mc_bf16_fast_scored"] = serve_path(
            "mc_bf16_fast_scored", url, bodies["scored"], 1)
    expected = int8_sites_per_forward() * n_batches
    with http_front(service(flagship, mc=MC_STEPS, quantize=True,
                            **BF16_FAST)) as url:
        _, record = serve_path("mc_bf16_fast_int8", url, bodies["scored"], 1,
                               int8_launches=expected)
    record["ece_delta_vs_f32"] = abs(record["ece"] - mc_ece)
    by_path["serve_mc_bf16_fast_int8"] = record
    int8_record = {"launches": expected, **{
        k: v for k, v in record.items() if k not in ("launches",
                                                     "int8_launches")}}
    log(f"serve mc_bf16_fast_int8: first request calibrated and quantized "
        f"({int8_sites_per_forward()} int8 launches a forward x {n_batches} "
        f"forwards); ECE {record['ece']:.6f} against the f32 service's "
        f"{mc_ece:.6f}: delta {record['ece_delta_vs_f32']:.2e} (information)")

    # the other families, scored
    with http_front(service(checkpoints["aleatoric"],
                            is_log_sigma=False)) as url:
        _, by_path["serve_aleatoric"] = serve_path("aleatoric", url,
                                                   bodies["bounds"], 1)
    members = checkpoints["ensemble"]
    for label, flags in (("ensemble", {}),
                         ("ensemble_bf16_fast_fold", BF16_FAST_FOLD)):
        with http_front(service(members[0], members=members[1:],
                                **flags)) as url:
            _, by_path[f"serve_{label}"] = serve_path(label, url,
                                                      bodies["scored"], 1)
    with http_front(service(checkpoints["postnet"],
                            segm_model_dir=checkpoints["segmenter"])) as url:
        _, by_path["serve_auxiliary_feat"] = serve_path(
            "auxiliary_feat", url, bodies["scored"], 1)
    with http_front(service(checkpoints["error_net"], aux_segm=True)) as url:
        _, by_path["serve_auxiliary_segm"] = serve_path(
            "auxiliary_segm", url, bodies["baseline"], 1)
    del bodies

    # per-image scoring: 32 ISIC images, one launch of the eval kernel
    model_dir, mc, body, k = isic_per_image_request(tmp)
    with http_front(VolumeInferenceService(model_dir, mc=mc, seed=SEED,
                                           device=DEVICE)) as url:
        out, by_path["serve_isic_per_image"] = serve_path(
            "isic_per_image", url, body, 1)
    if out["ece"].shape != (k,) or out["correction_tp"].shape != (k, 11):
        raise AssertionError(f"serve isic_per_image: rows {out['ece'].shape}")
    log(f"serving phase: {time.perf_counter() - t_phase:.1f} s")
    return by_path, int8_record


# the largest difference of an eval plane (ECE plane, uncertainty) of a
# latency mesh path from the single device's on the same weights: a part's
# forward may take another conv algorithm than the whole batch's, which
# moves an f32 plane in its last bits and a bf16 one in bf16's; a part that
# drew other dropout masks moves the MC mean by sampling noise, far past
# either bar
MESH_F32_PLANE_BAR = 1e-5
MESH_BF16_PLANE_BAR = 1e-3
# a float CSV cell (ECE, a bin's mean confidence, a minmax bound) of a row
# whose counts equal the single device's, beyond the largest plane
# difference: the confidence sums add in another lane order when a subject
# is split (the sharded eval reads 2.2e-9 relative, the latency paths' ECE
# 4.8e-11 to 7.5e-10 in smoke run 2 on the H100; PERF.md)
MESH_FLOAT_BAR = 1e-8
# the sharded eval's confidence sums against one launch's, relative: the
# kernel's lanes sum in float32 (check_kernel holds it to the float64
# plain version at 1e-5)
SHARDED_CONF_RTOL = 1e-6
SERVE_POOL_REQUESTS = (4, 2)  # client threads, requests each


def mesh_devices():
    """Two devices for the mesh phase: the machine's first two cards where
    it has them, else ``cuda:0`` twice, a virtual mesh whose entries share
    one card and one stream (it measures the split's overhead, not
    scaling). -> (devices, what they are)."""
    if torch.cuda.device_count() >= 2:
        return [torch.device("cuda", i) for i in range(2)], "two cards"
    return [torch.device("cuda", 0)] * 2, (
        "virtual: cuda:0 twice (one card, one stream: the split's overhead, "
        "not scaling)")


def reset_peaks(devices):
    for d in dict.fromkeys(devices):
        torch.cuda.reset_peak_memory_stats(d)


def peaks_gb(devices):
    return {str(d): torch.cuda.max_memory_allocated(d) / 1e9
            for d in dict.fromkeys(devices)}


def csv_texts(out_dir, run_id):
    """Every CSV of a run, its run id replaced, for a byte comparison."""
    return {name.replace(run_id, "ID"): open(os.path.join(out_dir, name))
            .read().replace(run_id, "ID")
            for name in sorted(os.listdir(out_dir))}


def csv_rows(out_dir, run_id):
    """{file: rows} of every CSV of a run, its run id replaced."""
    return {name: list(csv.reader(io.StringIO(text)))
            for name, text in csv_texts(out_dir, run_id).items()}


def subject_planes(kept, mesh):
    """Each subject's eval planes as :func:`run_path` kept them (per
    device, its slices' planes) -> per subject (ECE plane, prediction,
    uncertainty), each (Z, H, W) on the host in slice order (a latency
    mesh's devices hold the rows of its ``Split``), so that a reference
    run's planes take no room on the card in the runs after it."""
    from rcu_tpu_torch.parallel.mesh import Split, pad_batch_size_to_mesh
    out = []
    for per_device in kept:
        if len(per_device) == 1:
            out.append(tuple(p.cpu() for p in per_device[0]))
            continue
        split = Split(BRATS[0], pad_batch_size_to_mesh(BATCH, mesh),
                      mesh.data_devices)
        joined = []
        for k in range(3):
            pieces = []
            for shard, ranges in zip(per_device, split.ranges):
                offset = 0
                for a, b in ranges:
                    pieces.append((a, shard[k][offset:offset + b - a]))
                    offset += b - a
            joined.append(torch.cat([p.cpu() for _, p in
                                     sorted(pieces, key=lambda x: x[0])]))
        out.append(tuple(joined))
    return out


def mesh_path(label, dataset, tmp, models, devices, reference, plane_bar,
              eval_launches, int8_launches=0, **kwargs):
    """One ``evaluate_subjects`` run (``run_path``'s launch checks) on the
    mesh phase's devices: prints the ``mesh <label>:`` line with its
    s/subject, peak GB per device, launches and the ECE/Dice deltas
    against ``reference`` (out dir, run id, planes), the single device's
    run of the same weights. Against it every CSV cell is held
    (:func:`hold_csvs`): counts exact where the eval planes are bitwise
    equal, else within the voxels near a bin edge or threshold; the
    floats of rows with equal counts within :data:`MESH_FLOAT_BAR` beyond
    the planes' largest difference, which must stay within
    ``plane_bar``. -> (its by_path record, (out dir, run id, planes), the
    first subject's planes where one device held them)."""
    run_id = "mesh_" + label.replace(" ", "_")
    out_dir = os.path.join(tmp, run_id)
    reset_peaks(devices)
    kept = []
    launches, seconds, eces, planes = run_path(
        dataset, out_dir, models, run_id, int8_launches=int8_launches,
        eval_launches=eval_launches, keep=kept, **kwargs)
    kept = subject_planes(kept, kwargs.get("mesh"))
    n = len(dataset.subjects)
    peaks = peaks_gb(devices)
    record = {"launches": launches, "int8_launches": int8_launches,
              "s_per_subject": seconds / n, "peak_gb": peaks,
              "first_ece": eces[dataset.subjects[0]]}
    delta = ""
    if reference is not None:
        got, want = ece_dice(out_dir, run_id), ece_dice(*reference[:2])
        record["ece_delta"] = max(abs(got[s][0] - want[s][0]) for s in want)
        record["dice_delta"] = max(abs(got[s][1] - want[s][1]) for s in want)
        pairs = {s: (tuple(p.to(DEVICE).reshape(-1) for p in g),
                     tuple(p.to(DEVICE).reshape(-1) for p in w))
                 for s, g, w in zip(dataset.subjects, kept, reference[2])}
        exact, allowance, largest = plane_allowance(f"mesh {label}", pairs,
                                                    agree_only=False)
        record["plane_delta"] = largest
        if largest > plane_bar:
            raise AssertionError(f"mesh {label}: an eval plane {largest:.3e} "
                                 f"from the single device's (bar {plane_bar})")
        float_bar = MESH_FLOAT_BAR + largest
        worst = hold_csvs(f"mesh {label}", csv_rows(out_dir, run_id),
                          csv_rows(*reference[:2]), exact, allowance,
                          lambda a, b: abs(a - b) <= float_bar)
        record["count_delta"] = worst
        delta = (f"; against the single device: eval planes "
                 f"{'bitwise equal' if exact else f'{largest:.3e} apart'} "
                 f"(bar {plane_bar}), every CSV cell held: counts "
                 f"{'exact' if exact else f'within {allowance}'} (largest "
                 f"difference {worst}), the floats of rows with equal counts "
                 f"within {float_bar:.3e}; ECE / Dice max delta "
                 f"{record['ece_delta']:.2e} / {record['dice_delta']:.2e}")
    log(f"mesh {label}: {n} subjects {BRATS} in {seconds:.2f} s = "
        f"{seconds / n:.3f} s/subject (CUDA-synced), peak GB per device "
        f"{peaks}, fused_eval_stats launches {launches}, int8_conv launches "
        f"{int8_launches}{delta}")
    return record, (out_dir, run_id, kept), planes


def sharded_eval_check(planes, devices):
    """``parallel.inference.sharded_eval_stats`` on a subject's planes
    split in two contiguous shards, one per mesh device, against one
    launch over the whole subject: counts equal, confidence sums within
    :data:`SHARDED_CONF_RTOL` relative (a lane sums in float32, so a
    shard's lane sums round apart from the whole subject's); both timed
    (CUDA events, median of 30)."""
    from rcu_tpu_torch.parallel.inference import sharded_eval_stats
    th = DEFAULT_THRESHOLDS
    shards = [tuple(p.reshape(-1).tensor_split(len(devices))[d].to(dev)
                    for p in planes) for d, dev in enumerate(devices)]
    one = evalstats.fused_eval_stats(*planes, th)
    got = sharded_eval_stats(shards, th)
    torch.cuda.synchronize()
    for key, value in one.items():
        if key == "bins_conf_sum":
            err = float(((got[key] - value).abs()
                         / value.abs().clamp_min(1e-300)).max())
            if err > SHARDED_CONF_RTOL:
                raise AssertionError(f"sharded eval: conf sums {err:.2e} "
                                     "relative apart")
        elif not torch.equal(got[key], value):
            raise AssertionError(f"sharded eval {key}: {got[key].tolist()} "
                                 f"!= one launch's {value.tolist()}")
    single_ms = cuda_ms(lambda: evalstats.fused_eval_stats(*planes, th), 30)
    sharded_ms = cuda_ms(lambda: sharded_eval_stats(shards, th), 30)
    log(f"mesh sharded eval: {len(devices)} shards of {planes[0].numel():,} "
        f"voxels, counts equal to one launch, conf sums within {err:.1e} "
        f"relative; {sharded_ms:.4f} ms for the {len(devices)} launches and "
        f"the add against {single_ms:.4f} ms for one launch (CUDA events, "
        "median of 30)")
    return {"devices": len(devices), "ms": sharded_ms, "single_ms": single_ms,
            "conf_sum_rel_err": err}


def pooled_service_check(flagship, dataset, devices):
    """A throughput-mode service (a copy of the model per mesh device, a
    device checked out per request) answering 4 client threads of 2
    deterministic f32 scored requests through ``predict_timed``: each
    answer bitwise the single-device service's serial one, the eval
    kernel once a request."""
    from rcu_tpu_torch.eval.direct import foreground_mask
    from rcu_tpu_torch.parallel import Mesh
    from rcu_tpu_torch.serve import VolumeInferenceService
    subjects = dataset.subjects[:2]
    arrays = {}
    for s in subjects:
        target = dataset.read_volume(s, "labels")
        arrays[s] = {"images": dataset.read_volume(s, "images"),
                     "target": target,
                     "mask": foreground_mask(dataset, s, target.shape)}
    single = VolumeInferenceService(flagship, mc=0, batch_size=BATCH,
                                    seed=SEED, device=DEVICE)
    serial = {s: single.predict(**arrays[s]) for s in subjects}
    del single
    pooled = VolumeInferenceService(flagship, mc=0, batch_size=BATCH,
                                    seed=SEED, device=DEVICE,
                                    mesh=Mesh(devices), subject_parallel=True)
    threads, each = SERVE_POOL_REQUESTS
    order = [subjects[(k + i) % 2] for k in range(threads)
             for i in range(each)]

    def client(k):
        return [(s, *pooled.predict_timed(**arrays[s]))
                for s in order[k * each:(k + 1) * each]]

    evalstats.fused_eval_stats.launches = 0
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        answers = [a for r in pool.map(client, range(threads)) for a in r]
    seconds = time.perf_counter() - t0
    if evalstats.fused_eval_stats.launches != len(answers):
        raise AssertionError(
            f"mesh throughput serve: fused_eval_stats launched "
            f"{evalstats.fused_eval_stats.launches} times for {len(answers)} "
            "scored requests")
    for s, out, _ in answers:
        same_arrays("mesh throughput", out, serial[s])
    device_s = float(np.mean([d for _, _, d in answers]))
    log(f"mesh throughput serve_deterministic: pool of {pooled.pool_size}, "
        f"{threads} client threads x {each} scored requests in {seconds:.2f} "
        f"s = {len(answers) / seconds:.3f} requests/s, mean device "
        f"{device_s:.3f} s a request (CUDA events), every answer bitwise the "
        "single-device service's")
    return {"launches": len(answers), "requests": len(answers),
            "seconds": seconds, "requests_per_s": len(answers) / seconds,
            "device_s": device_s}


def mesh_phase(tmp, dataset, checkpoints):
    """The mesh phase: the inference paths on a 2-entry mesh
    (:func:`mesh_devices`) against the single device on the same weights
    (the staged phase's checkpoints) and subjects: MC20 f32 with no mesh
    (the reference), on a one-card mesh, in latency mode (the eval kernel
    once per data device and subject) and in throughput mode (once per
    subject; the CSVs byte for byte the reference's); MC20 in bf16 + fast
    + int8 single and in latency mode (the int8 conv 20 a forward and
    device); the 10-member ensemble in bf16 + fast + fold single and on a
    2 x 1 model x data mesh; the sharded eval on the reference's planes;
    a throughput-mode service. Each mesh path's eval planes and every CSV
    cell are held against its single device's (:func:`mesh_path`).
    Returns ({mesh path: the eval kernel's
    by_path record}, {int8 path: the int8 kernel's record}, the sharded
    eval's record)."""
    from rcu_tpu_torch.eval.direct import load_model
    from rcu_tpu_torch.parallel import Mesh, make_mesh
    from rcu_tpu_torch.parallel.ensemble import make_ensemble_mesh
    t_phase = time.perf_counter()
    devices, what = mesh_devices()
    log(f"mesh devices: {[str(d) for d in devices]} ({what})")
    n = len(dataset.subjects)
    by_path, int8_paths = {}, {}
    flagship = load_model(checkpoints["flagship"], "best", DEVICE)

    def path(label, models, reference, plane_bar, eval_launches, **kwargs):
        record, ref, planes = mesh_path(label, dataset, tmp, models, devices,
                                        reference, plane_bar, eval_launches,
                                        **kwargs)
        by_path["mesh_" + label.replace(" ", "_")] = record
        return record, ref, planes

    # MC20 f32: the single device, one card as a mesh, latency, throughput
    mc = dict(mc=MC_STEPS)
    single, ref, planes = path("none mc", flagship, None, 0.0, n, **mc)
    one, _, _ = path("one_card mc", flagship, ref, MESH_F32_PLANE_BAR, n,
                     mesh=make_mesh(devices=devices[:1]), **mc)
    path("latency mc", flagship, ref, MESH_F32_PLANE_BAR, 2 * n,
         mesh=Mesh(devices), **mc)
    _, out, _ = path("throughput mc", flagship, ref, 0.0, n,
                     mesh=Mesh(devices), subject_parallel=True, **mc)
    if csv_texts(*out[:2]) != csv_texts(*ref[:2]):
        raise AssertionError("mesh throughput mc: the CSVs are not the "
                             "single device's byte for byte")
    log(f"mesh throughput mc: the CSVs byte for byte the single device's; "
        f"one card as a mesh {one['s_per_subject']:.3f} s/subject against "
        f"{single['s_per_subject']:.3f} with no mesh")
    sharded = sharded_eval_check(planes, devices)
    del planes

    # MC20 bf16 + fast + int8: one calibration, then the single device and
    # the latency mesh (a forward of each part on each device)
    quant = _calibrated_quant_model(
        load_model(checkpoints["flagship"], "best", DEVICE, **BF16_FAST),
        dataset, BATCH, SEED, skip_levels=INT8_SKIP)
    launches = int8_sites_per_forward() * -(-BRATS[0] // BATCH) * n
    _, int8_ref, _ = path("none mc_bf16_fast_int8", quant, None, 0.0, n,
                          int8_launches=launches, **mc)
    path("latency mc_bf16_fast_int8", quant, int8_ref, MESH_BF16_PLANE_BAR,
         2 * n,
         int8_launches=2 * launches, mesh=Mesh(devices), **mc)
    for label in ("mesh_none_mc_bf16_fast_int8",
                  "mesh_latency_mc_bf16_fast_int8"):
        record = by_path[label]
        int8_paths[label] = {"launches": record["int8_launches"],
                             "s_per_subject": record["s_per_subject"],
                             "peak_gb": record["peak_gb"]}
    del quant

    # the 10-member ensemble, bf16 + fast + fold: members over the model
    # axis, one data device
    members = [load_model(d, "best", DEVICE, **BF16_FAST_FOLD)
               for d in checkpoints["ensemble"]]
    _, ens_ref, _ = path("none ensemble_bf16_fast_fold", members, None, 0.0,
                         n, strategy="ensemble")
    path("latency ensemble_bf16_fast_fold_model2x1", members, ens_ref,
         MESH_BF16_PLANE_BAR, n, strategy="ensemble",
         mesh=make_ensemble_mesh(2, devices))
    del members

    by_path["mesh_throughput_serve_deterministic"] = pooled_service_check(
        checkpoints["flagship"], dataset, devices)
    log(f"mesh phase: {time.perf_counter() - t_phase:.1f} s")
    return by_path, int8_paths, sharded


# --------------------------------------------------------- mesh training

# one SGD step, mesh against single device, on the same batch and
# generator (tests/test_parallel.py's lr and bar): the loss relative;
# every parameter and BatchNorm statistic |a - b| <= atol + rtol |b|
MESH_TRAIN_LR = 1e-2
MESH_TRAIN_LOSS_RTOL = 1e-5
MESH_TRAIN_RTOL, MESH_TRAIN_ATOL = 1e-4, 1e-6
# the Adam epoch on the mesh against the single device's (train phase):
# its first loss (no update yet) at the step's bar; the later losses
# relative and the validation dice absolute within these (Adam turns
# rounding noise in near-zero gradients into lr-sized steps, so weights
# are not compared). Set at ~20x and ~200x this phase's readings on an
# H100 80GB HBM3 at 700 W (the largest loss 5.4e-5, the dice 2.3e-7-4.6e-7)
MESH_LOOP_LOSS_RTOL, MESH_LOOP_DICE_ATOL = 1e-3, 1e-4
MESH_PROFILED = (2, 5)  # ProfilerHook's steps [start, stop)
ENSEMBLE_CONFIG = "config/train_ensemble/train_brats_ensemble_{}.yaml"


def states_apart(got, want):
    """Two models' state dicts: (the largest |a - b| / (atol + rtol |b|) over
    every float tensor at the SGD bar, bitwise equal)."""
    share, bitwise = 0.0, True
    for (name, a), b in zip(got.state_dict().items(),
                            want.state_dict().values()):
        if not a.dtype.is_floating_point:
            continue
        bitwise &= torch.equal(a, b)
        diff = (a.double() - b.double()).abs()
        share = max(share, float((diff / (MESH_TRAIN_ATOL + MESH_TRAIN_RTOL
                                          * b.double().abs())).max()))
    return share, bitwise


def sgd_states(configs, devices):
    """Train states of the flagship from ``configs[i].seed + i`` on
    ``devices[i]``, SGD at ``MESH_TRAIN_LR``."""
    from rcu_tpu_torch.engine.state import create_train_state
    from rcu_tpu_torch.models import get_optimizer
    sgd = get_optimizer("sgd", {"lr": MESH_TRAIN_LR})
    return [create_train_state(get_model(cfg.model.type, cfg.model.params),
                               sgd, cfg.seed + i, d)
            for i, (cfg, d) in enumerate(zip(configs, devices))]


def mesh_step_check(config, mesh, batch):
    """One SGD step of the flagship on ``mesh`` against the single device
    from the same weights, batch and generator."""
    single, = sgd_states([config], [DEVICE])
    state = copy.deepcopy(single)
    generator = lambda: steps.step_generator(SEED, 0, 0, DEVICE)  # noqa: E731
    want = steps.make_train_step()(single, batch, generator())
    got = steps.make_train_step(mesh=mesh)(state, batch, generator())
    loss_err = abs(float(got["loss"]) - float(want["loss"])) \
        / abs(float(want["loss"]))
    share, bitwise = states_apart(state.model, single.model)
    dice_err = abs(float(got["dice"]) - float(want["dice"]))
    log(f"mesh train step: one SGD step (lr {MESH_TRAIN_LR}) of the flagship "
        f"on {len(batch['valid'])} slices, mesh against single device: loss "
        f"{float(got['loss']):.6f} / {float(want['loss']):.6f} (relative "
        f"{loss_err:.2e}, bar {MESH_TRAIN_LOSS_RTOL}), dice delta "
        f"{dice_err:.2e}; parameters and BatchNorm statistics at "
        f"{share:.3f} of the bar (rtol {MESH_TRAIN_RTOL}, atol "
        f"{MESH_TRAIN_ATOL}), bitwise {bitwise}")
    if loss_err > MESH_TRAIN_LOSS_RTOL or share > 1.0:
        raise AssertionError("mesh train step: the mesh step misses the "
                             "single device's")
    return {"loss_rel_err": loss_err, "dice_err": dice_err,
            "state_bar_share": share, "bitwise": bitwise}


def trace_kernels(trace_dir):
    """The one Chrome trace under ``trace_dir``: (path, MB, CUDA kernel
    events)."""
    paths = sorted(os.path.join(trace_dir, f) for f in os.listdir(trace_dir)
                   if f.endswith(".pt.trace.json"))
    if len(paths) != 1:
        raise AssertionError(f"ProfilerHook wrote {paths}, not one trace")
    with open(paths[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return paths[0], os.path.getsize(paths[0]) / 1e6, kernels


def ensemble_configs(root):
    """The 10 shipped member configs on the smoke's stores, one epoch on
    the slices through the lesion."""
    from rcu_tpu_torch.engine import config as cfg_lib
    from rcu_tpu_torch.engine.config import ParametricNode
    configs = []
    for k in range(MEMBERS):
        cfg = cfg_lib.load(ENSEMBLE_CONFIG.format(k), "train-config")
        cfg.train_dir, cfg.split, cfg.epochs = root, "", 1
        cfg.train_data.dataset, cfg.valid_data.dataset = ("brats_train",
                                                          "brats_valid")
        cfg.train_data.selection_strategy = ParametricNode("with-foreground",
                                                           {})
        configs.append(cfg)
    return configs


def synced_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def fused_ensemble_check(root, devices, batch):
    """The 10 members on a 2 x 1 model x data mesh (5 a row): one lockstep
    SGD step against each member's solo step on one device (member 0 held
    at the SGD bar), then a timed lockstep step against 10 timed solo
    steps; then ``train_ensemble_fused`` for one epoch (Adam, the shipped
    configs) and each member's best checkpoint through
    ``eval.direct.load_model``."""
    from rcu_tpu_torch.eval.direct import load_model
    from rcu_tpu_torch.parallel import ensemble as ens_lib
    configs = ensemble_configs(root)
    mesh = ens_lib.make_ensemble_mesh(2, devices)
    placement = ens_lib.member_placement(MEMBERS, mesh)
    fused = sgd_states(configs, [d for d, _ in placement])
    solo = sgd_states(configs, [DEVICE] * MEMBERS)
    row_steps = {}
    for _, row in placement:
        row_steps.setdefault(row.devices, steps.make_train_step(mesh=row))
    member_steps = [row_steps[row.devices] for _, row in placement]
    single_step = steps.make_train_step()
    seed = configs[0].seed

    def lockstep(i):
        ens_lib.ensemble_step(fused, member_steps, [batch] * MEMBERS, [
            steps.seeded_generator((seed, 0, i, m), d)
            for m, (d, _) in enumerate(placement)])

    def solos(i):
        for m, state in enumerate(solo):
            single_step(state, batch,
                        steps.seeded_generator((seed, 0, i, m), DEVICE))

    control = copy.deepcopy(solo[0])
    lockstep(0)
    solos(0)
    share, bitwise = states_apart(fused[0].model, solo[0].model)
    # the control: member 0's solo step again from the same weights
    single_step(control, batch, steps.seeded_generator((seed, 0, 0, 0),
                                                       DEVICE))
    _, rerun_bitwise = states_apart(control.model, solo[0].model)
    del control
    fused_s, solo_s = synced_s(lambda: lockstep(1)), synced_s(lambda: solos(1))
    log(f"fused ensemble step: {MEMBERS} members on a 2 x 1 model x data "
        f"mesh, member 0 after its first step against its solo step at "
        f"{share:.3f} of the SGD bar, bitwise {bitwise} (the solo step "
        f"rerun from the same weights bitwise {rerun_bitwise}); one "
        f"lockstep step "
        f"of the {MEMBERS} members {fused_s:.3f} s against {MEMBERS} solo "
        f"steps {solo_s:.3f} s (batch {len(batch['valid'])}, synced)")
    if share > 1.0:
        raise AssertionError("fused ensemble: member 0 misses its solo step")
    del fused, solo
    t0 = time.perf_counter()
    members = ens_lib.train_ensemble_fused(configs, mesh=mesh)
    run_s = time.perf_counter() - t0
    x = batch["images"][:2].permute(0, 3, 1, 2)
    for m in members:
        model = load_model(m.model_files.model_dir, "best", DEVICE)
        share_m, same = states_apart(model, m.state.model)
        with torch.no_grad():
            finite = bool(torch.isfinite(model(x).logits).all())
        if not (same and finite and math.isfinite(m.best_score)):
            raise AssertionError(f"fused ensemble: {m.run_dir}'s best "
                                 f"checkpoint (bitwise {same}, finite "
                                 f"{finite}, score {m.best_score})")
    steps_run = min(m.train_data.nb_batches for m in members)
    log(f"fused ensemble run: train_ensemble_fused, {MEMBERS} members x "
        f"{steps_run} steps of {configs[0].train_data.batch_size} + "
        f"validation and checkpoints in {run_s:.2f} s; the {MEMBERS} best "
        f"checkpoints restore through eval.direct.load_model bitwise, "
        f"scores {[round(m.best_score, 4) for m in members]}")
    return {"member0_bar_share": share, "member0_bitwise": bitwise,
            "solo_rerun_bitwise": rerun_bitwise,
            "lockstep_s": fused_s, "solo_s": solo_s, "run_s": run_s,
            "run_steps": steps_run}


def mesh_train_phase(tmp, stores, single):
    """Training on a 2-entry mesh (:func:`mesh_devices`) at flagship width
    (config/train_brats_baseline.yaml, batch 32) on the train phase's
    stores: one SGD step against the single device; one epoch of
    ``strategies.train_default(mesh=)`` with Adam against the train
    phase's single-device run (``single``) under a ``ProfilerHook``,
    whose trace must hold CUDA kernels; the fused 10-member ensemble
    (:func:`fused_ensemble_check`); the practical HBM rate and the ring
    over the mesh devices. Training launches neither hand kernel.
    Returns ({check: numbers}, the practical HBM rate in bytes/s)."""
    from rcu_tpu_torch import strategies
    from rcu_tpu_torch.engine import databuild
    from rcu_tpu_torch.parallel import Mesh
    from rcu_tpu_torch.utils.profiling import (ProfilerHook,
                                               measure_practical_hbm,
                                               measure_practical_ici)
    t_phase = time.perf_counter()
    devices, what = mesh_devices()
    log(f"mesh training devices: {[str(d) for d in devices]} ({what})")
    mesh = Mesh(devices)
    root = _subdir(tmp, "mesh_train")
    out = {}
    evalstats.fused_eval_stats.launches = 0
    int8conv.int8_conv.launches = 0
    with memory_stores(stores):
        config = train_config("default", root, "brats_train", "brats_valid")
        loader = databuild.build_data(config.train_data,
                                      seed=config.seed).loader
        batch = {k: torch.from_numpy(v).to(DEVICE)
                 for k, v in next(iter(loader)).items()}
        out["step"] = mesh_step_check(config, mesh, batch)

        trace_dir = _subdir(tmp, "mesh_train_trace")
        loop, record = run_training(
            "mesh brats default", strategies.train_default, config,
            config.train_data.batch_size, devices=devices, mesh=mesh,
            extra_hooks=[ProfilerHook(trace_dir, *MESH_PROFILED)])
        losses, want = record["losses"], single["losses"]
        if len(losses) != len(want):
            raise AssertionError(f"mesh loop: {len(losses)} steps against "
                                 f"{len(want)}")
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
        dice_err = abs(record["score"] - single["score"])
        path, mb, kernels = trace_kernels(trace_dir)
        log(f"mesh train loop: one epoch of brats default (adam) on the mesh "
            f"against the single device: {record['step_ms']:.2f} / "
            f"{single['step_ms']:.2f} ms/step after {TRAIN_WARMUP} warm-up "
            f"steps (the host's enqueue {record['enqueue_ms']:.2f} / "
            f"{single['enqueue_ms']:.2f} ms/step), {record['per_s']:.1f} / "
            f"{single['per_s']:.1f} slices/s, "
            f"peak GB per device {record['peak_gb_per_device']} / "
            f"{single['peak_gb']:.2f}; losses relative to the single "
            f"device's: first {rel[0]:.2e} (bar {MESH_TRAIN_LOSS_RTOL}), the "
            f"largest {max(rel):.2e} (bar {MESH_LOOP_LOSS_RTOL}); validation "
            f"dice {record['score']:.4f} / {single['score']:.4f} (delta "
            f"{dice_err:.2e}, bar {MESH_LOOP_DICE_ATOL})")
        log(f"mesh train profile: ProfilerHook steps {MESH_PROFILED[0]}-"
            f"{MESH_PROFILED[1] - 1} -> {os.path.basename(path)}, {mb:.1f} MB, "
            f"{len(kernels)} CUDA kernel events")
        if rel[0] > MESH_TRAIN_LOSS_RTOL or max(rel) > MESH_LOOP_LOSS_RTOL \
                or dice_err > MESH_LOOP_DICE_ATOL:
            raise AssertionError("mesh train loop: the mesh run misses the "
                                 "single device's")
        if not kernels:
            raise AssertionError(f"{path} holds no CUDA kernels")
        record.update(loss_rel_err=rel, dice_err=dice_err,
                      trace_mb=mb, trace_kernels=len(kernels))
        record["busy_share"] = profile_train_steps(loop,
                                                   label="mesh brats default")
        out["loop"] = record
        del loop
        out["ensemble"] = fused_ensemble_check(root, devices, batch)
    launched = (evalstats.fused_eval_stats.launches,
                int8conv.int8_conv.launches)
    if launched != (0, 0):
        raise AssertionError(f"mesh training launched the hand kernels "
                             f"{launched} times")
    hbm = measure_practical_hbm(device=DEVICE)
    ici = measure_practical_ici(mesh)
    log(f"practical HBM: {hbm / 1e9:.1f} GB/s (multiply-add stream over "
        f"512 MiB, CUDA events, best of 3); ring over the mesh devices "
        f"({what}): {ici / 1e9:.1f} GB/s a link, one direction")
    out["practical_hbm_gb_s"], out["ring_gb_s"] = hbm / 1e9, ici / 1e9
    log(f"mesh training phase: {time.perf_counter() - t_phase:.1f} s")
    return out, hbm


def main():
    t_start = time.perf_counter()
    hbm_rate = device_phase()
    summaries = build_phase()
    ptxas = summaries["evalstats"]
    record = kernel_phase(hbm_rate, ptxas)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dataset = BratsLikeDataset(tmp)
        log(f"synthetic data: {time.perf_counter() - t0:.1f} s")
        model = seeded_unet(SEED, middle_batch(dataset).to(DEVICE))
        cpu_batch, cpu_logits = gpu_vs_cpu_check(model, dataset)
        record["launches"], planes = main_path_phase(
            model, dataset, os.path.join(tmp, "eval"))
        label = f"real planes of {dataset.subjects[0]} {BRATS}"
        check_kernel(planes, DEFAULT_THRESHOLDS, label)
        real = time_kernel(planes, label, hbm_rate, ptxas)
        record["real_planes_ms"] = real["ms"]
        record["real_planes_kernel_ms"] = real["kernel_ms"]
        record["real_planes_bound_share"] = real["bound_share"]
        del planes
        forward_breakdown(model, dataset, cpu_batch, cpu_logits)
        profile_phase(model, dataset, os.path.join(tmp, "profile"))
        by_path, err, families = strategies_phase(dataset, tmp, hbm_rate,
                                                  ptxas)
        checkpoints = save_staged_checkpoints(tmp, model, families)
        variants, variant_err = variants_phase(model, families, dataset, tmp,
                                               hbm_rate, ptxas)
        t0 = time.perf_counter()
        int8_record, int8_paths = int8_phase(model, families, dataset, tmp,
                                             hbm_rate, ptxas)
        log(f"int8 phase: {time.perf_counter() - t0:.1f} s")
        del families, model
        t0 = time.perf_counter()
        isic_paths, isic_int8, axis, isic_err = isic_phase(tmp, hbm_rate,
                                                           ptxas)
        log(f"isic phase: {time.perf_counter() - t0:.1f} s")
        train_paths, train_err, train_runs, train_stores = train_phase(tmp)
        staged_paths, staged_err = staged_phase(tmp, dataset, checkpoints,
                                                hbm_rate, ptxas)
        serve_paths, serve_int8 = serve_phase(tmp, dataset, checkpoints)
        mesh_paths, mesh_int8, sharded = mesh_phase(tmp, dataset,
                                                    checkpoints)
        mesh_train, practical_hbm = mesh_train_phase(
            tmp, train_stores, train_runs["brats_default"])
        del train_stores
    record["by_path"] = {"mc": {"launches": record["launches"]}, **by_path,
                         **variants, **int8_paths, **isic_paths,
                         **train_paths, **staged_paths, **serve_paths,
                         **mesh_paths}
    record["sharded"] = sharded
    record["launches"] = sum(p["launches"] for p in record["by_path"].values())
    record["max_abs_err"] = max(record["max_abs_err"], err, variant_err,
                                isic_err, staged_err)
    record["image_axis"] = axis
    # the eval kernel's bound at the practical memory rate beside the spec's
    record["practical_hbm_bytes_per_s"] = practical_hbm
    record["practical_bound_ms"] = record["bound_ms"] * hbm_rate / practical_hbm
    log(f"fused_eval_stats bound: {record['bound_ms']:.4f} ms at the spec's "
        f"{hbm_rate / 1e12:.2f} TB/s, {record['practical_bound_ms']:.4f} ms "
        f"at the practical {practical_hbm / 1e12:.3f} TB/s")
    int8_record["by_path"]["isic_mc_bf16_fast_int8"] = isic_int8
    int8_record["by_path"]["serve_mc_bf16_fast_int8"] = serve_int8
    int8_record["by_path"].update(mesh_int8)
    int8_record["launches"] += isic_int8["launches"] + serve_int8["launches"] \
        + sum(p["launches"] for p in mesh_int8.values())
    log(f"smoke run: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"training": train_runs, "mesh_training": mesh_train,
                    "card_vs_cpu_grad_err": train_err}))
    log(json.dumps({"kernels": [record, int8_record]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
