"""Direct one-pass test+eval on the GPU (``bin/eval_direct.py`` counterpart).

Streams each test-split subject through inference and the fused eval
kernel and writes the eval CSV families. The six protocols, detected from
the checkpoint and the config as ``rcu_tpu.eval.direct`` does, or named with
``-strategy``:
- ``mc``: MC-dropout mean and entropy (baseline_mc, center_mc);
- ``deterministic`` (``-mc 0``): one forward (baseline, center);
- ``aleatoric``: the sigma head, rescaled by the run's global bounds;
- ``ensemble``: the members' mean softmax and its entropy;
- ``auxiliary_feat``: a PostNet on a frozen segmenter's features;
- ``auxiliary_segm``: an error net over the images and a baseline
  prediction stored as a second labels channel.
Convolutions run in full float32 (``evaluate_subjects`` switches TF32
off), as the parity bar of the f32 path needs, unless the JAX CLI's
inference variants ask for more speed: ``-dtype bfloat16`` (the compute
dtype; weights and BatchNorm stay f32, the sigma and PostNet heads run in
f32), ``-fast_decoder`` (concat-free decoder and fused upsample, U-Nets
only), ``-fold_bn`` (BatchNorms folded into the convs at load; not
with the mc protocol), ``-quantize`` (int8 trunk convs after a one-batch
calibration; mc, deterministic and ensemble) and ``-quantize_skip N``
(with ``-quantize``: the N finest resolution levels stay in the compute
dtype; default 1). ``-eval_tree`` writes the staged eval engine's tree
(``calibration/``, ``ece[_foreground]/``, ``uncertainty/``, ``minmax/``)
in place of the flat layout. ``-devices N`` runs on a mesh of N devices
of ``-device``'s kind (cuda: cuda:0..N-1; cpu: the virtual mesh):
each volume's batches split over them (latency), or with
``-throughput`` whole subjects round-robin onto them; the CSVs are the
single device's.

Usage:
  python -m rcu_tpu_torch.cli.eval_direct -config_file config/test_brats_baseline_mc.yaml \
      [-run_id baseline_mc] [-out_dir out/eval/brats/direct] [-mc 20] \
      [-strategy ensemble] [-unmasked] [-device cpu] \
      [-dtype bfloat16] [-fast_decoder] [-fold_bn] [-quantize [-quantize_skip 1]] \
      [-eval_tree] [-devices N [-throughput]]
"""
import argparse
import logging
import os


def main(config_file, run_id=None, out_dir=None, mc=None, unmasked=False,
         device=None, strategy=None, eval_tree=False, devices=None,
         throughput=False, dtype=None, fast_decoder=False, fold_bn=False,
         quantize=False, quantize_skip=None):
    from rcu_tpu_torch.cli import _cli
    from rcu_tpu_torch.engine import config as cfg_lib
    from rcu_tpu_torch.eval.direct import evaluate_direct

    mesh = _cli.mesh_from_devices(devices, device)
    if throughput and mesh is None:
        raise ValueError("-throughput needs -devices N > 1")

    config = cfg_lib.load(config_file, expected_type="test-config")
    run_id = run_id or config.test_name or "baseline"
    out_dir = out_dir or os.path.join(
        os.path.dirname(config.model_dir or "."), "eval_direct")
    eces = evaluate_direct(config, out_dir, run_id=run_id, mc=mc,
                           masked=not unmasked, strategy=strategy,
                           device=device, dtype=dtype,
                           fast_decoder=fast_decoder, fold_bn=fold_bn,
                           quantize=quantize,
                           quantize_skip_levels=quantize_skip,
                           layout="eval_tree" if eval_tree else "flat",
                           mesh=mesh, subject_parallel=throughput)
    for subject, ece in eces.items():
        print(f"{subject}: ece={ece:.5f}")
    print(f"wrote eval CSVs to {out_dir}")


def cli():
    from rcu_tpu_torch.eval.direct import STRATEGIES
    parser = argparse.ArgumentParser(description="Direct one-pass test+eval (GPU)")
    parser.add_argument("-config_file", type=str, required=True)
    parser.add_argument("-run_id", type=str, default=None)
    parser.add_argument("-out_dir", type=str, default=None)
    parser.add_argument("-mc", type=int, default=None,
                        help="MC-dropout sample count (default others.mc "
                             "or 20; 0 = deterministic protocol)")
    parser.add_argument("-strategy", type=str, default=None,
                        choices=STRATEGIES,
                        help="protocol (default: detected from the "
                             "checkpoint and config)")
    parser.add_argument("-unmasked", action="store_true",
                        help="skip the BraTS t2>0 foreground mask")
    parser.add_argument("-device", type=str, default=None,
                        help="torch device (default cuda; cpu runs the "
                             "kernels' plain versions)")
    parser.add_argument("-dtype", type=str, default=None,
                        choices=("float32", "bfloat16"),
                        help="compute dtype (default float32); weights, "
                             "BatchNorm and the sigma/PostNet heads stay f32")
    parser.add_argument("-fast_decoder", action="store_true",
                        help="concat-free + fused-upsample U-Net decoder "
                             "(same checkpoints; accumulation-order "
                             "numerics)")
    parser.add_argument("-fold_bn", action="store_true",
                        help="fold BatchNorms into their convs at load "
                             "(deterministic single-forward protocols "
                             "only, not mc)")
    parser.add_argument("-quantize", action="store_true",
                        help="int8 PTQ trunk (mc/deterministic/ensemble): "
                             "calibrates activation scales on the first "
                             "test subject's centre slices, runs the trunk "
                             "convs in int8 (same checkpoints)")
    parser.add_argument("-quantize_skip", type=int, default=None,
                        help="with -quantize: keep the N finest resolution "
                             "levels in the compute dtype (default 1)")
    parser.add_argument("-devices", type=int, default=None,
                        help="run on a mesh of N devices of -device's kind "
                             "(default: one device)")
    parser.add_argument("-throughput", action="store_true",
                        help="with -devices N: whole subjects round-robin "
                             "across the devices (fastest testset wall "
                             "clock) instead of splitting each volume "
                             "(fastest single answer)")
    parser.add_argument("-eval_tree", action="store_true",
                        help="write the staged eval engine's directory "
                             "tree instead of the flat layout")
    args = parser.parse_args()
    if args.quantize_skip is not None and not args.quantize:
        parser.error("-quantize_skip only applies with -quantize")
    logging.basicConfig(level=logging.INFO)
    main(args.config_file, args.run_id, args.out_dir, args.mc, args.unmasked,
         args.device, args.strategy, args.eval_tree, args.devices,
         args.throughput, args.dtype, args.fast_decoder, args.fold_bn,
         args.quantize, args.quantize_skip)


if __name__ == "__main__":
    cli()
