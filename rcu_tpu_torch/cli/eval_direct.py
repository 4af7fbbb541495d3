"""Direct one-pass test+eval on the GPU (``bin/eval_direct.py`` counterpart).

Streams each test-split subject through MC-dropout inference and the fused
eval kernel and writes the eval CSV families. Ported protocols: ``mc`` and
``deterministic`` (``-mc 0``). Convolutions run in full float32: TF32 is
switched off, as the parity bar of the f32 path needs.

Usage:
  python -m rcu_tpu_torch.cli.eval_direct -config_file config/test_brats_baseline_mc.yaml \
      [-run_id baseline_mc] [-out_dir out/eval/brats/direct] [-mc 20] \
      [-unmasked] [-device cpu]
"""
import argparse
import logging
import os


def main(config_file, run_id=None, out_dir=None, mc=None, unmasked=False,
         device=None):
    import torch

    from rcu_tpu_torch.engine import config as cfg_lib
    from rcu_tpu_torch.eval.direct import evaluate_direct

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = cfg_lib.load(config_file)
    run_id = run_id or config.test_name or "baseline"
    out_dir = out_dir or os.path.join(
        os.path.dirname(config.model_dir or "."), "eval_direct")
    eces = evaluate_direct(config, out_dir, run_id=run_id, mc=mc,
                           masked=not unmasked, device=device)
    for subject, ece in eces.items():
        print(f"{subject}: ece={ece:.5f}")
    print(f"wrote eval CSVs to {out_dir}")


def cli():
    parser = argparse.ArgumentParser(description="Direct one-pass test+eval (GPU)")
    parser.add_argument("-config_file", type=str, required=True)
    parser.add_argument("-run_id", type=str, default=None)
    parser.add_argument("-out_dir", type=str, default=None)
    parser.add_argument("-mc", type=int, default=None,
                        help="MC-dropout sample count (default others.mc "
                             "or 20; 0 = deterministic protocol)")
    parser.add_argument("-unmasked", action="store_true",
                        help="skip the BraTS t2>0 foreground mask")
    parser.add_argument("-device", type=str, default=None,
                        help="torch device (default cuda; cpu runs the "
                             "kernels' plain versions)")
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    main(args.config_file, args.run_id, args.out_dir, args.mc, args.unmasked,
         args.device)


if __name__ == "__main__":
    cli()
