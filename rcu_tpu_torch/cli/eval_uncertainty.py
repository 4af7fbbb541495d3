"""Offline uncertainty evaluation (``bin/eval_uncertainty.py`` counterpart):
reads the NIfTI artifacts of the staged test runs and writes the four CSV
families (``minmax/``, ``ece[_foreground]/``, ``calibration/``,
``uncertainty/``) under the dataset's eval dir (``directories``).

The same flags and defaults: ``--ds {brats,isic} --ids <strategy ids>
--act {minmax,ece_dice,calib,bnf_ue}``; ``--device`` (default cuda; cpu
runs the eval kernel's plain version) and ``--devices N`` (each subject's
reductions split over a mesh of N devices of ``--device``'s kind, one
kernel launch each: ``eval.actions.MetricPass``). A subject's files are
read once for every pass; one thread reads the next subject while the
passes run.

  python -m rcu_tpu_torch.cli.eval_uncertainty --ds brats --ids baseline \\
      --act minmax ece_dice calib bnf_ue [--device cpu] [--devices N]
"""
import argparse
import concurrent.futures
import os
import time

DEFAULT_IDS = ["baseline", "baseline_mc", "center", "center_mc", "ensemble",
               "auxiliary_feat", "auxiliary_segm", "aleatoric"]
DEFAULT_ACTIONS = ["minmax", "ece_dice", "calib", "bnf_ue"]


def main(dataset, to_eval, action_names, n_devices=None, device=None) -> dict:
    """Evaluate the runs ``to_eval`` of ``dataset``; returns, per run id,
    its subjects, seconds, the seconds its reads took on the read-ahead
    thread (``read_s``) and the seconds of its passes (``passes_s``)."""
    from rcu_tpu_torch import directories as dirs
    from rcu_tpu_torch.cli import _cli
    from rcu_tpu_torch.eval import actions as act_lib
    from rcu_tpu_torch.eval import analysis, evaldata as evdata

    if dataset not in ("brats", "isic"):
        raise ValueError('chose "brats" or "isic" as dataset')
    mesh = _cli.mesh_from_devices(n_devices, device)
    if dataset == "brats":
        eval_data_list = evdata.get_brats_eval_data(to_eval)
        ece_details, base_dir = "foreground", dirs.BRATS_EVAL_DIR
    else:
        eval_data_list = evdata.get_isic_eval_data(to_eval)
        ece_details, base_dir = "", dirs.ISIC_EVAL_DIR

    min_max_dir = os.path.join(base_dir, dirs.MINMAX_NAME)
    actions = act_lib.get_actions(action_names, min_max_dir, base_dir,
                                  ece_details, mesh=mesh, device=device)
    timings = {}
    for entry in eval_data_list:
        for action in actions:
            action.setup_eval(entry)
        for action in actions:
            action.start_eval()

        def prewarm(sf):
            """The subject's files for every pass, on the read-ahead
            thread."""
            t0 = time.perf_counter()
            loader = analysis.Loader()
            for action in actions:
                loader.get_data(sf, **action.load_spec)
            return loader, time.perf_counter() - t0

        subject_files = entry.subject_files
        run_t0, read_s, passes_s = time.perf_counter(), 0.0, 0.0
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            future = pool.submit(prewarm, subject_files[0]) if subject_files else None
            for i, sf in enumerate(subject_files):
                print(f"[{i + 1}/{len(subject_files)}] {sf.subject}",
                      end=" ", flush=True)
                loader, read = future.result()
                read_s += read
                if i + 1 < len(subject_files):
                    future = pool.submit(prewarm, subject_files[i + 1])
                start = time.perf_counter()
                for action in actions:
                    action.eval_subject(sf, loader)
                passes_s += time.perf_counter() - start
                print(f"({time.perf_counter() - start}s)")

        for action in actions:
            action.finish_eval()
        timings[entry.id_] = {"subjects": len(subject_files),
                              "seconds": time.perf_counter() - run_t0,
                              "read_s": read_s, "passes_s": passes_s}
    return timings


def cli():
    parser = argparse.ArgumentParser()
    parser.add_argument("--ds", type=str, nargs="?",
                        help="the dataset to evaluate the runs on")
    parser.add_argument("--ids", type=str, nargs="*",
                        help="the ids of the runs to be evaluated")
    parser.add_argument("--act", type=str, nargs="*",
                        help="the names of the evaluation configuration")
    parser.add_argument("--devices", type=int, default=None,
                        help="shard each subject's eval reductions over "
                             "a mesh of N devices (default: one device)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default cuda)")
    args = parser.parse_args()

    ds = args.ds or "brats"
    to_evaluate = args.ids if args.ids else DEFAULT_IDS
    action_ids = args.act if args.act else DEFAULT_ACTIONS

    print("\n**************************************")
    print(f"dataset: {ds}")
    print(f"to_evaluate: {to_evaluate}")
    print(f"eval_actions: {action_ids}")
    print("**************************************\n")

    main(ds, to_evaluate, action_ids, n_devices=args.devices,
         device=args.device)


if __name__ == "__main__":
    cli()
