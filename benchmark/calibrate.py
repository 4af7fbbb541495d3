"""Readings that a cell's correctness limits are set from, on the card at
the cell's own size (the benchmark's runs do not run this):

  python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \
      [--control-seeds 1 2 3]

For each seed, the numbers that a run compares (``benchmark/compare``)
for sound runs of the program. For each control seed, the same numbers of
the control in the program's place: the reference with TF32 on, the
nearest precision below the cells' float32. A training cell also reads
the fault of half the batch left out (the reference on the first half,
the mean over it), both for epoch 0's first steps and for those of the
window's one epoch; a state left unchanged reads 1 by the measure and
needs no run. Prints one JSON line a reading, and appends it to
``--out`` where that is given.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def _eval_readings(run, items_n, control):
    from benchmark import compare
    from benchmark.drivers.direct_eval import EvalCell
    cell = EvalCell(run)
    cell.call(1, "warm-up")
    names, out = cell.call(items_n, "program")
    rows = cell.rows(out)
    picks = list(range(items_n))
    refs = cell.reference(names, picks)
    readings = [("program", compare.eval_gaps(rows, refs))]
    if control:
        got = cell.reference(names, picks, tf32=True)
        readings.append(("control_tf32", compare.eval_gaps(got, refs)))
    return readings


def _train_readings(run, control):
    from benchmark import compare
    from benchmark.drivers.train import TrainCell
    from rcu_tpu_torch.eval.device import full_float32
    cell = TrainCell(run)
    with full_float32():
        cell.start()
        for epoch in range(1, cell.last + 1):
            cell.epoch(epoch)
    got, got_window = cell.first_steps(), cell.window_steps()
    cell.free()
    want, want_window = cell.reference(), cell.reference_window()

    def gaps(first, window):
        return {**compare.train_gaps(first, want),
                **compare.window_gaps(window, want_window)}

    readings = [("program", gaps(got, got_window))]
    if control:
        readings.append(("control_tf32", gaps(
            cell.reference(tf32=True), cell.reference_window(tf32=True))))
        half = cell.batch // 2
        readings.append(("fault_half_batch", gaps(
            cell.reference(rows=half), cell.reference_window(rows=half))))
    return readings


def main(argv=None) -> int:
    import torch
    from benchmark import harness
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--items", type=int, default=None,
                        help="eval items a seed (default: the cell's check)")
    parser.add_argument("--out", default=os.devnull,
                        help="a file the readings are appended to")
    args = parser.parse_args(argv)
    spec = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    device = torch.device("cuda", 0)
    seeds = [(s, False) for s in args.seeds] \
        + [(s, True) for s in args.control_seeds]
    with open(args.out, "a") as log:
        for seed, control in seeds:
            t0 = time.perf_counter()
            run = harness.Run(ROOT, spec, args.workload, seed, 0, False,
                              device, 0.0)
            try:
                if run.traffic["driver"] == "train":
                    readings = _train_readings(run, control)
                else:
                    n = args.items or int(run.traffic["check_items"])
                    readings = _eval_readings(run, n, control)
            finally:
                run.close()
            for kind, numbers in readings:
                line = json.dumps({"workload": args.workload, "seed": seed,
                                   "kind": kind, **numbers,
                                   "seconds": time.perf_counter() - t0})
                print(line, flush=True)
                log.write(line + "\n")
            del run
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
