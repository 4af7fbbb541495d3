"""On the card: each real cell's control (the reference with TF32 on in
the program's place, the nearest precision below the cells' float32)
comes out as not correct against the cell's limits, and the program as
correct, on one seed and the items a run checks; the train cell's fault
of half the batch left out, in epoch 0's first steps and in the window's,
too. Run on the card with ``python -m pytest benchmark/tests -m cuda``."""
from __future__ import annotations

import json
import math
import os

import pytest
import torch

from tiny import REPO

CELLS = ("brats_mc20_f32", "isic_mc20_f32", "brats_train_f32")


def _fails(numbers, limits) -> bool:
    return any(not math.isfinite(numbers[k]) or numbers[k] > limits[k]
               for k in limits)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_bench_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's "
                    "own widths")
    from benchmark import calibrate, harness
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    run = harness.Run(REPO, spec, cell, 2 ** 31 + 101, 0, False,
                      torch.device("cuda", 0), 0.0)
    try:
        if run.traffic["driver"] == "train":
            readings = dict(calibrate._train_readings(run, control=True))
        else:
            readings = dict(calibrate._eval_readings(
                run, int(run.traffic["check_items"]), control=True))
    finally:
        run.close()
    assert not _fails(readings.pop("program"), run.limits)
    checked = {k: v for k, v in readings.items()
               if k.startswith(("control", "fault"))}
    assert checked
    for kind, numbers in checked.items():
        assert _fails(numbers, run.limits), (kind, numbers)
