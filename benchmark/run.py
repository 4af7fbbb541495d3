"""Run one cell of the benchmark of ``rcu_tpu_torch`` on the CUDA cards of
this machine and print its result as the last line of standard output:

  python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
      --trace <0|1>

Exits non-zero, printing no result, without a card (or with fewer than
the cell asks for), where the program's package is not in this checkout,
or where the JAX stack or the JAX package was loaded. The program's build
and kernel caches live in ``.bench_cache/`` and ``rcu_tpu_torch/_build/``
of this checkout; the eval's CSVs and the train run's directory go to a
directory under ``TMPDIR`` that the run removes.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the script's own directory would shadow standard modules (trace, ...)
sys.path[0] = ROOT
_CACHE = os.path.join(ROOT, ".bench_cache")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(_CACHE, _sub)


def process_started_at() -> float:
    """This process's start on CLOCK_BOOTTIME, from /proc (10 ms ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def _plain(value):
    if isinstance(value, float) and not math.isfinite(value):
        return repr(value)
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    return value


def main(argv=None) -> int:
    started_at = process_started_at()
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = {c["name"]: c for c in json.load(f)["workloads"]}
    if args.workload not in cells:
        print(f"no workload '{args.workload}' in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    chips = int(cells[args.workload]["chips"])
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"the cell needs {chips} CUDA card(s); this machine has "
              f"{cards}", file=sys.stderr)
        return 2
    import rcu_tpu_torch
    package = os.path.dirname(os.path.abspath(rcu_tpu_torch.__file__))
    if os.path.commonpath([package, ROOT]) != ROOT:
        print(f"rcu_tpu_torch is loaded from {package}, not from this "
              f"checkout {ROOT}", file=sys.stderr)
        return 2

    from benchmark import harness
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              args.trace, torch.device("cuda", 0),
                              started_at)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for step, seconds in result.pop("setup_phases"):
        print(f"set-up {step} done at {seconds!r} s", file=sys.stderr)
    for line in harness.check_lines(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_plain(result)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
