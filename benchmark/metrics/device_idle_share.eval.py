"""device_idle_share.eval: the share of the eval window in which no
operation ran on the device: 1 - (union of the device's activity
intervals) / (window), from the profiler's trace (%)."""
from benchmark.metrics._common import idle_share


def read(record):
    return idle_share(record, "direct_eval")
