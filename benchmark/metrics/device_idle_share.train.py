"""device_idle_share.train: the share of the training window in which no
operation ran on the device, from the profiler's trace (%)."""
from benchmark.metrics._common import idle_share


def read(record):
    return idle_share(record, "train")
