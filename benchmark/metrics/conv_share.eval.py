"""conv_share.eval: the share of the eval window's device kernel time
spent in kernels launched under aten::convolution or
aten::conv_transpose2d (%)."""
from benchmark.metrics._common import device_trace


def read(record):
    summary = device_trace(record)
    if summary is None or record["driver"] != "direct_eval":
        return None
    total = sum(summary["kernel_s"].values())
    return 100.0 * summary["conv_s"] / total if total > 0 else None
