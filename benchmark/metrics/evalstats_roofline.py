"""evalstats_roofline: the least time the eval reduction kernel's bytes
take at the card's published HBM rate (11 B a voxel: two float32 planes
and three uint8 planes, each read once), over the kernel's device time in
the trace (%). The kernel is bound by bytes, not by operations."""
from benchmark import roofline
from benchmark.metrics._common import device_trace


def read(record):
    summary = device_trace(record)
    work = record["work"]
    if summary is None or "evalstats_bytes" not in work:
        return None
    seconds = sum(s for name, s in summary["kernel_s"].items()
                  if roofline.EVALSTATS_KERNEL in name)
    if seconds <= 0:
        return None
    bound = work["evalstats_bytes"] / roofline.PEAK_HBM_BYTES_PER_S
    return 100.0 * bound / seconds
