"""transunet_mfu.eval: TransUNet's FLOPs in the eval window, counted from
shapes (``benchmark/transunet_flops.py``: its trunk's an image times the
program's counter ``transunet.trunk_images``, its encoder's and decoder's a
sample times ``transunet.samples``), over the seconds in which the trace
shows the device busy, as a share of the card's published peak at the
cell's compute precision (%). None where the program has no such
counters or counted nothing."""
from benchmark.metrics._common import device_trace


def read(record):
    summary, work = device_trace(record), record["work"]
    if summary is None or "transunet_trunk_flops" not in work:
        return None
    try:
        from rcu_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    counts = counters()
    images = counts.get("transunet.trunk_images", 0)
    samples = counts.get("transunet.samples", 0)
    if images <= 0 or samples <= 0:
        return None
    flops = work["transunet_trunk_flops"] * images \
        + work["transunet_sample_flops"] * samples
    return 100.0 * flops / summary["busy_s"] / work["peak_flops"]
