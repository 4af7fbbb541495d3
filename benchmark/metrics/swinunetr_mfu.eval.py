"""swinunetr_mfu.eval: Swin UNETR's FLOPs in the eval window, counted from
shapes (``benchmark/swinunetr_flops.py``: its shared prefix's an image times
the program's counter ``swinunetr.images``, the rest's a sample times
``swinunetr.samples``), over the seconds in which the trace shows the
device busy, as a share of the card's published peak at the cell's compute
precision (%). None where the program has no such counters or counted
nothing."""
from benchmark.metrics._common import device_trace


def read(record):
    summary, work = device_trace(record), record["work"]
    if summary is None or "swinunetr_shared_flops" not in work:
        return None
    try:
        from rcu_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    counts = counters()
    images = counts.get("swinunetr.images", 0)
    samples = counts.get("swinunetr.samples", 0)
    if images <= 0 or samples <= 0:
        return None
    flops = work["swinunetr_shared_flops"] * images \
        + work["swinunetr_sample_flops"] * samples
    return 100.0 * flops / summary["busy_s"] / work["peak_flops"]
