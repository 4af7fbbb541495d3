"""swin_share.eval: the seconds of Swin UNETR's four Swin stages and their
mergings on the device in the eval window (the program's ``swinunetr.swin``
spans, each timed by a pair of CUDA events on its stream,
``utils.profiling.device_seconds``), over the seconds in which the trace
shows the device busy (%). None where the program keeps no such reading or
recorded none."""
from benchmark.metrics._common import device_trace


def read(record):
    summary = device_trace(record)
    if summary is None:
        return None
    try:
        from rcu_tpu_torch.utils import profiling
    except ImportError:
        return None
    device_seconds = getattr(profiling, "device_seconds", None)
    if device_seconds is None:
        return None
    seconds = device_seconds().get("swinunetr.swin", 0.0)
    return 100.0 * seconds / summary["busy_s"] if seconds > 0 else None
