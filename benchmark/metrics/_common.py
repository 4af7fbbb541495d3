"""Shared by the per-layer readers: a reader gets the traced run's record
(``cell``, ``driver``, ``window_s``, ``trace``: ``benchmark.trace``'s
summary, ``work``: the driver's counts from shapes) and returns a number,
or None where the record holds nothing for it to read."""


def device_trace(record):
    """The trace summary where the device ran something, else None."""
    summary = record.get("trace")
    if not summary or summary["busy_s"] <= 0 or not record.get("window_s"):
        return None
    return summary


def idle_share(record, driver):
    """100 x the traced window's share in which the device ran nothing."""
    summary = device_trace(record)
    if summary is None or record["driver"] != driver:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / record["window_s"])


def mfu(record, flops_key):
    """100 x the FLOPs counted from shapes over the seconds in which the
    trace shows the device busy, as a share of the published peak at the
    cell's precision. The busy time, not the window's: the profiler slows
    the host's side of the traced window, not the device's work; the
    device's idle share is its own metric."""
    work = record["work"]
    summary = device_trace(record)
    if summary is None or flops_key not in work:
        return None
    return 100.0 * work[flops_key] / summary["busy_s"] / work["peak_flops"]
