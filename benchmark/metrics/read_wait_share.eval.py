"""read_wait_share.eval: the share of the eval window in which the
dispatching thread waited for the reader (the program's
``direct.wait_read`` spans, summed, over ``window_s``), in %. The program
records them only while a profiler runs, which in a traced run is the
window. None where the program keeps no such record, recorded no wait,
or dropped spans."""


def read(record):
    if record.get("driver") != "direct_eval" or not record.get("window_s"):
        return None
    from rcu_tpu_torch.utils import profiling
    spans = getattr(profiling, "spans", None)
    counters = getattr(profiling, "counters", None)
    if spans is None or counters is None or \
            counters().get("spans.dropped"):
        return None
    waits = [s.end_ns - s.start_ns for s in spans()
             if s.name == "direct.wait_read"]
    if not waits:
        return None
    return 100.0 * sum(waits) / 1e9 / record["window_s"]
