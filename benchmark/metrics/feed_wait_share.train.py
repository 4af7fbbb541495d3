"""feed_wait_share.train: the share of the training window in which the
train loop waited for its feed's next batch (the program's
``train.feed_wait`` spans, summed, over ``window_s``), in %. The program
records them only while a profiler runs, which in a traced run is the
window. None where the program keeps no such record, recorded no wait,
or dropped spans."""


def read(record):
    if record.get("driver") != "train" or not record.get("window_s"):
        return None
    from rcu_tpu_torch.utils import profiling
    spans = getattr(profiling, "spans", None)
    counters = getattr(profiling, "counters", None)
    if spans is None or counters is None or \
            counters().get("spans.dropped"):
        return None
    waits = [s.end_ns - s.start_ns for s in spans()
             if s.name == "train.feed_wait"]
    if not waits:
        return None
    return 100.0 * sum(waits) / 1e9 / record["window_s"]
