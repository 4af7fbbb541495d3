"""reader_voxels_per_s.eval: the direct eval's reader rate, the voxels of
the window's items (the program's counter ``eval.voxels``) over the
seconds its reader thread spent reading them (the program's
``direct.read`` spans, summed), in voxel/s. The program records them only
while a profiler runs, which in a traced run is the window. None where
the program keeps no such record, recorded nothing, or dropped spans."""


def read(record):
    if record.get("driver") != "direct_eval":
        return None
    from rcu_tpu_torch.utils import profiling
    spans = getattr(profiling, "spans", None)
    counters = getattr(profiling, "counters", None)
    if spans is None or counters is None:
        return None
    counts = counters()
    if counts.get("spans.dropped"):
        return None
    seconds = sum(s.end_ns - s.start_ns for s in spans()
                  if s.name == "direct.read") / 1e9
    voxels = counts.get("eval.voxels", 0)
    return voxels / seconds if voxels > 0 and seconds > 0 else None
