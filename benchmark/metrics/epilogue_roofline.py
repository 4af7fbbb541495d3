"""epilogue_roofline: the least time the conv epilogue kernel's bytes take
at the card's published HBM rate (the program's counter
``unet.epilogue_bytes``: 8 B an element of every fused ConvBnRelu site,
read once and written once), over the device time of the kernels whose
name holds the one the program exports (``ops.cuda.convepilogue.KERNEL``)
in the trace (%). The kernel is bound by bytes. None where the program has
no such kernel or counter, or the trace shows no launch of it."""
from benchmark import roofline
from benchmark.metrics._common import device_trace


def read(record):
    summary = device_trace(record)
    if summary is None:
        return None
    try:
        from rcu_tpu_torch.ops.cuda import convepilogue
        from rcu_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    kernel = getattr(convepilogue, "KERNEL", None)
    nbytes = counters().get("unet.epilogue_bytes", 0)
    if not kernel or nbytes <= 0:
        return None
    seconds = sum(s for name, s in summary["kernel_s"].items()
                  if kernel in name)
    if seconds <= 0:
        return None
    return 100.0 * nbytes / roofline.PEAK_HBM_BYTES_PER_S / seconds
