"""train_epilogue_roofline: the least time the train-mode epilogue kernels'
bytes take at the card's published HBM rate (the program's counter
``unet.train_epilogue_bytes``: of every fused train-mode ConvBnRelu site,
12 B an element forward and 20 B backward, each byte read or written
once), over the device time of the kernels whose name holds the prefix the
program exports (``ops.cuda.trainepilogue.KERNEL``) in the trace (%). The
kernels are bound by bytes. None where the program has no such kernels or
counter, or the trace shows no launch of them."""
from benchmark import roofline
from benchmark.metrics._common import device_trace


def read(record):
    summary = device_trace(record)
    if summary is None:
        return None
    try:
        from rcu_tpu_torch.ops.cuda import trainepilogue
        from rcu_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    kernel = getattr(trainepilogue, "KERNEL", None)
    nbytes = counters().get("unet.train_epilogue_bytes", 0)
    if not kernel or nbytes <= 0:
        return None
    seconds = sum(s for name, s in summary["kernel_s"].items()
                  if kernel in name)
    if seconds <= 0:
        return None
    return 100.0 * nbytes / roofline.PEAK_HBM_BYTES_PER_S / seconds
