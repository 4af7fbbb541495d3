"""eval_mfu: the published U-Net's convolution FLOPs of every forward in
the window, counted from shapes, over the seconds in which the trace shows
the device busy, as a share of the card's published peak at the cell's
compute precision (%)."""
from benchmark.metrics._common import mfu


def read(record):
    return mfu(record, "conv_flops")
