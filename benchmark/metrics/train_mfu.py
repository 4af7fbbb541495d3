"""train_mfu: 3 x the forward's convolution FLOPs of every train step in
the window (32 slices a step), over the seconds in which the trace shows
the device busy, as a share of the card's published peak at the cell's
precision (%)."""
from benchmark.metrics._common import mfu


def read(record):
    return mfu(record, "train_flops")
