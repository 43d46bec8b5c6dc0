"""FLOPs of the completed SE steps (the U-Net's forward and backward, the
loss's forwards and its backward to the estimate) over the window's wall
time and the H100 SXM f32 peak, in percent."""

from benchmark import readers


def read(run):
    return readers.mfu(run, readers.se_flops(run))
