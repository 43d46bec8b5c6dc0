"""FLOPs of the completed loss steps (two forwards and the backward to the
estimate) over the window's wall time and the H100 SXM f32 peak, in percent."""

from benchmark import readers


def read(run):
    return readers.mfu(run, readers.loss_flops(run))
