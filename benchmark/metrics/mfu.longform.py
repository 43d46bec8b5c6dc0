"""FLOPs of the completed ``predict`` calls (each file forward once, at its own
length) over the window's wall time and the H100 SXM f32 peak, in percent."""

from benchmark import readers


def read(run):
    return readers.mfu(run, readers.scoring_flops(run))
