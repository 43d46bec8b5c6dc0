"""Share of the traced window in which no operation ran on the device, in
percent."""

from benchmark import readers


def read(run):
    return readers.idle_share(run)
