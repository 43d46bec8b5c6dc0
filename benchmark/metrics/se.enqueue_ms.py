"""Median host time of a ``train_step`` call in the window, in ms (a wrapper on
the instance times it)."""

from benchmark import readers


def read(run):
    return readers.median_ms(run.counters.get("host_s", []))
