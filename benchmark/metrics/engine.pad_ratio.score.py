"""Samples sent to the card (``transfer_stats()``: int16 bytes / 2 + f32 bytes
/ 4) over the real samples of the files embedded."""


def read(run):
    c = run.counters
    return c["samples_sent"] / c["samples_real"] if c.get("samples_real") else None
