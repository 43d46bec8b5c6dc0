"""The least time the scored files' attention forward needs (each file over its
own frames, every layer) over K1's device time in the trace, in percent."""

from benchmark import readers


def read(run):
    c = run.counters
    need = readers.k1_needed_ms(run, c["files"], c["calls"])
    return readers.roofline(run, need, "flash_attention_fwd")
