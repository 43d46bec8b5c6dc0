"""The least time the loss steps' attention forwards need (clean and estimate,
every layer) over K1's device time in the trace, in percent."""

from benchmark import readers


def read(run):
    c = run.counters
    need = readers.k1_needed_ms(run, [c["samples"]] * c["batch"], 2 * c["steps"])
    return readers.roofline(run, need, "flash_attention_fwd")
