"""The least time the loss steps' attention backward needs (dQ; dK and dV;
every layer) over the device time of K2 and K3 in the trace, in percent."""

from benchmark import readers


def read(run):
    c = run.counters
    need = readers.k23_needed_ms(run, c["batch"], c["samples"], c["steps"])
    return readers.roofline(run, need, "flash_attention_bwd")
