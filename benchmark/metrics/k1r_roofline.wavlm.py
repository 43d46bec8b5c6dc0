"""The least time the scored files' attention forward with the gated
relative-position bias needs (``counts_wavlm.k1r_bound``: K1's work, a
product and a sum a score, the gate and the table read once; each file over
its own frames, every layer) over the device time of the trace's
``flash_attention_fwd`` group (K1r alone in this cell), in percent."""

from benchmark import counts_wavlm, readers


def read(run):
    c = run.counters
    if not c.get("calls"):
        return None
    need = counts_wavlm.k1r_needed_ms(c["files"], c["calls"], run.config["wavlm"])
    return readers.roofline(run, need, "flash_attention_fwd")
