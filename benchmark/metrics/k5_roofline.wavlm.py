"""The least time every LayerNorm of the scored files needs
(``counts_wavlm.layernorm_bytes``: each read and written once, at the HBM
rate; 7 frontend at 512 wide, the feature one, 48 in the blocks and the
encoder's, each file at its own frames) over K5's device time in the trace,
in percent."""

from benchmark import counts_wavlm, readers


def read(run):
    c = run.counters
    if not c.get("calls"):
        return None
    need = counts_wavlm.layernorm_needed_ms(c["files"], c["calls"], run.config["wavlm"])
    return readers.roofline(run, need, "layernorm_fwd")
