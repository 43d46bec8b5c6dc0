"""FLOPs of the completed ``predict`` calls through WavLM Large
(``counts_wavlm.forward_flops``: frontend, projections, FFN, attention,
gates and bias, head; each file forward once, at its own length) over the
window's wall time and the H100 SXM f32 peak, in percent."""

from benchmark import counts_wavlm, readers


def read(run):
    c = run.counters
    if not c.get("calls"):
        return None
    return readers.mfu(run, counts_wavlm.scoring_flops(c["files"], c["calls"],
                                                       run.config["wavlm"], run.config["emb_dim"]))
