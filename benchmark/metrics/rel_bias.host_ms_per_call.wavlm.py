"""Host time in the program's span ``model.rel_bias`` (the buckets of a
length's offsets, cached per length, and the gather of the bias table, once
a forward) per completed ``predict`` call, in ms; None where the program
keeps no such span."""

from benchmark import spans


def read(run):
    recs = [r for r in spans.program_log(run) or () if r["name"] == "model.rel_bias"]
    calls = run.counters.get("calls")
    if not recs or not calls:
        return None
    return sum(r["end_ns"] - r["start_ns"] for r in recs) / 1e6 / calls
