"""Device idle time while the host was in a span that feeds the card
(``predict.resolve``, ``engine.probe``, ``engine.plan``, ``engine.host_batch``,
``engine.native_ingest``) per ``predict`` call, in ms."""

from benchmark import spans

SPANS = ("predict.resolve", "engine.probe", "engine.plan", "engine.host_batch",
         "engine.native_ingest")


def read(run):
    return spans.idle_ms_per_call(run, SPANS)
