"""Device idle time while the host was in a span that handles the results
(``predict.d2h``, ``predict.tables``, ``predict.write_results``) per
``predict`` call, in ms."""

from benchmark import spans

SPANS = ("predict.d2h", "predict.tables", "predict.write_results")


def read(run):
    return spans.idle_ms_per_call(run, SPANS)
