"""evals.parse_pred: the median, over the traced stretch's batches, of
the time inside the `bench.parse_pred` range in which the device ran
nothing: the host half of parse_pred (the copies to the host and the
NMS) that the card waits for, the forward's own time left out."""
from benchmark.readers import median_ms


def read(cell, run):
    if run.trace is None:
        return None
    return median_ms(run.trace.idle_in("bench.parse_pred"))
