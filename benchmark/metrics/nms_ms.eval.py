"""evals.parse_pred's NMS: the median of the program's `parse_pred.nms`
spans (the greedy pass in the host library) in the batches before the
profiled stretch (`benchmark/recorder.py`)."""
from benchmark.recorder import median, span_ms


def read(cell, run):
    return median(span_ms(run, "parse_pred.nms"))
