"""evals.petr_decode, its device half, in the BEVFormer cell: the median
over the batches before the profiled stretch (`benchmark/recorder.py`)
of `decode_end` − `replay_end` on the device clock (the clones of the
graph's outputs, the new BEV among them, and the decode's sort, gathers
and box decode)."""
from benchmark.recorder import gaps_ms, median


def read(cell, run):
    return median(gaps_ms(run, "replay_end", "decode_end"))
