"""evals.petr_decode, its host half and the caller, in the BEVFormer
cell: the median over the batches before the profiled stretch
(`benchmark/recorder.py`) of the next batch's `replay_start` − this
batch's `decode_end`, device marks placed on the host clock: the one copy
to the host, the caller's next copy-in of six images, the stream
runner's host half, the graph's copy-in of the carried BEV, and the card
waiting on them."""
from benchmark.recorder import gaps_ms, median


def read(cell, run):
    return median(gaps_ms(run, "decode_end", "replay_start",
                          next_batch=True))
