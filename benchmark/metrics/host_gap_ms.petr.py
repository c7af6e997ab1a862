"""evals.petr_decode, its host half and the caller: the median over the
batches before the profiled stretch (`benchmark/recorder.py`) of the
next batch's `replay_start` − this batch's `decode_end`, device marks
placed on the host clock: the one copy to the host, the caller's next
copy-in of six images, and the card waiting on them."""
from benchmark.recorder import gaps_ms, median


def read(cell, run):
    return median(gaps_ms(run, "decode_end", "replay_start",
                          next_batch=True))
