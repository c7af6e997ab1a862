"""models forward (PETR): the model FLOPs (`work/petr_flops.py`) of the
replays before the profiled stretch (`benchmark/recorder.py`) over their
device time, each from its `replay_start` mark (after the graph's
copy-in) to its `replay_end` mark, CUDA events the program records on its
stream."""
from benchmark.readers import mfu
from benchmark.recorder import gaps_ms


def read(cell, run):
    t = gaps_ms(run, "replay_start", "replay_end")
    if not t:
        return None
    from benchmark.work.petr_flops import sample_flops
    return mfu(len(t) * run.counts["batch"] * sample_flops(cell.config),
               sum(t) / 1e3)
