"""models forward: the model FLOPs of the replays before the profiled
stretch (`benchmark/recorder.py`) over their device time, each from its
`replay_start` mark (after the graph's copy-in) to its `replay_end` mark,
CUDA events the program records on its stream."""
from benchmark.readers import mfu
from benchmark.recorder import gaps_ms
from benchmark.work.flops import sample_flops


def read(cell, run):
    t = gaps_ms(run, "replay_start", "replay_end")
    if not t:
        return None
    return mfu(len(t) * run.counts["batch"] * sample_flops(cell.config),
               sum(t) / 1e3)
