"""models forward: the model FLOPs of a traced run's forwards outside its
profiled stretch over their device time, read from CUDA events recorded
on the stream before and after each replay (the graph's copy of the
batch into its inputs and the forward's kernels; not the copy from the
host, nor the parse that follows)."""
from benchmark.readers import mfu
from benchmark.work.flops import sample_flops


def read(cell, run):
    t = run.spans.get("forward_device", [])
    if not t:
        return None
    return mfu(len(t) * run.counts["batch"] * sample_flops(cell.config),
               sum(t))
