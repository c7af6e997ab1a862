"""graphs, in the BEVFormer cell: the seconds of the program's
`graphs.warmup` and `graphs.capture` spans over the whole run, set-up
included (the eager first call and the CUDA graph capture of both forms,
a scene's first sample and a carried one), less the spans inside them,
which are not the graph layer's: the kernel libraries' builds and loads
(`kernels.load`), which a checkout's first run does inside the warm-up."""
from benchmark.recorder import total_s


def read(cell, run):
    return total_s(run, "graphs.warmup", "graphs.capture", key="self_s")
