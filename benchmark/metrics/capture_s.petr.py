"""graphs, in the PETR cells: the seconds of the program's `graphs.warmup`
and `graphs.capture` spans over the whole run, set-up included (the eager
first call of the PETR forward and its CUDA graph capture), less the
spans inside them, which are not the graph layer's: the DCN library's
build and load (`kernels.load`), which a checkout's first run does inside
the warm-up."""
from benchmark.recorder import total_s


def read(cell, run):
    return total_s(run, "graphs.warmup", "graphs.capture", key="self_s")
