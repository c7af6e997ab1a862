"""models init, in the BEVFormer cell: the seconds of the program's
`models.init` spans over the whole run, set-up included
(BEVFormerModel's construction)."""
from benchmark.recorder import total_s


def read(cell, run):
    return total_s(run, "models.init")
