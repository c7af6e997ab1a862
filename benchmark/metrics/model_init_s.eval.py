"""models init: the seconds of the program's `models.init` spans over the
whole run, set-up included (PARQModel's construction and random
initialisation)."""
from benchmark.recorder import total_s


def read(cell, run):
    return total_s(run, "models.init")
