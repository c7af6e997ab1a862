"""The device's idle share of the traced stretch in the PETR cells: 1 −
the union of its kernel, copy and fill intervals over the stretch's
length."""
from benchmark.readers import idle_percent


def read(cell, run):
    return idle_percent(run)
