"""evals.petr_decode, its host half, in the BEVFormer cell: the
program's copies from the card to the host a batch (its counter
`petr_decode.d2h_copies` over its spans `petr_decode.to_host`, one a
batch), over the whole run; each is a blocking copy, with the host's
wait and the stream's drain it brings."""
from benchmark.recorder import per_call


def read(cell, run):
    return per_call(run, "petr_decode.d2h_copies", "petr_decode.to_host")
