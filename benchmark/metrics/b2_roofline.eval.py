"""B2, the cross-attention forward: the problem's bound a forward
(`work.attention.fwd_bound_s`: L launches, each q and o once and the
memory's K and V read once) over the device time a forward of the
kernels named flash_fwd_* and flash_combine_*."""
from benchmark.readers import device_per, share_of_bound, starts
from benchmark.work.attention import fwd_bound_s


def read(cell, run):
    return share_of_bound(
        fwd_bound_s(cell.config, int(run.counts["batch"])),
        device_per(run, starts("flash_fwd", "flash_combine"), "batches"))
