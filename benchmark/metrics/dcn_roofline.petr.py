"""kernels: the DCNv2 sampling kernel's bound a forward
(`work.petr_flops.dcn_bound_s`: bytes, the input maps, offsets and masks
read once and the columns written once) over the device time a forward of
the kernels named deform_conv_* in the traced stretch."""
from benchmark.readers import device_per, share_of_bound, starts


def read(cell, run):
    spent = device_per(run, starts("deform_conv"), "batches")
    if spent is None:
        return None
    from benchmark.work.petr_flops import dcn_bound_s
    return share_of_bound(dcn_bound_s(cell.config, int(run.counts["batch"])),
                          spent)
