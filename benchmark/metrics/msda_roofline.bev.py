"""kernels: the multi-scale deformable attention's bound a forward
(`work.bevformer_flops.msda_bound_s`: bytes, the value maps, the
per-query offsets, logits and reference points read once and the output
written once, fixed by the configuration) over the device time a forward
of the kernels named ms_deform_attn* in the traced stretch."""
from benchmark.readers import device_per, share_of_bound, starts


def read(cell, run):
    spent = device_per(run, starts("ms_deform_attn"), "batches")
    if spent is None:
        return None
    from benchmark.work.bevformer_flops import msda_bound_s
    return share_of_bound(msda_bound_s(cell.config,
                                       int(run.counts["batch"])), spent)
