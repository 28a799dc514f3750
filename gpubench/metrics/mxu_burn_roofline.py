"""The tile-product kernel's share of its roofline, from the device
trace of the job's profiled stretch: one call's least time (its
operations and bytes at the call's shapes over the card's peaks) over
the kernel's mean device time, in %.  The call is the one the job's kind
names (``mxu_burn_call``); a kind that names none has no reading."""

from gpubench import flops, kinds
from gpubench.devtrace import mean_call_s

#: the kernel's name in the trace (``tpumon_torch/csrc/load_kernels.cu``)
KERNEL = "mxu_kernel"


def read(run):
    call = getattr(kinds.load(run.traffic["workload"]["kind"]),
                   "mxu_burn_call", None)
    if run.stretch is None or call is None:
        return None
    seconds = mean_call_s(run.stretch, KERNEL)
    if seconds is None:
        return None
    n, tile, iters = call(run.job.shapes)
    return flops.roofline_pct(flops.mxu_burn_flops(n, tile, iters),
                              flops.mxu_burn_bytes(n, tile), seconds,
                              run.device_name)
