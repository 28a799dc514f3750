"""The flash attention kernels' share of their roofline, from the device
trace of the job's profiled stretch: one call's least time (the larger
of its operations and its bytes at the call's shapes over the card's
peaks) over the mean device time of its kernels, the forward kernel's
and, where the step trains, the dQ and dK/dV kernels' added, in %.  The
call is the one the job's kind names (``flash_attention_call``); a kind
that names none has no reading."""

from gpubench import flops, kinds
from gpubench.devtrace import mean_call_s

#: the kernels' names in the trace (``tpumon_torch/csrc/flash_attn.cu``)
FWD, BWD = "flash_fwd_kernel", ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")


def read(run):
    call = getattr(kinds.load(run.traffic["workload"]["kind"]),
                   "flash_attention_call", None)
    if run.stretch is None or call is None:
        return None
    c = call(run.job.shapes)
    backward = c["backward"]
    parts = [mean_call_s(run.stretch, k)
             for k in (FWD,) + (BWD if backward else ())]
    if any(p is None for p in parts):
        return None
    b, s, h, d = c["b"], c["s"], c["h"], c["d"]
    ops = flops.attention_fwd_flops(b, h, s, d)
    if backward:
        ops += flops.attention_bwd_flops(b, h, s, d)
    return flops.roofline_pct(ops, flops.attention_bytes(b, h, s, d,
                                                         backward),
                              sum(parts), run.device_name)
