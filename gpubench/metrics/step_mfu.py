"""The whole step's share of the card's bf16 peak: the benchmark's own
operation count of one step (its kind's ``step_flops``, from shapes)
times the window's step rate, in %."""

from gpubench import flops, kinds


def read(run):
    rate = run.window_rate()
    if rate is None:
        return None
    kind = kinds.load(run.traffic["workload"]["kind"])
    try:
        peak = flops.peaks(run.device_name)["bf16_flops"]
    except KeyError:
        return None
    ops = kind.step_flops(run.traffic["workload"], run.job.shapes)
    return 100.0 * ops * rate / peak
