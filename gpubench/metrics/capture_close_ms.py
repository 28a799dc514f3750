"""The trace engine's close of one capture, ms: the seconds its captures
(landed and refused) spent stopping the profiler on the capturing
thread, the job's, over their count, from the engine's own counters at
the run's last sweep, the captures before and after the window included.
None where the engine counts no close."""


def read(run):
    st = run.trace_cost or {}
    n = st.get("captures_ok", 0.0) + st.get("captures_failed", 0.0)
    if n <= 0 or "capture_close_s" not in st:
        return None
    return 1000.0 * st["capture_close_s"] / n
