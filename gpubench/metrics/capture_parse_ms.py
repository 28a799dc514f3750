"""The trace engine's parse of one capture, ms: its parse seconds over
its captures (landed and refused), from its own counters at the run's
last sweep, the captures before and after the window included: the
engine parses on a thread of its own, beside the job's."""


def read(run):
    st = run.trace_cost or {}
    n = st.get("captures_ok", 0.0) + st.get("captures_failed", 0.0)
    if n <= 0:
        return None
    return 1000.0 * st["capture_parse_s"] / n
