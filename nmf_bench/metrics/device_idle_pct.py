"""The share of the traced window in which the card ran no operation."""


def read(run):
    if not run.get("busy_s") or not run.get("trace_window_s"):
        return None
    return 100.0 * (1.0 - run["busy_s"] / run["trace_window_s"])
