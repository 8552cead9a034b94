"""MU iterations completed over the window's seconds (whole fits)."""


def read(run):
    if "iterations" not in run:
        return None
    return run["iterations"] / run["window_s"]
