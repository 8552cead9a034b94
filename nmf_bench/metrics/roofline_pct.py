"""The least time of the window's work (work.py) over the seconds in which
the card ran an operation (device trace), in percent."""


def read(run):
    if not run.get("least_s") or not run.get("busy_s"):
        return None
    return 100.0 * run["least_s"] / run["busy_s"]
