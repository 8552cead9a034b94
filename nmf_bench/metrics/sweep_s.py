"""The window's seconds over the whole NMFk sweeps completed in it."""


def read(run):
    if not run.get("sweeps"):
        return None
    return run["window_s"] / run["sweeps"]
