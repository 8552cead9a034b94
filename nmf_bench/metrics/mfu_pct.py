"""The least time of the window's work (work.py) over the window's wall
seconds, in percent: the whole step's share of the card's peak."""


def read(run):
    if not run.get("least_s"):
        return None
    return 100.0 * run["least_s"] / run["window_s"]
