"""The most device memory allocated during the window, in GiB
(``torch.cuda.max_memory_allocated`` after a reset at its start)."""


def read(run):
    if not run.get("window_peak_bytes"):
        return None
    return run["window_peak_bytes"] / 2 ** 30
