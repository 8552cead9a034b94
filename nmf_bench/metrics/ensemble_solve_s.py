"""The program's ``ensemble_solve`` stage seconds a sweep: sampling, the
members' init draws and their batched solves (utils/timing.py)."""


def read(run):
    spans = run.get("spans")
    if not spans or "ensemble_solve" not in spans:
        return None
    return spans["ensemble_solve"]
