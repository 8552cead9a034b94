"""The program's ``clustering`` and ``regression`` stage seconds a sweep:
clustering, silhouettes, the W-frozen refit and its per-column errors."""


def read(run):
    spans = run.get("spans")
    if not spans or "clustering" not in spans:
        return None
    return spans["clustering"] + spans.get("regression", 0.0)
