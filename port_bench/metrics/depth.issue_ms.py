"""Depth entry: host ms of the DepthEvaluator.render call (no sync), the
mean over the window's frames."""


def read(run):
    if not run.issue_ms:
        return None
    return sum(run.issue_ms) / len(run.issue_ms)
