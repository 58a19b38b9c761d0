"""``issue_ms.decode``: host milliseconds from the serve step's call to
its return, before the tokens are copied to host memory, the mean over
the window's steps outside the profiled slice (``launch/steps.py``'s
serve step: the host's launch work while the device runs behind it)."""


def read(rec):
    issue = rec.get("issue_s") or []
    if not issue:
        return None
    return 1e3 * sum(issue) / len(issue)
