"""``dispatch_ms`` (layer: step on the host, ``train/step.py``,
``train/optim.py``, ``models/*``): host milliseconds from the step
call to its return, before the loss barrier, the mean over the timed
window's steps; the benchmark's own span around the call."""
LAYER = "step on the host"


def read(run: dict) -> float | None:
    spans = [s[1] for s in run["steps"]]
    return 1e3 * sum(spans) / len(spans) if spans else None
