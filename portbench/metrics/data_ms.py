"""``data_ms`` (layer: loop input, ``data/synthetic.py``): host
milliseconds a step inside the stream's ``batch_at``, the mean over the
timed window's steps, from the benchmark's own span around the call."""
LAYER = "loop input"


def read(run: dict) -> float | None:
    spans = [s[0] for s in run["steps"]]
    return 1e3 * sum(spans) / len(spans) if spans else None
