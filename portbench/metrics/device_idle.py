"""``device_idle`` (layer: device): the share of a step's wall in which
the card runs nothing, in %: one less the device's busy time a step
(the union of every kernel, copy and set in the profiled steps) over the
wall a step of the unprofiled timed window.  The profiler slows the
host, so its steps' own wall is not used."""
LAYER = "device"


def read(run: dict) -> float | None:
    tr = run["trace"]
    if tr is None or not tr.ops or not run["steps"]:
        return None
    busy = tr.busy_s() / run["profiled_steps"]
    wall = run["window_s"] / len(run["steps"])
    return 100.0 * (1.0 - busy / wall)
