"""``train_tokens_per_s``: every token of every step completed in the
timed window over the window's wall time (host clock; each step ends at
its ``float(loss)`` barrier)."""


def read(run: dict) -> float:
    return len(run["steps"]) * run["tokens_per_step"] / run["window_s"]
