"""``setup_s``: seconds from the process's start to the first timed step:
CUDA's start, the kernels' build or load, the weights made from the
seed, and the set-up steps that warm up every shape (host clock)."""


def read(run: dict) -> float:
    return run["setup_s"]
