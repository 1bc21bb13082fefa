"""``train_peak_mem_gib``: the allocator's peak over the timed window
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``
at its start), in GiB: weights, gradients, AdamW's moments and the
step's activations."""


def read(run: dict) -> float | None:
    return run["peak_bytes"] / 2**30 if run["peak_bytes"] else None
