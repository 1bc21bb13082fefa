from repro_torch.checkpoint.store import (  # noqa: F401
    CheckpointCorruptError,
    CheckpointManager,
    latest_step,
    restore,
    save,
)
