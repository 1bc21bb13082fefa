"""Training: AdamW with the reference's rules, the microbatched step,
int8 gradient compression and the fault-tolerant loop."""
from repro_torch.train.optim import (  # noqa: F401
    AdamWConfig,
    adamw_init,
    adamw_update,
    lr_schedule,
)
from repro_torch.train.step import (  # noqa: F401
    TrainState,
    init_train_state,
    make_train_step,
)
