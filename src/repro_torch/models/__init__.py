"""Model zoo of the port: the block kinds ported so far — mamba-2
(``"ssm"``), RG-LRU (``"rec"``) and causal / local self-attention
(``"attn"``)."""
from repro_torch.models.decoding import (  # noqa: F401
    DecodeWorkingSet,
    cache_slot_axes,
    decode_step,
    decode_working_set,
    init_caches,
    prefill,
    slot_decode_step,
)
from repro_torch.models.transformer import (  # noqa: F401
    forward,
    init_params,
    pattern_split,
)
