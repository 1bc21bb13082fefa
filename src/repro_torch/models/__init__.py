"""Model zoo of the port: mamba-2 (``"ssm"``), RG-LRU (``"rec"``) and
attention (``"attn"``) blocks, the latter with a dense MLP or the top-k
MoE FFN (``moe``), and the encoder-decoder stack (whisper); ``loss_fn``
is the training objective."""
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
    loss_fn,
    pattern_split,
)
