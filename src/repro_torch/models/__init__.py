"""The model zoo (dense, MoE, SSM, hybrid, vision-language and
encoder-decoder families) in the JAX package's layouts, eager PyTorch; the
unified API of :mod:`repro_torch.models.model`, re-exported."""
from repro_torch.models.model import (  # noqa: F401
    param_specs, init_params, abstract_params, forward_hidden,
    logits_from_hidden, loss_fn, prefill, decode_step, init_cache,
    input_specs, abstract_cache,
)
