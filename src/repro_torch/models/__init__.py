"""The LM (``models.lm``, ``attention``, ``ffn``, ``moe``, ``mamba2``,
``rwkv6``, ``nn``), counterpart of ``repro.models``."""
from repro_torch.models.lm import (  # noqa: F401
    ModelConfig, model_param_specs, forward, lm_logits, lm_loss, init_caches,
    decode_step, prefill)
from repro_torch.models.nn import (  # noqa: F401
    abstract_params, count_params, init_params)
