"""The LM's dense families (``models.lm``, ``attention``, ``ffn``,
``nn``), counterpart of ``repro.models``; MoE, Mamba2 and RWKV6 are
ROADMAP A.13.2."""
from repro_torch.models.lm import (  # noqa: F401
    ModelConfig, model_param_specs, forward, lm_logits, lm_loss, init_caches,
    decode_step, prefill)
from repro_torch.models.nn import (  # noqa: F401
    abstract_params, count_params, init_params)
