"""AdamW on parameter trees (``optim.adamw``), counterpart of
``repro.optim``."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig, init_opt_state, adamw_update, global_norm, schedule)
