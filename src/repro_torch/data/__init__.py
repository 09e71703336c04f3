"""The synthetic token pipeline (``data.pipeline``), counterpart of
``repro.data``."""
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: F401
