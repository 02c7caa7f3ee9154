"""repro_torch.data — deterministic sharded synthetic token pipeline."""
from .pipeline import DataConfig, TokenPipeline, make_batch_specs

__all__ = ["DataConfig", "TokenPipeline", "make_batch_specs"]
