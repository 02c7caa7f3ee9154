"""repro_torch.optim — AdamW + clipping + LR schedules (no external deps)."""
from .adamw import AdamW, OptState, cosine_schedule, linear_warmup_cosine

__all__ = ["AdamW", "OptState", "cosine_schedule", "linear_warmup_cosine"]
