from .build import build_optimizer, lr_schedule

__all__ = ["build_optimizer", "lr_schedule"]
