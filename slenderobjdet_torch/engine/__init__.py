from .train_loop import make_train_step

__all__ = ["make_train_step"]
