from .train_loop import TrainStep, make_train_step

__all__ = ["TrainStep", "make_train_step"]
