from .mesh import make_train_step, train_step_schedule

__all__ = ["make_train_step", "train_step_schedule"]
