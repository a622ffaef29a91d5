from .build import make_lr_schedule, make_optimizer, set_learning_rate

__all__ = ["make_lr_schedule", "make_optimizer", "set_learning_rate"]
