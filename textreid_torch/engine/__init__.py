from .state import TrainState, create_train_state
from .steps import make_train_step, moco_train_step

__all__ = ["TrainState", "create_train_state", "make_train_step",
           "moco_train_step"]
