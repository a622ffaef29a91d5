from .inference import compute_embeddings, inference
from .state import TrainState, create_train_state
from .steps import encode_step, make_train_step, moco_train_step

__all__ = ["TrainState", "compute_embeddings", "create_train_state",
           "encode_step", "inference", "make_train_step", "moco_train_step"]
