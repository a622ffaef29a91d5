from .gru import BiGRUEncoder
from .m_resnet import ModifiedResNet
from .model import TextReIDModel, build_model

__all__ = ["BiGRUEncoder", "ModifiedResNet", "TextReIDModel", "build_model"]
