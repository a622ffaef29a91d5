from .logger import setup_logger

__all__ = ["setup_logger"]
