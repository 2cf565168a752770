from .model import Model
from . import layers

__all__ = ["Model", "layers"]
