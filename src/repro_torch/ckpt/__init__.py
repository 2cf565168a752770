"""repro_torch.ckpt — checkpoints in the reference's on-disk format."""
from .checkpoint import Checkpointer

__all__ = ["Checkpointer"]
