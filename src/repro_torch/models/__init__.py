"""Model substrate of the port: the lm, hybrid, ssm and encdec families in PyTorch."""
from repro_torch.models.api import Model
from repro_torch.models.config import ModelConfig

__all__ = ["Model", "ModelConfig"]
