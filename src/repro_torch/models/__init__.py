"""Model zoo of the port (dense family so far): ``build_model`` -> ``Model``.

``repro_torch.models.convert`` carries the reference's parameters across.
"""
from .model import Model, build_model

__all__ = ["Model", "build_model"]
