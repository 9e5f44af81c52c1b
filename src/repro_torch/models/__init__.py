"""Model zoo of the port (dense and ssm families so far): ``build_model``
-> ``Model`` / ``SSMModel``.

``repro_torch.models.convert`` carries the reference's parameters across.
"""
from .model import Model, SSMModel, build_model

__all__ = ["Model", "SSMModel", "build_model"]
