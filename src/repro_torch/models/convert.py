"""Carry the reference's model parameters across to the port.

The reference keeps a model's parameters as a tree of arrays with the
layer axis stacked (``{"layers": {"attn": {"wq": (L, d, q_dim), ...},
"ln1": (L, d), ...}, "embed": ..., "final_norm": ...}``; a Mamba layer's
leaves are ``wz``, ``wx``, ``wB``, ``wC``, ``wdt``, ``dt_bias``, ``A_log``,
``D``, ``conv_w``, ``norm``, ``ln1``, ``out_proj``). Handed over as
nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)`` on the
caller's side — nothing here imports JAX), :func:`state_from_reference`
splits the layer axis and names each array as the port's modules do;
:func:`load_reference` loads that state into a :class:`~repro_torch.models.Model`.

bfloat16 arrives as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
refuses: it goes across bit for bit as ``uint16`` and is viewed as
``torch.bfloat16``.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

#: reference leaves that are RMSNorm scales (``<name>.scale`` in the port);
#: ``norm`` is the Mamba block's gated norm
_NORMS = frozenset({"ln1", "ln2", "q_norm", "k_norm", "final_norm", "norm"})


def to_tensor(a) -> torch.Tensor:
    """A numpy array (float32, bfloat16, ...) as a CPU tensor, bit for bit."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _leaves(tree: Mapping, prefix: tuple = ()):
    for name, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (name,))
        else:
            yield prefix + (name,), value


def _key(path: tuple) -> str:
    return ".".join(path) + (".scale" if path[-1] in _NORMS else "")


def state_from_reference(params: Mapping) -> dict[str, torch.Tensor]:
    """The port's state dict (CPU tensors) of a reference LM's tree (dense
    or ssm), every leaf in its own dtype, bit for bit."""
    state = {}
    for path, arr in _leaves(params):
        if path[0] == "layers":
            for i in range(arr.shape[0]):
                state[_key(("layers", str(i)) + path[1:])] = to_tensor(arr[i])
        else:
            state[_key(path)] = to_tensor(arr)
    return state


def load_reference(model: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Load the reference's parameters into ``model`` (strict: every name
    must match, and the dtypes must be the model's)."""
    state = state_from_reference(params)
    own = model.state_dict()
    for name, t in state.items():
        if name in own and own[name].dtype != t.dtype:
            raise TypeError(f"{name}: reference {t.dtype} vs model {own[name].dtype}")
    model.load_state_dict(state, strict=True)
    return model
