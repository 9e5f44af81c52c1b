"""Dispatch layer of the model zoo: kernels by the tensor's device.

The models call these wrappers only. A CPU tensor goes to the plain
version (:mod:`repro_torch.kernels.ref`); a CUDA tensor goes to the
hand-written kernel, or the call raises — nothing falls back. An explicit
``impl="plain"`` runs the plain version on any device (so that a model
built with it is the kernel model's twin on the card); nothing on the
serving path passes it.
"""
from __future__ import annotations

from typing import Optional

from . import flash_attention as _fa
from . import ref
from . import rmsnorm as _rn

IMPLS = (None, "plain")


def _plain(impl: Optional[str]) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl == "plain"


def attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
              impl: Optional[str] = None):
    if _plain(impl):
        return ref.attention(q, k, v, causal=causal, q_offset=q_offset)
    return _fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, pos, *, impl: Optional[str] = None):
    # decode is a GEMV against the cache: the reference has no kernel for it
    # (src/repro/kernels/ops.py:41), so neither has the port
    _plain(impl)
    return ref.decode_attention(q, k_cache, v_cache, pos)


def rmsnorm(x, scale, eps: float = 1e-5, *, impl: Optional[str] = None):
    if _plain(impl):
        return ref.rmsnorm(x, scale, eps)
    return _rn.rmsnorm(x, scale, eps)


# re-exported plain helper (no kernel variant)
swiglu = ref.swiglu
