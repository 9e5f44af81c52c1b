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
from . import ssd_scan as _ssd

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


def ssd_scan(x, dt, A, B, C, D, *, chunk: int = 256, initial_state=None,
             impl: Optional[str] = None):
    # unlike the reference (src/repro/kernels/ops.py:56), an initial state
    # goes to the kernel too: it loads the state in place of zeros
    if _plain(impl):
        return ref.ssd_scan(x, dt, A, B, C, D, chunk=chunk,
                            initial_state=initial_state)
    return _ssd.ssd_scan(x, dt, A, B, C, D, chunk=chunk,
                         initial_state=initial_state)


# re-exported plain helpers (no kernel variant, in the reference either:
# src/repro/kernels/ops.py:63-66)
swiglu = ref.swiglu
ssd_decode_step = ref.ssd_decode_step
causal_conv1d = ref.causal_conv1d
conv1d_step = ref.conv1d_step
