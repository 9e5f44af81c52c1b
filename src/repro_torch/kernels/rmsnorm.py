"""Fused RMSNorm: hand-written CUDA kernel + plain version.

Replaces the TPU kernel ``src/repro/kernels/rmsnorm.py::_rmsnorm_kernel``
(called by ``rmsnorm``). The CUDA source is ``csrc/rmsnorm.cu``, built at
first use by ``_build.load``.

``y = (x * rsqrt(mean(x²) + eps)).astype(x.dtype) * scale`` over the last
axis, statistics in float32, the cast *before* the multiply by ``scale``
(the reference's order). Bound by bytes: one read of ``x``, one write of
``y``. A row is held in registers by a warp (4 to 16 lanes for rows of
fewer than 32 16-byte vectors, such as the qk-norm's 128), all of its loads
in flight at once; rows wider than 512 vectors, or not 16-byte shaped, are
read a second time from L2 instead. See the note at the top of the ``.cu``.

:func:`rmsnorm` takes the plain version only for tensors that lie on the
CPU. For CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, ref

#: kernel launches so far (one per :func:`rmsnorm` call that reached the
#: card) — lets a run prove its path went through the kernel
launch_count = 0

_FN = {torch.float32: "rmsnorm_f32", torch.bfloat16: "rmsnorm_bf16"}


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """The same function in plain PyTorch, on any device."""
    return ref.rmsnorm(x, scale, eps)


def _check(x: torch.Tensor, scale: torch.Tensor) -> None:
    if not (isinstance(x, torch.Tensor) and isinstance(scale, torch.Tensor)):
        raise TypeError("rmsnorm takes torch tensors")
    if x.dtype not in _FN or scale.dtype != x.dtype:
        raise TypeError(f"rmsnorm takes float32 or bfloat16 x with a scale of "
                        f"the same dtype, got {x.dtype} and {scale.dtype}")
    if x.dim() < 1 or scale.shape != x.shape[-1:] or x.numel() == 0:
        raise ValueError(f"rmsnorm takes x (..., d) and scale (d,), got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if x.device != scale.device:
        raise ValueError(f"rmsnorm operands lie on {x.device} and {scale.device}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm takes contiguous tensors")


#: the widest row the kernel takes (``rmsnorm_max_d`` of the library)
MAX_D = 12288

_fns: Optional[dict] = None


def _library() -> dict:
    """The built kernel library's launchers by dtype, C signatures declared
    (bound once, so a call pays no attribute lookups)."""
    global _fns
    if _fns is None:
        lib = _build.load("rmsnorm")
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        fns = {}
        for dtype, name in _FN.items():
            fn = fns[dtype] = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, i64, i64, ctypes.c_float, ptr]
            fn.restype = ctypes.c_int
        lib.rmsnorm_max_d.argtypes = []
        lib.rmsnorm_max_d.restype = i64
        if lib.rmsnorm_max_d() != MAX_D:
            raise RuntimeError("rmsnorm: the built library's widest row differs "
                               "from the wrapper's")
        _fns = fns
    return _fns


def _launch_args(x, scale, out, eps: float) -> tuple:
    """The C launcher's arguments (without the stream); raises on rows
    wider than the kernel takes."""
    d = x.shape[-1]
    if d > MAX_D:
        raise ValueError(f"rmsnorm's kernel takes rows of at most {MAX_D} "
                         f"elements, got d = {d}")
    return (x.data_ptr(), scale.data_ptr(), out.data_ptr(), x.numel() // d, d, eps)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm of ``x (..., d)`` with ``scale (d,)``; output of x's shape and
    dtype. float32 or bfloat16, both operands alike, contiguous; anything
    else raises. Launches on the current CUDA stream and does not
    synchronise."""
    global launch_count
    _check(x, scale)
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm has no kernel for device {x.device}")
    fn = _library()[x.dtype]
    out = torch.empty_like(x)
    err = _build.launch_on(x.device, fn, *_launch_args(x, scale, out, eps))
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {err} "
                           f"for shape {tuple(x.shape)} {x.dtype}")
    launch_count += 1
    return out
