"""Flash attention (blocked online softmax): hand-written CUDA kernel + plain
version.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py::
_flash_kernel`` (called by ``flash_attention``). The CUDA source is
``csrc/flash_attention.cu``, built at first use by ``_build.load``.

``q (B, Sq, H, D)``, ``k, v (B, Skv, KVH, D)`` -> ``(B, Sq, H, D)`` in q's
dtype; causal (with the absolute position ``q_offset`` of ``q[0]``) or full;
GQA / MQA read in place (``H % KVH == 0``); scale ``D**-0.5``; float32
statistics and accumulation. Unlike the reference, which asserts that the
sequence lengths divide its blocks, any ``Sq`` and ``Skv`` are taken: the
kernel masks the ragged tiles. float32 takes head dims up to 128 (CUDA
cores). bfloat16 runs the Hopper kernel: TMA loads of Q and of K / V tiles
into an mbarrier ring fed by a producer warp, both products on ``wgmma``
for two consumer warpgroups of 64 query rows each, P kept in registers
(see the note at the top of the ``.cu``). It takes the head dims of the
configs (32, 64, 112, 128) with 16-byte aligned operands, which its tensor
maps need; :func:`_launch_args` raises on any other before the launch.

:func:`flash_attention` takes the plain version only for tensors that lie
on the CPU. For CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, ref

#: kernel launches so far (one per :func:`flash_attention` call that reached
#: the card) — lets a run prove its path went through the kernel
launch_count = 0

_FN = {torch.float32: "flash_attention_f32",
       torch.bfloat16: "flash_attention_bf16"}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """The same function in plain PyTorch (``ref.attention``), on any device."""
    return ref.attention(q, k, v, causal=causal, q_offset=q_offset)


def _check(q, k, v, q_offset) -> None:
    if not all(isinstance(t, torch.Tensor) for t in (q, k, v)):
        raise TypeError("flash_attention takes torch tensors")
    if q.dtype not in _FN or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B, Sq, H, D) and k, v "
                         f"(B, Skv, KVH, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    kb, skv, kvh, kd = k.shape
    if kb != b or kd != d or min(b, sq, h, d, skv, kvh) < 1 or h % kvh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k, v "
                         f"{tuple(k.shape)} do not fit (H % KVH == 0, same B and D)")
    if not (isinstance(q_offset, int) and q_offset >= 0):
        raise ValueError(f"flash_attention takes an int q_offset >= 0, got {q_offset!r}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention operands lie on {q.device}, "
                         f"{k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous tensors")


#: head dims the bfloat16 kernel has an instance for, and the float32
#: kernel's largest (``flash_attention_max_head_dim`` of the library)
BF16_HEAD_DIMS = (32, 64, 112, 128)
MAX_HEAD_DIM = 128

_fns: Optional[dict] = None


def _library() -> dict:
    """The built kernel library's launchers by dtype, C signatures declared
    (bound once, so a call pays no attribute lookups)."""
    global _fns
    if _fns is None:
        lib = _build.load("flash_attention")
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        fns = {}
        for dtype, name in _FN.items():
            fn = fns[dtype] = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64, i64, i64, i64,
                           ctypes.c_int, i64, ctypes.c_float, ptr]
            fn.restype = ctypes.c_int
        lib.flash_attention_max_head_dim.argtypes = []
        lib.flash_attention_max_head_dim.restype = i64
        if lib.flash_attention_max_head_dim() != MAX_HEAD_DIM:
            raise RuntimeError("flash_attention: the built library's largest head "
                               "dim differs from the wrapper's")
        _fns = fns
    return _fns


def _launch_args(q, k, v, out, causal: bool, q_offset: int) -> tuple:
    """The C launcher's arguments (without the stream), after the checks
    that only the card's kernels need: the float32 kernel's largest head
    dim, and the bfloat16 kernel's head dims and 16-byte alignment (its
    tensor maps need both)."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention's kernel takes head dims up to "
                         f"{MAX_HEAD_DIM}, got {d}")
    if q.dtype == torch.bfloat16:
        if d not in BF16_HEAD_DIMS:
            raise RuntimeError(f"flash_attention: bfloat16 takes head dims 32, 64, "
                               f"112, 128 and 16-byte aligned operands, got head dim {d}")
        if any(t.data_ptr() % 16 for t in (q, k, v, out)):
            raise RuntimeError("flash_attention: bfloat16 takes head dims 32, 64, "
                               "112, 128 and 16-byte aligned operands, got an "
                               "operand that is not 16-byte aligned")
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv,
            h, kvh, d, int(causal), q_offset, d ** -0.5)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Attention of ``q (B, Sq, H, D)`` over ``k, v (B, Skv, KVH, D)``.

    float32 or bfloat16, one dtype, contiguous; anything else raises.
    Launches on the current CUDA stream and does not synchronise.
    """
    global launch_count
    _check(q, k, v, q_offset)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention has no kernel for device {q.device}")
    fn = _library()[q.dtype]
    out = torch.empty_like(q)
    err = _build.launch_on(q.device, fn, *_launch_args(q, k, v, out, causal, q_offset))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err} for q {tuple(q.shape)}, k {tuple(k.shape)} "
                           f"{q.dtype}")
    launch_count += 1
    return out
