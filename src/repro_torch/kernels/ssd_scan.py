"""Mamba2 SSD chunked scan: hand-written CUDA kernel + plain version.

Replaces the TPU kernel ``src/repro/kernels/ssd_scan.py::_ssd_kernel``
(called by ``ssd_scan``). The CUDA source is ``csrc/ssd_scan.cu``, built at
first use by ``_build.load``.

``x (b, s, h, p)``, ``dt (b, s, h)``, ``A, D (h,)``, ``B, C (b, s, g, n)``
-> ``y (b, s, h, p)`` in x's dtype and the final state ``(b, h, p, n)``
float32, the contract of ``ref.ssd_scan``: float32 arithmetic,
``y_intra + y_inter + D·x`` rounded to x's dtype once, an optional
``initial_state`` loaded in place of zeros. (The TPU kernel rounds
``y_intra + y_inter`` to x's dtype and adds ``D·x`` outside, a second
rounding in bfloat16; and the reference's ``ops.ssd_scan`` falls back to
``ref`` when an initial state is given. The port's kernel does neither.)
Two instances of the kernel, one contract (see the note at the top of
the ``.cu``): ``"wgmma"`` runs bf16 heads of the configs' shape (p 64, n
64 or 128, chunk a multiple of 64) as the SSD block decomposition on the
tensor cores, in three launches with float32 scratch allocated here;
``"general"`` runs everything else on the CUDA cores. :func:`instance_for`
picks one; nothing falls back from one to the other.

:func:`ssd_scan` takes the plain version only for tensors that lie on the
CPU. For CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, ref

#: kernel launches so far (one per :func:`ssd_scan` call that reached the
#: card) — lets a run prove its path went through the kernel
launch_count = 0
#: the same calls by instance
INSTANCES = ("wgmma", "general")
instance_counts = dict.fromkeys(INSTANCES, 0)

#: the wgmma instance's heads: head dim, state sizes, chunk granularity
WGMMA_P, WGMMA_N, WGMMA_CHUNK = 64, (64, 128), 64

_FN = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}


def ssd_scan_plain(x, dt, A, B, C, D, *, chunk: int = 256,
                   initial_state: Optional[torch.Tensor] = None):
    """The same function in plain PyTorch (``ref.ssd_scan``), on any device."""
    return ref.ssd_scan(x, dt, A, B, C, D, chunk=chunk, initial_state=initial_state)


def instance_for(dtype: torch.dtype, p: int, n: int, chunk: int) -> str:
    """The instance a CUDA call with x of ``dtype``, head dim ``p``, state
    size ``n`` and ``chunk`` launches: ``"wgmma"`` for bf16 with p 64, n 64
    or 128 and chunk a multiple of 64 (every config's heads), else
    ``"general"``."""
    if (dtype == torch.bfloat16 and p == WGMMA_P and n in WGMMA_N
            and chunk % WGMMA_CHUNK == 0):
        return "wgmma"
    return "general"


#: the wgmma instance's scratch and its types
SCRATCH_DTYPES = {"cd": torch.float32, "states": torch.float32, "hin": torch.bfloat16}


def scratch_shapes(b: int, s: int, h: int, p: int, n: int, chunk: int) -> dict:
    """The wgmma instance's scratch (:data:`SCRATCH_DTYPES`): ``cd``, the
    within-chunk cumsum beside dt of every step; ``states``, the chunk
    states S_c as (n, p); ``hin``, the state entering each chunk as bf16
    hi and lo tiles of 64 state rows, swizzled as the tensor cores read
    them."""
    nc = s // chunk
    return {"cd": (b, h, s, 2), "states": (b, h, nc, n, p),
            "hin": (b, h, nc, n // 64, 2, 64, p)}


def _check(x, dt, A, B, C, D, chunk, initial_state) -> None:
    ts = [x, dt, A, B, C, D] + ([] if initial_state is None else [initial_state])
    if not all(isinstance(t, torch.Tensor) for t in ts):
        raise TypeError("ssd_scan takes torch tensors")
    if x.dtype not in _FN or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_scan takes float32 or bfloat16 x, B, C of one dtype, "
                        f"got {x.dtype}, {B.dtype}, {C.dtype}")
    if any(t.dtype != torch.float32 for t in [dt, A, D] + ts[6:]):
        raise TypeError("ssd_scan takes dt, A, D and initial_state in float32")
    if x.dim() != 4 or B.dim() != 4 or B.shape != C.shape:
        raise ValueError(f"ssd_scan takes x (b, s, h, p) and B, C (b, s, g, n), got "
                         f"{tuple(x.shape)}, {tuple(B.shape)}, {tuple(C.shape)}")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if (B.shape[:2] != (b, s) or dt.shape != (b, s, h) or A.shape != (h,)
            or D.shape != (h,) or min(b, s, h, p, g, n) < 1 or h % g):
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B/C {tuple(B.shape)}, D "
                         f"{tuple(D.shape)} do not fit (h % g == 0)")
    if not (isinstance(chunk, int) and chunk >= 1 and s % chunk == 0):
        raise ValueError(f"ssd_scan takes an int chunk that divides the sequence, "
                         f"got chunk {chunk!r} for s = {s}")
    if initial_state is not None and initial_state.shape != (b, h, p, n):
        raise ValueError(f"ssd_scan takes an initial_state of {(b, h, p, n)}, got "
                         f"{tuple(initial_state.shape)}")
    if any(t.device != x.device for t in ts):
        raise ValueError(f"ssd_scan operands lie on {[str(t.device) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("ssd_scan takes contiguous tensors")


_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    global _lib
    if _lib is None:
        lib = _build.load("ssd_scan")
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        for name in _FN.values():
            fn = getattr(lib, name)
            fn.argtypes = [ptr] * 9 + [i64] * 7 + [ptr]
            fn.restype = ctypes.c_int
        lib.ssd_scan_bf16_wgmma.argtypes = [ptr] * 12 + [i64] * 7 + [ptr]
        lib.ssd_scan_bf16_wgmma.restype = ctypes.c_int
        for name in ("ssd_scan_max_p", "ssd_scan_max_n"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i64
        lib.max_p, lib.max_n = int(lib.ssd_scan_max_p()), int(lib.ssd_scan_max_n())
        _lib = lib
    return _lib


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, D: torch.Tensor, *, chunk: int = 256,
             initial_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan; returns ``(y, final_state)``.

    x, B, C float32 or bfloat16 (one dtype); dt, A, D and initial_state
    float32; contiguous; ``s % chunk == 0``. Anything else raises. On the
    card the instance is :func:`instance_for`'s: the wgmma one needs x, B
    and C 16-byte aligned, the general one takes ``p <= 64`` and ``n <=
    128`` with ``n % 4 == 0`` (every config's heads take one or the
    other). Launches on the current CUDA stream and does not synchronise.
    """
    return _ssd_scan(x, dt, A, B, C, D, chunk=chunk, initial_state=initial_state)


def _ssd_scan(x, dt, A, B, C, D, *, chunk: int = 256,
              initial_state: Optional[torch.Tensor] = None,
              instance: Optional[str] = None):
    """:func:`ssd_scan` with the instance named (``None``: the one
    :func:`instance_for` picks), so that a check can time and hold both
    on the same inputs. A named instance that cannot take the call raises."""
    global launch_count
    _check(x, dt, A, B, C, D, chunk, initial_state)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, D, chunk=chunk, initial_state=initial_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan has no kernel for device {x.device}")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    fits = instance_for(x.dtype, p, n, chunk)
    if instance is None:
        instance = fits
    if instance not in INSTANCES:
        raise ValueError(f"ssd_scan instance must be one of {INSTANCES}, got {instance!r}")
    if instance == "wgmma" and fits != "wgmma":
        raise ValueError(f"ssd_scan's wgmma instance takes bf16 with p = {WGMMA_P}, n in "
                         f"{WGMMA_N} and chunk % {WGMMA_CHUNK} == 0, got {x.dtype}, "
                         f"p = {p}, n = {n}, chunk {chunk}")
    lib = _library()
    init = None if initial_state is None else initial_state.data_ptr()
    y = torch.empty_like(x)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if instance == "wgmma":
        scratch = {k: torch.empty(shape, dtype=SCRATCH_DTYPES[k], device=x.device)
                   for k, shape in scratch_shapes(b, s, h, p, n, chunk).items()}
        err = _build.launch_on(
            x.device, lib.ssd_scan_bf16_wgmma, x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            B.data_ptr(), C.data_ptr(), D.data_ptr(), init, y.data_ptr(), final.data_ptr(),
            *(scratch[k].data_ptr() for k in SCRATCH_DTYPES), b, s, h, p, g, n, chunk)
        hint = ("x, B and C must be 16-byte aligned, and a chunk's tiles fit 227 KB of "
                "shared memory")
    else:
        if p > lib.max_p or n > lib.max_n or n % 4:
            raise ValueError(f"ssd_scan's kernel takes p <= {lib.max_p} and n <= "
                             f"{lib.max_n} with n % 4 == 0, got p = {p}, n = {n}")
        err = _build.launch_on(
            x.device, getattr(lib, _FN[x.dtype]), x.data_ptr(), dt.data_ptr(),
            A.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(), init,
            y.data_ptr(), final.data_ptr(), b, s, h, p, g, n, chunk)
        hint = ("a chunk's tiles must fit 227 KB of shared memory: chunk <= 8,000 at "
                "n = 128, p = 64")
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed ({instance} instance): CUDA "
                           f"error {err} for x {tuple(x.shape)}, B {tuple(B.shape)} "
                           f"{x.dtype}, chunk {chunk} ({hint})")
    launch_count += 1
    instance_counts[instance] += 1
    return y, final
