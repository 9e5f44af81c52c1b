"""Segmented max-plus Lindley scan: hand-written CUDA kernel + plain version.

Replaces the TPU kernel ``src/repro/kernels/lindley_scan.py::_lindley_kernel``
(and its callers ``lindley_scan`` / ``lindley_scan_rows``). The CUDA source
is ``csrc/lindley_scan.cu``, built at first use by ``_build.load``.

Elements are the max-plus maps of ``repro_torch.core.sim_scan``:
``(u, v): w -> max(w + u, v)`` — a message contributes ``(X_n, 0)``, a
server's first message (segment head) ``(-inf, 0)``, padding the identity
``(0, -inf)``. Maps compose as ``(au, av) . (bu, bv) = (au + bu,
max(av + bu, bv))`` with the EARLIER map on the left; the operator is
associative, not commutative. Waits are ``W = max(U, V)`` of the inclusive
prefix maps.

Bound by bytes on the card: the least traffic is ``3 * itemsize`` per
element (read ``u`` and ``v``, write ``W``), 24 B in float64. The kernel
is a reduce-then-scan in three launches (rows are few and long, so the
scan axis is split into tiles across the SMs) and reads the inputs twice:
``5 * itemsize`` per element. See the note at the top of the ``.cu``.

:func:`lindley_scan` takes the plain version only for tensors that lie on
the CPU. For CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import _build

#: kernel launches so far (one per :func:`lindley_scan` call that reached
#: the card, whatever the number of CUDA launches inside it) — lets a run
#: prove its path went through the kernel
launch_count = 0

_FN = {torch.float32: "lindley_scan_f32", torch.float64: "lindley_scan_f64"}


def lindley_scan_plain(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The same scan in plain PyTorch, on any device, along the last axis.

    Log-step doubling sweep: after the step with distance ``d`` position
    ``i`` holds the composition of elements ``(i - 2d, i]`` in order.
    ``-inf`` heads only ever meet ``+`` and ``max`` (never a subtraction),
    so no NaN can form.
    """
    big_u, big_v = u.clone(), v.clone()
    n = u.shape[-1]
    d = 1
    while d < n:
        # combine(earlier = [..., :-d], later = [..., d:]); both right-hand
        # sides are evaluated before either is assigned
        new_v = torch.maximum(big_v[..., :-d] + big_u[..., d:], big_v[..., d:])
        new_u = big_u[..., :-d] + big_u[..., d:]
        big_u[..., d:] = new_u
        big_v[..., d:] = new_v
        d <<= 1
    return torch.maximum(big_u, big_v)


def _check(u: torch.Tensor, v: torch.Tensor) -> None:
    if not (isinstance(u, torch.Tensor) and isinstance(v, torch.Tensor)):
        raise TypeError("lindley_scan takes torch tensors")
    if u.dtype not in _FN or v.dtype != u.dtype:
        raise TypeError(f"lindley_scan takes float32 or float64 operands of "
                        f"one dtype, got {u.dtype} and {v.dtype}")
    if u.dim() != 2 or u.shape != v.shape:
        raise ValueError(f"lindley_scan takes two (B, n) tensors of one shape, "
                         f"got {tuple(u.shape)} and {tuple(v.shape)}")
    if u.shape[0] < 1 or u.shape[1] < 1:
        raise ValueError(f"lindley_scan needs B >= 1 and n >= 1, "
                         f"got {tuple(u.shape)}")
    if u.device != v.device:
        raise ValueError(f"lindley_scan operands lie on {u.device} and "
                         f"{v.device}")
    if not (u.is_contiguous() and v.is_contiguous()):
        raise ValueError("lindley_scan takes contiguous tensors")


_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    global _lib
    if _lib is None:
        lib = _build.load("lindley_scan")
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        for name in _FN.values():
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64, ptr]
            fn.restype = ctypes.c_int
        lib.lindley_scan_tile.argtypes = []
        lib.lindley_scan_tile.restype = ctypes.c_int64
        _lib = lib
    return _lib


def lindley_scan(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched waits ``W: (B, n)`` for max-plus element rows ``u, v: (B, n)``.

    The batch axis carries whatever the caller stacks — K candidate
    placements, independent hierarchy stages, or both (see
    :func:`lindley_scan_rows` for the ragged form). float32 or float64,
    contiguous, both operands alike; anything else raises. Launches on the
    current CUDA stream and does not synchronise.
    """
    global launch_count
    _check(u, v)
    if u.device.type == "cpu":
        return lindley_scan_plain(u, v)
    if u.device.type != "cuda":
        raise ValueError(f"lindley_scan has no kernel for device {u.device}")
    lib = _library()
    rows, n = u.shape
    tiles = -(-n // int(lib.lindley_scan_tile()))
    with torch.cuda.device(u.device):
        w = torch.empty_like(u)
        agg_u = torch.empty((rows, tiles), dtype=u.dtype, device=u.device)
        agg_v = torch.empty_like(agg_u)
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _FN[u.dtype])(
            u.data_ptr(), v.data_ptr(), w.data_ptr(), agg_u.data_ptr(),
            agg_v.data_ptr(), rows, n, stream)
    if err != 0:
        raise RuntimeError(f"lindley_scan kernel launch failed: CUDA error "
                           f"{err} for shape {tuple(u.shape)} {u.dtype}")
    launch_count += 1
    return w


def pad_rows(rows: Sequence[tuple[torch.Tensor, Optional[torch.Tensor]]]
             ) -> tuple[torch.Tensor, torch.Tensor, list[int]]:
    """Stack ragged ``(u, v)`` 1-D rows into one ``(R, longest)`` pair,
    padded with the identity ``(0, -inf)`` — padding cannot change any
    real prefix. ``v`` may be ``None`` for a row whose every element has
    ``v = 0`` (true of all real messages). Device and dtype are the first
    row's. Returns ``(u, v, lengths)``."""
    first = rows[0][0]
    lens = [int(u.shape[0]) for u, _ in rows]
    ub = torch.zeros((len(rows), max(lens)), dtype=first.dtype,
                     device=first.device)
    vb = torch.full_like(ub, float("-inf"))
    for i, (u, v) in enumerate(rows):
        ub[i, :lens[i]] = u
        vb[i, :lens[i]] = 0.0 if v is None else v
    return ub, vb, lens


def lindley_scan_rows(rows: Sequence[tuple[torch.Tensor,
                                           Optional[torch.Tensor]]]
                      ) -> list[torch.Tensor]:
    """Ragged batch: one scan for rows of different lengths.

    ``rows`` is a list of ``(u, v)`` 1-D element pairs — e.g. one row per
    hierarchy stage or per candidate placement (DESIGN.md §9) — padded by
    :func:`pad_rows` onto the scan's row axis and scanned in one call;
    returns the unpadded per-row waits.
    """
    if not rows:
        return []
    ub, vb, lens = pad_rows(rows)
    w = lindley_scan(ub, vb)
    return [w[i, :n] for i, n in enumerate(lens)]
