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


#: the kernel's tiling (``csrc/lindley_scan.cu``): a block of THREADS
#: threads scans a tile of THREADS * ITEMS elements, thread t owning the
#: ITEMS consecutive elements from t * ITEMS; WARP lanes scan together
THREADS, ITEMS, WARP = 256, 7, 32
TILE = THREADS * ITEMS


def _combine(a, b):
    """``a . b`` of two ``(u, v)`` map tensors, ``a`` the EARLIER one."""
    return a[0] + b[0], torch.maximum(a[1] + b[0], b[1])


def _identity_like(t: torch.Tensor, shape) -> tuple:
    return (torch.zeros(shape, dtype=t.dtype, device=t.device),
            torch.full(shape, float("-inf"), dtype=t.dtype, device=t.device))


def _block_exclusive(x):
    """``block_exclusive`` of the ``.cu`` over the last axis (THREADS maps
    in thread order): each thread's exclusive prefix and the block total.

    A Hillis-Steele scan inside each warp; the warps' totals folded in
    order from the identity; thread ``t``'s prefix is ``before(warp) .
    inclusive(t - 1)`` (the identity for lane 0)."""
    lead = x[0].shape[:-1]
    u = x[0].reshape(*lead, THREADS // WARP, WARP).clone()
    v = x[1].reshape(*lead, THREADS // WARP, WARP).clone()
    d = 1
    while d < WARP:
        # every lane reads its d-th predecessor's value from before the step
        new_u, new_v = _combine((u[..., :-d], v[..., :-d]), (u[..., d:], v[..., d:]))
        u[..., d:], v[..., d:] = new_u, new_v
        d <<= 1
    before = _identity_like(u, lead)
    befores_u, befores_v = [], []
    for w in range(THREADS // WARP):
        befores_u.append(before[0])
        befores_v.append(before[1])
        before = _combine(before, (u[..., w, -1], v[..., w, -1]))
    first_u, first_v = _identity_like(u, (*lead, THREADS // WARP, 1))
    prev = (torch.cat([first_u, u[..., :-1]], -1), torch.cat([first_v, v[..., :-1]], -1))
    excl = _combine((torch.stack(befores_u, -1)[..., None],
                     torch.stack(befores_v, -1)[..., None]), prev)
    return (excl[0].reshape(*lead, THREADS), excl[1].reshape(*lead, THREADS)), before


def lindley_scan_plain(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The same scan in plain PyTorch, on any device, along the last axis.

    It composes the maps in the kernel's order, step for step, so its
    result is bit-identical to the kernel's: the row is cut into tiles
    padded with the identity; (1) each thread's ITEMS elements are folded
    in order and scanned across the block into one aggregate per tile;
    (2) each row's tile aggregates are scanned, THREADS at a time, into
    every tile's carry-in; (3) each tile is rescanned from its carry-in
    and its threads' exclusive prefixes. A float sum depends on its
    association, so any other order (a log-step sweep, a serial loop)
    agrees with the kernel only to rounding. ``-inf`` heads only ever meet
    ``+`` and ``max`` (never a subtraction), so no NaN can form.
    """
    shape, n = u.shape, u.shape[-1]
    u2, v2 = u.reshape(-1, n), v.reshape(-1, n)
    rows, tiles = u2.shape[0], -(-n // TILE)
    pad_u, pad_v = _identity_like(u2, (rows, tiles * TILE - n))
    uu = torch.cat([u2, pad_u], -1).reshape(rows, tiles, THREADS, ITEMS)
    vv = torch.cat([v2, pad_v], -1).reshape(rows, tiles, THREADS, ITEMS)
    # 1. per tile: each thread folds its items, the block scans the threads
    acc = (uu[..., 0], vv[..., 0])
    for i in range(1, ITEMS):
        acc = _combine(acc, (uu[..., i], vv[..., i]))
    excl, total = _block_exclusive(acc)
    # 2. per row: the tiles' carry-ins, THREADS tiles a round
    carry = _identity_like(u2, (rows,))
    carry_u, carry_v = [], []
    for base in range(0, tiles, THREADS):
        k = min(THREADS, tiles - base)
        fill_u, fill_v = _identity_like(u2, (rows, THREADS - k))
        chunk = (torch.cat([total[0][:, base:base + k], fill_u], -1),
                 torch.cat([total[1][:, base:base + k], fill_v], -1))
        chunk_excl, chunk_total = _block_exclusive(chunk)
        c = _combine((carry[0][:, None], carry[1][:, None]), chunk_excl)
        carry_u.append(c[0][:, :k])
        carry_v.append(c[1][:, :k])
        carry = _combine(carry, chunk_total)
    # 3. per tile: carry-in . thread prefix, then the thread's items
    run = _combine((torch.cat(carry_u, -1)[..., None], torch.cat(carry_v, -1)[..., None]),
                   excl)
    out = []
    for i in range(ITEMS):
        run = _combine(run, (uu[..., i], vv[..., i]))
        out.append(torch.maximum(run[0], run[1]))
    return torch.stack(out, -1).reshape(rows, tiles * TILE)[:, :n].reshape(shape)


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
    w = torch.empty_like(u)
    agg_u = torch.empty((rows, tiles), dtype=u.dtype, device=u.device)
    agg_v = torch.empty_like(agg_u)
    err = _build.launch_on(u.device, getattr(lib, _FN[u.dtype]), u.data_ptr(),
                           v.data_ptr(), w.data_ptr(), agg_u.data_ptr(),
                           agg_v.data_ptr(), rows, n)
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
