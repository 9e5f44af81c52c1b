"""The port's Lindley scan against the reference's scans, on the CPU.

The same ``(u, v)`` rows, made from a seed with numpy, go through
``repro_torch.kernels.lindley_scan`` (on a CPU tensor the wrapper takes
its plain version; the CUDA kernel itself is held against the plain
version on the card by ``chip_smoke.py``) and through the reference:
the float64 ``lax.associative_scan`` (1e-9: another combine order), the
Pallas kernel in interpret mode (float32, 2e-3: the tolerance the
reference holds its own kernel to) and the scalar Lindley recursion.
"""
import numpy as np
import pytest
import torch

from repro.core.sim_scan import _waits_jax
from repro.core.simulator import _lindley_waits
from repro.kernels.lindley_scan import lindley_scan as ref_lindley_scan
from repro.kernels.lindley_scan import lindley_scan_rows as ref_lindley_scan_rows
from repro_torch.core.sim_scan import _waits_kernel, _waits_torch
from repro_torch.kernels import lindley_scan as ls
from torch_port_util import reference_x64

torch.set_num_threads(1)

CPU = torch.device("cpu")
SHAPES = [(1, 1), (3, 7), (2, 513), (5, 1000), (1, 2049), (4, 1791)]


def _rows(seed: int, b: int, n: int, dtype=np.float64):
    """Random element rows: interior (X_n, 0), heads (-inf, 0) and a
    random-length identity tail (0, -inf) per row."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-1.0, 0.6, (b, n))
    v = np.zeros((b, n))
    heads = rng.random((b, n)) < 0.05
    heads[:, 0] = True
    u[heads] = -np.inf
    for i in range(b):
        pad = int(rng.integers(0, max(1, n // 3)))
        if pad:
            u[i, n - pad:] = 0.0
            v[i, n - pad:] = -np.inf
    return u.astype(dtype), v.astype(dtype)


def _scalar_reference(u, v):
    out = np.empty_like(u, dtype=np.float64)
    for i in range(u.shape[0]):
        w = -np.inf
        for j in range(u.shape[1]):
            w = max(w + u[i, j], v[i, j])
            out[i, j] = w
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_float64_matches_reference_associative_scan(seed, shape):
    u, v = _rows(seed, *shape)
    with reference_x64():
        want = np.asarray(_waits_jax(u, v))
    assert want.dtype == np.float64
    got = ls.lindley_scan_plain(torch.from_numpy(u), torch.from_numpy(v)).numpy()
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got, _scalar_reference(u, v), rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_wrapper_float32_matches_reference_kernel_interpreted(shape):
    u, v = _rows(2, *shape, dtype=np.float32)
    want = np.asarray(ref_lindley_scan(u, v, interpret=True))
    got = ls.lindley_scan(torch.from_numpy(u), torch.from_numpy(v))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_per_segment_matches_lindley_recursion(seed):
    """One row of several servers' queues: each segment's waits equal the
    reference's per-server Lindley recursion."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 40, size=6)
    u_parts, want = [], []
    for n in lens:
        arrival = np.sort(rng.uniform(0.0, 1.0, n))
        service = rng.uniform(0.0, 0.08, n)
        x = np.empty(n)
        x[0] = -np.inf
        x[1:] = service[:-1] - np.diff(arrival)
        u_parts.append(x)
        want.append(_lindley_waits(arrival, service))
    u = np.concatenate(u_parts)
    want = np.concatenate(want)
    for got in (_waits_torch(u, CPU), _waits_kernel(u, CPU)):
        assert got.dtype == np.float64 and got.shape == u.shape
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    got32 = _waits_kernel(u, CPU, torch.float32)
    np.testing.assert_allclose(got32, want, rtol=2e-3, atol=2e-3)


def test_rows_ragged_matches_reference_rows():
    rng = np.random.default_rng(0)
    rows = []
    for n in (5, 17, 3, 64, 1):
        u = rng.uniform(-1, 1, n).astype(np.float32)
        u[0] = -np.inf                    # segment head: W_0 = 0
        rows.append((u, np.zeros(n, np.float32)))
    want = ref_lindley_scan_rows(rows)
    got = ls.lindley_scan_rows(
        [(torch.from_numpy(u), torch.from_numpy(v)) for u, v in rows])
    got_implicit_v = ls.lindley_scan_rows(
        [(torch.from_numpy(u), None) for u, _ in rows])
    for (u, _), w_ref, w, w2 in zip(rows, want, got, got_implicit_v):
        assert tuple(w.shape) == u.shape
        np.testing.assert_allclose(w.numpy(), w_ref, atol=1e-5)
        np.testing.assert_array_equal(w.numpy(), w2.numpy())
    assert ls.lindley_scan_rows([]) == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_no_nan_on_all_head_and_all_padding_rows(dtype):
    n = 37
    u = torch.zeros((2, n), dtype=dtype)
    v = torch.zeros((2, n), dtype=dtype)
    u[0] = float("-inf")                  # every element a segment head
    v[1] = float("-inf")                  # every element the identity
    for fn in (ls.lindley_scan_plain, ls.lindley_scan):
        w = fn(u, v)
        assert not torch.isnan(w).any()
        # heads: W = 0 each; identities compose to (0, -inf): W = max(0, -inf)
        assert torch.equal(w, torch.zeros((2, n), dtype=dtype))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    u = torch.zeros((2, 8), dtype=torch.float64)
    with pytest.raises(TypeError):
        ls.lindley_scan(u.to(torch.float16), u.to(torch.float16))
    with pytest.raises(TypeError):
        ls.lindley_scan(u, u.to(torch.float32))
    with pytest.raises(TypeError):
        ls.lindley_scan(u.numpy(), u.numpy())
    with pytest.raises(ValueError):
        ls.lindley_scan(u[0], u[0])                       # rank 1
    with pytest.raises(ValueError):
        ls.lindley_scan(u, u[:, :4].contiguous())         # shapes differ
    with pytest.raises(ValueError):
        ls.lindley_scan(u[:, ::2], u[:, ::2])             # non-contiguous
    with pytest.raises(ValueError):
        ls.lindley_scan(u[:, :0], u[:, :0])               # n = 0


def test_cpu_tensors_do_not_count_as_kernel_launches():
    before = ls.launch_count
    ls.lindley_scan(torch.zeros((1, 4), dtype=torch.float64),
                    torch.zeros((1, 4), dtype=torch.float64))
    assert ls.launch_count == before


def _kernel_order_scan(u, v, threads, items, warp):
    """The ``.cu``'s three launches transcribed element by element in
    Python floats: thread reduce, warp Hillis-Steele scan, warp totals
    folded from the identity, carry-in scan THREADS tiles a round, rescan."""
    ident = (0.0, -np.inf)

    def comb(a, b):
        return (a[0] + b[0], max(a[1] + b[0], b[1]))

    def block_exclusive(xs):
        inc = list(xs)
        d = 1
        while d < warp:
            inc = [comb(inc[t - d], inc[t]) if t % warp >= d else inc[t]
                   for t in range(threads)]
            d <<= 1
        aggs = [inc[w * warp + warp - 1] for w in range(threads // warp)]
        total, befores = ident, []
        for a in aggs:
            befores.append(total)
            total = comb(total, a)
        return [comb(befores[t // warp], ident if t % warp == 0 else inc[t - 1])
                for t in range(threads)], total

    tile = threads * items
    n = len(u)
    tiles = -(-n // tile)
    uu = list(u) + [0.0] * (tiles * tile - n)
    vv = list(v) + [-np.inf] * (tiles * tile - n)
    el = list(zip(uu, vv))
    excl, totals = [], []
    for t in range(tiles):
        thr = []
        for th in range(threads):
            base = t * tile + th * items
            acc = el[base]
            for i in range(1, items):
                acc = comb(acc, el[base + i])
            thr.append(acc)
        e, total = block_exclusive(thr)
        excl.append(e)
        totals.append(total)
    carry, carry_in = ident, []
    for base in range(0, tiles, threads):
        xs = [totals[base + k] if base + k < tiles else ident for k in range(threads)]
        e, total = block_exclusive(xs)
        carry_in += [comb(carry, e[k]) for k in range(threads) if base + k < tiles]
        carry = comb(carry, total)
    w = []
    for t in range(tiles):
        for th in range(threads):
            run = comb(carry_in[t], excl[t][th])
            for i in range(items):
                run = comb(run, el[t * tile + th * items + i])
                w.append(max(run))
    return np.array(w[:n])


@pytest.mark.parametrize("layout,n", [((256, 7, 32), 1), ((256, 7, 32), 1793),
                                      ((256, 7, 32), 4000), ((8, 3, 4), 23),
                                      ((8, 3, 4), 24 * 8 * 2 + 5)],
                         ids=["one", "two_tiles", "three_tiles",
                              "small_tile", "two_carry_rounds"])
def test_plain_version_composes_in_the_kernel_order(monkeypatch, layout, n):
    """The plain version's bits are the kernel's: its steps follow
    ``csrc/lindley_scan.cu`` (checked against the kernel itself on the
    card). A shrunken tile (8 threads x 3 items, warps of 4) reaches the
    carry scan's second round at a size Python can walk."""
    threads, items, warp = layout
    monkeypatch.setattr(ls, "THREADS", threads)
    monkeypatch.setattr(ls, "ITEMS", items)
    monkeypatch.setattr(ls, "WARP", warp)
    monkeypatch.setattr(ls, "TILE", threads * items)
    u, v = _rows(5, 1, n)
    want = _kernel_order_scan(u[0], v[0], threads, items, warp)
    got = ls.lindley_scan_plain(torch.from_numpy(u), torch.from_numpy(v))[0].numpy()
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
