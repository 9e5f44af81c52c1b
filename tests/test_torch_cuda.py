"""Tests of the port that need a CUDA card (marker ``cuda``).

They import nothing of the reference package, so they run on a machine
that has PyTorch with CUDA and ``nvcc`` but no JAX::

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card each test skips (decided inside the test, never at import).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import ClusterTopology, mapping, simulate, simulate_batch, workloads
from repro_torch.core.simulator import resolve_backend
from repro_torch.kernels import lindley_scan as ls

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    return torch.device("cuda", 0)


def _rows(seed, b, n, dtype, device):
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.9, 0.7, (b, n))
    heads = rng.random((b, n)) < 0.01
    heads[:, 0] = True
    u[heads] = -np.inf
    v = np.zeros((b, n))
    u[-1, n - n // 4:] = 0.0
    v[-1, n - n // 4:] = -np.inf
    return (torch.from_numpy(u).to(device, dtype),
            torch.from_numpy(v).to(device, dtype))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 2e-3)], ids=str)
@pytest.mark.parametrize("shape", [(1, 1), (3, 7), (2, 1792), (5, 1793),
                                   (64, 100_003), (4, 1_000_000)], ids=str)
def test_kernel_matches_plain_version(card, shape, dtype, tol):
    u, v = _rows(0, *shape, dtype, card)
    before = ls.launch_count
    got = ls.lindley_scan(u, v)
    torch.cuda.synchronize()
    assert ls.launch_count == before + 1
    want = ls.lindley_scan_plain(u, v)
    assert not torch.isnan(got).any()
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_wrapper_raises_on_cuda_tensors_it_does_not_take(card):
    u = torch.zeros((2, 8), dtype=torch.float64, device=card)
    with pytest.raises(TypeError):
        ls.lindley_scan(u.half(), u.half())
    with pytest.raises(ValueError):
        ls.lindley_scan(u[:, ::2], u[:, ::2])
    with pytest.raises(ValueError):
        ls.lindley_scan(u, u.cpu())


def test_auto_backend_is_the_kernel_and_agrees_with_the_host(card):
    assert resolve_backend("auto", card) == "kernel"
    assert resolve_backend("auto", None) == "kernel"
    jobs = workloads.synt_workload_3()
    cluster = ClusterTopology()
    pls = [mapping.STRATEGIES[n](jobs, cluster)
           for n in mapping.ONE_SHOT_STRATEGIES]
    before = ls.launch_count
    batch = simulate_batch(jobs, pls, cluster, 0.02)          # device=None
    assert ls.launch_count > before
    for pl, res in zip(pls, batch):
        host = simulate(jobs, pl, cluster, 0.02, backend="segmented",
                        device="cpu")
        assert res.total_wait == pytest.approx(host.total_wait, rel=1e-9)
        assert res.workload_finish == pytest.approx(host.workload_finish,
                                                    rel=1e-9)


# ---------------------------------------------------------------------------
# flash attention (K2) and RMSNorm (K4) against their plain versions
# ---------------------------------------------------------------------------
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _qkv(seed, b, sq, h, kvh, d, skv, dtype, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)
            for shape in ((b, sq, h, d), (b, skv, kvh, d), (b, skv, kvh, d))]


#: the bf16 kernel's tiles are 128 queries (two warpgroups of 64) by 128
#: keys; the cases after the first eight cross those edges
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,sq,skv,h,kvh,d,causal,q_offset", [
    (2, 256, 256, 16, 8, 128, True, 0),     # qwen3's heads
    (1, 1000, 1000, 4, 2, 128, True, 0),    # ragged
    (1, 64, 256, 4, 4, 64, True, 192),      # continuation
    (2, 130, 130, 8, 2, 64, False, 0),      # full, ragged
    (2, 128, 128, 4, 1, 32, True, 0),       # MQA
    (1, 200, 200, 2, 2, 112, True, 0),      # zamba2's head dim
    (3, 1, 77, 4, 2, 128, True, 76),        # one query at the end
    (2, 300, 300, 8, 2, 32, True, 0),       # ragged, head dim 32
    (1, 129, 129, 4, 2, 128, True, 0),      # one row past a query tile
    (1, 127, 127, 4, 2, 128, True, 0),      # one row short of it
    (2, 100, 60, 4, 2, 64, False, 0),       # Skv < 128, full
    (1, 50, 20, 2, 1, 128, True, 0),        # Skv < Sq < 128, causal
    (1, 64, 300, 4, 2, 128, True, 236),     # q_offset off the key tile
    (1, 77, 200, 4, 4, 64, True, 100),      # ... and off the query tile
    (3, 1, 77, 64, 8, 128, True, 76),       # B * H = 192 blocks of one row
    (2, 256, 256, 8, 1, 128, True, 0),      # MQA at head dim 128
    (1, 300, 300, 4, 2, 112, False, 0),     # head dim 112, full, ragged
    (2, 200, 333, 4, 2, 32, False, 0),      # head dim 32, full, ragged
], ids=str)
def test_flash_attention_matches_plain_version(card, dtype, b, sq, skv, h, kvh, d,
                                               causal, q_offset):
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _qkv(sq + d, b, sq, h, kvh, d, skv, dtype, card)
    before = fa.launch_count
    got = fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa.launch_count == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
#: d = 128 and 64 hold a row in 16 and 8 lanes, 24 (bf16) in 4; d = 100
#: and 2050 are not 16-byte multiples (scalar); 6144 and 12288 (bf16) are
#: read twice; (1, d) is one row
@pytest.mark.parametrize("rows,d", [(8192, 1024), (4096, 128), (7, 3584), (5, 6144),
                                    (3, 100), (1, 12288), (1, 128), (33, 64), (5, 24),
                                    (4, 2050), (6, 4096), (9, 2048)], ids=str)
def test_rmsnorm_matches_plain_version(card, dtype, rows, d):
    from repro_torch.kernels import rmsnorm as rn
    rng = np.random.default_rng(rows + d)
    x = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32)).to(card, dtype)
    scale = torch.from_numpy(rng.standard_normal(d).astype(np.float32)).to(card, dtype)
    before = rn.launch_count
    got = rn.rmsnorm(x, scale)
    torch.cuda.synchronize()
    assert rn.launch_count == before + 1
    want = rn.rmsnorm_plain(x, scale)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_rmsnorm_takes_unaligned_operands(card):
    """A contiguous view one element into its storage goes through the
    scalar path: the same values as the plain version."""
    from repro_torch.kernels import rmsnorm as rn
    rng = np.random.default_rng(5)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.standard_normal((6, 1024)).astype(np.float32)).to(card, dtype)
        scale = torch.from_numpy(rng.standard_normal(1024).astype(np.float32)).to(card, dtype)
        xs = torch.empty(x.numel() + 1, dtype=dtype, device=card)[1:].view(x.shape)
        xs.copy_(x)
        assert xs.data_ptr() % 16 != 0 and xs.is_contiguous()
        got = rn.rmsnorm(xs, scale)
        torch.cuda.synchronize()
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(got.float(), rn.rmsnorm_plain(x, scale).float(),
                                   rtol=tol, atol=tol)


def test_flash_attention_takes_unaligned_operands(card):
    """A contiguous view that starts one element into its storage is not
    16-byte aligned: float32 takes it, bfloat16 (the tensor-core kernel's
    16-byte loads) raises."""
    from repro_torch.kernels import flash_attention as fa

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out
    q, k, v = _qkv(3, 2, 100, 4, 2, 64, 100, torch.float32, card)
    qs, ks, vs = (shifted(t) for t in (q, k, v))
    assert qs.data_ptr() % 16 != 0 and qs.is_contiguous()
    got = fa.flash_attention(qs, ks, vs)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    qs, ks, vs = (shifted(t.bfloat16()) for t in (q, k, v))
    with pytest.raises(RuntimeError, match="16-byte aligned"):
        fa.flash_attention(qs, ks, vs)


def test_kernel_wrappers_raise_on_cuda_tensors_they_do_not_take(card):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    q, k, v = _qkv(0, 1, 8, 4, 2, 256, 8, torch.float32, card)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v)                     # head dim 256 > 128
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half())
    q, k, v = _qkv(0, 1, 8, 4, 2, 40, 8, torch.bfloat16, card)
    with pytest.raises(RuntimeError, match="head dims 32, 64, 112, 128"):
        fa.flash_attention(q, k, v)                     # no bf16 instance for 40
    x = torch.zeros((2, 20000), device=card)
    with pytest.raises(ValueError):
        rn.rmsnorm(x, torch.ones(20000, device=card))    # row longer than the kernel holds
    with pytest.raises(ValueError):
        rn.rmsnorm(x[:, ::2], torch.ones(10000, device=card))


# ---------------------------------------------------------------------------
# SSD chunked scan (K3) against its plain version, and the SSM model
# ---------------------------------------------------------------------------
#: (b, s, h, p, g, n, chunk): mamba2's smoke block, two of the reference's
#: sweep shapes, the serving path's 4 x 2048 prefill, a 1,000-token prompt
#: padded to 1,024, and zamba2's heads (n = 64)
SSD_CASES = [(2, 64, 8, 16, 1, 16, 32), (1, 64, 2, 8, 1, 4, 16), (2, 96, 4, 16, 4, 8, 32),
             (4, 2048, 32, 64, 1, 128, 256), (1, 1024, 32, 64, 1, 128, 256),
             (1, 512, 112, 64, 1, 64, 256)]


def _ssd_inputs(seed, b, s, h, p, g, n, dtype, device, init):
    """The model's ranges: dt = softplus(N(0, 1)), A = -linspace(1, 16, h)
    (A dt reaches about -11 a step at the last head)."""
    rng = np.random.default_rng(seed)
    t = lambda a, dt=torch.float32: torch.from_numpy(a.astype(np.float32)).to(device, dt)
    return (t(rng.standard_normal((b, s, h, p)), dtype),
            torch.nn.functional.softplus(t(rng.standard_normal((b, s, h)))),
            -torch.linspace(1.0, 16.0, h, device=device),
            t(rng.standard_normal((b, s, g, n)), dtype),
            t(rng.standard_normal((b, s, g, n)), dtype),
            t(rng.standard_normal(h)),
            t(rng.standard_normal((b, h, p, n))) if init else None)


@pytest.mark.parametrize("init", [False, True], ids=["zeros", "initial_state"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_CASES, ids=str)
def test_ssd_scan_matches_plain_version(card, dtype, init, b, s, h, p, g, n, chunk):
    from repro_torch.kernels import ssd_scan as ssd
    x, dt, A, B, C, D, st = _ssd_inputs(s + h, b, s, h, p, g, n, dtype, card, init)
    before = ssd.launch_count
    y, final = ssd.ssd_scan(x, dt, A, B, C, D, chunk=chunk, initial_state=st)
    torch.cuda.synchronize()
    assert ssd.launch_count == before + 1
    want_y, want_final = ssd.ssd_scan_plain(x, dt, A, B, C, D, chunk=chunk,
                                            initial_state=st)
    assert y.dtype == dtype and y.shape == x.shape and final.shape == (b, h, p, n)
    assert torch.isfinite(y).all() and torch.isfinite(final).all()
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(final, want_final, rtol=tol, atol=tol)


def test_ssd_scan_raises_on_cuda_tensors_it_does_not_take(card):
    from repro_torch.kernels import ssd_scan as ssd
    x, dt, A, B, C, D, _ = _ssd_inputs(0, 1, 64, 2, 128, 1, 16, torch.float32, card, False)
    with pytest.raises(ValueError, match="p <= 64"):
        ssd.ssd_scan(x, dt, A, B, C, D, chunk=32)        # head dim 128 > 64
    x, dt, A, B, C, D, _ = _ssd_inputs(0, 1, 64, 2, 16, 1, 6, torch.float32, card, False)
    with pytest.raises(ValueError, match="n % 4 == 0"):
        ssd.ssd_scan(x, dt, A, B, C, D, chunk=32)        # state 6
    with pytest.raises(ValueError):
        ssd.ssd_scan(x, dt, A, B, C, D, chunk=48)        # 64 % 48
    with pytest.raises(ValueError):
        ssd.ssd_scan(x, dt.cpu(), A, B, C, D, chunk=32)


#: (name, b, s, h, p, g, n, chunk, valid steps, initial state): cases of the
#: wgmma instance (bf16, p 64, n 64 / 128)
WGMMA_CASES = [
    ("state_passing", 1, 8192, 8, 64, 1, 128, 256, 8192, True),   # 32 chunks
    ("grouped", 2, 512, 8, 64, 2, 64, 256, 512, False),           # g = 2, n = 64
    ("padded_tail", 1, 1024, 32, 64, 1, 128, 256, 1000, False),   # dt, x, B, C = 0 from 1000
    ("chunk64", 2, 384, 4, 64, 1, 128, 64, 384, True),
    ("chunk128_n64", 1, 640, 6, 64, 3, 64, 128, 600, True),
]


@pytest.mark.parametrize("name,b,s,h,p,g,n,chunk,valid,init", WGMMA_CASES,
                         ids=[c[0] for c in WGMMA_CASES])
def test_ssd_scan_wgmma_instance_matches_plain_version(card, name, b, s, h, p, g, n, chunk,
                                                       valid, init):
    from repro_torch.kernels import ssd_scan as ssd
    x, dt, A, B, C, D, st = _ssd_inputs(s + n + chunk, b, s, h, p, g, n, torch.bfloat16,
                                        card, init)
    for t in (x, dt, B, C):
        t[:, valid:] = 0
    before = dict(ssd.instance_counts)
    y, final = ssd.ssd_scan(x, dt, A, B, C, D, chunk=chunk, initial_state=st)
    torch.cuda.synchronize()
    assert ssd.instance_counts == {"wgmma": before["wgmma"] + 1, "general": before["general"]}
    want_y, want_final = ssd.ssd_scan_plain(x, dt, A, B, C, D, chunk=chunk, initial_state=st)
    assert torch.isfinite(y).all() and torch.isfinite(final).all()
    tol = ATTN_TOL[torch.bfloat16]
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(final, want_final, rtol=tol, atol=tol)
    if valid < s:
        assert not y[:, valid:].any()                   # padded steps give y = 0 exactly


@pytest.mark.parametrize("n", [64, 128])
def test_ssd_scan_wgmma_known_case(card, n):
    """A = 0, dt = 1 and every row of B and C the same one-hot vector: M is
    the causal 0/1 mask and the state never decays, so y is the prefix sum
    of x over the whole sequence plus D x — held against a float64 cumsum.
    A wrong descriptor or swizzle shows here as wrong numbers."""
    from repro_torch.kernels import ssd_scan as ssd
    b, s, h, p, g = 2, 1024, 4, 64, 1
    gen = torch.Generator(device=card).manual_seed(n)
    x = torch.randn((b, s, h, p), generator=gen, device=card).bfloat16()
    B = torch.zeros((b, s, g, n), device=card)
    B[..., 5] = 1
    B = B.bfloat16()
    D = torch.linspace(-1.0, 1.0, h, device=card)
    y, final = ssd.ssd_scan(x, torch.ones((b, s, h), device=card), torch.zeros(h, device=card),
                            B, B.clone(), D, chunk=256)
    torch.cuda.synchronize()
    xd = x.double()
    want = (torch.cumsum(xd, 1) + D.double()[None, None, :, None] * xd).float()
    torch.testing.assert_close(y.float(), want, rtol=2e-2, atol=2e-2)
    want_final = torch.zeros((b, h, p, n), device=card, dtype=torch.float64)
    want_final[..., 5] = xd.sum(1)
    torch.testing.assert_close(final.double(), want_final, rtol=1e-5, atol=1e-4)


def _ssd_float64(x, dt, A, B, C, D, chunk, initial_state=None, operand=lambda v: v):
    """K3's function in float64 by the SSD block decomposition, with the
    within-chunk cumsum rounded to float32 once as the kernel rounds it.
    ``operand`` is applied to each product's float32 operand (M, tail x,
    the entering state). Returns y unrounded and the final state, float64."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc, L = s // chunk, chunk
    f64 = torch.float64
    xc = x.to(f64).reshape(b, nc, L, h, p)
    dtc = dt.to(f64).reshape(b, nc, L, h)
    Bc = B.to(f64).reshape(b, nc, L, g, n).repeat_interleave(h // g, 3)
    Cc = C.to(f64).reshape(b, nc, L, g, n).repeat_interleave(h // g, 3)
    cum = torch.cumsum(A.to(f64) * dtc, 2).float().double()
    causal = torch.tril(torch.ones(L, L, dtype=torch.bool, device=x.device))[None, None, ..., None]
    seg = torch.where(causal, cum[:, :, :, None] - cum[:, :, None], 0.0)
    M = torch.where(causal, torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc) * torch.exp(seg)
                    * dtc[:, :, None], 0.0)
    tail = torch.exp(cum[:, :, -1:] - cum) * dtc
    Sc = torch.einsum("bclhn,bclhp->bchpn", Bc, operand(tail[..., None] * xc))
    H = (torch.zeros((b, h, p, n), dtype=f64, device=x.device) if initial_state is None
         else initial_state.to(f64))
    h_in = []
    for c in range(nc):
        h_in.append(H)
        H = H * torch.exp(cum[:, c, -1])[..., None, None] + Sc[:, c]
    y = torch.einsum("bclhn,bchpn->bclhp", Cc, operand(torch.stack(h_in, 1))) \
        * torch.exp(cum)[..., None]
    y = y + torch.einsum("bcijh,bcjhp->bcihp", operand(M), xc) + D.to(f64)[:, None] * xc
    return y.reshape(b, s, h, p), H


@pytest.mark.parametrize("n", [128, 64])
def test_ssd_scan_wgmma_keeps_the_lo_halves(card, n):
    """The wgmma instance feeds each float32 operand (M, tail x, the
    entering state) to the bf16 tensor cores as hi + lo. Held against
    float64, it must stay ten times closer than a control that rounds
    those operands to bf16 once (as Mamba2's own kernels round M): in the
    final state, and in y where |y| < 2**-4, so that y's own bf16 rounding
    (half a unit, 2**-13 there) does not hide the operands' error. A kernel
    that dropped a lo half would sit near the control."""
    from repro_torch.kernels import ssd_scan as ssd
    b, s, h, p, g, chunk = 1, 1024, 32, 64, 1, 256
    x, dt, A, B, C, D, st = _ssd_inputs(n, b, s, h, p, g, n, torch.bfloat16, card, True)
    y, final = ssd._ssd_scan(x, dt, A, B, C, D, chunk=chunk, initial_state=st,
                             instance="wgmma")
    torch.cuda.synchronize()
    want_y, want_final = _ssd_float64(x, dt, A, B, C, D, chunk, st)
    once = lambda v: v.to(torch.bfloat16).double()
    ctl_y, ctl_final = _ssd_float64(x, dt, A, B, C, D, chunk, st, operand=once)
    small = want_y.abs() < 2.0 ** -4
    assert small.sum() > 10_000
    y_err = (y.double() - want_y).abs()[small].max()
    y_ctl = (once(ctl_y) - want_y).abs()[small].max()
    st_err = (final.double() - want_final).abs().max()
    st_ctl = (ctl_final - want_final).abs().max()
    assert y_err * 10 <= y_ctl, (y_err, y_ctl)
    assert st_err * 10 <= st_ctl, (st_err, st_ctl)


def test_ssd_scan_both_instances_at_the_path_shape(card):
    """mamba2's per-layer call of the 4 x 2048 prefill through each instance,
    named through ``_ssd_scan``; the per-instance counts show which ran."""
    from repro_torch.kernels import ssd_scan as ssd
    b, s, h, p, g, n, chunk = 4, 2048, 32, 64, 1, 128, 256
    x, dt, A, B, C, D, _ = _ssd_inputs(7, b, s, h, p, g, n, torch.bfloat16, card, False)
    want_y, want_final = ssd.ssd_scan_plain(x, dt, A, B, C, D, chunk=chunk)
    tol = ATTN_TOL[torch.bfloat16]
    for inst in ("wgmma", "general"):
        before = dict(ssd.instance_counts)
        y, final = ssd._ssd_scan(x, dt, A, B, C, D, chunk=chunk, instance=inst)
        torch.cuda.synchronize()
        assert {k: v - before[k] for k, v in ssd.instance_counts.items()} == {
            k: int(k == inst) for k in ssd.INSTANCES}
        torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(final, want_final, rtol=tol, atol=tol)


def test_ssd_scan_wgmma_instance_raises_and_never_falls_back(card):
    from repro_torch.kernels import ssd_scan as ssd
    x, dt, A, B, C, D, _ = _ssd_inputs(1, 1, 256, 4, 64, 1, 128, torch.float32, card, False)
    before = (ssd.launch_count, dict(ssd.instance_counts))
    with pytest.raises(ValueError, match="wgmma instance takes bf16"):
        ssd._ssd_scan(x, dt, A, B, C, D, chunk=256, instance="wgmma")
    xb, Bb, Cb = x.bfloat16(), B.bfloat16(), C.bfloat16()
    with pytest.raises(ValueError, match="wgmma instance takes"):
        ssd._ssd_scan(xb, dt, A, Bb, Cb, D, chunk=32, instance="wgmma")   # 32 % 64
    shifted = torch.empty(xb.numel() + 1, dtype=torch.bfloat16, device=card)[1:].view(xb.shape)
    shifted.copy_(xb)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    with pytest.raises(RuntimeError, match="16-byte aligned"):
        ssd.ssd_scan(shifted, dt, A, Bb, Cb, D, chunk=256)
    assert (ssd.launch_count, ssd.instance_counts) == before


def test_ssm_model_on_the_card_matches_its_plain_twin(card):
    """mamba2's smoke config in float32: the kernel model (K3, K4) against
    the plain twin on the same weights, prefill (ragged: 40 tokens, chunk
    32) and decode."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import build_model
    cfg = get_smoke_config("mamba2-370m")
    model = build_model(cfg).init(torch.Generator(device=card).manual_seed(0))
    twin = build_model(cfg, device=card, impl="plain")
    twin.load_state_dict(model.state_dict())
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 40))).to(card)
    before = ssd.launch_count
    got, cache = model.prefill(toks)
    assert ssd.launch_count == before + cfg.n_layers
    want, want_cache = twin.prefill(toks)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(cache["ssm"], want_cache["ssm"], rtol=1e-4, atol=1e-4)
    step = torch.tensor([[3], [5]], device=card)
    got, _ = model.decode_step(cache, step, torch.tensor([40, 40]))
    want, _ = twin.decode_step(want_cache, step, torch.tensor([40, 40]))
    assert ssd.launch_count == before + cfg.n_layers      # decode runs no scan
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
