"""The port's SSD scan and conv helpers against the reference's, on the CPU.

The same inputs, made from a seed with numpy, go through
``repro_torch.kernels.ssd_scan`` (on CPU tensors the wrapper takes its plain
version; the CUDA kernel is held against the plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``) and through the
reference: ``ref.ssd_scan`` and the Pallas kernel in interpret mode.

Tolerances: float32 at 3e-5, the reference's own Pallas-vs-ref sweep
(``tests/test_kernels.py:112-125``); the sweeps' ``initial_state`` and
token-by-token checks at its 2e-4 (``:127-154``). bfloat16 at one bf16
unit of the largest |y| against ``ref`` (both round ``y_intra + y_inter +
D·x`` once; only float32 summation orders differ), and at two units against
the Pallas kernel, which rounds ``y_intra + y_inter`` to bf16 and adds
``D·x`` after it — a second rounding (ROADMAP queue 3). The conv helpers
agree with the reference bit for bit in bfloat16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models.convert import to_tensor

torch.set_num_threads(1)

#: (b, s, h, p, g, n, chunk): the reference's sweep, then mamba2's smoke block
SHAPES = [(1, 64, 2, 8, 1, 4, 16), (2, 128, 4, 16, 2, 8, 32), (1, 256, 8, 32, 1, 16, 64),
          (2, 96, 4, 16, 4, 8, 32), (2, 64, 8, 16, 1, 16, 32)]


def _inputs(seed, b, s, h, p, g, n):
    """(x, dt, A, B, C, D) as numpy float32, the reference sweep's ranges."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.3, (b, s, h)).astype(np.float32),
            -rng.uniform(0.3, 2.0, (h,)).astype(np.float32),
            rng.standard_normal((b, s, g, n)).astype(np.float32),
            rng.standard_normal((b, s, g, n)).astype(np.float32),
            rng.standard_normal(h).astype(np.float32))


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16))


def _jax(args, bf16=False):
    """The inputs as the reference takes them (x, B, C rounded to bf16 if asked)."""
    x, dt, A, B, C, D = args
    if bf16:
        x, B, C = _bf16(x), _bf16(B), _bf16(C)
    return tuple(jnp.asarray(a) for a in (x, dt, A, B, C, D))


def _torch(args):
    return tuple(to_tensor(np.asarray(a)) for a in args)


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _bf16_unit(a) -> float:
    """The spacing of bfloat16 numbers at the largest |a|."""
    return float(2.0 ** (np.floor(np.log2(np.abs(_f32(a)).max())) - 7))


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SHAPES, ids=str)
def test_plain_matches_reference_and_pallas_float32(b, s, h, p, g, n, chunk):
    args = _inputs(s + h, b, s, h, p, g, n)
    y, st = ssd.ssd_scan(*_torch(args), chunk=chunk)
    assert y.shape == (b, s, h, p) and y.dtype == torch.float32
    assert st.shape == (b, h, p, n) and st.dtype == torch.float32
    for want_y, want_st in (jref.ssd_scan(*_jax(args), chunk=chunk),
                            pallas_ssd(*_jax(args), chunk=chunk)):
        np.testing.assert_allclose(_f32(y), _f32(want_y), rtol=3e-5, atol=3e-5)
        np.testing.assert_allclose(_f32(st), _f32(want_st), rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [SHAPES[2], SHAPES[4]], ids=str)
def test_plain_matches_reference_and_pallas_bfloat16(b, s, h, p, g, n, chunk):
    args = _inputs(7 * s + h, b, s, h, p, g, n)
    jargs = _jax(args, bf16=True)
    y, st = ssd.ssd_scan(*_torch(jargs), chunk=chunk)
    assert y.dtype == torch.bfloat16
    want_y, want_st = jref.ssd_scan(*jargs, chunk=chunk)
    unit = _bf16_unit(want_y)
    assert np.abs(_f32(y) - _f32(want_y)).max() <= unit
    np.testing.assert_allclose(_f32(st), _f32(want_st), rtol=3e-5, atol=3e-5)
    pal_y, pal_st = pallas_ssd(*jargs, chunk=chunk)
    assert np.abs(_f32(y) - _f32(pal_y)).max() <= 2 * unit
    np.testing.assert_allclose(_f32(st), _f32(pal_st), rtol=3e-5, atol=3e-5)


def test_initial_state_continuation():
    """Splitting a sequence at a chunk boundary and chaining states equals
    one full scan (the prefill -> decode handoff; ``test_kernels.py:140``);
    and the port's initial-state scan equals the reference's."""
    b, s, h, p, g, n = 1, 128, 2, 8, 1, 4
    args = _torch(_inputs(3, b, s, h, p, g, n))
    x, dt, A, B, C, D = args
    y_full, st_full = ssd.ssd_scan(*args, chunk=32)
    y1, st1 = ssd.ssd_scan(x[:, :64], dt[:, :64], A, B[:, :64], C[:, :64], D, chunk=32)
    tail = [t[:, 64:].contiguous() for t in (x, dt)] + [A] + \
        [t[:, 64:].contiguous() for t in (B, C)] + [D]
    y2, st2 = ssd.ssd_scan(*tail, chunk=32, initial_state=st1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(st2.numpy(), st_full.numpy(), rtol=2e-4, atol=2e-4)
    want_y, want_st = jref.ssd_scan(*(jnp.asarray(t.numpy()) for t in tail), chunk=32,
                                    initial_state=jnp.asarray(st1.numpy()))
    np.testing.assert_allclose(y2.numpy(), _f32(want_y), rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(st2.numpy(), _f32(want_st), rtol=3e-5, atol=3e-5)


def test_chunked_equals_token_by_token():
    """The SSD duality (``test_kernels.py:127``): the chunked scan equals
    the one-token recurrence, and the port's recurrence the reference's."""
    b, s, h, p, g, n = 1, 64, 2, 8, 1, 4
    args = _inputs(4, b, s, h, p, g, n)
    x, dt, A, B, C, D = _torch(args)
    y_ref, st_ref = ssd.ssd_scan(x, dt, A, B, C, D, chunk=16)
    state = torch.zeros((b, h, p, n))
    jstate = jnp.zeros((b, h, p, n))
    jx, jdt, jA, jB, jC, jD = _jax(args)
    ys = []
    for t in range(s):
        y, state = ref.ssd_decode_step(state, x[:, t], dt[:, t], A, B[:, t], C[:, t], D)
        jy, jstate = jref.ssd_decode_step(jstate, jx[:, t], jdt[:, t], jA, jB[:, t],
                                          jC[:, t], jD)
        np.testing.assert_allclose(y.numpy(), _f32(jy), rtol=1e-5, atol=1e-5)
        ys.append(y)
    np.testing.assert_allclose(y_ref.numpy(), torch.stack(ys, 1).numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(st_ref.numpy(), state.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(state.numpy(), _f32(jstate), rtol=1e-5, atol=1e-5)


def test_softplus_is_the_references():
    x = np.random.default_rng(6).standard_normal(4096).astype(np.float32) * 8
    got = ref.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the conv helpers: bit for bit in bfloat16
# ---------------------------------------------------------------------------
def _bits(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("with_cache", [False, True])
def test_causal_conv1d_matches_reference_bit_for_bit(with_cache):
    rng = np.random.default_rng(8)
    x = _bf16(rng.standard_normal((2, 40, 24)).astype(np.float32))
    w = _bf16(rng.standard_normal((4, 24)).astype(np.float32) * 0.5)
    cache = _bf16(rng.standard_normal((2, 3, 24)).astype(np.float32)) if with_cache else None
    want, want_cache = jref.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                          cache=None if cache is None else jnp.asarray(cache))
    got, got_cache = ops.causal_conv1d(to_tensor(x), to_tensor(w),
                                       cache=None if cache is None else to_tensor(cache))
    assert got.dtype == torch.bfloat16 and got_cache.shape == (2, 3, 24)
    assert np.array_equal(_bits(got), _bits(to_tensor(np.asarray(want))))
    assert np.array_equal(_bits(got_cache), _bits(to_tensor(np.asarray(want_cache))))


def test_conv1d_step_matches_reference_bit_for_bit_and_prefill_rounds_otherwise():
    """One step of the conv equals the reference's einsum (float32 sum,
    one rounding) bit for bit; the prefill's Python sum rounds each partial
    sum, so the two differ on some elements in bf16 — in both packages."""
    rng = np.random.default_rng(9)
    w = _bf16(rng.standard_normal((4, 64)).astype(np.float32) * 0.5)
    x = _bf16(rng.standard_normal((3, 4, 64)).astype(np.float32))
    cache = np.zeros((3, 3, 64), x.dtype)
    jcache, tcache = jnp.asarray(cache), to_tensor(cache)
    for t in range(4):
        want, jcache = jref.conv1d_step(jnp.asarray(x[:, t]), jnp.asarray(w), jcache)
        got, tcache = ops.conv1d_step(to_tensor(x[:, t]), to_tensor(w), tcache)
        assert np.array_equal(_bits(got), _bits(to_tensor(np.asarray(want))))
    assert np.array_equal(_bits(tcache), _bits(to_tensor(np.asarray(jcache))))
    full, _ = ops.causal_conv1d(to_tensor(x), to_tensor(w))
    assert not torch.equal(full[:, -1], got)
    torch.testing.assert_close(full[:, -1].float(), got.float(), rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# the wrapper: dispatch and refusals
# ---------------------------------------------------------------------------
def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    args = _torch(_inputs(10, 2, 64, 4, 8, 1, 8))
    before = ssd.launch_count
    y, st = ops.ssd_scan(*args, chunk=32)
    y2, st2 = ops.ssd_scan(*args, chunk=32, impl="plain")
    y3, st3 = ssd.ssd_scan_plain(*args, chunk=32)
    assert ssd.launch_count == before
    for a, b_ in ((y, y2), (y, y3), (st, st2), (st, st3)):
        assert torch.equal(a, b_)
    with pytest.raises(ValueError):
        ops.ssd_scan(*args, chunk=32, impl="pallas")


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, dt, A, B, C, D = _torch(_inputs(11, 1, 64, 4, 8, 2, 8))
    with pytest.raises(TypeError):                       # float16 x
        ssd.ssd_scan(x.half(), dt, A, B.half(), C.half(), D, chunk=32)
    with pytest.raises(TypeError):                       # B of another dtype than x
        ssd.ssd_scan(x, dt, A, B.bfloat16(), C, D, chunk=32)
    with pytest.raises(TypeError):                       # dt not float32
        ssd.ssd_scan(x, dt.bfloat16(), A, B, C, D, chunk=32)
    with pytest.raises(TypeError):
        ssd.ssd_scan(x.numpy(), dt, A, B, C, D, chunk=32)
    with pytest.raises(ValueError):                      # s % chunk != 0
        ssd.ssd_scan(x, dt, A, B, C, D, chunk=48)
    with pytest.raises(ValueError):                      # h % g != 0
        ssd.ssd_scan(x[:, :, :3].contiguous(), dt[:, :, :3].contiguous(), A[:3], B, C,
                     D[:3], chunk=32)
    with pytest.raises(ValueError):                      # initial state of another shape
        ssd.ssd_scan(x, dt, A, B, C, D, chunk=32, initial_state=torch.zeros(1, 4, 8, 7))
    with pytest.raises(ValueError):                      # not contiguous
        ssd.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A, B, C, D,
                     chunk=32)
    meta = [t.to("meta") for t in (x, dt, A, B, C, D)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ssd.ssd_scan(*meta, chunk=32)
    with pytest.raises(ValueError):                      # operands on two devices
        ssd.ssd_scan(meta[0], dt, A, B, C, D, chunk=32)


# ---------------------------------------------------------------------------
# the kernel's two instances: which one a CUDA call takes, the wgmma
# instance's scratch, and its arithmetic in plain torch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,p,n,chunk,want", [
    (torch.bfloat16, 64, 128, 256, "wgmma"),     # mamba2-370m's heads
    (torch.bfloat16, 64, 64, 256, "wgmma"),      # zamba2-7b's heads
    (torch.bfloat16, 64, 128, 64, "wgmma"),
    (torch.float32, 64, 128, 256, "general"),    # float32: the CUDA cores
    (torch.bfloat16, 16, 16, 32, "general"),     # the smoke configs' heads
    (torch.bfloat16, 64, 128, 96, "general"),    # chunk not a multiple of 64
    (torch.bfloat16, 64, 32, 256, "general"),
    (torch.bfloat16, 32, 128, 256, "general"),
], ids=str)
def test_instance_for_picks_by_type_and_head(dtype, p, n, chunk, want):
    assert ssd.instance_for(dtype, p, n, chunk) == want


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_instance_for_picks_wgmma_for_the_configs_bf16_heads(arch):
    from repro_torch.configs import get_config, get_smoke_config
    cfg = get_config(arch)
    s = cfg.ssm
    assert cfg.dtype == "bfloat16"
    assert ssd.instance_for(torch.bfloat16, s.head_dim, s.state_dim, s.chunk) == "wgmma"
    assert ssd.instance_for(torch.float32, s.head_dim, s.state_dim, s.chunk) == "general"
    t = get_smoke_config(arch).ssm
    assert ssd.instance_for(torch.bfloat16, t.head_dim, t.state_dim, t.chunk) == "general"


@pytest.mark.parametrize("b,s,h,p,n,chunk,states_bytes", [
    (4, 2048, 32, 64, 128, 256, 33_554_432),     # the serving path's prefill
    (1, 1024, 32, 64, 128, 256, 4_194_304),      # a 1,000-token prompt, padded
    (2, 512, 112, 64, 64, 256, 7_340_032),       # zamba2's heads
], ids=str)
def test_scratch_shapes_follow_from_the_call(b, s, h, p, n, chunk, states_bytes):
    shapes = ssd.scratch_shapes(b, s, h, p, n, chunk)
    nc = s // chunk
    assert shapes == {"cd": (b, h, s, 2), "states": (b, h, nc, n, p),
                      "hin": (b, h, nc, n // 64, 2, 64, p)}
    assert list(shapes) == list(ssd.SCRATCH_DTYPES)   # the C entry point's order
    size = {k: int(np.prod(v)) * torch.empty((), dtype=ssd.SCRATCH_DTYPES[k]).element_size()
            for k, v in shapes.items()}
    # the chunk states in float32 and the entering states as bf16 hi + lo
    # take the same bytes: 33.5 MB each at the path shape
    assert size["states"] == size["hin"] == states_bytes
    assert size["cd"] == 8 * b * h * s


def _split_bf16(v: torch.Tensor):
    """``v`` as ``hi + lo`` with ``hi = bf16(v)``, ``lo = bf16(v - hi)``:
    how the wgmma instance feeds a float32 operand (M, the weighted x of
    the chunk states, the entering state) to the bf16 tensor cores, two
    products into one accumulator; ``hi + lo`` is within 2**-16 |v|."""
    hi = v.to(torch.bfloat16)
    return hi, (v - hi.float()).to(torch.bfloat16)


def _path_chunk(seed, head, h=32, L=256, n=128, p=64):
    """One chunk of mamba2's path at its ranges: bf16 x, B, C ~ N(0, 1);
    dt = softplus(N(0, 1)); A of the head from -linspace(1, 16, h)."""
    rng = np.random.default_rng(seed)
    bf = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
    x, B, C = bf(L, p).float(), bf(L, n).float(), bf(L, n).float()
    dt = torch.nn.functional.softplus(torch.from_numpy(rng.standard_normal(L).astype(np.float32)))
    a = float(-np.linspace(1.0, 16.0, h, dtype=np.float32)[head])
    cum = torch.cumsum(a * dt, 0, dtype=torch.float64).float()
    return x, B, C, dt, cum


def _operand(kind, x, B, C, dt, cum):
    """(float32 operand v, bf16-exact other factor w, v @ w as the kernel
    forms it): M x of the outputs, B^T (tail x) of the chunk state, C H of
    the entering state (H from a seeded generator)."""
    if kind == "M":
        L = x.shape[0]
        causal = torch.tril(torch.ones(L, L, dtype=torch.bool))
        seg = torch.where(causal, cum[:, None] - cum[None, :], 0.0)
        M = torch.where(causal, (C @ B.T) * torch.exp(seg) * dt[None, :], 0.0)
        return M, x
    if kind == "tail_x":
        tail = torch.exp(cum[-1] - cum) * dt
        return (tail[:, None] * x).T.contiguous(), B        # (p, L) @ (L, n): S_c^T
    H = torch.from_numpy(np.random.default_rng(1).standard_normal((B.shape[1], x.shape[1]))
                         .astype(np.float32)) * 10
    return H.T.contiguous(), C.T.contiguous()                # (p, n) @ (n, L): (C H)^T


@pytest.mark.parametrize("kind", ["M", "tail_x", "state"])
@pytest.mark.parametrize("head", [0, 15, 31], ids=lambda i: f"head{i}")
def test_hi_lo_split_holds_what_one_bf16_rounding_does_not(kind, head):
    """The wgmma instance's products with a float32 operand run as hi . w +
    lo . w: within 2**-16 of sum |v| |w| of the float64 product, element by
    element. One bf16 rounding of v (as Mamba2's own kernels round M) is
    not."""
    v, w = _operand(kind, *_path_chunk(20 + head, head))
    hi, lo = _split_bf16(v)
    assert hi.dtype == lo.dtype == torch.bfloat16
    want = v.double() @ w.double()
    scale = v.double().abs() @ w.double().abs()
    split = hi.double() @ w.double() + lo.double() @ w.double()
    assert ((split - want).abs() <= 2.0 ** -16 * scale).all()
    once = hi.double() @ w.double()
    assert ((once - want).abs() > 2.0 ** -16 * scale).any()


def _wgmma_passes(x, dt, A, B, C, D, chunk, initial_state=None):
    """The wgmma instance's three passes in plain float32 torch, each
    product with a float32 operand as the sum of its bf16 hi and lo halves:
    chunk states S_c = B^T (tail x); the state pass H_in[c] = H, H <-
    exp(cum_last) H + S_c; outputs exp(cum_i) (C H_in) + M x + D x, rounded
    once."""
    def split(v):
        hi, lo = _split_bf16(v)
        return hi.float(), lo.float()
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc, L = s // chunk, chunk
    xf = x.float().reshape(b, nc, L, h, p)
    Bf = B.float().reshape(b, nc, L, g, n).repeat_interleave(h // g, 3)
    Cf = C.float().reshape(b, nc, L, g, n).repeat_interleave(h // g, 3)
    dtc = dt.reshape(b, nc, L, h)
    cum = torch.cumsum(A * dtc, 2, dtype=torch.float64).float()
    tail = torch.exp(cum[:, :, -1:] - cum) * dtc
    hi, lo = split(tail[..., None] * xf)
    Sc = sum(torch.einsum("bclhn,bclhp->bchnp", Bf, t) for t in (hi, lo))
    H = (torch.zeros(b, h, n, p) if initial_state is None
         else initial_state.transpose(-1, -2).float())
    h_in = []
    for c in range(nc):
        h_in.append(H)
        H = H * torch.exp(cum[:, c, -1])[..., None, None] + Sc[:, c]
    hi, lo = split(torch.stack(h_in, 1))
    y = sum(torch.einsum("bclhn,bchnp->bclhp", Cf, t) for t in (hi, lo))
    y = y * torch.exp(cum)[..., None]
    causal = torch.tril(torch.ones(L, L, dtype=torch.bool))[None, None, :, :, None]
    seg = torch.where(causal, cum[:, :, :, None] - cum[:, :, None], 0.0)
    M = torch.where(causal, torch.einsum("bcihn,bcjhn->bcijh", Cf, Bf) * torch.exp(seg)
                    * dtc[:, :, None], 0.0)
    hi, lo = split(M)
    y = y + sum(torch.einsum("bcijh,bcjhp->bcihp", t, xf) for t in (hi, lo))
    y = y + D[None, None, None, :, None] * xf
    return y.reshape(b, s, h, p).to(x.dtype), H.transpose(-1, -2).contiguous()


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,init", [
    (1, 256, 4, 64, 1, 128, 64, False),
    (2, 256, 4, 64, 2, 64, 128, True),
    (1, 512, 2, 64, 1, 128, 256, True),
], ids=str)
def test_wgmma_passes_match_the_reference(b, s, h, p, g, n, chunk, init):
    """The decomposition the wgmma instance runs, hi / lo splits included,
    against the reference's ``ref.ssd_scan`` on bf16 inputs at the model's
    ranges (dt = softplus(N(0, 1)), A = -linspace(1, 16, h)): y within one
    bf16 unit of the largest |y| (both round once), the final state within
    the reference's initial-state tolerance, 2e-4."""
    rng = np.random.default_rng(s + n + chunk)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    x, B, C = _bf16(f(b, s, h, p)), _bf16(f(b, s, g, n)), _bf16(f(b, s, g, n))
    dt = np.log1p(np.exp(f(b, s, h))).astype(np.float32)
    A = -np.linspace(1.0, 16.0, h, dtype=np.float32)
    D, st = f(h), (f(b, h, p, n) if init else None)
    y, final = _wgmma_passes(*_torch((x, dt, A, B, C, D)), chunk,
                             None if st is None else torch.from_numpy(st))
    want_y, want_st = jref.ssd_scan(*_jax((x, dt, A, B, C, D)), chunk=chunk,
                                    initial_state=None if st is None else jnp.asarray(st))
    assert y.dtype == torch.bfloat16
    assert np.abs(_f32(y) - _f32(want_y)).max() <= _bf16_unit(want_y)
    np.testing.assert_allclose(final.numpy(), _f32(want_st), rtol=2e-4, atol=2e-4)
