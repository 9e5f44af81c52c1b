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
