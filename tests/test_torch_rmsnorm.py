"""The port's RMSNorm against the reference's, on the CPU.

The same ``x`` and ``scale``, made from a seed with numpy, go through
``repro_torch.kernels.rmsnorm`` (on a CPU tensor the wrapper takes its
plain version; the CUDA kernel itself is held against the plain version on
the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``) and through
the reference: ``ref.rmsnorm`` and the Pallas kernel in interpret mode.
float32 at 2e-5 (the reference's own sweep, ``tests/test_kernels.py:160``);
bfloat16 at 2e-2 (one bf16 rounding of the normalised row, which another
float32 summation order can move by one unit).
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro_torch.kernels import _build
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models.convert import to_tensor
from torch_port_util import FakeLibrary

torch.set_num_threads(1)

# the reference's sweep (rows, d, Pallas block rows), plus d = 3584 (a
# non-power-of-two width of the configs) and the qk-norm rows of 128
SWEEP = [(8, 64, 4), (100, 96, 32), (256, 1024, 256), (5, 48, 8), (3, 3584, 3),
         (64, 128, 32)]


def _inputs(seed, rows, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    scale = rng.standard_normal(d).astype(np.float32)
    return x, scale


@pytest.mark.parametrize("rows,d,block", SWEEP, ids=str)
def test_plain_matches_reference_and_pallas_float32(rows, d, block):
    x, scale = _inputs(rows * d, rows, d)
    got = rn.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)).numpy()
    want = np.asarray(jref.rmsnorm(jnp.asarray(x), jnp.asarray(scale)))
    pallas = np.asarray(pallas_rmsnorm(jnp.asarray(x), jnp.asarray(scale),
                                       block_rows=block))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("rows,d,block", SWEEP, ids=str)
def test_plain_matches_reference_bfloat16(rows, d, block):
    x, scale = _inputs(rows + d, rows, d)
    xb, sb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale, jnp.bfloat16)
    want = jref.rmsnorm(xb, sb)
    got = rn.rmsnorm(to_tensor(np.asarray(xb)), to_tensor(np.asarray(sb)))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_bfloat16_rounds_before_the_scale_multiply():
    """(x * rsqrt).astype(bf16) * scale, not round((x * rsqrt) * scale)."""
    x, scale = _inputs(3, 64, 256)
    xb = torch.from_numpy(x).bfloat16()
    sb = torch.from_numpy(scale * 3.3).bfloat16()
    got = rn.rmsnorm(xb, sb)
    x32 = xb.float()
    normed = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-5)
    assert torch.equal(got, normed.bfloat16() * sb)
    late = (normed * sb.float()).bfloat16()
    assert not torch.equal(got, late)


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    x, scale = _inputs(0, 17, 384)
    xt, st = torch.from_numpy(x).reshape(17, 3, 128), torch.from_numpy(scale[:128])
    before = rn.launch_count
    got = rn.rmsnorm(xt, st, 1e-6)
    assert rn.launch_count == before
    assert got.shape == xt.shape and got.dtype == xt.dtype
    assert torch.equal(got, rn.rmsnorm_plain(xt, st, 1e-6))
    assert torch.equal(got, ref.rmsnorm(xt, st, 1e-6))
    assert torch.equal(ops.rmsnorm(xt, st, 1e-6), got)
    assert torch.equal(ops.rmsnorm(xt, st, 1e-6, impl="plain"), got)


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    x = torch.zeros((4, 8))
    with pytest.raises(TypeError):
        rn.rmsnorm(x.half(), torch.ones(8).half())
    with pytest.raises(TypeError):
        rn.rmsnorm(x, torch.ones(8, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        rn.rmsnorm(x, torch.ones(7))
    with pytest.raises(ValueError):
        rn.rmsnorm(torch.zeros((8, 4)).t(), torch.ones(8))
    with pytest.raises(ValueError):
        ops.rmsnorm(x, torch.ones(8), impl="pallas")


# ---------------------------------------------------------------------------
# the wrapper's launch path, up to the C call (the call itself needs a card)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(1, 128), (17, 3, 128), (2, 5, 7, 100), (1, 12288)],
                         ids=str)
def test_launch_args_flatten_the_leading_axes(shape):
    x = torch.zeros(shape, dtype=torch.bfloat16)
    scale = torch.ones(shape[-1], dtype=torch.bfloat16)
    out = torch.empty_like(x)
    rows = int(np.prod(shape[:-1]))
    assert rn._launch_args(x, scale, out, 1e-6) == (
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, shape[-1], 1e-6)


def test_launch_args_refuse_rows_wider_than_the_kernel_takes():
    x = torch.zeros((2, rn.MAX_D + 1))
    with pytest.raises(ValueError, match=f"at most {rn.MAX_D}"):
        rn._launch_args(x, torch.ones(rn.MAX_D + 1), torch.empty_like(x), 1e-5)


def test_library_binds_each_launcher_once(monkeypatch):
    lib = FakeLibrary(rmsnorm_max_d=rn.MAX_D)
    loads = []
    monkeypatch.setattr(_build, "load", lambda name: loads.append(name) or lib)
    monkeypatch.setattr(rn, "_fns", None)
    table = rn._library()
    assert rn._library() is table and loads == ["rmsnorm"]
    assert table == {torch.float32: lib.rmsnorm_f32, torch.bfloat16: lib.rmsnorm_bf16}
    for fn in table.values():
        assert len(fn.argtypes) == 7 and fn.restype is ctypes.c_int
        assert fn.argtypes[5] is ctypes.c_float


def test_library_of_another_row_limit_is_refused(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: FakeLibrary(rmsnorm_max_d=48 * 1024))
    monkeypatch.setattr(rn, "_fns", None)
    with pytest.raises(RuntimeError, match="widest row"):
        rn._library()
