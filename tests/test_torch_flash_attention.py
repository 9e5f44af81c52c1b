"""The port's attention against the reference's, on the CPU.

The same ``q, k, v``, made from a seed with numpy, go through
``repro_torch.kernels.flash_attention`` (on a CPU tensor the wrapper takes
its plain version; the CUDA kernel itself is held against the plain
version on the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``)
and through the reference: ``ref.attention`` and the Pallas flash kernel in
interpret mode, on the shapes, dtypes and ``q_offset`` cases of
``tests/test_kernels.py:25-60`` at the reference's tolerances (float32
2e-5, bfloat16 2e-2); then the chunked path, ``decode_attention`` and the
ragged lengths the card's kernel takes and the reference's kernel does not.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models.convert import to_tensor
from torch_port_util import FakeLibrary

torch.set_num_threads(1)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _qkv(seed, b, sq, h, kvh, d, skv=None):
    rng = np.random.default_rng(seed)
    skv = sq if skv is None else skv
    return _rand(rng, b, sq, h, d), _rand(rng, b, skv, kvh, d), _rand(rng, b, skv, kvh, d)


def _port(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("b,s,h,kvh,d", [
    (1, 128, 4, 4, 64),      # MHA
    (2, 256, 8, 2, 64),      # GQA 4x
    (1, 256, 16, 8, 128),    # qwen3-like head_dim
    (2, 128, 4, 1, 32),      # MQA
    (1, 512, 2, 2, 112),     # zamba2-like non-128 head_dim
], ids=str)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_reference_and_pallas(b, s, h, kvh, d, causal):
    q, k, v = _qkv(b * s + h + causal, b, s, h, kvh, d)
    got = fa.flash_attention(*_port(q, k, v), causal=causal).numpy()
    want = np.asarray(jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=causal))
    pallas = np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=causal, block_q=64, block_k=64))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_plain_matches_reference_and_pallas_dtypes(dtype, tol):
    q, k, v = _qkv(5, 2, 128, 4, 2, 64)
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    got = fa.flash_attention(*(to_tensor(np.asarray(a)) for a in (jq, jk, jv)))
    assert got.dtype == getattr(torch, dtype)
    want = jref.attention(jq, jk, jv, causal=True)
    pallas = pallas_flash(jq, jk, jv, causal=True, block_q=64, block_k=64)
    for other in (want, pallas):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(other, np.float32),
                                   rtol=tol, atol=tol)


def test_plain_matches_reference_and_pallas_q_offset():
    """Continuation prefill: q at absolute offset attends to earlier kv."""
    sq, skv = 64, 256
    q, k, v = _qkv(9, 1, sq, 4, 4, 64, skv=skv)
    got = fa.flash_attention(*_port(q, k, v), causal=True, q_offset=skv - sq).numpy()
    want = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, q_offset=skv - sq)
    pallas = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                          q_offset=skv - sq, block_q=32, block_k=64)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("sq,skv,q_offset,causal", [
    (100, 100, 0, True),     # ragged: no 64 / 128 block divides it
    (37, 100, 63, True),     # ragged continuation
    (1, 77, 76, True),       # one query at the end of a ragged kv
    (70, 33, 0, False),      # full attention, Sq > Skv
    (50, 20, 0, True),       # causal with Sq > Skv: late rows see all keys
])
def test_ragged_lengths_match_reference(sq, skv, q_offset, causal):
    q, k, v = _qkv(sq + skv, 2, sq, 6, 2, 48, skv=skv)
    got = fa.flash_attention(*_port(q, k, v), causal=causal, q_offset=q_offset).numpy()
    want = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal, q_offset=q_offset)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    assert np.isfinite(got).all()


def test_chunked_path_matches_reference_and_dense():
    q, k, v = _qkv(11, 1, 512, 4, 2, 32)
    chunked = ref.attention(*_port(q, k, v), causal=True, chunk_threshold=256,
                            q_chunk=128).numpy()
    dense = ref.attention(*_port(q, k, v), causal=True).numpy()
    want = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                          chunk_threshold=256, q_chunk=128)
    np.testing.assert_allclose(chunked, np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(chunked, dense, rtol=2e-5, atol=2e-5)


def test_decode_attention_matches_reference_and_last_row():
    q, k, v = _qkv(13, 2, 128, 8, 2, 64)
    pos = np.array([127, 60], np.int32)
    got = ops.decode_attention(*_port(q[:, -1:], k, v), torch.from_numpy(pos)).numpy()
    want = jref.decode_attention(jnp.asarray(q[:, -1:]), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(pos))
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    full = ref.attention(*_port(q, k, v), causal=True).numpy()
    np.testing.assert_allclose(got[:1], full[:1, -1:], rtol=2e-5, atol=2e-5)


def test_decode_attention_masks_beyond_pos():
    q, k, v = _qkv(17, 1, 1, 4, 4, 32, skv=64)
    qt, kt, vt = _port(q, k, v)
    pos = torch.tensor([20], dtype=torch.int32)
    base = ref.decode_attention(qt, kt, vt, pos)
    kt[:, 30:] = 99.0
    vt[:, 30:] = -99.0
    torch.testing.assert_close(ref.decode_attention(qt, kt, vt, pos), base,
                               rtol=1e-6, atol=0)


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    q, k, v = _port(*_qkv(19, 2, 40, 4, 2, 32))
    before = fa.launch_count
    got = fa.flash_attention(q, k, v, causal=True, q_offset=3)
    assert fa.launch_count == before
    assert got.shape == q.shape and got.dtype == q.dtype
    assert torch.equal(got, fa.flash_attention_plain(q, k, v, causal=True, q_offset=3))
    assert torch.equal(got, ops.attention(q, k, v, causal=True, q_offset=3))
    assert torch.equal(got, ops.attention(q, k, v, causal=True, q_offset=3, impl="plain"))


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    q, k, v = _port(*_qkv(23, 1, 8, 4, 2, 16))
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError):
        fa.flash_attention(q[..., :3, :], k, v)           # H % KVH != 0
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[:, :, :, :8], v[:, :, :, :8])
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, q_offset=-1)
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    with pytest.raises(ValueError):
        ops.attention(q, k, v, impl="pallas")


# ---------------------------------------------------------------------------
# the wrapper's launch path, up to the C call (the call itself needs a card)
# ---------------------------------------------------------------------------
def _unaligned(t):
    """A contiguous copy of ``t`` that starts one element into its storage."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("d", fa.BF16_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_launch_args_take_the_configs_head_dims(d, dtype):
    q, k, v = _port(*_qkv(29, 2, 33, 4, 2, d, skv=70), dtype=dtype)
    out = torch.empty_like(q)
    args = fa._launch_args(q, k, v, out, True, 5)
    assert args == (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    2, 33, 70, 4, 2, d, 1, 5, d ** -0.5)
    assert fa._launch_args(q, k, v, out, False, 0)[10] == 0


@pytest.mark.parametrize("d", [16, 40, 48, 96, 120])
def test_launch_args_refuse_bf16_head_dims_without_an_instance(d):
    """float32 takes any head dim up to 128; the bf16 kernel has tiles for
    the configs' 32, 64, 112 (on the 128-wide tiles) and 128 only."""
    q, k, v = _port(*_qkv(31, 1, 8, 2, 2, d))
    fa._launch_args(q, k, v, q, True, 0)
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    with pytest.raises(RuntimeError, match="head dims 32, 64, 112, 128"):
        fa._launch_args(qb, kb, vb, torch.empty_like(qb), True, 0)


def test_launch_args_refuse_what_no_kernel_takes():
    q, k, v = _port(*_qkv(37, 1, 8, 2, 2, 256))
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="head dims up to 128"):
            fa._launch_args(q.to(dtype), k.to(dtype), v.to(dtype), q.to(dtype), True, 0)


def test_launch_args_refuse_unaligned_bf16_operands():
    """The bf16 kernel's tensor maps need 16-byte aligned bases: each of q,
    k, v and the output is checked; float32 takes any alignment."""
    q, k, v = _port(*_qkv(41, 1, 16, 2, 1, 64), dtype=torch.bfloat16)
    out = torch.empty_like(q)
    assert all(t.data_ptr() % 16 == 0 for t in (q, k, v, out))
    for i in range(4):
        operands = [q, k, v, out]
        operands[i] = _unaligned(operands[i])
        assert operands[i].data_ptr() % 16 and operands[i].is_contiguous()
        with pytest.raises(RuntimeError, match="16-byte aligned"):
            fa._launch_args(*operands, True, 0)
    f32 = [_unaligned(t.float()) for t in (q, k, v, out)]
    assert fa._launch_args(*f32, True, 0)[0] == f32[0].data_ptr()


def test_library_binds_each_launcher_once(monkeypatch):
    lib = FakeLibrary(flash_attention_max_head_dim=fa.MAX_HEAD_DIM)
    loads = []
    monkeypatch.setattr(_build, "load", lambda name: loads.append(name) or lib)
    monkeypatch.setattr(fa, "_fns", None)
    table = fa._library()
    assert fa._library() is table and loads == ["flash_attention"]
    assert table == {torch.float32: lib.flash_attention_f32,
                     torch.bfloat16: lib.flash_attention_bf16}
    for fn in table.values():
        assert len(fn.argtypes) == 14 and fn.restype is ctypes.c_int
        assert fn.argtypes[10] is ctypes.c_int and fn.argtypes[12] is ctypes.c_float


def test_library_of_another_head_dim_limit_is_refused(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: FakeLibrary(
        flash_attention_max_head_dim=fa.MAX_HEAD_DIM * 2))
    monkeypatch.setattr(fa, "_fns", None)
    with pytest.raises(RuntimeError, match="largest head dim"):
        fa._library()
    assert fa._fns is None
