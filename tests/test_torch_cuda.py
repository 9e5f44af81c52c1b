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
