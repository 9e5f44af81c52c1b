"""PyTorch / CUDA port of the process-mapping system (reference: ``src/repro``).

Sub-packages mirror the reference by path:
  obs      — flight recorder, metrics, exporters (host)
  core     — graphs, hierarchy, workloads, mapping (numpy, host) and the
             Lindley-scan simulator (tensors on an explicit ``torch.device``)
  search   — batched placement search scored by ``simulate_batch``
  kernels  — hand-written Hopper kernels with their plain PyTorch versions

Entry points that touch the device take ``device=``; ``None`` means the
CUDA card and raises where there is none.
"""
