"""PyTorch / CUDA port of the process-mapping system (reference: ``src/repro``).

Sub-packages mirror the reference by path:
  obs      — flight recorder, metrics, exporters (host)
  core     — graphs, hierarchy, workloads, mapping (numpy, host) and the
             Lindley-scan simulator (tensors on an explicit ``torch.device``)
  search   — batched placement search scored by ``simulate_batch``
  ckpt     — the restart cost model and fault models (host)
  sched    — the online fleet scheduler: ``FleetScheduler`` re-simulates
             the live set through ``core.simulator`` at every event
  configs  — the model architectures and shapes (data)
  kernels  — hand-written Hopper kernels with their plain PyTorch versions,
             and ``ops``, the model zoo's dispatch by tensor device
  models   — the model zoo (dense family): ``build_model`` -> ``Model``
  serve    — the batched decode engine (``ServeEngine``) and the fleet's
             request streams and SLO accounting (``serve.fleet``)
  launch   — command-line entry points (``python -m repro_torch.launch.serve``)

Entry points that touch the device take ``device=``; ``None`` means the
CUDA card and raises where there is none.
"""
