"""Hand-written Hopper kernels of the port, each beside its plain version.

Public surface:
  lindley_scan    — segmented max-plus Lindley scan (CUDA C++,
                    ``csrc/lindley_scan.cu``): ``lindley_scan``,
                    ``lindley_scan_rows``, ``pad_rows``,
                    ``lindley_scan_plain``
  flash_attention — blocked online-softmax GQA attention (CUDA C++,
                    ``csrc/flash_attention.cu``): ``flash_attention``,
                    ``flash_attention_plain``
  rmsnorm         — fused RMSNorm (CUDA C++, ``csrc/rmsnorm.cu``):
                    ``rmsnorm``, ``rmsnorm_plain``
  ssd_scan        — Mamba2 SSD chunked scan (CUDA C++,
                    ``csrc/ssd_scan.cu``): ``ssd_scan``, ``ssd_scan_plain``
  ref             — plain PyTorch versions of the model zoo's kernels
  ops             — the model zoo's dispatch by tensor device
  _build          — nvcc + ctypes build/bind helper (first use, cached by
                    hash; ``build`` compiles several sources in parallel)
"""
