"""Hand-written Hopper kernels of the port, each beside its plain version.

Public surface:
  lindley_scan — segmented max-plus Lindley scan (CUDA C++,
                 ``csrc/lindley_scan.cu``): ``lindley_scan``,
                 ``lindley_scan_rows``, ``pad_rows``,
                 ``lindley_scan_plain``
  _build       — nvcc + ctypes build/bind helper (first use, cached by hash)
"""
