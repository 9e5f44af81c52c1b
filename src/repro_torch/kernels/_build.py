"""Build and bind the package's CUDA sources (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes`` — no PyTorch headers,
no ``ninja``. The build happens at first use, from the sources shipped in
the package and nothing else, into ``build/repro_torch/`` under the
current directory, keyed on a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited kernel or header is
rebuilt. A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"

#: no --use_fast_math: the scan's infinities, the softmax's exp and the
#: norms' rsqrt / division need IEEE behaviour
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}


BUILD_DIR = Path("build") / "repro_torch"


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(cuda_home, "bin", "nvcc")
        if os.path.exists(cand):
            nvcc = cand
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are compiled at first use and need the CUDA "
                           "toolkit (PATH or CUDA_HOME)")
    return nvcc


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (content-addressed: the source,
    every header in ``csrc/`` and the flags)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_command(name: str, out: Path) -> list[str]:
    return [find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: Sequence[str]) -> None:
    """Compile every ``csrc/<name>.cu`` whose library is missing: one
    ``nvcc`` per source, all started together. Raises if any fails."""
    running = []
    for name in dict.fromkeys(names):
        out = library_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        running.append((name, out, tmp, subprocess.Popen(
            build_command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, out, tmp, proc in running:
        _, err = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{err}")
        else:
            os.replace(tmp, out)      # atomic: a concurrent process sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is missing, and load it."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def launch_on(device, fn, *args) -> int:
    """Call the C launcher ``fn(*args, stream)`` on ``device``'s current
    stream and return its CUDA error code. The current device is switched
    (and restored) only when it is not ``device`` already, and the stream
    is read as a raw handle: both are host time that every launch of a
    short kernel pays."""
    if device.index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    with torch.cuda.device(device):
        return fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
