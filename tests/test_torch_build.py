"""The kernel build helper, with a stand-in for ``nvcc`` (none here).

``_build.build`` starts one compiler per source, all together, waits for
all of them, and raises if any failed; a library that exists is not
rebuilt. The stand-in is a small shell script that logs its start and
end and writes the ``-o`` file, or fails.
"""
import os
import stat

import pytest

from repro_torch.kernels import _build

SOURCES = ("lindley_scan", "flash_attention", "rmsnorm", "ssd_scan")


def _fake_nvcc(tmp_path, body: str) -> str:
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    out = tmp_path / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    return out


def test_sources_build_in_parallel_and_are_not_rebuilt(tmp_path, build_dir, monkeypatch):
    # each compiler logs "start", waits until all have started (or
    # 30 s, so a serial build finishes, late, and fails the check below),
    # logs "end" and writes the file after -o
    log = tmp_path / "log"
    nvcc = _fake_nvcc(tmp_path, f'echo start >> "{log}"\n'
                                'i=0\n'
                                f'while [ "$(grep -c start "{log}")" -lt {len(SOURCES)} ] '
                                '&& [ $i -lt 300 ]; do sleep 0.1; i=$((i+1)); done\n'
                                f'echo end >> "{log}"\n'
                                'while [ "$1" != "-o" ]; do shift; done\n'
                                'echo built > "$2"\n')
    monkeypatch.setattr(_build, "find_nvcc", lambda: nvcc)
    _build.build(SOURCES)
    events = log.read_text().split()
    n = len(SOURCES)
    assert events == ["start"] * n + ["end"] * n, f"not in parallel: {events}"
    for name in SOURCES:
        lib = _build.library_path(name)
        assert lib.parent == build_dir and lib.read_text() == "built\n"
    assert not [p for p in os.listdir(build_dir) if ".tmp" in p]
    log.unlink()
    _build.build(SOURCES)                      # all present: nothing runs
    assert not log.exists()


def test_a_failed_build_raises_and_leaves_no_library(tmp_path, build_dir, monkeypatch):
    nvcc = _fake_nvcc(tmp_path, 'echo "error: no such card" >&2\nexit 2\n')
    monkeypatch.setattr(_build, "find_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match=r"nvcc failed on rmsnorm\.cu \(exit 2\)"):
        _build.build(["rmsnorm"])
    assert not _build.library_path("rmsnorm").exists()


def test_library_path_follows_source_and_flags():
    a = _build.library_path("flash_attention")
    assert a.name.startswith("libflash_attention-") and a.suffix == ".so"
    assert a != _build.library_path("rmsnorm")
    assert "-gencode" in _build.NVCC_FLAGS and "--use_fast_math" not in _build.NVCC_FLAGS


def test_library_path_follows_the_shared_headers(tmp_path, monkeypatch):
    """A source's library is keyed on every ``csrc/*.cuh`` too: editing or
    adding a header changes the path, so no stale library is loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "hopper.cuh"\n')
    (csrc / "hopper.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    first = _build.library_path("k")
    (csrc / "hopper.cuh").write_text("// two\n")
    assert _build.library_path("k") != first
    (csrc / "hopper.cuh").write_text("// one\n")
    assert _build.library_path("k") == first
    (csrc / "more.cuh").write_text("")
    assert _build.library_path("k") != first


def test_the_tensor_core_kernels_share_one_header():
    for name in ("flash_attention", "ssd_scan"):
        assert '#include "hopper.cuh"' in (_build.CSRC / f"{name}.cu").read_text()
    assert (_build.CSRC / "hopper.cuh").exists()
