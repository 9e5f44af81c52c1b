"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or the reference package ``repro``, and
``triton`` is never imported while a module is imported."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "repro"}


def _imports(tree, top_level_only=False):
    """(root module name, relative level) of every import statement."""
    nodes = tree.body if top_level_only else ast.walk(tree)
    for node in nodes:
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


def test_the_walk_covers_the_slice():
    names = {str(p.relative_to(PORT)) for p in FILES[:-1]}
    for want in ("__init__.py", "obs/recorder.py", "core/graphs.py",
                 "core/simulator.py", "core/sim_scan.py", "core/convert.py",
                 "search/optimizer.py", "kernels/lindley_scan.py",
                 "kernels/_build.py", "kernels/flash_attention.py",
                 "kernels/rmsnorm.py", "kernels/ssd_scan.py", "kernels/ref.py",
                 "kernels/ops.py", "models/ssm.py",
                 "configs/base.py", "configs/qwen3_0_6b.py",
                 "models/layers.py", "models/model.py", "models/convert.py",
                 "serve/engine.py", "launch/serve.py", "serve/fleet.py",
                 "core/commgraph.py", "ckpt/__init__.py", "ckpt/checkpoint.py",
                 "ckpt/fault_tolerance.py", "sched/__init__.py",
                 "sched/events.py", "sched/stats.py", "sched/loads.py",
                 "sched/config.py", "sched/cells.py", "sched/clock.py",
                 "sched/traces.py", "sched/recovery.py", "sched/remap.py",
                 "sched/admission.py", "sched/autoscale.py",
                 "sched/scheduler.py"):
        assert want in names
    for cu in ("lindley_scan.cu", "flash_attention.cu", "rmsnorm.cu", "ssd_scan.cu"):
        assert (PORT / "kernels" / "csrc" / cu).is_file()


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for root, level in _imports(tree):
        if level == 0:
            assert root not in FORBIDDEN, f"{path}: imports {root}"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_triton_import_at_module_top(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for root, level in _imports(tree, top_level_only=True):
        assert not (level == 0 and root == "triton"), f"{path}: top-level triton"


def test_importing_the_port_leaves_jax_and_reference_out():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.obs, repro_torch.core\n"
        "import repro_torch.core.convert, repro_torch.search\n"
        "import repro_torch.kernels.lindley_scan\n"
        "import repro_torch.kernels.ops, repro_torch.configs, repro_torch.models\n"
        "import repro_torch.kernels.ssd_scan, repro_torch.models.ssm\n"
        "import repro_torch.models.convert, repro_torch.serve\n"
        "import repro_torch.launch.serve\n"
        "import repro_torch.sched, repro_torch.ckpt, repro_torch.serve.fleet\n"
        "import repro_torch.core.commgraph\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'triton'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stdout + proc.stderr
