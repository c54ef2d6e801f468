"""The port stands alone: ``repro_torch`` (its kernels, examples,
benchmarks, models, serving engine, optimizers, trainers, launchers,
observability layer and PS runtime too), ``chip_smoke.py`` and the rank
side of the sharded tests import neither JAX nor the reference package,
and the kernels build without fast math (their plain versions are their
yardstick)."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    code = ("import sys\n"
            "import repro_torch, repro_torch.api, repro_torch.kernels.ops\n"
            "import repro_torch.launch.mesh, repro_torch.core.sharded\n"
            "import repro_torch.kernels.logreg\n"
            "import repro_torch.examples.quickstart\n"
            "import repro_torch.examples.sparse_logreg_admm\n"
            "import repro_torch.benchmarks.convergence\n"
            "import repro_torch.models, repro_torch.serving.engine\n"
            "import repro_torch.launch.serve\n"
            "import repro_torch.kernels.flash_attention\n"
            "import repro_torch.obs, repro_torch.ps\n"
            "import repro_torch.ps.runtime, repro_torch.ps.engine\n"
            "import repro_torch.benchmarks.speedup\n"
            "import repro_torch.checkpoint, repro_torch.ps.recovery\n"
            "import repro_torch.core.tree, repro_torch.core.blocks\n"
            "import repro_torch.models.weights\n"
            "import repro_torch.optim, repro_torch.training\n"
            "import repro_torch.launch.train\n"
            "import repro_torch.examples.train_transformer_admm\n"
            "import repro_torch.models.moe, repro_torch.models.ssm\n"
            "import repro_torch.examples.serve_decode\n"
            "import repro_torch.kernels.autotune\n"
            "import repro_torch.benchmarks.spmd_replay\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py",
        ROOT / "tests" / "torch_sharded_ranks.py"],     # the spawned ranks
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"


def test_kernels_build_without_fast_math():
    src = (PORT / "kernels" / "_build.py").read_text()
    assert "fast_math" not in src and "fast-math" not in src
    assert "arch=compute_90a,code=sm_90a" in src
    sources = sorted((PORT / "csrc").glob("*.cu"))
    assert [p.stem for p in sources] == sorted(_build_sources())
    for cu in sources:
        text = cu.read_text()
        assert "fast_math" not in text and "__expf(" not in text


def _build_sources():
    """``_build.SOURCES``: every source under csrc/ is built."""
    tree = ast.parse((PORT / "kernels" / "_build.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "SOURCES":
            return ast.literal_eval(node.value)
    raise AssertionError("_build.py has no SOURCES")
