"""The port stands alone: no JAX and nothing of the JAX package in
``src/repro_torch`` or ``chip_smoke.py``, a real-mode serve run in a fresh
process leaves ``jax`` out of ``sys.modules``, and every module the port
copies from the JAX package is the same program (same AST, docstrings
aside) once its imports name ``repro_torch``."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
JAXPKG = ROOT / "src" / "repro"

FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s+import))", re.M)

COPIED = ["cache/allocator.py", "cache/__init__.py", "core/profiler.py",
          "core/queues.py", "core/ordering.py", "core/regulator.py",
          "core/scheduler.py", "serving/request.py", "serving/workload.py",
          "serving/metrics.py", "serving/engine.py",
          "serving/encoder_cache.py", "serving/journal.py",
          "serving/admission.py", "configs/__init__.py"] + sorted(
    f"configs/{p.name}" for p in (JAXPKG / "configs").glob("*.py")
    if p.name != "__init__.py")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_and_no_jax_package_imports(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports JAX or the JAX package"


def _normalized_ast(path: Path, rename: bool) -> str:
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and \
                isinstance(body[0], ast.Expr) and \
                isinstance(body[0].value, ast.Constant) and \
                isinstance(body[0].value.value, str):
            body[0] = ast.Pass()       # drop docstrings
        if rename and isinstance(node, ast.ImportFrom) and node.module and \
                (node.module == "repro" or node.module.startswith("repro.")):
            node.module = "repro_torch" + node.module[len("repro"):]
        if rename and isinstance(node, ast.Constant) and \
                isinstance(node.value, str) and "repro.configs" in node.value:
            node.value = node.value.replace("repro.configs",
                                            "repro_torch.configs")
    return ast.dump(tree)


@pytest.mark.parametrize("rel", COPIED)
def test_copied_modules_are_the_reference_program(rel):
    assert _normalized_ast(JAXPKG / rel, rename=True) == \
        _normalized_ast(PORT / rel, rename=False)


def test_serve_run_leaves_jax_unloaded():
    code = (
        "import sys, repro_torch\n"
        "from repro_torch.launch.serve import serve\n"
        "from repro_torch.serving.workload import WorkloadConfig\n"
        "done, eng = serve('qwen2-vl-2b', 'tcm', WorkloadConfig(mix='ML', "
        "rate=50, num_requests=6, seed=0), executor_kind='real', "
        "device='cpu')\n"
        "assert len(done) == 6, len(done)\n"
        "assert all(eng.executor.emitted.get(r.rid) for r in done)\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "print('ok', eng.iterations)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")


def test_chip_smoke_refuses_without_cuda_or_sources(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone)], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
