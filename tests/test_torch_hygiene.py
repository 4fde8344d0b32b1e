"""The port stands alone: no JAX and nothing of the JAX package in
``src/repro_torch`` or ``chip_smoke.py``, a real-mode serve run and a
train step in a fresh process leave ``jax`` out of ``sys.modules``, and
every module the port copies from the JAX package is the same program
(same AST, docstrings aside) once its imports name ``repro_torch``."""
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
          "serving/admission.py", "serving/faults.py", "serving/router.py",
          "serving/migration.py", "serving/fleet.py",
          "configs/__init__.py", "train/data.py"] + sorted(
    f"configs/{p.name}" for p in (JAXPKG / "configs").glob("*.py")
    if p.name != "__init__.py")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_and_no_jax_package_imports(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports JAX or the JAX package"


def test_every_model_module_is_checked():
    """The scan above reaches each module of the port's model, the
    recurrent blocks and the launcher included."""
    names = {p.relative_to(PORT).as_posix() for p in _sources()
             if PORT in p.parents}
    assert {"models/layers.py", "models/ssm.py", "models/xlstm.py",
            "models/transformer.py", "models/params.py",
            "launch/serve.py", "serving/executors.py", "train/loop.py",
            "train/optimizer.py", "train/checkpoint.py",
            "launch/train.py", "models/sharding.py", "launch/mesh.py",
            "launch/dryrun.py", "launch/dryrun_all.py"} <= names


def test_new_model_modules_import_alone():
    """``models/ssm.py``, ``models/xlstm.py`` and the fleet tier
    (``serving/fleet.py``, ``serving/migration.py``) load in a fresh
    process without JAX or the JAX package."""
    code = ("import sys\n"
            "import repro_torch.models.ssm, repro_torch.models.xlstm\n"
            "import repro_torch.serving.fleet, "
            "repro_torch.serving.migration\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


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


# launch/analysis.py is the reference's roofline model with its hardware
# constants set to an H100 SXM5's: the same program once these three
# assignments are dropped from both sides, and nothing else
HARDWARE_CONSTANTS = {"PEAK_FLOPS", "HBM_BW", "ICI_BW"}


def _without_constants(path: Path) -> str:
    """``path``'s source with the module-level assignments of
    ``HARDWARE_CONSTANTS`` dropped (each must be there)."""
    tree = ast.parse(path.read_text())
    names = [n.targets[0].id for n in tree.body
             if isinstance(n, ast.Assign) and len(n.targets) == 1 and
             isinstance(n.targets[0], ast.Name)]
    assert HARDWARE_CONSTANTS <= set(names), path
    tree.body = [n for n in tree.body if not (
        isinstance(n, ast.Assign) and len(n.targets) == 1 and
        isinstance(n.targets[0], ast.Name) and
        n.targets[0].id in HARDWARE_CONSTANTS)]
    return ast.unparse(tree)


def test_analysis_is_the_reference_program_but_its_constants(tmp_path):
    stripped = {}
    for side, root in (("ref", JAXPKG), ("port", PORT)):
        stripped[side] = tmp_path / f"{side}_analysis.py"
        stripped[side].write_text(
            _without_constants(root / "launch/analysis.py"))
    assert _normalized_ast(stripped["ref"], rename=True) == \
        _normalized_ast(stripped["port"], rename=False)
    from repro_torch.launch import analysis
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.ICI_BW) == \
        (989e12, 3.35e12, 50e9)


def test_dryrun_leaves_jax_unloaded():
    """The dry-run runs a reduced pair on the simulated (16, 16) mesh in a
    fresh process without loading JAX or the JAX package."""
    code = (
        "import sys\n"
        "from repro_torch.configs import get_reduced\n"
        "from repro_torch.launch import dryrun\n"
        "from repro_torch.models.config import pad_for_tp\n"
        "r = dryrun.run_one('qwen2-vl-2b', 'decode', 'single', '', "
        "cfg=pad_for_tp(get_reduced('qwen2-vl-2b'), 16), "
        "meta=dict(kind='decode', seq=64, batch=16), write=False)\n"
        "assert r['collectives']['all-reduce']['count'] == 5, r\n"
        "bad = [m for m in sys.modules if m in ('jax', 'repro') or "
        "m.startswith(('jax.', 'repro.'))]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_serve_run_leaves_jax_unloaded():
    """Real-mode serve runs of the batched path and of the dense-slot path
    (``real-legacy``, and gemma3, which takes it by itself) in a fresh
    process never load JAX."""
    code = (
        "import sys, repro_torch\n"
        "from repro_torch.launch.serve import serve\n"
        "from repro_torch.serving.workload import WorkloadConfig\n"
        "for arch, kind in (('qwen2-vl-2b', 'real'), "
        "('qwen2-vl-2b', 'real-legacy'), ('gemma3-27b', 'real')):\n"
        "    done, eng = serve(arch, 'tcm', WorkloadConfig(mix='ML', "
        "rate=50, num_requests=6, seed=0), executor_kind=kind, "
        "device='cpu')\n"
        "    assert len(done) == 6, len(done)\n"
        "    assert all(eng.executor.emitted.get(r.rid) for r in done)\n"
        "    assert eng.executor.legacy == (kind == 'real-legacy' or "
        "arch == 'gemma3-27b')\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "print('ok', eng.iterations)\n")
    # one intra-op thread, as the in-process port tests use
    # (torch_parity.py): with every core busy with the other test workers,
    # a default-width thread pool makes this ~10 s run take minutes
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")


def test_train_step_leaves_jax_unloaded():
    """The trainer and its launcher import, and a train step of a reduced
    model runs on the CPU, in a fresh process without loading JAX."""
    code = (
        "import sys, torch\n"
        "import repro_torch.train.loop as loop, repro_torch.launch.train\n"
        "from repro_torch.configs import get_reduced\n"
        "cfg = get_reduced('qwen2-vl-2b')\n"
        "st = loop.make_train_state(cfg, torch.Generator().manual_seed(0), "
        "'cpu')\n"
        "toks = torch.randint(1, cfg.vocab_size, (2, 9))\n"
        "st, m = loop.train_step(st, {'tokens': toks[:, :-1], "
        "'labels': toks[:, 1:]}, cfg)\n"
        "assert torch.isfinite(m['loss']), m\n"
        "bad = [k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'repro' or k.startswith('repro.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


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
