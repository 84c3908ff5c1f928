"""Nothing the benchmark loads is JAX or the JAX package, and the
reference loads nothing of the program. Top-level module names (before
the first dot) are compared whole: `semantic_meshes_torch` is not
`semantic_meshes`."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run

HERE = Path(__file__).resolve().parents[1]  # benchmark/
ROOT = HERE.parent
JAX = {"jax", "jaxlib", "flax", "semantic_meshes"}


def imports_of(path):
    """Absolute module names a file imports (relative ones resolved)."""
    rel = path.relative_to(ROOT).with_suffix("")
    package = list(rel.parts[:-1]) if rel.name != "__init__" else list(
        rel.parts[:-1])
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package[:len(package) - node.level + 1]
                mod = ".".join(base + ([node.module] if node.module else []))
                out.add(mod)
                out.update(f"{mod}.{a.name}" for a in node.names)
            else:
                out.add(node.module)
    return out


def module_file(name):
    p = ROOT.joinpath(*name.split("."))
    for cand in (p.with_suffix(".py"), p / "__init__.py"):
        if cand.is_file():
            return cand
    return None


def closure(start_files):
    """Every module name imported from the files, following the files of
    benchmark/ that they import."""
    seen, names, todo = set(), set(), list(start_files)
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        for name in imports_of(f):
            names.add(name)
            if name.split(".")[0] == "benchmark":
                g = module_file(name)
                if g is not None:
                    todo.append(g)
    return names


def tops(names):
    return {n.split(".")[0] for n in names}


def test_no_file_of_the_benchmark_imports_jax():
    files = sorted(HERE.rglob("*.py"))
    assert HERE / "run.py" in files
    assert not tops(closure(files)) & JAX


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((HERE / "reference").rglob("*.py"))
    found = tops(closure(files))
    assert "semantic_meshes_torch" not in found and not found & JAX
    assert found <= {"benchmark", "torch", "json", "math", "pathlib",
                     "typing", "__future__", "numpy"}


def test_forbidden_names_compare_whole():
    saved = dict(sys.modules)
    try:
        sys.modules["semantic_meshes_torch_probe"] = object()
        sys.modules["jaxlibx"] = object()
        assert run.forbidden_modules() == sorted(
            tops(saved) & set(run.FORBIDDEN))
        sys.modules["flax.core"] = object()
        assert "flax" in run.forbidden_modules()
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]


def test_a_run_loads_no_jax_module():
    """The whole harness, driven on the CPU at a small size, in a process
    of its own: no module of JAX or the JAX package is loaded."""
    code = (
        "import sys, json\n"
        "from benchmark import harness, run\n"
        "res, _ = harness.run_cell('scannet-eval.triangles', 3, 0.2, False,"
        " device='cpu', config_overrides=dict(width=64, height=48, "
        "classes=3, subdivisions=4, frames=8, pool_frames=4, "
        "intrinsics=dict(focal=[43.2, 43.2], principal=[32.0, 24.0])), "
        "traffic_overrides=dict(check_batches=1, warmup_batches=1))\n"
        "print(json.dumps([res['correct'], run.forbidden_modules()]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[true, []]"


@pytest.mark.parametrize("only_paths", [False, True])
def test_the_command_fails_without_a_card_or_the_program(tmp_path,
                                                         only_paths):
    """No card here: the command exits non-zero and prints no result;
    the same in a directory that holds only BENCHMARK.json and the
    benchmark's files."""
    cwd = ROOT
    if only_paths:
        import shutil
        shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
        shutil.copytree(HERE, tmp_path / "benchmark",
                        ignore=shutil.ignore_patterns("__pycache__"))
        cwd = tmp_path
    cmd = [sys.executable, "-m", "benchmark.run", "--workload",
           "scannet-eval.triangles", "--seed", str(2**31 + 5),
           "--seconds", "1", "--trace", "0"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
