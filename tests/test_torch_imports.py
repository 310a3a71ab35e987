"""The port stands alone: no file of `src/repro_torch/`, and not
`chip_smoke.py`, imports jax, jaxlib, the JAX package `repro` or msgpack
(the checkpoint files are read and written by `checkpoint/wire.py`)."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_imports_without_jax():
    """Importing every module of the port loads no jax."""
    mods = sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"mods = {mods!r}\n"
            "for m in mods: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n"
            "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(mods) >= 20


def test_chip_smoke_alone_fails_without_a_result(tmp_path):
    """`chip_smoke.py` in a directory with nothing else of the repository
    (or on a machine without a card) exits non-zero and prints no result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _code_strings(path):
    """The string constants of a file that are not docstrings."""
    tree = ast.parse(path.read_text(), str(path))
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant):
                docs.add(id(first.value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_command_the_port_builds_names_the_jax_package(path):
    """No string the port's code holds (a subprocess command, a module
    name) names a module of the JAX package: `repro.` followed by a name,
    as `python -m repro.launch.multihost` would."""
    import re
    bad = [s for s in _code_strings(path)
           if re.search(r"(?<![\w/])repro\.[a-z_]", s)
           or re.search(r"\bjax\b", s) and "import" in s]
    assert not bad, f"{path.relative_to(ROOT)}: {bad}"


def test_spawned_ranks_run_the_port():
    """`multihost.spawn_workers` starts the port's module, never the JAX
    package's."""
    from repro_torch.launch import multihost
    argv = multihost.worker_argv(["--mode", "sync"])
    assert argv[1:3] == ["-m", "repro_torch.launch.multihost"]
    assert multihost.WORKER_MODULE.startswith("repro_torch.")
