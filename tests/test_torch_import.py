"""The PyTorch port imports neither JAX nor the JAX package.

A subprocess imports every ``realhf_tpu_torch`` module (and
``chip_smoke.py``) with ``jax``, ``jaxlib`` and ``realhf_tpu`` made
unimportable by a ``sys.meta_path`` blocker that matches exact
top-level names (``realhf_tpu_torch`` shares the ``realhf_tpu`` prefix
and must stay importable). An AST scan finds no such import statement
anywhere in the package or the smoke script, including function-level
imports a plain import would not execute.
"""

import ast
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "realhf_tpu_torch"
BLOCKED = ("jax", "jaxlib", "realhf_tpu")

_CHILD = r"""
import importlib, importlib.abc, pkgutil, sys
BLOCKED = {blocked!r}

class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path=None, target=None):
        if fullname.split(".")[0] in BLOCKED:
            raise ImportError("blocked import of " + fullname)
        return None

sys.meta_path.insert(0, Blocker())
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
sys.path.insert(0, {repo!r})
import realhf_tpu_torch
names = ["realhf_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(realhf_tpu_torch.__path__,
                                          "realhf_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(names))
"""


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_without_jax_or_jax_package():
    code = _CHILD.format(blocked=BLOCKED, repo=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(REPO))
    assert res.returncode == 0, res.stderr[-3000:]
    assert int(res.stdout.strip().splitlines()[-1]) >= 20


def test_every_port_directory_is_a_package():
    """``walk_packages`` reaches a module only through packages: every
    directory of the port holding Python files has an ``__init__.py``, so
    the subprocess check above imports all of them."""
    dirs = {p.parent for p in PORT.rglob("*.py")}
    missing = sorted(str(d.relative_to(REPO)) for d in dirs
                     if not (d / "__init__.py").exists())
    assert not missing, missing
    assert {"agentic", "serving", "obs", "system"} <= {d.name for d in dirs}
    assert (PORT / "system" / "rollout.py").exists()


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_statement(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] not in BLOCKED, (
                f"{path.name}:{node.lineno} imports {mod}")


#: the checkpoint-IO slice's modules: each must be among the files the
#: checks above import and scan
CHECKPOINT_MODULES = (
    "base/safetensors_io.py", "base/constants.py", "base/recover.py",
    "models/hf/__init__.py", "models/hf/registry.py", "models/hf/llama.py",
    "models/hf/gemma.py", "models/hf/gpt2.py", "models/hf/mixtral.py",
    "engine/opt_checkpoint.py")


@pytest.mark.parametrize("rel", CHECKPOINT_MODULES)
def test_checkpoint_modules_are_covered(rel):
    path = PORT / rel
    assert path in _port_files()
    assert (path.parent / "__init__.py").exists()


def test_chip_smoke_defines_each_top_level_name_once():
    """A later phase's helper must not replace an earlier one's (the
    script is one module)."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = [n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    assert len(names) == len(set(names)), sorted(
        n for n in set(names) if names.count(n) > 1)
