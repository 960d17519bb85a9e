"""The port's layers import downwards only: no module of ``models``,
``optim``, ``data``, ``checkpoint``, ``kernels``, ``core`` or ``parallel``
imports ``repro_torch.launch`` (which builds their mesh placement and
hands it down), and ``parallel``, the layer below ``models``, ``optim``,
``data`` and ``checkpoint``, imports none of them. Read from each
module's source by AST, imports inside functions included."""
import ast
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"
BELOW_LAUNCH = ("models", "optim", "data", "checkpoint", "kernels", "core",
                "parallel")


def _module_name(path: Path, src: Path) -> str:
    parts = path.relative_to(src).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def imported(path: Path, src: Path = SRC) -> set[str]:
    """Every module an ``import`` or ``from ... import`` in ``path`` (a
    module under ``src``) names, relative imports resolved, and ``from
    pkg import name`` also as ``pkg.name`` (it may be a submodule)."""
    package = _module_name(path, src)
    if path.name != "__init__.py":
        package = package.rpartition(".")[0]
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                anchor = package.split(".")
                anchor = anchor[:len(anchor) - (node.level - 1)]
                base = ".".join(anchor + ([base] if base else []))
            out.add(base)
            out.update(f"{base}.{a.name}" for a in node.names)
    return out


def _within(name: str, pkg: str) -> bool:
    return name == pkg or name.startswith(pkg + ".")


MODULES = sorted(p for d in BELOW_LAUNCH for p in (PKG / d).rglob("*.py"))


def test_the_layers_below_launch_are_found():
    assert {p.relative_to(PKG).parts[0] for p in MODULES} == set(BELOW_LAUNCH)
    assert (PKG / "parallel" / "collectives.py") in MODULES
    assert (PKG / "parallel" / "placement.py") in MODULES
    assert not (PKG / "launch" / "collectives.py").exists()


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(PKG)) for p in MODULES])
def test_no_module_below_launch_imports_launch(path):
    bad = sorted(n for n in imported(path)
                 if _within(n, "repro_torch.launch"))
    assert not bad, f"{path.relative_to(SRC)} imports {bad}"


PARALLEL = sorted((PKG / "parallel").rglob("*.py"))


@pytest.mark.parametrize("path", PARALLEL,
                         ids=[p.name for p in PARALLEL])
def test_parallel_imports_no_layer_above_it(path):
    above = [f"repro_torch.{d}" for d in ("models", "optim", "data",
                                          "checkpoint", "launch")]
    bad = sorted(n for n in imported(path)
                 if any(_within(n, pkg) for pkg in above))
    assert not bad, f"{path.relative_to(SRC)} imports {bad}"


def test_the_check_sees_every_form_of_import(tmp_path):
    """The AST reading catches ``import``, ``from ... import``, a
    relative import and an import inside a function."""
    pkg = tmp_path / "repro_torch" / "models"
    pkg.mkdir(parents=True)
    probe = pkg / "probe.py"
    probe.write_text("import os\n"
                     "from ..launch import sharding\n"
                     "def f():\n"
                     "    from repro_torch import launch\n"
                     "    import repro_torch.launch.mesh\n")
    names = imported(probe, tmp_path)
    assert {"os", "repro_torch.launch", "repro_torch.launch.sharding",
            "repro_torch.launch.mesh"} <= names
