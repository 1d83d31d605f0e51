"""Each subpackage of the port exports what the reference's exports.

The reference's `__init__` is read as source (the names it binds at module
level, or its `__all__`), so no JAX module is imported here; the port's is
imported and must have every one of those names."""

import ast
import importlib
import pathlib

import pytest

REFERENCE = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro"
SUBPACKAGES = sorted(p.parent.name for p in REFERENCE.glob("*/__init__.py"))
# the TPU substrates of the reference's kernels/backend, which the port's
# backend replaces by its CUDA kernels and their plain versions
TPU_ONLY: dict[str, set[str]] = {
    "kernels": {"Substrate", "PALLAS", "PALLAS_CPU", "XLA", "INTERPRET",
                "for_impl", "resolve"},
}


def reference_exports(package: str) -> set[str]:
    tree = ast.parse((REFERENCE / package / "__init__.py").read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            return set(ast.literal_eval(node.value))
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
    return {n for n in names if not n.startswith("_")}


def test_every_subpackage_is_checked():
    assert len(SUBPACKAGES) >= 15 and "serve" in SUBPACKAGES


@pytest.mark.parametrize("package", SUBPACKAGES)
def test_port_exports_the_reference_names(package):
    port = importlib.import_module(f"repro_torch.{package}")
    want = reference_exports(package) - TPU_ONLY.get(package, set())
    missing = sorted(n for n in want if not hasattr(port, n))
    assert not missing, f"repro_torch.{package} lacks {missing}"
