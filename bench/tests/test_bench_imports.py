"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's); the reference loads nothing of the program either."""

import ast
import pathlib
import subprocess
import sys

from bench.tests.helpers import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _top_level_imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_name_no_forbidden_package():
    for path in BENCH.rglob("*.py"):
        assert not _top_level_imports(path) & FORBIDDEN, path
    for folder in ("reference", "families"):
        for path in (BENCH / folder).rglob("*.py"):
            assert "repro_torch" not in _top_level_imports(path), path


def test_sources_read_no_earlier_benchmark():
    for path in BENCH.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        for name in ("benchmarks/", "BENCH_kernels", "chip_smoke"):
            assert name not in text, (path, name)


def _loaded_after(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted("
         "{m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}",
                       "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=600, check=True)
    return set(out.stdout.strip().splitlines()[-1].split())


def test_a_whole_run_loads_no_forbidden_module():
    loaded = _loaded_after(
        "from bench.tests.helpers import tiny_run\n"
        "r = tiny_run('nemotron4_15b', trace=True, cohorts=1)\n"
        "assert r['correct'], r['check']")
    assert "repro_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after(
        "import torch\n"
        "from bench import weights, reference\n"
        "from bench.tests.helpers import tiny_config\n"
        "for name in ('nemotron4_15b', 'rwkv6_7b'):\n"
        "    conf = tiny_config(name)\n"
        "    p = weights.make(conf, 3, 'cpu')\n"
        "    tok = torch.randint(0, conf['vocab'], (2, 10))\n"
        "    reference.logits(p, conf, tok, 6)\n"
        "    reference.logits(p, conf, tok, 6, precision='fp8')")
    assert not loaded & (FORBIDDEN | {"repro_torch"}), loaded
