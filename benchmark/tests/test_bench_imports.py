"""No module of the benchmark imports JAX or the JAX package, compared by
the whole top-level name (``geodesic_raytracing_tpu_torch`` is the port);
the reference imports nothing of the port either."""

import ast
import sys
import types
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "geodesic_raytracing_tpu"}
PORT = "geodesic_raytracing_tpu_torch"


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        assert not top_level_imports(path) & JAX, path


def test_the_reference_imports_nothing_of_the_port():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        assert PORT not in top_level_imports(path), path


def test_the_checks_compare_whole_top_level_names(tmp_path, monkeypatch):
    path = tmp_path / "probe.py"
    path.write_text("import geodesic_raytracing_tpu_torch.render\n"
                    "from jax import numpy\n")
    assert top_level_imports(path) == {PORT, "jax"}

    from benchmark import run

    monkeypatch.setitem(sys.modules, PORT, types.ModuleType(PORT))
    assert PORT not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "geodesic_raytracing_tpu.metrics",
                        types.ModuleType("geodesic_raytracing_tpu.metrics"))
    assert "geodesic_raytracing_tpu" in run.forbidden_modules()
