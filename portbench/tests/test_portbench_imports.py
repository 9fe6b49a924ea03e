"""Nothing under ``portbench/`` imports JAX or the JAX package (whole
top-level names: ``repro_torch`` is the port, ``repro`` the JAX package),
the reference imports nothing of the port, and nothing reads the JAX
package's benchmarks."""

from __future__ import annotations

import ast

from portbench.tests.tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    return sorted(ROOT.rglob("*.py"))


def test_no_jax_anywhere():
    found = {str(p.relative_to(ROOT)): sorted(set(_imports(p)) & FORBIDDEN)
             for p in _sources()}
    assert not {k: v for k, v in found.items() if v}


def test_reference_imports_nothing_of_the_port():
    for path in (ROOT / "reference").rglob("*.py"):
        assert "repro_torch" not in set(_imports(path)), path


def test_nothing_reads_the_jax_benchmarks():
    for path in _sources():
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "BENCH_" not in text and "benchmarks/" not in text, path


def test_the_check_tells_whole_names():
    from portbench.tests import test_portbench_imports as me

    assert "repro_torch".split(".")[0] not in me.FORBIDDEN
