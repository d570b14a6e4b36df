"""What the benchmark's modules import, by whole top-level name: nothing
of JAX or the JAX package anywhere, and nothing of the program in the
plain references or the yardstick they use."""
import ast
import json
import subprocess
import sys

import pytest

from bench.harness import cells

BENCH = cells.BENCH
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
#: the yardstick: the references and what they import
PLAIN = ("reference",)


def imported(path):
    """Top-level names of every module ``path`` imports (a relative import
    counts as the benchmark's own)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("sub", PLAIN)
def test_references_import_nothing_of_the_program(sub):
    for path in sorted((BENCH / sub).rglob("*.py")):
        assert "repro_torch" not in imported(path), path


def test_references_load_alone():
    """Importing the references and the counts loads no program module."""
    code = ("import sys, json; sys.path.insert(0, sys.argv[1]);"
            "import bench.reference.mamba2, bench.reference.resnet,"
            "bench.harness.counts;"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code, str(cells.ROOT)],
                         capture_output=True, text=True, check=True)
    loaded = set(json.loads(out.stdout))
    assert not loaded & (FORBIDDEN | {"repro_torch"})


def test_the_top_level_name_is_compared_whole():
    assert "repro_torch" not in FORBIDDEN
    assert {"repro"} & FORBIDDEN
    from bench.harness import runner
    assert "repro" in runner.FORBIDDEN and "repro_torch" not in \
        runner.FORBIDDEN
