"""Nothing under bench/ imports JAX or the JAX package (top-level module
names compared whole: ``repro_torch`` is not ``repro``), the plain
references import nothing of the program, and nothing reads the JAX
package's benchmarks."""
import ast
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(BENCH.rglob("*.py"))


def _roots(path: Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            roots.add(node.args[0].value.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_reference_package(path):
    assert not _roots(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert not _roots(path) & {"repro_torch", "chip_smoke"}


def test_nothing_reads_the_jax_benchmarks():
    for path in FILES:
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "benchmarks/" not in text and "BENCH_" not in text, path


def test_a_run_loads_no_jax(monkeypatch):
    """The harness's modules, the program's training path and the
    references load, and no forbidden module with them (a fresh
    interpreter, so that nothing this test process holds counts)."""
    import subprocess

    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from bench import harness, control, run, spec\n"
            "import repro_torch.launch.train, repro_torch.models.transformer\n"
            "from bench.reference import gpt, mamba\n"
            "print(run.loaded_forbidden())" % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
