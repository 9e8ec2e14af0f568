"""Nothing the benchmark runs imports JAX or the JAX package: no file under
portbench/ imports a module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``tpu_cypher`` (compared whole: ``tpu_cypher_torch`` is the
program), and a run refuses to print a result where its process holds one."""

import ast
import subprocess
import sys
import types
from pathlib import Path

from portbench import harness

from conftest import REPO

BENCH = Path(harness.__file__).resolve().parent


def _imported_top_levels(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            yield node.args[0].value.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    bad = {str(f.relative_to(BENCH)): sorted(set(_imported_top_levels(f)) & set(harness.FORBIDDEN))
           for f in files}
    assert {f: b for f, b in bad.items() if b} == {}
    assert "tpu_cypher_torch" not in harness.FORBIDDEN


def test_a_run_leaves_neither_in_its_process(tmp_path):
    code = (
        "import sys, time, io; sys.path[:0] = [%r, %r]\n"
        "from conftest import make_tiny_root\n"
        "from pathlib import Path\n"
        "from portbench.harness import Bench, run, forbidden_modules\n"
        "root = make_tiny_root(Path(%r))\n"
        "rc = run(Bench(root), 'tiny.close', 5, 0.5, False, time.perf_counter(), device='cpu',"
        " out=io.StringIO(), err=io.StringIO())\n"
        "print(rc, forbidden_modules(), 'tpu_cypher_torch' in sys.modules)\n"
    ) % (str(REPO), str(Path(__file__).parent), str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "0 [] True"


def test_a_run_whose_process_holds_jax_prints_no_result(run_cpu, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, res, err = run_cpu("tiny.fof_distinct")
    assert rc == 3 and res is None and "jax" in err
