"""What the benchmark's process loads: never the JAX stack or the JAX
package (top-level names compared whole, so the port's package passes),
and the reference never the program."""

import ast
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "aloception_tpu"}

PROBE = """
import sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from conftest import tiny
from portbench import harness
bench = harness.read_json(harness.HERE.parent / "BENCHMARK.json")
for w in ("deformable-train-b8", "detr-serve-b32", "deformable-serve-b16"):
    for trace in (False, True):
        cell = harness.Cell(bench, w)
        harness.run_cell(cell, 3, 0.2, trace, "cpu", harness.now(), tiny(w))
for m in ("control", "faults"):
    __import__("portbench." + m)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_a_run_loads_no_jax():
    res = subprocess.run([sys.executable, "-c", PROBE.format(
        root=str(ROOT), tests=str(ROOT / "portbench" / "tests"))],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    loaded = set(eval(res.stdout.strip().splitlines()[-1]))
    assert "aloception_tpu_torch" in loaded and "torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_no_program():
    probe = ("import sys, pkgutil, importlib\n"
             f"sys.path.insert(0, {str(ROOT)!r})\n"
             "import portbench.reference as r\n"
             "import portbench.reference.models as m\n"
             "for pkg in (r, m):\n"
             "    for i in pkgutil.iter_modules(pkg.__path__):\n"
             "        importlib.import_module(pkg.__name__ + '.' + i.name)\n"
             "print(sorted({k.split('.')[0] for k in sys.modules}))\n")
    res = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    loaded = set(eval(res.stdout.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {"aloception_tpu_torch"})


def test_the_reference_names_no_program():
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {
                    "aloception_tpu_torch"}, (path, n)
