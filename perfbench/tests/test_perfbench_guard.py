"""No run loads JAX or the JAX package, the reference imports nothing of
the program, and the benchmark names no fixed path outside its checkout."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "xlstm_hved_tpu"}


def imported(path: Path):
    """Top-level names of every module a source file imports."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources(sub=""):
    return [p for p in (BENCH / sub).rglob("*.py") if "tests" not in p.parts]


def test_no_source_imports_jax():
    for path in sources():
        assert not set(imported(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        names = set(imported(path))
        assert "xlstm_hved_torch" not in names and not names & FORBIDDEN, path


def test_no_fixed_paths_outside_the_checkout():
    fixed = ("/dev/" + "shm", "/" + "tmp")
    for path in sources() + list(BENCH.rglob("*.json")):
        text = path.read_text()
        assert not any(f in text for f in fixed), path


def test_a_run_loads_no_jax_module():
    """The modules a run imports (the harness, every driver and reader, the
    program's entry points) leave no forbidden top-level name in
    sys.modules; the harness's own guard reads them the same way."""
    script = (
        "import sys; sys.path.insert(0, %r)\n"
        "import importlib, pkgutil\n"
        "from perfbench import harness\n"
        "import perfbench.drivers, perfbench.layer_metrics\n"
        "for pkg in (perfbench.drivers, perfbench.layer_metrics):\n"
        "    for m in pkgutil.iter_modules(pkg.__path__):\n"
        "        importlib.import_module(pkg.__name__ + '.' + m.name)\n"
        "import xlstm_hved_torch.engine.train, xlstm_hved_torch.engine.evaluate\n"
        "import xlstm_hved_torch.models.hved\n"
        "print(harness.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_guard_names_a_loaded_forbidden_module(monkeypatch):
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    monkeypatch.setitem(sys.modules, "flax.linen", object())
    assert harness.forbidden_modules() == ["flax"]


def test_run_fails_without_a_card():
    """No CUDA device: a non-zero exit and no result line."""
    script = ("import sys, torch; torch.cuda.is_available = lambda: False; "
              "sys.argv = ['run.py', '--workload', 'xlstm_hved.train_step', '--seed', '1', "
              "'--seconds', '1']; sys.path.insert(0, %r); import runpy; "
              "runpy.run_path(%r, run_name='__main__')" % (str(BENCH), str(BENCH / "run.py")))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
