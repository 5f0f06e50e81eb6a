"""Nothing the benchmark runs imports JAX or the JAX package (compared by
the whole top-level name), and the reference imports nothing of the port."""
import ast
import os
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "control_gic_tpu"}


def imported_tops(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_source_imports_jax():
    for path in sources():
        assert not set(imported_tops(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_port():
    for path in sources("reference"):
        assert "control_gic_tpu_torch" not in set(imported_tops(path)), path


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from conftest import tiny_run\n"
        "from common import harness\n"
        "assert tiny_run('kodak-single')['correct']\n"
        "bad = harness.forbidden_modules()\n"
        "assert not bad, bad\n"
        "import reference.judge, reference.train\n"
        "print('ok')\n") % (os.path.join(BENCH, "tests"), BENCH)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-2000:]


def test_reference_alone_loads_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import reference.model, reference.coder, reference.train, "
            "reference.judge\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "assert not tops & {'control_gic_tpu_torch', 'control_gic_tpu',"
            " 'jax', 'jaxlib', 'flax'}, tops\n") % BENCH
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from common import harness
    monkeypatch.setitem(sys.modules, "control_gic_tpu_torch_x", sys)
    assert "control_gic_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()
