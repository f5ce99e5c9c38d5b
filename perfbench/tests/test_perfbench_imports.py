"""Nothing under perfbench/ imports JAX or the JAX package, comparing each
module's top-level name whole (the port's name begins with the JAX
package's), and the reference imports nothing of the program."""

import ast
import subprocess
import sys

import pytest

FORBIDDEN = {"jax", "jaxlib", "flax", "eigenexa_tpu"}


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax(root):
    files = sorted((root / "perfbench").rglob("*.py"))
    assert len(files) > 10
    for path in files:
        tops = {name.split(".")[0] for name in imported(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program(root):
    tops = {n.split(".")[0]
            for n in imported(root / "perfbench" / "reference.py")}
    assert tops <= {"__future__", "torch", "numpy", "math"}


def test_a_run_loads_neither(root):
    """A CPU run of a cell in a fresh process loads no forbidden module."""
    code = (
        "import sys, time, torch; sys.path.insert(0, %r)\n"
        "from perfbench import harness\n"
        "spec = harness.load_cell('eigen_s-f64-n8192.A-random', "
        "harness.Path(%r)); spec['config']['n'] = 40\n"
        "harness.run_cell(spec, 1, 0.01, False, torch.device('cpu'), "
        "time.perf_counter())\n"
        "print(harness.forbidden_modules())\n") % (str(root), str(root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("names,found", [
    (["jax", "torch"], ["jax"]), (["jax.numpy"], ["jax"]),
    (["jaxlib.xla_client", "flax.linen"], ["flax", "jaxlib"]),
    (["eigenexa_tpu.ops.householder"], ["eigenexa_tpu"]),
    (["eigenexa_tpu_torch", "eigenexa_tpu_torch.ops.kernels",
      "eigenexa_tpux", "jaxtyping"], [])])
def test_top_level_names_compared_whole(names, found):
    from perfbench import harness

    assert harness.forbidden_modules(names) == found
