"""Nothing the benchmark runs imports JAX or the JAX package, and its
reference imports nothing of the program (top-level names compared whole:
the port's name begins with the JAX package's)."""

import ast

from benchmark import harness
from conftest import BENCH

JAX = {"jax", "jaxlib", "flax", "autonomous_racing_lpv_mpp_mpc_tpu"}
PORT = "autonomous_racing_lpv_mpp_mpc_tpu_torch"


def imported(path):
    """Top-level names of every import in a file, with the modules named
    in ``importlib.import_module`` calls whose argument is a plain string."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_no_module_imports_jax():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    bad = {str(p.relative_to(BENCH)): imported(p) & JAX for p in files if imported(p) & JAX}
    assert not bad


def test_reference_imports_nothing_of_the_program():
    for p in sorted((BENCH / "reference").rglob("*.py")):
        assert PORT not in imported(p), p
        assert PORT not in p.read_text(), p


def test_the_run_guard_compares_whole_names():
    port = [PORT, PORT + ".ops.megastep_kernel", "torch", "benchmark.harness"]
    assert harness.forbidden_modules(port) == []
    assert harness.forbidden_modules(port + ["jax.numpy", "flax"]) == ["flax", "jax"]
    assert harness.forbidden_modules(["autonomous_racing_lpv_mpp_mpc_tpu.ops"]) == [
        "autonomous_racing_lpv_mpp_mpc_tpu"]
