"""What the benchmark may load: never JAX or the JAX package, and in the
reference nothing of the program."""

import ast
import subprocess
import sys
import textwrap

import pytest

from conftest import CELLS, ROOT

JAX_PACKAGE = "rectified_flow_vision_tpu"
PORT = "rectified_flow_vision_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    files = sorted((ROOT / "rfbench" / "reference").glob("*.py"))
    assert files
    for f in files:
        tops = {name.split(".")[0] for name in _imports(f)}
        assert not tops & {PORT, JAX_PACKAGE, "jax", "jaxlib", "flax"}, f


def test_reference_loads_without_the_program():
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(ROOT)!r})
        import rfbench.reference.flow, rfbench.roofline, rfbench.weights
        print(sorted({{m.split('.')[0] for m in sys.modules}} & {{{PORT!r}, {JAX_PACKAGE!r}, 'jax'}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("cell", CELLS)
def test_a_cpu_rehearsal_loads_no_jax(cell):
    """Set-up, window, trace and check of a tiny version of the cell on the
    CPU, then the top-level names in ``sys.modules``, compared whole (the
    port's name begins with the JAX package's)."""
    code = textwrap.dedent(f"""
        import sys, time
        sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / "rfbench" / "tests")!r}]
        import torch
        torch.set_num_threads(2)
        from conftest import tiny
        from rfbench import run
        res = run.run_cell(tiny({cell!r}), 2**33 + 3, 1.0, True, torch.device("cpu"),
                           time.perf_counter())
        assert res["attempted"] > 0, res
        print(run.forbidden_modules(), {PORT!r} in sys.modules)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"
