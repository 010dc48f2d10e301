"""Every torch example (examples/torch/*.py) runs end to end on the CPU with
``--device cpu`` (each asserts its own quality, as the JAX examples do),
imports nothing of jax or rls_tpu, and refuses to run where CUDA is
absent and ``--device cpu`` was not given."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).parent.parent
EXAMPLES = sorted((ROOT / "examples" / "torch").glob("[!_]*.py"))
JAX_EXAMPLES = sorted((ROOT / "examples").glob("*.py"))


def _run(path, *args, **env):
    return subprocess.run(
        [sys.executable, str(path), *args],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT), **env},
    )


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_torch_example_runs_on_the_cpu(path):
    res = _run(path, "--device", "cpu")
    assert res.returncode == 0, f"{path.name} failed:\n{res.stdout[-2000:]}\n{res.stderr[-2000:]}"


def test_one_torch_example_per_jax_example():
    stems = {p.stem for p in JAX_EXAMPLES} - {"tpu_acceleration"} | {"gpu_acceleration"}
    assert {p.stem for p in EXAMPLES} == stems


def test_torch_examples_import_neither_jax_nor_rls_tpu():
    for path in EXAMPLES + [ROOT / "examples" / "torch" / "_common.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "rls_tpu")]
            assert not bad, (path.name, bad)


def test_torch_example_refuses_to_run_without_cuda():
    res = _run(EXAMPLES[0], CUDA_VISIBLE_DEVICES="")
    assert res.returncode != 0 and "pass --device cpu" in res.stderr
