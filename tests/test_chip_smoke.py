"""chip_smoke.py refuses to run without a GPU, and the library reaches no
accelerator backend but the GPU's."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_smoke_refuses_without_gpu(where, tmp_path):
    """On the CPU, and in a directory holding only the script, the smoke
    exits non-zero and prints no result line."""
    cwd = REPO
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path)
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    run = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert run.returncode != 0
    assert '"ok"' not in run.stdout


def test_library_reaches_only_cpu_and_gpu_backends():
    """No module imports a Pallas backend other than the GPU ones, or
    compares a platform name with anything but "cpu" or "gpu"."""
    allowed = {"cpu", "gpu"}
    pallas_gpu = {"triton", "mosaic_gpu"}
    hits = []
    for path in sorted((REPO / "sirius_tpu").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module] + [f"{node.module}.{a.name}" for a in node.names]
            for name in names:
                parts = name.split(".")
                if parts[:3] == ["jax", "experimental", "pallas"] and len(parts) > 3 \
                        and parts[3] not in pallas_gpu:
                    hits.append(f"{path.relative_to(REPO)}:{node.lineno} imports {name}")
            if isinstance(node, ast.Compare):
                for side in [node.left, *node.comparators]:
                    if isinstance(side, ast.Constant) and isinstance(side.value, str) \
                            and "backend" in ast.unparse(node) and side.value not in allowed:
                        hits.append(f"{path.relative_to(REPO)}:{node.lineno} {ast.unparse(node)}")
    assert hits == []
