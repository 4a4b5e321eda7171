"""What the benchmark loads: nothing of JAX or of the JAX package anywhere
under benchmark/ (top-level module names compared whole, since
openvivqa_tpu_torch begins with openvivqa_tpu), nothing of the port in the
references, and a run that refuses to measure without a card."""

import ast
import json
import os
import shutil
import subprocess
import sys

import portbench_small as small
import pytest

FORBIDDEN = {"jax", "jaxlib", "flax", "openvivqa_tpu"}


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(small.BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(small.BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((small.BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    assert "openvivqa_tpu_torch" not in imported(path)
    assert "portbench" not in imported(path)


def test_a_cpu_run_loads_no_jax():
    code = (
        "import portbench_small as small, sys; small.run('mmf_m4c.train_xe'); "
        "from portbench import env; print(env.forbidden_modules())"
    )
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=small.BENCH / "tests", timeout=600)
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.strip().splitlines()[-1] == "[]"


def _no_card_env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


def test_run_refuses_to_measure_without_a_card():
    done = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "mmf_m4c.train_xe",
                           "--seed", str(small.SEED), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=small.ROOT, env=_no_card_env(),
                          timeout=300)
    assert done.returncode != 0
    assert "no CUDA device" in done.stderr
    assert not any(line.startswith("{") for line in done.stdout.splitlines())


def test_run_fails_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(small.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(small.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "mmf_m4c.eval_greedy",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=tmp_path, env=_no_card_env(),
                          timeout=300)
    assert done.returncode != 0
    assert not any(line.startswith("{") for line in done.stdout.splitlines())
    json.loads((tmp_path / "BENCHMARK.json").read_text())
