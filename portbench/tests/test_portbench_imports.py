"""The top-level import check, and the runs that must print no result."""
import os
import shutil
import subprocess
import sys

from portbench.run import ROOT, forbidden_modules


def test_forbidden_names_are_compared_whole():
    assert forbidden_modules(["jax"]) == ["jax"]
    assert forbidden_modules(["jax.numpy", "jaxlib.xla_client"]) == ["jax", "jaxlib"]
    assert forbidden_modules(["sibelia_tpu", "sibelia_tpu.cli"]) == ["sibelia_tpu"]
    assert forbidden_modules(["flax.linen"]) == ["flax"]
    assert forbidden_modules(["sibelia_tpu_torch", "sibelia_tpu_torch.cli.sibelia",
                              "jaxtyping", "numpy"]) == []


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "sibelia_loose.hpylori2", "--seed", "1", "--seconds", "1", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    p = _run(ROOT)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


def test_no_program_no_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = _run(tmp_path)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


def test_the_harness_imports_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import portbench.run, "
            "portbench.control, portbench.reference; "
            "from portbench.run import forbidden_modules; "
            "print(forbidden_modules(sys.modules))" % ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert p.stdout.strip() == "[]", p.stderr
