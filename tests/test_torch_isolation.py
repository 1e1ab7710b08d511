"""The port never needs JAX, never hides the device, and never swallows a
failure of its re-prefilter callback."""
import os
import re
import subprocess
import sys

import pytest
import torch

import sibelia_tpu_torch.native.engine_runner as runner
from sibelia_tpu_torch.core.platform import resolve_device
from sibelia_tpu_torch.graph.sequence import MutableSequence
from sibelia_tpu_torch.index.enumeration import enumerate_bifurcations_host
from tests.test_device_e2e import REPO_ROOT, _write_fixture
from tests.test_torch_cli_e2e import write_pair_fixture
from tests.test_wave_device import _genomes

_BLOCKED_IMPORT = r"""
import importlib, os, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "sibelia_tpu")

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked for the port: " + name)
        return None

sys.meta_path.insert(0, Block())
import sibelia_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sibelia_tpu_torch.__path__,
                                               "sibelia_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(len(names))
if len(sys.argv) > 1:
    fasta, stages, ref, asm, out = sys.argv[1:]
    from sibelia_tpu_torch.cli import csibelia, sibelia
    rc = sibelia.run(["-k", stages, "-m", "100", "-o",
                      os.path.join(out, "sibelia"), fasta])
    assert rc == 0, rc
    assert os.path.getsize(os.path.join(out, "sibelia", "blocks_coords.txt"))
    rc = csibelia.run([ref, asm, "-o", os.path.join(out, "csibelia")])
    assert rc == 0, rc
    assert os.path.getsize(os.path.join(out, "csibelia", "variant.vcf"))
    # the exact aligner's device modules, forced on the CPU
    from sibelia_tpu_torch.kernels import order_device
    os.environ["SIBELIA_TPU_DEVICE_ORDER"] = "1"
    os.environ["SIBELIA_TPU_ANCHORS_DEVICE"] = "1"
    rc = csibelia.run([ref, asm, "-o", os.path.join(out, "csibelia_dev")])
    assert rc == 0, rc
    assert order_device.get_stats()["device_jobs"] > 0
    with open(os.path.join(out, "csibelia", "variant.vcf"), "rb") as h:
        host = h.read()
    with open(os.path.join(out, "csibelia_dev", "variant.vcf"), "rb") as h:
        assert h.read() == host
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
"""


def _run_blocked(args, timeout):
    env = {k: v for k, v in os.environ.items()
           if k not in ("SIBELIA_TPU_PLATFORM", "PYTHONPATH")}
    env["SIBELIA_TPU_TORCH_DEVICE"] = "cpu"
    return subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT, *args],
                          env=env, capture_output=True, text=True,
                          timeout=timeout, cwd=REPO_ROOT)


def test_every_module_imports_without_jax():
    r = _run_blocked([], 120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout) >= 42
    for module in ("align.anchors_device", "kernels.order_device"):
        assert os.path.exists(os.path.join(
            REPO_ROOT, "sibelia_tpu_torch", *module.split(".")) + ".py")


def test_both_clis_run_with_the_jax_package_blocked(tmp_path):
    fasta, stages = _write_fixture(tmp_path)
    ref, asm = write_pair_fixture(tmp_path)
    r = _run_blocked([str(fasta), str(stages), str(ref), str(asm),
                      str(tmp_path / "out")], 600)
    assert r.returncode == 0, r.stderr[-3000:]


def test_no_source_of_the_port_imports_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(sibelia_tpu|jax|jaxlib)\b",
                         re.M)
    sources = [os.path.join(REPO_ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(REPO_ROOT,
                                                  "sibelia_tpu_torch")):
        sources += [os.path.join(dirpath, f) for f in files
                    if f.endswith(".py")]
    assert len(sources) >= 40
    for path in sources:
        with open(path) as h:
            hit = pattern.search(h.read())
        assert hit is None, f"{path}: {hit.group(0).strip()}"


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("SIBELIA_TPU_DEVICE", "1")  # restored on teardown
    monkeypatch.setenv("SIBELIA_TPU_TORCH_DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device()
    monkeypatch.delenv("SIBELIA_TPU_TORCH_DEVICE")  # the default is cuda
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device()


def test_reprefilter_failure_fails_the_run(monkeypatch):
    class KernelFault(Exception):
        pass

    def failing(*args):
        raise KernelFault("reprefilter kernel failed")

    monkeypatch.setattr(runner, "device_reprefilter", failing)
    genomes = _genomes()
    seq = MutableSequence(list(genomes))
    enum = enumerate_bifurcations_host(list(genomes), 11)
    # no stage-start bitmap: the engine calls the re-prefilter at once
    with pytest.raises(KernelFault):
        runner.simplify(seq, enum, 11, 80, 4, torch.device("cpu"))


def test_wrapper_raises_on_an_unsupported_device():
    from sibelia_tpu_torch.kernels.enum_scan import enum_segment_scan
    cols = [torch.zeros(4, dtype=torch.int32, device="meta")] * 4
    with pytest.raises(ValueError, match="unsupported device"):
        enum_segment_scan(*cols, 4, 4)
