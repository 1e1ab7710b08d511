"""External-memory mode in the port (sibelia_tpu_torch/cli/sibelia.py::
_spill_dir and the native ranking arenas of native/ranking.cpp) against the
JAX package's (tests/test_spill.py holds that one).  The native library
latches SIBELIA_TPU_SPILL_DIR and SIBELIA_TPU_SPILL_MIN at first use, so
every run is a process of its own."""
import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sibelia_tpu.index.enumeration import \
    enumerate_bifurcations as jax_enumerate
from tests.test_device_e2e import REPO_ROOT, _write_fixture
from tests.test_native_engine import _rand_genomes
from tests.test_torch_cli_e2e import _tree
from tests.test_torch_multihost import _env

LINE = "Using external-memory mode (temp dir: "


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several intra-op threads a process only slow the plain versions
    down when the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case,extra,flags,spills", [
    # a host of 1 MiB: the estimated in-RAM peak does not fit
    ("small_host", {"SIBELIA_TPU_MEMAVAIL_MB": "1"}, [], True),
    ("forced", {"SIBELIA_TPU_EXTMEM": "1"}, [], True),
    # -r keeps the arenas in RAM however small the host
    ("inram", {"SIBELIA_TPU_MEMAVAIL_MB": "1"}, ["-r"], False),
])
def test_spill_dir_as_the_jax_cli(case, extra, flags, spills, tmp_path):
    """The same stderr line (a fresh directory under -t, removed at the
    end) and the same files as the JAX CLI."""
    fa, stages = _write_fixture(tmp_path)
    trees, lines = [], []
    for pkg in ("sibelia_tpu", "sibelia_tpu_torch"):
        temp = tmp_path / f"t_{pkg}"
        temp.mkdir()
        out = tmp_path / f"out_{pkg}"
        r = subprocess.run(
            [sys.executable, "-m", f"{pkg}.cli.sibelia", "-k", str(stages),
             "-m", "100", "-t", str(temp), *flags, "-o", str(out), str(fa)],
            capture_output=True, text=True, timeout=300, cwd=REPO_ROOT,
            env=_env(**extra))
        assert r.returncode == 0, r.stderr[-3000:]
        got = [ln for ln in r.stderr.splitlines() if ln.startswith(LINE)]
        assert len(got) == int(spills), r.stderr[-3000:]
        for ln in got:
            path = ln[len(LINE):-1]
            assert ln.endswith(")") and os.path.dirname(path) == str(temp)
            assert os.path.basename(path).startswith("sibelia_spill_")
        assert os.listdir(temp) == []  # the directory went with the run
        lines.append([ln.split(str(temp))[0] for ln in got])
        trees.append(_tree(out))
    assert lines[0] == lines[1]
    assert "blocks_coords.txt" in trees[0] and trees[1] == trees[0]


_ENUM = r"""
import hashlib, os, sys
import numpy as np
sys.path.insert(0, %(root)r)
from sibelia_tpu_torch.index.enumeration import enumerate_bifurcations_host
from tests.test_native_engine import _rand_genomes
enum = enumerate_bifurcations_host(_rand_genomes(7, 3, 12000), %(k)d)
h = hashlib.sha256(np.int64(enum.count).tobytes())
for s in (0, 1):
    for field in (enum.chr, enum.pos, enum.bif_id):
        h.update(np.asarray(field[s], dtype=np.int64).tobytes())
spill = os.environ.get("SIBELIA_TPU_SPILL_DIR")
with open("/proc/self/maps") as f:
    mapped = sum(1 for line in f if spill and spill in line
                 and "(deleted)" in line)
print(h.hexdigest(), mapped)
"""


def _digest(enum) -> str:
    h = hashlib.sha256(np.int64(enum.count).tobytes())
    for s in (0, 1):
        for field in (enum.chr, enum.pos, enum.bif_id):
            h.update(np.asarray(field[s], dtype=np.int64).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("k", [30, 100])
def test_host_enumeration_spilled_equals_in_ram_and_jax(k, tmp_path):
    """enumerate_bifurcations_host above 2^16 rows (the native
    enumeration) with every arena on an unlinked file in the spill
    directory: the in-RAM run's BifEnumeration and the JAX package's, and
    nothing left in the directory."""
    genomes = _rand_genomes(7, 3, 12000)
    assert 1 + 2 * sum(len(g) + 1 for g in genomes) >= 1 << 16
    runs = []
    for extra in ({}, {"SIBELIA_TPU_SPILL_DIR": str(tmp_path),
                       "SIBELIA_TPU_SPILL_MIN": "0"}):
        r = subprocess.run(
            [sys.executable, "-c", _ENUM % {"root": REPO_ROOT, "k": k}],
            capture_output=True, text=True, timeout=300, cwd=REPO_ROOT,
            env=_env(**extra))
        assert r.returncode == 0, r.stderr[-3000:]
        digest, mapped = r.stdout.split()[-2:]
        runs.append((digest, int(mapped)))
    (in_ram, none), (spilled, mapped) = runs
    assert none == 0 and mapped > 0  # the arenas were files there
    assert spilled == in_ram == _digest(jax_enumerate(genomes, k))
    assert os.listdir(tmp_path) == []
