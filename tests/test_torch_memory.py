"""Memory of the port: the Sibelia CLI's host setup (the glibc settings,
the arena slab's size and its reservation, the ranking library in the
global scope, no hugetlb pool write), the size rule of the single-card
enumeration (index/enumeration.py::fits_on_card) and the teardown of the
process group that parallel/runtime.py::init_distributed starts."""
import builtins
import ctypes
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from sibelia_tpu.index.enumeration import \
    enumerate_bifurcations as jax_enumerate
from sibelia_tpu_torch import native
from sibelia_tpu_torch.cli import sibelia as cli
from sibelia_tpu_torch.index import enumeration as port_enum
from tests.test_device_e2e import REPO_ROOT, _write_fixture
from tests.test_native_engine import _rand_genomes
from tests.test_torch_cli_e2e import _tree
from tests.test_torch_multihost import _env, _free_port

GIB = 1 << 30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several intra-op threads a process only slow the plain versions
    down when the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_slab(total, n_chr):
    """sibelia_tpu/cli/sibelia.py's slab size."""
    est_n = 2 * (total + n_chr + 1) + 128
    return est_n * 95 + (64 << 20)


@pytest.mark.parametrize("total,n_chr", [(8_000_000, 4), (64_000_000, 32),
                                         (300_000_000, 150)])
def test_slab_on_the_host_route_is_the_jax_size_below_the_clamp(total,
                                                                 n_chr):
    want = _jax_slab(total, n_chr)
    assert want >= GIB
    assert cli.slab_bytes(total, n_chr, True, None) == want
    assert cli.slab_bytes(total, n_chr, True, want * 4 // 3 + 4) == want


def test_slab_on_the_card_route_is_what_the_engines_carve():
    """Every stage's engine carves its sequence arrays anew, 5 B a base:
    the slab holds that much, and nothing under 1 GiB."""
    total, n_chr, stages = 64_000_000, 32, 4
    assert cli.slab_bytes(total, n_chr, False, None, stages) == \
        stages * cli.ENGINE_BYTES_A_BASE * total
    # 4 x 2 Mbp carve about 160 MB that way: no slab
    assert cli.slab_bytes(8_000_000, 4, False, None, stages) == 0
    # far below the bound of one instance a row, 17 B a node slot
    rows = 2 * (total + n_chr + 1) + 128
    assert cli.slab_bytes(total, n_chr, False, None, 1) < \
        17 * (rows + rows // 8)


@pytest.mark.parametrize("host_route", [False, True])
def test_slab_clamp_is_shared_by_the_processes(host_route):
    """N processes of one run may share the host: each takes 1/N of the
    budget."""
    total, avail = 512 << 20, 8 << 30
    one = cli.slab_bytes(total, 1, host_route, avail, 4, 1)
    assert one == avail * 3 // 4
    assert cli.slab_bytes(total, 1, host_route, avail, 4, 2) == one // 2
    # under 1 GiB a process: none
    assert cli.slab_bytes(total, 1, host_route, avail, 4, 16) == 0


@pytest.mark.parametrize("host_route", [False, True])
def test_no_slab_below_one_gib(host_route):
    assert cli.slab_bytes(2_000_000, 2, host_route, None, 4) == 0
    assert cli.slab_bytes(0, 0, host_route, None, 4) == 0
    # a clamp under 1 GiB leaves nothing either
    assert cli.slab_bytes(300_000_000, 150, host_route, GIB, 4) == 0


def test_slab_clamped_to_three_quarters_of_mem_available():
    """ADVICE.md's example: 512 MB of input on a host with 85 GB
    available; the JAX CLI would populate about 97 GB."""
    total, avail = 512 << 20, 85 << 30
    assert _jax_slab(total, 1) > avail
    got = cli.slab_bytes(total, 1, True, avail, 4)
    assert got == avail * 3 // 4
    assert cli.slab_bytes(total, 1, False, avail, 4) <= avail * 3 // 4


def test_mem_available_reads_the_override(monkeypatch):
    monkeypatch.setenv("SIBELIA_TPU_MEMAVAIL_MB", "300")
    assert cli.mem_available() == 300 << 20
    monkeypatch.delenv("SIBELIA_TPU_MEMAVAIL_MB")
    assert cli.mem_available() > 0


_GLOBAL_SCOPE = r"""
import ctypes, sys
sys.path.insert(0, %(root)r)
from sibelia_tpu import native as jax_native
from sibelia_tpu_torch import native
scope = ctypes.CDLL(None)
assert jax_native.load_ranking() is not None  # loaded RTLD_LOCAL
assert not hasattr(scope, "rank_slab_alloc")
assert native.load_ranking() is not None
assert scope.rank_slab_alloc
print("ok")
"""


def test_rank_slab_alloc_is_in_the_global_scope():
    """The engine finds the slab by dlsym(RTLD_DEFAULT, "rank_slab_alloc"):
    the port's ranking library puts it there, the JAX package's RTLD_LOCAL
    load does not."""
    r = subprocess.run([sys.executable, "-c",
                        _GLOBAL_SCOPE % {"root": REPO_ROOT}],
                       capture_output=True, text=True, timeout=300,
                       cwd=REPO_ROOT, env=_env())
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


def _defined_symbols(lib) -> set[str]:
    out = subprocess.run(["nm", "-D", "--defined-only", lib._name],
                         capture_output=True, text=True, check=True).stdout
    return {line.split()[-1] for line in out.splitlines() if line.strip()}


def test_ranking_library_exports_its_c_api_alone():
    """Loaded RTLD_GLOBAL, every name the ranking library defines would
    take the place of the engine's or the LAGAN library's own."""
    ranking = _defined_symbols(native.load_ranking())
    assert {"rank_slab_alloc", "rank_slab_reserve", "enum_run",
            "kmer_ranks_native"} <= ranking
    assert all(not name.startswith("_Z") for name in ranking), ranking
    for other in (native.load(), native.load_lagan()):
        assert not ranking & _defined_symbols(other)


_SLAB_RUN = r"""
import sys
sys.path.insert(0, %(root)r)
from sibelia_tpu_torch import native
from sibelia_tpu_torch.cli.sibelia import run
native.slab_reserve(256 << 20)
cap, used = native.slab_stats()
assert cap == 256 << 20 and used == 0, (cap, used)
assert run(["-k", %(stages)r, "-m", "100", "-o", %(out)r, %(fa)r]) == 0
cap, used = native.slab_stats()
print(cap, used)
"""


def test_the_engine_carves_from_the_slab(tmp_path, monkeypatch):
    """With a slab mapped before the run, the engine's node and sequence
    arrays come from it, and the files are those of a run without one."""
    monkeypatch.setenv("SIBELIA_TPU_TORCH_DEVICE", "cpu")
    fa, stages = _write_fixture(tmp_path)
    r = subprocess.run(
        [sys.executable, "-c", _SLAB_RUN % {
            "root": REPO_ROOT, "stages": str(stages),
            "out": str(tmp_path / "slab"), "fa": str(fa)}],
        capture_output=True, text=True, timeout=300, cwd=REPO_ROOT,
        env=_env())
    assert r.returncode == 0, r.stderr[-3000:]
    cap, used = map(int, r.stdout.split()[-2:])
    assert cap == 256 << 20 and 0 < used <= cap
    # at least every stage's sequence arrays: what the card route reserves
    total = sum(len(line.strip()) for line in open(fa)
                if not line.startswith(">"))
    n_stages = int(stages.read_text().split()[0])
    assert used >= n_stages * cli.ENGINE_BYTES_A_BASE * total
    assert cli.run(["-k", str(stages), "-m", "100", "-o",
                    str(tmp_path / "plain"), str(fa)]) == 0
    assert _tree(tmp_path / "slab") == _tree(tmp_path / "plain")


class _Libc:
    def __init__(self):
        self.calls = []

    def mallopt(self, param, value):
        self.calls.append((param, value))


@pytest.mark.parametrize("spill", [False, True])
def test_cli_memory_setup(spill, tmp_path, monkeypatch):
    """In RAM the CLI sets the JAX CLI's mallopt values and reserves the
    slab its sizing gives; it never opens /proc/sys/vm/nr_hugepages; with
    a spill directory it does neither."""
    fa, stages = _write_fixture(tmp_path)
    libc, reserved, opened = _Libc(), [], []
    real_open, real_cdll = builtins.open, ctypes.CDLL

    def spy_open(file, *args, **kwargs):
        opened.append(str(file))
        return real_open(file, *args, **kwargs)

    monkeypatch.setattr(builtins, "open", spy_open)
    monkeypatch.setattr(cli.ctypes, "CDLL", lambda name=None, *a, **k:
                        libc if name is None else real_cdll(name, *a, **k))
    # a slab of 1 GiB is asked for, and recorded instead of mapped
    monkeypatch.setattr(cli, "slab_bytes", lambda *args: GIB)
    monkeypatch.setattr(cli.native, "slab_reserve", reserved.append)
    monkeypatch.setenv("SIBELIA_TPU_TORCH_DEVICE", "cpu")
    if spill:
        monkeypatch.setenv("SIBELIA_TPU_SPILL_DIR", str(tmp_path))
    assert cli.run(["-k", str(stages), "-m", "100", "-o",
                    str(tmp_path / "out"), str(fa)]) == 0
    assert not any("nr_hugepages" in path for path in opened)
    if spill:
        assert libc.calls == [] and reserved == []
    else:
        assert libc.calls == [(-4, 0), (-1, 0x7FFFFFFF)]
        assert reserved == [GIB]


def _genomes():
    return _rand_genomes(5, 3, 30_000)


@pytest.mark.parametrize("k", [30, 100])
def test_size_rule_at_its_extremes(k):
    top = (1 << 30) - 1
    assert port_enum.fits_on_card(0, k, port_enum.CARD_BYTES_FIXED)
    assert not port_enum.fits_on_card(1, k, port_enum.CARD_BYTES_FIXED)
    assert not port_enum.fits_on_card(top, k, 80 * 10**9)
    assert port_enum.fits_on_card(top, k, 10**12)
    assert not port_enum.fits_on_card(1000, k, 0)
    rows = 100_000_000
    assert port_enum.fits_on_card(
        rows, k, port_enum.card_peak_bytes(rows, k))
    assert not port_enum.fits_on_card(
        rows, k, port_enum.card_peak_bytes(rows, k) - 1)
    # prefix doubling peaks lower a row than the prefilter's class
    assert port_enum.card_peak_bytes(rows, 100) < \
        port_enum.card_peak_bytes(rows, 30)


def test_host_route_names_why():
    cpu = torch.device("cpu")
    assert port_enum.host_route(1000, 30, cpu) is None
    assert "int32" in port_enum.host_route(1 << 30, 100, cpu)
    assert port_enum.supergenome_rows(10, 2) == \
        port_enum.build_supergenome([b"ACGTA", b"CCGTA"])[0].shape[0]


@pytest.mark.parametrize("k,min_branch", [(30, 150), (100, None)])
def test_both_routes_of_the_rule_equal_jax(k, min_branch, monkeypatch):
    """With what the card can give set to the rule's fitted peak, the
    device route runs; one byte less sends the call to the host
    enumeration (with a RuntimeWarning); both give the JAX package's
    BifEnumeration."""
    genomes = _genomes()
    cpu = torch.device("cpu")
    n = port_enum.supergenome_rows(sum(map(len, genomes)), len(genomes))
    got = {}
    for route, room in (("device", 0), ("host", -1)):
        monkeypatch.setattr(port_enum, "card_free_bytes", lambda device:
                            port_enum.card_peak_bytes(n, k) + room)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got[route] = port_enum.enumerate_bifurcations(
                genomes, k, min_branch, cpu)
        assert [str(w.message) for w in caught
                if issubclass(w.category, RuntimeWarning)
                and "falling back to the host" in str(w.message)] == (
            [] if route == "device" else [
                f"supergenome of {n} rows needs about "
                f"{port_enum.card_peak_bytes(n, k) >> 20} MiB on the device "
                f"at k = {k}, more than its {(port_enum.card_peak_bytes(n, k) - 1) >> 20}"
                " MiB; falling back to the host enumeration"])
    want = jax_enumerate(genomes, k)
    for res in got.values():
        assert res.count == want.count
        for s in (0, 1):
            for field in ("chr", "pos", "bif_id"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(res, field)[s], dtype=np.int64),
                    np.asarray(getattr(want, field)[s], dtype=np.int64))
    assert got["host"].candidates is None
    assert (got["device"].candidates is not None) == (min_branch is not None)


_EXIT_CHILD = r"""
import sys
sys.path.insert(0, %(root)r)
import torch, torch.distributed as dist
from sibelia_tpu_torch.parallel.runtime import init_distributed
assert init_distributed()
x = torch.tensor([dist.get_rank() + 1])
dist.all_reduce(x)
assert x.item() == 3
"""

_CLI_CHILD = r"""
import atexit, sys
sys.path.insert(0, %(root)r)
import torch.distributed as dist
destroyed = []
real = dist.destroy_process_group
def counted(*args, **kwargs):
    destroyed.append(1)
    return real(*args, **kwargs)
dist.destroy_process_group = counted
# runs after the teardown init_distributed registers (atexit is LIFO)
atexit.register(lambda: print("destroyed", len(destroyed), flush=True))
from sibelia_tpu_torch.cli.sibelia import run
assert run(["-k", %(stages)r, "-m", "100", "-o", %(out)r, %(fa)r]) == 0
"""


def _pair(code: str) -> list[tuple[int, str, str]]:
    """Run `code` in two processes of one gloo group; (returncode, stdout,
    stderr) of each."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], cwd=REPO_ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=_env(SIBELIA_TPU_COORD=f"127.0.0.1:{port}",
                 SIBELIA_TPU_NPROCS="2", SIBELIA_TPU_PROC_ID=str(rank)))
        for rank in range(2)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return results


@pytest.mark.parametrize("run", range(3))
def test_a_group_left_up_is_torn_down_at_exit(run):
    """Two gloo processes that exit with the group init_distributed
    started still up: both exit 0, neither aborts in the group's
    threads."""
    for rc, _, err in _pair(_EXIT_CHILD % {"root": REPO_ROOT}):
        assert rc == 0 and "terminate called" not in err, err[-2000:]


def test_a_group_the_cli_destroyed_is_destroyed_once(tmp_path):
    fa, stages = _write_fixture(tmp_path)
    results = _pair(_CLI_CHILD % {"root": REPO_ROOT, "stages": str(stages),
                                  "out": str(tmp_path / "out"),
                                  "fa": str(fa)})
    for rc, out, err in results:
        assert rc == 0 and "terminate called" not in err, err[-2000:]
        assert out.strip().splitlines()[-1] == "destroyed 1"
