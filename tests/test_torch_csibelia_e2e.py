"""Port vs JAX, end to end: ``python -m sibelia_tpu_torch.cli.csibelia`` on
the CPU against ``python -m sibelia_tpu.cli.csibelia`` on a 20 kb
reference / assembly pair with planted SNPs and indels.

In fast mode with device gap batching the port closes its gap batches
with the plain version of the Gotoh kernel, the JAX package with the
Pallas kernel in interpret mode; in the default mode both run the exact
LAGAN engine, in the native library or, with the device switches, through
their device modules on the CPU.  VCF and MAF byte-identical."""
import json
import os
import subprocess
import sys

import pytest

from tests.test_device_e2e import REPO_ROOT
from tests.test_torch_cli_e2e import write_pair_fixture

FAST = {"SIBELIA_TPU_ALIGNER": "fast", "SIBELIA_TPU_DEVICE_ALIGN": "1"}


def _run(module, ref, asm, outdir, env_extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               SIBELIA_TPU_TORCH_DEVICE="cpu", **env_extra)
    return subprocess.run(
        [sys.executable, "-m", module, str(ref), str(asm), "-o", str(outdir),
         "--maf", "alignment.maf"],
        env=env, capture_output=True, text=True, timeout=420, cwd=REPO_ROOT)


def _outputs(module, ref, asm, outdir, env_extra):
    r = _run(module, ref, asm, outdir, env_extra)
    assert r.returncode == 0, r.stderr[-3000:]
    return ((outdir / "variant.vcf").read_bytes(),
            (outdir / "alignment.maf").read_bytes())


def test_fast_device_mode_matches_jax(tmp_path):
    ref, asm = write_pair_fixture(tmp_path)
    timings = tmp_path / "timings.json"
    want = _outputs("sibelia_tpu.cli.csibelia", ref, asm, tmp_path / "jax",
                    FAST)
    got = _outputs("sibelia_tpu_torch.cli.csibelia", ref, asm,
                   tmp_path / "port",
                   dict(FAST, SIBELIA_TPU_TIMINGS=str(timings)))
    vcf = want[0].decode().splitlines()
    assert sum(not ln.startswith("#") for ln in vcf) >= 40
    assert got == want
    phases = json.loads(timings.read_text())
    # the gaps closed in batches through the plain version: no launches
    assert phases["gotoh_flushes"] > 0
    assert phases["gotoh_pairs"] >= phases["gotoh_flushes"]
    assert not any(key.startswith("launches_") for key in phases)


def test_exact_mode_matches_jax(tmp_path):
    from sibelia_tpu.align import lagan_exact
    if not lagan_exact.available():
        pytest.skip("native LAGAN engine unavailable")
    ref, asm = write_pair_fixture(tmp_path)
    want = _outputs("sibelia_tpu.cli.csibelia", ref, asm, tmp_path / "jax",
                    {})
    got = _outputs("sibelia_tpu_torch.cli.csibelia", ref, asm,
                   tmp_path / "port", {})
    assert got == want  # the VCF and the MAF


DEVICE_PATH = {"SIBELIA_TPU_DEVICE_ORDER": "1",
               "SIBELIA_TPU_ANCHORS_DEVICE": "1"}


@pytest.mark.parametrize("switches", [DEVICE_PATH,
                                      {"SIBELIA_TPU_DEVICE_ORDER": "0"}],
                         ids=["device path forced", "band DP on the host"])
def test_exact_mode_device_switches_match_jax(tmp_path, switches):
    """The exact aligner's device path, forced on the CPU (the port runs
    the plain versions of its two kernels, the JAX package its scans), and
    the band DP forced to the host: the same VCF and MAF as the JAX CLI
    under the same switches."""
    ref, asm = write_pair_fixture(tmp_path)
    timings = tmp_path / "timings.json"
    want = _outputs("sibelia_tpu.cli.csibelia", ref, asm, tmp_path / "jax",
                    switches)
    got = _outputs("sibelia_tpu_torch.cli.csibelia", ref, asm,
                   tmp_path / "port",
                   dict(switches, SIBELIA_TPU_TIMINGS=str(timings)))
    assert got == want
    phases = json.loads(timings.read_text())
    assert not any(key.startswith("launches_") for key in phases)
    assert phases["order_host_fallback"] == 0
    if switches is DEVICE_PATH:
        assert phases["order_device_jobs"] > 0
        assert phases["anchors_sweeps"] >= phases["order_device_jobs"]
        assert phases["order_row_bytes"] > 0
    else:
        assert phases["order_device_jobs"] == 0
        assert phases["anchors_sweeps"] == 0
