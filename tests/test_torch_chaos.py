"""The port's chaos sweep (`python -m mosaic_tpu_torch.tools.chaos_sweep
--device cpu`) against the reference's (`tools/chaos_sweep.py`): one
injected fault at each of the 25 registered sites, and each site's
outcome (typed, identical, degraded, contained) equal to the
reference's. Both sweeps run as processes of their own, one after the
other, each under its own time limit. `tests/test_torch_kernels_gpu.py` runs the
port's sweep on the card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from mosaic_tpu_torch.tools import chaos_sweep as CS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """(port line, port rc, reference line, reference rc, trail, port
    stderr). The two sweeps run one after the other, each on two threads
    (the suite's other workers time host work meanwhile)."""
    d = tmp_path_factory.mktemp("chaos")
    trail = str(d / "port.jsonl")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    port = subprocess.run(
        [sys.executable, "-m", "mosaic_tpu_torch.tools.chaos_sweep", "--device", "cpu",
         "--trail", trail], cwd=ROOT, capture_output=True, text=True, env=env,
        timeout=300)
    ref_env = dict(env, XLA_FLAGS=(env.get("XLA_FLAGS", "")
                                   + " --xla_cpu_multi_thread_eigen=false").strip())
    ref = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "chaos_sweep.py")],
                         cwd=ROOT, capture_output=True, text=True, env=ref_env, timeout=600)
    pline = json.loads(port.stdout.strip().splitlines()[-1])
    rline = json.loads(ref.stdout.strip().splitlines()[-1])
    return pline, port.returncode, rline, ref.returncode, trail, port.stderr


def test_port_sweep_passes_every_site_on_the_cpu(sweeps):
    pline, prc, _, _, _, perr = sweeps
    assert prc == 0, (pline, perr[-2000:])
    assert pline["metric"] == "chaos_sites_clean" and pline["unit"] == "sites"
    detail = pline["detail"]
    assert pline["value"] == detail["registered"] == 25
    assert detail["device"] == "cpu"
    assert detail["failures"] == {} and detail["missing_drivers"] == []
    assert detail["extra"] == []


def test_every_site_has_the_references_outcome(sweeps):
    pline, _, rline, rrc, _, _ = sweeps
    assert rrc == 0, rline
    got = {s: r["outcome"] for s, r in pline["detail"]["outcomes"].items()}
    want = {s: r["outcome"] for s, r in rline["detail"]["outcomes"].items()}
    assert got == want
    for site, r in pline["detail"]["outcomes"].items():
        ref = rline["detail"]["outcomes"][site]
        if r["outcome"] == "typed":
            assert r["error"] == ref["error"], site
        elif r["outcome"] == "identical":
            assert r["retries"] == ref["retries"] == 1, site
        elif r["outcome"] == "contained":
            assert r["quarantined"] == ref["quarantined"] == 4


def test_the_trail_records_each_site(sweeps):
    *_, trail, _ = sweeps
    with open(trail) as f:
        events = [json.loads(ln) for ln in f if ln.strip()]
    sites = [e["site"] for e in events if e.get("event") == "chaos_site"]
    with open(CS.DEFAULT_REGISTRY) as f:
        assert sorted(sites) == sorted(json.load(f)["fault_sites"])


def test_a_registered_site_without_a_driver_fails_the_sweep(tmp_path):
    reg = tmp_path / "registry.json"
    reg.write_text(json.dumps({"fault_sites": ["made.up", "stream.admit"]}))
    env = dict(os.environ)
    line, rc = CS.run_sweep(str(reg), "cpu", sites=["made.up", "stream.*"])
    assert rc == 1
    assert line["detail"]["missing_drivers"] == ["made.up"]
    assert "made.up" in line["detail"]["error"]
    assert set(line["detail"]["outcomes"]) == {
        "stream.admit", "stream.prefetch", "stream.scan_step", "stream.snapshot"}
    assert line["value"] == 4
    assert dict(os.environ) == env  # the sweep sets no knob


def test_the_json_line_comes_even_when_the_sweep_cannot_start(tmp_path, capsys):
    rc = CS.main(["--device", "cpu", "--registry", str(tmp_path / "missing.json")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and line["value"] == 0 and "No such file" in line["detail"]["error"]


def test_the_sweep_runs_on_the_card_by_default(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the gpu test sweeps it")
    rc = CS.main(["--sites", "stream.admit"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and "DeviceUnavailable" in line["detail"]["error"]
    assert line["detail"]["device"] == "cuda"
