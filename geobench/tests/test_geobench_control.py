"""The control: the reference in bfloat16, the precision below the
configuration's float32, put in the program's place, fails the limit
that sound runs of the program pass, both in the readings limits are set
from and through the harness's own ``correct``. On the CPU at the tiny
cell's size; on the card (``gpu``) at each cell's own size."""

import json
import os

import pytest
from conftest import TINY

from geobench import calibrate, harness

SPEC = harness.read_json(os.path.join(harness.ROOT, "BENCHMARK.json"))


def readings(capsys, workload, seeds, controls, device, **kw):
    calibrate.main(["--workload", workload, "--seeds", seeds, "--control-seeds", controls,
                    "--seconds", "0.5"], device=device, **kw)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_control_fails_where_the_program_passes(capsys, tiny_cache):
    r = readings(capsys, "tiny_zones.tiny_stream", "5,6", "5,6", "cpu",
                 spec_path=os.path.join(TINY, "BENCHMARK.json"), base=TINY, cache=tiny_cache)
    limit = harness.read_json(os.path.join(TINY, "limits", "tiny_zones.tiny_stream.json"))
    assert r["lower"] <= limit["mismatch_share"] < r["upper"]


@pytest.mark.parametrize("workload", ["tiny_zones.tiny_stream", "tiny_zones.tiny_batch",
                                      "tiny_zones.tiny_curbside"])
def test_control_through_the_harness_is_not_correct(run_tiny, workload):
    code, out, err = run_tiny(workload, seed=2**32 + 7)
    assert code == 0 and json.loads(out[-1])["correct"] is True
    code, out, err = run_tiny(workload, seed=2**32 + 7, extra=("--control", "bfloat16"))
    r = json.loads(out[-1])
    assert code == 0 and r["correct"] is False
    share = r["checks"]["mismatch_share"]
    assert share["value"] > share["limit"]
    assert "correct False" in err


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_control_on_the_card_at_the_cells_size(capfd, workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size there")
    from geobench import run

    def go(*extra):
        code = run.main(["--workload", workload, "--seed", "2147483659", "--seconds", "2",
                         "--trace", "0", *extra])
        return code, json.loads(capfd.readouterr().out.strip().splitlines()[-1])

    code, r = go()
    assert code == 0 and r["correct"] is True
    code, r = go("--control", "bfloat16")
    assert code == 0 and r["correct"] is False
    assert r["checks"]["mismatch_share"]["value"] > 3 * r["checks"]["mismatch_share"]["limit"]
