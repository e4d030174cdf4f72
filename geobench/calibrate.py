"""Readings for the limits of ``correct``, in one process:

    python3 geobench/calibrate.py --workload <cell> --seeds 1,2,... --control-seeds 1,2,3 [--seconds 2]

For each seed: the cell's driver runs a short window at the cell's own
size and load, and its answers are compared with the float64 reference
(the lower reading is the largest ``mismatch_share`` of these sound runs).
For each control seed: the reference itself, computed in bfloat16 (the
next precision below the configuration's float32) on recentred
coordinates, is compared with the float64 reference on the same points
(the upper reading is the smallest); ``run.py --control`` judges the same
answers through the harness's own ``correct``. One JSON line a reading;
the last line sums them up.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from geobench import harness  # noqa: E402


def main(argv=None, device="cuda", spec_path=None, base=harness.HERE, cache=harness.CACHE):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control-dtype", default="bfloat16")
    a = p.parse_args(argv)
    import torch

    from geobench import polygons, port
    from geobench.reference import pip as reference

    spec_path = spec_path or os.path.join(ROOT, "BENCHMARK.json")
    cell = harness.Cell.find(harness.read_json(spec_path), a.workload,
                             root=os.path.dirname(spec_path), base=base)
    dev = torch.device(device)
    polys = polygons.make(cell.config["polygons"])
    system = port.index_system(cell.config["index_system"])
    low_dtype = getattr(torch, a.control_dtype)
    seeds = [int(s) for s in a.seeds.split(",") if s]
    controls = {int(s) for s in a.control_seeds.split(",") if s}
    program, control = [], []
    for seed in seeds + sorted(controls - set(seeds)):
        run = harness.Run(cell=cell, seed=seed, seconds=a.seconds, trace=False, device=dev,
                          clock=harness.SetupClock(time.perf_counter()), cache=cache)
        run.polys, run.index_system = polys, system
        run.index, _ = harness.load_index(run)
        out = cell.driver().run(run)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        want = reference.answers(polys, out.points, dev)
        line = {"seed": seed, "points": int(want.numel())}
        if seed in seeds:
            got = torch.as_tensor(out.answers.astype("int64"), device=dev)
            line["program_mismatch_share"] = float((got != want).double().mean())
            line["exact_checks"] = {k: v for k, (v, _) in out.checks.items()}
            program.append(line["program_mismatch_share"])
        if seed in controls:
            low = reference.control_answers(polys, out.points, dev, low_dtype)
            line["control_mismatch_share"] = float((low != want).double().mean())
            control.append(line["control_mismatch_share"])
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": a.workload, "control_dtype": a.control_dtype,
                      "lower": max(program) if program else None,
                      "upper": min(control) if control else None,
                      "program": program, "control": control}), flush=True)


if __name__ == "__main__":
    main()
