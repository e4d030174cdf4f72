"""Write the recommender's priors from a ``chip_smoke.py`` run on the card.

    python3 chip_smoke.py > smoke.out
    python -m mosaic_tpu_torch.tools.card_priors smoke.out

reads the run's lines (one JSON object a line, the card's
``nvidia-smi`` name and power limit in the ``device`` line) and writes
into ``mosaic_tpu_torch/tune/priors/`` (or ``--out DIR``) the two priors
`tune/recommend.py` reads:

- ``OVERLAY_h100.json``: ``detail.speedup_vs_host``, the overlay join's
  host lane seconds over its best device lane seconds (phase 8i);
- ``KNN_h100.json``: ``detail.voronoi_speedup_vs_ring``, the Voronoi
  lane's queries/s over the ring lane's on 64-row dispatches (phase 8j).

Each file names the card and its power limit (``device``) and the phase
it came from (``source``); the run must have ended with ``"ok": true``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

PRIORS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "tune", "priors")


def read_lines(path: str) -> dict:
    """{phase: the last JSON line of that phase}, plus ``ok`` from the
    run's last line."""
    out = {}
    with open(path) as fh:
        for ln in fh:
            try:
                obj = json.loads(ln)
            except ValueError:
                continue
            if isinstance(obj, dict) and "phase" in obj:
                out[obj["phase"]] = obj
            elif isinstance(obj, dict) and "ok" in obj:
                out["ok"] = obj["ok"]
    return out


def priors_from(lines: dict) -> dict:
    """{file name: prior} from a run's lines."""
    if lines.get("ok") is not True:
        raise ValueError("the run did not end with \"ok\": true")
    name, limit = (p.strip() for p in lines["device"]["nvidia_smi"].split(",", 1))
    device = {"name": name, "power_limit": limit,
              "torch": lines["device"].get("torch"), "cuda": lines["device"].get("cuda")}
    o, k = lines["overlay"], lines["knn"]
    dev_s = min(o["device_s"])
    lanes = k["lanes_64_rows"]
    return {
        "OVERLAY_h100.json": {
            "source": "chip_smoke.py phase 8i (overlay): host_s / min(device_s)",
            "device": device,
            "detail": {
                "speedup_vs_host": o["host_s"] / dev_s,
                "device_s": dev_s, "host_s": o["host_s"], "pairs": o["pairs"],
                "n_per_side": o["n_per_side"], "res": o["res"],
            },
        },
        "KNN_h100.json": {
            "source": "chip_smoke.py phase 8j (knn): voronoi / ring queries_per_s, "
                      "64-row dispatches",
            "device": device,
            "detail": {
                "voronoi_speedup_vs_ring":
                    lanes["voronoi"]["queries_per_s"] / lanes["ring"]["queries_per_s"],
                "ring_queries_per_s": lanes["ring"]["queries_per_s"],
                "voronoi_queries_per_s": lanes["voronoi"]["queries_per_s"],
                "candidates": k["candidates"], "k": k["k"],
            },
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run", help="chip_smoke.py's standard output")
    ap.add_argument("--out", default=PRIORS_DIR)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for name, prior in priors_from(read_lines(args.run)).items():
        with open(os.path.join(args.out, name), "w") as fh:
            json.dump(prior, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(name, json.dumps(prior["detail"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
