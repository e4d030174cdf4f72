"""Fresh-process sweep: is a process's first CPU cell assignment right?

On the CPU, the first transcendental of a process (torch's MKL vector
math) can give wrong bits in whole thread chunks when it is split over
the intra-op pool (see `core/index/h3/hexmath.py warm_cpu_math`). A fault
of the FIRST call shows only in a fresh interpreter, so this tool starts
many of them. Each child runs one check and prints one JSON line:

- ``cells``: ``H3IndexSystem().point_to_cell`` at resolution 9 on the
  161,354 seed-7 NYC points — the first call (f32 tensor) against the
  second, then the f64 tensor path against the numpy host path;
- ``trig``: makes ``TorchNamespace("cpu")``, then runs ONE op first on
  161,354 seed-7 f32 values in [0.70, 0.72] — ``cos`` or ``sin`` through
  the namespace, ``sqrt`` or ``atan`` through torch — first call against
  second. Child ``i`` of a sweep runs ``TRIG_OPS[i % 4]``.

Run (prints one JSON document, the count of children that differed):

    python -m mosaic_tpu_torch.tools.first_call_sweep --procs 128 \
        --parallel 8 [--mode cells|trig] [--threads N]

``--threads`` sets the children's ``OMP_NUM_THREADS`` (their intra-op
pool). More threads make the first-call fault likelier on the cells path
(an unrepaired tree: 4 of 192 processes at 32 threads, 0 of 160 at 8).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

N_POINTS = 161_354
SEED = 7
TRIG_OPS = ("cos", "sin", "sqrt", "atan")


def child(mode: str, op: str = "cos") -> dict:
    """One fresh process's check (its first torch math is this one's)."""
    import torch

    rng = np.random.default_rng(SEED)
    if mode == "cells":
        from ..core.index.h3 import H3IndexSystem
        from ..datasets import NYC_BBOX

        pts = rng.uniform(NYC_BBOX[:2], NYC_BBOX[2:], (N_POINTS, 2))
        h3 = H3IndexSystem()
        t32 = torch.from_numpy(pts).float()
        first = h3.point_to_cell(t32, 9).numpy()
        second = h3.point_to_cell(t32, 9).numpy()
        dev64 = h3.point_to_cell(torch.from_numpy(pts), 9).numpy()
        host = np.asarray(h3.point_to_cell(pts, 9))
        return {
            "mode": mode,
            "first_vs_second": int((first != second).sum()),
            "f64_vs_host": int((dev64 != host).sum()),
        }
    if mode == "trig":
        from ..core.index.h3.hexmath import TorchNamespace

        x = torch.from_numpy(
            rng.uniform(0.70, 0.72, N_POINTS).astype(np.float32)
        )
        ns = TorchNamespace("cpu")
        f = {"cos": ns.cos, "sin": ns.sin, "sqrt": torch.sqrt,
             "atan": torch.atan}[op]
        first = f(x)
        return {
            "mode": mode,
            "op": op,
            "first_vs_second": int((first != f(x)).sum()),
        }
    raise ValueError(f"unknown mode {mode!r} (expected cells|trig)")


def run_child(mode: str, op: str = "cos", timeout_s: float = 300.0,
              threads: int | None = None) -> dict:
    """Start one fresh interpreter on :func:`child` and read its line."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    # idle pool threads sleep instead of spinning, so a sweep beside other
    # work does not stall the machine (the fault shows either way)
    env.setdefault("OMP_WAIT_POLICY", "passive")
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    proc = subprocess.run(
        [sys.executable, "-m", "mosaic_tpu_torch.tools.first_call_sweep",
         "--child", mode, "--op", op],
        capture_output=True, text=True, timeout=timeout_s, cwd=root, env=env,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"child failed: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def sweep(procs: int, parallel: int, mode: str, timeout_s: float = 300.0,
          threads: int | None = None) -> dict:
    """Run ``procs`` children, ``parallel`` at a time."""
    with ThreadPoolExecutor(max_workers=parallel) as pool:
        rows = list(pool.map(
            lambda i: run_child(mode, TRIG_OPS[i % len(TRIG_OPS)], timeout_s,
                                threads),
            range(procs)))
    bad = [r for r in rows
           if any(v for k, v in r.items() if k not in ("mode", "op"))]
    return {"mode": mode, "procs": procs, "parallel": parallel,
            "threads": threads, "differing": len(bad), "rows_differing": bad}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--child", choices=("cells", "trig"))
    ap.add_argument("--op", default="cos", choices=TRIG_OPS)
    ap.add_argument("--mode", default="cells", choices=("cells", "trig"))
    ap.add_argument("--procs", type=int, default=128)
    ap.add_argument("--parallel", type=int, default=8)
    ap.add_argument("--threads", type=int, default=None)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.child, args.op)))
        return 0
    import torch

    out = sweep(args.procs, args.parallel, args.mode, threads=args.threads)
    out["torch"] = torch.__version__
    out["cpu_capability"] = torch.backends.cpu.get_cpu_capability()
    out["sweeper_threads"] = torch.get_num_threads()
    print(json.dumps(out))
    return 0 if out["differing"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
