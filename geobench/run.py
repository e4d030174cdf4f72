"""Run one cell of the benchmark and print its result as the last line of
standard output:

    python3 geobench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's files are found by the names in ``BENCHMARK.json`` at the root
of the checkout (see ``harness.py``). The run needs a CUDA card: without
one, or with fewer cards than the cell asks for, or without the
``mosaic_tpu_torch`` package beside this folder, it prints no result and
exits with 2; with JAX or the JAX package loaded once the window has
closed, it exits with 3.

``--control bfloat16`` runs the cell as it is and then judges the
reference, computed in bfloat16 (the precision below the configuration's
float32), in the program's place: ``correct`` has to come out false.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from geobench import harness  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("bfloat16",), default=None,
                   help="judge the reference in this precision in the program's place")
    return p.parse_args(argv)


def main(argv=None, device=None, spec_path=None, base=harness.HERE,
         cache=harness.CACHE, t0=None) -> int:
    """The command. ``device`` (None: the CUDA card, required),
    ``spec_path``, ``base`` and ``cache`` let the tests run a tiny cell on
    the CPU."""
    t0 = T0 if t0 is None else t0
    args = parse(argv)
    # the configuration runs as it is stated: no knob of the program's
    # environment may change it
    for k in [k for k in os.environ if k.startswith("MOSAIC_")]:
        print(f"geobench: ignoring {k}", file=sys.stderr)
        del os.environ[k]
    spec_path = spec_path or os.path.join(ROOT, "BENCHMARK.json")
    try:
        spec = harness.read_json(spec_path)
        cell = harness.Cell.find(spec, args.workload, root=os.path.dirname(spec_path), base=base)
    except (OSError, KeyError, ValueError) as exc:
        print(f"geobench: {exc}", file=sys.stderr)
        return 2
    import torch

    if device is None:
        chips = int(cell.workload["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"geobench: the cell needs {chips} CUDA card(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
                  file=sys.stderr)
            return 2
        device = "cuda"
    try:
        import mosaic_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"geobench: the program is not here: {exc}", file=sys.stderr)
        return 2
    result, code = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                                    t0, cache=cache, control=args.control)
    if result is not None:
        harness.emit(result)
    return code


if __name__ == "__main__":
    sys.exit(main())
