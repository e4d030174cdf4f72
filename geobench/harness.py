"""One run of one cell: find its files by name, set up, hand the window to
the cell's driver, judge what the timed path produced against the plain
reference, and print the result line.

Everything a cell needs is found by the names in ``BENCHMARK.json``:
``configs/<config>.json`` (named by the configuration's ``file``),
``traffic/<traffic>.json``, the driver ``drivers/<driver>.py`` that the
traffic names, ``limits/<cell>.json``, and for each per-layer metric the
reader ``metrics/<name>.py``, or ``metrics/<name before its first
dot>.py``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: built indexes, one file per configuration and content (git-ignored)
CACHE = os.path.join(HERE, ".cache")
#: top-level module names that may not be loaded once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "mosaic_tpu")


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.isfile(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """The files of one cell, found by name."""

    name: str
    spec: dict  # the whole BENCHMARK.json
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    config_path: str

    @classmethod
    def find(cls, spec: dict, name: str, root: str = ROOT, base: str = HERE) -> "Cell":
        """The cell ``name`` of ``spec``; configuration files are found from
        ``root``, traffic and limits under ``base``."""
        by_name = {w["name"]: w for w in spec["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = by_name[name]
        conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
        config_path = os.path.join(root, conf["file"])
        return cls(
            name=name, spec=spec, workload=w,
            config=read_json(config_path),
            traffic=read_json(os.path.join(base, "traffic", f"{w['traffic']}.json")),
            limits=read_json(os.path.join(base, "limits", f"{name}.json")),
            config_path=config_path,
        )

    def driver(self):
        kind = self.traffic["driver"]
        return load_module(os.path.join(HERE, "drivers", f"{kind}.py"),
                           f"geobench_driver_{kind}")

    def metrics(self, section: str) -> list[dict]:
        """This cell's metrics of ``end_to_end`` or ``per_layer``: those
        that list it, and those with no list whose end-to-end metric it
        reports."""
        e2e = {m["name"] for m in self.spec["end_to_end"]
               if "workloads" not in m or self.name in m["workloads"]}
        out = []
        for m in self.spec[section]:
            if "workloads" in m:
                if self.name in m["workloads"]:
                    out.append(m)
            elif section == "end_to_end" or m["moves"] in e2e:
                out.append(m)
        return out


def reader(name: str):
    """The per-layer reader of metric ``name``."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(HERE, "metrics", f"{stem}.py")
        if os.path.isfile(path):
            return load_module(path, f"geobench_metric_{stem.replace('.', '_')}")
    raise FileNotFoundError(f"no reader for metric {name!r} under metrics/")


class SetupClock:
    """The split of ``setup_s``: seconds of each stage since the run began."""

    def __init__(self, t0: float):
        self.t0 = self.last = t0
        self.stages: dict[str, float] = {}
        self.notes: dict[str, object] = {}
        self.total: float | None = None

    def stage(self, name: str) -> None:
        now = time.perf_counter()
        self.stages[name] = self.stages.get(name, 0.0) + now - self.last
        self.last = now

    def done(self) -> float:
        """Close set-up: the window starts now."""
        self.stage("warm")
        self.total = time.perf_counter() - self.t0
        return self.total


@dataclasses.dataclass
class Run:
    """What a driver gets: the cell, the run's arguments, what set-up made."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    clock: SetupClock
    polys: object = None
    index: object = None
    index_system: object = None
    cache: str = CACHE

    @property
    def resolution(self) -> int:
        return int(self.cell.config["resolution"])


@dataclasses.dataclass
class Outcome:
    """What a driver returns once its window has closed and the program's
    state is freed: counts, end-to-end values, the trace for the readers,
    the points it sent with the answers the program gave, and the checks
    it made itself as ``{name: (value, limit)}``."""

    attempted: int
    failed: int
    e2e: dict
    memory_peak_bytes: int
    points: object  # (N, 2) f64 tensor or ndarray
    answers: object  # (N,) int ndarray
    checks: dict
    trace: object = None
    lines: list = dataclasses.field(default_factory=list)


def index_key(cell: Cell) -> str:
    """The cache file of a configuration: its name and a hash of its file
    and of the polygon generator it names."""
    h = hashlib.sha256()
    with open(cell.config_path, "rb") as f:
        h.update(f.read())
    with open(os.path.join(HERE, "polygons", f"{cell.config['polygons']['kind']}.py"), "rb") as f:
        h.update(f.read())
    return f"{cell.workload['config']}-{h.hexdigest()[:16]}.npz"


def load_index(run: Run):
    """The configuration's ChipIndex: loaded from the checkout's cache, or
    tessellated, built and saved there. Returns (index, "loaded"|"built")."""
    import numpy as np

    from geobench import port

    path = os.path.join(run.cache, index_key(run.cell))
    if os.path.isfile(path):
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        return port.index_from_arrays(arrays, run.device), "loaded"
    ix = port.build_index(run.polys, run.index_system, run.resolution, run.device)
    os.makedirs(run.cache, exist_ok=True)
    part = path + ".partial"
    with open(part, "wb") as f:
        np.savez(f, **ix.to_arrays())
    os.replace(part, path)
    return ix, "built"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
             cache: str = CACHE, control: str | None = None) -> tuple[dict | None, int]:
    """One run of ``cell``: (the result line's object, exit code). The
    result is None where the run may print none. ``control`` names a
    torch dtype below the configuration's: the reference in that
    precision is then judged in the program's place."""
    import gc

    import torch

    import mosaic_tpu_torch  # noqa: F401  (its import is set-up)

    from geobench import polygons, port
    from geobench.reference import pip as reference

    dev = torch.device(device)
    clock = SetupClock(t0)
    clock.stage("imports")
    if dev.type == "cuda":
        from mosaic_tpu_torch.kernels import _build

        _build.load("pip")
        torch.cuda.reset_peak_memory_stats(dev)
    clock.stage("libraries")
    run = Run(cell=cell, seed=seed, seconds=seconds, trace=trace, device=dev, clock=clock,
              cache=cache)
    run.polys = polygons.make(cell.config["polygons"])
    run.index_system = port.index_system(cell.config["index_system"])
    run.index, source = load_index(run)
    clock.notes["index"] = source
    clock.stage("index")

    out = cell.driver().run(run)
    bad = forbidden_modules()
    if bad:
        print(f"geobench: modules loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return None, 3
    emit({"setup": {**{f"{k}_s": v for k, v in clock.stages.items()},
                    "total_s": clock.total, **clock.notes}})
    for line in out.lines:
        emit(line)

    # the reference, with the program's state freed
    run.index = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want = reference.answers(run.polys, out.points, dev).cpu().numpy()
    if control:
        got = reference.control_answers(run.polys, out.points, dev,
                                        getattr(torch, control)).cpu().numpy()
    else:
        got = out.answers.astype(want.dtype)
    mismatch = int((got != want).sum())
    emit({"reference": {"points": int(want.size), "mismatched": mismatch,
                        "judged": f"control {control}" if control else "program",
                        "matched_share": float((want >= 0).mean()),
                        "seconds": time.perf_counter() - t_ref}})
    checks = {**out.checks,
              "mismatch_share": (mismatch / want.size, float(cell.limits["mismatch_share"]))}
    correct = all(v <= lim for v, lim in checks.values())

    metrics = {}
    if trace:
        for m in cell.metrics("per_layer"):
            v = reader(m["name"]).read(out.trace) if out.trace is not None else None
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"setup_s": clock.total, **out.e2e}
        for m in cell.metrics("end_to_end"):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device_info}
    prof = out.trace.profile if out.trace is not None else None
    if trace:
        device_info["busy_s"] = prof.busy_s() if prof else 0.0
        device_info["window_s"] = prof.window_s if prof else 0.0
        if prof is not None:
            result["breakdown"] = {"device_ops": prof.device_ops(), "idle_gaps": prof.idle_gaps()}
    if dev.type == "cuda":
        result["card"] = card()
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    print(f"correct {correct}", file=sys.stderr)
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr, flush=True)
    return result, 0


def card() -> dict:
    """The card's name and power limit, from nvidia-smi."""
    import subprocess

    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as exc:
        return {"nvidia_smi": f"not read: {exc}"[:200]}
    return {"nvidia_smi": got[0].strip() if got else "no output"}
