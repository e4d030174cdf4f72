"""Shared fixtures of the harness's tests: the repository root on the
path, and the tiny CPU cell under ``tests/tiny/``."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = os.path.join(HERE, "tiny")


@pytest.fixture(scope="session")
def tiny_cache(tmp_path_factory):
    """One index cache for the whole session (the tiny index builds once)."""
    return str(tmp_path_factory.mktemp("geobench-cache"))


@pytest.fixture
def run_tiny(tiny_cache, capsys):
    """Run a tiny cell on the CPU through ``run.main``; returns (exit code,
    stdout lines, stderr lines)."""
    import time

    from geobench import run

    def go(workload, seed=2**31 + 11, seconds=0.5, trace=0, extra=()):
        code = run.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                         "--trace", str(trace), *extra], device="cpu",
                        spec_path=os.path.join(TINY, "BENCHMARK.json"), base=TINY,
                        cache=tiny_cache, t0=time.perf_counter())
        out, err = capsys.readouterr()
        return code, out.strip().splitlines(), err.strip().splitlines()

    return go
