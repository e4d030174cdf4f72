"""The one generator of points: every traffic mix names a ``points``
kind and its parameters, and the kind's file ``points/<kind>.py`` makes
them with ``make(spec, config, polys, n, gen, device)``. Every seed gives
the same sizes.

Points are made with ``torch.Generator`` on ``device`` in a few large
calls, as float64.
"""

from __future__ import annotations

import os

import torch

from geobench.harness import load_module

HERE = os.path.dirname(os.path.abspath(__file__))
#: metres a degree of latitude (and of longitude at the equator)
M_PER_DEG = 111_320.0


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & ((1 << 63) - 1))
    return g


def make(spec: dict, config: dict, polys, n: int, gen: torch.Generator, device):
    """(n, 2) float64 points of the kind ``spec["kind"]``."""
    kind = spec["kind"]
    path = os.path.join(HERE, f"{kind}.py")
    if not os.path.isfile(path):
        raise ValueError(f"unknown points kind {kind!r}: no {path}")
    return load_module(path, f"geobench_points_{kind}").make(spec, config, polys, n, gen, device)
