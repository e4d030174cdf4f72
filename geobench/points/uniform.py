"""Points uniform over the configuration's ``points_bbox``."""

from __future__ import annotations

import torch


def make(spec, config, polys, n, gen, device):
    x0, y0, x1, y1 = config["points_bbox"]
    u = torch.rand((n, 2), dtype=torch.float64, generator=gen, device=device)
    lo = torch.tensor([x0, y0], dtype=torch.float64, device=device)
    span = torch.tensor([x1 - x0, y1 - y0], dtype=torch.float64, device=device)
    return lo + u * span
