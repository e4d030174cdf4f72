"""Points at the curb of zones whose borders follow streets: a uniformly
chosen zone, a uniformly chosen edge of it, a uniform position along the
edge, then a step along the edge's normal drawn from N(0, ``sigma_m``
metres)."""

from __future__ import annotations

import numpy as np
import torch

from geobench.points import M_PER_DEG


def make(spec, config, polys, n, gen, device):
    sigma_m = float(spec["sigma_m"])
    edges, owner = polys.edges()
    per = np.bincount(owner, minlength=len(polys))
    first = np.cumsum(per) - per
    e = torch.from_numpy(edges).to(device)
    zone = torch.randint(0, len(polys), (n,), generator=gen, device=device)
    pick = torch.rand(n, dtype=torch.float64, generator=gen, device=device)
    k = torch.from_numpy(first).to(device)[zone] + (
        pick * torch.from_numpy(per).to(device)[zone]).to(torch.int64)
    k = torch.minimum(k, torch.from_numpy(first + per - 1).to(device)[zone])
    x1, y1, x2, y2 = e[k].unbind(1)
    t = torch.rand(n, dtype=torch.float64, generator=gen, device=device)
    step = sigma_m * torch.randn(n, dtype=torch.float64, generator=gen, device=device)
    # the unit normal in local metres, then the step back in degrees
    cos_lat = torch.cos(torch.deg2rad(0.5 * (y1 + y2)))
    mx, my = (x2 - x1) * cos_lat * M_PER_DEG, (y2 - y1) * M_PER_DEG
    length = torch.sqrt(mx * mx + my * my).clamp(min=1e-9)
    x = x1 + t * (x2 - x1) + (-my / length) * step / (cos_lat * M_PER_DEG)
    y = y1 + t * (y2 - y1) + (mx / length) * step / M_PER_DEG
    return torch.stack([x, y], 1)
