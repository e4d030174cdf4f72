"""Single-controller device meshes: placement, shards and the two
collectives the distribution layer uses.

Port of what the reference takes from ``jax.sharding`` (``Mesh``,
``PartitionSpec``) and ``shard_map`` (`mosaic_tpu/parallel/_compat.py`):
one process holds a :class:`Mesh` of torch devices and runs a function
once a shard, shard ``i`` on device ``i`` of the mesh's row-major device
order. CUDA launches are asynchronous, so the shards on different cards
overlap; on one card they run one after another.

- :func:`shard` splits dim 0 contiguously, as ``P(axes)`` places shards;
- :func:`to_device` / :func:`replicas` place a replicated value (a tensor
  or a dataclass of tensors, such as a ``ChipIndex``) once per distinct
  device: on a device it already lives on, it is not copied;
- :func:`all_gather` concatenates shards in shard order (tiled);
- :func:`psum` sums per-shard partials in one fixed shard order;
- :func:`run_sharded` is the ``shard_map`` of a point-wise function.

A mesh's device list may repeat a device (``Mesh([dev] * 4)``), the
port's counterpart of XLA's ``--xla_force_host_platform_device_count``:
torch has one CPU device, and a machine may have one card. Such a
logical mesh runs every shard's code path on one device; it says nothing
about scaling. A mesh never mixes CPU and CUDA devices.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

__all__ = [
    "Mesh",
    "Placed",
    "all_gather",
    "device_scope",
    "platform_devices",
    "psum",
    "replicas",
    "run_sharded",
    "shard",
    "to_device",
]


def _norm(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """An n-D array of torch devices with named axes — the port's
    ``jax.sharding.Mesh``. ``shape`` maps each axis name to its size (in
    axis order), ``size`` is the device count, ``devices`` the numpy
    object array of ``torch.device``. Two meshes with the same axes,
    shape and device order are equal (and hash alike)."""

    def __init__(self, devices, axis_names=("dp",)):
        arr = np.asarray(devices, dtype=object)
        names = (axis_names,) if isinstance(axis_names, str) else tuple(axis_names)
        if arr.ndim != len(names):
            raise ValueError(
                f"mesh of {arr.ndim} dimensions needs {arr.ndim} axis "
                f"names, got {names}"
            )
        if arr.size < 1:
            raise ValueError("a mesh needs at least one device")
        devs = np.empty(arr.shape, dtype=object)
        for i, d in enumerate(arr.flat):
            devs.flat[i] = _norm(d)
        kinds = {d.type for d in devs.flat}
        if len(kinds) > 1:
            raise ValueError(
                f"a mesh cannot mix device types {sorted(kinds)}: every "
                "shard of one dispatch runs on one kind of device"
            )
        self.devices = devs
        self.axis_names = names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_list(self) -> list:
        """The devices in shard order (row-major)."""
        return list(self.devices.flat)

    @property
    def distinct(self) -> list:
        """Each device once, in first-seen shard order."""
        seen: dict = {}
        for d in self.devices.flat:
            seen.setdefault(str(d), d)
        return list(seen.values())

    @property
    def first(self) -> torch.device:
        """Where :func:`run_sharded` concatenates the shards' outputs."""
        return self.devices.flat[0]

    @property
    def type(self) -> str:
        return self.first.type

    def key(self) -> tuple:
        return (
            self.axis_names,
            tuple(self.devices.shape),
            tuple(str(d) for d in self.devices.flat),
        )

    def __eq__(self, other):
        return isinstance(other, Mesh) and self.key() == other.key()

    def __hash__(self):
        return hash(self.key())

    def __repr__(self):
        return (
            f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"
        )


def platform_devices(kind: str) -> list:
    """The real devices of one kind: every CUDA card, or the one CPU."""
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(kind)]


def _pieces(mesh: Mesh, axes) -> tuple[int, list]:
    """(pieces, piece index of each device in shard order) of a split
    over ``axes`` (None = every axis)."""
    axes = mesh.axis_names if axes is None else (
        (axes,) if isinstance(axes, str) else tuple(axes)
    )
    pos = [mesh.axis_names.index(a) for a in axes]
    sizes = [mesh.devices.shape[p] for p in pos]
    idx = []
    for coords in np.ndindex(*mesh.devices.shape):
        k = 0
        for p, s in zip(pos, sizes):
            k = k * s + coords[p]
        idx.append(k)
    return int(np.prod(sizes, dtype=np.int64)) if sizes else 1, idx


def shard(x: torch.Tensor, mesh: Mesh, axes=None) -> list:
    """Dim 0 of ``x`` split contiguously over ``axes`` (default: every
    axis), one piece a device in shard order, each on its device. The
    length must divide over the split."""
    n, idx = _pieces(mesh, axes)
    rows = int(x.shape[0])
    if rows % n:
        raise ValueError(
            f"{rows} rows do not divide over the {n} shards of {mesh!r}"
        )
    m = rows // n
    return [x[k * m:(k + 1) * m].to(d) for k, d in zip(idx, mesh.devices.flat)]


def to_device(obj, dev: torch.device):
    """``obj`` with its tensors on ``dev``; a tensor already there (and
    so a whole value) is returned as it is. Walks tensors, dataclass
    instances (keeping their non-field attributes, such as a
    ``ChipIndex``'s host companion), tuples, lists and dicts."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        names = [f.name for f in dataclasses.fields(obj)]
        moved = {n: to_device(getattr(obj, n), dev) for n in names}
        if all(moved[n] is getattr(obj, n) for n in names):
            return obj
        new = dataclasses.replace(obj, **moved)
        for k, v in vars(obj).items():
            if k not in moved:
                setattr(new, k, v)
        return new
    if isinstance(obj, (tuple, list)):
        moved = [to_device(v, dev) for v in obj]
        if all(a is b for a, b in zip(moved, obj)):
            return obj
        return type(obj)(moved)
    if isinstance(obj, dict):
        return {k: to_device(v, dev) for k, v in obj.items()}
    return obj


class Placed(dict):
    """A value placed once per distinct device of a mesh, ``{device
    string: value}`` (:func:`replicas`): :func:`run_sharded` hands it to
    each shard without moving it again."""


def replicas(obj, mesh: Mesh) -> Placed:
    """``obj`` placed on every distinct device of the mesh, moved once a
    device (not at all on a device it already lives on)."""
    return Placed({str(d): to_device(obj, d) for d in mesh.distinct})


def all_gather(shards, device=None) -> torch.Tensor:
    """The shards concatenated along dim 0 in shard order (tiled), on
    ``device`` (default: the first shard's)."""
    dev = shards[0].device if device is None else device
    return torch.cat([s.to(dev) for s in shards], dim=0)


def psum(parts, device=None) -> torch.Tensor:
    """The per-shard partials summed in shard order on ``device``
    (default: the first partial's). Integer partials sum exactly."""
    dev = parts[0].device if device is None else device
    acc = parts[0].to(dev).clone()
    for p in parts[1:]:
        acc += p.to(dev)
    return acc


def device_scope(dev: torch.device):
    """``dev`` made current on a CUDA device; nothing on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _concat(outs: list, dev: torch.device):
    if isinstance(outs[0], tuple):
        return tuple(_concat([o[j] for o in outs], dev) for j in range(len(outs[0])))
    return torch.cat([o.to(dev) for o in outs], dim=0)


def run_sharded(fn, mesh: Mesh, sharded=(), replicated=()):
    """Run ``fn(*shard_args, *replicated_args)`` once a shard: shard
    ``i`` gets piece ``i`` of every ``sharded`` tensor (dim 0 split over
    every axis) and the ``replicated`` values placed on its device (a
    :class:`Placed` value as it was placed), and runs under that device.
    Returns the outputs (a tensor or a tuple of tensors a shard)
    concatenated in shard order on the mesh's first device. Every output
    row depends only on its shard's rows and the replicated
    values, so the result equals one unsharded call bit for bit when
    ``fn`` is point-wise."""
    parts = [shard(x, mesh) for x in sharded]
    placed = [
        r if isinstance(r, Placed) else replicas(r, mesh) for r in replicated
    ]
    outs = []
    for i, dev in enumerate(mesh.devices.flat):
        with device_scope(dev):
            outs.append(fn(*(p[i] for p in parts), *(r[str(dev)] for r in placed)))
    return _concat(outs, mesh.first)
