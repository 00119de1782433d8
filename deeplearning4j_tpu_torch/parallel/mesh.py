"""Process groups as meshes.

Counterpart of `deeplearning4j_tpu/parallel/mesh.py:1-119`. The JAX package
runs one process over every device and names the device axes of a
`jax.sharding.Mesh`; the port runs one process per rank of a
`torch.distributed` process group, and its `Mesh` records the axis names,
their sizes, the group and this rank's device. `make_mesh` defaults to the
data-parallel ("dp",) mesh, `serve_mesh` is the serving path's 1-D
("batch",) mesh, and the plan's 2-D ("batch", "model") mesh is
`parallel/plan.plan_mesh`.

`init_distributed` starts (or reuses) the default group: from torchrun's
`RANK`/`WORLD_SIZE`/`MASTER_ADDR`/`MASTER_PORT` when they are set, and
otherwise as a group of one over an in-memory store. A CUDA device takes
NCCL and the CPU takes gloo; without NCCL a CUDA run fails and says so,
with no fallback to gloo. `shard_batch` gives this rank its contiguous
slice of a batch, the rows that `P("dp")` places on device r in JAX: the
rank at coordinate r of the axis takes rows [r·b/n, (r+1)·b/n).
"""

from __future__ import annotations

import math
import os
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nd.platform import resolve_device

#: canonical axis order, outermost first (the JAX package's)
AXIS_ORDER = ("pp", "dp", "ep", "sp", "tp")

#: the axis the port's data-parallel training runs over
DP_AXIS = "dp"
#: the axes that shard the batch: "dp", and "batch", the 1-D layout of the
#: CLI's `--mesh` (the JAX package's serving and plan axis)
DATA_AXES = (DP_AXIS, "batch")


class Mesh:
    """A mesh of ranks: `axis_names`, `shape` ({axis: size}), the process
    `group` whose ranks make up the mesh, this rank's `device`, and per
    axis this rank's coordinate (`coord`) and the sub-group of the ranks
    that differ from it only along that axis (`axis_group`)."""

    def __init__(self, shape: Dict[str, int], group, device: torch.device,
                 axis_groups: Optional[Dict[str, object]] = None):
        self.axis_names: Tuple[str, ...] = tuple(shape)
        self.shape: Dict[str, int] = dict(shape)
        self.group = group
        self.device = device
        self._axis_groups = dict(axis_groups or {})

    @property
    def rank(self) -> int:
        import torch.distributed as dist

        return dist.get_rank(self.group)

    def coord(self, axis: str) -> int:
        """This rank's coordinate along `axis` (row-major over the axes)."""
        if self.shape[axis] == 1:
            return 0
        stride = math.prod(self.shape[a] for a in self.axis_names[
            self.axis_names.index(axis) + 1:])
        return (self.rank // stride) % self.shape[axis]

    def axis_group(self, axis: str):
        """The process group of the ranks that share this rank's
        coordinates on every axis but `axis` (the mesh's own group where
        `axis` spans it)."""
        return self._axis_groups.get(axis, self.group)

    @property
    def backend(self) -> str:
        import torch.distributed as dist

        return str(dist.get_backend(self.group))

    def __repr__(self):
        return (f"Mesh(shape={self.shape}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")


class Sharding(NamedTuple):
    """Where an array lives on a mesh: `spec` names the mesh axis of each
    leading dim, () replicated (JAX's `PartitionSpec`)."""

    mesh: Mesh
    spec: Tuple[str, ...]


def mesh_axes(mesh: Mesh) -> Sequence[str]:
    return tuple(mesh.axis_names)


def _torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def rank_device(device=None) -> torch.device:
    """This rank's device. Under torchrun, one card a rank: None or a
    `cuda` without an index is the card of torchrun's `LOCAL_RANK` (modulo
    the cards this process sees, so a rank shown only its own card takes
    it); an explicit index or the CPU stands. Otherwise as
    `resolve_device`."""
    want = torch.device("cuda" if device is None else device)
    if (_torchrun() and want.type == "cuda" and want.index is None
            and torch.cuda.is_available()):
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        want = torch.device("cuda", local % torch.cuda.device_count())
    return resolve_device(want)


def init_distributed(device=None):
    """(group, device): the default process group, started here if no
    group is running, and this rank's device (`rank_device`, made the
    current CUDA device). torchrun's environment (`RANK`, `WORLD_SIZE`,
    `MASTER_ADDR`, `MASTER_PORT`, `LOCAL_RANK`) gives the rendezvous;
    without it the group is this process alone, over a `HashStore`. CUDA
    takes NCCL, the CPU gloo. Build the network on the returned device (or
    the mesh's): under torchrun it is not `cuda:0` on every rank."""
    import torch.distributed as dist

    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this "
                           "PyTorch build")
    if dist.is_initialized():
        have = str(dist.get_backend())
        if have != backend:
            raise RuntimeError(
                f"the running process group uses {have}, but a {dev.type} "
                f"mesh needs {backend}")
        return dist.group.WORLD, dev
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError(
            "data-parallel training on CUDA needs the NCCL backend, which "
            "this PyTorch build lacks (there is no gloo fallback on the "
            "card)")
    if _torchrun():
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dist.group.WORLD, dev


def _axis_groups(shape: Dict[str, int], group) -> Dict[str, object]:
    """One sub-group per axis that does not span the whole mesh, for this
    rank. `new_group` is collective over the default group: every process
    creates every sub-group, in one order (axes, then the other axes'
    coordinates row-major), the ones it is not in too (a mesh over a
    sub-group needs no sub-group of its own only when it has one rank)."""
    import torch.distributed as dist

    n = math.prod(shape.values())
    axes = list(shape)
    ranks = [dist.get_global_rank(group, r) if group is not dist.group.WORLD
             else r for r in range(n)]
    me = dist.get_rank(group)
    grid = np.arange(n).reshape([shape[a] for a in axes])
    out = {}
    for i, axis in enumerate(axes):
        if shape[axis] == n:
            continue
        moved = np.moveaxis(grid, i, -1).reshape(-1, shape[axis])
        for row in moved:
            sub = dist.new_group([ranks[int(r)] for r in row])
            if me in row:
                out[axis] = sub
    return out


def make_mesh(shape: Optional[Dict[str, int]] = None, device=None,
              group=None, order: Optional[Sequence[str]] = None) -> Mesh:
    """A Mesh of `{axis: size}` over the ranks of `group` (the default
    group, started by `init_distributed` when None); `-1` for one axis
    means every remaining rank. Default: data parallelism over every rank.
    The sizes must multiply to the group's size. The axes are laid out in
    `order`, else in AXIS_ORDER ("pp", "dp", "ep", "sp", "tp") with other
    names ("batch", "model", ...) after them in the order given; the
    first is outermost."""
    import torch.distributed as dist

    if group is None:
        group, dev = init_distributed(device)
    else:
        dev = rank_device(device)
    n = dist.get_world_size(group)
    shape = dict(shape) if shape else {DP_AXIS: n}
    fills = [a for a, s in shape.items() if s == -1]
    if len(fills) > 1:
        raise ValueError("at most one axis may be -1")
    fixed = math.prod(s for s in shape.values() if s != -1)
    if fills:
        if n % fixed:
            raise ValueError(f"{n} ranks not divisible by {fixed}")
        shape[fills[0]] = n // fixed
    total = math.prod(shape.values())
    if total != n:
        raise ValueError(f"mesh {shape} needs {total} ranks, the process "
                         f"group has {n}")
    if order is None:
        axes = [a for a in AXIS_ORDER if a in shape]
        axes += [a for a in shape if a not in axes]
    else:
        axes = list(order)
        if sorted(axes) != sorted(shape):
            raise ValueError(f"order {axes} does not name the axes of "
                             f"{shape}")
    shape = {a: shape[a] for a in axes}
    return Mesh(shape, group, dev, _axis_groups(shape, group))


#: the serving mesh's one axis (the JAX package's `SERVE_AXIS`)
SERVE_AXIS = "batch"


def serve_mesh(device=None, group=None) -> Mesh:
    """The 1-D ("batch",) mesh over every rank of `group` (the default
    group, started by `init_distributed`): rows of a served batch split
    over the ranks, params whole on each. Without torchrun it is a group
    of one over a `HashStore`, as the JAX package's degrades to a mesh of
    one device."""
    return make_mesh({SERVE_AXIS: -1}, device=device, group=group)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh: Mesh, axis: str = DP_AXIS) -> Sharding:
    """Shard the leading (batch) dimension over `axis`."""
    return Sharding(mesh, (axis,))


def batch_tensor(a) -> torch.Tensor:
    """An array of a batch as a tensor where it lies (float64 becomes
    float32)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a))


def shard_batch(mesh: Mesh, arrays, axis: str = DP_AXIS):
    """This rank's contiguous slice of each array's leading dim, as a
    tensor on the mesh's device (float64 becomes float32): rank r of n
    takes rows [r·b/n, (r+1)·b/n), the rows `P(axis)` places on device r
    in the JAX package. A leading dim that n does not divide raises.
    `arrays` is one array or a tuple or list of them."""
    n = mesh.shape[axis]
    r = mesh.coord(axis)

    def one(a):
        t = batch_tensor(a)
        b = int(t.shape[0])
        if b % n:
            raise ValueError(f"leading dim {b} is not divisible by the "
                             f"{n}-rank '{axis}' axis")
        k = b // n
        return t[r * k:(r + 1) * k].to(mesh.device)

    if isinstance(arrays, (tuple, list)):
        return type(arrays)(one(a) for a in arrays)
    return one(arrays)
