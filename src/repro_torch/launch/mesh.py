"""The (data, model) mesh over ``torch.distributed`` ranks.

Port of ``repro/launch/mesh.py``.  ``make_elastic_mesh``: the largest
(data, model) mesh with ``model <= model_parallel`` that divides the
world.  The world is the default process group, which the caller starts
(``init_world`` reads what ``torch.distributed.run`` sets); a process
with no group is a world of one rank, whose mesh is (1, 1) and has no
groups.  Rank r sits at (r // model, r % model), the row-major layout of
``init_device_mesh``.

``make_production_mesh``: the reference's production extents, (16, 16)
``data × model`` or, multi-pod, (2, 16, 16) ``pod × data × model``, over
a world of that size (the dry run's is a ``fake`` process group,
``launch/dryrun.py``).  The ``pod`` axis is a mesh axis of its own, as
in the reference: the batch shards over ``("pod", "data")`` (the
``batch`` group), the Adam moments over ``data`` alone.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) mesh: parameters shard over ``model`` (the
    engine's packed weights too), the batch, the Adam moments (ZeRO-1)
    and paged KV pools over ``data``."""

    data: int = 1
    model: int = 1
    rank: int = 0
    backend: Optional[str] = None
    device_mesh: object = None          # torch DeviceMesh; None: one rank
    pod: int = 1
    batch_group: object = None          # the (pod, data) group, pod > 1

    @property
    def axis_names(self) -> tuple:
        return (("pod", "data", "model") if self.pod > 1
                else ("data", "model"))

    @property
    def shape(self) -> Dict[str, int]:
        dims = {"data": self.data, "model": self.model}
        return {"pod": self.pod, **dims} if self.pod > 1 else dims

    @property
    def size(self) -> int:
        return self.pod * self.data * self.model

    @property
    def data_rank(self) -> int:
        return (self.rank // self.model) % self.data

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def batch(self) -> int:
        """The batch axes' extent: pod × data."""
        return self.pod * self.data

    @property
    def batch_rank(self) -> int:
        return self.rank // self.model

    def group(self, axis: str):
        """The process group of this rank's row (``"model"``) or column
        (``"data"``) of the mesh, or of its (pod, data) plane
        (``"batch"``: the data column without a pod axis)."""
        if axis == "batch":
            if self.pod == 1:
                axis = "data"
            else:
                return self.batch_group
        return self.device_mesh.get_group(axis)

    def _host_side(self) -> torch.device:
        """Where a small control tensor lives for a collective: the
        rank's card under nccl, the CPU under gloo."""
        return (torch.device("cuda", torch.cuda.current_device())
                if self.backend == "nccl" else torch.device("cpu"))

    def from_root(self, values: List[float]) -> List[float]:
        """Rank 0's ``values`` on every rank (one broadcast over the
        world), so that a decision taken on a reading of rank 0's (its
        clock) is the same on every rank.  A world of one rank returns
        ``values`` as they are."""
        if self.size == 1:
            return list(values)
        t = torch.tensor(values, dtype=torch.float64,
                         device=self._host_side())
        dist.broadcast(t, src=0)
        return t.tolist()

    def any_rank(self, flags: List[bool]) -> List[bool]:
        """Each flag OR-ed over every rank of the world, so that a
        decision one rank's own state prompts is taken on every rank
        (every rank passes the same number of flags, in the same order).
        A world of one rank returns ``flags`` as they are."""
        if self.size == 1 or not flags:
            return list(flags)
        t = torch.tensor([int(f) for f in flags], dtype=torch.int32,
                         device=self._host_side())
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return [bool(v) for v in t.tolist()]


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


_MESHES: Dict[tuple, Mesh] = {}


def make_elastic_mesh(model_parallel: int = 1,
                      device_type: str = "cpu") -> Mesh:
    """The largest (data, model) mesh the world allows with ``model <=
    model_parallel``.  Each shape's ``DeviceMesh`` is made once per
    process (every rank must build the same meshes in the same order:
    making one is collective) and reused."""
    n = world_size()
    mp = max(1, min(model_parallel, n))
    while n % mp:
        mp -= 1
    if n == 1:
        return Mesh()
    from torch.distributed.device_mesh import init_device_mesh
    backend = dist.get_backend()
    key = (device_type, n // mp, mp, backend)
    if key not in _MESHES:
        dm = init_device_mesh(device_type, (n // mp, mp),
                              mesh_dim_names=("data", "model"),
                              backend_override={"data": backend,
                                                "model": backend})
        _MESHES[key] = Mesh(n // mp, mp, dist.get_rank(), backend, dm)
    return _MESHES[key]


def make_production_mesh(multi_pod: bool = False,
                         device_type: str = "cpu") -> Mesh:
    """The reference's production mesh over the current world, which
    must have its size: (16, 16) ``data × model``, or with ``multi_pod``
    (2, 16, 16) ``pod × data × model``.  Made once per process and
    reused, as ``make_elastic_mesh``'s meshes."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    n = world_size()
    if n != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs a world of "
                         f"{math.prod(shape)} ranks, this one has {n}")
    key = (device_type, shape, dist.get_backend())
    if key not in _MESHES:
        from torch.distributed.device_mesh import init_device_mesh
        names = ("pod", "data", "model") if multi_pod else ("data", "model")
        dm = init_device_mesh(device_type, shape, mesh_dim_names=names)
        batch = (dm["pod", "data"]._flatten("batch").get_group()
                 if multi_pod else None)
        _MESHES[key] = Mesh(shape[-2], shape[-1], dist.get_rank(),
                            dist.get_backend(), dm,
                            pod=shape[0] if multi_pod else 1,
                            batch_group=batch)
    return _MESHES[key]


def mesh_tag(mesh: Mesh) -> str:
    """The mesh's extents joined by ``x`` (``16x16``, ``2x16x16``), the
    reference's record name."""
    return "x".join(str(n) for n in mesh.shape.values())


def init_world(backend: str, device: str = "cuda") -> torch.device:
    """Join the world ``torch.distributed.run`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``)
    with ``backend`` and return the device this rank serves on.

    ``nccl``: rank r runs on ``cuda:LOCAL_RANK``, one card per rank; a
    host with fewer cards than ranks raises (name ``--dist-backend
    gloo`` to share cards).  ``gloo``: every rank runs on ``device`` as
    named (``cuda`` is the current card, so one card can host the whole
    world; ``cpu`` the CPU); its collectives copy through host memory.
    Nothing here picks another backend or device by itself."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if backend == "nccl":
        if torch.device(device).type != "cuda":
            raise ValueError("nccl serves on cuda devices only")
        cards = torch.cuda.device_count()
        if local >= cards:
            raise RuntimeError(
                f"nccl puts each rank on its own card: local rank {local} "
                f"has no cuda:{local} ({cards} card(s) on this host); "
                f"run fewer ranks per host, or --dist-backend gloo to put "
                f"several ranks on one card")
        dev = torch.device("cuda", local)
    else:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cuda":
        # DeviceMesh leaves the device alone once it is set
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                world_size=world, rank=rank)
    return dev
