"""The ('data', 'views') mesh of processes, and the collectives of the port.

Counterpart of ``elasticdiffusion_tpu/parallel/sharding.py``. The JAX package
shards arrays over a ``Mesh`` of devices and XLA inserts the collectives.
Here every rank of the mesh is a process with one GPU that runs the same
host code, and the collectives are ``torch.distributed``'s, issued by hand:

  - weights are replicated: ``put_replicated`` broadcasts every parameter
    and buffer from the mesh's first rank;
  - the one merged UNet batch of an estimator is padded to the width of the
    'views' axis by repeating its leading rows (``pad_rows_to_mesh``) and
    split over 'views': each rank runs its contiguous slice, and
    ``all_gather`` hands every rank the whole output (``sharded_call``);
  - the latent is replicated by construction: every rank draws it, and every
    random number after it, from the same seeded generators, and gets every
    estimator's output whole. So ``shard_views`` and ``replicate_mesh`` have
    no counterpart;
  - the 'data' axis places nothing, as in the JAX package, whose
    ``shard_batch`` has no caller: ranks that differ only in 'data' hold the
    same 'views' index and compute the same rows. ``shard_batch`` has no
    counterpart either.

Three collectives are used, always on this module's helpers:
``all_gather`` (the list form), ``all_reduce`` and ``broadcast``. The gloo
backend takes CUDA tensors for all three (torch 2.11, two ranks on one
H100), so no collective is staged through host memory. Each call is counted
in ``collective_inventory``, the counterpart of the JAX package's count of
collectives in the compiled HLO, with its route: the backend and the device
of its tensors.
"""

from __future__ import annotations

import collections
import datetime
import math
import os
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

# a rank that dies fails its peers' next collective after this long
TIMEOUT = datetime.timedelta(minutes=10)

_inventory: Dict[str, collections.Counter] = collections.defaultdict(
    collections.Counter)


def make_mesh(shape: Tuple[int, ...] = (1, 1),
              axis_names: Tuple[str, ...] = ("data", "views"),
              backend: Optional[str] = None,
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` of the processes of this job with dims `axis_names`,
    ranks laid out row-major over `shape`; None when the shape holds one
    rank. The default process group is used when one exists, else it is
    initialised from the ``torchrun`` environment (``env://``) with
    `backend` (``"nccl"`` for CUDA, ``"gloo"`` for the CPU) and a finite
    timeout. On CUDA each rank takes ``cuda:{LOCAL_RANK % device_count}``.
    `device_type` defaults to ``"cuda"``."""
    shape = tuple(int(n) for n in shape)
    n = math.prod(shape)
    if n <= 1:
        return None
    device_type = device_type or "cuda"
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    world = dist.get_world_size() if dist.is_initialized() \
        else int(os.environ.get("WORLD_SIZE", "1"))
    if world != n:
        raise ValueError(f"mesh {'x'.join(map(str, shape))} needs {n} "
                         f"processes, the world has {world}")
    if dist.is_initialized() and dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"not {backend!r}")
    if device_type == "cuda":
        rank = dist.get_rank() if dist.is_initialized() \
            else int(os.environ.get("RANK", "0"))
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                timeout=TIMEOUT)
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_names))


def auto_mesh_shape(num_devices: int) -> Tuple[int, int]:
    """Every rank on the 'views' axis, the dominant fan-out."""
    return (1, num_devices)


def views_size(mesh) -> int:
    """Width of the mesh's 'views' axis (1 without a mesh or the axis)."""
    if mesh is None or "views" not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index("views"))


def views_rank(mesh) -> int:
    """This rank's index along 'views' (0 without a mesh or the axis)."""
    return 0 if views_size(mesh) == 1 else mesh.get_local_rank("views")


def is_first_rank() -> bool:
    """Whether this process is the job's first rank, the one that writes
    files (True without a process group). ``make_mesh`` lays a mesh's
    ranks out from it."""
    return not dist.is_initialized() or dist.get_rank() == 0


def view_pad_rows(n: int, mesh) -> int:
    """Rows to append so a leading axis of size n divides the views width."""
    return (-n) % views_size(mesh)


def pad_rows_to_mesh(x: torch.Tensor, mesh) -> torch.Tensor:
    """Pad the leading axis to a multiple of the views width by repeating
    the leading rows (x itself when nothing is missing). Where more rows are
    missing than x has, its rows repeat in turn; the JAX package's
    ``x[:pad]`` then falls short of the width and its batch stays
    replicated."""
    pad = view_pad_rows(x.shape[0], mesh)
    if not pad:
        return x
    idx = torch.arange(pad, device=x.device) % x.shape[0]
    return torch.cat([x, x[idx]])


def _note(name: str, x: torch.Tensor, group) -> None:
    route = f"{dist.get_backend(group)}:{x.device.type}"
    inv = _inventory[name]
    inv["count"] += 1
    inv["bytes"] += x.numel() * x.element_size()
    inv["route " + route] += 1


def collective_inventory() -> Dict[str, dict]:
    """Each collective issued since the last reset: calls (``count``),
    bytes of this rank's input tensors (``bytes``) and its routes, the
    backend and the device of the tensors (``routes``)."""
    return {name: {"count": c["count"], "bytes": c["bytes"],
                   "routes": {k[6:]: v for k, v in c.items()
                              if k.startswith("route ")}}
            for name, c in sorted(_inventory.items())}


def reset_collective_inventory() -> None:
    _inventory.clear()


def all_gather_views(x: torch.Tensor, mesh) -> List[torch.Tensor]:
    """x of every rank of this rank's 'views' group, in rank order."""
    group = mesh.get_group("views")
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(views_size(mesh))]
    dist.all_gather(out, x, group=group)
    _note("all_gather", x, group)
    return out


def all_reduce_views(x: torch.Tensor, mesh) -> torch.Tensor:
    """x summed over this rank's 'views' group, in place."""
    group = mesh.get_group("views")
    dist.all_reduce(x, group=group)
    _note("all_reduce", x, group)
    return x


def sharded_call(fn, mesh, *batched, **kw):
    """``fn(*batched, **kw)`` with the batch split over 'views': every
    batched input (None passes through) is padded by ``pad_rows_to_mesh``,
    this rank runs ``fn`` on its contiguous slice of rows / views width,
    and the outputs of the 'views' group, gathered in rank order, are
    joined and cut back to the true rows. Without a mesh, or with a views
    width of 1, it is ``fn(*batched, **kw)``."""
    n = views_size(mesh)
    if n == 1:
        return fn(*batched, **kw)
    rows = batched[0].shape[0]
    per = (rows + view_pad_rows(rows, mesh)) // n
    lo = views_rank(mesh) * per
    parts = [None if a is None else pad_rows_to_mesh(a, mesh)[lo:lo + per]
             for a in batched]
    return torch.cat(all_gather_views(fn(*parts, **kw), mesh))[:rows]


@torch.no_grad()
def put_replicated(module: torch.nn.Module, mesh) -> None:
    """Broadcast every parameter and buffer of `module` from the mesh's
    first rank, in place, over the default group (the mesh's ranks are the
    whole job): every replica then holds the first rank's weights."""
    if mesh is None:
        return
    src = int(mesh.mesh.flatten()[0])
    for t in (*module.parameters(), *module.buffers()):
        dist.broadcast(t.data, src)
        _note("broadcast", t, None)
