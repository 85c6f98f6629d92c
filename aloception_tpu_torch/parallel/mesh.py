"""Device meshes (counterpart of ``aloception_tpu/parallel/mesh.py``).

The JAX package lays its chips out as a ``jax.sharding.Mesh``; here the
processes of the default process group form a
``torch.distributed.device_mesh.DeviceMesh`` with the same four axes:

- ``dp``: data parallel (each rank steps its rows of the global batch; the
  gradients are averaged);
- ``pp``: pipeline parallel (``pipeline.gpipe``: each rank holds a
  contiguous slice of a layer stack);
- ``sp``: sequence parallel (the encoders split their tokens over the axis
  by ``shard.constrain_tokens``);
- ``tp``: tensor parallel (wide Linears column-parallel, their outputs
  gathered).

Without a process group there is no mesh: ``make_mesh`` returns None, which
every function of the package reads as the mesh of one. Code that reads the
mesh without being handed one (the criteria's counts, the encoders' token
split, RAFT's BatchNorm) reads the one that ``use_mesh`` entered, as the JAX
package's models read the mesh of ``with mesh:``.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional, Tuple

import torch.distributed as dist

AXES = ("dp", "pp", "sp", "tp")

_CURRENT = contextvars.ContextVar("aloception_tpu_torch_mesh", default=None)


def default_mesh_shape(n_devices: Optional[int] = None,
                       tp: Optional[int] = None,
                       sp: Optional[int] = None,
                       pp: Optional[int] = None
                       ) -> Tuple[int, int, int, int]:
    """(dp, pp, sp, tp) over ``n_devices`` (the world size by default):
    pure data parallelism unless tp, sp or pp is given."""
    if n_devices is None:
        n_devices = dist.get_world_size() \
            if dist.is_available() and dist.is_initialized() else 1
    tp, sp, pp = tp or 1, sp or 1, pp or 1
    assert n_devices % (tp * sp * pp) == 0, \
        f"{n_devices} devices not divisible by pp={pp} * sp={sp} * tp={tp}"
    return (n_devices // (tp * sp * pp), pp, sp, tp)


def make_mesh(tp: Optional[int] = None, sp: Optional[int] = None,
              pp: Optional[int] = None):
    """A ``DeviceMesh`` of the world with ``mesh_dim_names`` ("dp", "pp",
    "sp", "tp"), or None without a process group. Its device type is "cuda"
    on NCCL and "cpu" on gloo (whose all-reduce also takes CUDA tensors)."""
    if not (dist.is_available() and dist.is_initialized()):
        default_mesh_shape(1, tp, sp, pp)
        return None
    from torch.distributed.device_mesh import init_device_mesh
    shape = default_mesh_shape(None, tp, sp, pp)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=AXES)


def mesh_shape(mesh) -> Dict[str, int]:
    """{"dp": .., "pp": .., "sp": .., "tp": ..}; all 1 for None."""
    if mesh is None:
        return {a: 1 for a in AXES}
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(mesh, axis: str) -> int:
    return mesh_shape(mesh).get(axis, 1)


def axis_group(mesh, axis: str):
    """The process group of this rank along ``axis``, or None where the axis
    has one member."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


def axis_rank(mesh, axis: str) -> int:
    return 0 if axis_size(mesh, axis) == 1 else mesh.get_local_rank(axis)


def data_group(mesh):
    """The ranks that share this rank's pp and tp coordinates (dp x sp):
    the group over which gradients are averaged. The world's group where
    they are all the ranks (a world of one too), None without a mesh or
    where this rank is alone in it. Otherwise every rank creates every such
    group, in one order; the result is kept on the mesh."""
    shape = mesh_shape(mesh)
    if mesh is None:
        return None
    if shape["dp"] * shape["sp"] == dist.get_world_size():
        return dist.group.WORLD
    if shape["dp"] * shape["sp"] == 1:
        return None
    if not hasattr(mesh, "_alo_data_group"):
        ranks = mesh.mesh
        mine = None
        for i in range(shape["pp"]):
            for j in range(shape["tp"]):
                members = ranks[:, i, :, j].flatten().tolist()
                group = dist.new_group(members)
                if dist.get_rank() in members:
                    mine = group
        mesh._alo_data_group = mine
    return mesh._alo_data_group


@contextlib.contextmanager
def use_mesh(mesh):
    """Enter ``mesh`` for the code that reads it without being handed it
    (the JAX package's ``with mesh:``)."""
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)


def current_mesh():
    """The mesh ``use_mesh`` entered, or None."""
    return _CURRENT.get()
