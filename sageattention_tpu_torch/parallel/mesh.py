"""Mesh helpers and axis-name conventions (counterpart of
``sageattention_tpu/parallel/mesh.py``).

A ``torch.distributed`` device mesh over the process group's ranks with
three named dimensions:

  - "dp": data / CFG-batch parallel (xDiT ``use_cfg_parallel``)
  - "sp": sequence (context) parallel: the ring or Ulysses
  - "tp": head parallel

The JAX ``PartitionSpec``s of :func:`head_sharded` and :func:`seq_sharded`
become DTensor placements, one per mesh dimension.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

DP, SP, TP = "dp", "sp", "tp"


def make_mesh(dp: int = 1, sp: Optional[int] = None, tp: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """Build a (dp, sp, tp) mesh over the initialised process group's
    ranks; ``sp`` defaults to all remaining ranks."""
    n = dist.get_world_size()
    if sp is None:
        assert n % (dp * tp) == 0, (n, dp, tp)
        sp = n // (dp * tp)
    assert dp * sp * tp == n, f"mesh {dp}x{sp}x{tp} != {n} devices"
    return init_device_mesh(device_type, (dp, sp, tp), mesh_dim_names=(DP, SP, TP))


def _placements(layout: str, seq: bool):
    """Placements over (dp, sp, tp): batch over dp, heads over tp (axis 1 in
    HND, 2 in NHD), and with ``seq`` the sequence over sp."""
    head_ax, seq_ax = (1, 2) if layout == "HND" else (2, 1)
    return (Shard(0), Shard(seq_ax) if seq else Replicate(), Shard(head_ax))


def head_sharded(mesh: DeviceMesh, layout: str = "HND"):
    """Shard attention heads over tp (batch over dp)."""
    return _placements(layout, seq=False)


def seq_sharded(mesh: DeviceMesh, layout: str = "HND"):
    """Shard the sequence over sp (batch over dp, heads over tp)."""
    return _placements(layout, seq=True)
