"""Sequence / head / data parallel layer (counterpart of
``sageattention_tpu/parallel``), as ``torch.distributed`` code."""

from .mesh import make_mesh, head_sharded, seq_sharded, DP, SP, TP
from .ring import ring_sageattn
from .ulysses import ulysses_sageattn

__all__ = ["make_mesh", "head_sharded", "seq_sharded", "DP", "SP", "TP",
           "ring_sageattn", "ulysses_sageattn"]
