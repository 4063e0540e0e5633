"""dp x tp parallelism: the device mesh and sharding rules (``mesh.py``),
the tensor-parallel collectives and decoder layer (``tp.py``) and the
sharded T2S fine-tuning step (``train.py``)."""
from .mesh import DP_AXIS, TP_AXIS

__all__ = ["DP_AXIS", "TP_AXIS"]
