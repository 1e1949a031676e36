"""The multi-device mesh: one process per device on ``torch.distributed``.

Counterpart of ``csdr_tpu/parallel``: the ('time', 'ch') ``DeviceMesh``
(``mesh.py``), the time-sharded flagship kernel (``flagship.py``), the
channel- and time-sharded channelized FM receiver (``channelized.py``),
the generic sharded chain of any Block graph in the time layout
(``generic.py``), their streaming runner (``runner.py``) and a one-step
dry run (``dryrun.py``).
"""

from .channelized import ShardedChannelizedFM
from .dryrun import dryrun_multichip
from .flagship import ShardedFlagship
from .generic import ShardedChain
from .mesh import build_mesh, init_distributed, make_mesh, mesh_shape, spawn
from .runner import ShardedPipeline

__all__ = ["ShardedChain", "ShardedChannelizedFM", "ShardedFlagship", "ShardedPipeline",
           "build_mesh", "dryrun_multichip", "init_distributed", "make_mesh", "mesh_shape",
           "spawn"]
