"""Training across a torch.distributed world: the ("data", "model")
mesh, its sharding rules (``sharding``), the collectives and sharded
layers that carry them out (``spmd``), joining a world
(``distributed``), and a CPU rehearsal of every regime
(``dryrun.dryrun_multichip``)."""

from .distributed import initialize, is_primary
from .sharding import (batch_sharding, make_mesh, param_shardings,
                       replicated_sharding, shard_batch_local)

__all__ = ["make_mesh", "batch_sharding", "replicated_sharding",
           "param_shardings", "shard_batch_local",
           "initialize", "is_primary"]
