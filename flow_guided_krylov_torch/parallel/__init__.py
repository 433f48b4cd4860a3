"""The multi-device layer: a ('data', 'basis') mesh held in one process and
the row- and statevector-sharded products over it.

Counterpart of ``flow_guided_krylov_tpu/parallel/``.
"""

from .mesh import Mesh, gather, make_mesh, peer_bytes, split_rows
from .sharded_matvec import (RowBlocks, ShardedEll,
                             shard_hamiltonian_rows,
                             sharded_lanczos_expm,
                             sharded_lanczos_ground_state,
                             sharded_matvec_fn)
from .sharded_trotter import (gather_statevector, make_sharded_substep,
                              mesh_supports_statevector, shard_statevector)

__all__ = ["Mesh", "make_mesh", "split_rows", "gather", "peer_bytes",
           "RowBlocks", "ShardedEll", "shard_hamiltonian_rows",
           "sharded_matvec_fn", "sharded_lanczos_expm",
           "sharded_lanczos_ground_state", "make_sharded_substep",
           "mesh_supports_statevector", "shard_statevector",
           "gather_statevector"]
