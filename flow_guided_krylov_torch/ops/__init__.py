"""Determinant bit algebra and Slater-Condon kernels.

The ELL SpMV lives in the ``ell_spmv`` submodule, which is not re-exported
here so that its name stays the module's.
"""

from .bits import from_keys_np, keys_np, pack_device, pack_np, unpack_np
from .excitations import (ExcitationSpec, build_excitation_spec,
                          connection_count)
from .slater import (SlaterTables, build_tables, connections_batch_np,
                     diagonal_batch, diagonal_batch_np, make_connection_fn,
                     make_connection_fn_auto, make_connection_fn_w2)

__all__ = [
    "pack_np", "unpack_np", "keys_np", "from_keys_np", "pack_device",
    "ExcitationSpec", "build_excitation_spec", "connection_count",
    "SlaterTables", "build_tables", "connections_batch_np",
    "diagonal_batch", "diagonal_batch_np", "make_connection_fn",
    "make_connection_fn_w2", "make_connection_fn_auto",
]
