"""Memory sizing, the device connection table and the native build helper."""

from .connection_table import DeviceConnectionTable, build_connection_table
from .memory import MemoryBudget, device_memory_bytes

__all__ = ["DeviceConnectionTable", "build_connection_table",
           "MemoryBudget", "device_memory_bytes"]
