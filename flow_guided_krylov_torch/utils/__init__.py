"""Memory sizing, the device connection table, the native build helper
and the formula-based pipeline sizing (``system_scaler``)."""

from .connection_table import DeviceConnectionTable, build_connection_table
from .memory import MemoryBudget, device_memory_bytes
from .system_scaler import (AdaptiveAdjuster, QualityPreset, SystemScaler,
                            SystemTier, auto_scale_pipeline,
                            create_pipeline_config)

__all__ = ["DeviceConnectionTable", "build_connection_table",
           "MemoryBudget", "device_memory_bytes",
           "SystemScaler", "SystemTier", "QualityPreset", "AdaptiveAdjuster",
           "create_pipeline_config", "auto_scale_pipeline"]
