"""Memory sizing, the device connection table, checkpoints and resume,
profiling, and the formula-based pipeline sizing (``system_scaler``)."""

from .checkpoint import CheckpointManager, load_checkpoint, save_checkpoint
from .connection_table import DeviceConnectionTable, build_connection_table
from .memory import MemoryBudget, device_memory_bytes
from .profiling import StageTimer, device_memory_stats, trace
from .system_scaler import (AdaptiveAdjuster, QualityPreset, SystemScaler,
                            SystemTier, auto_scale_pipeline,
                            create_pipeline_config)

__all__ = [
    "SystemScaler", "SystemTier", "QualityPreset", "AdaptiveAdjuster",
    "create_pipeline_config", "auto_scale_pipeline",
    "CheckpointManager", "save_checkpoint", "load_checkpoint",
    "DeviceConnectionTable", "build_connection_table",
    "StageTimer", "trace", "device_memory_stats",
    "MemoryBudget", "device_memory_bytes",
]
