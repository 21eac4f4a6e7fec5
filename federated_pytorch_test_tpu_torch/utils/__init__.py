"""Device selection, the metric recorder and checkpoints."""

from .checkpoint import checkpoint_path, load_checkpoint, save_checkpoint
from .device import configure_precision, resolve_device
from .metrics import MetricsRecorder

__all__ = [
    "MetricsRecorder",
    "checkpoint_path",
    "configure_precision",
    "load_checkpoint",
    "resolve_device",
    "save_checkpoint",
]
