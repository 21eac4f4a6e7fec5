"""Device selection and the metric recorder."""

from .device import configure_precision, resolve_device
from .metrics import MetricsRecorder

__all__ = ["MetricsRecorder", "configure_precision", "resolve_device"]
