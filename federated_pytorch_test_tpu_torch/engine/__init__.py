"""Experiment engine: configuration, step functions and the trainer."""

from .config import PRESETS, ExperimentConfig, get_preset
from .trainer import Trainer

__all__ = ["PRESETS", "ExperimentConfig", "Trainer", "get_preset"]
