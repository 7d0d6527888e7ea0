"""Synthetic token data for training (``repro.data``)."""
from .pipeline import DataConfig, SyntheticLMData, to_device  # noqa: F401
