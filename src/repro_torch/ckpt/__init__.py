"""Checkpoints of a train state (``repro.ckpt``)."""
from .checkpoint import CheckpointConfig, CheckpointManager  # noqa: F401
