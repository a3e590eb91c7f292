"""Checkpoint save/restore (a port of ``repro.ckpt``)."""

from .checkpoint import latest_step, restore, save

__all__ = ["latest_step", "restore", "save"]
