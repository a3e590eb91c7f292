"""Deterministic synthetic data (a port of ``repro.data``)."""

from .pipeline import DataConfig, batch_specs, make_batch

__all__ = ["DataConfig", "batch_specs", "make_batch"]
