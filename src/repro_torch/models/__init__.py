"""Decoder models of the port: ``layers`` (building blocks) and ``model``
(config, params, forward / prefill / decode)."""
