"""Serving engine of the port: greedy generation and slot batching."""

from .engine import (Batcher, ServeConfig, greedy_generate,  # noqa: F401
                     make_decode_fn, pad_prefill_state)
