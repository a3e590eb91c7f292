"""AdamW with float32 master weights, and int8 gradient compression
(ports of ``repro.optim``)."""

from .adamw import (AdamWConfig, apply_updates, init_state,
                    opt_state_from_jax, schedule, tree_leaves, tree_map)
from .compression import (compressed_psum, compressed_psum_tree, dequantize,
                          quantize_int8)

__all__ = ["AdamWConfig", "apply_updates", "compressed_psum",
           "compressed_psum_tree", "dequantize", "init_state",
           "opt_state_from_jax", "quantize_int8", "schedule", "tree_leaves",
           "tree_map"]
