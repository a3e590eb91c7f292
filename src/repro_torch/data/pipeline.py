"""Deterministic synthetic data pipeline: a port of ``repro.data.pipeline``.

A batch is a pure function of (seed, step, arch), drawn with the
reference's numpy stream, so tokens, labels and patches are identical to
the reference's; that is what makes checkpoint/restart exactly
replayable: a restarted run consumes the identical token stream with no
data-loader state to persist.  `make_batch` returns tensors on
``device`` ("cuda" by default, which raises without a card).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.engine.kernels import check_device
from ..models.model import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    # zipf-ish unigram skew so losses move like real text rather than
    # uniform noise
    zipf_alpha: float = 1.1


def batch_specs(cfg: ArchConfig, batch: int, seq: int) -> dict:
    """{name: (shape, torch dtype)} of one training batch."""
    tok_shape = ((batch, seq, cfg.n_codebooks) if cfg.n_codebooks > 1
                 else (batch, seq))
    specs = {"tokens": (tok_shape, torch.int32),
             "labels": (tok_shape, torch.int32)}
    if cfg.vlm_patches:
        specs["patches"] = ((batch, cfg.vlm_patches, cfg.d_model),
                            torch.bfloat16)
    return specs


def make_batch(cfg: ArchConfig, dcfg: DataConfig, step: int, batch: int,
               seq: int, rows: slice | None = None,
               device="cuda") -> dict:
    """The batch for ``step``: tokens and labels int32 (the labels are the
    tokens shifted by one), and a vision model's patches bfloat16."""
    check_device(device)
    rng = np.random.default_rng((dcfg.seed, step))
    b = batch if rows is None else (rows.stop - rows.start)
    # zipf-ish unigram distribution over the vocab
    ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
    probs = ranks ** (-dcfg.zipf_alpha)
    probs /= probs.sum()
    shape = (b, seq + 1, cfg.n_codebooks) if cfg.n_codebooks > 1 else (b, seq + 1)
    toks = rng.choice(cfg.vocab, size=shape, p=probs).astype(np.int32)
    out = {"tokens": torch.from_numpy(np.ascontiguousarray(toks[:, :seq])),
           "labels": torch.from_numpy(np.ascontiguousarray(toks[:, 1:]))}
    if cfg.vlm_patches:
        patches = rng.standard_normal(
            (b, cfg.vlm_patches, cfg.d_model)).astype(np.float32)
        out["patches"] = torch.from_numpy(patches).to(torch.bfloat16)
    return {k: v.to(device) for k, v in out.items()}
