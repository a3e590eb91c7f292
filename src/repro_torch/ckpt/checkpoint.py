"""Checkpoint save/restore: a port of ``repro.ckpt.checkpoint``, in its
format.

A checkpoint is one ``step_########.npz`` of flat keys ("params/embed",
"opt/m/layers/0/ln1", ...: the tree's dict keys and list indices joined by
"/") and a ``manifest.json`` (step, keys, dtypes, shapes, extra), each
written to a temporary name and renamed into place.  numpy has no
bfloat16: as the reference's ``ml_dtypes`` leaves do in ``np.savez``, a
bfloat16 leaf is written as 2-byte ``|V2`` records of its bits, and the
manifest names its dtype "bfloat16".  `restore` reads those records back
as bfloat16, bit for bit and without ``ml_dtypes``, from this port's
checkpoints and the reference's alike, and returns the tree with tensors on ``device``; a
reference checkpoint keeps the reference's layout (stacked body), which
`model.params_from_jax` and `optim.opt_state_from_jax` carry across.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from ..core.engine.kernels import check_device

_BF16 = "bfloat16"


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict[str, Any]) -> Any:
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(k.isdigit() for k in keys):
            return [fix(node[str(i)]) for i in range(len(keys))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def _to_numpy(x) -> tuple[np.ndarray, str]:
    """(array to write, manifest dtype) of one leaf."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(x)
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """One stored leaf as a tensor: 2-byte void records are bfloat16 bits
    (the only leaves numpy cannot name)."""
    if not arr.flags.c_contiguous:     # np.load's arrays are fresh, writable
        arr = np.ascontiguousarray(arr)
    if arr.dtype == np.dtype("V2"):
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def save(path: str, step: int, params: Any, opt_state: Any | None = None,
         extra: dict | None = None) -> None:
    os.makedirs(path, exist_ok=True)
    tree = {"params": params}
    if opt_state is not None:
        tree["opt"] = opt_state
    arrays, dtypes = {}, {}
    for k, v in _flatten(tree).items():
        arrays[k], dtypes[k] = _to_numpy(v)
    tmp = os.path.join(path, f"tmp_step_{step:08d}.npz")
    final = os.path.join(path, f"step_{step:08d}.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, final)
    manifest = {
        "step": step,
        "keys": sorted(arrays),
        "dtypes": dtypes,
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "extra": extra or {},
    }
    mtmp = os.path.join(path, "manifest.json.tmp")
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(mtmp, os.path.join(path, "manifest.json"))


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = [int(f[5:13]) for f in os.listdir(path)
             if f.startswith("step_") and f.endswith(".npz")]
    return max(steps) if steps else None


def restore(path: str, step: int | None = None, device="cuda"):
    """Returns (step, tree) with every leaf a tensor on ``device`` ("cuda"
    by default, which raises without a card): bfloat16 leaves restored
    from their 2-byte records, the rest in their numpy dtype."""
    check_device(device)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    with np.load(os.path.join(path, f"step_{step:08d}.npz")) as z:
        flat = {k: _to_tensor(z[k], device) for k in z.files}
    return step, _unflatten(flat)
