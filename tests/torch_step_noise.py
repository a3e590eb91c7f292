"""Where one family's sharded train step and the JAX package's differ most,
and how far each is from the step's float64 gradient there.

  PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_step_noise.py \
      granite3_8b [--tree DIR]

Runs the family's smoke step as ``tests/test_torch_sharded_dense.py`` does
(B=4, S=32, the 2x2 mesh; `torch_sharded_worker`'s ``jax`` and ``train``
modes, the port's from ``DIR/src`` when ``--tree`` names another checkout)
and prints, for the leaf and element where the port's sharded parameters
differ most from the JAX package's sharded step: the relative difference
the test holds to ``STEP_TOL`` (sharded port against JAX, and against the
plain port), and the element's gradient in float64 (the port's plain step
on float64 tensors), in float32 from the port's plain step, from the JAX
package's unsharded ``loss_fn`` and (its clip and first moment undone)
from the JAX package's sharded step.  Adam's first update of an element
is g / (|g| + eps), so where |g| is near eps the update follows the
rounding of g.
"""

from __future__ import annotations

import argparse
import atexit
import dataclasses
import os
import shutil
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("--tree", default=os.path.join(HERE, ".."),
                    help="the checkout whose port and worker run the step")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path[:0] = [os.path.join(tree, "tests"), os.path.join(tree, "src")]
    import torch
    import torch.utils._pytree as pt

    import torch_sharded_worker as W
    from repro_torch import configs
    from repro_torch.launch.sharding import tree_items
    from repro_torch.models import model as TM
    from repro_torch.train.step import loss_and_grads
    from test_torch_sharded import _jax_leaves, _rel
    from test_torch_train import STEP_TOL, _ref_tree

    arch = args.arch
    cfg = configs.get_smoke(arch)
    tmp = tempfile.mkdtemp(prefix="step_noise_")
    atexit.register(shutil.rmtree, tmp, True)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.float32)
    W.write_inputs(tmp, {arch: _ref_tree(cfg, params)})
    W.finish(W.start("jax", tmp, [arch]) + W.start("train", tmp, [arch]),
             timeout=600)
    jax = W.load(tmp, f"jax_{arch}.pkl")
    r = W.load(tmp, "train0.pkl")[arch]

    worst = (0.0, None, None)
    for key, tol in STEP_TOL.items():
        want = _jax_leaves(cfg, jax[key])
        for path, x in r["sharded"][key].items():
            e = _rel(x, want[path]) / tol
            if e > worst[0]:
                worst = (e, key, path)
    _e, key, path = worst
    want = _jax_leaves(cfg, jax[key])[path]
    got = r["sharded"][key][path]
    at = np.unravel_index(np.abs(got - want).argmax(), got.shape)
    print(f"{arch}: worst leaf {key}/{path} at {tuple(int(i) for i in at)}: "
          f"sharded port vs JAX sharded {_rel(got, want):.6g} "
          f"(STEP_TOL {STEP_TOL[key]}), sharded vs plain port "
          f"{_rel(got, r['plain'][key][path]):.6g}")

    d = W.load(tmp, "in.pkl")[arch]
    batch = {k: torch.from_numpy(v) for k, v in d["batch"].items()}

    def leaf(tree) -> np.ndarray:
        """``path``'s leaf of a tree in the port's layout."""
        return next(x for q, x in tree_items(tree)
                    if "/".join(map(str, q)) == path)
    grads = {}
    for dt in (torch.float32, torch.float64):
        p = pt.tree_map(lambda t: t.to(dt) if t.is_floating_point() else t,
                        TM.params_from_jax(cfg, d["tree"], device="cpu"))
        b = {k: (v.to(dt) if v.is_floating_point() else v)
             for k, v in batch.items()}
        _loss, gl = loss_and_grads(p, cfg, b)
        names = ["/".join(map(str, q)) for q, _ in tree_items(p)]
        grads[dt] = gl[names.index(path)].double().numpy()
    g64, g32 = grads[torch.float64][at], grads[torch.float32][at]
    # the first moment after one step is (1 - beta1) clip g: the clip
    # from the port's own moment and gradient where g is large
    m_port = r["plain"]["m"][path].astype(np.float64)
    big = np.abs(grads[torch.float32]) > 1e-3
    clip = float(np.median(m_port[big] / (0.1 * grads[torch.float32][big])))
    g_jax_sharded = float(_jax_leaves(cfg, jax["m"])[path][at]) / (0.1 * clip)

    import jax as J
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import model as JM
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), remat=False)
    jparams = J.tree.map(jnp.asarray, d["tree"])
    jbatch = {k: jnp.asarray(v) for k, v in d["batch"].items()}
    jg = J.grad(lambda q: JM.loss_fn(q, jcfg, jbatch))(jparams)
    g_jax = float(leaf(TM.params_from_jax(cfg, J.tree.map(np.asarray, jg),
                                          device="cpu"))[at])
    gmax = float(np.abs(grads[torch.float64]).max())
    print(f"  gradient at it: float64 {g64:.6g}, port float32 {g32:.6g}, "
          f"JAX unsharded {g_jax:.6g}, JAX sharded {g_jax_sharded:.6g} "
          f"(clip {clip:.6g}; the leaf's largest |g| {gmax:.6g})")
    eps = 1e-8
    for name, g in (("float64", g64), ("port", g32),
                    ("JAX sharded", g_jax_sharded)):
        gc = g * clip
        print(f"  Adam's first update there, {name}: "
              f"{gc / (abs(gc) + eps):.6g}")


if __name__ == "__main__":
    main()
