"""The five other dense families' sharded programs on a device mesh against
the JAX package's own sharded step and the port's plain calls, on the
CPU.

For the smoke configs of phi4-mini (head dim 12, tied embeddings),
granite (tied embeddings), codeqwen (qkv biases), qwen2-vl (M-RoPE, four
prepended patches) and musicgen (four codebooks, sinusoidal positions,
the plain GELU MLP), from the weights and batch of
``tests/test_torch_sharded.py`` (B=4, S=32; qwen2-vl's patches enter
through ``distribute_batch``), on the 2x2 ("data", "model") mesh:

  * the train step: the loss within 1e-5 and ``grad_norm`` within 1e-4
    (relative) of the JAX package's sharded step
    (`torch_sharded_worker.jax_train`), every leaf after the step within
    `STEP_TOL` (the tolerances gemma2's step is held to in
    ``tests/test_torch_sharded.py``), and the same against the port's
    unsharded step;
  * every leaf keeps its rule's placements; flash's region sees batch
    B / 2 and half the query heads, the sequence (patches included)
    whole, forward and backward;
  * with TP-only parameters: prefill and four decode steps within 1e-4 of
    the plain calls, and ``greedy_generate``'s tokens identical (but
    qwen2-vl, which it cannot serve: ROADMAP's serving quirks).

The JAX steps run in a process a family, the port's train and serve
steps in two groups of four gloo ranks, all started at once; the file
ends asserting that no process it started is alive.
"""

import numpy as np
import pytest
import torch

import torch_sharded_worker as W
from repro_torch import configs
from repro_torch.models import model as TM
from test_torch_sharded import _check_leaves, _check_metrics, _jax_leaves
from test_torch_train import _ref_tree

TOL = dict(rtol=0, atol=1e-4)
#: the processes this file started
STARTED: list = []


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    trees = {}
    for arch in W.DENSE:
        cfg = configs.get_smoke(arch)
        params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu", dtype=torch.float32)
        trees[arch] = _ref_tree(cfg, params)
    tmp = tmp_path_factory.mktemp("sharded_dense")
    W.write_inputs(tmp, trees)
    groups = [W.start("jax", tmp, W.DENSE), W.start("train", tmp, W.DENSE),
              W.start("serve", tmp, W.DENSE)]
    for procs in groups:
        STARTED.extend(procs)
    for procs in groups:
        W.finish(procs, timeout=300)
    train = [W.load(tmp, f"train{r}.pkl") for r in range(W.N_RANKS)]
    serve = [W.load(tmp, f"serve{r}.pkl") for r in range(W.N_RANKS)]
    return {arch: dict(jax=W.load(tmp, f"jax_{arch}.pkl"),
                       ranks=[r[arch] for r in train],
                       serve=[r[arch] for r in serve]) for arch in W.DENSE}


@pytest.mark.parametrize("arch", W.DENSE)
def test_sharded_step_matches_the_jax_sharded_step(runs, arch):
    cfg = configs.get_smoke(arch)
    jax, r = runs[arch]["jax"], runs[arch]["ranks"][0]
    assert jax["n_devices"] == 4
    _check_metrics({k: v for k, (v, _) in r["metrics"].items()},
                   jax["metrics"])
    want = {k: _jax_leaves(cfg, jax[k])
            for k in ("params", "m", "v", "master")}
    _check_leaves(r["sharded"], want)


@pytest.mark.parametrize("arch", W.DENSE)
def test_sharded_step_matches_the_unsharded_port(runs, arch):
    r = runs[arch]["ranks"][0]
    _check_metrics({k: v for k, (v, _) in r["metrics"].items()},
                   r["plain_metrics"])
    _check_leaves(r["sharded"], r["plain"])


@pytest.mark.parametrize("arch", W.DENSE)
def test_every_leaf_keeps_the_placements_of_its_rule(runs, arch):
    ranks = runs[arch]["ranks"]
    sharded_on = set()
    for key, leaves in ranks[0]["placements"].items():
        for path, (want, got) in leaves.items():
            assert got == want, (key, path)
            sharded_on.update(i for i, p in enumerate(got) if p != "R")
    assert sharded_on == {0, 1}
    for r in ranks:
        for value, placements in r["metrics"].values():
            assert placements == ["R", "R"]
        assert r["metrics"] == ranks[0]["metrics"]
        for path, leaf in r["sharded"]["params"].items():
            np.testing.assert_array_equal(
                leaf, ranks[0]["sharded"]["params"][path])


@pytest.mark.parametrize("arch", W.DENSE)
def test_kernel_regions_see_local_shards(runs, arch):
    cfg = configs.get_smoke(arch)
    q = (W.B // 2, cfg.vlm_patches + W.S, cfg.n_heads // 2, cfg.head_dim)
    for r in runs[arch]["ranks"]:
        assert set(r["seen"]) == {("attention", q), ("attention_bwd", q)}


@pytest.mark.parametrize("arch", W.DENSE)
def test_sharded_prefill_and_decode_match_plain(runs, arch):
    cfg = configs.get_smoke(arch)
    r = runs[arch]["serve"][0]
    (logits, state), (pl, ps) = r["prefill"], r["plain"]["prefill"]
    head = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    assert logits.shape == (W.B, cfg.vlm_patches + W.S, *head,
                            cfg.vocab_padded)
    np.testing.assert_allclose(logits, pl, **TOL)
    W.assert_close_leaves(state, ps, TOL["atol"])
    (steps, state), (ps, pst) = r["decode"], r["plain"]["decode"]
    assert len(steps) == len(ps) == W.N_DECODE
    for got, want in zip(steps, ps):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **TOL)
    W.assert_close_leaves(state, pst, TOL["atol"])


@pytest.mark.parametrize("arch", W.DENSE)
def test_sharded_greedy_generate_tokens_identical(runs, arch):
    """The plain call's tokens, replicated on every rank; a prompt that
    differs between ranks, distributed, is rank 0's on every rank.
    qwen2-vl takes no ``greedy_generate``, sharded or plain."""
    ranks = runs[arch]["serve"]
    if configs.get_smoke(arch).vlm_patches:
        assert all("greedy" not in r for r in ranks)
        assert "greedy" not in ranks[0]["plain"]
        return
    tokens, placements = ranks[0]["greedy"]
    want = ranks[0]["plain"]["greedy"][0]
    np.testing.assert_array_equal(tokens, want)
    assert placements == ["R", "R"]
    for r in ranks:
        np.testing.assert_array_equal(r["greedy"][0], tokens)
        assert "DTensor prompt" in r["plain_prompt"]
        np.testing.assert_array_equal(r["rank_prompt"], want)


def test_no_child_process_left(runs):
    W.assert_none_alive(STARTED)
