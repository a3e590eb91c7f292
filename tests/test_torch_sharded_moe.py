"""The MoE families' sharded programs on a device mesh against the JAX
package's own sharded step and the port's plain calls, on the CPU.

For the smoke configs of deepseek-moe-16b (softmax-then-top-6 routing of 8
experts, a shared expert, a dense first layer) and mixtral-8x7b (top-2 of
4 experts, local GQA), from the weights and batch of
``tests/test_torch_sharded.py`` (B=4, S=32):

  * the train step on the 2x2 ("data", "model") mesh, and on an
    expert-factorized ("data", "expert", "model") mesh each (deepseek-moe
    (1, 2, 2), mixtral (2, 2, 1); `torch_sharded_worker.MOE_EXPERT`): the
    loss within 1e-5 and ``grad_norm`` within 1e-4 (relative) of the JAX
    package's sharded step (`torch_sharded_worker.jax_train`), every leaf
    after the step within `STEP_TOL` (the tolerances gemma2's step is held
    to in ``tests/test_torch_sharded.py``), and the same against the
    port's unsharded step;
  * every leaf keeps its rule's placements;
  * the dispatch and combine regions (``layers.moe_forward``) see one
    dispatch group a rank: routing (g, Tg, d) with g = 1, Tg = B S / G,
    and the combine's (1, E C + 1, d) slots; flash's region its local
    shards;
  * the routing: (token, expert) choices of the sharded step that differ
    from the unsharded port's and from the JAX step's, counted: none
    (`ROUTING_DIFFER`);
  * deepseek-moe's step issues all-gathers, reduce-scatters and
    all-reduces, no all-to-all (gloo's cpu-typed mesh takes an
    all-gather for it); with ``-s`` the test prints them by kind and site
    beside the reference's compiled step's and the deleted hand model's
    charge (``torch_sharded_worker.collectives_table``);
  * on the 2x2 mesh with TP-only parameters: prefill, four decode steps
    (1e-4) and ``greedy_generate`` (identical) against the plain calls.

The JAX steps run in a process a run, the port's train and serve steps in
two groups of four gloo ranks, all started at once; the file ends
asserting that no process it started is alive.
"""

import json

import numpy as np
import pytest
import torch

import torch_sharded_worker as W
from repro_torch import configs
from repro_torch.models import layers as L
from repro_torch.models import model as TM
from test_torch_sharded import _check_leaves, _check_metrics, _jax_leaves
from test_torch_train import _ref_tree

TRAIN = W.MOE + W.MOE_EXPERT
TOL = dict(rtol=0, atol=1e-4)
#: (token, expert) choices of the sharded step's routing that differ from
#: the JAX step's, in every run, over its MoE layers (B S K choices a
#: layer): the JAX side's routing comes from its MoE layers' inputs
#: through its router ops, the same float32 products summed in XLA's order
ROUTING_DIFFER = 0
#: the processes this file started
STARTED: list = []


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    trees = {}
    for arch in W.MOE:
        cfg = configs.get_smoke(arch)
        params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu", dtype=torch.float32)
        trees[arch] = _ref_tree(cfg, params)
    tmp = tmp_path_factory.mktemp("sharded_moe")
    W.write_inputs(tmp, trees)
    groups = [W.start("jax", tmp, TRAIN), W.start("train", tmp, TRAIN),
              W.start("serve", tmp, W.MOE)]
    for procs in groups:
        STARTED.extend(procs)
    for procs in groups:
        W.finish(procs, timeout=300)
    train = [W.load(tmp, f"train{r}.pkl") for r in range(W.N_RANKS)]
    serve = [W.load(tmp, f"serve{r}.pkl") for r in range(W.N_RANKS)]
    out = {run: dict(jax=W.load(tmp, f"jax_{run}.pkl"),
                     ranks=[r[run] for r in train]) for run in TRAIN}
    for arch in W.MOE:
        out[arch]["serve"] = [r[arch] for r in serve]
    return out


@pytest.mark.parametrize("run", TRAIN)
def test_sharded_step_matches_the_jax_sharded_step(runs, run):
    cfg = configs.get_smoke(W.split_run(run)[0])
    jax, r = runs[run]["jax"], runs[run]["ranks"][0]
    assert jax["n_devices"] == 4
    _check_metrics({k: v for k, (v, _) in r["metrics"].items()},
                   jax["metrics"])
    want = {k: _jax_leaves(cfg, jax[k])
            for k in ("params", "m", "v", "master")}
    _check_leaves(r["sharded"], want)


@pytest.mark.parametrize("run", TRAIN)
def test_sharded_step_matches_the_unsharded_port(runs, run):
    r = runs[run]["ranks"][0]
    _check_metrics({k: v for k, (v, _) in r["metrics"].items()},
                   r["plain_metrics"])
    _check_leaves(r["sharded"], r["plain"])


@pytest.mark.parametrize("run", TRAIN)
def test_every_leaf_keeps_the_placements_of_its_rule(runs, run):
    """Parameters and AdamW state after the step have their specs'
    placements, the experts' too; some are sharded on each mesh dim; the
    metrics are replicated and every rank holds the same values."""
    ranks = runs[run]["ranks"]
    sharded_on, experts = set(), set()
    for key, leaves in ranks[0]["placements"].items():
        for path, (want, got) in leaves.items():
            assert got == want, (key, path)
            sharded_on.update(i for i, p in enumerate(got) if p != "R")
            if path.split("/")[-2:-1] == ["moe"] and path[-2:] in (
                    "wg", "wu", "wd"):
                experts.add(tuple(got))
    assert sharded_on == {0, 1}
    assert experts and all(any(p != "R" for p in e) for e in experts)
    for r in ranks:
        for value, placements in r["metrics"].values():
            assert placements == ["R", "R"]
        assert r["metrics"] == ranks[0]["metrics"]
        for path, leaf in r["sharded"]["params"].items():
            np.testing.assert_array_equal(
                leaf, ranks[0]["sharded"]["params"][path])


def _groups(run) -> tuple[int, int]:
    """(G1, G2) of the reference's ``_moe_groups`` on the run's mesh: the
    data size, and the model size unless the mesh has an expert axis."""
    _, shape, names = W.split_run(run)
    size = dict(zip(names, shape))
    return size["data"], (1 if "expert" in size else size["model"])


@pytest.mark.parametrize("run", TRAIN)
def test_dispatch_and_combine_see_one_group_a_rank(runs, run):
    """The dispatch region routes one group of B S / G tokens a rank (the
    groups tile the device grid; on the (1, 2, 2) mesh G = 1 and each rank
    routes the whole batch as the reference's pjit does), the combine
    region reads that group's E C slots and the spare; flash sees batch
    B / data and H / TP heads, forward and backward."""
    arch, shape, names = W.split_run(run)
    cfg = configs.get_smoke(arch)
    size = dict(zip(names, shape))
    G1, G2 = _groups(run)
    Tg = W.B * W.S // (G1 * G2)
    C = L.moe_capacity(Tg, cfg.moe)
    tp = size["model"] * size.get("expert", 1)
    q = (W.B // size["data"], W.S, cfg.n_heads // tp, cfg.head_dim)
    for r in runs[run]["ranks"]:
        assert set(r["seen"]) == {
            ("moe_route", (1, Tg, cfg.d_model)),
            ("moe_combine", (1, cfg.moe.n_experts * C + 1, cfg.d_model)),
            ("attention", q), ("attention_bwd", q)}


def _global_routes(ranks, n_layers: int) -> list:
    """Each MoE layer's (B, S, K) expert choices, put together from the
    ranks' groups."""
    out = []
    for layer in range(n_layers):
        K = ranks[0]["routes"][0][layer].shape[-1]
        full = np.full((W.B, W.S, K), -1)
        for r in ranks:
            routes, (b0, s0, b, s) = r["routes"]
            full[b0:b0 + b, s0:s0 + s] = routes[layer].reshape(b, s, K)
        assert (full >= 0).all()
        out.append(full)
    return out


def _differ(a: list, b: list) -> int:
    """(token, expert) choices of ``a`` that ``b`` does not make."""
    n = 0
    for x, y in zip(a, b):
        x, y = np.sort(x, -1), np.sort(y, -1)
        for t in np.ndindex(x.shape[:-1]):
            n += len(set(x[t]) - set(y[t]))
    return n


@pytest.mark.parametrize("run", TRAIN)
def test_routing_against_the_unsharded_port_and_the_jax_step(runs, run):
    """The sharded step routes every token as the unsharded port does
    (each group routes its own tokens, the router's products are the
    same); against the JAX step's routing the count of differing
    (token, expert) choices is `ROUTING_DIFFER`."""
    cfg = configs.get_smoke(W.split_run(run)[0])
    n = sum(f == "moe" for _, f in cfg.layer_plan)
    ranks = runs[run]["ranks"]
    got = _global_routes(ranks, n)
    plain = [x.reshape(W.B, W.S, -1) for x in ranks[0]["plain_routes"]]
    jax = runs[run]["jax"]["routes"]
    assert len(got) == len(plain) == len(jax) == n
    assert _differ(got, plain) == 0
    assert _differ(got, jax) == ROUTING_DIFFER


def test_the_moe_step_issues_every_collective_the_dry_run_charges(runs):
    """deepseek-moe's step on the 2x2 mesh issues all-gathers,
    reduce-scatters and all-reduces; its dispatch buffer moves from
    groups to experts as an all-gather and a slice (gloo's cpu-typed
    mesh has no all-to-all; on a cuda-typed mesh DTensor issues an
    all-to-all there, ``tests/test_torch_dryrun_program.py``), issued in
    ``moe_forward``.  Every collective has a site in the port.  With
    ``-s`` the test prints ``W.collectives_table`` as JSON: the
    reference's compiled program, the port's and the deleted hand
    model's charge per kind."""
    arch = "deepseek_moe_16b"
    r = runs[arch]
    table = W.collectives_table(r["ranks"][0]["comm"], arch,
                                r["jax"]["xla_collectives"])
    print(json.dumps(table, indent=1))
    issued = {k for k, v in table["kinds"].items() if v["port"][0]}
    assert issued == {"all-gather", "reduce-scatter", "all-reduce"}
    for kind in issued:
        assert table["kinds"][kind]["port"][1] > 0, kind
    assert any(site.startswith("layers.py") and "moe_forward" in site
               for _phase, site, kind, *_ in table["step_sites"]
               if kind == "all-gather")
    assert all(site is not None for _phase, site, *_ in table["step_sites"])


@pytest.mark.parametrize("arch", W.MOE)
def test_sharded_prefill_and_decode_match_plain(runs, arch):
    r = runs[arch]["serve"][0]
    (logits, state), (pl, ps) = r["prefill"], r["plain"]["prefill"]
    assert logits.shape == (W.B, W.S, configs.get_smoke(arch).vocab_padded)
    np.testing.assert_allclose(logits, pl, **TOL)
    W.assert_close_leaves(state, ps, TOL["atol"])
    (steps, state), (ps, pst) = r["decode"], r["plain"]["decode"]
    assert len(steps) == len(ps) == W.N_DECODE
    for got, want in zip(steps, ps):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **TOL)
    W.assert_close_leaves(state, pst, TOL["atol"])


@pytest.mark.parametrize("arch", W.MOE)
def test_sharded_greedy_generate_tokens_identical(runs, arch):
    """``greedy_generate`` on the mesh gives the plain call's tokens,
    replicated on every rank, and a prompt that differs between ranks,
    distributed, is rank 0's on every rank."""
    ranks = runs[arch]["serve"]
    tokens, placements = ranks[0]["greedy"]
    want = ranks[0]["plain"]["greedy"][0]
    assert tokens.shape == (W.B, W.N_DECODE)
    np.testing.assert_array_equal(tokens, want)
    assert placements == ["R", "R"]
    for r in ranks:
        np.testing.assert_array_equal(r["greedy"][0], tokens)
        assert "DTensor prompt" in r["plain_prompt"]
        np.testing.assert_array_equal(r["rank_prompt"], want)


def test_no_child_process_left(runs):
    W.assert_none_alive(STARTED)
