"""The port's sharded train step on a device mesh against the JAX package's
own sharded step, on the CPU.

For the smoke configs of gemma2-2b (flash with a cap, local and global
GQA), recurrentgemma-2b (RG-LRU, local MQA) and rwkv6-7b (WKV6), from the
same weights (the port's ``init_params`` draw in the reference's layout,
`_ref_tree` of ``tests/test_torch_train.py``) and batch (B=4, S=32):

  * the JAX package's train step jitted with ``in_shardings``/
    ``out_shardings`` from its ``tree_shardings``/``batch_shardings`` under
    ``activation_sharding`` on a 2x2 mesh of 4 forced host devices (a
    subprocess, `torch_sharded_worker.jax_train`), as
    ``repro.launch.dryrun.lower_cell`` jits its train cell;
  * the port's step (``make_train_step``) on DTensors on the (2, 2)
    ``make_debug_mesh`` over gloo at world size 4, a process a rank on a
    FileStore (`torch_sharded_worker.port_train`), parameters and AdamW
    state from ``distribute_tree``, the batch from ``distribute_batch``;
  * the loss within 1e-5 and ``grad_norm`` within 1e-4 (relative) of the
    JAX package's sharded step, and of the port's unsharded step on plain
    tensors; ``params``, ``master``, ``m`` and ``v`` gathered whole
    (``full_tensor``) within `STEP_TOL`; every leaf keeps the placements
    of its rule; the kernels' plain versions see local shards;
  * the collectives the step issues (the dry run's own counter,
    ``launch.dryrun.ProgramCounter``) by kind and site; with ``-s``,
    `test_the_step_issues_every_collective_the_dry_run_charges` prints
    them beside the reference's compiled step's and the deleted hand
    model's charge (`torch_sharded_worker.collectives_table`);
  * a DTensor handed straight to a kernel op raises.

The JAX package's steps run in a process a family, the port's in four
ranks that take the families in turn, all seven started at once; each
group has its own timeout, and the file ends asserting that no process
it started is alive.
"""

import json
import numpy as np
import pytest
import torch

import torch_sharded_worker as W
from repro_torch import configs
from repro_torch.models import model as TM
from test_torch_train import STEP_TOL, _ref_tree

#: the processes this file started
STARTED: list = []


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    trees = {}
    for arch in W.ARCHS:
        cfg = configs.get_smoke(arch)
        params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu", dtype=torch.float32)
        trees[arch] = _ref_tree(cfg, params)
    tmp = tmp_path_factory.mktemp("sharded")
    W.write_inputs(tmp, trees)
    jax_procs, port_procs = W.start("jax", tmp), W.start("train", tmp)
    STARTED.extend(jax_procs + port_procs)
    W.finish(jax_procs, timeout=300)
    W.finish(port_procs, timeout=300)
    jax = {arch: W.load(tmp, f"jax_{arch}.pkl") for arch in W.ARCHS}
    ranks = [W.load(tmp, f"train{r}.pkl") for r in range(W.N_RANKS)]
    return {arch: dict(jax=jax[arch], ranks=[r[arch] for r in ranks])
            for arch in W.ARCHS}


def _rel(got, want) -> float:
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _jax_leaves(cfg, tree) -> dict:
    """The reference's tree, unstacked into the port's layout, by path."""
    from repro_torch.launch.sharding import tree_items
    port = TM.params_from_jax(cfg, tree, device="cpu")
    return {"/".join(map(str, p)): x.numpy() for p, x in tree_items(port)}


def _check_leaves(got: dict, want: dict) -> None:
    for key, tol in STEP_TOL.items():
        assert got[key].keys() == want[key].keys()
        for path, leaf in got[key].items():
            assert _rel(leaf, want[key][path]) <= tol, (key, path)


def _check_metrics(got: dict, want: dict) -> None:
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    assert abs(got["grad_norm"] - want["grad_norm"]) \
        <= 1e-4 * want["grad_norm"]
    assert got["lr"] == want["lr"]


@pytest.mark.parametrize("arch", W.ARCHS)
def test_sharded_step_matches_the_jax_sharded_step(runs, arch):
    cfg = configs.get_smoke(arch)
    jax, r = runs[arch]["jax"], runs[arch]["ranks"][0]
    assert jax["n_devices"] == 4
    _check_metrics({k: v for k, (v, _) in r["metrics"].items()},
                   jax["metrics"])
    want = {k: _jax_leaves(cfg, jax[k])
            for k in ("params", "m", "v", "master")}
    _check_leaves(r["sharded"], want)


@pytest.mark.parametrize("arch", W.ARCHS)
def test_sharded_step_matches_the_unsharded_port(runs, arch):
    r = runs[arch]["ranks"][0]
    _check_metrics({k: v for k, (v, _) in r["metrics"].items()},
                   r["plain_metrics"])
    _check_leaves(r["sharded"], r["plain"])


@pytest.mark.parametrize("arch", W.ARCHS)
def test_every_leaf_keeps_the_placements_of_its_rule(runs, arch):
    """Parameters and AdamW state after the step have their specs'
    placements (nothing came back replicated); some are sharded on each
    mesh dim; the metrics are replicated and every rank holds the same
    gathered values."""
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
        for key in ("params", "m"):
            for path, leaf in r["sharded"][key].items():
                np.testing.assert_array_equal(leaf,
                                              ranks[0]["sharded"][key][path])


@pytest.mark.parametrize("arch", W.ARCHS)
def test_kernel_regions_see_local_shards(runs, arch):
    """The kernels' plain versions (their ops' CPU route) see batch B/2 and
    half the heads (channels for RG-LRU) with the sequence whole, forward
    and backward."""
    cfg = configs.get_smoke(arch)
    seen = set(runs[arch]["ranks"][0]["seen"])
    b = W.B // 2
    want = set()
    if any(m in ("attn", "local") for m, _ in cfg.layer_plan):
        q = (b, W.S, cfg.n_heads // 2, cfg.head_dim)
        want |= {("attention", q), ("attention_bwd", q)}
    if any(m == "rglru" for m, _ in cfg.layer_plan):
        x = (b, W.S, (cfg.rglru_width or cfg.d_model) // 2)
        want |= {("rglru_scan", x), ("rglru_scan_bwd", x)}
    if any(m == "rwkv" for m, _ in cfg.layer_plan):
        r = (b, W.S, cfg.d_model // cfg.rwkv_head_size // 2,
             cfg.rwkv_head_size)
        want |= {("wkv6", r), ("wkv6_bwd", r)}
    assert seen == want


def test_the_step_issues_every_collective_the_dry_run_charges(runs):
    """gemma2's step on the 2x2 mesh issues all-gathers, reduce-scatters
    and all-reduces, each over a group of 2, every one with a site in the
    port; the dry run now charges exactly what this program issues
    (``tests/test_torch_dryrun_program.py`` holds its count on a fake
    mesh against this run's).  With ``-s`` the test prints
    ``W.collectives_table`` as JSON: per kind the reference's compiled
    program (its HLO parsed), the port's program and the deleted hand
    model's charge, side by side (no two are held equal: XLA's partitioner
    and DTensor choose their own collectives)."""
    r = runs["gemma2_2b"]
    table = W.collectives_table(r["ranks"][0]["comm"], "gemma2_2b",
                                r["jax"]["xla_collectives"])
    print(json.dumps(table, indent=1))
    issued = {k for k, v in table["kinds"].items() if v["port"][0]}
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= issued
    for kind in issued:
        assert table["kinds"][kind]["port"][1] > 0, kind
    assert sum(table["kinds"][k]["xla"][0] for k in table["kinds"]) > 0
    records = r["ranks"][0]["comm"][3]
    assert records and {g for _k, _b, g, _s in records} == {2}
    sites = table["step_sites"]
    assert sum(n for *_, n, _b in sites) == len(records)
    assert all(site is not None for _phase, site, *_ in sites)


@pytest.mark.parametrize("op", ["flash_attention", "rglru_scan", "wkv6"])
def test_a_dtensor_outside_a_kernel_region_raises(runs, op):
    err = runs[W.ARCHS[0]]["ranks"][0]["refused"][op]
    assert err is not None and "DTensor" in err


def test_no_child_process_left(runs):
    W.assert_none_alive(STARTED)
