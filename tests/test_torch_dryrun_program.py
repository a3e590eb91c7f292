"""The dry run counts the port's own sharded program, on the CPU.

``launch/dryrun.py`` runs one step of a cell as the port's DTensor
program on a mesh over torch's fake process group (rank 0's local shards
on meta) and reads its FLOPs, bytes and collectives there
(``ProgramCounter``).  One child process (`torch_sharded_worker.dry_jobs`)
counts every record this file reads, each on a fake group it owns, while
four gloo ranks run the same step on real tensors and the JAX package
runs its sharded step (a process a fault run); all start at once:

  * (a) on a cpu-typed 2x2 fake mesh the count equals the gloo run's, for
    gemma2-2b and deepseek-moe-16b smoke (B=4, S=32), by kind, count and
    result bytes;
  * (b) on a cuda-typed mesh (the collectives DTensor issues on NCCL) the
    MoE's dispatch and combine are all-to-alls, with no all-gather at
    those sites (the cpu-typed mesh all-gathers there);
  * (c) the count of a model of G body periods extrapolated from one and
    two periods equals the full walk, for a smoke config of each family
    (dense, MoE, RG-LRU, RWKV6) deepened to three periods: counts and
    bytes exactly, FLOPs to 1e-12;
  * (d) one sharded product is charged its global FLOPs over the device
    count on each device;
  * (e) a cell counts on a 2x2x2 ("pod", "data", "model") mesh, every dim
    above 1, and on an expert-factorized one;
  * the faults the 16x16 mesh met in the port's program, each repaired
    and held at a 1x4 mesh whose model axis its widths do not divide
    (`torch_sharded_worker.RUN_CONFIG`): the sharded train step against
    the unsharded port, and against the JAX package's own sharded step
    on the same 1x4 mesh with the same fields changed, loss, metrics and
    every leaf within ``STEP_TOL``.

The file ends asserting that no process it started is alive.
"""

import math
import pickle

import pytest
import torch

import torch_sharded_worker as W
from repro_torch.launch import dryrun
from repro_torch.models import model as TM
from test_torch_sharded import _check_leaves, _check_metrics, _jax_leaves
from test_torch_train import _ref_tree

#: the processes this file started
STARTED: list = []
#: each family's smoke config deepened to three body periods (its head
#: and tail layers kept), for (c)
DEEP = {"gemma2_2b": dict(n_layers=6),                 # (local, attn) x 3
        "deepseek_moe_16b": dict(n_layers=4),          # dense + 3 MoE
        "recurrentgemma_2b": dict(n_layers=11),        # 3 triples + 2
        "rwkv6_7b": dict(n_layers=3)}
MESH_2x2 = ((2, 2), ("data", "model"))
FAULTS = tuple(W.RUN_CONFIG)


def _jobs() -> dict:
    cell = dict(what="cell", kind="train", B=W.B, S=W.S, mesh=MESH_2x2)
    jobs = {}
    for arch in W.COMM_RUNS:
        # the gloo run's parameters are float32 (the reference's tree)
        jobs[f"a/{arch}"] = dict(cell, arch=arch, device_type="cpu",
                                 dtype="float32")
    jobs["b/deepseek_moe_16b"] = dict(cell, arch="deepseek_moe_16b",
                                      dtype="float32")
    for arch, fields in DEEP.items():
        for periods in (1, 2, None):
            jobs[f"c/{arch}/{periods}"] = dict(cell, arch=arch, fields=fields,
                                               periods=periods)
    jobs["d"] = dict(what="matmul", mkn=(8, 16, 32))
    jobs["e/multi"] = dict(cell, arch="gemma2_2b",
                           mesh=((2, 2, 2), ("pod", "data", "model")))
    jobs["e/moe3d"] = dict(cell, arch="deepseek_moe_16b",
                           mesh=((2, 2, 2), ("data", "expert", "model")))
    return jobs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("dryrun_program")
    trees = {}
    for run in W.COMM_RUNS + FAULTS:
        cfg = W.run_config(run)
        params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu", dtype=torch.float32)
        trees[run] = _ref_tree(cfg, params)
    W.write_inputs(tmp, trees)
    with open(tmp / "dry_in.pkl", "wb") as f:
        pickle.dump(_jobs(), f)
    groups = [W.start("jax", tmp, FAULTS), W.start("dry", tmp),
              W.start("train", tmp, W.COMM_RUNS + FAULTS)]
    for procs in groups:
        STARTED.extend(procs)
    for procs in groups:
        W.finish(procs, timeout=300)
    ranks = [W.load(tmp, f"train{r}.pkl") for r in range(W.N_RANKS)]
    return {"dry": W.load(tmp, "dry_out.pkl"), "ranks": ranks,
            "jax": {run: W.load(tmp, f"jax_{run}.pkl") for run in FAULTS}}


def _rec(runs, name):
    rec = runs["dry"][name]
    assert "error" not in rec, rec.get("error")
    return rec


@pytest.mark.parametrize("arch", W.COMM_RUNS)
def test_fake_count_equals_the_gloo_run(runs, arch):
    """(a): the same collectives, by kind, count and result bytes."""
    counts = _rec(runs, f"a/{arch}")["counts"]
    count, nbytes, _sites, records = runs["ranks"][0][arch]["comm"]
    assert counts["collectives"]["count_by_kind"] == count
    assert counts["result_bytes_by_kind"] == nbytes
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(count)
    assert {g for _k, _b, g, _s in records} == {2}


def test_cuda_mesh_dispatch_and_combine_are_all_to_alls(runs):
    """(b): on the cuda-typed mesh the buffer's moves between groups and
    experts in ``moe_forward`` are all-to-alls, and no all-gather shares
    their sites; on the cpu-typed mesh the same sites all-gather."""
    def by_site(counts):
        out: dict = {}
        for phase, site, kind, _n, _b in counts["sites"]:
            if phase != "backward":
                out.setdefault(site, set()).add(kind)
        return out
    cuda = by_site(_rec(runs, "b/deepseek_moe_16b")["counts"])
    cpu = by_site(_rec(runs, "a/deepseek_moe_16b")["counts"])
    moves = {site for site, kinds in cuda.items()
             if "all-to-all" in kinds and "moe_forward" in site}
    assert len(moves) >= 2                      # dispatch and combine
    for site in moves:
        assert cuda[site] == {"all-to-all"}, site
        assert "all-gather" in cpu[site] and "all-to-all" not in cpu[site]
    n_moe = 2                                   # the smoke's MoE layers
    calls = _rec(runs, "b/deepseek_moe_16b")["counts"]["collectives"][
        "count_by_kind"]["all-to-all"]
    assert calls >= 2 * n_moe


@pytest.mark.parametrize("arch", list(DEEP))
def test_extrapolation_equals_the_full_walk(runs, arch):
    """(c): T(1) + (G - 1) (T(2) - T(1)) of the counts at one and two body
    periods equals the count of all G = 3."""
    one, two, full = (_rec(runs, f"c/{arch}/{p}")["counts"]
                      for p in (1, 2, None))
    G = 3
    got = dryrun.extrapolate_counts(one, two, G)
    for key in ("aten_ops", "bytes_counted", "bytes"):
        assert got[key] == full[key], key
    for key in ("flops_counted", "flops"):
        assert got[key] == pytest.approx(full[key], rel=1e-12), key
    assert got["kernel_ops"].keys() == full["kernel_ops"].keys()
    for op, row in full["kernel_ops"].items():
        assert got["kernel_ops"][op]["calls"] == row["calls"], op
        assert got["kernel_ops"][op]["bytes"] == row["bytes"], op
        assert got["kernel_ops"][op]["flops"] == pytest.approx(
            row["flops"], rel=1e-12), op
    want = full["collectives"]
    assert got["collectives"]["count_by_kind"] == want["count_by_kind"]
    assert got["result_bytes_by_kind"] == full["result_bytes_by_kind"]
    for kind, b in want["bytes_by_kind"].items():
        assert got["collectives"]["bytes_by_kind"][kind] == pytest.approx(
            b, rel=1e-12), kind
    assert one["aten_ops"] < two["aten_ops"] < full["aten_ops"]


def test_one_sharded_product_is_charged_its_share(runs):
    """(d): (8, 16) rows on "data" times (16, 32) columns on "model" on a
    2x2 mesh: one local (4, 16) x (16, 16) product, 2 M K N / 4 FLOPs, no
    collective."""
    rec = _rec(runs, "d")
    M, K, N = 8, 16, 32
    assert rec["flops"] == 2 * M * K * N / 4
    assert rec["collectives"] == []
    assert rec["placements"] == ["S(0)", "S(1)"]


@pytest.mark.parametrize("name", ["e/multi", "e/moe3d"])
def test_a_cell_counts_on_three_dim_meshes(runs, name):
    """(e): every dim of the mesh above 1; the cell's program runs there,
    finite positive terms, collectives over groups of 2."""
    rec = _rec(runs, name)
    rl = rec["roofline"]
    assert rl["n_devices"] == 8
    for key in ("compute_s", "memory_s", "collective_s"):
        assert 0 < rl[key] < math.inf, key
    assert sum(rec["collectives"]["count_by_kind"].values()) > 0


@pytest.mark.parametrize("run", FAULTS)
def test_repaired_faults_match_the_unsharded_port(runs, run):
    """Each fault a 16x16 mesh met, at 1x4 with the same indivisibility
    (`torch_sharded_worker.RUN_CONFIG`): the sharded train step against
    the port's unsharded step on plain tensors."""
    r = runs["ranks"][0][run]
    _check_metrics({k: v for k, (v, _) in r["metrics"].items()},
                   r["plain_metrics"])
    _check_leaves(r["sharded"], r["plain"])


@pytest.mark.parametrize("run", FAULTS)
def test_repaired_faults_match_the_jax_sharded_step(runs, run):
    """Each fault run against the JAX package's own sharded train step on
    the same 1x4 mesh, its config changed by the same fields, from the
    same weights and batch."""
    jax, r = runs["jax"][run], runs["ranks"][0][run]
    assert jax["n_devices"] == 4
    _check_metrics({k: v for k, (v, _) in r["metrics"].items()},
                   jax["metrics"])
    cfg = W.run_config(run)
    _check_leaves(r["sharded"], {k: _jax_leaves(cfg, jax[k])
                                 for k in ("params", "m", "v", "master")})


def test_no_child_process_left(runs):
    W.assert_none_alive(STARTED)
