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
  * the memory read (``MemoryReader``): the peak extrapolated from one
    and two periods equals the full walk at three; on the 2x2 mesh the
    read on the cpu-typed fake mesh equals rank 0's read of the gloo run
    (its LM ops on their shape-only route); the arguments equal the JAX
    package's ``memory_analysis().argument_size_in_bytes`` on the 2x2 mesh
    (its sharded step) and on one device for the ten smoke configs (two
    more JAX processes, `torch_sharded_worker.jax_memory`); on one device
    the read on meta equals the read on CPU tensors, byte for byte;
  * the vocab-parallel loss: one loss chunk on a cuda-typed 1x4, 2x2 and
    expert-factorized mesh allocates no buffer above its local logits
    shard in float32 (the global logits chunk the gathered gold logit's
    backward allocated before);
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
from repro_torch import configs as tconfigs
from repro_torch.kernels import pin
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.sharding import tree_items
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
#: the loss chunk's meshes: 1x4 and 2x2 for every family; each MoE family
#: on its expert-factorized mesh, whose TP axes split the vocab twice
LOSS_MESHES = {"1x4": ((1, 4), ("data", "model")), "2x2": MESH_2x2,
               "1x2x2": ((1, 2, 2), ("data", "expert", "model")),
               "2x2x1": ((2, 2, 1), ("data", "expert", "model"))}
LOSS_RUNS = [f"{a}@{m}" for a in tconfigs.ARCH_IDS for m in ("1x4", "2x2")] \
    + list(W.MOE_EXPERT)
#: the JAX memory processes: the ten smoke configs in two halves
JAX_MEM = (",".join(tconfigs.ARCH_IDS[:5]), ",".join(tconfigs.ARCH_IDS[5:]))
#: one device's read on meta and on CPU tensors, for these families
CPU_READS = ("recurrentgemma_2b", "rwkv6_7b", "deepseek_moe_16b")


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
    for arch in tconfigs.ARCH_IDS:
        jobs[f"plain/{arch}"] = dict(what="plain", arch=arch, B=W.B, S=W.S)
    for run in LOSS_RUNS:
        arch, _, mesh = run.partition("@")
        jobs[f"loss/{run}"] = dict(what="loss_chunk", arch=arch,
                                   mesh=LOSS_MESHES[mesh])
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
    groups = [W.start("jax", tmp, FAULTS + W.COMM_RUNS), W.start("dry", tmp),
              W.start("train", tmp, W.COMM_RUNS + FAULTS),
              W.start("jaxmem", tmp, JAX_MEM)]
    for procs in groups:
        STARTED.extend(procs)
    for procs in groups:
        W.finish(procs, timeout=300)
    ranks = [W.load(tmp, f"train{r}.pkl") for r in range(W.N_RANKS)]
    jaxmem: dict = {}
    for archs in JAX_MEM:
        jaxmem.update(W.load(tmp, f"jaxmem_{archs}.pkl"))
    return {"dry": W.load(tmp, "dry_out.pkl"), "ranks": ranks,
            "jax": {run: W.load(tmp, f"jax_{run}.pkl")
                    for run in FAULTS + W.COMM_RUNS}, "jaxmem": jaxmem}


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


@pytest.mark.parametrize("arch", list(DEEP))
def test_peak_extrapolation_equals_the_full_walk(runs, arch):
    """The memory read at one and two body periods, extrapolated to three
    (`dryrun.extrapolate_memory`: the peak at the same site at both
    depths), equals the read of all three: every term byte for byte."""
    one, two, full = (_rec(runs, f"c/{arch}/{p}")["memory"]
                      for p in (1, 2, None))
    got = dryrun.extrapolate_memory(one, two, 3)
    assert got is not None, (one["peak_at"], two["peak_at"])
    for key in ("argument_bytes", "output_bytes", "temp_bytes",
                "alias_bytes", "peak_live_bytes"):
        assert got[key] == full[key], key
    assert got["peak_at"] == full["peak_at"]
    assert one["peak_live_bytes"] < two["peak_live_bytes"] \
        < full["peak_live_bytes"]


@pytest.mark.parametrize("arch", W.COMM_RUNS)
def test_fake_read_equals_the_gloo_read(runs, arch):
    """The read on the cpu-typed 2x2 fake mesh (rank 0's shards on meta)
    equals rank 0's read of the same step on gloo (real shards, the LM
    ops on their shape-only route): arguments, the peak, where it falls
    and the buffers live there."""
    fake = _rec(runs, f"a/{arch}")["memory"]
    gloo = runs["ranks"][0][arch]["memory"]
    for key in ("argument_bytes", "temp_bytes", "peak_live_bytes",
                "output_bytes", "alias_bytes", "peak_at", "largest"):
        assert fake[key] == gloo[key], key
    assert fake["peak_live_bytes"] == fake["argument_bytes"] \
        + fake["temp_bytes"]


def _stack_split_bytes(arch: str) -> int:
    """Bytes of rank 0's step inputs that the JAX package's layout does not
    hold on the 2x2 mesh: its body stacks the shared experts' leaves
    (n_body, d, f), and the MoE rule splits that stack dim over "model",
    so each device holds half the layers' shared experts, where each of
    the port's layers is a leaf of its own, split on (d, f) alone.  The
    weights and AdamW's m, v and master, float32 each."""
    from repro_torch.launch.sharding import local_shape, tree_shardings
    from repro_torch.models import model as TM
    cfg = tconfigs.get_smoke(arch)
    mesh = AbstractMesh(*MESH_2x2)
    params = TM.init_params(cfg, torch.Generator(), device="meta")
    specs = dict(tree_items(tree_shardings(params, mesh, cfg,
                                           depth=cfg.n_body)))
    n = sum(math.prod(local_shape(tuple(t.shape), specs[p], mesh))
            for p, t in tree_items(params) if "shared" in p)
    return n * 4 * 4 // 2


@pytest.mark.parametrize("arch", W.COMM_RUNS)
def test_arguments_equal_the_reference_on_the_2x2_mesh(runs, arch):
    """Rank 0's step inputs equal the JAX package's sharded step's
    ``argument_size_in_bytes`` on the same 2x2 mesh (float32 weights, the
    same batch), but for deepseek-moe's shared experts, which the
    reference's stacked body splits by layer (`_stack_split_bytes`); the
    reference's temp bytes printed beside."""
    mem = _rec(runs, f"a/{arch}")["memory"]
    ref = runs["jax"][arch]["memory"]
    print(f"{arch} 2x2: port peak {mem['peak_live_bytes']} temp "
          f"{mem['temp_bytes']}; reference temp {ref['temp_bytes']}")
    split = _stack_split_bytes(arch) if arch == "deepseek_moe_16b" else 0
    assert mem["argument_bytes"] == ref["argument_bytes"] + split


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_arguments_equal_the_reference_on_one_device(runs, arch):
    """The plain program's inputs on one device (bfloat16 weights, AdamW
    state, batch) equal the JAX package's ``argument_size_in_bytes`` for
    its step; the reference's temp bytes printed beside."""
    mem = _rec(runs, f"plain/{arch}")["memory"]
    ref = runs["jaxmem"][arch]
    print(f"{arch} one device: port peak {mem['peak_live_bytes']} temp "
          f"{mem['temp_bytes']}; reference temp {ref['temp_bytes']}")
    assert mem["argument_bytes"] == ref["argument_bytes"]
    assert mem["peak_live_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]


@pytest.mark.parametrize("arch", CPU_READS)
def test_meta_read_equals_the_cpu_read(arch):
    """One device: the step's read on meta equals its read on CPU tensors
    (the LM ops on their shape-only route, allocating what their kernels
    would), every term, the peak's site and the buffers live there."""
    torch.set_num_threads(1)
    cfg = tconfigs.get_smoke(arch)
    mesh = AbstractMesh((1, 1), ("data", "model"))
    reads = {}
    with pin.shape_route():
        for device in ("meta", "cpu"):
            reads[device] = dryrun.count_program(
                cfg, "train", W.B, W.S, mesh, microbatches=2,
                device=device)["memory"]
    assert reads["meta"] == reads["cpu"]
    assert reads["meta"]["temp_bytes"] > 0


@pytest.mark.parametrize("run", LOSS_RUNS)
def test_loss_chunk_holds_no_more_than_its_logits_shard(runs, run):
    """The vocab-parallel loss: no buffer one loss chunk allocates on rank
    0, forward or backward, exceeds the chunk's local logits shard in
    float32 (B/dp x chunk x [K x] V/tp x 4 bytes)."""
    rec = _rec(runs, f"loss/{run}")
    assert rec["largest"]["bytes"] <= rec["bound"], rec["largest"]


def test_no_child_process_left(runs):
    W.assert_none_alive(STARTED)
