"""The port's sharded serving programs on a device mesh against the same
calls on plain tensors, on the CPU.

For the smoke configs of gemma2-2b, recurrentgemma-2b and rwkv6-7b in
float32 with the weights of ``tests/test_torch_sharded.py``, on the (2, 2)
``make_debug_mesh`` over gloo at world size 4 (a process a rank on a
FileStore, `torch_sharded_worker.port_serve`), the parameters TP-only
(``distribute_tree(..., fsdp=False)``, as the reference's prefill and
decode cells shard them), the batch from ``distribute_batch`` and the
decode state from ``distribute_state``, all inside
``activation_sharding``:

  * ``prefill`` (full-sequence logits) and its state within 1e-4 of the
    port's unsharded prefill;
  * four ``decode_step`` calls on the padded state, logits and final state
    within 1e-4;
  * ``greedy_generate``'s tokens identical, replicated on every rank; a
    plain prompt refused on DTensor parameters, and a prompt that differs
    between ranks, distributed, taken from rank 0;
  * flash's kernel region on (1, 4) and (2, 2) meshes for every way it
    lays out GQA heads (`torch_sharded_worker.ATTN_CASES`), forward and
    backward against the plain call;
  * on a (1, 1) mesh over a gloo group of world size 1 in this process, a
    gradient pass, a prefill and ``greedy_generate`` of each family in
    float32 and bfloat16 bitwise equal to the plain-tensor calls.

The file ends asserting that no process it started is alive.
"""

import numpy as np
import pytest
import torch

import torch_sharded_worker as W
from repro_torch import configs
from repro_torch.models import model as TM
from repro_torch.models.sharding import (local_region, logical,
                                         replicated_like)
from test_torch_train import _ref_tree

TOL = dict(rtol=0, atol=1e-4)
#: the processes this file started
STARTED: list = []


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The four ranks, started (the in-process tests below run while they
    work)."""
    trees = {}
    for arch in W.ARCHS:
        cfg = configs.get_smoke(arch)
        params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu", dtype=torch.float32)
        trees[arch] = _ref_tree(cfg, params)
    tmp = tmp_path_factory.mktemp("sharded_serve")
    W.write_inputs(tmp, trees)
    procs = W.start("serve", tmp)
    STARTED.extend(procs)
    return tmp, procs


@pytest.fixture(scope="module")
def runs(started):
    tmp, procs = started
    W.finish(procs, timeout=300)
    ranks = [W.load(tmp, f"serve{r}.pkl") for r in range(W.N_RANKS)]
    return {key: [r[key] for r in ranks] for key in W.ARCHS + ["attn"]}


@pytest.fixture(scope="module")
def gloo_mesh_1(tmp_path_factory):
    """A (1, 1) mesh over a gloo group of world size 1 in this process (a
    FileStore), destroyed after the module."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    store = dist.FileStore(str(tmp_path_factory.mktemp("gloo1") / "store"),
                           1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield make_debug_mesh(1, 1, device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", W.ARCHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_world_size_1_is_the_plain_call_bit_for_bit(started, gloo_mesh_1,
                                                    arch, dtype):
    """On a (1, 1) mesh every placement is ``Replicate()`` and each op runs
    the same local op in the same order: a gradient pass of two
    microbatches, the last-position prefill and ``greedy_generate`` equal
    the plain-tensor calls bitwise (the CPU twin of chip_smoke's phase
    18)."""
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.launch.sharding import (activation_rules,
                                             distribute_batch,
                                             distribute_tree)
    from repro_torch.models.sharding import activation_sharding
    from repro_torch.serve.engine import greedy_generate
    from repro_torch.train import loss_and_grads
    mesh = gloo_mesh_1
    cfg = configs.get_smoke(arch)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu", dtype=dtype)
    batch = make_batch(cfg, DataConfig(seed=3), 0, W.B, 40, device="cpu")
    with activation_sharding(mesh, activation_rules(mesh, W.B,
                                                    n_kv=cfg.n_kv_heads)):
        dp = distribute_tree(params, mesh, cfg)
        db = distribute_batch(batch, mesh)
        sharded = (loss_and_grads(dp, cfg, db, microbatches=2),
                   TM.prefill(dp, cfg, {"tokens": db["tokens"]},
                              last_only=True)[0],
                   greedy_generate(dp, cfg, db["tokens"], 4, device="cpu"))
    plain = (loss_and_grads(params, cfg, batch, microbatches=2),
             TM.prefill(params, cfg, {"tokens": batch["tokens"]},
                        last_only=True)[0],
             greedy_generate(params, cfg, batch["tokens"], 4, device="cpu"))
    (ld, gd), logits_d, toks_d = sharded
    (lp, gp), logits_p, toks_p = plain
    assert torch.equal(ld.to_local(), lp)
    assert len(gd) == len(gp)
    for x, y in zip(gd, gp):
        assert torch.equal(x.to_local(), y)
    assert torch.equal(logits_d.to_local(), logits_p)
    assert torch.equal(toks_d.to_local(), toks_p)


def test_the_recompute_runs_under_the_forwards_rules(started, gloo_mesh_1):
    """Under remat a checkpointed layer is recomputed in the backward, and
    autograd runs a CUDA tensor's backward on a thread of its own, where
    the forward thread's rules are not set: a backward from another thread
    (the forward's rules gone) must recompute under the forward's rules
    and give the gradients of a backward on the forward's thread."""
    import threading

    from repro_torch.data import DataConfig, make_batch
    from repro_torch.launch.sharding import (activation_rules,
                                             distribute_batch,
                                             distribute_tree)
    from repro_torch.models.sharding import activation_sharding
    mesh = gloo_mesh_1
    cfg = configs.get_smoke("gemma2_2b")
    assert cfg.remat
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.float32)
    batch = distribute_batch(make_batch(cfg, DataConfig(seed=3), 0, W.B, 40,
                                        device="cpu"), mesh)
    grads = []
    for other_thread in (False, True):
        dp = distribute_tree(params, mesh, cfg)
        leaves = [p.requires_grad_(True) for p in
                  (dp["embed"], dp["layers"][0]["attn"]["wq"])]
        with activation_sharding(mesh, activation_rules(mesh, W.B,
                                                        n_kv=cfg.n_kv_heads)):
            loss = TM.loss_fn(dp, cfg, batch)
            if not other_thread:
                loss.backward()
        if other_thread:
            err = []

            def run():
                try:
                    loss.backward()
                except Exception as e:      # noqa: BLE001 (reported below)
                    err.append(e)
            t = threading.Thread(target=run)
            t.start()
            t.join()
            assert not err, err[0]
        grads.append([p.grad.to_local() for p in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", W.ARCHS)
def test_sharded_prefill_matches_plain(runs, arch):
    r = runs[arch][0]
    (logits, state), (pl, ps) = r["prefill"], r["plain"]["prefill"]
    cfg = configs.get_smoke(arch)
    assert logits.shape == (W.B, W.S, cfg.vocab_padded)
    np.testing.assert_allclose(logits, pl, **TOL)
    W.assert_close_leaves(state, ps, TOL["atol"])


@pytest.mark.parametrize("arch", W.ARCHS)
def test_sharded_decode_steps_match_plain(runs, arch):
    r = runs[arch][0]
    (steps, state), (ps, pst) = r["decode"], r["plain"]["decode"]
    assert len(steps) == len(ps) == W.N_DECODE
    for got, want in zip(steps, ps):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **TOL)
    W.assert_close_leaves(state, pst, TOL["atol"])


@pytest.mark.parametrize("arch", W.ARCHS)
def test_sharded_greedy_generate_tokens_identical(runs, arch):
    ranks = runs[arch]
    tokens, placements = ranks[0]["greedy"]
    assert tokens.shape == (W.B, W.N_DECODE) and tokens.dtype == np.int32
    np.testing.assert_array_equal(tokens, ranks[0]["plain"]["greedy"][0])
    assert placements == ["R", "R"]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["greedy"][0], tokens)


@pytest.mark.parametrize("arch", W.ARCHS)
def test_a_prompt_that_differs_between_ranks(runs, arch):
    """On DTensor parameters ``greedy_generate`` refuses a plain prompt
    (each rank could hold another one, and would decode its own under
    tokens marked replicated); a prompt that differs between ranks,
    distributed by ``distribute_batch``, is rank 0's on every rank: the
    tokens are the plain call's on rank 0's prompt."""
    want = runs[arch][0]["plain"]["greedy"][0]
    for r in runs[arch]:
        assert "DTensor prompt" in r["plain_prompt"]
        np.testing.assert_array_equal(r["rank_prompt"], want)


@pytest.mark.parametrize("case", range(len(W.ATTN_CASES)))
def test_flash_region_shards_heads_and_keeps_the_gqa_map(runs, case):
    """``layers.attention`` on DTensors (window 8, cap 50) on a (1, 4) or
    (2, 2) mesh: the flash op sees batch B / data and the query heads of
    its way (`torch_sharded_worker.ATTN_CASES`); the output and dq, dk, dv
    gathered whole match the plain call (dk and dv of whole KV heads are
    sums over the shards, in another order)."""
    (data, _), B, H, _, heads = W.ATTN_CASES[case]
    for r in runs["attn"]:
        got = r[case]
        q = (B // data, W.ATTN_S, heads, W.ATTN_HD)
        assert got["seen"] == [("attention", q), ("attention_bwd", q)]
        for a, b in zip(got["sharded"], got["plain"]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_plain_tensors_pass_the_helpers_unchanged():
    """Outside a mesh the helpers are the identity: a plain call takes the
    code path it took before the sharded programs."""
    t, like = torch.arange(6.0), torch.ones(3)
    assert replicated_like(t, like) is t
    assert logical(t) is t
    got = local_region(lambda a, b: (a, b), (t, like), (("batch",),) * 2,
                       (0, 1))
    assert got[0] is t and got[1] is like


def test_no_child_process_left(runs):
    W.assert_none_alive(STARTED)
