"""The port's training path against the JAX reference, on the CPU.

Each twin starts both sides from the same float32 weights and optimizer
state: the port's ``init_params`` draw, laid out as the reference's tree
(`_ref_tree`: the body stacked) with its constant leaves (norms, biases)
redrawn from a numpy seed, carried back by ``params_from_jax`` and
``opt_state_from_jax``; batches come from each side's ``make_batch`` (the
same numpy stream).  On CPU tensors the port runs the plain versions of
its kernels through the same autograd Functions as on the card.

  * one train step (``make_train_step``: loss, grads by autograd, AdamW)
    for the smoke configs of recurrentgemma-2b (RG-LRU and local
    attention), gemma2-2b (soft-caps, post-norms), deepseek-moe-16b (grads
    through the token-dropping MoE) and rwkv6-7b (the plain WKV6): loss
    within 1e-5, ``grad_norm`` within 1e-4 (relative), ``lr`` equal, and
    the parameters, ``m``, ``v`` and ``master`` after the step within
    `STEP_TOL`;
  * ``apply_updates`` alone on identical numpy gradients within 1e-6, and
    ``schedule`` at steps 0, 1, 50, 100, 5,000 and 10,000;
  * twins of ``tests/test_models.py``'s gradient accumulation (1, 2, and
    2 in order (1, 0)) and loss-decrease tests;
  * ``make_batch`` identical to the reference's; checkpoints (round trip
    bitwise, a reference-written checkpoint restored, ``latest_step``);
    the DAGPS pipeline plans and baselines equal to the reference's, and
    ``examples/torch_pipeline_dagps.py`` printing what
    ``examples/pipeline_dagps.py`` prints; ``quantize_int8``/``dequantize``
    bitwise; ``examples/torch_train_lm.py --device cpu --steps 3``.

The reference's steps are jitted once per module (module-scoped fixtures),
at XLA's backend optimization level 0 (`_ref_run`), and the torch side
runs on one thread.
"""

import dataclasses
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.ckpt import save as jsave
from repro.data import DataConfig as JDataConfig
from repro.data import make_batch as jmake_batch
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import apply_updates as japply
from repro.optim import dequantize as jdequantize
from repro.optim import quantize_int8 as jquantize
from repro.optim import schedule as jschedule
from repro.train import TrainConfig as JTrainConfig
from repro.train import gpipe_makespan as jgpipe
from repro.train import ideal_makespan as jideal
from repro.train import make_train_step as jmake_train_step
from repro.train import one_f_one_b_makespan as j1f1b
from repro.train import schedule_pipeline as jschedule_pipeline
from repro_torch import configs as tconfigs
from repro_torch.ckpt import latest_step, restore, save
from repro_torch.data import DataConfig, batch_specs, make_batch
from repro_torch.models import model as TM
from repro_torch.optim import (AdamWConfig, apply_updates, dequantize,
                               init_state, opt_state_from_jax, quantize_int8,
                               schedule, tree_leaves, tree_map)
from repro_torch.train import (TrainConfig, gpipe_makespan, ideal_makespan,
                               make_train_step, one_f_one_b_makespan,
                               schedule_pipeline)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TWIN_ARCHS = ["recurrentgemma_2b", "gemma2_2b", "deepseek_moe_16b",
              "rwkv6_7b"]
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
#: batch of the step twins: S above the smoke configs' windows (16), and
#: not a power of two, so the loss runs three chunks of 8
B, S = 2, 24
#: after one step, per leaf: max |port - reference| over the reference's
#: max |leaf| (the whole leaf when that is 0).  A run read, over the four
#: twins: params and master 3.0e-4 (rwkv6; a step moves a weight by about
#: lr = 1e-3 along sign(g), and where g is near 0 the two sides' float32
#: gradients can pick other signs), m 7.8e-6 and v 1.2e-5 (rwkv6: the
#: gradients agree to a few float32 ulps of their largest element); loss
#: within 8.5e-8 and grad_norm within 4.9e-7, relative
STEP_TOL = {"params": 2e-3, "master": 2e-3, "m": 1e-4, "v": 1e-4}
#: leaves the reference initializes to constants
_CONST_LEAVES = ("bq", "bk", "bv", "b1", "b2", "ln1", "ln2", "pln1", "pln2",
                 "final_ln", "conv_b", "ba", "bx", "ln_w")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ref_tree(cfg, params, seed=11):
    """The port's parameters as the reference's numpy tree (head layers,
    the body stacked by pattern position, tail layers), the constant
    leaves redrawn from ``seed`` so that they count."""
    rng = np.random.default_rng(seed)

    def np_tree(node, key=None):
        if isinstance(node, dict):
            return {k: np_tree(v, k) for k, v in node.items()}
        arr = node.detach().float().numpy().copy()
        if key in _CONST_LEAVES:
            arr = arr + 0.1 * rng.standard_normal(arr.shape).astype(np.float32)
        return arr
    head, body, tail = cfg.groups
    layers = [np_tree(bp) for bp in params["layers"]]
    tree = {k: np_tree(params[k], k) for k in params if k != "layers"}
    for j in range(len(head)):
        tree[f"head{j}"] = layers[j]
    off = len(head)
    if cfg.n_body:
        groups = [{f"b{j}": layers[off + g * len(body) + j]
                   for j in range(len(body))} for g in range(cfg.n_body)]
        tree["body"] = jax.tree.map(lambda *xs: np.stack(xs), *groups)
    off += cfg.n_body * len(body)
    for j in range(len(tail)):
        tree[f"tail{j}"] = layers[off + j]
    return tree


def _ref_opt(tree):
    zeros = jax.tree.map(np.zeros_like, tree)
    return {"m": zeros, "v": jax.tree.map(np.zeros_like, tree),
            "step": np.zeros((), np.int32),
            "master": jax.tree.map(np.copy, tree)}


def _start(arch, seed=0):
    """(torch cfg, reference cfg, reference numpy params tree).  The
    reference runs without ``jax.checkpoint`` (it moves no value and its
    compile takes longer); the port keeps ``remat`` on."""
    tcfg = tconfigs.get_smoke(arch)
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), remat=False)
    params = TM.init_params(tcfg, torch.Generator().manual_seed(seed),
                            device="cpu", dtype=torch.float32)
    return tcfg, jcfg, _ref_tree(tcfg, params)


def _ref_run(fn, *args):
    """``fn(*args)`` jitted at XLA's backend optimization level 0: a
    third of the default level's compile time on the smoke models, values
    within float32 rounding of it (the reference's code is unchanged)."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})(*args)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want) -> float:
    d = float((got - want).abs().max())
    return d / max(float(want.abs().max()), 1e-30)


# ----------------------------------------------------------------------
# one train step, four families
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def step_twins():
    cache = {}

    def get(arch):
        if arch in cache:
            return cache[arch]
        tcfg, jcfg, tree = _start(arch)
        jopt = _ref_opt(tree)
        jb = jmake_batch(jcfg, JDataConfig(seed=3), 0, B, S)
        p2, o2, jm = _ref_run(
            jmake_train_step(jcfg, JTrainConfig(optimizer=JAdamWConfig(**OPT))),
            jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, jopt),
            jb)
        params = TM.params_from_jax(tcfg, tree, device="cpu")
        opt = opt_state_from_jax(tcfg, jopt, device="cpu")
        tb = make_batch(tcfg, DataConfig(seed=3), 0, B, S, device="cpu")
        step = make_train_step(tcfg, TrainConfig(optimizer=AdamWConfig(**OPT)),
                               device="cpu")
        params, opt, tm = step(params, opt, tb)
        want = {"params": TM.params_from_jax(tcfg, _np(p2), device="cpu"),
                **{k: TM.params_from_jax(tcfg, _np(o2[k]), device="cpu")
                   for k in ("m", "v", "master")}}
        got = {"params": params, **{k: opt[k] for k in ("m", "v", "master")}}
        cache[arch] = dict(jm={k: float(v) for k, v in jm.items()},
                           tm={k: float(v) for k, v in tm.items()},
                           step=(int(o2["step"]), int(opt["step"])),
                           got=got, want=want)
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", TWIN_ARCHS)
def test_train_step_matches_reference(step_twins, arch):
    tw = step_twins(arch)
    jm, tm = tw["jm"], tw["tm"]
    assert np.isfinite(tm["loss"])
    assert abs(tm["loss"] - jm["loss"]) <= 1e-5 * abs(jm["loss"])
    assert abs(tm["grad_norm"] - jm["grad_norm"]) <= 1e-4 * jm["grad_norm"]
    assert tm["lr"] == jm["lr"]
    assert tw["step"] == (1, 1)
    for name, tol in STEP_TOL.items():
        worst = max(_rel(g, w) for g, w in zip(tree_leaves(tw["got"][name]),
                                               tree_leaves(tw["want"][name])))
        assert worst <= tol, (name, worst)


def test_apply_updates_alone_matches_reference():
    """AdamW on identical gradients over a small tree of dicts and lists
    (two steps, so the bias corrections and the state both count), with
    the clip active and without it."""
    rng = np.random.default_rng(9)
    shapes = {"a": (64, 48), "b": [(48,), (3, 5, 7)], "c": {"d": (1,)}}
    tree = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                        shapes, is_leaf=lambda x: isinstance(x, tuple))

    def to_t(t):
        return tree_map(lambda x: torch.from_numpy(np.array(x)), t)
    for clip in (1.0, 0.0):
        ocfg = dict(OPT, grad_clip=clip, warmup_steps=3)
        jstep = jax.jit(lambda p, g, o: japply(JAdamWConfig(**ocfg), p, g, o))
        jp, jo = tree, _ref_opt(tree)
        tp, to = to_t(tree), init_state(AdamWConfig(**ocfg), to_t(tree))
        for _ in range(2):
            grads = jax.tree.map(
                lambda x: rng.standard_normal(x.shape).astype(np.float32)
                * 0.3, tree)
            jp, jo, jm = jstep(jp, grads, jo)
            tp, to, tm = apply_updates(AdamWConfig(**ocfg), tp,
                                       tree_leaves(to_t(grads)), to)
            assert float(tm["lr"]) == float(jm["lr"])
            assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
                <= 1e-6 * float(jm["grad_norm"])
        for name, got, want in (("params", tp, jp),
                                *((k, to[k], jo[k])
                                  for k in ("m", "v", "master"))):
            worst = max(_rel(g, torch.from_numpy(np.array(w)))
                        for g, w in zip(tree_leaves(got),
                                        jax.tree.leaves(want)))
            assert worst <= 1e-6, (clip, name, worst)
        assert int(to["step"]) == int(jo["step"]) == 2


def test_schedule_matches_reference():
    cfg = dict(lr=3e-4, warmup_steps=100, total_steps=10_000)
    for step in (0, 1, 50, 100, 5_000, 10_000):
        want = float(jschedule(JAdamWConfig(**cfg), jnp.asarray(step)))
        got = float(schedule(AdamWConfig(**cfg), torch.tensor(step)))
        assert got == want, (step, got, want)


def test_init_state_layout():
    tcfg = tconfigs.get_smoke("recurrentgemma_2b")
    params = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.bfloat16)
    st = init_state(AdamWConfig(), params)
    assert int(st["step"]) == 0 and st["step"].dtype == torch.int32
    for p, m, master in zip(tree_leaves(params), tree_leaves(st["m"]),
                            tree_leaves(st["master"])):
        assert m.dtype == master.dtype == torch.float32
        assert not bool(m.any()) and torch.equal(master, p.float())
        assert master.data_ptr() != p.data_ptr()
    assert "master" not in init_state(AdamWConfig(master_weights=False),
                                      params)


# ----------------------------------------------------------------------
# gradient accumulation and training progress (tests/test_models.py)
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def accumulation():
    """granite's smoke step at microbatches (1, None), (2, None) and
    (2, (1, 0)) on the port, and the reference's (2, None)."""
    tcfg, jcfg, tree = _start("granite3_8b", seed=2)
    opt_cfg = dict(lr=1e-3, warmup_steps=0, total_steps=10, grad_clip=0.0)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tcfg.vocab, (4, 16)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    out = {}
    for mb, order in ((1, None), (2, None), (2, (1, 0))):
        params = TM.params_from_jax(tcfg, tree, device="cpu")
        opt = opt_state_from_jax(tcfg, _ref_opt(tree), device="cpu")
        step = make_train_step(tcfg, TrainConfig(
            optimizer=AdamWConfig(**opt_cfg), microbatches=mb,
            microbatch_order=order), device="cpu")
        p2, _, m = step(params, opt, tb)
        out[(mb, order)] = (float(m["loss"]), p2)
    jp2, _, jm = _ref_run(jmake_train_step(jcfg, JTrainConfig(
        optimizer=JAdamWConfig(**opt_cfg), microbatches=2)),
        jax.tree.map(jnp.asarray, tree),
        jax.tree.map(jnp.asarray, _ref_opt(tree)), jb)
    ref = (float(jm["loss"]), TM.params_from_jax(tcfg, _np(jp2), device="cpu"))
    return out, ref


@pytest.mark.parametrize("key", [(2, None), (2, (1, 0))])
def test_grad_accumulation_matches_full_batch(accumulation, key):
    out, (jl, jp) = accumulation
    l1, p1 = out[(1, None)]
    l2, p2 = out[key]
    assert abs(l1 - l2) < 1e-4 and abs(l2 - jl) < 1e-5 * abs(jl)
    for a, b, c in zip(tree_leaves(p1), tree_leaves(p2), tree_leaves(jp)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-3,
                                   atol=2e-5)
        np.testing.assert_allclose(b.numpy(), c.numpy(), rtol=2e-3,
                                   atol=2e-5)


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "qwen2_vl_7b"])
def test_remat_off_matches_remat_on(arch):
    """``remat=False`` (no checkpointed layers or loss chunks) gives the
    loss and gradients of ``remat=True`` bit for bit: the recomputation
    runs the same ops on the same inputs.  S = 24, so the loss runs three
    chunks; qwen2-vl slices its patches off before the head."""
    from repro_torch.train import loss_and_grads
    cfg = tconfigs.get_smoke(arch)
    base = TM.init_params(cfg, torch.Generator().manual_seed(1),
                          device="cpu", dtype=torch.float32)
    batch = make_batch(cfg, DataConfig(seed=2), 0, B, S, device="cpu")
    out = {}
    for remat in (True, False):
        params = tree_map(lambda t: t.detach().clone(), base)
        loss, grads = loss_and_grads(
            params, dataclasses.replace(cfg, remat=remat), batch)
        out[remat] = (loss, grads)
    assert cfg.remat and torch.equal(out[True][0], out[False][0])
    for on, off in zip(out[True][1], out[False][1]):
        assert (on is None) == (off is None)
        assert on is None or torch.equal(on, off)


def test_loss_decreases_under_training():
    cfg = tconfigs.get_smoke("phi4_mini_3_8b")
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=2e-3, warmup_steps=2,
                                             total_steps=40))
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.float32)
    opt = init_state(tcfg.optimizer, params)
    step = make_train_step(cfg, tcfg, device="cpu")
    losses = []
    for i in range(6):
        b = make_batch(cfg, DataConfig(), i % 2, 8, 32, device="cpu")
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


# ----------------------------------------------------------------------
# data, checkpoints, compression
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch,step", [("granite3_8b", 0), ("qwen2_vl_7b", 3),
                                       ("musicgen_large", 5)])
def test_make_batch_identical_to_reference(arch, step):
    tcfg, jcfg = tconfigs.get_smoke(arch), jconfigs.get_smoke(arch)
    want = jmake_batch(jcfg, JDataConfig(seed=7), step, 3, 20)
    got = make_batch(tcfg, DataConfig(seed=7), step, 3, 20, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        if k == "patches":
            assert got[k].dtype == torch.bfloat16
            assert np.array_equal(got[k].view(torch.int16).numpy(),
                                  w.view(np.int16))
        else:
            assert got[k].dtype == torch.int32
            assert np.array_equal(got[k].numpy(), w)
        shape, dtype = batch_specs(tcfg, 3, 20)[k]
        assert tuple(got[k].shape) == shape and got[k].dtype == dtype


def test_checkpoint_round_trip_bitwise(tmp_path):
    """A bf16 model with its AdamW state (float32 m, v, master; an int32
    step) through save and restore, bit for bit, and ``latest_step``."""
    tcfg = tconfigs.get_smoke("recurrentgemma_2b")
    params = TM.init_params(tcfg, torch.Generator().manual_seed(1),
                            device="cpu", dtype=torch.bfloat16)
    opt = init_state(AdamWConfig(), params)
    opt["m"] = tree_map(lambda t: torch.randn_like(t), opt["m"])
    opt["step"] = torch.tensor(7, dtype=torch.int32)
    path = str(tmp_path / "ck")
    assert latest_step(path) is None
    save(path, 3, params, opt, extra={"arch": tcfg.name})
    save(path, 10, params, opt)
    assert latest_step(path) == 10
    step, tree = restore(path, device="cpu")
    assert step == 10 and int(tree["opt"]["step"]) == 7
    assert tree["opt"]["step"].dtype == torch.int32
    assert tree["opt"]["step"].shape == ()
    for name, a, b in (("params", params, tree["params"]),
                       *((k, opt[k], tree["opt"][k])
                         for k in ("m", "v", "master"))):
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            assert x.dtype == y.dtype, name
            assert torch.equal(x.view(torch.int16) if x.dtype ==
                               torch.bfloat16 else x,
                               y.view(torch.int16) if y.dtype ==
                               torch.bfloat16 else y), name
    assert restore(path, step=3, device="cpu")[0] == 3


def test_reference_checkpoint_restored_by_the_port(tmp_path):
    """The reference's ``save`` of a tree with bfloat16 and float32 leaves:
    the port's ``restore`` (no ml_dtypes) then ``params_from_jax`` equals
    ``params_from_jax`` of the tree itself, bit for bit."""
    tcfg, _, tree = _start("gemma2_2b", seed=6)
    jtree = jax.tree.map(
        lambda x: jnp.asarray(x, jnp.float32 if x.ndim == 1 else
                              jnp.bfloat16), tree)
    jsave(str(tmp_path), 4, jtree, extra={"arch": "gemma2"})
    step, got = restore(str(tmp_path), device="cpu")
    assert step == 4 and latest_step(str(tmp_path)) == 4
    a = tree_leaves(TM.params_from_jax(tcfg, got["params"], device="cpu"))
    b = tree_leaves(TM.params_from_jax(tcfg, _np(jtree), device="cpu"))
    assert {x.dtype for x in a} == {torch.bfloat16, torch.float32}
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        if x.dtype == torch.bfloat16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        assert torch.equal(x, y)


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 7), (2, 512), (3, 4096)])
def test_quantize_int8_bitwise_against_reference(seed, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32) * rng.uniform(1e-3, 1e3)
    jq, js = jquantize(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    assert np.array_equal(dequantize(q, s).numpy(),
                          np.asarray(jdequantize(jq, js)))


# ----------------------------------------------------------------------
# the DAGPS pipeline plan and the examples
# ----------------------------------------------------------------------

@pytest.mark.parametrize("P,M", [(4, 8), (4, 16), (8, 16)])
def test_pipeline_plan_matches_reference(P, M):
    want = jschedule_pipeline(P, M, 1.0)
    got = schedule_pipeline(P, M, 1.0, device="cpu")
    assert got.order == want.order
    assert got.makespan == want.makespan
    assert got.bubble_fraction == want.bubble_fraction
    assert got.microbatch_order == want.microbatch_order
    for t, j in ((gpipe_makespan, jgpipe), (one_f_one_b_makespan, j1f1b),
                 (ideal_makespan, jideal)):
        assert t(P, M, 1.0) == j(P, M, 1.0)
        assert t(P, M, 1.0, 1.5) == j(P, M, 1.0, 1.5)


def _run_example(name, argv, capsys):
    old = sys.argv
    sys.argv = [name] + argv
    try:
        runpy.run_path(os.path.join(ROOT, "examples", name),
                       run_name="__main__")
    finally:
        sys.argv = old
    return capsys.readouterr().out


def test_pipeline_example_twin_prints_the_reference(capsys):
    want = _run_example("pipeline_dagps.py", [], capsys)
    got = _run_example("torch_pipeline_dagps.py", ["--device", "cpu"], capsys)
    assert got == want and "first events" in got


def test_train_example_runs_on_cpu(capsys):
    out = _run_example("torch_train_lm.py",
                       ["--device", "cpu", "--steps", "3", "--batch", "2",
                        "--seq", "32"], capsys)
    lines = [ln for ln in out.splitlines() if ln.startswith("step")]
    assert len(lines) == 2 and out.rstrip().endswith("done.")
    assert all(np.isfinite(float(ln.split()[3])) for ln in lines)
