"""Processes of the sharded-program tests (``tests/test_torch_sharded*.py``).

Run as ``python tests/torch_sharded_worker.py MODE ...``, each rank mode
over the runs of a list in turn (`ARCHS` by default).  A run is a family,
on the 2x2 ("data", "model") mesh, ``family@DxM`` on the ("data",
"model") mesh of those sizes, or ``family@DxExM``, on the ("data",
"expert", "model") mesh of those sizes (the expert-factorized meshes of
``repro.launch.mesh``'s ``expert_axis``); a run of `RUN_CONFIG` takes
its family's smoke config with those fields changed, on both sides:

  * ``jax TMP RUN``: the JAX package's own sharded train step on the run's
    mesh of 4 of 8 forced host devices, jitted with the
    shardings of ``repro.launch.dryrun.lower_cell``'s train cell
    (``tree_shardings``, ``batch_shardings``, inside ``activation_sharding``)
    at XLA's backend optimization level 0.  The mesh is built here with
    ``AxisType.Auto`` axes: jax's default Explicit axes refuse the
    ``with_sharding_constraint`` of the reference's ``logical``.  Its
    ``memory_analysis`` (argument and temp bytes) is kept beside.
  * ``jaxmem TMP ARCHS``: the JAX package's train step of each smoke
    config in ARCHS (comma-separated) on one device, compiled for its
    ``memory_analysis`` alone (`jax_memory`).
  * ``train RANK N TMP RUNS`` and ``serve RANK N TMP RUNS``: one rank of
    the port's sharded program on gloo (a FileStore in TMP) on the run's
    mesh (``make_debug_mesh`` for the 2x2 one): the train step (``make_train_step`` on DTensors
    from ``distribute_tree``/``distribute_batch``), or prefill, four decode
    steps and ``greedy_generate`` (parameters TP-only, as the reference's
    serving cells; a vision model takes its patches and no
    ``greedy_generate``, which cannot serve it); ``serve`` of the default
    runs also runs ``layers.attention`` on DTensors, forward and
    backward, on (1, 4) and (2, 2) meshes (`ATTN_CASES`).  Rank 0 also
    runs the unsharded twin on plain tensors.  For an MoE family both
    sides record each MoE layer's routing (`ROUTED`).  A `COMM_RUNS`
    train run also reads its step's memory on rank 0 (`read_memory`).
  * ``dry TMP``: the dry run's counts of the jobs in ``TMP/dry_in.pkl``
    (`dry_jobs`), each on a mesh over a fake process group this process
    owns, as ``launch/dryrun.py`` counts a cell.

Each reads ``TMP/in.pkl`` (`write_inputs`) and writes a pickle of numpy
arrays; the test files start the processes (`start`) and read them.  A
rank leaves by ``os._exit`` once its pickle is written (`main`).
"""

from __future__ import annotations

import contextlib
import os
import pickle
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
ARCHS = ["gemma2_2b", "recurrentgemma_2b", "rwkv6_7b"]
MOE = ["deepseek_moe_16b", "mixtral_8x7b"]
#: the MoE families on an expert-factorized mesh each: experts on their
#: own axis beside "model" (deepseek-moe) and beside "data" (mixtral)
MOE_EXPERT = ["deepseek_moe_16b@1x2x2", "mixtral_8x7b@2x2x1"]
DENSE = ["phi4_mini_3_8b", "granite3_8b", "codeqwen15_7b", "qwen2_vl_7b",
         "musicgen_large"]
#: the runs whose step's collectives are booked by kind and site
COMM_RUNS = ("gemma2_2b", "deepseek_moe_16b")
#: smoke configs whose head, KV-head, codebook or LoRA widths do not
#: divide a model axis of 4, as the full configs' do not divide 16: the
#: faults a 16x16 mesh met in the port's program, each held at 1x4
RUN_CONFIG = {
    "gemma2_2b@1x4": dict(n_heads=6, n_kv_heads=3),      # 8, 4 on 16
    "recurrentgemma_2b@1x4": dict(n_heads=2),            # 10, 1 on 16
    "rwkv6_7b@1x4": {},                                  # 5 x 32 LoRA
    "musicgen_large@1x4": dict(n_codebooks=3),           # 4 on 16
}
#: the batch: 4 rows over "data" = 2, S above the smoke windows (16)
B, S = 4, 32
N_RANKS = 4
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
#: decode steps after the prefill; new tokens of ``greedy_generate``
N_DECODE = 4
#: the deleted hand model's charge for the `COMM_RUNS` step (B=4, S=32,
#: the 2x2 mesh; every group of 2): per kind, the count and the result
#: bytes (PERF.md §6)
MODEL_CHARGE = {
    "gemma2_2b": {"all-gather": (85, 548_864),
                  "reduce-scatter": (55, 270_336),
                  "all-reduce": (23, 5_888)},
    "deepseek_moe_16b": {"all-gather": (83, 1_130_496),
                         "reduce-scatter": (51, 559_104),
                         "all-reduce": (13, 3_328),
                         "all-to-all": (12, 393_216)}}


def split_run(run: str) -> tuple[str, tuple, tuple]:
    """(family, mesh shape, mesh axis names) of a run."""
    arch, _, mesh = run.partition("@")
    if not mesh:
        return arch, (2, 2), ("data", "model")
    shape = tuple(int(x) for x in mesh.split("x"))
    if len(shape) == 2:
        return arch, shape, ("data", "model")
    return arch, shape, ("data", "expert", "model")


def run_config(run: str):
    """The smoke config of a run's family, changed by `RUN_CONFIG`."""
    import dataclasses

    from repro_torch import configs
    return dataclasses.replace(configs.get_smoke(split_run(run)[0]),
                               **RUN_CONFIG.get(run, {}))


def write_inputs(tmp, trees: dict) -> None:
    """Per family (or `RUN_CONFIG` run) of ``trees``, its reference-layout
    numpy weights and a batch drawn from the port's ``make_batch`` (the
    reference's draws the same numbers)."""
    from repro_torch.data import DataConfig, make_batch
    out = {}
    for arch, tree in trees.items():
        batch = make_batch(run_config(arch), DataConfig(seed=3), 0, B,
                           S, device="cpu")
        # a vision model's bfloat16 patches go as float32, exactly
        out[arch] = {"tree": tree, "batch": {
            k: (v.float() if v.is_floating_point() else v).numpy()
            for k, v in batch.items()}}
    with open(os.path.join(tmp, "in.pkl"), "wb") as f:
        pickle.dump(out, f)


def start(mode: str, tmp, runs=ARCHS) -> list:
    """The processes of one mode: the JAX steps, a run each, or N_RANKS
    ranks taking ``runs`` in turn (their outputs ``{mode}{rank}.pkl``)."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    me = os.path.abspath(__file__)
    if mode in ("jax", "jaxmem"):
        argvs = [[mode, str(tmp), run] for run in runs]
    elif mode == "dry":
        argvs = [[mode, str(tmp)]]
    else:
        argvs = [[mode, str(r), str(N_RANKS), str(tmp), ",".join(runs)]
                 for r in range(N_RANKS)]
    return [subprocess.Popen([sys.executable, me, *a], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True) for a in argvs]


def finish(procs: list, timeout: float) -> None:
    """Wait for ``procs`` within ``timeout`` seconds in all; kill what is
    left and fail with its error output."""
    end = time.monotonic() + timeout
    errs = []
    for p in procs:
        try:
            _out, err = p.communicate(timeout=max(end - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.communicate()
            raise AssertionError(f"{p.args[2:]} did not finish in {timeout} s")
        if p.returncode != 0:
            errs.append(err[-3000:])
    assert not errs, "\n".join(errs)


def load(tmp, name: str):
    with open(os.path.join(tmp, name), "rb") as f:
        return pickle.load(f)


def assert_none_alive(procs: list) -> None:
    """Every process of ``procs`` has ended and none is still a child of
    this one."""
    assert procs and all(p.poll() is not None for p in procs)
    live = set()
    for task in os.listdir("/proc/self/task"):
        with open(f"/proc/self/task/{task}/children") as f:
            live.update(int(x) for x in f.read().split())
    assert not {p.pid for p in procs} & live


def assert_close_leaves(got: dict, want: dict, atol: float) -> None:
    """The same paths, each leaf within ``atol``."""
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        np.testing.assert_allclose(leaf, want[path], rtol=0, atol=atol,
                                   err_msg=path)


# ----------------------------------------------------------------------
# the JAX package's sharded step
# ----------------------------------------------------------------------

def _jax_routes(cfg, routes: list):
    """Wrap the reference's ``moe_forward`` to hand ``routes`` each call's
    expert choices (B, S, K), taken from the MoE layer's input with the
    router ops of the reference's dispatch, through a debug callback."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from repro.models import layers as JL
    fwd = JL.moe_forward
    K = cfg.moe.top_k

    def moe_forward(p, x, mcfg):
        logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32),
                            p["router"].astype(jnp.float32))
        if mcfg.router_mode == "softmax_topk":
            _, idx = lax.top_k(jax.nn.softmax(logits, axis=-1), K)
        else:
            _, idx = lax.top_k(logits, K)
        jax.debug.callback(lambda i: routes.append(np.asarray(i)), idx)
        return fwd(p, x, mcfg)
    JL.moe_forward = moe_forward


def jax_train(tmp, run: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro import configs
    from repro.launch.sharding import (activation_rules, batch_shardings,
                                       tree_shardings)
    from repro.models.sharding import activation_sharding
    from repro.optim import AdamWConfig, init_state
    from repro.train import TrainConfig, make_train_step
    arch, shape, names = split_run(run)
    mesh = jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(
        shape))
    tcfg = TrainConfig(optimizer=AdamWConfig(**OPT))
    inputs = load(tmp, "in.pkl")
    d = inputs[run] if run in inputs else inputs[arch]
    # remat moves no value and only lengthens the compile
    cfg = dataclasses.replace(configs.get_smoke(arch), remat=False,
                              **RUN_CONFIG.get(run, {}))
    routes: list = []
    if cfg.moe is not None:
        _jax_routes(cfg, routes)
    rules = activation_rules(mesh, B, n_kv=cfg.n_kv_heads)
    with mesh, activation_sharding(mesh, rules):
        params = jax.tree.map(jnp.asarray, d["tree"])
        opt = init_state(tcfg.optimizer, params)
        batch = {k: jnp.asarray(v) for k, v in d["batch"].items()}
        pspec = tree_shardings(params, mesh)
        ospec = tree_shardings(opt, mesh)
        step = jax.jit(make_train_step(cfg, tcfg),
                       in_shardings=(pspec, ospec,
                                     batch_shardings(batch, mesh)),
                       out_shardings=(pspec, ospec, None))
        compiled = step.lower(params, opt, batch).compile(
            compiler_options={"xla_backend_optimization_level": 0,
                              "xla_llvm_disable_expensive_passes": True})
        p2, o2, m = compiled(params, opt, batch)
        jax.effects_barrier()
    xla = None
    if run in COMM_RUNS:
        # the reference's own count: its compiled program's collectives
        from repro.launch.roofline import parse_collectives
        xla = parse_collectives(compiled.as_text(), 4).to_json()
    mem = compiled.memory_analysis()
    out = {"xla_collectives": xla,
           "memory": {"argument_bytes": int(mem.argument_size_in_bytes),
                      "temp_bytes": int(mem.temp_size_in_bytes)},
           "params": jax.tree.map(np.asarray, p2),
           **{k: jax.tree.map(np.asarray, o2[k])
              for k in ("m", "v", "master")},
           "metrics": {k: float(v) for k, v in m.items()},
           "n_devices": len(p2["embed"].sharding.device_set),
           "routes": routes}
    with open(os.path.join(tmp, f"jax_{run}.pkl"), "wb") as f:
        pickle.dump(out, f)


def jax_memory(tmp, archs: str) -> None:
    """The JAX package's train step of each smoke config of ``archs`` on
    one device at (B, S), its parameters in the reference's default dtype,
    compiled at XLA's backend optimization level 0 (without remat, which
    moves no argument): ``memory_analysis``'s argument and temp bytes, to
    ``TMP/jaxmem_{archs}.pkl``."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.data import batch_specs
    from repro.models import model as JM
    from repro.optim import AdamWConfig, init_state
    from repro.train import TrainConfig, make_train_step
    out = {}
    for arch in archs.split(","):
        cfg = dataclasses.replace(configs.get_smoke(arch), remat=False)
        tcfg = TrainConfig(optimizer=AdamWConfig())
        params = jax.eval_shape(lambda k: JM.init_params(cfg, k),
                                jax.ShapeDtypeStruct((2,), jnp.uint32))
        opt = jax.eval_shape(lambda p: init_state(tcfg.optimizer, p), params)
        step = jax.jit(make_train_step(cfg, tcfg), donate_argnums=(0, 1))
        mem = step.lower(params, opt, batch_specs(cfg, B, S)).compile(
            compiler_options={"xla_backend_optimization_level": 0,
                              "xla_llvm_disable_expensive_passes": True}
        ).memory_analysis()
        out[arch] = {"argument_bytes": int(mem.argument_size_in_bytes),
                     "temp_bytes": int(mem.temp_size_in_bytes)}
    with open(os.path.join(tmp, f"jaxmem_{archs}.pkl"), "wb") as f:
        pickle.dump(out, f)


# ----------------------------------------------------------------------
# the port's sharded programs, one rank
# ----------------------------------------------------------------------

def _record_local_shapes(seen: list, routes: list | None = None) -> None:
    """Wrap the three kernels' plain versions (the CPU route of their ops)
    and the MoE's routing and combine (called in its dispatch and combine
    regions) to note the op and the shape of its first operand; each
    routing's expert choices (g, Tg, K) go to ``routes``."""
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.rg_lru import ref as gref
    from repro_torch.kernels.rwkv6 import ref as wref
    from repro_torch.models import layers as L

    def wrap(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            seen.append((name, tuple(a[0].shape)))
            return fn(*a, **k)
        setattr(mod, name, wrapped)
    for mod, names in ((fref, ("attention", "attention_bwd")),
                       (gref, ("rglru_scan", "rglru_scan_bwd")),
                       (wref, ("wkv6", "wkv6_bwd")),
                       (L, ("moe_route", "moe_combine"))):
        for name in names:
            wrap(mod, name)
    if routes is not None:
        route = L.moe_route

        def kept(*a, **k):
            w, idx = route(*a, **k)
            routes.append(idx.numpy().copy())
            return w, idx
        L.moe_route = kept


def _route_block(mesh, rules, B: int, S: int) -> tuple[int, int, int, int]:
    """(first batch row, first sequence position, rows, positions) of this
    rank's dispatch group under ``rules`` (one group a rank,
    `layers._moe_groups`)."""
    from repro_torch.models import layers as L
    from repro_torch.models.sharding import activation_sharding, axis_coord
    with activation_sharding(mesh, rules):
        G1, G2 = L._moe_groups(B, S)
    c1 = axis_coord(mesh, rules["batch"]) if G1 > 1 else 0
    c2 = axis_coord(mesh, rules["capacity"]) if G2 > 1 else 0
    return c1 * (B // G1), c2 * (S // G2), B // G1, S // G2


def _full(tree) -> dict:
    """path -> numpy array of every leaf, a DTensor gathered whole."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.sharding import tree_items
    return {"/".join(map(str, p)): (x.full_tensor() if isinstance(x, DTensor)
                                    else x).detach().numpy()
            for p, x in tree_items(tree)}


def _refusals(mesh) -> dict:
    """Each kernel op called on DTensors outside a region: its error."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rg_lru import ops as gops
    from repro_torch.kernels.rwkv6 import ops as wops

    def dt(*shape):
        return DTensor.from_local(torch.ones(*shape), mesh,
                                  [Replicate(), Replicate()], run_check=False)
    calls = {
        "flash_attention": lambda: fops.flash_attention(
            dt(2, 8, 2, 16), dt(2, 8, 2, 16), dt(2, 8, 2, 16)),
        "rglru_scan": lambda: gops.rglru_scan(dt(2, 8, 4), dt(2, 8, 4),
                                              dt(2, 4)),
        "wkv6": lambda: wops.wkv6(dt(2, 8, 2, 4), dt(2, 8, 2, 4),
                                  dt(2, 8, 2, 4), dt(2, 8, 2, 4), dt(2, 4),
                                  dt(2, 2, 4, 4))}
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except TypeError as e:
            out[name] = str(e)
    return out


def comm_mode():
    """The dry run's counter (``launch.dryrun.ProgramCounter``): each
    collective counted by kind (``count``), its result bytes summed
    (``nbytes``), both booked by site (``sites``: (phase, site, kind) ->
    [count, bytes]; in the backward the forward op's site, from anomaly
    mode's record, so the step runs under
    ``torch.autograd.detect_anomaly``), and the records
    (``collectives``)."""
    from repro_torch.launch.dryrun import ProgramCounter
    return ProgramCounter()


def collectives_table(comm, arch: str, xla: dict | None) -> dict:
    """``arch``'s step on the 2x2 mesh, three counts per kind: the
    reference's compiled program (``xla``: ``parse_collectives`` of its
    HLO), the port's program (``comm``: a `COMM_RUNS` rank's ``comm``
    record) and the deleted hand model's charge (`MODEL_CHARGE`); each a
    count and the ring-weighted bytes one device sends (what the
    roofline's collective term reads).  The port's collectives also by
    site."""
    from repro_torch.launch.roofline import collective_stats, ring_cost
    count, _nbytes, sites, records = comm
    port = collective_stats(records, N_RANKS).to_json()
    model = MODEL_CHARGE[arch]
    kinds = {}
    for k in sorted(set(port["count_by_kind"]) | set(model)
                    | set((xla or {}).get("count_by_kind", {}))):
        mn, mb = model.get(k, (0, 0))
        kinds[k] = {
            "xla": [(xla or {}).get("count_by_kind", {}).get(k, 0),
                    (xla or {}).get("bytes_by_kind", {}).get(k, 0.0)],
            "port": [port["count_by_kind"].get(k, 0),
                     port["bytes_by_kind"].get(k, 0.0)],
            "model": [mn, ring_cost(k, mb, 2)]}
    order = sorted(sites.items(), key=lambda kv: -kv[1][1])
    return {"arch": arch, "batch": B, "seq": S,
            "mesh": "data=2,model=2", "kinds": kinds,
            "step_sites": [[phase, site, kind, n, b]
                           for (phase, site, kind), (n, b) in order]}


def port_train(rank: int, mesh, run: str, d: dict) -> dict:
    import torch

    from repro_torch import configs
    from repro_torch.launch.sharding import (activation_rules,
                                             distribute_batch,
                                             distribute_tree, placements,
                                             tree_items, tree_shardings)
    from repro_torch.models import model as M
    from repro_torch.models.sharding import activation_sharding
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.train import TrainConfig, make_train_step
    cfg = run_config(run)
    tc = TrainConfig(optimizer=AdamWConfig(**OPT))
    step = make_train_step(cfg, tc, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in d["batch"].items()}

    def fresh():
        params = M.params_from_jax(cfg, d["tree"], device="cpu")
        return params, init_state(tc.optimizer, M.params_from_jax(
            cfg, d["tree"], device="cpu"))
    seen: list = []
    routes: list = []
    _record_local_shapes(seen, routes)
    params, opt = fresh()
    specs = {"params": tree_shardings(params, mesh, cfg),
             **{k: tree_shardings(opt[k], mesh, cfg)
                for k in ("m", "v", "master")}}
    params, opt = (distribute_tree(params, mesh, cfg),
                   distribute_tree(opt, mesh, cfg))
    # the collectives of a `COMM_RUNS` step, which the tests hold against
    # the dry run's (the mode's hook on every op slows the step)
    booked = run in COMM_RUNS
    comm = comm_mode() if booked else contextlib.nullcontext()
    anomaly = (torch.autograd.detect_anomaly(check_nan=False) if booked
               else contextlib.nullcontext())
    dbatch = distribute_batch(batch, mesh)
    rules = activation_rules(mesh, B, n_kv=cfg.n_kv_heads)
    t0 = time.perf_counter()
    with activation_sharding(mesh, rules), comm, anomaly:
        params, opt, m = step(params, opt, dbatch)
    n_moe = sum(f == "moe" for _, f in cfg.layer_plan)
    r = {"step_s": time.perf_counter() - t0, "seen": sorted(set(seen)),
         # the forward's routings (a recompute routes again after them)
         "routes": (routes[:n_moe], _route_block(mesh, rules, B, S)),
         "comm": (dict(getattr(comm, "count", {})),
                  dict(getattr(comm, "nbytes", {})),
                  dict(getattr(comm, "sites", {})),
                  list(getattr(comm, "collectives", []))),
         "metrics": {k: (float(v.full_tensor()), [str(p) for p in
                                                   v.placements])
                     for k, v in m.items()}}
    if booked:
        r["memory"] = read_memory(mesh, cfg, step, fresh, batch, rules)
    trees = {"params": params, **{k: opt[k] for k in ("m", "v", "master")}}
    r["placements"] = {
        key: {"/".join(map(str, p)): ([str(x) for x in placements(s, mesh)],
                                      [str(x) for x in leaf.placements])
              for (p, s), (_, leaf) in zip(tree_items(specs[key]),
                                           tree_items(trees[key]))}
        for key in trees}
    t0 = time.perf_counter()
    r["sharded"] = {k: _full(t) for k, t in trees.items()}
    r["gather_s"] = time.perf_counter() - t0
    if rank == 0:
        params, opt = fresh()
        routes.clear()
        params, opt, m = step(params, opt, batch)
        r["plain_routes"] = routes[:n_moe]
        r["plain"] = {"params": _full(params),
                      **{k: _full(opt[k]) for k in ("m", "v", "master")}}
        r["plain_metrics"] = {k: float(v) for k, v in m.items()}
        r["refused"] = _refusals(mesh)
    return r


def read_memory(mesh, cfg, step, fresh, batch, rules) -> dict:
    """This rank's memory read (``launch.dryrun.MemoryReader`` on the CPU's
    storages) of one more train step from fresh weights, the LM ops on
    their shape-only route (``kernels.pin.shape_route``), so that they
    allocate what their kernels would, as the dry run's meta count does."""
    from repro_torch.kernels import pin
    from repro_torch.launch import dryrun
    from repro_torch.launch.sharding import distribute_batch, distribute_tree
    from repro_torch.models.sharding import activation_sharding
    params, opt = fresh()
    params, opt = (distribute_tree(params, mesh, cfg),
                   distribute_tree(opt, mesh, cfg))
    dbatch = distribute_batch(batch, mesh)
    pc = dryrun.ProgramCounter(memory="cpu")
    pc.reader.arguments((params, opt, dbatch))
    with activation_sharding(mesh, rules), pin.shape_route(), pc:
        out = step(params, opt, dbatch)
    mem = dryrun.read_memory(pc.reader, out)
    pc.reader.close()
    return mem


def port_serve(rank: int, mesh, run: str, d: dict) -> dict:
    import torch

    from repro_torch import configs
    from repro_torch.launch.sharding import (activation_rules,
                                             distribute_batch,
                                             distribute_state,
                                             distribute_tree)
    from repro_torch.models import model as M
    from repro_torch.models.sharding import activation_sharding
    from repro_torch.serve.engine import greedy_generate, pad_prefill_state
    cfg = run_config(run)
    tokens = torch.from_numpy(d["batch"]["tokens"])
    steps = torch.from_numpy(d["batch"]["labels"][:, -N_DECODE:])
    # a vision model prefills its patches first, and decodes after them
    prompt = {"tokens": tokens}
    if cfg.vlm_patches:
        prompt["patches"] = torch.from_numpy(d["batch"]["patches"])
    P = cfg.vlm_patches

    def serve(params, put_batch, put_state):
        logits, st = M.prefill(params, cfg, put_batch(prompt))
        out = {"prefill": (_full({"x": logits})["x"], _full(st))}
        st = put_state(pad_prefill_state(cfg, st, P + S + N_DECODE))
        decoded = []
        for j in range(N_DECODE):
            tb = put_batch({"t": steps[:, j:j + 1],
                            "p": torch.full((B,), P + S + j)})
            lg, st = M.decode_step(params, cfg, st, tb["t"], tb["p"])
            decoded.append(_full({"x": lg})["x"])
        out["decode"] = (decoded, _full(st))
        if not P:
            g = greedy_generate(params, cfg, put_batch({"t": tokens})["t"],
                                N_DECODE, device="cpu")
            out["greedy"] = (_full({"x": g})["x"],
                             [str(p) for p in getattr(g, "placements", ())])
        return out

    params = distribute_tree(M.params_from_jax(cfg, d["tree"], device="cpu"),
                             mesh, cfg, fsdp=False)
    t0 = time.perf_counter()
    with activation_sharding(mesh, activation_rules(
            mesh, B, n_kv=cfg.n_kv_heads)):
        r = serve(params, lambda b: distribute_batch(b, mesh),
                  lambda st: distribute_state(st, mesh, B))
        r["serve_s"] = time.perf_counter() - t0
    if P:
        if rank == 0:
            plain = M.params_from_jax(cfg, d["tree"], device="cpu")
            r["plain"] = serve(plain, lambda b: b, lambda st: st)
        return r
    with activation_sharding(mesh, activation_rules(
            mesh, B, n_kv=cfg.n_kv_heads)):
        # a prompt that differs between ranks: refused plain; distributed,
        # rank 0's on every rank
        mine = (tokens + rank) % cfg.vocab
        try:
            greedy_generate(params, cfg, mine, 1, device="cpu")
            r["plain_prompt"] = None
        except TypeError as e:
            r["plain_prompt"] = str(e)
        g = greedy_generate(params, cfg, distribute_batch({"t": mine}, mesh)
                            ["t"], N_DECODE, device="cpu")
        r["rank_prompt"] = _full({"x": g})["x"]
    if rank == 0:
        plain = M.params_from_jax(cfg, d["tree"], device="cpu")
        r["plain"] = serve(plain, lambda b: b, lambda st: st)
    return r


#: flash on local shards: (mesh (data, model), B, H, KV, the query heads
#: a shard holds); S, hd fixed.  The ways of `layers._flash_region`: KV
#: heads on "model" (KV divides it); KV whole, each shard taking the one
#: KV head its query block reads (twice); the query heads whole (no block
#: reads a single KV head); MQA, on both meshes.
ATTN_CASES = (((1, 4), 2, 4, 4, 1), ((1, 4), 2, 4, 2, 1),
              ((1, 4), 2, 8, 2, 2), ((2, 2), 4, 6, 3, 6),
              ((2, 2), 4, 4, 1, 2), ((1, 4), 2, 4, 1, 1))
ATTN_S, ATTN_HD = 24, 16


def port_attn() -> list:
    """``layers.attention`` on DTensors (replicated inputs, the region
    redistributes them) inside activation_sharding, forward and backward,
    for each of `ATTN_CASES`, gathered whole beside the plain call."""
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import activation_rules
    from repro_torch.models import layers as L
    from repro_torch.models.sharding import activation_sharding
    seen: list = []
    _record_local_shapes(seen)
    meshes = {shape: make_debug_mesh(*shape, device_type="cpu")
              for shape in {c[0] for c in ATTN_CASES}}
    out = []
    for i, (shape, B, H, KV, _) in enumerate(ATTN_CASES):
        mesh = meshes[shape]
        gen = torch.Generator().manual_seed(i)
        q = torch.randn(B, ATTN_S, H, ATTN_HD, generator=gen)
        k, v = (torch.randn(B, ATTN_S, KV, ATTN_HD, generator=gen)
                for _ in range(2))
        do = torch.randn(B, ATTN_S, H, ATTN_HD, generator=gen)
        opts = dict(causal=True, window=8, cap=50.0)
        rep = [Replicate(), Replicate()]
        dq, dk, dv = (distribute_tensor(t, mesh, rep).requires_grad_()
                      for t in (q, k, v))
        seen.clear()
        with activation_sharding(mesh, activation_rules(mesh, B, n_kv=KV)):
            o = L.attention(dq, dk, dv, **opts)
        o.backward(distribute_tensor(do, mesh, o.placements))
        local = sorted(set(seen))
        pq, pk, pv = (t.clone().requires_grad_() for t in (q, k, v))
        po = L.attention(pq, pk, pv, **opts)
        po.backward(do)
        out.append(dict(
            seen=local,
            sharded=[t.full_tensor().detach().numpy()
                     for t in (o, dq.grad, dk.grad, dv.grad)],
            plain=[t.detach().numpy() for t in (po, pq.grad, pk.grad,
                                                pv.grad)]))
    return out


def _dry_one(job: dict):
    """One job of `dry_jobs`."""
    import dataclasses
    import math

    import torch

    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_group, fake_mesh
    what = job["what"]
    if what == "lower":          # a production cell, a smoke config in it
        return dryrun.lower_cell(job["arch"], job["shape"], job["multi"],
                                 job.get("variant", "base"),
                                 cfg=configs.get_smoke(job["arch"]),
                                 periods=job.get("periods"))
    if what == "cell_full":      # a full config's cell, whole
        return dryrun.roofline_cell(job["arch"], job["shape"], job["multi"])
    if what == "matmul":         # one sharded product, (d)
        from torch.distributed.tensor import DTensor, Replicate, Shard
        M_, K_, N_ = job["mkn"]
        with fake_group(4):
            mesh = fake_mesh((2, 2), ("data", "model"))
            x = DTensor.from_local(
                torch.empty(M_ // 2, K_, device="meta"), mesh,
                [Shard(0), Replicate()], run_check=False, shape=(M_, K_),
                stride=(K_, 1))
            w = DTensor.from_local(
                torch.empty(K_, N_ // 2, device="meta"), mesh,
                [Replicate(), Shard(1)], run_check=False, shape=(K_, N_),
                stride=(N_, 1))
            pc = dryrun.ProgramCounter()
            with pc:
                y = x @ w
            return {"flops": pc.flops, "ops": pc.ops,
                    "collectives": pc.collectives,
                    "placements": [str(p) for p in y.placements]}
    cfg = dataclasses.replace(configs.get_smoke(job["arch"]),
                              **job.get("fields", {}))
    if what == "plain":          # the plain program on one device
        from repro_torch.launch.mesh import AbstractMesh
        return dryrun.count_cell(cfg, "train", job["B"], job["S"],
                                 AbstractMesh((1, 1), ("data", "model")))
    if what == "loss_chunk":
        return _loss_chunk(cfg, job["mesh"])
    shape, names = job["mesh"]
    kind, b, s = job["kind"], job["B"], job["S"]
    dtype = getattr(torch, job.get("dtype", "bfloat16"))
    with fake_group(math.prod(shape)):
        mesh = fake_mesh(shape, names, job.get("device_type", "cuda"))
        return dryrun.count_cell(cfg, kind, b, s, mesh, dtype=dtype,
                                 periods=job.get("periods"))


def _loss_chunk(cfg, mesh_spec) -> dict:
    """One loss chunk of (B, S) (``model._chunk_loss``, forward and
    backward) on rank 0 of a cuda-typed fake mesh ``mesh_spec`` (shape,
    names), bfloat16 parameters on meta, the hidden states a leaf laid out
    as the embedding leaves them: the largest buffer the reader saw it
    allocate, and the chunk's local logits shard in float32 (B over the
    batch's axes, the vocab over the TP axes)."""
    import math

    import torch

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_group, fake_mesh
    from repro_torch.launch.sharding import (activation_rules,
                                             distribute_batch,
                                             distribute_tree)
    from repro_torch.models import model as M
    from repro_torch.models.sharding import activation_sharding, axis_prod
    from repro_torch.optim import tree_leaves
    shape, names = mesh_spec
    with fake_group(math.prod(shape)):
        mesh = fake_mesh(shape, names, "cuda")
        rules = activation_rules(mesh, B, n_kv=cfg.n_kv_heads)
        with activation_sharding(mesh, rules):
            params = distribute_tree(dryrun.meta_params(cfg), mesh, cfg)
            batch = distribute_batch(dryrun.meta_batch(cfg, B, S), mesh)
            x = M._embed(params, cfg, batch)[0][:, cfg.vlm_patches:]
            x = x.detach().requires_grad_(True)
            for p in tree_leaves(params):
                p.requires_grad_(True)
            pc = dryrun.ProgramCounter(memory="meta")
            with pc:
                M._chunk_loss(params, cfg, x, batch["labels"]).backward()
            pc.reader.close()
        K = max(cfg.n_codebooks, 1)
        bound = (B // axis_prod(mesh, rules["batch"]) * S * K
                 * cfg.vocab_padded // axis_prod(mesh, rules["vocab"]) * 4)
    return {"largest": pc.reader.largest_allocation(), "bound": bound}


def dry_jobs(tmp) -> None:
    """The jobs of ``TMP/dry_in.pkl`` (name -> job) counted in turn, each
    on a mesh over a fake group this process owns: the records (or, for
    a failing job, its error) to ``TMP/dry_out.pkl``."""
    import torch
    torch.set_num_threads(1)
    jobs = load(tmp, "dry_in.pkl")
    out = {}
    for name, job in jobs.items():
        t0 = time.perf_counter()
        try:
            out[name] = _dry_one(job)
        except Exception:  # noqa: BLE001 - the test reads the error
            out[name] = {"error": traceback.format_exc()[-3000:]}
        if isinstance(out[name], dict):
            out[name]["wall_s"] = time.perf_counter() - t0
    with open(os.path.join(tmp, "dry_out.pkl"), "wb") as f:
        pickle.dump(out, f)


def main(argv: list) -> None:
    mode = argv[0]
    if mode == "jax":
        jax_train(argv[1], argv[2])
        return
    if mode == "jaxmem":
        jax_memory(argv[1], argv[2])
        return
    if mode == "dry":
        dry_jobs(argv[1])
        return
    rank, n, tmp, runs = int(argv[1]), int(argv[2]), argv[3], argv[4]
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import make_debug_mesh
    torch.set_num_threads(1)
    # a store a mode: a file's train and serve ranks may run at once
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, f"store_{mode}"), n), rank=rank, world_size=n)
    meshes: dict = {}

    def mesh_of(run):
        _, shape, names = split_run(run)
        if shape not in meshes:
            if len(shape) == 2:
                meshes[shape] = make_debug_mesh(*shape, device_type="cpu")
            else:
                # a dim of size 1 shards nothing, so the run takes the
                # mesh's dims of size > 1 (the rules read an absent axis
                # as size 1); DTensor's strategy search then has two
                # dims to cost, not three
                full = init_device_mesh("cpu", shape, mesh_dim_names=names)
                meshes[shape] = full[tuple(n for n, k in zip(names, shape)
                                           if k > 1)]
        return meshes[shape]
    try:
        go = {"train": port_train, "serve": port_serve}[mode]
        inputs = load(tmp, "in.pkl")
        runs = runs.split(",")
        r = {run: go(rank, mesh_of(run), run,
                     inputs.get(run) or inputs[split_run(run)[0]])
             for run in runs}
        if mode == "serve" and runs == ARCHS:
            r["attn"] = port_attn()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"{mode}{rank}.pkl"), "wb") as f:
        pickle.dump(r, f)
    # done and written: leave without the interpreter's teardown, where
    # torch's gloo aborted 2 of 2,040 rank processes of
    # test_torch_launch.py's psum script ("terminate called without an
    # active exception", no Python frame left)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    main(sys.argv[1:])
