"""Processes of the sharded-program tests (``tests/test_torch_sharded*.py``).

Run as ``python tests/torch_sharded_worker.py MODE ...``, each rank mode
over the runs of a list in turn (`ARCHS` by default).  A run is a family,
on the 2x2 ("data", "model") mesh, or ``family@DxExM``, on the ("data",
"expert", "model") mesh of those sizes (the expert-factorized meshes of
``repro.launch.mesh``'s ``expert_axis``):

  * ``jax TMP RUN``: the JAX package's own sharded train step on the run's
    mesh of 4 of 8 forced host devices, jitted with the
    shardings of ``repro.launch.dryrun.lower_cell``'s train cell
    (``tree_shardings``, ``batch_shardings``, inside ``activation_sharding``)
    at XLA's backend optimization level 0.  The mesh is built here with
    ``AxisType.Auto`` axes: jax's default Explicit axes refuse the
    ``with_sharding_constraint`` of the reference's ``logical``.
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
    sides record each MoE layer's routing (`ROUTED`).

Each reads ``TMP/in.pkl`` (`write_inputs`) and writes a pickle of numpy
arrays; the test files start the processes (`start`) and read them.  A
rank leaves by ``os._exit`` once its pickle is written (`main`).
"""

from __future__ import annotations

import contextlib
import os
import pickle
import re
import subprocess
import sys
import time
import traceback
from collections import defaultdict

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
#: the batch: 4 rows over "data" = 2, S above the smoke windows (16)
B, S = 4, 32
N_RANKS = 4
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
#: decode steps after the prefill; new tokens of ``greedy_generate``
N_DECODE = 4
#: DTensor's collectives under the dry run's names (gloo has no
#: all-to-all on the CPU: DTensor takes an all-gather and a slice for it,
#: so the MoE's expert-parallel all-to-all is counted as an all-gather)
KINDS = {"all_gather_into_tensor": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "all_reduce": "all-reduce", "all_to_all_single": "all-to-all"}


def split_run(run: str) -> tuple[str, tuple, tuple]:
    """(family, mesh shape, mesh axis names) of a run."""
    arch, _, mesh = run.partition("@")
    if not mesh:
        return arch, (2, 2), ("data", "model")
    return arch, tuple(int(x) for x in mesh.split("x")), ("data", "expert",
                                                          "model")


def write_inputs(tmp, trees: dict) -> None:
    """Per family of ``trees``, its reference-layout numpy weights and a
    batch drawn from the port's ``make_batch`` (the reference's draws the
    same numbers)."""
    from repro_torch import configs
    from repro_torch.data import DataConfig, make_batch
    out = {}
    for arch, tree in trees.items():
        batch = make_batch(configs.get_smoke(arch), DataConfig(seed=3), 0, B,
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
    if mode == "jax":
        argvs = [[mode, str(tmp), run] for run in runs]
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
    d = load(tmp, "in.pkl")[arch]
    # remat moves no value and only lengthens the compile
    cfg = dataclasses.replace(configs.get_smoke(arch), remat=False)
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
    out = {"params": jax.tree.map(np.asarray, p2),
           **{k: jax.tree.map(np.asarray, o2[k])
              for k in ("m", "v", "master")},
           "metrics": {k: float(v) for k, v in m.items()},
           "n_devices": len(p2["embed"].sharding.device_set),
           "routes": routes}
    with open(os.path.join(tmp, f"jax_{run}.pkl"), "wb") as f:
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


_FRAME = re.compile(r'File "([^"]+)", line (\d+), in (\w+)')


def _site(frames) -> str | None:
    """``file:line function`` of the innermost frame of ``frames`` (file,
    line, function; outermost first) in the port, its sharding helpers
    left out (their caller is the site)."""
    for file, line, fn in reversed(list(frames)):
        f = file.replace(os.sep, "/")
        if "/repro_torch/" in f and not f.endswith("sharding.py"):
            return f"{f.rsplit('/', 1)[1]}:{line} {fn}"
    return None


def comm_mode():
    """``CommDebugMode`` that also counts each collective under the dry
    run's kind names (``count``), sums its result bytes (``nbytes``: what
    one rank receives, the gathered tensor of an all-gather, the
    scattered part of a reduce-scatter, the whole of an all-reduce) and
    books both by site (``sites``: (phase, site, kind) -> [count, bytes]).
    The site is the innermost frame of the port that issued it; in the
    backward, that of the forward op whose gradient issued it (anomaly
    mode's record of the node's forward stack, so the step runs under
    ``torch.autograd.detect_anomaly``).  The phase is "forward",
    "recompute" (a checkpointed layer rerun in the backward) or
    "backward"."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    class CommBytes(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.count = defaultdict(int)
            self.nbytes = defaultdict(float)
            self.sites = defaultdict(lambda: [0, 0.0])

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            name = getattr(func, "__name__", "").split(".")[0]
            if name in KINDS and isinstance(out, torch.Tensor):
                kind, nb = KINDS[name], out.numel() * out.element_size()
                self.count[kind] += 1
                self.nbytes[kind] += nb
                here = [(f.filename, f.lineno, f.name)
                        for f in traceback.extract_stack()]
                site, phase = _site(here), "forward"
                node = torch._C._current_autograd_node()
                if node is not None:
                    phase = "recompute"
                    if site is None or site.split(":")[0] == "step.py":
                        phase = "backward"
                        site = _site(_FRAME.findall("".join(
                            node.metadata.get("traceback_", []))))
                rec = self.sites[(phase, site, kind)]
                rec[0] += 1
                rec[1] += nb
            return out
    return CommBytes()


def _dry_run_site(op: str) -> str:
    """A dry-run record's op (``launch.dryrun.collectives_for``) with its
    layer or leaf name dropped."""
    if op in ("embed", "embed grad", "loss max/sum/gold", "head input",
              "head input grad"):
        return op
    if re.fullmatch(r"layer\d+ residual( grad)?", op):
        return op.split(" ", 1)[1]
    if re.fullmatch(r"(moe|attn)\d+ .+", op):
        kind, what = op.split(" ", 1)
        return f"{kind.rstrip('0123456789')} {what}"
    return "parameter " + op.rsplit(" ", 1)[1]


def collectives_table(comm, arch: str) -> dict:
    """``arch``'s sharded step on the 2x2 mesh (``comm``: a `COMM_RUNS`
    rank's ``comm`` record) beside the dry run's charge for the same
    config, shape (B=4, S=32) and mesh: per kind the count and result
    bytes of each and their ratios, and each side by site."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh
    count, nbytes, sites = comm
    recs = dryrun.collectives_for(
        configs.get_smoke(arch), {"batch": B, "seq": S, "kind": "train"},
        AbstractMesh((2, 2), ("data", "model")), fsdp=True)
    dry, dry_sites = defaultdict(lambda: [0, 0.0]), defaultdict(
        lambda: [0, 0.0])
    for kind, size, _group, op in recs:
        for rec in (dry[kind], dry_sites[(_dry_run_site(op), kind)]):
            rec[0] += 1
            rec[1] += size
    kinds = {}
    for k in sorted(set(count) | set(dry)):
        n, b = count.get(k, 0), nbytes.get(k, 0.0)
        dn, db = dry[k] if k in dry else (0, 0.0)
        kinds[k] = {"step_count": n, "step_bytes": b, "dry_run_count": dn,
                    "dry_run_bytes": db,
                    "count_ratio": n / dn if dn else None,
                    "bytes_ratio": b / db if db else None}
    order = sorted(sites.items(), key=lambda kv: -kv[1][1])
    return {"arch": arch, "batch": B, "seq": S,
            "mesh": "data=2,model=2", "kinds": kinds,
            "step_sites": [[phase, site, kind, n, b]
                           for (phase, site, kind), (n, b) in order],
            "dry_run_sites": [[site, kind, n, b] for (site, kind), (n, b)
                              in sorted(dry_sites.items(),
                                        key=lambda kv: -kv[1][1])]}


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
    arch = split_run(run)[0]
    cfg = configs.get_smoke(arch)
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
                  dict(getattr(comm, "sites", {}))),
         "metrics": {k: (float(v.full_tensor()), [str(p) for p in
                                                   v.placements])
                     for k, v in m.items()}}
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
    arch = split_run(run)[0]
    cfg = configs.get_smoke(arch)
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


def main(argv: list) -> None:
    mode = argv[0]
    if mode == "jax":
        jax_train(argv[1], argv[2])
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
                # DTensor expands an op's strategy over every combination
                # of its mesh dims' strategies: on three dims an einsum's
                # first call takes ~145 s here.  A dim of size 1 shards
                # nothing, so the run takes the mesh's dims of size > 1
                # (the rules read an absent axis as size 1)
                full = init_device_mesh("cpu", shape, mesh_dim_names=names)
                meshes[shape] = full[tuple(n for n, k in zip(names, shape)
                                           if k > 1)]
        return meshes[shape]
    try:
        go = {"train": port_train, "serve": port_serve}[mode]
        inputs = load(tmp, "in.pkl")
        runs = runs.split(",")
        r = {run: go(rank, mesh_of(run), run, inputs[split_run(run)[0]])
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
