"""The port's sharding and launch layer against the JAX reference, on the
CPU: ``launch/{mesh,sharding,roofline,dryrun,report}.py``,
``models/sharding.py``, ``compressed_psum`` and ``job_from_roofline``.

  * the parameter specs of all ten configurations at full width (shapes
    only: the reference's ``jax.eval_shape``, the port's meta tensors) on
    the 16x16, 2x16x16, expert-factorized (moe3d8) and 2x4 meshes, FSDP on
    and off, equal the reference's with its body's stack entry dropped;
    the five asserts of ``tests/test_launch.py::test_spec_guards_
    divisibility``; decode-state, batch and activation rules;
  * ``logical_spec`` against the spec the reference's ``logical`` hands to
    ``with_sharding_constraint`` (captured with ``monkeypatch``);
  * the MoE's dispatch groups under a 2x2 mesh's rules against the
    reference's ``moe_forward`` on a 4-device CPU mesh (a subprocess);
  * ``compressed_psum`` and ``compressed_psum_tree`` on gloo at world
    sizes 2 and 4 (a process a rank) bitwise against the reference's under
    ``shard_map`` (a subprocess), and ``distribute_tree`` on a 2x2 mesh;
  * twins of ``test_collective_parser`` and ``test_roofline_terms_math``;
  * the dry run, counted in one child process that owns the fake
    process groups its meshes need (`dry`): the four families' smoke
    configs as their sharded programs on a 2x4 mesh, one full-width
    cell's parameter counts and model FLOPs against the reference's; the
    report's tables; ``job_from_roofline`` on a record the port wrote, and
    ``schedule_cluster`` of both packages on the same jobs by ``repr``.
"""

import dataclasses
import json
import math
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from repro import configs as jconfigs
from repro.launch import cluster as jcluster
from repro.launch import report as jreport
from repro.launch import roofline as jroof
from repro.launch import sharding as jsh
from repro.models import model as JM
from repro.models import sharding as jmsh
from repro_torch import configs as tconfigs
from repro_torch.launch import cluster as tcluster
from repro_torch.launch import report as treport
from repro_torch.launch import roofline as troof
from repro_torch.launch import sharding as tsh
from repro_torch.launch.mesh import AbstractMesh, production_shape
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.sharding import activation_sharding, logical_spec
import torch_sharded_worker as W

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")

#: (name, shape, axis names) of the meshes the spec twins run on
MESHES = [("single", *production_shape()),
          ("multi", *production_shape(multi_pod=True)),
          ("moe3d8", *production_shape(expert_axis=8)),
          ("2x4", (2, 4), ("data", "model"))]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _meshes(shape, names):
    return AbstractMesh(shape, names), JAbstractMesh(shape, names)


def _ref_leaves(tree):
    """{path of names: (keypath, shape)} of a reference tree of shapes."""
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = tuple(getattr(k, "key", getattr(k, "name", str(k)))
                      for k in kp)
        out[names] = (kp, tuple(leaf.shape))
    return out


def _ref_path(cfg, path):
    """The reference tree's path of the port's leaf ``path`` and whether it
    sits in the stacked body."""
    if path[0] != "layers":
        return path, False
    top, g, key = TM._layer_keys(cfg)[path[1]]
    return (top,) + ((key,) if key else ()) + tuple(path[2:]), g is not None


def _drop_stack(spec, stacked):
    spec = tuple(spec)
    return spec[1:] if stacked and spec else spec


def _port_leaves(tree):
    return list(tsh.tree_items(tree))


@pytest.fixture(scope="module")
def ref_shapes():
    """The reference's parameter and decode-state shape trees, computed
    once per configuration."""
    out = {}

    def get(arch):
        if arch not in out:
            cfg = jconfigs.get(arch)
            key = jax.ShapeDtypeStruct((2,), jnp.uint32)
            shape = jconfigs.SHAPES["decode_32k"]
            out[arch] = (
                _ref_leaves(jax.eval_shape(lambda k: JM.init_params(cfg, k),
                                           key)),
                _ref_leaves(jax.eval_shape(lambda: JM.init_decode_state(
                    cfg, shape["batch"], shape["seq"]))))
        return out[arch]
    return get


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_param_specs_equal_the_reference(arch, ref_shapes):
    """Every parameter leaf of the full-width configuration on all four
    meshes, FSDP on and off."""
    cfg = tconfigs.get(arch)
    params = TM.init_params(cfg, torch.Generator(), device="meta")
    ref, _ = ref_shapes(arch)
    leaves = _port_leaves(params)
    assert {_ref_path(cfg, p)[0] for p, _ in leaves} == set(ref)
    for _label, shape, names in MESHES:
        tmesh, jmesh = _meshes(shape, names)
        for fsdp in (True, False):
            specs = dict(tsh.tree_items(tsh.tree_shardings(params, tmesh, cfg,
                                                      fsdp)))
            for path, leaf in leaves:
                rpath, stacked = _ref_path(cfg, path)
                kp, rshape = ref[rpath]
                assert rshape[int(stacked):] == tuple(leaf.shape), path
                want = jsh.spec_for_path(kp, rshape, jmesh, fsdp)
                assert tuple(specs[path]) == _drop_stack(want, stacked), (
                    _label, fsdp, path, specs[path], want)


def test_spec_guards_divisibility():
    """The five asserts of ``tests/test_launch.py``, on the port's paths
    (string keys) and a 2x4 abstract mesh; the stacked body leaf also as
    the port holds it, unstacked with its stack given."""
    mesh = AbstractMesh((2, 4), ("data", "model"))
    P = tsh.P
    s = tsh.spec_for_path(("body", "attn", "wk"), (8, 64, 2, 16), mesh)
    assert s == P(None, "data", None, None), s
    s = tsh.spec_for_path(("layers", 0, "attn", "wk"), (64, 2, 16), mesh,
                          stack=(8,))
    assert s == P("data", None, None), s
    s = tsh.spec_for_path(("mlp", "wg"), (64, 128), mesh)
    assert s == P("data", "model"), s
    s = tsh.spec_for_path(("mlp", "wg"), (64, 128), mesh, fsdp=False)
    assert s == P(None, "model"), s
    s = tsh.spec_for_path(("moe", "wg"), (8, 64, 128), mesh)
    assert s == P("model", "data", None), s
    s = tsh.spec_for_path(("moe", "wg"), (2, 64, 128), mesh)
    assert s == P(None, "data", "model"), s


def test_placements_take_a_missing_mesh_axis_as_size_one():
    """An axis that `launch.mesh` builds meshes with but this mesh lacks
    shards nothing (an expert-factorized rule on a mesh without its
    "expert" dim); any other axis name raises, as the reference's
    ``NamedSharding`` refuses an axis its mesh lacks."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = AbstractMesh((2, 2), ("data", "model"))
    P = tsh.P
    assert tsh.placements(P(("expert", "model"), None), mesh) == [
        Replicate(), Shard(0)]
    assert tsh.placements(P("data", ("pod", "expert")), mesh) == [
        Shard(0), Replicate()]
    for spec in (P("modle", None), P(None, ("data", "exprt"))):
        with pytest.raises(ValueError, match="neither in the mesh"):
            tsh.placements(spec, mesh)


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_state_batch_and_activation_rules_equal_the_reference(arch,
                                                              ref_shapes):
    """``decode_state_spec``/``state_shardings`` on the configuration's
    decode state at decode_32k, ``batch_shardings`` of its training batch
    and ``activation_rules``, on the single, multi-pod and moe3d8 meshes."""
    from repro.data import batch_specs as jbatch_specs
    from repro_torch.data import batch_specs as tbatch_specs
    cfg = tconfigs.get(arch)
    jcfg = jconfigs.get(arch)
    shape = tconfigs.SHAPES["decode_32k"]
    B, S = shape["batch"], shape["seq"]
    state = TM.init_decode_state(cfg, B, S, device="meta")
    _, ref = ref_shapes(arch)
    leaves = _port_leaves(state)
    assert {_ref_path(cfg, p)[0] for p, _ in leaves} == set(ref)
    for _label, mshape, names in MESHES[:3]:
        tmesh, jmesh = _meshes(mshape, names)
        specs = dict(tsh.tree_items(tsh.state_shardings(state, tmesh, B)))
        for path, leaf in leaves:
            rpath, stacked = _ref_path(cfg, path)
            kp, rshape = ref[rpath]
            want = jsh.decode_state_spec(kp, rshape, jmesh, B)
            got = tsh.decode_state_spec(path, tuple(leaf.shape), tmesh, B)
            assert tuple(got) == _drop_stack(want, stacked), (path, got, want)
            assert specs[path] == got
        for tshape in jconfigs.SHAPES.values():
            jb = jsh.batch_shardings(
                jbatch_specs(jcfg, tshape["batch"], tshape["seq"]), jmesh)
            tb = tsh.batch_shardings(
                tbatch_specs(cfg, tshape["batch"], tshape["seq"]), tmesh)
            assert {k: tuple(v) for k, v in tb.items()} == {
                k: tuple(v.spec) for k, v in jb.items()}
            for seq_shard in (True, False):
                assert tsh.activation_rules(
                    tmesh, tshape["batch"], n_kv=cfg.n_kv_heads,
                    seq_shard=seq_shard) == jsh.activation_rules(
                    jmesh, tshape["batch"], n_kv=jcfg.n_kv_heads,
                    seq_shard=seq_shard)


#: (shape, names, rules) for logical: a contested axis, a dim the axis does
#: not divide, tuple axes, a name prefix, unnamed dims
LOGICAL_CASES = [
    ((8, 64, 512), ("batch", "seq", "embed"),
     dict(batch="data", seq="model", embed=None)),
    ((8, 64, 16, 128), ("batch", "kv_seq", "heads", None),
     dict(batch="data", kv_seq="model", heads="model")),        # contested
    ((6, 64, 512), ("batch", "seq"),
     dict(batch="data", seq="model")),                          # 6 % 4, prefix
    ((8, 30, 512), ("batch", "seq", "embed"),
     dict(batch=("pod", "data"), seq="model", embed="model")),  # 30 % 4
    ((16, 8, 40, 512), ("moe_batch", "expert", None, "ffn"),
     dict(moe_batch="data", expert="model", ffn="model")),      # contested
    ((8, 12, 64), ("moe_group", None, None),
     dict(moe_group=("data", "model"))),                        # 8 % 8
    ((4, 1, 32000), ("batch", None, "vocab"),
     dict(batch="data", vocab=("expert", "model"))),
]


@pytest.mark.parametrize("shape,names,rules", LOGICAL_CASES)
def test_logical_spec_equals_the_reference(shape, names, rules, monkeypatch):
    """``logical_spec`` equals the spec the reference's ``logical`` builds,
    captured where it calls ``with_sharding_constraint``."""
    captured = []
    monkeypatch.setattr(jmsh, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jmsh.jax.lax, "with_sharding_constraint",
                        lambda x, s: captured.append(s) or x)
    for mshape, mnames in (((2, 4), ("data", "model")),
                           ((2, 2, 2, 2), ("pod", "data", "expert", "model"))):
        tmesh, jmesh = _meshes(mshape, mnames)
        captured.clear()
        with jmsh.activation_sharding(jmesh, rules):
            jmsh.logical(jax.ShapeDtypeStruct(shape, jnp.float32), *names)
        got = logical_spec(shape, names, rules, tmesh)
        assert tuple(got) == tuple(captured[0]), (mnames, got, captured[0])


MOE_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.launch.sharding import activation_rules
from repro.models import layers as L
from repro.models.sharding import activation_sharding
d = np.load(sys.argv[1], allow_pickle=True).item()
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
out = {}
for name, case in d.items():
    cfg = L.MoEConfig(**case["cfg"])
    p = jax.tree.map(jnp.asarray, case["p"])
    x = jnp.asarray(case["x"])
    with mesh, activation_sharding(mesh, activation_rules(mesh, x.shape[0])):
        groups = L._moe_groups(x.shape[0], x.shape[1])
        y = jax.jit(lambda p, x: L.moe_forward(p, x, cfg))(p, x)
    out[name] = dict(y=np.asarray(y), groups=groups)
np.save(sys.argv[2], out, allow_pickle=True)
"""


def _run(code: str, *args, env=None, timeout=300) -> str:
    full = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    full.update(env or {})
    proc = subprocess.run([sys.executable, "-c", code, *map(str, args)],
                          capture_output=True, text=True, env=full,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_moe_groups_under_a_mesh_equal_the_reference(tmp_path):
    """Under a 2x2 mesh's rules the dispatch groups tile the (data, model)
    grid, (2, 2) for B=2, S=16, and the port's ``moe_forward`` equals the
    reference's on a 4-device CPU mesh within the MoE tolerance of
    ``tests/test_torch_families.py``; with capacity drops the grouping
    changes the output (against the same input outside the mesh)."""
    from repro.models import layers as JL
    rng = np.random.default_rng(7)
    cases = {}
    for name, mode, n_shared in (("softmax", "softmax_topk", 0),
                                 ("topk_shared", "topk_softmax", 1)):
        jcfg = JL.MoEConfig(n_experts=4, top_k=2, d_expert=64,
                            n_shared=n_shared, capacity_factor=0.5,
                            router_mode=mode)
        p = jax.tree.map(np.asarray, JL.moe_init(
            jax.random.PRNGKey(len(cases)), 32, jcfg, dtype=jnp.float32))
        x = rng.standard_normal((2, 16, 32)).astype(np.float32)
        cases[name] = dict(cfg=dataclasses.asdict(jcfg), p=p, x=x)
    np.save(tmp_path / "in.npy", cases, allow_pickle=True)
    _run(MOE_REF, tmp_path / "in.npy", tmp_path / "out.npy")
    ref = np.load(tmp_path / "out.npy", allow_pickle=True).item()
    mesh = AbstractMesh((2, 2), ("data", "model"))
    for name, case in cases.items():
        tcfg = TL.MoEConfig(**case["cfg"])
        tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), case["p"])
        xt = torch.from_numpy(case["x"])
        with activation_sharding(mesh, tsh.activation_rules(mesh, 2)):
            assert TL._moe_groups(2, 16) == tuple(ref[name]["groups"]) \
                == (2, 2)
            got = TL.moe_forward(tp, xt, tcfg)
        np.testing.assert_allclose(got.numpy(), ref[name]["y"], rtol=0,
                                   atol=1e-5)
        alone = TL.moe_forward(tp, xt, tcfg)
        assert not np.allclose(alone.numpy(), got.numpy())


PSUM_PORT = r"""
import os, sys
import numpy as np, torch
import torch.distributed as dist
rank, n, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(tmp + "/store", n),
                        rank=rank, world_size=n)
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.optim import compressed_psum, compressed_psum_tree
mesh = make_debug_mesh(n, 1, device_type="cpu")
d = np.load(tmp + "/in.npy", allow_pickle=True).item()
x = torch.from_numpy(d["x"][rank])
tree = {"a": torch.from_numpy(d["a"][rank]),
        "b": [torch.from_numpy(d["b"][rank]).to(torch.bfloat16)]}
out = {"x": compressed_psum(x, "data", mesh).numpy()}
t = compressed_psum_tree(tree, "data", mesh)
out["a"] = t["a"].numpy()
out["b"] = t["b"][0].float().numpy()
out["b_dtype"] = str(t["b"][0].dtype)
if n == 4:
    from torch.distributed.tensor import DTensor
    from repro_torch import configs
    from repro_torch.launch.mesh import make_debug_mesh as mk
    from repro_torch.launch.sharding import (distribute_tree, tree_items,
                                             local_shape, tree_shardings)
    from repro_torch.models import model as M
    m2 = mk(2, 2, device_type="cpu")
    cfg = configs.get_smoke("gemma2_2b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu", dtype=torch.float32)
    specs = dict(tree_items(tree_shardings(params, m2, cfg)))
    dt = dict(tree_items(distribute_tree(params, m2, cfg)))
    full = dict(tree_items(params))
    sharded = 0
    for path, leaf in dt.items():
        assert isinstance(leaf, DTensor)
        assert tuple(leaf.to_local().shape) == local_shape(
            tuple(full[path].shape), specs[path], m2), path
        assert torch.equal(leaf.full_tensor(), full[path]), path
        sharded += any(e is not None for e in specs[path])
    out["sharded_leaves"] = sharded
np.save(f"{tmp}/out{rank}.npy", out, allow_pickle=True)
dist.destroy_process_group()
# done and written: leave without the interpreter's teardown, where
# torch's gloo aborted 2 of 2,040 such processes ("terminate called
# without an active exception", no Python frame left)
os._exit(0)
"""

PSUM_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.optim.compression import compressed_psum, compressed_psum_tree
tmp = sys.argv[1]
d = np.load(tmp + "/in.npy", allow_pickle=True).item()
n = d["x"].shape[0]
mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
f = jax.shard_map(lambda x: compressed_psum(x[0], "data")[None], mesh=mesh,
                  in_specs=P("data"), out_specs=P("data"), check_vma=False)
g = jax.shard_map(lambda t: jax.tree.map(
    lambda v: v[None], compressed_psum_tree(jax.tree.map(lambda v: v[0], t),
                                            "data")),
    mesh=mesh, in_specs=P("data"), out_specs=P("data"), check_vma=False)
t = g({"a": jnp.asarray(d["a"]),
       "b": [jnp.asarray(d["b"]).astype(jnp.bfloat16)]})
np.save(tmp + "/ref.npy", dict(x=np.asarray(f(jnp.asarray(d["x"]))),
                               a=np.asarray(t["a"]),
                               b=np.asarray(t["b"][0].astype(jnp.float32))),
        allow_pickle=True)
"""


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_psum_on_gloo_equals_the_reference(n, tmp_path):
    """Each rank's ``compressed_psum`` (and ``compressed_psum_tree``, one
    leaf cast back to bf16) bitwise equal to the reference's under
    ``shard_map`` on an n-device CPU mesh; every rank holds the same sum;
    at n = 4 ``distribute_tree`` on a 2x2 mesh shards the gemma2 smoke
    model by its specs and gathers back to it."""
    rng = np.random.default_rng(100 + n)
    d = {"x": (rng.standard_normal((n, 257)) * 3).astype(np.float32),
         "a": rng.standard_normal((n, 16, 24)).astype(np.float32),
         "b": (rng.standard_normal((n, 100)) * 1e-3).astype(np.float32)}
    d["x"][0, 5] = 40.0                # one replica's scale leads
    np.save(tmp_path / "in.npy", d, allow_pickle=True)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", PSUM_PORT, str(r),
                               str(n), str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(n)]
    _run(PSUM_REF, tmp_path)
    for p in procs:
        _out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
    ref = np.load(tmp_path / "ref.npy", allow_pickle=True).item()
    for r in range(n):
        got = np.load(tmp_path / f"out{r}.npy", allow_pickle=True).item()
        for key in ("x", "a", "b"):
            np.testing.assert_array_equal(got[key], ref[key][r])
            np.testing.assert_array_equal(got[key], ref[key][0])
        assert got["b_dtype"] == "torch.bfloat16"
        if n == 4:
            assert got["sharded_leaves"] > 0


def test_collective_stats_equal_the_reference_parser():
    """The five collectives of ``test_collective_parser`` as records (the
    async all-reduce's done half is the start's transfer, no record): the
    same bytes and counts as the reference's parse of their HLO text."""
    hlo = '''
  %all-gather = f32[4096,128]{1,0} all-gather(%x), channel_id=1, replica_groups=[16,16]<=[16,16]T(1,0), dimensions={0}
  %all-reduce.1 = bf16[128,64]{1,0} all-reduce(%y), replica_groups=[32,8]<=[256], to_apply=%add
  %ars = (f32[64]{0}, f32[64]{0}) all-reduce-start(%z), replica_groups={{0,1,2,3}}
  %ard = f32[64]{0} all-reduce-done(%ars)
  %cp = bf16[32,32]{1,0} collective-permute(%w), source_target_pairs={{0,1},{1,0}}
'''
    want = jroof.parse_collectives(hlo, 256)
    got = troof.collective_stats([
        ("all-gather", 4096 * 128 * 4, 16, "all-gather"),
        ("all-reduce", 128 * 64 * 2, 8, "all-reduce.1"),
        ("all-reduce", 64 * 4, 4, "ars"),   # the start's result half
        ("collective-permute", 32 * 32 * 2, 2, "cp")], 256)
    assert got.count_by_kind == want.count_by_kind
    assert got.bytes_by_kind.keys() == want.bytes_by_kind.keys()
    for k, v in want.bytes_by_kind.items():
        assert got.bytes_by_kind[k] == pytest.approx(v, rel=1e-12)
    assert got.total_bytes == pytest.approx(want.total_bytes, rel=1e-12)
    assert [t["bytes"] for t in got.top] == sorted(
        [t["bytes"] for t in got.top], reverse=True)


def test_roofline_terms_math():
    """The reference's test with the port's constants: H100 bf16 peak,
    HBM and NVLink rates; no TPU number."""
    coll = troof.CollectiveStats({"all-reduce": 1e9}, 1e9, {"all-reduce": 3})
    rl = troof.roofline_terms({"flops": troof.PEAK_FLOPS,
                               "bytes accessed": troof.HBM_BW}, coll,
                              n_devices=2, model_flops=2 * troof.PEAK_FLOPS)
    assert (troof.PEAK_FLOPS, troof.HBM_BW, troof.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    assert rl.compute_s == pytest.approx(1.0)
    assert rl.memory_s == pytest.approx(1.0)
    assert rl.collective_s == pytest.approx(1e9 / 450e9)
    assert rl.dominant in ("compute", "memory")
    assert rl.useful_ratio == pytest.approx(1.0)
    assert rl.roofline_fraction == pytest.approx(1.0)
    assert set(rl.to_json()) == set(jroof.roofline_terms(
        {"flops": 1.0}, jroof.CollectiveStats({}, 0.0, {}), 1, 1.0).to_json())


#: the families and kinds of `test_dry_run_counts_the_smoke_configs`
SMOKE_ARCHS = ["recurrentgemma_2b", "gemma2_2b", "deepseek_moe_16b",
               "rwkv6_7b"]
SMOKE_KINDS = ["train", "prefill", "decode"]
#: the full-width records the report and the jobs read
RECORD_ARCHS = ("deepseek_moe_16b", "gemma2_2b", "rwkv6_7b")


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    """The dry run's records of this file, counted in one child process
    (``torch_sharded_worker.dry_jobs``), each mesh over a fake process
    group the child owns: the smoke configs on a 2x4 mesh at B=8, S=64;
    deepseek-moe-16b train_4k on the single-pod mesh; and, for the report
    and the jobs, three smoke configs in train_4k cells of the single-pod
    mesh, named as the full ones."""
    tmp = tmp_path_factory.mktemp("dry")
    jobs = {f"smoke/{a}/{k}": dict(what="cell", arch=a, kind=k, B=8, S=64,
                                   mesh=((2, 4), ("data", "model")))
            for a in SMOKE_ARCHS for k in SMOKE_KINDS}
    jobs["full"] = dict(what="cell_full", arch="deepseek_moe_16b",
                        shape="train_4k", multi=False)
    for arch in RECORD_ARCHS:
        jobs[f"record/{arch}"] = dict(what="lower", arch=arch,
                                      shape="train_4k", multi=False)
    with open(tmp / "dry_in.pkl", "wb") as f:
        pickle.dump(jobs, f)
    procs = W.start("dry", tmp)
    W.finish(procs, timeout=600)
    W.assert_none_alive(procs)
    out = W.load(tmp, "dry_out.pkl")
    for name, rec in out.items():
        assert "error" not in rec, (name, rec.get("error"))
    return out


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
@pytest.mark.parametrize("kind", SMOKE_KINDS)
def test_dry_run_counts_the_smoke_configs(dry, arch, kind):
    """Each family's smoke config counted as its sharded program at B=8,
    S=64 on a 2x4 mesh (a fake group's, local shards on meta): finite,
    positive terms; the LM ops' meta route charged on local shards (the
    scans and flash, forward and, for train, backward, once a layer a
    pass, as on one device); the peak memory read from the program: the
    arguments plus the most live beside them."""
    cfg = tconfigs.get_smoke(arch)
    rec = dry[f"smoke/{arch}/{kind}"]
    rl, mem, ops = rec["roofline"], rec["memory"], rec["counts"]["kernel_ops"]
    for key in ("compute_s", "memory_s", "collective_s"):
        assert 0 < rl[key] < float("inf"), key
    assert rl["n_devices"] == 8
    assert mem["peak_live_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["peak_live_bytes"] >= mem["argument_bytes"]
    plan = [m for m, _ in cfg.layer_plan]
    n = {"flash_attention": sum(m in ("attn", "local") for m in plan),
         "rglru_scan": plan.count("rglru"), "wkv6": plan.count("rwkv")}
    if kind == "decode":
        n["flash_attention"] = 0        # decode attends in plain torch
    passes = 2 if kind == "train" else 1            # remat's recompute
    for op, layers in n.items():
        assert ops.get(op, {}).get("calls", 0) == passes * layers, op
        if kind == "train":
            bwd = "wkv6_bwd" if op == "wkv6" else op + "_bwd"
            assert ops.get(bwd, {}).get("calls", 0) == layers, bwd
    if n["wkv6"] and kind != "decode":
        # WKV6's charges per (b, t, h) of a local shard (batch over
        # "data" = 2, heads over "model" = 4): the forward's 5 (N^2 + N);
        # the backward kernel's (145 N^2 + 120 N) / 8 (``ops.py``)
        bsh, N = 8 * 64 * cfg.n_heads // 8, cfg.head_dim
        assert ops["wkv6"]["flops"] == passes * n["wkv6"] * 5 * bsh * (
            N * N + N)
        if kind == "train":
            assert ops["wkv6_bwd"]["flops"] == n["wkv6"] * bsh * (
                145 * N * N + 120 * N) / 8
    assert rec["model_flops"] > 0 and rec["n_params"] == cfg.n_params()


def test_full_width_cell_counts_equal_the_reference(dry):
    """deepseek-moe-16b train_4k on the single-pod mesh, the record the
    CLI writes (``roofline_cell``: one and two body periods counted,
    extrapolated to 27): ``n_params``, ``n_active_params`` and
    ``model_flops`` equal the reference's, and the counted FLOPs over all
    devices lie between 1 and 2 model FLOPs (remat's recompute, attention
    and the router)."""
    rec = dry["full"]
    jcfg = jconfigs.get("deepseek_moe_16b")
    n_active = jcfg.n_active_params()
    assert rec["n_params"] == jcfg.n_params()
    assert rec["n_active_params"] == n_active == 2_828_650_496
    assert rec["model_flops"] == 6.0 * n_active * 256 * 4096
    assert rec["roofline"]["extrapolated"] and rec["periods"] == 27
    total = rec["roofline"]["flops_per_device"] * rec["n_devices"]
    assert 1.0 <= total / rec["model_flops"] <= 2.0
    assert rec["n_devices"] == 256 and rec["memory"]["fits_80g"]


def _records(dry, tmp_path):
    """Port-written train_4k records of three smoke configs (named as the
    full ones), one per architecture."""
    recs = []
    for arch in RECORD_ARCHS:
        rec = dry[f"record/{arch}"]
        with open(tmp_path / f"{arch}_train_4k_single.json", "w") as f:
            json.dump(rec, f)
        recs.append(rec)
    return recs


def test_report_renders_as_the_reference(dry, tmp_path):
    """``roofline_table`` and ``pick_hillclimb`` give the reference's rows
    on the same records (the reference's fits column read from
    ``fits_16g``, set to the port's ``fits_80g``); ``load`` reads them
    back."""
    recs = _records(dry, tmp_path)
    assert [r["arch"] for r in treport.load(str(tmp_path))] == sorted(
        r["arch"] for r in recs)
    theirs = json.loads(json.dumps(recs))
    for r in theirs:
        r["memory"]["fits_16g"] = r["memory"]["fits_80g"]
    assert treport.roofline_table(recs) == jreport.roofline_table(theirs)
    assert treport.pick_hillclimb(recs) == jreport.pick_hillclimb(theirs)
    assert len(treport.dryrun_table(recs).splitlines()) == 2 + len(recs)


def test_memory_table_lists_each_read(dry, tmp_path):
    """``memory_table`` gives one row per record: its read peak in GB,
    whether it fits, how its depth was reached, where the peak falls and
    the largest buffer live there."""
    recs = _records(dry, tmp_path)
    rows = treport.memory_table(recs).splitlines()
    assert len(rows) == 2 + len(recs)
    for r, row in zip(recs, rows[2:]):
        m = r["memory"]
        cells = [c.strip() for c in row.strip("|").split("|")]
        assert cells[:3] == [r["arch"], r["shape"], r["mesh"]]
        assert cells[3] == f"{m['peak_live_bytes'] / 1e9:.3f}"
        assert cells[4] == ("yes" if m["fits_80g"] else "NO")
        assert cells[6].startswith(m["peak_at"]["phase"])
        assert cells[7].startswith(f"{m['largest'][0]['bytes'] / 1e9:.3f} GB")


def test_jobs_from_port_records_and_schedules(dry, tmp_path):
    """The port's ``job_from_roofline`` on a record the port wrote gives
    the reference's stages, except ``hbm``, rescaled by 16 GiB /
    ``HBM_PER_DEVICE``; ``schedule_cluster`` of both packages on the same
    stage dicts makes the same decisions (``repr``)."""
    _records(dry, tmp_path)
    scale = 16 * 2**30 / troof.HBM_PER_DEVICE
    tjobs, jjobs = [], []
    for i, arch in enumerate(("deepseek_moe_16b", "gemma2_2b", "rwkv6_7b",
                              "deepseek_moe_16b", "gemma2_2b")):
        kw = dict(steps=50 + 20 * (i % 4), group=i % 2)
        t = tcluster.job_from_roofline(f"j{i}", arch, str(tmp_path), **kw)
        j = jcluster.job_from_roofline(f"j{i}", arch, str(tmp_path), **kw)
        assert len(t.stages) == len(j.stages) == 4
        for ts, js in zip(t.stages, j.stages):
            assert {k: v for k, v in ts.items() if k != "hbm"} == {
                k: v for k, v in js.items() if k != "hbm"}
            if ts["name"] in ("train", "eval"):
                assert ts["hbm"] == pytest.approx(js["hbm"] * scale,
                                                  rel=1e-12)
                assert ts["hbm"] < js["hbm"] < 0.9 * 0.7
            else:
                assert ts["hbm"] == js["hbm"]
        tjobs.append(t)
        jjobs.append(jcluster.TPUJob(t.name, t.arch, t.stages, t.group))
    tres = tcluster.schedule_cluster(tjobs, n_slices=8, seed=1, device="cpu")
    jres = jcluster.schedule_cluster(jjobs, n_slices=8, seed=1)
    assert sorted((x.job_id, repr(x.jct)) for x in tres.jobs) == sorted(
        (x.job_id, repr(x.jct)) for x in jres.jobs)
    assert repr(tres.makespan) == repr(jres.makespan)


def test_no_tpu_constant_in_the_port():
    """No TPU v5e number (197 TFLOP/s, 819 GB/s, 50 GB/s, 16 GiB of HBM)
    stands in ``src/repro_torch/``."""
    import re
    bad = re.compile(r"(?<![\d.])(197e12|819e9|50e9|16 \* 2\*\*30|"
                     r"16 \* 1024\*\*3)(?![\d])")
    hits = []
    for base, _dirs, files in os.walk(os.path.join(SRC, "repro_torch")):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(base, name)
                for i, line in enumerate(open(path), 1):
                    if bad.search(line):
                        hits.append(f"{path}:{i}: {line.strip()}")
    assert not hits
    assert troof.HBM_PER_DEVICE > 80e9


def test_dry_run_cli_writes_a_record(tmp_path):
    """``python -m repro_torch.launch.dryrun --list`` lists the reference's
    cells, and ``main`` writes one cell's record where ``--out`` says."""
    code = ("import sys; from repro_torch.launch import dryrun; "
            "dryrun.main(sys.argv[1:])")
    out = _run(code, "--list")
    assert out.split("\n")[:-1] == [f"{a} {s}" for a, s in jconfigs.cells()]
    out = _run(code, "--arch", "gemma2_2b", "--shape", "decode_32k",
               "--out", tmp_path)
    assert "1/1 cells counted" in out
    with open(tmp_path / "gemma2_2b_decode_32k_single.json") as f:
        rec = json.load(f)
    assert rec["n_devices"] == math.prod(production_shape()[0]) == 256
    assert rec["kind"] == "decode" and rec["roofline"]["model_flops"] > 0
    assert {"count_s", "aten_ops", "collectives"} <= set(rec)
