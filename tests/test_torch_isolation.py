"""The port stands alone and never runs on the CPU unasked.

  * No module under ``src/repro_torch/``, not ``chip_smoke.py``, no
    script under ``scripts/`` and no ``examples/torch_*.py`` (they run on
    the card's machine, which has no JAX) imports jax or anything of the
    reference package ``repro`` (an AST scan).
  * ``device="cuda"`` without a CUDA device raises at every entry point,
    and ``chip_smoke.py`` exits non-zero without printing a result, both
    here and from a directory that holds nothing else of the repository.
"""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PORT = os.path.join(ROOT, "src", "repro_torch")
SMOKE = os.path.join(ROOT, "chip_smoke.py")
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    out = [SMOKE]
    scripts = os.path.join(ROOT, "scripts")
    out += [os.path.join(scripts, f) for f in os.listdir(scripts)
            if f.endswith(".py")]
    examples = os.path.join(ROOT, "examples")
    twins = [os.path.join(examples, f) for f in os.listdir(examples)
             if f.startswith("torch_") and f.endswith(".py")]
    assert len(twins) >= 2, "the scan found no example twins"
    out += twins
    for base, _dirs, files in os.walk(PORT):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


#: modules of the sharding and launch layer, which the scan must reach
LAUNCH_MODULES = ("launch/mesh.py", "launch/sharding.py", "launch/roofline.py",
                  "launch/dryrun.py", "launch/report.py", "launch/cluster.py",
                  "models/sharding.py", "optim/compression.py")


def test_port_imports_neither_jax_nor_reference():
    files = _sources()
    assert len(files) > 20, "the scan found too few port modules"
    assert {os.path.join(PORT, m) for m in LAUNCH_MODULES} <= set(files)
    bad = {os.path.relpath(p, ROOT): sorted(set(_imported_roots(p))
                                            & set(FORBIDDEN))
           for p in files}
    assert not {k: v for k, v in bad.items() if v}


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='cuda' is valid here")


def test_cuda_without_a_card_raises_at_every_entry_point():
    _no_card()
    from repro_torch.core import build_schedule
    from repro_torch.launch import TPUJob, schedule_cluster
    from repro_torch.sim import ClusterSim, SimConfig, make_workload, \
        run_workload, scheme
    from repro_torch.svc import SchedulerCore, ServiceConfig, \
        run_service_workload

    dag = make_workload("tpch", 1, seed=0)[0]
    with pytest.raises(RuntimeError, match="cuda"):
        build_schedule(dag, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        run_workload([dag], "dagps", n_machines=4)
    with pytest.raises(RuntimeError, match="cuda"):
        ClusterSim(SimConfig(n_machines=4), scheme("tez")).run([(0.0, dag, 0)])
    with pytest.raises(RuntimeError, match="cuda"):
        schedule_cluster([TPUJob("j", "a", [dict(seconds=5.0)])], n_slices=4)
    # the scheduler service: its config defaults to the card too
    assert ServiceConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        run_service_workload([(0.0, dag, 0)], ServiceConfig(n_machines=4),
                             scheme("dagps"))
    with pytest.raises(RuntimeError, match="cuda"):
        SchedulerCore(ServiceConfig(n_machines=4), scheme("dagps"))
    with pytest.raises(RuntimeError, match="cuda"):
        schedule_cluster([TPUJob("j", "a", [dict(seconds=5.0)])], n_slices=4,
                         serve=True)


def test_cuda_without_a_card_raises_at_the_lm_entry_points():
    _no_card()
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.serve import Batcher, ServeConfig, greedy_generate

    cfg = configs.get_smoke("recurrentgemma_2b")
    with pytest.raises(RuntimeError, match="cuda"):
        M.init_params(cfg, torch.Generator().manual_seed(0))
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        greedy_generate(params, cfg, torch.zeros(1, 4, dtype=torch.long), 2)
    with pytest.raises(RuntimeError, match="cuda"):
        Batcher(params, cfg, ServeConfig(batch=1, max_seq=8))


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "rwkv6_7b",
                                  "deepseek_moe_16b", "musicgen_large"])
def test_cuda_without_a_card_raises_at_the_model_helpers(arch):
    """The initializers, the decode state and the reference-tree carriers
    default to the card too; so do the serving entry points of each
    family."""
    _no_card()
    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.serve import Batcher, ServeConfig, greedy_generate

    cfg = configs.get_smoke(arch)
    gen = torch.Generator().manual_seed(0)
    if arch == "rwkv6_7b":
        inits = [lambda: L.rwkv_init(gen, cfg.rwkv_cfg())]
    elif arch == "deepseek_moe_16b":
        inits = [lambda: L.moe_init(gen, cfg.d_model, cfg.moe)]
    elif arch == "musicgen_large":
        inits = [lambda: L.mlp_init(gen, cfg.d_model, cfg.d_ff, "mlp")]
    else:
        inits = [lambda: L.attn_init(gen, cfg.attn_cfg("local")),
                 lambda: L.mlp_init(gen, cfg.d_model, cfg.d_ff, "geglu"),
                 lambda: L.rglru_init(gen, cfg.rglru_cfg())]
    calls = inits + [lambda: M.init_decode_state(cfg, 1, 8),
                     lambda: M.params_from_jax(cfg, {}),
                     lambda: M.state_from_jax(cfg, {}),
                     lambda: M.init_params(cfg, gen)]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    params = M.init_params(cfg, gen, device="cpu", dtype=torch.float32)
    assert M.init_decode_state(cfg, 1, 8, device="cpu")["layers"]
    with pytest.raises(RuntimeError, match="cuda"):
        greedy_generate(params, cfg, torch.zeros(1, 4, dtype=torch.long), 2)
    with pytest.raises(RuntimeError, match="cuda"):
        Batcher(params, cfg, ServeConfig(batch=1, max_seq=8))


def test_cuda_without_a_card_raises_at_the_training_entry_points(tmp_path):
    """The training slice's entry points default to the card too:
    ``init_train_state``, ``make_batch``, the step ``make_train_step``
    returns, ``opt_state_from_jax``, ``ckpt.restore``, ``schedule_pipeline``
    and ``examples/torch_train_lm.py``; each runs with ``device="cpu"``."""
    _no_card()
    from repro_torch import configs
    from repro_torch.ckpt import restore, save
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.optim import opt_state_from_jax
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step, schedule_pipeline)

    cfg = configs.get_smoke("recurrentgemma_2b")
    tcfg = TrainConfig()
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="cuda"):
        init_train_state(cfg, tcfg, gen)
    with pytest.raises(RuntimeError, match="cuda"):
        make_batch(cfg, DataConfig(), 0, 1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        opt_state_from_jax(cfg, {"step": 0})
    with pytest.raises(RuntimeError, match="cuda"):
        schedule_pipeline(2, 2, 1.0)
    params, opt = init_train_state(cfg, tcfg, gen, dtype=torch.float32,
                                   device="cpu")
    batch = make_batch(cfg, DataConfig(), 0, 1, 8, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        make_train_step(cfg, tcfg)(params, opt, batch)
    save(str(tmp_path), 1, params)
    with pytest.raises(RuntimeError, match="cuda"):
        restore(str(tmp_path))
    assert restore(str(tmp_path), device="cpu")[0] == 1
    assert schedule_pipeline(2, 2, 1.0, device="cpu").makespan > 0
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "torch_train_lm.py"),
         "--steps", "1"], capture_output=True, text=True, timeout=120,
        env=env, cwd=str(tmp_path))
    assert proc.returncode != 0 and "cuda" in proc.stderr
    assert "step" not in proc.stdout


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_a_card(where, tmp_path):
    _no_card()
    script = SMOKE
    if where == "alone":
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(SMOKE, script)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, script], capture_output=True,
                          text=True, timeout=120, cwd=os.path.dirname(script),
                          env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
