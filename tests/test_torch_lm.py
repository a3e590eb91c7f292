"""The port's LM serving path against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both sides; on CPU
tensors the port runs the plain PyTorch versions of its kernels.

  * flash attention: the port's plain version against the reference's
    Pallas kernel (interpret mode) and ``layers.attention``; 2e-5 in f32,
    2e-2 in bf16 (the tolerances of ``tests/test_kernels.py``).
  * rg_lru: the port's plain version against the Pallas kernel (interpret
    mode) and ``layers.rglru_scan`` (an associative scan, so it rounds
    differently: 2e-5), including state chained across two halves.
  * recurrentgemma ``smoke()`` in f32 with the reference's weights carried
    across by ``params_from_jax``: forward, prefill and decode logits within
    1e-4; ``greedy_generate`` and ``Batcher.serve`` tokens identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.flash_attention import kernel as jfak
from repro.kernels.rg_lru import kernel as jrgk
from repro.models import layers as JL
from repro.models import model as JM
from repro.serve import engine as JE
from repro_torch import configs as tconfigs
from repro_torch.kernels import pin
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.kernels.flash_attention import ref as tfar
from repro_torch.kernels.rg_lru import ops as trg
from repro_torch.kernels.rg_lru import ref as trgr
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serve import engine as TE

ARCH = "recurrentgemma_2b"


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=2e-5, atol=2e-5))


def _both(arr, dtype):
    """One numpy array as a jax array and a torch tensor of ``dtype``."""
    j = jnp.asarray(arr).astype(getattr(jnp, dtype))
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(getattr(torch, dtype))
    return j, t


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ----------------------------------------------------------------------
# kernels: plain versions against the reference
# ----------------------------------------------------------------------

FLASH_CASES = [
    # (B, Sq, Sk, H, KV, hd), dtype, opts, Pallas block
    ((1, 64, 64, 4, 1, 16), "float32", dict(causal=True, window=24), 32),
    ((2, 64, 128, 4, 2, 32), "bfloat16", dict(causal=False, cap=30.0), 64),
    ((1, 32, 32, 2, 1, 256), "float32", dict(causal=True, cap=20.0), 32),
    ((1, 64, 64, 4, 4, 16), "bfloat16", dict(causal=True, window=16), 32),
]


@pytest.mark.parametrize("shape,dtype,opts,block", FLASH_CASES)
def test_flash_plain_matches_pallas_and_layers(shape, dtype, opts, block):
    B, Sq, Sk, H, KV, hd = shape
    rng = np.random.default_rng(sum(shape))
    qj, qt = _both(rng.standard_normal((B, Sq, H, hd), np.float32), dtype)
    kj, kt = _both(rng.standard_normal((B, Sk, KV, hd), np.float32), dtype)
    vj, vt = _both(rng.standard_normal((B, Sk, KV, hd), np.float32), dtype)
    got = tfar.attention(qt, kt, vt, **opts)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    pallas = jfak.flash_attention(qj, kj, vj, block_q=block, block_k=block,
                                  interpret=True, **opts)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **_tol(dtype))
    xla = JL.attention(qj, kj, vj, **opts)
    np.testing.assert_allclose(_f32(got), _f32(xla), **_tol(dtype))
    # the op and the model's attention take the plain version on the CPU
    assert torch.equal(tfa.flash_attention(qt, kt, vt, **opts), got)
    assert torch.equal(TL.attention(qt, kt, vt, **opts), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_plain_matches_pallas_and_layers(dtype):
    B, S, D = 2, 64, 128
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, D)).astype(np.float32) * 0.5
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, D)))) * 0.4
         + 0.5).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32) * 0.2
    xj, xt = _both(x, dtype)
    aj, at = _both(a, dtype)
    y, hT = trgr.rglru_scan(xt, at, torch.from_numpy(h0))
    assert y.dtype == xt.dtype and hT.dtype == torch.float32
    yp, hTp = jrgk.rglru_scan(xj, aj, jnp.asarray(h0), chunk=32,
                              d_block=128, interpret=True)
    np.testing.assert_allclose(_f32(y), _f32(yp), **_tol(dtype))
    np.testing.assert_allclose(hT.numpy(), _f32(hTp), rtol=1e-3, atol=1e-3)
    if dtype == "float32":
        # the model's associative scan: same recurrence, other rounding
        ys = JL.rglru_scan(xj, aj, jnp.asarray(h0))
        np.testing.assert_allclose(y.numpy(), _f32(ys), rtol=2e-5, atol=2e-5)
        got, _ = TL.rglru_scan(xt, at, torch.from_numpy(h0))
        assert torch.equal(got, y)


def test_rglru_state_chaining():
    """Two half-sequences with the carried state == one full run (bitwise
    for the sequential plain version), and == the reference's chain."""
    B, S, D = 1, 64, 128
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, D)).astype(np.float32) * 0.5
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, D)))) * 0.4
         + 0.5).astype(np.float32)
    xt, at = torch.from_numpy(x), torch.from_numpy(a)
    h0 = torch.zeros(B, D)
    full, hT_full = trg.rglru_scan(xt, at, h0)
    h1, hT = trg.rglru_scan(xt[:, :32], at[:, :32], h0)
    h2, hT2 = trg.rglru_scan(xt[:, 32:], at[:, 32:], hT)
    assert torch.equal(full, torch.cat([h1, h2], dim=1))
    assert torch.equal(hT_full, hT2)
    j1, jT = jrgk.rglru_scan(jnp.asarray(x[:, :32]), jnp.asarray(a[:, :32]),
                             jnp.zeros((B, D)), chunk=16, interpret=True)
    j2, _ = jrgk.rglru_scan(jnp.asarray(x[:, 32:]), jnp.asarray(a[:, 32:]),
                            jT, chunk=16, interpret=True)
    np.testing.assert_allclose(full.numpy(),
                               np.concatenate([_f32(j1), _f32(j2)], axis=1),
                               rtol=1e-5, atol=1e-5)


def test_plain_pin_parses_and_rejects(monkeypatch):
    monkeypatch.setenv(pin.PIN_ENV, "plain")
    assert pin.pinned_plain()
    for bad in ("kernel", "all=plain"):
        monkeypatch.setenv(pin.PIN_ENV, bad)
        with pytest.raises(ValueError):
            pin.pinned_plain()
    monkeypatch.delenv(pin.PIN_ENV)
    assert not pin.pinned_plain()
    assert not pin.use_kernel("flash_attention", torch.zeros(1))


def test_wkv6_route_on_cpu_is_plain_both_ways(monkeypatch):
    """On a CPU tensor WKV6's route is the plain forward and the plain
    backward, pinned or not; the pin takes no value that would split
    them."""
    from repro_torch.kernels.rwkv6 import ops as wops
    from repro_torch.kernels.rwkv6 import ref as wref
    monkeypatch.delenv(pin.PIN_ENV, raising=False)
    assert wops._impl(torch.zeros(1)) == (wref.wkv6, wref.wkv6_bwd)
    monkeypatch.setenv(pin.PIN_ENV, "plain")
    assert wops._impl(torch.zeros(1)) == (wref.wkv6, wref.wkv6_bwd)
    monkeypatch.setenv(pin.PIN_ENV, "plain_backward")
    with pytest.raises(ValueError):
        pin.pinned_plain()


# ----------------------------------------------------------------------
# configs and parameters
# ----------------------------------------------------------------------

def test_configs_match_reference():
    for make in ("get", "get_smoke"):
        mine = getattr(tconfigs, make)(ARCH)
        ref = getattr(jconfigs, make)(ARCH)
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name
        assert mine.layer_plan == ref.layer_plan
        assert mine.groups == ref.groups and mine.n_body == ref.n_body
        assert mine.vocab_padded == ref.vocab_padded
    # every reference architecture is ported (the other eight families:
    # tests/test_torch_families.py)
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.get("mixtral_8x7b").moe.router_mode == "topk_softmax"
    with pytest.raises(KeyError):
        tconfigs.get_smoke("no_such_model")


def test_other_mixers_and_ffns_raise():
    """A mixer the reference does not define raises; the MoE, the plain
    MLP and sinusoidal positions, once refused, now run (on the
    recurrentgemma smoke model, swapped in one at a time)."""
    gen = torch.Generator().manual_seed(0)
    cfg = dataclasses.replace(tconfigs.get_smoke(ARCH),
                              block_pattern=("mamba",))
    with pytest.raises(NotImplementedError, match="no planned slice"):
        TM.init_params(cfg, gen, device="cpu")
    toks = {"tokens": torch.zeros(1, 4, dtype=torch.long)}
    base = tconfigs.get_smoke(ARCH)
    for cfg in (dataclasses.replace(base, moe=TL.MoEConfig(
                    n_experts=4, top_k=2, d_expert=32), first_k_dense=1),
                dataclasses.replace(base, mlp_kind="mlp"),
                dataclasses.replace(base, pos_embedding="sinusoidal")):
        params = TM.init_params(cfg, gen, device="cpu", dtype=torch.float32)
        logits = TM.forward(params, cfg, toks)
        assert logits.shape == (1, 4, cfg.vocab_padded)
        assert bool(torch.isfinite(logits).all())
    assert [f for _, f in cfg.layer_plan] == ["geglu"] * cfg.n_layers
    moe = dataclasses.replace(base, moe=TL.MoEConfig(4, 2, 32),
                              first_k_dense=1)
    assert [f for _, f in moe.layer_plan] == ["geglu"] + ["moe"] * 4
    assert "moe" in TM.init_params(moe, gen, device="cpu")["layers"][1]


@pytest.fixture(scope="module")
def smoke():
    """recurrentgemma smoke(): the reference's f32 weights, both ways."""
    jcfg = jconfigs.get_smoke(ARCH)
    tcfg = tconfigs.get_smoke(ARCH)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, TM.params_from_jax(tcfg, tree, device="cpu")


def test_init_params_has_reference_shapes(smoke):
    jcfg, tcfg, _, carried = smoke
    gen = torch.Generator().manual_seed(0)
    mine = TM.init_params(tcfg, gen, device="cpu", dtype=torch.float32)

    def shapes(node, out, path=""):
        if isinstance(node, dict):
            for k, v in node.items():
                shapes(v, out, f"{path}/{k}")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                shapes(v, out, f"{path}/{i}")
        else:
            out[path] = (tuple(node.shape), node.dtype)
        return out

    assert shapes(mine, {}) == shapes(carried, {})
    assert len(mine["layers"]) == tcfg.n_layers
    # scales: the embedding is N(0, 0.02), wq N(0, 1/sqrt(d))
    assert abs(float(mine["embed"].std()) - 0.02) < 2e-3
    wq = mine["layers"][2]["attn"]["wq"]
    assert abs(float(wq.std()) * np.sqrt(tcfg.d_model) - 1.0) < 0.1


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)


def test_smoke_forward_prefill_decode_match_reference(smoke):
    jcfg, tcfg, jparams, tparams = smoke
    B, S = 2, 20                       # S > window: the local layers mask
    toks = _tokens(tcfg, B, S, 5)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks).long()
    full_j = JM.forward(jparams, jcfg, {"tokens": jt})
    full_t = TM.forward(tparams, tcfg, {"tokens": tt})
    np.testing.assert_allclose(full_t.numpy(), _f32(full_j), rtol=0,
                               atol=1e-4)
    lj, sj = JM.prefill(jparams, jcfg, {"tokens": jt[:, :S - 1]})
    lt, st = TM.prefill(tparams, tcfg, {"tokens": tt[:, :S - 1]})
    np.testing.assert_allclose(lt.numpy(), _f32(lj), rtol=0, atol=1e-4)
    carried = TM.state_from_jax(tcfg, jax.tree.map(np.asarray, sj),
                                device="cpu")
    for mine, theirs in zip(st["layers"], carried["layers"]):
        for key in mine:
            for name in mine[key]:
                np.testing.assert_allclose(mine[key][name].numpy(),
                                           theirs[key][name].numpy(),
                                           rtol=0, atol=1e-4)
    sj = JE.pad_prefill_state(jcfg, sj, S)
    st = TE.pad_prefill_state(tcfg, st, S)
    pos = np.full((B,), S - 1, np.int32)
    dj, _ = JM.decode_step(jparams, jcfg, sj, jt[:, S - 1:], jnp.asarray(pos))
    dt, _ = TM.decode_step(tparams, tcfg, st, tt[:, S - 1:],
                           torch.from_numpy(pos).long())
    np.testing.assert_allclose(dt.numpy(), _f32(dj), rtol=0, atol=1e-4)
    # prefill(S-1) + decode == forward(S), as the reference's own test
    np.testing.assert_allclose(dt[:, 0].numpy(), full_t[:, -1].numpy(),
                               rtol=0, atol=1e-4)
    lt_last, _ = TM.prefill(tparams, tcfg, {"tokens": tt[:, :S - 1]},
                            last_only=True)
    np.testing.assert_allclose(lt_last.numpy(), lt[:, -1:].numpy(), rtol=0,
                               atol=1e-6)


def test_smoke_greedy_generate_tokens_identical(smoke):
    jcfg, tcfg, jparams, tparams = smoke
    prompt = _tokens(tcfg, 2, 20, 6)   # padded local cache: not a ring
    want = np.asarray(JE.greedy_generate(jparams, jcfg, jnp.asarray(prompt), 6))
    got = TE.greedy_generate(tparams, tcfg, torch.from_numpy(prompt), 6,
                             device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_smoke_batcher_tokens_identical(smoke):
    jcfg, tcfg, jparams, tparams = smoke
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, tcfg.vocab, n).astype(np.int32)
               for n in (9, 5, 12)]
    # 3 requests over 2 slots (slot reuse); max_seq 16 <= window: rings,
    # and the 12-token prompt plus its answer wraps its ring
    want = JE.Batcher(jparams, jcfg, JE.ServeConfig(batch=2, max_seq=16)) \
        .serve(prompts, 6)
    got = TE.Batcher(tparams, tcfg, TE.ServeConfig(batch=2, max_seq=16),
                     device="cpu").serve(prompts, 6)
    assert len(got) == len(prompts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
