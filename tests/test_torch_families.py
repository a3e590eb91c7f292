"""The port's other eight model families against the JAX reference, on the
CPU: gemma2, phi4-mini, granite, codeqwen (qkv biases), deepseek-moe and
mixtral (the token-dropping MoE), qwen2-vl (M-RoPE with prepended
patches) and musicgen (codebooks, sinusoidal positions, the plain MLP).

Each family's ``smoke()`` runs in float32 with the reference's weights
carried across by ``params_from_jax``; the leaves the reference
initializes to constants (qkv and MLP biases, norm weights) are drawn
from a numpy seed first, so that they count.  On CPU tensors the port
runs the plain PyTorch versions of its kernels.

  * configs field for field, ``layer_plan``, ``groups``, ``n_body``,
    ``SHAPES`` and ``cells()``; ``init_params`` shapes against the
    reference's tree;
  * ``forward``, ``prefill`` (its logits and decode state) and
    ``decode_step`` within 1e-4 of ``repro.models.model``;
  * twins of ``tests/test_models.py``: prefill + decode == forward, the
    mixtral ring cache (here step for step against the reference), MoE
    capacity dropping (here against the reference's ``moe_forward`` at
    capacity factor 0.5, and the kept pairs against the rule itself) and
    granite's vocab padding;
  * ``greedy_generate`` and ``Batcher.serve`` tokens identical to the
    reference's for gemma2, deepseek-moe and musicgen;
  * ``examples/torch_serve_lm.py`` at its defaults on the CPU.

Every reference output is computed once per module (module-scoped
fixtures) and the torch side runs on one thread: the file takes about a
minute alone.
"""

import dataclasses
import functools
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import model as JM
from repro.serve import engine as JE
from repro_torch import configs as tconfigs
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serve import engine as TE

ARCHS = ["gemma2_2b", "phi4_mini_3_8b", "granite3_8b", "codeqwen15_7b",
         "deepseek_moe_16b", "mixtral_8x7b", "qwen2_vl_7b", "musicgen_large"]
#: prompt length of the forward / prefill / decode comparison: above the
#: smoke configs' windows (16), so the local layers mask
B, S = 2, 20
TOL = dict(rtol=0, atol=1e-4)
#: leaves the reference initializes to constants
_CONST_LEAVES = ("bq", "bk", "bv", "b1", "b2", "ln1", "ln2", "pln1", "pln2",
                 "final_ln")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _perturb(tree, rng):
    """The reference's f32 tree as numpy, its constant leaves drawn anew."""
    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        arr = np.asarray(node)
        if key in _CONST_LEAVES:
            arr = arr + 0.1 * rng.standard_normal(arr.shape).astype(arr.dtype)
        return arr
    return walk(tree)


def _inputs(cfg, B, S, seed):
    """numpy tokens (B, S) or codes (B, S, K), and patches when the model
    takes them."""
    rng = np.random.default_rng(seed)
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks > 1 else (B, S)
    toks = rng.integers(0, cfg.vocab, shape).astype(np.int32)
    patches = (rng.standard_normal((B, cfg.vlm_patches, cfg.d_model))
               .astype(np.float32) if cfg.vlm_patches else None)
    return toks, patches


def _batches(toks, patches):
    j, t = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(
        toks).long()}
    if patches is not None:
        j["patches"], t["patches"] = jnp.asarray(patches), torch.from_numpy(
            patches)
    return j, t


class _Model:
    """One family's smoke model on both sides; the reference's passes are
    computed on first use."""

    def __init__(self, arch):
        self.jcfg, self.tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
        tree = jax.tree.map(np.asarray, JM.init_params(
            self.jcfg, jax.random.PRNGKey(1), dtype=jnp.float32))
        tree = _perturb(tree, np.random.default_rng(11))
        self.jparams = jax.tree.map(jnp.asarray, tree)
        self.tparams = TM.params_from_jax(self.tcfg, tree, device="cpu")

    @functools.cached_property
    def passes(self):
        """The reference's forward(S), prefill(S-1) and its decode state,
        and decode_step at S-1 from the padded prefill state."""
        toks, patches = _inputs(self.tcfg, B, S, 5)
        full, _ = _batches(toks, patches)
        head, _ = _batches(toks[:, :S - 1], patches)
        fwd = JM.forward(self.jparams, self.jcfg, full)
        lj, sj = JM.prefill(self.jparams, self.jcfg, head)
        P = self.jcfg.vlm_patches
        sj_pad = JE.pad_prefill_state(self.jcfg, sj, P + S)
        pos = np.full((B,), P + S - 1, np.int32)
        dj, _ = JM.decode_step(self.jparams, self.jcfg, sj_pad,
                               jnp.asarray(toks[:, S - 1:S]), jnp.asarray(pos))
        return dict(toks=toks, patches=patches, forward=_f32(fwd),
                    prefill=_f32(lj), state=jax.tree.map(np.asarray, sj),
                    decode=_f32(dj), pos=pos)


@pytest.fixture(scope="module")
def models():
    """arch -> its `_Model`, built once per module."""
    cache: dict = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _Model(arch)
        return cache[arch]
    return get


# ----------------------------------------------------------------------
# configs and parameters
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    for make in ("get", "get_smoke"):
        mine = getattr(tconfigs, make)(arch)
        ref = getattr(jconfigs, make)(arch)
        for f in dataclasses.fields(mine):
            theirs = getattr(ref, f.name)
            if f.name == "moe" and theirs is not None:
                theirs = dataclasses.asdict(theirs)
                assert dataclasses.asdict(mine.moe) == theirs
                continue
            assert getattr(mine, f.name) == theirs, f.name
        assert mine.layer_plan == ref.layer_plan
        assert mine.groups == ref.groups and mine.n_body == ref.n_body
        assert mine.vocab_padded == ref.vocab_padded
        for mixer in set(mine.block_pattern) & {"attn", "local"}:
            ma, ra = mine.attn_cfg(mixer), ref.attn_cfg(mixer)
            for f in dataclasses.fields(ma):
                assert getattr(ma, f.name) == getattr(ra, f.name), f.name
            # the port always scales by 1/sqrt(hd): no config sets another
            assert ra.query_scale is None


def test_arch_ids_shapes_and_cells_match_reference():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.SHAPES == jconfigs.SHAPES
    assert tconfigs.cells() == jconfigs.cells()
    for arch in tconfigs.ARCH_IDS:
        assert tconfigs.get(arch).name == jconfigs.get(arch).name
        assert tconfigs.get_smoke(arch.replace("_", "-")).name \
            == jconfigs.get_smoke(arch).name
    with pytest.raises(KeyError):
        tconfigs.get("no_such_model")


def _shapes(node, out, path=""):
    if isinstance(node, dict):
        for k, v in node.items():
            _shapes(v, out, f"{path}/{k}")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            _shapes(v, out, f"{path}/{i}")
    else:
        out[path] = (tuple(node.shape), node.dtype)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_reference_shapes(models, arch):
    m = models(arch)
    mine = TM.init_params(m.tcfg, torch.Generator().manual_seed(0),
                          device="cpu", dtype=torch.float32)
    assert _shapes(mine, {}) == _shapes(m.tparams, {})
    assert len(mine["layers"]) == m.tcfg.n_layers
    assert abs(float(mine["embed"].std()) - 0.02) < 3e-3


# ----------------------------------------------------------------------
# forward / prefill / decode against the reference
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_reference(models, arch):
    m = models(arch)
    r = m.passes
    toks, patches = r["toks"], r["patches"]
    _, full = _batches(toks, patches)
    _, head = _batches(toks[:, :S - 1], patches)
    np.testing.assert_allclose(TM.forward(m.tparams, m.tcfg, full).numpy(),
                               r["forward"], **TOL)
    lt, st = TM.prefill(m.tparams, m.tcfg, head)
    np.testing.assert_allclose(lt.numpy(), r["prefill"], **TOL)
    carried = TM.state_from_jax(m.tcfg, r["state"], device="cpu")
    assert len(st["layers"]) == len(carried["layers"]) == m.tcfg.n_layers
    for mine, theirs in zip(st["layers"], carried["layers"]):
        assert mine.keys() == theirs.keys()
        for key in mine:
            for name in mine[key]:
                np.testing.assert_allclose(mine[key][name].numpy(),
                                           theirs[key][name].numpy(), **TOL)
    P = m.tcfg.vlm_patches
    st = TE.pad_prefill_state(m.tcfg, st, P + S)
    dt, _ = TM.decode_step(m.tparams, m.tcfg, st,
                           torch.from_numpy(toks[:, S - 1:S]).long(),
                           torch.from_numpy(r["pos"]).long())
    np.testing.assert_allclose(dt.numpy(), r["decode"], **TOL)
    lt_last, _ = TM.prefill(m.tparams, m.tcfg, head, last_only=True)
    np.testing.assert_allclose(lt_last.numpy(), lt[:, -1:].numpy(), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "qwen2_vl_7b"])
def test_decode_matches_forward(models, arch):
    """prefill(S-1) + decode_step(S-1) == forward(S)[-1], the twin of the
    reference's test (which skips the vision model: its decode rotates at
    the cache slot P + j where its prefill put text token j at j)."""
    m = models(arch)
    toks, _ = _inputs(m.tcfg, B, 12, 2)
    tt = torch.from_numpy(toks).long()
    full = TM.forward(m.tparams, m.tcfg, {"tokens": tt})
    _, state = TM.prefill(m.tparams, m.tcfg, {"tokens": tt[:, :11]})
    state = TE.pad_prefill_state(m.tcfg, state, 12)
    dl, _ = TM.decode_step(m.tparams, m.tcfg, state, tt[:, 11:12],
                           torch.full((B,), 11, dtype=torch.long))
    np.testing.assert_allclose(dl[:, 0].numpy(), full[:, -1].numpy(), **TOL)


def test_decode_ring_buffer_local_attention(models):
    """mixtral's sliding-window ring cache: decoding past the window stays
    finite and equals the reference step for step (logits within 1e-4,
    the same greedy tokens)."""
    m = models("mixtral_8x7b")
    cfg = m.tcfg
    sj = JM.init_decode_state(m.jcfg, 1, S_max=cfg.window, dtype=jnp.float32)
    st = TM.init_decode_state(cfg, 1, cfg.window, dtype=torch.float32,
                              device="cpu")
    assert st["layers"][0]["kv"]["k"].shape[1] == cfg.window
    step = jax.jit(lambda s, t, p: JM.decode_step(m.jparams, m.jcfg, s, t, p))
    tok = np.zeros((1, 1), np.int32)
    for i in range(cfg.window + 4):                # wrap the ring
        lj, sj = step(sj, jnp.asarray(tok), jnp.full((1,), i, jnp.int32))
        lt, st = TM.decode_step(m.tparams, cfg, st,
                                torch.from_numpy(tok).long(),
                                torch.full((1,), i, dtype=torch.long))
        assert bool(torch.isfinite(lt).all())
        np.testing.assert_allclose(lt.numpy(), _f32(lj), **TOL)
        tok = np.asarray(jnp.argmax(lj[:, -1:], -1)).astype(np.int32)
        assert int(lt[0, -1].argmax()) == int(tok[0, 0])


@pytest.mark.parametrize("window", [None, 4, 8])
def test_attn_decode_write_at_and_past_the_cache_end(window):
    """Rows at, inside and past the end of an 8-slot cache: a plain cache
    (no window, or a window shorter than it) drops the write past its end
    as the reference's scatter does; a ring (window 8) takes the slot mod
    8.  Output and cache equal the reference's."""
    rng = np.random.default_rng(11)
    d, H, KV, hd, Sc = 16, 4, 2, 8, 8
    cfgs = [mod.AttnConfig(d_model=d, n_heads=H, n_kv_heads=KV, head_dim=hd,
                           window=window) for mod in (JL, TL)]
    p = {name: rng.standard_normal(shape).astype(np.float32) * 0.3
         for name, shape in (("wq", (d, H, hd)), ("wk", (d, KV, hd)),
                             ("wv", (d, KV, hd)), ("wo", (H, hd, d)))}
    x = rng.standard_normal((3, 1, d)).astype(np.float32)
    cache = {n: rng.standard_normal((3, Sc, KV, hd)).astype(np.float32)
             for n in ("k", "v")}
    pos = np.array([Sc - 1, Sc, Sc + 3])
    oj, cj = JL.attn_decode({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), cfgs[0],
                            {k: jnp.asarray(v) for k, v in cache.items()},
                            jnp.asarray(pos, jnp.int32))
    ot, ct = TL.attn_decode({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), cfgs[1],
                            {k: torch.from_numpy(v.copy())
                             for k, v in cache.items()},
                            torch.from_numpy(pos))
    np.testing.assert_allclose(ot.numpy(), _f32(oj), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(ct[n].numpy(), _f32(cj[n]), **TOL)
    # the ring overwrote slots 0 and 3 of rows 1 and 2; a plain cache kept
    # both rows as they stood
    kept = ct["k"][1:].numpy() == cache["k"][1:]
    assert kept.all() == (window != Sc)


# ----------------------------------------------------------------------
# MoE
# ----------------------------------------------------------------------

def _kept_by_rule(idx, C, E):
    """(T, K) expert choices -> (T, K) kept: each expert keeps its first C
    (token, choice) pairs in token order (a token never picks an expert
    twice)."""
    seen = np.zeros(E, np.int64)
    keep = np.zeros(idx.shape, bool)
    for t in range(idx.shape[0]):
        for k in range(idx.shape[1]):
            e = idx[t, k]
            keep[t, k] = seen[e] < C
            seen[e] += 1
    return keep


@pytest.mark.parametrize("mode,n_shared", [("softmax_topk", 0),
                                           ("topk_softmax", 0),
                                           ("softmax_topk", 1)])
def test_moe_capacity_drops_tokens(mode, n_shared):
    """Capacity factor 0.5 drops (token, choice) pairs: the port's output
    equals the reference's moe_forward, its kept pairs are the rule's, a
    token with every pair dropped gets only the shared experts, and 8.0
    (nothing dropped) differs, as the reference's own test asserts."""
    d, E, K, f = 32, 4, 2, 64
    tight = JL.MoEConfig(n_experts=E, top_k=K, d_expert=f, n_shared=n_shared,
                         capacity_factor=0.5, router_mode=mode)
    loose = dataclasses.replace(tight, capacity_factor=8.0)
    p = jax.tree.map(np.asarray, JL.moe_init(jax.random.PRNGKey(0), d, tight,
                                             dtype=jnp.float32))
    x = np.random.default_rng(3).standard_normal((2, 16, d)).astype(np.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
    xt = torch.from_numpy(x)
    out = {}
    for jcfg in (tight, loose):
        tcfg = TL.MoEConfig(**dataclasses.asdict(jcfg))
        want = _f32(JL.moe_forward(jax.tree.map(jnp.asarray, p),
                                   jnp.asarray(x), jcfg))
        got = TL.moe_forward(tp, xt, tcfg)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        out[jcfg.capacity_factor] = (got.numpy(), tcfg)
    assert not np.allclose(out[0.5][0], out[8.0][0])
    tcfg = out[0.5][1]
    T = 32
    C = TL.moe_capacity(T, tcfg)
    assert C == math.ceil(T * K / E * 0.5) == 8
    w, idx = TL.moe_route(xt.reshape(1, T, d), tp["router"], tcfg)
    # the reference's routing, from its own primitives
    logits = jnp.asarray(x.reshape(T, d)) @ jnp.asarray(p["router"])
    if mode == "softmax_topk":
        _, jidx = jax.lax.top_k(jax.nn.softmax(logits, -1), K)
    else:
        _, jidx = jax.lax.top_k(logits, K)
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(jidx))
    st, sw, keep, buf_idx = TL.moe_plan(idx, w, C, E)
    assert (buf_idx[0][~keep[0]] == E * C).all()
    slots = buf_idx[0][keep[0]]
    assert len(set(slots.tolist())) == len(slots)     # one pair a slot
    kept = {(int(t), int(b) // C) for t, b in zip(st[0][keep[0]], slots)}
    rule = _kept_by_rule(idx[0].numpy(), C, E)
    assert kept == {(t, int(idx[0, t, k])) for t, k in zip(*rule.nonzero())}
    assert 0 < rule.sum() < T * K
    gone = ~rule.any(1)
    y = out[0.5][0].reshape(T, d)
    if n_shared:
        shared = TL.mlp_forward(tp["shared"], xt.reshape(T, d), "swiglu")
        np.testing.assert_allclose(y[gone], shared.numpy()[gone], rtol=0,
                                   atol=1e-6)
    else:
        assert (y[gone] == 0).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["softmax_topk", "topk_softmax"])
def test_moe_combine_is_index_add_bitwise(mode, seed):
    """``moe_combine`` adds each token's K contributions from 0 in expert
    order, in a fixed loop, and so on the CPU equals bitwise the
    ``index_add_`` of the pairs in expert order that it replaced (one
    source row at a time), forward and backward, in float32 and bfloat16,
    with pairs dropped (capacity factor 0.5) and without (8.0)."""
    rng = np.random.default_rng(seed)
    g, Tg, K, E, d = 2, 24, 3, 6, 16
    for cf, dtype in ((0.5, torch.float32), (8.0, torch.bfloat16),
                      (0.5, torch.bfloat16)):
        cfg = TL.MoEConfig(n_experts=E, top_k=K, d_expert=8,
                           capacity_factor=cf, router_mode=mode)
        C = TL.moe_capacity(Tg, cfg)
        xg = torch.from_numpy(rng.standard_normal((g, Tg, d))
                              .astype(np.float32))
        router = torch.from_numpy(rng.standard_normal((d, E))
                                  .astype(np.float32))
        w, idx = TL.moe_route(xg, router, cfg)
        st, sw, keep, buf_idx = TL.moe_plan(idx, w, C, E)
        assert bool((~keep).any()) == (cf == 0.5)
        sw = torch.where(keep, sw, torch.zeros(())).to(dtype)
        yb = torch.from_numpy(rng.standard_normal((g, E * C + 1, d))
                              .astype(np.float32)).to(dtype)
        yb[:, -1] = 0
        outs, grads = [], []
        for combine in ("fixed", "index_add"):
            y = yb.clone().requires_grad_()
            if combine == "fixed":
                out = TL.moe_combine(y, st, sw, buf_idx, Tg, K)
            else:
                rows = torch.arange(g)[:, None]
                contrib = y[rows, buf_idx] * sw[..., None]
                out = torch.zeros((g * Tg, d), dtype=torch.float32)
                out = out.index_add(0, (st + rows * Tg).reshape(-1),
                                    contrib.reshape(-1, d).float())
                out = out.reshape(g, Tg, d)
            out.backward(torch.from_numpy(
                np.random.default_rng(seed + 10).standard_normal(
                    out.shape).astype(np.float32)))
            outs.append(out.detach())
            grads.append(y.grad)
        assert torch.equal(outs[0], outs[1])
        assert torch.equal(grads[0], grads[1])


def test_vocab_padding_masked(models):
    """granite with vocab 250: the padded slots' logits are below -1e8."""
    cfg = tconfigs.get_smoke("granite3_8b")
    assert cfg.vocab_padded == cfg.vocab  # 256 already aligned
    cfg2 = dataclasses.replace(cfg, vocab=250)
    params = TM.init_params(cfg2, torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.float32)
    toks, _ = _inputs(cfg2, 2, 16, 0)
    logits = TM.forward(params, cfg2, {"tokens": torch.from_numpy(toks).long()})
    assert logits.shape == (2, 16, 256)
    assert (logits[..., 250:] < -1e8).all()
    assert (logits[..., :250] > -1e8).all()


# ----------------------------------------------------------------------
# serving: tokens identical to the reference's
# ----------------------------------------------------------------------

SERVED = ["gemma2_2b", "deepseek_moe_16b", "musicgen_large"]


@pytest.mark.parametrize("arch", SERVED)
def test_greedy_generate_tokens_identical(models, arch):
    m = models(arch)
    prompt, _ = _inputs(m.tcfg, 2, 20, 6)
    want = np.asarray(JE.greedy_generate(m.jparams, m.jcfg,
                                         jnp.asarray(prompt), 6))
    got = TE.greedy_generate(m.tparams, m.tcfg, torch.from_numpy(prompt), 6,
                             device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", SERVED)
def test_batcher_tokens_identical(models, arch):
    """3 requests over 2 slots (slot reuse), max_seq 16: gemma2's local
    caches are rings the 12-token prompt wraps; deepseek's decode batch of
    2 rows gets ceil(2 K / E * cf) expert slots; musicgen feeds each prompt
    token to all 4 codebooks, as the reference does."""
    m = models(arch)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, m.tcfg.vocab, n).astype(np.int32)
               for n in (9, 5, 12)]
    want = JE.Batcher(m.jparams, m.jcfg,
                      JE.ServeConfig(batch=2, max_seq=16)).serve(prompts, 6)
    got = TE.Batcher(m.tparams, m.tcfg, TE.ServeConfig(batch=2, max_seq=16),
                     device="cpu").serve(prompts, 6)
    assert len(got) == len(prompts)
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape
        np.testing.assert_array_equal(g, np.asarray(w))


def test_vision_model_generate_needs_patches_as_the_reference_does(models):
    """The reference's greedy_generate cannot serve qwen2-vl (its prefill
    reads patches it is not given); the port raises the same way."""
    m = models("qwen2_vl_7b")
    prompt, _ = _inputs(m.tcfg, 1, 6, 1)
    with pytest.raises(KeyError, match="patches"):
        JE.greedy_generate(m.jparams, m.jcfg, jnp.asarray(prompt), 2)
    with pytest.raises(KeyError, match="patches"):
        TE.greedy_generate(m.tparams, m.tcfg, torch.from_numpy(prompt), 2,
                           device="cpu")


def test_serve_lm_example_runs_on_the_cpu(capsys):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "examples"))
    try:
        import torch_serve_lm
    finally:
        sys.path.pop(0)
    results = torch_serve_lm.main(["--device", "cpu"])
    assert len(results) == 8 and all(r is not None and len(r) == 12
                                     for r in results)
    out = capsys.readouterr().out
    assert "served 8/8 requests, 96 tokens" in out
