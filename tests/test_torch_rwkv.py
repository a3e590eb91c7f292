"""The port's rwkv6 serving path against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both sides; on CPU
tensors the port runs the plain PyTorch version of its wkv6 kernel.

  * wkv6: the port's plain version against the reference's Pallas kernel
    (interpret mode) and ``kernels/rwkv6/ref.wkv6``, with the tolerances of
    ``tests/test_kernels.py`` (y 2e-5 in f32, 2e-2 in bf16; final state
    1e-3); a ragged S, the S=1 step against ``ref.wkv6_step``, and state
    chained across two halves.  At the model's scale (unit r, k, v, whose
    y reaches 100 and more) float32 is held to ``ref.f32_error_bound``
    instead: the plain version against a float64 loop, and against the
    Pallas kernel.
  * ``rwkv_time_mix`` and ``rwkv_channel_mix`` with and without carries,
    on the reference's f32 weights.
  * rwkv6 ``smoke()`` in f32 with the reference's weights carried across by
    ``params_from_jax``: forward, prefill and decode logits within 1e-4;
    ``greedy_generate`` and ``Batcher.serve`` tokens identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.rwkv6 import kernel as jwk
from repro.kernels.rwkv6 import ref as jwr
from repro.models import layers as JL
from repro.models import model as JM
from repro.serve import engine as JE
from repro_torch import configs as tconfigs
from repro_torch.kernels.rwkv6 import ops as twk
from repro_torch.kernels.rwkv6 import ref as twr
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serve import engine as TE

ARCH = "rwkv6_7b"


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=2e-5, atol=2e-5))


STATE_TOL = dict(rtol=1e-3, atol=1e-3)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _wkv_inputs(B, S, H, N, seed):
    """r, k, v, w (B, S, H, N), u (H, N), s0 (B, H, N, N) as numpy f32, w
    a decay in (0, 1) as the model draws it."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, N)).astype(np.float32) * 0.5
               for _ in range(3))
    w0 = rng.uniform(-6.0, -5.0, (H, N))
    w = np.exp(-np.exp(w0 + rng.uniform(-0.5, 0.5, (B, S, H, N)))).astype(
        np.float32)
    u = rng.uniform(0.0, 0.5, (H, N)).astype(np.float32)
    s0 = (rng.standard_normal((B, H, N, N)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


def _to(arrs, dtype):
    """(jax, torch) pairs; r, k, v take ``dtype``, the rest stay f32."""
    out = []
    for i, a in enumerate(arrs):
        dt = dtype if i < 3 else "float32"
        out.append((jnp.asarray(a).astype(getattr(jnp, dt)),
                    torch.from_numpy(np.ascontiguousarray(a)).to(
                        getattr(torch, dt))))
    return [p[0] for p in out], [p[1] for p in out]


# ----------------------------------------------------------------------
# the wkv6 op's plain version against the reference
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 32, 2, 16), (2, 64, 3, 32)])
def test_wkv6_plain_matches_pallas_and_ref(shape, dtype):
    js, ts = _to(_wkv_inputs(*shape, seed=sum(shape)), dtype)
    y, sT = twr.wkv6(*ts)
    assert y.dtype == ts[0].dtype and sT.dtype == torch.float32
    yp, sTp = jwk.wkv6(*js, chunk=16, interpret=True)
    np.testing.assert_allclose(_f32(y), _f32(yp), **_tol(dtype))
    np.testing.assert_allclose(sT.numpy(), _f32(sTp), **STATE_TOL)
    yr, sTr = jwr.wkv6(*js)
    np.testing.assert_allclose(_f32(y), _f32(yr), **_tol(dtype))
    np.testing.assert_allclose(sT.numpy(), _f32(sTr), **STATE_TOL)
    # the op takes the plain version on the CPU
    y2, sT2 = twk.wkv6(*ts)
    assert torch.equal(y2, y) and torch.equal(sT2, sT)


def test_wkv6_ragged_and_single_step_match_ref():
    js, ts = _to(_wkv_inputs(2, 37, 3, 16, seed=9), "float32")
    y, sT = twk.wkv6(*ts)
    yr, sTr = jwr.wkv6(*js)
    np.testing.assert_allclose(y.numpy(), _f32(yr), **_tol("float32"))
    np.testing.assert_allclose(sT.numpy(), _f32(sTr), **STATE_TOL)
    # S = 1: the decode step, against the reference's wkv6_step
    step = [a[:, 0] if i < 4 else a for i, a in enumerate(js)]
    ys, ss = jwr.wkv6_step(*step)
    y1, s1 = twk.wkv6(*[t[:, :1] if i < 4 else t for i, t in enumerate(ts)])
    np.testing.assert_allclose(y1[:, 0].numpy(), _f32(ys), **_tol("float32"))
    np.testing.assert_allclose(s1.numpy(), _f32(ss), **STATE_TOL)
    y2, s2 = twr.wkv6_step(*[t[:, 0] if i < 4 else t
                             for i, t in enumerate(ts)])
    np.testing.assert_allclose(y2.numpy(), y1[:, 0].numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(s2.numpy(), s1.numpy(), rtol=0, atol=1e-6)


def test_wkv6_state_chaining():
    """Two halves with the carried state == one full run (bitwise for the
    sequential plain version) and == the reference's chain."""
    js, ts = _to(_wkv_inputs(1, 64, 2, 16, seed=11), "float32")
    r, k, v, w, u, s0 = ts
    y, sT = twk.wkv6(r, k, v, w, u, s0)
    halves = [[t[:, sl] for t in (r, k, v, w)] for sl in
              (slice(0, 32), slice(32, 64))]
    ya, sA = twk.wkv6(*halves[0], u, s0)
    yb, sB = twk.wkv6(*halves[1], u, sA)
    assert torch.equal(torch.cat([ya, yb], 1), y) and torch.equal(sB, sT)
    jr, jk, jv, jw, ju, js0 = js
    ja, jA = jwk.wkv6(jr[:, :32], jk[:, :32], jv[:, :32], jw[:, :32], ju,
                      js0, chunk=16, interpret=True)
    jb, jB = jwk.wkv6(jr[:, 32:], jk[:, 32:], jv[:, 32:], jw[:, 32:], ju,
                      jA, chunk=16, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.concatenate(
        [_f32(ja), _f32(jb)], axis=1), **_tol("float32"))
    np.testing.assert_allclose(sT.numpy(), _f32(jB), **STATE_TOL)


def _wkv6_f64(r, k, v, w, u, s0):
    """The recurrence in float64 with numpy: the exact result to float32's
    eye."""
    r, k, v, w, u, s = (np.asarray(a, np.float64) for a in (r, k, v, w, u,
                                                           s0))
    y = np.empty_like(r)
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        y[:, t] = np.einsum("bhn,bhnm->bhm", r[:, t], s + u[None, :, :, None]
                            * kv)
        s = w[:, t, :, :, None] * s + kv
    return y, s


@pytest.mark.parametrize("shape", [(1, 256, 2, 16), (1, 128, 2, 32)])
def test_wkv6_f32_within_error_bound_at_model_scale(shape):
    """Unit-scale r, k, v and the model's decays: the state sums hundreds of
    steps, y reaches 100 and more, and float32 rounding exceeds the fixed
    2e-5 limit near y = 0.  Each float32 evaluation stays within
    `ref.f32_error_bound` of the float64 result, two of them within twice
    it, and the bound is a real limit (under 1e-3 of max |y|)."""
    a = _wkv_inputs(*shape, seed=sum(shape))
    a = [x * 2 if i < 3 else x for i, x in enumerate(a)]
    js, ts = _to(a, "float32")
    y, sT = twr.wkv6(*ts)
    yb, sb = (x.numpy() for x in twr.f32_error_bound(*ts))
    y64, s64 = _wkv6_f64(*a)
    assert float(np.abs(y64).max()) > 50.0
    assert yb.max() < 1e-3 * np.abs(y64).max()
    assert (np.abs(y.numpy() - y64) <= yb).all()
    assert (np.abs(sT.numpy() - s64) <= sb).all()
    yp, sTp = jwk.wkv6(*js, chunk=16, interpret=True)
    assert (np.abs(y.numpy() - _f32(yp)) <= 2 * yb).all()
    assert (np.abs(sT.numpy() - _f32(sTp)) <= 2 * sb).all()


@pytest.mark.parametrize("shape", [(1, 128, 2, 16), (1, 96, 2, 32),
                                   (1, 48, 2, 64)])
def test_wkv6_kernel_order_twin_within_error_bound(shape):
    """`ref.wkv6_tiled` sums as the CUDA kernel does (row groups in order,
    a pairwise tree over the groups, the bonus factored into v_j times one
    dot product: its rows in 16-byte units, the units in a tree).  At the
    model's scale in float32 it lies within `ref.f32_error_bound` of the
    float64 result, and within twice it of the plain version and of the
    reference's Pallas kernel."""
    a = _wkv_inputs(*shape, seed=3 * sum(shape))
    a = [x * 2 if i < 3 else x for i, x in enumerate(a)]
    js, ts = _to(a, "float32")
    y, sT = twr.wkv6_tiled(*ts)
    assert y.dtype == torch.float32 and y.shape == ts[0].shape
    yb, sb = (x.numpy() for x in twr.f32_error_bound(*ts))
    y64, s64 = _wkv6_f64(*a)
    assert float(np.abs(y64).max()) > 30.0
    assert (np.abs(y.numpy() - y64) <= yb).all()
    assert (np.abs(sT.numpy() - s64) <= sb).all()
    y2, sT2 = twr.wkv6(*ts)
    assert (np.abs(y.numpy() - y2.numpy()) <= 2 * yb).all()
    assert torch.equal(sT, sT2)      # the state update is the same
    yp, _ = jwk.wkv6(*js, chunk=16, interpret=True)
    assert (np.abs(y.numpy() - _f32(yp)) <= 2 * yb).all()


@pytest.mark.parametrize("N", [16, 32, 64])
def test_wkv6_kernel_order_twin_bf16_halves_and_step(N):
    """The order twin in bf16 (8-row bonus units) within 2e-2 of the plain
    version; chained halves bitwise; S = 1 against ``wkv6_step``."""
    js, ts = _to(_wkv_inputs(2, 24, 3, N, seed=N), "bfloat16")
    y, sT = twr.wkv6_tiled(*ts)
    y2, sT2 = twr.wkv6(*ts)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(y), _f32(y2), **_tol("bfloat16"))
    np.testing.assert_allclose(sT.numpy(), sT2.numpy(), **STATE_TOL)
    r, k, v, w, u, s0 = ts
    ya, sA = twr.wkv6_tiled(*[t[:, :10] for t in (r, k, v, w)], u, s0)
    yb, sB = twr.wkv6_tiled(*[t[:, 10:] for t in (r, k, v, w)], u, sA)
    assert torch.equal(torch.cat([ya, yb], 1), y) and torch.equal(sB, sT)
    ys, ss = twr.wkv6_step(*[t[:, 0] for t in (r, k, v, w)], u, s0)
    y1, s1 = twr.wkv6_tiled(*[t[:, :1] for t in (r, k, v, w)], u, s0)
    np.testing.assert_allclose(_f32(y1[:, 0]), _f32(ys), **_tol("bfloat16"))
    assert torch.equal(s1, ss)


# ----------------------------------------------------------------------
# the RWKV6 block
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def block():
    """One layer's f32 weights from the reference's ``rwkv_init``."""
    cfg = JL.RWKVConfig(d_model=64, n_heads=4, d_ff=128)
    jp = JL.rwkv_init(jax.random.PRNGKey(3), cfg, dtype=jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    tcfg = TL.RWKVConfig(d_model=64, n_heads=4, d_ff=128)
    return cfg, tcfg, jp, tp


@pytest.mark.parametrize("carry", [False, True])
def test_time_and_channel_mix_match_reference(block, carry):
    cfg, tcfg, jp, tp = block
    B, S, d = 2, 12, cfg.d_model
    H, N = cfg.n_heads, cfg.head_size
    rng = np.random.default_rng(12 + carry)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    xc = rng.standard_normal((B, d)).astype(np.float32) if carry else None
    s0 = (rng.standard_normal((B, H, N, N)) * 0.1).astype(np.float32) \
        if carry else None
    xcc = rng.standard_normal((B, d)).astype(np.float32) if carry else None

    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else torch.from_numpy(a)

    jo, (jx, js) = JL.rwkv_time_mix(jp, j(x), cfg, j(xc), j(s0))
    to, (tx, ts) = TL.rwkv_time_mix(tp, t(x), tcfg, t(xc), t(s0))
    np.testing.assert_allclose(to.numpy(), _f32(jo), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), _f32(js), rtol=0, atol=1e-4)
    assert torch.equal(tx, t(x)[:, -1])
    jf, jfc = JL.rwkv_channel_mix(jp, j(x), j(xcc))
    tf, tfc = TL.rwkv_channel_mix(tp, t(x), t(xcc))
    np.testing.assert_allclose(tf.numpy(), _f32(jf), rtol=0, atol=1e-4)
    assert torch.equal(tfc, t(x)[:, -1])


# ----------------------------------------------------------------------
# configs, parameters and the smoke model
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
        rc, jc = mine.rwkv_cfg(), ref.rwkv_cfg()
        assert (rc.d_model, rc.n_heads, rc.d_ff, rc.lora_rank) == \
            (jc.d_model, jc.n_heads, jc.d_ff, jc.lora_rank)
    full = tconfigs.get(ARCH)
    assert full.n_body == 32 and full.groups[2] == []


@pytest.fixture(scope="module")
def smoke():
    """rwkv6 smoke(): the reference's f32 weights, both ways."""
    jcfg = jconfigs.get_smoke(ARCH)
    tcfg = tconfigs.get_smoke(ARCH)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, TM.params_from_jax(tcfg, tree, device="cpu")


def _shapes(node, out, path=""):
    if isinstance(node, dict):
        for k, v in node.items():
            _shapes(v, out, f"{path}/{k}")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            _shapes(v, out, f"{path}/{i}")
    else:
        out[path] = (tuple(node.shape), str(node.dtype).split(".")[-1])
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_has_reference_shapes(smoke, dtype):
    jcfg, tcfg, _, _ = smoke
    mine = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                          device="cpu", dtype=getattr(torch, dtype))
    ref = TM.params_from_jax(tcfg, jax.tree.map(
        np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0),
                                   dtype=getattr(jnp, dtype))), device="cpu")
    assert _shapes(mine, {}) == _shapes(ref, {})
    lay = mine["layers"][0]
    assert set(lay) == {"ln1", "rwkv", "ln2"}
    for name in ("mu", "w0", "u", "ln_w", "cm_mu"):
        assert lay["rwkv"][name].dtype == torch.float32, name
    # scales and ranges: wr N(0, 1/sqrt(d)), w0 in [-6, -5], u in [0, 0.5]
    wr = lay["rwkv"]["wr"].float()
    assert abs(float(wr.std()) * np.sqrt(tcfg.d_model) - 1.0) < 0.1
    assert float(lay["rwkv"]["w0"].min()) >= -6.0
    assert float(lay["rwkv"]["w0"].max()) <= -5.0
    assert 0.0 <= float(lay["rwkv"]["u"].min()) <= float(
        lay["rwkv"]["u"].max()) <= 0.5


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)


def test_smoke_forward_prefill_decode_match_reference(smoke):
    jcfg, tcfg, jparams, tparams = smoke
    B, S = 2, 20
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
        assert set(mine) == set(theirs) == {"rwkv", "rwkv_cm"}
        for name in ("x_tm", "s"):
            np.testing.assert_allclose(mine["rwkv"][name].numpy(),
                                       theirs["rwkv"][name].numpy(),
                                       rtol=0, atol=1e-4)
        np.testing.assert_allclose(mine["rwkv_cm"].numpy(),
                                   theirs["rwkv_cm"].numpy(), rtol=0,
                                   atol=1e-4)
    pos = np.full((B,), S - 1, np.int32)
    dj, _ = JM.decode_step(jparams, jcfg, sj, jt[:, S - 1:], jnp.asarray(pos))
    dt, _ = TM.decode_step(tparams, tcfg, st, tt[:, S - 1:],
                           torch.from_numpy(pos).long())
    np.testing.assert_allclose(dt.numpy(), _f32(dj), rtol=0, atol=1e-4)
    # decode from the reference's own state, carried across
    dc, _ = TM.decode_step(tparams, tcfg, carried, tt[:, S - 1:],
                           torch.from_numpy(pos).long())
    np.testing.assert_allclose(dc.numpy(), _f32(dj), rtol=0, atol=1e-4)
    # prefill(S-1) + decode == forward(S)
    np.testing.assert_allclose(dt[:, 0].numpy(), full_t[:, -1].numpy(),
                               rtol=0, atol=1e-4)


def test_smoke_greedy_generate_tokens_identical(smoke):
    jcfg, tcfg, jparams, tparams = smoke
    prompt = _tokens(tcfg, 2, 20, 6)
    want = np.asarray(JE.greedy_generate(jparams, jcfg, jnp.asarray(prompt), 6))
    got = TE.greedy_generate(tparams, tcfg, torch.from_numpy(prompt), 6,
                             device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_smoke_batcher_tokens_identical(smoke):
    """3 requests over 2 slots (slot reuse carries the recurrent state, as
    in the reference); the decode state is bf16 with an f32 WKV state."""
    jcfg, tcfg, jparams, tparams = smoke
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, tcfg.vocab, n).astype(np.int32)
               for n in (9, 5, 12)]
    want = JE.Batcher(jparams, jcfg, JE.ServeConfig(batch=2, max_seq=32)) \
        .serve(prompts, 6)
    got = TE.Batcher(tparams, tcfg, TE.ServeConfig(batch=2, max_seq=32),
                     device="cpu").serve(prompts, 6)
    assert len(got) == len(prompts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
