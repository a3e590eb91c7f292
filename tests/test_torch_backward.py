"""The backward plain versions and the autograd Functions of the port's
kernels, against torch autograd and the JAX reference, on the CPU.

  * ``flash_attention.ref.attention_bwd`` (the full matrices in float32,
    from the output and the row log-sum-exps) against torch autograd
    through ``ref.attention`` within 1e-5, and against ``jax.vjp`` of the
    reference's ``kernels.flash_attention.ref.attention`` and of its
    model's ``layers.attention`` (the function the reference's training
    differentiates) within 2e-5: MQA 4/1 with a window, GQA 4/2 with cap
    50, MHA, and S off any tile size; the forward's log-sum-exp against
    ``torch.logsumexp`` of the masked scores;
  * its bf16 kernel's rounding point (``attention_bwd(tile_dtype=
    torch.bfloat16)``: P and dS rounded before their products) against
    the float32 version and ``jax.vjp`` of the reference model's attention
    within the card's limit, 2e-2 of the maximum, at hd 64, 128 and 256,
    MHA/GQA/MQA, a window, a cap the scores reach, and Sq != Sk;
  * ``rg_lru.ref.rglru_scan_bwd`` (the reverse loop) against autograd
    through ``ref.rglru_scan`` within 1e-6 and against ``jax.vjp`` of the
    reference's ``layers.rglru_scan`` (its associative scan) within 1e-5;
  * the ops' autograd Functions on CPU tensors equal plain autograd, with
    dk and dv summed over each KV group, ``None`` for the non-tensor
    arguments and the operands' dtypes kept; with no operand requiring
    grad the op is the plain forward, Function-free;
  * ``wkv6`` under autograd on the CPU runs through its `WKV6` Function,
    whose backward is the plain reverse recurrence ``ref.wkv6_bwd``: its
    gradients within 1e-5 of autograd through the plain forward loop;
  * ``model.loss_fn`` against the reference's for a vision model (the
    patch positions sliced off) and a codebook model (tokens counted K
    times), and its chunking (S = 24 in chunks of 8) against one chunk.

The Pallas kernels of the reference are not differentiable and are not
used here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.flash_attention import ref as jfref
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.kernels.rg_lru import ops as rops
from repro_torch.kernels.rg_lru import ref as rref
from repro_torch.kernels.rwkv6 import ops as wops
from repro_torch.kernels.rwkv6 import ref as wref
from repro_torch.models import model as TM

#: (B, Sq, Sk, H, KV, hd), opts
ATTN_CASES = [
    ((2, 37, 37, 4, 1, 16), dict(causal=True, window=9)),
    ((1, 40, 40, 4, 2, 32), dict(causal=True, cap=50.0)),
    ((2, 33, 33, 3, 3, 8), dict(causal=True)),
    ((1, 29, 45, 4, 2, 16), dict(causal=False, cap=5.0)),
]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _draw(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jit_vjp(fn, *args, cot):
    """The vjp of ``fn`` at ``args`` applied to ``cot``, jitted (one
    compile instead of one per op)."""
    def run(cot, *args):
        return jax.vjp(fn, *args)[1](cot)
    return jax.jit(run)(jnp.asarray(cot), *(jnp.asarray(a) for a in args))


def _attn_inputs(shape, seed):
    B, Sq, Sk, H, KV, hd = shape
    return _draw(((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd),
                  (B, Sq, H, hd)), seed)


def _plain_bwd(q, k, v, do, opts):
    t = [torch.from_numpy(x) for x in (q, k, v)]
    o, lse = fref.attention(*t, return_lse=True, **opts)
    return o, lse, fref.attention_bwd(*t, o, lse, torch.from_numpy(do),
                                      **opts)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("shape,opts", ATTN_CASES)
def test_attention_bwd_matches_torch_autograd(shape, opts):
    q, k, v, do = _attn_inputs(shape, sum(shape))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fref.attention(*leaves, **opts)
    want = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    o, lse, got = _plain_bwd(q, k, v, do, opts)
    assert torch.equal(o, out.detach())
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    # the row log-sum-exps of the scaled, capped, masked scores
    B, Sq, Sk, H, KV, hd = shape
    kf = torch.from_numpy(k).repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", torch.from_numpy(q), kf) / hd ** 0.5
    if opts.get("cap"):
        s = opts["cap"] * torch.tanh(s / opts["cap"])
    mask = fref.live_mask(Sq, Sk, causal=opts["causal"],
                          window=opts.get("window"))
    _close(lse, torch.logsumexp(s.masked_fill(~mask, -1e30), -1), 1e-5)


@pytest.mark.parametrize("shape,opts", ATTN_CASES)
def test_attention_bwd_matches_jax_vjp(shape, opts):
    """Against ``jax.vjp`` of the reference's plain attention, and of the
    model's chunked attention that its training differentiates."""
    q, k, v, do = _attn_inputs(shape, sum(shape) + 1)
    _, _, got = _plain_bwd(q, k, v, do, opts)
    for fn in (jfref.attention, JL.attention):
        want = _jit_vjp(lambda a, b, c, fn=fn: fn(a, b, c, **opts),
                        q, k, v, cot=do)
        for g, w in zip(got, want):
            _close(g.numpy(), w, 2e-5)


#: the bf16 backward kernel's widths: (B, Sq, Sk, H, KV, hd), opts, the
#: factor q and k are scaled by (so capped scores reach the cap's bend)
TILE_CASES = [
    ((1, 70, 70, 4, 1, 256), dict(causal=True, window=30), 1.0),
    ((1, 65, 65, 8, 4, 256), dict(causal=True, cap=50.0), 4.0),
    ((2, 48, 48, 4, 2, 128), dict(causal=True, cap=20.0), 3.0),
    ((1, 40, 72, 3, 3, 64), dict(causal=False), 1.0),
    ((2, 50, 50, 4, 1, 64), dict(causal=True, window=17), 1.0),
]
#: the card's bf16 limit (chip_smoke.py FLASH_BWD_TOL): max |diff| over
#: the reference's max |value|
FLASH_BWD_TOL = 2e-2


@pytest.mark.parametrize("shape,opts,qk_scale", TILE_CASES)
def test_attention_bwd_bf16_tiles_within_the_card_limit(shape, opts,
                                                        qk_scale):
    """The bf16 kernel's one new rounding, P and dS to bf16 before their
    products (``attention_bwd(tile_dtype=torch.bfloat16)``), on bf16
    operands: within `FLASH_BWD_TOL` of the float32 plain version and of
    ``jax.vjp`` of the reference model's attention; and not equal to the
    float32 version, so the rounding is there to be held."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16).float() for x in
                   _attn_inputs(shape, sum(shape) + 5))
    q, k = q * qk_scale, k * qk_scale
    o, lse = fref.attention(q, k, v, return_lse=True, **opts)
    got = fref.attention_bwd(q, k, v, o, lse, do, tile_dtype=torch.bfloat16,
                             **opts)
    plain = fref.attention_bwd(q, k, v, o, lse, do, **opts)
    want = _jit_vjp(lambda a, b, c: JL.attention(a, b, c, **opts),
                    q.numpy(), k.numpy(), v.numpy(), cot=do.numpy())
    for g, p, w in zip(got, plain, want):
        w = np.asarray(w, np.float64)
        for ref_side in (p.double().numpy(), w):
            err = np.abs(g.double().numpy() - ref_side).max()
            assert err <= FLASH_BWD_TOL * np.abs(ref_side).max(), err
    assert not all(torch.equal(g, p) for g, p in zip(got, plain))


@pytest.mark.parametrize("shape", [(2, 50, 7), (1, 1, 5), (3, 33, 16)])
def test_rglru_scan_bwd_matches_autograd_and_jax(shape):
    B, S, D = shape
    rng = np.random.default_rng(S + D)
    x = rng.standard_normal(shape).astype(np.float32)
    a = rng.uniform(0.4, 0.999, shape).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    dh = rng.standard_normal(shape).astype(np.float32)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (x, a, h0)]
    h, _ = rref.rglru_scan(*leaves)
    want = torch.autograd.grad(h, leaves, torch.from_numpy(dh))
    got = rref.rglru_scan_bwd(torch.from_numpy(a), h.detach(),
                              torch.from_numpy(h0), torch.from_numpy(dh))
    for g, w in zip(got, want):
        _close(g, w, 1e-6)
    # the reference's associative scan (the function its training
    # differentiates; it returns h only)
    for g, w in zip(got, _jit_vjp(JL.rglru_scan, x, a, h0, cot=dh)):
        _close(g.numpy(), w, 1e-5)
    # a gradient of the final state as well
    dhT = rng.standard_normal((B, D)).astype(np.float32)
    h, hT = rref.rglru_scan(*leaves)
    want = torch.autograd.grad((h, hT), leaves,
                               (torch.from_numpy(dh), torch.from_numpy(dhT)))
    got = rref.rglru_scan_bwd(torch.from_numpy(a), h.detach(),
                              torch.from_numpy(h0), torch.from_numpy(dh),
                              torch.from_numpy(dhT))
    for g, w in zip(got, want):
        _close(g, w, 1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,opts", ATTN_CASES[:2])
def test_flash_function_equals_plain_autograd(shape, opts, dtype):
    q, k, v, do = _attn_inputs(shape, sum(shape) + 2)
    base = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    dot = torch.from_numpy(do).to(dtype)
    sides = []
    for fn in (fops.flash_attention, fref.attention):
        leaves = [t.clone().requires_grad_() for t in base]
        out = fn(*leaves, **opts)
        out.backward(dot)
        sides.append((out.detach(), [t.grad for t in leaves]))
    (o1, g1), (o2, g2) = sides
    assert torch.equal(o1, o2)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for g, w, t in zip(g1, g2, base):
        assert g.dtype == dtype and g.shape == t.shape
        _close(g.float(), w.float(), tol)


def test_flash_function_saves_and_sums_the_group():
    """The Function's graph: q, k, v, o and lse saved; a KV head's grads
    summed over its query heads (here 4 heads on one KV head); a grad of
    k alone needs no grad of q."""
    q, k, v, do = _attn_inputs((1, 12, 12, 4, 1, 8), 3)
    tq = torch.from_numpy(q)
    tk = torch.from_numpy(k).requires_grad_()
    tv = torch.from_numpy(v)
    out = fops.flash_attention(tq, tk, tv, causal=True, window=4)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert len(out.grad_fn.saved_tensors) == 5
    (gk,) = torch.autograd.grad(out, [tk], torch.from_numpy(do))
    # the same with k repeated per head: the group's sum
    tk4 = torch.from_numpy(np.repeat(k, 4, axis=2)).requires_grad_()
    out4 = fref.attention(tq, tk4, torch.from_numpy(np.repeat(v, 4, axis=2)),
                          causal=True, window=4)
    (gk4,) = torch.autograd.grad(out4, [tk4], torch.from_numpy(do))
    _close(gk, gk4.sum(2, keepdim=True), 1e-5)


def test_ops_without_grad_are_the_plain_forward():
    q, k, v, _ = _attn_inputs((1, 20, 20, 2, 1, 8), 4)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    out = fops.flash_attention(*t, causal=True, window=6)
    assert out.grad_fn is None
    assert torch.equal(out, fref.attention(*t, causal=True, window=6))
    leaves = [x.clone().requires_grad_() for x in t]
    with torch.no_grad():
        assert fops.flash_attention(*leaves, causal=True).grad_fn is None
    x = torch.randn(2, 9, 3)
    a = torch.rand(2, 9, 3)
    h0 = torch.zeros(2, 3)
    h, hT = rops.rglru_scan(x, a, h0)
    assert h.grad_fn is None
    h2, hT2 = rref.rglru_scan(x, a, h0)
    assert torch.equal(h, h2) and torch.equal(hT, hT2)


def test_rglru_function_equals_plain_autograd():
    rng = np.random.default_rng(8)
    x, dh = _draw(((2, 40, 6), (2, 40, 6)), 9)
    a = rng.uniform(0.5, 0.99, (2, 40, 6)).astype(np.float32)
    sides = []
    for fn in (rops.rglru_scan, rref.rglru_scan):
        leaves = [torch.from_numpy(x).requires_grad_(),
                  torch.from_numpy(a).requires_grad_(),
                  torch.zeros(2, 6, requires_grad=True)]
        h, hT = fn(*leaves)
        (h.sum() * 0 + (h * torch.from_numpy(dh)).sum() + hT.sum()).backward()
        sides.append([t.grad for t in leaves])
    assert type(rops.rglru_scan(*[torch.from_numpy(x).requires_grad_(),
                                  torch.from_numpy(a),
                                  torch.zeros(2, 6)])[0].grad_fn).__name__ \
        == "RGLRUScanBackward"
    for g, w in zip(*sides):
        _close(g, w, 1e-6)


def test_wkv6_autograd_on_cpu_runs_the_plain_version():
    """On CPU tensors the op's Function runs the plain versions: the
    forward loop, then ``ref.wkv6_bwd`` (its gradients bitwise), which
    agrees with autograd through the forward loop within 1e-5 of each
    gradient's largest element (float32 sums in another order)."""
    rng = np.random.default_rng(2)
    B, S, H, N = 1, 6, 2, 16
    r, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, N)).astype(
        np.float32) * 0.5).requires_grad_() for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.5, 0.95, (B, S, H, N)).astype(
        np.float32))
    u = torch.from_numpy(rng.standard_normal((H, N)).astype(np.float32))
    s0 = torch.zeros(B, H, N, N)
    y, _ = wops.wkv6(r, k, v, w, u, s0)
    assert type(y.grad_fn).__name__ == "WKV6Backward"
    g1 = torch.autograd.grad(y.sum(), [r, k, v])
    want = wref.wkv6_bwd(r.detach(), k.detach(), v.detach(), w, u, s0,
                         torch.ones_like(y), torch.zeros_like(s0))
    for a, b in zip(g1, want):
        assert torch.equal(a, b)
    y2, _ = wref.wkv6(r, k, v, w, u, s0)
    g2 = torch.autograd.grad(y2.sum(), [r, k, v])
    for a, b in zip(g1, g2):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("arch", ["qwen2_vl_7b", "musicgen_large"])
def test_loss_fn_matches_reference(arch):
    """The vision model's patch positions sliced off before the head, the
    codebook model's tokens counted K times; float32, the reference's
    weights."""
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    tree = jax.tree.map(np.asarray, jax.jit(
        lambda key: JM.init_params(jcfg, key, jnp.float32))(
            jax.random.PRNGKey(2)))
    params = TM.params_from_jax(tcfg, tree, device="cpu")
    rng = np.random.default_rng(4)
    shape = (2, 12, tcfg.n_codebooks) if tcfg.n_codebooks > 1 else (2, 12)
    toks = rng.integers(0, tcfg.vocab, shape).astype(np.int32)
    labels = rng.integers(0, tcfg.vocab, shape).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    if tcfg.vlm_patches:
        p = rng.standard_normal((2, tcfg.vlm_patches, tcfg.d_model)).astype(
            np.float32)
        jb["patches"], tb["patches"] = jnp.asarray(p), torch.from_numpy(p)
    want = float(jax.jit(lambda pr, b: JM.loss_fn(pr, jcfg, b))(tree, jb))
    with torch.no_grad():
        got = float(TM.loss_fn(params, tcfg, tb))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_loss_chunks_sum_to_one_chunk():
    cfg = tconfigs.get_smoke("granite3_8b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(3),
                            device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)).astype(
        np.int32))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    with torch.no_grad():
        chunked = TM.loss_fn(params, cfg, batch)          # 3 chunks of 8
        whole = TM.loss_fn(params, cfg, batch, seq_chunk=24)
    assert abs(float(chunked) - float(whole)) <= 1e-6 * abs(float(whole))
