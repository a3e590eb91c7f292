"""The WKV6 backward (``kernels/rwkv6``) against the JAX reference, on the
CPU.

The JAX package has no backward kernel for WKV6: its training
differentiates the plain recurrence (``repro.kernels.rwkv6.ref.wkv6``,
``jax.checkpoint`` per chunk when ``chunk`` divides S).  So:

  * ``ref.wkv6_bwd`` (the reverse recurrence over states rebuilt a chunk
    at a time) against ``jax.vjp`` of that function, with and without its
    ``chunk``, on all six gradients (dr, dk, dv, dw, du, ds0), with a
    non-zero initial state and a non-zero cotangent of the final state, S
    ragged against the port's chunk, and S = 1.  Two float32 evaluations
    of the same function: within twice ``ref.f32_bwd_error_bound``;
  * that bound itself against a float64 autograd of the recurrence: the
    plain backward lies within it, and it is small against the gradients;
  * ``ops.wkv6`` under autograd on CPU tensors: the `WKV6` Function, its
    gradients ``ref.wkv6_bwd``'s bitwise, cast to each operand's dtype;
  * ``ref.wkv6_bwd_tiled`` (the backward kernel's summation order: column
    groups of a cluster added in rank order, 16-step chunks) against
    ``jax.vjp`` and against ``ref.wkv6_bwd`` at N = 16, 32 and 64, S = 1,
    ragged and several chunks, with and without dsT: within twice
    ``ref.f32_bwd_error_bound``.

Inputs are made with numpy from a seed at small sizes (B <= 2, S <= 40,
H <= 2, N = 16; the order twin up to N = 64), at the model's scale (unit r, k, v; decays w = exp(-exp(
w0)) with w0 in (-6, -5)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6 import ref as jwr
from repro_torch.kernels.rwkv6 import ops as twk
from repro_torch.kernels.rwkv6 import ref as twr

NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _draw(B, S, H, N, seed):
    """r, k, v, w, u, s0, dy, dsT as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    shape = (B, S, H, N)
    r, k, v, dy = (rng.standard_normal(shape) for _ in range(4))
    w = np.exp(-np.exp(rng.uniform(-6.0, -5.0, (H, N))
                       + rng.uniform(-0.5, 0.5, shape)))
    u = rng.uniform(0.0, 0.5, (H, N))
    s0 = rng.standard_normal((B, H, N, N)) * 0.1
    dsT = rng.standard_normal((B, H, N, N))
    return [np.asarray(a, np.float32) for a in (r, k, v, w, u, s0, dy, dsT)]


def _jax_grads(arrays, chunk):
    r, k, v, w, u, s0, dy, dsT = (jnp.asarray(a) for a in arrays)

    def f(r, k, v, w, u, s0):
        return jwr.wkv6(r, k, v, w, u, s0, chunk=chunk)
    _, vjp = jax.vjp(jax.jit(f), r, k, v, w, u, s0)
    return [np.asarray(g) for g in vjp((dy, dsT))]


#: (B, S, H, N), the JAX side's chunk, the port's chunk
CASES = [
    ((2, 40, 2, 16), None, twr.CHUNK),
    ((2, 40, 2, 16), 8, 8),
    ((1, 37, 2, 16), None, 8),
    ((2, 32, 1, 16), 16, 5),
    ((2, 1, 2, 16), None, twr.CHUNK),
]


@pytest.mark.parametrize("shape,jchunk,tchunk", CASES)
def test_wkv6_bwd_matches_jax_vjp(shape, jchunk, tchunk):
    arrays = _draw(*shape, seed=sum(shape) + (jchunk or 0))
    want = _jax_grads(arrays, jchunk)
    ts = [torch.from_numpy(a) for a in arrays]
    got = twr.wkv6_bwd(*ts, chunk=tchunk)
    bound = twr.f32_bwd_error_bound(*ts, chunk=tchunk)
    for name, g, w, b in zip(NAMES, got, want, bound):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        diff = np.abs(g.double().numpy() - w.astype(np.float64))
        assert (diff <= 2 * b.numpy()).all(), (name, float(diff.max()))


def test_wkv6_bwd_chunk_does_not_change_the_result():
    """The chunk decides which states are kept and how many steps' sums
    are taken at once: the states and the adjoint are rebuilt by the same
    arithmetic (ds0 bitwise), the sums agree within float32 rounding."""
    ts = [torch.from_numpy(a) for a in _draw(2, 29, 2, 16, seed=3)]
    one = twr.wkv6_bwd(*ts, chunk=1)
    bound = twr.f32_bwd_error_bound(*ts)
    for chunk in (4, 7, 29, 64):
        got = twr.wkv6_bwd(*ts, chunk=chunk)
        assert torch.equal(got[5], one[5])
        for name, a, b, e in zip(NAMES, got, one, bound):
            assert ((a.double() - b.double()).abs() <= 2 * e).all(), name


def _grads_f64(arrays):
    """float64 autograd through the forward recurrence."""
    r, k, v, w, u, s0, dy, dsT = (torch.from_numpy(a).double()
                                  for a in arrays)
    leaves = [t.clone().requires_grad_() for t in (r, k, v, w, u, s0)]
    r, k, v, w, u, s = leaves
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhnm->bhm", r[:, t],
                               s + u[None, :, :, None] * kv))
        s = w[:, t, :, :, None] * s + kv
    loss = (torch.stack(ys, 1) * dy).sum() + (s * dsT).sum()
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("shape", [(2, 40, 2, 16), (1, 1, 2, 16)])
def test_wkv6_bwd_within_its_float32_bound(shape):
    """The plain backward against float64 autograd: within the first-order
    bound (which a float32 evaluation in any order meets), and the bound
    is a small share of each gradient's largest magnitude, so that twice
    it still tells a wrong gradient from a right one."""
    arrays = _draw(*shape, seed=11)
    ts = [torch.from_numpy(a) for a in arrays]
    got = twr.wkv6_bwd(*ts, chunk=8)
    bound = twr.f32_bwd_error_bound(*ts, chunk=8)
    exact = _grads_f64(arrays)
    for name, g, e, b in zip(NAMES, got, exact, bound):
        assert ((g.double() - e).abs() <= b).all(), name
        assert float(b.max()) <= 2e-3 * float(e.abs().max()), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_function_on_cpu_is_the_plain_backward(dtype):
    """Under autograd ``ops.wkv6`` is the `WKV6` Function: its gradients are
    ``ref.wkv6_bwd``'s on the cotangents autograd hands it, cast to each
    operand's dtype; with no operand requiring grad it is the plain
    forward alone."""
    arrays = _draw(2, 12, 2, 16, seed=5)
    r, k, v, w, u, s0, dy, dsT = (torch.from_numpy(a) for a in arrays)
    r, k, v = (t.to(dtype) for t in (r, k, v))
    leaves = [t.clone().requires_grad_() for t in (r, k, v, w, u, s0)]
    y, sT = twk.wkv6(*leaves)
    assert type(y.grad_fn).__name__ == "WKV6Backward"
    dyd = dy.to(dtype)
    torch.autograd.backward((y, sT), (dyd, dsT))
    want = twr.wkv6_bwd(r, k, v, w, u, s0, dyd, dsT)
    for name, leaf, g in zip(NAMES, leaves, want):
        assert leaf.grad.dtype == leaf.dtype, name
        assert torch.equal(leaf.grad, g.to(leaf.dtype)), name
    y2, _ = twk.wkv6(r, k, v, w, u, s0)
    assert y2.grad_fn is None and torch.equal(y2, y.detach())


#: (B, S, H, N), with dsT, the twin's columns a CTA: each head size, S = 1,
#: S ragged against the 16-step chunk and several whole chunks
TILED_CASES = [
    ((2, 40, 2, 16), True, 16),
    ((1, 1, 2, 16), False, 16),
    ((1, 37, 2, 32), True, 16),
    ((2, 32, 1, 32), False, 32),
    ((1, 48, 1, 64), True, 16),
    ((1, 21, 2, 64), False, 16),
    ((2, 1, 1, 64), True, 32),
]


@pytest.mark.parametrize("shape,with_dsT,cols", TILED_CASES)
def test_wkv6_bwd_tiled_matches_plain(shape, with_dsT, cols):
    """The kernel's summation order against the plain backward: the same
    states and adjoint (ds0 bitwise), every gradient within twice the
    float32 bound."""
    arrays = _draw(*shape, seed=sum(shape) + cols)
    ts = [torch.from_numpy(a) for a in arrays]
    if not with_dsT:
        ts[7] = None
    got = twr.wkv6_bwd_tiled(*ts, cols=cols)
    want = twr.wkv6_bwd(*ts)
    bound = twr.f32_bwd_error_bound(*ts)
    assert torch.equal(got[5], want[5])
    for name, g, w, b in zip(NAMES, got, want, bound):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert ((g.double() - w.double()).abs() <= 2 * b).all(), name


@pytest.mark.parametrize("shape,with_dsT", [((2, 40, 2, 16), True),
                                            ((1, 35, 1, 64), False)])
def test_wkv6_bwd_tiled_matches_jax_vjp(shape, with_dsT):
    """The kernel's summation order against ``jax.vjp`` of the reference's
    plain recurrence (S off the 16-step chunk)."""
    arrays = _draw(*shape, seed=sum(shape) + 2)
    if not with_dsT:
        arrays[7] = np.zeros_like(arrays[7])
    want = _jax_grads(arrays, None)
    ts = [torch.from_numpy(a) for a in arrays]
    if not with_dsT:
        ts[7] = None
    got = twr.wkv6_bwd_tiled(*ts)
    bound = twr.f32_bwd_error_bound(*ts)
    for name, g, w, b in zip(NAMES, got, want, bound):
        diff = np.abs(g.double().numpy() - w.astype(np.float64))
        assert (diff <= 2 * b.numpy()).all(), (name, float(diff.max()))


def test_wkv6_bwd_tiled_order_differs_from_the_plain_sums():
    """The twin is no copy of the plain backward: at N = 64 its grouped
    sums round differently in some element of dr, dk, dv and dw (within
    the bound, as the other tests hold)."""
    ts = [torch.from_numpy(a) for a in _draw(1, 20, 2, 64, seed=9)]
    got = twr.wkv6_bwd_tiled(*ts)
    want = twr.wkv6_bwd(*ts)
    for name, g, w in zip(NAMES[:4], got, want):
        assert not torch.equal(g, w), name
