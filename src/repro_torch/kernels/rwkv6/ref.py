"""Plain PyTorch version of the RWKV6 WKV recurrence: a loop over time.

Per (batch, head), with key and value width N:

    y_t[j] = sum_i r_t[i] * (S[i, j] + u[i] * k_t[i] * v_t[j])
    S[i, j] <- w_t[i] * S[i, j] + k_t[i] * v_t[j]

all in float32, the arithmetic of ``repro.kernels.rwkv6.ref``.  The
reference's ``chunk=`` argument only places ``jax.checkpoint`` around
chunks of the scan for the backward pass; it does not change the result,
so this forward-only port has none until training is ported.
"""

from __future__ import annotations

import torch


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: torch.Tensor):
    """r, k, v, w: (B, S, H, N); u: (H, N); state: (B, H, N, N) ->
    (y (B, S, H, N) in r's dtype, final state (B, H, N, N) float32)."""
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    s = state.float()
    ys = torch.empty(rf.shape, dtype=torch.float32, device=rf.device)
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]     # (B, H, N, N)
        ys[:, t] = torch.einsum("bhn,bhnm->bhm", rf[:, t], s + uf * kv)
        s = wf[:, t, :, :, None] * s + kv
    return ys.to(r.dtype), s


def wkv6_step(r, k, v, w, u, state):
    """One decode step: r, k, v, w (B, H, N) -> (y (B, H, N) in r's dtype,
    new state f32)."""
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    kv = kf[..., :, None] * vf[..., None, :]
    y = torch.einsum("bhn,bhnm->bhm", rf,
                     state + u.float()[None, :, :, None] * kv)
    return y.to(r.dtype), wf[..., :, None] * state + kv


#: rows of the state each kernel thread sums in order, per head size
#: (``csrc/wkv6.cu`` ``launch``; at N = 64 its ``WKV_ROWS``)
TILE_ROWS = {16: 8, 32: 16, 64: 16}


def wkv6_tiled(r, k, v, w, u, state, rows: int | None = None):
    """`wkv6` summed in the kernel's order, in float32 without FMAs.

    Per step, y_j is the row groups' partial sums (``rows`` rows each,
    added in order) added in a pairwise tree over the groups, plus v_j
    times one bonus dot product sum_i (r_i u_i) k_i: taken in order over
    the rows of each 16-byte unit of r (8 rows in bf16, 4 in float32),
    then in a pairwise tree over the units.  The state update is the plain
    version's.  Same arguments and results as `wkv6`.

    The reordering stays inside `f32_error_bound`: the state's share of y
    is rounded at most ``rows`` + log2(N / rows) + 1 times, the bonus's at
    most 8 + 3 + log2(N / 4), both at most N + 4 for N >= 16.
    """
    B, S, H, N = r.shape
    R = rows or TILE_ROWS[N]
    P = N // R
    epu = 16 // r.element_size()
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()
    s = state.float()
    ys = torch.empty(rf.shape, dtype=torch.float32, device=rf.device)
    for t in range(S):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], wf[:, t]
        part = torch.zeros((B, H, P, N), dtype=torch.float32,
                           device=rf.device)
        for i in range(R):
            idx = torch.arange(P, device=rf.device) * R + i
            part = part + rt[:, :, idx, None] * s[:, :, idx, :]
        while part.shape[2] > 1:
            part = part[:, :, 0::2] + part[:, :, 1::2]
        ruk = ((rt * uf) * kt).view(B, H, N // epu, epu)
        dot = ruk[..., 0]
        for a in range(1, epu):
            dot = dot + ruk[..., a]
        while dot.shape[2] > 1:
            dot = dot[:, :, 0::2] + dot[:, :, 1::2]
        ys[:, t] = part[:, :, 0] + vt * dot
        s = wt[..., :, None] * s + kt[..., :, None] * vt[..., None, :]
    return ys.to(r.dtype), s


#: float32's machine epsilon (twice its unit roundoff)
F32_EPS = 2.0 ** -23


def f32_error_bound(r, k, v, w, u, state):
    """How far a float32 evaluation of `wkv6` may lie from the exact
    result, to first order in ``F32_EPS``, whatever its summation order
    and with or without FMAs: (y bound (B, S, H, N), final state bound
    (B, H, N, N)), float64.  Two float32 evaluations part by at most twice
    it.  r, k, v must be float32 (bfloat16 output rounds far more).

    With M the magnitude of the state (M <- w*M + |k v|, from |state|) and
    D the bound on its error (each step rounds kv, w*S and the sum, at
    most 3 eps of M, and decays what came before: D <- w*D + 3 eps M), y's
    sum of N terms r_i (S_ij + u_i k_i v_j), each rounded up to four times
    before a sum of N, lies within (N + 4) eps sum_i |r_i| (M_ij + |u_i k_i
    v_j|) + sum_i |r_i| D_ij of the exact y."""
    rf, kf, vf, wf = (x.double() for x in (r, k, v, w))
    ua = u.double().abs()[None, :, :, None]
    N = r.shape[-1]
    mag = state.double().abs()
    err = torch.zeros_like(mag)
    yb = torch.empty(rf.shape, dtype=torch.float64, device=rf.device)
    for t in range(r.shape[1]):
        kv = (kf[:, t, :, :, None] * vf[:, t, :, None, :]).abs()
        ra = rf[:, t].abs()
        yb[:, t] = ((N + 4) * F32_EPS
                    * torch.einsum("bhn,bhnm->bhm", ra, mag + ua * kv)
                    + torch.einsum("bhn,bhnm->bhm", ra, err))
        mag = wf[:, t, :, :, None] * mag + kv
        err = wf[:, t, :, :, None] * err + 3 * F32_EPS * mag
    return yb, err
