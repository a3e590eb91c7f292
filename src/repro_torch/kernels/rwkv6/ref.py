"""Plain PyTorch version of the RWKV6 WKV recurrence: a loop over time.

Per (batch, head), with key and value width N:

    y_t[j] = sum_i r_t[i] * (S[i, j] + u[i] * k_t[i] * v_t[j])
    S[i, j] <- w_t[i] * S[i, j] + k_t[i] * v_t[j]

all in float32, the arithmetic of ``repro.kernels.rwkv6.ref``.  The
reference's ``chunk=`` argument only places ``jax.checkpoint`` around
chunks of the scan for the backward pass; it does not change the result.
Here the backward is written out (`wkv6_bwd`, the reverse recurrence),
and its ``chunk=`` plays that part: the states are rebuilt, a chunk at a
time, from every chunk-th state of one forward pass.
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


#: steps between the stored states of `wkv6_bwd`'s forward pass: memory
#: holds S / CHUNK states and two chunks' worth, O(sqrt S) at 4,096
CHUNK = 64


def _chunks(step, s0, S: int, chunk: int):
    """(t0, states) for each chunk of ``chunk`` steps, last first, where
    states[m] is s_{t0 + m}, the state before step t0 + m (s_0 = s0, s_{t+1}
    = step(t, s_t)): one forward pass keeps every ``chunk``-th state, then
    each chunk rebuilds its states from the one kept at its start."""
    kept, s = [s0], s0
    for t in range((S - 1) // chunk * chunk):    # up to the last chunk
        s = step(t, s)
        if (t + 1) % chunk == 0:
            kept.append(s)
    for c in range(len(kept) - 1, -1, -1):
        t0 = c * chunk
        states = [kept[c]]
        for t in range(t0, min(t0 + chunk, S) - 1):
            states.append(step(t, states[-1]))
        yield t0, states


def wkv6_bwd(r, k, v, w, u, state, dy, dsT=None, chunk: int = CHUNK):
    """The gradients of `wkv6` by the reverse recurrence, all float32.

    r, k, v, w, dy (B, S, H, N); u (H, N); state and dsT (or None) (B, H,
    N, N) -> (dr, dk, dv, dw (B, S, H, N), du (H, N), ds0 (B, H, N, N)).
    With G_t = dL/dS_t (G_S = dsT, or zeros), per (b, h), i the key row
    and j the value column, S_{t-1} the state before step t:

        dr_t[i] = sum_j S_{t-1}[i, j] dy_t[j] + u_i k_t[i] (v_t . dy_t)
        dk_t[i] = sum_j G_t[i, j] v_t[j] + r_t[i] u_i (v_t . dy_t)
        dv_t[j] = sum_i G_t[i, j] k_t[i] + dy_t[j] sum_i r_t[i] u_i k_t[i]
        dw_t[i] = sum_j G_t[i, j] S_{t-1}[i, j]
        du[h, i] = sum_{b, t} r_t[i] k_t[i] (v_t . dy_t)
        G_{t-1} = diag(w_t) G_t + r_t dy_t^T,   ds0 = G_0

    S_{t-1} comes from `_chunks` (states rebuilt from every ``chunk``-th
    one), never from dividing by w, which underflows towards 0.  Within a
    chunk the two recurrences run step by step and the sums for all of
    its steps at once."""
    B, S, H, N = r.shape
    rf, kf, vf, wf, dyf = (x.float() for x in (r, k, v, w, dy))
    uf = u.float()
    f32 = dict(dtype=torch.float32, device=rf.device)
    dr, dk, dv, dw = (torch.empty((B, S, H, N), **f32) for _ in range(4))
    du = torch.zeros((H, N), **f32)
    g = (torch.zeros((B, H, N, N), **f32) if dsT is None
         else dsT.float().clone())

    def step(t, s):
        return (wf[:, t, :, :, None] * s
                + kf[:, t, :, :, None] * vf[:, t, :, None, :])
    for t0, states in _chunks(step, state.float(), S, chunk):
        n = len(states)
        gs = [None] * n                   # gs[m] = G_{t0 + m}
        for m in range(n - 1, -1, -1):
            gs[m] = g
            t = t0 + m
            g = (wf[:, t, :, :, None] * g
                 + rf[:, t, :, :, None] * dyf[:, t, :, None, :])
        sp, gg = torch.stack(states, 1), torch.stack(gs, 1)  # (B, n, H, N, N)
        sl = slice(t0, t0 + n)
        rc, kc, vc, dyc = (x[:, sl] for x in (rf, kf, vf, dyf))
        vdy = (vc * dyc).sum(-1, keepdim=True)
        dr[:, sl] = torch.einsum("bthij,bthj->bthi", sp, dyc) + uf * kc * vdy
        dk[:, sl] = torch.einsum("bthij,bthj->bthi", gg, vc) + rc * uf * vdy
        dv[:, sl] = (torch.einsum("bthij,bthi->bthj", gg, kc)
                     + dyc * (rc * uf * kc).sum(-1, keepdim=True))
        dw[:, sl] = (gg * sp).sum(-1)
        du += (rc * kc * vdy).sum((0, 1))
    return dr, dk, dv, dw, du, g


def f32_bwd_error_bound(r, k, v, w, u, state, dy, dsT=None,
                        chunk: int = CHUNK):
    """How far a float32 evaluation of `wkv6_bwd` may lie from the exact
    gradients, to first order in ``F32_EPS``, whatever its summation order
    and with or without FMAs: bounds of (dr, dk, dv, dw, du, ds0), float64,
    in `wkv6_bwd`'s shapes.  Two float32 evaluations part by at most twice
    it.  The inputs are exact in float32 (bfloat16 r, k, v, dy are).

    The state's magnitude M and error D follow `f32_error_bound`; the
    adjoint's, Gm and E, follow the same rule backwards (Gm <- w Gm +
    |r dy|, E <- w E + 3 eps Gm, from |dsT| and 0).  Each gradient is a sum
    of at most N products plus a bonus term itself a sum of N products,
    each term rounded at most N + 4 times; a term a x with x carrying the
    error e adds |a| e.  du sums B S such terms, so its factor is B S + N
    + 4."""
    B, S, H, N = r.shape
    rf, kf, vf, wf, dyf = (x.double().abs() for x in (r, k, v, w, dy))
    ua = u.double().abs()
    e = F32_EPS
    f64 = dict(dtype=torch.float64, device=rf.device)
    br, bk, bv, bw = (torch.empty((B, S, H, N), **f64) for _ in range(4))
    bu = torch.zeros((H, N), **f64)
    gm = (torch.zeros((B, H, N, N), **f64) if dsT is None
          else dsT.double().abs())
    ge = torch.zeros_like(gm)
    c = (N + 4) * e

    def step(t, md):
        mag, err = md
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        mag = wf[:, t, :, :, None] * mag + kv
        return mag, wf[:, t, :, :, None] * err + 3 * e * mag
    s0 = state.double().abs()
    mv = torch.einsum
    for t0, states in _chunks(step, (s0, torch.zeros_like(s0)), S, chunk):
        n = len(states)
        gms, ges = [None] * n, [None] * n
        for m in range(n - 1, -1, -1):
            gms[m], ges[m] = gm, ge
            t = t0 + m
            gm = (wf[:, t, :, :, None] * gm
                  + rf[:, t, :, :, None] * dyf[:, t, :, None, :])
            ge = wf[:, t, :, :, None] * ge + 3 * e * gm
        mag = torch.stack([x[0] for x in states], 1)
        err = torch.stack([x[1] for x in states], 1)
        G, E = torch.stack(gms, 1), torch.stack(ges, 1)
        sl = slice(t0, t0 + n)
        rc, kc, vc, dyc = (x[:, sl] for x in (rf, kf, vf, dyf))
        vdy = (vc * dyc).sum(-1, keepdim=True)
        ruk = (rc * ua * kc).sum(-1, keepdim=True)
        br[:, sl] = (c * (mv("bthij,bthj->bthi", mag, dyc) + ua * kc * vdy)
                     + mv("bthij,bthj->bthi", err, dyc))
        bk[:, sl] = (c * (mv("bthij,bthj->bthi", G, vc) + rc * ua * vdy)
                     + mv("bthij,bthj->bthi", E, vc))
        bv[:, sl] = (c * (mv("bthij,bthi->bthj", G, kc) + dyc * ruk)
                     + mv("bthij,bthi->bthj", E, kc))
        bw[:, sl] = c * (G * mag).sum(-1) + (E * mag + G * err).sum(-1)
        bu += (B * S + N + 4) * e * (rc * kc * vdy).sum((0, 1))
    return br, bk, bv, bw, bu, ge


#: steps a chunk of the backward kernel (``csrc/wkv6.cu`` ``kBwdK``): its
#: checkpoint stride and the depth of the states each chunk rebuilds
BWD_CHUNK = 16
#: columns of the state one CTA of the backward kernel owns
#: (``WKV_BWD_COLS``): a (b, h) is a cluster of N / BWD_COLS CTAs
BWD_COLS = 32


def _tree(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dimension (a power of two) in a pairwise tree,
    neighbours first: the order of a reduction over lanes by
    ``__shfl_xor`` at offsets 1, 2, 4, ..."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _fold(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dimension in order, left to right."""
    out = x[..., 0]
    for a in range(1, x.shape[-1]):
        out = out + x[..., a]
    return out


def wkv6_bwd_tiled(r, k, v, w, u, state, dy, dsT=None,
                   cols: int = BWD_COLS):
    """`wkv6_bwd` summed in the backward kernel's order, in float32 without
    FMAs.  Same arguments and results as `wkv6_bwd`.

    The kernel splits each (b, h) over a cluster of N / ``cols`` CTAs, one
    group of ``cols`` columns each; a thread holds 2 rows x 4 columns of
    S and G.  Per step:

      * dr, dk, dw (sums over columns): the thread's 4 columns in order,
        a pairwise tree over the ``cols`` / 4 lanes of the CTA's columns,
        the CTAs' totals in rank order, then the bonus term;
      * dv (a sum over rows): the thread's 2 rows, a pairwise tree over
        the row groups of a warp (32 / (``cols`` / 4) groups), the warps
        in order, then dy times the bonus;
      * v . dy and sum_i (r_i u_i) k_i: 8 elements in order, then a
        pairwise tree over the N / 8 groups;
      * du: each (b, h)'s steps split over N / 8 slots (slot x takes steps
        t0 + x, t0 + x + N / 8, ... of each chunk, chunks last first), the
        slots in order, then the batch in order.

    The states come from every `BWD_CHUNK`-th one (`_chunks`), as the
    kernel's checkpoints.  Every sum stays a sum of the same terms, so the
    result lies within `f32_bwd_error_bound` of the exact gradients."""
    B, S, H, N = r.shape
    nc = min(cols, N)
    cl, lc = N // nc, nc // 4
    rgw = 32 // lc
    nw = N // (2 * rgw)
    P = N // 8
    rf, kf, vf, wf, dyf = (x.float() for x in (r, k, v, w, dy))
    uf = u.float()
    f32 = dict(dtype=torch.float32, device=rf.device)
    dr, dk, dv, dw = (torch.empty((B, S, H, N), **f32) for _ in range(4))
    du_slots = torch.zeros((B, H, P, N), **f32)
    g = (torch.zeros((B, H, N, N), **f32) if dsT is None
         else dsT.float().clone())

    def over_cols(x):   # (B, H, N, N) products -> (B, H, N) row sums
        x = x.reshape(B, H, N, cl, lc, 4)
        return _fold(_tree(_fold(x)))

    def over_rows(x):   # (B, H, N, N) products -> (B, H, N) column sums
        x = x.reshape(B, H, nw, rgw, 2, N)
        x = x[:, :, :, :, 0] + x[:, :, :, :, 1]           # (B, H, nw, rgw, N)
        return _fold(_tree(x.movedim(3, -1)).movedim(2, -1))

    def dot8(x):        # (B, H, N) products -> (B, H)
        return _tree(_fold(x.reshape(B, H, P, 8)))

    def step(t, s):
        return (wf[:, t, :, :, None] * s
                + kf[:, t, :, :, None] * vf[:, t, :, None, :])
    for t0, states in _chunks(step, state.float(), S, BWD_CHUNK):
        n = len(states)
        rk_vdy = torch.empty((B, n, H, N), **f32)
        for m in range(n - 1, -1, -1):
            t = t0 + m
            sp = states[m]
            rt, kt, vt, wt, dyt = (x[:, t] for x in (rf, kf, vf, wf, dyf))
            vdy = dot8(vt * dyt)[..., None]
            bonus = dot8((rt * uf) * kt)[..., None]
            dr[:, t] = over_cols(sp * dyt[:, :, None, :]) + uf * kt * vdy
            dk[:, t] = over_cols(g * vt[:, :, None, :]) + rt * uf * vdy
            dw[:, t] = over_cols(g * sp)
            dv[:, t] = over_rows(g * kt[:, :, :, None]) + dyt * bonus
            rk_vdy[:, m] = (rt * kt) * vdy
            g = wt[..., :, None] * g + rt[..., :, None] * dyt[..., None, :]
        for j in range(0, BWD_CHUNK, P):       # slot x takes step j + x
            idx = [m for m in range(j, j + P) if m < n]
            if idx:
                du_slots[:, :, :len(idx)] += rk_vdy[:, idx].movedim(1, 2)
    du = _fold(_fold(du_slots.movedim(2, -1)).movedim(0, -1))
    return dr, dk, dv, dw, du, g
