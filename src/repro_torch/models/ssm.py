"""Mamba-2 (SSD — state-space duality) in plain torch (port of
``repro/models/ssm.py``).

Chunked SSD algorithm (Dao & Gu 2024): the sequence is split into chunks of
length Q; within a chunk the recurrence is computed as a masked
attention-like quadratic form, and a (B, H, P, N) state is carried across
chunks by a loop (the JAX code's ``lax.scan``).

``ssd_reference`` is the exact sequential recurrence (the oracle for both
the chunked path and the kernels/ssd_scan kernel).

Shapes:
    x   (B, S, H, P)    inputs per head
    dt  (B, S, H)       softplus-ed step sizes
    A   (H,)            negative decay rates
    Bc  (B, S, G, N)    input projections (groups broadcast over heads)
    Cc  (B, S, G, N)    output projections
    D   (H,)            skip connection
state: (B, H, P, N) float32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _expand_groups(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, ..., G, N) -> (B, ..., H, N) by repeating each group."""
    G = t.shape[-2]
    if G == n_heads:
        return t
    return torch.repeat_interleave(t, n_heads // G, dim=-2)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bc: torch.Tensor, Cc: torch.Tensor, D: torch.Tensor,
                chunk: int = 128, h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) f32)."""
    B, S, H, P = x.shape
    N = Bc.shape[-1]
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    nc = S // chunk

    G = Bc.shape[-2]
    rep = H // G
    dtf = dt.float()
    da = dtf * A.float()                # (B, S, H) — log-decay per step

    def ck(t):
        return t.reshape(B, nc, chunk, *t.shape[2:])
    xc, dtc = ck(x), ck(dtf)
    Bcc, Ccc = ck(Bc), ck(Cc)
    L = torch.cumsum(ck(da), dim=2)     # (B, nc, Q, H) inclusive cum log-decay
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, :, :, None]

    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0
    ys = []
    for c in range(nc):
        xq, dtq, Lq = xc[:, c], dtc[:, c], L[:, c]
        Bf, Cf = Bcc[:, c].float(), Ccc[:, c].float()
        xf = xq.float()
        # intra-chunk quadratic form, grouped:
        # scores_hij = (C_gi . B_gj) * exp(L_hi - L_hj) * dt_hj  for i >= j
        cb = torch.einsum("bign,bjgn->bgij", Cf, Bf)        # (B, G, i, j)
        decay = Lq[:, :, None, :] - Lq[:, None, :, :]       # (B, i, j, H)
        # select, never multiply: exp above the diagonal may be inf
        M = torch.where(causal, torch.exp(decay),
                        torch.zeros((), device=x.device)) \
            * dtq[:, None, :, :]                            # (B, i, j, H)
        M = M.permute(0, 3, 1, 2)                           # (B, H, i, j)
        cb_h = torch.repeat_interleave(cb, rep, dim=1) if rep > 1 else cb
        y_intra = torch.einsum("bhij,bjhp->bihp", cb_h * M, xf)
        # inter-chunk: contribution of the incoming state
        if G == 1:
            y_inter = torch.einsum("bign,bih,bhpn->bihp", Cf,
                                   torch.exp(Lq), h)
        else:
            y_inter = torch.einsum(
                "bihn,bhpn->bihp",
                torch.repeat_interleave(Cf, rep, dim=2)
                * torch.exp(Lq)[..., None], h)
        # state update: h' = exp(L_Q) h + sum_j exp(L_Q - L_j) dt_j B_j x_j
        Lq_last = Lq[:, -1][:, None]                        # (B, 1, H)
        w = torch.exp(Lq_last - Lq) * dtq                   # (B, Q, H)
        if G == 1:
            upd = torch.einsum("bjgn,bjh,bjhp->bhpn", Bf, w, xf)
        else:
            upd = torch.einsum("bjhn,bjhp->bhpn",
                               torch.repeat_interleave(Bf, rep, dim=2)
                               * w[..., None], xf)
        h = torch.exp(Lq_last[:, 0])[..., None, None] * h + upd
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(B, S, H, P)
    y = y + x.float() * D.float()[None, None, :, None]
    return y.to(x.dtype), h


def ssd_reference(x, dt, A, Bc, Cc, D, h0=None):
    """Exact sequential recurrence — oracle (small shapes only)."""
    B, S, H, P = x.shape
    N = Bc.shape[-1]
    Bh = _expand_groups(Bc, H).float()
    Ch = _expand_groups(Cc, H).float()
    dtf = dt.float()
    xf = x.float()
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0
    Af = A.float()
    ys = []
    for t in range(S):
        x_t, dt_t, B_t, C_t = xf[:, t], dtf[:, t], Bh[:, t], Ch[:, t]
        a = torch.exp(dt_t * Af)                            # (B,H)
        h = h * a[..., None, None] + torch.einsum(
            "bhn,bhp->bhpn", B_t * dt_t[..., None], x_t)
        ys.append(torch.einsum("bhpn,bhn->bhp", h, C_t))
    y = torch.stack(ys, dim=1) + xf * D.float()[None, None, :, None]
    return y.to(x.dtype), h


def ssd_decode_step(h, x_t, dt_t, A, B_t, C_t, D):
    """One-token recurrence. h: (B,H,P,N) f32; x_t: (B,H,P); dt_t: (B,H);
    B_t/C_t: (B,G,N). Returns (h', y (B,H,P))."""
    H = x_t.shape[1]
    B_t = _expand_groups(B_t, H).float()
    C_t = _expand_groups(C_t, H).float()
    dtf = dt_t.float()
    xf = x_t.float()
    a = torch.exp(dtf * A.float())
    h = h * a[..., None, None] + torch.einsum("bhn,bhp->bhpn",
                                              B_t * dtf[..., None], xf)
    y = torch.einsum("bhpn,bhn->bhp", h, C_t) + xf * \
        D.float()[None, :, None]
    return h, y.to(x_t.dtype)


# ------------------------------------------------------------------ conv1d
def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, *C); w: (*C, K); b: (*C,).
    ``w`` and ``b`` are cast to x's dtype before the sum, as in JAX."""
    K = w.shape[-1]
    S = x.shape[1]
    pad = torch.zeros((x.shape[0], K - 1) + tuple(x.shape[2:]),
                      dtype=x.dtype, device=x.device)
    xp = torch.cat([pad, x], dim=1)
    wx = w.to(x.dtype)
    y = xp[:, 0:S] * wx[..., 0]
    for k in range(1, K):
        y = y + xp[:, k:k + S] * wx[..., k]
    return y + b.to(x.dtype)


def causal_conv_step(state: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """state: (B, K-1, *C) last inputs; x_t: (B, *C). -> (state', y)."""
    full = torch.cat([state, x_t[:, None]], dim=1)          # (B, K, *C)
    wt = torch.movedim(w, -1, 0).to(x_t.dtype)              # (K, *C)
    y = torch.sum(full * wt[None], dim=1) + b.to(x_t.dtype)
    return full[:, 1:], y
