"""Plain torch oracle for the flash attention kernel (GQA, causal, SWA): a
copy of ``repro/kernels/flash_attention/ref.py``. Scores in f32, masked
entries set to -1e30, the whole (S, S) score matrix at once."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, S, D); k: (B, KVH, S, D); v: (B, KVH, S, Dv) -> (B, Hq,
    S, Dv). A window below 1 masks every key: each row then averages all
    values uniformly (every score is -1e30), as in the reference."""
    B, Hq, S, D = q.shape
    KVH = k.shape[1]
    G = Hq // KVH
    scale = scale if scale is not None else D ** -0.5
    kk = torch.repeat_interleave(k, G, dim=1)
    vv = torch.repeat_interleave(v, G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, kk.float())
    pos = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= pos[:, None] - pos[None, :] < window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv.float()).to(q.dtype)
