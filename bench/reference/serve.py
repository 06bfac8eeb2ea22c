"""The served-token check: the reference's logits over each sampled
request's prompt and served tokens, and the widest gap by which a served
token's logit lies below the reference's best at its position.

With ``control`` the tokens judged are not the served ones but, at each
position of the same prompts and served tokens, the one that the reference
computed in float8 puts first: the reading that a check must refuse.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .common import exact_f32


@torch.no_grad()
def widest_gap(family, c: dict, w: dict,
               requests: Sequence[Tuple[np.ndarray, np.ndarray]],
               device, control: bool = False) -> float:
    """requests: (prompt (S,), served tokens (n,)) pairs, greedy. Returns
    the widest gap over every served token of every request."""
    worst = 0.0
    with exact_f32():
        for prompt, served in requests:
            S, n = len(prompt), len(served)
            seq = np.concatenate([prompt, served[:-1]]).astype(np.int64)
            toks = torch.as_tensor(seq, device=device)[None]
            ref = family.logits(c, w, family.hidden(c, w, toks)[0, S - 1:])
            if control:
                h8 = family.hidden(c, w, toks, "fp8")[0, S - 1:]
                picked = family.logits(c, w, h8, "fp8").argmax(-1)
            else:
                picked = torch.as_tensor(served.astype(np.int64),
                                         device=device)
            if ref.shape[0] != n:
                raise ValueError(f"{ref.shape[0]} positions for {n} tokens")
            gap = ref.max(-1).values - ref.gather(-1, picked[:, None])[:, 0]
            worst = max(worst, float(gap.max()))
    return worst
