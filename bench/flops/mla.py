"""Operations of the latent-attention decoder's useful work, from its
sizes (counting rules as in ``dense.py``).

Prefill expands keys and values from the latent (Dqk = nope + rope,
Dv = v_head_dim a pair). Decode attends in latent space, as the served
decode does: the query is absorbed into the latent (H nope kr), each
cached position costs H (kr + rope) for its score and H kr for its value,
and the latent output is expanded by H kr vh.
"""
from __future__ import annotations

from ..reference.mla import dims


def _shared(m: dict) -> int:
    """Products that prefill and decode share, per token and layer."""
    d, H, qr, kr = m["d"], m["H"], m["qr"], m["kr"]
    return (d * qr + qr * H * (m["nope"] + m["rope"]) + d * (kr + m["rope"])
            + H * m["vh"] * d + 3 * d * m["F"])


def serve_flops(c: dict, batch: int, prompt: int, new: int) -> float:
    m = dims(c)
    L, H, kr = m["L"], m["H"], m["kr"]
    head = 2 * m["d"] * m["V"]
    pre_tok = 2 * L * (_shared(m) + kr * H * (m["nope"] + m["vh"]))
    pair = 2 * H * (m["nope"] + m["rope"] + m["vh"])
    pre = prompt * pre_tok + L * pair * prompt * (prompt + 1) / 2 + head
    dec_tok = 2 * L * (_shared(m) + H * m["nope"] * kr + H * kr * m["vh"])
    dec = 0.0
    for i in range(new - 1):
        ctx = prompt + i + 1
        dec += dec_tok + head + L * 2 * H * (2 * kr + m["rope"]) * ctx
    return batch * (pre + dec)


def train_flops(c: dict, batch: int, seq: int) -> float:
    m = dims(c)
    H, kr = m["H"], m["kr"]
    layer = _shared(m) + kr * H * (m["nope"] + m["vh"])
    matrix = m["L"] * layer + m["d"] * m["V"]
    pair = 2 * H * (m["nope"] + m["rope"] + m["vh"])
    attn = 3 * m["L"] * pair * seq * (seq + 1) / 2 * batch
    return 6.0 * matrix * batch * seq + attn
