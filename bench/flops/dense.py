"""Operations of the dense decoder's useful work, from its sizes.

A product of (m, k) by (k, n) is 2 m k n operations. Attention counts
only the unmasked causal (query, key) pairs: 2 (Dqk + Dv) a pair and head.
The head's product counts over the unpadded vocabulary and only where a
token is produced. Recomputation (rematerialisation, a loss chunk
recomputed in backward) and the discarded last decode step are not
useful work and are not counted.
"""
from __future__ import annotations

from ..reference.dense import dims


def layer_matrix_params(c: dict) -> int:
    m = dims(c)
    d, H, KV, Dh, F = m["d"], m["H"], m["KV"], m["Dh"], m["F"]
    return d * (H + 2 * KV) * Dh + H * Dh * d + 3 * d * F


def attention_pair_ops(c: dict) -> int:
    """Operations of one (query, key) pair over all heads of a layer."""
    m = dims(c)
    return 2 * 2 * m["Dh"] * m["H"]


def serve_flops(c: dict, batch: int, prompt: int, new: int) -> float:
    """Prefill of ``prompt`` tokens and ``new - 1`` decode steps (the
    first new token comes from the prefill's logits), for ``batch``
    sequences."""
    m = dims(c)
    L, head = m["L"], 2 * m["d"] * m["V"]
    per_token = 2 * L * layer_matrix_params(c)
    pairs = prompt * (prompt + 1) / 2
    pre = prompt * per_token + L * attention_pair_ops(c) * pairs + head
    dec = 0.0
    for i in range(new - 1):
        ctx = prompt + i + 1
        dec += per_token + head + L * attention_pair_ops(c) * ctx
    return batch * (pre + dec)


def train_flops(c: dict, batch: int, seq: int) -> float:
    """6 x matrix params (head included) x tokens, and the causal
    attention products three times (forward, and two products each way
    in backward)."""
    m = dims(c)
    matrix = m["L"] * layer_matrix_params(c) + m["d"] * m["V"]
    pairs = seq * (seq + 1) / 2
    attn = 3 * m["L"] * attention_pair_ops(c) * pairs * batch
    return 6.0 * matrix * batch * seq + attn
