"""Plain reference of the dense decoder (Llama-style GQA; Yi-6B): RMSNorm,
rotary attention with grouped key/value heads, SwiGLU MLP, untied head.

It reads the sizes from the benchmark's configuration file (Hugging Face
key names) and the weights as a tree in the served layout: per-layer
leaves stacked on a leading layer dim, dense weights (d_in, d_out), head
projections (d, H, Dh), output projections (H, Dh, d), the vocabulary
padded to a multiple of 256. Everything is computed in float32.
"""
from __future__ import annotations

import torch

from .common import (causal_attention, matmul, normal_tree, rms_norm, rope,
                     swiglu_mlp)


def dims(c: dict) -> dict:
    d, H = c["hidden_size"], c["num_attention_heads"]
    return {"L": c["num_hidden_layers"], "d": d, "H": H,
            "KV": c["num_key_value_heads"], "Dh": c.get("head_dim", d // H),
            "F": c["intermediate_size"], "V": c["vocab_size"],
            "Vp": -(-c["vocab_size"] // 256) * 256,
            "eps": c["rms_norm_eps"], "theta": c["rope_theta"]}


def weight_spec(c: dict) -> dict:
    """{path: (shape, std)}; std None for the norms' ones."""
    m = dims(c)
    L, d, H, KV, Dh, F, Vp = (m[k] for k in ("L", "d", "H", "KV", "Dh", "F",
                                             "Vp"))
    return {
        "embed": ((Vp, d), 1.0),
        "blocks/attn_norm": ((L, d), None),
        "blocks/mlp_norm": ((L, d), None),
        "blocks/wq": ((L, d, H, Dh), d ** -0.5),
        "blocks/wk": ((L, d, KV, Dh), d ** -0.5),
        "blocks/wv": ((L, d, KV, Dh), d ** -0.5),
        "blocks/wo": ((L, H, Dh, d), (H * Dh) ** -0.5),
        "blocks/w_gate": ((L, d, F), d ** -0.5),
        "blocks/w_up": ((L, d, F), d ** -0.5),
        "blocks/w_down": ((L, F, d), F ** -0.5),
        "final_norm": ((d,), None),
        "lm_head": ((d, Vp), d ** -0.5),
    }


def init_weights(c: dict, generator: torch.Generator, device,
                 dtype: torch.dtype) -> dict:
    return normal_tree(weight_spec(c), generator, device, dtype)


def hidden(c: dict, w: dict, tokens: torch.Tensor,
           precision: str = "f32") -> torch.Tensor:
    """tokens (B, T) -> the final-normed hidden states (B, T, d)."""
    m = dims(c)
    B, T = tokens.shape
    H, KV, Dh, d = m["H"], m["KV"], m["Dh"], m["d"]
    pos = torch.arange(T, device=tokens.device)
    x = w["embed"][tokens].float()
    b = w["blocks"]
    for i in range(m["L"]):
        h = rms_norm(x, b["attn_norm"][i], m["eps"])
        q = matmul(h, b["wq"][i].reshape(d, H * Dh), precision)
        k = matmul(h, b["wk"][i].reshape(d, KV * Dh), precision)
        v = matmul(h, b["wv"][i].reshape(d, KV * Dh), precision)
        q = rope(q.view(B, T, H, Dh), pos, m["theta"])
        k = rope(k.view(B, T, KV, Dh), pos, m["theta"])
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.view(B, T, KV, Dh).repeat_interleave(H // KV, dim=2)
        o = causal_attention(q, k, v, Dh ** -0.5)
        x = x + matmul(o.reshape(B, T, H * Dh), b["wo"][i].reshape(H * Dh, d),
                       precision)
        h = rms_norm(x, b["mlp_norm"][i], m["eps"])
        x = x + swiglu_mlp(h, b["w_gate"][i], b["w_up"][i], b["w_down"][i],
                           precision)
    return rms_norm(x, w["final_norm"], m["eps"])


def logits(c: dict, w: dict, h: torch.Tensor,
           precision: str = "f32") -> torch.Tensor:
    """Hidden states (..., d) -> logits over the unpadded vocabulary."""
    return matmul(h, w["lm_head"][:, :dims(c)["V"]], precision)
