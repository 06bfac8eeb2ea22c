"""Plain reference of the decoder with multi-head latent attention
(MiniCPM3-4B, after DeepSeek-V2): the query through a low-rank
``q_lora_rank`` bottleneck, keys and values expanded from a
``kv_lora_rank`` latent, a rotary part of ``qk_rope_head_dim`` shared by
all heads, SwiGLU MLP, untied head.

Keys and values are expanded from the latent at every position (the
published, unabsorbed form); a served decode that attends in latent space
must agree with it. Departures from the published model, as the system
under test runs it: no ``scale_emb``, ``scale_depth`` or
``dim_model_base`` scaling and plain rotary angles (no LongRoPE factors).
Weights in the served layout (see ``dense.py``); float32 throughout.
"""
from __future__ import annotations

import torch

from .common import (causal_attention, matmul, normal_tree, rms_norm, rope,
                     swiglu_mlp)


def dims(c: dict) -> dict:
    return {"L": c["num_hidden_layers"], "d": c["hidden_size"],
            "H": c["num_attention_heads"], "qr": c["q_lora_rank"],
            "kr": c["kv_lora_rank"], "nope": c["qk_nope_head_dim"],
            "rope": c["qk_rope_head_dim"], "vh": c["v_head_dim"],
            "F": c["intermediate_size"], "V": c["vocab_size"],
            "Vp": -(-c["vocab_size"] // 256) * 256,
            "eps": c["rms_norm_eps"], "theta": c["rope_theta"]}


def weight_spec(c: dict) -> dict:
    m = dims(c)
    L, d, H, qr, kr, F, Vp = (m[k] for k in ("L", "d", "H", "qr", "kr", "F",
                                             "Vp"))
    nope, rp, vh = m["nope"], m["rope"], m["vh"]
    return {
        "embed": ((Vp, d), 1.0),
        "blocks/attn_norm": ((L, d), None),
        "blocks/mlp_norm": ((L, d), None),
        "blocks/wq_a": ((L, d, qr), d ** -0.5),
        "blocks/q_norm": ((L, qr), None),
        "blocks/wq_b": ((L, qr, H, nope + rp), qr ** -0.5),
        "blocks/wkv_a": ((L, d, kr + rp), d ** -0.5),
        "blocks/kv_norm": ((L, kr), None),
        "blocks/wkv_b": ((L, kr, H, nope + vh), kr ** -0.5),
        "blocks/wo": ((L, H, vh, d), (H * vh) ** -0.5),
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
    m = dims(c)
    B, T = tokens.shape
    d, H, qr, kr = m["d"], m["H"], m["qr"], m["kr"]
    nope, rp, vh = m["nope"], m["rope"], m["vh"]
    pos = torch.arange(T, device=tokens.device)
    x = w["embed"][tokens].float()
    b = w["blocks"]
    for i in range(m["L"]):
        h = rms_norm(x, b["attn_norm"][i], m["eps"])
        qa = rms_norm(matmul(h, b["wq_a"][i], precision), b["q_norm"][i],
                      m["eps"])
        q = matmul(qa, b["wq_b"][i].reshape(qr, H * (nope + rp)), precision)
        q = q.view(B, T, H, nope + rp)
        q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, m["theta"])],
                      dim=-1)
        kv_a = matmul(h, b["wkv_a"][i], precision)
        c_kv = rms_norm(kv_a[..., :kr], b["kv_norm"][i], m["eps"])
        k_rope = rope(kv_a[..., kr:], pos, m["theta"])           # (B, T, rope)
        kv = matmul(c_kv, b["wkv_b"][i].reshape(kr, H * (nope + vh)),
                    precision).view(B, T, H, nope + vh)
        k = torch.cat([kv[..., :nope],
                       k_rope[:, :, None].expand(B, T, H, rp)], dim=-1)
        o = causal_attention(q, k, kv[..., nope:], (nope + rp) ** -0.5)
        x = x + matmul(o.reshape(B, T, H * vh), b["wo"][i].reshape(H * vh, d),
                       precision)
        h = rms_norm(x, b["mlp_norm"][i], m["eps"])
        x = x + swiglu_mlp(h, b["w_gate"][i], b["w_up"][i], b["w_down"][i],
                           precision)
    return rms_norm(x, w["final_norm"], m["eps"])


def logits(c: dict, w: dict, h: torch.Tensor,
           precision: str = "f32") -> torch.Tensor:
    return matmul(h, w["lm_head"][:, :dims(c)["V"]], precision)
