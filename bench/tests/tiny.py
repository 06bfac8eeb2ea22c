"""Tiny sizes of each cell, widths cut so that a run takes seconds on the
CPU, and a run at them with the chip check left out."""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_DENSE = {"num_hidden_layers": 2, "hidden_size": 64,
              "num_attention_heads": 4, "num_key_value_heads": 2,
              "head_dim": 16, "intermediate_size": 128, "vocab_size": 199}
TINY_MLA = {"num_hidden_layers": 2, "hidden_size": 64,
            "num_attention_heads": 4, "num_key_value_heads": 4,
            "q_lora_rank": 32, "kv_lora_rank": 16, "qk_nope_head_dim": 16,
            "qk_rope_head_dim": 8, "v_head_dim": 16, "intermediate_size": 128,
            "vocab_size": 199}
TINY_STORE = {"store": {"use_fingerprints": True, "chunk_bytes": 1024,
                        "async_write": False, "durability": "batch",
                        "follower_keep": 2}}
TINY_SERVE = {"clients": 4, "prompt_lengths": [8, 16, 24, 32],
              "new_tokens": 8, "check_requests": 16}
# Limits at these sizes: fewer tokens average less rounding away, so a
# sound run reads higher than at the cells' sizes (CPU runs: loss gap up
# to 4e-4, first gradient 5e-4, change 1e-3, served gap 0.01) and the
# float8 control above them (4e-3, 5e-3, 2e-3 and 0.08-0.14; half the
# batch 0.05, 0.07, 0.2).
TINY_SERVE_LIMITS = {"served_logit_gap": 0.04}
TINY = {
    "minicpm3-4b.deploy": {
        "config": {**TINY_MLA, **TINY_STORE},
        "traffic": {**TINY_SERVE, "update": {
            "leaves": ["blocks/wq_b", "blocks/wkv_b"], "rank": 4,
            "relative": 0.01, "embed_rows": 4}},
        "limits": TINY_SERVE_LIMITS},
    "yi-6b.serve": {"config": TINY_DENSE, "traffic": TINY_SERVE,
                    "limits": TINY_SERVE_LIMITS},
    "yi-6b.train": {"config": TINY_DENSE,
                    "traffic": {"batch": 4, "seq": 16},
                    "limits": {"loss_gap": 1.5e-3, "first_grad_norm_gap": 2e-3,
                               "weight_change_norm_gap": 0.05,
                               "weight_change_median_gap": 1e-3}},
}


def tiny_run(cell, seed=5, seconds=0.6, readings=()):
    """A run of ``cell`` at tiny sizes on the CPU, the chip check left out."""
    from bench.harness import run_cell
    return run_cell(cell, seed, seconds, False, "cpu", time.perf_counter(),
                    overrides=TINY[cell], readings=readings)
