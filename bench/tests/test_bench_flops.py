"""The operation counts against hand sums, the port's parameter count, and
torch's FLOP counter run over the plain reference: the last two for every
declared configuration, through its family's ``bench/flops`` module, at
full width and at the family's tiny widths."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench import spec
from bench.flops import dense, mla
from bench.tests.tiny import family

DECL = spec.declaration()
YI = spec.config(DECL, "yi-6b")
MINICPM = spec.config(DECL, "minicpm3-4b")
CONFIGS = [c["name"] for c in DECL["configs"]]


def test_yi_layer_products_by_hand():
    # q, k, v, o: 4096 x (32 + 4 + 4) x 128 and 32 x 128 x 4096; MLP 3 x
    # 4096 x 11008
    assert dense.layer_matrix_params(YI) == \
        4096 * 40 * 128 + 4096 * 4096 + 3 * 4096 * 11008 == 173_015_040


def test_minicpm_layer_products_by_hand():
    m = 2560 * 768 + 768 * 40 * 96 + 2560 * 288 + 256 * 40 * 128 \
        + 40 * 64 * 2560 + 3 * 2560 * 6400
    assert mla._shared(mla.dims(MINICPM)) + 256 * 40 * 128 == m


@pytest.mark.parametrize("name", CONFIGS)
def test_matrix_params_match_the_ports_count(name):
    """6 x the matrix params in train_flops: every parameter but the
    embedding table and the norms, with the unpadded head."""
    from bench.harness import port_config
    conf = spec.config(DECL, name)
    cfg = port_config(conf)
    ref, flops = spec.family(conf)
    norms = sum(int(torch.Size(s).numel())
                for s, std in ref.weight_spec(conf).values() if std is None)
    d, V, Vp = cfg.d_model, cfg.vocab, -(-cfg.vocab // 256) * 256
    matrix = cfg.param_count() - norms - 2 * d * V
    per_token = (flops.train_flops(conf, 1, 1) -
                 3 * _pair_ops(conf, flops)) / 6
    assert per_token == matrix + d * V
    assert Vp >= V


def _pair_ops(conf, flops):
    return conf["num_hidden_layers"] * flops.attention_pair_ops(conf)


def test_serve_flops_sum_prefill_and_decode_by_hand():
    c = dict(YI, num_hidden_layers=1)
    per_tok = 2 * dense.layer_matrix_params(c)
    pair = 4 * 128 * 32
    head = 2 * 4096 * 64000
    S, new = 10, 3
    want = S * per_tok + pair * S * (S + 1) / 2 + head
    want += sum(per_tok + head + pair * (S + i + 1) for i in range(new - 1))
    assert dense.serve_flops(c, 2, S, new) == 2 * want


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_equals_torchs_count_of_the_reference(name):
    """The reference computes every (query, key) pair and masks the later
    keys; the prefill's useful work is its count less the masked pairs."""
    conf = spec.config(DECL, name)
    conf = dict(conf, **family(conf["family"]))
    ref, flops = spec.family(conf)
    w = ref.init_weights(conf, torch.Generator().manual_seed(0), "cpu",
                         torch.float32)
    T = 5
    toks = torch.zeros((1, T), dtype=torch.long)
    with FlopCounterMode(display=False) as fc:
        ref.logits(conf, w, ref.hidden(conf, w, toks)[:, -1])
    masked = _pair_ops(conf, flops) * (T * T - T * (T + 1) // 2)
    assert fc.get_total_flops() == flops.serve_flops(conf, 1, T, 1) + masked


def test_train_flops_are_three_forwards():
    c = dict(YI, num_hidden_layers=2)
    S, B = 64, 3
    fwd = B * S * 2 * (2 * dense.layer_matrix_params(c) + 4096 * 64000)
    attn = 2 * dense.attention_pair_ops(c) * S * (S + 1) / 2 * B
    assert dense.train_flops(c, B, S) == 3 * (fwd + attn)
