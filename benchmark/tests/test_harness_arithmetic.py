"""The yardstick's arithmetic: the copied FLOP count agrees with the
program's own, and each bound formula with a case worked by hand."""

import os

import pytest

from bench_lib import bounds, flops
from bench_lib.peaks import peaks_for
from checkout import BENCH, load


def cfg(name):
    return load(os.path.join(BENCH, "configs", f"{name}.json"))


@pytest.mark.parametrize("name,vocab,B,L", [("cruller_base", 50265, 16, 1023),
                                            ("cruller_base", 50265, 32, 1023),
                                            ("donut_base", 57525, 2, 1535)])
def test_train_flops_match_the_programs_count(name, vocab, B, L):
    from pixparse_tpu_torch.framework.profiling import cruller_train_flops
    from pixparse_tpu_torch.models.config import get_model_config
    from pixparse_tpu_torch.models.cruller import resolve_cruller_cfgs

    enc, dec, _ = resolve_cruller_cfgs(get_model_config(name), vocab_size=vocab)
    assert flops.train_step_flops(cfg(name), B, L) == pytest.approx(
        cruller_train_flops(enc, dec, B, L), rel=1e-12)


def test_cruller_base_b16_is_18_77_tflop():
    assert flops.train_step_flops(cfg("cruller_base"), 16, 1023) / 1e12 == pytest.approx(18.77, abs=0.005)


def test_encoder_tokens():
    assert flops.encoder_tokens(cfg("cruller_base")["encoder"]) == 1009
    assert flops.encoder_tokens(cfg("donut_base")["encoder"]) == 4800


def test_eval_flops_by_hand():
    c = {"encoder": {"kind": "vit", "image_size": [32, 16], "patch_size": 16, "in_chans": 1,
                     "embed_dim": 2, "depth": 1, "num_heads": 1, "mlp_ratio": 1.0, "cls_token": True},
         "decoder": {"d_model": 2, "ffn_dim": 2, "vocab_size": 3, "layers": 1}}
    N = 3  # 2 patches + the class token
    # the program's convention counts the patch product over all N tokens
    enc = 2 * N * 256 * 2 + flops.transformer_layer_flops(N, 2, 2)
    cross_kv = 4 * N * 2 * 2
    # one prompt token, 2 new tokens: positions 1 and 2 run (the last token's step does not)
    per_pos = (12 * 4 + 4 * 4 + 4 * N * 2) + 2 * 2 * 3
    self_keys = 4 * 2 * (1 + 2)
    assert flops.eval_batch_flops(c, [1], 2) == pytest.approx(enc + cross_kv + 2 * per_pos + self_keys)


def test_visible_pairs_by_hand():
    assert bounds.visible_pairs(1, 3, 3, True)[0] == 6  # 1 + 2 + 3
    assert bounds.visible_pairs(2, 2, 4, False, [3, 1])[0] == 2 * 3 + 2 * 1
    assert bounds.visible_pairs(1, 2, 4, True)[0] == 3 + 4  # rows see keys up to i + 2


def test_bounds_by_hand():
    f, b = bounds.flash_fwd(1, 2, 2, 1, 4, False)
    assert f == 4 * 4 * 4 and b == 2 * 4 * (2 * 2 + 2 * 2) + 4 * 2
    f, b = bounds.flash_bwd(1, 2, 2, 1, 4, False)
    assert f == 10 * 4 * 4 and b == 2 * 4 * (3 * 2 + 2 * 2 + 2 * 2) + 8 * 2
    assert bounds.fused_ce_fwd(3, 5, 2) == (2 * 3 * 5 * 2, 2 * 2 * 8 + 36)
    assert bounds.fused_ce_bwd(3, 5, 2) == (6 * 3 * 5 * 2, 2 * 2 * 2 * 8 + 36)
    assert bounds.window_fwd(2, 4, 8, 2, 1) == (4 * 2 * 16 * 8, 4 * 2 * 2 * 4 * 8 + 4 * 2 * 16 + 4 * 16)
    assert bounds.window_bwd(2, 4, 8, 2) == (10 * 2 * 16 * 8, 7 * 2 * 2 * 4 * 8 + 8 * 2 * 16)
    assert bounds.decode_attention(2, 10, 2, 4, 128) == (4 * 8 * 10, 2 * (2 * 2 * 8 + 2 * 10 * 8) + 256)
    # an operation-bound and a byte-bound call
    assert bounds.seconds([(1e12, 1.0), (0.0, 2e9)], 1e12, 1e9) == pytest.approx(3.0)


def test_peaks_by_card_name():
    assert peaks_for("NVIDIA H100 80GB HBM3").bf16_flops == 989e12
    assert peaks_for("NVIDIA H100 PCIe").hbm_bytes == 2.0e12
    assert peaks_for("cpu") is None
