"""How the benchmark reaches the program under test, ``pixparse_tpu_torch``:
a tokenizer of the configuration's vocabulary, the registered task built
from the cell's parameters and loaded with the seeded weights, and the
kernel wrappers' launch counters. Imported by the drivers only."""

from __future__ import annotations

import os
import shutil
from typing import Dict

from bench_lib.env import CACHE_DIR

PROGRAM = "pixparse_tpu_torch"


def tokenizer_dir(cfg: Dict, extra_specials: bool) -> str:
    """A saved byte-level tokenizer whose height is the configuration's
    vocabulary: the 256 byte tokens, the pretraining special tokens (and the
    DocVQA tokens where the task adds them), then filler tokens, so that the
    task's own token replay adds nothing and the tied table has the
    published height. Made once per checkout at a fixed path."""
    from pixparse_tpu_torch.task.common import (
        DOCVQA_FINETUNE_TOKENS,
        SPECIAL_TOKENS_FROM_PRETRAIN,
        add_special_tokens,
    )
    from pixparse_tpu_torch.tokenizers import ByteLevelTokenizer

    vocab = cfg["decoder"]["vocab_size"]
    path = os.path.join(CACHE_DIR, "tokenizers", f"bytelevel-{vocab}-{int(extra_specials)}")
    if os.path.isdir(path):
        return path
    tok = ByteLevelTokenizer()
    add_special_tokens(tok, SPECIAL_TOKENS_FROM_PRETRAIN)
    if extra_specials:
        add_special_tokens(tok, DOCVQA_FINETUNE_TOKENS)
    tok.add_tokens([f"<filler_{i}>" for i in range(vocab - len(tok))])
    tmp = f"{path}.tmp{os.getpid()}"
    tok.save_pretrained(tmp)
    try:
        os.rename(tmp, path)
    except OSError:  # another run made it first
        shutil.rmtree(tmp, ignore_errors=True)
    return path


def make_task(cell, device: str, weights: Dict, dtype: str = "bfloat16"):
    """The cell's registered task (``params.task``) on ``device`` with the
    configuration's model, given ``weights`` as its checkpoint."""
    from pixparse_tpu_torch.device import DeviceEnv
    from pixparse_tpu_torch.framework.config import OptimizationCfg
    from pixparse_tpu_torch.task.task_factory import TASK_CLASS_REGISTRY, TaskFactory
    from pixparse_tpu_torch.tokenizers import TokenizerCfg

    p, cfg = cell.params, cell.cfg
    _, cfg_cls = TASK_CLASS_REGISTRY[p["task"]]
    kwargs = dict(model_name=cfg["program_model"],
                  tokenizer=TokenizerCfg(name=tokenizer_dir(cfg, p.get("docvqa_tokens", False))),
                  dtype=dtype, device=device)
    if "opt" in p:  # a train task
        kwargs.update(opt=OptimizationCfg(**p["opt"]), num_intervals=p["num_intervals"],
                      num_warmup_intervals=p["num_warmup_intervals"], remat=p.get("remat"))
    task, _ = TaskFactory.create_task(p["task"], cfg_cls(**kwargs), DeviceEnv.initialize(device))
    if task.vocab_size != cfg["decoder"]["vocab_size"]:
        raise ValueError(f"the task's vocabulary is {task.vocab_size}, the configuration's "
                         f"{cfg['decoder']['vocab_size']}")
    check_sizes(cfg, task.vit_cfg, task.bart_cfg)
    task.resume_state_dict = weights
    return task


def check_sizes(cfg: Dict, enc_cfg, dec_cfg) -> None:
    """The program's resolved model sizes are the configuration file's."""
    enc, dec = cfg["encoder"], cfg["decoder"]
    want = {
        "img_size": tuple(enc["image_size"]), "in_chans": enc["in_chans"],
        "patch_size": enc["patch_size"], "embed_dim": enc["embed_dim"],
        "mlp_ratio": enc["mlp_ratio"], "ln_eps": enc["ln_eps"],
    }
    if enc["kind"] == "swin":
        want.update(depths=tuple(enc["depths"]), num_heads=tuple(enc["num_heads"]),
                    window_size=enc["window_size"], final_norm=enc["final_norm"])
    else:
        want.update(depth=enc["depth"], num_heads=enc["num_heads"],
                    use_cls_token=enc["cls_token"])
    got = {k: getattr(enc_cfg, k) for k in want}
    want_dec = {
        "vocab_size": dec["vocab_size"], "d_model": dec["d_model"],
        "decoder_layers": dec["layers"], "decoder_attention_heads": dec["heads"],
        "decoder_ffn_dim": dec["ffn_dim"], "max_position_embeddings": dec["max_positions"],
        "pos_offset": dec["pos_offset"], "scale_embedding": dec["scale_embedding"],
        "layernorm_embedding": dec["layernorm_embedding"], "pre_norm": dec["pre_norm"],
        "add_final_layer_norm": dec["final_layer_norm"], "ln_eps": dec["ln_eps"],
        "dropout": dec["dropout"], "activation_dropout": dec["activation_dropout"],
        "pad_token_id": dec["pad_token_id"],
    }
    got_dec = {k: getattr(dec_cfg, k) for k in want_dec}
    bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    bad.update({k: (got_dec[k], v) for k, v in want_dec.items() if got_dec[k] != v})
    if bad:
        raise ValueError(f"the program's model differs from the configuration: {bad}")


def counters():
    """The kernel wrappers whose ``launches`` count their kernel launches."""
    from pixparse_tpu_torch.ops.decode_attention import decode_attention
    from pixparse_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd
    from pixparse_tpu_torch.ops.loss import fused_ce_bwd, fused_ce_fwd
    from pixparse_tpu_torch.ops.window_attention import window_attention, window_attention_bwd

    return {"flash_attention_fwd": flash_attention_fwd, "flash_attention_bwd": flash_attention_bwd,
            "fused_ce_fwd": fused_ce_fwd, "fused_ce_bwd": fused_ce_bwd,
            "window_attention": window_attention, "window_attention_bwd": window_attention_bwd,
            "decode_attention": decode_attention}


def read_counts() -> Dict[str, int]:
    return {k: int(getattr(fn, "launches", 0)) for k, fn in counters().items()}
