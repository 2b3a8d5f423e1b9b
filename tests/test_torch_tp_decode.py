"""Tensor-parallel decoding (the mesh's ``model`` axis in eval and infer) on
the CPU, fp32: gloo process groups of 2 and 4 ranks in subprocesses (this
file is its own worker under ``__main__``), held against the port's
one-process run and the JAX package's eval task under a mesh of the same
shape (2 or 4 of the 8 virtual CPU devices), from the same weights (a JAX
init redrawn from a numpy seed, moved with ``cruller_state_dict_from_jax``).

Each decode case checks the ranks' tokens equal to each other, to the
process alone's and to JAX's:

- greedy, beam K=3 and the int8 head at ``cruller_test`` (the eval task
  cuts the model: 1 head a rank, the 262-entry vocabulary 131 / 131);
- ``cruller_swin_test`` (the Swin encoder cut at model 2);
- ``pix2struct_test`` at the model level with ragged real patches (the
  decode kernel's cross mask) and a 301-entry vocabulary (151 / 150);
- (1,1,4) with 4 heads (one a rank; 66 / 66 / 66 / 64 vocabulary rows);
- sampling: the ranks draw the process alone's tokens (same generator).

Also: every rank's caches hold ``H*Dh / model`` columns and the decode
attention runs at ``H / model`` heads; ``kv_cache_dtype='int8'`` still
raises; ``app.eval.eval`` merges one metric tree per model group (counts
not doubled); ``app.eval`` and ``app.infer`` at ``--task.mesh.model 2``
write the process alone's metrics and JSONL; ``--infer.continuous`` at
model 2 (a whole replica a rank) writes the process alone's JSONL.

The launches run in a thread while the parent computes the references;
every launch is waited for with a timeout.
"""

import json
import os
import sys
import threading
from datetime import timedelta

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_distributed import (  # noqa: E402
    GLOO_TIMEOUT_S,
    _eval_flags,
    _infer_flags,
    _pages,
    launch,
)

SCALES = {"kernel": 0.15, "bias": 0.05, "embedding": 0.5, "pos_embed": 0.1, "cls_token": 0.5}
B = 3  # pages a decode case
MAX_LENGTH = 12
# case: (model name, heads (None: the config's), task attributes, task cfg overrides)
CASES = {
    "greedy": ("cruller_test", None, {}, {}),
    "beam3": ("cruller_test", None, {"num_beams": 3}, {}),
    "int8_head": ("cruller_test", None, {}, {"lm_head_dtype": "int8"}),
    "swin": ("cruller_swin_test", None, {}, {}),
    "heads4": ("cruller_test", 4, {}, {}),  # at (1,1,4)
}
P2S_VOCAB = 301
P2S_SIZES = ((40, 80), (96, 64), (30, 30))  # pages of 8, 24 and 4 real patches
P2S_KW = dict(max_length=16, eos_token_id=2, pad_token_id=1)


# --------------------------------------------------------------------------
# shared by the workers and the references
# --------------------------------------------------------------------------

def eval_task(env, model_name, heads=None, weights=None, model_axis=True, **cfg_kw):
    """``cruller_eval_ocr`` at a test size, fp32, from ``weights``, set up
    (under a mesh with ``model > 1``: cut over it)."""
    import dataclasses

    from pixparse_tpu_torch.task.task_factory import TASK_CLASS_REGISTRY
    from pixparse_tpu_torch.tokenizers import TokenizerCfg

    cls, cfg_cls = TASK_CLASS_REGISTRY["cruller_eval_ocr"]
    task = cls(cfg_cls(model_name=model_name, tokenizer=TokenizerCfg(name="pixparse_bytelevel"),
                       device="cpu", **cfg_kw), env)
    if heads is not None:
        task.vit_cfg = dataclasses.replace(task.vit_cfg, num_heads=heads)
        task.bart_cfg = dataclasses.replace(task.bart_cfg, decoder_attention_heads=heads)
    task.resume_state_dict = dict(weights)
    task.setup(model_axis=model_axis)
    return task


def ocr_vocab():
    """The vocabulary of ``cruller_eval_ocr``'s byte-level tokenizer."""
    from pixparse_tpu_torch.device import DeviceEnv
    from pixparse_tpu_torch.task.task_factory import TASK_CLASS_REGISTRY
    from pixparse_tpu_torch.tokenizers import TokenizerCfg

    cls, cfg_cls = TASK_CLASS_REGISTRY["cruller_eval_ocr"]
    cfg = cfg_cls(model_name="cruller_test", tokenizer=TokenizerCfg(name="pixparse_bytelevel"),
                  device="cpu")
    return cls(cfg, DeviceEnv(torch.device("cpu"))).vocab_size


def p2s_model(weights, tp=None):
    """``pix2struct_test`` at ``P2S_VOCAB``, eval, from ``weights``; cut
    over ``tp`` when given."""
    from pixparse_tpu_torch.models.config import get_model_config
    from pixparse_tpu_torch.models.cruller import create_cruller, resolve_cruller_cfgs
    from pixparse_tpu_torch.models.interop import load_cruller_state_dict
    from pixparse_tpu_torch.parallel.tensor_parallel import parallelize

    v, b, _ = resolve_cruller_cfgs(get_model_config("pix2struct_test"), vocab_size=P2S_VOCAB)
    model = create_cruller(v, b)
    load_cruller_state_dict(model, weights)
    model.eval()
    if tp is not None:
        parallelize(model, tp)
    return model


def p2s_tokens(model, batch):
    from pixparse_tpu_torch.ops.generation import generate

    image = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.inference_mode():
        enc = model.encode(image)
    prompt = torch.zeros(len(P2S_SIZES), 1, dtype=torch.long)
    return generate(model, enc, prompt, encoder_pad_mask=image["mask"], **P2S_KW).tokens.numpy()


def sampled_tokens(task, images):
    """Tokens drawn by ``generate(sample=True)`` with its default generator."""
    from pixparse_tpu_torch.ops.generation import generate

    enc = task.encode_images(images)
    prompt = torch.from_numpy(task.prompt_ids(task.task_start_token, B)).long()
    return generate(task.model, enc, prompt, max_length=MAX_LENGTH, sample=True,
                    eos_token_id=task.tokenizer.eos_token_id,
                    pad_token_id=task.tokenizer.pad_token_id).tokens.numpy()


class DecodeCalls:
    """Records ``(num_heads, query width, valid keys of each row)`` of
    every decode attention call the cached decoder makes."""

    def __enter__(self):
        import pixparse_tpu_torch.models.bart as bart

        self.calls, self._plain = [], bart.decode_attention

        def recording(q, k, v, mask, num_heads):
            self.calls.append((num_heads, q.shape[-1], tuple(mask.sum(-1).tolist())))
            return self._plain(q, k, v, mask, num_heads=num_heads)

        bart.decode_attention = recording
        return self

    def __exit__(self, *exc):
        import pixparse_tpu_torch.models.bart as bart

        bart.decode_attention = self._plain


# --------------------------------------------------------------------------
# workers
# --------------------------------------------------------------------------

def _save(out_dir, name, obj):
    import torch.distributed as dist

    if dist.get_rank() == 0:
        torch.save(obj, os.path.join(out_dir, f"{name}.pt"))


def _decode_case(out_dir, env, inputs, name):
    model_name, heads, attrs, cfg_kw = CASES[name]
    task = eval_task(env, model_name, heads, inputs["weights"][model_name], **cfg_kw)
    for k, v in attrs.items():
        setattr(task, k, v)
    images = inputs["images"][model_name]
    with DecodeCalls() as rec:
        tokens = task.generate_ids(images, task.prompt_ids(task.task_start_token, B), MAX_LENGTH)
    _save(out_dir, name, {"tokens": env.all_gather_object(tokens), "calls": rec.calls})
    return task


def _cache_widths(task, images):
    """Every layer's self and cross cache widths after a prefill."""
    from pixparse_tpu_torch.models.bart import KVCache

    pad = task.tokenizer.pad_token_id
    prompt = torch.from_numpy(task.prompt_ids(task.task_start_token, B)).long()
    buffer = torch.full((B, MAX_LENGTH), pad)
    buffer[:, :prompt.shape[1]] = prompt
    cache = KVCache(max_len=MAX_LENGTH)
    with torch.inference_mode():
        task.model.decode(prompt, task.encode_images(images), cache, key_pad_mask=buffer != pad,
                          mode="prefill")
    return {kind: [tuple(c.shape) for c in getattr(cache, kind)]
            for kind in ("self_k", "self_v", "cross_k", "cross_v")}


def _worker(mode, out_dir):
    import torch.distributed as dist

    from pixparse_tpu_torch.parallel.mesh import MeshEnv, tp_group

    dist.init_process_group("gloo", timeout=timedelta(seconds=GLOO_TIMEOUT_S))
    torch.set_num_threads(2)
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    env = MeshEnv.initialize(model=dist.get_world_size(), device="cpu")
    if mode == "tp4":
        _decode_case(out_dir, env, inputs, "heads4")
    else:
        for name in ("beam3", "int8_head", "swin"):
            _decode_case(out_dir, env, inputs, name)
        task = _decode_case(out_dir, env, inputs, "greedy")
        images = inputs["images"]["cruller_test"]
        _save(out_dir, "widths", {"widths": env.all_gather_object(_cache_widths(task, images))})
        _save(out_dir, "sample", {"tokens": env.all_gather_object(sampled_tokens(task, images))})
        with DecodeCalls() as rec:
            tokens = p2s_tokens(p2s_model(inputs["weights"]["pix2struct"], tp_group(env.mesh)),
                                inputs["p2s_batch"])
        _save(out_dir, "pix2struct", {"tokens": env.all_gather_object(tokens), "calls": rec.calls})
        _int8_refusal(out_dir, env)
        _one_tree_per_group(out_dir, env)
        _continuous_infer(out_dir, env, inputs)
    rank = dist.get_rank()
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank}: OK", flush=True)


def _int8_refusal(out_dir, env):
    try:
        eval_task(env, "cruller_test", kv_cache_dtype="int8", weights={})
        raised = ""
    except ValueError as e:
        raised = str(e)
    _save(out_dir, "int8", {"raised": raised})


def _one_tree_per_group(out_dir, env):
    """``app.eval.eval`` at model 2: each rank's tree holds a count and a
    rank-independent ratio (the ranks of a group saw the same pages)."""
    import pixparse_tpu_torch.app.eval as eval_app

    plain = eval_app.evaluate
    eval_app.evaluate = lambda task, loaders: {"eval": {"num_samples": 3, "cer": 0.25}}
    try:
        cfg = eval_app.EvalCfg(metrics_file_path=os.path.join(out_dir, "merged.json"))
        merged = eval_app.eval(cfg, type("Task", (), {"device_env": env})(), {})
    finally:
        eval_app.evaluate = plain
    _save(out_dir, "merged", {"merged": merged, "model_ranks": env.all_gather_object(
        env.model_rank)})


def _continuous_infer(out_dir, env, inputs):
    """``app.infer``'s body (the process group already joined) with
    ``--infer.continuous true --task.mesh.model 2``."""
    from pixparse_tpu_torch.app.infer import _infer, parse_args

    infer_cfg, task_cfg = parse_args(_infer_flags(
        inputs["pages"], inputs["ckpt"], os.path.join(out_dir, "continuous.jsonl"))
        + ["--infer.continuous", "true", "--task.mesh.model", "2"])
    _infer(infer_cfg, task_cfg, env)


# --------------------------------------------------------------------------
# the references and the runs, made once
# --------------------------------------------------------------------------

def _redraw(params, seed=0):
    import jax
    from flax import linen as nn

    rng = np.random.RandomState(seed)

    def one(path, x):
        std = SCALES.get(str(getattr(path[-1], "key", path[-1])))
        x = np.asarray(x, np.float32)
        return rng.normal(0.0, std, x.shape).astype(np.float32) if std else x

    return jax.tree_util.tree_map_with_path(one, nn.unbox(params))


def _cruller_weights(model_name, vocab):
    """A JAX Cruller init at ``model_name``, redrawn, in the port's names."""
    import jax
    import jax.numpy as jnp

    from pixparse_tpu.models import Cruller as JaxCruller
    from pixparse_tpu.models import get_model_config as jax_model_config
    from pixparse_tpu.models import resolve_cruller_cfgs as jax_resolve
    from pixparse_tpu_torch.models.config import get_model_config
    from pixparse_tpu_torch.models.cruller import resolve_cruller_cfgs
    from pixparse_tpu_torch.models.interop import cruller_state_dict_from_jax

    jv, jb, _ = jax_resolve(jax_model_config(model_name), vocab_size=vocab)
    params = JaxCruller(jv, jb).init(jax.random.PRNGKey(0),
                                     jnp.zeros((1, *jv.img_size, jv.in_chans)),
                                     jnp.zeros((1, 4), jnp.int32))["params"]
    v, b, _ = resolve_cruller_cfgs(get_model_config(model_name), vocab_size=vocab)
    return cruller_state_dict_from_jax(_redraw(params), v, b)


def _p2s_inputs():
    """The JAX pix2struct model, its redrawn params, the port's weights and
    a batch of pages with ragged real patches."""
    import jax
    import jax.numpy as jnp

    from pixparse_tpu.models import get_model_config as jax_model_config
    from pixparse_tpu.models import resolve_cruller_cfgs as jax_resolve
    from pixparse_tpu.models.pix2struct import Pix2StructCruller as JaxP2S
    from pixparse_tpu_torch.models.config import get_model_config
    from pixparse_tpu_torch.models.cruller import resolve_cruller_cfgs
    from pixparse_tpu_torch.models.interop import cruller_state_dict_from_jax
    from pixparse_tpu_torch.ops.pix2struct import patchify_variable

    jv, jb, _ = jax_resolve(jax_model_config("pix2struct_test"), vocab_size=P2S_VOCAB)
    rng = np.random.RandomState(1)
    out = [patchify_variable(rng.randint(0, 255, hw, np.uint8), 16, jv.max_patches)
           for hw in P2S_SIZES]
    batch = {k: np.stack([o[k] for o in out]) for k in out[0]}
    jm = JaxP2S(jv, jb)
    image = {k: jnp.asarray(v) for k, v in batch.items()}
    text = jnp.zeros((len(P2S_SIZES), 4), jnp.int32)
    params = _redraw(jm.init(jax.random.PRNGKey(0), image, text)["params"])
    v, b, _ = resolve_cruller_cfgs(get_model_config("pix2struct_test"), vocab_size=P2S_VOCAB)
    return jm, params, cruller_state_dict_from_jax(params, v, b), batch


def _jax_env(model):
    import jax

    from pixparse_tpu.parallel.mesh import MeshEnv as JaxMeshEnv

    return JaxMeshEnv.initialize(data=1, fsdp=1, model=model, devices=jax.devices()[:model])


def _jax_eval_tokens(name, inputs):
    """The JAX eval task's ``generate_ids`` under a (1,1,model) mesh."""
    import dataclasses

    from pixparse_tpu.task import TASK_CLASS_REGISTRY as JAX_REGISTRY
    from pixparse_tpu.tokenizers import TokenizerCfg as JaxTokCfg

    model_name, heads, attrs, cfg_kw = CASES[name]
    cls, cfg_cls = JAX_REGISTRY["cruller_eval_ocr"]
    task = cls(cfg_cls(model_name=model_name, tokenizer=JaxTokCfg(name="pixparse_bytelevel"),
                       **cfg_kw), _jax_env(4 if name == "heads4" else 2), None)
    if heads is not None:
        task.vit_cfg = dataclasses.replace(task.vit_cfg, num_heads=heads)
        task.bart_cfg = dataclasses.replace(task.bart_cfg, decoder_attention_heads=heads)
    task.resume_state_dict = dict(inputs["weights"][model_name])
    task.setup()
    for k, v in attrs.items():
        setattr(task, k, v)
    return task.generate_ids(inputs["images"][model_name],
                             task.prompt_ids(task.task_start_token, B), MAX_LENGTH)


def _jax_p2s_tokens(jm, params, batch):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pixparse_tpu.ops.generation import generate as jax_generate

    mesh = _jax_env(2).mesh
    whole = NamedSharding(mesh, P())
    with mesh:
        params = jax.device_put(params, whole)
        image = {k: jax.device_put(jnp.asarray(v), whole) for k, v in batch.items()}
        enc = jm.apply({"params": params}, image, method="encode")
        prompt = jax.device_put(jnp.zeros((len(P2S_SIZES), 1), jnp.int32), whole)
        out = jax_generate(jm, params, enc, prompt, encoder_pad_mask=image["mask"], **P2S_KW)
    return np.asarray(out.tokens)


def _launches(d, inputs):
    """The four launches, in order; their outputs (or the exception)."""
    out = {}
    try:
        out["tp2"] = launch(2, ["tp2", d], script=__file__)
        out["tp4"] = launch(4, ["tp4", d], script=__file__)
        out["eval"] = launch(2, ["pixparse_tpu_torch.app.eval", *_eval_flags(
            inputs["shard"], inputs["ckpt"], os.path.join(d, "eval_tp"), 8),
            "--task.mesh.model", "2"], module=True)
        out["infer"] = launch(2, ["pixparse_tpu_torch.app.infer", *_infer_flags(
            inputs["pages"], inputs["ckpt"], os.path.join(d, "infer_tp", "ocr.jsonl")),
            "--task.mesh.model", "2"], module=True)
    except BaseException as e:  # noqa: BLE001 -- re-raised by the fixture
        out["error"] = e
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs; the launches (in a thread) beside the one-process port
    runs and the JAX references."""
    from test_torch_train_cli import _make_shard

    from pixparse_tpu_torch.app.eval import main as eval_main
    from pixparse_tpu_torch.app.infer import main as infer_main
    from pixparse_tpu_torch.device import DeviceEnv

    d = str(tmp_path_factory.mktemp("tp_decode"))
    alone = DeviceEnv(torch.device("cpu"))
    vocab = ocr_vocab()
    jm, p2s_params, p2s_weights, p2s_batch = _p2s_inputs()
    inputs = {"weights": {m: _cruller_weights(m, vocab) for m in ("cruller_test",
                                                                   "cruller_swin_test")},
              "p2s_batch": p2s_batch}
    inputs["weights"]["pix2struct"] = p2s_weights
    rng = np.random.RandomState(4)
    inputs["images"] = {m: rng.randn(B, *size, 1).astype(np.float32)
                        for m, size in (("cruller_test", (64, 48)),
                                        ("cruller_swin_test", (64, 64)))}
    inputs["ckpt"] = os.path.join(d, "weights.pt")
    torch.save(inputs["weights"]["cruller_test"], inputs["ckpt"])
    inputs["pages"] = _pages(os.path.join(d, "pages"))
    inputs["shard"] = os.path.join(d, "eval.tar")
    _make_shard(inputs["shard"], 8, seed=10)
    torch.save(inputs, os.path.join(d, "inputs.pt"))

    launched = {}
    thread = threading.Thread(target=lambda: launched.update(_launches(d, inputs)))
    thread.start()
    try:
        refs = {}
        for name, (model_name, heads, attrs, cfg_kw) in CASES.items():
            task = eval_task(alone, model_name, heads, inputs["weights"][model_name], **cfg_kw)
            for k, v in attrs.items():
                setattr(task, k, v)
            images = inputs["images"][model_name]
            refs[name] = {"alone": task.generate_ids(
                images, task.prompt_ids(task.task_start_token, B), MAX_LENGTH),
                "jax": _jax_eval_tokens(name, inputs)}
            if name == "greedy":
                refs["sample"] = {"alone": sampled_tokens(task, images)}
                refs["widths"] = _cache_widths(task, images)
        refs["pix2struct"] = {"alone": p2s_tokens(p2s_model(p2s_weights), p2s_batch),
                              "jax": _jax_p2s_tokens(jm, p2s_params, p2s_batch)}
        assert eval_main(_eval_flags(inputs["shard"], inputs["ckpt"],
                                     os.path.join(d, "eval_alone"), 8)) == 0
        for mode, extra in (("batched", []), ("continuous", ["--infer.continuous", "true"])):
            assert infer_main(_infer_flags(inputs["pages"], inputs["ckpt"],
                                           os.path.join(d, f"{mode}_alone.jsonl")) + extra) == 0
    finally:
        thread.join()
    if "error" in launched:
        raise launched["error"]
    return dict(dir=d, refs=refs, inputs=inputs, outputs=launched)


def load(runs, name):
    return torch.load(os.path.join(runs["dir"], f"{name}.pt"), weights_only=False)


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES) + ["pix2struct"])
def test_tp_tokens_equal_across_ranks_alone_and_jax(runs, name):
    got, ref = load(runs, name), runs["refs"][name]
    ranks = got["tokens"]
    assert len(ranks) == (4 if name == "heads4" else 2)
    for r, tokens in enumerate(ranks):
        np.testing.assert_array_equal(tokens, ranks[0], err_msg=f"rank {r}")
    np.testing.assert_array_equal(ranks[0], ref["alone"])
    np.testing.assert_array_equal(ranks[0], ref["jax"])
    assert len(np.unique(ranks[0])) > 3  # varied tokens, not one repeated id
    # the decode attention ran at the rank's heads (1 of 2, 1 of 4)
    heads = {c[0] for c in got["calls"]}
    assert got["calls"] and heads == {1}, heads


def test_tp_sampling_draws_the_process_alone_tokens_on_every_rank(runs):
    ranks = load(runs, "sample")["tokens"]
    np.testing.assert_array_equal(ranks[0], ranks[1])
    np.testing.assert_array_equal(ranks[0], runs["refs"]["sample"]["alone"])
    # not the greedy tokens: the draws are live
    assert not np.array_equal(ranks[0], runs["refs"]["greedy"]["alone"])


def test_rank_caches_hold_the_rank_heads(runs):
    want = runs["refs"]["widths"]  # the process alone: H*Dh = 64 columns
    assert {s[-1] for kind in want.values() for s in kind} == {64}
    for r, widths in enumerate(load(runs, "widths")["widths"]):
        assert widths.keys() == want.keys()
        for kind, shapes in widths.items():
            assert [s[:-1] + (s[-1] * 2,) for s in shapes] == want[kind], (r, kind)
    # pix2struct: the cross attention's decode steps at 1 head of 2 over each
    # page's real patches only
    real = tuple(runs["inputs"]["p2s_batch"]["mask"].sum(-1).tolist())
    assert len(set(real)) == 3, real  # ragged
    calls = load(runs, "pix2struct")["calls"]
    assert any(c[2] == real for c in calls) and {c[:2] for c in calls} == {(1, 32)}


def test_int8_caches_still_refuse_a_model_axis(runs):
    assert "does not support a model-parallel" in load(runs, "int8")["raised"]


def test_eval_merges_one_tree_per_model_group(runs):
    got = load(runs, "merged")
    assert got["model_ranks"] == [0, 1]
    assert got["merged"] == {"eval": {"num_samples": 3, "cer": 0.25}}  # not 6


def test_eval_app_at_model_two_writes_the_process_alone_metrics(runs):
    from pixparse_tpu_torch.app.eval import metrics_file_name

    name = metrics_file_name(runs["inputs"]["ckpt"], "FUNSD")
    files = {}
    for tag in ("eval_tp", "eval_alone"):
        with open(os.path.join(runs["dir"], tag, name)) as fh:
            files[tag] = json.load(fh)
    assert sorted(os.listdir(os.path.join(runs["dir"], "eval_tp"))) == sorted([name, "out.log"])
    assert files["eval_tp"] == files["eval_alone"]
    assert set(files["eval_tp"]["eval"]["average"]) == {"cer", "wer"}
    with open(os.path.join(runs["dir"], "eval_tp", "out.log")) as fh:
        assert "mesh=MeshCfg(data=0, fsdp=1, model=2)" in fh.read()


def test_infer_app_at_model_two_writes_the_process_alone_jsonl(runs):
    with open(os.path.join(runs["dir"], "batched_alone.jsonl")) as fh:
        want = fh.read()
    assert os.listdir(os.path.join(runs["dir"], "infer_tp")) == ["ocr.jsonl"]
    with open(os.path.join(runs["dir"], "infer_tp", "ocr.jsonl")) as fh:
        got = fh.read()
    assert got == want
    assert any(json.loads(line)["text"] for line in got.splitlines())


def test_continuous_infer_at_model_two_equals_one_process(runs):
    with open(os.path.join(runs["dir"], "continuous_alone.jsonl")) as fh:
        want = fh.read()
    with open(os.path.join(runs["dir"], "continuous.jsonl")) as fh:
        assert fh.read() == want
    assert len(want.splitlines()) == 5


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
