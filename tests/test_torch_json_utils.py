"""The port's JSON token protocol, tree edit distance and JSON-parse metrics
against the JAX package's, on seeded random nested objects (numpy
``RandomState``): ``json2token`` (sorted and unsorted keys, categorical
tokens, list separators), ``token2json`` (round trips, broken tags, tag-free
text, regex-metacharacter keys, categorical unwrapping), the Zhang-Shasha
``tree_edit_distance`` under the evaluator's costs, ``cal_acc``,
``cal_f1``, ``normalize_dict`` and ``flatten``. All pure Python: the
results must be EQUAL, not close.
"""

import numpy as np
import pytest

from pixparse_tpu.utils import json_utils as jax_json
from pixparse_tpu.utils import tree_edit as jax_tree
from pixparse_tpu_torch.task.common import CORD_FINETUNE_TOKENS, RVLCDIP_FINETUNE_TOKENS
from pixparse_tpu_torch.utils import json_utils, tree_edit

KEYS = ["menu", "nm", "price", "cnt", "sub", "total", "a.b", "x+y", "(q)", "k*", "[z]", "c|d",
        "dollar$", "a^b", "q?", "{n}", "back\\slash", "Upper", "num"]
LEAVES = ["latte", "5.00", "letter", "form", "sep", "handwritten", "", "  padded  ", "a<b",
          "x/y", "memo", "12", "Über", "new\nline"]
SPECIALS = ["<s>", "</s>", "<pad>", "<unk>"] + CORD_FINETUNE_TOKENS + RVLCDIP_FINETUNE_TOKENS
N_OBJECTS = 50  # per seed; four seeds: 200 objects


def _leaf(rng):
    r = rng.rand()
    if r < 0.7:
        return LEAVES[rng.randint(len(LEAVES))]
    if r < 0.85:
        return int(rng.randint(-5, 100))
    return round(float(rng.randn()), 3)


def _obj(rng, depth=0):
    r = rng.rand()
    if depth >= 3 or r < 0.3:
        return _leaf(rng)
    if r < 0.75:
        n = rng.randint(1, 4)
        keys = [KEYS[i] for i in rng.choice(len(KEYS), n, replace=False)]
        return {k: _obj(rng, depth + 1) for k in keys}
    n = rng.randint(1, 4)
    if rng.rand() < 0.5:
        return [_obj(rng, depth + 1) for _ in range(n)]
    return [_leaf(rng) for _ in range(n)]


def _objects(seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(N_OBJECTS):
        obj = _obj(rng)
        out.append(obj if isinstance(obj, dict) else {KEYS[rng.randint(len(KEYS))]: obj})
    return out


def _perturb(obj, rng):
    """A nearby object: some leaves changed, some keys dropped."""
    if isinstance(obj, dict):
        return {k: _perturb(v, rng) for k, v in obj.items() if rng.rand() > 0.15}
    if isinstance(obj, list):
        return [_perturb(v, rng) for v in obj if rng.rand() > 0.15]
    return _leaf(rng) if rng.rand() < 0.3 else obj


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("sort_json_key", [True, False])
def test_json2token_equal(seed, sort_json_key):
    for obj in _objects(seed):
        for specials, extra in ((SPECIALS, None), ([], ["<s_menu>"]), (SPECIALS, ["<letter/>"])):
            got = json_utils.json2token(obj, specials, extra, sort_json_key=sort_json_key)
            want = jax_json.json2token(obj, specials, extra, sort_json_key=sort_json_key)
            assert got == want, obj
        no_keys = dict(update_special_tokens_for_json_key=False, sort_json_key=sort_json_key)
        assert json_utils.json2token(obj, SPECIALS, **no_keys) == jax_json.json2token(
            obj, SPECIALS, **no_keys)


def _token_strings(seed):
    rng = np.random.RandomState(seed + 100)
    for obj in _objects(seed):
        text, _ = jax_json.json2token(obj, SPECIALS, sort_json_key=bool(rng.rand() < 0.5))
        yield text
        # a closing tag dropped: the parse skips the unmatched start tag
        closes = [i for i in range(len(text)) if text.startswith("</s_", i)]
        if closes:
            i = closes[rng.randint(len(closes))]
            yield text[:i] + text[text.index(">", i) + 1:]
        yield "<s_cord>" + text + "</s>"  # as a decode reads out
        yield text + "<sep/>" + text  # sibling dicts
        yield text.upper()  # tags matched case-insensitively
    yield "no tags at all"
    yield ""
    yield "<s_a.b>1</s_a.b><s_x+y>2<sep/>3</s_x+y><s_(q)><letter/></s_(q)>"


@pytest.mark.parametrize("seed", range(4))
def test_token2json_equal(seed):
    vocab = {t: i for i, t in enumerate(SPECIALS)}
    for text in _token_strings(seed):
        for added_vocab in (None, vocab):
            got = json_utils.token2json(text, added_vocab)
            want = jax_json.token2json(text, added_vocab)
            assert got == want, text


def _tree(mod, obj):
    ev = mod.JSONParseEvaluator()
    return ev.construct_tree_from_dict(ev.normalize_dict(obj)), ev


@pytest.mark.parametrize("seed", range(4))
def test_tree_edit_distance_equal(seed):
    rng = np.random.RandomState(seed + 200)
    objs = _objects(seed)
    for a, b in zip(objs, objs[1:] + [_perturb(objs[0], rng)]):
        ta, ev = _tree(json_utils, a)
        tb, _ = _tree(json_utils, b)
        ja, jev = _tree(jax_json, a)
        jb, _ = _tree(jax_json, b)
        costs = dict(insert_cost=ev.insert_and_remove_cost, remove_cost=ev.insert_and_remove_cost,
                     update_cost=ev.update_cost)
        jcosts = dict(insert_cost=jev.insert_and_remove_cost,
                      remove_cost=jev.insert_and_remove_cost, update_cost=jev.update_cost)
        got = tree_edit.tree_edit_distance(ta, tb, **costs)
        assert got == jax_tree.tree_edit_distance(ja, jb, **jcosts)
        # unit costs, and the distance to itself
        unit = dict(insert_cost=lambda n: 1, remove_cost=lambda n: 1,
                    update_cost=lambda x, y: int(x.label != y.label))
        assert tree_edit.tree_edit_distance(ta, tb, **unit) == jax_tree.tree_edit_distance(
            ja, jb, **unit)
        assert tree_edit.tree_edit_distance(ta, ta, **costs) == 0.0


def test_tree_edit_distance_known_values():
    """Small trees whose distances are known by hand."""
    T = tree_edit.TreeNode
    unit = dict(insert_cost=lambda n: 1, remove_cost=lambda n: 1,
                update_cost=lambda x, y: int(x.label != y.label))
    a = T("f").addkid(T("a").addkid(T("h")).addkid(T("c").addkid(T("b")))).addkid(T("e"))
    b = T("f").addkid(T("c").addkid(T("a").addkid(T("h")).addkid(T("b")))).addkid(T("e"))
    assert tree_edit.tree_edit_distance(a, b, **unit) == 2  # the classic example
    assert tree_edit.tree_edit_distance(T("x"), T("y"), **unit) == 1
    assert tree_edit.tree_edit_distance(T("x"), T("x").addkid(T("y")), **unit) == 1


@pytest.mark.parametrize("seed", range(4))
def test_cal_acc_cal_f1_normalize_flatten_equal(seed):
    rng = np.random.RandomState(seed + 300)
    ev, jev = json_utils.JSONParseEvaluator(), jax_json.JSONParseEvaluator()
    answers = _objects(seed)
    preds = [_perturb(a, rng) if rng.rand() < 0.8 else {} for a in answers]
    for p, a in zip(preds, answers):
        assert ev.cal_acc(p, a) == jev.cal_acc(p, a)
        assert ev.normalize_dict(a) == jev.normalize_dict(a)
        assert ev.flatten(ev.normalize_dict(a)) == jev.flatten(jev.normalize_dict(a))
    assert ev.cal_f1(preds, answers) == jev.cal_f1(preds, answers)
    assert ev.cal_acc(answers[0], answers[0]) == 1.0
    assert ev.cal_acc({}, {}) == jev.cal_acc({}, {}) == 1.0
