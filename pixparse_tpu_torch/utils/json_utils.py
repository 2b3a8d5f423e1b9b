"""JSON <-> token-sequence protocol and JSON-parse evaluation (the port's
own copy of :mod:`pixparse_tpu.utils.json_utils`; pure Python).

- :func:`json2token`: serialize a (possibly nested) JSON object to the Donut
  token protocol: dict keys become ``<s_key>...</s_key>`` wrappers (keys
  reverse-sorted by default), lists are ``<sep/>``-joined, leaf values whose
  ``<value/>`` form is a known special token are emitted as that token.
  Returns the string plus the sorted set of key tokens discovered.
- :func:`token2json`: inverse parse back into dicts/lists.
- :class:`JSONParseEvaluator`: Donut-style nTED accuracy and field micro-F1
  over :mod:`pixparse_tpu_torch.utils.tree_edit`.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Union

from pixparse_tpu_torch.utils.metrics import _edit_distance
from pixparse_tpu_torch.utils.tree_edit import TreeNode, tree_edit_distance


def json2token(
    obj: Any,
    tokenizer_all_special_tokens: List[str],
    additional_special_tokens: List[str] | None = None,
    update_special_tokens_for_json_key: bool = True,
    sort_json_key: bool = True,
):
    """Convert a JSON object into the token-sequence protocol.

    Returns ``(text, discovered_special_tokens)`` where the token list is the
    sorted set of ``<s_key>``/``</s_key>`` tokens encountered (when
    ``update_special_tokens_for_json_key``).
    """
    discovered: set = set(additional_special_tokens or ())
    known = set(tokenizer_all_special_tokens)

    def _convert(node: Any) -> str:
        if isinstance(node, dict):
            if len(node) == 1 and "text_sequence" in node:
                return node["text_sequence"]
            keys = sorted(node.keys(), reverse=True) if sort_json_key else list(node.keys())
            parts = []
            for k in keys:
                if update_special_tokens_for_json_key:
                    discovered.add(f"<s_{k}>")
                    discovered.add(f"</s_{k}>")
                parts.append(f"<s_{k}>{_convert(node[k])}</s_{k}>")
            return "".join(parts)
        if isinstance(node, list):
            return r"<sep/>".join(_convert(item) for item in node)
        leaf = str(node)
        token_form = f"<{leaf}/>"
        if token_form in known or token_form in discovered:
            return token_form  # categorical special token
        return leaf

    text = _convert(obj)
    return text, sorted(discovered)


def token2json(tokens: str, added_vocab: Dict[str, int] | None = None, is_inner_value: bool = False):
    """Parse a token-protocol string back into JSON (dicts / lists / strings).

    Mirrors the reference parse loop semantics exactly: case-insensitive tag
    matching, ``<sep/>`` list splitting after a closing tag producing sibling
    dicts, categorical ``<x/>`` leaves unwrapped when present in
    ``added_vocab``, and the ``{"text_sequence": ...}`` fallback for tag-free
    input at the top level.
    """
    added_vocab = added_vocab or {}
    output: Dict[str, Any] = {}

    while tokens:
        start_match = re.search(r"<s_(.*?)>", tokens, re.IGNORECASE)
        if start_match is None:
            break
        key = start_match.group(1)
        end_match = re.search(rf"</s_{re.escape(key)}>", tokens, re.IGNORECASE)
        start_tag = start_match.group()
        if end_match is None:
            tokens = tokens.replace(start_tag, "")
            continue
        end_tag = end_match.group()
        content_match = re.search(
            f"{re.escape(start_tag)}(.*?){re.escape(end_tag)}", tokens, re.IGNORECASE
        )
        if content_match is not None:
            content = content_match.group(1).strip()
            if r"<s_" in content and r"</s_" in content:  # non-leaf node
                value = token2json(content, added_vocab, True)
                if value:
                    if len(value) == 1:
                        value = value[0]
                    output[key] = value
            else:  # leaf node(s)
                leaves = []
                for leaf in content.split(r"<sep/>"):
                    leaf = leaf.strip()
                    if leaf in added_vocab and leaf.startswith("<") and leaf.endswith("/>"):
                        leaf = leaf[1:-2]  # unwrap categorical special token
                    leaves.append(leaf)
                output[key] = leaves if len(leaves) != 1 else leaves[0]
        tokens = tokens[tokens.find(end_tag) + len(end_tag):].strip()
        if tokens.startswith(r"<sep/>"):  # sibling dict follows
            sibling = token2json(tokens[6:], added_vocab, True)
            return [output] + (sibling if isinstance(sibling, list) else [sibling])

    if output:
        return [output] if is_inner_value else output
    return [] if is_inner_value else {"text_sequence": tokens}


class JSONParseEvaluator:
    """nTED accuracy and field micro-F1 for JSON predictions (Donut protocol).

    The tree-edit distance is the Zhang-Shasha DP of
    :mod:`pixparse_tpu_torch.utils.tree_edit`.
    """

    @staticmethod
    def flatten(data: dict) -> List[tuple]:
        """Flatten nested JSON into dotted (key, leaf-value) pairs."""
        out: List[tuple] = []

        def _flatten(value, key=""):
            if isinstance(value, dict):
                for child_key, child_value in value.items():
                    _flatten(child_value, f"{key}.{child_key}" if key else child_key)
            elif isinstance(value, list):
                for item in value:
                    _flatten(item, key)
            else:
                out.append((key, value))

        _flatten(data)
        return out

    @staticmethod
    def update_cost(node1: TreeNode, node2: TreeNode) -> float:
        """Leaf-leaf: string edit distance ignoring the '<leaf>' marker;
        leaf-internal: 1 + leaf string length; internal-internal: 0/1 label match."""
        label1, label2 = node1.label, node2.label
        leaf1 = "<leaf>" in label1
        leaf2 = "<leaf>" in label2
        if leaf1 and leaf2:
            return _edit_distance(
                label1.replace("<leaf>", ""), label2.replace("<leaf>", "")
            )
        if leaf2 and not leaf1:
            return 1 + len(label2.replace("<leaf>", ""))
        if leaf1 and not leaf2:
            return 1 + len(label1.replace("<leaf>", ""))
        return int(label1 != label2)

    @staticmethod
    def insert_and_remove_cost(node: TreeNode) -> float:
        label = node.label
        if "<leaf>" in label:
            return len(label.replace("<leaf>", ""))
        return 1

    def normalize_dict(self, data: Union[Dict, List, Any]):
        """Canonicalize: sort dict keys by (len, key), wrap scalars in lists,
        drop empty values, stringify/strip leaf items."""
        if not data:
            return {}
        if isinstance(data, dict):
            new_data = {}
            for key in sorted(data.keys(), key=lambda k: (len(k), k)):
                value = self.normalize_dict(data[key])
                if value:
                    if not isinstance(value, list):
                        value = [value]
                    new_data[key] = value
            return new_data
        if isinstance(data, list):
            if all(isinstance(item, dict) for item in data):
                return [n for n in (self.normalize_dict(item) for item in data) if n]
            return [
                str(item).strip()
                for item in data
                if type(item) in {str, int, float} and str(item).strip()
            ]
        return [str(data).strip()]

    def cal_f1(self, preds: List[dict], answers: List[dict]) -> float:
        """Field-level micro-F1 over flattened (key, value) pairs."""
        total_tp, total_fn_or_fp = 0, 0
        for pred, answer in zip(preds, answers):
            pred_fields = self.flatten(self.normalize_dict(pred))
            answer_fields = self.flatten(self.normalize_dict(answer))
            for field in pred_fields:
                if field in answer_fields:
                    total_tp += 1
                    answer_fields.remove(field)
                else:
                    total_fn_or_fp += 1
            total_fn_or_fp += len(answer_fields)
        return total_tp / (total_tp + total_fn_or_fp / 2)

    def construct_tree_from_dict(self, data: Union[Dict, List], node_name: str | None = None) -> TreeNode:
        """Build the evaluation tree: dict keys are internal nodes, lists of
        dicts become '<subtree>' children, scalar list items '<leaf>x' leaves."""
        if node_name is None:
            node_name = "<root>"
        node = TreeNode(node_name)
        if isinstance(data, dict):
            for key, value in data.items():
                node.addkid(self.construct_tree_from_dict(value, key))
        elif isinstance(data, list):
            if all(isinstance(item, dict) for item in data):
                for item in data:
                    node.addkid(self.construct_tree_from_dict(item, "<subtree>"))
            else:
                for item in data:
                    node.addkid(TreeNode(f"<leaf>{item}"))
        else:
            raise ValueError(f"unexpected node {data!r} under {node_name!r}")
        return node

    def cal_acc(self, pred: dict, answer: dict) -> float:
        """Normalized tree-edit-distance accuracy: max(0, 1 - TED / TED(empty, answer))."""
        pred_tree = self.construct_tree_from_dict(self.normalize_dict(pred))
        answer_tree = self.construct_tree_from_dict(self.normalize_dict(answer))
        empty_tree = self.construct_tree_from_dict(self.normalize_dict({}))
        dist = tree_edit_distance(
            pred_tree, answer_tree,
            insert_cost=self.insert_and_remove_cost,
            remove_cost=self.insert_and_remove_cost,
            update_cost=self.update_cost,
        )
        norm = tree_edit_distance(
            empty_tree, answer_tree,
            insert_cost=self.insert_and_remove_cost,
            remove_cost=self.insert_and_remove_cost,
            update_cost=self.update_cost,
        )
        if norm == 0.0:
            # empty ground truth: exact-empty prediction scores 1, else 0
            return 1.0 if dist == 0.0 else 0.0
        return max(0.0, 1.0 - dist / norm)
