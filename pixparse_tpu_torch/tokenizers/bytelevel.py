"""Pure-Python byte-level tokenizer ``pixparse_bytelevel``.

The same token ids and decoded strings as the JAX package's offline
tokenizer (``pixparse_tpu.tokenizers.local_bpe``: an HF ``tokenizers``
byte-level BPE with the 256-entry byte alphabet and no merges, wrapped by
``PreTrainedTokenizerFast``), without the ``tokenizers`` or
``transformers`` packages:

- ids 0-3 are ``<s>``, ``<pad>``, ``</s>``, ``<unk>``; ids 4-259 are the
  256 bytes, ordered by their GPT-2 byte-to-unicode character; special
  tokens added later (special or plain) take the next ids;
- encoding splits out special and added tokens first (leftmost, then longest
  match), then maps every UTF-8 byte of the rest to its id;
- decoding drops unknown ids (and special tokens when asked), joins the
  tokens' bytes and decodes them as UTF-8, replacing invalid sequences
  with U+FFFD; no tokenization-space clean-up (the wrapped tokenizer's
  default);
- ``save_pretrained`` / ``from_pretrained`` keep the added tokens in
  ``pixparse_bytelevel.json`` inside a directory, whose path then serves as
  the tokenizer's name (as a directory of HF tokenizer files does).
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace
from typing import Dict, Iterable, List, Optional, Sequence

BYTELEVEL_TOKENIZER_NAME = "pixparse_bytelevel"
BYTELEVEL_VOCAB_FILE = "pixparse_bytelevel.json"


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable unicode character table."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class ByteLevelTokenizer:
    """The subset of the HF tokenizer interface the port uses: ``encode``,
    ``decode``, ``batch_decode``, ``add_special_tokens``, ``add_tokens``,
    ``save_pretrained`` / ``from_pretrained``, ``len()``, the special-token
    attributes, and the call form the annotation preprocessing
    uses (pad and truncate to ``max_length``, numpy ids)."""

    bos_token, pad_token, eos_token, unk_token = "<s>", "<pad>", "</s>", "<unk>"

    def __init__(self):
        byte_char = bytes_to_unicode()
        chars = sorted(byte_char.values())
        self._vocab: Dict[str, int] = {}
        for tok in (self.bos_token, self.pad_token, self.eos_token, self.unk_token):
            self._vocab[tok] = len(self._vocab)
        for ch in chars:
            self._vocab[ch] = len(self._vocab)
        self._byte_ids = [self._vocab[byte_char[b]] for b in range(256)]
        self._char_byte = {c: b for b, c in byte_char.items()}
        self._id_token = {i: t for t, i in self._vocab.items()}
        self._special: List[str] = [self.bos_token, self.eos_token, self.unk_token, self.pad_token]
        # tokens encode() splits out whole: by first character, then by
        # length (longest first), so a position costs a set lookup a length
        # and not a scan of every token (a vocabulary padded with tens of
        # thousands of added tokens)
        self._whole: Dict[str, Dict[int, set]] = {}
        self._whole_lengths: Dict[str, List[int]] = {}
        for tok in self._special:
            self._match_whole(tok)

    # -- vocabulary ---------------------------------------------------------
    def __len__(self) -> int:
        return len(self._vocab)

    @property
    def all_special_tokens(self) -> List[str]:
        return list(self._special)

    def convert_tokens_to_ids(self, token: str) -> int:
        return self._vocab.get(token, self._vocab[self.unk_token])

    @property
    def bos_token_id(self) -> int:
        return self._vocab[self.bos_token]

    @property
    def pad_token_id(self) -> int:
        return self._vocab[self.pad_token]

    @property
    def eos_token_id(self) -> int:
        return self._vocab[self.eos_token]

    @property
    def unk_token_id(self) -> int:
        return self._vocab[self.unk_token]

    def _match_whole(self, tok: str):
        by_len = self._whole.setdefault(tok[0], {})
        if len(tok) not in by_len:
            by_len[len(tok)] = set()
            self._whole_lengths[tok[0]] = sorted(by_len, reverse=True)
        by_len[len(tok)].add(tok)

    def _longest_whole(self, text: str, i: int) -> Optional[str]:
        """The longest whole-split token that starts at ``text[i]``, or None."""
        by_len = self._whole.get(text[i])
        if by_len:
            for n in self._whole_lengths[text[i]]:
                if text[i:i + n] in by_len[n]:
                    return text[i:i + n]
        return None

    def add_tokens(self, tokens: Sequence[str]) -> int:
        """Plain added tokens -> number new to the vocabulary (each new one
        takes the next id). ``encode`` splits them out whole, as it does
        special tokens; ``decode(skip_special_tokens=True)`` keeps them."""
        added = 0
        for tok in tokens:
            if tok and tok not in self._vocab:
                self._vocab[tok] = len(self._vocab)
                self._id_token[self._vocab[tok]] = tok
                self._match_whole(tok)
                added += 1
        return added

    def add_special_tokens(self, special_tokens_dict: Dict[str, Sequence[str]]) -> int:
        """``{"additional_special_tokens": [...]}`` -> number of tokens new
        to the vocabulary (each new one takes the next id)."""
        tokens = list(special_tokens_dict.get("additional_special_tokens", ()))
        added = self.add_tokens(tokens)
        for tok in tokens:
            if tok not in self._special:
                self._special.append(tok)
                self._match_whole(tok)
        return added

    def save_pretrained(self, path: str):
        """Write the tokens added after the byte alphabet, in id order, to
        ``<path>/pixparse_bytelevel.json``."""
        base = len(ByteLevelTokenizer())
        added = [
            {"content": self._id_token[i], "special": self._id_token[i] in self._special}
            for i in range(base, len(self))
        ]
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, BYTELEVEL_VOCAB_FILE), "w", encoding="utf-8") as fh:
            json.dump({"added_tokens": added}, fh)

    @classmethod
    def from_pretrained(cls, path: str) -> "ByteLevelTokenizer":
        """The tokenizer ``save_pretrained`` wrote into ``path``: the same
        ids for every added token."""
        with open(os.path.join(path, BYTELEVEL_VOCAB_FILE), encoding="utf-8") as fh:
            added = json.load(fh)["added_tokens"]
        tok = cls()
        for entry in added:
            if entry["special"]:
                tok.add_special_tokens({"additional_special_tokens": [entry["content"]]})
            else:
                tok.add_tokens([entry["content"]])
        return tok

    # -- encode / decode ----------------------------------------------------
    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        """Token ids of ``text`` (no BOS/EOS is added either way: the
        wrapped tokenizer has no post-processor)."""
        ids: List[int] = []
        start = i = 0
        while i < len(text):
            match = self._longest_whole(text, i)
            if match is None:
                i += 1
                continue
            ids.extend(self._byte_ids[b] for b in text[start:i].encode("utf-8"))
            ids.append(self._vocab[match])
            i = start = i + len(match)
        ids.extend(self._byte_ids[b] for b in text[start:].encode("utf-8"))
        return ids

    def __call__(
        self,
        text: str,
        add_special_tokens: bool = True,
        return_tensors: Optional[str] = None,
        max_length: Optional[int] = None,
        padding=False,
        truncation: bool = False,
    ):
        """One string -> an object with ``input_ids`` and ``attention_mask``
        of shape ``(1, L)`` (numpy int64 with ``return_tensors='np'``, lists
        otherwise). ``truncation`` cuts to ``max_length``;
        ``padding='max_length'`` pads on the right with the pad id."""
        import numpy as np

        ids = self.encode(text, add_special_tokens=add_special_tokens)
        if truncation and max_length is not None:
            ids = ids[:max_length]
        mask = [1] * len(ids)
        if padding == "max_length" and max_length is not None:
            pad = max_length - len(ids)
            ids = ids + [self.pad_token_id] * pad
            mask = mask + [0] * pad
        if return_tensors == "np":
            return SimpleNamespace(
                input_ids=np.asarray([ids], np.int64), attention_mask=np.asarray([mask], np.int64)
            )
        if return_tensors is not None:
            raise ValueError(f"return_tensors={return_tensors!r}: only 'np' or None")
        return SimpleNamespace(input_ids=[ids], attention_mask=[mask])

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = False) -> str:
        out = bytearray()
        for i in ids:
            tok = self._id_token.get(int(i))
            if tok is None or (skip_special_tokens and tok in self._special):
                continue
            if all(c in self._char_byte for c in tok):
                out.extend(self._char_byte[c] for c in tok)
            else:
                out.extend(tok.encode("utf-8"))
        return out.decode("utf-8", errors="replace")

    def batch_decode(self, sequences, skip_special_tokens: bool = False) -> List[str]:
        # imported here: the tokenizer alone needs no torch
        from pixparse_tpu_torch.framework.profiling import span

        with span("tokenizer.batch_decode"):
            return [self.decode(seq, skip_special_tokens=skip_special_tokens) for seq in sequences]
