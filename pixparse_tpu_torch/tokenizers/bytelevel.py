"""Pure-Python byte-level tokenizer ``pixparse_bytelevel``.

The same token ids and decoded strings as the JAX package's offline
tokenizer (``pixparse_tpu.tokenizers.local_bpe``: an HF ``tokenizers``
byte-level BPE with the 256-entry byte alphabet and no merges, wrapped by
``PreTrainedTokenizerFast``), without the ``tokenizers`` or
``transformers`` packages:

- ids 0-3 are ``<s>``, ``<pad>``, ``</s>``, ``<unk>``; ids 4-259 are the
  256 bytes, ordered by their GPT-2 byte-to-unicode character; special
  tokens added later take the next ids;
- encoding splits out special tokens first (leftmost, then longest match),
  then maps every UTF-8 byte of the rest to its id;
- decoding drops unknown ids (and special tokens when asked), joins the
  tokens' bytes and decodes them as UTF-8, replacing invalid sequences
  with U+FFFD; no tokenization-space clean-up (the wrapped tokenizer's
  default).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

BYTELEVEL_TOKENIZER_NAME = "pixparse_bytelevel"


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
    ``decode``, ``batch_decode``, ``add_special_tokens``, ``len()`` and the
    special-token attributes."""

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

    def add_special_tokens(self, special_tokens_dict: Dict[str, Sequence[str]]) -> int:
        """``{"additional_special_tokens": [...]}`` -> number of tokens new
        to the vocabulary (each new one takes the next id)."""
        added = 0
        for tok in special_tokens_dict.get("additional_special_tokens", ()):
            if tok not in self._vocab:
                self._vocab[tok] = len(self._vocab)
                self._id_token[self._vocab[tok]] = tok
                added += 1
            if tok not in self._special:
                self._special.append(tok)
        return added

    # -- encode / decode ----------------------------------------------------
    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        """Token ids of ``text`` (no BOS/EOS is added either way: the
        wrapped tokenizer has no post-processor)."""
        ids: List[int] = []
        start = i = 0
        while i < len(text):
            match = max(
                (t for t in self._special if text.startswith(t, i)), key=len, default=None
            )
            if match is None:
                i += 1
                continue
            ids.extend(self._byte_ids[b] for b in text[start:i].encode("utf-8"))
            ids.append(self._vocab[match])
            i = start = i + len(match)
        ids.extend(self._byte_ids[b] for b in text[start:].encode("utf-8"))
        return ids

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
        return [self.decode(seq, skip_special_tokens=skip_special_tokens) for seq in sequences]
