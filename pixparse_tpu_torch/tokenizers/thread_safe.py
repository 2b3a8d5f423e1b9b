"""Thread-local tokenizer wrapper (counterpart of
:mod:`pixparse_tpu.tokenizers.thread_safe`).

HF fast tokenizers wrap a Rust object that is not thread-safe: concurrent
calls with differing truncation or padding raise ``RuntimeError: Already
borrowed``. The loaders run their decode and collate in threads
(``data/loader.py``, ``data/wds.py``), so each thread gets its own deep copy
here. Wrap the tokenizer only once it is fully configured (special tokens
added): each thread copies it lazily, on its first use.
"""

from __future__ import annotations

import copy
import threading


class ThreadLocalTokenizer:
    """Delegates every call and attribute to a per-thread deep copy of
    ``base``."""

    def __init__(self, base):
        object.__setattr__(self, "_base", base)
        object.__setattr__(self, "_tl", threading.local())

    def _get(self):
        tok = getattr(self._tl, "tok", None)
        if tok is None:
            tok = copy.deepcopy(self._base)
            self._tl.tok = tok
        return tok

    def __call__(self, *args, **kwargs):
        return self._get()(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._get(), name)

    def __len__(self):
        return len(self._get())

    def __deepcopy__(self, memo):
        # copying the wrapper gives a plain copy of the tokenizer
        return copy.deepcopy(self._base, memo)
