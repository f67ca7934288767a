"""Byte-level tokenizer (examples/serving demos; no external vocab files).

The port's own copy of the reference's ``repro.data.tokenizer``.

ids 0..255 = bytes; 256 = BOS; 257 = EOS; 258 = PAD.
"""
from __future__ import annotations

from typing import Iterable, List

import numpy as np

BOS, EOS, PAD = 256, 257, 258
VOCAB_SIZE = 259


def encode(text: str, *, bos: bool = True, eos: bool = False) -> np.ndarray:
    ids: List[int] = list(text.encode("utf-8"))
    if bos:
        ids = [BOS] + ids
    if eos:
        ids = ids + [EOS]
    return np.asarray(ids, np.int32)


def decode(ids: Iterable[int]) -> str:
    bs = bytes(i for i in ids if 0 <= int(i) < 256)
    return bs.decode("utf-8", errors="replace")


def batch_encode(texts: List[str], *, pad_to: int) -> np.ndarray:
    rows = []
    for t in texts:
        ids = encode(t)[:pad_to]
        rows.append(np.pad(ids, (0, pad_to - len(ids)),
                           constant_values=PAD))
    return np.stack(rows)
