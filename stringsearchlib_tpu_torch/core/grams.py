"""N-gram window extraction and packing.

The reference packs a fixed 3-byte window into an int32
(``gramHash``, nGramSearch.h:147-150) and extracts windows with a sliding
loop (index side dedups into a posting set, nGramSearch.hpp:13-21; query side
keeps duplicates, nGramSearch.hpp:29-36 - duplicate query grams count
multiple times, which is parity-critical).

This build generalizes to gram_size in {2,3,4} (the README's documented
``gSize``, Readme.md:39) and to UTF-32 codepoints:

  * narrow bytes: 8-bit fields packed into int64 (for g=3 the value equals
    the reference's hash for ASCII inputs);
  * wide codepoints, g<=3: 21-bit fields (max codepoint 0x10FFFF) -> exact
    injective packing in int64, no collisions (SURVEY hard-parts list);
  * wide g=4: packed through a per-index dense codepoint vocabulary
    (16-bit ids -> 64 bits exact).

Gram ids live host-side as numpy int64; compiled kernels only ever see dense
gram *slots* (positions in the index's sorted distinct-gram array), so no
64-bit gram arithmetic reaches the device.
"""

from __future__ import annotations

import numpy as np

WIDE_BITS = 21
VOCAB_BITS = 16


def window_count(lengths: np.ndarray, gram_size: int) -> np.ndarray:
    """Number of grams per row: len - g + 1, clamped at 0 for len < g."""
    return np.maximum(np.asarray(lengths, dtype=np.int64) - gram_size + 1, 0)


def extract_windows(
    tokens: np.ndarray, lengths: np.ndarray, gram_size: int
) -> tuple[np.ndarray, np.ndarray]:
    """Sliding windows over each row.

    Returns (windows, valid): windows is (N, W, g) int64 and valid is (N, W)
    bool, where W = max(width - g + 1, 1).  Invalid windows are zeroed.
    """
    n, width = tokens.shape
    w = max(width - gram_size + 1, 1)
    base = tokens.astype(np.int64)
    cols = [base[:, k : k + w] for k in range(gram_size)]
    cols = [
        np.pad(c, ((0, 0), (0, w - c.shape[1]))) if c.shape[1] < w else c
        for c in cols
    ]
    windows = np.stack(cols, axis=2)
    valid = np.arange(w)[None, :] < window_count(lengths, gram_size)[:, None]
    return np.where(valid[:, :, None], windows, 0), valid


def pack_fields(windows: np.ndarray, bits: int) -> np.ndarray:
    """Pack (…, g) fields into int64, first char highest (gramHash order)."""
    g = windows.shape[-1]
    out = np.zeros(windows.shape[:-1], dtype=np.int64)
    for k in range(g):
        out = (out << bits) | windows[..., k]
    return out


class WideVocab:
    """Dense codepoint vocabulary for exact wide g=4 packing."""

    def __init__(self, codepoints: np.ndarray):
        self.codepoints = np.unique(np.asarray(codepoints, dtype=np.int64))
        if self.codepoints.size >= (1 << VOCAB_BITS) - 1:
            raise ValueError(
                "wide gram_size=4 supports < 65535 distinct codepoints per index"
            )

    def lookup(self, tokens: np.ndarray) -> np.ndarray:
        """codepoint -> dense id + 1; unseen codepoints -> 0 (never matches an
        indexed gram because indexed windows use ids >= 1)."""
        idx = np.searchsorted(self.codepoints, tokens)
        idx_c = np.minimum(idx, max(self.codepoints.size - 1, 0))
        hit = (
            (self.codepoints[idx_c] == tokens)
            if self.codepoints.size
            else np.zeros(tokens.shape, dtype=bool)
        )
        return np.where(hit, idx_c + 1, 0).astype(np.int64)


def gram_ids(
    tokens: np.ndarray,
    lengths: np.ndarray,
    gram_size: int,
    wide: bool,
    vocab: WideVocab | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-row gram ids (duplicates preserved, query semantics).

    Returns (grams (N, W) int64, valid (N, W) bool).
    """
    if not wide:
        # shift-or the byte columns directly: the generic path's
        # (N, W, g) int64 window stack was the index build's single
        # largest allocation (13 s / ~700 MB at 1M keys)
        n, width = tokens.shape
        w = max(width - gram_size + 1, 1)
        t = tokens
        if width < gram_size:
            t = np.pad(t, ((0, 0), (0, gram_size - width)))
        out = t[:, 0:w].astype(np.int64)
        for k in range(1, gram_size):
            out = (out << 8) | t[:, k : k + w]
        valid = (
            np.arange(w)[None, :] < window_count(lengths, gram_size)[:, None]
        )
        return np.where(valid, out, 0), valid
    windows, valid = extract_windows(tokens, lengths, gram_size)
    if gram_size <= 3:
        return pack_fields(windows, WIDE_BITS), valid
    if vocab is None:
        raise ValueError("wide gram_size=4 requires a WideVocab")
    return pack_fields(vocab.lookup(windows), VOCAB_BITS), valid


def unique_grams_per_row(
    grams: np.ndarray, valid: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Dedup grams within each row (index-side posting-set semantics,
    nGramSearch.hpp:19 ``ngrams[hash].insert(id)``).

    Returns (grams, valid) of identical shape with duplicates invalidated.
    """
    order = np.argsort(grams, axis=1, kind="stable")
    sg = np.take_along_axis(grams, order, axis=1)
    sv = np.take_along_axis(valid, order, axis=1)
    dup = np.zeros_like(sv)
    dup[:, 1:] = (sg[:, 1:] == sg[:, :-1]) & sv[:, :-1]
    keep = sv & ~dup
    return np.where(keep, sg, 0), keep
