"""Vectorized codepoint/byte normalization.

Reproduces the reference's string prep exactly (free functions at
nGramSearch.h:30-98 and the validChar set at nGramSearch.h:306-313), but as
LUT-driven array ops over padded token matrices instead of per-char loops:

  * ``escape_blank`` - chars outside the valid set become spaces
    (nGramSearch.h:93-98).
  * ``trim`` - strip leading/trailing whitespace (nGramSearch.h:30-66).
  * ``to_upper`` - C ``toupper`` / ``towupper`` (nGramSearch.h:72-87).

Narrow strings are uint8 byte matrices, wide strings are uint32 UTF-32
codepoint matrices.  All matrices are padded with 0 beyond each row's length
and every function preserves that invariant, so downstream gram extraction
and DP kernels can rely on it.

These functions are pure numpy (host side, used by the index builder and the
query front end).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from ..config import DEFAULT_VALID_CHARS

SPACE = 0x20

# C-locale isspace set (reference casts to unsigned char, nGramSearch.h:31-33).
_NARROW_SPACES = (0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20)
# iswspace superset for wide strings (Unicode whitespace).
_WIDE_SPACES = _NARROW_SPACES + (
    0x85, 0xA0, 0x1680,
    0x2000, 0x2001, 0x2002, 0x2003, 0x2004, 0x2005, 0x2006, 0x2007,
    0x2008, 0x2009, 0x200A, 0x2028, 0x2029, 0x202F, 0x205F, 0x3000,
)


class TextTables:
    """Normalization tables for one index instance.

    The valid-char set is runtime-replaceable (``setValidChar``,
    dllmain.cpp:142-151), so each index owns its tables.

    For wide indexes the rule follows the reference's documented intent
    ("other characters in the ASCII range will be converted to spaces",
    nGramSearch.h:306): codepoints < 128 must be in the valid set; codepoints
    >= 128 are always kept.
    """

    def __init__(
        self,
        valid_chars: bytes = DEFAULT_VALID_CHARS,
        wide: bool = False,
        wide_upper: str = "simple",
    ):
        self.wide = wide
        self.wide_upper = wide_upper
        self.valid_chars = bytes(valid_chars)
        # 256-entry LUTs; wide codepoints >= 256 bypass them.
        self.valid_lut = np.zeros(256, dtype=bool)
        self.valid_lut[np.frombuffer(self.valid_chars, dtype=np.uint8)] = True
        self.space_lut = np.zeros(256, dtype=bool)
        self.space_lut[list(_NARROW_SPACES)] = True
        upper = np.arange(256, dtype=np.uint32)
        lower = np.arange(ord("a"), ord("z") + 1)
        upper[lower] = lower - 32
        self.upper_lut = upper
        self._wide_spaces = np.array(sorted(_WIDE_SPACES), dtype=np.uint32)
        # Lazy cache: codepoint -> simple uppercase for codepoints >= 128
        # ("simple" mode; see IndexConfig.wide_upper for the towupper
        # parity decision, reference nGramSearch.h:83-87).
        self._wide_upper_cache: dict[int, int] = {}

    # -- element predicates over token matrices --------------------------

    def is_space(self, tokens: np.ndarray) -> np.ndarray:
        if self.wide:
            return np.isin(tokens, self._wide_spaces)
        return self.space_lut[tokens]

    def is_valid(self, tokens: np.ndarray) -> np.ndarray:
        lut_hit = self.valid_lut[np.minimum(tokens, 255)]
        if not self.wide:
            return lut_hit
        # Wide: only the ASCII range is filtered (nGramSearch.h:306).
        return np.where(tokens < 128, lut_hit, True)

    def upper(self, tokens: np.ndarray) -> np.ndarray:
        """Uppercase per the index's mapping.

        Narrow: C ``toupper`` on bytes = ASCII a-z only (the reference
        casts through unsigned char, nGramSearch.h:72-77).  Wide "c"
        mode: C-locale ``towupper`` = ASCII a-z only too (the reference
        DLL never calls setlocale, nGramSearch.h:83-87).  Wide "simple"
        mode (default): Unicode simple uppercase for every codepoint -
        single-codepoint mappings only, so one-to-many expansions
        (ß -> SS, ligatures) keep the original codepoint, exactly like
        a locale-aware towupper.
        """
        out = self.upper_lut[np.minimum(tokens, 255)].astype(tokens.dtype)
        if not self.wide:
            return out
        # wide codepoints above the LUT bypass it (clamping would alias
        # them onto U+00FF)
        out = np.where(tokens > 255, tokens, out)
        if self.wide_upper == "c":
            return out
        high_mask = tokens >= 128
        high = np.unique(tokens[high_mask])
        if high.size:
            for cp in high.tolist():
                if cp not in self._wide_upper_cache:
                    up = chr(cp).upper()
                    self._wide_upper_cache[cp] = ord(up) if len(up) == 1 else cp
            mapped = np.array(
                [self._wide_upper_cache[cp] for cp in high.tolist()],
                dtype=tokens.dtype,
            )
            out[high_mask] = mapped[np.searchsorted(high, tokens[high_mask])]
        return out


# -- encoding ------------------------------------------------------------


def encode_batch(strings: Sequence, wide: bool) -> tuple[np.ndarray, np.ndarray]:
    """Encode python strings/bytes into a padded token matrix + lengths.

    Narrow strings accept ``bytes`` or latin-1-encodable ``str`` (the
    reference API is ``char**``); wide strings accept any ``str`` (UTF-32
    codepoints, matching ``wchar_t**`` in Readme.md:91).  ``None`` entries
    encode as empty rows (null words are skipped by the builder,
    nGramSearch.hpp:129,151).

    Bulk path: one join + one frombuffer + one gather, no per-string numpy.
    """
    dtype = np.uint32 if wide else np.uint8
    if wide:
        parts = [
            ""
            if s is None
            else (s.decode("utf-8") if isinstance(s, bytes) else str(s))
            for s in strings
        ]
        flat = np.frombuffer("".join(parts).encode("utf-32-le"), dtype=np.uint32)
        lengths = np.fromiter((len(p) for p in parts), np.int32, len(parts))
    else:
        parts = [
            b""
            if s is None
            else (s if isinstance(s, bytes) else str(s).encode("latin-1"))
            for s in strings
        ]
        flat = np.frombuffer(b"".join(parts), dtype=np.uint8)
        lengths = np.fromiter((len(p) for p in parts), np.int32, len(parts))
    n = len(parts)
    width = max(1, int(lengths.max()) if n else 1)
    if n == 0:
        return np.zeros((0, width), dtype=dtype), lengths
    starts = np.zeros(n, dtype=np.int64)
    np.cumsum(lengths[:-1], out=starts[1:])
    cols = np.arange(width, dtype=np.int64)
    gather = starts[:, None] + cols[None, :]
    in_range = cols[None, :] < lengths[:, None]
    if flat.size == 0:
        return np.zeros((n, width), dtype=dtype), lengths
    tokens = flat[np.minimum(gather, flat.size - 1)]
    return np.where(in_range, tokens, dtype(0)), lengths


def decode_row(tokens: np.ndarray, length: int, wide: bool) -> str:
    row = np.asarray(tokens[:length])
    if wide:
        return row.astype(np.uint32).tobytes().decode("utf-32-le")
    return row.astype(np.uint8).tobytes().decode("latin-1")


# -- matrix transforms (all preserve the pad-with-0 invariant) ------------


def _in_range_mask(tokens: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    return np.arange(tokens.shape[1])[None, :] < lengths[:, None]


def escape_blank_matrix(
    tokens: np.ndarray, lengths: np.ndarray, tables: TextTables
) -> np.ndarray:
    """Invalid characters -> space, within each row's length."""
    mask = _in_range_mask(tokens, lengths)
    escaped = np.where(tables.is_valid(tokens), tokens, tokens.dtype.type(SPACE))
    return np.where(mask, escaped, tokens.dtype.type(0))


def trim_matrix(
    tokens: np.ndarray, lengths: np.ndarray, tables: TextTables
) -> tuple[np.ndarray, np.ndarray]:
    """ltrim+rtrim each row; rows shift left, new lengths returned."""
    n, width = tokens.shape
    mask = _in_range_mask(tokens, lengths)
    nonspace = mask & ~tables.is_space(tokens)
    any_ns = nonspace.any(axis=1)
    first = np.argmax(nonspace, axis=1)
    last = width - 1 - np.argmax(nonspace[:, ::-1], axis=1)
    new_len = np.where(any_ns, last - first + 1, 0).astype(np.int32)
    cols = first[:, None] + np.arange(width)[None, :]
    shifted = np.take_along_axis(tokens, np.minimum(cols, width - 1), axis=1)
    out_mask = np.arange(width)[None, :] < new_len[:, None]
    return np.where(out_mask, shifted, tokens.dtype.type(0)), new_len


def upper_matrix(
    tokens: np.ndarray, lengths: np.ndarray, tables: TextTables
) -> np.ndarray:
    mask = _in_range_mask(tokens, lengths)
    return np.where(mask, tables.upper(tokens), tokens.dtype.type(0))


def normalize_matrix(
    tokens: np.ndarray,
    lengths: np.ndarray,
    tables: TextTables,
    upper: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """escapeBlank -> trim -> toUpper, the reference's query/term pipeline
    (nGramSearch.hpp:136-139,153-156,372-376).  ``upper=False`` gives the
    exact-match-promotion form (escapeBlank+trim only, nGramSearch.hpp:330-332).
    """
    t = escape_blank_matrix(tokens, lengths, tables)
    t, new_len = trim_matrix(t, lengths, tables)
    if upper:
        t = upper_matrix(t, new_len, tables)
    return t, new_len


def trim_only_matrix(
    tokens: np.ndarray, lengths: np.ndarray, tables: TextTables
) -> tuple[np.ndarray, np.ndarray]:
    """Plain trim, used on raw master keys (nGramSearch.hpp:131-133)."""
    return trim_matrix(tokens, lengths, tables)
