"""A frozen copy of the port's pure-Python oracle (``utils/oracle.py``),
made self-contained: the library's constants are written out here, so the
copy imports nothing of the program.  It mirrors StringIndex
(nGramSearch.hpp) loop for loop and is the check of ``index.py``: the
benchmark's tests hold the two equal at tiny sizes.  It is intentionally
unoptimized and never runs in a benchmark run.

Deterministic resolutions of the reference's nondeterminism (the
conformance comparator treats these as tie-group-equivalent):

  * string-table ids are assigned in first-encounter row order (the reference
    copies an unordered_set into a vector, nGramSearch.hpp:58-65);
  * the exact-match promotion (nGramSearch.hpp:328-336) resolves to
    max(100, best weighted score) - order-independent; the reference's result
    depends on unordered_map iteration order only when a weight exceeds 100;
  * wildcard search takes the max weight per key (reference: last writer wins
    in unordered iteration, nGramSearch.hpp:356-369);
  * final sort ties (equal score and key length) break by key id ascending
    (std::partial_sort is unstable, nGramSearch.hpp:397-401).

All score arithmetic uses float32, matching the reference's C floats.
"""

from __future__ import annotations

import numpy as np

DEFAULT_VALID_CHARS = (
    b".%$ @" b"0123456789" b"abcdefghijklmnopqrstuvwxyz" b"ABCDEFGHIJKLMNOPQRSTUVWXYZ"
)
INT32_MAX = 2**31 - 1
PERFECT_SCORE_CUTOFF = 0.999
PROMOTED_SCORE = 100.0
_NARROW_SPACES = (0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20)
_WIDE_SPACES = _NARROW_SPACES + (
    0x85, 0xA0, 0x1680,
    0x2000, 0x2001, 0x2002, 0x2003, 0x2004, 0x2005, 0x2006, 0x2007,
    0x2008, 0x2009, 0x200A, 0x2028, 0x2029, 0x202F, 0x205F, 0x3000,
)

_NARROW_SPACE_CHARS = frozenset(chr(c) for c in _NARROW_SPACES)
_WIDE_SPACE_CHARS = frozenset(chr(c) for c in _WIDE_SPACES)

_f32 = np.float32


class OracleIndex:
    """Reference-faithful index + search (StringIndex, nGramSearch.hpp)."""

    def __init__(
        self,
        words,
        row_size: int,
        weights=None,
        gram_size: int = 3,
        wide: bool = False,
        valid_chars: bytes = DEFAULT_VALID_CHARS,
        wide_upper: str = "simple",
    ):
        self.gram_size = gram_size
        self.wide = wide
        self.wide_upper = wide_upper
        self.valid_chars = set(bytes(valid_chars).decode("latin-1"))
        self._space_chars = _WIDE_SPACE_CHARS if wide else _NARROW_SPACE_CHARS

        self.string_lib: list[str] = []  # id -> string (terms + raw keys)
        self._string_ids: dict[str, int] = {}
        self.word_map: dict[int, list[int]] = {}  # term id -> key ids
        self.word_weight: dict[int, dict[int, float]] = {}
        self.long_lib: list[int] = []
        self.short_lib: list[int] = []
        self.ngrams: dict[int, set[int]] = {}
        self.longest = 0
        self.indexed = False
        self._build(words, row_size, weights)

    # -- normalization (nGramSearch.h:30-98) ------------------------------

    def _is_space(self, ch: str) -> bool:
        return ch in self._space_chars

    def trim(self, s: str) -> str:
        i, j = 0, len(s)
        while i < j and self._is_space(s[i]):
            i += 1
        while j > i and self._is_space(s[j - 1]):
            j -= 1
        return s[i:j]

    def escape_blank(self, s: str) -> str:
        out = []
        for ch in s:
            if self.wide and ord(ch) >= 128:
                out.append(ch)
            elif ch in self.valid_chars:
                out.append(ch)
            else:
                out.append(" ")
        return "".join(out)

    def to_upper(self, s: str) -> str:
        """toupper/towupper (nGramSearch.h:72-87).  Narrow and wide "c"
        mode uppercase ASCII only (the reference never calls setlocale);
        wide "simple" mode applies Unicode simple uppercase (single
        codepoint only - ß / ligatures stay).  Mirrors TextTables.upper."""
        out = []
        for ch in s:
            cp = ord(ch)
            if ord("a") <= cp <= ord("z"):
                out.append(chr(cp - 32))
            elif self.wide and self.wide_upper == "simple" and cp >= 128:
                up = ch.upper()
                out.append(up if len(up) == 1 else ch)
            else:
                out.append(ch)
        return "".join(out)

    def normalize(self, s: str, upper: bool = True) -> str:
        t = self.trim(self.escape_blank(s))
        return self.to_upper(t) if upper else t

    # -- build (StringIndex ctor + init + buildGrams) ----------------------

    def _intern(self, s: str) -> int:
        if s not in self._string_ids:
            self._string_ids[s] = len(self.string_lib)
            self.string_lib.append(s)
        return self._string_ids[s]

    def _build(self, words, row_size: int, weights) -> None:
        if words is None or len(words) < 2:
            return
        size = len(words)
        # term string -> {key string: weight}, insertion-ordered.
        temp_word_map: dict[str, dict[str, float]] = {}

        def add(term: str, key: str, w: float) -> None:
            # Intern at first recorded occurrence, in element order: this is
            # the deterministic id rule shared with the vectorized builder
            # (the reference's unordered_set makes ids arbitrary).
            self._intern(term)
            self._intern(key)
            temp_word_map.setdefault(term, {})[key] = w

        for i in range(0, size, row_size):
            if words[i] is None:
                continue
            str_key = self.trim(str(words[i]))
            if not str_key:
                continue
            upper_key = self.normalize(str_key)
            w = _f32(1.0) if weights is None else _f32(weights[i])
            if w != 0.0:
                add(upper_key, str_key, float(w))
            for j in range(i + 1, min(i + row_size, size)):
                if words[j] is None:
                    continue
                str_query = self.normalize(str(words[j]))
                if not str_query:
                    continue
                w = _f32(1.0) if weights is None else _f32(weights[j])
                if w != 0.0:
                    add(str_query, str_key, float(w))

        # init (nGramSearch.hpp:54-108); ids were interned during add().
        for s in self.string_lib:
            self.longest = max(self.longest, len(s))
        for term, keys in temp_word_map.items():
            tid = self._string_ids[term]
            if len(term) >= 2 * self.gram_size:
                self.long_lib.append(tid)
            else:
                self.short_lib.append(tid)
            self.word_map[tid] = [self._string_ids[k] for k in keys]
            self.word_weight[tid] = {
                self._string_ids[k]: w for k, w in keys.items()
            }

        # buildGrams (nGramSearch.hpp:41-46).
        for tid in self.long_lib:
            s = self.string_lib[tid]
            for i in range(len(s) - self.gram_size + 1):
                self.ngrams.setdefault(self._gram_hash(s, i), set()).add(tid)
        self.indexed = True

    def _gram_hash(self, s: str, i: int) -> int:
        h = 0
        for k in range(self.gram_size):
            h = (h << 21) | ord(s[i + k])
        return h

    def _query_grams(self, q: str) -> list[int]:
        return [self._gram_hash(q, i) for i in range(len(q) - self.gram_size + 1)]

    # -- scorers -----------------------------------------------------------

    def string_match(self, query: str, source: str) -> int:
        """Semi-global edit distance (nGramSearch.hpp:182-222)."""
        if len(query) == 1:
            return 1 if query[0] in source else 0
        q_size, s_size = len(query), len(source)
        row1 = [0] * (s_size + 1)
        for q in range(q_size):
            row2 = [0] * (s_size + 1)
            row2[0] = q + 1
            for s in range(s_size):
                cost = 0 if query[q] == source[s] else 1
                row2[s + 1] = min(row1[s + 1] + 1, row2[s] + 1, row1[s] + cost)
            row1 = row2
        return q_size - min(row1)

    def _search_short(self, query: str) -> dict[int, float]:
        score: dict[int, float] = {}
        qlen = len(query)
        for tid in self.short_lib:
            m = self.string_match(query, self.string_lib[tid])
            score[tid] = float(_f32(m) / _f32(qlen))
        if qlen <= self.gram_size:
            for tid in self.long_lib:
                m = self.string_match(query, self.string_lib[tid])
                score[tid] = float(_f32(m) / _f32(qlen))
        return score

    def _search_long(self, query: str) -> dict[int, float]:
        if len(query) < self.gram_size:
            return {}
        grams = self._query_grams(query)
        if not grams:
            return {}
        raw: dict[int, int] = {}
        for g in grams:
            for tid in self.ngrams.get(g, ()):
                raw[tid] = raw.get(tid, 0) + 1
        return {
            tid: float(_f32(hits) / _f32(len(grams))) for tid, hits in raw.items()
        }

    def _calc_score(
        self,
        query: str,
        entry_score: dict[int, float],
        promoted: set[int],
        score_list: dict[int, float],
        threshold: float,
    ) -> None:
        """calcScore (nGramSearch.hpp:310-341) with order-free promotion."""
        thr = _f32(threshold)
        for tid, s in score_list.items():
            if _f32(s) < thr:
                continue
            for kid in self.word_map.get(tid, ()):
                w = self.word_weight.get(tid, {}).get(kid)
                if w is None:
                    continue
                val = float(_f32(w) * _f32(s))
                entry_score[kid] = max(val, entry_score.get(kid, 0.0))
                if s > PERFECT_SCORE_CUTOFF:
                    lib = self.normalize(self.string_lib[kid], upper=False)
                    if lib == query:
                        promoted.add(kid)

    def _search(self, query: str, threshold: float, limit: int):
        entry_score: dict[int, float] = {}
        promoted: set[int] = set()
        if len(query) == 0 or query == "*":
            # Wildcard (nGramSearch.hpp:356-369): every key at its weight.
            for tid, kids in self.word_map.items():
                for kid in kids:
                    w = self.word_weight.get(tid, {}).get(kid)
                    if w is not None:
                        entry_score[kid] = max(entry_score.get(kid, -np.inf), w)
        else:
            q = self.normalize(query)
            if not q:
                return []
            score_short: dict[int, float] = {}
            score_long = self._search_long(q)
            if len(q) < 3 * self.gram_size:
                score_short = self._search_short(q)
            self._calc_score(q, entry_score, promoted, score_short, threshold)
            self._calc_score(q, entry_score, promoted, score_long, threshold)
            for kid in promoted:
                entry_score[kid] = max(PROMOTED_SCORE, entry_score[kid])

        elems = [
            (kid, float(s), len(self.string_lib[kid])) for kid, s in entry_score.items()
        ]
        elems.sort(key=lambda e: (-e[1], e[2], e[0]))
        return [(kid, s) for kid, s, _ in elems[:limit]]

    # -- public surface (dllmain.cpp / StringIndex::search|score) ----------

    def search(self, query: str, threshold: float = 0.0, limit: int = 0):
        """Returns (result strings, scores); limit 0 means unbounded."""
        if not self.indexed:
            return [], []
        if limit == 0:
            limit = INT32_MAX
        res = self._search(query, threshold, limit)
        return [self.string_lib[kid] for kid, _ in res], [s for _, s in res]

    def size(self) -> int:
        return len(self.word_map)

    def lib_size(self) -> int:
        return len(self.ngrams)

    def set_valid_char(self, chars: bytes) -> None:
        self.valid_chars = set(bytes(chars).decode("latin-1"))
