"""The plain reference: the library's search semantics in plain PyTorch.

It answers the same queries as the program from the same corpus, built
from scratch: its own normalization, its own gram index, its own scores.
It imports nothing of the program (nor of the JAX package) and takes
nothing that the program made.  The semantics are those of the upstream
StringSearchLib (nGramSearch.hpp), as the frozen oracle beside it
(``oracle.py``, a loop-by-loop transcription) states them:

  * a row of ``row_size`` elements: its first element, space-trimmed, is the
    key; each element's normalized form (characters outside the valid set
    become spaces, trimmed, ASCII uppercased) is a term of that key with
    the element's weight (zero weights and empty non-key terms skipped;
    the last weight written for a (term, key) pair holds);
  * a term of at least 2g characters is in the long tier and indexed by
    its distinct gram windows; a query's long score for a term is the
    number of the query's gram windows (with multiplicity) the term
    holds, over the query's window count, in float32;
  * queries shorter than 3g characters also score every short-tier term
    by the semi-global edit distance (matched characters over the query's
    length), and queries of at most g characters the long tier too;
  * a term's score passes at ``>= threshold``; a key's score is the
    largest weight x term score over its passing terms (never below 0);
    a key whose term scored above 0.999 and whose un-uppercased normal
    form equals the query is promoted to at least 100;
  * results rank by score descending, then key length ascending; ties are
    groups (the library's order within a group is unspecified).

Narrow (byte) strings only, ASCII: the benchmark's corpora are.  Runs on
any torch device; ``search_many`` computes the scores in ``score_dtype``
(float32, as the library's C floats; a lower precision makes the control).
"""

from __future__ import annotations

import numpy as np
import torch

VALID_CHARS = (
    b".%$ @" b"0123456789" b"abcdefghijklmnopqrstuvwxyz" b"ABCDEFGHIJKLMNOPQRSTUVWXYZ"
)
SPACES = (0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20)  # C-locale isspace
SPACE_STR = "".join(chr(c) for c in SPACES)
PERFECT_SCORE_CUTOFF = 0.999
PROMOTED_SCORE = 100.0
# postings gathered at once while counting a group of queries' hits
_POSTINGS_PER_STEP = 1 << 27


def _luts(device):
    valid = torch.zeros(256, dtype=torch.bool)
    valid[list(VALID_CHARS)] = True
    space = torch.zeros(256, dtype=torch.bool)
    space[list(SPACES)] = True
    upper = torch.arange(256, dtype=torch.int64)
    upper[ord("a"): ord("z") + 1] -= 32
    return valid.to(device), space.to(device), upper.to(torch.uint8).to(device)


def _trim_bounds(mat, lengths, space_lut):
    """(start, end) of each row's characters once the leading and trailing
    space characters are cut (start == end for a row of spaces)."""
    L = mat.shape[1]
    col = torch.arange(L, device=mat.device)
    keep = ~space_lut[mat.long()] & (col[None, :] < lengths[:, None])
    anyk = keep.any(1)
    first = torch.argmax(keep.to(torch.int8), 1)
    last = L - torch.argmax(keep.flip(1).to(torch.int8), 1)
    first = torch.where(anyk, first, torch.zeros_like(first))
    last = torch.where(anyk, last, torch.zeros_like(last))
    return first, last


def _left_align(mat, start, end):
    """Each row's [start, end) moved to column 0, zero padded after."""
    L = mat.shape[1]
    col = torch.arange(L, device=mat.device)
    idx = (start[:, None] + col[None, :]).clamp(max=max(L - 1, 0))
    out = torch.gather(mat, 1, idx)
    n = end - start
    return torch.where(col[None, :] < n[:, None], out, torch.zeros_like(out)), n


def _words64(mat):
    """(N, L) uint8 rows -> (N, ceil(L/8)) int64 words, zero padded."""
    n, L = mat.shape
    w = max((L + 7) // 8, 1)
    pad = torch.zeros((n, w * 8), dtype=torch.uint8, device=mat.device)
    pad[:, :L] = mat
    return pad.view(torch.int64)


def _group(cols):
    """Exact grouping of rows given as a list of (N,) int64 columns: (group id
    of each row, number of groups), ids in lexicographic order."""
    n = cols[0].shape[0]
    dev = cols[0].device
    order = torch.arange(n, device=dev)
    for c in reversed(cols):
        order = order[torch.argsort(c[order], stable=True)]
    if n == 0:
        return order, 0
    new = torch.zeros(n, dtype=torch.bool, device=dev)
    new[0] = True
    for c in cols:
        s = c[order]
        new[1:] |= s[1:] != s[:-1]
    gid_sorted = torch.cumsum(new.to(torch.int64), 0) - 1
    gid = torch.empty_like(gid_sorted)
    gid[order] = gid_sorted
    return gid, int(gid_sorted[-1]) + 1


def _csr(groups, n_groups, *values):
    """Values sorted by group (stable) and the (n_groups + 1,) row pointer."""
    order = torch.argsort(groups, stable=True)
    counts = torch.bincount(groups, minlength=n_groups)
    ptr = torch.zeros(n_groups + 1, dtype=torch.int64, device=groups.device)
    ptr[1:] = torch.cumsum(counts, 0)
    return (ptr, *[v[order] for v in values])


def _expand(ptr, rows):
    """For CSR rows ``rows``: (the position in ``rows`` of each gathered
    entry, the entry's index into the CSR values)."""
    cnt = ptr[rows + 1] - ptr[rows]
    rep = torch.repeat_interleave(torch.arange(rows.shape[0], device=rows.device), cnt)
    offs = torch.arange(int(cnt.sum()), device=rows.device) - (torch.cumsum(cnt, 0) - cnt)[rep]
    return rep, ptr[rows][rep] + offs


class ReferenceIndex:
    """The reference's index over ``words`` (the flattened rows) and its
    search."""

    def __init__(self, words, row_size: int, weights=None, gram_size: int = 3,
                 device="cpu"):
        self.g = int(gram_size)
        self.device = torch.device(device)
        self.valid_set = frozenset(VALID_CHARS.decode("latin-1"))
        self.indexed = words is not None and len(words) >= 2
        self._strs = ["" if w is None else str(w) for w in words] if self.indexed else []
        if not self.indexed:
            self.n_keys = self.n_terms = self.n_long = 0
            return
        dev = self.device
        n = len(self._strs)
        present = torch.tensor([w is not None for w in words], dtype=torch.bool)
        lens = np.fromiter(map(len, self._strs), np.int64, count=n)
        try:
            blob = "".join(self._strs).encode("ascii")
        except UnicodeEncodeError as e:
            raise ValueError("the reference takes ASCII strings only") from e
        L = max(int(lens.max()), 1)
        buf = torch.from_numpy(np.frombuffer(blob, np.uint8).copy()).to(dev)
        lengths = torch.from_numpy(lens).to(dev)
        starts = torch.cumsum(lengths, 0) - lengths
        col = torch.arange(L, device=dev)
        idx = (starts[:, None] + col[None, :]).clamp(max=max(buf.shape[0] - 1, 0))
        mat = buf[idx] if buf.numel() else torch.zeros((n, L), dtype=torch.uint8, device=dev)
        mat = torch.where(col[None, :] < lengths[:, None], mat, torch.zeros_like(mat))
        del buf, idx
        valid_lut, space_lut, upper_lut = _luts(dev)

        # raw keys: the first element of a row, space-trimmed
        ks, ke = _trim_bounds(mat, lengths, space_lut)
        # normal forms: invalid characters -> spaces, trimmed, uppercased
        esc = torch.where(valid_lut[mat.long()], mat, torch.full_like(mat, 0x20))
        esc = torch.where(col[None, :] < lengths[:, None], esc, torch.zeros_like(esc))
        ns, ne = _trim_bounds(esc, lengths, space_lut)
        norm, nlen = _left_align(upper_lut[esc.long()], ns, ne)
        del esc

        elem = torch.arange(n, device=dev)
        rs = int(row_size)
        row_first = (elem // rs) * rs
        is_key = elem == row_first
        present = present.to(dev)
        row_ok = present & (ke > ks)  # of a first element: its row is kept
        ok = row_ok[row_first]
        w = (torch.ones(n, dtype=torch.float32) if weights is None else
             torch.as_tensor(np.asarray(weights, np.float64)[:n], dtype=torch.float32)).to(dev)
        added = ok & present & (w != 0) & (is_key | (nlen > 0))

        key_rows = torch.nonzero(is_key & row_ok).squeeze(1)
        kmat, klen = _left_align(mat[key_rows], ks[key_rows], ke[key_rows])
        kgid, self.n_keys = _group([*_words64(kmat).unbind(1), klen])
        first_elem = torch.full((self.n_keys,), n, dtype=torch.int64, device=dev)
        first_elem.scatter_reduce_(0, kgid, key_rows, "amin")
        self.key_elem = first_elem.cpu().numpy()
        self.key_len = torch.zeros(self.n_keys, dtype=torch.int64, device=dev)
        self.key_len[kgid] = klen
        key_of_row = torch.full((n,), -1, dtype=torch.int64, device=dev)
        key_of_row[key_rows] = kgid
        del mat, kmat

        # terms, and the (term, key) pairs with the last weight written
        e_idx = torch.nonzero(added).squeeze(1)
        tmat, tlen = norm[e_idx], nlen[e_idx]
        tgid, self.n_terms = _group([*_words64(tmat).unbind(1), tlen])
        t_first = torch.full((self.n_terms,), n, dtype=torch.int64, device=dev)
        t_first.scatter_reduce_(0, tgid, torch.arange(e_idx.shape[0], device=dev), "amin")
        self.term_mat, self.term_len = tmat[t_first], tlen[t_first]
        pkey = key_of_row[row_first[e_idx]]
        pgid, n_pairs = _group([tgid, pkey])
        last = torch.full((n_pairs,), -1, dtype=torch.int64, device=dev)
        last.scatter_reduce_(0, pgid, e_idx, "amax")
        pair_term = torch.empty(n_pairs, dtype=torch.int64, device=dev)
        pair_key = torch.empty(n_pairs, dtype=torch.int64, device=dev)
        pair_term[pgid] = tgid
        pair_key[pgid] = pkey
        self.pair_ptr, self.pair_key, self.pair_w = _csr(
            pair_term, self.n_terms, pair_key, w[last])
        del norm, nlen, tmat

        # tiers; the long tier's distinct gram windows, by gram
        g = self.g
        long_mask = self.term_len >= 2 * g
        self.long_ids = torch.nonzero(long_mask).squeeze(1)
        self.short_ids = torch.nonzero(~long_mask).squeeze(1)
        self.n_long = int(self.long_ids.shape[0])
        lm, ll = self.term_mat[self.long_ids], self.term_len[self.long_ids]
        nw = max(lm.shape[1] - g + 1, 0)
        if self.n_long and nw:
            codes = self._codes(lm, nw)
            valid = torch.arange(nw, device=dev)[None, :] < (ll - g + 1)[:, None]
            term = torch.arange(self.n_long, device=dev)[:, None].expand(-1, nw)
            comb = torch.unique(codes[valid] * self.n_long + term[valid])
            gcode, gterm = comb // self.n_long, comb % self.n_long
            self.gram_codes, counts = torch.unique_consecutive(gcode, return_counts=True)
            self.gram_ptr = torch.zeros(self.gram_codes.shape[0] + 1, dtype=torch.int64,
                                        device=dev)
            self.gram_ptr[1:] = torch.cumsum(counts, 0)
            self.postings = gterm
        else:
            self.gram_codes = torch.zeros(0, dtype=torch.int64, device=dev)
            self.gram_ptr = torch.zeros(1, dtype=torch.int64, device=dev)
            self.postings = torch.zeros(0, dtype=torch.int64, device=dev)

    # -- strings ------------------------------------------------------------

    def _codes(self, mat, nw):
        """(R, nw) int64 gram codes of the windows of (R, L) uint8 rows (7
        bits a character: ASCII)."""
        m = mat.to(torch.int64)
        code = torch.zeros((m.shape[0], nw), dtype=torch.int64, device=m.device)
        for k in range(self.g):
            code = (code << 7) | m[:, k: k + nw]
        return code

    def key_string(self, kid: int) -> str:
        return self._strs[int(self.key_elem[kid])].strip(SPACE_STR)

    def normalize(self, s: str, upper: bool = True) -> str:
        t = "".join(c if c in self.valid_set else " " for c in s).strip(SPACE_STR)
        if upper:
            t = "".join(chr(ord(c) - 32) if "a" <= c <= "z" else c for c in t)
        return t

    def query_gram_codes(self, q: str) -> torch.Tensor:
        """The gram codes of a normalized query's windows, with
        multiplicity."""
        g = self.g
        if len(q) < g:
            return torch.zeros(0, dtype=torch.int64, device=self.device)
        b = torch.tensor(list(q.encode("ascii", "replace")), dtype=torch.uint8,
                         device=self.device)[None]
        return self._codes(b, len(q) - g + 1)[0]

    def gram_rows(self, codes: torch.Tensor) -> torch.Tensor:
        """The index's gram rows of ``codes`` that the corpus holds."""
        if self.gram_codes.numel() == 0 or codes.numel() == 0:
            return torch.zeros(0, dtype=torch.int64, device=self.device)
        pos = torch.searchsorted(self.gram_codes, codes).clamp(max=self.gram_codes.shape[0] - 1)
        return pos[self.gram_codes[pos] == codes]

    # -- scoring ------------------------------------------------------------

    def _long_scores(self, rows_per_query, nwins, threshold, dt):
        """For each query's gram rows (with multiplicity) and window count:
        the long-tier terms with hits whose score passes ``threshold``, and
        their scores (hits over windows, in the score precision ``dt``)."""
        out = [None] * len(rows_per_query)
        dev = self.device
        thr = torch.tensor(threshold, dtype=torch.float32).to(dt)
        sizes = [int((self.gram_ptr[r + 1] - self.gram_ptr[r]).sum()) if r.numel() else 0
                 for r in rows_per_query]
        i = 0
        while i < len(rows_per_query):
            j, total = i, 0
            while j < len(rows_per_query) and (
                    j == i or (total + sizes[j] <= _POSTINGS_PER_STEP
                               and (j - i + 1) * self.n_long <= _POSTINGS_PER_STEP)):
                total += sizes[j]
                j += 1
            rows = torch.cat([rows_per_query[k] for k in range(i, j)])
            slot = torch.cat([torch.full((rows_per_query[k].shape[0],), k - i,
                                         dtype=torch.int64, device=dev) for k in range(i, j)])
            rep, pos = _expand(self.gram_ptr, rows)
            hits = torch.bincount(slot[rep] * self.n_long + self.postings[pos],
                                  minlength=(j - i) * self.n_long).view(j - i, self.n_long)
            del rep, pos
            nwin = torch.tensor([max(nwins[k], 1) for k in range(i, j)], device=dev).to(dt)
            score = hits.to(dt) / nwin[:, None]
            q_slot, term = torch.nonzero((hits > 0) & (score >= thr), as_tuple=True)
            sc = score[q_slot, term]
            for k in range(i, j):
                sel = q_slot == k - i
                out[k] = (term[sel], sc[sel])
            del hits, score
            i = j
        return out

    def _dp_matched(self, q: str, ids: torch.Tensor) -> torch.Tensor:
        """Matched characters of ``q`` against terms ``ids``: the library's
        semi-global edit distance (nGramSearch.hpp:182-222), as q's length
        less the least edit cost of q against any substring."""
        src, slen = self.term_mat[ids].to(torch.int64), self.term_len[ids]
        qc = [ord(c) for c in q]
        L = src.shape[1]
        col = torch.arange(L, device=self.device)
        inlen = col[None, :] < slen[:, None]
        if len(qc) == 1:
            return ((src == qc[0]) & inlen).any(1).to(torch.int64)
        big = 1 << 30
        row1 = torch.zeros((ids.shape[0], L + 1), dtype=torch.int64, device=self.device)
        j = torch.arange(L, device=self.device)
        for qi, c in enumerate(qc):
            # row2[s+1] = min(row1[s] + cost, row1[s+1] + 1, row2[s] + 1):
            # the last term unrolled is a running minimum of best[j] + (s - j)
            best = torch.minimum(row1[:, :-1] + (src != c).to(torch.int64), row1[:, 1:] + 1)
            run = torch.cummin(best - j, 1).values + j
            row2 = torch.empty_like(row1)
            row2[:, 0] = qi + 1
            row2[:, 1:] = torch.minimum(run, qi + 2 + j)
            row1 = row2
        pos_ok = torch.arange(L + 1, device=self.device)[None, :] <= slen[:, None]
        least = torch.where(pos_ok, row1, torch.full_like(row1, big)).min(1).values
        return len(qc) - least

    def _search_one(self, q_raw: str, threshold: float, limit: int, long_scores, dt):
        dev = self.device
        if len(q_raw) == 0 or q_raw == "*":
            best = torch.full((self.n_keys,), float("-inf"), dtype=dt, device=dev)
            best.scatter_reduce_(0, self.pair_key, self.pair_w.to(dt), "amax")
            keys = torch.nonzero(best > float("-inf")).squeeze(1)
            return self._rank(keys, best[keys], limit)
        q = self.normalize(q_raw)
        if not q:
            return [], 0
        g = self.g
        terms, scores = [], []
        if long_scores is not None and len(q) >= g:
            t, sc = long_scores  # already past the threshold
            terms.append(self.long_ids[t])
            scores.append(sc)
        if len(q) < 3 * g:
            ids = self.short_ids if len(q) > g else torch.cat([self.short_ids, self.long_ids])
            if ids.numel():
                m = self._dp_matched(q, ids)
                terms.append(ids)
                scores.append(m.to(dt) / torch.tensor(len(q), dtype=dt, device=dev))
        if not terms:
            return [], 0
        terms, s = torch.cat(terms), torch.cat(scores)
        passing = s >= torch.tensor(threshold, dtype=torch.float32).to(dt)
        terms, s = terms[passing], s[passing]
        ent, pos = _expand(self.pair_ptr, terms)
        keys, w = self.pair_key[pos], self.pair_w[pos].to(dt)
        vals = w * s[ent]
        uk, inv = torch.unique(keys, return_inverse=True)
        best = torch.zeros(uk.shape[0], dtype=dt, device=dev)
        best.scatter_reduce_(0, inv, vals, "amax", include_self=True)
        perfect = (s[ent].double() > PERFECT_SCORE_CUTOFF)
        if bool(perfect.any()):
            promoted = set()
            for kid in set(keys[perfect].tolist()):
                if self.normalize(self.key_string(kid), upper=False) == q:
                    promoted.add(kid)
            if promoted:
                sel = torch.isin(uk, torch.tensor(sorted(promoted), device=dev))
                best = torch.where(sel, torch.clamp(best, min=PROMOTED_SCORE), best)
        return self._rank(uk, best, limit)

    def _rank(self, keys, score, limit: int):
        """(results, n_top): the keys ranked by score descending, then key
        length, then key id, cut after ``limit`` but carried to the end of
        the cut (score, length) group; n_top = min(limit, number ranked)."""
        if keys.numel() == 0:
            return [], 0
        klen = self.key_len[keys]
        order = torch.argsort(keys, stable=True)
        order = order[torch.argsort(klen[order], stable=True)]
        order = order[torch.argsort(-score[order].float(), stable=True)]
        keys, score, klen = keys[order], score[order].float(), klen[order]
        n = keys.shape[0]
        n_top = n if limit <= 0 else min(limit, n)
        end = n_top
        if end < n:
            same = (score == score[end - 1]) & (klen == klen[end - 1])
            end = int(torch.nonzero(same).max()) + 1
        keys, score, klen = keys[:end].tolist(), score[:end].tolist(), klen[:end].tolist()
        return [(self.key_string(k), s, ln) for k, s, ln in zip(keys, score, klen)], n_top

    def search_many(self, queries, threshold: float, limit: int,
                    score_dtype=torch.float32):
        """The reference's answer to each query: (results, n_top) with
        results [(key, score, key length)] ranked, carried to the end of
        the last (score, length) group, and n_top the number of results
        the library returns.  Every score operation is in ``score_dtype``."""
        if not self.indexed:
            return [([], 0) for _ in queries]
        norm = [self.normalize(q) if (q and q != "*") else "" for q in queries]
        rows = [self.gram_rows(self.query_gram_codes(q)) if len(q) >= self.g
                else torch.zeros(0, dtype=torch.int64, device=self.device) for q in norm]
        nwins = [len(q) - self.g + 1 for q in norm]
        longs = (self._long_scores(rows, nwins, threshold, score_dtype) if self.n_long
                 else [None] * len(queries))
        return [self._search_one(q, threshold, limit, ls, score_dtype)
                for q, ls in zip(queries, longs)]
