"""The benchmark's corpora, from ``--seed``.

A configuration's ``corpus`` names its columns; each column is made by
``benchmark/columns/<name>.py`` (``make(n, seed) -> list of str``), found
by name, so a new column is a new file.
"""

from __future__ import annotations

import numpy as np

from . import spec


def substream(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream of a run, from ``--seed`` (any integer;
    taken modulo 2**64) and the stream's tags, so the corpus, the warm-up
    and the window's queries never share draws."""
    ss = np.random.SeedSequence([seed % 2**64, *tags])
    return int(ss.generate_state(1, np.uint64)[0] >> 1)


def make_corpus(corpus: dict, seed: int, n_rows: int | None = None, root: str = spec.ROOT):
    """(flat words, row_size, weights or None) for a configuration's
    ``corpus``: ``n_rows`` rows (the configuration's unless given), one
    column per name in ``columns``, flattened row by row as the library's
    ``indexN`` takes them; ``weights`` repeats per row."""
    n = int(corpus["n_rows"] if n_rows is None else n_rows)
    cols = [spec.part(root, "columns", name).make(n, seed=substream(seed, 1, c))
            for c, name in enumerate(corpus["columns"])]
    row_size = len(cols)
    words = cols[0] if row_size == 1 else [x for row in zip(*cols) for x in row]
    weights = corpus.get("weights")
    if weights is not None:
        if len(weights) != row_size:
            raise ValueError("corpus weights must give one weight per column")
        weights = np.tile(np.asarray(weights, np.float64), n)
    return words, row_size, weights
