"""Product descriptions: 3-10 words (~29 characters, ASCII), each drawn
from one fixed vocabulary of 8,192 word-like tokens by a Zipf-Mandelbrot law
(rank r with weight 1 / (r + 2.7), the fit to English word counts), so a
few words recur across most rows and most words are rare, as in text; the
shorter a word, the more frequent (ranks follow length).

No public corpus of product descriptions is in the repository; the shape
(word lengths, the law, the length of a row) is this file's own.  The
vocabulary is the same for every seed; ``seed`` draws the rows.
"""

import random

import numpy as np

_ONSETS = ["", "b", "c", "d", "f", "g", "h", "k", "l", "m", "n", "p", "r", "s", "t",
           "v", "w", "br", "cl", "dr", "fl", "gr", "pl", "pr", "sh", "st", "th", "tr"]
_VOWELS = ["a", "e", "i", "o", "u", "ea", "ou", "ai"]
_CODAS = ["", "", "", "n", "r", "s", "t", "l", "m", "nd", "st", "ng", "ck"]
VOCABULARY = 8192
MIN_WORDS, MAX_WORDS = 3, 10


def vocabulary() -> list:
    """The fixed vocabulary, most frequent first: words of 1-3 syllables
    (onset, vowel, coda), shortest first."""
    rng = random.Random(0)
    words, seen = [], set()
    while len(words) < VOCABULARY:
        n = rng.choices((1, 2, 3), (0.5, 0.35, 0.15))[0]
        w = "".join(rng.choice(_ONSETS) + rng.choice(_VOWELS) + rng.choice(_CODAS)
                    for _ in range(n))
        if len(w) >= 2 and w not in seen:
            seen.add(w)
            words.append(w)
    return sorted(words, key=len)


def make(n: int, seed: int) -> list:
    """``n`` descriptions from ``seed``."""
    vocab = np.array(vocabulary())
    p = 1.0 / (np.arange(1, VOCABULARY + 1) + 2.7)
    rng = np.random.default_rng(seed)
    lens = rng.integers(MIN_WORDS, MAX_WORDS + 1, n)
    ends = np.cumsum(lens)
    tokens = vocab[rng.choice(VOCABULARY, int(ends[-1]) if n else 0, p=p / p.sum())].tolist()
    return [" ".join(tokens[e - k: e]) for e, k in zip(ends.tolist(), lens.tolist())]
