"""Product names: brand, 2-4 syllables, kind and a number (~22.7
characters, ASCII).  A frozen copy of the port's ``tools/bench.py``
``_product_names``, kept here so that a change to the program cannot change
the yardstick."""

import numpy as np

_SYLLABLES = [
    "al", "an", "ar", "ba", "be", "co", "da", "de", "el", "en", "er", "fa",
    "ga", "gi", "go", "ha", "in", "ka", "la", "le", "li", "lo", "ma", "me",
    "mi", "mo", "na", "ne", "no", "or", "pa", "pe", "po", "ra", "re", "ri",
    "ro", "sa", "se", "si", "so", "ta", "te", "ti", "to", "ur", "va", "ve",
    "vi", "zo",
]
_BRANDS = ["acme", "orion", "zenix", "nova", "apex", "volt", "lumen", "aero"]
_TYPES = ["widget", "sensor", "valve", "motor", "panel", "cable", "filter"]


def make(n: int, seed: int) -> list:
    """``n`` product names from ``seed``, built with vectorized numpy string
    ops."""
    rng = np.random.default_rng(seed)
    brands = rng.choice(_BRANDS, n)
    kinds = rng.choice(_TYPES, n)
    nums = rng.integers(1, 10000, n).astype("U4")
    nsyl = rng.integers(2, 5, n)
    syl = rng.choice(_SYLLABLES, (n, 4)).astype("U2")
    for j in (2, 3):
        syl[nsyl <= j, j] = ""
    word = np.char.add(np.char.add(syl[:, 0], syl[:, 1]),
                       np.char.add(syl[:, 2], syl[:, 3]))
    sp = np.full(n, " ", dtype="U1")
    out = np.char.add(np.char.add(np.char.add(brands, sp), word), sp)
    out = np.char.add(np.char.add(np.char.add(out, kinds), sp), nums)
    return out.tolist()
