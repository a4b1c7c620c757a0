"""Queries: an element of the corpus (any column) drawn uniformly, with
0-2 random edits as ``mutate`` makes them: a frozen copy of the port's
``tools/bench.py`` ``_mutate``."""

import random


def mutate(rng: random.Random, s: str) -> str:
    """0-2 random edits: a substitution, a deletion (keys of more than 4
    characters) or an insertion, of lowercase letters."""
    chars = list(s)
    for _ in range(rng.randint(0, 2)):
        i = rng.randrange(len(chars))
        op = rng.random()
        if op < 0.4:
            chars[i] = rng.choice("abcdefghijklmnopqrstuvwxyz")
        elif op < 0.7 and len(chars) > 4:
            del chars[i]
        else:
            chars.insert(i, rng.choice("abcdefghijklmnopqrstuvwxyz"))
    return "".join(chars)


def draw(words: list, n: int, rng: random.Random) -> list:
    """``n`` queries from ``words`` (the flattened rows), draws from ``rng``."""
    return [mutate(rng, rng.choice(words)) for _ in range(n)]
