"""What decides ``correct``: the program's answers against the reference's.

An answer is compared whole: the (score, key length) of every position in
rank order, exactly (scores as float32), and the keys of each (score, key
length) group as a set: the library leaves the order inside a group open.
The last group may be cut by the limit; its keys must then lie in the
reference's whole group.  Each check is a number and its limit; a run is
correct when every number is within its limit.
"""

from __future__ import annotations

import numpy as np


def answer_differs(got, want) -> str | None:
    """None when the program's ``got`` = (keys, scores) equals the
    reference's ``want`` = ([(key, score, key length)] ranked and carried to
    the end of the last group, n_top); else what differs."""
    keys, scores = got
    ranked, n_top = want
    if len(keys) != n_top or len(scores) != n_top:
        return f"{len(keys)} results, the reference {n_top}"
    seq = [(np.float32(s), len(k)) for k, s in zip(keys, scores)]
    ref = [(np.float32(s), n) for _, s, n in ranked[:n_top]]
    for i, (a, b) in enumerate(zip(seq, ref)):
        if a != b:
            return f"position {i}: (score, length) {a}, the reference {b}"
    groups: dict = {}
    for k, s, n in ranked:
        groups.setdefault((np.float32(s), n), set()).add(k)
    i = 0
    while i < len(seq):
        j = i
        while j < len(seq) and seq[j] == seq[i]:
            j += 1
        got_keys = set(keys[i:j])
        if len(got_keys) != j - i:
            return f"positions {i}-{j - 1}: a key repeats"
        extra = got_keys - groups[seq[i]]
        if extra:
            return f"positions {i}-{j - 1}: {sorted(extra)[:3]} not in the reference's group"
        i = j
    return None


def checks(wrong: int, unanswered: int, checked: int, plain_calls: int | None) -> dict:
    """The numbers compared, each with its limit (the order printed)."""
    out = {
        "wrong": {"value": wrong, "limit": 0},
        "unanswered": {"value": unanswered, "limit": 0},
        # a run that checked nothing proves nothing
        "unchecked": {"value": int(checked == 0), "limit": 0},
    }
    if plain_calls is not None:
        out["plain_calls"] = {"value": plain_calls, "limit": 0}
    return out


def passed(chk: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in chk.values())
