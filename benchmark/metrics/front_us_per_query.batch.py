"""Host microseconds per query answered in the traced batches, in the
front end: the self time of the program's ``sslib.front`` (encode, normalize,
promotion lookup, the split into query-width groups) and ``sslib.prep``
(gram slots, posting mass, promotion tables) spans."""

from benchmark import spans


def read(run):
    return spans.per_query(run, ("sslib.front", "sslib.prep"))
