"""Host microseconds per single query answered in the traced window, in the
front end: the self time of the program's ``sslib.front`` and ``sslib.prep``
spans."""

from benchmark import spans


def read(run):
    return spans.per_query(run, ("sslib.front", "sslib.prep"))
