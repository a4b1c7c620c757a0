"""Host microseconds per query answered in the traced batches, emitting
results: the self time of the program's ``sslib.emit`` spans (unpacking the
fetched block, the result rows and their key strings)."""

from benchmark import spans


def read(run):
    return spans.per_query(run, ("sslib.emit",))
