"""Host microseconds per query answered in the traced batches, enqueueing
device work: the self time of the program's ``sslib.dispatch`` spans (the
uploads, the kernel launches and the torch ops that queue them)."""

from benchmark import spans


def read(run):
    return spans.per_query(run, ("sslib.dispatch",))
