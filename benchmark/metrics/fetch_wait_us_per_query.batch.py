"""Host microseconds per query answered in the traced batches spent in the
program's ``sslib.fetch`` spans: the one device-to-host copy of a pass,
where the host waits for the work it queued."""

from benchmark import spans


def read(run):
    return spans.per_query(run, ("sslib.fetch",))
