"""The share of query rows whose first candidate pass met the exactness
guard: 1 - (``retry_fast`` summed) / (``n_items`` summed) over the traced
requests, from ``SearchEngine.last_routing`` after each."""


def read(run):
    rows = retried = 0
    for _, routing in run.window.requests:
        if "n_items" in routing and "retry_fast" in routing:
            rows += int(routing["n_items"])
            retried += int(routing["retry_fast"])
    return 100.0 * (1.0 - retried / rows) if rows else None
