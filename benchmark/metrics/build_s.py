"""Seconds of ``build_index`` and the first request, which builds the
resident tables the mix reads, to a synchronize (host clock)."""


def read(run):
    return run.build_s
