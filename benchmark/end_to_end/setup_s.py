"""Seconds from before the program is first imported to the first timed
request: the import, kernel loads or builds, ``build_index``, the resident
tables and the warm-up of the cell's own shapes."""


def read(run):
    return run.setup_s
