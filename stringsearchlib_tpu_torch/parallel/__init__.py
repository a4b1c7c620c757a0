"""Sharded search engines: the term-sharded engine (``dist``), the gram-axis
split (``tp``), their 2-D composition (``dp_tp``) and the multi-process
engine (``multihost``)."""
