"""The benchmark's plain reference (``index.ReferenceIndex``) and the frozen
oracle that checks it (``oracle.OracleIndex``).  Neither imports the
program or the JAX package."""
