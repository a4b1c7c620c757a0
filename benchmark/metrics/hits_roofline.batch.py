"""K1's share of its roofline over the traced batches: the least time the
card could take to count the batches' gram hits, over the device time of
the hit-counting kernels named below.

The bound reads the same work whatever implements it: for each distinct
gram of a batch that the corpus holds, its incidence row, one bit per
indexed (long-tier) term, read once, at 3.35 TB/s (``bounds.hits_bytes``).
The grams and the terms are counted by the reference's own gram code.  On
an exact incidence with no hashing no real read is smaller, so the share
cannot pass 100%; a change that skips table bits (block pruning) brings its
own benchmark correction.
"""

import torch

from benchmark import bounds

# the instantiations of csrc/bitmap_hits.cu's K1 (block maxima: the <true>
# instance), demangled and mangled, tile-major and row-major
KERNELS = ("bitmap_hits_kernel<true>", "bitmap_hits_rowmajor_kernel<true>",
           "bitmap_hits_kernelILb1E", "bitmap_hits_rowmajor_kernelILb1E")


def read(run):
    t, ref = run.trace, run.reference
    if t is None or ref is None:
        return None
    k1 = sum(b - a for a, b, name in t.device if any(k in name for k in KERNELS)) / 1e6
    if k1 <= 0:
        return None
    need = 0.0
    for queries, _ in run.window.requests:
        codes = [ref.query_gram_codes(ref.normalize(q)) for q in queries]
        rows = ref.gram_rows(torch.cat(codes)) if codes else torch.zeros(0)
        need += bounds.bytes_bound(bounds.hits_bytes(int(torch.unique(rows).numel()), ref.n_long))
    return 100.0 * need / k1
