"""Device-memory capacity planning for term-sharded indexes (the 100M-key
multi-card configuration).

PyTorch counterpart of ``stringsearchlib_tpu.utils.capacity``, with the same
byte model.  The resident footprint is flat arrays, so capacity is
predictable: ``estimate_shard_hbm`` computes the per-card resident bytes of
one term shard (parallel.dist: terms strided over shards, queries
replicated) plus the per-batch working set.  ``device_hbm_bytes`` reads a
card's memory; ``H100_HBM_BYTES`` is that of an NVIDIA H100 80GB HBM3 as
``torch.cuda.get_device_properties(...).total_memory`` reports it, for
planning without a card.  tests/test_torch_capacity.py pins the 100M plan on
that card.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Per-card resident + working bytes for one term shard."""

    n_keys: int
    shards: int
    tokens: int
    lengths: int
    postings_csr: int
    edges: int
    prim_records: int
    bitmap: int
    batch_workspace: int

    @property
    def resident(self) -> int:
        return (
            self.tokens + self.lengths + self.postings_csr + self.edges
            + self.prim_records + self.bitmap
        )

    @property
    def total(self) -> int:
        return self.resident + self.batch_workspace

    def breakdown(self) -> dict:
        gb = 1 / (1 << 30)
        return {
            "tokens_gb": round(self.tokens * gb, 2),
            "lengths_gb": round(self.lengths * gb, 2),
            "postings_csr_gb": round(self.postings_csr * gb, 2),
            "edges_gb": round(self.edges * gb, 2),
            "prim_records_gb": round(self.prim_records * gb, 2),
            "bitmap_gb": round(self.bitmap * gb, 2),
            "batch_workspace_gb": round(self.batch_workspace * gb, 2),
            "total_gb": round(self.total * gb, 2),
        }


def estimate_shard_hbm(
    n_keys: int,
    *,
    shards: int = 1,
    avg_len: int = 22,
    n_grams: int = 2816,
    gram_size: int = 3,
    keys_per_term: float = 1.0,
    batch: int = 256,
    top_k: int = 128,
) -> ShardPlan:
    """Per-card byte estimate for a term-sharded gram-dense index.

    Components mirror what parallel.dist uploads per shard (leaves in
    dist._STACKED) and what the bitmap-kernel candidate path allocates per
    batch (hits (B, Tl_c) int8 + rescore buffers):

      tokens        uint8 (Tl_c, pad(avg_len)) long-tier matrix
      postings_csr  int32 gram_terms (~windows per key) + gram_ptr
      edges         edge (term,key,weight) triples, int32/f32
      prim_records  4-wide int32 [key, weight, key_len, 0] rows
      bitmap        packed (G_pad, Tl_c_pad/8) incidence planes
      workspace     per-batch hits + selection + edge-expansion buffers
    """
    from ..ops.bitmap_matmul import PAD_LANES, g_padding

    tl_c = -(-n_keys // shards)
    tl_c_pad = -(-max(tl_c, 1) // PAD_LANES) * PAD_LANES
    g_pad = g_padding(n_grams)
    width = -(-max(avg_len, gram_size) // 8) * 8
    windows = max(avg_len - gram_size + 1, 1)
    n_edges = int(n_keys * keys_per_term) // shards

    tokens = tl_c * width  # uint8 on device
    lengths = tl_c * 4
    postings = tl_c * windows * 4 + (n_grams + 1) * 4
    edges = n_edges * 12
    prim = tl_c * 16
    bitmap = g_pad * (tl_c_pad // 8)
    workspace = (
        batch * tl_c_pad  # int8 hits
        + batch * 1024 * 128 * 5  # kept-lane rescore (f32 u/s + gather)
        + batch * 16384 * 24  # edge expansion lanes
        + batch * top_k * 16
        + (64 << 20)  # scratch / fragmentation allowance
    )
    return ShardPlan(
        n_keys=n_keys, shards=shards, tokens=tokens, lengths=lengths,
        postings_csr=postings, edges=edges, prim_records=prim,
        bitmap=bitmap, batch_workspace=workspace,
    )


def device_hbm_bytes(device=None) -> int:
    """Total memory of a CUDA card (the current one by default)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: use H100_HBM_BYTES to plan")
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None else device
    return int(torch.cuda.get_device_properties(dev).total_memory)


# one NVIDIA H100 80GB HBM3, as total_memory reports it (chip_smoke.py
# phase 24 prints the card's value)
H100_HBM_BYTES = 85_017_493_504
