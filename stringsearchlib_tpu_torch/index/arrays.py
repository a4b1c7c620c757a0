"""Device-resident index arrays.

PyTorch counterpart of ``stringsearchlib_tpu.index.arrays``: the same fields
with the same dtypes, held as a plain dataclass of tensors on one device
instead of a flax pytree.  Strings are padded token matrices, the posting
index is a CSR over dense gram slots, and the term->key maps are a COO edge
list consumed by segment-max score propagation.

Term index space: short-tier terms occupy [0, n_short), long-tier terms
[n_short, n_short + n_long).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class DeviceIndex:
    """Tensors of one index instance, all on one device."""

    # -- short tier (terms with normalized length < 2*gram_size) ----------
    short_tokens: torch.Tensor  # (Ts, short_pad) uint8 (narrow) / int32 (wide)
    short_lengths: torch.Tensor  # (Ts,) int32

    # -- long tier (rows length-ascending) ----------------------------------
    long_tokens: torch.Tensor  # (Tl, long_pad) uint8 / int32, 0-padded
    long_lengths: torch.Tensor  # (Tl,) int32

    # -- gram postings (CSR over dense gram slots; slots sorted by gram id) --
    gram_ptr: torch.Tensor  # (G + 1,) int32
    gram_terms: torch.Tensor  # (P,) int32 long-tier local ids, sorted per slot

    # -- term -> key edges (COO sorted by (term, key); global term ids) -----
    edge_term: torch.Tensor  # (E,) int32
    edge_key: torch.Tensor  # (E,) int32 in [0, K)
    edge_weight: torch.Tensor  # (E,) float32
    term_edge_ptr: torch.Tensor  # (T + 1,) int32
    term_wmax: torch.Tensor  # (T,) float32
    # primary-edge decomposition: every term's first edge densely, the rest
    # as a small term-keyed CSR
    term_prim_key: torch.Tensor  # (T,) int32, -1 = term has no edges
    term_prim_weight: torch.Tensor  # (T,) float32
    term_extra_ptr: torch.Tensor  # (T + 1,) int32 over the extra edges
    extra_key: torch.Tensor  # (E - T',) int32
    extra_weight: torch.Tensor  # (E - T',) float32
    # key-sorted duplicate of the edges
    key_edge_ptr: torch.Tensor  # (K + 1,) int32
    key_edge_term: torch.Tensor  # (E,) int32
    key_edge_weight: torch.Tensor  # (E,) float32

    # -- keys ---------------------------------------------------------------
    key_len: torch.Tensor  # (K,) int32: raw key string length (sort tiebreak)

    def to(self, device) -> "DeviceIndex":
        """A copy with every tensor on ``device``."""
        return DeviceIndex(
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
            }
        )

    @property
    def device(self) -> torch.device:
        return self.key_len.device

    @property
    def n_short(self) -> int:
        return self.short_tokens.shape[0]

    @property
    def n_long(self) -> int:
        return self.long_tokens.shape[0]

    @property
    def n_terms(self) -> int:
        return self.n_short + self.n_long

    @property
    def n_keys(self) -> int:
        return self.key_len.shape[0]

    @property
    def n_grams(self) -> int:
        return self.gram_ptr.shape[0] - 1


FIELDS = tuple(f.name for f in dataclasses.fields(DeviceIndex))
