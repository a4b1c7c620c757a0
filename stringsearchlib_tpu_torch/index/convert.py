"""An index's state carried across from the JAX package.

``host_index_from_arrays`` turns the reference's index state, fetched as
numpy, into this package's ``HostIndex`` on a chosen device.  It lets a
test (or a migration) run both engines on one and the same index.  The
array names are those of the reference's ``.npz`` format
(``stringsearchlib_tpu.index.serialize``): ``dev_<DeviceIndex field>`` for
every device array plus the host tables; scalars travel in ``meta``.
"""

from __future__ import annotations

import numpy as np

from ..config import DEFAULT_VALID_CHARS, IndexConfig
from ..core import grams as gramlib
from ..core import text as textlib
from .arrays import FIELDS, DeviceIndex
from .build import HostIndex, KeyStrings, to_tensor, to_token_tensor

_TOKEN_FIELDS = frozenset({"short_tokens", "long_tokens"})

HOST_ARRAYS = (
    "gram_ids", "key_tokens", "key_lengths", "host_key_norm_tokens",
    "host_key_norm_lengths", "host_key_edge_counts",
)


def host_index_from_arrays(arrays: dict, meta: dict, device) -> HostIndex:
    """HostIndex on ``device`` from the reference's arrays.

    ``arrays``: ``dev_<field>`` for each DeviceIndex field, and
    ``gram_ids``, ``key_tokens``, ``key_lengths``, ``host_key_norm_tokens``,
    ``host_key_norm_lengths``, ``host_key_edge_counts``; optionally
    ``vocab_codepoints`` (wide gram_size 4).
    ``meta``: ``gram_size``, ``wide``, ``n_terms``, ``max_term_len``,
    ``indexed``; optionally ``valid_chars`` (bytes), ``short_pad``,
    ``long_pad``, ``query_pad``, ``wide_upper``.
    """
    missing = [
        k for k in [f"dev_{f}" for f in FIELDS] + list(HOST_ARRAYS)
        if k not in arrays
    ]
    if missing:
        raise KeyError(f"missing index arrays: {missing}")
    base = IndexConfig()
    cfg = IndexConfig(
        gram_size=int(meta["gram_size"]),
        wide=bool(meta["wide"]),
        short_pad=int(meta.get("short_pad", base.short_pad)),
        long_pad=int(meta.get("long_pad", base.long_pad)),
        query_pad=int(meta.get("query_pad", base.query_pad)),
        wide_upper=str(meta.get("wide_upper", base.wide_upper)),
    )
    valid_chars = bytes(meta.get("valid_chars", DEFAULT_VALID_CHARS))
    tables = textlib.TextTables(
        valid_chars, wide=cfg.wide, wide_upper=cfg.wide_upper
    )
    di = DeviceIndex(
        **{
            f: (
                to_token_tensor(arrays[f"dev_{f}"], device)
                if f in _TOKEN_FIELDS
                else to_tensor(arrays[f"dev_{f}"], device)
            )
            for f in FIELDS
        }
    )
    vocab = None
    if "vocab_codepoints" in arrays:
        vocab = gramlib.WideVocab(np.asarray(arrays["vocab_codepoints"]))
    kew = np.asarray(arrays["dev_key_edge_weight"])
    return HostIndex(
        config=cfg,
        tables=tables,
        key_strings=KeyStrings(
            np.asarray(arrays["key_tokens"]),
            np.asarray(arrays["key_lengths"]),
            cfg.wide,
        ),
        gram_ids=np.asarray(arrays["gram_ids"], np.int64),
        device=di,
        n_terms=int(meta["n_terms"]),
        max_term_len=int(meta["max_term_len"]),
        vocab=vocab,
        indexed=bool(meta["indexed"]),
        host_posting_lens=np.diff(
            np.asarray(arrays["dev_gram_ptr"])
        ).astype(np.int64),
        host_key_norm_tokens=np.asarray(arrays["host_key_norm_tokens"]),
        host_key_norm_lengths=np.asarray(
            arrays["host_key_norm_lengths"], np.int32
        ),
        host_key_edge_counts=np.asarray(
            arrays["host_key_edge_counts"], np.int32
        ),
        host_long_lengths=np.asarray(arrays["dev_long_lengths"], np.int32),
        host_key_edge_ptr=np.asarray(arrays["dev_key_edge_ptr"]),
        host_key_edge_term=np.asarray(arrays["dev_key_edge_term"]),
        host_key_edge_weight=kew,
        uniform_weights=bool(kew.size == 0 or np.all(kew == 1.0)),
    )
