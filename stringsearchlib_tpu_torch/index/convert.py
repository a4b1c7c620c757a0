"""An index's state as named numpy arrays, in both directions.

``host_index_from_arrays`` turns an index's state, as numpy, into this
package's ``HostIndex`` on a chosen device; ``arrays_from_host_index`` is
its inverse.  The names are those of the reference's ``.npz`` format
(``stringsearchlib_tpu.index.serialize``, and this package's
``index.serialize``): ``dev_<DeviceIndex field>`` for every device array
plus the host tables; scalars travel in ``meta``.  They let a test (or a
migration) run both packages' engines on one and the same index.

``sharded_index_from_arrays``, ``gram_sharded_index_from_arrays`` and
``dp_tp_index_from_arrays`` do the same for a sharded index's host state:
the reference's ``ShardedIndex`` / ``GramShardedIndex`` / ``DpTpIndex``
leaves (numpy) and scalars, over a converted ``HostIndex``.
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


def arrays_from_host_index(host: HostIndex) -> tuple:
    """The inverse of ``host_index_from_arrays``: (arrays, meta) of
    ``host`` as numpy, under the same names (the reference's ``.npz``
    keys), fetched from the index's device."""
    arrays = {
        f"dev_{f}": getattr(host.device, f).cpu().numpy() for f in FIELDS
    }
    arrays.update(
        gram_ids=host.gram_ids,
        key_tokens=host.key_strings.tokens,
        key_lengths=host.key_strings.lengths,
        host_key_norm_tokens=host.host_key_norm_tokens,
        host_key_norm_lengths=host.host_key_norm_lengths,
        host_key_edge_counts=host.host_key_edge_counts,
    )
    if host.vocab is not None:
        arrays["vocab_codepoints"] = host.vocab.codepoints
    cfg = host.config
    meta = {
        "gram_size": cfg.gram_size,
        "wide": cfg.wide,
        "n_terms": host.n_terms,
        "max_term_len": host.max_term_len,
        "indexed": host.indexed,
        "valid_chars": host.tables.valid_chars,
        "short_pad": cfg.short_pad,
        "long_pad": cfg.long_pad,
        "query_pad": cfg.query_pad,
        "wide_upper": cfg.wide_upper,
    }
    return arrays, meta


def sharded_index_from_arrays(host: HostIndex, leaves: dict, meta: dict,
                              host_shard_posting_lens):
    """This package's ``parallel.dist.ShardedIndex`` over ``host`` from a
    term-sharded index's state as numpy: the reference's
    ``ShardedIndex.leaves`` (every name of ``dist._STACKED`` but ``gm``,
    and ``key_len``), ``meta`` with ``n_shards``, ``ts_c`` and ``tl_c``, and
    its ``host_shard_posting_lens``.  Leaves are copied as they are."""
    from ..parallel.dist import _STACKED, ShardedIndex

    need = [n for n in _STACKED if n != "gm"] + ["key_len"]
    missing = [n for n in need if n not in leaves]
    if missing:
        raise KeyError(f"missing sharded leaves: {missing}")
    s = int(meta["n_shards"])
    bad = [n for n in need if n != "key_len" and np.asarray(leaves[n]).shape[0] != s]
    if bad:
        raise ValueError(f"leaves without a leading dim of {s} shards: {bad}")
    return ShardedIndex(
        host=host,
        n_shards=s,
        ts_c=int(meta["ts_c"]),
        tl_c=int(meta["tl_c"]),
        leaves={n: np.array(leaves[n]) for n in need},
        host_shard_posting_lens=np.array(host_shard_posting_lens, np.int64),
    )


def gram_sharded_index_from_arrays(host: HostIndex, leaves: dict, meta: dict,
                                   host_shard_posting_lens):
    """This package's ``parallel.tp.GramShardedIndex`` over ``host`` from a
    gram-sharded index's state as numpy: the reference's
    ``GramShardedIndex.leaves``, ``meta`` with ``n_shards`` and ``g_c``, and
    its ``host_shard_posting_lens``."""
    from ..parallel.tp import GramShardedIndex

    need = ("gram_ptr", "gram_terms", "short_tokens", "short_lengths",
            "long_tokens", "long_lengths", "term_wmax", "term_extra_ptr",
            "extra_key", "edge_term", "edge_key", "edge_weight", "key_len",
            "pt", "xt")
    missing = [n for n in need if n not in leaves]
    if missing:
        raise KeyError(f"missing gram-sharded leaves: {missing}")
    return GramShardedIndex(
        host=host,
        n_shards=int(meta["n_shards"]),
        g_c=int(meta["g_c"]),
        leaves={n: np.array(leaves[n]) for n in need},
        host_shard_posting_lens=np.array(host_shard_posting_lens, np.int64),
    )


def dp_tp_index_from_arrays(sx, arrays: dict, meta: dict):
    """This package's ``parallel.dp_tp.DpTpIndex`` from a term-sharded
    ``sx`` (``sharded_index_from_arrays``) and the reference's 2-D split:
    ``arrays`` with ``gram_ptr2``, ``gram_terms2`` and ``lens3``, ``meta``
    with ``sg`` and ``g_c``."""
    from ..parallel.dp_tp import DpTpIndex

    missing = [n for n in ("gram_ptr2", "gram_terms2", "lens3") if n not in arrays]
    if missing:
        raise KeyError(f"missing 2-D postings arrays: {missing}")
    return DpTpIndex(
        sx=sx,
        sg=int(meta["sg"]),
        g_c=int(meta["g_c"]),
        gram_ptr2=np.array(arrays["gram_ptr2"], np.int32),
        gram_terms2=np.array(arrays["gram_terms2"], np.int32),
        lens3=np.array(arrays["lens3"], np.int64),
    )
