"""Index persistence: save/load a built HostIndex as one ``.npz`` file.

PyTorch counterpart of ``stringsearchlib_tpu.index.serialize``, in the
reference's format, so each package loads the other's files: numpy
``.npz`` (``np.savez_compressed``, a zip of .npy) with a format-version
guard, every array the engine needs under the same key, config scalars as
0-d int64 arrays, token matrices at their narrowest dtype (byte strings
uint8, wide codepoints uint32; widened to int32 on the device at load).

A load skips normalization, dedup and shingling: for a 10M-key index the
build dominates process start.  The tables a search builds lazily (packed
bitmap, sketch, gram matrix) are not saved; they are rebuilt at first use.
"""

from __future__ import annotations

import io
import os
from typing import Union

import numpy as np
import torch

from .arrays import FIELDS
from .build import HostIndex, default_device
from .convert import arrays_from_host_index, host_index_from_arrays

FORMAT_VERSION = 2  # v2: primary-edge decomposition arrays added

# stored narrow (uint8 / uint32), widened to int32 on device at load
_TOKEN_FIELDS = frozenset({"short_tokens", "long_tokens"})

_Path = Union[str, os.PathLike, io.IOBase]


def save_index(host: HostIndex, path: _Path) -> None:
    """Write every array ``host`` needs to ``path`` (.npz), fetched from
    its device."""
    arrays, meta = arrays_from_host_index(host)
    payload: dict[str, np.ndarray] = {
        "format_version": np.int64(FORMAT_VERSION),
        "gram_size": np.int64(meta["gram_size"]),
        "wide": np.int64(int(meta["wide"])),
        "short_pad": np.int64(meta["short_pad"]),
        "long_pad": np.int64(meta["long_pad"]),
        "query_pad": np.int64(meta["query_pad"]),
        # 0 = "simple" (default), 1 = "c" (ASCII-only towupper parity)
        "wide_upper_c": np.int64(int(meta["wide_upper"] == "c")),
        "valid_chars": np.frombuffer(meta["valid_chars"], dtype=np.uint8),
        "n_terms": np.int64(meta["n_terms"]),
        "max_term_len": np.int64(meta["max_term_len"]),
        "indexed": np.int64(int(meta["indexed"])),
    }
    for k, arr in arrays.items():
        f = k[4:] if k.startswith("dev_") else None
        if f in _TOKEN_FIELDS and arr.size and arr.dtype == np.int32:
            arr = arr.astype(
                np.uint8 if arr.max() < 256 and arr.min() >= 0 else np.uint32
            )
        payload[k] = arr
    np.savez_compressed(path, **payload)


def load_index(path: _Path, device=None) -> HostIndex:
    """Reconstruct a HostIndex saved by :func:`save_index` (or by the
    reference's) with its tensors on ``device``: the CUDA card by default
    (``default_device``, which raises without one), the CPU only when the
    caller passes ``device="cpu"``."""
    device = default_device() if device is None else torch.device(device)
    with np.load(path) as z:
        version = int(z["format_version"])
        if version != FORMAT_VERSION:
            raise ValueError(
                f"unsupported index format version {version} "
                f"(this build reads {FORMAT_VERSION})"
            )
        names = [f"dev_{f}" for f in FIELDS] + [
            "gram_ids", "key_tokens", "key_lengths", "host_key_norm_tokens",
            "host_key_norm_lengths", "host_key_edge_counts",
        ]
        if "vocab_codepoints" in z.files:
            names.append("vocab_codepoints")
        arrays = {k: z[k] for k in names}
        meta = {
            "gram_size": int(z["gram_size"]),
            "wide": bool(int(z["wide"])),
            "n_terms": int(z["n_terms"]),
            "max_term_len": int(z["max_term_len"]),
            "indexed": bool(int(z["indexed"])),
            "valid_chars": z["valid_chars"].tobytes(),
            "short_pad": int(z["short_pad"]),
            "long_pad": int(z["long_pad"]),
            "query_pad": int(z["query_pad"]),
            "wide_upper": (
                "c" if "wide_upper_c" in z.files and int(z["wide_upper_c"])
                else "simple"
            ),
        }
    return host_index_from_arrays(arrays, meta, device)
