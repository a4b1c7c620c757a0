"""Reference-compatible flat API.

PyTorch counterpart of ``stringsearchlib_tpu.api.capi``: the full
documented DLL surface (Readme.md:25-231) plus the actually-exported
handle-keyed subset (dllmain.cpp:37-151):

  handle-keyed:  indexN, search, score, release, dispose, getSize,
                 getLibSize, setValidChar
  guid-keyed:    index, indexW, index2D, index2DW, searchW, scoreW,
                 releaseW, disposeW, getSizeW, getLibSizeW
  persistence:   saveIndex, loadIndex (the reference's ``.npz`` format)

Quirks preserved:
  * limit == 0 -> unbounded (nGramSearch.hpp:420-421,454-455);
  * missing handle/guid -> 0 results (including the DLL's fall-off-the-end
    UB in score, dllmain.cpp:82-90, defined here as 0);
  * an index built from size < 2 still gets a handle but never matches
    (nGramSearch.hpp:122-123 leaves the object unusable);
  * weight 0 drops the (term, key) pair (nGramSearch.hpp:141-148);
  * ``release`` is a no-op: results are owned Python objects, not pointers
    into stringLib (nGramSearch.hpp:461-468).

Out-parameters in the C signatures become return values: ``search`` returns
the result strings, ``score`` returns (strings, scores).  The functions
that build or load an index take an optional ``device`` keyword: the CUDA
card by default (they raise without one), the CPU only when the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

from ..config import IndexConfig
from ..index.build import build_index
from .registry import GLOBAL_REGISTRY

Key = Union[int, str]


def _build(words, row_size, weight, g_size, wide, device):
    cfg = IndexConfig(gram_size=int(g_size), wide=wide)
    return build_index(words, int(row_size), weight, cfg, device=device)


# -- index construction ----------------------------------------------------


def indexN(
    words: Sequence,
    size: Optional[int] = None,
    rowSize: int = 1,
    weight: Optional[Sequence[float]] = None,
    *,
    device=None,
) -> int:
    """Handle-keyed narrow index (dllmain.cpp:37-49). Returns handle >= 1."""
    if size is not None:
        words = list(words)[: int(size)]
    host = _build(words, rowSize, weight, 3, False, device)
    return GLOBAL_REGISTRY.register(host)


def index(
    guid: str,
    words: Sequence,
    size: Optional[int] = None,
    rowSize: int = 1,
    weight: Optional[Sequence[float]] = None,
    gSize: int = 3,
    *,
    device=None,
) -> None:
    """Guid-keyed narrow index (Readme.md:69-85)."""
    if size is not None:
        words = list(words)[: int(size)]
    GLOBAL_REGISTRY.register(
        _build(words, rowSize, weight, gSize, False, device), guid
    )


def indexW(
    guid: str,
    words: Sequence,
    size: Optional[int] = None,
    rowSize: int = 1,
    weight: Optional[Sequence[float]] = None,
    gSize: int = 3,
    *,
    device=None,
) -> None:
    """Guid-keyed wide (UTF-32) index (Readme.md:91-109)."""
    if size is not None:
        words = list(words)[: int(size)]
    GLOBAL_REGISTRY.register(
        _build(words, rowSize, weight, gSize, True, device), guid
    )


def _flatten_2d(rows, weight):
    """2D rows + per-element weight rows -> flattened 1D model
    (Readme.md:31-43: each row is [key, description, ...])."""
    if not rows:
        return [], None, 0
    row_size = max(len(r) for r in rows)
    flat, flat_w = [], []
    for i, row in enumerate(rows):
        wrow = None if weight is None else weight[i]
        for j in range(row_size):
            flat.append(row[j] if j < len(row) else None)
            if wrow is None:
                flat_w.append(1.0)
            else:
                flat_w.append(float(wrow[j]) if j < len(wrow) else 1.0)
    return flat, (None if weight is None else flat_w), row_size


def _index2d(guid, rows, size, weight, gSize, wide, device) -> None:
    if size is not None:
        rows = list(rows)[: int(size)]
    flat, flat_w, rs = _flatten_2d(list(rows), weight)
    GLOBAL_REGISTRY.register(
        _build(flat, max(rs, 1), flat_w, gSize, wide, device), guid
    )


def index2D(
    guid: str,
    rows: Sequence[Sequence],
    size: Optional[int] = None,
    rowSize: Optional[int] = None,
    weight=None,
    gSize: int = 3,
    *,
    device=None,
) -> None:
    """Guid-keyed narrow 2D index (Readme.md:31-43)."""
    _index2d(guid, rows, size, weight, gSize, False, device)


def index2DW(
    guid: str,
    rows: Sequence[Sequence],
    size: Optional[int] = None,
    rowSize: Optional[int] = None,
    weight=None,
    gSize: int = 3,
    *,
    device=None,
) -> None:
    """Guid-keyed wide 2D index (Readme.md:47-63)."""
    _index2d(guid, rows, size, weight, gSize, True, device)


# -- search ------------------------------------------------------------------


def search(key: Key, query, threshold: float = 0.0, limit: int = 100) -> list:
    """Result strings, best first (dllmain.cpp:61-70 / Readme.md:115-129)."""
    entry = GLOBAL_REGISTRY.get(key)
    if entry is None:
        return []
    results, _ = entry.engine.search(query, threshold, limit)
    return results


def searchW(key: Key, query, threshold: float = 0.0, limit: int = 100) -> list:
    return search(key, query, threshold, limit)


def score(key: Key, query, threshold: float = 0.0, limit: int = 100):
    """(strings, scores) (dllmain.cpp:82-90)."""
    entry = GLOBAL_REGISTRY.get(key)
    if entry is None:
        return [], []
    return entry.engine.search(query, threshold, limit)


def scoreW(key: Key, query, threshold: float = 0.0, limit: int = 100):
    return score(key, query, threshold, limit)


# -- lifetime / introspection -------------------------------------------------


def release(key: Key, results=None, scores=None) -> None:
    """No-op: results are owned Python lists (kept for API compatibility
    with Readme.md:157-176)."""


def releaseW(key: Key, results=None, scores=None) -> None:
    """No-op."""


def dispose(key: Key) -> None:
    GLOBAL_REGISTRY.dispose(key)


def disposeW(key: Key) -> None:
    GLOBAL_REGISTRY.dispose(key)


def getSize(key: Key) -> int:
    """Number of distinct normalized terms (dllmain.cpp:120-127)."""
    entry = GLOBAL_REGISTRY.get(key)
    return 0 if entry is None else entry.host.n_terms


def getSizeW(key: Key) -> int:
    return getSize(key)


def getLibSize(key: Key) -> int:
    """Number of distinct gram hashes (dllmain.cpp:133-140)."""
    entry = GLOBAL_REGISTRY.get(key)
    return 0 if entry is None else entry.host.n_grams


def getLibSizeW(key: Key) -> int:
    return getLibSize(key)


def setValidChar(key: Key, characters, n: Optional[int] = None) -> None:
    """Replace the valid-char set (dllmain.cpp:142-151)."""
    if isinstance(characters, str):
        characters = characters.encode("latin-1")
    if n is not None:
        characters = bytes(characters)[: int(n)]
    GLOBAL_REGISTRY.set_valid_char(key, bytes(characters))


# -- persistence (no DLL equivalent) ------------------------------------------


def saveIndex(key: Key, path) -> bool:
    """Persist a built index's arrays; returns False for a missing handle."""
    from ..index.serialize import save_index

    entry = GLOBAL_REGISTRY.get(key)
    if entry is None:
        return False
    save_index(entry.host, path)
    return True


def loadIndex(path, guid: Optional[str] = None, *, device=None) -> Key:
    """Load a saved index on ``device`` (the card unless ``device="cpu"``);
    returns the new handle, or ``guid`` when given."""
    from ..index.serialize import load_index

    handle = GLOBAL_REGISTRY.register(load_index(path, device=device), guid)
    return guid if guid is not None else handle
