"""Index registry: handles, guids, and reader/writer locking.

PyTorch counterpart of ``stringsearchlib_tpu.api.registry``, with its own
copy of the ``RWLock`` (the port imports nothing of the reference).
Mirrors the reference DLL's global state (dllmain.cpp:22-24): a map of
live index instances guarded by a shared mutex - writers are
``indexN``/``dispose`` (unique_lock, dllmain.cpp:39,112), readers
everything else (shared_lock).  Handles are the lowest free integer >= 1;
0 is reserved for failure (dllmain.cpp:41-48).

The README additionally documents guid-string-keyed variants
(Readme.md:31-231); both keying schemes are supported here.  Index state is
immutable once built except setValidChar, which is performed under the
WRITE lock - the DLL mutates it under a shared lock
(dllmain.cpp:147-150), a race not reproduced here.
"""

from __future__ import annotations

import threading
from typing import Optional, Union

from ..index.build import HostIndex
from ..search.engine import SearchEngine


class RWLock:
    """Simple writer-preference reader/writer lock."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self):
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self):
        with self._cond:
            self._writers_waiting += 1
            while self._writer or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = True

    def release_write(self):
        with self._cond:
            self._writer = False
            self._cond.notify_all()

    class _Read:
        def __init__(self, lock):
            self.lock = lock

        def __enter__(self):
            self.lock.acquire_read()

        def __exit__(self, *exc):
            self.lock.release_read()

    class _Write:
        def __init__(self, lock):
            self.lock = lock

        def __enter__(self):
            self.lock.acquire_write()

        def __exit__(self, *exc):
            self.lock.release_write()

    def read(self):
        return RWLock._Read(self)

    def write(self):
        return RWLock._Write(self)


class Entry:
    __slots__ = ("host", "engine")

    def __init__(self, host: HostIndex):
        self.host = host
        self.engine = SearchEngine(host)


class Registry:
    """Process-global registry of live indexes."""

    def __init__(self):
        self.lock = RWLock()
        self._by_handle: dict[int, Entry] = {}
        self._by_guid: dict[str, Entry] = {}

    def register(self, host: HostIndex, guid: Optional[str] = None) -> int:
        entry = Entry(host)
        with self.lock.write():
            if guid is not None:
                self._by_guid[guid] = entry
                return 0
            handle = 1
            while handle in self._by_handle and handle < 2**32 - 1:
                handle += 1
            if handle == 2**32 - 1:
                return 0
            self._by_handle[handle] = entry
            return handle

    def get(self, key: Union[int, str]) -> Optional[Entry]:
        with self.lock.read():
            if isinstance(key, str):
                return self._by_guid.get(key)
            return self._by_handle.get(key)

    def dispose(self, key: Union[int, str]) -> None:
        """Missing keys are ignored (dllmain.cpp:107-114)."""
        with self.lock.write():
            if isinstance(key, str):
                self._by_guid.pop(key, None)
            else:
                self._by_handle.pop(key, None)

    def set_valid_char(self, key: Union[int, str], chars: bytes) -> None:
        # Write lock: this mutates index state (the reference's shared-lock
        # here is a documented race we do not reproduce).
        with self.lock.write():
            entry = (
                self._by_guid.get(key)
                if isinstance(key, str)
                else self._by_handle.get(key)
            )
            if entry is not None:
                entry.host.set_valid_char(chars)

    def clear(self) -> None:
        with self.lock.write():
            self._by_handle.clear()
            self._by_guid.clear()


GLOBAL_REGISTRY = Registry()
