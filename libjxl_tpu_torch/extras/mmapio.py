"""Memory-mapped file input (lib/extras/mmap.{h,cc} analog).

The reference tools map input files instead of reading them so large
inputs (multi-GB JPEG/PNG/JXL) never occupy two copies of RAM and the
OS pages data in on demand. `MemoryMappedFile` exposes the same
contract here: a zero-copy read-only buffer over the file, usable
anywhere `bytes` is accepted (BitReader, the JPEG/PNG parsers, the
suspendable decoder's `set_input`).
"""

from __future__ import annotations

import mmap
import os


class MemoryMappedFile:
    """Read-only memory map of a file.

    Use as a context manager or call close(). `view` is a zero-copy
    memoryview; slicing it copies only the slice. Empty files fall back
    to b"" (mmap rejects length-0 maps).
    """

    def __init__(self, path):
        self._fd = os.open(path, os.O_RDONLY)
        try:
            size = os.fstat(self._fd).st_size
            if size == 0:
                self._map = None
                self.view = memoryview(b"")
            else:
                self._map = mmap.mmap(self._fd, size,
                                      prot=mmap.PROT_READ)
                self.view = memoryview(self._map)
        except Exception:
            os.close(self._fd)
            raise

    def __len__(self):
        return len(self.view)

    def __getitem__(self, key):
        return self.view[key]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self):
        if self._fd is not None:
            self.view.release()
            if self._map is not None:
                self._map.close()
            os.close(self._fd)
            self._fd = None
            self._map = None


def read_mapped(path) -> bytes:
    """Map `path` and return an immutable bytes-like view of it.

    Convenience for one-shot decoders: the returned object keeps the
    map alive for its own lifetime (the commonest tool pattern), so the
    caller does not manage a handle. Falls back to a plain read when
    mapping fails (pipes, /proc files)."""
    try:
        m = MemoryMappedFile(path)
    except OSError:
        with open(path, "rb") as f:
            return f.read()
    return _OwningView(m)


class _OwningView(bytes):
    """bytes-compatible object that owns a MemoryMappedFile.

    Subclassing bytes gives full compatibility with every parser in the
    tree (struct.unpack_from, slicing, np.frombuffer); the map is
    released when the object is garbage collected. The bytes payload is
    materialized lazily per-slice by the parsers — the initial copy is
    unavoidable for bytes subclasses, so for true zero-copy use
    MemoryMappedFile.view directly.
    """

    def __new__(cls, mapped: MemoryMappedFile):
        obj = super().__new__(cls, mapped.view)
        obj._mapped = mapped
        return obj

    def __del__(self):
        try:
            self._mapped.close()
        except Exception:
            pass
