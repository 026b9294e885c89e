"""Atomic file publication (the counterpart of ``p2pfl_tpu/utils/fsio.py``).

A file another process tails live (a status record, the topology map)
must never be seen empty or half-written: write a ``tmp`` sibling in the
same directory, fsync it, then ``os.replace`` it onto the published name,
which POSIX makes atomic within a filesystem.
"""

from __future__ import annotations

import os
import pathlib


def atomic_write_bytes(path: pathlib.Path, data: bytes) -> None:
    path = pathlib.Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def atomic_write_text(path: pathlib.Path, text: str,
                      encoding: str = "utf-8") -> None:
    atomic_write_bytes(path, text.encode(encoding))
