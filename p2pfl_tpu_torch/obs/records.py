"""One timestamped record shape for every outward-flowing row.

The counterpart of ``p2pfl_tpu/obs/records.py``: metrics rows and status
files stamp through :func:`make_record`, so ``ts`` means one thing (epoch
seconds, float, stamped at emission) in every stream.
"""

from __future__ import annotations

import time
from typing import Any


def make_record(node: int | None, **fields: Any) -> dict[str, Any]:
    """Canonical emission record: ``node`` (None = federation-level),
    ``ts`` (epoch seconds at emission), then the caller's fields. A
    caller-supplied ``ts`` in ``fields`` wins, so replayed or merged rows
    keep their original stamp."""
    rec: dict[str, Any] = {"node": node, "ts": time.time()}
    rec.update(fields)
    return rec
