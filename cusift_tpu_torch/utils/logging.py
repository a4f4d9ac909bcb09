"""Structured metrics logging (twin of `cusift_tpu/utils/logging.py`).

Per-frame SLAM metrics and bench results go to JSONL (one dict a line),
beside standard Python logging with levels.
"""

from __future__ import annotations

import json
import logging
import time

log = logging.getLogger("cusift_tpu_torch")


class JsonlWriter:
    """Append-only JSONL metrics sink with wall-clock stamping."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a", buffering=1)
        self._t0 = time.time()

    def write(self, record: dict):
        rec = dict(record)
        rec.setdefault("t", round(time.time() - self._t0, 4))
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        self._f.close()


def configure(level: str = "INFO"):
    logging.basicConfig(
        level=getattr(logging, level.upper(), logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
