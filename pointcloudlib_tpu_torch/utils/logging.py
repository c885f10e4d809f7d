"""Structured training logs (counterpart of
``pointcloudlib_tpu/utils/logging.py``): one JSON object per event in
``<log_dir>/<run_name>.jsonl``, as both CLIs write behind ``--log-dir``.
Each record holds ``event``, ``t`` (seconds since the logger was made,
to the millisecond) and the fields; a tensor or numpy scalar is written
as a float."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Optional


class MetricsLogger:
    def __init__(self, log_dir: Optional[str], run_name: str = "train"):
        self._fh = None
        if log_dir:
            path = Path(log_dir)
            path.mkdir(parents=True, exist_ok=True)
            self._fh = open(path / f"{run_name}.jsonl", "a")
        self._t0 = time.time()

    def log(self, event: str, **fields: Any) -> None:
        if self._fh is None:
            return
        rec = {"event": event, "t": round(time.time() - self._t0, 3)}
        rec.update(
            {
                k: (float(v) if hasattr(v, "item") else v)
                for k, v in fields.items()
            }
        )
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
