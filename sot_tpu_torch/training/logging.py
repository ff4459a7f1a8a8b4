"""Structured training logs (L5), port of ``sot_tpu/training/logging.py``:
a JSONL file plus a stdout mirror, one line per logged event with a
``split`` and a ``step``. When a wandb run is active (``wandb.init`` called
by the user; wandb is optional and never imported eagerly), scalars are
mirrored there under the same key scheme as the JAX package's.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, Optional


def _wandb_run():
    try:
        import wandb
    except ImportError:
        return None
    return getattr(wandb, "run", None)


class JsonlLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self._fh = open(path, "a") if path else None
        self._echo = echo

    def write(self, record: Dict[str, Any]) -> None:
        record = {k: _jsonable(v) for k, v in record.items()}
        line = json.dumps(record)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._echo:
            print(line, file=sys.stdout, flush=True)
        run = _wandb_run()
        if run is not None:
            split = record.get("split", "train")
            step = record.get("step")
            scalars = {(k if "/" in k else f"{split}_metrics/{k}"): v
                       for k, v in record.items() if isinstance(v, float) and k != "step"}
            run.log(scalars, step=int(step) if step is not None else None)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


def _jsonable(v: Any) -> Any:
    """Anything ``float()`` accepts (a number, a 0-dim tensor or array)
    becomes a float; anything else is kept as it is."""
    try:
        return float(v)
    except (TypeError, ValueError, RuntimeError):
        return v
