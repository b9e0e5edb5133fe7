"""Structured JSONL metric stream (a copy of the JAX package's
`utils/logging.py`), replacing the reference's print() + tqdm postfix +
commented-out file write (`train_addvisor.py:385,390-392`)."""

from __future__ import annotations

import json
import os
import time


class JSONLLogger:
    def __init__(self, path: str | None, echo: bool = True):
        self.path = path
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, record: dict) -> None:
        record = {"ts": time.time(), **record}
        line = json.dumps(record, default=float)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self.echo:
            print(line, flush=True)

    __call__ = log
