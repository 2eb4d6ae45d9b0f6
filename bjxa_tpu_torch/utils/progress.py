"""Restartable-progress manifest for corpus jobs.

The reference's closest analog is its in-codec progress countdown
(``src/libbjxa.c:654-657``) making conversion resumable block-by-block;
at corpus scale the unit of restart is the file: a JSONL manifest records
every completed output with its content digest, and a resumed run skips
anything already recorded (per-host, so multi-host corpus runs shard the
manifest naturally).
"""

from __future__ import annotations

import json
import os
import pathlib


class Manifest:
    """Append-only JSONL completion log with atomic-ish appends."""

    def __init__(self, path: str | os.PathLike):
        self.path = pathlib.Path(path)
        self._done: dict[str, dict] = {}
        if self.path.exists():
            for line in self.path.read_text().splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail write from a crashed run
                self._done[rec["key"]] = rec

    def is_done(self, key: str) -> bool:
        return key in self._done

    def record(self, key: str, **info) -> None:
        rec = {"key": key, **info}
        self._done[key] = rec
        with self.path.open("a+b") as f:
            # a torn tail from a crashed run must not swallow this record:
            # terminate any unterminated final line first
            if f.tell() > 0:
                f.seek(-1, os.SEEK_END)
                if f.read(1) != b"\n":
                    f.write(b"\n")
            f.write((json.dumps(rec) + "\n").encode())
            f.flush()
            os.fsync(f.fileno())

    def __len__(self) -> int:
        return len(self._done)
