"""Run logger: screen + Run.out file with a warning registry (JLog2 analog)
and the one-line Run.csv run-results table (JSph::GetResInfo/SaveRes,
JSph.cpp:2962-3006).  Counterpart of
`dualsphysics_multilayer_tpu/utils/log.py`, copied."""

from __future__ import annotations

import os


class RunLog:
    def __init__(self, dirout=None, name="Run.out", echo=True):
        self.echo = echo
        self.warnings = []
        self.files = []
        self.fh = None
        if dirout:
            os.makedirs(dirout, exist_ok=True)
            self.fh = open(os.path.join(dirout, name), "a")

    def print(self, msg):
        if self.echo:
            print(msg)
        if self.fh:
            self.fh.write(msg + "\n")
            self.fh.flush()

    def warning(self, msg):
        self.warnings.append(msg)
        self.print(f"*** WARNING: {msg}")

    def addfile(self, path):
        self.files.append(path)

    def finish(self):
        if self.warnings:
            self.print(f"[WARNINGS] {len(self.warnings)}")
            for w in self.warnings:
                self.print(f"  - {w}")
        if self.fh:
            self.fh.close()


def save_run_csv(dirout, row: dict, name="Run.csv"):
    """Append a one-line-per-run results row (the -svres contract)."""
    os.makedirs(dirout, exist_ok=True)
    path = os.path.join(dirout, name)
    newfile = not os.path.exists(path)
    with open(path, "a") as f:
        if newfile:
            f.write(";".join(row.keys()) + "\n")
        f.write(";".join(str(v) for v in row.values()) + "\n")
    return path
