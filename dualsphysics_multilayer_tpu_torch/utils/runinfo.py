"""Run summary channel (Run.csv) + TERMINATE-file polling.

Counterpart of `dualsphysics_multilayer_tpu/utils/runinfo.py` (reference
`JSph::GetResInfo/SaveRes`, JSph.cpp:2962-3006): one CSV row per run
appended to Run.csv with the same column ontology, and
`JSph::CheckTermination` (JSph.cpp:2796-2820): a `TERMINATE` file in the
output directory ends the run early (optionally carrying a new tmax as its
text content).  The ``Hardware`` column names the card the run used, or
``cpu``.  ``MeanValue`` is the running min/max/mean of a sampled quantity.
"""

from __future__ import annotations

import datetime
import os

import torch


def hardware(device) -> str:
    """``torch.cuda.get_device_name`` of a CUDA ``device``, or ``cpu``."""
    device = torch.device(device)
    return "cpu" if device.type == "cpu" else torch.cuda.get_device_name(device)


def save_res(dirout, *, runname, appname, casenp, tsim, ttot, timestep,
             nstep, part, nout, maxparticles, maxcells, nbound, nfixed,
             dp, kernelh, device, pips_gpips="", runmode="", configinfo="",
             csvsep=";"):
    """Append one summary row to Run.csv (SaveRes, JSph.cpp:2989);
    ``device`` is the device the run used (:func:`hardware`)."""
    hinfo = ("#RunName;Rcode-VersionInfo;DateTime;Np;TSimul;TSeg;TTotal;"
             "MemCpu;MemGpu;Steps;GPIPS;PhysicalTime;PartFiles;PartsOut;"
             "MaxParticles;MaxCells;Hardware;RunMode;Configuration;"
             "Nbound;Nfixed;Dp;H")
    row = [runname, appname,
           datetime.datetime.now().isoformat(" ")[:19], casenp,
           f"{tsim:g}", f"{(tsim / timestep if timestep else 0):g}",
           f"{ttot:g}", 0, 0, nstep, pips_gpips, f"{timestep:.9g}", part,
           nout, maxparticles, maxcells, hardware(device), runmode,
           configinfo, nbound, nfixed, f"{dp:g}", f"{kernelh:g}"]
    path = os.path.join(dirout, "Run.csv")
    new = not os.path.exists(path)
    with open(path, "a") as f:
        if new:
            f.write(hinfo.replace(";", csvsep) + "\n")
        f.write(csvsep.join(str(x) for x in row) + "\n")
    return path


class TerminateCheck:
    """Polls <dirout>/TERMINATE; returns a new tmax (0.0 = stop now) when
    the file appears or changes (JSph::CheckTermination)."""

    def __init__(self, dirout):
        self.path = os.path.join(dirout, "TERMINATE")
        self.mtime = self._mt()

    def _mt(self):
        try:
            return os.stat(self.path).st_mtime_ns
        except OSError:
            return 0

    def poll(self):
        mt = self._mt()
        if mt and mt != self.mtime:
            self.mtime = mt
            try:
                with open(self.path) as f:
                    txt = f.read(127).strip()
                return float(txt) if txt else 0.0
            except (OSError, ValueError):
                return 0.0
        return None


class MeanValue:
    """Running min/max/mean accumulator (reference JMeanValue,
    `JMeanValues.h:40-59`; JAX ``runinfo.MeanValue``): a one-line summary
    of a sampled quantity."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.max = float("-inf")
        self.min = float("inf")
        self.mean = 0.0
        self.values = 0

    def add(self, v):
        v = float(v)
        self.max = max(self.max, v)
        self.min = min(self.min, v)
        self.mean = (self.mean * self.values + v) / (self.values + 1)
        self.values += 1
