"""A cell's job: the mix's "kind" names `portbench/kinds/<kind>.py`,
found by name, whose `Job` runs one job through the port's public API,
reads it out, and holds what the timed path produced against the
reference. A kind's Job has:

  work          the counted work of one job (portbench/counting.py)
  build()       the program, built once in set-up (plan_ms times it)
  start()       the register, made once in set-up
  job(keep)     one job: reset, application, a readout that ends in a
                host value (so each job ends synchronised); `phase(name)`
                marks its parts in a traced run
  probes()      readings taken after a traced window, by metric name
  output()      what the timed path produced; the program is dropped
  control_output(jobs)  the reference at CONTROL precision in the
                program's place, read out as `jobs` jobs would be
  compare(out)  the numbers compared with their limits, by name

The port is imported only inside the methods, after the run has set the
cache directories.
"""

from __future__ import annotations

import contextlib

import torch

from portbench import byname
from portbench.reference import circuits as R


class Job:
    """What every kind shares: its readouts and its phase marker."""

    def __init__(self):
        self.records = []
        self.phase = lambda name: contextlib.nullcontext()

    def probes(self) -> dict:
        return {}


def rel_l2(state: torch.Tensor, truth: torch.Tensor) -> float:
    """||state - truth|| / ||truth|| in float64; `state` complex or the
    port's (2, ...) real planes, a chunk at a time."""
    flat = truth.reshape(-1)
    planes = None if state.is_complex() else state.reshape(2, -1)
    num = torch.zeros((), dtype=torch.float64, device=flat.device)
    den = torch.zeros((), dtype=torch.float64, device=flat.device)
    for s in range(0, flat.numel(), R.CHUNK):
        t = flat[s:s + R.CHUNK].to(torch.complex128)
        if planes is None:
            x = state.reshape(-1)[s:s + R.CHUNK].to(t.device, torch.complex128)
        else:
            x = torch.complex(planes[0, s:s + R.CHUNK].to(t.device, torch.float64),
                              planes[1, s:s + R.CHUNK].to(t.device, torch.float64))
        num += ((x - t).abs() ** 2).sum()
        den += (t.abs() ** 2).sum()
    return float(torch.sqrt(num / den))


def engine(config: dict):
    """The configuration's engine, `portbench/engines/<engine>.py`."""
    return byname.module("engines", config["engine"])


def make(config: dict, mix: dict, seed: int, device) -> Job:
    """The Job of the mix's kind for this configuration and seed."""
    return byname.module("kinds", mix["kind"]).Job(config, mix, seed, device)
