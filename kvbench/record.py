"""What a run hands to the metric readers: the window, the harness's
spans, the counts the drivers keep (jobs, requests, steps, forwards) and
the profiled slice."""

from __future__ import annotations

import dataclasses
from typing import Optional

from kvbench.trace import Profile, Spans


@dataclasses.dataclass
class Record:
    cfg: object
    qcfg: object
    traffic: dict
    seconds: float
    spans: Spans
    on_card: bool = True               # False: a CPU run, no device metric
    family: object = None              # the cell's families/<family>.py
    setup_s: float = float("nan")
    t0: float = float("nan")           # the window's start (perf_counter)
    window_s: float = float("nan")     # the time the window's work took
    jobs: list = dataclasses.field(default_factory=list)
    requests: list = dataclasses.field(default_factory=list)
    steps: list = dataclasses.field(default_factory=list)
    token_times: list = dataclasses.field(default_factory=list)
    # least time (s) of each forward of the window's work
    forwards: list = dataclasses.field(default_factory=list)
    profile: Optional[Profile] = None
    attempted: int = 0
    failed: int = 0
