"""Profiling (counterpart of ns2vc_tpu/utils/profiling.py).

- `trace(logdir)`: context manager around `torch.profiler` (the host's
  ops and, on a card, its kernels), the trace written as a Chrome trace
  into `logdir` (open in chrome://tracing or Perfetto);
- `annotate(name)`: a named region on the trace's timeline
  (`torch.profiler.record_function`);
- Trainer integration: NS2VC_PROFILE_AT=<start_step>:<num_steps> (e.g.
  100:5) traces steps 100..104 of a training run into the run dir's
  `profile/` (`Trainer.train`).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class Window:
    """A trace opened by `start` and written by `stop` into `logdir` as
    `trace_<pid>_<ms since the epoch>.json`; `stop` returns its path."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self._prof = None

    @property
    def open(self) -> bool:
        return self._prof is not None

    def start(self) -> None:
        self._prof = torch.profiler.profile(activities=_activities())
        self._prof.start()

    def stop(self) -> str:
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self.logdir, exist_ok=True)
        path = os.path.join(self.logdir, f"trace_{os.getpid()}_"
                            f"{int(time.time() * 1e3)}.json")
        prof.export_chrome_trace(path)
        return path


@contextlib.contextmanager
def trace(logdir: str):
    window = Window(logdir)
    window.start()
    try:
        yield
    finally:
        window.stop()


def annotate(name: str):
    """Named trace region: `with annotate('sampler'): ...`."""
    return torch.profiler.record_function(name)


def profile_window_from_env() -> tuple[int, int] | None:
    """Parse NS2VC_PROFILE_AT='<start_step>:<num_steps>'."""
    spec = os.environ.get("NS2VC_PROFILE_AT")
    if not spec:
        return None
    try:
        start, num = spec.split(":")
        return int(start), int(num)
    except ValueError:
        print(f"ignoring malformed NS2VC_PROFILE_AT={spec!r}")
        return None
