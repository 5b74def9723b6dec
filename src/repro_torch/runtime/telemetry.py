"""Ring-buffer telemetry collected at the Python step boundary (the port
of ``repro.runtime.telemetry``).

Timing every call from Python measures only enqueue cost, because CUDA
launches are asynchronous; synchronising after every step would
serialise the host against the device.  ``Telemetry.tick`` threads the
needle: every ``fence_every`` steps it fences (a device synchronise on
the step's output) and attributes the wall time elapsed since the
previous fence evenly across the steps in between.  The fence cost
amortizes to ~1/fence_every and the step itself is never touched.

Collective timings arrive the same way: the controller's comm probe (a
micro-benchmark, an injected synthetic source, or per-bucket samples
attributed from a trace by ``repro_torch.observe.attribution``) hands back
``profiler.CommSample`` batches which are kept in their own ring so the
cost fit always sees a bounded, recent window.  The comm ring is
ordered oldest→newest and — like the step ring — survives
``state_arrays`` round-trips, per-bucket kinds/labels included.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Sequence

import numpy as np

from repro_torch import block_until_ready


@dataclasses.dataclass(frozen=True)
class StepSample:
    """One fenced timing: ``t_step`` seconds/step amortized over the
    ``fenced`` steps dispatched since the previous fence."""
    step: int
    t_step: float
    fenced: int


class Telemetry:
    """Bounded windows of per-step wall times and collective samples."""

    def __init__(self, window: int = 64, fence_every: int = 8,
                 comm_window: int = 256):
        self.window = int(window)
        self.fence_every = max(1, int(fence_every))
        self._steps: collections.deque[StepSample] = \
            collections.deque(maxlen=self.window)
        self._comm: collections.deque = collections.deque(maxlen=comm_window)
        self._last_fence_t: float | None = None
        self._since_fence = 0

    # -- step timings ------------------------------------------------------
    def tick(self, step_no: int, result=None) -> StepSample | None:
        """Record one step boundary; fence + sample every ``fence_every``.

        The first tick only establishes the baseline (step 0's one-time
        costs, kernel builds and allocator warm-up, must not pollute the
        window).  Returns the new
        ``StepSample`` when a fence fired, else None."""
        if self._last_fence_t is None:
            if result is not None:
                block_until_ready(result)
            self._last_fence_t = time.perf_counter()
            self._since_fence = 0
            return None
        self._since_fence += 1
        if self._since_fence < self.fence_every:
            return None
        if result is not None:
            block_until_ready(result)
        now = time.perf_counter()
        sample = StepSample(step=int(step_no),
                            t_step=(now - self._last_fence_t)
                            / self._since_fence,
                            fenced=self._since_fence)
        self._steps.append(sample)
        self._last_fence_t = now
        self._since_fence = 0
        return sample

    def reset_baseline(self) -> None:
        """Drop the fence baseline (e.g. after a step rebuild) so the next
        tick re-baselines instead of recording the rebuild."""
        self._last_fence_t = None
        self._since_fence = 0

    def record_step(self, step_no: int, t_step: float,
                    fenced: int = 1) -> None:
        """Inject a timing directly (restore path / tests)."""
        self._steps.append(StepSample(int(step_no), float(t_step),
                                      int(fenced)))

    def step_samples(self) -> list[StepSample]:
        return list(self._steps)

    def __len__(self) -> int:
        return len(self._steps)

    def median_step_time(self) -> float:
        """Median seconds/step over the window (0.0 when empty)."""
        if not self._steps:
            return 0.0
        ts = sorted(s.t_step for s in self._steps)
        return ts[len(ts) // 2]

    # -- collective samples ------------------------------------------------
    def record_comm(self, samples: Sequence) -> None:
        """Append in the given order: the sequence's last element becomes
        the ring's newest sample."""
        self._comm.extend(samples)

    def comm_samples(self, latest: int | None = None) -> list:
        """Samples ordered oldest-first / **newest-last** — the order they
        were recorded in, so ``comm_samples(latest=n)[-1]`` is always the
        most recent sample.  ``latest`` keeps only the n newest (still
        newest-last).  Pinned by a regression test: attribution windows
        depend on this ordering."""
        out = list(self._comm)
        return out if latest is None else out[-latest:]

    # -- checkpoint round-trip (arrays for ``checkpoint.io``) --------------
    def state_arrays(self) -> dict[str, np.ndarray]:
        comm = list(self._comm)
        return {
            "telemetry/step": np.array([s.step for s in self._steps],
                                       np.int64),
            "telemetry/t_step": np.array([s.t_step for s in self._steps],
                                         np.float64),
            "telemetry/fenced": np.array([s.fenced for s in self._steps],
                                         np.int64),
            # comm ring, oldest-first; kinds/labels as unicode arrays so
            # per-bucket provenance survives the .npz round-trip
            "telemetry/comm_kind": np.array([s.kind for s in comm],
                                            dtype=np.str_),
            "telemetry/comm_nbytes": np.array([s.nbytes for s in comm],
                                              np.float64),
            "telemetry/comm_p": np.array([s.p for s in comm], np.int64),
            "telemetry/comm_t": np.array([s.t for s in comm], np.float64),
            "telemetry/comm_label": np.array(
                [getattr(s, "label", "") for s in comm], dtype=np.str_),
        }

    def load_state_arrays(self, arrays: dict) -> None:
        """Replace the collector's state wholesale — both rings are
        cleared so pre-restore samples (possibly from a different wire
        epoch) cannot mix into the restored window."""
        from repro_torch.autotune.profiler import CommSample
        self._steps.clear()
        self._comm.clear()
        for step, t, f in zip(arrays["telemetry/step"],
                              arrays["telemetry/t_step"],
                              arrays["telemetry/fenced"]):
            self._steps.append(StepSample(int(step), float(t), int(f)))
        if "telemetry/comm_kind" in arrays:   # absent in pre-observe ckpts
            labels = arrays.get("telemetry/comm_label",
                                [""] * len(arrays["telemetry/comm_kind"]))
            for kind, nbytes, p, t, label in zip(
                    arrays["telemetry/comm_kind"],
                    arrays["telemetry/comm_nbytes"],
                    arrays["telemetry/comm_p"],
                    arrays["telemetry/comm_t"], labels):
                self._comm.append(CommSample(kind=str(kind),
                                             nbytes=float(nbytes),
                                             p=int(p), t=float(t),
                                             label=str(label)))
        self._last_fence_t = None  # re-baseline on the next tick
        self._since_fence = 0
