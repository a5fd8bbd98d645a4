"""Fault tolerance for long training runs: bad-step containment,
straggler detection, periodic checkpoints and elastic re-mesh restore
(port of ``repro.dist.fault``).

The Supervisor wraps the train step.  A step whose loss is non-finite is
*contained*: its state update is dropped and the run continues; too many
consecutive bad steps abort the run (the data or the optimizer is
broken, not one batch).  Step durations are tracked against their
running median to flag stragglers in the event log.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.tree import tree_leaves

_MIN_HISTORY = 5          # steps before straggler detection engages
_ABS_FLOOR_S = 0.01       # ignore sub-10ms jitter


@dataclasses.dataclass
class FaultConfig:
    max_consecutive_bad: int = 3
    straggler_factor: float = 3.0      # x median duration; 0 disables
    ckpt_dir: str = ""
    ckpt_every: int = 50


@dataclasses.dataclass
class StepReport:
    loss: float
    duration: float
    skipped: bool = False
    straggler: bool = False


class Supervisor:
    def __init__(self, cfg: FaultConfig | None = None):
        self.cfg = cfg or FaultConfig()
        self.events: list[str] = []
        self._consecutive_bad = 0
        self._durations: list[float] = []
        self._writer = None                 # the async save in flight

    # -- stepping ----------------------------------------------------------
    def run_step(self, step_fn, state, batch, step: int):
        """Execute one supervised step -> (state, StepReport).

        A non-finite loss drops the update (the old state is returned);
        the ``max_consecutive_bad``-th such step in a row raises
        RuntimeError.  (A donating step of ``launch.steps`` writes
        ``state`` in place only when the loss is finite.)"""
        t0 = time.monotonic()
        new_state, loss = step_fn(state, batch)
        loss_f = float(loss)               # waits for the step to finish
        dur = time.monotonic() - t0

        straggler = False
        if self.cfg.straggler_factor and len(self._durations) >= _MIN_HISTORY:
            med = statistics.median(self._durations)
            if dur > self.cfg.straggler_factor * med and \
                    dur - med > _ABS_FLOOR_S:
                straggler = True
                self.events.append(
                    f"step {step}: straggler ({dur:.3f}s vs median "
                    f"{med:.3f}s)")
        self._durations.append(dur)
        if len(self._durations) > 64:
            del self._durations[0]

        if not math.isfinite(loss_f):
            self._consecutive_bad += 1
            self.events.append(f"step {step}: bad loss ({loss_f}), "
                               f"update dropped")
            if self._consecutive_bad >= self.cfg.max_consecutive_bad:
                raise RuntimeError(
                    f"{self._consecutive_bad} consecutive bad steps "
                    f"(last loss {loss_f} at step {step})")
            return state, StepReport(loss=loss_f, duration=dur, skipped=True,
                                     straggler=straggler)

        self._consecutive_bad = 0
        return new_state, StepReport(loss=loss_f, duration=dur,
                                     straggler=straggler)

    # -- checkpoints -------------------------------------------------------
    def maybe_restore(self, state):
        """(state, start_step): resume from the latest checkpoint if any,
        onto the device ``state`` lives on."""
        if not self.cfg.ckpt_dir:
            return state, 0
        latest = ckpt.latest_step(self.cfg.ckpt_dir)
        if latest is None:
            return state, 0
        restored, step = ckpt.restore(self.cfg.ckpt_dir, state,
                                      device=tree_leaves(state)[0].device)
        self.events.append(f"restored checkpoint at step {step}")
        return restored, step + 1

    def _join(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None

    def maybe_save(self, state, step: int):
        if self.cfg.ckpt_dir and self.cfg.ckpt_every and step > 0 \
                and step % self.cfg.ckpt_every == 0:
            self._join()                    # one writer of LATEST at a time
            self._writer = ckpt.save(state, self.cfg.ckpt_dir, step=step,
                                     async_=True)

    def finalize(self, state, step: int):
        self._join()
        if self.cfg.ckpt_dir:
            ckpt.save(state, self.cfg.ckpt_dir, step=step)


def remesh(directory: str, like, new_mesh, shardings_fn):
    """Elastic restore: load a checkpoint onto a *different* mesh.

    ``shardings_fn(like, mesh)`` rebuilds the sharding tree for the
    surviving ranks, so a run that lost hosts resumes on what is left."""
    shardings = shardings_fn(like, new_mesh)
    return ckpt.restore(directory, like, shardings=shardings)
