"""Training runtime: checkpoint/restart, watchdog, straggler mitigation,
preemption handling, elastic re-planning.

The port of ``repro.runtime.trainer``, with the reference's behaviour and
one deliberate difference: ``run()`` puts the SIGTERM and SIGINT handlers
it found back, and closes its checkpointer, in a ``finally``, so a
trainer leaves no process-wide state behind (the reference installs its
handlers and never restores them). The state is a tree of tensors, which
``checkpoint.store`` writes and restores in place of the like-tree's.

Fault-tolerance model (designed for 1000+ nodes, exercised here on CPU):

* **Checkpoint/restart** — async atomic checkpoints every
  ``ckpt_every`` steps carry (params, opt state, data-pipeline state);
  ``Trainer.run`` auto-resumes from the newest complete checkpoint, so a
  killed process restarts losslessly (tests kill it mid-run).
* **Preemption** — SIGTERM flips a flag; the loop finishes the in-flight
  step, writes a synchronous checkpoint, and exits 0 (clean eviction).
* **Watchdog / stragglers** — a step-time EMA; any step slower than
  ``straggler_factor`` x EMA increments a strike counter per incident. On
  ``max_strikes`` the runtime calls the elastic hook — on a real fleet this
  re-runs the paper's scheduler with the degraded machine set (the paper:
  "by any change in the cluster state, this algorithm can be used to
  recalculate"), here it logs + re-plans via repro_torch.sched.elastic.
* **NaN containment** — non-finite loss skips the update (grads dropped)
  and counts; persistent NaNs abort rather than corrupt the checkpoint
  lineage.
"""

from __future__ import annotations

import dataclasses
import json
import math
import signal
import time
from pathlib import Path
from typing import Any, Callable, Iterator

from repro_torch.checkpoint import store

__all__ = ["TrainerConfig", "Trainer"]

_SIGNALS = (signal.SIGTERM, signal.SIGINT)


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 100
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    max_strikes: int = 5
    max_nan_steps: int = 10


class Trainer:
    def __init__(
        self,
        cfg: TrainerConfig,
        train_step: Callable,            # (state, batch) -> (state, metrics)
        init_state: Callable[[], Any],   # () -> state
        data: Iterator[dict] | Any,      # supports iteration; optional .state()/.seek()
        elastic_hook: Callable[[dict], None] | None = None,
        log: Callable[[str], None] = print,
    ):
        self.cfg = cfg
        self.train_step = train_step
        self.init_state = init_state
        self.data = data
        self.elastic_hook = elastic_hook
        self.log = log
        self._preempted = False
        self._strikes = 0
        self._nan_steps = 0

    # -- signals --------------------------------------------------------
    def _install_signals(self) -> dict:
        """Install the preemption handler; returns the handlers it replaced
        (none off the main thread, where signals cannot be set)."""

        def handler(signum, frame):
            self._preempted = True
            self.log(f"[trainer] signal {signum}: preemption requested")

        previous = {}
        try:
            for sig in _SIGNALS:
                previous[sig] = signal.getsignal(sig)
                signal.signal(sig, handler)
        except ValueError:
            pass  # not the main thread (tests)
        return previous

    @staticmethod
    def _restore_signals(previous: dict) -> None:
        for sig, old in previous.items():
            if old is not None:  # None: a handler not set from Python
                signal.signal(sig, old)

    # -- checkpoint glue -------------------------------------------------
    def _restore(self, state: Any) -> tuple[Any, int]:
        latest = store.latest_step(self.cfg.ckpt_dir)
        if latest is None:
            return state, 0
        restored, step = store.restore(self.cfg.ckpt_dir, state, latest)
        # data pipeline state rides in the manifest extra
        manifest = json.loads(
            (Path(self.cfg.ckpt_dir) / f"step_{step:08d}" / "manifest.json").read_text()
        )
        if hasattr(self.data, "seek") and manifest["extra"].get("data_state"):
            self.data.seek(manifest["extra"]["data_state"])
        self.log(f"[trainer] resumed from step {step}")
        return restored, step

    def _data_state(self) -> dict | None:
        return self.data.state() if hasattr(self.data, "state") else None

    # -- main loop --------------------------------------------------------
    def run(self) -> dict:
        previous = self._install_signals()
        ckpt = None
        try:
            state = self.init_state()
            state, start = self._restore(state)
            ckpt = store.AsyncCheckpointer(self.cfg.ckpt_dir, keep=self.cfg.keep)
            return self._loop(state, start, ckpt)
        finally:
            if ckpt is not None:
                ckpt.close()
            self._restore_signals(previous)

    def _loop(self, state: Any, start: int, ckpt: store.AsyncCheckpointer) -> dict:
        it = iter(self.data)
        ema = None
        losses = []
        step = start
        while step < self.cfg.total_steps and not self._preempted:
            batch = next(it)
            t0 = time.time()
            new_state, metrics = self.train_step(state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0

            if not math.isfinite(loss):
                self._nan_steps += 1
                self.log(f"[trainer] step {step}: non-finite loss, skipping update "
                         f"({self._nan_steps}/{self.cfg.max_nan_steps})")
                if self._nan_steps >= self.cfg.max_nan_steps:
                    raise FloatingPointError("persistent non-finite loss")
                step += 1
                continue
            state = new_state
            losses.append(loss)
            step += 1

            # Watchdog / straggler detection.
            if ema is None:
                ema = dt
            ema = 0.9 * ema + 0.1 * dt
            if dt > self.cfg.straggler_factor * ema and step - start > 5:
                self._strikes += 1
                self.log(f"[trainer] step {step}: straggler step "
                         f"({dt:.3f}s vs EMA {ema:.3f}s), strike {self._strikes}")
                if self._strikes >= self.cfg.max_strikes and self.elastic_hook:
                    self.elastic_hook({"step": step, "ema": ema, "last": dt})
                    self._strikes = 0

            if step % self.cfg.log_every == 0:
                self.log(f"[trainer] step {step}: loss {loss:.4f} ({dt*1e3:.0f} ms)")
            if step % self.cfg.ckpt_every == 0:
                ckpt.save(step, state, extra={"data_state": self._data_state()})

        if self._preempted:
            self.log(f"[trainer] preempted at step {step}; final checkpoint")
            store.save(self.cfg.ckpt_dir, step, state, extra={"data_state": self._data_state()})
        return {"final_step": step, "losses": losses, "state": state}
