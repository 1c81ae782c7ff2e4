"""Fault-tolerant training driver: the reference's
``repro.runtime.driver``.

The loop is checkpoint/restart-structured: every step is a pure
function of (params, opt_state, step_number) and the data pipeline is
stateless-resumable, so recovery = restore the latest checkpoint and
continue from its step.  Failures (a lost device, preemption, faults
injected by tests) surface as exceptions from the step; the driver
restores and retries, up to ``max_restarts``.  Straggler detection runs
on step wall times.  On the card a resumed run equals the uninterrupted
one bit for bit: the step's kernels use no atomics.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from ..checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..serve.elastic import StragglerMonitor

__all__ = ["TrainDriver", "DriverConfig", "StepEvent"]


@dataclasses.dataclass(frozen=True)
class DriverConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 50
    max_restarts: int = 3
    straggler_threshold: float = 2.5
    log_every: int = 10


@dataclasses.dataclass
class StepEvent:
    step: int
    kind: str             # "step" | "checkpoint" | "restart" | "straggler"
    wall_s: float = 0.0
    info: Optional[Dict[str, Any]] = None


def _ready(x) -> None:
    """Wait for the device work behind ``x`` (the reference's
    ``block_until_ready``)."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


class TrainDriver:
    """Drives ``step_fn`` with checkpoint/restart and straggler
    accounting.

    ``step_fn(params, opt_state, batch) -> (params, opt_state, metrics)``
    (``train.make_train_step``); ``batch_fn(step) -> batch`` must be
    stateless-resumable (``data.SyntheticPipeline`` is).
    ``metrics_log`` holds every ``log_every``-th step's loss, gradient
    norm (when the step reports one) and wall time.  On a mesh (run it
    under ``with mesh:``) ``shardings`` holds the ``logical_spec``
    tuples of ``{"params", "opt"}``: checkpoints are written from the
    shards and restored onto them.
    """

    def __init__(self, cfg: DriverConfig, step_fn: Callable,
                 batch_fn: Callable, *,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 shardings=None):
        self.cfg = cfg
        self.shardings = shardings
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.fault_hook = fault_hook     # tests inject failures here
        self.monitor = StragglerMonitor(cfg.straggler_threshold)
        self.events: List[StepEvent] = []
        self.metrics_log: List[Dict[str, float]] = []

    # -- recovery ---------------------------------------------------------
    def _restore(self, params, opt_state):
        step = latest_step(self.cfg.ckpt_dir)
        if step is None:
            return params, opt_state, 0
        tree, step = restore_checkpoint(
            self.cfg.ckpt_dir, {"params": params, "opt": opt_state},
            shardings=self.shardings)
        return tree["params"], tree["opt"], step

    def run(self, params, opt_state, *, start_step: int = 0):
        cfg = self.cfg
        step = start_step
        restarts = 0
        while step < cfg.total_steps:
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                t0 = time.time()
                batch = self.batch_fn(step)
                params, opt_state, metrics = self.step_fn(
                    params, opt_state, batch)
                _ready(metrics["loss"])
                dt = time.time() - t0
                ev = self.monitor.observe(step, dt)
                if ev is not None:
                    self.events.append(StepEvent(
                        step, "straggler", dt,
                        {"ratio": ev.ratio, "ema": ev.ema}))
                if step % cfg.log_every == 0:
                    entry = {"step": step, "loss": float(metrics["loss"]),
                             "wall_s": dt}
                    if "grad_norm" in metrics:
                        entry["grad_norm"] = float(metrics["grad_norm"])
                    self.metrics_log.append(entry)
                step += 1
                if step % cfg.ckpt_every == 0 or step == cfg.total_steps:
                    save_checkpoint(cfg.ckpt_dir, step,
                                    {"params": params, "opt": opt_state},
                                    shardings=self.shardings)
                    self.events.append(StepEvent(step, "checkpoint"))
            except KeyboardInterrupt:
                raise
            except Exception as e:                     # noqa: BLE001
                restarts += 1
                self.events.append(StepEvent(
                    step, "restart", info={"error": repr(e),
                                           "restart": restarts}))
                if restarts > cfg.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={cfg.max_restarts}") from e
                params, opt_state, step = self._restore(params, opt_state)
        return params, opt_state
