"""Trainer: the end-to-end loop wiring together the instrumented data
pipeline, the train step, checkpointing, and the monitor-driven
controllers (prefetch sizing, straggler detection)."""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.core.controller import BufferAutotuner
from repro_torch.core.device import resolve_device
from repro_torch.ft import FaultToleranceManager
from repro_torch.models.api import Model
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.step import TrainConfig, make_train_step

__all__ = ["Trainer", "TrainerConfig"]


@dataclasses.dataclass
class TrainerConfig:
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    log_every: int = 10
    param_dtype: Any = torch.float32


class Trainer:
    """Random weights from ``seed`` (a ``torch.Generator`` on the
    device), the optimizer state and the step counter on the card unless
    given ``device="cpu"``; ``fit`` trains on batches of numpy arrays or
    tensors, feeds the host step rate into the FT monitor every
    ``log_every`` steps and checkpoints every ``ckpt_every``."""

    def __init__(self, model: Model, tcfg: TrainerConfig, seed: int = 0, *,
                 device="cuda"):
        self.model = model
        self.tcfg = tcfg
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = model.init_params(gen, tcfg.param_dtype,
                                   device=self.device)
        opt = init_opt_state(tcfg.train.opt.name, params)
        self.state = {"params": params, "opt": opt,
                      "step": torch.zeros((), dtype=torch.int32,
                                          device=self.device)}
        self.step_fn = make_train_step(model, tcfg.train)
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir)
                     if tcfg.ckpt_dir else None)
        self.ft = FaultToleranceManager(n_hosts=1)
        self.autotuner = BufferAutotuner(current=16)
        self.history: list[dict] = []

    def maybe_restore(self) -> int:
        if self.ckpt is None:
            return 0
        state, step = self.ckpt.restore(self.state)
        if state is not None:
            self.state = state
            return int(step)
        return 0

    def fit(self, data_iter, steps: int) -> list[dict]:
        start = int(self.state["step"])
        t_last = time.monotonic()
        steps_done = 0
        for batch in data_iter:
            if steps_done >= steps:
                break
            tbatch = {k: torch.as_tensor(v, device=self.device)
                      for k, v in batch.items()}
            self.state, metrics = self.step_fn(self.state, tbatch)
            steps_done += 1
            cur = start + steps_done

            if steps_done % self.tcfg.log_every == 0:
                rec = {k: float(v) for k, v in metrics.items()}   # syncs
                now = time.monotonic()
                dt = now - t_last
                t_last = now
                rate = self.tcfg.log_every / dt
                # feed the host step stream into the FT monitor
                self.ft.rates.record_steps("host0", self.tcfg.log_every,
                                           dt)
                self.ft.heartbeats.beat("host0")
                rec.update(step=cur, steps_per_s=rate)
                self.history.append(rec)

            if (self.ckpt is not None
                    and steps_done % self.tcfg.ckpt_every == 0):
                self.ckpt.save(cur, self.state)
        if self.ckpt is not None and steps_done:
            self.ckpt.save(start + steps_done, self.state, blocking=True)
        return self.history
