"""Training loop: the step, checkpoint/restart and logging.

The port of the reference package's ``train/trainer.py`` on one device.
A step is ``LM.loss``, its gradient by autograd (the flash kernel's
backward on the card) and one AdamW update in place.  The fault-tolerance
contract is the reference's:

* the state (params and optimizer state) is checkpointed every
  ``ckpt_every`` steps, async and atomic (``train/checkpoint.py``);
* on construction the Trainer restores the newest checkpoint, if one
  exists, and resumes from its step;
* the data pipeline is a pure function of the step (``data/pipeline.py``),
  so a restart replays the same batches: on the CPU the resumed run is
  bitwise the uninterrupted one.

The weights come from an explicit ``torch.Generator`` made on the chosen
device (default CUDA; ``device="cpu"`` for the CPU).  ``mesh`` (the
reference's sharded training) comes with the multi-GPU slice and raises.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt_lib


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    ckpt_async: bool = True
    log_every: int = 10
    opt: opt_lib.OptimizerConfig = dataclasses.field(
        default_factory=opt_lib.OptimizerConfig)


def make_train_step(lm, opt_cfg):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss, its gradient with respect to every leaf of
    ``params`` (which must require grad), and one AdamW update in place.
    ``metrics`` holds ``loss``, the loss's metrics, ``grad_norm`` (device
    scalars) and ``lr``."""
    def train_step(params, opt_state, batch):
        loss, metrics = lm.loss(params, batch)
        flat = opt_lib.leaves(params)
        by_leaf = dict(zip(map(id, flat), torch.autograd.grad(loss, flat)))
        grads = opt_lib.tree_map(lambda p: by_leaf[id(p)], params)
        params, opt_state, om = opt_lib.update(opt_cfg, grads, opt_state,
                                               params)
        return params, opt_state, {"loss": loss.detach(),
                                   **{k: v.detach()
                                      for k, v in metrics.items()}, **om}
    return train_step


class Trainer:
    def __init__(self, lm, data, cfg: TrainConfig, mesh=None,
                 generator: torch.Generator | None = None, device=None):
        """``data(step)`` gives the batch of a step as CPU tensors.  The
        weights are ``lm.init(generator)`` (default: a generator on
        ``device`` seeded with 0), made on the generator's device."""
        if mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh=...) is not ported yet: sharded training "
                "comes with the multi-GPU slice (ROADMAP Queue 1 #8)")
        self.lm = lm
        self.data = data
        self.cfg = cfg
        if generator is None:
            generator = torch.Generator(
                device=resolve_device(device)).manual_seed(0)
        self.device = generator.device
        self.params = opt_lib.tree_map(lambda t: t.requires_grad_(True),
                                       lm.init(generator))
        self.opt_state = opt_lib.init(cfg.opt, self.params)
        self._step_fn = make_train_step(lm, cfg.opt)
        self.step = 0
        self.history: list[dict] = []
        # The newest step's metrics (device scalars), for callers that
        # read every step.
        self.metrics: dict = {}
        if cfg.ckpt_dir and ckpt_lib.latest_step(cfg.ckpt_dir) is not None:
            self.restore()

    # -- checkpoint/restart ------------------------------------------------
    def _tree(self):
        return {"params": self.params,
                "opt": {"m": self.opt_state["m"], "v": self.opt_state["v"],
                        "step": self.opt_state["step"]},
                "meta": {"step": self.step}}

    def save(self):
        if not self.cfg.ckpt_dir:
            return
        tree = self._tree()
        # The optimizer's step is an int32 in the reference's files.
        tree["opt"]["step"] = np.int32(tree["opt"]["step"])
        if self.cfg.ckpt_async:
            ckpt_lib.save_async(self.cfg.ckpt_dir, self.step, tree)
        else:
            ckpt_lib.save(self.cfg.ckpt_dir, self.step, tree)

    def restore(self, step=None):
        tree, _ = ckpt_lib.restore(self.cfg.ckpt_dir, self._tree(), step)
        with torch.no_grad():
            for dst, src in zip(opt_lib.leaves(
                    [self.params, self.opt_state["m"], self.opt_state["v"]]),
                    opt_lib.leaves([tree["params"], tree["opt"]["m"],
                                    tree["opt"]["v"]])):
                dst.copy_(src)
        self.opt_state["step"] = int(tree["opt"]["step"])
        self.step = int(tree["meta"]["step"])
        return self.step

    # -- loop ---------------------------------------------------------------
    def run(self, steps=None, on_step=None):
        steps = steps if steps is not None else self.cfg.steps
        while self.step < steps:
            batch = {k: t.to(self.device)
                     for k, t in self.data(self.step).items()}
            self.params, self.opt_state, self.metrics = self._step_fn(
                self.params, self.opt_state, batch)
            self.step += 1
            if self.step % self.cfg.log_every == 0 or self.step == steps:
                m = {k: float(v) for k, v in self.metrics.items()}
                m["step"] = self.step
                m["time"] = time.time()
                self.history.append(m)
            if self.cfg.ckpt_dir and self.step % self.cfg.ckpt_every == 0:
                self.save()
            if on_step is not None:
                on_step(self)
        ckpt_lib.wait_pending()
        return self.history
