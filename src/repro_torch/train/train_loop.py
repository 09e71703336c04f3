"""Train steps and a preemption-safe trainer loop.

Counterpart of ``repro/train/train_loop.py``:

* ``make_train_step`` -- one device: value and gradient of ``lm_loss``,
  then ``adamw_update`` in place (the reference's ``rules=None`` path;
  ``ShardingRules`` and the ZeRO layouts are ROADMAP A.13.3);
* ``make_compressed_train_step`` -- replicated data parallelism over a
  ``DeviceMesh`` dim (``launch.make_dp_mesh``): every rank holds the
  global batch and takes its rows, the loss is all-reduce-meaned, and the
  gradients are synced through the coded-sketch compressor
  (``core.gradient_compression.GradCompressor.sync``) or, with
  ``compressor=None``, by a mean all-reduce.

``Trainer`` resumes from the newest checkpoint, checkpoints and stops on
SIGTERM, retries a failed step once, logs stragglers, and checkpoints
periodically and at the end, through ``repro_torch.checkpoint`` (whose
checkpoints both packages read). A step never waits on the host: the
metrics stay on the device and the only host synchronisations of the
loop are the floats it logs every ``log_every`` steps and the
checkpoints.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import latest_step, restore_checkpoint, \
    save_checkpoint
from repro_torch.models import lm as L
from repro_torch.models.nn import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.parallel.collectives import all_reduce_sum, axis_group

__all__ = ["make_train_step", "make_compressed_train_step", "TrainState",
           "Trainer", "loss_and_grads"]


def loss_and_grads(params, tokens: torch.Tensor, cfg) -> tuple:
    """(loss, metrics, gradient tree) of ``lm_loss`` at ``params``; the
    parameters' ``requires_grad`` flags are left as they were."""
    leaves = tree_leaves(params)
    flags = [p.requires_grad for p in leaves]
    try:
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            loss, metrics = L.lm_loss(params, tokens, cfg)
            grads = torch.autograd.grad(loss, leaves)
    finally:
        for p, f in zip(leaves, flags):
            p.requires_grad_(f)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, grads)


def make_train_step(cfg, opt_cfg: AdamWConfig, rules=None) -> Callable:
    """(params, opt_state, tokens) -> (params, opt_state, metrics), the
    parameters and state updated in place."""
    if rules is not None:
        raise NotImplementedError(
            "ShardingRules (tensor-parallel and ZeRO layouts) are ROADMAP "
            "A.13.3, not yet ported to repro_torch")

    def step(params, opt_state, tokens):
        loss, metrics, grads = loss_and_grads(params, tokens, cfg)
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             opt_cfg)
        return params, opt_state, dict(metrics, loss=loss, **om)

    return step


def make_compressed_train_step(cfg, opt_cfg: AdamWConfig, mesh, compressor,
                               axis: str = "data") -> Callable:
    """(params, opt_state, ef, tokens) -> (params, opt_state, ef,
    metrics) on every rank of ``mesh[axis]``: ``tokens`` is the global
    batch, of which rank r takes the r-th block of rows (as the
    reference's ``P(axis)``); parameters and state stay replicated."""

    def step(params, opt_state, ef, tokens):
        _, rank, world = axis_group(mesh, axis, tokens)
        if tokens.shape[0] % world:
            raise ValueError(f"batch {tokens.shape[0]} does not split over "
                             f"{world} ranks")
        n = tokens.shape[0] // world
        loss, _, grads = loss_and_grads(
            params, tokens[rank * n:(rank + 1) * n], cfg)
        loss = all_reduce_sum(loss, mesh, axis) / world
        if compressor is None:    # the plain mean all-reduce baseline
            grads = tree_map(lambda g: all_reduce_sum(g, mesh, axis) / world,
                             grads)
            new_ef = ef
        else:
            grads, new_ef = compressor.sync(grads, ef, mesh,
                                            step=int(opt_state["step"]),
                                            axis=axis)
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             opt_cfg)
        return params, opt_state, new_ef, dict(om, loss=loss)

    return step


@dataclass
class TrainState:
    params: object
    opt_state: object
    step: int = 0
    ef: object = None     # error-feedback state (compressed path)


class Trainer:
    """Preemption-safe loop around a train step."""

    def __init__(self, step_fn: Callable, state: TrainState, pipeline,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 100,
                 keep: int = 3, log_every: int = 10, log_fn=print):
        self.step_fn = step_fn
        self.state = state
        self.pipeline = pipeline
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.keep = keep
        self.log_every = log_every
        self.log = log_fn
        self._preempted = False
        self._ema = None
        self.history = []

    def _install_sigterm(self):
        def handler(signum, frame):
            self._preempted = True
        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:  # not the main thread
            pass

    def _tree(self) -> dict:
        tree = {"params": self.state.params, "opt": self.state.opt_state}
        if self.state.ef is not None:
            tree["ef"] = self.state.ef
        return tree

    def maybe_resume(self):
        """Restore the newest checkpoint of ``ckpt_dir``, if any, onto the
        parameters' device (the step counter onto the host)."""
        if not self.ckpt_dir:
            return
        step = latest_step(self.ckpt_dir)
        if step is None:
            return
        device = tree_leaves(self.state.params)[0].device
        restored = restore_checkpoint(self.ckpt_dir, step, self._tree(),
                                      device=device)
        restored["opt"]["step"] = restored["opt"]["step"].cpu()
        self.state.params = restored["params"]
        self.state.opt_state = restored["opt"]
        if self.state.ef is not None:
            self.state.ef = restored["ef"]
        self.state.step = step
        self.log(f"[trainer] resumed from step {step}")

    def checkpoint(self):
        if self.ckpt_dir:
            save_checkpoint(self.ckpt_dir, self.state.step, self._tree(),
                            keep=self.keep)

    def run(self, n_steps: int) -> list:
        self._install_sigterm()
        s = self.state
        while s.step < n_steps and not self._preempted:
            tokens = self.pipeline.batch_at(s.step)
            t0 = time.monotonic()
            try:
                out = self._apply(tokens)
            except Exception as e:  # one retry for transient failures
                self.log(f"[trainer] step {s.step} failed ({e!r}); "
                         f"retrying once")
                out = self._apply(tokens)
            self._absorb(out)
            dt = time.monotonic() - t0     # host time: no synchronisation
            self._ema = dt if self._ema is None else 0.9 * self._ema + 0.1 * dt
            if dt > 3.0 * self._ema and s.step > 5:
                self.log(f"[trainer] straggler: step {s.step} took {dt:.2f}s "
                         f"(ema {self._ema:.2f}s)")
            s.step += 1
            if s.step % self.log_every == 0:
                m = self.history[-1]
                self.log(f"[trainer] step {s.step} loss={float(m['loss']):.4f} "
                         f"gnorm={float(m['grad_norm']):.3f} {dt * 1e3:.0f}ms")
            if self.ckpt_every and s.step % self.ckpt_every == 0:
                self.checkpoint()
        self.checkpoint()
        if self._preempted:
            self.log("[trainer] SIGTERM received: checkpointed and exiting")
        return self.history

    def _apply(self, tokens):
        s = self.state
        if s.ef is not None:
            return self.step_fn(s.params, s.opt_state, s.ef, tokens)
        return self.step_fn(s.params, s.opt_state, tokens)

    def _absorb(self, out):
        s = self.state
        if s.ef is not None:
            s.params, s.opt_state, s.ef, metrics = out
        else:
            s.params, s.opt_state, metrics = out
        self.history.append(metrics)
