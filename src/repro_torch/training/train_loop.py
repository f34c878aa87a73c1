"""Training step and loop: microbatching, gradient compression,
checkpoint/restart and straggler accounting.

PyTorch counterpart of ``repro.training.train_loop``.
``make_train_step(cfg, opt_cfg)`` returns the step function; ``TrainLoop``
adds checkpoint/restart and straggler accounting around it.  A step runs
the model's train mode (``models.model.loss_fn``: torch autograd over the
reference's jnp attention paths, never a CUDA kernel), then AdamW in
place.  Parameters must be leaf tensors that require grad
(``Model.train()``); the step updates them where they lie and returns the
same tree.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.models.model import loss_fn
from repro_torch.obs import span

from .optimizer import (AdamWConfig, adamw_update, init_opt_state, leaves,
                        maybe_compress, tree_map)

F32 = torch.float32


def batch_to_device(batch: dict, device) -> dict:
    """A training batch (numpy arrays, as ``data.pipeline`` yields them, or
    tensors) on ``device``: token ids as int64, the rest as given (the
    model casts frames and patch embeddings to its dtype)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v)) if not torch.is_tensor(v) else v
        if k in ("tokens", "targets"):
            t = t.to(torch.int64)
        out[k] = t.to(device)
    return out


def _synchronize(device: torch.device) -> None:
    """Wait for the device's queued work: the step's wall time is measured
    after it, as the reference's after ``jax.block_until_ready``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_train_step(cfg, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                    grad_shardings=None):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, updating ``params`` and ``opt_state`` in place.

    Microbatching: the batch splits along axis 0 into ``microbatches``
    sequential gradient accumulations in f32, the loss is their mean and
    the metrics are the last one's, as the reference's scan.  Gradient
    compression (int8 + error feedback) applies at the accumulation
    boundary, on what would cross the data-parallel all-reduce.  Metrics
    are 0-d tensors: the loss terms, ``grad_norm``, ``lr`` and
    ``loss_total``.  The step's sections are ``torch.profiler`` ranges
    (``obs.span``): ``train/forward``, ``train/backward`` and
    ``train/optimizer``.

    ``grad_shardings``: a tree shaped like ``params`` of DTensor
    placements.  Each gradient is redistributed to its leaf's placements
    right after the backward pass, as the reference constrains them at the
    autodiff boundary: a data-sharded parameter's ``Partial`` gradient
    then arrives by reduce-scatter instead of all-reduce + slice."""

    def grads_of(params, batch):
        with span("train/forward"):
            total, metrics = loss_fn(params, cfg, batch)
        with span("train/backward"):
            total.backward()
        if grad_shardings is not None:
            for t, pl in zip(leaves(params), leaves(grad_shardings)):
                if t.grad is not None and hasattr(t.grad, "redistribute"):
                    t.grad = t.grad.redistribute(t.grad.device_mesh, pl)
        return total.detach(), {k: v.detach() for k, v in metrics.items()}

    def train_step(params, opt_state, batch):
        device = leaves(params)[0].device
        batch = batch_to_device(batch, device)
        for t in leaves(params):
            t.grad = None
        if microbatches == 1:
            loss, metrics = grads_of(params, batch)
            grads = None                 # adamw_update reads and frees .grad
        else:
            n = batch["tokens"].shape[0]
            if n % microbatches:
                raise ValueError(f"batch of {n} does not split into "
                                 f"{microbatches} microbatches")
            size = n // microbatches
            acc = tree_map(lambda t: torch.zeros(t.shape, dtype=F32,
                                                 device=t.device), params)
            loss = None
            for i in range(microbatches):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                total, metrics = grads_of(params, mb)
                loss = total if loss is None else loss + total
                with torch.no_grad():
                    for a, t in zip(leaves(acc), leaves(params)):
                        a.add_(t.grad.float())
                        t.grad = None
            with torch.no_grad():
                for a in leaves(acc):
                    a.div_(microbatches)
            grads, loss = acc, loss / microbatches
        with span("train/optimizer"):
            if opt_cfg.compress_grads:
                if grads is None:
                    grads = tree_map(lambda t: t.grad, params)
                    for t in leaves(params):
                        t.grad = None
                grads, opt_state["compress_err"] = maybe_compress(
                    grads, opt_state.get("compress_err"), True)
            params, opt_state, opt_metrics = adamw_update(
                opt_cfg, params, grads, opt_state)
        metrics = dict(metrics, **opt_metrics, loss_total=loss)
        return params, opt_state, metrics

    return train_step


def init_train_state(params, opt_cfg: AdamWConfig) -> dict:
    """The optimizer state (``init_opt_state``), with the compression error
    (zeros) when ``opt_cfg.compress_grads``."""
    state = init_opt_state(params)
    if opt_cfg.compress_grads:
        state["compress_err"] = tree_map(
            lambda t: torch.zeros(t.shape, dtype=F32, device=t.device),
            params)
    return state


@dataclass
class TrainLoop:
    """Checkpointed training loop with failure recovery.

    * saves a checkpoint every ``ckpt_every`` steps (async commit),
    * on (re)start, resumes from the newest committed step,
    * a step whose wall time passes ``straggler_factor`` times the EMA of
      step wall times counts as a straggler.
    """

    model_cfg: Any
    opt_cfg: AdamWConfig
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    straggler_factor: float = 3.0

    def run(self, params, batch_iter, steps: int, *, train_step=None,
            opt_state=None, on_metrics: Optional[Callable] = None):
        from repro_torch.training import checkpoint as ckpt

        device = leaves(params)[0].device
        step0 = 0
        if self.ckpt_dir:
            # restore against templates so empty subtrees (e.g. the
            # non-parametric norms) keep their structure
            opt_template = opt_state or init_train_state(params, self.opt_cfg)
            restored = ckpt.restore_latest(self.ckpt_dir, params, opt_template)
            if restored is not None:
                params, opt_state, step0 = restored
        if opt_state is None:
            opt_state = init_train_state(params, self.opt_cfg)
        if train_step is None:
            train_step = make_train_step(self.model_cfg, self.opt_cfg)

        ema_dt = None
        stragglers = 0
        for step in range(step0, steps):
            batch = next(batch_iter)
            t0 = time.perf_counter()
            params, opt_state, metrics = train_step(params, opt_state, batch)
            _synchronize(device)
            dt = time.perf_counter() - t0
            ema_dt = dt if ema_dt is None else 0.9 * ema_dt + 0.1 * dt
            if dt > self.straggler_factor * ema_dt:
                stragglers += 1
            if on_metrics:
                on_metrics(step, {k: float(v) for k, v in metrics.items()}, dt)
            if self.ckpt_dir and (step + 1) % self.ckpt_every == 0:
                ckpt.save(self.ckpt_dir, params, opt_state, step + 1,
                          async_commit=True)
        if self.ckpt_dir:
            ckpt.wait_for_pending()   # never race an async save of this step
            if steps % self.ckpt_every != 0 or steps == step0:
                ckpt.save(self.ckpt_dir, params, opt_state, steps,
                          async_commit=False)
        return params, opt_state, {"stragglers": stragglers}
