"""End-to-end training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --steps 300 --batch 8 --seq 128 [--smoke] [--ckpt-dir DIR] \\
        [--device cpu]

Wires the training stack: the data pipeline's batches -> the train step
(torch autograd over the model's train mode, AdamW in place) -> the
checkpointed ``TrainLoop`` with straggler accounting, on the card unless
``--device cpu``.  ``--smoke`` runs the reduced same-family config.  The
flags and printed lines are the reference launcher's; the weights are
drawn from a ``torch.Generator`` seeded with 0, as the reference's come
from ``PRNGKey(0)``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.configs.base import ARCH_IDS, get_config, smoke_config
from repro_torch.data.pipeline import DataConfig, batches
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import TrainLoop, make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="olmo-1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--d-model", type=int, default=0,
                    help="override width (e.g. ~100M model: --d-model 512)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    overrides = {}
    if args.d_model:
        overrides.update(d_model=args.d_model,
                         d_ff=4 * args.d_model if cfg.d_ff else 0,
                         head_dim=args.d_model // cfg.n_heads)
    if args.layers:
        overrides.update(n_layers=args.layers)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    model = Model(cfg, seed=0, device=device).train()
    n_params = sum(t.numel() for t in model.buffers())
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"steps={args.steps} batch={args.batch}x{args.seq}")

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 10 + 1),
                          total_steps=args.steps,
                          compress_grads=args.compress_grads)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch)
    data = batches(data_cfg, model_cfg=cfg)

    loop = TrainLoop(cfg, opt_cfg, ckpt_dir=args.ckpt_dir)
    t0 = time.perf_counter()
    losses = {}

    def on_metrics(step, m, dt):
        losses[step] = m["loss"]
        if step % max(1, args.steps // 20) == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss={m['loss']:.4f}  "
                  f"grad_norm={m['grad_norm']:.2f}  lr={m['lr']:.2e}  "
                  f"{dt*1e3:.0f}ms/step", flush=True)

    train_step = make_train_step(cfg, opt_cfg, microbatches=args.microbatches)
    params, opt_state, info = loop.run(
        model.params, data, steps=args.steps, train_step=train_step,
        on_metrics=on_metrics)
    wall = time.perf_counter() - t0
    tokens = args.steps * args.batch * args.seq
    print(f"done: {wall:.1f}s, {tokens/wall:.0f} tok/s, "
          f"stragglers={info['stragglers']}")
    return {"losses": losses, "stragglers": info["stragglers"],
            "wall_s": wall, "params": params, "opt_state": opt_state}


if __name__ == "__main__":
    main()
