"""Train a ~100M-param dense LM for a few hundred steps (end-to-end driver).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] \\
        [--batch 8] [--seq 128] [--ckpt-dir DIR] [--compress-grads] \\
        [--device cpu]

Exercises the full training substrate: synthetic corpus with learnable
structure -> AdamW + clipping (+ optional int8 gradient compression) ->
checkpointed loop (kill it mid-run and rerun: it resumes from the newest
committed manifest).  The port's counterpart of ``examples/train_lm.py``:
the same model ("olmo-100m", 12 layers x 768), flags and lines, trained
through torch autograd (no kernel wrapper runs with grad) on the card
unless ``--device cpu``.  The weights are drawn from a ``torch.Generator``
seeded with 0, as the reference's come from ``PRNGKey(0)``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig, batches
from repro_torch.models.model import Model
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import TrainLoop, make_train_step


def olmo_100m():
    """The example's ~100M-param olmo-family config (12L x 768)."""
    return dataclasses.replace(
        get_config("olmo-1b"), name="olmo-100m", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=12, head_dim=64, d_ff=3072, vocab_size=8192,
        attn_impl="dense")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_train_lm"))
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)

    cfg = olmo_100m()
    model = Model(cfg, seed=0, device=args.device).train()
    n = sum(t.numel() for t in model.buffers())
    print(f"model: {cfg.name} {n/1e6:.1f}M params; "
          f"{args.steps} steps of {args.batch}x{args.seq}")

    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=30, total_steps=args.steps,
                          compress_grads=args.compress_grads)
    data = batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                              global_batch=args.batch))
    loop = TrainLoop(cfg, opt_cfg, ckpt_dir=args.ckpt_dir, ckpt_every=50)
    step_fn = make_train_step(cfg, opt_cfg)
    losses, step_s = {}, {}

    def report(step, m, dt):
        losses[step], step_s[step] = m["loss"], dt
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss={m['loss']:.4f}  "
                  f"lr={m['lr']:.2e}  {dt*1e3:.0f}ms", flush=True)

    _, _, info = loop.run(model.params, data, steps=args.steps,
                          train_step=step_fn, on_metrics=report)
    print(f"finished; stragglers flagged: {info['stragglers']}; "
          f"checkpoints in {args.ckpt_dir}")
    return {"n_params": n, "losses": losses, "step_s": step_s}


if __name__ == "__main__":
    main()
