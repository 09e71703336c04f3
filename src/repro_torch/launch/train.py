"""Training launcher, counterpart of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --steps 5 [--ckpt-dir DIR] [--smoke] [--device cpu]

One process on one device (``--mesh host``, the card by default): the
config's full width (or ``--smoke``'s reduced one), the token pipeline,
``make_train_step`` under ``Trainer``, which resumes from ``--ckpt-dir``'s
newest checkpoint and checkpoints on SIGTERM. The production meshes
(``--mesh single|multi``) are ROADMAP A.13.3 and raise.
"""
from __future__ import annotations

import argparse

from repro_torch import configs as C
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models import lm as L
from repro_torch.models.nn import count_params, init_params
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.train import Trainer, TrainState, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"])
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (the CUDA card by default)")
    args = ap.parse_args(argv)
    if args.mesh != "host":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the production meshes are ROADMAP A.13.3, "
            f"not yet ported to repro_torch")

    device = resolve_device(args.device)
    cfg = C.get_smoke_config(args.arch) if args.smoke else \
        C.get_config(args.arch)
    seq = args.seq or (64 if args.smoke else 4096)
    batch = args.batch or 8     # one card (the reference's 256 is a pod's)
    specs = L.model_param_specs(cfg)
    print(f"[train] {cfg.name}: {count_params(specs) / 1e6:.1f}M params, "
          f"seq={seq} batch={batch} mesh={args.mesh} device={device}")

    opt_cfg = AdamWConfig(lr_peak=args.lr, decay_steps=max(args.steps, 1000))
    pipe = TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        n_codebooks=cfg.n_codebooks), device=device)
    params = init_params(specs, seed=0, device=device)
    opt = init_opt_state(params, opt_cfg)
    trainer = Trainer(make_train_step(cfg, opt_cfg), TrainState(params, opt),
                      pipe, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every)
    trainer.maybe_resume()
    hist = trainer.run(args.steps)
    if hist:
        print(f"[train] final loss {float(hist[-1]['loss']):.4f}")
    return hist


if __name__ == "__main__":
    main()
