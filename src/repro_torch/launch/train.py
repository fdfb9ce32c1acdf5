"""Training launcher of the port (``repro.launch.train``'s flags, plus ``--device``).

Examples:
  # CPU-runnable end-to-end training, reduced model:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --reduced \
      --steps 200 --batch 8 --seq 128 --ckpt /path/to/ckpt --device cpu

  # with the paper's OT domain-alignment auxiliary loss:
  ... --ot-align

Without ``--device`` it trains on the card.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.configs.base import OptimizerConfig, TrainConfig
from repro_torch.data.pipeline import SyntheticLM, SyntheticLMConfig
from repro_torch.training.trainer import Trainer
from repro_torch.utils.logging import get_logger

log = get_logger("train")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ot-align", action="store_true")
    ap.add_argument("--grad-compression", choices=["none", "int8_ef"], default="none")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch versions on the host; default the card")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainConfig(
        optimizer=OptimizerConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5)),
        steps=args.steps,
        checkpoint_every=args.ckpt_every,
        ot_align=args.ot_align,
        grad_compression=args.grad_compression,
        seed=args.seed,
    )
    data = SyntheticLM(
        SyntheticLMConfig(
            vocab_size=cfg.vocab_size,
            seq_len=args.seq,
            global_batch=args.batch,
            seed=args.seed,
        )
    )
    trainer = Trainer(cfg, tcfg, data, ckpt_dir=args.ckpt, device=args.device)
    log.info(
        "training %s (%s) for %d steps on %s",
        args.arch, "reduced" if args.reduced else "full", args.steps, trainer.device,
    )
    final = trainer.run()
    log.info("final metrics: %s", final)
    return final


if __name__ == "__main__":
    main()
