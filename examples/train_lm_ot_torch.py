"""End-to-end driver of the PyTorch port: train smollm-135m with the paper's
group-sparse OT domain-alignment auxiliary loss.

The torch twin of ``examples/train_lm_ot.py``, with ``--device`` beside its
flags.  The OT loss routes through ``repro_torch.ot.OTLayer`` (Danskin
gradients through the screened dual); ``--ot-grad-impl pallas`` or ``fused``
solves on the hand-written CUDA kernels on the card.

Full run (the real config, on the card):

  PYTHONPATH=src python examples/train_lm_ot_torch.py --steps 300 --dtype bfloat16 \
      --ot-grad-impl pallas

Quick run (reduced model):

  PYTHONPATH=src python examples/train_lm_ot_torch.py --quick --device cpu

Smoke (tiny model, a few steps; exits 1 unless the training loss strictly
decreases):

  PYTHONPATH=src python examples/train_lm_ot_torch.py --smoke --device cpu
"""
import argparse
import dataclasses
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config
from repro_torch.configs.base import OptimizerConfig, TrainConfig
from repro_torch.data.pipeline import SyntheticLM, SyntheticLMConfig
from repro_torch.training.trainer import Trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny model, few steps; exit 1 unless loss decreases")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_lm_ot_ckpt"))
    ap.add_argument("--no-ot", action="store_true")
    ap.add_argument("--ot-solver", default="lbfgs",
                    choices=("lbfgs", "stochastic"),
                    help="dual solver for the OT alignment loss")
    ap.add_argument("--ot-grad-impl", default="screened",
                    choices=("dense", "screened", "pallas", "fused"),
                    help="gradient-oracle backend for the OT alignment loss")
    ap.add_argument("--dtype", default="float32",
                    help="param/compute dtype (the config's own is bfloat16)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch versions on the host; default the card")
    args = ap.parse_args()

    cfg = get_config("smollm-135m")
    cfg = dataclasses.replace(cfg, param_dtype=args.dtype, compute_dtype=args.dtype)
    steps = args.steps
    if args.smoke:
        cfg = cfg.reduced(num_layers=2, d_model=64, d_ff=128, vocab_size=128)
        steps = min(steps, 8)
        args.batch, args.seq = 4, 32
    elif args.quick:
        cfg = cfg.reduced(num_layers=4, d_model=128, d_ff=256, vocab_size=1024)
        steps = min(steps, 40)

    tcfg = TrainConfig(
        optimizer=OptimizerConfig(lr=1e-3 if args.smoke else 6e-4,
                                  warmup_steps=max(steps // 10, 2 if args.smoke else 5),
                                  decay_steps=steps),
        steps=steps,
        log_every=1 if args.smoke else max(steps // 20, 1),
        checkpoint_every=max(steps // 4, 10),
        ot_align=not args.no_ot,
        ot_align_weight=0.05,
        ot_solver=args.ot_solver,
        ot_grad_impl=args.ot_grad_impl,
    )
    data = SyntheticLM(
        SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch, num_classes=8)
    )
    ckpt_dir = None if args.smoke else args.ckpt
    trainer = Trainer(cfg, tcfg, data, ckpt_dir=ckpt_dir, device=args.device)
    final = trainer.run()
    first = trainer.metrics_history[0] if trainer.metrics_history else {}
    print(f"\nce: {first.get('ce', float('nan')):.4f} -> {final.get('ce', float('nan')):.4f}"
          f"   (ot_distance: {final.get('ot_distance', 'n/a')})")

    if args.smoke:
        ok = final.get("loss", float("inf")) < first.get("loss", float("-inf"))
        print(f"smoke: loss {first.get('loss'):.4f} -> {final.get('loss'):.4f} "
              f"({'DECREASED' if ok else 'DID NOT DECREASE'})")
        if not ok:
            sys.exit(1)


if __name__ == "__main__":
    main()
