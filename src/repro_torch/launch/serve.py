"""Serving launcher of the port (``repro.launch.serve``'s flags, plus ``--device``).

Example (CPU-runnable):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m --reduced \
      --requests 6 --prompt-len 16 --new-tokens 8 --device cpu

Without ``--device`` it serves on the card.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.utils.logging import get_logger

log = get_logger("serve")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch versions on the host; default the card")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, args.device, seed=0)
    engine = ServingEngine(cfg, model, max_batch=args.max_batch,
                           max_len=args.prompt_len + args.new_tokens + 8, device=args.device)
    rng = np.random.default_rng(0)
    reqs = [
        Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32),
            max_new_tokens=args.new_tokens,
        )
        for i in range(args.requests)
    ]
    done = engine.run(reqs)
    for r in done:
        log.info("request %d -> %s", r.rid, r.out_tokens)
    print(f"served {len(done)} requests")
    return done


if __name__ == "__main__":
    main()
