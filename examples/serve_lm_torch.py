"""Serve a small model with batched requests on the PyTorch port.

The torch twin of ``examples/serve_lm.py``, with ``--device`` beside its
flags.  More requests than slots: the engine admits, decodes per-slot
positions in one step, recycles slots as requests finish.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py [--requests 8] --device cpu

Without ``--device`` it serves on the card.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch versions on the host; default the card")
    args = ap.parse_args(argv)

    cfg = get_config("smollm-135m").reduced()
    model = build_model(cfg, args.device, seed=0)
    engine = ServingEngine(cfg, model, max_batch=args.max_batch,
                           max_len=args.prompt_len + args.new_tokens + 8, device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32),
                    max_new_tokens=args.new_tokens)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    done = engine.run(reqs)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens / dt:.1f} tok/s on {engine.device})")
    for r in done[:3]:
        print(f"  request {r.rid}: {r.out_tokens}")
    return done


if __name__ == "__main__":
    main()
