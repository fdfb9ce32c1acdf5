"""Serving launcher of the port (``repro.launch.serve``'s flags, plus ``--device``).

Example (CPU-runnable):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m --reduced \
      --requests 6 --prompt-len 16 --new-tokens 8 --device cpu

Without ``--device`` it serves on the card.  ``--mesh DATA,MODEL`` serves on a
mesh of ranks, one process a rank started by ``torchrun`` (a card a rank
without ``--device``; gloo on the host with ``--device cpu``):
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
      --arch phi3.5-moe-42b-a6.6b --reduced --mesh 1,2 --device cpu
Every rank serves the same requests and prints the same tokens.  An encoder-decoder
(``whisper-medium``) or a VLM (``llama-3.2-vision-90b``) is served through
``launch.steps`` instead of the engine, whose requests carry no frames or
image: the requests in one batch, the stub frontend's frames or image
tokens drawn from ``--seed``, one prefill (the encoder runs there) and one
decode step a token; on a mesh too:
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
      --arch llama-3.2-vision-90b --reduced --mesh 1,2 --device cpu
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import distributed as D
from repro_torch.data.pipeline import modality_stub
from repro_torch.launch import steps
from repro_torch.models import build_model, build_on_mesh
from repro_torch.models.common import torch_dtype
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.sharding import partition as P
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
    ap.add_argument("--seed", type=int, default=0,
                    help="the stub frames or image tokens of an encoder-decoder or a VLM")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch versions on the host; default the card")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="serve on a (data, model) mesh of ranks started by torchrun")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh = rules = None
    if args.mesh:
        mesh, device = _mesh(args.mesh, args.device)
        rules = P.default_rules(mesh.axis_names)
        model = build_on_mesh(cfg, device, rules, mesh, seed=0)
    else:
        model = build_model(cfg, args.device, seed=0)
    max_len = args.prompt_len + args.new_tokens + 8
    rng = np.random.default_rng(0)
    reqs = [
        Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32),
            max_new_tokens=args.new_tokens,
        )
        for i in range(args.requests)
    ]
    if cfg.family in ("encdec", "vlm"):
        done = serve_with_memory(cfg, model, reqs, max_len, args.seed)
    else:
        engine = ServingEngine(cfg, model, max_batch=args.max_batch, max_len=max_len,
                               device=args.device, mesh=mesh, rules=rules)
        done = engine.run(reqs)
    for r in done:
        log.info("request %d -> %s", r.rid, r.out_tokens)
    where = "" if mesh is None else f" on rank {D.mesh_rank(mesh)} of a {mesh.sizes} mesh"
    print(f"served {len(done)} requests{where}")
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return done


def _mesh(spec: str, device):
    """The ``(data, model)`` mesh of ``--mesh DATA,MODEL`` over the ranks ``torchrun``
    started (RANK, WORLD_SIZE and the rendezvous in the environment), and this rank's
    device."""
    shape = tuple(int(x) for x in spec.split(","))
    if len(shape) != 2:
        raise ValueError(f"--mesh {spec!r}: expected DATA,MODEL")
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise RuntimeError(f"--mesh {spec} needs one process a rank: start it with `torchrun "
                           f"--nproc-per-node {shape[0] * shape[1]} -m "
                           "repro_torch.launch.serve ...`")
    _, dev = D.init_process_group(int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
                                  "env://", device=device)
    return D.make_mesh(shape, ("data", "model")), dev


def serve_with_memory(cfg, model, reqs, max_len: int, seed: int):
    """Greedy decoding of ``reqs`` (prompts of one length) in one batch through the step
    functions, with the stub frontend's memory drawn from ``seed``.  On a mesh (a model
    placed there, ``build_on_mesh``) every rank runs the steps on the whole batch under
    the model's rules: each step takes the rank's rows, and its next tokens, each the
    argmax over the vocabulary's blocks, are gathered over the data axes."""
    dev = model.embed.device
    rules, mesh = P.module_mesh(model) or (None, None)
    rows = () if mesh is None else P.batch_split(len(reqs), rules, mesh)
    whole = lambda t: D.all_gather_axes(t, mesh, rows, 0) if rows else t
    params = {k: p.detach() for k, p in model.named_parameters()}
    prompts = torch.as_tensor(np.stack([r.prompt for r in reqs]), device=dev)
    (memory,) = modality_stub(cfg, len(reqs), seed).values()
    memory = torch.as_tensor(memory, device=dev).to(torch_dtype(cfg.compute_dtype))
    with P.use_rules(rules, mesh):
        caches = model.init_cache(len(reqs), max_len)
        logits, caches = steps.make_prefill_step(cfg)(params, prompts, caches, memory)
        token = whole(model.greedy(logits[:, -1, :]).to(torch.int32)[:, None])
        out = [token]
        serve_step = steps.make_serve_step(cfg)
        for i in range(max(r.max_new_tokens for r in reqs) - 1):
            token, caches = serve_step(params, token, caches, prompts.shape[1] + i)
            token = whole(token)
            out.append(token)
    out = torch.cat(out, dim=1).cpu().numpy()
    for r, row in zip(reqs, out):
        r.out_tokens = [int(t) for t in row[:r.max_new_tokens]]
        r.done = True
    return reqs


if __name__ == "__main__":
    main()
