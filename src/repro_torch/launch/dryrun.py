"""Dry run of every (arch x shape x mesh) cell, as ``repro.launch.dryrun``.

For each cell this driver:
  1. takes the production mesh's sizes (16 x 16 single-pod or 2 x 16 x 16
     multi-pod) as a mesh of sizes only, the cell's rules
     (``specs.rules_for_shape``, then the named variant);
  2. places the parameters, the optimizer state (train) or the caches and
     inputs (prefill, decode) on ``meta`` (no allocation), each tensor
     carrying its placement (``launch/specs.py``);
  3. RUNS rank 0's side of the train, prefill or serve step on ``meta``
     tensors of its blocks, the mesh in dry mode
     (``core.distributed.AxisMesh.dry_run``): every collective records
     itself and returns a tensor of its output's shape without
     communicating;
  4. records into ``<out>/<cell>.json``: ``memory_analysis`` (rank 0's
     bytes of the step's arguments and outputs, from the placements),
     ``cost_analysis`` (``flops``, ``torch.utils.flop_counter`` over that
     run) and ``collectives`` (the recorded ops in the JAX record's kinds).

JAX lowers and compiles the step and reads XLA's memory analysis and
post-SPMD HLO; PyTorch has neither.  So the record has no
``temp_size_in_bytes`` (no compiled buffer plan; it says so under
``not_measured``), its collectives are the ones the port's step makes
(``parse_collectives``, kept for the JAX records, reads HLO text), and a
size the step reads on the host from a tensor's values takes its static
bound on ``meta`` (``static_bounds`` lists each: the MoE dispatch's
capacity block, a decode index on ``meta``).  A family the mesh does not
run yet (xLSTM, the Mamba hybrid) records ``status: "error"`` with the
``NotImplementedError`` (ROADMAP A4 (e)), as JAX's ``run_cell`` records a
failing cell.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out dryrun_artifacts]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import time
import traceback
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, SHAPES_BY_NAME, get_config, list_archs, shape_applicable
from repro_torch.configs.base import OptimizerConfig, TrainConfig
from repro_torch.core import distributed as D
from repro_torch.launch.mesh import production_shape
from repro_torch.launch.specs import input_specs, param_specs, rules_for_shape
from repro_torch.launch.steps import (
    abstract_train_state,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
from repro_torch.launch.variants import apply_variant
from repro_torch.sharding.partition import sharding_tree, use_rules
from repro_torch.utils.tree import tree_bytes

_COLLECTIVES = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# bytes-on-the-wire multiplier per result byte (ring algorithms, large N)
_WIRE_FACTOR = {
    "all-reduce": 2.0,        # reduce-scatter + all-gather
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
}

_SHAPE_RE = re.compile(r"\b(pred|[suf]\d+|bf16)\[([\d,]*)\]")

_OP_RE = re.compile(
    r"=\s*(?P<type>\(?[a-z0-9\[\],{}\s/#_\.]*?\)?)\s*"
    r"(?P<op>all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?P<async>-start|-done)?\("
)

#: the port's recorded ops (``core.distributed.record_collectives``) by JAX's kinds
_KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
          "reduce_scatter": "reduce-scatter", "send_recv": "collective-permute"}

TEMP_NOT_MEASURED = ("PyTorch has no compiled buffer plan: the step runs eagerly on meta "
                     "tensors, so its temporaries have no size before a run on the device")


def _shape_bytes(text: str) -> int:
    """Sum byte sizes of every typed shape token in an HLO result type."""
    total = 0
    for m in _SHAPE_RE.finditer(text):
        dt, dims = m.group(1), m.group(2)
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES.get(dt, 4)
    return total


def _empty_kinds() -> dict:
    return {k: {"count": 0, "result_bytes": 0, "wire_bytes": 0.0} for k in _COLLECTIVES}


def _total(out: dict) -> dict:
    out["total_wire_bytes"] = sum(v["wire_bytes"] for v in out.values() if isinstance(v, dict))
    return out


def parse_collectives(hlo_text: str) -> dict:
    """Per-collective-kind result bytes + wire-byte model from post-SPMD HLO (the JAX
    records').

    Sync ops contribute their result bytes; async '-start' ops carry an
    (operand, result) tuple type, so their byte count is halved; '-done' ops
    are skipped (the start already counted the transfer).
    """
    out = _empty_kinds()
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m:
            continue
        if m.group("async") == "-done":
            continue
        kind = m.group("op")
        b = _shape_bytes(m.group("type"))
        if m.group("async") == "-start":
            b //= 2
        out[kind]["count"] += 1
        out[kind]["result_bytes"] += b
        out[kind]["wire_bytes"] += b * _WIRE_FACTOR[kind]
    return _total(out)


def summarize_collectives(records) -> dict:
    """:func:`parse_collectives`'s record of the ops a step made on this rank
    (``core.distributed.record_collectives``): each op's result bytes (an all-gather's
    input times its ranks, a reduce-scatter's input over them, else its input), by JAX's
    kinds."""
    out = _empty_kinds()
    for r in records:
        kind = _KINDS[r["op"]]
        b = r["bytes"]
        if kind == "all-gather":
            b *= r["ranks"]
        elif kind == "reduce-scatter":
            b //= r["ranks"]
        out[kind]["count"] += 1
        out[kind]["result_bytes"] += b
        out[kind]["wire_bytes"] += b * _WIRE_FACTOR[kind]
    return _total(out)


def probe_layers(cfg, n_steps: int):
    """Config with the layer stack truncated to n_steps scan iterations (the JAX cost
    probes' cut; the port's layers are a loop, counted whole)."""
    kw = dict(unroll_layers=True)
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, num_layers=cfg.attn_period * n_steps, **kw)
    if cfg.family == "ssm":
        return dataclasses.replace(cfg, num_layers=cfg.ssm.slstm_every * n_steps, **kw)
    if cfg.family == "vlm":
        return dataclasses.replace(cfg, num_layers=cfg.cross_attn_period * n_steps, **kw)
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, num_layers=n_steps, encoder_layers=n_steps, **kw)
    return dataclasses.replace(cfg, num_layers=n_steps, **kw)


def _blocks(tree, pls=None):
    """``meta`` tensors of rank 0's blocks of a tree of ``meta`` tensors, placed by the
    like tree ``pls`` or each by its own ``placement``."""
    if isinstance(tree, dict):
        return {k: _blocks(v, None if pls is None else pls[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_blocks(v, None if pls is None else pls[i])
                          for i, v in enumerate(tree))
    pl = tree.placement if pls is None else pls
    return torch.empty(pl.local_shape, dtype=tree.dtype, device="meta")


def _whole(tree):
    """``meta`` tensors of the whole shapes of a tree of ``meta`` tensors."""
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def step_args(cfg, shape, mesh, rules, tcfg: TrainConfig):
    """(step, args, argument bytes): the cell's step and rank 0's arguments on ``meta``
    (blocks; the train batch, the tokens and the token whole, as the steps take them),
    and rank 0's bytes of its blocks of every argument."""
    ins = input_specs(cfg, shape, mesh, rules)
    if shape.kind == "train":
        state, state_axes = abstract_train_state(cfg, tcfg.optimizer)
        state = _blocks(state, sharding_tree(state_axes, rules, mesh, shapes=state))
        batch = ins["batch"]
        arg_bytes = tree_bytes(state) + tree_bytes(_blocks(batch))
        return make_train_step(cfg, tcfg), (state, _whole(batch)), arg_bytes
    params = _blocks(param_specs(cfg, mesh, rules)[0])
    caches = _blocks(ins["caches"])
    if shape.kind == "prefill":
        tokens = ins["tokens"]
        args = (params, _whole(tokens), caches)
        arg_bytes = tree_bytes((params, caches)) + tree_bytes(_blocks(tokens))
        if "memory" in ins:            # an encoder-decoder's frames, a VLM's image tokens
            args += (_whole(ins["memory"]),)
            arg_bytes += tree_bytes(_blocks(ins["memory"]))
        return make_prefill_step(cfg), args, arg_bytes
    token, index = ins["token"], ins["index"]
    arg_bytes = tree_bytes((params, caches)) + tree_bytes(_blocks((token, index)))
    return make_serve_step(cfg), (params, _whole(token), caches, _whole(index)), arg_bytes


def run_step(cfg, shape, mesh, rules, tcfg: TrainConfig) -> dict:
    """Rank 0's step of the cell on ``meta`` on ``mesh`` in dry mode: its argument and
    output bytes, flops, recorded collectives and static bounds."""
    dry = mesh.dry_run()
    with use_rules(rules, dry):
        step, args, arg_bytes = step_args(cfg, shape, dry, rules, tcfg)
        with D.record_collectives() as ops, D.record_static_bounds() as bounds, \
                FlopCounterMode(display=False) as flops:
            out = step(*args)
    return {"argument_bytes": arg_bytes, "output_bytes": tree_bytes(out),
            "flops": int(flops.get_total_flops()), "ops": list(ops), "static_bounds": bounds}


def train_config(arch: str, over: dict) -> TrainConfig:
    """The dry run's train config (JAX's: master weights but for the largest arch)."""
    return TrainConfig(optimizer=OptimizerConfig(master_weights=(arch != "jamba-1.5-large-398b")),
                       **over)


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             force: bool = False, rules_override=None, tag: str = "",
             cfg_override=None) -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell_id = f"{arch}__{shape_name}__{mesh_name}{tag}"
    art = out_dir / f"{cell_id}.json"
    if art.exists() and not force:
        return json.loads(art.read_text())

    cfg = cfg_override or get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    ok, why = shape_applicable(cfg, shape)
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": shape.kind, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
    }
    if not ok:
        record.update(status="skipped", reason=why)
        art.write_text(json.dumps(record, indent=2))
        return record

    t0 = time.time()
    mesh = D.sizes_mesh(*production_shape(multi_pod))
    rules = rules_override or rules_for_shape(mesh, shape)
    variant = tag[3:] if tag.startswith("__v") else None
    try:
        cfg, rules, tcfg_over = apply_variant(variant and variant.lstrip("_"), cfg, rules)
        t_run = time.time()
        res = run_step(cfg, shape, mesh, rules, train_config(arch, tcfg_over))
        record.update(
            status="ok",
            devices=int(mesh.size()),
            run_s=round(time.time() - t_run, 2),
            memory_analysis={"argument_size_in_bytes": res["argument_bytes"],
                             "output_size_in_bytes": res["output_bytes"],
                             "not_measured": {"temp_size_in_bytes": TEMP_NOT_MEASURED}},
            cost_analysis={"flops": float(res["flops"])},
            collectives=summarize_collectives(res["ops"]),
            static_bounds=res["static_bounds"],
        )
    except Exception as e:              # a failing cell is a record, as JAX's run_cell
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
    record["wall_s"] = round(time.time() - t0, 2)
    art.write_text(json.dumps(record, indent=2))
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=[s.name for s in SHAPES])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--probe", action="store_true",
                    help="run 1- and 2-scan-step variants (cost-model probes)")
    ap.add_argument("--variant", default=None,
                    help="named perf variant (see launch/variants.py)")
    ap.add_argument("--out", default="dryrun_artifacts")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    archs = list_archs() if args.all else [args.arch]
    shapes = [s.name for s in SHAPES] if args.all else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]

    n_ok = n_skip = n_err = 0
    for a, s, m in cells:
        if args.probe:
            cfg = get_config(a)
            for n in (1, 2):
                rec = run_cell(a, s, m, out_dir, force=args.force,
                               tag=f"__probe{n}", cfg_override=probe_layers(cfg, n))
                print(f"[{rec['status'].upper():5s}] probe{n} {a} {s}")
            continue
        tag = f"__v_{args.variant}" if args.variant else ""
        rec = run_cell(a, s, m, out_dir, force=args.force, tag=tag)
        tagm = "2x16x16" if m else "16x16"
        if rec["status"] == "ok":
            n_ok += 1
            print(f"[OK]   {a:26s} {s:12s} {tagm:8s} "
                  f"flops={rec['cost_analysis']['flops']:.3e} "
                  f"wire={rec['collectives']['total_wire_bytes']:.3e}B "
                  f"args={rec['memory_analysis']['argument_size_in_bytes']:.3e}B "
                  f"run={rec['run_s']}s")
        elif rec["status"] == "skipped":
            n_skip += 1
            print(f"[SKIP] {a:26s} {s:12s} {tagm:8s} {rec['reason']}")
        else:
            n_err += 1
            print(f"[ERR]  {a:26s} {s:12s} {tagm:8s} {rec['error']}")
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
