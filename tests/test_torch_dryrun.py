"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX package's (CPU).

JAX lowers each cell's step and reads XLA's memory analysis; the port runs rank 0's
side of the step on ``meta`` tensors, the mesh in dry mode
(``core.distributed.AxisMesh.dry_run``).  Referees:
  * the argument bytes of ``yi-9b``, ``phi3.5-moe-42b-a6.6b``, ``minicpm3-4b``,
    ``whisper-medium`` and ``llama-3.2-vision-90b`` x ``train_4k`` /
    ``prefill_32k`` / ``decode_32k`` on ``pod16x16``: the sum of JAX's per-device
    blocks of the same arguments, from ``repro.sharding.partition.fit_spec`` and
    ``default_rules(...).spec(axes)`` on JAX's abstract parameters, optimizer state,
    batch, caches and a prefill's frames or image tokens (pure functions: no 256
    devices);
  * the attention families' cells run ``ok`` on both production meshes (rank 0's
    step on ``meta``: ``prefill_32k`` and ``decode_32k`` on each, ``train_4k`` on
    ``pod16x16``), ``long_500k`` skipped with JAX's reason;
  * the dry mode's recorded collectives, ``(op, shape)`` in order, for one train,
    prefill and serve step of ``phi3.5-moe-42b-a6.6b.reduced()`` on a sizes-only
    (2, 2) mesh: a live 4-rank gloo run's (rank 0) of the same steps, run as
    ``python tests/test_torch_dryrun.py live RANK 4 DIR``;
  * the records: JAX's keys and cell ids, a ``long_500k`` cell of a dense arch
    skipped with JAX's reason, a family the mesh does not run recorded as an error
    naming ROADMAP A4 (e), ``parse_collectives`` and ``_shape_bytes`` as
    tests/test_roofline_tools.py holds JAX's.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
THIS = os.path.abspath(__file__)
TIMEOUT_S = 180
NAMES = ("data", "model")
REDUCED = dict(train=(8, 16), prefill=(4, 16), decode=(4, 16))    # (batch, seq)
ARCHS = ("yi-9b", "phi3.5-moe-42b-a6.6b", "minicpm3-4b", "whisper-medium",
         "llama-3.2-vision-90b")
ATTN_ARCHS = ARCHS[2:]              # the attention families: MLA, encoder-decoder, VLM
SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def _reduced_cfg():
    from repro_torch.configs import get_config

    return get_config("phi3.5-moe-42b-a6.6b").reduced()


def _shape(kind):
    from repro_torch.configs.base import ShapeConfig

    b, s = REDUCED[kind]
    return ShapeConfig(f"reduced_{kind}", kind, s, b)


# -- the live ranks ---------------------------------------------------------------------

def job_live(rank, world, out_dir):
    """One train, prefill and serve step of the reduced MoE on a live (2, 2) mesh; rank
    0's recorded collectives."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import distributed as D
    from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
    from repro_torch.models import build_on_mesh
    from repro_torch.sharding import partition as P
    from repro_torch.training.optim import init_opt_state

    D.init_process_group(world, rank, f"file://{os.path.join(out_dir, 'live.store')}",
                         device="cpu", timeout_s=60)
    cfg = _reduced_cfg()
    mesh = D.make_mesh((2, 2), NAMES)
    rules = P.default_rules(NAMES)
    model = build_on_mesh(cfg, "cpu", rules, mesh)
    params = {k: p.detach() for k, p in model.named_parameters()}
    rng = np.random.default_rng(0)
    ints = lambda *s: torch.from_numpy(rng.integers(0, cfg.vocab_size, s).astype(np.int32))
    out = {}
    with P.use_rules(rules, mesh):
        tcfg = TrainConfig()
        b, s = REDUCED["train"]
        state = {"params": {k: t.clone() for k, t in params.items()},
                 "opt": init_opt_state(params, tcfg.optimizer)}
        with D.record_collectives() as rec:
            make_train_step(cfg, tcfg)(state, {"tokens": ints(b, s), "labels": ints(b, s)})
        out["train"] = rec
        b, s = REDUCED["prefill"]
        with D.record_collectives() as rec:
            make_prefill_step(cfg)(params, ints(b, s), model.init_cache(b, s))
        out["prefill"] = rec
        b, s = REDUCED["decode"]
        with D.record_collectives() as rec:
            make_serve_step(cfg)(params, ints(b, 1), model.init_cache(b, s),
                                 torch.tensor(s - 1, dtype=torch.int32))
        out["decode"] = rec
    return {k: [[r["op"], list(r["shape"])] for r in v] for k, v in out.items()}


def main(argv):
    job, rank, world, out_dir = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    res = {"live": job_live}[job](rank, world, out_dir)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{job}.{rank}.json"), "w") as f:
        json.dump(res, f)


# -- the tests' side ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def live(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun"))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    env.pop("LOCAL_RANK", None)
    procs = []
    for r in range(4):
        log = open(os.path.join(out, f"live.{r}.log"), "w")
        procs.append(subprocess.Popen([sys.executable, THIS, "live", str(r), "4", out],
                                      env=env, stdout=log, stderr=subprocess.STDOUT))
    yield procs, out
    for p in procs:
        if p.poll() is None:
            p.kill()


def _live_ops(live):
    procs, out = live
    deadline = time.monotonic() + TIMEOUT_S
    for r, p in enumerate(procs):
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"live rank {r} still running after {TIMEOUT_S} s")
        if p.returncode != 0:
            with open(os.path.join(out, f"live.{r}.log")) as f:
                raise AssertionError(f"live rank {r} exited {p.returncode}:\n{f.read()[-3000:]}")
    with open(os.path.join(out, "live.0.json")) as f:
        return json.load(f)


def _jax_block_bytes(cfg, shape, sizes):
    """The bytes of one device's blocks of every argument of JAX's dry-run step of the
    cell (``fit_spec`` of ``default_rules``' spec of each leaf's logical axes)."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import OptimizerConfig
    from repro.launch import specs
    from repro.launch.steps import abstract_train_state
    from repro.models import build_model
    from repro.sharding.partition import default_rules, fit_spec

    rules = default_rules(tuple(sizes))
    is_axes = lambda x: isinstance(x, tuple) and all(isinstance(a, str) or a is None for a in x)

    def block(leaf, axes):
        spec = fit_spec(tuple(leaf.shape), rules.spec(axes), sizes)
        n = int(np.prod(leaf.shape)) if leaf.shape else 1
        for entry in spec:
            for a in ((entry,) if isinstance(entry, str) else tuple(entry or ())):
                n //= sizes[a]
        return n * jnp.dtype(leaf.dtype).itemsize

    def total(tree, axes):
        return sum(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            block, tree, axes, is_leaf=lambda x: is_axes(x) or hasattr(x, "shape"))))

    model = build_model(cfg)
    GB, S = shape.global_batch, shape.seq_len
    i32 = lambda *s: jax.ShapeDtypeStruct(s, jnp.int32)
    if shape.kind == "train":
        state, axes = abstract_train_state(cfg, OptimizerConfig())
        batch = specs.batch_specs(cfg, shape)
        return total(state, axes) + total(batch, specs._batch_axes(cfg, shape))
    params, axes = model.init(jax.random.PRNGKey(0), abstract=True)
    caches = model.init_cache(GB, S, abstract=True)
    n = total(params, axes) + total(caches, model.cache_logical_axes())
    if shape.kind == "prefill":
        n += total({"t": i32(GB, S)}, {"t": ("batch", "seq")})
        ins = specs.input_specs(cfg, shape)
        if "memory" in ins:             # an encoder-decoder's frames, a VLM's image tokens
            n += total({"m": ins["memory"]}, {"m": ins["memory_axes"]})
        return n
    return n + total({"t": i32(GB, 1), "i": i32()}, {"t": ("batch", "seq"), "i": ()})


@pytest.mark.parametrize("shape_name", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_are_the_jax_blocks(arch, shape_name):
    from repro.configs import SHAPES_BY_NAME as JSHAPES
    from repro.configs import get_config as jget_config
    from repro_torch.configs import SHAPES_BY_NAME, get_config
    from repro_torch.core import distributed as D
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import production_shape
    from repro_torch.launch.specs import rules_for_shape

    mesh = D.sizes_mesh(*production_shape(False))
    shape = SHAPES_BY_NAME[shape_name]
    rules = rules_for_shape(mesh, shape)
    dry = mesh.dry_run()
    _, _, got = dryrun.step_args(get_config(arch), shape, dry, rules,
                                 dryrun.train_config(arch, {}))
    want = _jax_block_bytes(jget_config(arch), JSHAPES[shape_name], mesh.sizes)
    assert got == want


@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
def test_dry_mode_records_the_live_collectives(live, kind):
    from repro_torch.core import distributed as D
    from repro_torch.launch import dryrun
    from repro_torch.sharding import partition as P

    mesh = D.sizes_mesh((2, 2), NAMES)
    res = dryrun.run_step(_reduced_cfg(), _shape(kind), mesh, P.default_rules(NAMES),
                          dryrun.train_config("phi3.5-moe-42b-a6.6b", {}))
    dry = [[r["op"], list(r["shape"])] for r in res["ops"]]
    assert dry and dry == _live_ops(live)[kind]
    assert res["flops"] > 0 and res["argument_bytes"] > 0 and res["output_bytes"] > 0
    summary = dryrun.summarize_collectives(res["ops"])
    for op, kind_ in (("all_reduce", "all-reduce"), ("all_gather", "all-gather")):
        assert summary[kind_]["count"] == sum(r["op"] == op for r in res["ops"])


def test_records_keep_the_jax_keys_and_skips(tmp_path):
    from repro.configs import SHAPES_BY_NAME as JSHAPES
    from repro.configs import get_config as jget_config
    from repro.configs import shape_applicable as jshape_applicable
    from repro_torch.launch import dryrun

    skip = dryrun.run_cell("yi-9b", "long_500k", False, tmp_path)
    assert skip["status"] == "skipped"
    assert skip["reason"] == jshape_applicable(jget_config("yi-9b"), JSHAPES["long_500k"])[1]
    err = dryrun.run_cell("xlstm-1.3b", "decode_32k", True, tmp_path)
    assert err["status"] == "error" and err["mesh"] == "pod2x16x16"
    assert err["error"].startswith("NotImplementedError") and "A4 (e)" in err["error"]
    ok = dryrun.run_cell("phi3.5-moe-42b-a6.6b", "decode_32k", False, tmp_path,
                         tag="__reduced", cfg_override=_reduced_cfg())
    assert ok["status"] == "ok", ok.get("traceback")
    assert {"arch", "shape", "mesh", "kind", "seq_len", "global_batch", "devices",
            "memory_analysis", "cost_analysis", "collectives", "wall_s"} <= set(ok)
    assert ok["devices"] == 256 and ok["cost_analysis"]["flops"] > 0
    mem = ok["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0 and mem["output_size_in_bytes"] > 0
    assert "temp_size_in_bytes" in mem["not_measured"] and "temp_size_in_bytes" not in mem
    assert ok["collectives"]["total_wire_bytes"] > 0 and ok["static_bounds"]
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        f"{a}.json" for a in ("yi-9b__long_500k__pod16x16",
                              "xlstm-1.3b__decode_32k__pod2x16x16",
                              "phi3.5-moe-42b-a6.6b__decode_32k__pod16x16__reduced"))


@pytest.mark.parametrize("cell", [(a, s, m) for a in ATTN_ARCHS
                                  for s, m in (("prefill_32k", False), ("prefill_32k", True),
                                               ("decode_32k", False), ("decode_32k", True),
                                               ("train_4k", False))],
                         ids=lambda c: f"{c[0]}-{c[1]}-{'pod2x16x16' if c[2] else 'pod16x16'}")
def test_attention_family_cells_run_on_the_production_meshes(cell, tmp_path):
    """MLA, the encoder-decoder and the VLM on the LM mesh: rank 0's step of the cell runs
    on ``meta`` (a prefill with the frames or image tokens, a decode reading the cached
    cross-attention keys), with flops, argument bytes and collectives recorded."""
    from repro_torch.launch import dryrun

    arch, shape, multi = cell
    rec = dryrun.run_cell(arch, shape, multi, tmp_path)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["devices"] == (512 if multi else 256)
    assert rec["cost_analysis"]["flops"] > 0
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
    assert rec["collectives"]["total_wire_bytes"] > 0
    assert rec["collectives"]["all-reduce"]["count"] > 0      # the heads' partial sums


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_attention_family_long_context_cell_is_skipped_as_jax(arch, tmp_path):
    from repro.configs import SHAPES_BY_NAME as JSHAPES
    from repro.configs import get_config as jget_config
    from repro.configs import shape_applicable as jshape_applicable
    from repro_torch.launch import dryrun

    rec = dryrun.run_cell(arch, "long_500k", True, tmp_path)
    assert rec["status"] == "skipped"
    assert rec["reason"] == jshape_applicable(jget_config(arch), JSHAPES["long_500k"])[1]


def test_ported_hlo_helpers_keep_their_contract():
    from repro_torch.launch.dryrun import _shape_bytes, parse_collectives

    assert _shape_bytes("f32[128,256]") == 128 * 256 * 4
    assert _shape_bytes("(f32[4], bf16[2,2])") == 16 + 8
    hlo = """
  %ag = bf16[4096,1024]{1,0} all-gather(%p0), replica_groups=...
  %ar.1 = f32[512]{0} all-reduce(%x), to_apply=%sum
  %ars = (f32[256]{0}, f32[256]{0}) all-reduce-start(%y)
  %ard = f32[256]{0} all-reduce-done(%ars)
"""
    out = parse_collectives(hlo)
    assert out["all-gather"]["result_bytes"] == 4096 * 1024 * 2
    assert out["all-reduce"]["count"] == 2
    assert out["all-reduce"]["wire_bytes"] == 2.0 * out["all-reduce"]["result_bytes"]


if __name__ == "__main__":
    main(sys.argv[1:])
