"""Serving on the port's LM mesh against the JAX package (CPU): sharded prefill and
decode steps, the engine and the OT router over ``torch.distributed`` gloo ranks.

A mesh needs one process per rank, so the ranks run this file as a script,
``python tests/test_torch_serve_mesh.py serve RANK WORLD DIR`` (gloo, a
``file://`` store under ``DIR``, one intra-op thread, a process-group timeout and
a subprocess timeout); each rank writes what it saw to ``DIR/serve{WORLD}.RANK.json``
and rank 0 the gathered logits and caches to ``DIR/serve{WORLD}.npz``.  One 4-rank
job runs the (2, 2) mesh, one 2-rank job the (1, 2) and (2, 1) meshes (a mesh spans
the whole process group); the JAX references run here meanwhile, on one device.

Cases, at reduced sizes, float32: ``yi-9b.reduced()`` (dense; also with
``kv_quant``), ``phi3.5-moe-42b-a6.6b.reduced()`` (MoE, top-k) and the same with
``ot_balance`` (the OT router, 2 layers).  Every case starts from JAX's init,
carried to each rank's blocks by ``convert.lm_params_from_numpy(mesh=)``, and the
JAX zero cache by ``convert.lm_cache_from_numpy(mesh=)``.  Referees: JAX's
``make_prefill_step`` / ``make_serve_step`` on one device (a prefill of 4 x 12
tokens, then 3 greedy decode steps at a per-slot index): last-token logits within
rtol / atol 1e-5, the caches gathered (``convert.lm_cache_to_numpy``) within 1e-6
(``kv_quant``'s int8 within one step and its scales within 1e-6: the mesh sums the
heads' partial products in another order, which can move a value across a rounding
boundary), the greedy tokens equal; JAX's ``ServingEngine`` on 4 requests of 5-14
prompt tokens (through 4 slots, and the dense case through 3, which no data axis
divides): ``out_tokens`` equal.  The OT router's case is held to the port's
one device on (2, 1) (its router's L-BFGS leaves JAX's trajectory, ROADMAP C), and
on every mesh each routing is the one-device ``ot_route`` of the whole batch's
router logits, bit for bit.  Every rank's replicated outputs (tokens, gathered
logits and caches, the routes at prefill) are bitwise equal, and a rerun repeats
them.  The distributed argmax picks the first index on logits
with planted ties across the vocabulary's blocks.
"""
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
THIS = os.path.abspath(__file__)
TIMEOUT_S = 240
NAMES = ("data", "model")
MESHES = {4: ((2, 2),), 2: ((1, 2), (2, 1))}
B, S, MAX_LEN, DECODES = 4, 12, 32, 3
PROMPTS = (5, 14, 9, 7)                 # the engine's requests
NEW = 4
ENGINE_CASES = ("dense", "moe", "ot")
TOL = dict(rtol=1e-5, atol=1e-5)
CACHE_ATOL = 1e-6


def _configs(get_config):
    """case -> config, for either package's ``get_config``."""
    dense = get_config("yi-9b").reduced()
    moe = get_config("phi3.5-moe-42b-a6.6b").reduced()
    ot = dataclasses.replace(moe, num_layers=2,
                             moe=dataclasses.replace(moe.moe, ot_balance=True))
    return {"dense": dense, "kvq": dataclasses.replace(dense, kv_quant=True), "moe": moe,
            "ot": ot}


def _inputs(vocab):
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "prompts": [rng.integers(0, vocab, n).astype(np.int32) for n in PROMPTS]}


def _digest(*arrays) -> str:
    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _nest(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


# -- the ranks' side -------------------------------------------------------------------

def _jax_trees(out_dir, case):
    """JAX's init and zero cache of ``case`` (nested numpy trees)."""
    with np.load(os.path.join(out_dir, "jax_init.npz")) as z:
        pick = lambda kind: _nest({k.split(":", 2)[2]: z[k] for k in z.files
                                   if k.startswith(f"{kind}:{case}:")})
        return pick("params"), pick("cache")


def _gather(t, mesh, dims):
    """``t`` all-gathered over each ``(dim, axes)`` of ``dims``."""
    from repro_torch.core import distributed as D

    for dim, axes in dims:
        t = D.all_gather_axes(t, mesh, axes, dim)
    return t


def _run_steps(cfg, params, jcache, mesh, rules, tokens):
    """The prefill step, then DECODES serve steps, on the mesh: (gathered logits,
    tokens (B, 1 + DECODES), the gathered cache)."""
    from repro_torch import convert
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.sharding import partition as P

    caches = convert.lm_cache_from_numpy(cfg, jcache, mesh=mesh, rules=rules)
    rows = P.batch_split(B, rules, mesh)
    vocab = tuple(a for a in rules.lookup("vocab") if mesh.sizes.get(a, 1) > 1)
    with P.use_rules(rules, mesh):
        logits, caches = make_prefill_step(cfg)(params, torch.from_numpy(tokens), caches)
        logits = _gather(logits, mesh, ((2, vocab), (0, rows)))
        tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
        out = [tok]
        serve = make_serve_step(cfg)
        for i in range(DECODES):
            index = torch.full((B,), S + i, dtype=torch.int32)
            tok, caches = serve(params, tok, caches, index)
            tok = _gather(tok, mesh, ((0, rows),))
            out.append(tok)
    whole = convert.lm_cache_to_numpy(cfg, caches)
    return logits.numpy(), torch.cat(out, dim=1).numpy(), whole


def _serve(cfg, params, mesh, prompts, check=True, max_batch=B):
    """The engine on the mesh: (each request's tokens, a digest of the routes of the
    batch-1 prefills, the same on every rank, and for the OT router whether every
    routing is the one-device ``ot_route`` of the whole batch's router logits)."""
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.sharding import partition as P
    from repro_torch.training import ot_routing

    engine = ServingEngine(cfg, params, max_batch=max_batch, max_len=MAX_LEN, device="cpu",
                           mesh=mesh)
    moes = [b.moe for b in engine.model.blocks if hasattr(b, "moe")]
    inputs = []
    for m in moes:
        m.routes = []
        m.register_forward_hook(lambda mod, args, out: inputs.append((mod, args[0])))
    done = engine.run([Request(rid=i, prompt=p, max_new_tokens=NEW)
                       for i, p in enumerate(prompts)])
    routes = [r for m in moes for r in m.routes]
    prefills = [(i.numpy(), w.numpy()) for i, w in routes if i.shape[0] > B]
    same = None
    if check and cfg.moe is not None and cfg.moe.ot_balance:
        seen, same = {id(m): 0 for m in moes}, True
        for mod, x in inputs:
            topi, topw = mod.routes[seen[id(mod)]]
            seen[id(mod)] += 1
            axes = () if x.shape[1] > 1 else engine._data      # a prefill's one row: whole
            logits = x.reshape(-1, x.shape[-1]) @ P.weight(mod, "router", keep=())
            whole = _gather(logits.float(), mesh, ((0, axes),))
            ti, tw = ot_routing.ot_route(whole, num_seqs=whole.shape[0] // x.shape[1],
                                         seq_len=x.shape[1], top_k=cfg.moe.top_k,
                                         gamma=cfg.moe.ot_gamma, rho=cfg.moe.ot_rho)
            got_i, got_w = (_gather(t, mesh, ((0, axes),)) for t in (topi, topw))
            same &= torch.equal(got_i, ti) and torch.equal(got_w, tw.float())
    return ({r.rid: r.out_tokens for r in done}, _digest(*[a for r in prefills for a in r]),
            same)


def _argmax_cases(mesh):
    """The distributed argmax over a vocabulary split over every axis of the mesh, 8
    entries a rank, on rows with planted ties: (got, want) lists."""
    from repro_torch.core import distributed as D

    axes = tuple(a for a in NAMES if mesh.sizes[a] > 1)
    n = mesh.group_size(axes)
    V = 8 * n
    rows = np.zeros((5, V), np.float32)
    rows[0, [3, 8 + 1, V - 1]] = 2.0          # ties in the first and later blocks
    rows[1, [9, 8 + 6, V - 2]] = 1.5          # the first maximum in the second block
    rows[2, :] = -1.0                         # every entry equal
    rows[3, [V - 8, V - 1]] = 5.0             # only the last block
    rows[4, [0, 1]] = 0.5                     # the first two of the first block
    want = np.argmax(rows, axis=-1).tolist()
    pos = mesh.position(axes)
    block = torch.from_numpy(rows[:, pos * 8:(pos + 1) * 8].copy())
    return D.argmax_axes(block, mesh, axes, pos * 8).tolist(), want


def job_serve(rank, world, out_dir):
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core import distributed as D
    from repro_torch.sharding import partition as P

    D.init_process_group(world, rank, f"file://{os.path.join(out_dir, f'serve{world}.store')}",
                         device="cpu", timeout_s=60)
    cfgs = _configs(get_config)
    res, arrays = {}, {}
    for shape in MESHES[world]:
        mesh = D.make_mesh(shape, NAMES)
        rules = P.default_rules(NAMES)
        tag = "x".join(map(str, shape))
        res[f"argmax.{tag}"] = _argmax_cases(mesh)
        for case, cfg in cfgs.items():
            ins = _inputs(cfg.vocab_size)
            ptree, ctree = _jax_trees(out_dir, case)
            params = convert.lm_params_from_numpy(cfg, ptree, mesh=mesh, rules=rules)
            runs = [_run_steps(cfg, params, ctree, mesh, rules, ins["tokens"])
                    for _ in range(2)]
            logits, tokens, cache = runs[0]
            res[f"steps.{tag}.{case}"] = {
                "tokens": tokens.tolist(),
                "digests": [_digest(lg, tk, *_flat(c).values()) for lg, tk, c in runs]}
            arrays[f"{tag}.{case}.logits"] = logits
            arrays.update({f"{tag}.{case}.cache:{k}": v for k, v in cache.items()})
            if case in ENGINE_CASES:
                res[f"engine.{tag}.{case}"] = [_serve(cfg, params, mesh, ins["prompts"], check)
                                               for check in (True, False)]
            if case == "dense":      # 3 slots: no data axis divides them, each rank has all;
                whole = convert.lm_params_from_numpy(cfg, ptree)    # whole leaves, cut there
                res[f"engine3.{tag}"] = _serve(cfg, whole, mesh, ins["prompts"],
                                               max_batch=3)[0]
    if rank == 0:
        np.savez(os.path.join(out_dir, f"serve{world}.npz"), **arrays)
    return res


JOBS = {"serve": job_serve}


def main(argv):
    job, rank, world, out_dir = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    res = JOBS[job](rank, world, out_dir)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{job}{world}.{rank}.json"), "w") as f:
        json.dump(res, f)


# -- the tests' side ---------------------------------------------------------------------

def _rank_env() -> dict:
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    env.pop("LOCAL_RANK", None)
    return env


def _start(job, world, out_dir):
    procs = []
    for r in range(world):
        log = open(os.path.join(out_dir, f"{job}{world}.{r}.log"), "w")
        procs.append(subprocess.Popen([sys.executable, THIS, job, str(r), str(world), out_dir],
                                      env=_rank_env(), stdout=log, stderr=subprocess.STDOUT))
    return procs


def _finish(name, procs, out_dir, deadline):
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"{name}: ranks still running after {TIMEOUT_S} s")
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(out_dir, f"{name}.{r}.log")) as f:
                raise AssertionError(f"{name} rank {r} exited {p.returncode}:\n{f.read()[-3000:]}")
    out = []
    for r in range(len(procs)):
        with open(os.path.join(out_dir, f"{name}.{r}.json")) as f:
            out.append(json.load(f))
    return out


def _jax_references(cfgs, inits):
    """JAX's steps and engine on one device, from the same inits and inputs."""
    from repro.launch import steps as jsteps
    from repro.models import build_model as jbuild_model
    from repro.serving import engine as jengine

    ref = {}
    for case, jcfg in cfgs.items():
        params = inits[case]
        model = jbuild_model(jcfg)
        ins = _inputs(jcfg.vocab_size)
        logits, caches = jax.jit(jsteps.make_prefill_step(jcfg))(
            params, jnp.asarray(ins["tokens"]), model.init_cache(B, MAX_LEN))
        tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
        out = [tok]
        serve = jax.jit(jsteps.make_serve_step(jcfg))
        for i in range(DECODES):
            tok, caches = serve(params, tok, caches, jnp.full((B,), S + i, jnp.int32))
            out.append(tok)
        ref[f"{case}.logits"] = np.asarray(logits)
        ref[f"{case}.tokens"] = np.asarray(jnp.concatenate(out, axis=1))
        ref[f"{case}.cache"] = jax.tree_util.tree_map(np.asarray, caches)
        for n in ((B, 3) if case == "dense" else (B,) if case == "moe" else ()):
            engine = jengine.ServingEngine(jcfg, params, max_batch=n, max_len=MAX_LEN)
            done = engine.run([jengine.Request(rid=i, prompt=p, max_new_tokens=NEW)
                               for i, p in enumerate(ins["prompts"])])
            ref[f"{case}.engine" + ("" if n == B else str(n))] = {r.rid: r.out_tokens
                                                                 for r in done}
    return ref


def _port_references(cfg, init):
    """The OT router's case on one device of the port (the steps and the engine), from
    the same init: the router's L-BFGS leaves JAX's trajectory (ROADMAP C), so the mesh
    is held to this, and to JAX as closely as this is."""
    from repro_torch import convert
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import build_model
    from repro_torch.serving.engine import Request, ServingEngine

    params = convert.lm_params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, init))
    model = build_model(cfg, device="meta")
    ins = _inputs(cfg.vocab_size)
    caches = [{k: torch.zeros(t.shape, dtype=t.dtype) for k, t in c.items()}
              for c in model.init_cache(B, MAX_LEN, abstract=True)]
    logits, caches = make_prefill_step(cfg)(params, torch.from_numpy(ins["tokens"]), caches)
    tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
    out = [tok]
    for i in range(DECODES):
        tok, caches = make_serve_step(cfg)(params, tok, caches,
                                           torch.full((B,), S + i, dtype=torch.int32))
        out.append(tok)
    engine = ServingEngine(cfg, params, max_batch=B, max_len=MAX_LEN, device="cpu")
    done = engine.run([Request(rid=i, prompt=p, max_new_tokens=NEW)
                       for i, p in enumerate(ins["prompts"])])
    return {"logits": logits.numpy(), "tokens": torch.cat(out, dim=1).numpy(),
            "cache": convert.lm_cache_to_numpy(cfg, caches),
            "engine": {r.rid: r.out_tokens for r in done}}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """JAX's inits, then both rank jobs, with the JAX references made while they run."""
    from repro.configs import get_config as jget_config
    from repro.models import build_model as jbuild_model

    out = str(tmp_path_factory.mktemp("serve_mesh"))
    cfgs = _configs(jget_config)
    inits, flat = {}, {}
    for case, jcfg in cfgs.items():
        model = jbuild_model(jcfg)
        inits[case] = model.init(jax.random.PRNGKey(0))[0]
        flat.update({f"params:{case}:{k}": v for k, v in
                     _flat(jax.tree_util.tree_map(np.asarray, inits[case])).items()})
        flat.update({f"cache:{case}:{k}": v for k, v in
                     _flat(jax.tree_util.tree_map(np.asarray,
                                                  model.init_cache(B, MAX_LEN))).items()})
    np.savez(os.path.join(out, "jax_init.npz"), **flat)
    deadline = time.monotonic() + TIMEOUT_S
    started = {}
    try:
        started = {f"serve{w}": _start("serve", w, out) for w in (4, 2)}
        ref = _jax_references(cfgs, inits)
        from repro_torch.configs import get_config

        res = {"one": _port_references(_configs(get_config)["ot"], inits["ot"])}
        res.update({name: _finish(name, procs, out, deadline)
                    for name, procs in started.items()})
    finally:
        for p in [p for ps in started.values() for p in ps]:
            if p.poll() is None:
                p.kill()
    for w in (2, 4):
        with np.load(os.path.join(out, f"serve{w}.npz")) as z:
            res[f"npz{w}"] = {k: z[k] for k in z.files}
    res["jax"] = ref
    return res


SHAPES = [s for ss in MESHES.values() for s in ss]
CASES = ("dense", "kvq", "moe", "ot")


def _world(shape):
    return shape[0] * shape[1]


def _tag(shape):
    return "x".join(map(str, shape))


def _mesh_caches(arrays, tag, case):
    return {k.split(":", 1)[1]: v for k, v in arrays.items()
            if k.startswith(f"{tag}.{case}.cache:")}


def _close_caches(have, want):
    assert sorted(have) == sorted(want)
    for k, v in want.items():
        assert have[k].shape == v.shape and have[k].dtype == v.dtype, k
        if v.dtype == np.int8:
            assert np.max(np.abs(have[k].astype(np.int32) - v)) <= 1, k
        else:
            np.testing.assert_allclose(have[k], v, rtol=CACHE_ATOL, atol=CACHE_ATOL, err_msg=k)


@pytest.mark.parametrize("case", ("dense", "kvq", "moe"))
@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_prefill_and_serve_steps_on_the_mesh_match_jax(jobs, shape, case):
    world, tag = _world(shape), _tag(shape)
    arrays, ref = jobs[f"npz{world}"], jobs["jax"]
    np.testing.assert_allclose(arrays[f"{tag}.{case}.logits"], ref[f"{case}.logits"], **TOL)
    got = jobs[f"serve{world}"][0][f"steps.{tag}.{case}"]
    np.testing.assert_array_equal(np.array(got["tokens"]), ref[f"{case}.tokens"])
    _close_caches(_mesh_caches(arrays, tag, case), _flat(ref[f"{case}.cache"]))


def test_ot_router_on_the_data_axes_matches_one_device(jobs):
    """The OT-routed case on (2, 1), whose router logits are one device's bits: the
    steps held to the port's one device at the same tolerances (the same tokens), and to
    JAX as closely as the port's one device is (its router's L-BFGS leaves JAX's
    trajectory, ROADMAP C); the engine's tokens the one-device engine's."""
    arrays, one, ref = jobs["npz2"], jobs["one"], jobs["jax"]
    logits = arrays["2x1.ot.logits"]
    np.testing.assert_allclose(logits, one["logits"], **TOL)
    got = jobs["serve2"][0]["steps.2x1.ot"]
    np.testing.assert_array_equal(np.array(got["tokens"]), one["tokens"])
    _close_caches(_mesh_caches(arrays, "2x1", "ot"), one["cache"])
    off = np.max(np.abs(one["logits"] - ref["ot.logits"]))
    assert np.max(np.abs(logits - ref["ot.logits"])) <= off + TOL["atol"]
    tokens, _, _ = jobs["serve2"][0]["engine.2x1.ot"][0]
    assert {int(k): v for k, v in tokens.items()} == one["engine"]


@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_ot_router_on_the_mesh_solves_the_whole_batch(jobs, shape):
    """Every routing of the engine on the mesh (each MoE layer at every prefill and
    tick) is, bit for bit, the one-device ``ot_route`` of the whole batch's router
    logits.  Off the data axes the logits themselves are another summation order's (the
    heads' and experts' partial sums all-reduced over ``model``); the 40-iteration
    solve does not converge and moves with their last bits, as the port's moves off
    JAX's, so the tokens are held there only through these routes."""
    for r in jobs[f"serve{_world(shape)}"]:
        assert r[f"engine.{_tag(shape)}.ot"][0][2] is True


@pytest.mark.parametrize("case", ("dense", "moe"))
@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_engine_on_the_mesh_matches_jax(jobs, shape, case):
    got = jobs[f"serve{_world(shape)}"][0][f"engine.{_tag(shape)}.{case}"][0][0]
    assert {int(k): v for k, v in got.items()} == jobs["jax"][f"{case}.engine"]


@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_engine_with_slots_the_data_axes_do_not_divide(jobs, shape):
    """3 slots: every data shard decodes all of them (the batch replicated, as
    ``fit_spec`` drops the axis); the tokens are JAX's engine's."""
    got = jobs[f"serve{_world(shape)}"][0][f"engine3.{_tag(shape)}"]
    assert {int(k): v for k, v in got.items()} == jobs["jax"]["dense.engine3"]


def test_every_rank_and_a_rerun_give_the_same_bits(jobs):
    for world in (2, 4):
        ranks = jobs[f"serve{world}"]
        for key, val in ranks[0].items():
            if key.startswith("steps."):
                assert val["digests"][0] == val["digests"][1], (world, key)
            if key.startswith("engine."):
                assert val[0][:2] == val[1][:2], (world, key)
            for r in ranks[1:]:
                assert r[key] == val, (world, key)


@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_distributed_argmax_takes_the_first_index_among_ties(jobs, shape):
    for r in jobs[f"serve{_world(shape)}"]:
        got, want = r[f"argmax.{_tag(shape)}"]
        assert got == want == [3, 9, 0, 8 * _world(shape) - 8, 0], (got, want)


def test_an_engine_on_a_mesh_of_sizes_only_raises():
    """A mesh with no rank for this process (no process group) does not fall back to one
    device; nor does a serve on a mesh without torchrun's ranks."""
    from repro_torch.configs import get_config
    from repro_torch.core import distributed as D
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServingEngine

    cfg = _configs(get_config)["dense"]
    model = build_model(cfg, "cpu")
    with pytest.raises(ValueError, match="no rank"):
        ServingEngine(cfg, model, max_batch=2, max_len=16, device="cpu",
                      mesh=D.sizes_mesh((1, 2), NAMES))
    env = {k: os.environ.pop(k) for k in ("RANK", "WORLD_SIZE") if k in os.environ}
    try:
        with pytest.raises(RuntimeError, match="torchrun"):
            serve.main(["--arch", "yi-9b", "--reduced", "--mesh", "1,2", "--device", "cpu"])
    finally:
        os.environ.update(env)


if __name__ == "__main__":
    main(sys.argv[1:])
