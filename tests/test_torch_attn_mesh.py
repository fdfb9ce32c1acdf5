"""The attention families on the port's LM mesh against the JAX package (CPU): MLA
(``minicpm3-4b``), the encoder-decoder (``whisper-medium``) and the VLM
(``llama-3.2-vision-90b``) trained, prefilled and decoded over ``torch.distributed``
gloo ranks.

A mesh needs one process per rank, so the ranks run this file as a script,
``python tests/test_torch_attn_mesh.py attn RANK WORLD DIR`` (gloo, a ``file://``
store under ``DIR``, one intra-op thread, a process-group timeout and a
subprocess timeout); each rank writes what it saw to ``DIR/attn{WORLD}.RANK.json``
and rank 0 the gathered parameters, logits and caches to ``DIR/attn{WORLD}.npz``.
One 4-rank job runs the (2, 2) mesh, one 2-rank job the (1, 2) and (2, 1) meshes;
one JAX subprocess on 4 forced host devices makes the references, all started
together.

Cases, reduced, float32: ``minicpm3-4b`` (2 layers), ``whisper-medium`` (2 + 2
layers; its reduced vocabulary, 512, splits over ``model``), the same with a
vocabulary of 509 (odd, as the published 51 865: no mesh axis divides it, so the
tied table stays whole on every rank), ``llama-3.2-vision-90b`` (two periods of 2
layers, each ``cross_gate`` drawn nonzero from numpy: at its zero init the cross
path adds nothing).  Every case starts from JAX's init, carried to each rank's
blocks by ``convert.lm_params_from_numpy(mesh=)``, and the JAX zero cache by
``convert.lm_cache_from_numpy(mesh=)``.  Referees and tolerances:
  * ``make_train_step`` (AdamW, one step on 8 x 16 tokens and the stub frontend's
    frames or image tokens) against JAX's one-device step, and on (2, 2) also
    against JAX's GSPMD step on a (2, 2) mesh under ``use_rules``: the loss within
    1e-6 relative, ``ce`` and ``grad_norm`` within 1e-5, AdamW's m (0.1 x the
    clipped gradient) within rtol 1e-4, each entry also within 1e-6 of its leaf's
    largest magnitude (``test_torch_lm_mesh.py``'s rule), the parameters within
    atol 1e-5 (1 % of the step's learning rate) wherever the reference's gradient
    is at least 1e-7 (10 x AdamW's eps).  Below that AdamW's first step, lr x g /
    (|g| + 1e-8), hands the gradient's last digits to the parameter: the port's
    one-device step lands up to 1.8e-5 from JAX's on such entries of these
    configs, so there the parameters are held within lr / 10 (their gradients
    are held through m);
  * ``Trainer(mesh=)`` with the OT alignment term (one step) against the port's
    one-device ``Trainer``: the loss within 1e-6 relative, the OT distance bit for
    bit, m and the parameters as above;
  * ``make_prefill_step`` (4 x 12 tokens, and the frames or image tokens) then 3
    greedy ``make_serve_step`` decodes (a per-slot index; the encoder-decoder's
    scalar) against JAX's steps on one device, fed the memory's projected
    ``cross_kv`` (JAX's cached cross-attention reads its cache's zeros: ROADMAP
    queue C): last-token logits within rtol / atol 1e-5, the caches gathered
    (``convert.lm_cache_to_numpy``) within 1e-6, the greedy tokens equal;
  * MLA through ``ServingEngine(mesh=)``, 4 requests of 5-14 prompt tokens in 4
    slots: ``out_tokens`` equal JAX's ``ServingEngine``'s.
Every rank's replicated outputs (metrics, tokens, gathered logits and caches) are
bitwise equal, and a rerun repeats them.  A one-rank mesh is the single-device path
bit for bit; ``check_mesh_family`` raises only for the recurrent families.
"""
import hashlib
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
THIS = os.path.abspath(__file__)
TIMEOUT_S = 240
NAMES = ("data", "model")
MESHES = {4: ((2, 2),), 2: ((1, 2), (2, 1))}
BATCH = dict(seq_len=16, global_batch=8, num_classes=4)
OPT = dict(lr=1e-3, warmup_steps=2)
OT = dict(ot_align=True, ot_align_weight=0.05, ot_grad_impl="screened")
B, S, MAX_LEN, DECODES = 4, 12, 32, 3
PROMPTS = (5, 14, 9, 7)                 # the MLA engine's requests
NEW = 4
CASES = ("mla", "encdec", "encdec_odd", "vlm")
LOSS_RTOL, METRIC_RTOL, PARAM_ATOL = 1e-6, 1e-5, 1e-5
TOL = dict(rtol=1e-5, atol=1e-5)
CACHE_ATOL = 1e-6


def _configs(get_config):
    """case -> config, for either package's ``get_config``."""
    mla = get_config("minicpm3-4b").reduced(num_layers=2)
    encdec = get_config("whisper-medium").reduced(num_layers=2)
    return {"mla": mla, "encdec": encdec,
            "encdec_odd": get_config("whisper-medium").reduced(num_layers=2, vocab_size=509),
            "vlm": get_config("llama-3.2-vision-90b").reduced(num_layers=4)}


def _train_batch(cfg):
    """The global batch of the train step: ``SyntheticLM.batch(0)`` and the stub
    frontend's frames or image tokens (seed 7), numpy."""
    from repro_torch.data.pipeline import SyntheticLM, SyntheticLMConfig, modality_stub

    batch = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, **BATCH)).batch(0)
    batch.update(modality_stub(cfg, BATCH["global_batch"], 7))
    return batch


def _step_inputs(cfg):
    """The prefill's tokens (B, S), its memory (the frames or image tokens, seed 11, or
    None) and the engine's prompts."""
    from repro_torch.data.pipeline import modality_stub

    rng = np.random.default_rng(0)
    mem = modality_stub(cfg, B, 11)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "memory": next(iter(mem.values())) if mem else None,
            "prompts": [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in PROMPTS]}


def _index(cfg, i):
    """The decode index of step ``i``: a per-slot vector, the encoder-decoder's scalar."""
    if cfg.family == "encdec":
        return S + i
    return np.full((B,), S + i, np.int32)


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
    """JAX's init (gates drawn) and zero cache of ``case`` (nested numpy trees)."""
    with np.load(os.path.join(out_dir, "jax_init.npz")) as z:
        pick = lambda kind: _nest({k.split(":", 2)[2]: z[k] for k in z.files
                                   if k.startswith(f"{kind}:{case}:")})
        return pick("params"), pick("cache")


def _gather(t, mesh, dims):
    from repro_torch.core import distributed as D

    for dim, axes in dims:
        t = D.all_gather_axes(t, mesh, axes, dim)
    return t


def _metrics(m) -> dict:
    return {k: float(v) for k, v in m.items()}


def _run_steps(cfg, params, jcache, mesh, rules, ins):
    """The prefill step, then DECODES serve steps, on the mesh: (gathered logits, tokens
    (B, 1 + DECODES), the gathered cache)."""
    from repro_torch import convert
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import build_model
    from repro_torch.sharding import partition as P

    caches = convert.lm_cache_from_numpy(cfg, jcache, mesh=mesh, rules=rules)
    rows = P.batch_split(B, rules, mesh)
    meta = P.place_module(build_model(cfg, device="meta"), rules, mesh, cut_params=False)
    vocab = meta._vocab_block()[0]
    memory = None if ins["memory"] is None else torch.from_numpy(ins["memory"])
    with P.use_rules(rules, mesh):
        logits, caches = make_prefill_step(cfg)(params, torch.from_numpy(ins["tokens"]),
                                                caches, memory)
        logits = _gather(logits, mesh, ((2, vocab), (0, rows)))
        tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
        out = [tok]
        serve = make_serve_step(cfg)
        for i in range(DECODES):
            index = _index(cfg, i)
            index = torch.from_numpy(index) if isinstance(index, np.ndarray) else index
            tok, caches = serve(params, tok, caches, index)
            tok = _gather(tok, mesh, ((0, rows),))
            out.append(tok)
    whole = convert.lm_cache_to_numpy(cfg, caches)
    return logits.numpy(), torch.cat(out, dim=1).numpy(), whole


def job_attn(rank, world, out_dir):
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.core import distributed as D
    from repro_torch.data.pipeline import SyntheticLM, SyntheticLMConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.sharding import partition as P
    from repro_torch.training.optim import init_opt_state
    from repro_torch.training.trainer import Trainer

    D.init_process_group(world, rank, f"file://{os.path.join(out_dir, f'attn{world}.store')}",
                         device="cpu", timeout_s=60)
    cfgs = _configs(get_config)
    res, arrays = {}, {}

    def save(name, tree, pls):
        whole = {k: pls[k].gather(t).numpy() for k, t in tree.items()}
        arrays.update({f"{name}:{k}": v for k, v in whole.items()})

    for shape in MESHES[world]:
        mesh = D.make_mesh(shape, NAMES)
        rules = P.default_rules(NAMES)
        tag = "x".join(map(str, shape))
        for case, cfg in cfgs.items():
            ptree, ctree = _jax_trees(out_dir, case)
            pls = P.placements(P.place_module(build_model(cfg, device="meta"), rules, mesh,
                                              cut_params=False))
            # one step of make_train_step
            params = convert.lm_params_from_numpy(cfg, ptree, mesh=mesh, rules=rules)
            tcfg = TrainConfig(optimizer=OptimizerConfig(**OPT))
            state = {"params": params, "opt": init_opt_state(params, tcfg.optimizer)}
            batch = {k: torch.from_numpy(v) for k, v in _train_batch(cfg).items()}
            with P.use_rules(rules, mesh):
                state, met = make_train_step(cfg, tcfg)(state, batch)
            res[f"step.{tag}.{case}"] = _metrics(met)
            save(f"step.{tag}.{case}", state["params"], pls)
            save(f"step.{tag}.{case}.m", state["opt"]["m"], pls)
            # the trainer with the OT term, from the same init
            data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, **BATCH))
            ttcfg = TrainConfig(optimizer=OptimizerConfig(**OPT), steps=1, log_every=1, **OT)
            tr = Trainer(cfg, ttcfg, data, device="cpu", mesh=mesh, rules=rules)
            start = convert.lm_params_from_numpy(cfg, ptree, mesh=mesh, rules=rules)
            with torch.no_grad():
                for k, p in tr.state["params"].items():
                    p.copy_(start[k])
            tr.state["opt"] = init_opt_state(tr.state["params"], ttcfg.optimizer)
            tr.run()
            res[f"trainer.{tag}.{case}"] = tr.metrics_history[-1]
            save(f"trainer.{tag}.{case}", tr.state["params"], tr.placements)
            save(f"trainer.{tag}.{case}.m", tr.state["opt"]["m"], tr.placements)
            # prefill and decode through the steps, twice
            params = convert.lm_params_from_numpy(cfg, ptree, mesh=mesh, rules=rules)
            ins = _step_inputs(cfg)
            runs = [_run_steps(cfg, params, ctree, mesh, rules, ins) for _ in range(2)]
            logits, tokens, cache = runs[0]
            res[f"steps.{tag}.{case}"] = {
                "tokens": tokens.tolist(),
                "digests": [_digest(lg, tk, *_flat(c).values()) for lg, tk, c in runs]}
            arrays[f"{tag}.{case}.logits"] = logits
            arrays.update({f"{tag}.{case}.cache:{k}": v for k, v in _flat(cache).items()})
            if case == "mla":
                res[f"engine.{tag}"] = []
                for _ in range(2):
                    engine = ServingEngine(cfg, params, max_batch=B, max_len=MAX_LEN,
                                           device="cpu", mesh=mesh)
                    done = engine.run([Request(rid=i, prompt=p, max_new_tokens=NEW)
                                       for i, p in enumerate(ins["prompts"])])
                    res[f"engine.{tag}"].append({r.rid: r.out_tokens for r in done})
        if world == 4 and rank == 0:            # the port's one-device trainers
            for case, cfg in cfgs.items():
                ptree, _ = _jax_trees(out_dir, case)
                data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, **BATCH))
                ttcfg = TrainConfig(optimizer=OptimizerConfig(**OPT), steps=1, log_every=1,
                                    **OT)
                one = Trainer(cfg, ttcfg, data, device="cpu")
                start = convert.lm_params_from_numpy(cfg, ptree)
                with torch.no_grad():
                    for k, p in one.state["params"].items():
                        p.copy_(start[k])
                one.state["opt"] = init_opt_state(one.state["params"], ttcfg.optimizer)
                one.run()
                res[f"trainer.one.{case}"] = one.metrics_history[-1]
                arrays.update({f"trainer.one.{case}:{k}": p.detach().numpy()
                               for k, p in one.state["params"].items()})
                arrays.update({f"trainer.one.{case}.m:{k}": t.numpy()
                               for k, t in one.state["opt"]["m"].items()})
    if rank == 0:
        np.savez(os.path.join(out_dir, f"attn{world}.npz"), **arrays)
    return res


JOBS = {"attn": job_attn}


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

JAX_REF = """
    import json, os, sys
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.configs.base import OptimizerConfig, TrainConfig
    from repro.launch import steps as jsteps
    from repro.models import attention as jattn
    from repro.models import build_model
    from repro.serving import engine as jengine
    from repro.sharding.partition import default_rules, sharding_tree, use_rules
    from repro.training.optim import init_opt_state, opt_state_logical_axes
    from repro.utils.compat import make_mesh
    from repro_torch import convert

    sys.path.insert(0, sys.argv[2])
    import test_torch_attn_mesh as T

    out = sys.argv[1]
    cfgs = T._configs(get_config)
    np_tree = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    port = lambda case, tree: convert.lm_params_from_numpy(cfgs[case], np_tree(tree))
    inits, flat = {}, {}
    for case, cfg in cfgs.items():
        model = build_model(cfg)
        params, axes = model.init(jax.random.PRNGKey(0))
        if cfg.family == "vlm":      # nonzero gates: at their zero init the cross path is idle
            gate = np.random.default_rng(3).uniform(0.3, 0.9, (cfg.num_layers // 2, 1))
            params["blocks"]["cross_gate"] = jnp.asarray(gate, jnp.float32)
        inits[case] = (model, params, axes)
        flat.update({f"params:{case}:{k}": v for k, v in T._flat(np_tree(params)).items()})
        flat.update({f"cache:{case}:{k}": v for k, v in
                     T._flat(np_tree(model.init_cache(T.B, T.MAX_LEN))).items()})
    np.savez(out + "/jax_init.tmp.npz", **flat)
    os.replace(out + "/jax_init.tmp.npz", out + "/jax_init.npz")     # the ranks start now

    def fed_cache(case, memory):
        # JAX's zero cache with each layer's cross_kv the projection of the memory
        cfg = cfgs[case]
        model, params, _ = inits[case]
        cache = model.init_cache(T.B, T.MAX_LEN)
        if memory is None:
            return cache
        cross = params["decoder"]["cross"] if cfg.family == "encdec" else params["blocks"]["cross"]
        n = jax.tree_util.tree_leaves(cross)[0].shape[0]
        x = jnp.zeros((T.B, 1, cfg.d_model), jnp.float32)
        kvs = [jattn.apply_cross(jax.tree_util.tree_map(lambda v: v[i], cross), x, memory,
                                 cfg)[1] for i in range(n)]
        cache["cross_kv"] = {k: jnp.stack([kv[k] for kv in kvs]) for k in ("k", "v")}
        return cache

    ref, tokens = {}, {}
    tcfg = TrainConfig(optimizer=OptimizerConfig(**T.OPT))
    mesh = make_mesh((2, 2), ("data", "model"))
    rules = default_rules(mesh.axis_names)
    for case, cfg in cfgs.items():
        model, params, axes = inits[case]
        batch = {k: jnp.asarray(v) for k, v in T._train_batch(cfg).items()}
        step = jax.jit(jsteps.make_train_step(cfg, tcfg))
        for where in ("one", "gspmd"):
            state = {"params": params, "opt": init_opt_state(params, tcfg.optimizer)}
            if where == "gspmd":
                st_axes = {"params": axes, "opt": opt_state_logical_axes(
                    axes, tcfg.optimizer, "master" in state["opt"])}
                state = jax.device_put(state, sharding_tree(st_axes, rules, mesh, shapes=state))
                with use_rules(rules, mesh), mesh:
                    state, met = step(state, batch)
                state = jax.device_get(state)
            else:
                state, met = step(state, batch)
            ref.update({f"{where}.{case}:{k}": v.numpy()
                        for k, v in port(case, state["params"]).items()})
            ref.update({f"{where}.{case}.m:{k}": v.numpy()
                        for k, v in port(case, state["opt"]["m"]).items()})
            ref.update({f"{where}.{case}.metric:{k}": np.float32(v) for k, v in met.items()})
        ins = T._step_inputs(cfg)
        memory = None if ins["memory"] is None else jnp.asarray(ins["memory"])
        fed = fed_cache(case, model.encode(params, memory) if cfg.family == "encdec" else memory)
        args = (memory,) if memory is not None else ()
        logits, caches = jax.jit(jsteps.make_prefill_step(cfg))(
            params, jnp.asarray(ins["tokens"]), fed, *args)
        tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
        out_tokens = [tok]
        serve = jax.jit(jsteps.make_serve_step(cfg))
        for i in range(T.DECODES):
            tok, caches = serve(params, tok, caches, jnp.asarray(T._index(cfg, i), jnp.int32))
            out_tokens.append(tok)
        ref[f"{case}.logits"] = np.asarray(logits)
        tokens[f"{case}.tokens"] = np.asarray(jnp.concatenate(out_tokens, axis=1)).tolist()
        ref.update({f"{case}.cache:{k}": v for k, v in T._flat(np_tree(caches)).items()})
        if case == "mla":
            engine = jengine.ServingEngine(cfg, params, max_batch=T.B, max_len=T.MAX_LEN)
            done = engine.run([jengine.Request(rid=i, prompt=p, max_new_tokens=T.NEW)
                               for i, p in enumerate(ins["prompts"])])
            tokens["mla.engine"] = {r.rid: r.out_tokens for r in done}
    np.savez(out + "/jax_ref.npz", **ref)
    with open(out + "/jax_tokens.json", "w") as f:
        json.dump(tokens, f)
"""


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


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """JAX's inits and references in a subprocess on 4 forced host devices; both rank
    jobs started as soon as the inits are written."""
    out = str(tmp_path_factory.mktemp("attn_mesh"))
    env = dict(_rank_env(), XLA_FLAGS="--xla_force_host_platform_device_count=4")
    deadline = time.monotonic() + TIMEOUT_S
    jax_proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(JAX_REF), out,
                                 os.path.dirname(THIS)], env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    started = {}
    try:
        while not os.path.exists(os.path.join(out, "jax_init.npz")):
            assert jax_proc.poll() is None, jax_proc.communicate()[1][-3000:]
            assert time.monotonic() < deadline, "no JAX init"
            time.sleep(0.2)
        started = {f"attn{w}": _start("attn", w, out) for w in (4, 2)}
        res = {name: _finish(name, procs, out, deadline) for name, procs in started.items()}
        _, err = jax_proc.communicate(timeout=max(deadline - time.monotonic(), 1.0))
        assert jax_proc.returncode == 0, err[-3000:]
    finally:
        for p in [jax_proc] + [p for ps in started.values() for p in ps]:
            if p.poll() is None:
                p.kill()
    for w in (2, 4):
        with np.load(os.path.join(out, f"attn{w}.npz")) as z:
            res[f"npz{w}"] = {k: z[k] for k in z.files}
    with np.load(os.path.join(out, "jax_ref.npz")) as z:
        res["jax"] = {k: z[k] for k in z.files}
    with open(os.path.join(out, "jax_tokens.json")) as f:
        res["jax_tokens"] = json.load(f)
    return res


SHAPES = [s for ss in MESHES.values() for s in ss]


def _world(shape):
    return shape[0] * shape[1]


def _tag(shape):
    return "x".join(map(str, shape))


def _pick(arrays, prefix):
    return {k.split(":", 1)[1]: v for k, v in arrays.items() if k.startswith(prefix + ":")}


def _ref_metrics(jobs, prefix):
    return {k.split(":", 1)[1]: float(v) for k, v in jobs["jax"].items()
            if k.startswith(prefix + ".metric:")}


#: |g| below which AdamW's first step turns the gradient's last digits into the
#: parameter's (10 x its eps; m = 0.1 x g), and the bound held there (lr / 10)
FLAT_M, FLAT_ATOL = 0.1 * 1e-7, 0.1 * OPT["lr"]


def _close_params(got, want, m_ref):
    """The parameters within PARAM_ATOL where the reference's m says |g| >= 1e-7, within
    FLAT_ATOL elsewhere (see the module docstring)."""
    assert set(got) == set(want) == set(m_ref)
    for k in want:
        flat = np.abs(m_ref[k]) < FLAT_M
        np.testing.assert_allclose(got[k][~flat], want[k][~flat], rtol=0.0, atol=PARAM_ATOL,
                                   err_msg=k)
        np.testing.assert_allclose(got[k][flat], want[k][flat], rtol=0.0, atol=FLAT_ATOL,
                                   err_msg=k)


def _close_moments(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-6 * float(np.max(np.abs(want[k]))), err_msg=k)


def _close_step(got_metrics, arrays, name, jobs, where):
    want = _ref_metrics(jobs, where)
    np.testing.assert_allclose(got_metrics["loss"], want["loss"], rtol=LOSS_RTOL, atol=0)
    for k in ("ce", "lr", "grad_norm"):
        np.testing.assert_allclose(got_metrics[k], want[k], rtol=METRIC_RTOL, err_msg=k)
    m_ref = _pick(jobs["jax"], where + ".m")
    _close_moments(_pick(arrays, name + ".m"), m_ref)
    _close_params(_pick(arrays, name), _pick(jobs["jax"], where), m_ref)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_train_step_on_the_mesh_matches_jax(jobs, shape, case):
    """make_train_step on the mesh against JAX's one-device step from the same init and
    batch (the frames or image tokens included)."""
    world, tag = _world(shape), _tag(shape)
    got = jobs[f"attn{world}"][0][f"step.{tag}.{case}"]
    _close_step(got, jobs[f"npz{world}"], f"step.{tag}.{case}", jobs, f"one.{case}")


@pytest.mark.parametrize("case", CASES)
def test_train_step_on_2x2_matches_jax_gspmd(jobs, case):
    """The (2, 2) step against JAX's step on a (2, 2) mesh of host devices (GSPMD under
    ``use_rules``, the state sharded by its logical axes)."""
    got = jobs["attn4"][0][f"step.2x2.{case}"]
    _close_step(got, jobs["npz4"], f"step.2x2.{case}", jobs, f"gspmd.{case}")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_trainer_with_the_ot_term_on_the_mesh_matches_one_device(jobs, shape, case):
    """Trainer(mesh=) with ot_align (the stub memory sharded by rows; the OT term at d =
    d_model on the whole batch's features) against the port's one-device Trainer."""
    world, tag = _world(shape), _tag(shape)
    got = jobs[f"attn{world}"][0][f"trainer.{tag}.{case}"]
    want = jobs["attn4"][0][f"trainer.one.{case}"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL, atol=0)
    for k in ("ce", "lr", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL, err_msg=k)
    assert got["ot_distance"] == want["ot_distance"] > 0
    m_ref = _pick(jobs["npz4"], f"trainer.one.{case}.m")
    _close_moments(_pick(jobs[f"npz{world}"], f"trainer.{tag}.{case}.m"), m_ref)
    _close_params(_pick(jobs[f"npz{world}"], f"trainer.{tag}.{case}"),
                  _pick(jobs["npz4"], f"trainer.one.{case}"), m_ref)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_prefill_and_serve_steps_on_the_mesh_match_jax(jobs, shape, case):
    world, tag = _world(shape), _tag(shape)
    arrays, ref = jobs[f"npz{world}"], jobs["jax"]
    np.testing.assert_allclose(arrays[f"{tag}.{case}.logits"], ref[f"{case}.logits"], **TOL)
    got = jobs[f"attn{world}"][0][f"steps.{tag}.{case}"]
    assert got["tokens"] == jobs["jax_tokens"][f"{case}.tokens"]
    have = {k.split(":", 1)[1]: v for k, v in arrays.items()
            if k.startswith(f"{tag}.{case}.cache:")}
    want = {k.split(":", 1)[1]: v for k, v in ref.items() if k.startswith(f"{case}.cache:")}
    assert sorted(have) == sorted(want)
    for k, v in want.items():
        assert have[k].shape == v.shape and have[k].dtype == v.dtype, k
        np.testing.assert_allclose(have[k], v, rtol=CACHE_ATOL, atol=CACHE_ATOL, err_msg=k)


@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_mla_engine_on_the_mesh_matches_jax(jobs, shape):
    """ServingEngine(mesh=) on MLA: its splice takes the batch-1 prefill's {latent,
    k_rope} rows into the rank's slots; every request's tokens JAX's engine's."""
    for r in jobs[f"attn{_world(shape)}"]:
        for run in r[f"engine.{_tag(shape)}"]:
            assert {int(k): v for k, v in run.items()} == \
                {int(k): v for k, v in jobs["jax_tokens"]["mla.engine"].items()}


def test_every_rank_and_a_rerun_give_the_same_bits(jobs):
    bits = lambda d: {k: np.float32(v).tobytes().hex() for k, v in d.items()}
    for world in (2, 4):
        ranks = jobs[f"attn{world}"]
        for key, val in ranks[0].items():
            if key.startswith("steps."):
                assert val["digests"][0] == val["digests"][1], (world, key)
            if key.startswith("engine."):
                assert val[0] == val[1], (world, key)
            if key.startswith("trainer.one"):       # rank 0's one-device trainers
                continue
            for r in ranks[1:]:
                if key.startswith(("step.", "trainer.")):
                    assert bits(r[key]) == bits(val), (world, key)
                else:
                    assert r[key] == val, (world, key)


@pytest.mark.parametrize("arch", ("minicpm3-4b", "whisper-medium", "llama-3.2-vision-90b"))
def test_a_one_rank_mesh_is_the_single_device_path(arch):
    """``build_on_mesh`` and the steps on a mesh of one rank: the single-device model and
    step, bit for bit (parameters, the train step's metrics and parameters, the prefill's
    logits)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import distributed as D
    from repro_torch.launch.steps import make_prefill_step, make_train_step
    from repro_torch.models import build_model, build_on_mesh
    from repro_torch.sharding import partition as P
    from repro_torch.training.optim import init_opt_state

    cfg = get_config(arch).reduced(num_layers=4 if arch.startswith("llama") else 2)
    mesh = D.make_mesh((1, 1), NAMES)          # no process group: the one-rank mesh
    rules = P.default_rules(NAMES)
    one, placed = build_model(cfg, "cpu", seed=3), build_on_mesh(cfg, "cpu", rules, mesh, seed=3)
    assert P.module_mesh(placed) is None
    sd = {k: p.detach() for k, p in one.named_parameters()}
    assert all(torch.equal(sd[k], p) for k, p in placed.named_parameters())
    batch = {k: torch.from_numpy(v) for k, v in _train_batch(cfg).items()}
    ins = _step_inputs(cfg)
    out = []
    for ctx in (lambda: P.use_rules(None), lambda: P.use_rules(rules, mesh)):
        with ctx():
            state = {"params": {k: t.clone() for k, t in sd.items()}}
            state["opt"] = init_opt_state(state["params"], TrainConfig().optimizer)
            state, met = make_train_step(cfg, TrainConfig())(state, batch)
            memory = None if ins["memory"] is None else torch.from_numpy(ins["memory"])
            logits, _ = make_prefill_step(cfg)(sd, torch.from_numpy(ins["tokens"]),
                                               one.init_cache(B, MAX_LEN), memory)
        out.append((state["params"], met, logits))
    (pa, ma, la), (pb, mb, lb) = out
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert torch.equal(la, lb)


def test_only_the_recurrent_families_raise_on_a_mesh():
    """``check_mesh_family`` on a mesh of ranks (a dry one: rank 0's coordinate) raises
    for xLSTM and the Mamba hybrid alone; the engine still raises for the
    encoder-decoder and the VLM (a request carries no memory)."""
    from repro_torch.configs import get_config, list_archs
    from repro_torch.core import distributed as D
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.sharding import partition as P

    mesh = D.sizes_mesh((2, 2), NAMES).dry_run()
    raised = []
    for arch in list_archs():
        try:
            P.check_mesh_family(get_config(arch), mesh)
        except NotImplementedError as e:
            assert "A4 (e)" in str(e)
            raised.append(get_config(arch).family)
    assert sorted(raised) == ["hybrid", "ssm"]
    for arch in ("whisper-medium", "llama-3.2-vision-90b"):
        cfg = get_config(arch).reduced()
        with pytest.raises(NotImplementedError, match="launch.steps"):
            ServingEngine(cfg, build_model(cfg, "cpu"), device="cpu", mesh=mesh)


if __name__ == "__main__":
    main(sys.argv[1:])
