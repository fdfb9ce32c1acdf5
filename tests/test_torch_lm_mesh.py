"""The port's LM mesh against the JAX package (CPU): one training step of the dense and
MoE families over ``torch.distributed`` gloo ranks.

A mesh needs one process per rank, so the ranks run this file as a script,
``python tests/test_torch_lm_mesh.py JOB RANK WORLD DIR`` (gloo, a ``file://``
store under ``DIR``, one intra-op thread, a process-group timeout and a
subprocess timeout); each rank writes what it saw to ``DIR/JOB.RANK.json`` and
rank 0 the whole parameters after each case to ``DIR/JOB.CASE.npz``.  One
4-rank job runs the (2, 2) mesh; one 2-rank job the (1, 2) and (2, 1) meshes
(a mesh spans the whole process group); one JAX subprocess on 4 forced host
devices makes the references, all started together.

Every case starts from the JAX package's init (``convert.lm_params_from_numpy``,
cut to each rank's blocks) and the same global batch (``SyntheticLM.batch(0)``),
and is held to JAX's one-device step: ``make_train_step`` and ``Trainer`` with
``ot_align`` (both 'screened'), float32: the loss and metrics within rtol 1e-5,
``ot_distance`` within rtol 2e-5 (the two solvers, Theorem 2) and bitwise the
port's one-device trainer's; AdamW's first moments (the gradients) within rtol
1e-4, each entry within 1e-6 of its leaf's largest magnitude
(``test_torch_training.py``'s rule), and the parameters within atol 1e-5, 1 % of
the step's learning rate.  (AdamW's first step moves an entry by lr * g / (|g| +
1e-8): where |g| is near 1e-8 it carries the gradient's last digits, so even the
one-device port lands 2.5e-6 from JAX on a few entries.)  The trainer's ``embed``
takes the OT gradient of two L-BFGS paths (ROADMAP C): it is held to the port's
one-device trainer, and to JAX no further than that one is.  bfloat16
parameters (float32 master weights): JAX's own 5e-3 max abs
(``tests/test_distributed.py``).  ``constrain_grads`` on and off give the same
bits; every rank reports the same bits of the loss, the metrics and the OT
distance.  The MoE step (capacity factor 1.0, so tokens drop) with the global
dispatch matches JAX's one-device step, ``moe_dropped`` exactly; with
``local_dispatch`` it matches JAX's step on a (2, 2) mesh under ``use_rules``
(the shard-local dispatch), ``moe_dropped`` exactly.  A checkpoint written on
the (2, 2) mesh restores on one device bit for bit, and one written on one
device restores on the mesh bit for bit.
"""
import dataclasses
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
SMALL = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=128)
BATCH = dict(vocab_size=128, seq_len=32, global_batch=16, num_classes=4)
OPT = dict(lr=1e-3, warmup_steps=2)
OT = dict(ot_align=True, ot_align_weight=0.05, ot_grad_impl="screened")
MESHES = {4: ((2, 2),), 2: ((1, 2), (2, 1))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _configs(get_config):
    """(dense float32, dense bfloat16, MoE float32 with drops, the same with
    local_dispatch) for either package's ``get_config``."""
    dense = get_config("smollm-135m").reduced(**SMALL)
    bf16 = dataclasses.replace(dense, param_dtype="bfloat16", compute_dtype="bfloat16")
    moe = get_config("qwen2-moe-a2.7b").reduced(**SMALL)
    moe = dataclasses.replace(moe, moe=dataclasses.replace(moe.moe, capacity_factor=1.0))
    local = dataclasses.replace(moe, moe=dataclasses.replace(moe.moe, local_dispatch=True))
    return {"dense": dense, "bf16": bf16, "moe": moe, "moe_local": local}


def _bits(x) -> str:
    return hashlib.sha1(np.float32(x).tobytes()).hexdigest()[:16]


# -- the ranks' side -------------------------------------------------------------------

def _load(cfg, out_dir, case):
    """The JAX init of ``case``'s config, in the port's layout and the param dtype."""
    from repro_torch.models.common import torch_dtype

    with np.load(os.path.join(out_dir, "jax_init.npz")) as z:
        return {k[len(case) + 1:]: torch.from_numpy(z[k]).to(torch_dtype(cfg.param_dtype))
                for k in z.files if k.startswith(case + ":")}


def _metrics(m) -> dict:
    return {k: float(v) for k, v in m.items()}


def job_lm(rank, world, out_dir):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.core import distributed as D
    from repro_torch.data.pipeline import SyntheticLM, SyntheticLMConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.sharding import partition as P
    from repro_torch.training.optim import init_opt_state
    from repro_torch.training.trainer import Trainer

    D.init_process_group(world, rank, f"file://{os.path.join(out_dir, f'lm{world}.store')}",
                         device="cpu", timeout_s=60)
    cfgs = _configs(get_config)
    data = SyntheticLM(SyntheticLMConfig(**BATCH))
    batch = {k: torch.from_numpy(v) for k, v in data.batch(0).items()}
    res = {}

    def save(name, params, placements):
        whole = {k: placements[k].gather(t).float().numpy() for k, t in params.items()}
        if rank == 0:
            np.savez(os.path.join(out_dir, f"lm{world}.{name}.npz"), **whole)

    for shape in MESHES[world]:
        mesh = D.make_mesh(shape, ("data", "model"))
        rules = P.default_rules(mesh.axis_names)
        tag = "x".join(map(str, shape))
        pls_of = {}
        cases = [("dense", True), ("dense", False)]
        if world == 4:
            cases += [("bf16", True), ("moe", True), ("moe_local", True)]
        for case, pin in cases:
            cfg = cfgs[case]
            tcfg = TrainConfig(optimizer=OptimizerConfig(**OPT), constrain_grads=pin)
            full = _load(cfg, out_dir, case)
            from repro_torch.models import build_model

            meta = build_model(cfg, device="meta")
            P.place_module(meta, rules, mesh, cut_params=False)
            pls = pls_of.setdefault(case, P.placements(meta))
            params = {k: pls[k].cut(t) for k, t in full.items()}
            state = {"params": params, "opt": init_opt_state(params, tcfg.optimizer)}
            with P.use_rules(rules, mesh):
                state, met = make_train_step(cfg, tcfg)(state, batch)
            name = f"step.{tag}.{case}.{'pin' if pin else 'nopin'}"
            res[name] = _metrics(met)
            save(name, state["params"], pls)
            save(name + ".m", state["opt"]["m"], pls)
        # the trainer with the OT term, from the JAX init
        cfg = cfgs["dense"]
        tcfg = TrainConfig(optimizer=OptimizerConfig(**OPT), steps=1, log_every=1,
                           constrain_grads=True, **OT)
        tr = Trainer(cfg, tcfg, data, device="cpu", mesh=mesh, rules=rules)
        full = _load(cfg, out_dir, "dense")
        with torch.no_grad():
            for k, p in tr.state["params"].items():
                p.copy_(tr.placements[k].cut(full[k]))
        tr.state["opt"] = init_opt_state(tr.state["params"], tcfg.optimizer)
        tr.run()
        res[f"trainer.{tag}"] = tr.metrics_history[-1]
        save(f"trainer.{tag}", tr.state["params"], tr.placements)
        if world == 4:
            # checkpoints: the one-device trainer's step-1 checkpoint restores here bit for
            # bit; this trainer's step-1 checkpoint is the test's to restore on one device
            back = Trainer(cfg, dataclasses.replace(tcfg, steps=2), data,
                           ckpt_dir=os.path.join(out_dir, "ckpt_one"), device="cpu", mesh=mesh)
            res["restored_step"] = back.start_step
            save("restored", back.state["params"], back.placements)
            res["restored_opt_step"] = int(back.state["opt"]["step"])
            ck = Trainer(cfg, tcfg, data, ckpt_dir=os.path.join(out_dir, "ckpt_mesh"),
                         device="cpu", mesh=mesh)
            save("init_mesh", ck.state["params"], ck.placements)
            ck.run()
            save("ckpt_mesh", ck.state["params"], ck.placements)
            for kind in ("m", "v"):
                save(f"ckpt_mesh_{kind}", ck.state["opt"][kind], ck.placements)
            if rank == 0:            # the port's one-device trainer, for the OT bits
                one = Trainer(cfg, tcfg, data, device="cpu")
                with torch.no_grad():
                    for k, p in one.state["params"].items():
                        p.copy_(full[k])
                one.state["opt"] = init_opt_state(one.state["params"], tcfg.optimizer)
                one.run()
                res["trainer.one"] = one.metrics_history[-1]
                np.savez(os.path.join(out_dir, "lm4.trainer.one.npz"),
                         **{k: p.detach().float().numpy() for k, p in one.state["params"].items()})
    return res


JOBS = {"lm": job_lm}


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
    import dataclasses, os, sys
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.configs.base import OptimizerConfig, TrainConfig
    from repro.data.pipeline import SyntheticLM, SyntheticLMConfig
    from repro.launch.steps import make_train_step
    from repro.models import build_model
    from repro.sharding.partition import default_rules, sharding_tree, use_rules
    from repro.training.optim import init_opt_state, opt_state_logical_axes
    from repro.training.trainer import Trainer
    from repro.utils.compat import make_mesh
    from repro_torch import convert

    sys.path.insert(0, sys.argv[2])
    import test_torch_lm_mesh as T

    out = sys.argv[1]
    cfgs = T._configs(get_config)
    data = SyntheticLM(SyntheticLMConfig(**T.BATCH))
    batch = {k: jnp.asarray(v) for k, v in data.batch(0).items()}
    f32 = lambda tree: jax.tree_util.tree_map(lambda x: np.asarray(x.astype(jnp.float32)), tree)
    port = lambda case, tree: convert.lm_params_from_numpy(cfgs[case], f32(tree))
    init, ref = {}, {}
    tcfg = TrainConfig(optimizer=OptimizerConfig(**T.OPT))
    mesh = make_mesh((2, 2), ("data", "model"))
    inits = {case: build_model(cfg).init(jax.random.PRNGKey(0)) for case, cfg in cfgs.items()}
    for case, (params, _) in inits.items():
        init.update({f"{case}:{k}": v.float().numpy() for k, v in port(case, params).items()})
    np.savez(out + "/jax_init.tmp.npz", **init)
    os.replace(out + "/jax_init.tmp.npz", out + "/jax_init.npz")     # the ranks start now
    for case, cfg in cfgs.items():
        params, axes = inits[case]
        state = {"params": params, "opt": init_opt_state(params, tcfg.optimizer)}
        step = jax.jit(make_train_step(cfg, tcfg))
        if case == "moe_local":        # the shard-local dispatch needs the mesh
            rules = default_rules(mesh.axis_names)
            st_axes = {"params": axes, "opt": opt_state_logical_axes(
                axes, tcfg.optimizer, "master" in state["opt"])}
            state = jax.device_put(state, sharding_tree(st_axes, rules, mesh, shapes=state))
            with use_rules(rules, mesh), mesh:
                state, met = step(state, batch)
            state = jax.device_get(state)
        else:
            state, met = step(state, batch)
        ref.update({f"step.{case}:{k}": v.float().numpy()
                    for k, v in port(case, state["params"]).items()})
        ref.update({f"step.{case}.m:{k}": v.float().numpy()
                    for k, v in port(case, state["opt"]["m"]).items()})
        ref.update({f"step.{case}.metric:{k}": np.float32(v) for k, v in met.items()})
    tr = Trainer(cfgs["dense"], TrainConfig(optimizer=OptimizerConfig(**T.OPT), steps=1,
                                            log_every=1, **T.OT), data)
    tr.run()
    ref.update({f"trainer:{k}": v.float().numpy()
                for k, v in port("dense", tr.state["params"]).items()})
    ref.update({f"trainer.metric:{k}": np.float32(v) for k, v in tr.metrics_history[-1].items()
                if k != "step"})
    np.savez(out + "/jax_ref.npz", **ref)
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


def _one_device_checkpoint(out_dir):
    """The port's one-device trainer from the JAX init, one step, checkpointed at step 1
    (the mesh restores it)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.data.pipeline import SyntheticLM, SyntheticLMConfig
    from repro_torch.training.optim import init_opt_state
    from repro_torch.training.trainer import Trainer

    cfg = _configs(get_config)["dense"]
    tcfg = TrainConfig(optimizer=OptimizerConfig(**OPT), steps=1, log_every=1, **OT)
    tr = Trainer(cfg, tcfg, SyntheticLM(SyntheticLMConfig(**BATCH)),
                 ckpt_dir=os.path.join(out_dir, "ckpt_one"), device="cpu")
    full = _load(cfg, out_dir, "dense")
    with torch.no_grad():
        for k, p in tr.state["params"].items():
            p.copy_(full[k])
    tr.state["opt"] = init_opt_state(tr.state["params"], tcfg.optimizer)
    tr.run()
    return {k: p.detach().clone() for k, p in tr.state["params"].items()}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The JAX references, then every rank job, each started as soon as it can."""
    out = str(tmp_path_factory.mktemp("lm_mesh"))
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
        started["lm2"] = _start("lm", 2, out)
        one = _one_device_checkpoint(out)
        started["lm4"] = _start("lm", 4, out)
        res = {name: _finish(name, procs, out, deadline) for name, procs in started.items()}
        _, err = jax_proc.communicate(timeout=max(deadline - time.monotonic(), 1.0))
        assert jax_proc.returncode == 0, err[-3000:]
    finally:
        for p in [jax_proc] + [p for ps in started.values() for p in ps]:
            if p.poll() is None:
                p.kill()
    with np.load(os.path.join(out, "jax_ref.npz")) as z:
        res["jax"] = {k: z[k] for k in z.files}
    res["npz"] = lambda world, name: dict(np.load(os.path.join(out, f"lm{world}.{name}.npz")))
    res["one"] = one
    res["dir"] = out
    return res


def _world(shape):
    return shape[0] * shape[1]


def _tag(shape):
    return "x".join(map(str, shape))


def _ref_params(jobs, prefix):
    return {k.split(":", 1)[1]: v for k, v in jobs["jax"].items() if k.startswith(prefix + ":")}


def _ref_metrics(jobs, prefix):
    return {k.split(":", 1)[1]: float(v) for k, v in jobs["jax"].items()
            if k.startswith(prefix + ".metric:")}


PARAM_ATOL = 1e-5       # 1 % of the first step's learning rate (see the module docstring)


def _close_params(got, want, atol, rtol=0.0):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def _close_moments(got, want):
    """AdamW's first moments (0.1 x the clipped gradient) within rtol 1e-4, each entry
    also within 1e-6 of its leaf's largest magnitude (``test_torch_training.py``'s rule)."""
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-6 * float(np.max(np.abs(want[k]))), err_msg=k)


SHAPES = [s for ss in MESHES.values() for s in ss]


@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_train_step_on_the_mesh_matches_jax(jobs, shape):
    """make_train_step on the mesh (float32, constrain_grads on) against JAX's one-device
    step from the same init and batch."""
    world = _world(shape)
    got = jobs[f"lm{world}"][0][f"step.{_tag(shape)}.dense.pin"]
    want = _ref_metrics(jobs, "step.dense")
    for k in ("loss", "ce", "lr", "grad_norm", "moe_lb", "moe_dropped"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    _close_params(jobs["npz"](world, f"step.{_tag(shape)}.dense.pin"),
                  _ref_params(jobs, "step.dense"), PARAM_ATOL)
    _close_moments(jobs["npz"](world, f"step.{_tag(shape)}.dense.pin.m"),
                   _ref_params(jobs, "step.dense.m"))


@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_constrain_grads_on_and_off_give_the_same_bits(jobs, shape):
    world = _world(shape)
    a = jobs["npz"](world, f"step.{_tag(shape)}.dense.pin")
    b = jobs["npz"](world, f"step.{_tag(shape)}.dense.nopin")
    assert all(np.array_equal(a[k], b[k]) for k in a)
    for r in jobs[f"lm{world}"]:
        assert r[f"step.{_tag(shape)}.dense.pin"] == r[f"step.{_tag(shape)}.dense.nopin"]


@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_trainer_with_the_ot_term_on_the_mesh_matches_jax(jobs, shape):
    """Trainer with ot_align on the mesh against JAX's one-device Trainer; the OT distance
    bit for bit the port's one-device trainer's."""
    world = _world(shape)
    got = jobs[f"lm{world}"][0][f"trainer.{_tag(shape)}"]
    want = _ref_metrics(jobs, "trainer")
    for k in ("loss", "ce", "lr", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["ot_distance"], want["ot_distance"], rtol=2e-5)
    assert got["ot_distance"] == jobs["lm4"][0]["trainer.one"]["ot_distance"]
    mesh, one = jobs["npz"](world, f"trainer.{_tag(shape)}"), jobs["npz"](4, "trainer.one")
    ref = _ref_params(jobs, "trainer")
    _close_params(mesh, one, PARAM_ATOL)
    # embed takes the OT term's gradient, whose two L-BFGS paths part (ROADMAP C): held to
    # JAX as closely as the one-device port is
    _close_params({k: v for k, v in mesh.items() if k != "embed"},
                  {k: v for k, v in ref.items() if k != "embed"}, PARAM_ATOL)
    assert np.max(np.abs(mesh["embed"] - ref["embed"])) <= \
        np.max(np.abs(one["embed"] - ref["embed"])) + PARAM_ATOL


def test_every_rank_reports_the_same_bits(jobs):
    for world in (2, 4):
        ranks = jobs[f"lm{world}"]
        for key, val in ranks[0].items():
            if key.startswith(("step.", "trainer.")) and key != "trainer.one":
                for r in ranks[1:]:
                    assert {k: _bits(v) for k, v in r[key].items()} == \
                        {k: _bits(v) for k, v in val.items()}, (world, key)


def test_bf16_step_on_the_mesh_within_jax_tolerance(jobs):
    got = jobs["npz"](4, "step.2x2.bf16.pin")
    _close_params(got, _ref_params(jobs, "step.bf16"), 5e-3)
    np.testing.assert_allclose(jobs["lm4"][0]["step.2x2.bf16.pin"]["loss"],
                               _ref_metrics(jobs, "step.bf16")["loss"], rtol=1e-3)


@pytest.mark.parametrize("case", ["moe", "moe_local"])
def test_moe_step_on_the_mesh_matches_jax(jobs, case):
    """The MoE step with drops: the global dispatch against JAX's one-device step, the
    shard-local one against JAX's step on a (2, 2) mesh; the dropped fraction exactly."""
    got = jobs["lm4"][0][f"step.2x2.{case}.pin"]
    want = _ref_metrics(jobs, f"step.{case}")
    assert got["moe_dropped"] == want["moe_dropped"] > 0
    for k in ("loss", "ce", "grad_norm", "moe_lb"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    _close_params(jobs["npz"](4, f"step.2x2.{case}.pin"), _ref_params(jobs, f"step.{case}"),
                  PARAM_ATOL)
    _close_moments(jobs["npz"](4, f"step.2x2.{case}.pin.m"), _ref_params(jobs, f"step.{case}.m"))


def test_one_device_under_two_data_shards_takes_the_shard_local_dispatch(jobs):
    """One device under rules of two data shards (a mesh of sizes only): the MoE step with
    ``local_dispatch`` packs each half of the batch apart, as JAX's ``_dispatch_local``
    on a (2, 2) mesh: ``moe_dropped`` exactly, the gradients (AdamW's m) as above."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.core import distributed as D
    from repro_torch.data.pipeline import SyntheticLM, SyntheticLMConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.sharding import partition as P
    from repro_torch.training.optim import init_opt_state

    cfg = _configs(get_config)["moe_local"]
    params = _load(cfg, jobs["dir"], "moe_local")
    tcfg = TrainConfig(optimizer=OptimizerConfig(**OPT))
    state = {"params": params, "opt": init_opt_state(params, tcfg.optimizer)}
    batch = {k: torch.from_numpy(v)
             for k, v in SyntheticLM(SyntheticLMConfig(**BATCH)).batch(0).items()}
    names = ("data", "model")
    with P.use_rules(P.default_rules(names), D.sizes_mesh((2, 2), names)):
        state, met = make_train_step(cfg, tcfg)(state, batch)
    want = _ref_metrics(jobs, "step.moe_local")
    assert float(met["moe_dropped"]) == want["moe_dropped"]
    np.testing.assert_allclose(float(met["loss"]), want["loss"], rtol=1e-5)
    _close_moments({k: v.numpy() for k, v in state["opt"]["m"].items()},
                   _ref_params(jobs, "step.moe_local.m"))


def test_checkpoints_cross_between_the_mesh_and_one_device(jobs):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.data.pipeline import SyntheticLM, SyntheticLMConfig
    from repro_torch.training.trainer import Trainer

    # one device -> mesh: restored at step 1, every leaf bit for bit
    assert jobs["lm4"][0]["restored_step"] == 1 and jobs["lm4"][0]["restored_opt_step"] == 1
    restored = jobs["npz"](4, "restored")
    assert all(np.array_equal(restored[k], v.float().numpy()) for k, v in jobs["one"].items())
    # mesh -> one device
    cfg = _configs(get_config)["dense"]
    tcfg = TrainConfig(optimizer=OptimizerConfig(**OPT), steps=2, log_every=1, **OT)
    tr = Trainer(cfg, tcfg, SyntheticLM(SyntheticLMConfig(**BATCH)),
                 ckpt_dir=os.path.join(jobs["dir"], "ckpt_mesh"), device="cpu")
    assert tr.start_step == 1
    for kind, got in (("", tr.state["params"]), ("_m", tr.state["opt"]["m"]),
                      ("_v", tr.state["opt"]["v"])):
        want = jobs["npz"](4, "ckpt_mesh" + kind)
        assert all(np.array_equal(got[k].detach().float().numpy(), want[k]) for k in want), kind


def test_the_mesh_trainer_draws_the_one_device_init(jobs):
    """A trainer on the mesh draws each leaf and cuts it as it goes: gathered, its
    parameters are the one-device model's of the same seed, bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    want = build_model(_configs(get_config)["dense"], "cpu", seed=0)
    got = jobs["npz"](4, "init_mesh")
    assert set(got) == {k for k, _ in want.named_parameters()}
    assert all(np.array_equal(got[k], p.detach().float().numpy())
               for k, p in want.named_parameters())


def test_a_trainer_on_a_mesh_of_sizes_only_raises():
    """A mesh with no rank for this process (no process group) does not fall back to one
    device."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import distributed as D
    from repro_torch.data.pipeline import SyntheticLM, SyntheticLMConfig
    from repro_torch.training.trainer import Trainer

    data = SyntheticLM(SyntheticLMConfig(**BATCH))
    with pytest.raises(ValueError, match="no rank"):
        Trainer(_configs(get_config)["dense"], TrainConfig(), data, device="cpu",
                mesh=D.sizes_mesh((2, 2), ("data", "model")))


def test_constrain_grads_on_one_device_equals_the_step_without():
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.training.optim import init_opt_state

    cfg = get_config("smollm-135m").reduced(**SMALL)
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (4, 17)).astype(np.int32))
    out = []
    for pin in (False, True):
        sd = {k: p.detach().clone() for k, p in build_model(cfg, "cpu").named_parameters()}
        state = {"params": sd, "opt": init_opt_state(sd, TrainConfig().optimizer)}
        out.append(make_train_step(cfg, TrainConfig(constrain_grads=pin))(state,
                                                                          {"tokens": tok}))
    (a, ma), (b, mb) = out
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


def test_remat_recomputes_under_the_forward_rules_on_another_thread():
    """A CUDA backward runs on autograd's device thread: the recompute of a block must see
    the rules of its forward (here two data shards, so the MoE's shard-local dispatch), or
    it saves other tensors than the forward did."""
    import threading

    from repro_torch.configs import get_config
    from repro_torch.core import distributed as D
    from repro_torch.models import build_model
    from repro_torch.sharding import partition as P

    cfg = _configs(get_config)["moe_local"]
    model = build_model(cfg, "cpu")
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, 128, (4, 17)))
    names = ("data", "model")
    with P.use_rules(P.default_rules(names), D.sizes_mesh((2, 2), names)):
        loss, _ = model.train_loss({"tokens": tok}, remat=True)
    errors = []

    def backward():
        try:
            loss.backward()
        except Exception as e:            # reported by the assertion below
            errors.append(repr(e))

    t = threading.Thread(target=backward)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and not errors, errors
    assert model.embed.grad is not None


if __name__ == "__main__":
    main(sys.argv[1:])
