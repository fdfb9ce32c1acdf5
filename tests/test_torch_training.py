"""The port's training stack (``repro_torch.training`` / ``data`` / ``launch``) against
the JAX package (CPU).

Referees and tolerances:
  * ``SyntheticLM.batch``: bitwise, several steps and shards;
  * ``lr_schedule``: rtol 1e-6; ``adamw_update`` after 5 steps, float32 and
    bfloat16 params with float32 master weights: rtol 1e-6, each entry also
    within 1e-6 of its leaf's largest magnitude (a moment near a
    cancellation carries the last bit of the clip scale, whose global norm
    sums the leaves in another order); bfloat16 params within one bfloat16
    ulp of the JAX ones; the decay set leaf for leaf the JAX rule on the
    stacked layout;
  * int8 error feedback: bitwise (torch.round and jnp.round both round half
    to even, so no tie differs);
  * the watchdog: the same events on the same durations;
  * ``CheckpointManager``: the JAX tests' cases, plus either package's
    checkpoint restoring in the other bit for bit, and an in-place update
    after ``save()`` not reaching the file;
  * ``Trainer`` with ``ot_align`` (port 'pallas' through its plain versions,
    JAX 'screened', the TrainConfig default) from the same init: ``loss``
    and ``ce`` within rtol 1e-4 at every step, ``ot_distance`` within rtol
    2e-5 at step 0 (Theorem 2); a restart resumes to the bits of an
    uninterrupted run.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import pipeline as jpipeline
from repro.models import build_model as jbuild_model
from repro.training import checkpoint as jcheckpoint
from repro.training import compression as jcompression
from repro.training import elastic as jelastic
from repro.training import optim as joptim
from repro.training.trainer import Trainer as JTrainer
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import OptimizerConfig, TrainConfig
from repro_torch.data import pipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.training import checkpoint, compression, elastic, optim
from repro_torch.training.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers do not oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- data ------------------------------------------------------------------------

@pytest.mark.parametrize("shard,num_shards", [(0, 1), (1, 2), (3, 4)])
def test_synthetic_lm_bitwise(shard, num_shards):
    kw = dict(vocab_size=301, seq_len=24, global_batch=8, seed=5, num_classes=6)
    ours = pipeline.SyntheticLM(pipeline.SyntheticLMConfig(**kw), shard, num_shards)
    ref = jpipeline.SyntheticLM(jpipeline.SyntheticLMConfig(**kw), shard, num_shards)
    for step in (0, 1, 7, 123):
        a, b = ours.batch(step), ref.batch(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


# -- optimizer ---------------------------------------------------------------------

def test_lr_schedule_matches_jax():
    cfg = OptimizerConfig(lr=6e-4, warmup_steps=5, decay_steps=40)
    jcfg = JOptimizerConfig(lr=6e-4, warmup_steps=5, decay_steps=40)
    steps = np.arange(0, 50, dtype=np.int32)
    got = np.array([float(optim.lr_schedule(cfg, torch.tensor(s))) for s in steps])
    want = np.array([float(joptim.lr_schedule(jcfg, jnp.asarray(s))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _opt_problem(dtype):
    rng = np.random.default_rng(0)
    shapes = {"w": (6, 5), "stack": (3, 4, 2), "scale": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    tp = {k: torch.from_numpy(v.copy()).to(dtype) for k, v in params.items()}
    jp = {k: jnp.asarray(v).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
          for k, v in params.items()}
    return tp, jp, grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_matches_jax_after_five_steps(dtype):
    cfg = OptimizerConfig(lr=1e-2, warmup_steps=2, decay_steps=10, grad_clip=1.0)
    jcfg = JOptimizerConfig(lr=1e-2, warmup_steps=2, decay_steps=10, grad_clip=1.0)
    tp, jp, grads = _opt_problem(dtype)
    state = optim.init_opt_state(tp, cfg)
    jstate = joptim.init_opt_state(jp, jcfg)
    assert ("master" in state) == ("master" in jstate) == (dtype == torch.bfloat16)
    for g in grads:
        tg = {k: torch.from_numpy(v).to(dtype) for k, v in g.items()}
        jg = {k: jnp.asarray(v).astype(jp[k].dtype) for k, v in g.items()}
        _, _, met = optim.adamw_update(tp, tg, state, cfg)
        jp, jstate, jmet = joptim.adamw_update(jp, jg, jstate, jcfg)
        np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(met["lr"]), float(jmet["lr"]), rtol=1e-6)
    assert int(state["step"]) == int(jstate["step"]) == 5
    for k in tp:
        for part in ("m", "v") + (("master",) if "master" in state else ()):
            want = np.asarray(jstate[part][k])       # rtol 1e-6, also of the leaf's scale
            np.testing.assert_allclose(state[part][k].numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(), err_msg=f"{part} {k}")
        got = tp[k].float().numpy()
        want = np.asarray(jp[k].astype(jnp.float32))
        ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-6
        np.testing.assert_allclose(got, want, rtol=ulp, err_msg=k)


def test_decay_set_is_the_jax_rule_leaf_for_leaf():
    for arch in ("smollm-135m", "yi-6b"):
        cfg = get_config(arch).reduced(**SMALL)
        jparams, _ = jbuild_model(jget_config(arch).reduced(**SMALL)).init(
            jax.random.PRNGKey(0), abstract=True)
        want = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
            keys = [p.key for p in path]
            names = ([".".join(["blocks", str(i)] + keys[1:]) for i in range(cfg.num_layers)]
                     if keys[0] == "blocks" else [".".join(keys)])
            want.update({n: leaf.ndim >= 2 for n in names})
        mask = build_model(cfg, device="meta").decay_mask()
        assert mask == want
        assert mask["blocks.0.norm_attn.scale"] and not mask["final_norm.scale"]


def test_adamw_decays_only_the_marked_leaves():
    cfg = OptimizerConfig(lr=1e-2, warmup_steps=0, weight_decay=0.5)
    p = {"a": torch.ones(3), "b": torch.ones(3)}
    state = optim.init_opt_state(p, cfg)
    optim.adamw_update(p, {"a": torch.zeros(3), "b": torch.zeros(3)}, state, cfg,
                       decay={"a": True, "b": False})
    assert bool((p["a"] < 1).all()) and bool((p["b"] == 1).all())


# -- compression, watchdog -------------------------------------------------------------

def test_int8_error_feedback_bitwise():
    rng = np.random.default_rng(1)
    g = {k: rng.normal(size=(7, 9)).astype(np.float32) * s for k, s in (("a", 1.0), ("b", 1e-3))}
    e = {k: rng.normal(size=(7, 9)).astype(np.float32) * 1e-2 for k in g}
    gh, ne = compression.apply_error_feedback({k: torch.from_numpy(v) for k, v in g.items()},
                                              {k: torch.from_numpy(v) for k, v in e.items()})
    jgh, jne = jcompression.apply_error_feedback({k: jnp.asarray(v) for k, v in g.items()},
                                                 {k: jnp.asarray(v) for k, v in e.items()})
    for k in g:
        np.testing.assert_array_equal(gh[k].numpy(), np.asarray(jgh[k]))
        np.testing.assert_array_equal(ne[k].numpy(), np.asarray(jne[k]))
    x = rng.normal(size=(50,)).astype(np.float32)
    q, s = compression._q8(torch.from_numpy(x))
    jq, js = jcompression._q8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    assert compression.wire_bytes_saved({k: torch.from_numpy(v) for k, v in g.items()}) == \
        jcompression.wire_bytes_saved({k: jnp.asarray(v) for k, v in g.items()})


def test_watchdog_same_events():
    rng = np.random.default_rng(2)
    durations = np.abs(rng.normal(0.1, 0.02, 80))
    durations[[15, 40, 41, 70]] = [0.5, 0.3, 0.25, 1.0]
    ours = elastic.StragglerWatchdog(window=20, ratio_threshold=2.0, min_samples=5)
    ref = jelastic.StragglerWatchdog(window=20, ratio_threshold=2.0, min_samples=5)
    for step, d in enumerate(durations):
        a, b = ours.observe(step, float(d)), ref.observe(step, float(d))
        assert (a is None) == (b is None)
    assert [dataclasses.astuple(e) for e in ours.events] == [
        dataclasses.astuple(e) for e in ref.events]
    assert len(ours.events) >= 3


# -- checkpoint ------------------------------------------------------------------------

def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32)),
                   "b": torch.from_numpy(rng.normal(size=(8,)).astype(np.float32)).to(
                       torch.bfloat16)},
        "opt": {"m": {"w": torch.zeros((4, 8)), "b": torch.zeros((8,))},
                "step": torch.tensor(7, dtype=torch.int32)},
    }


def _flat(tree):
    return checkpoint._flatten(tree)


def test_checkpoint_roundtrip(tmp_path):
    cm = checkpoint.CheckpointManager(tmp_path, async_write=False)
    st = _state()
    cm.save(st, 10)
    restored, step = cm.restore(_state(seed=99))
    assert step == 10
    for k, v in _flat(st).items():
        assert torch.equal(_flat(restored)[k], v) and _flat(restored)[k].dtype == v.dtype


def test_checkpoint_async_save_then_wait(tmp_path):
    cm = checkpoint.CheckpointManager(tmp_path, async_write=True)
    cm.save(_state(), 1)
    cm.wait()
    assert cm.latest_step() == 1


def test_checkpoint_uncommitted_ignored(tmp_path):
    cm = checkpoint.CheckpointManager(tmp_path, async_write=False)
    cm.save(_state(), 5)
    d = tmp_path / "step_00000006"
    d.mkdir()
    (d / "index.json").write_text(json.dumps({"step": 6}))
    assert cm.latest_step() == 5
    _, step = cm.restore(_state())
    assert step == 5


def test_checkpoint_retention(tmp_path):
    cm = checkpoint.CheckpointManager(tmp_path, keep=2, async_write=False)
    for s in (1, 2, 3, 4):
        cm.save(_state(), s)
    assert cm.all_steps() == [3, 4]


def test_checkpoint_shape_mismatch_raises(tmp_path):
    cm = checkpoint.CheckpointManager(tmp_path, async_write=False)
    cm.save(_state(), 1)
    bad = _state()
    bad["params"]["w"] = torch.zeros((5, 8))
    with pytest.raises(ValueError, match="shape"):
        cm.restore(bad)


def test_checkpoint_in_place_update_after_save_does_not_reach_the_file(tmp_path):
    cm = checkpoint.CheckpointManager(tmp_path, async_write=True)
    st = _state()
    want = st["params"]["w"].clone()
    cm.save(st, 1)
    st["params"]["w"].add_(1.0)           # the optimizer's next step, while the writer runs
    cm.wait()
    restored, _ = cm.restore(_state(seed=3))
    assert torch.equal(restored["params"]["w"], want)


def _jax_state(seed=0):
    st = _state(seed)
    return {
        "params": {"w": jnp.asarray(st["params"]["w"].numpy()),
                   "b": jnp.asarray(st["params"]["b"].float().numpy()).astype(jnp.bfloat16)},
        "opt": {"m": {"w": jnp.zeros((4, 8)), "b": jnp.zeros((8,))},
                "step": jnp.asarray(7, jnp.int32)},
    }


def test_checkpoint_jax_to_port(tmp_path):
    jcheckpoint.CheckpointManager(tmp_path, async_write=False).save(_jax_state(), 4)
    restored, step = checkpoint.CheckpointManager(tmp_path).restore(_state(seed=9))
    assert step == 4
    for k, v in _flat(_state()).items():
        assert torch.equal(_flat(restored)[k], v), k


def test_checkpoint_port_to_jax(tmp_path):
    checkpoint.CheckpointManager(tmp_path, async_write=False).save(_state(), 4)
    restored, step = jcheckpoint.CheckpointManager(tmp_path).restore(_jax_state(seed=9))
    assert step == 4
    want = jcheckpoint._flatten(_jax_state())
    for k, v in jcheckpoint._flatten(restored).items():
        assert v.dtype == want[k].dtype
        np.testing.assert_array_equal(np.asarray(v.astype(jnp.float32)),
                                      np.asarray(want[k].astype(jnp.float32)))


# -- the trainer -----------------------------------------------------------------------

def _tcfg(cls, ocls, **kw):
    return cls(optimizer=ocls(lr=1e-3, warmup_steps=2), log_every=1, checkpoint_every=3, **kw)


def _data(mod):
    return mod.SyntheticLM(mod.SyntheticLMConfig(vocab_size=128, seq_len=32, global_batch=32))


def _port_trainer(jparams=None, ckpt=None, **kw):
    cfg = get_config("smollm-135m").reduced(**SMALL)
    tr = Trainer(cfg, _tcfg(TrainConfig, OptimizerConfig, **kw), _data(pipeline),
                 ckpt_dir=ckpt, device="cpu")
    if jparams is not None:                     # the JAX trainer's init, carried across
        tr.model.load_state_dict(convert.lm_params_from_numpy(cfg, jparams))
        tr.state["opt"] = optim.init_opt_state(tr.state["params"], tr.tcfg.optimizer)
    return tr


def test_trainer_ot_align_matches_jax():
    jtr = JTrainer(jget_config("smollm-135m").reduced(**SMALL),
                   _tcfg(JTrainConfig, JOptimizerConfig, steps=4, ot_align=True,
                         ot_align_weight=0.05), _data(jpipeline))
    jparams = jax.tree_util.tree_map(np.asarray, jtr.state["params"])
    jtr.run()
    tr = _port_trainer(jparams, steps=4, ot_align=True, ot_align_weight=0.05,
                       ot_grad_impl="pallas")
    tr.run()
    assert len(tr.metrics_history) == len(jtr.metrics_history) == 4
    for a, b in zip(tr.metrics_history, jtr.metrics_history):
        for key in ("loss", "ce", "grad_norm", "ot_distance"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-4, err_msg=f"{key} {a['step']}")
        assert a["ot_distance"] > 0
    np.testing.assert_allclose(tr.metrics_history[0]["ot_distance"],
                               jtr.metrics_history[0]["ot_distance"], rtol=2e-5)


def _first_gradients(port: bool, ot_grad_impl=None):
    """Each leaf's gradient of one step from the JAX trainer's init (with the OT
    alignment term on ``ot_grad_impl``, none when None), read from AdamW's first
    moment (m = (1 - b1) g with no clipping), in the JAX package's layout."""
    kw = dict(steps=1, log_every=1, ot_align=ot_grad_impl is not None, ot_align_weight=0.05,
              ot_grad_impl=ot_grad_impl or "screened")
    ocfg = dict(lr=1e-3, warmup_steps=2, grad_clip=0.0)
    jtr = JTrainer(jget_config("smollm-135m").reduced(**SMALL),
                   JTrainConfig(optimizer=JOptimizerConfig(**ocfg), **kw), _data(jpipeline))
    if port:
        tr = Trainer(get_config("smollm-135m").reduced(**SMALL),
                     TrainConfig(optimizer=OptimizerConfig(**ocfg), **kw), _data(pipeline),
                     device="cpu")
        jparams = jax.tree_util.tree_map(np.asarray, jtr.state["params"])
        tr.model.load_state_dict(convert.lm_params_from_numpy(tr.cfg, jparams))
        tr.state["opt"] = optim.init_opt_state(tr.state["params"], tr.tcfg.optimizer)
        tr.run()
        m = convert.lm_params_to_numpy(tr.cfg, tr.state["opt"]["m"])
    else:
        jtr.run()
        m = jax.tree_util.tree_map(np.asarray, jtr.state["opt"]["m"])
    return {k: v / (1 - JOptimizerConfig().b1) for k, v in _flat(m).items()}


def test_trainer_ot_gradient_matches_jax():
    """The wiring of the OT term's gradient (embed -> mean features -> classes ->
    OT loss -> embed), read from one step of each package's trainer:

      * without the OT term, every leaf's gradient within rtol 1e-4 of the JAX step's;
      * with it, every leaf but ``embed`` keeps the bits of the step without it
        (the features read ``embed`` alone);
      * the OT term's share of ``embed``'s gradient (the step with it less the
        step without), port 'pallas' against JAX 'screened', differs in L2 norm
        by no more than the JAX package's own exact backends differ ('dense'
        against 'screened'): the share is the envelope gradient at the L-BFGS
        solve's stopping point, which each backend's rounding moves (about 2e-3
        of the share's norm on this problem), so no elementwise rtol 1e-4 holds
        between any two backends.  A missing or misrouted OT gradient is off
        by the share's whole norm.
    """
    port_lm, jax_lm = _first_gradients(True), _first_gradients(False)
    assert sorted(port_lm) == sorted(jax_lm)
    for k in jax_lm:
        np.testing.assert_allclose(port_lm[k], jax_lm[k], rtol=1e-4, atol=1e-6, err_msg=k)
    port_ot = _first_gradients(True, "pallas")
    for k in port_lm:
        assert k == "embed" or np.array_equal(port_ot[k], port_lm[k]), k
    share = port_ot["embed"] - port_lm["embed"]
    want = _first_gradients(False, "screened")["embed"] - jax_lm["embed"]
    other = _first_gradients(False, "dense")["embed"] - jax_lm["embed"]
    norm = lambda v: float(np.linalg.norm(v))
    err, spread = norm(share - want) / norm(want), norm(other - want) / norm(want)
    assert norm(want) > 0.1 * norm(jax_lm["embed"]), "the OT share is too small to test"
    assert spread < 1e-2 and err <= spread, (err, spread)


def test_trainer_restart_resumes_bitwise(tmp_path):
    kw = dict(ot_align=True, ot_align_weight=0.05, ot_grad_impl="pallas")
    whole = _port_trainer(steps=6, **kw)
    whole.run()
    first = _port_trainer(ckpt=str(tmp_path), steps=6, **kw)
    first.run(3)
    assert first.ckpt.latest_step() == 3
    resumed = _port_trainer(ckpt=str(tmp_path), steps=6, **kw)
    assert resumed.start_step == 3
    resumed.run()
    for name, p in whole.state["params"].items():
        assert torch.equal(p, resumed.state["params"][name]), name
    for part in ("m", "v"):
        for name, t in whole.state["opt"][part].items():
            assert torch.equal(t, resumed.state["opt"][part][name]), (part, name)
    assert [m for m in whole.metrics_history if m["step"] >= 3] == resumed.metrics_history


def test_trainer_int8_ef_trains_finite():
    tr = _port_trainer(steps=4, grad_compression="int8_ef")
    tr.run()
    assert "ef" in tr.state
    assert all(np.isfinite(m["loss"]) for m in tr.metrics_history)


def test_launch_train_cpu(tmp_path):
    final = launch_train.main(["--arch", "smollm-135m", "--reduced", "--steps", "2", "--batch",
                               "4", "--seq", "16", "--ot-align", "--device", "cpu",
                               "--ckpt", str(tmp_path)])
    assert np.isfinite(final["loss"]) and final["ot_distance"] > 0
    assert checkpoint.CheckpointManager(tmp_path).latest_step() == 2


def test_example_smoke_exits_zero():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "examples", "train_lm_ot_torch.py"),
                        "--smoke", "--device", "cpu"], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "DECREASED" in r.stdout


def test_trainer_refuses_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(get_config("smollm-135m").reduced(**SMALL), TrainConfig(), _data(pipeline))
