"""The OT router where its solve converges: the port against the JAX package (CPU).

``tests/fixtures/router_prefill.npz`` holds router logits a card run of
``chip_smoke.py`` phase 14 (c) recorded: the first MoE layer of
``qwen2-moe-a2.7b`` (random weights, seed 0) at each of 6 prefills of 32
tokens, 60 experts, top 4, with the routes the card served and top-k's.
At the router's default ``max_iters=40`` neither package reaches the
optimum on them (ROADMAP §C); at ``max_iters=400`` both do.  Referees:
  * each prefill's OT dual value (``OTLayer.loss_and_plan`` at the
    router's settings) within rtol 2e-5 of JAX's, the repo's
    cross-backend objective tolerance;
  * ``ot_route``'s load_cv over the 6 prefills within 1e-2 of JAX's (the
    two f32 L-BFGS trajectories meet at the optimum, not bit for bit, so
    a few near-tied routes may differ), and both below top-k's on the same
    logits.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.regularizers import GroupSparseReg as JGroupSparseReg
from repro.ot import ExecutionPlan as JExecutionPlan
from repro.ot import OTLayer as JOTLayer
from repro.training import ot_routing as jot
from repro_torch.models import moe
from repro_torch.training import ot_routing

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "router_prefill.npz"
MAX_ITERS = 400
TOP_K = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread each, so parallel test workers do not oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def logits():
    x = np.load(FIXTURE)["logits"]
    assert x.shape == (6, 32, 60) and x.dtype == np.float32
    return x


def _jax_value(x):
    """JAX's dual value of ``ot_route``'s solve on one prefill's logits."""
    S, E = x.shape
    logp = jax.nn.log_softmax(jnp.asarray(x), axis=-1)
    C = -logp / jnp.maximum(jnp.max(-logp), 1e-9)
    layer = JOTLayer(num_groups=1, group_size=S, num_target=E,
                     reg=JGroupSparseReg.from_rho(5.0, 0.5),
                     plan=JExecutionPlan(grad_impl="screened", max_iters=MAX_ITERS, gtol=1e-5,
                                         max_rounds=MAX_ITERS // 10))
    return float(layer.loss_and_plan(C)[0])


def test_router_values_match_jax_at_convergence(logits):
    for i, x in enumerate(logits):
        S, E = x.shape
        layer = ot_routing.routing_layer(1, S, E, max_iters=MAX_ITERS, device="cpu")
        value, plan = layer.loss_and_plan(ot_routing.router_cost(torch.from_numpy(x)))
        assert torch.isfinite(plan).all()
        np.testing.assert_allclose(float(value), _jax_value(x), rtol=2e-5,
                                   err_msg=f"prefill {i}")


def test_router_load_balance_at_convergence(logits):
    n, S, E = logits.shape
    jx, port, tk = [], [], []
    for x in logits:
        jx.append(np.asarray(jot.ot_route(jnp.asarray(x), num_seqs=1, seq_len=S, top_k=TOP_K,
                                          max_iters=MAX_ITERS)[0]))
        topi, w = ot_routing.ot_route(torch.from_numpy(x), num_seqs=1, seq_len=S, top_k=TOP_K,
                                      max_iters=MAX_ITERS)
        assert torch.isfinite(w).all() and float((w.sum(-1) - 1).abs().max()) < 1e-4
        port.append(topi.numpy())
        tk.append(moe.top_k(torch.softmax(torch.from_numpy(x), -1), TOP_K)[1].numpy())
    cv = {name: float(ot_routing.routing_stats(torch.from_numpy(np.concatenate(t)), E, n,
                                               S)["load_cv"])
          for name, t in (("jax", jx), ("port", port), ("top-k", tk))}
    assert abs(cv["port"] - cv["jax"]) <= 1e-2, cv
    assert cv["port"] < cv["top-k"] and cv["jax"] < cv["top-k"], cv
