"""The port's mesh pieces against the JAX package (CPU): placements, the shard-local MoE
dispatch, GPipe, the elastic remesh and the distributed solve's collectives.

The multi-rank checks run this file as a script, ``python tests/test_torch_mesh.py
parts RANK 4 DIR`` (gloo on 4 ranks, a ``file://`` store under ``DIR``, one intra-op
thread, timeouts), beside one JAX subprocess on 4 forced host devices; each rank
writes what it saw to ``DIR/parts4.RANK.json``.

  (i) every leaf of a reduced dense, a reduced MoE and a 3-head config, on the
      (2, 2), (4, 1) and (1, 4) meshes under ``default_rules``, and the
      ``long_500k`` cell's inputs under ``rules_for_shape``: each rank's block
      is exactly what JAX's ``NamedSharding(...).devices_indices_map(shape)``
      gives the device at the same coordinate (``fit_spec``'s dropped axes
      included: 3 heads over ``model`` = 2 stay whole);
 (iii) ``moe.dispatch_local`` with D = 2 and 4 equals JAX's ``_dispatch_local``
      on the same tokens and routes: counts and the kept fraction exactly, the
      outputs within 1e-6;
  (iv) ``gpipe_forward`` on 4 ranks over ``pod`` equals the stages applied in
      sequence and JAX's ``gpipe_forward`` on ``tests/test_pipeline.py``'s
      inputs within 1e-5; ``bubble_fraction(4, 6) == 3 / 9``;
   (v) ``remesh_state`` (2, 2) -> (4, 1) -> (1, 4) keeps every value bit for bit,
      each rank's block the new mesh's;
  (vi) ``lower_dual_step`` on (2, 4) and ``DualProblem(16, 8, 256,
      GroupSparseReg(1, 1))``: the largest collective is at most 4 (m_pad + n),
      the bound of ``tests/test_distributed.py``; on the real (2, 2) mesh too.
"""
import dataclasses
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
TIMEOUT_S = 180
SMALL = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=128)
SHAPES = ((2, 2), (4, 1), (1, 4))
NAMES = ("data", "model")
PIPE = dict(P=4, M=6, mb=3, d=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _configs(get_config):
    dense = get_config("smollm-135m").reduced(**SMALL)
    return {"dense": dense,
            "moe": get_config("qwen2-moe-a2.7b").reduced(**SMALL),
            "heads3": dataclasses.replace(dense, num_heads=3, num_kv_heads=1)}


def _pipe_inputs():
    """tests/test_pipeline.py's stages and microbatches."""
    rng = np.random.default_rng(0)
    P, M, mb, d = PIPE["P"], PIPE["M"], PIPE["mb"], PIPE["d"]
    Ws = (rng.normal(size=(P, d, d)).astype(np.float32) * 0.3)
    bs = (rng.normal(size=(P, d)).astype(np.float32) * 0.1)
    x = rng.normal(size=(M, mb, d)).astype(np.float32)
    return Ws, bs, x


def _blocks(placement):
    return [[s.start, s.stop] for s in placement.index]


# -- the ranks' side -------------------------------------------------------------------

def job_parts(rank, world, out_dir):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES_BY_NAME
    from repro_torch.core import distributed as D
    from repro_torch.core.dual import DualProblem
    from repro_torch.core.regularizers import GroupSparseReg
    from repro_torch.launch.specs import input_specs
    from repro_torch.models import build_model
    from repro_torch.models.common import logical_axes
    from repro_torch.sharding import partition as P
    from repro_torch.training.elastic import remesh_state
    from repro_torch.training.pipeline import gpipe_forward

    D.init_process_group(world, rank, f"file://{os.path.join(out_dir, 'parts.store')}",
                         device="cpu", timeout_s=60)
    res = {"coordinate": {}, "placements": {}}
    meshes = {s: D.make_mesh(s, NAMES) for s in SHAPES}
    # (i) placements of every leaf on each mesh, and the long_500k cell's inputs
    for shape, mesh in meshes.items():
        tag = "x".join(map(str, shape))
        res["coordinate"][tag] = list(mesh.coordinate)
        rules = P.default_rules(mesh.axis_names)
        for case, cfg in _configs(get_config).items():
            model = build_model(cfg, device="meta")
            for name, ax in logical_axes(model).items():
                pl = P.placement(dict(model.named_parameters())[name].shape, ax, rules, mesh)
                res["placements"][f"{tag}/{case}/{name}"] = _blocks(pl)
        cell = input_specs(_configs(get_config)["dense"], SHAPES_BY_NAME["long_500k"], mesh)
        for key, t in (("k", cell["caches"][0]["k"]), ("token", cell["token"])):
            res["placements"][f"{tag}/long_500k/{key}"] = _blocks(t.placement)
    # (iv) GPipe over a 4-stage pod axis
    Ws, bs, x = _pipe_inputs()
    pod = D.make_mesh((4,), ("pod",))
    stage_fn = lambda p, h: torch.tanh(h @ p["w"] + p["b"])
    out = gpipe_forward(stage_fn, {"w": torch.from_numpy(Ws), "b": torch.from_numpy(bs)},
                        torch.from_numpy(x), pod, axis="pod")
    ref = torch.from_numpy(x)
    for s in range(PIPE["P"]):
        ref = stage_fn({"w": torch.from_numpy(Ws[s]), "b": torch.from_numpy(bs[s])}, ref)
    res["gpipe"] = out.numpy().tolist()
    res["gpipe_vs_sequential"] = float(torch.max(torch.abs(out - ref)))
    # (v) remesh (2, 2) -> (4, 1) -> (1, 4)
    cfg = _configs(get_config)["dense"]
    model = build_model(cfg, "cpu", seed=3)
    full = {k: p.detach().clone() for k, p in model.named_parameters()}
    full["w"] = torch.arange(64.0).reshape(8, 8)
    axes = dict(logical_axes(model), w=("embed", "mlp"))
    mesh0 = meshes[(2, 2)]
    state = {k: P.cut(t, axes[k], P.default_rules(NAMES), mesh0) for k, t in full.items()}
    ok_values, ok_blocks = True, True
    for shape in ((4, 1), (1, 4)):
        mesh = meshes[shape]
        rules = P.default_rules(NAMES)
        state = remesh_state(state, mesh, rules, axes)
        for k, t in state.items():
            want = P.placement(full[k].shape, axes[k], rules, mesh)
            ok_blocks &= t.placement == want and tuple(t.shape) == want.local_shape
            ok_values &= torch.equal(t, want.cut(full[k])) and \
                torch.equal(t.placement.gather(t), full[k])
    res["remesh"] = {"values": bool(ok_values), "blocks": bool(ok_blocks)}
    # (vi) the distributed solve's collectives on the real (2, 2) mesh
    rec = D.lower_dual_step(mesh0, DualProblem(16, 8, 256, GroupSparseReg(1.0, 1.0)),
                            device="cpu")
    res["lower"] = rec
    return res


JOBS = {"parts": job_parts}


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
    import json, sys
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.configs.base import SHAPES_BY_NAME
    from repro.launch.specs import input_specs
    from repro.models import build_model
    from repro.sharding.partition import default_rules, sharding_tree
    from repro.training.pipeline import gpipe_forward
    from repro.utils.compat import make_mesh

    sys.path.insert(0, sys.argv[2])
    import test_torch_mesh as T

    def blocks(sharding, mesh, shape):
        out = {}
        for dev, idx in sharding.devices_indices_map(tuple(shape)).items():
            coord = [int(c[0]) for c in np.nonzero(mesh.devices == dev)]
            rank = int(np.ravel_multi_index(coord, mesh.devices.shape))
            out[rank] = [[s.start or 0, n if s.stop is None else s.stop]
                         for s, n in zip(idx, shape)]
        return out

    res = {"placements": {}}
    for shape in T.SHAPES:
        mesh = make_mesh(shape, T.NAMES)
        tag = "x".join(map(str, shape))
        for case, cfg in T._configs(get_config).items():
            params, axes = build_model(cfg).init(jax.random.PRNGKey(0), abstract=True)
            sh = sharding_tree(axes, default_rules(mesh.axis_names), mesh, shapes=params)
            flat = jax.tree_util.tree_flatten_with_path(params)[0]
            shs = jax.tree_util.tree_leaves(sh, is_leaf=lambda x: hasattr(x, "spec"))
            for (path, leaf), s in zip(flat, shs):
                key = "/".join(p.key for p in path)
                res["placements"][f"{tag}/{case}/{key}"] = blocks(s, mesh, leaf.shape)
        cell = input_specs(T._configs(get_config)["dense"], SHAPES_BY_NAME["long_500k"], mesh)
        for key, t in (("k", cell["caches"]["k"]), ("token", cell["token"])):
            res["placements"][f"{tag}/long_500k/{key}"] = blocks(t.sharding, mesh, t.shape)
    Ws, bs, x = T._pipe_inputs()
    pod = make_mesh((4,), ("pod",))
    out = gpipe_forward(lambda p, h: jnp.tanh(h @ p["w"] + p["b"]),
                        {"w": jnp.asarray(Ws), "b": jnp.asarray(bs)}, jnp.asarray(x), pod)
    res["gpipe"] = np.asarray(out).tolist()
    json.dump(res, open(sys.argv[1] + "/jax.json", "w"))
"""


def _rank_env() -> dict:
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    env.pop("LOCAL_RANK", None)
    return env


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh_parts"))
    env = dict(_rank_env(), XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(JAX_REF), out,
                                 os.path.dirname(THIS)], env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    procs = []
    for r in range(4):
        log = open(os.path.join(out, f"parts4.{r}.log"), "w")
        procs.append(subprocess.Popen([sys.executable, THIS, "parts", str(r), "4", out],
                                      env=_rank_env(), stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
        _, err = jax_proc.communicate(timeout=max(deadline - time.monotonic(), 1.0))
        assert jax_proc.returncode == 0, err[-3000:]
    finally:
        for p in [jax_proc] + procs:
            if p.poll() is None:
                p.kill()
    ranks = []
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(out, f"parts4.{r}.log")) as f:
                raise AssertionError(f"rank {r} exited {p.returncode}:\n{f.read()[-3000:]}")
        with open(os.path.join(out, f"parts4.{r}.json")) as f:
            ranks.append(json.load(f))
    with open(os.path.join(out, "jax.json")) as f:
        return {"ranks": ranks, "jax": json.load(f)}


def _jax_key(key: str) -> str:
    """A rank's ``mesh/case/port name`` -> the JAX leaf's ``mesh/case/path``."""
    tag, case, name = key.split("/", 2)
    if case == "long_500k":
        return key
    return f"{tag}/{case}/" + "/".join(p for p in name.split(".") if not p.isdigit())


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_every_leaf_lies_where_jax_puts_it(jobs, shape):
    tag = "x".join(map(str, shape))
    jax_pl = jobs["jax"]["placements"]
    seen = 0
    for rank, r in enumerate(jobs["ranks"]):
        assert r["coordinate"][tag] == list(np.unravel_index(rank, shape))
        for key, got in r["placements"].items():
            if not key.startswith(tag + "/"):
                continue
            want = jax_pl[_jax_key(key)][str(rank)]
            stacked = len(want) - len(got)          # JAX's leading layers axis
            assert got == want[stacked:], (key, rank, got, want)
            seen += 1
    assert seen >= 4 * 70           # every leaf of the three configs and the cell
    # fit_spec's dropped axis: 3 heads stay whole over model = 2 and 4
    if shape[1] > 1:
        wq = jobs["ranks"][1]["placements"][f"{tag}/heads3/blocks.0.attn.wq"]
        assert wq[1] == [0, 3]


def test_dispatch_local_equals_jax():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.models import build_model as jbuild_model
    from repro.models import moe as jmoe
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("qwen2-moe-a2.7b").reduced(**SMALL)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))
    jcfg = jget_config("qwen2-moe-a2.7b").reduced(**SMALL)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=1.0))
    jparams, _ = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    layer = jax.tree_util.tree_map(lambda v: v[0], jparams["blocks"]["moe"])
    sd = convert.lm_params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jparams))
    from repro_torch.models import build_model

    model = build_model(cfg, "cpu")
    model.load_state_dict(sd)
    ffn = model.blocks[0].moe._expert_ffn
    rng = np.random.default_rng(5)
    T, E, k = 64, cfg.moe.num_experts, cfg.moe.top_k
    xt = rng.normal(size=(T, cfg.d_model)).astype(np.float32)
    topi = np.stack([rng.choice(E, k, replace=False) for _ in range(T)]).astype(np.int32)
    topi[:T // 3] = topi[0]                    # a crowded expert pair: drops at capacity
    topw = rng.random((T, k)).astype(np.float32)
    topw /= topw.sum(-1, keepdims=True)
    for D in (2, 4):
        jout, jcounts, jkeep = jmoe._dispatch_local(layer, jnp.asarray(xt), jnp.asarray(topi),
                                                    jnp.asarray(topw), jcfg, D)
        with torch.no_grad():
            out, counts, keep = moe.dispatch_local(ffn, torch.from_numpy(xt),
                                                   torch.from_numpy(topi).long(),
                                                   torch.from_numpy(topw), cfg, D)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
        assert float(keep) == float(jkeep) < 1.0
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-6)


@pytest.mark.parametrize("D", [2, 4])
def test_global_dispatch_packs_only_the_shards_slots(D):
    """On a mesh the global dispatch packs each data shard's entries at their global
    positions (after the earlier shards' counts) into a buffer of only the slots they
    fill: the shards' outputs, summed over two blocks of experts, are the unsharded
    dispatch's, the drops the same, and no buffer holds more rows than the capacity (a
    shard that fills none of an expert block's slots past its share holds fewer)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, moe
    from repro_torch.models.common import swiglu

    cfg = get_config("qwen2-moe-a2.7b").reduced(**SMALL)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))
    layer = build_model(cfg, "cpu").blocks[0].moe

    def ffn(h, e0=0):                          # the experts [e0, e0 + len(h))
        w = lambda name: getattr(layer, name)[e0:e0 + h.shape[0]]
        return torch.bmm(swiglu(torch.bmm(h, w("w_gate")), torch.bmm(h, w("w_up"))),
                         w("w_down"))

    rng = np.random.default_rng(7)
    T, E, k = 64, cfg.moe.num_experts, cfg.moe.top_k
    xt = torch.from_numpy(rng.normal(size=(T, cfg.d_model)).astype(np.float32))
    topi = np.stack([rng.choice(E, k, replace=False) for _ in range(T)])
    topi[:T // 3] = topi[0]                    # a crowded expert pair: drops at capacity
    eid = torch.from_numpy(topi).long().reshape(-1)
    wgt = torch.from_numpy(rng.random((T * k,)).astype(np.float32))
    cap, tl, half = moe.capacity(cfg, T), T // D, E // 2
    with torch.no_grad():
        buf, route = moe.pack(xt, eid, wgt, cap, E, k)
        want = moe.combine(ffn(buf), route, T, k)
        outs, kept, offset, sizes = [], 0, torch.zeros(E, dtype=torch.int32), []
        for i in range(D):
            rows = slice(i * tl * k, (i + 1) * tl * k)
            out = torch.zeros((tl, cfg.d_model))
            for e0 in (0, half):
                b, r = moe.pack(xt[i * tl:(i + 1) * tl], eid[rows], wgt[rows], cap, E, k,
                                offset=offset, experts=(e0, half))
                sizes.append(b.shape[1])
                out = out + moe.combine(ffn(b, e0), r, tl, k)
            kept += int(torch.sum(r.keep))
            offset = offset + r.counts
            outs.append(out)
    assert kept == int(torch.sum(route.keep)) < T * k
    assert max(sizes) <= cap and sum(sizes) < len(sizes) * cap, (sizes, cap)
    np.testing.assert_allclose(torch.cat(outs).numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_gpipe_equals_the_sequential_stages_and_jax(jobs):
    from repro_torch.training.pipeline import bubble_fraction

    want = np.asarray(jobs["jax"]["gpipe"], np.float32)
    for r in jobs["ranks"]:
        assert r["gpipe_vs_sequential"] < 1e-5
        np.testing.assert_allclose(np.asarray(r["gpipe"], np.float32), want, atol=1e-5)
    assert abs(bubble_fraction(4, 6) - 3 / 9) < 1e-12


def test_remesh_keeps_every_value_and_follows_the_new_mesh(jobs):
    for r in jobs["ranks"]:
        assert r["remesh"] == {"values": True, "blocks": True}


def test_lower_dual_step_collectives_are_small(jobs):
    from repro_torch.core import distributed as D
    from repro_torch.core.dual import DualProblem
    from repro_torch.core.regularizers import GroupSparseReg

    prob = DualProblem(16, 8, 256, GroupSparseReg(1.0, 1.0))
    bound = 4 * (16 * 8 + 256)
    rec = D.lower_dual_step(D.sizes_mesh((2, 4), NAMES), prob, device="cpu")
    assert 0 < rec["largest_elements"] <= bound, rec
    assert [c["op"] for c in rec["collectives"]] == ["all_reduce"]
    for r in jobs["ranks"]:            # the same step run on the real (2, 2) mesh
        assert r["lower"]["largest_elements"] == rec["largest_elements"], r["lower"]


if __name__ == "__main__":
    main(sys.argv[1:])
