"""Training loop: the step, checkpoint/restart, watchdog, OT-align option (torch).

Counterpart of ``repro.training.trainer`` on one device.  Every run
starts by probing the checkpoint directory and resuming from the latest
committed step; the synthetic pipeline regenerates ``batch(step)``, so a
restart continues the same trajectory.  With ``TrainConfig.ot_align`` the
step adds the paper's OT alignment loss: per-class mean token embeddings
of the batch's first half transported onto the second half's, solved by
``ot_alignment_loss`` (``OTLayer.from_samples``; on the kernel backends
K1, K4 and K5/K6 or K8 on the card).

On a mesh (``Trainer(..., mesh=, rules=)``, an ``AxisMesh`` of several
ranks; the dense (MLA included), MoE, VLM and encoder-decoder families;
every rank runs the same loop): the model
is drawn from the seed leaf by leaf, each leaf cut to this rank's block as
it is drawn, so no more than one whole leaf is held (the same draws as the
model on one device; ``partition.place_module``, ``default_rules`` by
default); a mesh of sizes only, with no rank on it, raises; each rank
feeds its data shard of ``data.batch(step)`` (and of the stub frontend's
frames or image tokens), and the step backpropagates
the whole batch's loss over the mesh size (the collectives' backward
passes sum the shares).  The OT term all-gathers the per-sequence features
over the data axes in batch order, so every rank solves the same problem
(JAX's source and target halves); the gradient of ``embed`` comes back to
its block.  ``state_tree`` gathers each leaf and ``restore`` cuts it, so a
checkpoint written on a mesh restores on one device and the other way
round; mesh rank 0 writes it.

State, in the port's layout (flat name -> tensor dicts):
``state["params"]`` (the model's parameters), ``state["opt"]`` (AdamW's,
``training/optim.py``) and, with ``grad_compression='int8_ef'``,
``state["ef"]``.  The checkpoint holds them in the JAX package's layout
(``convert.lm_params_to_tree``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import distributed as D
from repro_torch.convert import lm_params_from_numpy, lm_params_to_tree
from repro_torch.data.pipeline import SyntheticLM, modality_stub
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import build_model, build_on_mesh
from repro_torch.models.common import torch_dtype
from repro_torch.sharding import partition as P
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.compression import apply_error_feedback, init_error_state
from repro_torch.training.elastic import StragglerWatchdog
from repro_torch.training.losses import group_features_by_class, ot_alignment_loss
from repro_torch.training.optim import adamw_update, init_opt_state
from repro_torch.utils.logging import get_logger

log = get_logger("trainer")

_PER_PARAM = ("m", "v", "master")       # the optimizer's per-parameter states


class Trainer:
    """Trains ``cfg`` on ``data`` on ``device`` (``None`` is the card).

    The model's parameters are drawn from a generator on the device seeded
    with ``tcfg.seed``.
    """

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, data: SyntheticLM,
                 ckpt_dir: Optional[str] = None, device: DeviceLike = None, mesh=None,
                 rules: Optional[P.Rules] = None):
        self.cfg, self.tcfg = cfg, tcfg
        if mesh is not None and mesh.size() > 1 and not P.on_mesh(mesh):
            raise ValueError(f"{mesh!r} has no rank for this process: a trainer on a mesh of "
                             f"{mesh.size()} ranks needs a process group of that size "
                             "(repro_torch.core.distributed.make_mesh)")
        self.mesh = mesh if P.on_mesh(mesh) else None
        if self.mesh is not None:
            P.check_mesh_family(cfg, self.mesh)
            self.rules = rules or P.default_rules(self.mesh.axis_names)
            self.device = D.rank_device(device)
            if tcfg.grad_compression != "none":
                raise NotImplementedError("gradient compression on the LM mesh "
                                          "(ROADMAP A4 (e))")
            self.model = build_on_mesh(cfg, self.device, self.rules, self.mesh, tcfg.seed)
        else:
            self.rules = rules
            self.device = resolve_device(device)
            self.model = build_model(cfg, self.device, seed=tcfg.seed)
        self.placements = P.placements(self.model)
        self.data = data
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.watchdog = StragglerWatchdog()
        self.metrics_history = []

        params = dict(self.model.named_parameters())
        self.decay = self.model.decay_mask()
        self.state = {"params": params, "opt": init_opt_state(params, tcfg.optimizer)}
        if tcfg.grad_compression == "int8_ef":
            self.state["ef"] = init_error_state(params)

        self.start_step = 0
        if self.ckpt and self.ckpt.latest_step() is not None:
            self.start_step = self.restore()
            log.info("restored checkpoint at step %d", self.start_step)

    # -- the checkpoint's layout ------------------------------------------------
    def _whole(self, d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Per-parameter state gathered from every rank's blocks, leaf by leaf."""
        if self.mesh is None:
            return d
        return {k: self.placements[k].gather(t) for k, t in d.items()}

    def state_tree(self) -> Dict:
        """The state in the JAX package's layout (nested dicts, layers stacked); on a mesh
        every leaf whole (every rank takes part)."""
        tree = lambda d: lm_params_to_tree(self.cfg, self._whole(d))
        opt = self.state["opt"]
        out = {"params": tree(self.state["params"]),
               "opt": {k: tree(opt[k]) for k in _PER_PARAM if k in opt}}
        out["opt"]["step"] = opt["step"]
        if "ef" in self.state:
            out["ef"] = tree(self.state["ef"])
        return out

    @torch.no_grad()
    def restore(self, step: Optional[int] = None) -> int:
        """Load the checkpoint of ``step`` (default: the latest) into the state, in place."""
        tree, step = self.ckpt.restore(self.state_tree(), step)
        flat = lambda t: lm_params_from_numpy(self.cfg, t, self.device)
        targets = [(self.state["params"], tree["params"])]
        targets += [(self.state["opt"][k], tree["opt"][k]) for k in _PER_PARAM
                    if k in self.state["opt"]]
        if "ef" in self.state:
            targets.append((self.state["ef"], tree["ef"]))
        for dst, src in targets:
            for name, t in flat(src).items():
                dst[name].copy_(t if self.mesh is None else self.placements[name].cut(t))
        self.state["opt"]["step"].copy_(tree["opt"]["step"])
        return step

    # -- one step ---------------------------------------------------------------
    def ot_inputs(self, batch: Dict[str, torch.Tensor]):
        """The OT alignment problem of a batch: ``(h_src (L * g, d), h_tgt (half, d), L, g)``.

        Features are the sequences' mean token embeddings in float32; the
        first half of the batch, labelled by ``class``, is the source, packed
        ``g`` rows per class, the second half the target.
        """
        # The JAX step also runs model.forward here and discards its logits;
        # XLA drops that dead code, eager PyTorch would pay a whole forward pass.
        tokens = batch["tokens"][:, :-1]
        cls = batch["class"]
        if self.mesh is None:
            feats = torch.mean(self.model.embed.float()[tokens], dim=1)
        else:            # every data shard's features, in batch order, on every rank
            data = P.batch_axes(self.rules, self.mesh)
            feats = torch.mean(self.model.lookup(tokens, torch.float32), dim=1)
            feats = D.all_gather_axes(feats, self.mesh, data, 0)
            cls = D.all_gather_axes(cls, self.mesh, data, 0)
        half = feats.shape[0] // 2
        L = int(self.data.cfg.num_classes)
        gsz = max(half // L, 1)
        h_src = group_features_by_class(feats[:half], cls[:half], L, gsz)
        return h_src, feats[half:], L, gsz

    def ot_loss(self, batch: Dict[str, torch.Tensor]):
        """``ot_alignment_loss`` of the batch's features: ``(loss, {"ot_distance": loss})``."""
        tcfg = self.tcfg
        h_src, h_tgt, L, gsz = self.ot_inputs(batch)
        return ot_alignment_loss(h_src, h_tgt, num_classes=L, group_size=gsz,
                                 gamma=tcfg.ot_gamma, rho=tcfg.ot_rho, solver=tcfg.ot_solver,
                                 grad_impl=tcfg.ot_grad_impl, device=self.device)

    def loss_and_grads(self, batch: Dict[str, torch.Tensor], mark: Optional[Callable] = None):
        """``(metrics, grads)`` of one batch: the LM loss and its gradient in the
        parameters, then, with ``ot_align``, the OT alignment term, whose backward
        adds its own gradient to ``embed``'s (its features read ``embed`` alone).
        ``mark(piece)``, where given, is called as each piece ends: "LM forward +
        backward", "OT solve (forward)", "OT backward"."""
        tcfg, params = self.tcfg, self.state["params"]
        mark = mark or (lambda piece: None)
        # on a mesh every rank holds the whole batch's loss: each backpropagates its share
        share = 1.0 if self.mesh is None else 1.0 / self.mesh.size()
        total, metrics = self.model.train_loss(batch, z_loss=tcfg.z_loss,
                                               remat=tcfg.remat != "none")
        if self.mesh is not None:
            total = total * share
        grads = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
        metrics = {k: v.detach() for k, v in metrics.items()}
        mark("LM forward + backward")
        if tcfg.ot_align and "class" in batch:
            ot, ot_metrics = self.ot_loss(batch)
            metrics["ot_distance"] = ot_metrics["ot_distance"].detach()
            mark("OT solve (forward)")
            weight = tcfg.ot_align_weight * ot
            if self.mesh is not None:
                weight = weight * share
            (g_ot,) = torch.autograd.grad(weight, [params["embed"]])
            grads["embed"] = grads["embed"] + g_ot
            mark("OT backward")
        if self.mesh is not None:
            P.reduce_grads(grads, self.placements)
        return metrics, grads

    def step_fn(self, batch: Dict[str, torch.Tensor],
                mark: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
        """One training step on ``batch`` (tensors on the device); updates the state in
        place and returns the step's metrics (0-d tensors).  ``mark`` as in
        ``loss_and_grads``, and once more, "optimizer", after the update."""
        metrics, grads = self.loss_and_grads(batch, mark)
        with torch.no_grad():
            if "ef" in self.state:
                grads, self.state["ef"] = apply_error_feedback(grads, self.state["ef"])
            _, _, om = adamw_update(self.state["params"], grads, self.state["opt"],
                                    self.tcfg.optimizer, self.decay,
                                    placements=self.placements or None)
        if mark:
            mark("optimizer")
        return dict(metrics, **om)

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """``data.batch(step)`` as tensors on the device; for an encoder-decoder or a VLM
        with the stub frontend's frames or image tokens (``modality_stub``, seeded by the
        seed and the step) in the compute dtype."""
        out = {k: torch.as_tensor(v, device=self.device)
               for k, v in self.data.batch(step).items()}
        stub = modality_stub(self.cfg, out["tokens"].shape[0],
                             self.tcfg.seed * 1_000_003 + step)
        dt = torch_dtype(self.cfg.compute_dtype)
        out.update({k: torch.as_tensor(v, device=self.device).to(dt) for k, v in stub.items()})
        if self.mesh is not None:           # this rank's data shard
            out = P.shard_batch(out, self.rules, self.mesh)
        return out

    def _save(self, step: int) -> None:
        """Checkpoint ``step``: on a mesh every rank gathers, mesh rank 0 writes, and every
        rank waits for the write to commit."""
        tree = self.state_tree()
        if self.mesh is None:
            self.ckpt.save(tree, step)
            return
        if D.mesh_rank(self.mesh) == 0:
            self.ckpt.save(tree, step)
            self.ckpt.wait()
        D.all_reduce_sum(torch.zeros((1,), device=self.device), self.mesh)   # a barrier

    # -- the loop ---------------------------------------------------------------
    def run(self, steps: Optional[int] = None) -> Dict:
        """Train to ``steps`` (default ``tcfg.steps``) under the trainer's rules, where it
        has any (as JAX's ``run``; without, the rules in force stay)."""
        if self.rules is None:
            return self._run(steps)
        with P.use_rules(self.rules, self.mesh):
            return self._run(steps)

    def _run(self, steps: Optional[int] = None) -> Dict:
        steps = steps or self.tcfg.steps
        for step in range(self.start_step, steps):
            self.watchdog.step_start(step)
            metrics = self.step_fn(self.batch(step))
            # read one scalar so the watchdog times the step, not the asynchronous
            # enqueue of its launches
            loss = float(metrics["loss"])
            ev = self.watchdog.step_end()
            if step % self.tcfg.log_every == 0 or step == steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["loss"] = loss
                self.metrics_history.append({"step": step, **m})
                log.info(
                    "step %5d loss=%.4f ce=%.4f gnorm=%.2f lr=%.2e%s",
                    step, m.get("loss", 0), m.get("ce", 0),
                    m.get("grad_norm", 0), m.get("lr", 0),
                    " [straggler]" if ev else "",
                )
            if self.ckpt and (step + 1) % self.tcfg.checkpoint_every == 0:
                self._save(step + 1)
        if self.ckpt:
            self._save(steps)
            self.ckpt.wait()
        return self.metrics_history[-1] if self.metrics_history else {}
