"""Batched LM serving: continuous request batching over a decode step (torch).

Counterpart of ``repro.serving.engine``, with the same behaviour step for
step (for an MoE model it decides the routing of the live slots):
  * requests arrive with a prompt and a ``max_new_tokens`` budget; the
    engine packs up to ``max_batch`` of them into fixed slots;
  * admission prefills the request at batch 1 into a fresh ``max_len``
    cache and splices it into the slot's row of the engine's caches (so
    the row holds zeros past the prompt, and a recurrent state is the
    prompt's alone, whatever the slot held before), and takes the
    prefill's greedy token as the first output;
  * every ``tick`` runs ONE decode step for ALL slots, each at its own
    position (a per-slot index vector): an inactive slot decodes at index
    0 with its last token, which is never reset when a request finishes
    (its row is overwritten at the next admission);
  * a request ends once it holds ``max_new_tokens`` tokens, the prefill's
    included, and its slot is recycled.

Greedy decoding takes the first index among equal logits, as
``jnp.argmax`` does.  The engine runs on ``device`` (``None`` is the card)
and never falls back to the host.  It serves the decoder-only families
with a self-attention cache (GQA's or MLA's), a recurrent state
(xLSTM's, whose decode ignores the index) or both (the Mamba hybrid's KV
rows beside its Mamba layers' states); an encoder-decoder or a VLM
raises ``NotImplementedError``: a request carries no frames or image, so
those are driven through ``launch.steps`` (``launch/serve.py``).

On a mesh (``mesh=``, an ``AxisMesh`` of several ranks; the dense family,
MLA's ``{latent, k_rope}`` cache included, and MoE, the OT router included;
every rank runs the same engine on the
same requests, so every rank takes the same admission decisions): the
model holds this rank's blocks (``partition.place_module``), the cache
this rank's slots, contiguous blocks of them over the data axes (all of
them where the data axes do not divide ``max_batch``); the batch-1
prefill runs replicated over the data axes and the rank whose block
holds the slot splices it in; a tick decodes this rank's slots, and
the next tokens, each an argmax over the vocabulary's blocks, are
all-gathered over the data axes, so every rank's ``out_tokens`` are the
same.  A mesh with no rank for this process raises.
"""
from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import distributed as D
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import build_model
from repro_torch.models.lm import LM
from repro_torch.sharding import partition as P
from repro_torch.utils.logging import get_logger

log = get_logger("serving")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray             # (S,) int32
    max_new_tokens: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _splice(full: Mapping, one: Mapping, axes: Mapping, slot: int) -> None:
    """Every leaf of a block's cache ``full`` gets ``one``'s batch-1 leaf as its row
    ``slot``, in place: the batch axis found through the logical axes, the tree walked
    as it nests (an xLSTM's stacked mLSTM state, a hybrid's stacked Mamba states have
    their batch on axis 1); on a mesh by the rank whose block holds the row."""
    for name, ax in axes.items():
        if isinstance(ax, Mapping):
            _splice(full[name], one[name], ax, slot)
        else:
            P.splice(full[name], one[name], ax.index("batch"), slot)


class ServingEngine:
    """Serves ``cfg`` with ``max_batch`` slots of ``max_len`` positions on ``device``.

    ``params`` is the model: an :class:`~repro_torch.models.lm.LM` on the device
    (used as it is; on a mesh, placed there unless it already is), or a state dict in
    the port's layout (for instance ``convert.lm_params_from_numpy`` of a JAX parameter
    tree), loaded into a model built on the device; on a mesh each entry whole or this
    rank's block of it.  ``mesh`` (with ``rules``, by default ``default_rules``) serves
    on a mesh of ranks, each on ``device`` (``None``: the card of its local rank).
    """

    def __init__(self, cfg: ModelConfig, params: Union[LM, Mapping], max_batch: int = 4,
                 max_len: int = 512, device: DeviceLike = None, mesh=None,
                 rules: Optional[P.Rules] = None):
        if cfg.family in ("encdec", "vlm"):
            raise NotImplementedError(
                f"{cfg.arch_id}: a request carries no frames or image for the "
                f"{cfg.family!r} family's cross-attention; drive it through "
                "repro_torch.launch.steps (make_prefill_step with the memory, then "
                "make_serve_step), as launch/serve.py does")
        if mesh is not None and mesh.size() > 1 and not P.on_mesh(mesh):
            raise ValueError(f"{mesh!r} has no rank for this process: an engine on a mesh of "
                             f"{mesh.size()} ranks needs a process group of that size "
                             "(repro_torch.core.distributed.make_mesh)")
        self.cfg = cfg
        self.mesh = mesh if P.on_mesh(mesh) else None
        self.rules = None
        if self.mesh is not None:
            P.check_mesh_family(cfg, self.mesh)
            self.rules = rules or P.default_rules(self.mesh.axis_names)
            self.device = D.rank_device(device)
        else:
            self.device = resolve_device(device)
        self.model = self._load(cfg, params)
        self.max_batch = max_batch
        self.max_len = max_len
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.lengths = np.zeros((max_batch,), np.int32)
        self.caches = self.model.init_cache(max_batch, max_len)
        self._last_tokens = np.zeros((max_batch, 1), np.int32)
        # this rank's slots: the cache's rows, split over the data axes as they divide
        self._data, lo, n = (), 0, max_batch
        if self.mesh is not None:
            self._data = P.batch_split(max_batch, self.rules, self.mesh)
            n = max_batch // self.mesh.group_size(self._data)
            lo = self.mesh.position(self._data) * n
        self._mine = slice(lo, lo + n)

    def _load(self, cfg: ModelConfig, params: Union[LM, Mapping]) -> LM:
        """The model on the engine's device (and mesh)."""
        if isinstance(params, LM):
            if params.embed.device.type != self.device.type:
                raise ValueError(f"the model is on {params.embed.device}, the engine on "
                                 f"{self.device}")
            if self.mesh is not None and P.module_mesh(params) != (self.rules, self.mesh):
                if P.module_mesh(params) is not None:
                    raise ValueError("the model is placed on another mesh or under other "
                                     "rules than the engine's")
                P.place_module(params, self.rules, self.mesh)
            return params
        model = build_model(cfg, device="meta")
        if self.mesh is None:
            model.load_state_dict({k: torch.as_tensor(v).to(self.device)
                                   for k, v in params.items()}, assign=True)
            return model
        P.place_module(model, self.rules, self.mesh, cut_params=False)
        P.load_blocks(model, {k: torch.as_tensor(v) for k, v in params.items()}, self.device)
        return model

    @torch.no_grad()
    def _decode(self, tokens: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
        """One decode step of this rank's slots; the next token of every slot."""
        mine = self._mine
        with P.batch_rows(self.max_batch):
            logits, self.caches = self.model.decode_step(tokens[mine], self.caches,
                                                         index[mine])
            nxt = self.model.greedy(logits[:, -1, :]).to(torch.int32)[:, None]
        if self._data:
            nxt = D.all_gather_axes(nxt, self.mesh, self._data, 0)
        return nxt

    # -- slot management -----------------------------------------------------
    def try_admit(self, req: Request) -> bool:
        for i, s in enumerate(self.slots):
            if s is None:
                self._prefill_slot(i, req)
                return True
        return False

    @torch.no_grad()
    def _prefill_slot(self, slot: int, req: Request):
        S = len(req.prompt)
        if S + req.max_new_tokens > self.max_len:
            raise ValueError(f"request {req.rid}: {S} prompt + {req.max_new_tokens} new "
                             f"tokens exceed max_len {self.max_len}")
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int32)[None, :], device=self.device)
        # batch-1 prefill into a fresh cache, then its whole row into the slot's (the
        # batch axis located from the cache's logical axes, as in the JAX engine)
        # (on a mesh the batch-1 prefill runs on every data shard: the data axes do not
        # split one row)
        one_cache = self.model.init_cache(1, self.max_len)
        with P.batch_rows(1):
            logits, one_cache = self.model.prefill(tokens, one_cache)
            nxt = int(self.model.greedy(logits[0, -1]))
        for full, one, axes in zip(self.caches, one_cache, self.model.cache_logical_axes()):
            _splice(full, one, axes, slot)
        req.out_tokens.append(nxt)
        self.slots[slot] = req
        self.lengths[slot] = S
        self._last_tokens[slot, 0] = nxt
        log.info("admitted request %d into slot %d (prompt %d tokens)", req.rid, slot, S)

    # -- one engine tick -------------------------------------------------------
    def tick(self) -> List[Request]:
        """One decode step for every slot; returns the requests that finished."""
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return []
        # per-slot positions (continuous batching): each slot decodes at its own
        # frontier; inactive slots decode at index 0 (their cache rows are
        # overwritten at the next prefill)
        index = torch.tensor(self.lengths, device=self.device)
        tokens = torch.tensor(self._last_tokens, device=self.device)
        nxt = self._decode(tokens, index).cpu().numpy()
        finished = []
        for i in active:
            req = self.slots[i]
            req.out_tokens.append(int(nxt[i, 0]))
            self.lengths[i] += 1
            self._last_tokens[i, 0] = int(nxt[i, 0])
            if len(req.out_tokens) >= req.max_new_tokens:
                req.done = True
                finished.append(req)
                self.slots[i] = None
                self.lengths[i] = 0
                log.info("request %d finished (%d tokens)", req.rid, len(req.out_tokens))
        return finished

    def run(self, requests: List[Request]) -> List[Request]:
        pending = list(requests)
        done: List[Request] = []
        while pending or any(s is not None for s in self.slots):
            while pending and self.try_admit(pending[0]):
                pending.pop(0)
            done.extend(self.tick())
        return done
