"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py      # needs one CUDA card; takes about fifteen minutes
    python3 chip_smoke.py --compare _archive/parent [--pairs 10]
                               # this tree's kernels against another checkout's
    python3 chip_smoke.py --mesh-only
                               # phase 12 alone, from an earlier full run's results
    python3 chip_smoke.py --lm-only
                               # phase 13 alone (the LM trainer)
    python3 chip_smoke.py --serve-only
                               # phase 14 alone (LM serving, MoE, the OT router)
    python3 chip_smoke.py --families-only
                               # phase 15 alone (MLA, the encoder-decoder, the VLM)
    python3 chip_smoke.py --xlstm-only
                               # phase 16 alone (xlstm-1.3b served, float32, trained)
    python3 chip_smoke.py --hybrid-only
                               # phase 17 alone (jamba-1.5-large-398b on one period:
                               # served, float32, forward and backward)
    python3 chip_smoke.py --lm-mesh-only [--lm-mesh-part a]
                               # phase 18 (b) alone, on four cards: the LM mesh
                               # (yi-9b at full width and depth on (2, 2), NCCL);
                               # part a (the full run's, one card) alone
    python3 chip_smoke.py --serve-mesh-only
                               # phase 19 (b) alone, on four cards: serving on the
                               # LM mesh (phi3.5-moe-42b-a6.6b at full width and
                               # depth on (1, 4) and (2, 2), NCCL)
    python3 chip_smoke.py --attn-mesh-only
                               # phase 20 (b) alone, on four cards: the attention
                               # families on the LM mesh (llama-3.2-vision-90b at
                               # full width and depth on (1, 4) and (2, 2), NCCL)

The main path is the default plan at the paper's largest scale:
``repro_torch.ot.compile(Problem.from_samples(...), ExecutionPlan(grad_impl=
'pallas')).solve()``, which resolves to the factorized squared-l2 route
(the dense cost would take 1.05 GB): per L-BFGS evaluation K1 (screen) and
K5 or K6 (gradient on costs rebuilt from samples), per snapshot K4.  The
dense-cost route (K1, K2/K3, and K4's body on the dense cost) is driven as
well, and so are the fused oracle, ``ExecutionPlan(grad_impl='fused')``
(per evaluation K8 on the factorized route or K7 on the dense one, screen
and gradient in one launch; K1 + K6 / K3 on its compact branch), and
``precision='bf16'`` (the prepared cost stored in bfloat16) on both.

Phases:
  1. device: require CUDA; print the card's name and power limit;
  2. build: build the kernel library from ``src/repro_torch/kernels/csrc``;
  3. kernels vs plain versions at the main path's shapes (B = 1, L_pad =
     1280, g = 16, n_pad = 12800, d = 2, 8 x 128 tiles) at four live-tile
     shares: K1 exactly equal, K2 within rtol 1e-5 / atol 1e-6, K3 bitwise
     equal to K2, K5 and K6 bitwise equal to K2 and K3 on the
     device-materialized cost, K7/K8 flags exactly K1's and their sums
     bitwise K2's / K5's (and K8 == K7), K4 (both loaders) torch.equal to
     its plain version, all deterministic across runs; then the bf16
     instantiations of K2-K8 on the bf16 cost forms, held to their plain
     versions as the f32 ones are; K7 / K8 where a batch of the fused
     kernels holds many live tiles (one whole tile row live) and where only
     the launch's last tile is live, f32 and bf16, each with FUSED_RERUNS
     = 20 runs back to back bitwise equal; once more at d = 64 on a
     narrower problem, f32 and bf16 (the chunked loader, the tile one
     block: K8 == K5 and K7 there too, flags == K1's); the row-sum and
     row-dot kernels against their plain versions and across batch sizes,
     row_dot(a, b) bitwise row_sum(a * b), over row lengths 1 to 33280;
     at every share and storage the dense loader each of K2, K3 and K7 ran,
     read from its kernel's full name in the profiler's records: K2 and K7
     the staged one (tensor copies into shared memory), K3 the direct loads,
     so K3 == K2 and K7 == K2 hold the two loaders to each other bitwise;
  4. end to end through ``repro_torch.ot``: the default plan (factorized)
     with grid / compact / auto, the dense route (``geometry='dense'``)
     with grid / compact / auto, the dense route on
     ``problem.materialized()`` with grid / compact / auto, the fused
     oracle on both routes with grid / compact / auto, bf16 with pallas and
     fused, grid / compact / auto, on both routes (the factorized bf16
     solves stopped at 12 rounds: they take 108 to converge), and the plain
     'screened' and 'dense' backends.  Factorized equals
     dense-on-materialized bit for bit (duals, value, plan, rounds,
     stats); the main path keeps the value, plan and dual fingerprints the
     parent kernels gave it; grid == compact == auto bitwise
     per route; fused == pallas bitwise per route, impl and precision (the
     plan by an exact integer fingerprint of its bits); every f32
     objective within rtol 2e-5 of 'dense', every bf16 one printed beside
     it with its relative gap; launch counters reset just before and read
     just after each solve, and held per path (pallas: K1 and one gradient
     kernel per evaluation; fused grid: the fused kernel once per
     evaluation and no K1; fused compact: K1 and the compact kernel; the
     route's snapshot kernel once per snapshot).  Then the solver calls
     alone: the main path's and the fused/auto and fused/grid factorized
     ones, each with its peak device memory (must stay under the 1.05 GB
     dense cost) and a torch.profiler trace (device busy time, idle share,
     launches per evaluation, largest kernels; the main path's launches
     per evaluation must stay under the 199.8 they were while each inner
     product took a multiply and a row sum); the dense route's
     fused/auto solver call in f32 and bf16, peak memory.  The fused route's
     'auto' decides once per round at the snapshot point (as the JAX
     package does); at this scale it takes the two-launch compact branch in
     every round, so the kernel table counts K7/K8 on the fused grid paths;
  5. at the state of the main path's last round boundary: K1-K8 held to
     their plain versions (K1 and K4 exactly, K2/K3 within the f32 error
     bound of a float64 evaluation, K5/K6 bitwise to K2/K3, K7/K8 flags
     exactly K1's and sums bitwise K2's / K5's) and timed (CUDA events,
     median) beside their bounds and the plain versions; the round
     boundary with the plain torch.sum snapshot norms
     against K4's body; K2/K3/K5-K8 times across live shares (with every
     tile live they go into their kernel rows beside the bound), and
     K2/K5/K7/K8 on bf16 costs; at the final state and fully live, K7 / K8
     device time (torch.profiler, a call's launches summed) beside K1 + K2 /
     K1 + K5, the two launches each fused call replaces; the dense loader
     K2, K3 and K7 run at the paper's scale, f32 and bf16 (from the
     profiler); K2, K3 and K7 a call split into the gradient kernel and
     slot_reduce_kernel at the final state (with the cost in L2, and with
     the L2 flushed before each call, as the solver's calls find it) and
     fully live;
  6. solo vs batched (B = 2) at L = 64, n = 1024, dense and factorized,
     pallas and fused, grid and compact: bitwise equal (duals, value,
     rounds, stats), or the smoke fails;
  7. the solo oracle layer (B9-B14) at the state of phase 5: each solo
     wrapper (K2/K3/K7/K5/K6/K8 launched at B = 1), each solo oracle of
     kernels/ops.py and ``make_value_and_grad`` on both routes bitwise
     equal to the batched ones at B = 1 (sums, flags, value, gradient);
     the solo path (``make_value_and_grad`` once per route and oracle)
     counted, each solo wrapper timed beside its twin's bound;
  8. training-time OT at full width: ``OTLayer.from_samples`` with
     ``normalize_cost`` under grad_impl 'pallas' and 'fused' (value bitwise
     ``solve_dual``'s on the same FactorizedCost; forward + backward with
     one solve, exact zero gradients on padded rows, the translation
     invariance of the squared-l2 cost, peak memory under the 1.05 GB dense
     cost; times), ``grad_refine=20`` through B12, and five Adam steps of a
     Linear(2, 2) map under ``ot_alignment_loss`` (g = 10, unpadded) with a
     loss that must fall;
  9. ``solver='stochastic'`` at full width (sgd_block_cols=128, the default
     60 epochs, not cut): reruns, fused == pallas and 'grid' == 'auto'
     bitwise (the pair prices 'auto''s host read per step), the value at
     most the L-BFGS one, times and launches per step, a profile of 5
     epochs; and on the golden problem at sgd_block_cols=4 (tile_n = 4).
 10. ``Executor.solve_many`` and ``stream`` at full width on four problems
     (seeds 0-3; three with 10 samples per class, one with 12, padded to
     the same g = 16, so K4's register kernel takes a row mask per
     problem), the default plan: each problem bitwise its solo solve
     (duals, value, rounds, stats, plan fingerprint), the stream bitwise
     ``solve_many`` with its alive count never rising; the B = 4 solver
     call's peak memory and profile (device busy, idle share, launches per
     evaluation) beside phase 4's B = 1 figures;
 11. the serving engine, ``OTServingEngine(reg, SolveOptions(grad_impl=
     'pallas'), max_batch=4)``: six full-width requests (four with 10
     samples per class, two with 12) through the four slots of one bucket,
     each DONE once with the value and duals of its solo dense solve, bit
     for bit; ticks, launches per tick, time per tick by live slots and
     the idle share over the ticks; and a chaos run at L = 128 (a NaN cost
     walks one request down the ladder to 'dense'; its neighbours keep
     their bits).
 12. the same work over two ranks of ``torch.distributed``, spawned from here
     (NCCL with a card each where there are two, else gloo with both on card
     0; the backend and world size on a line of their own): (a)
     ``solve_many`` and (b) ``stream`` with ``ExecutionPlan(grad_impl=
     'pallas', devices='all')`` on phase 10's problems, each bitwise phase
     10's solo solve (prints handed over in a file); (c) the engine on the
     mesh, ``max_batch=2``, on four of phase 11's requests, each DONE once
     with phase 11's bits; (d) ``solve_dual_distributed`` on the main
     problem's dense cost at full width on a (data=2, model=1) and a
     (data=1, model=2) mesh, 'pallas' grid and compact, within rtol 2e-5
     of phase 4's dense route, its plan within a total variation of 2.5e-2
     of that route's and its marginal residual at most 1.5 x the route's,
     every rank's duals equal, K1, K2/K3 and K4's dense body launched on
     every rank, the collective bytes per evaluation printed.  Each rank
     prints its wall, device busy time, idle share and launches per
     evaluation beside phase 10's single-rank figures, and (a)'s time split
     into lowering, the block's solve, the final gather and the plan
     recoveries.
 13. the LM trainer with the paper's OT alignment loss:
     ``repro_torch.training.trainer.Trainer`` on ``smollm-135m`` at full
     width and depth (30 layers, d_model 576, 9 / 3 heads, d_ff 1536, vocab
     49 152, tied, bf16, 134 515 008 parameters), ``SyntheticLM(vocab, 128,
     64, 8 classes, seed 0)``, ``TrainConfig(ot_align=True,
     ot_align_weight=0.05, ot_grad_impl='pallas', ot_solver='lbfgs',
     remat='block')``, 12 steps at lr 6e-4 (warmup 2, decay over 12): each
     step solves one 32 x 32 OT problem (8 classes x 4) at d = 576 on K1, K4
     and K5/K6.  Every loss and OT distance finite, every OT distance above
     0, the last loss below the first, K1, K4 and K5 or K6 launched (the
     counters); the step's wall time split into the LM forward + backward,
     the OT solve, its backward and the optimizer, tokens per second, peak
     memory, a profile of 1 step (idle share, launches per step) and each OT
     kernel's launches per step; K1, K4, K5, K6 and K8 at the step-0 OT
     operands (L_pad 8, g 4, n_pad 128, d 576: the chunked loader, 18 chunks
     of 32, the tile one block, shared by K4-K8) held to their plain versions
     as at d = 64, f32 and bf16 (K8 == K5 bitwise, flags == K1's), and timed;
     a 3-step run with ``ot_grad_impl='fused'`` whose step-0 OT distance
     is the pallas run's bit for bit; and a restart at full width cut to 2
     layers (save at step 3, resume to 6) bitwise an uninterrupted 6-step
     run, under ``torch.use_deterministic_algorithms(True)``.
 14. LM serving through ``repro_torch.serving.engine.ServingEngine`` (four
     slots, continuous batching, prefill at batch 1 and one decode step a
     tick for every slot): (a) ``smollm-135m`` at full width and depth, bf16,
     eight requests of 64 + 32 tokens, each back once with 32 tokens, those
     served in recycled slots bit for bit each alone in a fresh engine; with
     ``kv_quant`` the int8 cache under 0.65 of the bf16 bytes and its
     teacher-forced decode logits within 0.2 of the bf16 run's std; in float32
     the teacher-forced prefill and decode logits within rtol / atol 2e-3 of
     ``LM.forward``.  (b) ``qwen2-moe-a2.7b`` at full width and depth (24
     layers, 60 experts top-4, 4 shared, bf16, 14 315 636 736 parameters drawn
     on the card), six requests of 32 + 16: every request served, a second run
     the same tokens bit for bit, the dropped fraction printed.  (c) the same
     at full width cut to 1 layer with ``ot_balance``, six requests of 32 + 8: one OT solve
     (``grad_impl='screened'``: ``row_dot`` / ``row_sum``, no other port
     kernel) per MoE layer and forward pass, every routing weight finite and
     summing to 1 within 1e-4, the router's seconds a solve and launches; the
     first layer's prefill routing beside top-k's (load_cv, experts per
     sequence; the logits saved in ``_archive/phase14``, as the CPU test's
     fixture ``tests/fixtures/router_prefill.npz`` was); the same logits
     solved to convergence (``max_iters=400``), whose load_cv must be below
     top-k's; and tests/test_ot_routing.py's property on the card: on its
     skewed router ``ot_route``'s load_cv below top-k's.  For each run tokens a second, ms a
     tick, peak memory, and a profile of a few ticks (idle share, launches a
     tick).
 15. the attention families at full width, random bf16 weights from seed 0, each
     sub-phase's model freed and the peak reset before the next: (a) ``minicpm3-4b``
     (MLA; 62 layers, 4 261 902 848 parameters, the cache 35 712 B a token, both
     checked on ``meta``) cut to 4 layers for the smoke's time, served through
     ``ServingEngine`` as 14 (a) (eight requests of 64 + 32, four slots): each back
     once, those in recycled slots bit for bit each alone in a fresh engine, and in
     float32 the absorbed path (prefill, teacher-forced decode) within rtol / atol
     2e-3 of the expanded one (``forward``); (b) the same trained with the OT
     alignment loss on phase 13's data for 3 steps, cut to 4 of its 62 layers for
     the smoke's time (full depth fits: an AdamW step of 16 B a
     parameter plus 12 GiB; a deeper cut where it would not), said so: losses
     finite, the OT term present, K1, K4 and K5 or K6 launched; the step split, a
     profile of one step, the fused OT term of one step (K8 or K6); K1, K4, K5, K6
     and K8 at the step-0 OT operands (L_pad 8, g 4, n_pad 128, d 2560: 80 chunks
     of 32) held as in phase 13 and timed; (c) ``whisper-medium`` (24 + 24 layers)
     at full width and depth: one AdamW step of ``make_train_step`` on 8 x 128
     tokens and 8 x 1500 frames, then ``make_prefill_step`` (the encoder, then the
     decoder's prefill) of 4 x 32 tokens and 32 ``make_serve_step`` decode steps:
     the loss finite, each layer's ``cross_kv`` after prefill the projection of the
     encoder's output bit for bit, other frames other prefill logits, and in
     float32 prefill and decode within 2e-3 of the decoder without a cache; (d)
     ``llama-3.2-vision-90b`` cut to one period (5 of 100 layers, 6 379 634 689
     parameters), ``cross_gate`` set to 0.5 (at its zero init the cross path adds
     nothing): forward and backward of ``train_loss`` on 4 x 128 tokens and 1601
     image tokens (no optimizer: its state does not fit), the loss and gradient
     norm finite and ``cross.wq``'s gradient nonzero, then (c)'s serving and checks
     with the image tokens.
 16. the xLSTM family at full width, ``xlstm-1.3b`` (48 layers in 6 periods of an sLSTM
     and 7 mLSTMs, d_model 2048, 4 heads, 2 020 751 696 parameters, a recurrent state of
     706 560 000 B a sequence, both checked on ``meta``), random bf16 weights from seed 0:
     (a) cut to 1 of its 6 periods (8 layers) for the smoke's time, served through
     ``ServingEngine`` (four slots, eight requests with prompts of 2, 37, 64, 64,
     128, 129, 257 and 300 tokens, 32 new tokens each): each back once, those in recycled
     slots bit for bit each alone in a fresh engine (a slot's whole state replaced at
     admission); (b) in float32 on 2 of its 6 periods, prefill and 8 teacher-forced
     decode steps within rtol /
     atol 2e-3 of ``LM.forward``, and a chunkwise prefill of 257 tokens (chunks of 128,
     128 and 1) against 257 decode steps from the zero state, its last logits and every
     state leaf within rtol / atol 2e-3; (c) trained with the OT alignment loss on phase
     13's data for 3 steps, as 15 (b), cut to 1 of its 6 periods (8 of 48 layers) for
     the smoke's time (losses, OT distances and gradient norms finite, the step split, a
     profile of one step, the fused OT term), K1, K4, K5, K6 and K8 at its step-0 OT
     operands (d = 2048: 64 chunks of 32) held to their plain versions and timed.
 17. the hybrid family, ``jamba-1.5-large-398b`` at full width (d_model 8192, d_inner
     16 384, d_state 16, dt_rank 512, 64 / 8 heads, d_ff 24 576, 16 experts top-2 of
     width 24 576, vocab 65 536), random weights from seed 0, each sub-phase's model
     freed and the peak reset before the next; the depth cut to one period (the repo's
     ``reduced()`` layout: attention at the middle slot, MoE at the odd ones): (a) one
     period of 4 layers (Mamba + MLP, Mamba + MoE, attention + MLP, Mamba + MoE;
     23 021 379 584 parameters, bf16; a cache of 3 440 640 B a sequence and 4 096 B a
     cached token) served through ``ServingEngine`` (four slots, eight requests with
     prompts of 2, 37, 64, 64, 128, 129, 257 and 300 tokens, 32 new tokens each): each
     back once, a second run the same tokens bit for bit, each request admitted into a
     recycled slot with a fresh engine's first token and slot cache (KV rows, every Mamba
     ``conv`` and ``ssm`` leaf) bit for bit (later ticks may drop other tokens at the MoE's
     capacity, so they are not held), the dropped fraction printed; (b) float32 on one
     period of 2 layers (Mamba + MLP, attention + MoE; 11 912 896 512 parameters), the
     MoE's capacity factor raised to 4 as ``reduced()`` does (no token dropped): prefill
     and 8 teacher-forced decode steps within rtol / atol 2e-3 of ``LM.forward``; one
     Mamba layer's chunkwise prefill of 257 tokens (chunks of 128, 128 and 1) against 257
     decode steps from the zero state, outputs and both state leaves within rtol / atol
     2e-3; (c) bf16 on that period: ``train_loss`` forward and backward (remat per block,
     no optimizer: AdamW's state does not fit at any cut that holds a MoE layer) on 8 x
     128 tokens of phase 13's step-0 batch, the loss and gradient norm finite and
     ``mamba.0.A_log``'s and ``attn.wq``'s gradients nonzero; the OT alignment term on the
     whole batch (L_pad 8, g 4, n_pad 128, d 8192), as the trainer computes it from
     ``embed``, and its backward, pallas (K1, K4, K5 or K6 launched) and fused (K8 or
     K6); K1, K4, K5, K6 and K8 at its operands (256 chunks of 32) held to their plain
     versions and timed.
 18. the LM mesh (``sharding/partition.py``: FSDP over the data axes x tensor / expert
     parallelism over ``model``, one rank a process over ``torch.distributed``):
     (a) ``yi-9b`` cut to 2 of its 48 layers at full width (d 4096, 32 / 4 heads, ff
     11 008, vocab 64 000; bf16, AdamW with float32 master weights, the OT term on
     'pallas', 64 x 32 tokens): one step on one card here, then two gloo ranks on
     this card run it on a (data=1, model=2) and a (2, 1) mesh, each rank holding its
     rules blocks: the loss within rtol 1e-3 of the card's, the grad_norm within rtol
     1e-3, every parameter within 5e-3, each leaf's AdamW m within 5 % of its norm
     (the gradient, which the parameters after one step cannot show), the ranks'
     losses and OT distances bit for bit, K1, K4 and K5 or K6
     launched on every rank; K1, K4, K5, K6 and K8 at the card's step-0 OT operands
     (d = 4096: 128 chunks of 32) held to their plain versions and timed;
     (b) ``--lm-mesh-only``, four cards, NCCL, (2, 2): ``yi-9b`` at full width and
     depth, 3 steps of 8 x 512 tokens (finite, step 0 within 2 of ln 64 000, each
     card's peak under 80 GB), the 2-layer cut and ``qwen2-moe-a2.7b`` cut to 4 layers
     (float32 compute; ``local_dispatch`` off and on, the dropped fraction one card's
     within 4 routed entries a layer, with it on one card's under the rules of two data
     shards, JAX's per-shard rule) against one card, step times and a profile of the
     last step (the collectives' device time) per rank.
 19. serving on the LM mesh (sharded prefill and decode, ``ServingEngine(mesh=)``, the
     OT router over the whole batch): (a), in phase 18 (a)'s two gloo ranks on this
     card, ``phi3.5-moe-42b-a6.6b`` cut to 2 of its 32 layers at full width (bf16
     parameters, float32 compute) served on (1, 2) and (2, 1) against the card's engine
     (every request's tokens equal, every rank's the same, the prefill logits within
     rtol / atol 1e-3), and ``qwen2-moe-a2.7b`` cut to 2 layers with the OT router on
     (2, 1) (each routing the one-device solve of the whole batch's router logits bit
     for bit, the tokens beside the card's, row_dot / row_sum launched); (b)
     ``--serve-mesh-only``, four cards, NCCL: ``phi3.5-moe-42b-a6.6b`` at full width
     and depth (83.7 GB in bf16) on (1, 4) and (2, 2), 16 requests of 64-512 prompt
     tokens and 32 new ones, 16 slots of 1 024 positions (ms a tick, tokens/s,
     admission s, peak and state bytes, launches a tick, NCCL's device time in
     profiled ticks, per rank), and the 2-layer cut on both meshes against one card.
 20. the attention families on the LM mesh (MLA, the encoder-decoder, the VLM; query
     heads split over ``model``, KV heads whole, a modality memory's rows with the
     tokens'): (a), in phase 18 (a)'s two gloo ranks on this card, at full width (bf16
     parameters), ``minicpm3-4b`` cut to 2 layers and ``whisper-medium`` to 2 + 2 on
     (1, 2) and (2, 1), ``llama-3.2-vision-90b`` cut to one period (5 layers,
     ``cross_gate`` 0.5) on (1, 2) alone (its 12.8 GB would cross the host at every
     forward on (2, 1)): one trainer step with the OT term (the VLM period's loss and
     gradients without the optimizer, whose state does not fit), against the card's
     (loss, grad norm, parameters and AdamW m as phase 18 (a); the VLM's loss and
     gradient norm), every rank's bits the same, K1, K4 and K5 or K6 launched on every
     rank; the float32-compute twin prefilled (2 x 16 tokens, the stub frames or image
     tokens) and decoded 3 steps through the steps, MLA's also through
     ``ServingEngine(mesh=)``: the tokens the card's, the prefill logits within rtol /
     atol 1e-3; K1, K4, K5, K6 and K8 at the card's whisper step-0 OT operands (d =
     1024) held to their plain versions and timed.  (b) ``--attn-mesh-only``, four
     cards, NCCL: ``llama-3.2-vision-90b`` at full width and depth (100 layers, bf16,
     175.3 GB) prefilled (8 x 512 tokens, 1 601 image tokens each) and decoded 32
     steps through the steps on (1, 4) and (2, 2); one VLM period trained with AdamW on
     (2, 2); ``minicpm3-4b`` (62 layers) and ``whisper-medium`` (24 + 24) trained on
     (2, 2) with the OT term, 3 steps of 8 x 512 tokens; MLA served through the engine
     and whisper through the steps on (1, 4) at full depth; each cut against card 0
     (per rank: ms a decode step or tick, prefill s, tokens/s, state and peak bytes,
     launches and NCCL's device time in profiled steps, step walls).
Phase 3 also runs K2-K8 at tile_n 4, 20, 40 and 128 on a narrow problem
(K2, K3 and K7 in f32 and bf16; K2 and K7 on the staged loader at 128, 1024
and 256, on the direct loads where a warp has lanes past the tile; K3 on the
direct loads: each read from the profiler),
and at 1024 (d = 2) and 256 (d = 64), the kernels' wide builds, and phase 4 holds the main path's solve to the fingerprint it had
before the kernels took any tile width.
The second-to-last line is the kernel table as JSON (K1-K8, B9-B14, and
row_sum / row_dot, the solver's batch-invariant reductions, which stand in
for XLA's reductions and have no TPU kernel; their ``launches_ot_router``
are phase 14 (c)'s; K1, K4, K5, K6 and K8 once more at phase 13's trainer
shapes, ``@lm_step``, d = 576, phase 15 (b)'s, ``@mla_step``, d = 2560, phase 16
(c)'s, ``@xlstm_step``, d = 2048, phase 17 (c)'s, ``@hybrid_step``, d = 8192, and
phase 18 (a)'s, ``@lm_mesh_step``, d = 4096, and phase 20 (a)'s whisper step,
``@attn_mesh_step``, d = 1024; row_sum / row_dot's
``launches_serve_mesh`` are phase 19 (a)'s OT router on (2, 1)), the last line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")
# cuBLAS needs it before CUDA starts for torch.use_deterministic_algorithms (phase 13);
# so every phase runs with this cuBLAS workspace
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
TILE_L, TILE_N = 8, 128

K1, K2, K3 = "screen_batched", "gradpsi_batched", "gradpsi_compact_batched"
K4, K5, K6 = "snapshot_norms_fact_batched", "gradpsi_fact_batched", "gradpsi_fact_compact_batched"
K7, K8 = "gradpsi_fused_batched", "gradpsi_fused_fact_batched"
K4D = "snapshot_norms_dense_batched"          # K4's body on the dense cost
SLOT = "slot_reduce_kernel"                   # each gradient call's second launch
KERNELS = (K1, K2, K3, K4, K5, K6, K7, K8)
# the solo wrappers (ROADMAP B9-B14): the batched kernel of their twin at B = 1
B9, B10, B11 = "gradpsi", "gradpsi_compact", "gradpsi_fused"
B12, B13, B14 = "gradpsi_fact", "gradpsi_fact_compact", "gradpsi_fused_fact"
SOLO_KERNELS = (B9, B10, B11, B12, B13, B14)
TWIN = {B9: K2, B10: K3, B11: K7, B12: K5, B13: K6, B14: K8}
MAIN_PATH = "factorized/auto"
# The main path's (value, plan fingerprint, (alpha, beta) fingerprints) as the
# kernels gave them before they took any tile width (the parent commit's
# kernels on an H100): the tile-width change must leave them unchanged.
MAIN_PATH_PRINTS = (0.02530081570148468, 4167098694829814692,
                    (132603576222989663, 82920091132708291))
# bf16 solves on the factorized route take 108 rounds to converge (PERF.md);
# the smoke stops them here, which keeps every bitwise check among them
BF16_FACT_ROUNDS = 12
# Device launches per evaluation of the main path's solver call while every
# inner product was a torch multiply and a row_sum launch (PERF.md)
LAUNCHES_PER_EVAL_BEFORE = 199.8
DENSE_PATH = "dense/auto"
FUSED_PATH = "factorized/fused-auto"          # ExecutionPlan(grad_impl='fused')
# 'auto' on the fused route decides once per round at the snapshot point;
# at this scale it takes the two-launch compact branch every round, so the
# fused kernels run on the fused route's grid paths
FUSED_GRID_PATH = "factorized/fused-grid"
FUSED_DENSE_GRID_PATH = "dense/fused-grid"
PORT_KERNELS = ("screen_kernel", "gradpsi_grid_kernel", "gradpsi_compact_kernel",
                "gradpsi_fused_kernel", "slot_reduce_kernel", "snapshot_kernel",
                "snapshot_reg_kernel", "row_reduce_kernel",
                "row_sum_kernel")           # an older tree's name (--compare)
# the solver's batch-invariant reductions (kernels/reduce.py): no TPU kernel,
# they stand in for XLA's jnp.sum
ROW_SUM, ROW_DOT = "row_sum", "row_dot"
REDUCE_PATH = {ROW_SUM: "dense", ROW_DOT: MAIN_PATH}   # where each runs
ROW_D = (1, 31, 32, 33, 4096, 4097, 12800, 20480, 33280)
ROW_D_MAIN = 33280                 # the main path's L-BFGS vectors: m_pad + n
SOURCES = {
    K1: ("src/repro_torch/kernels/csrc/screen.cu", "src/repro/kernels/screen.py:63"),
    K2: ("src/repro_torch/kernels/csrc/gradpsi.cu", "src/repro/kernels/gradpsi.py:522"),
    K3: ("src/repro_torch/kernels/csrc/gradpsi.cu", "src/repro/kernels/gradpsi.py:653"),
    K4: ("src/repro_torch/kernels/csrc/snapshot.cu", "src/repro/kernels/screen.py:157"),
    K5: ("src/repro_torch/kernels/csrc/gradpsi.cu", "src/repro/kernels/gradpsi.py:1091"),
    K6: ("src/repro_torch/kernels/csrc/gradpsi.cu", "src/repro/kernels/gradpsi.py:1205"),
    K7: ("src/repro_torch/kernels/csrc/gradpsi.cu", "src/repro/kernels/gradpsi.py:1485"),
    K8: ("src/repro_torch/kernels/csrc/gradpsi.cu", "src/repro/kernels/gradpsi.py:1751"),
    B9: ("src/repro_torch/kernels/csrc/gradpsi.cu", "src/repro/kernels/gradpsi.py:276"),
    B10: ("src/repro_torch/kernels/csrc/gradpsi.cu", "src/repro/kernels/gradpsi.py:397"),
    B11: ("src/repro_torch/kernels/csrc/gradpsi.cu", "src/repro/kernels/gradpsi.py:1362"),
    B12: ("src/repro_torch/kernels/csrc/gradpsi.cu", "src/repro/kernels/gradpsi.py:845"),
    B13: ("src/repro_torch/kernels/csrc/gradpsi.cu", "src/repro/kernels/gradpsi.py:958"),
    B14: ("src/repro_torch/kernels/csrc/gradpsi.cu", "src/repro/kernels/gradpsi.py:1615"),
    ROW_SUM: ("src/repro_torch/kernels/csrc/reduce.cu", "src/repro/core/dual.py:135"),
    ROW_DOT: ("src/repro_torch/kernels/csrc/reduce.cu", "src/repro/core/lbfgs.py:111"),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def sync():
    import torch

    torch.cuda.synchronize()


def median_ms(fn, runs: int, warmup: int = 2) -> float:
    """Median time of ``fn()`` on the card, by CUDA events around each run."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def same(a, b) -> bool:
    """Bitwise equal tuples of tensors."""
    import torch

    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


STAGED, DIRECT = "StagedTile", "DenseTile"     # the dense loaders, as kernel names show them
DENSE_KERNELS = {"gradpsi_grid_kernel": K2, "gradpsi_compact_kernel": K3,
                 "gradpsi_fused_kernel": K7}


def expected_loaders(C, tile_l, g, tile_n):
    """{K2, K3, K7: the dense loader its launch takes on the cost ``C``}: K2 and K7 the
    staged one where ``gradpsi.dense_staged_fits``, K3 the direct loads."""
    from repro_torch.kernels import gradpsi as kg

    fits = kg.dense_staged_fits(tile_l, g, tile_n, C.element_size(), C.data_ptr() % 16 == 0)
    return {K2: STAGED if fits else DIRECT, K3: DIRECT, K7: STAGED if fits else DIRECT}


def launched_loaders(call, repeats: int = 3, tries: int = 5):
    """{K2 / K3 / K7: the dense loader its kernel ran} in profiled calls of ``call()``:
    the template argument of each dense gradient kernel's full name in
    torch.profiler's device records (the wide builds count as their kernel).
    The profiler now and then misses records, even all of one profile's (both
    seen on an H100), so each profile runs ``repeats`` calls and is taken
    again, up to ``tries`` times, until every kernel of the call shows; two
    loaders for one kernel fail at once."""
    out = {}
    for _ in range(tries):
        _, _, _, _, rows = profile_device(lambda: [call() for _ in range(repeats)])
        for key, _, _ in rows:
            kind = DENSE_KERNELS.get(kernel_name(key).removesuffix("_wide"))
            if kind is None:
                continue
            tiles = [t for t in (STAGED, DIRECT) if f"{t}<" in key]
            check(len(tiles) == 1 and out.get(kind, tiles[0]) == tiles[0],
                  f"{kind}: no single dense loader in its kernels' names ({key})")
            out[kind] = tiles[0]
        if len(out) == len(DENSE_KERNELS):
            break
    return out


def check_loaders(label, C, a, b, flags, sched, nact, sargs, kw):
    """Launch K2, K3 and K7 once each on ``C`` under the profiler and check that each ran
    the loader its launch takes at this shape; returns {name: loader}."""
    from repro_torch.kernels import gradpsi as kg

    ran = launched_loaders(lambda: (kg.gradpsi_batched(a, b, C, flags, **kw),
                                    kg.gradpsi_compact_batched(a, b, C, sched, nact, **kw),
                                    kg.gradpsi_fused_batched(a, b, C, *sargs, **kw)))
    want = expected_loaders(C, kw["tile_l"], kw["group_size"], kw["tile_n"])
    check(ran == want, f"K2/K3/K7 ran the loaders {ran}, not {want}, {label}")
    return ran


def kernel_slot_split(fn, cold=False, rows=None):
    """(gradient kernel us, slot_reduce_kernel us) of a call of ``fn`` on the device;
    with ``cold`` the L2 is flushed before each call by writing 128 MiB (more than
    the H100's 50 MB L2), as the solver's calls find the cost after K1's pass (the
    flush's own kernel is left out; its buffer is freed on return).  ``rows``, a
    list, receives the profile's (kernel, device us, records)."""
    import torch

    buf = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda") if cold else None
    split = device_split((lambda: (buf.fill_(1.0), fn())) if cold else fn, rows=rows)
    del buf
    return (sum(us for name, us in split.items() if name.startswith("gradpsi")),
            split.get(SLOT, 0.0))


def print_splits(label, fns, cold=False):
    """Print each call's device time split into the gradient kernel and the slot
    reduction; ``fns`` = {name: call}.  Returns {name: (kernel us, reduction us)}."""
    out = {}
    for name, fn in fns.items():
        rows = []
        k, r = out[name] = kernel_slot_split(fn, cold, rows)
        # beside it the earlier count, every record of the two kernels / calls
        mine = [(kernel_name(n), us, c) for n, us, c in rows]
        summed = sum(us for n, us, _ in mine if n.startswith("gradpsi") or n == SLOT)
        print(f"device split {label}{' (L2 flushed before each call)' if cold else ''} {name}: "
              f"gradient kernel {k:.2f} us + {SLOT} {r:.2f} us = {k + r:.2f} us a call (the "
              f"reduction {r / max(k + r, 1e-9):.3f} of it; torch.profiler, {SPLIT_CALLS} "
              f"calls; records a kernel {', '.join(f'{n} {c}' for n, _, c in mine)}; the two "
              f"kernels' records summed / {SPLIT_CALLS}: {summed / SPLIT_CALLS:.2f} us)",
              flush=True)
    return out


def bound(nbytes, ops):
    """(least ms on the card, 'bytes' or 'operations'), at the data-sheet peaks."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def fact_ops_per_entry(d: int) -> int:
    """fp32 operations per live cost entry of K5/K6: the rebuilt cost, then K2's 9."""
    return (2 * d - 1) + 4 + 9


def snapshot_ops_per_entry(d: int) -> int:
    """fp32 operations per cost entry of K4: the rebuilt cost, f, the mask and three sums."""
    return (2 * d - 1) + 4 + 2 + 1 + 2 + 6


# -- the main problem and its two cost forms -------------------------------------

class Operands:
    """The main problem's tile-padded cost forms on the card (B = 1).

    ``fp``: the FactorizedProblem of the default plan; ``pp``: the
    PaddedProblem whose cost is ``fp`` materialized with the kernels'
    recipe; ``mask``: the padded real-row mask.
    """

    def __init__(self, problem, reg, device):
        import torch

        import repro_torch.ot as ot
        from repro_torch.core.dual import DualProblem
        from repro_torch.kernels import ops as kops

        ex = ot.compile(problem, ot.ExecutionPlan(grad_impl="pallas"), device=device)
        self.spec = problem.group_spec()
        self.prob = DualProblem(self.spec.num_groups, self.spec.group_size,
                                problem.num_target, reg)
        geom = ex.geometry(problem)
        self.fc = kops.FactorizedCost(*(t[None] for t in geom.operands()))
        self.fp = kops.prepare_factorized_problem(self.fc, self.prob)
        rm = torch.as_tensor(self.spec.row_mask().reshape(-1), device=device)
        self.row_mask = rm
        self.mask = kops._padded_mask(rm, self.fp)
        self._pp = self._forms16 = None

    @property
    def pp(self):
        """The dense padded problem on the materialized cost (1.05 GB), built on first use."""
        from repro_torch.kernels import gradpsi as kg
        from repro_torch.kernels import ops as kops

        if self._pp is None:
            fp = self.fp
            self._pp = kops.PaddedProblem(
                Cp=kg.factorized_cost_tile(*fp.leaves()), L=fp.L, g=fp.g, n=fp.n,
                L_pad=fp.L_pad, n_pad=fp.n_pad, tile_l=fp.tile_l, tile_n=fp.tile_n)
        return self._pp

    def drop_dense(self) -> None:
        """Free the materialized cost (the main path's solve must not need it)."""
        self._pp = self._forms16 = None

    def cost_forms(self, storage: str):
        """(dense padded cost, factorized leaves) stored as ``storage`` ('f32' or 'bf16').

        bf16: each f32 form rounded to bfloat16, as ``precision='bf16'``
        prepares them (the dense form rounds the materialized cost, so it
        is not the factorized bf16 cost materialized).
        """
        import torch

        if storage == "f32":
            return self.pp.Cp, self.fp.leaves()
        if self._forms16 is None:
            self._forms16 = (self.pp.Cp.to(torch.bfloat16),
                             tuple(t.to(torch.bfloat16) for t in self.fp.leaves()))
        return self._forms16


# -- phase 3 inputs ------------------------------------------------------------

def kernel_inputs(rng, C, L_pad: int, tau_val: float, live_share: float, device,
                  live_tiles=None):
    """Snapshot state, deltas and duals whose tile flags are live at ~live_share
    (or where the (B, Lt, Nt) bool array ``live_tiles`` says).

    Dead tiles get z~ far under tau and an empty active set, so every entry
    is ZERO; live tiles get z~ spread across tau, some active entries and
    lower bounds that sometimes certify ACTIVE.
    """
    import numpy as np
    import torch

    B, m_pad, n_pad = C.shape
    g = m_pad // L_pad
    Lt, Nt = L_pad // TILE_L, n_pad // TILE_N
    if live_tiles is None:
        live_tiles = rng.random((B, Lt, Nt)) < live_share
    live = np.repeat(np.repeat(live_tiles, TILE_L, axis=1), TILE_N, axis=2)
    z = np.where(live, rng.uniform(0.0, 3.0 * tau_val, live.shape),
                 rng.uniform(0.0, 0.2 * tau_val, live.shape)).astype(np.float32)
    k = (z + rng.uniform(0.0, 2.0 * tau_val, live.shape)).astype(np.float32)
    o = rng.uniform(0.0, 0.5 * tau_val, live.shape).astype(np.float32)
    act = (live & (rng.random(live.shape) < 0.05)).astype(np.int8)
    da = [rng.uniform(0.0, 0.05 * tau_val, (B, L_pad)).astype(np.float32) for _ in range(3)]
    db = rng.uniform(-0.05 * tau_val, 0.05 * tau_val, (B, n_pad)).astype(np.float32)
    sqrt_g = np.full((B, L_pad), np.sqrt(10.0), np.float32)
    alpha = rng.uniform(0.0, 0.6, (B, m_pad)).astype(np.float32)
    beta = rng.uniform(0.0, 0.6, (B, n_pad)).astype(np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return dict(z=t(z), k=t(k), o=t(o), act=t(act), da_plus=t(da[0]), da_full=t(da[1]),
                da_neg=t(da[2]), db=t(db), sqrt_g=t(sqrt_g), alpha=t(alpha), beta=t(beta),
                g=g, L_pad=L_pad)


def screen_args(inp):
    """K1's operands in launch order, from ``kernel_inputs``."""
    return tuple(inp[k] for k in ("z", "k", "o", "act", "da_plus", "da_full", "da_neg", "db",
                                  "sqrt_g"))


def run_kernels(inp, ops, tau_p, gamma, storage="f32"):
    """K1 flags, then K2/K3/K7 on the dense cost, K5/K6/K8 on the factorized one, and K4,
    on the cost forms stored as ``storage``."""
    from repro_torch.kernels import gradpsi as kg
    from repro_torch.kernels import screen as ks

    sargs = screen_args(inp)
    verdict, flags = ks.screen_batched(*sargs, tau=tau_p, tile_l=TILE_L, tile_n=TILE_N,
                                       emit_verdict=True)
    kw = dict(num_groups=inp["L_pad"], group_size=inp["g"], tau=tau_p, gamma=gamma,
              tile_l=TILE_L, tile_n=TILE_N)
    a, b = inp["alpha"], inp["beta"]
    C, leaves = ops.cost_forms(storage)
    sched, nact = kg.build_batch_tile_schedule(flags)
    out = dict(
        verdict=verdict, flags=flags, sched=sched, nact=nact, C=C, leaves=leaves,
        k2=kg.gradpsi_batched(a, b, C, flags, **kw),
        k3=kg.gradpsi_compact_batched(a, b, C, sched, nact, **kw),
        k5=kg.gradpsi_fact_batched(a, b, *leaves, flags, **kw),
        k6=kg.gradpsi_fact_compact_batched(a, b, *leaves, sched, nact, **kw),
        k7=kg.gradpsi_fused_batched(a, b, C, *sargs, **kw),
        k8=kg.gradpsi_fused_fact_batched(a, b, *leaves, *sargs, **kw),
    )
    skw = dict(num_groups=inp["L_pad"], group_size=inp["g"], tile_l=TILE_L, tile_n=TILE_N)
    out["k4"] = ks.snapshot_norms_fact_batched(a, b, *leaves, ops.mask, **skw)
    out["k4d"] = ks.snapshot_norms_dense_batched(a, b, C, ops.mask, **skw)
    return out


def phase_kernels(ops, reg, device):
    import numpy as np
    import torch

    from repro_torch.kernels import gradpsi as kg
    from repro_torch.kernels import screen as ks

    tau_val = float(reg.tau)
    L_pad = ops.fp.L_pad
    tau_p = torch.full((L_pad,), tau_val, dtype=torch.float32, device=device)
    for storage in ("f32", "bf16"):
        rng = np.random.default_rng(0)
        for target in (0.0, 0.1, 0.6, 1.0):
            inp = kernel_inputs(rng, ops.pp.Cp, L_pad, tau_val, target, device)
            r = run_kernels(inp, ops, tau_p, reg.gamma, storage)
            C, leaves = r["C"], r["leaves"]
            at = f"at share {target} ({storage})"
            v_ref, f_ref = ks.screen_batched_ref(*screen_args(inp), tau=tau_p, tile_l=TILE_L,
                                                 tile_n=TILE_N)
            check(torch.equal(r["verdict"], v_ref), f"K1 verdicts differ from the plain "
                  f"version {at}")
            check(torch.equal(r["flags"], f_ref), f"K1 flags differ from the plain version {at}")
            gkw = dict(num_groups=L_pad, group_size=inp["g"], tau=tau_p, gamma=reg.gamma,
                       tile_l=TILE_L, tile_n=TILE_N)
            errs, rels = [], []
            for key, ref in (("k2", kg.gradpsi_batched_ref(inp["alpha"], inp["beta"], C,
                                                           r["flags"], **gkw)),
                             ("k5", kg.gradpsi_fact_batched_ref(inp["alpha"], inp["beta"],
                                                                *leaves, r["flags"], **gkw))):
                for name, got, want in zip(("rowsum", "colsum", "psi"), r[key], ref):
                    check(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
                          f"{key} {name} off its plain version {at}: max abs err "
                          f"{float((got - want).abs().max())}")
                    errs.append(float((got - want).abs().max()))
                    rels.append(float(((got - want).abs() / want.abs().clamp_min(1e-30)).max()))
                del ref
            live = int(torch.count_nonzero(r["flags"]))
            check(int(r["k3"][3]) == live and int(r["k6"][3]) == live,
                  f"K3/K6 num_active {int(r['k3'][3])}/{int(r['k6'][3])} != live tiles {live}")
            check(same(r["k2"], r["k3"][:3]), f"K3 not bitwise equal to K2 {at}")
            check(same(r["k6"][:3], r["k5"]), f"K6 not bitwise equal to K5 {at}")
            check(torch.equal(r["k7"][3], r["flags"]) and torch.equal(r["k8"][3], r["flags"]),
                  f"K7/K8 flags differ from K1's {at}")
            check(same(r["k7"][:3], r["k2"]), f"K7 not bitwise equal to K2 on K1's flags {at}")
            check(same(r["k8"][:3], r["k5"]), f"K8 not bitwise equal to K5 on K1's flags {at}")
            if storage == "f32":          # the dense cost is the factorized one, materialized
                check(same(r["k5"], r["k2"]), f"K5 not bitwise equal to K2 on the "
                      f"materialized cost {at}")
                check(same(r["k8"], r["k7"]), f"K8 not bitwise equal to K7 {at}")
            # K4 does not depend on the flags: its plain versions once per share
            k4_plain = ks.snapshot_norms_fact_ref(inp["alpha"], inp["beta"], *leaves, ops.mask,
                                                  num_groups=L_pad, group_size=inp["g"])
            check(same(r["k4"], k4_plain), f"K4 differs from its plain version {at}")
            k4d_plain = k4_plain if storage == "f32" else ks.snapshot_norms_dense_ref(
                inp["alpha"], inp["beta"], C, ops.mask, num_groups=L_pad, group_size=inp["g"])
            check(same(r["k4d"], k4d_plain), f"K4's body on the dense cost differs from its "
                  f"plain version {at}")
            ran = check_loaders(at, C, inp["alpha"], inp["beta"], r["flags"], r["sched"],
                                r["nact"], screen_args(inp), gkw)
            check(ran == {K2: STAGED, K3: DIRECT, K7: STAGED}, f"K2/K7 did not run the staged "
                  f"loader, or K3 not the direct loads, at the paper's tile {at}: {ran}")
            again = run_kernels(inp, ops, tau_p, reg.gamma, storage)
            check(torch.equal(r["flags"], again["flags"]), "K1 not deterministic")
            for key in ("k2", "k3", "k5", "k6", "k7", "k8", "k4", "k4d"):
                check(same(r[key], again[key]), f"{key} not deterministic ({storage})")
            share = live / r["flags"].numel()
            print(f"kernels {storage} @ live share {share:.4f} (target {target}): K1 == plain "
                  f"(verdicts, flags); K2, K5 max abs err {max(errs):.3e}, max rel err "
                  f"{max(rels):.3e} (rtol 1e-5, atol 1e-6); K3 == K2, K6 == K5, K7 == K2 and "
                  f"K8 == K5 on K1's flags (K7/K8 flags == K1's) bitwise"
                  f"{', K5 == K2, K8 == K7 bitwise' if storage == 'f32' else ''}, "
                  f"num_active={live}; K4 (factorized and dense loaders) == plain bitwise; "
                  f"loaders run (profiler): {', '.join(f'{k} {v}' for k, v in ran.items())}; "
                  f"rerun bitwise equal", flush=True)
            del r, again, inp, k4_plain, k4d_plain, C, leaves


FUSED_RERUNS = 20            # back-to-back K7 / K8 runs held bitwise equal


def fused_patterns(B, Lt, Nt):
    """Live-tile patterns that stress the fused kernels' batches: every tile of one
    tile row (the middle one), and the last tile alone."""
    import numpy as np

    row = np.zeros((B, Lt, Nt), bool)
    row[:, Lt // 2] = True
    last = np.zeros((B, Lt, Nt), bool)
    last[-1, -1, -1] = True
    return {"one tile row": row, "last tile only": last}


def phase_fused_stress(ops, reg, device):
    """K7 / K8 where a batch holds many live tiles or the launch's last tile is the only
    live one, f32 and bf16: flags == K1's, sums bitwise K2's / K5's on them, and
    FUSED_RERUNS runs back to back (no synchronize between) bitwise equal, at those
    patterns and at a live share of 0.1."""
    import numpy as np
    import torch

    from repro_torch.kernels import gradpsi as kg
    from repro_torch.kernels import screen as ks

    tau_val = float(reg.tau)
    L_pad = ops.fp.L_pad
    tau_p = torch.full((L_pad,), tau_val, dtype=torch.float32, device=device)
    Lt, Nt = L_pad // TILE_L, ops.fp.n_pad // TILE_N
    pats = dict(fused_patterns(1, Lt, Nt))
    pats["share 0.1"] = None
    for storage in ("f32", "bf16"):
        C, leaves = ops.cost_forms(storage)
        rng = np.random.default_rng(2)
        for name, live_tiles in pats.items():
            inp = kernel_inputs(rng, ops.pp.Cp, L_pad, tau_val, 0.1, device, live_tiles)
            sargs = screen_args(inp)
            kw = dict(num_groups=L_pad, group_size=inp["g"], tau=tau_p, gamma=reg.gamma,
                      tile_l=TILE_L, tile_n=TILE_N)
            a, b = inp["alpha"], inp["beta"]
            _, f1 = ks.screen_batched(*sargs, tau=tau_p, tile_l=TILE_L, tile_n=TILE_N,
                                      emit_verdict=False)
            if live_tiles is not None:
                check(torch.equal(f1.cpu(), torch.from_numpy(live_tiles.astype(np.int32))),
                      f"the pattern '{name}' did not give its flags")
            k2 = kg.gradpsi_batched(a, b, C, f1, **kw)
            k5 = kg.gradpsi_fact_batched(a, b, *leaves, f1, **kw)
            k7 = [kg.gradpsi_fused_batched(a, b, C, *sargs, **kw) for _ in range(FUSED_RERUNS)]
            k8 = [kg.gradpsi_fused_fact_batched(a, b, *leaves, *sargs, **kw)
                  for _ in range(FUSED_RERUNS)]
            at = f"({name}, {storage})"
            check(torch.equal(k7[0][3], f1) and torch.equal(k8[0][3], f1),
                  f"K7/K8 flags differ from K1's {at}")
            check(same(k7[0][:3], k2), f"K7 not bitwise K2 on K1's flags {at}")
            check(same(k8[0][:3], k5), f"K8 not bitwise K5 on K1's flags {at}")
            check(all(same(r, k7[0]) for r in k7) and all(same(r, k8[0]) for r in k8),
                  f"K7/K8 not bitwise equal across {FUSED_RERUNS} runs {at}")
            print(f"fused stress {at}: {int(f1.sum())} of {f1.numel()} tiles live; K7/K8 flags "
                  f"== K1's, sums bitwise K2's / K5's, {FUSED_RERUNS} back-to-back runs each "
                  f"bitwise equal", flush=True)
            del k7, k8, k2, k5, inp, sargs


def kernel_name(key: str) -> str:
    """A profiler record's kernel name cut at the template's '<'."""
    name = key.replace("(anonymous namespace)::", "").split("<")[0].split("(")[0]
    return name.replace("void ", "").strip()


SPLIT_CALLS = 20


def device_split(fn, calls: int = SPLIT_CALLS, rows=None):
    """{kernel name: device us a call} of ``fn`` over ``calls`` calls (torch.profiler,
    the device's own records), names cut at the template's '<'.  The profiler
    drops a record now and then, so each kernel's time is the mean of its
    records times their nearest whole number a call (0 for a kernel seen in
    fewer than half the calls).  ``rows``, a list, receives the records."""
    fn()
    sync()
    _, _, _, _, recs = profile_device(lambda: [fn() for _ in range(calls)])
    if rows is not None:
        rows.extend(recs)
    out = {}
    for key, us, n in recs:
        name = kernel_name(key)
        out[name] = out.get(name, 0.0) + us / max(n, 1) * round(n / calls)
    return out


def fused_beside_pairs(label, calls):
    """Print K7 / K8 device time beside K1 + K2 / K1 + K5 (each pair's sum) for the
    callables in ``calls`` ({K1, K2, K5, K7, K8: fn}); returns {name: device us}."""
    dev = {k: sum(device_split(f).values()) for k, f in calls.items()}
    print(f"fused vs two launches {label} (device us a call, torch.profiler, each call's "
          f"launches summed): K7 {dev[K7]:.2f} vs K1 + K2 {dev[K1] + dev[K2]:.2f} "
          f"({dev[K1]:.2f} + {dev[K2]:.2f}); K8 {dev[K8]:.2f} vs K1 + K5 "
          f"{dev[K1] + dev[K5]:.2f} ({dev[K1]:.2f} + {dev[K5]:.2f})", flush=True)
    return dev


def phase_kernels_wide_d(device):
    """K4-K8 at d = 64 (two 32-column chunks of the chunked loader) on a narrower
    problem, f32 and bf16 storage."""
    import numpy as np
    import torch

    from repro_torch.kernels import gradpsi as kg
    from repro_torch.kernels import screen as ks

    rng = np.random.default_rng(3)
    B, L_pad, g, n_pad, d = 2, 64, 16, 1024, 64
    m_pad = L_pad * g
    x = (rng.uniform(-0.5, 0.5, (B, m_pad, d)) / np.sqrt(d)).astype(np.float32)
    y = (rng.uniform(-0.5, 0.5, (B, n_pad, d)) / np.sqrt(d)).astype(np.float32)
    x_sq = np.sum(x * x, axis=-1, dtype=np.float32)
    y_sq = np.sum(y * y, axis=-1, dtype=np.float32)
    mask = np.ones(m_pad, np.int8)
    mask[3::7] = 0
    x[:, mask == 0], x_sq[:, mask == 0] = 0.0, 1e9
    alpha = rng.uniform(0.0, 0.5, (B, m_pad)).astype(np.float32)
    beta = rng.uniform(0.0, 0.5, (B, n_pad)).astype(np.float32)
    flags = (rng.random((B, L_pad // TILE_L, n_pad // TILE_N)) < 0.5).astype(np.int32)
    tau = np.linspace(0.0, 0.4, L_pad).astype(np.float32)
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(device)
    a, b, fl, tp, mk = (t(v) for v in (alpha, beta, flags, tau, mask))
    leaves32 = tuple(t(v) for v in (x, x_sq, y, y_sq))
    kw = dict(num_groups=L_pad, group_size=g, tau=tp, gamma=0.25, tile_l=TILE_L, tile_n=TILE_N)
    check(kg.d_chunk(TILE_L, g, TILE_N, d) == 32 and kg.fact_loader_dc(TILE_L, g, TILE_N, d) == 32,
          "d = 64 should run the chunked loader, two 32-column chunks")
    # K8: its own flags (K1's on random screening operands), K5 on them
    inp = kernel_inputs(rng, kg.factorized_cost_tile(*leaves32), L_pad, 0.2, 0.5, device)
    sargs = screen_args(inp)
    _, f1 = ks.screen_batched(*sargs, tau=tp, tile_l=TILE_L, tile_n=TILE_N, emit_verdict=False)
    skw = dict(num_groups=L_pad, group_size=g, tile_l=TILE_L, tile_n=TILE_N)
    for storage in ("f32", "bf16"):
        leaves = leaves32 if storage == "f32" else tuple(v.bfloat16() for v in leaves32)
        xx, xs, yy, ys = leaves
        check(kg.fact_loader(TILE_L, g, TILE_N, d, xx.element_size()) == (32, TILE_L),
              f"d = 64 ({storage}) should stage the whole tile in 32-column chunks")
        k5 = kg.gradpsi_fact_batched(a, b, *leaves, fl, **kw)
        ref = kg.gradpsi_fact_batched_ref(a, b, *leaves, fl, **kw)
        err = max(float((p - q).abs().max()) for p, q in zip(k5, ref))
        check(all(torch.allclose(p, q, rtol=1e-5, atol=1e-6) for p, q in zip(k5, ref)),
              f"K5 at d = 64 ({storage}) off its plain version: max abs err {err:.3e}")
        sched, nact = kg.build_batch_tile_schedule(fl)
        k6 = kg.gradpsi_fact_compact_batched(a, b, *leaves, sched, nact, **kw)
        C = kg.factorized_cost_tile(*leaves)          # the f32 cost of the stored leaves
        k2 = kg.gradpsi_batched(a, b, C, fl, **kw)
        check(same(k5, k2) and same(k6[:3], k5),
              f"K5/K6 at d = 64 ({storage}) not bitwise equal to K2")
        k8 = kg.gradpsi_fused_fact_batched(a, b, *leaves, *sargs, **kw)
        k5f = kg.gradpsi_fact_batched(a, b, *leaves, f1, **kw)
        k7 = kg.gradpsi_fused_batched(a, b, C, *sargs, **kw)
        check(torch.equal(k8[3], f1) and same(k8[:3], k5f) and torch.equal(k7[3], f1)
              and same(k7[:3], k5f),
              f"K8 (K7) at d = 64 ({storage}) not K1's flags and K5's sums bit for bit")
        k4 = ks.snapshot_norms_fact_batched(a, b, *leaves, mk, **skw)
        k4p = ks.snapshot_norms_fact_ref(a, b, *leaves, mk, num_groups=L_pad, group_size=g)
        check(same(k4, k4p), f"K4 at d = 64 ({storage}) differs from its plain version")
        print(f"kernels @ d = 64 ({storage}; B = 2, L_pad = 64, g = 16, n_pad = 1024, 2 chunks "
              f"of 32, the whole tile one block): K5 max abs err {err:.3e} (rtol 1e-5, atol "
              f"1e-6), K5 == K2 and K6 == K5 bitwise, K8 == K1's flags and K5's sums bitwise "
              f"(live share {int(f1.count_nonzero()) / f1.numel():.3f}), K7 == K8 on the "
              f"materialized cost, K4 == plain bitwise", flush=True)


def device_us_per_call(fn, calls: int = 50):
    """(device us, device launches) per call of ``fn``, from a torch.profiler trace.

    The profiler drops a kernel record now and then, so the time is the mean
    of the launches recorded times their whole number per call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        sync()
    rows = [(e.key, device_us(e), e.count) for e in prof.key_averages()]
    kernels = [r for r in rows if r[1] > 0 and not r[0].startswith(("aten::", "cuda"))]
    n = sum(r[2] for r in kernels)
    if n == 0:
        return 0.0, 0.0
    return sum(r[1] for r in kernels) / n * max(round(n / calls), 1), n / calls


def phase_row_sum(device):
    """The batch-invariant row sum and row inner product against their plain versions,
    against each other (row_dot(a, b) bitwise row_sum(a * b)) and across batch
    sizes, over row lengths 1 to 33280; then both timed on one L-BFGS vector of
    the main path (D = 33280) beside torch.sum / torch.linalg.vecdot.  Returns
    their kernel-table rows (launches filled in after phase 4)."""
    import numpy as np
    import torch

    from repro_torch.kernels import reduce as kr

    rng = np.random.default_rng(4)
    worst = {ROW_SUM: 0.0, ROW_DOT: 0.0}
    for D in sorted(set(ROW_D) | {16, 300}):
        x = torch.from_numpy(rng.normal(size=(3, D)).astype(np.float32)).to(device)
        y = torch.from_numpy(rng.normal(size=(3, D)).astype(np.float32)).to(device)
        got = {ROW_SUM: kr.row_sum(x), ROW_DOT: kr.row_dot(x, y)}
        plain = {ROW_SUM: kr.row_sum_ref(x), ROW_DOT: kr.row_dot_ref(x, y)}
        for name in (ROW_SUM, ROW_DOT):
            check(torch.allclose(got[name], plain[name], rtol=1e-5, atol=1e-4),
                  f"{name} off its plain version at D = {D}")
            worst[name] = max(worst[name], float((got[name] - plain[name]).abs().max()))
        check(torch.equal(got[ROW_DOT], kr.row_sum(x * y)),
              f"row_dot(a, b) not bitwise row_sum(a * b) at D = {D}")
        for i in range(3):
            check(torch.equal(kr.row_sum(x[i:i + 1])[0], got[ROW_SUM][i])
                  and torch.equal(kr.row_dot(x[i:i + 1], y[i:i + 1])[0], got[ROW_DOT][i]),
                  f"row_sum / row_dot not batch-invariant at D = {D}")
    print(f"row_sum, row_dot: within rtol 1e-5 / atol 1e-4 of their plain versions (max abs "
          f"err {worst[ROW_SUM]:.3e}, {worst[ROW_DOT]:.3e}) for D in {ROW_D} and 16, 300; "
          f"row_dot(a, b) == row_sum(a * b) bitwise; each row's bits the same alone and in a "
          f"batch of 3", flush=True)

    D = ROW_D_MAIN
    x = torch.from_numpy(rng.normal(size=(1, D)).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.normal(size=(1, D)).astype(np.float32)).to(device)
    cases = {
        ROW_SUM: (lambda: kr.row_sum(x), lambda: kr.row_sum_ref(x),
                  lambda: torch.sum(x, dim=-1), 4 * D + 4, D - 1,
                  "within rtol 1e-5 / atol 1e-4 of torch.sum, D in 1..33280, batch-invariant"),
        ROW_DOT: (lambda: kr.row_dot(x, y), lambda: kr.row_dot_ref(x, y),
                  lambda: torch.linalg.vecdot(x, y), 8 * D + 4, 2 * D - 1,
                  "bitwise row_sum(a * b), within rtol 1e-5 / atol 1e-4 of its plain version"),
    }
    rows = []
    for name, (fn, plain, lib, nbytes, nops, what) in cases.items():
        err = float((fn() - plain()).abs().max())
        ms, plain_ms, lib_ms = median_ms(fn, 50), median_ms(plain, 50), median_ms(lib, 50)
        dev_us, dev_launches = device_us_per_call(fn)
        lib_us, lib_launches = device_us_per_call(lib)
        bms, by = bound(nbytes, nops)
        source, replaces = SOURCES[name]
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": 0, "launches_path": REDUCE_PATH[name], "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                     "library_ms": lib_ms, "device_us_per_call": dev_us,
                     "device_launches_per_call": dev_launches, "library_device_us": lib_us,
                     "check": what, "result": "pass"})
        print(f"time {name} at (1, {D}): {ms:.4f} ms (CUDA events, wrapper included), device "
              f"{dev_us:.2f} us in {dev_launches:.0f} launch(es) a call (profiler); bound "
              f"{bms * 1e3:.3f} us by {by}; plain {plain_ms:.4f} ms; library {lib_ms:.4f} ms, "
              f"device {lib_us:.2f} us in {lib_launches:.0f} launch(es)", flush=True)
    return rows


def phase_tile_widths(device):
    """K2/K3/K5-K8 at tile widths that are not whole warps (4, 20, 40), at 128, and
    wider than 128 (the kernels' wide builds: 1024 at d = 2, 256 at d = 64, where
    K4 takes its wide build too).

    The stochastic solver runs the kernels with tile_n = its column block,
    so a CTA rounds tile_n up to whole warps and the extra lanes add zeros.
    B = 2, L_pad = 64, g = 16, tile_l = 8, n_pad about 1000.
    """
    import numpy as np
    import torch

    from repro_torch.kernels import gradpsi as kg
    from repro_torch.kernels import screen as ks

    for tile_n, d in ((4, 2), (20, 2), (40, 2), (128, 2), (1024, 2), (256, 64)):
        rng = np.random.default_rng(tile_n)
        B, L_pad, g, tile_l = 2, 64, 16, 8
        Nt = -(-1000 // tile_n)
        n_pad, m_pad = Nt * tile_n, L_pad * g
        x = (rng.normal(size=(B, m_pad, d)) * 0.3 / np.sqrt(d / 2)).astype(np.float32)
        y = (rng.normal(size=(B, n_pad, d)) * 0.3 / np.sqrt(d / 2)).astype(np.float32)
        t = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        leaves = tuple(t(v) for v in (x, (x * x).sum(-1), y, (y * y).sum(-1)))
        C = kg.factorized_cost_tile(*leaves)
        a = t(rng.uniform(0.1, 0.6, (B, m_pad)).astype(np.float32))
        b = t(rng.uniform(0.1, 0.6, (B, n_pad)).astype(np.float32))
        flags = t((rng.random((B, L_pad // tile_l, Nt)) < 0.5).astype(np.int32))
        tau = torch.linspace(0.05, 0.5, L_pad, device=device)
        kw = dict(num_groups=L_pad, group_size=g, tau=tau, gamma=0.25, tile_l=tile_l,
                  tile_n=tile_n)
        sched, nact = kg.build_batch_tile_schedule(flags)
        k2 = kg.gradpsi_batched(a, b, C, flags, **kw)
        k5 = kg.gradpsi_fact_batched(a, b, *leaves, flags, **kw)
        err = 0.0
        for got, want in ((k2, kg.gradpsi_batched_ref(a, b, C, flags, **kw)),
                          (k5, kg.gradpsi_fact_batched_ref(a, b, *leaves, flags, **kw))):
            check(all(torch.allclose(p, q, rtol=1e-5, atol=1e-6) for p, q in zip(got, want)),
                  f"K2/K5 at tile_n = {tile_n} off their plain versions")
            err = max(err, max_errs(got, want)[0])
        check(same(kg.gradpsi_compact_batched(a, b, C, sched, nact, **kw)[:3], k2)
              and same(kg.gradpsi_fact_compact_batched(a, b, *leaves, sched, nact,
                                                       **kw)[:3], k5) and same(k5, k2),
              f"K3/K6/K5 not bitwise K2 at tile_n = {tile_n}")
        sargs = _narrow_screen_args(rng, B, L_pad, n_pad, device)
        _, f1 = ks.screen_batched(*sargs, tau=tau, tile_l=tile_l, tile_n=tile_n,
                                  emit_verdict=False)
        k7 = kg.gradpsi_fused_batched(a, b, C, *sargs, **kw)
        k8 = kg.gradpsi_fused_fact_batched(a, b, *leaves, *sargs, **kw)
        check(torch.equal(k7[3], f1) and torch.equal(k8[3], f1)
              and same(k7[:3], kg.gradpsi_batched(a, b, C, f1, **kw))
              and same(k8[:3], kg.gradpsi_fact_batched(a, b, *leaves, f1, **kw)),
              f"K7/K8 at tile_n = {tile_n} not K1's flags and K2's / K5's sums")
        mask = torch.ones(L_pad * g, dtype=torch.int8, device=device)
        skw = dict(num_groups=L_pad, group_size=g)
        check(same(ks.snapshot_norms_fact_batched(a, b, *leaves, mask, tile_l=tile_l,
                                                  tile_n=tile_n, **skw),
                   ks.snapshot_norms_fact_ref(a, b, *leaves, mask, **skw)),
              f"K4 at tile_n = {tile_n} differs from its plain version")
        # K2/K3/K7 on the bf16 cost too, and the dense loader each ran
        loaders = []
        for storage, Cs in (("f32", C), ("bf16", C.bfloat16())):
            at = f"at tile_n = {tile_n} ({storage})"
            k2s = kg.gradpsi_batched(a, b, Cs, flags, **kw)
            want = kg.gradpsi_batched_ref(a, b, Cs, flags, **kw)
            check(all(torch.allclose(p, q, rtol=1e-5, atol=1e-6) for p, q in zip(k2s, want)),
                  f"K2 off its plain version {at}")
            check(same(kg.gradpsi_compact_batched(a, b, Cs, sched, nact, **kw)[:3], k2s)
                  and same(kg.gradpsi_fused_batched(a, b, Cs, *sargs, **kw)[:3],
                           kg.gradpsi_batched(a, b, Cs, f1, **kw)),
                  f"K3 not bitwise K2, or K7 not K2's sums on K1's flags, {at}")
            ran = check_loaders(at, Cs, a, b, flags, sched, nact, sargs, kw)
            staged = STAGED if tile_n % 32 == 0 else DIRECT
            check(ran == {K2: staged, K3: DIRECT, K7: staged}, f"K2/K7 did not run the "
                  f"{staged} loader, or K3 not the direct loads, {at}: {ran}")
            loaders.append(f"{storage} " + "/".join(ran[k] for k in (K2, K3, K7)))
        print(f"tile width {tile_n} (d = {d}, B = 2, L_pad = 64, g = 16, n_pad = {n_pad}, "
              f"{-(-tile_n // 32) * 32} threads per CTA): K2, K5 within rtol 1e-5 / atol 1e-6 "
              f"of plain (max abs err {err:.3e}); K3 == K2, K5 == K2, K6 == K5, K7/K8 == K1's "
              f"flags (live share {int(f1.count_nonzero()) / f1.numel():.3f}) and K2's / K5's "
              f"sums, bitwise; K4 == plain; K2/K3/K7 ran (profiler) {', '.join(loaders)}; "
              f"bf16 K2 within rtol 1e-5 of plain, K3 == K2 and K7 == K2 on K1's flags",
              flush=True)


def _narrow_screen_args(rng, B, L_pad, n_pad, device):
    """K1's operands with about half the entries above tau = 0.05-0.5 (narrow tiles)."""
    import numpy as np
    import torch

    f32 = np.float32
    shape = (B, L_pad, n_pad)
    live = rng.random(shape) < 0.05
    z = np.where(live, rng.uniform(0.0, 1.2, shape), rng.uniform(0.0, 0.04, shape)).astype(f32)
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return (t(z), t((z + rng.uniform(0, 0.5, shape)).astype(f32)),
            t(rng.uniform(0, 0.2, shape).astype(f32)), t((rng.random(shape) < 0.01)
                                                         .astype(np.int8)),
            *(t(rng.uniform(0, 0.01, (B, L_pad)).astype(f32)) for _ in range(3)),
            t(rng.uniform(-0.01, 0.01, (B, n_pad)).astype(f32)),
            t(np.full((B, L_pad), 4.0, f32)))


# -- phase 4 -------------------------------------------------------------------

# per route: (grid kernel, compact kernel, snapshot kernel, fused kernel)
ROUTE_K = {"factorized": (K5, K6, K4, K8), "dense": (K2, K3, K4D, K7),
           "materialized": (K2, K3, K4D, K7)}


def path_parts(name: str):
    """'route/impl', 'route/fused-impl', 'route/bf16-grad_impl[-impl]' (impl 'auto' when
    left out) -> (route, grad_impl, impl, precision); the plain backends -> (None, name,
    None, 'f32')."""
    route, sep, rest = name.partition("/")
    if not sep:
        return None, name, None, "f32"
    if rest.startswith("bf16-"):
        grad_impl, _, impl = rest[5:].partition("-")
        return route, grad_impl, impl or "auto", "bf16"
    if rest.startswith("fused-"):
        return route, "fused", rest[6:], "f32"
    return route, "pallas", rest, "f32"


def check_path_launches(name: str, counts: dict, sol) -> None:
    """Each path launched what it should.

    pallas: K1 once per evaluation and one gradient kernel per evaluation
    (grid: the grid kernel only, compact: the compact one only, auto: both).
    fused: the fused kernel or K1 + the compact kernel per evaluation (grid:
    the fused kernel only, no K1; compact: K1 and the compact kernel only;
    auto: either, decided per round).  Every kernel path: the route's
    snapshot kernel once per snapshot (one at the start, one per round) and
    no kernel of the other route.  The plain backends launch none of them.
    """
    n_evals, snaps = sol.n_evals, 1 + sol.rounds
    route, grad_impl, impl, _ = path_parts(name)
    c = {k: counts.get(k, 0) for k in (K1, K2, K3, K4, K4D, K5, K6, K7, K8)}
    if route is None:
        ok = not any(c.values())
    else:
        grid_k, compact_k, snap_k, fused_k = ROUTE_K[route]
        mine = (K1, grid_k, compact_k, snap_k, fused_k)
        g_, c_, f_ = c[grid_k], c[compact_k], c[fused_k]
        ok = c[snap_k] == snaps and not any(c[k] for k in c if k not in mine)
        if grad_impl == "pallas":
            ok = ok and f_ == 0 and c[K1] == n_evals and {
                "grid": g_ == n_evals and c_ == 0, "compact": c_ == n_evals and g_ == 0,
                "auto": g_ + c_ == n_evals and g_ > 0 and c_ > 0}[impl]
        else:
            ok = ok and g_ == 0 and c[K1] == c_ and f_ + c_ == n_evals and {
                "grid": c_ == 0, "compact": f_ == 0, "auto": True}[impl]
    check(ok, f"{name}: launches {counts} do not fit n_evals {n_evals}, snapshots {snaps}")


def solution_bits(sol):
    return (sol.value, sol.rounds, sol.iterations, sol.n_evals, sol.stats)


def solution_prints(sol) -> list:
    """``solution_bits`` and the exact prints of the duals and the plan, JSON-able."""
    return [list(solution_bits(sol)), fingerprint(sol.alpha), fingerprint(sol.beta),
            fingerprint(sol.plan)]


def fingerprint(t) -> int:
    """An exact integer function of a float32 tensor's bits: equal tensors, equal prints."""
    import torch

    bits = t.contiguous().view(torch.int32).reshape(-1).to(torch.int64)
    w = torch.arange(bits.numel(), device=t.device, dtype=torch.int64) % 65521 + 1
    return int(torch.sum(bits * w)) ^ (int(torch.sum(bits)) << 1)


def phase_end_to_end(problem, mat_problem, device):
    """Solve through the facade on every path; returns (solutions, launches per path)."""
    import numpy as np
    import torch

    import repro_torch.ot as ot
    from repro_torch.kernels import _build as kbuild

    P = ot.ExecutionPlan
    runs = []
    for route, prob, geo in (("factorized", problem, {}),
                             ("dense", problem, {"geometry": "dense"}),
                             ("materialized", mat_problem, {"geometry": "dense"})):
        for impl in ("grid", "compact", "auto"):
            kw = {"grad_impl": "pallas", **geo}
            if impl != "auto":                         # 'auto' is the default plan
                kw["pallas_impl"] = impl
            runs.append((f"{route}/{impl}", prob, kw))
    for route, geo in (("factorized", {}), ("dense", {"geometry": "dense"})):
        for impl in ("grid", "compact", "auto"):
            kw = {"grad_impl": "fused", **geo}
            if impl != "auto":
                kw["pallas_impl"] = impl
            runs.append((f"{route}/fused-{impl}", problem, kw))
        for gi in ("pallas", "fused"):
            for impl in ("grid", "compact", "auto"):
                kw = {"grad_impl": gi, "precision": "bf16", **geo}
                if impl != "auto":
                    kw["pallas_impl"] = impl
                if route == "factorized":
                    kw["max_rounds"] = BF16_FACT_ROUNDS
                runs.append((f"{route}/bf16-{gi}{'' if impl == 'auto' else '-' + impl}",
                             problem, kw))
    runs += [("screened", problem, {"grad_impl": "screened", "geometry": "dense"}),
             ("dense", problem, {"grad_impl": "dense", "geometry": "dense"})]

    for grad_impl in ("pallas", "fused"):
        ex = ot.compile(problem, P(grad_impl=grad_impl), device=device)
        check(ex._route(problem) == "factorized", f"ExecutionPlan(grad_impl={grad_impl!r}) "
              f"resolves to {ex._route(problem)!r}, not 'factorized'")
        print(f"plan ExecutionPlan(grad_impl={grad_impl!r}): " + "; ".join(
            ln for ln in ex.describe().splitlines() if ln.startswith(("geometry:", "backend:"))),
              flush=True)
    main_ex = ot.compile(problem, P(grad_impl="pallas"), device=device)

    # warm-up: one short solve per backend family (allocator, library load)
    for name, prob, kw in runs:
        if name.endswith("auto") or name.startswith("materialized") or "bf16" in name:
            continue
        ot.compile(prob, P(**kw, max_iters=2, max_rounds=1), device=device).solve()
    sync()

    # host lowering per route, timed on its own (each solve below repeats it)
    lowering = {}
    t0 = time.perf_counter()
    main_ex.geometry(problem)
    sync()
    lowering["factorized"] = time.perf_counter() - t0
    for route, prob in (("dense", problem), ("materialized", mat_problem)):
        t0 = time.perf_counter()
        pa = prob.padded()
        torch.from_numpy(pa.C).to(device)
        sync()
        lowering[route] = time.perf_counter() - t0
    lowering["screened"] = lowering["dense"]
    print("host lowering before the solve: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in lowering.items() if k != "screened") +
          " (factorized: samples, squared norms and the 1 / max C pass on the card; dense: "
          "Problem.padded in numpy and the copy of the padded cost)", flush=True)

    sols, launches, plans, prints = {}, {}, {}, {}
    for name, prob, kw in runs:
        ex = ot.compile(prob, P(**kw), device=device)
        route = name.partition("/")[0]
        if route == "factorized":
            check(ex._route(prob) == "factorized", f"{name} did not take the factorized route")
        torch.cuda.reset_peak_memory_stats()
        sync()
        kbuild.reset_launch_counts()
        t0 = time.perf_counter()
        sol = ex.solve()
        sync()
        wall = time.perf_counter() - t0
        launches[name] = kbuild.launch_counts()
        check(bool(torch.isfinite(sol.plan).all()), f"{name} plan not finite")
        check(tuple(sol.plan.shape) == (problem.num_source, problem.num_target),
              f"{name} plan shape {tuple(sol.plan.shape)}")
        check(bool(torch.isfinite(sol.alpha).all() and torch.isfinite(sol.beta).all()),
              f"{name} duals not finite")
        share = sol.result.live_tile_share
        print(f"e2e {name}: wall {wall:.3f} s (lowering {lowering[route]:.3f} s), value "
              f"{sol.value!r}, rounds {sol.rounds}, iterations {sol.iterations}, n_evals "
              f"{sol.n_evals}, converged {sol.converged}, stats {sol.stats}, group_sparsity "
              f"{sol.group_sparsity!r}, mean live-tile share "
              f"{'n/a' if share is None else f'{share:.6f}'}, max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, launches "
              f"{ {k: v for k, v in launches[name].items() if k not in REDUCE_PATH} }",
              flush=True)
        check_path_launches(name, launches[name], sol)
        prints[name] = fingerprint(sol.plan)
        if name == MAIN_PATH:
            main_duals = (fingerprint(sol.alpha), fingerprint(sol.beta))
        _, grad_impl, impl, precision = path_parts(name)
        if route in ("factorized", "materialized") and (grad_impl, precision) == ("pallas",
                                                                                  "f32"):
            if route == "factorized":
                plans[impl] = sol.plan
            else:
                f = sols[f"factorized/{impl}"]
                check(solution_bits(sol) == solution_bits(f) and torch.equal(sol.alpha, f.alpha)
                      and torch.equal(sol.beta, f.beta) and torch.equal(sol.plan, plans[impl]),
                      f"factorized/{impl} not bitwise equal to materialized/{impl}")
                del plans[impl]
        sol.plan = sol.plan_padded = None        # keep only duals and scalars
        sols[name] = sol

    main_prints = (sols[MAIN_PATH].value, prints[MAIN_PATH], main_duals)
    print(f"main path {MAIN_PATH}: value {main_prints[0]!r}, plan fingerprint {main_prints[1]}, "
          f"duals fingerprints {main_prints[2]} (the parent kernels': {MAIN_PATH_PRINTS})",
          flush=True)
    check(main_prints == MAIN_PATH_PRINTS,
          "the main path's solve does not keep the fingerprint it had before the tile-width "
          "change")
    ref = sols["dense"].value
    for name, sol in sols.items():
        rel = abs(sol.value - ref) / abs(ref)
        if path_parts(name)[3] == "bf16":
            print(f"e2e {name}: bf16 value {sol.value!r} vs f32 dense {ref!r}: rel gap "
                  f"{rel:.3e} (recorded, not gated)", flush=True)
            continue
        check(rel <= 2e-5, f"{name} objective {sol.value} vs dense {ref}: rel {rel:.3e}")

    def bitwise(x, y):
        return (torch.equal(sols[x].alpha, sols[y].alpha) and torch.equal(sols[x].beta,
                                                                          sols[y].beta)
                and solution_bits(sols[x]) == solution_bits(sols[y]))

    for route in ("factorized", "dense", "materialized"):
        for impl in ("compact", "auto"):
            check(bitwise(f"{route}/{impl}", f"{route}/grid"),
                  f"{route}/{impl} not bitwise equal to {route}/grid")
    for route in ("factorized", "dense"):
        pairs = [(f"{route}/fused-{impl}", f"{route}/{impl}") for impl in ("grid", "compact",
                                                                           "auto")]
        pairs += [(f"{route}/bf16-fused{sfx}", f"{route}/bf16-pallas{sfx}")
                  for sfx in ("-grid", "-compact", "")]
        for x, y in pairs:
            check(bitwise(x, y) and prints[x] == prints[y],
                  f"{x} not bitwise equal to {y} (duals, value, rounds, stats, plan)")
    rel_fd = abs(sols[MAIN_PATH].value - sols[DENSE_PATH].value) / abs(sols[DENSE_PATH].value)
    print(f"e2e checks: factorized == dense on problem.materialized() bit for bit (duals, "
          f"value, plan, rounds, iterations, evaluations, stats) for grid, compact and auto; "
          f"grid == compact == auto bitwise per route; fused == pallas bitwise per route, impl "
          f"and precision (plans by fingerprint); all f32 objectives within rtol 2e-5 of "
          f"dense (factorized vs the numpy-lowered dense route: rel {rel_fd:.3e}); per path, "
          f"the launches of its oracle per evaluation and the route's snapshot kernel per "
          f"snapshot, the plain backends none", flush=True)
    return sols, launches


def device_us(evt) -> float:
    """Self device time of a profiler event, under either torch attribute name."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def solver_call(ops, problem, device, plan, dense=False):
    """The arguments of a path's solver call: (cost, a, b, spec, opts).

    The cost is the main problem's FactorizedCost, or with ``dense`` its
    device-materialized (m_pad, n) cost.
    """
    import repro_torch.ot as ot
    from repro_torch.kernels.ops import FactorizedCost

    ex = ot.compile(problem, plan, device=device)
    a, b, _ = ex._marginals(problem)
    if dense:
        cost = ops.pp.Cp[0, : ops.spec.m_pad, : problem.num_target]
    else:
        cost = FactorizedCost(*(t[0] for t in ops.fc.leaves()))
    return cost, a, b, ops.spec, ex.plan.solve_options()


def peak_memory(ops, problem, reg, device, plan, dense=False):
    """(peak device bytes of one solver call, bytes held before it, result)."""
    import torch

    from repro_torch.core import solver as slv

    cost, a, b, spec, opts = solver_call(ops, problem, device, plan, dense)
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = slv.solve_dual(cost, a, b, spec, reg, opts, device)
    sync()
    return torch.cuda.max_memory_allocated(), base, res


def profile_solver_call(label, ops, problem, reg, device, plan):
    """Peak device memory and a torch.profiler trace of one factorized solver call
    (plan recovery excluded); returns (peak, launches per evaluation, summary):
    the summary holds wall and busy seconds, n_evals and the kernel rows
    (name, device us, launches)."""
    from repro_torch.core import solver as slv

    peak, base, res = peak_memory(ops, problem, reg, device, plan)
    dense_bytes = ops.spec.m_pad * problem.num_target * 4
    print(f"peak device memory of the {label} solver call: {peak} B "
          f"({peak / 2**20:.1f} MiB, of which {base} B were held before it) vs the dense cost "
          f"alone {dense_bytes} B; n_evals {res.n_evals}", flush=True)
    check(peak < dense_bytes, f"the {label} solver call peaked at {peak} B, not below the "
          f"{dense_bytes} B of the dense cost")

    cost, a, b, spec, opts = solver_call(ops, problem, device, plan)
    res, wall, busy, n_launch, kernels = profile_device(
        lambda: slv.solve_dual(cost, a, b, spec, reg, opts, device))
    port = sum(r[1] for r in kernels if any(k in r[0] for k in PORT_KERNELS)) / 1e6
    print(f"profile {label} solver call: wall {wall:.4f} s, rounds {res.rounds}, n_evals "
          f"{res.n_evals}, device busy {busy:.4f} s, idle share {1.0 - busy / wall:.4f}, port "
          f"kernels {port:.4f} s, PyTorch kernels {busy - port:.4f} s, {n_launch} device "
          f"launches ({n_launch / res.n_evals:.1f} per evaluation)", flush=True)
    for key, us, count in kernels[:14]:
        print(f"  {us / 1e3:10.3f} ms  x{count:<6d} {key[:100]}", flush=True)
    summary = dict(wall_s=wall, busy_s=busy, n_evals=res.n_evals, kernels=kernels)
    return peak, n_launch / res.n_evals, summary


def phase_memory_and_profile(ops, problem, reg, device):
    """The main path's and the fused/auto factorized solver calls: peak memory and profile;
    the dense route's fused/auto solver call in f32 and bf16: peak memory.  Returns the
    main path's (peak, launches per evaluation, summary) for phase 10."""
    import repro_torch.ot as ot

    P = ot.ExecutionPlan
    main_profile = profile_solver_call(MAIN_PATH, ops, problem, reg, device,
                                       P(grad_impl="pallas"))
    per_eval = main_profile[1]
    print(f"launches per evaluation on {MAIN_PATH}: {per_eval:.1f} (two per gradient call, the "
          f"kernel and the slot reduction, one per inner product; {LAUNCHES_PER_EVAL_BEFORE} "
          f"with a multiply and a row sum per inner product, PERF.md)", flush=True)
    check(per_eval < LAUNCHES_PER_EVAL_BEFORE,
          f"{MAIN_PATH}: {per_eval:.1f} device launches per evaluation, not below "
          f"{LAUNCHES_PER_EVAL_BEFORE}: an inner product takes more than one launch")
    profile_solver_call(FUSED_PATH, ops, problem, reg, device, P(grad_impl="fused"))
    profile_solver_call(FUSED_GRID_PATH, ops, problem, reg, device,
                        P(grad_impl="fused", pallas_impl="grid"))
    peaks = {}
    for precision in ("f32", "bf16"):
        peaks[precision] = peak_memory(ops, problem, reg, device,
                                       P(grad_impl="fused", precision=precision,
                                         geometry="dense"), dense=True)[:2]
    print("peak device memory of the dense/fused-auto solver call (materialized cost, "
          f"{ops.spec.m_pad * problem.num_target * 4} B, held before it): " + ", ".join(
              f"{p} {peak} B ({(peak - base) / 2**20:.1f} MiB above the {base} B held)"
              for p, (peak, base) in peaks.items()), flush=True)
    ops.drop_dense()
    return main_profile


# -- phase 5 -------------------------------------------------------------------

def max_errs(got, want):
    """(max abs err, max rel err) over a tuple of outputs against their plain versions."""
    abs_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    rel_err = max(float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
                  for a, b in zip(got, want))
    return abs_err, rel_err


U32 = 2.0 ** -24             # unit roundoff of float32


def gradient_f64_with_bound(alpha, beta, C, sched, num_active, *, num_groups, group_size,
                            tau, gamma, tile_l, tile_n, chunk=2048):
    """K2/K3's function on the live tiles in float64, and a bound on any f32 evaluation's error.

    Returns ``((rowsum, colsum, psi), (e_row, e_col, e_psi))`` in float64.
    The bound follows each float32 rounding (unit roundoff u) to first order
    through f = a + b - c, Z = ||[f]_+||, s = 1 - tau/Z, T = s [f]_+ / gamma,
    psi's closed form and the sums (at most (k - 1) u sum|x| for k nonzero
    terms, in any order).  It is what a check at a converged state needs:
    there most live groups sit just above their threshold, s = 1 - tau/Z
    cancels, and any float32 evaluation keeps only a few digits of T.
    """
    import torch

    u = U32
    B, n_pad = beta.shape
    L_pad, g = num_groups, group_size
    Lt, Nt = L_pad // tile_l, n_pad // tile_n
    na = int(num_active)
    bi, li, ji = (sched[r, :na].long() for r in range(3))
    tau_l = tau.to(torch.float64).reshape(Lt, tile_l)
    parts = {k: [] for k in ("row", "col", "psi", "e_row", "e_col", "e_psi",
                             "k_row", "k_col", "k_psi")}
    for lo in range(0, na, chunk):
        b_, l_, j_ = bi[lo:lo + chunk], li[lo:lo + chunk], ji[lo:lo + chunk]
        a = alpha.reshape(B, Lt, tile_l, g)[b_, l_].double()[..., None]       # (S, TL, g, 1)
        bj = beta.reshape(B, Nt, tile_n)[b_, j_].double()[:, None, None, :]   # (S, 1, 1, TN)
        c = C.reshape(B, Lt, tile_l, g, Nt, tile_n)[b_, l_, :, :, j_].double()
        t = tau_l[l_][:, :, None, None]                                      # (S, TL, 1, 1)
        f = (a + bj) - c
        fp = f.clamp_min(0.0)
        e_f = u * (a.abs() + bj.abs() + f.abs())
        e_fp = torch.where(f > -e_f, e_f, 0.0)
        z = (fp * fp).sum(dim=2, keepdim=True).sqrt()                       # (S, TL, 1, TN)
        zc = z.clamp_min(1e-300)
        e_z = (fp * e_fp).sum(dim=2, keepdim=True) / zc + (g / 2 + 2) * u * z
        on, near = z > t, z + e_z > t
        s_ = torch.where(on, 1.0 - t / zc, 0.0)
        e_s = torch.where(near, (t / zc) * (e_z / zc + 2 * u) + u * s_, 0.0)
        T = s_ * fp / gamma
        e_T = (fp * e_s + s_ * e_fp) / gamma + 4 * u * T
        X, Y = s_ * z * z / gamma * (1.0 - 0.5 * s_), t * s_ * z / gamma
        psi = torch.where(on, X - Y, 0.0)
        e_psi = torch.where(near, 6 * u * (X + Y) + (s_ * z + e_z) / gamma * e_z, 0.0)
        nz, nzp = (T != 0).double(), (psi != 0).double()
        S = f.shape[0]
        for key, x in (("row", T), ("e_row", e_T), ("k_row", nz)):
            parts[key].append(x.sum(3).reshape(S, tile_l * g))
        for key, x in (("col", T), ("e_col", e_T), ("k_col", nz)):
            parts[key].append(x.sum((1, 2)))
        for key, x in (("psi", psi.abs()), ("e_psi", e_psi), ("k_psi", nzp)):
            parts[key].append(x.sum((1, 2, 3)))

    def total(key):
        kw = dict(dtype=torch.float64, device=alpha.device)
        x = torch.cat(parts[key])
        if "row" in key:
            full = torch.zeros((B, Nt, Lt, tile_l * g), **kw)
            full[bi, ji, li] = x
            return full.sum(1).reshape(B, L_pad * g)
        if "col" in key:
            full = torch.zeros((B, Lt, Nt, tile_n), **kw)
            full[bi, li, ji] = x
            return full.sum(1).reshape(B, n_pad)
        full = torch.zeros((B, Lt, Nt), **kw)
        full[bi, li, ji] = x
        return full.sum((1, 2))

    vals, bounds = [], []
    for key in ("row", "col", "psi"):
        v = total(key)
        vals.append(v)
        bounds.append(total("e_" + key) + (total("k_" + key) - 1.0).clamp_min(0.0) * u * v.abs())
    return tuple(vals), tuple(bounds)


def kernel_work(pp, d, live, T, real_rows=None):
    """{kernel: (bytes, fp32 operations)} these inputs need: every input read once,
    every output written once, the live tiles' work (``live`` of ``T`` tiles), all
    counted on the rows and columns that are not padding: the ``pp.n`` real
    columns, the ``pp.L`` real groups and, of their rows, the ``real_rows`` that
    K4's row mask keeps (all when None).  A padded row or column adds nothing;
    each live tile holds its share of the real rows and columns."""
    m_pad = pp.L_pad * pp.g
    rows = pp.L * pp.g if real_rows is None else real_rows
    cols = pp.n
    E = pp.L * cols                                       # real bound-matrix entries
    # the live tiles' real entries, and the sample rows and columns they read
    entries = live * pp.tile_l * pp.g * pp.tile_n * rows * cols // (m_pad * pp.n_pad)
    sample_bytes = live * (pp.tile_l * pp.g * rows // m_pad
                           + pp.tile_n * cols // pp.n_pad) * (d + 1) * 4
    vec_bytes = 4 * (2 * rows + 2 * cols + pp.L + 1)      # duals in, sums out, tau
    work = {
        K1: (13 * E + 4 * (4 * pp.L + cols + pp.L) + 4 * T, 14 * E),
        K2: (4 * entries + vec_bytes + 4 * T, 9 * entries),
        K3: (4 * entries + vec_bytes + 12 * live + 4, 9 * entries),
        K4: (4 * (rows + cols) * (d + 2) + m_pad + 12 * E,
             rows * cols * snapshot_ops_per_entry(d) + 3 * E),
        K5: (sample_bytes + vec_bytes + 4 * T, fact_ops_per_entry(d) * entries),
        K6: (sample_bytes + vec_bytes + 12 * live + 4, fact_ops_per_entry(d) * entries),
    }
    # the fused kernels: the flags' reads (z~ and the active mask, 5 bytes an
    # entry: the flag does not depend on k~, o~, da_full or da_neg, rt::live),
    # the flags, then K2's or K5's live-tile work
    flag_work = (5 * E + 4 * (3 * pp.L + cols) + 4 * T, 6 * E)
    work[K7] = (flag_work[0] + work[K2][0] - 4 * T, flag_work[1] + work[K2][1])
    work[K8] = (flag_work[0] + work[K5][0] - 4 * T, flag_work[1] + work[K5][1])
    # the slot reduction after a grid kernel: each live tile's slots (its rows'
    # and columns' partial sums and psi), the flags, then the sums it writes
    slot_floats = pp.tile_l * pp.g + pp.tile_n + 1
    work[SLOT] = (4 * live * slot_floats + 4 * T + 4 * (m_pad + pp.n_pad + 1),
                  live * slot_floats)
    return work


def final_state(sol, ops, reg, device):
    """The kernels' operands at the state of a solve's last round boundary."""
    import torch

    from repro_torch.core import screening
    from repro_torch.kernels import gradpsi as kg
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import screen as ks

    pp, spec = ops.pp, ops.spec
    scr = sol.result.screen_state
    scr_b = type(scr)(**{f: getattr(scr, f)[None] for f in scr.__dataclass_fields__})
    sqrt_g = torch.as_tensor(spec.sqrt_sizes(), device=device)[None]
    pstate = kops.pad_screen_state_batched(scr_b, sqrt_g, pp)
    alpha, beta = sol.alpha[None], sol.beta[None]
    tau = ops.prob.tau_vec(device)
    tau_p = kops._pad_tau(tau, pp.L, pp.tile_l, device)
    da = screening.grouped_norms(alpha - pstate.alpha_snap, pp.L)
    da = [kops._pad_axis(d, -1, pp.tile_l, 0.0).contiguous() for d in da]
    db = kops._pad_axis(beta - pstate.beta_snap, -1, pp.tile_n, 0.0).contiguous()
    sargs = (pstate.z, pstate.k, pstate.o, pstate.act, *da, db, pstate.sqrt_g)
    skw = dict(tau=tau_p, tile_l=pp.tile_l, tile_n=pp.tile_n, emit_verdict=False)
    _, flags = ks.screen_batched(*sargs, **skw)
    alphap, betap = kops.pad_tile_inputs(alpha, beta, pp)
    gkw = dict(num_groups=pp.L_pad, group_size=pp.g, tau=tau_p, gamma=reg.gamma,
               tile_l=pp.tile_l, tile_n=pp.tile_n)
    sched, nact = kg.build_batch_tile_schedule(flags)
    return dict(sargs=sargs, skw=skw, alphap=alphap, betap=betap, flags=flags, sched=sched,
                nact=nact, gkw=gkw, alpha=alpha, beta=beta, scr=scr_b, sqrt_g=sqrt_g, tau=tau)


def phase_times(sol, ops, reg, launches, device):
    """Check and time K1-K6 at the main path's last round boundary, beside their plain versions."""
    import torch

    from repro_torch.kernels import gradpsi as kg
    from repro_torch.kernels import screen as ks

    st = final_state(sol, ops, reg, device)
    pp, fp, leaves = ops.pp, ops.fp, ops.fp.leaves()
    sargs, skw, a, b = st["sargs"], st["skw"], st["alphap"], st["betap"]
    flags, sched, nact, gkw = st["flags"], st["sched"], st["nact"], st["gkw"]
    k4kw = dict(num_groups=pp.L_pad, group_size=pp.g)
    live = int(nact)
    T = flags.numel()
    share = live / T

    fns = {
        K1: (lambda: ks.screen_batched(*sargs, **skw), lambda: ks.screen_batched_ref(*sargs, **skw)),
        K2: (lambda: kg.gradpsi_batched(a, b, pp.Cp, flags, **gkw),
             lambda: kg.gradpsi_batched_ref(a, b, pp.Cp, flags, **gkw)),
        K3: (lambda: kg.gradpsi_compact_batched(a, b, pp.Cp, sched, nact, **gkw),
             lambda: kg.gradpsi_compact_batched_ref(a, b, pp.Cp, sched, nact, **gkw)),
        K4: (lambda: ks.snapshot_norms_fact_batched(a, b, *leaves, ops.mask, tile_l=pp.tile_l,
                                                    tile_n=pp.tile_n, **k4kw),
             lambda: ks.snapshot_norms_fact_ref(a, b, *leaves, ops.mask, **k4kw)),
        K5: (lambda: kg.gradpsi_fact_batched(a, b, *leaves, flags, **gkw),
             lambda: kg.gradpsi_fact_batched_ref(a, b, *leaves, flags, **gkw)),
        K6: (lambda: kg.gradpsi_fact_compact_batched(a, b, *leaves, sched, nact,
                                                     **gkw),
             lambda: kg.gradpsi_fact_compact_batched_ref(a, b, *leaves, sched, nact, **gkw)),
        K7: (lambda: kg.gradpsi_fused_batched(a, b, pp.Cp, *sargs, **gkw),
             lambda: kg.gradpsi_fused_batched_ref(a, b, pp.Cp, *sargs, **gkw)),
        K8: (lambda: kg.gradpsi_fused_fact_batched(a, b, *leaves, *sargs, **gkw),
             lambda: kg.gradpsi_fused_fact_batched_ref(a, b, *leaves, *sargs, **gkw)),
    }
    out = {name: (fn(), plain()) for name, (fn, plain) in fns.items()}
    fused_flags = {name: (out[name][0][3], out[name][1][3]) for name in (K7, K8)}
    for name in (K3, K6, K7, K8):
        out[name] = (out[name][0][:3], out[name][1][:3])
    out[K1] = ((out[K1][0][1].float(),), (out[K1][1][1].float(),))

    # Checks on these inputs.  K1 and K4: exactly equal to the plain version.
    # K2/K3: here every float32 evaluation, the plain one included, keeps only
    # a few digits (s = 1 - tau/Z cancels just above the threshold), so each
    # is held to the float64 value within the computed f32 error bound e, and
    # so to the plain version within 2e; the plain version must meet e too,
    # else the bound is wrong.  K3 == K2, K5 == K2 and K6 == K3 bitwise.
    exact, e = gradient_f64_with_bound(a, b, pp.Cp, sched, nact, **gkw)
    ratio = lambda got: max(float(((x.double() - r).abs() / bb.clamp_min(1e-300)).max())
                            for x, r, bb in zip(got, exact, e))
    q2, q2p, q3 = ratio(out[K2][0]), ratio(out[K2][1]), ratio(out[K3][0])
    print(f"final-state f32 error over its bound (<= 1 passes): K2 {q2:.3f}, K3 {q3:.3f}, "
          f"plain {q2p:.3f}; largest bound over largest |value|: "
          + ", ".join(f"{n} {float(bb.max() / r.abs().max().clamp_min(1e-300)):.3e}"
                      for n, r, bb in zip(("rowsum", "colsum", "psi"), exact, e)), flush=True)
    check(q2p <= 1.0, f"the plain version exceeds the f32 error bound ({q2p:.3f}): bound wrong")
    ok = {
        K1: same(out[K1][0], out[K1][1]),
        K2: q2 <= 1.0,
        K3: q3 <= 1.0 and same(out[K3][0], out[K2][0]),
        K4: same(out[K4][0], out[K4][1]),
        K5: same(out[K5][0], out[K2][0]),
        K6: same(out[K6][0], out[K3][0]),
        K7: (same(fused_flags[K7], (flags, flags)) and same(out[K7][0], out[K2][0])),
        K8: (same(fused_flags[K8], (flags, flags)) and same(out[K8][0], out[K5][0])),
    }
    checks = {
        K1: "flags == plain (torch.equal)",
        K2: "within the f32 error bound of the f64 value (2x bound vs plain)",
        K3: "within the f32 error bound of the f64 value, bitwise == gradpsi_batched",
        K4: "z~, k~, o~ == plain (torch.equal)",
        K5: "bitwise == gradpsi_batched on the device-materialized cost",
        K6: "bitwise == gradpsi_compact_batched on the device-materialized cost",
        K7: "flags == K1's and its plain version's, sums bitwise == gradpsi_batched on them",
        K8: "flags == K1's and its plain version's, sums bitwise == gradpsi_fact_batched on "
            "them",
    }

    work = kernel_work(pp, fp.d, live, T, int(torch.count_nonzero(ops.mask)))
    rows = []
    for name in KERNELS:
        fn, plain = fns[name]
        err, rel = max_errs(*out[name])
        ms = median_ms(fn, 50)
        dev_us = device_us_per_call(fn, 20)[0] if name == K4 else None
        plain_ms = median_ms(plain, 5, warmup=1)
        nbytes, nops = work[name]
        bms, by = bound(nbytes, nops)
        path = {K2: DENSE_PATH, K3: DENSE_PATH, K7: FUSED_DENSE_GRID_PATH,
                K8: FUSED_GRID_PATH}.get(name, MAIN_PATH)
        source, replaces = SOURCES[name]
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[path].get(name, 0), "launches_path": path,
                     "max_abs_err": err, "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bms, "bound_by": by, "library_ms": None,
                     "check": checks[name], "result": "pass" if ok[name] else "fail",
                     "err_over_bound": {K2: q2, K3: q3}.get(name)})
        if dev_us is not None:            # a long kernel: its own time beside the call's
            rows[-1]["device_us_per_call"] = dev_us
            print(f"device time {name}: {dev_us:.2f} us a call (profiler, 20 calls)", flush=True)
        print(f"time {name}: {ms:.4f} ms (bound {bms:.4f} ms by {by}, {nbytes} B, {nops} "
              f"flops), plain {plain_ms:.4f} ms, live share {share:.6f}; {checks[name]}: "
              f"{'pass' if ok[name] else 'FAIL'} (max abs err {err:.3e}, max rel err "
              f"{rel:.3e}); launches on {path}: {launches[path].get(name, 0)}", flush=True)
    fused_beside_pairs(f"at the final state (live share {share:.4f})",
                       {k: fns[k][0] for k in (K1, K2, K5, K7, K8)})
    # the dense loader K2 / K3 / K7 ran at the paper's scale (from the profiler),
    # then a call split into the gradient kernel and the slot reduction, with the
    # cost in L2 (calls back to back) and in device memory (as the solver's
    # calls find it after K1's pass)
    ran = {}
    for C_, what in ((pp.Cp, "f32"), (ops.cost_forms("bf16")[0], "bf16")):
        ran[what] = check_loaders(f"at the paper's scale ({what})", C_, a, b, flags, sched,
                                  nact, sargs, gkw)
        check(ran[what] == {K2: STAGED, K3: DIRECT, K7: STAGED}, f"K2/K7 did not run the "
              f"staged loader, or K3 not the direct loads, at the paper's scale ({what})")
        print(f"loaders run at the paper's scale (tile_n {pp.tile_n}, {what}; profiler): "
              + ", ".join(f"{k} {v}" for k, v in ran[what].items()), flush=True)
    at = f"at the final state (live share {share:.4f})"
    for cold in (False, True):
        split = print_splits(at, {k: fns[k][0] for k in (K2, K3, K7)}, cold)
        for row in rows:
            if row["name"] in split:
                row["loader"] = ran["f32"][row["name"]]
                tag = "cold" if cold else "hot"
                row[f"{tag}_kernel_us"], row[f"{tag}_{SLOT}_us"] = split[row["name"]]
    full = kernel_work(pp, fp.d, T, T)[SLOT]
    print(f"bound {SLOT} (each gradient call's second launch): {bound(*work[SLOT])[0]:.6f} ms "
          f"at the final state ({work[SLOT][0]} B), {bound(*full)[0]:.6f} ms with every tile "
          f"live ({full[0]} B); launches on {MAIN_PATH}: one a gradient call", flush=True)
    for row in rows:
        check(row["launches"] > 0, f"{row['name']} was not launched on {row['launches_path']}")
    if not all(ok.values()):
        print(json.dumps({"kernels": rows}), flush=True)
        fail("a kernel disagrees with its plain version at the main path's final state")
    st["work"] = work
    st["batched"] = {K2: out[K2][0], K3: out[K3][0], K5: out[K5][0], K6: out[K6][0],
                     K7: out[K7][0] + (fused_flags[K7][0],), K8: out[K8][0] + (fused_flags[K8][0],)}
    return rows, st


def snapshot_norms_torch_sum(alpha, beta, C, prob, row_mask):
    """The dense route's snapshot norms before K4's body took them: torch.sum over g."""
    import torch

    L, g = prob.num_groups, prob.group_size
    F = alpha[..., :, None] + beta[..., None, :] - C
    Fg = F.reshape(F.shape[:-2] + (L, g, F.shape[-1]))
    mask = row_mask.reshape(row_mask.shape[:-1] + (L, g, 1))
    Fm = torch.where(mask, Fg, torch.zeros((), dtype=F.dtype, device=F.device))
    z = torch.sqrt(torch.sum(torch.square(torch.clamp_min(Fm, 0.0)), dim=-2))
    k = torch.sqrt(torch.sum(torch.square(Fm), dim=-2))
    o = torch.sqrt(torch.sum(torch.square(torch.clamp_max(Fm, 0.0)), dim=-2))
    return z, k, o


def phase_round_boundary(st, ops):
    """The round boundary (refresh N, snapshot, take it, verdict counts) at the final state,
    with the snapshot norms of each version, in turns (before, after, after, before)."""
    import torch

    from repro_torch.core import dual, screening
    from repro_torch.kernels import ops as kops

    alpha, beta, scr, sqrt_g, tau = st["alpha"], st["beta"], st["scr"], st["sqrt_g"], st["tau"]
    prob, rm = ops.prob, ops.row_mask
    C = ops.pp.Cp[:, : prob.m_pad, : prob.n]
    snaps = {
        "plain, torch.sum over g (before)": lambda: snapshot_norms_torch_sum(alpha, beta, C, prob, rm),
        "plain, members in order": lambda: dual.snapshot_norms(alpha, beta, C, prob, rm),
        "K4's body on the dense cost": lambda: kops.snapshot_norms_padded(alpha, beta, ops.pp, rm),
        "K4 (factorized)": lambda: kops.snapshot_norms_factorized(alpha, beta, ops.fp, rm),
    }

    def boundary(snap):
        new = screening.refresh_active(scr, alpha, beta, sqrt_g, tau)
        z, k, o = snap()
        new = screening.take_snapshot(new, alpha, beta, z, k, o)
        v = screening.verdicts(new, alpha, beta, sqrt_g, tau)
        return torch.stack([torch.sum(v == x, dim=(-2, -1))
                            for x in (screening.ZERO, screening.CHECK, screening.ACTIVE)])

    ref = snaps["K4's body on the dense cost"]()
    check(same(snaps["plain, members in order"](), ref) and same(snaps["K4 (factorized)"](), ref),
          "snapshot norms: the plain version, K4's dense body and K4 disagree")
    times = {name: [] for name in snaps}
    for name in list(snaps) + list(reversed(snaps)):
        times[name].append((median_ms(snaps[name], 10), median_ms(lambda: boundary(snaps[name]), 10)))
    for name, ts in times.items():
        print(f"round boundary with {name}: snapshot {ts[0][0]:.4f} / {ts[1][0]:.4f} ms, whole "
              f"boundary {ts[0][1]:.4f} / {ts[1][1]:.4f} ms (two turns)", flush=True)


def phase_density_times(ops, reg, device):
    """K1-K3, K5-K8 times across live shares (the grid/compact crossover, the fused
    kernels against K1 + K2 / K5), and K2/K5/K7/K8 on the bf16 cost forms.

    Returns {K2, K3, K5-K8: (ms, bound ms, bound by, live share)} with every
    tile live.
    """
    import numpy as np
    import torch

    from repro_torch.kernels import gradpsi as kg
    from repro_torch.kernels import screen as ks

    rng = np.random.default_rng(1)
    L_pad = ops.fp.L_pad
    C, leaves = ops.cost_forms("f32")
    C16, leaves16 = ops.cost_forms("bf16")
    tau_p = torch.full((L_pad,), float(reg.tau), dtype=torch.float32, device=device)
    for target in (0.0, 0.1, 0.6, 1.0):
        inp = kernel_inputs(rng, C, L_pad, float(reg.tau), target, device)
        sargs = screen_args(inp)
        _, flags = ks.screen_batched(*sargs, tau=tau_p, tile_l=TILE_L, tile_n=TILE_N,
                                     emit_verdict=False)
        kw = dict(num_groups=L_pad, group_size=inp["g"], tau=tau_p, gamma=reg.gamma,
                  tile_l=TILE_L, tile_n=TILE_N)
        a, b = inp["alpha"], inp["beta"]
        sched, nact = kg.build_batch_tile_schedule(flags)
        t = {K1: lambda: ks.screen_batched(*sargs, tau=tau_p, tile_l=TILE_L, tile_n=TILE_N,
                                           emit_verdict=False),
             K2: lambda: kg.gradpsi_batched(a, b, C, flags, **kw),
             K3: lambda: kg.gradpsi_compact_batched(a, b, C, sched, nact, **kw),
             K5: lambda: kg.gradpsi_fact_batched(a, b, *leaves, flags, **kw),
             K6: lambda: kg.gradpsi_fact_compact_batched(a, b, *leaves, sched, nact,
                                                         **kw),
             K7: lambda: kg.gradpsi_fused_batched(a, b, C, *sargs, **kw),
             K8: lambda: kg.gradpsi_fused_fact_batched(a, b, *leaves, *sargs, **kw),
             K2 + " bf16": lambda: kg.gradpsi_batched(a, b, C16, flags, **kw),
             K5 + " bf16": lambda: kg.gradpsi_fact_batched(a, b, *leaves16, flags, **kw),
             K7 + " bf16": lambda: kg.gradpsi_fused_batched(a, b, C16, *sargs, **kw),
             K8 + " bf16": lambda: kg.gradpsi_fused_fact_batched(a, b, *leaves16, *sargs,
                                                                  **kw)}
        ms = {k: median_ms(f, 20) for k, f in t.items()}
        ms.update({k + " again": median_ms(t[k], 20) for k in (K5, K2, K7, K8)})
        ts = median_ms(lambda: kg.build_batch_tile_schedule(flags), 20)
        share = int(nact) / flags.numel()
        print(f"share sweep @ live share {share:.4f}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in ms.items()) + f" (+ schedule build {ts:.4f} ms)",
              flush=True)
        if target == 1.0:
            fused_beside_pairs("fully live", {k: t[k] for k in (K1, K2, K5, K7, K8)})
            print_splits("fully live", {k: t[k] for k in (K2, K3, K7)})
            work = kernel_work(ops.fp, ops.fp.d, int(nact), flags.numel())
            live = {k: (min(ms[k], ms.get(k + " again", ms[k])),) + bound(*work[k]) + (share,)
                    for k in (K2, K3, K5, K6, K7, K8)}
            print("fully live: " + ", ".join(f"{k} {v[0]:.4f} ms against a bound of {v[1]:.4f} "
                                             f"ms ({v[2]})" for k, v in live.items()),
                  flush=True)
    return live


# -- phase 6 -------------------------------------------------------------------

def phase_solo_vs_batched(device):
    import numpy as np
    import torch

    import repro_torch.ot as ot
    from repro_torch.core import solver as slv
    from repro_torch.core.regularizers import GroupSparseReg
    from repro_torch.data.pipeline import DomainPairConfig, make_domain_pair
    from repro_torch.kernels.ops import FactorizedCost
    from repro_torch.ot.problem import Problem

    reg = GroupSparseReg.from_rho(0.1, 0.8)
    probs = []
    for seed in (1, 2):
        Xs, ys, Xt, _ = make_domain_pair(DomainPairConfig(num_classes=64, samples_per_class=16,
                                                          seed=seed))
        probs.append(Problem.from_samples(Xs, ys, Xt, reg))
    pads = [p.padded() for p in probs]
    spec = pads[0].spec
    check(all(p.spec == spec for p in pads), "phase 6 layouts differ")
    ex = ot.compile(probs[0], ot.ExecutionPlan(grad_impl="pallas", geometry="on_the_fly"),
                    device=device)
    fcs = [FactorizedCost(*ex.geometry(p).operands()) for p in probs]
    margs = [ex._marginals(p) for p in probs]
    routes = {
        "dense": ([p.C for p in pads], np.stack([p.C for p in pads]),
                  [p.a for p in pads], [p.b for p in pads]),
        "factorized": (fcs, FactorizedCost(*(torch.stack(v) for v in
                                             zip(*(f.leaves() for f in fcs)))),
                       [m[0] for m in margs], [m[1] for m in margs]),
    }
    for route, (solo_costs, batch_cost, a, b) in routes.items():
        for grad_impl in ("pallas", "fused"):
            for impl in ("grid", "compact"):
                opts = slv.SolveOptions(grad_impl=grad_impl, pallas_impl=impl)
                both = slv.solve_dual_batch(batch_cost, np.stack(a), np.stack(b), spec, reg,
                                            opts, device)
                for i in range(2):
                    solo = slv.solve_dual(solo_costs[i], a[i], b[i], spec, reg, opts, device)
                    one = both[i]
                    bitwise = (torch.equal(solo.alpha, one.alpha)
                               and torch.equal(solo.beta, one.beta)
                               and torch.equal(solo.value, one.value)
                               and solo.rounds == one.rounds and solo.stats == one.stats
                               and solo.iterations == one.iterations
                               and solo.n_evals == one.n_evals)
                    rel = abs(float(solo.value) - float(one.value)) / abs(float(solo.value))
                    tag = f"{route}/{'' if grad_impl == 'pallas' else 'fused-'}{impl}"
                    print(f"solo vs batched (L=64, n=1024, B=2, {tag}, problem {i}): "
                          f"bitwise={bitwise}, value rel diff {rel:.3e}, rounds solo "
                          f"{solo.rounds} batched {one.rounds}, stats equal "
                          f"{solo.stats == one.stats}", flush=True)
                    check(bitwise, f"solo != batched on {tag}, problem {i}")


# -- phase 7: the solo oracle layer (B9-B14) --------------------------------------

def _unbatched(ops):
    """The main problem's prepared cost forms without their B axis (solo route)."""
    import dataclasses

    pp, fp = ops.pp, ops.fp
    return (dataclasses.replace(pp, Cp=pp.Cp[0]),
            dataclasses.replace(fp, **{k: getattr(fp, k)[0] for k in ("x", "x_sq", "y",
                                                                     "y_sq")}))


def phase_solo(sol, st, ops, problem, reg, device):
    """B9-B14 at the main path's final state, against their batched twins at B = 1.

    Each solo kernel wrapper, each solo oracle of kernels/ops.py and
    ``make_value_and_grad`` on both routes must give the bits of the batched
    kernel / oracle at B = 1 (sums, flags, value); the solo wrappers are
    timed beside the bound of their twin's work and their plain versions.
    The solo path: ``make_value_and_grad`` once per (route, oracle, impl),
    counters reset just before and read just after.  Returns the kernel rows.
    """
    import torch

    import repro_torch.ot as ot
    from repro_torch.core import screening
    from repro_torch.core import solver as slv
    from repro_torch.kernels import _build as kbuild
    from repro_torch.kernels import gradpsi as kg
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ops import FactorizedCost

    pps, fps = _unbatched(ops)
    gkw = st["gkw"]
    a1, b1, flags = st["alphap"][0], st["betap"][0], st["flags"][0]
    scr_args = tuple(t[0] for t in st["sargs"])
    sched, nact = kg.build_tile_schedule(flags)
    leaves = fps.leaves()
    A, Bt, F, Cb, Lb = st["alphap"], st["betap"], st["flags"], ops.pp.Cp, ops.fp.leaves()
    fns = {
        B9: (lambda: kg.gradpsi(a1, b1, pps.Cp, flags, **gkw),
             lambda: kg.gradpsi_batched_ref(A, Bt, Cb, F, **gkw)),
        B10: (lambda: kg.gradpsi_compact(a1, b1, pps.Cp, sched, nact, **gkw),
              lambda: kg.gradpsi_compact_batched_ref(A, Bt, Cb, st["sched"], st["nact"],
                                                     **gkw)),
        B11: (lambda: kg.gradpsi_fused(a1, b1, pps.Cp, *scr_args, **gkw),
              lambda: kg.gradpsi_fused_batched_ref(A, Bt, Cb, *st["sargs"], **gkw)),
        B12: (lambda: kg.gradpsi_fact(a1, b1, *leaves, flags, **gkw),
              lambda: kg.gradpsi_fact_batched_ref(A, Bt, *Lb, F, **gkw)),
        B13: (lambda: kg.gradpsi_fact_compact(a1, b1, *leaves, sched, nact, **gkw),
              lambda: kg.gradpsi_fact_compact_batched_ref(A, Bt, *Lb, st["sched"], st["nact"],
                                                          **gkw)),
        B14: (lambda: kg.gradpsi_fused_fact(a1, b1, *leaves, *scr_args, **gkw),
              lambda: kg.gradpsi_fused_fact_batched_ref(A, Bt, *Lb, *st["sargs"], **gkw)),
    }
    outs = {}
    for name, (fn, plain) in fns.items():
        got = fn()
        twin = st["batched"][TWIN[name]]
        want = tuple(t[0] for t in twin[:3]) + ((twin[3][0],) if len(twin) == 4 else ())
        check(same(tuple(got[:3]) + ((got[3],) if name in (B11, B14) else ()), want),
              f"{name} not bitwise equal to {TWIN[name]} at B = 1")
        if name in (B10, B13):
            check(int(got[3]) == int(st["nact"]), f"{name} steps != live tiles")
        outs[name] = (got[:3], tuple(t[0] for t in plain()[:3]))

    # the solo oracles of kernels/ops.py against the batched ones at B = 1
    ex = ot.compile(problem, ot.ExecutionPlan(grad_impl="pallas"), device=device)
    a_np, b_np, _ = ex._marginals(problem)
    a, b = torch.from_numpy(a_np).to(device), torch.from_numpy(b_np).to(device)
    alpha, beta, prob = sol.alpha, sol.beta, ops.prob
    scr_b, sqb, tau = st["scr"], st["sqrt_g"], st["tau"]
    scr1 = screening.ScreenState(**{f: getattr(scr_b, f)[0] for f in scr_b.__dataclass_fields__})
    lift = lambda *ts: tuple(t[None] for t in ts)
    for route, (pp1, ppb) in (("dense", (pps, ops.pp)), ("factorized", (fps, ops.fp))):
        ps1 = kops.pad_screen_state(scr1, sqb[0], pp1)
        psb = kops.pad_screen_state_batched(scr_b, sqb, ppb)
        f1 = kops.screen_tile_flags(ps1, alpha, beta, pp1, tau)
        fb = kops.screen_tile_flags_batched(psb, *lift(alpha, beta), ppb, tau)
        check(torch.equal(f1, fb[0]), f"solo screen_tile_flags != batched ({route})")
        fn1, fnb = ((kops.dual_value_and_grad_factorized,
                     kops.dual_value_and_grad_factorized_batched) if route == "factorized"
                    else (kops.dual_value_and_grad_padded,
                          kops.dual_value_and_grad_padded_batched))
        for impl in ("grid", "compact"):
            got = fn1(alpha, beta, a, b, f1, pp1, prob, impl=impl)
            want = fnb(*lift(alpha, beta, a, b), fb, ppb, prob, impl=impl)
            check(same(got, tuple(t[0] for t in want)),
                  f"solo {fn1.__name__}({impl}) != batched at B = 1 ({route})")
        got = kops.dual_value_and_grad_fused(alpha, beta, a, b, ps1, pp1, prob, impl="grid")
        want = kops.dual_value_and_grad_fused_batched(*lift(alpha, beta, a, b), psb, ppb, prob,
                                                      impl="grid")
        check(same(got, tuple(t[0] for t in want)),
              f"solo dual_value_and_grad_fused(grid) != batched at B = 1 ({route})")

    # the solo path: make_value_and_grad on both routes, counted
    x = torch.cat([alpha, beta])
    costs = {"dense": (ops.pp.Cp[0, : prob.m_pad, : prob.n], pps, ops.pp),
             "factorized": (FactorizedCost(*(t[0] for t in ops.fc.leaves())), fps, ops.fp)}
    runs = [(route, gi, impl) for route in ("dense", "factorized")
            for gi, impl in (("pallas", "grid"), ("pallas", "compact"), ("fused", "grid"))]
    sync()
    kbuild.reset_launch_counts()
    solo = {r: slv.make_value_and_grad(costs[r[0]][0], a, b, prob, sqb[0], r[1], scr1,
                                       padded=costs[r[0]][1], pallas_impl=r[2])(x) for r in runs}
    sync()
    launches = kbuild.launch_counts()
    for r in runs:
        cost_b = costs[r[0]][0]
        cost_b = cost_b.map(lambda t: t[None]) if r[0] == "factorized" else cost_b[None]
        bv, bg = slv.make_value_and_grad_batched(cost_b, a[None], b[None], prob, sqb, r[1],
                                                 scr_b, padded=costs[r[0]][2],
                                                 pallas_impl=r[2])(x[None])
        check(torch.equal(solo[r][0], bv[0]) and torch.equal(solo[r][1], bg[0]),
              f"make_value_and_grad {r} != the batched oracle at B = 1")
    for name in SOLO_KERNELS:
        check(launches.get(name, 0) == 1, f"the solo path launched {name} "
              f"{launches.get(name, 0)} times, not once: {launches}")
    print(f"solo path at the main path's final state: B9-B14 == K2/K3/K7/K5/K6/K8 at B = 1 "
          f"bitwise (sums, flags, steps); the solo oracles of kernels/ops.py (grid, compact, "
          f"fused grid) and make_value_and_grad on both routes == the batched ones at B = 1 "
          f"bitwise (value, gradient, flags); launches {launches}", flush=True)

    rows = []
    for name, (fn, plain) in fns.items():
        err, rel = max_errs(*outs[name])
        ms = median_ms(fn, 50)
        plain_ms = median_ms(plain, 5, warmup=1)
        bms, by = bound(*st["work"][TWIN[name]])
        source, replaces = SOURCES[name]
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches.get(name, 0), "launches_path": "solo/make_value_and_grad",
                     "max_abs_err": err, "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bms, "bound_by": by, "library_ms": None,
                     "check": f"bitwise == {TWIN[name]} at B = 1", "result": "pass"})
        print(f"time {name} ({TWIN[name]} at B = 1): {ms:.4f} ms (bound {bms:.4f} ms by {by}), "
              f"plain {plain_ms:.4f} ms, max abs err vs plain {err:.3e}", flush=True)
    return rows


# -- phase 8: the differentiable layer, forward and backward, and training ------------

def phase_train(problem, reg, device):
    """The samples layer at full width: value, forward + backward, refinement, training.

    Returns the launches of the refine run.
    """
    import dataclasses

    import numpy as np
    import torch

    import repro_torch.ot as ot
    from repro_torch.core import groups as G
    from repro_torch.core import solver as slv
    from repro_torch.kernels import _build as kbuild
    from repro_torch.kernels.ops import FactorizedCost
    from repro_torch.ot import diff
    from repro_torch.training import losses

    spec = problem.group_spec()
    L, g, n = spec.num_groups, spec.group_size, problem.num_target
    Xp, _, mask = G.pad_sources(np.asarray(problem.X_S, np.float32), problem.labels, spec)
    x = torch.from_numpy(Xp).to(device)
    y = torch.from_numpy(np.asarray(problem.X_T, np.float32)).to(device)
    pad_rows = torch.from_numpy(~mask).to(device)
    dense_bytes = spec.m_pad * n * 4
    # the first matmul and the first backward on the card start cuBLAS and
    # the autograd engine's device thread (about a second): not the layer's time
    w = torch.ones((8, 8), device=device, requires_grad=True)
    torch.autograd.grad(torch.sum(w @ torch.ones((8, 2), device=device)), w)
    sync()
    for gi in ("pallas", "fused"):
        plan = ot.ExecutionPlan(grad_impl=gi)
        layer = diff.OTLayer(L, g, n, reg, plan=plan, sizes=spec.sizes, normalize_cost=True,
                             device=device)
        with torch.no_grad():
            xs, x_sq, ys, y_sq, scale = diff._scaled_factors(layer, x, y)
            a, b = layer._marginals(None, None)
            ref = slv.solve_dual(FactorizedCost(xs, x_sq, ys, y_sq), a, b, spec, reg,
                                 plan.solve_options(), device)
            v0 = layer.from_samples(x, y)
        check(torch.equal(v0, ref.value), f"layer ({gi}) value {float(v0)!r} != solve_dual on "
              f"the same FactorizedCost {float(ref.value)!r}")
        del ref, xs, x_sq, ys, y_sq
        xg, yg = x.clone().requires_grad_(), y.clone().requires_grad_()
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        diff.reset_solve_count()
        kbuild.reset_launch_counts()
        t0 = time.perf_counter()
        v = layer.from_samples(xg, yg)
        sync()
        t_fwd = time.perf_counter() - t0
        peak_fwd = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        torch.autograd.grad(v, (xg, yg), retain_graph=True)
        sync()
        t_bwd0 = time.perf_counter() - t0          # the first: the allocator grows
        t0 = time.perf_counter()
        gx, gy = torch.autograd.grad(v, (xg, yg))
        sync()
        t_bwd = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = kbuild.launch_counts()
        check(diff.solve_count() == 1, f"forward + backward ran {diff.solve_count()} solves")
        check(torch.equal(v.detach(), v0), f"layer ({gi}) value differs with grad enabled")
        check(bool(torch.isfinite(gx).all() and torch.isfinite(gy).all()),
              "layer gradients not finite")
        check(bool((gx[pad_rows] == 0).all()), "padded rows' gradients are not exact zeros")
        total = float((gx.sum(0) + gy.sum(0)).abs().max())
        mass = float(gx.abs().sum() + gy.abs().sum())
        check(total <= 1e-3 * mass, f"translation invariance: |sum gx + sum gy| {total:.3e} > "
              f"1e-3 * {mass:.3e}")
        check(peak < dense_bytes, f"forward + backward peaked at {peak} B, not below the "
              f"{dense_bytes} B of the dense cost")
        kernels_run = {k: c for k, c in launches.items() if k not in REDUCE_PATH}
        check(launches.get(K1, 0) > 0 and launches.get(K4, 0) > 0
              and (launches.get(K5, 0) + launches.get(K6, 0) + launches.get(K8, 0)) > 0,
              f"layer ({gi}) forward did not run K1, K4 and a factorized gradient kernel: "
              f"{launches}")
        print(f"layer from_samples ({gi}, L = {L}, g = {g}, m_pad = {spec.m_pad}, n = {n}, "
              f"d = 2, normalize_cost): value {float(v0)!r} == solve_dual on the same "
              f"FactorizedCost bitwise; forward {t_fwd:.4f} s, backward {t_bwd0:.4f} s, again "
              f"{t_bwd:.4f} s; one "
              f"solve; padded rows' gradients exact zeros; |sum gx + sum gy| {total:.3e} "
              f"(<= 1e-3 * {mass:.3e}); peak device memory {peak} B (forward {peak_fwd} B, "
              f"{base} B held before) vs the dense cost {dense_bytes} B; launches "
              f"{kernels_run}", flush=True)
        del v, gx, gy, xg, yg

    # refinement: grad_refine steps of the solo factorized oracle (B12)
    steps = 20
    layer = diff.OTLayer(L, g, n, reg, plan=ot.ExecutionPlan(grad_impl="pallas"),
                         sizes=spec.sizes, normalize_cost=True, device=device)
    refined = dataclasses.replace(layer, grad_refine=steps)
    with torch.no_grad():
        sync()
        kbuild.reset_launch_counts()
        t0 = time.perf_counter()
        v_r = refined.from_samples(x, y)
        sync()
        t_ref = time.perf_counter() - t0
        refine_launches = kbuild.launch_counts()
        t0 = time.perf_counter()
        v_0 = layer.from_samples(x, y)
        sync()
        t_plain = time.perf_counter() - t0
    check(refine_launches.get(B12, 0) == steps + 1, f"grad_refine={steps} launched {B12} "
          f"{refine_launches.get(B12, 0)} times, not {steps + 1}: {refine_launches}")
    check(bool(torch.isfinite(v_r)), "refined value not finite")
    # one refine step alone: the solo factorized oracle (B12) and the ascent step
    with torch.no_grad():
        xs, x_sq, ys, y_sq, _ = diff._scaled_factors(layer, x, y)
        a, b = layer._marginals(None, None)
        oracle = diff._exact_oracle(FactorizedCost(xs, x_sq, ys, y_sq), a, b,
                                    layer.dual_problem())
        res = slv.solve_dual(FactorizedCost(xs, x_sq, ys, y_sq), a, b, spec, reg,
                             layer.plan.solve_options(), device)
        lr = float(reg.gamma) / float(max(spec.m_pad, n))

        def refine_step():
            _, ga, gb = oracle(res.alpha, res.beta)
            return res.alpha + lr * ga, res.beta + lr * gb

        per_step = median_ms(refine_step, 20) / 1e3
    print(f"layer grad_refine={steps}: value {float(v_r)!r} (unrefined {float(v_0)!r}); "
          f"{B12} launches {refine_launches.get(B12, 0)}; forward {t_ref:.4f} s against "
          f"{t_plain:.4f} s unrefined; one refine step (B12 with every tile live, then the "
          f"ascent step) {per_step * 1e3:.3f} ms (median of 20, CUDA events)", flush=True)

    # training: Adam steps of a Linear(2, 2) map on the source clouds (g = 10, unpadded)
    Xs = torch.from_numpy(np.asarray(problem.X_S, np.float32)).to(device)
    order = np.argsort(problem.labels, kind="stable")
    Xs = Xs[torch.from_numpy(order).to(device)]
    torch.manual_seed(0)
    lin = torch.nn.Linear(2, 2).to(device)
    with torch.no_grad():
        lin.weight.copy_(torch.eye(2))
        lin.bias.copy_(torch.tensor([0.0, 1.0]))
    # the shift carries the domain gap; the samples reach x = 6400, so the
    # weight takes small steps (Adam moves every entry by about its rate)
    opt = torch.optim.Adam([{"params": [lin.weight], "lr": 1e-5},
                            {"params": [lin.bias], "lr": 0.5}])
    hist, times = [], []
    for _ in range(5):
        sync()
        t0 = time.perf_counter()
        opt.zero_grad()
        loss, _ = losses.ot_alignment_loss(lin(Xs), y, num_classes=L,
                                           group_size=problem.num_source // L,
                                           grad_impl="pallas", device=device)
        loss.backward()
        opt.step()
        sync()
        times.append(time.perf_counter() - t0)
        hist.append(float(loss.detach()))
    check(hist[-1] < hist[0], f"the training loss did not fall from the first step to the "
          f"last: {hist}")
    print(f"training: 5 Adam steps (rates 1e-5 weight, 0.5 bias) of Linear(2, 2) (identity, "
          f"bias (0, 1)) on the "
          f"source clouds, ot_alignment_loss(grad_impl='pallas', L = {L}, g = "
          f"{problem.num_source // L}, n = {n}): loss {hist} (strictly falling at every step: "
          f"{all(q < p for p, q in zip(hist, hist[1:]))}); step times "
          f"{[round(t, 4) for t in times]} s; bias now {lin.bias.detach().tolist()}",
          flush=True)
    return refine_launches


# -- phase 9: the stochastic solver ------------------------------------------------

def phase_stochastic(problem, reg, lbfgs_value, device):
    """solver='stochastic' at full width (sgd_block_cols=128) and on the golden problem
    (sgd_block_cols=4, tile_n = 4).  Returns the launches of the full-width pallas run."""
    import numpy as np
    import torch

    import repro_torch.ot as ot
    from repro_torch.core import groups as G
    from repro_torch.core import stochastic as sgd
    from repro_torch.core.regularizers import GroupSparseReg
    from repro_torch.kernels import _build as kbuild
    from repro_torch.kernels.ops import FactorizedCost

    P = ot.ExecutionPlan
    kw = dict(solver="stochastic", sgd_block_cols=128)
    ex = ot.compile(problem, P(grad_impl="pallas", **kw), device=device)
    check(ex._route(problem) == "factorized", "the stochastic plan did not take the factorized "
          "route")
    fc = FactorizedCost(*ex.geometry(problem).operands())
    a, b, _ = ex._marginals(problem)
    spec = problem.group_spec()
    sopts = ex.plan.stochastic_options()
    w, nt = sgd._num_blocks(problem.num_target, sopts.block_cols)
    steps = sopts.epochs * max(nt // min(sopts.batch_blocks, nt), 1)
    res, launches = {}, {}
    walls = {}
    # 'auto' (the default) reads the live-tile count on the host every step;
    # 'grid' reads nothing and gives the same bits: the pair prices the read
    for label, gi, impl in (("pallas", "pallas", "auto"), ("pallas grid", "pallas", "grid"),
                            ("pallas again", "pallas", "auto"), ("fused", "fused", "auto")):
        opts = P(grad_impl=gi, pallas_impl=impl, **kw).solve_options()
        sync()
        kbuild.reset_launch_counts()
        t0 = time.perf_counter()
        r = sgd.solve_solo(fc, a, b, spec, reg, opts, sopts, device)
        sync()
        wall = time.perf_counter() - t0
        launches[label] = kbuild.launch_counts()
        res[label], walls[label] = r, wall
        n_launch = sum(launches[label].values())
        print(f"stochastic {label} (epochs {sopts.epochs}, not cut; {nt} blocks of {w} columns, "
              f"{sopts.batch_blocks} per step, {steps} steps): wall {wall:.3f} s, "
              f"{wall / steps * 1e3:.3f} ms per step, {n_launch / steps:.2f} counted launches "
              f"per step ({launches[label]}); value {float(r.value)!r}", flush=True)
    bits = lambda r: (r.alpha, r.beta, r.value)
    check(same(bits(res["pallas"]), bits(res["pallas again"])),
          "two stochastic runs with the same seed differ")
    check(same(bits(res["fused"]), bits(res["pallas"])), "stochastic fused != pallas bitwise")
    check(same(bits(res["pallas grid"]), bits(res["pallas"])),
          "stochastic pallas_impl='grid' != 'auto' bitwise")
    read = ((walls["pallas"] + walls["pallas again"]) / 2 - walls["pallas grid"]) / steps
    print(f"stochastic 'auto' (a host read of the live count, the schedule, K6 on the live "
          f"tiles) against 'grid' (K5 over every tile, the dead ones returning at once), "
          f"bitwise equal: {read * 1e3:+.3f} ms per step", flush=True)
    v = float(res["pallas"].value)
    check(np.isfinite(v) and v <= lbfgs_value * (1 + 2e-5), f"stochastic value {v!r} not "
          f"finite or above the L-BFGS value {lbfgs_value!r}")
    check(launches["pallas"].get(K6, 0) + launches["pallas"].get(K5, 0) >= steps,
          f"the stochastic path did not run a factorized gradient kernel per step")
    sol = ex.solve()
    check(sol.value == v, f"Executor.solve (stochastic) {sol.value!r} != solve_solo {v!r}")
    print(f"stochastic at full width: reruns bitwise, fused == pallas bitwise, value {v!r} <= "
          f"the L-BFGS value {lbfgs_value!r} (gap {(lbfgs_value - v) / lbfgs_value:.3e}); "
          f"Executor.solve gives the same value", flush=True)

    # the idle card: one profiled stochastic call of 5 epochs
    from torch.profiler import ProfilerActivity, profile

    short = P(grad_impl="pallas", **kw, sgd_epochs=5)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sgd.solve_solo(fc, a, b, spec, reg, short.solve_options(), short.stochastic_options(),
                       device)
        sync()
        wall = time.perf_counter() - t0
    rows = [(e.key, device_us(e), e.count) for e in prof.key_averages()]
    kern = [r for r in rows if r[1] > 0 and not r[0].startswith(("aten::", "cuda"))]
    busy = sum(r[1] for r in kern) / 1e6
    n_dev = sum(r[2] for r in kern)
    st5 = 5 * max(nt // min(sopts.batch_blocks, nt), 1)
    print(f"profile stochastic (5 epochs, {st5} steps): wall {wall:.4f} s, device busy "
          f"{busy:.4f} s, idle share {1.0 - busy / wall:.4f}, {n_dev} device launches "
          f"({n_dev / st5:.1f} per step)", flush=True)
    for key, us, count in sorted(kern, key=lambda r: -r[1])[:8]:
        print(f"  {us / 1e3:10.3f} ms  x{count:<6d} {key[:100]}", flush=True)

    # the golden-sized problem at sgd_block_cols=4: tile_n = 4 on the card
    C = np.random.default_rng(0).random((24, 20), dtype=np.float32)
    gspec = G.GroupSpec(num_groups=3, group_size=8, sizes=(8,) * 3, m=24)
    gprob = ot.Problem.from_padded(C, np.full(24, 1 / 24, np.float32),
                                   np.full(20, 1 / 20, np.float32), gspec,
                                   GroupSparseReg.from_rho(1.0, 0.6))
    gkw = dict(solver="stochastic", sgd_epochs=200, sgd_block_cols=4, pallas_impl="grid")
    exact = ot.compile(gprob, P(grad_impl="dense", gtol=1e-7, max_iters=2000), device=device)
    exact = exact.solve().value
    kbuild.reset_launch_counts()
    gp = ot.compile(gprob, P(grad_impl="pallas", **gkw), device=device).solve()
    glaunch = kbuild.launch_counts()
    gf = ot.compile(gprob, P(grad_impl="fused", **gkw), device=device).solve()
    check(glaunch.get(K2, 0) >= 400, f"sgd_block_cols=4 did not run K2 per step: {glaunch}")
    check(gp.value == gf.value and torch.equal(gp.alpha, gf.alpha),
          "golden stochastic fused != pallas")
    check(abs(gp.value - exact) <= 1e-3, f"golden stochastic {gp.value} vs exact {exact}")
    print(f"stochastic on the golden problem (24 x 20, sgd_block_cols=4: tile_n = 4, 28 of a "
          f"CTA's 32 lanes idle): value {gp.value!r} vs exact {exact!r} (gap "
          f"{abs(gp.value - exact):.3e} <= 1e-3), fused == pallas bitwise, launches {glaunch}",
          flush=True)
    return launches["pallas"]


# -- --compare: this tree's gradient kernels against another checkout's --------------

# -- phase 10: the batch API at full width ----------------------------------------

def full_width_problems(reg, cases):
    """Problems at the main path's scale, one per (seed, samples per class): L = 1280,
    d = 2, n = 12 800 targets (10 per class, so every problem fits one template;
    with 12 sources per class g = 12 pads to 16 as 10 does)."""
    import numpy as np

    from repro_torch.data.pipeline import DomainPairConfig, make_domain_pair
    from repro_torch.ot.problem import Problem

    out = []
    for seed, spc in cases:
        Xs, ys, Xt, _ = make_domain_pair(DomainPairConfig(num_classes=1280,
                                                          samples_per_class=spc, seed=seed))
        out.append(Problem.from_samples(Xs, ys, Xt[np.arange(len(Xt)) % spc < 10], reg))
    return out


def same_solution(x, y) -> bool:
    """Bitwise equal duals, value, rounds, stats, iterations and plan fingerprint."""
    import torch

    return (torch.equal(x.alpha, y.alpha) and torch.equal(x.beta, y.beta)
            and solution_bits(x) == solution_bits(y)
            and fingerprint(x.plan) == fingerprint(y.plan))


def profile_device(fn, untraced=None):
    """(result, wall s, device busy s, device launches, kernel rows) of ``fn()`` under
    torch.profiler, from the device's own records only (kernels, copies, fills; not
    the profiler's buffer flushes, nor host ops, whose self time would count the
    ctypes-launched kernels inside them once more); rows are (name, device us,
    launches), largest first.

    Where the profiler does not start and ``untraced`` is given, ``untraced(error)``
    is called and ``fn()`` runs without it: (result, wall s, None, None, []).  Only
    the profiler's start is guarded; an error of ``fn`` propagates."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])     # no host ops: quick to read
    try:
        prof.start()
    except RuntimeError as e:
        if untraced is None:
            raise
        untraced(e)
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0, None, None, []
    try:
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
    finally:
        prof.stop()
    kernels = sorted(((e.key, device_us(e), e.count) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and not e.key.startswith("Buffer Flush")),
                     key=lambda r: -r[1])
    return out, wall, sum(r[1] for r in kernels) / 1e6, sum(r[2] for r in kernels), kernels


def check_k4_mask_per_problem(label, x, pp, row_mask):
    """K4 on the duals ``x`` (B, m_pad + n) of a batch whose (B, m_pad) row mask differs
    between problems, at the shapes the path gives it: the kernel (the factorized
    loader or the dense body, by ``pp``) against its plain version on the same
    tensors, bit for bit.  Its launch is a comparison's, not the path's."""
    import torch

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import screen

    m_pad = row_mask.shape[-1]
    check(row_mask.dim() == 2 and bool((row_mask != row_mask[:1]).any()),
          f"{label}: the batch's row mask is not one per problem")
    alphap, betap = kops.pad_tile_inputs(x[:, :m_pad], x[:, m_pad:], pp)
    mask = kops._padded_mask(row_mask, pp)
    kw = dict(num_groups=pp.L_pad, group_size=pp.g)
    if isinstance(pp, kops.FactorizedProblem):
        name, cost = K4, pp.leaves()
        got = screen.snapshot_norms_fact_batched(alphap, betap, *cost, mask, tile_l=pp.tile_l,
                                                 tile_n=pp.tile_n, **kw)
        want = screen.snapshot_norms_fact_ref(alphap, betap, *cost, mask, **kw)
    else:
        name = K4D
        got = screen.snapshot_norms_dense_batched(alphap, betap, pp.Cp, mask, tile_l=pp.tile_l,
                                                  tile_n=pp.tile_n, **kw)
        want = screen.snapshot_norms_dense_ref(alphap, betap, pp.Cp, mask, **kw)
    sync()
    differ = sum(int((g != w).sum()) for g, w in zip(got, want))
    print(f"{label}: {name} with a ({mask.shape[0]}, {mask.shape[1]}) row mask (mask stride "
          f"{mask.shape[1]}) against its plain version on {tuple(alphap.shape)} duals: "
          f"{differ} of {3 * got[0].numel()} outputs differ (bitwise)", flush=True)
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"{label}: {name} with a row mask per problem differs from its plain version")


def phase_batch(reg, main_profile, device):
    """``solve_many`` and ``stream`` on four full-width problems, the default plan
    (factorized route, pallas_impl='auto'): three with 10 samples per class and one
    with 12, so the batch carries a row mask per problem through K4's register
    kernel.  Each problem's bits must equal its solo ``Executor.solve``; the
    stream's must equal ``solve_many``'s and its alive count must never rise.
    Then the B = 4 solver call alone: peak memory and a profile, beside phase
    4's B = 1 figures, and K4 at its final duals with the (4, m_pad) mask against
    its plain version, bit for bit.  Returns each solo solve's prints (phase 12 holds
    the sharded solves to them) and the B = 4 call's figures."""
    import torch

    import repro_torch.ot as ot
    from repro_torch.core import solver as slv
    from repro_torch.kernels import _build

    probs = full_width_problems(reg, ((0, 10), (1, 10), (2, 10), (3, 12)))
    ex = ot.compile(probs[0], ot.ExecutionPlan(grad_impl="pallas"), device=device)
    check(all(ex._route(p) == "factorized" for p in probs), "phase 10 left the factorized route")
    t0 = time.perf_counter()
    solo = [ex.solve(p) for p in probs]
    sync()
    t_solo = time.perf_counter() - t0
    prints = [solution_prints(s) for s in solo]
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    many = ex.solve_many(probs)
    sync()
    t_many = time.perf_counter() - t0
    counts = _build.launch_counts()
    stream = ex.stream(probs)
    alive = [info["alive"] for info in stream]
    streamed = stream.solutions()
    for i, (s, m, t) in enumerate(zip(solo, many, streamed)):
        print(f"phase 10 problem {i} (m={probs[i].num_source}, sizes "
              f"{sorted(set(probs[i].group_spec().sizes))}): value {m.value!r}, rounds "
              f"{m.rounds}, n_evals {m.n_evals}; solve_many == solo {same_solution(m, s)}, "
              f"stream == solve_many {same_solution(t, m)}", flush=True)
        check(same_solution(m, s), f"phase 10: solve_many != solo on problem {i}")
        check(same_solution(t, m), f"phase 10: stream != solve_many on problem {i}")
    check(alive == sorted(alive, reverse=True) and alive[-1] == 0,
          f"phase 10: the stream's alive count rose or did not reach 0: {alive}")
    for name in (K1, K4):
        check(counts.get(name, 0) > 0, f"phase 10: solve_many launched no {name}: {counts}")
    check(counts.get(K5, 0) + counts.get(K6, 0) > 0, f"phase 10: no gradient kernel: {counts}")
    stats = ex.stats()
    check(stats["launches"] == 4 + 1 + 1 + len(alive) and stats["problems_solved"] == 12,
          f"phase 10: executor stats {stats}")
    print(f"phase 10: 4 solo solves {t_solo:.3f} s, solve_many {t_many:.3f} s (plan recovery "
          f"included), stream rounds {len(alive)} alive {alive}; launches in solve_many "
          f"{counts}; executor stats {stats}", flush=True)

    # the B = 4 solver call alone, with the Solutions above freed
    del solo, many, streamed, stream, s, m, t
    preps, C, a, b, row_mask, sqrt_g = ex._stack(probs)
    check(tuple(row_mask.shape) == (4, ex.spec.m_pad), "phase 10: the mask is not per problem")
    prob, opts = ex._prob, ex._opts

    def call():
        return slv._solve_batch_impl(C, a, b, row_mask, sqrt_g, prob, opts)

    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    call()
    sync()
    peak = torch.cuda.max_memory_allocated()
    _build.reset_launch_counts()
    out, wall, busy, n_launch, kernels = profile_device(call)
    evals = max(_build.launch_counts().get(K1, 0), 1)   # one K1 launch a batched evaluation
    b1_peak, b1_per_eval, b1 = main_profile
    print(f"phase 10 B = 4 solver call: wall {wall:.4f} s, device busy {busy:.4f} s, idle share "
          f"{1.0 - busy / wall:.4f}, {n_launch} device launches over {evals} batched "
          f"evaluations ({n_launch / evals:.1f} per evaluation; the most any problem took "
          f"{int(out[0].n_evals.max())}), peak device memory {peak - base} B above the {base} B "
          f"held ({(peak - base) / 4 / 1e9:.3f} GB a problem)", flush=True)
    print(f"phase 10 beside phase 4 (B = 1, {MAIN_PATH}): wall {b1['wall_s']:.4f} s, device "
          f"busy {b1['busy_s']:.4f} s, idle share {1.0 - b1['busy_s'] / b1['wall_s']:.4f}, "
          f"{b1_per_eval:.1f} launches per evaluation over {b1['n_evals']} evaluations, peak "
          f"{b1_peak} B", flush=True)
    for key, us, count in kernels[:8]:
        print(f"  {us / 1e3:10.3f} ms  x{count:<6d} {key[:100]}", flush=True)
    check(peak - base < 4 * b1_peak + 2**28,
          f"phase 10: B = 4 peaked {peak - base} B above what was held, over 4 x {b1_peak}")
    check_k4_mask_per_problem("phase 10", out[0].x, slv._prepare_padded(C, prob, opts),
                              row_mask)
    return {"prints": prints, "b4": {"wall_s": wall, "busy_s": busy,
                                     "launches_per_eval": n_launch / evals,
                                     "solve_many_s": t_many}}


# -- phase 11: the serving engine on the card -------------------------------------

def phase_engine(reg, device):
    """``OTServingEngine(reg, SolveOptions(grad_impl='pallas'), max_batch=4)`` on the
    card: six full-width requests (L = 1280, m = n = 12 800: four with 10 samples
    per class, two with 12) share one bucket, so they go through its four slots
    and the slots recycle, with K1, K2/K3 and K4's dense body taking a row mask
    per slot.  Each request must end DONE exactly once, from its slot, with the
    value and duals of its solo ``Executor.solve`` at geometry='dense', bit for
    bit.  After the first tick K4's dense body, on the bucket's slots with their
    row mask per slot, is held bitwise against its plain version (its launch is
    left out of the path's counts).  Then one chaos run at a narrower size (L = 128, m = n = 1280, so it
    costs seconds): ``FaultSpec('nan_cost')`` on one of three requests walks the
    ladder to 'dense' and ends DONE there, and its neighbours keep the bits of a
    run without the fault.  Returns, per request, the served value, rounds and plan
    print and the solo dense solve's dual prints (phase 12 holds the engine on a
    mesh to them)."""
    import logging

    import numpy as np
    import torch

    import repro_torch.ot as ot
    from repro_torch.core.solver import SolveOptions
    from repro_torch.kernels import _build
    from repro_torch.serving import ot_engine
    from repro_torch.serving.policy import RequestStatus
    from repro_torch.utils import faults

    logging.getLogger("repro_torch.ot_serving").setLevel("WARNING")
    duals = {}
    retire = ot_engine._Bucket._retire

    def keep_duals(self, slot, converged, rounds):       # the duals, for the bit check
        x = self.state.lb.x[slot].clone()
        req = retire(self, slot, converged, rounds)
        duals[req.rid] = x
        return req

    ot_engine._Bucket._retire = keep_duals
    try:
        sizes = (10, 10, 12, 10, 12, 10)
        probs = full_width_problems(reg, list(enumerate(sizes, start=4)))
        engine = ot_engine.OTServingEngine(reg, SolveOptions(grad_impl="pallas"), max_batch=4,
                                           device=device)
        reqs = [engine.enqueue(p)[0] for p in probs]
        _build.reset_launch_counts()
        done, ticks, t_admit, extra = [], [], 0.0, {}
        while len(engine.pending) or engine._in_flight():
            t0 = time.perf_counter()
            engine.admit_pending()
            sync()
            t_admit += time.perf_counter() - t0
            live = engine._in_flight()
            before = _build.launch_counts()
            (retired, wall, busy, n_launch, _) = profile_device(engine.tick)
            after = _build.launch_counts()
            port = sum(after.values()) - sum(before.values())
            ticks.append((live, wall, busy, n_launch, port))
            done += retired
            if len(ticks) == 1:          # four live slots, two row masks: K4's dense body
                bucket = next(iter(engine.buckets.values()))
                bucket._operands()
                check_k4_mask_per_problem("phase 11", bucket.state.lb.x, bucket._padded,
                                          bucket.row_mask)
                checked = _build.launch_counts()
                extra = {k: checked[k] - after.get(k, 0) for k in checked}
        # the path's launches, without the comparison's
        counts = {k: c - extra.get(k, 0) for k, c in _build.launch_counts().items()}
    finally:
        ot_engine._Bucket._retire = retire
    for k, (live, wall, busy, n_launch, port) in enumerate(ticks, start=1):
        print(f"phase 11 tick {k}: {live} live slots, {wall:.4f} s, device busy {busy:.4f} s, "
              f"idle share {1.0 - busy / wall:.4f}, {n_launch} device launches ({port} of "
              f"them the port's kernels)", flush=True)
    walls = [t[1] for t in ticks]
    busy = sum(t[2] for t in ticks)
    by_live = {n: [t[1] for t in ticks if t[0] == n] for n in sorted({t[0] for t in ticks})}
    print(f"phase 11: {len(ticks)} ticks, {sum(walls):.3f} s in ticks, admission {t_admit:.3f} "
          f"s (host padding and upload of six 1.05 GB costs, state init); idle share over the "
          f"ticks {1.0 - busy / sum(walls):.4f}; launches per tick "
          f"{sum(t[3] for t in ticks) / len(ticks):.1f} (device), "
          f"{sum(t[4] for t in ticks) / len(ticks):.1f} (the port's kernels); s a tick by live "
          f"slots: " + ", ".join(f"{n}: {np.median(v):.4f} (x{len(v)})"
                                 for n, v in by_live.items()), flush=True)
    print(f"phase 11 launches: {counts}; engine stats {engine.stats()}", flush=True)
    check(len(done) == 6 and sorted(r.rid for r in done) == list(range(6)),
          f"phase 11: {len(done)} requests came back")
    check(all(r.status is RequestStatus.DONE and r.route == "slot" for r in reqs),
          f"phase 11: statuses {[(r.rid, r.status, r.route) for r in reqs]}")
    check(engine.stats()["status"]["DONE"] == 6 and len(engine.buckets) == 1,
          f"phase 11: engine stats {engine.stats()}")
    for name in (K1, K4D):
        check(counts.get(name, 0) > 0, f"phase 11: the engine launched no {name}: {counts}")
    check(counts.get(K2, 0) + counts.get(K3, 0) > 0, f"phase 11: no K2/K3 launch: {counts}")

    plan = ot.ExecutionPlan(grad_impl="pallas", geometry="dense")
    served = {}
    for req, p in zip(reqs, probs):
        sol = ot.compile(p, plan, device=device).solve()
        m_pad = sol.alpha.shape[0]
        ok = (req.value == sol.value and req.rounds == sol.rounds
              and torch.equal(duals[req.rid][:m_pad], sol.alpha)
              and torch.equal(duals[req.rid][m_pad:], sol.beta))
        served[req.rid] = {"value": req.value, "rounds": req.rounds,
                           "plan": fingerprint(torch.from_numpy(req.plan)),
                           "duals": [fingerprint(sol.alpha), fingerprint(sol.beta)]}
        print(f"phase 11 request {req.rid} (m={p.num_source}): value {req.value!r}, rounds "
              f"{req.rounds}, ticks in flight {req.ticks_in_flight}; == solo dense solve "
              f"{ok}", flush=True)
        check(ok, f"phase 11: request {req.rid} differs from its solo solve")
        del sol

    # chaos at L = 128, m = n = 1280
    small = []
    for seed in range(3):
        from repro_torch.data.pipeline import DomainPairConfig, make_domain_pair
        from repro_torch.ot.problem import Problem

        Xs, ys, Xt, _ = make_domain_pair(DomainPairConfig(num_classes=128, samples_per_class=10,
                                                          seed=100 + seed))
        small.append(Problem.from_samples(Xs, ys, Xt, reg))
    runs = {}
    for fault in (False, True):
        eng = ot_engine.OTServingEngine(reg, SolveOptions(grad_impl="pallas"), max_batch=4,
                                        device=device)
        specs = (faults.FaultSpec("nan_cost", rids={1}),) if fault else ()
        with faults.injected(*specs) as registry:
            out = {r.rid: r for r in eng.run(small)}
            fired = list(registry.fired)
        runs[fault] = (out, fired)
    (clean, _), (hit, fired) = runs[False], runs[True]
    bad = hit[1]
    print(f"phase 11 chaos (L=128, m=n=1280): faults fired {fired}; request 1 {bad.status.value} "
          f"via {bad.route} after {bad.attempts} attempts ({bad.error}); value {bad.value!r} "
          f"against the clean run's {clean[1].value!r}", flush=True)
    check(len(fired) == 1 and bad.status is RequestStatus.DONE and bad.route == "dense"
          and bad.attempts == 3, "phase 11 chaos: the poisoned request did not end DONE via dense")
    check(abs(bad.value - clean[1].value) <= 2e-5 * abs(clean[1].value),
          "phase 11 chaos: the dense rung's value is off the slot's by more than rtol 2e-5")
    for rid in (0, 2):
        ok = (hit[rid].status is RequestStatus.DONE and hit[rid].value == clean[rid].value
              and np.array_equal(hit[rid].plan, clean[rid].plan))
        check(ok, f"phase 11 chaos: neighbour {rid} lost its bits")
    return served


# -- phase 12: the same work spread over two ranks --------------------------------

MESH_WORLD = 2
MESH_DIR = os.path.join(HERE, "_archive", "phase12")       # git-ignored
MESH_TIMEOUT_S = 420
# (d)'s plan against phase 4's dense route's: total variation sum |T - T_ref|
# (the plans carry mass 1), and the marginal residual sum |T 1 - a| +
# sum |T^T 1 - b| over the route's.  Readings (PERF.md §6): 0 and 1.0 here at
# full width; up to 9.0e-3 and 1.14 in tests/test_torch_distributed.py, whose
# bound on the variation this shares
MESH_PLAN_TV = 2.5e-2
MESH_RESIDUAL_OVER = 1.5


def write_handoff(handoff: dict, dense_duals: dict) -> None:
    """Phases 4, 10 and 11's results for phase 12's ranks, in ``MESH_DIR``: a later
    ``--mesh-only`` run on this tree (several cards) reads them from there."""
    import torch

    os.makedirs(MESH_DIR, exist_ok=True)
    for name in os.listdir(MESH_DIR):
        os.remove(os.path.join(MESH_DIR, name))
    with open(os.path.join(MESH_DIR, "handoff.json"), "w") as f:
        json.dump(handoff, f)
    torch.save(dense_duals, os.path.join(MESH_DIR, "dense_duals.pt"))


def phase_mesh(smi_line: str) -> None:
    """Two ranks over ``torch.distributed``, spawned from here: NCCL with a card each
    where there are two, else gloo with both on card 0.  Each rank (``mesh_rank``)
    runs (a) ``solve_many`` and (b) ``stream`` with ``ExecutionPlan(grad_impl=
    'pallas', devices='all')`` on phase 10's four problems, each bitwise phase 10's
    solo solve; (c) the engine on the mesh, ``max_batch=2``, on four of phase 11's
    requests, each DONE once with the bits phase 11 gave it; (d)
    ``solve_dual_distributed`` on the main problem's dense cost (m = n = 12 800), on
    a (data=2, model=1) and a (data=1, model=2) mesh with 'pallas' grid and compact,
    within rtol 2e-5 of phase 4's unsharded dense route, its plan within
    ``MESH_PLAN_TV`` of that route's and its marginal residual at most
    ``MESH_RESIDUAL_OVER`` times that route's, every rank's duals equal.  The
    phases' results come through ``write_handoff``'s files; every rank's result
    must agree."""
    import socket

    import torch

    with open(os.path.join(MESH_DIR, "handoff.json")) as f:
        handoff = json.load(f)
    for name in os.listdir(MESH_DIR):
        if name.startswith("rank"):
            os.remove(os.path.join(MESH_DIR, name))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.empty_cache()               # the ranks may share this card
    cards = torch.cuda.device_count()
    print(f"phase 12: backend {'nccl' if cards >= MESH_WORLD else 'gloo'}, world size "
          f"{MESH_WORLD} ({'a card each' if cards >= MESH_WORLD else 'both ranks on card 0'})",
          flush=True)
    procs = []
    t0 = time.perf_counter()
    try:
        for r in range(MESH_WORLD):
            log = open(os.path.join(MESH_DIR, f"rank{r}.log"), "w")
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
                 "--mesh-init", f"tcp://127.0.0.1:{port}"],
                stdout=log, stderr=subprocess.STDOUT))
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break                          # one rank failed: stop the others
            if time.perf_counter() - t0 > MESH_TIMEOUT_S:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r in range(len(procs)):
        with open(os.path.join(MESH_DIR, f"rank{r}.log")) as f:
            for line in f.read().splitlines()[-200:]:
                print(f"  [rank {r}] {line}", flush=True)
    rcs = [p.returncode for p in procs]
    check(all(rc == 0 for rc in rcs), f"phase 12: the ranks exited {rcs} after {wall:.1f} s "
                                      f"(limit {MESH_TIMEOUT_S} s)")
    res = []
    for r in range(MESH_WORLD):
        with open(os.path.join(MESH_DIR, f"rank{r}.json")) as f:
            res.append(json.load(f))
    for key in ("a_prints", "c_served", "d_x"):
        check(all(x[key] == res[0][key] for x in res), f"phase 12: the ranks disagree on {key}")
    b4 = handoff["batch"]["b4"]
    print(f"phase 12 ({res[0]['backend']}, world size {MESH_WORLD}; {smi_line}): {wall:.1f} s "
          f"with the ranks' start; beside phase 10's single-rank B = 4 solver call (wall "
          f"{b4['wall_s']:.4f} s, device busy {b4['busy_s']:.4f} s, idle share "
          f"{1.0 - b4['busy_s'] / b4['wall_s']:.4f}, {b4['launches_per_eval']:.1f} launches per "
          f"evaluation; solve_many {b4['solve_many_s']:.3f} s):", flush=True)
    for r, x in enumerate(res):
        print(f"phase 12 rank {r}: " + "; ".join(f"{k} {v}" for k, v in x["figures"].items()),
              flush=True)


def mesh_rank(rank: int, init: str) -> None:
    """One rank of phase 12 (see ``phase_mesh``); exits non-zero on any failed check."""
    import logging

    import numpy as np
    import torch

    import repro_torch.ot as ot
    from repro_torch.core import distributed as D
    from repro_torch.core import sharded as shd
    from repro_torch.core import solver as slv
    from repro_torch.core.dual import DualProblem, plan_from_duals
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving import ot_engine
    from repro_torch.serving.policy import RequestStatus

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    logging.getLogger("repro_torch.ot_serving").setLevel("WARNING")
    backend, device = D.init_process_group(MESH_WORLD, rank, init, timeout_s=300)
    say = lambda msg: print(f"[{time.perf_counter() - t_start:.1f} s] {msg}", flush=True)
    say(f"phase 12: backend {backend}, world size {MESH_WORLD}, rank {rank} on {device} "
        f"({torch.cuda.get_device_name(device)}; {torch.cuda.device_count()} card(s) visible)")
    with open(os.path.join(MESH_DIR, "handoff.json")) as f:
        handoff = json.load(f)
    figures = {}
    norm = lambda x: json.loads(json.dumps(x))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def profiled(fn):
        """profile_device(fn); where the profiler does not start on this rank (a
        second process tracing the card), fn runs without it and busy and idle
        read 'not measured'.  A fault of fn propagates."""
        return profile_device(fn, untraced=lambda e: say(
            f"phase 12: torch.profiler did not start on rank {rank} ({e}); busy not measured"))

    def lapped(laps, obj, name):
        """Wrap ``obj.name`` so each call adds its synchronized seconds to
        ``laps[name]``; returns the restore."""
        real = getattr(obj, name)

        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return real(*args, **kw)
            finally:
                torch.cuda.synchronize()
                laps[name] = laps.get(name, 0.0) + time.perf_counter() - t0

        setattr(obj, name, run)
        return lambda: setattr(obj, name, real)

    def busy_text(wall, busy, n_launch, evals, rows):
        """The rank's own device work; NCCL's kernels apart: they run on their own
        stream and wait on the card for the other rank, so they are not its work."""
        if busy is None:
            return f"wall {wall:.4f} s, device busy not measured"
        nccl = [r for r in rows if "nccl" in r[0].lower()]
        comm = sum(r[1] for r in nccl) / 1e6
        busy, n_launch = busy - comm, n_launch - sum(r[2] for r in nccl)
        return (f"wall {wall:.4f} s, device busy {busy:.4f} s, idle share "
                f"{1.0 - busy / wall:.4f}, {n_launch / evals:.1f} launches per evaluation, "
                f"NCCL kernels {comm:.4f} s in {sum(r[2] for r in nccl)} launches")

    def kernels_ran(label, counts, names, any_of=()):
        for name in names:
            check(counts.get(name, 0) > 0, f"{label}: rank {rank} launched no {name}: {counts}")
        if any_of:
            check(sum(counts.get(k, 0) for k in any_of) > 0,
                  f"{label}: rank {rank} launched none of {any_of}: {counts}")

    reg, problem = main_problem()
    say("phase 12: the problems are built")

    # (a) solve_many, (b) stream: phase 10's problems over the mesh
    probs = full_width_problems(reg, ((0, 10), (1, 10), (2, 10), (3, 12)))
    ex = ot.compile(probs[0], ot.ExecutionPlan(grad_impl="pallas", devices="all"))
    check(ex.mesh.size() == MESH_WORLD and ex.device == device,
          f"phase 12: mesh {ex.mesh}, device {ex.device}")
    _build.reset_launch_counts()
    D.reset_collective_counts()
    laps = {}
    restore = [lapped(laps, ex, "_stack_block"), lapped(laps, slv, "_solve_batch_impl"),
               lapped(laps, shd, "gather_result"), lapped(laps, ex, "_wrap_sharded")]
    try:
        many, t_many = timed(lambda: ex.solve_many(probs))
    finally:
        for undo in restore:
            undo()
    counts, comm = _build.launch_counts(), D.collective_counts()
    got = norm([solution_prints(s) for s in many])
    for i, (g_, w_) in enumerate(zip(got, handoff["batch"]["prints"])):
        say(f"phase 12 (a) problem {i}: value {g_[0][0]!r}, rounds {g_[0][1]}; == phase 10's "
            f"solo solve {g_ == w_}")
        check(g_ == w_, f"phase 12 (a): problem {i} differs from its solo solve on rank {rank}")
    kernels_ran("phase 12 (a)", counts, (K1, K4), (K5, K6))
    split = (f"lowering and upload of the rank's block {laps['_stack_block']:.3f} s, its solve "
             f"{laps['_solve_batch_impl']:.3f} s, the final gather (with the wait for the "
             f"slower rank) {laps['gather_result']:.3f} s, four plan recoveries "
             f"{laps['_wrap_sharded']:.3f} s")
    say(f"phase 12 (a) solve_many: {t_many:.3f} s: {split}; launches {counts}; "
        f"collectives {comm}")
    del many
    stream = ex.stream(probs)
    (alive, streamed), t_stream = timed(lambda: ([i["alive"] for i in stream],
                                                 stream.solutions()))
    check(norm([solution_prints(s) for s in streamed]) == got,
          f"phase 12 (b): stream != solve_many on rank {rank}")
    check(alive == sorted(alive, reverse=True) and alive[-1] == 0,
          f"phase 12 (b): alive {alive}")
    say(f"phase 12 (b) stream: {t_stream:.3f} s, rounds {len(alive)}, alive {alive}; == (a) True")
    del streamed, stream
    lo, preps, C, a, b, rm, sg = ex._stack_block(probs)
    _build.reset_launch_counts()
    out, wall, busy, n_launch, rows = profiled(
        lambda: slv._solve_batch_impl(C, a, b, rm, sg, ex._prob, ex._opts))
    evals = max(_build.launch_counts().get(K1, 0), 1)
    figures["(a) B = 2 block solver call"] = (busy_text(wall, busy, n_launch, evals, rows)
                                              + f" over {evals} batched evaluations")
    figures["(a) solve_many s"] = f"{t_many:.3f} ({split})"
    figures["(b) stream s"] = f"{t_stream:.3f}"
    del out, C, a, b, rm, sg, preps, ex
    torch.cuda.empty_cache()
    say("phase 12 (a), (b) done")

    # (c) the engine on the mesh: four of phase 11's requests, max_batch = 2
    duals, retire = {}, ot_engine._Bucket._retire

    def keep_duals(self, slot, converged, rounds):
        if self.owns(slot):
            x = self.state.lb.x[self.slot_placement(slot)[1]]
            duals[self.slots[slot].rid] = [fingerprint(x[: self.prob.m_pad]),
                                           fingerprint(x[self.prob.m_pad:])]
        return retire(self, slot, converged, rounds)

    ot_engine._Bucket._retire = keep_duals
    try:
        reqs = full_width_problems(reg, list(enumerate((10, 10, 12, 10), start=4)))
        engine = ot_engine.OTServingEngine(reg, slv.SolveOptions(grad_impl="pallas"),
                                           max_batch=2, mesh=D.make_batch_mesh())
        _build.reset_launch_counts()
        done, t_engine = timed(lambda: engine.run(reqs))
        counts = _build.launch_counts()
    finally:
        ot_engine._Bucket._retire = retire
    check(sorted(r.rid for r in done) == [0, 1, 2, 3], f"phase 12 (c): {len(done)} came back")
    served = {}
    for req in done:
        want = handoff["engine"][str(req.rid)]
        plan = fingerprint(torch.from_numpy(req.plan))
        ok = (req.status is RequestStatus.DONE and req.route == "slot"
              and req.value == want["value"] and req.rounds == want["rounds"]
              and plan == want["plan"] and duals.get(req.rid, want["duals"]) == want["duals"])
        say(f"phase 12 (c) request {req.rid}: {req.status.value} via {req.route}, value "
            f"{req.value!r}, rounds {req.rounds}, ticks in flight {req.ticks_in_flight}"
            f"{', duals held here' if req.rid in duals else ''}; == phase 11 {ok}")
        check(ok, f"phase 12 (c): request {req.rid} differs from phase 11 on rank {rank}")
        served[req.rid] = [req.value, req.rounds, plan]
    check(len(duals) == 2, f"phase 12 (c): rank {rank} held {sorted(duals)}, not two slots")
    kernels_ran("phase 12 (c)", counts, (K1, K4D), (K2, K3))
    st = engine.stats()
    figures["(c) engine"] = (f"{t_engine:.3f} s, {st['ticks']} ticks, {st['launches']} solver "
                             f"calls on this rank, statuses {st['status']}")
    del engine, reqs, done
    torch.cuda.empty_cache()

    # (d) one problem over a 2-D mesh: the main problem's dense cost
    pa = problem.padded()
    ref = torch.load(os.path.join(MESH_DIR, "dense_duals.pt"))
    C_dev = torch.from_numpy(pa.C).to(device)
    a_dev, b_dev = (torch.from_numpy(np.asarray(v, np.float32)).to(device) for v in (pa.a, pa.b))
    prob = DualProblem(pa.spec.num_groups, pa.spec.group_size, int(pa.C.shape[1]), reg)
    m_pad = int(pa.C.shape[0])

    def plan_of(alpha, beta):
        """(plan, its marginal residual sum |T 1 - a| + sum |T^T 1 - b|) on the card."""
        T = plan_from_duals(alpha[:m_pad].to(device), beta.to(device), C_dev, prob)
        return T, float(torch.sum(torch.abs(T.sum(1) - a_dev))
                        + torch.sum(torch.abs(T.sum(0) - b_dev)))

    say("phase 12 (d): the dense cost is padded and on the card")
    d_x = {}
    for shape in ((2, 1), (1, 2)):
        mesh = make_host_mesh(*shape)
        for impl in ("grid", "compact"):
            opts = slv.SolveOptions(grad_impl="pallas", pallas_impl=impl)
            _build.reset_launch_counts()
            res, wall, busy, n_launch, rows = profiled(lambda: D.solve_dual_distributed(
                pa.C, pa.a, pa.b, pa.spec, reg, mesh, opts))
            counts = _build.launch_counts()
            want = handoff["dense"][impl]
            value = float(res.value)
            rel = abs(value - want) / abs(want)
            xs = D.all_gather_objects(fingerprint(res.lbfgs_state.x), mesh)
            label = f"phase 12 (d) data={shape[0]} model={shape[1]} {impl}"
            say(f"{label}: value {value!r} against phase 4's dense/{impl} {want!r} (rel "
                f"{rel:.2e}), rounds {res.rounds}, {res.comm['evaluations']} evaluations, "
                f"{res.comm['bytes_per_evaluation']:.0f} collective bytes per evaluation "
                f"(4 x (m_pad + n + 2) = {4 * (pa.C.shape[0] + pa.C.shape[1] + 2)}), "
                f"every rank's duals equal {len(set(xs)) == 1}; "
                f"{busy_text(wall, busy, n_launch, res.comm['evaluations'], rows)}; {counts}")
            T, resid = plan_of(res.alpha, res.beta)
            T_ref, resid_ref = plan_of(*ref[impl])
            tv = float(torch.sum(torch.abs(T - T_ref)))
            del T, T_ref
            say(f"{label}: plan against phase 4's dense/{impl}: total variation {tv:.3e} "
                f"(bound {MESH_PLAN_TV:.1e}), marginal residual {resid:.3e} against the "
                f"route's {resid_ref:.3e} (bound {MESH_RESIDUAL_OVER:.1f} x)")
            check(rel <= 2e-5, f"{label}: off the unsharded dense route by {rel:.2e}")
            check(tv <= MESH_PLAN_TV, f"{label}: plan {tv:.3e} off the dense route's")
            check(resid <= MESH_RESIDUAL_OVER * resid_ref,
                  f"{label}: marginal residual {resid:.3e} over {MESH_RESIDUAL_OVER} x "
                  f"{resid_ref:.3e}")
            check(len(set(xs)) == 1, f"{label}: the ranks' duals differ")
            check(res.comm["bytes_per_evaluation"] <= 4 * (pa.C.shape[0] + pa.C.shape[1] + 16),
                  f"{label}: {res.comm}")
            kernels_ran(label, counts, (K1, K4D), (K2, K3))
            d_x[f"{shape}/{impl}"] = xs[0]
            figures[f"(d) {shape[0]}x{shape[1]} {impl}"] = (
                busy_text(wall, busy, n_launch, res.comm["evaluations"], rows)
                + f", {res.comm['bytes_per_evaluation']:.0f} collective B per evaluation, "
                f"plan TV {tv:.3e}, residual {resid:.3e} (route {resid_ref:.3e})")
    import torch.distributed as dist

    dist.barrier()
    with open(os.path.join(MESH_DIR, f"rank{rank}.json"), "w") as f:
        json.dump({"backend": backend, "a_prints": got, "c_served": norm(served),
                   "d_x": d_x, "figures": figures}, f)
    dist.destroy_process_group()
    say("phase 12: done")


# -- phase 13: the LM trainer with the OT alignment loss -----------------------------

LM_ARCH = "smollm-135m"
LM_PARAMS = 134_515_008              # its parameter count (the JAX abstract init's)
LM_STEPS = 12
LM_SEQ, LM_BATCH, LM_CLASSES = 128, 64, 8
LM_RESTART_LAYERS = 2                # the restart check's depth cut (PERF.md §4)
LM_SPLIT_STEPS = 3                   # steps timed piece by piece after the run
LM_DIR = os.path.join(HERE, "_archive", "phase13")         # git-ignored: the restart's files
LM_ROW = "@lm_step"                  # suffix of the kernel rows at the trainer's shapes


def lm_trainer(cfg, grad_impl: str, steps: int, device, ckpt=None):
    """The trainer of phase 13: ``SyntheticLM(vocab, 128, 64, 8 classes, seed 0)``, AdamW
    at lr 6e-4 (warmup 2, decay over 12 steps), remat per block, the OT alignment loss
    (weight 0.05, L-BFGS) on ``grad_impl``; a checkpoint every 3 steps into ``ckpt``."""
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.data.pipeline import SyntheticLM, SyntheticLMConfig
    from repro_torch.training.trainer import Trainer

    tcfg = TrainConfig(optimizer=OptimizerConfig(lr=6e-4, warmup_steps=2, decay_steps=LM_STEPS),
                       steps=steps, log_every=1, checkpoint_every=3, ot_align=True,
                       ot_align_weight=0.05, ot_solver="lbfgs", ot_grad_impl=grad_impl,
                       remat="block")
    data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=LM_SEQ,
                                         global_batch=LM_BATCH, num_classes=LM_CLASSES, seed=0))
    return Trainer(cfg, tcfg, data, ckpt_dir=ckpt, device=device)


def lm_ot_operands(tr, batch, device):
    """The OT problem of ``batch`` as the trainer's layer solves it at the current
    parameters: (the tile-padded FactorizedProblem, duals padded to its grid, its row
    mask, the regularizer, the solve's result)."""
    import torch

    from repro_torch.core import solver as slv
    from repro_torch.kernels import ops as kops
    from repro_torch.ot import diff
    from repro_torch.training import losses

    tcfg = tr.tcfg
    with torch.no_grad():
        h_src, h_tgt, L, g = tr.ot_inputs(batch)
        layer = losses._alignment_layer(L, g, int(h_tgt.shape[0]), tcfg.ot_gamma, tcfg.ot_rho,
                                        60, tcfg.ot_solver, "pallas", device)
        xs, x_sq, ys, y_sq, _ = diff._scaled_factors(layer, h_src.float(), h_tgt.float())
        a, b = layer._marginals(None, None)
        fc = kops.FactorizedCost(xs, x_sq, ys, y_sq)
        res = slv.solve_dual(fc, a, b, layer.spec(), layer.reg, layer.plan.solve_options(),
                             device)
        fp = kops.prepare_factorized_problem(fc.map(lambda t: t[None]), layer.dual_problem())
        alphap, betap = kops.pad_tile_inputs(res.alpha[None], res.beta[None], fp)
        row_mask = torch.as_tensor(layer.spec().row_mask().reshape(-1), device=device)
    return fp, alphap, betap, kops._padded_mask(row_mask, fp), layer.reg, res


def phase_lm_kernels(fp, a, b, mask, reg, counts, smi_line, device, phase="phase 13",
                     suffix=LM_ROW, plain_runs=3):
    """K1, K4, K5, K6 and K8 at a trainer's step-0 OT operands (phase 13: L_pad 8, g 4,
    n_pad 128, d 576; phase 15: d 2560; the chunked loader and K4's FactCost body), on the
    solve's duals, each held to its plain version as ``phase_kernels_wide_d`` holds them at
    d = 64, then timed (CUDA events; device us from the profiler's records) beside its
    bound and its plain version (the median of ``plain_runs``).  ``counts`` is {kernel:
    (the path, its launches there)}.  Returns the kernel-table rows."""
    import numpy as np
    import torch

    from repro_torch.kernels import gradpsi as kg
    from repro_torch.kernels import screen as ks

    L_pad, g, n_pad, d = fp.L_pad, fp.g, fp.n_pad, fp.d
    check((fp.tile_l, fp.tile_n) == (TILE_L, TILE_N), f"{phase} tiles {fp.tile_l} x {fp.tile_n}")
    dc = kg.fact_loader_dc(TILE_L, g, TILE_N, d)
    check(0 < dc < d, f"d = {d} should take the chunked loader, got dc = {dc}")
    loaders = {st: kg.fact_loader(TILE_L, g, TILE_N, d, size)
               for st, size in (("f32", 4), ("bf16", 2))}
    check(all(dcg[0] == 32 for dcg in loaders.values()),
          f"{phase}: d = {d} should load 32-column chunks: fact_loader (dc, gb) {loaders}")
    leaves = fp.leaves()
    tp = torch.full((L_pad,), float(reg.tau), dtype=torch.float32, device=device)
    kw = dict(num_groups=L_pad, group_size=g, tau=tp, gamma=reg.gamma, tile_l=TILE_L,
              tile_n=TILE_N)
    skw = dict(num_groups=L_pad, group_size=g, tile_l=TILE_L, tile_n=TILE_N)
    C = kg.factorized_cost_tile(*leaves)
    rng = np.random.default_rng(13)
    errs = []
    for share in (0.0, 1.0):
        flags = torch.full((1, L_pad // TILE_L, n_pad // TILE_N), int(share), dtype=torch.int32,
                           device=device)
        inp = kernel_inputs(rng, C, L_pad, float(reg.tau), share, device)
        sargs = screen_args(inp)
        v1, f1 = ks.screen_batched(*sargs, tau=tp, tile_l=TILE_L, tile_n=TILE_N,
                                   emit_verdict=True)
        v1p, f1p = ks.screen_batched_ref(*sargs, tau=tp, tile_l=TILE_L, tile_n=TILE_N)
        check(torch.equal(v1, v1p) and torch.equal(f1, f1p),
              f"K1 at the trainer's shapes (share {share}) differs from its plain version")
        for storage in ("f32", "bf16"):
            lv = leaves if storage == "f32" else tuple(v.bfloat16() for v in leaves)
            at = f"at d = {d} (share {share}, {storage})"
            k5 = kg.gradpsi_fact_batched(a, b, *lv, flags, **kw)
            ref = kg.gradpsi_fact_batched_ref(a, b, *lv, flags, **kw)
            errs.append(max(float((p - q).abs().max()) for p, q in zip(k5, ref)))
            check(all(torch.allclose(p, q, rtol=1e-5, atol=1e-6) for p, q in zip(k5, ref)),
                  f"K5 {at} off its plain version: max abs err {errs[-1]:.3e}")
            sched, nact = kg.build_batch_tile_schedule(flags)
            k6 = kg.gradpsi_fact_compact_batched(a, b, *lv, sched, nact, **kw)
            k2 = kg.gradpsi_batched(a, b, kg.factorized_cost_tile(*lv), flags, **kw)
            check(same(k5, k2) and same(k6[:3], k5),
                  f"K5/K6 {at} not bitwise equal to K2 on the cost")
            k8 = kg.gradpsi_fused_fact_batched(a, b, *lv, *sargs, **kw)
            k5f = kg.gradpsi_fact_batched(a, b, *lv, f1, **kw)
            check(torch.equal(k8[3], f1) and same(k8[:3], k5f),
                  f"K8 {at} not K1's flags and K5's sums bit for bit")
            k4 = ks.snapshot_norms_fact_batched(a, b, *lv, mask, **skw)
            k4p = ks.snapshot_norms_fact_ref(a, b, *lv, mask, num_groups=L_pad, group_size=g)
            check(same(k4, k4p), f"K4 {at} differs from its plain version")
    print(f"{phase} kernels @ the trainer's step-0 OT operands (B = 1, L_pad = {L_pad}, g = "
          f"{g}, n_pad = {n_pad}, d = {d}: {-(-d // dc)} chunks of {dc}, fact_loader (dc, gb) "
          f"{loaders}; the solve's duals; f32 and bf16): K5 max abs err {max(errs):.3e} (rtol 1e-5, atol "
          f"1e-6), K5 == K2 and K6 == K5 bitwise, K1 == plain, K8 == K1's flags and K5's sums "
          f"bitwise (live shares 0 and 1), K4 == plain bitwise", flush=True)

    # times at the live state (the one tile live), beside bound and plain version
    flags = torch.ones((1, 1, 1), dtype=torch.int32, device=device)
    sched, nact = kg.build_batch_tile_schedule(flags)
    sargs = screen_args(inp)                # share 1.0: K1 and K8 find the tile live
    fns = {
        K1: (lambda: ks.screen_batched(*sargs, tau=tp, tile_l=TILE_L, tile_n=TILE_N,
                                       emit_verdict=False),
             lambda: ks.screen_batched_ref(*sargs, tau=tp, tile_l=TILE_L, tile_n=TILE_N)),
        K4: (lambda: ks.snapshot_norms_fact_batched(a, b, *leaves, mask, **skw),
             lambda: ks.snapshot_norms_fact_ref(a, b, *leaves, mask, num_groups=L_pad,
                                                group_size=g)),
        K5: (lambda: kg.gradpsi_fact_batched(a, b, *leaves, flags, **kw),
             lambda: kg.gradpsi_fact_batched_ref(a, b, *leaves, flags, **kw)),
        K6: (lambda: kg.gradpsi_fact_compact_batched(a, b, *leaves, sched, nact, **kw),
             lambda: kg.gradpsi_fact_compact_batched_ref(a, b, *leaves, sched, nact, **kw)),
        K8: (lambda: kg.gradpsi_fused_fact_batched(a, b, *leaves, *sargs, **kw),
             lambda: kg.gradpsi_fused_fact_batched_ref(a, b, *leaves, *sargs, **kw)),
    }
    work = kernel_work(fp, d, 1, 1, int(torch.count_nonzero(mask)))
    rows = []
    for name, (fn, plain) in fns.items():
        got, want = fn(), plain()
        if name == K1:
            got, want = (got[1].float(),), (want[1].float(),)
        err, rel = max_errs(got[:3], want[:3])
        ms = median_ms(fn, 50)
        plain_ms = median_ms(plain, plain_runs, warmup=1)
        split = device_split(fn)
        # None where the profiler kept no record of the kernel in the session
        dev_us = sum(split.values()) if any(v > 0 for v in split.values()) else None
        bms, by = bound(*work[name])
        path, count = counts[name]
        source, replaces = SOURCES[name]
        rows.append({"name": name + suffix, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": count, "launches_path": path,
                     "max_abs_err": err, "max_rel_err": rel, "ms": ms, "device_us": dev_us,
                     "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None,
                     "check": f"{phase}: held to the plain version as at d = 64",
                     "result": "pass"})
        dev = "not recorded by the profiler" if dev_us is None else f"{dev_us:.2f} us"
        print(f"time {name}{suffix} ({smi_line}): {ms:.4f} ms a call, device {dev} (bound "
              f"{bms:.6f} ms by {by}), plain {plain_ms:.4f} ms, max abs err {err:.3e}; "
              f"launches on {path}: {count}", flush=True)
    return rows


def print_split_steps(phase, tr, first, n, smi_line):
    """Time ``n`` steps of ``tr`` on batches ``first``, ``first + 1``, ... piece by piece
    (each piece of ``tr.step_fn`` ending in a synchronize) and print the medians."""
    import statistics

    def split_step(batch):
        marks = [("start", time.perf_counter())]
        tr.step_fn(batch, mark=lambda piece: (sync(), marks.append((piece, time.perf_counter()))))
        return {p: t - marks[i][1] for i, (p, t) in enumerate(marks[1:])}

    splits = [split_step(tr.batch(first + i)) for i in range(n)]
    print(f"{phase} step split (median of {n}, {smi_line}): "
          + ", ".join(f"{p} {statistics.median(r[p] for r in splits):.4f} s" for p in splits[0])
          + f"; total {statistics.median(sum(r.values()) for r in splits):.4f} s", flush=True)


def phase_lm(smi_line, device):
    """The LM trainer of the port on the card (see the module docstring, phase 13).
    Returns the kernel-table rows at the trainer's shapes."""
    import dataclasses
    import math
    import shutil
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build as kbuild
    from repro_torch.models.common import count_params
    from repro_torch.ot import diff

    t_phase = time.perf_counter()

    def lap13(what):
        print(f"[phase 13 +{time.perf_counter() - t_phase:.1f} s] {what}", flush=True)

    cfg = get_config(LM_ARCH)
    # The restart check runs under torch.use_deterministic_algorithms (the
    # backward of the embedding gathers accumulates with atomics otherwise), with
    # no NaN fill of every torch.empty (the mode's default: the kernels read only
    # memory the call wrote, ROADMAP queue C).  The mode costs a tenth to a third
    # of a step (PERF.md §5), so the timed run and the fused check (a forward, no
    # atomics) go without it.
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        tr = lm_trainer(cfg, "pallas", LM_STEPS, device)
        n_params = count_params(tr.model)
        check(n_params == LM_PARAMS, f"{LM_ARCH} has {n_params} parameters, not {LM_PARAMS}")
        check(next(tr.model.parameters()).dtype == torch.bfloat16, "the params are not bf16")
        ops = lm_ot_operands(tr, tr.batch(0), device)
        lap13("the trainer is built")
        sync()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        kbuild.reset_launch_counts()
        diff.reset_solve_count()
        t0 = time.perf_counter()
        tr.run()
        sync()
        wall = time.perf_counter() - t0
        launches = kbuild.launch_counts()
        solves = diff.solve_count()
        peak = torch.cuda.max_memory_allocated()
        hist = tr.metrics_history
        durations = list(tr.watchdog.window)
        losses = [m["loss"] for m in hist]
        dists = [m["ot_distance"] for m in hist]
        print(f"phase 13 {LM_ARCH} ({n_params} params, {cfg.num_layers} layers, d_model "
              f"{cfg.d_model}, bf16) {LM_STEPS} steps of {LM_BATCH} x {LM_SEQ} tokens, "
              f"ot_align (pallas, L = {LM_CLASSES}, g = {ops[0].g}, n = {ops[0].n}, d = "
              f"{ops[0].d}): loss {losses}; ce {[m['ce'] for m in hist]}; ot_distance {dists}",
              flush=True)
        check(len(hist) == LM_STEPS and all(math.isfinite(v) for v in losses + dists),
              f"phase 13: a loss or OT distance is not finite: {losses} {dists}")
        check(all(v > 0 for v in dists), f"phase 13: an OT distance is not positive: {dists}")
        check(losses[-1] < losses[0], f"phase 13: the loss did not fall: {losses}")
        check(solves == LM_STEPS, f"phase 13 ran {solves} OT solves in {LM_STEPS} steps")
        check(launches.get(K1, 0) > 0 and launches.get(K4, 0) > 0
              and launches.get(K5, 0) + launches.get(K6, 0) > 0,
              f"phase 13: the trainer did not launch K1, K4 and K5 or K6: {launches}")
        per_step = {k: v / LM_STEPS for k, v in sorted(launches.items())}
        med = statistics.median(durations[1:])
        print(f"phase 13 ({smi_line}): {wall:.3f} s for {LM_STEPS} steps; step wall median "
              f"{med:.4f} s (steps 1-{LM_STEPS - 1}; step 0 {durations[0]:.4f} s), "
              f"{LM_BATCH * LM_SEQ / med:.1f} tokens/s; peak device memory {peak} B ({base} B "
              f"held before); OT kernel launches per step {per_step}", flush=True)
        lap13(f"{LM_STEPS} steps")

        print_split_steps("phase 13", tr, LM_STEPS, LM_SPLIT_STEPS, smi_line)
        lap13("split steps")

        s0 = LM_STEPS + LM_SPLIT_STEPS
        _, pwall, busy, n_dev, krows = profile_device(lambda: tr.step_fn(tr.batch(s0)))
        check(busy > 0, "phase 13: the profiler recorded no device time")
        print(f"phase 13 profile (1 step, torch.profiler, the device's own records, "
              f"{smi_line}): wall {pwall:.4f} s, device busy {busy:.4f} s, idle share "
              f"{1 - busy / pwall:.4f}, {n_dev} device launches per step; largest: "
              + ", ".join(f"{k[:48]} {us / 1e3:.2f} ms x{c}" for k, us, c in krows[:8]),
              flush=True)
        lap13("profile")
        del tr

        # fused: the same init and data, 3 steps; step 0's OT distance bit for bit pallas's
        kbuild.reset_launch_counts()
        trf = lm_trainer(cfg, "fused", 3, device)
        trf.run()
        fused_launches = kbuild.launch_counts()
        fd = trf.metrics_history[0]["ot_distance"]
        check(fd == dists[0], f"phase 13: fused step-0 OT distance {fd!r} != pallas {dists[0]!r}")
        check(fused_launches.get(K8, 0) + fused_launches.get(K6, 0) > 0,
              f"phase 13: the fused run launched no K8 or K6: {fused_launches}")
        print(f"phase 13 fused (3 steps): step-0 ot_distance {fd!r} == pallas bit for bit; "
              f"losses {[m['loss'] for m in trf.metrics_history]}; launches {fused_launches}",
              flush=True)
        del trf
        lap13("fused")

        counts = {k: (f"phase 13 {LM_ARCH} trainer, {LM_STEPS} steps, grad_impl 'pallas'",
                      launches.get(k, 0)) for k in (K1, K4, K5, K6)}
        counts[K8] = (f"phase 13 {LM_ARCH} trainer, 3 steps, grad_impl 'fused'",
                      fused_launches.get(K8, 0))
        rows = phase_lm_kernels(*ops[:5], counts, smi_line, device)
        del ops
        lap13("kernels")

        # restart: full width, 2 layers; save at step 3, resume to 6 == 6 uninterrupted
        torch.use_deterministic_algorithms(True)
        cfg2 = dataclasses.replace(cfg, num_layers=LM_RESTART_LAYERS)
        shutil.rmtree(LM_DIR, ignore_errors=True)
        t0 = time.perf_counter()
        first = lm_trainer(cfg2, "pallas", 6, device, ckpt=LM_DIR)
        first.run(3)
        check(first.ckpt.latest_step() == 3, "phase 13: no checkpoint at step 3")
        ckpt_bytes = sum(os.path.getsize(os.path.join(LM_DIR, "step_00000003", f))
                         for f in os.listdir(os.path.join(LM_DIR, "step_00000003")))
        del first
        resumed = lm_trainer(cfg2, "pallas", 6, device, ckpt=LM_DIR)
        check(resumed.start_step == 3, f"phase 13: resumed at {resumed.start_step}, not 3")
        resumed.run()
        whole = lm_trainer(cfg2, "pallas", 6, device)
        whole.run()
        same_params = all(torch.equal(p, resumed.state["params"][k])
                          for k, p in whole.state["params"].items())
        same_opt = all(torch.equal(t, resumed.state["opt"][kind][k])
                       for kind in ("m", "v", "master")
                       for k, t in whole.state["opt"][kind].items())
        tail = [m for m in whole.metrics_history if m["step"] >= 3]
        check(same_params and same_opt and tail == resumed.metrics_history,
              "phase 13: the resumed run differs from the uninterrupted one")
        print(f"phase 13 restart ({LM_RESTART_LAYERS} layers, full width; checkpoint "
              f"{ckpt_bytes} B): saved at 3, resumed to 6 == 6 uninterrupted, bit for bit "
              f"(params, m, v, master, metrics; under use_deterministic_algorithms) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        shutil.rmtree(LM_DIR, ignore_errors=True)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
    print(f"phase 13 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows


# -- phase 14: LM serving and the MoE family with the OT router ------------------------

SERVE_SLOTS = 4
SERVE_DENSE = dict(requests=8, prompt=64, new=32, max_len=104)     # (a) smollm-135m
SERVE_MOE_ARCH = "qwen2-moe-a2.7b"
SERVE_MOE_PARAMS = 14_315_636_736    # its parameter count (the JAX abstract init's)
SERVE_MOE = dict(requests=6, prompt=32, new=16, max_len=56)        # (b); (c) with 8 new
SERVE_OT_LAYERS = 1                  # (c)'s depth cut, for the smoke's time (PERF.md §4)
SERVE_OT = dict(SERVE_MOE, new=8)    # (c)'s requests: 8 new tokens each, for the smoke's
                                     # time (PERF.md §4)
SERVE_TF_STEPS = 8                   # teacher-forced decode steps of the float32 check
SERVE_DIR = os.path.join(HERE, "_archive", "phase14")  # git-ignored: (c)'s router logits
SERVE_OT_CONVERGED_ITERS = 400       # where the router's solve converges (ROADMAP §C)


def serve_requests(vocab, spec, seed):
    """``spec['requests']`` numpy-seeded prompts of ``spec['prompt']`` tokens: (rid, prompt)
    pairs, made into fresh Requests for each run."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, spec["prompt"]).astype(np.int32))
            for i in range(spec["requests"])]


def drive_engine(engine, pairs, new):
    """``engine.run`` step by step, each admission and tick on the host clock (each ends
    reading its tokens).  Returns {done, ticks [(live slots, s)], admission s, wall s,
    peak device memory B}."""
    import torch

    from repro_torch.serving.engine import Request

    pending = [Request(rid=i, prompt=p, max_new_tokens=new) for i, p in pairs]
    done, ticks, t_admit = [], [], 0.0
    sync()
    torch.cuda.reset_peak_memory_stats()
    t_run = time.perf_counter()
    while pending or any(s is not None for s in engine.slots):
        t0 = time.perf_counter()
        while pending and engine.try_admit(pending[0]):
            pending.pop(0)
        t_admit += time.perf_counter() - t0
        live = sum(s is not None for s in engine.slots)
        t0 = time.perf_counter()
        done += engine.tick()
        ticks.append((live, time.perf_counter() - t0))
    return {"done": done, "ticks": ticks, "admit": t_admit,
            "wall": time.perf_counter() - t_run, "peak": torch.cuda.max_memory_allocated()}


def profile_ticks(engine, pairs, new, n_ticks, phase="phase 14"):
    """The first wave admitted and one tick run, then ``n_ticks`` ticks under one
    torch.profiler session (the device's own records): (wall s, busy s, device launches,
    largest kernels)."""
    from repro_torch.serving.engine import Request

    pending = [Request(rid=i, prompt=p, max_new_tokens=new) for i, p in pairs]
    while pending and engine.try_admit(pending[0]):
        pending.pop(0)
    engine.tick()
    check(new - 2 > n_ticks, f"{phase}: the profiled ticks would outlast the first wave")
    _, wall, busy, n_dev, krows = profile_device(lambda: [engine.tick() for _ in range(n_ticks)])
    check(busy > 0, f"{phase}: the profiler recorded no device time")
    return wall, busy, n_dev, krows


def report_serve(label, run, prof, n_ticks, smi_line, phase="phase 14"):
    """Print a run's tokens a second, ms a tick, launches a tick, idle share and peak."""
    import statistics

    done, ticks = run["done"], run["ticks"]
    tokens = sum(len(r.out_tokens) for r in done)
    t_ticks = sum(t for _, t in ticks)
    decoded = sum(n for n, _ in ticks)                     # live slots' tokens from ticks
    by_live = {n: statistics.median(t for m, t in ticks if m == n)
               for n in sorted({n for n, _ in ticks})}
    wall, busy, n_dev, krows = prof
    print(f"{phase} {label} ({smi_line}): {len(done)} requests, {tokens} tokens in "
          f"{run['wall']:.4f} s, {tokens / run['wall']:.1f} tokens/s; {len(ticks)} ticks, "
          f"{t_ticks:.4f} s in ticks ({decoded / t_ticks:.1f} decoded tokens/s), median "
          f"{statistics.median(t for _, t in ticks) * 1e3:.3f} ms a tick (by live slots: "
          + ", ".join(f"{n}: {s * 1e3:.3f}" for n, s in by_live.items())
          + f"), admission {run['admit']:.4f} s for {len(done)} prefills; peak device memory "
          f"{run['peak']} B; profile of {n_ticks} ticks with {SERVE_SLOTS} live slots: wall "
          f"{wall:.4f} s, device busy {busy:.4f} s, idle share {1.0 - busy / wall:.4f}, "
          f"{n_dev / n_ticks:.1f} device launches a tick; largest: "
          + ", ".join(f"{k[:40]} {us / 1e3:.2f} ms x{c}" for k, us, c in krows[:5]), flush=True)


def check_served(label, done, n, new, phase="phase 14"):
    check(len(done) == n and sorted(r.rid for r in done) == list(range(n)),
          f"{phase} {label}: requests came back as {sorted(r.rid for r in done)}")
    check(all(r.done and len(r.out_tokens) == new for r in done),
          f"{phase} {label}: token counts {[len(r.out_tokens) for r in done]}")


def dropped_fraction(cfg, routes):
    """The dispatch's dropped share over the recorded routings: an expert's tokens past
    ``capacity(cfg, T)`` are dropped, as ``_dispatch_global`` drops them."""
    import torch

    from repro_torch.models.moe import capacity

    drop = total = 0
    for topi, _ in routes:
        T, k = topi.shape
        counts = torch.bincount(topi.reshape(-1), minlength=cfg.moe.num_experts)
        drop += int(torch.clamp_min(counts - capacity(cfg, T), 0).sum())
        total += T * k
    return drop / total


def teacher_forced_check(label, full, prefill, decode, prompt, steps):
    """Prefill's last logits and ``steps`` teacher-forced decode steps' against the no-cache
    logits ``full`` (B, prompt + steps, V), within rtol / atol 2e-3 (float32).
    ``prefill()`` gives the last prompt position's logits (B, 1, V), ``decode(i)``
    position i's, called in order."""
    import torch

    got = [prefill()] + [decode(i) for i in range(prompt, prompt + steps)]
    want = [full[:, prompt - 1 + j] for j in range(steps + 1)]
    errs = [float((g[:, 0] - w).abs().max()) for g, w in zip(got, want)]
    check(all(torch.allclose(g[:, 0], w, rtol=2e-3, atol=2e-3) for g, w in zip(got, want)),
          f"{label}: prefill / decode logits off the no-cache logits: {errs}")
    print(f"{label} float32 teacher-forced ({full.shape[0]} x {prompt} prompt, {steps} decode "
          f"steps): logits within rtol / atol 2e-3 of the no-cache path, max abs err "
          f"{max(errs):.3e}", flush=True)


def phase_serve_dense(smi_line, device):
    """(a): ``smollm-135m`` at full width and depth, bf16, through ``ServingEngine``."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import count_params
    from repro_torch.serving.engine import ServingEngine

    spec = SERVE_DENSE
    cfg = get_config(LM_ARCH)
    model = build_model(cfg, device, seed=0)
    check(count_params(model) == LM_PARAMS, f"phase 14 (a): {count_params(model)} parameters")
    pairs = serve_requests(cfg.vocab_size, spec, 14)
    engine = lambda m=model: ServingEngine(cfg, m, max_batch=SERVE_SLOTS,
                                           max_len=spec["max_len"], device=device)
    run = drive_engine(engine(), pairs, spec["new"])
    check_served("(a)", run["done"], spec["requests"], spec["new"])
    report_serve(f"(a) {LM_ARCH} bf16, {SERVE_SLOTS} slots, {spec['requests']} requests of "
                 f"{spec['prompt']} + {spec['new']}", run,
                 profile_ticks(engine(), pairs, spec["new"], 8), 8, smi_line)
    # the requests past the first four were served in recycled slots: each alone in a
    # fresh engine with the same slots gives the same tokens, bit for bit
    tokens = {r.rid: r.out_tokens for r in run["done"]}
    recycled = pairs[SERVE_SLOTS:]
    for rid, prompt in recycled:
        [alone] = drive_engine(engine(), [(rid, prompt)], spec["new"])["done"]
        check(alone.out_tokens == tokens[rid],
              f"phase 14 (a): request {rid} in a recycled slot differs from a fresh engine's")
    print(f"phase 14 (a): requests {[r for r, _ in recycled]} (recycled slots) == each alone "
          f"in a fresh {SERVE_SLOTS}-slot engine, bit for bit", flush=True)

    # kv_quant: the same parameters with an int8 cache
    cfg_q = dataclasses.replace(cfg, kv_quant=True)
    model_q = build_model(cfg_q, device="meta")
    model_q.load_state_dict(model.state_dict(), assign=True)
    nbytes = lambda cs: sum(t.numel() * t.element_size() for c in cs for t in c.values())
    ratio = nbytes(model_q.init_cache(SERVE_SLOTS, spec["max_len"], abstract=True)) / nbytes(
        model.init_cache(SERVE_SLOTS, spec["max_len"], abstract=True))
    check(ratio < 0.65, f"phase 14 (a): the int8 cache takes {ratio:.4f} of the bf16 bytes")
    tf = torch.as_tensor(np.random.default_rng(16).integers(
        0, cfg.vocab_size, (2, spec["prompt"] + SERVE_TF_STEPS)), device=device)
    rels = []
    c, cq = model.init_cache(2, spec["max_len"]), model_q.init_cache(2, spec["max_len"])
    _, c = model.prefill(tf[:, :spec["prompt"]], c)
    _, cq = model_q.prefill(tf[:, :spec["prompt"]], cq)
    for i in range(spec["prompt"], spec["prompt"] + SERVE_TF_STEPS):
        idx = torch.full((2,), i, device=device)
        l_fp, c = model.decode_step(tf[:, i:i + 1], c, idx)
        l_q, cq = model_q.decode_step(tf[:, i:i + 1], cq, idx)
        l_fp, l_q = l_fp.float(), l_q.float()
        rels.append(float((l_q - l_fp).abs().max()) / max(float(l_fp.std()), 1e-6))
    check(max(rels) < 0.2, f"phase 14 (a): int8-cache decode logits off by {rels} of their std")
    run_q = drive_engine(engine(model_q), pairs, spec["new"])
    check_served("(a) kv_quant", run_q["done"], spec["requests"], spec["new"])
    same_q = sum(r.out_tokens == tokens[r.rid] for r in run_q["done"])
    print(f"phase 14 (a) kv_quant: the int8 cache takes {ratio:.5f} of the bf16 cache's "
          f"bytes; teacher-forced decode logits within {max(rels):.4f} of the bf16 run's std "
          f"(limit 0.2) over {SERVE_TF_STEPS} steps; {same_q} of {spec['requests']} requests "
          f"give the bf16 engine's tokens", flush=True)
    report_serve("(a) kv_quant", run_q, profile_ticks(engine(model_q), pairs, spec["new"], 8), 8,
                 smi_line)
    del model_q

    # float32, teacher-forced: prefill and decode logits against forward of the sequence
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    m32 = build_model(cfg32, device, seed=0)
    with torch.no_grad():
        full, _ = m32.forward(tf)
    caches = m32.init_cache(2, spec["max_len"])
    teacher_forced_check(
        "phase 14 (a) prefill / decode vs LM.forward of the whole sequence,", full,
        lambda: m32.prefill(tf[:, :spec["prompt"]], caches)[0],
        lambda i: m32.decode_step(tf[:, i:i + 1], caches, torch.full((2,), i, device=device))[0],
        spec["prompt"], SERVE_TF_STEPS)


def phase_serve_moe(smi_line, device):
    """(b): ``qwen2-moe-a2.7b`` at full width and depth with top-k routing; returns its
    config."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import count_params
    from repro_torch.serving.engine import ServingEngine

    spec = SERVE_MOE
    cfg = get_config(SERVE_MOE_ARCH)
    sync()
    t0 = time.perf_counter()
    model = build_model(cfg, device, seed=0)
    sync()
    t_init = time.perf_counter() - t0
    n = count_params(model)
    check(n == SERVE_MOE_PARAMS, f"phase 14 (b): {n} parameters, not {SERVE_MOE_PARAMS}")
    check(next(model.parameters()).dtype == torch.bfloat16, "phase 14 (b): params not bf16")
    print(f"phase 14 (b) {SERVE_MOE_ARCH}: {n} parameters ({cfg.num_layers} layers, "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}, {cfg.moe.num_shared_experts} "
          f"shared, bf16) drawn on the card in {t_init:.2f} s; "
          f"{torch.cuda.memory_allocated()} B allocated", flush=True)
    pairs = serve_requests(cfg.vocab_size, spec, 15)
    engine = lambda: ServingEngine(cfg, model, max_batch=SERVE_SLOTS, max_len=spec["max_len"],
                                   device=device)
    for block in model.blocks:
        block.moe.routes = []
    run = drive_engine(engine(), pairs, spec["new"])
    routes = [r for block in model.blocks for r in block.moe.routes]
    for block in model.blocks:
        block.moe.routes = None
    again = drive_engine(engine(), pairs, spec["new"])
    check_served("(b)", run["done"], spec["requests"], spec["new"])
    check({r.rid: r.out_tokens for r in run["done"]}
          == {r.rid: r.out_tokens for r in again["done"]},
          "phase 14 (b): a second run gave other tokens (the combine is not deterministic)")
    dropped = dropped_fraction(cfg, routes)
    prefill = [r for r in routes if r[0].shape[0] == spec["prompt"]]
    print(f"phase 14 (b): a second run gives the same tokens bit for bit; dropped fraction "
          f"{dropped:.6f} over {len(routes)} routings ({dropped_fraction(cfg, prefill):.6f} "
          f"over the {len(prefill)} at prefill; capacity factor {cfg.moe.capacity_factor})",
          flush=True)
    report_serve(f"(b) {SERVE_MOE_ARCH} top-k, {SERVE_SLOTS} slots, {spec['requests']} "
                 f"requests of {spec['prompt']} + {spec['new']}", run,
                 profile_ticks(engine(), pairs, spec["new"], 4), 4, smi_line)
    return cfg


def skewed_router_check(device):
    """tests/test_ot_routing.py's property on the card: on a skewed router (4 sequences of
    32 tokens, 8 experts, top 2; experts 0-1 preferred) ``ot_route`` balances the load
    better than top-k, with finite weights summing to 1.  Returns (OT, top-k) load_cv."""
    import numpy as np
    import torch

    from repro_torch.models.moe import top_k
    from repro_torch.training import ot_routing

    B, S, E, k = 4, 32, 8, 2
    logits = np.random.default_rng(0).normal(size=(B * S, E)).astype(np.float32)
    logits[:, 0] += 2.0
    logits[:, 1] += 1.5
    logits = torch.from_numpy(logits).to(device)
    base = ot_routing.routing_stats(top_k(torch.softmax(logits, -1), k)[1], E, B, S)
    topi, w = ot_routing.ot_route(logits, num_seqs=B, seq_len=S, top_k=k, gamma=5.0, rho=0.5)
    ot = ot_routing.routing_stats(topi, E, B, S)
    cv_ot, cv_tk = float(ot["load_cv"]), float(base["load_cv"])
    check(cv_ot < cv_tk, f"phase 14 (c): on the skewed router OT's load_cv {cv_ot:.4f} is not "
          f"below top-k's {cv_tk:.4f}")
    check(bool(torch.isfinite(w).all()) and float((w.sum(-1) - 1).abs().max()) < 1e-4,
          "phase 14 (c): the skewed router's weights are not finite or do not sum to 1")
    return cv_ot, cv_tk


def phase_serve_ot(cfg, smi_line, device):
    """(c): ``qwen2-moe-a2.7b`` at full width cut to 2 layers with ``ot_balance``: one OT
    solve per MoE layer and forward pass on the card.  Returns the run's kernel launches."""
    import dataclasses
    import statistics

    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.models.moe import top_k
    from repro_torch.ot import diff
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.training import ot_routing

    spec = SERVE_OT
    cfg_c = dataclasses.replace(cfg, num_layers=SERVE_OT_LAYERS,
                                moe=dataclasses.replace(cfg.moe, ot_balance=True))
    model = build_model(cfg_c, device, seed=0)
    pairs = serve_requests(cfg.vocab_size, spec, 15)
    engine = lambda: ServingEngine(cfg_c, model, max_batch=SERVE_SLOTS,
                                   max_len=spec["max_len"], device=device)
    inputs = []                           # the first MoE layer's input, at every forward
    hook = model.blocks[0].moe.register_forward_pre_hook(
        lambda mod, args: inputs.append(args[0].detach().clone()))
    for block in model.blocks:
        block.moe.routes = []
    route, solve_s = ot_routing.ot_route, []

    def timed_route(*args, **kwargs):
        sync()
        t = time.perf_counter()
        out = route(*args, **kwargs)
        sync()
        solve_s.append(time.perf_counter() - t)
        return out

    ot_routing.ot_route = timed_route
    try:
        diff.reset_solve_count()
        _build.reset_launch_counts()
        run = drive_engine(engine(), pairs, spec["new"])
        launches = _build.launch_counts()
        solves = diff.solve_count()
    finally:
        ot_routing.ot_route = route
        hook.remove()
    routes0 = list(model.blocks[0].moe.routes)
    routes = [r for block in model.blocks for r in block.moe.routes]
    for block in model.blocks:
        block.moe.routes = None
    check_served("(c)", run["done"], spec["requests"], spec["new"])
    forwards = SERVE_OT_LAYERS * (spec["requests"] + len(run["ticks"]))
    check(solves == len(solve_s) == len(routes) == forwards,
          f"phase 14 (c): {solves} OT solves, {len(routes)} routings for {forwards} MoE passes")
    bad = [(tuple(t.shape), float((w.sum(-1) - 1).abs().max())) for t, w in routes
           if not (torch.isfinite(w).all() and float((w.sum(-1) - 1).abs().max()) < 1e-4)]
    check(not bad, f"phase 14 (c): routing weights not finite or not summing to 1: {bad[:4]}")
    check(launches.get(ROW_DOT, 0) > 0, f"phase 14 (c): the router launched no {ROW_DOT}")
    other = {k: v for k, v in launches.items() if k not in (ROW_SUM, ROW_DOT)}
    check(not other, f"phase 14 (c): the router launched other kernels than the row sums: {other}")

    # the first layer at the prefills: the served OT routing beside top-k on the same logits
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    router = model.blocks[0].moe.router.detach()
    pre = [i for i, x in enumerate(inputs) if tuple(x.shape[:2]) == (1, spec["prompt"])]
    check(len(pre) == spec["requests"], f"phase 14 (c): {len(pre)} prefills recorded")
    logits = [(inputs[i].reshape(-1, cfg.d_model) @ router.to(inputs[i].dtype)).float()
              for i in pre]
    tk = torch.cat([top_k(torch.softmax(x, dim=-1), k)[1] for x in logits])
    served = torch.cat([routes0[i][0] for i in pre])
    st_ot = ot_routing.routing_stats(served, E, len(pre), spec["prompt"])
    st_tk = ot_routing.routing_stats(tk, E, len(pre), spec["prompt"])
    os.makedirs(SERVE_DIR, exist_ok=True)
    np.savez(os.path.join(SERVE_DIR, "router_prefill.npz"),
             logits=torch.stack(logits).cpu().numpy(), ot_topi=served.cpu().numpy(),
             topk_topi=tk.cpu().numpy())
    cv_ot, cv_tk = skewed_router_check(device)
    # the same prefills' logits solved to convergence (the served router stops at
    # max_iters=40, where the solve has not converged: ROADMAP §C)
    conv = torch.cat([ot_routing.ot_route(x, num_seqs=1, seq_len=spec["prompt"], top_k=k,
                                          max_iters=SERVE_OT_CONVERGED_ITERS)[0]
                      for x in logits])
    cv_conv = float(ot_routing.routing_stats(conv, E, len(pre), spec["prompt"])["load_cv"])
    check(cv_conv < float(st_tk["load_cv"]),
          f"phase 14 (c): converged OT routing's load_cv {cv_conv:.4f} is not below top-k's "
          f"{float(st_tk['load_cv']):.4f} on the prefills' logits")
    print(f"phase 14 (c) {SERVE_MOE_ARCH} with ot_balance ({SERVE_OT_LAYERS} layers, full "
          f"width; {smi_line}): {solves} OT solves (one per MoE layer and forward pass), "
          f"{sum(solve_s) / len(solve_s):.4f} s a solve (median "
          f"{statistics.median(solve_s):.4f}, max {max(solve_s):.4f}; host clock, synchronized "
          f"on each side); row_dot {launches.get(ROW_DOT, 0)} launches "
          f"({launches.get(ROW_DOT, 0) / solves:.1f} a solve), row_sum "
          f"{launches.get(ROW_SUM, 0)} ({launches.get(ROW_SUM, 0) / solves:.1f} a solve), no "
          f"other port kernel; every weight finite, summing to 1 within 1e-4; dropped "
          f"fraction {dropped_fraction(cfg_c, routes):.6f}", flush=True)
    print(f"phase 14 (c) routing: the first layer at the {len(pre)} prefills (logits in "
          f"{SERVE_DIR}): load_cv OT {float(st_ot['load_cv']):.4f}, top-k "
          f"{float(st_tk['load_cv']):.4f}; converged (max_iters={SERVE_OT_CONVERGED_ITERS}) "
          f"OT {cv_conv:.4f} < top-k; experts per sequence OT "
          f"{float(st_ot['experts_per_seq']):.2f}, top-k {float(st_tk['experts_per_seq']):.2f}; "
          f"the skewed router of tests/test_ot_routing.py on the card: load_cv OT {cv_ot:.4f} "
          f"< top-k {cv_tk:.4f}", flush=True)
    report_serve("(c) OT router", run, profile_ticks(engine(), pairs, spec["new"], 1), 1,
                 smi_line)
    return launches


def phase_serve(smi_line, device):
    """Phase 14 (see the module docstring): LM serving and the MoE family on the card.
    Returns the OT router's kernel launches over its run."""
    import torch

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    phase_serve_dense(smi_line, device)
    print(f"[phase 14 +{time.perf_counter() - t_phase:.1f} s] (a)", flush=True)
    cfg = phase_serve_moe(smi_line, device)
    torch.cuda.empty_cache()
    print(f"[phase 14 +{time.perf_counter() - t_phase:.1f} s] (b)", flush=True)
    launches = phase_serve_ot(cfg, smi_line, device)
    torch.cuda.empty_cache()
    print(f"phase 14 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# -- phase 15: the attention families (MLA, the encoder-decoder, the VLM) --------------

FAM_MLA_ARCH = "minicpm3-4b"
FAM_MLA_PARAMS = 4_261_902_848       # its parameter count (the JAX abstract init's)
FAM_MLA_CACHE_B = 35_712             # its cache a token: 62 layers x (256 + 32) x 2 B
FAM_MLA_STEPS = 3                    # (b)'s trainer steps, then 2 split, 1 profiled
FAM_MLA_TRAIN_LAYERS = 4             # (b)'s depth cut, for the smoke's time (PERF.md §4;
                                     # phase 20 (b) trains all 62 on four cards)
FAM_MLA_SERVE_LAYERS = 4             # (a)'s depth cut, for the smoke's time (PERF.md §4;
                                     # phase 20 (b) serves all 62 on four cards)
FAM_STEP_HEADROOM = 12 * 2**30       # (b): a step's activations and temporaries
FAM_ED_ARCH = "whisper-medium"
FAM_ED_PARAMS = 791_827_456
FAM_VLM_ARCH = "llama-3.2-vision-90b"
FAM_VLM_LAYERS = 5                   # (d)'s depth cut: one period of 5 of 100 layers
FAM_VLM_PARAMS = 6_379_634_689       # the period's parameter count
FAM_VLM_GATE = 0.5                   # (d)'s cross_gate (its init, 0, hides the cross path)
FAM_TRAIN = {FAM_ED_ARCH: (8, 128), FAM_VLM_ARCH: (4, 128)}       # (batch, tokens)
FAM_SERVE = dict(batch=4, prompt=32, new=32)                       # (c) and (d)


def fresh_memory():
    """Free what earlier sub-phases left and reset the peak, so that each printed peak is
    its own sub-phase's."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def cache_bytes(caches) -> int:
    import torch

    if isinstance(caches, torch.Tensor):
        return caches.numel() * caches.element_size()
    items = caches.values() if isinstance(caches, dict) else caches
    return sum(cache_bytes(c) for c in items)


def phase_fam_mla_serve(smi_line, device):
    """(a): ``minicpm3-4b`` at full width, bf16, cut to ``FAM_MLA_SERVE_LAYERS`` of its 62
    layers (the whole config's parameter count and cache a token checked on ``meta``),
    through ``ServingEngine``."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import count_params
    from repro_torch.serving.engine import ServingEngine

    spec = SERVE_DENSE
    whole = build_model(get_config(FAM_MLA_ARCH), device="meta")
    n = count_params(whole)
    check(n == FAM_MLA_PARAMS, f"phase 15 (a): {n} parameters, not {FAM_MLA_PARAMS}")
    per_token = cache_bytes(whole.init_cache(1, 1, abstract=True))
    check(per_token == FAM_MLA_CACHE_B, f"phase 15 (a): {per_token} cache B a token")
    cfg = dataclasses.replace(get_config(FAM_MLA_ARCH), num_layers=FAM_MLA_SERVE_LAYERS)
    model = build_model(cfg, device, seed=0)
    n, per_token = count_params(model), cache_bytes(model.init_cache(1, 1, abstract=True))
    check(next(model.parameters()).dtype == torch.bfloat16, "phase 15 (a): params not bf16")
    pairs = serve_requests(cfg.vocab_size, spec, 17)
    engine = lambda: ServingEngine(cfg, model, max_batch=SERVE_SLOTS, max_len=spec["max_len"],
                                   device=device)
    run = drive_engine(engine(), pairs, spec["new"])
    check_served("(a)", run["done"], spec["requests"], spec["new"], phase="phase 15")
    report_serve(f"(a) {FAM_MLA_ARCH} bf16, {FAM_MLA_SERVE_LAYERS} of 62 layers ({n} params, "
                 f"MLA cache {per_token} B a token, "
                 f"{per_token * SERVE_SLOTS * spec['max_len']} B for {SERVE_SLOTS} slots), "
                 f"{SERVE_SLOTS} slots, {spec['requests']} requests of {spec['prompt']} + "
                 f"{spec['new']}", run,
                 profile_ticks(engine(), pairs, spec["new"], 8, "phase 15"), 8, smi_line,
                 phase="phase 15")
    tokens = {r.rid: r.out_tokens for r in run["done"]}
    recycled = pairs[SERVE_SLOTS:]
    for rid, prompt in recycled:
        [alone] = drive_engine(engine(), [(rid, prompt)], spec["new"])["done"]
        check(alone.out_tokens == tokens[rid],
              f"phase 15 (a): request {rid} in a recycled slot differs from a fresh engine's")
    print(f"phase 15 (a): requests {[r for r, _ in recycled]} (recycled slots) == each alone "
          f"in a fresh {SERVE_SLOTS}-slot engine, bit for bit", flush=True)
    del model
    fresh_memory()

    # float32: the absorbed path (prefill, decode) against the expanded one (forward)
    m32 = build_model(dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32"),
                      device, seed=0)
    P = spec["prompt"]
    tf = torch.as_tensor(np.random.default_rng(18).integers(
        0, cfg.vocab_size, (2, P + SERVE_TF_STEPS)), device=device)
    with torch.no_grad():
        full, _ = m32.forward(tf)
    caches = m32.init_cache(2, spec["max_len"])
    teacher_forced_check(
        "phase 15 (a) MLA, absorbed (cache) vs expanded (no cache),", full,
        lambda: m32.prefill(tf[:, :P], caches)[0],
        lambda i: m32.decode_step(tf[:, i:i + 1], caches, torch.full((2,), i, device=device))[0],
        P, SERVE_TF_STEPS)


def train_depth(cfg, free_bytes: int):
    """(layers, parameters) of the deepest cut of ``cfg`` whose AdamW step fits in
    ``free_bytes``: 16 B a parameter (bf16 weights and gradients, float32 master, m and v)
    plus ``FAM_STEP_HEADROOM`` of activations and temporaries (remat per block).  A cut
    keeps whole blocks (a period of layers for the periodic families)."""
    import dataclasses

    from repro_torch.models import build_model
    from repro_torch.models.common import count_params
    from repro_torch.models.lm import num_scan_steps

    unit = cfg.num_layers // num_scan_steps(cfg)            # layers a block
    n = lambda blocks: count_params(build_model(
        dataclasses.replace(cfg, num_layers=blocks * unit), device="meta"))
    base, per_block = n(1), n(2) - n(1)
    for blocks in range(cfg.num_layers // unit, 0, -1):
        params = base + (blocks - 1) * per_block
        if 16 * params + FAM_STEP_HEADROOM <= free_bytes:
            return blocks * unit, params
    fail(f"not even one block of {cfg.arch_id} trains in {free_bytes} B")


def family_train(arch, n_steps, phase, suffix, smi_line, device, max_layers=None):
    """``arch`` trained with the OT alignment loss at full width for ``n_steps`` steps on
    phase 13's data, at the depth ``train_depth`` allows, at most ``max_layers`` (said
    when cut): losses, OT
    distances and gradient norms finite, the OT term present, K1, K4 and K5 or K6
    launched; the step split, a profile of one step, the fused OT term of one step (K8 or
    K6); then K1, K4, K5, K6 and K8 held at the step-0 OT operands (d = d_model) and
    timed.  Returns the kernel-table rows, named with ``suffix``."""
    import dataclasses
    import math
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build as kbuild
    from repro_torch.models import build_model
    from repro_torch.models.common import count_params
    from repro_torch.ot import diff

    cfg = get_config(arch)
    held = torch.cuda.memory_allocated()
    free = torch.cuda.mem_get_info()[1] - held
    layers, n_params = train_depth(cfg, free)
    if max_layers is not None and max_layers < layers:
        layers, n_params = max_layers, count_params(build_model(
            dataclasses.replace(cfg, num_layers=max_layers), device="meta"))
    cut = layers < cfg.num_layers
    if cut:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    print(f"{phase} {arch}: {layers} of {get_config(arch).num_layers} "
          f"layers ({'CUT: ' if cut else 'full depth; '}{n_params} parameters, an AdamW step "
          f"estimated at {16 * n_params + FAM_STEP_HEADROOM} B of {free} B free, {held} B held)",
          flush=True)
    tr = lm_trainer(cfg, "pallas", n_steps, device)
    ops = lm_ot_operands(tr, tr.batch(0), device)
    check(ops[0].d == cfg.d_model, f"{phase}: OT at d = {ops[0].d}")
    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kbuild.reset_launch_counts()
    diff.reset_solve_count()
    t0 = time.perf_counter()
    tr.run()
    sync()
    wall = time.perf_counter() - t0
    launches = kbuild.launch_counts()
    solves = diff.solve_count()
    peak = torch.cuda.max_memory_allocated()
    hist = tr.metrics_history
    durations = list(tr.watchdog.window)
    losses = [m["loss"] for m in hist]
    dists = [m.get("ot_distance", float("nan")) for m in hist]
    norms = [m.get("grad_norm", float("nan")) for m in hist]
    print(f"{phase} {arch} ({layers} layers, d_model {cfg.d_model}, bf16) "
          f"{n_steps} steps of {LM_BATCH} x {LM_SEQ} tokens, ot_align (pallas, L = "
          f"{LM_CLASSES}, g = {ops[0].g}, n = {ops[0].n}, d = {ops[0].d}): loss {losses}; ce "
          f"{[m['ce'] for m in hist]}; ot_distance {dists}; grad_norm {norms}", flush=True)
    check(len(hist) == n_steps and all(math.isfinite(v) for v in losses + dists + norms),
          f"{phase}: a loss, OT distance or gradient norm is not finite: {losses} {dists} "
          f"{norms}")
    check(all(v > 0 for v in dists), f"{phase}: the OT term is missing: {dists}")
    check(solves == n_steps, f"{phase} ran {solves} OT solves")
    check(launches.get(K1, 0) > 0 and launches.get(K4, 0) > 0
          and launches.get(K5, 0) + launches.get(K6, 0) > 0,
          f"{phase}: the trainer did not launch K1, K4 and K5 or K6: {launches}")
    med = statistics.median(durations[1:])
    print(f"{phase} ({smi_line}): {wall:.3f} s for {n_steps} steps; step wall "
          f"median {med:.4f} s (steps 1-{n_steps - 1}; step 0 {durations[0]:.4f} s), "
          f"{LM_BATCH * LM_SEQ / med:.1f} tokens/s; peak device memory {peak} B ({base} B held "
          f"before); OT kernel launches per step "
          f"{ {k: v / n_steps for k, v in sorted(launches.items())} }", flush=True)
    print_split_steps(phase, tr, n_steps, 2, smi_line)
    s0 = n_steps + 2
    _, pwall, busy, n_dev, krows = profile_device(lambda: tr.step_fn(tr.batch(s0)))
    check(busy > 0, f"{phase}: the profiler recorded no device time")
    print(f"{phase} profile (1 step, torch.profiler, {smi_line}): wall {pwall:.4f} s, "
          f"device busy {busy:.4f} s, idle share {1 - busy / pwall:.4f}, {n_dev} device "
          f"launches a step; largest: "
          + ", ".join(f"{k[:48]} {us / 1e3:.2f} ms x{c}" for k, us, c in krows[:8]), flush=True)
    # the fused oracle on the OT term of step 0's batch (a second trainer would not fit)
    tcfg = tr.tcfg
    tr.tcfg = dataclasses.replace(tcfg, ot_grad_impl="fused")
    kbuild.reset_launch_counts()
    ot, _ = tr.ot_loss(tr.batch(0))
    torch.autograd.grad(ot, [tr.state["params"]["embed"]])
    sync()
    del ot
    fused_launches = kbuild.launch_counts()
    tr.tcfg = tcfg
    check(fused_launches.get(K8, 0) + fused_launches.get(K6, 0) > 0,
          f"{phase}: the fused OT term launched no K8 or K6: {fused_launches}")
    print(f"{phase} fused OT term (step 0's batch, forward + backward): launches "
          f"{fused_launches}", flush=True)
    del tr
    fresh_memory()
    path = f"{phase} {arch} trainer, {n_steps} steps, grad_impl 'pallas'"
    counts = {k: (path, launches.get(k, 0)) for k in (K1, K4, K5, K6)}
    counts[K8] = (f"{phase} {arch}, the OT term of one step, grad_impl 'fused'",
                  fused_launches.get(K8, 0))
    return phase_lm_kernels(*ops[:5], counts, smi_line, device, phase=phase, suffix=suffix)


def serve_through_steps(label, cfg, model, memory_of, smi_line, device):
    """Prefill (``make_prefill_step``, with the stub frontend's memory from seed 1) then
    ``FAM_SERVE['new']`` decode steps (``make_serve_step``) of ``FAM_SERVE['batch']``
    prompts; ``memory_of(seed)`` is the step's memory argument (frames or image tokens)
    and the memory its cross-attention reads.  Gates: each layer's ``cross_kv`` after
    prefill is the memory's projection bit for bit, and other memory gives other logits."""
    import numpy as np
    import torch

    from repro_torch.launch import steps

    B, P, new = FAM_SERVE["batch"], FAM_SERVE["prompt"], FAM_SERVE["new"]
    max_len = P + new + 8
    params = {k: p.detach() for k, p in model.named_parameters()}
    prompts = torch.as_tensor(np.random.default_rng(19).integers(0, cfg.vocab_size, (B, P)),
                              dtype=torch.int32, device=device)
    arg, mem = memory_of(1)
    prefill_step, serve_step = steps.make_prefill_step(cfg), steps.make_serve_step(cfg)
    prefill_step(params, prompts, model.init_cache(B, max_len), arg)       # warm
    caches = model.init_cache(B, max_len)
    sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, caches = prefill_step(params, prompts, caches, arg)
    sync()
    t_prefill = time.perf_counter() - t0
    token = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
    t0 = time.perf_counter()
    for i in range(new):
        token, caches = serve_step(params, token, caches, P + i)
    sync()
    t_decode = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    blocks = model.decoder if cfg.family == "encdec" else model.blocks
    with torch.no_grad():
        for block, c in zip(blocks, caches):
            for name, w in (("k", block.cross.wk), ("v", block.cross.wv)):
                check(torch.equal(c["cross_kv"][name], torch.einsum("bmd,dhk->bmhk", mem, w)),
                      f"{label}: cross_kv/{name} after prefill is not the memory's projection")
    other, _ = prefill_step(params, prompts, model.init_cache(B, max_len), memory_of(2)[0])
    diff = float((other.float() - logits.float()).abs().max())
    check(diff > 0, f"{label}: two memories gave the same prefill logits")
    print(f"{label} serving ({smi_line}): prefill of {B} x {P} tokens {t_prefill * 1e3:.3f} ms, "
          f"{new} decode steps {t_decode / new * 1e3:.3f} ms a step, "
          f"{B * (new + 1) / (t_prefill + t_decode):.1f} tokens/s; peak device memory {peak} B; "
          f"cross_kv after prefill == the memory's projection bit for bit in all "
          f"{len(caches)} blocks; another memory moves the prefill logits by up to {diff:.4f}",
          flush=True)


def phase_fam_encdec(smi_line, device):
    """(c): ``whisper-medium`` at full width and depth: one AdamW step through
    ``make_train_step``, then prefill (the encoder) and decode through the steps."""
    import dataclasses
    import math

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import modality_stub
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.models.common import count_params
    from repro_torch.training.optim import init_opt_state

    label = "phase 15 (c)"
    cfg = get_config(FAM_ED_ARCH)
    model = build_model(cfg, device, seed=0)
    n = count_params(model)
    check(n == FAM_ED_PARAMS, f"{label}: {n} parameters, not {FAM_ED_PARAMS}")
    frames_of = lambda batch, seed: torch.as_tensor(
        modality_stub(cfg, batch, seed)["frames"], device=device).to(torch.bfloat16)
    Bt, St = FAM_TRAIN[FAM_ED_ARCH]
    tcfg = TrainConfig()
    params = {k: p.detach() for k, p in model.named_parameters()}
    state = {"params": params, "opt": init_opt_state(params, tcfg.optimizer)}
    batch = {"tokens": torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (Bt, St + 1)), dtype=torch.int32, device=device),
        "frames": frames_of(Bt, 0)}
    train_step = steps.make_train_step(cfg, tcfg)
    sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, met = train_step(state, batch)
    loss, gnorm = float(met["loss"]), float(met["grad_norm"])
    t_step = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(math.isfinite(loss) and math.isfinite(gnorm),
          f"{label}: the train step's loss {loss} or grad norm {gnorm} is not finite")
    print(f"{label} {FAM_ED_ARCH} ({n} params, {cfg.encoder_layers} + {cfg.num_layers} layers, "
          f"bf16; {smi_line}): one AdamW step (make_train_step, remat per block) on {Bt} x {St} "
          f"tokens and {Bt} x {cfg.num_audio_frames} frames: loss {loss:.4f}, grad norm "
          f"{gnorm:.4f}, {t_step:.4f} s (the first step; host clock, ending in a read), "
          f"{Bt * St / t_step:.1f} tokens/s; peak device memory {peak} B", flush=True)
    del state, batch, met
    fresh_memory()
    frames4 = frames_of(FAM_SERVE["batch"], 1)
    with torch.no_grad():
        enc_ms = median_ms(lambda: model.encode(frames4), 5)
    print(f"{label} encode of {FAM_SERVE['batch']} x {cfg.num_audio_frames} frames: "
          f"{enc_ms:.3f} ms (CUDA events, median of 5)", flush=True)

    def memory_of(seed):
        frames = frames_of(FAM_SERVE["batch"], seed)
        with torch.no_grad():
            return frames, model.encode(frames)

    serve_through_steps(label, cfg, model, memory_of, smi_line, device)
    del model, params
    fresh_memory()
    m32 = build_model(dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32"),
                      device, seed=0)
    P, steps_tf = FAM_SERVE["prompt"], SERVE_TF_STEPS
    tf = torch.as_tensor(np.random.default_rng(20).integers(0, cfg.vocab_size,
                                                            (2, P + steps_tf)), device=device)
    with torch.no_grad():
        mem = m32.encode(torch.as_tensor(modality_stub(cfg, 2, 3)["frames"], device=device))
        full, _ = m32.forward(tf, mem)
    caches = m32.init_cache(2, P + steps_tf + 8)
    teacher_forced_check(f"{label} {FAM_ED_ARCH}, prefill and decode (cache) vs the decoder "
                         f"without one,", full,
                         lambda: m32.prefill(tf[:, :P], caches, mem)[0],
                         lambda i: m32.decode_step(tf[:, i:i + 1], caches, i)[0], P, steps_tf)


def phase_fam_vlm(smi_line, device):
    """(d): ``llama-3.2-vision-90b`` cut to one period (5 of 100 layers) at full width:
    forward and backward of ``train_loss`` (no optimizer: AdamW's state for the period
    does not fit), then prefill and decode through the steps."""
    import dataclasses
    import math

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import modality_stub
    from repro_torch.models import build_model
    from repro_torch.models.common import count_params
    from repro_torch.utils.tree import tree_global_norm

    label = "phase 15 (d)"
    cfg = dataclasses.replace(get_config(FAM_VLM_ARCH), num_layers=FAM_VLM_LAYERS)
    model = build_model(cfg, device, seed=0)
    n = count_params(model)
    check(n == FAM_VLM_PARAMS, f"{label}: {n} parameters, not {FAM_VLM_PARAMS}")

    def set_gates(m):
        with torch.no_grad():
            for block in m.blocks:
                block.cross_gate.fill_(FAM_VLM_GATE)

    set_gates(model)
    image_of = lambda batch, seed, dtype=torch.bfloat16: torch.as_tensor(
        modality_stub(cfg, batch, seed)["memory"], device=device).to(dtype)
    Bt, St = FAM_TRAIN[FAM_VLM_ARCH]
    batch = {"tokens": torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (Bt, St + 1)), dtype=torch.int32, device=device),
        "memory": image_of(Bt, 0)}
    names = [k for k, _ in model.named_parameters()]
    sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, _ = model.train_loss(batch, z_loss=1e-4, remat=True)
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
    loss, gnorm = float(loss.detach()), float(tree_global_norm(grads))
    t_step = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    wq = float(grads["blocks.0.cross.wq"].float().abs().max())
    check(math.isfinite(loss) and math.isfinite(gnorm),
          f"{label}: the loss {loss} or the gradient norm {gnorm} is not finite")
    check(wq > 0, f"{label}: cross.wq got no gradient")
    print(f"{label} {FAM_VLM_ARCH} cut to {cfg.num_layers} of 100 layers ({n} params, bf16, "
          f"cross_gate set to {FAM_VLM_GATE}; {smi_line}): train_loss forward + backward (no "
          f"optimizer, remat per block) on {Bt} x {St} tokens and {Bt} x "
          f"{cfg.num_image_tokens} image tokens: loss {loss:.4f}, gradient norm {gnorm:.4f}, "
          f"|grad cross.wq| max {wq:.3e}; {t_step:.4f} s (host clock, ending in a read), "
          f"{Bt * St / t_step:.1f} tokens/s; peak device memory {peak} B", flush=True)
    del grads, batch
    fresh_memory()

    def memory_of(seed):
        img = image_of(FAM_SERVE["batch"], seed)
        return img, img

    serve_through_steps(label, cfg, model, memory_of, smi_line, device)
    del model
    fresh_memory()
    m32 = build_model(dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32"),
                      device, seed=0)
    set_gates(m32)
    P, steps_tf = FAM_SERVE["prompt"], SERVE_TF_STEPS
    tf = torch.as_tensor(np.random.default_rng(21).integers(0, cfg.vocab_size,
                                                            (2, P + steps_tf)), device=device)
    img = image_of(2, 3, torch.float32)
    with torch.no_grad():
        full, _ = m32.forward(tf, img)
    caches = m32.init_cache(2, P + steps_tf + 8)
    teacher_forced_check(f"{label} one period, prefill and decode (cache) vs forward,", full,
                         lambda: m32.prefill(tf[:, :P], caches, img)[0],
                         lambda i: m32.decode_step(tf[:, i:i + 1], caches, i)[0], P, steps_tf)


def phase_families(smi_line, device):
    """Phase 15 (see the module docstring): MLA, the encoder-decoder and the VLM at full
    width.  Returns the kernel-table rows at (b)'s OT shapes."""
    t_phase = time.perf_counter()
    lap = lambda what: print(f"[phase 15 +{time.perf_counter() - t_phase:.1f} s] {what}",
                             flush=True)
    fresh_memory()
    phase_fam_mla_serve(smi_line, device)
    fresh_memory()
    lap("(a)")
    rows = family_train(FAM_MLA_ARCH, FAM_MLA_STEPS, "phase 15 (b)", "@mla_step", smi_line,
                        device, max_layers=FAM_MLA_TRAIN_LAYERS)
    fresh_memory()
    lap("(b)")
    phase_fam_encdec(smi_line, device)
    fresh_memory()
    lap("(c)")
    phase_fam_vlm(smi_line, device)
    fresh_memory()
    print(f"phase 15 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows


XL_ARCH = "xlstm-1.3b"
XL_PARAMS = 2_020_751_696            # its parameter count (the JAX abstract init's)
XL_STATE_B = 706_560_000             # its recurrent state a sequence (the JAX abstract init's)
XL_SERVE = dict(prompts=(2, 37, 64, 64, 128, 129, 257, 300), new=32, max_len=340)    # (a)
XL_TF = dict(prompt=64, steps=8)     # (b): the teacher-forced check
XL_CHUNKED = 257                     # (b): chunkwise prefill (128, 128, 1) vs decode steps
XL_STEPS = 3                         # (c)'s trainer steps, then 2 split, 1 profiled
XL_TRAIN_LAYERS = 8                  # (c)'s depth cut, 1 of 6 periods, for the smoke's time
XL_SERVE_LAYERS = 8                  # (a)'s depth cut, 1 of 6 periods, for the smoke's time
XL_F32_LAYERS = 16                   # (b)'s depth cut, 2 of 6 periods, for the smoke's time


def phase_xlstm_serve(smi_line, device):
    """(a): ``xlstm-1.3b`` at full width, bf16, cut to ``XL_SERVE_LAYERS`` of its 48 layers
    (the whole config's parameter count and state checked on ``meta``), through
    ``ServingEngine``: eight requests of 2-300 prompt tokens and 32 new ones through four
    slots; each back once, and those in recycled slots bit for bit each alone in a fresh
    engine."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import count_params
    from repro_torch.serving.engine import ServingEngine

    spec = XL_SERVE
    whole = build_model(get_config(XL_ARCH), device="meta")
    n = count_params(whole)
    check(n == XL_PARAMS, f"phase 16 (a): {n} parameters, not {XL_PARAMS}")
    per_seq = cache_bytes(whole.init_cache(1, 1, abstract=True))
    check(per_seq == XL_STATE_B, f"phase 16 (a): {per_seq} state B a sequence")
    cfg = dataclasses.replace(get_config(XL_ARCH), num_layers=XL_SERVE_LAYERS)
    model = build_model(cfg, device, seed=0)
    n, per_seq = count_params(model), cache_bytes(model.init_cache(1, 1, abstract=True))
    check(next(model.parameters()).dtype == torch.bfloat16, "phase 16 (a): params not bf16")
    rng = np.random.default_rng(21)
    pairs = [(i, rng.integers(0, cfg.vocab_size, p).astype(np.int32))
             for i, p in enumerate(spec["prompts"])]
    engine = lambda: ServingEngine(cfg, model, max_batch=SERVE_SLOTS, max_len=spec["max_len"],
                                   device=device)
    run = drive_engine(engine(), pairs, spec["new"])
    check_served("(a)", run["done"], len(pairs), spec["new"], phase="phase 16")
    report_serve(f"(a) {XL_ARCH} bf16, {XL_SERVE_LAYERS} of 48 layers ({n} params, "
                 f"recurrent state {per_seq} B a sequence, "
                 f"{per_seq * SERVE_SLOTS} B for {SERVE_SLOTS} slots), {SERVE_SLOTS} slots, "
                 f"{len(pairs)} requests of {list(spec['prompts'])} + {spec['new']}", run,
                 profile_ticks(engine(), pairs, spec["new"], 8, "phase 16"), 8, smi_line,
                 phase="phase 16")
    tokens = {r.rid: r.out_tokens for r in run["done"]}
    recycled = pairs[SERVE_SLOTS:]
    for rid, prompt in recycled:
        [alone] = drive_engine(engine(), [(rid, prompt)], spec["new"])["done"]
        check(alone.out_tokens == tokens[rid],
              f"phase 16 (a): request {rid} in a recycled slot differs from a fresh engine's")
    print(f"phase 16 (a): requests {[r for r, _ in recycled]} (recycled slots, prompts "
          f"{[len(p) for _, p in recycled]}) == each alone in a fresh {SERVE_SLOTS}-slot "
          f"engine, bit for bit", flush=True)


def phase_xlstm_f32(device):
    """(b), float32 at full width on ``XL_F32_LAYERS`` of its 48 layers: prefill and
    teacher-forced decode against
    ``LM.forward``, and a chunkwise prefill of ``XL_CHUNKED`` tokens (chunks of 128, 128
    and 1) against as many decode steps from the zero state: logits and every state leaf
    within rtol / atol 2e-3."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(XL_ARCH)
    m32 = build_model(dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32",
                                          num_layers=XL_F32_LAYERS), device, seed=0)
    P, steps = XL_TF["prompt"], XL_TF["steps"]
    tf = torch.as_tensor(np.random.default_rng(22).integers(
        0, cfg.vocab_size, (2, P + steps)), device=device)
    with torch.no_grad():
        full, _ = m32.forward(tf)
    caches = m32.init_cache(2, P + steps)
    teacher_forced_check(
        "phase 16 (b) xLSTM prefill / decode vs LM.forward of the whole sequence,", full,
        lambda: m32.prefill(tf[:, :P], caches)[0],
        lambda i: m32.decode_step(tf[:, i:i + 1], caches, torch.full((2,), i, device=device))[0],
        P, steps)
    S = XL_CHUNKED
    tok = torch.as_tensor(np.random.default_rng(23).integers(0, cfg.vocab_size, (1, S)),
                          device=device)
    lg, chunked = m32.prefill(tok, m32.init_cache(1, S))
    stepped = m32.init_cache(1, S)
    for i in range(S):
        lg_s, stepped = m32.decode_step(tok[:, i:i + 1], stepped, i)
    errs = {"logits": float((lg - lg_s).abs().max())}
    ok = torch.allclose(lg, lg_s, rtol=2e-3, atol=2e-3)
    for b, (c, s_) in enumerate(zip(chunked, stepped)):
        for part in ("slstm", "mlstm"):
            for k in c[part]:
                a, w = c[part][k].float(), s_[part][k].float()
                key = f"{part}/{k}"
                errs[key] = max(errs.get(key, 0.0), float((a - w).abs().max()))
                ok = ok and torch.allclose(a, w, rtol=2e-3, atol=2e-3)
    check(ok, f"phase 16 (b): the chunkwise prefill of {S} off {S} decode steps: {errs}")
    print(f"phase 16 (b) float32 chunkwise prefill of {S} tokens (chunks of 128, 128 and 1) "
          f"vs {S} decode steps from the zero state: last logits and every state leaf within "
          f"rtol / atol 2e-3; max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)


def phase_xlstm(smi_line, device):
    """Phase 16 (see the module docstring): ``xlstm-1.3b`` served on 2 of its 6 periods,
    checked in float32 at full width on 3, trained at full width on 1 period.  Returns the
    kernel-table rows at (c)'s OT shapes."""
    t_phase = time.perf_counter()
    lap = lambda what: print(f"[phase 16 +{time.perf_counter() - t_phase:.1f} s] {what}",
                             flush=True)
    fresh_memory()
    phase_xlstm_serve(smi_line, device)
    fresh_memory()
    lap("(a)")
    phase_xlstm_f32(device)
    fresh_memory()
    lap("(b)")
    rows = family_train(XL_ARCH, XL_STEPS, "phase 16 (c)", "@xlstm_step", smi_line, device,
                        max_layers=XL_TRAIN_LAYERS)
    fresh_memory()
    print(f"phase 16 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows



# -- phase 18: the LM mesh (FSDP x TP / EP over torch.distributed) ---------------------

LMM_ARCH, LMM_MOE_ARCH = "yi-9b", "qwen2-moe-a2.7b"
LMM_PARAMS = 8_829_407_232           # yi-9b's parameter count (the JAX abstract init's)
LMM_CUT = 2                          # (a) and (b)'s one-card check: 2 of its 48 layers
LMM_MOE_CUT = 4                      # (b)'s MoE check: 4 of qwen2-moe-a2.7b's 24 layers
LMM_A = dict(batch=64, seq=32, classes=8)           # (a): a step of 64 x 32 tokens (the
                                                    # OT problem of phase 13: L 8, g 4)
LMM_B = dict(batch=8, seq=512, classes=4, steps=3)  # (b): 3 steps of 8 x 512 tokens
LMM_STATE_B = 16                     # an AdamW step's bytes a parameter: bf16 params and
                                     # gradients, float32 m, v and master weights
LMM_LOSS_RTOL, LMM_PARAM_ATOL = 1e-3, 5e-3          # against one card
# The bf16 parameters after AdamW's first step (lr 3e-4, each entry moved by about lr x
# g / |g|) cannot see a wrong gradient: the step's grad_norm (before the clip) is held
# within LMM_GNORM_RTOL of one card's, and AdamW's m (0.1 x the clipped gradient) leaf by
# leaf within LMM_M_RTOL of one card's in norm: a gradient lost, flipped or summed over
# the wrong ranks moves its leaf's m by 0.5-2 of its norm, a scaled one the grad_norm.
LMM_GNORM_RTOL, LMM_M_RTOL = 1e-3, 0.05
LMM_DROP_ENTRIES = 4                 # routed entries a MoE layer's drops may differ by
LMM_DIR = os.path.join(HERE, "_archive", "phase18")   # git-ignored: rank logs and results
LMM_TIMEOUT_S = {"a": 600, "b": 900}          # (a) with phases 19 (a) and 20 (a) in its ranks
LMM_ROW = "@lm_mesh_step"            # suffix of the kernel rows at (a)'s trainer shapes


def lmm_setup(cfg, shape: dict, steps=1, grad_impl="pallas"):
    """(train config, data) of a phase 18 trainer: ``SyntheticLM(vocab, seq, batch,
    classes, seed 0)``, AdamW at lr 6e-4 (warmup 2) with float32 master weights, remat
    per block, the OT alignment loss (weight 0.05, L-BFGS) on ``grad_impl``."""
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.data.pipeline import SyntheticLM, SyntheticLMConfig

    tcfg = TrainConfig(optimizer=OptimizerConfig(lr=6e-4, warmup_steps=2, decay_steps=12),
                       steps=steps, log_every=1, ot_align=True, ot_align_weight=0.05,
                       ot_solver="lbfgs", ot_grad_impl=grad_impl, remat="block")
    data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=shape["seq"],
                                         global_batch=shape["batch"],
                                         num_classes=shape["classes"], seed=0))
    return tcfg, data


def lmm_trainer(cfg, shape: dict, device, mesh=None, steps=1, grad_impl="pallas",
                local_dispatch=None):
    """A trainer of phase 18 (``lmm_setup``) on ``mesh`` where given."""
    import dataclasses

    from repro_torch.training.trainer import Trainer

    if local_dispatch is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               local_dispatch=local_dispatch))
    return Trainer(cfg, *lmm_setup(cfg, shape, steps, grad_impl), device=device, mesh=mesh)


def lmm_cut(arch, layers):
    """``arch`` cut to ``layers``; the MoE cut computes in float32 (bf16 parameters), so
    that near-ties of its router, which the mesh's other summation order can flip in
    bf16, are too rare to move the dropped fraction past LMM_DROP_ENTRIES."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    return cfg


def lmm_compare(label, ref, got, phase="phase 18"):
    """One card's run ``ref`` against a mesh run ``got`` (dicts from ``lmm_run``): the loss
    within rtol LMM_LOSS_RTOL, the grad_norm within rtol LMM_GNORM_RTOL, every parameter
    within LMM_PARAM_ATOL, each leaf's AdamW m within LMM_M_RTOL of its norm; returns
    (the max abs parameter difference, the largest relative m difference and its leaf)."""
    import math

    import torch

    rl, gl = ref["loss"][0], got["loss"][0]
    check(math.isfinite(gl) and abs(gl - rl) <= LMM_LOSS_RTOL * abs(rl),
          f"{phase} {label}: loss {gl!r} on the mesh, {rl!r} on one card")
    rg, gg = ref["gnorm"][0], got["gnorm"][0]
    check(math.isfinite(gg) and abs(gg - rg) <= LMM_GNORM_RTOL * abs(rg),
          f"{phase} {label}: grad_norm {gg!r} on the mesh, {rg!r} on one card")
    worst = 0.0
    for k, t in ref["params"].items():
        worst = max(worst, float(torch.max(torch.abs(got["params"][k].float() - t.float()))))
    check(worst <= LMM_PARAM_ATOL, f"{phase} {label}: parameters {worst:.3e} off one card's "
                                   f"(limit {LMM_PARAM_ATOL})")
    m_rel, m_leaf = 0.0, None
    for k, t in ref["m"].items():
        a = t.float()
        diff = float(torch.linalg.vector_norm(got["m"][k].float() - a))
        norm = float(torch.linalg.vector_norm(a))
        rel = diff / norm if norm > 0 else (0.0 if diff == 0 else math.inf)
        if rel >= m_rel:
            m_rel, m_leaf = rel, k
    check(m_rel <= LMM_M_RTOL, f"{phase} {label}: AdamW's m of {m_leaf} is {m_rel:.3e} of "
                               f"its norm off one card's (limit {LMM_M_RTOL})")
    return worst, m_rel, m_leaf


def lmm_run(tr, steps, device, profile_step=False, gather=True):
    """Run ``tr`` for ``steps``, each step split into its pieces (the batch, the LM
    forward + backward, the OT solve, its backward, the optimizer; each ending in a
    synchronize); returns its losses, OT distances, MoE drop fractions, step walls and
    splits, launches, peak and state bytes, and (every rank gathering) its whole
    parameters on the host (``gather``).  ``profile_step``: the last step under
    torch.profiler, its collectives' device time apart."""
    import contextlib

    import torch

    from repro_torch.kernels import _build as kbuild
    from repro_torch.sharding import partition as P
    from repro_torch.utils.tree import tree_bytes

    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    kbuild.reset_launch_counts()
    state_b = tree_bytes(tr.state)
    hist, splits = [], []

    def mark(marks, piece):
        torch.cuda.synchronize(device)
        marks.append((piece, time.perf_counter()))

    def one_step(step):
        marks = [("start", time.perf_counter())]
        rules = P.use_rules(tr.rules, tr.mesh) if tr.rules is not None else \
            contextlib.nullcontext()
        with rules:
            batch = tr.batch(step)
            mark(marks, "batch")
            m = tr.step_fn(batch, mark=lambda piece: mark(marks, piece))
        hist.append({k: float(v) for k, v in m.items()})
        splits.append({p: t - marks[i][1] for i, (p, t) in enumerate(marks[1:])})

    prof = None
    for step in range(steps - 1 if profile_step else steps):
        one_step(step)
    if profile_step:
        _, wall, busy, n_dev, krows = profile_device(lambda: one_step(steps - 1))
        comm = sum(us for k, us, _ in krows if "nccl" in k.lower()) / 1e6
        prof = dict(wall_s=wall, busy_s=busy, launches=n_dev, collective_s=comm,
                    top=[(k[:60], us / 1e3, c) for k, us, c in krows[:6]])
    whole = lambda d: {k: (t if not P.on_mesh(tr.mesh) else tr.placements[k].gather(t))
                       .detach().to(torch.bfloat16).cpu() for k, t in d.items()}
    return dict(loss=[m["loss"] for m in hist], ot=[m["ot_distance"] for m in hist],
                gnorm=[m["grad_norm"] for m in hist], dropped=[m["moe_dropped"] for m in hist],
                walls=[sum(sp.values()) for sp in splits], splits=splits,
                launches=kbuild.launch_counts(), peak=torch.cuda.max_memory_allocated(device),
                state_b=state_b, params=whole(tr.state["params"]) if gather else None,
                m=whole(tr.state["opt"]["m"]) if gather else None, profile=prof)


def lmm_barrier(device):
    import torch
    import torch.distributed as dist

    t = torch.zeros(1, device=device if dist.get_backend() == "nccl" else "cpu")
    dist.all_reduce(t)


def lmm_check_blocks(tr, label, phase="phase 18"):
    """Every parameter of a mesh trainer is its rules block: the shape of a freshly
    computed placement of the whole leaf under the same rules."""
    from repro_torch.models import build_model
    from repro_torch.sharding import partition as P

    meta = dict(build_model(tr.cfg, device="meta").named_parameters())
    for k, t in tr.state["params"].items():
        want = P.placement(meta[k].shape, meta[k].logical_axes, tr.rules, tr.mesh)
        check(tuple(t.shape) == want.local_shape and tr.placements[k].index == want.index,
              f"{phase} {label}: {k} holds {tuple(t.shape)}, not its block {want.local_shape}")
        for kind in ("m", "v", "master"):
            check(tuple(tr.state["opt"][kind][k].shape) == want.local_shape,
                  f"{phase} {label}: opt {kind} of {k} is not its block")


def lm_mesh_rank(rank: int, init: str, part: str) -> None:
    """One rank of phase 18 (see ``phase_lm_mesh``); exits non-zero on any failed check.
    Its results go to ``LMM_DIR/rank{rank}.json`` (and mesh rank 0's gathered
    parameters to ``LMM_DIR/{case}.pt`` in (a))."""
    import gc
    import math

    import torch

    from repro_torch.core import distributed as D
    from repro_torch.models import build_model
    from repro_torch.sharding import partition as P
    from repro_torch.utils.tree import tree_bytes

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    world = 2 if part == "a" else 4
    backend, device = D.init_process_group(world, rank, init, timeout_s=900)
    say = lambda msg: print(f"[{time.perf_counter() - t_start:.1f} s] {msg}", flush=True)
    say(f"phase 18 ({part}): backend {backend}, world size {world}, rank {rank} on {device} "
        f"({torch.cuda.get_device_name(device)})")
    names = ("data", "model")
    out = {"backend": backend, "runs": {}, "serve": {}, "attn": {}}

    def keep(label, run):
        out["runs"][label] = {k: v for k, v in run.items() if k not in ("params", "m")}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    if part == "a":
        cfg = lmm_cut(LMM_ARCH, LMM_CUT)
        meshes = {shape: D.make_mesh(shape, names) for shape in ((1, 2), (2, 1))}
        for shape, mesh in meshes.items():
            label = f"{LMM_ARCH} {LMM_CUT} layers on {shape}"
            tr = lmm_trainer(cfg, LMM_A, device, mesh)
            lmm_check_blocks(tr, label)
            run = lmm_run(tr, 1, device)
            keep(label, run)
            if rank == 0:
                torch.save({"params": run["params"], "m": run["m"]},
                           os.path.join(LMM_DIR, f"a_{shape[0]}x{shape[1]}.pt"))
            say(f"{label}: loss {run['loss']}, ot {run['ot']}, state {run['state_b']} B, "
                f"peak {run['peak']} B, launches {run['launches']}")
            del tr, run
            free()
        # phase 19 (a): serving on the same ranks and meshes
        save = lambda name, obj: torch.save(obj, os.path.join(LMM_DIR, name)) \
            if rank == 0 else None
        sm_rank_a(meshes, device, out, save)
        say("phase 19 (a): " + "; ".join(f"{k}: tokens {v['tokens']}, wall {v['wall']:.1f} s"
                                          for k, v in out["serve"].items()))
        # phase 20 (a): the attention families on the same ranks and meshes
        am_rank_a(meshes, device, out, save)
        say("phase 20 (a): " + "; ".join(f"{k}: loss {v['loss']}, tokens "
                                          f"{v['steps']['tokens']}, {v['wall_all']:.1f} s"
                                          for k, v in out["attn"].items()))
    else:
        mesh = D.make_mesh((2, 2), names)
        # yi-9b at full width and depth: 3 steps of 8 x 512 tokens
        cfg = lmm_cut(LMM_ARCH, 48)
        label = f"{LMM_ARCH} 48 layers on (2, 2)"
        torch.cuda.reset_peak_memory_stats(device)
        tr = lmm_trainer(cfg, LMM_B, device, mesh, steps=LMM_B["steps"])
        # the trainer draws leaf by leaf and cuts as it goes: its init holds its state and
        # at most one whole leaf's draw (float32, then the parameter dtype), not the model
        init_peak = torch.cuda.max_memory_allocated(device)
        leaf_b = 6 * max(p.numel() for p in build_model(cfg, device="meta").parameters())
        check(init_peak <= tree_bytes(tr.state) + leaf_b,
              f"phase 18 {label}: the trainer's init peaked at {init_peak} B, over its state "
              f"{tree_bytes(tr.state)} B and one leaf's draw {leaf_b} B")
        lmm_check_blocks(tr, label)
        run = lmm_run(tr, LMM_B["steps"], device, profile_step=True, gather=False)
        run["init_peak"] = init_peak
        keep(label, run)
        check(all(math.isfinite(v) for v in run["loss"] + run["ot"]),
              f"phase 18 {label}: a loss or OT distance is not finite: {run}")
        check(abs(run["loss"][0] - math.log(cfg.vocab_size)) <= 2.0,
              f"phase 18 {label}: step-0 loss {run['loss'][0]} is not within 2 of "
              f"ln {cfg.vocab_size} = {math.log(cfg.vocab_size):.3f}")
        check(run["peak"] < 80e9, f"phase 18 {label}: peak {run['peak']} B")
        say(f"{label}: loss {run['loss']}, ot {run['ot']}, walls {run['walls']}, state "
            f"{run['state_b']} B, init peak {init_peak} B, peak {run['peak']} B, launches "
            f"{run['launches']}, "
            f"profile {run['profile']}")
        del tr, run
        free()
        # the cuts held against one card (mesh rank 0 runs the card's step after)
        runs = {}
        for arch, layers, local in ((LMM_ARCH, LMM_CUT, None), (LMM_MOE_ARCH, LMM_MOE_CUT,
                                                                False),
                                    (LMM_MOE_ARCH, LMM_MOE_CUT, True)):
            label = f"{arch} {layers} layers on (2, 2)" + \
                ("" if local is None else f", local_dispatch {local}")
            tr = lmm_trainer(lmm_cut(arch, layers), LMM_B, device, mesh, local_dispatch=local)
            lmm_check_blocks(tr, label)
            run = lmm_run(tr, 1, device)
            keep(label, run)
            runs[(arch, local)] = run if rank == 0 else None
            say(f"{label}: loss {run['loss']}, ot {run['ot']}, dropped {run['dropped']}, "
                f"state {run['state_b']} B, peak {run['peak']} B, launches {run['launches']}")
            del tr
            free()
        if rank == 0:
            # one card at each cut; with local_dispatch, under rules of two data shards (a
            # mesh of sizes only): the MoE then packs each half of the batch apart, as
            # JAX's _dispatch_local on the whole batch
            two_shards = D.sizes_mesh((2, 2), names)
            for (arch, local), got in runs.items():
                layers = LMM_CUT if arch == LMM_ARCH else LMM_MOE_CUT
                cfg = lmm_cut(arch, layers)
                one = lmm_trainer(cfg, LMM_B, device, local_dispatch=local)
                with P.use_rules(P.default_rules(names) if local else None, two_shards):
                    ref = lmm_run(one, 1, device)
                label = f"{arch} {layers} layers (2, 2)" + \
                    ("" if local is None else f" local_dispatch {local}")
                worst, m_rel, m_leaf = lmm_compare(label, ref, got)
                out["runs"][label + " vs one card"] = dict(
                    loss=(got["loss"][0], ref["loss"][0]), param_max_abs=worst,
                    grad_norm=(got["gnorm"][0], ref["gnorm"][0]), m_rel=(m_rel, m_leaf),
                    one_card_step_s=ref["walls"], one_card_split=ref["splits"],
                    one_card_peak=ref["peak"])
                if cfg.moe is not None:
                    out["runs"][label + " vs one card"]["dropped"] = (got["dropped"][0],
                                                                      ref["dropped"][0])
                    bound = LMM_DROP_ENTRIES * layers / (LMM_B["batch"] * LMM_B["seq"] *
                                                         cfg.moe.top_k)
                    check(abs(got["dropped"][0] - ref["dropped"][0]) <= bound,
                          f"phase 18 {label}: dropped {got['dropped'][0]!r} on the mesh, "
                          f"{ref['dropped'][0]!r} on one card")
                say(f"{label} vs one card: loss {got['loss'][0]!r} / {ref['loss'][0]!r}, "
                    f"grad_norm {got['gnorm'][0]!r} / {ref['gnorm'][0]!r}, max abs param "
                    f"diff {worst:.3e}, AdamW m {m_rel:.3e} of its norm off ({m_leaf})")
                del one, ref
                free()
        lmm_barrier(device)
    with open(os.path.join(LMM_DIR, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    lmm_barrier(device)


def phase_lm_mesh(smi_line: str, part: str):
    """Phase 18, the LM mesh (see the module docstring); (a) runs phases 19 (a) and 20 (a)
    in its ranks too, and returns (kernel rows, phase 19 (a)'s row_dot / row_sum
    launches).  (a), in the full run: 2 gloo
    ranks on card 0, ``yi-9b`` cut to 2 layers at full width (bf16, AdamW with master
    weights, the OT term on 'pallas'), one step on a (data=1, model=2) and a (2, 1)
    mesh, each against one card's ``Trainer`` step of the same cut (here, before the
    ranks start): loss and grad_norm within rtol 1e-3, parameters within 5e-3, AdamW's m
    within 5 % of each leaf's norm, the ranks' loss and OT
    distance bit for bit; K1, K4 and K5 launched on every rank.  Returns the kernel
    rows at the trainers' OT shapes (d = 4096; phase 20 (a)'s whisper, d = 1024).  (b),
    ``--lm-mesh-only`` on four
    cards (NCCL, a card a rank, (2, 2)): ``yi-9b`` at full width and depth, 3 steps of
    8 x 512 tokens; the 2-layer cut and ``qwen2-moe-a2.7b`` cut to 4 layers (with
    ``local_dispatch`` off and on) against one card."""
    import dataclasses
    import socket

    import torch

    from repro_torch.kernels import _build as kbuild
    from repro_torch.models import build_model
    from repro_torch.models.common import count_params

    t_phase = time.perf_counter()
    world = 2 if part == "a" else 4
    os.makedirs(LMM_DIR, exist_ok=True)
    for name in os.listdir(LMM_DIR):
        os.remove(os.path.join(LMM_DIR, name))
    rows, ref = [], None
    if part == "a":
        check(torch.cuda.device_count() >= 1, "phase 18 (a) needs a card")
        n_params = count_params(build_model(lmm_cut(LMM_ARCH, 48), device="meta"))
        check(n_params == LMM_PARAMS, f"{LMM_ARCH} has {n_params} parameters, not {LMM_PARAMS}")

    def one_card():
        """(a)'s one-card side (phases 18, 19 and 20), run here while the ranks start and
        train: the ranks spend most of their time in cold starts and on the host's gloo
        copies, and the card's memory holds both (the VLM period's check first, while
        the ranks hold the least)."""
        am = am_reference(torch.device("cuda"))
        fresh_memory()
        sm = sm_reference(torch.device("cuda"))
        one = lmm_trainer(lmm_cut(LMM_ARCH, LMM_CUT), LMM_A, torch.device("cuda"))
        batch = one.batch(0)
        ops = lm_ot_operands(one, batch, torch.device("cuda"))
        ref = lmm_run(one, 1, torch.device("cuda"))
        # the OT term of the step-0 batch once more, fused (K8), for the kernel rows
        kbuild.reset_launch_counts()
        with torch.no_grad():
            one.tcfg = dataclasses.replace(one.tcfg, ot_grad_impl="fused")
            one.ot_loss(batch)
        fused_launches = kbuild.launch_counts()
        del one, batch
        fresh_memory()
        print(f"phase 18 (a) one card ({smi_line}; concurrent with the ranks): {LMM_ARCH} "
              f"{LMM_CUT} layers, loss {ref['loss']}, ot {ref['ot']}, state {ref['state_b']} B, "
              f"peak {ref['peak']} B, step {ref['walls']} s (split {ref['splits']}); launches "
              f"{ref['launches']}; the fused OT term {fused_launches}", flush=True)
        return ref, ops, fused_launches, sm, am

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    t0 = time.perf_counter()
    try:
        for r in range(world):
            log = open(os.path.join(LMM_DIR, f"rank{r}.log"), "w")
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--lm-mesh-rank", str(r),
                 "--lm-mesh-part", part, "--mesh-init", f"tcp://127.0.0.1:{port}"],
                stdout=log, stderr=subprocess.STDOUT))
        if part == "a":
            ref, ops, fused_launches, sm_ref, (am_ref, am_ops, am_fused) = one_card()
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break                          # one rank failed: stop the others
            if time.perf_counter() - t0 > LMM_TIMEOUT_S[part]:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r in range(len(procs)):
        with open(os.path.join(LMM_DIR, f"rank{r}.log")) as f:
            for line in f.read().splitlines()[-60:]:
                print(f"  [rank {r}] {line}", flush=True)
    rcs = [p.returncode for p in procs]
    check(all(rc == 0 for rc in rcs), f"phase 18 ({part}): the ranks exited {rcs} after "
                                      f"{wall:.1f} s (limit {LMM_TIMEOUT_S[part]} s)")
    res = []
    for r in range(world):
        with open(os.path.join(LMM_DIR, f"rank{r}.json")) as f:
            res.append(json.load(f))
    for label, run in res[0]["runs"].items():
        if "loss" not in run or "vs one card" in label or "one card" in label:
            continue
        for x in res[1:]:
            other = x["runs"][label]
            check(other["loss"] == run["loss"] and other["ot"] == run["ot"],
                  f"phase 18 {label}: the ranks' losses or OT distances differ: "
                  f"{run['loss']} {run['ot']} / {other['loss']} {other['ot']}")
        for r, x in enumerate(res):
            ln = x["runs"][label]["launches"]
            check(ln.get(K1, 0) > 0 and ln.get(K4, 0) > 0 and ln.get(K5, 0) + ln.get(K6, 0) > 0,
                  f"phase 18 {label}: rank {r} did not launch K1, K4 and K5/K6: {ln}")
        for r, x in enumerate(res):
            rr = x["runs"][label]
            med = sorted(rr["walls"])[len(rr["walls"]) // 2]
            tokens = (LMM_A if part == "a" else LMM_B)["batch"] * \
                (LMM_A if part == "a" else LMM_B)["seq"]
            print(f"phase 18 ({res[0]['backend']}, {smi_line}) {label} rank {r}: loss "
                  f"{rr['loss']}, ot {rr['ot']}, step walls {rr['walls']} s ({tokens / med:.1f} "
                  f"tokens/s at the median), state {rr['state_b']} B, peak {rr['peak']} B, "
                  f"launches {rr['launches']}; split " +
                  "; ".join(", ".join(f"{p} {t:.4f}" for p, t in sp.items())
                            for sp in rr["splits"]) +
                  ("" if not rr.get("profile") else f"; profile {rr['profile']}"), flush=True)
    if part == "a":
        for shape in ((1, 2), (2, 1)):
            got = dict(res[0]["runs"][f"{LMM_ARCH} {LMM_CUT} layers on {shape}"])
            got.update(torch.load(os.path.join(LMM_DIR, f"a_{shape[0]}x{shape[1]}.pt")))
            worst, m_rel, m_leaf = lmm_compare(f"(a) {shape}", ref, got)
            print(f"phase 18 (a) {shape} vs one card: loss {got['loss'][0]!r} / "
                  f"{ref['loss'][0]!r}, grad_norm {got['gnorm'][0]!r} / {ref['gnorm'][0]!r}, "
                  f"max abs parameter difference {worst:.3e}, AdamW m {m_rel:.3e} of its "
                  f"norm off ({m_leaf})", flush=True)
        counts = {k: (f"phase 18 (a) {LMM_ARCH} {LMM_CUT} layers, one step on one card, "
                      "grad_impl 'pallas'", ref["launches"].get(k, 0)) for k in (K1, K4, K5, K6)}
        counts[K8] = (f"phase 18 (a) {LMM_ARCH} {LMM_CUT} layers, the step-0 OT term on one "
                      "card, grad_impl 'fused'", fused_launches.get(K8, 0))
        rows = phase_lm_kernels(*ops[:5], counts, smi_line, torch.device("cuda"),
                                phase="phase 18 (a)", suffix=LMM_ROW)
        del ops
        sm_launches = sm_compare_a(sm_ref, res,
                                   lambda name: torch.load(os.path.join(LMM_DIR, name)))
        counts = am_compare_a(am_ref, res, lambda name: torch.load(os.path.join(LMM_DIR, name)))
        counts[K8] = ("phase 20 (a) one card: whisper-medium 2 + 2 layers, the step-0 OT term, "
                      "grad_impl 'fused'", am_fused.get(K8, 0))
        rows += phase_lm_kernels(*am_ops[:5], counts, smi_line, torch.device("cuda"),
                                 phase="phase 20 (a)", suffix=AM_ROW)
        del am_ops
        for name in os.listdir(LMM_DIR):
            if name.endswith(".pt"):
                os.remove(os.path.join(LMM_DIR, name))
    else:
        need = LMM_STATE_B * LMM_PARAMS
        peaks = [x["runs"][f"{LMM_ARCH} 48 layers on (2, 2)"]["peak"] for x in res]
        print(f"phase 18 (b) ({smi_line}): {LMM_ARCH} at 48 layers on (2, 2): each card's "
              f"peak {peaks} B, against {need} B ({need / 1e9:.1f} GB) one card would need "
              f"for the AdamW step's state alone", flush=True)
        for label, run in res[0]["runs"].items():
            if "vs one card" in label:
                print(f"phase 18 (b) {label}: {run}", flush=True)
    print(f"phase 18 ({part}) took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return (rows, sm_launches) if part == "a" else rows


# -- phase 19: serving on the LM mesh (sharded prefill and decode, the OT router) --------

SM_ARCH, SM_OT_ARCH = "phi3.5-moe-42b-a6.6b", "qwen2-moe-a2.7b"
SM_PARAMS = 41_872_527_360           # phi3.5-moe-42b-a6.6b's parameter count (JAX's)
SM_CUT = 2                           # the checks' depth cut: 2 of its 32 layers (and of
                                     # qwen2-moe-a2.7b's 24 with the OT router)
# (a)'s requests: on (2, 1) two gloo ranks gather every weight through the host at each
# forward (9.6 s a forward for the check cut, PERF.md PR 27), so 2 prefills and 1 tick
SM_CHECK = dict(prompts=(48, 96), new=2, max_batch=2, max_len=128)
SM_CHECK_B = dict(prompts=(48, 64, 96, 80), new=4, max_batch=4, max_len=128)   # (b)'s
SM_OT = dict(prompts=(32, 48), new=2, max_batch=2, max_len=64)      # (a)'s OT cut, (2, 1)
SM_FULL = dict(requests=16, prompt=(64, 512), new=32, max_batch=16, max_len=1024)   # (b)
SM_LOGIT_TOL = 1e-3                  # prefill logits against one card, rtol and atol
SM_DIR = os.path.join(HERE, "_archive", "phase19")    # git-ignored: (b)'s rank logs
SM_PROFILED_TICKS = 2                # (b): ticks under torch.profiler, a rank
SM_TIMEOUT_S = 780


def sm_pairs(vocab, spec, seed):
    """(rid, prompt) pairs: ``spec['prompts']``' lengths, or ``spec['requests']`` of
    lengths drawn in ``spec['prompt']``'s range."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = spec.get("prompts") or [int(n) for n in rng.integers(*spec["prompt"],
                                                                 spec["requests"])]
    return [(i, rng.integers(0, vocab, n).astype(np.int32)) for i, n in enumerate(lens)]


def sm_ot_cut():
    """``qwen2-moe-a2.7b`` cut to SM_CUT layers, routed by the OT solver (float32 compute,
    as every check cut)."""
    import dataclasses

    cfg = lmm_cut(SM_OT_ARCH, SM_CUT)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, ot_balance=True))


def sm_serve(cfg, model, spec, seed, device, mesh=None):
    """Serve ``spec``'s requests through ``ServingEngine`` (on ``mesh`` where given), each
    admission and tick timed (``drive_engine``); the prefills' last logits, whole (the
    vocabulary's blocks gathered on a mesh), on the host.  Returns (run, logits)."""
    import logging

    from repro_torch.core import distributed as D
    from repro_torch.serving.engine import ServingEngine

    logging.getLogger("serving").setLevel(logging.WARNING)     # no line a request
    engine = ServingEngine(cfg, model, max_batch=spec["max_batch"], max_len=spec["max_len"],
                           device=device, mesh=mesh)
    logits, prefill = [], engine.model.prefill
    axes = () if mesh is None else engine.model._vocab_block()[0]

    def recording(tokens, caches, memory=None):
        lg, caches = prefill(tokens, caches, memory)
        logits.append(D.all_gather_axes(lg[0, -1], mesh, axes, 0).float().cpu()
                      if axes else lg[0, -1].float().cpu())
        return lg, caches

    engine.model.prefill = recording
    run = drive_engine(engine, sm_pairs(cfg.vocab_size, spec, seed), spec["new"])
    engine.model.prefill = prefill
    run["tokens"] = {r.rid: r.out_tokens for r in run["done"]}
    run["engine"] = engine
    return run, logits


def sm_ot_run(cfg, model, device, mesh=None):
    """The OT-routed cut served on SM_OT's requests: its tokens, solves, launches and wall;
    on a mesh also whether every routing (each MoE layer at every prefill and tick) is,
    bit for bit, the one-device ``ot_route`` of the whole batch's router logits (the
    solve's inputs gathered here from the layer's input and the router weight)."""
    import torch

    from repro_torch.core import distributed as D
    from repro_torch.kernels import _build
    from repro_torch.ot import diff
    from repro_torch.sharding import partition as P
    from repro_torch.training import ot_routing

    moes = [b.moe for b in model.blocks]
    inputs = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: inputs.append((mod, args[0])))
             for m in moes]
    for m in moes:
        m.routes = []
    diff.reset_solve_count()
    _build.reset_launch_counts()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    run, _ = sm_serve(cfg, model, SM_OT, 19, device, mesh)
    torch.cuda.synchronize(device)
    out = dict(tokens=run["tokens"], solves=diff.solve_count(),
               launches=_build.launch_counts(), wall=time.perf_counter() - t0)
    for h in hooks:
        h.remove()
    if mesh is not None:
        data = run["engine"]._data
        seen, same = {id(m): 0 for m in moes}, True
        for mod, x in inputs:
            topi, topw = mod.routes[seen[id(mod)]]
            seen[id(mod)] += 1
            axes = () if x.shape[1] > 1 else data         # a prefill's one row is whole
            gather = lambda t: D.all_gather_axes(t, mesh, axes, 0) if axes else t
            with torch.no_grad():
                logits = (x.reshape(-1, x.shape[-1])
                          @ P.weight(mod, "router", keep=()).to(x.dtype)).float()
                whole = gather(logits)
                ti, tw = ot_routing.ot_route(whole, num_seqs=whole.shape[0] // x.shape[1],
                                             seq_len=x.shape[1], top_k=cfg.moe.top_k,
                                             gamma=cfg.moe.ot_gamma, rho=cfg.moe.ot_rho)
            same &= torch.equal(gather(topi), ti) and torch.equal(gather(topw), tw.float())
        out["same_problem"] = bool(same)
        out["routings"] = len(inputs)
    for m in moes:
        m.routes = None
    return out


def sm_reference(device):
    """Phase 19 (a)'s one-card side, in the main process before the ranks start: the
    check cut and the OT cut served on the card.  Returns their tokens and logits."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.models.common import count_params

    n = count_params(build_model(lmm_cut(SM_ARCH, 32), device="meta"))
    check(n == SM_PARAMS, f"{SM_ARCH} has {n} parameters, not {SM_PARAMS}")
    cfg = lmm_cut(SM_ARCH, SM_CUT)
    model = build_model(cfg, device, seed=0)
    run, logits = sm_serve(cfg, model, SM_CHECK, 19, device)
    check_served("(a) one card", run["done"], len(SM_CHECK["prompts"]), SM_CHECK["new"],
                 phase="phase 19")
    ref = {"tokens": run["tokens"], "logits": logits}
    del model, run
    fresh_memory()
    ot_cfg = sm_ot_cut()
    ref["ot"] = sm_ot_run(ot_cfg, build_model(ot_cfg, device, seed=0), device)
    fresh_memory()
    print(f"phase 19 (a) one card: {SM_ARCH} cut to {SM_CUT} layers (bf16 parameters, float32 "
          f"compute), tokens {ref['tokens']}; the OT cut ({SM_OT_ARCH}, {SM_CUT} layers) "
          f"tokens {ref['ot']['tokens']}, {ref['ot']['solves']} solves, launches "
          f"{ref['ot']['launches']}", flush=True)
    torch.cuda.synchronize()
    return ref


def sm_rank_a(meshes, device, out, save):
    """Phase 19 (a) on a rank of phase 18 (a)'s two gloo ranks: the check cut on (1, 2)
    and (2, 1), the OT cut on (2, 1); every rank's tokens, rank 0's prefill logits
    (``save``)."""
    import torch

    from repro_torch.models import build_on_mesh
    from repro_torch.sharding import partition as P

    cfg = lmm_cut(SM_ARCH, SM_CUT)
    for shape, mesh in meshes.items():
        t0 = time.perf_counter()
        model = build_on_mesh(cfg, device, P.default_rules(mesh.axis_names), mesh)
        run, logits = sm_serve(cfg, model, SM_CHECK, 19, device, mesh)
        label = f"{SM_ARCH} {SM_CUT} layers on {shape}"
        out["serve"][label] = dict(tokens=run["tokens"], admit=run["admit"],
                                   ticks=run["ticks"], wall=time.perf_counter() - t0,
                                   peak=run["peak"])
        save(f"sm_{shape[0]}x{shape[1]}.pt", logits)
        del model, run
        fresh_memory()
    ot_cfg, mesh = sm_ot_cut(), meshes[(2, 1)]
    model = build_on_mesh(ot_cfg, device, P.default_rules(mesh.axis_names), mesh)
    ot = sm_ot_run(ot_cfg, model, device, mesh)
    out["serve"][f"{SM_OT_ARCH} {SM_CUT} layers, OT router, on (2, 1)"] = ot
    del model
    fresh_memory()
    torch.cuda.synchronize(device)


def sm_compare_a(ref, res, load):
    """Phase 19 (a)'s checks: each mesh's tokens the card's and every rank's the same, its
    prefill logits within SM_LOGIT_TOL of the card's; the OT cut's tokens every rank's
    the same, each routing the one-device solve of the whole batch's router logits, its
    row_dot / row_sum launched, its tokens beside the card's (the 40-iteration solve
    moves with the last bits of its logits, ROADMAP C: reported, not held).  Returns
    {kernel: (path, launches)} of the OT run."""
    import torch

    for shape in ((1, 2), (2, 1)):
        label = f"{SM_ARCH} {SM_CUT} layers on {shape}"
        got = [x["serve"][label] for x in res]
        toks = [{int(k): v for k, v in g["tokens"].items()} for g in got]
        check(all(t == toks[0] for t in toks), f"phase 19 (a) {label}: the ranks' tokens differ")
        check(toks[0] == ref["tokens"], f"phase 19 (a) {label}: tokens {toks[0]} on the mesh, "
                                        f"{ref['tokens']} on one card")
        logits = load(f"sm_{shape[0]}x{shape[1]}.pt")
        errs = [float((a - b).abs().max()) for a, b in zip(logits, ref["logits"])]
        check(len(logits) == len(ref["logits"]) and all(
            torch.allclose(a, b, rtol=SM_LOGIT_TOL, atol=SM_LOGIT_TOL)
            for a, b in zip(logits, ref["logits"])),
            f"phase 19 (a) {label}: prefill logits off one card's by {errs}")
        g = got[0]
        ticks = [t for _, t in g["ticks"]]
        print(f"phase 19 (a) {label} (two gloo ranks on one card): every request's tokens "
              f"the card's, every rank's the same; prefill logits within {SM_LOGIT_TOL} "
              f"(max abs err {max(errs):.3e}); admission {g['admit']:.3f} s, "
              f"{len(ticks)} ticks, median {sorted(ticks)[len(ticks) // 2] * 1e3:.1f} ms a "
              f"tick, peak {g['peak']} B, {g['wall']:.1f} s with the draw", flush=True)
    label = f"{SM_OT_ARCH} {SM_CUT} layers, OT router, on (2, 1)"
    ots = [x["serve"][label] for x in res]
    toks = [{int(k): v for k, v in o["tokens"].items()} for o in ots]
    check(all(t == toks[0] for t in toks), f"phase 19 (a) {label}: the ranks' tokens differ")
    check(all(o["same_problem"] for o in ots),
          f"phase 19 (a) {label}: a routing is not the one-device solve of the whole "
          f"batch's router logits")
    ln, solves = ots[0]["launches"], ots[0]["solves"]
    check(ln.get(ROW_DOT, 0) > 0 and ln.get(ROW_SUM, 0) > 0,
          f"phase 19 (a) {label}: the router launched no {ROW_DOT} or {ROW_SUM}: {ln}")
    agree = toks[0] == ref["ot"]["tokens"]
    print(f"phase 19 (a) {label}: {solves} solves on each rank, each of the "
          f"{ots[0]['routings']} routings the one-device ot_route of the whole batch's router "
          f"logits bit for bit (every rank the same problem); tokens "
          f"{'the card' + chr(39) + 's' if agree else 'NOT the card' + chr(39) + 's'} "
          f"({toks[0]} / {ref['ot']['tokens']}); {ROW_DOT} {ln.get(ROW_DOT, 0)} "
          f"({ln.get(ROW_DOT, 0) / solves:.1f} a solve), {ROW_SUM} {ln.get(ROW_SUM, 0)} "
          f"({ln.get(ROW_SUM, 0) / solves:.1f} a solve) on rank 0; one card "
          f"{ref['ot']['launches']}; {ots[0]['wall']:.1f} s", flush=True)
    path = f"phase 19 (a) {label}, {SM_OT['max_batch']} slots, rank 0"
    return {k: (path, ln.get(k, 0)) for k in (ROW_DOT, ROW_SUM)}


def serve_mesh_rank(rank: int, init: str) -> None:
    """One rank of phase 19 (b) (see ``phase_serve_mesh``); exits non-zero on any failed
    check.  Its results go to ``SM_DIR/rank{rank}.json``."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import distributed as D
    from repro_torch.models import build_model, build_on_mesh
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.sharding import partition as P
    from repro_torch.utils.tree import tree_bytes

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    backend, device = D.init_process_group(4, rank, init, timeout_s=900)
    say = lambda msg: print(f"[{time.perf_counter() - t_start:.1f} s] {msg}", flush=True)
    say(f"phase 19 (b): backend {backend}, rank {rank} on {device} "
        f"({torch.cuda.get_device_name(device)})")
    out = {"backend": backend, "runs": {}}
    meshes = {shape: D.make_mesh(shape, ("data", "model")) for shape in ((1, 4), (2, 2))}

    def free():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

    cfg = get_config(SM_ARCH)
    for shape, mesh in meshes.items():
        rules = P.default_rules(mesh.axis_names)
        free()
        t0 = time.perf_counter()
        model = build_on_mesh(cfg, device, rules, mesh)
        torch.cuda.synchronize(device)
        t_draw = time.perf_counter() - t0
        label = f"{SM_ARCH} 32 layers on {shape}"
        cold, _ = sm_serve(cfg, model, SM_FULL, 20, device, mesh)    # the first, cold run
        check_served(f"(b) {label}", cold["done"], SM_FULL["requests"], SM_FULL["new"],
                     phase="phase 19")
        state_b = tree_bytes(dict(model.named_parameters())) + cache_bytes(cold["engine"].caches)
        cold = dict(tokens=cold["tokens"], wall=cold["wall"], admit=cold["admit"])
        free()
        run, _ = sm_serve(cfg, model, SM_FULL, 20, device, mesh)     # the timed, warm run
        del run["engine"]
        free()
        engine = ServingEngine(cfg, model, max_batch=SM_FULL["max_batch"],
                               max_len=SM_FULL["max_len"], device=device, mesh=mesh)
        prof = profile_ticks(engine, sm_pairs(cfg.vocab_size, SM_FULL, 20), SM_FULL["new"],
                             SM_PROFILED_TICKS, "phase 19 (b)")
        wall, busy, n_dev, krows = prof
        nccl = sum(us for k, us, _ in krows if "nccl" in k.lower()) / 1e6
        run.pop("done")
        out["runs"][label] = dict(
            tokens=run["tokens"], ticks=run["ticks"], admit=run["admit"], wall=run["wall"],
            peak=run["peak"], state_b=state_b, draw_s=t_draw, cold=cold,
            profile=dict(wall_s=wall, busy_s=busy, launches=n_dev, nccl_s=nccl,
                         top=[(k[:60], us / 1e3, c) for k, us, c in krows[:6]]))
        say(f"{label}: wall {run['wall']:.2f} s, admission {run['admit']:.2f} s, "
            f"{len(run['ticks'])} ticks, peak {run['peak']} B, state {state_b} B")
        check(run["peak"] < 80e9, f"phase 19 (b) {label}: peak {run['peak']} B")
        check(cold["tokens"] == run["tokens"], f"phase 19 (b) {label}: a second run gave "
                                               "other tokens")
        del model, engine, run
        free()
        # the check cut against one card (card 0, after every rank has served)
        cut = lmm_cut(SM_ARCH, SM_CUT)
        model = build_on_mesh(cut, device, rules, mesh)
        run, logits = sm_serve(cut, model, SM_CHECK_B, 19, device, mesh)
        label = f"{SM_ARCH} {SM_CUT} layers on {shape}"
        out["runs"][label] = dict(tokens=run["tokens"])
        if rank == 0:
            torch.save(logits, os.path.join(SM_DIR, f"b_{shape[0]}x{shape[1]}.pt"))
        del model, run
        free()
    if rank == 0:
        cut = lmm_cut(SM_ARCH, SM_CUT)
        run, logits = sm_serve(cut, build_model(cut, device, seed=0), SM_CHECK_B, 19, device)
        out["one card"] = dict(tokens=run["tokens"])
        torch.save(logits, os.path.join(SM_DIR, "b_one.pt"))
        del run
        free()
    lmm_barrier(device)
    with open(os.path.join(SM_DIR, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    lmm_barrier(device)


def phase_serve_mesh(smi_line: str):
    """Phase 19 (b), ``--serve-mesh-only`` on four cards (NCCL, a card a rank):
    ``phi3.5-moe-42b-a6.6b`` at full width and depth (bf16, 83.7 GB: no card holds it)
    served on (1, 4) and (2, 2), SM_FULL's 16 requests of 64-512 prompt tokens and 32 new
    ones through 16 slots of 1 024 positions; its 2-layer float32-compute cut on both
    meshes against one card (tokens equal, prefill logits within SM_LOGIT_TOL); per rank
    ms a tick, tokens/s, admission s, peak and state bytes, launches a tick and NCCL's
    device time in profiled ticks."""
    import socket
    import statistics

    import torch

    t_phase = time.perf_counter()
    os.makedirs(SM_DIR, exist_ok=True)
    for name in os.listdir(SM_DIR):
        os.remove(os.path.join(SM_DIR, name))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    t0 = time.perf_counter()
    try:
        for r in range(4):
            log = open(os.path.join(SM_DIR, f"rank{r}.log"), "w")
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--serve-mesh-rank", str(r),
                 "--mesh-init", f"tcp://127.0.0.1:{port}"],
                stdout=log, stderr=subprocess.STDOUT))
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break                          # one rank failed: stop the others
            if time.perf_counter() - t0 > SM_TIMEOUT_S:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r in range(len(procs)):
        with open(os.path.join(SM_DIR, f"rank{r}.log")) as f:
            for line in f.read().splitlines()[-40:]:
                print(f"  [rank {r}] {line}", flush=True)
    rcs = [p.returncode for p in procs]
    check(all(rc == 0 for rc in rcs), f"phase 19 (b): the ranks exited {rcs} after "
                                      f"{time.perf_counter() - t0:.1f} s")
    res = []
    for r in range(4):
        with open(os.path.join(SM_DIR, f"rank{r}.json")) as f:
            res.append(json.load(f))
    one = res[0]["one card"]["tokens"]
    ref = torch.load(os.path.join(SM_DIR, "b_one.pt"))
    for shape in ((1, 4), (2, 2)):
        label = f"{SM_ARCH} {SM_CUT} layers on {shape}"
        toks = [x["runs"][label]["tokens"] for x in res]
        check(all(t == one for t in toks), f"phase 19 (b) {label}: tokens {toks} on the "
                                           f"ranks, {one} on one card")
        logits = torch.load(os.path.join(SM_DIR, f"b_{shape[0]}x{shape[1]}.pt"))
        errs = [float((a - b).abs().max()) for a, b in zip(logits, ref)]
        check(all(torch.allclose(a, b, rtol=SM_LOGIT_TOL, atol=SM_LOGIT_TOL)
                  for a, b in zip(logits, ref)),
              f"phase 19 (b) {label}: prefill logits off one card's by {errs}")
        print(f"phase 19 (b) {label}: every rank's tokens one card's, prefill logits within "
              f"{SM_LOGIT_TOL} (max abs err {max(errs):.3e})", flush=True)
        label = f"{SM_ARCH} 32 layers on {shape}"
        toks = [x["runs"][label]["tokens"] for x in res]
        check(all(t == toks[0] for t in toks), f"phase 19 (b) {label}: the ranks' tokens differ")
        other = res[0]["runs"][f"{SM_ARCH} 32 layers on {(1, 4)}"]["tokens"]
        same = sum(toks[0][k] == other[k] for k in other)
        print(f"phase 19 (b) {label}: every rank's tokens the same, bit for bit, in both runs; "
              f"{same} of {len(other)} requests' tokens those of (1, 4) (bf16: the meshes sum "
              f"in other orders)", flush=True)
        for r, x in enumerate(res):
            g = x["runs"][label]
            ticks = [t for _, t in g["ticks"]]
            n_tok = sum(len(v) for v in g["tokens"].values())
            pr = g["profile"]
            print(f"phase 19 (b) ({res[0]['backend']}, {smi_line}) {label} rank {r}, warm run "
                  f"(the cold one {g['cold']['wall']:.3f} s, admission "
                  f"{g['cold']['admit']:.3f} s): "
                  f"{len(g['tokens'])} requests, {n_tok} tokens in {g['wall']:.3f} s "
                  f"({n_tok / g['wall']:.1f} tokens/s); {len(ticks)} ticks, median "
                  f"{statistics.median(ticks) * 1e3:.3f} ms a tick (min {min(ticks) * 1e3:.3f}, "
                  f"max {max(ticks) * 1e3:.3f}); admission {g['admit']:.3f} s for "
                  f"{len(g['tokens'])} prefills; state {g['state_b']} B (its parameter blocks "
                  f"and cache), peak {g['peak']} B; drawn in {g['draw_s']:.1f} s; profile of "
                  f"{SM_PROFILED_TICKS} ticks with {SM_FULL['max_batch']} live slots: wall "
                  f"{pr['wall_s']:.4f} s, device busy {pr['busy_s']:.4f} s, "
                  f"{pr['launches'] / SM_PROFILED_TICKS:.1f} device launches a tick, NCCL's "
                  f"kernels {pr['nccl_s']:.4f} s (waits for peers included); largest "
                  f"{pr['top']}", flush=True)
    print(f"phase 19 (b) took {time.perf_counter() - t_phase:.1f} s", flush=True)


# -- phase 20: the attention families on the LM mesh (MLA, the encoder-decoder, the VLM) ---

AM_ARCHS = (FAM_MLA_ARCH, FAM_ED_ARCH, FAM_VLM_ARCH)
AM_VLM_PARAMS = 87_666_958_356       # llama-3.2-vision-90b's parameter count (the port's
                                     # build_model on meta): 175.3 GB in bf16
AM_CUTS = {FAM_MLA_ARCH: dict(num_layers=2),                 # the checks' depth cuts
           FAM_ED_ARCH: dict(num_layers=2, encoder_layers=2),
           FAM_VLM_ARCH: dict(num_layers=5)}                  # one period, 5 of 100 layers
# (a)'s meshes: the VLM period's 12.8 GB would cross the host at every forward on (2, 1)
AM_MESHES_A = {FAM_MLA_ARCH: ((1, 2), (2, 1)), FAM_ED_ARCH: ((1, 2), (2, 1)),
               FAM_VLM_ARCH: ((1, 2),)}
# (a)'s steps: whisper's OT problem L 8, g 2 (the kernel rows' tile of 8 groups; its
# encoder's scores are 16 heads x 1500^2 a row), the VLM's L 4, g 2
AM_TRAIN_A = {FAM_MLA_ARCH: LMM_A, FAM_ED_ARCH: dict(batch=32, seq=32, classes=8),
              FAM_VLM_ARCH: dict(batch=16, seq=32, classes=4)}
AM_STEPS_A = dict(batch=2, prompt=16, new=2)       # (a): prefill, then decode steps
AM_ENGINE_A = dict(prompts=(16, 24), new=2, max_batch=2, max_len=64)   # (a): MLA's engine,
                                     # on (1, 2) (on (2, 1) every forward gathers the
                                     # weights through the host, about 2 s on an H100)
AM_TRAIN_B = dict(batch=8, seq=512, classes=4, steps=3)           # (b)'s trainers
AM_STEPS_B = dict(batch=8, prompt=512, new=32)     # (b): the VLM at full depth
AM_CHECK_B = dict(batch=4, prompt=64, new=4)       # (b): the cuts' steps against one card
AM_ENGINE_B = dict(requests=8, prompt=(64, 512), new=32, max_batch=8, max_len=576)
AM_ENGINE_CHECK_B = dict(prompts=(48, 64, 96, 80), new=4, max_batch=4, max_len=128)
AM_PROFILED = 2                      # (b): decode steps or ticks under torch.profiler
AM_DIR = os.path.join(HERE, "_archive", "phase20")    # git-ignored: (b)'s rank logs
AM_TIMEOUT_S = 1000
AM_ROW = "@attn_mesh_step"           # suffix of the kernel rows at whisper's OT shape


def am_cut(arch, compute=None, full=False):
    """``arch`` at full width, cut to its check depth (``full``: at its whole depth), the
    compute dtype ``compute`` where given (bf16 parameters either way)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if not full:
        cfg = dataclasses.replace(cfg, **AM_CUTS[arch])
    if compute is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=compute)
    return cfg


def am_step_cut(arch):
    """(b)'s one-step check against card 0: the MLA cut, bf16; ``whisper-medium`` at full
    depth in float32 compute (in bf16 its 48 layers' roundings moved the gradient norm
    1.3e-3 off one card's on four H100s, over LMM_GNORM_RTOL)."""
    if arch == FAM_ED_ARCH:
        return am_cut(arch, "float32", full=True), "full depth, float32 compute"
    return am_cut(arch), "cut"


def am_gates(model):
    """A VLM's ``cross_gate`` set to FAM_VLM_GATE in every period (its init, 0, hides the
    cross path); nothing for the other families."""
    import torch

    if model.cfg.family == "vlm":
        with torch.no_grad():
            for block in model.blocks:
                block.cross_gate.fill_(FAM_VLM_GATE)


def am_grads(cfg, shape, device, mesh=None):
    """Step 0 of a phase 18 trainer (``lmm_setup``) without its optimizer, whose state a
    VLM period leaves no room for on one card: the trainer's ``loss_and_grads`` (the OT
    term's gradient included) on a ``Trainer`` whose state is its parameters alone.
    Returns its loss, the gradients' global norm (each distinct block once on a mesh),
    OT distance, launches, wall s and peak B."""
    import contextlib

    import torch

    from repro_torch.core import distributed as D
    from repro_torch.kernels import _build as kbuild
    from repro_torch.models import build_model, build_on_mesh
    from repro_torch.sharding import partition as P
    from repro_torch.training.trainer import Trainer
    from repro_torch.utils.tree import tree_global_norm

    class GradTrainer(Trainer):
        def __init__(self):                 # Trainer.__init__ without the optimizer state
            self.cfg = cfg
            self.tcfg, self.data = lmm_setup(cfg, shape)
            self.mesh = mesh if P.on_mesh(mesh) else None
            if self.mesh is not None:
                self.rules = P.default_rules(mesh.axis_names)
                self.device = D.rank_device(device)
                self.model = build_on_mesh(cfg, self.device, self.rules, self.mesh,
                                           self.tcfg.seed)
            else:
                self.rules, self.device = None, device
                self.model = build_model(cfg, device, seed=self.tcfg.seed)
            self.placements = P.placements(self.model)
            self.state = {"params": dict(self.model.named_parameters())}

    tr = GradTrainer()
    am_gates(tr.model)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    kbuild.reset_launch_counts()
    t0 = time.perf_counter()
    with P.use_rules(tr.rules, tr.mesh) if tr.mesh is not None else contextlib.nullcontext():
        metrics, grads = tr.loss_and_grads(tr.batch(0))
        gnorm = (P.global_norm(grads, tr.placements) if tr.mesh is not None
                 else tree_global_norm(grads))
        out = dict(loss=float(metrics["loss"]), gnorm=float(gnorm),
                   ot=float(metrics["ot_distance"]))
    torch.cuda.synchronize(device)
    out.update(launches=kbuild.launch_counts(), wall=time.perf_counter() - t0,
               peak=torch.cuda.max_memory_allocated(device))
    return out


def am_steps(cfg, model, spec, seed, device, profiled=0):
    """Prefill (``make_prefill_step``) of ``spec['batch']`` prompts of ``spec['prompt']``
    tokens (numpy seed ``seed``) with the stub frontend's frames or image tokens, then
    ``spec['new']`` greedy decode steps (``make_serve_step``); on a mesh (the model placed
    there) under its rules, each step given the whole batch, its next tokens gathered over
    the data axes.  Returns the tokens (B, 1 + new), the prefill's last logits whole (the
    vocabulary's blocks and the rows gathered; float32, host), prefill s, each decode
    step's s (host clock, each ending in a synchronize), peak B, state B (parameter
    blocks and cache), and with ``profiled`` that many more decode steps under
    torch.profiler (wall, busy, device launches, NCCL's kernels' device s)."""
    import numpy as np
    import torch

    from repro_torch.core import distributed as D
    from repro_torch.data.pipeline import modality_stub
    from repro_torch.launch import steps
    from repro_torch.models.common import torch_dtype
    from repro_torch.sharding import partition as P
    from repro_torch.utils.tree import tree_bytes

    B, S, new = spec["batch"], spec["prompt"], spec["new"]
    rules, mesh = P.module_mesh(model) or (None, None)
    gather = lambda t, dim, axes: D.all_gather_axes(t, mesh, axes, dim) if axes else t
    rows = () if mesh is None else P.batch_split(B, rules, mesh)
    vocab = () if mesh is None else model._vocab_block()[0]
    params = {k: p.detach() for k, p in model.named_parameters()}
    prompts = torch.as_tensor(np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)),
                              dtype=torch.int32, device=device)
    mem = modality_stub(cfg, B, seed)
    mem = (torch.as_tensor(next(iter(mem.values())), device=device)
           .to(torch_dtype(cfg.compute_dtype)) if mem else None)
    prefill, serve = steps.make_prefill_step(cfg), steps.make_serve_step(cfg)
    with P.use_rules(rules, mesh):
        caches = model.init_cache(B, S + new + profiled + 8)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        logits, caches = prefill(params, prompts, caches, mem)
        token = gather(model.greedy(logits[:, -1, :]).to(torch.int32)[:, None], 0, rows)
        torch.cuda.synchronize(device)
        t_prefill = time.perf_counter() - t0
        last = gather(gather(logits[:, -1, :], 1, vocab), 0, rows).float().cpu()
        out, walls = [token], []
        for i in range(new):
            t0 = time.perf_counter()
            token, caches = serve(params, token, caches, S + i)
            token = gather(token, 0, rows)
            torch.cuda.synchronize(device)
            walls.append(time.perf_counter() - t0)
            out.append(token)
        res = dict(tokens=torch.cat(out, dim=1).cpu().tolist(), logits=last,
                   prefill_s=t_prefill, step_s=walls,
                   peak=torch.cuda.max_memory_allocated(device),
                   state_b=tree_bytes(params) + cache_bytes(caches))
        if profiled:
            def more():
                tok, c = token, caches
                for i in range(new, new + profiled):
                    tok, c = serve(params, tok, c, S + i)
                    tok = gather(tok, 0, rows)

            _, wall, busy, n_dev, krows = profile_device(more)
            res["profile"] = dict(
                wall_s=wall, busy_s=busy, launches=n_dev,
                nccl_s=sum(us for k, us, _ in krows if "nccl" in k.lower()) / 1e6,
                top=[(k[:60], us / 1e3, c) for k, us, c in krows[:6]])
    return res


def am_reference(device):
    """Phase 20 (a)'s one-card side, in the main process before the ranks start: each
    family's cut trained one step (the VLM period's loss and gradients alone), its
    float32-compute twin prefilled and decoded through the steps, MLA's also through
    the engine; whisper's step-0 OT operands (d = 1024) and its fused OT term's
    launches for the kernel rows.  Returns (the runs by arch, the operands, those
    launches)."""
    import dataclasses

    import torch

    from repro_torch.kernels import _build as kbuild
    from repro_torch.models import build_model
    from repro_torch.models.common import count_params

    n = count_params(build_model(am_cut(FAM_VLM_ARCH, full=True), device="meta"))
    check(n == AM_VLM_PARAMS, f"{FAM_VLM_ARCH} has {n} parameters, not {AM_VLM_PARAMS}")
    ref, ops, fused = {}, None, None
    for arch in AM_ARCHS:
        cfg = am_cut(arch)
        if arch == FAM_VLM_ARCH:
            r = am_grads(cfg, AM_TRAIN_A[arch], device)
        else:
            one = lmm_trainer(cfg, AM_TRAIN_A[arch], device)
            if arch == FAM_ED_ARCH:
                batch = one.batch(0)
                ops = lm_ot_operands(one, batch, device)
            r = lmm_run(one, 1, device)
            if arch == FAM_ED_ARCH:          # the OT term of step 0 once more, fused (K8)
                kbuild.reset_launch_counts()
                with torch.no_grad():
                    one.tcfg = dataclasses.replace(one.tcfg, ot_grad_impl="fused")
                    one.ot_loss(batch)
                fused = kbuild.launch_counts()
                del batch
            del one
        fresh_memory()
        cfg32 = am_cut(arch, "float32")
        model = build_model(cfg32, device, seed=0)
        am_gates(model)
        r["steps"] = am_steps(cfg32, model, AM_STEPS_A, 20, device)
        if arch == FAM_MLA_ARCH:
            eng, logits = sm_serve(cfg32, model, AM_ENGINE_A, 21, device)
            r["engine"], r["engine_logits"] = eng["tokens"], logits
            del eng
        del model
        fresh_memory()
        ref[arch] = r
        print(f"phase 20 (a) one card: {arch} {AM_CUTS[arch]}: loss {r['loss']}, grad norm "
              f"{r['gnorm']}, ot {r['ot']}; steps' tokens {r['steps']['tokens']}"
              + (f"; engine tokens {r['engine']}" if "engine" in r else ""), flush=True)
    return ref, ops, fused


def am_rank_a(meshes, device, out, save):
    """Phase 20 (a) on a rank of phase 18 (a)'s two gloo ranks: each family's cut on its
    meshes (AM_MESHES_A): one train step (the VLM's loss and gradients), the float32
    twin through the steps, MLA's through the engine; rank 0's gathered parameters,
    AdamW m and logits (``save``)."""
    import torch

    from repro_torch.models import build_on_mesh
    from repro_torch.sharding import partition as P

    for arch in AM_ARCHS:
        for shape in AM_MESHES_A[arch]:
            mesh, tag = meshes[shape], f"{arch}_{shape[0]}x{shape[1]}"
            t0 = time.perf_counter()
            cfg = am_cut(arch)
            if arch == FAM_VLM_ARCH:
                run = am_grads(cfg, AM_TRAIN_A[arch], device, mesh)
            else:
                tr = lmm_trainer(cfg, AM_TRAIN_A[arch], device, mesh)
                lmm_check_blocks(tr, f"(a) {tag}", "phase 20")
                full = lmm_run(tr, 1, device)
                save(f"am_{tag}.pt", {"params": full["params"], "m": full["m"]})
                run = dict(loss=full["loss"][0], gnorm=full["gnorm"][0], ot=full["ot"][0],
                           launches=full["launches"], wall=full["walls"][0],
                           peak=full["peak"], state_b=full["state_b"])
                del tr, full
            fresh_memory()
            cfg32 = am_cut(arch, "float32")
            model = build_on_mesh(cfg32, device, P.default_rules(mesh.axis_names), mesh)
            am_gates(model)
            st = am_steps(cfg32, model, AM_STEPS_A, 20, device)
            save(f"am_{tag}_logits.pt", st.pop("logits"))
            run["steps"] = st
            if arch == FAM_MLA_ARCH and shape == (1, 2):
                eng, logits = sm_serve(cfg32, model, AM_ENGINE_A, 21, device, mesh)
                run["engine"] = eng["tokens"]
                save(f"am_{tag}_engine.pt", logits)
                del eng
            run["wall_all"] = time.perf_counter() - t0
            out["attn"][f"{arch} on {shape}"] = run
            del model
            fresh_memory()
    torch.cuda.synchronize(device)


def am_compare(label, ref, got, vlm):
    """A mesh train run ``got`` against one card's ``ref``: the VLM's loss and gradient
    norm (no optimizer step) within LMM_LOSS_RTOL / LMM_GNORM_RTOL, the others through
    ``lmm_compare`` (parameters, AdamW m).  Returns the summary's words."""
    import math

    if not vlm:
        worst, m_rel, m_leaf = lmm_compare(label, ref, got, "phase 20")
        return (f"max abs parameter difference {worst:.3e}, AdamW m {m_rel:.3e} of its norm "
                f"off ({m_leaf})")
    for k, tol in (("loss", LMM_LOSS_RTOL), ("gnorm", LMM_GNORM_RTOL)):
        check(math.isfinite(got[k]) and abs(got[k] - ref[k]) <= tol * abs(ref[k]),
              f"phase 20 {label}: {k} {got[k]!r} on the mesh, {ref[k]!r} on one card")
    return "no optimizer step (the period's AdamW state does not fit one card)"


def am_check_steps(label, ref, got, logits, ref_logits):
    """The steps' tokens one card's; the prefill logits within SM_LOGIT_TOL."""
    import torch

    check(got["tokens"] == ref["tokens"], f"phase 20 {label}: tokens {got['tokens']} on the "
                                          f"mesh, {ref['tokens']} on one card")
    err = float((logits - ref_logits).abs().max())
    check(torch.allclose(logits, ref_logits, rtol=SM_LOGIT_TOL, atol=SM_LOGIT_TOL),
          f"phase 20 {label}: prefill logits off one card's by {err:.3e}")
    return err


def am_compare_a(ref, res, load):
    """Phase 20 (a)'s checks, after the ranks: every rank's losses, OT distances, gradient
    norms and tokens the same; K1, K4 and K5 or K6 launched on every rank; each run
    against the card's (``am_compare``; the steps' tokens and logits, MLA's engine's)."""
    import math

    for arch in AM_ARCHS:
        for shape in AM_MESHES_A[arch]:
            label, tag = f"(a) {arch} on {shape}", f"{arch}_{shape[0]}x{shape[1]}"
            got = [x["attn"][f"{arch} on {shape}"] for x in res]
            for k in ("loss", "ot", "gnorm"):
                check(all(g[k] == got[0][k] for g in got) and math.isfinite(got[0][k]),
                      f"phase 20 {label}: the ranks' {k} differ or are not finite: "
                      f"{[g[k] for g in got]}")
            check(all(g["steps"]["tokens"] == got[0]["steps"]["tokens"] for g in got),
                  f"phase 20 {label}: the ranks' tokens differ")
            for r, g in enumerate(got):
                ln = g["launches"]
                check(ln.get(K1, 0) > 0 and ln.get(K4, 0) > 0
                      and ln.get(K5, 0) + ln.get(K6, 0) > 0,
                      f"phase 20 {label}: rank {r} did not launch K1, K4 and K5/K6: {ln}")
            vlm = arch == FAM_VLM_ARCH
            g = dict(got[0])
            if not vlm:
                g = dict(loss=[g["loss"]], gnorm=[g["gnorm"]], **load(f"am_{tag}.pt"))
            words = am_compare(label, ref[arch], g, vlm)
            err = am_check_steps(label, ref[arch]["steps"], got[0]["steps"],
                                 load(f"am_{tag}_logits.pt"), ref[arch]["steps"]["logits"])
            eng = ""
            if "engine" in got[0]:
                toks = [{int(k): v for k, v in x["engine"].items()} for x in got]
                check(all(t == ref[arch]["engine"] for t in toks),
                      f"phase 20 {label}: engine tokens {toks} on the ranks, "
                      f"{ref[arch]['engine']} on one card")
                errs = [float((a - b).abs().max()) for a, b in
                        zip(load(f"am_{tag}_engine.pt"), ref[arch]["engine_logits"])]
                check(all(e <= SM_LOGIT_TOL for e in errs),
                      f"phase 20 {label}: the engine's prefill logits off one card's by {errs}")
                eng = (f"; through ServingEngine(mesh=) every request's tokens the card's, "
                       f"prefill logits {max(errs):.3e} off")
            st = got[0]["steps"]
            print(f"phase 20 {label} (two gloo ranks on one card): loss {got[0]['loss']!r} / "
                  f"{ref[arch]['loss']!r} one card's, grad norm {got[0]['gnorm']!r} / "
                  f"{ref[arch]['gnorm']!r}, ot {got[0]['ot']!r}, every rank's the same; "
                  f"{words}; the float32 steps' tokens the card's, prefill logits "
                  f"{err:.3e} off; step {got[0]['wall']:.2f} s, prefill "
                  f"{st['prefill_s']:.3f} s, decode {sorted(st['step_s'])[len(st['step_s']) // 2]:.3f} "
                  f"s a step, peak {got[0]['peak']} B, launches {got[0]['launches']}{eng}; "
                  f"{got[0]['wall_all']:.1f} s with the draws", flush=True)
    counts = {k: ("phase 20 (a) one card: whisper-medium 2 + 2 layers, one step, "
                  "grad_impl 'pallas'", ref[FAM_ED_ARCH]["launches"].get(k, 0))
              for k in (K1, K4, K5, K6)}
    return counts


def attn_mesh_rank(rank: int, init: str) -> None:
    """One rank of phase 20 (b) (see ``phase_attn_mesh``); exits non-zero on any failed
    check.  Its results go to ``AM_DIR/rank{rank}.json``, mesh rank 0's logits and
    gathered parameters to ``AM_DIR/*.pt``."""
    import gc
    import math

    import torch

    from repro_torch.core import distributed as D
    from repro_torch.models import build_model, build_on_mesh
    from repro_torch.models.common import count_params
    from repro_torch.sharding import partition as P
    from repro_torch.utils.tree import tree_bytes

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    backend, device = D.init_process_group(4, rank, init, timeout_s=900)
    say = lambda msg: print(f"[{time.perf_counter() - t_start:.1f} s] {msg}", flush=True)
    say(f"phase 20 (b): backend {backend}, rank {rank} on {device} "
        f"({torch.cuda.get_device_name(device)})")
    out = {"backend": backend, "runs": {}}
    meshes = {shape: D.make_mesh(shape, ("data", "model")) for shape in ((1, 4), (2, 2))}
    save = lambda name, obj: torch.save(obj, os.path.join(AM_DIR, name)) if rank == 0 else None

    def free():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

    def keep(label, run):
        out["runs"][label] = run
        check(run["peak"] < 80e9, f"phase 20 (b) {label}: peak {run['peak']} B")
        say(f"{label}: " + ", ".join(f"{k} {v}" for k, v in run.items()
                                     if k not in ("params", "m", "logits")))

    # llama-3.2-vision-90b at full width and depth, served through the steps
    cfg = am_cut(FAM_VLM_ARCH, full=True)
    for shape, mesh in meshes.items():
        rules = P.default_rules(mesh.axis_names)
        free()
        t0 = time.perf_counter()
        model = build_on_mesh(cfg, device, rules, mesh)
        am_gates(model)
        torch.cuda.synchronize(device)
        t_draw = time.perf_counter() - t0
        run = am_steps(cfg, model, AM_STEPS_B, 22, device, profiled=AM_PROFILED)
        run.pop("logits")
        run["draw_s"] = t_draw
        keep(f"{FAM_VLM_ARCH} 100 layers on {shape}", run)
        del model
        free()
        cut = am_cut(FAM_VLM_ARCH, "float32")
        model = build_on_mesh(cut, device, rules, mesh)
        am_gates(model)
        run = am_steps(cut, model, AM_CHECK_B, 23, device)
        save(f"vlm_{shape[0]}x{shape[1]}.pt", run.pop("logits"))
        keep(f"{FAM_VLM_ARCH} 5 layers on {shape}", run)
        del model
        free()
    mesh22, mesh14 = meshes[(2, 2)], meshes[(1, 4)]
    # one VLM period trained with AdamW on (2, 2)
    tr = lmm_trainer(am_cut(FAM_VLM_ARCH), AM_TRAIN_B, device, mesh22, steps=2)
    am_gates(tr.model)
    lmm_check_blocks(tr, "(b) VLM period", "phase 20")
    run = lmm_run(tr, 2, device, profile_step=True, gather=False)
    keep(f"{FAM_VLM_ARCH} 5 layers trained on (2, 2)", run)
    del tr, run
    free()
    # minicpm3-4b at full depth trained on (2, 2), 3 steps; its cut against one card
    cfg = am_cut(FAM_MLA_ARCH, full=True)
    tr = lmm_trainer(cfg, AM_TRAIN_B, device, mesh22, steps=AM_TRAIN_B["steps"])
    run = lmm_run(tr, AM_TRAIN_B["steps"], device, profile_step=True, gather=False)
    check(all(math.isfinite(v) for v in run["loss"] + run["ot"]),
          f"phase 20 (b) {FAM_MLA_ARCH}: a loss or OT distance is not finite: {run['loss']}")
    keep(f"{FAM_MLA_ARCH} 62 layers trained on (2, 2)", run)
    del tr, run
    free()
    for arch in (FAM_MLA_ARCH, FAM_ED_ARCH):      # the MLA cut, whisper at full depth
        cfg, how = am_step_cut(arch)
        tr = lmm_trainer(cfg, AM_TRAIN_B, device, mesh22)
        run = lmm_run(tr, 1, device)
        save(f"train_{arch}.pt", {"params": run.pop("params"), "m": run.pop("m")})
        keep(f"{arch} {how} trained on (2, 2), one step", run)
        del tr, run
        free()
    # whisper-medium at full depth trained on (2, 2), 3 steps
    tr = lmm_trainer(am_cut(FAM_ED_ARCH, full=True), AM_TRAIN_B, device, mesh22,
                     steps=AM_TRAIN_B["steps"])
    run = lmm_run(tr, AM_TRAIN_B["steps"], device, profile_step=True, gather=False)
    keep(f"{FAM_ED_ARCH} 24 + 24 layers trained on (2, 2)", run)
    del tr, run
    free()
    # served on (1, 4): minicpm3-4b through the engine, whisper-medium through the steps,
    # each at full depth, then the float32 twins against one card
    rules14 = P.default_rules(mesh14.axis_names)
    model = build_on_mesh(am_cut(FAM_MLA_ARCH, full=True), device, rules14, mesh14)
    eng, _ = sm_serve(model.cfg, model, AM_ENGINE_B, 24, device, mesh14)
    engine = eng.pop("engine")
    prof = profile_ticks(engine, sm_pairs(model.cfg.vocab_size, AM_ENGINE_B, 24),
                         AM_ENGINE_B["new"], AM_PROFILED, "phase 20 (b)")
    wall, busy, n_dev, krows = prof
    check_served(f"(b) {FAM_MLA_ARCH}", eng.pop("done"), AM_ENGINE_B["requests"],
                 AM_ENGINE_B["new"], phase="phase 20")
    eng["state_b"] = tree_bytes(dict(model.named_parameters())) + cache_bytes(engine.caches)
    eng["profile"] = dict(wall_s=wall, busy_s=busy, launches=n_dev,
                          nccl_s=sum(us for k, us, _ in krows if "nccl" in k.lower()) / 1e6,
                          top=[(k[:60], us / 1e3, c) for k, us, c in krows[:6]])
    keep(f"{FAM_MLA_ARCH} 62 layers served on (1, 4)", eng)
    del model, engine, eng
    free()
    cfg = am_cut(FAM_ED_ARCH, full=True)
    model = build_on_mesh(cfg, device, rules14, mesh14)
    run = am_steps(cfg, model, AM_STEPS_B, 25, device, profiled=AM_PROFILED)
    run.pop("logits")
    keep(f"{FAM_ED_ARCH} 24 + 24 layers served on (1, 4)", run)
    del model
    free()
    cut = am_cut(FAM_MLA_ARCH, "float32")
    model = build_on_mesh(cut, device, rules14, mesh14)
    eng, logits = sm_serve(cut, model, AM_ENGINE_CHECK_B, 26, device, mesh14)
    save("mla_engine.pt", logits)
    out["runs"][f"{FAM_MLA_ARCH} cut served on (1, 4)"] = dict(tokens=eng["tokens"])
    del model, eng
    free()
    cfg32 = am_cut(FAM_ED_ARCH, "float32", full=True)
    model = build_on_mesh(cfg32, device, rules14, mesh14)
    run = am_steps(cfg32, model, AM_CHECK_B, 27, device)
    save("whisper_steps.pt", run.pop("logits"))
    out["runs"][f"{FAM_ED_ARCH} float32 served on (1, 4)"] = dict(tokens=run["tokens"])
    del model
    free()
    if rank == 0:                     # one card: each check against its mesh twin
        one = {}
        cut = am_cut(FAM_VLM_ARCH, "float32")
        model = build_model(cut, device, seed=0)
        am_gates(model)
        run = am_steps(cut, model, AM_CHECK_B, 23, device)
        save("vlm_one.pt", run.pop("logits"))
        one["vlm steps"] = dict(tokens=run["tokens"])
        del model
        free()
        one["vlm grads"] = am_grads(am_cut(FAM_VLM_ARCH), AM_TRAIN_B, device)
        free()
        for arch in (FAM_MLA_ARCH, FAM_ED_ARCH):
            tr = lmm_trainer(am_step_cut(arch)[0], AM_TRAIN_B, device)
            run = lmm_run(tr, 1, device)
            save(f"train_{arch}_one.pt", {"params": run.pop("params"), "m": run.pop("m")})
            one[f"train {arch}"] = run
            del tr
            free()
        model = build_model(am_cut(FAM_MLA_ARCH, "float32"), device, seed=0)
        eng, logits = sm_serve(model.cfg, model, AM_ENGINE_CHECK_B, 26, device)
        save("mla_engine_one.pt", logits)
        one["mla engine"] = dict(tokens=eng["tokens"])
        del model, eng
        free()
        model = build_model(cfg32, device, seed=0)
        run = am_steps(cfg32, model, AM_CHECK_B, 27, device)
        save("whisper_steps_one.pt", run.pop("logits"))
        one["whisper steps"] = dict(tokens=run["tokens"])
        del model
        free()
        out["one card"] = one
        n = count_params(build_model(am_cut(FAM_VLM_ARCH, full=True), device="meta"))
        check(n == AM_VLM_PARAMS, f"{FAM_VLM_ARCH} has {n} parameters, not {AM_VLM_PARAMS}")
    lmm_barrier(device)
    with open(os.path.join(AM_DIR, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    lmm_barrier(device)


def phase_attn_mesh(smi_line: str):
    """Phase 20 (b), ``--attn-mesh-only`` on four cards (NCCL, a card a rank):
    ``llama-3.2-vision-90b`` at full width and depth (bf16, 175.3 GB: no card holds it)
    prefilled (8 x 512 tokens, 1 601 image tokens each) and decoded 32 steps through the
    steps on (1, 4) and (2, 2); one VLM period trained with AdamW on (2, 2);
    ``minicpm3-4b`` (62 layers) and ``whisper-medium`` (24 + 24) trained on (2, 2) with
    the OT term (3 steps of 8 x 512 tokens), MLA served through the engine and whisper
    through the steps on (1, 4); each cut against one card (card 0): the VLM period's
    float32 steps (tokens, prefill logits within SM_LOGIT_TOL) and its loss and gradient
    norm, the MLA cut's and whisper's one step (``lmm_compare``), the MLA cut's engine
    and whisper's float32 steps (tokens, logits).  Per rank: ms a decode step or tick,
    prefill s, tokens/s, state and peak B, launches and NCCL's device time in profiled
    steps, step walls."""
    import socket
    import statistics

    import torch

    t_phase = time.perf_counter()
    os.makedirs(AM_DIR, exist_ok=True)
    for name in os.listdir(AM_DIR):
        os.remove(os.path.join(AM_DIR, name))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    t0 = time.perf_counter()
    try:
        for r in range(4):
            log = open(os.path.join(AM_DIR, f"rank{r}.log"), "w")
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--attn-mesh-rank", str(r),
                 "--mesh-init", f"tcp://127.0.0.1:{port}"],
                stdout=log, stderr=subprocess.STDOUT))
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break                          # one rank failed: stop the others
            if time.perf_counter() - t0 > AM_TIMEOUT_S:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r in range(len(procs)):
        with open(os.path.join(AM_DIR, f"rank{r}.log")) as f:
            for line in f.read().splitlines()[-40:]:
                print(f"  [rank {r}] {line[:1500]}", flush=True)
    rcs = [p.returncode for p in procs]
    check(all(rc == 0 for rc in rcs), f"phase 20 (b): the ranks exited {rcs} after "
                                      f"{time.perf_counter() - t0:.1f} s")
    res = []
    for r in range(4):
        with open(os.path.join(AM_DIR, f"rank{r}.json")) as f:
            res.append(json.load(f))
    load = lambda name: torch.load(os.path.join(AM_DIR, name))
    one = res[0]["one card"]
    runs = lambda label: [x["runs"][label] for x in res]
    for label, r in res[0]["runs"].items():         # every rank the same bits
        for k in ("loss", "ot", "tokens"):
            if k in r:
                check(all(x[k] == r[k] for x in runs(label)),
                      f"phase 20 (b) {label}: the ranks' {k} differ")
    for shape in ((1, 4), (2, 2)):
        label = f"{FAM_VLM_ARCH} 5 layers on {shape}"
        err = am_check_steps(f"(b) {label}", one["vlm steps"], res[0]["runs"][label],
                             load(f"vlm_{shape[0]}x{shape[1]}.pt"), load("vlm_one.pt"))
        print(f"phase 20 (b) {label} (float32 compute): every rank's tokens one card's, "
              f"prefill logits {err:.3e} off", flush=True)
    label = f"{FAM_VLM_ARCH} 5 layers trained on (2, 2)"
    got = res[0]["runs"][label]
    am_compare(f"(b) {label}", one["vlm grads"],
               dict(loss=got["loss"][0], gnorm=got["gnorm"][0]), vlm=True)
    print(f"phase 20 (b) {label}: step-0 loss {got['loss'][0]!r} / {one['vlm grads']['loss']!r} "
          f"one card's, grad norm {got['gnorm'][0]!r} / {one['vlm grads']['gnorm']!r}",
          flush=True)
    for arch in (FAM_MLA_ARCH, FAM_ED_ARCH):
        label = f"{arch} {am_step_cut(arch)[1]} trained on (2, 2), one step"
        got = dict(res[0]["runs"][label], **load(f"train_{arch}.pt"))
        ref = dict(one[f"train {arch}"], **load(f"train_{arch}_one.pt"))
        words = am_compare(f"(b) {label}", ref, got, vlm=False)
        print(f"phase 20 (b) {label}: loss {got['loss'][0]!r} / {ref['loss'][0]!r} one card's, "
              f"grad norm {got['gnorm'][0]!r} / {ref['gnorm'][0]!r}; {words}; one card's "
              f"step {ref['walls'][0]:.3f} s, peak {ref['peak']} B", flush=True)
    got = res[0]["runs"][f"{FAM_MLA_ARCH} cut served on (1, 4)"]["tokens"]
    check(got == one["mla engine"]["tokens"], f"phase 20 (b) {FAM_MLA_ARCH} cut: engine "
                                              f"tokens {got}, one card {one['mla engine']}")
    errs = [float((a - b).abs().max()) for a, b in zip(load("mla_engine.pt"),
                                                       load("mla_engine_one.pt"))]
    check(all(e <= SM_LOGIT_TOL for e in errs),
          f"phase 20 (b) {FAM_MLA_ARCH} cut: engine prefill logits off one card's by {errs}")
    label = f"{FAM_ED_ARCH} float32 served on (1, 4)"
    err = am_check_steps(f"(b) {label}", one["whisper steps"], res[0]["runs"][label],
                         load("whisper_steps.pt"), load("whisper_steps_one.pt"))
    print(f"phase 20 (b) {FAM_MLA_ARCH} cut through the engine on (1, 4) and {label}: every "
          f"request's tokens one card's, prefill logits {max(errs):.3e} / {err:.3e} off",
          flush=True)
    for r, x in enumerate(res):
        for label, g in x["runs"].items():
            if "step_s" in g:              # the steps
                tok = len(g["tokens"]) * len(g["tokens"][0])
                pr = g.get("profile") or {}
                print(f"phase 20 (b) ({res[0]['backend']}, {smi_line}) {label} rank {r}: "
                      f"prefill {g['prefill_s']:.3f} s, decode median "
                      f"{statistics.median(g['step_s']) * 1e3:.2f} ms a step (min "
                      f"{min(g['step_s']) * 1e3:.2f}, max {max(g['step_s']) * 1e3:.2f}), "
                      f"{tok / (g['prefill_s'] + sum(g['step_s'])):.1f} tokens/s, state "
                      f"{g['state_b']} B, peak {g['peak']} B"
                      + (f", drawn in {g['draw_s']:.1f} s" if "draw_s" in g else "")
                      + (f"; profile of {AM_PROFILED} decode steps: wall {pr['wall_s']:.4f} s, "
                         f"busy {pr['busy_s']:.4f} s, {pr['launches'] / AM_PROFILED:.1f} "
                         f"launches a step, NCCL {pr['nccl_s']:.4f} s; largest {pr['top']}"
                         if pr else ""), flush=True)
            elif "walls" in g:             # the trainers
                print(f"phase 20 (b) ({res[0]['backend']}, {smi_line}) {label} rank {r}: loss "
                      f"{g['loss']}, ot {g['ot']}, grad norm {g['gnorm']}, step walls "
                      f"{g['walls']} s, state {g['state_b']} B, peak {g['peak']} B, launches "
                      f"{g['launches']}; split "
                      + "; ".join(", ".join(f"{p} {t:.4f}" for p, t in sp.items())
                                  for sp in g["splits"])
                      + ("" if not g.get("profile") else f"; profile {g['profile']}"),
                      flush=True)
            elif "ticks" in g:             # the engine
                ticks = [t for _, t in g["ticks"]]
                n_tok = sum(len(v) for v in g["tokens"].values())
                pr = g["profile"]
                print(f"phase 20 (b) ({res[0]['backend']}, {smi_line}) {label} rank {r}: "
                      f"{len(g['tokens'])} requests, {n_tok} tokens in {g['wall']:.3f} s "
                      f"({n_tok / g['wall']:.1f} tokens/s); {len(ticks)} ticks, median "
                      f"{statistics.median(ticks) * 1e3:.2f} ms a tick; admission "
                      f"{g['admit']:.3f} s; state {g['state_b']} B, peak {g['peak']} B; "
                      f"profile of {AM_PROFILED} ticks: wall {pr['wall_s']:.4f} s, busy "
                      f"{pr['busy_s']:.4f} s, {pr['launches'] / AM_PROFILED:.1f} launches a "
                      f"tick, NCCL {pr['nccl_s']:.4f} s; largest {pr['top']}", flush=True)
    print(f"phase 20 (b) took {time.perf_counter() - t_phase:.1f} s", flush=True)


# -- phase 17: the hybrid family (Mamba, attention and MoE layers) ---------------------

HY_ARCH = "jamba-1.5-large-398b"
HY_SERVE_CUT = dict(num_layers=4, attn_period=4)   # (a): one period of 4 (PERF.md §4)
HY_SERVE_PARAMS = 23_021_379_584     # the cut's parameter count (the JAX abstract init's)
HY_STATE_B = 3_440_640               # its Mamba state a sequence: 3 x (conv bf16 + scan f32)
HY_KV_TOKEN_B = 4_096                # its attention layer's keys and values a cached token
HY_SERVE = dict(prompts=(2, 37, 64, 64, 128, 129, 257, 300), new=32, max_len=340)    # (a)
HY_STEP_CUT = dict(num_layers=2, attn_period=2)    # (b), (c): one period of 2
HY_STEP_PARAMS = 11_912_896_512
HY_TF = dict(prompt=64, steps=8)     # (b): the teacher-forced check
HY_TF_CAPACITY = 4.0                 # (b): the MoE capacity factor, as reduced(): no drops
HY_CHUNKED = 257                     # (b): one Mamba layer's chunkwise prefill vs decode steps
HY_LM_ROWS = 8                       # (c): the LM part on 8 x 128 of phase 13's step-0 batch
HY_ROW = "@hybrid_step"


def hybrid_cfg(cut, **over):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(HY_ARCH), **cut, **over)


def slot_rows(engine, slot):
    """Each block's cache row of ``slot`` (cloned), the batch axis found through the
    cache's logical axes."""
    def take(cache, axes):
        return {k: take(cache[k], ax) if isinstance(ax, dict)
                else cache[k].narrow(ax.index("batch"), slot, 1).clone()
                for k, ax in axes.items()}

    return [take(c, ax) for c, ax in zip(engine.caches, engine.model.cache_logical_axes())]


def same_tree(a, b) -> bool:
    import torch

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tree(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same_tree(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def phase_hybrid_serve(smi_line, device):
    """(a): one period of 4 layers of ``jamba-1.5-large-398b`` at full width, bf16, through
    ``ServingEngine``: eight requests of 2-300 prompt tokens and 32 new ones through four
    slots; each back once, a second run the same tokens, and each request admitted into a
    recycled slot with a fresh engine's first token and slot cache, bit for bit."""
    import numpy as np
    import torch

    from repro_torch.models import build_model
    from repro_torch.models.common import count_params
    from repro_torch.serving.engine import Request, ServingEngine

    label, spec = "phase 17 (a)", HY_SERVE
    cfg = hybrid_cfg(HY_SERVE_CUT)
    sync()
    t0 = time.perf_counter()
    model = build_model(cfg, device, seed=0)
    sync()
    t_init = time.perf_counter() - t0
    n = count_params(model)
    check(n == HY_SERVE_PARAMS, f"{label}: {n} parameters, not {HY_SERVE_PARAMS}")
    check(next(model.parameters()).dtype == torch.bfloat16, f"{label}: params not bf16")
    sizes = [cache_bytes(model.init_cache(1, T, abstract=True)) for T in (1, 2)]
    check(sizes == [HY_STATE_B + HY_KV_TOKEN_B, HY_STATE_B + 2 * HY_KV_TOKEN_B],
          f"{label}: {sizes} cache B a sequence of 1 and 2 tokens")
    print(f"{label} {HY_ARCH} cut to {cfg.num_layers} of 72 layers, one period (slots: Mamba "
          f"+ MLP, Mamba + MoE, attention + MLP, Mamba + MoE; d_model {cfg.d_model}, "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}, bf16): {n} parameters drawn "
          f"on the card in {t_init:.2f} s, {torch.cuda.memory_allocated()} B allocated; cache "
          f"{HY_STATE_B} B a sequence + {HY_KV_TOKEN_B} B a cached token", flush=True)
    rng = np.random.default_rng(24)
    pairs = [(i, rng.integers(0, cfg.vocab_size, p).astype(np.int32))
             for i, p in enumerate(spec["prompts"])]
    engine = lambda: ServingEngine(cfg, model, max_batch=SERVE_SLOTS, max_len=spec["max_len"],
                                   device=device)
    moes = [moe for block in model.blocks for moe in block.moe]
    first = engine()
    admitted = {}
    prefill_slot = first._prefill_slot

    def recording(slot, req):                 # the slot's cache right after admission
        prefill_slot(slot, req)
        admitted[req.rid] = (req.out_tokens[0], slot_rows(first, slot))

    first._prefill_slot = recording
    for moe in moes:
        moe.routes = []
    run = drive_engine(first, pairs, spec["new"])
    routes = [r for moe in moes for r in moe.routes]
    for moe in moes:
        moe.routes = None
    check_served("(a)", run["done"], len(pairs), spec["new"], phase="phase 17")
    again = drive_engine(engine(), pairs, spec["new"])
    check({r.rid: r.out_tokens for r in run["done"]}
          == {r.rid: r.out_tokens for r in again["done"]},
          f"{label}: a second run gave other tokens")
    recycled = pairs[SERVE_SLOTS:]
    for rid, prompt in recycled:
        fresh = engine()
        req = Request(rid=rid, prompt=prompt, max_new_tokens=spec["new"])
        check(fresh.try_admit(req) and fresh.slots[0] is req, f"{label}: admission failed")
        token, rows = admitted[rid]
        check(req.out_tokens[0] == token,
              f"{label}: request {rid}'s first token in a recycled slot differs from a fresh "
              f"engine's")
        check(same_tree(rows, slot_rows(fresh, 0)),
              f"{label}: request {rid}'s slot cache after admission into a recycled slot "
              f"differs from a fresh engine's")
    prefill = [r for r in routes if r[0].shape[0] > SERVE_SLOTS]
    print(f"{label}: a second run gives the same tokens bit for bit; requests "
          f"{[r for r, _ in recycled]} (recycled slots, prompts {[len(p) for _, p in recycled]}) "
          f"admitted with a fresh engine's first token and slot cache (KV rows, every Mamba "
          f"conv and ssm leaf), bit for bit; dropped fraction "
          f"{dropped_fraction(cfg, routes):.6f} over {len(routes)} routings "
          f"({dropped_fraction(cfg, prefill):.6f} over the {len(prefill)} at prefill; capacity "
          f"factor {cfg.moe.capacity_factor})", flush=True)
    report_serve(f"(a) {HY_ARCH}, one period of 4 layers, bf16 ({n} params, cache "
                 f"{HY_STATE_B} B a sequence + {HY_KV_TOKEN_B} B a token), {SERVE_SLOTS} "
                 f"slots, {len(pairs)} requests of {list(spec['prompts'])} + {spec['new']}", run,
                 profile_ticks(engine(), pairs, spec["new"], 8, "phase 17"), 8, smi_line,
                 phase="phase 17")


def phase_hybrid_f32(device):
    """(b), float32 on one period of 2 layers: prefill and teacher-forced decode against
    ``LM.forward`` (the MoE's capacity factor at 4: no token drops, so the two compare);
    then one Mamba layer at the published widths, a chunkwise prefill of ``HY_CHUNKED``
    tokens (chunks of 128, 128 and 1) against as many decode steps from the zero state:
    outputs and both state leaves within rtol / atol 2e-3."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models import build_model, ssm
    from repro_torch.models.common import ParamInit

    label = "phase 17 (b)"
    cfg = hybrid_cfg(HY_STEP_CUT, param_dtype="float32", compute_dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           capacity_factor=HY_TF_CAPACITY))
    m32 = build_model(cfg, device, seed=0)
    P, steps = HY_TF["prompt"], HY_TF["steps"]
    tf = torch.as_tensor(np.random.default_rng(25).integers(
        0, cfg.vocab_size, (2, P + steps)), device=device)
    with torch.no_grad():
        full, aux = m32.forward(tf)
    check(float(aux[2]) == 0.0, f"{label}: forward dropped {float(aux[2])} of its tokens")
    caches = m32.init_cache(2, P + steps)
    teacher_forced_check(
        f"{label} one period of 2 layers (capacity factor {HY_TF_CAPACITY}: no token "
        f"dropped), prefill / decode vs LM.forward of the whole sequence,", full,
        lambda: m32.prefill(tf[:, :P], caches)[0],
        lambda i: m32.decode_step(tf[:, i:i + 1], caches, torch.full((2,), i, device=device))[0],
        P, steps)
    del m32, caches, full
    fresh_memory()

    layer = ssm.Mamba(ParamInit("float32", device, torch.Generator(device=device).manual_seed(0)),
                      cfg)
    S = HY_CHUNKED
    x = torch.as_tensor(np.random.default_rng(26).standard_normal((1, S, cfg.d_model),
                                                                   dtype=np.float32),
                        device=device)
    chunks = [c for _, c in ssm.chunk_bounds(S, cfg.ssm.chunk)]
    check(len(chunks) == 3 and chunks[-1] == 1, f"{label}: chunks {chunks}")
    with torch.no_grad():
        y, st = layer(x, ssm.mamba_make_state(cfg, 1, torch.float32, device))
        step = ssm.mamba_make_state(cfg, 1, torch.float32, device)
        ys = []
        for i in range(S):
            y_i, step = layer(x[:, i:i + 1], step)
            ys.append(y_i)
        y_s = torch.cat(ys, dim=1)
    pairs = {"outputs": (y, y_s), "conv": (st["conv"], step["conv"]),
             "ssm": (st["ssm"], step["ssm"])}
    errs = {k: float((a - b).abs().max()) for k, (a, b) in pairs.items()}
    check(all(torch.allclose(a, b, rtol=2e-3, atol=2e-3) for a, b in pairs.values()),
          f"{label}: the chunkwise prefill of {S} off {S} decode steps: {errs}")
    print(f"{label} float32, one Mamba layer at the published widths (d_inner "
          f"{ssm.mamba_dims(cfg)[0]}, d_state {cfg.ssm.d_state}): chunkwise prefill of {S} "
          f"tokens (chunks of {chunks}) vs {S} decode steps from the zero state, every "
          f"output and both state leaves within rtol / atol 2e-3; max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)


class OTTerm:
    """The trainer's OT alignment term on a model without the trainer, whose AdamW state
    would not fit: ``Trainer.ot_inputs`` and ``Trainer.ot_loss`` on phase 13's data."""

    def __init__(self, model, grad_impl, device):
        from repro_torch.configs.base import TrainConfig
        from repro_torch.data.pipeline import SyntheticLM, SyntheticLMConfig
        from repro_torch.training.trainer import Trainer

        self.model, self.device, self.cfg = model, device, model.cfg
        self.mesh = self.rules = None           # one card
        self.tcfg = TrainConfig(ot_align=True, ot_align_weight=0.05, ot_solver="lbfgs",
                                ot_grad_impl=grad_impl, remat="block")
        self.data = SyntheticLM(SyntheticLMConfig(vocab_size=model.cfg.vocab_size,
                                                  seq_len=LM_SEQ, global_batch=LM_BATCH,
                                                  num_classes=LM_CLASSES, seed=0))
        self.ot_inputs = Trainer.ot_inputs.__get__(self)
        self.ot_loss = Trainer.ot_loss.__get__(self)
        self.batch = Trainer.batch.__get__(self)


def phase_hybrid_step(smi_line, device):
    """(c), bf16 on one period of 2 layers at full width: ``train_loss`` forward and
    backward (remat per block; no optimizer: AdamW's state does not fit at any cut that
    holds a MoE layer) on 8 x 128 tokens of phase 13's step-0 batch, then the OT alignment
    term on the whole batch (d = 8192) and its backward into ``embed``, pallas and fused;
    K1, K4, K5, K6 and K8 held at its operands and timed.  Returns the kernel rows."""
    import dataclasses
    import math

    import torch

    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels import _build as kbuild
    from repro_torch.models import build_model
    from repro_torch.models.common import count_params
    from repro_torch.ot import diff
    from repro_torch.utils.tree import tree_global_norm

    label = "phase 17 (c)"
    cfg = hybrid_cfg(HY_STEP_CUT)
    model = build_model(cfg, device, seed=0)
    n = count_params(model)
    check(n == HY_STEP_PARAMS, f"{label}: {n} parameters, not {HY_STEP_PARAMS}")
    term = OTTerm(model, "pallas", device)
    batch = term.batch(0)
    lm_batch = {"tokens": batch["tokens"][:HY_LM_ROWS]}
    names = [k for k, _ in model.named_parameters()]
    sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, _ = model.train_loss(lm_batch, z_loss=TrainConfig().z_loss, remat=True)
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
    loss, gnorm = float(loss.detach()), float(tree_global_norm(grads))
    t_lm = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    g_a = float(grads["blocks.0.mamba.0.A_log"].float().abs().max())
    g_q = float(grads["blocks.0.attn.wq"].float().abs().max())
    check(math.isfinite(loss) and math.isfinite(gnorm),
          f"{label}: the loss {loss} or the gradient norm {gnorm} is not finite")
    check(g_a > 0 and g_q > 0, f"{label}: |grad mamba.0.A_log| {g_a}, |grad attn.wq| {g_q}")
    S = lm_batch["tokens"].shape[1] - 1
    print(f"{label} {HY_ARCH} cut to {cfg.num_layers} of 72 layers, one period (Mamba + "
          f"MLP, attention + MoE; {n} params, bf16; {smi_line}): train_loss forward + "
          f"backward (no optimizer, remat per block, the scan's chunks recomputed) on "
          f"{HY_LM_ROWS} x {S} tokens: loss {loss:.4f}, gradient norm {gnorm:.4f}, |grad "
          f"mamba.0.A_log| max {g_a:.3e}, |grad attn.wq| max {g_q:.3e}; {t_lm:.4f} s (host "
          f"clock, ending in a read), {HY_LM_ROWS * S / t_lm:.1f} tokens/s; peak device memory "
          f"{peak} B", flush=True)
    del grads
    fresh_memory()

    def ot_term(grad_impl):
        term.tcfg = dataclasses.replace(term.tcfg, ot_grad_impl=grad_impl)
        kbuild.reset_launch_counts()
        diff.reset_solve_count()
        sync()
        t0 = time.perf_counter()
        ot, metrics = term.ot_loss(batch)
        dist = float(metrics["ot_distance"].detach())
        t_fwd = time.perf_counter() - t0
        t0 = time.perf_counter()
        (g,) = torch.autograd.grad(term.tcfg.ot_align_weight * ot, [model.embed])
        g_max = float(g.float().abs().max())
        t_bwd = time.perf_counter() - t0
        check(math.isfinite(dist) and dist > 0 and math.isfinite(g_max) and g_max > 0,
              f"{label} ({grad_impl}): the OT distance {dist} or |grad embed| {g_max}")
        check(diff.solve_count() == 1, f"{label}: {diff.solve_count()} OT solves")
        return dist, t_fwd, t_bwd, g_max, kbuild.launch_counts()

    ot_term("pallas")                                            # warm
    sync()
    torch.cuda.reset_peak_memory_stats()
    dist, t_fwd, t_bwd, g_max, launches = ot_term("pallas")
    peak = torch.cuda.max_memory_allocated()
    check(launches.get(K1, 0) > 0 and launches.get(K4, 0) > 0
          and launches.get(K5, 0) + launches.get(K6, 0) > 0,
          f"{label}: the OT term did not launch K1, K4 and K5 or K6: {launches}")
    fdist, _, _, _, fused = ot_term("fused")
    check(fused.get(K8, 0) + fused.get(K6, 0) > 0,
          f"{label}: the fused OT term launched no K8 or K6: {fused}")
    print(f"{label} OT alignment term on phase 13's step-0 batch ({LM_BATCH} sequences: L = "
          f"{LM_CLASSES}, g = {LM_BATCH // 2 // LM_CLASSES}, n = {LM_BATCH // 2}, d = "
          f"{cfg.d_model}; {smi_line}): distance {dist:.6f} (fused {fdist:.6f}), solve "
          f"{t_fwd:.4f} s, backward into embed {t_bwd:.4f} s (|grad| max {g_max:.3e}); peak "
          f"device memory {peak} B; launches pallas {launches}, fused {fused}", flush=True)
    path = f"{label} {HY_ARCH}, the OT term of step 0's batch, grad_impl 'pallas'"
    counts = {k: (path, launches.get(k, 0)) for k in (K1, K4, K5, K6)}
    counts[K8] = (f"{label} {HY_ARCH}, the OT term of step 0's batch, grad_impl 'fused'",
                  fused.get(K8, 0))
    term.tcfg = dataclasses.replace(term.tcfg, ot_grad_impl="pallas")
    ops = lm_ot_operands(term, batch, device)
    check(ops[0].d == cfg.d_model, f"{label}: OT at d = {ops[0].d}")
    del model, term
    fresh_memory()
    return phase_lm_kernels(*ops[:5], counts, smi_line, device, phase=label, suffix=HY_ROW)


def phase_hybrid(smi_line, device):
    """Phase 17 (see the module docstring): ``jamba-1.5-large-398b`` at full width on one
    period, served, checked in float32, forward and backward.  Returns the kernel-table
    rows at (c)'s OT shapes."""
    t_phase = time.perf_counter()
    lap = lambda what: print(f"[phase 17 +{time.perf_counter() - t_phase:.1f} s] {what}",
                             flush=True)
    fresh_memory()
    phase_hybrid_serve(smi_line, device)
    fresh_memory()
    lap("(a)")
    phase_hybrid_f32(device)
    fresh_memory()
    lap("(b)")
    rows = phase_hybrid_step(smi_line, device)
    fresh_memory()
    print(f"phase 17 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows


COMPARE_DIR = os.path.join(HERE, "_archive", "compare")     # git-ignored


def main_problem():
    """(reg, problem): the main path's problem at the paper's scale."""
    from repro_torch.core.regularizers import GroupSparseReg
    from repro_torch.data.pipeline import DomainPairConfig, make_domain_pair
    from repro_torch.ot.problem import Problem

    reg = GroupSparseReg.from_rho(0.1, 0.8)
    Xs, ys, Xt, _ = make_domain_pair(DomainPairConfig(num_classes=1280, samples_per_class=10,
                                                      seed=0))
    return reg, Problem.from_samples(Xs, ys, Xt, reg)


def compare_bits(device):
    """K2-K8 (and B9-B14 at d = 2, tile_n = 128) on seeded inputs across g in
    {1, 3, 16, 17, 33}, d in {1, 2, 3, 8, 64} (and the trainer's 576 at g 3 and
    16), tile_n in {4, 20, 128}, f32 and bf16 storage -> {case: tuple of CPU
    tensors}."""
    import numpy as np
    import torch

    from repro_torch.kernels import gradpsi as kg

    from repro_torch.kernels import screen as ks

    out = {}
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(device)
    for g in (1, 3, 16, 17, 33):
        for d in (1, 2, 3, 8, 64) + ((576,) if g in (3, 16) else ()):
            for tile_n in (4, 20, 128):
                rng = np.random.default_rng(1000 * g + 10 * d + tile_n)
                B, L_pad, tile_l = 2, 16, 8
                Nt = -(-300 // tile_n)
                n_pad, m_pad = Nt * tile_n, L_pad * g
                x = (rng.normal(size=(B, m_pad, d)) * 0.3 / np.sqrt(d)).astype(np.float32)
                y = (rng.normal(size=(B, n_pad, d)) * 0.3 / np.sqrt(d)).astype(np.float32)
                f32 = tuple(t(v) for v in (x, (x * x).sum(-1), y, (y * y).sum(-1)))
                a = t(rng.uniform(0.1, 0.6, (B, m_pad)).astype(np.float32))
                b = t(rng.uniform(0.1, 0.6, (B, n_pad)).astype(np.float32))
                flags = t((rng.random((B, L_pad // tile_l, Nt)) < 0.6).astype(np.int32))
                tau = torch.linspace(0.05, 0.5, L_pad, device=device)
                shape = (B, L_pad, n_pad)
                z = rng.uniform(0.0, 0.6, shape).astype(np.float32)
                sargs = (t(z), t(z + rng.uniform(0, 0.3, shape).astype(np.float32)),
                         t(rng.uniform(0, 0.2, shape).astype(np.float32)),
                         t((rng.random(shape) < 0.01).astype(np.int8)),
                         *(t(rng.uniform(0, 0.01, (B, L_pad)).astype(np.float32))
                           for _ in range(3)),
                         t(rng.uniform(-0.01, 0.01, (B, n_pad)).astype(np.float32)),
                         t(np.full((B, L_pad), np.sqrt(g), np.float32)))
                kw = dict(num_groups=L_pad, group_size=g, tau=tau, gamma=0.25, tile_l=tile_l,
                          tile_n=tile_n)
                sched, nact = kg.build_batch_tile_schedule(flags)
                for storage in ("f32", "bf16"):
                    leaves = f32 if storage == "f32" else tuple(v.bfloat16() for v in f32)
                    C = kg.factorized_cost_tile(*f32)
                    C = C if storage == "f32" else C.bfloat16()
                    key = f"g{g} d{d} tn{tile_n} {storage}"
                    out[key + " K2"] = kg.gradpsi_batched(a, b, C, flags, **kw)
                    out[key + " K3"] = kg.gradpsi_compact_batched(a, b, C, sched, nact, **kw)
                    out[key + " K5"] = kg.gradpsi_fact_batched(a, b, *leaves, flags, **kw)
                    out[key + " K6"] = kg.gradpsi_fact_compact_batched(a, b, *leaves, sched,
                                                                       nact, **kw)
                    out[key + " K7"] = kg.gradpsi_fused_batched(a, b, C, *sargs, **kw)
                    out[key + " K8"] = kg.gradpsi_fused_fact_batched(a, b, *leaves, *sargs, **kw)
                    out[key + " K4"] = ks.snapshot_norms_fact_batched(
                        a, b, *leaves, torch.ones(L_pad * g, dtype=torch.int8, device=device),
                        num_groups=L_pad, group_size=g, tile_l=tile_l, tile_n=tile_n)
                    if d == 2 and tile_n == 128:
                        one = lambda *ts: tuple(v[0] for v in ts)
                        f1 = flags[0]
                        s1, n1 = kg.build_tile_schedule(f1)
                        a1, b1, C1, l1, sa1 = a[0], b[0], C[0], one(*leaves), one(*sargs)
                        out[key + " B9"] = kg.gradpsi(a1, b1, C1, f1, **kw)
                        out[key + " B10"] = kg.gradpsi_compact(a1, b1, C1, s1, n1, **kw)
                        out[key + " B11"] = kg.gradpsi_fused(a1, b1, C1, *sa1, **kw)
                        out[key + " B12"] = kg.gradpsi_fact(a1, b1, *l1, f1, **kw)
                        out[key + " B13"] = kg.gradpsi_fact_compact(a1, b1, *l1, s1, n1, **kw)
                        out[key + " B14"] = kg.gradpsi_fused_fact(a1, b1, *l1, *sa1, **kw)
    sync()
    return {k: tuple(v.cpu() for v in vs) for k, vs in out.items()}


def reduce_calls(kr, device, rng, shape):
    """{row_sum, row_dot: call} on seeded f32 rows of ``shape``; a tree without
    row_dot takes its callers' former form, a multiply and row_sum."""
    import numpy as np
    import torch

    t = lambda v: torch.from_numpy(v.astype(np.float32)).to(device)
    x = t(rng.normal(size=shape) * 10.0 ** rng.integers(-3, 3, shape))
    y = t(rng.normal(size=shape))
    dot = getattr(kr, "row_dot", lambda a, b: kr.row_sum(a * b))
    return {ROW_SUM: lambda: kr.row_sum(x), ROW_DOT: lambda: dot(x, y)}


def compare_run(out_path: str, with_bits: bool) -> None:
    """One tree's numbers for --compare (``repro_torch`` is that tree's): the main
    path's prints and its solver call's profile and peak memory; K2/K3/K5-K8
    and K1 and K4 at the main path's last round boundary, and row_sum / row_dot on
    one of its L-BFGS vectors (CUDA events, median of 50, and host enqueue:
    the mean of 100 calls in a row with no synchronize; row_sum / row_dot also
    their device us per call, profiled); K2/K3/K5-K8 with every tile live
    (median of 20), K1 on the same screening inputs; with ``with_bits``,
    compare_bits, K1's and K4's outputs at the final state and the row sums
    over ROW_D."""
    import numpy as np
    import torch

    import repro_torch
    import repro_torch.ot as ot
    from repro_torch.kernels import _build
    from repro_torch.kernels import gradpsi as kg
    from repro_torch.kernels import reduce as kr
    from repro_torch.kernels import screen as ks

    device = torch.device("cuda")
    _build.build()
    res = {"tree": os.path.dirname(os.path.dirname(os.path.dirname(repro_torch.__file__)))}
    reg, problem = main_problem()
    plan = ot.ExecutionPlan(grad_impl="pallas")
    ops = Operands(problem, reg, device)
    # the solver call first, while the card holds only the factorized operands
    peak, per_eval, prof = profile_solver_call(MAIN_PATH, ops, problem, reg, device, plan)
    pick = lambda name: sum(us for k, us, _ in prof["kernels"] if name in k) / 1e3
    res["profile"] = {"peak_bytes": peak, "launches_per_eval": per_eval,
                      "idle_share": 1.0 - prof["busy_s"] / prof["wall_s"],
                      "K1 device ms": pick("screen_kernel"),
                      "K5 device ms": pick("gradpsi_grid_kernel"),
                      "K6 device ms": pick("gradpsi_compact_kernel"),
                      "slot epilogue device ms": pick("slot_reduce_kernel") + pick("slot_sum"),
                      "fill device ms": pick("FillFunctor"),
                      "row reductions device ms": pick("row_sum_kernel")
                      + pick("row_reduce_kernel"),
                      "multiplies device ms": pick("MulFunctor"),
                      "K4 device ms": pick("snapshot_kernel") + pick("snapshot_reg_kernel"),
                      "device launches": per_eval * prof["n_evals"]}
    ex = ot.compile(problem, plan, device=device)
    ex.solve()                                        # warm-up
    sol = ex.solve()
    res["main_path"] = [sol.value, fingerprint(sol.plan),
                        [fingerprint(sol.alpha), fingerprint(sol.beta)]]

    def calls(a, b, flags, sched, nact, sargs, kw):
        C, leaves = ops.pp.Cp, ops.fp.leaves()
        return {K2: lambda: kg.gradpsi_batched(a, b, C, flags, **kw),
                K3: lambda: kg.gradpsi_compact_batched(a, b, C, sched, nact, **kw),
                K5: lambda: kg.gradpsi_fact_batched(a, b, *leaves, flags, **kw),
                K6: lambda: kg.gradpsi_fact_compact_batched(a, b, *leaves, sched, nact, **kw),
                K7: lambda: kg.gradpsi_fused_batched(a, b, C, *sargs, **kw),
                K8: lambda: kg.gradpsi_fused_fact_batched(a, b, *leaves, *sargs, **kw)}

    st = final_state(sol, ops, reg, device)
    del sol, ex                                       # the dense plan
    final = calls(st["alphap"], st["betap"], st["flags"], st["sched"], st["nact"], st["sargs"],
                  st["gkw"])
    k4kw = dict(num_groups=ops.fp.L_pad, group_size=ops.fp.g, tile_l=ops.fp.tile_l,
                tile_n=ops.fp.tile_n)
    final[K4] = lambda: ks.snapshot_norms_fact_batched(st["alphap"], st["betap"],
                                                       *ops.fp.leaves(), ops.mask, **k4kw)
    final[K1] = lambda: ks.screen_batched(*st["sargs"], **st["skw"])
    rows = reduce_calls(kr, device, np.random.default_rng(5), (1, ROW_D_MAIN))
    final.update(rows)
    res["device_us"] = {k: device_us_per_call(f)[0] for k, f in rows.items()}
    res["device_us"][K4] = device_us_per_call(final[K4], 20)[0]
    bits = None
    if with_bits:
        bits = {"K4 final state": tuple(v.cpu() for v in final[K4]()),
                "K1 final state": tuple(v.cpu() for v in final[K1]() if v is not None)}
        rng = np.random.default_rng(6)
        for D in ROW_D:
            for name, f in reduce_calls(kr, device, rng, (3, D)).items():
                bits[f"{name} D{D}"] = (f().cpu(),)
    res["final_share"] = int(st["nact"]) / st["flags"].numel()
    res["final_ms"] = {k: median_ms(f, 50) for k, f in final.items()}
    res["final_host_us"] = {}
    for k, f in final.items():
        sync()
        h0 = time.perf_counter()
        for _ in range(100):
            f()
        res["final_host_us"][k] = (time.perf_counter() - h0) / 100 * 1e6
        sync()
    inp = kernel_inputs(np.random.default_rng(1), ops.pp.Cp, ops.fp.L_pad, float(reg.tau), 1.0,
                        device)
    sargs = screen_args(inp)
    _, flags = ks.screen_batched(*sargs, tau=st["gkw"]["tau"], tile_l=TILE_L, tile_n=TILE_N,
                                 emit_verdict=False)
    sched, nact = kg.build_batch_tile_schedule(flags)
    res["live_share"] = int(nact) / flags.numel()
    live = calls(inp["alpha"], inp["beta"], flags, sched, nact, sargs, st["gkw"])
    live[K1] = lambda: ks.screen_batched(*sargs, tau=st["gkw"]["tau"], tile_l=TILE_L,
                                         tile_n=TILE_N, emit_verdict=False)
    res["live_ms"] = {k: median_ms(f, 20) for k, f in live.items()}
    # device us a call (profiler, a call's launches summed) at the final state and
    # fully live: the fused kernels beside the two-launch pairs they replace, and
    # K2 / K3 / K7 split into the gradient kernel and the slot reduction
    for tag, fns in (("final", final), ("live", live)):
        res[f"{tag}_device_us"], res[f"{tag}_split_us"] = {}, {}
        for k in (K1, K2, K3, K5, K7, K8):
            split = device_split(fns[k])
            res[f"{tag}_device_us"][k] = sum(split.values())
            if k in (K2, K3, K7):
                slot = split.get(SLOT, 0.0)
                res[f"{tag}_split_us"][f"{k} kernel"] = sum(split.values()) - slot
                res[f"{tag}_split_us"][f"{k} {SLOT}"] = slot
    # at the final state with the L2 flushed before each call, as the solver's
    # calls find the cost after K1's pass
    res["final_cold_split_us"] = {}
    for k in (K2, K3, K7):
        kern, slot = kernel_slot_split(final[k], cold=True)
        res["final_cold_split_us"][f"{k} kernel"] = kern
        res["final_cold_split_us"][f"{k} {SLOT}"] = slot
    res["lm_ms"], res["lm_device_us"] = {}, {}
    for k, f in lm_shape_calls(device).items():
        res["lm_ms"][k] = median_ms(f, 50)
        res["lm_device_us"][k] = sum(device_split(f).values())
    if with_bits:
        bits.update(compare_bits(device))
    torch.save({"res": res, "bits": bits}, out_path)
    print(json.dumps(res), flush=True)


def lm_shape_calls(device):
    """{K1, K4-K8 (f32; K4, K5, K8 also bf16): call} at the trainer's OT shape (B = 1,
    L_pad 8, g 4, n_pad 128, d 576, the one tile live), on seeded samples."""
    import numpy as np
    import torch

    from repro_torch.kernels import gradpsi as kg
    from repro_torch.kernels import screen as ks

    rng = np.random.default_rng(21)
    L_pad, g, n_pad, d = 8, 4, 128, 576
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(device)
    x = (rng.normal(size=(1, L_pad * g, d)) / np.sqrt(d)).astype(np.float32)
    y = (rng.normal(size=(1, n_pad, d)) / np.sqrt(d)).astype(np.float32)
    f32 = tuple(t(v) for v in (x, (x * x).sum(-1), y, (y * y).sum(-1)))
    bf16 = tuple(v.bfloat16() for v in f32)
    a = t(rng.uniform(0.0, 0.5, (1, L_pad * g)).astype(np.float32))
    b = t(rng.uniform(0.0, 0.5, (1, n_pad)).astype(np.float32))
    tp = torch.full((L_pad,), 0.3, dtype=torch.float32, device=device)
    kw = dict(num_groups=L_pad, group_size=g, tau=tp, gamma=0.5, tile_l=TILE_L, tile_n=TILE_N)
    skw = dict(num_groups=L_pad, group_size=g, tile_l=TILE_L, tile_n=TILE_N)
    flags = torch.ones((1, 1, 1), dtype=torch.int32, device=device)
    sched, nact = kg.build_batch_tile_schedule(flags)
    mask = torch.ones(L_pad * g, dtype=torch.int8, device=device)
    C = kg.factorized_cost_tile(*f32)
    sargs = screen_args(kernel_inputs(rng, C, L_pad, 0.3, 1.0, device))
    calls = {K1: lambda: ks.screen_batched(*sargs, tau=tp, tile_l=TILE_L, tile_n=TILE_N,
                                           emit_verdict=False),
             K6: lambda: kg.gradpsi_fact_compact_batched(a, b, *f32, sched, nact, **kw),
             K7: lambda: kg.gradpsi_fused_batched(a, b, C, *sargs, **kw)}
    for tag, lv in (("", f32), (" bf16", bf16)):
        calls[K4 + tag] = lambda lv=lv: ks.snapshot_norms_fact_batched(a, b, *lv, mask, **skw)
        calls[K5 + tag] = lambda lv=lv: kg.gradpsi_fact_batched(a, b, *lv, flags, **kw)
        calls[K8 + tag] = lambda lv=lv: kg.gradpsi_fused_fact_batched(a, b, *lv, *sargs, **kw)
    return calls


def compare(other: str, pairs: int) -> None:
    """``pairs`` runs of each tree, one process each, in turns (other, this; this,
    other; ...): bits must agree, times print as medians with their range."""
    import statistics

    import torch

    os.makedirs(COMPARE_DIR, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    order = []
    for k in range(pairs):
        order += [other, HERE] if k % 2 == 0 else [HERE, other]
    runs = {HERE: [], other: []}
    bits = {}
    for i, tree in enumerate(order):
        out, log = (os.path.join(COMPARE_DIR, f"run{i}.{ext}") for ext in ("pt", "log"))
        with open(log, "w") as fh:
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--compare-run",
                                   os.path.join(tree, "src"), "--out", out]
                                  + (["--bits"] if tree not in bits else []),
                                  stdout=fh, stderr=subprocess.STDOUT, timeout=900)
        check(proc.returncode == 0, f"--compare run {i} ({tree}) failed: see {log}")
        got = torch.load(out)
        if got["bits"] is not None:
            bits[tree] = got["bits"]
        runs[tree].append(got["res"])
        print(f"run {i}: {got['res']['tree']}", flush=True)
    a, b = runs[HERE], runs[other]
    prints = {json.dumps(r["main_path"]) for r in a + b}
    check(len(prints) == 1, f"the main path's prints differ between runs: {prints}")
    keys = set(bits[HERE]) | set(bits[other])
    bad = sorted(k for k in keys if k not in bits[HERE] or k not in bits[other] or not same(
        bits[HERE][k], bits[other][k]))
    check(not bad, f"{len(bad)} of {len(keys)} kernel cases differ: {bad[:20]}")
    print(f"bits: {len(keys)} kernel cases (gradient kernels, K4 at the final state, row sums "
          f"and inner products over D in {ROW_D}) and the main path's solve equal in both trees; "
          f"main path {a[0]['main_path']}; final live share {a[0]['final_share']:.4f}",
          flush=True)
    span = lambda v: f"{statistics.median(v):.4f} [{min(v):.4f}, {max(v):.4f}]"
    print(f"{pairs} runs of each tree: median [min, max]; ratio = this / other per pair "
          f"(the k-th run of each)", flush=True)
    for section in ("final_ms", "final_host_us", "device_us", "final_device_us",
                    "final_split_us", "final_cold_split_us", "live_ms", "live_device_us",
                    "live_split_us", "lm_ms", "lm_device_us", "profile"):
        for k in a[0][section]:
            va, vb = [r[section][k] for r in a], [r[section][k] for r in b]
            ratio = [x / y for x, y in zip(va, vb) if y]
            print(f"{section} {k:30s} this {span(va)}  other {span(vb)}  ratio "
                  f"{span(ratio) if ratio else '-'}", flush=True)
    for section, what in (("final_device_us", "at the final state"),
                          ("live_device_us", "fully live")):
        for k in (K2, K3, K7):
            ma = statistics.median(r[section][k] for r in a)
            mb = statistics.median(r[section][k] for r in b)
            print(f"{k} device us a call {what}: median {ma:.2f} vs {mb:.2f} the other tree's "
                  f"({ma / mb:.3f} of it)", flush=True)
    for k in (K2, K3, K7):
        tot = lambda runs: statistics.median(r["final_cold_split_us"][f"{k} kernel"]
                                             + r["final_cold_split_us"][f"{k} {SLOT}"]
                                             for r in runs)
        print(f"{k} device us a call at the final state, L2 flushed before each call: median "
              f"{tot(a):.2f} vs {tot(b):.2f} the other tree's ({tot(a) / tot(b):.3f} of it)",
              flush=True)
    for section, k, what, unit in (("final_ms", K4, "K4 at the final state", "ms"),
                                   ("device_us", K4, "K4's device time a call", "us"),
                                   ("device_us", ROW_DOT, "row_dot's device time a call", "us")):
        va, vb = [r[section][k] for r in a], [r[section][k] for r in b]
        ma, mb = statistics.median(va), statistics.median(vb)
        q = statistics.quantiles(vb, n=4) if len(vb) > 1 else vb * 3
        halves = sum(x < 0.5 * y for x, y in zip(va, vb))
        print(f"{what}: median {ma:.4f} {unit} vs {mb:.4f} {unit}, {ma / mb:.3f} of the other "
              f"tree's ({'under' if ma < 0.5 * mb else 'NOT under'} half); under half in "
              f"{halves} of {len(va)} pairs; the other tree's quartiles {q[0]:.4f}-{q[2]:.4f} "
              f"{unit}", flush=True)


def main() -> None:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive the port on one GPU and check it.")
    ap.add_argument("--compare", metavar="DIR",
                    help="instead: time this tree's gradient kernels against those of the "
                         "checkout at DIR (e.g. the parent commit unpacked by git archive "
                         "into _archive/parent), in turns, and hold their bits equal")
    ap.add_argument("--pairs", type=int, default=10, help="runs of each tree (--compare)")
    ap.add_argument("--compare-run", metavar="SRC", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    ap.add_argument("--bits", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-init", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-only", action="store_true",
                    help="instead: build, then run phase 12 alone from the results an earlier "
                         "full run of this tree left in _archive/phase12 (for several cards: "
                         "NCCL with a card a rank)")
    ap.add_argument("--lm-only", action="store_true",
                    help="instead: build, then run phase 13 (the LM trainer) alone")
    ap.add_argument("--families-only", action="store_true",
                    help="instead: build, then run phase 15 (MLA, the encoder-decoder and "
                         "the VLM at full width) alone")
    ap.add_argument("--xlstm-only", action="store_true",
                    help="instead: build, then run phase 16 (xlstm-1.3b at full width: "
                         "served, checked in float32 and trained) alone")
    ap.add_argument("--hybrid-only", action="store_true",
                    help="instead: build, then run phase 17 (jamba-1.5-large-398b at full "
                         "width: one period of 4 layers served, one of 2 checked in float32 "
                         "and run forward and backward) alone")
    ap.add_argument("--lm-mesh-only", action="store_true",
                    help="instead: build, then run phase 18 (b) alone: the LM mesh on four "
                         "cards (NCCL, (2, 2)), yi-9b at full width and depth")
    ap.add_argument("--lm-mesh-part", choices=("a", "b"),
                    help="with --lm-mesh-only: the part of phase 18 (default b; a: two "
                         "gloo ranks on one card, as the full run)")
    ap.add_argument("--lm-mesh-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--serve-mesh-only", action="store_true",
                    help="instead: build, then run phase 19 (b) alone: serving on the LM "
                         "mesh on four cards (NCCL, (1, 4) and (2, 2)), phi3.5-moe-42b-a6.6b "
                         "at full width and depth")
    ap.add_argument("--serve-mesh-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--attn-mesh-only", action="store_true",
                    help="instead: build, then run phase 20 (b) alone: the attention families "
                         "on the LM mesh on four cards (NCCL, (1, 4) and (2, 2)), "
                         "llama-3.2-vision-90b served at full width and depth")
    ap.add_argument("--attn-mesh-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--serve-only", action="store_true",
                    help="instead: build, then run phase 14 (LM serving, the MoE family and "
                         "the OT router) alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    src = os.path.abspath(args.compare_run) if args.compare_run else SRC
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"{src}/repro_torch not found: run from a checkout of the repository")
    sys.path.insert(0, src)
    if args.mesh_rank is not None:
        mesh_rank(args.mesh_rank, args.mesh_init)
        return
    if args.lm_mesh_rank is not None:
        lm_mesh_rank(args.lm_mesh_rank, args.mesh_init, args.lm_mesh_part)
        return
    if args.serve_mesh_rank is not None:
        serve_mesh_rank(args.serve_mesh_rank, args.mesh_init)
        return
    if args.attn_mesh_rank is not None:
        attn_mesh_rank(args.attn_mesh_rank, args.mesh_init)
        return
    if args.compare_run:
        compare_run(args.out, args.bits)
        return
    if args.compare:
        compare(os.path.abspath(args.compare), args.pairs)
        return
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    if args.serve_mesh_only:                # no kernel on its path: nothing to build
        check(torch.cuda.device_count() >= 4,
              f"--serve-mesh-only needs four cards, found {torch.cuda.device_count()}")
        phase_serve_mesh(smi_line)
        print(f"{smi_line}; phase 19 (b) alone took {time.perf_counter() - t_start:.1f} s",
              flush=True)
        return

    # 2. build
    from repro_torch.kernels import _build

    path, secs, log = _build.build(verbose=True)
    print(f"build: {path.name} in {secs:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("==") \
                or "Compiling entry" in line:
            print(f"  {line.strip()}", flush=True)
    if args.mesh_only:
        check(os.path.exists(os.path.join(MESH_DIR, "dense_duals.pt")),
              f"--mesh-only needs an earlier full run's results in {MESH_DIR}")
        phase_mesh(smi_line)
        print(f"{smi_line}; phase 12 alone took {time.perf_counter() - t_start:.1f} s",
              flush=True)
        return
    if args.lm_only:
        print(json.dumps({"kernels": phase_lm(smi_line, device)}), flush=True)
        print(f"{smi_line}; phase 13 alone took {time.perf_counter() - t_start:.1f} s",
              flush=True)
        return
    if args.families_only:
        print(json.dumps({"kernels": phase_families(smi_line, device)}), flush=True)
        print(f"{smi_line}; phase 15 alone took {time.perf_counter() - t_start:.1f} s",
              flush=True)
        return
    if args.xlstm_only:
        print(json.dumps({"kernels": phase_xlstm(smi_line, device)}), flush=True)
        print(f"{smi_line}; phase 16 alone took {time.perf_counter() - t_start:.1f} s",
              flush=True)
        return
    if args.hybrid_only:
        print(json.dumps({"kernels": phase_hybrid(smi_line, device)}), flush=True)
        print(f"{smi_line}; phase 17 alone took {time.perf_counter() - t_start:.1f} s",
              flush=True)
        return
    if args.lm_mesh_only:
        part = args.lm_mesh_part or "b"
        check(part == "a" or torch.cuda.device_count() >= 4,
              f"--lm-mesh-only needs four cards, found {torch.cuda.device_count()}")
        rows = phase_lm_mesh(smi_line, part)
        print(json.dumps({"kernels": rows[0] if part == "a" else rows}), flush=True)
        print(f"{smi_line}; phase 18 ({part}) alone took {time.perf_counter() - t_start:.1f} s",
              flush=True)
        return
    if args.attn_mesh_only:
        check(torch.cuda.device_count() >= 4,
              f"--attn-mesh-only needs four cards, found {torch.cuda.device_count()}")
        phase_attn_mesh(smi_line)
        print(f"{smi_line}; phase 20 (b) alone took {time.perf_counter() - t_start:.1f} s",
              flush=True)
        return
    if args.serve_only:
        print(json.dumps({"ot_router_launches": phase_serve(smi_line, device)}), flush=True)
        print(f"{smi_line}; phase 14 alone took {time.perf_counter() - t_start:.1f} s",
              flush=True)
        return

    reg, problem = main_problem()
    t0 = time.perf_counter()
    mat_problem = problem.materialized(device=device)
    t_mat = time.perf_counter() - t0
    ops = Operands(problem, reg, device)
    print(f"data: m={problem.num_source}, n={problem.num_target}, L={ops.spec.num_groups}, "
          f"g_pad={ops.spec.group_size}, d={ops.fp.d}, factorized "
          f"operands {sum(t.numel() for t in ops.fp.leaves()) * 4} B on the card; "
          f"problem.materialized() in {t_mat:.3f} s", flush=True)

    def lap(what):
        print(f"[{time.perf_counter() - t_start:.1f} s] {what}", flush=True)

    # 3. kernels vs plain versions
    lap("phase 3")
    phase_kernels(ops, reg, device)
    phase_fused_stress(ops, reg, device)
    phase_kernels_wide_d(device)
    reduce_rows = phase_row_sum(device)
    phase_tile_widths(device)
    ops.drop_dense()
    # 4. the solver calls alone (memory, profile), then every path end to end
    lap("phase 4")
    main_profile = phase_memory_and_profile(ops, problem, reg, device)
    sols, launches = phase_end_to_end(problem, mat_problem, device)
    del mat_problem
    # 5. checks and times at the main path's final state
    lap("phase 5")
    rows, st = phase_times(sols[MAIN_PATH], ops, reg, launches, device)
    for row in reduce_rows:
        row["launches"] = launches[row["launches_path"]].get(row["name"], 0)
        check(row["launches"] > 0, f"{row['name']} was not launched on {row['launches_path']}")
    phase_round_boundary(st, ops)
    fully = phase_density_times(ops, reg, device)
    for row in rows:                       # beside the final state, every tile live
        if row["name"] in fully:
            ms, bms, by, share = fully[row["name"]]
            row.update(live_ms=ms, live_bound_ms=bms, live_bound_by=by, live_share=share)
    # 7. the solo oracle layer at the same state
    lap("phase 7")
    solo_rows = phase_solo(sols[MAIN_PATH], st, ops, problem, reg, device)
    lbfgs_value = sols[MAIN_PATH].value
    handoff = {"dense": {impl: sols[f"dense/{impl}"].value for impl in ("grid", "compact")}}
    dense_duals = {impl: (sols[f"dense/{impl}"].alpha.cpu(), sols[f"dense/{impl}"].beta.cpu())
                   for impl in ("grid", "compact")}
    del ops, st, sols
    # 6. solo vs batched solves
    lap("phase 6")
    phase_solo_vs_batched(device)
    # 8. the differentiable layer and training; 9. the stochastic solver
    lap("phase 8")
    refine_launches = phase_train(problem, reg, device)
    lap("phase 9")
    phase_stochastic(problem, reg, lbfgs_value, device)
    # 10. solve_many and stream at full width; 11. the serving engine
    lap("phase 10")
    handoff["batch"] = phase_batch(reg, main_profile, device)
    lap("phase 11")
    handoff["engine"] = phase_engine(reg, device)
    # 12. the same work spread over two ranks
    lap("phase 12")
    write_handoff(handoff, dense_duals)
    phase_mesh(smi_line)
    # 13. the LM trainer with the OT alignment loss
    lap("phase 13")
    lm_rows = phase_lm(smi_line, device)
    # 14. LM serving, the MoE family and the OT router
    lap("phase 14")
    router_launches = phase_serve(smi_line, device)
    for row in reduce_rows:                 # the OT router's L-BFGS runs them
        row["launches_ot_router"] = router_launches.get(row["name"], 0)
    # 15. the attention families: MLA, the encoder-decoder, the VLM
    lap("phase 15")
    fam_rows = phase_families(smi_line, device)
    # 16. the xLSTM family: recurrent-state serving, float32 checks, training
    lap("phase 16")
    xl_rows = phase_xlstm(smi_line, device)
    # 17. the hybrid family: Mamba, attention and MoE layers, the mixed cache
    lap("phase 17")
    hy_rows = phase_hybrid(smi_line, device)
    # 18. the LM mesh: two gloo ranks on this card, FSDP x TP against one card
    lap("phase 18")
    lmm_rows, sm_launches = phase_lm_mesh(smi_line, "a")
    for row in reduce_rows:                 # phase 19 (a)'s OT router on (2, 1)
        row["launches_serve_mesh_path"], row["launches_serve_mesh"] = sm_launches[row["name"]]
    for row in solo_rows:
        if row["name"] == B12:          # the layer's grad_refine path runs it
            row["launches"] = refine_launches[B12]
            row["launches_path"] = "layer from_samples, grad_refine=20"
    rows += solo_rows + reduce_rows + lm_rows + fam_rows + xl_rows + hy_rows + lmm_rows

    print(f"{smi_line}; smoke took {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
