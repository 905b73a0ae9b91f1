#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port's main paths on the card — serving a DSEKL model
through ``repro_torch.launch.serve.serve_dsekl``, training one through
``repro_torch.launch.train.train_dsekl`` then serving it, training with
Algorithm 2 at the paper's parallel covertype protocol in memory and out
of core from a memmap, block coordinate descent rounds in memory and out
of core, the paper's baselines (EmpFix, RKS, the batch SVM) and kernel
PCA, the online train-to-serve loop and the multi-tenant front door
(``serve_online``, ``serve_tenants``), serving the jamba-v0.1-52b
language model at full width through
``repro_torch.launch.serve.serve_lm``, training mamba2-780m at full
width and depth through ``repro_torch.launch.train.train_lm``, the
DSEKL readout over its frozen features, the DSEKL mesh and serving on
the mesh (four ``torch.distributed`` ranks sharing the card: the engine's
support set sharded, jamba-v0.1-52b tensor- and expert-parallel) — with
every kernel built from this checkout's sources and held against its
plain PyTorch version.  Phases (any failure exits non-zero and prints no
result):

  1. device  — name, compute capability, ``nvidia-smi`` name and power
               limit; requires sm_90.
  2. build   — nvcc builds every kernel source (build seconds, ptxas);
               the three tensor-core libraries' ptxas registers, shared
               memory, spills and warnings, and their SASS counts by
               cuobjdump: HGMMA (wgmma) and, for flash and the SSD scan,
               UTMALDG (TMA) must be > 0; the sm90 matvec must spill
               nothing; the sm90 train kernel's wide instantiations
               must spill nothing (the narrow ones' ptxas lines are
               printed), no C75xx note may appear, and the wide
               variant's dynamic shared memory is printed.
  3. parity  — each DSEKL kernel vs its plain version on the card, 7
               kernels x D in {3, 54, 784} at ragged I=1000, J=5003:
               matvec, vecmat, the dual pass, the train pass for the 4
               losses at f_scale 1 and N/|J|, and ops.kernel_dual_pass's
               matvec-then-vecmat fallback under a forced small stash
               budget; each launch counter must go up by one per call,
               and the matvec and vecmat on their route
               (``block.select_matvec_route``: sm90 for the six
               cross-term kinds at D <= 64, fp32 for the rest).  The
               dual and train passes on both train routes
               (``block.select_train_route``: J = 5003 on the fp32 one,
               the ragged J = 1000 on the sm90 one with K in registers,
               J = 4096 and the ragged 3000 on its wide variant with K in
               shared memory), and the indexed train pass (rows read by
               index from the 5003, duplicates among them, lam 1e-4; J =
               1000, 4096 and 3000) against its plain version and, bit
               for bit, against the same kernel on the rows gathered
               beforehand.
  4. lm-parity — flash attention (causal and not, window 64 and 0, GQA
               32/8 and 4/1, D 64 and 128, ragged S, S != T, and lengths at
               the 128-row tiles' edges: 127, 128, 129, 255, 257) in
               float32 through the fp32 route and in bfloat16 through the
               sm90 route (and bf16 at D 48 through the fp32 route), twice
               each with the same bits, and the SSD scan (n 16 and 128, hd
               64, chunk 256 and 128, ragged S) in float32 through the fp32
               route and in bfloat16 through the sm90 route (lengths at the
               chunk's edges, g 2, a fast decay; twice each with the same
               bits) vs their plain versions; counters +1 per call, on the
               expected route.
  5. serve   — the DSEKL serving path at the covertype scale: 559,890 x
               54 training rows, RBF, ~50% support, 16,384 queries in
               requests of 64, query_block 1024, through flush_async and
               flush; answers checked against the plain path; the
               kernel's launches must equal the serve calls, all on the
               sm90 route.
  6. train   — the training path at full width: ``train_dsekl`` on the
               covertype protocol (559,890 x 54 training rows after the
               2,048-row hold-out, |I| = |J| = 1024, hinge, adagrad, 2
               epochs = 1,092 steps); the indexed train pass's launches
               must equal the steps, all on the sm90 route (no launch of
               the contiguous train pass), two more steps under a
               TorchFunctionMode must index none of x, y and alpha in
               Python, alpha be finite and the last validation error beat
               the all-zero model's; then the trained model is served
               through ``engine_from_fit`` and its error must equal the
               fit's, up to labels whose |f| is within tolerance of 0.
  7. train-cuda-vs-ref — 16 Alg.-1 steps on one shared plan at the main
               shape (square loss) with impl "cuda" and "ref": alpha and
               accum must agree.
  8. train-two-pass — a fit with fuse_dual_pass=False (N = 65,536, one
               epoch of 64 steps): vecmat launches must equal the steps,
               on the sm90 route (and the validation evals of phase 6).
  9. profile — torch.profiler over 32 steps of the training path: device
               time by kernel, device kernels launched a step and the
               device's busy share.
 10. train-parallel — Algorithm 2 at the Fig. 3a protocol through
               ``train_dsekl`` (559,890 x 54 rows in memory, |I| = |J| =
               1024, 4 workers, RBF, hinge, adagrad, 1 epoch = 546 steps):
               one train-pass launch a step over the 4,096-column J union,
               all on the sm90 route (its wide variant, rows read by
               index), none on the fp32 route, no matvec / vecmat
               fallback; the eval's one matvec; the val error beats the
               all-zero model; ms a step; then torch.profiler over 32 of
               its steps: device busy, device kernels a step.
 11. train-hosted — the same out of core: ``--data mmap`` writes the
               561,938 x 54 float32 dataset (116 MiB), 2 epochs through
               the prefetcher, then 1 with ``--no-prefetch``: train-pass
               launches equal the steps, all sm90 (the wide variant on the
               staged blocks), none fp32; the streamed eval's
               matvec launches equal its 4,096-row chunks (137), all sm90;
               the peak device memory over the fit stays below half the
               dataset; ms a step, gather_s, wait_s and the hidden share
               1 - wait_s / gather_s; the val error beats the all-zero
               model.
 12. hosted-vs-memory — one 65,536-row memmap on the same plans, hosted
               and on the device: Algorithm 2 bit-identical, Algorithm 1
               within the float32 tolerance; prefetched blocks behind a
               spin on the consumer's stream equal SyncGather's.
 13. times   — each DSEKL kernel at its main path's shape (and the RBF
               delegation of row 5): its device time per call
               (``device_ms``: CUDA events around 25 calls enqueued
               behind a spin kernel, two readings), its bound (the matvec
               and vecmat on the sm90 route: products at the TF32 tensor
               peak, the rest at fp32), the plain version's and the fp32
               cross-term GEMM yardstick's device time, and one call of
               kernel and plain by CUDA events (the host's enqueue
               included), in ms; for row 1 also the TF32 cross-term GEMM
               (a second yardstick, not the same function) and the fp32
               route at the same shape, on a line of its own; rows 3 and 4
               on the sm90 train route (row 4 as the step calls it: rows
               by index, lam), the contiguous sm90 train pass, and both on
               the fp32 route at the same shape, each on a line of its
               own; row 4 at the Alg.-2 step's shape (I = 1024, J =
               4,096): the sm90 route's wide variant as the step calls it,
               with its launches on the Alg.-2 paths
               (``launches_by_path``) and the clusters the card holds at
               once, and the fp32 route, each a row of its own; the step's
               call with the fp32 route forced on a line; row 2 at the
               EigenPro correction's shape (I 1,024, J = m 512) as a row of
               its own (kernel_vecmat_precond: launches 0, they are counted
               in row 2's kernel_vecmat by path), its error taken on the
               rows scaled to unit norm, where K is far from I.
               Every route of every kernel is a row of the kernels line
               (``kernel_route``).
 14. serve-jamba — the LM main path: jamba-v0.1-52b at full width cut to
               one period of 8 layers (7 mamba + 1 attention, 4 MoE FFNs),
               bf16, random weights from a seed, 4 random prompts of 2,048
               tokens, 32 greedy tokens each (cache 2,080); the flash and
               SSD counters must read 1 and 7 per prefill (none in
               decode), every flash and SSD launch on the sm90 route;
               prefill and
               decode times on the host clock; the
               timed prefill's flash and SSD launches, their inputs and
               outputs kept at the model's call sites, are each held
               against the plain version on those activations; then the
               same model's prefill logits with impl "ref" must match
               within 2e-2 x max|ref|, and the greedy-token agreement is
               printed; then torch.profiler over one prefill and 8
               decode steps: device time by kernel (the SSD scan and the
               MoE dispatch's scan among them).
 15. train-precond — EigenPro on the training paths: ``train_dsekl``
               with ``--precondition-k 64`` (m auto = 512) on the covertype
               protocol of phase 6 (2 epochs, 1,092 steps) and of phase
               10 (Algorithm 2, 4 workers, 1 epoch, 546 steps): every step
               one indexed train-pass launch and one vecmat launch (the
               correction's K(X_I, X_P)^T v, I 1,024 x m 512), all on the
               sm90 routes, the evals' matvecs and nothing else; alpha
               finite and unlike the plain fit's of the same run; the
               estimate's seconds, ms a step beside the plain step's, the
               val error beside the plain fit's and the all-zero model's;
               two more preconditioned steps under the gather watch may
               index x and y once each a step and alpha never; the profile
               of 32 preconditioned steps.
 16. precond-parity — on the card, the CUDA path against the ref path on
               the same inputs at the float32 tolerance with atol x
               |ref|_inf (no floor at 1), on the main path's rows scaled
               to unit norm (at gamma 1 the raw rows give K ~ I and a
               correction near zero): the correction at I 1,024 and 1,000
               against m 512 and 500 (each one vecmat launch on the sm90
               route), one preconditioned Algorithm-1 step and one
               Algorithm-2 step (one indexed train pass and one vecmat
               each, on sm90), each step also on the correction's own
               share of alpha (the step less the plain step).  Each held
               value set's median |ref| must lie above 100x the atol.
 17. precond-hosted — the estimate from phase 11's memmap and from the
               same rows on the card, bit for bit; one preconditioned
               hosted Algorithm-2 epoch (prefetched) against the in-memory
               epoch on the same plan, bit for bit.
 18. precond-converge — the JAX ``precond`` cell's protocol without JAX:
               n 4,096, d 54, RBF gamma 0.05, labels sign(K alpha*) with
               alpha* on eigenmodes 16..200 of K (an f64 eigh of the
               4,096^2 matrix on the card), square loss, const schedule at
               pre.baseline_step_size(256) in both arms, lam 1e-4,
               unbiased scaling, |I| = |J| = 256, k 64, m 512, up to 200
               epochs with an eval every 5: epochs to a 0.35 validation
               error for each arm, beside the JAX cell's committed
               reading.  Gates: at the cell's fit seed 3 the preconditioned
               arm reaches the target in strictly fewer epochs; scale > 1;
               one vecmat a preconditioned step on sm90; finite values.
 19. bcd-cell — block coordinate descent (core/bcd.py) on the JAX ``bcd``
               cell's problem without JAX: CONVERGE's data (shared with
               precond-converge), lam 1e-4, |J| = row tile = 256, square
               loss, 40 rounds with an eval each: rounds to 0.35, the best
               val error, kernel-tile evaluations to target, the dense
               (K + lam n I)^-1 y val error (float64 on the card) and BCD's
               gap to it, beside the JAX cell's committed reading.  Gates:
               0.35 reached; one sm90 matvec an eval and no other launch
               (the rounds' GEMMs and Cholesky are cuBLAS / cuSOLVER);
               impl "cuda" and "ref" bit-identical alpha, prefetch and sync
               too, a fit stopped after round 2 and resumed equal to the
               uninterrupted one bit for bit; bcd_shards=2 runs.
 20. bcd-exact — one full-block round (|J| = n = 1,024, gamma 0.2, no
               jitter) against the dense float64 solve, at atol 32 cond(A)
               u |alpha|_inf with cond(A) measured in float64 (u = 2^-24),
               its median |alpha| above 100x that atol.
 21. bcd-hosted — BCD at full width out of core: train-hosted's 559,890 x
               54 memmap, |J| = row tile = 1,024, 3 rounds prefetched, an
               eval each (137 sm90 matvecs): seconds a round, host syncs
               (torch's sync debug mode, counted), peak device memory
               (below half the dataset), val error beside the all-zero
               model's, the round's fp32 work and its bound; one more
               round on a BCDPlan under the profiler (device kernels and
               host syncs a round) whose residual f_J must equal K(x_J,
               x_J) alpha_J by the matvec.  Removes the memmap.
 22. baselines — on 65,536 covertype-like rows in memory scaled to unit
               norm (RBF gamma 1, D 54): 16 EmpFix steps of I 1,024
               against 1,024 landmarks (square) with impl "cuda" (one sm90
               matvec and one sm90 vecmat a step, one matvec for the
               decision) and "ref" on the same landmarks and plans; 16 RKS
               steps at 1,024 features and a batch SVM at n 2,048 for 50
               iterations, each against the same run on the host's CPU.
               Each hold at the float32 tolerance with atol x |ref|_inf,
               its median |ref| above 100x the atol.
 23. kpca   — kernel PCA on 65,536 such rows: 8 steps of r 4, J 256 with
               impl "cuda" and "ref" on the same v0 and plans, then
               ``transform`` of 4,096 rows (16 chunks): r sm90 matvecs a
               step and a chunk; the subspaces' principal-angle cosines >=
               1 - 1e-4, the transform cuda vs ref at the float32
               tolerance.  Then (shape-times) the sm90 matvec and vecmat at
               each of these paths' shapes, and the matvec at the online
               flush's (1,024 queries against the first window's 262,144
               rows and the full ring's 524,288): device ms and bound.
 24. lm-times — flash attention and the SSD scan (both on the sm90 route)
               at their served shapes: device time, one call by events, the
               plain version's device time, the bound (products at the bf16
               tensor-core peak, the rest at fp32), and for flash SDPA's
               device time on the same bf16 values in the same call (a
               yardstick the port never calls); then each kernel's fp32
               route at the same shape in float32 against its plain
               version, on a line of its own.

 25. online  — the online train-to-serve loop through
               ``repro_torch.launch.serve.serve_online`` (``--online``): D
               54, a ring of 524,288 events prefilled with 262,144 of the
               launcher's event stream (seed 0), 32,768 ingested an epoch
               for 10 epochs (the ring wraps), |I| = |J| = 1,024, RBF gamma
               1, hinge, a rebuild at a drift of 0.1, query block 1,024, sv
               block 4,096; three client threads submit 64-row requests and
               flush while the fit thread (HostedPlan, Algorithm 1, on a
               CUDA stream of its own) trains.  Gates: no fit-thread error,
               every ticket answered once, >= 2 versions served, >= 1
               rebuild, the ring wrapped; every train-pass launch on the
               sm90 route (one a step, on the staged rows) and every matvec
               launch on it, nothing else launched; a sample of responses
               (and every version's first) bit-identical to a fresh engine
               on its version's recorded (alpha, snapshot); the last
               model's error on 4,096 rows of its own snapshot below the
               all-zero model's.  Prints flush p50 / p99 while training and
               for the first 1,500 requests of each client replayed after
               stop() (and the first client's alone), the fit thread's ms
               a step, staleness, publishes, rebuilds and the peak device
               memory against two engines and the plan; the interpreter's
               garbage-collection pauses in each; and a torch.profiler device trace of the fit thread's
               epoch 3 (no rebuild in it): each stream's kernels and busy
               time, the device time a flush beside that epoch's flush
               walls.
 26. tenants — the front door through ``serve_tenants`` (``--tenants
               gold:2,standard:1,batch:1:4:0 --cache-blocks 8``) on
               covertype-serve's engine, QoS on then off on identical
               traffic: the launcher's rounds; then, on the same front
               door, the reference harness's noisy-neighbor trace
               (benchmarks/load_harness.py ``measure_multi_tenant``) on a
               clock of one pump a round: the victims gold (flat) and
               standard (diurnal) arrive at a rate of 0.25 a round at
               peak, each cycling a pool of 3 full-tile batches (the
               cacheable working set); the aggressor batch sends bursts of
               8 unique full-tile batches every 24 rounds, over its budget
               of 4 tickets; garbage collection held off for the trace, as
               the harness does.  Then a backlog: gold and standard each
               queue 48 pool batches at once.  Gates: every response
               bit-identical to the bare engine on the same rows and
               version (the cached path, or the streaming one for batch's
               quota 0 with QoS on), every ticket answered once, gold's
               rows within 10% of twice standard's while both are
               backlogged (QoS on), sheds only with QoS on and only of
               batch, cache hits for gold and standard and no resident
               tile of batch (QoS on), every matvec launch on the sm90
               route.  Prints the victims' p99 on and off (the headline),
               each tenant's p50 / p99, sheds and cache counters.
 27. lm-train — LM training through ``repro_torch.launch.train.train_lm``
               on mamba2-780m at full width (d_model 1,536, vocab 50,280;
               cut to 12 of its 48 layers since mesh-lm trains the full
               depth: the whole run's time), bf16 parameters, f32 AdamW moments,
               cosine at lr 1e-3, loss_chunks 4, remat per layer): batch
               8 x 1,024 tokens, 12 steps, a checkpoint at step 6 (under
               build/); then step 6 restored into freshly built state
               (another init seed) and run to step 12.  First step 0's
               loss and grad norm in bf16 are held against the same
               weights and batch in float32 (rtol 1e-2 and 5e-2).  Gates:
               every loss and grad norm
               finite, the mean of the last three losses below the first,
               the resumed losses, grad norms and parameters equal to the
               uninterrupted run's bit for bit, no flash, SSD or DSEKL
               launch while training (no kernel has a backward).  Prints
               ms a step over steps 2-12 and tokens/s, model FLOPs (6 x
               parameters x tokens) against the bf16 dense peak with the
               remat recompute apart, peak device memory, and device busy
               and the largest kernels over two profiled steps.
 28. lm-readout — the trained model frozen: ``extract_features`` of
               4,096 sequences of 512 tokens from a 24-token alphabet, in
               batches of 32 (an SSD launch a layer a batch, all sm90, at n 128;
               the last batch's held against the plain version on their
               activations), then ``KernelReadout.fit`` by Algorithm 2 (4
               workers, |I| = |J| = 512: every step one launch of the
               sm90 train kernel's wide variant at a J union of 2,048) on
               2,048 rows, at most 60 epochs, gamma 3.2 / D, and the
               decisions on the other 2,048 rows and the train rows (the
               matvec's fp32 route at D 1,536, counted by route).  Gates:
               held-out error <= 0.35 and train error <= 0.05
               (tests/test_readout.py's), the card's decision equal to
               ``decision_function_ref`` at the DSEKL tolerance.  Times
               the SSD at B*nh 1,536, S 512, n 128 and the fp32 matvec at
               the decision's shape with their bounds (the kernels line's
               ``ms_bound_by_shape`` of rows ssd and kernel_matvec_fp32).

 29. mesh    — the DSEKL mesh (``core/distributed.py``), run after
               bcd-exact: ranks under ``python -m torch.distributed.run
               --standalone`` (this script with ``--mesh-rank``, killed
               whole at a time limit; any rank's non-zero exit fails),
               four gloo ranks sharing the one card (so a step's time is
               no multi-card figure), the kernels built by phase 2 before
               any rank starts (a rank that ran nvcc fails).  (a) parity
               on a (2, 2) world: 8 steps at D 54, |I| = |J| = 1,024 a
               shard on unit-norm covertype-like rows, square, adagrad,
               impl "cuda", one shared plan, against the port's
               simulate_step with impl "ref" on rank 0; again with
               compress_bits=8 (one const-rate step within
               compression_error_bound of the exact one, times the most
               copies of an index in J) and with EigenPro (k 64, const at
               its step size); every step on every rank one sm90 matvec
               and one sm90 vecmat (EigenPro two), no train pass, the
               ranks' counts summed by all_reduce.  (d) bcd-cell's
               problem, 8 rounds on (2, 2) against the serial BCDPlan
               at bcd_shards=2 on the card at 32 cond(A) u |ref|_inf.
               (b) the launcher, ``--execution mesh --data-par 2
               --model-par 2 --dist-backend gloo --data mmap``, 561,936 x
               54 (559,888 train rows, divisible by 4), hinge, adagrad,
               1,024 a shard, 2 epochs with a checkpoint each: ms a step,
               the step's all_reduce host time, gather_s / wait_s, peak
               device memory per rank, the val error beside
               covertype-train's and below the all-zero model's; the
               epoch-1 checkpoint resumed twice on (4, 1), the two at the
               trajectory tolerance.  (c) a world of one, 1 x 1, nccl
               against gloo, one epoch on the same plan.
 30. mesh-serve — serving on the mesh (``distributed/sharding.py``,
               ``distributed/collectives.py``, the sharded models and
               engine), run after serve-jamba, as phase 29 runs its ranks
               (four gloo ranks sharing the card; no figure is a
               multi-card one).  (a) covertype-serve's engine through the
               launcher, ``serve_dsekl`` with ``--data-par 4`` and with
               ``--data-par 2 --model-par 2``: every query's f against
               the single-card engine's at rtol 2e-4, atol 1e-5 x max(1,
               |f|_inf), again from the same sharded engine's
               ``predict``; ``n_shards`` 4 and 2; one sm90 matvec a
               serve call on every rank; queries/s through
               ``flush_async`` and the f ``all_reduce``'s host time a
               serve call.  (b) jamba-v0.1-52b at serve-jamba's full
               width, depth and run on (1, 4) through ``serve_lm(ctx=)``:
               each rank 1 flash and 7 SSD launches a prefill, all sm90,
               at its local shapes (8 / 2 heads, 32 SSM heads), each held
               against its plain version; every layer run on the single
               card's input to it (serve-jamba's prompts, recorded layer
               by layer) and held to the single card's output at 2e-2 x
               |ref|_inf, on the tokens each MoE layer dispatched alike
               (the same expert set, kept or dropped alike; at most 5%
               otherwise: the random router's near-ties flip on a
               rounding difference, moving the capacity's cut, and the
               free-running prefill's logits, reported beside the
               reroutes, then drift far past the gate, as cuda and ref do
               on one card); prefill and decode ms, the all_reduces' host
               time, peak memory per rank.  (c) the
               launcher's reduced jamba on (2, 2) (the ZeRO weights
               gathered over data by the slot stack, the MoE's expert
               batches gathered and psum-scattered, the batch over data),
               held at the same gate to the single-device run on each
               data shard's half of the batch (the MoE's capacity is per
               data shard).  Then flash and the SSD scan timed alone at
               (b)'s local shapes (the kernels line's
               ``ms_bound_by_shape``).
 31. mesh-lm — LM training and the three layer kinds that serve on the
               mesh since PR 27, run after mesh-serve as phase 29 runs its
               ranks (four gloo ranks sharing the card; no figure is a
               multi-card one).  The parent first takes one card's
               references and frees them.  (a) mamba2-780m at full width
               (cut to 12 of its 48 layers, MESH_LM_LAYERS)
               through the launcher, ``--full --data-par 2
               --model-par 2 --dist-backend gloo``, lm-train's batch and
               rate, 4 steps, no checkpoint: no kernel launch (no kernel
               has a backward); every bf16 loss within 5e-3 and step 0's
               loss and grad norm within LM_DTYPE_RTOL of one card's run
               of the launcher; step 0 in float32 (the same seed's
               float32 draws) within 1e-4 of one card's, relative.
               Prints ms a step, the host-staged all_reduces' host time
               a step and peak memory per rank.  (b) llama-3.2-vision cut
               to one period (4 self- and 1 cross-attention layers, gates
               1.0) over its (4, 1,601, 4,096) frontend on (1, 4),
               whisper-tiny on (2, 2) (8 x 1,500 frames), deepseek-v3 cut
               to 1 layer on (1, 4) (the ranks draw its weights in turns)
               through ``serve_lm(ctx=)``, 4 greedy tokens each: flash
               launches counted by rank and path, all sm90, each distinct
               shape of a prefill held once against the plain version, 0
               in MLA; the prompts one card's; every layer on one card's
               recorded input at 2e-2 x |ref|_inf (deepseek's MoE
               dispatched to one card's expert sets, its own reroutes
               printed); llama and whisper in float32 from the same seed
               through the plain attention, the prefill and 2 decode steps
               fed one card's greedy tokens within 1e-4 x |ref|_inf;
               deepseek's float32 MLA sublayer within 1e-4 of one card's
               and its absorbed decode against the expanded prefill on
               the mesh at PR 24's limits; bf16 end to end printed.  Then
               the new local flash shapes timed alone (the kernels line's
               ``ms_bound_by_shape``).
 32. dryrun — the production dry-run (``launch/dryrun.py``) against
               the card, run after serve-jamba (before mesh-serve).  (a)
               serve-jamba's prefill (8 layers at full width, 4 x 2,048
               tokens), the DSEKL mesh step on a world of one at the
               covertype shape (N 559,888, D 54, I = J = 1,024) and
               lm-train's step (mamba2-780m, 12 layers, 8 x 1,024), each
               built by the dry-run's builders, traced on the meta device
               (a fake world of one for the DSEKL step) and then run on
               the card: the traced kernel launches by op and route equal
               the card's ``launches_by_route`` deltas, and the card's
               peak (``max_memory_allocated`` after a reset, less what
               was allocated before other than the step's arguments) is
               within DRYRUN_PEAK_TOL of the traced arguments + temp.
               Each kernel op's added dispatch cost a call (its CUDA
               wrapper through the ``torch.library`` op against its body
               called directly; the kernels line's ``dispatch_added_us``
               of rows 1, 2, 6, 7).  (c) DRYRUN_CELLS through the
               dry-run's command line on this host, every record ok, each
               cell's per-rank GiB beside the card's memory.  (b) runs in
               mesh-serve's ranks: the float32 jamba on (1, 4) again under
               the decode override (``kv_seq`` over the model axis: each
               rank holds a quarter of every KV cache's slots), the
               prefill and 4 decode steps within 1e-4 x |ref|_inf of one
               card's float32 run, the routing held fixed.

The DSEKL kernel tolerance is the JAX suite's float32 one
(tests/test_dual_pass.py ``_tols``): rtol 2e-4, atol 1e-5 * max(1,
|oracle|_inf), on both matvec routes (the sm90 one splits its TF32
products three ways to keep float32's function).  The 16-step
cuda-vs-ref trajectory is held at rtol 1e-3, atol 1e-4 * max(1,
|oracle|_inf): sixteen steps of float32 sums taken in
another order, and duplicate J indices scattered by atomics on the card.
Flash attention and the SSD scan in float32 are held at the JAX suite's
tolerances (tests/test_kernels_models.py): flash 2e-6, SSD 1e-4, each atol
times max(1, |oracle|_inf) as above.  Given bfloat16 inputs, which the
kernels convert at load, each is held against its plain version on the
same values in float32: the bfloat16 output at rtol 8e-3 (one rounding)
with atol 1e-5 (flash) or 1e-4 (SSD) times max(1, |oracle|_inf), the
SSD's float32 final state at its float32 tolerance.  The sm90 flash and
SSD kernels are held to that same check: each splits its float32 factors
into bf16 terms (flash's P into two; the SSD's P into three, its state and
B o w into two) so that its products keep float32's function.
It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

DEVICE = "cuda"
RTOL, ATOL = 2e-4, 1e-5
PARITY_SHAPE = (1000, 5003)
SM90_PARITY_J = 1000                     # the ragged J of the sm90 train route
# The sm90 train route's wide variant (K in shared memory): J at its limit,
# and a ragged J that leaves the last CTAs' slices short or empty.
SM90_WIDE_PARITY_J = (4096, 3000)
PARITY_DIMS = (3, 54, 784)
PARITY_CASES = [
    ("rbf", (("gamma", 0.7),)),
    ("laplacian", (("gamma", 0.3),)),
    ("linear", ()),
    ("polynomial", (("gamma", 0.5), ("coef0", 0.0), ("degree", 3))),
    ("sigmoid", (("gamma", 0.5), ("coef0", 0.1))),
    ("matern32", (("length_scale", 1.3),)),
    ("matern52", (("length_scale", 0.8),)),
]
# The main path: the covertype protocol at full size (581,012 rows less
# 21,122 held out), RBF, 50% support, 16,384 queries in requests of 64.
SERVE_ARGS = ["--dsekl", "--data", "covertype", "--n-train", "559890",
              "--dim", "54", "--kernel", "rbf", "--support-frac", "0.5",
              "--queries", "16384", "--request", "64", "--query-block",
              "1024", "--max-queue", "64", "--seed", "0"]
# The training path: the covertype protocol (benchmarks/covertype_scale.py)
# at full size through the port's launcher, 2 epochs.
TRAIN_ARGS = ["--dsekl", "--data", "memory", "--n", "561938", "--dim", "54",
              "--n-grad", "1024", "--n-expand", "1024", "--kernel", "rbf",
              "--gamma", "1.0", "--epochs", "2", "--seed", "0"]
TRAIN_N = 561938 - 2048                      # rows left after the hold-out
TRAIN_STEPS = 2 * (TRAIN_N // 1024)          # 1,092
TWO_PASS_N = 65536                           # one epoch of 64 steps
# Algorithm 2 at the paper's parallel covertype protocol (Fig. 3a,
# benchmarks/covertype_scale.py: |I| = |J| = 1024, 4 workers, RBF): in
# memory for one epoch, then out of core from a memmap.
PARALLEL_ARGS = ["--dsekl", "--data", "memory", "--algorithm", "parallel",
                 "--workers", "4", "--n", "561938", "--dim", "54",
                 "--n-grad", "1024", "--n-expand", "1024", "--kernel", "rbf",
                 "--gamma", "1.0", "--epochs", "1", "--seed", "0"]
HOSTED_ARGS = [a if a != "memory" else "mmap" for a in PARALLEL_ARGS]
PARALLEL_STEPS = TRAIN_N // 1024             # 546 an epoch
PARALLEL_J = 4 * 1024                        # the step's J union
EVAL_CHUNK = 4096                            # decision_function_source's
HOSTED_VS_MEMORY_N = 65536
MMAP_DIR = os.path.join(ROOT, "build", "chip_smoke_mmap")
# EigenPro (core/precond.py) on the training paths: rank 64, m auto =
# min(N, max(4 (k + 1), 512)) = 512 subsample rows, so each step adds one
# vecmat at I = 1,024 against J = 512.
PRECOND_K = 64
PRECOND_M = 512
PRECOND_ARGS = ["--precondition-k", str(PRECOND_K)]
PRECOND_FIELDS = ("indices", "rows", "vectors", "damping", "eigenvalues")
# The JAX package's ``precond`` cell (benchmarks/perf_dsekl.py
# ``measure_precond``), rebuilt without JAX: band-limited labels on
# eigenmodes 16..200 of the RBF kernel matrix, square loss, const
# schedule at the matched step size pre.baseline_step_size(256) in both
# arms, epochs to a 0.35 validation error.  One data set and the cell's
# fit seed 3.
CONVERGE = dict(n=4096, d=54, gamma=0.05, band=(16, 200), n_val=512,
                batch=256, epochs=200, eval_every=5, target=0.35, seed=3)
# The cell's committed reading (BENCH_dsekl.json "precond", the JAX
# package on a CPU): epochs to target with and without the correction.
JAX_PRECOND_EPOCHS = {"precond": 52, "baseline": 82}
# Block coordinate descent (core/bcd.py) on the JAX ``bcd`` cell's problem
# (benchmarks/perf_dsekl.py ``measure_bcd``: CONVERGE's data, lam 1e-4,
# |J| = row tile = 256, square loss, up to 40 rounds, eval every round).
BCD_CELL = dict(block=256, row_block=256, lam=1e-4, rounds=40, target=0.35)
# The cell's committed reading (BENCH_dsekl.json "bcd", the JAX package on
# a CPU): rounds to 0.35 and the gap of the best val error to the dense
# solve's.
JAX_BCD = {"rounds_to_target": 2, "exact_gap": 0.0}
# One full-block round (|J| = n) is the dense solve: rows of the cell's
# data at gamma 0.2, where cond(A) ~ 4e2 (at the cell's 0.05 it is ~1e7,
# past what a float32 Cholesky resolves).
BCD_EXACT = dict(n=1024, gamma=0.2, lam=1e-4)
BCD_HOSTED_ROUNDS = 3
U32 = 2.0 ** -24                       # float32's unit roundoff
# The paper's baselines (core/baselines.py) and kernel PCA (core/kpca.py)
# at the main path's shape: I 1,024, 1,024 landmarks / features, RBF, D 54.
BASELINE_N, BASELINE_STEPS = 65536, 16
SVM_N, SVM_ITERS = 2048, 50
KPCA = dict(n=65536, r=4, j=256, steps=8, queries=4096)
# The online train-to-serve loop (serving/online.py) through the launcher's
# --online: D 54, a ring of 524,288 events prefilled with 262,144, 32,768
# ingested an epoch for 10 epochs (the ring wraps), |I| = |J| = 1,024, RBF
# gamma 1, hinge (the DSEKLConfig defaults JAX's serve_online uses),
# rebuilds at a drift of 0.1, query block 1,024, sv block 4,096; three
# client threads flush 64-row requests while it trains.
ONLINE_ARGS = ["--dsekl", "--online", "--dim", "54", "--capacity", "524288",
               "--n-prefill", "262144", "--events-per-epoch", "32768",
               "--epochs", "10", "--n-grad", "1024", "--n-expand", "1024",
               "--rebuild-drift", "0.1", "--query-block", "1024",
               "--sv-block", "4096", "--request", "64", "--seed", "0"]
ONLINE_CLIENTS = 3
ONLINE_ORACLE_SAMPLE = 1500        # responses held against their oracle
ONLINE_REPLAY = 1500               # each client's requests replayed idle
ONLINE_ERROR_ROWS = 4096
ONLINE_PROFILE_EPOCH = 3           # the fit thread's epoch traced
# The multi-tenant front door (serving/tenancy.py) through the launcher's
# --tenants on covertype-serve's engine, QoS on and off on identical
# traffic; then the reference harness's noisy-neighbor trace
# (benchmarks/load_harness.py, measure_multi_tenant) on a clock of one pump
# a round: victims gold (flat) and standard (diurnal) arrive with
# probability TENANT_VICTIM_P a round at peak, each cycling TENANT_POOL
# full-tile batches; the aggressor batch sends TENANT_BURST unique
# full-tile batches every TENANT_BURST_EVERY rounds; then gold and standard
# each queue TENANT_BACKLOG pool batches at once.
TENANT_SPEC = "gold:2,standard:1,batch:1:4:0"
TENANT_ARGS = SERVE_ARGS + ["--tenants", TENANT_SPEC, "--cache-blocks", "8"]
TENANT_ROUNDS, TENANT_VICTIM_P, TENANT_POOL = 240, 0.25, 3
TENANT_BURST, TENANT_BURST_EVERY, TENANT_BACKLOG = 8, 24, 48
TRAJ_RTOL, TRAJ_ATOL = 1e-3, 1e-4
LOSSES = ("hinge", "squared_hinge", "square", "logistic")
# fp32 outside the tensor cores, dense TF32 and bf16 on the tensor cores
# and HBM bandwidth (NVIDIA data sheets; TF32 is half the bf16 rate).
PEAKS = [  # (name substring, fp32, tf32 tensor, bf16 tensor FLOP/s, bytes/s)
    ("H100 PCIe", 51.2e12, 378e12, 756e12, 2.0e12),
    ("H100 NVL", 60.0e12, 417.5e12, 835e12, 3.9e12),
    ("H200", 67.0e12, 494.5e12, 989e12, 4.8e12),
    ("H100", 67.0e12, 494.5e12, 989e12, 3.35e12),
]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def compare(got, want, rtol: float = RTOL, atol: float = ATOL,
            floor: bool = True) -> float:
    """Max abs error; raises unless got matches want at the tolerance:
    atol x max(1, |want|_inf), or with ``floor=False`` atol x |want|_inf."""
    import torch
    got, want = got.double(), want.double()
    check(bool(torch.isfinite(got).all()), "non-finite kernel output")
    top = float(want.abs().max()) if want.numel() else 1.0
    atol = atol * (max(1.0, top) if floor else top)
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    check(not bool(bad.any()),
          f"{int(bad.sum())} of {got.numel()} values out of tolerance; max "
          f"abs err {float(err.max()):.3e} (atol {atol:.3e}, rtol {rtol})")
    return float(err.max()) if err.numel() else 0.0


def peaks(device_name: str) -> dict:
    """The named card's peaks: FLOP/s "fp32", "tf32" and "bf16" (tensor
    cores, dense), and "bytes"/s."""
    for key, *rates in PEAKS:
        if key in device_name:
            return dict(zip(("fp32", "tf32", "bf16", "bytes"), rates))
    raise SmokeFailure(f"no data-sheet peaks for {device_name!r}")


def _device_rows(prof) -> list:
    """(self device us, name, count) of a profile's device-side events
    (kernels, copies, fills): an aten op's row would repeat the device
    time of the kernels it launched, and a span's device range
    (``repro_torch.*``, a user annotation) the kernels under it."""
    import torch
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if ev.device_type != torch.autograd.DeviceType.CPU and dev_us > 0 \
                and not getattr(ev, "is_user_annotation", False):
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    return rows


# GPU clock cycles per ms of ``torch.cuda._sleep``'s spin (measured once),
# and the readings of ``device_ms``: kept, taken again behind a longer
# spin, and kept though the host paced them.
SPIN = {"cycles_per_ms": None}
READINGS = {"kept": 0, "retaken": 0, "host_paced": 0}


def _spin(ms: float) -> None:
    """Keep the current stream busy for about ``ms`` ms (a spin kernel)."""
    import torch
    if SPIN["cycles_per_ms"] is None:
        torch.cuda._sleep(1_000_000)                     # warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        end.synchronize()
        SPIN["cycles_per_ms"] = 20_000_000 / start.elapsed_time(end)
    torch.cuda._sleep(int(ms * SPIN["cycles_per_ms"]))


def device_ms(fn, reps: int = 25, warmup: int = 3, readings: int = 2,
              max_spin_ms: float = 1000.0) -> float:
    """Device time of one call in ms: the mean of ``readings`` readings,
    each CUDA events around ``reps`` calls enqueued back to back behind a
    spin kernel, over ``reps``.  The spin lasts twice the host's enqueue
    of ``reps`` calls (timed in the warm-up), so the host has enqueued
    every call before the device reaches the first: a reading leaves out
    the enqueue (argument checks, allocation, the launch itself), which
    at a few us of device work is most of a call, and keeps the device's
    own gaps between kernels.  A reading whose start event the device
    passed before the host had enqueued every call is taken again behind
    a spin twice as long; past ``max_spin_ms`` it is kept and counted as
    paced by the host (a function of many small launches that fill the
    launch queue).  No event can be lost: torch.profiler, which timed
    these rows before, dropped kernel events from its readings on the
    card."""
    import torch
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / max(warmup, 1) * reps
    torch.cuda.synchronize()
    spin_ms = min(max(2.0 * host_ms, 1.0), max_spin_ms)
    kept = []
    while len(kept) < readings:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        _spin(spin_ms)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        overtaken = start.query()
        end.synchronize()
        if overtaken and spin_ms < max_spin_ms:
            spin_ms = min(2.0 * spin_ms, max_spin_ms)
            READINGS["retaken"] += 1
            continue
        if overtaken:
            READINGS["host_paced"] += 1
            print(f"[device_ms] {fn.__qualname__}: the device reached the "
                  f"calls before the host had enqueued them, behind a "
                  f"{spin_ms:.0f} ms spin; the reading is paced by the host")
        kept.append(start.elapsed_time(end) / reps)
    READINGS["kept"] += readings
    return statistics.mean(kept)


def time_ms(fn, reps: int = 25, warmup: int = 3) -> list:
    """``reps`` CUDA-event timings of one call, in ms: the host's enqueue
    included, since the events bracket it."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi("name,power.limit")
    print(f"[device] {name} sm_{cap[0]}{cap[1]} count="
          f"{torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda}")
    print(smi)
    check(cap == (9, 0), f"needs sm_90 (Hopper), got sm_{cap[0]}{cap[1]}")
    return name, smi


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    records = _build.build_all()
    wall = time.perf_counter() - t0
    check(bool(records), "no kernel sources found")
    for rec in records.values():
        print(f"[build] {rec.name}: nvcc {rec.seconds:.1f}s -> "
              f"{os.path.relpath(rec.path, ROOT)}")
        for line in rec.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
    print(f"[build] all sources in {wall:.1f}s")
    _inspect_sm90(records["flash_attn_sm90"], "flash sm90",
                  ("HGMMA", "UTMALDG", "UTMASTG"))
    _inspect_sm90(records["ssd_sm90"], "ssd sm90", ("HGMMA", "UTMALDG"))
    _inspect_sm90(records["dsekl_matvec_sm90"], "matvec sm90", ("HGMMA",))
    _check_no_spills(records["dsekl_matvec_sm90"], "matvec sm90")
    _inspect_train_sm90(records["dsekl_train_sm90"])
    return records


def _inspect_train_sm90(rec) -> None:
    """The sm90 train kernel's instantiations (train_sm90, K in registers;
    train_sm90_wide, K in shared memory): ptxas's registers, static shared
    memory and spills for each, and the wide variant's dynamic shared
    memory.  No wide instantiation may spill, and no C75xx note may
    appear; the narrow kernel's spills are printed."""
    from repro_torch.kernels.dsekl import block
    what = "train sm90"
    entry, wide_spills = "", []
    for line in rec.log.splitlines():
        if "Compiling entry function" in line:
            entry = ("train_sm90_wide" if "train_sm90_wideI" in line else
                     "train_sm90" if "train_sm90I" in line else "helper")
            kind = line.split("ILi")[1][0] if "ILi" in line else "-"
            print(f"[build] {what} {entry} kind {kind}:")
        elif any(w in line for w in ("registers", "spill", "C75")):
            print(f"[build] {what}   {line.strip()[:160]}")
            if (entry == "train_sm90_wide" and "spill" in line
                    and not (" 0 bytes spill stores" in line
                             and " 0 bytes spill loads" in line)):
                wide_spills.append(line.strip())
    notes = [ln.strip() for ln in rec.log.splitlines() if "C75" in ln]
    check(not notes, f"{what}: ptxas notes {notes[:3]}")
    check(not wide_spills, f"{what}: the wide variant spilled registers: "
          f"{wide_spills[:3]}")
    lib = block._train_sm90_lib()
    print(f"[build] {what}: train_sm90_wide spills nothing; dynamic shared "
          f"memory a CTA {lib.dsekl_train_sm90_smem_bytes(4096)} B for the "
          f"wide variant (J > 1,024), {lib.dsekl_train_sm90_smem_bytes(1024)}"
          f" B for J <= 1,024")


def _check_no_spills(rec, what: str) -> None:
    """ptxas must report 0 bytes spilled for every kernel of ``rec``."""
    spills = [ln.strip() for ln in rec.log.splitlines()
              if "spill" in ln and not (" 0 bytes spill stores" in ln
                                        and " 0 bytes spill loads" in ln)]
    check(not spills, f"{what}: ptxas spilled registers: {spills[:3]}")
    print(f"[build] {what}: 0 bytes spilled in every kernel")


def _inspect_sm90(rec, what: str, required) -> None:
    """A tensor-core library: ptxas's registers, shared memory, spills and
    warnings for each kernel, and the SASS instructions that prove the
    tensor-core (and TMA) path (cuobjdump, where the toolkit has it): each
    of ``required`` must be > 0."""
    from repro_torch.kernels import _build
    for line in rec.log.splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "warning",
                                   "C75", "setmaxnreg")):
            print(f"[build] {what} {line.strip()[:200]}")
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    if not os.path.isfile(cuobjdump):
        print(f"[build] {what}: no cuobjdump at {cuobjdump}; SASS not "
              "counted")
        return
    sass = subprocess.run([cuobjdump, "-sass", str(rec.path)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout.splitlines()
    counts = {op: sum(op in line for line in sass)
              for op in ("HGMMA", "UTMALDG", "UTMASTG", "UBLKCP", "MUFU.EX2")}
    print(f"[build] {what} SASS (every instantiation): " + ", ".join(
        f"{op} {n}" for op, n in counts.items()))
    check(all(counts[op] for op in required),
          f"the {what} library lacks {required}: {counts}")


def _routed(fn, counter, route: str, what: str):
    """Call ``fn`` and check that ``counter`` counted one launch, on
    ``route``."""
    before = dict(counter.launches_by_route)
    out = _counted(fn, counter, what)
    before[route] += 1
    check(counter.launches_by_route == before,
          f"{what}: not launched on the {route} route")
    return out


def _counted(fn, counter, what: str):
    """Call ``fn`` and check that ``counter.launches`` went up by one."""
    import torch
    before = counter.launches
    out = fn()
    torch.cuda.synchronize()
    check(counter.launches == before + 1,
          f"{what}: launch count did not go up by one")
    return out


def phase_parity():
    import numpy as np
    import torch
    from repro_torch.kernels.dsekl import block, ops
    n_i, n_j = PARITY_SHAPE
    worst = {}

    def held(name, got, want):
        # The error relative to the tolerance's scale, max(1, |want|_inf).
        err = compare(got, want) / max(1.0, float(want.abs().max()))
        worst[name] = max(worst.get(name, 0.0), err)

    for d in PARITY_DIMS:
        worst.clear()
        routes_before = dict(block.kernel_matvec_cuda.launches_by_route)
        rng = np.random.default_rng(d)
        scale = 1.0 / np.sqrt(d)

        def dev(v):
            return torch.tensor(v, dtype=torch.float32, device=DEVICE)

        x = dev(rng.standard_normal((n_i, d)) * scale)
        z = dev(rng.standard_normal((n_j, d)) * scale)
        a = dev(rng.standard_normal(n_j))
        v = dev(rng.standard_normal(n_i))
        y = dev(np.where(rng.standard_normal(n_i) >= 0, 1.0, -1.0))
        y_reg = dev(rng.standard_normal(n_i))            # square loss
        # The indexed train pass: labels for the 5003 rows, and I and J
        # drawn with replacement (duplicates among them).
        y_n = dev(np.where(rng.standard_normal(n_j) >= 0, 1.0, -1.0))
        idx_i = torch.tensor(rng.integers(0, n_j, n_i), device=DEVICE)
        idx_js = [torch.tensor(rng.integers(0, n_j, w), device=DEVICE)
                  for w in (SM90_PARITY_J,) + SM90_WIDE_PARITY_J]
        for name, params in PARITY_CASES:
            kw = dict(kernel_name=name, params=dict(params))
            # The matvec and vecmat: on the tensor-core route for the six
            # cross-term kinds at D <= 64, else on the fp32 one.
            route = block.select_matvec_route(name, d)
            check(route == ("sm90" if name != "laplacian"
                            and d <= block.SM90_MAX_D else "fp32"),
                  f"{name} D={d}: route {route}")
            wrappers = (block.kernel_matvec_cuda, block.kernel_vecmat_cuda)
            by_route = [dict(f.launches_by_route) for f in wrappers]
            got = _counted(lambda: block.kernel_matvec_cuda(x, z, a, **kw),
                           block.kernel_matvec_cuda, name)
            want = block.kernel_matvec_plain(x, z, a, **kw)
            held(f"kernel_matvec {route}", got, want)
            got = _counted(lambda: block.kernel_vecmat_cuda(x, z, v, **kw),
                           block.kernel_vecmat_cuda, name)
            held(f"kernel_vecmat {route}", got,
                 block.kernel_vecmat_plain(x, z, v, **kw))
            for f, before in zip(wrappers, by_route):
                before[route] += 1
                check(f.launches_by_route == before,
                      f"{name} D={d}: not launched on the {route} route")
            # The dual and train passes on both train routes: the fp32
            # one at J = 5003, the sm90 one at the ragged J = 1000 (K in
            # registers) and at J = 4096 and 3000 (the wide variant, K in
            # shared memory).
            for w in (n_j, SM90_PARITY_J) + SM90_WIDE_PARITY_J:
                zz, aa = z[:w], a[:w]
                troute = block.select_train_route(n_i, w, d, name)
                check(troute == ("sm90" if w <= block.SM90_TRAIN_MAX_J
                                 else "fp32"),
                      f"{name} D={d} J={w}: train route {troute}")
                tag = troute + (" wide" if w in SM90_WIDE_PARITY_J else "")
                gf, gg = _routed(
                    lambda: block.dual_pass_cuda(x, zz, aa, v, **kw),
                    block.dual_pass_cuda, troute, name)
                wf, wg = block.dual_pass_plain(x, zz, aa, v, **kw)
                held(f"dual_pass {tag}", gf, wf)
                held(f"dual_pass {tag}", gg, wg)
                for loss in LOSSES:
                    yl = y_reg if loss == "square" else y
                    for f_scale in (1.0, TRAIN_N / zz.shape[0]):
                        gf, gg = _routed(
                            lambda: block.train_pass_cuda(
                                x, zz, aa, yl, loss=loss, f_scale=f_scale,
                                **kw),
                            block.train_pass_cuda, troute, f"{name} {loss}")
                        wf, wg = block.train_pass_plain(
                            x, zz, aa, yl, loss=loss, f_scale=f_scale, **kw)
                        held(f"train_pass {tag}", gf, wf)
                        held(f"train_pass {tag}", gg, wg)
            # The indexed train pass: rows of the J = 5003 block read by
            # index, as the steps read them from the training rows (J =
            # 1000 in registers, 4096 and 3000 in the wide variant).
            for idx_j in idx_js:
                w = idx_j.shape[0]
                ikw = dict(kw, loss="hinge", f_scale=TRAIN_N / w, lam=1e-4)
                gf, gg = _routed(
                    lambda: block.train_pass_indexed_cuda(z, y_n, a, idx_i,
                                                          idx_j, **ikw),
                    block.train_pass_indexed_cuda, "sm90", name)
                wf, wg = block.train_pass_indexed_plain(z, y_n, a, idx_i,
                                                        idx_j, **ikw)
                held(f"train_pass indexed J={w}", gf, wf)
                held(f"train_pass indexed J={w}", gg, wg)
                bf, bg = block.train_pass_cuda(
                    z[idx_i], z[idx_j], a[idx_j], y_n[idx_i], loss="hinge",
                    f_scale=TRAIN_N / w, **kw)
                check(torch.equal(gf, bf)
                      and torch.equal(gg, bg + 1e-4 * a[idx_j]),
                      f"{name} D={d} J={w}: the indexed train pass differs "
                      "from the gathered one")
            # The over-budget fallback: matvec then vecmat, no stash.
            budget, block.STASH_BUDGET = block.STASH_BUDGET, 0
            try:
                counts = [c.launches for c in (
                    block.kernel_matvec_cuda, block.kernel_vecmat_cuda,
                    block.train_pass_cuda)]
                gf, gg = ops.kernel_dual_pass(
                    x, z, a, y, kernel_name=name, kernel_params=params,
                    loss="hinge", f_scale=TRAIN_N / n_j, impl="cuda")
                torch.cuda.synchronize()
                check([c.launches for c in (
                    block.kernel_matvec_cuda, block.kernel_vecmat_cuda,
                    block.train_pass_cuda)] == [counts[0] + 1, counts[1] + 1,
                                                counts[2]],
                      f"{name}: the fallback did not run matvec then vecmat")
            finally:
                block.STASH_BUDGET = budget
            wf, wg = block.train_pass_plain(x, z, a, y, loss="hinge",
                                            f_scale=TRAIN_N / n_j, **kw)
            held("fallback", gf, wf)
            held("fallback", gg, wg)
        routes = {r: n - routes_before[r] for r, n in
                  block.kernel_matvec_cuda.launches_by_route.items()}
        print(f"[parity] D={d:<4d} 7 kernels, matvec launches by route "
              f"{routes}, worst max abs err / max(1, |want|_inf): "
              + ", ".join(f"{k} {e:.3e}" for k, e in worst.items())
              + "; the indexed train pass equals the gathered one bit for "
              "bit")


def phase_serve():
    import torch
    from repro_torch.kernels.dsekl import block, ops
    from repro_torch.launch import serve
    block.kernel_matvec_cuda.launches = 0        # the main path starts here
    block.kernel_matvec_cuda.launches_by_route = dict.fromkeys(
        block.MATVEC_ROUTES, 0)
    runs = {}
    for mode, extra in (("flush_async", []), ("flush", ["--sync"])):
        args = serve.parser().parse_args(
            SERVE_ARGS + ["--device", DEVICE] + extra)
        runs[mode] = serve.serve_dsekl(args)
    launches = block.kernel_matvec_cuda.launches  # ... and ends here
    by_route = dict(block.kernel_matvec_cuda.launches_by_route)
    serve_calls = 0
    for mode, res in runs.items():
        eng = res["engine"]
        serve_calls += eng.serve_calls
        f = torch.cat(res["outs"])
        check(f.shape == (res["queries"].shape[0],), f"{mode}: bad shape")
        check(bool(torch.isfinite(f).all()), f"{mode}: non-finite answers")
        xq = res["queries"][:1024].to(DEVICE)
        want = ops.kernel_matvec_tiled(
            xq, res["x_train"], res["alpha"], kernel_name="rbf",
            kernel_params=eng.cfg.kernel_params, z_block=4096, impl="ref")
        err = compare(f[:1024], want)
        st = eng.stats()
        print(f"[serve] {mode}: n_sv={st['n_sv']} padded={st['n_sv_padded']} "
              f"{res['queries_per_s']:.1f} queries/s, serve_calls="
              f"{eng.serve_calls}, first 1024 vs plain: max abs err "
              f"{err:.3e} (max|f| {float(want.abs().max()):.3e})")
    print(f"[serve] kernel_matvec launches={launches} (by route "
          f"{by_route}) serve_calls={serve_calls}")
    check(launches > 0 and launches == serve_calls,
          f"launches {launches} != serve calls {serve_calls}")
    check(by_route["sm90"] == launches,
          f"the serve launches did not all take the sm90 route: {by_route}")
    return runs["flush_async"], launches


def phase_train():
    """The training path at full width, then serving the trained model."""
    import torch
    from repro_torch.core.dsekl import decision_function, predict_labels
    from repro_torch.kernels.dsekl import block
    from repro_torch.launch import train
    from repro_torch.serving import engine_from_fit
    args = train.parser().parse_args(TRAIN_ARGS + ["--device", DEVICE])
    indexed = block.train_pass_indexed_cuda
    for f in (indexed, block.train_pass_cuda, block.dual_pass_cuda):
        f.launches = 0                         # the training path starts
        f.launches_by_route = dict.fromkeys(block.TRAIN_ROUTES, 0)
    block.kernel_matvec_cuda.launches = 0
    block.kernel_matvec_cuda.launches_by_route = dict.fromkeys(
        block.MATVEC_ROUTES, 0)
    out = train.train_dsekl(args)
    train_launches = indexed.launches                 # ... and ends here
    train_routes = dict(indexed.launches_by_route)
    contiguous_launches = block.train_pass_cuda.launches
    eval_launches = block.kernel_matvec_cuda.launches
    eval_routes = dict(block.kernel_matvec_cuda.launches_by_route)
    dual_launches = block.dual_pass_cuda.launches
    res, cfg = out["result"], out["cfg"]
    x, x_val, y_val = out["x"], out["x_val"], out["y_val"]
    check(tuple(x.shape) == (TRAIN_N, 54), f"training rows {tuple(x.shape)}")
    steps = res.epochs_run * max(x.shape[0] // cfg.n_grad, 1)
    print(f"[train] {res.epochs_run} epochs, {steps} steps: indexed "
          f"train_pass launches={train_launches} (by route {train_routes}),"
          f" contiguous train_pass launches={contiguous_launches}, "
          f"kernel_matvec launches (validation evals)={eval_launches} (by "
          f"route {eval_routes}), dual_pass launches={dual_launches}")
    check(train_launches == steps and steps == TRAIN_STEPS,
          f"train_pass launches {train_launches} != steps {steps}")
    check(train_routes == {"sm90": steps, "fp32": 0},
          f"the train-pass launches did not all take the sm90 route: "
          f"{train_routes}")
    check(contiguous_launches == 0, f"{contiguous_launches} launches of the "
          "contiguous train pass in a fit: the step gathered its rows")
    check(eval_launches == 2 and eval_routes["sm90"] == 2,
          f"{eval_launches} eval matvec launches ({eval_routes}), expected "
          "one per epoch's eval, on the sm90 route")
    # A fit with a loss takes the fused train pass; the dual pass
    # (loss=None) is the op's own path, driven by the parity phase.
    check(dual_launches == 0, f"{dual_launches} dual_pass launches in a "
          "fit, expected the train pass alone")
    alpha = res.state.alpha
    check(bool(torch.isfinite(alpha).all()), "non-finite alpha")
    zero_err = float(torch.mean((y_val != 1.0).to(torch.float32)))
    last = res.history[-1]["val_error"]
    print(f"[train] val errors "
          f"{[round(h['val_error'], 6) for h in res.history]}, all-zero "
          f"model {zero_err:.6f}, n_sv {int((alpha.abs() > 1e-8).sum())}")
    check(last < zero_err, f"val error {last} does not beat the all-zero "
          f"model's {zero_err}")
    _check_no_python_gathers(out)
    ep2 = res.history[-1]["seconds"]
    per = max(x.shape[0] // cfg.n_grad, 1)
    print(f"[train] epoch 2: {ep2 * 1e3:.3f} ms for {per} steps = "
          f"{ep2 / per * 1e3:.4f} ms/step, {per / ep2:.1f} steps/s (wall, "
          "eval excluded)")
    # Serve the trained model.
    eng = engine_from_fit(cfg, res, x, device=DEVICE)
    f_eng = eng.predict(x_val)
    f_fit = decision_function(cfg, alpha, x, x_val)
    err_eng = float(torch.mean((predict_labels(f_eng) != y_val).float()))
    atol = ATOL * max(1.0, float(f_fit.abs().max()))
    near0 = int((f_fit.abs() <= atol).sum())
    n_val = y_val.shape[0]
    print(f"[train] served by the engine (n_sv {eng.n_sv}): val error "
          f"{err_eng:.6f} vs the fit's {last:.6f}; {near0} labels with "
          f"|f| <= {atol:.1e}")
    check(abs(err_eng - last) * n_val <= near0 + 1e-6,
          "the engine's error differs from the fit's beyond near-zero f")
    return {"out": out, "launches": train_launches,
            "dual_launches": dual_launches, "ms_per_step": ep2 / per * 1e3,
            "steps_per_s": per / ep2}


# The torch functions that gather rows by index.
GATHERS = ("__getitem__", "index_select", "take", "gather", "index")


def _check_no_python_gathers(out, pc=None) -> None:
    """Two more Alg.-1 steps of the trained fit under a TorchFunctionMode
    that records every gather, by the tensor it reads: none may read x,
    y or alpha (the kernel reads their rows by index); the scatter's read
    of the adagrad accumulator is counted.  With an EigenPro block ``pc``
    each step may read x and y once (the correction's rows and labels at
    I) and alpha never, and launches one vecmat on the sm90 route."""
    import torch
    from torch.overrides import TorchFunctionMode
    from repro_torch.core import dsekl, sampler
    from repro_torch.kernels.dsekl import block
    cfg, x, y = out["cfg"], out["x"], out["y"]
    st = out["result"].state
    watched = {x.data_ptr(): "x", y.data_ptr(): "y",
               st.alpha.data_ptr(): "alpha"}
    seen = []

    class Gathers(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            name = getattr(func, "__name__", "")
            if (name in GATHERS and args
                    and isinstance(args[0], torch.Tensor)):
                seen.append(watched.get(args[0].data_ptr(),
                                        f"{tuple(args[0].shape)}"))
            return func(*args, **(kwargs or {}))

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    idx_i, idx_j = sampler.epoch_plan(gen, x.shape[0], cfg.n_grad,
                                      cfg.n_expand, 2)
    idx_i, idx_j = list(idx_i), list(idx_j)       # rows taken outside
    before = _indexed_launches()
    vecmats = block.kernel_vecmat_cuda.launches_by_route["sm90"]
    with Gathers():
        for t in range(2):
            st = dsekl.step_serial(cfg, st, x, y, idx_i[t], idx_j[t], pc)
            watched[st.alpha.data_ptr()] = "alpha"
    torch.cuda.synchronize()
    block_launches = _indexed_launches() - before
    vecmats = block.kernel_vecmat_cuda.launches_by_route["sm90"] - vecmats
    read = sorted(n for n in seen if n in ("x", "y", "alpha"))
    if pc is None:
        print(f"[train] 2 steps under a gather watch: {block_launches} "
              f"indexed train-pass launches; gathers in Python {seen} (none "
              "of x, y, alpha)")
        check(not read and block_launches == 2 and vecmats == 0,
              f"the step gathered {read} in Python, or launched the indexed "
              f"train pass {block_launches} times and the vecmat {vecmats} "
              "times for 2 steps")
        return
    print(f"[train-precond] 2 preconditioned steps under a gather watch: "
          f"{block_launches} indexed train-pass and {vecmats} sm90 vecmat "
          f"launches; gathers in Python {seen} (x and y once a step, alpha "
          "never)")
    check(read == ["x", "x", "y", "y"] and block_launches == 2
          and vecmats == 2,
          f"the preconditioned step gathered {read} in Python, or launched "
          f"{block_launches} train passes and {vecmats} vecmats for 2 steps")


def _indexed_launches() -> int:
    from repro_torch.kernels.dsekl import block
    return block.train_pass_indexed_cuda.launches_by_route["sm90"]


def phase_train_cuda_vs_ref(out):
    """16 Alg.-1 steps on one plan, impl cuda vs ref (square loss)."""
    import torch
    from repro_torch.core import dsekl, sampler
    cfg = out["cfg"].replace(loss="square")
    x, y = out["x"], out["y"]
    n = x.shape[0]
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    idx_i, idx_j = sampler.epoch_plan(gen, n, cfg.n_grad, cfg.n_expand, 16)
    states = {}
    for impl in ("cuda", "ref"):
        c = cfg.replace(impl=impl)
        st = dsekl.init_state(n, device=DEVICE)
        for t in range(16):
            st = dsekl.step_serial(c, st, x, y, idx_i[t], idx_j[t])
        torch.cuda.synchronize()
        states[impl] = st
    e_a = compare(states["cuda"].alpha, states["ref"].alpha, TRAJ_RTOL,
                  TRAJ_ATOL)
    e_g = compare(states["cuda"].accum, states["ref"].accum, TRAJ_RTOL,
                  TRAJ_ATOL)
    check(int(states["cuda"].step) == int(states["ref"].step) == 16,
          "step counters differ")
    print(f"[train-cuda-vs-ref] 16 steps, square loss: alpha max abs err "
          f"{e_a:.3e} (max|alpha| {float(states['ref'].alpha.abs().max()):.3e}"
          f"), accum max abs err {e_g:.3e}")


def phase_train_two_pass(cfg):
    """fuse_dual_pass=False: the path that launches the vecmat kernel."""
    import torch
    from repro_torch.core import fit
    from repro_torch.data import make_covertype_like
    from repro_torch.kernels.dsekl import block
    x, y = make_covertype_like(TWO_PASS_N, 54, seed=1, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    for f in (block.kernel_vecmat_cuda, block.kernel_matvec_cuda):
        f.launches = 0                         # the two-pass path starts
        f.launches_by_route = dict.fromkeys(block.MATVEC_ROUTES, 0)
    res = fit(cfg.replace(fuse_dual_pass=False), x, y, gen, n_epochs=1,
              tol=0.0, device=DEVICE)
    vecmat = block.kernel_vecmat_cuda.launches  # ... and ends here
    matvec = block.kernel_matvec_cuda.launches
    routes = {"vecmat": dict(block.kernel_vecmat_cuda.launches_by_route),
              "matvec": dict(block.kernel_matvec_cuda.launches_by_route)}
    check(bool(torch.isfinite(res.state.alpha).all()), "non-finite alpha")
    steps = TWO_PASS_N // 1024
    print(f"[train-two-pass] {TWO_PASS_N} x 54, 1 epoch of {steps} steps: "
          f"kernel_vecmat launches={vecmat}, kernel_matvec launches="
          f"{matvec} (by route {routes}), "
          f"{res.history[0]['seconds'] * 1e3:.3f} ms")
    check(vecmat == steps and matvec == steps,
          f"two-pass launches vecmat={vecmat} matvec={matvec}, expected "
          f"{steps}")
    check(all(r["sm90"] == steps for r in routes.values()),
          f"two-pass launches off the sm90 route: {routes}")
    return vecmat


def _step_inputs(out):
    """One step's operands from the trained model: the training rows x, y
    and alpha, I = J = 1024 indices into them drawn with replacement, and
    the rows they pick, gathered."""
    import torch
    x, y, alpha = out["x"], out["y"], out["result"].state.alpha
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    idx_i = torch.randint(0, x.shape[0], (1024,), generator=gen,
                          device=DEVICE)
    idx_j = torch.randint(0, x.shape[0], (1024,), generator=gen,
                          device=DEVICE)
    return {"x": x, "y": y, "alpha": alpha, "idx_i": idx_i, "idx_j": idx_j,
            "xi": x[idx_i].contiguous(), "xj": x[idx_j].contiguous(),
            "aj": alpha[idx_j].contiguous(), "yi": y[idx_i].contiguous()}


def phase_profile(out, parallel: bool = False, pc=None):
    """torch.profiler over 32 training steps (Algorithm 1's, or with
    ``parallel`` Algorithm 2's at 4 workers; with the EigenPro block
    ``pc`` when given): device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import dsekl, sampler
    cfg, x, y = out["cfg"], out["x"], out["y"]
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    if parallel:
        idx_i, idx_jk = sampler.parallel_epoch_plan(gen, x.shape[0], 1024,
                                                    1024, cfg.n_workers)

        def step(st, t):
            return dsekl._parallel_inner(cfg, st, x, y, idx_i[t], idx_jk[t],
                                         pc)
    else:
        idx_i, idx_j = sampler.epoch_plan(gen, x.shape[0], 1024, 1024, 36)

        def step(st, t):
            return dsekl.step_serial(cfg, st, x, y, idx_i[t], idx_j[t], pc)
    tag = ("[profile-parallel" if parallel else "[profile") + (
        "-precond]" if pc is not None else "]")
    st = out["result"].state
    for t in range(4):                                   # warm-up
        st = step(st, t)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(4, 36):
            st = step(st, t)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = _device_rows(prof)
    total = sum(r[0] for r in rows)
    check(total > 0, "torch.profiler recorded no device time")
    ours = sum(r[0] for r in rows if "(anonymous namespace)" in r[1])
    per_step = sum(r[2] for r in rows) / 32
    print(f"{tag} 32 steps: wall {wall * 1e3:.3f} ms (profiler on), "
          f"device busy {total / 1e3:.3f} ms = "
          f"{total / 1e3 / (wall * 1e3):.1%} of the wall; the train pass's "
          f"kernels {ours / 32:.1f} us a step of {total / 32:.1f}; "
          f"{per_step:.2f} device kernels (and copies, fills) a step")
    for dev_us, key, count in rows[:16]:
        print(f"{tag}   {dev_us / 1e3:9.3f} ms {count:5d}x {key[:90]}")
    return {"busy_ms": total / 1e3 / 32, "kernels": per_step,
            "busy_share": total / 1e3 / (wall * 1e3)}


def _reset_dsekl_counters() -> None:
    """Every DSEKL wrapper's launch counts to 0 (a main path starts)."""
    from repro_torch.kernels.dsekl import block
    for f in (block.train_pass_indexed_cuda, block.train_pass_cuda,
              block.dual_pass_cuda):
        f.launches = 0
        f.launches_by_route = dict.fromkeys(block.TRAIN_ROUTES, 0)
    for f in (block.kernel_matvec_cuda, block.kernel_vecmat_cuda):
        f.launches = 0
        f.launches_by_route = dict.fromkeys(block.MATVEC_ROUTES, 0)


def _dsekl_counts() -> dict:
    """Each DSEKL wrapper's launches by route, as the counters read now."""
    from repro_torch.kernels.dsekl import block
    return {f.__name__: dict(f.launches_by_route) for f in (
        block.train_pass_indexed_cuda, block.train_pass_cuda,
        block.dual_pass_cuda, block.kernel_matvec_cuda,
        block.kernel_vecmat_cuda)}


def _check_train_steps(counts: dict, steps: int, wrapper: str, route: str,
                       matvecs: int, what: str, vecmats: int = 0) -> None:
    """Every step one train-pass launch of ``wrapper`` on ``route`` (none
    on the other), no other train-pass or dual-pass launch, ``matvecs``
    matvec launches (the evals) and ``vecmats`` vecmat launches (EigenPro's
    correction, one a preconditioned step), all on the sm90 route."""
    none_t = {"sm90": 0, "fp32": 0}
    train = dict(none_t, **{route: steps})
    want = {"train_pass_indexed_cuda": none_t, "train_pass_cuda": none_t,
            "dual_pass_cuda": none_t,
            "kernel_matvec_cuda": {"sm90": matvecs, "fp32": 0},
            "kernel_vecmat_cuda": {"sm90": vecmats, "fp32": 0}}
    want[wrapper] = train
    check(counts == want, f"{what}: launches by wrapper and route {counts}, "
          f"expected {want}")


def _zero_model_error(y_val) -> float:
    import torch
    return float(torch.mean((y_val != 1.0).to(torch.float32)))


def phase_train_parallel():
    """Algorithm 2 at the Fig. 3a protocol, in memory: one epoch of 546
    steps, each one train pass over the 4,096-column J union (the sm90
    route's wide variant, rows read by index), then the validation eval
    (one matvec)."""
    import torch
    from repro_torch.launch import train
    args = train.parser().parse_args(PARALLEL_ARGS + ["--device", DEVICE])
    _reset_dsekl_counters()                    # the parallel path starts
    out = train.train_dsekl(args)
    counts = _dsekl_counts()                   # ... and ends here
    res, cfg = out["result"], out["cfg"]
    check(tuple(out["x"].shape) == (TRAIN_N, 54) and cfg.n_workers == 4,
          f"training rows {tuple(out['x'].shape)}, workers {cfg.n_workers}")
    steps = int(res.state.step)
    print(f"[train-parallel] {steps} steps, J union {PARALLEL_J}: launches "
          f"{counts}")
    check(steps == PARALLEL_STEPS, f"{steps} steps, expected "
          f"{PARALLEL_STEPS}")
    _check_train_steps(counts, steps, "train_pass_indexed_cuda", "sm90", 1,
                       "train-parallel")
    alpha = res.state.alpha
    check(bool(torch.isfinite(alpha).all()), "non-finite alpha")
    err, zero = res.history[-1]["val_error"], _zero_model_error(out["y_val"])
    ms = res.history[-1]["seconds"] / steps * 1e3
    print(f"[train-parallel] val error {err:.6f}, all-zero model "
          f"{zero:.6f}; {ms:.4f} ms/step over the epoch "
          f"({steps / res.history[-1]['seconds']:.1f} steps/s, wall, eval "
          f"excluded), n_sv {int((alpha.abs() > 1e-8).sum())}")
    check(err < zero, f"val error {err} does not beat the all-zero model's "
          f"{zero}")
    return {"out": out, "launches": steps, "ms_per_step": ms,
            "eval_launches": 1}


def phase_train_hosted():
    """The same protocol out of core: a 561,938 x 54 float32 memmap, 2
    epochs through the prefetcher, then one with the gather inline.  The
    dataset must never become device-resident.  The memmap stays for
    precond-hosted and bcd-hosted."""
    import torch
    from repro_torch.launch import train
    chunks = -(-TRAIN_N // EVAL_CHUNK)
    runs = {}
    for mode, extra in (("prefetch", ["--epochs", "2"]),
                        ("sync", ["--epochs", "1", "--no-prefetch"])):
        args = train.parser().parse_args(
            HOSTED_ARGS + extra + ["--device", DEVICE, "--mmap-dir",
                                   MMAP_DIR])
        _reset_dsekl_counters()                # the hosted path starts
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = train.train_dsekl(args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        counts = _dsekl_counts()               # ... and ends here
        res, src = out["result"], out["dataset"]
        x_bytes, y_bytes = (os.path.getsize(os.path.join(MMAP_DIR, f))
                            for f in (f"x_{src.n}x{src.d}.f32",
                                      f"y_{src.n}.f32"))
        on_disk = x_bytes + y_bytes
        steps = int(res.state.step)
        epochs = res.epochs_run
        check(out["source"].n == TRAIN_N and steps == epochs *
              PARALLEL_STEPS, f"{out['source'].n} rows, {steps} steps")
        print(f"[train-hosted] {mode}: {epochs} epoch(s), {steps} steps; "
              f"dataset {src.n} x {src.d} float32 on disk: x "
              f"{x_bytes / 2**20:.1f} MiB + y {y_bytes / 2**20:.1f} MiB; "
              f"launches {counts}")
        _check_train_steps(counts, steps, "train_pass_cuda", "sm90",
                           epochs * chunks, f"train-hosted {mode}")
        check(bool(torch.isfinite(res.state.alpha).all()), "non-finite alpha")
        err = res.history[-1]["val_error"]
        zero = _zero_model_error(out["y_val"])
        ld = res.loader
        hidden = 1.0 - ld["wait_s"] / ld["gather_s"]
        ms = res.history[-1]["seconds"] / PARALLEL_STEPS * 1e3
        print(f"[train-hosted] {mode}: {ms:.4f} ms/step over epoch {epochs} "
              f"(wall, eval excluded); gather_s {ld['gather_s']:.4f}, "
              f"wait_s {ld['wait_s']:.4f}, hidden {hidden:.1%} (over "
              f"{ld['steps']} steps); val errors "
              f"{[round(h['val_error'], 6) for h in res.history]}, all-zero "
              f"model {zero:.6f}; eval {chunks} matvec launches of "
              f"{out['x_val'].shape[0]} x {EVAL_CHUNK} x 54 each")
        print(f"[train-hosted] {mode}: device memory peak over the fit "
              f"{peak / 2**20:.2f} MiB above its start, against the "
              f"dataset's {on_disk / 2**20:.1f} MiB")
        check(peak < on_disk / 2, f"peak device memory {peak} B is not "
              f"below half the dataset's {on_disk} B: the dataset went to "
              "the device")
        check(err < zero, f"{mode}: val error {err} does not beat the "
              f"all-zero model's {zero}")
        runs[mode] = {"steps": steps, "ms_per_step": ms, "gather_s":
                      ld["gather_s"], "wait_s": ld["wait_s"],
                      "hidden": hidden, "peak_mib": peak / 2**20,
                      "eval_launches": epochs * chunks}
    runs["source"] = out["source"]
    runs["x_val"], runs["y_val"] = out["x_val"], out["y_val"]
    return runs


def phase_hosted_vs_memory():
    """One memmap at N = 65,536 on the same plans, as a hosted fit and on
    the device: Algorithm 2 bit for bit (its steps scatter no duplicate
    index), Algorithm 1 within the float32 tolerance (duplicate J indices
    scattered by atomics, lam added in-kernel on one side); then the
    copy stream: prefetched blocks behind a spin on the consumer's stream
    equal SyncGather's."""
    import shutil
    import torch
    from repro_torch.core import DSEKLConfig, fit, sampler
    from repro_torch.data import (BlockPrefetcher, SyncGather,
                                  make_memmap_dataset)
    n = HOSTED_VS_MEMORY_N
    d_dir = MMAP_DIR + "_small"
    src = make_memmap_dataset(d_dir, n, 54, seed=1)
    xs, ys = src.gather(slice(0, n))
    x = torch.from_numpy(xs).to(DEVICE)
    y = torch.from_numpy(ys).to(DEVICE)
    cfg = DSEKLConfig(n_grad=1024, n_expand=1024, n_workers=4, kernel="rbf",
                      kernel_params=(("gamma", 1.0),), lam=1e-4,
                      schedule="adagrad")
    gen = torch.Generator().manual_seed(6)
    cases = {
        "parallel": (cfg.replace(loss="hinge"), [
            sampler.parallel_epoch_plan(gen, n, 1024, 1024, 4)
            for _ in range(2)]),
        "serial": (cfg.replace(loss="square", n_workers=1), [
            sampler.epoch_plan(gen, n, 1024, 1024, n // 1024)
            for _ in range(2)]),
    }
    for algorithm, (c, plans) in cases.items():
        kw = dict(plans=plans, algorithm=algorithm, n_epochs=2, tol=0.0,
                  device=DEVICE)
        mem = fit(c, x, y, **kw).state
        host = fit(c, src, None, **kw).state
        torch.cuda.synchronize()
        if algorithm == "parallel":
            same = (torch.equal(mem.alpha, host.alpha)
                    and torch.equal(mem.accum, host.accum))
            diff = float((mem.alpha - host.alpha).abs().max())
            print(f"[hosted-vs-memory] Algorithm 2 (hinge, 2 x {n // 1024} "
                  f"steps): "
                  f"alpha and accum bit-identical {same} (max abs diff "
                  f"{diff:.3e}, max|alpha| "
                  f"{float(mem.alpha.abs().max()):.3e})")
            check(same, "hosted Algorithm 2 is not bit-identical to the "
                  "in-memory fit")
        else:
            e_a = compare(host.alpha, mem.alpha)
            e_g = compare(host.accum, mem.accum)
            print(f"[hosted-vs-memory] Algorithm 1 (square, 2 x {n // 1024} "
                  f"steps): "
                  f"alpha max abs err {e_a:.3e} (max|alpha| "
                  f"{float(mem.alpha.abs().max()):.3e}), accum {e_g:.3e}; "
                  f"rtol {RTOL}, atol {ATOL} x max(1, |.|_inf)")
    # The copy stream: 64 steps of the Alg.-2 plan; each consumer step
    # queues a spin, then copies its blocks out; compared with SyncGather.
    plan_i, plan_jk = (p.numpy() for p in cases["parallel"][1][0])
    flat = plan_jk.reshape(plan_i.shape[0], -1)
    steps = plan_i.shape[0]
    got = []
    with BlockPrefetcher(src, plan_i, flat, device=DEVICE) as loader:
        for _ in range(steps):
            _spin(2.0)
            got.append(tuple(b.clone() for b in loader.get()))
        torch.cuda.synchronize()
    sync = SyncGather(src, plan_i, flat, device=DEVICE)
    equal = all(all(torch.equal(a, b) for a, b in zip(g, sync.get()))
                for g in got)
    print(f"[hosted-vs-memory] copy stream: {steps} prefetched steps behind "
          f"a 2 ms spin each equal SyncGather's: {equal}")
    check(equal, "prefetched blocks differ from SyncGather's")
    shutil.rmtree(d_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# EigenPro preconditioning (core/precond.py): the training paths with the
# correction, its parity, the out-of-core estimate and the convergence cell.
# ---------------------------------------------------------------------------

def phase_train_precond(trained, parallel):
    """``train_dsekl --precondition-k 64`` on the covertype protocols of
    train (Algorithm 1, 2 epochs) and train-parallel (Algorithm 2, 4
    workers, 1 epoch): per step one indexed train pass and one vecmat,
    both on sm90; alpha finite and unlike the plain fit's of this run."""
    import torch
    from repro_torch.launch import train
    runs = {}
    for tag, base, plain, steps in (
            ("train-precond", TRAIN_ARGS, trained, TRAIN_STEPS),
            ("train-precond parallel", PARALLEL_ARGS, parallel,
             PARALLEL_STEPS)):
        args = train.parser().parse_args(base + PRECOND_ARGS
                                         + ["--device", DEVICE])
        _reset_dsekl_counters()                # the preconditioned path
        out = train.train_dsekl(args)
        counts = _dsekl_counts()               # ... and its end
        res, pre = out["result"], out["result"].precond
        n_steps = int(res.state.step)
        print(f"[{tag}] {res.epochs_run} epoch(s), {n_steps} steps; "
              f"EigenPro k {pre.k}, m {pre.m}, n {pre.n}, scale "
              f"{pre.scale:.6f} (mu_1 {pre.eigenvalues[0]:.6f}, mu_k+1 "
              f"{pre.eigenvalues[-1]:.6f}); estimate_s "
              f"{res.estimate_s:.4f}; launches {counts}")
        check(n_steps == steps and pre.k == PRECOND_K and pre.m == PRECOND_M,
              f"{tag}: {n_steps} steps (expected {steps}), k {pre.k}, "
              f"m {pre.m}")
        _check_train_steps(counts, n_steps, "train_pass_indexed_cuda",
                           "sm90", res.epochs_run, tag, vecmats=n_steps)
        alpha = res.state.alpha
        plain_res = plain["out"]["result"]
        check(bool(torch.isfinite(alpha).all()), f"{tag}: non-finite alpha")
        moved = int((alpha != plain_res.state.alpha).sum())
        check(moved > 0, f"{tag}: alpha equals the plain fit's: the "
              "correction did not fire")
        err, zero = (res.history[-1]["val_error"],
                     _zero_model_error(out["y_val"]))
        per = steps // res.epochs_run
        ms = res.history[-1]["seconds"] / per * 1e3
        print(f"[{tag}] {ms:.4f} ms/step over the last epoch (the plain "
              f"step {plain['ms_per_step']:.4f} in this run: "
              f"{ms / plain['ms_per_step']:.3f}x); val error {err:.6f}, the "
              f"plain fit's {plain_res.history[-1]['val_error']:.6f}, the "
              f"all-zero model's {zero:.6f} (beats it: {err < zero}); "
              f"{moved} alpha entries unlike the plain fit's (max abs diff "
              f"{float((alpha - plain_res.state.alpha).abs().max()):.3e})")
        runs[tag] = {"out": out, "launches": n_steps, "ms_per_step": ms,
                     "estimate_s": res.estimate_s}
    out = runs["train-precond"]["out"]
    pc = out["result"].precond.block(out["x"].device)
    _check_no_python_gathers(out, pc)
    runs["profile"] = phase_profile(out, pc=pc)
    return runs


def _unit_rows(x):
    """The rows scaled to unit norm on average: at RBF gamma 1 the raw
    covertype-like rows (|x|^2 ~ 16.6) give K ~ I, the spectrum flat and
    the correction near zero (scale 1.08); these give K far from I."""
    return (x / x.norm(dim=1).mean()).contiguous()


def _compare_biting(what, got, want, where=None, atol=ATOL, rtol=RTOL):
    """``compare`` at atol x |want|_inf (no floor at 1), after checking
    that the values it holds (``want[where]``) are not near zero: their
    median is above 100x that atol, so a zero or sign-flipped answer
    fails.  Returns (max abs err, |want|_inf, the median)."""
    top = float(want.abs().max())
    held = want if where is None else want[where]
    med = float(held.abs().median())
    check(med > 100 * atol * top, f"{what}: median |ref| {med:.3e} is not "
          f"above 100x the atol {atol * top:.3e}: the comparison cannot "
          "fail a wrong answer")
    return compare(got, want, rtol=rtol, atol=atol, floor=False), top, med


def phase_precond_parity(out):
    """The correction, a preconditioned Algorithm-1 step and Algorithm-2
    step on the card, CUDA against ref on the same inputs (float32
    tolerance, atol x |ref|_inf without a floor), on the main path's
    rows scaled to unit norm (``_unit_rows``); each vecmat on the sm90
    route.  The steps are also held on the correction's own share of
    alpha: the preconditioned step less the plain step of its backend."""
    import torch
    from repro_torch.core import dsekl, precond, sampler
    from repro_torch.kernels.dsekl import block
    cfg, y = out["cfg"], out["y"]
    x = _unit_rows(out["x"])
    n, d = x.shape
    # Small alpha, so that |f| < 1 on most gradient rows and the hinge
    # gradient v, which the correction maps, is dense.
    st = out["result"].state
    st = st._replace(alpha=0.1 * torch.randn(
        n, generator=torch.Generator(device=DEVICE).manual_seed(16),
        device=DEVICE))
    check(block.select_matvec_route(cfg.kernel, d) == "sm90",
          "the correction's vecmat is not on the sm90 route")
    pres = {m: precond.estimate_preconditioner(
        cfg, x[:65536], torch.Generator().manual_seed(13), k=PRECOND_K,
        m=m, device=DEVICE) for m in (PRECOND_M, 500)}
    print("[precond-parity] on unit-norm rows: EigenPro scale "
          + ", ".join(f"{p.scale:.4f} (m {m})" for m, p in pres.items()))
    pcs = {m: p.block(x.device) for m, p in pres.items()}
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    vecmat, indexed = block.kernel_vecmat_cuda, block.train_pass_indexed_cuda
    errs = []
    for n_i in (1024, 1000):
        idx = torch.randint(0, n, (n_i,), generator=gen, device=DEVICE)
        xi = x[idx].contiguous()
        v = torch.randn(n_i, generator=gen, device=DEVICE)
        for m, pc in pcs.items():
            got = _routed(lambda: dsekl.precond_correction(cfg, xi, v, pc,
                                                           1024),
                          vecmat, "sm90", f"correction I={n_i} m={m}")
            want = dsekl.precond_correction(cfg.replace(impl="ref"), xi, v,
                                            pc, 1024)
            what = f"correction I={n_i} m={m}"
            errs.append((what, *_compare_biting(what, got, want)))
    pc = pcs[PRECOND_M]
    idx_i, idx_j = sampler.epoch_plan(gen, n, 1024, 1024, 1)
    i_batches, idx_jk = sampler.parallel_epoch_plan(gen, n, 1024, 1024, 4)
    for name, c, step, ii, jj in (
            ("Algorithm-1 step", cfg, dsekl.step_serial, idx_i[0], idx_j[0]),
            ("Algorithm-2 step", cfg.replace(n_workers=4),
             dsekl._parallel_inner, i_batches[0], idx_jk[0])):
        before = [dict(f.launches_by_route) for f in (indexed, vecmat)]
        card = step(c, st, x, y, ii, jj, pc)
        torch.cuda.synchronize()
        for b in before:
            b["sm90"] += 1
        check([indexed.launches_by_route, vecmat.launches_by_route]
              == before, f"{name}: not one indexed train pass and one "
              "vecmat on the sm90 route")
        ref = step(c.replace(impl="ref"), st, x, y, ii, jj, pc)
        plain = step(c, st, x, y, ii, jj)
        plain_ref = step(c.replace(impl="ref"), st, x, y, ii, jj)
        what = f"{name} correction's share of alpha"
        errs.append((what, *_compare_biting(what, card.alpha - plain.alpha,
                                            ref.alpha - plain_ref.alpha,
                                            pc.indices)))
        for f in ("alpha", "accum"):
            want = getattr(ref, f)
            errs.append((f"{name} {f}", compare(getattr(card, f), want,
                                                floor=False),
                         float(want.abs().max()), None))
    print("[precond-parity] cuda vs ref, max abs err (max|ref|, median "
          "|ref| held): " + "; ".join(
              f"{k} {e:.3e} ({w:.3e}"
              + (f", {med:.3e})" if med is not None else ")")
              for k, e, w, med in errs)
          + f"; rtol {RTOL}, atol {ATOL} x |ref|_inf")


def phase_precond_hosted(src):
    """The estimate from train-hosted's memmap and from the same rows on
    the card: bit for bit.  One preconditioned hosted Algorithm-2 epoch,
    prefetched, against the in-memory epoch on the same plan: bit for
    bit.  The memmap stays for bcd-hosted."""
    import numpy as np
    import torch
    from repro_torch.core import DSEKLConfig, fit, precond, sampler
    cfg = DSEKLConfig(n_grad=1024, n_expand=1024, n_workers=4, kernel="rbf",
                      kernel_params=(("gamma", 1.0),), loss="hinge",
                      lam=1e-4, schedule="adagrad", precondition_k=PRECOND_K)
    xs, ys = src.gather(slice(0, src.n))
    x, y = torch.from_numpy(xs).to(DEVICE), torch.from_numpy(ys).to(DEVICE)
    pres, secs = [], []
    for data in (src, x):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pres.append(precond.estimate_preconditioner(
            cfg, data, torch.Generator().manual_seed(14), device=DEVICE))
        secs.append(time.perf_counter() - t0)
    same = all(np.array_equal(getattr(pres[0], f), getattr(pres[1], f))
               for f in PRECOND_FIELDS)
    print(f"[precond-hosted] estimate from the memmap ({src.n} x {src.d}, "
          f"{-(-src.n // 4096)} chunks of 4,096 rows) {secs[0]:.4f}s, from "
          f"the same rows on the card {secs[1]:.4f}s: bit-identical {same}")
    check(same, "the estimate from the memmap differs from the one from "
          "the same rows in memory")
    plan = sampler.parallel_epoch_plan(torch.Generator().manual_seed(15),
                                       src.n, 1024, 1024, 4)
    kw = dict(plans=[plan], algorithm="parallel", n_epochs=1, tol=0.0,
              precondition=pres[0], device=DEVICE)
    _reset_dsekl_counters()                    # the hosted path starts
    host = fit(cfg, src, None, **kw)
    counts = _dsekl_counts()                   # ... and ends here
    mem = fit(cfg, x, y, **kw)
    steps = int(host.state.step)
    _check_train_steps(counts, steps, "train_pass_cuda", "sm90", 0,
                       "precond-hosted", vecmats=steps)
    same = (torch.equal(host.state.alpha, mem.state.alpha)
            and torch.equal(host.state.accum, mem.state.accum))
    ms = host.history[-1]["seconds"] / steps * 1e3
    print(f"[precond-hosted] 1 hosted Algorithm-2 epoch ({steps} steps, "
          f"prefetched, {ms:.4f} ms/step) vs in memory on the same plan "
          f"({mem.history[-1]['seconds'] / steps * 1e3:.4f} ms/step): alpha "
          f"and accum bit-identical {same} (max abs diff "
          f"{float((host.state.alpha - mem.state.alpha).abs().max()):.3e})")
    check(same, "the preconditioned hosted epoch differs from the "
          "in-memory one")
    return {"launches": steps, "estimate_s": secs}


def _epochs_to_target(history, target: float):
    """The JAX cell's accounting (benchmarks/common.py
    ``to_target_summary``): the first eval whose best-so-far error is <=
    target, charged to the next epoch boundary; and the best error."""
    best, hit = 1.0, None
    for h in history:
        if "val_error" in h:
            best = min(best, h["val_error"])
            if hit is None and best <= target:
                hit = h["epoch"] + 1
    return hit, best


def _converge_problem():
    """CONVERGE's band-limited problem (benchmarks/common.py
    ``make_band_limited_problem``) on the card: covertype-like rows,
    labels sign(K alpha*) with alpha* on eigenmodes 16..200 of the float64
    kernel matrix (an eigh on the card).  Shared by precond-converge and
    bcd-cell."""
    import numpy as np
    import torch
    from repro_torch.core.kernels_fn import get_kernel
    from repro_torch.data import make_covertype_like
    c = CONVERGE
    n, d = c["n"], c["d"]
    xtr, _ = make_covertype_like(n, d, seed=0, device=DEVICE)
    xva, _ = make_covertype_like(c["n_val"], d, seed=1, device=DEVICE)
    kern = get_kernel("rbf", gamma=c["gamma"])
    t0 = time.perf_counter()
    kmat = kern(xtr.double(), xtr.double())
    _, u = torch.linalg.eigh(kmat)
    u = u.flip(1)                                   # descending
    lo, hi = c["band"]
    coef = torch.from_numpy(np.random.RandomState(11).randn(hi - lo))
    a_star = u[:, lo:hi] @ coef.to(DEVICE)
    kva = kern(xva.double(), xtr.double())
    ytr = torch.sign(kmat @ a_star).float()
    yva = torch.sign(kva @ a_star).float()
    torch.cuda.synchronize()
    return {"xtr": xtr, "ytr": ytr, "xva": xva, "yva": yva, "kmat": kmat,
            "kva": kva, "t_labels": time.perf_counter() - t0}


def phase_precond_converge(prob):
    """The JAX ``precond`` cell's protocol on the card (CONVERGE): epochs
    to a 0.35 validation error with and without the correction, at the
    same step size, at the cell's fit seed."""
    import torch
    from repro_torch.core import DSEKLConfig, fit, precond
    from repro_torch.kernels.dsekl import block
    c = CONVERGE
    n, d, gamma, target = c["n"], c["d"], c["gamma"], c["target"]
    lo, hi = c["band"]
    xtr, ytr, xva, yva = (prob[k] for k in ("xtr", "ytr", "xva", "yva"))
    t_labels = prob["t_labels"]
    cfg = DSEKLConfig(n_grad=c["batch"], n_expand=c["batch"], kernel="rbf",
                      kernel_params=(("gamma", gamma),), loss="square",
                      lam=1e-4, schedule="const", unbiased_scaling=True,
                      precondition_m=PRECOND_M, precondition_auto_lr=False)
    pre = precond.estimate_preconditioner(
        cfg, xtr, torch.Generator().manual_seed(11), k=PRECOND_K,
        device=DEVICE)
    cfg = cfg.replace(lr0=pre.baseline_step_size(c["batch"]))
    print(f"[precond-converge] n {n}, d {d}, RBF gamma {gamma}, labels on "
          f"eigenmodes {lo}..{hi} (f64 eigh of the {n}^2 kernel matrix and "
          f"labels {t_labels:.2f}s; {float((ytr > 0).float().mean()):.3f} "
          f"positive); k {pre.k}, m {pre.m}, scale {pre.scale:.4f}, lr0 "
          f"{cfg.lr0:.6e} (baseline_step_size({c['batch']})) in both arms")
    check(pre.scale > 1.0, f"scale {pre.scale} is not above 1")
    arms = {}
    for arm, p in (("baseline", 0), ("precond", pre)):
        def stop(epoch, st, rec):
            return _epochs_to_target([rec], target)[0] is not None

        before = block.kernel_vecmat_cuda.launches_by_route["sm90"]
        t0 = time.perf_counter()
        res = fit(cfg, xtr, ytr, torch.Generator().manual_seed(c["seed"]),
                  n_epochs=c["epochs"], tol=0.0, x_val=xva, y_val=yva,
                  eval_every=c["eval_every"], precondition=p,
                  on_epoch=stop, device=DEVICE)
        secs = time.perf_counter() - t0
        vecmats = (block.kernel_vecmat_cuda.launches_by_route["sm90"]
                   - before)
        steps = int(res.state.step)
        check(bool(torch.isfinite(res.state.alpha).all()),
              f"{arm}: non-finite alpha")
        check(vecmats == (steps if p else 0),
              f"{arm}: {vecmats} sm90 vecmats for {steps} steps")
        hit, best = _epochs_to_target(res.history, target)
        arms[arm] = hit
        print(f"[precond-converge] seed {c['seed']} {arm}: epochs to "
              f"{target} {hit} (best {best:.4f}, {res.epochs_run} epochs "
              f"run, {secs:.2f}s)")
    hp, hb = arms["precond"], arms["baseline"]
    print(f"[precond-converge] epochs to {target}: preconditioned {hp} "
          f"against baseline {hb}; the JAX cell's committed CPU reading "
          f"(BENCH_dsekl.json, other data): "
          f"{JAX_PRECOND_EPOCHS['precond']} against "
          f"{JAX_PRECOND_EPOCHS['baseline']}")
    check(hp is not None and (hb is None or hp < hb),
          f"the preconditioned arm did not reach {target} in fewer epochs "
          f"than the baseline: {hp} against {hb}")
    return {"epochs": arms, "scale": pre.scale}


# ---------------------------------------------------------------------------
# Block coordinate descent (core/bcd.py, trainer.BCDPlan): the JAX bcd
# cell's problem, one exact round, and BCD out of core at full width.
# ---------------------------------------------------------------------------

def _count_syncs(fn):
    """``(fn(), the host syncs it made)``: torch's sync debug mode warns at
    every synchronizing CUDA call (a device-to-host copy, a pageable
    host-to-device copy, a tensor's truth value, a synchronize), and the
    warnings are counted."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def _zero_one(f, y) -> float:
    """The error rate of labels f >= 0 -> +1 against y."""
    import torch
    return float(torch.mean((torch.where(f >= 0, 1.0, -1.0)
                             != y.to(f.dtype)).float()))


def phase_bcd_cell(prob):
    """The JAX ``bcd`` cell's problem on the card (CONVERGE's data,
    BCD_CELL): rounds to a 0.35 validation error, the best val error,
    kernel-tile evaluations to target, and the dense float64 solve's val
    error.  Gates: BCD reaches the target; the rounds run no hand kernel,
    so impl "cuda" and "ref" give the same alpha bit for bit, and so do
    prefetch and sync; a fit stopped after round 2 and resumed equals the
    uninterrupted one bit for bit; bcd_shards=2 runs.  Every eval is one
    matvec launch on the sm90 route."""
    import torch
    from repro_torch.core import DSEKLConfig, bcd, fit
    c, b = CONVERGE, BCD_CELL
    n, target, rounds = c["n"], b["target"], b["rounds"]
    xtr, ytr, xva, yva = (prob[k] for k in ("xtr", "ytr", "xva", "yva"))
    cfg = DSEKLConfig(n_grad=b["row_block"], n_expand=b["block"],
                      kernel="rbf", kernel_params=(("gamma", c["gamma"]),),
                      loss="square", lam=b["lam"], bcd_block=b["block"],
                      bcd_row_block=b["row_block"])

    def run(cfg_=cfg, **kw):
        args = dict(execution="bcd", n_epochs=rounds, tol=0.0, x_val=xva,
                    y_val=yva, device=DEVICE)
        args.update(kw)
        return fit(cfg_, xtr, ytr, torch.Generator().manual_seed(c["seed"]),
                   **args)

    _reset_dsekl_counters()                    # the bcd path starts
    t0 = time.perf_counter()
    res = run()
    secs = time.perf_counter() - t0
    counts = _dsekl_counts()                   # ... and ends here
    _check_train_steps(counts, 0, "train_pass_cuda", "sm90", rounds,
                       "bcd-cell")
    check(bool(torch.isfinite(res.state.alpha).all()), "non-finite alpha")
    hit, best = _epochs_to_target(res.history, target)
    per_round = bcd.kernel_tile_evals_per_round(n, b["block"])
    eye = torch.eye(n, dtype=torch.float64, device=DEVICE)
    a_ex = torch.linalg.solve(prob["kmat"] + b["lam"] * n * eye,
                              ytr.double())
    err_ex = _zero_one(prob["kva"] @ a_ex, yva)
    round_s = [h["seconds"] for h in res.history]
    print(f"[bcd-cell] n {n}, d {c['d']}, RBF gamma {c['gamma']}, lam "
          f"{b['lam']}, |J| {b['block']}, row tile {b['row_block']}, "
          f"{rounds} rounds ({secs:.2f}s with the evals; a round "
          f"{statistics.mean(round_s) * 1e3:.2f} ms, eval excluded): rounds "
          f"to {target} {hit}, best val error {best:.6f}, first "
          f"{res.history[0]['val_error']:.6f}; kernel-tile evaluations "
          f"{per_round} a round, "
          f"{hit * per_round if hit else None} to target; the dense "
          f"(K + lam n I)^-1 y (float64 on the card) val error "
          f"{err_ex:.6f}, BCD's gap to it {best - err_ex:+.6f}; launches "
          f"{counts['kernel_matvec_cuda']} matvec (one eval a round)")
    print(f"[bcd-cell] the JAX cell's committed CPU reading "
          f"(BENCH_dsekl.json, its own data): rounds to target "
          f"{JAX_BCD['rounds_to_target']}, exact_gap_bcd "
          f"{JAX_BCD['exact_gap']}")
    check(hit is not None, f"BCD did not reach {target} in {rounds} rounds "
          f"(best {best})")
    ref = run(cfg.replace(impl="ref"))
    sync = run(prefetch=False)
    ckpt = os.path.join(ROOT, "build", "chip_smoke_bcd_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    run(n_epochs=2, checkpoint_dir=ckpt)
    resumed = run(checkpoint_dir=ckpt, resume=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    sharded = run(cfg.replace(bcd_shards=2))
    same = {name: torch.equal(r.state.alpha, res.state.alpha)
            for name, r in (("cuda-vs-ref", ref), ("prefetch-vs-sync", sync),
                            ("resumed", resumed))}
    same["resumed history"] = ([h["delta_alpha"] for h in resumed.history]
                               == [h["delta_alpha"] for h in res.history])
    s_hit, s_best = _epochs_to_target(sharded.history, target)
    print(f"[bcd-cell] bit-identical alpha: {same}; val errors cuda vs ref "
          f"differ on {sum(a['val_error'] != r['val_error'] for a, r in zip(res.history, ref.history))} "
          f"of {rounds} rounds; bcd_shards=2: rounds to target {s_hit}, "
          f"best {s_best:.6f}, max |alpha - alpha(1 group)| "
          f"{float((sharded.state.alpha - res.state.alpha).abs().max()):.3e}"
          f" (max|alpha| {float(res.state.alpha.abs().max()):.3e})")
    check(all(same.values()), f"bcd-cell: not bit-identical: {same}")
    check(bool(torch.isfinite(sharded.state.alpha).all())
          and sharded.epochs_run == rounds, "bcd_shards=2 did not run")
    return {"rounds_to_target": hit, "best": best, "exact": err_ex,
            "eval_launches": rounds, "round_ms":
                statistics.mean(round_s) * 1e3}


def phase_bcd_exact(prob):
    """One full-block round (|J| = n = 1,024, no jitter) is the dense
    solve alpha = (K + lam n I)^-1 y, held at the tolerance that the
    system's float64 cond(A) gives a float32 Cholesky: atol 32 cond(A) u
    |alpha|_inf, rtol 0, with its median |alpha| above 100x that atol."""
    import torch
    from repro_torch.core import DSEKLConfig, fit
    from repro_torch.core.kernels_fn import get_kernel
    n, gamma, lam = BCD_EXACT["n"], BCD_EXACT["gamma"], BCD_EXACT["lam"]
    x = prob["xtr"][:n].contiguous()
    y = prob["ytr"][:n].contiguous()
    cfg = DSEKLConfig(n_grad=256, n_expand=n, kernel="rbf",
                      kernel_params=(("gamma", gamma),), loss="square",
                      lam=lam, bcd_jitter=0.0)
    res = fit(cfg, x, y, torch.Generator().manual_seed(0), execution="bcd",
              n_epochs=1, tol=0.0, device=DEVICE)
    k = get_kernel("rbf", gamma=gamma)(x.double(), x.double())
    eye = torch.eye(n, dtype=torch.float64, device=DEVICE)
    a_star = torch.linalg.solve(k + lam * n * eye, y.double())
    cond = float(torch.linalg.cond(k @ k + lam * n * k))
    tol = 32 * cond * U32
    err, top, med = _compare_biting("bcd-exact", res.state.alpha, a_star,
                                    atol=tol, rtol=0.0)
    print(f"[bcd-exact] n {n}, RBF gamma {gamma}, lam {lam}, one round of "
          f"|J| = n, no jitter: cond(A) {cond:.4e} (float64), tolerance "
          f"32 cond(A) u = {tol:.3e} x |alpha|_inf {top:.4e}; max abs err "
          f"{err:.3e} against the float64 solve (median |alpha| {med:.4e})")
    return {"cond": cond, "err": err, "top": top}


def phase_bcd_hosted(hosted, device_name: str):
    """BCD at full width out of core: train-hosted's 559,890 x 54 memmap,
    |J| = row tile = 1,024 (the defaults: n_expand, n_grad), 3 rounds
    prefetched, the streamed eval each round.  Seconds a round, host syncs
    (the sync debug mode's count), peak device memory (below half the
    dataset: the rows stay on the host), the val error beside the
    all-zero model's; then one more round on a BCDPlan under the profiler
    (device kernels a round) and the sync count, whose residual f at J
    must equal K(x_J, x_J) alpha_J by the matvec.  Removes the memmap."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import DSEKLConfig, bcd, fit, trainer
    from repro_torch.kernels.dsekl import ops
    src, x_val, y_val = hosted["source"], hosted["x_val"], hosted["y_val"]
    rounds = BCD_HOSTED_ROUNDS
    cfg = DSEKLConfig(n_grad=1024, n_expand=1024, kernel="rbf",
                      kernel_params=(("gamma", 1.0),), loss="square",
                      lam=1e-4)
    j, rb = bcd.block_size(cfg, src.n), bcd.row_block_size(cfg)
    blocks = -(-src.n // rb)
    chunks = -(-src.n // EVAL_CHUNK)
    _reset_dsekl_counters()                    # the hosted bcd path starts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    res, syncs = _count_syncs(lambda: fit(
        cfg, src, None, torch.Generator().manual_seed(0), execution="bcd",
        n_epochs=rounds, tol=0.0, x_val=x_val, y_val=y_val,
        device=DEVICE))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    counts = _dsekl_counts()                   # ... and ends here
    _check_train_steps(counts, 0, "train_pass_cuda", "sm90",
                       rounds * chunks, "bcd-hosted")
    check(res.loader["steps"] == rounds * 2 * blocks,
          f"{res.loader['steps']} tiles, expected {rounds * 2 * blocks}")
    alpha = res.state.alpha
    check(bool(torch.isfinite(alpha).all())
          and 0 < int((alpha != 0).sum()) <= rounds * j,
          "bcd-hosted: alpha non-finite or off its blocks")
    on_disk = src.nbytes
    check(peak < on_disk / 2, f"peak device memory {peak} B is not below "
          f"half the dataset's {on_disk} B")
    peak_f = peaks(device_name)["fp32"]
    gemm = blocks * 2 * rb * j * (j + 1)               # pass 1's products
    kblocks = 2 * blocks * 2 * rb * j * src.d          # both passes' K
    round_s = [h["seconds"] for h in res.history]
    zero = _zero_model_error(y_val)
    ld = res.loader
    print(f"[bcd-hosted] {src.n} x {src.d} memmap, |J| {j}, row tile {rb} "
          f"({blocks} row blocks a pass), {rounds} rounds prefetched: "
          f"seconds a round {[round(t, 4) for t in round_s]} (eval "
          f"excluded); host syncs {syncs / rounds:.1f} a round over the "
          f"fit (the loop's and the evals' {chunks}-chunk copies "
          f"included); peak device memory {peak / 2**20:.2f} MiB against "
          f"the dataset's {on_disk / 2**20:.1f} MiB; gather_s "
          f"{ld['gather_s']:.3f}, wait_s {ld['wait_s']:.3f} over "
          f"{ld['steps']} tiles; val errors "
          f"{[round(h['val_error'], 6) for h in res.history]}, all-zero "
          f"model {zero:.6f}; launches {counts['kernel_matvec_cuda']} "
          f"matvec (the evals)")
    print(f"[bcd-hosted] a round's fp32 work: pass 1 {blocks} x one "
          f"({j} x {rb}) . ({rb} x {j + 1}) GEMM = {gemm:.4e} FLOP, the K "
          f"tiles' cross terms {kblocks:.4e} more; bound at the fp32 peak "
          f"({peak_f / 1e12:.1f} TFLOP/s) {gemm / peak_f * 1e3:.3f} ms "
          f"(with the K tiles {(gemm + kblocks) / peak_f * 1e3:.3f} ms) "
          f"against {statistics.mean(round_s) * 1e3:.1f} ms read")
    # One more round, profiled, on a plan of its own.
    plan = trainer.BCDPlan(cfg, src, device=torch.device(DEVICE))
    try:
        state = plan.init_state()
        idx = bcd.sample_block(torch.Generator().manual_seed(1), src.n, j)
        plan.plan_epoch(idx)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, round_syncs = _count_syncs(
                lambda: plan.run_epoch(state, idx))
            wall = time.perf_counter() - t0
        rows = _device_rows(prof)
        busy = sum(r[0] for r in rows) / 1e3
        kernels = sum(r[2] for r in rows)
        idx_j = torch.from_numpy(idx).to(DEVICE)
        xj = torch.from_numpy(src.gather_x(idx)).to(DEVICE)
        want = ops.kernel_matvec(xj, xj, state.alpha[idx_j],
                                 kernel_params=cfg.kernel_params)
        err, top, med = _compare_biting("bcd-hosted residual",
                                        plan._f[idx_j], want)
    finally:
        plan.close()
    print(f"[bcd-hosted] one round under the profiler: wall "
          f"{wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
          f"({busy / (wall * 1e3):.1%}), {kernels} device kernels (and "
          f"copies, fills), {round_syncs} host syncs in the round's "
          f"run_epoch (the partials to the host among them); the "
          f"residual f_J against K(x_J, x_J) alpha_J by the matvec: max abs "
          f"err {err:.3e} of |ref|_inf {top:.3e} (median {med:.3e})")
    for dev_us, key, count in rows[:8]:
        print(f"[bcd-hosted]   {dev_us / 1e3:9.3f} ms {count:6d}x "
              f"{key[:80]}")
    shutil.rmtree(MMAP_DIR, ignore_errors=True)
    return {"eval_launches": rounds * chunks, "round_s": round_s,
            "syncs_per_round": round_syncs, "kernels_per_round": kernels,
            "peak_mib": peak / 2**20, "gemm_flop": gemm}


# ---------------------------------------------------------------------------
# The paper's baselines (core/baselines.py) and kernel PCA (core/kpca.py).
# ---------------------------------------------------------------------------

def _unit_pair(x, *others):
    """``x`` and ``others`` divided by x's mean row norm (K far from I at
    gamma 1; ``_unit_rows``)."""
    scale = x.norm(dim=1).mean()
    return tuple((t / scale).contiguous() for t in (x,) + others)


def phase_baselines():
    """The paper's baselines on covertype-like rows in memory, scaled to
    unit norm, at the main path's shape (I 1,024, RBF gamma 1, D 54):
    16 EmpFix steps against 1,024 fixed landmarks on impl "cuda" (one
    sm90 matvec and one sm90 vecmat a step) and on "ref", from the same
    landmarks and plans; 16 RKS steps at 1,024 features and a batch SVM
    at n 2,048 for 50 iterations, each held against the same run on the
    host's CPU.  Each hold at the float32 tolerance with atol x
    |ref|_inf (no floor), its median |ref| above 100x the atol."""
    import torch
    from repro_torch.core import DSEKLConfig, baselines as bl
    from repro_torch.data import make_covertype_like
    n = BASELINE_N
    x, y = make_covertype_like(n, 54, seed=2, device=DEVICE)
    xv, yv = make_covertype_like(2048, 54, seed=3, device=DEVICE)
    x, xv = _unit_pair(x, xv)
    gen = torch.Generator().manual_seed(21)
    land = torch.randperm(n, generator=gen)[:1024]
    plans = [torch.randint(0, n, (1024,), generator=gen).to(DEVICE)
             for _ in range(BASELINE_STEPS)]
    cfg = DSEKLConfig(n_grad=1024, n_expand=1024, kernel="rbf",
                      kernel_params=(("gamma", 1.0),), loss="square",
                      lam=1e-4, lr0=1e-4)
    models = {}
    for impl in ("cuda", "ref"):
        c = cfg.replace(impl=impl)
        m = bl.emp_fix_init(None, x, 1024, indices=land)
        if impl == "cuda":
            _reset_dsekl_counters()            # the EmpFix path starts
        t0 = time.perf_counter()
        for idx in plans:
            m = bl.emp_fix_step(c, m, x, y, idx)
        f_val = bl.emp_fix_decision(c, m, xv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if impl == "cuda":
            counts = _dsekl_counts()           # ... and ends here
            step_ms = secs / BASELINE_STEPS * 1e3
        models[impl] = (m, f_val)
    steps = BASELINE_STEPS
    _check_train_steps(counts, 0, "train_pass_cuda", "sm90", steps + 1,
                       "baselines emp-fix", vecmats=steps)
    err_a, top_a, med_a = _compare_biting(
        "emp-fix alpha", models["cuda"][0].alpha, models["ref"][0].alpha)
    err_f, top_f, med_f = _compare_biting(
        "emp-fix decision", models["cuda"][1], models["ref"][1])
    zero = _zero_model_error(yv)
    print(f"[baselines] EmpFix: {steps} steps of I 1,024 against 1,024 "
          f"landmarks (square, lr0 {cfg.lr0}), {step_ms:.4f} ms a step with "
          f"the decision (host clock); launches {counts}; cuda vs ref: "
          f"alpha max abs err {err_a:.3e} of |ref|_inf {top_a:.3e} (median "
          f"{med_a:.3e}), decision on 2,048 rows {err_f:.3e} of {top_f:.3e} "
          f"(median {med_f:.3e}); val error "
          f"{_zero_one(models['cuda'][1], yv):.6f}, all-zero model "
          f"{zero:.6f}")
    # RKS and the batch SVM run plain GEMMs: held against the CPU.
    rks = {}
    for dev in (DEVICE, "cpu"):
        xd, yd, xvd = (t.to(dev) for t in (x, y, xv))
        m = bl.rks_init(torch.Generator().manual_seed(22), 54, 1024, 1.0,
                        device=dev)
        for idx in plans:
            m = bl.rks_step(cfg.replace(lr0=5e-3), m, xd, yd, idx.to(dev))
        rks[dev] = (m.weights, bl.rks_decision(m, xvd))
    e_w, t_w, m_w = _compare_biting("rks weights", rks[DEVICE][0].cpu(),
                                    rks["cpu"][0])
    svm = {}
    scfg = cfg.replace(lr0=1.0)
    for dev in (DEVICE, "cpu"):
        xs, ys = x[:SVM_N].to(dev), y[:SVM_N].to(dev)
        t0 = time.perf_counter()
        a = bl.batch_svm_fit(scfg, xs, ys, n_iters=SVM_ITERS, lr0=1.0)
        svm[dev] = (a, bl.batch_svm_decision(scfg, a, xs, xv.to(dev)),
                    time.perf_counter() - t0)
    e_s, t_s, m_s = _compare_biting("batch svm alpha", svm[DEVICE][0].cpu(),
                                    svm["cpu"][0])
    print(f"[baselines] RKS: {steps} steps at 1,024 features, card vs CPU "
          f"weights max abs err {e_w:.3e} of |ref|_inf {t_w:.3e} (median "
          f"{m_w:.3e}), val error {_zero_one(rks[DEVICE][1], yv):.6f}; "
          f"batch SVM: n {SVM_N}, {SVM_ITERS} iterations "
          f"({svm[DEVICE][2]:.3f}s on the card), card vs CPU alpha max abs "
          f"err {e_s:.3e} of {t_s:.3e} (median {m_s:.3e}), val error "
          f"{_zero_one(svm[DEVICE][1], yv):.6f}")
    return {"matvec": steps + 1, "vecmat": steps, "step_ms": step_ms}


def phase_kpca():
    """Kernel PCA on 65,536 covertype-like rows (unit norm, RBF gamma 1):
    8 steps of r 4, J 256 on impl "cuda" and on "ref" from the same v0 and
    J plans, then ``transform`` of 4,096 new rows (16 chunks).  r matvec
    launches a step and r a chunk, all sm90; the subspaces held by their
    principal-angle cosines (>= 1 - 1e-4), ``transform`` of the same
    state cuda vs ref at the float32 tolerance, no floor, its median above
    100x the atol."""
    import dataclasses
    import torch
    from repro_torch.core import kpca
    from repro_torch.data import make_covertype_like
    k = KPCA
    n, r = k["n"], k["r"]
    x, _ = make_covertype_like(n, 54, seed=4, device=DEVICE)
    xq, _ = make_covertype_like(k["queries"], 54, seed=5, device=DEVICE)
    x, xq = _unit_pair(x, xq)
    gen = torch.Generator().manual_seed(31)
    v0 = torch.randn((n, r), generator=gen) / n ** 0.5
    plans = [torch.randint(0, n, (k["j"],), generator=gen)
             for _ in range(k["steps"])]
    cfg = kpca.KPCAConfig(n_components=r, n_grad=k["j"], n_expand=k["j"],
                          kernel="rbf", kernel_params=(("gamma", 1.0),))
    chunks = -(-n // kpca.TRANSFORM_CHUNK)
    _reset_dsekl_counters()                    # the kpca path starts
    t0 = time.perf_counter()
    state = kpca.fit(cfg, x, None, k["steps"], plans=plans, v0=v0)
    z = kpca.transform(cfg, state, x, xq)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _dsekl_counts()                   # ... and ends here
    launches = k["steps"] * r + chunks * r
    _check_train_steps(counts, 0, "train_pass_cuda", "sm90", launches,
                       "kpca")
    ref_cfg = dataclasses.replace(cfg, impl="ref")
    ref = kpca.fit(ref_cfg, x, None, k["steps"], plans=plans, v0=v0)
    qa = torch.linalg.qr(state.v.double())[0]
    qb = torch.linalg.qr(ref.v.double())[0]
    cos = torch.linalg.svdvals(qa.T @ qb)
    z_ref = kpca.transform(ref_cfg, state, x, xq)
    err, top, med = _compare_biting("kpca transform", z, z_ref)
    print(f"[kpca] n {n}, r {r}, J {k['j']}, {k['steps']} steps + transform "
          f"of {k['queries']} rows ({chunks} chunks) in {secs:.3f}s; "
          f"launches {counts}; principal-angle cosines cuda vs ref "
          f"{[round(float(c), 8) for c in cos]}; transform max abs err "
          f"{err:.3e} of |ref|_inf {top:.3e} (median {med:.3e})")
    check(float(cos.min()) >= 1 - 1e-4, f"kpca subspaces differ: cos {cos}")
    check(bool(torch.isfinite(z).all()) and tuple(z.shape) ==
          (k["queries"], r), "kpca transform shape or values")
    return {"matvec": launches}


def _replay(service, batches, cap: int) -> list:
    """Each client's first ``cap`` requests again, one thread a client, each
    request submitted and flushed: the flushes' host-clock latencies."""
    import threading
    lat, lock = [], threading.Lock()

    def client(seq):
        for q in seq[:cap]:
            service.submit(q)
            t0 = time.perf_counter()
            service.flush()
            dt = time.perf_counter() - t0
            with lock:
                lat.append(dt)

    threads = [threading.Thread(target=client, args=(seq,))
               for seq in batches]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return lat


@contextlib.contextmanager
def _gc_pauses():
    """The interpreter's garbage collections while the block runs, as
    (generation, seconds), timed by a ``gc.callbacks`` entry."""
    import gc
    pauses, t0 = [], [0.0]

    def timed(phase, info):
        if phase == "start":
            t0[0] = time.perf_counter()
        else:
            pauses.append((info["generation"], time.perf_counter() - t0[0]))

    gc.callbacks.append(timed)
    try:
        yield pauses
    finally:
        gc.callbacks.remove(timed)


def _gc_line(pauses) -> str:
    long = [t for _, t in pauses if t >= 1e-3]
    gen2 = [t for g, t in pauses if g == 2]
    top = sorted(long, reverse=True)[:5]
    return (f"{len(pauses)} collections, {len(gen2)} of generation 2 "
            f"(longest {max(gen2, default=0.0) * 1e3:.4f} ms), {len(long)} "
            f"of >= 1 ms summing {sum(long) * 1e3:.4f} ms, the longest "
            f"[{', '.join(f'{t * 1e3:.4f}' for t in top)}] ms")


def _profiled_service(base):
    """``base`` (the launcher's ``OnlineService``) with each flush timed
    and torch.profiler's device trace held on over the fit thread's epoch
    ONLINE_PROFILE_EPOCH, by a watcher thread that ``start`` starts."""
    import threading
    import torch
    from torch.profiler import ProfilerActivity, profile

    class Profiled(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.window = []            # (wall s, served anything) a flush
            self.window_s, self.prof = 0.0, None
            self._in_window = False
            self.watcher = threading.Thread(target=self._watch, daemon=True)
            self.flushes = []           # (start s, end s) while training
            self.rebuild_spans = []     # (start s, end s) of each rebuild

        def flush(self):
            t0 = time.perf_counter()
            out = super().flush()
            t1 = time.perf_counter()
            if self.running:
                self.flushes.append((t0, t1))
            if self._in_window:
                self.window.append((t1 - t0, bool(out)))
            return out

        def _maybe_rebuild(self):
            n, t0 = self.rebuilds, time.perf_counter()
            super()._maybe_rebuild()
            if self.rebuilds != n:
                self.rebuild_spans.append((t0, time.perf_counter()))

        def start(self):
            super().start()
            self.watcher.start()

        def _watch(self):
            # The first start of a profiler in a process takes seconds:
            # take it here, on epoch 0, so that the traced one is whole.
            warm = profile(activities=[ProfilerActivity.CUDA])
            warm.start()
            warm.stop()
            while self.running and self.epoch < ONLINE_PROFILE_EPOCH:
                time.sleep(1e-4)
            if self.epoch != ONLINE_PROFILE_EPOCH:
                return
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
            self._in_window = True
            t0 = time.perf_counter()
            while self.running and self.epoch == ONLINE_PROFILE_EPOCH:
                time.sleep(1e-4)
            self.window_s = time.perf_counter() - t0
            self._in_window = False
            torch.cuda.synchronize()
            prof.stop()
            self.prof = prof

    return Profiled


def _union_ms(spans) -> float:
    """The length of a union of (start ns, end ns) intervals, in ms."""
    total, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e6


def _streams(prof) -> dict:
    """A profile's device events (kernels, copies, fills; not the spans'
    device ranges) by CUDA stream: ``{stream: [(start ns, end ns, name),
    ...]}``."""
    import torch
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA \
                or ev.is_user_annotation():
            continue
        out.setdefault(ev.device_resource_id(), []).append(
            (ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name()))
    return out


def _online_profile(svc, serve) -> dict:
    """The profiled epoch: each stream's role (fit: it ran the train pass;
    serve: it ran the matvec; other), events and busy ms; the device time
    a sweep on the serving streams beside the window's flush walls."""
    import collections
    streams = _streams(svc.prof)
    role = {}
    for sid, evs in streams.items():
        names = " ".join(n for _, _, n in evs)
        role[sid] = ("fit" if "train_sm90" in names else
                     "serve" if "matvec_sm90" in names else "other")
    busy = {sid: _union_ms([e[:2] for e in evs])
            for sid, evs in streams.items()}
    every = _union_ms([e[:2] for evs in streams.values() for e in evs])
    w_ms = svc.window_s * 1e3
    for sid, evs in sorted(streams.items()):
        top = collections.Counter(n for _, _, n in evs).most_common(3)
        print(f"[online-profile] stream {sid} ({role[sid]}): {len(evs)} "
              f"device events, busy {busy[sid]:.4f} ms = "
              f"{busy[sid] / w_ms:.1%} of the epoch; most: " + "; ".join(
                  f"{c}x {n[:60]}" for n, c in top))
    sweeps = sum("matvec_sm90" in n for sid, evs in streams.items()
                 if role[sid] == "serve" for _, _, n in evs)
    check(sweeps > 0 and "fit" in role.values(),
          f"the traced epoch holds {sweeps} sweeps and streams {role}")
    serve_ms = sum(b for sid, b in busy.items() if role[sid] == "serve")
    served = [w for w, got in svc.window if got]
    p50 = serve._percentile_ms(served, 50)
    per_sweep = serve_ms / max(sweeps, 1)
    host = 1.0 - per_sweep / p50 if p50 else 0.0
    print(f"[online-profile] the fit thread's epoch {ONLINE_PROFILE_EPOCH} "
          f"(no rebuild in it): {w_ms:.4f} ms with the profiler on, device "
          f"busy {every:.4f} ms = {every / w_ms:.1%}; {len(svc.window)} "
          f"flushes, {len(served)} that served, their p50 {p50:.4f} ms, "
          f"p99 {serve._percentile_ms(served, 99):.4f} ms; {sweeps} sweeps "
          f"on the serving streams, {per_sweep:.4f} ms of device time each "
          f"= host {host:.1%} of that p50")
    return {"window_ms": w_ms, "busy_share": every / w_ms,
            "flush_p50": p50, "sweep_ms": per_sweep, "host_share": host,
            "streams": {r: sum(1 for v in role.values() if v == r)
                        for r in ("fit", "serve", "other")}}


def phase_online():
    """The online loop through ``serve_online``: three client threads
    flush while the fit thread trains (HostedPlan, Algorithm 1, on its own
    stream), publishes every epoch and rebuilds on drift."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.serving import DSEKLPredictionEngine
    args = serve.parser().parse_args(ONLINE_ARGS + ["--device", DEVICE])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    launcher_service = serve.OnlineService
    serve.OnlineService = _profiled_service(launcher_service)
    try:
        with _gc_pauses() as gc_train:
            _reset_dsekl_counters()            # the online path starts
            res = serve.serve_online(args, clients=ONLINE_CLIENTS,
                                     record_models=True)
            counts = _dsekl_counts()           # ... and ends here
    finally:
        serve.OnlineService = launcher_service
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    svc, st, ring = res["service"], res["stats"], res["ring"]
    svc.watcher.join()
    check(svc.prof is not None, f"the fit thread's epoch "
          f"{ONLINE_PROFILE_EPOCH} was not traced")
    # Algorithm 1 takes max(n // n_grad, 1) steps an epoch, on the n that
    # the epoch's publish logs.
    steps = sum(max(e["n"] // svc.cfg.n_grad, 1) for e in svc.publish_log
                if e["kind"] == "swap")
    print(f"[online] {svc.epoch} epochs, {steps} steps; ring total "
          f"{ring.total} of capacity {ring.capacity}; launches {counts}")
    check(svc.error is None, f"fit-thread error: {svc.error!r}")
    tickets = [r.ticket for r in res["responses"]]
    check(len(tickets) == len(set(tickets)), "a ticket was served twice")
    check(set(tickets) == set(res["sent"]), "tickets dropped or invented")
    versions = sorted({r.version for r in res["responses"]})
    check(len(versions) >= 2, f"versions served {versions}")
    check(svc.rebuilds >= 1, "no rebuild")
    check(ring.total > ring.capacity, "the ring never wrapped")
    none = {"sm90": 0, "fp32": 0}
    check(counts["train_pass_cuda"] == {"sm90": steps, "fp32": 0},
          f"train passes {counts['train_pass_cuda']}, expected {steps} "
          "on sm90")
    check(counts["train_pass_indexed_cuda"] == none
          and counts["dual_pass_cuda"] == none
          and counts["kernel_vecmat_cuda"] == none,
          f"unexpected launches {counts}")
    mv = counts["kernel_matvec_cuda"]
    check(mv["fp32"] == 0 and mv["sm90"] >= len(set(
        r.version for r in res["responses"])),
          f"matvec launches {mv}")

    # Every sampled response against a fresh engine on its version's
    # recorded (alpha, snapshot), one oracle at a time.
    rs = res["responses"]
    pick = np.unique(np.linspace(0, len(rs) - 1, min(
        len(rs), ONLINE_ORACLE_SAMPLE)).astype(int))
    sample = sorted((rs[i] for i in pick), key=lambda r: r.version)
    first = {}
    for r in rs:
        first.setdefault(r.version, r)
    sample += [r for v, r in first.items()
               if v not in {s.version for s in sample}]
    sample.sort(key=lambda r: r.version)
    oracle, held = None, 0
    for r in sample:
        if oracle is None or oracle.alpha_version != r.version:
            del oracle
            alpha, snap = svc.published(r.version)
            oracle = DSEKLPredictionEngine(
                svc.cfg, alpha, snap.gather_x(slice(None)),
                engine_cfg=svc.engine_cfg, device=DEVICE,
                alpha_version=r.version)
        check(torch.equal(r.f, oracle.predict(res["sent"][r.ticket])),
              f"ticket {r.ticket} is not bit-identical to version "
              f"{r.version}'s oracle")
        held += 1
    del oracle

    # The last published model on rows of its own snapshot.
    alpha, snap = svc.published(svc.version)
    idx = np.linspace(0, snap.n - 1, ONLINE_ERROR_ROWS).astype(np.int64)
    xr, yr = snap.gather(idx)
    eng = DSEKLPredictionEngine(svc.cfg, alpha, snap.gather_x(slice(None)),
                                engine_cfg=svc.engine_cfg, device=DEVICE)
    f = eng.predict(xr)
    del eng
    yr = torch.from_numpy(yr).to(DEVICE)
    err = float(torch.mean((torch.where(f >= 0, 1.0, -1.0) != yr).float()))
    zero = _zero_model_error(yr)
    print(f"[online] last model (version {svc.version}, n {snap.n}) on "
          f"{ONLINE_ERROR_ROWS} of its snapshot's rows: error {err:.6f}, "
          f"all-zero model {zero:.6f}")
    check(err < zero, f"online model error {err} does not beat the all-zero "
          f"model's {zero}")

    lat_train = res["latencies_s"]
    with _gc_pauses() as gc_idle:
        lat_idle = _replay(svc, res["client_batches"], ONLINE_REPLAY)
    lat_one = _replay(svc, res["client_batches"][:1], ONLINE_REPLAY)
    p50, p99 = (serve._percentile_ms(lat_train, q) for q in (50, 99))
    q50, q99 = (serve._percentile_ms(lat_idle, q) for q in (50, 99))
    fit_s = sum(svc.epoch_seconds)
    ms_step = fit_s / steps * 1e3
    log = svc.publish_log
    n_max = max(e["n"] for e in log)
    engine_bytes = 4 * n_max * (54 + 1)
    plan_bytes = 4 * 2 * n_max + 4 * 2 * (1024 * 54 + 1024 + 1024 * 54)
    print(f"[online] flush while training: p50 {p50:.4f} ms, p99 "
          f"{p99:.4f} ms over {len(lat_train)} flushes ({ONLINE_CLIENTS} "
          f"clients); after stop(), the first {ONLINE_REPLAY} requests of "
          f"each client again: p50 {q50:.4f} ms, p99 {q99:.4f} ms over "
          f"{len(lat_idle)} flushes")
    spans = svc.rebuild_spans
    during = [b - a for a, b in svc.flushes
              if any(a < e and b > r for r, e in spans)]
    apart = [b - a for a, b in svc.flushes
             if not any(a < e and b > r for r, e in spans)]
    print(f"[online] {len(spans)} rebuilds on the fit thread, ms each: "
          f"{', '.join(f'{(e - r) * 1e3:.1f}' for r, e in spans)}; "
          f"flushes while training that overlap one: {len(during)}, p50 "
          f"{serve._percentile_ms(during, 50):.4f} ms, p99 "
          f"{serve._percentile_ms(during, 99):.4f} ms; the other "
          f"{len(apart)}: p50 {serve._percentile_ms(apart, 50):.4f} ms, p99 "
          f"{serve._percentile_ms(apart, 99):.4f} ms")
    print(f"[online] after stop(), the first client's {ONLINE_REPLAY} "
          f"requests alone: p50 {serve._percentile_ms(lat_one, 50):.4f} ms, "
          f"p99 {serve._percentile_ms(lat_one, 99):.4f} ms")
    print(f"[online] garbage collection while training: "
          f"{_gc_line(gc_train)}; in the replay: {_gc_line(gc_idle)}")
    print(f"[online] fit thread {ms_step:.4f} ms a step ({steps} steps, "
          f"{fit_s:.3f} s in epochs; each epoch's wall includes its "
          f"gathers); staleness mean {st['staleness_mean']:.1f} max "
          f"{st['staleness_max']} events; {st['publishes']} publishes, "
          f"{st['rebuilds']} rebuilds, versions served {len(versions)}; "
          f"{held} responses held bit-identical to their oracle")
    print(f"[online] peak device memory {peak / 2**20:.2f} MiB above the "
          f"start, against two engines at n {n_max} "
          f"({2 * engine_bytes / 2**20:.2f} MiB) plus the plan "
          f"({plan_bytes / 2**20:.2f} MiB)")
    out = {"train_launches": steps, "matvec_launches": mv["sm90"],
           "p50": p50, "p99": p99, "idle_p50": q50, "idle_p99": q99,
           "ms_per_step": ms_step, "staleness_mean": st["staleness_mean"],
           "staleness_max": st["staleness_max"],
           "publishes": st["publishes"], "rebuilds": st["rebuilds"],
           "peak_mib": peak / 2**20,
           "profile": _online_profile(svc, serve)}
    del res, svc
    return out


def _tenant_trace(seed: int, dim: int, rows: int):
    """The reference harness's noisy-neighbor traffic
    (benchmarks/load_harness.py, ``measure_multi_tenant``) on a clock of
    one pump a round: the rounds of ``(tenant, batch)`` submits, and the
    backlog (one round) that holds gold and standard queued at once.
    Victims cycle pools of full-tile batches (stable tile hashes: the
    cacheable working set); the aggressor's batches are unique."""
    import math
    import numpy as np
    rng = np.random.default_rng((seed, 23))
    pools = {n: [rng.standard_normal((rows, dim)).astype(np.float32)
                 for _ in range(TENANT_POOL)] for n in ("gold", "standard")}
    drawn = {"gold": 0, "standard": 0}

    def pool(name):
        drawn[name] += 1
        return name, pools[name][(drawn[name] - 1) % TENANT_POOL]

    rounds = []
    for r in range(TENANT_ROUNDS):
        # standard's rate follows the harness's raised-cosine day (floor
        # 0.2 of the peak); gold's is flat.
        day = 0.2 + 0.8 * 0.5 * (1.0 - math.cos(2.0 * math.pi * r
                                                 / TENANT_ROUNDS))
        submits = []
        if rng.random() < TENANT_VICTIM_P:
            submits.append(pool("gold"))
        if rng.random() < TENANT_VICTIM_P * day:
            submits.append(pool("standard"))
        if r % TENANT_BURST_EVERY == 0:
            submits += [("batch", rng.standard_normal((rows, dim))
                         .astype(np.float32)) for _ in range(TENANT_BURST)]
        rounds.append(submits)
    backlog = [[pool(n) for n in ("gold", "standard")
                for _ in range(TENANT_BACKLOG)]]
    return rounds, backlog


def _backlogged_rows(pumps, gold_rows: int):
    """(gold, standard) rows served up to the last pump that served
    standard while gold still had rows queued; None if there was none."""
    got, fair = {"gold": 0, "standard": 0}, None
    for responses in pumps:
        for r in responses:
            got[r.tenant] += int(r.f.shape[0])
        if (any(r.tenant == "standard" for r in responses)
                and got["gold"] < gold_rows):
            fair = dict(got)
    return fair


def phase_tenants():
    """The front door through ``serve_tenants`` on covertype-serve's engine
    with QoS on, then off; on each front door the harness's noisy-neighbor
    trace and the backlog, the same traffic on both."""
    import gc
    import torch
    from repro_torch.launch import serve
    from repro_torch.serving import DSEKLPredictionEngine, EngineConfig
    pct = serve._percentile_ms
    args = serve.parser().parse_args(TENANT_ARGS + ["--device", DEVICE])
    rows = args.query_block
    trace, backlog = _tenant_trace(args.seed, args.dim, rows)
    arms, launches = {}, 0
    for qos in ("on", "off"):
        args = serve.parser().parse_args(
            TENANT_ARGS + ["--qos", qos, "--device", DEVICE])
        _reset_dsekl_counters()                # the tenants path starts
        res = serve.serve_tenants(args)
        fd = res["front_door"]
        # As the harness does: a generation-2 collection is as long as the
        # tails measured, so the trace runs with the collector held off.
        gc.collect()
        gc.disable()
        try:
            run = serve.drive_front_door(fd, trace)
        finally:
            gc.enable()
        back = serve.drive_front_door(fd, backlog)
        counts = _dsekl_counts()               # ... and ends here
        mv = counts["kernel_matvec_cuda"]
        print(f"[tenants] qos {qos}: launches {counts}")
        check(mv["fp32"] == 0, f"qos {qos}: fp32 matvec launches {mv}")
        check(all(v == {"sm90": 0, "fp32": 0} for k, v in counts.items()
                  if k != "kernel_matvec_cuda"), f"qos {qos}: {counts}")
        launches += mv["sm90"]
        everything = res["responses"] + [
            r for got in run["pumps"] + back["pumps"] for r in got]
        sent_all = {**res["sent"], **run["sent"], **back["sent"]}
        tickets = [r.ticket for r in everything]
        check(len(tickets) == len(set(tickets)),
              f"qos {qos}: a ticket was served twice")
        check(set(tickets) == set(sent_all),
              f"qos {qos}: tickets dropped or invented")
        all_sheds = res["sheds"] + run["sheds"] + back["sheds"]
        owners = fd.cache_info()["owners"]
        fair = _backlogged_rows(back["pumps"], TENANT_BACKLOG * rows)
        if qos == "on":
            check(len(all_sheds) > 0, "qos on: nothing was shed")
            check(all(s.tenant == "batch" for s in all_sheds),
                  f"qos on: sheds outside batch: {all_sheds[:3]}")
            check(fair is not None and fair["standard"] > 0,
                  "qos on: standard was never served while backlogged")
            ratio = fair["gold"] / fair["standard"]
            check(abs(ratio - 2.0) <= 0.2,
                  f"qos on: gold served {fair['gold']} rows against "
                  f"standard's {fair['standard']} (ratio {ratio:.3f})")
            check(owners["batch"]["resident"] == 0
                  and owners["batch"]["bypasses"] > 0,
                  f"qos on: batch's cache {owners['batch']}")
            check(owners["gold"]["hits"] > 0
                  and owners["standard"]["hits"] > 0,
                  f"qos on: the victims' pools never hit: {owners}")
            check(mv["sm90"] > 0, "qos on: the bypass launched no matvec")
        else:
            check(not all_sheds, f"qos off: {len(all_sheds)} sheds")
            ratio = None
        # The bare engine on the same rows and version (0): the cached
        # path for cached tenants, the streaming path for batch (QoS on).
        eng = res["engine"]
        ec = eng.engine_cfg
        oracles = {}
        for r in everything:
            tenant, q = sent_all[r.ticket]
            stream = qos == "on" and tenant == "batch"
            if stream not in oracles:
                oracles[stream] = DSEKLPredictionEngine(
                    eng.cfg, res["alpha"], res["x_train"],
                    engine_cfg=(EngineConfig(
                        query_block=ec.query_block, sv_block=ec.sv_block,
                        max_queue=ec.max_queue) if stream else ec),
                    device=DEVICE)
            check(r.version == 0 and torch.equal(
                r.f, oracles[stream].predict(q)),
                  f"qos {qos}: ticket {r.ticket} ({tenant}) differs from "
                  "the bare engine")
        del oracles
        stats = fd.stats()["tenants"]
        lat = run["latencies_s"]
        for name, ls in lat.items():
            ts = stats[name]
            oc = owners.get(name) or {}
            print(f"[tenants] qos {qos} {name}: p50 {pct(ls, 50):.4f} ms, "
                  f"p99 {pct(ls, 99):.4f} ms over {len(ls)} requests of the "
                  f"trace; served rows {ts['served_rows']}; shed "
                  f"{ts['shed']}; cache hits {oc.get('hits', 0)}, misses "
                  f"{oc.get('misses', 0)}, bypasses {oc.get('bypasses', 0)}")
        if qos == "off":
            oc = owners.get("_default", {})
            print(f"[tenants] qos off: unattributed cache hits "
                  f"{oc.get('hits', 0)}, misses {oc.get('misses', 0)}")
        if ratio is not None:
            print(f"[tenants] qos on: backlog, gold {fair['gold']} rows "
                  f"against standard's {fair['standard']} while both queued "
                  f"(ratio {ratio:.4f}); {len(all_sheds)} sheds, all batch")
        arms[qos] = {name: (pct(ls, 50), pct(ls, 99))
                     for name, ls in lat.items()}
        arms[qos]["victim_p99"] = max(pct(lat[n], 99)
                                      for n in ("gold", "standard"))
        arms[qos]["sheds"] = len(all_sheds)
        arms[qos]["ratio"] = ratio
        del res, fd, eng
        torch.cuda.empty_cache()
    on, off = arms["on"]["victim_p99"], arms["off"]["victim_p99"]
    print(f"[tenants] the victims' p99 (the worse of gold and standard over "
          f"the trace): QoS on {on:.4f} ms, off {off:.4f} ms "
          f"(off / on {off / on:.4f})")
    arms["launches"] = launches
    return arms


def phase_shape_times(device_name: str):
    """The sm90 matvec and vecmat at each shape this slice's paths give
    them (unit-norm rows, RBF gamma 1, D 54): device ms a call
    (``device_ms``), the bound (products at the TF32 tensor peak, the
    rest at fp32; bytes at HBM rate), and the error against the plain
    version.  Returns {label: (ms, bound_ms)}."""
    import torch
    from repro_torch.kernels.dsekl import block
    peak = peaks(device_name)
    shapes = [("bcd-cell eval", "matvec", 512, 4096),
              ("bcd-hosted eval", "matvec", 2048, 4096),
              ("emp-fix step", "matvec", 1024, 1024),
              ("emp-fix step", "vecmat", 1024, 1024),
              ("kpca step", "matvec", 65536, 256),
              ("kpca transform", "matvec", 4096, 4096),
              ("online flush n0", "matvec", 1024, 262144),
              ("online flush full ring", "matvec", 1024, 524288)]
    gen = torch.Generator(device=DEVICE).manual_seed(41)
    out = {}
    for label, kind, n_i, n_j in shapes:
        xi = torch.randn((n_i, 54), generator=gen, device=DEVICE) / 54 ** 0.5
        xj = torch.randn((n_j, 54), generator=gen, device=DEVICE) / 54 ** 0.5
        vec = torch.randn((n_j if kind == "matvec" else n_i,),
                          generator=gen, device=DEVICE)
        fn = (block.kernel_matvec_cuda if kind == "matvec"
              else block.kernel_vecmat_cuda)
        plain = (block.kernel_matvec_plain if kind == "matvec"
                 else block.kernel_vecmat_plain)

        def kernel():
            return fn(xi, xj, vec, kernel_name="rbf", params={"gamma": 1.0})

        err = compare(kernel(), plain(xi, xj, vec, kernel_name="rbf",
                                      params={"gamma": 1.0}))
        ms = statistics.mean([device_ms(kernel), device_ms(kernel)])
        products, ops_count, bytes_count = _matvec_work(n_i, n_j, 54)
        bound = max(products / peak["tf32"] + ops_count / peak["fp32"],
                    bytes_count / peak["bytes"]) * 1e3
        out[f"{label} {kind}"] = (ms, bound)
        print(f"[shape-times] kernel_{kind} at {label} (I {n_i}, J {n_j}, D "
              f"54): device {ms:.4f} ms a call, bound {bound:.6f} ms = "
              f"{bound / ms:.1%}; vs plain max abs err {err:.3e}")
    return out


def phase_precond_times(out, pre, device_name: str):
    """Row 2 at the correction's shape: the vecmat K(X_I, X_P)^T v at I =
    1,024 gradient rows of a step against the m = 512 subsample rows, D
    54, v the hinge gradient at the step's f; its bound (products at the
    TF32 tensor peak, the rest at fp32), the plain version and the fp32
    cross-term GEMM yardstick."""
    import torch
    from repro_torch.core.losses import get_loss
    from repro_torch.kernels.dsekl import block
    st = _step_inputs(out)
    xi, xj, aj, yi = st["xi"], st["xj"], st["aj"], st["yi"]
    f, _ = block.train_pass_plain(xi, xj, aj, yi, loss="hinge")
    v = get_loss("hinge").grad_f(f, yi).contiguous()
    rows = torch.from_numpy(pre.rows).to(DEVICE).contiguous()
    n_i, d = xi.shape
    n_j = rows.shape[0]
    check(block.select_matvec_route("rbf", d) == "sm90",
          "the correction's vecmat is not on the sm90 route")

    def kernel():
        return block.kernel_vecmat_cuda(xi, rows, v)

    def plain():
        return block.kernel_vecmat_plain(xi, rows, v)

    # At gamma 1 on these rows K ~ I and most outputs lie below the atol;
    # the error is taken on the same rows scaled to unit norm, where they
    # do not (``_unit_rows``), and on the main path's rows as well.
    s = out["x"].norm(dim=1).mean()
    xs, rs = (xi / s).contiguous(), (rows / s).contiguous()
    err, top, med = _compare_biting(
        "kernel_vecmat_precond", block.kernel_vecmat_cuda(xs, rs, v),
        block.kernel_vecmat_plain(xs, rs, v))
    err_main = compare(kernel(), plain(), floor=False)
    print(f"[times] kernel_vecmat_precond cuda vs plain: max abs err "
          f"{err:.3e} on unit-norm rows (max|ref| {top:.3e}, median "
          f"{med:.3e}), {err_main:.3e} on the main path's rows; rtol "
          f"{RTOL}, atol {ATOL} x |ref|_inf")
    t = _timed(kernel, plain)
    products, n_ops, n_bytes = _matvec_work(n_j, n_i, d)
    row = _row("kernel_vecmat_precond",
               "src/repro_torch/kernels/dsekl/csrc/dsekl_matvec_sm90.cu",
               "src/repro/kernels/dsekl/block.py:280", t, n_ops, n_bytes,
               device_name, err, device_ms(lambda: torch.matmul(xi, rows.T)),
               tensor_ops=products, tensor="tf32")
    row["kernel_route"] = "sm90"
    row["max_abs_err_main_rows"] = err_main
    # A time row of kernel_vecmat at another shape: its launches are
    # counted once, in kernel_vecmat's row.
    row["launches_counted_in"] = "kernel_vecmat"
    _print_row(row, t, f"I={n_i} J={n_j} D={d}", products + n_ops, n_bytes,
               "torch.matmul(xi, rows.T); sm90 route,")
    print(f"[times] kernel_vecmat_precond: {row['bound_ms'] / row['ms']:.1%}"
          f" of its bound")
    return row


def phase_parallel_times(out, device_name: str):
    """Row 4 at the Alg.-2 step's shape (I = 1024, J union = 4,096, D =
    54, RBF, hinge): the sm90 route's wide variant as the step calls it
    (rows by index, lam) and on the rows gathered beforehand, and the fp32
    route on the gathered rows, each against its plain version, with the
    fp32 cross-term GEMM as yardstick; and the step's indexed call with
    the fp32 route forced (the gathers, its launches, + lam * a_J in
    torch), as the step ran before the wide variant."""
    import torch
    from repro_torch.core.losses import LOSS_CODES
    from repro_torch.kernels.dsekl import block
    x, y, alpha = out["x"], out["y"], out["result"].state.alpha
    lam = out["cfg"].lam
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    idx_i = torch.randperm(x.shape[0], generator=gen, device=DEVICE)[:1024]
    idx_j = torch.randperm(x.shape[0], generator=gen,
                           device=DEVICE)[:PARALLEL_J]
    xi, yi = x[idx_i].contiguous(), y[idx_i].contiguous()
    xj, aj = x[idx_j].contiguous(), alpha[idx_j].contiguous()
    n_i, d = xi.shape
    n_j = xj.shape[0]
    check(block.select_train_route(n_i, n_j, d, "rbf") == "sm90",
          "the Alg.-2 step's shape is not on the sm90 route")
    check(block.fits_stash(n_i, n_j), "the Alg.-2 step's K stash is over "
          "the fp32 route's budget")
    kind, p = block.KINDS["rbf"], block.tile_params("rbf", None)
    lib = block._train_sm90_lib()
    clusters = lib.dsekl_train_sm90_active_clusters(kind, n_j)
    row_blocks = -(-n_i // block.SM90_TRAIN_ROWS)
    print(f"[times] train_pass sm90 route, wide variant at J={n_j}: "
          f"{row_blocks} row blocks of {block.SM90_TRAIN_ROWS} (clusters of "
          f"8 CTAs, {lib.dsekl_train_sm90_smem_bytes(n_j)} B of dynamic "
          f"shared memory a CTA); the card holds {clusters} such clusters "
          f"at once")
    check(clusters >= row_blocks, f"{row_blocks} row blocks need "
          f"{row_blocks} clusters at once, the card holds {clusters}")
    cross, norms, epi = 2 * n_i * n_j * d, 2 * d * (n_i + n_j), 8 * n_i * n_j
    n_ops = cross + norms + epi + 2 * n_i * n_j + 4 * n_i
    n_bytes = 4 * (n_i * d + n_j * d + n_j + n_i + n_i + n_j)
    t_gemm = device_ms(lambda: torch.matmul(xi, xj.T))
    src = "src/repro_torch/kernels/dsekl/csrc/"
    rows = []
    # (name, kernel route, source, kernel, plain, operations, bytes): the
    # sm90 row as the step calls it, which also reads its indices and adds
    # lam * a_j.
    cases = [
        ("train_pass_sm90_j4096", "sm90", src + "dsekl_train_sm90.cu",
         lambda: block.train_pass_indexed_cuda(x, y, alpha, idx_i, idx_j,
                                               loss="hinge", lam=lam),
         lambda: block.train_pass_indexed_plain(x, y, alpha, idx_i, idx_j,
                                                loss="hinge", lam=lam),
         n_ops + 2 * n_j, n_bytes + 8 * (n_i + n_j)),
        ("train_pass_fp32_j4096", "fp32", src + "dsekl_train.cu",
         lambda: block._launch_train_fp32(
             "fp32 route", xi, xj, aj, yi, LOSS_CODES["hinge"], kind, p, 1.0),
         lambda: block.train_pass_plain(xi, xj, aj, yi, loss="hinge"),
         n_ops, n_bytes),
    ]
    for name, kroute, source, kernel, plain, ops_count, bytes_count in cases:
        got, want = kernel(), plain()
        err = max(compare(got[0], want[0]), compare(got[1], want[1]))
        t = _timed(kernel, plain)
        row = _row(name, source, "src/repro/kernels/dsekl/block.py:432", t,
                   ops_count, bytes_count, device_name, err, t_gemm)
        row["kernel_route"] = kroute
        rows.append(row)
        _print_row(row, t, f"I={n_i} J={n_j} D={d}", ops_count, bytes_count,
                   f"torch.matmul(xi, xj.T); {kroute} route,")
        print(f"[times] {name}: {row['bound_ms'] / row['ms']:.1%} of its "
              f"bound")
    sm90, fp32 = rows
    contiguous = [device_ms(lambda: block.train_pass_cuda(xi, xj, aj, yi,
                                                          loss="hinge"))
                  for _ in range(2)]
    max_j = block.SM90_TRAIN_MAX_J
    block.SM90_TRAIN_MAX_J = 1024             # the step before the wide variant
    try:
        check(block.select_train_route(n_i, n_j, d, "rbf") == "fp32",
              "the forced route is not fp32")
        step_fp32 = [device_ms(lambda: block.train_pass_indexed_cuda(
            x, y, alpha, idx_i, idx_j, loss="hinge", lam=lam))
            for _ in range(2)]
    finally:
        block.SM90_TRAIN_MAX_J = max_j
    print(f"[times] train_pass_sm90_j4096: the step's call (rows by index, "
          f"lam in the kernel) device {sm90['ms']:.4f} ms; on the rows "
          f"gathered beforehand (train_pass_cuda, the hosted step's call) "
          f"{statistics.mean(contiguous):.4f} ms ({contiguous[0]:.4f}, "
          f"{contiguous[1]:.4f}); the fp32 route's kernels "
          f"{fp32['ms']:.4f} ms = {fp32['ms'] / sm90['ms']:.2f}x; the step's "
          f"call on the fp32 route (the gathers, the kernels, + lam * a_J) "
          f"{statistics.mean(step_fp32):.4f} ms ({step_fp32[0]:.4f}, "
          f"{step_fp32[1]:.4f})")
    sm90["contiguous_ms"] = statistics.mean(contiguous)
    fp32["step_call_ms"] = statistics.mean(step_fp32)
    return rows


def _row(name, source, replaces, t, ops_count, bytes_count, device_name,
         err, t_gemm=None, library=None, tensor_ops=0, tensor="bf16"):
    """One row of the kernels line from ``_timed``'s readings ``t``.
    ``ms`` and ``plain_ms`` are device time per call; ``wall_ms`` and
    ``plain_wall_ms`` are one call by CUDA events, the host's enqueue
    included; ``library_ms`` is one PyTorch call of the same function, where
    there is one, and ``gemm_ms`` the DSEKL kernels' cross-term GEMM.
    ``ops_count`` runs at the fp32 peak; ``tensor_ops``, the products the
    kernel runs on the tensor cores, at the ``tensor`` ("bf16" or "tf32")
    tensor peak, and the two times add up."""
    peak = peaks(device_name)
    t_ops = (ops_count / peak["fp32"] + tensor_ops / peak[tensor]) * 1e3
    t_bytes = bytes_count / peak["bytes"] * 1e3
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": None, "max_abs_err": err,
        "ms": statistics.mean(t["kernel"]),
        "plain_ms": statistics.mean(t["plain"]),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library, "gemm_ms": t_gemm,
        "wall_ms": statistics.median(t["kernel_wall"]),
        "plain_wall_ms": statistics.median(t["plain_wall"]),
    }


def _route_row(name, source, replaces, ms, plain_ms, ops_ms, bytes_ms,
               err, library=None) -> dict:
    """A row of the kernels line for a kernel's fp32 route, timed at its
    sm90 route's shape (``ms``, ``plain_ms``: device ms a call; ``ops_ms``,
    ``bytes_ms``: the two halves of the bound)."""
    return {"name": name, "route": "cuda", "kernel_route": "fp32",
            "source": source, "replaces": replaces, "launches": None,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": library}


def _timed(kernel, plain) -> dict:
    """Device ms per call (``device_ms``: the mean of two readings of 25
    calls) in turns plain, kernel, kernel, plain; then 25 CUDA-event
    timings of one call of each."""
    t = {"plain": [device_ms(plain)], "kernel": [device_ms(kernel)]}
    t["kernel"].append(device_ms(kernel))
    t["plain"].append(device_ms(plain))
    t["kernel_wall"] = time_ms(kernel)
    t["plain_wall"] = time_ms(plain)
    return t


def _print_row(row, t, shape: str, n_ops: float, n_bytes: float,
               gemm: str) -> None:
    print(f"[times] {row['name']} {shape} (rbf): device {row['ms']:.4f} ms "
          f"a call ({t['kernel'][0]:.4f}, {t['kernel'][1]:.4f}); one call "
          f"by events {row['wall_ms']:.4f} ms (min {min(t['kernel_wall']):.4f},"
          f" max {max(t['kernel_wall']):.4f}); plain device "
          f"{row['plain_ms']:.4f} ms, by events {row['plain_wall_ms']:.4f} "
          f"ms; bound {row['bound_ms']:.6f} ms ({row['bound_by']}: "
          f"{n_ops:.3e} ops, {n_bytes:.3e} B); gemm yardstick {gemm} device "
          f"{row['gemm_ms']:.4f} ms")


def phase_train_times(out, device_name: str):
    """The vecmat, the dual pass and the train pass at the training step's
    shape: rows 3 and 4 on the sm90 train route (row 4 as the step calls
    it, rows by index with lam), the contiguous sm90 train pass on a line
    of its own, and both passes on the fp32 route as rows of their own."""
    import torch
    from repro_torch.core.losses import LOSS_CODES, get_loss
    from repro_torch.kernels.dsekl import block
    st = _step_inputs(out)
    xi, xj, aj, yi = st["xi"], st["xj"], st["aj"], st["yi"]
    n_i, d = xi.shape
    n_j = xj.shape[0]
    lam = out["cfg"].lam
    # The step's own v: the hinge gradient at its decision values.
    f, _ = block.train_pass_plain(xi, xj, aj, yi, loss="hinge")
    v = get_loss("hinge").grad_f(f, yi).contiguous()
    t_gemm = device_ms(lambda: torch.matmul(xi, xj.T))
    cross, norms, epi = 2 * n_i * n_j * d, 2 * d * (n_i + n_j), 8 * n_i * n_j
    src = "src/repro_torch/kernels/dsekl/csrc/"
    route = block.select_matvec_route("rbf", d)
    check(route == "sm90", f"the step's vecmat takes the {route} route")
    troute = block.select_train_route(n_i, n_j, d, "rbf")
    check(troute == "sm90", f"the step's train pass takes the {troute} "
          "route")
    kind, p = block.KINDS["rbf"], block.tile_params("rbf", None)
    row_blocks = -(-n_i // block.SM90_TRAIN_ROWS)
    clusters = block._train_sm90_lib().dsekl_train_sm90_active_clusters(
        kind, n_j)
    print(f"[times] train_pass sm90 route: {row_blocks} row blocks of "
          f"{block.SM90_TRAIN_ROWS} (clusters of {-(-n_j // 128)} CTAs); "
          f"the card holds {clusters} such clusters at once")

    def fp32_route(vy, code):
        return lambda: block._launch_train_fp32(
            "fp32 route", xi, xj, aj, vy, code, kind, p, 1.0)

    dual_ops = cross + norms + epi + 2 * n_i * n_j
    train_ops = dual_ops + 4 * n_i
    vec_bytes = 4 * (n_i * d + n_j * d + n_j + n_i + n_i + n_j)
    rows = []
    # (name, kernel route, source, replaces, kernel, plain, fp32 ops, TF32
    # tensor-core products, bytes): the vecmat runs its products on the
    # tensor cores; the indexed train pass also reads its indices and
    # adds lam * a_j.
    cases = [
        ("kernel_vecmat", "sm90", src + "dsekl_matvec_sm90.cu",
         "src/repro/kernels/dsekl/block.py:280",
         lambda: block.kernel_vecmat_cuda(xi, xj, v),
         lambda: block.kernel_vecmat_plain(xi, xj, v),
         norms + epi, cross, 4 * (n_i * d + n_j * d + n_i + n_j)),
        ("dual_pass", "sm90", src + "dsekl_train_sm90.cu",
         "src/repro/kernels/dsekl/block.py:330",
         lambda: block.dual_pass_cuda(xi, xj, aj, v),
         lambda: block.dual_pass_plain(xi, xj, aj, v),
         dual_ops, 0, vec_bytes),
        ("train_pass", "sm90", src + "dsekl_train_sm90.cu",
         "src/repro/kernels/dsekl/block.py:432",
         lambda: block.train_pass_indexed_cuda(
             st["x"], st["y"], st["alpha"], st["idx_i"], st["idx_j"],
             loss="hinge", lam=lam),
         lambda: block.train_pass_indexed_plain(
             st["x"], st["y"], st["alpha"], st["idx_i"], st["idx_j"],
             loss="hinge", lam=lam),
         train_ops + 2 * n_j, 0, vec_bytes + 8 * (n_i + n_j)),
        ("dual_pass_fp32", "fp32", src + "dsekl_train.cu",
         "src/repro/kernels/dsekl/block.py:330",
         fp32_route(v, -1), lambda: block.dual_pass_plain(xi, xj, aj, v),
         dual_ops, 0, vec_bytes),
        ("train_pass_fp32", "fp32", src + "dsekl_train.cu",
         "src/repro/kernels/dsekl/block.py:432",
         fp32_route(yi, LOSS_CODES["hinge"]),
         lambda: block.train_pass_plain(xi, xj, aj, yi, loss="hinge"),
         train_ops, 0, vec_bytes),
    ]
    for (name, kroute, source, replaces, kernel, plain, n_ops, n_tensor,
         n_bytes) in cases:
        got, want = kernel(), plain()
        if isinstance(got, tuple):
            err = max(compare(got[0], want[0]), compare(got[1], want[1]))
        else:
            err = compare(got, want)
        t = _timed(kernel, plain)
        row = _row(name, source, replaces, t, n_ops, n_bytes, device_name,
                   err, t_gemm, tensor_ops=n_tensor, tensor="tf32")
        row["kernel_route"] = kroute
        rows.append(row)
        _print_row(row, t, f"I={n_i} J={n_j} D={d}", n_ops + n_tensor,
                   n_bytes, f"torch.matmul(xi, xj.T); {kroute} route,")
    # The sm90 train pass on the same rows gathered beforehand, as
    # train_pass_cuda takes them: the price of reading by index.
    contiguous = [device_ms(lambda: block.train_pass_cuda(xi, xj, aj, yi,
                                                          loss="hinge"))
                  for _ in range(2)]
    train = next(r for r in rows if r["name"] == "train_pass")
    print(f"[times] train_pass sm90 route on the rows gathered beforehand "
          f"(train_pass_cuda, contiguous): device "
          f"{statistics.mean(contiguous):.4f} ms ({contiguous[0]:.4f}, "
          f"{contiguous[1]:.4f}) against {train['ms']:.4f} ms by index; "
          f"the fp32 route (csrc/dsekl_train.cu) at the same shape "
          f"{rows[-1]['ms']:.4f} ms = "
          f"{rows[-1]['ms'] / train['ms']:.2f}x the sm90 kernel")
    return rows


def _serve_inputs(res):
    """One serve call's operands: a query block and the padded support."""
    from repro_torch.core.dsekl import truncate
    from repro_torch.kernels.dsekl import ops
    eng = res["engine"]
    a_sv, x_sv = truncate(res["alpha"], res["x_train"])
    x_sv = ops.pad_rows_to_block(x_sv, eng.sv_block).contiguous()
    a_sv = ops.pad_rows_to_block(a_sv, eng.sv_block).contiguous()
    check(x_sv.shape[0] == eng.n_sv_padded, "support geometry mismatch")
    xq = res["queries"][:eng.engine_cfg.query_block].to(DEVICE).contiguous()
    return xq, x_sv, a_sv, dict(eng.cfg.kernel_params)


def _matvec_work(n_i: int, n_j: int, d: int):
    """(products, other operations, bytes) of one RBF matvec: the cross
    term's products; the row norms and the epilogue per (i, j):
    |x|^2+|z|^2-2xz, clamp, scale, exp, *a, +."""
    return (2 * n_i * n_j * d, 2 * d * (n_i + n_j) + 8 * n_i * n_j,
            4 * (n_i * d + n_j * d + n_j + n_i))


def phase_times(res, device_name: str):
    """Row 1 at the serve call's shape on the sm90 route (its bound: the
    products at the TF32 tensor peak, the rest at fp32), the fp32 and TF32
    cross-term GEMMs as yardsticks, then the fp32 route at the same shape
    on a line of its own."""
    import torch
    from repro_torch.kernels.dsekl import block
    xq, x_sv, a_sv, params = _serve_inputs(res)
    n_i, d = xq.shape
    n_j = x_sv.shape[0]
    check(block.select_matvec_route("rbf", d) == "sm90",
          "the serve shape does not take the sm90 route")

    def kernel():
        return block.kernel_matvec_cuda(xq, x_sv, a_sv, kernel_name="rbf",
                                        params=params)

    def plain():
        return block.kernel_matvec_plain(xq, x_sv, a_sv, kernel_name="rbf",
                                         params=params)

    def gemm():
        return torch.matmul(xq, x_sv.T)

    torch.backends.cuda.matmul.allow_tf32 = False
    before = block.kernel_matvec_cuda.launches_by_route["sm90"]
    got = kernel()
    check(block.kernel_matvec_cuda.launches_by_route["sm90"] == before + 1,
          "the serve shape's launch missed the sm90 route")
    want = plain()
    err = compare(got, want)
    t = _timed(kernel, plain)
    t_gemm = device_ms(gemm)
    torch.backends.cuda.matmul.allow_tf32 = True      # the TF32 yardstick
    try:
        t_gemm_tf32 = statistics.mean([device_ms(gemm), device_ms(gemm)])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    products, ops_count, bytes_count = _matvec_work(n_i, n_j, d)
    row = _row("kernel_matvec",
               "src/repro_torch/kernels/dsekl/csrc/dsekl_matvec_sm90.cu",
               "src/repro/kernels/dsekl/block.py:252", t, ops_count,
               bytes_count, device_name, err, t_gemm, tensor_ops=products,
               tensor="tf32")
    row["matvec_route"] = "sm90"
    row["gemm_tf32_ms"] = t_gemm_tf32
    _print_row(row, t, f"I={n_i} J={n_j} D={d}", products + ops_count,
               bytes_count, "torch.matmul(xq, x_sv.T), fp32,")
    print(f"[times] kernel_matvec sm90 route: "
          f"{row['bound_ms'] / row['ms']:.1%} of its bound ({products:.3e} TF32 tensor-core products + "
          f"{ops_count:.3e} fp32 ops; the split's 3x products not counted); "
          f"the TF32 GEMM yardstick (torch.matmul, allow_tf32, one product "
          f"and the (I, J) output written) device {t_gemm_tf32:.4f} ms; the "
          f"kernel {row['ms'] / t_gemm:.3f}x the fp32 GEMM, "
          f"{row['ms'] / t_gemm_tf32:.3f}x the TF32 one")
    # The fp32 route at the same shape, against the same plain answer.
    lib32 = block._lib("fp32")
    kind, p = block.KINDS["rbf"], block.tile_params("rbf", params)

    def kernel32():
        return block.launch_matvec(lib32, "fp32", xq, x_sv, a_sv, kind, p)

    err32 = compare(kernel32(), want)
    t32 = [device_ms(kernel32), device_ms(kernel32)]
    peak = peaks(device_name)
    bound32 = max((products + ops_count) / peak["fp32"],
                  bytes_count / peak["bytes"]) * 1e3
    print(f"[times] kernel_matvec fp32 route, the same shape "
          f"(csrc/dsekl_matvec.cu): device {statistics.mean(t32):.4f} ms "
          f"({t32[0]:.4f}, {t32[1]:.4f}); bound {bound32:.4f} ms (all "
          f"{products + ops_count:.3e} operations at the fp32 peak) = "
          f"{bound32 / statistics.mean(t32):.1%}; vs plain: max abs err "
          f"{err32:.3e}; sm90 is {statistics.mean(t32) / row['ms']:.2f}x "
          "faster")
    row["fp32_route_ms"] = statistics.mean(t32)
    row["kernel_route"] = "sm90"
    row32 = _route_row(
        "kernel_matvec_fp32", "src/repro_torch/kernels/dsekl/csrc/"
        "dsekl_matvec.cu", "src/repro/kernels/dsekl/block.py:252",
        statistics.mean(t32), row["plain_ms"],
        (products + ops_count) / peak["fp32"] * 1e3,
        bytes_count / peak["bytes"] * 1e3, err32)
    print("[times] clocks.sm,power.draw,power.limit,temperature.gpu: "
          + nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu"))
    return [row, row32]


def phase_rbf_times(res, device_name: str):
    """Row 5: ``rbf_block.rbf_matvec``, the RBF delegation, at the serving
    shape.  It launches the matvec kernel (counted there) and has no
    caller on any main path, so its ``launches`` are 0."""
    import torch
    from repro_torch.kernels.dsekl import block, rbf_block
    xq, x_sv, a_sv, params = _serve_inputs(res)
    gamma = params["gamma"]

    def kernel():
        return rbf_block.rbf_matvec(xq, x_sv, a_sv, gamma=gamma)

    def plain():
        return block.kernel_matvec_plain(xq, x_sv, a_sv, kernel_name="rbf",
                                         params=params)

    err = compare(kernel(), plain())
    t = _timed(kernel, plain)
    route = block.select_matvec_route("rbf", xq.shape[1])
    products, ops_count, bytes_count = _matvec_work(
        xq.shape[0], x_sv.shape[0], xq.shape[1])
    row = _row("rbf_matvec",
               "src/repro_torch/kernels/dsekl/rbf_block.py",
               "src/repro/kernels/dsekl/rbf_block.py:26", t, ops_count,
               bytes_count, device_name, err,
               device_ms(lambda: torch.matmul(xq, x_sv.T)),
               tensor_ops=products, tensor="tf32")
    row["matvec_route"] = row["kernel_route"] = route
    _print_row(row, t, f"I={xq.shape[0]} J={x_sv.shape[0]} D={xq.shape[1]}",
               products + ops_count, bytes_count,
               f"torch.matmul(xq, x_sv.T) ({route} route)")
    return row


# ---------------------------------------------------------------------------
# The LM serving slice: flash attention and the SSD scan.
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # (b, s, t, h, kv, d, causal, window)
    (2, 256, 256, 32, 8, 128, True, 1 << 30),    # jamba's GQA 32/8, D 128
    (2, 256, 256, 4, 1, 64, False, 1 << 30),     # 4/1, non-causal, D 64
    (1, 256, 256, 8, 2, 64, True, 64),           # sliding window 64
    (2, 200, 200, 32, 8, 128, True, 1 << 30),    # ragged S
    (1, 200, 333, 4, 1, 64, False, 64),          # ragged S != T
    (1, 130, 130, 4, 2, 128, True, 0),           # window 0: mean(v)
]
# Lengths at the edges of the sm90 kernel's 128-row tiles: causal S = T at
# jamba's GQA 32/8, D 128, and non-causal S != T at 4/1, D 64.
FLASH_EDGE_CASES = [c for n in (127, 128, 129, 255, 257) for c in (
    (1, n, n, 32, 8, 128, True, 1 << 30), (1, n, n + 3, 4, 1, 64, False,
                                           1 << 30))]
# bf16 at a head dim the sm90 kernel does not take: the fp32 route.
FLASH_FP32_BF16_CASE = (1, 130, 130, 4, 2, 48, False, 0)
FLASH_TOL = 2e-6                    # float32, tests/test_kernels_models.py
# bfloat16 inputs are converted to float32 at load, so a kernel given them
# is held against its plain version on the same values in float32: the
# output differs by one bfloat16 rounding (rtol 8e-3) and float32
# summation order (flash: atol 1e-5 x max(1, |want|_inf), five times its
# float32 tolerance; SSD: its own SSD_ATOL).
BF16_RTOL, FLASH_BF16_ATOL = 8e-3, 1e-5
SSD_CASES = [
    # (b, s, nh, hd, g, n, chunk)
    (2, 512, 16, 64, 1, 16, 256),                # jamba's n, chunk 256
    (1, 600, 8, 64, 1, 128, 128),                # mamba2's n, ragged S
    (2, 300, 8, 64, 2, 16, 256),                 # one partial chunk, g 2
    (1, 1000, 4, 64, 1, 128, 256),               # ragged last chunk
]
# bf16 cases of the SSD's sm90 route: lengths at the chunk's edges, g 2,
# and a fast decay (dt x 10: exp(cum) underflows within a chunk).
SSD_SM90_CASES = [
    # (b, s, nh, hd, g, n, chunk, dt_scale)
    (2, 255, 16, 64, 1, 16, 256, 1.0),
    (2, 257, 16, 64, 1, 16, 256, 1.0),
    (1, 1000, 8, 64, 2, 16, 128, 1.0),
    (1, 600, 8, 64, 1, 128, 128, 1.0),
    (1, 1000, 4, 64, 1, 128, 256, 1.0),
    (1, 520, 8, 64, 1, 16, 256, 10.0),
]
SSD_RTOL, SSD_ATOL = 1e-4, 1e-4                  # x max(1, |want|_inf)
# The main path: jamba-v0.1-52b at full width, cut to one period of 8
# layers (7 mamba, 1 attention; 4 MoE and 4 dense FFNs), bf16, 4 prompts of
# 2,048 tokens, 32 greedy tokens each.
JAMBA = dict(batch=4, prompt_len=2048, new_tokens=32, cache_len=2080,
             seed=0)
JAMBA_LAYERS = 8
LOGITS_TOL = 2e-2                                # x max|ref|, bf16 model
# The kernels' shapes on the main path: the attention layer's prefill
# (B, S, H, Kv, D) and a mamba layer's scan (B, S, nh, hd, g, n, chunk).
FLASH_SERVED = (4, 2048, 32, 8, 128)
SSD_SERVED = (4, 2048, 128, 64, 1, 16, 256)


def _rand(shape, gen, device, dtype):
    import torch
    return torch.randn(shape, generator=gen).to(device=device, dtype=dtype)


def _flash_inputs(case, dtype, seed=0):
    import torch
    b, s, t, h, kv, d = case[:6]
    gen = torch.Generator().manual_seed(seed + s + t + h + d)
    return [_rand(sh, gen, DEVICE, dtype)
            for sh in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d))]


def _ssd_inputs(case, dtype, seed=0, dt_scale=1.0):
    import torch
    b, s, nh, hd, g, n = case[:6]
    gen = torch.Generator().manual_seed(seed + sum(case))
    x = _rand((b, s, nh, hd), gen, DEVICE, dtype)
    dt = (torch.nn.functional.softplus(torch.randn((b, s, nh), generator=gen))
          * dt_scale).to(DEVICE, dtype)
    a = -torch.exp(torch.randn((nh,), generator=gen) * 0.5).to(DEVICE)
    bm = _rand((b, s, g, n), gen, DEVICE, dtype)
    cm = _rand((b, s, g, n), gen, DEVICE, dtype)
    return x, dt, a, bm, cm


def phase_lm_parity():
    """Flash attention and the SSD scan vs their plain versions."""
    import torch
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.ssd import ssd_chunked
    worst = {}
    runs = [(dtype, case) for dtype in (torch.float32, torch.bfloat16)
            for case in FLASH_CASES + FLASH_EDGE_CASES]
    runs.append((torch.bfloat16, FLASH_FP32_BF16_CASE))
    for dtype, case in runs:
        q, k, v = _flash_inputs(case, dtype)
        kw = dict(causal=case[6], window=case[7])
        route = fk.select_route(dtype, case[5], case[3], case[4])
        check(route == ("sm90" if dtype == torch.bfloat16 and case[5] in
                        (64, 128) else "fp32"), f"flash {case}: route {route}")
        by_route = dict(fk.flash_attention_cuda.launches_by_route)
        got = _counted(lambda: fk.flash_attention_cuda(q, k, v, **kw),
                       fk.flash_attention_cuda, f"flash {case}")
        by_route[route] += 1
        check(fk.flash_attention_cuda.launches_by_route == by_route,
              f"flash {case}: not launched on the {route} route")
        check(got.dtype == dtype, f"flash output is {got.dtype}")
        again = fk.flash_attention_cuda(q, k, v, **kw)
        check(torch.equal(again, got), f"flash {case}: two runs differ")
        want = flash_attention(q.float(), k.float(), v.float(),
                               impl="ref", **kw)
        rtol, atol = ((BF16_RTOL, FLASH_BF16_ATOL) if dtype == torch.bfloat16
                      else (FLASH_TOL, FLASH_TOL))
        err = compare(got.float(), want, rtol, atol)
        key = f"flash {str(dtype)[6:]} {route}"
        worst[key] = max(worst.get(key, 0.0), err)
    ssd_runs = ([(torch.float32, case + (1.0,)) for case in SSD_CASES]
                + [(torch.bfloat16, case) for case in SSD_SM90_CASES])
    for dtype, case in ssd_runs:
        x, dt, a, bm, cm = _ssd_inputs(case[:7], dtype,
                                       dt_scale=case[7])
        chunk = case[6]
        route = sk.select_route(dtype, case[3], case[5], chunk)
        check(route == ("sm90" if dtype == torch.bfloat16 else "fp32"),
              f"ssd {case} {dtype}: route {route}")
        by_route = dict(sk.ssd_cuda.launches_by_route)
        got = _counted(lambda: sk.ssd_cuda(x, dt, a, bm, cm, chunk=chunk),
                       sk.ssd_cuda, f"ssd {case}")
        by_route[route] += 1
        check(sk.ssd_cuda.launches_by_route == by_route,
              f"ssd {case}: not launched on the {route} route")
        again = sk.ssd_cuda(x, dt, a, bm, cm, chunk=chunk)
        check(all(torch.equal(u, v) for u, v in zip(got, again)),
              f"ssd {case}: two runs differ")
        want = ssd_chunked(x.float(), dt.float(), a, bm.float(), cm.float(),
                           chunk=chunk, impl="ref")
        key = f"ssd {str(dtype)[6:]} {route}"
        for g, w, rtol in zip(got, want, (
                BF16_RTOL if dtype == torch.bfloat16 else SSD_RTOL,
                SSD_RTOL)):
            err = compare(g.float(), w, rtol, SSD_ATOL)
            worst[key] = max(worst.get(key, 0.0),
                             err / max(1.0, float(w.abs().max())))
    print(f"[lm-parity] {len(FLASH_CASES) + len(FLASH_EDGE_CASES)} flash "
          f"cases x 2 dtypes + 1 bf16 case at D 48, {len(SSD_CASES)} ssd "
          f"cases in float32 + {len(SSD_SM90_CASES)} in bfloat16; routes by "
          f"launches flash {fk.flash_attention_cuda.launches_by_route}, ssd "
          f"{sk.ssd_cuda.launches_by_route}; worst max abs err: "
          + ", ".join(f"{k} {e:.3e}" for k, e in worst.items())
          + " (ssd: / max(1, |want|_inf); bf16 y at rtol "
          f"{BF16_RTOL}, the final state at {SSD_RTOL})")


def _greedy(engine, tokens, n_new, frontend=None):
    """(prefill logits, greedy tokens (B, n_new)) with the engine's model
    as it is set up (impl)."""
    import torch
    logits, cache = engine.prefill(tokens, frontend)
    out = [torch.argmax(logits, dim=-1)]
    for i in range(n_new - 1):
        step, cache = engine.decode_step(out[-1], cache,
                                         tokens.shape[1] + i)
        out.append(torch.argmax(step, dim=-1))
    return logits, torch.stack(out, dim=1)


def _recorder(module, name: str, store: list, per_prefill: int):
    """Wrap the op ``module.name`` at a model's call site so that each call
    keeps its arguments and output in ``store``, which holds one prefill's
    ``per_prefill`` calls (the last); returns the undo."""
    op = getattr(module, name)

    def recorded(*args, **kw):
        out = op(*args, **kw)
        if len(store) == per_prefill:
            store.clear()
        store.append((args, kw, out))
        return out

    setattr(module, name, recorded)
    return lambda: setattr(module, name, op)


def _held_bytes(calls) -> int:
    """Device bytes that the recorded calls keep alive (storages, once)."""
    import torch
    seen = {}
    for args, _, out in calls:
        outs = out if isinstance(out, tuple) else (out,)
        for t in (*args, *outs):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def _hold_main_path(flash_calls, ssd_calls, tag: str = "serve-jamba",
                    what: str = "the timed prefill's") -> None:
    """Each recorded launch of the main path against its plain version on
    the activations it was given, in float32: bfloat16 outputs at
    BF16_RTOL with atol FLASH_BF16_ATOL (flash) or SSD_ATOL (SSD), float32
    ones and the SSD's final state at the float32 tolerances."""
    import torch
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.ssd import ssd_chunked
    worst = {"flash": 0.0, "ssd y": 0.0, "ssd final": 0.0}
    bf16 = torch.bfloat16
    for args, kw, out in flash_calls:
        q, k, v = (t.float() for t in args)
        want = flash_attention(q, k, v, causal=kw["causal"],
                               window=kw["window"], impl="ref")
        rtol, atol = ((BF16_RTOL, FLASH_BF16_ATOL) if out.dtype == bf16
                      else (FLASH_TOL, FLASH_TOL))
        worst["flash"] = max(worst["flash"],
                             compare(out.float(), want, rtol, atol))
        del q, k, v, want
    for args, kw, (y, final) in ssd_calls:
        x, dt, a, bm, cm = (t.float() for t in args)
        wy, wf = ssd_chunked(x, dt, a, bm, cm, chunk=kw["chunk"],
                             impl="ref")
        rtol = BF16_RTOL if y.dtype == bf16 else SSD_RTOL
        worst["ssd y"] = max(worst["ssd y"],
                             compare(y.float(), wy, rtol, SSD_ATOL))
        worst["ssd final"] = max(worst["ssd final"],
                                 compare(final, wf, SSD_RTOL, SSD_ATOL))
        del x, dt, a, bm, cm, wy, wf
    print(f"[{tag}] {what} {len(flash_calls)} flash and "
          f"{len(ssd_calls)} ssd launches vs their plain versions on the "
          "activations they were given (float32): max abs err "
          + ", ".join(f"{k} {e:.3e}" for k, e in worst.items())
          + f" (bf16 outputs at rtol {BF16_RTOL}, atol x max(1, |want|)"
          f" flash {FLASH_BF16_ATOL}, ssd {SSD_ATOL}; final state "
          f"{SSD_RTOL} / {SSD_ATOL})")


def phase_serve_jamba():
    """The main path: serve_lm on jamba-v0.1-52b at full width."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.launch import serve
    from repro_torch.models import attention, moe, ssm
    cfg = get_config("jamba-v0.1-52b").replace(n_layers=JAMBA_LAYERS)
    n_attn = cfg.layer_pattern.count("attn")
    n_mamba = cfg.layer_pattern.count("mamba")
    # The kernels' inputs and outputs at the model's call sites, kept for
    # the last (timed) prefill: each launch is held against its plain
    # version on the activations it was given.
    flash_calls, ssd_calls = [], []
    undo = [_recorder(attention, "flash_attention", flash_calls, n_attn),
            _recorder(ssm, "ssd_chunked", ssd_calls, n_mamba)]
    fk.flash_attention_cuda.launches = 0          # the main path starts here
    fk.flash_attention_cuda.launches_by_route = dict.fromkeys(fk.ROUTES, 0)
    sk.ssd_cuda.launches = 0
    sk.ssd_cuda.launches_by_route = dict.fromkeys(sk.ROUTES, 0)
    try:
        res = serve.serve_lm(cfg, device=DEVICE, **JAMBA)
    finally:
        for fn in undo:
            fn()
    flash_n = fk.flash_attention_cuda.launches    # ... and ends here
    flash_routes = dict(fk.flash_attention_cuda.launches_by_route)
    ssd_n = sk.ssd_cuda.launches
    ssd_routes = dict(sk.ssd_cuda.launches_by_route)
    model, engine = res["model"], res["engine"]
    out, logits = res["out"], res["logits"]
    n_params = sum(p.numel() for p in model.parameters())
    held = _held_bytes(flash_calls + ssd_calls)
    print(f"[serve-jamba] {cfg.name}: {cfg.n_layers} layers "
          f"({n_mamba} mamba, {n_attn} attn), d_model {cfg.d_model}, "
          f"{n_params:,} parameters in {cfg.param_dtype}; init "
          f"{res['init_s']:.2f}s; peak {res['peak_bytes'] / 2**30:.2f} GiB "
          f"(timed prefill + decode), of which up to {held / 2**30:.2f} GiB"
          " are the kernels' inputs and outputs kept for the check")
    print(f"[serve-jamba] {res['prefills']} prefills (1 warm-up): "
          f"flash launches={flash_n} (by route {flash_routes}), ssd "
          f"launches={ssd_n} (by route {ssd_routes})")
    check(flash_routes["sm90"] == flash_n and flash_n > 0,
          f"the prefill's flash launches did not all take the sm90 route: "
          f"{flash_routes}")
    check(ssd_routes["sm90"] == ssd_n and ssd_n > 0,
          f"the prefill's ssd launches did not all take the sm90 route: "
          f"{ssd_routes}")
    check(flash_n == n_attn * res["prefills"] and
          ssd_n == n_mamba * res["prefills"],
          f"launches flash {flash_n} ssd {ssd_n}, expected {n_attn} and "
          f"{n_mamba} per prefill, none in decode")
    check(len(flash_calls) == n_attn and len(ssd_calls) == n_mamba,
          f"recorded {len(flash_calls)} flash and {len(ssd_calls)} ssd "
          "calls in the last prefill")
    check(tuple(out.shape) == (JAMBA["batch"], JAMBA["new_tokens"]),
          f"generated {tuple(out.shape)}")
    check(bool(torch.isfinite(logits.float()).all()), "non-finite logits")
    check(int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size,
          "token ids out of range")
    print(f"[serve-jamba] prefill {res['prefill_s'] * 1e3:.3f} ms = "
          f"{res['prefill_tokens_per_s']:.1f} tokens/s; decode "
          f"{res['decode_ms_per_step']:.4f} ms/step = "
          f"{res['decode_tokens_per_s']:.2f} tokens/s (host clock, each "
          "ending in a device synchronisation; warm-up excluded)")
    _hold_main_path(flash_calls, ssd_calls)
    del flash_calls, ssd_calls
    # A second gate: the same model's prefill with the plain versions.  Both
    # runs record each MoE layer's top-k expert sets, to count the tokens
    # routed elsewhere (a near-tie in the router flips on a rounding
    # difference, and the token's FFN output changes wholesale).
    routes = []
    moe_forward = moe.moe_forward

    def recording(p, c, x, **kw):
        logits = x.reshape(-1, x.shape[-1]).float() @ p.router.float()
        routes.append(torch.topk(logits, c.top_k, dim=-1)[1].sort(-1)[0])
        return moe_forward(p, c, x, **kw)

    moe.moe_forward = recording
    try:
        again, _ = engine.prefill(res["tokens"])
        n_moe = len(routes)
        t0 = time.perf_counter()
        model.impl = "ref"
        ref_logits, ref_out = _greedy(engine, res["tokens"],
                                      JAMBA["new_tokens"])
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
    finally:
        moe.moe_forward = moe_forward
        model.impl = "auto"
    rerouted = [int((c != r).any(-1).sum())
                for c, r in zip(routes[:n_moe], routes[n_moe:2 * n_moe])]
    scale = float(ref_logits.float().abs().max())
    err = float((logits.float() - ref_logits.float()).abs().max())
    agree = float((out == ref_out).float().mean())
    first = float((out[:, 0] == ref_out[:, 0]).float().mean())
    print(f"[serve-jamba] cuda vs ref prefill logits: max abs err {err:.4e} "
          f"(tolerance {LOGITS_TOL} x max|ref| = {LOGITS_TOL * scale:.4e}); "
          f"greedy tokens agree {agree:.1%} (first token {first:.0%}); "
          f"tokens routed to another expert set, per MoE layer, of "
          f"{out.shape[0] * res['tokens'].shape[1]}: {rerouted}; a second "
          f"cuda prefill differs by {float((again - logits).abs().max()):.1e};"
          f" ref generate {ref_s:.2f}s")
    check(err <= LOGITS_TOL * scale, "cuda and ref prefill logits differ")
    _profile_serve(engine, res["tokens"])
    return {"flash": flash_n, "ssd": ssd_n, "res": res}


def _profile_serve(engine, tokens, tag: str = "profile-jamba",
                   steps: int = 8, frontend=None):
    """torch.profiler over one prefill, then over ``steps`` decode steps:
    wall, device busy, and device time by kernel (the ten largest and the
    port's own)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    s = tokens.shape[1]
    for what in ("prefill", "decode"):
        logits, cache = engine.prefill(tokens, frontend)
        tok = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if what == "prefill":
                engine.prefill(tokens, frontend)
            else:
                for i in range(steps):
                    step, cache = engine.decode_step(tok, cache, s + i)
                    tok = torch.argmax(step, dim=-1)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = _device_rows(prof)
        total = sum(r[0] for r in rows) / 1e3
        per = 1 if what == "prefill" else steps
        print(f"[{tag}] {what} ({per} call{'s' * (per > 1)}): wall "
              f"{wall:.3f} ms (profiler on), device busy {total:.3f} ms = "
              f"{total / wall:.1%} of the wall; {len(rows)} kernel names")
        # The ten largest, and wherever they rank those in a top-level
        # anonymous namespace (the port's kernels and a few of PyTorch's)
        # and the scans (the MoE dispatch's cumsum).
        for rank, (dev_us, key, count) in enumerate(rows):
            if rank < 10 or key.startswith(("void (anonymous namespace)::",
                                            "(anonymous namespace)::")) or (
                    "scan" in key.lower()):
                print(f"[{tag}]   {dev_us / 1e3 / per:9.3f} ms/call "
                      f"{count // per:5d}x {key[:90]}")


def _pairs(s: int, t: int, causal: bool, window: int) -> int:
    """(query, key) pairs the flash mask keeps."""
    total = 0
    for q in range(s):
        lo = max(0, q - window + 1)
        hi = min(q, t - 1) if causal else t - 1
        total += max(0, hi - lo + 1)
    return total


def _ssd_ops(s: int, chunk: int, n: int, hd: int):
    """(tensor-core products, fp32 operations) of the chunked scan for one
    (b, h).  Products: per chunk of L the intra pairs j <= i (the C.B dot
    and the score times the x dt row), per position the inter product
    C.state and its absorption into the state.  fp32: per pair the decay
    (subtract, exp, multiply), per position x dt, the sum of intra and
    inter and the cumsum, per chunk the state's decay."""
    tensor = fp32 = 0
    for c0 in range(0, s, chunk):
        ln = min(chunk, s - c0)
        pairs = ln * (ln + 1) // 2
        tensor += pairs * (2 * n + 2 * hd) + ln * 4 * n * hd
        fp32 += pairs * 3 + ln * (2 * hd + 4) + n * hd
    return tensor, fp32


def phase_lm_times(device_name: str):
    """Flash and SSD at the served shapes: device time per call
    (``device_ms``), one call by CUDA events, the plain version's device
    time, the bound, and (flash) SDPA on the same bf16 values; then each
    kernel's fp32 route at the same shape in float32."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.ssd import ssd_chunked
    rows = []
    # Flash at the served shape, causal, bf16: the sm90 route.
    b, s, h, kv, d = FLASH_SERVED
    q, k, v = _flash_inputs((b, s, s, h, kv, d), torch.bfloat16, seed=11)
    check(fk.select_route(q.dtype, d, h, kv) == "sm90",
          "the served shape does not take the sm90 route")

    def kernel():
        return fk.flash_attention_cuda(q, k, v, causal=True)

    def plain():
        return flash_attention(q, k, v, causal=True, impl="ref")

    sm90_before = fk.flash_attention_cuda.launches_by_route["sm90"]
    got = kernel()
    check(fk.flash_attention_cuda.launches_by_route["sm90"] ==
          sm90_before + 1, "the served shape's launch missed the sm90 route")
    err = compare(got.float(), flash_attention(
        q.float(), k.float(), v.float(), causal=True, impl="ref"),
        BF16_RTOL, FLASH_BF16_ATOL)
    t = {"plain": [device_ms(plain, reps=5)], "kernel": [device_ms(kernel)]}
    t["kernel"].append(device_ms(kernel))
    t["plain"].append(device_ms(plain, reps=5))
    t["kernel_wall"], t["plain_wall"] = time_ms(kernel), time_ms(plain, 5)
    # SDPA on the same values, kv heads expanded beforehand, (B, H, S, D).
    qt = q.transpose(1, 2).contiguous()
    kt = torch.repeat_interleave(k, h // kv, dim=2).transpose(1, 2).contiguous()
    vt = torch.repeat_interleave(v, h // kv, dim=2).transpose(1, 2).contiguous()

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    lib_err = float((library().transpose(1, 2).float() - got.float())
                    .abs().max())
    lib_ms = statistics.mean([device_ms(library), device_ms(library)])
    # Per kept (query, key) pair: QK^T and PV, 4D products of bf16 values
    # on the tensor cores; scale, max-subtract and exp, 3 in fp32.
    pairs = _pairs(s, s, True, 1 << 30) * b * h
    n_tensor, n_ops = pairs * 4 * d, pairs * 3
    n_bytes = 2 * (2 * b * s * h * d + 2 * b * s * kv * d)
    rows.append(_row(
        "flash_attention", "src/repro_torch/kernels/flash_attn/csrc/"
        "flash_attn_sm90.cu", "src/repro/kernels/flash_attn/kernel.py:72",
        t, n_ops, n_bytes, device_name, err, library=lib_ms,
        tensor_ops=n_tensor))
    row = rows[-1]
    print(f"[times] flash_attention sm90 route, B={b} H={h} Kv={kv} S=T={s} "
          f"D={d} causal bf16: device {row['ms']:.4f} ms "
          f"({t['kernel'][0]:.4f}, {t['kernel'][1]:.4f}) = "
          f"{row['bound_ms'] / row['ms']:.1%} of the bound; by events "
          f"{row['wall_ms']:.4f} ms; plain device {row['plain_ms']:.4f} ms; "
          f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
          f"{n_tensor:.3e} bf16 tensor ops + {n_ops:.3e} fp32 ops, "
          f"{n_bytes:.3e} B; the P split's extra 2D products a pair not "
          f"counted); SDPA device {lib_ms:.4f} ms = "
          f"{row['bound_ms'] / lib_ms:.1%} of the bound, the kernel "
          f"{row['ms'] / lib_ms:.2f}x SDPA (max abs diff to the kernel "
          f"{lib_err:.3e}); vs plain on float32 values: max abs err "
          f"{err:.3e}")
    del qt, kt, vt, got
    # The fp32 route at the same shape in float32, at the float32
    # tolerance, against its plain version.
    q32, k32, v32 = (x.float() for x in (q, k, v))
    del q, k, v

    def kernel32():
        return fk.flash_attention_cuda(q32, k32, v32, causal=True)

    def plain32():
        return flash_attention(q32, k32, v32, causal=True, impl="ref")

    fp32_before = fk.flash_attention_cuda.launches_by_route["fp32"]
    err32 = compare(kernel32(), plain32(), FLASH_TOL, FLASH_TOL)
    check(fk.flash_attention_cuda.launches_by_route["fp32"] ==
          fp32_before + 1, "the float32 launch missed the fp32 route")
    t32 = [device_ms(kernel32), device_ms(kernel32)]
    p32 = [device_ms(plain32, reps=5), device_ms(plain32, reps=5)]
    peak = peaks(device_name)
    bound32 = max((n_tensor + n_ops) / peak["fp32"],
                  2 * n_bytes / peak["bytes"])
    print(f"[times] flash_attention fp32 route, the same shape in float32 "
          f"(csrc/flash_attn.cu): device {statistics.mean(t32):.4f} ms "
          f"({t32[0]:.4f}, {t32[1]:.4f}); plain device "
          f"{statistics.mean(p32):.4f} ms; bound {bound32 * 1e3:.4f} ms (all "
          f"{n_tensor + n_ops:.3e} operations at the fp32 peak); vs plain: "
          f"max abs err {err32:.3e} (tolerance {FLASH_TOL})")
    rows[-1]["kernel_route"] = "sm90"
    rows.append(_route_row(
        "flash_attention_fp32", "src/repro_torch/kernels/flash_attn/csrc/"
        "flash_attn.cu", "src/repro/kernels/flash_attn/kernel.py:72",
        statistics.mean(t32), statistics.mean(p32),
        (n_tensor + n_ops) / peak["fp32"] * 1e3,
        2 * n_bytes / peak["bytes"] * 1e3, err32))
    del q32, k32, v32
    # SSD at the served shape (B x nh = 512 (b, h) blocks), bf16: the sm90
    # route.
    case = SSD_SERVED
    args = _ssd_inputs(case, torch.bfloat16, seed=12)
    check(sk.select_route(torch.bfloat16, case[3], case[5], case[6]) ==
          "sm90", "the served SSD shape does not take the sm90 route")

    def skernel():
        return sk.ssd_cuda(*args, chunk=case[6])

    def splain():
        return ssd_chunked(*args, chunk=case[6], impl="ref")

    sm90_before = sk.ssd_cuda.launches_by_route["sm90"]
    gy, gf = skernel()
    check(sk.ssd_cuda.launches_by_route["sm90"] == sm90_before + 1,
          "the served SSD launch missed the sm90 route")
    wy, wf = ssd_chunked(*(a.float() for a in args), chunk=case[6],
                         impl="ref")
    err = max(compare(gy.float(), wy, BF16_RTOL, SSD_ATOL),
              compare(gf, wf, SSD_RTOL, SSD_ATOL))
    # The plain version is a loop of ~20,000 launches: one call a reading,
    # paced by the host (``device_ms`` says so).
    t = {"plain": [device_ms(splain, reps=1, warmup=1)],
         "kernel": [device_ms(skernel)]}
    t["kernel"].append(device_ms(skernel))
    t["plain"].append(device_ms(splain, reps=1, warmup=1))
    t["kernel_wall"] = time_ms(skernel)
    t["plain_wall"] = time_ms(splain, reps=2, warmup=0)
    b, s, nh, hd, g, n, chunk = case
    n_tensor, n_ops = (b * nh * x for x in _ssd_ops(s, chunk, n, hd))
    n_bytes = (2 * (2 * b * s * nh * hd + b * s * nh + 2 * b * s * g * n)
               + 4 * nh + 4 * b * nh * hd * n)
    rows.append(_row(
        "ssd", "src/repro_torch/kernels/ssd/csrc/ssd_sm90.cu",
        "src/repro/kernels/ssd/kernel.py:74", t, n_ops, n_bytes,
        device_name, err, tensor_ops=n_tensor))
    row = rows[-1]
    print(f"[times] ssd sm90 route, B*nh={b * nh} S={s} hd={hd} n={n} "
          f"chunk={chunk} bf16: device {row['ms']:.4f} ms "
          f"({t['kernel'][0]:.4f}, {t['kernel'][1]:.4f}) = "
          f"{row['bound_ms'] / row['ms']:.1%} of the bound; by events "
          f"{row['wall_ms']:.4f} ms; plain device {row['plain_ms']:.4f} ms "
          f"(the sequential recurrence); bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}: {n_tensor:.3e} bf16 tensor ops + "
          f"{n_ops:.3e} fp32 ops, {n_bytes:.3e} B; the splits' extra "
          f"products not counted); no single PyTorch call computes it; vs "
          f"plain on float32 values: max abs err {err:.3e}")
    # The fp32 route at the same shape in float32, at the float32
    # tolerance, against its plain version.
    args32 = [t.float() for t in args]
    del args, gy, gf

    def skernel32():
        return sk.ssd_cuda(*args32, chunk=chunk)

    def splain32():
        return ssd_chunked(*args32, chunk=chunk, impl="ref")

    fp32_before = sk.ssd_cuda.launches_by_route["fp32"]
    gy, gf = skernel32()
    check(sk.ssd_cuda.launches_by_route["fp32"] == fp32_before + 1,
          "the float32 SSD launch missed the fp32 route")
    err32 = max(compare(gy, wy, SSD_RTOL, SSD_ATOL),
                compare(gf, wf, SSD_RTOL, SSD_ATOL))
    t32 = [device_ms(skernel32), device_ms(skernel32)]
    p32 = device_ms(splain32, reps=1, warmup=1, readings=1)
    peak = peaks(device_name)
    bytes32 = 2 * n_bytes - 4 * nh - 4 * b * nh * hd * n
    bound32 = max((n_tensor + n_ops) / peak["fp32"], bytes32 / peak["bytes"])
    print(f"[times] ssd fp32 route, the same shape in float32 "
          f"(csrc/ssd.cu): device {statistics.mean(t32):.4f} ms "
          f"({t32[0]:.4f}, {t32[1]:.4f}) = "
          f"{bound32 * 1e3 / statistics.mean(t32):.1%} of its bound; plain "
          f"device {p32:.4f} ms (one reading); bound {bound32 * 1e3:.4f} ms "
          f"(all {n_tensor + n_ops:.3e} operations at the fp32 peak, "
          f"{bytes32:.3e} B); vs plain: max abs err {err32:.3e} (tolerance "
          f"{SSD_RTOL} / {SSD_ATOL} x max(1, |want|_inf))")
    next(r for r in rows if r["name"] == "ssd")["kernel_route"] = "sm90"
    rows.append(_route_row(
        "ssd_fp32", "src/repro_torch/kernels/ssd/csrc/ssd.cu",
        "src/repro/kernels/ssd/kernel.py:74", statistics.mean(t32), p32,
        (n_tensor + n_ops) / peak["fp32"] * 1e3,
        bytes32 / peak["bytes"] * 1e3, err32))
    return rows


# ---------------------------------------------------------------------------
# MLA, cross-attention and whisper served at full width: the flash
# kernel's non-causal route on a main path.
# ---------------------------------------------------------------------------

# llama-3.2-vision-11b at its published widths and full depth (40 layers:
# 32 self-attention, GQA 32/8 x 128, and 8 gated cross-attention layers
# over 1,601 image-patch embeddings), bf16, 4 prompts of 2,048 tokens.
LLAMA_V = dict(batch=4, prompt_len=2048, new_tokens=32, cache_len=2080,
               seed=0)
# whisper-tiny at full width and depth: 8 x 1,500 frames through the
# 4-layer non-causal encoder, 8 prompts of 448 tokens (the decoder's
# context) through 4 attn_cross blocks (6 heads of 64).
WHISPER = dict(batch=8, prompt_len=448, new_tokens=32, cache_len=480,
               seed=0)
# deepseek-v3-671b at full width (d_model 7,168, 128 MLA heads, q_lora
# 1,536, kv_lora 512, 256 routed experts top-8 + 1 shared), cut to 2 of
# its 61 layers (~11.5B parameters a layer: ~50 GB of bf16 with the
# embedding and the head); 4 prompts of 2,048 tokens.
DEEPSEEK = dict(batch=4, prompt_len=2048, new_tokens=32, cache_len=2080,
                seed=0)
DEEPSEEK_LAYERS = 2
# The absorbed MLA decode of token S against the expanded prefill's
# output for token S, on layer 0's attention alone.  float32 (copies of
# the layer's weights): the same function summed in another order (over
# r_kv 512 and 2,048 keys against 128 + 64 dims a head), held at 1e-4 x
# |expanded|_inf.  bfloat16 (the served weights): each form rounds
# another set of intermediates to bf16 (q W_UK^T, the context c and its
# W_UV against k_nope, v and the per-head output; 2^-9 relative each),
# and both round the probabilities; those errors add to ~1e-2 of the
# output's scale, so 3e-2 x |expanded|_inf.  A wrong scale (sqrt(128)
# for sqrt(192)) or a dropped rope term moves the output by far more;
# the gate also checks that token S - 1's output sits > 10x the limit
# away.
MLA_F32_TOL, MLA_BF16_TOL = 1e-4, 3e-2


def _flash_shape_time(case, device_name: str) -> dict:
    """One flash shape of a main path, timed alone on bf16 values: the
    sm90 kernel's device ms (two ``device_ms`` readings), the plain
    version's, and SDPA's (``enable_gqa=True``, kv heads not expanded,
    (B, H, S, D) made contiguous beforehand); the bound: 4 D bf16
    products a kept (query, key) pair at the tensor peak plus 3 fp32
    operations a pair, against q, k, v read and the output written once.
    The kernel is held against its plain version in float32."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.flash_attn import kernel as fk
    b, s, t, h, kv, d, causal, window = case
    q, k, v = _flash_inputs(case, torch.bfloat16, seed=13)
    check(fk.select_route(q.dtype, d, h, kv) == "sm90",
          f"flash {case}: not on the sm90 route")

    def kernel():
        return fk.flash_attention_cuda(q, k, v, causal=causal,
                                       window=window)

    def plain():
        return flash_attention(q, k, v, causal=causal, window=window,
                               impl="ref")

    before = fk.flash_attention_cuda.launches_by_route["sm90"]
    got = kernel()
    check(fk.flash_attention_cuda.launches_by_route["sm90"] == before + 1,
          f"flash {case}: the launch missed the sm90 route")
    err = compare(got.float(), flash_attention(
        q.float(), k.float(), v.float(), causal=causal, window=window,
        impl="ref"), BF16_RTOL, FLASH_BF16_ATOL)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)

    lib_err = float((library().transpose(1, 2).float() - got.float())
                    .abs().max())
    ms = statistics.mean([device_ms(kernel), device_ms(kernel)])
    lib_ms = statistics.mean([device_ms(library), device_ms(library)])
    plain_ms = device_ms(plain, reps=5)
    pairs = _pairs(s, t, causal, window) * b * h
    n_tensor, n_ops = pairs * 4 * d, pairs * 3
    n_bytes = 2 * (2 * b * s * h * d + 2 * b * t * kv * d)
    peak = peaks(device_name)
    t_ops = (n_ops / peak["fp32"] + n_tensor / peak["bf16"]) * 1e3
    t_bytes = n_bytes / peak["bytes"] * 1e3
    bound = max(t_ops, t_bytes)
    print(f"[times] flash_attention sm90 at B={b} S={s} T={t} H={h} "
          f"Kv={kv} D={d} {'causal' if causal else 'non-causal'}: device "
          f"{ms:.4f} ms = {bound / ms:.1%} of the bound {bound:.4f} ms "
          f"({'operations' if t_ops >= t_bytes else 'bytes'}: "
          f"{n_tensor:.3e} bf16 tensor ops + {n_ops:.3e} fp32, "
          f"{n_bytes:.3e} B); SDPA (enable_gqa) {lib_ms:.4f} ms, the kernel "
          f"{ms / lib_ms:.2f}x SDPA (max abs diff {lib_err:.3e}); plain "
          f"{plain_ms:.4f} ms; vs plain on float32 values max abs err "
          f"{err:.3e}")
    del q, k, v, qt, kt, vt, got
    return {"ms": ms, "bound_ms": bound, "library_ms": lib_ms,
            "plain_ms": plain_ms, "max_abs_err": err}


class _Prepared:
    """While active, every ``LanguageModel`` ``serve_lm`` builds gets
    ``prepare(model)`` right after its weights are drawn; with ``turns``
    the ranks of the world draw their weights one after another (a
    sharded parameter is drawn whole before its slice is kept: four
    ranks drawing deepseek-v3's (256, 7,168, 2,048) experts at once would
    hold ~30 GB more)."""

    def __init__(self, prepare=None, turns: bool = False):
        self.prepare, self.turns = prepare, turns

    def __enter__(self):
        from repro_torch.launch import serve
        base = self._base = serve.LanguageModel
        prepare, turns = self.prepare, self.turns

        class Prepared(base):
            def init(self, generator):
                if turns:
                    import torch.distributed as dist
                    for turn in range(dist.get_world_size()):
                        if turn == dist.get_rank():
                            super().init(generator)
                        dist.barrier()
                else:
                    super().init(generator)
                if prepare is not None:
                    prepare(self)
                return self

        serve.LanguageModel = Prepared
        return self

    def __exit__(self, *exc):
        from repro_torch.launch import serve
        serve.LanguageModel = self._base


def _open_gates(model) -> None:
    import torch
    with torch.no_grad():
        for blk in model.layers:
            if blk.kind == "cross_attn":
                blk.xattn.gate.fill_(1.0)


def _serve_main_path(tag: str, cfg, run: dict, n_flash: int,
                     prepare=None) -> dict:
    """``serve_lm`` on ``cfg`` at ``run``'s sizes, the flash counters set
    to 0 just before and read just after; the timed prefill's ``n_flash``
    launches recorded at the model's call site and each held against its
    plain version on its activations; all on the sm90 route, ``n_flash``
    a prefill and none in decode; then the cuda prefill's logits against
    the ``impl="ref"`` prefill at LOGITS_TOL.  ``prepare(model)`` runs on
    the model as soon as its weights are drawn."""
    import torch
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.launch import serve
    from repro_torch.models import attention
    t_start = time.perf_counter()
    flash_calls = []
    undo = [_recorder(attention, "flash_attention", flash_calls,
                      max(n_flash, 1))]
    fk.flash_attention_cuda.launches = 0          # the main path starts here
    fk.flash_attention_cuda.launches_by_route = dict.fromkeys(fk.ROUTES, 0)
    ssd_before = sk.ssd_cuda.launches
    try:
        with _Prepared(prepare):
            res = serve.serve_lm(cfg, device=DEVICE, **run)
    finally:
        for fn in undo:
            fn()
    flash_n = fk.flash_attention_cuda.launches    # ... and ends here
    routes = dict(fk.flash_attention_cuda.launches_by_route)
    model, engine = res["model"], res["engine"]
    tokens, frontend, out = res["tokens"], res["frontend"], res["out"]
    n_params = sum(p.numel() for p in model.parameters())
    shapes = {}
    for args, kw, _ in flash_calls:
        key = (tuple(args[0].shape), tuple(args[1].shape),
               "causal" if kw["causal"] else "non-causal")
        shapes[key] = shapes.get(key, 0) + 1
    held = _held_bytes(flash_calls)
    kinds = [f"{cfg.layer_pattern.count(k) * cfg.n_periods} {k}"
             for k in dict.fromkeys(cfg.layer_pattern)]
    if cfg.encoder_layers:
        kinds.append(f"encoder {cfg.encoder_layers}")
    fe_shape = ("" if frontend is None
                else f", frontend {tuple(frontend.shape)}")
    print(f"[{tag}] {cfg.name}: {cfg.n_layers} layers ({', '.join(kinds)})"
          f", d_model {cfg.d_model}, {n_params:,} parameters in "
          f"{cfg.param_dtype}; batch {run['batch']} x {run['prompt_len']} "
          f"tokens{fe_shape}"
          f", cache {run['cache_len']}, {run['new_tokens']} greedy tokens; "
          f"init {res['init_s']:.2f}s; peak "
          f"{res['peak_bytes'] / 2**30:.2f} GiB (timed prefill + decode), of "
          f"which up to {held / 2**30:.2f} GiB are the kernels' inputs and "
          "outputs kept for the check")
    print(f"[{tag}] {res['prefills']} prefills (1 warm-up): flash "
          f"launches={flash_n} (by route {routes}); the last prefill's by "
          "(q, k, mask): " + "; ".join(f"{q} x {k} {m}: {n}" for (q, k, m), n
                                       in shapes.items()))
    check(routes["sm90"] == flash_n, f"[{tag}] flash launches off the sm90 "
          f"route: {routes}")
    check(flash_n == n_flash * res["prefills"] and
          len(flash_calls) == (n_flash or len(flash_calls)),
          f"[{tag}] {flash_n} flash launches, expected {n_flash} a prefill "
          f"and none in decode; {len(flash_calls)} recorded")
    check(sk.ssd_cuda.launches == ssd_before, f"[{tag}] an SSD launch")
    check(tuple(out.shape) == (run["batch"], run["new_tokens"]),
          f"[{tag}] generated {tuple(out.shape)}")
    check(bool(torch.isfinite(res["logits"].float()).all()),
          f"[{tag}] non-finite logits")
    check(int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size,
          f"[{tag}] token ids out of range")
    print(f"[{tag}] prefill {res['prefill_s'] * 1e3:.3f} ms = "
          f"{res['prefill_tokens_per_s']:.1f} tokens/s; decode "
          f"{res['decode_ms_per_step']:.4f} ms/step = "
          f"{res['decode_tokens_per_s']:.2f} tokens/s (host clock, each "
          "ending in a device synchronisation; warm-up excluded)")
    if flash_calls:
        _hold_main_path(flash_calls, [], tag)
    del flash_calls
    logits = res["logits"]
    again, _ = engine.prefill(tokens, frontend)
    t0 = time.perf_counter()
    model.impl = "ref"
    try:
        ref_logits, ref_out = _greedy(engine, tokens, run["new_tokens"],
                                      frontend)
        torch.cuda.synchronize()
    finally:
        model.impl = "auto"
    ref_s = time.perf_counter() - t0
    scale = float(ref_logits.float().abs().max())
    err = float((logits.float() - ref_logits.float()).abs().max())
    agree = float((out == ref_out).float().mean())
    print(f"[{tag}] cuda vs ref prefill logits: max abs err {err:.4e} "
          f"(tolerance {LOGITS_TOL} x max|ref| = {LOGITS_TOL * scale:.4e}); "
          f"greedy tokens agree {agree:.1%} (first token "
          f"{float((out[:, 0] == ref_out[:, 0]).float().mean()):.0%}); a "
          f"second cuda prefill differs by "
          f"{float((again - logits).abs().max()):.1e}; ref generate "
          f"{ref_s:.2f}s")
    check(err <= LOGITS_TOL * scale, f"[{tag}] cuda and ref prefill logits "
          "differ")
    _profile_serve(engine, tokens, "profile-" + tag[len("serve-"):],
                   frontend=frontend)
    return {"flash": flash_n, "res": res, "shapes": shapes,
            "seconds": time.perf_counter() - t_start}


def _release(res) -> None:
    import gc

    import torch
    res.clear()
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve_llama_vision(device_name: str):
    """llama-3.2-vision-11b served at full width and depth: 32 causal
    flash launches a prefill at (4, 2,048, 32/8, 128) and 8 non-causal ones
    at S 2,048 against T 1,601 (the cross layers).  The gates are set to
    1.0: at 0 (the init) tanh(0) would switch every cross layer off."""
    from repro_torch.configs import get_config
    cfg = get_config("llama-3.2-vision-11b")
    n_cross = cfg.layer_pattern.count("cross_attn") * cfg.n_periods
    print(f"[serve-llama-vision] the {n_cross} cross layers' gates set to "
          "1.0 after the seeded init (0 there: tanh(0) = 0 would switch "
          "them off)")
    out = _serve_main_path("serve-llama-vision", cfg, LLAMA_V, cfg.n_layers,
                           prepare=_open_gates)
    non_causal = sum(n for (_, _, m), n in out["shapes"].items()
                     if m == "non-causal")
    check(non_causal == n_cross, f"[serve-llama-vision] {non_causal} "
          f"non-causal launches a prefill, expected {n_cross}")
    b, s = LLAMA_V["batch"], LLAMA_V["prompt_len"]
    hd = cfg.resolved_head_dim
    cross = (b, s, cfg.n_frontend_tokens, cfg.n_heads, cfg.n_kv_heads, hd,
             False, 1 << 30)
    _release(out.pop("res"))
    times = {"serve-llama-vision cross (B %d, S %d, T %d, H %d, Kv %d, D "
             "%d, non-causal)" % cross[:6]: dict(
                 _flash_shape_time(cross, device_name),
                 launches_per_prefill=n_cross)}
    print(f"[serve-llama-vision] {out['seconds']:.1f}s")
    return dict(out, times=times)


def phase_serve_whisper(device_name: str):
    """whisper-tiny served at full width and depth: 12 flash launches a
    prefill at D 64, all sm90: 4 encoder (non-causal, S = T = 1,500), 4
    decoder self-attention (causal, 448) and 4 cross-attention (S 448
    against T 1,500)."""
    from repro_torch.configs import get_config
    cfg = get_config("whisper-tiny")
    n = cfg.encoder_layers + 2 * cfg.n_layers
    out = _serve_main_path("serve-whisper", cfg, WHISPER, n)
    non_causal = sum(c for (_, _, m), c in out["shapes"].items()
                     if m == "non-causal")
    check(non_causal == cfg.encoder_layers + cfg.n_layers,
          f"[serve-whisper] {non_causal} non-causal launches a prefill")
    b, s, t = WHISPER["batch"], WHISPER["prompt_len"], cfg.n_frontend_tokens
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    _release(out.pop("res"))
    times = {}
    for what, case, per in (
            ("encoder", (b, t, t, h, kv, hd, False, 1 << 30),
             cfg.encoder_layers),
            ("cross", (b, s, t, h, kv, hd, False, 1 << 30), cfg.n_layers)):
        times["serve-whisper %s (B %d, S %d, T %d, H %d, Kv %d, D %d, "
              "non-causal)" % ((what,) + case[:6])] = dict(
            _flash_shape_time(case, device_name), launches_per_prefill=per)
    print(f"[serve-whisper] {out['seconds']:.1f}s")
    return dict(out, times=times)


def _mla_decode_gate(model, tokens) -> dict:
    """Layer 0's attention at full width: ``mla_decode`` of token S after
    ``mla_prefill`` of tokens 0..S-1 against ``mla_prefill`` of tokens
    0..S at token S, on the model's input to that attention (its embedded,
    normed prompts), in bf16 and on float32 copies of the weights (on a
    mesh, this rank's slices and heads; the batch whole)."""
    import torch
    from repro_torch.models import attention, layers
    from repro_torch.nn.module import ParamTree
    cfg, blk = model.cfg, model.layers[0]
    s = tokens.shape[1] - 1
    pos = torch.arange(s + 1, dtype=torch.int32, device=tokens.device)
    p32 = ParamTree(attention.mla_specs(cfg), dtype=torch.float32,
                    device=tokens.device, ctx=blk.ctx)
    p32.load_state_dict({k: v.float() for k, v in
                         blk.attn.state_dict().items()})
    p32, p16 = p32.view(), blk.attn.view()
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    out = {}
    with torch.no_grad():
        h = layers.rmsnorm(blk.ln_attn.view(), layers.embed(
            model.embed.view(), cfg, tokens), cfg.norm_eps)
        for name, c, p, x, tol in (("bf16", cfg, p16, h, MLA_BF16_TOL),
                                   ("f32", cfg32, p32, h.float(),
                                    MLA_F32_TOL)):
            _, cache = attention.mla_prefill(p, c, x[:, :s], pos[:s],
                                             cache_len=s + 1)
            got, _ = attention.mla_decode(p, c, x[:, s:], cache, s)
            want, _ = attention.mla_prefill(p, c, x, pos, cache_len=s + 1)
            got, prev, want = (got[:, 0].float(), want[:, s - 1].float(),
                               want[:, s].float())
            top = float(want.abs().max())
            err = compare(got, want, rtol=0.0, atol=tol, floor=False)
            away = float((prev - want).abs().max())
            check(away > 10 * tol * top, f"the MLA gate cannot bite: token "
                  f"S - 1 is {away:.3e} from token S, limit {tol * top:.3e}")
            out[name] = (err, tol * top, away)
            del cache, want
    return out


def phase_serve_deepseek():
    """deepseek-v3-671b at full width, cut to 2 layers: MLA and the MoE on
    the main path, no flash launch (MLA's prefill runs ``mha_full``, as
    JAX's does: qk 192 against v 128 takes no flash route); then the
    absorbed decode gate on layer 0's attention."""
    import torch
    from repro_torch.configs import get_config
    full = get_config("deepseek-v3-671b")
    cfg = full.replace(n_layers=DEEPSEEK_LAYERS)
    run = dict(DEEPSEEK)
    per_layer = (cfg.param_count_estimate()
                 - 2 * cfg.vocab_size * cfg.d_model) // cfg.n_layers
    print(f"[serve-deepseek] cut to {cfg.n_layers} of {full.n_layers} "
          f"layers: {per_layer / 1e9:.2f}B parameters a layer, "
          f"{cfg.param_count_estimate() * 2 / 1e9:.1f} GB of bf16 weights "
          f"with the embedding and the head (all {full.n_layers}: "
          f"{full.param_count_estimate() * 2 / 1e12:.2f} TB)")
    try:
        out, oom = _serve_main_path("serve-deepseek", cfg, run, 0), None
    except torch.cuda.OutOfMemoryError as e:
        out, oom = None, str(e).splitlines()[0]
    if out is None:             # retried outside the handler: its traceback
        _release({})            # holds the first model
        run["batch"] //= 2
        print(f"[serve-deepseek] out of device memory at batch "
              f"{DEEPSEEK['batch']} ({oom}); the batch is halved to "
              f"{run['batch']}")
        out = _serve_main_path("serve-deepseek", cfg, run, 0)
    check(out["flash"] == 0, f"[serve-deepseek] {out['flash']} flash "
          "launches, expected 0")
    res = out.pop("res")
    gate = _mla_decode_gate(res["model"], res["tokens"])
    print(f"[serve-deepseek] layer 0's absorbed mla_decode of token "
          f"{run['prompt_len'] - 1} vs the expanded mla_prefill of "
          f"{run['prompt_len']} tokens (batch {run['batch']}): "
          + "; ".join(f"{k} max abs err {e:.3e} (limit {lim:.3e}; token "
                      f"S - 1 lies {away:.3e} away)"
                      for k, (e, lim, away) in gate.items()))
    _release(res)
    print(f"[serve-deepseek] {out['seconds']:.1f}s")
    return dict(out, gate=gate, batch=run["batch"])


# LM training at mamba2-780m's full width (d_model 1,536, vocab 50,280,
# bf16, f32 AdamW moments), cut to 12 of its 48 layers (PR 27: the whole
# run came within ~60 s of its time limit once mesh-lm trained the full
# depth on the mesh; its two ~10-GB checkpoints and 20 steps took ~220
# s), through the launcher's train_lm: batch 8 x 1,024 tokens, 12 steps,
# a checkpoint at step 6; then step 6 restored into freshly built state
# and run to step 12.  lr 1e-3: at the launcher's default 3e-3 (one warmup
# step) Adam's first steps raise the loss for all 12 steps (the launcher
# at each rate; PERF.md §6).
LM_TRAIN = dict(arch="mamba2-780m", batch=8, seq=1024, steps=12,
                ckpt_every=6, lr=1e-3, layers=12)
LM_CKPT_DIR = os.path.join(ROOT, "build", "chip_smoke_lm_ckpt")
# Step 0 in bf16 against the same weights and batch in float32 (full
# float32 products): the loss to rtol 1e-2, the grad norm to rtol 5e-2.
LM_DTYPE_RTOL = {"loss": 1e-2, "grad_norm": 5e-2}
BF16_PEAK_FLOPS = 989e12            # PERF.md's dense bf16 peak of the H100
LM_PROFILED_STEPS = 2
# The readout over the trained model, frozen: 4,096 sequences of 512
# tokens (two SSD chunks) from a 24-token alphabet (tests/test_readout.py's
# recipe), extracted in batches of 32; Algorithm 2 (4 workers, |I| = |J| =
# 512: a J union of 2,048) on 2,048 rows, at most 60 epochs, the other
# 2,048 held out; gamma x D = 3.2, as the JAX test's 0.05 at D 64.
READOUT = dict(n=4096, seq=512, alphabet=24, batch=32, n_train=2048,
               workers=4, n_grad=512, n_expand=512, epochs=60, gamma_d=3.2,
               lam=1e-5, seed=7)


def _loss_and_grad_norm(model, batch) -> tuple:
    """The training step's loss and grad norm (loss_chunks 4, remat on)
    of ``model`` on ``batch``, on one device or a mesh (the step's
    gradients: summed over the data axes, divided by the shards; the
    global norm), the parameters left as they are."""
    import torch
    from repro_torch.distributed import collectives
    from repro_torch.optim import global_norm
    from repro_torch.train import param_shards, trainable
    from repro_torch.train.step import finish_grads
    params = trainable(model)
    shards = param_shards(model)
    loss = model.loss(batch["tokens"], batch["labels"], loss_chunks=4)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    loss = loss.detach()
    if shards.ctx is not None:
        ctx = shards.ctx
        grads = finish_grads(grads, shards)
        loss = collectives.psum(loss.clone(), ctx, ctx.data_axes) / ctx.n_data
    return float(loss), float(global_norm(grads, shards))


def _lm_batch0(cfg):
    """lm-train's first batch (the pipeline's seed 1, step 0)."""
    import torch
    from repro_torch.data.pipeline import BigramPipeline, to_device
    return to_device(BigramPipeline(cfg.vocab_size, LM_TRAIN["batch"],
                                    LM_TRAIN["seq"], seed=1).peek_batch(0),
                     torch.device(DEVICE))


def _lm_step0_dtypes(cfg) -> dict:
    """Step 0 of lm-train (init seed 0, the pipeline's first batch) in
    bf16, and on float32 copies of the same weights with float32
    compute."""
    import torch
    from repro_torch.kernels import full_fp32_matmul
    from repro_torch.models.model import LanguageModel
    batch = _lm_batch0(cfg)
    bf16 = LanguageModel(cfg, device=DEVICE).init(
        torch.Generator(device=DEVICE).manual_seed(0))
    out = {"bf16": _loss_and_grad_norm(bf16, batch)}
    f32 = LanguageModel(cfg.replace(param_dtype="float32",
                                    compute_dtype="float32"), device=DEVICE)
    with torch.no_grad():
        f32.load_state_dict(bf16.state_dict())
    del bf16
    with full_fp32_matmul():
        out["float32"] = _loss_and_grad_norm(f32, batch)
    del f32, batch
    torch.cuda.empty_cache()
    return out


def _lm_kernel_launches() -> dict:
    """Launches of every kernel wrapper an LM or DSEKL path can reach."""
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.dsekl import block
    return {"flash": fk.flash_attention_cuda.launches,
            "ssd": sk.ssd_cuda.launches,
            **{f.__name__: f.launches for f in (
                block.train_pass_indexed_cuda, block.train_pass_cuda,
                block.dual_pass_cuda, block.kernel_matvec_cuda,
                block.kernel_vecmat_cuda)}}


def _reset_lm_counters() -> None:
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.kernels.ssd import kernel as sk
    _reset_dsekl_counters()
    fk.flash_attention_cuda.launches = 0
    fk.flash_attention_cuda.launches_by_route = dict.fromkeys(fk.ROUTES, 0)
    sk.ssd_cuda.launches = 0
    sk.ssd_cuda.launches_by_route = dict.fromkeys(sk.ROUTES, 0)


def _lm_train_args(resume: bool, seed: int):
    from repro_torch.launch import train
    argv = ["--arch", LM_TRAIN["arch"], "--full", "--device", DEVICE,
            "--steps", str(LM_TRAIN["steps"]), "--batch",
            str(LM_TRAIN["batch"]), "--seq", str(LM_TRAIN["seq"]),
            "--lr", str(LM_TRAIN["lr"]), "--ckpt-dir", LM_CKPT_DIR,
            "--ckpt-every", str(LM_TRAIN["ckpt_every"]), "--seed", str(seed)]
    return train.parser().parse_args(argv + ["--resume"] * resume)


class _Depth:
    """While active, the train launcher's config of ``arch`` at its
    published widths has ``layers`` layers (``--full`` gives all)."""

    def __init__(self, arch: str, layers: int):
        self.arch, self.layers = arch, layers

    def __enter__(self):
        from repro_torch.launch import train
        orig = self._orig = train.get_config

        def get_config(name, reduced=False):
            cfg = orig(name, reduced=reduced)
            if name == self.arch and not reduced:
                cfg = cfg.replace(n_layers=self.layers)
            return cfg

        train.get_config = get_config
        return self

    def __exit__(self, *exc):
        from repro_torch.launch import train
        train.get_config = self._orig


def phase_lm_train():
    """mamba2-780m at full width, cut to LM_TRAIN's layers, trained through ``train_lm``
    (AdamW, cosine, bf16 parameters, f32 moments); a checkpoint at step 6
    restored into freshly built state runs to step 12 bit for bit; no
    kernel launches (training runs the plain differentiable functions:
    no kernel has a backward); then two steps under torch.profiler.
    First step 0 in bf16 is held against the same weights in float32."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import to_device
    from repro_torch.launch import train
    full = get_config(LM_TRAIN["arch"])
    cfg = full.replace(n_layers=LM_TRAIN["layers"])
    print(f"[lm-train] cut to {cfg.n_layers} of {full.n_layers} layers "
          "(the full depth trains on the mesh in mesh-lm)")
    args = _lm_train_args(resume=False, seed=0)
    with _Depth(LM_TRAIN["arch"], LM_TRAIN["layers"]):
        refusal = train.lm_refusal(args)
    check(not refusal, f"lm-train: {refusal}")
    # A checkpoint holds the parameters in float32 and the two moments.
    ckpt_bytes = 12 * cfg.param_count_estimate()
    shutil.rmtree(LM_CKPT_DIR, ignore_errors=True)
    os.makedirs(LM_CKPT_DIR)
    free = shutil.disk_usage(LM_CKPT_DIR).free
    check(free > 2.2 * ckpt_bytes, f"lm-train: no room for two "
          f"{ckpt_bytes / 1e9:.1f} GB checkpoints in {LM_CKPT_DIR}: "
          f"{free / 1e9:.1f} GB free")
    state_gb = train.lm_state_bytes(cfg) / 1e9
    print(f"[lm-train] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, {cfg.param_dtype}; "
          f"parameters + gradients + f32 moments ~{state_gb:.1f} GB; "
          f"checkpoints of ~{ckpt_bytes / 1e9:.1f} GB to {LM_CKPT_DIR} "
          f"({free / 1e9:.0f} GB free)")
    step0 = _lm_step0_dtypes(cfg)
    (l16, n16), (l32, n32) = step0["bf16"], step0["float32"]
    print(f"[lm-train] step 0 in {cfg.param_dtype}: loss {l16:.6f}, grad "
          f"norm {n16:.6f};"
          f" the same weights in float32: loss {l32:.6f}, grad norm "
          f"{n32:.6f} (relative gaps {abs(l16 - l32) / abs(l32):.3e}, "
          f"{abs(n16 - n32) / abs(n32):.3e}; held to {LM_DTYPE_RTOL})")
    for key, got, want in (("loss", l16, l32), ("grad_norm", n16, n32)):
        check(math.isfinite(got) and abs(got - want)
              <= LM_DTYPE_RTOL[key] * abs(want),
              f"lm-train: step 0's bf16 {key} {got} is not within "
              f"{LM_DTYPE_RTOL[key]} of float32's {want}")
    _reset_lm_counters()                      # the training path starts
    t0 = time.perf_counter()
    with _Depth(LM_TRAIN["arch"], LM_TRAIN["layers"]):
        clean = train.train_lm(args)
    torch.cuda.synchronize()
    clean_s = time.perf_counter() - t0
    launches = _lm_kernel_launches()          # ... and ends here
    hist = clean["history"]
    params = {k: p.detach().clone()
              for k, p in clean["model"].named_parameters()}
    n_params, peak = clean["n_params"], clean["peak_bytes"]
    del clean
    torch.cuda.empty_cache()
    steps = sorted(int(s[5:]) for s in os.listdir(LM_CKPT_DIR)
                   if s.startswith("step_") and s[5:].isdigit())
    check(steps == [LM_TRAIN["ckpt_every"], LM_TRAIN["steps"]],
          f"lm-train: checkpoints at steps {steps}")
    shutil.rmtree(os.path.join(LM_CKPT_DIR, f"step_{LM_TRAIN['steps']:010d}"))
    t0 = time.perf_counter()
    with _Depth(LM_TRAIN["arch"], LM_TRAIN["layers"]):
        resumed = train.train_lm(_lm_train_args(resume=True, seed=1))
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    # Two more steps under the profiler (they change the state).
    model, step_fn = resumed["model"], resumed["step"]
    tparams = dict(model.named_parameters())
    opt_state, pipe = resumed["opt_state"], resumed["pipeline"]
    rhist = resumed["history"]
    same = all(torch.equal(p, params[k]) for k, p in tparams.items())
    del params
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(LM_PROFILED_STEPS):
            _, opt_state, m = step_fn(tparams, opt_state, to_device(
                pipe.next_batch(), torch.device(DEVICE)))
            float(m["loss"])
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    shutil.rmtree(LM_CKPT_DIR, ignore_errors=True)
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    print(f"[lm-train] kernel launches during training: {launches}")
    check(not any(launches.values()),
          f"lm-train: kernels launched while training: {launches}")
    check(len(hist) == LM_TRAIN["steps"], f"lm-train: {len(hist)} steps")
    check(all(map(math.isfinite, losses + norms)),
          f"lm-train: non-finite loss or grad norm: {losses} {norms}")
    tail = statistics.mean(losses[-3:])
    check(tail < losses[0], f"lm-train: the last three losses' mean {tail} "
          f"is not below the first {losses[0]}")
    print("[lm-train] loss " + " ".join(f"{v:.4f}" for v in losses)
          + "; grad norm " + " ".join(f"{v:.3f}" for v in norms))
    first = LM_TRAIN["ckpt_every"]
    check([h["step"] for h in rhist] == list(range(first, LM_TRAIN["steps"])),
          f"lm-train: the resumed run's steps {[h['step'] for h in rhist]}")
    check([h["loss"] for h in rhist] == losses[first:]
          and [h["grad_norm"] for h in rhist] == norms[first:],
          "lm-train: the resumed run's losses or grad norms differ from the "
          f"uninterrupted run's: {[h['loss'] for h in rhist]} vs "
          f"{losses[first:]}")
    check(same, "lm-train: the resumed run's parameters differ from the "
          "uninterrupted run's")
    print(f"[lm-train] step {first} restored into freshly built state (init "
          f"seed 1) and run to step {LM_TRAIN['steps']}: losses, grad norms "
          f"and all {n_params:,} parameters equal the uninterrupted run's bit "
          f"for bit; wall {clean_s:.1f} s uninterrupted (init, 12 steps, "
          f"checkpoints at 6 and 12), {resume_s:.1f} s resumed")
    secs = [h["seconds"] for h in hist[1:]]
    ms = statistics.mean(secs) * 1e3
    tokens = LM_TRAIN["batch"] * LM_TRAIN["seq"]
    embed = cfg.vocab_size * cfg.d_model
    model_flops = 6 * n_params * tokens
    recompute = 2 * (n_params - embed) * tokens
    mfu = model_flops / (ms / 1e3) / BF16_PEAK_FLOPS
    print(f"[lm-train] {ms:.3f} ms a step over steps 2-{LM_TRAIN['steps']} "
          f"(host clock, each step ending in a device sync; min "
          f"{min(secs) * 1e3:.3f}, max {max(secs) * 1e3:.3f}) = "
          f"{tokens / (ms / 1e3):,.0f} tokens/s; model FLOPs 6 x "
          f"{n_params:,} parameters x {tokens} tokens = {model_flops:.4e} a "
          f"step = {model_flops / (ms / 1e3) / 1e12:.2f} TFLOP/s = {mfu:.2%} "
          f"of the {BF16_PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16 dense peak; "
          f"remat recomputes the layers' and the head's forward, 2 x "
          f"{n_params - embed:,} x {tokens} = {recompute:.4e} more "
          f"(model + recompute {(model_flops + recompute) / (ms / 1e3) / 1e12:.2f}"
          f" TFLOP/s; the SSD's intra-chunk products not counted); peak "
          f"device memory {peak / 2**30:.2f} GiB")
    rows = _device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3
    check(busy > 0, "lm-train: torch.profiler recorded no device time")
    wall = prof_wall * 1e3
    print(f"[lm-train] torch.profiler over {LM_PROFILED_STEPS} steps: wall "
          f"{wall:.3f} ms (profiler on), device busy {busy:.3f} ms = "
          f"{busy / wall:.1%}; {sum(r[2] for r in rows) / LM_PROFILED_STEPS:.0f}"
          f" device kernels (and copies, fills) a step; the largest:")
    for dev_us, key, count in rows[:12]:
        print(f"[lm-train]   {dev_us / 1e3 / LM_PROFILED_STEPS:9.3f} ms/step "
              f"{count // LM_PROFILED_STEPS:6d}x {key[:90]}")
    return {"model": model, "ms_per_step": ms, "tokens_per_s":
            tokens / (ms / 1e3), "mfu": mfu, "peak_gib": peak / 2**30,
            "busy_share": busy / wall, "step0": step0}


def _ssd_shape_time(case, device_name: str):
    """The sm90 SSD kernel at ``case`` (b, s, nh, hd, g, n, chunk) in
    bf16: device ms a call (``device_ms``), the bound (products at the bf16
    tensor peak, the rest at fp32; bytes at HBM rate), error against the
    plain version on the same values in float32."""
    import torch
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.ssd import ssd_chunked
    args = _ssd_inputs(case, torch.bfloat16, seed=13)
    b, s, nh, hd, g, n, chunk = case
    check(sk.select_route(torch.bfloat16, hd, n, chunk) == "sm90",
          f"ssd {case} does not take the sm90 route")

    def kernel():
        return sk.ssd_cuda(*args, chunk=chunk)

    gy, gf = kernel()
    wy, wf = ssd_chunked(*(a.float() for a in args), chunk=chunk, impl="ref")
    err = max(compare(gy.float(), wy, BF16_RTOL, SSD_ATOL),
              compare(gf, wf, SSD_RTOL, SSD_ATOL))
    del gy, gf, wy, wf
    ms = statistics.mean([device_ms(kernel), device_ms(kernel)])
    peak = peaks(device_name)
    n_tensor, n_ops = (b * nh * x for x in _ssd_ops(s, chunk, n, hd))
    n_bytes = (2 * (2 * b * s * nh * hd + b * s * nh + 2 * b * s * g * n)
               + 4 * nh + 4 * b * nh * hd * n)
    t_ops = (n_tensor / peak["bf16"] + n_ops / peak["fp32"]) * 1e3
    bound = max(t_ops, n_bytes / peak["bytes"] * 1e3)
    return ms, bound, err


def phase_lm_readout(model, device_name: str):
    """The DSEKL readout over the trained model, frozen: features of 4,096
    sequences through the SSD kernel (one launch a layer a batch, sm90; the last
    batch's held against the plain version on its activations), then
    ``KernelReadout.fit`` by Algorithm 2 (every step one launch of the
    sm90 train kernel's wide variant) and its decision through the fp32
    matvec route (D 1,536); gates as tests/test_readout.py."""
    import torch
    from repro_torch.core.dsekl import (DSEKLConfig, decision_function_ref)
    from repro_torch.core.readout import KernelReadout, extract_features
    from repro_torch.kernels.dsekl import block
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.models import ssm
    cfg = model.cfg
    r = READOUT
    d = cfg.d_model
    gen = torch.Generator(device=DEVICE).manual_seed(r["seed"])
    tokens = torch.randint(0, r["alphabet"], (r["n"], r["seq"]),
                           generator=gen, device=DEVICE)
    n_batches = r["n"] // r["batch"]
    ssd_calls = []
    undo = _recorder(ssm, "ssd_chunked", ssd_calls, cfg.n_layers)
    _reset_lm_counters()                      # the readout path starts
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = extract_features(model, tokens, batch_size=r["batch"])
        torch.cuda.synchronize()
        extract_s = time.perf_counter() - t0
    finally:
        undo()
    ssd_routes = dict(sk.ssd_cuda.launches_by_route)
    ssd_n = sk.ssd_cuda.launches
    fwd_flops = 2 * (sum(p.numel() for p in model.parameters())
                     - cfg.vocab_size * d) * r["n"] * r["seq"]
    print(f"[lm-readout] extract_features: {r['n']} x {r['seq']} tokens in "
          f"{n_batches} batches of {r['batch']}: {extract_s:.3f} s (host "
          f"clock ending in a sync; {fwd_flops:.3e} FLOPs of frozen forward "
          f"by 2 x parameters x tokens = {fwd_flops / extract_s / 1e12:.1f} "
          f"TFLOP/s); ssd launches {ssd_n} by route {ssd_routes}")
    check(ssd_n == cfg.n_layers * n_batches and ssd_routes["sm90"] == ssd_n,
          f"lm-readout: {ssd_n} ssd launches ({ssd_routes}), expected "
          f"{cfg.n_layers} x {n_batches}, all sm90")
    check(tuple(feats.shape) == (r["n"], d)
          and bool(torch.isfinite(feats).all()),
          f"lm-readout: features {tuple(feats.shape)} or non-finite")
    _hold_main_path([], ssd_calls, "lm-readout", "the last batch's")
    del ssd_calls
    w = torch.randn(d, generator=gen, device=DEVICE)
    y = torch.sign(feats @ w / d ** 0.5 + 1e-6)
    ntr = r["n_train"]
    hcfg = DSEKLConfig(n_grad=r["n_grad"], n_expand=r["n_expand"],
                       n_workers=r["workers"], lam=r["lam"], lr0=1.0,
                       schedule="adagrad",
                       kernel_params=(("gamma", r["gamma_d"] / d),))
    head = KernelReadout(hcfg)
    train_before = dict(block.train_pass_indexed_cuda.launches_by_route)
    t0 = time.perf_counter()
    res = head.fit(feats[:ntr].contiguous(), y[:ntr].contiguous(),
                   torch.Generator(device=DEVICE).manual_seed(r["seed"]),
                   n_epochs=r["epochs"])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    steps = int(res.state.step)
    counts = _dsekl_counts()
    j_union = r["workers"] * r["n_expand"]
    wide_smem = block._train_sm90_lib().dsekl_train_sm90_smem_bytes(j_union)
    check(counts["train_pass_indexed_cuda"] == {"sm90": steps, "fp32": 0}
          and train_before == {"sm90": 0, "fp32": 0} and wide_smem > 0
          and counts["train_pass_cuda"] == {"sm90": 0, "fp32": 0},
          f"lm-readout: {steps} steps, train launches {counts}; J union "
          f"{j_union} takes {wide_smem} B of dynamic shared memory (the wide "
          "variant takes > 0)")
    matvec_fit = dict(block.kernel_matvec_cuda.launches_by_route)
    test_feats = feats[ntr:].contiguous()
    dec = head.decision(test_feats)
    pred = torch.sign(dec)
    tr_pred = head.predict(feats[:ntr].contiguous())
    torch.cuda.synchronize()
    matvec = {k: v - matvec_fit[k]
              for k, v in block.kernel_matvec_cuda.launches_by_route.items()}
    launches = _lm_kernel_launches()          # ... and ends here
    err = float((pred != y[ntr:]).float().mean())
    tr_err = float((tr_pred != y[:ntr]).float().mean())
    n_sv = head.x_train.shape[0]
    print(f"[lm-readout] Algorithm 2 (4 workers x |J| {r['n_expand']}, J "
          f"union {j_union}: the sm90 train kernel's wide variant, "
          f"{wide_smem} B of dynamic shared memory) on {ntr} rows x D {d}, "
          f"gamma {r['gamma_d'] / d:.6f}: {res.epochs_run} epochs, {steps} "
          f"steps in {fit_s:.3f} s ({fit_s / steps * 1e3:.3f} ms a step); "
          f"{n_sv} support vectors; held-out error {err:.4f} (gate 0.35), "
          f"train error {tr_err:.4f} (gate 0.05); matvec launches by route "
          f"for the decisions {matvec}, in the fit {matvec_fit}")
    check(err <= 0.35 and tr_err <= 0.05,
          f"lm-readout: held-out error {err}, train error {tr_err}")
    route = block.select_matvec_route("rbf", d)     # fp32 at D 1,536
    check(matvec == dict({"sm90": 0, "fp32": 0}, **{route: 2})
          and sum(matvec_fit.values()) == 0,
          f"lm-readout: decision matvecs by route {matvec}, expected 2 on "
          f"the {route} route; in the fit {matvec_fit}")
    want = decision_function_ref(hcfg.replace(impl="ref"), head.alpha,
                                 head.x_train, test_feats)
    derr = compare(dec, want)
    print(f"[lm-readout] the card's decision vs decision_function_ref: max "
          f"abs err {derr:.3e} (rtol {RTOL}, atol {ATOL} x max(1, |ref|), "
          f"|ref|_inf {float(want.abs().max()):.4f})")
    # The two shapes this path gives its kernels, timed with their bounds.
    ssd_case = (r["batch"], r["seq"], cfg.ssm_heads, cfg.ssm_head_dim,
                cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_chunk)
    ssd_ms, ssd_bound, ssd_err = _ssd_shape_time(ssd_case, device_name)
    print(f"[lm-readout] ssd sm90 at B*nh {r['batch'] * cfg.ssm_heads}, S "
          f"{r['seq']}, hd {cfg.ssm_head_dim}, n {cfg.ssm_state}, chunk "
          f"{cfg.ssm_chunk}: device {ssd_ms:.4f} ms a call, bound "
          f"{ssd_bound:.4f} ms = {ssd_bound / ssd_ms:.1%}; vs plain max abs "
          f"err {ssd_err:.3e}")
    params = {"gamma": r["gamma_d"] / d}
    alpha_sv = head.alpha.contiguous()

    def mv():
        return block.kernel_matvec_cuda(test_feats, head.x_train, alpha_sv,
                                        kernel_name="rbf", params=params)

    mv_err = compare(mv(), block.kernel_matvec_plain(
        test_feats, head.x_train, alpha_sv, kernel_name="rbf",
        params=params))
    mv_ms = statistics.mean([device_ms(mv), device_ms(mv)])
    peak = peaks(device_name)
    products, ops_count, bytes_count = _matvec_work(test_feats.shape[0],
                                                    n_sv, d)
    mv_bound = max((products + ops_count) / peak["fp32"],
                   bytes_count / peak["bytes"]) * 1e3
    print(f"[lm-readout] kernel_matvec fp32 route at (I {test_feats.shape[0]}"
          f", J {n_sv}, D {d}): device {mv_ms:.4f} ms a call, bound "
          f"{mv_bound:.6f} ms = {mv_bound / mv_ms:.1%} (all operations at the "
          f"fp32 peak); vs plain max abs err {mv_err:.3e}")
    # The wide sm90 train variant alone at the fit's step (I n_grad, a J
    # union of 2,048, D 1,536), as the step calls it (rows by index, lam),
    # counted as phase_parallel_times counts the step at D 54.
    xs, ys, a_full = feats[:ntr].contiguous(), y[:ntr].contiguous(), \
        res.state.alpha
    tgen = torch.Generator(device=DEVICE).manual_seed(r["seed"] + 1)
    idx_i = torch.randperm(ntr, generator=tgen, device=DEVICE)[:r["n_grad"]]
    idx_j = torch.randperm(ntr, generator=tgen, device=DEVICE)[:j_union]
    scale = ntr / j_union if hcfg.unbiased_scaling else 1.0
    tkw = dict(loss=hcfg.loss, params=params, f_scale=scale, lam=hcfg.lam)
    check(block.select_train_route(r["n_grad"], j_union, d, "rbf") ==
          "sm90", "lm-readout: the fit's step is not on the sm90 route")

    def wide():
        return block.train_pass_indexed_cuda(xs, ys, a_full, idx_i, idx_j,
                                             **tkw)

    def wide_plain():
        return block.train_pass_indexed_plain(xs, ys, a_full, idx_i, idx_j,
                                              **tkw)

    got, want = wide(), wide_plain()
    w_err = max(compare(got[0], want[0]), compare(got[1], want[1]))
    w_ms = statistics.mean([device_ms(wide), device_ms(wide)])
    w_plain = device_ms(wide_plain, reps=5)
    n_i = r["n_grad"]
    w_ops = (2 * n_i * j_union * d + 2 * d * (n_i + j_union)
             + 8 * n_i * j_union + 2 * n_i * j_union + 4 * n_i + 2 * j_union)
    w_bytes = 4 * (n_i * d + j_union * d + 2 * j_union + 2 * n_i) \
        + 8 * (n_i + j_union)
    w_bound = max(w_ops / peak["fp32"], w_bytes / peak["bytes"]) * 1e3
    print(f"[lm-readout] train_pass_sm90_j4096 (the wide variant) at the "
          f"fit's step (I {n_i}, J union {j_union}, D {d}, rows by index, "
          f"lam): device {w_ms:.4f} ms a call, bound {w_bound:.6f} ms = "
          f"{w_bound / w_ms:.1%} ({w_ops:.3e} operations at the fp32 peak, "
          f"{w_bytes:.3e} B); plain {w_plain:.4f} ms; vs plain max abs err "
          f"{w_err:.3e}")
    return {"ssd": ssd_n, "train": steps, "matvec": sum(matvec.values()),
            "train_time": (w_ms, w_bound, w_plain),
            "train_shape": (n_i, j_union, d),
            "launches": launches, "extract_s": extract_s,
            "ssd_time": (ssd_ms, ssd_bound), "matvec_time": (mv_ms, mv_bound),
            "err": err, "tr_err": tr_err, "ssd_case": ssd_case,
            "matvec_shape": (test_feats.shape[0], n_sv, d)}


# ---------------------------------------------------------------------------
# The DSEKL mesh (core/distributed.py): four gloo ranks sharing the card.
# ---------------------------------------------------------------------------

MESH_RANKS = 4
MESH_DIR = os.path.join(ROOT, "build", "chip_smoke_mesh")
# (a) parity: covertype-like rows scaled to unit norm (K far from I), D 54,
# I = J = 1,024 a shard on a (2, 2) mesh, square loss, 8 steps.
MESH_PARITY = dict(n=65536, steps=8, seed=5)
# (b) the covertype protocol through the launcher on a (2, 2) mesh from
# the memmap: 561,936 rows (559,888 after the hold-out: divisible by 4, so
# the (4, 1) resume keeps N), RBF, hinge, adagrad, 1,024 a shard.
MESH_ARGS = ["--dsekl", "--execution", "mesh", "--data", "mmap", "--n",
             "561936", "--dim", "54", "--n-grad", "1024", "--n-expand",
             "1024", "--kernel", "rbf", "--gamma", "1.0", "--seed", "0"]
MESH_TRAIN_N = 561936 - 2048
MESH_BCD_ROUNDS = 8
MESH_TIMEOUT_S = 300


def _torchrun(part: str, spec: dict, where: str = MESH_DIR,
              timeout_s: float = MESH_TIMEOUT_S) -> dict:
    """Run this script's ``--mesh-rank`` program on ``MESH_RANKS`` ranks
    under ``torch.distributed.run --standalone`` (a new session, killed
    whole at the time limit); fails on any rank's non-zero exit.  Returns
    each rank's JSON result by rank."""
    spec = dict(spec, part=part, dir=where)
    path = os.path.join(where, f"spec_{part}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(spec.get("ranks", MESH_RANKS)),
           os.path.abspath(__file__), "--mesh-rank", path]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, err = proc.communicate()
        print(out[-4000:], err[-4000:], sep="\n")
        raise SmokeFailure(f"mesh {part}: the ranks did not finish within "
                           f"{timeout_s} s")
    for line in out.splitlines():
        if line.startswith("[mesh"):
            print(line)
    if proc.returncode != 0:
        print(out[-4000:], err[-6000:], sep="\n")
        raise SmokeFailure(f"mesh {part}: torch.distributed.run exited "
                           f"{proc.returncode}")
    print(f"[mesh] {part}: {spec.get('ranks', MESH_RANKS)} ranks under "
          f"torch.distributed.run in {time.perf_counter() - t0:.1f}s")
    results = {}
    for r in range(spec.get("ranks", MESH_RANKS)):
        with open(os.path.join(where, f"{part}_rank{r}.json")) as f:
            results[r] = json.load(f)
    return results


def _mesh_counts_summed(counts: dict):
    """Every rank's launches by wrapper and route, summed by all_reduce."""
    import torch
    import torch.distributed as dist
    keys = [(w, r) for w in sorted(counts) for r in sorted(counts[w])]
    t = torch.tensor([float(counts[w][r]) for w, r in keys])
    dist.all_reduce(t)
    out = {}
    for (w, r), v in zip(keys, t.tolist()):
        out.setdefault(w, {})[r] = int(v)
    return out


def _mesh_parity():
    """(a) 8 mesh steps with impl "cuda" on one shared plan against the
    port's simulate_step with impl "ref" (rank 0, on the card), then with
    compress_bits=8 and with EigenPro; each step on each rank one sm90
    matvec and one sm90 vecmat (EigenPro: two), summed by all_reduce."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import DSEKLConfig, dsekl, losses, precond, sampler
    from repro_torch.core import distributed as D
    from repro_torch.data import make_covertype_like
    from repro_torch.distributed import compression
    from repro_torch.launch.mesh import make_local_mesh
    p = MESH_PARITY
    mesh = make_local_mesh(2, 2, backend="gloo", device=DEVICE)
    dev, n, steps = mesh.device, p["n"], p["steps"]
    rank, (d, m) = mesh.rank, mesh.coordinate
    x, y = make_covertype_like(n, 54, seed=0, device=dev)
    x = _unit_rows(x)
    cfg = DSEKLConfig(n_grad=1024, n_expand=1024, kernel="rbf",
                      kernel_params=(("gamma", 1.0),), loss="square",
                      lam=1e-4, schedule="adagrad", impl="cuda")
    xg, yg, xe = D.shard_inputs(mesh, x, y)
    gen = torch.Generator().manual_seed(p["seed"])
    rows = (n // 2, n // 2)
    plans = [sampler.mesh_step_plan(gen, 1024, 1024, rows, rows)
             for _ in range(steps)]
    rows_m = n // 2

    def run(c, pc=None, compress=False):
        st = D.init_sharded_state(mesh, n)
        g = torch.Generator(device=dev) if compress else None
        _reset_dsekl_counters()                 # the mesh path starts
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if pc is None:
            step = D.make_distributed_step(c, mesh, n)
            for t, plan in enumerate(plans):
                if g is not None:
                    g.manual_seed(1000 + t)
                st = step(xg, yg, xe, st, plan, generator=g)
        else:
            step = D.make_distributed_block_step(c, mesh, n,
                                                 precondition=True)
            for ii, jj in plans:
                i, j = ii[d].to(dev), jj[m].to(dev)
                st = step(xg[i], yg[i], xe[j], j, st, pc)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        counts = _dsekl_counts()                # ... and ends here
        _check_train_steps(counts, 0, "train_pass_cuda", "sm90", steps,
                           f"mesh parity rank {rank}",
                           vecmats=steps * (2 if pc is not None else 1))
        return st, _mesh_counts_summed(counts), ms

    def reference(c, pc=None):
        """simulate_step with impl "ref" on rank 0, sent to every rank."""
        full = torch.zeros(n, device=dev)
        if rank == 0:
            cr = c.replace(impl="ref")
            a, g = torch.zeros(n, device=dev), torch.ones(n, device=dev)
            t = torch.zeros((), dtype=torch.int32, device=dev)
            for ii, jj in plans:
                a, g, t = D.simulate_step(cr, 2, 2, x, y, a, g, t, ii, jj,
                                          pc)
            full = a
        dist.broadcast(full, src=0)
        return full[m * rows_m:(m + 1) * rows_m]

    out = {}
    st, counts, ms = run(cfg)
    ref = reference(cfg)
    err = compare(st.alpha, ref, TRAJ_RTOL, TRAJ_ATOL)
    out["plain"] = {"launches": counts, "ms": ms, "err": err,
                    "top": float(ref.abs().max())}
    # compress_bits = 8: the trajectory, and one const-rate step against
    # the exact one on the same state within the error bound.
    st_c, counts_c, ms_c = run(cfg.replace(compress_bits=8), compress=True)
    check(bool(torch.isfinite(st_c.alpha).all()), "compressed: non-finite")
    one = cfg.replace(schedule="const", lr0=0.5)
    st0 = D.init_sharded_state(mesh, n)._replace(
        alpha=torch.randn(rows_m, generator=torch.Generator(
            device=dev).manual_seed(7), device=dev))
    ii, jj = plans[0]
    i, j = ii[d].to(dev), jj[m].to(dev)
    aj = st0.alpha[j]
    f = D._sum(dsekl._block_f(one, xg[i], xe[j], aj, n), mesh, "model")
    v = losses.get_loss(one.loss).grad_f(f, yg[i])
    gmax = dsekl._block_grad(one.replace(lam=0.0), xg[i], xe[j], aj,
                             v).abs().max().reshape(1)
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=mesh.group("data"))
    exact = D.make_distributed_step(one, mesh, n)(xg, yg, xe, st0, plans[0])
    comp = D.make_distributed_step(one.replace(compress_bits=8), mesh, n)(
        xg, yg, xe, st0, plans[0],
        generator=torch.Generator(device=dev).manual_seed(1))
    # J repeats (drawn with replacement): an entry takes each copy's error.
    mult = int(torch.bincount(j).max())
    bound = mult * one.lr0 * compression.compression_error_bound(
        float(gmax[0]), 8, 2)
    c_err = float((comp.alpha - exact.alpha).abs().max())
    check(c_err <= bound * (1 + 1e-5) + 1e-7,
          f"compressed step {c_err:.3e} past the bound {bound:.3e}")
    out["compress"] = {"launches": counts_c, "ms": ms_c, "err": c_err,
                       "bound": bound, "traj_diff": float(
                           (st_c.alpha - st.alpha).abs().max())}
    # EigenPro: the block estimated on every rank, replicated from rank 0;
    # the const schedule at its step size for the step's J union.
    pre = precond.estimate_preconditioner(
        cfg, x, torch.Generator().manual_seed(11), k=PRECOND_K, device=dev)
    pc = D.broadcast_block(mesh, pre.block(dev))
    cfg_p = cfg.replace(schedule="const", lr0=pre.step_size(2 * 1024))
    st_p, counts_p, ms_p = run(cfg_p, pc=pc)
    ref_p = reference(cfg_p, pc)
    err_p = compare(st_p.alpha, ref_p, TRAJ_RTOL, TRAJ_ATOL)
    moved = float((ref_p - reference(cfg_p)).abs().max())
    check(moved > 100 * TRAJ_ATOL * max(1.0, float(ref_p.abs().max())),
          f"EigenPro moved alpha by only {moved:.3e}")
    out["precond"] = {"launches": counts_p, "ms": ms_p, "err": err_p,
                      "moved": moved}
    if rank == 0:
        print(f"[mesh-a] rank 0: 8 steps at I = J = 1,024 a shard, D 54: "
              f"plain {ms:.4f} ms a step, max err {err:.3e} (|ref| "
              f"{out['plain']['top']:.3e}); compressed {ms_c:.4f} ms, one "
              f"step {c_err:.3e} <= bound {bound:.3e}; EigenPro {ms_p:.4f} "
              f"ms, err {err_p:.3e}, its correction {moved:.3e}")
    return out


def _mesh_bcd(spec: dict) -> dict:
    """(d) bcd-cell's problem, MESH_BCD_ROUNDS rounds on the (2, 2) mesh;
    rank 0 saves the full alpha."""
    import numpy as np
    import torch
    from repro_torch.core import DSEKLConfig, fit
    from repro_torch.core import distributed as D
    from repro_torch.data import HostSource
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(2, 2, backend="gloo", device=DEVICE)
    z = np.load(spec["bcd_problem"])
    xva = torch.from_numpy(z["xva"]).to(mesh.device)
    yva = torch.from_numpy(z["yva"]).to(mesh.device)
    _reset_dsekl_counters()                     # the mesh BCD path starts
    t0 = time.perf_counter()
    res = fit(_bcd_cell_cfg(), HostSource(z["xtr"], z["ytr"]), None,
              torch.Generator().manual_seed(CONVERGE["seed"]),
              execution="bcd", mesh=mesh, n_epochs=MESH_BCD_ROUNDS, tol=0.0,
              x_val=xva, y_val=yva, device=DEVICE)
    secs = time.perf_counter() - t0
    counts = _dsekl_counts()                    # ... and ends here
    full = D.gather_model_shards(mesh, res.state.alpha)
    if mesh.rank == 0:
        np.save(os.path.join(MESH_DIR, "bcd_alpha.npy"), full.cpu().numpy())
    return {"launches": _mesh_counts_summed(counts), "seconds": secs,
            "val": [h["val_error"] for h in res.history]}


def _mesh_launch(argv, what: str) -> dict:
    """The launcher's ``train_dsekl`` on this rank, instrumented: the host
    time of the step's reductions (1,024 floats: f over model, g over
    data), the launches, the peak device memory; rank 0 saves the full
    alpha under ``what``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core.distributed import gather_model_shards
    from repro_torch.launch import train
    ar = {"n": 0, "s": 0.0}
    orig = dist.all_reduce

    def timed(t, *a, **k):
        t0 = time.perf_counter()
        r = orig(t, *a, **k)
        if t.numel() == 1024:
            ar["n"] += 1
            ar["s"] += time.perf_counter() - t0
        return r

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _reset_dsekl_counters()                     # the launcher's path starts
    dist.all_reduce = timed
    try:
        out = train.train_dsekl(train.parser().parse_args(
            argv + ["--device", DEVICE]))
    finally:
        dist.all_reduce = orig
    torch.cuda.synchronize()
    counts = _dsekl_counts()                    # ... and ends here
    peak = torch.cuda.max_memory_allocated() - base
    res, mesh = out["result"], out["mesh"]
    full = gather_model_shards(mesh, res.state.alpha)
    check(bool(torch.isfinite(full).all()), f"{what}: non-finite alpha")
    if mesh.rank == 0:
        np.save(os.path.join(MESH_DIR, f"{what}_alpha.npy"),
                full.cpu().numpy())
    steps = int(res.state.step)
    last = res.history[-1]
    spe = MESH_TRAIN_N // (1024 * mesh.size("data"))
    return {"steps": steps, "epochs": res.epochs_run,
            "ms_per_step": last["seconds"] / spe * 1e3,
            "ar_ms_per_step": ar["s"] * 1e3 / max(steps, 1),
            "ar_count": ar["n"], "loader": res.loader,
            "peak_mib": peak / 2**20, "val": [h.get("val_error")
                                               for h in res.history],
            "zero": _zero_model_error(out["y_val"]),
            "launches": _mesh_counts_summed(counts),
            "rank_launches": counts}


def _mesh_protocol(spec: dict) -> dict:
    """(b) the launcher on a (2, 2) mesh, 2 epochs, a checkpoint each."""
    argv = MESH_ARGS + ["--data-par", "2", "--model-par", "2",
                        "--dist-backend", "gloo", "--epochs", "2",
                        "--mmap-dir", spec["mmap"], "--checkpoint-dir",
                        spec["ckpt"]]
    return _mesh_launch(argv, "protocol")


def _mesh_resume(spec: dict) -> dict:
    """(b) the epoch-1 checkpoint resumed on (4, 1), from each copy."""
    out = {}
    for i, ck in enumerate(spec["dirs"]):
        argv = MESH_ARGS + ["--data-par", "4", "--model-par", "1",
                            "--dist-backend", "gloo", "--epochs", "2",
                            "--mmap-dir", spec["mmap"], "--checkpoint-dir",
                            ck, "--resume"]
        out[f"resume{i}"] = _mesh_launch(argv, f"resume{i}")
    return out


def mesh_rank(spec_path: str) -> int:
    """One rank of the mesh phase, under torch.distributed.run: the world
    from its environment (gloo: four ranks share the one card), the part
    the spec names, its JSON result to MESH_DIR.  The kernels were built
    by the parent's build phase: a rank that had to run nvcc fails."""
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import init_world
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(spec_path) as f:
        spec = json.load(f)
    init_world("gloo", DEVICE)
    rank = dist.get_rank()
    try:
        out = {}
        if spec["part"] == "main":
            out["parity"] = _mesh_parity()
            out["bcd"] = _mesh_bcd(spec)
            out["protocol"] = _mesh_protocol(spec)
        elif spec["part"] == "serve":
            out["a"] = _mesh_serve_engine(spec)
            out["b"] = _mesh_serve_jamba(spec)
            out["c"] = _mesh_serve_reduced()
        elif spec["part"] == "lm":
            out["a"] = _mesh_lm_a(spec)
            out["b"] = _mesh_lm_b(spec)
        else:
            out.update(_mesh_resume(spec))
        built = sorted(r.name for r in _build._records.values()
                       if r.seconds > 0)
        check(not built, f"rank {rank} ran nvcc for {built}")
        with open(os.path.join(spec["dir"],
                               f"{spec['part']}_rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
    return 0


def _bcd_cell_cfg():
    from repro_torch.core import DSEKLConfig
    b = BCD_CELL
    return DSEKLConfig(n_grad=b["row_block"], n_expand=b["block"],
                       kernel="rbf",
                       kernel_params=(("gamma", CONVERGE["gamma"]),),
                       loss="square", lam=b["lam"], bcd_block=b["block"],
                       bcd_row_block=b["row_block"])


def _bcd_cond(prob, rounds: int) -> float:
    """The largest float64 cond(A) over the rounds' blocks J (drawn as the
    fit draws them): A = K_{.,J}^T K_{.,J} + lam n K_{J,J}."""
    import torch
    from repro_torch.core import bcd
    n, lam = CONVERGE["n"], BCD_CELL["lam"]
    gen = torch.Generator().manual_seed(CONVERGE["seed"])
    conds = []
    for _ in range(rounds):
        j = torch.from_numpy(bcd.sample_block(gen, n, BCD_CELL["block"]))
        kj = prob["kmat"][:, j.to(prob["kmat"].device)]
        a = kj.T @ kj + lam * n * kj[j.to(kj.device)]
        conds.append(float(torch.linalg.cond(a)))
    return max(conds)


def phase_mesh(prob, smi: str, covertype_err: float) -> dict:
    """The DSEKL mesh on the one card: (a) parity, (d) BCD and (b) the
    covertype protocol on a (2, 2) gloo world of 4 ranks, then (b)'s
    epoch-1 checkpoint resumed twice on (4, 1), then (c) a world of one
    with nccl against gloo.  Four ranks share one card: the step times are
    not a multi-card figure."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import fit
    from repro_torch.launch import train
    t0 = time.perf_counter()
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    mmap = os.path.join(MESH_DIR, "mmap")
    ckpt = os.path.join(MESH_DIR, "ckpt")
    bcd_npz = os.path.join(MESH_DIR, "bcd_problem.npz")
    np.savez(bcd_npz, **{k: prob[k].cpu().numpy()
                         for k in ("xtr", "ytr", "xva", "yva")})
    main = _torchrun("main", {"bcd_problem": bcd_npz, "mmap": mmap,
                              "ckpt": ckpt})
    r0 = main[0]
    # (a): launches summed over the ranks, by route.
    steps = MESH_PARITY["steps"]
    for arm, vec in (("plain", 1), ("compress", 1), ("precond", 2)):
        got = r0["parity"][arm]["launches"]
        want = {"sm90": MESH_RANKS * steps, "fp32": 0}
        check(got["kernel_matvec_cuda"] == want
              and got["kernel_vecmat_cuda"] == {"sm90": vec * MESH_RANKS
                                                * steps, "fp32": 0}
              and all(sum(got[w].values()) == 0 for w in (
                  "train_pass_cuda", "train_pass_indexed_cuda",
                  "dual_pass_cuda")),
              f"mesh parity {arm}: launches summed over the ranks {got}")
    pa = r0["parity"]
    print(f"[mesh-a] ({smi}) 4 ranks x {steps} steps: sm90 matvec "
          f"{pa['plain']['launches']['kernel_matvec_cuda']['sm90']}, "
          f"vecmat {pa['plain']['launches']['kernel_vecmat_cuda']['sm90']}"
          f" (EigenPro {pa['precond']['launches']['kernel_vecmat_cuda']['sm90']}"
          f"), no train pass; max err against ref {max(r['parity']['plain']['err'] for r in main.values()):.3e}"
          f", EigenPro {max(r['parity']['precond']['err'] for r in main.values()):.3e}"
          f" (rtol {TRAJ_RTOL}, atol {TRAJ_ATOL} x max(1, |ref|)); "
          f"compressed step {max(r['parity']['compress']['err'] for r in main.values()):.3e}"
          f" within its bound {pa['compress']['bound']:.3e}")
    # (d): mesh BCD against the serial BCDPlan at bcd_shards = 2.
    ser = fit(_bcd_cell_cfg().replace(bcd_shards=2), prob["xtr"],
              prob["ytr"], torch.Generator().manual_seed(CONVERGE["seed"]),
              execution="bcd", n_epochs=MESH_BCD_ROUNDS, tol=0.0,
              x_val=prob["xva"], y_val=prob["yva"], device=DEVICE)
    got = torch.from_numpy(np.load(os.path.join(MESH_DIR, "bcd_alpha.npy")))
    want = ser.state.alpha.cpu()
    cond = _bcd_cond(prob, MESH_BCD_ROUNDS)
    tol = 32 * cond * U32
    err = compare(got, want, rtol=0.0, atol=tol, floor=False)
    bd = r0["bcd"]
    check(bd["launches"]["kernel_matvec_cuda"]["sm90"] == MESH_RANKS
          * MESH_BCD_ROUNDS, f"mesh bcd: launches {bd['launches']}")
    print(f"[mesh-d] ({smi}) bcd-cell's problem, {MESH_BCD_ROUNDS} rounds "
          f"on (2, 2) in {bd['seconds']:.2f}s: max |alpha - serial "
          f"(bcd_shards 2)| {err:.3e}, bit-identical "
          f"{torch.equal(got, want)}; tolerance 32 cond(A) u |ref| with "
          f"cond(A) {cond:.4e} (float64, the rounds' largest); val errors "
          f"{[round(v, 4) for v in bd['val']]} against serial "
          f"{[round(h['val_error'], 4) for h in ser.history]}")
    # (b): the protocol on (2, 2).
    pr = [main[r]["protocol"] for r in range(MESH_RANKS)]
    b0 = pr[0]
    check(b0["steps"] == 2 * (MESH_TRAIN_N // 2048),
          f"protocol: {b0['steps']} steps")
    check(b0["val"][-1] < b0["zero"], f"protocol: val error {b0['val'][-1]}"
          f" does not beat the all-zero model's {b0['zero']}")
    print(f"[mesh-b] ({smi}) --execution mesh --data-par 2 --model-par 2 "
          f"--dist-backend gloo --data mmap, {MESH_TRAIN_N} x 54, 2 epochs "
          f"of {MESH_TRAIN_N // 2048} steps: {b0['ms_per_step']:.4f} ms a "
          f"step (rank 0, epoch 2 wall, eval excluded; four ranks share one "
          f"card: not a multi-card figure), the step's two 1,024-float "
          f"all_reduces {b0['ar_ms_per_step']:.4f} ms a step on the host "
          f"(their wait for the kernels included); loader gather_s "
          f"{b0['loader']['gather_s']:.4f} wait_s "
          f"{b0['loader']['wait_s']:.4f}; peak device memory per rank "
          f"{[round(p['peak_mib'], 2) for p in pr]} MiB; val errors "
          f"{[round(v, 6) for v in b0['val']]} (all-zero "
          f"{b0['zero']:.6f}; covertype-train {covertype_err:.6f}); "
          f"launches {b0['launches']}")
    # (b): the epoch-1 checkpoint resumed twice on (4, 1).
    dirs = []
    for i in range(2):
        d = os.path.join(MESH_DIR, f"resume{i}")
        os.makedirs(d)
        shutil.copytree(os.path.join(ckpt, "step_0000000001"),
                        os.path.join(d, "step_0000000001"))
        dirs.append(d)
    res = _torchrun("resume", {"dirs": dirs, "mmap": mmap})
    alphas = [torch.from_numpy(np.load(os.path.join(
        MESH_DIR, f"resume{i}_alpha.npy"))) for i in range(2)]
    rs = res[0]["resume0"]
    check(rs["steps"] == MESH_TRAIN_N // 2048 + MESH_TRAIN_N // 4096,
          f"resume: {rs['steps']} steps")
    r_err = compare(alphas[0], alphas[1], TRAJ_RTOL, TRAJ_ATOL)
    print(f"[mesh-b] ({smi}) epoch-1 checkpoint resumed on (4, 1) twice: "
          f"epoch 2 of {MESH_TRAIN_N // 4096} steps, "
          f"{rs['ms_per_step']:.4f} ms a step; the two resumes differ by "
          f"{r_err:.3e} (bit-identical {torch.equal(*alphas)}); val error "
          f"{rs['val'][-1]:.6f}")
    # (c): a world of one, nccl against gloo, one epoch on the same plan.
    one = {}
    for backend in ("nccl", "gloo"):
        argv = MESH_ARGS + ["--data-par", "1", "--model-par", "1",
                            "--dist-backend", backend, "--epochs", "1",
                            "--mmap-dir", mmap, "--device", DEVICE]
        _reset_dsekl_counters()                 # the 1 x 1 path starts
        out = train.train_dsekl(train.parser().parse_args(argv))
        counts = _dsekl_counts()                # ... and ends here
        check(not dist.is_initialized(), f"{backend}: the world of one "
              "was left initialised")
        st = out["result"]
        one[backend] = (st.state.alpha, counts,
                        st.history[-1]["seconds"] / (MESH_TRAIN_N // 1024)
                        * 1e3)
    c_err = compare(one["nccl"][0], one["gloo"][0], TRAJ_RTOL, TRAJ_ATOL)
    print(f"[mesh-c] ({smi}) a world of one, 1 x 1, one epoch of "
          f"{MESH_TRAIN_N // 1024} steps: nccl {one['nccl'][2]:.4f} ms a "
          f"step, gloo {one['gloo'][2]:.4f}; alphas differ by {c_err:.3e}")
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    secs = time.perf_counter() - t0
    print(f"[mesh] ({smi}) the phase took {secs:.1f}s")
    paths = {"matvec": {}, "vecmat": {}}
    for tag, lc in (("mesh-a parity, 4 ranks", pa["plain"]["launches"]),
                    ("mesh-a compressed", pa["compress"]["launches"]),
                    ("mesh-a EigenPro", pa["precond"]["launches"]),
                    ("mesh-d bcd evals", bd["launches"]),
                    ("mesh-b protocol (2, 2)", b0["launches"]),
                    ("mesh-b resumes (4, 1)",
                     _sum_counts(res[0]["resume0"]["launches"],
                                 res[0]["resume1"]["launches"])),
                    ("mesh-c nccl 1 x 1", one["nccl"][1]),
                    ("mesh-c gloo 1 x 1", one["gloo"][1])):
        paths["matvec"][tag] = lc["kernel_matvec_cuda"]["sm90"]
        paths["vecmat"][tag] = lc["kernel_vecmat_cuda"]["sm90"]
    return {"paths": paths, "seconds": secs, "protocol": b0, "resume": rs,
            "parity": pa, "nccl_ms": one["nccl"][2]}


def _sum_counts(a: dict, b: dict) -> dict:
    return {w: {r: a[w][r] + b[w][r] for r in a[w]} for w in a}


# ---------------------------------------------------------------------------
# Serving on the mesh: four gloo ranks sharing the card.
# ---------------------------------------------------------------------------

MESH_SERVE_DIR = os.path.join(ROOT, "build", "chip_smoke_mesh_serve")
# (a) covertype-serve's engine with its support set over the data axis.
MESH_SERVE_SHAPES = ((4, 1), (2, 2))
# (b) jamba-v0.1-52b at full width (serve-jamba's JAMBA, JAMBA_LAYERS) on
# a (1, 4) mesh: 8 / 2 q / kv heads, 32 SSM heads and 4 experts a rank.
MESH_SERVE_JAMBA = (1, 4)
# (c) the reduced config through the launcher on (2, 2).
MESH_SERVE_REDUCED = ["--arch", "jamba-v0.1-52b", "--data-par", "2",
                      "--model-par", "2", "--dist-backend", "gloo"]
MESH_SERVE_TIMEOUT_S = 480
# (b)'s teacher-forced layers: the largest share of a prefill's tokens an
# MoE layer may dispatch otherwise than the single card (another expert
# set, or kept / dropped otherwise by the capacity).
TEACHER_REROUTED = 0.005
# (b)'s decode steps held to the single card's with the routing fixed.
FORCED_DECODE = 4
# (b)'s float32 run with the routing fixed: x |ref|_inf, the port's
# float32 LM tests' tolerance (tests/test_torch_lm.py).
F32_TOL = 1e-4
# The local shapes of rows 6 and 7 on (1, 4): flash (B, S, T, H, Kv, D,
# causal, window) and the SSD scan (B, S, nh, hd, g, n, chunk).
FLASH_MESH = (4, 2048, 2048, 8, 2, 128, True, 1 << 30)
SSD_MESH = (4, 2048, 32, 64, 1, 16, 256)


class _AllReduceTimer:
    """``torch.distributed.all_reduce`` timed on the host clock while
    active: (numel, seconds, phase) a call, the wait for the device's
    prior work included; the phase is "prefill" or "decode" inside
    ``LanguageModel.prefill`` / ``decode_step``, else "other"."""

    def __enter__(self):
        import torch.distributed as dist
        from repro_torch.models.model import LanguageModel
        self.calls, self.phase = [], "other"
        self._orig = dist.all_reduce
        self._lm = (LanguageModel.prefill, LanguageModel.decode_step)

        def timed(t, *a, **k):
            t0 = time.perf_counter()
            r = self._orig(t, *a, **k)
            self.calls.append((t.numel(), time.perf_counter() - t0,
                               self.phase))
            return r

        def in_phase(fn, phase):
            def run(*a, **k):
                self.phase = phase
                try:
                    return fn(*a, **k)
                finally:
                    self.phase = "other"
            return run

        dist.all_reduce = timed
        LanguageModel.prefill = in_phase(self._lm[0], "prefill")
        LanguageModel.decode_step = in_phase(self._lm[1], "decode")
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        from repro_torch.models.model import LanguageModel
        dist.all_reduce = self._orig
        LanguageModel.prefill, LanguageModel.decode_step = self._lm

    def seconds(self, phase: str):
        """(calls, seconds) of ``phase``."""
        got = [c[1] for c in self.calls if c[2] == phase]
        return len(got), sum(got)


class _MoeRoutes:
    """While active, every MoE call's expert sets: the (tokens, top_k) ids
    its router picks, sorted, call by call in ``sets`` (S > 1 for a
    prefill's, ``prefill_sets`` the last ``n`` of those).  With ``forced``
    (such sets, consumed in order) each call dispatches to the next forced
    set instead, weighted by its own router's probabilities there,
    renormalised: the routing held fixed while rounding differs.  Unforced,
    the call is the port's ``moe_forward``; forced, the same dispatch
    (``_moe_mesh`` / ``_moe_inner``) on those ids.  A token's choices go
    to distinct experts, so their order moves no slot and no sum."""

    def __init__(self, forced=None):
        self.sets, self.seqs = [], []
        self.forced = None if forced is None else list(forced)

    def prefill_sets(self, n: int) -> list:
        return [r for r, s in zip(self.sets, self.seqs) if s > 1][-n:]

    def __enter__(self):
        import torch
        from repro_torch.models import layers, moe
        self._orig = orig = moe.moe_forward

        def routed(p, c, x, with_aux=False, batch_split=False):
            b, s, d = x.shape
            xt = x.reshape(b * s, d)
            probs = torch.softmax(
                xt.float() @ moe.whole_router(p).float(), dim=-1)
            ids = torch.topk(probs, c.top_k, dim=-1)[1].sort(-1)[0]
            self.sets.append(ids.cpu())
            self.seqs.append(s)
            if self.forced is None:
                return orig(p, c, x, with_aux=with_aux,
                            batch_split=batch_split)
            check(not with_aux, "forced routes serve only")
            ids = self.forced.pop(0).to(x.device)
            top = torch.gather(probs, 1, ids)
            top = (top / top.sum(-1, keepdim=True)).to(x.dtype)
            if p.ctx is not None and p.ctx.sharded:
                y = moe._moe_mesh(p, c, xt, ids, top, batch_split)
            else:
                cap = max(1, math.ceil(b * s * c.top_k * c.capacity_factor
                                       / c.n_experts))
                y = moe._moe_inner(xt, ids, top, p.w_gate, p.w_up, p.w_down,
                                   c.n_experts, cap)
            y = y.reshape(b, s, d)
            if c.n_shared_experts:
                y = y + layers.mlp(p.shared, c, x)
            return y

        moe.moe_forward = routed
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.moe_forward = self._orig


def _tensor_save(path: str, t) -> None:
    """``t`` to ``path`` (.npz), bfloat16 kept as its bits."""
    import numpy as np
    import torch
    bf16 = t.dtype == torch.bfloat16
    np.savez(path, x=(t.detach().view(torch.int16) if bf16 else t.detach())
             .cpu().numpy(), bf16=bf16)


def _tensor_load(path: str, device):
    import numpy as np
    import torch
    z = np.load(path)
    t = torch.from_numpy(z["x"])
    return (t.view(torch.bfloat16) if bool(z["bf16"]) else t).to(device)


def _forced_run(model, tokens, feed, sets, steps: int):
    """``model``'s prefill of ``tokens`` and ``steps`` decode steps fed
    ``feed[:, i]``, every MoE call dispatched to the next of ``sets``
    (None: its own routes): the (B, V) logits of each, float32 on the
    host, and the routes."""
    got = []
    with _MoeRoutes(forced=sets) as routes:
        logits, cache = model.prefill(tokens, JAMBA["cache_len"])
        got.append(logits.float().cpu())
        for i in range(steps):
            logits, cache = model.decode_step(feed[:, i], cache,
                                              JAMBA["prompt_len"] + i)
            got.append(logits.float().cpu())
    return got, routes


def _rel(got, ref) -> float:
    """max |got - ref| / |ref|_inf."""
    return float((got - ref).abs().max() / ref.abs().max())


def _jamba_layer_refs(res: dict) -> dict:
    """serve-jamba's single-card run kept for mesh-serve (b): the timed
    prefill's logits, prompts and greedy tokens, and one more prefill of
    the same prompts recorded layer by layer (each layer's input, the
    last one's output; its logits equal the timed one's), then
    FORCED_DECODE decode steps fed the timed run's greedy tokens (their
    logits; each step's argmax the timed run's next token), every MoE
    call's expert sets in order; then the same prefill and steps on
    those expert sets through the plain flash and SSD (``card_noise``: how
    far the card's own logits move by its kernels' rounding alone).
    Saved under MESH_SERVE_DIR."""
    import numpy as np
    import torch
    from repro_torch.models import blocks
    shutil.rmtree(MESH_SERVE_DIR, ignore_errors=True)
    os.makedirs(MESH_SERVE_DIR)
    model, tokens = res["model"], res["tokens"]
    n_moe = sum(blk.is_moe for blk in model.layers)
    xs = []
    orig = blocks.Block.prefill

    def prefill(blk, x, *a, **k):
        xs.append(x)
        out, cache = orig(blk, x, *a, **k)
        if len(xs) == len(model.layers):
            xs.append(out)
        return out, cache

    blocks.Block.prefill = prefill
    steps = []
    try:
        with _MoeRoutes() as routes:
            logits, cache = model.prefill(tokens, JAMBA["cache_len"])
            blocks.Block.prefill = orig
            for i in range(FORCED_DECODE):
                step, cache = model.decode_step(
                    res["out"][:, i], cache, JAMBA["prompt_len"] + i)
                check(torch.equal(torch.argmax(step, dim=-1),
                                  res["out"][:, i + 1]),
                      f"serve-jamba: recorded decode step {i} differs from "
                      "the timed one")
                steps.append(step.float())
    finally:
        blocks.Block.prefill = orig
    del cache
    check(torch.equal(logits, res["logits"]),
          "serve-jamba: a recorded prefill differs from the timed one")
    check(len(routes.sets) == n_moe * (1 + FORCED_DECODE),
          f"serve-jamba: {len(routes.sets)} MoE calls recorded")
    model.impl = "ref"
    try:
        plain, _ = _forced_run(model, tokens, res["out"], routes.sets,
                               FORCED_DECODE)
    finally:
        model.impl = "auto"
    card_noise = [_rel(a, b.cpu()) for a, b in zip(
        plain, [logits.float()] + steps)]
    spec = {"jamba_layers": len(model.layers), "jamba_moe": n_moe,
            "card_noise": card_noise}
    for name, t in (("jamba_logits", res["logits"].float()),
                    ("jamba_steps", torch.stack(steps)),
                    ("jamba_plain", torch.stack(plain)),
                    ("jamba_tokens", tokens), ("jamba_out", res["out"])):
        spec[name] = os.path.join(MESH_SERVE_DIR, f"{name}.npy")
        np.save(spec[name], t.cpu().numpy())
    for i, x in enumerate(xs):
        _tensor_save(os.path.join(MESH_SERVE_DIR, f"jamba_x{i}.npz"), x)
    for i, r in enumerate(routes.sets):
        np.save(os.path.join(MESH_SERVE_DIR, f"jamba_r{i}.npy"), r.numpy())
    return spec


def _dispatch(sets, n_experts: int, capacity: int):
    """(T, k) bool: whether each of a token's experts (its sorted top-k
    set, tokens in order) keeps it, as the MoE's dispatch does: a token
    takes the next slot of each of its experts, and slots past the
    capacity drop."""
    import torch
    onehot = torch.nn.functional.one_hot(sets, n_experts).sum(1)   # (T, E)
    pos = torch.cumsum(onehot, dim=0) - onehot                     # earlier
    return torch.gather(pos, 1, sets) < capacity


def _jamba_f32(spec: dict, ctx=None):
    """serve-jamba's configuration in float32 from JAMBA's seed: the whole
    model on the card (``ctx`` None) or this rank's slices of the same
    draws."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import LanguageModel
    cfg = get_config("jamba-v0.1-52b").replace(
        n_layers=JAMBA_LAYERS, param_dtype="float32",
        compute_dtype="float32")
    gen = torch.Generator(device=DEVICE).manual_seed(JAMBA["seed"])
    return LanguageModel(cfg, device=DEVICE, ctx=ctx).init(gen)


def _jamba_f32_ref(spec: dict) -> dict:
    """mesh-serve (b)'s float32 reference on the one card: ``_jamba_f32``'s
    prefill of serve-jamba's prompts and FORCED_DECODE decode steps fed
    its greedy tokens, the logits of each and every MoE call's expert
    sets saved under MESH_SERVE_DIR (the model freed after)."""
    import numpy as np
    import torch
    model = _jamba_f32(spec)
    tokens = torch.from_numpy(np.load(spec["jamba_tokens"])).to(DEVICE)
    feed = torch.from_numpy(np.load(spec["jamba_out"])).to(DEVICE)
    got, routes = _forced_run(model, tokens, feed, None, FORCED_DECODE)
    del model
    torch.cuda.empty_cache()
    out = {"jamba_f32_logits": os.path.join(MESH_SERVE_DIR,
                                            "jamba_f32_logits.npy")}
    np.save(out["jamba_f32_logits"], torch.stack(got).numpy())
    for i, r in enumerate(routes.sets):
        np.save(os.path.join(MESH_SERVE_DIR, f"jamba_f32_r{i}.npy"),
                r.numpy())
    return out


def _forced_routes(model, tokens, spec: dict, sets: str, refs) -> dict:
    """The sharded ``model``'s prefill of the single card's prompts and
    FORCED_DECODE decode steps fed the single card's greedy tokens, every
    MoE call dispatched to the single card's recorded expert sets (files
    ``{sets}{i}.npy``; the capacity is the single card's: one data
    shard): each step's max |err| / |ref|_inf against ``refs`` (1 +
    FORCED_DECODE logits), and the prefill tokens the rank's own router
    would have sent elsewhere, by MoE layer."""
    import numpy as np
    import torch
    n = spec["jamba_moe"] * (1 + FORCED_DECODE)
    recorded = [torch.from_numpy(np.load(os.path.join(
        spec["dir"], f"{sets}{i}.npy"))) for i in range(n)]
    feed = torch.from_numpy(np.load(spec["jamba_out"])).to(model.device)
    got, routes = _forced_run(model, tokens, feed, recorded, FORCED_DECODE)
    check(len(routes.forced) == 0, f"(b) forced: {len(routes.forced)} of "
          f"{n} expert sets left unused")
    check(all(bool(torch.isfinite(g).all()) for g in got),
          "(b) forced: logits not finite")
    own = [int((a.cpu() != b).any(-1).sum())
           for a, b in zip(routes.sets[:spec["jamba_moe"]], recorded)]
    return {"err": [_rel(g, r) for g, r in zip(got, refs)], "own": own}


def _mesh_serve_forced(res: dict, spec: dict, ctx) -> dict:
    """(b) with the routing held fixed (``_forced_routes``).  In bf16,
    reported: against serve-jamba's card, and the prefill again with
    every contraction-split product's partials rounded to bf16 before
    their psum (``psum_product``'s alternative).  Then in float32
    (``_jamba_f32`` on the rank, ``res`` emptied and the bf16 model freed
    first), gated:
    every step's logits within F32_TOL x |ref|_inf of the card's float32
    run (``_jamba_f32_ref``)."""
    import gc

    import numpy as np
    import torch
    from repro_torch.distributed import collectives
    model, tokens = res.pop("model"), res["tokens"]
    res.clear()
    refs = [torch.from_numpy(np.load(spec["jamba_logits"]))] + list(
        torch.from_numpy(np.load(spec["jamba_steps"])))
    bf16 = _forced_routes(model, tokens, spec, "jamba_r", refs)
    product = collectives.psum_product
    collectives.psum_product = (
        lambda op, x, w, ctx, axes: collectives.psum(op(x, w), ctx, axes))
    try:
        sets = [torch.from_numpy(np.load(os.path.join(
            spec["dir"], f"jamba_r{i}.npy")))
            for i in range(spec["jamba_moe"])]
        partials = _rel(_forced_run(model, tokens, None, sets, 0)[0][0],
                        refs[0])
    finally:
        collectives.psum_product = product
    del model
    gc.collect()
    torch.cuda.empty_cache()
    f32_refs = list(torch.from_numpy(np.load(spec["jamba_f32_logits"])))
    f32_model = _jamba_f32(spec, ctx)
    f32 = _forced_routes(f32_model, tokens, spec, "jamba_f32_r", f32_refs)
    for i, e in enumerate(f32["err"]):
        check(e <= F32_TOL, f"(b) float32, routing fixed, "
              f"{'prefill' if i == 0 else f'decode {i}'}: logits {e:.4e} x "
              f"|ref|_inf from the single card's, limit {F32_TOL}")
    # dryrun (b): the same weights under the dry-run's decode override,
    # the KV caches' slots over the model axis (kv_seq), q gathered over it.
    kv = _forced_routes(_with_ctx(f32_model, _kv_seq_ctx(ctx)), tokens,
                        spec, "jamba_f32_r", f32_refs)
    layouts = [blk.layout for blk in f32_model.layers
               if blk.layout is not None]
    check(layouts and all(lay.seq_axes == "model" for lay in layouts),
          f"dryrun (b): cache layouts {layouts}")
    for i, e in enumerate(kv["err"]):
        check(e <= F32_TOL, f"dryrun (b) kv_seq over model, float32, "
              f"{'prefill' if i == 0 else f'decode {i}'}: logits {e:.4e} x "
              f"|ref|_inf from the single card's, limit {F32_TOL}")
    del f32_model
    gc.collect()
    torch.cuda.empty_cache()
    return {"forced_err": bf16["err"], "forced_own": bf16["own"],
            "forced_bf16_err": partials, "f32_err": f32["err"],
            "f32_own": f32["own"], "kvseq_err": kv["err"],
            "kvseq_slots": [lay.hi - lay.lo for lay in layouts]}


def _kv_seq_ctx(ctx):
    """``ctx``'s mesh under the decode rules with the dry-run's override:
    ``kv_seq`` over the model axis."""
    from repro_torch.distributed.sharding import MeshCtx
    return MeshCtx.for_mesh(ctx.mesh, "decode", {"kv_seq": "model"})


def _with_ctx(model, ctx):
    """``model`` (its parameters untouched) under ``ctx``, a context of the
    same mesh whose rules lay the parameters out alike (they differ in
    the caches' rules alone)."""
    from repro_torch.nn.module import ParamTree
    model.ctx = ctx
    for m in model.modules():
        if isinstance(m, ParamTree):
            m.ctx = ctx
    return model


def _mesh_serve_engine(spec: dict) -> dict:
    """(a) covertype-serve's engine through the launcher on each of
    MESH_SERVE_SHAPES (``serve_dsekl`` with ``--data-par`` /
    ``--model-par``, ``flush_async``), its answers against the single-card
    engine's; then the same sharded engine built here, ``predict`` on the
    queries.  Every matvec launch of the launcher's run on the sm90 route,
    one a serve call."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.serving import DSEKLPredictionEngine
    f_ref = torch.from_numpy(np.load(spec["f_ref"]))
    out = {}
    for d, m in MESH_SERVE_SHAPES:
        argv = SERVE_ARGS + ["--data-par", str(d), "--model-par", str(m),
                             "--dist-backend", "gloo", "--device", DEVICE]
        _reset_dsekl_counters()                 # the launcher's path starts
        with _AllReduceTimer() as art:
            run = serve.serve_dsekl(serve.parser().parse_args(argv))
            torch.cuda.synchronize()
        counts = _dsekl_counts()                # ... and ends here
        eng = run["engine"]
        check(eng.n_shards == d, f"(a) {d} x {m}: {eng.n_shards} shards")
        mv = counts["kernel_matvec_cuda"]
        check(mv == {"sm90": eng.serve_calls, "fp32": 0} and all(
            sum(counts[w].values()) == 0 for w in counts
            if w != "kernel_matvec_cuda"),
            f"(a) {d} x {m}: launches {counts}, serve calls "
            f"{eng.serve_calls}")
        err = compare(torch.cat(run["outs"]).cpu(), f_ref)
        direct = DSEKLPredictionEngine(
            eng.cfg, run["alpha"], run["x_train"],
            engine_cfg=eng.engine_cfg, mesh=run["mesh"]).predict(
                run["queries"]).cpu()
        err_direct = compare(direct, f_ref)
        ar = [c[1] for c in art.calls if c[0] == eng.engine_cfg.query_block]
        st = eng.stats()
        out[f"{d}x{m}"] = {
            "n_shards": st["n_shards"], "rows": st["sv_rows_per_shard"],
            "padded": st["n_sv_padded"], "serve_calls": eng.serve_calls,
            "launches": mv, "qps": run["queries_per_s"],
            "ar_ms": 1e3 * sum(ar) / max(len(ar), 1), "ar_n": len(ar),
            "err": err, "err_direct": err_direct,
            "top": float(f_ref.abs().max())}
        del run, eng, direct
        torch.cuda.empty_cache()
    return out


def _mesh_serve_jamba(spec: dict) -> dict:
    """(b) serve-jamba's run at full width on a (1, 4) mesh through
    ``serve_lm(ctx=...)``: each rank draws the same weights' slices and
    prompts; its flash and SSD launches counted and each held against its
    plain version; the prefill's logits against serve-jamba's."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import MeshCtx
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import attention, ssm
    cfg = get_config("jamba-v0.1-52b").replace(n_layers=JAMBA_LAYERS)
    n_attn = cfg.layer_pattern.count("attn")
    n_mamba = cfg.layer_pattern.count("mamba")
    ctx = MeshCtx.for_mesh(make_local_mesh(*MESH_SERVE_JAMBA,
                                           backend="gloo", device=DEVICE),
                           "decode")
    rank = ctx.mesh.rank
    flash_calls, ssd_calls = [], []
    undo = [_recorder(attention, "flash_attention", flash_calls, n_attn),
            _recorder(ssm, "ssd_chunked", ssd_calls, n_mamba)]
    n_moe = sum(cfg.moe_pattern)
    _reset_lm_counters()                        # the mesh's path starts
    try:
        with _AllReduceTimer() as art, _MoeRoutes() as routes:
            res = serve.serve_lm(cfg, device=DEVICE, ctx=ctx, **JAMBA)
    finally:
        for fn in undo:
            fn()
    flash = dict(fk.flash_attention_cuda.launches_by_route)  # ... ends
    ssd = dict(sk.ssd_cuda.launches_by_route)
    prefills = res["prefills"]
    check(flash == {"sm90": n_attn * prefills, "fp32": 0} and ssd == {
        "sm90": n_mamba * prefills, "fp32": 0},
        f"(b) rank {rank}: flash {flash}, ssd {ssd}; expected {n_attn} and "
        f"{n_mamba} sm90 launches a prefill")
    q, k, _ = flash_calls[0][0]
    x = ssd_calls[0][0][0]
    shapes = {"flash q": tuple(q.shape), "flash k": tuple(k.shape),
              "ssd x": tuple(x.shape)}
    check(shapes["flash q"][2] == cfg.n_heads // 4
          and shapes["flash k"][2] == cfg.n_kv_heads // 4
          and shapes["ssd x"][2] == cfg.ssm_heads // 4,
          f"(b) rank {rank}: local shapes {shapes}")
    _hold_main_path(flash_calls, ssd_calls, tag=f"mesh-serve-b rank {rank}")
    del flash_calls, ssd_calls, q, k, x
    ref = torch.from_numpy(np.load(spec["jamba_logits"]))
    tokens = torch.from_numpy(np.load(spec["jamba_tokens"]))
    check(torch.equal(res["tokens"].cpu(), tokens),
          f"(b) rank {rank}: the prompts differ from serve-jamba's")
    logits = res["logits"].float().cpu()
    check(tuple(logits.shape) == (JAMBA["batch"], cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"(b): logits {tuple(logits.shape)}, finite "
          f"{bool(torch.isfinite(logits).all())}")
    # The free-running prefill against the single card's: reported, with
    # the tokens each MoE layer routed to another expert set.
    scale = float(ref.abs().max())
    err = float((logits - ref).abs().max())
    free_rerouted = [int((r != torch.from_numpy(np.load(os.path.join(
        spec["dir"], f"jamba_r{i}.npy")))).any(-1).sum())
        for i, r in enumerate(routes.prefill_sets(n_moe))]
    agree = float((res["out"].cpu() == torch.from_numpy(
        np.load(spec["jamba_out"]))).float().mean())
    teacher = _teacher_forced(res["model"], cfg, JAMBA, spec["dir"],
                              "jamba")
    weights = sum(p.numel() * p.element_size()
                  for p in res["model"].parameters())
    n_pre, s_pre = art.seconds("prefill")
    n_dec, s_dec = art.seconds("decode")
    out = {"flash": flash["sm90"], "ssd": ssd["sm90"], "shapes": shapes,
           "err": err, "scale": scale, "agree": agree,
           "free_rerouted": free_rerouted, **teacher,
           "prefill_ms": res["prefill_s"] * 1e3,
           "decode_ms": res["decode_ms_per_step"],
           "init_s": res["init_s"], "peak_gib": res["peak_bytes"] / 2**30,
           "weights_gib": weights / 2**30,
           "ar_prefill_ms": 1e3 * s_pre / prefills,
           "ar_prefill_n": n_pre / prefills,
           "ar_decode_ms": 1e3 * s_dec / JAMBA["new_tokens"],
           "ar_decode_n": n_dec / JAMBA["new_tokens"]}
    out.update(_mesh_serve_forced(res, spec, ctx))
    return out


def _mesh_serve_reduced() -> dict:
    """(c) the reduced jamba through the launcher on (2, 2): the ZeRO
    weights' gathers over data, the MoE's expert-batch gather and
    psum-scatter, the batch over data.  Held to the single-device port's
    reduced run on the same seed, on each data shard's half of the batch
    (the MoE's capacity is per data shard, as JAX's)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.launch import serve
    from repro_torch.models.model import LanguageModel
    ap = serve.parser()
    args = ap.parse_args(MESH_SERVE_REDUCED + ["--device", DEVICE])
    _reset_lm_counters()                        # the launcher's path starts
    before = dict(collectives.COUNTS)
    res = serve.lm_main(ap, args)
    flash = dict(fk.flash_attention_cuda.launches_by_route)  # ... ends
    ssd = dict(sk.ssd_cuda.launches_by_route)
    used = {k: v - before.get(k, 0) for k, v in collectives.COUNTS.items()
            if v - before.get(k, 0)}
    cfg = get_config(args.arch, reduced=True)
    check(sum(flash.values()) == 2 * cfg.layer_pattern.count("attn")
          and sum(ssd.values()) == 2 * cfg.layer_pattern.count("mamba"),
          f"(c): flash {flash}, ssd {ssd}")
    # gloo gathers a CUDA tensor by the slot stack alone.
    gather = "slots" if torch.device(DEVICE).type == "cuda" else "native"
    check(all(used.get(k, 0) > 0 for k in (
        f"all_gather:{gather}", "psum_scatter:all_reduce",
        "psum:all_reduce")), f"(c): collectives {used}")
    gen = torch.Generator(device=DEVICE).manual_seed(args.seed)
    model = LanguageModel(cfg, device=DEVICE).init(gen)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=DEVICE)
    check(torch.equal(tokens, res["tokens"]), "(c): prompts differ")
    halves = tokens.chunk(2)
    ref = torch.cat([model.prefill(t, args.cache_len)[0] for t in halves])
    whole = model.prefill(tokens, args.cache_len)[0]
    scale = float(ref.abs().max())
    err = float((res["logits"] - ref).abs().max())
    check(err <= LOGITS_TOL * scale, f"(c): logits {err:.4e} from the "
          f"single-device run's, limit {LOGITS_TOL * scale:.4e}")
    return {"flash": flash, "ssd": ssd, "collectives": used, "err": err,
            "limit": LOGITS_TOL * scale,
            "whole_err": float((res["logits"] - whole).abs().max()),
            "prefill_ms": res["prefill_s"] * 1e3,
            "decode_ms": res["decode_ms_per_step"]}


# ---------------------------------------------------------------------------
# dryrun: the production dry-run (launch/dryrun.py) held against the card.
# ---------------------------------------------------------------------------

# (a) Three steps the card already runs, traced on the meta device with the
# dry-run's builders and then run for real: serve-jamba's prefill, the
# DSEKL mesh step on a world of one at the covertype protocol's shape, and
# lm-train's step.  The traced peak (arguments + temp) is held to the
# card's within DRYRUN_PEAK_TOL (the limit written in PERF.md before the
# first card run).
DRYRUN_PEAK_TOL = 0.20
DRYRUN_DSEKL = dict(n=559_888, d=54, per_rank=1024)
# (c) Production cells traced on this host.
DRYRUN_CELLS = [("mamba2-780m", s, False) for s in
                ("train_4k", "prefill_32k", "decode_32k", "long_500k")] + [
    ("dsekl", "dsekl_covtype", False), ("dsekl", "dsekl_covtype", True),
    ("deepseek-v3-671b", "decode_32k", False)]
DRYRUN_DIR = os.path.join(ROOT, "build", "chip_smoke_dryrun")
# Calls a reading of the kernel ops' dispatch cost, and its shapes: the
# serve flush's matvec (a query block against covertype's support set) and
# covertype-train's step's vecmat (I = J = 1,024), (I, J, D); flash and the
# SSD at FLASH_SERVED / SSD_SERVED.
DISPATCH_CALLS = 64
DISPATCH_MATVEC = (4096, 65_536, 54)
DISPATCH_VECMAT = (1024, 1024, 54)


def _launch_counts() -> dict:
    """Every traceable kernel op's launches by route, keyed as the trace
    keys them."""
    from repro_torch.kernels.dsekl import block
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.kernels.ssd import kernel as sk
    out = {}
    for op, fn in (("kernel_matvec", block.kernel_matvec_cuda),
                   ("kernel_vecmat", block.kernel_vecmat_cuda),
                   ("flash_attention", fk.flash_attention_cuda),
                   ("ssd", sk.ssd_cuda)):
        routes = {k: v for k, v in fn.launches_by_route.items() if v}
        if routes:
            out[op] = routes
    return out


def _card_run(cell, grad: bool) -> dict:
    """``cell``'s step on the card once: its launches by op and route, and
    its peak (the card's ``max_memory_allocated`` after a reset, less what
    was allocated before the step other than the step's arguments)."""
    import torch
    from repro_torch.launch import dryrun
    args = dryrun.tree_bytes(cell.args)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    _reset_lm_counters()                         # the step starts here
    with contextlib.nullcontext() if grad else torch.no_grad():
        out = cell.fn(*cell.args)
    torch.cuda.synchronize()
    launches = _launch_counts()                  # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    del out
    return {"launches": launches, "peak": peak - (before - args),
            "raw_peak": peak, "before": before, "args": args}


def _dryrun_step(tag: str, build, grad: bool, init=None) -> dict:
    """``build(device, impl)`` -> a Cell: traced on meta, then run on the
    card; the launches by op and route equal, the peaks within
    DRYRUN_PEAK_TOL."""
    import gc

    import torch
    from repro_torch.launch import dryrun
    meta = build("meta")
    with contextlib.nullcontext() if grad else torch.no_grad():
        rec = dryrun.trace_cell(meta)
    del meta
    mem = rec["memory_analysis"]
    traced = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    cell = build(DEVICE)
    if init is not None:
        init(cell)
    card = _card_run(cell, grad)
    del cell
    gc.collect()
    torch.cuda.empty_cache()
    ratio = card["peak"] / traced
    print(f"[dryrun] (a) {tag}: traced launches {rec['kernels']}, the "
          f"card's {card['launches']}; traced peak {traced / 2**30:.4f} GiB "
          f"(arguments {mem['argument_size_in_bytes'] / 2**30:.4f} + temp "
          f"{mem['temp_size_in_bytes'] / 2**30:.4f}), the card's "
          f"{card['peak'] / 2**30:.4f} GiB = {ratio:.4f} x traced (raw "
          f"max_memory_allocated {card['raw_peak'] / 2**30:.4f} GiB, "
          f"{card['before'] / 2**30:.4f} allocated before, of which "
          f"{card['args'] / 2**30:.4f} the arguments); trace "
          f"{rec['seconds_trace']:.2f} s, {rec['cost_analysis']['flops']:.4e}"
          " flops")
    check(rec["kernels"] == card["launches"],
          f"dryrun (a) {tag}: traced launches {rec['kernels']} != the "
          f"card's {card['launches']}")
    check(abs(ratio - 1.0) <= DRYRUN_PEAK_TOL,
          f"dryrun (a) {tag}: the card's peak is {ratio:.4f} x the traced "
          f"one, limit 1 +- {DRYRUN_PEAK_TOL}")
    return {"traced_launches": rec["kernels"], "launches": card["launches"],
            "traced_peak": traced, "peak": card["peak"], "ratio": ratio,
            "raw_peak": card["raw_peak"], "flops": rec["cost_analysis"][
                "flops"], "seconds_trace": rec["seconds_trace"]}


def _dispatch_costs() -> dict:
    """Each kernel op's added host cost a call: its CUDA wrapper (through
    the ``torch.library`` op) against its CUDA body called directly, on
    the same inputs at a main-path shape, DISPATCH_CALLS calls a reading,
    readings in the order op, body, body, op (twice), medians; the
    launch counters are restored after.  Microseconds a call."""
    import torch
    from repro_torch.kernels.dsekl import block
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.kernels.ssd import kernel as sk
    saved = [(f, f.launches, dict(f.launches_by_route)) for f in (
        block.kernel_matvec_cuda, block.kernel_vecmat_cuda,
        fk.flash_attention_cuda, sk.ssd_cuda)]
    gen = torch.Generator().manual_seed(11)

    def rnd(*shape, dtype=torch.float32):
        return _rand(shape, gen, DEVICE, dtype)

    q_flash = FLASH_SERVED
    b, s, h, kv, d = q_flash
    bf = torch.bfloat16
    fq, fkk, fv = rnd(b, s, h, d, dtype=bf), rnd(b, s, kv, d, dtype=bf), \
        rnd(b, s, kv, d, dtype=bf)
    sb, ss, nh, hd, g, n, chunk = SSD_SERVED
    sx, sdt = rnd(sb, ss, nh, hd, dtype=bf), (0.1 * rnd(sb, ss, nh)).abs().to(
        bf)
    sa = -rnd(nh).abs()
    sbm, scm = rnd(sb, ss, g, n, dtype=bf), rnd(sb, ss, g, n, dtype=bf)
    mi, mj, md = DISPATCH_MATVEC
    qx, zx, a = rnd(mi, md), rnd(mj, md), rnd(mj)
    vi, vj, vd = DISPATCH_VECMAT
    xi, xj, v = rnd(vi, vd), rnd(vj, vd), rnd(vi)
    scal = block._op_scalars("kernel_matvec_cuda", "rbf", None)
    cases = {
        f"kernel_matvec (serve flush: {mi:,} x {mj:,}, D {md})": (
            lambda: block.kernel_matvec_cuda(qx, zx, a),
            lambda: block._matvec_body(qx, zx, a, "rbf", *scal)),
        f"kernel_vecmat (covertype-train step: {vi:,} x {vj:,}, D {vd})": (
            lambda: block.kernel_vecmat_cuda(xi, xj, v),
            lambda: block._vecmat_body(xi, xj, v, "rbf", *scal)),
        "flash_attention (serve-jamba prefill)": (
            lambda: fk.flash_attention_cuda(fq, fkk, fv),
            lambda: fk._body(fq, fkk, fv, True, 1 << 30)),
        "ssd (serve-jamba prefill)": (
            lambda: sk.ssd_cuda(sx, sdt, sa, sbm, scm, chunk=chunk),
            lambda: sk._body(sx, sdt, sa, sbm, scm, chunk)),
    }
    out = {}
    for key, (op, body) in cases.items():
        op(), body()
        torch.cuda.synchronize()
        readings = {"op": [], "body": []}
        for which in ("op", "body", "body", "op") * 2:
            fn = op if which == "op" else body
            t0 = time.perf_counter()
            for _ in range(DISPATCH_CALLS):
                fn()
            readings[which].append((time.perf_counter() - t0)
                                   / DISPATCH_CALLS)
            torch.cuda.synchronize()
        op_us = 1e6 * statistics.median(readings["op"])
        body_us = 1e6 * statistics.median(readings["body"])
        out[key] = {"op_us": op_us, "body_us": body_us,
                    "added_us": op_us - body_us}
        print(f"[dryrun] dispatch {key}: the op {op_us:.2f} us a call, the "
              f"body {body_us:.2f} us: +{op_us - body_us:.2f} us")
    for f, n, routes in saved:
        f.launches, f.launches_by_route = n, routes
    return out


def phase_dryrun(name: str) -> dict:
    """The production dry-run against the card: (a) three steps traced with
    the dry-run's builders and run for real (launches by op and route
    equal; peak within DRYRUN_PEAK_TOL); the kernel ops' dispatch cost;
    (c) a few production cells traced on this host, each record ok, their
    per-rank GiB beside the card's memory.  (b), jamba's decode with the
    cache's slots over the model axis on (1, 4), runs in mesh-serve's
    ranks (``_mesh_serve_forced``)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    check(not dist.is_initialized(), "dryrun: a process group is up")
    out = {"steps": {}}
    cells = _dryrun_cells_start()          # (c) runs on the host meanwhile

    def jamba(device):
        return dryrun.build_cell(
            "jamba-v0.1-52b", "prefill_32k", None, n_layers=JAMBA_LAYERS,
            batch=JAMBA["batch"], seq_len=JAMBA["prompt_len"], device=device)

    def lm_train(device):
        return dryrun.build_cell(
            LM_TRAIN["arch"], "train_4k", None, n_layers=LM_TRAIN["layers"],
            batch=LM_TRAIN["batch"], seq_len=LM_TRAIN["seq"], device=device)

    def seeded(cell):
        cell.model.init(torch.Generator(device=DEVICE).manual_seed(3))

    try:
        out["steps"]["serve-jamba prefill"] = _dryrun_step(
            "serve-jamba prefill", jamba, grad=False, init=seeded)
        out["steps"]["dsekl mesh step (1 x 1)"] = _dryrun_dsekl()
        out["steps"]["lm-train step"] = _dryrun_step(
            "lm-train step", lm_train, grad=True, init=seeded)
        out["dispatch"] = _dispatch_costs()
        out["cells"] = _dryrun_cells(cells, name)
    finally:
        for _, _, proc in cells:         # none left running on a failure
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out["seconds"] = time.perf_counter() - t0
    print(f"[dryrun] phase {out['seconds']:.1f} s")
    return out


def _dryrun_dsekl() -> dict:
    """(a)'s DSEKL step at the covertype protocol's shape: traced on a fake
    world of one, closed before the card's world of one (gloo) starts,
    where the same step runs on random rows and a random plan."""
    import gc

    import torch
    from repro_torch.launch import dryrun, mesh as mesh_lib
    fake = mesh_lib.make_fake_mesh((1, 1), mesh_lib.MESH_AXES)
    try:
        meta = dryrun.build_dsekl_cell("dsekl_covtype", fake, device="meta",
                                       **DRYRUN_DSEKL)
        rec = dryrun.trace_cell(meta)
        del meta
    finally:
        fake.close()
    mem = rec["memory_analysis"]
    traced = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    mesh = mesh_lib.make_local_mesh(1, 1, backend="gloo", device=DEVICE)
    try:
        cell = dryrun.build_dsekl_cell("dsekl_covtype", mesh, device=DEVICE,
                                       **DRYRUN_DSEKL)
        gen = torch.Generator(device=DEVICE).manual_seed(5)
        x_grad, y_grad, x_exp, state, plan = cell.args
        with torch.no_grad():
            x_grad.normal_(generator=gen)
            x_exp.copy_(x_grad)
            y_grad.copy_(torch.sign(x_grad[:, 0]))
            for idx in plan:
                idx.copy_(torch.randint(0, x_grad.shape[0], idx.shape,
                                        generator=gen, device=DEVICE))
        card = _card_run(cell, grad=False)
        del cell, x_grad, y_grad, x_exp, state, plan
    finally:
        mesh.close()
    gc.collect()
    torch.cuda.empty_cache()
    ratio = card["peak"] / traced
    print(f"[dryrun] (a) dsekl mesh step (1 x 1, N {DRYRUN_DSEKL['n']:,}, "
          f"D {DRYRUN_DSEKL['d']}, I = J = {DRYRUN_DSEKL['per_rank']:,}): "
          f"traced launches {rec['kernels']}, the card's "
          f"{card['launches']}; traced peak {traced / 2**30:.4f} GiB, the "
          f"card's {card['peak'] / 2**30:.4f} GiB = {ratio:.4f} x traced")
    check(rec["kernels"] == card["launches"],
          f"dryrun (a) dsekl: traced launches {rec['kernels']} != the "
          f"card's {card['launches']}")
    check(abs(ratio - 1.0) <= DRYRUN_PEAK_TOL,
          f"dryrun (a) dsekl: the card's peak is {ratio:.4f} x the traced "
          f"one, limit 1 +- {DRYRUN_PEAK_TOL}")
    return {"traced_launches": rec["kernels"], "launches": card["launches"],
            "traced_peak": traced, "peak": card["peak"], "ratio": ratio,
            "raw_peak": card["raw_peak"],
            "flops": rec["cost_analysis"]["flops"],
            "seconds_trace": rec["seconds_trace"]}


def _dryrun_cells_start() -> list:
    """(c): DRYRUN_CELLS through the dry-run's command line, one
    subprocess each, all started at once (they run on the host while (a)
    runs on the card)."""
    from repro_torch.launch import dryrun
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=SRC)
    return [(cell, time.perf_counter(), subprocess.Popen(
        dryrun._cell_cmd(*cell, DRYRUN_DIR), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for cell in DRYRUN_CELLS]


def _dryrun_cells(procs: list, name: str) -> dict:
    """(c)'s records: every one ok; per-rank GiB (arguments + temp)
    beside the card's memory."""
    import torch
    from repro_torch.launch import dryrun
    card = torch.cuda.get_device_properties(0).total_memory
    out = {}
    t0 = min(t for _, t, _ in procs)
    for cell, _, proc in procs:
        _, err = proc.communicate(timeout=600)
        arch, shape, multi_pod = cell
        path = dryrun.cell_path(DRYRUN_DIR, arch, shape, multi_pod)
        check(proc.returncode == 0 and os.path.exists(path),
              f"dryrun (c) {cell}: exit {proc.returncode}: {err[-2000:]}")
        with open(path) as f:
            rec = json.load(f)
        check(rec.get("ok") is True, f"dryrun (c) {cell}: not ok")
        gib = rec["per_rank_bytes"] / 2**30
        key = f"{arch} x {shape} x {rec['mesh']}"
        out[key] = {"per_rank_gib": gib, "flops": rec["cost_analysis"][
            "flops"], "collective_bytes": rec["collectives"]["total_bytes"],
            "kernels": rec["kernels"], "seconds": rec["seconds"]}
        print(f"[dryrun] (c) {key}: {gib:.3f} GiB a rank (the card {name} "
              f"holds {card / 2**30:.2f} GiB), {rec['cost_analysis']['flops']:.4e} "
              f"flops, {rec['collectives']['total_bytes']:.4e} collective "
              f"bytes, kernels {rec['kernels']}, {rec['seconds']:.1f} s")
    print(f"[dryrun] (c) {len(out)} cells in {time.perf_counter() - t0:.1f} s"
          " from their start")
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    return out


def phase_mesh_serve(serve_f, jamba_ref: dict, smi: str,
                     device_name: str) -> dict:
    """Serving on a mesh of four gloo ranks sharing the card (``jamba_ref``:
    ``_jamba_layer_refs``'s files of serve-jamba's run), under
    ``torch.distributed.run`` (the parent built every kernel; a rank that
    runs nvcc fails): (a) covertype-serve's sharded engine on (4, 1) and
    (2, 2); (b) jamba-v0.1-52b at full width on (1, 4); (c) the reduced
    jamba on (2, 2) through the launcher.  Then the flash and SSD kernels
    timed alone at (b)'s local shapes.  Four ranks share one card: no
    figure here is a multi-card one."""
    import gc

    import numpy as np
    import torch
    t0 = time.perf_counter()
    spec = dict(jamba_ref, f_ref=os.path.join(MESH_SERVE_DIR, "f_ref.npy"))
    np.save(spec["f_ref"], serve_f.numpy())
    gc.collect()
    torch.cuda.empty_cache()
    spec.update(_jamba_f32_ref(spec))
    print(f"[mesh-serve] the parent holds {torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB of device memory while the ranks run")
    res = _torchrun("serve", spec, where=MESH_SERVE_DIR,
                    timeout_s=MESH_SERVE_TIMEOUT_S)
    label = f"({smi}; four gloo ranks share the one card)"
    paths = {"matvec": {}, "flash": {}, "ssd": {}}
    for shape in (f"{d}x{m}" for d, m in MESH_SERVE_SHAPES):
        a = [res[r]["a"][shape] for r in range(MESH_RANKS)]
        launches = sum(x["launches"]["sm90"] for x in a)
        paths["matvec"][f"mesh-serve (a) {shape}, 4 ranks"] = launches
        print(f"[mesh-serve-a] {label} covertype-serve's engine on "
              f"{shape.replace('x', ' x ')}: {a[0]['n_shards']} shards of "
              f"{a[0]['rows']} support rows (padded {a[0]['padded']}), "
              f"{a[0]['qps']:.1f} queries/s through flush_async (rank 0; "
              f"{[round(x['qps'], 1) for x in a]} by rank), the f "
              f"all_reduce {a[0]['ar_ms']:.4f} ms a serve call on the host "
              f"({a[0]['ar_n']} calls; its wait for the kernel included); "
              f"{launches} sm90 matvec launches = the ranks' serve calls "
              f"{sum(x['serve_calls'] for x in a)}; max abs err against the "
              f"single-card engine {max(x['err'] for x in a):.3e} (launcher)"
              f", {max(x['err_direct'] for x in a):.3e} (predict) of |f| "
              f"{a[0]['top']:.3e} (rtol {RTOL}, atol {ATOL} x max(1, |f|))")
    b = [res[r]["b"] for r in range(MESH_RANKS)]
    paths["flash"]["mesh-serve (b) (1, 4), 4 ranks"] = sum(
        x["flash"] for x in b)
    paths["ssd"]["mesh-serve (b) (1, 4), 4 ranks"] = sum(x["ssd"] for x in b)
    b0 = b[0]
    print(f"[mesh-serve-b] {label} jamba-v0.1-52b, {JAMBA_LAYERS} layers at "
          f"full width on (1, 4), {JAMBA['batch']} x {JAMBA['prompt_len']} "
          f"tokens, {JAMBA['new_tokens']} greedy: prefill "
          f"{b0['prefill_ms']:.3f} ms, decode {b0['decode_ms']:.4f} ms a "
          f"step (rank 0; host clock, each ending in a sync); the step's "
          f"all_reduces on the host: {b0['ar_prefill_ms']:.3f} ms a prefill "
          f"({b0['ar_prefill_n']:.0f} calls), {b0['ar_decode_ms']:.4f} ms a "
          f"decode step ({b0['ar_decode_n']:.1f} calls); init "
          f"{b0['init_s']:.2f}s; peak "
          f"device memory per rank {[round(x['peak_gib'], 2) for x in b]} "
          f"GiB, of it {b0['weights_gib']:.2f} GiB of weight shards; local "
          f"shapes {b0['shapes']}; per rank {b0['flash']} flash and "
          f"{b0['ssd']} ssd launches (2 prefills), all sm90")
    print(f"[mesh-serve-b] {label} the routing held fixed (every MoE call "
          f"dispatched to the single card's expert sets), max abs err / "
          f"|ref|_inf of the prefill's logits and {FORCED_DECODE} decode "
          f"steps fed the single card's tokens: float32 (the same draws) "
          f"{[float(f'{e:.4g}') for e in b0['f32_err']]} (limit "
          f"{F32_TOL}; max over ranks "
          f"{max(max(x['f32_err']) for x in b):.4g}; own routers would have "
          f"sent elsewhere {b0['f32_own']} prefill tokens by MoE layer); "
          f"bf16, not gated, {[round(e, 6) for e in b0['forced_err']]} "
          f"(own routers {b0['forced_own']} of "
          f"{JAMBA['batch'] * JAMBA['prompt_len']}), against the card's own "
          f"cuda vs plain kernels {[round(e, 6) for e in spec['card_noise']]}"
          f"; bf16 with the split products' partials rounded to bf16 before "
          f"their psum (not the port's) the prefill's "
          f"{b0['forced_bf16_err']:.6f}")
    print(f"[dryrun] (b) {label} jamba-v0.1-52b on (1, 4) under the "
          f"decode override (kv_seq over model: {b0['kvseq_slots'][0]} of "
          f"the cache's slots a rank), float32, the routing held fixed: max "
          f"abs err / |ref|_inf of the prefill and {FORCED_DECODE} decode "
          f"steps {[float(f'{e:.4g}') for e in b0['kvseq_err']]} (limit "
          f"{F32_TOL}; max over ranks "
          f"{max(max(x['kvseq_err']) for x in b):.4g}); the same weights "
          f"with the caches whole over model "
          f"{[float(f'{e:.4g}') for e in b0['f32_err']]}")
    print(f"[mesh-serve-b] {label} each layer on the single card's input "
          f"to it (teacher-forced): max abs err / |ref|_inf by layer "
          f"{[round(e, 6) for e in b0['layer_err']]} (limit {LOGITS_TOL}; "
          f"share of outputs that differ at all "
          f"{[round(f, 6) for f in b0['layer_flips']]}; "
          f"MoE layers on the tokens dispatched alike), tokens dispatched "
          f"otherwise (expert set, or kept / dropped) {b0['rerouted']} of "
          f"{JAMBA['batch'] * JAMBA['prompt_len']} (limit "
          f"{TEACHER_REROUTED:.1%}); free-running, the prefill's logits "
          f"{b0['err']:.4e} from serve-jamba's (|ref|_inf {b0['scale']:.4e}"
          f"), tokens rerouted by MoE layer {b0['free_rerouted']}, greedy "
          f"tokens agree {b0['agree']:.1%}")
    c = [res[r]["c"] for r in range(MESH_RANKS)]
    c0 = c[0]
    print(f"[mesh-serve-c] {label} the launcher, {' '.join(MESH_SERVE_REDUCED)}"
          f" (reduced, float32): logits against the single-device run on "
          f"each data shard's half of the batch {max(x['err'] for x in c):.3e}"
          f" (limit {c0['limit']:.3e}); against the whole batch on one "
          f"device {c0['whole_err']:.3e} (the MoE's capacity is per data "
          f"shard); flash {c0['flash']}, ssd {c0['ssd']} launches by route "
          f"(rank 0); collectives {c0['collectives']}; prefill "
          f"{c0['prefill_ms']:.3f} ms, decode {c0['decode_ms']:.4f} ms")
    shutil.rmtree(MESH_SERVE_DIR, ignore_errors=True)
    secs = time.perf_counter() - t0
    times = {
        "flash_attention": {
            "mesh-serve (b) local (B %d, S %d, T %d, H %d, Kv %d, D %d, "
            "causal)" % FLASH_MESH[:6]: _flash_shape_time(FLASH_MESH,
                                                          device_name)},
        "ssd": {}}
    ms, bound, err = _ssd_shape_time(SSD_MESH, device_name)
    times["ssd"]["mesh-serve (b) local (B %d, S %d, nh %d, hd %d, g %d, "
                 "n %d, chunk %d)" % SSD_MESH] = (ms, bound)
    print(f"[times] ssd sm90 at (b)'s local shape {SSD_MESH}: device "
          f"{ms:.4f} ms = {bound / ms:.1%} of the bound {bound:.4f} ms; vs "
          f"plain max abs err {err:.3e}")
    print(f"[mesh-serve] {label} the phase took {secs:.1f}s (the kernels "
          "timed alone after it not included)")
    return {"paths": paths, "times": times, "seconds": secs, "a": res[0]["a"],
            "b": b0, "c": c0}


MESH_LM_DIR = os.path.join(ROOT, "build", "chip_smoke_mesh_lm")
MESH_LM_TIMEOUT_S = 600
# (a) lm-train's configuration (mamba2-780m at full width, bf16, f32 AdamW
# moments, batch 8 x 1,024, lr 1e-3) through the launcher on a (2, 2) mesh
# of the four gloo ranks, 4 steps; no checkpoint is written (lm-train
# drives that path on one card: a ~10-GB one would be gathered whole
# through gloo here).  Cut to MESH_LM_LAYERS of its 48 layers, as
# lm-train is: at full depth the phase took up to ~235 s of the script's
# time limit, most of it gloo's host-staged reductions, which scale with
# the layers.
MESH_LM_STEPS = 4
MESH_LM_LAYERS = 12
MESH_LM_ARGS = ["--arch", LM_TRAIN["arch"], "--full", "--steps",
                str(MESH_LM_STEPS), "--batch", str(LM_TRAIN["batch"]),
                "--seq", str(LM_TRAIN["seq"]), "--lr", str(LM_TRAIN["lr"]),
                "--seed", "0"]
MESH_LM_MESH = ["--data-par", "2", "--model-par", "2", "--dist-backend",
                "gloo"]
# Step 0 in float32 (the same seed's float32 draws on both sides): the
# loss and grad norm within 1e-4 of one card's, relative.  The bf16 run's
# 4 losses within 5e-3 of one card's (tests/test_torch_lm_train.py's
# bfloat16 tolerance for a loss); step 0's loss and grad norm within
# LM_DTYPE_RTOL.
MESH_LM_F32_RTOL = 1e-4
MESH_LM_BF16_LOSS_RTOL = 5e-3
# (b) the three layer kinds that serve on the mesh since this slice, at
# full width: llama-3.2-vision-11b cut to its first period (4 self- and 1
# cross-attention layers, gates 1.0) over a (4, 1,601, 4,096) frontend on
# (1, 4); whisper-tiny whole on (2, 2) (8 x 1,500 frames: 4 a data shard,
# 3 heads a rank); deepseek-v3-671b cut to 1 layer on (1, 4) (32 MLA heads
# and 64 experts a rank).  4 greedy tokens each (cut from 32).
MESH_LLAMA_SHAPE, MESH_LLAMA_LAYERS = (1, 4), 5
MESH_LLAMA_RUN = dict(LLAMA_V, new_tokens=4)
MESH_WHISPER_SHAPE = (2, 2)
MESH_WHISPER_RUN = dict(WHISPER, new_tokens=4)
MESH_DEEPSEEK_SHAPE, MESH_DEEPSEEK_LAYERS = (1, 4), 1
MESH_DEEPSEEK_RUN = dict(DEEPSEEK, new_tokens=4)
# Decode steps after the prefill in the float32 end-to-end gates.
MESH_F32_STEPS = 2
# The float32 MLA sublayer's weights and input (its own draws).
MLA_F32_SEED = 11
# The new local flash shapes of (b) (llama's self-attention local shape,
# (4, 2,048², 8 / 2, 128, causal), is mesh-serve's FLASH_MESH):
# (B, S, T, H, Kv, D, causal, window).
FLASH_MESH_LM = {
    "llama-3.2-vision cross on (1, 4)": (4, 2048, 1601, 8, 2, 128, False,
                                         1 << 30),
    "whisper encoder on (2, 2)": (4, 1500, 1500, 3, 3, 64, False, 1 << 30),
    "whisper decoder self on (2, 2)": (4, 448, 448, 3, 3, 64, True,
                                       1 << 30),
    "whisper cross on (2, 2)": (4, 448, 1500, 3, 3, 64, False, 1 << 30),
}


class _NoCheckpoints:
    """While active, ``train_lm`` writes no checkpoint: the launcher's
    ``CheckpointManager`` is None (``train_loop`` takes None)."""

    def __enter__(self):
        from repro_torch.launch import train
        self._orig = train.CheckpointManager
        train.CheckpointManager = lambda *a, **k: None
        return self

    def __exit__(self, *exc):
        from repro_torch.launch import train
        train.CheckpointManager = self._orig


def _mesh_cfg(name: str, layers: int = 0, dtype: str = ""):
    from repro_torch.configs import get_config
    cfg = get_config(name)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    if dtype:
        cfg = cfg.replace(param_dtype=dtype, compute_dtype=dtype)
    return cfg


def _free(*objs) -> None:
    import gc
    import torch
    for o in objs:
        if isinstance(o, dict):
            o.clear()
    gc.collect()
    torch.cuda.empty_cache()


def _mesh_lm_refs_train(spec: dict) -> None:
    """(a)'s references on the one card: the launcher's bf16 run of
    MESH_LM_STEPS steps (losses, grad norms), and step 0 in float32."""
    import torch
    from repro_torch.launch import train
    from repro_torch.models.model import LanguageModel
    args = train.parser().parse_args(MESH_LM_ARGS + ["--device", DEVICE])
    with _NoCheckpoints(), _Depth(LM_TRAIN["arch"], MESH_LM_LAYERS):
        res = train.train_lm(args)
    spec["a_card_bf16"] = [(h["loss"], h["grad_norm"])
                           for h in res["history"]]
    spec["a_card_bf16_ms"] = statistics.mean(
        h["seconds"] for h in res["history"][1:]) * 1e3
    _free(res)
    cfg32 = _mesh_cfg(LM_TRAIN["arch"], MESH_LM_LAYERS, dtype="float32")
    model = LanguageModel(cfg32, device=DEVICE).init(
        torch.Generator(device=DEVICE).manual_seed(0))
    spec["a_card_f32"] = _loss_and_grad_norm(model, _lm_batch0(cfg32))
    del model
    _free()


def _record_layers(model, tokens, cache_len: int, frontend, prefix: str):
    """One prefill of ``tokens`` on ``model`` with every layer's input (and
    the last layer's output) saved under MESH_LM_DIR as ``{prefix}_x{i}``,
    every MoE call's expert sets as ``{prefix}_r{i}``; returns the
    logits."""
    import numpy as np
    from repro_torch.models import blocks
    xs = []
    orig = blocks.Block.prefill

    def prefill(blk, x, *a, **k):
        xs.append(x)
        out, cache = orig(blk, x, *a, **k)
        if len(xs) == len(model.layers):
            xs.append(out)
        return out, cache

    blocks.Block.prefill = prefill
    try:
        with _MoeRoutes() as routes:
            logits, cache = model.prefill(tokens, cache_len, frontend)
    finally:
        blocks.Block.prefill = orig
    del cache
    for i, x in enumerate(xs):
        _tensor_save(os.path.join(MESH_LM_DIR, f"{prefix}_x{i}.npz"), x)
    for i, r in enumerate(routes.sets):
        np.save(os.path.join(MESH_LM_DIR, f"{prefix}_r{i}.npy"), r.numpy())
    return logits


def _f32_run(model, tokens, frontend, feed, cache_len: int):
    """The prefill of ``tokens`` and MESH_F32_STEPS decode steps fed
    ``feed[:, i]`` on ``model`` through the plain attention (no kernel
    launches: the gate runs beside the counted bf16 path): each step's
    (B, V) logits, float32 on the host."""
    import torch
    model.impl = "ref"
    got = []
    with torch.no_grad():
        logits, cache = model.prefill(tokens, cache_len, frontend)
        got.append(logits.float().cpu())
        for i in range(MESH_F32_STEPS):
            logits, cache = model.decode_step(feed[:, i], cache,
                                              tokens.shape[1] + i)
            got.append(logits.float().cpu())
    return got


def _mesh_lm_refs_serve(spec: dict, tag: str, cfg, run: dict,
                        prepare=None) -> None:
    """(b)'s references for one config on the one card: ``serve_lm`` in
    bf16 (its prompts, frontend, greedy tokens and prefill logits), a
    prefill recorded layer by layer, and the float32 model from the same
    seed through the plain attention (``_f32_run``); saved under
    MESH_LM_DIR."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models.model import LanguageModel
    with _Prepared(prepare):
        res = serve.serve_lm(cfg, device=DEVICE, **run)
    files = {}
    for name, t in (("tokens", res["tokens"]), ("out", res["out"]),
                    ("logits", res["logits"].float())):
        files[name] = os.path.join(MESH_LM_DIR, f"{tag}_{name}.npy")
        np.save(files[name], t.cpu().numpy())
    if res["frontend"] is not None:
        files["frontend"] = os.path.join(MESH_LM_DIR, f"{tag}_fe.npz")
        _tensor_save(files["frontend"], res["frontend"])
    model = res["model"]
    logits = _record_layers(model, res["tokens"], run["cache_len"],
                            res["frontend"], tag)
    check(torch.equal(logits, res["logits"]), f"mesh-lm {tag}: a recorded "
          "prefill differs from the timed one")
    tokens, frontend, out = res["tokens"], res["frontend"], res["out"]
    _free(res)
    del model
    _free()
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    model = LanguageModel(cfg32, device=DEVICE).init(
        torch.Generator(device=DEVICE).manual_seed(run["seed"]))
    if prepare is not None:
        prepare(model)
    got = _f32_run(model, tokens, frontend, out, run["cache_len"])
    files["f32"] = os.path.join(MESH_LM_DIR, f"{tag}_f32.npy")
    np.save(files["f32"], torch.stack(got).numpy())
    del model, tokens, frontend, out
    _free()
    spec[tag] = files


def _mla_f32_inputs(cfg, ctx=None):
    """The float32 MLA sublayer's weights (this rank's slices on ``ctx``)
    and input x (B, S, D), drawn from MLA_F32_SEED on the card."""
    import torch
    from repro_torch.models import attention
    from repro_torch.nn.module import ParamTree, init_params
    gen = torch.Generator(device=DEVICE).manual_seed(MLA_F32_SEED)
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    p = ParamTree(attention.mla_specs(cfg32), dtype=torch.float32,
                  device=torch.device(DEVICE), ctx=ctx)
    init_params(p, gen)
    b, s = MESH_DEEPSEEK_RUN["batch"], MESH_DEEPSEEK_RUN["prompt_len"]
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=DEVICE)
    return cfg32, p, x


def _mesh_lm_refs_deepseek(spec: dict) -> None:
    """deepseek's references: ``_mesh_lm_refs_serve``'s bf16 part (no
    float32 model: one layer is ~53 GB in float32), and the float32 MLA
    sublayer's output on its own draws."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import attention
    cfg = _mesh_cfg("deepseek-v3-671b", MESH_DEEPSEEK_LAYERS)
    run = MESH_DEEPSEEK_RUN
    res = serve.serve_lm(cfg, device=DEVICE, **run)
    # The recorded prefill's logits are the reference: the top-8 bf16 MoE
    # scatter adds in a run-dependent order on the card (ROADMAP.md §3),
    # so two prefills differ in their last bits.
    logits = _record_layers(res["model"], res["tokens"], run["cache_len"],
                            None, "deepseek")
    files = {}
    for name, t in (("tokens", res["tokens"]), ("out", res["out"]),
                    ("logits", logits.float())):
        files[name] = os.path.join(MESH_LM_DIR, f"deepseek_{name}.npy")
        np.save(files[name], t.cpu().numpy())
    _free(res)
    del logits
    _free()
    cfg32, p, x = _mla_f32_inputs(cfg)
    pos = torch.arange(x.shape[1], dtype=torch.int32, device=DEVICE)
    with torch.no_grad():
        want = attention.mla_forward(p, cfg32, x, pos)
    files["mla_f32"] = os.path.join(MESH_LM_DIR, "deepseek_mla_f32.npy")
    np.save(files["mla_f32"], want.cpu().numpy())
    del p, x, want
    _free()
    spec["deepseek"] = files


def _mesh_lm_a(spec: dict) -> dict:
    """(a) on the rank: the launcher's bf16 run on (2, 2), no kernel
    launch; then step 0 in float32 from the same seed."""
    import torch
    from repro_torch.launch import train
    from repro_torch.models.model import LanguageModel
    t_start = time.perf_counter()
    args = train.parser().parse_args(MESH_LM_ARGS + MESH_LM_MESH
                                     + ["--device", DEVICE])
    check(train.lm_refusal(args) == "", "mesh-lm (a): refused")
    ctx = train.lm_ctx(args)
    rank = ctx.mesh.rank
    _reset_lm_counters()                     # the training path starts
    t0 = time.perf_counter()
    with _NoCheckpoints(), _AllReduceTimer() as art, \
            _Depth(LM_TRAIN["arch"], MESH_LM_LAYERS):
        res = train.train_lm(args, ctx)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _lm_kernel_launches()         # ... and ends here
    check(not any(launches.values()), f"mesh-lm (a) rank {rank}: kernels "
          f"launched while training: {launches}")
    hist = res["history"]
    n_ar, s_ar = art.seconds("other")
    local = sum(p.numel() for p in res["model"].parameters())
    out = {"hist": [(h["loss"], h["grad_norm"], h["seconds"]) for h in hist],
           "peak_gib": res["peak_bytes"] / 2**30, "wall": wall,
           "ar_s_step": s_ar / len(hist), "ar_n_step": n_ar / len(hist),
           "local_params": local, "n_params": res["n_params"]}
    _free(res)
    cfg32 = _mesh_cfg(LM_TRAIN["arch"], MESH_LM_LAYERS, dtype="float32")
    t0 = time.perf_counter()
    model = LanguageModel(cfg32, device=DEVICE, ctx=ctx).init(
        torch.Generator(device=DEVICE).manual_seed(0))
    out["f32"] = _loss_and_grad_norm(model, _lm_batch0(cfg32))
    out["f32_s"] = time.perf_counter() - t0
    del model
    _free()
    out["seconds"] = time.perf_counter() - t_start
    want = spec["a_card_f32"]
    for i, key in enumerate(("loss", "grad_norm")):
        rel = abs(out["f32"][i] - want[i]) / abs(want[i])
        check(rel <= MESH_LM_F32_RTOL, f"mesh-lm (a) rank {rank}: float32 "
              f"step 0's {key} {out['f32'][i]} is {rel:.3e} from one card's "
              f"{want[i]}, limit {MESH_LM_F32_RTOL}")
    card = spec["a_card_bf16"]
    check(len(hist) == len(card) == MESH_LM_STEPS,
          f"mesh-lm (a): {len(hist)} steps")
    for i, key in enumerate(("loss", "grad_norm")):
        got, ref = hist[0][key], card[0][i]
        check(abs(got - ref) <= LM_DTYPE_RTOL[key] * abs(ref),
              f"mesh-lm (a) rank {rank}: bf16 step 0's {key} {got} is not "
              f"within {LM_DTYPE_RTOL[key]} of one card's {ref}")
    for i, (h, (ref, _)) in enumerate(zip(hist, card)):
        check(abs(h["loss"] - ref) <= MESH_LM_BF16_LOSS_RTOL * abs(ref),
              f"mesh-lm (a) rank {rank}: bf16 step {i}'s loss {h['loss']} "
              f"is not within {MESH_LM_BF16_LOSS_RTOL} of one card's {ref}")
    return out


def _flash_counted(tag: str, rank: int, per_prefill: int, prefills: int,
                   calls: list) -> dict:
    """The path's flash launches (the counters set to 0 just before it):
    every one on the sm90 route, ``per_prefill`` a prefill and none in
    decode; each distinct recorded shape of a prefill held once against
    the plain version.  Returns the launches and the shapes."""
    from repro_torch.kernels.flash_attn import kernel as fk
    routes = dict(fk.flash_attention_cuda.launches_by_route)
    check(routes == {"sm90": per_prefill * prefills, "fp32": 0},
          f"mesh-lm {tag} rank {rank}: flash launches by route {routes}, "
          f"expected {per_prefill} sm90 a prefill")
    shapes, once = {}, []
    for args, kw, out in calls:
        key = (tuple(args[0].shape), tuple(args[1].shape),
               "causal" if kw["causal"] else "non-causal")
        if key not in shapes:
            once.append((args, kw, out))
        shapes[key] = shapes.get(key, 0) + 1
    if once:
        _hold_main_path(once, [], tag=f"mesh-lm {tag} rank {rank}",
                        what="each distinct shape of a prefill:")
    return {"flash": routes["sm90"],
            "shapes": {f"{q} x {k} {m}": n for (q, k, m), n in
                       shapes.items()}}


def _teacher_forced(model, cfg, run: dict, directory: str, tag: str,
                    frontend=None, forced: bool = False) -> dict:
    """Each layer of the sharded ``model`` run on one card's input to it
    (``{directory}/{tag}_x{i}.npz``, the run's prompts): its output
    against the card's at LOGITS_TOL x its |ref|_inf, on the tokens that
    each MoE layer dispatched alike (the same expert set, kept or dropped
    by each expert alike: a near-tie in the random router flips on a
    rounding difference, the token's FFN output changes wholesale, and
    the slots it takes or frees move later tokens across the capacity);
    at most TEACHER_REROUTED of the tokens may be dispatched otherwise.
    With ``forced`` every MoE layer dispatches to one card's recorded
    expert sets (``_MoeRoutes(forced=)``) and every token is held; the
    tokens the layer's own router would have sent elsewhere are counted,
    not gated (deepseek-v3's top-8 of 256 experts has far more near-ties
    than jamba's top-2 of 16, on which TEACHER_REROUTED was set).  On a
    batch split over data each rank holds its shard's rows."""
    import numpy as np
    import torch
    b, s = run["batch"], run["prompt_len"]
    split = model.batch_split(b)
    if split:
        b //= model.ctx.n_data
    lo = model.ctx.index(model.ctx.data_axes) * b if split else 0
    positions = torch.arange(s, dtype=torch.int32, device=model.device)
    fe = model._frontend(model._local(frontend), model.impl)
    errs, rerouted, flips, moe_i = [], [], [], 0
    for i, blk in enumerate(model.layers):
        x = _tensor_load(os.path.join(directory, f"{tag}_x{i}.npz"),
                         model.device)[lo:lo + b]
        want = _tensor_load(os.path.join(directory, f"{tag}_x{i + 1}.npz"),
                            model.device)[lo:lo + b].float()
        ref = None
        if blk.is_moe:
            ref = torch.from_numpy(np.load(os.path.join(
                directory, f"{tag}_r{moe_i}.npy")))[lo * s:(lo + b) * s]
        with _MoeRoutes(forced=[ref] if forced and ref is not None
                        else None) as routes, torch.no_grad():
            out, _ = blk.prefill(x, positions, run["cache_len"], fe,
                                 impl=model.impl, batch_split=split)
        same = torch.ones(b * s, dtype=torch.bool)
        if blk.is_moe:
            got = routes.sets[0]
            cap = max(1, math.ceil(run["batch"] * s * cfg.top_k
                                   * cfg.capacity_factor / cfg.n_experts))
            alike = ((got == ref).all(-1)
                     & (_dispatch(got, cfg.n_experts, cap)
                        == _dispatch(ref, cfg.n_experts, cap)).all(-1))
            if not forced:
                same = alike
            moe_i += 1
            rerouted.append(int((~alike).sum()))
        diff = (out.float() - want).abs().reshape(b * s, -1)
        flips.append(float((diff > 0).float().mean()))
        err = float(diff[same.to(diff.device)].max())
        scale = float(want.abs().max())
        check(err <= LOGITS_TOL * scale, f"{tag} layer {i} ({blk.kind}, "
              f"{'MoE' if blk.is_moe else 'dense'}): {err:.4e} from one "
              f"card's, limit {LOGITS_TOL * scale:.4e}")
        errs.append(err / scale)
        del x, want, out, diff
    check(forced or all(r <= TEACHER_REROUTED * b * s for r in rerouted),
          f"{tag}: tokens dispatched otherwise by MoE layer {rerouted} of "
          f"{b * s}")
    return {"layer_err": errs, "rerouted": rerouted, "layer_flips": flips,
            "forced": forced}


def _mesh_lm_serve(spec: dict, tag: str, cfg, run: dict, shape, n_flash: int,
                   prepare=None, turns: bool = False,
                   forced: bool = False) -> dict:
    """(b) for one config on the rank: ``serve_lm(ctx=)`` at full width
    (the flash launches counted and held, ``_flash_counted``), the prompts
    against one card's, the bf16 prefill logits against one card's
    (printed), each layer on one card's recorded inputs
    (``_teacher_forced``); the model returned for more gates."""
    import numpy as np
    import torch
    from repro_torch.distributed.sharding import MeshCtx
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import attention
    files = spec[tag]
    ctx = MeshCtx.for_mesh(make_local_mesh(*shape, backend="gloo",
                                           device=DEVICE), "decode")
    rank = ctx.mesh.rank
    calls = []
    undo = _recorder(attention, "flash_attention", calls, max(n_flash, 1))
    _reset_lm_counters()                     # the path starts
    try:
        with _AllReduceTimer() as art, _Prepared(prepare, turns):
            res = serve.serve_lm(cfg, device=DEVICE, ctx=ctx, **run)
    finally:
        undo()
    out = _flash_counted(tag, rank, n_flash, res["prefills"], calls)
    del calls                                # ... and ends here
    tokens = torch.from_numpy(np.load(files["tokens"]))
    check(torch.equal(res["tokens"].cpu(), tokens),
          f"mesh-lm {tag} rank {rank}: the prompts differ from one card's")
    ref = torch.from_numpy(np.load(files["logits"]))
    logits = res["logits"].float().cpu()
    check(tuple(logits.shape) == (run["batch"], cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"mesh-lm {tag}: logits {tuple(logits.shape)}")
    model = res["model"]
    n_pre, s_pre = art.seconds("prefill")
    out.update(
        bf16_err=_rel(logits, ref), agree=float(
            (res["out"].cpu() == torch.from_numpy(np.load(files["out"])))
            .float().mean()),
        prefill_ms=res["prefill_s"] * 1e3,
        decode_ms=res["decode_ms_per_step"], init_s=res["init_s"],
        peak_gib=res["peak_bytes"] / 2**30,
        ar_prefill_ms=1e3 * s_pre / res["prefills"],
        ar_prefill_n=n_pre / res["prefills"],
        weights_gib=sum(p.numel() * p.element_size()
                        for p in model.parameters()) / 2**30)
    frontend = None
    if "frontend" in files:
        frontend = _tensor_load(files["frontend"], model.device)
    out.update(_teacher_forced(model, cfg, run, MESH_LM_DIR, tag, frontend,
                               forced))
    res.clear()
    return out, model, ctx, frontend


def _mesh_lm_f32(spec: dict, tag: str, cfg, run: dict, ctx, frontend,
                 prepare=None) -> list:
    """The float32 model from the same seed on ``ctx`` (this rank's
    slices), through the plain attention: the prefill and MESH_F32_STEPS
    decode steps fed one card's greedy tokens, each step's logits within
    F32_TOL x |ref|_inf of one card's float32 run."""
    import numpy as np
    import torch
    from repro_torch.models.model import LanguageModel
    files = spec[tag]
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    model = LanguageModel(cfg32, device=DEVICE, ctx=ctx).init(
        torch.Generator(device=DEVICE).manual_seed(run["seed"]))
    if prepare is not None:
        prepare(model)
    tokens = torch.from_numpy(np.load(files["tokens"])).to(DEVICE)
    feed = torch.from_numpy(np.load(files["out"])).to(DEVICE)
    got = _f32_run(model, tokens, frontend, feed, run["cache_len"])
    refs = torch.from_numpy(np.load(files["f32"]))
    errs = [_rel(g, r) for g, r in zip(got, refs)]
    del model
    _free()
    for i, e in enumerate(errs):
        check(e <= F32_TOL, f"mesh-lm {tag} float32 "
              f"{'prefill' if i == 0 else f'decode {i}'}: logits {e:.4e} x "
              f"|ref|_inf from one card's, limit {F32_TOL}")
    return errs


def _mesh_lm_b(spec: dict) -> dict:
    """(b) on the rank: llama-3.2-vision on (1, 4), whisper on (2, 2),
    deepseek-v3 on (1, 4)."""
    import numpy as np
    import torch
    from repro_torch.models import attention
    out = {}
    t0 = time.perf_counter()
    cfg = _mesh_cfg("llama-3.2-vision-11b", MESH_LLAMA_LAYERS)
    n_flash = cfg.n_layers
    res, model, ctx, fe = _mesh_lm_serve(
        spec, "llama", cfg, MESH_LLAMA_RUN, MESH_LLAMA_SHAPE, n_flash,
        prepare=_open_gates)
    del model
    _free()
    res["f32_err"] = _mesh_lm_f32(spec, "llama", cfg, MESH_LLAMA_RUN, ctx,
                                  fe, prepare=_open_gates)
    out["llama"] = res
    del fe
    _free()
    res["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = _mesh_cfg("whisper-tiny")
    res, model, ctx, fe = _mesh_lm_serve(
        spec, "whisper", cfg, MESH_WHISPER_RUN, MESH_WHISPER_SHAPE,
        cfg.encoder_layers + 2 * cfg.n_layers)
    del model
    res["f32_err"] = _mesh_lm_f32(spec, "whisper", cfg, MESH_WHISPER_RUN,
                                  ctx, fe)
    out["whisper"] = res
    del fe
    _free()
    res["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = _mesh_cfg("deepseek-v3-671b", MESH_DEEPSEEK_LAYERS)
    res, model, ctx, _ = _mesh_lm_serve(
        spec, "deepseek", cfg, MESH_DEEPSEEK_RUN, MESH_DEEPSEEK_SHAPE, 0,
        turns=True, forced=True)
    tokens = torch.from_numpy(np.load(spec["deepseek"]["tokens"])).to(DEVICE)
    res["decode_gate"] = _mla_decode_gate(model, tokens)
    del model
    _free()
    cfg32, p, x = _mla_f32_inputs(cfg, ctx)
    pos = torch.arange(x.shape[1], dtype=torch.int32, device=DEVICE)
    with torch.no_grad():
        got = attention.mla_forward(p.view(), cfg32, x, pos).cpu()
    want = torch.from_numpy(np.load(spec["deepseek"]["mla_f32"]))
    res["mla_f32_err"] = _rel(got, want)
    check(res["mla_f32_err"] <= F32_TOL, f"mesh-lm deepseek rank "
          f"{ctx.mesh.rank}: the float32 MLA sublayer {res['mla_f32_err']:.4e}"
          f" x |ref|_inf from one card's, limit {F32_TOL}")
    del p, x, got, want
    _free()
    res["seconds"] = time.perf_counter() - t0
    out["deepseek"] = res
    return out


def phase_mesh_lm(smi: str, device_name: str) -> dict:
    """LM training and the three remaining layer kinds' serving on a mesh
    of four gloo ranks sharing the card (no figure here is a multi-card
    one), under ``torch.distributed.run`` (the parent built every kernel;
    a rank that runs nvcc fails).  The parent first takes one card's
    references, then frees them: (a) mamba2-780m trained through the
    launcher on (2, 2) against one card (float32 step 0, bf16 steps); (b)
    llama-3.2-vision, whisper and deepseek-v3 served at full width
    (``MESH_*``) against one card (float32 end to end, bf16 layer by
    layer, MLA's sublayer in float32 and its absorbed decode).  Then the
    new local flash shapes timed alone."""
    t0 = time.perf_counter()
    shutil.rmtree(MESH_LM_DIR, ignore_errors=True)
    os.makedirs(MESH_LM_DIR)
    spec = {}
    _mesh_lm_refs_train(spec)
    _mesh_lm_refs_serve(spec, "llama", _mesh_cfg("llama-3.2-vision-11b",
                                                 MESH_LLAMA_LAYERS),
                        MESH_LLAMA_RUN, prepare=_open_gates)
    _mesh_lm_refs_serve(spec, "whisper", _mesh_cfg("whisper-tiny"),
                        MESH_WHISPER_RUN)
    _mesh_lm_refs_deepseek(spec)
    refs_s = time.perf_counter() - t0
    print(f"[mesh-lm] one card's references in {refs_s:.1f}s")
    res = _torchrun("lm", spec, where=MESH_LM_DIR,
                    timeout_s=MESH_LM_TIMEOUT_S)
    label = f"({smi}; four gloo ranks share the one card)"
    a = [res[r]["a"] for r in range(MESH_RANKS)]
    a0, card = a[0], spec["a_card_bf16"]
    ms = statistics.mean(h[2] for h in a0["hist"][1:]) * 1e3
    print(f"[mesh-lm-a] {label} {LM_TRAIN['arch']} at full width, cut to "
          f"{MESH_LM_LAYERS} layers ({a0['n_params']:,} parameters, {a0['local_params']:,} on rank "
          f"0) through the launcher on (2, 2), bf16, batch "
          f"{LM_TRAIN['batch']} x {LM_TRAIN['seq']}, {MESH_LM_STEPS} steps: "
          f"{ms:.3f} ms a step over steps 2-{MESH_LM_STEPS} (rank 0, host "
          f"clock ending in a sync; one card {spec['a_card_bf16_ms']:.3f}), "
          f"of it {a0['ar_s_step'] * 1e3:.3f} ms in "
          f"{a0['ar_n_step']:.0f} host-staged all_reduces a step; step 0 "
          f"{a0['hist'][0][2] * 1e3:.3f} ms; peak device memory per rank "
          f"{[round(x['peak_gib'], 2) for x in a]} GiB; 0 kernel launches "
          f"(training runs the plain functions); (a) {a0['seconds']:.1f}s "
          f"on the ranks, the float32 step 0 {a0['f32_s']:.1f}s of it")
    print(f"[mesh-lm-a] {label} losses "
          f"{[round(h[0], 6) for h in a0['hist']]} against one card's "
          f"{[round(c[0], 6) for c in card]} (limit "
          f"{MESH_LM_BF16_LOSS_RTOL} relative); grad norms "
          f"{[round(h[1], 5) for h in a0['hist']]} against "
          f"{[round(c[1], 5) for c in card]}; float32 step 0: loss "
          f"{a0['f32'][0]:.7f} vs {spec['a_card_f32'][0]:.7f}, grad norm "
          f"{a0['f32'][1]:.7f} vs {spec['a_card_f32'][1]:.7f} (limit "
          f"{MESH_LM_F32_RTOL} relative)")
    paths = {}
    for tag in ("llama", "whisper", "deepseek"):
        b = [res[r]["b"][tag] for r in range(MESH_RANKS)]
        b0 = b[0]
        paths[f"mesh-lm (b) {tag}, 4 ranks"] = sum(x["flash"] for x in b)
        print(f"[mesh-lm-b] {label} {tag}: prefill {b0['prefill_ms']:.3f} "
              f"ms ({b0['ar_prefill_ms']:.3f} of it in "
              f"{b0['ar_prefill_n']:.0f} host-staged all_reduces), decode "
              f"{b0['decode_ms']:.4f} ms a step (rank 0); peak per rank "
              f"{[round(x['peak_gib'], 2) for x in b]} GiB "
              f"({b0['weights_gib']:.2f} of weight shards); flash launches "
              f"by rank {[x['flash'] for x in b]}, all sm90, by shape a "
              f"prefill {b0['shapes']}; bf16 logits end to end "
              f"{max(x['bf16_err'] for x in b):.4e} x |ref|_inf from one "
              f"card's (printed, not gated; greedy tokens agree "
              f"{b0['agree']:.1%}); each layer on one card's inputs "
              f"{[round(e, 6) for e in b0['layer_err']]} (limit "
              f"{LOGITS_TOL}; "
              + ("every MoE call dispatched to one card's expert sets, "
                 f"its own router would have sent {b0['rerouted']} tokens "
                 "elsewhere" if b0["forced"] else
                 f"tokens dispatched otherwise {b0['rerouted']}")
              + f"; {b0['seconds']:.1f}s on the ranks)"
              + ("" if "f32_err" not in b0 else
                 f"; float32 end to end {[float(f'{e:.4g}') for e in b0['f32_err']]}"
                 f" (max over ranks "
                 f"{max(max(x['f32_err']) for x in b):.4g}; limit {F32_TOL})"))
    d0 = res[0]["b"]["deepseek"]
    check(all(res[r]["b"]["deepseek"]["flash"] == 0
              for r in range(MESH_RANKS)), "mesh-lm deepseek: MLA made "
          "flash launches")
    print(f"[mesh-lm-b] {label} deepseek's MLA on (1, 4): the float32 "
          f"sublayer {max(res[r]['b']['deepseek']['mla_f32_err'] for r in range(MESH_RANKS)):.4e}"
          f" x |ref|_inf from one card's (limit {F32_TOL}); the absorbed "
          f"decode against the expanded prefill on the mesh: "
          + "; ".join(f"{k} {e:.3e} (limit {lim:.3e}, token S - 1 "
                      f"{away:.3e} away)"
                      for k, (e, lim, away) in d0["decode_gate"].items()))
    shutil.rmtree(MESH_LM_DIR, ignore_errors=True)
    secs = time.perf_counter() - t0
    times = {}
    for what, case in FLASH_MESH_LM.items():
        key = ("mesh-lm (b) %s (B %d, S %d, T %d, H %d, Kv %d, D %d, %s)"
               % ((what,) + case[:6] + ("causal" if case[6]
                                        else "non-causal",)))
        times[key] = _flash_shape_time(case, device_name)
    print(f"[mesh-lm] {label} the phase took {secs:.1f}s (one card's "
          f"references {refs_s:.1f}; the kernels timed alone after it not "
          "included)")
    return {"paths": paths, "times": times, "seconds": secs, "a": a0,
            "b": {t: res[0]["b"][t] for t in ("llama", "whisper",
                                              "deepseek")}}


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card only", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no port package under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()

    def elapsed(what: str) -> None:
        print(f"[elapsed] {what}: {time.perf_counter() - t0:.1f}s")

    name, smi = phase_device()
    phase_build()
    elapsed("build")
    phase_parity()
    phase_lm_parity()
    elapsed("parity, lm-parity")
    res, launches = phase_serve()
    serve_f = torch.cat(res["outs"]).cpu()     # mesh-serve (a)'s reference
    trained = phase_train()
    phase_train_cuda_vs_ref(trained["out"])
    vecmat_launches = phase_train_two_pass(trained["out"]["cfg"])
    step_profile = phase_profile(trained["out"])
    elapsed("serve, train, train-cuda-vs-ref, train-two-pass, profile")
    parallel = phase_train_parallel()
    parallel_profile = phase_profile(parallel["out"], parallel=True)
    hosted = phase_train_hosted()
    phase_hosted_vs_memory()
    elapsed("train-parallel, profile-parallel, train-hosted, "
            "hosted-vs-memory")
    precond = phase_train_precond(trained, parallel)
    phase_precond_parity(trained["out"])
    precond_hosted = phase_precond_hosted(hosted["source"])
    prob = _converge_problem()
    converge = phase_precond_converge(prob)
    elapsed("train-precond, precond-parity, precond-hosted, "
            "precond-converge")
    bcd_cell = phase_bcd_cell(prob)
    bcd_exact = phase_bcd_exact(prob)
    mesh = phase_mesh(prob, smi,
                      trained["out"]["result"].history[-1]["val_error"])
    del prob
    bcd_hosted = phase_bcd_hosted(hosted, name)
    base = phase_baselines()
    kp = phase_kpca()
    elapsed("bcd-cell, bcd-exact, mesh, bcd-hosted, baselines, kpca")
    online = phase_online()
    tenants = phase_tenants()
    elapsed("online, tenants")
    # The wide sm90 train kernel's launches on the Alg.-2 paths, by path.
    wide_paths = {"train-parallel": parallel["launches"],
                  "train-hosted prefetch": hosted["prefetch"]["steps"],
                  "train-hosted sync": hosted["sync"]["steps"]}
    # The vecmat's launches on the main paths: the two-pass fit, and one
    # EigenPro correction a preconditioned step (I 1,024 x m 512).
    precond_paths = {
        "train-precond": precond["train-precond"]["launches"],
        "train-precond parallel":
            precond["train-precond parallel"]["launches"],
        "precond-hosted": precond_hosted["launches"]}
    vecmat_paths = dict({"train-two-pass": vecmat_launches}, **precond_paths)
    vecmat_paths["baselines emp-fix step"] = base["vecmat"]
    vecmat_paths.update(mesh["paths"]["vecmat"])
    matvec_paths = {"serve": launches,
                    "train-parallel eval": parallel["eval_launches"],
                    "train-hosted prefetch eval":
                        hosted["prefetch"]["eval_launches"],
                    "train-hosted sync eval": hosted["sync"]["eval_launches"],
                    "bcd-cell eval": bcd_cell["eval_launches"],
                    "bcd-hosted eval": bcd_hosted["eval_launches"],
                    "baselines emp-fix step and decision": base["matvec"],
                    "kpca steps and transform": kp["matvec"],
                    "online serve and rebuild warm-ups":
                        online["matvec_launches"],
                    "tenants (qos on: batch's bypass)": tenants["launches"]}
    matvec_paths.update(mesh["paths"]["matvec"])
    # The narrow sm90 train pass: Algorithm 1's indexed step in memory, and
    # the online fit thread's hosted step on the staged rows.
    train_paths = {"train": trained["launches"],
                   "online fit": online["train_launches"]}
    rows = phase_times(res, name) + [phase_rbf_times(res, name)]
    rows += phase_train_times(trained["out"], name)
    rows += phase_parallel_times(parallel["out"], name)
    rows.append(phase_precond_times(
        trained["out"], precond["train-precond"]["out"]["result"].precond,
        name))
    shape_times = phase_shape_times(name)
    del res, trained["out"], parallel["out"]
    for tag in ("train-precond", "train-precond parallel"):
        del precond[tag]["out"]
    elapsed("times")
    jamba = phase_serve_jamba()
    jr = jamba.pop("res")
    jamba_ref = _jamba_layer_refs(jr)
    del jr
    elapsed("serve-jamba")
    dry = phase_dryrun(name)
    elapsed("dryrun")
    mesh_serve = phase_mesh_serve(serve_f, jamba_ref, smi, name)
    elapsed("mesh-serve")
    mesh_lm = phase_mesh_lm(smi, name)
    elapsed("mesh-lm")
    llama = phase_serve_llama_vision(name)
    whisper = phase_serve_whisper(name)
    deepseek = phase_serve_deepseek()
    elapsed("serve-llama-vision, serve-whisper, serve-deepseek")
    lm_train = phase_lm_train()
    elapsed("lm-train")
    readout = phase_lm_readout(lm_train.pop("model"), name)
    elapsed("lm-readout")
    rows += phase_lm_times(name)
    elapsed("lm-times")
    # Launches on the main paths; every fp32 route but the matvec's (the
    # readout's decision at D 1,536) has none there.
    wide_paths["lm-readout fit (J union 2,048)"] = readout["train"]
    # The readout's decisions at D 1,536 take the matvec's fp32 route.
    matvec_fp32_paths = {"lm-readout decisions (D 1,536)": readout["matvec"]}
    # Flash: causal prefills (jamba, llama-3.2-vision's self-attention,
    # whisper's decoder) and, since the frontend slice, non-causal ones
    # (the cross layers, whisper's encoder); none in deepseek's (MLA).
    flash_paths = {"serve-jamba": jamba["flash"],
                   "serve-llama-vision": llama["flash"],
                   "serve-whisper": whisper["flash"],
                   "serve-deepseek": deepseek["flash"]}
    ssd_paths = {"serve-jamba": jamba["ssd"],
                 "lm-readout (mamba2-780m, n 128)": readout["ssd"]}
    flash_paths.update(mesh_serve["paths"]["flash"])
    flash_paths.update(mesh_lm["paths"])
    ssd_paths.update(mesh_serve["paths"]["ssd"])
    matvec_paths.update(mesh_serve["paths"]["matvec"])
    by_path = {"kernel_matvec": matvec_paths,
               "train_pass": train_paths,
               "train_pass_sm90_j4096": wide_paths,
               "kernel_vecmat": vecmat_paths, "ssd": ssd_paths,
               "flash_attention": flash_paths,
               "kernel_matvec_fp32": matvec_fp32_paths}
    # kernel_vecmat_precond times kernel_vecmat at the correction's shape;
    # its launches are counted once, in kernel_vecmat's row.
    launches = {"kernel_matvec": sum(matvec_paths.values()), "rbf_matvec": 0,
                "kernel_matvec_fp32": sum(matvec_fp32_paths.values()),
                "kernel_vecmat": sum(vecmat_paths.values()),
                "kernel_vecmat_precond": 0,
                "dual_pass": trained["dual_launches"],
                "train_pass": sum(train_paths.values()),
                "train_pass_sm90_j4096": sum(wide_paths.values()),
                "flash_attention": sum(flash_paths.values()),
                "ssd": sum(ssd_paths.values())}
    for row in rows:
        row["launches"] = launches.get(row["name"], 0)
        if row["name"] in by_path:
            row["launches_by_path"] = by_path[row["name"]]
        if row["name"] in ("kernel_matvec", "kernel_vecmat"):
            kind = row["name"][len("kernel_"):]
            row["ms_bound_by_shape"] = {
                k[: -len(kind) - 1]: v for k, v in shape_times.items()
                if k.endswith(kind)}
        if row["name"] == "kernel_matvec_fp32":
            row["ms_bound_by_shape"] = {
                "lm-readout decision (I %d, J %d, D %d)"
                % readout["matvec_shape"]: readout["matvec_time"]}
        if row["name"] == "flash_attention":
            row["ms_bound_by_shape"] = dict(
                llama["times"], **whisper["times"],
                **mesh_serve["times"]["flash_attention"],
                **mesh_lm["times"])
        if row["name"] == "train_pass_sm90_j4096":
            row["ms_bound_by_shape"] = {
                "lm-readout fit (I %d, J union %d, D %d)"
                % readout["train_shape"]: readout["train_time"]}
        if row["name"] == "ssd":
            row["ms_bound_by_shape"] = {
                "lm-readout (B %d, S %d, nh %d, hd %d, g %d, n %d, chunk %d)"
                % readout["ssd_case"]: readout["ssd_time"],
                **mesh_serve["times"]["ssd"]}
        dispatch = {k.split(" ", 1)[0]: v["added_us"]
                    for k, v in dry["dispatch"].items()}
        if row["name"] in dispatch:
            row["dispatch_added_us"] = dispatch[row["name"]]
        check(row["name"] in launches or row["kernel_route"] == "fp32",
              f"no main-path launch count for {row['name']}")
    train = next(r for r in rows if r["name"] == "train_pass")
    step_ms = trained["ms_per_step"]
    print(f"[train] {trained['steps_per_s']:.1f} steps/s, {step_ms:.4f} "
          f"ms/step (epoch 2 wall); the train pass's kernels take "
          f"{train['ms']:.4f} ms of device time = {train['ms'] / step_ms:.1%}"
          f" of the step, one call of its wrapper {train['wall_ms']:.4f} ms "
          f"by events = {train['wall_ms'] / step_ms:.1%}; device busy "
          f"{step_profile['busy_ms']:.4f} ms/step (profiler; "
          f"{step_profile['busy_share']:.1%} of the profiled wall), "
          f"{step_profile['kernels']:.2f} device kernels a step")
    wide = next(r for r in rows if r["name"] == "train_pass_sm90_j4096")
    print(f"[train-parallel] {parallel['ms_per_step']:.4f} ms/step in "
          f"memory (the serial step {step_ms:.4f}); out of core "
          f"{hosted['prefetch']['ms_per_step']:.4f} ms/step prefetched "
          f"(hidden {hosted['prefetch']['hidden']:.1%}), "
          f"{hosted['sync']['ms_per_step']:.4f} inline; the wide sm90 train "
          f"kernel {wide['ms']:.4f} ms of device time = "
          f"{wide['ms'] / parallel['ms_per_step']:.1%} of the in-memory "
          f"step; device busy {parallel_profile['busy_ms']:.4f} ms/step, "
          f"{parallel_profile['kernels']:.2f} device kernels a step "
          f"(profiler; the serial step {step_profile['kernels']:.2f})")
    vec = next(r for r in rows if r["name"] == "kernel_vecmat_precond")
    pstep = precond["train-precond"]["ms_per_step"]
    pprof = precond["profile"]
    print(f"[train-precond] {pstep:.4f} ms/step with EigenPro (the plain "
          f"step {step_ms:.4f}: +{pstep - step_ms:.4f} ms); Algorithm 2 "
          f"{precond['train-precond parallel']['ms_per_step']:.4f} (plain "
          f"{parallel['ms_per_step']:.4f}); the correction's vecmat "
          f"{vec['ms']:.4f} ms of device time = {vec['ms'] / pstep:.1%} of "
          f"the step; device busy {pprof['busy_ms']:.4f} ms/step, "
          f"{pprof['kernels']:.2f} device kernels a step (the plain step "
          f"{step_profile['kernels']:.2f}); estimate_s "
          f"{precond['train-precond']['estimate_s']:.4f} in memory, "
          f"{precond_hosted['estimate_s'][0]:.4f} from the memmap; "
          f"precond-converge: epochs to target preconditioned "
          f"{converge['epochs']['precond']} against baseline "
          f"{converge['epochs']['baseline']}")
    print(f"[bcd] bcd-cell: rounds to {BCD_CELL['target']} "
          f"{bcd_cell['rounds_to_target']} (JAX cell "
          f"{JAX_BCD['rounds_to_target']}), best val error "
          f"{bcd_cell['best']:.6f} against the dense solve's "
          f"{bcd_cell['exact']:.6f}, {bcd_cell['round_ms']:.2f} ms a round; "
          f"bcd-exact cond(A) {bcd_exact['cond']:.4e}, max abs err "
          f"{bcd_exact['err']:.3e}; bcd-hosted "
          f"{statistics.mean(bcd_hosted['round_s']):.4f} s a round, "
          f"{bcd_hosted['kernels_per_round']} device kernels and "
          f"{bcd_hosted['syncs_per_round']} host syncs a round, peak "
          f"{bcd_hosted['peak_mib']:.2f} MiB; EmpFix "
          f"{base['step_ms']:.4f} ms a step")
    print(f"[online] flush p50 {online['p50']:.4f} / p99 "
          f"{online['p99']:.4f} ms while training, {online['idle_p50']:.4f} "
          f"/ {online['idle_p99']:.4f} ms after stop(); the fit thread "
          f"{online['ms_per_step']:.4f} ms a step (hosted Algorithm 1 at "
          f"J 1,024; covertype-train in memory {step_ms:.4f}, hosted-train "
          f"prefetched {hosted['prefetch']['ms_per_step']:.4f} at J "
          f"4,096); staleness mean {online['staleness_mean']:.1f} max "
          f"{online['staleness_max']}; {online['publishes']} publishes, "
          f"{online['rebuilds']} rebuilds; peak {online['peak_mib']:.2f} "
          f"MiB")
    prof = online["profile"]
    print(f"[online] the fit thread's epoch {ONLINE_PROFILE_EPOCH} traced: "
          f"device busy {prof['busy_share']:.1%}, a sweep "
          f"{prof['sweep_ms']:.4f} ms of device time against the window's "
          f"flush p50 {prof['flush_p50']:.4f} ms (host "
          f"{prof['host_share']:.1%})")
    for qos in ("on", "off"):
        arm = tenants[qos]
        print(f"[tenants] qos {qos}: victims' p99 "
              f"{arm['victim_p99']:.4f} ms; " + ", ".join(
                  f"{n} p50 {arm[n][0]:.4f} p99 {arm[n][1]:.4f} ms"
                  for n in ("gold", "standard", "batch"))
              + f"; {arm['sheds']} sheds")
    print(f"[lm-train] {LM_TRAIN['arch']} at full width, "
          f"{LM_TRAIN['layers']} layers: "
          f"{lm_train['ms_per_step']:.3f} ms a step, "
          f"{lm_train['tokens_per_s']:,.0f} tokens/s, {lm_train['mfu']:.2%} "
          f"of the bf16 dense peak (6 x parameters x tokens), peak "
          f"{lm_train['peak_gib']:.2f} GiB, device busy "
          f"{lm_train['busy_share']:.1%} (profiled); step 0's bf16 loss "
          f"{lm_train['step0']['bf16'][0]:.6f} vs float32's "
          f"{lm_train['step0']['float32'][0]:.6f}; lm-readout "
          f"extract {readout['extract_s']:.3f} s, held-out error "
          f"{readout['err']:.4f}, train error {readout['tr_err']:.4f}")
    print(f"[device_ms] {READINGS['kept']} readings kept, "
          f"{READINGS['retaken']} taken again behind a longer spin, "
          f"{READINGS['host_paced']} paced by the host")
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(sys.argv[2]))
    try:
        sys.exit(main())
    except Exception as exc:  # report the failed phase, exit non-zero
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
