#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--serve-only | --sharded-only | --legacy-only |
                           --lm-only | --train-only | --mesh-only |
                           --ci-only | --bench-only]

``--serve-only`` runs phases 1 and I alone (the job server in a fresh
process), ``--sharded-only`` phases 1, J and K, ``--legacy-only`` phases 1
and L (without L (c)'s readings, which come from phases 4 and G),
``--lm-only`` phases 1, 5-9 and M-R (the LM serving path),
``--train-only`` phases 1, S, T, U and V (LM training), ``--mesh-only``
phases 1 and W (LM training on a mesh), ``--ci-only`` phase 1 and
``launch/ci_smoke.py`` on the card (the CI smoke suite: engine,
resilience, serve, serve-chaos, kernel and docs smokes, each in a child
process), ``--bench-only`` phases 1 and Y (the benchmark drivers); none
prints the result line.
Needs one CUDA card and the CUDA toolkit (``nvcc``); exits nonzero,
printing no result, without them.
Phases (each raises on failure):

1. the card's name and power limit; build every kernel from ``csrc/``;
   ptxas's registers, stack frame and spills of each kernel body;
2. each kernel against its plain PyTorch version on B20 8x8x8 (4,096 atoms,
   0.08 A thermal jitter, random spins, production spec, capacity 64): f64
   within 1e-9 and f32 within 1e-4 of each output's max |ref|, K1 and K2
   each in both bodies (warp per atom, the default at this spec, and thread
   per atom); and ``nep_compute`` through the kernels against the autograd
   ``compute``;
3. the main path: ``Engine`` with ``NEPSpinPotential(use_kernel=True)`` on
   32x32x32 B20 cells (262,144 atoms) for 3 chunks x 20 steps at 300 K in a
   0.2 T field; launch counts must equal 1 + steps + rebuilds (one
   evaluation at construction, one per step, one per rebuild), every K1 and
   K2 launch in the warp-per-atom body;
4. each kernel (K1 and K2 in both bodies) against its plain version at the
   main path's shapes (f32, 1e-4), and times of each with CUDA events (the
   bodies in turns: warp, thread, thread, warp), beside the least time the
   card could take (bytes at 3.35 TB/s or f32 operations at 67 TFLOP/s);
5. SSD and FA against their plain versions on the sweeps of
   ``tests/test_kernels_ssd.py`` and ``tests/test_kernels_attention.py``,
   SSD at Mamba-2-2.7B's chunk (L=128, P=64, N=128: the CUDA-core body's
   other shared-memory layout), SSD in both bodies (tensor cores, the bf16
   default, and CUDA cores) on bf16 copies of the f32 sweep cases plus the
   bf16 one (N = 128 among them), and FA's tensor-core body on bf16 copies
   of the f32 sweep cases plus d = 80 and dv = 24 cases (its exact and
   guarded instantiations: window, ragged S and T, GQA, dv != d,
   dv % 16 = 8): f32 within 1e-4 of max |ref|; bf16 inputs within 5e-4 for
   SSD (its outputs are f32 on both sides) and 2e-2 for FA (its output is
   rounded to bf16; bf16 runs FA's tensor-core body, f32 its CUDA-core
   body);
6. Zamba2-2.7B at full width and depth (54 layers, d_model 2560, random
   weights from a seed) in f32 with TF32 off: forward logits of B=2 x
   S=256 tokens (two SSD chunks) against 256 decode steps from empty
   caches, within 5e-3 of max |logit|;
7. the LM main path, bf16: ``make_prefill_fn`` at B=2, S=8,192 (the
   ``prefill_32k`` shape cut to one card), one warm call and the median of
   3 in prefill tokens/s; every call must launch SSD 54 times, all in its
   tensor-core body, and FA 9 times (bf16, so FA's tensor-core body;
   counts set to 0 before each call), and give finite logits;
8. ``make_decode_fn`` at B=8 against 8,192-slot caches, 64 greedy steps
   after 2 warm ones, in decode tokens/s; decode runs no kernel, so the
   counts must stay 0;
9. SSD and FA at the prefill's shapes against their plain versions, in
   f32 (1e-4) and in bf16 (SSD 5e-4, both bodies; FA 5e-3, about one bf16
   ulp of its largest output), and FA's bf16 output row by row against the
   f32 plain
   version on the same (bf16-valued) inputs: each output's error beyond
   half a bf16 ulp (its own rounding), over its row's max |ref|, within
   1e-4 (P V with P's bf16 hi half alone reads ~3e-3 there); timed in bf16
   beside the plain versions (SSD's bodies in turns: tc, cuda_core,
   cuda_core, tc) and, for FA, the library call
   ``scaled_dot_product_attention`` (a yardstick the port never calls),
   and the least time the card could take (bytes at 3.35 TB/s or
   contraction flops at the bf16 dense peak of 989 TFLOP/s);
M. FA's new instantiations against ``flash_attention_plain`` at the zoo's
   prefill shapes (B=2): d = 120 with window 4,096 at h2o-danube's 32 / 8
   heads, S = T = 8,192 (the 8-k-step body, its last k-step on zeroed pad
   columns); d = 192, dv = 128 at deepseek-v3's 128 heads, S = T = 4,096
   (the 12-k-step body); non-causal S = 2,048 against T = 8,192 at
   seamless's 16 heads of 64: f32 within 1e-4 of max |ref|, bf16 within
   2e-2 and row by row beyond rounding within 1e-4 (phases 5 and 9's
   bars), every bf16 launch on the case's tensor-core body; each timed in
   bf16 beside the plain version, ``scaled_dot_product_attention`` (GQA;
   the window as a boolean mask) and the bound (bytes at 3.35 TB/s or the
   pairs the masks keep, 2 (d + dv) flops each, at 989 TFLOP/s);
N. qwen2-7b at full width and depth (28 layers, d_model 3,584, random
   weights): f32 forward against decode at B=2, S=256 with TF32 off
   (5e-3 of max |logit|); ``make_prefill_fn`` in bf16 at B=2, S=8,192, one
   warm call and the median of 3 (FA 28 launches a call, all on the
   tensor-core body; finite logits), decode at B=8 against 8,192-slot
   caches, 64 steps after 2 warm ones (no launch);
O. h2o-danube-3-4b (every FA launch at d = 120), minitron-4b and
   starcoder2-3b at full width and depth: a warm and a timed bf16 prefill
   (FA n_layers a call), ``ZOO_DECODE_STEPS`` decode steps; positions/s,
   tokens/s, peak memory;
P. moonshot-v1-16b-a3b at full width (64 experts, top 6, 2 shared, the
   dense dispatch), its depth cut from 48 layers to the largest whose bf16
   weights and decode caches (B=8, 8,192 slots) leave ``MOE_HEADROOM_GIB``
   of ``MOE_MAX_GIB`` (``moe_depth``); prefill and decode as in N; its
   peak must stay below ``MOE_MAX_GIB``;
Q. pixtral-12b at full width and depth, a prefill with 25 % of the 8,192
   positions as ``embeds``, and decode; deepseek-v3-671b at full width
   with its depth cut to first_dense + 1 = 4 layers (3 dense MLA layers, 1
   MoE layer of 256 experts): f32 forward against decode at B=1, S=256
   with the capacity factor at E / k (no prefill drops), a bf16 prefill
   with FA 4 launches on the d = 192 body, and decode through the absorbed
   MLA;
R. seamless-m4t-large-v2 at full width and depth: a prefill of 8,192
   source frames and 2,048 target tokens (FA 24 + 2 x 24 = 72 a call),
   and decode at B=8 against the encoder's cross K/V; one
   ``{"lm_zoo": ...}`` line with phases M-R's numbers and times;
S. the FA backward kernel (``flash_attention_bwd.cu``, two passes; bf16
   on the tensor-core bodies ``tc_k8`` / ``tc_k12``, f32 on the CUDA
   cores, each call on the body ``fa_bwd_body`` names) on the kernel
   forward's o and lse against ``flash_attention_bwd_plain`` on the same
   q, k, v, dO and the plain forward's own o and lse: the FA sweep's
   cases, the tensor-core bodies' edges in bf16 (``FA_BWD_TC_CASES``: d =
   120's padded k-step at GQA 7 with a window and ragged tiles, d = 192 /
   dv = 128 at ragged S, non-causal S < T) and every training shape of
   phase T (qwen2's d = 128 at 28 / 4 heads, S = T = 4,096; h2o's d = 120
   with window 4,096 at S = T = 8,192; deepseek's d = 192 / dv = 128 at
   128 heads; seamless's non-causal cross attention, S 1,024 x T 4,096;
   phase V's zamba2 shared block, d = dv = 80 at 32 / 32 heads, S = T =
   4,096),
   f32 within 1e-4 and bf16 within 5e-3 of each output's max |ref|, each
   kernel call ``torch.equal`` to a second; the forward's lse, f32 and
   bf16 (every body), against the plain version's (1e-5); ptxas must
   report no spills in either pass of either tensor-core body; at the
   training shapes, bf16 timed in turns with the earlier CUDA-core bf16
   body (launched by its index), beside the plain
   version, the SDPA backward (``torch.autograd.grad`` through
   ``scaled_dot_product_attention``, a retained graph; the library's time,
   which the port never calls) and the bound (``launch/roofline.py:
   fa_bwd_work``: q, k, v, o, dO, lse read once, dq, dk, dv written once;
   2 (3d + 2dv) flops a kept pair at 989 TFLOP/s), with ptxas's report of
   both passes of both bodies;
T. LM training through ``launch/train.py:train_lm`` on random weights and
   ``data/tokens.py``'s synthetic stream: (a) qwen2-7b at full width, its
   depth cut by ``train_depth`` to the most layers whose bf16 weights and
   gradients, f32 accumulation buffers and f32 AdamW moments (16 bytes a
   parameter) fit ``TRAIN_BUDGET_GIB``, B = 2 x S = 4,096 a microbatch,
   accumulation 2, remat, ``TRAIN_STEPS`` steps: the mean loss of the
   last 3 steps below the first 3's, every loss and gradient norm finite, FA launches
   a step exactly 2 forwards (all on the d = 128 tensor-core body) and 1
   backward (both passes, all on the backward's ``tc_k8`` body) per layer
   and microbatch; step time, tokens/s,
   peak memory; (b) 2 layers, B = 1 x S = 1,024, of qwen2 in f32 and in
   bf16 (the d = 128 tensor-core body) and of deepseek-v3 in bf16 (its
   dense MLA layers, the d = 192 bodies; every backward on the body
   ``fa_bwd_body`` names, f32's on ``cuda_core``): the loss and every leaf's
   gradient through the kernels against the same with
   ``flash_attention_plain`` / ``flash_attention_bwd_plain`` on the card,
   f32 within 1e-4; bf16 both paths against the plain path in f32 on the
   same weights, the kernels' error per leaf at most 1.5 times the plain
   path's and the loss within 1e-3 of the plain bf16 path's; (c) one step
   each at full width, depth cut the same way:
   h2o-danube-3-4b (B = 1 x 8,192, the window binding), moonshot (the MoE
   dense dispatch), deepseek-v3 (its leading dense MLA layers, d = 192)
   and seamless (4,096 source frames, 1,024 target tokens; FA enc + 2 dec
   a microbatch), finite loss and gradient norm, FA launches as in (a);
   one ``{"lm_train": ...}`` line with phases S-T's numbers and times;
U. the SSD backward kernel (``ssd_chunks_bwd.cu``: bf16 on the tensor
   cores where ``ssd_bwd_body`` names ``"tc"``, dB / dC summed over a
   cluster of heads in the kernel; f32 on the CUDA cores, per-head dB /
   dC partials summed by torch) against ``ssd_chunks_bwd_plain`` on the same inputs (x, b, c strided views of
   one projection buffer; ``cum`` from the forward kernel; normal
   gradients of the three outputs): the SSD sweep's cases (G = 1, 2, 4,
   f32 and bf16) and phase V's training shapes, mamba2's N = 128 and
   zamba2's N = 64 at B = 2 x S = 4,096, 80 heads of 64, in f32 and bf16;
   each f32 gradient (before the cast to its input's dtype) within 1e-4
   (f32) or 5e-4 (bf16 inputs) of its max |ref|, two calls
   ``torch.equal``, the cast gradients the f32 ones cast, every call on
   the body ``ssd_bwd_body`` names; at the training shapes, bf16 timed
   with CUDA events in turns with the earlier bf16 body (the CUDA-core
   one), beside the plain version and the bound (``launch/roofline.py:
   ssd_bwd_work``: inputs read once, gradients written once at their
   inputs' widths, the least products at 989 TFLOP/s), no library call,
   the dB / dC partial bytes of both bodies, the cluster size, the
   occupancy calculator's blocks an SM and resident clusters; ptxas's
   report of every instantiation, none of the tc body's exact ones
   spilling;
V. Mamba-2 and Zamba2 training through ``train_lm``: (a) mamba2-2.7b at
   full width, its depth by ``train_depth`` (all 64 layers fit), B = 2 x
   S = 4,096 a microbatch, accumulation 2, remat, ``TRAIN_STEPS`` steps:
   the mean loss of the last 3 below the first 3's, every loss and
   gradient norm finite, SSD launches a step exactly 2 forwards and 1 backward per
   layer and microbatch, all ``"tc"``, FA none; step time, tokens/s, peak
   memory; (b) mamba2 at 2 layers and zamba2 at 6 (one shared-block
   call), B = 1 x S = 1,024, f32 and bf16: the loss and every leaf's
   gradient through the kernels against the same with the plain versions
   (``ssd_chunks_plain`` / ``ssd_chunks_bwd_plain``, FA's) at phase
   T(b)'s bars; (c) zamba2-2.7b at full width (all 54 layers), the same
   batch, 3 steps: finite, SSD as in (a), FA 1 forward (``tc_exact``) and
   1 backward (``tc_k8``) per shared-block call and microbatch; one
   ``{"ssm_train": ...}`` line with phases U-V's numbers and times;
W. the LM zoo on a mesh of two ranks (NCCL with a card each when there
   are two cards, else gloo ranks sharing the one card, which measures
   no scaling): ``MESH_CASES`` at full width, depth by ``train_depth`` at
   ``MESH_BUDGET_GIB`` over the ranks sharing a card (times the ranks
   sharing the state under tp / fsdp), cut to ``MESH_MAX_LAYERS``, B = 2
   x S = 4,096 a microbatch (fsdp 512), accumulation 2: (a) qwen2-7b
   ``dp`` over data = 2, (b) qwen2-7b ``tp`` (14 q / 2 kv heads a rank)
   and ``fsdp`` over model = 2, (c) mamba2-2.7b ``tp`` (40 of 80 heads a
   rank), (d)
   moonshot-v1-16b-a3b ``tp`` with ``moe_impl="ep"`` on a 1 x 2 mesh (32
   of 64 experts a rank), whose MoE layer is first held against the
   dense dispatch at capacity factor E/k (neither drops: asserted) within
   ``MESH_EP_BAR``.  Each case's one-rank step (the same parameters,
   global batch and seed; cases that share them share it) runs first,
   all of them in one process of their own, then the ranks run every
   case through ``launch/train.py:train_lm_on_mesh`` for its 2 steps
   (3, and 5 for (a), until the time limit cut them): loss and gradient
   norm of steps 1-2 within ``MESH_LOSS_BAR`` / ``MESH_GNORM_BAR`` of the one
   rank's (W(d), at the config's own capacity factor, where the paths
   drop different tokens: ``MESH_EP_*``), each rank's FA and SSD
   launches a step equal to the one rank's and to ``train_launches``
   (bf16: ``tc_k8`` / ``tc`` only); the median global tokens/s of steps
   2 on, the gradient reduction's seconds, each rank's peak memory, the
   SSD backward's cluster K a rank, the MoE drops of each path; one
   ``{"lm_mesh": ...}`` line;
X. the CI smokes and the LM dry run: (a) ``launch/kernel_smoke.py`` on
   the card (the reference's spec, B20 4^3 with a 0.08 A jitter, capacity
   64): K1 and K2 launched once each on the body the spec picks (warp),
   E / F / H_eff within 1e-4 / 2e-4 / 2e-4 of the plain versions, the
   kernels more than 1.2x faster than the plain versions on the card
   (median of 3 x 5 calls), no build or load across four chunked calls;
   (b) ``launch/engine_smoke.py`` on two gloo ranks sharing the card
   (Sharded plan, field cooling, runlog contract, bitwise
   checkpoint/resume); (c) ``DRY_LM_CELLS`` through
   ``launch/dryrun.py:run_all`` (host only, ``CUDA_VISIBLE_DEVICES=""``,
   started right after phase 1 in the background and read here): per
   cell FLOPs a rank, bytes, collectives by kind, whether it fits the
   card, the roofline's bottleneck and its host seconds; one ``{"ci":
   ...}`` line;
A. field cooling at the main path's size: ``Engine`` with K1/K2 under
   ``protocol.field_cooling(300, 100, 0.2, t_hold=0.02, t_ramp=0.04)``,
   4 chunks x 20 steps, all six observables every 5 steps, a runlog with
   ``HealthConfig(max_spin_dev=1e-3)``, a profiler trace and a checkpoint
   every chunk (keep 2, the chunk-2 step pinned), under ``build/``; run
   once bare and once with all of that: every step's temperature equals
   the protocol's formula written out in numpy and its field 0.2 T along
   z, every K1/K2 launch is in the warp body (1 + steps + rebuilds), the
   runlog parses with 0 compiles after the first chunk and every verdict
   "ok", the profiled run wrote a non-empty Chrome trace, and the runs
   end bitwise equal; steps/s of each, and a checkpoint's size, save time
   (and the call time of ``save_md``'s async write) at this size;
B. the chunk-2 checkpoint restored into a fresh Engine and run through
   chunks 3-4: ``torch.equal`` with phase A's final pos, vel, spin, step,
   rebuild count and trace rows; the restore time;
C. Heisenberg-DMI on the same 262,144-atom B20 lattice (Morse minimum at
   the Fe-Fe distance), 2 chunks x 20 steps, midpoint with 2 iterations,
   300 K: steps/s and peak memory; a resume from the chunk-1 checkpoint
   bitwise equal; the deterministic pair-reaction and spin-grid sums
   against ``index_add_`` on the same inputs (f32 within 2e-5 of max
   |ref|; two deterministic evaluations equal), and both timed;
   one ``{"md_surface": ...}`` line with phases A-C's numbers;
D. the md_loop scenario (``launch/md_loop.py``: simple cubic 16^3 = 4,096
   atoms, chunk 20, skin 0.2, capacity 8, 500 K): Heisenberg-DMI fused
   against legacy (400 steps), autograd NEP-SPIN fused against legacy (60),
   the K1/K2 path (20) against the autograd fused path, and telemetry
   runs against bare ones in turns, with the scenario's gates (>= 3
   rebuilds per fused run, 1 on the
   kernel path; no kernel build or load while timed; telemetry overhead
   under 25 %); every K1 and K2 launch of the kernel path in the warp
   body; then K1 and K2, both bodies, on the kernel path's own table,
   blocks and spins after its timed run against the plain versions (f32
   1e-4; f64 1e-9 on the same inputs cast); one ``{"md_loop": ...}`` line
   with those errors;
E. the Replicated plan at full width: 4 copies of the main path's lattice
   (4 x 262,144 atoms, each replica's velocities and a 0.02 A position
   jitter from its own generator) under phase A's field cooling, 3 x 20
   steps: K1 and K2 launches equal 1 + steps + rebuilds (one launch per
   evaluation for all replicas), all warp; (b) K1 and K2 on an R = 4
   batch of B20 8x8x8, both bodies, against the plain versions (f64 1e-9,
   f32 1e-4) and each replica bitwise a flat launch; (c) a 10-step chunk
   of the batch bitwise 4 flat Engines on its table with the same
   generators; (d) checkpoints every chunk leave the run bitwise as it
   was, and a resume from the chunk-1 checkpoint is bitwise the
   uninterrupted run; (e) per-slot mode on a frozen lattice:
   ``write_slots`` into slot 2 between chunks leaves slots 0, 1 and 3
   bitwise unchanged; replica-steps/s, atom-steps/s, peak memory, and K1
   and K2 per batched launch beside 4 flat launches (in turns); one
   ``{"replica_plan": ...}`` line;
F. the ensemble layer: ``launch/skyrmion_nucleation.py`` at
   ``nucleation_ensemble()`` (8 x 32x32x1 films, Heisenberg-DMI, thermal
   and cold; depth cut to ``NUCLEATION_STEPS``), parallel tempering on
   four of its films, a 4-rung ladder over its protocol's 20-95 K, a swap
   attempt every 10 steps for ``TEMPERING_CHUNKS`` chunks (accepts > 0),
   ``run_sweep`` on
   ``nucleation_ensemble_smoke()``'s grid, and ``launch/ensemble_rate.py``
   at R = 1, 4 and 16; one ``{"ensemble": ...}`` line;
G. training and the fitted potential (f32 on the card):
   ``launch/accuracy.py`` (B20 2x2x2 with its oracle, 24 training and 8
   validation configurations; Adam for ``FIT_STEPS`` = 150 steps on
   ``nepspin`` and ``nep-nospin``, the classical (J0, D0) scan) with
   ``tests/test_system.py``'s bars on ``nepspin`` (final loss under 0.25x
   the first, validation F and H RMSE under 0.35x their label scales);
   ``fit_snes`` for ``SNES_GENERATIONS`` generations (cut from 100); the
   loss and its gradient at f64 on the card against the CPU (1e-9);
   ``launch/train.py``'s ``train_md`` at ``--cells 32`` (262,144 atoms;
   its own fit, then 160 K, 0.1 T, dt 2 fs, 4 chunks x 25 steps through
   ``NEPSpinPotential(use_kernel=True)``): finite values, Fe |S| in
   (0.3, 2), K1/K2 launches 1 + steps + rebuilds, all in the body the
   spec selects (warp); the kernel path against the autograd evaluation
   with the fitted weights (1e-4); K1 and K2 in both bodies on the run's
   own table, blocks and spins against the plain versions (f32 1e-4, f64
   1e-9), and both bodies timed; one ``{"training": ...}`` line;
H. supervised recovery on phase A's 262,144-atom field-cooling Engine
   (K1/K2), 4 chunks x 20 steps, a checkpoint every chunk: a NaN in the
   forces and a bit flip (bit 30 of one spin component) at step 45, the
   flip once with the plan's own seed 0 and once with the first seed whose
   row is of the other type (an Fe spin and a Ge spin, 0 -> 2.0), each
   recovered bitwise to the uninterrupted run with 0 kernel builds
   or loads after the rollback, the runlog holding fault_injected,
   rollback, retry and recovered and ``launch/report.py`` rendering each;
   the dt ladder on a persistent fault inert below full dt (half dt for
   ``degrade_span`` chunks, then back); ``rebind`` on Replicated(4) at
   phase E's size; ``launch/resilience_smoke.py`` (supervised retry, a
   SIGKILLed child and a bitwise resume); the supervised run's wall time
   against the clean run's and one rollback's; one ``{"resilience": ...}``
   line;
I. the batched simulation job server (``repro_torch.serve``): (a)
   ``launch/serve_smoke.py``: ``launch/serve.py``'s Heisenberg-DMI fleet
   at f64 through a packed 2-slot server and a solo 1-slot server, every
   stream and final state bitwise, no kernel build or load after a
   bucket's first chunk, the accounting closed; (b) the card-scale
   NEP-SPIN fleet (production spec, random weights, K1/K2, f32, frozen
   lattice, chunk 20, obs_every 10): 6 jobs on each of B20 16^3 (32,768
   atoms) and 32^3 (262,144), 4 slots per bucket, budgets 40/60/80 steps
   (backfills), a 300 K hold, a 300 -> 100 K anneal, a 0.2 T field and
   field cooling; each bucket's evaluations equal 1 + steps + backfills
   and the K1 and K2 launches their sum (one launch per evaluation for all
   slots), all in the warp body, 0 steady builds and warmup no larger
   than the kernel libraries, the accounting closed; K1 and K2 (warp)
   on each bucket's own blocks and spins after that drain against their
   plain versions, f32 within 1e-4 and f64 within 1e-9 (the large
   bucket's first 8,192 rows of every slot); every small-bucket job and
   two large ones bitwise their solo runs; four timed drains after the
   first, journal off / on / on / off, each bitwise the first: jobs/s,
   slot-steps/s and atom-steps/s over the journal-off drains, the same
   rates over their segments with every slot busy, the journal's
   overhead per pair; peak memory; a journaled fleet abandoned after two
   ticks, ``SimServer.recover`` and the resubmission timed, then
   drained: the accounting closed and the resumed jobs' remaining
   streams bitwise; (c) a NaN temperature schedule among three
   small-bucket jobs evicted through the supervisor's ``evict_slot_hook``,
   the three bitwise their solo runs; (d) ``launch/serve_chaos_smoke.py`` (faults, a SIGKILLed child,
   recovery, the remaining streams bitwise, f64); one ``{"serving": ...}``
   line;
J. the Sharded plan (``torch.distributed``; ``parallel/{plan,halo,domain}``):
   (a) the main path's run (262,144 atoms, K1/K2, f32, 300 K, 0.2 T, 3 x
   20 steps) through ``Engine(plan=Sharded())`` on one NCCL rank: E, F and
   H_eff at construction within 1e-4 of the flat Engine's, K1 and K2
   launches 1 + steps + rebuilds, all warp, one drift-pos exchange a
   step; steps/s beside phase 3's, rebuilds, migrations, the halo ledger,
   the resolved cells, peak memory; K1/K2 on the rank's own slots
   against the plain versions (the first ``SHARDED_KERNEL_ROWS``, K2
   through the local-first table over the owned + halo-ring adjoint
   rows; f32 1e-4); (c) a checkpoint after chunk 1 restored into a fresh
   Engine, chunks 2-3 ``torch.equal`` to the uninterrupted run; (b) two
   gloo ranks on the one card (1-D ``"sx"``, allgather halos through the
   host: no scaling figure): B20 8^3 (4,096 atoms, 600 K, a 0.25 A
   jitter) at f64 for 40 NVE steps, NEP-SPIN through K1/K2 and
   Heisenberg-DMI midpoint (2 iterations), each with >= 1 rebuild and
   migrations, within 1e-9 of the flat Engine on the card; the main
   path's 262,144 atoms at f32 for 2 x 20 steps (finite, launches 1 +
   steps + rebuilds on each rank, all warp); K1/K2 on each rank's slots
   against the plain versions (f32 1e-4, f64 1e-9); then the main path's
   checkpoint for phase K (b) and its same-mesh elastic restore; one
   ``{"sharded": ...}`` line;
K. the rest of the Sharded plan: (a) the main path's lattice through
   ``Engine(plan=Sharded(replicas=4))`` on one NCCL rank (4 x 400,896
   slots, each replica its own cells, table and generator) for one chunk
   of 10 steps that trips no rebuild: K1 and K2 launches 1 + steps, all
   warp (one batched launch per evaluation for the 4 replicas); each
   replica's state ``torch.equal`` to a ``Sharded()`` Engine's run with
   that replica's generator; the batched per-replica-table K1/K2 launch
   ``torch.equal`` to 4 flat launches and timed beside them (in turns),
   and against the plain versions on each replica's first
   ``SHARDED_KERNEL_ROWS`` slots (f32 1e-4); replica-steps/s beside J(a)'s
   steps/s, peak memory; (b) the checkpoint two gloo ranks wrote in J(b)
   restored elastically onto the one NCCL rank: the gathered state
   ``torch.equal`` to the writers', E, F and H_eff within 1e-4 of the
   writers' same-mesh elastic restore, the gather and the whole restore
   timed; (c) on two gloo ranks at f64 (B20 8^3, NEP-SPIN through K1/K2,
   40 NVE steps): a corrupted halo face on rank 1 under the Supervisor
   (``rollback, retry, recovered``, ``torch.equal`` to the clean run), a
   persistent overflow on rank 1 (the capacity rung, K at least doubled,
   step 40), elastic restore 2 -> 1 -> 2 (energies within 1e-10 of a
   same-mesh restore and of a one-rank restore, 1e-8 after 20 steps on);
   (d) a 2 x 2 ``("replica", "sx")`` mesh of 4 gloo ranks at f64 (NVE
   replicas ``torch.equal``, each within 1e-12 of a ``Sharded(devices=
   (0, 1))`` run on two of the ranks) and ``Replicated(4)`` split over 2
   gloo ranks (through a checkpoint) ``torch.equal`` to its one-process
   run; one ``{"sharded_replicas": ...}`` line;
L. the legacy per-evaluation domain paths on one NCCL rank: (a)
   ``distributed_kernel_force_fn`` (K1 -> one q_Fp halo round -> K2) on
   the main path's 262,144-atom state binned into cells at least the
   cutoff wide: E, F and H_eff within 1e-4 of the flat ``nep_compute``,
   one K1 and one K2 launch, both warp; K1/K2 on its slots against the
   plain versions (first ``LEGACY_KERNEL_ROWS``, f32 1e-4) and timed; one
   evaluation timed; (b) the stencil and pruned autograd paths and the
   kernel path at f64 on B20 8^3 against the flat evaluation and each
   other at ``tests/test_domain.py``'s bars (of max(|ref|, 1)); (c)
   ``launch/roofline.py``'s ``nep_report`` at the main path (taken in
   phase 4: its bounds must read ``MAIN_PATH_BOUNDS``) and at the fitted
   spec (taken in phase G); (d) the dry run's MD cells through
   ``launch/dryrun.py:run_all`` (md_small and md_large on fake 256- and
   512-rank worlds, host only, started in the background at phase S in
   the whole run, beside phases S to V, which time nothing on the host,
   at the phase's beginning with ``--legacy-only``) and
   ``report.dryrun_main``'s tables; one ``{"legacy": ...}`` line;
Y. the benchmark drivers: ``launch/bench_run.py --strict`` on the card,
   each driver in a child process at its card size
   (``kernel_rows`` B20 32^3 = 262,144 atoms or the largest whose autograd
   row fits, ``ablation`` 16^3, ``throughput --kernel`` 8-48^3 up to
   884,736 atoms until one runs out of memory, ``scaling`` 1 NCCL rank
   and 2 / 4 gloo ranks sharing the card, ``accuracy``, ``ensemble_rate``,
   ``serve_rate``, ``md_loop``); the whole run, cut for the time limit,
   runs ``BENCH_WHOLE_RUN`` alone (the drivers whose rows launch kernels).
   ``kernel_rows`` and ``throughput --kernel`` fail on the card if a
   kernel of their rows launched no time; one ``{"bench": ...}`` line
   with each driver's own JSON and the launches by body of those two
   (the kernel rows' K1, K2, FA and SSD, ``throughput``'s K1 and K2);
10. the card's name and power limit, one ``{"kernels": [...]}`` line with
    all six kernels (SSD's backward with phase V(a)'s launches a step and
    V(c)'s as ``launches_zamba2``, phase U's errors, and its time, plain
    time, bound and ptxas at mamba2's shape and, with the case's name
    appended, at zamba2's; SSD's forward with ``launches_train`` and
    ``launches_train_zamba2``; FA's backward with phase T(a)'s launches a step,
    phase S's errors, times, bound and ptxas at qwen2's shape and, with
    the case's name appended, at the other training shapes; FA's forward
    with ``launches_train`` and ``body_train``; FA's and SSD's forward
    and backward with ``launches_mesh_a_step_by_rank`` (phase W(b) tp,
    W(c)); K1, K2, SSD and SSD's
    backward with ``body`` and ``previous_ms``, the earlier body's time
    in this run (the backward's also with its partial bytes, cluster
    size and occupancy); FA's ``previous_ms`` null, as its
    earlier body is gone; all with ptxas's report of the body timed; K1
    and K2 with ``launches_field_cooling`` from phase A, from phase E
    ``launches_replica``, ``replica_ms`` and ``replica_flat_ms`` (one
    batched launch at R = 4, and 4 flat launches), and from phase G
    ``launches_training``, ``body_training``, ``max_rel_err_training`` and
    ``ms_training`` (each body's time at the fitted spec), and from phase
    I ``launches_serving`` and ``max_rel_err_serving``, from phase J
    ``launches_sharded``, ``ms_sharded`` (each on the one rank's 400,896
    slots) and ``max_rel_err_sharded``, and from phase K
    ``launches_sharded_replicas``, ``ms_sharded_replicas`` (one batched
    launch over 4 x 400,896 slots), ``sharded_replicas_flat_ms`` (4 flat
    launches) and ``max_rel_err_sharded_replicas``, and from phase L
    ``launches_legacy``, ``ms_legacy``, ``max_rel_err_legacy`` and the
    fitted spec's ``bound_ms_fitted``, ``bound_by_fitted`` and
    ``ms_fitted``; FA with ``launches_<arch>`` per prefill of each arch of
    phases N-R and, for each case of phase M (``d120``, ``d192``,
    ``noncausal``), ``ms_``, ``bound_ms_``, ``bound_by_``,
    ``library_ms_``, ``plain_ms_``, ``max_rel_err_`` and ``ptxas_``
    followed by the case's name); K1 and K2 with phase X's
    ``launches_kernel_smoke`` and the smoke's whole evaluation (gather,
    K1, K2) timed as ``eval_ms_kernel_smoke`` beside the plain versions'
    ``plain_eval_ms_kernel_smoke``; K1, K2, FA and SSD with phase Y's
    ``launches_bench_kernel_rows`` and K1 and K2 with
    ``launches_bench_throughput``, by body; the script's wall seconds,
    then ``{"ok": true, "device": ...}``.  Every bound is
    ``launch/roofline.py``'s.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
KERNELS = {
    "nep_atom_pass": dict(
        source="src/repro_torch/kernels/nep/csrc/nep_atom_pass.cu",
        replaces="src/repro/kernels/nep/kernel.py:194"),
    "nep_force_pass": dict(
        source="src/repro_torch/kernels/nep/csrc/nep_force_pass.cu",
        replaces="src/repro/kernels/nep/kernel.py:379"),
    "ssd_chunks": dict(
        source="src/repro_torch/kernels/ssd/csrc/ssd_chunks.cu",
        replaces="src/repro/kernels/ssd/kernel.py:62"),
    "flash_attention_fwd": dict(
        source="src/repro_torch/kernels/attention/csrc/flash_attention_fwd.cu",
        replaces="src/repro/kernels/attention/kernel.py:68"),
    # no Pallas kernel: the reference differentiates its XLA
    # chunked_attention under jax.grad
    "flash_attention_bwd": dict(
        source="src/repro_torch/kernels/attention/csrc/flash_attention_bwd.cu",
        replaces="none: src/repro/models/attention.py:60 (chunked_attention,"
                 " differentiated by jax.grad)"),
    # no Pallas kernel: the reference differentiates its jnp ssd_chunked
    # under jax.grad
    "ssd_chunks_bwd": dict(
        source="src/repro_torch/kernels/ssd/csrc/ssd_chunks_bwd.cu",
        replaces="none: src/repro/models/ssm.py:61 (ssd_chunked, "
                 "differentiated by jax.grad)"),
}
# the sweeps of tests/test_kernels_ssd.py:10 and tests/test_kernels_attention.py:9
SSD_SWEEP = [   # bs, s, h, p, g, n, chunk, dtype
    (2, 64, 4, 8, 2, 16, 16, "float32"),
    (1, 48, 2, 16, 1, 8, 16, "float32"),
    (1, 128, 8, 8, 1, 32, 32, "float32"),
    (2, 64, 4, 8, 4, 16, 16, "float32"),
    (1, 64, 4, 8, 2, 16, 16, "bfloat16"),
    # Mamba-2-2.7B's chunk: N = 128 sends the CUDA-core body down its
    # unpadded shared-memory layout (230,400 of 232,448 bytes)
    (1, 256, 8, 64, 1, 128, 128, "float32"),
]
# bf16 copies of the f32 cases (N = 128: the tensor-core body's second
# exact instantiation; N = 8 and P = 16, 8: its guarded one)
SSD_SWEEP += [c[:7] + ("bfloat16",) for c in SSD_SWEEP if c[7] == "float32"]
FA_SWEEP = [    # b, s, t, h, hkv, d, dv, causal, window, dtype
    (2, 64, 64, 4, 2, 32, 32, True, 0, "float32"),
    (1, 48, 80, 4, 4, 16, 16, True, 16, "float32"),
    (2, 32, 64, 2, 1, 32, 32, False, 0, "float32"),
    (1, 40, 40, 8, 2, 64, 64, True, 0, "float32"),
    (1, 64, 64, 4, 1, 32, 16, True, 0, "float32"),
    (2, 64, 64, 4, 2, 32, 32, True, 0, "bfloat16"),
]
# FA's tensor-core body on the f32 cases in bf16 (its guarded
# instantiation), and its exact d = dv = 80 one with a window, ragged
# S < T and GQA, and dv % 16 = 8 (V's zeroed pad columns)
FA_TC_SWEEP = [c[:9] + ("bfloat16",) for c in FA_SWEEP[:5]] + [
    (1, 100, 130, 4, 2, 80, 80, True, 40, "bfloat16"),
    (2, 70, 70, 4, 4, 32, 24, True, 0, "bfloat16"),
]
# of max |ref|.  SSD's outputs are f32 on both sides, so bf16 inputs change
# nothing but the inputs; FA rounds its output to bf16 (the sweep keeps the
# reference suite's 2e-2; at the main shapes 5e-3 is about one bf16 ulp of
# the largest output)
SSD_BAR = {"float32": 1e-4, "bfloat16": 5e-4}
FA_BAR = {"float32": 1e-4, "bfloat16": 2e-2}
FA_MAIN_BF16_BAR = 5e-3
# FA bf16 at the prefill's shapes, row by row: error beyond the output's
# own rounding, over the row's max |ref| (see fa_beyond_rounding)
FA_MAIN_ROW_BAR = 1e-4
LM_ARCH = "zamba2-2.7b"
PREFILL_B, PREFILL_S = 2, 8192       # prefill_32k cut to one card
DECODE_B, DECODE_T, DECODE_STEPS = 8, 8192, 64
PARITY_B, PARITY_S = 2, 256          # two SSD chunks


def log(*args):
    """Print a line stamped with the seconds since the script started."""
    print(f"[{time.perf_counter() - T_START:7.1f} s]", *args, flush=True)


def rel_err(got, want) -> float:
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / max(scale, 1e-300)


def check(name, got, want, bar):
    err = rel_err(got, want)
    log(f"  {name:<28} rel err {err:.3e} (bar {bar:g})")
    if not err < bar:
        raise AssertionError(f"{name}: relative error {err:.3e} >= {bar:g}")
    return err


def time_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def ptxas_report(text: str) -> dict:
    """``{mangled kernel: {registers, stack_bytes, spill_bytes}}`` from an
    ``nvcc -Xptxas -v`` log."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out[name].update(stack_bytes=int(m.group(1)),
                             spill_bytes=int(m.group(2)) + int(m.group(3)))
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def ptxas_of(reports: dict, library: str, *parts) -> dict:
    """The report of the one kernel of ``library`` whose mangled name holds
    every one of ``parts``."""
    hits = [v for k, v in reports[library].items()
            if all(p in k for p in parts)]
    if len(hits) != 1:
        raise AssertionError(f"ptxas report of {library}: {len(hits)} "
                             f"kernels match {parts}")
    return hits[0]


# the timed bodies' kernels in ptxas's reports (mangled names): the warp
# bodies' flat instantiation (BATCH false) at the production spec, f32
PROD_SIZES = "SizesILi2ELi8ELi6ELi4ELi4ELi4ELi32ELi3EEEfLb0EE"
PTXAS_K1_WARP = ("nep_atom_pass", "atom_pass_warp_kernel", PROD_SIZES)
PTXAS_K1_THREAD = ("nep_atom_pass", "atom_pass_kernelIfE")
PTXAS_K2_WARP = ("nep_force_pass", "force_pass_warp_kernel", PROD_SIZES)
PTXAS_K2_THREAD = ("nep_force_pass", "force_pass_kernelIfE")
PTXAS_SSD_TC = ("ssd_chunks", "ssd_chunk_tc_kernelILi4ELi8ELb1E")
PTXAS_SSD_CC = ("ssd_chunks", "ssd_chunk_kernelI13__nv_bfloat16E")
PTXAS_FA_TC = ("flash_attention_fwd", "flash_fwd_tc_kernelILi5ELi5ELb1E")


# ---------------------------------------------------------------------------
# LM serving path: Zamba2-2.7B through the SSD and flash-attention kernels
# ---------------------------------------------------------------------------

def lm_counters():
    from repro_torch.kernels.attention import kernel as fa
    from repro_torch.kernels.ssd import kernel as ssd
    return ssd.ssd_chunks, fa.flash_attention_fwd


def reset_lm_counters():
    for fn in lm_counters():
        fn.launches = 0
        fn.body_launches = dict.fromkeys(fn.body_launches, 0)


def read_lm_counters():
    return tuple(fn.launches for fn in lm_counters())


def lm_sweeps(torch, dev):
    """Phase 5: each LM kernel against its plain version on the sweeps of
    the reference's kernel tests.  Returns the worst error per dtype."""
    from repro_torch.kernels.attention import kernel as fa
    from repro_torch.kernels.ssd import kernel as ssd
    gen = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    worst = {"ssd_chunks": {}, "flash_attention_fwd": {}}
    for i, (bs, s, h, p, g, n, chunk, dtype) in enumerate(SSD_SWEEP):
        dt_ = getattr(torch, dtype)
        x = rnd(bs, s, h, p).to(dt_)
        dtv = torch.nn.functional.softplus(rnd(bs, s, h))
        a = -torch.exp(rnd(h) * 0.5)
        b = (rnd(bs, s, g, n) * 0.3).to(dt_)
        c = (rnd(bs, s, g, n) * 0.3).to(dt_)
        body = ssd.ssd_body(x, b, c, chunk)
        if body != {"float32": "cuda_core", "bfloat16": "tc"}[dtype]:
            raise AssertionError(f"SSD sweep {i} {dtype} chose {body}")
        want = ssd.ssd_chunks_plain(x, dtv, a, b, c, chunk=chunk)
        # bf16 runs both bodies; the default's error is the one kept
        for bd in ssd.BODIES if body == "tc" else (body,):
            got = ssd.ssd_chunks(x, dtv, a, b, c, chunk=chunk, body=bd)
            torch.cuda.synchronize()
            err = max(check(f"SSD sweep {i} {bd} {o} {dtype}", u, w,
                            SSD_BAR[dtype])
                      for o, u, w in zip(("y_intra", "states", "cum"), got,
                                         want))
            if bd == body:
                w = worst["ssd_chunks"]
                w[dtype] = max(w.get(dtype, 0.0), err)
    cases = [("sweep", i, c) for i, c in enumerate(FA_SWEEP)] + [
        ("tensor-core sweep", i, c) for i, c in enumerate(FA_TC_SWEEP)]
    for label, i, (b, s, t, h, hkv, d, dv, causal, win, dtype) in cases:
        dt_ = getattr(torch, dtype)
        q, k, v = (rnd(b, s, h, d).to(dt_), rnd(b, t, hkv, d).to(dt_),
                   rnd(b, t, hkv, dv).to(dt_))
        got = fa.flash_attention_fwd(q, k, v, causal=causal, window=win)
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=win)
        torch.cuda.synchronize()
        err = check(f"FA {label} {i} {dtype}", got.float(), want.float(),
                    FA_BAR[dtype])
        w = worst["flash_attention_fwd"]
        w[dtype] = max(w.get(dtype, 0.0), err)
    return worst


def lm_parity(torch, dev, cfg, b=None):
    """Phase 6: full-width f32 forward logits of ``b`` (PARITY_B) x PARITY_S tokens
    against token-by-token decode from empty caches (the forward path runs
    the kernels, decode none)."""
    import dataclasses

    from repro_torch.models import lm
    from repro_torch.models import transformer as tfm
    b = PARITY_B if b is None else b
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(1)
    params = lm.init_params(cfg32, gen, device=dev)
    tokens = torch.randint(0, cfg.vocab, (b, PARITY_S), generator=gen,
                           device=dev)
    t0 = time.perf_counter()
    h, _, logits_fn = tfm.forward(cfg32, params, tokens)
    full = logits_fn(h).float()
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    if not bool(torch.isfinite(full).all()):
        raise AssertionError("f32 forward logits are not finite")
    caches = tfm.init_caches(cfg32, b, PARITY_S, torch.float32, dev)
    decode = lm.make_decode_fn(cfg32)
    err = torch.zeros((), device=dev)
    t0 = time.perf_counter()
    for i in range(PARITY_S):
        pos = torch.full((b,), i, dtype=torch.int32, device=dev)
        logits, caches = decode(params, caches,
                                {"token": tokens[:, i:i + 1], "position": pos})
        err = torch.maximum(err, (logits - full[:, i]).abs().max())
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    rel = float(err) / float(full.abs().max())
    log(f"  f32 forward {fwd_s:.2f} s, {PARITY_S} decode steps {dec_s:.2f} s;"
        f" max |decode - forward| / max |forward| = {rel:.3e} (bar 5e-3)")
    if not rel < 5e-3:
        raise AssertionError(f"decode vs prefill relative error {rel:.3e}")
    return rel


def lm_prefill(torch, dev, cfg, params):
    """Phase 7: timed bf16 prefill; every call must launch SSD once per
    Mamba-2 block and FA once per shared-block invocation."""
    from repro_torch.models import lm
    from repro_torch.models.transformer import padded_vocab
    gen = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S),
                           generator=gen, device=dev)
    prefill = lm.make_prefill_fn(cfg)
    expect = (cfg.n_layers, cfg.n_layers // cfg.shared_every)
    secs, counts = [], None
    torch.cuda.reset_peak_memory_stats(dev)
    for i in range(4):
        torch.cuda.synchronize()
        reset_lm_counters()
        t0 = time.perf_counter()
        logits = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts = read_lm_counters()
        if counts != expect:
            raise AssertionError(f"prefill call {i} launched (SSD, FA) = "
                                 f"{counts}, expected {expect}")
        ssd_bodies = lm_counters()[0].body_launches
        if ssd_bodies != {"tc": expect[0], "cuda_core": 0}:
            raise AssertionError(f"prefill call {i}: SSD launches by body "
                                 f"{ssd_bodies}, all must be tensor-core")
    if tuple(logits.shape) != (PREFILL_B, padded_vocab(cfg.vocab)) or not \
            bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                             "finite or of the wrong shape")
    med = sorted(secs[1:])[1]
    tps = PREFILL_B * PREFILL_S / med
    log(f"  prefill B={PREFILL_B} S={PREFILL_S}: warm {secs[0]:.3f} s, "
        f"calls {[round(s, 4) for s in secs[1:]]} s, median {med:.4f} s = "
        f"{tps:.1f} prefill tokens/s; launches in the last call (SSD, FA) "
        f"= {counts}, SSD by body {lm_counters()[0].body_launches}; peak "
        f"memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return {"tokens_per_s": tps, "median_s": med, "launches": counts}


def lm_decode(torch, dev, cfg, params, caches=None, steps=None):
    """Phase 8: timed bf16 greedy decode at B=DECODE_B against caches of
    DECODE_T slots (or the ``caches`` given, of that batch), ``steps``
    (DECODE_STEPS) steps after 2 warm ones; decode runs no kernel, so the counters must
    not move."""
    from repro_torch.models import lm
    from repro_torch.models import transformer as tfm
    steps = DECODE_STEPS if steps is None else steps
    gen = torch.Generator(device=dev).manual_seed(3)
    if caches is None:
        caches = tfm.init_caches(cfg, DECODE_B, DECODE_T, torch.bfloat16,
                                 dev)
    decode = lm.make_decode_fn(cfg)
    tok = torch.randint(0, cfg.vocab, (DECODE_B, 1), generator=gen,
                        device=dev)
    reset_lm_counters()

    def step(i, tok):
        pos = torch.full((DECODE_B,), i, dtype=torch.int32, device=dev)
        logits, _ = decode(params, caches, {"token": tok, "position": pos})
        return logits, logits.argmax(-1, keepdim=True)

    for i in range(2):                       # warm
        logits, tok = step(i, tok)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(2, 2 + steps):
        logits, tok = step(i, tok)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if read_lm_counters() != (0, 0):
        raise AssertionError(f"decode launched (SSD, FA) = "
                             f"{read_lm_counters()}, expected none")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("decode logits are not finite")
    tps = DECODE_B * steps / secs
    slots = max(t.shape[-1] for t in _leaves(caches) if t.dim() == 3)
    log(f"  decode B={DECODE_B} against {slots}-slot caches: {steps} "
        f"steps in {secs:.3f} s = {1e3 * secs / steps:.2f} ms/step = "
        f"{tps:.1f} decode tokens/s; no kernel launched")
    return {"tokens_per_s": tps, "ms_per_step": 1e3 * secs / steps}


def ssd_names(tag):
    return [f"SSD main {o} {tag}" for o in ("y_intra", "states", "cum")]


def compare_main(torch, names, kernel, plain, args, bar, **kw):
    """One kernel against its plain version on ``args``, one name per
    output; returns the worst relative and absolute errors."""
    got, want = kernel(*args, **kw), plain(*args, **kw)
    torch.cuda.synchronize()
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    rel = max(check(name, u.float(), w.float(), bar)
              for name, u, w in zip(names, got, want))
    return rel, max(float((u.float() - w.float()).abs().max())
                    for u, w in zip(got, want))


def lm_kernels_main(torch, dev, cfg, sweep_err, launches, ptxas):
    """Phase 9: each LM kernel at the prefill's shapes, against its plain
    version in f32 and in bf16 (the config's dtype); timed in bf16 beside
    the plain version, the library call where one exists, and the least
    time the card could take."""
    import math

    from repro_torch.launch import roofline
    from repro_torch.launch.roofline import nbytes

    from repro_torch.kernels.attention import kernel as fa
    from repro_torch.kernels.ssd import kernel as ssd
    from repro_torch.models.ssm import ssm_dims
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(4)
    bf16 = torch.bfloat16
    B, S = PREFILL_B, PREFILL_S
    rows = []

    # SSD: x, B and C as the strided views of the conv output
    s = cfg.ssm
    d_in, H = ssm_dims(cfg)
    G, N, P, L = s.n_groups, s.d_state, s.head_dim, s.chunk
    xbc = torch.randn((B, S, d_in + 2 * G * N), generator=gen, device=dev,
                      dtype=bf16)
    x = xbc[..., :d_in].view(B, S, H, P)
    b = xbc[..., d_in:d_in + G * N].view(B, S, G, N)
    c = xbc[..., d_in + G * N:].view(B, S, G, N)
    dt = F.softplus(torch.randn((B, S, H), generator=gen, device=dev))
    a = -torch.linspace(1.0, 16.0, H, device=dev)
    args = (x, dt, a, b, c)
    xbc32 = xbc.float()
    args32 = (xbc32[..., :d_in].view(B, S, H, P), dt, a,
              xbc32[..., d_in:d_in + G * N].view(B, S, G, N),
              xbc32[..., d_in + G * N:].view(B, S, G, N))
    rel32, _ = compare_main(torch, ssd_names("f32"),
                            ssd.ssd_chunks, ssd.ssd_chunks_plain, args32,
                            SSD_BAR["float32"], chunk=L)
    del xbc32, args32
    if ssd.ssd_body(x, b, c, L) != "tc":
        raise AssertionError("SSD at the prefill's shapes must take the "
                             "tensor-core body")
    rel, abs_err = compare_main(torch, ssd_names("bf16 tc"),
                                ssd.ssd_chunks, ssd.ssd_chunks_plain, args,
                                SSD_BAR["bfloat16"], chunk=L)
    compare_main(
        torch, ssd_names("bf16 cuda_core"),
        functools.partial(ssd.ssd_chunks, body="cuda_core"),
        ssd.ssd_chunks_plain, args, SSD_BAR["bfloat16"], chunk=L)
    nbytes_ssd, flops_ssd = roofline.ssd_fwd_work(x, dt, a, b, c, chunk=L)
    # the bodies in turns: tc, cuda_core, cuda_core, tc
    ssd_ms = {"tc": [], "cuda_core": []}
    for body in ("tc", "cuda_core", "cuda_core", "tc"):
        ssd_ms[body].append(time_ms(torch, lambda: ssd.ssd_chunks(
            *args, chunk=L, body=body), 20))
    log(f"  SSD by body, in turns (ms): {ssd_ms}")
    plain = time_ms(torch, lambda: ssd.ssd_chunks_plain(*args, chunk=L), 2)
    rows.append(kernel_row(
        "ssd_chunks", launches[0], abs_err, sum(ssd_ms["tc"]) / 2, plain,
        None, nbytes_ssd, flops_ssd,
        {"max_rel_err_f32": max(rel32, sweep_err["ssd_chunks"]["float32"]),
         "max_rel_err_bf16": max(rel, sweep_err["ssd_chunks"]["bfloat16"]),
         "body": "tc",
         "previous_ms": sum(ssd_ms["cuda_core"]) / 2,
         "previous_body": "cuda_core",
         "ptxas": ptxas_of(ptxas, *PTXAS_SSD_TC),
         "previous_ptxas": ptxas_of(ptxas, *PTXAS_SSD_CC)}))
    del xbc, x, b, c, dt, args
    torch.cuda.empty_cache()

    # FA: the shared block's causal GQA prefill attention
    Hq, Hkv, d = cfg.n_heads, cfg.kv_heads, cfg.hd
    q = torch.randn((B, S, Hq, d), generator=gen, device=dev, dtype=bf16)
    k = torch.randn((B, S, Hkv, d), generator=gen, device=dev, dtype=bf16)
    v = torch.randn((B, S, Hkv, d), generator=gen, device=dev, dtype=bf16)
    errs = fa_prefill_errors(torch, q, k, v)
    for name, key, bar in (("FA main f32", "f32", FA_BAR["float32"]),
                           ("FA main bf16", "bf16", FA_MAIN_BF16_BAR),
                           ("FA main bf16 by row", "bf16_row",
                            FA_MAIN_ROW_BAR)):
        log(f"  {name:<28} rel err {errs[key]:.3e} (bar {bar:g})")
        if not errs[key] < bar:
            raise AssertionError(f"{name}: relative error {errs[key]:.3e} "
                                 f">= {bar:g}")
    torch.cuda.empty_cache()
    nbytes_fa = nbytes(q, k, v) + B * S * Hq * d * q.element_size()
    flops_fa = 2.0 * B * Hq * (S * (S + 1) // 2) * (d + d)
    ms = time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, causal=True),
                 10)
    plain = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v,
                                                            causal=True), 1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=1 / math.sqrt(d)), 20)
    rows.append(kernel_row(
        "flash_attention_fwd", launches[1], errs["bf16_abs"], ms, plain, lib,
        nbytes_fa, flops_fa,
        {"max_rel_err_f32": max(
            errs["f32"], sweep_err["flash_attention_fwd"]["float32"]),
         "max_rel_err_bf16": max(
             errs["bf16"], sweep_err["flash_attention_fwd"]["bfloat16"]),
         "max_row_err_bf16": errs["bf16_row"], "previous_ms": None,
         "ptxas": ptxas_of(ptxas, *PTXAS_FA_TC)}))
    return rows


def fa_beyond_rounding(torch, got, want) -> float:
    """Each bf16 output's error against the f32 ``want`` beyond half a
    bf16 ulp of the larger of the two magnitudes (what rounding the output
    alone may add), floored at 0, over the max |want| of its row (the last
    dimension); the largest over all rows.  Rounding P to bf16 once shows
    here, where one-ulp flips of the output hide it from the max-|ref|
    measure."""
    got = got.float()
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    half_ulp = torch.exp2((e - 9).float())   # magnitude in [2^(e-1), 2^e)
    excess = ((got - want).abs() - half_ulp).clamp_min(0).amax(-1)
    return float((excess / want.abs().amax(-1).clamp_min(1e-30)).max())


def fa_prefill_errors(torch, q, k, v, **mask) -> dict:
    """FA on bf16 q, k, v at the prefill's shapes against its plain
    version: ``f32``, the f32 kernel on the same values, relative to max
    |ref|; ``bf16`` and ``bf16_abs``, the bf16 kernel against the bf16
    plain version; ``bf16_row``, :func:`fa_beyond_rounding` of the bf16
    kernel against the f32 plain version.  ``mask``: causal (default
    True) and window."""
    from repro_torch.kernels.attention import kernel as fa
    mask = {"causal": True, **mask}
    q32, k32, v32 = (t.float() for t in (q, k, v))
    want32 = fa.flash_attention_plain(q32, k32, v32, **mask)
    got32 = fa.flash_attention_fwd(q32, k32, v32, **mask)
    del q32, k32, v32
    got = fa.flash_attention_fwd(q, k, v, **mask)
    want = fa.flash_attention_plain(q, k, v, **mask).float()
    torch.cuda.synchronize()
    out = {"f32": rel_err(got32, want32),
           "bf16": rel_err(got.float(), want),
           "bf16_abs": float((got.float() - want).abs().max()),
           "bf16_row": fa_beyond_rounding(torch, got, want32)}
    del got32, want32, got, want
    return out


def kernel_row(name, launches, abs_err, ms, plain_ms, library_ms, nbytes_,
               flops, extra):
    """One row of the kernels line for a bf16 LM kernel: the bound is the
    larger of its bytes at 3.35 TB/s and its contraction flops at the bf16
    dense tensor-core peak of 989 TFLOP/s."""
    from repro_torch.launch.roofline import bound as card_bound
    bd = card_bound(nbytes_, flops, "bfloat16")
    t_bytes, t_ops, bound = bd["bytes_ms"], bd["ops_ms"], bd["bound_ms"]
    lib = "none" if library_ms is None else f"{library_ms:.3f} ms"
    log(f"  {name}: {ms:.3f} ms (plain {plain_ms:.1f} ms, library {lib}); "
        f"{nbytes_ / 1e6:.1f} MB -> {t_bytes:.4f} ms, {flops / 1e9:.2f} "
        f"GFLOP -> {t_ops:.4f} ms at bf16 peak; bound {bound:.4f} ms = "
        f"{100 * bound / ms:.2f}% of the kernel's time")
    meta = KERNELS[name]
    return {"name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches,
            "max_abs_err": abs_err, **extra, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bd["bound_by"],
            "bound_peak": "3.35 TB/s; bf16 dense 989 TFLOP/s",
            "library_ms": library_ms}


def lm_phases(torch, dev, ptxas):
    """Phases 5-9 (the LM serving path); returns their kernel rows."""
    from repro_torch import configs
    from repro_torch.launch.roofline import nbytes
    from repro_torch.models import lm
    cfg = configs.get(LM_ARCH)
    log(f"phase 5: SSD and FA against their plain versions on the "
        f"reference's sweeps")
    sweep_err = lm_sweeps(torch, dev)
    log(f"phase 6: {cfg.name} full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}) in f32: decode vs prefill, B={PARITY_B}, "
        f"S={PARITY_S}")
    lm_parity(torch, dev, cfg)
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_params(cfg, gen, device=dev)
    n_par = sum(t.numel() for t in _leaves(params))
    log(f"phase 7: {cfg.name} bf16 prefill ({n_par / 1e9:.3f} B parameters, "
        f"{sum(nbytes(t) for t in _leaves(params)) / 1e9:.2f} GB)")
    pre = lm_prefill(torch, dev, cfg, params)
    log("phase 8: bf16 decode")
    lm_decode(torch, dev, cfg, params)
    del params
    torch.cuda.empty_cache()
    log("phase 9: SSD and FA at the prefill's shapes (f32 and bf16)")
    return lm_kernels_main(torch, dev, cfg, sweep_err, pre["launches"],
                           ptxas)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ---------------------------------------------------------------------------
# the rest of the LM zoo: dense, MoE, vlm, MLA and encoder-decoder serving
# (phases M-R), every prefill attention through FA's tensor-core body
# ---------------------------------------------------------------------------

# phase M: FA's new widths at the zoo's prefill shapes
# (b, s, t, h, hkv, d, dv, causal, window, body)
FA_ZOO_CASES = {
    "d120": (2, 8192, 8192, 32, 8, 120, 120, True, 4096, "tc_k8"),
    "d192": (2, 4096, 4096, 128, 128, 192, 128, True, 0, "tc_k12"),
    "noncausal": (2, 2048, 8192, 16, 16, 64, 64, False, 0, "tc_k8"),
}
PTXAS_FA_K8 = ("flash_attention_fwd", "flash_fwd_tc_kernelILi8ELi8ELb0E")
PTXAS_FA_K12 = ("flash_attention_fwd", "flash_fwd_tc_kernelILi12ELi8ELb0E")
DENSE_MAIN = "qwen2-7b"
DENSE_OTHERS = ("h2o-danube-3-4b", "minitron-4b", "starcoder2-3b")
MOE_ARCH = "moonshot-v1-16b-a3b"
VLM_ARCH = "pixtral-12b"
MLA_ARCH = "deepseek-v3-671b"
ENCDEC_ARCH = "seamless-m4t-large-v2"
MOE_MAX_GIB = 70.0       # phase P's peak must stay below: its depth is
MOE_HEADROOM_GIB = 4.0   # cut until weights + caches leave this for the rest
ZOO_DECODE_STEPS = 16    # phases O-R
MLA_PARITY_B = 1         # phase Q's deepseek parity: B=1 x PARITY_S


def fa_hold(torch, name, q, k, v, mask, body) -> dict:
    """FA on bf16 ``q``, ``k``, ``v`` against its plain version
    (:func:`fa_prefill_errors`) in f32 (1e-4) and bf16 (2e-2, and row by
    row beyond rounding 1e-4), the bf16 launch on ``body``.  Resets the LM
    counters."""
    from repro_torch.kernels.attention import kernel as fa
    reset_lm_counters()
    errs = fa_prefill_errors(torch, q, k, v, **mask)
    got = dict(lm_counters()[1].body_launches)
    if got != {**dict.fromkeys(fa.BODIES, 0), "cuda_core": 1, body: 1}:
        raise AssertionError(f"FA {name}: launches by body {got}, expected "
                             f"one f32 cuda_core and one bf16 {body}")
    for label, key, bar in (("f32", "f32", FA_BAR["float32"]),
                            ("bf16", "bf16", FA_BAR["bfloat16"]),
                            ("bf16 by row", "bf16_row", FA_MAIN_ROW_BAR)):
        log(f"  FA {name} {label:<12} rel err {errs[key]:.3e} (bar {bar:g})")
        if not errs[key] < bar:
            raise AssertionError(f"FA {name} {label}: relative error "
                                 f"{errs[key]:.3e} >= {bar:g}")
    return errs


def fa_zoo_case(torch, dev, name, ptxas) -> dict:
    """One of phase M's cases: :func:`fa_hold` on random inputs, timed in
    bf16 beside the plain version, ``scaled_dot_product_attention`` (GQA,
    the window as a boolean mask) and the bound."""
    from repro_torch.kernels.attention import kernel as fa
    from repro_torch.launch.roofline import bound as card_bound
    from repro_torch.launch.roofline import fa_fwd_work
    F = torch.nn.functional
    b, s, t, h, hkv, d, dv, causal, win, body = FA_ZOO_CASES[name]
    gen = torch.Generator(device=dev).manual_seed(6)
    bf16 = torch.bfloat16
    q = torch.randn((b, s, h, d), generator=gen, device=dev, dtype=bf16)
    k = torch.randn((b, t, hkv, d), generator=gen, device=dev, dtype=bf16)
    v = torch.randn((b, t, hkv, dv), generator=gen, device=dev, dtype=bf16)
    mask = dict(causal=causal, window=win)
    errs = fa_hold(torch, name, q, k, v, mask, body)
    torch.cuda.empty_cache()
    ms = time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, **mask), 10)
    plain = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, **mask),
                    1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kw = dict(scale=d ** -0.5, enable_gqa=h != hkv)
    if win:
        qp = torch.arange(s, device=dev)[:, None]
        kp = torch.arange(t, device=dev)[None, :]
        kw["attn_mask"] = (kp <= qp) & (kp > qp - win)
    else:
        kw["is_causal"] = causal
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, **kw), 10)
    bd = card_bound(*fa_fwd_work(q, k, v, **mask), "bfloat16")
    ptx = ptxas_of(ptxas, *(PTXAS_FA_K12 if body == "tc_k12" else
                            PTXAS_FA_K8))
    log(f"  FA {name} ({body}, ptxas {ptx}): {ms:.3f} ms, plain {plain:.1f}"
        f" ms, SDPA {lib:.3f} ms; bound {bd['bound_ms']:.4f} ms "
        f"({bd['bound_by']}) = {100 * bd['bound_ms'] / ms:.2f}% of the "
        "kernel's time")
    return {"body": body, "ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
            "max_rel_err": max(errs["f32"], errs["bf16"]),
            "max_row_err_bf16": errs["bf16_row"], "ptxas": ptx}


def fa_path_holds(torch, prefill, params, batch, body) -> list:
    """One more prefill call, in which FA's first call at each distinct
    shape and mask is held (:func:`fa_hold`) on the path's own q, k and v,
    at their strides: the head widths, GQA ratios, windows and sequence
    lengths the arch runs.  Its launches count in no phase."""
    from repro_torch.kernels.attention import kernel as fa
    from repro_torch.models import attention, encdec
    held = []

    def holding(q, k, v, *, causal=True, window=0):
        sig = dict(q=tuple(q.shape), k=tuple(k.shape), v=tuple(v.shape),
                   causal=bool(causal), window=int(window))
        if all(h["sig"] != sig for h in held):
            name = (f"path q{sig['q']} k{sig['k']} v{sig['v']} "
                    f"causal={sig['causal']} window={sig['window']}")
            held.append({"sig": sig, **fa_hold(
                torch, name, q, k, v, dict(causal=causal, window=window),
                body)})
        return fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    mods = (attention, encdec)
    for m in mods:
        m.flash_attention = holding
    try:
        prefill(params, batch)
        torch.cuda.synchronize()
    finally:
        for m in mods:
            m.flash_attention = fa.flash_attention
    return held


def zoo_prefill(torch, dev, cfg, params, batch, body, reps=3) -> dict:
    """A bf16 ``make_prefill_fn`` call, warm once, then ``reps`` timed
    calls (the median kept): each must launch FA once per attention, every
    launch on ``body``, and no SSD; finite logits of (B, vocab).  Then
    :func:`fa_path_holds`."""
    from repro_torch.models import lm
    from repro_torch.models.transformer import padded_vocab
    n_fa = (cfg.encoder_layers + 2 * cfg.n_layers if cfg.family == "audio"
            else cfg.n_layers)
    prefill = lm.make_prefill_fn(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    secs = []
    for i in range(1 + reps):
        torch.cuda.synchronize()
        reset_lm_counters()
        t0 = time.perf_counter()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        fa_bodies = lm_counters()[1].body_launches
        if read_lm_counters() != (0, n_fa) or fa_bodies[body] != n_fa:
            raise AssertionError(
                f"{cfg.name} prefill call {i} launched (SSD, FA) = "
                f"{read_lm_counters()}, FA by body {fa_bodies}; expected "
                f"(0, {n_fa}), all {body}")
    bsz = batch["tokens"].shape[0]
    if tuple(logits.shape) != (bsz, padded_vocab(cfg.vocab)) or not \
            bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name} prefill logits "
                             f"{tuple(logits.shape)} not finite or of the "
                             "wrong shape")
    med = sorted(secs[1:])[len(secs[1:]) // 2]
    positions = sum(x.shape[0] * x.shape[1] for key, x in batch.items())
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    log(f"  {cfg.name} prefill {({k: tuple(x.shape[:2]) for k, x in batch.items()})}:"
        f" warm {secs[0]:.3f} s, calls {[round(x, 4) for x in secs[1:]]} s, "
        f"median {med:.4f} s = {positions / med:.1f} positions/s; FA "
        f"{n_fa} a call, all {body}; peak {peak:.2f} GiB")
    del logits
    held = fa_path_holds(torch, prefill, params, batch, body)
    return {"positions_per_s": positions / med, "median_s": med,
            "fa_launches": n_fa, "fa_body": body, "peak_gib": peak,
            "fa_path": held}


def zoo_params(torch, dev, cfg, seed):
    from repro_torch.launch.roofline import nbytes
    from repro_torch.models import lm
    torch.cuda.empty_cache()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), device=dev)
    leaves = list(_leaves(params))
    log(f"  {cfg.name}: {cfg.n_layers} layers"
        f"{f' + {cfg.encoder_layers} encoder' if cfg.encoder_layers else ''},"
        f" d_model {cfg.d_model}, {sum(x.numel() for x in leaves) / 1e9:.3f}"
        f" B parameters, {sum(nbytes(x) for x in leaves) / 1e9:.2f} GB "
        f"{cfg.dtype}")
    return params


def zoo_tokens(torch, dev, cfg, shape, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, cfg.vocab, shape, generator=gen, device=dev)


def zoo_dense(torch, dev, cfg, body, seed, reps=1, decode_steps=None
              ) -> dict:
    """A decoder-only arch at full width: bf16 prefill at B=PREFILL_B x
    PREFILL_S, then ``decode_steps`` (ZOO_DECODE_STEPS) decode steps at
    B=DECODE_B against DECODE_T-slot caches."""
    from repro_torch.models import lm
    params = zoo_params(torch, dev, cfg, seed)
    batch = {"tokens": zoo_tokens(torch, dev, cfg, (PREFILL_B, PREFILL_S),
                                  seed)}
    if cfg.family == "vlm":
        s_img, s_txt = lm._frontend_split(cfg, PREFILL_S)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        batch = {"embeds": torch.randn(
            (PREFILL_B, s_img, cfg.d_model), generator=gen, device=dev,
            dtype=getattr(torch, cfg.dtype)),
            "tokens": batch["tokens"][:, :s_txt]}
    out = {"prefill": zoo_prefill(torch, dev, cfg, params, batch, body,
                                  reps)}
    del batch
    torch.cuda.reset_peak_memory_stats(dev)
    out["decode"] = lm_decode(torch, dev, cfg, params, steps=(
        ZOO_DECODE_STEPS if decode_steps is None else decode_steps))
    out["decode"]["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    del params
    torch.cuda.empty_cache()
    return out


def moe_depth(torch, cfg):
    """``cfg`` at the largest depth, past its dense layers, whose bf16
    weights and decode caches (B=DECODE_B, DECODE_T slots) leave
    ``MOE_HEADROOM_GIB`` of ``MOE_MAX_GIB`` for the run's transients
    (``launch/train.py:fit_depth``, sizes from the meta device; at full
    depth moonshot's 48 layers hold 52.9 GiB of weights and 24 GiB of
    caches)."""
    from repro_torch.launch.roofline import nbytes
    from repro_torch.launch.train import fit_depth
    from repro_torch.models import lm
    from repro_torch.models import transformer as tfm
    meta = torch.device("meta")

    def weights_and_caches(cut):
        return sum(nbytes(x) for tree in (
            lm.init_params(cut, None, device=meta),
            tfm.init_caches(cut, DECODE_B, DECODE_T, torch.bfloat16, meta))
            for x in _leaves(tree))

    cut, gib = fit_depth(cfg, MOE_MAX_GIB - MOE_HEADROOM_GIB,
                         weights_and_caches,
                         min_layers=cfg.moe.first_dense + 1)
    log(f"  depth {cut.n_layers}: {gib:.2f} GiB of weights and caches")
    return cut


def zoo_encdec(torch, dev, cfg, seed) -> dict:
    """Phase R: seamless at full width: a prefill of PREFILL_S source
    frames and PREFILL_S / TGT_RATIO target tokens (FA enc + 2 dec a
    call), then decode at B=DECODE_B against the encoder's cross K/V."""
    from repro_torch.models import encdec
    params = zoo_params(torch, dev, cfg, seed)
    dt = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    s_tgt = PREFILL_S // encdec.TGT_RATIO
    batch = {"src_embeds": torch.randn((PREFILL_B, PREFILL_S, cfg.d_model),
                                       generator=gen, device=dev, dtype=dt),
             "tokens": zoo_tokens(torch, dev, cfg, (PREFILL_B, s_tgt), seed)}
    out = {"prefill": zoo_prefill(torch, dev, cfg, params, batch, "tc_k8")}
    del batch
    torch.cuda.reset_peak_memory_stats(dev)
    src = torch.randn((DECODE_B, PREFILL_S, cfg.d_model), generator=gen,
                      device=dev, dtype=dt)
    caches = encdec.init_caches(cfg, DECODE_B, s_tgt, PREFILL_S, dt, dev)
    encdec.fill_cross_kv(cfg, params, caches, src)
    del src
    out["decode"] = lm_decode(torch, dev, cfg, params, caches,
                              ZOO_DECODE_STEPS)
    out["decode"]["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    del params, caches
    torch.cuda.empty_cache()
    return out


def lm_zoo_phases(torch, dev, ptxas, fa_row) -> dict:
    """Phases M-R; adds each arch's FA launches per prefill and the new
    instantiations' numbers to ``fa_row``."""
    import dataclasses

    from repro_torch import configs
    t_start = time.perf_counter()
    out, times = {}, {}
    log("phase M: FA's d = 120, d = 192 / dv = 128 and non-causal S != T "
        "instantiations against the plain version")
    t0 = time.perf_counter()
    out["fa"] = {name: fa_zoo_case(torch, dev, name, ptxas)
                 for name in FA_ZOO_CASES}
    times["M"] = time.perf_counter() - t0
    for name, r in out["fa"].items():
        for key in ("ms", "bound_ms", "bound_by", "library_ms", "plain_ms",
                    "max_rel_err", "ptxas"):
            fa_row[f"{key}_{name}"] = r[key]

    t0 = time.perf_counter()
    cfg = configs.get(DENSE_MAIN)
    log(f"phase N: {cfg.name} full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}) in f32: decode vs prefill, B={PARITY_B}, "
        f"S={PARITY_S}")
    out[DENSE_MAIN] = {"parity_rel_err": lm_parity(torch, dev, cfg)}
    torch.cuda.empty_cache()
    log(f"phase N: {cfg.name} bf16 prefill and decode")
    out[DENSE_MAIN].update(zoo_dense(torch, dev, cfg, "tc_k8", 10, reps=3,
                                     decode_steps=DECODE_STEPS))
    times["N"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    for arch in DENSE_OTHERS:
        cfg = configs.get(arch)
        log(f"phase O: {cfg.name} full width, bf16 prefill and decode")
        out[arch] = zoo_dense(torch, dev, cfg, "tc_k8", 11)
    times["O"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    full = configs.get(MOE_ARCH)
    cfg = moe_depth(torch, full)
    log(f"phase P: {cfg.name} full width (MoE {cfg.moe.n_experts} experts, "
        f"top {cfg.moe.top_k}, dense dispatch), depth {cfg.n_layers} of "
        f"{full.n_layers}, bf16")
    out[MOE_ARCH] = zoo_dense(torch, dev, cfg, "tc_k8", 12, reps=3,
                              decode_steps=DECODE_STEPS)
    out[MOE_ARCH]["n_layers"] = cfg.n_layers
    peak = max(out[MOE_ARCH][k]["peak_gib"] for k in ("prefill", "decode"))
    if not peak < MOE_MAX_GIB:
        raise AssertionError(f"{cfg.name} at depth {cfg.n_layers} peaked "
                             f"at {peak:.2f} GiB (limit {MOE_MAX_GIB})")
    times["P"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cfg = configs.get(VLM_ARCH)
    log(f"phase Q: {cfg.name} full width and depth, "
        f"{int(100 * cfg.frontend_frac)} % of the positions as embeds")
    out[VLM_ARCH] = zoo_dense(torch, dev, cfg, "tc_k8", 13)
    full = configs.get(MLA_ARCH)
    cfg = dataclasses.replace(full, n_layers=full.moe.first_dense + 1)
    log(f"phase Q: {cfg.name} full width, depth cut to {cfg.n_layers} of "
        f"{full.n_layers} ({full.moe.first_dense} dense + 1 MoE layer)")
    # no prefill drops (capacity T, as the reference's decode test): a
    # per-token decode never drops
    nodrop = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(-(-cfg.moe.n_experts //
                                         cfg.moe.top_k))))
    log(f"  f32 decode vs prefill, B={MLA_PARITY_B}, S={PARITY_S}, capacity"
        f" factor {nodrop.moe.capacity_factor:g}")
    out[MLA_ARCH] = {"parity_rel_err": lm_parity(torch, dev, nodrop,
                                                 MLA_PARITY_B),
                     "n_layers": cfg.n_layers}
    torch.cuda.empty_cache()
    out[MLA_ARCH].update(zoo_dense(torch, dev, cfg, "tc_k12", 14))
    times["Q"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cfg = configs.get(ENCDEC_ARCH)
    log(f"phase R: {cfg.name} full width and depth, encoder-decoder")
    out[ENCDEC_ARCH] = zoo_encdec(torch, dev, cfg, 15)
    times["R"] = time.perf_counter() - t0

    for arch, r in out.items():
        if arch != "fa":
            fa_row[f"launches_{arch}"] = r["prefill"]["fa_launches"]
            held = r["prefill"]["fa_path"]
            fa_row[f"path_max_rel_err_{arch}"] = max(
                max(h["f32"], h["bf16"]) for h in held)
            fa_row[f"path_max_row_err_{arch}"] = max(
                h["bf16_row"] for h in held)
    out["phase_s"] = times
    out["total_s"] = time.perf_counter() - t_start
    log(f"phases M-R: {({k: round(v, 1) for k, v in times.items()})} s, "
        f"{out['total_s']:.1f} s together")
    return out


# ---------------------------------------------------------------------------
# LM training (phases S-T): the FA backward kernel, and the zoo's attention
# families trained through FA's forward and backward kernels
# ---------------------------------------------------------------------------

# phase S: the backward kernel at phase T's shapes (b, s, t, h, hkv, d, dv,
# causal, window); qwen2's 28 heads over 4 kv heads are the launcher's
# (tp = 1: no head padding)
FA_BWD_TRAIN_CASES = {
    "qwen2_d128": (2, 4096, 4096, 28, 4, 128, 128, True, 0),
    "h2o_d120_window": (1, 8192, 8192, 32, 8, 120, 120, True, 4096),
    "deepseek_d192": (1, 4096, 4096, 128, 128, 192, 128, True, 0),
    "seamless_cross": (2, 1024, 4096, 16, 16, 64, 64, False, 0),
    # phase V's zamba2 shared block: d = dv = 80 over 32 / 32 heads
    "zamba2_d80": (2, 4096, 4096, 32, 32, 80, 80, True, 0),
}
# phase S, bf16 only: the tensor-core bodies' edges - the padded k-step
# (d = 120) at GQA 7 with a window and ragged tiles; d = 192 / dv = 128 at
# ragged S = T; non-causal S < T at GQA 7 (with the sweep's dv = 24 case,
# tc_sweep1, V's and dO's pad columns)
FA_BWD_TC_CASES = {
    "tc_d120_gqa7_window": (1, 200, 200, 14, 2, 120, 120, True, 96),
    "tc_d192_dv128": (1, 130, 130, 8, 8, 192, 128, True, 0),
    "tc_noncausal_s_lt_t": (2, 96, 160, 7, 1, 128, 128, False, 0),
}
FA_BWD_MAIN = "qwen2_d128"
FA_BWD_BAR = {"float32": 1e-4, "bfloat16": 5e-3}
FA_LSE_BAR = 1e-5     # the forward's lse, either body, of max |ref|
# each backward body's two passes in ptxas's report (mangled names); the
# tensor-core bodies must not spill
PTXAS_FA_BWD = {
    "tc_k8": {"dkdv": ("flash_attention_bwd", "dkdv_tc_kernelILi8ELi8E"),
              "dq": ("flash_attention_bwd", "dq_tc_kernelILi8ELi8E")},
    "tc_k12": {"dkdv": ("flash_attention_bwd", "dkdv_tc_kernelILi12ELi8E"),
               "dq": ("flash_attention_bwd", "dq_tc_kernelILi12ELi8E")},
    "cuda_core": {"dkdv": ("flash_attention_bwd", "dkdv_kernelI13__nv_bf"),
                  "dq": ("flash_attention_bwd", "dq_kernelI13__nv_bf")}}
TRAIN_ARCH = "qwen2-7b"
TRAIN_BUDGET_GIB = 60.0   # bf16 weights + gradients, f32 buffer and moments
# T(a) / V(a) ran 10 steps until the script's time limit cut them to 6
TRAIN_B, TRAIN_S, TRAIN_ACCUM, TRAIN_STEPS = 2, 4096, 2, 6
TRAIN_LR = 3e-4
# T(b): (arch, dtype) at 2 layers, B=1 x S=1024: the f32 CUDA-core body,
# and the bf16 tensor-core bodies tc_k8 (d 128) and tc_k12 (d 192/128)
TRAIN_PARITY = (("qwen2-7b", "float32"), ("qwen2-7b", "bfloat16"),
                ("deepseek-v3-671b", "bfloat16"))
TRAIN_PARITY_LAYERS, TRAIN_PARITY_S = 2, 1024
# f32: the loss and each leaf's gradient, kernels against plain, within
# 1e-4 (of max |ref|).  bf16: a bf16 gradient sits up to ~9 % of max |ref|
# from the same computed in f32 (the embedding's most), so two bf16 paths
# differ by rounding alone by a few %; each bf16 path is held against the
# plain path in f32 on the same bf16-valued weights, the kernels' error at
# most TRAIN_BF16_RATIO times the plain bf16 path's, the loss within
# TRAIN_BF16_LOSS_BAR of the plain bf16 path's
TRAIN_PARITY_BAR = 1e-4
TRAIN_BF16_RATIO = 1.5
TRAIN_BF16_LOSS_BAR = 1e-3
# T(c): (arch, batch, positions a row); one step each, accumulation 1
TRAIN_ONE_STEP = (("h2o-danube-3-4b", 1, 8192),
                  ("moonshot-v1-16b-a3b", 2, 4096),
                  ("deepseek-v3-671b", 1, 4096),
                  ("seamless-m4t-large-v2", 2, 4096))


def fa_bwd_counters():
    from repro_torch.kernels.attention import kernel as fa
    return fa.flash_attention_fwd, fa.flash_attention_bwd


def reset_train_counters():
    """The FA and SSD kernels' launch counters, which the training phases
    read."""
    from repro_torch.kernels.ssd import kernel as ssd
    fwd, bwd = fa_bwd_counters()
    fwd.launches = bwd.launches = 0
    fwd.body_launches = dict.fromkeys(fwd.body_launches, 0)
    bwd.pass_launches = dict.fromkeys(bwd.pass_launches, 0)
    bwd.body_launches = dict.fromkeys(bwd.body_launches, 0)
    ssd.ssd_chunks.launches = ssd.ssd_chunks_bwd.launches = 0
    ssd.ssd_chunks.body_launches = dict.fromkeys(ssd.BODIES, 0)
    ssd.ssd_chunks_bwd.body_launches = dict.fromkeys(ssd.BWD_BODIES, 0)


def read_train_counters() -> dict:
    from repro_torch.kernels.ssd import kernel as ssd
    fwd, bwd = fa_bwd_counters()
    return {"fwd": fwd.launches, "fwd_bodies": dict(fwd.body_launches),
            "bwd": bwd.launches, "bwd_passes": dict(bwd.pass_launches),
            "bwd_bodies": dict(bwd.body_launches),
            "ssd_fwd": ssd.ssd_chunks.launches,
            "ssd_fwd_bodies": dict(ssd.ssd_chunks.body_launches),
            "ssd_bwd": ssd.ssd_chunks_bwd.launches,
            "ssd_bwd_bodies": dict(ssd.ssd_chunks_bwd.body_launches)}


def train_launches(torch, cfg, micro: int) -> tuple:
    """(the FA and SSD launches ``micro`` microbatches of training make,
    by body, in :func:`read_train_counters`' layout; the bodies: FA's
    forward, FA's backward, SSD's forward).  Every layer is
    rematted (its forward runs twice, its backward once) except zamba2's
    shared attention block (one forward, one backward a call, as in the
    reference); bf16 runs the tensor-core bodies (``fa_body`` /
    ``fa_bwd_body``; SSD's forward and backward ``"tc"``, the layout of
    the projection's views being one they take), f32 the CUDA-core
    ones."""
    from repro_torch.kernels.attention import kernel as fa
    from repro_torch.kernels.ssd import kernel as ssd
    dtype = getattr(torch, cfg.dtype)
    if cfg.family == "hybrid":
        fa_fwd = fa_bwd = cfg.n_layers // cfg.shared_every
    elif cfg.family == "ssm":
        fa_fwd = fa_bwd = 0
    else:
        fa_bwd = n_attention(cfg)
        fa_fwd = 2 * fa_bwd
    d = cfg.mla.qk_nope + cfg.mla.qk_rope if cfg.mla else cfg.hd
    dv = cfg.mla.v_head if cfg.mla else cfg.hd
    body, bwd_body = fa.fa_body(dtype, d, dv), fa.fa_bwd_body(dtype, d, dv)
    ssd_layers = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    ssd_body = "tc" if dtype == torch.bfloat16 else "cuda_core"
    fa_fwd, fa_bwd, ssd_layers = (micro * v for v in (fa_fwd, fa_bwd,
                                                       ssd_layers))
    return ({"fwd": fa_fwd,
             "fwd_bodies": {**dict.fromkeys(fa.BODIES, 0), body: fa_fwd},
             "bwd": fa_bwd,
             "bwd_passes": dict.fromkeys(fa.BWD_PASSES, fa_bwd),
             "bwd_bodies": {**dict.fromkeys(fa.BWD_BODIES, 0),
                            bwd_body: fa_bwd},
             "ssd_fwd": 2 * ssd_layers,
             "ssd_fwd_bodies": {**dict.fromkeys(ssd.BODIES, 0),
                                ssd_body: 2 * ssd_layers},
             "ssd_bwd": ssd_layers,
             "ssd_bwd_bodies": {**dict.fromkeys(ssd.BWD_BODIES, 0),
                                ssd_body: ssd_layers}},
            (body, bwd_body, ssd_body))


def fa_bwd_hold(torch, dev, name, case, gen,
                dtypes=("float32", "bfloat16")) -> dict:
    """The forward kernel's lse and the backward kernel on its o and lse
    against the plain versions' chain, in each of ``dtypes``: the forward's
    lse against ``flash_attention_plain``'s (``FA_LSE_BAR`` of max |ref|),
    and the kernel's (dq, dk, dv) against ``flash_attention_bwd_plain`` on
    the plain forward's own o and lse (``FA_BWD_BAR`` of each output's max
    |ref|), each kernel call bitwise equal to a second one and both on the
    body ``fa_bwd_body`` names.  Returns the errors and the bf16 tensors
    (with the kernel forward's o and lse, and the plain chain's gradients)."""
    from repro_torch.kernels.attention import kernel as fa
    b, s, t, h, hkv, d, dv, causal, win = case
    mask = dict(causal=causal, window=win)
    out = {}
    for dtype in dtypes:
        dt_ = getattr(torch, dtype)
        q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dt_)
        k = torch.randn((b, t, hkv, d), generator=gen, device=dev).to(dt_)
        v = torch.randn((b, t, hkv, dv), generator=gen, device=dev).to(dt_)
        do = torch.randn((b, s, h, dv), generator=gen, device=dev).to(dt_)
        o, lse = fa.flash_attention_fwd(q, k, v, **mask, return_lse=True)
        want_o, want_lse = fa.flash_attention_plain(q, k, v, **mask,
                                                    return_lse=True)
        out[f"lse_{dtype}"] = check(f"FA bwd {name} lse {dtype}", lse,
                                    want_lse, FA_LSE_BAR)
        body = fa.fa_bwd_body(dt_, d, dv)
        before = dict(fa.flash_attention_bwd.body_launches)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, **mask)
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, **mask)
        ran = {k_: n - before[k_] for k_, n in
               fa.flash_attention_bwd.body_launches.items() if n != before[k_]}
        if ran != {body: 2}:
            raise AssertionError(f"FA bwd {name} {dtype}: bodies {ran}, "
                                 f"expected {body} twice")
        want = fa.flash_attention_bwd_plain(q, k, v, want_o, want_lse, do,
                                            **mask)
        del want_o, want_lse
        torch.cuda.synchronize()
        errs, abs_errs = [], []
        for oname, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
            if not torch.equal(g, a):
                raise AssertionError(f"FA bwd {name} {oname} {dtype}: two "
                                     "calls differ")
            errs.append(check(f"FA bwd {name} {oname} {dtype} ({body})",
                              g.float(), w.float(), FA_BWD_BAR[dtype]))
            abs_errs.append(float((g.float() - w.float()).abs().max()))
        out[dtype] = max(errs)
        out[f"abs_{dtype}"] = max(abs_errs)
        out[f"body_{dtype}"] = body
        del got, again
        if dtype == "bfloat16":
            out["tensors"] = (q, k, v, o, lse, do, want)
        else:
            del q, k, v, o, lse, do, want
    return out


def bf16_ulps(torch, a, b) -> float:
    """The largest difference of two bf16 tensors in ulps of ``b``, over
    the elements of ``b`` at or above a 16th of its max |b| (away from the
    near-zero elements, whose ulps are tiny)."""
    a, b = a.float(), b.float()
    big = b.abs() >= b.abs().max() / 16
    ulp = torch.exp2(torch.floor(torch.log2(b.abs())) - 7)
    return float(((a - b).abs() / ulp)[big].max())


def fa_bwd_ptxas(ptxas, body) -> dict:
    """ptxas's report of each pass of a backward body."""
    return {p: ptxas_of(ptxas, *parts)
            for p, parts in PTXAS_FA_BWD[body].items()}


def fa_bwd_timed(torch, dev, name, case, tensors, ptxas) -> dict:
    """The bf16 backward kernel timed in turns with the earlier bf16 body
    (the CUDA-core one, launched by its index: new, earlier, earlier, new;
    its error against the plain chain on the same inputs is recorded, with
    no bar), beside its plain version, the library's backward
    (``torch.autograd.grad`` through ``scaled_dot_product_attention`` with
    a retained graph; GQA, the window as a boolean mask) and the bound
    (``launch/roofline.py``)."""
    from repro_torch.kernels.attention import kernel as fa
    from repro_torch.launch import roofline
    F = torch.nn.functional
    b, s, t, h, hkv, d, dv, causal, win = case
    mask = dict(causal=causal, window=win)
    q, k, v, o, lse, do, want = tensors
    body = fa.fa_bwd_body(q.dtype, d, dv)
    prev = fa._bwd_launch(q, k, v, o, lse, do, causal, win, "cuda_core")
    prev_err = max(rel_err(p.float(), w.float()) for p, w in zip(prev, want))
    new = fa.flash_attention_bwd(q, k, v, o, lse, do, **mask)
    ulps = max(bf16_ulps(torch, a, b_) for a, b_ in zip(new, prev))
    del prev, want, new
    turns = {"new": (lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                    **mask), 3, []),
             "earlier": (lambda: fa._bwd_launch(q, k, v, o, lse, do, causal,
                                                win, "cuda_core"), 1, [])}
    for which in ("new", "earlier", "earlier", "new"):
        fn, reps, got = turns[which]
        got.append(time_ms(torch, fn, reps))
    ms, earlier = (sum(turns[w][2]) / 2 for w in ("new", "earlier"))
    plain = time_ms(torch, lambda: fa.flash_attention_bwd_plain(
        q, k, v, o, lse, do, **mask), 1)
    leaves = [x.detach().transpose(1, 2).requires_grad_(True)
              for x in (q, k, v)]
    kw = dict(scale=d ** -0.5, enable_gqa=h != hkv)
    if win:
        qp = torch.arange(s, device=dev)[:, None]
        kp = torch.arange(t, device=dev)[None, :]
        kw["attn_mask"] = (kp <= qp) & (kp > qp - win)
    else:
        kw["is_causal"] = causal
    lib_out = F.scaled_dot_product_attention(*leaves, **kw)
    g_out = do.transpose(1, 2)
    lib = time_ms(torch, lambda: torch.autograd.grad(
        lib_out, leaves, g_out, retain_graph=True), 3)
    del lib_out, leaves, kw
    nb, flops = roofline.fa_bwd_work(q, k, v, o, lse, do, **mask)
    bd = roofline.bound(nb, flops, "bfloat16")
    ptx, ptx_cc = fa_bwd_ptxas(ptxas, body), fa_bwd_ptxas(ptxas, "cuda_core")
    log(f"  FA bwd {name}: {ms:.3f} ms ({body}; turns "
        f"{[round(x, 3) for x in turns['new'][2]]}), earlier body "
        f"(cuda_core) {earlier:.3f} ms in the same call (its worst bf16 "
        f"rel err on these inputs {prev_err:.3e}; the bodies differ by at "
        f"most {ulps:g} bf16 ulp above a 16th of max |out|), plain "
        f"{plain:.1f} ms, SDPA backward {lib:.3f} ms; {nb / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP -> bound {bd['bound_ms']:.4f} ms "
        f"({bd['bound_by']}) = {100 * bd['bound_ms'] / ms:.2f}% of the "
        f"kernel's time; ptxas {ptx} (earlier {ptx_cc})")
    return {"ms": ms, "body": body, "previous_ms": earlier,
            "previous_body": "cuda_core", "previous_rel_err_bf16": prev_err,
            "ulps_vs_previous": ulps,
            "plain_ms": plain,
            "library_ms": lib, "bound_ms": bd["bound_ms"],
            "bound_by": bd["bound_by"], "bytes": nb, "flops": flops,
            "ptxas": ptx, "ptxas_previous": ptx_cc}


def phase_fa_bwd(torch, dev, ptxas) -> dict:
    """Phase S: the FA backward kernel against its plain version on the
    sweeps' cases (f32 and bf16), the tensor-core bodies' edge cases
    (bf16) and every training shape of phase T, timed at the latter; the
    tensor-core bodies' ptxas reports must show no spills."""
    t0 = time.perf_counter()
    for body in ("tc_k8", "tc_k12"):
        rep = fa_bwd_ptxas(ptxas, body)
        log(f"  FA bwd {body} ptxas {rep}")
        if any(r.get("spill_bytes", 0) for r in rep.values()):
            raise AssertionError(f"FA bwd {body}: ptxas reports spills "
                                 f"{rep}")
    gen = torch.Generator(device=dev).manual_seed(16)
    out = {"sweep": {}, "train": {}}
    cases = [(f"sweep{i}", c[:9]) for i, c in enumerate(FA_SWEEP)] + [
        (f"tc_sweep{i}", c[:9]) for i, c in enumerate(FA_TC_SWEEP[5:])]
    for name, case in cases:
        r = fa_bwd_hold(torch, dev, name, case, gen)
        r.pop("tensors")
        out["sweep"][name] = r
    for name, case in FA_BWD_TC_CASES.items():
        r = fa_bwd_hold(torch, dev, name, case, gen, ("bfloat16",))
        r.pop("tensors")
        out["sweep"][name] = r
    for name, case in FA_BWD_TRAIN_CASES.items():
        r = fa_bwd_hold(torch, dev, name, case, gen)
        r.update(fa_bwd_timed(torch, dev, name, case, r.pop("tensors"),
                              ptxas))
        out["train"][name] = r
        torch.cuda.empty_cache()
    held = [r for grp in ("sweep", "train") for r in out[grp].values()]
    out["max_rel_err"] = {dt: max(r[dt] for r in held if dt in r)
                          for dt in FA_BWD_BAR}
    out["max_rel_err"]["lse"] = max(r[f"lse_{dt}"] for r in held
                                    for dt in FA_BWD_BAR
                                    if f"lse_{dt}" in r)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase S: worst {out['max_rel_err']} in {out['seconds']:.1f} s")
    return out


def train_args(arch, batch, seq, steps, accum, seed):
    from repro_torch.launch.train import parse_args
    return parse_args(["--arch", arch, "--batch", str(batch), "--seq",
                       str(seq), "--steps", str(steps), "--accum",
                       str(accum), "--lr", str(TRAIN_LR), "--seed",
                       str(seed), "--log-every", "1", "--device", "cuda"])


def n_attention(cfg) -> int:
    return (cfg.encoder_layers + 2 * cfg.n_layers if cfg.family == "audio"
            else cfg.n_layers)


def train_run(torch, dev, cfg, batch, seq, steps, accum, seed) -> dict:
    """``launch/train.py:train_lm`` on ``cfg`` (its depth already cut) on
    the card: FA's and SSD's launches must be, a step, what
    :func:`train_launches` names - for a rematted layer 2 forwards (the
    forward and remat's recomputation) and one backward (FA's both
    passes) per microbatch, every one on the body named for the arch's
    dtype and widths (bf16: the tensor-core bodies); every loss and
    gradient norm finite.  Returns the rows, the launches a step and the
    peak memory."""
    from repro_torch.launch.train import train_lm
    expect, (body, bwd_body, _) = train_launches(torch, cfg, steps * accum)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_train_counters()
    run = train_lm(train_args(cfg.name, batch, seq, steps, accum, seed),
                   cfg_override=cfg)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    got = read_train_counters()
    if got != expect:
        raise AssertionError(f"{cfg.name} training: FA / SSD launches "
                             f"{got}, expected {expect}")
    rows = run["rows"]
    bad = [r for r in rows if not (math.isfinite(r["loss"])
                                   and math.isfinite(r["grad_norm"]))]
    if bad:
        raise AssertionError(f"{cfg.name} training: non-finite {bad}")
    del run
    torch.cuda.empty_cache()
    return {"n_layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers,
            "batch": batch, "seq": seq, "accum": accum, "rows": rows,
            "fa_fwd_a_step": got["fwd"] // steps,
            "fa_bwd_a_step": got["bwd"] // steps,
            "fa_bwd_passes_a_step": {p: c // steps for p, c in
                                     got["bwd_passes"].items()},
            "fa_bwd_bodies_a_step": {b_: c // steps for b_, c in
                                     got["bwd_bodies"].items()},
            "ssd_fwd_a_step": got["ssd_fwd"] // steps,
            "ssd_fwd_bodies_a_step": {b_: c // steps for b_, c in
                                      got["ssd_fwd_bodies"].items()},
            "ssd_bwd_a_step": got["ssd_bwd"] // steps,
            "ssd_bwd_bodies_a_step": {b_: c // steps for b_, c in
                                      got["ssd_bwd_bodies"].items()},
            "fa_body": body, "fa_bwd_body": bwd_body, "peak_gib": peak}


def train_parity(torch, dev, full, dtype, layers=TRAIN_PARITY_LAYERS,
                 tag="T(b)") -> dict:
    """T(b) and V(b): ``full`` cut to ``layers`` layers
    (``launch/train.py:depth_cut``) in ``dtype``: the loss and every
    leaf's gradient through the kernels against the same computed with
    their plain versions on the card (``flash_attention_plain`` /
    ``flash_attention_bwd_plain``, the plain chain from the plain forward's
    own o and lse; ``ssd_chunks_plain`` / ``ssd_chunks_bwd_plain``): in
    f32 within ``TRAIN_PARITY_BAR`` of each leaf's max |ref|; in bf16 both
    against the plain path in f32 on the same bf16-valued weights, the
    kernels' error at most ``TRAIN_BF16_RATIO`` times the plain bf16
    path's.  Holds the autograd Functions' wiring and the forward body's
    lse; the kernels' launches must be :func:`train_launches`'."""
    import dataclasses

    from repro_torch.data.tokens import synthetic_batches, to_tensors
    from repro_torch.kernels.attention import kernel as fa
    from repro_torch.kernels.ssd import kernel as ssd
    from repro_torch.launch.train import depth_cut
    from repro_torch.models import lm
    from repro_torch.utils.tree import tree_cast, tree_leaves, tree_unflatten
    cfg = dataclasses.replace(depth_cut(full, layers), dtype=dtype)
    want, (body, bwd_body, ssd_body) = train_launches(torch, cfg, 1)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
        17), tp=1, device=dev)
    batch = to_tensors(next(synthetic_batches(cfg, 1, TRAIN_PARITY_S, 17)),
                       dev)
    kernels = ((fa, "flash_attention_fwd", "flash_attention_plain"),
               (fa, "flash_attention_bwd", "flash_attention_bwd_plain"),
               (ssd, "ssd_chunks", "ssd_chunks_plain"),
               (ssd, "ssd_chunks_bwd", "ssd_chunks_bwd_plain"))

    def loss_and_grads(c, tree, plain=False):
        # a gradient is None for a leaf no layer reads (an empty MoE stack)
        real = [getattr(mod, name) for mod, name, _ in kernels]
        if plain:
            for mod, name, plain_name in kernels:
                setattr(mod, name, getattr(mod, plain_name))
        try:
            ps = [p.detach().requires_grad_(True) for p in tree_leaves(tree)]
            loss = lm.make_loss_fn(c, remat=True)(tree_unflatten(tree, ps),
                                                  batch)
            grads = torch.autograd.grad(loss, ps, allow_unused=True)
        finally:
            for (mod, name, _), fn in zip(kernels, real):
                setattr(mod, name, fn)
        return float(loss.detach()), grads

    def leaf_errs(got, want):
        if [g is None for g in got] != [g is None for g in want]:
            raise AssertionError(f"{tag} {cfg.name} {dtype}: the paths "
                                 "differentiate different leaves")
        return [rel_err(a.float(), b.float()) for a, b in zip(got, want)
                if a is not None]

    reset_train_counters()
    loss_k, grads_k = loss_and_grads(cfg, params)
    torch.cuda.synchronize()
    launches = read_train_counters()
    if launches != want:
        raise AssertionError(f"{tag} {cfg.name} {dtype}: FA / SSD launches "
                             f"{launches}, expected {want}")
    loss_p, grads_p = loss_and_grads(cfg, params, plain=True)
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    errs = leaf_errs(grads_k, grads_p)
    worst = [tuple(g.shape) for g in grads_k if g is not None][
        errs.index(max(errs))]
    out = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": dtype,
           "body": body, "bwd_body": bwd_body, "ssd_body": ssd_body,
           "loss_rel_err": loss_err, "grad_max_rel_err": max(errs),
           "worst_leaf_shape": worst, "leaves": len(errs),
           "launches": launches}
    head = (f"  {tag} {cfg.name} {cfg.n_layers} layers {dtype} (FA {body}, "
            f"backward {bwd_body}; SSD {ssd_body}), "
            f"B=1 x S={TRAIN_PARITY_S}: loss {loss_k:.6f} vs plain "
            f"{loss_p:.6f} (rel {loss_err:.3e}); worst leaf gradient rel "
            f"err {max(errs):.3e} (a {worst} leaf) over {len(errs)} "
            "leaves")
    if dtype == "float32":
        log(f"{head} (bar {TRAIN_PARITY_BAR:g})")
        if not (loss_err < TRAIN_PARITY_BAR and max(errs) < TRAIN_PARITY_BAR):
            raise AssertionError(f"{tag} {cfg.name}: loss {loss_err:.3e}, "
                                 f"gradients {max(errs):.3e} >= "
                                 f"{TRAIN_PARITY_BAR:g}")
        return out
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    loss_32, grads_32 = loss_and_grads(cfg32, tree_cast(params,
                                                        torch.float32),
                                       plain=True)
    errs_k, errs_p = leaf_errs(grads_k, grads_32), leaf_errs(grads_p,
                                                             grads_32)
    ratio = max(k / max(p, 1e-30) for k, p in zip(errs_k, errs_p))
    del grads_k, grads_p, grads_32, params
    torch.cuda.empty_cache()
    log(f"{head}; against f32 (loss {loss_32:.6f}): kernels "
        f"{max(errs_k):.3e}, plain {max(errs_p):.3e}, worst leaf ratio "
        f"{ratio:.3f} (bar {TRAIN_BF16_RATIO:g}; loss bar "
        f"{TRAIN_BF16_LOSS_BAR:g})")
    if not (loss_err < TRAIN_BF16_LOSS_BAR and ratio <= TRAIN_BF16_RATIO):
        raise AssertionError(f"{tag} {cfg.name} {dtype}: loss {loss_err:.3e}"
                             f", kernel / plain error against f32 {ratio:.3f}"
                             f" > {TRAIN_BF16_RATIO:g}")
    out.update(loss_f32=loss_32, grad_max_rel_err_f32_kernel=max(errs_k),
               grad_max_rel_err_f32_plain=max(errs_p), f32_ratio=ratio)
    return out


def phase_lm_train(torch, dev) -> dict:
    """Phase T: (a) qwen2-7b at full width, its depth cut to fit
    TRAIN_BUDGET_GIB (``launch/train.py:train_depth``), TRAIN_STEPS steps
    through the launcher; (b) the gradient parity at 2 layers, f32 and
    the bf16 tensor-core bodies (``TRAIN_PARITY``); (c) one
    step each of h2o, moonshot, deepseek (its first dense MLA layers) and
    seamless, each cut the same way."""
    from repro_torch import configs
    from repro_torch.launch.train import train_depth
    t_start = time.perf_counter()
    out, times = {}, {}
    t0 = time.perf_counter()
    full = configs.get(TRAIN_ARCH)
    cfg, gib = train_depth(full, TRAIN_BUDGET_GIB)
    log(f"phase T(a): {cfg.name} full width, depth {cfg.n_layers} of "
        f"{full.n_layers} ({gib:.2f} GiB of training state by the meta "
        f"estimate), B={TRAIN_B} x S={TRAIN_S} a microbatch, accum "
        f"{TRAIN_ACCUM}, remat, {TRAIN_STEPS} steps")
    run = train_run(torch, dev, cfg, TRAIN_B * TRAIN_ACCUM, TRAIN_S,
                    TRAIN_STEPS, TRAIN_ACCUM, 18)
    losses = [r["loss"] for r in run["rows"]]
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    if not last < first:
        raise AssertionError(f"T(a): loss did not fall: {losses}")
    steady = sorted(r["s"] for r in run["rows"][1:])
    med = steady[len(steady) // 2]
    run.update(estimate_gib=gib, full_layers=full.n_layers,
               step_s_median=med,
               tokens_per_s=TRAIN_B * TRAIN_ACCUM * TRAIN_S / med,
               loss_first3=first, loss_last3=last)
    log(f"  T(a): losses {[round(x, 4) for x in losses]}; step median "
        f"{med:.3f} s = {run['tokens_per_s']:.1f} tokens/s; peak "
        f"{run['peak_gib']:.2f} GiB; FA {run['fa_fwd_a_step']} forwards "
        f"({run['fa_body']}) and {run['fa_bwd_a_step']} backwards "
        f"({run['fa_bwd_body']}) a step")
    out[TRAIN_ARCH] = run
    times["a"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    log(f"phase T(b): {TRAIN_PARITY} at {TRAIN_PARITY_LAYERS} layers: "
        "kernels against plain versions under autograd")
    out["parity"] = [train_parity(torch, dev, configs.get(arch), dtype)
                     for arch, dtype in TRAIN_PARITY]
    times["b"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out["one_step"] = {}
    for arch, b, s in TRAIN_ONE_STEP:
        full = configs.get(arch)
        cfg, gib = train_depth(full, TRAIN_BUDGET_GIB)
        enc = (f" (+{cfg.encoder_layers} encoder)" if cfg.encoder_layers
               else "")
        log(f"phase T(c): {cfg.name} full width, depth {cfg.n_layers} of "
            f"{full.n_layers}{enc} ({gib:.2f} GiB estimate), B={b} x {s}, "
            "one step")
        r = train_run(torch, dev, cfg, b, s, 1, 1, 19)
        r.update(estimate_gib=gib, full_layers=full.n_layers,
                 tokens_per_s=r["rows"][0]["tokens_per_s"])
        log(f"  {cfg.name}: loss {r['rows'][0]['loss']:.4f}, gnorm "
            f"{r['rows'][0]['grad_norm']:.3f}, {r['rows'][0]['s']:.3f} s, "
            f"peak {r['peak_gib']:.2f} GiB, FA {r['fa_fwd_a_step']} forwards "
            f"({r['fa_body']}) and {r['fa_bwd_a_step']} backwards "
            f"({r['fa_bwd_body']})")
        out["one_step"][arch] = r
    times["c"] = time.perf_counter() - t0
    out["phase_s"] = times
    out["seconds"] = time.perf_counter() - t_start
    return out


def lm_train_phases(torch, dev, ptxas, fa_row) -> tuple:
    """Phases S and T; returns ({"fa_bwd": S, "train": T}, the backward
    kernel's row of the kernels line) and adds phase T's FA forward
    launches and body to ``fa_row``."""
    log("phase S: the FA backward kernel against its plain version")
    s = phase_fa_bwd(torch, dev, ptxas)
    t = phase_lm_train(torch, dev)
    main = s["train"][FA_BWD_MAIN]
    run = t[TRAIN_ARCH]
    meta = KERNELS["flash_attention_bwd"]
    row = {"name": "flash_attention_bwd", "route": "cuda",
           "source": meta["source"], "replaces": meta["replaces"],
           "launches": run["fa_bwd_a_step"],
           "launches_per": "a phase-T(a) training step (2 kernels each)",
           "pass_launches": run["fa_bwd_passes_a_step"],
           "body_launches": run["fa_bwd_bodies_a_step"],
           "body": main["body"], "previous_ms": main["previous_ms"],
           "previous_body": main["previous_body"],
           "previous_rel_err_bf16": main["previous_rel_err_bf16"],
           "max_abs_err": main["abs_bfloat16"],
           "max_rel_err_f32": s["max_rel_err"]["float32"],
           "max_rel_err_bf16": s["max_rel_err"]["bfloat16"],
           "max_rel_err_lse": s["max_rel_err"]["lse"],
           "ms": main["ms"], "plain_ms": main["plain_ms"],
           "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
           "bound_peak": "3.35 TB/s; bf16 dense 989 TFLOP/s",
           "library_ms": main["library_ms"],
           "library": "SDPA backward (torch.autograd.grad)",
           "ptxas": main["ptxas"], "ptxas_previous": main["ptxas_previous"]}
    for name, r in s["train"].items():
        if name != FA_BWD_MAIN:
            for key in ("ms", "previous_ms", "previous_rel_err_bf16",
                        "plain_ms", "library_ms", "bound_ms", "bound_by",
                        "body", "ptxas"):
                row[f"{key}_{name}"] = r[key]
    fa_row["launches_train"] = run["fa_fwd_a_step"]
    fa_row["body_train"] = run["fa_body"]
    s_total = s["seconds"] + t["seconds"]
    log(f"phases S-T: S {s['seconds']:.1f} s, T {t['phase_s']} s, "
        f"{s_total:.1f} s together")
    return {"fa_bwd": s, "train": t, "seconds": s_total}, row


# ---------------------------------------------------------------------------
# Mamba-2 and Zamba2 training (phases U-V): the SSD backward kernel, and the
# ssm and hybrid families trained through SSD's forward and backward kernels
# ---------------------------------------------------------------------------

# phase U: the backward kernel at phase V's training shapes (bs, s, h, p,
# g, n, chunk): mamba2-2.7b's N = 128 and zamba2-2.7b's N = 64, 80 heads of
# 64 over one group, B = 2 x S = 4,096
SSD_BWD_TRAIN_CASES = {
    "mamba2_n128": (2, 4096, 80, 64, 1, 128, 128),
    "zamba2_n64": (2, 4096, 80, 64, 1, 64, 128),
}
SSD_BWD_MAIN = "mamba2_n128"
# each output's f32 gradient (before the cast to its input's dtype)
# against the plain version's, of its max |ref|: bf16 inputs as phase 9
# holds SSD's forward (both sides sum in f32 from the same bf16 values)
SSD_BWD_BAR = {"float32": 1e-4, "bfloat16": 5e-4}
SSD_BWD_OUTPUTS = ("dx", "ddt", "da", "db", "dc")
# ptxas's reports of the backward's bodies (mangled names): the tc body's
# exact instantiations (NK, KP) = (8, 4) at mamba2's N = 128 and (4, 4) at
# zamba2's N = 64, its guarded one, and the CUDA-core body in bf16 and f32
PTXAS_SSD_BWD = {
    "tc_n128": ("ssd_chunks_bwd", "ssd_chunk_bwd_tc_kernelILi8ELi4ELb1E"),
    "tc_n64": ("ssd_chunks_bwd", "ssd_chunk_bwd_tc_kernelILi4ELi4ELb1E"),
    "tc_guarded": ("ssd_chunks_bwd", "ssd_chunk_bwd_tc_kernelILi8ELi8ELb0E"),
    "cuda_core_bf16": ("ssd_chunks_bwd",
                       "ssd_chunk_bwd_kernelI13__nv_bfloat16E"),
    "cuda_core_f32": ("ssd_chunks_bwd", "ssd_chunk_bwd_kernelIfE")}
SSD_BWD_TC_PTXAS = {"mamba2_n128": "tc_n128", "zamba2_n64": "tc_n64"}
SSM_TRAIN_ARCH = "mamba2-2.7b"
HYBRID_TRAIN_ARCH = "zamba2-2.7b"
HYBRID_TRAIN_STEPS = 3
# V(b): (arch, layers) in f32 and bf16 at B=1 x S=1024: mamba2's 2 Mamba-2
# layers; zamba2's 6, one shared-block call (d = 80)
SSM_PARITY = (("mamba2-2.7b", 2), ("zamba2-2.7b", 6))


def ssd_bwd_inputs(torch, dev, case, dtype, gen) -> tuple:
    """The backward's inputs at ``case``: x, b and c strided views of one
    (B, S, H P + 2 G N) buffer, as the model's projection split hands them
    over; dt = softplus of a normal draw, a = -linspace(1, 16, H) (the
    model's initial decays); ``cum`` from the forward kernel; f32 normal
    gradients of the three outputs."""
    from repro_torch.kernels.ssd import kernel as ssd
    bs, s, h, p, g, n, L = case
    d_in = h * p
    xbc = (0.5 * torch.randn((bs, s, d_in + 2 * g * n), generator=gen,
                             device=dev)).to(getattr(torch, dtype))
    x = xbc[..., :d_in].view(bs, s, h, p)
    b = xbc[..., d_in:d_in + g * n].view(bs, s, g, n)
    c = xbc[..., d_in + g * n:].view(bs, s, g, n)
    dt = torch.nn.functional.softplus(torch.randn((bs, s, h), generator=gen,
                                                  device=dev))
    a = -torch.linspace(1.0, 16.0, h, device=dev)
    y, st, cum = ssd.ssd_chunks(x, dt, a, b, c, chunk=L)
    grads = [torch.randn(t.shape, generator=gen, device=dev)
             for t in (y, st, cum)]
    del y, st
    return (x, dt, a, b, c, cum, *grads)


def ssd_bwd_hold(torch, dev, name, case, dtype, gen) -> dict:
    """The backward kernel against ``ssd_chunks_bwd_plain`` on the same
    inputs, each f32 gradient within ``SSD_BWD_BAR`` of its max |ref|, two
    kernel calls ``torch.equal``, the cast gradients in their inputs'
    dtypes and equal to the f32 ones cast, every call on the body
    ``ssd_bwd_body`` names.  Returns the errors, the body and the
    inputs."""
    from repro_torch.kernels.ssd import kernel as ssd
    L = case[6]
    args = ssd_bwd_inputs(torch, dev, case, dtype, gen)
    body = ssd.ssd_bwd_body(args[0], args[3], args[4], L)
    before = dict(ssd.ssd_chunks_bwd.body_launches)
    got = ssd.ssd_chunks_bwd(*args, chunk=L, cast=False)
    again = ssd.ssd_chunks_bwd(*args, chunk=L, cast=False)
    cast = ssd.ssd_chunks_bwd(*args, chunk=L)
    ran = {k: v - before[k] for k, v in
           ssd.ssd_chunks_bwd.body_launches.items()}
    if ran != {**dict.fromkeys(ssd.BWD_BODIES, 0), body: 3}:
        raise AssertionError(f"SSD bwd {name} {dtype}: launches by body "
                             f"{ran}, expected 3 on {body!r}")
    want = ssd.ssd_chunks_bwd_plain(*args, chunk=L, cast=False)
    torch.cuda.synchronize()
    errs, abs_errs = [], []
    for oname, g, a, w, cg, t in zip(SSD_BWD_OUTPUTS, got, again, want,
                                     cast, args):
        if not torch.equal(g, a):
            raise AssertionError(f"SSD bwd {name} {oname} {dtype}: two "
                                 "calls differ")
        if cg.dtype != t.dtype or not torch.equal(cg, g.to(t.dtype)):
            raise AssertionError(f"SSD bwd {name} {oname} {dtype}: the "
                                 "cast gradient is not the f32 one cast")
        errs.append(check(f"SSD bwd {name} {oname} {dtype} {body}", g, w,
                          SSD_BWD_BAR[dtype]))
        abs_errs.append(float((g - w).abs().max()))
    del got, again, cast
    return {dtype: max(errs), f"abs_{dtype}": max(abs_errs),
            f"body_{dtype}": body, "args": args, "want": want}


def ssd_bwd_timed(torch, dev, name, case, args, want, ptxas) -> dict:
    """The bf16 backward kernel at a training shape timed with CUDA events
    in turns with the earlier bf16 body (the CUDA-core one, launched
    through the uncounted ``_bwd_launch``: new, earlier, earlier, new; its
    error against the plain version on the same inputs recorded, with no
    bar), beside its plain version and the bound (``launch/roofline.py:
    ssd_bwd_work``: its inputs read once, its gradients written once at
    their inputs' widths; the least products at the bf16 dense peak).  No
    single PyTorch call computes the function: no library time.  Records
    the bytes of the dB / dC partials each body writes, the tc body's
    cluster size, and what the occupancy calculator gives it."""
    from repro_torch.kernels.ssd import kernel as ssd
    from repro_torch.launch import roofline
    bs, s, h, p, g, n, L = case
    body = ssd.ssd_bwd_body(args[0], args[3], args[4], L)
    if body != "tc":
        raise AssertionError(f"SSD bwd {name}: the bf16 training shape "
                             f"takes {body!r}, not the tensor-core body")
    prev = ssd._bwd_launch(*args, L, False, "cuda_core")
    prev_err = max(rel_err(a, w) for a, w in zip(prev, want))
    del prev
    turns = {"new": (lambda: ssd.ssd_chunks_bwd(*args, chunk=L), 5, []),
             "earlier": (lambda: ssd._bwd_launch(*args, L, True,
                                                 "cuda_core"), 2, [])}
    for which in ("new", "earlier", "earlier", "new"):
        fn, reps, got = turns[which]
        got.append(time_ms(torch, fn, reps))
    ms, earlier = (sum(turns[w][2]) / 2 for w in ("new", "earlier"))
    plain = time_ms(torch, lambda: ssd.ssd_chunks_bwd_plain(*args, chunk=L),
                    1)
    nb, flops = roofline.ssd_bwd_work(*args, chunk=L)
    bd = roofline.bound(nb, flops, "bfloat16")
    k = ssd.cluster_heads(h // g)
    info = ssd.tc_bwd_info(L, p, n, k)
    part = {"tc": 2 * 4 * bs * s * (h // k) * n,
            "cuda_core": 2 * 4 * bs * s * h * n}
    ptx = ptxas_of(ptxas, *PTXAS_SSD_BWD[SSD_BWD_TC_PTXAS[name]])
    ptx_cc = ptxas_of(ptxas, *PTXAS_SSD_BWD["cuda_core_bf16"])
    log(f"  SSD bwd {name}: {ms:.3f} ms (tc; turns "
        f"{[round(x, 3) for x in turns['new'][2]]}), earlier body "
        f"(cuda_core) {earlier:.3f} ms in the same call (its worst rel err "
        f"on these inputs {prev_err:.3e}), plain {plain:.1f} ms, library "
        f"none; {nb / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP -> bound "
        f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}) = "
        f"{100 * bd['bound_ms'] / ms:.2f}% of the kernel's time; clusters "
        f"of K={k} heads, dB/dC partials {part['tc'] / 1e6:.1f} MB (the "
        f"earlier body's per-head ones {part['cuda_core'] / 1e6:.1f} MB); "
        f"{info}; ptxas {ptx} (earlier {ptx_cc})")
    return {"ms": ms, "body": body, "previous_ms": earlier,
            "previous_body": "cuda_core", "previous_rel_err_bf16": prev_err,
            "plain_ms": plain, "library_ms": None,
            "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
            "bytes": nb, "flops": flops, "cluster_heads": k,
            "partial_bytes": part["tc"],
            "previous_partial_bytes": part["cuda_core"], "occupancy": info,
            "ptxas": ptx, "ptxas_previous": ptx_cc}


def phase_ssd_bwd(torch, dev, ptxas) -> dict:
    """Phase U: the SSD backward kernel against its plain version on the
    SSD sweep's cases (G = 1, 2, 4; f32 on the CUDA-core body, bf16 on the
    tensor-core body where it takes the shape) and at phase V's training
    shapes in f32 and bf16, timed there in bf16 beside the earlier body."""
    t0 = time.perf_counter()
    reps = {b: ptxas_of(ptxas, *parts) for b, parts in PTXAS_SSD_BWD.items()}
    log(f"  SSD bwd ptxas {reps}")
    spills = {b: r for b, r in reps.items()
              if b.startswith("tc_n") and r.get("spill_bytes")}
    if spills:
        raise AssertionError(f"SSD bwd: the tc body's exact instantiations "
                             f"spill: {spills}")
    gen = torch.Generator(device=dev).manual_seed(20)
    out = {"sweep": {}, "train": {}, "ptxas": reps}
    for i, (bs, s, h, p, g, n, chunk, dtype) in enumerate(SSD_SWEEP):
        r = ssd_bwd_hold(torch, dev, f"sweep{i}", (bs, s, h, p, g, n, chunk),
                         dtype, gen)
        del r["args"], r["want"]
        out["sweep"][f"sweep{i}_{dtype}"] = r
    for name, case in SSD_BWD_TRAIN_CASES.items():
        r = ssd_bwd_hold(torch, dev, name, case, "float32", gen)
        del r["args"], r["want"]
        rb = ssd_bwd_hold(torch, dev, name, case, "bfloat16", gen)
        args, want = rb.pop("args"), rb.pop("want")
        r.update(rb)
        r.update(ssd_bwd_timed(torch, dev, name, case, args, want, ptxas))
        del args, want
        out["train"][name] = r
        torch.cuda.empty_cache()
    held = [*out["sweep"].values(), *out["train"].values()]
    out["max_rel_err"] = {dt: max(r[dt] for r in held if dt in r)
                          for dt in SSD_BWD_BAR}
    out["seconds"] = time.perf_counter() - t0
    log(f"phase U: worst {out['max_rel_err']} in {out['seconds']:.1f} s")
    return out


def phase_ssm_train(torch, dev) -> dict:
    """Phase V: (a) mamba2-2.7b at full width, its depth by
    ``train_depth`` (every layer fits TRAIN_BUDGET_GIB), TRAIN_STEPS steps
    through the launcher; (b) the gradient parity of ``SSM_PARITY`` in f32
    and bf16; (c) zamba2-2.7b at full width the same way, HYBRID_TRAIN_STEPS
    steps."""
    from repro_torch import configs
    from repro_torch.launch.train import train_depth
    t_start = time.perf_counter()
    out, times = {}, {}
    t0 = time.perf_counter()
    full = configs.get(SSM_TRAIN_ARCH)
    cfg, gib = train_depth(full, TRAIN_BUDGET_GIB)
    log(f"phase V(a): {cfg.name} full width, depth {cfg.n_layers} of "
        f"{full.n_layers} ({gib:.2f} GiB of training state by the meta "
        f"estimate), B={TRAIN_B} x S={TRAIN_S} a microbatch, accum "
        f"{TRAIN_ACCUM}, remat, {TRAIN_STEPS} steps")
    run = train_run(torch, dev, cfg, TRAIN_B * TRAIN_ACCUM, TRAIN_S,
                    TRAIN_STEPS, TRAIN_ACCUM, 21)
    losses = [r["loss"] for r in run["rows"]]
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    if not last < first:
        raise AssertionError(f"V(a): loss did not fall: {losses}")
    steady = sorted(r["s"] for r in run["rows"][1:])
    med = steady[len(steady) // 2]
    run.update(estimate_gib=gib, full_layers=full.n_layers,
               step_s_median=med,
               tokens_per_s=TRAIN_B * TRAIN_ACCUM * TRAIN_S / med,
               loss_first3=first, loss_last3=last)
    log(f"  V(a): losses {[round(x, 4) for x in losses]}; step median "
        f"{med:.3f} s = {run['tokens_per_s']:.1f} tokens/s; peak "
        f"{run['peak_gib']:.2f} GiB; SSD {run['ssd_fwd_a_step']} forwards "
        f"({run['ssd_fwd_bodies_a_step']}) and {run['ssd_bwd_a_step']} "
        f"backwards a step; FA {run['fa_fwd_a_step']}")
    out[SSM_TRAIN_ARCH] = run
    times["a"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    log(f"phase V(b): {SSM_PARITY} in f32 and bf16: kernels against plain "
        "versions under autograd")
    out["parity"] = [train_parity(torch, dev, configs.get(arch), dtype,
                                  layers=layers, tag="V(b)")
                     for arch, layers in SSM_PARITY
                     for dtype in ("float32", "bfloat16")]
    times["b"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    full = configs.get(HYBRID_TRAIN_ARCH)
    cfg, gib = train_depth(full, TRAIN_BUDGET_GIB)
    log(f"phase V(c): {cfg.name} full width, depth {cfg.n_layers} of "
        f"{full.n_layers} ({gib:.2f} GiB estimate), B={TRAIN_B} x "
        f"S={TRAIN_S} a microbatch, accum {TRAIN_ACCUM}, "
        f"{HYBRID_TRAIN_STEPS} steps")
    r = train_run(torch, dev, cfg, TRAIN_B * TRAIN_ACCUM, TRAIN_S,
                  HYBRID_TRAIN_STEPS, TRAIN_ACCUM, 22)
    steady = sorted(x["s"] for x in r["rows"][1:])
    med = steady[len(steady) // 2]
    r.update(estimate_gib=gib, full_layers=full.n_layers, step_s_median=med,
             tokens_per_s=TRAIN_B * TRAIN_ACCUM * TRAIN_S / med)
    log(f"  V(c): losses {[round(x['loss'], 4) for x in r['rows']]}, gnorm "
        f"{[round(x['grad_norm'], 3) for x in r['rows']]}; step median "
        f"{med:.3f} s = {r['tokens_per_s']:.1f} tokens/s; peak "
        f"{r['peak_gib']:.2f} GiB; SSD {r['ssd_fwd_a_step']} forwards and "
        f"{r['ssd_bwd_a_step']} backwards a step; FA {r['fa_fwd_a_step']} "
        f"forwards ({r['fa_body']}) and {r['fa_bwd_a_step']} backwards "
        f"({r['fa_bwd_body']})")
    out[HYBRID_TRAIN_ARCH] = r
    times["c"] = time.perf_counter() - t0
    out["phase_s"] = times
    out["seconds"] = time.perf_counter() - t_start
    return out


def ssm_train_phases(torch, dev, ptxas, ssd_row) -> tuple:
    """Phases U and V; returns ({"ssd_bwd": U, "train": V}, the SSD
    backward kernel's row of the kernels line) and adds phase V's SSD
    forward launches to ``ssd_row``."""
    log("phase U: the SSD backward kernel against its plain version")
    u = phase_ssd_bwd(torch, dev, ptxas)
    v = phase_ssm_train(torch, dev)
    main = u["train"][SSD_BWD_MAIN]
    run, hyb = v[SSM_TRAIN_ARCH], v[HYBRID_TRAIN_ARCH]
    meta = KERNELS["ssd_chunks_bwd"]
    for tag, r in (("V(a)", run), ("V(c)", hyb)):
        if r["ssd_bwd_bodies_a_step"]["tc"] != r["ssd_bwd_a_step"]:
            raise AssertionError(f"{tag}: SSD backward launches by body "
                                 f"{r['ssd_bwd_bodies_a_step']}, not all tc")
    row = {"name": "ssd_chunks_bwd", "route": "cuda",
           "source": meta["source"], "replaces": meta["replaces"],
           "launches": run["ssd_bwd_a_step"],
           "launches_per": "a phase-V(a) mamba2-2.7b training step",
           "launches_zamba2": hyb["ssd_bwd_a_step"],
           "body": main["body"], "previous_ms": main["previous_ms"],
           "previous_body": main["previous_body"],
           "max_abs_err": main["abs_bfloat16"],
           "max_rel_err_f32": u["max_rel_err"]["float32"],
           "max_rel_err_bf16": u["max_rel_err"]["bfloat16"],
           "ms": main["ms"], "plain_ms": main["plain_ms"],
           "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
           "bound_peak": "3.35 TB/s; bf16 dense 989 TFLOP/s",
           "library_ms": None, "library": "none (no single PyTorch call)",
           "cluster_heads": main["cluster_heads"],
           "partial_bytes": main["partial_bytes"],
           "previous_partial_bytes": main["previous_partial_bytes"],
           "occupancy": main["occupancy"],
           "ptxas": main["ptxas"], "ptxas_previous": main["ptxas_previous"],
           "ptxas_f32": u["ptxas"]["cuda_core_f32"]}
    for name, r in u["train"].items():
        if name != SSD_BWD_MAIN:
            for key in ("ms", "previous_ms", "plain_ms", "library_ms",
                        "bound_ms", "bound_by", "ptxas"):
                row[f"{key}_{name}"] = r[key]
    ssd_row["launches_train"] = run["ssd_fwd_a_step"]
    ssd_row["launches_train_zamba2"] = hyb["ssd_fwd_a_step"]
    total = u["seconds"] + v["seconds"]
    log(f"phases U-V: U {u['seconds']:.1f} s, V {v['phase_s']} s, "
        f"{total:.1f} s together")
    return {"ssd_bwd": u, "train": v, "seconds": total}, row


# ---------------------------------------------------------------------------
# the full single-device MD surface: field cooling with telemetry and
# checkpoints, bitwise resume, Heisenberg-DMI
# ---------------------------------------------------------------------------

SURFACE_DIR = ROOT / "build" / "chip_smoke"
FC_CHUNKS, FC_CHUNK, FC_OBS_EVERY = 4, 20, 5
FC_OBS = ("energy", "kinetic", "magnetization", "charge", "skyrmion_count",
          "pitch")
# the Fig. 9 protocol: 300 K for 20 fs, down to 100 K over 40 fs, 0.2 T
FC_T = dict(t_hot=300.0, t_cold=100.0, b_field=0.2, t_hold=0.02,
            t_ramp=0.04)
# Heisenberg-DMI on the B20 lattice: its Morse minimum at the Fe-Fe
# nearest-neighbor distance (the default r0 is the lattice constant, which
# would push the 2.4-2.9 A B20 neighbors apart at ~150 eV/A)
HEIS_B20 = dict(r0=2.9, morse_de=0.05, d0=0.008, ka=0.001)
HEIS_CHUNKS, HEIS_CHUNK = 2, 20


def reset_md_counters(kern):
    for fn in (kern.nep_atom_pass, kern.nep_force_pass):
        fn.launches = 0
        fn.body_launches = dict.fromkeys(kern.BODIES, 0)


def read_md_counters(kern):
    return {fn.__name__: (fn.launches, dict(fn.body_launches))
            for fn in (kern.nep_atom_pass, kern.nep_force_pass)}


def cooling_rows(dt: float):
    """The per-step temperatures of the field-cooling protocol, written out
    here in numpy float32 (hold, linear ramp, hold) at the engine's clock:
    chunk start ``step * dt`` plus ``i * dt``, both float32."""
    import numpy as np
    f32 = np.float32
    t = np.concatenate([f32(c * FC_CHUNK) * f32(dt)
                        + np.arange(FC_CHUNK, dtype=f32) * f32(dt)
                        for c in range(FC_CHUNKS)])
    t0 = f32(FC_T["t_hold"])
    t1 = f32(FC_T["t_hold"] + FC_T["t_ramp"])
    hot, cold = f32(FC_T["t_hot"]), f32(FC_T["t_cold"])
    w = np.clip((t - t0) / np.maximum(t1 - t0, f32(1e-30)), f32(0), f32(1))
    ramp = hot + w * (cold - hot)
    return np.where(t < t0, hot, np.where(t >= t1, cold, ramp))


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def fc_engine(torch, dev, spec, lat, moments, kern):
    """A field-cooling Engine at the main path's size and spec, K1/K2."""
    from repro_torch.configs.fege_spinlattice import main_path
    from repro_torch.core.potential import NEPSpinPotential, init_params
    from repro_torch.ensemble import protocol
    from repro_torch.md.engine import Engine
    from repro_torch.md.integrator import IntegratorConfig
    from repro_torch.md.state import init_state
    run = main_path()
    dtype = getattr(torch, run.dtype)
    state = init_state(lat, run.unit_cells, generator=torch.Generator(
        device=dev).manual_seed(21), temperature=FC_T["t_hot"], dtype=dtype,
        device=dev)
    params = init_params(spec, torch.Generator(device=dev).manual_seed(22),
                         dtype=dtype, device=dev)
    temp, field = protocol.field_cooling(
        FC_T["t_hot"], FC_T["t_cold"], FC_T["b_field"],
        t_hold=FC_T["t_hold"], t_ramp=FC_T["t_ramp"])
    cfg = IntegratorConfig(dt=run.dt, lattice_gamma=run.lattice_gamma,
                           spin_alpha=run.spin_alpha)
    return run, Engine(
        NEPSpinPotential(spec, params, moments.to(dtype), use_kernel=True),
        cfg, state, torch.tensor(lat.masses, dtype=dtype, device=dev),
        torch.tensor(lat.moments, device=dev) > 0, spec.cutoff,
        temperature=temp, field=field, observables=FC_OBS,
        obs_every=FC_OBS_EVERY, capacity=run.capacity, skin=run.skin,
        use_cell_list=True, cell_capacity=run.cell_capacity, device=dev)


def same_run(torch, a, b, rows, what):
    """Raise unless engine ``b`` ended bitwise where ``a`` did and its
    trace equals ``a``'s rows ``rows``."""
    import numpy as np
    for k in ("pos", "vel", "spin"):
        if not torch.equal(getattr(a.state, k), getattr(b.state, k)):
            d = float((getattr(a.state, k) - getattr(b.state, k)).abs().max())
            raise AssertionError(f"{what}: {k} differs (max |diff| {d:.3e})")
    if (a.state.step, a.n_rebuilds) != (b.state.step, b.n_rebuilds):
        raise AssertionError(f"{what}: step / rebuilds {a.state.step}, "
                             f"{a.n_rebuilds} vs {b.state.step}, "
                             f"{b.n_rebuilds}")
    for k, v in b.trace.values.items():
        if not np.array_equal(a.trace.values[k][rows], v):
            raise AssertionError(f"{what}: trace {k} differs")


def phase_field_cooling(torch, dev, spec, lat, moments, kern) -> dict:
    """Phases A and B; returns their numbers."""
    import shutil

    import numpy as np

    from repro_torch.ckpt.checkpoint import save_md
    from repro_torch.telemetry import HealthConfig, Telemetry, read_runlog
    shutil.rmtree(SURFACE_DIR, ignore_errors=True)
    ckpt = SURFACE_DIR / "ckpt"
    steps = FC_CHUNKS * FC_CHUNK
    log(f"phase A: field cooling (Fig. 9: {FC_T}) at the main path's size, "
        f"{FC_CHUNKS} x {FC_CHUNK} steps, observables {FC_OBS} every "
        f"{FC_OBS_EVERY} steps, runlog + health + profile + checkpoints")
    out, done = {}, {}
    # bare; with a runlog, health checks and a checkpoint every chunk; and
    # with a profiler trace on top (its runlog and checkpoints are the ones
    # checked and restored)
    for tag in ("bare", "telemetry", "profiled"):
        torch.cuda.synchronize()
        reset_md_counters(kern)
        run, eng = fc_engine(torch, dev, spec, lat, moments, kern)
        seen = []
        step = eng._step

        def recording(st, ff, nbh, gen, temp, field, _step=step):
            seen.append((temp, field))
            return _step(st, ff, nbh, gen, temp, field)

        eng._step = recording
        gen = torch.Generator(device=dev).manual_seed(23)
        kw = {}
        if tag != "bare":
            eng.ckpt_pin = 2 * FC_CHUNK       # phase B restores it
            sub = SURFACE_DIR / tag
            kw = dict(checkpoint_dir=str(sub / "ckpt"), checkpoint_keep=2,
                      telemetry=Telemetry(
                          runlog=sub / "field_cooling.jsonl",
                          health=HealthConfig(max_spin_dev=1e-3),
                          profile_dir=(sub / "profile" if tag == "profiled"
                                       else None)))
        # first uses (the FFT plan, sorts) outside the timed run
        eng._observe(eng._carry.state, eng._carry.ff)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(steps, gen, chunk=FC_CHUNK, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_md_counters(kern)
        expect = 1 + steps + eng.n_rebuilds
        log(f"  {tag}: {steps} steps in {secs:.3f} s = {steps / secs:.3f} "
            f"steps/s, rebuilds {eng.n_rebuilds}, launches {counts}")
        for name, (n, by_body) in counts.items():
            if n != expect or by_body != {"warp": expect, "thread": 0}:
                raise AssertionError(f"{name}: launches {n} by body "
                                     f"{by_body}, expected {expect}, all "
                                     "in the warp body")
        temps = np.asarray([t for t, _ in seen], np.float32)
        if not np.array_equal(temps, cooling_rows(run.dt)):
            raise AssertionError("per-step temperatures differ from the "
                                 "protocol's formula")
        fields = torch.stack([f for _, f in seen]).cpu()
        if not torch.equal(fields, torch.tensor(
                [[0.0, 0.0, FC_T["b_field"]]] * steps,
                dtype=fields.dtype)):
            raise AssertionError("per-step fields differ from 0.2 T along z")
        n_emit = steps // FC_OBS_EVERY
        for k, v in eng.trace.values.items():
            if v.shape[0] != n_emit or not np.isfinite(v).all():
                raise AssertionError(f"observable {k}: shape {v.shape} or "
                                     "non-finite values")
        out[tag] = dict(steps_per_s=steps / secs, seconds=secs,
                        rebuilds=eng.n_rebuilds, launches=expect)
        done[tag] = eng
        if tag == "bare":
            continue
        same_run(torch, done["bare"], eng, slice(None),
                 f"{tag}: telemetry and checkpoints changed the trajectory")
        events = read_runlog(SURFACE_DIR / tag / "field_cooling.jsonl")
        chunks = [e for e in events if e["event"] == "chunk"]
        kinds = [e["event"] for e in events]
        if kinds != ["run_start"] + ["chunk"] * FC_CHUNKS + ["run_end"]:
            raise AssertionError(f"runlog events {kinds}")
        if any(c["compiles"] for c in chunks[1:]):
            raise AssertionError(f"compiles after the first chunk: "
                                 f"{[c['compiles'] for c in chunks]}")
        if (any(c["verdict"] != "ok" for c in chunks)
                or events[-1]["status"] != "ok"):
            raise AssertionError(f"verdicts {[c['verdict'] for c in chunks]}"
                                 f", status {events[-1]['status']}")
        ckpts = sorted(p.name for p in (SURFACE_DIR / tag / "ckpt").iterdir())
        chunk_rates = [c["steps_per_s"] for c in chunks]
        log(f"  {tag} runlog: {len(events)} records, compiles "
            f"{[c['compiles'] for c in chunks]}, verdicts "
            f"{[c['verdict'] for c in chunks]}, in-chunk steps/s "
            f"{[round(r, 3) for r in chunk_rates]}, last health "
            f"{chunks[-1]['health']}; checkpoints {ckpts}")
        out[tag]["chunk_steps_per_s"] = chunk_rates
        if tag == "profiled":
            trace = SURFACE_DIR / tag / "profile" / "trace.json"
            if not trace.is_file() or trace.stat().st_size == 0:
                raise AssertionError(f"no profiler trace at {trace}")
            out[tag]["trace_bytes"] = trace.stat().st_size
            log(f"  provenance {events[0]['provenance']}; trace "
                f"{trace.stat().st_size / 1e6:.1f} MB")
            log(f"  observables at the last emission: "
                f"{ {k: v[-1].tolist() for k, v in eng.trace.values.items()} }")
    ckpt = SURFACE_DIR / "profiled" / "ckpt"

    # the cost of a checkpoint at this size, outside the run
    t0 = time.perf_counter()
    path = eng.save(str(SURFACE_DIR / "timing"), gen)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    handle = save_md(str(SURFACE_DIR / "timing_async"), eng.ckpt_step(),
                     eng._ckpt_tree(eng._carry), gen, async_=True)
    async_s = time.perf_counter() - t0
    handle.join()
    size = dir_bytes(Path(path))

    log("phase B: restore the chunk-2 checkpoint into a fresh Engine, run "
        "chunks 3-4, hold them bitwise to phase A")
    _, fresh = fc_engine(torch, dev, spec, lat, moments, kern)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen_b = fresh.restore(str(ckpt), step=2 * FC_CHUNK)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    fresh.run(steps - 2 * FC_CHUNK, gen_b, chunk=FC_CHUNK)
    same_run(torch, eng, fresh, slice(steps // FC_OBS_EVERY // 2, None),
             "resume")
    log(f"  resumed run is bitwise phase A's (pos, vel, spin, step "
        f"{fresh.state.step}, rebuilds {fresh.n_rebuilds}, trace rows); "
        f"checkpoint {size / 1e6:.1f} MB, save {save_s:.3f} s (async call "
        f"returns in {async_s:.3f} s), load + re-derived blocks "
        f"{load_s:.3f} s")
    out.update(ckpt_bytes=size, save_s=save_s, async_call_s=async_s,
               load_s=load_s)
    del eng, done, fresh
    torch.cuda.empty_cache()
    return out


def phase_heisenberg(torch, dev, lat) -> dict:
    """Phase C: Heisenberg-DMI at full width with deterministic pair sums."""
    import shutil

    from repro_torch.configs.fege_spinlattice import main_path
    from repro_torch.core.hamiltonian import HeisenbergDMIModel
    from repro_torch.md import analysis
    from repro_torch.md.engine import Engine
    from repro_torch.md.integrator import IntegratorConfig
    from repro_torch.md.neighbor import (assemble_pair_forces,
                                         assemble_pair_forces_plain,
                                         reverse_index)
    from repro_torch.md.state import init_state
    from repro_torch.telemetry import peak_device_memory
    run = main_path()
    dtype = getattr(torch, run.dtype)
    ham = HeisenbergDMIModel(**HEIS_B20)
    steps = HEIS_CHUNKS * HEIS_CHUNK
    log(f"phase C: Heisenberg-DMI {HEIS_B20} on B20 {run.unit_cells} = "
        f"{run.n_atoms} atoms, {HEIS_CHUNKS} x {HEIS_CHUNK} steps, midpoint "
        f"(2 iterations), {run.temperature} K, B={run.field} T")
    ckpt = SURFACE_DIR / "heisenberg_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)

    def engine():
        state = init_state(lat, run.unit_cells, generator=torch.Generator(
            device=dev).manual_seed(31), temperature=run.temperature,
            dtype=dtype, device=dev)
        cfg = IntegratorConfig(dt=run.dt, lattice_gamma=run.lattice_gamma,
                               spin_alpha=run.spin_alpha, midpoint=True,
                               midpoint_iters=2)
        return Engine(ham, cfg, state,
                      torch.tensor(lat.masses, dtype=dtype, device=dev),
                      torch.tensor(lat.moments, device=dev) > 0, ham.cutoff,
                      temperature=run.temperature, field=run.field,
                      observables=FC_OBS, capacity=run.capacity,
                      skin=run.skin, use_cell_list=True,
                      cell_capacity=run.cell_capacity, device=dev)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = engine()
    torch.cuda.synchronize()
    peak_setup = peak_device_memory()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(33)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(steps, gen, chunk=HEIS_CHUNK, checkpoint_dir=str(ckpt),
            checkpoint_keep=2)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = peak_device_memory()
    log(f"  {steps} steps in {secs:.3f} s = {steps / secs:.3f} steps/s "
        f"(5 evaluations a step), rebuilds {eng.n_rebuilds}, peak memory "
        f"{peak / 2**30:.2f} GiB in the run, {peak_setup / 2**30:.2f} GiB "
        f"in the construction (a table build, one evaluation), energy "
        f"{eng.energy:.6f} eV")
    for k, v in eng.trace.values.items():
        if not torch.isfinite(torch.as_tensor(v)).all():
            raise AssertionError(f"Heisenberg observable {k} non-finite")

    fresh = engine()
    gen_b = fresh.restore(str(ckpt), step=HEIS_CHUNK)
    fresh.run(steps - HEIS_CHUNK, gen_b, chunk=HEIS_CHUNK)
    same_run(torch, eng, fresh, slice(1, None), "Heisenberg resume")
    log("  resumed run is bitwise the uninterrupted one")

    # the deterministic reductions against index_add_ on the same inputs
    c = eng._carry
    nbh, spin, types = c.nbh, c.state.spin, c.state.types
    det = ham.compute(nbh, spin, types, run.field)
    again = ham.compute(nbh, spin, types, run.field)
    plain = ham.compute(nbh, spin, types, run.field, plain=True)
    plain2 = ham.compute(nbh, spin, types, run.field, plain=True)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(det, again)):
        raise AssertionError("two deterministic evaluations differ")
    errs = {name: check(f"Heisenberg {name} det vs index_add_", a, b, 2e-5)
            for name, a, b in zip("EFH", det, plain)}
    plain_repeat = [float((a - b).abs().max()) for a, b in zip(plain,
                                                               plain2)]
    log(f"  index_add_ twice on the same inputs: max |diff| E, F, H "
        f"{plain_repeat}")
    g = torch.randn(nbh.dr.shape, dtype=dtype, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(34))
    pos, box = c.state.pos, c.state.box
    times = {
        "pair_forces_ms": time_ms(torch, lambda: assemble_pair_forces(
            g, nbh), 20),
        "pair_forces_plain_ms": time_ms(
            torch, lambda: assemble_pair_forces_plain(g, nbh), 20),
        "reverse_index_ms": time_ms(torch, lambda: reverse_index(nbh.idx),
                                    5),
        "spin_grid_ms": time_ms(torch, lambda: analysis.accumulate_spin_grid(
            pos, spin, box), 20),
        "spin_grid_plain_ms": time_ms(
            torch, lambda: analysis.accumulate_spin_grid(pos, spin, box,
                                                         plain=True), 20),
        "evaluation_ms": time_ms(torch, lambda: ham.compute(
            nbh, spin, types, run.field), 5),
        "evaluation_plain_ms": time_ms(torch, lambda: ham.compute(
            nbh, spin, types, run.field, plain=True), 5),
    }
    grid_err = check("spin grid det vs index_add_",
                     analysis.accumulate_spin_grid(pos, spin, box),
                     analysis.accumulate_spin_grid(pos, spin, box,
                                                   plain=True), 2e-5)
    log(f"  times (ms): {times}")
    out = dict(steps_per_s=steps / secs, seconds=secs,
               rebuilds=eng.n_rebuilds, peak_memory_bytes=peak,
               peak_memory_setup_bytes=peak_setup,
               det_vs_plain_rel_err=errs, grid_rel_err=grid_err,
               plain_repeat_max_abs_diff=plain_repeat, **times)
    del eng, fresh, c, nbh, det, again, plain, plain2, g
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# later slices: the md_loop scenario, the replica plan, the ensemble layer
# ---------------------------------------------------------------------------

REPLICAS = 4
REP_CHUNKS, REP_CHUNK = 3, 20
REP_FLAT_STEPS = 10       # (c): a chunk short enough to trip no rebuild
REP_JITTER = 0.02         # A: each replica's positions, from its generator
REP_KERNEL_CELLS = (8, 8, 8)   # (b): phase 2's 4,096-atom lattice
# phase F's depth, cut for the time limit (the autograd Heisenberg-DMI
# evaluation loops over the replicas: ~80 ms a step for 8 films); the
# protocol keeps its shape (its knots scale with the step count)
NUCLEATION_STEPS = 300     # of nucleation_ensemble()'s 2,000 (500 until
                           # the script's time limit cut it)
SWEEP_STEPS = 50           # of nucleation_ensemble_smoke()'s 300 (100
                           # until the script's time limit cut it)
TEMPERING_CHUNKS = 8       # of 10 steps, on nucleation_ensemble()'s film


def md_loop_kernels(torch, kern, ref, sim) -> dict:
    """Phase D's kernels on the md_loop path's own inputs: the kernel
    path's table, blocks and spins after its timed run (4,096 simple-cubic
    atoms, M = 8, the md_loop spec), K1 and K2 in both bodies against the
    plain versions at f32 (1e-4) and, on the same inputs cast, f64
    (1e-9)."""
    from repro_torch.core.potential import NEPSpinParams
    c = sim._engine._carry
    spec, types = sim.potential.spec, c.state.types
    errs = {"nep_atom_pass": {}, "nep_force_pass": {}}
    for dtype, bar, tag in ((torch.float32, 1e-4, "f32"),
                            (torch.float64, 1e-9, "f64")):
        params = NEPSpinParams(*(p.to(dtype) for p in sim.potential.params))
        dr, spin = c.nbh.dr.to(dtype), c.state.spin.to(dtype)
        sj = spin[c.nbh.idx.long()]
        blocks = (dr, c.nbh.mask, types, c.nbh.tj, spin, sj)
        want1 = ref.atom_pass_plain(spec, params, *blocks)
        k2_args = (dr, c.nbh.mask, c.nbh.idx, types, c.nbh.tj, spin, sj,
                   want1[2])
        want2 = ref.force_pass_plain(spec, params, *k2_args)
        for body in kern.BODIES:
            got1 = kern.nep_atom_pass(spec, params, *blocks, body=body)
            got2 = kern.nep_force_pass(spec, params, *k2_args, body=body)
            torch.cuda.synchronize()
            e1 = max(check(f"K1 md_loop {body} {o} {tag}", a, b, bar)
                     for o, a, b in zip(("e", "hdir", "abar"), got1, want1))
            e2 = max(check(f"K2 md_loop {body} {o} {tag}", a, b, bar)
                     for o, a, b in zip(("F", "h2"), got2, want2))
            errs["nep_atom_pass"][f"{body}_{tag}"] = e1
            errs["nep_force_pass"][f"{body}_{tag}"] = e2
    return errs


def phase_md_loop(torch, kern, ref) -> dict:
    """Phase D: the md_loop scenario (launch/md_loop.py) with its gates;
    every K1 and K2 launch of the kernel path in the warp body; then both
    kernels, both bodies, against their plain versions on the path's own
    inputs."""
    from repro_torch.launch.md_loop import run_scenario
    log("phase D: the md_loop scenario, simple cubic 16^3 = 4,096 atoms, "
        "chunk 20, skin 0.2, capacity 8, 500 K")
    sims = {}
    out = run_scenario("cuda", keep=sims)
    kp = out["potentials"]["nep_kernel"]
    for name, c in kp["fused"]["launches"].items():
        if c["total"] == 0 or c["warp"] != c["total"] or c["thread"]:
            raise AssertionError(f"md_loop kernel path: {name} launches {c}"
                                 ", expected all in the warp body")
    log(f"  vs_autodiff {kp['vs_autodiff']:.3f}; kernel-path launches "
        f"{kp['fused']['launches']}; telemetry overhead "
        f"{100 * out['telemetry']['overhead_vs_fused']:.1f}%")
    out["kernel_rel_err"] = md_loop_kernels(
        torch, kern, ref, sims["nep_kernel", "fused"])
    del sims
    torch.cuda.empty_cache()
    return out


def replica_states(torch, dev, lat, cells, dtype, seed, temperature):
    """REPLICAS distinct states: each replica's velocities and a small
    position jitter drawn from its own generator."""
    from repro_torch.md.state import init_state, stack_states
    sts = []
    for r in range(REPLICAS):
        g = torch.Generator(device=dev).manual_seed(seed + r)
        st = init_state(lat, cells, generator=g, temperature=temperature,
                        dtype=dtype, device=dev)
        jit = REP_JITTER * torch.randn(st.pos.shape, generator=g,
                                       dtype=dtype, device=dev)
        sts.append(st._replace(pos=torch.remainder(st.pos + jit, st.box)))
    return stack_states(sts)


def replica_kernels(torch, dev, spec, lat, kern, ref) -> dict:
    """Phase E (b): K1 and K2 on a replica batch (R = 4, B20 8x8x8, both
    bodies) against the plain versions at f64 (1e-9) and f32 (1e-4), and
    replica r of each batched launch bitwise against a flat launch on
    replica r's inputs."""
    from repro_torch.core.potential import NEPSpinParams, init_params
    from repro_torch.md.neighbor import (cell_neighbor_table, reference_pos,
                                         shared_blocks)
    errs = {"nep_atom_pass": {}, "nep_force_pass": {}}
    p64 = init_params(spec, torch.Generator(device=dev).manual_seed(41),
                      dtype=torch.float64, device=dev)
    for dtype, bar, tag in ((torch.float64, 1e-9, "f64"),
                            (torch.float32, 1e-4, "f32")):
        st = replica_states(torch, dev, lat, REP_KERNEL_CELLS, dtype, 50,
                            0.0)
        g = torch.Generator(device=dev).manual_seed(42)
        spin = torch.nn.functional.normalize(torch.randn(
            st.spin.shape, generator=g, dtype=dtype, device=dev), dim=-1)
        spin = spin * (st.spin.norm(dim=-1, keepdim=True) > 0)
        params = NEPSpinParams(*(p.to(dtype) for p in p64))
        box, types = st.box[0], st.types[0]
        tab = cell_neighbor_table(reference_pos(st.pos, box), box,
                                  spec.cutoff, 64, cell_capacity=32)
        nbh = shared_blocks(tab, types, st.pos, box)
        sj = spin[:, nbh.idx.long()]
        blocks = (nbh.dr, nbh.mask, types, nbh.tj, spin, sj)
        want1 = ref.atom_pass_plain(spec, params, *blocks)
        k2_args = (nbh.dr, nbh.mask, nbh.idx, types, nbh.tj, spin, sj,
                   want1[2])
        want2 = ref.force_pass_plain(spec, params, *k2_args)
        for body in kern.BODIES:
            got1 = kern.nep_atom_pass(spec, params, *blocks, body=body)
            got2 = kern.nep_force_pass(spec, params, *k2_args, body=body)
            torch.cuda.synchronize()
            e1 = max(check(f"K1 R={REPLICAS} {body} {o} {tag}", a, b, bar)
                     for o, a, b in zip(("e", "hdir", "abar"), got1, want1))
            e2 = max(check(f"K2 R={REPLICAS} {body} {o} {tag}", a, b, bar)
                     for o, a, b in zip(("F", "h2"), got2, want2))
            for r in range(REPLICAS):
                flat1 = kern.nep_atom_pass(
                    spec, params, nbh.dr[r], nbh.mask, types, nbh.tj,
                    spin[r], sj[r], body=body)
                flat2 = kern.nep_force_pass(
                    spec, params, nbh.dr[r], nbh.mask, nbh.idx, types,
                    nbh.tj, spin[r], sj[r], want1[2][r], body=body)
                for o, a, b in zip(("e", "hdir", "abar", "F", "h2"),
                                   (*got1, *got2), (*flat1, *flat2)):
                    if not torch.equal(a[r], b):
                        raise AssertionError(
                            f"{body} {tag}: replica {r}'s {o} of the "
                            "batched launch is not the flat launch's")
            if body == "warp":
                errs["nep_atom_pass"][tag] = e1
                errs["nep_force_pass"][tag] = e2
        log(f"  {tag}: every replica of the batched launches bitwise the "
            "flat launch, both bodies")
    torch.cuda.empty_cache()
    return errs


def replica_engine(torch, dev, spec, params, lat, moments, states, **kw):
    from repro_torch.configs.fege_spinlattice import main_path
    from repro_torch.core.potential import NEPSpinPotential
    from repro_torch.ensemble import protocol
    from repro_torch.md.engine import Engine
    from repro_torch.md.integrator import IntegratorConfig
    from repro_torch.parallel.plan import Replicated
    run = main_path()
    dtype = states.pos.dtype
    temp, field = protocol.field_cooling(
        FC_T["t_hot"], FC_T["t_cold"], FC_T["b_field"],
        t_hold=FC_T["t_hold"], t_ramp=FC_T["t_ramp"])
    cfg = kw.pop("cfg", IntegratorConfig(dt=run.dt,
                                         lattice_gamma=run.lattice_gamma,
                                         spin_alpha=run.spin_alpha))
    return Engine(
        NEPSpinPotential(spec, params, moments.to(dtype), use_kernel=True),
        cfg, states, torch.tensor(lat.masses, dtype=dtype, device=dev),
        torch.tensor(lat.moments, device=dev) > 0, spec.cutoff,
        plan=kw.pop("plan", Replicated(REPLICAS)), temperature=temp,
        field=field, capacity=run.capacity, skin=run.skin,
        use_cell_list=True, cell_capacity=run.cell_capacity, device=dev,
        **kw)


def same_replicas(torch, a, b, what, slots=None):
    for k in ("pos", "vel", "spin"):
        x, y = getattr(a.state, k), getattr(b.state, k)
        for r in (range(x.shape[0]) if slots is None else slots):
            if not torch.equal(x[r], y[r]):
                d = float((x[r] - y[r]).abs().max())
                raise AssertionError(f"{what}: replica {r}'s {k} differs "
                                     f"(max |diff| {d:.3e})")


def phase_replica(torch, dev, spec, lat, moments, kern, ref) -> dict:
    """Phase E: the Replicated plan at full width (4 x 262,144 atoms)."""
    import shutil

    import numpy as np

    from repro_torch.launch.roofline import nbytes

    from repro_torch.configs.fege_spinlattice import main_path
    from repro_torch.core.potential import init_params
    from repro_torch.ensemble.replica import spawn_generators
    from repro_torch.md.integrator import IntegratorConfig
    from repro_torch.md.state import init_state, stack_states, unstack_state
    from repro_torch.parallel.plan import SingleDevice
    from repro_torch.telemetry import peak_device_memory
    run = main_path()
    dtype = getattr(torch, run.dtype)
    steps = REP_CHUNKS * REP_CHUNK
    log(f"phase E: Replicated({REPLICAS}) x B20 {run.unit_cells} = "
        f"{REPLICAS} x {run.n_atoms} atoms, field cooling {FC_T}, "
        f"{REP_CHUNKS} x {REP_CHUNK} steps, K1/K2 batched over the replicas")
    errs = replica_kernels(torch, dev, spec, lat, kern, ref)
    params = init_params(spec, torch.Generator(device=dev).manual_seed(43),
                         dtype=dtype, device=dev)

    def states():
        return replica_states(torch, dev, lat, run.unit_cells, dtype, 60,
                              FC_T["t_hot"])

    # (a) the run, every evaluation one K1 and one K2 launch for all R
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_md_counters(kern)
    eng = replica_engine(torch, dev, spec, params, lat, moments, states())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(steps, spawn_generators(61, REPLICAS, dev), chunk=REP_CHUNK)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = peak_device_memory()
    counts = read_md_counters(kern)
    expect = 1 + steps + eng.n_rebuilds
    n_atoms = eng.state.pos.shape[1]
    log(f"  {steps} steps of {REPLICAS} replicas in {secs:.3f} s = "
        f"{steps / secs:.3f} steps/s, {REPLICAS * steps / secs:.3f} "
        f"replica-steps/s, {REPLICAS * n_atoms * steps / secs:.4e} "
        f"atom-steps/s; rebuilds {eng.n_rebuilds}; launches {counts}; peak "
        f"memory {peak / 2**30:.2f} GiB")
    for name, (n, by_body) in counts.items():
        if n != expect or by_body != {"warp": expect, "thread": 0}:
            raise AssertionError(f"{name}: launches {n} by body {by_body}, "
                                 f"expected {expect} (one per evaluation "
                                 "for all replicas), all warp")
    for k, v in eng.trace.values.items():
        if v.shape[:2] != (REP_CHUNKS, REPLICAS) or not np.isfinite(v).all():
            raise AssertionError(f"replica observable {k}: shape {v.shape} "
                                 "or non-finite values")
    for k in ("pos", "vel", "spin"):
        if not bool(torch.isfinite(getattr(eng.state, k)).all()):
            raise AssertionError(f"replica state {k} non-finite")
    out = dict(steps_per_s=steps / secs,
               replica_steps_per_s=REPLICAS * steps / secs,
               atom_steps_per_s=REPLICAS * n_atoms * steps / secs,
               seconds=secs, rebuilds=eng.n_rebuilds, launches=expect,
               peak_memory_bytes=peak, kernel_rel_err=errs)

    # K1/K2 per batched launch beside R flat launches, in turns
    c = eng._carry
    nbh, spin, types = c.nbh, c.states.spin, eng._types0
    sj = spin[:, nbh.idx.long()]
    e, hdir, abar = kern.nep_atom_pass(spec, params, nbh.dr, nbh.mask, types,
                                       nbh.tj, spin, sj)
    def rows(x, r):          # the batch, or replica r's rows
        return x if r is None else x[r]

    def k1(r=None):
        return kern.nep_atom_pass(spec, params, rows(nbh.dr, r), nbh.mask,
                                  types, nbh.tj, rows(spin, r), rows(sj, r))

    def k2(r=None):
        return kern.nep_force_pass(spec, params, rows(nbh.dr, r), nbh.mask,
                                   nbh.idx, types, nbh.tj, rows(spin, r),
                                   rows(sj, r), rows(abar, r))

    times = {}
    for name, fn in (("nep_atom_pass", k1), ("nep_force_pass", k2)):
        t = {"batched": [], "flat": []}
        for how in ("batched", "flat", "flat", "batched"):
            t[how].append(time_ms(torch, fn if how == "batched" else (
                lambda: [fn(r) for r in range(REPLICAS)]), 10))
        times[name] = {"batched_ms": sum(t["batched"]) / 2,
                       "flat_ms": sum(t["flat"]) / 2}
    log(f"  K1/K2 at R={REPLICAS}: one batched launch vs {REPLICAS} flat "
        f"launches (ms): {times}")
    out["kernel_ms"] = times
    out["blocks_bytes"] = {"dr": nbytes(nbh.dr), "sj": nbytes(sj),
                           "abar": nbytes(abar),
                           "table": nbytes(nbh.idx, nbh.mask, nbh.tj)}
    del c, nbh, spin, sj, e, hdir, abar, k1, k2

    # (c) one chunk of the batch bitwise 4 flat Engines with its table
    rep = replica_engine(torch, dev, spec, params, lat, moments, states())
    table0 = rep.table           # the shared table before the chunk
    rep.run(REP_FLAT_STEPS, spawn_generators(62, REPLICAS, dev),
            chunk=REP_FLAT_STEPS)
    gens = spawn_generators(62, REPLICAS, dev)
    st0 = states()
    flats = []
    for r in range(REPLICAS):
        flat = replica_engine(torch, dev, spec, params, lat, moments,
                              unstack_state(st0, r),
                              plan=SingleDevice(cell_order=False),
                              table=table0)
        flat.run(REP_FLAT_STEPS, gens[r], chunk=REP_FLAT_STEPS)
        if flat.n_rebuilds or rep.n_rebuilds:
            raise AssertionError("(c) needs a chunk without rebuilds: "
                                 f"{flat.n_rebuilds}, {rep.n_rebuilds}")
        for k in ("pos", "vel", "spin"):
            if not torch.equal(getattr(flat.state, k),
                               getattr(rep.state, k)[r]):
                raise AssertionError(f"(c) replica {r}'s {k} is not the "
                                     "flat Engine's")
        if flat.energy != float(rep.energy[r]):
            raise AssertionError(f"(c) replica {r}'s energy differs")
        flats.append(flat.energy)
        del flat
    log(f"  (c) a {REP_FLAT_STEPS}-step chunk of the batch is bitwise "
        f"{REPLICAS} flat Engines on its table (energies {flats})")
    del rep

    # (d) checkpoints every chunk leave the run as it was; a resume from
    # the chunk-1 checkpoint is bitwise the uninterrupted run
    ckpt = SURFACE_DIR / "replica_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    again = replica_engine(torch, dev, spec, params, lat, moments, states())
    again.ckpt_pin = REP_CHUNK
    again.run(steps, spawn_generators(61, REPLICAS, dev), chunk=REP_CHUNK,
              checkpoint_dir=str(ckpt), checkpoint_keep=2)
    same_replicas(torch, eng, again, "checkpointed run")
    fresh = replica_engine(torch, dev, spec, params, lat, moments, states())
    gens = fresh.restore(str(ckpt), step=REP_CHUNK)
    fresh.run(steps - REP_CHUNK, gens, chunk=REP_CHUNK)
    same_replicas(torch, eng, fresh, "replica resume")
    if (fresh.n_rebuilds != eng.n_rebuilds or not np.array_equal(
            fresh.trace.values["energy"], eng.trace.values["energy"][1:])):
        raise AssertionError("replica resume: rebuilds or trace differ")
    log(f"  (d) the resumed run is bitwise the uninterrupted one (rebuilds "
        f"{fresh.n_rebuilds}, trace rows)")
    del again, fresh, eng

    # (e) per-slot mode, frozen lattice: a job seated in slot 2 between
    # chunks leaves slots 0, 1 and 3 bitwise as they were
    frozen = IntegratorConfig(dt=run.dt, spin_alpha=run.spin_alpha,
                              frozen_lattice=True)
    runs = []
    for write in (False, True):
        e_ = replica_engine(torch, dev, spec, params, lat, moments, states(),
                            cfg=frozen, per_slot=True)
        gens = spawn_generators(63, REPLICAS, dev)
        e_.run(REP_CHUNK, gens, chunk=REP_CHUNK)
        if write:
            job = init_state(lat, run.unit_cells, generator=torch.Generator(
                device=dev).manual_seed(64), temperature=FC_T["t_hot"],
                dtype=dtype, device=dev)
            e_.write_slots([2], stack_states([job]))
            gens[2] = torch.Generator(device=dev).manual_seed(65)
        e_.run(REP_CHUNK, gens, chunk=REP_CHUNK)
        runs.append(e_)
    same_replicas(torch, runs[0], runs[1], "per-slot write_slots",
                  slots=(0, 1, 3))
    h = runs[1].trace.health
    log(f"  (e) per-slot: slots 0, 1, 3 bitwise unchanged by write_slots "
        f"into slot 2; clocks {runs[1].state.step.tolist()}; slot health "
        f"{ {k: h[k][-1].tolist() for k in ('slot_nonfinite', 'slot_e_drift', 'slot_spin_dev')} }")
    del runs, e_
    torch.cuda.empty_cache()
    return out


def phase_ensemble(torch, dev) -> dict:
    """Phase F: the ensemble layer at the reference's sizes."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.fege_spinlattice import (
        nucleation_ensemble, nucleation_ensemble_smoke)
    from repro_torch.ensemble import protocol
    from repro_torch.ensemble.replica import (ReplicaEnsemble, replicate,
                                              spawn_generators)
    from repro_torch.ensemble.sweep import run_sweep
    from repro_torch.launch import ensemble_rate, skyrmion_nucleation
    from repro_torch.launch.sweep import build_film
    from repro_torch.md.integrator import IntegratorConfig
    ecfg = dataclasses.replace(nucleation_ensemble(),
                               n_steps=NUCLEATION_STEPS)
    log(f"phase F: the ensemble layer: {ecfg.name} ({ecfg.n_replicas} x "
        f"{ecfg.n_cells} film, {ecfg.n_steps} steps, Heisenberg-DMI), "
        "parallel tempering, run_sweep, ensemble_rate")
    out = {}
    t0 = time.perf_counter()
    q_th = skyrmion_nucleation.run(True, ecfg.n_steps, ecfg.n_replicas,
                                   ecfg.b_field, device=dev, log=lambda *a:
                                   None)
    t1 = time.perf_counter()
    q_cold = skyrmion_nucleation.run(False, ecfg.n_steps, 1, ecfg.b_field,
                                     device=dev, log=lambda *a: None)
    t2 = time.perf_counter()
    chunks = ecfg.n_steps // ecfg.chunk
    if q_th.shape != (chunks, ecfg.n_replicas) or q_cold.shape != (
            chunks, 1) or not (np.isfinite(q_th).all()
                               and np.isfinite(q_cold).all()):
        raise AssertionError(f"nucleation: charges {q_th.shape}, "
                             f"{q_cold.shape} or non-finite")
    out["nucleation"] = dict(
        skyrmion_nucleation.summarize(q_th, q_cold), thermal_s=t1 - t0,
        cold_s=t2 - t1, n_atoms=int(np.prod(ecfg.n_cells)),
        thermal_replica_steps_per_s=ecfg.n_replicas * ecfg.n_steps
        / (t1 - t0), cold_steps_per_s=ecfg.n_steps / (t2 - t1))
    log(f"  nucleation: {out['nucleation']}")

    # tempering on the nucleation ensemble's film (32x32x1), a 4-rung
    # ladder over its protocol's range, a swap attempt every chunk
    lat, ham, st = build_film(ecfg, 0, dev)
    ens = ReplicaEnsemble(
        potential=ham, cfg=IntegratorConfig(
            dt=ecfg.dt, lattice_gamma=ecfg.lattice_gamma,
            spin_alpha=ecfg.spin_alpha),
        states=replicate(st, 4),
        masses=torch.tensor(lat.masses, dtype=torch.float32, device=dev),
        magnetic=torch.tensor(lat.moments, device=dev) > 0, cutoff=5.0,
        capacity=8, diag_grid=(32, 32), device=dev)
    t0 = time.perf_counter()
    tr = ens.run(TEMPERING_CHUNKS * 10, spawn_generators(70, 4, dev),
                 temperature=protocol.temperature_ladder(
                     ecfg.t_cold, ecfg.t_hot, 4),
                 chunk=10, exchange_every=1,
                 exchange_generator=torch.Generator().manual_seed(71))
    # parity alternates: 2 pairs, then 1, per chunk
    attempts = 3 * TEMPERING_CHUNKS // 2
    if (tr.exchange_attempts != attempts
            or not 0 < tr.exchange_accepts <= attempts):
        raise AssertionError(f"parallel tempering: {tr.exchange_accepts} of "
                             f"{tr.exchange_attempts} swaps accepted")
    out["tempering"] = {"accepts": tr.exchange_accepts,
                        "attempts": tr.exchange_attempts,
                        "n_atoms": int(st.pos.shape[0]),
                        "seconds": time.perf_counter() - t0}
    log(f"  parallel tempering (4 x {ecfg.n_cells} films, ladder "
        f"{ecfg.t_cold:g}-{ecfg.t_hot:g} K, {TEMPERING_CHUNKS} chunks of 10 "
        f"steps): {tr.exchange_accepts} of {tr.exchange_attempts} swaps "
        "accepted")

    scfg = nucleation_ensemble_smoke()
    lat, ham, st = build_film(scfg, 0, dev)
    t0 = time.perf_counter()
    pd = run_sweep(
        st, ham, IntegratorConfig(dt=scfg.dt,
                                  lattice_gamma=scfg.lattice_gamma,
                                  spin_alpha=scfg.spin_alpha),
        torch.tensor(lat.masses, dtype=torch.float32, device=dev),
        torch.tensor(lat.moments, device=dev) > 0,
        scfg.sweep_temperatures, scfg.sweep_fields,
        n_replicas=scfg.n_replicas, n_steps=SWEEP_STEPS, seed=72,
        cutoff=5.0, capacity=8, chunk=scfg.chunk, device=dev)
    grid = (len(scfg.sweep_temperatures), len(scfg.sweep_fields))
    for k in ("charge", "charge_abs", "charge_std", "magnetization", "pitch",
              "energy"):
        v = getattr(pd, k)
        if v.shape != grid or not np.isfinite(v).all():
            raise AssertionError(f"run_sweep: {k} {v.shape} not filled")
    out["sweep"] = {"seconds": time.perf_counter() - t0,
                    "charge_abs": pd.charge_abs.tolist(),
                    "magnetization": pd.magnetization.tolist()}
    log(f"  run_sweep {grid} x {scfg.n_replicas} replicas: "
        f"{out['sweep']}")
    out["rate"] = ensemble_rate.measure(dev)
    log(f"  ensemble_rate (16x16x1, chunk 50): {out['rate']}")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the seventh slice: training and the fitted potential, supervised recovery
# ---------------------------------------------------------------------------

FIT_STEPS = 150            # train_md's --fit-steps
SNES_GENERATIONS = 20      # of fit_snes's 100 (cut for the time limit)
TRAIN_MD = dict(cells=32, steps=100)   # 262,144 atoms, 4 chunks of 25
RES_CHUNKS, RES_CHUNK, RES_FAULT_STEP = 4, 20, 45


def phase_training(torch, dev, kern, ref, random_weight_k) -> dict:
    """Phase G: the accuracy table, SNES, the loss and its gradient on the
    card against the CPU at f64, train_md at 262,144 atoms through K1/K2,
    and both kernels in both bodies on that run's own inputs.
    ``random_weight_k`` is phase 3's final temperature (random weights),
    printed beside the fitted potential's."""
    from repro_torch.core.potential import NEPSpinParams, compute
    from repro_torch.core.training import Dataset, fit_snes, loss_and_grad
    from repro_torch.kernels.nep.ops import nep_compute
    from repro_torch.launch import accuracy, train
    log("phase G: training (launch/accuracy.py: B20 2x2x2, 24 + 8 "
        f"configurations, Adam {FIT_STEPS} steps; SNES "
        f"{SNES_GENERATIONS} generations), then train_md at "
        f"{TRAIN_MD['cells']}^3 cells through K1/K2")
    acc = accuracy.main(["--device", str(dev), "--steps", str(FIT_STEPS)])
    table = {k: {m: acc[k][m] for m in ("e_rmse_per_atom", "f_rmse",
                                         "h_rmse", "fit_s")}
             for k in ("nepspin", "nep-nospin", "classical-fit")}
    nep, tr, val = acc["nepspin"], acc["train"], acc["val"]
    spec, params, hist = nep["spec"], nep["params"], nep["loss"]
    f_scale = float(torch.sqrt(torch.mean(val.f_ref ** 2)))
    h_scale = float(torch.sqrt(torch.mean(val.h_ref ** 2)))
    gates = {"loss_ratio": hist[-1] / hist[0],
             "f_over_scale": nep["f_rmse"] / f_scale,
             "h_over_scale": nep["h_rmse"] / h_scale}
    log(f"  nepspin loss {hist[0]:.4f} -> {hist[-1]:.4f}; validation F "
        f"{nep['f_rmse']:.4f} of scale {f_scale:.4f}, H {nep['h_rmse']:.4f} "
        f"of {h_scale:.4f}; gates {gates}")
    if not (gates["loss_ratio"] < 0.25 and gates["f_over_scale"] < 0.35
            and gates["h_over_scale"] < 0.35):
        raise AssertionError(f"fit bars (loss < 0.25 x first, F and H RMSE "
                             f"< 0.35 x scale) not met: {gates}")
    adam_ms = 1e3 * nep["fit_s"] / FIT_STEPS

    # SNES at a reduced number of generations
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, snes_hist = fit_snes(spec, tr, torch.Generator(device=dev)
                            .manual_seed(5), generations=SNES_GENERATIONS)
    snes_ms = 1e3 * (time.perf_counter() - t0) / SNES_GENERATIONS
    log(f"  SNES {SNES_GENERATIONS} generations: best {snes_hist[0]:.4f} -> "
        f"{snes_hist[-1]:.4f}, {snes_ms:.1f} ms a generation (a loop over "
        "32 members)")

    # the loss and its gradient, card against CPU, f64
    p64 = NEPSpinParams(*(p.detach().double() for p in params))
    ds64 = Dataset(*(t.double() if t.is_floating_point() else t for t in tr))
    l_gpu, g_gpu = loss_and_grad(spec, p64, ds64)
    cpu = torch.device("cpu")
    l_cpu, g_cpu = loss_and_grad(
        spec, NEPSpinParams(*(p.to(cpu) for p in p64)),
        Dataset(*(t.to(cpu) for t in ds64)))
    grad_err = max(rel_err(a.cpu(), b) for a, b in zip(g_gpu, g_cpu))
    loss_err = abs(float(l_gpu) - float(l_cpu)) / abs(float(l_cpu))
    log(f"  loss and gradient at f64, card vs CPU: loss rel {loss_err:.3e}, "
        f"gradient rel {grad_err:.3e} (bar 1e-9)")
    if not (loss_err < 1e-9 and grad_err < 1e-9):
        raise AssertionError(f"f64 loss {loss_err:.3e} / gradient "
                             f"{grad_err:.3e} off the CPU's")

    # train_md: fit, then MD with the fitted weights through K1/K2
    args = train.parse_args(["--arch", "fege-spinlattice", "--cells",
                             str(TRAIN_MD["cells"]), "--steps",
                             str(TRAIN_MD["steps"]), "--fit-steps",
                             str(FIT_STEPS), "--use-kernel", "--device",
                             str(dev)])
    keep = {}
    reset_md_counters(kern)
    md = train.train_md(args, keep=keep)
    counts = read_md_counters(kern)
    sim = keep["sim"]
    expect = 1 + md["steps"] + md["rebuilds"]
    bodies = {"nep_atom_pass": kern.atom_pass_body(md["spec"]),
              "nep_force_pass": kern.force_pass_body(md["spec"])}
    for name, (n, by_body) in counts.items():
        want = {b: (expect if b == bodies[name] else 0) for b in kern.BODIES}
        if n != expect or by_body != want:
            raise AssertionError(f"train_md {name}: launches {n} by body "
                                 f"{by_body}, expected {want}")
    st = sim.state
    for k in ("pos", "vel", "spin"):
        if not bool(torch.isfinite(getattr(st, k)).all()):
            raise AssertionError(f"train_md: non-finite {k}")
    fe = st.types == 0
    smag = torch.linalg.norm(st.spin[fe], dim=-1)
    smin, smax = float(smag.min()), float(smag.max())
    vals = [md["pitch"]] + md["chunk_temperatures"] + [
        r["charge"] for r in md["rows"]] + [r["energy"] for r in md["rows"]]
    if not (all(math.isfinite(v) for v in vals) and 0.3 < smin
            and smax < 2.0):
        raise AssertionError(f"train_md: values {vals}, Fe |S| in "
                             f"[{smin}, {smax}]")
    log(f"  train_md: {md['n_atoms']} atoms, {md['steps']} steps "
        f"{md['steps_per_s']:.3f} steps/s, rebuilds {md['rebuilds']}, "
        f"launches {counts}; T after each chunk "
        f"{[round(t, 1) for t in md['chunk_temperatures']]} K (random "
        f"weights, phase 3: {random_weight_k:.1f} K); Q {[r['charge'] for r in md['rows']]}"
        f"; pitch {md['pitch']:.2f} A; Fe |S| in [{smin:.3f}, {smax:.3f}]")

    # the kernel path against the autograd evaluation, fitted weights
    c = sim._engine._carry
    field = torch.tensor([0.0, 0.0, args.field], dtype=st.pos.dtype,
                         device=dev)
    mom = sim.potential.moments
    ek = nep_compute(md["spec"], sim.potential.params, c.nbh, c.state.spin,
                     c.state.types, field, mom)
    ea = compute(md["spec"], sim.potential.params, c.nbh, c.state.spin,
                 c.state.types, field, mom)
    path_err = max(check(f"train_md nep_compute {n} vs autograd", a, b,
                         1e-4) for n, a, b in zip("EFH", ek, ea))
    del ek, ea
    # K1 and K2 in both bodies on the run's own inputs, and their times
    errs = md_loop_kernels(torch, kern, ref, sim)
    sj = c.state.spin[c.nbh.idx.long()]
    blocks = (c.nbh.dr, c.nbh.mask, c.state.types, c.nbh.tj, c.state.spin,
              sj)
    p = sim.potential.params
    a1 = kern.nep_atom_pass(md["spec"], p, *blocks)
    k2 = (md["spec"], p, c.nbh.dr, c.nbh.mask, c.nbh.idx, c.state.types,
          c.nbh.tj, c.state.spin, sj, a1[2])
    ms = {"nep_atom_pass": {}, "nep_force_pass": {}}
    for body in ("warp", "thread", "thread", "warp"):
        ms["nep_atom_pass"].setdefault(body, []).append(time_ms(
            torch, lambda: kern.nep_atom_pass(md["spec"], p, *blocks,
                                              body=body), 10))
        ms["nep_force_pass"].setdefault(body, []).append(time_ms(
            torch, lambda: kern.nep_force_pass(*k2, body=body), 10))
    ms = {k: {b: sum(v) / len(v) for b, v in t.items()}
          for k, t in ms.items()}
    log(f"  K1/K2 at the fitted spec, {md['n_atoms']} atoms, by body (ms): "
        f"{ms}")
    from repro_torch.launch import roofline
    fitted = roofline.nep_report(md["spec"], p, c.nbh, c.state.spin,
                                 c.state.types)
    out = {"accuracy": table, "gates": gates, "loss_first": hist[0],
           "loss_last": hist[-1], "adam_ms_per_step": adam_ms,
           "snes_ms_per_generation": snes_ms, "snes_best": snes_hist,
           "f64_loss_rel_err": loss_err, "f64_grad_rel_err": grad_err,
           "train_md": {k: md[k] for k in (
               "fit", "loss_first", "loss_last", "fit_s", "n_atoms", "steps", "steps_per_s", "md_s",
               "chunk_temperatures", "rows", "pitch", "rebuilds")},
           "fe_spin_norm": [smin, smax], "launches": counts,
           "bodies": bodies, "kernel_path_vs_autograd": path_err,
           "kernel_rel_err": errs, "kernel_ms": ms,
           "random_weight_k": random_weight_k, "roofline": fitted}
    del sim, keep, c, blocks, a1, k2
    torch.cuda.empty_cache()
    return out


def supervised_fc(torch, dev, spec, lat, moments, kern, fault, sub,
                  config=None, seed=0):
    """A supervised field-cooling run (phase A's engine) with one fault
    plan; returns (engine, supervisor, injector, wall s, rollback s)."""
    from repro_torch.resilience import (FaultPlan, Supervisor,
                                        SupervisorConfig, install_faults)
    from repro_torch.telemetry import HealthConfig, Telemetry
    _, eng = fc_engine(torch, dev, spec, lat, moments, kern)
    log_path = sub / "run.jsonl"
    inj = install_faults(eng, FaultPlan(faults=(fault,), seed=seed),
                         runlog=log_path)
    restore, spent = eng.restore, []

    def timed_restore(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = restore(*a, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    eng.restore = timed_restore
    sup = Supervisor(config or SupervisorConfig(max_retries=2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sup.run(eng, RES_CHUNKS * RES_CHUNK,
            torch.Generator(device=dev).manual_seed(23), chunk=RES_CHUNK,
            checkpoint_dir=str(sub / "ckpt"),
            telemetry=Telemetry(runlog=log_path,
                                health=HealthConfig(max_spin_dev=1e-3)))
    torch.cuda.synchronize()
    return eng, sup, inj, time.perf_counter() - t0, spent


def phase_resilience(torch, dev, spec, lat, moments, kern) -> dict:
    """Phase H: supervised recovery on phase A's 262,144-atom field-cooling
    Engine (K1/K2): NaN and bit-flip faults recovered bitwise with 0 builds
    after the rollback, the dt ladder, rebind on the Replicated plan, and
    launch/resilience_smoke.py on the card."""
    import shutil

    import numpy as np

    from repro_torch.ensemble.replica import spawn_generators
    from repro_torch.launch import resilience_smoke
    from repro_torch.launch.report import runlog_report
    from repro_torch.resilience import Fault, SupervisorConfig
    from repro_torch.telemetry import read_runlog
    root = SURFACE_DIR / "resilience"
    shutil.rmtree(root, ignore_errors=True)
    steps = RES_CHUNKS * RES_CHUNK
    log(f"phase H: supervised recovery on phase A's engine, {RES_CHUNKS} x "
        f"{RES_CHUNK} steps, a checkpoint every chunk, faults at step "
        f"{RES_FAULT_STEP}")
    # the uninterrupted run; the carry's row types at the faulted chunk's
    # start (the same rows in the supervised runs, bitwise the same up to
    # there)
    _, clean = fc_engine(torch, dev, spec, lat, moments, kern)
    hot_types = []

    def at_fault_chunk(e):
        if e._step_now() == RES_FAULT_STEP // RES_CHUNK * RES_CHUNK:
            hot_types.append(e._carry.state.types.cpu().numpy())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clean.run(steps, torch.Generator(device=dev).manual_seed(23),
              chunk=RES_CHUNK, callback=at_fault_chunk)
    torch.cuda.synchronize()
    clean_s = time.perf_counter() - t0
    out = {"clean_s": clean_s}
    # the bit flip hits one spin component of the row the plan's seed
    # picks: an Fe spin's flip blows up, a Ge spin's (0 -> 2.0) is caught
    # only because the spin-norm signal holds non-magnetic spins at 0.
    # The plan's own seed 0, then the first seed whose row is of the other
    # type, so both cases run whatever seed 0 picks.
    rows = np.arange(hot_types[0].size)

    def flip_row_type(seed):
        row = np.random.default_rng(np.random.SeedSequence([seed, 0])) \
            .choice(rows, size=1, replace=False)[0]
        return "Fe" if hot_types[0][row] == 0 else "Ge"

    other_seed = next(s for s in range(1, 64)
                      if flip_row_type(s) != flip_row_type(0))
    flip = Fault(kind="bit_flip", step=RES_FAULT_STEP, leaf="spin", bit=30)
    for tag, fault, seed in (
            ("nan", Fault(kind="nan", step=RES_FAULT_STEP, leaf="force"), 0),
            ("bit_flip", flip, 0),
            ("bit_flip_other_row", flip, other_seed)):
        reset_md_counters(kern)
        eng, sup, inj, wall, spent = supervised_fc(
            torch, dev, spec, lat, moments, kern, fault, root / tag,
            seed=seed)
        events = [e["event"] for e in sup.events]
        if events != ["rollback", "retry", "recovered"]:
            raise AssertionError(f"{tag}: supervisor events {events}")
        for k in ("pos", "vel", "spin"):
            if not torch.equal(getattr(clean.state, k),
                               getattr(eng.state, k)):
                raise AssertionError(f"{tag}: recovered {k} is not the "
                                     "uninterrupted run's")
        records = read_runlog(root / tag / "run.jsonl")
        kinds = [r["event"] for r in records]
        for ev in ("fault_injected", "rollback", "retry", "recovered"):
            if ev not in kinds:
                raise AssertionError(f"{tag}: runlog lacks {ev}: {kinds}")
        first_rb = kinds.index("rollback")
        after = [r["compiles"] for r in records[first_rb:]
                 if r["event"] == "chunk"]
        if not after or any(after):
            raise AssertionError(f"{tag}: builds after the rollback {after}")
        text = runlog_report(root / tag / "run.jsonl")
        lines = [ln.strip() for ln in text.splitlines()]
        for token in (f"fault_injected: {fault.kind} at step "
                      f"{RES_FAULT_STEP}", "rollback #1", "retry #1",
                      "recovered after 1"):
            if not any(ln.startswith(token) for ln in lines):
                raise AssertionError(f"{tag}: report lacks {token!r}:\n"
                                     f"{text}")
        rb = next(e for e in sup.events if e["event"] == "rollback")
        row = flip_row_type(seed) if fault.kind == "bit_flip" else None
        log(f"  {tag} (seed {seed}{f', {row} row' if row else ''}): "
            f"{events}, kind {rb['kind']} at step {rb['step']}, "
            f"bitwise the uninterrupted run; builds after the rollback "
            f"{after}; supervised {wall:.3f} s vs clean {clean_s:.3f} s, "
            f"rollback (restore) {spent[0]:.3f} s; launches "
            f"{read_md_counters(kern)}")
        out[tag] = {"events": events, "kind": rb["kind"], "seed": seed,
                    "row": row,
                    "supervised_s": wall, "rollback_s": spent[0],
                    "builds_after_rollback": after,
                    "report": [ln for ln in lines if ln.startswith((
                        "fault_injected", "rollback", "retry",
                        "recovered"))]}
        if tag == "nan":
            log("  runlog report:\n" + text)
        del eng
    # the dt ladder: a persistent fault that a smaller step fixes
    eng, sup, inj, wall, spent = supervised_fc(
        torch, dev, spec, lat, moments, kern,
        Fault(kind="nan", step=RES_FAULT_STEP, leaf="spin", once=False,
              while_dt_ge=clean.cfg.dt), root / "ladder",
        SupervisorConfig(max_retries=4, degrade_after=2))
    events = [e["event"] for e in sup.events]
    degrade = next((e for e in sup.events if e["event"] == "degrade"), {})
    if (events != ["rollback", "retry", "rollback", "degrade",
                   "degrade_restore", "retry", "recovered"]
            or degrade.get("action") != "dt"
            or degrade.get("dt") != clean.cfg.dt * 0.5
            or eng.cfg.dt != clean.cfg.dt or eng._step_now() != steps
            or len(inj.fired) != 2
            or not bool(torch.isfinite(eng.state.spin).all())):
        raise AssertionError(f"dt ladder: events {events}, degrade "
                             f"{degrade}, dt {eng.cfg.dt}, step "
                             f"{eng._step_now()}, fired {len(inj.fired)}")
    log(f"  dt ladder: {events}; dt {degrade['prev_dt']} -> {degrade['dt']} "
        f"for {degrade['span_steps']} steps, then back; {wall:.3f} s")
    out["dt_ladder"] = {"events": events, "span_steps":
                        degrade["span_steps"], "seconds": wall}
    del eng, clean
    torch.cuda.empty_cache()

    # rebind on the Replicated plan at phase E's size, one chunk each side
    from repro_torch.configs.fege_spinlattice import main_path
    from repro_torch.core.potential import init_params
    run = main_path()
    dtype = getattr(torch, run.dtype)
    params = init_params(spec, torch.Generator(device=dev).manual_seed(43),
                         dtype=dtype, device=dev)
    reng = replica_engine(torch, dev, spec, params, lat, moments,
                          replica_states(torch, dev, lat, run.unit_cells,
                                         dtype, 60, FC_T["t_hot"]))
    gens = spawn_generators(61, REPLICAS, dev)
    reng.run(RES_CHUNK, gens, chunk=RES_CHUNK)
    before = {k: getattr(reng.state, k).clone() for k in ("pos", "vel",
                                                          "spin")}
    step0, dt0 = reng._step_now(), reng.cfg.dt
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reng.rebind(cfg=dataclasses.replace(reng.cfg, dt=0.5 * dt0))
    torch.cuda.synchronize()
    rebind_s = time.perf_counter() - t0
    for k, v in before.items():
        if not torch.equal(getattr(reng.state, k), v):
            raise AssertionError(f"replica rebind changed {k}")
    reng.run(RES_CHUNK, gens, chunk=RES_CHUNK)
    if (reng._step_now() != step0 + RES_CHUNK or reng.cfg.dt != 0.5 * dt0
            or not bool(torch.isfinite(reng.state.pos).all())):
        raise AssertionError("replica run after rebind")
    log(f"  Replicated({REPLICAS}) x {run.n_atoms} atoms: rebind to dt "
        f"{0.5 * dt0} in {rebind_s:.3f} s (state bitwise kept, table and "
        f"forces rebuilt), then {RES_CHUNK} steps to step "
        f"{reng._step_now()}")
    out["replica_rebind_s"] = rebind_s
    del reng, before
    torch.cuda.empty_cache()

    # launch/resilience_smoke.py on the card: supervised retry and the
    # SIGKILL child with a bitwise resume
    smoke = resilience_smoke.main(["--device", str(dev)])
    out["resilience_smoke"] = {
        "events": smoke["supervised"]["events"],
        "retry_compiles": smoke["supervised"]["retry_compiles"],
        "latest_checkpoint": smoke["kill_resume"]["latest"],
        "child_rc": smoke["kill_resume"]["child_rc"]}
    return out



# ---------------------------------------------------------------------------
# phase I: the batched simulation job server
# ---------------------------------------------------------------------------

SERVE_SLOTS, SERVE_CHUNK, SERVE_OBS_EVERY = 4, 20, 10
SERVE_JOBS = 6                                # per bucket
SERVE_LARGE_SOLO = 2                          # large-bucket jobs run solo
# the rows of every slot held against the plain versions, by bucket size
# (all 262,144 at R = 4 would take the plain versions ~20 s a dtype);
# other buckets whole
SERVE_KERNEL_ROWS = {262144: 8192}
# the timed drains, each on a fresh server after phase I's first drain:
# two pairs of journal off / on in alternating order
SERVE_TIMED = ("off", "on", "on", "off")


def serve_fleet(torch, dev, spec):
    """The card-scale fleet (cell fege-serve-1card): NEP-SPIN at the
    production spec, random weights from a seed, K1/K2, f32, frozen
    lattice, budgets 40/60/80 and four protocols per bucket."""
    from repro_torch.launch.serve import (NEP_CELLS, NEP_SEED,
                                          build_nep_fleet, nep_potential)
    return build_nep_fleet(nep_potential(spec, NEP_SEED, device=dev),
                           NEP_CELLS, SERVE_JOBS, SERVE_OBS_EVERY)


def serve_cfg(root, name, **kw):
    from repro_torch.serve import ServeConfig
    return ServeConfig(runlog=str(root / f"{name}.jsonl"),
                       workdir=str(root / name), chunk=SERVE_CHUNK, **kw)


def drain_fleet(torch, cfg, jobs):
    """(server, handles, wall s of submit + drain)."""
    from repro_torch.serve import SimServer
    srv = SimServer(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hs = [srv.submit(j) for j in jobs]
    srv.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for h in hs:
        if h.status != "done":
            raise AssertionError(f"{h.job.name}: {h.status} ({h.error})")
    return srv, hs, wall


def busy_segments(runlog, atoms_of, into) -> None:
    """Add the drain's segments in which every slot held a job (the
    fleet's tail excluded) to ``into``, by bucket size: their count,
    slot-steps and wall (each segment's own: the chunk, the supervisor's
    checkpoints and the backfill's evaluation)."""
    from repro_torch.telemetry import read_runlog
    for rec in read_runlog(runlog):
        if rec["event"] == "serve_chunk" and not rec["idle"]:
            v = into.setdefault(atoms_of[rec["bucket"]], {
                "segments": 0, "slot_steps": 0, "wall_s": 0.0})
            v["segments"] += 1
            v["slot_steps"] += len(rec["slots"]) * rec["steps"]
            v["wall_s"] += rec["wall_s"]


def serve_kernels(torch, kern, ref, engine, rows=None) -> dict:
    """Phase I (b): K1 and K2 (warp body) on a bucket's own inputs after
    the packed drain - its shared blocks, the (slots, N, 3) spins and
    their ``sj`` - against the plain versions at f32 (1e-4) and, on the
    same inputs cast, f64 (1e-9); with ``rows``, the plain versions on
    the first ``rows`` atoms of every slot (K2's on K1's whole ``abar``,
    which both sides read through ``idx``)."""
    from repro_torch.core.potential import NEPSpinParams
    c, spec, types = engine._carry, engine.potential.spec, engine._types0
    nbh = c.nbh
    n = rows or types.shape[0]
    errs = {"nep_atom_pass": {}, "nep_force_pass": {}}
    for dtype, bar, tag in ((torch.float32, 1e-4, "f32"),
                            (torch.float64, 1e-9, "f64")):
        params = NEPSpinParams(*(p.to(dtype)
                                 for p in engine.potential.params))
        dr, spin = nbh.dr.to(dtype), c.states.spin.to(dtype)
        sj = spin[:, nbh.idx.long()]
        got1 = kern.nep_atom_pass(spec, params, dr, nbh.mask, types,
                                  nbh.tj, spin, sj, body="warp")
        got2 = kern.nep_force_pass(spec, params, dr, nbh.mask, nbh.idx,
                                   types, nbh.tj, spin, sj, got1[2],
                                   body="warp")
        torch.cuda.synchronize()
        head = (dr[:, :n], nbh.mask[:n])
        want1 = ref.atom_pass_plain(spec, params, *head, types[:n],
                                    nbh.tj[:n], spin[:, :n], sj[:, :n])
        want2 = ref.force_pass_plain(spec, params, *head, nbh.idx[:n],
                                     types[:n], nbh.tj[:n], spin[:, :n],
                                     sj[:, :n], got1[2])
        what = f"serving {types.shape[0]}" + (f"[:{n}]" if rows else "")
        errs["nep_atom_pass"][tag] = max(
            check(f"K1 {what} {o} {tag}", a[:, :n], b, bar)
            for o, a, b in zip(("e", "hdir", "abar"), got1, want1))
        errs["nep_force_pass"][tag] = max(
            check(f"K2 {what} {o} {tag}", a[:, :n], b, bar)
            for o, a, b in zip(("F", "h2"), got2, want2))
        del dr, spin, sj, got1, got2, want1, want2
    return errs


def phase_serve(torch, dev, spec, kern, ref) -> dict:
    """Phase I: the job server (launch/serve.py's fleet at f64, packed vs
    solo bitwise), the card-scale NEP-SPIN fleet through K1/K2 (launch
    counts per bucket, K1/K2 against their plain versions on each
    bucket's inputs, packed vs solo bitwise, jobs/s and busy slot-steps/s
    over warm drains, journal overhead over alternating pairs, recovery),
    eviction of a poisoned job, and the chaos smoke."""
    import collections
    import gc
    import shutil

    import numpy as np

    from repro_torch import _build
    from repro_torch.launch import serve_chaos_smoke, serve_smoke
    from repro_torch.launch.serve import NEP_CELLS
    from repro_torch.launch.serve_smoke import same_job
    from repro_torch.md.engine import Engine
    from repro_torch.ensemble import protocol
    from repro_torch.serve import SimServer
    from repro_torch.telemetry import read_runlog
    root = SURFACE_DIR / "serve"
    shutil.rmtree(root, ignore_errors=True)
    out = {}
    t_phase = time.perf_counter()

    def release(srv_dir):
        shutil.rmtree(root / srv_dir, ignore_errors=True)
        gc.collect()     # an engine and its packer's hook form a cycle
        torch.cuda.empty_cache()

    # (a) the CLI fleet: Heisenberg-DMI, f64, packed 2 slots vs solo
    t0 = time.perf_counter()
    out["cli_fleet"] = serve_smoke.main(["--device", str(dev)])
    out["cli_fleet"]["seconds"] = time.perf_counter() - t0
    log(f"phase I (a): launch/serve.py's fleet at f64, packed vs solo "
        f"bitwise, 0 steady builds, accounting closes "
        f"({out['cli_fleet']['seconds']:.1f} s)")

    # (b) the card-scale fleet.  The first drain counts evaluations (a
    # wrapper around the engine's evaluation) and launches, and leaves
    # each bucket's inputs for the kernel check; it also warms the phase
    # (kernel libraries, allocator), so the timed drains after it do not
    # depend on what ran before phase I
    log(f"phase I (b): NEP-SPIN fleet, {SERVE_JOBS} jobs on each of "
        f"{[8 * a * b * c for a, b, c in NEP_CELLS]} atoms, "
        f"{SERVE_SLOTS} slots, chunk {SERVE_CHUNK}, obs_every "
        f"{SERVE_OBS_EVERY}")
    evals = collections.Counter()
    replica_eval = Engine._replica_eval

    def counted(self, *a):
        evals[int(self.state.pos.shape[1])] += 1
        return replica_eval(self, *a)

    Engine._replica_eval = counted
    try:
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()     # by earlier phases
        reset_md_counters(kern)
        srv, packed, first_wall = drain_fleet(
            torch, serve_cfg(root, "packed", slots=SERVE_SLOTS),
            serve_fleet(torch, dev, spec))
        launches = read_md_counters(kern)
        peak = torch.cuda.max_memory_allocated() - held
    finally:
        Engine._replica_eval = replica_eval
    acct = srv.accounting
    buckets = {}
    for key, rt in srv.buckets.items():
        n = int(rt.engine.state.pos.shape[1])
        expect = 1 + rt.segments * SERVE_CHUNK + rt.backfills
        b = acct.buckets[key.id]
        buckets[n] = {"segments": rt.segments, "backfills": rt.backfills,
                      "evaluations": evals[n], "expect": expect,
                      "warmup_compiles": b["warmup_compiles"],
                      "steady_compiles": b["steady_compiles"],
                      "slot_steps": b["ok_slot_steps"]}
        if evals[n] != expect:
            raise AssertionError(f"bucket of {n} atoms: {evals[n]} "
                                 f"evaluations, expected 1 + steps + "
                                 f"backfills = {expect}")
    total = sum(v["expect"] for v in buckets.values())
    for name, (n, by_body) in launches.items():
        if n != total or by_body != {"warp": total, "thread": 0}:
            raise AssertionError(f"{name}: {n} launches {by_body}, expected "
                                 f"{total} = sum over buckets of 1 + steps "
                                 "+ backfills, all warp")
    n_libs = len(_build.SOURCES)
    for n, v in buckets.items():
        if v["steady_compiles"] or v["warmup_compiles"] > n_libs:
            raise AssertionError(f"bucket of {n} atoms: builds {v}")
    if not acct.consistent():
        raise AssertionError(f"accounting: {acct.summary()}")
    slot_steps = acct.computed_slot_steps
    atom_steps = sum(n * v["slot_steps"] for n, v in buckets.items())
    # K1 and K2 on the serving path's own inputs, each bucket
    t0 = time.perf_counter()
    kernel_err = {}
    for rt in srv.buckets.values():
        n = int(rt.engine.state.pos.shape[1])
        kernel_err[n] = serve_kernels(torch, kern, ref, rt.engine,
                                      rows=SERVE_KERNEL_ROWS.get(n))
    log(f"  K1/K2 on each bucket's inputs vs plain: {kernel_err} "
        f"({time.perf_counter() - t0:.1f} s)")
    # where the drain's time goes, from its runlog: the chunks' own wall
    # (integration and the chunk-end readback) and the segments' (plus the
    # supervisor's checkpoints), per bucket; the rest is the host's
    # seating, harvest and submission
    atoms_of = {k.id: int(rt.engine.state.pos.shape[1])
                for k, rt in srv.buckets.items()}
    bucket_id = None
    for rec in read_runlog(srv.cfg.runlog):
        if rec["event"] == "run_start":
            bucket_id = rec.get("bucket")
        elif rec["event"] == "chunk" and bucket_id is not None:
            v = buckets[atoms_of[bucket_id]]
            v["chunk_wall_s"] = v.get("chunk_wall_s", 0.0) + rec["wall_s"]
        elif rec["event"] == "serve_chunk":
            v = buckets[atoms_of[rec["bucket"]]]
            v["segment_wall_s"] = (v.get("segment_wall_s", 0.0)
                                   + rec["wall_s"])
    for n, v in buckets.items():
        v["ms_per_step"] = 1e3 * v["chunk_wall_s"] / (v["segments"]
                                                      * SERVE_CHUNK)
    log(f"  first drain (counted): {len(packed)} jobs in {first_wall:.3f} "
        f"s, peak {peak / 2**30:.2f} GiB above the phase's start; K1/K2 "
        f"launches {launches}; "
        f"buckets {buckets}; idle slot-steps {acct.idle_steps}")
    del srv
    release("packed")

    # packed vs solo, bitwise: every small-bucket job, two large ones
    fleet = serve_fleet(torch, dev, spec)
    solo_jobs = fleet[:SERVE_JOBS + SERVE_LARGE_SOLO]
    srv, solo, solo_wall = drain_fleet(
        torch, serve_cfg(root, "solo", slots=1), solo_jobs)
    for h, g in zip(packed, solo):
        same_job(h, g, "packed vs solo")
    log(f"  packed vs solo bitwise: {len(solo)} jobs (solo {solo_wall:.3f} "
        "s)")
    del srv
    release("solo")

    # the timed drains, warm and uncounted: journal off and on in
    # alternating pairs, each bitwise the first drain
    walls = {"off": [], "on": []}
    busy = {}
    for i, mode in enumerate(SERVE_TIMED):
        name = f"timed{i}-{mode}"
        kw = ({"journal_dir": str(root / f"{name}-wal")} if mode == "on"
              else {})
        srv, hs, wall = drain_fleet(
            torch, serve_cfg(root, name, slots=SERVE_SLOTS, **kw), fleet)
        for h, g in zip(hs, packed):
            same_job(h, g, f"timed drain {i} (journal {mode})")
        if not srv.accounting.consistent():
            raise AssertionError(f"timed drain {i}: accounting")
        walls[mode].append(wall)
        if mode == "off":
            busy_segments(srv.cfg.runlog, atoms_of, busy)
        del srv, hs
        release(name)
    off = sum(walls["off"]) / len(walls["off"])
    on = sum(walls["on"]) / len(walls["on"])
    pairs = [100.0 * (walls["on"][k] / walls["off"][k] - 1.0)
             for k in range(len(walls["off"]))]
    overhead = 100.0 * (on / off - 1.0)
    # a difference between the pairs larger than the overhead itself
    # leaves its sign unresolved
    resolved = abs(pairs[0] - pairs[1]) <= abs(overhead)
    for n, v in busy.items():
        v["slot_steps_per_s"] = v["slot_steps"] / v["wall_s"]
        v["atom_steps_per_s"] = n * v["slot_steps_per_s"]
    busy_wall = sum(v["wall_s"] for v in busy.values())
    busy_rate = sum(v["slot_steps"] for v in busy.values()) / busy_wall
    busy_atoms = sum(n * v["slot_steps"] for n, v in busy.items()) / busy_wall
    log(f"  timed drains (journal off {walls['off']}, on {walls['on']} s): "
        f"{len(packed) / off:.3f} jobs/s, {slot_steps / off:.1f} "
        f"slot-steps/s, {atom_steps / off:.4e} atom-steps/s; segments "
        f"with every slot busy {busy_rate:.1f} slot-steps/s, "
        f"{busy_atoms:.4e} atom-steps/s (by bucket {busy}); journal "
        f"overhead {overhead:+.2f} % (pairs {pairs[0]:+.2f}, "
        f"{pairs[1]:+.2f} %: {'resolved' if resolved else 'unresolved'})")

    # recovery: abandon a journaled fleet after two ticks, replay the WAL
    # and resubmit; the drain that follows closes the accounting and the
    # resumed jobs' remaining streams are bitwise the uninterrupted ones
    rcfg = serve_cfg(root, "recover", slots=SERVE_SLOTS,
                     journal_dir=str(root / "recover-wal"))
    srv = SimServer(rcfg)
    for j in serve_fleet(torch, dev, spec):
        srv.submit(j)
    srv._tick()
    srv._tick()
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv = SimServer.recover(rcfg)
    handles = [srv.submit(j) for j in serve_fleet(torch, dev, spec)]
    replay_s = time.perf_counter() - t0
    deduped = sum(h.status == "done" for h in handles)
    resumed = [h for h in handles if h.rows_base > 0]
    srv.drain()
    torch.cuda.synchronize()
    racct = srv.accounting
    if (not resumed or not racct.consistent() or racct.recoveries != 1
            or any(b["steady_compiles"] for b in racct.buckets.values())
            or any(h.status != "done" for h in handles)):
        raise AssertionError(f"recovery: resumed {len(resumed)}, "
                             f"{racct.summary()}")
    for h, g in zip(handles, packed):
        if h.rows_base > 0:
            same_job(h, g, "recovered", skip_rows=h.rows_base)
    log(f"  recover after two ticks: replay + resubmit {replay_s:.4f} s; "
        f"{deduped} deduplicated, {len(resumed)} resumed bitwise")
    del srv, handles
    release("recover")
    out["card_fleet"] = {
        "jobs": len(packed), "first_wall_s": first_wall,
        "timed_wall_s": walls, "jobs_per_s": len(packed) / off,
        "slot_steps_per_s": slot_steps / off,
        "atom_steps_per_s": atom_steps / off,
        "busy_segments": busy, "busy_slot_steps_per_s": busy_rate,
        "busy_atom_steps_per_s": busy_atoms,
        "peak_memory_bytes": peak, "buckets": buckets,
        "launches": {k: v[0] for k, v in launches.items()},
        "kernel_rel_err": kernel_err,
        "idle_slot_steps": acct.idle_steps,
        "solo_bitwise_jobs": len(solo), "solo_wall_s": solo_wall,
        "journal_overhead_pct": overhead,
        "journal_overhead_pairs_pct": pairs,
        "journal_overhead_resolved": resolved,
        "recover_replay_s": replay_s, "recover_deduplicated": deduped,
        "recover_resumed": len(resumed)}

    # (c) eviction on the card: a NaN temperature schedule beside three
    # small-bucket jobs, which stay bitwise their solo runs
    poison = protocol.Schedule(times=np.asarray([0.0, 1.0], np.float32),
                               values=np.full(2, np.nan, np.float32))
    jobs = serve_fleet(torch, dev, spec)[:SERVE_JOBS]
    bad = dataclasses.replace(jobs[3], temperature=poison, name="poisoned",
                              tenant="eve")
    srv = SimServer(serve_cfg(root, "evict", slots=SERVE_SLOTS))
    hs = [srv.submit(j) for j in (jobs[0], jobs[1], jobs[2], bad)]
    t0 = time.perf_counter()
    srv.drain()
    torch.cuda.synchronize()
    evict_s = time.perf_counter() - t0
    eacct = srv.accounting
    if hs[3].status != "evicted" or len(eacct.evictions) != 1:
        raise AssertionError(f"eviction: {hs[3].status} {hs[3].error}")
    for h, g in zip(hs[:3], solo[:3]):
        same_job(h, g, "batch-mate of an evicted job")
    if not eacct.consistent():
        raise AssertionError(f"eviction: accounting {eacct.summary()}")
    ev = eacct.evictions[0]
    log(f"  (c) eviction: {hs[3].job.name} evicted off slot {ev['slot']} "
        f"for {ev['kind']}, 3 batch-mates bitwise their solo runs "
        f"({evict_s:.3f} s)")
    out["eviction"] = {"slot": ev["slot"], "kind": ev["kind"],
                       "seconds": evict_s, "mates_bitwise": 3}
    del srv, hs, packed, solo
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the chaos smoke at its own size: faults, a SIGKILLed child,
    # recovery, the remaining streams bitwise
    t0 = time.perf_counter()
    out["chaos"] = serve_chaos_smoke.main(["--device", str(dev)])
    out["chaos"]["seconds"] = time.perf_counter() - t0
    log(f"phase I (d): launch/serve_chaos_smoke.py: {out['chaos']} ")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase I: {out['seconds']:.1f} s")
    return out

# ---------------------------------------------------------------------------
# phase J: the Sharded plan (torch.distributed), K1/K2 on the cell-major
# slots with the q_Fp adjoint halo between them
# ---------------------------------------------------------------------------

SHARDED_DIR = SURFACE_DIR / "sharded"
SHARDED_SMALL = dict(unit_cells=(8, 8, 8), temperature=600.0, jitter=0.25,
                     skin=0.3, steps=40, chunk=20)   # (b): 4,096 atoms, f64
SHARDED_FULL_CHUNKS = 2                      # (b): 262,144 atoms at f32
SHARDED_KERNEL_ROWS = 8192                   # slots compared at full width
ELASTIC_DIR = SURFACE_DIR / "elastic"        # J(b) writes it, K(b) reads


def sharded_kernels(torch, kern, ref, eng, bar, rows=None,
                    timed: bool = False) -> dict:
    """K1 and K2 (the bodies the spec selects) on an Engine's own slot
    blocks after its run - K2 reading the local-first table and the
    owned + halo-ring adjoint rows, as the plan launches them - against the
    plain versions on the same inputs; the first ``rows`` slots (all by
    default).  Returns ``({kernel: rel err}, {kernel: ms})``, the times
    (with ``timed``, else empty) of each kernel on all the rank's
    slots."""
    from repro_torch.parallel.halo import exchange_halo
    c = eng._carry
    spec, params = eng.potential.spec, eng.potential.params
    k, m = c.state.types.shape[-1], c.nbh.idx.shape[-1]
    n = c.state.types.numel()
    rows = n if rows is None else min(rows, n)
    occ = c.state.types.reshape(-1) >= 0
    ti = torch.where(occ, c.state.types.reshape(-1),
                     torch.zeros_like(c.state.types.reshape(-1)))
    blocks = (c.nbh.dr.reshape(n, m, 3)[:rows].contiguous(),
              c.nbh.mask.reshape(n, m)[:rows].contiguous(),
              ti[:rows].contiguous(),
              c.nbh.tj.reshape(n, m)[:rows].contiguous(),
              c.state.spin.reshape(n, 3)[:rows].contiguous(),
              c.nbh.sj.reshape(n, m, 3)[:rows].contiguous())
    got = kern.nep_atom_pass(spec, params, *blocks)
    want = ref.atom_pass_plain(spec, params, *blocks)
    err = {"nep_atom_pass": max(rel_err(a, b) for a, b in zip(got, want))}
    # every slot's adjoints, exchanged as the plan does (no ledger open)
    _, _, abar = kern.nep_atom_pass(spec, params, c.nbh.dr.reshape(n, m, 3),
                                    c.nbh.mask.reshape(n, m), ti,
                                    c.nbh.tj.reshape(n, m),
                                    c.state.spin.reshape(n, 3),
                                    c.nbh.sj.reshape(n, m, 3))
    abar = torch.where(occ[:, None], abar, torch.zeros_like(abar))
    rp = eng._rplan
    ext = exchange_halo(abar.reshape(*rp.local_shape, k, -1), rp.axes,
                        allgather=rp.allgather)
    from repro_torch.parallel.domain import local_first_index
    _, ring = local_first_index(rp.local_shape, k, abar.device)
    abar_rows = torch.cat([abar, ext.reshape(-1, abar.shape[-1])[ring]])
    k2 = (spec, params, blocks[0], blocks[1], c.nbh.lf[:rows].contiguous(),
          blocks[2], blocks[3], blocks[4], blocks[5], abar_rows)
    got = kern.nep_force_pass(*k2)
    want = ref.force_pass_plain(*k2)
    torch.cuda.synchronize()
    err["nep_force_pass"] = max(rel_err(a, b) for a, b in zip(got, want))
    for name, e in err.items():
        if not e < bar:
            raise AssertionError(f"{name} on the sharded slots: relative "
                                 f"error {e:.3e} >= {bar:g}")
    ms = {}
    if timed:
        full = (c.nbh.dr.reshape(n, m, 3), c.nbh.mask.reshape(n, m), ti,
                c.nbh.tj.reshape(n, m), c.state.spin.reshape(n, 3),
                c.nbh.sj.reshape(n, m, 3))
        ms["nep_atom_pass"] = time_ms(
            torch, lambda: kern.nep_atom_pass(spec, params, *full), 10)
        ms["nep_force_pass"] = time_ms(
            torch, lambda: kern.nep_force_pass(
                spec, params, full[0], full[1], c.nbh.lf, full[2], full[3],
                full[4], full[5], abar_rows), 10)
    return err, ms


def _sharded_same(torch, a, b, bar, what) -> float:
    """Max |a - b| over pos, vel, spin of two flat states; raises past
    ``bar``."""
    err = max(float((getattr(a, k) - getattr(b, k)).abs().max())
              for k in ("pos", "vel", "spin"))
    if not err < bar:
        raise AssertionError(f"{what}: max |diff| {err:.3e} >= {bar:g}")
    return err


def _sharded_rank(rank: int, out: str, device: str) -> None:
    """Phase J (b), one of two gloo ranks on the one card."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.fege_spinlattice import config, main_path
    from repro_torch.core.hamiltonian import HeisenbergDMIModel
    from repro_torch.core.potential import NEPSpinPotential, init_params
    from repro_torch.kernels.nep import kernel as kern
    from repro_torch.kernels.nep import ref
    from repro_torch.md.engine import Engine
    from repro_torch.md.integrator import IntegratorConfig
    from repro_torch.md.lattice import b20_fege
    from repro_torch.md.state import init_state
    from repro_torch.parallel.plan import Sharded

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    spec, lat = config().spec, b20_fege()
    moments = torch.tensor([1.16, 0.0], device=dev)
    res = {"rank": rank}
    small = SHARDED_SMALL
    f64 = torch.float64

    def engine(pot, cfg, state, plan, **kw):
        return Engine(pot, cfg, state,
                      torch.tensor(lat.masses, dtype=state.pos.dtype,
                                   device=dev),
                      torch.tensor(lat.moments, device=dev) > 0,
                      getattr(pot, "cutoff", spec.cutoff), plan=plan,
                      capacity=64, device=dev, **kw)

    # NEP-SPIN at f64 through K1/K2, and Heisenberg-DMI with midpoint
    g = torch.Generator(device=dev).manual_seed(40)
    st = init_state(lat, small["unit_cells"], generator=g,
                    temperature=small["temperature"], spin_init="random",
                    dtype=f64, device=dev)
    # a position jitter puts atoms near cell faces, so rebuilds migrate
    jitter = small["jitter"] * torch.randn(st.pos.shape, generator=g,
                                           dtype=f64, device=dev)
    st = st._replace(pos=torch.remainder(st.pos + jitter, st.box))
    pots = {"nep_f64": (NEPSpinPotential(spec, init_params(
                spec, g, dtype=f64, device=dev), moments.to(f64),
                use_kernel=True), IntegratorConfig(dt=config().dt)),
            "heisenberg_f64": (HeisenbergDMIModel(**HEIS_B20),
                               IntegratorConfig(dt=config().dt, midpoint=True,
                                                midpoint_iters=2))}
    for name, (pot, cfg) in pots.items():
        reset_md_counters(kern)
        sh = engine(pot, cfg, st, Sharded(), skin=small["skin"])
        drift0 = sh.halo_ledger.counts.get("drift-pos", 0)
        t0 = time.perf_counter()
        sh.run(small["steps"], chunk=small["chunk"])
        torch.cuda.synchronize()
        row = {"steps_per_s": small["steps"] / (time.perf_counter() - t0),
               "rebuilds": sh.n_rebuilds, "migrated": sh.n_migrated,
               "drift_pos_per_step": (sh.halo_ledger.counts["drift-pos"]
                                      - drift0) / small["steps"],
               "cells": list(sh._rplan.dspec.cells),
               "cell_capacity": sh._rplan.dspec.capacity,
               "launches": read_md_counters(kern)}
        if sh.n_rebuilds < 1 or sh.n_migrated < 1:
            raise AssertionError(f"{name}: {sh.n_rebuilds} rebuilds, "
                                 f"{sh.n_migrated} migrations")
        if row["drift_pos_per_step"] != 1:
            raise AssertionError(f"{name}: {row['drift_pos_per_step']} "
                                 "drift-pos exchanges a step")
        if rank == 0:
            flat = engine(pot, cfg, st, None, skin=small["skin"],
                          use_cell_list=True, cell_capacity=32)
            flat.run(small["steps"], chunk=small["chunk"])
            row["vs_flat"] = _sharded_same(torch, sh.state, flat.state, 1e-9,
                                           f"{name} sharded vs flat")
            row["flat_rebuilds"] = flat.n_rebuilds
            del flat
        if name == "nep_f64":
            row["kernel_rel_err"] = sharded_kernels(torch, kern, ref, sh,
                                                    1e-9)[0]
        res[name] = row
        dist.barrier()
        del sh

    # NEP-SPIN at full width, f32
    run = main_path()
    dtype = getattr(torch, run.dtype)
    g = torch.Generator(device=dev).manual_seed(0)
    state = init_state(lat, run.unit_cells, generator=g,
                       temperature=run.temperature, dtype=dtype, device=dev)
    pot = NEPSpinPotential(spec, init_params(spec, g, dtype=dtype,
                                             device=dev),
                           moments.to(dtype), use_kernel=True)
    cfg = IntegratorConfig(dt=run.dt, lattice_gamma=run.lattice_gamma,
                           spin_alpha=run.spin_alpha)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_md_counters(kern)
    t0 = time.perf_counter()
    sh = engine(pot, cfg, state, Sharded(), skin=run.skin,
                temperature=run.temperature, field=run.field)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    steps = SHARDED_FULL_CHUNKS * run.chunk
    gen = torch.Generator(device=dev).manual_seed(100 + rank)
    t0 = time.perf_counter()
    sh.run(steps, gen, chunk=run.chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_md_counters(kern)
    expect = 1 + steps + sh.n_rebuilds
    for kname, (n, bodies) in launches.items():
        if n != expect or bodies != {"warp": expect, "thread": 0}:
            raise AssertionError(f"rank {rank} {kname}: {n} launches "
                                 f"{bodies}, expected {expect}, all warp")
    for kname in ("pos", "vel", "spin"):
        t = getattr(sh.state, kname)
        if t.shape != (run.n_atoms, 3) or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"full width {kname}: non-finite or shape "
                                 f"{tuple(t.shape)}")
    # phase K (b)'s writer: this two-rank run's checkpoint, the state it
    # holds, and the E, F, H_eff of a same-mesh elastic restore of it
    ck = ELASTIC_DIR / "ckpt"
    t0 = time.perf_counter()
    sh.save(str(ck), gen)
    save_s = time.perf_counter() - t0
    if rank == 0:
        torch.save({k: getattr(sh.state, k).cpu() for k in
                    ("pos", "vel", "spin", "types")},
                   ELASTIC_DIR / "writer_state.pt")
    same = engine(pot, cfg, state, Sharded(), skin=run.skin,
                  temperature=run.temperature, field=run.field)
    same.restore(str(ck), plan=Sharded())
    if rank == 0:
        torch.save({"E": torch.as_tensor(same.energy),
                    "F": same._ff.force.cpu(), "H": same._ff.field.cpu()},
                   ELASTIC_DIR / "same_mesh.pt")
    del same
    res["nep_full_f32"] = {
        "save_s": save_s,
        "steps_per_s": steps / wall, "setup_s": setup_s,
        "rebuilds": sh.n_rebuilds, "migrated": sh.n_migrated,
        "launches": launches, "expect": expect,
        "cells": list(sh._rplan.dspec.cells),
        "local_cells": list(sh._rplan.local_shape),
        "cell_capacity": sh._rplan.dspec.capacity,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "halo": sh.halo_ledger.snapshot(),
        "kernel_rel_err": sharded_kernels(torch, kern, ref, sh, 1e-4,
                                          rows=SHARDED_KERNEL_ROWS)[0]}
    with open(os.path.join(out, f"rank_{rank}.json"), "w") as f:
        json.dump(res, f)


def phase_sharded(torch, dev, spec, lat, moments, kern, ref,
                  flat_steps_per_s) -> dict:
    """Phase J: (a) the main path on one NCCL rank with a resume from its
    chunk-1 checkpoint (c), then (b) two gloo ranks on the one card."""
    import shutil

    import torch.distributed as dist

    from repro_torch.configs.fege_spinlattice import main_path
    from repro_torch.core.potential import NEPSpinPotential, init_params
    from repro_torch.md.engine import Engine
    from repro_torch.md.integrator import IntegratorConfig
    from repro_torch.md.state import init_state
    from repro_torch.parallel.plan import Sharded
    from repro_torch.parallel.ranks import spawn

    t_phase = time.perf_counter()
    shutil.rmtree(SHARDED_DIR, ignore_errors=True)
    SHARDED_DIR.mkdir(parents=True)
    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    ELASTIC_DIR.mkdir(parents=True)
    run = main_path()
    dtype = getattr(torch, run.dtype)
    steps = run.chunks * run.chunk
    log(f"phase J (a): Engine(plan=Sharded()) on one NCCL rank, B20 "
        f"{run.unit_cells} = {run.n_atoms} atoms, {run.chunks} x "
        f"{run.chunk} steps, K1/K2 on the cell-major slots")
    dist.init_process_group("nccl", init_method="file://" + str(
        SHARDED_DIR / "rendezvous"), world_size=1, rank=0)
    out = {}
    try:
        g = torch.Generator(device=dev).manual_seed(0)
        state = init_state(lat, run.unit_cells, generator=g,
                           temperature=run.temperature, dtype=dtype,
                           device=dev)
        params = init_params(spec, g, dtype=dtype, device=dev)
        pot = NEPSpinPotential(spec, params, moments.to(dtype),
                               use_kernel=True)
        cfg = IntegratorConfig(dt=run.dt, lattice_gamma=run.lattice_gamma,
                               spin_alpha=run.spin_alpha)
        masses = torch.tensor(lat.masses, dtype=dtype, device=dev)
        magnetic = torch.tensor(lat.moments, device=dev) > 0
        kw = dict(temperature=run.temperature, field=run.field,
                  capacity=run.capacity, skin=run.skin, device=dev)
        flat = Engine(pot, cfg, state, masses, magnetic, spec.cutoff,
                      use_cell_list=True, cell_capacity=run.cell_capacity,
                      **kw)

        def sharded():
            return Engine(pot, cfg, state, masses, magnetic, spec.cutoff,
                          plan=Sharded(), **kw)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_md_counters(kern)
        t0 = time.perf_counter()
        eng = sharded()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        setup_peak = torch.cuda.max_memory_allocated()
        rp = eng._rplan
        construct = {}
        for name, a, b in (("E", torch.as_tensor(eng.energy),
                            torch.as_tensor(flat.energy)),
                           ("F", eng._ff.force, flat._ff.force),
                           ("H", eng._ff.field, flat._ff.field)):
            construct[name] = check(f"J(a) {name} sharded vs flat", a, b,
                                    1e-4)
        del flat
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev).manual_seed(1)
        drift0 = eng.halo_ledger.counts.get("drift-pos", 0)
        ck = SHARDED_DIR / "ckpt"
        t0 = time.perf_counter()
        eng.run(run.chunk, gen, chunk=run.chunk)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eng.save(str(ck), gen)
        t2 = time.perf_counter()
        eng.run(steps - run.chunk, gen, chunk=run.chunk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t2 + (t1 - t0)
        run_peak = torch.cuda.max_memory_allocated()
        launches = read_md_counters(kern)
        expect = 1 + steps + eng.n_rebuilds
        for name, (n, bodies) in launches.items():
            if n != expect or bodies != {"warp": expect, "thread": 0}:
                raise AssertionError(f"J(a) {name}: {n} launches {bodies}, "
                                     f"expected 1 + steps + rebuilds = "
                                     f"{expect}, all warp")
        drift = (eng.halo_ledger.counts["drift-pos"] - drift0) / steps
        if drift != 1:
            raise AssertionError(f"J(a): {drift} drift-pos exchanges a step")
        for name in ("pos", "vel", "spin"):
            t = getattr(eng.state, name)
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"J(a) {name} not finite")
        n_slots = int(eng._carry.state.types.numel())
        out["one_rank"] = {
            "steps_per_s": steps / wall,
            "flat_steps_per_s_phase3": flat_steps_per_s,
            "setup_s": setup_s, "save_s": t2 - t1,
            "rebuilds": eng.n_rebuilds, "migrated": eng.n_migrated,
            "launches": launches[kern.nep_atom_pass.__name__][0],
            "drift_pos_per_step": drift, "construct_rel_err": construct,
            "cells": list(rp.dspec.cells), "cell_capacity":
            rp.dspec.capacity, "slots": n_slots,
            "slots_per_atom": n_slots / run.n_atoms,
            "setup_peak_gib": setup_peak / 2 ** 30,
            "run_peak_gib": run_peak / 2 ** 30,
            "halo": eng.halo_ledger.snapshot()}
        log(f"  J(a): {out['one_rank']}")
        (out["one_rank"]["kernel_rel_err"],
         out["one_rank"]["kernel_ms"]) = sharded_kernels(
            torch, kern, ref, eng, 1e-4, rows=SHARDED_KERNEL_ROWS,
            timed=True)

        # (c) the chunk-1 checkpoint into a fresh Engine, chunks 2-3
        fresh = sharded()
        t0 = time.perf_counter()
        gen2 = fresh.restore(str(ck))
        restore_s = time.perf_counter() - t0
        fresh.run(steps - run.chunk, gen2, chunk=run.chunk)
        torch.cuda.synchronize()
        for name in ("pos", "vel", "spin"):
            if not torch.equal(getattr(fresh.state, name),
                               getattr(eng.state, name)):
                raise AssertionError(f"J(c): resumed {name} differs")
        if (fresh.state.step, fresh.n_rebuilds) != (eng.state.step,
                                                    eng.n_rebuilds):
            raise AssertionError("J(c): step or rebuild count differs")
        out["resume"] = {"bitwise": True, "restore_s": restore_s,
                         "checkpoint_mb": dir_bytes(ck) / 1e6}
        log(f"  J(c): resume bitwise, {out['resume']}")
        del eng, fresh
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    log("phase J (b): two gloo ranks on the one card (gloo copies the "
        "allgather halos through the host: no scaling figure)")
    t0 = time.perf_counter()
    spawn(_sharded_rank, 2, str(SHARDED_DIR), str(dev), backend="gloo",
          workdir=str(SHARDED_DIR))
    out["two_ranks"] = [json.loads((SHARDED_DIR / f"rank_{r}.json")
                                   .read_text()) for r in range(2)]
    out["two_ranks_s"] = time.perf_counter() - t0
    for r in out["two_ranks"]:
        log(f"  J(b) rank {r['rank']}: {r}")
    out["phase_s"] = time.perf_counter() - t_phase
    shutil.rmtree(SHARDED_DIR, ignore_errors=True)
    return out

# ---------------------------------------------------------------------------
# phase K: the rest of the Sharded plan - replicas on the spatial mesh with
# K1/K2 on per-replica tables, elastic restore, the faults and the capacity
# rung, the replica axis across ranks
# ---------------------------------------------------------------------------

SHARDED_REPLICAS = 4
SREP_STEPS = 10       # (a): one chunk short enough to trip no rebuild
K_SMALL = dict(unit_cells=(8, 8, 8), temperature=600.0, jitter=0.25,
               skin=0.3, steps=40, chunk=10)     # (c), (d): f64, 4,096 atoms


def _k_small_setup(torch, dev):
    """(c) and (d)'s f64 B20 8^3 state, NEP-SPIN potential through K1/K2
    and Engine keywords, the same on every rank."""
    from repro_torch.configs.fege_spinlattice import config
    from repro_torch.core.potential import NEPSpinPotential, init_params
    from repro_torch.md.integrator import IntegratorConfig
    from repro_torch.md.lattice import b20_fege
    from repro_torch.md.state import init_state
    spec, lat, f64 = config().spec, b20_fege(), torch.float64
    g = torch.Generator(device=dev).manual_seed(41)
    st = init_state(lat, K_SMALL["unit_cells"], generator=g,
                    temperature=K_SMALL["temperature"], spin_init="random",
                    dtype=f64, device=dev)
    jitter = K_SMALL["jitter"] * torch.randn(st.pos.shape, generator=g,
                                             dtype=f64, device=dev)
    st = st._replace(pos=torch.remainder(st.pos + jitter, st.box))
    pot = NEPSpinPotential(spec, init_params(spec, g, dtype=f64, device=dev),
                           torch.tensor([1.16, 0.0], dtype=f64, device=dev),
                           use_kernel=True)
    kw = dict(masses=torch.tensor(lat.masses, dtype=f64, device=dev),
              magnetic=torch.tensor(lat.moments, device=dev) > 0,
              cutoff=spec.cutoff, capacity=64, skin=K_SMALL["skin"],
              device=dev)
    return st, pot, IntegratorConfig(dt=config().dt), kw


def _faults_rank(rank: int, out: str, device: str) -> None:
    """Phase K (c) and (d)'s Replicated(4) split, one of two gloo ranks."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.md.engine import Engine
    from repro_torch.parallel.plan import Replicated, Sharded
    from repro_torch.resilience import (Fault, FaultPlan, Supervisor,
                                        SupervisorConfig, install_faults)
    from repro_torch.telemetry import HealthConfig, Telemetry

    dev = torch.device(device)
    st, pot, cfg, kw = _k_small_setup(torch, dev)
    steps, chunk = K_SMALL["steps"], K_SMALL["chunk"]
    res = {"rank": rank}

    def engine(plan, **extra):
        return Engine(pot, cfg, st, plan=plan, **kw, **extra)

    clean = engine(Sharded())
    clean.run(steps, chunk=chunk)
    cap0 = clean._rplan.dspec.capacity
    if clean.n_rebuilds < 1:
        raise AssertionError(f"K(c) clean run: {clean.n_rebuilds} rebuilds")
    # a corrupted halo face on rank 1
    eng = engine(Sharded())
    install_faults(eng, FaultPlan(faults=(Fault(kind="halo", step=15,
                                                device=1),)))
    sup = Supervisor(SupervisorConfig(max_retries=2))
    t0 = time.perf_counter()
    got = sup.run(eng, steps, None, chunk=chunk,
                  checkpoint_dir=os.path.join(out, "k_halo"),
                  telemetry=Telemetry(health=HealthConfig()))
    res["halo"] = {"events": [e["event"] for e in sup.events],
                   "seconds": time.perf_counter() - t0}
    if res["halo"]["events"] != ["rollback", "retry", "recovered"]:
        raise AssertionError(f"K(c) halo: {res['halo']['events']}")
    for k in ("pos", "vel", "spin"):
        if not torch.equal(getattr(got, k), getattr(clean.state, k)):
            raise AssertionError(f"K(c) halo recovery: {k} differs")
    # a persistent overflow on rank 1: the capacity rung
    eng = engine(Sharded())
    install_faults(eng, FaultPlan(faults=(
        Fault(kind="overflow", step=15, device=1, once=False),)))
    sup = Supervisor(SupervisorConfig(max_retries=4, degrade_after=2))
    sup.run(eng, steps, None, chunk=chunk,
            checkpoint_dir=os.path.join(out, "k_overflow"))
    cap1 = eng._rplan.dspec.capacity
    res["overflow"] = {"events": [e["event"] for e in sup.events],
                       "cap0": cap0, "cap1": cap1,
                       "final_step": eng._step_now()}
    if not (cap1 >= 2 * cap0 and eng._step_now() == steps
            and "degrade" in res["overflow"]["events"]):
        raise AssertionError(f"K(c) overflow: {res['overflow']}")
    # elastic 2 -> 1 -> 2
    ck, ck1 = os.path.join(out, "k_el2"), os.path.join(out, "k_el1")
    eng = engine(Sharded())
    eng.run(2 * chunk, chunk=chunk, checkpoint_dir=ck)
    same = engine(Sharded())
    same.restore(ck, plan=Sharded())
    el = {"e_same": same.energy}
    same.run(2 * chunk, chunk=chunk)
    el["e_same_end"] = same.energy
    if rank == 0:
        down = engine(Sharded(devices=(0,)))
        t0 = time.perf_counter()
        down.restore(ck, plan=Sharded(devices=(0,)))
        el["restore_s"] = time.perf_counter() - t0
        el["e_down"] = down.energy
        down.run(2 * chunk, chunk=chunk)
        el["e_down_end"] = down.energy
        down.save(ck1, None)
        one = engine(Sharded(devices=(0,)))
        one.restore(ck1, plan=Sharded(devices=(0,)))
        el["e_up_one"] = one.energy
    else:
        try:
            engine(Sharded(devices=(0,)))
            raise AssertionError("K(c): rank 1 ran a plan on rank 0 only")
        except ValueError:
            pass
    dist.barrier()
    up = engine(Sharded())
    up.restore(ck1, plan=Sharded())
    el["e_up"], el["mesh_up"] = up.energy, up._rplan.world
    if rank == 0:
        el["down_delta"] = abs(el["e_down"] - el["e_same"])
        el["down_end_delta"] = abs(el["e_down_end"] - el["e_same_end"])
        el["up_delta"] = abs(el["e_up"] - el["e_up_one"])
        if not (el["down_delta"] < 1e-10 and el["up_delta"] < 1e-10
                and el["down_end_delta"] < 1e-8):
            raise AssertionError(f"K(c) elastic 2 -> 1 -> 2: {el}")
    res["elastic"] = el
    # (d) Replicated(4) split over the two ranks, through a checkpoint
    gens = [torch.Generator(device=dev).manual_seed(300 + r)
            for r in range(4)]
    temps = [300.0, 450.0, 600.0, 750.0]

    def replicated(devices):
        return Engine(pot, dataclasses.replace(cfg, lattice_gamma=1.0,
                                               spin_alpha=0.05), st,
                      plan=Replicated(4, devices=devices), temperature=temps,
                      field=(0.0, 0.0, 0.2), **kw)

    split = replicated((0, 1))
    ck = os.path.join(out, "k_rep")
    split.run(chunk, gens[2 * rank:2 * rank + 2], chunk=chunk,
              checkpoint_dir=ck)
    fresh = replicated((0, 1))
    g = fresh.restore(ck)
    fresh.run(chunk, g, chunk=chunk)
    if rank == 0:
        whole = replicated(None)
        wg = [torch.Generator(device=dev).manual_seed(300 + r)
              for r in range(4)]
        whole.run(2 * chunk, wg, chunk=chunk)
        for k in ("pos", "vel", "spin"):
            if not torch.equal(getattr(fresh.state, k),
                               getattr(whole.state, k)):
                raise AssertionError(f"K(d) Replicated(4) split: {k} "
                                     "differs from the one-process run")
        res["replicated_split"] = {"bitwise": True,
                                   "rebuilds": whole.n_rebuilds}
    with open(os.path.join(out, f"k_rank_{rank}.json"), "w") as f:
        json.dump(res, f)


def _mesh_rank(rank: int, out: str, device: str) -> None:
    """Phase K (d): a 2 x 2 ("replica", "sx") mesh of 4 gloo ranks."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.ensemble.replica import sharded_replica_mesh
    from repro_torch.md.engine import Engine
    from repro_torch.parallel.plan import Sharded

    dev = torch.device(device)
    st, pot, cfg, kw = _k_small_setup(torch, dev)
    steps, chunk = K_SMALL["steps"], K_SMALL["chunk"]
    fields = [(0.0, 0.0, 0.2), (0.0, 0.0, 0.2)]
    rep = Engine(pot, cfg, st, plan=Sharded(mesh=sharded_replica_mesh(2, 2),
                                            replicas=2),
                 field=fields, **kw)
    rep.run(steps, [torch.Generator(device=dev)], chunk=chunk,
            temperature=[0.0, 0.0])
    try:
        two = Engine(pot, cfg, st, plan=Sharded(devices=(0, 1)),
                     field=fields[0], **kw)
    except ValueError:
        two = None                      # ranks 2 and 3 hold no part of it
    if two is not None:
        two.run(steps, torch.Generator(device=dev), chunk=chunk,
                temperature=0.0)
    dist.barrier()
    if rank == 0:
        same = all(torch.equal(getattr(rep.state, k)[0],
                               getattr(rep.state, k)[1])
                   for k in ("pos", "vel", "spin"))
        vs_two = max(float((getattr(rep.state, k)[0]
                            - getattr(two.state, k)).abs().max())
                     for k in ("pos", "vel", "spin"))
        shapes = [list(rep.trace.values["energy"].shape),
                  list(rep.trace.values["magnetization"].shape)]
        if not (same and vs_two < 1e-12 and shapes == [
                [steps // chunk, 2], [steps // chunk, 2, 3]]):
            raise AssertionError(f"K(d) replica mesh: identical {same}, vs "
                                 f"two ranks {vs_two}, trace {shapes}")
        with open(os.path.join(out, "k_mesh.json"), "w") as f:
            json.dump({"identical": same, "vs_two_ranks": vs_two,
                       "trace_shapes": shapes,
                       "rebuilds": rep.n_rebuilds,
                       "migrated": rep.n_migrated}, f)


def sharded_replica_kernels(torch, kern, ref, eng, rows_cmp: int) -> tuple:
    """K1 and K2 on the replicas' own slot blocks as the evaluator launches
    them (one batched launch over per-replica tables): ``torch.equal`` to
    one flat launch per replica, timed beside them in turns, and against
    the plain versions on each replica's first ``rows_cmp`` slots.
    Returns ({kernel: rel err}, {kernel: {"batched_ms", "flat_ms"}})."""
    from repro_torch.parallel.domain import local_first_index
    from repro_torch.parallel.halo import cell_dims, exchange_halo
    c, rp = eng._carry, eng._rplan
    spec, params = eng.potential.spec, eng.potential.params
    r, k, m = eng._batch, c.state.types.shape[-1], c.nbh.idx.shape[-1]
    n = c.state.types[0].numel()
    occ = c.state.types.reshape(r, n) >= 0
    ti = torch.where(occ, c.state.types.reshape(r, n),
                     torch.zeros_like(c.state.types.reshape(r, n)))
    k1_in = (c.nbh.dr.reshape(r, n, m, 3), c.nbh.mask.reshape(r, n, m), ti,
             c.nbh.tj.reshape(r, n, m), c.state.spin.reshape(r, n, 3),
             c.nbh.sj.reshape(r, n, m, 3))
    out1 = kern.nep_atom_pass(spec, params, *k1_in)
    abar = torch.where(occ[..., None], out1[2], torch.zeros_like(out1[2]))
    a = abar.shape[-1]
    ext = exchange_halo(abar.reshape(r, *rp.local_shape, k, a), rp.axes,
                        dims=cell_dims(1), allgather=rp.allgather)
    _, ring = local_first_index(rp.local_shape, k, abar.device)
    abar_rows = torch.cat([abar, ext.reshape(r, -1, a)[:, ring]], dim=1)
    lf = c.nbh.lf
    k2_in = (k1_in[0], k1_in[1], lf, ti, k1_in[3], k1_in[4], k1_in[5],
             abar_rows)
    out2 = kern.nep_force_pass(spec, params, *k2_in)
    for q in range(r):
        flat1 = kern.nep_atom_pass(spec, params, *(x[q] for x in k1_in))
        flat2 = kern.nep_force_pass(spec, params, *(x[q] for x in k2_in))
        for name, got, want in (("K1", out1, flat1), ("K2", out2, flat2)):
            for o, (x, y) in enumerate(zip(got, want)):
                if not torch.equal(x[q], y):
                    raise AssertionError(f"K(a) {name} output {o}: replica "
                                         f"{q} of the batched launch is not "
                                         "its flat launch")
    err = {}
    cut = lambda x: x[:, :rows_cmp].contiguous()
    p1 = tuple(cut(x) for x in k1_in)
    want = ref.atom_pass_plain(spec, params, *p1)
    got = kern.nep_atom_pass(spec, params, *p1)
    err["nep_atom_pass"] = max(rel_err(x, y) for x, y in zip(got, want))
    p2 = tuple(cut(x) for x in k2_in[:7]) + (abar_rows,)
    want = ref.force_pass_plain(spec, params, *p2)
    got = kern.nep_force_pass(spec, params, *p2)
    torch.cuda.synchronize()
    err["nep_force_pass"] = max(rel_err(x, y) for x, y in zip(got, want))
    for name, e in err.items():
        if not e < 1e-4:
            raise AssertionError(f"K(a) {name} vs plain on the replicas' "
                                 f"slots: relative error {e:.3e} >= 1e-4")
    times = {}
    for name, fn, args in (("nep_atom_pass", kern.nep_atom_pass, k1_in),
                           ("nep_force_pass", kern.nep_force_pass, k2_in)):
        t = {"batched": [], "flat": []}
        for how in ("batched", "flat", "flat", "batched"):
            t[how].append(time_ms(torch, (lambda: fn(spec, params, *args))
                                  if how == "batched" else (
                lambda: [fn(spec, params, *(x[q] for x in args))
                         for q in range(r)]), 5))
        times[name] = {"batched_ms": sum(t["batched"]) / 2,
                       "flat_ms": sum(t["flat"]) / 2}
    return err, times


def phase_sharded_replicas(torch, dev, spec, lat, moments, kern, ref,
                           j_steps_per_s) -> dict:
    """Phase K: (a) Sharded(replicas=4) on one NCCL rank, (b) the elastic
    restore of J(b)'s checkpoint onto it, then (c) and (d) on gloo ranks
    sharing the card."""
    import shutil

    import torch.distributed as dist

    from repro_torch.ckpt.elastic import gather_md_state
    from repro_torch.configs.fege_spinlattice import main_path
    from repro_torch.core.potential import NEPSpinPotential, init_params
    from repro_torch.md.engine import Engine
    from repro_torch.md.integrator import IntegratorConfig
    from repro_torch.md.state import init_state
    from repro_torch.parallel.plan import Sharded
    from repro_torch.parallel.ranks import spawn

    t_phase = time.perf_counter()
    run = main_path()
    dtype = getattr(torch, run.dtype)
    kdir = SURFACE_DIR / "sharded_replicas"
    shutil.rmtree(kdir, ignore_errors=True)
    kdir.mkdir(parents=True)
    log(f"phase K (a): Engine(plan=Sharded(replicas={SHARDED_REPLICAS})) on "
        f"one NCCL rank, B20 {run.unit_cells} = {run.n_atoms} atoms a "
        f"replica, one chunk of {SREP_STEPS} steps")
    dist.init_process_group("nccl", init_method="file://" + str(
        kdir / "rendezvous"), world_size=1, rank=0)
    out = {}
    try:
        g = torch.Generator(device=dev).manual_seed(0)
        state = init_state(lat, run.unit_cells, generator=g,
                           temperature=run.temperature, dtype=dtype,
                           device=dev)
        params = init_params(spec, g, dtype=dtype, device=dev)
        pot = NEPSpinPotential(spec, params, moments.to(dtype),
                               use_kernel=True)
        cfg = IntegratorConfig(dt=run.dt, lattice_gamma=run.lattice_gamma,
                               spin_alpha=run.spin_alpha)
        masses = torch.tensor(lat.masses, dtype=dtype, device=dev)
        magnetic = torch.tensor(lat.moments, device=dev) > 0
        kw = dict(temperature=run.temperature, field=run.field,
                  capacity=run.capacity, skin=run.skin, device=dev)

        def engine(plan):
            return Engine(pot, cfg, state, masses, magnetic, spec.cutoff,
                          plan=plan, **kw)

        def gens():
            return [torch.Generator(device=dev).manual_seed(200 + q)
                    for q in range(SHARDED_REPLICAS)]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_md_counters(kern)
        t0 = time.perf_counter()
        eng = engine(Sharded(replicas=SHARDED_REPLICAS))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng.run(SREP_STEPS, gens(), chunk=SREP_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = read_md_counters(kern)
        expect = 1 + SREP_STEPS + eng.n_rebuilds
        for name, (n, bodies) in launches.items():
            if n != expect or bodies != {"warp": expect, "thread": 0}:
                raise AssertionError(f"K(a) {name}: {n} launches {bodies}, "
                                     f"expected 1 + steps + rebuilds = "
                                     f"{expect}, all warp")
        if eng.n_rebuilds:
            raise AssertionError(f"K(a): {eng.n_rebuilds} rebuild(s) in "
                                 f"{SREP_STEPS} steps; the replica-vs-solo "
                                 "comparison needs a chunk with none")
        for name in ("pos", "vel", "spin"):
            t = getattr(eng.state, name)
            if t.shape != (SHARDED_REPLICAS, run.n_atoms, 3) or not bool(
                    torch.isfinite(t).all()):
                raise AssertionError(f"K(a) {name}: shape {tuple(t.shape)} "
                                     "or non-finite values")
        obs = {k: list(v.shape) for k, v in eng.trace.values.items()}
        slots = int(eng._carry.state.types.numel())
        out["replicas"] = {
            "replica_steps_per_s": SHARDED_REPLICAS * SREP_STEPS / wall,
            "steps_per_s": SREP_STEPS / wall,
            "j_a_steps_per_s": j_steps_per_s, "setup_s": setup_s,
            "launches": launches["nep_atom_pass"][0], "slots": slots,
            "rebuilds": eng.n_rebuilds, "peak_gib": peak / 2 ** 30,
            "trace_shapes": obs, "cells": list(eng._rplan.dspec.cells),
            "cell_capacity": eng._rplan.dspec.capacity}
        log(f"  K(a): {out['replicas']}")
        (out["replicas"]["kernel_rel_err"],
         out["replicas"]["kernel_ms"]) = sharded_replica_kernels(
            torch, kern, ref, eng, SHARDED_KERNEL_ROWS)
        log(f"  K(a) kernels: {out['replicas']['kernel_rel_err']}, "
            f"{out['replicas']['kernel_ms']}")
        reps = eng.state
        del eng
        torch.cuda.empty_cache()
        for q, gq in enumerate(gens()):
            solo = engine(Sharded())
            solo.run(SREP_STEPS, gq, chunk=SREP_STEPS)
            if solo.n_rebuilds:
                raise AssertionError(f"K(a) solo {q}: a rebuild")
            for name in ("pos", "vel", "spin"):
                if not torch.equal(getattr(solo.state, name),
                                   getattr(reps, name)[q]):
                    raise AssertionError(f"K(a) replica {q} {name} is not "
                                         "the Sharded() run with its "
                                         "generator")
            del solo
        out["replicas"]["bitwise_vs_solo"] = True
        del reps
        torch.cuda.empty_cache()

        # (b) J(b)'s two-rank checkpoint, restored elastically here
        log("phase K (b): J(b)'s two-gloo-rank checkpoint restored "
            "elastically onto this one NCCL rank")
        ck = ELASTIC_DIR / "ckpt"
        target = engine(Sharded())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gathered, _, step = gather_md_state(
            str(ck), target._domain_ckpt_tree(target._carry), device=dev)
        torch.cuda.synchronize()
        gather_s = time.perf_counter() - t0
        writer = torch.load(ELASTIC_DIR / "writer_state.pt")
        for name, t in writer.items():
            if not torch.equal(getattr(gathered, name).cpu(), t):
                raise AssertionError(f"K(b) gathered {name} is not the "
                                     "writers' state")
        del gathered
        t0 = time.perf_counter()
        target.restore(str(ck), plan=Sharded())
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same = torch.load(ELASTIC_DIR / "same_mesh.pt")
        err = {"E": check("K(b) E vs same-mesh", torch.as_tensor(
                   target.energy), same["E"], 1e-4),
               "F": check("K(b) F vs same-mesh", target._ff.force.cpu(),
                          same["F"], 1e-4),
               "H": check("K(b) H vs same-mesh", target._ff.field.cpu(),
                          same["H"], 1e-4)}
        out["elastic"] = {"from_ranks": 2, "to_ranks": target._rplan.world,
                          "step": step, "gather_s": gather_s,
                          "restore_s": restore_s, "rel_err": err,
                          "cells": list(target._rplan.dspec.cells)}
        log(f"  K(b): {out['elastic']}")
        del target
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)

    log("phase K (c): faults, the capacity rung and elastic 2 -> 1 -> 2 on "
        "two gloo ranks (f64 B20 8^3, K1/K2); (d) Replicated(4) split over "
        "them")
    t0 = time.perf_counter()
    spawn(_faults_rank, 2, str(kdir), str(dev), backend="gloo",
          workdir=str(kdir))
    out["faults"] = [json.loads((kdir / f"k_rank_{q}.json").read_text())
                     for q in range(2)]
    out["faults_s"] = time.perf_counter() - t0
    log(f"  K(c): {out['faults']}")
    log("phase K (d): a 2 x 2 (replica, sx) mesh of 4 gloo ranks")
    t0 = time.perf_counter()
    spawn(_mesh_rank, 4, str(kdir), str(dev), backend="gloo",
          workdir=str(kdir))
    out["mesh"] = json.loads((kdir / "k_mesh.json").read_text())
    out["mesh_s"] = time.perf_counter() - t0
    log(f"  K(d): {out['mesh']}")
    out["phase_s"] = time.perf_counter() - t_phase
    shutil.rmtree(kdir, ignore_errors=True)
    return out


LEGACY_DIR = SURFACE_DIR / "legacy"
LEGACY_SMALL = (8, 8, 8)                     # (b): B20 unit cells, f64
LEGACY_KERNEL_ROWS = 8192                    # (a): slots against plain
# (b): tests/test_domain.py's bars, of max(|ref|, 1): at 4,096 atoms the
# energy is O(10^3) eV, and an f64 sum in another order moves it by more
# than 1e-10 absolute
LEGACY_BARS = {"stencil": (1e-10, 1e-12), "pruned": (1e-8, 1e-10),
               "kernel": (1e-8, 1e-10)}
# phase 4's reading of the main path's bounds (PERF.md), ms
MAIN_PATH_BOUNDS = (0.2047, 0.5002)


def _scaled_err(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                  1.0)


def legacy_domain(torch, state, dev):
    """The legacy paths' domain of a flat state on one rank: cells at least
    the cutoff wide (skin 0), the capacity its fullest cell needs; returns
    (DomainSpec, the binned DomainState on ``dev``, each slot's atom id
    (host))."""
    import numpy as np

    from repro_torch.parallel.domain import DomainSpec, pack_domain
    b = state.box.cpu().numpy()
    grid = tuple(int(x // 5.0) for x in b)
    ci = np.clip((state.pos.cpu().numpy() / b * grid).astype(np.int64), 0,
                 np.asarray(grid) - 1)
    flat = (ci[:, 0] * grid[1] + ci[:, 1]) * grid[2] + ci[:, 2]
    dspec = DomainSpec(cells=grid, capacity=int(np.bincount(flat).max()),
                       cutoff=5.0, box=tuple(float(x) for x in b),
                       axis_map=("sx", None, None))
    dspec.check_loop({"sx": 1})       # >= 3 cells a dim: 27 distinct cells
    dst, ex = pack_domain(dspec, state.pos, state.vel, state.spin,
                          state.types,
                          extras={"aid": np.arange(state.pos.shape[0])})
    return dspec, type(dst)(*(x.to(dev) for x in dst)), ex["aid"]


def _unbin(torch, aid, dev, *blocks):
    """Cell blocks -> flat (N, 3) tensors on ``dev`` in atom order."""
    from repro_torch.parallel.domain import unbin_cells
    return [torch.from_numpy(x).to(dev) for x in unbin_cells(
        aid, *(t.cpu().numpy() for t in blocks))]


# the dry run's cells: phase L (d) the MD ones on both worlds, phase X
# (c) three LM cells, each on one world (False: 16 x 16, True: 2 x 16 x 16)
DRY_MD_CELLS = (("fege-spinlattice", "md_small"),
                ("fege-spinlattice", "md_large"))
DRY_LM_CELLS = (("qwen2-7b", "train_4k", False),
                ("moonshot-v1-16b-a3b", "train_4k", False),
                ("zamba2-2.7b", "decode_32k", True))
DRY_LM_DIR = SURFACE_DIR / "dryrun_lm"
# outside SURFACE_DIR, which phase A wipes after L (d) has started
DRY_MD_DIR = ROOT / "build" / "chip_smoke_dryrun_md"
DRY_LM_TIMEOUT = 900


def start_dryrun(cells, out_dir):
    """``launch/dryrun.py:run_all`` on ``cells`` in a background process
    on the host (no card: ``CUDA_VISIBLE_DEVICES=""``), its output piped."""
    code = ("import json, sys; from repro_torch.launch import dryrun; "
            "dryrun.run_all(sys.argv[2], cells=json.loads(sys.argv[1]))")
    return subprocess.Popen(
        [sys.executable, "-c", code, json.dumps(cells), str(out_dir)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 CUDA_VISIBLE_DEVICES=""),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def start_md_dryrun():
    """Phase L (d)'s MD dry run, in the background (host work with no
    card): the whole run starts it at phase S, beside phases S to V, which
    time nothing on the host (CUDA events, card-bound training steps)."""
    import shutil
    shutil.rmtree(DRY_MD_DIR, ignore_errors=True)
    return start_dryrun(DRY_MD_CELLS, DRY_MD_DIR)


def phase_legacy(torch, dev, spec, lat, moments, kern, ref, reports,
                 dry=None) -> dict:
    """Phase L: the legacy per-evaluation domain paths on one NCCL rank,
    the roofline module's bounds at the main path and the fitted spec
    (``reports``: phase 4's and phase G's ``nep_report``, or None), and the
    MD dry run on fake worlds in a background process (``dry``, started by
    :func:`start_md_dryrun`; started here, before (a)-(c), if None)."""
    import shutil

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import report
    t_phase = time.perf_counter()
    if dry is None:
        dry = start_md_dryrun()
    shutil.rmtree(LEGACY_DIR, ignore_errors=True)
    LEGACY_DIR.mkdir(parents=True)
    dry_dir = DRY_MD_DIR
    out = {}
    try:
        dist.init_process_group("nccl", init_method="file://" + str(
            LEGACY_DIR / "rendezvous"), world_size=1, rank=0)
        try:
            mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("sx",))
            out["kernel_path"] = _legacy_kernel_path(
                torch, dev, spec, lat, moments, kern, ref, mesh)
            out["autograd_f64"] = _legacy_autograd(torch, dev, spec, lat,
                                                   moments, mesh)
        finally:
            dist.destroy_process_group()
        out["roofline"] = _legacy_roofline(reports)
        text, _ = dry.communicate(timeout=600)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
    log("phase L (d): launch/dryrun.py:run_all on the MD cells (fake "
        "worlds of 256 and 512 ranks, a child process each)")
    for line in text.splitlines():
        log("  " + line)
    if dry.returncode != 0:
        raise AssertionError(f"the dry run exited with {dry.returncode}")
    cells = {(r["shape"], "pod2" if r["mesh"].get("pod") else "pod1"): r
             for r in report.load_all(str(dry_dir))}
    for key in (("md_small", "pod1"), ("md_small", "pod2")):
        if "roofline" not in cells.get(key, {}):
            raise AssertionError(f"dry run: no record for {key}: "
                                 f"{cells.get(key)}")
    report.dryrun_main(str(dry_dir))
    out["dryrun"] = {f"{s}__{p}": {k: r.get(k) for k in (
        "flops_total", "bytes_total", "bytes_naive", "memory", "collectives",
        "roofline", "elapsed_s", "error")} for (s, p), r in cells.items()}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase L: {out['phase_s']:.1f} s")
    return out


def _legacy_kernel_path(torch, dev, spec, lat, moments, kern, ref,
                        mesh) -> dict:
    """Phase L (a): ``distributed_kernel_force_fn`` at fege-main's width
    against the flat ``nep_compute``; K1/K2 on its slots against the plain
    versions; the time of one evaluation."""
    import types as pytypes

    from repro_torch.configs.fege_spinlattice import main_path
    from repro_torch.core.potential import init_params
    from repro_torch.kernels.nep.ops import nep_compute
    from repro_torch.md.neighbor import cell_neighbor_table, gather_blocks
    from repro_torch.md.state import init_state
    from repro_torch.parallel.domain import distributed_kernel_force_fn
    from repro_torch.parallel.halo import HaloTrace, halo_axes
    run = main_path()
    dtype = getattr(torch, run.dtype)
    g = torch.Generator(device=dev).manual_seed(0)     # phase 3's state
    st = init_state(lat, run.unit_cells, generator=g,
                    temperature=run.temperature, dtype=dtype, device=dev)
    params = init_params(spec, g, dtype=dtype, device=dev)
    mom = moments.to(dtype)
    field = torch.tensor(run.field, dtype=dtype, device=dev)
    t0 = time.perf_counter()
    dspec, dst, aid = legacy_domain(torch, st, dev)
    build, effn = distributed_kernel_force_fn(
        spec, dspec, mesh, capacity=run.capacity, field=field, moments=mom)
    idx, nmask = build(dst.pos, dst.types, dst.mask)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_slots = dst.types.numel()
    log(f"phase L (a): distributed_kernel_force_fn on one NCCL rank, B20 "
        f"{run.unit_cells} = {run.n_atoms} atoms, f32: grid {dspec.cells} x "
        f"K = {dspec.capacity} ({n_slots} slots), table M = "
        f"{idx.shape[-1]}; bin + table {setup_s:.2f} s")
    args = (dst.pos, dst.spin, dst.types, dst.mask, idx, nmask)
    reset_md_counters(kern)
    with HaloTrace() as ledger:
        e, f, h = effn(params, *args)
    torch.cuda.synchronize()
    counts = read_md_counters(kern)
    for name, (n, by_body) in counts.items():
        if n != 1 or by_body != {"warp": 1, "thread": 0}:
            raise AssertionError(f"legacy kernel path {name}: launches {n} "
                                 f"by body {by_body}, expected one warp")
    tab = cell_neighbor_table(st.pos, st.box, spec.cutoff, run.capacity,
                              cell_capacity=run.cell_capacity)
    nbh = gather_blocks(st.pos, st.types, tab, st.box)
    ef, ff, hf = nep_compute(spec, params, nbh, st.spin, st.types, field,
                             mom)
    fl, hl = _unbin(torch, aid, dev, f, h)
    errs = {"E": abs(float(e) - float(ef)) / abs(float(ef)),
            "F": rel_err(fl, ff), "H": rel_err(hl, hf)}
    log(f"  E {float(e):.6f} eV (flat {float(ef):.6f}); rel err vs flat "
        f"nep_compute {errs} (bar 1e-4); launches {counts}; ledger "
        f"{ledger.snapshot()}")
    if not max(errs.values()) < 1e-4:
        raise AssertionError(f"legacy kernel path vs flat: {errs}")
    del tab, nbh, ff, hf, fl, hl
    # K1 and K2 on this path's own slot blocks, as sharded_kernels reads
    # an Engine's
    nbh_l, typ = effn.blocks(*args)
    ns = pytypes.SimpleNamespace
    eng = ns(_carry=ns(state=ns(types=typ, spin=dst.spin), nbh=nbh_l),
             potential=ns(spec=spec, params=params),
             _rplan=ns(local_shape=tuple(dspec.cells),
                       axes=halo_axes(mesh, dspec.axis_map), allgather=True))
    kerr, kms = sharded_kernels(torch, kern, ref, eng, 1e-4,
                                rows=LEGACY_KERNEL_ROWS, timed=True)
    eval_ms = time_ms(torch, lambda: effn(params, *args), 5)
    log(f"  K1/K2 vs plain on the first {LEGACY_KERNEL_ROWS} slots {kerr} "
        f"(bar 1e-4); on all {n_slots} slots {kms} ms; one evaluation "
        f"(exchanges, gathers, K1, q_Fp, K2) {eval_ms:.3f} ms")
    out = {"atoms": run.n_atoms, "cells": list(dspec.cells),
           "cell_capacity": dspec.capacity, "slots": n_slots,
           "setup_s": setup_s, "rel_err_vs_flat": errs, "launches": counts,
           "kernel_rel_err": kerr, "kernel_ms": kms, "eval_ms": eval_ms,
           "ledger": ledger.snapshot()}
    del eng, nbh_l, typ, e, f, h, idx, nmask, dst, st, params, args
    torch.cuda.empty_cache()
    return out


def _legacy_autograd(torch, dev, spec, lat, moments, mesh) -> dict:
    """Phase L (b): the stencil and pruned autograd paths (and the kernel
    path) at f64 on B20 8^3 against the flat evaluation."""
    from repro_torch.core.potential import energy_forces_field, init_params
    from repro_torch.md.neighbor import dense_neighbor_table
    from repro_torch.md.state import init_state
    from repro_torch.parallel.domain import (distributed_energy_fn,
                                             distributed_energy_fn_pruned,
                                             distributed_kernel_force_fn)
    f64 = torch.float64
    g = torch.Generator(device=dev).manual_seed(11)
    st = init_state(lat, LEGACY_SMALL, generator=g, temperature=300.0,
                    spin_init="random", dtype=f64, device=dev)
    params = init_params(spec, torch.Generator(device=dev).manual_seed(7),
                         dtype=f64, device=dev)
    mom = moments.to(f64)
    field = torch.tensor([0.0, 0.0, 0.2], dtype=f64, device=dev)
    dspec, dst, aid = legacy_domain(torch, st, dev)
    tab = dense_neighbor_table(st.pos, st.box, spec.cutoff, 64)
    ef, ff, hf = energy_forces_field(spec, params, st.pos, st.spin, st.types,
                                     tab, st.box, field, mom)
    got, secs = {}, {}
    t0 = time.perf_counter()
    _, eff = distributed_energy_fn(spec, dspec, mesh, field=field,
                                   moments=mom)
    got["stencil"] = eff(params, dst)
    torch.cuda.synchronize()
    secs["stencil"] = time.perf_counter() - t0
    for name, make in (("pruned", distributed_energy_fn_pruned),
                       ("kernel", distributed_kernel_force_fn)):
        t0 = time.perf_counter()
        build, fn = make(spec, dspec, mesh, capacity=64, field=field,
                         moments=mom)
        got[name] = fn(params, dst.pos, dst.spin, dst.types, dst.mask,
                       *build(dst.pos, dst.types, dst.mask))
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    res = {name: (e, *_unbin(torch, aid, dev, f, h))
           for name, (e, f, h) in got.items()}
    errs = {"stencil_vs_flat": dict(zip("EFH", (
        _scaled_err(a, b) for a, b in zip(res["stencil"], (ef, ff, hf)))))}
    for name in ("pruned", "kernel"):
        errs[f"{name}_vs_stencil"] = dict(zip("EFH", (
            _scaled_err(a, b) for a, b in zip(res[name], res["stencil"]))))
    log(f"phase L (b): B20 {LEGACY_SMALL} = {st.pos.shape[0]} atoms f64, "
        f"grid {dspec.cells} x K = {dspec.capacity}, E {float(ef):.9f} eV; "
        f"errors (of max(|ref|, 1)) {errs}; seconds {secs}")
    for key, e in errs.items():
        be, bf = LEGACY_BARS[key.split("_")[0]]
        if not (e["E"] < be and e["F"] < bf and e["H"] < bf):
            raise AssertionError(f"phase L (b) {key}: {e} past ({be:g}, "
                                 f"{bf:g})")
    return {"atoms": int(st.pos.shape[0]), "cells": list(dspec.cells),
            "cell_capacity": dspec.capacity, "errors": errs, "seconds": secs}


def _legacy_roofline(reports) -> dict:
    """Phase L (c): ``roofline.nep_report``'s readings at the main path
    (phase 4) and the fitted spec (phase G); the main path's bounds must
    read phase 4's."""
    out = {}
    for name, rep in reports.items():
        if rep is None:
            log(f"phase L (c): {name}: not run in this mode")
            continue
        m = rep["measured"]
        row = {k: {f: m[k][f] for f in ("bound_ms", "bound_by", "bytes",
                                        "flops", "ms", "share_of_bound",
                                        "gflop_per_s", "gb_per_s")}
               for k in ("nep_atom_pass", "nep_force_pass")}
        row.update(n_atoms=m["n_atoms"], n_pairs=m["n_pairs"],
                   flops_ratio=rep["flops_ratio"],
                   analytic_flops=rep["analytic"]["flops"],
                   analytic_hbm_bytes=rep["analytic"]["hbm_bytes"])
        out[name] = row
        log(f"phase L (c): roofline.nep_report at the {name}: "
            f"{m['n_atoms']} atoms, {m['n_pairs']} pairs inside the cutoff; "
            + "; ".join(f"{k} {row[k]['ms']:.3f} ms, bound "
                        f"{row[k]['bound_ms']:.4f} ms ({row[k]['bound_by']}),"
                        f" {100 * row[k]['share_of_bound']:.2f}% of it, "
                        f"{row[k]['gflop_per_s']:.0f} GFLOP/s, "
                        f"{row[k]['gb_per_s']:.0f} GB/s"
                        for k in ("nep_atom_pass", "nep_force_pass"))
            + f"; counted / analytic FLOPs {rep['flops_ratio']:.3f}")
    main = out.get("main path")
    if main is not None:
        got = (round(main["nep_atom_pass"]["bound_ms"], 4),
               round(main["nep_force_pass"]["bound_ms"], 4))
        if got != MAIN_PATH_BOUNDS:
            raise AssertionError(f"main-path bounds {got} ms, expected "
                                 f"{MAIN_PATH_BOUNDS}")
    return out


# ---------------------------------------------------------------------------
# phase W: the LM zoo on a mesh
# ---------------------------------------------------------------------------

MESH_BUDGET_GIB = 60.0   # training state on one card (TRAIN_BUDGET_GIB)
MESH_B, MESH_ACCUM = 2, 2    # train_4k's rows a microbatch, accumulation
MESH_REF_STEPS = 2       # the one-rank step's losses and norms compared
# (tag, arch, sharding, mesh, moe_impl, positions a row, steps); the depth
# by train_depth at the per-rank budget, then cut to MESH_MAX_LAYERS (the
# phase's time: every collective of gloo ranks sharing the card crosses
# the host).  Each case reads its step 2 (they ran 3 steps, W(a) 5, until
# the script's time limit cut them to 2).
# fsdp at 512 positions: the reference's rules split the activations'
# d_model too, so every projection and each loss chunk's logits are
# all-reduced (~88 s a step at 4,096 positions on gloo ranks sharing
# an H100: PERF.md §6)
MESH_CASES = (("W(a)", "qwen2-7b", "dp", {"data": 2}, None, 4096, 2),
              ("W(b)", "qwen2-7b", "tp", {"model": 2}, None, 4096, 2),
              ("W(b)", "qwen2-7b", "fsdp", {"model": 2}, None, 512, 2),
              ("W(c)", "mamba2-2.7b", "tp", {"model": 2}, None, 4096, 2),
              ("W(d)", "moonshot-v1-16b-a3b", "tp", {"data": 1, "model": 2},
               "ep", 4096, 2))
MESH_MAX_LAYERS = {"qwen2-7b": 2, "mamba2-2.7b": 2,
                   "moonshot-v1-16b-a3b": 2}
# bf16 against the one-rank step at the same tp: T(b) found two bf16
# paths apart by rounding alone by up to ~3 % of a leaf's largest gradient
# (the embedding's most) and its loss bar is TRAIN_BF16_LOSS_BAR on one
# layout; a mesh adds the bf16 rounding of each partial sum before its
# reduction and another order of every reduction (dp sums each half's
# bf16 embedding gradient in f32: the one rank's bf16 sum over all rows
# is the coarser), so 5x each: the loss within 5e-3 and the gradient
# norm within 5e-2 (relative).  W(d) trains at the config's own capacity
# factor, where EP (per model-rank capacity) and the dense dispatch
# (global) drop different tokens: 2e-2 and 1e-1
MESH_LOSS_BAR, MESH_GNORM_BAR = 5e-3, 5e-2
MESH_EP_LOSS_BAR, MESH_EP_GNORM_BAR = 2e-2, 1e-1
# W(d)'s EP layer against the dense dispatch where neither drops (the
# capacity factor E/k): bf16 outputs of the same products on buffers of
# other shapes, 2e-2 of max |ref| (bf16 keeps 8 bits: 3.9e-3 an element)
MESH_EP_S, MESH_EP_BAR = 1024, 2e-2


def mesh_case_cfg(arch, mode, shape, moe_impl, sharing: int):
    """The case's config: full width, depth by ``train_depth`` at
    MESH_BUDGET_GIB over the ranks that share a card (``sharing``), times
    the ranks that share the state under tp / fsdp, then cut to
    MESH_MAX_LAYERS."""
    from repro_torch import configs
    from repro_torch.launch.train import depth_cut, train_depth
    full = configs.get(arch)
    world = math.prod(shape.values())
    budget = MESH_BUDGET_GIB / sharing * (world if mode != "dp" else 1)
    cfg, gib = train_depth(full, budget)
    if cfg.n_layers > MESH_MAX_LAYERS[arch]:
        cfg = depth_cut(full, MESH_MAX_LAYERS[arch])
    if moe_impl:
        cfg = dataclasses.replace(cfg, moe_impl=moe_impl)
    return cfg, budget, full.n_layers


def mesh_args(cfg, mode, shape, seq, steps, tp, seed=27):
    from repro_torch.launch.train import parse_args
    args = parse_args(["--arch", cfg.name, "--batch",
                       str(MESH_B * MESH_ACCUM), "--seq", str(seq),
                       "--steps", str(steps), "--accum", str(MESH_ACCUM),
                       "--lr", str(TRAIN_LR), "--seed", str(seed),
                       "--log-every", "1", "--device", "cuda",
                       "--sharding", mode, "--tp", str(tp)])
    args.mesh = ",".join(f"{k}={v}" for k, v in shape.items())
    return args


def _mesh_tp(shape) -> int:
    return shape.get("model", 1)


def _lm_mesh_ref(rank: int, refs, out: str) -> None:
    """Phase W's one-rank steps, one after another in this process (each
    one's memory freed before the next): ``train_lm`` with no mesh at the
    case's tp, MESH_REF_STEPS steps, FA / SSD launches a step and the
    MoE drops.  ``refs``: (cfg, tp, positions a row)."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.train import train_lm
    from repro_torch.models import moe
    res = []
    for cfg, tp, seq in refs:
        args = mesh_args(cfg, "tp", {}, seq, MESH_REF_STEPS, tp)
        args.mesh = None
        reset_train_counters()
        moe.DROPS = [] if cfg.moe is not None else None
        torch.cuda.reset_peak_memory_stats()
        run = train_lm(args, cfg_override=cfg)
        got = read_train_counters()
        res.append({"rows": run["rows"], "launches": got,
                    "dropped": sum(moe.DROPS or []),
                    "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
        moe.DROPS = None
        del run
        torch.cuda.empty_cache()
    with open(out, "w") as f:
        json.dump(res, f)


def _ep_layer_check(torch, cfg, mesh) -> dict:
    """W(d) (a): one MoE layer of ``cfg`` (its widths, bf16) through the
    expert-parallel path on ``mesh`` against the dense dispatch on the
    same tokens, at capacity factor E/k (neither path can drop)."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models import moe
    from repro_torch.parallel import sharding as sh
    m = cfg.moe
    cf = m.n_experts / m.top_k
    c2 = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=cf), moe_impl="ep")
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    gen = torch.Generator(device=dev).manual_seed(31)
    p = moe.init_moe(c2, gen, getattr(torch, cfg.dtype), dev)
    x = torch.randn((MESH_B, MESH_EP_S, cfg.d_model), generator=gen,
                    device=dev).to(getattr(torch, cfg.dtype))
    moe.DROPS = []
    want, _ = moe.apply_moe_dense(c2, p, x)
    dense_drops = sum(moe.DROPS)
    pl = sh.param_shardings(mesh, {"moe": p}, "tp")["moe"]
    dp = {k: distribute_tensor(v, mesh, pl[k], src_data_rank=None)
          for k, v in p.items()}
    xd = distribute_tensor(x, mesh, sh.placements(mesh, sh.resolve_spec(
        mesh, ("batch",), (MESH_B,))), src_data_rank=None)
    moe.DROPS = []
    with sh.use_mesh(mesh, "tp"):
        y, _ = moe.apply_moe(c2, dp, xd)
    got = y.full_tensor()
    drops = [None] * dist.get_world_size()
    dist.all_gather_object(drops, sum(moe.DROPS))
    moe.DROPS = None
    err = rel_err(got.float(), want.float())
    return {"capacity_factor": cf, "tokens": MESH_B * MESH_EP_S,
            "dense_dropped": dense_drops, "ep_dropped_by_rank": drops,
            "max_rel_err": err, "bar": MESH_EP_BAR}


def _lm_mesh_rank(rank: int, cases, out: str) -> None:
    """Phase W's mesh runs on one of two ranks (gloo ranks on the one
    card, or NCCL ranks on cards of their own): each case through
    ``launch/train.py:train_lm_on_mesh``, the rank loop ``train_lm
    --mesh`` spawns, with this rank's FA / SSD launches, the SSD
    backward's cluster size and the MoE drops; W(d) first holds its EP
    layer against the dense dispatch."""
    import faulthandler
    import torch
    import torch.distributed as dist
    faulthandler.enable()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.ssd import kernel as ssd
    from repro_torch.launch.train import make_mesh, train_lm_on_mesh
    from repro_torch.models import moe
    from repro_torch.models.ssm import ssm_dims
    res = []
    for cfg, mode, shape, seq, steps in cases:
        args = mesh_args(cfg, mode, shape, seq, steps, _mesh_tp(shape))
        mesh = make_mesh(args)
        case = {}
        if cfg.moe is not None and cfg.moe_impl == "ep":
            case["ep_layer"] = _ep_layer_check(torch, cfg, mesh)
            torch.cuda.empty_cache()
        reset_train_counters()
        moe.DROPS = [] if cfg.moe is not None else None
        torch.cuda.reset_peak_memory_stats()
        run = train_lm_on_mesh(args, cfg, mesh)
        launches = read_train_counters()
        dropped = sum(moe.DROPS or [])
        moe.DROPS = None
        if cfg.ssm is not None:
            _, nh = ssm_dims(cfg)
            h_loc = nh // _mesh_tp(shape)
            g_loc = max(1, cfg.ssm.n_groups // _mesh_tp(shape))
            case["ssd_cluster_k"] = ssd.cluster_heads(h_loc // g_loc)
        mine = {"launches": launches, "dropped": dropped,
                "ssd_cluster_k": case.get("ssd_cluster_k")}
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, mine)
        case.update(rows=run["rows"], peak_gib=run["peak_gib"],
                    backend=run["backend"], tp=run["tp"], ranks=ranks)
        res.append(case)
        del run
        torch.cuda.empty_cache()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)


def _per_step(launches: dict, steps: int) -> dict:
    return {k: (v // steps if isinstance(v, int) else
                {b_: c // steps for b_, c in v.items()})
            for k, v in launches.items()}


def phase_mesh(torch, dev) -> dict:
    """Phase W: the LM zoo on a mesh of two ranks (``MESH_CASES``)."""
    from repro_torch.models import lm
    from repro_torch.models.attention import pad_heads
    from repro_torch.models.ssm import ssm_dims
    from repro_torch.parallel.ranks import spawn
    t_start = time.perf_counter()
    world = 2
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    sharing = 1 if backend == "nccl" else world
    log(f"phase W: the LM zoo on a mesh of {world} ranks: {backend}"
        + (" ranks sharing the one card (no scaling measurement; their "
           "all-gathers of CUDA tensors staged through the host)"
           if sharing > 1 else ", a card each"))
    cases, meta, refs, ref_of = [], [], [], []
    for tag, arch, mode, shape, impl, seq, steps in MESH_CASES:
        cfg, budget, full_layers = mesh_case_cfg(arch, mode, shape, impl,
                                                 sharing)
        tp = _mesh_tp(shape)
        # one one-rank run serves every case with the same parameters
        # (shapes at the case's tp, drawn from the same seed) and batch
        key = (arch, cfg.n_layers, seq, tuple(
            (k, tuple(v.shape)) for k, v in sorted(_flat(
                lm.abstract_params(cfg, tp=tp)).items())))
        keys = [r[0] for r in refs]
        if key not in keys:
            refs.append((key, (cfg, tp, seq)))
            keys.append(key)
        ref_of.append(keys.index(key))
        cases.append((cfg, mode, shape, seq, steps))
        meta.append({"case": tag, "arch": arch, "sharding": mode,
                     "mesh": shape, "moe_impl": impl, "seq": seq,
                     "steps": steps, "n_layers": cfg.n_layers,
                     "full_layers": full_layers, "budget_gib": budget})
        log(f"  {tag} {arch} {mode} on {shape}: depth {cfg.n_layers} of "
            f"{full_layers} (per-rank budget {budget:g} GiB, cut to "
            f"{MESH_MAX_LAYERS[arch]}), B={MESH_B} x S={seq} a microbatch, "
            f"accum {MESH_ACCUM}, {steps} steps; one-rank run "
            f"{ref_of[-1]}")
    wdir = ROOT / "build" / "chip_smoke" / "mesh"
    wdir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    spawn(_lm_mesh_ref, 1, [r[1] for r in refs], str(wdir / "ref.json"),
          backend="gloo", workdir=str(wdir))
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    spawn(_lm_mesh_rank, world, cases, str(wdir / "mesh.json"),
          backend=backend, workdir=str(wdir))
    mesh_s = time.perf_counter() - t0
    ref_runs = json.loads((wdir / "ref.json").read_text())
    runs = json.loads((wdir / "mesh.json").read_text())
    out = {"backend": backend, "ranks_a_card": sharing, "cases": []}
    for (cfg, mode, shape, seq, steps), m, ri, run in zip(cases, meta,
                                                          ref_of, runs):
        ref = ref_runs[ri]
        tag = f"{m['case']} {m['arch']} {mode}"
        ep = cfg.moe is not None and cfg.moe_impl == "ep"
        lbar, gbar = ((MESH_EP_LOSS_BAR, MESH_EP_GNORM_BAR) if ep else
                      (MESH_LOSS_BAR, MESH_GNORM_BAR))
        errs = []
        for i in range(MESH_REF_STEPS):
            for key, bar in (("loss", lbar), ("grad_norm", gbar)):
                a, b = run["rows"][i][key], ref["rows"][i][key]
                e = abs(a - b) / abs(b)
                errs.append(e)
                if not (math.isfinite(a) and e < bar):
                    raise AssertionError(f"{tag}: step {i + 1} {key} {a} "
                                         f"vs one-rank {b} (rel {e:.3e}, "
                                         f"bar {bar:g})")
        expect, (body, bwd_body, ssd_body) = train_launches(
            torch, cfg, steps * MESH_ACCUM)
        one = _per_step(ref["launches"], MESH_REF_STEPS)
        for r, rk in enumerate(run["ranks"]):
            if rk["launches"] != expect:
                raise AssertionError(f"{tag}: rank {r} launches "
                                     f"{rk['launches']}, expected {expect}")
            if _per_step(rk["launches"], steps) != one:
                raise AssertionError(f"{tag}: rank {r} launches a step "
                                     f"{_per_step(rk['launches'], steps)}, "
                                     f"one rank {one}")
        if ep:
            el = run["ep_layer"]
            if el["dense_dropped"] or any(el["ep_dropped_by_rank"]):
                raise AssertionError(f"{tag}: EP layer at cf "
                                     f"{el['capacity_factor']} dropped {el}")
            if not el["max_rel_err"] < MESH_EP_BAR:
                raise AssertionError(f"{tag}: EP vs dense {el}")
            log(f"  {tag}: EP layer vs dense dispatch at cf "
                f"{el['capacity_factor']:.3f} on {el['tokens']} tokens: 0 "
                f"dropped, rel err {el['max_rel_err']:.3e} (bar "
                f"{MESH_EP_BAR:g})")
        steady = sorted(r["s"] for r in run["rows"][1:])
        med = steady[len(steady) // 2]
        tokens = MESH_B * MESH_ACCUM * seq
        red = sorted(r["reduce_s"] for r in run["rows"][1:])
        a_step = _per_step(expect, steps)
        row = dict(m, backend=run["backend"], tp=run["tp"],
                   rows=run["rows"], ref_rows=ref["rows"],
                   max_rel_err_vs_one_rank=max(errs),
                   loss_bar=lbar, grad_norm_bar=gbar,
                   step_s_median=med, global_tokens_per_s=tokens / med,
                   grad_reduction_s_median=red[len(red) // 2],
                   peak_gib_by_rank=run["peak_gib"],
                   one_rank_peak_gib=ref["peak_gib"],
                   launches_a_step_by_rank=[_per_step(rk["launches"], steps)
                                            for rk in run["ranks"]],
                   fa_body=body, fa_bwd_body=bwd_body, ssd_body=ssd_body)
        split = _mesh_tp(shape) if mode == "tp" else 1
        if cfg.n_heads:
            hp = pad_heads(cfg.n_heads, run["tp"])
            kvp = (cfg.kv_heads if cfg.kv_heads <= run["tp"] else
                   pad_heads(cfg.kv_heads, run["tp"]))
            row["q_kv_heads_a_rank"] = (hp // split, kvp // split
                                        if kvp % split == 0 else kvp)
        if cfg.ssm is not None:
            row["ssd_heads_a_rank"] = ssm_dims(cfg)[1] // split
            row["ssd_cluster_k_by_rank"] = [rk["ssd_cluster_k"]
                                            for rk in run["ranks"]]
        if cfg.moe is not None:
            row["experts_a_rank"] = cfg.moe.n_experts // split
            row["dropped_a_step_by_rank"] = [rk["dropped"] / steps
                                             for rk in run["ranks"]]
            row["one_rank_dropped_a_step"] = ref["dropped"] / MESH_REF_STEPS
            row["ep_layer"] = run.get("ep_layer")
        out["cases"].append(row)
        log(f"  {tag}: losses {[round(r['loss'], 4) for r in run['rows']]} "
            f"(one rank {[round(r['loss'], 4) for r in ref['rows']]}), "
            f"worst rel {max(errs):.3e}; median step {med:.3f} s = "
            f"{tokens / med:.1f} global tokens/s; gradient reduction "
            f"{row['grad_reduction_s_median']:.3f} s; peak GiB by rank "
            f"{[p if p is None else round(p, 2) for p in run['peak_gib']]}"
            f" (one rank {ref['peak_gib']:.2f}); a step a rank: FA "
            f"{a_step['fwd']} "
            f"fwd ({body}) + {a_step['bwd']} bwd ({bwd_body}), SSD "
            f"{a_step['ssd_fwd']} fwd + {a_step['ssd_bwd']} bwd "
            f"({ssd_body})"
            + (f"; q / kv heads a rank {row['q_kv_heads_a_rank']}"
               if cfg.n_heads else "")
            + (f"; {row['ssd_heads_a_rank']} SSD heads a rank, backward "
               f"cluster K by rank {row['ssd_cluster_k_by_rank']}"
               if cfg.ssm is not None else "")
            + (f"; {row['experts_a_rank']} experts a rank"
               if cfg.moe is not None else "")
            + (f"; dropped (token, choice) pairs a step by rank "
               f"{row['dropped_a_step_by_rank']}, one rank "
               f"{row['one_rank_dropped_a_step']}"
               if cfg.moe is not None else ""))
    out.update(ref_s=ref_s, mesh_s=mesh_s,
               seconds=time.perf_counter() - t_start)
    log(f"phase W: {len(cases)} cases in {out['seconds']:.1f} s ("
        f"{len(refs)} one-rank runs {ref_s:.1f} s, mesh {mesh_s:.1f} s)")
    return out


def _stop(proc) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def phase_ci(torch, dev, dry) -> dict:
    """Phase X: the kernel and engine smokes on the card, and the LM dry
    run's cells from ``dry`` (the background process of
    :func:`start_dryrun` on ``DRY_LM_CELLS``)."""
    from repro_torch.launch import engine_smoke, kernel_smoke, report
    t_phase = time.perf_counter()
    out = {}
    log("phase X (a): launch/kernel_smoke.py on the card")
    out["kernel_smoke"] = kernel_smoke.main(["--device", "cuda"])
    ks = out["kernel_smoke"]
    log(f"  K1 {ks['bodies']['K1']} / K2 {ks['bodies']['K2']} bodies, "
        f"launches {ks['launches']}, parity {ks['parity']}, "
        f"{ks['ratio']:.2f}x the plain versions ({ks['ms']:.3f} vs "
        f"{ks['plain_ms']:.3f} ms), builds/loads {ks['builds']}")
    torch.cuda.empty_cache()
    log("phase X (b): launch/engine_smoke.py on two gloo ranks sharing "
        "the card")
    t0 = time.perf_counter()
    out["engine_smoke"] = engine_smoke.main(["--device", "cuda"])
    out["engine_smoke"]["seconds"] = time.perf_counter() - t0
    es = out["engine_smoke"]
    log(f"  {es['ranks']} ranks, {es['chunks']} chunk records, halo "
        f"{es['halo']['counts']}, resume bitwise {es['resume_bitwise']}, "
        f"{es['seconds']:.1f} s")
    log("phase X (c): the LM dry run's cells (host, fake worlds), started "
        "after phase 1")
    t0 = time.perf_counter()
    try:
        text, _ = dry.communicate(timeout=DRY_LM_TIMEOUT)
    finally:
        _stop(dry)
    log(f"  waited {time.perf_counter() - t0:.1f} s for it")
    for line in text.splitlines():
        if not line.startswith("[rank"):
            log("  " + line)
    if dry.returncode != 0:
        raise AssertionError(f"the LM dry run exited with {dry.returncode}")
    recs = {(r["arch"], r["shape"], bool(r["mesh"].get("pod"))): r
            for r in report.load_all(str(DRY_LM_DIR))}
    out["dryrun"] = {}
    for cell in DRY_LM_CELLS:
        r = recs.get(tuple(cell))
        if r is None or "roofline" not in r:
            raise AssertionError(f"LM dry run: no record for {cell}: "
                                 f"{None if r is None else r.get('error')}")
        rf = r["roofline"]
        tag = f"{cell[0]}__{cell[1]}__{'pod2' if cell[2] else 'pod1'}"
        out["dryrun"][tag] = {
            "flops_per_rank": r["flops_total"],
            "bytes_per_rank": r["bytes_total"],
            "bytes_naive_per_rank": r["bytes_naive"],
            "collectives": r["collectives"], "memory": r["memory"],
            "fits": r["card"]["fits"], "bottleneck": rf["bottleneck"],
            "step_time_s": rf["step_time_s"], "elapsed_s": r["elapsed_s"]}
        log(f"  {tag}: {r['flops_total']:.4e} FLOP/rank, "
            f"{r['bytes_total']:.4e} B/rank, collectives "
            f"{ {k: (v['count'], v['bytes']) for k, v in r['collectives'].items()} }, "
            f"fits {r['card']['fits']}, bound {rf['bottleneck']}, "
            f"{r['elapsed_s']} host s")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase X: {out['phase_s']:.1f} s")
    return out


BENCH_DIR = SURFACE_DIR / "bench"
# the whole run's phase Y, cut for the script's time limit to the drivers
# whose rows launch kernels; the others drive paths that earlier phases
# drive at card scale (scaling: J, K; accuracy: G; ensemble: F; serve: I;
# md_loop: D; ablation: the autograd evaluation of phase 4's geometry)
# and run with --bench-only
BENCH_WHOLE_RUN = ("kernels", "throughput")


def phase_bench(torch, names=None) -> dict:
    """Phase Y: ``launch/bench_run.py`` on the card, each driver of
    ``names`` (default: the whole registry) in a child process (on the
    card ``kernel_rows`` and ``throughput --kernel`` fail if a kernel of
    their rows launched no time); returns each driver's own JSON, its CSV
    rows left out (the drivers print them), and the kernels' launches by
    body in those two."""
    import shutil

    from repro_torch.launch import bench_run
    names = list(names or bench_run.REGISTRY)
    log(f"phase Y: launch/bench_run.py --strict on the card: {names}")
    t0 = time.perf_counter()
    shutil.rmtree(BENCH_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    res = bench_run.main(["--device", "cuda", "--strict", "--out",
                          str(BENCH_DIR), "--only", ",".join(names)])
    if not res["ok"]:
        raise AssertionError(f"benchmark drivers failed: {res['failed']}")
    out = {"drivers": res["drivers"]}
    for name in names:
        out[name] = json.loads(bench_run.result_path(BENCH_DIR, name)
                               .read_text())
        out[name].pop("rows", None)
    out["launches"] = {"kernel_rows": out["kernels"]["launches"],
                       "throughput": out["throughput"]["kernel"]["launches"]}
    out["phase_s"] = time.perf_counter() - t0
    for name, d in res["drivers"].items():
        log(f"  {name}: {d['seconds']:.1f} s")
    log(f"  launches: {out['launches']}; throughput --kernel bodies "
        f"{out['throughput']['kernel']['bodies']}, largest N "
        f"{out['throughput']['kernel']['largest_n']}")
    log(f"phase Y: {out['phase_s']:.1f} s")
    return out


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def main(argv) -> int:
    if argv not in ([], ["--serve-only"], ["--sharded-only"],
                    ["--legacy-only"], ["--lm-only"], ["--train-only"],
                    ["--mesh-only"], ["--ci-only"], ["--bench-only"]):
        print("usage: chip_smoke.py [--serve-only | --sharded-only | "
              "--legacy-only | --lm-only | --train-only | --mesh-only | "
              "--ci-only | --bench-only]", file=sys.stderr)
        return 2
    t_script = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} is missing; run "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import _build
    from repro_torch.configs.fege_spinlattice import config, main_path
    from repro_torch.core.potential import (NEPSpinParams, NEPSpinPotential,
                                            compute, init_params)
    from repro_torch.kernels.nep import kernel as kern
    from repro_torch.kernels.nep import ref
    from repro_torch.kernels.nep.layout import unpack_abar
    from repro_torch.kernels.nep.ops import nep_compute
    from repro_torch.launch import roofline
    from repro_torch.md.engine import Engine
    from repro_torch.md.integrator import IntegratorConfig
    from repro_torch.md.lattice import b20_fege
    from repro_torch.md.neighbor import cell_neighbor_table, gather_blocks
    from repro_torch.md.state import init_state, temperature_of

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- phase 1: card, build ---------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"phase 1: built {sorted(secs)} in {time.perf_counter() - t0:.1f} s "
        f"(per library: { {k: round(v, 1) for k, v in secs.items()} })")
    ptxas = {}
    for name in _build.SOURCES:
        ptxas[name] = ptxas_report(
            _build.library_path(name).with_suffix(".log").read_text())
        for kernel, rep in ptxas[name].items():
            if "registers" in rep:
                log(f"  ptxas {name}: {kernel}: {rep}")

    spec = config().spec
    lat = b20_fege()
    moments = torch.tensor([1.16, 0.0], device=dev)
    if argv == ["--serve-only"]:
        print(json.dumps({"serving": phase_serve(torch, dev, spec, kern,
                                                 ref)}), flush=True)
        print(card, flush=True)
        return 0
    if argv == ["--sharded-only"]:
        sharded = phase_sharded(torch, dev, spec, lat, moments, kern, ref,
                                None)
        print(json.dumps({"sharded": sharded}), flush=True)
        print(json.dumps({"sharded_replicas": phase_sharded_replicas(
            torch, dev, spec, lat, moments, kern, ref,
            sharded["one_rank"]["steps_per_s"])}), flush=True)
        print(card, flush=True)
        return 0
    if argv == ["--legacy-only"]:
        print(json.dumps({"legacy": phase_legacy(
            torch, dev, spec, lat, moments, kern, ref,
            {"main path": None, "fitted spec": None})}), flush=True)
        print(card, flush=True)
        return 0
    if argv == ["--lm-only"]:
        rows = lm_phases(torch, dev, ptxas)
        zoo = lm_zoo_phases(torch, dev, ptxas, rows[-1])
        print(json.dumps({"lm_zoo": zoo}), flush=True)
        print(card, flush=True)
        print(json.dumps({"kernels": rows}), flush=True)
        return 0
    if argv == ["--mesh-only"]:
        print(json.dumps({"lm_mesh": phase_mesh(torch, dev)}), flush=True)
        print(card, flush=True)
        return 0
    if argv == ["--ci-only"]:
        from repro_torch.launch import ci_smoke
        res = ci_smoke.main(["--device", "cuda"])
        print(json.dumps({"ci_smoke": res}), flush=True)
        print(card, flush=True)
        return 0 if res["ok"] else 1
    if argv == ["--bench-only"]:
        print(json.dumps({"bench": phase_bench(torch)}), flush=True)
        print(card, flush=True)
        return 0
    if argv == ["--train-only"]:
        fa_row = {"name": "flash_attention_fwd"}
        lm_train, bwd_row = lm_train_phases(torch, dev, ptxas, fa_row)
        print(json.dumps({"lm_train": lm_train}), flush=True)
        torch.cuda.empty_cache()
        ssd_row = {"name": "ssd_chunks"}
        ssm_train, ssd_bwd_row = ssm_train_phases(torch, dev, ptxas, ssd_row)
        print(json.dumps({"ssm_train": ssm_train}), flush=True)
        print(card, flush=True)
        print(json.dumps({"kernels": [fa_row, bwd_row, ssd_row,
                                      ssd_bwd_row]}), flush=True)
        return 0

    # phase X (c) runs on the host beside everything up to phase X
    import atexit
    import shutil
    shutil.rmtree(DRY_LM_DIR, ignore_errors=True)
    dry_lm = start_dryrun(DRY_LM_CELLS, DRY_LM_DIR)
    atexit.register(_stop, dry_lm)

    # ---- phase 2: kernels vs plain versions, 4,096 atoms --------------------
    log("phase 2: kernels vs plain versions, B20 8x8x8, production spec")
    errs = {name: {} for name in KERNELS}
    gen = torch.Generator(device=dev).manual_seed(7)
    p64 = init_params(spec, gen, dtype=torch.float64, device=dev)
    for dtype, bar, tag in ((torch.float64, 1e-9, "f64"),
                            (torch.float32, 1e-4, "f32")):
        g = torch.Generator(device=dev).manual_seed(11)
        st = init_state(lat, (8, 8, 8), generator=g, spin_init="random",
                        dtype=dtype, device=dev)
        pos = torch.remainder(st.pos + 0.08 * torch.randn(
            st.pos.shape, generator=g, dtype=dtype, device=dev), st.box)
        params = NEPSpinParams(*(p.to(dtype) for p in p64))
        tab = cell_neighbor_table(pos, st.box, spec.cutoff, 64,
                                  cell_capacity=32)
        nbh = gather_blocks(pos, st.types, tab, st.box)
        sj = st.spin[nbh.idx.long()]
        blocks = (nbh.dr, nbh.mask, st.types, nbh.tj, st.spin, sj)
        want = ref.atom_pass_plain(spec, params, *blocks)
        wl = unpack_abar(spec, want[2])
        for body in kern.BODIES:
            got = kern.nep_atom_pass(spec, params, *blocks, body=body)
            torch.cuda.synchronize()
            worst = max(check(f"K1 {body} e {tag}", got[0], want[0], bar),
                        check(f"K1 {body} hdir {tag}", got[1], want[1], bar))
            gl = unpack_abar(spec, got[2])
            for k in wl:
                worst = max(worst, check(f"K1 {body} abar.{k} {tag}", gl[k],
                                         wl[k], bar))
            if body == kern.atom_pass_body(spec):
                errs["nep_atom_pass"][tag] = worst
        k2_args = (spec, params, nbh.dr, nbh.mask, nbh.idx, st.types, nbh.tj,
                   st.spin, sj, want[2])
        fp = ref.force_pass_plain(*k2_args)
        for body in kern.BODIES:
            fk = kern.nep_force_pass(*k2_args, body=body)
            torch.cuda.synchronize()
            err = max(check(f"K2 {body} F {tag}", fk[0], fp[0], bar),
                      check(f"K2 {body} h2 {tag}", fk[1], fp[1], bar))
            if body == kern.force_pass_body(spec):
                errs["nep_force_pass"][tag] = err
        field = torch.tensor([0.0, 0.0, 0.2], dtype=dtype, device=dev)
        mom = moments.to(dtype)
        ek = nep_compute(spec, params, nbh, st.spin, st.types, field, mom)
        ea = compute(spec, params, nbh, st.spin, st.types, field, mom)
        for name, a, b in zip("EFH", ek, ea):
            check(f"nep_compute {name} {tag}", a, b, bar)

    # ---- phase 3: the main path ---------------------------------------------
    run = main_path()
    log(f"phase 3: Engine main path, B20 {run.unit_cells} = {run.n_atoms} "
        f"atoms, {run.chunks} x {run.chunk} steps, T={run.temperature} K, "
        f"B={run.field} T")
    dtype = getattr(torch, run.dtype)
    g = torch.Generator(device=dev).manual_seed(0)
    state = init_state(lat, run.unit_cells, generator=g,
                       temperature=run.temperature, dtype=dtype, device=dev)
    params = init_params(spec, g, dtype=dtype, device=dev)
    pot = NEPSpinPotential(spec, params, moments.to(dtype), use_kernel=True)
    cfg = IntegratorConfig(dt=run.dt, lattice_gamma=run.lattice_gamma,
                           spin_alpha=run.spin_alpha)
    masses = torch.tensor(lat.masses, dtype=dtype, device=dev)
    magnetic = torch.tensor(lat.moments, device=dev) > 0
    for fn in (kern.nep_atom_pass, kern.nep_force_pass):
        fn.launches = 0
        fn.body_launches = dict.fromkeys(kern.BODIES, 0)
    t0 = time.perf_counter()
    eng = Engine(pot, cfg, state, masses, magnetic, spec.cutoff,
                 temperature=run.temperature, field=run.field,
                 capacity=run.capacity, skin=run.skin, use_cell_list=True,
                 cell_capacity=run.cell_capacity, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    steps = run.chunks * run.chunk
    t0 = time.perf_counter()
    eng.run(steps, g, chunk=run.chunk)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    flat_rate = steps / run_s
    launches = {"nep_atom_pass": kern.nep_atom_pass.launches,
                "nep_force_pass": kern.nep_force_pass.launches}
    body_launches = {"nep_atom_pass": dict(kern.nep_atom_pass.body_launches),
                     "nep_force_pass": dict(
                         kern.nep_force_pass.body_launches)}
    st, ff = eng.state, eng._ff
    expect = 1 + steps + eng.n_rebuilds
    log(f"  grid {eng._n_cells}, setup {setup_s:.2f} s, {steps} steps in "
        f"{run_s:.3f} s = {steps / run_s:.3f} steps/s, "
        f"rebuilds {eng.n_rebuilds}, launches {launches} "
        f"(expect {expect} each), by body {body_launches}")
    for name, n in launches.items():
        if n != expect:
            raise AssertionError(f"{name} launched {n} times, expected "
                                 f"1 + steps + rebuilds = {expect}")
        if body_launches[name] != {"warp": expect, "thread": 0}:
            raise AssertionError(f"{name} launches by body "
                                 f"{body_launches[name]}: the main path "
                                 "must run the warp body only")
    for name, t in (("pos", st.pos), ("vel", st.vel), ("spin", st.spin),
                    ("force", ff.force), ("field", ff.field)):
        if t.shape != (run.n_atoms, 3) or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: shape {tuple(t.shape)} or "
                                 "non-finite values")
    fe = magnetic[st.types.long()]
    spin_dev = float((torch.linalg.norm(st.spin[fe], dim=-1) - 1).abs().max())
    log(f"  state finite; {int(fe.sum())} Fe spins, max ||S|-1| = "
        f"{spin_dev:.3e}; energy {float(ff.energy):.6f} eV; "
        f"observables {[(k, v.tolist()) for k, v in eng.trace.values.items()]}")
    if not spin_dev < 1e-4:
        raise AssertionError(f"|S| drifted by {spin_dev}")
    t_random = float(temperature_of(st, masses))
    log(f"  lattice temperature after {steps} steps (random weights): "
        f"{t_random:.1f} K")

    # ---- phase 4: at the main path's shapes: compare, time, bound ----------
    log("phase 4: kernels at the main path's shapes (f32)")
    c = eng._carry
    nbh, spin, types = c.nbh, c.state.spin, c.state.types
    sj = spin[nbh.idx.long()]
    blocks = (nbh.dr, nbh.mask, types, nbh.tj, spin, sj)
    n_atoms = spin.shape[0]
    n_pairs = roofline.pairs_inside(nbh.dr, nbh.mask, spec.cutoff)
    log(f"  {n_atoms} atoms x {nbh.mask.shape[1]} slots, "
        f"{int(nbh.mask.sum())} pairs in the table, {n_pairs} inside the "
        "cutoff")
    k1 = kern.nep_atom_pass(spec, params, *blocks)
    p1 = ref.atom_pass_plain(spec, params, *blocks)
    k1_thread = kern.nep_atom_pass(spec, params, *blocks, body="thread")
    k2 = kern.nep_force_pass(spec, params, nbh.dr, nbh.mask, nbh.idx, types,
                             nbh.tj, spin, sj, p1[2])
    k2_thread = kern.nep_force_pass(spec, params, nbh.dr, nbh.mask, nbh.idx,
                                    types, nbh.tj, spin, sj, p1[2],
                                    body="thread")
    p2 = ref.force_pass_plain(spec, params, nbh.dr, nbh.mask, nbh.idx, types,
                              nbh.tj, spin, sj, p1[2])
    torch.cuda.synchronize()
    for o, a, b in zip(("e", "hdir", "abar"), k1_thread, p1):
        check(f"K1 thread {o} main", a, b, 1e-4)
    for o, a, b in zip(("F", "h2"), k2_thread, p2):
        check(f"K2 thread {o} main", a, b, 1e-4)
    del k1_thread, k2_thread
    main_err = {
        "nep_atom_pass": (max(check(f"K1 {o} main", a, b, 1e-4) for o, a, b
                              in zip(("e", "hdir", "abar"), k1, p1)),
                          max(float((a - b).abs().max())
                              for a, b in zip(k1, p1))),
        "nep_force_pass": (max(check(f"K2 {o} main", a, b, 1e-4) for o, a, b
                               in zip(("F", "h2"), k2, p2)),
                           max(float((a - b).abs().max())
                               for a, b in zip(k2, p2))),
    }
    k1_args = (spec, params, *blocks)
    k2_args = (spec, params, nbh.dr, nbh.mask, nbh.idx, types, nbh.tj, spin,
               sj, k1[2])
    # each kernel's bodies in turns: warp, thread, thread, warp
    calls = {"nep_atom_pass": (kern.nep_atom_pass, k1_args),
             "nep_force_pass": (kern.nep_force_pass, k2_args)}
    by_body = {}
    for name, (fn, fargs) in calls.items():
        by_body[name] = {"warp": [], "thread": []}
        for body in ("warp", "thread", "thread", "warp"):
            by_body[name][body].append(time_ms(
                torch, lambda: fn(*fargs, body=body), 20))
        log(f"  {name} by body, in turns (ms): {by_body[name]}")
    ms = {name: sum(t["warp"]) / 2 for name, t in by_body.items()}
    ptx = {"nep_atom_pass": (PTXAS_K1_WARP, PTXAS_K1_THREAD),
           "nep_force_pass": (PTXAS_K2_WARP, PTXAS_K2_THREAD)}
    extra = {name: {"body": "warp",
                    "previous_ms": sum(by_body[name]["thread"]) / 2,
                    "previous_body": "thread",
                    "ptxas": ptxas_of(ptxas, *ptx[name][0]),
                    "previous_ptxas": ptxas_of(ptxas, *ptx[name][1])}
             for name in calls}
    plain_ms = {"nep_atom_pass": time_ms(torch, lambda: ref.atom_pass_plain(
                    *k1_args), 2),
                "nep_force_pass": time_ms(torch, lambda: ref.force_pass_plain(
                    *k2_args), 2)}
    work = {
        "nep_atom_pass": roofline.atom_pass_work(spec, params, *blocks, k1,
                                                 n_pairs),
        "nep_force_pass": roofline.force_pass_work(*k2_args, k2, n_pairs),
    }
    step_ms = 1e3 * run_s / steps
    rows = []
    for name, (b, f) in work.items():
        meta = KERNELS[name]
        bd = roofline.bound(b, f, dtype)
        t_bytes, t_ops, bound = bd["bytes_ms"], bd["ops_ms"], bd["bound_ms"]
        log(f"  {name}: {ms[name]:.3f} ms (plain {plain_ms[name]:.1f} ms); "
            f"{b / 1e6:.1f} MB -> {t_bytes:.4f} ms, {f / 1e9:.2f} GFLOP -> "
            f"{t_ops:.4f} ms; bound {bound:.4f} ms = "
            f"{100 * bound / ms[name]:.2f}% of the kernel's time")
        rows.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[name],
            "max_abs_err": main_err[name][1],
            "max_rel_err_f32": max(errs[name]["f32"], main_err[name][0]),
            "max_rel_err_f64": errs[name]["f64"],
            "ms": ms[name], "plain_ms": plain_ms[name], "bound_ms": bound,
            "bound_by": bd["bound_by"], "library_ms": None, **extra[name],
        })
    log(f"  main path step {step_ms:.2f} ms, of which K1 + K2 "
        f"{ms['nep_atom_pass'] + ms['nep_force_pass']:.2f} ms per evaluation")
    # the roofline module's record at this geometry (phase L (c) reads it)
    main_report = roofline.nep_report(spec, params, nbh, spin, types)
    del eng, c, nbh, blocks, k1, p1, k2, p2, state, st, ff
    torch.cuda.empty_cache()

    rows += lm_phases(torch, dev, ptxas)
    torch.cuda.empty_cache()
    print(json.dumps({"lm_zoo": lm_zoo_phases(torch, dev, ptxas, rows[-1])}),
          flush=True)
    torch.cuda.empty_cache()
    dry_md = start_md_dryrun()         # phase L (d), beside phases S to V
    atexit.register(_stop, dry_md)
    lm_train, bwd_row = lm_train_phases(torch, dev, ptxas, rows[-1])
    rows.append(bwd_row)
    print(json.dumps({"lm_train": lm_train}), flush=True)
    torch.cuda.empty_cache()
    ssd_row = next(r for r in rows if r["name"] == "ssd_chunks")
    ssm_train, ssd_bwd_row = ssm_train_phases(torch, dev, ptxas, ssd_row)
    rows.append(ssd_bwd_row)
    print(json.dumps({"ssm_train": ssm_train}), flush=True)
    torch.cuda.empty_cache()
    mesh = phase_mesh(torch, dev)
    by_case = {(c["case"], c["sharding"]): c for c in mesh["cases"]}
    for row in rows:
        src = {"flash_attention_fwd": ("W(b)", "tp", "fwd"),
               "flash_attention_bwd": ("W(b)", "tp", "bwd"),
               "ssd_chunks": ("W(c)", "tp", "ssd_fwd"),
               "ssd_chunks_bwd": ("W(c)", "tp", "ssd_bwd")}.get(row["name"])
        if src:
            row["launches_mesh_a_step_by_rank"] = [
                r[src[2]] for r in by_case[src[:2]][
                    "launches_a_step_by_rank"]]
    print(json.dumps({"lm_mesh": mesh}), flush=True)
    torch.cuda.empty_cache()
    ci = phase_ci(torch, dev, dry_lm)
    for row in rows:
        if row["name"] in ("nep_atom_pass", "nep_force_pass"):
            i = 0 if row["name"] == "nep_atom_pass" else 1
            row["launches_kernel_smoke"] = ci["kernel_smoke"]["launches"][i]
            row["eval_ms_kernel_smoke"] = ci["kernel_smoke"]["ms"]
            row["plain_eval_ms_kernel_smoke"] = ci["kernel_smoke"][
                "plain_ms"]
    print(json.dumps({"ci": ci}), flush=True)
    torch.cuda.empty_cache()
    surface = {"field_cooling": phase_field_cooling(torch, dev, spec, lat,
                                                    moments, kern)}
    surface["heisenberg"] = phase_heisenberg(torch, dev, lat)
    for row in rows:
        if row["name"] in ("nep_atom_pass", "nep_force_pass"):
            row["launches_field_cooling"] = surface["field_cooling"][
                "profiled"]["launches"]
    print(json.dumps({"md_surface": surface}), flush=True)
    md_loop = phase_md_loop(torch, kern, ref)
    print(json.dumps({"md_loop": md_loop}), flush=True)
    replica = phase_replica(torch, dev, spec, lat, moments, kern, ref)
    for row in rows:
        if row["name"] in ("nep_atom_pass", "nep_force_pass"):
            row["launches_replica"] = replica["launches"]
            row["replica_ms"] = replica["kernel_ms"][row["name"]][
                "batched_ms"]
            row["replica_flat_ms"] = replica["kernel_ms"][row["name"]][
                "flat_ms"]
            row["max_rel_err_replica"] = replica["kernel_rel_err"][
                row["name"]]
            row["max_rel_err_md_loop"] = md_loop["kernel_rel_err"][
                row["name"]]
    print(json.dumps({"replica_plan": replica}), flush=True)
    print(json.dumps({"ensemble": phase_ensemble(torch, dev)}), flush=True)
    training = phase_training(torch, dev, kern, ref, t_random)
    for row in rows:
        if row["name"] in ("nep_atom_pass", "nep_force_pass"):
            row["launches_training"] = training["launches"][row["name"]][0]
            row["body_training"] = training["bodies"][row["name"]]
            row["max_rel_err_training"] = training["kernel_rel_err"][
                row["name"]]
            row["ms_training"] = training["kernel_ms"][row["name"]]
    print(json.dumps({"training": training}), flush=True)
    print(json.dumps({"resilience": phase_resilience(
        torch, dev, spec, lat, moments, kern)}), flush=True)
    reset_md_counters(kern)
    serve = phase_serve(torch, dev, spec, kern, ref)
    for row in rows:
        if row["name"] in ("nep_atom_pass", "nep_force_pass"):
            fleet = serve["card_fleet"]
            row["launches_serving"] = fleet["launches"][row["name"]]
            row["max_rel_err_serving"] = {
                tag: max(e[row["name"]][tag]
                         for e in fleet["kernel_rel_err"].values())
                for tag in ("f32", "f64")}
    print(json.dumps({"serving": serve}), flush=True)
    torch.cuda.empty_cache()
    sharded = phase_sharded(torch, dev, spec, lat, moments, kern, ref,
                            flat_rate)
    for row in rows:
        if row["name"] in ("nep_atom_pass", "nep_force_pass"):
            row["launches_sharded"] = sharded["one_rank"]["launches"]
            row["ms_sharded"] = sharded["one_rank"]["kernel_ms"][row["name"]]
            errs = [sharded["one_rank"]["kernel_rel_err"][row["name"]]] + [
                r["nep_full_f32"]["kernel_rel_err"][row["name"]]
                for r in sharded["two_ranks"]]
            row["max_rel_err_sharded"] = {
                "f32": max(errs), "f64": max(
                    r["nep_f64"]["kernel_rel_err"][row["name"]]
                    for r in sharded["two_ranks"])}
    print(json.dumps({"sharded": sharded}), flush=True)
    torch.cuda.empty_cache()
    srep = phase_sharded_replicas(torch, dev, spec, lat, moments, kern, ref,
                                  sharded["one_rank"]["steps_per_s"])
    for row in rows:
        if row["name"] in ("nep_atom_pass", "nep_force_pass"):
            row["launches_sharded_replicas"] = srep["replicas"]["launches"]
            row["ms_sharded_replicas"] = srep["replicas"]["kernel_ms"][
                row["name"]]["batched_ms"]
            row["sharded_replicas_flat_ms"] = srep["replicas"]["kernel_ms"][
                row["name"]]["flat_ms"]
            row["max_rel_err_sharded_replicas"] = srep["replicas"][
                "kernel_rel_err"][row["name"]]
    print(json.dumps({"sharded_replicas": srep}), flush=True)
    torch.cuda.empty_cache()
    legacy = phase_legacy(torch, dev, spec, lat, moments, kern, ref,
                          {"main path": main_report,
                           "fitted spec": training["roofline"]}, dry_md)
    for row in rows:
        name = row["name"]
        if name in ("nep_atom_pass", "nep_force_pass"):
            kp = legacy["kernel_path"]
            row["launches_legacy"] = kp["launches"][name][0]
            row["ms_legacy"] = kp["kernel_ms"][name]
            row["max_rel_err_legacy"] = kp["kernel_rel_err"][name]
            fitted = legacy["roofline"]["fitted spec"][name]
            row["bound_ms_fitted"] = fitted["bound_ms"]
            row["bound_by_fitted"] = fitted["bound_by"]
            row["ms_fitted"] = fitted["ms"]
    print(json.dumps({"legacy": legacy}), flush=True)
    torch.cuda.empty_cache()
    bench = phase_bench(torch, BENCH_WHOLE_RUN)
    for row in rows:
        for driver, launches in bench["launches"].items():
            if row["name"] in launches:
                row[f"launches_bench_{driver}"] = launches[row["name"]]
    print(json.dumps({"bench": bench}), flush=True)
    log(f"chip_smoke: {time.perf_counter() - t_script:.1f} s in all")
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
