#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phase 1  the card's name and power limit; builds every CUDA kernel from
         the checkout's sources (one nvcc per source, started together);
         holds the 48 BGMV kernels to 0 spilled bytes (``-Xptxas -v``) and
         the 16 of them that shrink bf16 prefill tiles, and the bf16
         kernels of the flash_attention, fused_dora, quant_matmul and
         ssd_scan libraries, to the tensor cores (HMMA instructions in
         ``cuobjdump -sass``); every ssd_scan kernel to 0 spilled bytes.
Phase 2  each kernel against its plain PyTorch version on the card, f32
         and bf16, and its time beside the plain version's, one library
         call's and the bound (bytes over 3.35 TB/s or operations over
         the peak), each replayed from a CUDA graph (device time) and
         issued eagerly:
           BGMV at llama2-7b widths (d_in = d_out = 4096, r 8 and 16, 9
             pool slots; decode rows, prefill blocks, an odd S, B * S at
             the decode / prefill threshold and one above it, repeated
             slots, mixed ranks with rank-0 slots that must give 0), each
             call's variant printed, bf16 also within
             ``batched_lora/ref.py::bf16_bound``; timed in bf16 at r 8
             beside the one-block-a-row kernel's earlier time
             (BGMV_EARLIER_MS), with the rate the factors stream at;
           fused_dora at x (8, 4096) and (512, 4096), W0 4096 x 4096, r 8
             and 16, nonzero dA_dir and dB_mag, and a ragged (37, 4096) x
             (4096, 4160), timed in bf16 at r 8 beside the CUDA-core
             kernel's earlier time, the achieved TFLOP/s (prefill) and
             the rate W0 streams at (decode);
           quant_matmul int8 and int4, per channel and in groups of 128,
             at (K, N) = (4096, 4096), (4096, 11008), (11008, 4096) and
             M = 8, 512 and a ragged 37, with zero-scale columns, f32 and
             bf16, plus a bf16 call in groups of 24 (qmm_tiled); each
             call's variant printed; bf16 timed at M = 8 and 512 beside
             the CUDA-core kernel's earlier time (QUANT_EARLIER_MS), the
             TFLOP/s (prefill) or the rate the codes stream at (decode);
           flash_attention, bf16, timed through its dispatcher at
             llama2-7b prefill (1 x 4096, causal), decode (8 x 1 x 128),
             the gemma3-1b local layer (window 512), qwen3-32b prefill
             (1 x 4096, 64 heads over 8 kv heads), and one query row over
             4096 keys at qwen3-32b and a gemma3-1b global layer, beside
             scaled_dot_product_attention, the CUDA-core kernel's earlier
             time and the achieved TFLOP/s;
           ssd_scan timed at mamba2-2.7b 1 x 4096 in bf16 and f32 at
             chunk 128 and in bf16 at the default chunk 256, and at
             jamba-v0.1's SSM layers 1 x 4096 in bf16 (no single PyTorch
             call computes it), each beside the one-block-a-head kernel's
             earlier time (SSD_EARLIER_MS), with its variant and the
             blocks of its four launches; each output held as phase 6
             holds its own.
Phase 3  the serving path at full width: llama2-7b, 32 layers, bf16,
         random weights from a seeded generator on the card.
         AdapterStore (dora_mag, 6 tenants at ranks 2/4/8 + the null
         tenant) → ServeEngine (8 rows, prompts of 16-64 tokens, 32 new
         tokens, 12 requests), then the same with a pairs store of
         raw-LoRA tenants; each must launch its BGMV kernel 2 targets x
         32 layers x (prefills + decode steps) times.
Phase 4  path B1, fused-DoRA generation: greedy_generate over the backbone
         merged with one decomposed adapter (the shared one, one tenant's
         ΔB_M as dB_mag, a nonzero dA_dir) with use_fused_dora, 8 prompts
         of 64 tokens, 32 new tokens: 2048 fused_dora launches, no BGMV.
Phase 5  path B4, the quantized engine: ServeEngine with backbone_quant
         int8 (per channel), then int4 (groups of 128), over the dora_mag
         store and the 12 requests of phase 3, each built from a base that
         is then dropped: quant_matmul 7 x 32 x (prefills + decode steps)
         launches and the BGMV launches of phase 3's engine.
Phase 6  the standalone entry points flash_attention(...) and ssd_scan(...)
         at the full widths of the repo's configs (src/repro/configs/*.py,
         written out below): flash_attention at llama2-7b (1 x 4096, 8 x
         512, decode 8 x 1 x 128, a ragged 4095), qwen3-32b (1 x 4096;
         1 x 1024 non-causal) and the gemma3-1b local layer (1 x 4096,
         window 512), bf16, llama2-7b 1 x 4096 and gemma3-1b local also
         in f32, plus flash_attention_bhsd_cuda with sk_valid < Sk and
         rows that see no key; ssd_scan at mamba2-2.7b (1 x 4096
         and 4 x 2048 at chunk 128, 1 x 4096 at the default 256, 1 x 4096
         in f32) and jamba-v0.1's SSM layers (1 x 4096), and a three-way
         check (kernel, ssd_ref, ssd_naive) at S 256; each kernel
         launched once a call.
Phase 7  training, run between phases 4 and 5 on phase 3's backbone:
         first one stage-1 step's loss and the gradients of all 12
         adapter leaves of the first CHECK_DEPTH layers cast to f32 (one
         client, 1 x 64 tokens, dropout 0, a nonzero B_mag) on the card
         against the CPU, within 1e-4 of each leaf's max |g|; then
         run_federated (fedlora_opt: 4 specialist clients on the dolly
         tasks, 2 rounds of 2 local steps of 4 x 128 tokens, 2 stage-2
         steps on the task mix, 2 stage-3 steps; rank 8 on q/v, alpha 32,
         lora_dropout 0.1) at full width, with every stage checked bit
         for bit: stage 1 changes the base components and neither dA_dir
         nor dB_mag (dB_mag stays 0), stage 2 changes dA_dir only, stage
         3 dB_mag only, and after each rebroadcast every shared leaf is
         equal across clients and each client keeps its own dB_mag (also
         held on a copy of the clients whose dB_mag is nonzero, since the
         real one is 0 until stage 3); the training path launches no
         hand-written kernel; every loss and metric finite.  Then the 4 personalized clients (the stage-2
         server model plus each one's dB_mag) serve 8 requests as
         dora_mag tenants through ServeEngine: bgmv_mag 2 x 32 x
         (prefills + decode steps) launches, the prefill logits held as
         phase 3's.  Prints each stage's wall seconds, each stage-1
         step's wall and process CPU ms, the median step after the first
         (which warms up) and its training tokens/s, the peak memory, one stage-1 step
         under torch.profiler (device busy share, top kernels), each
         round's train CE and the accuracies (printed only: the weights
         are random), the comm bytes and the serving tokens/s.
Phase 8  the baselines, run after phase 7 on phase 3's backbone cut to its
         first CUT_DEPTH (8) layers of full width: first the
         card-vs-CPU gradient check of phase 7 on one method of each new
         adapter kind (fedalt's dual pair, adapter's Houlsby bottleneck,
         prompt tuning; the zero-initialized factor drawn nonzero); then
         run_federated for each of the nine uniform-rank methods of the
         registry (ffa_lora, fedprox, prompt, adapter, fedalt,
         lora_trimmed, lora_fedbuff, lora_fedavg_q8, lora_fedavg_topk: 4
         specialist dolly clients, 1 round of 2 steps of 4 x 128 tokens,
         1 personalization step, prox_mu 0.1) through phase 7's checking
         FedSim (each stage changes exactly the leaves its mask trains,
         so ffa_lora no lora_A and prompt / adapter only their own
         leaves; each rebroadcast as phase 7's, fedalt's on a probe copy
         too), with each method's own checks: fedalt's aggregate holds
         exact zeros in local_A / local_B; lora_fedavg_topk uplinks
         exactly ⌈0.05·n⌉ nonzeros a leaf a client; lora_fedavg_q8's
         aggregate is within one quantization step of the plain mean;
         lora_trimmed's equals numpy's trimmed mean within 1e-6;
         fedprox's loss is the loss without the term plus ½µ‖θ − θ_ref‖²
         within 1e-5; comm bytes equal the formula of the method's comm
         class; no hand-written kernel launched; every loss and metric
         finite.  sensitivity_report (Fig. 1) of lora_fedbuff's clients
         against their aggregate is printed.  Then the global models of
         ffa_lora, fedprox, lora_trimmed, lora_fedbuff, lora_fedavg_q8,
         lora_fedavg_topk and fedalt (its shared pair) serve 8 requests
         as pairs tenants with the null tenant: bgmv 2 x 8 x (prefills
         + decode steps) launches, the prefill logits held as phase 3's.
         Prints each method's stage walls, stage-1 steps' wall and CPU
         ms, train CE, comm bytes and peak memory, and the serving
         tokens/s.  Each sim is freed before the next.
Phase 9  mixed-rank fleets, run after phase 8 on phase 3's backbone:
         run_federated at client ranks 2/4/8/16 (allocated rank 16) for
         fedlora_opt, lora_zeropad, lora_replication and lora_exact, and
         lora_exact again at server_rank 32 (>= the ranks' sum, 30), with
         phase 8's cuts (1 round of 2 steps of 4 x 128 tokens, 1 stage-2
         and 1 stage-3 step), through phase 7's checking FedSim: after
         every stage each rank-axis leaf is exactly 0 above each client's
         rank (the axes written out in RANK_AXIS, not read from the
         port), the stages change the leaves EXPECT gives, each
         rebroadcast hands every client the aggregate cut to its rank;
         lora_zeropad's aggregate is the plain mean and
         lora_replication's the per-row coverage mean, both computed in
         f64 here, within 1e-6 of max |x|; lora_exact's residual
         ‖ΣwᵢAᵢBᵢ − A'B'‖_F over the first CHECK_DEPTH layers is within
         1e-5 of ‖ΣwᵢAᵢBᵢ‖_F at server rank 32 and equals the
         Eckart-Young tail of its singular values (torch.linalg.svdvals,
         f64, on the card) within 1e-4 of it at 16, and the card's exact_fedavg agrees
         with the CPU's on the same client stacks (products within
         1e-5); comm bytes equal the formula with each client billed at
         its own rank (125,829,120 for the psum methods, 314,572,800 for
         lora_exact's all_gather); no hand-written kernel launched;
         every loss and metric finite.  Then fedlora_opt's clients serve
         as dora_mag tenants at their own ranks in a rank-16 pool over
         the stage-2 server model (whose rows above a tenant's rank are
         nonzero, so bgmv_mag's per-slot rank decides them) and
         lora_exact's as pairs tenants in a rank-16 pool, each with the
         null tenant: the store reads back each tenant's rank, bgmv_mag
         and bgmv launch 2 x 32 x (prefills + decode steps) times, and
         the prefill logits are held as phase 3's and, beside that,
         against each client's own adapter through the plain path.
         Prints each run's stage walls, stage-1 steps' wall and CPU ms,
         peak memory, comm bytes, lora_exact's residuals and the serving
         tokens/s.
Phase 10 persistence, run after phase 9 on phase 3's backbone and phase
         9's server model, both cut to CUT_DEPTH (8) layers, in a work
         directory under the checkout's build/ that it removes.  (a)
         FedSim resume: fedlora_opt at client ranks 2/4/8/16 with phase
         9's cuts; sim A runs round 1 (2 steps and the aggregate), saves,
         runs round 2; a fresh sim B loads the file (round 1 returned,
         every state leaf equal to A's at its save), runs round 2, and
         every client adapter, moment, step and comm bytes equals A's bit
         for bit; a sim at ranks 16/8/4/2 refuses the file (ValueError);
         the file restored on the CPU and saved from there gives the same
         bytes.  (b) Tiered serving: a TieredAdapterStore (dora_mag, 32
         slots, a 256-entry host cache, shards on disk) over phase 9's
         fedlora_opt stage-2 server model; 10,000 tenants registered, each
         with its own seeded ΔB_M at a rank cycling 2/4/8/16, with no
         device allocation, leaving 9,744 shards and 10,000 after flush;
         ServeEngine(16 rows, prompts of 16, 16 new tokens, chunks of 8)
         serves 32 requests over tenants 0-31 (warm) and 32 drawn
         Zipf(1.1) over all 10,000 from seed 0, in two rounds of flat
         warm, tiered warm, tiered Zipf, flat Zipf, through a checking store
         that holds every promoted slot's rows to the tenant's ΔB_M
         exactly: the warm tokens equal a flat 32-slot store's, the Zipf
         tokens a flat store's holding its tenants, the Zipf tokens again
         after a save and a load into a fresh store on the same shards,
         and both schedules with prefetch a no-op; bgmv_mag 2 x 8 x
         (prefills + decode steps) launches a run.  Prints the save and
         load seconds and MB/s of (a), the registration seconds, the
         shard counts, T0 hits, T1 hits and shard reads, and each run's
         tokens/s.
Phase 11 telemetry and cohort rounds, run after phase 10 in its work
         directory.  (a) On phase 10's 8-layer cut, with ``obs``
         enabled (events in the work directory), phase 10's warm and
         Zipf runs again over its 10,000-tenant tiered store: tokens
         equal those with telemetry off; pool/tier_hits (t0, t1),
         tier_misses, promotions (t1, t2) and t1_spills equal the
         checking store's counts of the same runs; span_seconds of
         serve/prefill and serve/decode_chunk count last_run's prefills
         and chunks; each serve_run event's
         tokens are last_run's; one ckpt_restore event per shard read,
         prefetched ones included, all emitted on the serving thread.
         One FedSim save / load: one ckpt_save and one ckpt_restore of
         its file, with its step, leaf count and payload bytes.  One
         prefill + one decode chunk under torch.profiler: as many
         "kernels/bgmv_mag" ranges as counted bgmv_mag launches (2 x 8
         a pass), each linked to exactly one bgmv_kernel on the card.
         One warm batch's decode step ms with telemetry off and on, in
         turns (off, on, on, off, ...) on one warm engine, printed
         beside the card's name and power limit.  (b) For fedlora_opt and
         lora_fedbuff: a CohortSim of a 4-slot FedSim over a 16-client
         host bank, FaultPlan(dropout 0.25, stragglers 0.25 at delays
         1-2, corrupted updates 0.25 x 10, seed 1), 3 rounds of 1 step
         of 4 x 128 tokens, telemetry on: cohorts, fates and delays
         equal a replay of the numpy draws written out here; every
         client that did not sync (and had no delivery due) is
         unchanged in the bank bit for bit; the bill is the unit times
         live clients plus deliveries; the bank is host memory and the
         device peak stays within one plain round's peak plus the 4
         clients' round-start copy and 256 MiB; the dropout, straggler
         and corruption counters equal the draws; the last fed_cohort
         event's comm bytes are the sim's.  fedlora_opt is saved after
         round 1 with a straggler in flight (the cohort file and the
         FedSim's own, for its step counter) and resumed in a fresh
         sim: rounds 2-3 equal the uninterrupted run's, bank bit for
         bit, and the straggler delivers at its round.  lora_fedbuff's
         16 bank clients, each at its last-synced adapter, are served
         as pairs tenants in one 16-row batch through bgmv (2 x 32 x
         (prefills + decode steps) launches), the prefill logits held
         as phase 8's.  Prints the telemetry counts, the decode step
         ms, each round's wall, the bank's size, the peaks, the cohort
         file's save and load seconds and the serving tokens/s.
Phase 12 the production round engine, run after phase 11 on phase 3's
         backbone cut to its first CUT_DEPTH (8) layers of full width
         (dropout 0): fedlora_opt at llama2-7b width through
         launch/train.make_fed_pipeline_step, one client per rank of a
         4-rank gloo group on the one card (launch/mesh.ClientPool; the
         ranks map this process's backbone by CUDA IPC), 2 pipeline
         iterations of 2 local steps of 4 x 128 tokens a client, 2 stage-2
         steps over 16 x 128 server rows (the sharded path: 2 rows a
         rank a step) and 2 stage-3 steps, remat on, micro_batches 1, the
         last iteration also through run_pipeline with telemetry on,
         which must give every rank the adapters, stage-1 optimizer
         state and server model of round_step -> global_step ->
         personal_step from the same input bit for bit.  Held against
         the port's FedSim in this process, each stage of both
         iterations from the engine's own input to it (in bf16 a 1e-7
         difference in an f32 adapter flips bf16 roundings that later
         stages carry): stage 1's client adapters before the collective
         equal FedSim.local_round's bit for bit (the first differing leaf
         is named if not); the collective's aggregate and rebroadcast
         within 1e-5 of each leaf's max of FedSim.aggregate's; stage 2
         within 1e-4 of FedSim's global stage with its gradient taken in
         the engine's 4 row slices (sharded_global_stage); stage 3 within
         1e-6 of FedSim.personalize's.  The f32 witness: the engine's
         sharded stage 2 at 4 layers of full width in f32, from the
         first iteration's server model, against FedSim.global_stage's
         full batch: every leaf within 1e-2 of its norm and at most 0.1%
         of its elements beyond 1e-3 of its max; the bf16 replica's
         distance from global_stage at the same depth is printed.  Also:
         every client is the server model plus its dB_mag;
         comm_bytes_round equals FedSim's bill for the round; the card
         holds under 80 GB with the ranks up, which add under 4 x 6 GiB
         and each allocate under half the backbone (none copies it); one
         fed_round event with 4 clients' ce, grad_norm and drift.  The 4
         personalized clients serve 8 requests as dora_mag tenants
         (bgmv_mag 2 x 32 x (prefills + decode steps) launches, the
         prefill logits held as phase 7's).  The phase takes at most 120
         s.  Prints the card's used memory, each rank's peak, the stage
         walls of both engines, each rank's warm stage-1 step ms, the
         collectives' calls, bytes and seconds, and the fed_round event.
Phase 13 the rest of the dense family, run after phase 6 (the backbones
         drawn anew, full width, random weights from seeded generators):
         (a) llama2-7b, 32 layers, bf16, a 1 x 4096 prefill through
         ``forward`` on the plain chunked path (``kernel_impl="torch"``)
         and through flash_attention (32 launches), each timed with its
         peak above the weights; flash held to the plain path through
         CHECK_DEPTH layers in bf16 (2e-2) and all 32 in f32 (1e-4).
         (b) qwen3-32b (qk-norm, rep 8, d_head 128) at all 64 layers and
         (c) granite-34b (rep 48, one kv head) at 24 of its 88 layers
         (the cut printed), bf16: greedy_generate over a 1 x 4096 prompt
         for 1 and 16 tokens (flash once a layer a prefill), the prefill
         ms, decode step ms, tokens/s and peak; flash held to the plain
         chunked path through CHECK_DEPTH layers in bf16 (2e-2), and at
         2 layers of full width in f32 (logits within 1e-4, 16 greedy
         tokens equal).  (d) gemma3-1b, 26 layers (4
         superblocks of 5 local + 1 global and a tail of 2): the same
         with 64 tokens, the local layers on flash's window 512; flash
         held in bf16 through CHECK_DEPTH layers and in f32 through 26;
         in f32 a 448-token prompt and 128 decode steps (the 512-slot
         ring wraps at step 64): the tokens equal greedy_generate's, the
         logits of steps 0, 63, 64 and 127 within 1e-4 of the plain
         forward over the sequence so far (last row).  (e) run_federated
         fedlora_opt at gemma3-1b under phase 7's stage checks (2 clients
         x 1 x 4096 tokens, 1 round of 2 steps, the first a warm-up, 1
         stage-2 and 1 stage-3 step, dropout 0; the plain chunked,
         windowed path with each query block checkpointed; eval batches
         of 128 tokens; no kernel launched): the stage-1 step ms, peak,
         every loss finite; then the 2 clients as dora_mag tenants
         over the f32 backbone through greedy_generate with adapter_idx
         (bgmv_mag 2 x 26 x 16 launches), each row's 16 tokens equal to
         its merged model's.  Every number is printed beside the card's
         nvidia-smi line.
Phase 14 mixture of experts, run after phase 13 (the backbones drawn
         anew, full width, random weights): (a) qwen3-moe-30b-a3b (128
         experts, top 8, qk-norm, rep 8) at all 48 layers, bf16 (61.1
         GB): greedy_generate over a 1 x 4096 prompt for 1 and 16 tokens
         (flash_attention once a layer a prefill), the prefill ms,
         decode step ms and peak; flash held to the plain chunked path
         through CHECK_DEPTH layers in bf16 (2e-2) and at 2 layers of
         full width in f32 (logits within 1e-4, 16 greedy tokens equal).
         (b) One MoE layer of qwen3-moe width at T 512, drop-free: the
         grouped layer against the dense oracle (every expert on every
         token) in f32 within 1e-4 of max |y|, the aux within 1e-5; in
         bf16 within 2e-2 of the f32 oracle on the same rounded inputs
         over the tokens routed alike (at most 15% routed otherwise);
         two runs bit-equal in f32, bf16 and bf16 at capacity 1.25.
         (c) mixtral-8x22b (8 experts in 16 half-d_ff slots, window
         4096, rep 6) at 10 of its 56 layers (50.9 GB; the cut printed):
         (a)'s checks over a 1 x 8192 prompt, which the window cuts.
         (d) qwen3-moe at 8 layers: run_federated fedlora_opt under
         phase 7's stage checks (4 clients x 4 x 128 tokens, 1 round of
         2 steps, 1 stage-2 and 1 stage-3 step; the aux in the loss; no
         kernel launched), the card-vs-CPU gradient check at
         CHECK_DEPTH layers in f32; the 4 clients as dora_mag tenants
         through ServeEngine: at the drop-free capacity in f32 each
         tenant's 16 tokens equal its merged model's; at capacity 1.25
         in bf16 8 requests twice with the same tokens; bgmv_mag 2 x 8 x
         (prefills + decode steps) launches a run.
Phase 15 SSM and hybrid models, run after phase 14 (the backbones drawn
         anew, full width, random weights): (a) mamba2-2.7b at all 64
         layers, bf16 (5.66 GB): greedy_generate over a 1 x 4096 prompt
         for 1 and 16 tokens (ssd_scan once a layer a prefill through
         the mixer's kernel branch, never in a decode step), the prefill
         ms, decode step ms and peak; every ssd_scan output of the first
         CHECK_DEPTH layers, on that layer's own padded inputs, within
         ``ssd_scan/ref.py::bf16_bound`` and ``cast_point_interval``;
         the kernel path against the plain path (``kernel_impl="torch"``)
         through CHECK_DEPTH layers in bf16 (2e-2) and all 64 in f32
         (logits within 1e-4, 16 greedy tokens equal); in f32 the cache
         of a 4095-token prefill and one decode step against a 4096-token
         prefill's (state and conv states within 1e-4 of max).  (b)
         jamba-v0.1-52b at 16 of its 32 layers (two superblocks of 1
         attention + 7 Mamba sublayers, 4 dense and 4 MoE FFNs each; 52.0
         GB; the cut printed): (a)'s checks in bf16 (ssd_scan 14 and
         flash_attention 2 launches a prefill; the flash output of the
         first CHECK_DEPTH layers also within ``bf16_bound_bhsd``), and
         at 2 layers of full width in f32 (attention + dense, Mamba +
         MoE) logits within 1e-4 and 16 greedy tokens equal.  (c)
         mamba2 at 8 layers: the card-vs-CPU gradient check at
         CHECK_DEPTH layers in f32 (x_proj / out_proj B_mag nonzero),
         run_federated fedlora_opt under phase 7's stage checks (4
         clients x 4 x 128 tokens, 1 round of 2 steps, 1 stage-2 and 1
         stage-3 step): under autograd the plain scan runs, so ssd_scan
         launches only in the eval forwards (counted); the 4 clients'
         merged models in f32 through greedy_generate, 16 tokens each
         equal to the plain path's.  (d) jamba at 2 layers of full width
         in f32 at the drop-free capacity: two dora_mag tenants with
         random ΔB_M on q / v served in one batch through
         greedy_generate with adapter_idx (bgmv_mag 2 x 1 attention
         layer x 16 launches), each row's tokens equal to its merged
         model's.  (a) and (b) also profile one prefill (the device's
         busy ms against the unprofiled wall; the scan's, flash's and
         the GEMMs' ms).  The phase takes at most 90 s.
Phase 16 vision-language and encoder-decoder models, run after phase 15
         (full width, full depth, random weights): (a) qwen2-vl-2b, 28
         layers, bf16: greedy_generate over 1 x (1024 patch embeddings +
         3072 tokens) with 3-section M-RoPE positions (the patches a 32 x
         32 grid at t = 0, the text from 32 on) for 1 and 16 tokens
         (flash_attention once a layer a prefill, causal), the prefill
         ms, decode step ms and peak; (b) seamless-m4t-large-v2, 24 + 24
         layers, bf16: 1 x 4096 frames into the encoder and 1 x 2048
         tokens into the decoder, 16 greedy tokens with the encoder's
         output in every decode step (flash 72 launches a prefill: the
         non-causal encoder 24, the causal self-attention 24, the
         non-causal cross-attention of 2048 over 4096 24).  Each: the
         flash output of the first CHECK_DEPTH layers within
         ``bf16_bound_bhsd`` of its own mask, the kernels against the
         plain path through CHECK_DEPTH layers in bf16 (2e-2) and through
         every layer in f32 (1e-4); seamless's f32 decode step (with
         enc_out) against its full forward's last row (1e-4).  (c) each
         at 4 layers (seamless 4 + 4) in f32: the card-vs-CPU gradient
         check at CHECK_DEPTH layers with frontend_emb in the batch, one
         fedlora_opt pipeline round through FedSim (4 clients x 2 rows
         of 128 patches / frames + 128 tokens; 2 stage-1 steps, 1
         stage-2, 1 stage-3), each stage timed, every stage's leaves
         moved (seamless's encoder's in stage 1), no kernel launched.
         (d) at 2 layers, f32: qwen2-vl's clients 0 and 1 as dora_mag
         tenants in one batch through greedy_generate with adapter_idx
         (bgmv_mag 2 x 2 x 16 launches), each row's tokens equal to its
         merged model's; seamless's pooled tree refused (its encoder
         takes no per-row adapters), a tenant served merged.  (a) and
         (b) also profile one prefill.  The phase takes at most 90 s.
Phase 17 backbone pretraining, the analytic account and the user
         examples, run after phase 16: (a) fed.pretrain.pretrain_base at
         llama2-7b's full width, 8 layers, bf16 (full-parameter AdamW,
         clip 1, f32 moments; 32 layers would not fit in 80 GB), the
         reference's batch of 32 x 48 tokens and lr 3e-3, 10 steps: each
         step's loss finite, each step's host ms around a sync (the
         last profiled instead: device busy ms, GEMMs against the rest),
         the median warm step, tokens/s, the peak, and the achieved TFLOP/s
         from launch/analysis.analytic_step_flops (3 forward passes a
         train step) with its share of 989 TFLOP/s; the meta tree's
         parameter count (param_counts) and bytes (tree_bytes) equal the
         real tree's.  (b) One full-parameter gradient, 1 layer of
         llama2-7b width in f32, 2 x 48 tokens: every backbone leaf's
         gradient on the card within 1e-4 of the leaf's max |g| on the
         CPU, the loss within 1e-5.  (c) get_pretrained_base at the e2e
         example's 100m profile, 50 steps, its cache in build/phase17/:
         the first call trains once and writes the file, the second
         restores it bit for bit without training.  (d) ``python -m
         repro_torch.examples.fed_finetune_e2e --profile 100m --rounds 2
         --pretrain-steps 50`` in build/phase17/ with (c)'s cache: exit
         0, (c)'s base restored, accuracies in [0, 1], its history file
         written; its wall time.  (e) examples.serve_personalized.main()
         in this process: its mixed batch equal to merge-per-tenant
         greedy_generate, bgmv_mag launched 2 targets x 4 layers x 2
         generate calls x (1 prefill + 8 decode forwards) = 144 times;
         both tokens/s.  The phase takes at most 90 s.
Phase 18 the one-card dry run (``launch/dryrun.py``: a step run once on
         meta tensors under a storage tally) against the card, after
         phase 17: (a) the meta branches of flash_attention (llama2-7b
         prefill 1 x 4096, bf16) and ssd_scan (mamba2-2.7b 1 x 4096,
         chunk 128) allocate exactly what the real call grows
         max_memory_allocated by, each storage rounded up to the caching
         allocator's 512 bytes, and return the card's shapes and dtypes;
         (b) four steps on the default kernel path, each against its
         account on meta: llama2-7b prefill 1 x 4096 at 32 layers (flash
         32 launches), decode at batch 8 over a 4096-position cache at 32
         layers, one fedlora_opt stage-1 step at 8 layers of 4 x 1024
         tokens, mamba2-2.7b prefill 1 x 4096 at 64 layers (ssd_scan 64
         launches): the inputs allocate the account's argument_bytes
         within 0.1%, the step's own allocation is its peak_estimate_bytes
         − argument_bytes within 5% or 64 MiB, the result is finite;
         (c) the full-width records of llama2-7b and mamba2-2.7b at every
         shape they support, traced in a background process (no card
         visible, one thread) started after phase 2, printed as
         launch/report.py renders them, every status ok.  The phase takes
         at most 60 s.
Phase 19 the 'model' axis, after phase 18: one ClientPool grid of 2 data
         x 2 model ranks sharing the card over gloo (launch/mesh
         .make_debug_mesh); each rank maps this process's tensors by CUDA
         IPC and copies its own shard (launch/specs.shard_tree by
         param_specs).  (a) llama2-7b at full width: the prefill step of
         2 x 4096 tokens, a row a data rank, each rank's 16 of 32 heads
         through flash_attention once a layer, then 15 greedy decode
         steps, every row's logits gathered: through 8 layers in f32 the
         prefill logits within 1e-4 of max of the unsharded path on the
         card and the 16 greedy tokens equal; through CHECK_DEPTH layers
         in bf16 within 2e-2; all 32 layers in bf16 run and reported;
         every rank returns the same logits.  (b) the production engine
         on the grid: one fedlora_opt iteration at 8 layers of llama2-7b
         width (2 clients of 4 x 128 tokens, 2 local steps, 1 stage-2
         step over 4 server rows sharded over the data ranks, 1 stage-3
         step) against FedSim with 2 clients from the same adapters and
         batches: in f64 every client and server leaf within 1e-4 of its
         max, dA_dir (one AdamW step from zero, its smallest gradients at
         AdamW's eps) within 1e-4 in norm with at most 0.1% of its
         elements beyond 1e-3 of max; in f32 every element within 1e-4
         of its leaf's max but those f32 does not resolve (an f32 run
         more than 1e-5 of max off its own f64 run), the grid's f32 run
         so off at no more than twice as many elements as FedSim's, plus
         2; every rank of a model row holds its client bit for bit.  (c)
         qwen3-moe-30b-a3b at full width, 4 of 48 layers, in f32 and in
         bf16, 64 of the 128 expert slots a data rank with their d_ff
         over the model ranks, at the capacity factor where nothing drops
         (from the router's picks): the 2 x 1024 prefill step (all-to-all)
         and a one-row prompt and decode step (the small-batch path)
         beside the unsharded path; in f32 the logits of every row routed
         alike in every layer within 1e-4 of max (a row of the prefill at
         least), in bf16 the logits and the tokens routed otherwise
         printed; then the first MoE layer on the bf16 calls' own inputs,
         moe_ffn_ep on the grid against moe_ffn_local: f32 within 1e-4 of
         max with every token routed alike, bf16 within 2e-2 over the
         tokens routed alike, the aux the mean of the data ranks' own.
         Prints each part's times, each rank's peak and shard bytes and
         the collectives' calls, bytes and seconds.  The ranks start on a
         thread beside phases 17 and 18 (each builds the production
         engine once there: a process's first meta-tensor ops import
         PyTorch's reference implementations, seconds of host time);
         from then the phase takes at most 90 s.  ``python3
         chip_smoke.py --mesh-only`` runs phases 19 to 21 alone on every
         card there is (NCCL when each rank has its own).
Phase 20 the SSM, hybrid and encoder-decoder families on phase 19's grid,
         each rank's shard by param_specs (the Mamba-2 mixer split by
         heads), beside the unsharded path on the same card.  (a)
         mamba2-2.7b at full width: the prefill step of 2 x 4096 tokens,
         a row a data rank, each rank's 40 of 80 heads through ssd_scan
         once a layer, then 16 greedy decode steps: through 8 layers in
         f32 the prefill logits within 1e-4 of max and the 17 tokens
         equal; through CHECK_DEPTH layers in bf16 within 2e-2; all 64
         layers in bf16 reported (64 ssd_scan launches a rank).  (b)
         jamba-v0.1-52b at full width, at the drop-free capacity, 2 x
         2048 and 4 decode steps: its first 2 layers (attention + dense,
         SSM + MoE: 64 of 128 SSM heads, 16 of 32 attention heads, 8 of
         16 expert slots a data rank with half their d_ff) in f32, the
         prefill's and the decode steps' logits within 1e-4 of max over
         the rows routed alike in every layer (the tokens routed
         otherwise printed); one superblock of 8 layers in bf16 reported.
         (c) seamless-m4t-large-v2 at full width: 2 rows of 4096 frames
         and 2048 tokens, a row a data rank, the encoder over the rank's
         rows and 8 of 16 heads (flash_attention non-causal once an
         encoder layer; its output whole over the model row), the
         decoder's self- (causal) and cross-attention through
         flash_attention too, 72 launches a rank at 24 + 24 layers, then
         16 greedy steps with the encoder's output: at 24 + 24 layers in
         f32 the prefill logits within 1e-4 of max and the 17 tokens
         equal; at CHECK_DEPTH + CHECK_DEPTH in bf16 within 2e-2.  Every
         rank returns the same logits; each launches exactly its
         prefill's kernels.  (d) phase 19 (b) at mamba2-2.7b's width, 8
         layers, adapters on x_proj / out_proj, against FedSim with 2
         clients, f64 and f32 held as there.  Prints each part's times,
         each rank's peak and shard bytes and the collectives' calls,
         bytes and seconds; the phase takes at most 90 s.
Phase 21 the sequence-split KV cache and the grid's account on phase
         19's grid.  (a) gemma3-1b at full width (one kv head, 26 layers:
         local rings of 512 slots and global layers), 2 x 4096 prompt
         tokens, a row a data rank, 16 greedy tokens on the grid's
         seq_shard_kv layout (a cache of 4112 slots split on its
         sequence, 2056 a rank, its rings 256): in f32 every step's
         logits within 1e-4 of max of the unsharded path on the same card
         and the tokens equal; through CHECK_DEPTH layers in bf16, both
         fed the unsharded path's tokens, within 2e-2; each rank's cache
         half the default layout's (the kv head whole on every rank),
         whose decode step is timed beside.  (b) granite-34b at full
         width (48 heads, MQA), 4 of 88 layers, the same in f32.  (c)
         each rank's step against its meta account on a meta grid at its
         place (launch/dryrun.py): (a)'s prefill step and one
         sequence-split decode step at gemma3-1b's config, and phase 19's
         llama2-7b prefill step at 8 layers (bf16): the step's growth of
         max_memory_allocated within 5% or 64 MiB of peak_estimate −
         argument_bytes, and its collectives' calls and bytes equal to
         the meta group's exactly.  Prints each rank's decode step ms on
         both layouts, the collectives' bytes a step and the ranks'
         peaks; the phase takes at most 90 s.
Every run starts with every launch count at 0.  Each path's prefill
logits, kernels against plain versions, relative to max |logit|: bf16
weights through the first CHECK_DEPTH layers within 2e-2, f32 weights
through all 32 within 1e-4; the other depths are printed.  Path B1 is
also held against the unfused path in f32; path B4's drift from the
unquantized model is printed only.  BGMV: within TOL of the plain
version relative to its max |y|, and bf16 also elementwise within
``batched_lora/ref.py::bf16_bound`` (f32 sums in any order, one bf16 ulp
of h per rank column, the output's rounding), which a d_in slice left
out would break.  fused_dora: within FUSED_TOL of the
plain version relative to its max |y|, and bf16 also elementwise within
the bound of its cast points (``ref.bf16_bound``: f32 sums in any order,
one bf16 ulp at T(h ⊙ b_eff_mag) and at the output), which a K tile
left out would break.  quant_matmul: within TOL of the plain version
relative to its max |y|, and bf16 also elementwise within
``quant_matmul/ref.py::bf16_bound`` (f32 sums in any order, the scale
per element or per group, the output's rounding).  flash_attention: f32
within 2e-5, bf16 within 2e-2, absolute, of the plain version run in f32
on the same
values, and bf16 also elementwise within the bound of its roundings
(``bf16_bound_bhsd``: u |ref| + (1 + u)(u min(Σ w|v|, 8 sqrt(Σ w² v²))
+ 2e-5), u = 2^-8).  ssd_scan: f32 within rtol 1e-3, atol 1e-4 elementwise; bf16
within 2e-2 of max |y| of the plain version on the same bf16 inputs, and
elementwise within ``ssd_scan/ref.py::bf16_bound`` (the cast points of
the reference and of the kernel, f32 sums in any order, the output's
rounding), which a left-out carried state, column tile or chunk end
state would break, and inside ``ssd_scan/ref.py::cast_point_interval``
(the kernel's own cast points with exact sums: only f32 sums and exps in
another order may move an output), which a state rounded once to bf16
would break.

Prints a JSON ``kernels`` line, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``.  Exits non-zero, with no
result line, when there is no CUDA device, outside a checkout, or when
any check fails.  Imports nothing of JAX.
"""
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # relative to max |plain output|
FUSED_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # tests/test_kernels.py's
LOGITS_F32_TOL = 1e-4   # f32 weights, all layers, kernels vs plain
GPU = ""                # the card's nvidia-smi line, set by main()
HBM_BYTES_PER_S = 3.35e12                   # H100 SXM
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
D, R_MAIN, L_SLOTS = 4096, 8, 9
N_NEW, PAD_W, MAX_LEN, ROWS, CHUNK = 32, 64, 128, 8, 8
CHECK_DEPTH = 2         # layers through which bf16 prefill logits are held
QUANT_CHECK_DEPTH = 1   # the same on the quantized path (PERF.md)
DEPTHS = (1, 2, 4, 8, 16, 32)   # depths at which they are read
QUANT_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))   # (K, N)
QUANT_MODES = (("int8", None), ("int4", 128))    # as the engines use them


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)
    print(f"ok: {msg}")


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_inputs(torch, B, S, r, dtype, seed):
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dt, device="cuda")

    shape = (B, D) if S is None else (B, S, D)
    ranks = [r, r // 2, 0, 1, r, 2, r - 1, 3, 0]        # slot 8 = null
    return dict(
        x=t(rng.normal(size=shape), dtype),
        a_pool=t(rng.normal(size=(L_SLOTS, D, r)) / np.sqrt(D)),
        b_pool=t(rng.normal(size=(L_SLOTS, r, D)) / np.sqrt(r)),
        a_dir=t(rng.normal(size=(D, r)) / np.sqrt(D)),
        a_mag=t(rng.uniform(0.5, 1.5, size=(D,))),
        b_mag=t(rng.normal(size=(r,))),
        dmag=t(rng.normal(size=(L_SLOTS, r))),
        b_dir=t(rng.normal(size=(r, D)) / np.sqrt(r)),
        # repeated slots and rank-0 slots (2 and the null slot 8)
        idx=t([0, 2, 4, 4, 8, 1, 6, 6][:B], torch.int32),
        ranks=t(ranks, torch.int32))


def call(kind, v, impl, ranked, scale=4.0):
    from repro_torch.kernels import bgmv, bgmv_mag
    ranks = v["ranks"] if ranked else None
    if kind == "bgmv":
        return bgmv(v["x"], v["a_pool"], v["b_pool"], v["idx"], scale=scale,
                    ranks=ranks, impl=impl)
    return bgmv_mag(v["x"], v["a_dir"], v["a_mag"], v["b_mag"], v["dmag"],
                    v["b_dir"], v["idx"], scale=scale, ranks=ranks, impl=impl)


def library_call(torch, kind, v, scale=4.0):
    """One composite of PyTorch calls for the same ranked function (gather,
    two batched products, the rank mask on h): a yardstick only, never
    called by the port."""
    x = v["x"] if v["x"].dim() == 3 else v["x"][:, None]
    dt, idx = x.dtype, v["idx"]
    cols = torch.arange(v["a_dir"].shape[1], device=x.device)

    def keep(gi):                                           # (B, 1, r)
        return (cols < v["ranks"][gi][:, None]).to(dt)[:, None]

    def pairs():
        gi = idx.long()
        return torch.bmm(torch.bmm(x, v["a_pool"][gi].to(dt)) * keep(gi),
                         v["b_pool"][gi].to(dt)) * scale

    def mag():
        gi = idx.long()
        m = (v["b_mag"] + v["dmag"][gi])[:, None].to(dt) * keep(gi)
        return torch.matmul(torch.matmul(x * v["a_mag"].to(dt),
                                         v["a_dir"].to(dt)) * m,
                            v["b_dir"].to(dt)) * scale
    return pairs if kind == "bgmv" else mag


def rel_err(y, ref):
    diff = (y.float() - ref.float()).abs().max()
    return (diff / ref.float().abs().max().clamp_min(1e-30)).item(), diff.item()


def time_ms(torch, fn, side, reps=5, iters=200, warmup=20):
    """Per-call ms of ``fn``: {"graph": ..., "eager": ...}, each a median
    and [min, max] over ``reps`` CUDA-event timings of ``iters`` calls.
    "graph" replays the calls from one CUDA graph captured on stream
    ``side``, so it is the device's time with the host taken out; "eager"
    issues them back to back from Python, which is what an eager caller
    such as the engine pays."""
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()

    def eager():
        for _ in range(iters):
            fn()

    out = {}
    for name, run in (("graph", graph.replay), ("eager", eager)):
        run()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / iters)
        out[name] = (statistics.median(ts), [min(ts), max(ts)])
    del graph
    return out


def roofline(nbytes, ops, dtype_name):
    """(bound_ms, bound_by): the larger of ``nbytes`` over HBM and ``ops``
    over the card's peak for ``dtype_name``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound(kind, v, dtype_name):
    """(bound_ms, bound_by): the larger of the bytes the call must move
    (each input read once, each output written once; pool factors of the
    slots this idx touches) over HBM and its operations over the peak."""
    x = v["x"]
    BS = x.numel() // D
    es = x.element_size()
    r = v["a_dir"].shape[1]
    slots = len(set(v["idx"].tolist()))
    nbytes = 2 * x.numel() * es + 4 * (v["idx"].numel() + v["ranks"].numel())
    ops = 2 * BS * r * (D + D)
    if kind == "bgmv":
        nbytes += 4 * slots * (D * r + r * D)
    else:
        nbytes += 4 * (D * r + D + r + r * D + slots * r)
        ops += BS * (D + r)
    return roofline(nbytes, ops, dtype_name)


def timings(torch, side, fns, **kw):
    """{key: graph ms, key_range, eager_key, eager_key_range} for each
    named callable (``kw``: reps, iters, warmup of ``time_ms``)."""
    row = {}
    for key, fn in fns.items():
        t = time_ms(torch, fn, side, **kw)
        row[key], row[key + "_range"] = t["graph"]
        row["eager_" + key], row["eager_" + key + "_range"] = t["eager"]
    return row


# bf16 ms of the one-block-a-row BGMV kernel (PERF.md, the kernel table's
# rows 1 and 2: NVIDIA H100 80GB HBM3, 700.00 W), printed beside the
# cluster kernel's
BGMV_EARLIER_MS = {"bgmv decode": 0.01680, "bgmv prefill": 0.03154,
                   "bgmv_mag decode": 0.01160, "bgmv_mag prefill": 0.02510}
# (B, S) of phase 2's BGMV cases: decode rows, the prefill block, a ragged
# S, and B * S at the decode / prefill threshold (16) and one above it
BGMV_SHAPES = ((8, None), (8, 64), (8, 37), (2, 8), (1, 17))


def bgmv_bound_ratio(kind, v, y, ranked, scale=4.0):
    """max |y − ref| / bound over the elements, for a bf16 output: ref and
    bound from ``batched_lora/ref.py::bf16_bound``, the exact value at the
    Pallas cast points and the bound of f32 sums in any order, h's rounding
    per rank column and the output's.  Rank-0 rows have ref and bound 0 and
    must be 0."""
    from repro_torch.kernels.batched_lora.ref import bf16_bound
    x = v["x"] if v["x"].dim() == 3 else v["x"][:, None]
    ranks = v["ranks"] if ranked else None
    if kind == "bgmv":
        ref, bnd = bf16_bound(x, v["a_pool"], v["b_pool"], v["idx"], scale,
                              ranks)
    else:
        ref, bnd = bf16_bound(x, v["a_dir"], v["b_dir"], v["idx"], scale,
                              ranks, mag=(v["a_mag"], v["b_mag"], v["dmag"]))
    return ((y.double().reshape(ref.shape) - ref.double()).abs()
            / bnd.double().clamp_min(1e-300)).max().item()


def factor_bytes(kind, v):
    """The factor bytes a call must read: one (d_in, r) + (r, d_out) f32
    pair per distinct slot (pairs), or the shared pair (magnitude)."""
    r = v["a_dir"].shape[1]
    slots = len(set(v["idx"].tolist())) if kind == "bgmv" else 1
    return 4 * slots * 2 * D * r


def phase_bgmv(torch, side, worst):
    from repro_torch.kernels.batched_lora.bgmv import variant
    taken = {}
    for kind in ("bgmv", "bgmv_mag"):
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            for r in (8, 16):
                for B, S in BGMV_SHAPES:
                    v = kernel_inputs(torch, B, S, r, dtype, seed=r + (S or 0))
                    var = variant(B, S or 1)
                    taken.setdefault(var, set()).add(f"x{tuple(v['x'].shape)}")
                    for ranked in (False, True):
                        y = call(kind, v, None, ranked)
                        ref = call(kind, v, "torch", ranked)
                        torch.cuda.synchronize()
                        rel, _ = rel_err(y, ref)
                        case = (f"{kind} {dn} r={r} x{tuple(v['x'].shape)} "
                                f"{'ranked' if ranked else 'full'} [{var}]")
                        check(y.shape == ref.shape and bool(
                            torch.isfinite(y.float()).all()), f"{case} shape")
                        check(rel <= TOL[dn], f"{case} rel err {rel:.3e} <= "
                              f"{TOL[dn]}")
                        if dn == "bfloat16":
                            ratio = bgmv_bound_ratio(kind, v, y, ranked)
                            check(ratio <= 1.0, f"{case} within the bf16 "
                                  f"rounding bound: max |err| / bound "
                                  f"{ratio:.3f}")
                            worst[(kind, "bound_ratio")] = max(
                                worst.get((kind, "bound_ratio"), 0), ratio)
                        if ranked:
                            zero = (v["ranks"][v["idx"].long()] == 0)
                            check(bool((y[zero] == 0).all()),
                                  f"{case} rank-0 rows exactly 0")
                        worst[(kind, dn)] = max(worst.get((kind, dn), 0), rel)
    print("bgmv variants taken: " + json.dumps(
        {k: sorted(v) for k, v in taken.items()}))

    rows = {}
    for kind in ("bgmv", "bgmv_mag"):
        rows[kind] = {}
        for label, S in (("decode", None), ("prefill", PAD_W)):
            v = kernel_inputs(torch, ROWS, S, R_MAIN, torch.bfloat16, seed=7)
            y = call(kind, v, None, True)
            ref = call(kind, v, "torch", True)
            rel, err = rel_err(y, ref)
            ratio = bgmv_bound_ratio(kind, v, y, True)
            check(rel <= TOL["bfloat16"] and ratio <= 1.0, f"{kind} {label} "
                  f"bf16 rel err {rel:.3e}, |err| / bound {ratio:.3f}")
            b_ms, b_by = bound(kind, v, "bfloat16")
            lib = library_call(torch, kind, v)
            lib_rel = rel_err(lib().reshape(ref.shape), ref)[0]
            check(lib_rel <= TOL["bfloat16"], f"{kind} {label} library "
                  f"yardstick vs plain {lib_rel:.3e} <= {TOL['bfloat16']}")
            row = {"x": list(v["x"].shape), "variant": variant(ROWS, S or 1),
                   "max_abs_err": err, "rel_err": rel, "bound_ratio": ratio,
                   "tolerance": TOL["bfloat16"]}
            row.update(timings(torch, side, {
                "ms": lambda: call(kind, v, None, True),
                "plain_ms": lambda: call(kind, v, "torch", True),
                "library_ms": lib}))
            row.update(bound_ms=b_ms, bound_by=b_by,
                       bound_share=b_ms / row["ms"],
                       factor_gbps=factor_bytes(kind, v) / row["ms"] / 1e6)
            rows[kind][label] = row
            print(f"{kind} {label} x{tuple(v['x'].shape)} bf16 r={R_MAIN}: "
                  + json.dumps(row))
            key = f"{kind} {label}"
            print(f"{key} [{row['variant']}]: {row['ms']:.5f} ms, "
                  f"one-block-a-row kernel before {BGMV_EARLIER_MS[key]} ms; "
                  f"factors at {row['factor_gbps']:.0f} GB/s; "
                  f"{row['bound_share']:.3f} of the bound ({b_ms:.5f} ms, "
                  f"{b_by}); library {row['library_ms']:.5f} ms "
                  f"({row['ms'] / row['library_ms']:.2f}x); eager "
                  f"{row['eager_ms']:.5f} ms; |err| / bound {ratio:.3f}")
    pf = rows["bgmv"]["prefill"]
    print(f"bgmv prefill faster than the library call: "
          f"{pf['ms'] < pf['library_ms']} ({pf['ms']:.5f} vs "
          f"{pf['library_ms']:.5f} ms)")
    print(f"BGMV_EARLIER_MS = {json.dumps(BGMV_EARLIER_MS)}")
    return rows


FUSED_ORDER = ("x", "w0", "a_dir", "a_mag", "b_dir", "b_mag", "da_dir",
               "db_mag")


def fused_inputs(torch, M, K, N, r, dtype, seed):
    """x N(0, 1); W0 N(0, 0.02²); the adapter's sizes as in phase 3, with
    dA_dir = N(0, 1) x (1/6) x RMS(A_dir) and dB_mag N(0, 1)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    a_dir = n(K, r) / K ** 0.5
    return dict(x=n(M, K).to(dtype), w0=(n(K, N) * 0.02).to(dtype),
                a_dir=a_dir, a_mag=torch.rand(K, generator=g, device="cuda")
                + 0.5, b_dir=n(r, N) / r ** 0.5, b_mag=n(r),
                da_dir=n(K, r) * a_dir.square().mean().sqrt() / 6,
                db_mag=n(r))


def fused_call(v, impl, scale=4.0):
    from repro_torch.kernels import fused_dora
    return fused_dora(*(v[k] for k in FUSED_ORDER), scale=scale, impl=impl)


def fused_bound(v, dtype_name):
    M, K = v["x"].shape
    N, r = v["w0"].shape[1], v["a_dir"].shape[1]
    es = v["x"].element_size()
    nbytes = es * (M * K + K * N + M * N) + 4 * (2 * K * r + K + r * N + 2 * r)
    ops = (2 * M * K * N + M * K + 2 * M * K * r + M * r + 2 * M * r * N
           + 2 * M * N)
    return roofline(nbytes, ops, dtype_name)


# bf16 ms of the CUDA-core fused_dora (PERF.md, the kernel table's row 3:
# NVIDIA H100 80GB HBM3, 700.00 W), printed beside the tensor-core kernel's
FUSED_EARLIER_MS = {"decode": 0.1244, "prefill": 1.240}


def fused_bound_ratio(v, y, scale):
    """max |y − ref| / bound over the elements, for a bf16 output: ref and
    bound from ``ref.bf16_bound``, the cast points' exact value and the
    bound of f32 sums in any order and the two bf16 roundings."""
    from repro_torch.kernels.fused_dora.ref import bf16_bound
    ref, bnd = bf16_bound(*(v[k] for k in FUSED_ORDER), scale)
    return ((y.float() - ref).abs() / bnd).max().item()


def check_fused(case, v, y, ref, dn, worst, scale=4.0):
    """y against the plain output within FUSED_TOL and, in bf16, within
    the rounding bound; returns (rel err, max abs err, bound ratio)."""
    rel, err = rel_err(y, ref)
    check(y.shape == ref.shape and bool(y.float().isfinite().all()), f"{case} shape")
    check(rel <= FUSED_TOL[dn], f"{case} rel err {rel:.3e} <= {FUSED_TOL[dn]}")
    worst[("fused_dora", dn)] = max(worst.get(("fused_dora", dn), 0), rel)
    ratio = None
    if dn == "bfloat16":
        ratio = fused_bound_ratio(v, y, scale)
        check(ratio <= 1.0, f"{case} within the bf16 rounding bound: max "
              f"|err| / bound {ratio:.3f}")
        worst[("fused_dora", "bound_ratio")] = max(
            worst.get(("fused_dora", "bound_ratio"), 0), ratio)
    return rel, err, ratio


def phase_fused_dora(torch, side, worst):
    from repro_torch.kernels.fused_dora.fused_dora import fused_dora_cuda
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        cases = [(M, D, D, r) for r in (8, 16) for M in (ROWS, ROWS * PAD_W)]
        for M, K, N, r in cases + [(37, D, D + 64, R_MAIN)]:
            v = fused_inputs(torch, M, K, N, r, dtype, seed=M + r)
            y, ref = fused_call(v, None), fused_call(v, "torch")
            torch.cuda.synchronize()
            check_fused(f"fused_dora {dn} r={r} x({M}, {K}) W0({K}, {N})",
                        v, y, ref, dn, worst)
    rows = {}
    scale = 4.0
    for label, M in (("decode", ROWS), ("prefill", ROWS * PAD_W)):
        v = fused_inputs(torch, M, D, D, R_MAIN, torch.bfloat16, seed=7)
        dt = v["x"].dtype
        a_eff = (v["a_dir"] + v["da_dir"]).to(dt)
        b_eff = v["b_mag"] + v["db_mag"]
        b_dir = v["b_dir"].to(dt)
        am, bm = v["a_mag"].to(dt), b_eff.to(dt)
        x, w0 = v["x"], v["w0"]

        def lib():
            return torch.matmul(x, w0) + scale * (
                (((x * am) @ a_eff) * bm) @ b_dir)
        ref = fused_call(v, "torch", scale)
        rel, err, ratio = check_fused(f"fused_dora {label} bf16", v,
                                      fused_call(v, None, scale), ref,
                                      "bfloat16", worst, scale)
        lib_rel = rel_err(lib(), ref)[0]
        check(lib_rel <= FUSED_TOL["bfloat16"], f"fused_dora {label} library "
              f"yardstick vs plain {lib_rel:.3e} <= {FUSED_TOL['bfloat16']}")
        b_ms, b_by = fused_bound(v, "bfloat16")
        row = {"x": list(x.shape), "w0": list(w0.shape), "r": R_MAIN,
               "max_abs_err": err, "rel_err": rel, "bound_ratio": ratio,
               "tolerance": FUSED_TOL["bfloat16"]}
        row.update(timings(torch, side, {
            "ms": lambda: fused_dora_cuda(x, w0, a_eff, v["a_mag"], b_dir,
                                          b_eff, scale=scale),
            "plain_ms": lambda: fused_call(v, "torch", scale),
            "library_ms": lib}))
        ops = 2 * M * D * D
        row.update(bound_ms=b_ms, bound_by=b_by,
                   f32_core_bound_ms=fused_bound(v, "float32")[0],
                   tflops=ops / row["ms"] / 1e9,
                   w0_gbps=w0.numel() * w0.element_size() / row["ms"] / 1e6,
                   bound_share=b_ms / row["ms"])
        rows[label] = row
        print(f"fused_dora {label} x{tuple(x.shape)} W0{tuple(w0.shape)} "
              f"bf16 r={R_MAIN}: " + json.dumps(row))
        print(f"fused_dora {label}: {row['ms']:.5f} ms, CUDA-core kernel "
              f"before {FUSED_EARLIER_MS[label]} ms; {row['tflops']:.1f} "
              f"TFLOP/s of x W0, W0 at {row['w0_gbps']:.0f} GB/s; "
              f"{row['bound_share']:.3f} of the bf16 bound ({b_ms:.5f} ms, "
              f"{b_by}); library {row['library_ms']:.5f} ms "
              f"({row['ms'] / row['library_ms']:.2f}x); |err| / bound "
              f"{ratio:.3f}")
    print(f"FUSED_EARLIER_MS = {json.dumps(FUSED_EARLIER_MS)}")
    return rows


def quant_inputs(torch, K, N, mode, gs, seed):
    """Codes and scales of an N(0, 0.02²) weight whose last two columns
    are zero (zero scales)."""
    from repro_torch.kernels import quantize_int4, quantize_int8
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((K, N), generator=g, device="cuda") * 0.02
    w[:, -2:] = 0.0
    quant = quantize_int8 if mode == "int8" else quantize_int4
    return quant(w, group_size=gs)


def quant_bound(x, q, s, dtype_name):
    M, K = x.shape
    N = q.shape[1]
    nbytes = (x.element_size() * (M * K + M * N) + q.numel() * q.element_size()
              + 4 * s.numel())
    return roofline(nbytes, 2 * M * K * N + K * N, dtype_name)


def quant_bound_ratio(x, q, s, y):
    """max |y − ref| / bound over the elements, for a bf16 output: ref and
    bound from ``ref.bf16_bound``, the exact value and the bound of f32
    sums in any order, the scale per element or per group and the output's
    rounding.  A zero-scale column has ref and bound 0 and must be 0."""
    from repro_torch.kernels.quant_matmul.ref import bf16_bound
    ref, bnd = bf16_bound(x, q, s)
    return ((y.double() - ref).abs() / bnd.clamp_min(1e-300)).max().item()


# bf16 ms of the CUDA-core quant_matmul (PERF.md, the kernel table's row 4
# and the FFN shapes below it: NVIDIA H100 80GB HBM3, 700.00 W), printed
# beside the tensor-core kernel's
QUANT_EARLIER_MS = {
    "int8 decode 4096x4096": 0.0390, "int8 prefill 4096x4096": 1.123,
    "int4 decode 4096x4096": 0.0385, "int4 prefill 4096x4096": 1.134,
    "int8 decode 4096x11008": 0.0791, "int8 prefill 4096x11008": 3.132,
    "int8 decode 11008x4096": 0.0963, "int8 prefill 11008x4096": 3.118,
    "int4 decode 4096x11008": 0.0741, "int4 prefill 4096x11008": 2.916,
    "int4 decode 11008x4096": 0.0912, "int4 prefill 11008x4096": 3.166}
# a bf16 call whose groups of 24 rows are not a whole number of the tensor
# cores' k steps, so it keeps qmm_tiled: ragged M and N
QUANT_TILED_CASE = dict(M=37, K=4080, N=4100, mode="int8", gs=24)


def check_quant(case, x, q, s, y, ref, worst):
    """y against the plain output within TOL and, in bf16, within the
    rounding bound; returns (rel err, max abs err, bound ratio)."""
    dn = str(x.dtype).split(".")[-1]
    rel, err = rel_err(y, ref)
    check(y.shape == ref.shape and bool(y.float().isfinite().all()) and bool(
        (y[:, -2:] == 0).all()), f"{case} shape, zero-scale columns "
        f"exactly 0")
    check(rel <= TOL[dn], f"{case} rel err {rel:.3e} <= {TOL[dn]}")
    worst[("quant_matmul", dn)] = max(worst.get(("quant_matmul", dn), 0), rel)
    ratio = None
    if dn == "bfloat16":
        ratio = quant_bound_ratio(x, q, s, y)
        check(ratio <= 1.0, f"{case} within the bf16 rounding bound: max "
              f"|err| / bound {ratio:.3f}")
        worst[("quant_matmul", "bound_ratio")] = max(
            worst.get(("quant_matmul", "bound_ratio"), 0), ratio)
    return rel, err, ratio


def phase_quant_matmul(torch, side, worst):
    from repro_torch.kernels import dequantize, quant_matmul
    from repro_torch.kernels.quant_matmul.quant_matmul import (
        quant_matmul_cuda, variant)
    taken = {}
    for K, N in QUANT_SHAPES:
        for mode in ("int8", "int4"):
            for gs in (None, 128):
                q, s = quant_inputs(torch, K, N, mode, gs, seed=K + N)
                for dtype in (torch.float32, torch.bfloat16):
                    dn = str(dtype).split(".")[-1]
                    for M in (ROWS, ROWS * PAD_W, 37):
                        g = torch.Generator(device="cuda").manual_seed(M)
                        x = torch.randn((M, K), generator=g,
                                        device="cuda").to(dtype)
                        y = quant_matmul(x, q, s)
                        ref = quant_matmul(x, q, s, impl="torch")
                        torch.cuda.synchronize()
                        v = variant(M, K, s.shape[0], dtype)
                        taken.setdefault(v, []).append(f"{dn} M={M}")
                        check_quant(f"quant_matmul {mode} g={gs} {dn} "
                                    f"x({M}, {K}) W({K}, {N}) [{v}]",
                                    x, q, s, y, ref, worst)
    c = QUANT_TILED_CASE
    q, s = quant_inputs(torch, c["K"], c["N"], c["mode"], c["gs"], seed=3)
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((c["M"], c["K"]), generator=g,
                    device="cuda").to(torch.bfloat16)
    v = variant(c["M"], c["K"], s.shape[0], x.dtype)
    check(v == "qmm_tiled", f"quant_matmul bf16 groups of {c['gs']} take "
          f"qmm_tiled: {v}")
    taken.setdefault(v, []).append(f"bfloat16 M={c['M']} g={c['gs']}")
    check_quant(f"quant_matmul {c['mode']} g={c['gs']} bfloat16 "
                f"x({c['M']}, {c['K']}) W({c['K']}, {c['N']}) [{v}]",
                x, q, s, quant_matmul(x, q, s),
                quant_matmul(x, q, s, impl="torch"), worst)
    print("quant_matmul variants taken: " + json.dumps(
        {k: sorted(set(v)) for k, v in taken.items()}))
    rows = {}
    for K, N in QUANT_SHAPES:
        for mode, gs in QUANT_MODES:
            q, s = quant_inputs(torch, K, N, mode, gs, seed=7)
            for label, M in (("decode", ROWS), ("prefill", ROWS * PAD_W)):
                g = torch.Generator(device="cuda").manual_seed(7)
                x = torch.randn((M, K), generator=g,
                                device="cuda").to(torch.bfloat16)

                def lib():
                    return torch.matmul(x, dequantize(q, s).to(x.dtype))
                key = f"{mode} {label} {K}x{N}"
                ref = quant_matmul(x, q, s, impl="torch")
                rel, err, ratio = check_quant(
                    f"quant_matmul {key} bf16", x, q, s, quant_matmul(x, q, s),
                    ref, worst)
                lib_rel = rel_err(lib(), ref)[0]
                check(lib_rel <= TOL["bfloat16"], f"quant_matmul {label} "
                      f"library yardstick vs plain {lib_rel:.3e}")
                b_ms, b_by = quant_bound(x, q, s, "bfloat16")
                row = {"x": [M, K], "w": [K, N], "mode": mode, "group": gs,
                       "variant": variant(M, K, s.shape[0], x.dtype),
                       "max_abs_err": err, "rel_err": rel,
                       "bound_ratio": ratio, "tolerance": TOL["bfloat16"],
                       "bound_ms": b_ms, "bound_by": b_by,
                       "f32_core_bound_ms": quant_bound(x, q, s,
                                                        "float32")[0]}
                row.update(timings(torch, side, {
                    "ms": lambda: quant_matmul_cuda(x, q, s),
                    "plain_ms": lambda: quant_matmul(x, q, s, impl="torch"),
                    "library_ms": lib}))
                code_bytes = q.numel() * q.element_size()
                row.update(bound_share=b_ms / row["ms"],
                           tflops=2 * M * K * N / row["ms"] / 1e9,
                           code_gbps=code_bytes / row["ms"] / 1e6)
                rows[key] = row
                print(f"quant_matmul {mode} g={gs} {label} x({M}, {K}) "
                      f"W({K}, {N}) bf16: " + json.dumps(row))
                rate = (f"{row['tflops']:.1f} TFLOP/s" if label == "prefill"
                        else f"codes at {row['code_gbps']:.0f} GB/s")
                print(f"quant_matmul {key} [{row['variant']}]: "
                      f"{row['ms']:.5f} ms, CUDA-core kernel before "
                      f"{QUANT_EARLIER_MS[key]} ms; {rate}; "
                      f"{row['bound_share']:.3f} of the bf16 bound "
                      f"({b_ms:.5f} ms, {b_by}); library "
                      f"{row['library_ms']:.5f} ms "
                      f"({row['ms'] / row['library_ms']:.2f}x); eager "
                      f"{row['eager_ms']:.5f} ms; |err| / bound {ratio:.3f}")
    print(f"QUANT_EARLIER_MS = {json.dumps(QUANT_EARLIER_MS)}")
    return rows


# --- flash_attention and ssd_scan (the repo's configs, written out) -------

# src/repro/configs/*.py: (heads, kv heads, head dim) and the SSM widths
LLAMA2_7B = dict(H=32, K=32, dh=128)                 # configs/llama2_7b.py
QWEN3_32B = dict(H=64, K=8, dh=128)                  # configs/qwen3_32b.py
GEMMA3_1B = dict(H=4, K=1, dh=256, window=512)       # configs/gemma3_1b.py
# configs/mamba2_2_7b.py: d_inner 2 x 2560 = 5120 over heads of 64
MAMBA2_2_7B = dict(H=80, P=64, N=128, G=1, chunk=128)
# configs/jamba_v0_1_52b.py: its SSM layers
JAMBA_V0_1 = dict(H=128, P=64, N=16, G=1, chunk=128)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}      # absolute
SSD_RTOL, SSD_ATOL = 1e-3, 1e-4                      # f32, elementwise
SSD_BF16_TOL = TOL["bfloat16"]                       # relative to max |y|


def qkv(torch, B, Sq, Sk, H, K, dh, dtype, seed):
    """q (B, Sq, H, dh), k and v (B, Sk, K, dh), N(0, 1), on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((B, S, h, dh), generator=g, device="cuda").to(dtype)
            for S, h in ((Sq, H), (Sk, K), (Sk, K))]


def head_major(t):
    """The same (B, S, H, ...) values stored head-major underneath, so the
    dispatchers' fold of heads into the batch is a view and a timed call
    is the kernel alone."""
    return t.transpose(1, 2).contiguous().transpose(1, 2)


def fold(t):
    """(B, S, H, d) → (B·H, S, d), as the flash_attention dispatcher folds."""
    return t.transpose(1, 2).reshape(-1, t.shape[1], t.shape[3])


def check_flash(label, y, q, k, v, **kw):
    """Kernel output y against the plain version in f32 on the same values
    of q, k, v, all in the (B·H, S, dh) layout with the bhsd knobs ``kw``:
    y finite and of q's shape, within FLASH_TOL absolute, and in bf16 also
    within ``bf16_bound_bhsd``'s elementwise bound (the rounding of the
    softmax weights and of the output, PERF.md).  Returns the errors and
    the plain output."""
    import torch
    from repro_torch.kernels.flash_attention.ref import bf16_bound_bhsd
    dn = str(y.dtype).split(".")[-1]
    ref, bnd = bf16_bound_bhsd(q.float(), k.float(), v.float(), **kw)
    d = (y.float() - ref).abs()
    err, ratio = d.max().item(), (d / bnd).max().item()
    ok = (y.shape == q.shape and bool(torch.isfinite(y.float()).all())
          and err <= FLASH_TOL[dn])
    msg = f"{label}: max abs err {err:.3e} <= {FLASH_TOL[dn]}"
    if dn == "bfloat16":
        ok = ok and ratio <= 1.0
        msg += f", worst |err| / rounding bound {ratio:.3f} <= 1"
    check(ok, msg)
    return {"max_abs_err": err, "bound_ratio": ratio,
            "rel_err": err / ref.abs().max().item()}, ref


def max_abs(y, ref):
    return (y.float() - ref.float()).abs().max().item()


def valid_pairs(Sq, Sk, causal, window, q_offset=None, sk_valid=0):
    """(query row, key) pairs the masks keep, counted from this run's
    shapes; a row with no valid key averages v over all Sk keys."""
    q_offset = Sk - Sq if q_offset is None else q_offset
    qi = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.full(Sq, min(sk_valid or Sk, Sk), np.int64)
    if causal:
        hi = np.minimum(hi, qi + 1)
    lo = np.maximum(qi - window + 1, 0) if window is not None else 0 * qi
    n = np.maximum(hi - lo, 0)
    return int(np.where(n > 0, n, Sk).sum())


def flash_ops(BH, dh, pairs):
    """QK^T and PV over the valid pairs (2 dh each), scale, exp and the
    running sums (5 a pair)."""
    return BH * pairs * (4 * dh + 5)


def flash_bound(BH, Sq, Sk, BK, dh, es, pairs, dtype_name):
    """q, k, v read once and the output written once; ``flash_ops``."""
    nbytes = es * (2 * BH * Sq * dh + 2 * BK * Sk * dh)
    return roofline(nbytes, flash_ops(BH, dh, pairs), dtype_name)


def sdpa_call(torch, q, k, v, causal, window):
    """One PyTorch call for the same function in the (B, H, S, dh) layout:
    a yardstick only, never called by the port."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    Sq, Sk = q.shape[1], k.shape[1]
    gqa = q.shape[2] != k.shape[2]
    if window is None and (not causal or Sq == Sk or Sq == 1):
        causal_flag = causal and Sq == Sk
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal_flag, enable_gqa=gqa)
    qi = torch.arange(Sq, device="cuda")[:, None] + (Sk - Sq)
    kj = torch.arange(Sk, device="cuda")[None, :]
    mask = kj <= qi if causal else torch.ones_like(kj <= qi)
    if window is not None:
        mask = mask & (kj > qi - window)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=gqa)


FLASH_TIMED = (   # label, config, B, Sq, Sk, causal
    ("prefill", LLAMA2_7B, 1, 4096, 4096, True),
    ("decode", LLAMA2_7B, 8, 1, 128, True),
    ("gemma3_local", GEMMA3_1B, 1, 4096, 4096, True),
    ("qwen3_prefill", QWEN3_32B, 1, 4096, 4096, True),
    # one query row over a long cache: BK x ceil(rep / 16) blocks of the
    # decode variant, 8 for qwen3-32b and 1 for a gemma3-1b global layer
    ("qwen3_decode", QWEN3_32B, 1, 1, 4096, True),
    ("gemma3_global_decode", dict(GEMMA3_1B, window=None), 1, 1, 4096, True),
)
# bf16 ms of the first, CUDA-core flash_attention at these shapes (PERF.md,
# the kernel table's row 5: NVIDIA H100 80GB HBM3, 700.00 W), printed beside
# the tensor-core kernel's
FLASH_EARLIER_MS = {"prefill": 9.692, "decode": 0.07117, "gemma3_local": 0.6629}


def ptxas_usage(log: str) -> dict[str, dict[str, int]]:
    """Per kernel (mangled name), from an ``-Xptxas -v`` log: registers,
    stack frame and spill store / load bytes."""
    out: dict[str, dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )"
                      r"(\w+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
        elif name is None:
            continue
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                            r"stores, (\d+) bytes spill loads", line):
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        elif m := re.search(r"Used (\d+) registers", line):
            out[name]["registers"] = int(m.group(1))
    return out


def count_opcode(sass: str, opcode: str) -> dict[str, int]:
    """``cuobjdump -sass`` text → {function: instructions starting with
    ``opcode``}."""
    out: dict[str, int] = {}
    fn = None
    pat = re.compile(r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?" + re.escape(opcode)
                     + r"\b")
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, 0)
        elif fn is not None and pat.search(line):
            out[fn] += 1
    return out


def template_args(tail):
    """The template arguments that open ``tail``, the rest of a mangled
    name after the kernel's own: f32 / bf16 for a type, the digits of an
    int or bool."""
    out = []
    m = re.match(r"I((?:f|13__nv_bfloat16|L[ib]\d+E)+)E", tail)
    for t in re.findall(r"f|13__nv_bfloat16|L[ib]\d+E", m.group(1) if m else ""):
        out.append({"f": "f32", "13__nv_bfloat16": "bf16"}.get(t, t[2:-1]))
    return out


def check_build(name, short, held, n_held, what, tensor_core=""):
    """The built library ``name``'s kernels whose mangled names hold
    ``held`` spill nothing (``-Xptxas -v``), those of them whose names also
    hold ``tensor_core`` (by default all of them; None for none) run on the
    tensor cores (a count of HMMA instructions from ``cuobjdump -sass``
    above 0 in each), and there are ``n_held`` of them (``what``).
    ``short`` is the regular expression that finds each kernel's name in
    its mangled one.  Returns what was read, by short name and template
    arguments."""
    from repro_torch.kernels import _build
    usage = ptxas_usage(_build.log_path(name).read_text())
    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    lib = _build.build_all([name])[name]
    hmma = count_opcode(subprocess.run(
        [str(tool), "-sass", str(lib)], capture_output=True, text=True,
        check=True, timeout=300).stdout, "HMMA")
    out = {}
    for fn, u in sorted(usage.items()):
        m = re.search(short, fn)
        key = m.group(0) + "<" + ",".join(template_args(fn[m.end():])) + ">"
        out[key] = dict(u, hmma=hmma.get(fn))
        print(f"{name} kernel {key}: {u['registers']} registers, "
              f"{u['spill_stores']} / {u['spill_loads']} bytes spilled, "
              f"{hmma.get(fn)} HMMA")
        if held in fn:
            if tensor_core is not None and (tensor_core or held) in fn:
                check(hmma.get(fn, 0) > 0, f"{name} kernel {key} runs on the "
                      f"tensor cores: {hmma.get(fn)} HMMA instructions")
            check(u["spill_stores"] == 0 and u["spill_loads"] == 0,
                  f"{name} kernel {key} spills nothing")
    check(sum(held in fn for fn in usage) == n_held,
          f"{n_held} {name} kernels ({what})")
    return out


def phase_flash(torch, side, worst):
    """Times at full width, bf16, through the dispatcher on head-major
    inputs; the outputs held as phase 6 holds its own."""
    from repro_torch.kernels import flash_attention
    rows = {}
    for label, c, B, Sq, Sk, causal in FLASH_TIMED:
        H, K, dh, window = c["H"], c["K"], c["dh"], c.get("window")
        q, k, v = (head_major(t) for t in qkv(torch, B, Sq, Sk, H, K, dh,
                                               torch.bfloat16, seed=7))
        kw = dict(causal=causal, window=window)
        y = flash_attention(q, k, v, **kw)
        e, plain = check_flash(
            f"flash_attention {label} q{tuple(q.shape)} k{tuple(k.shape)} bf16",
            fold(y), fold(q), fold(k), fold(v), scale=dh ** -0.5,
            q_offset=Sk - Sq, **kw)
        key = ("flash_attention", "bfloat16")
        worst[key] = max(worst.get(key, 0), e["max_abs_err"])
        lib = sdpa_call(torch, q, k, v, causal, window)
        lib_err = max_abs(lib().reshape(plain.shape), plain)
        check(lib_err <= FLASH_TOL["bfloat16"], f"flash_attention {label} "
              f"library yardstick vs plain {lib_err:.3e}")
        pairs = valid_pairs(Sq, Sk, causal, window)
        b_ms, b_by = flash_bound(B * H, Sq, Sk, B * K, dh, 2, pairs, "bfloat16")
        row = dict(e, q=list(q.shape), k=list(k.shape), causal=causal,
                   window=window, tolerance=FLASH_TOL["bfloat16"],
                   bound_ms=b_ms, bound_by=b_by, valid_pairs_per_head=pairs,
                   f32_core_bound_ms=flash_bound(B * H, Sq, Sk, B * K, dh, 2,
                                                 pairs, "float32")[0])
        row.update(timings(torch, side, {
            "ms": lambda: flash_attention(q, k, v, **kw),
            "plain_ms": lambda: flash_attention(q, k, v, impl="torch", **kw),
            "library_ms": lib}, reps=3, iters=10, warmup=3))
        row.update(tflops=flash_ops(B * H, dh, pairs) / row["ms"] / 1e9,
                   bound_share=b_ms / row["ms"])
        rows[label] = row
        print(f"flash_attention {label} q{tuple(q.shape)} k{tuple(k.shape)} "
              f"bf16: " + json.dumps(row))
        earlier = ("" if label not in FLASH_EARLIER_MS else
                   f", CUDA-core kernel before {FLASH_EARLIER_MS[label]} ms")
        print(f"flash_attention {label}: {row['ms']:.5f} ms{earlier}; "
              f"{row['tflops']:.1f} TFLOP/s, {row['bound_share']:.3f} of the "
              f"bf16 bound ({b_ms:.5f} ms, {b_by}); SDPA "
              f"{row['library_ms']:.5f} ms ({row['ms'] / row['library_ms']:.2f}x)")
        del q, k, v, y, plain, lib
    return rows


def ssd_inputs(torch, b, S, c, dtype, seed):
    """As init_params draws the mixer (src/repro/models/model.py:73-75):
    A_log = log(linspace(1, 16, H)), dt = softplus(z - 2) with z ~ N(0, 1);
    x, B and C ~ N(0, 1)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    H, P, N, G = c["H"], c["P"], c["N"], c["G"]

    def n(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    return dict(x=n(b, S, H, P).to(dtype),
                dt=torch.nn.functional.softplus(n(b, S, H) - 2.0),
                A_log=torch.log(torch.linspace(1.0, 16.0, H, device="cuda")),
                B=n(b, S, G, N).to(dtype), C=n(b, S, G, N).to(dtype))


SSD_ORDER = ("x", "dt", "A_log", "B", "C")


def ssd_call(v, impl=None, **kw):
    from repro_torch.kernels import ssd_scan
    return ssd_scan(*(v[k] for k in SSD_ORDER), impl=impl, **kw)


def ssd_f32_errs(y, st, y_ref, st_ref):
    """(worst |d| / (atol + rtol |ref|) over y and the state, error
    relative to max |y|)."""
    def ratio(a, r):
        return ((a - r).abs() / (SSD_ATOL + SSD_RTOL * r.abs())).max().item()
    return max(ratio(y, y_ref), ratio(st, st_ref)), rel_err(y, y_ref)[0]


def ssd_bf16_errs(torch, v, y, st, chunk):
    """Kernel bf16 against the plain version on the same bf16 inputs
    (held), against ``ssd_scan/ref.py::bf16_bound`` elementwise (held:
    the largest |y − ref| / bound) and against ``cast_point_interval``
    (held: no output outside it); printed beside them, that plain
    version against itself in f32 and the kernel against the plain f32
    version."""
    from repro_torch.kernels.ssd_scan.ref import (bf16_bound,
                                                  cast_point_interval)
    y_p, st_p = ssd_call(v, "torch", chunk=chunk)
    f32 = {k: t.float() for k, t in v.items()}
    y_f, _ = ssd_call(f32, "torch", chunk=chunk)
    ins = [v[k] for k in SSD_ORDER]
    ref, bnd = bf16_bound(*ins, min(chunk, v["x"].shape[1]))
    lo, hi = cast_point_interval(*ins, min(chunk, v["x"].shape[1]))
    outside = int(((y < lo) | (y > hi)).sum().item())
    wide = (lo != hi).float().mean().item()
    del lo, hi
    return {"kernel_vs_plain": max(rel_err(y, y_p)[0], rel_err(st, st_p)[0]),
            "cast_point_outside": outside, "cast_point_wide": wide,
            "max_abs_err": rel_err(y, y_p)[1],
            "bound_ratio": ((y.float() - ref).abs() / bnd).max().item(),
            "plain_bound_ratio": ((y_p.to(y.dtype).float() - ref).abs()
                                  / bnd).max().item(),
            "plain_bf16_vs_f32": rel_err(y_p, y_f)[0],
            "kernel_vs_plain_f32": rel_err(y, y_f)[0]}


def check_ssd_bf16(torch, label, v, y, st, chunk):
    e = ssd_bf16_errs(torch, v, y, st, chunk)
    check(e["kernel_vs_plain"] <= SSD_BF16_TOL and e["bound_ratio"] <= 1.0
          and e["cast_point_outside"] == 0,
          f"{label}: rel err {e['kernel_vs_plain']:.3e} <= {SSD_BF16_TOL}, "
          f"worst |err| / bf16_bound {e['bound_ratio']:.3f} <= 1 and "
          f"{e['cast_point_outside']} outputs outside cast_point_interval "
          f"(wider than one value at {e['cast_point_wide']:.3f} of them) (plain "
          f"bf16 {e['plain_bound_ratio']:.3f} of the bound; plain bf16 vs "
          f"f32 {e['plain_bf16_vs_f32']:.3e}, kernel vs plain f32 "
          f"{e['kernel_vs_plain_f32']:.3e})")
    return e


def check_ssd_f32(label, v, y, st, chunk):
    from repro_torch.kernels import ssd_ref
    y_r, st_r = ssd_ref(*(v[k] for k in SSD_ORDER),
                        min(chunk, v["x"].shape[1]))
    ratio, rel = ssd_f32_errs(y, st, y_r, st_r)
    check(ratio <= 1.0, f"{label}: kernel vs ssd_ref within rtol {SSD_RTOL} "
          f"atol {SSD_ATOL} (worst |err| / bound {ratio:.3f}; {rel:.3e} of "
          f"max |y|)")
    return {"vs_ssd_ref_bound_ratio": ratio, "vs_ssd_ref_rel": rel,
            "max_abs_err": max_abs(y, y_r), "rel_err": rel}, (y_r, st_r)


def ssd_bound(v, dtype_name, chunk):
    """x, dt, B, C read once, y and the state written once; C.B^T once a
    group and chunk (the triangle, 2N a pair), and per head and chunk the
    decayed triangle's product with x.dt (2P + 2 a pair), the state term
    and the chunk's end state (2NP a step each)."""
    b, S, H, P = v["x"].shape
    G, N = v["B"].shape[2:]
    Q = min(chunk, S)
    es = v["x"].element_size()
    nbytes = (es * (2 * b * S * H * P + 2 * b * S * G * N) + 4 * b * S * H
              + 4 * H + 4 * b * H * N * P)
    tri = Q * (Q + 1) // 2
    ops = (b * G * (S // Q) * tri * 2 * N
           + b * H * (S // Q) * (tri * (2 * P + 2) + 4 * Q * N * P + 2 * Q * P
                                 + Q * N))
    return roofline(nbytes, ops, dtype_name)


# label: config, b, S, chunk, dtype of phase 2's timed ssd_scan calls
SSD_TIMED = {
    "mamba2 bf16": (MAMBA2_2_7B, 1, 4096, 128, "bfloat16"),
    "mamba2 f32": (MAMBA2_2_7B, 1, 4096, 128, "float32"),
    "mamba2 bf16 chunk 256": (MAMBA2_2_7B, 1, 4096, 256, "bfloat16"),
    "jamba bf16": (JAMBA_V0_1, 1, 4096, 128, "bfloat16"),
}
# ms of the one-block-a-head CUDA-core kernel (PR 13's source) at these
# calls, the mean of the two rounds of scripts/ssd_scan_variants.py
# --earlier (PERF.md, the kernel table's row 6: NVIDIA H100 80GB HBM3,
# 700.00 W), printed beside the chunk-parallel kernel's
SSD_EARLIER_MS = {"mamba2 bf16": 3.6326, "mamba2 f32": 3.7915,
                  "mamba2 bf16 chunk 256": 4.6966, "jamba bf16": 1.6812}


def ssd_timed_inputs(torch, label):
    """Head-major inputs of a SSD_TIMED call (the dispatcher's fold of heads
    into the batch is then a view) and its chunk."""
    c, b, S, chunk, dn = SSD_TIMED[label]
    v = ssd_inputs(torch, b, S, c, getattr(torch, dn), seed=7)
    v = {k: t if k == "A_log" else head_major(t) for k, t in v.items()}
    return v, chunk


def ssd_check(torch, label, v, y, st, chunk):
    """The phase 2 / phase 6 check of one output: shape, finite, and bf16
    as ``check_ssd_bf16``, f32 as ``check_ssd_f32``."""
    check(y.shape == v["x"].shape and bool(torch.isfinite(y.float()).all()
                                           and torch.isfinite(st).all()),
          f"{label} shape, finite")
    if y.dtype == torch.bfloat16:
        e = check_ssd_bf16(torch, label, v, y, st, chunk)
        return dict(e, rel_err=e["kernel_vs_plain"]), None
    return check_ssd_f32(label, v, y, st, chunk)


def phase_ssd(torch, side, worst):
    """The SSD_TIMED calls at full width through the dispatcher on
    head-major inputs, each held as phase 6 holds its own, timed beside
    the plain version and SSD_EARLIER_MS, with its variant and blocks."""
    from repro_torch.kernels.ssd_scan import ssd_scan as K
    rows = {}
    for label, (c, b, S, chunk, dn) in SSD_TIMED.items():
        v, chunk = ssd_timed_inputs(torch, label)
        y, st = ssd_call(v, chunk=chunk)
        name = f"ssd_scan {label} x{tuple(v['x'].shape)} chunk {chunk}"
        e, _ = ssd_check(torch, name, v, y, st, chunk)
        key = ("ssd_scan", dn)
        worst[key] = max(worst.get(key, 0), e["rel_err"])
        b_ms, b_by = ssd_bound(v, dn, chunk)
        blocks = K.blocks(b * c["H"], b * c["G"], S, c["P"], c["N"], chunk,
                          v["x"].dtype)
        row = dict(e, x=list(v["x"].shape), N=c["N"], chunk=chunk,
                   tolerance=SSD_BF16_TOL if dn == "bfloat16" else
                   [SSD_RTOL, SSD_ATOL], bound_ms=b_ms, bound_by=b_by,
                   f32_core_bound_ms=ssd_bound(v, "float32", chunk)[0],
                   library_ms=None, eager_library_ms=None,
                   library_ms_range=None, eager_library_ms_range=None,
                   variant=K.variant(v["x"].dtype), blocks=blocks)
        row.update(timings(torch, side, {
            "ms": lambda: ssd_call(v, chunk=chunk),
            "plain_ms": lambda: ssd_call(v, "torch", chunk=chunk)},
            reps=3, iters=10, warmup=3))
        row["bound_share"] = b_ms / row["ms"]
        rows[label] = row
        print(f"{name} {dn}: " + json.dumps(row))
        print(f"ssd_scan {label}: {row['ms']:.5f} ms (variant "
              f"{row['variant']}, blocks {blocks}); one-block-a-head kernel "
              f"before {SSD_EARLIER_MS[label]} ms; plain "
              f"{row['plain_ms']:.4f} ms; bound "
              f"{b_ms:.5f} ms ({b_by}, {row['bound_share']:.3f} of it), "
              f"f32-core {row['f32_core_bound_ms']:.4f} ms")
        del v, y, st
    print(f"SSD_EARLIER_MS = {json.dumps(SSD_EARLIER_MS)}")
    return rows


def phase_kernels(torch):
    worst = {}
    # One capture stream for all timings: cuBLAS keeps a workspace for
    # each stream it runs on, cleared below.
    side = torch.cuda.Stream()
    rows = phase_bgmv(torch, side, worst)
    rows["fused_dora"] = phase_fused_dora(torch, side, worst)
    rows["quant_matmul"] = phase_quant_matmul(torch, side, worst)
    rows["flash_attention"] = phase_flash(torch, side, worst)
    rows["ssd_scan"] = phase_ssd(torch, side, worst)
    print("worst relative error by kernel and dtype: "
          + json.dumps({f"{k} {d}": e for (k, d), e in worst.items()}))
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()  # so the engine's peak is its own
    return rows


# ---------------------------------------------------------------------------
# phases 3-5: the paths at full width
# ---------------------------------------------------------------------------

def counters():
    from repro_torch.kernels.batched_lora import bgmv
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_dora import fused_dora
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.kernels.ssd_scan import ssd_scan
    return bgmv, fused_dora, quant_matmul, flash_attention, ssd_scan


def reset_launches():
    for m in counters():
        m.reset_launches()


def read_launches():
    out = {}
    for m in counters():
        out.update(m.LAUNCHES)
    return out


def check_launches(launches, expect, n_layers, passes, label, what):
    """Every kernel launched ``expect[name]`` x ``n_layers`` x ``passes``
    times (0 for a kernel not named)."""
    for name in sorted(launches):
        k = expect.get(name, 0)
        check(launches[name] == k * n_layers * passes,
              f"{label}: {name} launched {launches[name]} times = {k} x "
              f"{n_layers} x ({what})")


def requests(rng, tenants, vocab):
    """12 requests: the first 7 share one prompt (6 tenants + the null
    tenant), the rest have prompts of 16-64 tokens."""
    shared = rng.integers(0, vocab, size=48).astype(np.int32)
    reqs = [(t, shared) for t in tenants] + [(None, shared)]
    for i in range(12 - len(reqs)):
        n = int(rng.integers(16, PAD_W + 1))
        reqs.append((tenants[i % len(tenants)],
                     rng.integers(0, vocab, size=n).astype(np.int32)))
    return reqs


def engine(params, cfg, store):
    from repro_torch.serve import ServeEngine
    return ServeEngine(params, cfg, store, max_rows=ROWS, max_prompt_len=PAD_W,
                       max_len=MAX_LEN, decode_chunk=CHUNK, device="cuda")


def serve(torch, eng, reqs, label, *, expect=None):
    """Run ``reqs`` through ``eng`` with every launch count at 0; with
    ``expect`` ({kernel: launches per layer and forward pass}), hold the
    counts to it, and where the first 7 requests share one prompt (as
    ``requests`` makes them) require more than one continuation among
    them."""
    torch.cuda.synchronize()
    reset_launches()
    rids = [eng.submit(t, p, N_NEW) for t, p in reqs]
    results = eng.run()
    launches = read_launches()
    st = eng.last_run
    check(len(results) == len(reqs) and all(
        results[r].shape == (N_NEW,) for r in rids),
        f"{label}: {len(reqs)} requests returned {N_NEW} tokens each")
    if expect is not None:
        check_launches(launches, expect, eng.cfg.n_layers,
                       st["prefills"] + st["decode_steps"], label,
                       f"{st['prefills']} prefills + {st['decode_steps']} "
                       f"decode steps")
    outs = [results[r] for r in rids]
    shared = len(reqs) >= 7 and all(np.array_equal(p, reqs[0][1])
                                    for _, p in reqs[:7])
    if expect is not None and shared:
        first = [tuple(o.tolist()) for o in outs[:7]]
        check(len(set(first)) >= 2, f"{label}: {len(set(first))} distinct "
              f"continuations of one prompt over 6 tenants + the null "
              f"tenant")
    return outs, st, launches


def admitted_batch(torch, store, reqs, rows=ROWS):
    """The first ``rows`` requests as one admitted prefill batch, and the
    index of each row's last prompt token."""
    tokens = np.zeros((rows, PAD_W), np.int32)
    lens = np.ones((rows,), np.int64)
    slots = np.zeros((rows,), np.int32)
    for i, (t, p) in enumerate(reqs[:rows]):
        tokens[i, :p.size], lens[i] = p, p.size
        slots[i] = store.null_slot if t is None else store.slot_of(t)
    batch = {"tokens": torch.as_tensor(tokens, device="cuda"),
             "adapter_idx": torch.as_tensor(slots, device="cuda")}
    return batch, torch.as_tensor(lens - 1, device="cuda")


def prefill_logits(torch, batch, last):
    """logits(tree, cfg, depth, impl): the prefill logits at each row's
    last prompt token of ``tree`` cut to its first ``depth`` layers (the
    same weights and head), every kernel of the forward at ``impl``."""
    from repro_torch.models import model as M
    from repro_torch.utils import pytree as pt
    ar = torch.arange(batch["tokens"].shape[0], device="cuda")

    def logits(tree, cfg, depth, impl):
        cut = dict(tree, blocks=pt.tree_map(lambda t: t[:depth],
                                            tree["blocks"]))
        h, _, _ = M.forward(cut, batch, cfg, kernel_impl=impl)
        return (h[ar, last] @ M._head_kernel(tree, cfg).to(h.dtype)).float()
    return logits


def to_f32(tree):
    from repro_torch.utils import pytree as pt
    return pt.tree_map(lambda t: t.float() if t.is_floating_point() else t,
                       tree)


def logits_checks(torch, label, tree, cfg, logits, extra=None,
                  depth=CHECK_DEPTH, depths=DEPTHS):
    """Prefill logits with the kernels against the plain versions
    (``kernel_impl="torch"``), relative to max |logit|.

    With the bf16 weights the model is cut to its first ``depth`` layers
    and held at 2e-2; with the weights cast to f32 all layers are
    held at LOGITS_F32_TOL.  The kernels round at other points than the
    plain versions (PERF.md), and a random bf16 network amplifies a
    rounding difference with depth as it amplifies bf16 arithmetic
    itself, so the bf16 readings at each depth in ``depths`` are printed
    beside plain bf16 against plain f32.  ``extra(f32_tree)`` returns
    further f32 readings {name: (value, tolerance)}."""
    f32 = to_f32(tree)
    by_depth = {}
    for d in depths:
        plain = logits(tree, cfg, d, "torch")
        by_depth[d] = {
            "kernel_vs_plain_bf16": rel_err(logits(tree, cfg, d, None),
                                            plain)[0],
            "plain_bf16_vs_f32": rel_err(plain, logits(f32, cfg, d,
                                                       "torch"))[0]}
    n = cfg.n_layers
    f32_checks = {"kernel_vs_plain_f32": (
        rel_err(logits(f32, cfg, n, None), logits(f32, cfg, n, "torch"))[0],
        LOGITS_F32_TOL)}
    if extra is not None:
        f32_checks.update(extra(f32))
    del f32
    print(f"{label} prefill logits, relative to max |logit|, by depth: "
          + json.dumps(by_depth))
    out = {"by_depth": by_depth}
    for name, (err, tol) in f32_checks.items():
        check(err <= tol, f"{label} prefill logits, {n} layers, f32 weights, "
              f"{name.replace('_', ' ')}: {err:.3e} <= {tol}")
        out[name] = err
    err = by_depth[depth]["kernel_vs_plain_bf16"]
    tol = TOL["bfloat16"]
    check(err <= tol, f"{label} prefill logits, {depth} layers, bf16 "
          f"weights, kernel vs plain: {err:.3e} <= {tol}")
    return out


def profiled(fn, cpu=True):
    """Run ``fn`` under torch.profiler; returns ({kernel name: device
    ms}, {kernel name: launches}) from its CUDA kernel events.
    ``cpu=False`` records no host op events (far less overhead on a step
    of ~10^4 ops)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        fn()
    by_name, counts = {}, {}
    for e in prof.events():
        # a recording profiler opens the port's obs scopes
        # ("kernels/bgmv_mag", ...): their device-side ranges span
        # kernels counted on their own
        if e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
            counts[e.name] = counts.get(e.name, 0) + 1
    return by_name, counts


def profile_run(torch, eng, reqs, label, kernels=()):
    """Device busy share of one prefill + one decode chunk of the engine
    (8 rows), from torch.profiler's kernel events; the profiler's own
    host cost inflates the wall time, so the share is a lower bound.
    ``kernels``, pairs (name, part): also the device ms of the kernels
    whose names hold ``part``, and their share of the busy time."""
    for t, p in reqs[:ROWS]:
        eng.submit(t, p, CHUNK + 1)
    torch.cuda.synchronize()
    by_name, _ = profiled(eng.run)
    st = eng.last_run
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"wall_ms": 1e3 * st["wall_seconds"], "device_busy_ms": busy_ms,
           "busy_share": busy_ms / (1e3 * st["wall_seconds"]),
           "prefill_ms": 1e3 * st["prefill_seconds"][0],
           "decode_chunk_ms": 1e3 * st["chunk_seconds"][0],
           "top_kernels_ms": {k[:80]: v for k, v in top}}
    for name, part in kernels:
        ms = sum(v for k, v in by_name.items() if part in k)
        out.update({f"{name}_device_ms": ms,
                    f"{name}_share_of_busy": ms / busy_ms})
    print(f"profile {label} (1 prefill + 1 decode chunk, 8 rows): "
          + json.dumps(out))
    return out


def engine_report(label, st, n_req, peak):
    out = {"requests": n_req, "tokens": st["tokens"], "peak_bytes": peak,
           "wall_s": st["wall_seconds"],
           "tokens_per_s": st["tokens"] / st["wall_seconds"],
           "prefills": st["prefills"], "decode_steps": st["decode_steps"],
           "prefill_ms": [1e3 * s for s in st["prefill_seconds"]],
           "decode_chunk_ms": [1e3 * s for s in st["chunk_seconds"]]}
    print(f"engine {label}: " + json.dumps(out))
    return out


def draw(torch, cfg):
    """The llama2-7b backbone from the seeded generator (the same weights
    on every call) and the generator, on the card."""
    from repro_torch.models import model as M
    g = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = M.init_params(g, cfg, device="cuda")
    torch.cuda.synchronize()
    print(f"llama2-7b params drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    return params, g


def phase_main_path(torch):
    """Phase 3.  Returns the report, the launch counts and what phases 4
    and 5 reuse (the backbone, the dora_mag store, its shared adapter and
    tenant deltas, the requests)."""
    from repro_torch.configs import get_config
    from repro_torch.core.dora import magnitude
    from repro_torch.core.peft import add_lora
    from repro_torch.serve import AdapterStore
    from repro_torch.utils import pytree as pt

    cfg = get_config("llama2-7b")
    params, g = draw(torch, cfg)
    rng = np.random.default_rng(0)
    ranks = [2, 4, 8, 2, 4, 8]
    tenants = [f"tenant{i}" for i in range(len(ranks))]

    # --- dora_mag: shared decomposed adapter, per-tenant raw ΔB_M ---------
    # add_lora's decomposed init has B_mag = 0.  B_mag is set to the
    # magnitudes of its raw-LoRA B init instead (the pairs tenants' below),
    # so the two stores' adapters have one size; each tenant's ΔB_M moves
    # every magnitude by N(0, 1) times itself, up to the tenant's rank.
    raw = add_lora(params, cfg, g)
    shared = pt.tree_map_with_path(
        lambda p, x: (magnitude(pt.tree_get(raw, p[:-len("B_mag")]
                                            + "lora_B"))
                      if p.endswith("/B_mag") else x),
        add_lora(params, cfg, g, decomposed=True))
    del raw
    mag = AdapterStore(params, cfg, n_slots=8, kind="dora_mag", shared=shared,
                       device="cuda")
    deltas = {}
    for t, r in zip(tenants, ranks):
        deltas[t] = pt.tree_map_with_path(
            lambda p, x: pt.tree_get(shared, p[:-len("dB_mag")] + "B_mag")
            * torch.as_tensor(rng.normal(size=tuple(x.shape))
                              * (np.arange(x.shape[-1]) < r),
                              dtype=torch.float32, device="cuda"),
            pt.filter_tree(shared, lambda p: p.endswith("dB_mag")))
        mag.register(t, deltas[t], rank=r)
    reqs = requests(rng, tenants, cfg.vocab_size)

    eng = engine(params, cfg, mag)
    serve(torch, eng, reqs[:2], "dora_mag warm-up")
    torch.cuda.reset_peak_memory_stats()
    _, st, launches_mag = serve(torch, engine(params, cfg, mag), reqs,
                                "dora_mag", expect={"bgmv_mag": 2})
    report = {"dora_mag": engine_report("dora_mag", st, len(reqs),
                                        torch.cuda.max_memory_allocated())}

    batch, last = admitted_batch(torch, mag, reqs)
    report["dora_mag"]["prefill_logits"] = logits_checks(
        torch, "dora_mag", pt.merge_trees(params, mag.overlay()), cfg,
        prefill_logits(torch, batch, last))
    report["dora_mag"]["profile"] = profile_run(
        torch, engine(params, cfg, mag), reqs, "dora_mag",
        (("bgmv_mag", "bgmv_kernel"),))

    # --- pairs: raw-LoRA tenants at their own ranks (add_lora's init) ----
    pairs = AdapterStore(params, cfg, n_slots=8, kind="pairs", rank=R_MAIN,
                         device="cuda")
    for t, r in zip(tenants, ranks):
        pairs.register(t, add_lora(params, cfg, g, rank=r))
    torch.cuda.reset_peak_memory_stats()
    _, st, launches_pairs = serve(torch, engine(params, cfg, pairs), reqs,
                                  "pairs", expect={"bgmv": 2})
    report["pairs"] = engine_report("pairs", st, len(reqs),
                                    torch.cuda.max_memory_allocated())
    del pairs
    launches = {"bgmv_mag": launches_mag["bgmv_mag"],
                "bgmv": launches_pairs["bgmv"]}
    ctx = dict(cfg=cfg, params=params, mag=mag, shared=shared,
               delta=deltas["tenant2"], reqs=reqs, batch=batch, last=last)
    return report, launches, ctx


def phase_fused_path(torch, ctx):
    """Phase 4, path B1: fused-DoRA generation at full width, bf16.  The
    adapter is the shared decomposed one with the rank-8 tenant's ΔB_M as
    dB_mag and dA_dir = N(0, 1) x (1/6) x RMS(A_dir) (the 0.05 : 0.3 ratio
    of tests/test_kernels.py's sweep)."""
    from repro_torch.launch.serve import greedy_generate, merge_adapters
    from repro_torch.models import model as M
    from repro_torch.utils import pytree as pt

    cfg, params = ctx["cfg"], ctx["params"]
    fcfg = dataclasses.replace(cfg, use_fused_dora=True)
    g = torch.Generator(device="cuda").manual_seed(1)

    def leaf(p, x):
        if p.endswith("/dB_mag"):
            return pt.tree_get(ctx["delta"], p)
        if p.endswith("/dA_dir"):
            a = pt.tree_get(ctx["shared"], p[:-len("dA_dir")] + "A_dir")
            return (torch.randn(a.shape, generator=g, device="cuda")
                    * a.square().mean().sqrt() / 6)
        return x
    adapter = pt.tree_map_with_path(leaf, ctx["shared"])
    merged = merge_adapters(params, adapter)
    rng = np.random.default_rng(1)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                           size=(ROWS, PAD_W)), device="cuda")
    greedy_generate(merged, {"tokens": prompts[:, :16]}, fcfg, 2,
                    device="cuda")                              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    toks = greedy_generate(merged, {"tokens": prompts}, fcfg, N_NEW,
                           device="cuda")
    toks_h = toks.cpu().numpy()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    check(toks_h.shape == (ROWS, N_NEW) and toks_h.min() >= 0
          and toks_h.max() < cfg.vocab_size,
          f"fused: {ROWS} prompts of {PAD_W} tokens returned {N_NEW} tokens")
    check_launches(launches, {"fused_dora": 2}, cfg.n_layers, N_NEW,
                   "fused", f"1 prefill + {N_NEW - 1} decode steps")
    def prefill():
        M.prefill(merged, {"tokens": prompts}, fcfg, cache_len=PAD_W + N_NEW)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    # what of that the device is busy for, fused_dora's share of it
    by_name, _ = profiled(prefill)
    unfused = greedy_generate(merged, {"tokens": prompts}, cfg, N_NEW,
                              device="cuda")
    same = float((unfused.cpu().numpy() == toks_h).mean())
    report = {"rows": ROWS, "prompt_tokens": PAD_W, "tokens": toks_h.size,
              "wall_s": wall, "tokens_per_s": toks_h.size / wall,
              "prefill_ms": prefill_ms,
              "prefill_device_busy_ms": sum(by_name.values()),
              "prefill_fused_dora_device_ms": sum(
                  v for k, v in by_name.items() if "fused_dora" in k),
              "decode_step_ms": (1e3 * wall - prefill_ms) / (N_NEW - 1),
              "peak_bytes": peak,
              "tokens_equal_to_unfused_bf16": same}
    print("fused generation: " + json.dumps(report))

    batch = {"tokens": prompts}
    last = torch.full((ROWS,), PAD_W - 1, device="cuda")
    logits = prefill_logits(torch, batch, last)
    n = cfg.n_layers

    def fused_vs_unfused(f32):
        return {"fused_vs_unfused_f32": (rel_err(
            logits(f32, fcfg, n, None), logits(f32, cfg, n, None))[0],
            LOGITS_F32_TOL)}
    report["prefill_logits"] = logits_checks(torch, "fused", merged, fcfg,
                                             logits, fused_vs_unfused)
    return report, launches["fused_dora"]


# --- phase 7: training (run between phases 4 and 5) -----------------------

TRAIN_HP = dict(method="fedlora_opt", n_clients=4, rounds=2, local_steps=2,
                batch=4, seq_len=128, global_steps=2, personal_steps=2)
TRAIN_EVAL = 2          # eval batches: global, and per client on its task
GRAD_TOL = 1e-4         # card vs CPU, relative to each leaf's max |g|


def grad_check(torch, cfg, params, method="fedlora_opt", nonzero="/B_mag",
               scale=0.5, extra=None):
    """One stage-1 step's loss and gradients of every adapter leaf of
    ``method`` on the card against the CPU's: the first CHECK_DEPTH
    layers of the backbone (and of an encoder) cast to f32, one client,
    1 x 64 tokens of the dolly data (with ``extra``'s numpy arrays in the
    batch beside them: a frontend's embeddings), dropout 0, the
    zero-initialized leaves ending in ``nonzero`` drawn N(0, scale²) (so
    every leaf has a gradient), TF32 off."""
    from repro_torch.data import (SyntheticInstructionDataset, to_device,
                                  make_dataset_family, specialist_partition)
    from repro_torch.fed.simulate import FedHyper, FedSim
    from repro_torch.utils import pytree as pt

    cfg2 = dataclasses.replace(cfg, n_layers=CHECK_DEPTH, dtype="float32",
                               n_enc_layers=min(cfg.n_enc_layers,
                                                CHECK_DEPTH),
                               lora_dropout=0.0)
    base = dict(params, blocks=pt.tree_map(lambda t: t[:CHECK_DEPTH],
                                           params["blocks"]))
    if "encoder" in params:
        base["encoder"] = dict(params["encoder"], blocks=pt.tree_map(
            lambda t: t[:CHECK_DEPTH], params["encoder"]["blocks"]))
    base = to_f32(base)
    fam = make_dataset_family("dolly", vocab_size=cfg.vocab_size)
    ds = SyntheticInstructionDataset(fam, specialist_partition(1, 4)[0])
    batch = dict(ds.sample_batch(np.random.default_rng(1), 1, 64),
                 **(extra or {}))
    hp = FedHyper(method=method, n_clients=1)
    sims = {dev: FedSim(cfg2, hp, base=pt.tree_map(lambda t: t.to(dev), base),
                        device=dev) for dev in ("cuda", "cpu")}
    del base
    g = torch.Generator(device="cuda").manual_seed(2)
    ad = pt.tree_map_with_path(
        lambda p, x: (scale * torch.randn(x.shape, generator=g,
                                          device="cuda")
                      if nonzero and p.endswith(nonzero) else x),
        sims["cuda"].adapter_template)
    out = {dev: sim.loss_and_grad(pt.tree_map(lambda t: t.to(dev), ad),
                                  to_device(batch, dev))
           for dev, sim in sims.items()}
    (l_gpu, _, g_gpu), (l_cpu, _, g_cpu) = out["cuda"], out["cpu"]
    errs = {"loss": abs(float(l_gpu) - float(l_cpu)) / abs(float(l_cpu))}
    for p, want in pt.tree_leaves_with_path(g_cpu):
        got = pt.tree_get(g_gpu, p).cpu()
        check(float(want.abs().max()) > 0, f"grad check: {p} has a nonzero "
              f"gradient")
        errs[p] = float((got - want).abs().max() / want.abs().max())
    worst = max(errs, key=errs.get)
    check(errs[worst] <= GRAD_TOL, f"grad check {method}, {CHECK_DEPTH} "
          f"layers f32, 1 x 64 tokens: loss and {len(errs) - 1} adapter "
          f"gradients on the card within {GRAD_TOL} of the CPU's (worst "
          f"{worst}: {errs[worst]:.3e})")
    return {"loss": float(l_gpu), "worst": worst, "worst_err": errs[worst],
            "loss_err": errs["loss"], "leaves": len(errs) - 1}


# What each method's adapter holds, what each stage trains and what the
# rebroadcast keeps per client, written out here from the paper and the
# baselines' papers rather than read from the program, so that a wrong
# mask or regex in the port fails the stage checks: regexes over the
# adapter's leaf paths.  "leaves": every leaf of the adapter matches it;
# "stage1" / "stage2" / "stage3": the leaves local training, the
# server's global stage and the personalization step train (no
# "stage2": the method has no global stage); "keep": the leaves kept
# per client through every rebroadcast; "zero": the leaves the
# aggregate holds at exactly 0; "zero_in_stage1": the leaves still
# exactly 0 after every stage-1 round.
_LORA = {"leaves": r"/lora_[AB]$", "stage1": ".", "stage3": "."}
EXPECT = {
    "fedlora_opt": {"leaves": r"/(A_mag|A_dir|B_dir|B_mag|dA_dir|dB_mag)$",
                    "stage1": r"/(A_mag|A_dir|B_dir|B_mag)$",
                    "stage2": r"/dA_dir$", "stage3": r"/dB_mag$",
                    "keep": r"/dB_mag$", "zero_in_stage1": r"/dB_mag$"},
    "lora": _LORA, "fedprox": _LORA, "lora_trimmed": _LORA,
    "lora_fedbuff": _LORA, "lora_fedavg_q8": _LORA,
    "lora_fedavg_topk": _LORA,
    "ffa_lora": dict(_LORA, stage1=r"/lora_B$", stage3=r"/lora_B$"),
    "prompt": {"leaves": r"^prompt_embed$", "stage1": ".", "stage3": "."},
    "adapter": {"leaves": r"/mlp/adapter_(down|up)$", "stage1": ".",
                "stage3": "."},
    "fedalt": {"leaves": r"/(lora|local)_[AB]$", "stage1": ".",
               "stage3": ".", "keep": r"/local_[AB]$",
               "zero": r"/local_[AB]$"},
    "lora_zeropad": _LORA, "lora_replication": _LORA, "lora_exact": _LORA,
}
# The axis of each adapter leaf that indexes LoRA rank, by leaf name,
# written out here from the factors' shapes (A (d_in, r), B (r, d_out),
# the B magnitudes (r,)); A_mag (d_in,) has none.
RANK_AXIS = {"lora_A": -1, "A_dir": -1, "dA_dir": -1, "lora_B": -2,
             "B_dir": -2, "B_mag": -1, "dB_mag": -1}


def rank_rows(path, x, r):
    """One client's leaf ``x`` at ``path`` with its rows from ``r`` on,
    along its RANK_AXIS, set to 0 (``x`` itself when it has none)."""
    ax = RANK_AXIS.get(path.rsplit("/", 1)[-1])
    if ax is None:
        return x
    out = x.clone()
    out.narrow(ax, r, x.shape[ax] - r).zero_()
    return out


def select(tree, rx):
    """The leaf paths of ``tree`` that regex ``rx`` matches (none for
    None)."""
    from repro_torch.utils import pytree as pt
    return [p for p, _ in pt.tree_leaves_with_path(tree)
            if rx is not None and re.search(rx, p)]


def checked_sim(torch, log, hooks=None):
    """FedSim with the stage checks of phases 7 and 8 around each stage
    (bit for bit, on the client-stacked leaves), held to the method's
    ``EXPECT`` entry: at construction, the adapter's leaves, each
    stage's mask, the keep-local and the zeroed leaves the port's method
    declares; after each stage, the leaves it changed (those it trains
    and nothing else); after each rebroadcast, every shared leaf equal
    across clients and each client keeping its own keep-local leaves
    (also on a copy of the clients whose keep-local leaves are nonzero);
    and each stage's wall time, host clock around work that ends in a
    sync (stage 1 timed step by step, with the process's CPU time beside
    each step's wall time), and the kernel launches in each stage
    (``<stage>_launches``).  On a mixed-rank fleet each client's
    rebroadcast leaf is the aggregate (or its own keep-local leaf) cut
    to its rank (``rank_rows``).  ``hooks``: {"round": fn(sim, batches),
    "aggregate": fn(sim, clients, aggregated), "stage": fn(sim, what)},
    a method's own checks after stage 1, after the aggregation (the
    client adapters it was given, cloned) and after every stage."""
    from repro_torch.core import aggregation as agg
    from repro_torch.fed.simulate import FedSim
    from repro_torch.utils import pytree as pt
    hooks = hooks or {}

    def snap(tree):
        return pt.tree_map(lambda t: t.clone(), tree)

    def timed(name, fn):
        torch.cuda.synchronize()
        n0 = read_launches()
        t0, c0 = time.perf_counter(), time.process_time()
        out = fn()
        torch.cuda.synchronize()
        log.setdefault(name, []).append(time.perf_counter() - t0)
        log.setdefault(name + "_cpu", []).append(time.process_time() - c0)
        n1 = read_launches()
        for k in n1:
            n = log.setdefault(name + "_launches", {})
            n[k] = n.get(k, 0) + n1[k] - n0[k]
        return out

    class CheckedSim(FedSim):
        instances = []

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            CheckedSim.instances.append(self)
            self.expect = EXPECT[self.hp.method]
            self.check_declared()

        def want(self, key):
            return select(self.adapter_template, self.expect.get(key))

        def named(self, key):
            rx = self.expect.get(key)
            return {None: "no", ".": "every"}.get(rx, f"the {rx}")

        def check_declared(self):
            """The port's method against the written-out expectation."""
            name, ex, tmpl = self.hp.method, self.expect, self.adapter_template
            leaves = select(tmpl, ".")
            check(leaves and self.want("leaves") == leaves,
                  f"{name}: the adapter's {len(leaves)} leaves all match "
                  f"{ex['leaves']}")
            for stage, mask in (("stage1", self.train_mask),
                                ("stage2", self.global_mask),
                                ("stage3", self.local_mask)):
                if stage not in ex:
                    continue
                got = [p for p, m in pt.tree_leaves_with_path(mask) if m]
                check(got == self.want(stage), f"{name}: the {stage} mask "
                      f"trains exactly {self.named(stage)} leaves "
                      f"({len(got)})")
            check(select(tmpl, self.method.keep_local) == self.want("keep"),
                  f"{name}: keep-local holds {self.named('keep')} leaves")
            check(select(tmpl, agg.aggregate_zero_rx(self.method))
                  == self.want("zero"),
                  f"{name}: the aggregate zeroes {self.named('zero')} leaves")

        def check_changed(self, before, after, stage, what):
            changed = [p for p, x in pt.tree_leaves_with_path(after)
                       if not torch.equal(x, pt.tree_get(before, p))]
            want = self.want(stage)
            check(changed == want, f"{self.hp.method} {what}: the "
                  f"{len(want)} leaves it trains ({self.named(stage)} "
                  f"leaf) changed and nothing else ({len(changed)} changed)")

        def check_rebroadcast(self, tree, aggregated, personal_before, what):
            what = f"{self.hp.method} {what}"
            keep = set(self.want("keep"))
            ranks = self.hp.client_ranks
            for p, x in pt.tree_leaves_with_path(tree):
                for c in range(x.shape[0]):
                    src = (pt.tree_get(personal_before, p)[c] if p in keep
                           else pt.tree_get(aggregated, p))
                    if not torch.equal(x[c], src if ranks is None
                                       else rank_rows(p, src, ranks[c])):
                        raise CheckFailed(
                            f"{what}: client {c}'s {p} is not "
                            + ("its own" if p in keep else "the aggregate")
                            + ("" if ranks is None else
                               f" cut to its rank {ranks[c]}"))
            print(f"ok: {what}: every shared leaf "
                  + ("equal across clients" if ranks is None else
                     f"the aggregate cut to each client's rank {ranks}")
                  + (f", every {self.expect['keep']} leaf kept per client"
                     if keep else ""))

        def local_round(self, batches, rng=None):
            before = snap(self.client_adapters)
            step = super(CheckedSim, self).local_round
            for b in batches:           # one step a call, each timed
                mets = timed("stage1_step", lambda: step([b], rng))
            self.last_batches, self.last_rng = batches, rng
            log["rounds"] = log.get("rounds", 0) + 1
            what = f"stage 1 round {log['rounds']}"
            check(all(np.isfinite(v).all() for v in mets.values()),
                  f"{self.hp.method} {what}: metrics finite")
            self.check_changed(before, self.client_adapters, "stage1", what)
            # fedlora_opt: dA_dir is 0 until the first stage 2 and then
            # the server's; dB_mag is 0 until stage 3
            if "zero_in_stage1" in self.expect:
                nz = [p for p in self.want("zero_in_stage1") if torch
                      .count_nonzero(pt.tree_get(self.client_adapters, p))]
                check(not nz, f"{self.hp.method} {what}: every "
                      f"{self.expect['zero_in_stage1']} leaf still exactly 0")
            if "round" in hooks:
                hooks["round"](self, batches)
            if "stage" in hooks:
                hooks["stage"](self, what)
            return mets

        def probe_rebroadcast(self, aggregated, what):
            """The rebroadcast on a copy of the clients whose keep-local
            leaves are nonzero and differ by client (fedlora_opt's dB_mag
            is 0 until stage 3, where a rebroadcast that overwrote it
            would not show)."""
            keep = set(self.want("keep"))
            if not keep:
                return
            g = torch.Generator(device=self.device).manual_seed(3)
            probe = pt.tree_map_with_path(
                lambda p, x: (torch.randn(x.shape, generator=g,
                                          device=x.device, dtype=x.dtype)
                              if p in keep else x),
                self.client_adapters)
            real, self.client_adapters = self.client_adapters, probe
            try:
                out = self._rebroadcast(aggregated)
            finally:
                self.client_adapters = real
            self.check_rebroadcast(out, aggregated, probe,
                                   f"{what} (probe, nonzero keep-local)")

        def aggregate(self, **kw):
            clients = snap(self.client_adapters)
            out = timed("aggregate", lambda: super(CheckedSim, self)
                        .aggregate(**kw))
            if "zero" in self.expect:
                zero = self.want("zero")
                check(zero and all(not torch.count_nonzero(pt.tree_get(out, p))
                                   for p in zero),
                      f"{self.hp.method}: the aggregate's {len(zero)} "
                      f"{self.expect['zero']} leaves exactly 0")
            self.check_rebroadcast(self.client_adapters, out, clients,
                                   "aggregate")
            self.probe_rebroadcast(out, "aggregate")
            self.aggregated = out
            if "aggregate" in hooks:
                hooks["aggregate"](self, clients, out)
            if "stage" in hooks:
                hooks["stage"](self, "aggregate")
            return out

        def global_stage(self, aggregated, server_batches, rng=None):
            check("stage2" in self.expect, f"{self.hp.method}: a global "
                  f"stage runs only in the staged pipeline")
            before, personal = snap(aggregated), snap(self.client_adapters)
            out = timed("stage2", lambda: super(CheckedSim, self)
                        .global_stage(aggregated, server_batches, rng))
            self.check_changed(before, out, "stage2", "stage 2")
            self.check_rebroadcast(self.client_adapters, out, personal,
                                   "stage 2 rebroadcast")
            self.probe_rebroadcast(out, "stage 2 rebroadcast")
            self.server_model = out
            if "stage" in hooks:
                hooks["stage"](self, "stage 2")
            return out

        def personalize(self, batches, rng=None):
            before = snap(self.client_adapters)
            timed("stage3", lambda: super(CheckedSim, self)
                  .personalize(batches, rng))
            self.check_changed(before, self.client_adapters, "stage3",
                               "stage 3")
            if "stage" in hooks:
                hooks["stage"](self, "stage 3")

        def eval_global(self, aggregated, batches):
            return timed("eval", lambda: super(CheckedSim, self)
                         .eval_global(aggregated, batches))

        def eval_personalized(self, batches_stacked):
            return timed("eval", lambda: super(CheckedSim, self)
                         .eval_personalized(batches_stacked))

    return CheckedSim


def fed_data(cfg, C, B, S):
    """Phases 7 and 8's data: C specialist clients on the dolly tasks,
    the server's task mix, TRAIN_EVAL global eval batches and as many
    stacked per-client batches of each client's own task, on the card."""
    from repro_torch.data import (TASK_TYPES, SyntheticInstructionDataset,
                                  eval_batches, make_dataset_family,
                                  specialist_partition, to_device)
    fam = make_dataset_family("dolly", vocab_size=cfg.vocab_size)
    part = specialist_partition(C, 4)
    cds = [SyntheticInstructionDataset(fam, part[c], client_seed=c)
           for c in range(C)]
    sds = SyntheticInstructionDataset(fam, np.ones(4) / 4, client_seed=99)
    ev_g = eval_batches(sds, B, S, TRAIN_EVAL, seed=20_000, device="cuda")
    rng = np.random.default_rng(30_000)
    ev_l = []
    for _ in range(TRAIN_EVAL):
        outs = [d.sample_task_batch(rng, B, S, TASK_TYPES[c % 4])
                for c, d in enumerate(cds)]
        ev_l.append(to_device({k: np.stack([o[k] for o in outs])
                               for k in outs[0]}, "cuda"))
    return cds, sds, ev_g, ev_l


def run_checked(torch, cfg, params, hp, data, hooks=None, eval_kernels=()):
    """``run_federated`` on the card through a checking FedSim swapped
    into ``core.fedlora`` for the call, with every launch count at 0
    before it and the peak memory reset; the training path must launch
    no hand-written kernel: every launch in the call is one of the eval
    forwards' (no gradient), and of a kernel ``eval_kernels`` names (an
    SSM model's ssd_scan).  Returns (result, sim, stage log, wall s,
    peak bytes)."""
    from repro_torch.core import fedlora
    log = {}
    sim_cls = checked_sim(torch, log, hooks)
    real = fedlora.FedSim
    fedlora.FedSim = sim_cls
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        res = fedlora.run_federated(cfg, hp, *data, base=params,
                                    device="cuda")
    finally:
        fedlora.FedSim = real
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    evals = log.get("eval_launches", {})
    check(all(n == 0 or k in eval_kernels for k, n in evals.items()),
          f"training {hp.method}: the eval forwards launch only "
          f"{list(eval_kernels)} ({evals})")
    for k, n in read_launches().items():
        check(n == evals.get(k, 0), f"training {hp.method}: {k} launched "
              f"{n} times, all by the eval forwards ({evals.get(k, 0)}): "
              f"the training path launches no hand-written kernel")
    hist = res.history
    check(all(np.isfinite([h["train_ce"], h["ce"], h["acc"]]).all()
              for h in hist) and np.isfinite(res.local_acc)
          and np.isfinite(res.global_acc),
          f"training {hp.method}: every loss and metric finite")
    return res, sim_cls.instances[-1], log, wall, peak


def phase_training(torch, ctx):
    """Phase 7: the paper's pipeline (fedlora_opt stages 1-3) through
    ``run_federated`` at llama2-7b full width on phase 3's backbone, its
    stage checks, the card-vs-CPU gradient check, and the personalized
    clients served as dora_mag tenants through ``bgmv_mag``."""
    from repro_torch.fed.simulate import FedHyper, FedSim, client
    from repro_torch.serve import AdapterStore
    from repro_torch.utils import pytree as pt

    cfg, params = ctx["cfg"], ctx["params"]
    report = {"grad_check": grad_check(torch, cfg, params)}
    gc.collect()
    torch.cuda.empty_cache()

    hp = FedHyper(**TRAIN_HP)
    C, B, S = hp.n_clients, hp.batch, hp.seq_len
    ctx["fed_data"] = fed_data(cfg, C, B, S)
    res, sim, log, wall, peak = run_checked(torch, cfg, params, hp,
                                            ctx["fed_data"])
    hist = res.history
    tokens_step = C * B * S
    step_ms = [1e3 * s for s in log["stage1_step"]]
    warm_ms = float(np.median(step_ms[1:]))     # the first step warms up
    report.update({
        "config": dict(TRAIN_HP, layers=cfg.n_layers, d_model=cfg.d_model,
                       rank=cfg.lora_rank, lora_dropout=cfg.lora_dropout),
        "wall_s": wall, "peak_bytes": peak,
        "stage_wall_s": {k: v for k, v in log.items() if k != "rounds"},
        "stage1_step_ms": step_ms,
        "stage1_step_cpu_ms": [1e3 * s for s in log["stage1_step_cpu"]],
        "stage1_step_ms_warm_median": warm_ms,
        "train_tokens_per_s_warm": tokens_step / (warm_ms / 1e3),
        "train_ce_by_round": [h["train_ce"] for h in hist],
        "global_acc_by_round": [h["acc"] for h in hist],
        "global_acc": res.global_acc, "local_acc": res.local_acc,
        "per_client_acc": res.per_client, "comm_bytes": res.comm_bytes})
    print("training: " + json.dumps(report))

    # --- serve the personalized clients through bgmv_mag -----------------
    server = sim.server_model
    mag = AdapterStore(params, cfg, n_slots=8, kind="dora_mag", shared=server,
                       device="cuda")
    tenants = [f"client{c}" for c in range(C)]
    for c, t in enumerate(tenants):
        own = client(sim.client_adapters, c)
        for p, x in pt.tree_leaves_with_path(own):
            if not p.endswith("/dB_mag") and not torch.equal(
                    x, pt.tree_get(server, p)):
                raise CheckFailed(f"client {c}: {p} differs from the server "
                                  f"model")
        mag.register(t, pt.filter_tree(own, lambda p: p.endswith("/dB_mag")))
    print("ok: each client's model is the stage-2 server model plus its own "
          "dB_mag (registered as its tenant)")
    rng = np.random.default_rng(7)
    reqs = [(tenants[i % C], rng.integers(0, cfg.vocab_size,
                                          size=int(rng.integers(16, PAD_W + 1))
                                          ).astype(np.int32))
            for i in range(8)]
    torch.cuda.reset_peak_memory_stats()
    _, st, counts = serve(torch, engine(params, cfg, mag), reqs, "trained",
                          expect={"bgmv_mag": 2})
    report["serve"] = engine_report("trained", st, len(reqs),
                                    torch.cuda.max_memory_allocated())
    batch, last = admitted_batch(torch, mag, reqs)
    report["serve"]["prefill_logits"] = logits_checks(
        torch, "trained", pt.merge_trees(params, mag.overlay()), cfg,
        prefill_logits(torch, batch, last))

    # --- one stage-1 step under the profiler -------------------------------
    def one_step():                 # FedSim's own, without the checks
        FedSim.local_round(sim, sim.last_batches[:1], sim.last_rng)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    by_name, n_by_name = profiled(one_step, cpu=False)
    prof_ms = 1e3 * (time.perf_counter() - t0)
    busy = sum(by_name.values())
    gemm = sum(v for k, v in by_name.items()
               if any(w in k for w in ("nvjet", "gemm", "cutlass")))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    report["profile"] = {
        "step_ms_under_profiler": prof_ms, "device_busy_ms": busy,
        "gemm_device_ms": gemm, "launches": sum(n_by_name.values()),
        "busy_share_of_profiled_step": busy / prof_ms,
        "busy_share_of_warm_step": busy / warm_ms,
        "top_kernels_ms": {k[:80]: v for k, v in top}}
    print(f"profile training (one stage-1 step, {C} clients x {B} x {S} "
          f"tokens): " + json.dumps(report["profile"]))
    return report, counts["bgmv_mag"]


# --- phase 8: the baselines (run after phase 7) ---------------------------

BASELINES = ("ffa_lora", "fedprox", "prompt", "adapter", "fedalt",
             "lora_trimmed", "lora_fedbuff", "lora_fedavg_q8",
             "lora_fedavg_topk")
BASELINE_HP = dict(n_clients=4, rounds=1, local_steps=2, batch=4,
                   seq_len=128, personal_steps=1, prox_mu=0.1)
# each method's comm class (psum where not named) and the top-k
# uplink's density, from the baselines' definitions
COMM = {"lora_trimmed": "all_gather", "lora_fedavg_q8": "q8",
        "lora_fedavg_topk": "topk"}
TOPK_RATIO = 0.05
# one method of each new adapter kind, its zero-initialized factor and
# the scale it is drawn at: a few AdamW steps' size.  local_B at 0.5
# makes q ~ 10² and saturates the softmax, where f32 gradients are
# 1.1-1.3e-3 from those with f64 weights on the H100 and 0.9-1.6e-3 on
# the CPU, 4-7e-6 at 0.01 (scripts/grad_conditioning.py)
KIND_GRADS = (("fedalt", "/local_B", 0.01), ("adapter", "/adapter_up", 0.01),
              ("prompt", None, 0.0))
# the global models served as pairs tenants (FedALT's shared pair)
SERVED = ("ffa_lora", "fedprox", "lora_trimmed", "lora_fedbuff",
          "lora_fedavg_q8", "lora_fedavg_topk", "fedalt")
PROX_TOL = 1e-5         # relative, the prox term's loss identity
TRIM_TOL = 1e-6         # relative to max |value|, trimmed mean vs numpy
TOPK_TOL = 1e-6         # relative to max |value|, top-k mean vs the hook's
Q8_MIN = 0.1            # q8: some coordinate at least this many steps off


def comm_formula(template, keep_local, comm, C, ratio, rank=None):
    """One client's wire bytes a round by comm class, written out from
    ``aggregation.comm_bytes_per_round``'s docstring: psum 2·n·s,
    all_gather (C+1)·n·s, q8 n + 4 + n·s, topk ⌈ratio·n⌉·(s + 4) + n·s,
    over the leaves that are not kept local; with ``rank`` (a mixed-rank
    fleet's client), n counts only the client's own rank rows."""
    from repro_torch.utils import pytree as pt
    rx = re.compile(keep_local) if keep_local else None
    total = 0
    for p, x in pt.tree_leaves_with_path(template):
        if rx is not None and rx.search(p):
            continue
        ax = RANK_AXIS.get(p.rsplit("/", 1)[-1])
        n = x.numel() if rank is None or ax is None else (
            x.numel() // x.shape[ax] * min(rank, x.shape[ax]))
        sz = x.element_size()
        total += {"psum": 2 * n * sz, "all_gather": (C + 1) * n * sz,
                  "q8": n + 4 + n * sz,
                  "topk": max(1, math.ceil(ratio * n)) * (sz + 4) + n * sz
                  }[comm]
    return total


def baseline_hooks(torch, name, checks):
    """The checks of method ``name`` after its stage-1 round and after
    its aggregation (``checked_sim``'s hooks); readings go to
    ``checks``."""
    from repro_torch.core import aggregation as agg
    from repro_torch.core.sensitivity import sensitivity_report
    from repro_torch.fed.simulate import client
    from repro_torch.utils import pytree as pt

    def prox(sim, batches):
        """Client 0's trained adapters against its round reference (what
        the round started from), on the round's first batch, dropout 0;
        the term itself summed here in f64."""
        theta, ref = client(sim.client_adapters, 0), client(sim._round_ref, 0)
        b = client(batches[0], 0)
        with_term, _, _ = sim.loss_and_grad(theta, b, prox_ref=ref)
        plain, _, _ = sim.loss_and_grad(theta, b)
        sq = sum(float(((x.double() - pt.tree_get(ref, p).double()) ** 2)
                       .sum()) for p, x in pt.tree_leaves_with_path(theta))
        term = 0.5 * BASELINE_HP["prox_mu"] * sq
        err = abs(float(with_term) - float(plain) - term) / float(with_term)
        check(term > 0 and err <= PROX_TOL,
              f"fedprox: loss {float(with_term):.6f} = loss without the "
              f"term {float(plain):.6f} + ½µ‖θ − θ_ref‖² {term:.3e} within "
              f"{PROX_TOL} ({err:.2e})")
        checks["prox"] = {"loss": float(with_term), "plain": float(plain),
                          "term": term, "rel_err": err}

    def topk(sim, clients, out):
        """Each client's uplink (the port's ``compress_update``) is its
        ⌈ratio·n⌉ largest-|x| coordinates, picked here with torch.topk,
        and the aggregate is the mean of those."""
        worst, kept = 0.0, []
        for p, x in pt.tree_leaves_with_path(clients):
            n = x[0].numel()
            k = math.ceil(TOPK_RATIO * n)
            mine = torch.zeros_like(x).flatten(1)
            idx = torch.topk(x.flatten(1).abs(), k, dim=1).indices
            mine.scatter_(1, idx, x.flatten(1).gather(1, idx))
            mine = mine.view_as(x)
            for c in range(x.shape[0]):
                up = pt.tree_get(agg.compress_update(
                    client(clients, c), mode="topk",
                    topk_ratio=TOPK_RATIO), p)
                check(int(torch.count_nonzero(up)) == k
                      and torch.equal(up, mine[c]), f"lora_fedavg_topk: "
                      f"client {c} uplinks exactly the ⌈{TOPK_RATIO}·{n}⌉ = "
                      f"{k} largest coordinates of {p}")
            want = mine.mean(0)
            err = float((pt.tree_get(out, p) - want).abs().max()
                        / want.abs().max())
            check(err <= TOPK_TOL, f"lora_fedavg_topk: {p} aggregate the "
                  f"mean of the clients' top-k within {TOPK_TOL} ({err:.2e})")
            worst, kept = max(worst, err), kept + [k]
        checks["topk"] = {"ratio": TOPK_RATIO, "k_by_leaf": sorted(set(kept)),
                          "rel_err": worst}

    def q8(sim, clients, out):
        """Within one quantization step of the plain mean everywhere, and
        at least ``Q8_MIN`` steps off it somewhere in every leaf (a mean
        with no rounding is ~1e-7 of a step off)."""
        worst, least = 0.0, float("inf")
        for p, x in pt.tree_leaves_with_path(clients):
            step = float(torch.stack([x[c].abs().max() for c in range(
                x.shape[0])]).mean()) / 127.0
            err = float((pt.tree_get(out, p) - x.mean(0)).abs().max())
            check(Q8_MIN * step <= err <= step * (1 + 1e-5),
                  f"lora_fedavg_q8: {p} between {Q8_MIN} and 1 "
                  f"quantization step {step:.3e} of the plain mean "
                  f"({err:.3e})")
            worst, least = max(worst, err / step), min(least, err / step)
        checks["q8_err_over_step"] = {"max": worst, "least_leaf_max": least}

    def trimmed(sim, clients, out):
        worst = 0.0
        for p, x in pt.tree_leaves_with_path(clients):
            xs = np.sort(x.cpu().numpy(), axis=0)
            C = xs.shape[0]
            k = int(0.25 * C)
            want = xs[k:C - k].mean(axis=0) if 0 < k < C - k else xs.mean(0)
            err = float(np.abs(pt.tree_get(out, p).cpu().numpy() - want).max()
                        / np.abs(want).max())
            check(err <= TRIM_TOL, f"lora_trimmed: {p} the numpy trimmed "
                  f"mean within {TRIM_TOL} ({err:.2e})")
            worst = max(worst, err)
        checks["trimmed_rel_err"] = worst

    def sensitivity(sim, clients, out):
        rep = sensitivity_report(
            {f"client{c}": client(clients, c)
             for c in range(sim.hp.n_clients)}, out)
        checks["sensitivity"] = {k: rep[k] for k in (
            "mean", "obs1_dir_ratio_A_over_B", "obs2_mag_ratio_B_over_A")}
        print("sensitivity (Eqs. 2-3, clients against their aggregate; "
              "random weights, printed only): " + json.dumps(
                  checks["sensitivity"]))

    return {"fedprox": {"round": prox},
            "lora_fedavg_topk": {"aggregate": topk},
            "lora_fedavg_q8": {"aggregate": q8},
            "lora_trimmed": {"aggregate": trimmed},
            "lora_fedbuff": {"aggregate": sensitivity}}.get(name, {})


def phase_baselines(torch, ctx):
    """Phase 8: the nine uniform-rank baselines of the registry through
    ``run_federated`` at llama2-7b full width on phase 3's backbone, each
    with its own checks; the card-vs-CPU gradient check of each new
    adapter kind; the global models of the raw-LoRA-form methods served
    as pairs tenants through ``bgmv``."""
    from repro_torch.core import aggregation as agg
    from repro_torch.fed.simulate import FedHyper
    from repro_torch.serve import AdapterStore
    from repro_torch.utils import pytree as pt

    cfg, params = ctx["cfg"], ctx["params"]
    report = {"grad_check": {m: grad_check(torch, cfg, params, m, nz, sc)
                             for m, nz, sc in KIND_GRADS}}
    gc.collect()
    torch.cuda.empty_cache()
    served, runs = {}, {}
    for name in BASELINES:
        hp = FedHyper(method=name, **BASELINE_HP)
        C = hp.n_clients
        checks = {}
        res, sim, log, wall, peak = run_checked(
            torch, cfg, params, hp, ctx["fed_data"],
            baseline_hooks(torch, name, checks))
        comm = COMM.get(name, "psum")
        check(agg.comm_class(sim.method) == comm, f"{name}: billed as "
              f"{comm}")
        want = hp.rounds * C * comm_formula(
            sim.adapter_template, EXPECT[name].get("keep"), comm, C,
            TOPK_RATIO)
        check(res.comm_bytes == want, f"{name}: comm bytes {res.comm_bytes} "
              f"= {hp.rounds} x {C} x the {comm} formula ({want})")
        steps = [1e3 * t for t in log["stage1_step"]]
        runs[name] = {
            "comm": comm, "wall_s": wall,
            "peak_bytes": peak,
            "stage_wall_s": {k: v for k, v in log.items() if k != "rounds"},
            "stage1_step_ms": steps,
            "stage1_step_cpu_ms": [1e3 * t for t in log["stage1_step_cpu"]],
            "warm_step_ms": steps[-1],       # the first step warms up
            "train_ce": res.history[0]["train_ce"],
            "global_acc": res.global_acc, "local_acc": res.local_acc,
            "comm_bytes": res.comm_bytes, "checks": checks}
        print(f"baseline {name}: " + json.dumps(runs[name]))
        if name in SERVED:
            served[name] = pt.filter_tree(
                sim.aggregated, lambda p: not p.endswith(("/local_A",
                                                          "/local_B")))
        del res, sim
        gc.collect()
        torch.cuda.empty_cache()
    report["runs"] = runs

    # --- serve the global models through bgmv ----------------------------
    store = AdapterStore(params, cfg, n_slots=8, kind="pairs", rank=R_MAIN,
                         device="cuda")
    for name in SERVED:
        store.register(name, served[name])
    rng = np.random.default_rng(8)
    reqs = [(t, rng.integers(0, cfg.vocab_size,
                             size=int(rng.integers(16, PAD_W + 1))
                             ).astype(np.int32))
            for t in SERVED + (None,)]
    torch.cuda.reset_peak_memory_stats()
    _, st, counts = serve(torch, engine(params, cfg, store), reqs,
                          "baselines", expect={"bgmv": 2})
    report["serve"] = engine_report("baselines", st, len(reqs),
                                    torch.cuda.max_memory_allocated())
    batch, last = admitted_batch(torch, store, reqs)
    report["serve"]["prefill_logits"] = logits_checks(
        torch, "baselines", pt.merge_trees(params, store.overlay()), cfg,
        prefill_logits(torch, batch, last))
    del store
    return report, counts["bgmv"]


# --- phase 9: mixed-rank fleets (run after phase 8) ------------------------

FLEET_RANKS = (2, 4, 8, 16)
FLEET_HP = dict(BASELINE_HP, global_steps=1, client_ranks=FLEET_RANKS)
# (method, server_rank): the paper's pipeline and the three rank-aware
# aggregators at the fleet's largest rank, lora_exact also at a server
# rank at least the ranks' sum, 30, where its aggregate is exact
FLEET_RUNS = (("fedlora_opt", 0), ("lora_zeropad", 0),
              ("lora_replication", 0), ("lora_exact", 0), ("lora_exact", 32))
# one client's bytes a round summed over the fleet, from the arithmetic:
# 524,288 elements a unit of rank (q/v x 32 layers x (4096 + 4096)) x
# Σrᵢ = 30 x 4 bytes, x 2 copies (psum) or x (C + 1) = 5 (all_gather)
FLEET_COMM_BYTES = {"lora_zeropad": 125_829_120,
                    "lora_replication": 125_829_120,
                    "lora_exact": 314_572_800}
FLEET_MEAN_TOL = 1e-6   # zero-pad / replication vs f64 here, of max |x|
EXACT_TOL = 1e-5        # server rank >= Σrᵢ: residual over ‖ΣwAB‖_F
EY_TOL = 1e-4           # |residual - Eckart-Young tail| over ‖ΣwAB‖_F
EXACT_DEVICE_TOL = 1e-5  # card vs CPU exact_fedavg products, Frobenius


def fleet_hooks(torch, name, checks):
    """Phase 9's checks for method ``name`` (``checked_sim`` hooks): the
    zero rows after every stage, and the method's aggregate against its
    definition computed here; readings go to ``checks``."""
    from repro_torch.core import aggregation as agg
    from repro_torch.utils import pytree as pt

    def zero_rows(sim, what):
        """Every rank-axis leaf exactly 0 above each client's rank."""
        n = 0
        for p, x in pt.tree_leaves_with_path(sim.client_adapters):
            ax = RANK_AXIS.get(p.rsplit("/", 1)[-1])
            for c, r in enumerate(FLEET_RANKS if ax is not None else ()):
                rows = x[c].narrow(ax, r, x.shape[ax] - r)
                if torch.count_nonzero(rows):
                    raise CheckFailed(f"{name} {what}: client {c}'s {p} is "
                                      f"nonzero above its rank {r}")
                n += 1
        check(n > 0, f"{name} {what}: {n} (leaf, client) pairs exactly 0 "
              f"above the client's rank {FLEET_RANKS}")

    def mean_err(out, p, want):
        got = pt.tree_get(out, p).double()
        return float((got - want).abs().max() / want.abs().max())

    def zeropad(sim, clients, out):
        worst = max(mean_err(out, p, x.double().mean(0))
                    for p, x in pt.tree_leaves_with_path(clients))
        check(worst <= FLEET_MEAN_TOL, f"lora_zeropad: the aggregate is the "
              f"plain mean (f64 here) within {FLEET_MEAN_TOL} ({worst:.2e})")
        checks["zeropad_rel_err"] = worst

    def replication(sim, clients, out):
        worst, off_mean = 0.0, 0.0
        for p, x in pt.tree_leaves_with_path(clients):
            x = x.double()
            cover = torch.stack([rank_rows(p, torch.ones_like(x[0]), r)
                                 for r in FLEET_RANKS])
            den = cover.sum(0)
            want = torch.where(den > 0, (x * cover).sum(0) / den.clamp(min=1),
                               torch.zeros_like(den))
            worst = max(worst, mean_err(out, p, want))
            off_mean = max(off_mean, mean_err(out, p, x.mean(0)))
        check(worst <= FLEET_MEAN_TOL, f"lora_replication: the aggregate is "
              f"each row's mean over the clients that own it (f64 here) "
              f"within {FLEET_MEAN_TOL} ({worst:.2e}; {off_mean:.2e} off "
              f"the plain mean)")
        checks.update(replication_rel_err=worst,
                      replication_off_plain_mean=off_mean)

    def exact(sim, clients, out):
        """On the first CHECK_DEPTH layers, Σwᵢ·AᵢBᵢ formed here in f64
        against A'·B' of the aggregate: exact at a server rank >= Σrᵢ,
        else off it by the Eckart-Young tail of its singular values;
        and the CPU's exact_fedavg of the same client stacks.  The
        singular values: torch.linalg.svdvals in f64 on the card of the
        core R_a·R_bᵀ of f64 QRs of the stacked factors (Σwᵢ·AᵢBᵢ =
        Q_a·R_a·R_bᵀ·Q_bᵀ has rank ≤ Σrᵢ; an SVD of the 4096² product
        itself takes ≈ 12 s a pair of layers)."""
        r_out, D, C = sim.alloc_rank, CHECK_DEPTH, len(FLEET_RANKS)
        cpu = agg.exact_fedavg(pt.tree_map(lambda t: t.cpu(), clients),
                               ranks=FLEET_RANKS)
        rows = {}
        for pa in sorted(p for p, _ in pt.tree_leaves_with_path(out)
                         if p.endswith("/lora_A")):
            pb = pa[:-1] + "B"
            A = pt.tree_get(clients, pa)[:, :D].double() / C   # uniform w
            B = pt.tree_get(clients, pb)[:, :D].double()
            a_cat, b_cat = torch.cat(list(A), dim=-1), torch.cat(list(B), -2)
            want = a_cat @ b_cat
            got = (pt.tree_get(out, pa)[:D].double()
                   @ pt.tree_get(out, pb)[:D].double())
            host = (pt.tree_get(cpu, pa)[:D].double()
                    @ pt.tree_get(cpu, pb)[:D].double()).cuda()
            norm = torch.linalg.matrix_norm(want)
            resid = torch.linalg.matrix_norm(want - got)
            dev = float((torch.linalg.matrix_norm(got - host)
                         / torch.linalg.matrix_norm(host)).max())
            row = {"residual_over_norm": (resid / norm).tolist(),
                   "card_vs_cpu": dev}
            if r_out >= sum(FLEET_RANKS):
                err = float((resid / norm).max())
                check(err <= EXACT_TOL, f"lora_exact at server rank {r_out}: "
                      f"{pa[:-7]} over {D} layers, ‖ΣwAB − A'B'‖_F within "
                      f"{EXACT_TOL} of ‖ΣwAB‖_F ({err:.2e})")
            else:
                _, ra = torch.linalg.qr(a_cat)
                _, rb = torch.linalg.qr(b_cat.transpose(-1, -2))
                s = torch.linalg.svdvals(ra @ rb.transpose(-1, -2))
                tail = torch.sqrt(torch.sum(s[..., r_out:] ** 2, dim=-1))
                err = float(((resid - tail).abs() / norm).max())
                row.update(tail_over_norm=(tail / norm).tolist(),
                           gap=(s[..., r_out - 1] / s[..., r_out]).tolist())
                check(err <= EY_TOL and bool((tail > 0).all()),
                      f"lora_exact at rank {r_out}: {pa[:-7]} over {D} "
                      f"layers, ‖ΣwAB − A'B'‖_F the Eckart-Young tail "
                      f"√Σ_(j>{r_out}) σ_j² within {EY_TOL} of ‖ΣwAB‖_F "
                      f"({err:.2e}; tail {row['tail_over_norm']})")
            check(dev <= EXACT_DEVICE_TOL, f"lora_exact at rank {r_out}: "
                  f"{pa[:-7]}'s A'B' on the card within {EXACT_DEVICE_TOL} "
                  f"of the CPU's exact_fedavg of the same stacks ({dev:.2e})")
            rows[pa[:-7]] = row
        checks[f"exact_r{r_out}"] = rows

    hooks = {"stage": zero_rows}
    aggregate = {"lora_zeropad": zeropad, "lora_replication": replication,
                 "lora_exact": exact}.get(name)
    if aggregate is not None:
        hooks["aggregate"] = aggregate
    return hooks


def fleet_serve(torch, ctx, label, store, own, kernel):
    """Serve 8 requests (7 over the fleet's tenants and the null tenant)
    from ``store``, whose tenants ``client0..3`` were registered at
    their ranks; the prefill logits held as phase 3's and, beside that,
    against each client's own adapter ``own[c]`` through the plain path
    (bf16 through CHECK_DEPTH layers, f32 through all).  Returns the
    report and the kernel's launches."""
    from repro_torch.utils import pytree as pt
    cfg, params = ctx["cfg"], ctx["params"]
    C = len(FLEET_RANKS)
    tenants = [f"client{c}" for c in range(C)]
    for c, t in enumerate(tenants):
        check(store.rank_of(t) == FLEET_RANKS[c], f"{label}: the store "
              f"reads back {t}'s rank {FLEET_RANKS[c]}")
    rng = np.random.default_rng(9)
    reqs = [(t, rng.integers(0, cfg.vocab_size,
                             size=int(rng.integers(16, PAD_W + 1))
                             ).astype(np.int32))
            for t in [tenants[i % C] for i in range(7)] + [None]]
    torch.cuda.reset_peak_memory_stats()
    _, st, counts = serve(torch, engine(params, cfg, store), reqs, label,
                          expect={kernel: 2})
    report = engine_report(label, st, len(reqs),
                           torch.cuda.max_memory_allocated())
    batch, last = admitted_batch(torch, store, reqs)
    logits = prefill_logits(torch, batch, last)
    owners = [None if t is None else tenants.index(t) for t, _ in reqs[:ROWS]]

    def own_logits(base, depth):
        """Each row's logits from its own client's adapter (the bare
        backbone for the null tenant), plain path."""
        out = None
        for c in set(owners):
            tree = base if c is None else pt.merge_trees(base, own[c])
            y = logits(tree, cfg, depth, "torch")
            sel = torch.tensor([o == c for o in owners], device="cuda")
            out = y if out is None else torch.where(sel[:, None], y, out)
        return out

    def extra(f32):
        base = pt.filter_tree(f32, lambda p: not re.search(
            r"/(pool_|bgmv_)\w+$", p))
        own_f32 = own_logits(base, cfg.n_layers)
        # how far the adapters move the logits, printed beside the check
        report["adapter_effect_f32"] = rel_err(
            own_f32, logits(base, cfg, cfg.n_layers, "torch"))[0]
        return {"kernel_vs_own_adapter_f32": (rel_err(
            logits(f32, cfg, cfg.n_layers, None), own_f32)[0],
            LOGITS_F32_TOL)}
    tree = pt.merge_trees(params, store.overlay())
    report["prefill_logits"] = logits_checks(
        torch, label, tree, cfg, logits, extra, depths=(CHECK_DEPTH,))
    err = rel_err(logits(tree, cfg, CHECK_DEPTH, None),
                  own_logits(params, CHECK_DEPTH))[0]
    check(err <= TOL["bfloat16"], f"{label} prefill logits, {CHECK_DEPTH} "
          f"layers, bf16 weights, kernel vs each client's own adapter "
          f"(plain): {err:.3e} <= {TOL['bfloat16']}")
    report["prefill_logits"]["kernel_vs_own_adapter_bf16"] = err
    print(f"{label}: the clients' adapters move the f32 logits by "
          f"{report['adapter_effect_f32']:.3e} of max |logit|")
    return report, counts[kernel]


def phase_fleet(torch, ctx):
    """Phase 9: mixed-rank fleets (ranks 2/4/8/16) through
    ``run_federated`` at llama2-7b full width on phase 3's backbone for
    fedlora_opt and the three rank-aware methods, each with its own
    checks; fedlora_opt's clients served through ``bgmv_mag`` and
    lora_exact's through ``bgmv``, each at its own rank."""
    from repro_torch.core import aggregation as agg
    from repro_torch.fed.simulate import FedHyper, client
    from repro_torch.serve import AdapterStore
    from repro_torch.utils import pytree as pt

    cfg, params = ctx["cfg"], ctx["params"]
    C = len(FLEET_RANKS)
    runs, keep = {}, {}
    for name, server_rank in FLEET_RUNS:
        label = name + (f"@{server_rank}" if server_rank else "")
        hp = FedHyper(method=name, server_rank=server_rank, **FLEET_HP)
        checks = {}
        res, sim, log, wall, peak = run_checked(
            torch, cfg, params, hp, ctx["fed_data"],
            fleet_hooks(torch, name, checks))
        alloc = server_rank or max(FLEET_RANKS)
        check(sim.alloc_rank == alloc and all(
            x.shape[-1] == alloc for p, x in pt.tree_leaves_with_path(
                sim.adapter_template) if p.endswith(("/lora_A", "/A_dir"))),
              f"{label}: adapters allocated at rank {alloc}")
        comm = "all_gather" if name == "lora_exact" else "psum"
        check(agg.comm_class(sim.method) == comm, f"{label}: billed as {comm}")
        want = hp.rounds * sum(comm_formula(
            sim.adapter_template, EXPECT[name].get("keep"), comm, C, 0.0, r)
            for r in FLEET_RANKS)
        check(res.comm_bytes == want == FLEET_COMM_BYTES.get(name, want),
              f"{label}: comm bytes {res.comm_bytes} = the {comm} formula "
              f"with each client at its own rank ({want})")
        steps = [1e3 * t for t in log["stage1_step"]]
        runs[label] = {
            "comm": comm, "alloc_rank": alloc, "wall_s": wall,
            "peak_bytes": peak,
            "stage_wall_s": {k: v for k, v in log.items() if k != "rounds"},
            "stage1_step_ms": steps,
            "stage1_step_cpu_ms": [1e3 * t for t in log["stage1_step_cpu"]],
            "warm_step_ms": steps[-1],       # the first step warms up
            "train_ce": res.history[0]["train_ce"],
            "global_acc": res.global_acc, "local_acc": res.local_acc,
            "comm_bytes": res.comm_bytes, "checks": checks}
        print(f"fleet {label}: " + json.dumps(runs[label]))
        if label in ("fedlora_opt", "lora_exact"):
            keep[label] = (sim.server_model if name == "fedlora_opt"
                           else None,
                           [client(sim.client_adapters, c) for c in range(C)])
        del res, sim
        gc.collect()
        torch.cuda.empty_cache()
    report = {"runs": runs}

    # --- fedlora_opt's clients as dora_mag tenants at their own ranks -----
    server, own = keep.pop("fedlora_opt")
    for c, r in enumerate(FLEET_RANKS):
        for p, x in pt.tree_leaves_with_path(own[c]):
            if not p.endswith("/dB_mag") and not torch.equal(
                    x, rank_rows(p, pt.tree_get(server, p), r)):
                raise CheckFailed(f"fleet client {c}: {p} is not the server "
                                  f"model cut to its rank {r}")
    above = int(sum(torch.count_nonzero(x[..., min(FLEET_RANKS):])
                    for p, x in pt.tree_leaves_with_path(server)
                    if p.endswith("/dA_dir")))
    check(above > 0, f"fleet: the stage-2 server model's dA_dir is nonzero "
          f"above rank {min(FLEET_RANKS)} ({above} elements), so the pool's "
          f"per-slot rank decides what a tenant reads")
    mag = AdapterStore(params, cfg, n_slots=8, kind="dora_mag", shared=server,
                       device="cuda")
    check(mag.rank == max(FLEET_RANKS), f"fleet: dora_mag pool at the server "
          f"model's rank {max(FLEET_RANKS)}")
    for c, r in enumerate(FLEET_RANKS):
        mag.register(f"client{c}", pt.filter_tree(
            own[c], lambda p: p.endswith("/dB_mag")), rank=r)
    report["serve_dora_mag"], n_mag = fleet_serve(
        torch, ctx, "fleet dora_mag", mag, own, "bgmv_mag")
    ctx["fleet_server"] = server            # phase 10 serves over it
    del mag, server, own

    # --- lora_exact's clients as pairs tenants at their own ranks ---------
    _, own = keep.pop("lora_exact")
    pairs = AdapterStore(params, cfg, n_slots=8, kind="pairs",
                         rank=max(FLEET_RANKS), device="cuda")
    for c, r in enumerate(FLEET_RANKS):
        pairs.register(f"client{c}", own[c], rank=r)
    report["serve_pairs"], n_pairs = fleet_serve(
        torch, ctx, "fleet pairs", pairs, own, "bgmv")
    del pairs, own
    return report, {"bgmv_mag": n_mag, "bgmv": n_pairs}


# --- phase 10: persistence (run after phase 9) -----------------------------

# (a) FedSim resume: phase 9's fedlora_opt fleet, 2 rounds of 2 steps and
# the aggregate, saved after the first
RESUME_HP = dict(FLEET_HP, method="fedlora_opt", rounds=2)
# (b) the reference benchmark's churn constants
# (benchmarks/serve_multitenant.py:38-44): 10k tenants, a 32-slot pool, a
# 256-entry host cache, 16 rows, 32 requests of 16 + 16 tokens, Zipf 1.1
TIER_TENANTS, TIER_SLOTS, TIER_T1 = 10_000, 32, 256
TIER_ROWS, TIER_PROMPT, TIER_REQS, TIER_NEW = 16, 16, 32, 16
TIER_ZIPF_S = 1.1
TIER_DELTA = 0.1        # each tenant's ΔB_M: N(0, 1) x this, up to its rank
TIER_REPS = 2           # rounds of flat warm, tiered warm, tiered / flat Zipf
TIER_COUNTS = ("t0_hits", "t1_hits", "t2_reads", "prefetch_reads",
               "installs", "rows", "shard_writes")


def resume_round(torch, sim, cds, hp, rnd):
    """Round ``rnd`` as run_federated runs it (its steps, the round's
    generator, the aggregate), on batches drawn from a numpy generator
    seeded by the round, so two sims given one round see one batch."""
    from repro_torch.data import client_batch
    rng = np.random.default_rng(40_000 + rnd)
    batches = [client_batch(cds, rng, hp.batch, hp.seq_len, device="cuda")
               for _ in range(hp.local_steps)]
    gen = torch.Generator(device="cuda").manual_seed(hp.seed * 1000 + rnd)
    sim.local_round(batches, gen)
    sim.aggregate()
    torch.cuda.synchronize()


def host_copy(torch, tree):
    from repro_torch.utils import pytree as pt
    return pt.tree_map(lambda x: x.detach().cpu().clone()
                       if torch.is_tensor(x) else np.array(x), tree)


def same_leaves(torch, got, want, what):
    """Every leaf of ``got`` equal to ``want``'s bit for bit, dtype
    included (tensors on any device, numpy arrays); returns the count."""
    from repro_torch.utils import pytree as pt
    check(pt.tree_paths(got) == pt.tree_paths(want),
          f"{what}: the same {len(pt.tree_paths(want))} leaf paths")
    for p, x in pt.tree_leaves_with_path(got):
        x, w = (torch.as_tensor(v).detach().cpu()
                for v in (x, pt.tree_get(want, p)))
        if not (x.dtype == w.dtype and torch.equal(x, w)):
            raise CheckFailed(f"{what}: {p} differs")
    return len(pt.tree_paths(want))


def phase_resume(torch, ctx, workdir):
    """Phase 10 (a): a FedSim saved after round 1 and loaded into a fresh
    sim resumes round 2 bit for bit; another fleet refuses the file; the
    card's file restored on the CPU saves again to the same bytes."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.fed.simulate import FedHyper, FedSim
    from repro_torch.utils import pytree as pt
    cfg, params = ctx["cfg"], ctx["params"]
    cds = ctx["fed_data"][0]
    hp = FedHyper(**RESUME_HP)
    path = workdir / "sim.msgpack"
    a = FedSim(cfg, hp, base=params, device="cuda")
    resume_round(torch, a, cds, hp, 0)
    t0 = time.perf_counter()
    a.save(str(path), round_idx=1)
    save_s = time.perf_counter() - t0
    mb = path.stat().st_size / 1e6
    saved = host_copy(torch, a.state_tree())
    resume_round(torch, a, cds, hp, 1)

    b = FedSim(cfg, hp, base=params, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rnd = b.load(str(path))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(rnd == 1, f"resume: load returns round {rnd} = 1")
    n = same_leaves(torch, b.state_tree(), saved,
                    "resume: the loaded state against sim A's at its save")
    print(f"ok: resume: {n} state leaves loaded bit for bit")
    resume_round(torch, b, cds, hp, 1)
    same_leaves(torch, b.state_tree(), a.state_tree(),
                "resume: round 2 after the load against round 2 run on")
    print(f"ok: resume: round 2 from the file equals round 2 run on, {n} "
          f"leaves bit for bit (client adapters, moments, step, comm bytes, "
          f"ranks)")
    del a, saved
    other = FLEET_RANKS[::-1]
    perm = FedSim(cfg, FedHyper(**dict(RESUME_HP, client_ranks=other)),
                  base=params, device="cuda")
    try:
        perm.load(str(path))
    except ValueError as e:
        check("ranks" in str(e), f"resume: a fleet at ranks {other} refuses "
              f"the file ({e})")
    else:
        raise CheckFailed(f"resume: a fleet at ranks {other} loaded a file "
                          f"of ranks {FLEET_RANKS}")
    del perm
    tree, step = restore_checkpoint(str(path), b.state_tree(), device="cpu")
    check(all(x.device.type == "cpu" for x in pt.tree_leaves(tree)
              if torch.is_tensor(x)), "resume: the file restored on the CPU")
    save_checkpoint(str(workdir / "cpu.msgpack"), tree, step=step)
    check((workdir / "cpu.msgpack").read_bytes() == path.read_bytes(),
          f"resume: the card's file restored on the CPU and saved from the "
          f"CPU gives the same {mb:.1f} MB")
    del b, tree
    gc.collect()
    torch.cuda.empty_cache()
    out = {"file_mb": mb, "leaves": n, "save_s": save_s, "load_s": load_s,
           "save_mb_per_s": mb / save_s, "load_mb_per_s": mb / load_s}
    print("resume: " + json.dumps(out))
    return out


def tier_deltas(server):
    """Every tenant's ΔB_M for each dB_mag leaf of the server model:
    (tenants, leaves, *leaf shape) f32 on the host, N(0, 1) x TIER_DELTA
    from a seeded generator (no two tenants share a row), zero above the
    tenant's rank (the ranks cycle FLEET_RANKS)."""
    from repro_torch.utils import pytree as pt
    paths = [p for p in pt.tree_paths(server) if p.endswith("/dB_mag")]
    shape = tuple(pt.tree_get(server, paths[0]).shape)
    ranks = np.resize(np.asarray(FLEET_RANKS), TIER_TENANTS)
    d = np.random.default_rng(1).standard_normal(
        (TIER_TENANTS, len(paths), *shape), dtype=np.float32) * TIER_DELTA
    d *= np.arange(shape[-1]) < ranks[:, None, None, None]
    return paths, ranks, d


def tier_overlay(torch, paths, ranks, d, t):
    """Tenant ``t``'s ΔB_M overlay at its own rank, as host tensors."""
    from repro_torch.utils import pytree as pt
    tree: dict = {}
    for j, p in enumerate(paths):
        pt.set_leaf(tree, p, torch.from_numpy(d[t, j, ..., :ranks[t]]))
    return tree


def checked_tiered(torch, paths, ranks, d, counts):
    """TieredAdapterStore that holds every install to the script's own
    ΔB_M (each promoted slot's rows equal to the tenant's, exactly, with
    its rank in the slot table) and counts T0 hits, T1 hits, shard reads
    on the serving thread (T2) and on the prefetch thread."""
    import threading
    from repro_torch.serve import TieredAdapterStore
    prefixes = [p[:-len("/dB_mag")] for p in paths]
    lock = threading.Lock()

    class CheckedTiered(TieredAdapterStore):
        def _shard_tree(self, packed, rank):       # one a shard write
            counts["shard_writes"] += 1
            return super()._shard_tree(packed, rank)

        def _read_shard(self, tenant):
            out = super()._read_shard(tenant)
            key = ("t2_reads" if threading.current_thread()
                   is threading.main_thread() else "prefetch_reads")
            with lock:
                counts[key] += 1
            return out

        def install_batch(self, tenants, *, pinned=(), queued=()):
            want = list(dict.fromkeys(tenants))
            hits = sum(t in self._slot_of for t in want)
            reads = counts["t2_reads"]
            out = super().install_batch(tenants, pinned=pinned,
                                        queued=queued)
            counts["t0_hits"] += hits
            counts["t1_hits"] += (len(want) - hits
                                  - (counts["t2_reads"] - reads))
            return out

        def _install_rows(self, rows):
            super()._install_rows(rows)
            pools = [self._pools[p]["pool_dB_mag"].cpu().numpy()
                     for p in prefixes]
            for slot, tenant, _packed, r in rows:
                t = int(tenant[len("tenant"):])
                if not r == ranks[t] == self._slot_ranks[slot]:
                    raise CheckFailed(f"tiered: slot {slot} holds {tenant} "
                                      f"at rank {self._slot_ranks[slot]}, "
                                      f"not {ranks[t]}")
                for j, pool in enumerate(pools):
                    if not np.array_equal(pool[:, slot], d[t, j]):
                        raise CheckFailed(f"tiered: slot {slot}'s "
                                          f"{paths[j]} row is not {tenant}'s "
                                          f"ΔB_M")
            counts["installs"] += 1
            counts["rows"] += len(rows)

    return CheckedTiered


def tier_run(torch, ctx, store, reqs, label):
    """``reqs`` through a ServeEngine over ``store`` with every launch
    count at 0: bgmv_mag 2 x layers x (prefills + decode steps) launches,
    no other kernel.  Returns the tokens, the run's numbers, the launches."""
    from repro_torch.serve import ServeEngine
    cfg = ctx["cfg"]
    eng = ServeEngine(ctx["params"], cfg, store, max_rows=TIER_ROWS,
                      max_prompt_len=TIER_PROMPT,
                      max_len=TIER_PROMPT + TIER_NEW + 8, decode_chunk=8,
                      device="cuda")
    torch.cuda.synchronize()
    reset_launches()
    outs = eng.generate(reqs, n_new=TIER_NEW)
    launches = read_launches()
    st = eng.last_run
    passes = st["prefills"] + st["decode_steps"]
    check_launches(launches, {"bgmv_mag": 2}, cfg.n_layers, passes, label,
                   f"{st['prefills']} prefills + {st['decode_steps']} decode "
                   f"steps")
    check(all(o.shape == (TIER_NEW,) for o in outs),
          f"{label}: {len(reqs)} requests returned {TIER_NEW} tokens each")
    return outs, {"tokens_per_s": st["tokens"] / st["wall_seconds"],
                  "wall_s": st["wall_seconds"], "prefills": st["prefills"],
                  "decode_steps": st["decode_steps"], "tokens": st["tokens"],
                  "chunks": len(st["chunk_seconds"]),
                  "decode_step_ms": [1e3 * t / CHUNK
                                     for t in st["chunk_seconds"]]}, \
        launches["bgmv_mag"]


def same_tokens(a, b, what):
    check(len(a) == len(b) and all(np.array_equal(x, y)
                                   for x, y in zip(a, b)),
          f"tiered: {what} ({len(a)} requests)")


def phase_tiered(torch, ctx, workdir):
    """Phase 10 (b): 10,000 dora_mag tenants registered into a tiered
    store over phase 9's fedlora_opt stage-2 server model, paged from
    disk through a 256-entry host cache into a 32-slot pool and served
    through ``bgmv_mag``, against flat stores, with and without prefetch
    and across a save / load."""
    from repro_torch.checkpoint import list_shards
    from repro_torch.serve import AdapterStore
    cfg, params, server = ctx["cfg"], ctx["params"], ctx["fleet_server"]
    paths, ranks, d = tier_deltas(server)
    shard_dir = workdir / "shards"

    def overlay(t):
        return tier_overlay(torch, paths, ranks, d, t)

    def tiered():
        counts = dict.fromkeys(TIER_COUNTS, 0)
        store = checked_tiered(torch, paths, ranks, d, counts)(
            params, cfg, shard_dir=str(shard_dir), host_capacity=TIER_T1,
            n_slots=TIER_SLOTS, kind="dora_mag", shared=server,
            device="cuda")
        check(store.rank == max(FLEET_RANKS) and all(
            x.device.type == "cuda" for pool in store._pools.values()
            for x in pool.values()), "tiered: T0 on the card at rank "
              f"{max(FLEET_RANKS)}")
        return store, counts

    def flat(ids):
        store = AdapterStore(params, cfg, n_slots=TIER_SLOTS,
                             kind="dora_mag", shared=server, device="cuda")
        for t in ids:
            store.register(f"tenant{t}", overlay(t), rank=int(ranks[t]))
        return store

    ts, counts = tiered()
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    t0 = time.perf_counter()
    for t in range(TIER_TENANTS):
        ts.register(f"tenant{t}", overlay(t), rank=int(ranks[t]))
    reg_s = time.perf_counter() - t0
    new_allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - allocs
    check(new_allocs == 0, f"tiered: {TIER_TENANTS} registrations made "
          f"{new_allocs} device allocations (0)")
    n_spilled = len(list_shards(str(shard_dir)))
    check(n_spilled == TIER_TENANTS - TIER_T1, f"tiered: registration left "
          f"{n_spilled} shards ({TIER_TENANTS} - {TIER_T1} spilled)")
    t0 = time.perf_counter()
    ts.flush()                          # the T1 entries: TIER_T1 shard writes
    flush_s = time.perf_counter() - t0
    n_flushed = len(list_shards(str(shard_dir)))
    check(n_flushed == TIER_TENANTS, f"tiered: {n_flushed} shards after "
          f"flush ({TIER_TENANTS})")

    rng = np.random.default_rng(0)
    prompts = rng.integers(5, cfg.vocab_size,
                           size=(TIER_REQS, TIER_PROMPT)).astype(np.int32)
    p = 1.0 / np.arange(1, TIER_TENANTS + 1) ** TIER_ZIPF_S
    zipf_ids = rng.choice(TIER_TENANTS, size=TIER_REQS, p=p / p.sum())
    warm = [(f"tenant{i % TIER_SLOTS}", prompts[i])
            for i in range(TIER_REQS)]
    zipf = [(f"tenant{t}", prompts[i]) for i, t in enumerate(zipf_ids)]
    distinct = sorted(set(int(t) for t in zipf_ids))
    check(len(distinct) <= TIER_SLOTS, f"tiered: the Zipf schedule's "
          f"{len(distinct)} tenants fit a flat {TIER_SLOTS}-slot store")

    runs, launches = {}, {"tiered": 0, "flat": 0}

    def run(store, reqs, label, kind):
        outs, runs[label], n = tier_run(torch, ctx, store, reqs, label)
        launches[kind] += n
        return outs

    flat_warm, flat_zipf = flat(range(TIER_SLOTS)), flat(distinct)
    run(flat_warm, warm[:2], "flat warm-up", "flat")
    rounds = []
    for rep in range(TIER_REPS):        # side by side: host clocks drift
        out_flat = run(flat_warm, warm, f"flat warm {rep}", "flat")
        same_tokens(run(ts, warm, f"tiered warm {rep}", "tiered"), out_flat,
                    "the warm schedule's tokens equal the flat store's")
        out_zipf = run(ts, zipf, f"tiered Zipf {rep}", "tiered")
        same_tokens(run(flat_zipf, zipf, f"flat Zipf {rep}", "flat"),
                    out_zipf, "the Zipf schedule's tokens equal a flat "
                    f"store's holding its {len(distinct)} tenants")
        rounds.append((out_flat, out_zipf))
    out_flat, out_zipf = rounds[0]
    for later in rounds[1:]:
        same_tokens(later[0], out_flat, "a later round's warm tokens equal "
                    "the first round's")
        same_tokens(later[1], out_zipf, "a later round's Zipf tokens equal "
                    "the first round's")
    check(ts.wait_prefetch(timeout=30.0), "tiered: the prefetcher is idle")

    ckpt = str(workdir / "tier.msgpack")
    t0 = time.perf_counter()
    ts.save(ckpt)
    save_s = time.perf_counter() - t0
    loaded, counts_loaded = tiered()
    t0 = time.perf_counter()
    loaded.load(ckpt)
    load_s = time.perf_counter() - t0
    check(len(loaded.tenants) == TIER_TENANTS
          and loaded.resident_tenants == ts.resident_tenants,
          f"tiered: the loaded store knows {TIER_TENANTS} tenants and the "
          f"{len(ts.resident_tenants)} residents")
    same_tokens(run(loaded, zipf, "tiered Zipf after save / load", "tiered"),
                out_zipf, "the Zipf tokens after a save and a load into a "
                "fresh store on the same shards are unchanged")

    quiet, counts_quiet = tiered()
    quiet.prefetch = lambda tenants: None
    same_tokens(run(quiet, warm, "tiered warm, no prefetch", "tiered"),
                out_flat, "the warm tokens with prefetch a no-op")
    same_tokens(run(quiet, zipf, "tiered Zipf, no prefetch", "tiered"),
                out_zipf, "the Zipf tokens with prefetch a no-op equal "
                "those with prefetch on")
    check(counts_quiet["prefetch_reads"] == 0,
          "tiered: no shard read off the serving thread without prefetch")
    for store in (ts, loaded, quiet):
        check(store.wait_prefetch(timeout=30.0),
              "tiered: every prefetcher idle at the end")
    ckpt_mb = (workdir / "tier.msgpack").stat().st_size / 1e6
    out = {"tenants": TIER_TENANTS, "register_s": reg_s,
           "flush_s": flush_s, "flush_ms_per_shard": 1e3 * flush_s / TIER_T1,
           "shards_after_register": n_spilled, "shards_after_flush": n_flushed,
           "bytes_per_tenant": ts.bytes_per_tenant(),
           "zipf_distinct_tenants": len(distinct),
           "counts": counts, "counts_after_load": counts_loaded,
           "counts_no_prefetch": counts_quiet,
           "save_s": save_s, "load_s": load_s, "ckpt_mb": ckpt_mb,
           "runs": runs, "bgmv_mag_launches": launches}
    print("tiered: " + json.dumps(out))
    tier = {"store": ts, "counts": counts, "warm": warm, "zipf": zipf,
            "out_warm": out_flat, "out_zipf": out_zipf}
    return out, launches, tier


def phase_persistence(torch, ctx, workdir):
    """Phase 10: (a) FedSim resume and (b) tiered serving, in
    ``workdir``; returns the report, the launches and the tiered store
    with its schedules, which phase 11 serves again."""
    report = {"resume": phase_resume(torch, ctx, workdir)}
    report["tiered"], launches, tier = phase_tiered(torch, ctx, workdir)
    return report, launches, tier


# --- phase 11: telemetry and cohort rounds (run after phase 10) ------------

TELEMETRY_REPS = 4      # rounds of one warm batch off, on / on, off, ...
# (b) a bank of 16 clients over a FedSim of 4 slots, 3 rounds of 1 step of
# 4 x 128 tokens, each slot fed by its dolly client's data
COHORT_N = 16
COHORT_HP = dict(BASELINE_HP, local_steps=1, rounds=3)
COHORT_PLAN = dict(dropout_rate=0.25, straggler_rate=0.25,
                   straggler_delay=(1, 2), corrupt_rate=0.25,
                   corrupt_scale=10.0, seed=1)
COHORT_SEED = 0         # the sampler's
COHORT_METHODS = ("fedlora_opt", "lora_fedbuff")
COHORT_RESUMED = "fedlora_opt"     # saved after round 1, resumed
COHORT_SERVED = "lora_fedbuff"     # its bank served as pairs tenants
# the card may hold, beside one 4-client FedSim round's peak, the
# round-start copy of the 4 clients' state and this much more
COHORT_PEAK_SLACK = 256 << 20


def series(snap, kind, name, **labels):
    """Σ of a snapshot's series of ``name`` whose labels include
    ``labels``."""
    return sum(s.get("value", s.get("count", 0))
               for s in snap[kind].get(name, [])
               if labels.items() <= s["labels"].items())


def tree_nbytes(torch, tree):
    from repro_torch.utils import pytree as pt
    return sum(x.numel() * x.element_size() if torch.is_tensor(x)
               else np.asarray(x).nbytes for x in pt.tree_leaves(tree))


def bgmv_ranges(torch, fn):
    """Run ``fn`` under torch.profiler (host and card); returns, for each
    host range named "kernels/bgmv_mag", the names of the device kernels
    whose launch (the runtime call, matched to its kernel by CUPTI's
    correlation id) lies inside it; the count of ``bgmv_kernel`` launches
    on the card; and how many of them were launched outside every
    range."""
    import bisect
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    evs = prof.events()
    ranges = sorted((e.time_range.start, e.time_range.end) for e in evs
                    if e.name == "kernels/bgmv_mag"
                    and e.device_type == DeviceType.CPU)
    starts = [a for a, _ in ranges]
    launch = {e.id: e for e in evs if e.device_type == DeviceType.CPU
              and "Launch" in e.name}
    held = [[] for _ in ranges]
    on_card = outside = 0
    for e in evs:
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        is_bgmv = "bgmv_kernel" in e.name
        on_card += is_bgmv
        rt = launch.get(e.id)
        i = (-1 if rt is None
             else bisect.bisect_right(starts, rt.time_range.start) - 1)
        if i >= 0 and rt.time_range.end <= ranges[i][1]:
            held[i].append(e.name)
        elif is_bgmv:
            outside += 1
    print(f"trace: {len(ranges)} ranges, {len(launch)} runtime launch "
          f"events ({sorted({e.name for e in launch.values()})}), "
          f"{on_card} bgmv_kernel launches on the card")
    return held, on_card, outside


def phase_telemetry(torch, ctx, workdir, tier):
    """Phase 11 (a): telemetry on over phase 10's 10,000-tenant tiered
    store (its warm and Zipf schedules again, the counters against the
    checking store's counts, the spans against ``last_run``), one FedSim
    save /
    load, one traced decode chunk whose every "kernels/bgmv_mag" range
    holds one ``bgmv_kernel`` launch, and the decode step's ms with
    telemetry off and on."""
    from repro_torch import obs
    from repro_torch.checkpoint import checkpoint_leaf_paths
    from repro_torch.fed.simulate import FedHyper, FedSim
    from repro_torch.serve import ServeEngine
    cfg, params = ctx["cfg"], ctx["params"]
    ts, counts = tier["store"], tier["counts"]
    events_path = workdir / "telemetry.jsonl"
    launches = 0
    obs.enable(str(events_path))
    try:
        # --- phase 10's warm then Zipf runs, counted by the checking
        # store and by obs --------------------------------------------------
        before = dict(counts)
        run = {"prefills": 0, "chunks": 0, "tokens": []}
        for label in ("warm", "zipf"):
            outs, r, n = tier_run(torch, ctx, ts, tier[label],
                                  f"telemetry: tiered {label}")
            launches += n
            same_tokens(outs, tier[f"out_{label}"], f"the {label} tokens "
                        f"with telemetry on equal those with it off")
            run["prefills"] += r["prefills"]
            run["chunks"] += r["chunks"]
            run["tokens"].append(r["tokens"])
            run[label] = r
        check(ts.wait_prefetch(timeout=30.0), "telemetry: prefetcher idle")
        ts.drain_prefetch()             # the last reads' restore records
        d = {k: counts[k] - before[k] for k in counts}
        snap = obs.active().metrics.snapshot()
        want = {("counters", "pool/tier_hits", (("tier", "t0"),)):
                d["t0_hits"],
                ("counters", "pool/tier_hits", (("tier", "t1"),)):
                d["t1_hits"],
                ("counters", "pool/tier_misses", (("tier", "t1"),)):
                d["t2_reads"],
                ("counters", "pool/promotions", (("src", "t1"),)):
                d["t1_hits"],
                ("counters", "pool/promotions", (("src", "t2"),)):
                d["t2_reads"],
                ("counters", "pool/t1_spills", ()): d["shard_writes"],
                ("histograms", "span_seconds",
                 (("span", "serve/prefill"),)): run["prefills"],
                ("histograms", "span_seconds",
                 (("span", "serve/decode_chunk"),)): run["chunks"]}
        got = {}
        for (kind, name, labels), n_want in want.items():
            n_got = series(snap, kind, name, **dict(labels))
            got[f"{name}{dict(labels)}"] = n_got
            check(n_got == n_want, f"telemetry: {name} {dict(labels)} = "
                  f"{n_got}, the checking store / last_run's {n_want}")
        obs.active().events.flush()
        evs = obs.read_events(str(events_path))
        runs = [e["tokens"] for e in evs if e["kind"] == "serve_run"]
        check(runs == run["tokens"], f"telemetry: the serve_run events' "
              f"tokens {runs} = each run's last_run tokens {run['tokens']}")
        shard_reads = sum(e["kind"] == "ckpt_restore" for e in evs)
        check(shard_reads == d["t2_reads"] + d["prefetch_reads"],
              f"telemetry: {shard_reads} ckpt_restore events of shards = "
              f"{d['t2_reads']} serving-thread + {d['prefetch_reads']} "
              f"prefetch reads, all emitted on the serving thread")

        # --- one FedSim save / load ----------------------------------------
        sim = FedSim(cfg, FedHyper(**RESUME_HP), base=params, device="cuda")
        path = workdir / "telemetry_sim.msgpack"
        sim.save(str(path), round_idx=3)
        check(sim.load(str(path)) == 3, "telemetry: the FedSim reloads")
        obs.active().events.flush()
        mine = [e for e in obs.read_events(str(events_path))
                if e.get("path") == str(path)]
        n_leaves = len(checkpoint_leaf_paths(str(path)))
        n_bytes = tree_nbytes(torch, sim.state_tree())
        check([e["kind"] for e in mine] == ["ckpt_save", "ckpt_restore"]
              and all(e["step"] == 3 and e["leaves"] == n_leaves
                      for e in mine) and mine[0]["bytes"] == n_bytes,
              f"telemetry: one ckpt_save and one ckpt_restore of the FedSim "
              f"file, step 3, {n_leaves} leaves, {n_bytes} bytes "
              f"({[{k: e[k] for k in ('kind', 'step', 'leaves')} for e in mine]})")
        del sim
        gc.collect()
        torch.cuda.empty_cache()

        # --- one decode chunk traced ---------------------------------------
        eng = ServeEngine(params, cfg, ts, max_rows=TIER_ROWS,
                          max_prompt_len=TIER_PROMPT,
                          max_len=TIER_PROMPT + TIER_NEW + 8, decode_chunk=CHUNK,
                          device="cuda")
        reqs = tier["warm"][:TIER_ROWS]
        eng.generate(reqs[:2], n_new=2)                 # warm, untraced
        torch.cuda.synchronize()
        reset_launches()
        for t, p in reqs:
            eng.submit(t, p, CHUNK + 1)
        ranges, on_card, outside = bgmv_ranges(torch, eng.run)
        n_mag = read_launches()["bgmv_mag"]
        launches += n_mag
        st = eng.last_run
        steps = st["prefills"] + st["decode_steps"]
        check(st["prefills"] == 1 and len(st["chunk_seconds"]) == 1
              and n_mag == 2 * cfg.n_layers * steps,
              f"telemetry trace: 1 prefill + 1 chunk, bgmv_mag launched "
              f"{n_mag} = 2 x {cfg.n_layers} x {steps}")
        check(len(ranges) == n_mag, f"telemetry trace: {len(ranges)} "
              f"kernels/bgmv_mag ranges = the {n_mag} counted launches")
        bad = [k for k in ranges if len(k) != 1 or "bgmv_kernel" not in k[0]]
        check(not bad and on_card == n_mag and outside == 0,
              f"telemetry trace: each range holds exactly one device "
              f"kernel, a bgmv_kernel ({len(bad)} do not, e.g. {bad[:1]}); "
              f"{on_card} bgmv_kernel launches on the card, {outside} "
              f"outside every range")
    finally:
        obs.disable()

    # --- the decode step with telemetry off and on, one warm engine --------
    eng = ServeEngine(params, cfg, ts, max_rows=TIER_ROWS,
                      max_prompt_len=TIER_PROMPT,
                      max_len=TIER_PROMPT + TIER_NEW + 8, decode_chunk=CHUNK,
                      device="cuda")
    step_ms = {"off": [], "on": []}
    reqs = tier["warm"][:TIER_ROWS]          # one batch: 1 prefill, 2 chunks
    want = eng.generate(reqs, n_new=TIER_NEW)            # warm, off
    for rep in range(TELEMETRY_REPS):
        for mode in (("off", "on") if rep % 2 == 0 else ("on", "off")):
            if mode == "on":
                obs.enable(str(workdir / "telemetry_cost.jsonl"))
            try:
                torch.cuda.synchronize()
                reset_launches()
                outs = eng.generate(reqs, n_new=TIER_NEW)
                launches += read_launches()["bgmv_mag"]
            finally:
                obs.disable()
            same_tokens(outs, want, f"one warm batch's tokens, telemetry "
                        f"{mode}")
            step_ms[mode] += [1e3 * t / CHUNK
                              for t in eng.last_run["chunk_seconds"]]
    gpu = gpu_line()
    out = {"counts": d, "obs": got, "runs": run,
           "fedsim_ckpt": {"leaves": n_leaves, "bytes": n_bytes},
           "trace": {"ranges": len(ranges), "bgmv_kernel_on_card": on_card,
                     "bgmv_kernel_outside_ranges": outside},
           "decode_step_ms_off": statistics.median(step_ms["off"]),
           "decode_step_ms_on": statistics.median(step_ms["on"]),
           "decode_step_ms_all": step_ms, "gpu": gpu,
           "bgmv_mag_launches": launches}
    print(f"telemetry: decode step {out['decode_step_ms_off']:.2f} ms off, "
          f"{out['decode_step_ms_on']:.2f} ms on (median of "
          f"{len(step_ms['off'])} chunks each, {gpu})")
    print("telemetry: " + json.dumps(out))
    return out, launches


def replay_cohort(r):
    """Round ``r``'s cohort and faults from numpy, as the sampler and the
    fault plan draw them (written out here, not taken from the port)."""
    rng = np.random.default_rng((COHORT_SEED, r))
    idx = np.sort(rng.choice(COHORT_N, size=COHORT_HP["n_clients"],
                             replace=False))
    p, C = COHORT_PLAN, COHORT_HP["n_clients"]
    rng = np.random.default_rng((p["seed"], r, 727))
    u = rng.random(C)
    drop = u < p["dropout_rate"]
    strag = ~drop & (u < p["dropout_rate"] + p["straggler_rate"])
    corrupt = ~drop & ~strag & (rng.random(C) < p["corrupt_rate"])
    lo, hi = p["straggler_delay"]
    delays = rng.integers(lo, hi + 1, size=C)
    return idx, drop, strag, corrupt, delays


def cohort_batches(torch, ctx, r):
    """Round ``r``'s stacked (4, 4, 128) batch, slot c from dolly client
    c, from a numpy generator seeded by the round, and its generator."""
    from repro_torch.data import client_batch
    hp = COHORT_HP
    rng = np.random.default_rng(50_000 + r)
    b = [client_batch(ctx["fed_data"][0], rng, hp["batch"], hp["seq_len"],
                      device="cuda") for _ in range(hp["local_steps"])]
    return b, torch.Generator(device="cuda").manual_seed(60_000 + r)


def bank_entry(torch, bank, c):
    from repro_torch.utils import pytree as pt
    return {t: pt.tree_map(lambda x: x[c].clone(), getattr(bank, t))
            for t in ("adapters", "opt_state")}


def cohort_round(torch, ctx, cs, r, label, checks):
    """One cohort round with its checks against the replayed draws:
    cohort, fates, delays, billing, and every client that did not sync
    (and had no delivery due) unchanged in the bank, bit for bit."""
    idx, drop, strag, corrupt, delays = replay_cohort(r)
    due = {d["client"] for d in cs._pending if d["deliver_at"] <= r}
    idle = [int(idx[s]) for s in np.nonzero(drop | strag)[0]
            if int(idx[s]) not in due]
    before = {c: bank_entry(torch, cs.bank, c) for c in idle}
    pending = len(cs._pending)
    bill = cs.sim.comm_bytes
    batches, gen = cohort_batches(torch, ctx, r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = cs.run_round(batches, gen)
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    check(np.array_equal(out["cohort"], idx)
          and np.array_equal(out["participation"], ~(drop | strag)),
          f"{label} round {r}: cohort {out['cohort'].tolist()} and "
          f"participation equal the replayed draws")
    new = cs._pending[pending - out["delivered_billed"]:]
    check([(d["client"], d["deliver_at"]) for d in new]
          == [(int(idx[s]), r + int(delays[s])) for s in np.nonzero(strag)[0]],
          f"{label} round {r}: the stragglers and their delays are the "
          f"replayed ones")
    unit = cs.sim.client_comm_bytes()
    want = bill + unit * (int((~(drop | strag)).sum())
                          + out["delivered_billed"])
    check(cs.sim.comm_bytes == want, f"{label} round {r}: comm bytes "
          f"{cs.sim.comm_bytes} = {bill} + {unit} x (live + deliveries)")
    for c, entry in before.items():
        now = bank_entry(torch, cs.bank, c)
        same_leaves(torch, now, entry, f"{label} round {r}: client {c}, "
                    f"who did not sync, in the bank")
    checks.setdefault("idle_clients_unchanged", 0)
    checks["idle_clients_unchanged"] += len(before)
    checks.setdefault("corrupt", 0)
    checks["corrupt"] += int(corrupt.sum())
    return out


def phase_cohort(torch, ctx, workdir):
    """Phase 11 (b): faulted cohort rounds over a 16-client host bank,
    fedlora_opt and lora_fedbuff at llama2-7b width, with telemetry on;
    fedlora_opt resumed from a file written with a straggler in flight;
    lora_fedbuff's bank served as pairs tenants through ``bgmv``."""
    from repro_torch import obs
    from repro_torch.fed import CohortSim, FaultPlan
    from repro_torch.fed.simulate import FedHyper, FedSim
    from repro_torch.serve import AdapterStore, ServeEngine
    from repro_torch.utils import pytree as pt
    cfg, params = ctx["cfg"], ctx["params"]
    report, checks = {}, {}
    for method in COHORT_METHODS:
        hp = FedHyper(method=method, **COHORT_HP)
        # one plain 4-client round: the device peak the bank must not raise
        plain = FedSim(cfg, hp, base=params, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        plain.run_round(*cohort_batches(torch, ctx, 0))
        torch.cuda.synchronize()
        plain_peak = torch.cuda.max_memory_allocated()
        state_bytes = tree_nbytes(torch, plain.client_adapters) + \
            tree_nbytes(torch, plain.opt_state)
        del plain
        gc.collect()
        torch.cuda.empty_cache()

        events_path = workdir / f"cohort_{method}.jsonl"
        obs.enable(str(events_path))
        try:
            sim = FedSim(cfg, hp, base=params, device="cuda")
            t0 = time.perf_counter()
            cs = CohortSim(sim, COHORT_N, faults=FaultPlan(**COHORT_PLAN),
                           seed=COHORT_SEED)
            bank_s = time.perf_counter() - t0
            bank_bytes = tree_nbytes(torch, cs.bank.adapters) + \
                tree_nbytes(torch, cs.bank.opt_state)
            check(all(x.device.type == "cpu" for t in (cs.bank.adapters,
                                                       cs.bank.opt_state)
                      for x in pt.tree_leaves(t)),
                  f"cohort {method}: the {COHORT_N}-client bank is host "
                  f"memory ({bank_bytes / 1e9:.2f} GB)")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            outs = []
            ckpt = workdir / "cohort.msgpack"
            for r in range(COHORT_HP["rounds"]):
                outs.append(cohort_round(torch, ctx, cs, r, f"cohort {method}",
                                         checks))
                if method == COHORT_RESUMED and r == 0:
                    check(any(d["deliver_at"] > 0 for d in cs._pending),
                          f"cohort {method}: a straggler in flight at the "
                          f"save")
                    in_flight = [dict(d) for d in cs._pending]
                    # the cohort file holds the bank, round, bill and
                    # in-flight updates, as the reference's; the sim's
                    # own file holds its step counter (AdamW's bias
                    # correction), which a resume needs as well
                    t0 = time.perf_counter()
                    cs.save(str(ckpt))
                    save_s = time.perf_counter() - t0
                    sim.save(str(workdir / "cohort_sim.msgpack"), round_idx=1)
            peak = torch.cuda.max_memory_allocated()
            check(peak <= plain_peak + state_bytes + COHORT_PEAK_SLACK,
                  f"cohort {method}: device peak {peak / 1e9:.3f} GB <= one "
                  f"plain round's {plain_peak / 1e9:.3f} GB + the 4 clients' "
                  f"state {state_bytes / 1e9:.3f} GB + "
                  f"{COHORT_PEAK_SLACK >> 20} MiB (the bank: "
                  f"{bank_bytes / 1e9:.2f} GB, on the host)")
            snap = obs.emit_snapshot()
        finally:
            obs.disable()
        draws = [replay_cohort(r) for r in range(COHORT_HP["rounds"])]
        for name, i in (("fed/dropouts", 1), ("fed/stragglers", 2),
                        ("fed/corrupt_updates", 3)):
            n = series(snap, "counters", name, method=method)
            check(n == sum(int(d[i].sum()) for d in draws),
                  f"cohort {method}: {name} = {n}, the draws'")
        evs = obs.read_events(str(events_path), kind="fed_cohort")
        check(len(evs) == COHORT_HP["rounds"]
              and evs[-1]["comm_bytes"] == sim.comm_bytes,
              f"cohort {method}: the last fed_cohort event's comm bytes "
              f"{evs[-1]['comm_bytes']} = sim.comm_bytes {sim.comm_bytes}")
        run = {"bank_gb": bank_bytes / 1e9, "bank_s": bank_s,
               "round_wall_s": [o["wall_s"] for o in outs],
               "peak_bytes": peak,
               "plain_round_peak_bytes": plain_peak,
               "state_bytes": state_bytes, "comm_bytes": sim.comm_bytes,
               "ce": [o["metrics"]["ce"].tolist() for o in outs],
               "participation": [o["participation"].astype(int).tolist()
                                 for o in outs],
               "delivered": [o["delivered"] for o in outs]}

        if method == COHORT_RESUMED:
            fresh = FedSim(cfg, hp, base=params, device="cuda")
            t0 = time.perf_counter()
            cs2 = CohortSim(fresh, COHORT_N, faults=FaultPlan(**COHORT_PLAN),
                            seed=COHORT_SEED)
            check(fresh.load(str(workdir / "cohort_sim.msgpack")) == 1
                  and cs2.load(str(ckpt)) == 1, f"cohort {method}: the files "
                  f"resume at round 1")
            load_s = time.perf_counter() - t0
            check([(d["client"], d["deliver_at"]) for d in cs2._pending]
                  == [(d["client"], d["deliver_at"]) for d in in_flight],
                  f"cohort {method}: the in-flight stragglers come back")
            for r in range(1, COHORT_HP["rounds"]):
                o = cohort_round(torch, ctx, cs2, r, f"cohort {method} "
                                 f"resumed", checks)
                w = outs[r]
                check(o["delivered"] == w["delivered"]
                      and o["delivered_billed"] == w["delivered_billed"]
                      and np.array_equal(o["metrics"]["ce"],
                                         w["metrics"]["ce"]),
                      f"cohort {method} resumed round {r}: deliveries and "
                      f"ce equal the uninterrupted run's")
                for d in in_flight:
                    if d["deliver_at"] == r:
                        check(cs2.bank.last_sync[d["client"]] ==
                              d["trained_round"] and o["delivered"] >= 1,
                              f"cohort {method}: client {d['client']}'s "
                              f"update delivered at its round {r}")
                        same_leaves(torch, bank_entry(torch, cs2.bank,
                                                      d["client"])["adapters"],
                                    d["adapters"], f"cohort {method}: the "
                                    f"delivered update")
            n = same_leaves(torch, cs2.bank.state_tree(), cs.bank.state_tree(),
                            f"cohort {method}: the resumed bank against the "
                            f"uninterrupted one")
            check(cs2.sim.comm_bytes == sim.comm_bytes
                  and cs2.round == cs.round and
                  [(d["client"], d["deliver_at"]) for d in cs2._pending]
                  == [(d["client"], d["deliver_at"]) for d in cs._pending],
                  f"cohort {method}: resumed comm bytes, round and in-flight "
                  f"stragglers equal the uninterrupted run's")
            print(f"ok: cohort {method}: rounds 2-3 from the file equal the "
                  f"uninterrupted run, {n} bank leaves bit for bit")
            run.update(save_s=save_s, load_s=load_s,
                       ckpt_gb=ckpt.stat().st_size / 1e9)
            del cs2, fresh
            ckpt.unlink()
            (workdir / "cohort_sim.msgpack").unlink()
        report[method] = run
        print(f"cohort {method}: " + json.dumps(run))
        if method == COHORT_SERVED:
            served = cs.bank
        del cs, sim
        gc.collect()
        torch.cuda.empty_cache()
    report["checks"] = checks

    # --- the served method's 16 bank clients as pairs tenants -------------
    tenants = [f"client{c}" for c in range(COHORT_N)]
    store = AdapterStore(params, cfg, n_slots=COHORT_N, kind="pairs",
                         rank=cfg.lora_rank, device="cuda")
    for c, t in enumerate(tenants):
        store.register(t, pt.tree_map(lambda x: x[c], served.adapters))
    rng = np.random.default_rng(11)
    reqs = [(t, rng.integers(0, cfg.vocab_size,
                             size=int(rng.integers(16, PAD_W + 1))
                             ).astype(np.int32)) for t in tenants]
    eng = ServeEngine(params, cfg, store, max_rows=COHORT_N,
                      max_prompt_len=PAD_W, max_len=MAX_LEN,
                      decode_chunk=CHUNK, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    _, st, counts = serve(torch, eng, reqs, "cohort bank", expect={"bgmv": 2})
    check(st["prefills"] == 1, "cohort bank: the 16 tenants in one batch")
    report["serve"] = engine_report("cohort bank", st, len(reqs),
                                    torch.cuda.max_memory_allocated())
    batch, last = admitted_batch(torch, store, reqs, rows=COHORT_N)
    report["serve"]["prefill_logits"] = logits_checks(
        torch, "cohort bank", pt.merge_trees(params, store.overlay()), cfg,
        prefill_logits(torch, batch, last), depths=(CHECK_DEPTH,))
    del store, served
    return report, counts["bgmv"]


def quant_bytes(tree):
    from repro_torch.utils import pytree as pt
    return sum(t.numel() * t.element_size()
               for p, t in pt.tree_leaves_with_path(tree)
               if p.endswith(("/kernel_q", "/kernel_scale")))


def phase_quant_path(torch, ctx):
    """Phase 5, path B4: the quantized engine over the dora_mag store, at
    full width, bf16; int8 per channel, then int4 in groups of 128.  Each
    engine is built from a freshly drawn backbone (the same weights) that
    is dropped before it serves, so the peak is what quantized serving
    holds."""
    from repro_torch.utils import pytree as pt
    cfg, mag, reqs = ctx["cfg"], ctx["mag"], ctx["reqs"]
    logits = prefill_logits(torch, ctx["batch"], ctx["last"])
    n = cfg.n_layers
    report, launches = {}, {}
    for mode, group in QUANT_MODES:
        label = f"dora_mag {mode}" + (f" g{group}" if group else "")
        qcfg = dataclasses.replace(cfg, backbone_quant=mode,
                                   backbone_quant_group=group)
        params, _ = draw(torch, cfg)
        bf16_bytes = sum(t.numel() * t.element_size()
                         for p, t in pt.tree_leaves_with_path(params)
                         if p.endswith("_proj/kernel"))
        t0 = time.perf_counter()
        eng = engine(params, qcfg, mag)
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t0
        tree = pt.merge_trees(eng.base, mag.overlay())
        drift = rel_err(logits(tree, qcfg, n, None),
                        logits(pt.merge_trees(params, mag.overlay()), cfg, n,
                               None))[0]
        del params
        gc.collect()
        torch.cuda.empty_cache()
        out = {"quantize_s": quantize_s, "proj_bytes": quant_bytes(eng.base),
               "proj_bytes_bf16": bf16_bytes,
               "drift_vs_unquantized_bf16": drift}
        print(f"{label}: quantized projections {out['proj_bytes']} bytes "
              f"(bf16 {bf16_bytes}); logits drift from the unquantized "
              f"model (printed only) {drift:.3e}")
        # the plain quant_matmul rounds every dequantized weight to bf16
        # where the kernel keeps it in f32, and the plain path is itself
        # 2e-2 from its f32 version at 2 layers: held at 1 (PERF.md)
        out["prefill_logits"] = logits_checks(torch, label, tree, qcfg,
                                              logits, depth=QUANT_CHECK_DEPTH)
        del tree
        serve(torch, eng, reqs[:2], f"{label} warm-up")
        torch.cuda.reset_peak_memory_stats()
        _, st, counts = serve(torch, eng, reqs, label,
                              expect={"quant_matmul": 7, "bgmv_mag": 2})
        out.update(engine_report(label, st, len(reqs),
                                 torch.cuda.max_memory_allocated()))
        if mode == "int8":
            out["profile"] = profile_run(
                torch, eng, reqs, label, (("quant_matmul", "::qmm_"),
                                          ("bgmv_mag", "bgmv_kernel")))
        report[mode] = out
        launches[mode] = counts["quant_matmul"]
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return report, launches


# ---------------------------------------------------------------------------
# phase 6: the standalone entry points at the configs' full widths
# ---------------------------------------------------------------------------

# name, config, B, Sq, Sk, causal, window, dtype: flash_attention(...)
FLASH_PATH = (
    ("llama2-7b prefill", LLAMA2_7B, 1, 4096, 4096, True, None, "bfloat16"),
    ("llama2-7b batch", LLAMA2_7B, 8, 512, 512, True, None, "bfloat16"),
    ("llama2-7b decode", LLAMA2_7B, 8, 1, 128, True, None, "bfloat16"),
    ("qwen3-32b prefill", QWEN3_32B, 1, 4096, 4096, True, None, "bfloat16"),
    ("gemma3-1b local", GEMMA3_1B, 1, 4096, 4096, True, 512, "bfloat16"),
    ("qwen3-32b non-causal", QWEN3_32B, 1, 1024, 1024, False, None,
     "bfloat16"),
    ("llama2-7b ragged", LLAMA2_7B, 1, 4095, 4095, True, None, "bfloat16"),
    ("llama2-7b prefill", LLAMA2_7B, 1, 4096, 4096, True, None, "float32"),
    ("gemma3-1b local", GEMMA3_1B, 1, 4096, 4096, True, 512, "float32"),
)
# through the bhsd wrapper: llama2-7b heads, a cache of 512 whose last 128
# slots are empty (sk_valid 384), causal, window 64: rows 447-511 see no key
FLASH_SK_VALID = dict(B=8, S=512, sk_valid=384, window=64)
# name, config, b, S, chunk (None: the dispatcher's default, 256), dtype
SSD_PATH = (
    ("mamba2-2.7b", MAMBA2_2_7B, 1, 4096, 128, "bfloat16"),
    ("mamba2-2.7b", MAMBA2_2_7B, 4, 2048, 128, "bfloat16"),
    ("jamba-v0.1", JAMBA_V0_1, 1, 4096, 128, "bfloat16"),
    ("mamba2-2.7b default chunk", MAMBA2_2_7B, 1, 4096, None, "bfloat16"),
    ("mamba2-2.7b", MAMBA2_2_7B, 1, 4096, 128, "float32"),
    ("mamba2-2.7b three-way", MAMBA2_2_7B, 1, 256, 128, "float32"),
)


def phase_standalone(torch):
    """Phase 6.  Every call goes through the entry point a user calls
    (``flash_attention``, ``ssd_scan``; the sk_valid case through
    ``flash_attention_bhsd_cuda``) with every launch count at 0; the
    outputs are held against the plain versions after the counts are
    read."""
    from repro_torch.kernels import flash_attention, ssd_naive, ssd_scan
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bhsd_cuda)
    from repro_torch.kernels.ssd_scan.ssd_scan import variant as ssd_variant
    from repro_torch.models.layers import _causal_window_mask, _sdpa

    flash_in = [qkv(torch, B, Sq, Sk, c["H"], c["K"], c["dh"],
                    getattr(torch, dn), seed=i)
                for i, (_, c, B, Sq, Sk, _, _, dn) in enumerate(FLASH_PATH)]
    sv = FLASH_SK_VALID
    c = LLAMA2_7B
    bq, bk, bv = (fold(t).contiguous()
                  for t in qkv(torch, sv["B"], sv["S"], sv["S"], c["H"], c["K"],
                               c["dh"], torch.bfloat16, seed=99))
    skw = dict(scale=c["dh"] ** -0.5, causal=True, window=sv["window"],
               sk_valid=sv["sk_valid"], q_offset=0)
    ssd_in = [ssd_inputs(torch, b, S, cfg, getattr(torch, dn), seed=i)
              for i, (_, cfg, b, S, _, dn) in enumerate(SSD_PATH)]
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    flash_out = [flash_attention(q, k, v, causal=causal, window=window)
                 for (q, k, v), (_, _, _, _, _, causal, window, _)
                 in zip(flash_in, FLASH_PATH)]
    sk_out = flash_attention_bhsd_cuda(bq, bk, bv, **skw)
    ssd_out = [ssd_scan(*(v[k] for k in SSD_ORDER),
                        **({} if chunk is None else {"chunk": chunk}))
               for v, (_, _, _, _, chunk, _) in zip(ssd_in, SSD_PATH)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_flash, n_ssd = len(FLASH_PATH) + 1, len(SSD_PATH)
    check_launches(launches, {"flash_attention": n_flash, "ssd_scan": n_ssd},
                   1, 1, "standalone", f"{n_flash} flash_attention and {n_ssd} "
                   f"ssd_scan calls")

    report = {"wall_s": wall, "flash_attention": {}, "ssd_scan": {}}
    for (name, c, B, Sq, Sk, causal, window, dn), (q, k, v), y in zip(
            FLASH_PATH, flash_in, flash_out):
        shape = (f"q{tuple(q.shape)} k{tuple(k.shape)} causal={causal} "
                 f"window={window}")
        e, _ = check_flash(f"standalone flash_attention {name} {dn} {shape}",
                           fold(y), fold(q), fold(k), fold(v),
                           scale=c["dh"] ** -0.5, causal=causal, window=window,
                           q_offset=Sk - Sq)
        report["flash_attention"][f"{name} {dn}"] = dict(e, shape=shape)
    q, k, v = flash_in[0]
    mask = _causal_window_mask(q.shape[1], k.shape[1], 0, None,
                               q.device)[None, None]
    sdpa_err = max_abs(flash_out[0], _sdpa(q, k, v, mask, q.shape[-1] ** -0.5))
    report["flash_attention"]["llama2-7b prefill bfloat16"]["vs_layers_sdpa"] = \
        sdpa_err
    print(f"standalone flash_attention llama2-7b prefill against the port's "
          f"models/layers._sdpa (causal mask, bf16, printed only): max abs "
          f"{sdpa_err:.3e}")
    rows_empty = sv["S"] - (sv["sk_valid"] + sv["window"] - 1)
    e, _ = check_flash(
        f"standalone flash_attention_bhsd q{tuple(bq.shape)} sk_valid "
        f"{sv['sk_valid']} window {sv['window']} ({rows_empty} rows see no "
        f"key) bfloat16", sk_out, bq, bk, bv, **skw)
    report["flash_attention"]["sk_valid"] = dict(e, q=list(bq.shape))
    del flash_in, flash_out

    for (name, c, b, S, chunk, dn), v, (y, st) in zip(SSD_PATH, ssd_in, ssd_out):
        ch = 256 if chunk is None else chunk
        label = f"standalone ssd_scan {name} {dn} x{tuple(v['x'].shape)} chunk {ch}"
        e, refs = ssd_check(torch, label, v, y, st, ch)
        e["variant"] = ssd_variant(y.dtype)
        if dn == "float32" and S <= 256:
            y_n, st_n = ssd_naive(*(v[k] for k in SSD_ORDER))
            for who, (ya, sa) in (("kernel", (y, st)), ("ssd_ref", refs)):
                ratio, rel = ssd_f32_errs(ya, sa, y_n, st_n)
                e[f"{who}_vs_naive_bound_ratio"] = ratio
                check(ratio <= 1.0, f"{label}: {who} vs ssd_naive within "
                      f"rtol {SSD_RTOL} atol {SSD_ATOL} (worst |err| / bound "
                      f"{ratio:.3f}; {rel:.3e} of max |y|)")
        report["ssd_scan"][f"{name} {dn} b={b} S={S}"] = dict(e, chunk=ch)
    print("standalone: " + json.dumps(report))
    return report, {k: launches[k] for k in ("flash_attention", "ssd_scan")}


# --- phase 13: the rest of the dense family (run after phase 6) ------------

DENSE_S = 4096          # prefill tokens: the chunked path (S >= 2048, S % 512)
DENSE_NEW = 16          # greedy tokens at qwen3-32b and granite-34b
# layers run at full width: qwen3-32b whole (61.0 GiB in bf16), granite-34b
# cut from 88 (88.0 GiB in bf16 is more than the card holds)
DENSE_DEPTH = {"qwen3-32b": 64, "granite-34b": 24}
GEMMA_NEW = 64
RING_PROMPT, RING_STEPS = 448, 128   # decode position 512 wraps the ring
RING_HELD = (0, 63, 64, 127)         # decode steps held against forward
DENSE_TRAIN_HP = dict(method="fedlora_opt", n_clients=2, rounds=1,
                      local_steps=2, batch=1, seq_len=DENSE_S, global_steps=1,
                      personal_steps=1, lr=1e-3, server_lr=5e-4)
DENSE_EVAL_S = 128      # eval batches: below the chunked length, no kernel
DENSE_SERVE_PROMPT = 64


def dense_model(torch, arch, layers=None, dtype=None, seed=0):
    """``arch``'s config (at ``layers``, an encoder's too, in ``dtype``
    when given, dropout 0) and its random backbone from a seeded
    generator on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    kw = {"lora_dropout": 0.0}
    if layers:
        kw["n_layers"] = layers
        if get_config(arch).n_enc_layers:
            kw["n_enc_layers"] = layers
    if dtype:
        kw["dtype"] = dtype
    cfg = dataclasses.replace(get_config(arch), **kw)
    g = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = M.init_params(g, cfg, device="cuda")
    torch.cuda.synchronize()
    enc = f" + {cfg.n_enc_layers}" if cfg.n_enc_layers else ""
    print(f"{arch} ({cfg.n_layers}{enc} layers, {cfg.dtype}) drawn on the "
          f"card in {time.perf_counter() - t0:.2f} s")
    return cfg, params


def first_layers(params, cfg, depth):
    """``params`` cut to its first ``depth`` layers (whole superblocks in
    the stack, the rest as a tail; an encoder-decoder's encoder and
    decoder layers each) and the config to match."""
    from repro_torch.utils import pytree as pt
    if cfg.n_enc_layers:
        cut = dict(params, blocks=pt.tree_map(lambda t: t[:depth],
                                              params["blocks"]),
                   encoder=dict(params["encoder"], blocks=pt.tree_map(
                       lambda t: t[:depth], params["encoder"]["blocks"])))
        return cut, dataclasses.replace(cfg, n_layers=depth,
                                        n_enc_layers=depth)
    n_sb, _, pattern = cfg.blocks_layout(depth)
    tail = depth - n_sb * len(pattern)
    cut = dict(params, blocks=pt.tree_map(lambda t: t[:n_sb],
                                          params["blocks"]) if n_sb else {})
    cut.pop("tail", None)
    if tail:
        cut["tail"] = {f"sub{i}": pt.tree_map(lambda t: t[n_sb],
                                             params["blocks"][f"sub{i}"])
                       for i in range(tail)}
    return cut, dataclasses.replace(cfg, n_layers=depth)


def prefill_last(torch, params, cfg, tokens, impl):
    """The prefill's work through ``forward`` (hidden states and the cache
    with DENSE_NEW slots of headroom) at ``impl``; the last row's
    logits, f32."""
    from repro_torch.models import model as M
    S = tokens.shape[1]
    h, _, _ = M.forward(params, {"tokens": tokens}, cfg, return_cache=True,
                        cache_len=S + DENSE_NEW, kernel_impl=impl)
    return (h[:, -1] @ M._head_kernel(params, cfg).to(h.dtype)).float()


def synced(torch, fn):
    """(fn(), host ms around it ending in a sync, the peak bytes it
    allocated above what was allocated before it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    return out, ms, torch.cuda.max_memory_allocated() - before


def greedy_plain(torch, params, cfg, tokens, n_new):
    """Greedy tokens with the prefill on the plain chunked path
    (``kernel_impl="torch"``) and ``decode_step`` after it."""
    from repro_torch.models import model as M
    S = tokens.shape[1]
    h, cache, _ = M.forward(params, {"tokens": tokens}, cfg,
                            return_cache=True, cache_len=S + n_new,
                            kernel_impl="torch")
    tok = M.argmax_first((h[:, -1] @ M._head_kernel(params, cfg).to(
        h.dtype)).float())
    out = [tok]
    for i in range(n_new - 1):
        logits, cache = M.decode_step(params, tok, cache, S + i, cfg)
        tok = M.argmax_first(logits)
        out.append(tok)
    return torch.stack(out, dim=1)


def dense_tokens(torch, cfg, B, S, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                         device="cuda")


def flash_vs_plain(torch, label, params, cfg, tokens, tol, greedy=0,
                   family="dense", kernels="flash_attention"):
    """The prefill's last-row logits with the hand-written kernels
    (``kernels`` names them: flash_attention, and ssd_scan on an SSM
    path) against the plain path (``kernel_impl="torch"``), relative to
    max |logit|, within ``tol``; with ``greedy``, also that many greedy
    tokens equal."""
    from repro_torch.launch.serve import greedy_generate
    err, _ = rel_err(prefill_last(torch, params, cfg, tokens, None),
                     prefill_last(torch, params, cfg, tokens, "torch"))
    check(err <= tol, f"{family} {label}: prefill logits, {kernels} "
          f"vs the plain path: {err:.3e} <= {tol} of max |logit|")
    out = {"logits_rel_err": err}
    if greedy:
        a = greedy_generate(params, {"tokens": tokens}, cfg, greedy,
                            device="cuda").cpu().numpy()
        b = greedy_plain(torch, params, cfg, tokens, greedy).cpu().numpy()
        check(np.array_equal(a, b), f"{family} {label}: {greedy} greedy "
              f"tokens with {kernels} equal the plain path's")
        out["greedy_tokens_equal"] = greedy
    return out


def dense_generate(torch, label, params, cfg, tokens, n_new,
                   family="dense", per_prefill=None):
    """``greedy_generate`` timed twice after a warm-up: for 1 token (the
    prefill and its argmax) and for ``n_new``; each kernel must launch
    ``per_prefill[name]`` times in each prefill (default flash_attention
    once a layer) and nowhere else, so never in a decode step.  Returns
    the report (with the launches) and flash_attention's launches of the
    two timed runs."""
    from repro_torch.launch.serve import greedy_generate
    greedy_generate(params, {"tokens": tokens[:, :2048]}, cfg, 2,
                    device="cuda")                          # warm-up
    reset_launches()
    toks1, ms1, peak1 = synced(torch, lambda: greedy_generate(
        params, {"tokens": tokens}, cfg, 1, device="cuda"))
    toks, ms, peak = synced(torch, lambda: greedy_generate(
        params, {"tokens": tokens}, cfg, n_new, device="cuda"))
    launches = read_launches()
    check_launches(launches, per_prefill or {"flash_attention": cfg.n_layers},
                   1, 2, f"{family} {label}", "2 prefills of greedy_generate")
    toks = toks.cpu().numpy()
    check(toks.shape == (tokens.shape[0], n_new) and toks.min() >= 0
          and toks.max() < cfg.vocab_size
          and np.array_equal(toks[:, :1], toks1.cpu().numpy()),
          f"{family} {label}: {n_new} greedy tokens in the vocabulary, the "
          f"first the 1-token run's")
    report = {"layers": cfg.n_layers, "prompt": list(tokens.shape),
              "prefill_ms": ms1, "generate_ms": ms, "new_tokens": n_new,
              "decode_step_ms": (ms - ms1) / (n_new - 1),
              "tokens_per_s": tokens.shape[0] * n_new / (ms / 1e3),
              "peak_bytes_above_params": max(peak, peak1),
              "allocated_bytes": torch.cuda.memory_allocated(),
              "launches": {k: v for k, v in launches.items() if v}}
    print(f"{family} {label} [{GPU}]: " + json.dumps(report))
    return report, launches["flash_attention"]


def free(torch):
    """Release what this process no longer holds, the memory the grid's
    ranks mapped from it (CUDA IPC) and have dropped included."""
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()


def dense_llama(torch):
    """(a) llama2-7b, 32 layers, bf16, prefill 1 x 4096: the plain chunked
    path and flash_attention, each timed with its peak; flash held to
    the plain path in bf16 through CHECK_DEPTH layers and in f32 through
    all 32."""
    from repro_torch.models import model as M
    cfg, params = dense_model(torch, "llama2-7b")
    tokens = dense_tokens(torch, cfg, 1, DENSE_S, seed=1)
    report = {}
    for name, impl in (("plain", "torch"), ("flash", None)):
        prefill_last(torch, params, cfg, tokens, impl)          # warm-up
        reset_launches()
        _, ms, peak = synced(torch, lambda: prefill_last(torch, params, cfg,
                                                         tokens, impl))
        launches = read_launches()
        check_launches(launches, {"flash_attention": int(impl is None)},
                       cfg.n_layers, 1, f"dense llama2-7b {name} prefill",
                       "1 prefill")
        # the forward alone (no cache kept): the attention path's own peak
        _, fwd_ms, fwd_peak = synced(torch, lambda: M.forward(
            params, {"tokens": tokens}, cfg, kernel_impl=impl)[0][:, -1])
        report[name] = {"prefill_ms": ms, "peak_bytes_above_params": peak,
                        "forward_ms": fwd_ms,
                        "forward_peak_bytes_above_params": fwd_peak}
        if impl is None:
            n_flash = launches["flash_attention"]
    for key in ("peak_bytes_above_params",
                "forward_peak_bytes_above_params"):
        report["plain_minus_flash_" + key] = (report["plain"][key]
                                              - report["flash"][key])
    cut, ccfg = first_layers(params, cfg, CHECK_DEPTH)
    report["bf16"] = flash_vs_plain(torch, f"llama2-7b {CHECK_DEPTH} layers "
                                    f"bf16", cut, ccfg, tokens,
                                    TOL["bfloat16"])
    del cut
    f32 = to_f32(params)
    del params
    free(torch)
    report["f32"] = flash_vs_plain(
        torch, f"llama2-7b {cfg.n_layers} layers f32", f32,
        dataclasses.replace(cfg, dtype="float32"), tokens, LOGITS_F32_TOL)
    del f32
    free(torch)
    print(f"dense llama2-7b 1 x {DENSE_S} prefill [{GPU}]: "
          + json.dumps(report))
    return report, n_flash


def dense_big(torch, arch):
    """(b), (c): ``arch`` at full width and DENSE_DEPTH layers, bf16:
    greedy_generate over a 1 x 4096 prompt, and flash against the plain
    chunked path through its first CHECK_DEPTH layers in bf16 (the
    tensor-core kernel the prefill runs; granite's rep 48); then at 2
    layers of full width in f32, flash against the plain chunked path
    (logits within LOGITS_F32_TOL, greedy tokens equal)."""
    from repro_torch.configs import get_config
    full = get_config(arch).n_layers
    depth = DENSE_DEPTH[arch]
    if depth < full:
        print(f"dense {arch}: full width, depth cut to {depth} of {full} "
              f"layers ({full} do not fit the card in bf16)")
    cfg, params = dense_model(torch, arch, layers=depth)
    tokens = dense_tokens(torch, cfg, 1, DENSE_S, seed=2)
    report, n_flash = dense_generate(torch, arch, params, cfg, tokens,
                                     DENSE_NEW)
    report["full_layers"] = full
    report["bf16"] = flash_vs_plain(torch, f"{arch} {CHECK_DEPTH} layers "
                                    f"bf16", *first_layers(params, cfg,
                                                           CHECK_DEPTH),
                                    tokens, TOL["bfloat16"])
    del params
    free(torch)
    cfg, params = dense_model(torch, arch, layers=2, dtype="float32")
    report["f32_2_layers"] = flash_vs_plain(torch, f"{arch} 2 layers f32",
                                            params, cfg, tokens,
                                            LOGITS_F32_TOL, greedy=DENSE_NEW)
    del params
    free(torch)
    return report, n_flash


def dense_gemma(torch):
    """(d) gemma3-1b at full size, 26 layers: greedy_generate over a 1 x
    4096 prompt in bf16 (the local layers through flash's window 512);
    flash against the plain chunked path in bf16 through CHECK_DEPTH
    layers (two local layers) and in f32 through all 26; then in f32 a
    448-token prompt and 128 decode steps, which wrap the 512-slot ring
    at step 64: the tokens equal greedy_generate's, and the logits of
    decode steps RING_HELD equal the plain forward's over the sequence
    so far (last row) within LOGITS_F32_TOL.  Returns the report, the
    model-path flash launches and the f32 backbone (for (e))."""
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models import model as M
    cfg, params = dense_model(torch, "gemma3-1b")
    tokens = dense_tokens(torch, cfg, 1, DENSE_S, seed=3)
    report, n_flash = dense_generate(torch, "gemma3-1b", params, cfg, tokens,
                                     GEMMA_NEW)
    cut, ccfg = first_layers(params, cfg, CHECK_DEPTH)
    report["bf16"] = flash_vs_plain(torch, f"gemma3-1b {CHECK_DEPTH} layers "
                                    f"bf16", cut, ccfg, tokens,
                                    TOL["bfloat16"])
    del cut
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = to_f32(params)
    report["f32"] = flash_vs_plain(torch, f"gemma3-1b {cfg.n_layers} layers f32", p32,
                                   cfg32, tokens, LOGITS_F32_TOL)

    prompt = dense_tokens(torch, cfg, 1, RING_PROMPT, seed=4)
    want = greedy_generate(p32, {"tokens": prompt}, cfg32, RING_STEPS + 1,
                           device="cuda")
    logits, cache = M.prefill(p32, {"tokens": prompt}, cfg32,
                              cache_len=RING_PROMPT + RING_STEPS + 1)
    tok = M.argmax_first(logits)
    seq, held = [tok], {}
    for i in range(RING_STEPS):
        logits, cache = M.decode_step(p32, tok, cache, RING_PROMPT + i, cfg32)
        if i in RING_HELD:
            held[i] = logits
        tok = M.argmax_first(logits)
        seq.append(tok)
    got = torch.stack(seq, dim=1)
    check(torch.equal(got, want), f"dense gemma3-1b ring: the decode loop's "
          f"{RING_STEPS + 1} tokens equal greedy_generate's")
    errs = {}
    for i, lg in held.items():
        full = torch.cat([prompt, got[:, :i + 1]], dim=1)
        with torch.no_grad():
            ref = prefill_last(torch, p32, cfg32, full, "torch")
        errs[i] = rel_err(lg, ref)[0]
        check(errs[i] <= LOGITS_F32_TOL, f"dense gemma3-1b ring: decode step "
              f"{i} (position {RING_PROMPT + i}, ring slot "
              f"{(RING_PROMPT + i) % cfg.sliding_window}) logits vs the plain "
              f"forward over {full.shape[1]} tokens: {errs[i]:.3e} <= "
              f"{LOGITS_F32_TOL} of max |logit|")
    report["ring"] = {"prompt": RING_PROMPT, "steps": RING_STEPS,
                      "held_rel_err": errs}
    print(f"dense gemma3-1b ring [{GPU}]: " + json.dumps(report["ring"]))
    return report, n_flash, params, p32


def dense_training(torch, params, p32):
    """(e) fedlora_opt through run_federated at gemma3-1b full size, bf16,
    under phase 7's stage checks (``run_checked``): 2 clients x 1 x 4096
    tokens, 1 round of 2 steps (the first warms up: the first backward
    at these shapes takes about 10 s once), 1 stage-2 and 1 stage-3
    step, dropout 0 (training takes the plain chunked, windowed path,
    each query block under checkpoint; eval batches of 128 tokens: no
    kernel runs); then the 2 personalized clients served as dora_mag
    tenants over the f32 backbone through greedy_generate with
    adapter_idx (bgmv_mag), each row's tokens equal to its merged
    model's."""
    from repro_torch.configs import get_config
    from repro_torch.fed.simulate import FedHyper, client
    from repro_torch.launch.serve import greedy_generate, merge_adapters
    from repro_torch.serve import AdapterStore
    from repro_torch.utils import pytree as pt

    cfg = dataclasses.replace(get_config("gemma3-1b"), lora_dropout=0.0)
    hp = FedHyper(**DENSE_TRAIN_HP)
    C = hp.n_clients
    data = fed_data(cfg, C, hp.batch, DENSE_EVAL_S)
    free(torch)
    res, sim, log, wall, peak = run_checked(torch, cfg, params, hp, data)
    step_ms = [1e3 * s for s in log["stage1_step"]]
    report = {"config": dict(DENSE_TRAIN_HP, layers=cfg.n_layers,
                             eval_seq_len=DENSE_EVAL_S),
              "wall_s": wall, "peak_bytes": peak,
              "stage1_step_ms": step_ms, "stage1_step_ms_warm": step_ms[-1],
              "stage_wall_s": {k: v for k, v in log.items() if k != "rounds"},
              "train_ce": [h["train_ce"] for h in res.history]}
    print(f"dense training gemma3-1b 2 x 1 x {DENSE_S} [{GPU}]: "
          + json.dumps(report))

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    server = pt.tree_map(lambda t: t.float(), sim.server_model)
    store = AdapterStore(p32, cfg32, n_slots=4, kind="dora_mag",
                         shared=server, device="cuda")
    tenants = [f"client{c}" for c in range(C)]
    own = [pt.tree_map(lambda t: t.float(), client(sim.client_adapters, c))
           for c in range(C)]
    for t, ad in zip(tenants, own):
        store.register(t, pt.filter_tree(ad, lambda p: p.endswith("/dB_mag")))
    prompts = dense_tokens(torch, cfg, C, DENSE_SERVE_PROMPT, seed=5)
    slots = torch.tensor([store.slot_of(t) for t in tenants], device="cuda")
    pooled_params = pt.merge_trees(p32, store.overlay())
    reset_launches()
    pooled, ms, _ = synced(torch, lambda: greedy_generate(
        pooled_params, {"tokens": prompts}, cfg32, DENSE_NEW,
        adapter_idx=slots, device="cuda"))
    launches = read_launches()
    check_launches(launches, {"bgmv_mag": 2}, cfg.n_layers, DENSE_NEW,
                   "dense serve gemma3-1b", f"1 prefill + {DENSE_NEW - 1} "
                   f"decode steps")
    for c, ad in enumerate(own):
        merged = greedy_generate(merge_adapters(p32, ad),
                                 {"tokens": prompts[c:c + 1]}, cfg32,
                                 DENSE_NEW, device="cuda")
        check(torch.equal(pooled[c:c + 1], merged), f"dense serve gemma3-1b: "
              f"tenant {tenants[c]}'s {DENSE_NEW} tokens through bgmv_mag "
              f"equal its merged model's")
    report["serve"] = {"tenants": C, "prompt": DENSE_SERVE_PROMPT,
                       "new_tokens": DENSE_NEW, "wall_ms": ms,
                       "tokens_per_s": C * DENSE_NEW / (ms / 1e3)}
    print(f"dense serve gemma3-1b f32 [{GPU}]: " + json.dumps(report["serve"]))
    return report, launches["bgmv_mag"]


def phase_dense(torch):
    """Phase 13.  Returns the report and the model path's launches of
    flash_attention (the timed prefills of (a)-(d)) and bgmv_mag ((e)'s
    pooled generation)."""
    report, flash = {}, {}
    t0 = time.perf_counter()
    report["llama2-7b"], flash["llama2-7b"] = dense_llama(torch)
    for arch in ("qwen3-32b", "granite-34b"):
        report[arch], flash[arch] = dense_big(torch, arch)
    report["gemma3-1b"], flash["gemma3-1b"], params, p32 = dense_gemma(torch)
    report["training"], n_mag = dense_training(torch, params, p32)
    del params, p32
    free(torch)
    report["flash_launches"] = flash
    report["wall_s"] = time.perf_counter() - t0
    print(f"dense family [{GPU}]: flash_attention launches on the model path "
          + json.dumps(flash) + f"; phase wall {report['wall_s']:.1f} s")
    return report, {"flash_attention": sum(flash.values()), "bgmv_mag": n_mag}


# --- phase 14: mixture of experts (run after phase 13) ---------------------

MOE_QWEN, MOE_MIXTRAL = "qwen3-moe-30b-a3b", "mixtral-8x22b"
MOE_NEW = 16            # greedy tokens after each long prefill
MIXTRAL_S = 8192        # past mixtral's window of 4096: the window cuts it
# mixtral at full width: 10 of 56 layers are 50.9 GB in bf16 (56 would be
# 281 GB; quantize_backbone leaves the experts as they are, in both packages)
MIXTRAL_DEPTH = 10
MOE_LAYER_T = 512       # tokens of (b)'s one layer at qwen3-moe width
MOE_LAYER_TOL = 1e-4    # f32 grouped vs the dense oracle, of max |y|
MOE_AUX_TOL = 1e-5      # f32 aux vs the oracle's
# bf16 grouped (bf16 weights, activations and router product) vs the f32
# oracle on the same rounded weights, router and inputs, of max |y|, over
# the tokens whose bf16 top-k set is the f32 one; at most MOE_FLIP_SHARE
# of the tokens route otherwise: the bf16 product rounds each logit by up
# to 2^-9 of it (~4e-3 at |logit| ~ 1), against a mean gap of ~5e-2
# between a token's 8th and 9th logit of 128 at these weights
MOE_BF16_TOL = 2e-2
MOE_FLIP_SHARE = 0.15
# bf16 prefill logits, flash against the plain chunked path, are held at
# 2e-2 through CHECK_DEPTH layers, but through 1 at mixtral: its random
# model's bf16 runs part by 1.26e-2 of max |logit| through 1 layer, 2.04e-2
# through 2, 2.34e-2 through 3 and 4.66e-2 through 4, while f32 through 2
# agrees to 7.0e-6 (PERF.md §6); both models' flash outputs are also
# held elementwise within bf16_bound_bhsd in each of CHECK_DEPTH layers
MOE_BF16_DEPTH = {MOE_MIXTRAL: 1}
MOE_BOUND_ROWS = 512    # the last query rows held within bf16_bound_bhsd
MOE_TRAIN_DEPTH = 8     # qwen3-moe layers trained and served in (d)
MOE_TRAIN_HP = dict(method="fedlora_opt", n_clients=4, rounds=1,
                    local_steps=2, batch=4, seq_len=128, global_steps=1,
                    personal_steps=1)
MOE_SERVE_PROMPT = 32   # (d)'s prompts: every row full, no padding


def drop_free(cfg):
    """``cfg`` at capacity E / k: every slot takes all T rows, nothing is
    dropped, and a token's output is its own whatever the batch."""
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


def flash_within_bound(torch, label, params, cfg, tokens, n_attn=None,
                       batch=None):
    """A bf16 prefill through flash_attention (``forward`` of ``tokens``,
    or of ``batch`` when given, no cache): in each layer, the kernel's
    output for the last MOE_BOUND_ROWS query rows of every head, on that
    layer's own q, k and v and mask (causal or not), elementwise within
    ``bf16_bound_bhsd`` of the plain attention in f32 on the same values;
    ``n_attn`` such layers (default every layer).  Returns the largest
    |err| / bound."""
    from repro_torch.kernels.flash_attention.ref import bf16_bound_bhsd
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    seen = []
    real = L._long_attention

    def spy(q, k, v, softmax_scale, window, kernel_impl, causal=True):
        y = real(q, k, v, softmax_scale, window, kernel_impl, causal)
        n = MOE_BOUND_ROWS
        seen.append((q[:, -n:].clone(), k.clone(), v.clone(),
                     y[:, -n:].clone(), softmax_scale, window, causal))
        return y
    L._long_attention = spy
    try:
        with torch.no_grad():
            M.forward(params, batch or {"tokens": tokens}, cfg)
    finally:
        L._long_attention = real

    def fold(t):
        return t.transpose(1, 2).reshape(-1, t.shape[1], t.shape[3]
                                         ).contiguous()
    worst = 0.0
    for i, (q, k, v, y, sc, window, causal) in enumerate(seen):
        ref, bound = bf16_bound_bhsd(fold(q), fold(k), fold(v), scale=sc,
                                     causal=causal, window=window,
                                     q_offset=k.shape[1] - q.shape[1])
        ratio = float(((fold(y).float() - ref).abs() / bound).max())
        check(ratio <= 1.0, f"{label} layer {i}: flash_attention's "
              f"last {q.shape[1]} rows of {q.shape[2]} heads within "
              f"bf16_bound_bhsd (largest |err| / bound {ratio:.3f})")
        worst = max(worst, ratio)
        del ref, bound
    want = cfg.n_layers if n_attn is None else n_attn
    check(len(seen) == want, f"{label}: one long attention an attention "
          f"layer ({len(seen)} of {want})")
    return worst


def moe_generate(torch, arch, layers=None):
    """(a) / (c): ``arch`` at full width (``layers`` deep), bf16, a 1 x S
    prompt through ``greedy_generate`` (flash_attention once a layer in
    each prefill); flash within ``bf16_bound_bhsd`` in each of
    CHECK_DEPTH layers and against the plain chunked path through
    MOE_BF16_DEPTH layers in bf16; then 2 layers of full width in f32,
    flash against the plain chunked path (logits within LOGITS_F32_TOL,
    MOE_NEW greedy tokens equal)."""
    from repro_torch.configs import get_config
    full = get_config(arch).n_layers
    S = MIXTRAL_S if arch == MOE_MIXTRAL else DENSE_S
    if layers and layers < full:
        print(f"moe {arch}: full width, depth cut to {layers} of {full} "
              f"layers ({full} do not fit the card)")
    cfg, params = dense_model(torch, arch, layers=layers)
    tokens = dense_tokens(torch, cfg, 1, S, seed=6)
    report, n_flash = dense_generate(torch, arch, params, cfg, tokens,
                                     MOE_NEW, family="moe")
    report["full_layers"] = full
    depth = MOE_BF16_DEPTH.get(arch, CHECK_DEPTH)
    cut, ccfg = first_layers(params, cfg, CHECK_DEPTH)
    report["bf16_bound_ratio"] = flash_within_bound(
        torch, f"moe {arch} {CHECK_DEPTH} layers bf16", cut, ccfg, tokens)
    report["bf16"] = flash_vs_plain(torch, f"{arch} {depth} layers bf16",
                                    *first_layers(params, cfg, depth),
                                    tokens, TOL["bfloat16"], family="moe")
    if depth < CHECK_DEPTH:
        report["bf16_rel_err_at_check_depth"] = rel_err(
            prefill_last(torch, cut, ccfg, tokens, None),
            prefill_last(torch, cut, ccfg, tokens, "torch"))[0]
        print(f"moe {arch} {CHECK_DEPTH} layers bf16: prefill logits, flash "
              f"vs plain {report['bf16_rel_err_at_check_depth']:.3e} of max "
              f"|logit| (printed; held through {depth})")
    del params, cut
    free(torch)
    cfg, params = dense_model(torch, arch, layers=2, dtype="float32")
    report["f32_2_layers"] = flash_vs_plain(
        torch, f"{arch} 2 layers f32", params, cfg, tokens, LOGITS_F32_TOL,
        greedy=MOE_NEW, family="moe")
    del params
    free(torch)
    return report, n_flash


def moe_layer_inputs(torch, cfg, seed=0):
    """One MoE layer of ``cfg``'s width in f32 drawn on the card (the
    router N(0, 0.02²), the experts N(0, 0.02²)) and x (1, T, D) N(0, 1)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    D, E, F = cfg.d_model, cfg.n_experts, cfg.d_ff

    def n(*shape):
        return 0.02 * torch.randn(shape, generator=g, device="cuda")
    p = {"router": {"kernel": n(D, E)},
         "experts": {"gate": n(E, D, F), "up": n(E, D, F), "down": n(E, F, D)}}
    x = torch.randn((1, MOE_LAYER_T, D), generator=g, device="cuda")
    return p, x


def moe_layer_check(torch):
    """(b) One layer of qwen3-moe width (128 experts, top 8, D 2048, F
    768) at T = 512, drop-free: the grouped layer (``moe_ffn_local``)
    in f32 against ``moe_ffn_dense_ref`` within MOE_LAYER_TOL, its aux
    within MOE_AUX_TOL; in bf16 against the f32 oracle on the same
    rounded weights, router and inputs within MOE_BF16_TOL over the
    tokens that route alike; two runs bit-equal in f32, in bf16 and in
    bf16 at the published capacity (the fixed-order combine)."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.utils import pytree as pt
    cfg = dataclasses.replace(get_config(MOE_QWEN), dtype="float32")
    free_cfg = drop_free(cfg)
    p, x = moe_layer_inputs(torch, cfg)
    with torch.no_grad():
        y, aux = L.moe_ffn_local(p, x, free_cfg)
        yo, auxo = L.moe_ffn_dense_ref(p, x, free_cfg)
        err, _ = rel_err(y, yo)
        aux_err = abs(float(aux) - float(auxo))
        check(err <= MOE_LAYER_TOL, f"moe layer f32, T {MOE_LAYER_T}: grouped "
              f"vs the dense oracle {err:.3e} <= {MOE_LAYER_TOL} of max |y|")
        check(aux_err <= MOE_AUX_TOL, f"moe layer f32: aux {float(aux):.6f} "
              f"vs the oracle's {float(auxo):.6f}: {aux_err:.2e} <= "
              f"{MOE_AUX_TOL}")
        check(torch.equal(L.moe_ffn_local(p, x, free_cfg)[0], y),
              "moe layer f32: two runs bit-equal")
        # bf16: the experts and x rounded, the router kept in f32 (its
        # product runs in bf16, as the model's)
        p16 = {"router": p["router"], "experts": pt.tree_map(
            lambda t: t.to(torch.bfloat16), p["experts"])}
        x16 = x.to(torch.bfloat16)
        cfg16 = dataclasses.replace(free_cfg, dtype="bfloat16")
        pr = {"router": {"kernel": p["router"]["kernel"].to(
            torch.bfloat16).float()}, "experts": pt.tree_map(
            lambda t: t.float(), p16["experts"])}
        yr, _ = L.moe_ffn_dense_ref(pr, x16.float(), free_cfg)
        (y16, aux16), ms, _ = synced(torch, lambda: L.moe_ffn_local(
            p16, x16, cfg16))
        xt = x16.reshape(-1, cfg.d_model)
        i16 = L.moe_router(p16, xt, cfg16)[0].sort(-1).values
        i32 = L.moe_router(pr, xt.float(), free_cfg)[0].sort(-1).values
        same = (i16 == i32).all(-1)
        flips = int((~same).sum())
        d = (y16.float() - yr).abs().reshape(-1, cfg.d_model)[same]
        err16 = float(d.max() / yr.abs().max())
        check(flips <= MOE_FLIP_SHARE * MOE_LAYER_T, f"moe layer bf16: "
              f"{flips} of {MOE_LAYER_T} tokens route otherwise than in f32 "
              f"<= {MOE_FLIP_SHARE:.0%}")
        check(err16 <= MOE_BF16_TOL, f"moe layer bf16 vs the f32 oracle over "
              f"the {int(same.sum())} tokens routed alike: {err16:.3e} <= "
              f"{MOE_BF16_TOL} of max |y|")
        y16b, aux16b = L.moe_ffn_local(p16, x16, cfg16)
        check(torch.equal(y16, y16b) and torch.equal(aux16, aux16b),
              "moe layer bf16: two runs bit-equal")
        pub = dataclasses.replace(cfg16, capacity_factor=cfg.capacity_factor)
        ya, _ = L.moe_ffn_local(p16, x16, pub)
        yb, _ = L.moe_ffn_local(p16, x16, pub)
        check(torch.equal(ya, yb), f"moe layer bf16 at capacity "
              f"{cfg.capacity_factor} (drops): two runs bit-equal")
    out = {"tokens": MOE_LAYER_T, "f32_rel_err": err, "aux": float(aux),
           "aux_err": aux_err, "bf16_rel_err_routed_alike": err16,
           "bf16_tokens_routed_otherwise": flips, "bf16_ms": ms,
           "capacity_drop_free": L.moe_capacity(cfg16, MOE_LAYER_T),
           "capacity_published": L.moe_capacity(pub, MOE_LAYER_T)}
    print(f"moe layer {MOE_QWEN} width [{GPU}]: " + json.dumps(out))
    del p, x, p16, pr
    free(torch)
    return out


def moe_training(torch):
    """(d) qwen3-moe at full width and MOE_TRAIN_DEPTH layers, bf16:
    fedlora_opt through run_federated under phase 7's stage checks
    (``run_checked``; 4 clients x 4 x 128 tokens, 1 round of 2 steps, 1
    stage-2 and 1 stage-3 step; the aux in every stage's loss); the
    card-vs-CPU gradient check at CHECK_DEPTH layers in f32; then the 4
    clients served as dora_mag tenants through ``ServeEngine``
    (``bgmv_mag``): at the drop-free capacity in f32 each tenant's
    tokens equal its merged model's greedy tokens; at the published
    capacity in bf16 two runs of the same requests give the same
    tokens.  Returns the report and the bgmv_mag launches."""
    from repro_torch.fed.simulate import FedHyper, client
    from repro_torch.launch.serve import greedy_generate, merge_adapters
    from repro_torch.serve import AdapterStore, ServeEngine
    from repro_torch.utils import pytree as pt
    cfg, params = dense_model(torch, MOE_QWEN, layers=MOE_TRAIN_DEPTH)
    report = {"grad_check": grad_check(torch, cfg, params)}
    free(torch)
    hp = FedHyper(**MOE_TRAIN_HP)
    C, B, S = hp.n_clients, hp.batch, hp.seq_len
    data = fed_data(cfg, C, B, S)
    res, sim, log, wall, peak = run_checked(torch, cfg, params, hp, data)
    step_ms = [1e3 * s for s in log["stage1_step"]]
    report.update({
        "config": dict(MOE_TRAIN_HP, layers=cfg.n_layers),
        "wall_s": wall, "peak_bytes": peak, "stage1_step_ms": step_ms,
        "stage_wall_s": {k: v for k, v in log.items() if k != "rounds"},
        "train_ce": [h["train_ce"] for h in res.history],
        "global_acc": res.global_acc, "local_acc": res.local_acc})
    print(f"moe training {MOE_QWEN} {cfg.n_layers} layers [{GPU}]: "
          + json.dumps(report))
    server = sim.server_model
    own = [client(sim.client_adapters, c) for c in range(C)]
    tenants = [f"client{c}" for c in range(C)]
    del res, sim
    free(torch)

    def store_of(tree, dt):
        st = AdapterStore(tree, cfg, n_slots=C, kind="dora_mag",
                          shared=pt.tree_map(lambda t: t.to(dt), server),
                          device="cuda")
        for t, ad in zip(tenants, own):
            st.register(t, pt.filter_tree(
                pt.tree_map(lambda x: x.to(dt), ad),
                lambda p: p.endswith("/dB_mag")))
        return st

    launches = 0
    # drop-free, f32: the pooled batch against each tenant's merged model
    cfg32 = dataclasses.replace(drop_free(cfg), dtype="float32")
    p32 = to_f32(params)
    store = store_of(p32, torch.float32)
    prompts = dense_tokens(torch, cfg, C, MOE_SERVE_PROMPT, seed=7).cpu(
        ).numpy().astype(np.int32)
    eng = ServeEngine(p32, cfg32, store, max_rows=C,
                      max_prompt_len=MOE_SERVE_PROMPT,
                      max_len=MOE_SERVE_PROMPT + MOE_NEW, decode_chunk=CHUNK,
                      device="cuda")
    reset_launches()
    outs, ms, _ = synced(torch, lambda: eng.generate(
        list(zip(tenants, prompts)), MOE_NEW))
    n = read_launches()
    st = eng.last_run
    check_launches(n, {"bgmv_mag": 2}, cfg.n_layers,
                   st["prefills"] + st["decode_steps"], "moe serve f32",
                   f"{st['prefills']} prefills + {st['decode_steps']} decode "
                   f"steps")
    launches += n["bgmv_mag"]
    for c, ad in enumerate(own):
        merged = greedy_generate(merge_adapters(p32, pt.tree_map(
            lambda t: t.float(), ad)), {"tokens": prompts[c:c + 1]}, cfg32,
            MOE_NEW, device="cuda")
        check(np.array_equal(outs[c], merged[0].cpu().numpy()),
              f"moe serve f32 drop-free: tenant {tenants[c]}'s {MOE_NEW} "
              f"tokens through ServeEngine (bgmv_mag) equal its merged "
              f"model's")
    report["serve_f32"] = {"tenants": C, "prompt": MOE_SERVE_PROMPT,
                           "new_tokens": MOE_NEW, "wall_ms": ms,
                           "capacity_factor": cfg32.capacity_factor}
    del eng, store, p32
    free(torch)
    # the published capacity, bf16: drops make a row depend on its batch,
    # so the check is that two runs of one request set agree
    store = store_of(params, torch.bfloat16)
    rng = np.random.default_rng(9)
    reqs = [(tenants[i % C] if i % 5 else None,
             rng.integers(0, cfg.vocab_size,
                          size=int(rng.integers(16, PAD_W + 1))
                          ).astype(np.int32)) for i in range(ROWS)]
    runs = []
    for _ in range(2):
        outs, st, n = serve(torch, engine(params, cfg, store), reqs,
                            "moe serve bf16", expect={"bgmv_mag": 2})
        launches += n["bgmv_mag"]
        runs.append(outs)
    check(all(np.array_equal(a, b) for a, b in zip(*runs)),
          f"moe serve bf16 at capacity {cfg.capacity_factor}: two runs of "
          f"{len(reqs)} requests give the same tokens")
    report["serve_bf16"] = engine_report("moe bf16", st, len(reqs),
                                         torch.cuda.max_memory_allocated())
    del store, params
    free(torch)
    print(f"moe serve {MOE_QWEN} [{GPU}]: " + json.dumps(
        {k: report[k] for k in ("serve_f32", "serve_bf16")}))
    return report, launches


def phase_moe(torch):
    """Phase 14.  Returns the report and the MoE path's launches of
    flash_attention ((a) and (c)'s timed prefills) and bgmv_mag ((d)'s
    serving)."""
    report, flash = {}, {}
    t0 = time.perf_counter()
    report[MOE_QWEN], flash[MOE_QWEN] = moe_generate(torch, MOE_QWEN)
    report["layer"] = moe_layer_check(torch)
    report[MOE_MIXTRAL], flash[MOE_MIXTRAL] = moe_generate(
        torch, MOE_MIXTRAL, layers=MIXTRAL_DEPTH)
    report["training"], n_mag = moe_training(torch)
    report["flash_launches"] = flash
    report["wall_s"] = time.perf_counter() - t0
    print(f"moe [{GPU}]: flash_attention launches on the MoE path "
          + json.dumps(flash) + f", bgmv_mag {n_mag}; phase wall "
          f"{report['wall_s']:.1f} s")
    return report, {"flash_attention": sum(flash.values()), "bgmv_mag": n_mag}


# --- phase 15: SSM and hybrid models (run after phase 14) ------------------

SSM_MAMBA, SSM_JAMBA = "mamba2-2.7b", "jamba-v0.1-52b"
SSM_NEW = 16            # greedy tokens after each long prefill
# jamba at full width: 16 of its 32 layers (two superblocks of 1 attention
# + 7 Mamba sublayers, 4 dense and 4 MoE FFNs each) are 52.0 GB in bf16;
# all 32 would be 102.9 GB
JAMBA_DEPTH = 16
SSM_TRAIN_DEPTH = 8     # mamba2 layers trained and served in (c)
SSM_TRAIN_HP = dict(method="fedlora_opt", n_clients=4, rounds=1,
                    local_steps=2, batch=4, seq_len=128, global_steps=1,
                    personal_steps=1)
SSM_SERVE_PROMPT = 200  # (c) and (d)'s prompts, padded to 256 in the scan
SSM_CACHE_TOL = 1e-4    # f32 prefill + decode cache vs one prefill's, of max
SSM_BUDGET_S = 90       # the phase's wall time


def mixer_counts(cfg):
    """{"attn": n, "ssm": n}: the sublayers of ``cfg``'s n_layers by mixer."""
    n_sb, tail, pattern = cfg.blocks_layout()
    subs = pattern * n_sb + pattern[:tail]
    return {m: sum(s.mixer == m for s in subs) for m in ("attn", "ssm")}


def ssd_within_bound(torch, label, params, cfg, tokens):
    """A bf16 prefill through ``forward`` (no cache): each SSM layer's
    ssd_scan call (the kernel branch of ``models/ssm._ssd``), on that
    layer's own padded inputs, elementwise within
    ``ssd_scan/ref.py::bf16_bound`` of the f32 scan of the same values and
    inside ``cast_point_interval``.  Returns the largest |err| / bound."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import (bf16_bound,
                                                  cast_point_interval)
    from repro_torch.models import model as M
    seen = []
    real = ops.ssd_scan

    def spy(x, dt, A_log, B, C, *, chunk, impl):
        y, st = real(x, dt, A_log, B, C, chunk=chunk, impl=impl)
        seen.append((x, dt, A_log, B, C, chunk, y))
        return y, st
    ops.ssd_scan = spy
    try:
        with torch.no_grad():
            M.forward(params, {"tokens": tokens}, cfg)
    finally:
        ops.ssd_scan = real
    worst = 0.0
    for i, (x, dt, A_log, B, C, Q, y) in enumerate(seen):
        ref, bound = bf16_bound(x, dt, A_log, B, C, Q)
        ratio = float(((y.float() - ref).abs() / bound).max())
        del ref, bound
        lo, hi = cast_point_interval(x, dt, A_log, B, C, Q)
        outside = int(((y < lo) | (y > hi)).sum())
        del lo, hi
        check(ratio <= 1.0 and outside == 0, f"{label}: ssd_scan call {i} "
              f"(x {tuple(x.shape)}, chunk {Q}) within bf16_bound (largest "
              f"|err| / bound {ratio:.3f}) and cast_point_interval "
              f"({outside} outside)")
        worst = max(worst, ratio)
    n = mixer_counts(cfg)["ssm"]
    check(len(seen) == n, f"{label}: one ssd_scan an SSM layer "
          f"({len(seen)} of {n})")
    return worst


def prefill_profile(torch, label, params, cfg, tokens, wall_ms, batch=None):
    """One prefill (``greedy_generate`` for 1 token, of ``tokens`` or of
    ``batch`` when given) under torch.profiler: the device's busy ms (its
    kernels' summed time) against ``wall_ms``, the same prefill's wall
    time without the profiler, and the ms of the ssd_scan,
    flash_attention and GEMM kernels and of the rest."""
    from repro_torch.launch.serve import greedy_generate

    def run():
        greedy_generate(params, batch or {"tokens": tokens}, cfg, 1,
                        device="cuda")
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    by_name, counts = profiled(run)
    busy = sum(by_name.values())

    def part(*keys):
        return sum(v for k, v in by_name.items()
                   if any(key in k.lower() for key in keys))
    out = {"device_busy_ms": busy, "wall_ms": wall_ms,
           "busy_share": busy / wall_ms, "kernels": sum(counts.values()),
           "ssd_scan_ms": part("ssd_"), "flash_attention_ms": part("flash_"),
           "gemm_ms": part("gemm", "xmma", "cutlass", "nvjet")}
    out["other_ms"] = busy - sum(out[k] for k in (
        "ssd_scan_ms", "flash_attention_ms", "gemm_ms"))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out["top_kernels_ms"] = {k[:80]: v for k, v in top}
    print(f"{label} prefill profile [{GPU}]: " + json.dumps(out))
    return out


def ssm_cache_check(torch, params, cfg, tokens):
    """The cache after a prefill of all tokens but the last and one decode
    step of it against one prefill of them all: the SSM state and conv
    states (and attention k / v) within SSM_CACHE_TOL of each leaf's max
    (the padded chunk of the shorter prefill, the in-place update)."""
    from repro_torch.models import model as M
    from repro_torch.utils import pytree as pt
    S = tokens.shape[1]
    with torch.no_grad():
        _, c1 = M.prefill(params, {"tokens": tokens[:, :-1]}, cfg,
                          cache_len=S)
        _, c1 = M.decode_step(params, tokens[:, -1], c1, S - 1, cfg)
        _, c2 = M.prefill(params, {"tokens": tokens}, cfg, cache_len=S)
    errs = {p: rel_err(pt.tree_get(c1, p), x)[0]
            for p, x in pt.tree_leaves_with_path(c2)}
    worst = max(errs, key=errs.get)
    check(errs[worst] <= SSM_CACHE_TOL, f"ssm {cfg.name} {cfg.n_layers} "
          f"layers f32: the cache of a {S - 1}-token prefill and a decode "
          f"step vs a {S}-token prefill's, {len(errs)} leaves within "
          f"{SSM_CACHE_TOL} of max (worst {worst}: {errs[worst]:.3e})")
    return {"worst": worst, "worst_rel_err": errs[worst],
            "leaves": len(errs)}


def ssm_generate(torch, arch, layers=None):
    """(a) / (b): ``arch`` at full width (``layers`` deep), bf16, a 1 x
    4096 prompt through ``greedy_generate``: ssd_scan once an SSM layer
    and flash_attention once an attention layer in each prefill, neither
    in a decode step; every ssd_scan (and flash_attention) output of the
    first CHECK_DEPTH layers within its bound on its own inputs; the
    kernels against the plain path (``kernel_impl="torch"``) through
    CHECK_DEPTH layers in bf16.  mamba2 then in f32 through all its
    layers: logits within LOGITS_F32_TOL, SSM_NEW greedy tokens equal,
    and the cache of a 4095-token prefill and a decode step against a
    4096-token prefill's.  Returns the report, the launches of the timed
    prefills, and the prompt."""
    from repro_torch.configs import get_config
    full = get_config(arch).n_layers
    if layers and layers < full:
        print(f"ssm {arch}: full width, depth cut to {layers} of {full} "
              f"layers ({full} do not fit the card)")
    cfg, params = dense_model(torch, arch, layers=layers)
    tokens = dense_tokens(torch, cfg, 1, DENSE_S, seed=8)
    n = mixer_counts(cfg)
    report, _ = dense_generate(
        torch, arch, params, cfg, tokens, SSM_NEW, family="ssm",
        per_prefill={"ssd_scan": n["ssm"], "flash_attention": n["attn"]})
    report["full_layers"] = full
    report["profile"] = prefill_profile(torch, f"ssm {arch}", params, cfg,
                                        tokens, report["prefill_ms"])
    cut, ccfg = first_layers(params, cfg, CHECK_DEPTH)
    label = f"ssm {arch} {CHECK_DEPTH} layers bf16"
    report["bf16_ssd_bound_ratio"] = ssd_within_bound(torch, label, cut,
                                                      ccfg, tokens)
    n_attn = mixer_counts(ccfg)["attn"]
    if n_attn:
        report["bf16_flash_bound_ratio"] = flash_within_bound(
            torch, label, cut, ccfg, tokens, n_attn=n_attn)
    kernels = "ssd_scan" + (" and flash_attention" if n["attn"] else "")
    report["bf16"] = flash_vs_plain(
        torch, f"{arch} {CHECK_DEPTH} layers bf16", cut, ccfg, tokens,
        TOL["bfloat16"], family="ssm", kernels=kernels)
    del cut
    if arch == SSM_MAMBA:
        p32 = to_f32(params)
        del params
        free(torch)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        report["f32"] = flash_vs_plain(
            torch, f"{arch} {cfg.n_layers} layers f32", p32, cfg32, tokens,
            LOGITS_F32_TOL, greedy=SSM_NEW, family="ssm", kernels=kernels)
        report["f32_cache"] = ssm_cache_check(torch, p32, cfg32, tokens)
        del p32
    else:
        del params
    free(torch)
    print(f"ssm {arch} checks [{GPU}]: " + json.dumps(
        {k: v for k, v in report.items() if k.startswith(("bf16", "f32"))}))
    return report, report["launches"], tokens


def ssm_training(torch):
    """(c) mamba2 at full width and SSM_TRAIN_DEPTH layers, bf16, adapters
    on x_proj / out_proj: the card-vs-CPU gradient check at CHECK_DEPTH
    layers in f32 (x_proj's and out_proj's B_mag drawn nonzero); then
    fedlora_opt through run_federated under phase 7's stage checks (4
    clients x 4 x 128 tokens, 1 round of 2 steps, 1 stage-2 and 1
    stage-3 step): under autograd the plain scan runs, so ssd_scan
    launches only in the eval forwards; then the 4 clients' merged
    models in f32 through greedy_generate (the kernel path), SSM_NEW
    tokens each equal to the plain path's.  Returns the report and the
    ssd_scan launches of the eval forwards and of the serving."""
    from repro_torch.fed.simulate import FedHyper, client
    from repro_torch.launch.serve import greedy_generate, merge_adapters
    from repro_torch.utils import pytree as pt
    cfg, params = dense_model(torch, SSM_MAMBA, layers=SSM_TRAIN_DEPTH)
    report = {"grad_check": grad_check(torch, cfg, params)}
    free(torch)
    hp = FedHyper(**SSM_TRAIN_HP)
    C, B, S = hp.n_clients, hp.batch, hp.seq_len
    data = fed_data(cfg, C, B, S)
    res, sim, log, wall, peak = run_checked(torch, cfg, params, hp, data,
                                            eval_kernels=("ssd_scan",))
    n_eval = log.get("eval_launches", {}).get("ssd_scan", 0)
    check(n_eval > 0 and n_eval % cfg.n_layers == 0, f"ssm training: the "
          f"eval forwards launch ssd_scan once a layer ({n_eval})")
    step_ms = [1e3 * s for s in log["stage1_step"]]
    report.update({
        "config": dict(SSM_TRAIN_HP, layers=cfg.n_layers),
        "wall_s": wall, "peak_bytes": peak, "stage1_step_ms": step_ms,
        "stage1_step_ms_warm": step_ms[-1],
        "eval_ssd_scan_launches": n_eval,
        "stage_launches": {k: v for k, v in log.items()
                           if k.endswith("_launches")},
        "stage_wall_s": {k: v for k, v in log.items()
                         if k != "rounds" and not k.endswith("_launches")},
        "train_ce": [h["train_ce"] for h in res.history]})
    print(f"ssm training {SSM_MAMBA} {cfg.n_layers} layers [{GPU}]: "
          + json.dumps(report))
    own = [pt.tree_map(lambda t: t.float(), client(sim.client_adapters, c))
           for c in range(C)]
    del res, sim
    p32 = to_f32(params)
    del params
    free(torch)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    prompts = dense_tokens(torch, cfg, C, SSM_SERVE_PROMPT, seed=9)
    n_serve, ms = 0, []
    for c, ad in enumerate(own):
        merged = merge_adapters(p32, ad)
        reset_launches()
        got, t, _ = synced(torch, lambda: greedy_generate(
            merged, {"tokens": prompts[c:c + 1]}, cfg32, SSM_NEW,
            device="cuda"))
        launches = read_launches()
        check_launches(launches, {"ssd_scan": cfg.n_layers}, 1, 1,
                       f"ssm serve client{c}", "1 prefill")
        n_serve += launches["ssd_scan"]
        ms.append(t)
        want = greedy_plain(torch, merged, cfg32, prompts[c:c + 1], SSM_NEW)
        check(torch.equal(got, want), f"ssm serve f32: client{c}'s merged "
              f"model's {SSM_NEW} tokens through ssd_scan equal the plain "
              f"path's")
    report["serve_f32"] = {"clients": C, "prompt": SSM_SERVE_PROMPT,
                           "new_tokens": SSM_NEW, "wall_ms": ms,
                           "ssd_scan_launches": n_serve}
    print(f"ssm serve {SSM_MAMBA} f32 [{GPU}]: "
          + json.dumps(report["serve_f32"]))
    del p32, own
    free(torch)
    return report, n_eval, n_serve


def jamba_f32(torch, tokens):
    """(b)'s f32 check and (d): jamba at 2 layers of full width in f32
    (sublayer 0 attention + dense, sublayer 1 Mamba + MoE): the 1 x 4096
    prefill's logits with the kernels against the plain path within
    LOGITS_F32_TOL and SSM_NEW greedy tokens equal; then, at the
    drop-free capacity (at 1.25 a row's MoE output depends on the rows
    beside it), two dora_mag tenants with random ΔB_M on q / v in an
    AdapterStore, served in one batch through greedy_generate with
    adapter_idx (bgmv_mag 2 targets x 1 attention layer x SSM_NEW
    passes), each row's tokens equal to its merged model's.  Returns the
    report and the launches of the pooled run."""
    from repro_torch.core.peft import add_lora
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.serve import AdapterStore
    from repro_torch.utils import pytree as pt
    cfg, params = dense_model(torch, SSM_JAMBA, layers=2, dtype="float32")
    report = {"f32_2_layers": flash_vs_plain(
        torch, f"{SSM_JAMBA} 2 layers f32", params, cfg, tokens,
        LOGITS_F32_TOL, greedy=SSM_NEW, family="ssm",
        kernels="ssd_scan and flash_attention")}
    cfg = drop_free(cfg)
    g = torch.Generator(device="cuda").manual_seed(11)
    shared = pt.tree_map_with_path(
        lambda p, x: x + 0.25 if p.endswith("/B_mag") else x,
        add_lora(params, cfg, g, decomposed=True))
    store = AdapterStore(params, cfg, n_slots=2, kind="dora_mag",
                         shared=shared, device="cuda")
    deltas = [pt.tree_map(lambda x: torch.randn(x.shape, generator=g,
                                                device="cuda"),
                          pt.filter_tree(shared,
                                         lambda p: p.endswith("/dB_mag")))
              for _ in range(2)]
    tenants = ["t0", "t1"]
    for t, d in zip(tenants, deltas):
        store.register(t, d)
    slots = torch.tensor([store.slot_of(t) for t in tenants], device="cuda")
    prompts = dense_tokens(torch, cfg, 2, SSM_SERVE_PROMPT, seed=12)
    pooled_params = pt.merge_trees(params, store.overlay())
    reset_launches()
    pooled, ms, _ = synced(torch, lambda: greedy_generate(
        pooled_params, {"tokens": prompts}, cfg, SSM_NEW, adapter_idx=slots,
        device="cuda"))
    launches = read_launches()
    n = mixer_counts(cfg)
    check_launches(launches, {"bgmv_mag": 2 * n["attn"] * SSM_NEW,
                              "ssd_scan": n["ssm"]}, 1, 1,
                   "ssm serve jamba tenants", f"1 prefill + {SSM_NEW - 1} "
                   f"decode steps; bgmv_mag 2 targets x {n['attn']} "
                   f"attention layer x {SSM_NEW} passes, ssd_scan "
                   f"{n['ssm']} in the prefill")
    for i, (t, d) in enumerate(zip(tenants, deltas)):
        merged = greedy_generate(
            pt.merge_trees(params, pt.merge_trees(shared, d)),
            {"tokens": prompts[i:i + 1]}, cfg, SSM_NEW, device="cuda")
        check(torch.equal(pooled[i:i + 1], merged), f"ssm serve jamba: "
              f"tenant {t}'s {SSM_NEW} tokens through bgmv_mag equal its "
              f"merged model's")
    report["serve"] = {"tenants": 2, "prompt": SSM_SERVE_PROMPT,
                       "new_tokens": SSM_NEW, "wall_ms": ms,
                       "capacity_factor": cfg.capacity_factor,
                       "launches": {k: v for k, v in launches.items() if v}}
    print(f"ssm jamba 2 layers f32 [{GPU}]: " + json.dumps(report))
    del params, pooled_params, store, shared
    free(torch)
    return report, launches


def phase_ssm(torch):
    """Phase 15.  Returns the report and the SSM path's launches of
    ssd_scan ((a) and (b)'s timed prefills, (c)'s eval forwards and
    serving, (d)'s pooled prefill), flash_attention ((b)'s timed
    prefills) and bgmv_mag ((d)'s pooled run)."""
    report, prefill = {}, {}
    t0 = time.perf_counter()
    report[SSM_MAMBA], prefill[SSM_MAMBA], _ = ssm_generate(torch, SSM_MAMBA)
    report[SSM_JAMBA], prefill[SSM_JAMBA], tokens = ssm_generate(
        torch, SSM_JAMBA, layers=JAMBA_DEPTH)
    report["training"], n_eval, n_serve = ssm_training(torch)
    report["jamba_f32"], served = jamba_f32(torch, tokens)
    ssd = {a: prefill[a].get("ssd_scan", 0) for a in prefill}
    ssd_other = {"training_eval": n_eval, "mamba2_serve": n_serve,
                 "jamba_serve": served["ssd_scan"]}
    flash = {a: prefill[a].get("flash_attention", 0) for a in prefill}
    report["launches"] = {"ssd_scan_prefill": ssd,
                          "ssd_scan_eval_and_serve": ssd_other,
                          "flash_attention": flash,
                          "bgmv_mag": served["bgmv_mag"]}
    report["wall_s"] = time.perf_counter() - t0
    print(f"ssm [{GPU}]: launches on the SSM path "
          + json.dumps(report["launches"]) + f"; phase wall "
          f"{report['wall_s']:.1f} s")
    return report, {"ssd_scan": sum(ssd.values()) + sum(ssd_other.values()),
                    "flash_attention": sum(flash.values()),
                    "bgmv_mag": served["bgmv_mag"]}


# --- phase 16: vision-language and encoder-decoder models (after 15) -------

MM_VL, MM_ENC = "qwen2-vl-2b", "seamless-m4t-large-v2"
MM_NEW = 16             # greedy tokens after each long prefill
MM_GRID = 32            # qwen2-vl's patches: a 32 x 32 grid at t = 0 ...
MM_TEXT = 3072          # ... then its tokens: 4096 rows in all
MM_FRAMES, MM_DEC = 4096, 2048   # seamless's encoder frames, decoder tokens
MM_TRAIN_DEPTH = 4      # layers in (c) (seamless: encoder and decoder each)
MM_TRAIN_HP = dict(method="fedlora_opt", n_clients=4, batch=2, seq_len=128,
                   local_steps=2, global_steps=1, personal_steps=1)
MM_TRAIN_FRONT = 128    # (c) and (d)'s patches / frames a row
MM_GRAD_FRONT = 32      # the grad check's patches / frames beside 64 tokens
MM_SERVE_DEPTH = 2      # (d)'s layers, f32
MM_SERVE_PROMPT = 64    # (d)'s tokens a row
MM_BUDGET_S = 90        # the phase's wall time


def mrope_positions(torch, B, F, S, grid):
    """Qwen2-VL-style (B, F + S, 3) (t, h, w) ids: F patches of a grid x
    F / grid image at t = 0 (h = i // grid, w = i % grid), then S text
    positions from ``grid`` on with all three components equal."""
    i = torch.arange(F, device="cuda")
    img = torch.stack([torch.zeros_like(i), i // grid, i % grid], -1)
    txt = (grid + torch.arange(S, device="cuda"))[:, None].expand(S, 3)
    return torch.cat([img, txt])[None].expand(B, F + S, 3).contiguous()


def mm_batch(torch, cfg, B, front, S, seed, positions=False):
    """B rows of ``front`` frontend embeddings (N(0, 1), f32: the model
    casts them) and S random tokens, with M-RoPE positions when asked."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                     device="cuda"),
             "frontend_emb": torch.randn((B, front, cfg.d_model),
                                         generator=g, device="cuda")}
    if positions:
        batch["positions"] = mrope_positions(torch, B, front, S, MM_GRID)
    return batch


def mm_rows(cfg, batch):
    """The rows a prefill's cache holds: F + S, or S for an
    encoder-decoder."""
    S = batch["tokens"].shape[1]
    return S if cfg.n_enc_layers else S + batch["frontend_emb"].shape[1]


def mm_last(torch, params, cfg, batch, impl):
    """The prefill's work through ``forward`` at ``impl`` (with the cache,
    MM_NEW slots of headroom); the last row's logits, f32."""
    from repro_torch.models import model as M
    h, _, _ = M.forward(params, batch, cfg, return_cache=True,
                        cache_len=mm_rows(cfg, batch) + MM_NEW,
                        kernel_impl=impl)
    return (h[:, -1] @ M._head_kernel(params, cfg).to(h.dtype)).float()


def mm_vs_plain(torch, label, params, cfg, batch, tol):
    err, _ = rel_err(mm_last(torch, params, cfg, batch, None),
                     mm_last(torch, params, cfg, batch, "torch"))
    check(err <= tol, f"mm {label}: prefill logits, flash_attention vs the "
          f"plain path: {err:.3e} <= {tol} of max |logit|")
    return {"logits_rel_err": err}


def mm_flash_per_prefill(cfg):
    """flash_attention launches a long prefill makes: one a decoder
    layer, and for an encoder-decoder one an encoder layer and two a
    decoder layer (self- and cross-attention)."""
    return (cfg.n_enc_layers + 2 * cfg.n_layers if cfg.n_enc_layers
            else cfg.n_layers)


def mm_generate(torch, arch, batch):
    """(a) / (b): ``arch`` at full width and depth, bf16, ``batch``
    through ``greedy_generate``, timed for 1 token and for MM_NEW after a
    warm-up: flash_attention mm_flash_per_prefill times in each prefill
    and never in a decode step; then the kernels against the plain path
    through CHECK_DEPTH layers in bf16 (each flash output within
    ``bf16_bound_bhsd``), and through every layer in f32; one prefill
    profiled.  Returns the report and the launches of the two timed
    runs."""
    from repro_torch.launch.serve import greedy_generate
    cfg, params = dense_model(torch, arch)
    greedy_generate(params, batch, cfg, 2, device="cuda")      # warm-up
    per = mm_flash_per_prefill(cfg)
    reset_launches()
    toks1, ms1, peak1 = synced(torch, lambda: greedy_generate(
        params, batch, cfg, 1, device="cuda"))
    toks, ms, peak = synced(torch, lambda: greedy_generate(
        params, batch, cfg, MM_NEW, device="cuda"))
    launches = read_launches()
    check_launches(launches, {"flash_attention": per}, 1, 2, f"mm {arch}",
                   "2 prefills of greedy_generate")
    toks = toks.cpu().numpy()
    check(toks.shape == (1, MM_NEW) and toks.min() >= 0
          and toks.max() < cfg.vocab_size
          and np.array_equal(toks[:, :1], toks1.cpu().numpy()),
          f"mm {arch}: {MM_NEW} greedy tokens in the vocabulary, the first "
          f"the 1-token run's")
    report = {"layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers,
              "frontend_rows": batch["frontend_emb"].shape[1],
              "tokens": batch["tokens"].shape[1],
              "prefill_ms": ms1, "generate_ms": ms, "new_tokens": MM_NEW,
              "decode_step_ms": (ms - ms1) / (MM_NEW - 1),
              "peak_bytes_above_params": max(peak, peak1),
              "allocated_bytes": torch.cuda.memory_allocated(),
              "flash_per_prefill": per,
              "launches": {k: v for k, v in launches.items() if v}}
    print(f"mm {arch} [{GPU}]: " + json.dumps(report))
    report["profile"] = prefill_profile(torch, f"mm {arch}", params, cfg,
                                        None, ms1, batch=batch)
    cut, ccfg = first_layers(params, cfg, CHECK_DEPTH)
    label = f"{arch} {CHECK_DEPTH} layers bf16"
    report["bf16_flash_bound_ratio"] = flash_within_bound(
        torch, f"mm {label}", cut, ccfg, None,
        n_attn=mm_flash_per_prefill(ccfg), batch=batch)
    report["bf16"] = mm_vs_plain(torch, label, cut, ccfg, batch,
                                 TOL["bfloat16"])
    del cut
    p32 = to_f32(params)
    del params
    free(torch)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    report["f32"] = mm_vs_plain(torch, f"{arch} {cfg.n_layers} layers f32",
                                p32, cfg32, batch, LOGITS_F32_TOL)
    if cfg.n_enc_layers:
        report["f32"]["decode_vs_forward"] = mm_decode_check(torch, p32,
                                                             cfg32, batch)
    del p32
    free(torch)
    print(f"mm {arch} checks [{GPU}]: " + json.dumps(
        {k: v for k, v in report.items() if k.startswith(("bf16", "f32"))}))
    return report, launches


def mm_decode_check(torch, params, cfg, batch):
    """An encoder-decoder in f32: a decode step of the last token, with
    the encoder's output, after a prefill of the rest, against the full
    forward's last row within LOGITS_F32_TOL of max |logit| (the check
    the reference's greedy_generate, which drops enc_out, would fail)."""
    from repro_torch.models import model as M
    S = batch["tokens"].shape[1]
    with torch.no_grad():
        enc = M._encode(params, batch["frontend_emb"], cfg)
        _, cache = M.prefill(params, dict(batch, tokens=batch["tokens"][
            :, :-1]), cfg, cache_len=S, enc_out=enc)
        dlog, _ = M.decode_step(params, batch["tokens"][:, -1], cache, S - 1,
                                cfg, enc_out=enc)
        del cache, enc
        full = mm_last(torch, params, cfg, batch, None)
    err, _ = rel_err(dlog, full)
    check(err <= LOGITS_F32_TOL, f"mm {cfg.name} f32: a decode step with "
          f"enc_out after {S - 1} tokens vs the {S}-token forward's last "
          f"row: {err:.3e} <= {LOGITS_F32_TOL} of max |logit|")
    return err


def mm_training(torch, arch):
    """(c) ``arch`` at full width and MM_TRAIN_DEPTH layers (seamless:
    MM_TRAIN_DEPTH + MM_TRAIN_DEPTH), f32: the card-vs-CPU gradient check
    at CHECK_DEPTH layers (frontend_emb in its batch); then one
    fedlora_opt pipeline round through FedSim (4 clients x 2 rows of
    MM_TRAIN_FRONT frontend rows + 128 tokens, 2 stage-1 steps, 1
    stage-2 and 1 stage-3 step), each stage timed and synced, with no
    kernel launch anywhere (under autograd the plain paths run, and no
    row reaches the chunked length): every stage moves its leaves
    (seamless: the encoder's in stage 1).  Returns the report, the
    server model, the clients' adapters, the backbone and the config."""
    from repro_torch.fed.simulate import FedHyper, FedSim
    from repro_torch.utils import pytree as pt
    cfg, params = dense_model(torch, arch, layers=MM_TRAIN_DEPTH,
                           dtype="float32")
    extra = {"frontend_emb": np.random.default_rng(3).normal(
        size=(1, MM_GRAD_FRONT, cfg.d_model)).astype(np.float32)}
    report = {"grad_check": grad_check(torch, cfg, params, extra=extra)}
    free(torch)
    hp = FedHyper(**MM_TRAIN_HP)
    C, B, S = hp.n_clients, hp.batch, hp.seq_len
    sim = FedSim(cfg, hp, base=params, device="cuda")
    seeds = iter(range(100, 200))

    def batch(lead):
        g = torch.Generator(device="cuda").manual_seed(next(seeds))
        return {"tokens": torch.randint(0, cfg.vocab_size, (*lead, S),
                                        generator=g, device="cuda"),
                "loss_mask": torch.ones((*lead, S), device="cuda"),
                "frontend_emb": torch.randn(
                    (*lead, MM_TRAIN_FRONT, cfg.d_model), generator=g,
                    device="cuda")}

    def leaves(rx):
        return {p: x.clone() for p, x in
                pt.tree_leaves_with_path(sim.client_adapters)
                if re.search(rx, p)}

    def moved(before, what):
        n = sum(not torch.equal(x, pt.tree_get(sim.client_adapters, p))
                for p, x in before.items())
        check(before and n == len(before), f"mm training {arch}: {what} "
              f"moved all {len(before)} leaves ({n})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    walls, step_ms, ce = {}, [], []
    enc_rx = r"^encoder/" if cfg.n_enc_layers else r"/A_dir$"
    stage1 = leaves(r"/(A_mag|A_dir|B_dir|B_mag)$")
    enc_before = leaves(enc_rx + (r".*/A_dir$" if cfg.n_enc_layers else ""))
    for _ in range(hp.local_steps):
        b = batch((C, B))
        met, ms, _ = synced(torch, lambda: sim.local_round([b]))
        step_ms.append(ms)
        ce.append(float(np.mean(met["ce"])))
    moved(stage1, "stage 1")
    moved(enc_before, "stage 1 (the encoder's A_dir)" if cfg.n_enc_layers
          else "stage 1 (A_dir)")
    agg, walls["aggregate_ms"], _ = synced(torch, sim.aggregate)
    d_a = leaves(r"/dA_dir$")
    server, walls["stage2_ms"], _ = synced(torch, lambda: sim.global_stage(
        agg, [batch((B * C,))]))
    moved(d_a, "stage 2 (dA_dir)")
    d_b = leaves(r"/dB_mag$")
    _, walls["stage3_ms"], _ = synced(torch, lambda: sim.personalize(
        [batch((C, B))]))
    moved(d_b, "stage 3 (dB_mag)")
    launches = read_launches()
    check(not any(launches.values()), f"mm training {arch}: no kernel "
          f"launched in the pipeline round ({launches})")
    check(all(np.isfinite(ce)), f"mm training {arch}: finite stage-1 CE")
    report.update({
        "config": dict(MM_TRAIN_HP, layers=cfg.n_layers,
                       enc_layers=cfg.n_enc_layers, front=MM_TRAIN_FRONT),
        "stage1_step_ms": step_ms, "stage1_step_ms_warm": step_ms[-1],
        "stage_ms": walls, "train_ce": ce,
        "peak_bytes": torch.cuda.max_memory_allocated()})
    print(f"mm training {arch} {cfg.n_layers} layers [{GPU}]: "
          + json.dumps(report))
    own = [pt.filter_tree(pt.tree_map(lambda t: t[c], sim.client_adapters),
                          lambda p: p.endswith("/dB_mag")) for c in range(C)]
    del sim
    free(torch)
    return report, server, own, params, cfg


def mm_serving(torch, arch, server, own, params, cfg):
    """(d) the first MM_SERVE_DEPTH layers of (c)'s model and adapters,
    f32.  qwen2-vl: 2 tenants (clients 0 and 1's ΔB_M over the server
    model) in a dora_mag AdapterStore, one batch of 2 rows (each its own
    MM_TRAIN_FRONT patches, MM_SERVE_PROMPT tokens, M-RoPE positions)
    through greedy_generate with adapter_idx: bgmv_mag 2 targets x
    MM_SERVE_DEPTH layers x MM_NEW passes, each row's tokens equal to
    its tenant's merged model's.  seamless: the pooled tree is refused
    (ValueError: its encoder takes no per-row adapters), and tenant 0 is
    served merged.  Returns the report and the bgmv_mag launches."""
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.serve import AdapterStore
    from repro_torch.utils import pytree as pt
    p2, cfg2 = first_layers(params, cfg, MM_SERVE_DEPTH)
    shared = pt.tree_map(lambda t: t[:MM_SERVE_DEPTH], server)
    deltas = [pt.tree_map(lambda t: t[:MM_SERVE_DEPTH], d) for d in own[:2]]
    store = AdapterStore(p2, cfg2, n_slots=2, kind="dora_mag", shared=shared,
                         device="cuda")
    tenants = ["t0", "t1"]
    for t, d in zip(tenants, deltas):
        store.register(t, d)
    slots = torch.tensor([store.slot_of(t) for t in tenants], device="cuda")
    prompts = mm_batch(torch, cfg2, 2, MM_TRAIN_FRONT, MM_SERVE_PROMPT,
                       seed=21, positions=bool(cfg.mrope))
    pooled_params = pt.merge_trees(p2, store.overlay())
    report = {"layers": MM_SERVE_DEPTH, "prompt": MM_SERVE_PROMPT,
              "front": MM_TRAIN_FRONT, "new_tokens": MM_NEW}
    if cfg.n_enc_layers:
        try:
            greedy_generate(pooled_params, prompts, cfg2, 2,
                            adapter_idx=slots, device="cuda")
            refused = ""
        except ValueError as e:
            refused = str(e)
        check("encoder carries pooled" in refused, f"mm serve {arch}: "
              f"pooled leaves on the encoder are refused ({refused!r})")
        row = {k: v[:1] for k, v in prompts.items()}
        toks, ms, _ = synced(torch, lambda: greedy_generate(
            pt.merge_trees(p2, pt.merge_trees(shared, deltas[0])), row, cfg2,
            MM_NEW, device="cuda"))
        check(toks.shape == (1, MM_NEW), f"mm serve {arch}: tenant t0 "
              f"served merged")
        report.update({"pooled_refused": True, "merged_wall_ms": ms})
        n = 0
    else:
        reset_launches()
        pooled, ms, _ = synced(torch, lambda: greedy_generate(
            pooled_params, prompts, cfg2, MM_NEW, adapter_idx=slots,
            device="cuda"))
        launches = read_launches()
        check_launches(launches, {"bgmv_mag": 2}, MM_SERVE_DEPTH, MM_NEW,
                       f"mm serve {arch} tenants", f"1 prefill + "
                       f"{MM_NEW - 1} decode steps, 2 targets a layer")
        n = launches["bgmv_mag"]
        for i, (t, d) in enumerate(zip(tenants, deltas)):
            row = {k: v[i:i + 1] for k, v in prompts.items()}
            merged = greedy_generate(
                pt.merge_trees(p2, pt.merge_trees(shared, d)), row, cfg2,
                MM_NEW, device="cuda")
            check(torch.equal(pooled[i:i + 1], merged), f"mm serve {arch}: "
                  f"tenant {t}'s {MM_NEW} tokens through bgmv_mag equal its "
                  f"merged model's")
        report.update({"tenants": 2, "pooled_wall_ms": ms,
                       "bgmv_mag_launches": n})
    print(f"mm serve {arch} f32 [{GPU}]: " + json.dumps(report))
    del store, pooled_params, p2
    free(torch)
    return report, n


def phase_mm(torch):
    """Phase 16.  Returns the report and the launches of flash_attention
    ((a) and (b)'s timed prefills) and bgmv_mag ((d)'s pooled run)."""
    report, prefill = {}, {}
    t0 = time.perf_counter()
    from repro_torch.configs import get_config
    vl, enc = get_config(MM_VL), get_config(MM_ENC)
    report[MM_VL], prefill[MM_VL] = mm_generate(torch, MM_VL, mm_batch(
        torch, vl, 1, vl.frontend_tokens, MM_TEXT, seed=14, positions=True))
    report[MM_ENC], prefill[MM_ENC] = mm_generate(torch, MM_ENC, mm_batch(
        torch, enc, 1, MM_FRAMES, MM_DEC, seed=15))
    n_mag = 0
    for arch in (MM_VL, MM_ENC):
        tr, server, own, params, cfg = mm_training(torch, arch)
        sv, n = mm_serving(torch, arch, server, own, params, cfg)
        report[f"training {arch}"], report[f"serve {arch}"] = tr, sv
        n_mag += n
        del server, own, params
        free(torch)
    flash = {a: prefill[a].get("flash_attention", 0) for a in prefill}
    report["launches"] = {"flash_attention": flash, "bgmv_mag": n_mag}
    report["wall_s"] = time.perf_counter() - t0
    print(f"mm [{GPU}]: launches on the multimodal path "
          + json.dumps(report["launches"]) + f"; phase wall "
          f"{report['wall_s']:.1f} s")
    return report, {"flash_attention": sum(flash.values()),
                    "bgmv_mag": n_mag}


# --- phase 17: pretraining, the analytic account and the examples ----------

TOOLING_ARCH = "llama2-7b"
PRETRAIN_DEPTH = 8      # llama2-7b layers in (a): full-parameter AdamW
PRETRAIN_STEPS = 10     # (a)'s steps at the reference's defaults
PRETRAIN_BATCH, PRETRAIN_SEQ, PRETRAIN_LR = 32, 48, 3e-3
PRETRAIN_GRAD_ROWS = 2  # (b)'s batch, 1 layer of full width in f32
E2E_PROFILE, E2E_STEPS, E2E_ROUNDS = "100m", 50, 2   # (c) and (d)
TOOLING_BUDGET_S = 90   # the phase's wall time


def pretrain_full_width(torch):
    """(a) ``pretrain_base`` at llama2-7b's width, PRETRAIN_DEPTH layers,
    bf16, the reference's batch and lr, PRETRAIN_STEPS steps; each step
    timed on the host clock around a sync (``fed.pretrain._train_step``
    wrapped for the run), the last under torch.profiler instead (device
    busy ms, the GEMMs' share, the top kernels).  The analytic account of its meta tree against
    the real tree; achieved TFLOP/s from ``analytic_step_flops``."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.data import (SyntheticInstructionDataset,
                                  make_dataset_family)
    from repro_torch.fed import pretrain as pre
    from repro_torch.launch import analysis
    from repro_torch.launch.specs import abstract_params
    from repro_torch.utils import pytree as pt
    cfg = dataclasses.replace(get_config(TOOLING_ARCH),
                              n_layers=PRETRAIN_DEPTH, lora_dropout=0.0)
    fam = make_dataset_family("dolly", vocab_size=cfg.vocab_size)
    mix = SyntheticInstructionDataset(fam, [1 / 3, 1 / 3, 1 / 3, 0],
                                      client_seed=0)
    steps, losses, prof = [], [], {}
    inner = pre._train_step

    def timed(*a):
        torch.cuda.synchronize()
        if len(losses) == PRETRAIN_STEPS - 1:      # the last step, profiled
            held = []
            prof["by_name"], _ = profiled(lambda: held.append(inner(*a)),
                                          cpu=False)
            out = held[0]
        else:
            t0 = time.perf_counter()
            out = inner(*a)
            torch.cuda.synchronize()
            steps.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(out[2]["ce"]))
        return out
    log = []
    free(torch)
    torch.cuda.reset_peak_memory_stats()
    pre._train_step = timed
    try:
        t0 = time.perf_counter()
        params = pre.pretrain_base(cfg, mix, steps=PRETRAIN_STEPS,
                                   batch=PRETRAIN_BATCH, seq_len=PRETRAIN_SEQ,
                                   lr=PRETRAIN_LR, seed=0, log=log.append,
                                   device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        pre._train_step = inner
    peak = torch.cuda.max_memory_allocated()
    check(len(losses) == PRETRAIN_STEPS and all(map(math.isfinite, losses)),
          f"pretrain {TOOLING_ARCH} x {PRETRAIN_DEPTH} layers: "
          f"{PRETRAIN_STEPS} finite losses ({losses})")
    check(bool(pt.tree_all_finite(params)), "pretrain: every leaf finite")
    meta = abstract_params(cfg)
    counts = analysis.param_counts(cfg, meta)
    real = (pt.tree_count_params(params), pt.tree_bytes(params))
    check((counts["n_params"], pt.tree_bytes(meta)) == real,
          f"pretrain: the abstract tree's {counts['n_params']} parameters "
          f"and {pt.tree_bytes(meta)} bytes equal the real tree's {real}")
    shape = InputShape("pretrain", PRETRAIN_SEQ, PRETRAIN_BATCH, "train")
    flops = analysis.analytic_step_flops(cfg, shape)["flops_global"]
    warm = statistics.median(steps[1:])
    tokens = PRETRAIN_BATCH * PRETRAIN_SEQ
    busy = sum(prof["by_name"].values())
    gemm = sum(v for k, v in prof["by_name"].items()
               if re.search(r"gemm|xmma|nvjet|cutlass", k, re.I))
    top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:6]
    report = {
        "layers": cfg.n_layers, "dtype": cfg.dtype, "n_params": real[0],
        "param_bytes": real[1], "steps": PRETRAIN_STEPS,
        "batch": [PRETRAIN_BATCH, PRETRAIN_SEQ], "lr": PRETRAIN_LR,
        "losses": losses, "step_ms": steps, "warm_step_ms_median": warm,
        "profiled_step": {"device_busy_ms": busy, "gemm_ms": gemm,
                          "other_ms": busy - gemm,
                          "top_kernels_ms": {k[:80]: v for k, v in top}},
        "tokens_per_s": tokens / (warm / 1e3), "wall_s": wall,
        "peak_bytes": peak, "log": log,
        "analytic_step_flops": flops,
        "achieved_tflops": flops / (warm / 1e3) / 1e12,
        "share_of_989_tflops": flops / (warm / 1e3) / analysis.PEAK_FLOPS,
        "note": "the analytic train count is 3 forward passes; a "
                "full-parameter backward (input and weight gradients) is "
                "about 2 forward passes, so 3 is this step's count too"}
    print(f"tooling pretrain [{GPU}]: " + json.dumps(report))
    del params, meta
    free(torch)
    return report


def pretrain_grad_check(torch):
    """(b) One full-parameter gradient on the card against the CPU's: 1
    layer of llama2-7b width in f32, PRETRAIN_GRAD_ROWS x PRETRAIN_SEQ
    tokens of the dolly mix, every backbone leaf within GRAD_TOL of the
    leaf's max |g| on the CPU, through the loss and gradient
    ``pretrain_base`` takes (``fed.simulate.value_and_grad`` of
    ``loss_and_metrics``).  The embedding's backward sums rows with
    atomics on the card, so no bit equality is asked."""
    from repro_torch.configs import get_config
    from repro_torch.data import (SyntheticInstructionDataset,
                                  make_dataset_family, to_device)
    from repro_torch.fed.simulate import value_and_grad
    from repro_torch.models import model as M
    from repro_torch.utils import pytree as pt
    cfg = dataclasses.replace(get_config(TOOLING_ARCH), n_layers=1,
                              dtype="float32", lora_dropout=0.0)
    params = M.init_params(torch.Generator(device="cuda").manual_seed(5),
                           cfg, device="cuda")
    fam = make_dataset_family("dolly", vocab_size=cfg.vocab_size)
    mix = SyntheticInstructionDataset(fam, [1 / 3, 1 / 3, 1 / 3, 0],
                                      client_seed=0)
    batch = mix.sample_batch(np.random.default_rng(3), PRETRAIN_GRAD_ROWS,
                             PRETRAIN_SEQ)
    out = {}
    for dev in ("cuda", "cpu"):
        p = params if dev == "cuda" else pt.tree_map(lambda t: t.cpu(),
                                                     params)
        b = to_device(batch, dev)
        out[dev] = value_and_grad(lambda q: M.loss_and_metrics(q, b, cfg), p)
    (l_gpu, _, g_gpu), (l_cpu, _, g_cpu) = out["cuda"], out["cpu"]
    errs = {}
    for p, want in pt.tree_leaves_with_path(g_cpu):
        scale = float(want.abs().max())
        check(scale > 0, f"pretrain grad check: {p} has a nonzero gradient")
        errs[p] = float((pt.tree_get(g_gpu, p).cpu() - want).abs().max()
                        / scale)
    worst = max(errs, key=errs.get)
    loss_err = abs(float(l_gpu) - float(l_cpu)) / abs(float(l_cpu))
    check(errs[worst] <= GRAD_TOL and loss_err <= 1e-5,
          f"pretrain grad check, 1 layer of {TOOLING_ARCH} width f32, "
          f"{PRETRAIN_GRAD_ROWS} x {PRETRAIN_SEQ} tokens: {len(errs)} "
          f"backbone gradients on the card within {GRAD_TOL} of the CPU's "
          f"(worst {worst}: {errs[worst]:.3e}), loss within 1e-5 "
          f"({loss_err:.2e})")
    report = {"leaves": len(errs), "worst": worst, "worst_err": errs[worst],
              "loss": float(l_gpu), "loss_err": loss_err}
    print("tooling grad check: " + json.dumps(report))
    del params, out, g_gpu, g_cpu
    free(torch)
    return report


def pretrain_cache(torch, workdir):
    """(c) ``get_pretrained_base`` at the e2e E2E_PROFILE profile for
    E2E_STEPS steps with REPRO_CACHE in ``workdir``: the first call trains
    (one ``pretrain_base`` call) and writes the file, the second restores
    it, every leaf bit for bit, without training."""
    from repro_torch.data import (SyntheticInstructionDataset,
                                  make_dataset_family)
    from repro_torch.examples.fed_finetune_e2e import PROFILES
    from repro_torch.fed import pretrain as pre
    from repro_torch.utils import pytree as pt
    cfg = PROFILES[E2E_PROFILE]
    fam = make_dataset_family("dolly", vocab_size=cfg.vocab_size)
    mix = SyntheticInstructionDataset(fam, [1 / 3, 1 / 3, 1 / 3, 0],
                                      client_seed=0)
    calls = []
    inner = pre.pretrain_base

    def counted(*a, **k):
        calls.append(1)
        return inner(*a, **k)
    old = os.environ.get("REPRO_CACHE")
    os.environ["REPRO_CACHE"] = str(workdir / "cache")
    pre.pretrain_base = counted
    try:
        path = pre.cache_path(cfg, E2E_STEPS, 0, fam.name)
        check(not os.path.exists(path), f"tooling cache: {path} is new")
        log = []
        first, ms_train, _ = synced(torch, lambda: pre.get_pretrained_base(
            cfg, mix, steps=E2E_STEPS, log=log.append, device="cuda"))
        check(len(calls) == 1 and os.path.isfile(path),
              f"tooling cache: the first call trained once ({len(calls)}) "
              f"and wrote {path}")
        second, ms_restore, _ = synced(torch, lambda: pre.get_pretrained_base(
            cfg, mix, steps=E2E_STEPS, log=log.append, device="cuda"))
        check(len(calls) == 1 and log[-1] == f"restored pretrained base "
              f"from {path}", "tooling cache: the second call restored the "
              "file without training")
    finally:
        pre.pretrain_base = inner
        if old is None:
            os.environ.pop("REPRO_CACHE")
        else:
            os.environ["REPRO_CACHE"] = old
    same_leaves(torch, second, first, f"tooling cache {E2E_PROFILE}")
    check(all(x.device.type == "cuda" for x in pt.tree_leaves(second)),
          "tooling cache: the restored base is on the card")
    report = {"profile": E2E_PROFILE, "steps": E2E_STEPS,
              "n_params": pt.tree_count_params(first),
              "file_bytes": os.path.getsize(path),
              "train_ms": ms_train, "restore_ms": ms_restore, "log": log}
    print(f"tooling cache [{GPU}]: " + json.dumps(report))
    del first, second
    free(torch)
    return report


def e2e_example(torch, workdir):
    """(d) ``python -m repro_torch.examples.fed_finetune_e2e`` as a user
    runs it, in ``workdir`` with (c)'s cache: it restores (c)'s base,
    federates E2E_ROUNDS rounds, prints accuracies in [0, 1] and writes
    its history file."""
    env = dict(os.environ, REPRO_CACHE=str(workdir / "cache"),
               PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.examples.fed_finetune_e2e",
           "--profile", E2E_PROFILE, "--rounds", str(E2E_ROUNDS),
           "--pretrain-steps", str(E2E_STEPS)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=workdir, env=env, capture_output=True,
                          text=True, timeout=TOOLING_BUDGET_S)
    wall = time.perf_counter() - t0
    print(f"--- {' '.join(cmd[1:])} (exit {proc.returncode}, {wall:.1f} s)"
          f" ---\n{proc.stdout.strip()}\n{proc.stderr.strip()[-2000:]}")
    check(proc.returncode == 0, f"e2e example exited {proc.returncode}")
    out = proc.stdout
    check("restored pretrained base from" in out,
          "e2e example: restored (c)'s pretrained base")
    accs = {k: float(re.search(rf"{k} acc : ([0-9.]+)", out).group(1))
            for k in ("global model", "personalized")}
    check(all(0.0 <= a <= 1.0 for a in accs.values()),
          f"e2e example: accuracies in [0, 1] ({accs})")
    hist = workdir / "experiments" / f"e2e_{E2E_PROFILE}.msgpack"
    check(hist.is_file(), f"e2e example: wrote {hist}")
    report = {"wall_s": wall, "accuracies": accs,
              "history_bytes": hist.stat().st_size}
    print(f"tooling e2e example [{GPU}]: " + json.dumps(report))
    return report


def serve_example(torch):
    """(e) ``examples.serve_personalized.main`` in this process on the
    card, every count at 0 before it: its own mixed = merged assertion,
    and bgmv_mag launched 2 targets x its layers x (prefill and decode
    forwards of its two ``generate`` calls) times: each call admits its
    N_TENANTS requests into one N_TENANTS-row prefill and decodes the
    N_NEW - 1 remaining tokens in one chunk of CHUNK steps; the merged
    path (``greedy_generate`` per tenant) launches no kernel."""
    from repro_torch.examples import serve_personalized as sp
    per_call = (math.ceil(sp.N_TENANTS / sp.N_TENANTS)
                + math.ceil((sp.N_NEW - 1) / sp.CHUNK) * sp.CHUNK)
    torch.cuda.synchronize()
    reset_launches()
    res = sp.main([])
    launches = read_launches()
    st = res["last_run"]
    check(st["prefills"] + st["decode_steps"] == per_call,
          f"serve example: {st['prefills']} prefill + {st['decode_steps']} "
          f"decode forwards a generate call = {per_call}")
    check_launches(launches, {"bgmv_mag": 2}, sp.CFG.n_layers, 2 * per_call,
                   "serve example", f"2 generate calls x {per_call} forwards")
    report = {"mixed_tokens_per_s": res["mixed_tokens_per_s"],
              "merged_tokens_per_s": res["merged_tokens_per_s"],
              "forwards_per_generate": per_call,
              "bgmv_mag": launches["bgmv_mag"]}
    print(f"tooling serve example [{GPU}]: " + json.dumps(report))
    return report, launches["bgmv_mag"]


def phase_tooling(torch, workdir):
    """Phase 17.  Returns the report and bgmv_mag's launches in (e)."""
    t0 = time.perf_counter()
    report = {"pretrain": pretrain_full_width(torch),
              "grad_check": pretrain_grad_check(torch),
              "cache": pretrain_cache(torch, workdir),
              "e2e_example": e2e_example(torch, workdir)}
    report["serve_example"], n = serve_example(torch)
    report["wall_s"] = time.perf_counter() - t0
    print(f"tooling [{GPU}]: phase wall {report['wall_s']:.1f} s")
    return report, n


# --- phase 18: the one-card dry run against the card (after phase 17) -----

DRY_ARCHS = ("llama2-7b", "mamba2-2.7b")   # (c): every shape they support
DRY_ROUND = 512         # the CUDA caching allocator's rounding, bytes
DRY_STEP_TOL = 0.05     # a step's allocation against its account ...
DRY_STEP_FLOOR = 64 << 20   # ... or this many bytes, the larger
DRY_ARG_TOL = 1e-3      # the inputs' allocation against argument_bytes
DRYRUN_BUDGET_S = 60    # the phase's wall time
DRY_RECORDS_WAIT_S = 300    # the most (c) may still wait for its records
# (b): label, arch, layers, (seq, batch, kind), launches of the path
DRY_STEPS = (
    ("llama2-7b prefill", "llama2-7b", 32, (4096, 1, "prefill"),
     {"flash_attention": 32}),
    ("llama2-7b decode", "llama2-7b", 32, (4096, 8, "decode"), {}),
    ("llama2-7b fedlora_opt stage-1 step", "llama2-7b", 8,
     (1024, 4, "train"), {}),
    ("mamba2-2.7b prefill", "mamba2-2.7b", 64, (4096, 1, "prefill"),
     {"ssd_scan": 64}))


def start_dry_records(workdir):
    """(c)'s full-width records, traced by ``launch.dryrun`` on meta
    tensors in one background process with no card visible (one thread),
    started after phase 2 so that its CPU minutes overlap the card's
    phases: the train_4k accounts run 7 micro-batches of a 32- or
    64-layer model through autograd on meta, 1-2 minutes of one core."""
    code = ("from repro_torch.configs import SHAPES, shape_supported\n"
            "from repro_torch.launch import dryrun\n"
            f"for a in {DRY_ARCHS!r}:\n"
            "    for s in SHAPES:\n"
            "        if shape_supported(a, s):\n"
            f"            dryrun.main(['--arch', a, '--shape', s, '--out', "
            f"{str(workdir)!r}])\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def alloc_growth(torch, fn):
    """(fn()'s result, the growth of max_memory_allocated across it)."""
    free(torch)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def dry_kernels(torch):
    """(a) Each kernel's meta branch against the card's allocator, at the
    shape of its phase-2 row: the tally of the meta call (each storage
    rounded up to DRY_ROUND bytes) equals the growth of
    max_memory_allocated across the real call, and the outputs' shapes
    and dtypes are the meta outputs'."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.ssd_scan import ssd_scan as SSD
    from repro_torch.launch.dryrun import StorageTally
    bf16, f32 = torch.bfloat16, torch.float32
    g = torch.Generator(device="cuda").manual_seed(18)

    def inputs(dev, specs):
        return [torch.randn(s, dtype=d, device=dev, generator=g)
                if dev == "cuda" else torch.empty(s, dtype=d, device=dev)
                for s, d in specs]
    H, S, dh = LLAMA2_7B["H"], 4096, LLAMA2_7B["dh"]
    BH, P, N, Q = (MAMBA2_2_7B[k] for k in ("H", "P", "N", "chunk"))
    cases = (
        ("flash_attention", "llama2-7b prefill q, k, v (32, 4096, 128) bf16, "
         "causal", [((H, S, dh), bf16)] * 3,
         lambda q, k, v: FA.flash_attention_bhsd_cuda(
             q, k, v, scale=dh ** -0.5, causal=True)),
        ("ssd_scan", "mamba2-2.7b 1 x 4096: x (80, 4096, 64) bf16, B, C "
         "(1, 4096, 128), chunk 128",
         [((BH, S, P), bf16), ((BH, S), f32), ((BH,), f32),
          ((1, S, N), bf16), ((1, S, N), bf16)],
         lambda *a: SSD.ssd_scan_bh_cuda(*a, chunk=Q)))
    report = {}
    for name, shape, specs, call in cases:
        meta = inputs("meta", specs)
        with StorageTally(round_to=DRY_ROUND) as tally:
            out_m = call(*meta)
        real = inputs("cuda", specs)
        out_c, growth = alloc_growth(torch, lambda: call(*real))
        outs = [out_m] if torch.is_tensor(out_m) else list(out_m)
        outc = [out_c] if torch.is_tensor(out_c) else list(out_c)
        check([(tuple(t.shape), t.dtype) for t in outs]
              == [(tuple(t.shape), t.dtype) for t in outc],
              f"dry run (a) {name}: the meta branch's outputs have the "
              f"card's shapes and dtypes")
        check(tally.peak == growth,
              f"dry run (a) {name} [{shape}]: the meta branch allocates "
              f"{tally.peak} bytes ({DRY_ROUND}-byte rounding), the card's "
              f"max_memory_allocated grew {growth}")
        report[name] = {"shape": shape, "meta_tally_bytes": tally.peak,
                        "card_growth_bytes": growth}
        del real, out_c, outc
    free(torch)
    return report


def requested(torch, stat="current"):
    """The caching allocator's requested bytes (the sizes asked for,
    before its rounding and unsplit blocks)."""
    return torch.cuda.memory_stats()[f"requested_bytes.all.{stat}"]


def finite_out(torch, kind, out):
    """A step's result is finite: the logits (B, V) of a serving step, or
    the adapters, optimizer state and metrics of a train step."""
    from repro_torch.utils import pytree as pt
    if kind == "train":
        ad, ost, met = out
        return all(bool(pt.tree_all_finite(t)) for t in (ad, ost)) and all(
            math.isfinite(float(v)) for v in met.values())
    return bool(torch.isfinite(out[0]).all())


def dry_steps(torch):
    """(b) Each step of DRY_STEPS on the card against its dry-run account
    (``launch.dryrun.account`` on meta tensors, the same config cut to
    the step's depth): the inputs (``step_and_inputs`` on the card, the
    backbone drawn on it) allocate argument_bytes within DRY_ARG_TOL; the
    step's own allocation (max_memory_allocated after the inputs, the
    peak reset) is peak_estimate_bytes − argument_bytes within
    DRY_STEP_TOL or DRY_STEP_FLOOR, the larger; the result is finite; the
    path launches its kernel once a layer.  The step runs a second time
    on the same inputs, its allocation printed."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import dryrun
    report = {}
    for label, arch, layers, (S, B, kind), expect in DRY_STEPS:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        shape = InputShape(label, S, B, kind)
        t0 = time.perf_counter()
        acc = dryrun.account(cfg, shape)
        t_meta = time.perf_counter() - t0
        mem = acc["memory"]
        want = mem["peak_estimate_bytes"] - mem["argument_bytes"]
        free(torch)
        step, make_args = dryrun.step_and_inputs(cfg, shape, device="cuda")
        torch.cuda.synchronize()
        m1 = torch.cuda.memory_allocated()
        args = make_args()
        torch.cuda.synchronize()
        m2 = torch.cuda.memory_allocated()
        r2 = requested(torch)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        grew = torch.cuda.max_memory_allocated() - m2
        asked = requested(torch, "peak") - r2
        launches = {k: v for k, v in read_launches().items() if v}
        check(abs((m2 - m1) - mem["argument_bytes"])
              <= DRY_ARG_TOL * mem["argument_bytes"],
              f"dry run (b) {label} x {layers} layers, {B} x {S}: the inputs "
              f"allocate {m2 - m1} bytes, the account's argument_bytes "
              f"{mem['argument_bytes']} (within {DRY_ARG_TOL:.0e})")
        bound = max(DRY_STEP_TOL * want, DRY_STEP_FLOOR)
        check(abs(grew - want) <= bound,
              f"dry run (b) {label}: the step allocates {grew} bytes on the "
              f"card, the account's peak_estimate - argument_bytes {want} "
              f"(temp {mem['temp_bytes']} + output {mem['output_bytes']} - "
              f"alias {mem['alias_bytes']}; off by {grew - want}, bound "
              f"{bound:.0f})")
        check(finite_out(torch, kind, out),
              f"dry run (b) {label}: the result is finite")
        check(launches == expect, f"dry run (b) {label}: launches "
              f"{launches} = {expect}")
        # the same step again on the same inputs: what the first run
        # allocated once and kept (a cuBLAS handle's workspace) shows
        del out
        free(torch)
        m3 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = step(*args)
        torch.cuda.synchronize()
        again = torch.cuda.max_memory_allocated() - m3
        report[label] = {
            "layers": layers, "batch": B, "seq": S, "kind": kind,
            "account": mem, "account_s": t_meta,
            "card_argument_bytes": m2 - m1, "card_step_bytes": grew,
            "account_step_bytes": want, "step_off_bytes": grew - want,
            "card_step_bytes_again": again,
            "card_step_requested_bytes": asked,
            "kept_by_first_run_bytes": m3 - m2, "step_wall_s": wall,
            "launches": launches}
        print(f"dry run (b) {label} [{GPU}]: " + json.dumps(report[label]))
        del step, args, out
        free(torch)
    return report


def dry_records(proc, workdir):
    """(c) The background process's records of DRY_ARCHS at every shape
    they support, rendered by ``launch.report``; each status ok."""
    from repro_torch.configs import SHAPES, shape_supported
    from repro_torch.launch import report as R
    t0 = time.perf_counter()
    try:
        log, _ = proc.communicate(timeout=DRY_RECORDS_WAIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise CheckFailed(f"dry run (c): the records' process ran past "
                          f"{DRY_RECORDS_WAIT_S} s of waiting")
    waited = time.perf_counter() - t0
    print(f"dry run (c): waited {waited:.1f} s for the records' process")
    print("--- dry run (c) log ---\n" + log.strip())
    check(proc.returncode == 0, f"dry run (c): the records' process exited "
          f"{proc.returncode}")
    want = [f"{a}__{s}__1.json" for a in DRY_ARCHS for s in SHAPES
            if shape_supported(a, s)]
    recs = []
    for name in want:
        path = workdir / name
        check(path.is_file(), f"dry run (c): {name} written")
        recs.append(json.loads(path.read_text()))
        check(recs[-1]["status"] == "ok",
              f"dry run (c) {name}: status {recs[-1]['status']} "
              f"{recs[-1].get('error', '')}")
    print(R.dryrun_section(recs))
    print(R.roofline_section(recs))
    return {"waited_s": waited, "records": {
        f"{r['arch']} {r['shape']}": {
            "memory": r["memory"], "fits_80g": r["fits_80g"],
            "flops_counted": r["cost_analysis"]["flops_counted"],
            "kernel_flops": r["cost_analysis"]["kernel_flops"],
            "flops_global": r["analytic"]["flops_global"],
            "trace_s": r["trace_s"], "roofline": r["roofline"]}
        for r in recs}}


def phase_dryrun(torch, proc, workdir):
    """Phase 18.  Returns the report."""
    t0 = time.perf_counter()
    report = {"kernels": dry_kernels(torch), "steps": dry_steps(torch)}
    report["records"] = dry_records(proc, workdir)
    report["wall_s"] = time.perf_counter() - t0
    print(f"dry run [{GPU}]: phase wall {report['wall_s']:.1f} s")
    return report


# --- phase 12: the production round engine (run after phase 11) ------------

ENGINE_HP = dict(method="fedlora_opt", n_clients=4, local_steps=2, batch=4,
                 seq_len=128, global_steps=2, personal_steps=2)
ENGINE_SERVER_ROWS = 16     # a stage-2 batch: 8 rows a step, 2 a rank
ENGINE_ITERS = 2            # pipeline iterations; telemetry on in the last
ENGINE_AGG_TOL = 1e-5       # the collective vs FedSim's aggregate, of max
ENGINE_STAGE2_TOL = 1e-4    # sharded stage 2 vs its FedSim replica, of max
ENGINE_STAGE3_TOL = 1e-6    # stage 3 vs FedSim.personalize, of max
ENGINE_WITNESS_LAYERS = 4   # depth of the f32 stage-2 witness, full width
ENGINE_REL_TOL = 1e-2       # f32 witness: every leaf's ‖Δ‖ / ‖leaf‖ ...
ENGINE_ELEM_TOL = 1e-3      # ... and |Δ| beyond this of max |leaf| ...
ENGINE_ELEM_SHARE = 1e-3    # ... in at most this share of its elements
ENGINE_RANK_GIB = 6.0       # the card's memory a rank may add
ENGINE_BUDGET_S = 120       # the phase's wall time, serving included


def engine_batches(ctx, rng):
    """Phase 12's batches on the host: per iteration T stage-1 batches of
    each client's own tasks (C, B, S), TG server batches of the task mix
    (8 rows), TP stage-3 batches."""
    from repro_torch.data import client_batch, to_device
    cds, sds = ctx["engine_data"]
    C, B, S = (ENGINE_HP[k] for k in ("n_clients", "batch", "seq_len"))
    T, TG, TP = (ENGINE_HP[k] for k in ("local_steps", "global_steps",
                                        "personal_steps"))
    rows = ENGINE_SERVER_ROWS // TG
    return [([client_batch(cds, rng, B, S, device="cpu") for _ in range(T)],
             [to_device(sds.sample_batch(rng, rows, S), "cpu")
              for _ in range(TG)],
             [client_batch(cds, rng, B, S, device="cpu") for _ in range(TP)])
            for _ in range(ENGINE_ITERS)]


def engine_rank(group, cfg, settings, params, ad0, iters, events):
    """Phase 12 on one rank of the client group: the rank's client of
    ``ad0`` (host, (C, ...)) through ENGINE_ITERS pipeline iterations on
    the card, over ``params`` (CUDA IPC: mapped, never written).  Each
    iteration keeps its input (adapters, stage-1 optimizer state, step)
    and runs stage 1's local steps alone (``local_step``), then
    ``round_step`` → ``global_step`` → ``personal_step`` from that
    input, each stage's output kept; the last iteration also runs
    ``run_pipeline`` with telemetry on from the same input (rank 0 writes
    the events to ``events``) and names each leaf of its adapters,
    optimizer state and server model that differs from the
    composition's.  Then one more warm ``local_step``, timed.  Returns
    host copies and readings."""
    import torch
    from repro_torch import obs
    from repro_torch.launch.train import (TrainSettings,
                                          make_fed_pipeline_step)
    from repro_torch.utils import pytree as pt
    torch.backends.cuda.matmul.allow_tf32 = False
    me, dev = group.rank, torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()

    def mine(tree):
        return pt.tree_map(lambda x: x[me:me + 1].to(dev), tree)

    def cat(bs, dim):
        return {k: torch.cat([b[k] for b in bs], dim).to(dev) for k in bs[0]}

    def host(tree):
        return pt.tree_map(lambda x: x.detach().cpu(), tree)

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    pipes = {t: make_fed_pipeline_step(cfg, group, TrainSettings(
        **settings, telemetry=t), device="cuda") for t in (False, True)}
    pipe = pipes[False]
    ad = mine(ad0)
    ost = pipe.opt_init(ad)
    out = {"comm_bytes_round": pipe.comm_bytes_round, "iters": [],
           "walls": []}
    step, anchor = 0, None
    T = settings["local_steps"]
    for i, (cb, sb, pb) in enumerate(iters):
        cb, sb, pb = mine(cat(cb, 1)), cat(sb, 0), mine(cat(pb, 1))
        it = {"ad": host(ad), "ost": host(ost), "step": step}
        (local, _, _), t0 = wall(lambda: pipe.local_step(
            params, ad, ost, step, cb, anchor))
        it["local"] = host(local)
        del local
        (ad1, ost1, agg1, m1), t1 = wall(lambda: pipe.round_step(
            params, ad, ost, step, cb, anchor))
        (agg2, ad2, _), t2 = wall(lambda: pipe.global_step(
            params, agg1, ad1, sb))
        (ad3, _), t3 = wall(lambda: pipe.personal_step(params, ad2, pb))
        it.update(ad1=host(ad1), agg1=host(agg1), ad2=host(ad2),
                  agg2=host(agg2), ad3=host(ad3))
        w = {"local": t0, "round": t1, "global": t2, "personal": t3}
        if i == len(iters) - 1:
            if me == 0:
                obs.enable(events)
            (adp, ostp, aggp, _, met), w["pipeline"] = wall(
                lambda: pipes[True].run_pipeline(params, ad, ost, step, cb,
                                                 sb, pb, anchor))
            if me == 0:
                obs.disable()
            got = {"adapters": adp, "opt_state": ostp, "server": aggp}
            want = {"adapters": ad3, "opt_state": ost1, "server": agg2}
            it["pipeline_differs"] = [
                p for p, x in pt.tree_leaves_with_path(got)
                if not torch.equal(x, pt.tree_get(want, p))]
            m1 = met["round"]
        anchor = ad1 if pipe.method.prox else None
        ad, ost, agg = ad3, ost1, agg2
        step += T
        out["iters"].append(it)
        out["walls"].append(w)
    _, t_warm = wall(lambda: pipe.local_step(params, ad, ost, step, cb))
    out.update(adapters=host(ad), agg=host(agg),
               warm_step_ms=1e3 * t_warm / T,
               metrics={k: v.detach().cpu().tolist() for k, v in m1.items()},
               peak_bytes=torch.cuda.max_memory_allocated(),
               collectives=group.stats)
    return out


def engine_stage2(group, cfg, settings, params, aggregated, server_batches):
    """One sharded stage 2 (``global_step``) on this rank from the server
    model ``aggregated`` (host, no client axis) over ``params`` (CUDA
    IPC); returns the trained server model on the host."""
    import torch
    from repro_torch.launch.train import (TrainSettings,
                                          make_fed_pipeline_step)
    from repro_torch.utils import pytree as pt
    torch.backends.cuda.matmul.allow_tf32 = False
    pipe = make_fed_pipeline_step(cfg, group, TrainSettings(**settings),
                                  device="cuda")
    agg = pt.tree_map(lambda x: x.to("cuda"), aggregated)
    sb = {k: torch.cat([b[k] for b in server_batches]).to("cuda")
          for k in server_batches[0]}
    agg, _, _ = pipe.global_step(params, agg,
                                 pt.tree_map(lambda x: x[None], agg), sb)
    return pt.tree_map(lambda x: x.detach().cpu(), agg)


CUT_DEPTH = 8           # layers of full width in phases 8, 10, 11 (a), 12


def cut_ctx(ctx, layers):
    """``ctx`` with its backbone (and phase 9's server model, where there)
    cut to the first ``layers`` superblocks, and the config to match."""
    out = dict(ctx, cfg=dataclasses.replace(ctx["cfg"], n_layers=layers),
               params=depth_cut(ctx["params"], layers))
    if "fleet_server" in ctx:
        out["fleet_server"] = depth_cut(ctx["fleet_server"], layers)
    return out


def depth_cut(tree, layers, dtype=None):
    """``tree`` (the backbone or an adapter tree) cut to its first
    ``layers`` superblocks, on the card, cast to ``dtype`` if given (a
    cut without a cast is a view)."""
    from repro_torch.utils import pytree as pt
    return pt.tree_map_with_path(
        lambda p, x: (x[:layers] if p.startswith("blocks/") else x).to(
            "cuda", dtype=dtype), tree)


def sharded_global_stage(torch, sim, aggregated, server_batches, shards):
    """``FedSim.global_stage`` with each step's gradient taken as the
    engine's sharded stage 2 takes it: the step's rows cut into
    ``shards`` slices in rank order, each slice's gradient by FedSim's
    own ``loss_and_grad``, weighted by its token count and summed in
    f32, over the total count; then FedSim's clip and masked AdamW and
    its rebroadcast.  In bf16 a slice's gradient is rounded where the
    whole batch's is (``layers.lora_delta`` casts the factors to the
    activations' dtype), so this, not the plain ``global_stage``, is the
    math the engine must reproduce."""
    from repro_torch.optim import apply_updates
    from repro_torch.utils import pytree as pt
    opt_state = sim.opt_global.init(aggregated)
    for step, b in enumerate(server_batches):
        rows = b["tokens"].shape[0] // shards
        acc, n_tot = None, 0.0
        for r in range(shards):
            _, met, g = sim.loss_and_grad(
                aggregated, {k: v[r * rows:(r + 1) * rows]
                             for k, v in b.items()})
            n = met["n_tok"]
            g = pt.tree_map(lambda x: x.float() * n, g)
            acc = g if acc is None else pt.tree_map2(torch.add, acc, g)
            n_tot = n_tot + n
        upd, opt_state = sim.opt_global.update(
            pt.tree_map(lambda x: x / n_tot, acc), opt_state, aggregated,
            step)
        aggregated = apply_updates(aggregated, upd)
    sim.client_adapters = sim._rebroadcast(aggregated)
    return aggregated


def leaf_errs(torch, got, want):
    """Per leaf: max |Δ| / max |want|, ‖Δ‖ / ‖want‖ and the share of
    elements beyond 1e-3 of max |want| (f64 on the host)."""
    from repro_torch.utils import pytree as pt
    out = {}
    for p, w in pt.tree_leaves_with_path(want):
        w = w.detach().double().cpu()
        d = (pt.tree_get(got, p).detach().double().cpu() - w).abs()
        scale = max(float(w.abs().max()), 1e-30)
        out[p.split("/", 2)[-1]] = (
            float(d.max()) / scale, float(d.norm() / max(float(w.norm()),
                                                         1e-30)),
            float((d > 1e-3 * scale).double().mean()))
    return out


def phase_engine(torch, ctx, workdir):
    """Phase 12: the paper's pipeline through the production engine
    (``launch/train.make_fed_pipeline_step``), one client per rank of a
    4-rank gloo group on the one card, at llama2-7b full width; each
    stage of both iterations against the port's FedSim from the engine's
    own inputs, ``run_pipeline`` against its three stage calls, and the
    f32 witness of the sharded stage 2 against ``FedSim.global_stage``;
    then the personalized clients served through ``bgmv_mag``."""
    from repro_torch.data import (SyntheticInstructionDataset,
                                  make_dataset_family, specialist_partition)
    from repro_torch.fed.simulate import FedHyper, FedSim, client
    from repro_torch.launch.mesh import ClientPool
    from repro_torch.obs import read_events
    from repro_torch.serve import AdapterStore
    from repro_torch.utils import pytree as pt

    cfg = dataclasses.replace(ctx["cfg"], lora_dropout=0.0)
    params = ctx["params"]
    hp = FedHyper(**ENGINE_HP)
    C, T = hp.n_clients, hp.local_steps
    fam = make_dataset_family("dolly", vocab_size=cfg.vocab_size)
    part = specialist_partition(C, 4)
    ctx["engine_data"] = (
        [SyntheticInstructionDataset(fam, part[c], client_seed=c)
         for c in range(C)],
        SyntheticInstructionDataset(fam, np.ones(4) / 4, client_seed=99))
    iters = engine_batches(ctx, np.random.default_rng(40_000))
    backbone = sum(x.numel() * x.element_size()
                   for x in pt.tree_leaves(params))
    report = {"config": dict(ENGINE_HP, server_rows=ENGINE_SERVER_ROWS,
                             iterations=ENGINE_ITERS, micro_batches=1,
                             remat=True, layers=cfg.n_layers,
                             d_model=cfg.d_model, rank=cfg.lora_rank),
              "backbone_bytes": backbone}
    gib = 1 << 30

    def cuda(tree):
        return pt.tree_map(lambda x: x.to("cuda"), tree)

    def on(bs):
        return [cuda(b) for b in bs]

    # --- the engine: 4 ranks sharing the backbone --------------------------
    sim = FedSim(cfg, hp, base=params, device="cuda")
    ad0 = host_copy(torch, sim.client_adapters)
    del sim
    torch.cuda.synchronize()
    free0, total = torch.cuda.mem_get_info()
    settings = dict(lr=hp.lr, micro_batches=1, clip=hp.clip, remat=True,
                    method=hp.method, local_steps=T, server_lr=hp.server_lr,
                    global_steps=hp.global_steps,
                    personal_steps=hp.personal_steps, lam=hp.lam)
    events = str(workdir / "engine.jsonl")
    L = ENGINE_WITNESS_LAYERS
    cfg32 = dataclasses.replace(cfg, n_layers=L, dtype="float32")
    t0 = time.perf_counter()
    with ClientPool(C, str(workdir), timeout_s=600) as pool:
        t_up = time.perf_counter() - t0
        try:
            res = pool.run(engine_rank, cfg, settings, params, ad0, iters,
                           events)
        except RuntimeError as e:
            raise CheckFailed(f"engine: a rank failed:\n{e}")
        free1, _ = torch.cuda.mem_get_info()     # the ranks still hold theirs
        t_engine = time.perf_counter() - t0
        # the f32 witness: the engine's sharded stage 2 at full width, L
        # layers deep, from the first iteration's server model
        base32 = depth_cut(params, L, torch.float32)
        agg32 = depth_cut(res[0]["iters"][0]["agg1"], L)
        try:
            got32 = pool.run(engine_stage2, cfg32, settings, base32,
                             host_copy(torch, agg32), iters[0][1])[0]
        except RuntimeError as e:
            raise CheckFailed(f"engine: a rank failed in the f32 witness:"
                              f"\n{e}")
    report["engine"] = {
        "pool_start_s": t_up, "wall_s": t_engine,
        "card_used_bytes": total - free1, "ranks_added_bytes": free0 - free1,
        "rank_peak_bytes": [r["peak_bytes"] for r in res],
        "walls": [r["walls"] for r in res],
        "warm_stage1_step_ms": [r["warm_step_ms"] for r in res],
        "collectives": [r["collectives"] for r in res]}
    print("engine: " + json.dumps(report["engine"]))
    check(total - free1 < 80e9, f"engine: the card holds "
          f"{(total - free1) / gib:.1f} GiB with 4 ranks up, under 80 GB")
    check(free0 - free1 < C * ENGINE_RANK_GIB * gib
          and max(r["peak_bytes"] for r in res) < backbone / 2,
          f"engine: the 4 ranks added {(free0 - free1) / gib:.2f} GiB to the "
          f"card (< {C} x {ENGINE_RANK_GIB} GiB), each allocated at most "
          f"{max(r['peak_bytes'] for r in res) / gib:.2f} GiB: they map the "
          f"one {backbone / gib:.1f} GiB backbone, none copies it")
    differs = sorted({p for r in res for p in r["iters"][-1]["pipeline_differs"]})
    check(not differs, "engine: run_pipeline with telemetry on gives every "
          "rank the adapters, stage-1 optimizer state and server model of "
          "round_step → global_step → personal_step from the same input, "
          "bit for bit" + (f" (leaves that differ: {differs[:4]}, "
                           f"{len(differs)} in all)" if differs else ""))

    # --- every iteration, stage by stage, against FedSim --------------------
    # each stage of FedSim starts from the engine's own input to it: in
    # bf16 a 1e-7 difference in an f32 adapter flips the bf16 rounding of
    # some elements, which the next stage would carry and amplify
    sim = FedSim(cfg, hp, base=params, device="cuda")
    t0 = time.perf_counter()
    stages, fedsim_walls = [], []
    for i, (cb, sb, pb) in enumerate(iters):
        its = [r["iters"][i] for r in res]

        def stacked(key, its=its):
            return pt.tree_map_with_path(lambda p, _: torch.cat(
                [pt.tree_get(it[key], p) for it in its]), its[0][key])
        check(all(it["step"] == sim._step for it in its),
              f"engine, iteration {i + 1}: every rank starts stage 1 at "
              f"FedSim's step {sim._step}")
        sim.client_adapters = cuda(stacked("ad"))
        sim.opt_state = cuda(stacked("ost"))
        w = {}
        torch.cuda.synchronize()
        t = time.perf_counter()
        sim.local_round(on(cb))
        local = stacked("local")
        diff = [(p, float((pt.tree_get(local, p) - x.cpu()).abs().max()))
                for p, x in pt.tree_leaves_with_path(sim.client_adapters)
                if not torch.equal(pt.tree_get(local, p), x.cpu())]
        check(not diff, f"engine, iteration {i + 1}: stage 1's client "
              "adapters before the collective equal FedSim.local_round's bit "
              "for bit" + (f" (first leaf that differs: {diff[0][0]}, max "
                           f"|Δ| {diff[0][1]:.3e}; {len(diff)} leaves differ)"
                           if diff else ""))
        bill = sim.comm_bytes
        agg_s = sim.aggregate()
        torch.cuda.synchronize()
        w["round"], t = time.perf_counter() - t, time.perf_counter()
        if i == 0:
            round_bill = sim.comm_bytes - bill
        st = {"aggregate": leaf_errs(torch, its[0]["agg1"], agg_s),
              "rebroadcast": leaf_errs(torch, stacked("ad1"),
                                       sim.client_adapters)}
        sim.client_adapters = cuda(stacked("ad1"))
        agg2_s = sharded_global_stage(torch, sim, cuda(its[0]["agg1"]),
                                      on(sb), C)
        torch.cuda.synchronize()
        w["global"], t = time.perf_counter() - t, time.perf_counter()
        st["stage2"] = leaf_errs(torch, its[0]["agg2"], agg2_s)
        st["stage2_rebroadcast"] = leaf_errs(torch, stacked("ad2"),
                                             sim.client_adapters)
        sim.client_adapters = cuda(stacked("ad2"))
        sim.personalize(on(pb))
        torch.cuda.synchronize()
        w["personal"] = time.perf_counter() - t
        st["stage3"] = leaf_errs(torch, stacked("ad3"), sim.client_adapters)
        stages.append(st)
        fedsim_walls.append(w)
    del sim, agg_s, agg2_s
    report["fedsim"] = {"wall_s": time.perf_counter() - t0,
                        "walls": fedsim_walls, "round_bill": round_bill}
    print("engine's FedSim checks: " + json.dumps(report["fedsim"]))
    worst = [{k: max(v[0] for v in d.values()) for k, d in st.items()}
             for st in stages]
    report["engine"]["stages_vs_fedsim"] = {"max_err_of_max": worst,
                                            "per_leaf": stages}
    print("engine, each iteration stage by stage against FedSim from the "
          "engine's inputs (max |Δ| / max, ‖Δ‖ / ‖leaf‖, share beyond 1e-3 "
          "of max): " + json.dumps(report["engine"]["stages_vs_fedsim"]))
    for i, wi in enumerate(worst):
        for k, tol in (("aggregate", ENGINE_AGG_TOL),
                       ("rebroadcast", ENGINE_AGG_TOL),
                       ("stage2", ENGINE_STAGE2_TOL),
                       ("stage2_rebroadcast", ENGINE_STAGE2_TOL),
                       ("stage3", ENGINE_STAGE3_TOL)):
            check(wi[k] <= tol, f"engine, iteration {i + 1}: {k} within "
                  f"{wi[k]:.2e} <= {tol} of each leaf's max of FedSim's from "
                  f"the same input" + (
                      " (stage 2 with its gradient taken in the engine's "
                      f"{C} slices)" if k.startswith("stage2") else ""))

    # --- the f32 witness, against FedSim.global_stage -----------------------
    # the engine's sharded stage 2 in f32 against FedSim's full-batch
    # global stage (held), and in bf16 FedSim's own sharded replica
    # against its full-batch global stage (a reading: the gap bf16 makes)
    sb0 = on(iters[0][1])
    sim = FedSim(cfg32, hp, base=base32, device="cuda")
    witness = {"float32_engine": leaf_errs(
        torch, got32, sim.global_stage(agg32, sb0))}
    del sim, base32
    sim = FedSim(dataclasses.replace(cfg, n_layers=L), hp,
                 base=depth_cut(params, L), device="cuda")
    witness["bfloat16_sharded_replica"] = leaf_errs(
        torch, sharded_global_stage(torch, sim, agg32, sb0, C),
        sim.global_stage(agg32, sb0))
    del sim, agg32
    gc.collect()
    torch.cuda.empty_cache()
    wsum = {k: {"max_err_of_max": max(v[0] for v in d.values()),
                "rel_norm": max(v[1] for v in d.values()),
                "share_beyond": max(v[2] for v in d.values())}
            for k, d in witness.items()}
    report["engine"]["stage2_witness"] = dict(layers=L, **wsum,
                                              per_leaf=witness)
    print(f"engine, stage 2 from the same server model at {L} layers of "
          "full width, sharded against FedSim.global_stage's full batch "
          "(max |Δ| / max, ‖Δ‖ / ‖leaf‖, share beyond 1e-3 of max): "
          + json.dumps(report["engine"]["stage2_witness"]))
    f32 = wsum["float32_engine"]
    check(f32["rel_norm"] <= ENGINE_REL_TOL
          and f32["share_beyond"] <= ENGINE_ELEM_SHARE,
          f"engine: in f32 the sharded stage 2 is FedSim.global_stage's "
          f"step: every leaf within ‖Δ‖/‖leaf‖ {f32['rel_norm']:.2e} <= "
          f"{ENGINE_REL_TOL}, {f32['share_beyond']:.2e} of its elements "
          f"beyond {ENGINE_ELEM_TOL} of its max (<= {ENGINE_ELEM_SHARE})")

    check(all(torch.equal(x[0], pt.tree_get(r["agg"], p))
              and torch.equal(pt.tree_get(r["agg"], p),
                              pt.tree_get(res[0]["agg"], p))
              for r in res for p, x in pt.tree_leaves_with_path(r["adapters"])
              if not p.endswith("/dB_mag")),
          "engine: every client's model is the stage-2 server model plus its "
          "own dB_mag, the same server model on every rank")
    check(all(r["comm_bytes_round"] == round_bill for r in res),
          f"engine: comm_bytes_round {res[0]['comm_bytes_round']} equals "
          f"FedSim's bill for the round, {round_bill}")
    evs = read_events(events)
    rounds = [e for e in evs if e["kind"] == "fed_round"]
    check(len(rounds) == 1 and rounds[0]["clients"] == C
          and len(rounds[0]["ce"]) == C
          and np.allclose(np.mean(rounds[0]["ce"]),
                          res[0]["metrics"]["ce"], rtol=1e-5)
          and all(np.isfinite(rounds[0][k]).all()
                  for k in ("ce", "grad_norm", "drift")),
          "engine: one fed_round event from the telemetry iteration, its "
          "per-client ce averaging the round's ce, every value finite")
    report["engine"]["fed_round"] = {k: rounds[0][k] for k in (
        "ce", "grad_norm", "drift", "loss_spread", "comm_bytes", "wall")}
    print("engine fed_round: " + json.dumps(report["engine"]["fed_round"]))

    # --- serve the personalized clients through bgmv_mag --------------------
    server = cuda(res[0]["agg"])
    mag = AdapterStore(params, cfg, n_slots=8, kind="dora_mag", shared=server,
                       device="cuda")
    tenants = [f"client{c}" for c in range(C)]
    for c, t in enumerate(tenants):
        own = cuda(client(res[c]["adapters"], 0))
        mag.register(t, pt.filter_tree(own, lambda p: p.endswith("/dB_mag")))
    del res
    rng = np.random.default_rng(7)
    reqs = [(tenants[i % C], rng.integers(0, cfg.vocab_size,
                                          size=int(rng.integers(16, PAD_W + 1))
                                          ).astype(np.int32))
            for i in range(8)]
    torch.cuda.reset_peak_memory_stats()
    _, st, counts = serve(torch, engine(params, cfg, mag), reqs, "engine",
                          expect={"bgmv_mag": 2})
    report["serve"] = engine_report("engine", st, len(reqs),
                                    torch.cuda.max_memory_allocated())
    batch, last = admitted_batch(torch, mag, reqs)
    report["serve"]["prefill_logits"] = logits_checks(
        torch, "engine", pt.merge_trees(params, mag.overlay()), cfg,
        prefill_logits(torch, batch, last))
    return report, counts["bgmv_mag"]


# --- phase 19: the 'model' axis, a 2 x 2 grid of ranks on the one card ----

MESH_GRID = (2, 2)      # data x model ranks, sharing the one card over gloo
MESH_ARCH = "llama2-7b"
MESH_S = 4096           # (a)'s prompt a row: one row a data rank
MESH_NEW = 16           # (a)'s greedy tokens
MESH_F32_DEPTH = 8      # (a)'s f32 check and (b)'s engine, layers of full width
MESH_ENGINE_HP = dict(method="fedlora_opt", n_clients=2, local_steps=2,
                      batch=4, seq_len=128, global_steps=1, personal_steps=1)
MESH_SERVER_ROWS = 4    # (b)'s stage-2 batch: 2 rows a data rank (sharded)
MESH_ENGINE_TOL = 1e-4  # (b): every leaf against FedSim, of its max, f64
MESH_EPS_SHARE = 1e-3   # (b): dA_dir's elements at AdamW's eps, at most
MESH_WITNESS_TOL = 1e-5  # (b) f32: off its own f64 run by more, of max
MESH_MOE = "qwen3-moe-30b-a3b"
MESH_MOE_DEPTH = 4      # (c)'s layers of full width (of 48)
MESH_MOE_S = 1024       # (c)'s prefill a row: one row a data rank
MESH_MOE_PROMPT = 64    # (c)'s one-row prompt before the one-row decode step
MESH_BUDGET_S = 90      # the phase's wall time


def stats_delta(before, after):
    """The collectives' calls, bytes and seconds between two readings of
    ``Grid.stats``, per group and op."""
    return {g: {op: {k: after[g][op][k] - before[g][op][k]
                     for k in after[g][op]} for op in after[g]}
            for g in after}


def stats_copy(stats):
    return {g: {op: dict(v) for op, v in ops.items()}
            for g, ops in stats.items()}


def mesh_warm_rank(grid):
    """A rank's first meta-tensor work, the production engine's adapter
    template: a process's first decomposed meta ops import PyTorch's
    reference implementations (sympy among them), seconds of host time
    that would otherwise land in (b)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import TrainSettings, make_fed_pipeline_step
    t0 = time.perf_counter()
    make_fed_pipeline_step(get_smoke_config(MESH_ARCH), grid.data,
                           TrainSettings(), device=grid.device)
    return time.perf_counter() - t0


class MeshPool:
    """Phase 19's grid of ranks, started (and each rank warmed,
    ``mesh_warm_rank``) on a thread of this process while it runs phases
    17 and 18; ``get()`` waits for it and returns the ``ClientPool``, or
    raises what starting it raised."""

    def __init__(self, workdir):
        import threading
        self.workdir, self.pool, self.error, self.times = workdir, None, None, {}
        self.thread = threading.Thread(target=self._start, daemon=True)
        self.thread.start()

    def _start(self):
        from repro_torch.launch.mesh import ClientPool
        try:
            t0 = time.perf_counter()
            self.pool = ClientPool(MESH_GRID[0], str(self.workdir),
                                   n_model=MESH_GRID[1], device="cuda",
                                   timeout_s=600)
            self.times["pool_start_s"] = time.perf_counter() - t0
            self.times["warm_s"] = self.pool.run(mesh_warm_rank)
        except Exception as e:          # raised again in get()
            self.error = e

    def get(self):
        self.thread.join()
        if self.error is not None:
            raise CheckFailed(f"mesh: the grid did not start:\n{self.error}")
        return self.pool

    def close(self):
        self.thread.join()
        if self.pool is not None:
            self.pool.close()


def mesh_rank_start(grid, cfg, params):
    """A phase-19 task's start on its rank: TF32 off, the peak reset, and
    the rank's shard of ``params`` (CUDA IPC, never written) cut by
    ``param_specs`` and copied to the rank's card; returns (shard, its
    bytes, the seconds it took)."""
    import torch
    from repro_torch.launch import specs as SP
    from repro_torch.utils import pytree as pt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mine = pt.tree_map(lambda t: t.to(grid.device), SP.shard_tree(
        params, SP.param_specs(cfg, grid, params), grid))
    torch.cuda.synchronize()
    return mine, sum(x.numel() * x.element_size()
                     for x in pt.tree_leaves(mine)), time.perf_counter() - t0


def mesh_serve_rank(grid, cfg, params, tokens, n_new):
    """Phase 19 (a) on one rank: its shard of ``params``; the prefill step
    of the whole batch ``tokens`` (its row; flash_attention over its q
    heads once a layer) with room for ``n_new`` tokens, then ``n_new`` - 1
    greedy decode steps, every row's logits gathered.  Returns host
    copies, the times, launches, peak and the collectives' readings."""
    import torch
    from repro_torch.launch.serve import make_decode_step, make_prefill_step
    from repro_torch.models import model as M
    mine, shard_bytes, shard_s = mesh_rank_start(grid, cfg, params)
    prefill, decode = make_prefill_step(cfg, grid), make_decode_step(cfg, grid)
    S = tokens.shape[1]
    before = stats_copy(grid.stats)
    reset_launches()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(mine, {"tokens": tokens}, cache_len=S + n_new)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        first = logits.cpu()
        tok = M.argmax_first(logits)
        toks = [tok]
        for i in range(n_new - 1):
            logits, cache = decode(mine, tok, cache, S + i)
            tok = M.argmax_first(logits)
            toks.append(tok)
        toks = torch.stack(toks, dim=1).cpu()
        t2 = time.perf_counter()
    launches = read_launches()
    out = {"logits": first, "tokens": toks, "prefill_ms": 1e3 * (t1 - t0),
           "decode_step_ms": 1e3 * (t2 - t1) / max(n_new - 1, 1),
           "launches": {k: v for k, v in launches.items() if v},
           "shard_bytes": shard_bytes, "shard_s": shard_s,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "collectives": stats_delta(before, grid.stats)}
    del mine, cache, logits
    torch.cuda.empty_cache()
    return out


def mesh_engine_rank(grid, cfg, settings, params, ad0, cb, sb, pb):
    """Phase 19 (b) on one rank: the production engine on the grid, the
    rank's client (its data index) of the host (C, ...) adapters ``ad0``,
    one fedlora_opt iteration: round_step (the stage-1 batch ``cb`` (C,
    T·B, S)) → global_step (the server batch ``sb``, sharded over the
    data ranks) → personal_step (``pb``).  Returns the client's adapters,
    the server model, the stage walls, peak and collectives."""
    import torch
    from repro_torch.launch.train import (TrainSettings,
                                          make_fed_pipeline_step, rank_slice)
    from repro_torch.utils import pytree as pt
    t_task = time.perf_counter()
    mine, shard_bytes, shard_s = mesh_rank_start(grid, cfg, params)
    pipe = make_fed_pipeline_step(cfg, grid, TrainSettings(**settings),
                                  device="cuda")
    d = grid.data.rank

    def cuda(tree):
        return pt.tree_map(lambda x: x.to("cuda"), tree)

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0
    ad = cuda(rank_slice(ad0, d))
    ost = pipe.opt_init(ad)
    before = stats_copy(grid.stats)
    cb, sb, pb = cuda(rank_slice(cb, d)), cuda(sb), cuda(rank_slice(pb, d))
    (ad, ost, agg, _), t1 = wall(lambda: pipe.round_step(mine, ad, ost, 0,
                                                         cb))
    (agg, ad, _), t2 = wall(lambda: pipe.global_step(mine, agg, ad, sb))
    (ad, met), t3 = wall(lambda: pipe.personal_step(mine, ad, pb))
    out = {"adapters": host_copy(torch, ad), "agg": host_copy(torch, agg),
           "walls": {"round": t1, "global": t2, "personal": t3},
           "ce": float(met["ce"]), "shard_bytes": shard_bytes,
           "shard_s": shard_s, "task_s": time.perf_counter() - t_task,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "collectives": stats_delta(before, grid.stats)}
    del mine, ad, ost, agg
    torch.cuda.empty_cache()
    return out


class RecordedPicks:
    """Within it, every ``layers.moe_router`` call's top-k expert picks
    (T, k) are kept, in call order, on the host (``picks``), and with
    ``inputs`` its input rows (T, D) too, where they are."""

    def __init__(self, inputs=False):
        self.keep = inputs

    def __enter__(self):
        from repro_torch.models import layers as L
        self.L, self.real, self.picks, self.inputs = L, L.moe_router, [], []

        def recording(p, xt, cfg):
            out = self.real(p, xt, cfg)
            self.picks.append(out[0].cpu())
            if self.keep:
                self.inputs.append(xt.detach().clone())
            return out
        L.moe_router = recording
        return self

    def __exit__(self, *exc):
        self.L.moe_router = self.real


def mesh_moe_rank(grid, cfg, params, tokens, prompt):
    """Phase 19 (c) on one rank: its 64 of 128 expert slots with its half
    of their d_ff (and its shard of the rest); the prefill step of the
    whole (2, S) ``tokens`` (one row a data rank: the all-to-all path),
    then of the one-row ``prompt`` (the small-batch path: every data rank
    runs the row) and one decode step after it.  Returns every row's
    logits, the times, peak and collectives."""
    import torch
    from repro_torch.launch.serve import make_decode_step, make_prefill_step
    from repro_torch.models import model as M
    mine, shard_bytes, shard_s = mesh_rank_start(grid, cfg, params)
    prefill, decode = make_prefill_step(cfg, grid), make_decode_step(cfg, grid)
    slots = mine["blocks"]["sub0"]["moe"]["experts"]["gate"].shape
    before = stats_copy(grid.stats)
    with torch.no_grad(), RecordedPicks() as rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        split, _ = prefill(mine, {"tokens": tokens})
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        one, cache = prefill(mine, {"tokens": prompt},
                             cache_len=prompt.shape[1] + 1)
        step, _ = decode(mine, M.argmax_first(one), cache, prompt.shape[1])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    out = {"split": split.cpu(), "one": one.cpu(), "step": step.cpu(),
           "picks": rec.picks,
           "slot_shape": list(slots), "prefill_ms": 1e3 * (t1 - t0),
           "one_row_ms": 1e3 * (t2 - t1), "shard_bytes": shard_bytes,
           "shard_s": shard_s,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "collectives": stats_delta(before, grid.stats)}
    del mine, cache
    torch.cuda.empty_cache()
    return out


def mesh_serving(torch, pool):
    """Phase 19 (a): llama2-7b at full width on the grid against the
    unsharded path on the same card."""
    from repro_torch.launch.serve import greedy_generate, make_prefill_step
    from repro_torch.utils import pytree as pt
    cfg, params = dense_model(torch, MESH_ARCH)
    tokens = dense_tokens(torch, cfg, MESH_GRID[0], MESH_S, seed=19)
    report, flash = {}, 0
    runs = (("f32", MESH_F32_DEPTH, torch.float32, LOGITS_F32_TOL, MESH_NEW),
            ("bf16", CHECK_DEPTH, None, TOL["bfloat16"], 1),
            ("bf16", cfg.n_layers, None, None, MESH_NEW))
    for dn, depth, dtype, tol, n_new in runs:
        label = f"{depth} layers {dn}"
        cut, ccfg = first_layers(params, cfg, depth)
        if dtype is not None:
            cut = pt.tree_map(lambda t: t.to(dtype), cut)
            ccfg = dataclasses.replace(ccfg, dtype="float32")
        want = toks = None
        if tol is not None:         # the unsharded path first, on its own
            with torch.no_grad():
                want, _ = make_prefill_step(ccfg)(cut, {"tokens": tokens},
                                                  cache_len=MESH_S + MESH_NEW)
            if dtype is not None:
                toks = greedy_generate(cut, {"tokens": tokens}, ccfg,
                                       MESH_NEW, device="cuda").cpu()
        res = pool.run(mesh_serve_rank, ccfg, cut, tokens, n_new)
        for r in res[1:]:
            check(torch.equal(r["logits"], res[0]["logits"])
                  and torch.equal(r["tokens"], res[0]["tokens"]),
                  f"mesh {label}: every rank returns the same logits and "
                  f"tokens for every row")
        n = [r["launches"].get("flash_attention", 0) for r in res]
        check(n == [depth] * len(res), f"mesh {label}: flash_attention "
              f"launched {n} times on the ranks = {depth} (once a layer of "
              f"the rank's prefill, over its heads)")
        flash += sum(n)
        out = {"layers": depth, "prompt": list(tokens.shape),
               "prefill_ms": [r["prefill_ms"] for r in res],
               "decode_step_ms": [r["decode_step_ms"] for r in res],
               "rank_peak_bytes": [r["peak_bytes"] for r in res],
               "rank_shard_bytes": [r["shard_bytes"] for r in res],
               "shard_s": [r["shard_s"] for r in res],
               "launches": [r["launches"] for r in res],
               "collectives": [r["collectives"] for r in res]}
        if tol is not None:
            err, _ = rel_err(res[0]["logits"], want.cpu())
            check(err <= tol, f"mesh {label}: prefill logits on the grid vs "
                  f"the unsharded path {err:.3e} <= {tol} of max |logit|")
            out["logits_rel_err"] = err
            if toks is not None:
                check(torch.equal(toks, res[0]["tokens"]),
                      f"mesh {label}: {MESH_NEW} greedy tokens on the grid "
                      f"equal the unsharded path's")
                out["greedy_tokens_equal"] = MESH_NEW
        print(f"mesh (a) {MESH_ARCH} {label} [{GPU}]: " + json.dumps(out))
        report[label] = out
        del cut
        free(torch)
    del params
    free(torch)
    return report, flash


def mesh_engine(torch, pool, arch=MESH_ARCH, layers=MESH_F32_DEPTH,
                label="(b)"):
    """Phase 19 (b): one fedlora_opt pipeline iteration on the grid at
    ``arch``'s width (llama2-7b), ``layers`` layers, against FedSim from
    the same initial adapters and batches: in f64, every client and
    server leaf within MESH_ENGINE_TOL of its max (``mesh_engine_check``);
    in f32 the same by the f64 witness (``mesh_engine_f32_check``: the
    AdamW steps that move dA_dir and B_dir from zero sit at its eps for
    the elements of smallest gradient, where f32's other summation order
    moves them: PERF.md).  Phase 20 (d) runs it at mamba2-2.7b's width
    (adapters on x_proj / out_proj), ``label`` naming the part."""
    from repro_torch.fed.simulate import FedHyper, FedSim
    from repro_torch.utils import pytree as pt
    cfg, params = dense_model(torch, arch, layers=layers, dtype="float32",
                              seed=20)
    hp = FedHyper(**MESH_ENGINE_HP)
    C, T, B, S = hp.n_clients, hp.local_steps, hp.batch, hp.seq_len
    g = torch.Generator(device="cuda").manual_seed(21)

    def batch(*lead):
        tok = torch.randint(5, cfg.vocab_size, (*lead, S), generator=g,
                            device="cuda")
        return {"tokens": tok, "loss_mask": torch.ones(tok.shape,
                                                       device="cuda")}

    def cat(bs, dim):
        return {k: torch.cat([b[k] for b in bs], dim) for k in bs[0]}
    cbs = [batch(C, B) for _ in range(T)]
    rows = MESH_SERVER_ROWS // hp.global_steps
    sbs = [batch(rows) for _ in range(hp.global_steps)]
    pbs = [batch(C, B) for _ in range(hp.personal_steps)]
    settings = dict(lr=hp.lr, micro_batches=1, clip=hp.clip, remat=False,
                    method=hp.method, local_steps=T, server_lr=hp.server_lr,
                    global_steps=hp.global_steps,
                    personal_steps=hp.personal_steps, lam=hp.lam)
    n_model = MESH_GRID[1]
    report = {"config": dict(MESH_ENGINE_HP, server_rows=MESH_SERVER_ROWS,
                             arch=arch, layers=cfg.n_layers, remat=False,
                             lora_targets=list(cfg.lora_targets))}
    ad0, runs = None, {}
    for dn, dt in (("f64", torch.float64), ("f32", torch.float32)):
        base = pt.tree_map(lambda t: t.to(dt), params)
        sim = FedSim(cfg, hp, base=base, device="cuda")
        if ad0 is None:
            ad0 = host_copy(torch, sim.client_adapters)
        sim.client_adapters = pt.tree_map(lambda t: t.to("cuda", dt), ad0)
        sim.opt_state = sim._init_clients(sim.opt)
        cast = [[pt.tree_map(lambda t: t.to(dt) if t.is_floating_point()
                             else t, b) for b in bs] for bs in (cbs, sbs, pbs)]
        # FedSim first, then the grid: four ranks and this process sharing
        # the card in turns slow both
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.local_round(cast[0])
        agg = sim.aggregate()
        agg = sim.global_stage(agg, cast[1])
        sim.personalize(cast[2])
        torch.cuda.synchronize()
        t_sim = time.perf_counter() - t0
        want = {"clients": host_copy(torch, sim.client_adapters),
                "server": host_copy(torch, agg)}
        del sim, agg
        free(torch)
        t0 = time.perf_counter()
        res = pool.run(mesh_engine_rank, cfg, settings, base,
                       pt.tree_map(lambda t: t.to(dt), ad0),
                       cat(cast[0], 1), cat(cast[1], 0), cat(cast[2], 1))
        t_grid = time.perf_counter() - t0
        for r in range(len(res)):
            lead = res[r - r % n_model]
            check(all(torch.equal(x, pt.tree_get(lead["adapters"], p))
                      for p, x in pt.tree_leaves_with_path(res[r]["adapters"]))
                  and all(torch.equal(x, pt.tree_get(res[0]["agg"], p))
                          for p, x in pt.tree_leaves_with_path(res[r]["agg"])),
                  f"mesh engine {label} {dn}: rank {r} holds its model "
                  f"row's client and the one server model bit for bit")
        clients = [res[d * n_model]["adapters"] for d in range(C)]
        got = pt.tree_map_with_path(lambda p, _: torch.cat(
            [pt.tree_get(c, p) for c in clients]), clients[0])
        runs[dn] = ({"clients": got, "server": res[0]["agg"]}, want)
        errs = {"clients": leaf_errs(torch, got, want["clients"]),
                "server": leaf_errs(torch, res[0]["agg"], want["server"])}
        worst = max(e[0] for part in errs.values() for e in part.values())
        for part, e in errs.items():
            top = sorted(e.items(), key=lambda kv: -kv[1][0])[:4]
            print(f"mesh {label} engine {arch} {dn}, {part}: leaves "
                  f"farthest from "
                  f"FedSim's (max |Δ| / max, ‖Δ‖ / ‖leaf‖, share beyond 1e-3 "
                  f"of max): " + json.dumps(top))
        report[dn] = {
            "grid_wall_s": t_grid, "fedsim_wall_s": t_sim,
            "worst_leaf_rel_err": worst,
            "worst_leaf_norm_rel_err": max(
                e[1] for part in errs.values() for e in part.values()),
            "walls": [r["walls"] for r in res],
            "shard_s": [r["shard_s"] for r in res],
            "task_s": [r["task_s"] for r in res],
            "ce": [r["ce"] for r in res],
            "rank_peak_bytes": [r["peak_bytes"] for r in res],
            "rank_shard_bytes": [r["shard_bytes"] for r in res],
            "collectives": [r["collectives"] for r in res]}
        print(f"mesh {label} engine {arch} {dn} [{GPU}]: "
              + json.dumps(report[dn]))
        if dn == "f64":
            mesh_engine_check(errs, label)
        else:
            report[dn]["witness"] = mesh_engine_f32_check(torch, runs, label)
        del base, res
        free(torch)
    del params
    free(torch)
    return report


def mesh_engine_f32_check(torch, runs, label="(b)"):
    """(b) in f32, by the f64 witness (the rule of the CPU tests' f32
    comparisons, ``tests/test_torch_tp.py``, with the share bound taken
    from FedSim's own f32 run: at full width a tenth to a fifth of
    dA_dir's elements sit at AdamW's eps): every client and server
    element within MESH_ENGINE_TOL of its leaf's max of FedSim's f32 run,
    but where f32 does not resolve it, the grid's or FedSim's f32 run
    being more than MESH_WITNESS_TOL of max off its own f64 run; and the
    grid's f32 run so off at no more than twice as many elements of a
    leaf as FedSim's, plus 2 (a fault of the grid's f32 path alone would
    put it off everywhere).  ``runs``: {"f32" | "f64": (grid, FedSim)},
    each {"clients" | "server": tree}.  Returns, per leaf, the elements
    beyond MESH_ENGINE_TOL, and those of each run off its f64."""
    from repro_torch.utils import pytree as pt
    (g32, f32), (g64, f64) = runs["f32"], runs["f64"]
    out = {}
    for part in ("clients", "server"):
        for p, w in pt.tree_leaves_with_path(f32[part]):
            def host(tree):
                return pt.tree_get(tree[part], p).detach().double().cpu()
            w, g, wg, wf = w.detach().double().cpu(), host(g32), host(g64), \
                host(f64)
            scale = max(float(w.abs().max()), 1e-30)
            beyond = (g - w).abs() > MESH_ENGINE_TOL * scale
            off_g = (g - wg).abs() > MESH_WITNESS_TOL * scale
            off_f = (w - wf).abs() > MESH_WITNESS_TOL * scale
            n = {k: int(v.sum()) for k, v in (
                ("beyond", beyond), ("grid_off_f64", off_g),
                ("fedsim_off_f64", off_f),
                ("unresolved_beyond", beyond & ~(off_g | off_f)))}
            out[f"{part} {p.split('/', 2)[-1]}"] = dict(n, elements=w.numel())
    print(f"mesh {label} engine f32 by the f64 witness [{GPU}]: "
          + json.dumps({k: v for k, v in out.items() if v["beyond"]}))
    for leaf, n in out.items():
        check(n["unresolved_beyond"] == 0
              and n["grid_off_f64"] <= 2 * n["fedsim_off_f64"] + 2,
              f"mesh engine {label} f32 {leaf}: {n['beyond']} of "
              f"{n['elements']} elements beyond {MESH_ENGINE_TOL} of max, each one f32 does "
              f"not resolve ({n['unresolved_beyond']} not); the grid off "
              f"its f64 at {n['grid_off_f64']} <= 2 x {n['fedsim_off_f64']}"
              f" + 2 (FedSim's)")
    return out


def mesh_engine_check(errs, label="(b)"):
    """(b) in f64: every client and server leaf within MESH_ENGINE_TOL of
    its max of FedSim's, but dA_dir, which one AdamW step moves from zero
    (each element by -lr · g / (|g| + eps)), so that an element whose
    gradient is near eps moves with the gradient's last bits (f32 cast
    points inside the f64 model, another summation order): it is held
    in norm within MESH_ENGINE_TOL, and at most MESH_EPS_SHARE of its
    elements beyond 1e-3 of its max."""
    for part, e in errs.items():
        for p, (mx, nrm, share) in e.items():
            if p.endswith("dA_dir"):
                check(nrm <= MESH_ENGINE_TOL and share <= MESH_EPS_SHARE,
                      f"mesh engine {label} f64 {part} {p}: ‖Δ‖ {nrm:.3e} <= "
                      f"{MESH_ENGINE_TOL} of ‖leaf‖, {share:.2e} <= "
                      f"{MESH_EPS_SHARE} of elements beyond 1e-3 of max "
                      f"(max {mx:.3e})")
            else:
                check(mx <= MESH_ENGINE_TOL, f"mesh engine {label} f64 "
                      f"{part} {p}: "
                      f"{mx:.3e} <= {MESH_ENGINE_TOL} of max |leaf|")


def moe_loads(torch, cfg, params, tokens):
    """The most tokens any expert takes in any MoE layer of a prefill of
    ``tokens``, over all rows and over each row alone (the router's picks,
    recorded through ``layers.moe_router``)."""
    from repro_torch.models import model as M
    with torch.no_grad(), RecordedPicks() as rec:
        M.forward(params, {"tokens": tokens}, dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k))
    B = tokens.shape[0]
    whole = row = 0
    for top_i in rec.picks:
        per_row = top_i.reshape(B, -1)
        counts = torch.zeros((B, cfg.n_experts), dtype=torch.int64)
        counts.scatter_add_(1, per_row, torch.ones_like(per_row))
        whole = max(whole, int(counts.sum(0).max()))
        row = max(row, int(counts.max()))
    return whole, row


def routed_otherwise(got, want):
    """Tokens whose set of picked experts differs, summed over the MoE
    layers (``got`` / ``want``: each layer's (T, k) picks)."""
    return sum(int((g.sort(-1).values != w.sort(-1).values).any(-1).sum())
               for g, w in zip(got, want))


def mesh_moe_layer_rank(grid, cfg, p, xs):
    """Phase 19 (c), one MoE layer on one rank: ``layers.moe_ffn_ep`` over
    the rank's slots of the whole layer ``p`` (the rule table's ("data",
    None, "model")) on each whole input of ``xs``: (2, S, D) a row a data
    rank (the all-to-all path), (1, 1, D) on every rank (the small-batch
    path).  Returns every row's output, the aux and the picks of each."""
    import torch
    from repro_torch.launch import specs as SP
    from repro_torch.models import layers as L
    from repro_torch.utils.sharding import DEFAULT_PARAM_RULES, tree_specs
    torch.backends.cuda.matmul.allow_tf32 = False
    mine = SP.shard_tree({"moe": p}, tree_specs({"moe": p},
                                                DEFAULT_PARAM_RULES, grid),
                         grid)["moe"]
    mine = {k: {n: t.to(grid.device) for n, t in v.items()}
            for k, v in mine.items()}
    dp, d = grid.data.size, grid.data.rank
    out = []
    with torch.no_grad():
        for x in xs:
            x = x.to(grid.device)
            split = x.shape[0] % dp == 0
            n = x.shape[0] // dp
            with RecordedPicks() as rec:
                y, aux = L.moe_ffn_ep(mine, x[d * n:(d + 1) * n] if split
                                      else x, cfg, grid.replace(rows_split=split))
            picks = rec.picks[0]
            if split:
                y = torch.cat(list(grid.data.all_gather([y])[0].unbind(0)))
                picks = torch.cat(list(grid.data.all_gather(
                    [picks.to(x.device)])[0].unbind(0))).cpu()
            out.append((y.cpu(), float(aux), picks))
    del mine
    torch.cuda.empty_cache()
    return out


def rows_alike(got, want, rows):
    """Per row of a batch of ``rows``: whether every token of it picked
    the same experts in every layer (``got`` / ``want``: each layer's
    (T, k) picks, T = rows · tokens a row)."""
    out = None
    for g, w in zip(got, want):
        same = (g.sort(-1).values == w.sort(-1).values).all(-1)
        same = same.reshape(rows, -1).all(-1)
        out = same if out is None else out & same
    return out


def mesh_moe_model(torch, pool, cfg, params, tokens, prompt):
    """(c)'s model in ``cfg``'s dtype: the 2 x S prefill (a row a data
    rank), the one-row prompt and its decode step on the grid beside the
    unsharded path.  Returns (the report, the unsharded run's recorded
    router picks and inputs, every row's logits and whether each row of
    them was routed alike in every layer)."""
    from repro_torch.launch.serve import make_decode_step, make_prefill_step
    from repro_torch.models import model as M
    with torch.no_grad(), RecordedPicks(inputs=True) as rec:
        want_split, _ = make_prefill_step(cfg)(params, {"tokens": tokens})
        one, cache = make_prefill_step(cfg)(
            params, {"tokens": prompt}, cache_len=MESH_MOE_PROMPT + 1)
        want_step, _ = make_decode_step(cfg)(
            params, M.argmax_first(one), cache, MESH_MOE_PROMPT)
    del cache
    res = pool.run(mesh_moe_rank, cfg, params, tokens, prompt)
    n = MESH_MOE_DEPTH
    rows = [res[d * MESH_GRID[1]]["picks"] for d in range(MESH_GRID[0])]
    grid_picks = [torch.cat([r[i] for r in rows]) for i in range(n)]
    grid_picks += res[0]["picks"][n:]
    for r in res[1:]:
        check(all(torch.equal(r[k], res[0][k]) for k in ("split", "one",
                                                          "step")),
              "mesh (c): every rank returns the same logits for every row")
    E = cfg.n_experts * cfg.ep_fsplit
    check(all(r["slot_shape"][1] == E // MESH_GRID[0] for r in res),
          f"mesh (c): each rank holds {E // MESH_GRID[0]} of {E} slots")
    check(all(torch.isfinite(r[k]).all() for r in res
              for k in ("split", "one", "step")),
          "mesh (c): the grid's logits are finite")
    one_alike = rows_alike(grid_picks[n:2 * n], rec.picks[n:2 * n], 1)
    alike = {"split": rows_alike(grid_picks[:n], rec.picks[:n],
                                 MESH_GRID[0]),
             "one": one_alike,
             "step": one_alike & rows_alike(grid_picks[2 * n:],
                                            rec.picks[2 * n:], 1)}
    logits = {k: (res[0][k], w.cpu()) for k, w in
              (("split", want_split), ("one", one), ("step", want_step))}
    out = {"logits_rel_err": {k: rel_err(*v)[0] for k, v in logits.items()},
           "rows_routed_alike": {k: [bool(b) for b in a]
                                 for k, a in alike.items()},
           "token_layers_routed_otherwise": routed_otherwise(grid_picks,
                                                             rec.picks),
           "token_layers": sum(x.shape[0] for x in rec.picks),
           "slot_shape": res[0]["slot_shape"],
           "prefill_ms": [r["prefill_ms"] for r in res],
           "one_row_ms": [r["one_row_ms"] for r in res],
           "rank_peak_bytes": [r["peak_bytes"] for r in res],
           "rank_shard_bytes": [r["shard_bytes"] for r in res],
           "shard_s": [r["shard_s"] for r in res],
           "collectives": [r["collectives"] for r in res]}
    return out, rec, logits, alike


def mesh_moe(torch, pool):
    """Phase 19 (c): qwen3-moe-30b-a3b at full width, MESH_MOE_DEPTH
    layers, its expert slots over the data ranks and their d_ff over the
    model ranks, at a capacity where nothing drops: the model's 2 x S
    prefill (a row a data rank) and a one-row prompt and decode step (the
    small-batch path) on the grid beside the unsharded path.  In f32 the
    logits of every row routed alike in every layer are held within
    LOGITS_F32_TOL of max (the split prefill must keep a row); in bf16
    the grid's other summation order moves near-ties at the top-k
    boundary of the random router, so its logits and the tokens routed
    otherwise are printed.  Then the first MoE layer on the bf16 model's
    own inputs through ``moe_ffn_ep`` on the grid, held against
    ``moe_ffn_local``, f32 within LOGITS_F32_TOL of max and bf16 within
    TOL over the tokens routed alike, the picks equal in f32."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.utils import pytree as pt
    report = {"layers": MESH_MOE_DEPTH}
    for dn, dtype in (("f32", "float32"), ("bf16", None)):
        cfg, params = dense_model(torch, MESH_MOE, layers=MESH_MOE_DEPTH,
                                  dtype=dtype)
        tokens = dense_tokens(torch, cfg, MESH_GRID[0], MESH_MOE_S, seed=22)
        prompt = dense_tokens(torch, cfg, 1, MESH_MOE_PROMPT, seed=23)
        whole, row = moe_loads(torch, cfg, params, tokens)
        # the capacity factor at which neither a row's tokens (the grid's
        # shards) nor the batch's (the unsharded layer) drop a pick, in
        # quarters: C = ceil(k · T · cf / E) >= the most an expert takes
        need = max(row * cfg.n_experts / (cfg.top_k * MESH_MOE_S),
                   whole * cfg.n_experts / (cfg.top_k * 2 * MESH_MOE_S))
        cf = math.ceil(4 * need) / 4
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
        print(f"mesh (c) {MESH_MOE} {dn}: full width, {MESH_MOE_DEPTH} of "
              f"{get_config(MESH_MOE).n_layers} layers; an expert takes at "
              f"most {row} picks of a row's {MESH_MOE_S} tokens, {whole} of "
              f"both rows': capacity factor {cf}")
        out, rec, logits, alike = mesh_moe_model(torch, pool, cfg, params,
                                                 tokens, prompt)
        out.update(capacity_factor=cf,
                   max_expert_picks={"row": row, "both_rows": whole})
        if dn == "f32":
            check(bool(alike["split"].any()),
                  "mesh (c) model f32: a row of the 2 x S prefill routed "
                  "alike in every layer")
            held = {}
            for k, (got, want) in logits.items():
                if alike[k].any():
                    held[k] = rel_err(got[alike[k]], want[alike[k]])[0]
                    check(held[k] <= LOGITS_F32_TOL,
                          f"mesh (c) model f32 {k}: the grid's logits vs the "
                          f"unsharded path {held[k]:.3e} <= {LOGITS_F32_TOL} "
                          f"of max over {int(alike[k].sum())} of "
                          f"{alike[k].numel()} rows routed alike")
            out["held_rel_err"] = held
        print(f"mesh (c) {MESH_MOE} {dn} model [{GPU}]: " + json.dumps(out))
        report[f"{dn}_model"] = out
        if dn == "f32":
            del params, rec, logits
            free(torch)
    # the first MoE layer on the bf16 model's prefill and decode inputs
    x_split = rec.inputs[0].reshape(MESH_GRID[0], MESH_MOE_S, -1)
    x_one = rec.inputs[-MESH_MOE_DEPTH].reshape(1, 1, -1)
    layer = pt.tree_map(lambda t: t[0].clone(),
                        params["blocks"]["sub0"]["moe"])
    del params, rec, logits
    free(torch)
    for dn, dtype, tol in (("f32", torch.float32, LOGITS_F32_TOL),
                           ("bf16", torch.bfloat16, TOL["bfloat16"])):
        p = pt.tree_map(lambda t: t.to(dtype) if t.dtype != torch.float32
                        or dtype == torch.float32 else t.clone(), layer)
        ccfg = dataclasses.replace(cfg, dtype="float32" if dtype ==
                                   torch.float32 else "bfloat16")
        xs = [x_split.to(dtype), x_one.to(dtype)]
        with torch.no_grad():
            with RecordedPicks() as lrec:
                want = [L.moe_ffn_local(p, x, ccfg) for x in xs]
            # the grid's aux on the split path: the mean of each data
            # rank's own (the reference's pmean), not the batch's
            row_aux = [float(L.moe_router(p, x.reshape(-1, x.shape[-1]),
                                          ccfg)[2]) for x in xs[0]]
        want[0] = (want[0][0], sum(row_aux) / len(row_aux))
        aux_tol = 1e-5 if dtype == torch.float32 else tol
        res = pool.run(mesh_moe_layer_rank, ccfg, p, xs)
        out = {}
        for i, (name, (y0, a0)) in enumerate(zip(("split", "one"), want)):
            y0 = y0.reshape(-1, y0.shape[-1]).cpu()
            for r in res:
                y, aux, picks = r[i]
                y = y.reshape(-1, y.shape[-1])
                alike = (picks.sort(-1).values
                         == lrec.picks[i].sort(-1).values).all(-1)
                err = rel_err(y[alike], y0[alike])[0]
                aux_err = abs(aux - float(a0)) / abs(float(a0))
                if dtype == torch.float32:
                    check(bool(alike.all()), f"mesh (c) layer f32 {name}: "
                          f"every token routed alike on the grid")
                check(err <= tol and aux_err <= aux_tol,
                      f"mesh (c) layer {dn} {name}: "
                      f"moe_ffn_ep on the grid vs moe_ffn_local {err:.3e} <= "
                      f"{tol} of max over {int(alike.sum())} of "
                      f"{alike.numel()} tokens routed alike; aux "
                      f"{aux_err:.2e}")
            out[name] = {"rel_err": err, "aux_rel_err": aux_err,
                         "routed_otherwise": int((~alike).sum()),
                         "tokens": int(alike.numel())}
        print(f"mesh (c) first MoE layer {dn} [{GPU}]: " + json.dumps(out))
        report[f"layer_{dn}"] = out
        del p, xs, want
        free(torch)
    return report


def phase_mesh(torch, mesh_pool):
    """Phase 19: the 'model' axis on a 2 data x 2 model grid of 4 ranks
    sharing the card (``ClientPool(n_model=2, device="cuda")``, gloo),
    the pool ``mesh_pool`` started: (a) serving, (b) the production
    engine, (c) expert parallelism.  Returns the report and
    flash_attention's launches on the ranks."""
    from repro_torch.launch.mesh import grid_backend
    n_data, n_model = MESH_GRID
    backend = grid_backend(n_data * n_model, "cuda")
    print(f"mesh: {n_data} x {n_model} grid on {torch.cuda.device_count()} "
          f"card(s): {backend}")
    t0 = time.perf_counter()
    pool = mesh_pool.get()
    report = dict(mesh_pool.times, wait_s=time.perf_counter() - t0)
    try:
        report["serving"], flash = mesh_serving(torch, pool)
        report["engine"] = mesh_engine(torch, pool)
        report["moe"] = mesh_moe(torch, pool)
    except RuntimeError as e:
        raise CheckFailed(f"mesh: a rank failed:\n{e}")
    report["wall_s"] = time.perf_counter() - t0
    report["flash_launches"] = flash
    report["backend"] = backend
    print(f"mesh [{GPU}]: {backend}, pool start "
          f"{report['pool_start_s']:.1f} s and warm-up "
          f"{max(report['warm_s']):.1f} s on its thread, waited "
          f"{report['wait_s']:.1f} s for them; phase {report['wall_s']:.1f} "
          f"s, flash_attention {flash} launches on the ranks")
    return report, flash


# --- phase 20: the SSM, hybrid and encoder-decoder families on the grid ---

FAM_MAMBA = "mamba2-2.7b"
FAM_JAMBA = "jamba-v0.1-52b"
FAM_SEAMLESS = "seamless-m4t-large-v2"
FAM_MAMBA_S = 4096      # (a)'s prompt a row: one row a data rank
FAM_JAMBA_S = 2048      # (b)'s
FAM_FRAMES = 4096       # (c)'s frames into the encoder a row ...
FAM_TOKENS = 2048       # ... and its tokens into the decoder
FAM_NEW = 17            # greedy tokens in (a) and (c): 16 decode steps
FAM_JAMBA_NEW = 5       # in (b): 4 decode steps
FAM_MAMBA_F32_DEPTH = 8  # (a)'s f32 check and (d)'s engine, layers
FAM_JAMBA_F32_DEPTH = 2  # (b)'s f32 check: attention + dense, SSM + MoE
FAM_JAMBA_DEPTH = 8     # (b)'s bf16 run: one superblock
FAM_BUDGET_S = 90       # the phase's wall time


FAM_KEPT = {}            # on a rank: the shard fam_keep_rank cut


def fam_keep_rank(grid, cfg, params):
    """Cut the rank's shard of ``params`` and keep it on the rank for the
    next ``fam_serve_rank`` (given no params), so that the caller can
    free its whole copy first; returns the shard's bytes."""
    FAM_KEPT["shard"] = mesh_rank_start(grid, cfg, params)
    return FAM_KEPT["shard"][1]


def fam_serve_rank(grid, cfg, params, batch, n_new, record=False):
    """Phase 20 on one rank: its shard of ``params``; an encoder-decoder's
    encoder over the rank's rows of frames first (``model._encode`` on
    the grid: over the rank's heads, its output whole over the model
    row); the prefill step of the whole ``batch`` with room for ``n_new``
    tokens (ssd_scan and flash_attention over the rank's heads), then
    ``n_new`` - 1 greedy decode steps with the encoder's output, every
    row's logits gathered; ``params`` None: the shard ``fam_keep_rank``
    kept.  With ``record``, every MoE layer's router picks of the rank's
    rows, call after call.  Returns host copies, the times, launches,
    peak and the collectives' readings."""
    import torch
    from repro_torch.launch.serve import (_rows, make_decode_step,
                                          make_prefill_step)
    from repro_torch.models import model as M
    if params is None:
        mine, shard_bytes, shard_s = FAM_KEPT.pop("shard")
        torch.cuda.reset_peak_memory_stats()
    else:
        mine, shard_bytes, shard_s = mesh_rank_start(grid, cfg, params)
    prefill, decode = make_prefill_step(cfg, grid), make_decode_step(cfg, grid)
    S = batch["tokens"].shape[1]
    before = stats_copy(grid.stats)
    reset_launches()
    with torch.no_grad(), RecordedPicks() as rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = None
        if cfg.n_enc_layers:
            local, rows = _rows(batch, grid)
            enc = M._encode(mine, local["frontend_emb"], cfg, mesh=rows)
        logits, cache = prefill(mine, batch, enc_out=enc,
                                cache_len=S + n_new)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        first, steps = logits.cpu(), []
        tok = M.argmax_first(logits)
        toks = [tok]
        for i in range(n_new - 1):
            logits, cache = decode(mine, tok, cache, S + i, enc_out=enc)
            steps.append(logits.cpu())
            tok = M.argmax_first(logits)
            toks.append(tok)
        toks = torch.stack(toks, dim=1).cpu()
        t2 = time.perf_counter()
    launches = read_launches()
    out = {"logits": first, "steps": steps if record else [],
           "tokens": toks, "picks": rec.picks if record else [],
           "prefill_ms": 1e3 * (t1 - t0),
           "decode_step_ms": 1e3 * (t2 - t1) / max(n_new - 1, 1),
           "launches": {k: v for k, v in launches.items() if v},
           "shard_bytes": shard_bytes, "shard_s": shard_s,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "collectives": stats_delta(before, grid.stats)}
    del mine, cache, logits, enc
    torch.cuda.empty_cache()
    return out


def fam_unsharded(torch, cfg, params, batch, n_new):
    """The unsharded path on the same card, as ``fam_serve_rank`` runs
    the grid (the encoder, the prefill, greedy decode steps with its
    output): (prefill logits, the decode steps' logits, the tokens, the
    router's picks)."""
    from repro_torch.models import model as M
    S = batch["tokens"].shape[1]
    with torch.no_grad(), RecordedPicks() as rec:
        enc = (M._encode(params, batch["frontend_emb"], cfg)
               if cfg.n_enc_layers else None)
        logits, cache = M.prefill(params, batch, cfg, cache_len=S + n_new,
                                  enc_out=enc)
        first, steps = logits.cpu(), []
        tok = M.argmax_first(logits)
        toks = [tok]
        for i in range(n_new - 1):
            logits, cache = M.decode_step(params, tok, cache, S + i, cfg,
                                          enc_out=enc)
            steps.append(logits.cpu())
            tok = M.argmax_first(logits)
            toks.append(tok)
    del cache, enc
    return first, steps, torch.stack(toks, dim=1).cpu(), rec.picks


def fam_expect(cfg):
    """Each kernel's launches in one prefill on a rank: ssd_scan once an
    SSM layer, flash_attention once an attention layer (an
    encoder-decoder's: an encoder layer, and self- and cross-attention a
    decoder layer)."""
    if cfg.n_enc_layers:
        return {"flash_attention": mm_flash_per_prefill(cfg)}
    n = mixer_counts(cfg)
    return {k: v for k, v in (("ssd_scan", n["ssm"]),
                              ("flash_attention", n["attn"])) if v}


def fam_alike(res, want_picks, rows, n_moe, n_steps):
    """Per row of the grid's run: whether every token of it picked the
    same experts as the unsharded run's in every MoE layer of the prefill
    (``[0]``) and of it and every decode step up to step j (``[j + 1]``)."""
    import torch
    n_model = MESH_GRID[1]
    per = [res[d * n_model]["picks"] for d in range(MESH_GRID[0])]
    got = [torch.cat([p[i] for p in per]) for i in range(len(per[0]))]
    out = [rows_alike(got[:n_moe], want_picks[:n_moe], rows)]
    for j in range(n_steps):
        a, b = n_moe * (j + 1), n_moe * (j + 2)
        out.append(out[-1] & rows_alike(got[a:b], want_picks[a:b], rows))
    return out, routed_otherwise(got, want_picks)


def fam_run(torch, pool, arch, cfg, params, batch, depth, dn, tol, n_new):
    """One depth of (a), (b) or (c): the grid beside the unsharded path
    (``tol`` None: the grid alone, reported; ``params`` None: on the
    shards ``fam_keep_rank`` kept).  Held: every rank returns
    the same logits and tokens; each rank launches ssd_scan and
    flash_attention ``fam_expect`` times; with ``tol``, the prefill
    logits within it of max of the unsharded path's (an MoE model's over
    the rows routed alike in every layer, its decode steps' too), and
    with f32 weights the greedy tokens equal.  Returns the report and
    the ranks' launches."""
    from repro_torch.utils import pytree as pt
    label = f"{depth} layers {dn}"
    moe = bool(cfg.n_experts)
    want = None
    if tol is not None:                 # the unsharded path first, alone
        want = fam_unsharded(torch, cfg, params, batch, n_new)
    t0 = time.perf_counter()
    res = pool.run(fam_serve_rank, cfg, params, batch, n_new, moe)
    wall = time.perf_counter() - t0
    for r in res[1:]:
        check(torch.equal(r["logits"], res[0]["logits"])
              and torch.equal(r["tokens"], res[0]["tokens"]),
              f"mesh {arch} {label}: every rank returns the same logits "
              f"and tokens for every row")
    expect = fam_expect(cfg)
    for r, x in enumerate(res):
        check(x["launches"] == expect, f"mesh {arch} {label}: rank {r} "
              f"launched {x['launches']} = {expect} (one prefill over its "
              f"heads)")
    check(all(torch.isfinite(r["logits"]).all() for r in res),
          f"mesh {arch} {label}: the grid's logits are finite")
    B = batch["tokens"].shape[0]
    out = {"layers": depth, "rows": B,
           "prompt": {k: list(v.shape[:2]) for k, v in batch.items()},
           "grid_wall_s": wall,
           "prefill_ms": [r["prefill_ms"] for r in res],
           "decode_step_ms": [r["decode_step_ms"] for r in res],
           "rank_peak_bytes": [r["peak_bytes"] for r in res],
           "rank_shard_bytes": [r["shard_bytes"] for r in res],
           "shard_s": [r["shard_s"] for r in res],
           "launches": [r["launches"] for r in res],
           "collectives": [r["collectives"] for r in res]}
    if moe:
        out["capacity_factor"] = cfg.capacity_factor
    if want is not None:
        first, steps, toks, picks = want
        rows = torch.ones(B, dtype=torch.bool)
        if moe:
            n_moe = sum(t.shape[0] if t.dim() == 3 else 1 for p, t in
                        pt.tree_leaves_with_path(params)
                        if p.endswith("router/kernel"))
            alike, flips = fam_alike(res, picks, B, n_moe, n_new - 1)
            rows = alike[0]
            out["rows_routed_alike"] = [[bool(b) for b in a] for a in alike]
            out["token_layers_routed_otherwise"] = flips
            out["token_layers"] = sum(x.shape[0] for x in picks)
            check(bool(rows.any()), f"mesh {arch} {label}: a row of the "
                  f"prefill routed alike in every layer")
            errs = [rel_err(r[a], w[a])[0] for r, w, a in zip(
                res[0]["steps"], steps, alike[1:]) if a.any()]
            out["decode_logits_rel_err"] = max(errs, default=None)
            check(all(e <= tol for e in errs), f"mesh {arch} {label}: the "
                  f"decode steps' logits on the grid vs the unsharded "
                  f"path {errs} <= {tol} of max over the rows routed alike")
        err = rel_err(res[0]["logits"][rows], first[rows])[0]
        check(err <= tol, f"mesh {arch} {label}: prefill logits on the "
              f"grid vs the unsharded path {err:.3e} <= {tol} of max "
              f"|logit| over {int(rows.sum())} of {B} rows")
        out["logits_rel_err"] = err
        if dn == "f32" and n_new > 1:
            check(torch.equal(toks[rows], res[0]["tokens"][rows]),
                  f"mesh {arch} {label}: {n_new} greedy tokens on the grid "
                  f"equal the unsharded path's")
            out["greedy_tokens_equal"] = n_new
    print(f"mesh 20 {arch} {label} [{GPU}]: " + json.dumps(out))
    return out, [r["launches"] for r in res]


def fam_depths(torch, pool, arch, cfg, params, batch, runs):
    """``runs`` of (dtype name, depth, tol, new tokens) through
    ``fam_run``, each on ``params`` cut to its first layers (cast to f32
    for an f32 run).  Returns the report and the launches summed over
    the ranks and runs."""
    from repro_torch.utils import pytree as pt
    report, launches = {}, {}
    for dn, depth, tol, n_new in runs:
        cut, ccfg = (params, cfg) if depth == cfg.n_layers else \
            first_layers(params, cfg, depth)
        if dn == "f32" and cfg.dtype != "float32":
            cut = pt.tree_map(lambda t: t.float(), cut)
            ccfg = dataclasses.replace(ccfg, dtype="float32")
        report[f"{depth} layers {dn}"], ls = fam_run(
            torch, pool, arch, ccfg, cut, batch, depth, dn, tol, n_new)
        for rank in ls:
            for k, v in rank.items():
                launches[k] = launches.get(k, 0) + v
        del cut
        free(torch)
    return report, launches


def fam_mamba(torch, pool):
    """(a): mamba2-2.7b at full width, 2 x 4096 a row a data rank, each
    rank's 40 of 80 heads through ssd_scan once a layer: f32 at 8 layers
    held within LOGITS_F32_TOL and its 17 greedy tokens, bf16 at
    CHECK_DEPTH within TOL, all 64 layers in bf16 reported."""
    cfg, params = dense_model(torch, FAM_MAMBA)
    batch = {"tokens": dense_tokens(torch, cfg, MESH_GRID[0], FAM_MAMBA_S,
                                    seed=24)}
    out = fam_depths(torch, pool, FAM_MAMBA, cfg, params, batch, (
        ("f32", FAM_MAMBA_F32_DEPTH, LOGITS_F32_TOL, FAM_NEW),
        ("bf16", CHECK_DEPTH, TOL["bfloat16"], 1),
        ("bf16", cfg.n_layers, None, FAM_NEW)))
    del params
    free(torch)
    return out


def fam_jamba(torch, pool):
    """(b): jamba-v0.1-52b at full width, 2 x 2048 a row a data rank, at
    the drop-free capacity (E / k: no slot drops a token, on the grid's
    shards or the unsharded batch): the first 2 layers (attention +
    dense, SSM + MoE) in f32, drawn apart so that the grid and the
    unsharded run fit the card together, held within LOGITS_F32_TOL over
    the rows routed alike (prefill and 4 decode steps); one superblock
    of 8 layers (1 attention, 7 SSM, 4 MoE) in bf16 reported, its
    shards cut before this process frees its whole copy (15.3 B
    parameters: the copy and the ranks' prefills do not fit together)."""
    cfg, params = dense_model(torch, FAM_JAMBA, layers=FAM_JAMBA_F32_DEPTH,
                              dtype="float32", seed=25)
    cfg = drop_free(cfg)
    batch = {"tokens": dense_tokens(torch, cfg, MESH_GRID[0], FAM_JAMBA_S,
                                    seed=26)}
    report, launches = fam_depths(
        torch, pool, FAM_JAMBA, cfg, params, batch,
        (("f32", FAM_JAMBA_F32_DEPTH, LOGITS_F32_TOL, FAM_JAMBA_NEW),))
    del params
    free(torch)
    cfg, params = dense_model(torch, FAM_JAMBA, layers=FAM_JAMBA_DEPTH,
                              seed=25)
    cfg = drop_free(cfg)
    pool.run(fam_keep_rank, cfg, params)
    del params
    free(torch)
    label = f"{FAM_JAMBA_DEPTH} layers bf16"
    report[label], ls = fam_run(torch, pool, FAM_JAMBA, cfg, None, batch,
                                FAM_JAMBA_DEPTH, "bf16", None, FAM_JAMBA_NEW)
    for rank in ls:
        for k, v in rank.items():
            launches[k] = launches.get(k, 0) + v
    return report, launches


def fam_seamless(torch, pool):
    """(c): seamless-m4t-large-v2 at full width, 2 rows of 4096 frames +
    2048 tokens a row a data rank, the rank's 8 of 16 heads through
    flash_attention in every encoder layer (non-causal) and in the
    decoder's self- (causal) and cross-attention, then 16 greedy decode
    steps with the encoder's output: f32 at 24 + 24 layers held within
    LOGITS_F32_TOL and its tokens, bf16 at CHECK_DEPTH + CHECK_DEPTH
    within TOL."""
    cfg, params = dense_model(torch, FAM_SEAMLESS, dtype="float32")
    batch = mm_batch(torch, cfg, MESH_GRID[0], FAM_FRAMES, FAM_TOKENS,
                     seed=27)
    report, launches = fam_depths(torch, pool, FAM_SEAMLESS, cfg, params,
                                  batch, (("f32", cfg.n_layers,
                                           LOGITS_F32_TOL, FAM_NEW),))
    del params
    free(torch)
    cfg, params = dense_model(torch, FAM_SEAMLESS, layers=CHECK_DEPTH)
    r, ls = fam_depths(torch, pool, FAM_SEAMLESS, cfg, params, batch,
                       (("bf16", CHECK_DEPTH, TOL["bfloat16"], 1),))
    report.update(r)
    for k, v in ls.items():
        launches[k] = launches.get(k, 0) + v
    del params
    free(torch)
    return report, launches


def phase_families(torch, mesh_pool):
    """Phase 20: mamba2-2.7b, jamba-v0.1-52b and seamless-m4t-large-v2 on
    phase 19's 2 data x 2 model grid: (a)-(c) serving beside the
    unsharded path, (d) the production engine at mamba2's width against
    FedSim.  Returns the report and the ranks' ssd_scan and
    flash_attention launches."""
    t0 = time.perf_counter()
    pool = mesh_pool.get()
    report, launches = {}, {}
    try:
        for part, fn in (("mamba2", fam_mamba), ("jamba", fam_jamba),
                         ("seamless", fam_seamless)):
            t = time.perf_counter()
            report[part], ls = fn(torch, pool)
            report[part]["wall_s"] = time.perf_counter() - t
            for k, v in ls.items():
                launches[k] = launches.get(k, 0) + v
        t = time.perf_counter()
        report["engine"] = mesh_engine(torch, pool, FAM_MAMBA,
                                       FAM_MAMBA_F32_DEPTH, "20 (d)")
        report["engine"]["wall_s"] = time.perf_counter() - t
    except RuntimeError as e:
        raise CheckFailed(f"mesh 20: a rank failed:\n{e}")
    report["wall_s"] = time.perf_counter() - t0
    report["launches"] = launches
    print(f"mesh 20 [{GPU}]: phase {report['wall_s']:.1f} s (mamba2 "
          f"{report['mamba2']['wall_s']:.1f}, jamba "
          f"{report['jamba']['wall_s']:.1f}, seamless "
          f"{report['seamless']['wall_s']:.1f}, engine "
          f"{report['engine']['wall_s']:.1f}); launches on the ranks "
          f"{launches}")
    return report, launches


# --- phase 21: the sequence-split cache and the grid's account -------------

SEQ_ARCH = "gemma3-1b"  # (a): one kv head, local rings of 512, global layers
SEQ_BIG = "granite-34b"     # (b): MQA, 48 heads
SEQ_BIG_DEPTH = 4       # (b)'s layers of full width (of 88)
SEQ_S = 4096            # the prompt a row: one row a data rank
SEQ_NEW = 16            # greedy tokens: a cache of 4112 slots, 2056 a rank
SEQ_ACCOUNT_LLAMA = 8   # (c): phase 19's llama2-7b prefill step, layers
SEQ_BUDGET_S = 90       # the phase's wall time


def seq_serve_rank(grid, cfg, params, tokens, n_new, seq, feed=None):
    """Phase 21 (a), (b) on one rank: its shard of ``params``; with
    ``seq`` the grid's ``seq_shard_kv`` layout (the cache split on its
    sequence over the model row), else the default (the one kv head whole
    on every rank); the prefill step of the whole (B, S) ``tokens`` with
    room for ``n_new`` tokens, then ``n_new`` - 1 decode steps fed the
    greedy tokens (or the (B, n_new) ``feed``), every row's logits of
    every step.  Returns host copies, the times, the rank's cache bytes,
    launches, peak and the collectives' readings."""
    import torch
    from repro_torch.launch.serve import make_decode_step, make_prefill_step
    from repro_torch.models import model as M
    from repro_torch.utils import pytree as pt
    mine, shard_bytes, shard_s = mesh_rank_start(grid, cfg, params)
    S = tokens.shape[1]
    g = grid.replace(seq_shard_kv=seq, kv_len=S + n_new)
    prefill, decode = make_prefill_step(cfg, g), make_decode_step(cfg, g)
    before = stats_copy(grid.stats)
    reset_launches()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(mine, {"tokens": tokens}, cache_len=S + n_new)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mid = stats_copy(grid.stats)
        cache_bytes = sum(x.numel() * x.element_size()
                          for x in pt.tree_leaves(cache))
        steps, toks = [logits], [M.argmax_first(logits)]
        for i in range(n_new - 1):
            tok = toks[-1] if feed is None else feed[:, i].to(grid.device)
            logits, cache = decode(mine, tok, cache, S + i)
            steps.append(logits)
            toks.append(M.argmax_first(logits))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    launches = read_launches()
    out = {"steps": torch.stack(steps).cpu(),
           "tokens": torch.stack(toks, dim=1).cpu(),
           "prefill_ms": 1e3 * (t1 - t0),
           "decode_step_ms": 1e3 * (t2 - t1) / max(n_new - 1, 1),
           "cache_bytes": cache_bytes,
           "launches": {k: v for k, v in launches.items() if v},
           "shard_bytes": shard_bytes, "shard_s": shard_s,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "prefill_collectives": stats_delta(before, mid),
           "decode_collectives": stats_delta(mid, grid.stats)}
    del mine, cache, logits, steps
    torch.cuda.empty_cache()
    return out


def seq_per_step(colls, n_steps):
    """The collectives' bytes a decode step sends, per group and op."""
    return {f"{g}/{op}": v["bytes"] / n_steps for g, ops in colls.items()
            for op, v in ops.items() if v["calls"]}


def seq_run(torch, pool, label, cfg, params, tokens, tol, feed=False,
            layouts=(True, False)):
    """One model of (a) or (b): the unsharded path on the same card, then
    the grid on the sequence-split layout (and the default one, timed).
    Held: every rank returns the same logits and tokens; every step's
    logits within ``tol`` of max of the unsharded path's (with ``feed``,
    both fed the unsharded path's tokens, else the greedy tokens equal);
    each rank's cache half the default layout's; the prefill launches
    flash_attention once an attention layer on every rank.  Returns the
    report and the ranks' flash launches."""
    want_first, want_steps, want_toks, _ = fam_unsharded(
        torch, cfg, params, {"tokens": tokens}, SEQ_NEW)
    want = torch.stack([want_first] + want_steps)
    free(torch)
    out, flash, res = {"layers": cfg.n_layers, "dtype": cfg.dtype}, 0, {}
    for seq in layouts:
        name = "seq" if seq else "default"
        res[name] = pool.run(seq_serve_rank, cfg, params, tokens, SEQ_NEW,
                             seq, want_toks if feed else None)
        for r in res[name][1:]:
            check(torch.equal(r["steps"], res[name][0]["steps"])
                  and torch.equal(r["tokens"], res[name][0]["tokens"]),
                  f"seq {label} {name}: every rank returns the same logits "
                  f"and tokens")
        n = [r["launches"].get("flash_attention", 0) for r in res[name]]
        check(n == [cfg.n_layers] * len(n), f"seq {label} {name}: "
              f"flash_attention launched {n} times on the ranks = "
              f"{cfg.n_layers} (once an attention layer of the prefill)")
        flash += sum(n)
        steps = SEQ_NEW - 1
        out[name] = {
            "prefill_ms": [r["prefill_ms"] for r in res[name]],
            "decode_step_ms": [r["decode_step_ms"] for r in res[name]],
            "rank_cache_bytes": [r["cache_bytes"] for r in res[name]],
            "rank_peak_bytes": [r["peak_bytes"] for r in res[name]],
            "rank_shard_bytes": [r["shard_bytes"] for r in res[name]],
            "decode_bytes_per_step": seq_per_step(
                res[name][0]["decode_collectives"], steps),
            "decode_calls_per_step": {
                f"{g}/{op}": v["calls"] / steps for g, ops in
                res[name][0]["decode_collectives"].items()
                for op, v in ops.items() if v["calls"]},
            "launches": [r["launches"] for r in res[name]]}
        if seq:
            err = max(rel_err(res[name][0]["steps"][i], want[i].cpu())[0]
                      for i in range(want.shape[0]))
            check(err <= tol, f"seq {label}: every step's logits on the "
                  f"sequence-split cache vs the unsharded path {err:.3e} <= "
                  f"{tol} of max |logit|")
            out["logits_rel_err"] = err
            if not feed:
                check(torch.equal(res[name][0]["tokens"], want_toks),
                      f"seq {label}: {SEQ_NEW} greedy tokens on the "
                      f"sequence-split cache equal the unsharded path's")
                out["greedy_tokens_equal"] = SEQ_NEW
    if len(layouts) == 2:
        for a, b in zip(res["seq"], res["default"]):
            check(2 * a["cache_bytes"] == b["cache_bytes"],
                  f"seq {label}: a rank's sequence-split cache "
                  f"{a['cache_bytes']} bytes is half its whole cache's "
                  f"{b['cache_bytes']}")
    print(f"seq {label} [{GPU}]: " + json.dumps(out))
    return out, flash


def seq_account_rank(grid, cfg, shape, seq):
    """Phase 21 (c) on one rank: its meta account on a meta grid at its
    place (``launch.dryrun.account``), then the same step on the card
    from ``dryrun.step_and_inputs`` on the rank's grid (its shard built
    whole on the card and cut), run once: the growth of
    max_memory_allocated across the step after its inputs, and the
    collectives it issued (the rank's stats zeroed before it)."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_meta_grid
    torch.backends.cuda.matmul.allow_tf32 = False
    meta = make_meta_grid(grid.shape["data"], grid.shape["model"],
                          rank=grid.rank)
    t0 = time.perf_counter()
    acc = dryrun.account(cfg, shape, grid=meta, seq_shard_kv=seq)
    t_meta = time.perf_counter() - t0
    step, make_args = dryrun.step_and_inputs(cfg, shape, device=grid.device,
                                             grid=grid, seq_shard_kv=seq)
    gc.collect()
    torch.cuda.empty_cache()
    args = make_args()
    torch.cuda.synchronize()
    m2 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dryrun.zero_stats(grid)
    reset_launches()
    t0 = time.perf_counter()
    out = step(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    grew = torch.cuda.max_memory_allocated() - m2
    colls = dryrun.collectives(grid)
    finite = bool(torch.isfinite(out[0]).all())
    del out, args
    torch.cuda.empty_cache()
    return {"account": acc["memory"], "account_collectives":
            acc["collectives"], "account_s": t_meta, "card_step_bytes": grew,
            "card_collectives": colls, "step_wall_s": wall,
            "finite": finite,
            "launches": {k: v for k, v in read_launches().items() if v}}


def seq_account(torch, pool, gemma_cfg):
    """Phase 21 (c): (a)'s prefill step and one sequence-split decode
    step at gemma3-1b's full config, and phase 19's llama2-7b prefill
    step at 8 layers, each rank against its meta account: the step's
    allocation within DRY_STEP_TOL or DRY_STEP_FLOOR of peak_estimate −
    argument_bytes, the collectives' calls and bytes equal exactly."""
    from repro_torch.configs import InputShape, get_config
    B = MESH_GRID[0]
    llama = dataclasses.replace(get_config(MESH_ARCH),
                                n_layers=SEQ_ACCOUNT_LLAMA)
    cases = (("gemma3-1b prefill", gemma_cfg,
              InputShape("p21", SEQ_S, B, "prefill"), False,
              gemma_cfg.n_layers),
             ("gemma3-1b sequence-split decode", gemma_cfg,
              InputShape("d21", SEQ_S + SEQ_NEW, B, "decode"), True, 0),
             (f"{MESH_ARCH} prefill", llama,
              InputShape("p21", SEQ_S, B, "prefill"), False,
              llama.n_layers))
    report, flash = {}, 0
    for label, cfg, shape, seq, n_flash in cases:
        free(torch)
        res = pool.run(seq_account_rank, cfg, shape, seq)
        rows = []
        for r, x in enumerate(res):
            mem = x["account"]
            want = mem["peak_estimate_bytes"] - mem["argument_bytes"]
            bound = max(DRY_STEP_TOL * want, DRY_STEP_FLOOR)
            check(abs(x["card_step_bytes"] - want) <= bound,
                  f"seq (c) {label}, rank {r}: the step allocates "
                  f"{x['card_step_bytes']} bytes on the card, its meta "
                  f"account {want} (off by {x['card_step_bytes'] - want}, "
                  f"bound {bound:.0f})")
            check(x["card_collectives"] == x["account_collectives"],
                  f"seq (c) {label}, rank {r}: the collectives on the card "
                  f"{x['card_collectives']} = the meta account's "
                  f"{x['account_collectives']}")
            check(x["finite"], f"seq (c) {label}, rank {r}: finite logits")
            n = x["launches"].get("flash_attention", 0)
            check(n == n_flash, f"seq (c) {label}, rank {r}: flash_attention "
                  f"launched {n} times = {n_flash}")
            flash += n
            rows.append({"card_step_bytes": x["card_step_bytes"],
                         "account_step_bytes": want,
                         "step_off_bytes": x["card_step_bytes"] - want,
                         "collective_bytes": x["card_collectives"]["total"],
                         "account_s": x["account_s"],
                         "step_wall_s": x["step_wall_s"]})
        report[label] = rows
        print(f"seq (c) {label} [{GPU}]: " + json.dumps(rows))
    return report, flash


def phase_seq(torch, mesh_pool):
    """Phase 21: the sequence-split KV cache and the grid's account on
    phase 19's 2 data x 2 model grid.  Returns the report and the ranks'
    flash_attention launches."""
    from repro_torch.utils import pytree as pt
    t0 = time.perf_counter()
    pool = mesh_pool.get()
    report, flash = {}, 0
    try:
        t = time.perf_counter()
        cfg, params = dense_model(torch, SEQ_ARCH)
        tokens = dense_tokens(torch, cfg, MESH_GRID[0], SEQ_S, seed=21)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        p32 = pt.tree_map(lambda x: x.float(), params)
        report["gemma_f32"], n = seq_run(
            torch, pool, f"(a) {SEQ_ARCH} {cfg.n_layers} layers f32", cfg32,
            p32, tokens, LOGITS_F32_TOL)
        flash += n
        del p32
        free(torch)
        cut, ccfg = first_layers(params, cfg, CHECK_DEPTH)
        report["gemma_bf16"], n = seq_run(
            torch, pool, f"(a) {SEQ_ARCH} {CHECK_DEPTH} layers bf16", ccfg,
            cut, tokens, TOL["bfloat16"], feed=True, layouts=(True,))
        flash += n
        del cut, params
        free(torch)
        report["gemma_wall_s"] = time.perf_counter() - t
        t = time.perf_counter()
        bcfg, bparams = dense_model(torch, SEQ_BIG, layers=SEQ_BIG_DEPTH,
                                    dtype="float32")
        btok = dense_tokens(torch, bcfg, MESH_GRID[0], SEQ_S, seed=22)
        report["granite_f32"], n = seq_run(
            torch, pool, f"(b) {SEQ_BIG} {SEQ_BIG_DEPTH} layers f32", bcfg,
            bparams, btok, LOGITS_F32_TOL)
        flash += n
        del bparams
        free(torch)
        report["granite_wall_s"] = time.perf_counter() - t
        t = time.perf_counter()
        report["account"], n = seq_account(torch, pool, cfg)
        flash += n
        report["account_wall_s"] = time.perf_counter() - t
    except RuntimeError as e:
        raise CheckFailed(f"seq: a rank failed:\n{e}")
    report["wall_s"] = time.perf_counter() - t0
    report["flash_launches"] = flash
    print(f"seq [{GPU}]: phase {report['wall_s']:.1f} s ((a) "
          f"{report['gemma_wall_s']:.1f}, (b) {report['granite_wall_s']:.1f},"
          f" (c) {report['account_wall_s']:.1f}); flash_attention {flash} "
          f"launches on the ranks")
    return report, flash


def kernel_entry(name, src, replaces, launches, row, shape, extra=None):
    keys = ("ms", "plain_ms", "library_ms", "eager_ms", "eager_plain_ms",
            "eager_library_ms")
    out = {"name": name, "route": "cuda", "source": src,
           "replaces": replaces, "launches": launches,
           "max_abs_err": row["max_abs_err"], "rel_err": row["rel_err"],
           "tolerance": row["tolerance"], "shape": shape,
           "ms": row["ms"], "plain_ms": row["plain_ms"],
           "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
           "library_ms": row["library_ms"], "eager_ms": row["eager_ms"],
           "ranges_ms": {k: row[k + "_range"] for k in keys}}
    out.update(extra or {})
    return out


def mesh_only(torch):
    """``--mesh-only``: phases 19, 20 and 21 alone, on every card there is
    (the grid on NCCL when each rank has a card of its own), after
    building flash_attention and ssd_scan; prints their reports.  Not
    the chip check: that is the run with no arguments."""
    from repro_torch.kernels import _build
    _build.build_all(["flash_attention", "ssd_scan"])
    workdir = ROOT / "build" / "phase19"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    t0 = time.perf_counter()
    mesh_pool = MeshPool(workdir)
    try:
        report, flash = phase_mesh(torch, mesh_pool)
        t19 = time.perf_counter() - t0
        families, _ = phase_families(torch, mesh_pool)
        seq, _ = phase_seq(torch, mesh_pool)
    except CheckFailed as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        mesh_pool.close()
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"phase 19 (the model axis) took {t19:.1f} s, phase 20 "
          f"{families['wall_s']:.1f} s, phase 21 {seq['wall_s']:.1f} s on "
          f"{torch.cuda.device_count()} card(s)")
    print(json.dumps({"mesh": report, "families": families, "seq": seq}))
    print(f"gpu: {GPU}")
    return 0


def main():
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print(f"FAIL: {ROOT} is not a checkout of the repository "
              f"(src/repro_torch is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    global GPU
    gpu = GPU = gpu_line()
    print(f"gpu: {gpu}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    # the host-bound phases' times move with the host's free cores
    print(f"host: {len(os.sched_getaffinity(0))} cores usable, "
          f"{torch.get_num_threads()} torch threads, load average "
          f"{os.getloadavg()[0]:.2f}")
    t_start = time.perf_counter()
    if "--mesh-only" in sys.argv[1:]:
        return mesh_only(torch)
    dry_proc = mesh_pool = None
    try:
        t0 = time.perf_counter()
        libs = _build.build_all()
        print(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
        for name in libs:
            print(f"--- nvcc log {name} ---\n"
                  + _build.log_path(name).read_text().strip())
        bgmv_build = check_build(
            "bgmv", r"(?<=\d)bgmv_kernel(?=I)", "bgmv_kernel", 48,
            "pairs / magnitude x r buckets 8, 16, 32, 64 x aligned / general "
            "x f32, bf16, bf16 prefill; the last, whose template arguments "
            "end in MMA = true, on the tensor cores",
            tensor_core="Lb1EEEvPK")
        flash_build = check_build(
            "flash_attention", r"flash_[a-z_]+?_kernel", "flash_mma", 6,
            "bf16 mma and mma_decode at dh 64, 128, 256")
        fused_build = check_build(
            "fused_dora", r"(?<=\d)fused_dora_[a-z_]+(?=I)", "fused_dora_mma", 8,
            "bf16 mma and mma_decode at r buckets 8, 16, 32, 64")
        quant_build = check_build(
            "quant_matmul", r"(?<=\d)qmm_[a-z_]+(?=I)", "qmm_mma", 6,
            "bf16 qmm_mma int8 / int4 x per channel / grouped and "
            "qmm_mma_decode int8 / int4")
        ssd_build = check_build(
            "ssd_scan", r"(?<=\d)ssd_[a-z_]+(?=[IE])", "ssd_", 9,
            "ssd_cb, ssd_states (two builds for bf16), ssd_y: f32 simt and "
            "bf16 mma; ssd_pass: f32 in place, bf16 split; the mma builds on "
            "the tensor cores",
            tensor_core="_mma")
        t0 = time.perf_counter()
        rows = phase_kernels(torch)
        print(f"phase 2 took {time.perf_counter() - t0:.1f} s")
        dry_dir = ROOT / "build" / "phase18"    # (c)'s records
        shutil.rmtree(dry_dir, ignore_errors=True)
        dry_dir.mkdir(parents=True)
        dry_proc = start_dry_records(dry_dir)
        t0 = time.perf_counter()
        report, launches, ctx = phase_main_path(torch)
        print(f"phase 3 took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        report["fused"], launches["fused_dora"] = phase_fused_path(torch, ctx)
        print(f"phase 4 took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        report["training"], train_launches = phase_training(torch, ctx)
        launches["bgmv_mag"] += train_launches
        print(f"phase 7 (training) took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        report["baselines"], baseline_launches = phase_baselines(
            torch, cut_ctx(ctx, CUT_DEPTH))
        launches["bgmv"] += baseline_launches
        print(f"phase 8 (baselines) took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        report["fleet"], fleet_launches = phase_fleet(torch, ctx)
        for name, n in fleet_launches.items():
            launches[name] += n
        print(f"phase 9 (mixed-rank fleets) took "
              f"{time.perf_counter() - t0:.1f} s")
        workdir = ROOT / "build" / "phase10"    # phases 10 and 11's files
        shutil.rmtree(workdir, ignore_errors=True)
        workdir.mkdir(parents=True)
        try:
            t0 = time.perf_counter()
            ctx_cut = cut_ctx(ctx, CUT_DEPTH)     # phase 11 (a) serves it too
            report["persistence"], persist_launches, tier = \
                phase_persistence(torch, ctx_cut, workdir)
            launches["bgmv_mag"] += sum(persist_launches.values())
            print(f"phase 10 (persistence) took "
                  f"{time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            report["telemetry"], tel_launches = phase_telemetry(
                torch, ctx_cut, workdir, tier)
            launches["bgmv_mag"] += tel_launches
            del tier, ctx_cut
            gc.collect()
            torch.cuda.empty_cache()
            print(f"phase 11 (a) (telemetry) took "
                  f"{time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            report["cohort"], cohort_launches = phase_cohort(torch, ctx,
                                                             workdir)
            launches["bgmv"] += cohort_launches
            print(f"phase 11 (b) (cohort rounds) took "
                  f"{time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            (workdir / "engine").mkdir()
            report["engine"], engine_launches = phase_engine(
                torch, cut_ctx(ctx, CUT_DEPTH), workdir / "engine")
            launches["bgmv_mag"] += engine_launches
            t_engine = time.perf_counter() - t0
            print(f"phase 12 (production engine) took {t_engine:.1f} s")
            check(t_engine <= ENGINE_BUDGET_S, f"phase 12 took "
                  f"{t_engine:.1f} s <= {ENGINE_BUDGET_S} s")
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        del ctx["params"]
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        report["quant"], quant_launches = phase_quant_path(torch, ctx)
        print(f"phase 5 took {time.perf_counter() - t0:.1f} s")
        del ctx
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        standalone, launches_6 = phase_standalone(torch)
        print(f"phase 6 took {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        report["dense"], dense_launches = phase_dense(torch)
        launches["bgmv_mag"] += dense_launches["bgmv_mag"]
        print(f"phase 13 (dense family) took {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        report["moe"], moe_launches = phase_moe(torch)
        launches["bgmv_mag"] += moe_launches["bgmv_mag"]
        print(f"phase 14 (mixture of experts) took "
              f"{time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        report["ssm"], ssm_launches = phase_ssm(torch)
        launches["bgmv_mag"] += ssm_launches["bgmv_mag"]
        t_ssm = time.perf_counter() - t0
        print(f"phase 15 (SSM and hybrid) took {t_ssm:.1f} s")
        check(t_ssm <= SSM_BUDGET_S, f"phase 15 took {t_ssm:.1f} s <= "
              f"{SSM_BUDGET_S} s")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        report["mm"], mm_launches = phase_mm(torch)
        launches["bgmv_mag"] += mm_launches["bgmv_mag"]
        t_mm = time.perf_counter() - t0
        print(f"phase 16 (vision-language and encoder-decoder) took "
              f"{t_mm:.1f} s")
        check(t_mm <= MM_BUDGET_S, f"phase 16 took {t_mm:.1f} s <= "
              f"{MM_BUDGET_S} s")
        gc.collect()
        torch.cuda.empty_cache()
        mesh_dir = ROOT / "build" / "phase19"     # the grid's rendezvous
        shutil.rmtree(mesh_dir, ignore_errors=True)
        mesh_dir.mkdir(parents=True)
        mesh_pool = MeshPool(mesh_dir)  # phase 19's ranks start beside 17-18
        workdir = ROOT / "build" / "phase17"    # phase 17's cache and cwd
        shutil.rmtree(workdir, ignore_errors=True)
        workdir.mkdir(parents=True)
        try:
            t0 = time.perf_counter()
            report["tooling"], tooling_launches = phase_tooling(torch,
                                                                workdir)
            launches["bgmv_mag"] += tooling_launches
            t_tooling = time.perf_counter() - t0
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(f"phase 17 (pretraining, tooling and examples) took "
              f"{t_tooling:.1f} s")
        check(t_tooling <= TOOLING_BUDGET_S, f"phase 17 took "
              f"{t_tooling:.1f} s <= {TOOLING_BUDGET_S} s")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        report["dryrun"] = phase_dryrun(torch, dry_proc, dry_dir)
        t_dry = time.perf_counter() - t0
        print(f"phase 18 (the dry run against the card) took {t_dry:.1f} s")
        check(t_dry <= DRYRUN_BUDGET_S, f"phase 18 took {t_dry:.1f} s <= "
              f"{DRYRUN_BUDGET_S} s")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        report["mesh"], mesh_flash = phase_mesh(torch, mesh_pool)
        t_mesh = time.perf_counter() - t0
        print(f"phase 19 (the model axis) took {t_mesh:.1f} s")
        check(t_mesh <= MESH_BUDGET_S, f"phase 19 took {t_mesh:.1f} s <= "
              f"{MESH_BUDGET_S} s")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        report["families"], fam_launches = phase_families(torch, mesh_pool)
        t_fam = time.perf_counter() - t0
        print(f"phase 20 (the model axis: SSM, hybrid, encoder-decoder) "
              f"took {t_fam:.1f} s")
        check(t_fam <= FAM_BUDGET_S, f"phase 20 took {t_fam:.1f} s <= "
              f"{FAM_BUDGET_S} s")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        report["seq"], seq_flash = phase_seq(torch, mesh_pool)
        t_seq = time.perf_counter() - t0
        print(f"phase 21 (the sequence-split cache and the grid's account) "
              f"took {t_seq:.1f} s")
        check(t_seq <= SEQ_BUDGET_S, f"phase 21 took {t_seq:.1f} s <= "
              f"{SEQ_BUDGET_S} s")
    except CheckFailed as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        if dry_proc is not None and dry_proc.poll() is None:
            dry_proc.kill()
            dry_proc.communicate()
        if mesh_pool is not None:
            mesh_pool.close()
        shutil.rmtree(ROOT / "build" / "phase18", ignore_errors=True)
        shutil.rmtree(ROOT / "build" / "phase19", ignore_errors=True)

    kdir = "src/repro_torch/kernels"
    pallas = "src/repro/kernels"
    kernels = []
    for name, line in (("bgmv_mag", 223), ("bgmv", 134)):
        dec = rows[name]["decode"]
        kernels.append(kernel_entry(
            name, f"{kdir}/batched_lora/csrc/bgmv.cu",
            f"{pallas}/batched_lora/bgmv.py:{line}", launches[name], dec,
            "x (8, 4096) bf16, r 8, 9 slots, ranked (the decode step); "
            "variants: decode (B * S <= 16), prefill (tiles of 32 tokens)",
            {"variant": dec["variant"], "bound_ratio": dec["bound_ratio"],
             "factor_gbps": dec["factor_gbps"],
             "prefill": {k: rows[name]["prefill"][k] for k in
                         ("x", "variant", "ms", "plain_ms", "library_ms",
                          "bound_ms", "eager_ms", "bound_ratio",
                          "factor_gbps")},
             "build": bgmv_build,
             "launches_phase9_fleet_serve": fleet_launches[name],
             **({"launches_phase10_tiered_serve": persist_launches["tiered"],
                 "launches_phase13_dense_serve": dense_launches["bgmv_mag"],
                 "launches_phase10_flat_serve": persist_launches["flat"],
                 "launches_phase11_telemetry_serve": tel_launches,
                 "launches_phase12_engine_serve": engine_launches,
                 "launches_phase14_moe_serve": moe_launches["bgmv_mag"],
                 "launches_phase15_jamba_serve": ssm_launches["bgmv_mag"],
                 "launches_phase16_qwen2_vl_serve": mm_launches["bgmv_mag"],
                 "launches_phase17_serve_example": tooling_launches}
                if name == "bgmv_mag" else
                {"launches_phase11_cohort_serve": cohort_launches}),
             **({"launches_phase7_training_serve": train_launches}
                if name == "bgmv_mag" else
                {"launches_phase8_baselines_serve": baseline_launches})}))
    fd = rows["fused_dora"]
    kernels.append(kernel_entry(
        "fused_dora", f"{kdir}/fused_dora/csrc/fused_dora.cu",
        f"{pallas}/fused_dora/fused_dora.py:74", launches["fused_dora"],
        fd["decode"], "x (8, 4096) bf16, W0 (4096, 4096), r 8 (the decode "
        "step of path B1)",
        {"prefill": {k: fd["prefill"][k] for k in
                     ("x", "ms", "plain_ms", "library_ms", "bound_ms",
                      "bound_by", "f32_core_bound_ms", "eager_ms",
                      "bound_ratio", "tflops")},
         "bound_ratio": fd["decode"]["bound_ratio"],
         "w0_gbps": fd["decode"]["w0_gbps"], "build": fused_build}))
    qm = rows["quant_matmul"]
    kernels.append(kernel_entry(
        "quant_matmul", f"{kdir}/quant_matmul/csrc/quant_matmul.cu",
        f"{pallas}/quant_matmul/quant_matmul.py:60", quant_launches["int8"],
        qm["int8 decode {}x{}".format(*QUANT_SHAPES[0])],
        "x (8, 4096) bf16, int8 codes (4096, 4096), per channel (q/k/v/o at "
        "decode on path B4); variants: bf16 qmm_mma_decode (M <= 16), "
        "qmm_mma (M > 16), qmm_tiled for groups not a multiple of 16; f32 "
        "qmm_skinny, qmm_tiled",
        {"launches_int4": quant_launches["int4"],
         "variant": qm["int8 decode {}x{}".format(*QUANT_SHAPES[0])]["variant"],
         "bound_ratio": qm["int8 decode {}x{}".format(*QUANT_SHAPES[0])][
             "bound_ratio"],
         "shapes": {k: {f: v[f] for f in (
             "variant", "ms", "plain_ms", "library_ms", "bound_ms",
             "bound_by", "f32_core_bound_ms", "eager_ms", "bound_ratio",
             "tflops", "code_gbps")} for k, v in qm.items()},
         "build": quant_build}))
    fa = rows["flash_attention"]
    kernels.append(kernel_entry(
        "flash_attention", f"{kdir}/flash_attention/csrc/flash_attention.cu",
        f"{pallas}/flash_attention/flash_attention.py:87",
        dense_launches["flash_attention"] + moe_launches["flash_attention"]
        + ssm_launches["flash_attention"] + mm_launches["flash_attention"]
        + mesh_flash + fam_launches["flash_attention"] + seq_flash,
        fa["prefill"],
        "llama2-7b prefill: q, k, v (1, 4096, 32, 128) bf16, causal (phase 6 "
        "runs it with the other configs' shapes); launches: the prefills of "
        "phase 13 (llama2-7b, qwen3-32b, granite-34b, gemma3-1b at 1 x "
        "4096), phase 14 (qwen3-moe-30b-a3b 1 x 4096, mixtral-8x22b 1 x "
        "8192), phase 15 (jamba-v0.1-52b's attention layers, 1 x 4096) and "
        "phase 16 (qwen2-vl-2b 1 x (1024 patches + 3072 tokens), causal; "
        "seamless-m4t-large-v2's non-causal encoder over 4096 frames, "
        "causal decoder over 2048 tokens and non-causal cross-attention of "
        "2048 over 4096), phase 19 (llama2-7b's 2 x 4096 prefill on a 2 x "
        "2 grid of ranks, each rank over its 16 q heads, at 8 layers f32, "
        "2 and 32 layers bf16), phase 20 (the same grid: jamba-v0.1-52b's "
        "attention layers over 16 of 32 heads at 2 x 2048, 2 layers f32 and "
        "8 bf16; seamless-m4t-large-v2's encoder, decoder self- and "
        "cross-attention over 8 of 16 heads at 2 x (4096 frames + 2048 "
        "tokens), 24 + 24 layers f32 and 2 + 2 bf16), phase 21 (the same "
        "grid: gemma3-1b's 2 x 4096 prefills over 2 of 4 heads at 26 layers "
        "f32 on both cache layouts and 2 layers bf16, granite-34b's over 24 "
        "of 48 heads at 4 layers f32 on both, and the prefill steps held "
        "against their meta accounts: gemma3-1b at 26 layers, llama2-7b at "
        "8, bf16)",
        {"launches_phase6_standalone": launches_6["flash_attention"],
         "launches_phase19_mesh_ranks": mesh_flash,
         "launches_phase20_mesh_ranks": fam_launches["flash_attention"],
         "launches_phase21_mesh_ranks": seq_flash,
         "launches_phase13_by_config": report["dense"]["flash_launches"],
         "launches_phase14_by_config": report["moe"]["flash_launches"],
         "launches_phase15_by_config":
             report["ssm"]["launches"]["flash_attention"],
         "launches_phase16_by_config":
             report["mm"]["launches"]["flash_attention"],
         "other_shapes": {k: {f: r[f] for f in (
            "q", "k", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "f32_core_bound_ms", "eager_ms", "max_abs_err", "bound_ratio",
            "tflops")}
            for k, r in fa.items() if k != "prefill"},
         "f32_core_bound_ms": fa["prefill"]["f32_core_bound_ms"],
         "bound_ratio": fa["prefill"]["bound_ratio"],
         "tflops": fa["prefill"]["tflops"], "build": flash_build}))
    sd = rows["ssd_scan"]
    kernels.append(kernel_entry(
        "ssd_scan", f"{kdir}/ssd_scan/csrc/ssd_scan.cu",
        f"{pallas}/ssd_scan/ssd_scan.py:85",
        ssm_launches["ssd_scan"] + fam_launches["ssd_scan"],
        sd["mamba2 bf16"],
        "mamba2-2.7b: x (1, 4096, 80, 64) bf16, B and C (1, 4096, 1, 128), "
        "chunk 128; library_ms null: no single PyTorch call computes the "
        "scan; launches: phase 15's SSM path (the 1 x 4096 prefills of "
        "mamba2-2.7b and jamba-v0.1-52b, mamba2's eval forwards in "
        "training and its served clients, jamba's pooled prefill) and "
        "phase 20's grid (each rank's 40 of mamba2-2.7b's 80 heads at 2 x "
        "4096, 8 layers f32, 2 and 64 bf16; 64 of jamba-v0.1-52b's 128 at "
        "2 x 2048, 2 layers f32 and 8 bf16)",
        {"launches_phase20_mesh_ranks": fam_launches["ssd_scan"],
         "launches_phase15_ssm_prefill":
             report["ssm"]["launches"]["ssd_scan_prefill"],
         "launches_phase15_eval_and_serve":
             report["ssm"]["launches"]["ssd_scan_eval_and_serve"],
         "launches_phase6_standalone": launches_6["ssd_scan"],
         "f32_core_bound_ms": sd["mamba2 bf16"]["f32_core_bound_ms"],
         "variant": sd["mamba2 bf16"]["variant"],
         "blocks": sd["mamba2 bf16"]["blocks"],
         "bound_ratio": sd["mamba2 bf16"]["bound_ratio"],
         "other_shapes": {k: {f: r[f] for f in (
             "x", "N", "chunk", "variant", "ms", "plain_ms", "bound_ms",
             "bound_by", "f32_core_bound_ms", "eager_ms", "max_abs_err",
             "rel_err", "blocks")}
             for k, r in sd.items() if k != "mamba2 bf16"},
         "build": ssd_build}))
    print(json.dumps({"engine": report}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(f"gpu: {gpu}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
