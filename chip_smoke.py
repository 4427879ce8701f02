#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one card

Phases, in order; any failure exits non-zero and prints no result line:

1. print the card's name and power limit (``nvidia-smi``); no GPU -> exit 1.
2. build the CUDA kernels (``src/repro_torch/kernels/csrc``, one ``nvcc``
   per source for sm_90a, all at once) and print the build time.
3. hold every kernel against its plain PyTorch version on the card.  The
   int8 and top-k kernels at the VGG-5 path's shapes plus the tie and
   masked-tail drills, bit for bit; for quantize/dequantize also one row,
   odd widths, a CTA a row (4096), widths above the register limit (8200,
   2053), the batched engine's stacked cut (5 x 25600, 32) and inputs 4
   (x) and 1 (codes) bytes off a 16-byte boundary; a real VGG-5 client
   delta masked at width 0.25 as the server step masks it (whole zero
   blocks and -0.0 entries: top-k at density 0.1 decides many lanes on
   its tie path at kth == 0, and its 580 x 1024 int8 round trip has
   all-zero rows); for
   top-k (a radix select) every VGG-5 leaf as the reference server step
   cuts it (one buffer a leaf, short leaves one short block), keys
   that share their top digits, blocks of 100 lanes, and blocks of 99 and
   37 lanes and a buffer 4 bytes off a 16-byte boundary (its scalar
   path); flash attention (3xTF32 on
   the tensor cores) over the reference's sweep (``FLASH_CASES`` of
   tests/test_kernels.py) plus small head dims, gemma2-2b's head shape
   (D = 256, softcap 50, global and windowed; and in bf16), mixtral-8x22b's
   (48 query heads over 8 KV heads of D = 128, window 256 at S = 512; fp32
   and bf16), whisper-base's (D = 64 without causality over 1500 keys, and
   a 12-row prompt over them), recurrentgemma-9b's (16 query heads over
   one KV head of 256, window 256 at S = 600), a head dim of
   13 and inputs 4 bytes off a 16-byte boundary (its 4-byte copies),
   within 1e-5 (fp32) and 2e-2 (bf16); the SSD scan (chunk-parallel,
   3xTF32 on the tensor cores) over the reference's ``SSD_CASES`` plus an
   entering state, mamba2's widths and the tiling's edges (B > 1 ragged,
   S < chunk, a chunk of 40, P over two slices, an odd P over 64), on y
   and the final state
   within 5e-4, the reference's own tolerances, and within 1e-5 of the
   largest plain value.  The flash backward (two kernels, dq then dk/dv,
   3xTF32 on the tensor cores) and the forward's output and row log-sum-exp against their plain
   versions (``attention_bwd_plain``, ``attention_plain_lse``) over the
   sweep's fp32
   cases (its head dim 13 and its rows that see no key, which must get dq
   exactly 0 and lse +inf) and qwen3-0.6b's (16 over 8 heads of 128, S =
   2048), gemma2-2b's (D = 256, softcap 50, global and window 4096 at S =
   1024), mixtral's (48 over 8 of 128, window 256), recurrentgemma-9b's
   (MQA of 256, window 2048 at S = 2100) shapes and inputs 4 bytes off a
   16-byte boundary: out, dq, dk, dv each within 1e-5 x max(1,
   max|want|).  The SSD scan's backward (the forward's first three passes
   again, then six kernels, every product in 3xTF32 on the tensor cores)
   against ``ssd_scan_bwd_plain`` on every ``SSD_CASES`` shape
   with an entering state and a final-state gradient and with neither:
   dx, ddt, dBm, dCm, dinit within 1e-5 x max(1, max|want|), dA within
   1e-4 x max(1, max|want|) (``SSD_BWD_DA_REL``), two calls bitwise
   equal.
4. the federated main path: ``run_federated`` on VGG-5 at full width
   (582,346 params, random weights from a seed), K=5 clients on the
   paper's 5-device testbed, 1000 samples each, batch 100, 10 local
   iterations, 3 rounds; once in ``sfl`` at OP1 with the int8 cut, top-k
   deltas at density 0.1 and int8 deltas, once in ``fedadapt`` (the agent
   deployed, no exploration).  The kernels' launch counts are zeroed just
   before each of the two runs and read just after it; each kernel must
   have launched in each run, as often as the run's history (its OPs and
   kept clients) says, and flash attention never.  Then one more sfl-op1
   round under ``torch.profiler`` gives the card's busy share (the round
   must succeed; a profiler without device time gives "not measured").
4b. the control plane's training: the quickstart driver
   (``repro_torch.launch.quickstart``) trains the PPO agent on the card
   (``train_rl_agent``, 350 rounds, factored, G=3, the paper testbed) and
   deploys it (``run_fl_with_controller``, 5 rounds), then does the same on
   the CPU from the same params and noise: the first 30 rounds' OPs must be
   equal and their actions within 1e-5, the deployed agent must cut the
   card's round time by more than 25% against classic FL, and no repo
   kernel may launch.  Both wall times are printed.
4c. phase 4's two runs again with the batched engine (clients vmapped per
   OP group, the int8 cut quantizing the chunk's stacked activations in
   one call) and the per-leaf reference server step (top-k per leaf, one
   int8 round trip per client): launch counts exact as their histories
   need (the cut per chunk and local iteration, top-k per leaf and kept
   client), OPs and modelled round times equal to phase 4's, accuracy
   within 0.02 a round; one more sfl-op1 round under the profiler.
4d. the async runtime and checkpoints, phase 4's set-up (sfl-op1, the
   sequential engine, the fused server step), with cuDNN held
   deterministic: ``run_federated_async`` with buffer 5 and discount 0
   against ``run_federated`` over 3 aggregations (ops, times, accuracy and
   params bit for bit, round times within 1e-12); buffer 3, discount 0.5,
   6 aggregations checkpointed at 3 and resumed from there (the suffix bit
   for bit); the fault-tolerance driver's crash and resume
   (``launch/fault_tolerance_drill.py``, bit for bit); a combined chaos
   drill (5 clients, 6 aggregations, buffer 2) that keeps its invariants
   and resumes bit for bit from its mid-drill checkpoint.  The async runs'
   launch counts must be what their histories need (218/218/18
   uninterrupted, 69/69/9 resumed).  Also printed: wall seconds per
   aggregation, one checkpoint's save and restore seconds, and whether the
   buffered pair replays bit for bit with cuDNN's default algorithms.
4e. HeteroFL widths and the two-tier server, phase 4's set-up (sfl at
   OP1, the int8 cut, top-k 0.1, int8 deltas) with client widths (1.0,
   0.5, 0.25, 0.25, 0.5): the sequential engine and the fused step (each
   device's modelled time its phase-4 compute times ``w**2`` plus its
   comm); widths (0.5, 0.5, 0.25, 0.25, 0.5), whose uncovered coordinates
   must keep their initial values bit for bit; ``num_edges=1`` against
   the flat step (cuDNN deterministic, bit for bit); two edges with an
   edge->root hop of 50 and 10 Mbit/s (``edge_time`` the slow edge's
   hop, ``round_time`` the flat run's plus it), and one round's real
   deltas, EF rows and masks through two and three edges against the
   flat step (EF rows bit for bit, the global within 1e-6); the batched
   engine (OPs and times equal, accuracy within 0.02 a round); the async
   runtime with two edges (buffer 3, discount 0.5, 6 aggregations; the
   hop reported, the virtual clock the run's without it).  Every run's
   launches exactly as its history needs.
4f. VGG-5 on a mesh: phase 4's sfl-op1 set-up on the batched engine and
   the fused step, mesh-less and over ``FLConfig.mesh_shape`` (1, 1),
   (1, 8) and (2, 4), the mesh's eight places all this card
   (``mesh_devices``), cuDNN deterministic.  (1, 1) and (1, 8) (580
   blocks: a tail of 4) give the mesh-less run's params and history bit
   for bit; at (2, 4) (5 rows padded to 6) every server step is held
   against the single-device step on its own inputs (the new global
   within 1e-6, the EF rows bit for bit), OPs, modelled times, comm and
   drops are exact and accuracy within 0.02 a round (phase 4c's contract:
   the data shards' reordered fp32 sums move int8 codes and top-k
   near-ties over the run).  ``run_federated_async`` over (2, 1), 4
   aggregations checkpointed at 2 and resumed: the suffix and params bit
   for bit.  Launches exact: the cut once per (data shard, chunk, local
   step), top-k and the delta int8 pair once per (padded row, model
   shard).  Printed with the card's name and power limit: each run's wall
   a round and server-step seconds against the mesh-less run's.
5. the serving main path: ``ServeEngine`` on gemma2-2b at full width
   (26 layers, d_model 2304, 8 query heads over 4 KV heads of dim 256,
   vocab 256000; fp32 weights drawn on the card from a seed).  First the
   flash kernel is held against its plain version on q, k, v of the first
   local and the first global layer of a real prefill at S=4608.  Then
   ``serve`` takes 8 seeded Poisson requests (prompts of 600, 2100 or
   4500 tokens, 8-32 generated) through 4 slots, prefilled at 4608, and
   each request's tokens must equal the sequential oracle's
   (``oracle_steps``: ``reference_decode``'s calls a step at a time, on
   the card) up to the first token chosen under a top-2 logit margin
   below 1e-3, and over that prefix every decode step's logits row the
   oracle's within 2e-4 (``stepwise_max_abs_diff``; each request's count
   of distinct tokens printed beside it).  Launch counts are zeroed just before
   the run and read after the oracle: flash attention must have launched
   26 times per prefill (engine and oracle), the other kernels never.  One
   more prefill at 4608 and one decode step run under ``torch.profiler``.
5b. the serving main path of the SSM family: mamba2-780m at full width (48
   layers, d_model 1536, 48 SSD heads of dim 64, state 128, vocab 50280;
   857,379,072 fp32 params drawn on the card from a seed, after gemma2-2b's
   are freed).  The SSD kernel is held against its plain version on the
   inputs of layers 0 and 47 of real prefills at S=4096 and S=1000 (a
   ragged last chunk), within 5e-4 and 1e-5 x max|want|.  Then, with the
   launch counts zeroed: ``reference_decode`` serves 4 seeded prompts (300,
   1000, 4096, 16384 tokens, 32 generated each); ``api.prefill`` over 4
   rows of 4096 tokens and 31 ``api.decode`` steps give each row the tokens
   of its ``reference_decode`` up to the first one chosen under a top-2
   margin below 1e-3; the 300-token prompt fed through ``api.decode`` one
   token at a time from zero caches gives the prefill's logits and caches
   within 2e-4.  The SSD kernel must have launched 48 times per prefill, the
   other kernels never.  Prefill seconds, decode ms per step (1 and 4 rows)
   and tokens/s are read from the host clock; one prefill at 4096 and one
   decode step over 4 rows run under ``torch.profiler`` (the SSD scan's
   passes listed by kernel name).  (The engine, ``ServeEngine``, refuses the
   SSM family, as the reference's does.)
5c. the MoE and VLM families.  mixtral-8x22b at full width (d_model 6144,
   48 query heads over 8 KV heads of 128, 8 experts of d_ff 16384, top-2,
   window 4096 on every layer, vocab 32768; fp32 weights drawn on the card
   from a seed) with two cuts: 6 of its 56 layers, and capacity factor 4.0
   (``MIXTRAL_CF``: C = T, so the padded engine prefill and the unpadded
   oracle drop nothing).  Flash attention against its plain version on the
   first and the last layer of a real 4096-token prefill (1e-5); layer 0's
   real MoE input through the capacity path and through the exact decode
   path on all T rows (within 2e-5 x max|y|); ``serve`` of 6 seeded
   requests (prompts of 600, 2100 and 4060 tokens, 8-64 generated) through
   ``ServeEngine`` with 4 slots, prompts padded to 4096 and a 4096-slot
   rolling cache that one request wraps, each request's tokens equal to
   the oracle's up to the first top-2 margin below 1e-3 and its decode
   steps' logits within 2e-4 of the oracle's over that prefix (phase 5's
   check), the prefix also ending at the first decode step whose oracle
   routing has a top-k router gap below 1e-4 (a choice that may flip
   between the engine's 4-row and the oracle's 1-row sums); the
   wrapping request decoded through its cache against a full-forward
   prefill of the same tokens (2e-4).  Flash attention must have launched
   6 times per prefill (14 prefills), the other kernels never.  Printed:
   prefill seconds (also once at the config's capacity factor 1.25), one
   layer's attention and MoE blocks apart, decode ms per step by active
   slots and at 1 row (the oracle), tokens/s, peak memory; one prefill and
   one decode step under ``torch.profiler``.  Then internvl2-2b at full
   width and depth (24 layers, 1.89 B fp32 params): ``api.prefill`` over 2
   rows of 256 seeded patch embeddings and 744 tokens, 16 ``api.decode``
   steps after the patches, the last step's logits against a full forward
   and each row alone against the batch (2e-4), flash attention 24 times
   per prefill (4 prefills), the other kernels never.
5d. the hybrid and encoder-decoder families.  recurrentgemma-9b at full
   width and depth (38 layers: 26 RG-LRU and 12 local attention of 16
   query heads over one KV head of 256, window 2048; vocab 256000;
   9,396,195,328 fp32 params drawn on the card from a seed): flash against
   its plain version on the first and the last local layer of a real
   4096-token prefill (1e-5); with the launch counts zeroed,
   ``reference_decode`` of prompts of 300, 2100 and 4096 tokens (the two
   longer wrap the rolling cache at prefill; 32 generated each);
   ``api.prefill`` over 3 rows of 4096 and 31 ``api.decode`` steps, each
   row's tokens equal to its oracle's up to the first top-2 margin below
   1e-3, the rows' last step against a full forward (2e-4); the 300-token
   prompt fed through ``api.decode`` one token at a time from zero caches
   against the prefill's logits and every cache leaf (2e-4).  Flash must
   have launched 12 times per prefill (8 prefills), the other kernels
   never.  Printed: prefill seconds, decode ms per step (1 and 3 rows),
   tokens/s, one R and one L layer's parts at 4096 tokens, peak memory;
   one prefill and one decode step under ``torch.profiler``.  Then
   whisper-base at full width and depth (6 encoder and 6 decoder layers,
   8 heads of 64, vocab 51865): 4 rows of 1500 seeded frame embeddings
   and 96-token prompts through ``api.prefill``, 32 greedy ``api.decode``
   steps, the last against a full forward and each row alone against the
   batch (2e-4); flash drills on encoder layers 0 and 5 (1500 x 1500, no
   causality), decoder layer 0's self-attention and the cross-attention
   of decoder layers 0 and 5 (the prompt over the 1500 frames) within
   1e-5; flash 18 times per prefill (6 encoder, 6 self, 6 cross; 6
   prefills), the other kernels never.
5e. LM training: qwen3-0.6b at full width and depth (28 layers, d_model
   1024, 16 query heads over 8 KV heads of 128 with qk-norm, tied vocab
   151936; fp32 weights drawn on the card from a seed, after the earlier
   phases' models are freed).  The flash backward against its plain
   version on the q, k, v and dO of layers 0 and 27 of a real 4096-token
   step (1e-5 x max(1, max|want|)); one local step (``loss_through_cut``
   at OP 14 with the int8 cut, 1024 tokens, then ``torch.autograd.grad``)
   on the card against the host CPU from the same params and batch: the
   loss within 1e-5 relative, every gradient leaf within 1e-4 of its
   largest CPU entry and nonzero on the card, the step's launches exact;
   ``loss_through_cut`` at OPs 0, 14 and 28 equal to ``api.loss`` within
   1e-5 relative; the LM driver (``repro_torch.launch.train``, fedadapt,
   3 clients, 2 rounds of 2 local steps of 4096 tokens, the int8 cut,
   AdamW with cosine) whose OPs and modelled round times must equal a CPU
   replay of its control plane (``replay_control``), its losses finite and
   its launches exactly what its OPs need (flash forward twice per layer
   and step: the forward and its remat recompute; each backward kernel
   once per layer and step; the int8 pair once per step below the native
   OP; top-k and the SSD scan never).  Printed: seconds per local step,
   tokens/s, peak memory, one step's loss and gradient under
   ``torch.profiler``.
5f. LM training of the SSM family: mamba2-780m at full width and depth
   (48 layers, d_model 1536, 48 SSD heads of 64, state 128, chunk 128,
   vocab 50280; 857,379,072 fp32 params drawn on the card from a seed,
   after phase 5e's model is freed).  The SSD backward against its plain
   version on the inputs and y's gradient (scaled to a max of 1) of layers
   0 and 47 of a real 4096-token step, each bitwise repeatable; one local
   step at OP 24 with the int8 cut, 1024 tokens, on the card against the
   host CPU (the CPU taking the card's int8 codes; the loss within 1e-5
   relative, every gradient leaf within 1e-4 of its largest CPU entry,
   finite and nonzero on the card, the step's launches exact);
   ``loss_through_cut`` at OPs 0, 24 and 48 equal to ``api.loss`` within
   1e-5 relative; the LM driver with phase 5e's arguments, its OPs,
   modelled times and drops equal to ``replay_control``'s, its losses
   finite and its launches exactly what its OPs need (the SSD scan twice
   per layer and step, its backward once, the int8 pair once per step
   below the native OP, flash attention and top-k never).  Printed:
   seconds per local step, tokens/s, peak memory, one step under
   ``torch.profiler`` with the SSD backward's kernels by name and share.
5g. federated LM training through ``run_federated`` (the paper's loop:
   planner, ``Transport``-timed communication, the fused server step):
   qwen3-0.6b at full width and depth drawn on the card from a seed, K = 3
   clients of ``token_dataset`` rows of 4096 tokens, batch 1, 2 local
   iterations, 2 rounds, sfl at OP 14, the int8 cut, top-k 0.1 with error
   feedback and int8 deltas, the sequential engine, the paper testbed's
   first three devices and links; round 1's server step recomputed on the
   card from the run's own deltas and EF rows with the plain versions
   (``topk_blocks_plain``, ``quantize_rows_plain``,
   ``dequantize_rows_plain``) beside the kernels: kept values, int8 codes
   and scales, the new EF rows and the new global bitwise.  Then the same
   set-up for 1 round with widths (1.0, 0.5, 0.25) and two edges (top-k
   dropped: with it the run would not fit the card): the width-0.25
   client's params exactly 0 outside its mask, and with the width-1.0
   client left out of a recomputed step every uncovered coordinate keeps
   its value bit for bit.  The qwen3-0.6b set-up again through the
   batched engine (the three clients one vmapped chunk, every layer and
   CE chunk rematerialised under ``torch.func``): OPs, modelled times and
   drops equal to the sequential run's, the metric within 5e-4, the final
   params within phase 6's discrete-step bounds of the sequential run's
   (at most 5% of the lanes beyond 1e-4 of their leaf's max, none beyond
   0.25; the flash forward a launch a chunk).  Then mamba2-780m at full
   width, 12 of 48 layers, 1 round at OP 6 with the int8 cut.  Each run:
   OPs, modelled
   round and comm times, drops and ``edge_time`` equal to a CPU replay of
   the planner and ``RoundClock``; the -CE eval metric finite every round;
   launches exactly what its history needs (the mixer's forward twice a
   layer and local step plus once a layer for each round's eval pass, its
   backward once a layer and step; the int8 pair once a step below the
   native OP plus once per surviving client row for the delta wire; top-k
   once per surviving client row).  Printed with the card's name and power
   limit: wall seconds a round, the server step's seconds, peak memory,
   the flat buffer's lanes.
5h. federated training published into a live server: phase 5g's qwen3-0.6b
   set-up (top-k 0.1 EF kept) through ``run_federated_async`` (a buffer of
   K = 3, 1 local iteration, 3 aggregations) whose ``on_aggregate`` hook
   publishes each aggregation into a ``ParamStore`` (a copy of the flat
   global), swaps it into a live ``ServeEngine`` (4 slots, prompts padded
   to 4096, 4608 positions) and serves 4 seeded requests (prompts of
   600-4000 tokens, 16 generated) through ``serve(..., store=)``: the
   served versions are [1, 2, 3]; every request's tokens equal the oracle's
   on the adopted params up to the first top-2 margin below 1e-3, and its
   decode steps' logits within 2e-4 of the oracle's over that prefix (phase
   5's check); launches exactly the history's and the engine's prefills
   (the flash forward once a layer a prefill); OPs, modelled times, comm
   and drops equal to the CPU replay; the engine's final params bitwise the
   run's; a second ``maybe_swap`` without a publication returns False; a
   fresh engine on the adopted params gives the live engine's
   ``last_logits`` bit for bit; a publication from a second stream on a
   second thread, still copying when the engine swaps, is adopted whole.
   Printed with the card's name and power limit: each aggregation's wall
   seconds and its hook's, each ``publish_flat``'s and ``maybe_swap``'s
   seconds, the prefill seconds and decode ms a step under training's
   memory pressure, peak memory.
5i. the LM on a mesh: phase 5g's qwen3-0.6b run over mesh (1, 4) of this
   card (582,081 blocks: a tail of 3), its params and history bit for bit
   phase 5g's, launches exact (top-k and the delta pair once per row and
   model shard); then one MoE layer at full width from seeded weights,
   local against expert-parallel (``use_rules``): mixtral-8x22b (capacity
   factor 4.0: C = T) in case A at (1, 4), case B (d_ff over 16) at (1,
   16), FSDP at (2, 4) plain and under ``moe_int8_gather()``; arctic-480b
   (128 experts, 53.5 GB of fp32 experts; capacity factor 8.0, the
   busiest expert checked within C) in case A at (1, 16), 8 experts a
   place; each on 2048 tokens and one decode step over 8 rows, within
   1e-4 of the largest local value (int8: 0.05), no repo kernel launched.
   Printed with the card's name and power limit: the mesh run's wall a
   round, step seconds and peak against 5g's, each MoE call's ms against
   local, peak memory.  The places share one card: no inter-card traffic
   is measured.
5j. the launch drivers (``repro_torch.launch.steps``, ``dryrun``,
   ``fedavg_dryrun``, ``fleet_simulation``): the FedAdapt pod pair
   (``make_local_sync_steps``: the train step vmapped over 2 pods, then
   the FedAvg sync) at qwen3-0.6b's full width and depth from one start,
   two 4096-token rows a pod and step (every layer and CE chunk
   rematerialised under ``torch.func``), AdamW, 2 local steps, the first
   under ``launch.steps.ParamCopyRecorder`` (no param copied per row);
   each pod against ``make_train_step`` on its two rows alone
   (after one step every lane within 1e-5 of its leaf's max but for at
   most 1e-4 of the lanes, none of them beyond 2 lr: Adam's sign steps),
   the sync bit for bit
   ``(p0 + p1) * 0.5`` in both pods, flash's forward launched twice a
   layer and step (the forward and its recompute) and its backward pair
   once, for both pods; ``make_prefill_step`` / ``make_decode_step`` (B = 2, a
   512-token prompt, 8 decode steps) bit for bit ``api.prefill`` /
   ``api.decode``; the dry runs on meta (qwen3-0.6b train_4k, its FLOPs
   the closed form: four forwards, the recompute counted; mixtral-8x22b and arctic-480b decode_32k at 4 of
   their layers, their collectives those of the expert-parallel body's
   case B and case A; mamba2-780m long_500k; the fedavg dry run of
   qwen3-0.6b on 2 x 16 x 16), every cell ``ok`` with no card memory and
   no launch; ``launch.fleet_simulation`` at the example's size (lm16m, K
   = 32, 3 rounds through both engines), launches exact and the engines'
   metric within 1e-5 of its largest value.  Printed with the card's name
   and power limit: each local step's and the sync's seconds, the peak,
   each dry run's FLOPs, per-place argument bytes, collective bytes and
   seconds, each engine's rounds/s.
6. the small configurations on the CPU and on the card from the same
   weights: the VGG-5 runs of ``tests/test_torch_loop.py`` (ops and times
   exact, accuracy within one test sample, final params within the tests'
   tolerances) plus one with widths (0.5, 1.0, 0.25), two edges, top-k 0.5
   and int8 deltas (the edge hop too exact), gemma2-2b's smoke config
   through ``serve`` (tokens equal,
   logits within 1e-4) and the smoke configs of mamba2-780m, mixtral-8x22b,
   arctic-480b (at their capacity factor 1.25: the card must drop the
   (token, choice) pairs the CPU drops), internvl2-2b (seeded patches),
   recurrentgemma-9b and whisper-base (seeded frames) through prefill and
   decode (tokens equal, logits within 1e-4); the training loss and its
   gradient of the gemma2, qwen3, mixtral (capacity factor 1.25),
   internvl2, recurrentgemma, whisper and mamba2 smoke configs (the loss
   within 1e-5 relative, every leaf within 1e-4 of its max); the lm16m
   driver for 2 rounds from the same initial params and agent noise (OPs
   and times exact, each round's loss within 1e-5 relative); lm16m through
   ``run_federated`` with each engine (sfl at OP 3, the int8 cut, top-k 0.5
   and int8 deltas: OPs and times exact, the metric and params within the
   discrete-step bounds) and plain through the sequential engine, and
   mamba2's smoke config through the batched engine (the metric within
   1e-5 relative, the params within 1e-4 of each leaf's max); the
   mixtral-8x22b and arctic-480b smoke configs through the batched engine
   at capacity factor 1.25: plain (the metric and every lane within
   1e-5, and the eval passes dropping the same (token, choice) pairs on
   both), and each with the int8 cut, top-k 0.5 and int8 deltas (the
   discrete-step bounds).  Last, the silu drill: over a seeded (4, 8192)
   fp32 input on the card, ``torch.func.grad`` and ``vmap`` of it through
   the port's ``silu`` (``layers.silu``) give ``torch.autograd.grad``'s
   bits, 0 lanes apart (``F.silu``'s lanes apart printed beside).
7. time each kernel with CUDA events (median of CUDA-graph replays; the
   int8 pair also at the stacked cut, top-k also at VGG-5's largest leaf,
   both also at one qwen3-0.6b flat row of phase 5g: top-k over (1,
   596050944) at density 0.1, the int8 pair over its (582081, 1024) rows)
   beside its bound (flash attention and the SSD scan: the 3xTF32 tensor-core
   bound, and the fp32 CUDA-core bound as ``bound_fp32_ms``), its plain
   version and a library call computing the same function where PyTorch
   has one (``torch.mul`` for dequantize,
   ``torch.topk`` for top-k, compiled ``flex_attention`` for flash
   attention with gemma2's softcap and on recurrentgemma-9b's local layer
   (window 2048, which binds; MQA at D = 256), and
   ``scaled_dot_product_attention`` on gemma2's global layer without the
   softcap, mixtral's layer 0 (D = 128, GQA 6), whisper-base's encoder
   layer (D = 64, no causality) and qwen3-0.6b's layer 0 of a training
   step (S = 4096, 16 over 8 heads of 128, causal, the forward writing
   its lse as training's does): yardsticks the port never calls; no
   PyTorch call computes
   the SSD scan); the flash backward's two kernels and the whole backward
   at qwen3-0.6b's layer 0 (S = 4096, a real step's dO) and gemma2-2b's
   global layer (softcap 50), beside the same two bounds and the plain
   version of the same part (dq; dk and dv; all three), the whole
   backward also beside the backward of SDPA (k and v repeated) or of
   compiled ``flex_attention`` (the softcap), which no PyTorch call splits
   into the kernels' parts; each row also carries the work the kernels
   compute (three products in dq, four in dk/dv: seven for the pair) and
   its 3xTF32 bound; two calls of the pair on each of these layers must
   give bitwise-equal dq, dk and dv (the kernels use no atomics); the SSD
   scan's backward at mamba2-780m's layer 0 of a real 4096-token step
   (its y's gradient scaled to a max of 1) beside its plain version and
   the 3xTF32 and fp32 bounds of the products its passes compute (no
   PyTorch call computes the SSD scan's gradient); then print the whole
   run's seconds (the build included) with the card's name and power
   limit, the kernels' JSON line and the result line.

TF32 is switched off for convolutions and matrix products throughout, so
every comparison is in full fp32.  The full record goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import collections
import contextlib
import inspect
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

START = time.perf_counter()
HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "src"))

# NVIDIA H100 SXM data sheet: HBM3 rate, fp32 rate outside the tensor
# cores (the int8 and top-k kernels do fp32 arithmetic and comparisons)
# and the dense TF32 tensor-core rate (the 3xTF32 products of flash
# attention and the SSD scan)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12

SMALL = dict(rounds=2, local_iters=2, batch_size=10, augment=True, seed=0)
SMALL_MODES = {
    "fl": (dict(mode="fl"), 1e-4),
    "sfl-op2-int8": (dict(mode="sfl", static_op=2, quantize_transfer=True),
                     1e-3),
    "fedadapt-topk-int8": (dict(mode="fedadapt", delta_density=0.5,
                                quantize_deltas=True), 1e-3),
    "hetero-edges-topk-int8": (dict(mode="sfl", static_op=2,
                                    client_widths=(0.5, 1.0, 0.25),
                                    num_edges=2, delta_density=0.5,
                                    quantize_deltas=True), 1e-3),
}
# final-params atol, CPU vs card.  fl: 1e-4, looser than the CPU tests'
# 1e-5 against JAX because cuDNN may pick a Winograd or FFT convolution whose
# fp32 rounding error is larger than a direct sum's.  int8/top-k modes: 1e-3,
# the tests' bound for an int8 code or a top-k near-tie going the other way.

VGG_KERNELS = ("quantize", "dequantize", "topk_compress")
# the batched engine's chunk: get_engine builds it with BatchedEngine's
# default max_group (the reference's 8); the main path checks the default
BATCHED_MAX_GROUP = 8
# the stacked int8 cut of the batched engine: 5 clients at OP1 in one chunk,
# 100 samples of 16 x 16 x 32 each
STACKED_CUT = 5 * 25600
# phase 4b: the PPO agent trained on the card against the same training on
# the CPU (same params, same noise).  The first 30 rounds (three updates)
# must give the same OPs and actions within 1e-5: the actor's fp32 matmuls
# and the updates' sums round differently on the two devices, by ~1e-7 a
# step (the CPU tests against JAX see 1.3e-7 after 350 rounds)
PPO_TRAIN_ROUNDS, PPO_CHECK_ROUNDS, PPO_ACTION_ATOL = 350, 30, 1e-5
# phase 4c against phase 4: accuracy within 0.02 a round, the reference's
# own bound between its two engines (tests/test_fleet.py)
BATCHED_ACC_ATOL = 0.02
# phase 4e: the Jetson at full width, the Pi 4s at half, the Pi 3s at a
# quarter (paper_testbed's order: jetson, pi4_1, pi3_1, pi3_2, pi4_2); a
# fleet with no full-width client; the edge->root links of two edges
HETERO_WIDTHS = (1.0, 0.5, 0.25, 0.25, 0.5)
NARROW_WIDTHS = (0.5, 0.5, 0.25, 0.25, 0.5)
EDGE_BPS = (50e6, 10e6)
# one round's real deltas through two and three edges against the flat
# step: the global within 1e-6 (each edge normalizes by its own mass and
# the root re-weights, so fp32 sums run in another order)
TIERED_ATOL = 1e-6
# the reference's flash-attention sweep (tests/test_kernels.py FLASH_CASES,
# copied: this script imports nothing of JAX) plus the smoke head dims of
# gemma2/qwen3 (16) and lm16m (40) and a row range that sees no key:
# B, Sq, Sk, H, KV, D, causal, window, softcap, dtype
FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0, 0.0, "float32"),
    (1, 256, 256, 8, 8, 64, True, 64, 0.0, "float32"),
    (2, 100, 100, 8, 2, 32, True, 0, 50.0, "float32"),
    (1, 128, 384, 4, 1, 64, False, 0, 0.0, "float32"),
    (1, 64, 64, 2, 2, 128, True, 32, 30.0, "float32"),
    (2, 128, 128, 4, 4, 64, True, 0, 0.0, "bfloat16"),
    (2, 70, 70, 4, 2, 16, True, 32, 50.0, "float32"),
    (1, 77, 77, 8, 4, 40, True, 0, 0.0, "float32"),
    (1, 200, 72, 4, 2, 64, True, 16, 0.0, "float32"),
    # gemma2-2b's head shape with its softcap, global and windowed; in bf16;
    # and a head dim that is not a multiple of 4 (4-byte copies)
    (1, 600, 600, 8, 4, 256, True, 0, 50.0, "float32"),
    (1, 600, 600, 8, 4, 256, True, 256, 50.0, "float32"),
    (1, 300, 300, 8, 4, 256, True, 0, 50.0, "bfloat16"),
    (1, 50, 50, 2, 1, 13, True, 0, 0.0, "float32"),
    # mixtral-8x22b's head shape (48 query heads over 8 KV heads of 128)
    # with a window shorter than the sequence; and in bf16
    (1, 512, 512, 48, 8, 128, True, 256, 0.0, "float32"),
    (1, 512, 512, 48, 8, 128, True, 256, 0.0, "bfloat16"),
    # whisper-base's encoder (no causality over 1500 keys, not a multiple
    # of the 32-key tile, D = 64) and cross-attention (a short prompt over
    # the 1500 frames); recurrentgemma-9b's local layer (16 query heads over
    # one KV head of 256, a window shorter than the sequence)
    (1, 1500, 1500, 8, 8, 64, False, 0, 0.0, "float32"),
    (2, 12, 1500, 8, 8, 64, False, 0, 0.0, "float32"),
    (1, 600, 600, 16, 1, 256, True, 256, 0.0, "float32"),
]
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# phase 3's flash-attention backward drills: the sweep's fp32 cases (a
# gradient is fp32 only; the sweep holds the head dim 13 and, at
# (1, 200, 72, ...) with window 16, rows 87-199 that see no key) and the
# models' layer shapes: qwen3-0.6b (16 query heads over 8 KV heads of
# 128), gemma2-2b (D = 256, softcap 50, global and window 4096), mixtral
# (48 over 8 of 128, window 256), recurrentgemma-9b (MQA of 256, window
# 2048, which binds at 2100); whisper's 1500 x 1500 is in the sweep
FLASH_BWD_CASES = [c for c in FLASH_CASES if c[-1] == "float32"] + [
    (1, 2048, 2048, 16, 8, 128, True, 0, 0.0, "float32"),
    (1, 1024, 1024, 8, 4, 256, True, 0, 50.0, "float32"),
    (1, 1024, 1024, 8, 4, 256, True, 4096, 50.0, "float32"),
    (1, 512, 512, 48, 8, 128, True, 256, 0.0, "float32"),
    (1, 2100, 2100, 16, 1, 256, True, 2048, 0.0, "float32"),
]
# dq, dk, dv (and the forward's lse) within FLASH_BWD_REL * max(1,
# max|want|): kernel and plain version both sum in fp32 (the kernel's
# products in 3xTF32 on the tensor cores, each tile's summed apart; the
# plain version through cuBLAS), in other orders, over D and over up to
# 2100 keys or rows (times the GQA group)
FLASH_BWD_REL = 1e-5
# gemma2-2b's real-layer drill.  1e-5 as in the sweep: the kernel and the
# plain version both sum in fp32 (over D=256 and up to 4608 keys), the
# layers' v are O(1) (unit-variance h times N(0, 1/d) weights) and the
# output is a convex mix of them, so fp32 reordering moves it by a few
# 1e-6 (PERF.md records the measured errors).
REAL_LAYER_TOL = 1e-5

SERVE_SLOTS, SERVE_PROMPT, SERVE_SEQ = 4, 4608, 4640
SERVE_TRAFFIC = dict(rate=0.5, n_requests=8, vocab_size=256000,
                     prompt_lens=(600, 2100, 4500), gen_lens=(8, 16, 32),
                     seed=0)
MARGIN = 1e-3   # oracle top-2 logit gap under which a token may flip
# gemma2 smoke served on the CPU and on the card: logits within 1e-4 (fp32
# matmuls on either device and the kernel vs the plain attention move them
# by ~1e-6 at this size)
SMALL_SERVE_ATOL = 1e-4

# the reference's SSD sweep (tests/test_kernels.py SSD_CASES, copied) plus
# an entering state and mamba2's widths with a ragged last chunk:
# B, S, H, P, N, chunk, init_state
SSD_CASES = [
    (2, 64, 4, 16, 16, 16, False),
    (1, 128, 2, 32, 32, 32, False),
    (2, 96, 4, 16, 16, 32, False),
    (1, 64, 2, 16, 16, 64, False),
    (2, 96, 4, 16, 16, 32, True),
    (1, 1000, 48, 64, 128, 128, False),
    # the chunk-parallel kernel's tiling: B > 1 ragged with an entering
    # state, S < chunk, Q not a multiple of the 16-row tiles, P over two
    # 64-column slices with N not a multiple of 8
    (2, 1000, 4, 64, 128, 128, True),
    (1, 50, 4, 64, 128, 128, True),
    (1, 300, 4, 64, 128, 40, True),
    (1, 200, 2, 130, 20, 64, True),
    # odd P over 64: a first slice 64 wide whose rows start at odd floats
    (1, 200, 3, 65, 16, 64, True),
    # odd widths (4-byte copies, scalar stores), chunks of 7 and of 1 row
    (2, 37, 3, 5, 3, 7, True),
    (1, 20, 2, 8, 4, 1, False),
    # five heads: the backward's dB / dC pass sums the heads four a group
    # at P = 64, so its last group has one
    (1, 300, 5, 64, 128, 128, True),
]
# the reference's own kernel tolerance (tests/test_kernels.py): the kernel's
# in-chunk prefix sum and fp32 sums run in another order than the plain
# version's, and cum reaches about -600 within a chunk at full width
SSD_TOL = 5e-4
# and a relative bound: max abs error <= SSD_REL * max |want|, on y and on
# the state.  The real layers' y is small (the absolute 5e-4 alone would
# pass almost anything there); 3xTF32 and reordered fp32 sums stay a few
# 1e-6 of the largest value (tests/test_torch_ssm.py emulates the passes)
SSD_REL = 1e-5
# phase 3's SSD backward drills: each SSD_CASES shape with an entering
# state and a final-state gradient, and with neither.  dx, ddt, dBm, dCm
# and dinit within SSD_BWD_REL * max(1, max|want|): kernel and plain
# version both sum in fp32 (the kernel's products in 3xTF32, each output
# tile over at most 256 terms), in other orders.  dA is
# one sum a head over the B S rows of d(dt A)_s dt_s, each a reversed
# prefix sum of d cum, whose row and column sums of M o dM cancel: fp32
# rounding in any order leaves more of itself in dA, relative to its
# largest value, than in the others (the plain version in fp32 against
# float64, tests/test_torch_ssd_grad.py test_plain_fp32_against_float64;
# the kernel sums the cancelling terms in double), so dA takes
# SSD_BWD_DA_REL
SSD_BWD_REL, SSD_BWD_DA_REL = 1e-5, 1e-4
MAMBA_PROMPTS = (300, 1000, 4096, 16384)
MAMBA_GEN = 32
MAMBA_ROWS, MAMBA_ROW_PROMPT = 4, 4096
MAMBA_DRILLS = (4096, 1000)     # real-layer drills: 1000 has a ragged chunk
# prefill against token-by-token decode: the reference's own bound
# (tests/test_models.py test_decode_matches_full_forward)
STEPWISE_TOL = 2e-4

# phase 5c, mixtral-8x22b at full width with two cuts.  Depth: 6 of 56
# layers (every layer is "L", so the pattern's period is 1); 6 layers hold
# 57.5 GiB of fp32 params.  Capacity factor 4.0 instead of 1.25: with
# E/k = 4 it makes C = T, so the capacity path drops no token.  The engine
# prefills a prompt padded to max_prompt and the oracle prefills it
# unpadded: at 1.25 the two get different capacities, so different drops
# and different tokens (the reference's serving test raises it to 8.0 for
# the same reason).  Widths are the config's.
MIXTRAL_LAYERS, MIXTRAL_CF = 6, 4.0
MIXTRAL_SLOTS, MIXTRAL_PROMPT, MIXTRAL_SEQ = 4, 4096, 4160
# seed 5 is the first whose 6 requests take all three prompt lengths and
# run one request past position 4096, so its slot's rolling buffer wraps
MIXTRAL_TRAFFIC = dict(rate=0.5, n_requests=6, vocab_size=32768,
                       prompt_lens=(600, 2100, 4060), gen_lens=(8, 16, 32, 64),
                       seed=5)
# the capacity path at cf 4.0 against the exact path on the same T rows of
# a real layer: drop-free, they compute one function, and only the fp32
# reduction order over d_model and d_ff (the batched vs per-expert
# products) differs: 6e-6 of the largest output on the H100 (PERF.md).
# The check also runs the capacity path with TF32 products (10-bit
# mantissas) and fails unless that breaks the bound, so the bound tells
# the configuration's fp32 from a lower precision.
MOE_REL_TOL = 2e-5
# phase 5c's per-step logits check: a decode step whose oracle routing has
# a token's k-th and (k+1)-th router probabilities closer than
# ROUTER_MARGIN ends the compared prefix, as a top-2 logit margin below
# MARGIN does.  The engine's 4-row decode and the oracle's 1-row decode
# sum in other orders, and a near-tie goes the other way: on the H100 one
# of 234 decode steps flipped a choice (gap 7.6e-7, request 0's step 19,
# one layer) and read its logits 0.883 from the oracle's, while every
# step without a flip read at most 2.98e-5 and no gap of 5.2e-6 or more
# flipped (scripts/mixtral_routing_flips.py; PERF.md)
ROUTER_MARGIN = 1e-4
# phase 5c, internvl2-2b at full width and depth: 2 rows of 256 patch
# embeddings (the frontend stub, seeded) and 744 tokens, 16 decode steps
VLM_ROWS, VLM_TEXT, VLM_GEN = 2, 744, 16
# phase 5d, recurrentgemma-9b at full width and depth (38 layers: 26
# RG-LRU and 12 local attention with 16 query heads over one KV head of
# 256, window 2048; vocab 256000; 35.0 GiB of fp32 params, no cut):
# reference_decode of prompts on both sides of the window (2100 and 4096
# wrap the rolling cache at prefill), a batch of rows of 4096, and the
# shortest prompt fed one token at a time from position 0 (the stepwise
# oracle: 300 decode steps)
HYBRID_PROMPTS = (300, 2100, 4096)
HYBRID_GEN = 32
HYBRID_ROWS, HYBRID_ROW_PROMPT = 3, 4096
# phase 5d, whisper-base at full width and depth (6 encoder and 6 decoder
# layers, d_model 512, 8 heads of 64, 1500 frames, vocab 51865): 4 rows of
# 1500 seeded frame embeddings N(0, 0.1^2) and 96-token prompts, 32 greedy
# decode steps
WHISPER_ROWS, WHISPER_TEXT, WHISPER_GEN = 4, 96, 32
# phase 5e, LM training: qwen3-0.6b at full width and depth (28 layers,
# d_model 1024, 16 query heads over 8 KV heads of 128 with qk-norm, tied
# embeddings of vocab 151936; 595,984,384 fp32 params drawn on the card).
# The real-layer drill's step is train_4k's length; the card-vs-CPU local
# step is at OP 14 with the int8 cut, batch 1, 1024 tokens; split equals
# native at OPs 0, 14 and 28; the driver runs fedadapt with 3 clients, 2
# rounds of 2 local steps of 4096 tokens, the int8 cut, AdamW with cosine
QWEN3_DRILL_SEQ = 4096
QWEN3_STEP_OP, QWEN3_STEP_SEQ = 14, 1024
QWEN3_SPLIT_OPS = (0, 14, 28)
QWEN3_DRIVER = ["--mode", "fedadapt", "--clients", "3", "--rounds", "2",
                "--local-steps", "2", "--batch", "1", "--seq", "4096",
                "--quantize-transfer"]
# a local step on the card against the host CPU from the same params and
# batch: the loss within 1e-5 relative, every gradient leaf within 1e-4 of
# its largest CPU entry: fp32 sums over 1024 tokens and 28 layers run in
# other orders on the two devices (cuBLAS and the kernels against MKL and
# the plain versions; 6.2e-6 measured without the cut, PERF.md).  At the
# int8 cut the CPU takes the card's codes (its own activations, the card's
# quantized values, the straight-through gradient): each device rounds
# values that the two place within an ulp of a code boundary to
# neighbouring codes (76 of 1,048,576 at OP 14), a discrete step of
# absmax / 127 in one element that moves every later value.  Each device
# quantizing its own cut is printed too and held to the discrete-step
# bound the repo's int8 comparisons take (1e-3, ROADMAP queue 3).  Phase
# 6's smoke configs and the lm16m driver take TRAIN_LOSS_REL and
# TRAIN_GRAD_REL.
TRAIN_LOSS_REL, TRAIN_GRAD_REL = 1e-5, 1e-4
CUT_FLIP_REL = 1e-3
# phase 5f, LM training: mamba2-780m at full width and depth (48 layers,
# d_model 1536, 48 SSD heads of 64, state 128, chunk 128, vocab 50280;
# 857,379,072 fp32 params drawn on the card): the real-layer drill's step
# of 4096 tokens; the card-vs-CPU local step at OP 24 (half the stack on
# the device) with the int8 cut, 1024 tokens, held to TRAIN_LOSS_REL and
# TRAIN_GRAD_REL; split equals native at OPs 0, 24 and 48; the driver with
# phase 5e's arguments (QWEN3_DRIVER)
MAMBA_DRILL_SEQ = 4096
MAMBA_STEP_OP, MAMBA_STEP_SEQ = 24, 1024
MAMBA_SPLIT_OPS = (0, 24, 48)
# phase 5g, federated LM training through run_federated: qwen3-0.6b at full
# width and depth (drawn on the card from seed 0), K = 3 clients of
# token_dataset rows of 4096 tokens (4 rows each: 2 rounds x 2 local
# iterations at batch 1), a test set of 2 rows (the -CE eval at the native
# OP, one no_grad pass a round), sfl at OP 14, the int8 cut, top-k 0.1 with
# error feedback, int8 deltas, the fused server step, the sequential
# engine; the paper testbed's first three devices and links (its Eq. 1
# cluster over the LM's workload, a Transport over their bandwidths)
FED_K, FED_SEQ, FED_ROWS, FED_TEST_ROWS = 3, 4096, 4, 2
FED_OP, FED_LR = 14, 0.01
# the width run: the same set-up for 1 round with widths (1.0, 0.5, 0.25)
# and two edges behind EDGE_BPS.  Its predicted peak is ~58 GiB without
# top-k and ~78 GiB with it (PERF.md, phase 5g): past ~70 GiB, so this run
# drops top-k (density 1.0, the int8 deltas kept) and keeps the widths
FED_WIDTHS = (1.0, 0.5, 0.25)
# then mamba2-780m at full width with its depth cut to 12 of 48 layers: 1
# sync round at OP 6 with the int8 cut
FED_MAMBA_LAYERS, FED_MAMBA_OP = 12, 6
# the batched run: the qwen3-0.6b set-up above with engine="batched" (the
# three clients at OP 14 one chunk, one vmapped step a local iteration,
# every layer and CE chunk rematerialised under torch.func), held to the
# sequential run: OPs, modelled round and comm times and drops equal, the
# metric within FED_DISCRETE_METRIC_REL, the final params lane by lane
# within FED_LANE_REL / FED_TREE_SHARE / FED_DISCRETE_PARAMS_REL (phase
# 6's bounds below): the engines' fp32 sums part, which moves int8 codes
# and top-k near-ties, discrete steps that later rounds carry on
# phase 6's lm16m runs through run_federated, card against CPU: a plain
# fp32 run within TRAIN_LOSS_REL (the metric) and TRAIN_GRAD_REL (every
# param leaf, of its max); the runs with the int8 cut, top-k and int8
# deltas with the metric within FED_DISCRETE_METRIC_REL and the params
# lane by lane: an int8 code or a top-k near-tie that the two devices'
# fp32 sums send different ways is a discrete step (1/127 of a row's
# absmax; a top-k flip moves one coordinate by its whole local delta),
# which later steps carry on, so at most FED_TREE_SHARE of the lanes may
# lie beyond FED_LANE_REL of their leaf's max and none beyond
# FED_DISCRETE_PARAMS_REL.  On the CPU against the reference, sound runs
# stayed within 2.68% and 0.130, and runs with training off or one local
# iteration of two read at least 49.2% and 0.770 (tests/torch_fl_cases.py
# holds the same bounds)
FED_DISCRETE_METRIC_REL, FED_DISCRETE_PARAMS_REL = 5e-4, 0.25
FED_LANE_REL, FED_TREE_SHARE = 1e-4, 0.05
# phase 6's batched MoE runs (mixtral-8x22b and arctic-480b smoke configs
# at their capacity factor 1.25): the plain runs' metric and every param
# lane within FED_MOE_PLAIN_REL (relative; of the leaf's max); the runs
# with the int8 cut, top-k 0.5 and int8 deltas take the discrete-step
# bounds.  Card and CPU both run the batched engine; silu's backward is
# aten's silu_backward under either engine (layers.silu), so on the CPU
# the port's two engines give these runs bit for bit
# (tests/test_torch_lm_federated_moe.py)
FED_MOE_PLAIN_REL = 1e-5
# phase 6's silu drill: the input's shape (the batched engine's vmap runs
# over its rows)
SILU_DRILL_SHAPE = (4, 8192)
# phase 5h, federated training published into a live server: phase 5g's
# qwen3-0.6b set-up (K = 3, rows of 4096 tokens, batch 1, sfl at OP 14,
# the int8 cut, top-k HOT_DENSITY with error feedback, int8 deltas, the
# fused step, the sequential engine) through run_federated_async with a
# buffer of K and 1 local iteration, HOT_AGGS aggregations; each is
# published into a ParamStore and adopted by a live ServeEngine (HOT_SLOTS
# slots, prompts padded to HOT_MAX_PROMPT, HOT_MAX_SEQ positions), which
# then serves HOT_TRAFFIC's seeded requests (seed: the version) through
# serve(..., store=).  The side-stream probe sleeps HOT_SIDE_SLEEP cycles
# (~60 ms) on the publisher's stream before its copy, so the engine's swap
# is enqueued while the copy is still pending
HOT_AGGS, HOT_DENSITY = 3, 0.1
HOT_SLOTS, HOT_MAX_PROMPT, HOT_MAX_SEQ = 4, 4096, 4608
HOT_TRAFFIC = dict(rate=4.0, n_requests=4, prompt_lens=(600, 2000, 4000),
                   gen_lens=(16,))
HOT_SIDE_SLEEP = 100_000_000
# phase 4f, VGG-5 on a mesh: phase 4's sfl set-up at OP1 (K = 5, 1000
# samples a client, batch 100, 10 local iterations, 3 rounds, the int8 cut,
# top-k 0.1 EF, int8 deltas) on the batched engine and the fused step, over
# meshes whose MESH_PLACES places are all this one card, against the
# mesh-less run of the same set-up: the data = 1 meshes bit for bit; at
# (2, 4) every server step within MESH_ATOL of the single-device step on
# the same inputs (the reference's bound between its data > 1 mesh step
# and its single-device step) and its EF rows bit for bit, OPs, modelled
# times, comm and drops exact, and the whole run's accuracy within
# BATCHED_ACC_ATOL a round (phase 4c's contract between two summation
# orders of one algorithm): the data shards' sums and the engine's
# smaller vmapped chunks reorder fp32 additions, which across 3 rounds
# move int8 codes and top-k near-ties (PERF.md records the params' gap);
# cuDNN held deterministic.  Then run_federated_async over MESH_ASYNC
# (buffer 3, discount 0.5, 4 aggregations, a checkpoint at 2) resumed from
# that checkpoint, bit for bit the straight run's suffix
MESH_PLACES = 8
VGG_MESHES = ((1, 1), (1, 8), (2, 4))
MESH_ATOL = 1e-6
MESH_ASYNC = (2, 1)
# phase 5i, the LM on a mesh: phase 5g's qwen3-0.6b run on FED_MESH (its
# 582,081 blocks leave a tail of 3), bit for bit phase 5g's run; then one
# MoE layer at full width, sharded (``use_rules``) against local from the
# same seeded weights, at MOE_MESH_S tokens (B = 1) and one decode step
# over MOE_MESH_ROWS rows, within MOE_MESH_REL of the largest local value
# (the reference test's 1e-4, tests/test_moe_sharded.py), the int8 gather
# within MOE_INT8_GATHER_REL (tests/test_torch_moe_sharded.py's
# INT8_GATHER_REL: rowwise int8 moves a weight by at most 1/254 of its
# row's absmax).  The capacity factors drop nothing on either side:
# mixtral's makes C = T (E / k = 4); arctic's C = 256 is checked against
# the busiest expert's load
FED_MESH = (1, 4)
MOE_MESH_S, MOE_MESH_ROWS = 2048, 8
MOE_MESH_REL, MOE_INT8_GATHER_REL = 1e-4, 0.05
MOE_MESH_CASES = {
    # (mesh, int8 gather): case A (E % tp == 0) at (1, 4); case B (d_ff
    # over 16) at (1, 16); FSDP (d over data) at (2, 4), plain and int8
    "mixtral-8x22b": (4.0, (((1, 4), False), ((1, 16), False),
                            ((2, 4), False), ((2, 4), True))),
    # 8 of 128 experts a place: one chip's expert share
    "arctic-480b": (8.0, (((1, 16), False),)),
}


# phase 5j, the launch drivers.  (a) The FedAdapt pod pair
# (``launch.steps.make_local_sync_steps``) at qwen3-0.6b's full width and
# depth: fp32 params from api.init(cfg, 0) on the card, the same start in
# both pods, POD_ROWS rows of POD_SEQ tokens a pod and local step
# (train_4k's row length, its global batch of 256 cut to two rows a pod),
# qwen3's AdamW (make_opt: make_optimizer's default rate ADAMW_LR, clip
# 1.0), POD_LOCAL_STEPS vmapped local steps, then the sync.  The first
# local step runs under ``launch.steps.ParamCopyRecorder``: no param may be
# copied per row (the CE once copied each pod's tied unembedding a row, 4
# x 0.622 GB a chunk here).  Each pod against make_train_step on its
# rows alone: the loss within TRAIN_LOSS_REL, and
# after one step every lane within POD_STEP_REL of its leaf's max but for
# at most POD_FLIP_SHARE of the tree's lanes, none beyond 2 * ADAMW_LR
# more: Adam's first step is lr * sign(g) wherever |g| >> eps, so a
# gradient within the vmapped GEMMs' rounding of 0 flips its lane by up
# to 2 lr (a discrete step); the reading after the second step is
# recorded.  The sync equals (p0 + p1) * 0.5 bit for bit in both pods, and
# flash launches twice a layer and step for both pods (the forward and
# its remat recompute; its vmap rules fold the pods into B).  Every layer
# and CE chunk is rematerialised under ``torch.func`` (``layers._Remat``),
# so a pod keeps its layers' inputs, not their intermediates: without
# that, 4096 tokens a pod ran out of the card (PERF.md, phase 5j)
POD_ROWS, POD_SEQ, POD_LOCAL_STEPS = 2, 4096, 2
ADAMW_LR = 1e-4
POD_STEP_REL, POD_FLIP_SHARE = 1e-5, 1e-4
# (b) the step builders at qwen3-0.6b: B = 2 rows of a STEPS_PROMPT-token
# seeded prompt, then STEPS_DECODE greedy decode steps, bit for bit
# api.prefill / api.decode
STEPS_PROMPT, STEPS_DECODE = 512, 8
# (c) the dry runs on meta (run_cell on the 16 x 16 mesh of meta places,
# fedavg_dryrun.run on 2 x 16 x 16): (arch, shape, layers); the MoE cells
# keep DRYRUN_MOE_LAYERS of their layers (under the step analysis the
# expert-parallel body runs for one place)
DRYRUN_MOE_LAYERS = 4
DRYRUN_CELLS = (("qwen3-0.6b", "train_4k", None),
                ("mixtral-8x22b", "decode_32k", DRYRUN_MOE_LAYERS),
                ("arctic-480b", "decode_32k", DRYRUN_MOE_LAYERS),
                ("mamba2-780m", "long_500k", None))
# (d) launch.fleet_simulation at the example's size (lm16m, K = 32, 3
# rounds through both engines): the engines' metric within
# FLEET_DRIFT_REL of its largest value, the plain fp32 bound the federated
# LM tests hold (tests/torch_fl_cases.py PLAIN_METRIC_REL)
FLEET_CLIENTS, FLEET_ROUNDS = 32, 3
FLEET_DRIFT_REL = 1e-5
# (e) launch.hlo_analysis over a real train step of qwen3-0.6b and
# mamba2-780m (full width and depth, one row of ANALYSED_SEQ tokens, one
# place): the analysed peak (arguments plus the high-water mark of the
# step's live storages) against torch.cuda.max_memory_allocated over the
# step, within ANALYSED_PEAK_BAND: below, the allocator's rounding and
# the kernels' scratch (the SSD passes'), which the analysis does not see;
# above, nothing it counts is left out.  The first run read 0.9998 for
# both steps (0.8-1.05 was stated before it)
ANALYSED_SEQ = 4096
ANALYSED_PEAK_BAND = (0.95, 1.02)

def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(name: str):
    print(f"\n== {name} (at {time.perf_counter() - START:.1f} s)",
          flush=True)


def time_ms(fn, graph: bool = True, reps: int = 15, inner: int = 20):
    """Median over ``reps`` of the mean time of ``inner`` back-to-back
    calls, from CUDA events.  With ``graph`` the calls are captured once in
    a CUDA graph and replayed, so the time is the device's alone (a call
    that cannot be captured fails the run); with ``graph=False``, eager
    calls also pay the host's launch overhead, which is what the main path
    pays.  The inputs stay in L2: the main path calls these kernels on data
    it has just written."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(inner):
                fn()
        run = g.replay
    else:
        def run():
            for _ in range(inner):
                fn()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / inner)
    return statistics.median(samples)


def bound_ms(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(torch, tq, tt, dev):
    """Phase 3: each kernel equals its plain version bit for bit."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    worst = {"quantize": 0.0, "dequantize": 0.0, "topk_compress": 0.0}

    def same(a, b, what):
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"{what}: {a.dtype}{tuple(a.shape)} vs "
                 f"{b.dtype}{tuple(b.shape)}")
        if a.dtype == torch.float32:
            equal = torch.equal(a.view(torch.int32), b.view(torch.int32))
        else:
            equal = torch.equal(a, b)
        if not equal:
            fail(f"{what}: kernel differs from its plain version")
        if a.numel() == 0:
            return 0.0
        return float((a.double() - b.double()).abs().max())

    # quantize / dequantize: the VGG-5 cut at B=100 (OP1, OP2) and the delta
    # wire, then the paths the kernels' plans split on: odd C (scalar
    # loads, 1 to 32 threads a row), one row, a CTA a row (4096), C above
    # the register limit (the row read twice: 8200 in float4s, 2053 in
    # scalars), and x and the codes 4 and 1 bytes off a 16-byte boundary
    def quant_drill(x, what):
        q, s = tq.quantize_rows(x)
        qp, sp = tq.quantize_rows_plain(x)
        worst["quantize"] = max(worst["quantize"],
                                same(q, qp, f"quantize codes {what}"),
                                same(s, sp, f"quantize scales {what}"))
        if x.data_ptr() % 16:
            shifted = torch.zeros(q.numel() + 1, dtype=torch.int8,
                                  device=dev)
            shifted[1:] = q.reshape(-1)
            q = shifted[1:].view(q.shape)
        worst["dequantize"] = max(worst["dequantize"], same(
            tq.dequantize_rows(q, s), tq.dequantize_rows_plain(q, s),
            f"dequantize {what}"))
        print(f"quantize/dequantize {what}: equal")

    for R, C in [(25600, 32), (6400, 64), (580, 1024), (STACKED_CUT, 32),
                 (300, 32), (33, 13), (300, 37), (5, 3), (1, 1), (1, 64),
                 (3, 4096), (2, 8200), (2, 2053)]:
        x = (torch.randn((R, C), generator=gen) * 3.0)
        for i, scale in enumerate((1.0, 2.0, 3.0)[:R]):   # exact .5 ties
            x[i] = (torch.arange(C) % 9 - 4.5) * scale
            x[i, 0] = 127.0 * scale
        x[3:4] = 0.0                                       # all-zero row
        quant_drill(x.to(dev), f"({R}, {C})")
    for R, C in [(580, 1024), (300, 32), (3, 4096)]:
        buf = torch.randn(R * C + 1, generator=gen).to(dev)
        view = buf[1:].view(R, C)
        if view.data_ptr() % 16 != 4:
            fail("quantize misaligned drill: the view is not 4 bytes off")
        quant_drill(view, f"({R}, {C}) 4 bytes off")

    # top-k: one VGG-5 client row at density 0.1, three rows at once, and
    # the drills (ties, masked tail, density from the true size, density 1)
    from repro_torch.configs.vgg import VGG5
    from repro_torch.fl.flatbuf import FlatLayout
    from repro_torch.models.vgg import init
    layout = FlatLayout(init(VGG5, gen))
    cases = []
    for rows, density in [(1, 0.1), (3, 0.1), (1, 0.5), (1, 1.0)]:
        cases.append((f"VGG-5 layout x{rows} at density {density}",
                      torch.randn((rows, layout.padded), generator=gen),
                      torch.from_numpy(layout.block_meta(density)), 1024))
    ties = torch.tensor([5.0, -3.0, 3.0, 3.0, -5.0, 1.0, 0.5, 0.25] * 16)
    cases.append(("ties", ties[None], torch.tensor([[128, 3]]), 128))
    heavy = torch.randint(-3, 4, (1, 4096), generator=gen).float()
    heavy[heavy == 0] = 1.0
    cases.append(("heavy ties", heavy, torch.tensor(
        [[512, k] for k in (1, 7, 100, 300, 511, 512, 64, 2)]), 512))
    tail = torch.randn((1, 2048), generator=gen)
    tail[:, 1500:] = 100.0
    cases.append(("masked tail", tail,
                  torch.from_numpy(tt.density_block_meta(1500, 1024, 0.02)),
                  1024))
    small = torch.zeros((1, 1024))
    small[0, :100] = torch.randn(100, generator=gen)
    cases.append(("density from true size", small,
                  torch.from_numpy(tt.density_block_meta(100, 1024, 0.05)),
                  1024))
    # magnitudes in [1, 2): every key shares its top 9 bits, so the radix
    # passes at bits 24 and 16 leave one bin each
    same_exp = (1.0 + torch.rand((1, 4096), generator=gen)) * \
        torch.where(torch.rand((1, 4096), generator=gen) < 0.5, -1.0, 1.0)
    cases.append(("equal exponents", same_exp, torch.tensor(
        [[1024, k] for k in (1, 100, 700, 1023)]), 1024))
    # a block of 100 lanes (25 threads in one warp, the float4 path); blocks
    # of 99 and 37 lanes, not a multiple of 4, whose last thread holds lanes
    # past the block, and a buffer 4 bytes off a 16-byte boundary: the
    # kernel's scalar path
    for block, ks in [(100, (1, 10, 33, 50, 99, 100, 5)),
                      (99, (1, 10, 33, 50, 98, 99, 5)), (37, (1, 7, 36))]:
        odd = torch.randn((1, block * len(ks)), generator=gen)
        cases.append((f"block {block}", odd,
                      torch.tensor([[block, k] for k in ks]), block))
    shifted = torch.randn(2 * 1024 + 1, generator=gen).to(dev)[1:]
    if shifted.data_ptr() % 16 == 0:
        fail("topk misaligned drill: the buffer is 16-byte aligned")
    cases.append(("misaligned", shifted.view(1, 2048),
                  torch.tensor([[1024, 102], [1000, 7]]), 1024))
    # the reference server step's per-leaf calls: every VGG-5 leaf as its
    # own buffer, a leaf under 1024 elements one short block
    for shape in layout.shapes:
        n = math.prod(shape)
        b = min(1024, n)
        leaf = torch.randn(n + (-n) % b, generator=gen)
        leaf[n:] = 0.0
        cases.append((f"VGG-5 leaf {shape} at density 0.1", leaf[None],
                      torch.from_numpy(tt.density_block_meta(n, b, 0.1)), b))
    for name, buf, meta, block in cases:
        buf, meta = buf.to(dev), meta.to(torch.int32).to(dev)
        out = tt.topk_compress_flat(buf, meta, block)
        ref = tt.topk_blocks_plain(buf.view(-1, block),
                                   meta.repeat(buf.shape[0], 1)).view_as(buf)
        worst["topk_compress"] = max(worst["topk_compress"],
                                     same(out, ref, f"topk {name}"))
        kept = (out.view(-1, block) != 0).sum(1)
        if not torch.equal(kept, meta[:, 1].repeat(buf.shape[0]).long()):
            fail(f"topk {name}: survivors per block != k")
        print(f"topk_compress {name}: equal")

    # a real client delta masked at width 0.25, as the server step masks it
    # (m * d): whole zero blocks, -0.0 where the mask zeroes a negative
    # entry.  Top-k at density 0.1 decides the lanes of every block with
    # fewer nonzeros than k on its tie path at kth == 0, where the
    # magnitude key makes -0.0 equal to 0.0; the output keeps each lane's
    # sign, so bitwise equality is the keep mask lane for lane.  Then the
    # row's int8 round trip, whose all-zero rows take the floor scale
    row, layout = masked_delta_row(torch, dev)
    blocks = row.view(-1, 1024)
    zero_blocks = int((blocks == 0).all(1).sum())
    neg_zeros = int(((row == 0) & torch.signbit(row)).sum())
    if not zero_blocks or not neg_zeros:
        fail(f"masked delta row: {zero_blocks} zero blocks, {neg_zeros} "
             f"-0.0 entries (the drill needs both)")
    meta = torch.from_numpy(layout.block_meta(0.1)).to(torch.int32).to(dev)
    tie_blocks = int(((blocks != 0).sum(1) < meta[:, 1]).sum())
    out = tt.topk_compress_flat(row[None], meta, 1024)
    worst["topk_compress"] = max(worst["topk_compress"], same(
        out, tt.topk_blocks_plain(blocks, meta).view_as(out),
        "topk masked delta row"))
    print(f"topk_compress masked VGG-5 delta row at width 0.25: equal "
          f"({zero_blocks} zero blocks, {tie_blocks} blocks with kth == 0, "
          f"{neg_zeros} -0.0 entries)")
    quant_drill(blocks, "masked VGG-5 delta row (580, 1024)")
    return worst


def masked_delta_row(torch, dev):
    """A real VGG-5 client delta at width 0.25, masked as the server step
    masks it: one client of phase 4's data, 2 local iterations at OP1 from
    the seed's weights (no int8 cut), ``m * (row - g)`` on the card.
    Returns the row and the layout."""
    from repro_torch.configs.vgg import VGG5
    from repro_torch.data import FleetLoader, make_cifar_like
    from repro_torch.fl.flatbuf import FlatLayout
    from repro_torch.fl.fleet import SequentialEngine
    from repro_torch.fl.hetero import HeteroSpec
    from repro_torch.models.split_program import get_split_program
    program = get_split_program(VGG5)
    params = program.init(torch.Generator().manual_seed(0), dev)
    layout = FlatLayout(params)
    spec = HeteroSpec(program, params, [0.25], layout=layout)
    loader = FleetLoader.for_clients([make_cifar_like(200, seed=1)], 100)
    _, rows = SequentialEngine(program, 2, 0, True, False, dev).run_round(
        params, loader, [VGG5.ops[0]], [0], 0, 0.01, hetero=spec)
    g = layout.flatten(params)
    return spec.mask_row(0) * (layout.flatten(rows[0]) - g), layout


def batched_cut_launches(fl, sizes, native_op, data=1):
    """The batched engine's int8-cut launches (one quantize, one
    dequantize each) for the ``(OP, n clients)`` groups of its calls: per
    local iteration of every chunk below the native OP, chunks of
    ``BATCHED_MAX_GROUP`` clients rounded up to a multiple of the mesh's
    ``data`` size, each chunk's data shards launching apart."""
    chunk = -(-BATCHED_MAX_GROUP // data) * data
    return fl.local_iters * data * sum(-(-n // chunk) for op, n in sizes
                                       if op < native_op)


def expected_launches(h, fl, native_op, n_leaves, mesh_shape=None):
    """Each kernel's launches in one ``run_federated`` run without failures
    or deadline, from its history.  The int8 cut (one quantize, one
    dequantize) runs per local iteration of every client below the native
    OP in the sequential engine, and per local iteration of every chunk
    (an ``(OP, width)`` group below the native OP, cut into
    ``BATCHED_MAX_GROUP`` clients at most) in the batched one.  The fused
    server step takes one top-k (density < 1) and one int8 round trip per
    client row, flat or through the edges; the reference step one top-k
    per leaf (``n_leaves``) and one int8 round trip per kept client.  On a
    ``mesh_shape`` ``(data, model)`` mesh the batched engine's chunks split
    into ``data`` shards, each launching the cut, and the fused step's
    compression paths take each row, padded to a multiple of ``data``,
    once per model shard."""
    assert fl.fail_prob == 0 and fl.deadline_factor == 0, \
        "every client trains and is kept"
    data, model = mesh_shape or (1, 1)
    K = len(h["ops"][0])
    widths = fl.client_widths or (1.0,) * K
    if not fl.quantize_transfer:
        cut = 0
    elif fl.engine == "batched":
        cut = batched_cut_launches(fl, [
            (op, n) for row in h["ops"]
            for (op, _), n in collections.Counter(
                (int(o), float(wk)) for o, wk in zip(row, widths)).items()],
            native_op, data)
    else:
        cut = fl.local_iters * int(sum(op < native_op for row in h["ops"]
                                       for op in row))
    compressed = fl.delta_density < 1 or fl.quantize_deltas
    rows = len(h["ops"]) * ((K + (-K) % data) * model if compressed else K)
    quant = cut + (rows if fl.quantize_deltas else 0)
    per_row = n_leaves if fl.server_step == "reference" else 1
    return {"quantize": quant, "dequantize": quant,
            "topk_compress": rows * per_row if fl.delta_density < 1 else 0,
            "flash_attention": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkdv": 0, "ssd_scan": 0, "ssd_scan_bwd": 0}


def expected_async_launches(h, fl, native_op, K, resumed=False, cfg=None,
                            prefills=0, mesh_shape=None):
    """Each kernel's launches in one ``run_federated_async`` run on live
    links (the sequential engine, an ``sfl`` static OP, the fused server
    step), from its history: the in-flight set of C clients is dispatched
    once at the start (not on resume) and each aggregation but the last
    re-dispatches its ``buffer_size`` reporters, every dispatch running
    the int8 cut once per local iteration below the native OP; each
    aggregation applies its reports less the ``max_staleness`` drops, one
    top-k and one int8 round trip a row.  With ``cfg`` (an LM's config)
    also its sequence mixer's kernels: every local step runs the forward
    twice a layer (the forward and its remat recompute) and the backward
    once, each aggregation's eval pass the forward once a layer, and each
    of ``prefills`` engine prefills (phase 5h's live server) the forward
    once a layer.  The batched engine runs the cut per chunk of a dispatch
    (``batched_cut_launches``); on a ``mesh_shape`` mesh the step's rows
    pad to the ``data`` size and each goes once per model shard."""
    import numpy as np
    assert fl.mode == "sfl" and fl.server_step == "fused", \
        "a static-OP fused run"
    assert np.isfinite(h["times"]).all(), "every report arrives"
    data, model = mesh_shape or (1, 1)
    C = fl.cohort_size or K
    buf = fl.buffer_size or C
    n_agg = len(h["accuracy"])
    sizes = ([] if resumed else [C]) + [buf] * (n_agg - 1)
    dispatched = sum(sizes)
    if not fl.quantize_transfer:
        cut = 0
    elif fl.engine == "batched":
        cut = batched_cut_launches(fl, [(fl.static_op, n) for n in sizes],
                                   native_op, data)
    else:
        cut = (fl.local_iters * dispatched
               if fl.static_op < native_op else 0)
    rows = sum((n + (-n) % data) * model for n in
               (buf - int(d) for d in h["dropped"]))
    quant = cut + (rows if fl.quantize_deltas else 0)
    out = {"quantize": quant, "dequantize": quant,
           "topk_compress": rows if fl.delta_density < 1 else 0,
           "flash_attention": 0, "flash_attention_bwd_dq": 0,
           "flash_attention_bwd_dkdv": 0, "ssd_scan": 0, "ssd_scan_bwd": 0}
    if cfg is not None:
        L, steps = cfg.num_layers, fl.local_iters * dispatched
        fwd, bwd = 2 * L * steps + L * (n_agg + prefills), L * steps
        if cfg.family == "ssm":
            out.update(ssd_scan=fwd, ssd_scan_bwd=bwd)
        else:
            out.update(flash_attention=fwd, flash_attention_bwd_dq=bwd,
                       flash_attention_bwd_dkdv=bwd)
    return out


def vgg5_main_path(torch, dev, launches, reset_launches, engine="sequential",
                   server_step="fused"):
    """Phase 4 (sequential engine, fused server step) and 4c (batched
    engine, reference server step): the port's entry point at full width on
    the paper testbed.  Each path's launch counts are zeroed just before its
    run and read just after; every VGG-path kernel must have launched
    exactly as often as the run's history says it should, flash attention
    and the SSD scan never.  Then one more sfl-op1 round, from the same
    set-up, runs under ``torch.profiler``."""
    from repro_torch.configs.vgg import VGG5
    from repro_torch.core.controller import FedAdaptController
    from repro_torch.core.env import SimulatedCluster
    from repro_torch.core.testbed import paper_testbed
    from repro_torch.data import make_cifar_like, split_clients
    from repro_torch.fl.comm import Transport, device_bandwidths
    from repro_torch.fl.fleet import BatchedEngine
    from repro_torch.fl.loop import FLConfig, run_federated
    from repro_torch.models.split_program import get_split_program

    if inspect.signature(BatchedEngine).parameters["max_group"].default \
            != BATCHED_MAX_GROUP:
        fail("BatchedEngine's default max_group is not BATCHED_MAX_GROUP")
    clients = split_clients(make_cifar_like(5000, seed=1), 5)
    test = make_cifar_like(1000, seed=2)
    w, devices, c_srv, ovh = paper_testbed(VGG5)
    native_op = get_split_program(VGG5).native_op
    paths = {"sfl-op1": dict(mode="sfl", static_op=VGG5.ops[0]),
             "fedadapt": dict(mode="fedadapt")}
    suffix = "" if engine == "sequential" else f"-{engine}-{server_step}"

    def run(name, rounds):
        fl = FLConfig(rounds=rounds, local_iters=10, batch_size=100, seed=0,
                      quantize_transfer=True, delta_density=0.1,
                      quantize_deltas=True, engine=engine,
                      server_step=server_step, **paths[name])
        sim = SimulatedCluster(w, devices, c_srv, VGG5.ops,
                               iterations=fl.local_iters, overhead_s=ovh)
        ctl = (FedAdaptController(w, VGG5.ops, num_groups=3, seed=0,
                                  device=dev)
               if fl.mode == "fedadapt" else None)
        h = run_federated(VGG5, clients, test, fl, sim=sim, controller=ctl,
                          transport=Transport(device_bandwidths(devices)),
                          device=dev)
        torch.cuda.synchronize()
        return h, fl

    runs = {}
    for name in paths:
        reset_launches()
        t0 = time.perf_counter()
        h, fl = run(name, rounds=3)
        total = time.perf_counter() - t0
        counts = dict(launches)
        n_leaves = sum(len(layer) for layer in h["params"])
        want = expected_launches(h, fl, native_op, n_leaves)
        name += suffix
        print(f"{name}: launches {counts} (expected from its history "
              f"{want})")
        for kernel, n in counts.items():
            if n != want[kernel] or (kernel in VGG_KERNELS and n <= 0):
                fail(f"{name}: kernel {kernel} launched {n} times, its "
                     f"history needs {want[kernel]}")
        flat = torch.cat([v.reshape(-1) for layer in h["params"]
                          for v in layer.values()])
        if flat.numel() != 582_346 or not bool(torch.isfinite(flat).all()):
            fail(f"{name}: params not finite or not VGG-5's 582,346")
        acc = h["accuracy"]
        if len(acc) != 3 or not all(0.0 <= a <= 1.0 for a in acc):
            fail(f"{name}: accuracy history {acc}")
        ops = h["ops"].tolist()
        if any(op not in VGG5.ops for row in ops for op in row):
            fail(f"{name}: OPs {ops} outside {VGG5.ops}")
        runs[name] = {"wall_s": [float(t) for t in h["wall_s"]],
                      "total_s": total,
                      "accuracy": [float(a) for a in acc],
                      "round_time_model_s": h["round_time"].tolist(),
                      "times_model_s": h["times"].tolist(),
                      "comm_time_model_s": h["comm_time"].tolist(),
                      "ops": ops, "launches": counts,
                      "engine": engine, "server_step": server_step}
        print(f"{name}: wall per round (s) "
              f"{[round(t, 4) for t in runs[name]['wall_s']]}, "
              f"accuracy {acc.tolist()}, modelled round time (s) "
              f"{[round(t, 3) for t in h['round_time'].tolist()]}, "
              f"ops {ops}", flush=True)
    return runs, profile_device(
        torch, f"one sfl-op1{suffix} round",
        lambda: run("sfl-op1", rounds=1)[0],
        lambda h: float(h["wall_s"][0]) * 1e3)


def batched_against_sequential(runs):
    """Phase 4c's check: the batched engine with the reference server step
    gives phase 4's OPs and modelled round times exactly and its accuracy
    within BATCHED_ACC_ATOL a round."""
    for name in ("sfl-op1", "fedadapt"):
        seq, bat = runs[name], runs[f"{name}-batched-reference"]
        for key in ("ops", "round_time_model_s", "comm_time_model_s"):
            if seq[key] != bat[key]:
                fail(f"{name}: batched/reference {key} {bat[key]} != "
                     f"sequential/fused {seq[key]}")
        diff = max(abs(a - b) for a, b in zip(seq["accuracy"],
                                              bat["accuracy"]))
        if diff > BATCHED_ACC_ATOL:
            fail(f"{name}: batched/reference accuracy {bat['accuracy']} vs "
                 f"sequential/fused {seq['accuracy']}")
        print(f"{name}: batched/reference == sequential/fused (ops, round "
              f"times), accuracy within {diff:.4f} <= {BATCHED_ACC_ATOL}; "
              f"wall per round {bat['wall_s']} vs {seq['wall_s']} s")


def _same_history(a, b, keys, what):
    """Fail unless the histories' ``keys`` and final params are equal, bit
    for bit."""
    import numpy as np
    import torch
    for key in keys:
        if not np.array_equal(a[key], b[key]):
            fail(f"{what}: {key} {b[key]} != {a[key]}")
    for la, lb in zip(a["params"], b["params"]):
        for k in la:
            if not torch.equal(la[k], lb[k]):
                fail(f"{what}: final params differ ({k})")


def async_checkpoint_path(torch, dev, launches, reset_launches):
    """Phase 4d: the async runtime and checkpoints at VGG-5's full width,
    phase 4's set-up (K=5 on the paper testbed, 1000 samples a client,
    batch 100, 10 local iterations, sfl at OP1 with the int8 cut, top-k
    0.1 and int8 deltas, the sequential engine and the fused server step),
    cuDNN held deterministic.  1. ``run_federated_async`` with buffer 5 and
    discount 0 against ``run_federated``, 3 aggregations (rounds): equal.
    2. buffer 3, discount 0.5, 6 aggregations, a checkpoint at 3, then the
    same config resumed: the suffix bitwise, launches exactly as the
    histories need.  3. the fault-tolerance driver's crash and resume
    (``launch/fault_tolerance_drill.py``): bitwise.  4. a combined chaos
    drill (5 clients, 6 aggregations, buffer 2) passes its invariants and
    resumes bitwise from its mid-drill checkpoint.  Also: one checkpoint's
    save and restore seconds, and whether the buffered pair replays bitwise
    with cuDNN's default (non-deterministic) algorithms."""
    import tempfile

    import numpy as np
    from repro_torch.checkpoint import CheckpointManager, save_tree
    from repro_torch.configs.vgg import VGG5
    from repro_torch.core.env import SimulatedCluster
    from repro_torch.core.testbed import paper_testbed
    from repro_torch.data import make_cifar_like, split_clients
    from repro_torch.fl.async_loop import run_federated_async
    from repro_torch.fl.comm import Transport, device_bandwidths
    from repro_torch.fl.flatbuf import FlatLayout
    from repro_torch.fl.loop import FLConfig, run_federated
    from repro_torch.fl.state import async_state_tree
    from repro_torch.launch.fault_tolerance_drill import main as drill_main
    from repro_torch.models.split_program import get_split_program
    from repro_torch.runtime.chaos import ChaosScript, run_chaos_drill

    K = 5
    clients = split_clients(make_cifar_like(1000 * K, seed=1), K)
    test = make_cifar_like(1000, seed=2)
    w, devices, c_srv, ovh = paper_testbed(VGG5)
    program = get_split_program(VGG5)
    native_op = program.native_op
    init = program.init(torch.Generator().manual_seed(0), "cpu")
    base = dict(local_iters=10, batch_size=100, seed=0, mode="sfl",
                static_op=VGG5.ops[0], quantize_transfer=True,
                delta_density=0.1, quantize_deltas=True)
    suffix_keys = ("accuracy", "virtual_time", "staleness", "round_time",
                   "dropped", "agg_weight_sum")
    out = {}

    def counted(name, run, want=None):
        """``run()`` between a zeroing and a read of the launch counts;
        with ``want(h)``, the counts must equal it."""
        reset_launches()
        t0 = time.perf_counter()
        h = run()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = dict(launches)
        hist = h.history if hasattr(h, "history") else h
        row = {"total_s": total, "launches": counts,
               "wall_s": [float(t) for t in hist.get("wall_s", [])],
               "accuracy": [float(a) for a in hist["accuracy"]]}
        if want is not None:
            row["expected_launches"] = want(hist)
            if counts != row["expected_launches"]:
                fail(f"{name}: launches {counts}, its history needs "
                     f"{row['expected_launches']}")
        out[name] = row
        print(f"{name}: {total:.2f} s, wall per aggregation (s) "
              f"{[round(t, 4) for t in row['wall_s']]}, launches {counts}"
              + (" (as its history needs)" if want is not None else ""),
              flush=True)
        return h

    def run_async(fl, resume=False):
        sim = SimulatedCluster(w, devices, c_srv, VGG5.ops,
                               iterations=fl.local_iters, overhead_s=ovh)
        return run_federated_async(
            VGG5, clients, test, fl, sim=sim,
            transport=Transport(device_bandwidths(devices)), resume=resume,
            init_params=init, device=dev)

    def buffered_pair(ck, tag):
        fl = FLConfig(rounds=6, buffer_size=3, staleness_discount=0.5,
                      checkpoint_dir=ck, checkpoint_every=3, **base)
        full = counted(f"async-buffered{tag}", lambda: run_async(fl),
                       lambda h: expected_async_launches(h, fl, native_op,
                                                         K))
        resumed = counted(
            f"async-resumed{tag}", lambda: run_async(fl, resume=True),
            lambda h: expected_async_launches(h, fl, native_op, K,
                                              resumed=True))
        return fl, full, resumed

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # 1. buffer K, discount 0: the sync loop
        fl = FLConfig(rounds=3, buffer_size=K, **base)
        sim = SimulatedCluster(w, devices, c_srv, VGG5.ops,
                               iterations=fl.local_iters, overhead_s=ovh)
        h_sync = counted("async-equiv-sync", lambda: run_federated(
            VGG5, clients, test, fl, sim=sim,
            transport=Transport(device_bandwidths(devices)),
            init_params=init, device=dev),
            lambda h: expected_launches(
                h, fl, native_op, sum(len(x) for x in h["params"])))
        h_async = counted("async-equiv-async", lambda: run_async(fl),
                          lambda h: expected_async_launches(h, fl, native_op,
                                                            K))
        _same_history(h_sync, h_async, ("ops", "times", "accuracy"),
                      "async buffer=K vs sync")
        if not np.allclose(h_async["round_time"], h_sync["round_time"],
                           rtol=1e-12, atol=0):
            fail(f"async buffer=K round_time {h_async['round_time']} vs "
                 f"sync {h_sync['round_time']}")
        if (h_async["staleness"] != 0).any():
            fail(f"async buffer=K staleness {h_async['staleness']}")
        print("async buffer=K, discount 0 == run_federated on the card "
              "(ops, times, accuracy and params bitwise)")

        # 2. buffered async, checkpoint at 3, resume
        with tempfile.TemporaryDirectory() as ck:
            fl, full, resumed = buffered_pair(ck, "")
            tail = {k: (v[-3:] if k != "params" else v)
                    for k, v in full.items()}
            _same_history(tail, resumed, suffix_keys, "async resume")
            if full["staleness"].max() <= 0:
                fail("buffered async: no report was ever stale")
            # one checkpoint's restore and save: params, the dense EF rows
            # and the in-flight rows, host <-> card
            mgr = CheckpointManager(ck)
            layout = FlatLayout(full["params"])
            template = async_state_tree(
                full["params"], torch.zeros((K, layout.padded), device=dev),
                None, K, K, layout, template=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tree, _ = mgr.restore_latest(template)
            tree["async"]["ev_delta"] = torch.from_numpy(
                tree["async"]["ev_delta"]).to(dev)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            path = os.path.join(ck, "timed.npz")
            t0 = time.perf_counter()
            save_tree(path, tree, 3)
            save_s = time.perf_counter() - t0
            out["checkpoint"] = {"bytes": os.path.getsize(path),
                                 "save_s": save_s, "restore_s": restore_s}
            print(f"checkpoint at version 3: {os.path.getsize(path)} bytes, "
                  f"save {save_s:.4f} s, restore {restore_s:.4f} s "
                  f"(params, 5 EF rows and 5 in-flight rows of "
                  f"{layout.padded} fp32)")
        print("async buffered resume == uninterrupted suffix, bitwise")

        # 3. the sync loop's crash and resume, through the driver
        reset_launches()
        drill = drill_main(["--device", str(dev)])
        torch.cuda.synchronize()
        if not drill["bitwise"]:
            fail("fault-tolerance drill: resume not bitwise")
        out["sync-resume-drill"] = {
            "launches": dict(launches),
            "accuracy": [float(a) for a in drill["full"]["accuracy"]],
            "wall_s": [float(t) for t in drill["resumed"]["wall_s"]]}

        # 4. a chaos drill and its mid-drill resume
        script = ChaosScript.combined(K, 6, seed=7)
        with tempfile.TemporaryDirectory() as ck:
            fl = FLConfig(rounds=6, buffer_size=2, staleness_discount=0.5,
                          checkpoint_dir=ck, checkpoint_every=3, **base)

            def drill(resume=False):
                res = run_chaos_drill(VGG5, clients, test, fl, script,
                                      resume=resume, init_params=init,
                                      device=dev)
                if not res.ok():
                    fail(f"chaos drill: {res.violations}")
                return res
            full = counted("chaos-drill", drill).history
            resumed = counted("chaos-drill-resumed",
                              lambda: drill(resume=True)).history
            tail = {k: (v[-3:] if k != "params" else v)
                    for k, v in full.items()}
            _same_history(tail, resumed, suffix_keys, "chaos drill resume")
        print("chaos drill (combined, 5 clients) ok; mid-drill resume "
              "bitwise")
    finally:
        torch.backends.cudnn.deterministic = deterministic

    # the buffered pair once more with cuDNN's default algorithms: does
    # replay stay bitwise without the setting?  A measurement, not a check
    with tempfile.TemporaryDirectory() as ck:
        _, full, resumed = buffered_pair(ck, "-nondeterministic")
    differ = [k for k in suffix_keys
              if not np.array_equal(full[k][-3:], resumed[k])]
    param_diff = max(float((a[k] - b[k]).abs().max())
                     for a, b in zip(full["params"], resumed["params"])
                     for k in a)
    out["without_cudnn_deterministic"] = {
        "bitwise": not differ and param_diff == 0.0,
        "differing_columns": differ, "max_param_diff": param_diff}
    print(f"cudnn.deterministic={deterministic} (default): buffered resume "
          f"{'bitwise' if not differ and param_diff == 0 else 'NOT bitwise'}"
          f" (columns that differ: {differ}, final params within "
          f"{param_diff:.3g})")
    return out


def hetero_hierarchy_path(torch, dev, launches, reset_launches, flat_run,
                          samples=1000, local_iters=10):
    """Phase 4e: HeteroFL widths and the two-tier server at VGG-5's full
    width, phase 4's set-up (K=5 on the paper testbed, ``samples`` a
    client, batch 100, ``local_iters`` local iterations, sfl at OP1 with the
    int8 cut, top-k 0.1 and int8 deltas; 3 rounds).  ``flat_run`` is phase
    4's sfl-op1 record at the same set-up (its per-device modelled times
    and comm).  Every run's launch counts are zeroed just before it and
    must equal what its history needs; the runs:

    1. ``hetero-sfl-op1``: widths ``HETERO_WIDTHS``, the sequential engine
       and the fused step; each device's modelled time is its phase-4
       compute times ``w**2`` plus its comm (rtol 1e-12).
    2. ``hetero-narrow-sfl-op1``: ``NARROW_WIDTHS``; coordinates outside
       every mask keep their initial values bit for bit, a covered one
       moves.
    3. ``edges1-sfl-op1`` against ``flat-sfl-op1`` (homogeneous), cuDNN
       deterministic: histories and params bit for bit.
    4. ``edges2-hetero-sfl-op1``: run 1 through two edges with an
       ``EDGE_BPS`` edge->root hop: ``edge_time`` the slow edge's hop,
       ``round_time`` run 1's plus it.  Then one round's real deltas, EF
       rows and masks through two and three edges against the flat step:
       EF rows bit for bit, the global within ``TIERED_ATOL``.
    5. ``hetero-batched``: run 1 on the batched engine: OPs and times equal
       run 1's, accuracy within ``BATCHED_ACC_ATOL`` a round.
    6. ``async-hetero-edges2``: ``run_federated_async``, buffer 3, discount
       0.5, run 1's widths, two edges and run 4's hop, 6 aggregations:
       ``edge_time`` as derived, ``virtual_time`` that of the same run
       without the hop (``async-hetero-edges2-free``).

    One more round of run 1 runs under ``torch.profiler``."""
    import numpy as np
    from repro_torch.configs.vgg import VGG5
    from repro_torch.core.env import SimulatedCluster
    from repro_torch.core.testbed import paper_testbed
    from repro_torch.data import make_cifar_like, split_clients
    from repro_torch.fl.async_loop import run_federated_async
    from repro_torch.fl.comm import (Transport, device_bandwidths,
                                     indexed_bandwidths)
    from repro_torch.fl.fedavg import model_bytes
    from repro_torch.fl.flatbuf import FlatLayout
    from repro_torch.fl.hetero import HeteroSpec
    from repro_torch.fl.loop import FLConfig, run_federated
    from repro_torch.models.split_program import get_split_program

    K = 5
    clients = split_clients(make_cifar_like(samples * K, seed=1), K)
    test = make_cifar_like(1000, seed=2)
    w, devices, c_srv, ovh = paper_testbed(VGG5)
    program = get_split_program(VGG5)
    native_op = program.native_op
    init = program.init(torch.Generator().manual_seed(0), "cpu")
    base = dict(local_iters=local_iters, batch_size=100, seed=0, mode="sfl",
                static_op=VGG5.ops[0], quantize_transfer=True,
                delta_density=0.1, quantize_deltas=True)
    hop = 2 * model_bytes(init) * 8.0 / min(EDGE_BPS)
    out = {}

    def edge_link():
        return Transport(indexed_bandwidths(EDGE_BPS))

    def counted(name, fl, run, want):
        """``run()`` between a zeroing and a read of the launch counts,
        which must equal ``want(h)``."""
        reset_launches()
        t0 = time.perf_counter()
        h = run()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = dict(launches)
        expected = want(h)
        if counts != expected:
            fail(f"{name}: launches {counts}, its history needs {expected}")
        out[name] = {"wall_s": [float(t) for t in h["wall_s"]],
                     "total_s": total, "launches": counts,
                     "accuracy": [float(a) for a in h["accuracy"]],
                     "round_time_model_s": h["round_time"].tolist(),
                     "edge_time_model_s": h["edge_time"].tolist(),
                     "ops": h["ops"].tolist(),
                     "client_widths": list(fl.client_widths or ()),
                     "num_edges": fl.num_edges, "engine": fl.engine}
        print(f"{name}: {total:.2f} s, wall per round/aggregation (s) "
              f"{[round(t, 4) for t in out[name]['wall_s']]}, launches "
              f"{counts} (as its history needs), accuracy "
              f"{[round(a, 4) for a in out[name]['accuracy']]}", flush=True)
        return h

    def sim():
        return SimulatedCluster(w, devices, c_srv, VGG5.ops,
                                iterations=local_iters, overhead_s=ovh)

    def sync(name, edge_transport=None, **kw):
        fl = FLConfig(rounds=3, **base, **kw)
        return counted(name, fl, lambda: run_federated(
            VGG5, clients, test, fl, sim=sim(),
            transport=Transport(device_bandwidths(devices)),
            edge_transport=edge_transport, init_params=init, device=dev),
            lambda h: expected_launches(
                h, fl, native_op, sum(len(x) for x in h["params"])))

    # 1. widths on the flat server: Eq. 1 compute scaled by w**2
    h1 = sync("hetero-sfl-op1", client_widths=HETERO_WIDTHS)
    comm = np.asarray(flat_run["comm_time_model_s"])
    comp = np.asarray(flat_run["times_model_s"]) - comm
    if h1["ops"].tolist() != flat_run["ops"] or \
            not np.array_equal(h1["comm_time"], comm):
        fail("hetero-sfl-op1: OPs or comm differ from phase 4's sfl-op1")
    want = comp * np.square(HETERO_WIDTHS) + comm
    if not np.allclose(h1["times"], want, rtol=1e-12, atol=0):
        fail(f"hetero-sfl-op1: modelled times {h1['times'].tolist()} != "
             f"phase 4's compute x w**2 + comm {want.tolist()}")
    if (h1["edge_time"] != 0).any():
        fail(f"hetero-sfl-op1: edge_time {h1['edge_time']} without edges")
    print("hetero-sfl-op1: modelled times == phase 4's compute x w**2 + "
          "comm (rtol 1e-12)")
    # one more round of run 1 under the profiler, as phase 4 profiles its
    # sfl-op1 round: what the masks add to the launches and the busy share
    fl1 = FLConfig(rounds=1, client_widths=HETERO_WIDTHS, **base)
    out["profile"] = profile_device(
        torch, "one hetero-sfl-op1 round", lambda: run_federated(
            VGG5, clients, test, fl1, sim=sim(),
            transport=Transport(device_bandwidths(devices)),
            init_params=init, device=dev),
        lambda h: float(h["wall_s"][0]) * 1e3)

    # 2. no full-width client: what no mask covers never moves
    h2 = sync("hetero-narrow-sfl-op1", client_widths=NARROW_WIDTHS)
    init_dev = program.init(torch.Generator().manual_seed(0), dev)
    layout = FlatLayout(init_dev)
    covered = HeteroSpec(program, init_dev, NARROW_WIDTHS,
                         layout=layout).rows(range(K)).sum(0) > 0
    flat0, flat1 = layout.flatten(init_dev), layout.flatten(h2["params"])
    if not torch.equal(flat1[~covered].view(torch.int32),
                       flat0[~covered].view(torch.int32)):
        fail("hetero-narrow-sfl-op1: an uncovered coordinate moved")
    if not bool((flat1[covered] != flat0[covered]).any()):
        fail("hetero-narrow-sfl-op1: no covered coordinate moved")
    print(f"hetero-narrow-sfl-op1: {int((~covered).sum())} uncovered "
          f"coordinates bitwise at their initial values, "
          f"{int((flat1 != flat0).sum())} moved")

    # 3. one edge is the flat step, bit for bit
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        flat = sync("flat-sfl-op1")
        e1 = sync("edges1-sfl-op1", num_edges=1)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    _same_history(flat, e1, ("ops", "times", "round_time", "comm_time",
                             "dropped", "accuracy", "edge_time"),
                  "num_edges=1 vs the flat step")
    print("edges1-sfl-op1 == flat-sfl-op1 on the card (history and params "
          "bitwise, cudnn deterministic)")

    # 4. two edges and the hop
    h4 = sync("edges2-hetero-sfl-op1", client_widths=HETERO_WIDTHS,
              num_edges=2, edge_transport=edge_link())
    if not np.allclose(h4["edge_time"], hop, rtol=1e-9, atol=0):
        fail(f"edges2-hetero-sfl-op1: edge_time {h4['edge_time']} != {hop}")
    if not np.allclose(h4["round_time"], h1["round_time"] + h4["edge_time"],
                       rtol=1e-12, atol=0):
        fail(f"edges2-hetero-sfl-op1: round_time {h4['round_time']} != "
             f"run 1's {h1['round_time']} + the hop")
    worst = tiered_drill(torch, dev, clients, local_iters)
    out["tiered_drill"] = worst
    print(f"edges2-hetero-sfl-op1: edge_time {hop:.6f} s a round; one "
          f"round's real deltas through 2 and 3 edges: EF rows bitwise, "
          f"global within {max(worst.values()):.3g} <= {TIERED_ATOL}")

    # 5. the batched engine, chunks per (OP, width) group
    h5 = sync("hetero-batched", client_widths=HETERO_WIDTHS,
              engine="batched")
    if h5["ops"].tolist() != h1["ops"].tolist() or \
            not np.array_equal(h5["times"], h1["times"]):
        fail("hetero-batched: OPs or modelled times differ from run 1's")
    diff = float(np.max(np.abs(h5["accuracy"] - h1["accuracy"])))
    if diff > BATCHED_ACC_ATOL:
        fail(f"hetero-batched: accuracy {h5['accuracy']} vs sequential "
             f"{h1['accuracy']}")
    print(f"hetero-batched == hetero-sfl-op1 (ops, times), accuracy within "
          f"{diff:.4f} <= {BATCHED_ACC_ATOL}")

    # 6. the async runtime through two edges: the hop reported, not clocked
    fl6 = FLConfig(rounds=6, buffer_size=3, staleness_discount=0.5,
                   client_widths=HETERO_WIDTHS, num_edges=2, **base)

    def run_async(edge_transport):
        return run_federated_async(
            VGG5, clients, test, fl6, sim=sim(),
            transport=Transport(device_bandwidths(devices)),
            edge_transport=edge_transport, init_params=init, device=dev)

    def want_async(h):
        return expected_async_launches(h, fl6, native_op, K)
    h6 = counted("async-hetero-edges2", fl6, lambda: run_async(edge_link()),
                 want_async)
    free = counted("async-hetero-edges2-free", fl6, lambda: run_async(None),
                   want_async)
    if not np.array_equal(h6["virtual_time"], free["virtual_time"]):
        fail(f"async-hetero-edges2: virtual_time {h6['virtual_time']} != "
             f"the run without the hop {free['virtual_time']}")
    if not np.allclose(h6["edge_time"], hop, rtol=1e-9, atol=0) or \
            (free["edge_time"] != 0).any():
        fail(f"async-hetero-edges2: edge_time {h6['edge_time']} (free "
             f"{free['edge_time']}), the hop {hop}")
    print(f"async-hetero-edges2: edge_time {hop:.6f} s an aggregation, "
          f"virtual_time {h6['virtual_time'].tolist()} == the run without "
          f"the hop")
    return out


def vgg5_mesh_path(torch, dev, launches, reset_launches, card=""):
    """Phase 4f: phase 4's sfl-op1 set-up at VGG-5's full width on the
    batched engine and the fused step, mesh-less and over each of
    ``VGG_MESHES`` (``mesh_devices``: ``MESH_PLACES`` places, all ``dev``),
    cuDNN held deterministic: the data = 1 meshes' params and history bit
    for bit the mesh-less run's; at (2, 4) each step within ``MESH_ATOL``
    of the single-device step on its inputs, OPs, modelled times, comm and
    drops exact, accuracy within ``BATCHED_ACC_ATOL`` a round;
    ``run_federated_async`` over
    ``MESH_ASYNC`` checkpointed and resumed, the suffix and params bit for
    bit.  Every run's launches exactly what its history and mesh need.
    Printed with ``card``: each run's wall a round and its server steps'
    seconds against the mesh-less run's."""
    import tempfile

    import numpy as np
    from repro_torch.configs.vgg import VGG5
    from repro_torch.core.env import SimulatedCluster
    from repro_torch.core.testbed import paper_testbed
    from repro_torch.data import make_cifar_like, split_clients
    from repro_torch.fl.async_loop import run_federated_async
    from repro_torch.fl.comm import Transport, device_bandwidths
    from repro_torch.fl.loop import FLConfig, run_federated
    from repro_torch.models.split_program import get_split_program

    K = 5
    clients = split_clients(make_cifar_like(1000 * K, seed=1), K)
    test = make_cifar_like(1000, seed=2)
    w, devices, c_srv, ovh = paper_testbed(VGG5)
    program = get_split_program(VGG5)
    native_op = program.native_op
    init = program.init(torch.Generator().manual_seed(0), "cpu")
    n_leaves = sum(len(layer) for layer in init)
    base = dict(local_iters=10, batch_size=100, seed=0, mode="sfl",
                static_op=VGG5.ops[0], quantize_transfer=True,
                delta_density=0.1, quantize_deltas=True, engine="batched")
    exact = ("ops", "times", "round_time", "comm_time", "dropped")
    out = {}

    def counted(name, run, want):
        """``run()`` between a zeroing and a read of the launch counts,
        its server steps timed; the counts must be ``want(h)``."""
        reset_launches()
        t0 = time.perf_counter()
        with ServerStepProbe(torch, check=False, single=True) as probe:
            h = run()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = dict(launches)
        expected = want(h)
        if counts != expected:
            fail(f"{name}: launches {counts}, its history and mesh need "
                 f"{expected}")
        if any(counts[k] <= 0 for k in VGG_KERNELS):
            fail(f"{name}: a VGG-path kernel never launched: {counts}")
        out[name] = {"total_s": total, "launches": counts,
                     "wall_s": [float(t) for t in h["wall_s"]],
                     "server_step_s": probe["server_step_s"],
                     "step_vs_single_device": probe[
                         "single_device_max_abs_err"],
                     "accuracy": [float(a) for a in h["accuracy"]],
                     "ops": np.asarray(h["ops"]).tolist(),
                     "round_time_model_s": h["round_time"].tolist()}
        print(f"{name}: {total:.2f} s, wall per round (s) "
              f"{[round(t, 4) for t in out[name]['wall_s']]}, server step "
              f"(s) {[round(t, 4) for t in probe['server_step_s']]}, "
              f"launches {counts} (as its history and mesh need)",
              flush=True)
        return h

    def sync(mesh_shape):
        fl = FLConfig(rounds=3, mesh_shape=mesh_shape, **base)
        sim = SimulatedCluster(w, devices, c_srv, VGG5.ops,
                               iterations=fl.local_iters, overhead_s=ovh)
        tag = ("mesh-none" if mesh_shape is None
               else f"mesh-{mesh_shape[0]}x{mesh_shape[1]}")
        return counted(tag, lambda: run_federated(
            VGG5, clients, test, fl, sim=sim,
            transport=Transport(device_bandwidths(devices)),
            init_params=init, device=dev,
            mesh_devices=[dev] * MESH_PLACES),
            lambda h: expected_launches(h, fl, native_op, n_leaves,
                                        mesh_shape))

    def run_async(fl, resume=False):
        sim = SimulatedCluster(w, devices, c_srv, VGG5.ops,
                               iterations=fl.local_iters, overhead_s=ovh)
        return run_federated_async(
            VGG5, clients, test, fl, sim=sim,
            transport=Transport(device_bandwidths(devices)), resume=resume,
            init_params=init, device=dev, mesh_devices=[dev] * MESH_PLACES)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref = sync(None)
        for shape in VGG_MESHES:
            h = sync(shape)
            what = f"mesh {shape} vs mesh-less"
            if shape[0] == 1:
                _same_history(ref, h, ("accuracy",) + exact, what)
                print(f"{what}: params and history bit for bit")
                continue
            for key in exact:
                if not np_equal(ref[key], h[key]):
                    fail(f"{what}: {key} {h[key]} != {ref[key]}")
            # its steps held the single-device step's numbers on their own
            # inputs (ServerStepProbe(single=True)); across the run the
            # fp32 reorderings move int8 codes and top-k near-ties, so the
            # run takes phase 4c's contract between two summation orders
            # of one algorithm (accuracy within BATCHED_ACC_ATOL a round)
            # and its params' gap is recorded
            errs = [(a[k] - b[k]).abs().reshape(-1)
                    / max(float(a[k].abs().max()), 1e-3)
                    for a, b in zip(ref["params"], h["params"]) for k in a]
            gap = max(float(e.max()) for e in errs)
            share = (sum(int((e > FED_LANE_REL).sum()) for e in errs)
                     / sum(e.numel() for e in errs))
            err = max(float((a[k] - b[k]).abs().max())
                      for a, b in zip(ref["params"], h["params"]) for k in a)
            acc = float(np.abs(ref["accuracy"] - h["accuracy"]).max())
            out[f"mesh-{shape[0]}x{shape[1]}"].update(
                params_max_abs_err=err, params_rel=gap, lane_share=share)
            finite = all(bool(torch.isfinite(v).all())
                         for layer in h["params"] for v in layer.values())
            if acc > BATCHED_ACC_ATOL or not finite:
                fail(f"{what}: accuracy within {acc} (<= "
                     f"{BATCHED_ACC_ATOL}?), params finite {finite}")
            steps = out[f"mesh-{shape[0]}x{shape[1]}"][
                "step_vs_single_device"]
            print(f"{what}: OPs, modelled times, comm and drops exact; each "
                  f"step within {max(steps):.3g} <= {MESH_ATOL} of the "
                  f"single-device step on its inputs, EF rows bitwise; "
                  f"accuracy within {acc} <= {BATCHED_ACC_ATOL}; the run's "
                  f"params {err:.3g} apart ({gap:.3g} of a leaf's max, "
                  f"{share:.3g} of the lanes beyond {FED_LANE_REL})")

        # run_federated_async over MESH_ASYNC: 4 aggregations, a
        # checkpoint at 2 (none at the last), then resumed from it
        suffix = ("accuracy", "virtual_time", "staleness", "round_time",
                  "dropped", "agg_weight_sum")
        tag = f"mesh-async-{MESH_ASYNC[0]}x{MESH_ASYNC[1]}"
        with tempfile.TemporaryDirectory() as ck:
            fl = FLConfig(rounds=4, buffer_size=3, staleness_discount=0.5,
                          checkpoint_dir=ck, checkpoint_every=2,
                          mesh_shape=MESH_ASYNC, **base)
            full, resumed = (counted(
                name, lambda: run_async(fl, resume),
                lambda h: expected_async_launches(
                    h, fl, native_op, K, resumed=resume,
                    mesh_shape=MESH_ASYNC))
                for name, resume in ((tag, False),
                                     (f"{tag}-resumed", True)))
        if len(resumed["accuracy"]) != 2:
            fail(f"{tag}: the resumed run took {len(resumed['accuracy'])} "
                 f"aggregations, not the 2 after its checkpoint")
        tail = {k: (v[-2:] if k != "params" else v) for k, v in full.items()}
        _same_history(tail, resumed, suffix, f"{tag} resume")
        if full["staleness"].max() <= 0:
            fail(f"{tag}: no report was ever stale")
        print(f"{tag}: resumed at 2 of 4 aggregations == the straight run's "
              f"suffix and params, bit for bit")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    none = out["mesh-none"]
    for name, r in out.items():
        print(f"{name} ({card}, {MESH_PLACES} places on one card, no "
              f"inter-card traffic): wall a round "
              f"{[round(t, 4) for t in r['wall_s']]} s, server step "
              f"{[round(t, 4) for t in r['server_step_s']]} s; mesh-less "
              f"{[round(t, 4) for t in none['wall_s']]} / "
              f"{[round(t, 4) for t in none['server_step_s']]} s",
              flush=True)
    return out


def tiered_drill(torch, dev, clients, local_iters):
    """Phase 4e, run 4's drill: two rounds of run 1 (the engine, widths,
    the fused step) by hand on the card; round 1's real deltas, EF rows
    (from round 0's step) and masks through two and three edges against
    the flat step.  EF rows bit for bit (an edge computes each client's
    residual from the same row), the global within ``TIERED_ATOL``.
    Returns the global's max abs difference per edge count."""
    from repro_torch.configs.vgg import VGG5
    from repro_torch.data import FleetLoader
    from repro_torch.fl.flatbuf import FlatLayout, ServerStep, get_root_step
    from repro_torch.fl.fleet import SequentialEngine
    from repro_torch.fl.hetero import HeteroSpec
    from repro_torch.fl.hierarchy import hierarchical_apply
    from repro_torch.models.split_program import get_split_program
    K = len(clients)
    program = get_split_program(VGG5)
    params = program.init(torch.Generator().manual_seed(0), dev)
    layout = FlatLayout(params)
    spec = HeteroSpec(program, params, HETERO_WIDTHS, layout=layout)
    engine = SequentialEngine(program, local_iters, 0, True, True, dev)
    loader = FleetLoader.for_clients(clients, 100, seed=0)
    step = ServerStep(layout, 0.1, True)
    weights = [3.0, 1.0, 2.0, 1.0, 4.0]
    g = layout.flatten(params)
    errors = torch.zeros((K, layout.padded), device=dev)
    ops = [VGG5.ops[0]] * K
    for r in range(2):
        idxs, rows = engine.run_round(params, loader, ops, list(range(K)),
                                      r, 0.01, hetero=spec)
        deltas = layout.rows_to_deltas(rows, g)
        masks = spec.rows(idxs)
        if r == 0:
            g, errors = step(g, deltas, weights, errors, masks=masks)
            params = layout.unflatten(g)
    if not bool((errors != 0).any()):
        fail("tiered drill: round 0 left no EF residual")
    flat_g, flat_e = step(g, deltas, weights, errors, masks=masks)
    worst = {}
    for edges in (2, 3):
        got_g, got_e, used = hierarchical_apply(
            step, get_root_step(layout), g, deltas, weights, errors, masks,
            num_edges=edges)
        if used != edges:
            fail(f"tiered drill: {used} edges used of {edges}")
        if not torch.equal(got_e.view(torch.int32),
                           flat_e.view(torch.int32)):
            fail(f"tiered drill: {edges} edges' EF rows != the flat step's")
        worst[edges] = float((got_g - flat_g).abs().max())
        if worst[edges] > TIERED_ATOL:
            fail(f"tiered drill: {edges} edges' global {worst[edges]} from "
                 f"the flat step's > {TIERED_ATOL}")
    return worst


def ppo_training_path(torch, dev, launches, reset_launches):
    """Phase 4b: the PPO agent trained on the card through the quickstart
    driver (``train_rl_agent``, 350 rounds, factored, G=3, the paper
    testbed; then ``run_fl_with_controller``, 5 rounds), and the same run
    of the port on the CPU: the same initial params and the same noise
    (both from the CPU generator of the seed).  The first 30 rounds' OPs
    must be equal and their actions within PPO_ACTION_ATOL; the deployed
    agent on the card must cut the round time by more than 25% against
    classic FL (the repo's end-to-end bar, tests/test_system.py).  PPO
    launches no repo kernel: the counts must stay 0."""
    import numpy as np
    from repro_torch.launch.quickstart import main as quickstart
    argv = ["--train-rounds", str(PPO_TRAIN_ROUNDS), "--deploy-rounds", "5"]
    reset_launches()
    card = quickstart(argv + ["--device", str(dev)])
    torch.cuda.synchronize()
    counts = dict(launches)
    cpu = quickstart(argv + ["--device", "cpu"])
    print(f"train-ppo: launches {counts} (expected none)")
    if any(counts.values()):
        fail(f"train-ppo: repo kernels launched {counts}")
    if card["agent"].params["actor"]["w0"].device.type != "cuda":
        fail("train-ppo: the agent did not train on the card")
    a, b = card["train"], cpu["train"]
    n = PPO_CHECK_ROUNDS
    if not np.array_equal(a["ops"][:n], b["ops"][:n]):
        fail(f"train-ppo: the first {n} rounds' OPs differ card vs cpu")
    act_diff = float(np.abs(a["actions"][:n] - b["actions"][:n]).max())
    if act_diff > PPO_ACTION_ATOL:
        fail(f"train-ppo: actions differ by {act_diff} > {PPO_ACTION_ATOL}")
    parted = np.flatnonzero((a["ops"] != b["ops"]).any(axis=1))
    first = int(parted[0]) + 1 if parted.size else None
    if card["reduction"] <= 0.25:
        fail(f"train-ppo: only {card['reduction']:.0%} reduction on the "
             f"card (paper: 40%)")
    # where the card's time goes: one update (50 epochs) of the trained
    # agent over a buffer of 10 seeded transitions, under the profiler
    agent = card["agent"]
    rng = np.random.RandomState(0)
    buf = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.rand(10, 6), rng.rand(10, 3), rng.randn(10, 3),
        rng.randn(10, 3), rng.rand(10, 6))]
    std = torch.tensor(0.5, device=dev)
    prof = profile_device(
        torch, "one PPO update, 50 epochs",
        lambda: agent._update(agent.params, agent.opt_state, *buf, std))
    out = {"train_s_card": card["train_s"], "train_s_cpu": cpu["train_s"],
           "profile_update": prof,
           "reduction_card": card["reduction"],
           "reduction_cpu": cpu["reduction"],
           "max_action_diff_first_rounds": act_diff,
           "max_action_diff_all": float(np.abs(a["actions"]
                                               - b["actions"]).max()),
           "first_round_ops_differ": first, "rounds": PPO_TRAIN_ROUNDS,
           "launches": counts}
    print(f"train-ppo: {PPO_TRAIN_ROUNDS} rounds in {card['train_s']:.2f} s "
          f"on the card, {cpu['train_s']:.2f} s on the CPU; first {n} "
          f"rounds' OPs equal, actions within {act_diff:.3g}; OPs part at "
          f"round {first}; reduction {card['reduction']:.4f} (card), "
          f"{cpu['reduction']:.4f} (cpu)", flush=True)
    return out


def profile_device(torch, what, run, wall_of=None):
    """A measurement, not a check: ``run()`` under ``torch.profiler``, for
    the card's busy share (profiler on), its top kernels and the part of
    the port's serving kernels (flash attention, the SSD scan).  ``run`` fails the run like any other call; only a
    profiler that records no device time gives "not measured".  The wall
    time is the host clock around ``run`` and a sync, or ``wall_of`` of
    its result."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if wall_of is not None:
        wall_ms = wall_of(res)
    try:
        # kernels and copies only: a CPU op's device time repeats theirs
        stats = [(e.key, e.self_device_time_total, e.count)
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and e.self_device_time_total > 0]
    except (AttributeError, RuntimeError) as e:
        print(f"profile ({what}): not measured ({e})")
        return None
    busy_ms = sum(t for _, t, _ in stats) / 1e3
    if busy_ms <= 0:
        print(f"profile ({what}): not measured (no device time recorded)")
        return None
    stats.sort(key=lambda r: -r[1])
    ours = {name: sum(t for k, t, _ in stats if mark in k) / 1e3
            for name, mark in (("flash_attention", "flash_fwd"),
                               ("flash_attention_bwd_dq", "flash_bwd_dq"),
                               ("flash_attention_bwd_dkdv",
                                "flash_bwd_dkdv"),
                               ("ssd_scan", "ssd_scan_"))}
    # the SSD backward's own device kernels (it also runs the forward's
    # first three passes again, under their names)
    ours["ssd_scan_bwd"] = sum(
        t for k, t, _ in stats
        if "ssd_scan_bwd_" in k or "chunk_states<true>" in k) / 1e3
    # the SSD scan's passes by kernel name (every kernel of its source
    # starts with ssd_scan_)
    ssd_passes = {"ssd_scan_" + k.split("ssd_scan_", 1)[1].split("(")[0]:
                  (t / 1e3, c) for k, t, c in stats if "ssd_scan_" in k}
    top = [{"kernel": k[:80], "ms": t / 1e3, "count": c}
           for k, t, c in stats[:10]]
    launches = sum(c for _, _, c in stats)
    print(f"profile ({what}, profiler on): wall {wall_ms:.1f} ms, device "
          f"busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"{launches} kernels and copies, flash "
          f"attention {ours['flash_attention']:.1f} ms, ssd_scan "
          f"{ours['ssd_scan']:.1f} ms" + (
              f", flash backward dq {ours['flash_attention_bwd_dq']:.1f} ms"
              f" dk/dv {ours['flash_attention_bwd_dkdv']:.1f} ms"
              if ours["flash_attention_bwd_dq"] else "") + (
              f", the SSD backward's own kernels {ours['ssd_scan_bwd']:.1f} "
              f"ms ({100 * ours['ssd_scan_bwd'] / busy_ms:.1f}% of busy)"
              if ours["ssd_scan_bwd"] else ""))
    for row in top:
        print(f"  {row['ms']:9.3f} ms  x{row['count']:<5} {row['kernel']}")
    for name, (ms, count) in ssd_passes.items():
        print(f"  ssd_scan pass {name}: {ms:.3f} ms over {count} launches")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_launches": launches, "port_kernels_ms": ours, "top": top,
            "ssd_scan_passes_ms": {k: v[0] for k, v in ssd_passes.items()}}


def small_cpu_vs_card(torch, dev):
    """Phase 6, federated: the small configuration on the CPU and on the
    card."""
    import numpy as np
    from repro_torch.configs.vgg import VGG5
    from repro_torch.convert import vgg_params_to_numpy
    from repro_torch.core.controller import FedAdaptController
    from repro_torch.core.env import SimulatedCluster
    from repro_torch.core.testbed import paper_testbed
    from repro_torch.data import make_cifar_like, split_clients
    from repro_torch.fl.comm import (Transport, device_bandwidths,
                                     indexed_bandwidths)
    from repro_torch.fl.loop import FLConfig, run_federated
    from repro_torch.models.vgg import init

    clients = split_clients(make_cifar_like(60, seed=1), 3)
    test = make_cifar_like(20, seed=2)
    w, devices, c_srv, ovh = paper_testbed(VGG5)
    init_np = vgg_params_to_numpy(init(VGG5, torch.Generator().manual_seed(0)))
    out = {}
    for mode, (kw, atol) in SMALL_MODES.items():
        hists = {}
        for d in ("cpu", dev):
            sim = SimulatedCluster(w, devices[:3], c_srv, VGG5.ops,
                                   iterations=2, jitter=0.05, seed=3,
                                   overhead_s=ovh)
            ctl = (FedAdaptController(w, VGG5.ops, 3, seed=4, device=d)
                   if kw["mode"] == "fedadapt" else None)
            hists[str(d)] = run_federated(
                VGG5, clients, test, FLConfig(**SMALL, **kw), sim=sim,
                controller=ctl,
                transport=Transport(device_bandwidths(devices[:3])),
                edge_transport=Transport(indexed_bandwidths(EDGE_BPS)),
                init_params=init_np, device=d)
        a, b = hists["cpu"], hists[str(dev)]
        for key in ("ops", "times", "round_time", "comm_time", "dropped",
                    "edge_time"):
            if not np.array_equal(a[key], b[key]):
                fail(f"small {mode}: {key} differs cpu {a[key]} vs card "
                     f"{b[key]}")
        if np.max(np.abs(a["accuracy"] - b["accuracy"])) > 1 / 20 + 1e-9:
            fail(f"small {mode}: accuracy {a['accuracy']} vs {b['accuracy']}")
        diff = max(float(np.max(np.abs(x[k] - y[k])))
                   for x, y in zip(vgg_params_to_numpy(a["params"]),
                                   vgg_params_to_numpy(b["params"]))
                   for k in x)
        if diff > atol:
            fail(f"small {mode}: final params differ by {diff} > {atol}")
        out[mode] = {"max_param_diff": diff, "atol": atol,
                     "accuracy": b["accuracy"].tolist()}
        print(f"small {mode}: cpu == card (ops, times), max param diff "
              f"{diff:.3g} <= {atol}", flush=True)
    return out


def count_params(params) -> int:
    """Elements in a tree of tensors (nested dicts, lists and tuples)."""
    from repro_torch.tree import tree_leaves
    return sum(t.numel() for t in tree_leaves(params))


def free_card(torch):
    """Drop the last phase's tensors from the card and zero the peak."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def flash_drill(torch, tf, q, k, v, causal, window, cap, tol, what):
    """One flash-attention launch against the plain version on the same
    inputs; returns the max abs error."""
    out = tf.flash_attention(q, k, v, causal=causal, window=window,
                             softcap=cap)
    torch.cuda.synchronize()
    want = tf.attention_plain(q, k, v, causal, window, cap)
    if out.shape != want.shape or out.dtype != want.dtype:
        fail(f"flash {what}: {out.dtype}{tuple(out.shape)} vs "
             f"{want.dtype}{tuple(want.shape)}")
    if not bool(torch.isfinite(out).all()):
        fail(f"flash {what}: non-finite output")
    err = float((out.float() - want.float()).abs().max())
    if not torch.allclose(out.float(), want.float(), atol=tol, rtol=tol):
        fail(f"flash {what}: max abs err {err} beyond {tol}")
    print(f"flash_attention {what}: max_abs_err {err:.3g} (tol {tol})",
          flush=True)
    return err


def check_flash(torch, tf, dev):
    """Phase 3, flash attention: the reference's sweep and the drills."""
    gen = torch.Generator(device="cpu").manual_seed(3)
    worst = 0.0
    for B, Sq, Sk, H, KV, D, causal, window, cap, dt in FLASH_CASES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(shape, generator=gen).to(dtype).to(dev)
                   for shape in ((B, Sq, H, D), (B, Sk, KV, D),
                                 (B, Sk, KV, D)))
        worst = max(worst, flash_drill(
            torch, tf, q, k, v, causal, window, cap, FLASH_TOL[dt],
            f"({B}, {Sq}, {Sk}, {H}, {KV}, {D}) causal={causal} "
            f"window={window} softcap={cap} {dt}"))
    # q, k, v 4 bytes off a 16-byte boundary: the kernel takes its 4-byte
    # copies though D is a multiple of 4
    B, S, H, KV, D = 1, 130, 4, 2, 64
    q, k, v = (torch.randn(n + 1, generator=gen).to(dev)[1:].view(shape)
               for n, shape in ((B * S * H * D, (B, S, H, D)),
                                (B * S * KV * D, (B, S, KV, D)),
                                (B * S * KV * D, (B, S, KV, D))))
    if q.data_ptr() % 16 == 0:
        fail("flash misaligned drill: q is 16-byte aligned")
    worst = max(worst, flash_drill(torch, tf, q, k, v, True, 0, 50.0,
                                   FLASH_TOL["float32"],
                                   "(1, 130, 130, 4, 2, 64) misaligned"))
    return worst


def flash_bwd_drill(torch, tf, q, k, v, do, causal, window, cap, what):
    """The forward kernel's output and lse against ``attention_plain_lse``,
    and the backward kernels' dq, dk, dv against ``attention_bwd_plain`` on
    the same q, k, v, o, lse and do, each within FLASH_BWD_REL * max(1,
    max|want|); a row that sees no key must get dq exactly 0; the forward
    without lse (a remat layer's first run) bit for bit the forward with
    it (the recompute the backward differentiates).  Returns
    the max abs errors by name ("out" is the forward kernel's) and their
    bounds under "bounds"."""
    out, lse = tf.flash_attention_lse(q, k, v, causal, window, cap)
    got = tf.flash_attention_bwd(q, k, v, out, lse, do, causal, window, cap)
    with torch.no_grad():
        bare = tf.flash_attention(q, k, v, causal, window, cap)
    torch.cuda.synchronize()
    if not torch.equal(bare, out):
        fail(f"flash bwd {what}: the forward without lse (a remat layer's "
             f"first run) is not bit for bit the forward with it (its "
             f"recompute)")
    want_out, want_lse = tf.attention_plain_lse(q, k, v, causal, window, cap)
    want = tf.attention_bwd_plain(q, k, v, out, lse, do, causal, window, cap)
    empty = torch.isinf(want_lse)
    if not torch.equal(torch.isinf(lse), empty) or bool((lse[empty] < 0)
                                                         .any()):
        fail(f"flash bwd {what}: lse is not +inf exactly on the rows that "
             f"see no key")
    errs, bounds = {}, {}
    pairs = [("out", out, want_out), ("lse", lse[~empty], want_lse[~empty])
             ] + list(zip(("dq", "dk", "dv"), got, want))
    for name, g, w in pairs:
        if not bool(torch.isfinite(g).all()):
            fail(f"flash bwd {what}: non-finite {name}")
        err = float((g - w).abs().max()) if w.numel() else 0.0
        bound = FLASH_BWD_REL * max(1.0, float(w.abs().max())
                                    if w.numel() else 0.0)
        if err > bound:
            fail(f"flash bwd {what}: {name} max abs err {err} beyond "
                 f"{bound}")
        errs[name], bounds[name] = err, bound
    if bool((got[0].transpose(1, 2)[empty] != 0).any()):
        fail(f"flash bwd {what}: a row that sees no key got a nonzero dq")
    print(f"flash_attention_bwd {what}: max_abs_err "
          + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
          + (f"; {int(empty.sum())} rows see no key, dq 0" if empty.any()
             else ""), flush=True)
    return {**errs, "bounds": bounds}


def add_bwd_errs(worst, e):
    """Fold one ``flash_bwd_drill``'s errors into the worst by kernel."""
    for name, err in (("flash_attention", e["out"]),
                      ("flash_attention_bwd_dq", e["dq"]),
                      ("flash_attention_bwd_dkdv", max(e["dk"], e["dv"]))):
        worst[name] = max(worst[name], err)


def check_flash_bwd(torch, tf, dev, worst):
    """Phase 3, the flash backward (``FLASH_BWD_CASES`` and inputs 4 bytes
    off a 16-byte boundary): folds into ``worst`` the max abs errors of the
    forward kernel's output (with its lse on), of the dq kernel and of the
    dk/dv kernel; returns each drill's errors and bounds."""
    gen = torch.Generator(device="cpu").manual_seed(4)
    worst.update(flash_attention_bwd_dq=0.0, flash_attention_bwd_dkdv=0.0)
    drills = {}

    def drill(q, k, v, causal, window, cap, what):
        do = torch.randn(q.shape, generator=gen).to(dev)
        drills[what] = flash_bwd_drill(torch, tf, q, k, v, do, causal,
                                       window, cap, what)
        add_bwd_errs(worst, drills[what])

    for B, Sq, Sk, H, KV, D, causal, window, cap, _ in FLASH_BWD_CASES:
        q, k, v = (torch.randn(shape, generator=gen).to(dev)
                   for shape in ((B, Sq, H, D), (B, Sk, KV, D),
                                 (B, Sk, KV, D)))
        drill(q, k, v, causal, window, cap,
              f"({B}, {Sq}, {Sk}, {H}, {KV}, {D}) causal={causal} "
              f"window={window} softcap={cap}")
    B, S, H, KV, D = 1, 130, 4, 2, 64
    q, k, v = (torch.randn(n + 1, generator=gen).to(dev)[1:].view(shape)
               for n, shape in ((B * S * H * D, (B, S, H, D)),
                                (B * S * KV * D, (B, S, KV, D)),
                                (B * S * KV * D, (B, S, KV, D))))
    if q.data_ptr() % 16 == 0:
        fail("flash bwd misaligned drill: q is 16-byte aligned")
    drill(q, k, v, True, 0, 50.0, "(1, 130, 130, 4, 2, 64) misaligned")
    return drills


def capture_flash_calls(torch, L, run):
    """q, k, v, causal, window and softcap of each flash-attention call
    that ``run()`` makes through ``models.layers`` (each still launches
    the kernel)."""
    calls, kernel = [], L.flash_attention

    def capture(q, k, v, causal=True, window=0, softcap=0.0):
        calls.append((q, k, v, causal, window, softcap))
        return kernel(q, k, v, causal=causal, window=window, softcap=softcap)

    L.flash_attention = capture
    try:
        run()
    finally:
        L.flash_attention = kernel
    torch.cuda.synchronize()
    return calls


def capture_prefill_attention(torch, L, T, cfg, params, tokens, layers,
                              moe_inputs=None):
    """The flash-attention calls (``capture_flash_calls``) of the first
    ``layers`` layers of a real prefill of ``tokens``; with a list
    ``moe_inputs``, each MoE block's input is appended to it too."""
    import dataclasses
    block = L.moe_block

    def capture_moe(cfg_, p, x):
        moe_inputs.append(x)
        return block(cfg_, p, x)

    if moe_inputs is not None:
        L.moe_block = capture_moe
    try:
        return capture_flash_calls(torch, L, lambda: T.forward(
            dataclasses.replace(cfg, num_layers=layers), params, tokens))
    finally:
        L.moe_block = block


def oracle_steps(torch, cfg, params, prompt, gen):
    """The sequential oracle of one request, a step at a time: the same
    ``api.prefill`` / ``api.decode`` calls as ``reference_decode``
    (looked up on ``api`` at each call, so a wrapper set there sees
    them), yielding each token, the top-2 gap of the logits it was chosen
    from, and those (1, V) logits where the params lie."""
    import numpy as np
    from repro_torch.models import api
    leaf = params
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    L = int(len(prompt))
    tokens = torch.as_tensor(np.asarray(prompt, np.int64)[None],
                             device=leaf.device)
    logits, cache = api.prefill(cfg, params, {"tokens": tokens},
                                target_seq=L + gen)
    for i in range(gen):
        if i:
            logits, cache = api.decode(cfg, params, cache, token, L + i - 1)
        token = torch.argmax(logits, -1)[:, None]
        top2 = torch.topk(logits[0], 2).values
        yield int(token[0, 0]), float(top2[0] - top2[1]), logits


def capture_engine_rows(engine, rows):
    """Wrap ``engine.submit`` and ``engine.step`` (over the wrappers they
    already carry): after each decode step, each live request's row of
    ``engine.last_logits`` (a host copy) goes to ``rows[rid, i]``, ``i``
    the index of the token chosen from it (token 0 is the prefill's)."""
    import numpy as np
    submit, step = engine.submit, engine.step
    live = {}                          # slot -> [rid, next token's index]

    def claim(rid, *a, **kw):
        idle = ~engine.active
        r = submit(rid, *a, **kw)
        for s in np.nonzero(idle & engine.active)[0]:
            live[int(s)] = [rid, 1]
        return r

    def decode(*a, **kw):
        before = [(s, *live[s])
                  for s in map(int, np.nonzero(engine.active)[0])]
        r = step(*a, **kw)
        for s, rid, i in before:
            rows[rid, i] = engine.last_logits[s].copy()
            live[s][1] += 1
        return r
    engine.submit, engine.step = claim, decode


def router_gaps(torch, L, gaps):
    """Wrap ``L.moe_route``: each call also appends to ``gaps`` the
    smallest gap between a token's k-th and (k+1)-th router probability
    (a 0-d tensor where the params lie: no sync).  Returns the undo."""
    route = L.moe_route

    def recorded(cfg, p, xf):
        out = route(cfg, p, xf)
        top = torch.topk(L._router_probs(p, xf), cfg.moe.top_k + 1,
                         -1).values
        gaps.append((top[:, -2] - top[:, -1]).min())
        return out
    L.moe_route = recorded
    return lambda: setattr(L, "moe_route", route)


def check_against_oracle(torch, cfg, params, r, rows, what, gaps=None):
    """One served request ``r`` against ``oracle_steps`` on ``params``:
    its tokens up to the first top-2 margin below MARGIN (a near-tie may
    flip under another summation order), and over the same prefix each
    decode step's logits row (``capture_engine_rows``; popped from
    ``rows``, as are the request's later rows) within STEPWISE_TOL of the
    oracle's.  With ``gaps`` (``router_gaps``' list), the logits' prefix
    also ends at the first decode step whose oracle routing has a gap
    below ROUTER_MARGIN.  Compared as it goes: only the largest difference
    is kept.  Returns (tokens compared, decode steps' logits compared, max
    |engine - oracle| logit, the oracle's tokens, its margins)."""
    import numpy as np
    if r.tokens is None or len(r.tokens) != r.gen:
        fail(f"{what}: request {r.rid} gave {r.tokens}, needs {r.gen} "
             f"tokens")
    n, m, diff, ref, margins = 0, 0, 0.0, [], []
    if gaps is not None:
        gaps.clear()
    for i, (tok, margin, logits) in enumerate(
            oracle_steps(torch, cfg, params, r.prompt, r.gen)):
        ref.append(tok)
        margins.append(margin)
        tie = bool(i and gaps) and float(
            torch.stack(gaps).min()) < ROUTER_MARGIN
        if gaps is not None:
            gaps.clear()
        if n < i or margin < MARGIN:
            continue
        if r.tokens[i] != tok:
            fail(f"{what}: request {r.rid} token {i} is {r.tokens[i]}, the "
                 f"oracle's {tok} (margin {margin:.4g})")
        n += 1
        if not i or m < i - 1 or tie:
            continue
        if (r.rid, i) not in rows:
            fail(f"{what}: request {r.rid} step {i}: no logits row captured")
        got = rows[r.rid, i]
        want = logits[0].float().cpu().numpy()
        diff = max(diff, float(np.abs(got - want).max()))
        m += 1
    for i in range(r.gen):
        rows.pop((r.rid, i), None)
    if not diff < STEPWISE_TOL:
        fail(f"{what}: request {r.rid}: decode logits {diff} from the "
             f"oracle's >= {STEPWISE_TOL} over its first {m} decode steps")
    return n, m, diff, ref, margins


def gemma2_main_path(torch, tf, dev, launches, reset_launches):
    """Phase 5: ``ServeEngine`` on gemma2-2b at full width: the real-layer
    flash drills, the served traffic against the sequential oracle (tokens,
    and each decode step's logits: ``check_against_oracle``) with the
    launch count the path needs, and one profiled prefill."""
    import numpy as np
    from repro_torch.configs.gemma2_2b import CONFIG as cfg
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serving import (ServeCosts, ServeEngine,
                                     TrafficGenerator, latency_stats,
                                     serve)
    out = {"config": cfg.name}
    t0 = time.perf_counter()
    params = T.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    n_params = count_params(params)
    norms = cfg.num_layers * 4 * cfg.d_model + cfg.d_model
    if n_params != cfg.param_count() + norms:
        fail(f"gemma2-2b: {n_params} params, the config counts "
             f"{cfg.param_count()} + {norms} norm weights")
    print(f"gemma2-2b: {n_params:,} fp32 params drawn on the card in "
          f"{out['init_s']:.2f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    requests = TrafficGenerator(**SERVE_TRAFFIC).generate()

    # real-layer drills: layer 0 is local (window 4096), layer 1 global
    longest = max(requests, key=lambda r: len(r.prompt))
    padded = np.zeros(SERVE_PROMPT, np.int64)
    padded[:len(longest.prompt)] = longest.prompt
    calls = capture_prefill_attention(
        torch, L, T, cfg, params, torch.from_numpy(padded[None]).to(dev), 2)
    worst, real = 0.0, {}
    for (q, k, v, causal, window, cap), kind in zip(calls, ("local",
                                                            "global")):
        worst = max(worst, flash_drill(
            torch, tf, q, k, v, causal, window, cap, REAL_LAYER_TOL,
            f"gemma2-2b {kind} layer, S={q.shape[1]} window={window} "
            f"softcap={cap}"))
        real[kind] = (q, k, v, window, cap)
    out["real_layer_max_abs_err"] = worst

    # the main path: engine and oracle, counts zeroed just before
    engine = ServeEngine(cfg, params, slots=SERVE_SLOTS,
                         max_prompt=SERVE_PROMPT, max_seq=SERVE_SEQ)
    prefill_s, decode_s = [], []

    def timed(fn, log):
        def run(*a, **kw):
            t = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            log.append(time.perf_counter() - t)
            return r
        return run
    engine.submit = timed(engine.submit, prefill_s)
    engine.step = timed(engine.step, decode_s)
    rows = {}
    capture_engine_rows(engine, rows)
    reset_launches()
    t0 = time.perf_counter()
    res = serve(engine, requests, ServeCosts(prefill=1.0, decode=0.1))
    serve_wall = time.perf_counter() - t0
    if engine.last_logits is None or engine.last_logits.shape != (
            SERVE_SLOTS, cfg.vocab_size) or not np.isfinite(
            engine.last_logits).all():
        fail("gemma2-2b serve: last logits missing, misshapen or not "
             "finite")
    t0 = time.perf_counter()
    compared, stepwise, distinct = 0, {}, {}
    for r in res["requests"]:
        n, m, stepwise[r.rid], _, margins = check_against_oracle(
            torch, cfg, params, r, rows, "gemma2-2b serve")
        distinct[r.rid] = len(set(r.tokens))
        compared += n
        print(f"request {r.rid}: prompt {len(r.prompt)}, gen {r.gen}, "
              f"{n} tokens equal the oracle's (min margin "
              f"{min(margins):.3g}), {distinct[r.rid]} distinct; {m} decode "
              f"steps' logits within {stepwise[r.rid]:.3g} < "
              f"{STEPWISE_TOL}", flush=True)
    oracle_wall = time.perf_counter() - t0
    counts = dict(launches)
    prefills = 2 * len(requests)
    want = {k: 0 for k in counts}
    want["flash_attention"] = cfg.num_layers * prefills
    print(f"serve-gemma2-2b: launches {counts} (expected {want}: "
          f"{cfg.num_layers} layers x {prefills} prefills)")
    if counts != want:
        fail(f"serve-gemma2-2b: launches {counts}, the path needs {want}")
    total = sum(r.gen for r in requests)
    if compared < total // 2:
        fail(f"gemma2-2b serve: only {compared} of {total} tokens compared")
    stats = latency_stats(res)
    busy = sum(prefill_s) + sum(decode_s)
    out.update({
        "requests": [{"rid": r.rid, "prompt": len(r.prompt), "gen": r.gen,
                      "tokens": r.tokens} for r in res["requests"]],
        "tokens_compared": compared, "tokens_total": total,
        "stepwise_max_abs_diff": max(stepwise.values()),
        "stepwise_by_request": stepwise, "distinct_tokens": distinct,
        "prefill_s": prefill_s, "decode_step_s": decode_s,
        "serve_wall_s": serve_wall, "oracle_wall_s": oracle_wall,
        "tokens_per_s": total / busy, "launches": counts,
        "virtual_clock_stats": stats,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30})
    print(f"serve-gemma2-2b: {compared} of {total} tokens compared, all "
          f"equal; decode logits within {max(stepwise.values()):.3g} of "
          f"the oracle's; prefill at {SERVE_PROMPT}: median "
          f"{statistics.median(prefill_s):.3f} s ({len(prefill_s)}); "
          f"decode step ({SERVE_SLOTS} slots): median "
          f"{statistics.median(decode_s) * 1e3:.1f} ms "
          f"({len(decode_s)} steps); {out['tokens_per_s']:.1f} tokens/s "
          f"over engine time {busy:.2f} s (wall {serve_wall:.2f} s); "
          f"oracle {oracle_wall:.2f} s", flush=True)
    # one engine-shaped prefill and one decode step over the pooled cache
    tokens = torch.from_numpy(padded[None]).to(dev)
    out["profile_prefill"] = profile_device(
        torch, f"one prefill, {SERVE_PROMPT} tokens",
        lambda: T.forward(cfg, params, tokens, return_cache=True,
                          cache_seq=SERVE_SEQ))
    step_tok = torch.zeros((SERVE_SLOTS, 1), dtype=torch.long, device=dev)
    step_pos = torch.full((SERVE_SLOTS,), SERVE_PROMPT, device=dev)
    out["profile_decode"] = profile_device(
        torch, f"one decode step, {SERVE_SLOTS} slots",
        lambda: T.decode_step(cfg, params, engine.cache, step_tok, step_pos))
    return out, real


def small_serve_cpu_vs_card(torch, dev):
    """Phase 6, serving: gemma2-2b's smoke config through ``serve`` on the
    CPU (plain attention) and on the card (the kernel), same weights and
    traffic: tokens equal, every decode step's logits within 1e-4."""
    import numpy as np
    from repro_torch import convert
    from repro_torch.configs.gemma2_2b import smoke_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import transformer as T
    from repro_torch.serving import (ServeCosts, ServeEngine,
                                     TrafficGenerator, serve)
    cfg = smoke_config()
    host = T.init(cfg, seed=0, device="cpu")
    card = convert.lm_params_from_numpy(
        convert.lm_params_to_numpy(host), dev)
    traffic = TrafficGenerator(rate=1.5, n_requests=10,
                               vocab_size=cfg.vocab_size,
                               prompt_lens=(3, 12, 40), gen_lens=(1, 3, 6),
                               seed=3)
    runs = {}
    for name, params in (("cpu", host), ("card", card)):
        engine = ServeEngine(cfg, params, slots=3, max_prompt=40,
                             max_seq=52)
        logits, step = [], engine.step

        def logged(step=step, engine=engine, logits=logits):
            done = step()
            logits.append(engine.last_logits)
            return done
        engine.step = logged
        before = LAUNCHES["flash_attention"]
        res = serve(engine, traffic.generate(), ServeCosts(0.4, 0.2))
        runs[name] = ([r.tokens for r in res["requests"]], logits,
                      LAUNCHES["flash_attention"] - before)
    (tok_a, log_a, n_a), (tok_b, log_b, n_b) = runs["cpu"], runs["card"]
    if n_a != 0 or n_b <= 0:
        fail(f"small serve: flash launches cpu {n_a} (needs 0), card {n_b}")
    if tok_a != tok_b:
        fail(f"small serve: tokens differ cpu {tok_a} vs card {tok_b}")
    if len(log_a) != len(log_b):
        fail("small serve: decode step counts differ")
    diff = max(float(np.max(np.abs(a - b))) for a, b in zip(log_a, log_b))
    if diff > SMALL_SERVE_ATOL:
        fail(f"small serve: logits differ by {diff} > {SMALL_SERVE_ATOL}")
    print(f"small serve gemma2-2b smoke: cpu == card tokens "
          f"({sum(map(len, tok_a))}), max logit diff {diff:.3g} <= "
          f"{SMALL_SERVE_ATOL} over {len(log_a)} decode steps; {n_b} "
          f"kernel launches on the card", flush=True)
    return {"tokens": sum(map(len, tok_a)), "max_logit_diff": diff,
            "atol": SMALL_SERVE_ATOL, "card_launches": n_b}


def ssd_drill(torch, ts, args, chunk, init, what):
    """One SSD-scan launch against the plain version on the same inputs,
    on y and on the final state, within SSD_TOL and within SSD_REL of the
    largest plain value; returns the max abs error."""
    y, state = ts.ssd_scan(*args, chunk, init_state=init)
    torch.cuda.synchronize()
    want_y, want_s = ts.ssd_scan_plain(*args, chunk, init)
    err, notes = 0.0, []
    for got, want, name in ((y, want_y, "y"), (state, want_s, "state")):
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            fail(f"ssd_scan {what}: {name} {tuple(got.shape)} not finite or "
                 f"not {tuple(want.shape)}")
        e = float((got - want).abs().max())
        top = float(want.abs().max())
        if not torch.allclose(got, want, atol=SSD_TOL, rtol=SSD_TOL):
            fail(f"ssd_scan {what}: {name} max abs err {e} beyond {SSD_TOL}")
        if e > SSD_REL * top:
            fail(f"ssd_scan {what}: {name} max abs err {e} beyond "
                 f"{SSD_REL} x max|want| = {SSD_REL * top}")
        notes.append(f"{name} {e:.3g} (max|want| {top:.3g}, relative "
                     f"{e / top if top else 0.0:.3g})")
        err = max(err, e)
    print(f"ssd_scan {what}: max_abs_err {'; '.join(notes)} (tol {SSD_TOL}, "
          f"relative {SSD_REL})", flush=True)
    return err


def check_ssd(torch, ts, dev):
    """Phase 3, the SSD scan: the reference's sweep, an entering state and
    mamba2's widths (inputs drawn as the reference's test draws them)."""
    gen = torch.Generator(device="cpu").manual_seed(4)
    worst = 0.0
    for B, S, H, P, N, chunk, init in SSD_CASES:
        def draw(*shape):
            return torch.randn(shape, generator=gen)
        args = [draw(B, S, H, P),
                torch.nn.functional.softplus(draw(B, S, H)),
                -torch.exp(draw(H) * 0.5), draw(B, S, N), draw(B, S, N)]
        s0 = draw(B, H, P, N).to(dev) if init else None
        worst = max(worst, ssd_drill(
            torch, ts, [a.to(dev) for a in args], chunk, s0,
            f"({B}, {S}, {H}, {P}, {N}) chunk={chunk} init_state={init}"))
    return worst


def ssd_bwd_drill(torch, ts, args, chunk, init, dy, dfinal, what):
    """The backward kernel against ``ssd_scan_bwd_plain`` on the same
    inputs, each gradient within SSD_BWD_REL (dA: SSD_BWD_DA_REL) of
    max(1, max|want|), and two calls bitwise equal (no atomics).  Returns
    each gradient's max abs error and that scale by name."""
    got = ts.ssd_scan_bwd(*args, chunk, init, dy, dfinal)
    again = ts.ssd_scan_bwd(*args, chunk, init, dy, dfinal)
    torch.cuda.synchronize()
    want = ts.ssd_scan_bwd_plain(*args, chunk, init, dy, dfinal)
    errs, notes = {}, []
    for name, g, a, w in zip(("dx", "ddt", "dA", "dBm", "dCm", "dinit"),
                             got, again, want):
        if w is None:
            if g is not None:
                fail(f"ssd_scan_bwd {what}: {name} without an init_state")
            continue
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            fail(f"ssd_scan_bwd {what}: {name} {tuple(g.shape)} not finite "
                 f"or not {tuple(w.shape)}")
        if not torch.equal(g, a):
            fail(f"ssd_scan_bwd {what}: two calls give different {name} "
                 f"(the kernel must be bitwise repeatable)")
        e = float((g - w).abs().max())
        scale = max(1.0, float(w.abs().max()))
        tol = SSD_BWD_DA_REL if name == "dA" else SSD_BWD_REL
        if e > tol * scale:
            fail(f"ssd_scan_bwd {what}: {name} max abs err {e} beyond "
                 f"{tol} x {scale:.4g}")
        notes.append(f"{name} {e:.3g} ({e / scale:.2g} of {scale:.3g})")
        errs[name] = {"max_abs_err": e, "scale": scale}
    print(f"ssd_scan_bwd {what}: max_abs_err {'; '.join(notes)}; bitwise "
          f"repeatable", flush=True)
    return errs


def worst_ssd_bwd(drills):
    """The worst max abs error and the worst error over its scale in a
    list of ``ssd_bwd_drill`` results."""
    errs = [e for d in drills for e in d.values()]
    return (max(e["max_abs_err"] for e in errs),
            max(e["max_abs_err"] / e["scale"] for e in errs))


def check_ssd_bwd(torch, ts, dev):
    """Phase 3, the SSD backward: every SSD_CASES shape (its ``init_state``
    flag aside) with an entering state and a final-state gradient, and with
    neither (inputs drawn as ``check_ssd`` draws them).  Returns each
    drill's errors by its name."""
    gen = torch.Generator(device="cpu").manual_seed(6)
    drills = {}
    for B, S, H, P, N, chunk, init in SSD_CASES:
        for with_state in (True, False):
            def draw(*shape):
                return torch.randn(shape, generator=gen).to(dev)
            args = [draw(B, S, H, P),
                    torch.nn.functional.softplus(draw(B, S, H)),
                    -torch.exp(draw(H) * 0.5), draw(B, S, N), draw(B, S, N)]
            s0, dfinal = ((draw(B, H, P, N), draw(B, H, P, N))
                          if with_state else (None, None))
            what = (f"({B}, {S}, {H}, {P}, {N}) chunk={chunk} "
                    f"init_state/dfinal={with_state}")
            drills[what] = ssd_bwd_drill(torch, ts, args, chunk, s0,
                                         draw(B, S, H, P), dfinal, what)
    return drills


def capture_ssd_inputs(torch, S_model, cfg, params, tokens, layers):
    """The SSD-scan inputs of the listed layers of a real prefill of
    ``tokens`` (the call of layer i is the i-th call of ``ssd_scan``)."""
    calls, kernel = [], S_model.ssd_scan

    def capture(x, dt, A, Bm, Cm, chunk, init_state=None):
        if len(calls) in layers:
            calls.append((x, dt, A, Bm, Cm))
        else:
            calls.append(None)
        return kernel(x, dt, A, Bm, Cm, chunk, init_state)

    S_model.ssd_scan = capture
    try:
        S_model.forward(cfg, params, tokens)
    finally:
        S_model.ssd_scan = kernel
    torch.cuda.synchronize()
    return {i: calls[i] for i in layers}


def mamba2_main_path(torch, ts, dev, launches, reset_launches):
    """Phase 5b: mamba2-780m served at full width through the port's entry
    points (``reference_decode``, ``api.prefill``, ``api.decode``): the
    real-layer SSD drills, sequential serving of 4 prompts, a batch of 4
    rows against the oracle, the stepwise oracle, and the launch counts
    the path needs."""
    import numpy as np
    from repro_torch.configs.mamba2_780m import CONFIG as cfg
    from repro_torch.models import api
    from repro_torch.models import ssm as S_model
    from repro_torch.serving import reference_decode
    out = {"config": cfg.name}
    free_card(torch)
    t0 = time.perf_counter()
    params = api.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    n_params = count_params(params)
    if n_params != 857_379_072:
        fail(f"mamba2-780m: {n_params} params, its init shapes give "
             f"857,379,072")
    out["params"] = n_params
    print(f"mamba2-780m: {n_params:,} fp32 params drawn on the card in "
          f"{out['init_s']:.2f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    rng = np.random.RandomState(0)
    prompts = {L: rng.randint(0, cfg.vocab_size, L) for L in MAMBA_PROMPTS}
    rows = [prompts[MAMBA_ROW_PROMPT]] + [
        rng.randint(0, cfg.vocab_size, MAMBA_ROW_PROMPT)
        for _ in range(MAMBA_ROWS - 1)]

    # real-layer drills: the first and the last layer, at S=4096 and at
    # S=1000 (a ragged last chunk)
    worst, real = 0.0, None
    last = cfg.num_layers - 1
    for L in MAMBA_DRILLS:
        tokens = torch.from_numpy(prompts[L][None]).to(dev)
        caught = capture_ssd_inputs(torch, S_model, cfg, params, tokens,
                                    (0, last))
        for i, args in caught.items():
            worst = max(worst, ssd_drill(
                torch, ts, list(args), cfg.ssm.chunk, None,
                f"mamba2-780m layer {i}, S={L}"))
        if L == MAMBA_ROW_PROMPT:
            real = caught[0]
        del caught
    out["real_layer_max_abs_err"] = worst

    # the main path, counts zeroed just before: every prefill and decode
    # step goes through the entry points, timed to a sync
    timing = {"prefill": [], "decode": []}
    prefill, decode = api.prefill, api.decode

    def timed(fn, kind):
        def run(cfg_, params_, *a, **kw):
            t = time.perf_counter()
            r = fn(cfg_, params_, *a, **kw)
            torch.cuda.synchronize()
            shape = (a[0]["tokens"] if kind == "prefill" else a[1]).shape
            timing[kind].append((tuple(shape), time.perf_counter() - t))
            return r
        return run
    api.prefill, api.decode = timed(prefill, "prefill"), timed(decode,
                                                               "decode")
    try:
        reset_launches()
        t0 = time.perf_counter()
        # 1. sequential serving: one request at a time
        seq = {}
        for L, prompt in prompts.items():
            toks, margins = reference_decode(cfg, params, prompt, MAMBA_GEN,
                                             return_margins=True)
            seq[L] = (toks, margins)
            print(f"sequential: prompt {L}, {MAMBA_GEN} tokens, min top-2 "
                  f"margin {min(margins):.3g}", flush=True)
        seq_wall = time.perf_counter() - t0
        n_seq = len(timing["prefill"]), len(timing["decode"])
        # 2. the batched path: one prefill over 4 rows, then 31 decodes
        t0 = time.perf_counter()
        batch = torch.from_numpy(np.stack(rows)).to(dev)
        logits, cache = api.prefill(cfg, params, {"tokens": batch})
        got = []
        for i in range(MAMBA_GEN):
            if i:
                logits, cache = api.decode(cfg, params, cache, token,
                                           MAMBA_ROW_PROMPT + i - 1)
            token = torch.argmax(logits, -1)[:, None]
            got.append(token[:, 0].tolist())
        batch_wall = time.perf_counter() - t0
        if not bool(torch.isfinite(logits).all()) or logits.shape != (
                MAMBA_ROWS, cfg.vocab_size):
            fail(f"mamba2-780m batch: last logits {tuple(logits.shape)} "
                 f"not finite or misshapen")
        del cache
        got = np.asarray(got).T                       # (rows, gen)
        compared = 0
        for r, prompt in enumerate(rows):
            ref, margins = seq[MAMBA_ROW_PROMPT] if r == 0 else \
                reference_decode(cfg, params, prompt, MAMBA_GEN,
                                 return_margins=True)
            n = 0
            for i in range(MAMBA_GEN):
                if margins[i] < MARGIN:
                    break
                if got[r, i] != ref[i]:
                    fail(f"mamba2-780m batch: row {r} token {i} is "
                         f"{got[r, i]}, the oracle's {ref[i]} (margin "
                         f"{margins[i]:.4g})")
                n += 1
            compared += n
            print(f"batch row {r}: {n} of {MAMBA_GEN} tokens equal the "
                  f"oracle's (min margin {min(margins):.3g})", flush=True)
        if compared < MAMBA_ROWS * MAMBA_GEN // 2:
            fail(f"mamba2-780m batch: only {compared} of "
                 f"{MAMBA_ROWS * MAMBA_GEN} tokens compared")
        # 3. the stepwise oracle: the 300-token prompt one token at a time
        L = MAMBA_PROMPTS[0]
        tokens = torch.from_numpy(prompts[L][None]).to(dev)
        want, want_cache = api.prefill(cfg, params, {"tokens": tokens})
        step_cache = api.init_cache(cfg, 1, L, torch.float32, dev)
        for i in range(L):
            step, step_cache = api.decode(cfg, params, step_cache,
                                          tokens[:, i:i + 1], i)
        stepwise = {}
        for name, a, b in (("logits", step, want),
                           ("conv", step_cache["conv"], want_cache["conv"]),
                           ("state", step_cache["state"],
                            want_cache["state"])):
            stepwise[name] = float((a - b).abs().max())
            if not stepwise[name] < STEPWISE_TOL:
                fail(f"mamba2-780m stepwise oracle: {name} differs by "
                     f"{stepwise[name]} >= {STEPWISE_TOL}")
        print(f"stepwise oracle ({L} decode steps from zero caches): max "
              f"abs diff {stepwise} < {STEPWISE_TOL}", flush=True)
        counts = dict(launches)
    finally:
        api.prefill, api.decode = prefill, decode
    prefills = len(timing["prefill"])
    if prefills != len(MAMBA_PROMPTS) + 1 + (MAMBA_ROWS - 1) + 1:
        fail(f"mamba2-780m: {prefills} prefills, the path makes "
             f"{len(MAMBA_PROMPTS) + MAMBA_ROWS + 1}")
    want_counts = {k: 0 for k in counts}
    want_counts["ssd_scan"] = cfg.num_layers * prefills
    print(f"serve-mamba2-780m: launches {counts} (expected {want_counts}: "
          f"{cfg.num_layers} layers x {prefills} prefills)")
    if counts != want_counts:
        fail(f"serve-mamba2-780m: launches {counts}, the path needs "
             f"{want_counts}")

    # records: prefill seconds by prompt, decode ms per step by rows
    pre = {}
    for shape, t in timing["prefill"]:
        pre.setdefault(f"{shape[0]}x{shape[1]}", []).append(t)
    seq_pre = [t for _, t in timing["prefill"][:n_seq[0]]]
    seq_dec = [t for _, t in timing["decode"][:n_seq[1]]]
    rows_dec = [t for shape, t in timing["decode"]
                if shape[0] == MAMBA_ROWS]
    batch_busy = pre[f"{MAMBA_ROWS}x{MAMBA_ROW_PROMPT}"][0] + sum(rows_dec)
    seq_busy = sum(seq_pre) + sum(seq_dec)
    out.update({
        "sequential": {str(L): seq[L][0] for L in MAMBA_PROMPTS},
        "min_margin": {str(L): min(seq[L][1]) for L in MAMBA_PROMPTS},
        "batch_tokens": got.tolist(), "tokens_compared": compared,
        "stepwise_max_abs_diff": stepwise, "launches": counts,
        "prefill_s": pre,
        "decode_step_ms_1row": [t * 1e3 for t in seq_dec],
        "decode_step_ms_rows": [t * 1e3 for t in rows_dec],
        "tokens_per_s_sequential": len(MAMBA_PROMPTS) * MAMBA_GEN / seq_busy,
        "tokens_per_s_batch": MAMBA_ROWS * MAMBA_GEN / batch_busy,
        "sequential_wall_s": seq_wall, "batch_wall_s": batch_wall,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30})
    print(f"serve-mamba2-780m: prefill (s) "
          f"{ {k: [round(t, 4) for t in v] for k, v in pre.items()} }; "
          f"decode step median "
          f"{statistics.median(seq_dec) * 1e3:.1f} ms "
          f"at 1 row, {statistics.median(rows_dec) * 1e3:.1f} ms at "
          f"{MAMBA_ROWS} rows; {out['tokens_per_s_sequential']:.1f} tokens/s "
          f"sequential (engine time {seq_busy:.2f} s), "
          f"{out['tokens_per_s_batch']:.1f} tokens/s over {MAMBA_ROWS} rows "
          f"(engine time {batch_busy:.2f} s); peak memory "
          f"{out['peak_memory_gib']:.2f} GiB", flush=True)
    tokens = torch.from_numpy(np.stack(rows)).to(dev)
    out["profile_prefill"] = profile_device(
        torch, f"one prefill, {MAMBA_ROW_PROMPT} tokens",
        lambda: prefill(cfg, params, {"tokens": tokens[:1]}))
    cache = api.init_cache(cfg, MAMBA_ROWS, 1, torch.float32, dev)
    step_tok = tokens[:, :1]
    out["profile_decode"] = profile_device(
        torch, f"one decode step, {MAMBA_ROWS} rows",
        lambda: decode(cfg, params, cache, step_tok, 0))
    return out, real


def mixtral_main_path(torch, tf, dev, launches, reset_launches):
    """Phase 5c, MoE: ``ServeEngine`` on mixtral-8x22b at full width (6
    layers, capacity factor 4.0; see ``MIXTRAL_LAYERS``): the real-layer
    flash drills, the capacity path against the exact path on a real
    layer, the served traffic against the sequential oracle through a
    wrapped rolling cache (tokens, and each decode step's logits:
    ``check_against_oracle``), decode through that cache against a full
    forward, the launch counts the path needs, and the timings."""
    import dataclasses

    import numpy as np
    from repro_torch.configs.mixtral_8x22b import CONFIG
    from repro_torch.models import api
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serving import (ServeCosts, ServeEngine,
                                     TrafficGenerator, latency_stats,
                                     serve)
    cfg = dataclasses.replace(
        CONFIG, num_layers=MIXTRAL_LAYERS,
        moe=dataclasses.replace(CONFIG.moe, capacity_factor=MIXTRAL_CF))
    out = {"config": cfg.name, "layers": MIXTRAL_LAYERS,
           "of_layers": CONFIG.num_layers, "capacity_factor": MIXTRAL_CF}
    free_card(torch)
    t0 = time.perf_counter()
    params = api.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    n_params = count_params(params)
    norms = cfg.num_layers * 2 * cfg.d_model + cfg.d_model
    if n_params != cfg.param_count() + norms:
        fail(f"mixtral-8x22b: {n_params} params, the config counts "
             f"{cfg.param_count()} + {norms} norm weights")
    out["params"] = n_params
    out["init_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"mixtral-8x22b ({MIXTRAL_LAYERS} of {CONFIG.num_layers} layers, "
          f"capacity factor {MIXTRAL_CF}): {n_params:,} fp32 params drawn on "
          f"the card in {out['init_s']:.2f} s; peak memory "
          f"{out['init_peak_gib']:.2f} GiB", flush=True)
    requests = TrafficGenerator(**MIXTRAL_TRAFFIC).generate()
    CL = T.cache_len(cfg, MIXTRAL_SEQ)
    wrapped = {r.rid: r for r in requests if len(r.prompt) + r.gen - 2 >= CL}
    if CL != cfg.window or not wrapped:
        fail(f"mixtral traffic: cache {CL}, no request decodes past it")

    # real layers: flash on the first and the last layer's q, k, v, and
    # layer 0's MoE input through both branches
    longest = max(requests, key=lambda r: len(r.prompt))
    padded = np.zeros(MIXTRAL_PROMPT, np.int64)
    padded[:len(longest.prompt)] = longest.prompt
    tokens = torch.from_numpy(padded[None]).to(dev)
    moe_in = []
    calls = capture_prefill_attention(torch, L, T, cfg, params, tokens,
                                      cfg.num_layers, moe_inputs=moe_in)
    worst = 0.0
    for i in (0, cfg.num_layers - 1):
        q, k, v, causal, window, cap = calls[i]
        worst = max(worst, flash_drill(
            torch, tf, q, k, v, causal, window, cap, REAL_LAYER_TOL,
            f"mixtral-8x22b layer {i}, S={q.shape[1]} H={q.shape[2]} "
            f"KV={k.shape[2]} D={q.shape[3]} window={window}"))
    out["real_layer_max_abs_err"] = worst
    real = calls[0][:3] + (calls[0][4], calls[0][5])
    h0 = moe_in[0]
    del calls, moe_in
    p0 = T.layer_params(params, 0)
    xf = h0.reshape(-1, cfg.d_model)
    topw, topi = L.moe_route(cfg, p0["moe"], xf)
    C, _, keep = L.moe_dispatch(cfg, topi)
    if C < xf.shape[0] or not bool(keep.all()):
        fail(f"mixtral MoE: capacity {C} for {xf.shape[0]} tokens drops")
    cap_y = L._moe_capacity(cfg, p0["moe"], xf, topw, topi)
    exact_y = L._moe_decode_exact(cfg, p0["moe"], xf, topw, topi)
    moe_err = float((cap_y - exact_y).abs().max())
    moe_bound = MOE_REL_TOL * float(exact_y.abs().max())
    if not np.isfinite(moe_err) or moe_err > moe_bound:
        fail(f"mixtral MoE layer 0: capacity path vs exact path max abs "
             f"err {moe_err} > {moe_bound}")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_err = float((L._moe_capacity(cfg, p0["moe"], xf, topw, topi)
                          - exact_y).abs().max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    if not tf32_err > moe_bound:
        fail(f"mixtral MoE layer 0: with TF32 products the capacity path is "
             f"within {tf32_err} <= {moe_bound} of the exact path: the bound "
             f"cannot tell TF32 from fp32")
    load = torch.bincount(topi.reshape(-1),
                          minlength=cfg.moe.num_experts).tolist()
    out.update({"moe_max_abs_err": moe_err, "moe_bound": moe_bound,
                "moe_tf32_max_abs_err": tf32_err,
                "expert_load_layer0": load})
    print(f"mixtral MoE layer 0 (T={xf.shape[0]}, C={C}, expert load "
          f"{load}): capacity path vs exact path max abs err "
          f"{moe_err:.3g} <= {MOE_REL_TOL} x max|y| = {moe_bound:.3g}; "
          f"with TF32 products {tf32_err:.3g} "
          f"({tf32_err / moe_bound:.1f}x the bound)", flush=True)
    del cap_y, exact_y

    # the main path, counts zeroed just before: engine, oracle, and decode
    # through the wrapped cache against a full forward
    engine = ServeEngine(cfg, params, slots=MIXTRAL_SLOTS,
                         max_prompt=MIXTRAL_PROMPT, max_seq=MIXTRAL_SEQ)
    prefill_s, decode_s = [], []
    submit, step = engine.submit, engine.step

    def timed_submit(*a, **kw):
        t = time.perf_counter()
        r = submit(*a, **kw)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t)
        return r

    def timed_step():
        active = engine.num_active
        t = time.perf_counter()
        r = step()
        torch.cuda.synchronize()
        decode_s.append((active, time.perf_counter() - t))
        return r
    engine.submit, engine.step = timed_submit, timed_step
    rows = {}
    capture_engine_rows(engine, rows)
    oracle_decode_s = []
    decode = api.decode

    def timed_decode(*a, **kw):
        t = time.perf_counter()
        r = decode(*a, **kw)
        torch.cuda.synchronize()
        oracle_decode_s.append(time.perf_counter() - t)
        return r
    reset_launches()
    t0 = time.perf_counter()
    res = serve(engine, requests, ServeCosts(prefill=1.0, decode=0.1))
    serve_wall = time.perf_counter() - t0
    if engine.last_logits is None or engine.last_logits.shape != (
            MIXTRAL_SLOTS, cfg.vocab_size) or not np.isfinite(
            engine.last_logits).all():
        fail("mixtral serve: last logits missing, misshapen or not finite")
    t0 = time.perf_counter()
    compared, oracle, stepwise, distinct, steps = 0, {}, {}, {}, {}
    gaps = []
    api.decode = timed_decode
    unroute = router_gaps(torch, L, gaps)
    try:
        for r in res["requests"]:
            n, steps[r.rid], stepwise[r.rid], oracle[r.rid], margins = \
                check_against_oracle(torch, cfg, params, r, rows,
                                     "mixtral serve", gaps)
            distinct[r.rid] = len(set(r.tokens))
            compared += n
            print(f"request {r.rid}: prompt {len(r.prompt)}, gen {r.gen}"
                  f"{' (wraps the cache)' if r.rid in wrapped else ''}, {n} "
                  f"tokens equal the oracle's (min margin "
                  f"{min(margins):.3g}), {distinct[r.rid]} distinct; "
                  f"{steps[r.rid]} decode steps' logits (to the first router "
                  f"gap below {ROUTER_MARGIN}) within "
                  f"{stepwise[r.rid]:.3g} < {STEPWISE_TOL}", flush=True)
    finally:
        api.decode = decode
        unroute()
    oracle_wall = time.perf_counter() - t0
    # decode through the wrapped cache against a full forward: the
    # request's prompt and oracle tokens, the last decode step's logits
    # (position L + gen - 2 >= CL) against a prefill over L + gen - 1
    r = max(wrapped.values(), key=lambda r: len(r.prompt) + r.gen)
    Lp = len(r.prompt)
    seq = np.concatenate([r.prompt, oracle[r.rid][:-1]]).astype(np.int64)
    tokens = torch.from_numpy(seq[None]).to(dev)
    logits, cache = api.prefill(cfg, params, {"tokens": tokens[:, :Lp]},
                                target_seq=Lp + r.gen)
    for i in range(1, r.gen):
        logits, cache = api.decode(cfg, params, cache,
                                   tokens[:, Lp + i - 1:Lp + i], Lp + i - 1)
    del cache
    full, _ = api.prefill(cfg, params, {"tokens": tokens},
                          target_seq=Lp + r.gen)
    wrap_err = float((logits - full).abs().max())
    if not wrap_err < STEPWISE_TOL:
        fail(f"mixtral: decode through the wrapped cache (position "
             f"{Lp + r.gen - 2}, cache {CL}) vs full forward: {wrap_err} >= "
             f"{STEPWISE_TOL}")
    print(f"mixtral: decode through the wrapped cache to position "
          f"{Lp + r.gen - 2} (cache {CL}) vs a full forward over "
          f"{len(seq)} tokens: max abs logit diff {wrap_err:.3g} < "
          f"{STEPWISE_TOL}", flush=True)
    counts = dict(launches)
    prefills = 2 * len(requests) + 2
    want = {k: 0 for k in counts}
    want["flash_attention"] = cfg.num_layers * prefills
    print(f"serve-mixtral-8x22b: launches {counts} (expected {want}: "
          f"{cfg.num_layers} layers x {prefills} prefills)")
    if counts != want:
        fail(f"serve-mixtral-8x22b: launches {counts}, the path needs "
             f"{want}")
    total = sum(r.gen for r in requests)
    if compared < total // 2:
        fail(f"mixtral serve: only {compared} of {total} tokens compared")

    # timings outside the counted run: one prefill at the config's own
    # capacity factor, and one layer's MoE and attention blocks apart
    own = dataclasses.replace(cfg, moe=CONFIG.moe)
    tokens = torch.from_numpy(padded[None]).to(dev)
    t0 = time.perf_counter()
    T.forward(own, params, tokens, return_cache=True, cache_seq=MIXTRAL_SEQ)
    torch.cuda.synchronize()
    own_prefill_s = time.perf_counter() - t0
    x0 = T.embed_inputs(cfg, params, tokens)
    h_attn = L.rms_norm(x0, p0["ln1"])
    positions = torch.arange(MIXTRAL_PROMPT, device=dev)
    layer_ms = {
        "attention_block": time_ms(lambda: L.attention_block(
            cfg, p0["attn"], h_attn, positions, window=cfg.window),
            graph=False, reps=3, inner=2),
        "flash_attention": time_ms(lambda: tf.flash_attention(
            *real[:3], True, real[3], real[4]), graph=False, reps=3, inner=2),
        f"moe_block_cf{MIXTRAL_CF}": time_ms(
            lambda: L.moe_block(cfg, p0["moe"], h0), graph=False, reps=3,
            inner=1),
        f"moe_block_cf{CONFIG.moe.capacity_factor}": time_ms(
            lambda: L.moe_block(own, p0["moe"], h0), graph=False, reps=3,
            inner=1)}
    del x0, h_attn
    by_active = {}
    for active, t in decode_s:
        by_active.setdefault(active, []).append(t)
    busy = sum(prefill_s) + sum(t for _, t in decode_s)
    out.update({
        "requests": [{"rid": r.rid, "prompt": len(r.prompt), "gen": r.gen,
                      "tokens": r.tokens} for r in res["requests"]],
        "tokens_compared": compared, "tokens_total": total,
        "stepwise_max_abs_diff": max(stepwise.values()),
        "stepwise_by_request": stepwise, "stepwise_steps": steps,
        "distinct_tokens": distinct,
        "wrap_logit_max_abs_diff": wrap_err, "launches": counts,
        "prefill_s": prefill_s, f"prefill_s_cf{CONFIG.moe.capacity_factor}":
        own_prefill_s, "decode_step_s_by_active": by_active,
        "decode_step_s_1row_oracle": oracle_decode_s, "layer_ms": layer_ms,
        "serve_wall_s": serve_wall, "oracle_wall_s": oracle_wall,
        "tokens_per_s": total / busy, "virtual_clock_stats":
        latency_stats(res),
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30})
    med = {a: statistics.median(v) * 1e3 for a, v in sorted(by_active.items())}
    print(f"serve-mixtral-8x22b: {compared} of {total} tokens compared, all "
          f"equal; {sum(steps.values())} decode steps' logits within "
          f"{max(stepwise.values()):.3g} of the oracle's; prefill at "
          f"{MIXTRAL_PROMPT} (cf {MIXTRAL_CF}): median "
          f"{statistics.median(prefill_s):.3f} s ({len(prefill_s)}), at cf "
          f"{CONFIG.moe.capacity_factor}: {own_prefill_s:.3f} s; decode "
          f"step ({MIXTRAL_SLOTS} slots) median ms by active slots "
          f"{ {a: round(m, 1) for a, m in med.items()} }, oracle (1 row) "
          f"median {statistics.median(oracle_decode_s) * 1e3:.1f} ms; "
          f"{out['tokens_per_s']:.1f} tokens/s over engine time {busy:.2f} s"
          f" (wall {serve_wall:.2f} s); oracle {oracle_wall:.2f} s; peak "
          f"memory {out['peak_memory_gib']:.2f} GiB", flush=True)
    print(f"mixtral layer 0 at {MIXTRAL_PROMPT} tokens (ms, eager): "
          f"{ {k: round(v, 2) for k, v in layer_ms.items()} }", flush=True)
    out["profile_prefill"] = profile_device(
        torch, f"one prefill, {MIXTRAL_PROMPT} tokens, cf {MIXTRAL_CF}",
        lambda: T.forward(cfg, params, tokens, return_cache=True,
                          cache_seq=MIXTRAL_SEQ))
    step_tok = torch.zeros((MIXTRAL_SLOTS, 1), dtype=torch.long, device=dev)
    step_pos = torch.full((MIXTRAL_SLOTS,), MIXTRAL_PROMPT, device=dev)
    out["profile_decode"] = profile_device(
        torch, f"one decode step, {MIXTRAL_SLOTS} slots",
        lambda: T.decode_step(cfg, params, engine.cache, step_tok, step_pos))
    return out, real


def internvl2_main_path(torch, dev, launches, reset_launches):
    """Phase 5c, VLM: internvl2-2b at full width and depth through
    ``api.prefill`` / ``api.decode``: 2 rows of 256 seeded patch embeddings
    and 744 tokens, 16 greedy decode steps after the patches, the last
    step's logits against a full forward, each row alone against the
    batch, and the launch counts the path needs."""
    import numpy as np
    from repro_torch.configs.internvl2_2b import CONFIG as cfg
    from repro_torch.models import api
    out = {"config": cfg.name}
    free_card(torch)
    t0 = time.perf_counter()
    params = api.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    n_params = count_params(params)
    d = cfg.d_model
    norms = cfg.num_layers * 2 * d + d
    if n_params != cfg.param_count() + norms + d * d:
        fail(f"internvl2-2b: {n_params} params, the config counts "
             f"{cfg.param_count()} + {norms} norm weights + {d * d} of "
             f"patch_proj")
    out["params"] = n_params
    print(f"internvl2-2b: {n_params:,} fp32 params drawn on the card in "
          f"{out['init_s']:.2f} s", flush=True)
    rng = np.random.RandomState(0)
    text = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                        (VLM_ROWS, VLM_TEXT))).to(dev)
    patches = torch.from_numpy((0.1 * rng.randn(
        VLM_ROWS, cfg.num_patches, d)).astype(np.float32)).to(dev)
    P = cfg.num_patches
    target = P + VLM_TEXT + VLM_GEN
    timing = {"prefill": [], "decode": []}

    def timed(kind, fn, *a, **kw):
        t = time.perf_counter()
        r = fn(*a, **kw)
        torch.cuda.synchronize()
        timing[kind].append(time.perf_counter() - t)
        return r

    def run(rows, fed=None):
        """Prefill ``rows`` and decode VLM_GEN steps, greedy, or fed the
        tokens ``fed``; returns every step's logits and the tokens."""
        batch = {"tokens": text[rows], "patches": patches[rows]}
        logits, cache = timed("prefill", api.prefill, cfg, params, batch,
                              target_seq=target)
        seen, toks = [logits], []
        for i in range(VLM_GEN):
            tok = torch.argmax(logits, -1)[:, None] if fed is None \
                else fed[:, i:i + 1]
            toks.append(tok)
            logits, cache = timed("decode", api.decode, cfg, params, cache,
                                  tok, P + VLM_TEXT + i)
            seen.append(logits)
        return seen, torch.cat(toks, dim=1)

    free_card(torch)
    reset_launches()
    rows = list(range(VLM_ROWS))
    seen, gen = run(rows)
    full, _ = timed("prefill", api.prefill, cfg, params, {
        "tokens": torch.cat([text, gen], dim=1), "patches": patches},
        target_seq=target)
    if not bool(torch.isfinite(seen[-1]).all()) or seen[-1].shape != (
            VLM_ROWS, cfg.vocab_size):
        fail("internvl2-2b: last logits not finite or misshapen")
    stepwise = float((seen[-1] - full).abs().max())
    if not stepwise < STEPWISE_TOL:
        fail(f"internvl2-2b: decode at position {target - 1} vs full "
             f"forward: {stepwise} >= {STEPWISE_TOL}")
    alone = 0.0
    for r in rows:
        mine, _ = run([r], fed=gen[r:r + 1])
        alone = max(alone, max(float((a - b[r:r + 1]).abs().max())
                               for a, b in zip(mine, seen)))
    if not alone < STEPWISE_TOL:
        fail(f"internvl2-2b: a row alone vs the batch: {alone} >= "
             f"{STEPWISE_TOL}")
    counts = dict(launches)
    prefills = 2 + VLM_ROWS
    want = {k: 0 for k in counts}
    want["flash_attention"] = cfg.num_layers * prefills
    print(f"serve-internvl2-2b: launches {counts} (expected {want}: "
          f"{cfg.num_layers} layers x {prefills} prefills)")
    if counts != want:
        fail(f"serve-internvl2-2b: launches {counts}, the path needs {want}")
    batch_decode = timing["decode"][:VLM_GEN]
    out.update({
        "tokens": gen.tolist(), "stepwise_max_abs_diff": stepwise,
        "row_alone_max_abs_diff": alone, "launches": counts,
        "prefill_s": timing["prefill"], "decode_step_s": timing["decode"],
        "tokens_per_s_batch": VLM_ROWS * VLM_GEN / (
            timing["prefill"][0] + sum(batch_decode)),
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30})
    print(f"serve-internvl2-2b: decode at positions {P + VLM_TEXT}-"
          f"{target - 1} vs full forward max abs logit diff {stepwise:.3g},"
          f" rows alone vs batch {alone:.3g} (< {STEPWISE_TOL}); prefill "
          f"{VLM_ROWS} x ({P} patches + {VLM_TEXT} tokens) "
          f"{timing['prefill'][0]:.3f} s, 1 row "
          f"{statistics.median(timing['prefill'][2:]):.3f} s; decode step "
          f"median {statistics.median(batch_decode) * 1e3:.1f} ms at "
          f"{VLM_ROWS} rows, "
          f"{statistics.median(timing['decode'][VLM_GEN:]) * 1e3:.1f} at 1; "
          f"{out['tokens_per_s_batch']:.1f} tokens/s; peak memory "
          f"{out['peak_memory_gib']:.2f} GiB", flush=True)
    batch = {"tokens": text, "patches": patches}
    out["profile_prefill"] = profile_device(
        torch, f"one prefill, {VLM_ROWS} x {P + VLM_TEXT} positions",
        lambda: api.prefill(cfg, params, batch, target_seq=target))
    return out


def prefill_launches(cfg) -> int:
    """Launches of the family's kernel per prefill: the SSD scan once a
    layer for the SSM family; flash attention once per attention layer
    (the hybrid's local layers only), and for encdec once per encoder
    layer and twice per decoder layer (self- and cross-attention)."""
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.num_layers
    if cfg.family == "hybrid":
        return sum(cfg.layer_kind(i) == "L" for i in range(cfg.num_layers))
    return cfg.num_layers


def hybrid_main_path(torch, tf, dev, launches, reset_launches):
    """Phase 5d, hybrid: recurrentgemma-9b at full width and depth through
    the port's entry points (``reference_decode``, ``api.prefill``,
    ``api.decode``): the real-layer flash drills (MQA at D = 256, window
    2048), sequential serving of prompts on both sides of the window, a
    batch of rows against the oracle, decode against a full forward, the
    token-by-token oracle from position 0, the launch counts the path
    needs, and the timings."""
    import numpy as np
    from repro_torch.configs.recurrentgemma_9b import CONFIG as cfg
    from repro_torch.models import api
    from repro_torch.models import hybrid as H
    from repro_torch.models import layers as L
    from repro_torch.serving import reference_decode
    from repro_torch.tree import tree_leaves
    out = {"config": cfg.name}
    free_card(torch)
    t0 = time.perf_counter()
    params = api.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["init_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    n_params = count_params(params)
    r_layers = sum(cfg.layer_kind(i) == "R" for i in range(cfg.num_layers))
    l_layers = cfg.num_layers - r_layers
    # param_count charges an R layer w * (conv_width + 3) for its conv
    # weight and bias and its Λ, which hold w * (conv_width + 2)
    norms = (2 * cfg.num_layers + 1) * cfg.d_model
    want_n = cfg.param_count() + norms - r_layers * cfg.rglru.lru_width
    if n_params != want_n:
        fail(f"recurrentgemma-9b: {n_params} params, its init shapes give "
             f"{want_n}")
    out.update({"params": n_params, "r_layers": r_layers,
                "l_layers": l_layers})
    print(f"recurrentgemma-9b: {n_params:,} fp32 params "
          f"({n_params * 4 / 2**30:.2f} GiB; {cfg.num_layers} layers, "
          f"{r_layers} RG-LRU and {l_layers} local attention) drawn on the "
          f"card in {out['init_s']:.2f} s; peak memory "
          f"{out['init_peak_gib']:.2f} GiB", flush=True)
    rng = np.random.RandomState(0)
    prompts = {n: rng.randint(0, cfg.vocab_size, n) for n in HYBRID_PROMPTS}
    rows = [prompts[HYBRID_ROW_PROMPT]] + [
        rng.randint(0, cfg.vocab_size, HYBRID_ROW_PROMPT)
        for _ in range(HYBRID_ROWS - 1)]

    # real-layer drills: the first and the last local-attention layer of a
    # 4096-token prefill (16 query heads over one KV head of 256, window
    # 2048); call i is layer 3 i + 2
    tokens = torch.from_numpy(prompts[HYBRID_ROW_PROMPT][None]).to(dev)
    calls = capture_flash_calls(torch, L, lambda: H.forward(cfg, params,
                                                            tokens))
    if len(calls) != l_layers:
        fail(f"recurrentgemma-9b: {len(calls)} flash calls in a forward, "
             f"{l_layers} local layers")
    worst = 0.0
    for i in (0, len(calls) - 1):
        q, k, v, causal, window, cap = calls[i]
        worst = max(worst, flash_drill(
            torch, tf, q, k, v, causal, window, cap, REAL_LAYER_TOL,
            f"recurrentgemma-9b layer {3 * i + 2}, S={q.shape[1]} "
            f"H={q.shape[2]} KV={k.shape[2]} D={q.shape[3]} "
            f"window={window}"))
    out["real_layer_max_abs_err"] = worst
    real = calls[0][:3] + (calls[0][4], calls[0][5])
    del calls

    # the main path, counts zeroed just before: every prefill and decode
    # step goes through the entry points, timed to a sync
    timing = {"prefill": [], "decode": []}
    prefill, decode = api.prefill, api.decode

    def timed(fn, kind):
        def run(cfg_, params_, *a, **kw):
            t = time.perf_counter()
            r = fn(cfg_, params_, *a, **kw)
            torch.cuda.synchronize()
            shape = (a[0]["tokens"] if kind == "prefill" else a[1]).shape
            timing[kind].append((tuple(shape), time.perf_counter() - t))
            return r
        return run
    api.prefill, api.decode = timed(prefill, "prefill"), timed(decode,
                                                               "decode")
    try:
        reset_launches()
        # 1. sequential serving: one request at a time, on both sides of
        # the window (2100 and 4096 wrap the rolling cache at prefill)
        seq = {}
        t0 = time.perf_counter()
        for n, prompt in prompts.items():
            seq[n] = reference_decode(cfg, params, prompt, HYBRID_GEN,
                                      return_margins=True)
            print(f"sequential: prompt {n}, {HYBRID_GEN} tokens, min top-2 "
                  f"margin {min(seq[n][1]):.3g}", flush=True)
        seq_wall = time.perf_counter() - t0
        n_seq = len(timing["prefill"]), len(timing["decode"])
        # 2. the batched path: one prefill over the rows, then decodes;
        # each row's tokens against its own oracle under the margin rule
        t0 = time.perf_counter()
        batch = torch.from_numpy(np.stack(rows)).to(dev)
        logits, cache = api.prefill(cfg, params, {"tokens": batch},
                                    target_seq=HYBRID_ROW_PROMPT + HYBRID_GEN)
        got = []
        for i in range(HYBRID_GEN):
            if i:
                logits, cache = api.decode(cfg, params, cache, token,
                                           HYBRID_ROW_PROMPT + i - 1)
            token = torch.argmax(logits, -1)[:, None]
            got.append(token[:, 0])
        batch_wall = time.perf_counter() - t0
        if not bool(torch.isfinite(logits).all()) or logits.shape != (
                HYBRID_ROWS, cfg.vocab_size):
            fail(f"recurrentgemma-9b batch: last logits "
                 f"{tuple(logits.shape)} not finite or misshapen")
        del cache
        got = torch.stack(got, dim=1)                  # (rows, gen)
        # decode through the wrapped caches against a full forward: the
        # rows' last decode logits (position 4126) against a prefill of
        # their prompts and first gen - 1 tokens (the random model repeats
        # its last prompt token at a top-2 margin of ~17, so the logits
        # carry this check, not the tokens)
        full, _ = api.prefill(cfg, params, {"tokens": torch.cat(
            [batch, got[:, :-1]], dim=1)})
        wrap_err = float((logits - full).abs().max())
        if not wrap_err < STEPWISE_TOL:
            fail(f"recurrentgemma-9b: decode at position "
                 f"{HYBRID_ROW_PROMPT + HYBRID_GEN - 2} vs full forward: "
                 f"{wrap_err} >= {STEPWISE_TOL}")
        del full
        got = got.cpu().numpy()
        compared = 0
        for r, prompt in enumerate(rows):
            ref, margins = seq[HYBRID_ROW_PROMPT] if r == 0 else \
                reference_decode(cfg, params, prompt, HYBRID_GEN,
                                 return_margins=True)
            n = 0
            for i in range(HYBRID_GEN):
                if margins[i] < MARGIN:
                    break
                if got[r, i] != ref[i]:
                    fail(f"recurrentgemma-9b batch: row {r} token {i} is "
                         f"{got[r, i]}, the oracle's {ref[i]} (margin "
                         f"{margins[i]:.4g})")
                n += 1
            compared += n
            print(f"batch row {r}: {n} of {HYBRID_GEN} tokens equal the "
                  f"oracle's (min margin {min(margins):.3g})", flush=True)
        if compared < HYBRID_ROWS * HYBRID_GEN // 2:
            fail(f"recurrentgemma-9b batch: only {compared} of "
                 f"{HYBRID_ROWS * HYBRID_GEN} tokens compared")
        # 3. the stepwise oracle: a prompt one token at a time from zero
        # caches (rglru_step against the log-depth scan, the rolled conv
        # window, decode's KV writes against the prefill's placement)
        n = HYBRID_PROMPTS[0]
        tokens = torch.from_numpy(prompts[n][None]).to(dev)
        want, want_cache = api.prefill(cfg, params, {"tokens": tokens})
        step_cache = api.init_cache(cfg, 1, n, torch.float32, dev)
        for i in range(n):
            step, step_cache = api.decode(cfg, params, step_cache,
                                          tokens[:, i:i + 1], i)
        stepwise = {"logits": float((step - want).abs().max()),
                    "caches": max(float((a - b).abs().max()) for a, b in zip(
                        tree_leaves(step_cache), tree_leaves(want_cache)))}
        if not max(stepwise.values()) < STEPWISE_TOL:
            fail(f"recurrentgemma-9b stepwise oracle: {stepwise} >= "
                 f"{STEPWISE_TOL}")
        print(f"stepwise oracle ({n} decode steps from zero caches): max abs "
              f"diff {stepwise} < {STEPWISE_TOL}", flush=True)
        del step_cache, want_cache
        counts = dict(launches)
    finally:
        api.prefill, api.decode = prefill, decode
    prefills = len(timing["prefill"])
    want_prefills = len(HYBRID_PROMPTS) + 1 + 1 + (HYBRID_ROWS - 1) + 1
    if prefills != want_prefills:
        fail(f"recurrentgemma-9b: {prefills} prefills, the path makes "
             f"{want_prefills}")
    want_counts = {k: 0 for k in counts}
    want_counts["flash_attention"] = prefill_launches(cfg) * prefills
    print(f"serve-recurrentgemma-9b: launches {counts} (expected "
          f"{want_counts}: {prefill_launches(cfg)} local layers x "
          f"{prefills} prefills)")
    if counts != want_counts:
        fail(f"serve-recurrentgemma-9b: launches {counts}, the path needs "
             f"{want_counts}")

    # records: prefill seconds by shape, decode ms per step by rows
    pre = {}
    for shape, t in timing["prefill"]:
        pre.setdefault(f"{shape[0]}x{shape[1]}", []).append(t)
    seq_pre = [t for _, t in timing["prefill"][:n_seq[0]]]
    seq_dec = [t for _, t in timing["decode"][:n_seq[1]]]
    rows_dec = [t for shape, t in timing["decode"]
                if shape[0] == HYBRID_ROWS]
    batch_busy = pre[f"{HYBRID_ROWS}x{HYBRID_ROW_PROMPT}"][0] + sum(rows_dec)
    seq_busy = sum(seq_pre) + sum(seq_dec)
    out.update({
        "sequential": {str(n): seq[n][0] for n in HYBRID_PROMPTS},
        "min_margin": {str(n): min(seq[n][1]) for n in HYBRID_PROMPTS},
        "batch_tokens": got.tolist(), "tokens_compared": compared,
        "wrap_logit_max_abs_diff": wrap_err,
        "stepwise_max_abs_diff": stepwise, "launches": counts,
        "prefill_s": pre,
        "decode_step_ms_1row": [t * 1e3 for t in seq_dec],
        "decode_step_ms_rows": [t * 1e3 for t in rows_dec],
        "tokens_per_s_sequential": len(HYBRID_PROMPTS) * HYBRID_GEN
        / seq_busy,
        "tokens_per_s_batch": HYBRID_ROWS * HYBRID_GEN / batch_busy,
        "sequential_wall_s": seq_wall, "batch_wall_s": batch_wall,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30})
    print(f"serve-recurrentgemma-9b: {compared} of "
          f"{HYBRID_ROWS * HYBRID_GEN} batch tokens compared, all equal; "
          f"decode at position {HYBRID_ROW_PROMPT + HYBRID_GEN - 2} vs full "
          f"forward {wrap_err:.3g}; prefill (s) "
          f"{ {k: [round(t, 4) for t in v] for k, v in pre.items()} }; "
          f"decode step median {statistics.median(seq_dec) * 1e3:.1f} ms at "
          f"1 row, {statistics.median(rows_dec) * 1e3:.1f} ms at "
          f"{HYBRID_ROWS} rows; {out['tokens_per_s_sequential']:.1f} "
          f"tokens/s sequential, {out['tokens_per_s_batch']:.1f} over "
          f"{HYBRID_ROWS} rows; peak memory {out['peak_memory_gib']:.2f} "
          f"GiB", flush=True)

    # one R and one L layer apart at 4096 tokens (eager, as the main path
    # runs them): the RG-LRU scan, the recurrent and attention mixes, the
    # kernel, a GeGLU FFN
    tokens = torch.from_numpy(prompts[HYBRID_ROW_PROMPT][None]).to(dev)
    slots = params["layers"]["slots"]
    h = L.rms_norm(H._embed(cfg, params, tokens), slots[0]["ln1"][0])
    r0 = {k: v[0] for k, v in slots[0]["rglru"].items()}
    a0 = {k: v[0] for k, v in slots[2]["attn"].items()}
    f0 = {k: v[0] for k, v in slots[0]["ffn"].items()}
    u = L.causal_conv(h @ r0["w_in2"], r0["conv_w"], r0["conv_b"])
    a, b = H._rglru_coeffs(r0, u)
    positions = torch.arange(HYBRID_ROW_PROMPT, device=dev)
    kw = dict(graph=False, reps=3, inner=2)
    layer_ms = {
        "associative_scan": time_ms(lambda: H.associative_scan(a, b), **kw),
        "rglru_scan": time_ms(lambda: H.rglru_scan(r0, u), **kw),
        "recurrent_mix": time_ms(lambda: H.recurrent_mix(cfg, r0, h), **kw),
        "attention_block": time_ms(lambda: L.attention_block(
            cfg, a0, h, positions, window=cfg.window), **kw),
        "flash_attention": time_ms(lambda: tf.flash_attention(
            *real[:3], True, real[3], real[4]), **kw),
        "ffn": time_ms(lambda: L.ffn(f0, h, cfg.mlp_act), **kw)}
    del h, u, a, b
    out["layer_ms"] = layer_ms
    print(f"recurrentgemma-9b layers at {HYBRID_ROW_PROMPT} tokens (ms, "
          f"eager): { {k: round(v, 2) for k, v in layer_ms.items()} }; "
          f"{r_layers} RG-LRU scans a prefill "
          f"{r_layers * layer_ms['rglru_scan']:.1f} ms (the associative "
          f"scan alone {r_layers * layer_ms['associative_scan']:.1f})",
          flush=True)
    out["profile_prefill"] = profile_device(
        torch, f"one prefill, {HYBRID_ROW_PROMPT} tokens",
        lambda: prefill(cfg, params, {"tokens": tokens}))
    cache = api.init_cache(cfg, 1, HYBRID_ROW_PROMPT, torch.float32, dev)
    out["profile_decode"] = profile_device(
        torch, "one decode step, 1 row",
        lambda: decode(cfg, params, cache, tokens[:, :1], 0))
    return out, real


def whisper_main_path(torch, tf, dev, launches, reset_launches):
    """Phase 5d, encdec: whisper-base at full width and depth through
    ``api.prefill`` / ``api.decode``: the real-layer flash drills (the
    bidirectional encoder, the cross-attention over 1500 frames, the
    decoder's causal self-attention, all D = 64), greedy decoding of a
    batch, its last step against a full forward, each row alone against
    the batch, and the launch counts the path needs."""
    import numpy as np
    from repro_torch.configs.whisper_base import CONFIG as cfg
    from repro_torch.models import api
    from repro_torch.models import layers as L
    out = {"config": cfg.name}
    free_card(torch)
    t0 = time.perf_counter()
    params = api.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    n_params = count_params(params)
    norms = (2 * cfg.encoder_layers + 3 * cfg.num_layers + 2) * cfg.d_model
    if n_params != cfg.param_count() + norms:
        fail(f"whisper-base: {n_params} params, the config counts "
             f"{cfg.param_count()} + {norms} norm weights")
    out["params"] = n_params
    print(f"whisper-base: {n_params:,} fp32 params ({cfg.encoder_layers} "
          f"encoder + {cfg.num_layers} decoder layers) drawn on the card in "
          f"{out['init_s']:.2f} s", flush=True)
    rng = np.random.RandomState(0)
    text = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (WHISPER_ROWS, WHISPER_TEXT))).to(dev)
    frames = torch.from_numpy((0.1 * rng.randn(
        WHISPER_ROWS, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        ).to(dev)
    target = WHISPER_TEXT + WHISPER_GEN

    # real-layer drills: the first encoder layer (1500 x 1500, no
    # causality), the first decoder layer's self-attention (causal) and
    # cross-attention (the prompt over the 1500 frames), the last encoder
    # layer and the last cross-attention
    E = cfg.encoder_layers
    calls = capture_flash_calls(torch, L, lambda: api.prefill(
        cfg, params, {"tokens": text, "frames": frames}, target_seq=target))
    if len(calls) != prefill_launches(cfg):
        fail(f"whisper-base: {len(calls)} flash calls in a prefill, "
             f"{prefill_launches(cfg)} expected")
    worst = 0.0
    for i, what in ((0, "encoder layer 0"), (E - 1, f"encoder layer {E - 1}"),
                    (E, "decoder layer 0 self-attention"),
                    (E + 1, "decoder layer 0 cross-attention"),
                    (len(calls) - 1,
                     f"decoder layer {cfg.num_layers - 1} cross-attention")):
        q, k, v, causal, window, cap = calls[i]
        worst = max(worst, flash_drill(
            torch, tf, q, k, v, causal, window, cap, REAL_LAYER_TOL,
            f"whisper-base {what}, B={q.shape[0]} Sq={q.shape[1]} "
            f"Sk={k.shape[1]} H={q.shape[2]} D={q.shape[3]} "
            f"causal={causal}"))
    out["real_layer_max_abs_err"] = worst
    real = tuple(t[:1].contiguous() for t in calls[0][:3]) + (0, 0.0)
    del calls

    timing = {"prefill": [], "decode": []}

    def timed(kind, fn, *a, **kw):
        t = time.perf_counter()
        r = fn(*a, **kw)
        torch.cuda.synchronize()
        timing[kind].append(time.perf_counter() - t)
        return r

    def run(rows, fed=None):
        """Prefill ``rows`` and decode WHISPER_GEN steps, greedy, or fed
        the tokens ``fed``; returns every step's logits and the tokens."""
        batch = {"tokens": text[rows], "frames": frames[rows]}
        logits, cache = timed("prefill", api.prefill, cfg, params, batch,
                              target_seq=target)
        seen, toks = [logits], []
        for i in range(WHISPER_GEN):
            tok = torch.argmax(logits, -1)[:, None] if fed is None \
                else fed[:, i:i + 1]
            toks.append(tok)
            logits, cache = timed("decode", api.decode, cfg, params, cache,
                                  tok, WHISPER_TEXT + i)
            seen.append(logits)
        return seen, torch.cat(toks, dim=1)

    reset_launches()
    rows = list(range(WHISPER_ROWS))
    seen, gen = run(rows)
    full, _ = timed("prefill", api.prefill, cfg, params, {
        "tokens": torch.cat([text, gen], dim=1), "frames": frames},
        target_seq=target)
    if not bool(torch.isfinite(seen[-1]).all()) or seen[-1].shape != (
            WHISPER_ROWS, cfg.vocab_size):
        fail("whisper-base: last logits not finite or misshapen")
    stepwise = float((seen[-1] - full).abs().max())
    if not stepwise < STEPWISE_TOL:
        fail(f"whisper-base: decode at position {target - 1} vs full "
             f"forward: {stepwise} >= {STEPWISE_TOL}")
    alone = 0.0
    for r in rows:
        mine, _ = run([r], fed=gen[r:r + 1])
        alone = max(alone, max(float((a - b[r:r + 1]).abs().max())
                               for a, b in zip(mine, seen)))
    if not alone < STEPWISE_TOL:
        fail(f"whisper-base: a row alone vs the batch: {alone} >= "
             f"{STEPWISE_TOL}")
    counts = dict(launches)
    prefills = 2 + WHISPER_ROWS
    want = {k: 0 for k in counts}
    want["flash_attention"] = prefill_launches(cfg) * prefills
    print(f"serve-whisper-base: launches {counts} (expected {want}: "
          f"{prefill_launches(cfg)} ({E} encoder, {cfg.num_layers} self, "
          f"{cfg.num_layers} cross) x {prefills} prefills)")
    if counts != want:
        fail(f"serve-whisper-base: launches {counts}, the path needs {want}")
    batch_decode = timing["decode"][:WHISPER_GEN]
    out.update({
        "tokens": gen.tolist(), "stepwise_max_abs_diff": stepwise,
        "row_alone_max_abs_diff": alone, "launches": counts,
        "prefill_s": timing["prefill"], "decode_step_s": timing["decode"],
        "tokens_per_s_batch": WHISPER_ROWS * WHISPER_GEN / (
            timing["prefill"][0] + sum(batch_decode)),
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30})
    print(f"serve-whisper-base: decode at positions {WHISPER_TEXT}-"
          f"{target - 1} vs full forward max abs logit diff {stepwise:.3g},"
          f" rows alone vs batch {alone:.3g} (< {STEPWISE_TOL}); prefill "
          f"{WHISPER_ROWS} x ({cfg.encoder_seq} frames + {WHISPER_TEXT} "
          f"tokens) {timing['prefill'][0]:.3f} s, 1 row "
          f"{statistics.median(timing['prefill'][2:]):.3f} s; decode step "
          f"median {statistics.median(batch_decode) * 1e3:.1f} ms at "
          f"{WHISPER_ROWS} rows, "
          f"{statistics.median(timing['decode'][WHISPER_GEN:]) * 1e3:.1f} "
          f"at 1; {out['tokens_per_s_batch']:.1f} tokens/s; peak memory "
          f"{out['peak_memory_gib']:.2f} GiB", flush=True)
    batch = {"tokens": text, "frames": frames}
    out["profile_prefill"] = profile_device(
        torch, f"one prefill, {WHISPER_ROWS} x ({cfg.encoder_seq} frames + "
        f"{WHISPER_TEXT} tokens)",
        lambda: api.prefill(cfg, params, batch, target_seq=target))
    return out, real


def train_grads(torch, program, params, batch, op, quantize, cut=None):
    """The loss of ``program.loss_through_cut`` and its gradient over every
    param leaf (the driver's local step without the update).  With
    ``cut``, the cut activations take those values in the forward (another
    device's int8 round trip) with the straight-through gradient, as the
    int8 cut's."""
    from repro_torch.tree import tree_leaves, tree_map
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    if cut is None:
        loss = program.loss_through_cut(live, batch, op, quantize=quantize)
    else:
        acts = program.client_forward(live, batch, op)
        acts = acts + (cut - acts).detach()
        loss = program.server_forward(live, acts, batch, op)
    leaves = tree_leaves(live)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(t) if g is None else g
                           for t, g in zip(leaves, grads)]


def compare_training(torch, what, card, host, nonzero=True,
                     loss_tol=None, grad_tol=None):
    """A loss and its gradients from the card against the host CPU's:
    the loss within ``loss_tol`` (TRAIN_LOSS_REL) relative, every leaf
    within ``grad_tol`` (TRAIN_GRAD_REL) of its largest CPU entry and,
    with ``nonzero``, every leaf's card gradient nonzero.  Returns the
    worst relative errors."""
    (lc, gc), (lh, gh) = card, host
    loss_tol = TRAIN_LOSS_REL if loss_tol is None else loss_tol
    grad_tol = TRAIN_GRAD_REL if grad_tol is None else grad_tol
    loss_rel = abs(float(lc) - float(lh)) / abs(float(lh))
    if not loss_rel <= loss_tol:
        fail(f"{what}: loss {float(lc)} on the card, {float(lh)} on the "
             f"CPU: {loss_rel:.3g} relative > {loss_tol}")
    worst, zero = 0.0, []
    for i, (c, h) in enumerate(zip(gc, gh)):
        c = c.cpu()
        if not bool(torch.isfinite(c).all()):
            fail(f"{what}: leaf {i} gradient not finite on the card")
        scale = float(h.abs().max())
        err = float((c - h).abs().max()) / max(scale, 1e-30)
        if not err <= grad_tol:
            fail(f"{what}: leaf {i} {tuple(h.shape)} gradient "
                 f"{err:.3g} of its max {scale:.3g} apart > {grad_tol}")
        worst = max(worst, err)
        if float(c.abs().max()) == 0.0:
            zero.append(i)
    if nonzero and zero:
        fail(f"{what}: leaves {zero} got a zero gradient on the card")
    print(f"{what}: loss {float(lc):.6f} (card) vs {float(lh):.6f} (CPU), "
          f"{loss_rel:.3g} relative; {len(gc)} gradient leaves within "
          f"{worst:.3g} of their max (bounds {loss_tol}, {grad_tol})"
          + (", none zero on the card" if nonzero else ""), flush=True)
    return {"loss_card": float(lc), "loss_cpu": float(lh),
            "loss_rel": loss_rel, "grad_rel": worst, "leaves": len(gc)}


def training_launches(cfg, ops_rows, local_steps, native_op):
    """Each kernel's launches in a run of the LM driver (no failures) from
    its OPs: every local step runs the sequence mixer's forward once per
    layer and again in the remat recompute (flash attention, or the SSD
    scan for mamba2) and its backward once per layer (the two flash
    kernels, or the SSD scan's); the int8 cut's quantize and dequantize
    once per step below the native OP; top-k never, nor the other
    family's kernels."""
    steps = local_steps * sum(len(row) for row in ops_rows)
    cut = local_steps * sum(op < native_op for row in ops_rows for op in row)
    L = cfg.num_layers
    ssm = cfg.family == "ssm"
    attn = 0 if ssm else L * steps
    return {"quantize": cut, "dequantize": cut, "topk_compress": 0,
            "flash_attention": 2 * attn, "flash_attention_bwd_dq": attn,
            "flash_attention_bwd_dkdv": attn,
            "ssd_scan": 2 * L * steps if ssm else 0,
            "ssd_scan_bwd": L * steps if ssm else 0}


def local_step_vs_cpu(torch, cfg, program, params, batch, op, launches,
                      reset_launches):
    """One local step (``loss_through_cut`` at ``op`` with the int8 cut,
    then ``torch.autograd.grad``) on the card, its launches exactly what a
    step needs, against the host CPU from the same params and batch, the
    CPU taking the card's int8 codes (``compare_training``).  Returns the
    record, the card's loss and gradients, the host params and batch."""
    from repro_torch.kernels.quant_transfer import fake_quant_int8
    from repro_torch.tree import tree_map
    reset_launches()
    card = train_grads(torch, program, params, batch, op, True)
    torch.cuda.synchronize()
    counts = dict(launches)
    want = training_launches(cfg, [[op]], 1, program.native_op)
    if counts != want:
        fail(f"{cfg.name} local step: launches {counts}, it needs {want}")
    host = tree_map(lambda t: t.detach().cpu(), params)
    hbatch = {k: v.cpu() for k, v in batch.items()}
    with torch.no_grad():
        card_cut = fake_quant_int8(program.client_forward(params, batch,
                                                          op)).cpu()
    t0 = time.perf_counter()
    cpu = train_grads(torch, program, host, hbatch, op, True, cut=card_cut)
    out = {"cpu_step_s": time.perf_counter() - t0}
    out["step_vs_cpu"] = compare_training(
        torch, f"{cfg.name} local step at OP {op}, int8 cut, "
        f"{batch['tokens'].shape[1]} tokens (the CPU takes the card's "
        f"codes)", card, cpu)
    print(f"{cfg.name}: the CPU's step took {out['cpu_step_s']:.1f} s",
          flush=True)
    return out, card, host, hbatch


def split_vs_native(torch, cfg, program, params, batch, ops):
    """``loss_through_cut`` at each OP equal to ``api.loss`` within
    TRAIN_LOSS_REL (no gradient); returns the relative gaps by OP."""
    from repro_torch.models import api
    with torch.no_grad():
        native_loss = float(api.loss(cfg, params, batch))
        rels = {}
        for op in ops:
            loss = float(program.loss_through_cut(params, batch, op))
            rels[op] = abs(loss - native_loss) / abs(native_loss)
            if not rels[op] <= TRAIN_LOSS_REL:
                fail(f"{cfg.name}: loss through the cut at OP {op} {loss} vs "
                     f"api.loss {native_loss}: {rels[op]:.3g} > "
                     f"{TRAIN_LOSS_REL}")
    print(f"{cfg.name}: loss_through_cut at OPs {ops} vs api.loss "
          f"{native_loss:.6f}: relative {[f'{r:.3g}' for r in rels.values()]} "
          f"(<= {TRAIN_LOSS_REL})", flush=True)
    return rels


def driver_path(torch, cfg, program, params, dev, launches, reset_launches,
                batch_of, step_op):
    """The LM driver (``QWEN3_DRIVER``'s arguments) from ``params``: its
    OPs, modelled round times and drops equal to a CPU replay of its
    control plane, its losses finite, its launches exactly what its OPs
    need; then one local step at ``step_op`` from the trained params under
    the profiler.  Returns the record."""
    from repro_torch.launch import train as driver
    args = driver.parser().parse_args(QWEN3_DRIVER)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    run = driver.train(cfg, args, device=dev, init_params=params,
                       log=lambda line: print(f"  {line}", flush=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launches)
    h = run["history"]
    replay = driver.replay_control(cfg, args)
    if h["ops"] != replay["ops"] or h["dropped"] != replay["dropped"] or \
            any(not np_equal(a, b) for a, b in zip(h["times"],
                                                   replay["times"])):
        fail(f"{cfg.name} driver: OPs {h['ops']}, times {h['times']}, "
             f"drops {h['dropped']} vs the CPU replay's {replay}")
    if not all(math.isfinite(x) for row in h["client_losses"] for x in row):
        fail(f"{cfg.name} driver: losses {h['client_losses']}")
    want = training_launches(cfg, h["ops"], args.local_steps,
                             program.native_op)
    print(f"train-{cfg.name}: launches {counts} (expected from its OPs "
          f"{h['ops']}: {want})")
    if counts != want:
        fail(f"train-{cfg.name}: launches {counts}, its history needs "
             f"{want}")
    steps = args.local_steps * sum(len(row) for row in h["ops"])
    out = {
        "launches": counts, "ops": h["ops"], "loss": h["loss"],
        "client_losses": h["client_losses"],
        "round_time_model_s": [t.tolist() for t in h["times"]],
        "round_wall_s": h["wall_s"], "wall_s": wall, "local_steps": steps,
        "s_per_local_step": sum(h["wall_s"]) / steps,
        "tokens_per_s": steps * args.batch * args.seq / sum(h["wall_s"]),
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(f"train-{cfg.name}: OPs and modelled round times equal to the CPU "
          f"replay; losses {[round(x, 4) for x in h['loss']]}; "
          f"{out['s_per_local_step']:.3f} s per local step of "
          f"{args.seq} tokens (round wall / steps, aggregation included), "
          f"{out['tokens_per_s']:.0f} tokens/s; peak memory "
          f"{out['peak_memory_gib']:.2f} GiB", flush=True)
    b4 = batch_of(args.seq, 3)
    out["profile_step"] = profile_device(
        torch, f"one local step's loss and gradient at OP {step_op}, int8 "
        f"cut, {args.seq} tokens",
        lambda: train_grads(torch, program, run["params"], b4, step_op,
                            True))
    return out


def lm_batches(torch, cfg, dev):
    """``batch_of(S, step)``: batch 1 of S tokens and their labels from a
    seeded token stream, on the card."""
    from repro_torch.data.synthetic import batch_tokens, make_token_stream
    stream = make_token_stream(400_000, cfg.vocab_size, seed=7)

    def batch_of(S, step):
        toks, labs = batch_tokens(stream, 1, S, step)
        return {"tokens": torch.from_numpy(toks).to(dev),
                "labels": torch.from_numpy(labs).to(dev)}
    return batch_of


def qwen3_training_path(torch, tf, dev, launches, reset_launches):
    """Phase 5e: qwen3-0.6b trained at full width and depth through the
    split path (``LMSplitProgram``), the flash backward kernels and the LM
    driver (``repro_torch.launch.train``).  Returns the record and layer
    0's q, k, v and dO of a real 4096-token step (phase 7's row)."""
    from repro_torch.configs.qwen3_0_6b import CONFIG as cfg
    from repro_torch.kernels.quant_transfer import quantize
    from repro_torch.models import layers as L
    from repro_torch.models.split_program import get_split_program
    free_card(torch)
    program = get_split_program(cfg)
    native = program.native_op
    t0 = time.perf_counter()
    params = program.init(0, dev)
    torch.cuda.synchronize()
    n = count_params(params)
    # the config's count leaves out the norm vectors (two of d_model and
    # q/k-norm's two of head_dim a layer, and the final norm)
    norms = cfg.num_layers * 2 * (cfg.d_model + cfg.head_dim) + cfg.d_model
    if n != cfg.param_count() + norms:
        fail(f"qwen3-0.6b: {n} params, the config counts "
             f"{cfg.param_count()} + {norms} in norms")
    print(f"qwen3-0.6b: {n:,} fp32 params ({n * 4 / 2**30:.2f} GiB) drawn "
          f"on the card in {time.perf_counter() - t0:.1f} s", flush=True)
    batch_of = lm_batches(torch, cfg, dev)

    # 1. the flash backward on the q, k, v and dO of layers 0 and 27 of a
    # real 4096-token step (native OP: every layer through the stack)
    layers = (0, cfg.num_layers - 1)
    seen, got_do, kernel = [0], {}, L.flash_attention

    def capture(q, k, v, causal=True, window=0, softcap=0.0):
        i = seen[0]
        seen[0] += 1
        o = kernel(q, k, v, causal=causal, window=window, softcap=softcap)
        if i in layers:
            got_do[i] = [q.detach(), k.detach(), v.detach(), causal, window,
                         softcap]
            o.register_hook(lambda g, i=i: got_do[i].append(g.detach()))
        return o

    L.flash_attention = capture
    try:
        train_grads(torch, program, params, batch_of(QWEN3_DRILL_SEQ, 0),
                    native, False)
    finally:
        L.flash_attention = kernel
    torch.cuda.synchronize()
    if seen[0] != 2 * cfg.num_layers or any(len(got_do[i]) != 7
                                           for i in layers):
        fail(f"qwen3-0.6b drill: {seen[0]} flash calls (the forward and its "
             f"recompute need {2 * cfg.num_layers}), dO of layers "
             f"{[i for i in layers if len(got_do[i]) == 7]}")
    # the gradients are linear in dO: the drills take it scaled to a max
    # of 1 (a real step's is ~1e-6), where the bound 1e-5 x max(1,
    # max|want|) is a relative one
    out = {"real_layer_bwd_err": {}}
    for i in layers:
        q, k, v, causal, window, cap, do = got_do[i]
        do = do / do.abs().max()
        out["real_layer_bwd_err"][i] = flash_bwd_drill(
            torch, tf, q, k, v, do, causal, window, cap,
            f"qwen3-0.6b layer {i} of a real {QWEN3_DRILL_SEQ}-token step, "
            f"dO / max|dO|")
    q, k, v, _, _, _, do = got_do[0]
    real = (q, k, v, do / do.abs().max())
    del got_do

    # 2. one local step on the card against the host CPU, which also
    # quantizes its own cut: the codes the two part, and that step held to
    # the discrete-step bound
    batch = batch_of(QWEN3_STEP_SEQ, 1)
    step, card, host, hbatch = local_step_vs_cpu(
        torch, cfg, program, params, batch, QWEN3_STEP_OP, launches,
        reset_launches)
    out.update(step)
    with torch.no_grad():
        codes = quantize(program.client_forward(params, batch,
                                                QWEN3_STEP_OP))[0].cpu()
        parted = int((codes != quantize(program.client_forward(
            host, hbatch, QWEN3_STEP_OP))[0]).sum())
    what = (f"qwen3-0.6b local step at OP {QWEN3_STEP_OP}, int8 cut, "
            f"{QWEN3_STEP_SEQ} tokens")
    print(f"{what}: {parted} of {codes.numel()} int8 codes of the cut part "
          f"between the card and the CPU")
    out["step_vs_cpu_own_cut"] = compare_training(
        torch, f"{what} (each device its own codes)", card,
        train_grads(torch, program, host, hbatch, QWEN3_STEP_OP, True),
        loss_tol=CUT_FLIP_REL, grad_tol=CUT_FLIP_REL)
    out["cut_codes_parted"] = parted
    del host, card

    # 3. split equals native; 4. the driver and a profiled step
    out["split_vs_native"] = split_vs_native(torch, cfg, program, params,
                                             batch, QWEN3_SPLIT_OPS)
    out.update(driver_path(torch, cfg, program, params, dev, launches,
                           reset_launches, batch_of, QWEN3_STEP_OP))
    del params
    return out, real


def mamba2_training_path(torch, ts, dev, launches, reset_launches):
    """Phase 5f: mamba2-780m trained at full width and depth through the
    split path (``SSMSplitProgram``), the SSD scan's backward kernel and
    the LM driver, as phase 5e trains qwen3-0.6b.  Returns the record and
    layer 0's SSD inputs and y's gradient (scaled to a max of 1) of a real
    4096-token step (phase 7's row)."""
    from repro_torch.configs.mamba2_780m import CONFIG as cfg
    from repro_torch.models import ssm as S_model
    from repro_torch.models.split_program import get_split_program
    free_card(torch)
    program = get_split_program(cfg)
    t0 = time.perf_counter()
    params = program.init(0, dev)
    torch.cuda.synchronize()
    n = count_params(params)
    if n != 857_379_072:
        fail(f"mamba2-780m: {n} params, its init shapes give 857,379,072")
    print(f"mamba2-780m: {n:,} fp32 params ({n * 4 / 2**30:.2f} GiB) drawn "
          f"on the card in {time.perf_counter() - t0:.1f} s", flush=True)
    batch_of = lm_batches(torch, cfg, dev)

    # 1. the SSD backward on the inputs and dy of layers 0 and 47 of a real
    # 4096-token step (native OP: every layer through the stack).  The
    # forward's calls are layers 0-47 in order; their y's hooks get dy
    # (the remat recomputes refill the saved inputs only)
    layers = (0, cfg.num_layers - 1)
    seen, got, kernel = [0], {}, S_model.ssd_scan

    def capture(x, dt, A, Bm, Cm, chunk, init_state=None):
        i = seen[0]
        seen[0] += 1
        y, final = kernel(x, dt, A, Bm, Cm, chunk, init_state)
        if i in layers:
            got[i] = [t.detach() for t in (x, dt, A, Bm, Cm)]
            y.register_hook(lambda g, i=i: got[i].append(g.detach()))
        return y, final

    S_model.ssd_scan = capture
    try:
        train_grads(torch, program, params, batch_of(MAMBA_DRILL_SEQ, 0),
                    program.native_op, False)
    finally:
        S_model.ssd_scan = kernel
    torch.cuda.synchronize()
    if seen[0] != 2 * cfg.num_layers or any(len(got[i]) != 6 for i in layers):
        fail(f"mamba2-780m drill: {seen[0]} SSD calls (the forward and its "
             f"recompute need {2 * cfg.num_layers}), dy of layers "
             f"{[i for i in layers if len(got[i]) == 6]}")
    # the gradients are linear in dy: the drills take it scaled to a max of
    # 1 (a real step's is ~1e-5), where the bound is a relative one
    out = {"real_layer_bwd_err": {}}
    for i in layers:
        args, dy = got[i][:5], got[i][5] / got[i][5].abs().max()
        out["real_layer_bwd_err"][i] = ssd_bwd_drill(
            torch, ts, args, cfg.ssm.chunk, None, dy, None,
            f"mamba2-780m layer {i} of a real {MAMBA_DRILL_SEQ}-token step, "
            f"dy / max|dy|")
        got[i][5] = dy
    real = got[0]
    del got

    # 2. one local step on the card against the host CPU; 3. split equals
    # native; 4. the driver and a profiled step
    batch = batch_of(MAMBA_STEP_SEQ, 1)
    step, _, _, _ = local_step_vs_cpu(torch, cfg, program, params, batch,
                                      MAMBA_STEP_OP, launches,
                                      reset_launches)
    out.update(step)
    out["split_vs_native"] = split_vs_native(torch, cfg, program, params,
                                             batch, MAMBA_SPLIT_OPS)
    out.update(driver_path(torch, cfg, program, params, dev, launches,
                           reset_launches, batch_of, MAMBA_STEP_OP))
    del params
    return out, real


def fed_lm_launches(cfg, h, fl, native_op, K, mesh_shape=None):
    """Each kernel's launches in a ``run_federated`` run over an LM from
    its history (no failures, no deadline): every local step runs the
    sequence mixer's forward twice a layer (the forward and its remat
    recompute) and its backward once; each round's eval pass (the whole
    test set at the native OP under ``no_grad``) runs the forward once a
    layer; the int8 pair once a step below the native OP (with the int8
    cut) and once per surviving client row for the delta wire; top-k once
    per surviving client row (on a ``mesh_shape`` mesh: rows padded to the
    ``data`` size, each once per model shard).  The sequential engine
    steps a client at a time; the batched one (mesh-less here) a chunk of
    an OP's clients (``BATCHED_MAX_GROUP`` at most) at a time, its flash
    Functions and the int8 cut folding the chunk into one call, while the
    SSD scan's run once a client (each holds its own ``A``)."""
    rounds = len(h["ops"])
    steps = fl.local_iters * K * rounds
    if fl.engine == "batched":
        assert mesh_shape is None, "the batched count is mesh-less"
        groups = [(op, n) for row in h["ops"] for op, n in
                  collections.Counter(int(o) for o in row).items()]
        folded = fl.local_iters * sum(-(-n // BATCHED_MAX_GROUP)
                                      for _, n in groups)
        cut = batched_cut_launches(fl, groups, native_op)
    else:
        folded = steps
        cut = fl.local_iters * int(sum(op < native_op for row in h["ops"]
                                       for op in row))
    cut = cut if fl.quantize_transfer else 0
    data, model = mesh_shape or (1, 1)
    kept = sum((n + (-n) % data) * model
               for n in (K - int(d) for d in h["dropped"]))
    L = cfg.num_layers
    ssm = cfg.family == "ssm"
    calls = steps if ssm else folded
    mixer = {"fwd": 2 * L * calls + L * rounds, "bwd": L * calls}
    wire = kept if fl.quantize_deltas else 0
    return {"quantize": cut + wire, "dequantize": cut + wire,
            "topk_compress": kept if fl.delta_density < 1.0 else 0,
            "flash_attention": 0 if ssm else mixer["fwd"],
            "flash_attention_bwd_dq": 0 if ssm else mixer["bwd"],
            "flash_attention_bwd_dkdv": 0 if ssm else mixer["bwd"],
            "ssd_scan": mixer["fwd"] if ssm else 0,
            "ssd_scan_bwd": mixer["bwd"] if ssm else 0}


def fed_lm_setup(cfg, fl, K):
    """The run's program and data (token rows of FED_SEQ tokens, seeded),
    ``links()``: a fresh Eq. 1 cluster over the paper testbed's first K
    devices and the LM's workload, its Transport (and the edges' for a
    two-tier run), and ``replay(params)``: the CPU replay of the run's
    control plane, the planner and ``RoundClock`` over the same cluster and
    links with no model (``params`` only sizes the weight sync)."""
    import numpy as np
    from repro_torch.configs.vgg import VGG5
    from repro_torch.core import costmodel as cm
    from repro_torch.core.env import SimulatedCluster
    from repro_torch.core.testbed import paper_testbed
    from repro_torch.data import split_clients, token_dataset
    from repro_torch.fl.comm import (Transport, device_bandwidths,
                                     indexed_bandwidths)
    from repro_torch.fl.hierarchy import assign_edges
    from repro_torch.fl.loop import RoundClock, _resolve_planner
    from repro_torch.models.split_program import get_split_program
    program = get_split_program(cfg)
    _, devices, c_srv, _ = paper_testbed(VGG5)
    workload = cm.program_workload(program, fl.batch_size, FED_SEQ)

    def links():
        sim = SimulatedCluster(workload, devices[:K], c_srv,
                               program.op_candidates(),
                               iterations=fl.local_iters, jitter=0.05,
                               seed=3)
        edges = (Transport(indexed_bandwidths(EDGE_BPS))
                 if fl.num_edges > 0 else None)
        return sim, Transport(device_bandwidths(devices[:K])), edges

    clients = split_clients(token_dataset(K * FED_ROWS, FED_SEQ,
                                          cfg.vocab_size, seed=0), K)
    test = token_dataset(FED_TEST_ROWS, FED_SEQ, cfg.vocab_size, seed=9)

    def replay(params):
        sim, transport, edges = links()
        scale = (np.asarray([w * w for w in fl.client_widths], np.float64)
                 if fl.client_widths is not None else None)
        clock = RoundClock(program, fl, K, params, sim=sim,
                           transport=transport, compute_scale=scale,
                           edge_transport=edges, seq=FED_SEQ)
        native = program.native_op
        times, _ = clock.times([native] * K, 0)
        plan = _resolve_planner(fl, native, None, None, sim)
        plan.begin(times)
        out = {k: [] for k in ("ops", "times", "round_time", "comm_time",
                               "dropped", "edge_time")}
        for r in range(fl.rounds):
            ops = plan.plan(r, times, sim.bandwidths(r))
            times, comm = clock.times(ops, r)
            edge = 0.0
            if fl.num_edges > 0 and edges is not None:
                used = len(assign_edges(K, fl.num_edges))
                edge = float(np.max(clock.edge_hop_times(used, r)))
            out["ops"].append(list(ops))
            out["times"].append(times.copy())
            out["round_time"].append(float(np.max(times)) + edge)
            out["comm_time"].append(comm.copy())
            out["dropped"].append(0)
            out["edge_time"].append(edge)
            plan.feedback(times)
        return {k: np.asarray(v) for k, v in out.items()}
    return program, clients, test, links, replay


def fed_lm_run(torch, cfg, fl, K, dev, launches, reset_launches, what,
               wrap, keep=None):
    """One ``run_federated`` run of phase 5g on the card, its params drawn
    by the run itself (``program.init(seed)`` on the card): its launches
    exactly what its history needs, its OPs, modelled round and comm
    times, drops and ``edge_time`` equal to the CPU replay, the -CE metric
    finite every round.  ``wrap()`` is the run's server-step probe (a
    context manager whose value is its record).  With ``fl.mesh_shape``
    the mesh's places are all ``dev``.  ``keep`` (a dict) receives the
    final params' flat buffer on the host (``"flat"``) and the history's
    arrays (``"hist"``).  Returns the record."""
    import numpy as np
    from repro_torch.fl.flatbuf import FlatLayout
    from repro_torch.fl.loop import run_federated
    free_card(torch)
    program, clients, test, links, replay = fed_lm_setup(cfg, fl, K)
    sim, transport, edges = links()
    mesh = tuple(fl.mesh_shape) if fl.mesh_shape is not None else None
    places = [dev] * (mesh[0] * mesh[1]) if mesh is not None else None
    reset_launches()
    t0 = time.perf_counter()
    with wrap() as probe:
        h = run_federated(cfg, clients, test, fl, sim=sim,
                          transport=transport, edge_transport=edges,
                          device=dev, mesh_devices=places)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launches)
    n = count_params(h["params"])
    layout = FlatLayout(h["params"])
    if keep is not None:
        keep["flat"] = layout.flatten(h["params"]).cpu()
        keep["hist"] = {k: np.asarray(h[k]) for k in h if k != "params"}
    want = fed_lm_launches(cfg, h, fl, program.native_op, K, mesh)
    print(f"fed-{what}: {n:,} fp32 params ({n * 4 / 2**30:.2f} GiB), the "
          f"flat buffer {layout.padded:,} lanes ({layout.padded // 1024:,} "
          f"blocks of 1024); launches {counts} (expected from its history: "
          f"{want})", flush=True)
    if counts != want:
        fail(f"fed-{what}: launches {counts}, its history needs {want}")
    rep = replay(h["params"])
    for key in ("ops", "times", "round_time", "comm_time", "dropped",
                "edge_time"):
        if not np_equal(h[key], rep[key]):
            fail(f"fed-{what}: {key} {h[key]} vs the CPU replay's "
                 f"{rep[key]}")
    if not np.all(np.isfinite(h["accuracy"])):
        fail(f"fed-{what}: eval metric {h['accuracy']}")
    out = {"launches": counts, "ops": h["ops"].tolist(),
           "metric": h["accuracy"].tolist(),
           "round_time_model_s": h["round_time"].tolist(),
           "comm_time_model_s": h["comm_time"].tolist(),
           "edge_time_model_s": h["edge_time"].tolist(),
           "round_wall_s": h["wall_s"].tolist(), "wall_s": wall,
           "params": n, "flat_lanes": layout.padded,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    out.update(probe)
    print(f"fed-{what}: OPs {h['ops'].tolist()}, modelled round times "
          f"{[round(float(t), 3) for t in h['round_time']]} s (comm, drops "
          f"and edge_time too) equal to the CPU replay; -CE metric "
          f"{[round(float(m), 5) for m in h['accuracy']]}", flush=True)
    del h
    return out


def quiet_launches(fn):
    """``fn()`` with the launch counts restored after it: the checks'
    kernel calls compare a kernel with its plain version and do not count
    as the main path's."""
    from repro_torch.kernels import LAUNCHES
    saved = dict(LAUNCHES)
    try:
        return fn()
    finally:
        LAUNCHES.update(saved)


def topk_plain_chunked(torch, tt, row, meta, block, chunk=1 << 15):
    """``topk_blocks_plain`` over one flat row, ``chunk`` blocks at a time
    (its sort's index buffers at a whole LM row would take ~20 GB)."""
    xb = row.view(-1, block)
    return torch.cat([tt.topk_blocks_plain(xb[i:i + chunk],
                                           meta[i:i + chunk])
                      for i in range(0, xb.shape[0], chunk)]).view(-1)


def server_step_check(torch, step, g, deltas, weights, errors, new_g,
                      new_err):
    """Round 1's server step recomputed on the card from the run's own
    deltas and EF rows, with the plain versions called directly
    (``topk_blocks_plain``, ``quantize_rows_plain``,
    ``dequantize_rows_plain``) and the kernels beside them: each client
    row's kept values and int8 codes and scales bitwise equal, its new EF
    row and the new global bitwise equal to the run's.  The bound on the
    global is 0: with the same kept values and codes, the recompute runs
    ``ServerStep``'s own elementwise fp32 operations (carry, subtract,
    ``acc + w_i * sent``, ``g + acc``) in the same order on the same
    device, and nothing in it reduces across lanes."""
    from repro_torch.fl.flatbuf import _normalized_f64
    from repro_torch.kernels import quant_transfer as tq
    from repro_torch.kernels import topk_compress as tt
    block = step.layout.block
    meta = step._meta.to(g.device)
    w = _normalized_f64(weights, g.device)
    acc = torch.zeros_like(g)
    kept = 0
    for i in range(deltas.shape[0]):
        carried = deltas[i] + errors[i]
        comp = topk_plain_chunked(torch, tt, carried, meta, block)
        comp_k = quiet_launches(lambda: tt.topk_compress_flat(
            carried[None], meta, block)[0])
        if not torch.equal(comp, comp_k):
            fail(f"server step check, client {i}: the top-k kernel keeps "
                 f"{int((comp != comp_k).sum())} lanes otherwise than "
                 f"topk_blocks_plain")
        kept += int((comp != 0).sum())
        q, s = tq.quantize_rows_plain(comp.view(-1, block))
        q_k, s_k = quiet_launches(lambda: tq.quantize_rows(
            comp.view(-1, block)))
        if not (torch.equal(q, q_k) and torch.equal(s, s_k)):
            fail(f"server step check, client {i}: int8 codes or scales of "
                 f"the kernel differ from quantize_rows_plain")
        sent = tq.dequantize_rows_plain(q, s).view(-1)
        if not torch.equal(sent, quiet_launches(
                lambda: tq.dequantize_rows(q, s).view(-1))):
            fail(f"server step check, client {i}: dequantize kernel vs "
                 f"dequantize_rows_plain")
        if not torch.equal(carried - sent, new_err[i]):
            fail(f"server step check, client {i}: new EF row differs")
        acc = acc + w[i] * sent
        del carried, comp, comp_k, q, s, q_k, s_k, sent
    diff = float((g + acc - new_g).abs().max())
    if diff != 0.0:
        fail(f"server step check: the new global differs from the plain "
             f"recompute by {diff} (bound 0)")
    print(f"server step check (round 1): top-k keep masks ({kept:,} lanes "
          f"kept of {deltas.numel():,}), int8 codes and scales bitwise "
          f"equal to the plain versions over {deltas.shape[0]} client "
          f"rows; the new EF rows and the new global bitwise the run's",
          flush=True)
    return {"kept_lanes": kept, "new_global_max_abs_diff": diff}


class ServerStepProbe:
    """Wraps ``ServerStep.__call__`` for one run: each call's seconds (a
    sync before and after) and, with ``check``, round 1's step (the
    second, with nonzero EF rows) checked by ``server_step_check``, its
    seconds kept apart.  With ``single``, every call of a mesh step whose
    ``data`` size is above 1 is held against the single-device
    ``ServerStep`` on the same inputs (no launch counted): the new global
    within ``MESH_ATOL`` (the data shards' partial sums add in another
    order), the EF rows bit for bit (each row's wire is the same ops)."""

    def __init__(self, torch, check=True, single=False):
        self.torch, self.check, self.single = torch, check, single
        self.rec = {"server_step_s": [], "check_s": None}
        if single:
            self.rec["single_device_max_abs_err"] = []

    def against_single(self, step, g, deltas, weights, errors, masks,
                       new_g, new_err):
        from repro_torch.fl import flatbuf
        if not isinstance(step, flatbuf.ShardedServerStep) \
                or step.data_size == 1:
            return
        one = flatbuf.ServerStep(step.layout, step.density, step.quantize)
        want_g, want_err = quiet_launches(
            lambda: self.orig(one, g, deltas, weights, errors, masks))
        err = float((new_g - want_g).abs().max())
        self.rec["single_device_max_abs_err"].append(err)
        if err > MESH_ATOL or (new_err is not None
                               and not self.torch.equal(new_err, want_err)):
            fail(f"mesh step (data={step.data_size}) vs the single-device "
                 f"step on its inputs: global within {err:.3g} (bound "
                 f"{MESH_ATOL}), EF rows bitwise "
                 f"{new_err is None or self.torch.equal(new_err, want_err)}")

    def __enter__(self):
        from repro_torch.fl import flatbuf
        torch, rec, orig = self.torch, self.rec, flatbuf.ServerStep.__call__
        self.orig, self.cls = orig, flatbuf.ServerStep

        def call(step, g, deltas, weights, errors=None, masks=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new_g, new_err = orig(step, g, deltas, weights, errors, masks)
            torch.cuda.synchronize()
            rec["server_step_s"].append(time.perf_counter() - t0)
            if self.single:
                self.against_single(step, g, deltas, weights, errors, masks,
                                    new_g, new_err)
            if self.check and len(rec["server_step_s"]) == 2:
                t1 = time.perf_counter()
                rec["check"] = server_step_check(torch, step, g, deltas,
                                                 weights, errors, new_g,
                                                 new_err)
                rec["check_s"] = time.perf_counter() - t1
            return new_g, new_err
        flatbuf.ServerStep.__call__ = call
        return rec

    def __exit__(self, *exc):
        self.cls.__call__ = self.orig
        return False


class WidthProbe:
    """Wraps the loop's ``hierarchical_apply`` for the width run: its
    seconds, then on the run's own rows: the width-0.25 client's params
    are exactly 0 outside its mask (its delta is exactly -g there, so it
    never left its subnetwork), and a step over the two narrower clients
    alone (nobody covers what lies outside the width-0.5 mask) keeps every
    uncovered coordinate of the global bit for bit."""

    def __init__(self, torch):
        self.torch = torch
        self.rec = {"server_step_s": [], "check_s": None}

    def __enter__(self):
        from repro_torch.fl import loop
        torch, rec, orig = self.torch, self.rec, loop.hierarchical_apply
        self.orig, self.mod = orig, loop

        def call(step, root, g, deltas, weights, errors=None, masks=None,
                 num_edges=1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(step, root, g, deltas, weights, errors, masks,
                       num_edges=num_edges)
            torch.cuda.synchronize()
            rec["server_step_s"].append(time.perf_counter() - t0)
            t1 = time.perf_counter()
            narrow = masks[2] == 0
            outside = int(narrow.sum())
            if not bool(((deltas[2] + g)[narrow] == 0).all()):
                fail("width run: the width-0.25 client's params are not 0 "
                     "outside its mask")
            uncovered = masks[1] == 0
            sub = quiet_launches(lambda: step(g, deltas[1:3], weights[1:3],
                                              None if errors is None
                                              else errors[1:3],
                                              masks=masks[1:3])[0])
            if not torch.equal(sub[uncovered], g[uncovered]):
                fail("width run: a coordinate that no client covers moved")
            moved = int((sub[~uncovered] != g[~uncovered]).sum())
            # in the run a width-1.0 client covers every true lane: what
            # no mask covers is the padding between leaves
            none = int(((masks == 0).all(0)).sum())
            padding = step.layout.padded - step.layout.size
            if none != padding:
                fail(f"width run: {none} lanes uncovered, the padding is "
                     f"{padding}")
            rec["width_check"] = {
                "outside_narrow_mask": outside,
                "uncovered_by_narrow_clients": int(uncovered.sum()),
                "covered_moved": moved, "uncovered_in_run": none}
            rec["check_s"] = time.perf_counter() - t1
            print(f"width run: the width-0.25 client's params exactly 0 on "
                  f"the {outside:,} lanes outside its mask; with the "
                  f"width-1.0 client left out, the {int(uncovered.sum()):,} "
                  f"uncovered lanes keep the global bit for bit ({moved:,} "
                  f"covered lanes moved); in the run itself only the "
                  f"{none:,} padding lanes are uncovered", flush=True)
            del sub
            return out
        loop.hierarchical_apply = call
        return rec

    def __exit__(self, *exc):
        self.mod.hierarchical_apply = self.orig
        return False


def federated_lm_path(torch, dev, launches, reset_launches, card="",
                      keep=None):
    """Phase 5g: ``run_federated`` over qwen3-0.6b at full width and depth
    (sfl at OP 14, the int8 cut, top-k 0.1 EF, int8 deltas, the fused
    server step, round 1's step checked against the plain versions), the
    same set-up with widths and two edges for one round, then mamba2-780m
    at full width, 12 of 48 layers, one round at OP 6 with the int8 cut.
    ``card`` (the card's name and power limit) goes on each summary line;
    ``keep`` receives the qwen3-0.6b run's final flat params and history
    (``fed_lm_run``), phase 5i's yardstick.  Returns the records by path
    name."""
    import dataclasses
    from repro_torch.configs.mamba2_780m import CONFIG as mamba_cfg
    from repro_torch.configs.qwen3_0_6b import CONFIG as qwen_cfg
    from repro_torch.fl.loop import FLConfig
    fl = FLConfig(rounds=2, local_iters=2, batch_size=1, lr=FED_LR,
                  augment=False, mode="sfl", static_op=FED_OP,
                  quantize_transfer=True, delta_density=0.1,
                  quantize_deltas=True, seed=0)
    out = {}
    keep = {} if keep is None else keep
    out["fed-qwen3-0.6b"] = fed_lm_run(
        torch, qwen_cfg, fl, FED_K, dev, launches, reset_launches,
        "qwen3-0.6b", wrap=lambda: ServerStepProbe(torch), keep=keep)
    batched = {}
    out["fed-qwen3-0.6b-batched"] = fed_lm_run(
        torch, qwen_cfg, dataclasses.replace(fl, engine="batched"), FED_K,
        dev, launches, reset_launches, "qwen3-0.6b-batched",
        wrap=lambda: ServerStepProbe(torch, check=False), keep=batched)
    out["fed-qwen3-0.6b-batched"].update(engines_agree(
        torch, dev, qwen_cfg, batched, keep, "fed-qwen3-0.6b-batched"))
    del batched
    wide = dataclasses.replace(fl, rounds=1, client_widths=FED_WIDTHS,
                               num_edges=2, delta_density=1.0)
    out["fed-qwen3-0.6b-widths"] = fed_lm_run(
        torch, qwen_cfg, wide, FED_K, dev, launches, reset_launches,
        "qwen3-0.6b-widths", wrap=lambda: WidthProbe(torch))
    cfg = dataclasses.replace(mamba_cfg, num_layers=FED_MAMBA_LAYERS)
    out["fed-mamba2-780m"] = fed_lm_run(
        torch, cfg, dataclasses.replace(
            fl, rounds=1, static_op=FED_MAMBA_OP, delta_density=1.0,
            quantize_deltas=False), FED_K, dev, launches, reset_launches,
        f"mamba2-780m ({FED_MAMBA_LAYERS} of 48 layers)",
        wrap=lambda: ServerStepProbe(torch, check=False))
    for name, r in out.items():
        walls = [round(t, 3) for t in r["round_wall_s"]]
        check = (f" (the last includes the {r['check_s']:.2f} s check)"
                 if r["check_s"] is not None else "")
        print(f"{name} ({card}): wall per round {walls} s{check}, server "
              f"step {[round(t, 3) for t in r['server_step_s']]} s, peak "
              f"{r['peak_memory_gib']:.2f} GiB, {r['flat_lanes']:,} "
              f"flat-buffer lanes", flush=True)
    return out


def engines_agree(torch, dev, cfg, got, want, what):
    """A batched ``run_federated`` run (``got``: ``fed_lm_run``'s ``keep``)
    against the sequential run of the same set-up (``want``): OPs,
    modelled round and comm times and drops equal, the -CE metric within
    FED_DISCRETE_METRIC_REL, the final params lane by lane within
    FED_LANE_REL / FED_TREE_SHARE / FED_DISCRETE_PARAMS_REL of their
    leaf's largest sequential value.  Returns the readings."""
    import numpy as np
    from repro_torch.fl.flatbuf import FlatLayout
    from repro_torch.models.split_program import get_split_program
    hg, hw = got["hist"], want["hist"]
    for key in ("ops", "times", "round_time", "comm_time", "dropped",
                "edge_time"):
        if not np_equal(hg[key], hw[key]):
            fail(f"{what}: {key} {hg[key]} != the sequential run's "
                 f"{hw[key]}")
    metric = float(np.max(np.abs(hg["accuracy"] - hw["accuracy"])
                          / np.abs(hw["accuracy"])))
    free_card(torch)
    layout = FlatLayout(get_split_program(cfg).init(0, device="meta"))
    a, b = got["flat"].to(dev), want["flat"].to(dev)
    gap, beyond = 0.0, 0
    for off, size in zip(layout.offsets, layout.sizes):
        x, y = a[off:off + size], b[off:off + size]
        err = (x - y).abs() / max(float(y.abs().max()), 1e-3)
        gap = max(gap, float(err.max()))
        beyond += int((err > FED_LANE_REL).sum())
    share = beyond / layout.size
    del a, b
    if not (metric <= FED_DISCRETE_METRIC_REL
            and gap <= FED_DISCRETE_PARAMS_REL and share <= FED_TREE_SHARE):
        fail(f"{what} vs sequential: metric {metric:.3g} relative (<= "
             f"{FED_DISCRETE_METRIC_REL}?), params {gap:.3g} of a leaf's "
             f"max (<= {FED_DISCRETE_PARAMS_REL}?), {share:.3g} of the "
             f"lanes beyond {FED_LANE_REL} (<= {FED_TREE_SHARE}?)")
    print(f"{what} == sequential (ops, times, comm, drops); metric "
          f"{metric:.3g} relative (<= {FED_DISCRETE_METRIC_REL}), params "
          f"{gap:.3g} of a leaf's max (<= {FED_DISCRETE_PARAMS_REL}), "
          f"{share:.3g} of the lanes beyond {FED_LANE_REL} (<= "
          f"{FED_TREE_SHARE})", flush=True)
    return {"vs_sequential": {"metric_rel": metric, "params_rel": gap,
                              "lane_share": share}}


def side_stream_publication(torch, engine, store, src):
    """Phase 5h's stream probe: a publisher thread makes its own stream
    wait for ``src`` (written on the default stream), sleeps it
    HOT_SIDE_SLEEP cycles, and publishes ``src`` from it (the flatten runs
    there); the engine then swaps on the default stream at once, while the
    copy is still pending (the probe fails if it is not, since the swap
    would then prove nothing).  The adopted params must be ``src`` bit for
    bit.  Returns the probe's record."""
    from repro_torch.tree import tree_leaves
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    published = torch.cuda.Event()
    version = store.version

    def publish():
        with torch.cuda.stream(side):
            side.wait_stream(main)
            torch.cuda._sleep(HOT_SIDE_SLEEP)
            store.publish(src)
            published.record(side)
    t0 = time.perf_counter()
    thread = threading.Thread(target=publish)
    thread.start()
    thread.join(timeout=60)
    if thread.is_alive() or store.version != version + 1:
        fail("side-stream publication: the publisher thread did not finish")
    pending = not published.query()
    if not pending:
        fail("side-stream publication: the copy had finished before the "
             "swap (a longer sleep is needed for the probe to race)")
    if not engine.maybe_swap(store):
        fail("side-stream publication: the engine did not swap")
    same = all(torch.equal(a, b) for a, b in
               zip(tree_leaves(engine.params), tree_leaves(src)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not same:
        fail("side-stream publication: the engine adopted params that "
             "differ from the publication's source")
    print(f"side-stream publication: published from a second stream on a "
          f"second thread, the copy still pending when the engine swapped; "
          f"the adopted params are the source's bit for bit ({wall:.3f} s "
          f"with the {HOT_SIDE_SLEEP:,}-cycle sleep)", flush=True)
    return {"copy_pending_at_swap": pending, "bitwise": same,
            "wall_s": wall, "version": engine.params_version}


def hotswap_lm_path(torch, dev, launches, reset_launches, card=""):
    """Phase 5h: federated training published into a live server.
    ``run_federated_async`` over qwen3-0.6b at full width and depth (phase
    5g's set-up, a buffer of K, 1 local iteration, HOT_AGGS aggregations)
    with an ``on_aggregate`` hook that publishes each aggregation into a
    ``ParamStore`` (``on_aggregate``: a copy of the flat global), swaps it
    into a live ``ServeEngine`` (``maybe_swap``) and serves HOT_TRAFFIC's
    requests through ``serve(..., store=)``.  Checked: the served versions
    are 1..HOT_AGGS; after each swap every request against the oracle on
    the adopted params (``check_against_oracle``: its tokens up to the
    first top-2 margin below MARGIN, its decode steps' logits over that
    prefix within STEPWISE_TOL); the run's launches are exactly its
    history's (``expected_async_launches``: training, eval passes and the
    engine's prefills; the checks' kernel calls are not counted); OPs,
    modelled times, comm and drops equal the CPU replay (round times within
    1e-12); after the run the engine's params are ``hist["params"]`` bit
    for bit, a ``maybe_swap`` without a publication returns False, a fresh
    engine on the same params given the last aggregation's requests gives
    the live engine's ``last_logits`` bit for bit at every step, and a
    publication from a side stream is adopted whole
    (``side_stream_publication``).  Printed with ``card``: the wall seconds
    of each aggregation and of its hook (publish, swap, serve), each
    publication's and swap's seconds, prefill seconds and decode ms a step
    under training's memory pressure, and the peak GiB.  The oracle check
    is no part of training and serving: ``aggregation_wall_s`` and
    ``peak_memory_gib`` leave it out, ``aggregation_wall_with_check_s`` and
    ``peak_memory_with_check_gib`` keep it.  Returns the record."""
    import numpy as np
    from repro_torch.configs.qwen3_0_6b import CONFIG as cfg
    from repro_torch.fl.async_loop import run_federated_async
    from repro_torch.fl.loop import FLConfig
    from repro_torch.serving import (ParamStore, ServeCosts, ServeEngine,
                                     TrafficGenerator, serve)
    from repro_torch.tree import tree_leaves, tree_map
    free_card(torch)
    fl = FLConfig(rounds=HOT_AGGS, local_iters=1, batch_size=1, lr=FED_LR,
                  augment=False, mode="sfl", static_op=FED_OP,
                  quantize_transfer=True, delta_density=HOT_DENSITY,
                  quantize_deltas=True, seed=0)
    program, clients, test, links, replay = fed_lm_setup(cfg, fl, FED_K)
    sim, transport, _ = links()
    torch.cuda.reset_peak_memory_stats()
    init = program.init(fl.seed, dev)
    store = ParamStore(program.flat_layout(init))
    engine = ServeEngine(cfg, init, slots=HOT_SLOTS,
                         max_prompt=HOT_MAX_PROMPT, max_seq=HOT_MAX_SEQ)
    del init
    costs = ServeCosts(prefill=1.0, decode=0.1)
    rec = {"publish_s": [], "swap_s": [], "hook_s": [], "serve_s": [],
           "check_s": [], "prefill_s": [], "decode_step_s": [],
           "served_versions": [], "tokens_compared": 0, "tokens_total": 0,
           "stepwise_max_abs_diff": 0.0, "stepwise_by_request": [],
           "distinct_tokens": [], "engine_prefills": 0}
    step_logits = []
    peaks = {"train_serve": 0, "with_check": 0}

    def synced(fn, log, logits=False):
        def run(*a, **kw):
            active = engine.active.copy()
            t = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            log.append(time.perf_counter() - t)
            if logits:   # the rows of the slots that were decoding
                step_logits.append(engine.last_logits[active])
            return r
        return run
    engine.submit = synced(engine.submit, rec["prefill_s"])
    engine.step = synced(engine.step, rec["decode_step_s"], logits=True)
    rows = {}
    capture_engine_rows(engine, rows)

    def requests_of(version):
        return TrafficGenerator(vocab_size=cfg.vocab_size, seed=version,
                                **HOT_TRAFFIC).generate()

    def oracle_check(version, res):
        """Each request against the oracle on the engine's adopted params
        (``check_against_oracle``): its tokens and its decode steps'
        logits, up to the first margin below MARGIN."""
        for r in res["requests"]:
            n, m, diff, _, margins = check_against_oracle(
                torch, cfg, engine.params, r, rows, f"hotswap v{version}")
            distinct = len(set(r.tokens))
            rec["tokens_compared"] += n
            rec["tokens_total"] += r.gen
            rec["stepwise_max_abs_diff"] = max(
                rec["stepwise_max_abs_diff"], diff)
            rec["stepwise_by_request"].append((version, r.rid, diff, m))
            rec["distinct_tokens"].append((version, r.rid, distinct))
            print(f"hotswap v{version} request {r.rid}: prompt "
                  f"{len(r.prompt)}, {n} of {r.gen} tokens equal the "
                  f"oracle's (min margin {min(margins):.3g}), {distinct} "
                  f"distinct; {m} decode steps' logits within {diff:.3g} < "
                  f"{STEPWISE_TOL}", flush=True)

    def hook(version, params, g_flat=None):
        t_hook = time.perf_counter()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store.on_aggregate(version, params, g_flat=g_flat)
        torch.cuda.synchronize()
        rec["publish_s"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        swapped = engine.maybe_swap(store)
        torch.cuda.synchronize()
        rec["swap_s"].append(time.perf_counter() - t0)
        if not swapped or engine.params_version != version:
            fail(f"hotswap: aggregation {version} not adopted (swapped "
                 f"{swapped}, serving version {engine.params_version})")
        rec["served_versions"].append(engine.params_version)
        requests = requests_of(version)
        step_logits.clear()
        rows.clear()
        t0 = time.perf_counter()
        res = serve(engine, requests, costs, store=store)
        rec["serve_s"].append(time.perf_counter() - t0)
        rec["engine_prefills"] += len(requests)
        if res["swaps"]:
            fail(f"hotswap v{version}: serve swapped {res['swaps']} with no "
                 f"new publication")
        # the check is no part of training and serving: its seconds come
        # off the aggregation's wall, and its memory off the peak
        peaks["train_serve"] = max(peaks["train_serve"],
                                   torch.cuda.max_memory_allocated())
        t0 = time.perf_counter()
        quiet_launches(lambda: oracle_check(version, res))
        rec["check_s"].append(time.perf_counter() - t0)
        peaks["with_check"] = max(peaks["with_check"],
                                  torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        rec["last_logits"] = list(step_logits)
        rec["hook_s"].append(time.perf_counter() - t_hook)

    reset_launches()
    t0 = time.perf_counter()
    h = run_federated_async(cfg, clients, test, fl, sim=sim,
                            transport=transport, on_aggregate=hook,
                            device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launches)
    last = torch.cuda.max_memory_allocated()
    peak = max(peaks["train_serve"], last) / 2**30
    peak_with_check = max(peaks["with_check"], last) / 2**30
    want = expected_async_launches(h, fl, program.native_op, FED_K, cfg=cfg,
                                   prefills=rec["engine_prefills"])
    print(f"hotswap-qwen3-0.6b: launches {counts} (expected from its "
          f"history and {rec['engine_prefills']} engine prefills: {want})",
          flush=True)
    if counts != want:
        fail(f"hotswap-qwen3-0.6b: launches {counts}, its history and "
             f"prefills need {want}")
    if rec["served_versions"] != list(range(1, HOT_AGGS + 1)):
        fail(f"hotswap: served versions {rec['served_versions']}")
    if rec["tokens_compared"] < rec["tokens_total"] // 2:
        fail(f"hotswap: only {rec['tokens_compared']} of "
             f"{rec['tokens_total']} tokens compared")
    rep = replay(h["params"])
    for key in ("ops", "times", "comm_time", "dropped"):
        if not np_equal(h[key], rep[key]):
            fail(f"hotswap: {key} {h[key]} vs the CPU replay's {rep[key]}")
    if not np.allclose(h["round_time"], rep["round_time"], rtol=1e-12,
                       atol=0) or (h["staleness"] != 0).any():
        fail(f"hotswap: round times {h['round_time']} vs the replay's "
             f"{rep['round_time']}, staleness {h['staleness']}")
    if not np.all(np.isfinite(h["accuracy"])):
        fail(f"hotswap: eval metric {h['accuracy']}")
    if not all(torch.equal(a, b) for a, b in zip(
            tree_leaves(engine.params), tree_leaves(h["params"]))):
        fail("hotswap: the engine's final params differ from the run's")
    if engine.maybe_swap(store):
        fail("hotswap: maybe_swap without a new publication swapped")
    del h["params"]
    print(f"hotswap: served versions {rec['served_versions']}; "
          f"{rec['tokens_compared']} of {rec['tokens_total']} tokens "
          f"compared, all equal, decode logits within "
          f"{rec['stepwise_max_abs_diff']:.3g} of the oracle's; the "
          f"engine's final params are the run's "
          f"bit for bit; a second maybe_swap returns False; OPs "
          f"{h['ops'].tolist()}, modelled times, comm and drops equal to "
          f"the CPU replay", flush=True)

    # a fresh engine on the same params, the last aggregation's requests;
    # the rows of the decoding slots compared (an idle slot decodes what
    # its last occupant left, which differs between the two engines)
    fresh = ServeEngine(cfg, engine.params, slots=HOT_SLOTS,
                        max_prompt=HOT_MAX_PROMPT, max_seq=HOT_MAX_SEQ)
    fresh_logits = []
    step = fresh.step

    def fresh_step():
        active = fresh.active.copy()
        out = step()
        fresh_logits.append(fresh.last_logits[active])
        return out
    fresh.step = fresh_step
    quiet_launches(lambda: serve(fresh, requests_of(HOT_AGGS), costs))
    live = rec.pop("last_logits")
    if len(live) != len(fresh_logits) or not all(
            np.array_equal(a, b) for a, b in zip(live, fresh_logits)):
        fail(f"hotswap: the live engine's last_logits differ from a fresh "
             f"engine's on the same params ({len(live)} and "
             f"{len(fresh_logits)} steps)")
    print(f"hotswap: a fresh ServeEngine on the adopted params, given the "
          f"same {HOT_TRAFFIC['n_requests']} requests, gives the live "
          f"engine's last_logits (the decoding slots' rows) bit for bit at "
          f"all {len(live)} decode steps", flush=True)
    del fresh, fresh_logits, live

    src = tree_map(lambda p: p * 1.5, engine.params)
    rec["side_stream"] = side_stream_publication(torch, engine, store, src)
    del src

    walls_with_check = [float(t) for t in h["wall_s"]]
    walls = [t - c for t, c in zip(walls_with_check, rec["check_s"])]
    out = {"launches": counts, "expected_launches": want,
           "ops": h["ops"].tolist(), "metric": h["accuracy"].tolist(),
           "round_time_model_s": h["round_time"].tolist(),
           "aggregation_wall_s": walls,
           "aggregation_wall_with_check_s": walls_with_check, "wall_s": wall,
           "peak_memory_gib": peak,
           "peak_memory_with_check_gib": peak_with_check,
           "params": count_params(engine.params),
           "flat_lanes": store.layout.padded, "top_k_density": HOT_DENSITY}
    out.update(rec)
    print(f"hotswap-qwen3-0.6b ({card}): wall per aggregation, train and "
          f"serve, {[round(t, 3) for t in walls]} s (with the oracle check "
          f"{[round(t, 3) for t in walls_with_check]}; the check "
          f"{[round(t, 3) for t in rec['check_s']]}); the hook without the "
          f"check (publish, swap, serve) "
          f"{[round(t - c, 3) for t, c in zip(rec['hook_s'], rec['check_s'])]}"
          f" s; "
          f"publish_flat {[round(t * 1e3, 2) for t in rec['publish_s']]} ms, "
          f"maybe_swap {[round(t * 1e3, 2) for t in rec['swap_s']]} ms; "
          f"prefill (padded to {HOT_MAX_PROMPT}) median "
          f"{statistics.median(rec['prefill_s']):.3f} s "
          f"({len(rec['prefill_s'])}), decode step ({HOT_SLOTS} slots) "
          f"median {statistics.median(rec['decode_step_s']) * 1e3:.1f} ms "
          f"({len(rec['decode_step_s'])}); peak {peak:.2f} GiB (with the "
          f"check {peak_with_check:.2f}); the whole run {wall:.2f} s",
          flush=True)
    return out


def moe_mesh_drill(torch, dev, arch, cf, cases, launches, reset_launches):
    """One MoE layer of ``arch`` at full width (seeded weights drawn on the
    card), its capacity factor ``cf``: the local block and the sharded
    block (``use_rules`` over each case's mesh of ``dev`` places, under
    ``moe_int8_gather()`` where the case says) on ``MOE_MESH_S`` tokens and
    on one decode step of ``MOE_MESH_ROWS`` rows, each within its bound of
    the largest local value; no repo kernel launches.  Returns the
    record."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.models import layers as L
    from repro_torch.parallel.sharding import (make_axis_rules,
                                               make_flat_mesh, use_rules)
    free_card(torch)
    cfg0 = get_config(arch)
    cfg = dataclasses.replace(cfg0, moe=dataclasses.replace(
        cfg0.moe, capacity_factor=cf))
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    p = L.init_moe(torch.Generator(device=dev).manual_seed(0), cfg,
                   torch.float32)
    n = sum(v.numel() for v in p.values() if torch.is_tensor(v)) + sum(
        v.numel() for v in p.get("dense", {}).values())
    gen = torch.Generator(device=dev).manual_seed(1)
    xs = {"S": torch.randn((1, MOE_MESH_S, cfg.d_model), generator=gen,
                           device=dev) * 0.5,
          "decode": torch.randn((MOE_MESH_ROWS, 1, cfg.d_model),
                                generator=gen, device=dev) * 0.5}
    rec = {"params": n, "capacity_factor": cf, "cases": {}}
    reset_launches()
    with torch.no_grad():
        # nothing dropped: the busiest expert's load within the capacity
        _, topi = L.moe_route(cfg, p, xs["S"].reshape(-1, cfg.d_model))
        load = int(torch.bincount(topi.reshape(-1), minlength=E).max())
        C = max(1, int(cf * MOE_MESH_S * k / E))
        if load > C:
            fail(f"{arch}: an expert takes {load} tokens, capacity {C}")
        rec["busiest_expert"], rec["capacity"] = load, C

        def timed(fn, reps=3):
            ts = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y = fn()
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            return y, statistics.median(ts)

        local = {key: timed(lambda x=x: L._moe_block_local(cfg, p, x))
                 for key, x in xs.items()}
        for shape, int8 in cases:
            mesh = make_flat_mesh(shape, devices=[dev] * (shape[0]
                                                          * shape[1]))
            rules = make_axis_rules(mesh)
            kind = ("A" if E % shape[1] == 0 else "B") + (
                " FSDP" if shape[0] > 1 else "") + (" int8" if int8 else "")
            bound = MOE_INT8_GATHER_REL if int8 else MOE_MESH_REL
            for key, x in xs.items():
                with use_rules(rules), L.moe_int8_gather(int8):
                    y, ms = timed(lambda: L.moe_block(cfg, p, x))
                want, local_ms = local[key]
                rel = float((y - want).abs().max() / want.abs().max())
                name = f"{shape[0]}x{shape[1]}{'-int8' if int8 else ''}-{key}"
                rec["cases"][name] = {"case": kind, "rel_err": rel,
                                      "ms": ms, "local_ms": local_ms}
                print(f"{arch} MoE layer, case {kind} on {shape} "
                      f"({key}: {tuple(x.shape)}): sharded {ms:.2f} ms vs "
                      f"local {local_ms:.2f} ms, within {rel:.3g} of the "
                      f"largest local value (bound {bound})", flush=True)
                if not bool(torch.isfinite(y).all()) or rel > bound:
                    fail(f"{arch} {name}: sharded vs local {rel:.3g} > "
                         f"{bound}")
    if any(launches.values()):
        fail(f"{arch} MoE layers launched a repo kernel: {dict(launches)}")
    rec["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"{arch} MoE layer: {n:,} fp32 params, busiest expert {load} of "
          f"capacity {C}, peak {rec['peak_memory_gib']:.2f} GiB", flush=True)
    del p, xs, local
    return rec


def lm_mesh_path(torch, dev, launches, reset_launches, card, fed_ref):
    """Phase 5i: phase 5g's qwen3-0.6b run over ``FED_MESH`` (places all
    ``dev``), its params and history bit for bit phase 5g's (``fed_ref``,
    from ``federated_lm_path(keep=)``), launches exactly what its history
    and mesh need; then ``moe_mesh_drill`` over ``MOE_MESH_CASES``.
    Returns the records."""
    import dataclasses

    import numpy as np
    from repro_torch.configs.qwen3_0_6b import CONFIG as qwen_cfg
    from repro_torch.fl.loop import FLConfig
    from repro_torch.parallel.sharding import flat_shard_tail
    fl = FLConfig(rounds=2, local_iters=2, batch_size=1, lr=FED_LR,
                  augment=False, mode="sfl", static_op=FED_OP,
                  quantize_transfer=True, delta_density=0.1,
                  quantize_deltas=True, seed=0, mesh_shape=FED_MESH)
    keep = {}
    tag = f"fed-qwen3-0.6b-mesh-{FED_MESH[0]}x{FED_MESH[1]}"
    out = {tag: fed_lm_run(
        torch, qwen_cfg, fl, FED_K, dev, launches, reset_launches,
        f"qwen3-0.6b on mesh {FED_MESH}",
        wrap=lambda: ServerStepProbe(torch, check=False), keep=keep)}
    r = out[tag]
    tail = flat_shard_tail(r["flat_lanes"], 1024, FED_MESH[1])
    r["tail_lanes"] = tail
    for key, want in fed_ref["hist"].items():
        if key != "wall_s" and not np.array_equal(keep["hist"][key], want):
            fail(f"{tag}: {key} {keep['hist'][key]} != phase 5g's {want}")
    if not torch.equal(keep["flat"], fed_ref["flat"]):
        fail(f"{tag}: final params differ from phase 5g's")
    print(f"{tag}: params ({r['flat_lanes']:,} lanes + a tail of {tail}) "
          f"and history bit for bit phase 5g's run", flush=True)
    del keep
    for arch, (cf, cases) in MOE_MESH_CASES.items():
        out[f"moe-{arch}"] = moe_mesh_drill(torch, dev, arch, cf, cases,
                                            launches, reset_launches)
        free_card(torch)
    r, ref = out[tag], fed_ref["record"]
    print(f"{tag} ({card}, {FED_MESH[0] * FED_MESH[1]} places on one card, "
          f"no inter-card traffic): wall a round "
          f"{[round(t, 3) for t in r['round_wall_s']]} s, server step "
          f"{[round(t, 3) for t in r['server_step_s']]} s, peak "
          f"{r['peak_memory_gib']:.2f} GiB; phase 5g's "
          f"{[round(t, 3) for t in ref['round_wall_s']]} / "
          f"{[round(t, 3) for t in ref['server_step_s']]} s, "
          f"{ref['peak_memory_gib']:.2f} GiB", flush=True)
    return out


def pod_lane_readings(torch, got, want):
    """``got`` (a pod's params) against ``want`` (the lone step's), leaf by
    leaf: the worst error over its leaf's max, the tree's share of lanes
    beyond POD_STEP_REL of their leaf's max, and the worst absolute error
    of those lanes."""
    from repro_torch.tree import tree_leaves
    worst, beyond, lanes, worst_abs = 0.0, 0, 0, 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        scale = max(float(w.abs().max()), 1e-30)
        err = (g - w).abs()
        worst = max(worst, float(err.max()) / scale)
        far = err > POD_STEP_REL * scale
        beyond += int(far.sum())
        lanes += err.numel()
        if bool(far.any()):
            worst_abs = max(worst_abs, float(err[far].max()))
    return worst, beyond / lanes, worst_abs


def pod_pair_launches(cfg, local_steps):
    """The pod pair's launches: a local step runs flash's forward twice a
    layer (the forward and its remat recompute, both under ``vmap``) and
    its backward pair once, every pod folded into one launch."""
    n = cfg.num_layers * local_steps
    return {"quantize": 0, "dequantize": 0, "topk_compress": 0,
            "flash_attention": 2 * n, "flash_attention_bwd_dq": n,
            "flash_attention_bwd_dkdv": n, "ssd_scan": 0, "ssd_scan_bwd": 0}


def pod_pair_path(torch, dev, launches, reset_launches, card,
                  strict=True):
    """Phase 5j (a): the FedAdapt pod pair at qwen3-0.6b's full width and
    depth, POD_ROWS rows a pod, no param copied per row in the first
    local step, each pod against the train step on its rows alone, the
    sync bit for bit.  ``strict=False`` records the per-row copies
    instead of failing on them (``scripts/pod_rows.py`` runs another
    tree's package through this phase).  Returns the record and the
    initial params."""
    from repro_torch.configs.qwen3_0_6b import CONFIG as cfg
    from repro_torch.launch import steps as S
    from repro_torch.models import api
    from repro_torch.tree import tree_leaves, tree_map
    free_card(torch)
    params = api.init(cfg, 0, device=dev)
    opt = S.make_opt(cfg)
    local_step, sync_step = S.make_local_sync_steps(cfg, opt, 2)
    train_step = S.make_train_step(cfg, opt)
    batch_of = lm_batches(torch, cfg, dev)

    def pod_rows(t, i):
        rs = [batch_of(POD_SEQ, POD_ROWS * (2 * t + i) + r)
              for r in range(POD_ROWS)]
        return {k: torch.cat([r[k] for r in rs]) for k in rs[0]}
    rows = [[pod_rows(t, i) for i in range(2)]
            for t in range(POD_LOCAL_STEPS)]
    pp = tree_map(lambda x: torch.stack([x, x]), params)
    oo = tree_map(lambda x: torch.stack([x, x]), opt.init(params))
    torch.cuda.synchronize()
    reset_launches()
    after, losses, step_s, step_peak = [], [], [], []
    for t in range(POD_LOCAL_STEPS):
        batch = {k: torch.stack([r[k] for r in rows[t]]) for k in rows[t][0]}
        recorder = S.ParamCopyRecorder(pp) if t == 0 else None
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with recorder or contextlib.nullcontext():
            loss, pp, oo = local_step(pp, oo, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        step_peak.append(torch.cuda.max_memory_allocated() / 2**30)
        after.append(pp)
        losses.append(loss.tolist())
        if recorder is not None:
            copies = recorder.copies
            del recorder
            if copies and strict:
                fail(f"pod pair: params copied per row in the first local "
                     f"step: {copies}")
    peak = max(step_peak)
    got = dict(launches)
    want = pod_pair_launches(cfg, POD_LOCAL_STEPS)
    if got != want:
        fail(f"pod pair: launches {got} != {want}")
    del oo
    t0 = time.perf_counter()
    synced = sync_step(pp)
    torch.cuda.synchronize()
    sync_s = time.perf_counter() - t0
    for x, y in zip(tree_leaves(synced), tree_leaves(pp)):
        mean = (y[0] + y[1]) * 0.5
        if not (torch.equal(x[0], mean) and torch.equal(x[1], mean)):
            fail("pod pair: the sync is not (p0 + p1) * 0.5 in both pods")
    parted = max(float((y[0] - y[1]).abs().max()) for y in tree_leaves(pp))
    del synced, pp
    out = {"rows_a_pod": POD_ROWS, "seq": POD_SEQ, "launches": got,
           "peak_memory_gib": peak, "step_peak_gib": step_peak,
           "local_step_s": step_s, "sync_s": sync_s, "losses": losses,
           "pods_parted": parted, "per_row_copies": copies, "lone": []}
    # each pod alone: the train step on its own rows, two steps
    for i in range(2):
        p, state = params, opt.init(params)
        for t in range(POD_LOCAL_STEPS):
            t0 = time.perf_counter()
            loss, p, state = quiet_launches(
                lambda: train_step(p, state, rows[t][i]))
            torch.cuda.synchronize()
            lone_s = time.perf_counter() - t0
            rel = abs(float(loss) - losses[t][i]) / abs(float(loss))
            if not rel <= TRAIN_LOSS_REL:
                fail(f"pod {i} step {t + 1}: loss {losses[t][i]} vmapped, "
                     f"{float(loss)} alone: {rel:.3g} > {TRAIN_LOSS_REL}")
            worst, share, worst_abs = pod_lane_readings(
                torch, tree_map(lambda x: x[i], after[t]), p)
            if t == 0 and not (share <= POD_FLIP_SHARE and worst_abs
                               <= 2 * ADAMW_LR * (1 + 1e-3)
                               + POD_STEP_REL):
                fail(f"pod {i} after one step: {share:.3g} of the lanes "
                     f"beyond {POD_STEP_REL} of their leaf's max (bound "
                     f"{POD_FLIP_SHARE}), the worst of them {worst_abs:.3g} "
                     f"(bound 2 lr)")
            out["lone"].append({"pod": i, "step": t + 1, "loss_rel": rel,
                                "worst_rel": worst, "share_beyond": share,
                                "worst_abs_beyond": worst_abs,
                                "step_s": lone_s})
            print(f"pod {i} step {t + 1} against the step alone: loss "
                  f"{rel:.3g} relative, lanes within {worst:.3g} of their "
                  f"leaf's max, {share:.3g} of them beyond {POD_STEP_REL} "
                  f"(worst {worst_abs:.3g})", flush=True)
        del p, state
    del after
    print(f"pod pair, qwen3-0.6b full width and depth, {POD_ROWS} rows of "
          f"{POD_SEQ} tokens a pod ({card}): local steps "
          f"{[round(t, 3) for t in step_s]} s (the first under the copy "
          f"recorder: {len(copies)} per-row param copies), sync "
          f"{sync_s:.3f} s, the step alone "
          f"{[round(r['step_s'], 3) for r in out['lone']]} s, peak "
          f"{peak:.2f} GiB (a step: {[round(p, 2) for p in step_peak]}); "
          f"the sync (p0 + p1) * 0.5 bit for bit; launches {got}",
          flush=True)
    return out, params


def step_builders_path(torch, dev, params, launches, reset_launches):
    """Phase 5j (b): make_prefill_step and make_decode_step at qwen3-0.6b
    bit for bit api.prefill / api.decode."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.qwen3_0_6b import CONFIG as cfg
    from repro_torch.launch import steps as S
    from repro_torch.models import api
    from repro_torch.tree import tree_leaves
    gen = torch.Generator().manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (2, STEPS_PROMPT),
                           generator=gen).to(dev)
    shape = ShapeConfig("prefill", STEPS_PROMPT + STEPS_DECODE, 2,
                        "prefill")
    prefill = S.make_prefill_step(cfg, shape)
    decode = S.make_decode_step(cfg)

    def same(a, b, what):
        if not all(torch.equal(x, y) for x, y in
                   zip(tree_leaves(a), tree_leaves(b))):
            fail(f"step builders: {what} differs from the api's")
    with torch.no_grad():
        reset_launches()
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        want_logits, want_cache = quiet_launches(lambda: api.prefill(
            cfg, params, {"tokens": tokens}, target_seq=shape.seq_len))
        same((logits, cache), (want_logits, want_cache), "the prefill")
        token = logits.argmax(-1)[:, None]
        for i in range(STEPS_DECODE):
            pos = STEPS_PROMPT + i
            logits, cache = decode(params, cache, token, pos)
            want_logits, want_cache = quiet_launches(
                lambda: api.decode(cfg, params, want_cache, token, pos))
            same((logits, cache), (want_logits, want_cache),
                 f"decode step {i}")
            token = logits.argmax(-1)[:, None]
        got = dict(launches)
    want = {k: 0 for k in got}
    want["flash_attention"] = cfg.num_layers
    if got != want:
        fail(f"step builders: launches {got} != {want}")
    print(f"step builders (qwen3-0.6b, B = 2, {STEPS_PROMPT}-token prompt, "
          f"{STEPS_DECODE} decode steps): bit for bit api.prefill / "
          f"api.decode; prefill {prefill_s:.3f} s", flush=True)
    return {"launches": got, "prefill_s": prefill_s}


def moe_gather_bytes(cfg, tp, layers):
    """A place's sharded-MoE all-gather bytes in a bf16 dry run: its body
    gathers the router (d, E) and its experts' three weights, the ``E /
    tp`` experts it holds (case A) or a ``d_ff / tp`` slice of all of them
    (case B), plus arctic's dense FFN (its ``d_ff`` over ``tp`` when that
    divides), once a layer."""
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    case_a = E % tp == 0
    local_E, f_l = (E // tp, f) if case_a else (E, f // tp)
    per_place = d * E + 3 * local_E * d * f_l
    if cfg.moe.dense_residual:
        per_place += 3 * d * (f // tp if f % tp == 0 else f)
    return 2.0 * per_place * layers


def qwen3_train_flops(cfg, B, S):
    """The global matmul FLOPs of a qwen3 train step: the forward
    (projections and the tied unembedding 2 T d d_out, attention's two
    products a head over the S (S + 1) / 2 causal pairs, the flash
    kernel's written count),
    its recompute in the backward (every one of them sits in a
    rematerialised layer or CE chunk, recomputed under ``torch.func``
    too) and the backward's two products a forward one: four forwards.  A
    place of the 16 x 16 mesh does 1/256 of it."""
    T, d, L = B * S, cfg.d_model, cfg.num_layers
    per_layer = (d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
                 + 3 * d * cfg.d_ff)
    attention = 4 * B * cfg.num_heads * (S * (S + 1) // 2) * cfg.head_dim
    return 4 * (2 * T * (L * per_layer + cfg.vocab_size * d)
                + L * attention)


def qwen3_train_collectives(cfg, B, S, chunk=1024):
    """A place's FSDP and TP collectives in qwen3's train step on the 16
    x 16 mesh (``launch.hlo_analysis``'s rules): each weight matrix
    gathered over data (its model split kept) in the forward, its
    recompute and for the input gradient, the tied unembedding likewise
    in each CE chunk; each gradient leaf reduce-scattered to its share;
    the residual stream (B / 16 rows, bf16) summed over model at the
    embedding's and each block's two pins (forward and recompute) and at
    the first layer's and each block's two input gradients.  Returns
    ``{(op, where): (count, bytes)}``."""
    L, d, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    per_layer = (d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
                 + 3 * d * cfg.d_ff)
    chunks = S // min(chunk, S)
    return {"fsdp all-gather": (3 * (7 * L + chunks),
                                2 * 3 * (L * per_layer + chunks * V * d)
                                / 16),
            "fsdp reduce-scatter": (8, 2 * (L * per_layer + V * d) / 256),
            "tp all-reduce": (6 * L + 2, (6 * L + 2) * 2 * B // 16 * S
                              * d)}


def qwen3_read_collectives(groups):
    """The same three from a cell's ``collective_groups``."""
    fsdp = [v for k, v in groups.items() if k.startswith("all-gather data ")
            and k.split()[2] in ("mm", "bmm")]
    rs = groups.get("reduce-scatter data shard", {"count": 0, "bytes": 0})
    tp = [groups[k] for k in ("all-reduce model shard",
                              "all-reduce model add") if k in groups]
    return {"fsdp all-gather": (sum(v["count"] for v in fsdp),
                                sum(v["bytes"] for v in fsdp)),
            "fsdp reduce-scatter": (rs["count"], rs["bytes"]),
            "tp all-reduce": (sum(v["count"] for v in tp),
                              sum(v["bytes"] for v in tp))}


def dry_runs_path(torch, launches, card):
    """Phase 5j (c): the dry runs on meta, on this machine (no JAX):
    every cell ``ok``, the card's memory and every launch count unchanged;
    per place (``launch.hlo_analysis``): qwen3's matmul FLOPs the closed
    form over the 256 places (their sum the global form) and its FSDP and
    TP collectives closed forms, the MoE cells' one-place body's gathers
    and sums those of case B (mixtral) and case A (arctic), the fedavg
    local step's collectives within a pod and its sync one all-reduce."""
    import contextlib
    import io

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun, fedavg_dryrun
    mem0, counts0 = torch.cuda.memory_allocated(), dict(launches)
    out = {}
    for arch, shape, layers in DRYRUN_CELLS:
        flags = {"num_layers": layers} if layers else None
        variant = f"depth{layers}" if layers else "baseline"
        t0 = time.perf_counter()
        r = dryrun.run_cell(arch, shape, False, variant, flags)
        r["wall_s"] = time.perf_counter() - t0
        if r["status"] != "ok":
            fail(f"dry run {arch} {shape}: {r['status']}")
        cfg = get_config(arch)
        coll, groups = r["collectives"], r["collective_groups"]
        if cfg.moe is not None:
            B = SHAPES[shape].global_batch
            want = {"all-gather data moe": {
                        "count": (7 if cfg.moe.dense_residual else 4)
                        * layers, "bytes": moe_gather_bytes(cfg, 16, layers)},
                    "all-reduce model moe": {
                        "count": layers,
                        "bytes": layers * (B // 16) * cfg.d_model * 2.0}}
            got = {k: groups.get(k) for k in want}
            if got != want:
                fail(f"dry run {arch}: the MoE body's collectives {got} are "
                     f"not one place's ({want})")
        if arch == "qwen3-0.6b":
            sh = SHAPES[shape]
            glob = qwen3_train_flops(cfg, sh.global_batch, sh.seq_len)
            if r["cost"]["matmul_flops"] != glob / 256 or \
                    r["cost"]["matmul_flops"] * 256 != glob:
                fail(f"dry run qwen3: {r['cost']['matmul_flops']} matmul "
                     f"FLOPs a place, the closed form {glob} / 256")
            want = qwen3_train_collectives(cfg, sh.global_batch, sh.seq_len)
            got = qwen3_read_collectives(groups)
            if got != want:
                fail(f"dry run qwen3: FSDP / TP collectives {got}, the "
                     f"closed forms {want}")
            r["closed_forms"] = want
        out[f"{arch}/{shape}/{variant}"] = r
        print(f"dry run {arch} {shape} {variant} ({r['mesh']} meta "
              f"places), a place: {r['cost']['flops']:.4g} FLOPs "
              f"({r['cost']['matmul_flops']:.4g} in products), "
              f"{r['cost']['bytes_accessed']:.4g} bytes, "
              f"{r['cost']['transcendentals']:.4g} transcendentals, "
              f"{r['memory']['argument_size_in_bytes'] / 2**30:.3f} GiB of "
              f"arguments, peak {r['memory']['peak_memory_in_bytes'] / 2**30:.3f}"
              f" GiB, collectives {coll['total']['bytes'] / 2**30:.3f} GiB "
              f"in {coll['total']['count']} calls, {r['wall_s']:.2f} s",
              flush=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        fed = fedavg_dryrun.run("qwen3-0.6b")
    fed["wall_s"] = time.perf_counter() - t0
    sync, local = fed["sync_step"]["collectives"], fed["local_step"]
    if fed["status"] != "ok" or sync["all-reduce"]["count"] != 1 or \
            sync["total"]["count"] != 1 or local["pod_spanning"] != 0 or \
            local["collectives"]["all-gather"]["count"] == 0:
        fail(f"fedavg dry run: {fed}")
    out["fedavg/qwen3-0.6b"] = fed
    print(f"fedavg dry run qwen3-0.6b (2 x 16 x 16 meta places): model "
          f"{fed['model_bytes'] / 2**30:.3f} GiB bf16; a place's sync one "
          f"all-reduce over pod of {sync['all-reduce']['bytes'] / 2**20:.3f}"
          f" MiB; its local step {local['collectives']['total']['count']} "
          f"within-pod collectives, none spanning pod, "
          f"{fed['wall_s']:.2f} s", flush=True)
    if torch.cuda.memory_allocated() != mem0 or dict(launches) != counts0:
        fail("the dry runs allocated on the card or launched a kernel")
    total = sum(r["wall_s"] for r in out.values())
    print(f"dry runs: no card memory, no launch; {total:.1f} s ({card})",
          flush=True)
    return {"launches": {k: 0 for k in launches}, "cells": out,
            "wall_s": total}


def analysed_step(torch, cfg, dev, launches, reset_launches):
    """One train step (``launch.steps.make_train_step``, AdamW, fp32) of
    ``cfg`` at full width and depth over one 4096-token row on a one-place
    mesh: timed alone, then under ``launch.hlo_analysis.analyse`` on the
    card (its launches counted, its peak measured), then analysed over
    ``meta`` stand-ins of the same shapes."""
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.launch import inputs as I
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import api
    from repro_torch.parallel.sharding import make_axis_rules, use_rules
    from repro_torch.configs.base import ShapeConfig
    shape = ShapeConfig("row", ANALYSED_SEQ, 1, "train")
    reads = {}
    for where in ("card", "meta"):
        device = dev if where == "card" else torch.device("meta")
        mesh = make_debug_mesh(1, 1, devices=[device])
        rules = make_axis_rules(mesh)
        with use_rules(rules):
            opt = S.make_opt(cfg)
            if where == "card":
                params = api.init(cfg, 0, torch.float32, device=dev)
                state = opt.init(params)
                gen = torch.Generator(device=dev).manual_seed(5)
                toks = torch.randint(0, cfg.vocab_size, (1, ANALYSED_SEQ),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)
                batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
            else:
                params = S.abstract_params(cfg, torch.float32)
                state = S.abstract_opt_state(opt, params)
                batch = I.train_batch_specs(cfg, shape, torch.float32)
            p_specs = S.model_param_pspecs(cfg, params, rules)
            specs = (p_specs, S.opt_pspecs(state, params, p_specs, rules),
                     I.batch_pspecs(cfg, batch, rules))
            step = S.make_train_step(cfg, opt)
            args = (params, state, batch)
            if where == "card":
                step(*args)                       # warm (the kernels built)
                free_card(torch)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs = step(*args)
                torch.cuda.synchronize()
                reads["step_s"] = time.perf_counter() - t0
                del outs
                free_card(torch)
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
            r = H.analyse(step, args, specs,
                          lambda o: ((), specs[0], specs[1]), mesh.shape,
                          (0, 1))
            if where == "card":
                torch.cuda.synchronize()
                reads["launches"] = dict(launches)
                reads["measured_peak"] = (torch.cuda.max_memory_allocated()
                                          - base + H.memory_stats(r)[
                                              "argument_size_in_bytes"])
            reads[where] = {"cost": H.cost_stats(r),
                            "memory": H.memory_stats(r),
                            "kernels": r["kernels"]}
            del r, args, params, state, batch
        free_card(torch)
    return reads


def analysed_steps_path(torch, dev, launches, reset_launches, card):
    """Phase 5j (e): the step analysis over real steps on the card:
    qwen3-0.6b (the flash forward, its recompute and the backward pair)
    and mamba2-780m (the SSD scan, its recompute and its backward) at full
    width and depth, one 4096-token row, one place.  Held: FLOPs, bytes
    and transcendentals equal to the same step's over meta stand-ins, the
    analysed peak within ANALYSED_PEAK_BAND of the measured one, the
    launches exactly the step's; printed: the step's seconds beside its
    three roofline terms at the card's peaks."""
    from repro_torch.configs.mamba2_780m import CONFIG as mamba2
    from repro_torch.configs.qwen3_0_6b import CONFIG as qwen3
    out = {}
    for cfg, want in (
            (qwen3, {"flash_attention": 2 * qwen3.num_layers,
                     "flash_attention_bwd_dq": qwen3.num_layers,
                     "flash_attention_bwd_dkdv": qwen3.num_layers}),
            (mamba2, {"ssd_scan": 2 * mamba2.num_layers,
                      "ssd_scan_bwd": mamba2.num_layers})):
        reads = analysed_step(torch, cfg, dev, launches, reset_launches)
        got = {k: v for k, v in reads["launches"].items() if v}
        if got != want:
            fail(f"analysed step {cfg.name}: launches {got} != {want}")
        card_cost, meta_cost = reads["card"]["cost"], reads["meta"]["cost"]
        keys = ("flops", "bytes_accessed", "transcendentals")
        if any(card_cost[k] != meta_cost[k] for k in keys):
            fail(f"analysed step {cfg.name}: the card reads {card_cost}, "
                 f"meta {meta_cost}")
        peak = reads["card"]["memory"]["peak_memory_in_bytes"]
        ratio = peak / reads["measured_peak"]
        lo, hi = ANALYSED_PEAK_BAND
        if not lo <= ratio <= hi:
            fail(f"analysed step {cfg.name}: analysed peak {peak / 2**30:.3f}"
                 f" GiB is {ratio:.3f} of the measured "
                 f"{reads['measured_peak'] / 2**30:.3f} (band {lo}-{hi})")
        terms = {"compute_s": card_cost["flops"] / FP32_OPS_PER_S,
                 "memory_s": card_cost["bytes_accessed"] / HBM_BYTES_PER_S,
                 "collective_s": 0.0}
        print(f"analysed step {cfg.name} (one {ANALYSED_SEQ}-token row, "
              f"AdamW, fp32; {card}): {reads['step_s']:.3f} s measured; a "
              f"place's {card_cost['flops']:.6g} FLOPs "
              f"({card_cost['matmul_flops']:.6g} in products), "
              f"{card_cost['bytes_accessed']:.6g} bytes, "
              f"{card_cost['transcendentals']:.6g} transcendentals, equal "
              f"on meta; roofline terms at the card's peaks: compute "
              f"{terms['compute_s']:.4f} s (fp32 67 TFLOP/s), memory "
              f"{terms['memory_s']:.4f} s (3.35 TB/s), collectives 0 (one "
              f"place); peak analysed {peak / 2**30:.3f} GiB, measured "
              f"{reads['measured_peak'] / 2**30:.3f} ({ratio:.3f}); "
              f"launches {got}", flush=True)
        out[f"analysed-{cfg.name}"] = {
            "launches": reads["launches"], "step_s": reads["step_s"],
            "cost": card_cost, "memory": reads["card"]["memory"],
            "measured_peak": reads["measured_peak"], "peak_ratio": ratio,
            "roofline_terms": terms}
    return out


def fleet_simulation_launches(cfg, hists, fl_kw, K):
    """The fleet simulation's launches: ``fed_lm_launches`` of each
    engine's history."""
    from repro_torch.fl.loop import FLConfig
    from repro_torch.models.split_program import get_split_program
    native = get_split_program(cfg).native_op
    runs = [fed_lm_launches(cfg, hists[e], FLConfig(**fl_kw, engine=e),
                            native, K) for e in ("sequential", "batched")]
    return {k: runs[0][k] + runs[1][k] for k in runs[0]}


def fleet_simulation_path(torch, launches, reset_launches, card):
    """Phase 5j (d): ``launch.fleet_simulation`` on the card at the
    example's size, the engines' drift within FLEET_DRIFT_REL."""
    from repro_torch.configs.lm_small import LM16M
    from repro_torch.launch import fleet_simulation
    reset_launches()
    out = fleet_simulation.main(["--clients", str(FLEET_CLIENTS),
                                 "--rounds", str(FLEET_ROUNDS)])
    got = dict(launches)
    fl_kw = dict(rounds=FLEET_ROUNDS, local_iters=2, batch_size=2, lr=0.3,
                 mode="sfl", static_op=3, augment=False)
    want = fleet_simulation_launches(LM16M, out["hists"], fl_kw,
                                     FLEET_CLIENTS)
    if got != want:
        fail(f"fleet simulation: launches {got} != {want}")
    scale = max(abs(float(a)) for a in out["hists"]["sequential"]["accuracy"])
    if not out["drift"] <= FLEET_DRIFT_REL * scale:
        fail(f"fleet simulation: the engines drift {out['drift']:.3g} > "
             f"{FLEET_DRIFT_REL} x {scale:.3g}")
    rates = out["rounds_per_s"]
    print(f"fleet simulation (lm16m, K = {FLEET_CLIENTS}, {FLEET_ROUNDS} "
          f"rounds; {card}): sequential {rates['sequential']:.3f} rounds/s, "
          f"batched {rates['batched']:.3f}; drift {out['drift']:.3g} "
          f"(bound {FLEET_DRIFT_REL} x {scale:.3g}); launches {got}",
          flush=True)
    return {"launches": got, "rounds_per_s": rates, "drift": out["drift"]}


def launch_drivers_path(torch, dev, launches, reset_launches, card):
    """Phase 5j: the pod pair, the step builders, the dry runs on meta,
    the fleet simulation and the step analysis over real steps.  Returns
    the records by path."""
    out = {}
    out["pods-qwen3-0.6b"], params = pod_pair_path(
        torch, dev, launches, reset_launches, card)
    out["steps-qwen3-0.6b"] = step_builders_path(torch, dev, params,
                                                 launches, reset_launches)
    del params
    free_card(torch)
    out["dryrun-meta"] = dry_runs_path(torch, launches, card)
    out["fleet-simulation"] = fleet_simulation_path(torch, launches,
                                                    reset_launches, card)
    out.update(analysed_steps_path(torch, dev, launches, reset_launches,
                                   card))
    return out

def np_equal(a, b) -> bool:
    import numpy as np
    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


def small_lm_cpu_vs_card(torch, dev, arch):
    """Phase 6, language models: ``arch``'s smoke config on the CPU (the
    plain kernels) and on the card (the kernels), same weights: for each
    prompt the prefill and 6 decode steps, tokens equal and logits within
    1e-4.  The VLM gets seeded patch embeddings and encdec seeded frame
    embeddings; an MoE config keeps its capacity factor, so tokens are
    dropped, and the card must drop the (token, choice) pairs the CPU
    drops."""
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import api
    from repro_torch.models import layers as L
    cfg = get_smoke_config(arch)
    kernel = "ssd_scan" if cfg.family == "ssm" else "flash_attention"
    host = api.init(cfg, seed=0, device="cpu")
    card = convert.lm_params_from_numpy(convert.lm_params_to_numpy(host),
                                        dev)
    gen = torch.Generator().manual_seed(5)
    diff, steps, before = 0.0, 0, LAUNCHES[kernel]
    keeps = {"cpu": [], "card": []}
    dispatch = L.moe_dispatch

    def recorded(name):
        def run(cfg_, topi):
            C, slot, keep = dispatch(cfg_, topi)
            keeps[name].append(keep.cpu())
            return C, slot, keep
        return run
    try:
        for S in (3, 16, 37, 50):
            prompt = torch.randint(0, cfg.vocab_size, (2, S), generator=gen)
            batch = {"tokens": prompt}
            if cfg.family == "vlm":
                batch["patches"] = 0.1 * torch.randn(
                    (2, cfg.num_patches, cfg.d_model), generator=gen)
            if cfg.family == "encdec":
                batch["frames"] = 0.1 * torch.randn(
                    (2, cfg.encoder_seq, cfg.d_model), generator=gen)
            P = cfg.num_patches if cfg.family == "vlm" else 0
            runs = {}
            for name, params, d in (("cpu", host, "cpu"),
                                    ("card", card, dev)):
                L.moe_dispatch = recorded(name)
                logits, cache = api.prefill(
                    cfg, params, {k: v.to(d) for k, v in batch.items()},
                    target_seq=P + S + 6)
                seen = [logits.cpu()]
                for i in range(6):
                    token = torch.argmax(seen[-1], -1)[:, None]
                    logits, cache = api.decode(cfg, params, cache,
                                               token.to(d), P + S + i)
                    seen.append(logits.cpu())
                runs[name] = seen
            for a, b in zip(runs["cpu"], runs["card"]):
                if not torch.equal(torch.argmax(a, -1), torch.argmax(b, -1)):
                    fail(f"small {arch} prompt {S}: tokens differ cpu vs "
                         f"card")
                diff = max(diff, float((a - b).abs().max()))
                steps += 1
    finally:
        L.moe_dispatch = dispatch
    n = LAUNCHES[kernel] - before
    if diff > SMALL_SERVE_ATOL or n != 4 * prefill_launches(cfg):
        fail(f"small {arch}: logits differ by {diff} (> "
             f"{SMALL_SERVE_ATOL}?) or {n} card {kernel} launches (needs "
             f"{4 * prefill_launches(cfg)})")
    dropped = sum(int((~k).sum()) for k in keeps["cpu"])
    if cfg.moe is not None:
        same = len(keeps["cpu"]) == len(keeps["card"]) and all(
            torch.equal(a, b) for a, b in zip(keeps["cpu"], keeps["card"]))
        if not same or not dropped:
            fail(f"small {arch}: {dropped} assignments dropped on the CPU; "
                 f"the card's drops equal them: {same}")
    print(f"small {arch} smoke: cpu == card tokens over {steps} steps, max "
          f"logit diff {diff:.3g} <= {SMALL_SERVE_ATOL}; {n} {kernel} "
          f"launches on the card"
          + (f"; the same {dropped} assignments dropped on both"
             if cfg.moe is not None else ""), flush=True)
    return {"steps": steps, "max_logit_diff": diff,
            "atol": SMALL_SERVE_ATOL, "card_launches": n,
            "dropped": dropped}


def small_lm_training_cpu_vs_card(torch, dev, arch):
    """Phase 6, LM training: ``arch``'s smoke config's loss and gradient
    (``api.loss``; gemma2's softcap, qwen3's qk-norm, mixtral's MoE at its
    capacity factor 1.25, internvl2's patches, recurrentgemma's groups,
    whisper's frames) on the CPU and on the card from the same weights and
    batch, within TRAIN_LOSS_REL and TRAIN_GRAD_REL."""
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import api
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_smoke_config(arch)
    host = api.init(cfg, seed=0, device="cpu")
    card = convert.lm_params_from_numpy(convert.lm_params_to_numpy(host),
                                        dev)
    gen = torch.Generator().manual_seed(9)
    S = 96 - cfg.num_patches if cfg.family == "vlm" else 96
    toks = torch.randint(0, cfg.vocab_size, (2, S + 1), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn((2, cfg.num_patches, cfg.d_model),
                                       generator=gen)
    if cfg.family == "encdec":
        batch["frames"] = 0.1 * torch.randn((2, cfg.encoder_seq,
                                             cfg.d_model), generator=gen)

    def grads(params, b):
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = api.loss(cfg, live, b)
        return loss.detach(), list(torch.autograd.grad(
            loss, tree_leaves(live)))

    on_card = grads(card, {k: v.to(dev) for k, v in batch.items()})
    return compare_training(torch, f"{arch} smoke loss and gradient",
                            on_card, grads(host, batch))


def lm16m_driver_cpu_vs_card(torch, dev):
    """Phase 6, the LM driver: ``lm16m`` for 2 rounds (3 clients, 2 local
    steps of 2 x 64 tokens, the int8 cut) on the card and on the CPU from
    the same initial params and agent noise (the agent's own seeded
    generator on both): OPs and modelled times exactly, each round's loss
    within TRAIN_LOSS_REL."""
    from repro_torch.configs.lm_small import LM16M
    from repro_torch.launch import train as driver
    from repro_torch.models.split_program import get_split_program
    argv = ["--rounds", "2", "--local-steps", "2", "--batch", "2", "--seq",
            "64", "--clients", "3", "--quantize-transfer"]
    args = driver.parser().parse_args(argv)
    init = get_split_program(LM16M).init(0, "cpu")
    runs = {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        runs[name] = driver.train(LM16M, args, device=device,
                                  init_params=init,
                                  log=lambda line: None)["history"]
    a, b = runs["card"], runs["cpu"]
    if a["ops"] != b["ops"] or a["dropped"] != b["dropped"] or any(
            not np_equal(x, y) for x, y in zip(a["times"], b["times"])):
        fail(f"lm16m driver: card OPs {a['ops']} times {a['times']} vs CPU "
             f"{b['ops']} {b['times']}")
    rel = max(abs(x - y) / abs(y) for x, y in zip(a["loss"], b["loss"]))
    if not rel <= TRAIN_LOSS_REL:
        fail(f"lm16m driver: losses {a['loss']} (card) vs {b['loss']} (CPU)")
    print(f"lm16m driver, 2 rounds: OPs {a['ops']} and modelled times equal "
          f"on the card and the CPU; losses {a['loss']} vs {b['loss']}, "
          f"{rel:.3g} relative (<= {TRAIN_LOSS_REL})", flush=True)
    return {"ops": a["ops"], "loss_card": a["loss"], "loss_cpu": b["loss"],
            "loss_rel": rel}


def silu_drill(torch, dev):
    """Phase 6: the port's ``silu`` (``layers.silu``) on the card over a
    seeded SILU_DRILL_SHAPE fp32 input: ``torch.func.grad`` (the step of
    ``launch.steps``) and ``vmap`` of it over the rows (the batched
    engine's) give ``torch.autograd.grad``'s bits (the sequential
    engine's), 0 lanes apart.  ``F.silu``'s lanes apart under the same
    transforms are printed beside: the split the Function removes."""
    import torch.nn.functional as F
    from repro_torch.models import layers as L
    gen = torch.Generator(device=dev).manual_seed(0)
    x = 4 * torch.randn(SILU_DRILL_SHAPE, generator=gen, device=dev)

    def apart(fn):
        xa = x.clone().requires_grad_()
        want, = torch.autograd.grad(fn(xa).sum(), xa)

        def loss(t):
            return fn(t).sum()
        got = (torch.func.grad(loss)(x),
               torch.func.vmap(torch.func.grad(loss))(x))
        return {k: int((g != want).sum())
                for k, g in zip(("grad", "vmap_grad"), got)}
    port, plain = apart(L.silu), apart(F.silu)
    print(f"silu drill {SILU_DRILL_SHAPE} on {dev}: layers.silu's "
          f"torch.func.grad / vmap(grad) lanes apart from "
          f"torch.autograd.grad {port} (F.silu's {plain})", flush=True)
    if any(port.values()):
        fail(f"silu drill: layers.silu's gradient under torch.func is "
             f"{port} lanes apart from torch.autograd.grad's")
    return {"shape": list(SILU_DRILL_SHAPE), "lanes_apart": port,
            "f_silu_lanes_apart": plain}


def small_federated_lm_cpu_vs_card(torch, dev):
    """Phase 6, federated LM training: ``run_federated`` on the CPU and on
    the card from the same initial params: lm16m in sfl at OP 3 with the
    int8 cut, top-k 0.5 and int8 deltas through each engine (OPs, modelled
    round and comm times, drops and ``edge_time`` exact; the -CE metric
    and the final params within FED_DISCRETE_METRIC_REL, FED_TREE_SHARE
    and FED_DISCRETE_PARAMS_REL), lm16m plain through the sequential engine
    and mamba2's smoke config plain through the batched engine (the same
    exact keys; the metric within TRAIN_LOSS_REL, every param leaf within
    TRAIN_GRAD_REL of its max).  Then the MoE family on the batched engine
    (mixtral-8x22b's and arctic-480b's smoke configs at OP 1 and their
    capacity factor 1.25): plain, the metric and every lane within
    FED_MOE_PLAIN_REL, and each eval pass (outside ``vmap``) dropping on
    the card the (token, choice) pairs it drops on the CPU; each with the
    int8 cut, top-k 0.5 and int8 deltas, within the discrete-step
    bounds."""
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.lm_small import LM16M
    from repro_torch.data import split_clients, token_dataset
    from repro_torch.fl.loop import FLConfig, run_federated
    from repro_torch.models import layers as L
    from repro_torch.models.split_program import get_split_program
    from repro_torch.tree import tree_leaves
    discrete = dict(quantize_transfer=True, delta_density=0.5,
                    quantize_deltas=True)
    mixtral = get_smoke_config("mixtral-8x22b")
    arctic = get_smoke_config("arctic-480b")
    runs = {"lm16m-sequential-int8-topk": (LM16M, "sequential", 3, discrete),
            "lm16m-batched-int8-topk": (LM16M, "batched", 3, discrete),
            "lm16m-sequential": (LM16M, "sequential", 3, {}),
            "mamba2-smoke-batched": (get_smoke_config("mamba2-780m"),
                                     "batched", 1, {}),
            "mixtral-smoke-batched": (mixtral, "batched", 1, {}),
            "mixtral-smoke-batched-int8-topk": (mixtral, "batched", 1,
                                                discrete),
            "arctic-smoke-batched": (arctic, "batched", 1, {}),
            "arctic-smoke-batched-int8-topk": (arctic, "batched", 1,
                                               discrete)}
    dispatch = L.moe_dispatch
    keeps = []

    def recorded(cfg_, topi):
        C, slot, keep = dispatch(cfg_, topi)
        if not torch._C._are_functorch_transforms_active():
            keeps.append(keep.cpu())
        return C, slot, keep
    out = {}
    for name, (cfg, engine, op, kw) in runs.items():
        clients = split_clients(token_dataset(16, 32, cfg.vocab_size,
                                              seed=0), 2)
        test = token_dataset(4, 32, cfg.vocab_size, seed=9)
        init = get_split_program(cfg).init(0, "cpu")
        fl = FLConfig(rounds=2, local_iters=2, batch_size=2, lr=0.1,
                      augment=False, mode="sfl", static_op=op,
                      engine=engine, **kw)
        by_device = {}
        for d in ("cpu", dev):
            keeps.clear()
            L.moe_dispatch = recorded
            try:
                h = run_federated(cfg, clients, test, fl, init_params=init,
                                  device=d)
            finally:
                L.moe_dispatch = dispatch
            by_device[str(d)] = (h, list(keeps))
        (a, keep_a), (b, keep_b) = by_device["cpu"], by_device[str(dev)]
        dropped = sum(int((~k).sum()) for k in keep_a)
        if cfg.moe is not None and not kw:
            same = len(keep_a) == len(keep_b) and all(
                torch.equal(x, y) for x, y in zip(keep_a, keep_b))
            if not same or not dropped:
                fail(f"small {name}: {dropped} assignments dropped in the "
                     f"CPU's eval passes; the card's drops equal them: "
                     f"{same}")
        for key in ("ops", "times", "round_time", "comm_time", "dropped",
                    "edge_time"):
            if not np_equal(a[key], b[key]):
                fail(f"small {name}: {key} cpu {a[key]} vs card {b[key]}")
        metric = float(np.max(np.abs(b["accuracy"] - a["accuracy"])
                              / np.abs(a["accuracy"])))
        errs = [(x.cpu() - y).abs().reshape(-1)
                / max(float(y.abs().max()), 1e-3)
                for x, y in zip(tree_leaves(b["params"]),
                                tree_leaves(a["params"]))]
        gap = max(float(e.max()) for e in errs)
        share = (sum(int((e > FED_LANE_REL).sum()) for e in errs)
                 / sum(e.numel() for e in errs))
        m_tol, p_tol, s_tol = ((FED_DISCRETE_METRIC_REL,
                                FED_DISCRETE_PARAMS_REL, FED_TREE_SHARE)
                               if kw else (TRAIN_LOSS_REL, TRAIN_GRAD_REL,
                                           0.0))
        if cfg.moe is not None and not kw:
            m_tol = p_tol = FED_MOE_PLAIN_REL
        if not (metric <= m_tol and gap <= p_tol and share <= s_tol):
            fail(f"small {name}: metric {metric:.3g} relative (<= {m_tol}?), "
                 f"params {gap:.3g} of a leaf's max (<= {p_tol}?), "
                 f"{share:.3g} of the lanes beyond {FED_LANE_REL} "
                 f"(<= {s_tol}?)")
        out[name] = {"metric_rel": metric, "params_rel": gap,
                     "lane_share": share, "bounds": [m_tol, p_tol, s_tol],
                     "ops": b["ops"].tolist()}
        if cfg.moe is not None:
            out[name]["eval_assignments_dropped"] = dropped
        print(f"small {name}: cpu == card (ops, times, comm, drops), metric "
              f"{metric:.3g} relative (<= {m_tol}), params {gap:.3g} of a "
              f"leaf's max (<= {p_tol}), {share:.3g} of the lanes beyond "
              f"{FED_LANE_REL} (<= {s_tol})"
              + (f"; the same {dropped} MoE assignments dropped in the eval "
                 f"passes on both" if cfg.moe is not None and not kw
                 else ""), flush=True)
    return out


def work_io(w):
    """A kernel's written count as ``_timing_row``'s (bytes, operations):
    every FLOP at the fp32 rate (the int8 pair, top-k)."""
    return w["bytes_accessed"], w["flops"]


def tensor_core_row(row, w):
    """A 3xTF32 kernel's row bounded by its written count (``w``): the
    larger of the bytes over the memory rate, the products three times
    over the TF32 tensor-core rate and the rest of its FLOPs and its
    transcendentals over the fp32 rate; ``bound_fp32_ms`` every operation
    at the fp32 rate."""
    prod = w["matmul_flops"]
    elem = w["flops"] - prod + w["transcendentals"]
    b_ms, b_by = bound_ms(w["bytes_accessed"], 3 * prod, TF32_OPS_PER_S)
    elem_ms = elem / FP32_OPS_PER_S * 1e3
    if elem_ms > b_ms:
        b_ms, b_by = elem_ms, "operations"
    row.update({"bound_ms": b_ms, "bound_by": b_by,
                "bound_fp32_ms": bound_ms(w["bytes_accessed"],
                                          prod + elem)[0],
                "gflop": prod / 1e9, "elementwise_gflop": elem / 1e9,
                "mbytes": w["bytes_accessed"] / 1e6})
    return row


def time_ssd_bwd(torch, ts, real):
    """Phase 7, the SSD scan's backward at mamba2-780m's layer 0 of a real
    4096-token training step (B=1, S=4096, H=48, P=64, N=128, Q=128; x,
    B and C the model's views of its projection, y's real gradient scaled
    to a max of 1).  No PyTorch call computes the SSD scan's gradient.
    Bounds from its written count (``ssd_scan_bwd_work``, the gradient's
    two products a forward one), ``tensor_core_row``."""
    x, dt, A, Bm, Cm, dy = real
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    w = ts.ssd_scan_bwd_work(x.shape, Bm.shape, None, 128)
    row = tensor_core_row(_timing_row(
        "ssd_scan_bwd", [B, S, H, P, N, 128],
        lambda: ts.ssd_scan_bwd(x, dt, A, Bm, Cm, 128, None, dy),
        lambda: ts.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, 128, None, dy),
        None, 0, 0, reps=7, inner=5), w)
    print(f"ssd_scan_bwd at mamba2-780m's layer 0: {row['gflop']:.2f} "
          f"GFLOP of products, {row['elementwise_gflop']:.3f} G "
          f"elementwise, {row['mbytes']:.1f} MB")
    return [row]


def time_ssd(torch, ts, real):
    """Phase 7, the SSD scan at mamba2-780m's prefill shape (B=1, S=4096,
    H=48, P=64, N=128, Q=128) on layer 0's inputs.  No PyTorch call
    computes the SSD scan.  Bounds from its written count
    (``ssd_scan_work``), ``tensor_core_row``."""
    x, dt, A, Bm, Cm = real
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    return [tensor_core_row(_timing_row(
        "ssd_scan", [B, S, H, P, N, 128],
        lambda: ts.ssd_scan(x, dt, A, Bm, Cm, 128),
        lambda: ts.ssd_scan_plain(x, dt, A, Bm, Cm, 128), None, 0, 0,
        reps=7, inner=5), ts.ssd_scan_work(x.shape, Bm.shape, None, 128))]


# phase 7's flash rows: the real layer's q, k, v (``real[kind]``), its
# model, the softcap and causality timed on them, and whether the rows'
# log-sum-exp is written too (training's forward)
FLASH_TIMED = [("global", "gemma2-2b", 50.0, True, False),
               ("local", "gemma2-2b", 50.0, True, False),
               ("global", "gemma2-2b", 0.0, True, False),
               ("mixtral", "mixtral-8x22b", 0.0, True, False),
               ("recurrentgemma", "recurrentgemma-9b", 0.0, True, False),
               ("whisper", "whisper-base", 0.0, False, False),
               ("qwen3-train", "qwen3-0.6b", 0.0, True, True)]


def time_flash(torch, tf, real):
    """Phase 7, flash attention on real layers' q, k, v (``FLASH_TIMED``):
    gemma2-2b's two prefill shapes (S=4608, H=8, KV=4, D=256, causal,
    softcap 50, global and local window 4096) and the global one without
    the softcap; mixtral-8x22b's layer 0 (S=4096, H=48, KV=8, D=128, window
    4096, which does not bind at S=4096); recurrentgemma-9b's first local
    layer (S=4096, 16 query heads over one KV head of 256, window 2048,
    which binds); whisper-base's first encoder layer (S=1500, H=KV=8,
    D=64, no causality); qwen3-0.6b's layer 0 of a 4096-token training
    step (H=16, KV=8, D=128, causal) with the rows' log-sum-exp written, as
    training's forward writes it (``flash_attention_lse`` beside
    ``attention_plain_lse``; the lse's bytes counted).  The yardstick is
    one PyTorch call computing the
    same function: compiled ``flex_attention`` (``flex_attention_call``)
    where a softcap or a binding window needs it, else
    ``scaled_dot_product_attention`` (causal or not; k and v repeated to H
    heads outside the timed call).  Each yardstick's max abs difference
    from the kernel is kept as ``library_err``.  The bounds come from the
    kernel's written count (``flash_attention_work``: 4 * D * H
    operations a (q, k) pair the mask leaves visible; each input and
    output byte once), ``tensor_core_row`` (three TF32 products per
    operation pair at 495 TFLOP/s: one TF32 product breaks the 1e-5
    tolerance)."""
    F = torch.nn.functional
    rows = []
    for kind, model, cap, causal, lse in FLASH_TIMED:
        q, k, v, window, _ = real[kind]
        B, S, H, D = q.shape
        Sk, KV = k.shape[1], k.shape[2]
        pairs = int(tf.visible_mask(S, Sk, causal, window, q.device).sum())
        counted_pairs = tf.visible_pairs(S, Sk, bool(causal), int(window))
        if pairs != counted_pairs:
            fail(f"flash timing {kind}: visible_pairs {counted_pairs} != "
                 f"the mask's {pairs}")
        kern, plain = ((tf.flash_attention_lse, tf.attention_plain_lse)
                       if lse else (tf.flash_attention, tf.attention_plain))
        args = (q, k, v, causal, window, cap)
        mine = kern(*args)[0] if lse else kern(*args)
        if cap > 0.0 or 0 < window < Sk:
            if not causal:
                fail(f"flash timing {kind}: flex_attention_call is causal")
            library = flex_attention_call(torch, q, k, v, window, cap)
            what = "flex_attention"
        else:
            qh = q.transpose(1, 2)
            kh = k.transpose(1, 2).repeat_interleave(H // KV, dim=1)
            vh = v.transpose(1, 2).repeat_interleave(H // KV, dim=1)

            def library():
                return F.scaled_dot_product_attention(qh, kh, vh,
                                                      is_causal=causal)
            what = "scaled_dot_product_attention"
        library_err = float((library().transpose(1, 2) - mine).abs().max())
        print(f"flash vs {what} ({model}, window {window}, softcap {cap}, "
              f"causal {causal}): max abs diff {library_err:.3g}")
        row = tensor_core_row(_timing_row(
            "flash_attention", [B, S, H, KV, D], lambda: kern(*args),
            lambda: plain(*args), library, 0, 0, reps=7, inner=5),
            tf.flash_attention_work(q.shape, k.shape, causal, window, 4, lse,
                                    cap))
        row.update({"model": model, "window": window, "softcap": cap,
                    "causal": causal, "lse": lse, "pairs": pairs,
                    "library": what, "library_err": library_err})
        rows.append(row)
    return rows


def time_flash_bwd(torch, tf, real):
    """Phase 7, the flash backward on real layers: qwen3-0.6b's layer 0
    (``real["qwen3"]``: q, k, v and dO of a 4096-token training step; 16
    query heads over 8 KV heads of 128, causal) and gemma2-2b's global
    layer (S=4608, D=256, softcap 50; a seeded dO).  Rows for each kernel
    and for the whole backward, bounded by the kernels' written counts
    (``flash_attention_bwd_dq_work``: dP and dQ; ``..._dkdv_work``: dV and
    dK; 4 * D * H operations a visible pair each, the four products of
    the differentiated attention), ``tensor_core_row``.  Each row
    also carries what its kernels compute, ``computed_gflop`` (dq 3
    products, dk/dv 4, the pair 7 over the visible pairs: both kernels
    recompute S and dP, 240.6 GFLOP at qwen3's shape), and
    ``computed_bound_ms``, its 3xTF32 bound.
    Two calls of the pair on each layer must give bitwise-equal dq, dk and
    dv (no atomics), or the run fails.  Each row's
    plain version computes that row's part, timed in a CUDA graph:
    ``attention_bwd_dq_plain`` (dq and delta), ``attention_bwd_dkdv_plain``
    (dk, dv) and ``attention_bwd_plain`` (all three).  The yardstick, never
    called by the port, computes the whole backward only, so only the
    whole row has one: the backward of ``scaled_dot_product_attention`` (k
    and v repeated to H heads; no softcap) or of compiled
    ``flex_attention`` (the softcap), timed eagerly as one forward and
    backward less one forward, each gradient's max abs difference from the
    kernels' kept as ``library_err``; the kernels' rows carry
    ``library_ms`` None."""
    F = torch.nn.functional
    gen = torch.Generator().manual_seed(11)
    rows = []
    q, k, v, window, cap = real["global"]
    cases = [("qwen3-0.6b", real["qwen3"][:3], 0, 0.0, real["qwen3"][3]),
             ("gemma2-2b", (q, k, v), window, cap,
              torch.randn(q.shape, generator=gen).to(q.device))]
    for model, (q, k, v), window, cap, do in cases:
        B, S, H, D = q.shape
        Sk, KV = k.shape[1], k.shape[2]
        pairs = int(tf.visible_mask(S, Sk, True, window, q.device).sum())
        o, lse = tf.flash_attention_lse(q, k, v, True, window, cap)
        mine = tf.flash_attention_bwd(q, k, v, o, lse, do, True, window, cap)
        again = tf.flash_attention_bwd(q, k, v, o, lse, do, True, window,
                                       cap)
        if not all(torch.equal(a, b) for a, b in zip(mine, again)):
            fail(f"flash backward ({model}): two calls on the same inputs "
                 f"differ (dq, dk, dv must be bitwise repeatable)")
        print(f"flash backward ({model}): two calls give bitwise-equal dq, "
              f"dk, dv")
        del again
        _, delta = tf.flash_attention_bwd_dq(q, k, v, o, lse, do, True,
                                             window, cap)
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        if cap > 0.0:
            fwd = flex_attention_call(torch, qq, kk, vv, window, cap)
            what = "flex_attention backward"

            def lib_grads():
                out = fwd().transpose(1, 2)
                return torch.autograd.grad(out, (qq, kk, vv), do)
        else:
            what = "scaled_dot_product_attention backward"

            def fwd():
                return F.scaled_dot_product_attention(
                    qq.transpose(1, 2),
                    kk.transpose(1, 2).repeat_interleave(H // KV, dim=1),
                    vv.transpose(1, 2).repeat_interleave(H // KV, dim=1),
                    is_causal=True)

            def lib_grads():
                return torch.autograd.grad(fwd().transpose(1, 2),
                                           (qq, kk, vv), do)
        library_err = max(float((a - b).abs().max())
                          for a, b in zip(lib_grads(), mine))
        kw = dict(reps=5, inner=3)
        lib_ms = (time_ms(lib_grads, graph=False, **kw)
                  - time_ms(fwd, graph=False, **kw))
        args = (True, window, cap)
        w_dq = tf.flash_attention_bwd_dq_work(q.shape, k.shape, True, window,
                                              cap)
        w_dkdv = tf.flash_attention_bwd_dkdv_work(q.shape, k.shape, True,
                                                  window, cap)
        w_both = {key: w_dq[key] + w_dkdv[key] for key in w_dq}
        for name, fn, plain, w, computed, computes in [
                ("flash_attention_bwd_dq",
                 lambda: tf.flash_attention_bwd_dq(q, k, v, o, lse, do,
                                                   *args),
                 lambda: tf.attention_bwd_dq_plain(q, k, v, o, lse, do,
                                                   *args), w_dq, 3,
                 "dq, delta"),
                ("flash_attention_bwd_dkdv",
                 lambda: tf.flash_attention_bwd_dkdv(q, k, v, lse, delta, do,
                                                     *args),
                 lambda: tf.attention_bwd_dkdv_plain(q, k, v, lse, delta, do,
                                                     *args), w_dkdv, 4,
                 "dk, dv"),
                ("flash_attention_bwd",
                 lambda: tf.flash_attention_bwd(q, k, v, o, lse, do, *args),
                 lambda: tf.attention_bwd_plain(q, k, v, o, lse, do, *args),
                 w_both, 7, "dq, dk, dv")]:
            done = 2 * computed * D * H * pairs
            whole = name == "flash_attention_bwd"
            row = tensor_core_row({
                "name": name, "shape": [B, S, H, KV, D],
                "ms": time_ms(fn, **kw),
                "call_ms": time_ms(fn, graph=False, **kw),
                "plain_ms": time_ms(plain, **kw),
                "library_ms": lib_ms if whole else None,
                "library": what if whole else None,
                "library_err": library_err, "model": model,
                "window": window, "softcap": cap, "causal": True,
                "pairs": pairs, "computes": computes,
                "computed_gflop": done / 1e9,
                "computed_bound_ms": bound_ms(w["bytes_accessed"], 3 * done,
                                              TF32_OPS_PER_S)[0],
                "bitwise_repeat": True}, w)
            rows.append(row)
        print(f"flash backward vs {what} ({model}): max abs grad diff "
              f"{library_err:.3g}")
    return rows


def flex_attention_call(torch, q, k, v, window, cap):
    """One PyTorch call computing the flash kernel's causal function:
    ``flex_attention`` (compiled by inductor, as its documentation asks)
    with the causal and window mask as a block mask (blocks no row sees are
    skipped), gemma2's softcap ``cap * tanh(s / cap)`` on the scaled scores
    as its ``score_mod`` where ``cap > 0``, GQA by ``enable_gqa`` and the
    kernel's scale 1 / sqrt(D), on (B, H, S, D) views of q, k, v.  With
    TF32 off its products are full fp32.  The block mask is built outside
    the timed call.  Returns the call; its output is (B, H, S, D)."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    S, Sk, D = q.shape[1], k.shape[1], q.shape[3]

    def visible(b, h, qi, ki):
        if window > 0:
            return (ki <= qi) & (ki > qi - window)
        return ki <= qi

    def softcap(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    mask = create_block_mask(visible, None, None, S, Sk, device=q.device)
    flex = torch.compile(flex_attention, dynamic=False)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    scale = 1.0 / math.sqrt(D)
    score_mod = softcap if cap > 0 else None
    return lambda: flex(qh, kh, vh, score_mod=score_mod, block_mask=mask,
                        scale=scale, enable_gqa=True)


def _timing_row(name, shape, fn, plain, library, nbytes, ops, reps=15,
                inner=20, ops_per_s=FP32_OPS_PER_S):
    b_ms, b_by = bound_ms(nbytes, ops, ops_per_s)
    kw = dict(reps=reps, inner=inner)
    return {"name": name, "shape": shape, "ms": time_ms(fn, **kw),
            "call_ms": time_ms(fn, graph=False, **kw),
            "plain_ms": time_ms(plain, **kw), "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None if library is None else time_ms(library, **kw)}


def lm_row_timings(torch, tq, tt, dev, gen, n):
    """Phase 7's rows at one LM flat row (phase 5g: qwen3-0.6b's ``n``
    lanes): top-k at density 0.1 over ``(1, n)`` and the int8 pair over
    its ``(n / 1024, 1024)`` rows, each beside its byte bound, its plain
    version and ``torch.topk`` / ``torch.mul``.  Fewer repetitions than
    the small rows: the plain top-k sorts the whole row."""
    nb = n // 1024
    meta = torch.from_numpy(tt.density_block_meta(n, 1024, 0.1)).to(
        torch.int32).to(dev)
    buf = torch.randn((1, n), generator=gen).to(dev)
    kmax = int(meta[:, 1].max())
    mag = buf.view(nb, 1024).abs()
    rows = [_timing_row(
        "topk_compress", [1, n], lambda: tt.topk_compress_flat(buf, meta),
        lambda: tt.topk_blocks_plain(buf.view(nb, 1024), meta),
        lambda: torch.topk(mag, kmax, dim=1),
        *work_io(tt.topk_compress_work((1, n))), reps=3, inner=2)]
    del mag
    x = buf.view(nb, 1024)
    q, s = tq.quantize_rows(x)
    for name, fn, plain, library, w in [
            ("quantize", lambda: tq.quantize_rows(x),
             lambda: tq.quantize_rows_plain(x), None,
             tq.quantize_work((nb, 1024))),
            ("dequantize", lambda: tq.dequantize_rows(q, s),
             lambda: tq.dequantize_rows_plain(q, s),
             lambda: torch.mul(q, s[:, None]),
             tq.dequantize_work((nb, 1024)))]:
        rows.append(_timing_row(name, [nb, 1024], fn, plain, library,
                                *work_io(w), reps=5, inner=4))
    return rows


def time_kernels(torch, tq, tt, dev, launches, worst, worst_rel,
                 serving_rows, lm_lanes):
    """Phase 7: each kernel's time beside its bound, its plain version and
    a library call where one computes the same function: ``torch.mul`` of
    the int8 codes by the scales (one kernel that promotes to fp32) for
    dequantize, ``torch.topk`` over the blocks' magnitudes for top-k,
    compiled ``flex_attention`` for flash attention with the softcap and
    ``scaled_dot_product_attention`` without it (``time_flash``).  No
    single PyTorch call computes the rowwise absmax int8 quantizer.
    ``worst_rel``: the SSD backward's worst error over its bound's scale
    (phases 3 and 5f).  ``lm_lanes``: phase 5g's qwen3-0.6b flat-buffer
    length, where top-k and the int8 pair run once per client row."""
    from repro_torch.configs.vgg import VGG5
    from repro_torch.fl.flatbuf import FlatLayout
    from repro_torch.models.vgg import init
    gen = torch.Generator().manual_seed(1)
    rows = []
    # quantize / dequantize at the cut (B=100: OP1, 150 calls per run, and
    # OP2), on the delta wire (one VGG-5 client row) and at the batched
    # engine's stacked cut (5 clients at OP1)
    for R, C in [(25600, 32), (6400, 64), (580, 1024), (STACKED_CUT, 32)]:
        x = torch.randn((R, C), generator=gen).to(dev)
        q, s = tq.quantize_rows(x)
        n = R * C
        for name, fn, plain, library, w in [
                ("quantize", lambda: tq.quantize_rows(x),
                 lambda: tq.quantize_rows_plain(x), None,
                 tq.quantize_work((R, C))),
                ("dequantize", lambda: tq.dequantize_rows(q, s),
                 lambda: tq.dequantize_rows_plain(q, s),
                 lambda: torch.mul(q, s[:, None]),
                 tq.dequantize_work((R, C)))]:
            rows.append(_timing_row(name, [R, C], fn, plain, library,
                                    w["bytes_accessed"], w["flops"]))
    # top-k over one VGG-5 client row at the main path's density 0.1
    layout = FlatLayout(init(VGG5, gen))
    meta = torch.from_numpy(layout.block_meta(0.1)).to(torch.int32).to(dev)
    buf = torch.randn((1, layout.padded), generator=gen).to(dev)
    nb = meta.shape[0]
    kmax = int(meta[:, 1].max())
    lane = torch.arange(1024, device=dev)[None]
    mag = torch.where(lane < meta[:, :1], buf.view(nb, 1024).abs(),
                      torch.tensor(float("-inf"), device=dev))
    n = layout.padded
    rows.append(_timing_row(
        "topk_compress", [1, n], lambda: tt.topk_compress_flat(buf, meta),
        lambda: tt.topk_blocks_plain(buf.view(nb, 1024), meta),
        lambda: torch.topk(mag, kmax, dim=1),
        *work_io(tt.topk_compress_work((1, n)))))
    # top-k over VGG-5's largest leaf (the FC128 weight, 4096 x 128), one
    # of the reference server step's per-leaf calls
    n = 4096 * 128
    leaf_meta = torch.from_numpy(tt.density_block_meta(n, 1024, 0.1)).to(
        torch.int32).to(dev)
    leaf = torch.randn((1, n), generator=gen).to(dev)
    nb = n // 1024
    leaf_mag, leaf_k = leaf.view(nb, 1024).abs(), int(leaf_meta[:, 1].max())
    rows.append(_timing_row(
        "topk_compress", [1, n], lambda: tt.topk_compress_flat(leaf,
                                                               leaf_meta),
        lambda: tt.topk_blocks_plain(leaf.view(nb, 1024), leaf_meta),
        lambda: torch.topk(leaf_mag, leaf_k, dim=1),
        *work_io(tt.topk_compress_work((1, n)))))
    rows += lm_row_timings(torch, tq, tt, dev, gen, lm_lanes)
    rows += serving_rows
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        extra = (f" {r['model']} window {r['window']} softcap "
                 f"{r['softcap']}" if "window" in r else "")
        if r.get("lse"):
            extra += " with lse (training's forward)"
        if "computes" in r:
            extra += (f" ({r['computes']}; computes "
                      f"{r['computed_gflop']:.1f} GFLOP, 3xTF32 bound "
                      f"{r['computed_bound_ms']:.4f} ms)")
        fp32 = (f", 3xTF32 tensor cores; fp32 CUDA-core bound_fp32_ms "
                f"{r['bound_fp32_ms']:.5f}" if "bound_fp32_ms" in r else "")
        print(f"kernel {r['name']} {tuple(r['shape'])}{extra}: launches "
              f"{launches.get(r['name'], 'dq + dk/dv')}, kernel_ms "
              f"{r['ms']:.4f} "
              f"(graph; eager call {r['call_ms']:.4f}), bound_ms "
              f"{r['bound_ms']:.5f} ({r['bound_by']}{fp32}), plain_ms "
              f"{r['plain_ms']:.4f}, library_ms {lib}")
    port, ref = "src/repro_torch/kernels/csrc/", "src/repro/kernels/"
    src = {"quantize": (port + "quant_transfer.cu",
                        ref + "quant_transfer/quant_transfer.py:31"),
           "dequantize": (port + "quant_transfer.cu",
                          ref + "quant_transfer/quant_transfer.py:52"),
           "topk_compress": (port + "topk_compress.cu",
                             ref + "topk_compress/topk_compress.py:64"),
           "flash_attention": (port + "flash_attention.cu",
                               ref + "flash_attention/flash_attention.py:84"),
           # no Pallas backward exists: the reference differentiates the jnp
           # attention (layers.multi_head_attention) that the forward kernel
           # replaces on the TPU path
           "flash_attention_bwd_dq": (
               port + "flash_attention.cu",
               ref + "flash_attention/flash_attention.py:84"),
           "flash_attention_bwd_dkdv": (
               port + "flash_attention.cu",
               ref + "flash_attention/flash_attention.py:84"),
           "ssd_scan": (port + "ssd_scan.cu", ref + "ssd_scan/ssd_scan.py:69"),
           # no Pallas backward exists: the reference differentiates the jnp
           # ssd_chunked (models/ssm.py) that the forward kernel replaces
           "ssd_scan_bwd": (port + "ssd_scan.cu",
                            ref + "ssd_scan/ssd_scan.py:69")}
    kernels = []
    for r in rows:
        if r["name"] in [k["name"] for k in kernels] or r["name"] not in src:
            continue   # the JSON line holds each kernel's main-path shape
        kernels.append({"name": r["name"], "route": "cuda",
                        "source": src[r["name"]][0],
                        "replaces": src[r["name"]][1],
                        "launches": sum(launches[r["name"]].values()),
                        "launches_by_path": launches[r["name"]],
                        "max_abs_err": worst[r["name"]],
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
        if "bound_fp32_ms" in r:
            kernels[-1]["bound_fp32_ms"] = r["bound_fp32_ms"]
        if r["name"] == "ssd_scan_bwd":
            kernels[-1]["replaces_note"] = (
                "no Pallas backward exists: the gradient of this line's "
                "function, which the reference takes by autodiff of the jnp "
                "ssd_chunked (src/repro/models/ssm.py:73)")
            kernels[-1]["max_rel_err"] = worst_rel
            kernels[-1]["gflop"] = r["gflop"]
            kernels[-1]["library"] = None
        if r["name"].startswith("flash_attention_bwd"):
            kernels[-1]["replaces_note"] = (
                "no Pallas backward exists: the gradient of this line's "
                "function, which the reference takes by autodiff of the jnp "
                "attention (src/repro/models/layers.py:137)")
            kernels[-1]["computes"] = r["computes"]
            kernels[-1]["computed_gflop"] = r["computed_gflop"]
            kernels[-1]["computed_bound_ms"] = r["computed_bound_ms"]
            # no library call computes one kernel's part alone: the pair's
            # row (the same shape, the whole backward) carries the yardstick
            pair = next(p for p in rows if p["name"] == "flash_attention_bwd"
                        and p["shape"] == r["shape"])
            kernels[-1]["library_note"] = (
                "no PyTorch call computes this kernel's part alone; "
                "whole_backward holds the pair (dq + dk/dv kernels) against "
                "the library's whole backward")
            kernels[-1]["whole_backward"] = {
                key: pair[key] for key in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "bound_fp32_ms",
                                           "library_ms", "library",
                                           "library_err", "computes",
                                           "computed_gflop",
                                           "computed_bound_ms")}
    return kernels, rows


def main() -> None:
    # the flex_attention yardstick compiles through inductor and Triton:
    # their caches go to the kernels' git-ignored build directory
    build = HERE / "src" / "repro_torch" / "kernels" / "build"
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(build / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is visible")
    phase("1. card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not card:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmul and cuDNN: every comparison is full fp32")
    try:
        from repro_torch.kernels import LAUNCHES, _build, reset_launches
        from repro_torch.kernels import flash_attention as tf
        from repro_torch.kernels import quant_transfer as tq
        from repro_torch.kernels import ssd_scan as ts
        from repro_torch.kernels import topk_compress as tt
    except ImportError as e:
        fail(f"the port is not beside chip_smoke.py ({e})")
    dev = torch.device("cuda", 0)
    record = {"card": card}
    try:
        phase("2. build")
        t0 = time.perf_counter()
        logs = _build.build_all(verbose=True)
        record["build_s"] = time.perf_counter() - t0
        print(f"built {sorted(logs) or 'nothing (cached)'} in "
              f"{record['build_s']:.2f} s")
        for name, log in logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

        phase("3. kernels vs plain versions")
        worst = check_kernels(torch, tq, tt, dev)
        worst["flash_attention"] = check_flash(torch, tf, dev)
        record["flash_bwd_drills"] = check_flash_bwd(torch, tf, dev, worst)
        worst["ssd_scan"] = check_ssd(torch, ts, dev)
        record["ssd_bwd_drills"] = check_ssd_bwd(torch, ts, dev)
        torch.cuda.synchronize()

        phase("4. federated main path: run_federated on VGG-5, full width")
        record["main_path"], record["profile"] = vgg5_main_path(
            torch, dev, LAUNCHES, reset_launches)

        phase("4b. control plane: the PPO agent trained on the card")
        record["main_path"]["train-ppo"] = ppo_training_path(
            torch, dev, LAUNCHES, reset_launches)

        phase("4c. federated main path: the batched engine and the "
              "reference server step")
        batched, record["profile_batched"] = vgg5_main_path(
            torch, dev, LAUNCHES, reset_launches, engine="batched",
            server_step="reference")
        record["main_path"].update(batched)
        batched_against_sequential(record["main_path"])

        phase("4d. the async runtime and checkpoints: run_federated_async, "
              "resume and a chaos drill on VGG-5, full width")
        record["async"] = async_checkpoint_path(torch, dev, LAUNCHES,
                                                reset_launches)
        record["main_path"].update(
            {name: run for name, run in record["async"].items()
             if isinstance(run, dict) and "launches" in run})

        phase("4e. heterogeneous widths and the two-tier server on VGG-5, "
              "full width")
        record["hetero"] = hetero_hierarchy_path(
            torch, dev, LAUNCHES, reset_launches,
            record["main_path"]["sfl-op1"])
        record["main_path"].update(
            {name: run for name, run in record["hetero"].items()
             if isinstance(run, dict) and "launches" in run})

        phase("4f. VGG-5 on a mesh: (1, 1), (1, 8) and (2, 4) over "
              f"{MESH_PLACES} places of one card, and async over "
              f"{MESH_ASYNC} with a resume")
        record["mesh"] = vgg5_mesh_path(torch, dev, LAUNCHES,
                                        reset_launches, card)
        record["main_path"].update(record["mesh"])

        phase("5. serving main path: ServeEngine on gemma2-2b, full width")
        serving, real = gemma2_main_path(torch, tf, dev, LAUNCHES,
                                         reset_launches)
        record["main_path"]["serve-gemma2-2b"] = serving
        worst["flash_attention"] = max(worst["flash_attention"],
                                       serving["real_layer_max_abs_err"])

        phase("5b. serving main path: mamba2-780m, full width")
        ssm_serving, ssd_real = mamba2_main_path(torch, ts, dev, LAUNCHES,
                                                 reset_launches)
        record["main_path"]["serve-mamba2-780m"] = ssm_serving
        worst["ssd_scan"] = max(worst["ssd_scan"],
                                ssm_serving["real_layer_max_abs_err"])

        phase("5c. serving main path: mixtral-8x22b (MoE, 6 layers at full "
              "width) and internvl2-2b (VLM, full width and depth)")
        moe_serving, real["mixtral"] = mixtral_main_path(
            torch, tf, dev, LAUNCHES, reset_launches)
        record["main_path"]["serve-mixtral-8x22b"] = moe_serving
        worst["flash_attention"] = max(worst["flash_attention"],
                                       moe_serving["real_layer_max_abs_err"])
        record["main_path"]["serve-internvl2-2b"] = internvl2_main_path(
            torch, dev, LAUNCHES, reset_launches)

        phase("5d. serving main path: recurrentgemma-9b (hybrid, full width "
              "and depth) and whisper-base (encoder-decoder, full width and "
              "depth)")
        hybrid_serving, real["recurrentgemma"] = hybrid_main_path(
            torch, tf, dev, LAUNCHES, reset_launches)
        record["main_path"]["serve-recurrentgemma-9b"] = hybrid_serving
        whisper_serving, real["whisper"] = whisper_main_path(
            torch, tf, dev, LAUNCHES, reset_launches)
        record["main_path"]["serve-whisper-base"] = whisper_serving
        worst["flash_attention"] = max(
            worst["flash_attention"], hybrid_serving["real_layer_max_abs_err"],
            whisper_serving["real_layer_max_abs_err"])
        free_card(torch)

        phase("5e. LM training: qwen3-0.6b (full width and depth) through "
              "the split path, the flash backward kernels and the driver")
        training, real["qwen3"] = qwen3_training_path(
            torch, tf, dev, LAUNCHES, reset_launches)
        record["main_path"]["train-qwen3-0.6b"] = training
        for e in training["real_layer_bwd_err"].values():
            add_bwd_errs(worst, e)
        free_card(torch)

        phase("5f. LM training: mamba2-780m (full width and depth) through "
              "the split path, the SSD scan's backward kernel and the driver")
        ssm_training, ssd_bwd_real = mamba2_training_path(
            torch, ts, dev, LAUNCHES, reset_launches)
        record["main_path"]["train-mamba2-780m"] = ssm_training
        worst["ssd_scan_bwd"], worst_rel_ssd_bwd = worst_ssd_bwd(
            list(record["ssd_bwd_drills"].values())
            + list(ssm_training["real_layer_bwd_err"].values()))
        free_card(torch)

        phase("5g. federated LM training: run_federated over qwen3-0.6b "
              "(full width and depth; then widths and two edges) and "
              "mamba2-780m (12 of 48 layers)")
        fed_ref = {}
        record["main_path"].update(federated_lm_path(
            torch, dev, LAUNCHES, reset_launches, card, keep=fed_ref))
        fed_ref["record"] = record["main_path"]["fed-qwen3-0.6b"]
        free_card(torch)

        phase("5h. federated training published into a live server: "
              "run_federated_async over qwen3-0.6b (full width and depth) "
              "into a ServeEngine through a ParamStore")
        record["main_path"]["hotswap-qwen3-0.6b"] = hotswap_lm_path(
            torch, dev, LAUNCHES, reset_launches, card)
        free_card(torch)

        phase(f"5i. the LM on a mesh: phase 5g's qwen3-0.6b run over "
              f"{FED_MESH}, and the expert-parallel MoE layer of "
              f"mixtral-8x22b and arctic-480b at full width")
        lm_mesh = lm_mesh_path(torch, dev, LAUNCHES, reset_launches, card,
                               fed_ref)
        del fed_ref
        record["main_path"].update(
            {k: v for k, v in lm_mesh.items() if "launches" in v})
        record["moe_mesh"] = {k: v for k, v in lm_mesh.items()
                              if "launches" not in v}
        free_card(torch)

        phase("5j. the launch drivers: the FedAdapt pod pair at qwen3-0.6b "
              "(full width and depth), the step builders, the dry runs on "
              "meta, the fleet simulation and the step analysis over real "
              "steps")
        record["main_path"].update(launch_drivers_path(
            torch, dev, LAUNCHES, reset_launches, card))
        free_card(torch)
        launches = {k: {path: run["launches"][k]
                        for path, run in record["main_path"].items()}
                    for k in LAUNCHES}

        phase("6. small configurations: CPU vs card")
        record["small"] = small_cpu_vs_card(torch, dev)
        record["small_serve"] = small_serve_cpu_vs_card(torch, dev)
        record["small_ssm"] = small_lm_cpu_vs_card(torch, dev, "mamba2-780m")
        record["small_moe_vlm"] = {
            arch: small_lm_cpu_vs_card(torch, dev, arch)
            for arch in ("mixtral-8x22b", "arctic-480b", "internvl2-2b")}
        record["small_hybrid_encdec"] = {
            arch: small_lm_cpu_vs_card(torch, dev, arch)
            for arch in ("recurrentgemma-9b", "whisper-base")}
        record["small_training"] = {
            arch: small_lm_training_cpu_vs_card(torch, dev, arch)
            for arch in ("gemma2-2b", "qwen3-0.6b", "mixtral-8x22b",
                         "internvl2-2b", "recurrentgemma-9b",
                         "whisper-base", "mamba2-780m")}
        record["small_driver"] = lm16m_driver_cpu_vs_card(torch, dev)
        record["small_federated_lm"] = small_federated_lm_cpu_vs_card(
            torch, dev)
        record["silu_drill"] = silu_drill(torch, dev)

        phase("7. kernel times")
        real["qwen3-train"] = (*real["qwen3"][:3], 0, 0.0)
        kernels, rows = time_kernels(
            torch, tq, tt, dev, launches, worst, worst_rel_ssd_bwd,
            time_flash(torch, tf, real) + time_flash_bwd(torch, tf, real)
            + time_ssd(torch, ts, ssd_real)
            + time_ssd_bwd(torch, ts, ssd_bwd_real),
            record["main_path"]["fed-qwen3-0.6b"]["flat_lanes"])
        record["kernels"], record["timings"] = kernels, rows
        torch.cuda.synchronize()
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        fail("a phase raised")
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    record["whole_run_s"] = time.perf_counter() - START
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(f"whole run: {record['whole_run_s']:.1f} s, the kernels' build "
          f"included ({card})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
