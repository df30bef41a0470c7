"""Smoke run of paddle_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--parent DIR]

Builds the port's CUDA kernels from paddle_tpu_torch/csrc (one nvcc per
source, all started together; each build's seconds printed) and, beside
them, the native runtime from paddle_tpu_torch/csrc/native (the runner
library, ptt_run and the C++ op library, paddle_tpu_torch.runtime), then:

1. kernels: each kernel against its plain PyTorch version on the card
   (each kernel with a custom op called through it, `torch.ops.ptt`), at
   the shapes the serving and training paths give it, in bfloat16 and
   float32, with the kernel's, the plain version's and (where one PyTorch
   call computes the same function) the library call's time; the int8
   attention kernels read pages quantized by page_quant from random rows;
   the flash and ragged kernels take two routes by type and shape
   (flash_attention.route, ragged_attention.route): bfloat16 and float16
   the tensor-core kernels, held against the plain versions that round P
   and dS where they do (p_dtype; ragged: the kernel's own tiled walk,
   element by element) and against the float32 plain version (flash:
   beside the library call); float32 the SIMT kernels; ragged attention
   (float and int8 pages) at the smoke's mixed rows, with GQA 8, at
   contexts up to the engine's whole table ([long]), D = 64, a window of
   Q_max = 8 ([q8]), the verify windows of speculative decoding (4 rows of
   q_len 5 in s_pad 8 at serving contexts, [verify]), a 40-slot mixed step
   ([c40]) and float16, each printing its route; the flash backward at the training shape [4, 2048, 16, 128]
   and with GQA at [1, 2048, 32 -> 8, 128] in bfloat16, its dq, dk and dv
   each held; the edges of both routes in bfloat16 and float32 (S_q < S_k,
   S_q > S_k, S = 300, D = 64, GQA, the masked forms), float16 at one
   shape; flashmask forward and backward
   (a packed-document mask at [4, 2048, 16, 128], per-KV-head bounds under
   GQA, bidirectional 4 bounds, a window of 256; SDPA with the dense mask
   as the library time) and bias + dropout + residual + LayerNorm at
   BERT-base's [16384, 768] (its keep mask bit-equal to the plain
   Philox's); paged decode attention (float and int8 pages) at the
   smoke's contexts, at contexts up to the engine's whole table ([long]),
   with 16 query heads a KV head ([rep16]), the tiny model's D = 16 and the
   scalar path's D = 18, each with its split plan and CUDA launches per
   call; RMSNorm at the prefill, training, decode ([4, 4096]) and odd
   ([37, 333]) shapes; the RoPE kernel in each form the main path
   launches (q and k of the dense admission in one launch, with GQA 8;
   the paged steps' per-token rows, a decode step's and a ragged chunk's;
   q and k of the training step and their gradients, the transposed
   form), tables in x's type, and the scalar path (D = 18), each printing
   its path; GPT-3 1.3B's serving shapes (decode and ragged attention,
   float and int8 pages, at 16 KV heads of 128; the dense admission's
   causal flash at [4, 256, 16, 128]) and BERT-base's non-causal flash at
   [8, 512, 12, 64] beside SDPA; then the cost of the plain int8 page
   write (page_quant.write_rows) at the decode shape;
2. agree: a 2-layer tiny Llama in float32 with the same seeded weights on
   the CPU (plain versions) and on the card (kernels) — generate_batch
   with prefix cache, chunked prefill and mixed steps, generate_batch with
   cold prompts that fit the chunk (dense admission) beside a prefix hit,
   and generate with its KV cache must give the same greedy tokens; then
   the same two workloads and a fork mid-decode over int8 KV pages; then
   (agree:train) the first backward's gradients and 3 AdamW steps of
   compile_train_step must agree; (agree:masked) the tiny Llama with a
   padded-batch attn_mask (logits, loss, gradients), a tiny
   fused_feedforward and F.flashmask_attention in each bound form must
   agree; (agree:spec) speculative decoding on the tiny pair, float and
   int8 pools, with the n-gram drafter, self-drafting and a chunked-prefill
   interleave: CUDA spec-on tokens equal the CPU plain path's and (float)
   the spec-off tokens, float self-drafting accepts every draft;
   (surface) two threads streaming from one engine, a cancel, an
   export/import round trip through the CPU engine and a weight swap
   mid-run, each equal to the CPU plain path; (agree:graphs) the engine's
   step programs as replayed CUDA graphs against the eager twin
   (``_graphs = False``): greedy and seeded sampled tokens, float and int8
   pools, prefix sharing and chunked prefill, dense admission, a fork (the
   CoW copy program) and self-drafting must be token-identical with equal
   kernel launches, a repeat wave of the same shapes must build no
   program (the draft engine's too), and a weight swap in place must keep
   every program (a moved parameter drops them); (agree:gpt) the tiny
   GPT (multi-head, learned positions) through the prefix-sharing chunked
   workload, dense admissions and spec decoding (n-gram and draft model),
   float and int8 pools: CPU, CUDA graphs and the eager twin must give the
   same greedy tokens, and the card must launch decode, ragged and flash
   attention and the int8 twins; (agree:bert) the tiny BERT's three heads
   with and without a padding mask (and their losses), MultiHeadAttention
   through a Cache and a StaticCache, a Transformer, the six fused
   incubate layers, fused_multi_transformer and
   block_multihead_attention, CPU against the card within 1e-4 of each
   output's largest value, with the flash kernel launched once a layer
   where no mask is given and never under one; (agree:train2) each
   optimizer of the rest of training over 3 steps and LBFGS on a
   quadratic, AdamW under a warm-up cosine schedule on the tiny Llama,
   the tiny Llama with apply_llama_remat against itself without remat on
   the card (the forward kernels launched twice a layer), the tiny GPT's
   steps, a tiny BERT under amp O2 + GradScaler on the tensor-core flash
   route, and a checkpoint written from the card and loaded on the CPU
   bit for bit; (agree:fleet) float and int8 pools: the card's KV page
   exports of the prompts equal the CPU's byte for byte (int8: codes and
   scale rows), the card's exports imported by a CPU engine and the
   CPU's by a card engine continue with the cold run's tokens, a request
   exported mid-stream with its KV continues exactly once on the other
   device, and a card engine whose pool cannot hold the prompts spills
   into a PrefixStore and refills token-exact;
3. flashmask: F.flashmask_attention through autograd at [4, 2048, 16,
   128] bf16 with packed documents (each call must launch the masked
   forward and backward kernels once; out and grads held against the
   plain versions), then the forward at [1, 8192, 32, 128] beside SDPA
   with the dense mask; fused_ffn: BERT-base fused_feedforward (post-norm,
   gelu, dropout 0.1, training) forward and backward on [32, 512, 768]
   bf16 and the FusedBiasDropoutResidualLayerNorm layer, one bdrln launch
   a call;
4. serve: Llama-2-7B geometry in bfloat16 with random weights from a seed
   (SERVE_LAYERS, 4, of its 32 layers) serves 8 requests of 300-900 tokens (chunked prefill,
   a prefix hit, mixed steps) through one engine whose step programs are
   CUDA graphs: a cold wave captures them, a warm wave of the same shapes
   (it must build none) gives the numbers, and a third wave runs engine
   steps 2-4 under torch.profiler (device time by kernel, idle share,
   host launch calls and device kernels per engine step); then the eager
   twin (``_graphs = False``) on a fresh engine, timed and profiled, must
   give the warm wave's tokens and kernel launches; every kernel of that
   path must launch, and a prefix-cache hit must occur;
5. serve:dense: the same model serves 8 cold requests of 64-256 tokens,
   which the engine admits through the dense prefill (flash attention and
   fused RoPE), a cold and a warm wave; then the first dense admission of
   a third wave (a replayed graph) runs under torch.profiler, and the
   eager twin must give the warm wave's tokens and launches;
6. serve:int8 and serve:dense:int8: the two workloads again with
   kv_dtype="int8" (int8 pools, the int8 attention kernels), each beside
   the share of its generated tokens that differ from its bf16 twin's
   (printed, not checked: the weights are random), then profiled as
   their twins are;
   then serve:spec and serve:spec:int8 (graphs, a cold and a warm wave
   each): the [serve] workload with self-drafting (DraftModelDrafter over
   the serving model, pools like the target's), then the n-gram drafter on
   prompts that hold their own next token (on random weights, text that
   merely repeats gives it nothing) beside their own spec-off run: the
   spec accounting, drafting and verify ms per dispatch, model steps and
   kernel launches per generated token beside the spec-off twin's, peak
   memory; both drafters must draft, no drafter error, float verify
   windows on the tensor-core ragged route, no float paged kernel in the
   int8 runs, and each request's first divergence from its spec-off twin
   a near-tie under the dense forward (SPEC_TIE_ULPS); then spec:rescore
   and spec:rescore:int8: self-drafting again, untimed, every dispatch
   with a rejected draft rescored through the plain ragged version with
   P in float32 and with P rounded as the kernel rounds it (rejections,
   flips against the kernel, and the decisions P's rounding alone
   changes);
   then serve:gpt, serve:gpt:int8 and serve:gpt:dense: with the Llama
   released, GPT-3 1.3B (6 of its 24 layers, hidden 2048,
   16 heads, FFN 8192,
   vocab 50304, bf16, random weights from seed 0) serves the serve and
   serve:dense workloads as the Llama does (cold, warm and profiled waves
   and the eager twins), launching decode and ragged or flash
   attention (int8 twins over int8 pools) and no RMSNorm, SwiGLU or RoPE;
   then bert: BERT-base's BertForMaskedLM in bf16 over 8 x 512 tokens
   without a mask (the non-causal flash kernel, 12 launches a forward) and
   with a padding mask (the dense path, none), agreeing on the unpadded
   row (one unmasked forward profiled), and FusedMultiTransformer at the
   same widths (12 layers), each with its ms per forward;
   fleet and fleet:int8 (after spec:rescore, on the 7B model): two
   LocalReplicas over that one model, each with its own engine and pools
   (the [serve] settings), roles prefill and decode behind one Router,
   serve [serve]'s workload: every request prefills on p0 and hands its
   KV pages to d0 (kvpages/v1), which decodes; every delivered token
   must be the dense forward's argmax at its position or within
   FLEET_TIE_ULPS of it (the prefill replica's GEMMs run at other row
   counts than [serve]'s, so requests may leave [serve]'s tokens at
   near-ties; each first departure is printed), every request must cross the handoff with
   pages, p0 must never decode and d0 must launch the ragged and paged
   decode kernels (the int8 ones and no float paged kernel over int8
   pools); one handoff of the 518-token prompt is timed by part (gather,
   pack, crc32, unpack, upload; host clock) beside the decode replica's
   re-prefill of it; then a second decode replica joins, d0 is killed
   mid-stream and the new one drained with transfer: zero failed
   requests, no duplicate token, tokens held as before; then fleet:proc (the 7B
   model released): two ProcessReplica workers (python -m
   paddle_tpu_torch.serving.worker) on the card, each building the 7B
   width at 2 layers in float32, sharing a FileStore fleet prefix store:
   a prompt spilled by one is a fleet-tier hit on the other, pages cross
   the sidecar frame, and under the router one worker is SIGKILLed
   mid-stream: zero failed requests, exactly-once resume, tokens equal to
   an in-process engine's; each prints the worker start-up seconds and
   the sidecar frame's bytes;
7. train: with the serving models released, the configuration bench.py
   trains on the TPU (0.74B Llama, batch 4 x 2048, bf16 parameters,
   AdamW(1e-4, multi_precision=True)) takes a warm-up step and 5 timed
   steps of compile_train_step on random weights and a fixed batch: the
   losses must be finite and fall, and every step must launch each kernel
   of the path as often as the model has call sites; then (profile:train)
   one more step under torch.profiler; then train:remat (bench.py:147-170
   exactly: the same model with recompute=True and apply_llama_remat: the
   losses equal to train's, the forward kernels twice a layer, peak memory
   below train's, MFU of the model's flops beside the hardware's, one
   step profiled and its device kernels held to the counted launches),
   train:gpt (GPT-3 1.3B, all 24 layers, 4 x 2048, AdamW with masters
   under a warm-up cosine schedule: 24 + 24 flash launches a step, the
   rate each step the scheduler's) and train:bert (BERT-base MLM 32 x 512
   under amp O2 + GradScaler with dropout 0.1: the dense attention path,
   the scale after each step);
8. the training run's telemetry and recovery: programs:serve and
   programs:serve:int8 (after each warm wave: the introspection registry,
   one entry per step program under the JAX engine's labels, with flops
   and HBM bytes, as many as the programs built); after profile:train,
   profiler (profiler.Profiler with make_scheduler(closed=1, ready=1,
   record=2) over 5 more [train] steps: the window's chrome trace must
   name the flash forward, dQ, dK/dV, RMSNorm, SwiGLU and RoPE kernels
   and hold the RecordEvent spans) and amp:debug (operator stats of one
   O1 forward; an Inf injected into a weight under check_numerics_guard
   must raise, naming the op); last, train:resilient ([train]'s model at
   RES_LAYERS layers under ResilientTrainer, fed by an io.DataLoader with
   two shared-memory workers and pinned batches, timed by a StepTimer:
   a checkpoint every 4 steps, a NaN loss rolled back, a hung wait
   raising CommTimeoutError and recovered from the last checkpoint; the
   events, goodput, the phases' seconds, perf_mfu beside the analytic
   MFU over a fault-free window (within 10%), the counted train-step
   flops beside _train_flops (within 5%), the save, restore and snapshot
   seconds; then an uninterrupted run of the surviving steps must give
   the same losses and final parameters, each within 2 bf16 ulps).
9. tensor parallelism (slice 16): collectives (after agree:fleet): every
   collective of paddle_tpu_torch.distributed on co-located 2- and
   4-rank worlds on the card (stacked and per-rank layouts, every reduce
   op, the object collectives, the step programs' all-reduce and
   all-gather) against the host's result: integers exact, float32 within
   COLL_RTOL; agree:mesh: a narrow Llama (2 KV heads) and GPT in bf16
   through MeshGenerationEngine at tp2, tp4 (the Llama's pools
   replicated) and tp2 x fsdp2, float and int8 pools, against the
   single-device engine on the card: every first divergence a near-tie
   (MESH_TIE_ULPS), the largest teacher-forced logit difference printed,
   programs built per kind equal, and a tp2 export's shards block
   refused by a single-device importer that then re-prefills; then
   serve:mesh (after fleet:int8): the 7B model at tp=2 co-located on the
   card (16 heads and 16 KV heads a shard) through serve's workload, a
   cold and a warm wave with graphs and a profiled window: decode
   tokens/s, TTFT and peak memory beside serve's from the same call, the
   pool bytes per shard, programs and graphs, decode attention twice a
   layer a decode step, RoPE once a layer a shard, the harvest's
   all-reduces and bytes a decode step, every token within MESH_TIE_ULPS
   of the dense argmax; sharding: the harvest and partition audit of that engine
   (green), and the narrow Llama with q_proj.weight overridden to
   replicated (red, naming the parameter); serve:mesh runs the 7B
   model's first MESH_SERVE_LAYERS (4) layers.
10. the graph compiler (slice 17): dispatch (after kernels): the host
   us per call of a kernel through its custom op beside the bare
   wrapper; agree:fuse (after agree:mesh): the plain-op tiny Llama
   (fusion_audit_torch.PlainLlama) under compile_train_step(fuse=True)
   on the CPU and the card (the architecture's rewrites on both, losses
   within 1e-4), and the port's tiny Llama fused (its capture holds its
   kernels as nodes, 0 rewrites, launches and losses equal to eager's);
   train:fuse (after train:remat): PlainLlama at [train]'s configuration
   and weights, eager, fused and fused with remat_policy="fused" (a
   warm-up and 5 timed steps each: rewrites attention 12, rms_norm 25,
   swiglu 12, rope 24, 0 fallbacks, 1 program; launches a step; median
   ms and peak memory beside [train]'s; the three loss curves held
   against each other); to_static: to_static(fuse=True) on PlainLlama's
   forward at full width, one capture, its logits and the eager ones
   against the float32 forward's and each other. [time] prints each
   phase's seconds.
11. nn and the diffusion UNet (slice 19): kernels: the UNet's attention
   rows, forward and backward, non-causal bf16 [16, 1024, 4, 32] (the
   SIMT route: P and dS float32, every gradient element held to the
   bf16 rule) and [16, 256, 4, 64] (tensor cores), beside SDPA / aten;
   agree:unet (after agree:fuse): the tiny UNet in float32 on the CPU
   and the card with the same weights (forward, first gradients, 3
   AdamW steps), then every kernel entry point on strided bf16 views
   (bit-equal to its dense call, within 2e-2 of the plain version);
   train:unet (after train:bert): UNetConfig() at full width, 16 x
   4x64x64 latents, O1 bf16, AdamW(1e-4) through compile_train_step,
   one warm-up and 10 steps timed with CUDA events (median ms, images/s,
   peak memory, losses finite and falling, 9 flash forward and 9
   backward launches a step: 4 SIMT + 5 tensor-core each way), then one
   step profiled (the attention's share of the device time).
12. the RNNs, nn's tail and vision (slice 20): agree:vision (after
   agree:unet): a tiny ResNet-18 (forward in both modes, 3 hapi Momentum
   losses), a 2-layer bidirectional LSTM and a GRU (outputs, states,
   gradients), the CPU against the card in float32; tail and rnn (after
   fused_ffn): flash_attn_qkvpacked at [4, 1024, 16, 128] bf16 causal and
   flash_attn_varlen_qkvpacked over 300 / 700 / 1024 tokens, forward and
   backward against the float32 plain versions, one flash launch each
   way a call (a sequence for varlen), tensor cores; LSTM(512, 1024, 2
   layers, bidirect) over [32, 128, 512] forward and backward (ms)
   against the plain loop on the CPU; train:resnet (after train:unet):
   ResNet-50 with a 10-way head through hapi.Model.fit at batch 128 over
   a CIFAR-10-format archive written from the seed (ms a step, images/s,
   peak memory, losses falling, evaluate's top-1 above chance, predict,
   a bit-equal save / load round trip, one profiled step).
13. save and deploy (slice 21): agree:vision and train:resnet run under
   FLAGS_cudnn_deterministic (agree:vision's losses held per step: the
   first to the forward's 1e-5, the later ones to 20 times the change
   one float32 ulp of the weights makes to the CPU's loss; train:resnet
   fits and evaluates twice from one seed: equal losses and top-1);
   deploy (after train:resnet): Llama-2-7B widths at DEPLOY_LAYERS
   layers through jit.save (a static [4, 512] int64 signature) and
   inference.create_predictor, its logits bit-equal to eager, one run's
   flash, RMSNorm, SwiGLU and RoPE launches counted; the trained
   ResNet-50 saved with a dynamic batch, its Predictor at batches 1 and
   128 and a DynamicBatcher over single images against eager (1e-5 of
   the largest logit), ProgramAnalysis' summary; deploy:native: the
   AOTInductor package of the Llama artifact (compile seconds, launches,
   logits within the bf16 rule, the package reused by a second
   construction).
14. the distributed strategies of BASELINE configs 3 and 4 (slice 22),
   after train:gpt, every rank of each mesh on the one card:
   train:hybrid: GPT-3 1.3B at full width and depth as a PipelineLayer
   at dp 2 x pp 2, 4 micro-batches a step, stage-2 ZeRO over dp through
   fleet.distributed_optimizer(DygraphShardingOptimizer), a warm-up and
   3 timed train_batch calls; its losses held bit-close to the same
   micro-batches accumulated on one device and to the whole-batch
   compile_train_step run (the first within 1e-3, the later ones within
   20 times what one bf16 ulp on half the weights moves that run);
   train:pipeline: CompiledPipeline over 8 of its 24 blocks at dp 2 x pp
   2 x mp 2 with apply_tp and zero_axis="dp", 2 steps under 1F1B and 2
   under ZBH1 from the same weights (equal losses; the B chain's and the
   W phase's ms); train:semi: Llama-2-7B widths at 2 layers through
   apply_llama_tp, shard_optimizer(ShardingStage2) and dist.to_static,
   held to the single-device compile_train_step's losses. Each prints ms
   a step (CUDA events), peak memory, each rank's optimizer-state bytes
   (half of the whole, held), collective calls and bytes per step by op
   (held) and its kernels' launches per step by route (held).
15. quantization, MoE, incubate, text and audio (slice 23), after
   train:semi: quant:ptq: Llama-2-7B widths at QAT_LAYERS layers in bf16
   calibrated by PTQ over PTQ_BATCHES batches of PTQ_BATCH tokens with the
   Absmax, Hist and KL observers on the activations (Absmax on the
   weights): the first layer's scales and each observer's host seconds;
   quant:qat (the slice's main path): the same model trained QAT_STEPS
   AdamW steps float, then swapped by QAT and trained again from the same
   weights through compile_train_step, and by an eager twin loop: swapped
   layers counted, ms a step and peak memory beside the float run's,
   RMSNorm, SwiGLU, RoPE and flash (tensor cores) launches held every
   step, one profiled step each (device kernels a step: the fake quant's
   launches), losses different from the float ones and equal to the
   twin's; quant:weight_only: weight_quantize and weight_only_linear on
   gate_proj [4096, 11008] (int8 per channel, int4 in groups of 128) at 4
   and 2048 rows, error against the float32 dequantized product, weight
   bytes, ms beside torch.matmul on the bf16 weight; quant:pass: the
   plain-op Llama at TRAIN_CFG widths and QPASS_LAYERS layers through
   compiler.optimize with pattern fusion then quantize_pass: one
   quant_linear rewrite per linear product, the kernels fusion still
   places, logits against the eager fake-quant composition (the pass
   alone: bit-equal); moe: MoELayer at Mixtral-8x7B's widths, forward and
   backward under both dispatch forms and at ep=4 on a co-located mesh
   (ms, peak memory, tokens dropped, the three gates' aux losses, sorted
   against one-hot and ep=4 against dense); incubate: 2:4 prune_model of
   a 7B decoder layer, one decorated AdamW step (sparsity held),
   LookAhead and ModelAverage steps, the geometric ops card against CPU;
   text: viterbi_decode (32 x 256 x 64) card against CPU, paths equal;
   audio: LogMelSpectrogram and MFCC of 32 clips of 5 s at 44.1 kHz card
   against CPU.
16. the Python-free native runner (slice 24): deploy:native runs its
   package through the C API (ptt_predictor_* over ctypes); deploy:cpp
   (after it) runs the same package with no Python in the process:
   ptt_run (ldd shows no libpython; an environment without PYTHON*
   variables) on the artifact's ids, its logits within the bf16 rule of
   eager, its C++ ops' launches those of one forward on the tensor-core
   and q + k routes, load and run seconds; a plain C client
   (examples/ptt_c_client.c, gcc -x c) giving ptt_run's bytes; and
   ptt_run --selftest: each of the seven C++ ops once through the
   dispatcher on seeded inputs at the deploy widths, bit-equal to the
   Python op on the same inputs.
17. the multi-process world, context parallelism and the auto-tuner
   (slice 25): dist:launch (after train:hybrid, which also accumulates
   the reference: the two half-batches in one process) starts two
   workers with `python -m paddle_tpu_torch.distributed.launch --nnodes 2
   --rank r --master 127.0.0.1:<port>` on the card, joined over gloo: GPT-3
   1.3B's widths, DataParallel with ZeRO stage 2 (reduce-scatter of each
   rank's gradients, all-gather of the new slices), 3 timed AdamW steps,
   then save_checkpoint(world_size=2) through the commit barrier; losses
   against the one-process run, gloo calls / bytes / seconds / host-staged
   bytes a step, state bytes per rank, flash launches per rank, start-up
   and wall seconds, LATEST after both progress posts; ring:
   ring_flash_attention (causal and not) and ulysses_attention at
   [1, 16384, 32, 128] bf16 over a 4-rank mesh of the card, forward and
   backward against whole-sequence flash, flash launches by direction and
   route (the causal ring: 10 blocks of 16), ms and peak; auto_tuner
   (after profile:train): the h100 profile's predicted ms and bytes for
   [train]'s configuration against [train]'s median and peak.

Each flashmask, fused_ffn, tail, serving (serve:mesh too), BERT, training
(the resilient one's too) and deploy run's launch counts are set to 0 just before it and read just after it; every kernel of its path
must have launched, the int8 runs must launch the float paged attention
kernels 0 times, every flash launch of the Llama, GPT and BERT training,
dense-serving and flashmask runs (bfloat16) and every ragged launch of
the serving runs must take the tensor-core route (the UNet's head dim 32
takes SIMT: its routes are held per step); every model step of the Llama serving runs
must launch RoPE once a layer (q and k together, on the vector path), and
every training step once a layer each way. Then
it prints the card's name and power limit, one JSON line with every
kernel's numbers, and as the last line {"ok": true, "device": {...}}. Any
failure raises and exits non-zero without that line. Without a CUDA card
it exits 2 before doing anything. The serving runs also print decode
attention's launches per decode step and, profiled, its share and the
ragged kernel's share of the device's busy time.

--parent DIR names a copy of an earlier commit's paddle_tpu_torch/csrc
(for example `git archive HEAD~1 paddle_tpu_torch/csrc | tar -x -C
build/parent_src`): its decode attention, ragged attention (float and
int8 pages), RMSNorm and RoPE are built beside this tree's and timed on
the same inputs in the order parent, kernel, kernel, parent (parent_ms on
the [kernels] rows; a q + k RoPE row times the parent's kernel on q and
on k, the per-token rows and the backward the plain versions that the
parent's tree ran there).
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}  # dense tensor-core bf16; fp32 non-tensor
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}
# the bf16 flash backward, element by element: |got - want| <=
# 2^-7 |want| (one bf16 rounding of either side) + 2^-8 rms(want)
BWD_REL_BF16, BWD_FLOOR_BF16 = 2.0 ** -7, 2.0 ** -8
# the 16-bit (tensor-core) flash backward: at most max(ceil(this share of
# the elements), BWD_OVER_FLOOR) elements of each of dq, dk and dv beyond
# that rule, every element within it plus one rounding of each term of its
# product (see _within)
BWD_OVER_SHARE = 1e-5
BWD_OVER_FLOOR = 4
# a 16-bit kernel's error against the float32 plain version, at most this
# multiple of the library call's
LIB_ERR_FACTOR = 2.0
ITERS = 10                          # timed launches per kernel
L2_FLUSH_BYTES = 256 << 20          # > the H100's 50 MB L2
# device clock cycles (~1 ms) the stream spins before each timed launch
HEAD_START_CYCLES = 2_000_000
_flush = []


def _time_ms(fn, iters=ITERS):
    """Mean device time of fn over `iters` launches, each timed alone
    after a read of a buffer larger than L2, so that every launch reads
    its inputs from HBM as the bound assumes. The stream then spins for
    ~1 ms, so that the host has enqueued the start event and fn's kernels
    before the device reaches them: a slow host adds no gap to the
    measured span."""
    if not _flush:
        _flush.append(torch.empty(L2_FLUSH_BYTES // 4, device="cuda"))
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        _flush[0].sum()
        torch.cuda._sleep(HEAD_START_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def _bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def _ulp_bf16(ref):
    """One bf16 ulp at each element of ref (float32 tensor)."""
    e = torch.floor(torch.log2(ref.abs().clamp_min(1e-30)))
    return torch.pow(2.0, e - 7)


# ----------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ----------------------------------------------------------------------

def _paged_case(rng, dev, dtype, rows, h, h_kv, d, page, p_max):
    """Page pools holding each row's context at shuffled page ids (page 0
    is the trash page, filled with garbage). rows: list of (ctx, q_len,
    dummy). Returns (k_pages, v_pages, block_tables int32 [C, P])."""
    need = [0 if dummy else -(-ctx // page) for ctx, _, dummy in rows]
    n_pages = 1 + sum(need)
    ids = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((len(rows), p_max), np.int32)
    at = 0
    for i, n in enumerate(need):
        bt[i, :n] = ids[at:at + n]
        at += n
    k = torch.from_numpy(rng.standard_normal(
        (n_pages, page, h_kv, d), dtype=np.float32)).to(dev, dtype)
    v = torch.from_numpy(rng.standard_normal(
        (n_pages, page, h_kv, d), dtype=np.float32)).to(dev, dtype)
    return k, v, torch.from_numpy(bt).to(dev)


def _int8_pools(kp, vp):
    """Float pools -> (int8 codes and float32 scale rows) for K and V:
    page_quant's whole-page quantization, scales from the data."""
    from paddle_tpu_torch.quantization import page_quant
    kq, ks = page_quant.quantize_pages(kp)
    vq, vs = page_quant.quantize_pages(vp)
    return (kq, vq, ks, vs)


# the smoke's ragged rows (Llama-2-7B heads, the engine's table of 256
# pages of 16): a suffix chunk after a 300-token prefix, a first chunk
# ending mid-page, a decode row, a dummy row; (context, q_len, dummy)
RAGGED_ROWS = ((556, 256, False), (200, 200, False), (777, 1, False),
               (1, 1, True))
# [long]: a 256-query chunk at the tail of a 4096-token context (the whole
# table), decode rows at 3000 and 2048, a dummy row
RAGGED_LONG = ((4096, 256, False), (3000, 1, False), (2048, 1, False),
               (1, 1, True))
# [q8]: a short suffix or verify window (Q_max 8), contexts mid-page
RAGGED_Q8 = ((37, 8, False), (21, 5, False), (90, 1, False), (1, 1, True))
# [verify]: a speculative verify dispatch of the [serve:spec] runs: 4 rows
# of q_len 5 (the last committed token and 4 drafts) in s_pad 8, at the
# serving contexts (prompts of 300-900 tokens plus what has been generated)
RAGGED_VERIFY = ((617, 5, False), (349, 5, False), (905, 5, False),
                 (448, 5, False))
# [c40]: a mixed step at 40 slots (tables of 64 pages): four chunks of up
# to 256 queries, 35 decode rows, a dummy row; at GQA 8 a block holds 32
# positions, so 40 x 8 = 320 (row, query tile) items, past the 256 that
# the kernel's blocks rank by keys (its fixed order: last query tile first)
RAGGED_C40 = ((600, 256, False), (256, 256, False), (900, 200, False),
              (333, 77, False)) + tuple(
                  (17 + 29 * i, 1, False) for i in range(35)) + \
    ((1, 1, True),)


def _row_rule(got, want, extra=None):
    """Largest err / (2^-7 |want| + 2^-8 rms of want's row over D [+ extra])
    over the elements of a [C, Q, H, D] output (the flash backward's form,
    with the rms of each (row, query, head)); an element allowed 0 passes
    only when it is exact."""
    want = want.float()
    err = (got.float() - want).abs()
    allow = BWD_REL_BF16 * want.abs() + \
        BWD_FLOOR_BF16 * want.square().mean(-1, keepdim=True).sqrt()
    if extra is not None:
        allow = allow + extra
    ratio = torch.where(err == 0, torch.zeros_like(err), err / allow)
    return float(ratio.max())


def check_ragged(K, dev, dtype, h_kv, rng, int8=False, rows=RAGGED_ROWS,
                 q_max=256, h=32, d=128, page=16, p_max=256):
    """Ragged paged attention against its plain versions. The tensor-core
    route (16-bit q, D 64/128, pages of a multiple of 8) rounds P (int8: P
    times the key's V multiplier) to q's type before the P V product: each
    element is held to 2^-7 |want| + 2^-8 rms(want's row) against the
    kernel's own walk (``*_tiled_plain`` with p_dtype: the same tiles, the
    same rounding points), and to that plus half an ulp of each rounded P
    term (half_ulp * sum_k w_k |V_k|, from the plain version over |V|)
    against the float32-P plain version (the TPU kernel's rounding). The
    same walk with the last 64 keys of the longest decode row dropped must
    fail the first rule. The SIMT route keeps P float32 and is held to TOL.
    With the parent's build loaded, its ragged entry is timed beside the
    kernel (parent, kernel, kernel, parent)."""
    from paddle_tpu_torch.ops.kernels import ragged_attention as RA
    c = len(rows)
    kp, vp, bt = _paged_case(rng, dev, dtype, rows, h, h_kv, d, page, p_max)
    ctx = torch.tensor([r[0] for r in rows], dtype=torch.int32, device=dev)
    ql = torch.tensor([r[1] for r in rows], dtype=torch.int32, device=dev)
    q = torch.from_numpy(rng.standard_normal(
        (c, q_max, h, d), dtype=np.float32)).to(dev, dtype)
    if int8:
        fn, plain, tiled = K.ragged_paged_attention_int8, \
            K.ragged_paged_attention_int8_plain, \
            K.ragged_paged_attention_int8_tiled_plain
    else:
        fn, plain, tiled = K.ragged_paged_attention, \
            K.ragged_paged_attention_plain, \
            K.ragged_paged_attention_tiled_plain
    name = fn.__name__
    pools = _int8_pools(kp, vp) if int8 else (kp, vp)
    rt = RA.route(q, page)
    before = getattr(fn, f"{rt}_launches")
    got = fn(q, *pools, bt, ctx, ql)
    if getattr(fn, f"{rt}_launches") != before + 1:
        raise AssertionError(f"{name}: the launch took no {rt} route")
    pd = dtype if rt == "sm90" else None
    want = tiled(q, *pools, bt, ctx, ql, p_dtype=pd) if pd is not None \
        else plain(q, *pools, bt, ctx, ql)
    torch.cuda.synchronize()
    err = _max_err(got, want)
    pad_zero = all(float(got[i, n:].float().abs().max()) == 0.0
                   for i, (_, n, _) in enumerate(rows) if n < q_max)
    if not pad_zero:
        raise AssertionError("ragged: padded query rows are not zero")
    elt = q.element_size()
    kv_elt = pools[0].element_size()
    pairs = sum(sum(min(ctx_r - n + i + 1, ctx_r) for i in range(n))
                for ctx_r, n, _ in rows)
    flops = 4 * pairs * h * d
    # q is read for the real queries only; the output is written whole
    # (padded rows as zeros); each row's K and V are read up to its context
    # (int8: plus one float32 K and V scale per page read)
    nbytes = (sum(r[1] for r in rows) * h * d * elt + q.numel() * elt
              + 2 * sum(r[0] for r in rows) * h_kv * d * kv_elt)
    if int8:
        nbytes += 2 * 4 * sum(-(-r[0] // page) for r in rows)
    res = {"got": got, "want": want, "err": err, "route": rt, "flops": flops,
           "bytes": nbytes,
           "plain_ms": _time_ms(lambda: plain(q, *pools, bt, ctx, ql,
                                              p_dtype=pd), ITERS // 10),
           "library_ms": None}
    if pd is not None:
        res["tiled"] = _row_rule(got, want)
        # per batch row: the largest error and the rms of its real outputs
        res["rows"] = [(_max_err(got[i, :n], want[i, :n]),
                        float(want[i, :n].float().square().mean().sqrt()))
                       for i, (_, n, _) in enumerate(rows)]
        f32p = plain(q, *pools, bt, ctx, ql)
        vabs = (pools[0], pools[1].abs(), *pools[2:]) if int8 else \
            (pools[0], pools[1].abs())
        half_ulp = torch.finfo(dtype).eps / 2
        terms = plain(q, *vabs, bt, ctx, ql).float() * half_ulp
        res["err_f32p"] = _max_err(got, f32p)
        res["f32p"] = _row_rule(got, f32p, terms)
        del f32p, terms
        # a kernel that drops a key tile: the longest decode row (with no
        # decode row, the longest row) without its last 64 keys (its
        # queries then sit 64 positions earlier)
        real = [i for i, (n_ctx, _, dummy) in enumerate(rows)
                if not dummy and n_ctx > 64]
        dec = max([i for i in real if rows[i][1] == 1] or real,
                  key=lambda i: rows[i][0])
        short = ctx.clone()
        short[dec] -= 64
        res["dropped"] = _row_rule(tiled(q, *pools, bt, short, ql,
                                         p_dtype=pd), want)
        if res["dropped"] <= 1.0:
            raise AssertionError(f"{name}: the 16-bit rule does not reject "
                                 f"a dropped key tile")
    res.update(_with_parent(
        lambda: fn(q, *pools, bt, ctx, ql),
        lambda: _parent_ragged(int8, q, pools, bt, ctx, ql),
        "quantized_attention" if int8 else "ragged_attention", want))
    if "parent_ms" in res:
        res["parent_route"] = "sm90" if pd is not None and \
            "ragged_sm90" in _PARENT else "simt"
    return res


# the smoke's decode batch (Llama-2-7B heads at B = 4, the engine's table
# of 256 pages of 16) and the long one, where the bound (~0.045 ms in bf16)
# rather than launch latency sets the floor
DECODE_LENS = (1000, 517, 64, 1)
LONG_LENS = (4096, 3000, 2048, 1)


def check_decode(K, dev, dtype, rng, h_kv=32, int8=False, lens=DECODE_LENS,
                 b=4, h=32, d=128, page=16, p_max=256):
    """The decode kernel against its plain version; the record carries the
    split plan (from shapes alone) and the CUDA launches of one call (the
    split kernel, and the merge when the plan has more than one split)."""
    rows = [(n, 1, False) for n in lens]
    kp, vp, bt = _paged_case(rng, dev, dtype, rows, h, h_kv, d, page, p_max)
    ctx = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.from_numpy(rng.standard_normal(
        (b, h, d), dtype=np.float32)).to(dev, dtype)
    if int8:
        fn, plain = K.paged_decode_attention_int8, \
            K.paged_decode_attention_int8_plain
    else:
        fn, plain = K.paged_decode_attention, K.paged_decode_attention_plain
    pools = _int8_pools(kp, vp) if int8 else (kp, vp)
    got = fn(q, *pools, bt, ctx)
    want = plain(q, *pools, bt, ctx)
    torch.cuda.synchronize()
    elt = q.element_size()
    nbytes = 2 * q.numel() * elt + \
        2 * sum(lens) * h_kv * d * pools[0].element_size()
    if int8:                  # one float32 K and V scale per page read
        nbytes += 2 * 4 * sum(-(-n // page) for n in lens)
    splits, pps = K.split_plan(b, h, h_kv, p_max, page)
    res = {"got": got, "want": want, "err": _max_err(got, want),
           "flops": 4 * sum(lens) * h * d, "bytes": nbytes,
           "plan": (splits, pps), "launches_per_call": 1 + (splits > 1),
           "plain_ms": _time_ms(lambda: plain(q, *pools, bt, ctx),
                                ITERS // 10),
           "library_ms": None}
    name = "quantized_attention" if int8 else "decode_attention"
    res.update(_with_parent(lambda: fn(q, *pools, bt, ctx),
                            lambda: _parent_decode(name, q, pools, bt, ctx),
                            name, want))
    return res


def check_rms(K, dev, dtype, rng, t=1024, hid=4096):
    eps = 1e-6
    x = torch.from_numpy(rng.standard_normal(
        (t, hid), dtype=np.float32)).to(dev, dtype)
    w = torch.from_numpy(1.0 + 0.1 * rng.standard_normal(
        hid, dtype=np.float32)).to(dev, dtype)
    got = K.rms_norm(x, w, eps)
    want = K.rms_norm_plain(x, w, eps)
    torch.cuda.synchronize()
    elt = x.element_size()
    res = {"got": got, "want": want, "err": _max_err(got, want),
           "flops": 4 * x.numel(),
           "bytes": 2 * x.numel() * elt + hid * w.element_size(),
           "plain_ms": _time_ms(lambda: K.rms_norm_plain(x, w, eps)),
           "library_ms": _time_ms(lambda: torch.nn.functional.rms_norm(
               x, (hid,), w, eps))}
    res.update(_with_parent(lambda: K.rms_norm(x, w, eps),
                            lambda: _parent_rms(x, w, eps), "rms_norm",
                            want))
    return res


# ----------------------------------------------------------------------
# the parent commit's versions of the kernels this tree redesigned, timed
# beside them in the same call (python3 chip_smoke.py --parent DIR)
# ----------------------------------------------------------------------

PARENT_SOURCES = ("decode_attention", "quantized_attention", "rms_norm",
                  "ragged_attention", "ragged_sm90", "rope")
_PARENT = {}             # source name -> ctypes library of the parent's build


def _start_parent(src_dir):
    """One nvcc per parent source in src_dir (a copy of the parent's
    paddle_tpu_torch/csrc), into build/parent/, with the port's flags."""
    from pathlib import Path

    from paddle_tpu_torch.ops.kernels import _build
    out = Path(__file__).resolve().parent / "build" / "parent"
    out.mkdir(parents=True, exist_ok=True)
    src_dir = Path(src_dir).resolve()
    # a parent older than a source (ragged_sm90 is younger than decode or
    # RMSNorm) lacks it
    return {name: (out / f"lib{name}.so", subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src_dir), "-o",
         str(out / f"lib{name}.so"), str(src_dir / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name in PARENT_SOURCES if (src_dir / f"{name}.cu").exists()}


def _finish_parent(jobs):
    import ctypes
    for name, (lib, proc) in jobs.items():
        log = proc.communicate(timeout=900)[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the parent's {name}.cu:\n"
                               f"{log[-3000:]}")
        for kernel, used in _ptxas_kernels(log):
            print(f"[ptxas:parent] {name}: {kernel}: {used}")
        _PARENT[name] = ctypes.CDLL(str(lib))


def _parent_decode(name, q, pools, bt, ctx):
    """The parent's decode entry on these inputs (the split-K entry of this
    tree's signature: a workspace sized by the same split plan)."""
    import ctypes

    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import decode_attention as DA
    from paddle_tpu_torch.ops.kernels import quantized_attention as QA
    int8 = name == "quantized_attention"
    fn = getattr(_PARENT[name], "ptt_decode_attention_int8" if int8
                 else "ptt_decode_attention")
    fn.argtypes = QA._DECODE_ARGS if int8 else DA._ARGS
    fn.restype = ctypes.c_int
    b, h, d = q.shape
    _, page, h_kv, _ = pools[0].shape
    out = torch.empty_like(q)
    ws = DA.workspace(q, DA.split_plan(b, h, h_kv, bt.shape[1], page)[0])
    _build.check(fn(*[_build.ptr(t) for t in (q, *pools, bt, ctx, out)],
                    _build.ptr_or_null(ws), b, h, h_kv, d, page, bt.shape[1],
                    1.0 / math.sqrt(d), _build.dtype_code(q),
                    _build.stream(q)), f"parent {name}")
    return out


def _parent_ragged(int8, q, pools, bt, ctx, ql):
    """The parent's ragged entry on these inputs, float or int8 pages: its
    tensor-core kernel where it has one (ragged_sm90) and the tree's route
    takes it, else its SIMT kernel."""
    import ctypes

    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import quantized_attention as QA
    from paddle_tpu_torch.ops.kernels import ragged_attention as RA
    c, q_max, h, d = q.shape
    n, page, h_kv, _ = pools[0].shape
    sm90 = "ragged_sm90" in _PARENT and RA.route(q, page) == "sm90"
    lib = _PARENT["ragged_sm90"] if sm90 else \
        _PARENT["quantized_attention" if int8 else "ragged_attention"]
    fn = getattr(lib, "ptt_ragged_attention" + ("_int8" if int8 else "")
                 + ("_sm90" if sm90 else ""))
    fn.argtypes = QA._RAGGED_ARGS if int8 else RA._ARGS
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    _build.check(fn(*[_build.ptr(t) for t in (q, *pools, bt, ctx, ql, out)],
                    c, q_max, h, h_kv, d, page, bt.shape[1],
                    n if sm90 else RA.tile_queries(q_max, h // h_kv),
                    1.0 / math.sqrt(d), _build.dtype_code(q),
                    _build.stream(q)), "parent ragged attention")
    return out


def _parent_rms(x, w, eps):
    import ctypes

    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels.rms_norm import _ARGS
    fn = _PARENT["rms_norm"].ptt_rms_norm
    fn.argtypes, fn.restype = _ARGS, ctypes.c_int
    h = x.shape[-1]
    out = torch.empty_like(x)
    _build.check(fn(_build.ptr(x), _build.ptr(w), _build.ptr(out),
                    x.numel() // h, h, float(eps), _build.dtype_code(x),
                    _build.dtype_code(w), _build.stream(x)), "parent rms_norm")
    return out


def _parent_rope(x, cos, sin):
    """The parent's RoPE entry (one tensor, [S, D] tables) on x: its
    ``ptt_rope`` (the tree's signature) or, in older parents,
    ``ptt_fused_rope``."""
    import ctypes

    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import rope as RP
    b, s, h, d = x.shape
    out = torch.empty_like(x)
    lib = _PARENT["rope"]
    if hasattr(lib, "ptt_rope"):
        fn = lib.ptt_rope
        fn.argtypes, fn.restype = RP._ARGS, ctypes.c_int
        null, vec = ctypes.c_void_p(None), ctypes.c_int(0)
        _build.check(fn(_build.ptr(x), null, _build.ptr(out), null,
                        _build.ptr(cos), _build.ptr(sin), b * s, s, h, 0, d,
                        0, 0, _build.dtype_code(x), _build.dtype_code(cos),
                        ctypes.byref(vec), _build.stream(x)), "parent rope")
        return out
    fn = lib.ptt_fused_rope
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + \
        [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(fn(_build.ptr(x), _build.ptr(cos), _build.ptr(sin),
                    _build.ptr(out), b * s * h, s, h, d, _build.dtype_code(x),
                    _build.dtype_code(cos), _build.stream(x)), "parent rope")
    return out


def _flat(out):
    """A result or a tuple of results as one flat tensor."""
    if isinstance(out, tuple):
        return torch.cat([t.flatten() for t in out])
    return out


def _with_parent(run, parent, name, want):
    """{"ms": the kernel's time} -- with the parent's build loaded, both
    timed in the order parent, kernel, kernel, parent (each the mean of
    the two), plus the parent's time and its error against the plain
    version (printed, not held: the parent is not under test)."""
    if name not in _PARENT:
        return {"ms": _time_ms(run)}
    err = _max_err(_flat(parent()), want)
    torch.cuda.synchronize()
    p1, k1, k2, p2 = (_time_ms(f) for f in (parent, run, run, parent))
    return {"ms": (k1 + k2) / 2, "parent_ms": (p1 + p2) / 2,
            "parent_abba": (p1, k1, k2, p2), "parent_err": err}


def check_swiglu(K, dev, dtype, rng, t=1024, f=11008):
    g = torch.from_numpy(rng.standard_normal(
        (t, f), dtype=np.float32)).to(dev, dtype)
    u = torch.from_numpy(rng.standard_normal(
        (t, f), dtype=np.float32)).to(dev, dtype)
    got = K.swiglu(g, u)
    want = K.swiglu_plain(g, u)
    torch.cuda.synchronize()
    return {"got": got, "want": want, "err": _max_err(got, want),
            "flops": 5 * g.numel(), "bytes": 3 * g.numel() * g.element_size(),
            "ms": _time_ms(lambda: K.swiglu(g, u)),
            "plain_ms": _time_ms(lambda: K.swiglu_plain(g, u)),
            "library_ms": None}


def _causal_pairs(s_q, s_k):
    """Visible (query, key) pairs of one head under the bottom-right
    causal mask."""
    off = s_k - s_q
    return sum(max(0, min(i + off + 1, s_k)) for i in range(s_q))


def _p_dtype(dtype, q=None):
    """The rounding of P and dS in the flash kernel of this type (and of
    q's route, when q is given): the tensor-core kernels (16-bit inputs,
    D 64 or 128) round them to the input type where the TPU kernel does;
    the SIMT kernels (float32, and 16-bit inputs of other head dims, such
    as the UNet's D = 32) keep them float32."""
    if q is not None:
        from paddle_tpu_torch.ops.kernels.flash_attention import route
        if route(q) == "simt":
            return None
    return None if dtype == torch.float32 else dtype


def _sdpa(q, k, v, causal, dense=None):
    """PyTorch's scaled_dot_product_attention on [B, H, S, D] views of
    paddle-layout tensors: is_causal where S_q = S_k and no mask is given,
    else a dense bool mask (bottom-right causal when none is given)."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    s_q, s_k = q.shape[1], k.shape[1]
    gqa = q.shape[2] != k.shape[2]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if dense is None and causal and s_q != s_k:
        dense = torch.ones(s_q, s_k, dtype=torch.bool,
                           device=q.device).tril(s_k - s_q)
    if dense is None:
        return sdpa(qt, kt, vt, is_causal=causal, enable_gqa=gqa)
    return sdpa(qt, kt, vt, attn_mask=dense, enable_gqa=gqa)


def _accuracy_fwd(K, q, k, v, got, causal, bounds=None, dense=None):
    """(kernel's, library's) largest error against the float32 plain
    version on float32 copies of the inputs, over the rows that see a key
    (SDPA gives NaN where a row sees none)."""
    want, lse = K.flash_attention_fwd_plain(q.float(), k.float(), v.float(),
                                            causal, None, bounds)
    seen = (lse > -1e29).transpose(1, 2)[..., None]
    lib = _sdpa(q, k, v, causal, dense).transpose(1, 2)

    def err(a):
        return float(torch.where(seen, (a.float() - want).abs(), 0.0).max())
    return err(got), err(lib)


def _accuracy_bwd(K, q, k, v, do, got, causal, bounds=None, dense=None,
                  library=True):
    """(kernel's, library's) largest errors of dq, dk, dv against the
    float32 plain backward on float32 copies of the inputs (out and lse
    from the float32 plain forward). The library's gradients: SDPA's
    backward under autograd after its own forward (None without a
    library)."""
    f = [x.float() for x in (q, k, v, do)]
    out32, lse32 = K.flash_attention_fwd_plain(*f[:3], causal, None, bounds)
    want = K.flash_attention_bwd_plain(*f[:3], out32, lse32, f[3], causal,
                                       None, bounds)
    del out32, lse32, f
    kerr = [_max_err(a, r) for a, r in zip(got, want)]
    lerr = None
    if library:
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        o = _sdpa(*leaves, causal, dense)
        grads = torch.autograd.grad(o, leaves, do.transpose(1, 2))
        lerr = [_max_err(g, r) for g, r in zip(grads, want)]
    return kerr, lerr


def check_flash(K, dev, dtype, rng, b, s_q, s_k, h, h_kv, d=128,
                library=True, causal=True):
    """Flash attention (causal unless told otherwise) against its plain
    version, rounding P where the kernel of this type does. The library call is PyTorch's
    scaled_dot_product_attention on [B, H, S, D] views (its causal mask is
    top-left aligned, so it is timed only where S_q = S_k; its accuracy,
    beside the kernel's, against the float32 plain version, is taken with
    a bottom-right bool mask where S_q != S_k)."""
    q = torch.from_numpy(rng.standard_normal(
        (b, s_q, h, d), dtype=np.float32)).to(dev, dtype)
    k = torch.from_numpy(rng.standard_normal(
        (b, s_k, h_kv, d), dtype=np.float32)).to(dev, dtype)
    v = torch.from_numpy(rng.standard_normal(
        (b, s_k, h_kv, d), dtype=np.float32)).to(dev, dtype)
    got, lse = K.flash_attention_fwd(q, k, v, causal=causal)
    pd = _p_dtype(dtype, q)
    want, want_lse = K.flash_attention_fwd_plain(q, k, v, causal=causal,
                                                 p_dtype=pd)
    torch.cuda.synchronize()
    blind = max(0, s_q - s_k) if causal else 0   # rows that see no key
    if blind and float(got[:, :blind].float().abs().max()) != 0.0:
        raise AssertionError("flash: rows with no visible key are not 0")
    finite = want_lse > -1e29
    lse_err = float((lse - want_lse)[finite].abs().max())
    if lse_err > 1e-3 or not bool((lse[~finite] <= -1e29).all()):
        raise AssertionError(f"flash: lse disagrees with the plain version "
                             f"(max abs err {lse_err})")
    acc = None if pd is None else _accuracy_fwd(K, q, k, v, got, causal)
    elt = q.element_size()
    lib = None
    if library and (s_q == s_k or not causal):
        lib = _time_ms(lambda: _sdpa(q, k, v, causal))
    pairs = _causal_pairs(s_q, s_k) if causal else s_q * s_k
    from paddle_tpu_torch.ops.kernels.flash_attention import route
    return {"got": got, "want": want, "err": _max_err(got, want),
            "lse_err": lse_err, "acc": acc, "route": route(q),
            "flops": 4 * b * h * d * pairs,
            "bytes": (2 * q.numel() + 2 * k.numel()) * elt + lse.numel() * 4,
            "ms": _time_ms(lambda: K.flash_attention_fwd(q, k, v,
                                                         causal=causal)),
            "plain_ms": _time_ms(lambda: K.flash_attention_fwd_plain(
                q, k, v, causal=causal, p_dtype=pd), ITERS // 10),
            "library_ms": lib}


def _rounding_terms(K, q, k, v, out, lse, do, causal, bounds=None):
    """For each element of dq, dk and dv, the sum of the absolute terms of
    the product the 16-bit kernels take it from, over the operand they
    round: scale |dS| |K|, scale |dS|^T |Q| and P^T |dO| (float32, the
    plain backward's P and dS)."""
    from paddle_tpu_torch.ops.kernels.flash_attention import _visible
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    rep = h // h_kv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, s_q, h_kv, rep, d).float()
    dog = do.reshape(b, s_q, h_kv, rep, d).float()
    delta = (dog * out.reshape(b, s_q, h_kv, rep, d).float()).sum(-1)
    p = torch.exp(torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * scale -
                  lse.reshape(b, h_kv, rep, s_q, 1))
    vis = _visible(b, s_q, s_k, h_kv, rep, causal, bounds, q.device)
    if vis is not None:
        p = p.masked_fill(~vis, 0.0)
    ds = torch.einsum("bqgrd,bkgd->bgrqk", dog, v.float())
    ds = (p * (ds - delta.permute(0, 2, 3, 1)[..., None])).abs_()
    tq = torch.einsum("bgrqk,bkgd->bqgrd", ds, k.float().abs()) * scale
    tk = torch.einsum("bgrqk,bqgrd->bkgd", ds, qg.abs()) * scale
    del ds
    tv = torch.einsum("bgrqk,bqgrd->bkgd", p, dog.abs())
    return tq.reshape(b, s_q, h, d), tk, tv


def check_flash_bwd(K, dev, dtype, rng, b, s_q, s_k, h, h_kv, d=128,
                    library=True, causal=True):
    """The flash backward (causal unless told otherwise) against its plain
    version (rounding P and dS where the kernel of this type does) on the
    same q, k, v, dout and the forward kernel's out and lse. The library
    call is PyTorch's backward of the same function: aten's flash
    attention backward (aten._scaled_dot_product_flash_attention_backward,
    on [B, H, S, D] views, after its own forward) where S_q = S_k without
    GQA, SDPA's backward with enable_gqa under autograd under GQA; a
    yardstick the port never calls."""
    q, do = (torch.from_numpy(rng.standard_normal(
        (b, s_q, h, d), dtype=np.float32)).to(dev, dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal(
        (b, s_k, h_kv, d), dtype=np.float32)).to(dev, dtype)
        for _ in range(2))
    out, lse = K.flash_attention_fwd(q, k, v, causal=causal)
    got = K.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    pd = _p_dtype(dtype, q)
    want = K.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                       p_dtype=pd)
    torch.cuda.synchronize()
    terms = None if pd is None else _rounding_terms(K, q, k, v, out, lse, do,
                                                    causal)
    res = _grad_rule(got, want, terms)
    if terms is not None:
        # the rule must reject a kernel wrong by one typical value on a
        # tail of keys (one rms added to dk's last 10% of keys) or of
        # queries (to dq's last 10%)
        for i, what, s_x in ((1, "dk", s_k), (0, "dq", s_q)):
            bad = list(got)
            bad[i] = got[i].float()
            bad[i][:, -max(1, s_x // 10):] += res["rms"][i]
            tail = _grad_rule(bad, want, terms)
            passed, _ = _within("flash_attention_bwd", tail, dtype)
            print(f"[kernels] flash_attention_bwd rule on {what} with one "
                  f"rms added to its last 10% of "
                  f"{'keys' if i else 'queries'}: elements beyond "
                  f"{tail['over_n'][i]} (allowed "
                  f"{_over_allowed(tail['n'][i])}), err/bound "
                  f"{tail['bound'][i]:.1f} (must fail)", flush=True)
            if passed:
                raise AssertionError(f"flash_attention_bwd: the 16-bit rule "
                                     f"does not reject a wrong tail of "
                                     f"{what}")
            del bad, tail
    del terms
    # the library: aten's flash backward where it applies, else SDPA's
    # (blind rows give NaN in SDPA: no library there)
    acc = None
    if pd is not None:
        acc = _accuracy_bwd(K, q, k, v, do, got, causal,
                            library=s_q <= s_k)
    elt = q.element_size()
    lib = None
    if library:
        lib = _library_flash_bwd(q, k, v, do, causal)
    from paddle_tpu_torch.ops.kernels.flash_attention import route
    pairs = _causal_pairs(s_q, s_k) if causal else s_q * s_k
    res.update({
        "got": got, "want": want, "acc": acc, "route": route(q),
        # five products over the visible pairs: S, dP, dV, dQ, dK
        "flops": 10 * b * h * d * pairs,
        # q, out, dout and k, v read, lse read, dq, dk, dv written
        "bytes": (4 * q.numel() + 4 * k.numel()) * elt + lse.numel() * 4,
        "ms": _time_ms(lambda: K.flash_attention_bwd(
            q, k, v, out, lse, do, causal=causal)),
        "plain_ms": _time_ms(lambda: K.flash_attention_bwd_plain(
            q, k, v, out, lse, do, causal=causal, p_dtype=pd), ITERS // 10),
        "library_ms": lib})
    return res


def _library_flash_bwd(q, k, v, do, causal=True):
    """ms of PyTorch's backward of attention (causal unless told
    otherwise) at this shape: aten's flash attention backward without
    GQA, SDPA's backward with enable_gqa under autograd with it; None
    (printed) when this PyTorch build refuses the call."""
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    try:
        if q.shape[2] != k.shape[2]:
            leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
            o = torch.nn.functional.scaled_dot_product_attention(
                *leaves, is_causal=causal, enable_gqa=True)
            return _time_ms(lambda: torch.autograd.grad(
                o, leaves, dot, retain_graph=True))
        fw = torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, causal, False)
        bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
        args = (dot, qt, kt, vt, fw[0], fw[1], fw[2], fw[3], fw[4], fw[5],
                0.0, causal, fw[6], fw[7])
        return _time_ms(lambda: bwd(*args))
    except (RuntimeError, TypeError) as e:
        print(f"[kernels] library flash backward not timed: "
              f"{type(e).__name__}: {str(e)[:200]}")
        return None


def _flashmask_case(rng, dev, b, s, h, h_kv, form):
    """Bounds of one flashmask form at [B, S] (query length = key length):
    "doc" packs documents of seeded lengths 64-1024 into each row, causal
    with start[t] = the end of t's document (1 bound, one row for all
    heads); "gqa" per-KV-head causal 2-bound intervals [start, end) below
    the diagonal; "bidir" per-head bidirectional 4 bounds; "window" causal
    window_size=256 through F._window_to_indices. Returns (causal, bounds
    (start, end, start2, end2) as the kernel takes them, the dense bool
    mask [B, kh or H, S, S] (True = attend, for SDPA), visible pairs)."""
    from paddle_tpu_torch.nn import functional as F

    col = np.arange(s)
    if form == "doc":
        causal, kh = True, 1
        start = np.empty((b, 1, s), np.int64)
        for i in range(b):
            pos = 0
            while pos < s:
                end = min(s, pos + int(rng.integers(64, 1025)))
                start[i, 0, pos:end] = end
                pos = end
        idx = start[..., None]
    elif form == "gqa":
        causal, kh = True, h_kv
        st = np.minimum(s, col + rng.integers(1, 513, (b, kh, s)))
        en = np.minimum(s, st + rng.integers(0, 1025, (b, kh, s)))
        idx = np.stack([st, en], -1)
    elif form == "bidir":
        causal, kh = False, h
        shp = (b, kh, s)
        lts = np.maximum(rng.integers(1, s + 1, shp), col + 1)
        lte = np.minimum(lts + rng.integers(0, s // 2, shp), s)
        ute = np.minimum(rng.integers(0, s, shp), col)
        uts = np.maximum(ute - rng.integers(0, s // 2, shp), 0)
        idx = np.stack([lts, lte, uts, ute], -1)
    else:
        causal = True
        idx = F._window_to_indices(256, b, s, s, True, "cpu").numpy()
        kh = 1
    idx = torch.from_numpy(idx.astype(np.int32)).to(dev)
    bounds = tuple(None if t is None else t.contiguous()
                   for t in F._flashmask_intervals(idx, causal, s))
    rows = torch.arange(s, device=dev)[None, None, :, None]
    ms, me, ms2, me2 = bounds
    masked = (ms[:, :, None, :] <= rows) & (rows < me[:, :, None, :])
    if ms2 is not None:
        masked |= (ms2[:, :, None, :] <= rows) & (rows < me2[:, :, None, :])
    dense = ~masked
    del masked
    if causal:
        dense &= torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    if kh == h_kv and h_kv != h:
        dense = dense.repeat_interleave(h // h_kv, dim=1)
    pairs = int(dense.sum()) * (h // dense.shape[1])
    return causal, bounds, dense, pairs


def _bounds_bytes(bounds):
    return sum(t.numel() * 4 for t in bounds if t is not None)


def check_flashmask(K, dev, dtype, rng, b, s, h, h_kv, form, d=128,
                    library=True):
    """The masked flash forward against its plain version; the library
    call is SDPA with the dense boolean mask (built outside the timed
    region; a yardstick the port never calls)."""
    causal, bounds, dense, pairs = _flashmask_case(rng, dev, b, s, h, h_kv,
                                                   form)
    q = torch.from_numpy(rng.standard_normal(
        (b, s, h, d), dtype=np.float32)).to(dev, dtype)
    k, v = (torch.from_numpy(rng.standard_normal(
        (b, s, h_kv, d), dtype=np.float32)).to(dev, dtype) for _ in range(2))
    got, lse = K.flashmask_attention_fwd(q, k, v, *bounds, causal=causal)
    pd = _p_dtype(dtype)
    want, want_lse = K.flashmask_attention_fwd_plain(q, k, v, *bounds,
                                                     causal=causal,
                                                     p_dtype=pd)
    torch.cuda.synchronize()
    acc = None if pd is None else _accuracy_fwd(K, q, k, v, got, causal,
                                                bounds, dense)
    seen = want_lse > -1e29
    lse_err = float((lse - want_lse)[seen].abs().max())
    if lse_err > 1e-3 or not bool((lse[~seen] <= -1e29).all()):
        raise AssertionError(f"flashmask {form}: lse disagrees with the "
                             f"plain version (max abs err {lse_err})")
    elt = q.element_size()
    lib = None
    if library:
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = _time_ms(lambda: sdpa(qt, kt, vt, attn_mask=dense,
                                    enable_gqa=h != h_kv))
    del dense
    return {"got": got, "want": want, "err": _max_err(got, want),
            "lse_err": lse_err, "pairs": pairs, "acc": acc,
            "flops": 4 * d * pairs,
            "bytes": (2 * q.numel() + 2 * k.numel()) * elt +
            lse.numel() * 4 + _bounds_bytes(bounds),
            "ms": _time_ms(lambda: K.flashmask_attention_fwd(
                q, k, v, *bounds, causal=causal)),
            "plain_ms": _time_ms(lambda: K.flashmask_attention_fwd_plain(
                q, k, v, *bounds, causal=causal, p_dtype=pd), ITERS // 10),
            "library_ms": lib}


def _grad_rule(got, want, terms=None):
    """The flash backward's checks over (dq, dk, dv): max errors, largest
    values, mean, rms and the worst err / (2^-7 |want| + 2^-8 rms(want));
    with the rounded products' absolute term sums (``_rounding_terms``),
    also the share of elements beyond that allowance and the worst err /
    (the allowance + 2^-7 terms)."""
    out = {"errs": [], "scales": [], "means": [], "rms": [], "worst": [],
           "over": [], "over_n": [], "n": [], "bound": []}
    for i, (a, r) in enumerate(zip(got, want)):
        r = r.float()
        rms = float(r.square().mean().sqrt())
        allow = BWD_REL_BF16 * r.abs() + BWD_FLOOR_BF16 * rms
        err = (a.float() - r).abs()
        out["errs"].append(float(err.max()))
        out["scales"].append(float(r.abs().max()))
        out["means"].append(float(r.abs().mean()))
        out["rms"].append(rms)
        out["worst"].append(float((err / allow).max()))
        if terms is not None:
            over_n = int((err > allow).sum())
            out["over_n"].append(over_n)
            out["n"].append(err.numel())
            out["over"].append(over_n / err.numel())
            out["bound"].append(float(
                (err / (allow + BWD_REL_BF16 * terms[i].float())).max()))
    out["err"] = max(out["errs"])
    return out


def check_flashmask_bwd(K, dev, dtype, rng, b, s, h, h_kv, form, d=128,
                        library=True):
    """The masked flash backward against its plain version on the same q,
    k, v, dout, bounds and the forward kernel's out and lse. The library
    call is the backward alone of SDPA with the dense boolean mask
    (autograd.grad after one forward, retain_graph)."""
    causal, bounds, dense, pairs = _flashmask_case(rng, dev, b, s, h, h_kv,
                                                   form)
    q, do = (torch.from_numpy(rng.standard_normal(
        (b, s, h, d), dtype=np.float32)).to(dev, dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal(
        (b, s, h_kv, d), dtype=np.float32)).to(dev, dtype) for _ in range(2))
    out, lse = K.flashmask_attention_fwd(q, k, v, *bounds, causal=causal)
    got = K.flashmask_attention_bwd(q, k, v, out, lse, do, *bounds,
                                    causal=causal)
    pd = _p_dtype(dtype)
    want = K.flashmask_attention_bwd_plain(q, k, v, out, lse, do, *bounds,
                                           causal=causal, p_dtype=pd)
    torch.cuda.synchronize()
    res = _grad_rule(got, want, None if pd is None else _rounding_terms(
        K, q, k, v, out, lse, do, causal, bounds))
    # the library (SDPA with the dense mask) gives NaN on rows that see no
    # key: its accuracy is taken only where every row sees one
    acc = None if pd is None else _accuracy_bwd(
        K, q, k, v, do, got, causal, bounds, dense,
        library=bool(dense.any(-1).all()))
    elt = q.element_size()
    lib = None
    if library:
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        o = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=dense, enable_gqa=h != h_kv)
        dot = do.transpose(1, 2)
        lib = _time_ms(lambda: torch.autograd.grad(
            o, (qt, kt, vt), dot, retain_graph=True))
        del o
    del dense
    res.update({
        "got": got, "want": want, "pairs": pairs, "acc": acc,
        "flops": 10 * d * pairs,     # S, dP, dV, dQ, dK over visible pairs
        "bytes": (4 * q.numel() + 4 * k.numel()) * elt + lse.numel() * 4 +
        _bounds_bytes(bounds),
        "ms": _time_ms(lambda: K.flashmask_attention_bwd(
            q, k, v, out, lse, do, *bounds, causal=causal)),
        "plain_ms": _time_ms(lambda: K.flashmask_attention_bwd_plain(
            q, k, v, out, lse, do, *bounds, causal=causal, p_dtype=pd),
            ITERS // 10),
        "library_ms": lib})
    return res


def check_bdrln(K, dev, dtype, rng, rows, h, p, eps=1e-12):
    """bias + dropout + residual + LayerNorm against its plain version: y
    within one bf16 rounding (float32: 1e-4; it is expected bit-equal),
    the keep mask equal bit for bit, the keep rate within 5 sigma of
    1 - p, and out (bf16) within one bf16 ulp plus 2^-16 of its terms,
    |n w| + |b| (n the normalized value): out = n w + b cancels where
    n w ~ -b, and there the float32 means and variances of the two sides,
    summed in other orders, differ by ~1e-7 of the terms, more than a bf16
    ulp of a small result. No single PyTorch call computes this; the
    composition F.layer_norm(residual + F.dropout(x + bias)) is timed
    beside it (printed, not a library time)."""
    f = torch.nn.functional
    x, r = (torch.from_numpy(rng.standard_normal(
        (rows, h), dtype=np.float32)).to(dev, dtype) for _ in range(2))
    w, bb, bias = (torch.from_numpy(rng.standard_normal(
        (h,), dtype=np.float32)).to(dev, dtype) for _ in range(3))
    seed = int(rng.integers(0, 2 ** 31 - 1))
    out, y, keep = K.bias_dropout_residual_ln(x, r, w, bb, bias, eps, p,
                                              seed)
    w_out, w_y, w_keep = K.bias_dropout_residual_ln_plain(x, r, w, bb, bias,
                                                          eps, p, seed)
    torch.cuda.synchronize()
    if p > 0.0:
        if not torch.equal(keep, w_keep):
            raise AssertionError("bdrln: the kernel's keep mask differs from "
                                 "the plain Philox mask")
        rate = float(keep.float().mean())
        sigma = (p * (1 - p) / keep.numel()) ** 0.5
        if abs(rate - (1 - p)) > 5 * sigma:
            raise AssertionError(f"bdrln: keep rate {rate} not within 5 "
                                 f"sigma of {1 - p}")
    elif keep is not None or w_keep is not None:
        raise AssertionError("bdrln: p = 0 wrote a keep mask")
    y_ok = bool(((y.float() - w_y.float()).abs() <=
                 (_ulp_bf16(w_y.float()) if dtype != torch.float32 else
                  1e-4)).all())
    if not y_ok:
        raise AssertionError("bdrln: y differs from the plain version by "
                             "more than one rounding")
    want = w_out.float()
    allow = _ulp_bf16(want) + 2.0 ** -16 * ((want - bb.float()).abs() +
                                           bb.float().abs())
    worst = float(((out.float() - want).abs() / allow).max())
    comp = _time_ms(lambda: f.layer_norm(
        r + f.dropout(x + bias, p), (h,), w, bb, eps))
    elt = x.element_size()
    n = x.numel()
    return {"got": out, "want": w_out, "err": _max_err(out, w_out),
            "y_err": _max_err(y, w_y), "worst": worst,
            "keep_rate": float(keep.float().mean()) if keep is not None
            else 1.0,
            "composition_ms": comp,
            "flops": 10 * n,
            # x, residual read; out, y written; the mask byte when p > 0;
            # bias, w, b read once
            "bytes": 4 * n * elt + (n if p > 0.0 else 0) + 3 * h * elt,
            "ms": _time_ms(lambda: K.bias_dropout_residual_ln(
                x, r, w, bb, bias, eps, p, seed)),
            "plain_ms": _time_ms(lambda: K.bias_dropout_residual_ln_plain(
                x, r, w, bb, bias, eps, p, seed)),
            "library_ms": None}


def _rope_path(run, counter):
    """The path ("vector" or "scalar") that `run`, one RoPE launch
    counted on `counter` (K.fused_rope or K.fused_rope_bwd), takes."""
    before = counter.scalar_launches
    run()
    return "scalar" if counter.scalar_launches > before else "vector"


def check_rope(K, dev, dtype, rng, b=4, s=256, h=32, d=128):
    """RoPE of one tensor with float32 [S, D] tables; by default on the
    dense admission's q, [4, 256, 32, 128]. The parent: its kernel."""
    x = torch.from_numpy(rng.standard_normal(
        (b, s, h, d), dtype=np.float32)).to(dev, dtype)
    cos = torch.from_numpy(rng.standard_normal(
        (s, d), dtype=np.float32)).to(dev)
    sin = torch.from_numpy(rng.standard_normal(
        (s, d), dtype=np.float32)).to(dev)
    got = K.fused_rope(x, cos, sin)
    want = K.fused_rope_plain(x, cos, sin)
    torch.cuda.synchronize()

    def run():
        return K.fused_rope(x, cos, sin)

    return {"got": got, "want": want, "err": _max_err(got, want),
            "flops": 3 * x.numel(),
            "bytes": 2 * x.numel() * x.element_size() + 2 * cos.numel() * 4,
            **_with_parent(run, lambda: _parent_rope(x, cos, sin), "rope",
                           want),
            "plain_ms": _time_ms(lambda: K.fused_rope_plain(x, cos, sin)),
            "library_ms": None, "route": _rope_path(run, K.fused_rope)}


def check_rope_qk(K, dev, dtype, rng, b, s, hq, hk, d=128, rows=False,
                  bwd=False, table_dtype=torch.float32):
    """q [b, s, hq, d] and k [b, s, hk, d] in one launch of the RoPE
    kernel: forward with [S, D] tables, or (rows) with per-token rows
    ([b, d] when s = 1, the decode step's; else [b, s, d], the ragged
    chunk's), or (bwd) the transposed form on two gradients. Held against
    the plain versions on q and on k. The parent: its kernel on q and on k
    (two launches); for the rows forms the parent tree's plain _rope_rows
    on q and on k, and for the backward its plain backward on each (the
    parent had no kernel for these)."""
    q = torch.from_numpy(rng.standard_normal(
        (b, s, hq, d), dtype=np.float32)).to(dev, dtype)
    k = torch.from_numpy(rng.standard_normal(
        (b, s, hk, d), dtype=np.float32)).to(dev, dtype)
    shape = ((b, d) if s == 1 else (b, s, d)) if rows else (s, d)
    cos, sin = (torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(dev, table_dtype) for _ in range(2))
    if bwd:
        def run():
            return K.fused_rope_bwd(q, cos, sin, k)

        def plain():
            return (K.fused_rope_bwd_plain(q, cos, sin),
                    K.fused_rope_bwd_plain(k, cos, sin))
        parent, counter = plain, K.fused_rope_bwd
    else:
        one = K.fused_rope_rows_plain if rows else K.fused_rope_plain

        def run():
            return K.fused_rope_qk(q, k, cos, sin)

        def plain():
            return one(q, cos, sin), one(k, cos, sin)

        def parent():
            return _parent_rope(q, cos, sin), _parent_rope(k, cos, sin)
        if rows:
            parent = plain
        counter = K.fused_rope
    got, want = _flat(run()), _flat(plain())
    torch.cuda.synchronize()
    n = q.numel() + k.numel()
    return {"got": got, "want": want, "err": _max_err(got, want),
            "flops": 3 * n,
            "bytes": 2 * n * q.element_size() +
            2 * cos.numel() * cos.element_size(),
            **_with_parent(run, parent, "rope", want),
            "plain_ms": _time_ms(plain), "library_ms": None,
            "route": _rope_path(run, counter)}


def _over_allowed(n):
    """Elements of a 16-bit flash gradient of n elements that may pass the
    per-element allowance (see _within)."""
    return max(math.ceil(BWD_OVER_SHARE * n), BWD_OVER_FLOOR)


def _within(name, res, dtype):
    """Tolerances: float32 1e-4 absolute for every kernel (the kernels and
    the plain versions sum in other orders); bfloat16 2e-2 absolute for
    attention (outputs of magnitude < 1, one bf16 rounding of each side)
    and one bf16 ulp of the plain result for the elementwise kernels
    (both round one float32 value that differs in its last bits; RoPE
    rounds in the same order on both sides and is expected exact). The
    flash backward's dq, dk and dv sum thousands of terms in float32 on
    both sides and round once. Their values fall off along the causal rows,
    so a typical |dq|, |dk|, |dv| (mean and rms, printed) lies far below
    the largest: in float32 each is held to 1e-4 of its own largest value
    (errors ~1e-6 of it); in bfloat16 each ELEMENT is held to 2^-7 of its
    own size (one bf16 rounding, up to 2^-7 relative, of two float32 values
    that differ in their last bits) plus a floor of 2^-8 of the tensor's
    rms (elements near zero, where the float32 sums cancel), so an error
    the size of a typical value anywhere fails.

    The 16-bit flash kernels (bfloat16, float16: the tensor-core route)
    round P and dS to the input type before the dV, dK and dQ products, as
    the TPU kernel does, and are held against the plain version that rounds
    at the same points (forward: 2e-2 absolute, as above). Both sides round
    float32 values that differ in their last bits, so where a value sits at
    a rounding midpoint the two take neighbouring 16-bit values: one term
    of the sum moves by one ulp, up to 2^-7 of itself. Such a flip can
    carry an element past the rule above where a few large terms cancel:
    flash_rounding_check.py shows the plain version itself, against a
    float64 version with the same roundings, past it on about one element
    in a million at [4, 2048, 16, 128], by up to 2x, while the kernels'
    float32 accumulation is exact to half an ulp. So in 16 bits at most
    max(ceil(BWD_OVER_SHARE n), BWD_OVER_FLOOR) of the n elements of each
    of dq, dk and dv may pass that allowance, and none may pass it plus
    2^-7 times the sum of its product's absolute terms over the rounded
    operand (scale |dS||K|, scale |dS|^T|Q|, P^T|dO|: every term flipped at
    once). The floor of a few elements is for small shapes, where a share
    of 1e-5 is one or two elements: at [2, 300, 8 -> 4, 64] the plain
    version against a float64 version with the same roundings passes the
    allowance on up to 3 elements of dq (flash_rounding_check.py --small).
    A kernel wrong by a typical value on a tenth of the keys, or by one
    rms on a tenth of dq's queries, still fails (checked on every run).
    Beside that, each 16-bit row holds the kernel's largest error against
    the float32 plain version (on float32 copies of the inputs) to at most
    LIB_ERR_FACTOR times the library call's (SDPA,
    or its backward) against the same: the redesign is to be as accurate
    as the library, which rounds P and dS to 16 bits too.

    The 16-bit ragged rows (the tensor-core route) are held element by
    element to 2^-7 |want| + 2^-8 rms(want's row over D) against the
    kernel's own walk (the same key tiles, P rounded at the same points),
    so that at 4096 keys, where a typical output is ~0.02, a dropped key
    tile still fails (checked on every run); against the float32-P plain
    version, to that plus half a 16-bit ulp of every rounded P term
    (check_ragged)."""
    if "tiled" in res:
        return res["tiled"] <= 1.0, ("<= 2^-7|want| + 2^-8 rms(row) of the "
                                     f"kernel's walk: worst "
                                     f"{res['tiled']:.3f}")
    if name in ("flash_attention_bwd", "flashmask_attention_bwd"):
        if dtype == torch.float32:
            ok = all(e <= 1e-4 * max(1.0, m)
                     for e, m in zip(res["errs"], res["scales"]))
            return ok, "<= 1e-4 of max|grad| per dq/dk/dv"
        if not res["over_n"]:
            # the SIMT route in 16 bits (the UNet's D = 32) keeps P and dS
            # float32 and rounds each gradient once, as the plain version
            return all(w <= 1.0 for w in res["worst"]), (
                "every element <= 2^-7|want| + 2^-8 rms(want) (SIMT: P "
                "and dS float32)")
        ok = all(c <= _over_allowed(n)
                 for c, n in zip(res["over_n"], res["n"])) and \
            all(w <= 1.0 for w in res["bound"])
        return ok, (f"<= 2^-7|want| + 2^-8 rms(want) but for <= "
                    f"max(ceil({BWD_OVER_SHARE:g} n), {BWD_OVER_FLOOR}) "
                    f"elements; all <= that + 2^-7 sum|terms|")
    if dtype == torch.float32:
        return res["err"] <= TOL[dtype], f"<= {TOL[dtype]}"
    if name == "bias_dropout_residual_ln":
        return res["worst"] <= 1.0, ("<= 1 bf16 ulp + 2^-16 (|n w| + |b|); "
                                     f"worst ratio {res['worst']:.3f}")
    if name in ("rms_norm", "swiglu", "fused_rope", "fused_rope_bwd"):
        want = res["want"].float()
        ok = bool(((res["got"].float() - want).abs()
                   <= _ulp_bf16(want)).all())
        return ok, "<= 1 bf16 ulp"
    return res["err"] <= TOL[dtype], f"<= {TOL[dtype]}"


class _ViaOp:
    """A kernel wrapper called through its custom op (``torch.ops.ptt``,
    ``ops.kernels._ops``), the route every model takes; its counters and
    other attributes are the wrapper's."""

    def __init__(self, wrapper, call):
        self.__dict__["_wrapper"] = wrapper
        self.__dict__["_call"] = call

    def __call__(self, *args, **kwargs):
        return self._call(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._wrapper, name)


class _KernelsViaOps:
    """``ops.kernels`` with each kernel that has a custom op reached
    through it (the wrappers' signatures kept); everything else is the
    module's."""

    def __init__(self, K):
        from paddle_tpu_torch.ops.kernels import _ops as O
        self._K = K

        def bdrln(x, residual, ln_w, ln_b, bias=None, eps=1e-5, p=0.0,
                  seed=0):
            out, y, keep = O.bias_dropout_residual_ln_op(
                x, residual, ln_w, ln_b, bias, float(eps), float(p),
                int(seed))
            return out, y, keep if keep.numel() else None

        def rope_bwd(g, cos, sin, g_k=None):
            if g_k is None:
                return O.fused_rope_bwd_op(g, cos, sin)
            return O.fused_rope_qk_bwd_op(g, g_k, cos, sin)

        calls = {
            "rms_norm": lambda x, w, eps=1e-6: O.rms_norm_op(
                x, w, float(eps)),
            "swiglu": O.swiglu_op,
            "fused_rope": O.fused_rope_op,
            "fused_rope_qk": O.fused_rope_qk_op,
            "fused_rope_bwd": rope_bwd,
            "flash_attention_fwd": lambda q, k, v, causal=False, scale=None:
                O.flash_attention_fwd_op(q, k, v, bool(causal), scale),
            "flash_attention_bwd": lambda q, k, v, out, lse, dout,
                causal=False, scale=None: O.flash_attention_bwd_op(
                    q, k, v, out, lse, dout, bool(causal), scale),
            "flashmask_attention_fwd": lambda q, k, v, start, end,
                start2=None, end2=None, causal=True, scale=None:
                O.flashmask_attention_fwd_op(q, k, v, start, end, start2,
                                             end2, bool(causal), scale),
            "flashmask_attention_bwd": lambda q, k, v, out, lse, dout,
                start, end, start2=None, end2=None, causal=True,
                scale=None: O.flashmask_attention_bwd_op(
                    q, k, v, out, lse, dout, start, end, start2, end2,
                    bool(causal), scale),
            "bias_dropout_residual_ln": bdrln,
        }
        self._ops = {n: _ViaOp(getattr(K, n), c) for n, c in calls.items()}

    def __getattr__(self, name):
        ops = self.__dict__.get("_ops", {})
        return ops[name] if name in ops else getattr(self._K, name)


def phase_kernels(K, dev):
    """Every kernel against its plain version at the serving shapes, in
    bf16 and f32, each kernel with a custom op called through it. Returns
    {name: bf16 record} for the JSON line."""
    K = _KernelsViaOps(K)
    rng = np.random.default_rng(0)
    rng8 = np.random.default_rng(1)      # the int8 cases' own inputs
    # the ragged rows added with the tensor-core ragged kernel, drawing
    # apart so that every earlier row keeps its inputs
    rng_r = np.random.default_rng(3)
    # the RoPE kernel's forms added with its redesign, likewise apart
    rng_p = np.random.default_rng(4)
    # the speculative verify windows, likewise apart
    rng_v = np.random.default_rng(5)
    # GPT-3 1.3B's and BERT-base's shapes, likewise apart
    rng_g = np.random.default_rng(6)
    # the UNet's attention shapes, likewise apart
    rng_u = np.random.default_rng(7)
    out = {}
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        if dtype == torch.float16:
            # the tensor-core kernels' float16 instantiations
            cases = [
                ("flash_attention[f16]", lambda: check_flash(
                    K, dev, dtype, rng, 2, 512, 512, 16, 16)),
                ("flash_attention_bwd[f16]", lambda: check_flash_bwd(
                    K, dev, dtype, rng, 2, 512, 512, 16, 16)),
                ("ragged_paged_attention[f16]", lambda: check_ragged(
                    K, dev, dtype, 32, rng_r)),
                ("fused_rope[qk,gqa8]", lambda: check_rope_qk(
                    K, dev, dtype, rng_p, 4, 256, 32, 8)),
            ]
            _run_cases(cases, dtype, out)
            continue
        cases = [
            ("ragged_paged_attention", lambda: check_ragged(
                K, dev, dtype, 32, rng)),
            ("ragged_paged_attention[gqa8]", lambda: check_ragged(
                K, dev, dtype, 8, rng)),
            ("paged_decode_attention", lambda: check_decode(
                K, dev, dtype, rng)),
            ("paged_decode_attention[gqa8]", lambda: check_decode(
                K, dev, dtype, rng, h_kv=8)),
            ("rms_norm", lambda: check_rms(K, dev, dtype, rng)),
            ("swiglu", lambda: check_swiglu(K, dev, dtype, rng)),
            # the dense admission of the serve:dense run: c = 4 rows of 256
            ("flash_attention", lambda: check_flash(
                K, dev, dtype, rng, 4, 256, 256, 32, 32)),
            ("flash_attention[gqa8]", lambda: check_flash(
                K, dev, dtype, rng, 4, 256, 256, 32, 8)),
            ("flash_attention[s2048]", lambda: check_flash(
                K, dev, dtype, rng, 1, 2048, 2048, 32, 32)),
            ("fused_rope", lambda: check_rope(K, dev, dtype, rng)),
            # int8 pages: no single PyTorch call attends over paged int8
            # KV, so there is no library time
            ("ragged_paged_attention_int8", lambda: check_ragged(
                K, dev, dtype, 32, rng8, int8=True)),
            ("ragged_paged_attention_int8[gqa8]", lambda: check_ragged(
                K, dev, dtype, 8, rng8, int8=True)),
            ("paged_decode_attention_int8", lambda: check_decode(
                K, dev, dtype, rng8, int8=True)),
            ("paged_decode_attention_int8[gqa8]", lambda: check_decode(
                K, dev, dtype, rng8, h_kv=8, int8=True)),
            # contexts up to the engine's whole table (4096 tokens)
            ("paged_decode_attention[long]", lambda: check_decode(
                K, dev, dtype, rng, lens=LONG_LENS)),
            ("paged_decode_attention_int8[long]", lambda: check_decode(
                K, dev, dtype, rng8, int8=True, lens=LONG_LENS)),
            # the decode step's RMSNorm (65 launches a step at B = 4) and
            # a width that is no whole number of vectors (the scalar path)
            ("rms_norm[decode]", lambda: check_rms(K, dev, dtype, rng, 4,
                                                   4096)),
            ("rms_norm[odd]", lambda: check_rms(K, dev, dtype, rng, 37,
                                                333)),
            # 16 query heads a KV head: two row groups of 8 per page range
            ("paged_decode_attention[rep16]", lambda: check_decode(
                K, dev, dtype, rng, h_kv=2, lens=(300, 17), b=2,
                d=64, p_max=32)),
        ]
        if dtype == torch.bfloat16:
            # the tensor-core ragged kernel's edges: contexts up to the
            # engine's whole table, D = 64 (GQA 8 -> 4), a short window
            cases += [
                ("ragged_paged_attention[long]", lambda: check_ragged(
                    K, dev, dtype, 32, rng_r, rows=RAGGED_LONG)),
                ("ragged_paged_attention_int8[long]", lambda: check_ragged(
                    K, dev, dtype, 32, rng_r, int8=True, rows=RAGGED_LONG)),
                ("ragged_paged_attention[d64]", lambda: check_ragged(
                    K, dev, dtype, 4, rng_r, h=8, d=64)),
                ("ragged_paged_attention[q8]", lambda: check_ragged(
                    K, dev, dtype, 32, rng_r, rows=RAGGED_Q8, q_max=8)),
                ("ragged_paged_attention_int8[q8]", lambda: check_ragged(
                    K, dev, dtype, 32, rng_r, int8=True, rows=RAGGED_Q8,
                    q_max=8)),
                ("ragged_paged_attention[verify]", lambda: check_ragged(
                    K, dev, dtype, 32, rng_v, rows=RAGGED_VERIFY, q_max=8)),
                ("ragged_paged_attention_int8[verify]",
                 lambda: check_ragged(K, dev, dtype, 32, rng_v, int8=True,
                                      rows=RAGGED_VERIFY, q_max=8)),
                ("ragged_paged_attention[c40]", lambda: check_ragged(
                    K, dev, dtype, 8, rng_r, rows=RAGGED_C40, p_max=64)),
            ]
            # GPT-3 1.3B serving (16 heads = 16 KV heads of 128, the
            # engine's table of 128 pages of 16; its dense admission
            # [4, 256]) and BERT-base's encoder (non-causal, D = 64, batch
            # 8 x 512)
            cases += [
                ("paged_decode_attention[gpt]", lambda: check_decode(
                    K, dev, dtype, rng_g, h_kv=16, h=16, p_max=128)),
                ("paged_decode_attention_int8[gpt]", lambda: check_decode(
                    K, dev, dtype, rng_g, h_kv=16, int8=True, h=16,
                    p_max=128)),
                ("ragged_paged_attention[gpt]", lambda: check_ragged(
                    K, dev, dtype, 16, rng_g, h=16, p_max=128)),
                ("ragged_paged_attention_int8[gpt]", lambda: check_ragged(
                    K, dev, dtype, 16, rng_g, int8=True, h=16, p_max=128)),
                ("flash_attention[gpt,admit]", lambda: check_flash(
                    K, dev, dtype, rng_g, 4, 256, 256, 16, 16)),
                ("flash_attention[bert]", lambda: check_flash(
                    K, dev, dtype, rng_g, 8, 512, 512, 12, 12, d=64,
                    causal=False)),
            ]
            # the UNet's attention blocks ([train:unet], batch 16 of
            # 64x64 latents): non-causal, 4 heads of channels / 4; block
            # 1 at 32x32 = 1024 positions, D 32 (the SIMT route in bf16),
            # block 2 and the middle at 16x16 = 256, D 64 (tensor cores)
            cases += [
                ("flash_attention[unet32]", lambda: check_flash(
                    K, dev, dtype, rng_u, 16, 1024, 1024, 4, 4, d=32,
                    causal=False)),
                ("flash_attention[unet64]", lambda: check_flash(
                    K, dev, dtype, rng_u, 16, 256, 256, 4, 4, d=64,
                    causal=False)),
                ("flash_attention_bwd[unet32]", lambda: check_flash_bwd(
                    K, dev, dtype, rng_u, 16, 1024, 1024, 4, 4, d=32,
                    causal=False)),
                ("flash_attention_bwd[unet64]", lambda: check_flash_bwd(
                    K, dev, dtype, rng_u, 16, 256, 256, 4, 4, d=64,
                    causal=False)),
            ]
            # the training step's shapes: [train] runs B=4, S=2048, 16
            # heads of 128; GQA at the 7B width
            cases += [
                ("rms_norm[train]", lambda: check_rms(
                    K, dev, dtype, rng, 8192, 2048)),
                ("swiglu[train]", lambda: check_swiglu(
                    K, dev, dtype, rng, 8192, 5504)),
                ("fused_rope[train]", lambda: check_rope(
                    K, dev, dtype, rng, 4, 2048, 16, 128)),
                # the RoPE kernel's forms on the main path: q and k of the
                # dense admission (7B heads; GQA 8), the paged steps'
                # per-token rows (a decode step at 4 slots, a ragged chunk
                # of 4 x 256), the training step's q and k and their
                # gradients; then tables in x's type (a model cast with
                # .to(dtype)) and a head dim of 18 (the scalar path)
                ("fused_rope[qk]", lambda: check_rope_qk(
                    K, dev, dtype, rng_p, 4, 256, 32, 32)),
                ("fused_rope[qk,gqa8]", lambda: check_rope_qk(
                    K, dev, dtype, rng_p, 4, 256, 32, 8)),
                ("fused_rope[rows,decode]", lambda: check_rope_qk(
                    K, dev, dtype, rng_p, 4, 1, 32, 32, rows=True)),
                ("fused_rope[rows,chunk]", lambda: check_rope_qk(
                    K, dev, dtype, rng_p, 4, 256, 32, 32, rows=True)),
                ("fused_rope[train,qk]", lambda: check_rope_qk(
                    K, dev, dtype, rng_p, 4, 2048, 16, 16)),
                ("fused_rope_bwd[train]", lambda: check_rope_qk(
                    K, dev, dtype, rng_p, 4, 2048, 16, 16, bwd=True)),
                ("fused_rope[qk,x_tables]", lambda: check_rope_qk(
                    K, dev, dtype, rng_p, 4, 256, 32, 8,
                    table_dtype=dtype)),
                ("fused_rope[rows,d18]", lambda: check_rope_qk(
                    K, dev, dtype, rng_p, 2, 37, 8, 4, d=18, rows=True)),
                ("fused_rope_bwd[d18]", lambda: check_rope_qk(
                    K, dev, dtype, rng_p, 2, 37, 8, 4, d=18, bwd=True)),
                ("flash_attention[train]", lambda: check_flash(
                    K, dev, dtype, rng, 4, 2048, 2048, 16, 16)),
                ("flash_attention_bwd", lambda: check_flash_bwd(
                    K, dev, dtype, rng, 4, 2048, 2048, 16, 16)),
                ("flash_attention_bwd[gqa8]", lambda: check_flash_bwd(
                    K, dev, dtype, rng, 1, 2048, 2048, 32, 8)),
                # flashmask: a packed-document causal mask at the training
                # shape, per-KV-head 2-bound causal under GQA at the 7B
                # width, bidirectional 4 bounds, a causal window of 256
                ("flashmask_attention", lambda: check_flashmask(
                    K, dev, dtype, rng, 4, 2048, 16, 16, "doc")),
                ("flashmask_attention_bwd", lambda: check_flashmask_bwd(
                    K, dev, dtype, rng, 4, 2048, 16, 16, "doc")),
                ("flashmask_attention[gqa8]", lambda: check_flashmask(
                    K, dev, dtype, rng, 1, 2048, 32, 8, "gqa")),
                ("flashmask_attention_bwd[gqa8]", lambda: check_flashmask_bwd(
                    K, dev, dtype, rng, 1, 2048, 32, 8, "gqa")),
                ("flashmask_attention[bidir4]", lambda: check_flashmask(
                    K, dev, dtype, rng, 2, 1024, 16, 16, "bidir")),
                ("flashmask_attention_bwd[bidir4]",
                 lambda: check_flashmask_bwd(
                     K, dev, dtype, rng, 2, 1024, 16, 16, "bidir")),
                ("flashmask_attention[window256]", lambda: check_flashmask(
                    K, dev, dtype, rng, 4, 2048, 16, 16, "window")),
                ("flashmask_attention_bwd[window256]",
                 lambda: check_flashmask_bwd(
                     K, dev, dtype, rng, 4, 2048, 16, 16, "window")),
                # BERT-base's FFN epilogue: 32 x 512 tokens of 768
                ("bias_dropout_residual_ln", lambda: check_bdrln(
                    K, dev, dtype, rng, 16384, 768, 0.1)),
                ("bias_dropout_residual_ln[p0]", lambda: check_bdrln(
                    K, dev, dtype, rng, 16384, 768, 0.0)),
            ]
        # the edges of both flash routes (bf16: tensor cores; f32: SIMT):
        # bottom-right causal alignment (S_q < S_k); rows that see no key
        # (S_q > S_k); ragged tiles (S = 300, no multiple of 64 or 128);
        # D = 64; GQA; the masked forms at a small shape
        cases += [
            ("flash_attention[bottom_right]", lambda: check_flash(
                K, dev, dtype, rng, 1, 100, 300, 32, 32)),
            ("flash_attention[q_longer]", lambda: check_flash(
                K, dev, dtype, rng, 1, 300, 100, 32, 32)),
            ("flash_attention[s300]", lambda: check_flash(
                K, dev, dtype, rng, 2, 300, 300, 8, 4)),
            ("flash_attention[d64]", lambda: check_flash(
                K, dev, dtype, rng, 2, 300, 300, 8, 4, d=64)),
            ("flash_attention_bwd[bottom_right]", lambda: check_flash_bwd(
                K, dev, dtype, rng, 1, 100, 300, 8, 8, library=False)),
            ("flash_attention_bwd[q_longer]", lambda: check_flash_bwd(
                K, dev, dtype, rng, 1, 300, 100, 8, 8, library=False)),
            ("flash_attention_bwd[s300]", lambda: check_flash_bwd(
                K, dev, dtype, rng, 2, 300, 300, 8, 4, library=False)),
            ("flash_attention_bwd[small]", lambda: check_flash_bwd(
                K, dev, dtype, rng, 2, 300, 300, 8, 4, d=64,
                library=False)),
            ("flashmask_attention[small]", lambda: check_flashmask(
                K, dev, dtype, rng, 2, 300, 8, 4, "bidir", d=64,
                library=False)),
            ("flashmask_attention_bwd[small]",
             lambda: check_flashmask_bwd(
                 K, dev, dtype, rng, 2, 300, 8, 4, "gqa", d=64,
                 library=False)),
        ]
        if dtype == torch.float32:
            cases += [
                # the RoPE kernel in float32: the dense admission's q and
                # k, a ragged chunk's rows under GQA 8, the gradients, the
                # tiny model's D = 16 and the scalar path's D = 18
                ("fused_rope[qk]", lambda: check_rope_qk(
                    K, dev, dtype, rng_p, 4, 256, 32, 32)),
                ("fused_rope[rows,chunk,gqa8]", lambda: check_rope_qk(
                    K, dev, dtype, rng_p, 4, 256, 32, 8, rows=True)),
                ("fused_rope_bwd[gqa8]", lambda: check_rope_qk(
                    K, dev, dtype, rng_p, 4, 256, 32, 8, bwd=True)),
                ("fused_rope[rows,d16]", lambda: check_rope_qk(
                    K, dev, dtype, rng_p, 2, 37, 4, 2, d=16, rows=True)),
                ("fused_rope[qk,d18]", lambda: check_rope_qk(
                    K, dev, dtype, rng_p, 2, 37, 8, 4, d=18)),
                # the tiny model's heads (D = 16, rep 2) over a table of 64
                # pages of 4: the vector path with four floats a lane, two
                # page ranges and the merge, an idle slot; D = 18: the
                # scalar path
                ("paged_decode_attention[d16]", lambda: check_decode(
                    K, dev, dtype, rng, h_kv=2, lens=(200, 97, 4, 0), h=4,
                    d=16, page=4, p_max=64)),
                ("paged_decode_attention_int8[d16]", lambda: check_decode(
                    K, dev, dtype, rng8, h_kv=2, int8=True,
                    lens=(200, 97, 4, 0), h=4, d=16, page=4, p_max=64)),
                ("paged_decode_attention[d18]", lambda: check_decode(
                    K, dev, dtype, rng, h_kv=4, lens=(600, 129, 1), b=3,
                    h=8, d=18, p_max=40)),
                # an odd h: the scalar path; h > 1536: y recomputed, not
                # cached in shared memory
                ("bias_dropout_residual_ln[odd]", lambda: check_bdrln(
                    K, dev, dtype, rng, 37, 333, 0.2)),
                ("bias_dropout_residual_ln[wide]", lambda: check_bdrln(
                    K, dev, dtype, rng, 64, 4096, 0.1)),
            ]
        _run_cases(cases, dtype, out)
    measure_write_rows(dev)
    return out


# the [kernels] row whose numbers stand for a kernel in the JSON line,
# where it is not the row of the kernel's own name: the RoPE kernel's
# forms as the main path launches them
RECORD_ROWS = {"fused_rope": "fused_rope[qk]",
               "fused_rope_bwd": "fused_rope_bwd[train]"}


def _run_cases(cases, dtype, out):
    """Run [kernels] cases of one type: print each row, raise on a rule
    broken, and keep the bf16 rows of the base names (or RECORD_ROWS) in
    `out` under the base names."""
    for name, run in cases:
        res = run()
        base = name.split("[")[0]
        ok, tol = _within(base, res, dtype)
        bound, by = _bound_ms(res["bytes"], res["flops"], dtype)
        lib = res["library_ms"]
        lse = f" lse_err={res['lse_err']:.3e}" if "lse_err" in res else ""
        if "pairs" in res:
            lse += f" visible_pairs={res['pairs']}"
        if "y_err" in res:
            lse += (f" y_err={res['y_err']:.3e} keep_rate="
                    f"{res['keep_rate']:.6f} keep_mask=bit-equal "
                    f"composition_ms(F.layer_norm(r+F.dropout(x+b)))="
                    f"{res['composition_ms']:.4f}")
        if "plan" in res:
            lse += (f" splits={res['plan'][0]} pages_per_split="
                    f"{res['plan'][1]} launches_per_call="
                    f"{res['launches_per_call']}")
        if "route" in res:
            lse += f" route={res['route']}"
        if "f32p" in res:
            lse += (f" vs_f32P_plain: kernel_err={res['err_f32p']:.3e} "
                    f"err/allowed={res['f32p']:.3f} (<= 1: the same rule "
                    f"+ half an ulp of each P term) dropped_tile: "
                    f"err/allowed={res['dropped']:.1f} (must fail) rows "
                    f"err/rms=" + "/".join(f"{e:.2e}:{r:.2e}"
                                           for e, r in res["rows"]))
        if "parent_ms" in res:
            if "parent_route" in res:
                lse += f" parent_route={res['parent_route']}"
            lse += (f" parent_ms={res['parent_ms']:.4f} (order parent, "
                    f"kernel, kernel, parent: " + "/".join(
                        f"{t:.4f}" for t in res["parent_abba"]) +
                    f"; parent_err={res['parent_err']:.3e})")
        if "errs" in res:
            lse += " dq/dk/dv_err=" + "/".join(
                f"{e:.3e}" for e in res["errs"]) + " max|grad|=" + \
                "/".join(f"{m:.3f}" for m in res["scales"]) + \
                " mean|grad|=" + "/".join(
                    f"{m:.4f}" for m in res["means"]) + " rms=" + \
                "/".join(f"{m:.4f}" for m in res["rms"]) + \
                " err/allowed(bf16 rule)=" + "/".join(
                    f"{w:.3f}" for w in res["worst"])
            if res["over"]:
                lse += " beyond(allowed)=" + "/".join(
                    f"{c}({_over_allowed(n)})" for c, n in
                    zip(res["over_n"], res["n"])) + \
                    " share_beyond=" + "/".join(
                    f"{o:.2e}" for o in res["over"]) + \
                    " err/(allowed+2^-7 sum|terms|)=" + "/".join(
                        f"{w:.3f}" for w in res["bound"])
        acc_ok = True
        if res.get("acc") is not None:
            kerr, lerr = res["acc"]
            fmt = (lambda e: "/".join(f"{x:.3e}" for x in e)) if \
                isinstance(kerr, list) else (lambda e: f"{e:.3e}")
            lse += (f" vs_f32_plain: kernel_err={fmt(kerr)} library_err="
                    f"{'null' if lerr is None else fmt(lerr)}")
            if lerr is not None:
                pairs = zip(kerr, lerr) if isinstance(kerr, list) else \
                    [(kerr, lerr)]
                acc_ok = all(a <= LIB_ERR_FACTOR * b for a, b in pairs)
                lse += f" (kernel <= {LIB_ERR_FACTOR:g}x library)"
        print(f"[kernels] {name:35s} {str(dtype)[6:]:9s} "
              f"max_abs_err={res['err']:.3e} ({tol}){lse} "
              f"kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
              f"library_ms={'null' if lib is None else f'{lib:.4f}'} "
              f"bound_ms={bound:.4f} ({by})", flush=True)
        if not ok:
            raise AssertionError(f"{name} {dtype}: max_abs_err "
                                 f"{res['err']} not {tol}")
        if res.get("f32p", 0.0) > 1.0:
            raise AssertionError(f"{name} {dtype}: the kernel's error "
                                 f"against the float32-P plain version is "
                                 f"{res['f32p']} of its allowance")
        if not acc_ok:
            raise AssertionError(f"{name} {dtype}: the kernel's error "
                                 f"against the float32 plain version is "
                                 f"more than {LIB_ERR_FACTOR:g}x the "
                                 f"library's: {res['acc']}")
        if dtype == torch.bfloat16 and RECORD_ROWS.get(base, base) == name:
            out[base] = {"max_abs_err": res["err"], "ms": res["ms"],
                         "plain_ms": res["plain_ms"], "bound_ms": bound,
                         "bound_by": by, "library_ms": lib}
        del res
    torch.cuda.empty_cache()


def measure_write_rows(dev):
    """The plain int8 page write (page_quant.write_rows, eager PyTorch, no
    kernel of its own) at the decode shape: 4 rows, one per slot, into
    one Llama-2-7B layer pool (1025 pages of 16 x 32 x 128), two of them
    opening a page. Prints the CUDA kernels one call launches (profiler)
    and the host time per call; a decode step makes 64 calls (32 layers,
    K and V)."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.quantization import page_quant
    pages = torch.zeros((1025, 16, 32, 128), dtype=torch.int8, device=dev)
    scales = torch.ones(1025, device=dev)
    pids = torch.tensor([5, 9, 13, 0], device=dev)
    offs = torch.tensor([3, 0, 7, 0], device=dev)
    rows = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, 32, 128), dtype=np.float32)).to(dev, torch.bfloat16)

    def write():
        page_quant.write_rows(pages, scales, pids, offs, rows)

    write()
    torch.cuda.synchronize()
    calls = 10
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            write()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")) / calls
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        write()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / 100
    print(f"[write_rows] decode shape (4 rows, one layer's K): "
          f"kernels_per_call={n:g} host_ms_per_call={host_ms:.4f}; per "
          f"decode step (64 calls): {64 * n:g} launches, "
          f"{64 * host_ms:.2f} ms of host time", flush=True)


# ----------------------------------------------------------------------
# driver
# ----------------------------------------------------------------------

SM90_SOURCES = ("flash_fwd_sm90", "flash_bwd_sm90")


def check_sass(build):
    """The tensor-core kernels as built: every bfloat16 D = 128 kernel of
    the two flash sm90 libraries, and every kernel of the ragged one (both
    16-bit types, D 64 and 128, float and int8 pages),
    must contain tensor-core products (HGMMA, from wgmma) and TMA loads
    (UTMALDG); prints the counts."""
    from pathlib import Path

    tool = Path(build._nvcc()).with_name("cuobjdump")
    for src in SM90_SOURCES + ("ragged_sm90",):
        sass = subprocess.run([str(tool), "-sass", str(build._target(src)[1])],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        for part in sass.split("Function : ")[1:]:
            fn, body = part.split("\n", 1)
            hg, tma = body.count("HGMMA"), body.count("UTMALDG")
            if src == "ragged_sm90":
                # ..._kernelI<T><KV>Li<D>E...
                args = fn.split("ragged_sm90_kernelI")[1]
                t = "f16" if args.startswith("6__half") else "bf16"
                kv = "int8" if args[len("6__half" if t == "f16" else
                                        "13__nv_bfloat16"):][:1] == "a" \
                    else t
                d = args.split("Li")[1].split("E")[0]
                kind = f"ragged<{t},{kv},{d}>"
            else:
                if "__nv_bfloat16Li128E" not in fn:
                    continue
                kind = "dq" if "flash_dq" in fn else (
                    "dkv" if "flash_dkv" in fn else "fwd")
                nm = fn.split("Li128ELi")[1][0]
                kind = f"{kind}<bf16,128,{nm}>"
            print(f"[sass] {src} {kind}: HGMMA {hg} UTMALDG {tma}",
                  flush=True)
            if not hg or not tma:
                raise AssertionError(f"[sass] {src} {kind}: no wgmma or no "
                                     "TMA")


def _ptxas_kernels(log):
    """[(kernel, what ptxas reports for it)] from an `-Xptxas -v` log:
    registers, barriers, stack and spills, the kernel's name demangled
    (c++filt, where the toolkit's host has it) without its parameters."""
    import shutil
    entries, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = [line.split("'")[1], []]
            entries.append(cur)
        elif cur is not None and ("Used" in line or "spill" in line):
            cur[1].append(line.split(":", 1)[-1].strip())
    names = [e[0] for e in entries]
    if names and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True, check=True,
                               timeout=60).stdout.splitlines()
    return [(n.replace("(anonymous namespace)::", "").replace("void ", "")
             .split("(")[0], "; ".join(e[1])) for n, e in zip(names, entries)]


def _nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="a copy of the parent commit's "
                         "paddle_tpu_torch/csrc: its versions of "
                         f"{', '.join(PARENT_SOURCES)} are built and timed "
                         "beside this tree's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    parent = _start_parent(args.parent) if args.parent else None
    from paddle_tpu_torch import runtime
    native_job = runtime.start_build(ops=True)
    waited = _build.build_all()
    native_s = runtime.finish_build(native_job)
    print(f"[build] seconds per source "
          f"{json.dumps({k: round(v, 2) for k, v in waited.items()})}"
          f" total_s={time.perf_counter() - t0:.2f}; the native runtime "
          f"(runner, ptt_run, C++ op library, g++ beside nvcc) done at "
          f"{native_s:.2f} s into {runtime.build_dir()}", flush=True)
    if parent:
        _finish_parent(parent)
        print(f"[build] the parent's {', '.join(PARENT_SOURCES)} from "
              f"{args.parent}: timed beside this tree's kernels "
              f"(parent_ms)", flush=True)
    for name in _build.SOURCES:
        for kernel, used in _ptxas_kernels(_build.ptxas_report(name)):
            print(f"[ptxas] {name}: {kernel}: {used}")
    check_sass(_build)

    times = {}

    def run(tag, fn, /, *args, **kwargs):
        """fn(*args, **kwargs), its seconds kept under `tag`."""
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        times[tag] = round(time.perf_counter() - t, 1)
        return out

    records = run("kernels", phase_kernels, K, dev)
    run("dispatch", phase_dispatch, K, dev)
    run("agree", phase_agree, dev)
    run("agree:int8", phase_agree_int8, dev)
    run("agree:train", phase_agree_train, dev)
    run("agree:masked", phase_agree_masked, dev)
    run("agree:spec", phase_agree_spec, dev)
    run("surface", phase_surface, dev)
    run("agree:graphs", phase_agree_graphs, dev)
    run("agree:gpt", phase_agree_gpt, dev)
    run("agree:bert", phase_agree_bert, dev)
    run("agree:train2", phase_agree_train2, dev)
    run("agree:fleet", phase_agree_fleet, dev)
    run("collectives", phase_collectives, dev)
    run("agree:mesh", phase_agree_mesh, dev)
    run("agree:fuse", phase_agree_fuse, dev)
    run("agree:unet", phase_agree_unet, dev)
    run("agree:vision", phase_agree_vision, dev)
    opl = run("ops:layer", phase_ops_layer, K, dev)
    ops = run("ops:sweep", phase_ops_sweep, K, dev)
    agr = run("autograd", phase_autograd, K, dev)
    run("device", phase_device, dev)
    masked = run("flashmask", phase_flashmask, K, dev)
    ffn = run("fused_ffn", phase_fused_ffn, K, dev)
    tail = run("tail", phase_tail, K, dev)
    run("rnn", phase_rnn, dev)
    model = run("serve:model", _serving_model, dev)
    serve, serve_out, serve_st = run("serve", phase_serve, K, model,
                                     programs=True)
    dense, dense_out = run("serve:dense", phase_serve_dense, K, model)
    serve8, serve8_out, serve8_st = run("serve:int8", phase_serve, K, model,
                                        kv_dtype="int8", twin=serve_out,
                                        programs=True)
    dense8, _ = run("serve:dense:int8", phase_serve_dense, K, model,
                    kv_dtype="int8", twin=dense_out)
    spec = run("serve:spec", phase_serve_spec, K, model, serve_out,
               serve_st)
    spec8 = run("serve:spec:int8", phase_serve_spec, K, model, serve8_out,
                serve8_st, kv_dtype="int8")
    run("spec:rescore", phase_spec_rescore, model)
    run("spec:rescore:int8", phase_spec_rescore, model, kv_dtype="int8")
    fleet, _ = run("fleet", phase_fleet, K, model, serve_out)
    fleet8, _ = run("fleet:int8", phase_fleet, K, model, serve8_out,
                    kv_dtype="int8")
    mesh, mesh_eng = run("serve:mesh", phase_serve_mesh, K, model, serve_out,
                         serve_st)
    run("sharding", phase_sharding, mesh_eng, dev)
    del mesh_eng
    del model                            # the next runs read their own peak
    _release()
    run("fleet:proc", phase_fleet_proc, dev)
    gpt = _serving_gpt(dev)
    gserve, gserve_out, _ = run("serve:gpt", phase_serve, K, gpt,
                                name="serve:gpt")
    gserve8, _, _ = run("serve:gpt:int8", phase_serve, K, gpt,
                        kv_dtype="int8", twin=gserve_out, name="serve:gpt")
    gdense, _ = run("serve:gpt:dense", phase_serve_dense, K, gpt,
                    name="serve:gpt:dense")
    del gpt
    bert = run("bert", phase_bert, K, dev)
    train, model, opt, batch, base = run("train", phase_train, K, dev)
    run("profile:train", phase_profile_train, model, opt, batch)
    run("auto_tuner", phase_auto_tuner, base)
    run("profiler", phase_profiler, model, opt, batch)
    run("amp:debug", phase_amp_debug, model, batch)
    del model, opt, batch
    remat = run("train:remat", phase_train_remat, K, dev, base)
    fuse = run("train:fuse", phase_train_fuse, K, dev, base)
    static = run("to_static", phase_to_static, K, dev)
    gtrain = run("train:gpt", phase_train_gpt, K, dev)
    htrain = run("train:hybrid", phase_train_hybrid, K, dev)
    dtrain = run("dist:launch", phase_dist_launch, K, dev)
    ring_runs = run("ring", phase_ring, K, dev)
    ptrain = run("train:pipeline", phase_train_pipeline, K, dev)
    strain = run("train:semi", phase_train_semi, K, dev)
    qmodel = run("quant:model", _quant_model, dev)
    run("quant:ptq", phase_quant_ptq, qmodel)
    qtrain = run("quant:qat", phase_quant_qat, K, qmodel)
    del qmodel
    run("quant:weight_only", phase_quant_weight_only, dev)
    qpass = run("quant:pass", phase_quant_pass, K, dev)
    run("moe", phase_moe, dev)
    run("incubate", phase_incubate, dev)
    run("text", phase_text, dev)
    run("audio", phase_audio, dev)
    btrain = run("train:bert", phase_train_bert, K, dev)
    utrain = run("train:unet", phase_train_unet, K, dev)
    resnet = run("train:resnet", phase_train_resnet, dev)
    deployed, deploy_art = run("deploy", phase_deploy, K, dev, resnet)
    del resnet
    native, native_logits = run("deploy:native", phase_deploy_native, K,
                                *deploy_art)
    run("deploy:cpp", phase_deploy_cpp, K, *deploy_art, native_logits)
    del deploy_art
    rtrain = run("train:resilient", phase_train_resilient, K, dev)
    print(f"[time] seconds per phase {json.dumps(times)}; total since the "
          f"build {sum(times.values()):.1f}", flush=True)
    runs = (serve, dense, serve8, dense8, spec, spec8, fleet, fleet8, mesh,
            gserve, gserve8, gdense, bert, train, remat, fuse, static,
            gtrain, htrain, ptrain, strain, qtrain, qpass, btrain, utrain,
            rtrain, masked, ffn, tail, opl, ops, agr, deployed, native,
            dtrain, ring_runs)
    launches = {k: sum(r[k] for r in runs) for k in K.launch_counts()}
    _require_launched("all serving, fleet, mesh, BERT, training (the "
                      "UNet's, QAT's and the two dist:launch workers' "
                      "too), quantize-pass, flashmask, fused_ffn, tail, "
                      "ring, op-surface and deploy runs",
                      launches, K.KERNELS)

    name_power = _nvidia_smi()
    print(name_power)
    kernels = []
    for name, (_fn, source, replaces) in K.KERNELS.items():
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               **records[name]}
        if name in K.ROUTED:
            # source: the tensor-core kernel, which every 16-bit launch
            # above took; float32 launches take the SIMT kernel
            row["float32_source"] = K.SIMT_SOURCES[name]
            row["launches_by_route"] = {
                rt: launches[f"{name}.{rt}"] for rt in K.ROUTES}
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ----------------------------------------------------------------------
# slice 15: the training run's telemetry and recovery
# ----------------------------------------------------------------------

# [train:resilient]: TRAIN_CFG's widths (bench.py:150-154) at RES_LAYERS
# layers (cut from 12: at full depth the phase took 89-109 s on an H100
# host, most of it writing, verifying and reading three 10.3 GB
# checkpoints on the host; at 6 layers 83.1 s of an 823.0 s smoke that
# must keep under 760 s, at 3 58.5 s of a 767.5 s one, at 2 52.5 s of a
# 767.8 s one after the UNet's phases joined, on a slow host) under
# ResilientTrainer: RES_STEPS steps, a checkpoint every
# RES_CKPT_EVERY steps, a host snapshot every RES_SNAPSHOT_EVERY, one
# non-finite loss (step RES_NAN_STEP's loss times NaN: the NaN reaches
# the gradients and the parameters, as a divergence does) that the guard
# rolls back at once (max_consecutive_bad=1), and one hang of the wait
# after step RES_HANG_STEP (the watchdog's wait seam sleeps past its
# timeout) that the trainer recovers from the last checkpoint
RES_LAYERS = 1
RES_STEPS, RES_CKPT_EVERY, RES_SNAPSHOT_EVERY = 12, 4, 4
RES_NAN_STEP, RES_HANG_STEP = 5, 9
RES_TIMEOUT_S = 20.0            # the watchdog's deadline on a step
RES_HANG_TIMEOUT_S = 2.0        # ... on the hung step
# the steps whose updates the final state holds: 0-3; the rollback to the
# snapshot taken before step 4 drops 4 and 5; the restore of the
# checkpoint saved after step 7 drops the first run of 8 and 9, which
# are replayed
RES_LINEAGE = [0, 1, 2, 3, 6, 7, 8, 9, 10, 11]
RES_EVENTS = ["restored_initial", "checkpoint", "bad_step", "rollback",
              "checkpoint", "fault", "backoff", "restored",
              "recovery_complete", "budget_reset", "checkpoint"]
RES_MFU_WINDOW = (1, 4)         # steps [1, 4): no fault, no save, counted


def _res_model(dev):
    """TRAIN_CFG at RES_LAYERS layers, bf16, seed 0; AdamW(1e-4) with
    masters; compile_train_step over the loss times a poison factor (1.0,
    or NaN on the step that diverges)."""
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.jit import compile_train_step
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = LlamaConfig(**{**TRAIN_CFG, "num_hidden_layers": RES_LAYERS})
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    weights.init_random_(model, seed=0)
    opt = AdamW(1e-4, parameters=model.parameters(), multi_precision=True)
    step = compile_train_step(model, lambda m, i, l, z: m(i, labels=l) * z,
                              opt)
    return cfg, model, opt, step


def _res_data(cfg):
    """Seeded random ids and labels: RES_STEPS batches of TRAIN_BATCH x
    TRAIN_SEQ, as [RES_STEPS * TRAIN_BATCH, TRAIN_SEQ] arrays."""
    rng = np.random.default_rng(2)
    n = RES_STEPS * TRAIN_BATCH
    return (rng.integers(0, cfg.vocab_size, (n, TRAIN_SEQ)),
            rng.integers(0, cfg.vocab_size, (n, TRAIN_SEQ)))


def phase_train_resilient(K, dev):
    """The training loop's telemetry and recovery at [train]'s widths:
    the DataLoader feeding compile_train_step under ResilientTrainer and a
    StepTimer (each step: dispatch, then compute timed at the watchdog's
    wait on an event recorded after the step), with the injected faults
    of RES_*. Prints the events, goodput and the phases' seconds, the
    timer's perf_mfu beside the analytic MFU (_train_flops) over a window
    with no fault, the counted train-step flops beside _train_flops, the
    checkpoint, restore, snapshot and recovery seconds and the peak of
    memory; then an uninterrupted run of the surviving steps on a fresh
    model (the same seed) must give the same losses and final parameters
    by [train:remat]'s rule (each within 2 bf16 ulps). The checkpoints
    are deleted at the end."""
    import shutil
    from paddle_tpu_torch.distributed import resilient, watchdog
    from paddle_tpu_torch.observability import perf, xla_introspect
    import paddle_tpu_torch.observability as obs

    tag = "train:resilient"
    _release()
    obs.reset()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "resilient_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    t_phase = time.perf_counter()
    from paddle_tpu_torch import io

    cfg, model, opt, step = _res_model(dev)
    loader = io.DataLoader(io.TensorDataset(list(_res_data(cfg))),
                           batch_size=TRAIN_BATCH, num_workers=2,
                           use_shared_memory=True, pin_memory=True,
                           device=dev)
    it = iter(loader)
    batches = {}
    timer = perf.StepTimer(program=step.program)
    totals = {}                  # step call -> timer totals after it
    calls, losses, lineage = [], [], []
    events = []
    snap_lineage = {}
    one, nan = (torch.tensor(v, device=dev, dtype=torch.float32)
                for v in (1.0, float("nan")))

    def on_event(kind, **info):
        events.append((kind, info))
        print(f"[{tag}] event {kind} {json.dumps(info, default=str)}",
              flush=True)

    def step_fn(s):
        while s not in batches:          # the loader's next batch
            batches[len(batches)] = next(it)
        ids, lab = batches[s]
        n = len(calls)
        first = s not in calls
        calls.append(s)
        hang = s == RES_HANG_STEP and first
        with timer.step():
            with timer.phase("dispatch"):
                loss = step(ids, lab,
                            nan if s == RES_NAN_STEP and first else one)
            with timer.phase("compute"):
                done = torch.cuda.Event()
                done.record()
                if hang:
                    seam = watchdog._block
                    watchdog._block = lambda v: time.sleep(
                        3 * RES_HANG_TIMEOUT_S)
                try:
                    watchdog.watched_wait(
                        done, what="train_step",
                        timeout=RES_HANG_TIMEOUT_S if hang
                        else RES_TIMEOUT_S)
                finally:
                    if hang:
                        watchdog._block = seam
        totals[n] = timer.totals()
        losses.append((s, loss))
        lineage.append(s)
        if n == 0:
            timer.resolve_flops()        # counted in step 0, outside
        return loss

    tr = resilient.ResilientTrainer(
        model, opt, ckpt_root=root, ckpt_every=RES_CKPT_EVERY,
        keep_last_n=2, snapshot_every=RES_SNAPSHOT_EVERY,
        max_consecutive_bad=1, backoff_base=0.05, backoff_cap=0.1,
        backoff_seed=0, on_event=on_event)
    # the lineage of the state: what a snapshot, a save, a rollback and a
    # restore keep of the steps applied so far
    secs = {"snapshot": [], "save": [], "restore": []}
    g_snap, t_save, t_restore = tr.guard.snapshot, tr.save, tr.restore

    def snapshot(s):
        t0 = time.perf_counter()
        g_snap(s)
        secs["snapshot"].append(time.perf_counter() - t0)
        snap_lineage["guard"] = list(lineage)

    def save(s):
        t0 = time.perf_counter()
        out = t_save(s)
        secs["save"].append(time.perf_counter() - t0)
        snap_lineage[f"ckpt{s}"] = list(lineage)
        return out

    def restore():
        t0 = time.perf_counter()
        nxt = t_restore()
        secs["restore"].append(time.perf_counter() - t0)
        lineage[:] = snap_lineage[f"ckpt{nxt - 1}"] if nxt else []
        snap_lineage["guard"] = list(lineage)   # restore's own snapshot
        return nxt

    g_rollback = tr.guard.rollback

    def rollback():
        g_rollback()
        lineage[:] = snap_lineage["guard"]

    tr.guard.snapshot, tr.save, tr.restore = snapshot, save, restore
    tr.guard.rollback = rollback
    K.reset_launch_counts()
    completed = tr.run(step_fn, RES_STEPS)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    timer.detach()
    wall = time.perf_counter() - t_phase
    peak = torch.cuda.max_memory_allocated() / 1e9
    kinds = [k for k, _ in events if k in set(RES_EVENTS)]
    tot = timer.totals()
    n_params = sum(p.numel() for p in model.parameters())
    n_matmul = n_params - model.llama.embed_tokens.weight.numel()
    flops, formula = _train_flops(cfg, n_matmul)
    counted = xla_introspect.flops_of(step.program)
    a, b = RES_MFU_WINDOW
    win = perf.window_stats(totals[a - 1], totals[b - 1],
                            flops_per_step=counted, peak=timer.peak)
    analytic = flops * win["steps"] / win["wall"] / timer.peak
    snap = obs.snapshot()
    print(f"[{tag}] TRAIN_CFG widths at {RES_LAYERS} layers (hidden "
          f"{cfg.hidden_size}, ffn {cfg.intermediate_size}, "
          f"{cfg.num_attention_heads} heads, vocab {cfg.vocab_size}), "
          f"bf16, AdamW(1e-4, multi_precision=True), batch {TRAIN_BATCH}x"
          f"{TRAIN_SEQ}; DataLoader(num_workers=2, shared memory, pinned); "
          f"{RES_STEPS} steps, {len(calls)} step calls, completed "
          f"{completed}; program {step.program}")
    print(f"[{tag}] events {json.dumps([k for k, _ in events])}")
    print(f"[{tag}] step calls {calls}; surviving steps {lineage}")
    print(f"[{tag}] losses {[(s, float(v)) for s, v in losses]}")
    print(f"[{tag}] goodput={tot['goodput']:.4f} steps={tot['steps']} "
          f"wall_s={tot['wall']:.3f} phases_s "
          f"{json.dumps({k: round(v, 4) for k, v in tot['phases'].items()})}")
    print(f"[{tag}] window steps [{a}, {b}): wall_s={win['wall']:.4f} "
          f"phases_s {json.dumps({k: round(v, 4) for k, v in win['phases'].items()})}; "
          f"perf_mfu={win['mfu']:.4f} analytic MFU={analytic:.4f} "
          f"(ratio {win['mfu'] / analytic:.4f}); gauge perf_mfu="
          f"{snap['gauges'].get('perf_mfu')} over the whole run "
          f"(faults included); peak {timer.peak:.4g}")
    print(f"[{tag}] counted xla_program_flops{{program={step.program}}}="
          f"{counted:.6e} analytic {formula} (ratio "
          f"{counted / flops:.4f}); counted kernels "
          f"{json.dumps(xla_introspect.programs()[step.program].get('kernels'))}")
    print(f"[{tag}] seconds: snapshot {[round(x, 3) for x in secs['snapshot']]}"
          f" save {[round(x, 3) for x in secs['save']]} restore "
          f"{[round(x, 3) for x in secs['restore']]}; recovery_s "
          f"{[i.get('duration_s') for k, i in events if k == 'recovery_complete']}; "
          f"phase wall_s={wall:.2f} peak_mem_gb={peak:.2f}")
    print(f"[{tag}] counters {json.dumps({k: v for k, v in snap['counters'].items() if k.startswith(('resilient_', 'dataloader_', 'perf_'))})}")
    print(f"[{tag}] launches {json.dumps(launches)}", flush=True)
    _require_launched(tag, launches, TRAIN_KERNELS)
    if kinds != RES_EVENTS:
        raise AssertionError(f"[{tag}] events {kinds} != {RES_EVENTS}")
    # every step call completes but the hung one
    if lineage != RES_LINEAGE or completed != len(calls) - 1:
        raise AssertionError(f"[{tag}] surviving steps {lineage} != "
                             f"{RES_LINEAGE}")
    faults = [i for k, i in events if k == "fault"]
    if faults[0]["type"] != "CommTimeoutError":
        raise AssertionError(f"[{tag}] the fault was {faults[0]}")
    if not 0.95 <= counted / flops <= 1.05:
        raise AssertionError(f"[{tag}] counted flops {counted:.4e} are not "
                             f"within 5% of {flops:.4e}")
    if not 0.9 <= win["mfu"] / analytic <= 1.1:
        raise AssertionError(f"[{tag}] perf_mfu {win['mfu']:.4f} is not "
                             f"within 10% of the analytic {analytic:.4f}")
    # the surviving steps' losses: the replayed ones equal their first run
    final = {}
    for s, v in losses:
        final.setdefault(s, []).append(float(v))
    for s, vs in final.items():
        if len(vs) > 1 and s != RES_NAN_STEP and len(set(vs)) != 1:
            raise AssertionError(f"[{tag}] step {s} replayed to other "
                                 f"losses {vs}")
    got_losses = [final[s][-1] for s in RES_LINEAGE]
    got_params = [p.detach().clone() for p in model.parameters()]
    del tr, model, opt, step, loader, it, batches, losses
    _release()

    # the uninterrupted run of the surviving steps
    cfg, model, opt, step = _res_model(dev)
    ids, lab = (torch.from_numpy(a).to(dev) for a in _res_data(cfg))
    rows = [slice(s * TRAIN_BATCH, (s + 1) * TRAIN_BATCH)
            for s in RES_LINEAGE]
    want_losses = [float(step(ids[r], lab[r], one)) for r in rows]
    diffs = [abs(x - y) for x, y in zip(got_losses, want_losses)]
    p_ok = all(bool(((g.float() - w.float()).abs()
                     <= 2 * _ulp_bf16(w.float())).all())
               for g, w in zip(got_params, model.parameters()))
    p_same = all(torch.equal(g, w) for g, w in
                 zip(got_params, model.parameters()))
    print(f"[{tag}] uninterrupted run of the surviving steps: losses "
          f"{want_losses}; max |diff| {max(diffs):.4g}; final parameters "
          f"within 2 bf16 ulps {p_ok}, bit-equal {p_same}", flush=True)
    if any(d > 2 * _bf16_ulp(w) for d, w in zip(diffs, want_losses)) \
            or not p_ok:
        raise AssertionError(f"[{tag}] the recovery path changed the "
                             "results")
    del model, opt, step, ids, lab, got_params
    shutil.rmtree(root, ignore_errors=True)
    _release()
    return launches


PROFILER_TRAIN_KERNELS = ("flash_fwd_sm90_kernel", "flash_dq_sm90_kernel",
                          "flash_dkv_sm90_kernel", "rms_norm_vec_kernel",
                          "swiglu_vec", "rope_vec_kernel")


def phase_profiler(model, opt, batch):
    """The port's profiler.Profiler with make_scheduler(closed=1, ready=1,
    record=2) over 5 more [train] steps, each a RecordEvent span: the
    window (steps 2-3) exported as a chrome trace when it closes; its
    device events must name the hand-written training kernels and the
    spans must be there; then the summary table."""
    from paddle_tpu_torch import profiler

    tag = "profiler"
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "profiler_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    ids, lab = batch
    out = {}

    def ready(prof):
        out["doc"] = prof.export(path)
        out["step"] = prof._step
        out["summary"] = prof.summary()     # printed; the window's spans

    prof = profiler.Profiler(
        scheduler=profiler.make_scheduler(closed=1, ready=1, record=2,
                                          repeat=1),
        on_trace_ready=ready)
    states = []
    torch.cuda.synchronize()
    prof.start()
    for i in range(5):
        states.append(prof._state)
        with profiler.RecordEvent(f"train_step_{i}"):
            loss = model(ids, labels=lab)
            loss.backward()
            opt.step()
            opt.clear_grad()
            float(loss.detach())
        prof.step()
    prof.stop()
    names = {e.get("name", "") for e in out.get("doc", {}).get(
        "traceEvents", [])}
    found = {k: any(k in n for n in names) for k in PROFILER_TRAIN_KERNELS}
    spans = sorted(n for n in names if n.startswith("train_step_"))
    print(f"[{tag}] states {states}; window closed at step "
          f"{out.get('step')}; trace {path}: {len(names)} event names, "
          f"training kernels named {json.dumps(found)}; RecordEvent spans "
          f"{spans}")
    print(f"[{tag}] summary: {len(out.get('summary', '').splitlines())} "
          f"lines (above)", flush=True)
    if not all(found.values()):
        raise AssertionError(f"[{tag}] the trace does not name every "
                             f"training kernel: {found}")
    if spans != ["train_step_2", "train_step_3"]:
        raise AssertionError(f"[{tag}] the window's spans are {spans}")


def phase_amp_debug(model, batch):
    """amp.debugging on the card with the [train] model: operator stats of
    one O1 forward; then an Inf injected into a weight under
    check_numerics_guard must raise, naming the op that reads it."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.amp import debugging

    tag = "amp:debug"
    ids, lab = batch
    with torch.no_grad():
        with debugging.collect_operator_stats():
            with amp.auto_cast(level="O1"):
                model(ids[:1, :256])
            stats = debugging.get_operator_stats()
    print(f"[{tag}] operator stats of one O1 forward "
          f"{json.dumps(dict(sorted(stats.items())))}")
    n_layers = model.config.num_hidden_layers
    if stats.get("linear") != 7 * n_layers + 1 or \
            stats.get("rms_norm") != 2 * n_layers + 1:
        raise AssertionError(f"[{tag}] the counts are not the model's op "
                             "sites")
    w = model.llama.layers[0].mlp.gate_proj.weight
    keep = w[3].clone()
    with torch.no_grad():
        w[3] = float("inf")
    raised = None
    try:
        with debugging.check_numerics_guard():
            with torch.no_grad():
                model(ids[:1, :256])
    except FloatingPointError as e:
        raised = str(e)
    finally:
        with torch.no_grad():
            w[3] = keep
    print(f"[{tag}] an Inf in llama.layers.0.mlp.gate_proj.weight under "
          f"check_numerics_guard raised: {raised}", flush=True)
    if raised is None or "op 'linear'" not in raised:
        raise AssertionError(f"[{tag}] the injected Inf was not named "
                             f"({raised})")


def _print_programs(tag, eng):
    """[programs]: the introspection registry after the warm wave: one
    entry per program the engine built (decode, prefill, ragged, verify;
    the copy and upload programs, which the JAX engine does not register,
    apart), under the JAX engine's labels, each with flops and HBM bytes;
    the count must equal the engine's trace counters of those kinds."""
    from paddle_tpu_torch.observability import xla_introspect

    progs = {n: e for n, e in xla_introspect.programs().items()
             if n.startswith("engine:")}
    tc = _trace_counts(eng)
    kinds = ("decode_trace_count", "prefill_trace_count",
             "ragged_trace_count", "spec_trace_count")
    built = sum(tc[k] for k in kinds)
    for n, e in sorted(progs.items()):
        print(f"[programs:{tag}] {n} flops={e['flops']:.4e} "
              f"bytes_accessed={e.get('bytes_accessed', 0):.4e} "
              f"hbm_total={e['hbm_total']:.4e} kernels "
              f"{json.dumps({k: v['calls'] for k, v in (e.get('kernels') or {}).items()})}")
    print(f"[programs:{tag}] {len(progs)} entries; the engine built "
          f"{built} programs of the registered kinds "
          f"{json.dumps({k: tc[k] for k in kinds})}; watermark "
          f"{xla_introspect.hbm_high_watermark_bytes():.4e} B", flush=True)
    bad = [n for n, e in progs.items()
           if not e["flops"] or not e["hbm_total"]]
    if len(progs) != built or bad:
        raise AssertionError(f"[programs:{tag}] {len(progs)} entries for "
                             f"{built} programs; without flops or HBM "
                             f"bytes: {bad}")


def _serving_prompts(rng, n, lo, hi, vocab, shared_len, sharers):
    """n prompts with lengths in [lo, hi); the prompts at the `sharers`
    indices are longer than `shared_len` and start with one common
    `shared_len`-token prefix."""
    shared = rng.integers(1, vocab, shared_len)
    out = []
    for i in range(n):
        length = int(rng.integers(shared_len + 1 if i in sharers else lo,
                                  hi))
        toks = rng.integers(1, vocab, length)
        if i in sharers:
            toks[:shared_len] = shared
        out.append(toks.astype(np.int32))
    return out


def _tiny_pair(dev):
    """A 2-layer tiny Llama in float32 with one set of seeded weights on
    the CPU (plain versions) and on the card (kernels)."""
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny()
    cpu = LlamaForCausalLM(cfg, device="cpu")
    state = weights.random_state(cpu, seed=0)
    weights.from_paddle_tpu_state(state, cpu)
    gpu = weights.from_paddle_tpu_state(
        state, LlamaForCausalLM(cfg, device=dev))
    return cfg, cpu, gpu


def phase_agree(dev):
    """The tiny pair: generate_batch through the prefix cache, chunked
    prefill and mixed steps must give the same greedy tokens."""
    cfg, cpu, gpu = _tiny_pair(dev)
    rng = np.random.default_rng(1)
    prompts = _serving_prompts(rng, 6, 9, 20, cfg.vocab_size, 12, (0, 4))
    kw = dict(max_new_tokens=12, max_slots=2, page_size=4, max_seq_len=64,
              prefix_cache=True, prefill_chunk=8, mixed_step=True)
    want = cpu.generate_batch(prompts, **kw)
    got = gpu.generate_batch(prompts, **kw)
    eng = gpu.get_engine(max_slots=2, page_size=4, max_seq_len=64,
                         prefix_cache=True, prefill_chunk=8, mixed_step=True)
    same = all(np.array_equal(a, b) for a, b in zip(want, got))
    print(f"[agree] tiny f32 cpu-plain vs cuda-kernels: "
          f"{sum(np.array_equal(a, b) for a, b in zip(want, got))}/"
          f"{len(prompts)} requests token-identical; prefix_hits="
          f"{eng.stats['prefix_hits']} mixed_decode_tokens="
          f"{eng.stats['mixed_decode_tokens']}", flush=True)
    if not same:
        for a, b in zip(want, got):
            print(f"[agree]   cpu {a[-12:].tolist()}\n"
                  f"[agree]  cuda {b[-12:].tolist()}")
        raise AssertionError("CPU plain path and CUDA kernel path disagree")
    if eng.stats["prefix_hits"] < 1:
        raise AssertionError("agreement run saw no prefix-cache hit")

    # dense admission: cold prompts of 3-8 tokens fit the chunk of 8; the
    # two sharing a 4-token page take a prefix hit, then the ragged suffix
    prompts = _serving_prompts(np.random.default_rng(3), 6, 3, 9,
                               cfg.vocab_size, 4, (0, 4))
    kw = dict(kw, max_slots=3)           # a fresh engine on each model
    want = cpu.generate_batch(prompts, **kw)
    got = gpu.generate_batch(prompts, **kw)
    st = gpu.get_engine(**{k: v for k, v in kw.items()
                           if k != "max_new_tokens"}).stats
    n_same = sum(np.array_equal(a, b) for a, b in zip(want, got))
    print(f"[agree] dense admission: {n_same}/{len(prompts)} requests "
          f"token-identical; prefill_admits={st['prefill_admits']} "
          f"ragged_steps={st['ragged_steps']} "
          f"prefix_hits={st['prefix_hits']}", flush=True)
    if n_same != len(prompts):
        raise AssertionError("dense admission: CPU plain path and CUDA "
                             "kernel path disagree")
    if st["prefill_admits"] < 1 or st["ragged_steps"] < 1:
        raise AssertionError("dense-admission run did not take both the "
                             "dense prefill and the ragged path")

    ids = np.random.default_rng(4).integers(1, cfg.vocab_size, (2, 7))
    want = cpu.generate(ids, max_new_tokens=12, use_cache=True).numpy()
    got = gpu.generate(ids, max_new_tokens=12, use_cache=True).cpu().numpy()
    print(f"[agree] generate(use_cache=True): token-identical="
          f"{np.array_equal(want, got)} {got[0, 7:].tolist()}", flush=True)
    if not np.array_equal(want, got):
        raise AssertionError("generate: CPU plain path and CUDA kernel path "
                             "disagree")


def phase_agree_int8(dev):
    """The tiny pair over int8 KV pages, CPU plain versions against CUDA
    kernels: the chunked workload (prefix hit, chunked and
    suffix prefill, mixed steps), the dense-admission workload, and a fork
    mid-decode (CoW copies of int8 pages and their scale rows) must give
    the same greedy tokens; the GPU runs must launch both int8 attention
    kernels and neither float paged kernel."""
    from paddle_tpu_torch.inference import GenerationEngine
    from paddle_tpu_torch.ops import kernels as K

    cfg, cpu, gpu = _tiny_pair(dev)
    base = dict(max_slots=2, page_size=4, max_seq_len=64, prefix_cache=True,
                prefill_chunk=8, mixed_step=True, kv_dtype="int8")
    workloads = [
        ("chunked", _serving_prompts(np.random.default_rng(1), 6, 9, 20,
                                     cfg.vocab_size, 12, (0, 4)), base),
        ("dense admission", _serving_prompts(np.random.default_rng(3), 6, 3,
                                             9, cfg.vocab_size, 4, (0, 4)),
         dict(base, max_slots=3)),
    ]
    K.reset_launch_counts()
    for tag, prompts, kw in workloads:
        runs = []
        for model in (cpu, gpu):
            eng = GenerationEngine(model, **kw)
            rids = [eng.add_request(p, max_new_tokens=12) for p in prompts]
            with torch.inference_mode():
                out = eng.run()
            runs.append([out[r] for r in rids])
        st = eng.stats
        n_same = sum(np.array_equal(a, b) for a, b in zip(*runs))
        print(f"[agree:int8] {tag}: {n_same}/{len(prompts)} requests "
              f"token-identical; prefill_admits={st['prefill_admits']} "
              f"ragged_steps={st['ragged_steps']} "
              f"prefix_hits={st['prefix_hits']}", flush=True)
        if n_same != len(prompts):
            raise AssertionError(f"int8 {tag}: CPU plain path and CUDA "
                                 "kernel path disagree")

    prompt = np.array([3, 1, 4, 1, 5], np.int32)
    runs = []
    for model in (cpu, gpu):
        eng = GenerationEngine(model, **base)
        rid = eng.add_request(prompt, max_new_tokens=12)
        with torch.inference_mode():
            while len(eng._reqs[rid].out) < 4:     # mid-decode, tail partial
                eng.step()
            child = eng.fork_request(rid)
            out = eng.run()
        runs.append((out[rid], out[child], eng.blocks.cow_copies))
    (p_cpu, c_cpu, _), (p_gpu, c_gpu, cows) = runs
    same = np.array_equal(p_cpu, p_gpu) and np.array_equal(c_cpu, c_gpu)
    print(f"[agree:int8] fork: token-identical={same} cow_copies={cows} "
          f"parent==fork={np.array_equal(p_gpu, c_gpu)}", flush=True)
    if not same or cows < 1:
        raise AssertionError("int8 fork: CPU plain path and CUDA kernel path "
                             "disagree, or no copy-on-write happened")
    launches = K.launch_counts()
    _require_launched("agree:int8", launches, ("ragged_paged_attention_int8",
                                               "paged_decode_attention_int8"))
    _require_idle("agree:int8", launches, FLOAT_PAGED_KERNELS)


TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "rms_norm",
                 "swiglu", "fused_rope", "fused_rope_bwd")


def _train_step(model, lr, multi_precision=False):
    """(compile_train_step over the model's loss with AdamW(lr), the
    optimizer)."""
    from paddle_tpu_torch.jit import compile_train_step
    from paddle_tpu_torch.optimizer import AdamW

    opt = AdamW(lr, parameters=model.parameters(),
                multi_precision=multi_precision)
    return compile_train_step(model, lambda m, i, l: m(i, labels=l),
                              opt), opt


def _release():
    """Free what earlier phases left on the card, so that the next peak
    reading is the next phase's own."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def phase_agree_train(dev):
    """The tiny pair trains: the first backward's gradients and 3 steps of
    compile_train_step with AdamW(1e-3) on a fixed batch, CPU plain
    versions against CUDA kernels, in float32. Tolerances: gradients 1e-4
    absolute plus 1e-4 relative, losses 1e-4 (the same float32 products
    summed in other orders by the kernels, cuBLAS and the CPU's BLAS; AdamW
    steps each near-zero gradient by ~lr * sign, so parameters are not
    held, the losses they give are). Every kernel of the training path
    must launch on the card."""
    from paddle_tpu_torch.ops import kernels as K

    _, cpu, gpu = _tiny_pair(dev)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, cpu.config.vocab_size, (2, 16))
    lab = rng.integers(0, cpu.config.vocab_size, (2, 16))
    lab[0, :3] = -100
    batch = {"cpu": (torch.from_numpy(ids), torch.from_numpy(lab))}
    batch["gpu"] = tuple(t.to(dev) for t in batch["cpu"])
    K.reset_launch_counts()
    grads = {}
    for tag, model in (("cpu", cpu), ("gpu", gpu)):
        model(batch[tag][0], labels=batch[tag][1]).backward()
        grads[tag] = {n: p.grad.detach().cpu().clone()
                      for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
    worst = max(float(((grads["gpu"][n] - g).abs() - 1e-4 * g.abs()).max())
                for n, g in grads["cpu"].items())
    losses = {tag: [float(step(*batch[tag])) for _ in range(3)]
              for tag, (step, _) in (("cpu", _train_step(cpu, 1e-3)),
                                     ("gpu", _train_step(gpu, 1e-3)))}
    launches = K.launch_counts()
    loss_err = max(abs(a - b) for a, b in zip(losses["cpu"], losses["gpu"]))
    print(f"[agree:train] tiny f32, 3 AdamW steps: losses cpu "
          f"{losses['cpu']} cuda {losses['gpu']} max_err={loss_err:.3e} "
          f"(<= 1e-4); first-step grads max(|err| - 1e-4 |grad|)="
          f"{worst:.3e} (<= 1e-4); launches "
          f"{json.dumps({k: launches[k] for k in TRAIN_KERNELS})}",
          flush=True)
    if worst > 1e-4 or loss_err > 1e-4:
        raise AssertionError("training: CPU plain path and CUDA kernel path "
                             "disagree")
    if not losses["gpu"][-1] < losses["gpu"][0]:
        raise AssertionError("training: the tiny model's loss did not fall")
    _require_launched("agree:train", launches, TRAIN_KERNELS)


def _agree_grads(cpu_t, gpu_t):
    """max(|err| - 1e-4 |want|) over the named tensors' grads (CPU plain
    against CUDA kernels)."""
    return max(float(((g.grad.detach().cpu() - c.grad).abs() -
                      1e-4 * c.grad.abs()).max())
               for c, g in zip(cpu_t, gpu_t))


def phase_agree_masked(dev):
    """The masked and fused paths, CPU plain versions against CUDA kernels,
    in float32: the tiny Llama with a padded-batch attn_mask (logits, loss,
    first gradients), the tiny fused_feedforward (post-norm, gelu, p = 0)
    and F.flashmask_attention in each bound form (out and grads). All
    within 1e-4 (gradients: |err| <= 1e-4 + 1e-4 |grad|). The flashmask
    kernels and the bdrln kernel must launch."""
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import kernels as K

    K.reset_launch_counts()
    _, cpu, gpu = _tiny_pair(dev)
    rng = np.random.default_rng(7)
    s = 16
    ids = torch.from_numpy(rng.integers(0, cpu.config.vocab_size, (2, s)))
    lab = torch.from_numpy(rng.integers(0, cpu.config.vocab_size, (2, s)))
    lab[1, 11:] = -100
    pos = torch.arange(s)
    mask = (pos[None, :] <= pos[:, None])[None, None] & \
        (pos[None, None, None, :] < torch.tensor([s, 11])[:, None, None, None])
    with torch.no_grad():
        lc = cpu(ids, attn_mask=mask)
        lg = gpu(ids.to(dev), attn_mask=mask.to(dev)).cpu()
    logit_err = _max_err(lc, lg)
    losses = []
    for model, d in ((cpu, "cpu"), (gpu, dev)):
        loss = model(ids.to(d), labels=lab.to(d), attn_mask=mask.to(d))
        loss.backward()
        losses.append(float(loss.detach()))
    grad_err = _agree_grads(list(cpu.parameters()),
                            list(gpu.parameters()))
    loss_err = abs(losses[0] - losses[1])
    print(f"[agree:masked] tiny Llama, padded batch (lengths {s}/11) with "
          f"attn_mask: logits max_err={logit_err:.3e} loss cpu/cuda="
          f"{losses[0]:.6f}/{losses[1]:.6f} first grads max(|err| - 1e-4 "
          f"|grad|)={grad_err:.3e}", flush=True)
    if logit_err > 1e-4 or loss_err > 1e-4 or grad_err > 1e-4:
        raise AssertionError("agree:masked: the masked Llama disagrees "
                             "between the CPU and the card")

    h, f = 32, 64
    arrs = [rng.standard_normal(shp).astype(np.float32) * sc
            for shp, sc in (((2, 8, h), 1.0), ((h, f), 0.2), ((f, h), 0.2),
                            ((f,), 1.0), ((h,), 1.0), ((h,), 1.0),
                            ((h,), 1.0))]
    outs, leaves = [], []
    for d in ("cpu", dev):
        ts = [torch.from_numpy(a).to(d).requires_grad_() for a in arrs]
        o = IF.fused_feedforward(ts[0], ts[1], ts[2], linear1_bias=ts[3],
                                 linear2_bias=ts[4], ln2_scale=ts[5],
                                 ln2_bias=ts[6], dropout1_rate=0.0,
                                 dropout2_rate=0.0, activation="gelu")
        o.backward(torch.ones_like(o))
        outs.append(o.detach().cpu())
        leaves.append(ts)
    ffn_err = _max_err(*outs)
    ffn_grad = _agree_grads(*leaves)
    print(f"[agree:masked] tiny fused_feedforward (post-norm, gelu, p=0): "
          f"out max_err={ffn_err:.3e} grads max(|err| - 1e-4 |grad|)="
          f"{ffn_grad:.3e}", flush=True)
    if ffn_err > 1e-4 or ffn_grad > 1e-4:
        raise AssertionError("agree:masked: fused_feedforward disagrees "
                             "between the CPU and the card")

    b, sq, hq, hkv, d_ = 2, 64, 4, 2, 16
    col = np.arange(sq)
    for causal, nb, kh in ((True, 1, 1), (True, 2, hkv), (False, 2, hq),
                           (False, 4, hkv)):
        shp = (b, kh, sq)
        lts = np.maximum(rng.integers(1, sq + 1, shp), col + 1)
        if causal:
            idx = lts[..., None] if nb == 1 else np.stack(
                [lts, np.minimum(lts + rng.integers(0, sq, shp), sq)], -1)
        else:
            ute = np.minimum(rng.integers(0, sq, shp), col)
            idx = np.stack([lts, ute], -1) if nb == 2 else np.stack(
                [lts, np.minimum(lts + rng.integers(0, sq // 2, shp), sq),
                 np.maximum(ute - rng.integers(0, sq // 2, shp), 0), ute],
                -1)
        idx = torch.from_numpy(idx.astype(np.int32))
        qkv = [rng.standard_normal(shp_).astype(np.float32)
               for shp_ in ((b, sq, hq, d_), (b, sq, hkv, d_),
                            (b, sq, hkv, d_))]
        res = []
        for d in ("cpu", dev):
            ts = [torch.from_numpy(a).to(d).requires_grad_() for a in qkv]
            o, lse = F.flashmask_attention(*ts, idx.to(d), causal=causal,
                                           return_softmax_lse=True)
            o.backward(torch.ones_like(o))
            res.append((o.detach().cpu(), lse.cpu(), ts))
        seen = res[0][1] > -1e29
        err = max(_max_err(res[0][0], res[1][0]),
                  _max_err(res[0][1][seen], res[1][1][seen]))
        g_err = _agree_grads(res[0][2], res[1][2])
        print(f"[agree:masked] F.flashmask_attention causal={causal} "
              f"bounds={nb} kh={kh}: out/lse max_err={err:.3e} grads "
              f"max(|err| - 1e-4 |grad|)={g_err:.3e}", flush=True)
        if err > 1e-4 or g_err > 1e-4:
            raise AssertionError("agree:masked: flashmask disagrees between "
                                 "the CPU and the card")
    _require_launched("agree:masked", K.launch_counts(), MASKED_KERNELS)


# the tiny speculative workload of tests/test_speculative.py: four prompts,
# one of them a repeating pattern the n-gram drafter can follow
SPEC_PROMPTS = ([1, 2, 3], [9, 8, 7, 6, 5, 4, 3], [5, 6, 7, 8] * 5, [42, 17])
# int8 pages: a verify window that opens a page freezes the page's scale
# over every row of the window in it (a decode step: its one row), so
# spec-on tokens may leave spec-off ones, as the JAX engine's do; the
# share of generated tokens allowed to differ (tests/test_kv_int8.py's)
INT8_SPEC_BUDGET = 0.25


def _serve_tiny(model, prompts, n_new, **kw):
    from paddle_tpu_torch.inference import GenerationEngine
    eng = GenerationEngine(model, **kw)
    rids = [eng.add_request(np.asarray(p), max_new_tokens=n_new)
            for p in prompts]
    with torch.inference_mode():
        out = eng.run()
    return eng, [out[r] for r in rids]


def _no_drafter_error(tag, eng):
    fb = eng.stats["spec_fallbacks"]
    if fb.get("drafter_error"):
        raise AssertionError(f"[{tag}] the drafter raised ({fb}): "
                             f"{eng.spec_last_error!r}")


def phase_agree_spec(dev):
    """The tiny pair with speculative decoding, float and int8 pools: the
    n-gram drafter and self-drafting (DraftModelDrafter over the model
    itself), then a long prompt chunking through the ragged program while
    running slots commit spec bundles. CUDA spec-on tokens must equal the
    CPU plain path's spec-on tokens and, over float pools, the spec-off
    tokens (int8: within INT8_SPEC_BUDGET, as on the CPU); float
    self-drafting must accept every draft."""
    from paddle_tpu_torch.inference import DraftModelDrafter
    from paddle_tpu_torch.ops import kernels as K

    _, cpu, gpu = _tiny_pair(dev)
    kw = dict(max_slots=4, page_size=4, max_seq_len=96, mixed_step=False)
    K.reset_launch_counts()
    for kv in (None, "int8"):
        name = "float" if kv is None else "int8"
        off = [_serve_tiny(m, SPEC_PROMPTS, 24, spec_decode=False,
                           kv_dtype=kv, **kw)[1] for m in (cpu, gpu)]
        if not all(np.array_equal(a, b) for a, b in zip(*off)):
            raise AssertionError(f"[agree:spec] {name} spec-off: CPU plain "
                                 "path and CUDA kernel path disagree")
        for drafter in ("ngram", "self-draft"):
            runs = []
            for m in (cpu, gpu):
                spec = "ngram" if drafter == "ngram" else \
                    DraftModelDrafter(m)
                runs.append(_serve_tiny(m, SPEC_PROMPTS, 24, spec_decode=spec,
                                        kv_dtype=kv, **kw))
            (_, on_cpu), (eng, on_gpu) = runs
            st = eng.stats
            same_cpu = all(np.array_equal(a, b)
                           for a, b in zip(on_gpu, on_cpu))
            diff = sum(int(np.count_nonzero(a != b))
                       for a, b in zip(on_gpu, off[1]))
            print(f"[agree:spec] {name} {drafter}: cuda == cpu spec-on "
                  f"{same_cpu}; generated tokens differing from spec-off "
                  f"{diff}/{24 * len(SPEC_PROMPTS)}; verify dispatches="
                  f"{st['spec_dispatches']} drafted="
                  f"{st['spec_draft_tokens']} accepted="
                  f"{st['spec_accepted_tokens']} rollbacks="
                  f"{st['spec_rollbacks']} fallbacks={st['spec_fallbacks']}",
                  flush=True)
            _no_drafter_error("agree:spec", eng)
            if not same_cpu:
                raise AssertionError(f"[agree:spec] {name} {drafter}: CPU "
                                     "plain path and CUDA kernel path "
                                     "disagree")
            if diff > (0 if kv is None else
                       INT8_SPEC_BUDGET * 24 * len(SPEC_PROMPTS)):
                raise AssertionError(f"[agree:spec] {name} {drafter}: "
                                     f"{diff} tokens differ from spec-off")
            if st["spec_dispatches"] < 1 or st["spec_draft_tokens"] < 1:
                raise AssertionError(f"[agree:spec] {name} {drafter}: no "
                                     "verify dispatch drafted anything")
            if kv is None and drafter == "self-draft" and \
                    st["spec_accepted_tokens"] != st["spec_draft_tokens"]:
                raise AssertionError("[agree:spec] float self-drafting "
                                     "rejected a draft")

    # the chunked-prefill interleave: a 40-token prompt (5 chunks of 8)
    # admitted mid-decode while self-drafted bundles commit
    long_prompt = np.random.RandomState(7).randint(1, 128, size=40)
    ikw = dict(max_slots=3, page_size=4, max_seq_len=96, prefill_chunk=8,
               mixed_step=False)

    def interleave(model, spec):
        from paddle_tpu_torch.inference import GenerationEngine
        eng = GenerationEngine(model, spec_decode=spec, **ikw)
        r1 = eng.add_request(np.tile(np.array([5, 6, 7, 8]), 4), 24)
        r2 = eng.add_request(np.array([9, 8, 7]), 24)
        with torch.inference_mode():
            while not (eng._reqs[r1].out and eng._reqs[r2].out):
                eng.step()
            r3 = eng.add_request(long_prompt, 12)
            out = eng.run()
        return eng, [out[r] for r in (r1, r2, r3)]

    _, want = interleave(cpu, False)
    eng, got = interleave(gpu, DraftModelDrafter(gpu))
    _, off = interleave(gpu, False)
    st = eng.stats
    same = all(np.array_equal(a, b) for a, b in zip(got, want)) and \
        all(np.array_equal(a, b) for a, b in zip(got, off))
    print(f"[agree:spec] chunked-prefill interleave (self-draft): cuda "
          f"spec-on == cuda spec-off == cpu {same}; ragged_steps="
          f"{st['ragged_steps']} verify dispatches={st['spec_dispatches']} "
          f"accepted={st['spec_accepted_tokens']}/"
          f"{st['spec_draft_tokens']}", flush=True)
    _no_drafter_error("agree:spec", eng)
    if not same or st["ragged_steps"] < 5 or \
            st["spec_accepted_tokens"] != st["spec_draft_tokens"]:
        raise AssertionError("[agree:spec] the interleave disagrees, or did "
                             "not chunk, or rejected a self-draft")
    _require_launched("agree:spec", K.launch_counts(), RAGGED_KERNELS)


# the weight [surface] changes in place mid-run (x 3: the tokens move)
SWAP_PARAM = "llama.layers.0.self_attn.o_proj.weight"


def phase_surface(dev):
    """The request lifecycle on the card (tiny f32 pair): two threads
    streaming from one engine, a cancel that frees every page at once, an
    export/import round trip through the CPU engine and back, and a weight
    swap mid-run, each held to the CPU plain path's tokens."""
    import threading

    from paddle_tpu_torch.inference import (GenerationEngine,
                                            RequestCancelledError)

    _, cpu, gpu = _tiny_pair(dev)
    prompts = [np.array(p) for p in SPEC_PROMPTS[:3]]
    kw = dict(max_slots=2, page_size=4, max_seq_len=64, mixed_step=False)
    want = _serve_tiny(cpu, prompts, 16, **kw)[1]
    gen = [w[len(p):].tolist() for w, p in zip(want, prompts)]

    eng = GenerationEngine(gpu, **kw)
    got = {}

    def consume(idx):
        for i in idx:
            got[i] = list(eng.stream(prompts[i], 16))

    threads = [threading.Thread(target=consume, args=(idx,))
               for idx in ([0, 2], [1])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    streams_ok = got == dict(enumerate(gen))

    it = eng.stream(prompts[0], 16)
    next(it)
    rid = max(eng._reqs)
    eng.cancel_request(rid)
    freed = bool(np.all(eng.blocks.refcount[1:] == 0))
    try:
        list(it)
        cut = False
    except RequestCancelledError:
        cut = True

    # export mid-decode -> the CPU engine -> export -> back to the card
    rid = eng.add_request(prompts[2], max_new_tokens=16)
    with torch.inference_mode():
        while len(eng._reqs[rid].out) < 3:
            eng.step()
    snap = eng.remove_request(rid)
    ceng = GenerationEngine(cpu, **kw)
    crid = ceng.import_request(snap)
    with torch.inference_mode():
        while len(ceng._reqs[crid].out) < 4:
            ceng.step()
    snap2 = ceng.remove_request(crid)
    rid = eng.import_request(snap2)
    round_trip = np.array_equal(eng.run()[rid], want[2])

    # a swap mid-run on fresh copies (the same change on both devices)
    _, cpu2, gpu2 = _tiny_pair(dev)
    outs = []
    for m in (cpu2, gpu2):
        e = GenerationEngine(m, **kw)
        rids = [e.add_request(p, max_new_tokens=16) for p in prompts[:2]]
        with torch.inference_mode():
            while not all(len(e._reqs[r].out) >= 2 for r in rids):
                e.step()
        w = dict(m.named_parameters())[SWAP_PARAM]
        e.swap_weights(lambda w=w: w.mul_(3.0), tag="b")
        with torch.inference_mode():
            res = e.run()
        outs.append(([res[r] for r in rids], e._weight_epoch,
                     len(e.blocks._index)))
    swap_ok = all(np.array_equal(a, b) for a, b in zip(outs[0][0],
                                                       outs[1][0]))
    moved = any(not np.array_equal(a, w) for a, w in zip(outs[1][0], want))
    print(f"[surface] two threads streaming == cpu run(): {streams_ok}; "
          f"cancel freed every page: {freed}, stream raised "
          f"RequestCancelledError: {cut}; export/import card -> cpu -> card "
          f"token-exact: {round_trip}; swap_weights mid-run: cuda == cpu {swap_ok}, "
          f"tokens moved {moved}, epoch {outs[1][1]}, index entries after "
          f"{outs[1][2]}", flush=True)
    if not (streams_ok and freed and cut and round_trip and swap_ok and
            moved and outs[1][1] == 1 and outs[1][2] == 0):
        raise AssertionError("[surface] the lifecycle surface disagrees "
                             "with the CPU plain path")


def _set_graphs(eng, on):
    """Graphs on or off (the private eager twin) for an engine and its
    draft model's private engine; before the engine's first step."""
    eng._graphs = on
    inner = getattr(eng._spec, "_eng", None)
    if inner is not None:
        inner._graphs = on


def _trace_counts(eng):
    """The engine's trace counters (the JAX engine's names), and the draft
    model's engine's under "draft."."""
    from paddle_tpu_torch.inference.programs import TRACE_COUNTERS
    out = {n: getattr(eng, n) for n in TRACE_COUNTERS.values()}
    inner = getattr(eng._spec, "_eng", None)
    if inner is not None:
        out.update({f"draft.{n}": getattr(inner, n)
                    for n in TRACE_COUNTERS.values()})
    return out


def _captures(eng):
    """{kind: CUDA graphs captured} of the engine (and its draft
    engine's, under "draft.")."""
    out = {k: v for k, v in eng._programs.captured().items() if v}
    inner = getattr(eng._spec, "_eng", None)
    if inner is not None:
        out.update({f"draft.{k}": v for k, v in
                    inner._programs.captured().items() if v})
    return out


def _wave(eng, prompts, n_new, temperature=0.0):
    """One wave of requests through a (reused) engine; the prefix index is
    dropped first, so a repeat wave sees the shapes of the first."""
    eng.blocks.invalidate_index()
    rids = [eng.add_request(np.asarray(p), max_new_tokens=n_new,
                            temperature=temperature) for p in prompts]
    with torch.inference_mode():
        out = eng.run()
    return [out[r] for r in rids]


def phase_agree_graphs(dev):
    """The tiny f32 model on the card, every step program a replayed CUDA
    graph against the eager twin (``_graphs = False``): greedy and seeded
    sampled tokens, float and int8 pools, the prefix-sharing chunked
    workload and the dense-admission one, a fork mid-decode (the CoW copy
    program) and self-drafting spec must be token-identical, with equal
    kernel launch counts (the replays' counted from their captures); a
    second wave of the same shapes adds nothing to any trace counter (the
    draft engine's too); a weight swap through an in-place loader keeps
    every program and gives a fresh engine's tokens, and a loader that
    moves a parameter drops them (the counters show the rebuilds)."""
    from paddle_tpu_torch.inference import DraftModelDrafter, GenerationEngine
    from paddle_tpu_torch.ops import kernels as K

    cfg, _, gpu = _tiny_pair(dev)
    chunked = (_serving_prompts(np.random.default_rng(1), 6, 9, 20,
                                cfg.vocab_size, 12, (0, 4)),
               dict(max_slots=2, page_size=4, max_seq_len=64,
                    prefix_cache=True, prefill_chunk=8, mixed_step=True))
    dense = (_serving_prompts(np.random.default_rng(3), 6, 3, 9,
                              cfg.vocab_size, 4, (0, 4)),
             dict(max_slots=3, page_size=4, max_seq_len=64,
                  prefix_cache=True, prefill_chunk=8, mixed_step=True))
    spec_kw = dict(max_slots=4, page_size=4, max_seq_len=96,
                   mixed_step=False)
    bad = []
    for kv in (None, "int8"):
        name = "float" if kv is None else "int8"
        cases = [(f"{name} chunked+prefix {mode}", chunked, t)
                 for mode, t in (("greedy", 0.0), ("sampled", 0.8))]
        cases += [(f"{name} dense admission {mode}", dense, t)
                  for mode, t in (("greedy", 0.0), ("sampled", 0.8))]
        for tag, (prompts, kw), temp in cases:
            runs = []
            for on in (True, False):
                eng = GenerationEngine(gpu, kv_dtype=kv, seed=11, **kw)
                _set_graphs(eng, on)
                K.reset_launch_counts()
                first = _wave(eng, prompts, 12, temp)
                launches = K.launch_counts()
                marks = _trace_counts(eng)
                _wave(eng, prompts, 12, temp)
                runs.append((first, launches, marks, _trace_counts(eng),
                             _captures(eng)))
            (g_tok, g_l, g_m, g_m2, caps), (e_tok, e_l, _, _, _) = runs
            same = all(np.array_equal(a, b) for a, b in zip(g_tok, e_tok))
            frozen = g_m == g_m2
            print(f"[agree:graphs] {tag}: graphs == eager {same}; launches "
                  f"equal {g_l == e_l}; repeat wave adds no program "
                  f"{frozen} {json.dumps(g_m)}; captured {json.dumps(caps)}",
                  flush=True)
            if not (same and g_l == e_l and frozen and caps):
                bad.append(tag)

        # a fork mid-decode: the CoW copy program
        runs = []
        for on in (True, False):
            eng = GenerationEngine(gpu, kv_dtype=kv, **chunked[1])
            _set_graphs(eng, on)
            rid = eng.add_request(np.array([3, 1, 4, 1, 5]), 12)
            with torch.inference_mode():
                while len(eng._reqs[rid].out) < 4:
                    eng.step()
                child = eng.fork_request(rid)
                out = eng.run()
            runs.append(([out[rid], out[child]], eng.copy_trace_count,
                         _captures(eng).get("copy", 0)))
        same = all(np.array_equal(a, b) for a, b in zip(runs[0][0],
                                                         runs[1][0]))
        print(f"[agree:graphs] {name} fork: graphs == eager {same}; copy "
              f"programs {runs[0][1]}, captured {runs[0][2]}", flush=True)
        if not (same and runs[0][2] >= 1):
            bad.append(f"{name} fork")

        # self-drafting: the verify program and the draft engine's
        runs = []
        for on in (True, False):
            eng = GenerationEngine(gpu, kv_dtype=kv,
                                   spec_decode=DraftModelDrafter(
                                       gpu, kv_dtype=kv), **spec_kw)
            _set_graphs(eng, on)
            first = _wave(eng, SPEC_PROMPTS, 24)
            marks = _trace_counts(eng)
            _wave(eng, SPEC_PROMPTS, 24)
            runs.append((first, marks, _trace_counts(eng), _captures(eng),
                         eng.stats["spec_accepted_tokens"],
                         eng.stats["spec_draft_tokens"]))
            _no_drafter_error("agree:graphs", eng)
        (g_tok, m1, m2, caps, acc, drafted), (e_tok, *_rest) = runs
        same = all(np.array_equal(a, b) for a, b in zip(g_tok, e_tok))
        print(f"[agree:graphs] {name} self-draft: graphs == eager {same}; "
              f"accepted {acc}/{drafted}; repeat wave adds no program "
              f"{m1 == m2} {json.dumps(m2)}; captured {json.dumps(caps)}",
              flush=True)
        if not (same and m1 == m2 and caps.get("verify")
                and caps.get("draft.decode") and drafted > 0):
            bad.append(f"{name} self-draft")

    # weight swaps: in place (programs kept) and moving a parameter
    prompts, kw = chunked
    eng = GenerationEngine(gpu, **kw)
    _wave(eng, prompts, 12)
    marks = _trace_counts(eng)
    w = dict(gpu.named_parameters())[SWAP_PARAM]
    eng.swap_weights(lambda: w.mul_(3.0), tag="b")
    swapped = _wave(eng, prompts, 12)
    kept = _trace_counts(eng) == marks
    fresh = _wave(GenerationEngine(gpu, **kw), prompts, 12)
    equal = all(np.array_equal(a, b) for a, b in zip(swapped, fresh))

    def move():
        w.data = w.data * (1.0 / 3.0)      # a new tensor: a new address

    eng.swap_weights(move, tag="c")
    moved = _wave(eng, prompts, 12)
    rebuilt = _trace_counts(eng)
    again = _wave(GenerationEngine(gpu, **kw), prompts, 12)
    print(f"[agree:graphs] swap_weights in place: programs kept {kept}, "
          f"tokens == a fresh engine's {equal}; a moved parameter: "
          f"programs rebuilt {json.dumps(rebuilt)} (before "
          f"{json.dumps(marks)}), tokens == a fresh engine's "
          f"{all(np.array_equal(a, b) for a, b in zip(moved, again))}",
          flush=True)
    if not (kept and equal and all(rebuilt[k] >= 2 * marks[k] for k in marks
                                   if marks[k])
            and all(np.array_equal(a, b) for a, b in zip(moved, again))):
        bad.append("swap_weights")
    if bad:
        raise AssertionError(f"[agree:graphs] failed: {bad}")


MASKED_KERNELS = ("flashmask_attention", "flashmask_attention_bwd",
                  "bias_dropout_residual_ln")
FLASHMASK_SHAPE = (4, 2048, 16, 128)       # [train]'s attention geometry
FLASHMASK_CALLS = 3
FLASHMASK_7B = (1, 8192, 32, 128)          # Llama-2-7B attention, S = 8192


def _profile_calls(tag, call, note):
    """One more call of `call` under torch.profiler: device time by kernel
    and the device's idle share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _print_profile(tag, prof, wall, note)


def phase_flashmask(K, dev):
    """The flashmask path: F.flashmask_attention through autograd at the
    training geometry [4, 2048, 16, 128] bf16 with a packed-document
    causal mask; a warm-up and FLASHMASK_CALLS timed forward+backward
    calls with the launch counts set to 0 before and read after (each
    call must launch the masked forward and backward once); out and
    grads held against the plain versions. Then the forward at the
    Llama-2-7B width, [1, 8192, 32, 128], beside SDPA with the dense mask,
    its output held against SDPA's within the bf16 attention tolerance.
    Returns the launch counts of the timed calls."""
    from paddle_tpu_torch.nn import functional as F

    _release()
    rng = np.random.default_rng(21)
    b, s, h, d = FLASHMASK_SHAPE
    causal, bounds, dense, pairs = _flashmask_case(rng, dev, b, s, h, h,
                                                   "doc")
    del dense
    idx = bounds[0][..., None]           # the document ends, 1 bound
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (b, s, h, d), dtype=np.float32)).to(dev, torch.bfloat16)
        for _ in range(4))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]

    def call():
        for t in leaves:
            t.grad = None
        out = F.flashmask_attention(*leaves, idx, causal=True)
        out.backward(do)
        return out

    call()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(FLASHMASK_CALLS):
        out = call()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / FLASHMASK_CALLS
    launches = K.launch_counts()
    # the plain versions round P and dS where the tensor-core kernels do;
    # the plain backward takes the kernel's out and lse, as in [kernels]
    bf16 = torch.bfloat16
    want_out, _ = K.flashmask_attention_fwd_plain(q, k, v, *bounds,
                                                  causal=True, p_dtype=bf16)
    k_out, k_lse = K.flashmask_attention_fwd(q, k, v, *bounds, causal=True)
    want = K.flashmask_attention_bwd_plain(q, k, v, k_out, k_lse, do,
                                           *bounds, causal=True,
                                           p_dtype=bf16)
    out_err = _max_err(out.detach(), want_out)
    rule = _grad_rule([t.grad for t in leaves], want, _rounding_terms(
        K, q, k, v, k_out, k_lse, do, True, bounds))
    grads_ok, grads_rule = _within("flashmask_attention_bwd", rule, bf16)
    print(f"[flashmask] F.flashmask_attention fwd+bwd [{b}, {s}, {h}, {d}] "
          f"bf16, packed documents (lengths 64-1024), causal, "
          f"{pairs} visible pairs: ms_per_call={ms:.3f} (host clock, "
          f"{FLASHMASK_CALLS} calls) out max_err={out_err:.3e} (<= 2e-2) "
          f"dq/dk/dv elements beyond 2^-7|want| + 2^-8 rms(want) "
          f"(allowed)=" + "/".join(f"{c}({_over_allowed(n)})" for c, n in
                     zip(rule["over_n"], rule["n"])) + " share="
          + "/".join(f"{o:.2e}" for o in rule["over"]) +
          " err/(that + 2^-7 sum|terms|)="
          + "/".join(f"{w:.3f}" for w in rule["bound"]) +
          f" ({grads_rule})" +
          f" launches {json.dumps({n: launches[n] for n in MASKED_KERNELS})}"
          f" tensor-core route "
          f"{json.dumps({n: launches[n + '.sm90'] for n in MASKED_KERNELS[:2]})}",
          flush=True)
    if out_err > TOL[bf16] or not grads_ok:
        raise AssertionError("[flashmask] the path's out or grads disagree "
                             "with the plain versions")
    _profile_calls("profile:flashmask", call, "one forward+backward call")
    for n in ("flashmask_attention", "flashmask_attention_bwd"):
        if launches[n] != FLASHMASK_CALLS or \
                launches[f"{n}.sm90"] != FLASHMASK_CALLS:
            raise AssertionError(f"[flashmask] {n} launched {launches[n]} "
                                 f"times ({launches[f'{n}.sm90']} on the "
                                 f"tensor-core route) in {FLASHMASK_CALLS} "
                                 f"calls")
    del out, want, want_out, k_out, k_lse, leaves, q, k, v, do
    _release()

    # Llama-2-7B attention width at S = 8192 (no plain version: its float32
    # score tensors alone would be 8.6 GB each)
    b, s, h, d = FLASHMASK_7B
    causal, bounds, dense, pairs = _flashmask_case(rng, dev, b, s, h, h,
                                                   "doc")
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (b, s, h, d), dtype=np.float32)).to(dev, torch.bfloat16)
        for _ in range(3))
    got, _ = K.flashmask_attention_fwd(q, k, v, *bounds, causal=True)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ref = sdpa(qt, kt, vt, attn_mask=dense).transpose(1, 2)
    err = _max_err(got, ref)
    k_ms = _time_ms(lambda: K.flashmask_attention_fwd(q, k, v, *bounds,
                                                      causal=True), 5)
    l_ms = _time_ms(lambda: sdpa(qt, kt, vt, attn_mask=dense), 5)
    bound, by = _bound_ms((4 * q.numel()) * 2 + _bounds_bytes(bounds),
                          4 * d * pairs, torch.bfloat16)
    print(f"[flashmask] 7B width [{b}, {s}, {h}, {d}] bf16, packed documents: "
          f"{pairs} visible pairs; kernel_ms={k_ms:.4f} sdpa_dense_mask_ms="
          f"{l_ms:.4f} bound_ms={bound:.4f} ({by}); max_abs_err vs SDPA="
          f"{err:.3e} (<= 2e-2)", flush=True)
    if err > TOL[torch.bfloat16]:
        raise AssertionError("[flashmask] the 8192 forward disagrees with "
                             "SDPA")
    return launches


FFN_SHAPE = (32, 512, 768, 3072)           # BERT-base: hidden 768, FFN 3072
FFN_CALLS = 5


def phase_fused_ffn(K, dev):
    """The fused FFN path at BERT-base width (bert.py:13): fused_feedforward
    post-norm on [32, 512, 768] bf16, gelu, dropout1 = dropout2 = 0.1,
    ln_epsilon 1e-12, training; forward and backward, a warm-up and
    FFN_CALLS timed calls; bdrln must launch once per call. Then the
    FusedBiasDropoutResidualLayerNorm layer at the same shape. One more
    call is held against the plain versions on the same inputs: the same
    ops replayed from the same generator state with the plain bdrln in
    place of the kernel. The path's output must equal the kernel's on the
    replay's pre-LN tensor bit for bit (so dropout1, GELU, the bias, the
    residual and the seed are the path's), the kernel's there the plain
    bdrln's within one bf16 ulp plus 2^-16 (|n w| + |b| + |w|), and every
    input's gradient the replay's within 1e-2 of its norm (the replay's
    LayerNorm backward differentiates the float32 y, the path's the y
    saved in bf16: ~0.5% apart). The |w| term is new against [kernels]'
    rule: n = (y - mean) / std is near 0 where y ~ mean, the two sides'
    float32 means (summed in other orders) differ by ~1e-7 absolute, and
    LN2's b is 0 here, so |b| gives no slack. Returns the launch counts of
    the timed fused_feedforward calls."""
    from paddle_tpu_torch.incubate.nn import FusedBiasDropoutResidualLayerNorm
    from paddle_tpu_torch.framework.random import next_seed
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.nn import functional as F

    _release()
    b, s, h, f = FFN_SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(
            torch.bfloat16).requires_grad_()

    x = rnd(b, s, h)
    w1, w2 = rnd(h, f, std=0.02), rnd(f, h, std=0.02)
    b1, b2 = rnd(f, std=0.02), rnd(h, std=0.02)
    s2 = torch.ones(h, device=dev, dtype=torch.bfloat16, requires_grad=True)
    c2 = torch.zeros(h, device=dev, dtype=torch.bfloat16, requires_grad=True)
    g = torch.randn((b, s, h), generator=gen, device=dev).to(torch.bfloat16)

    def call():
        out = IF.fused_feedforward(
            x, w1, w2, linear1_bias=b1, linear2_bias=b2, ln2_scale=s2,
            ln2_bias=c2, dropout1_rate=0.1, dropout2_rate=0.1,
            activation="gelu", ln_epsilon=1e-12, pre_layer_norm=False,
            training=True)
        out.backward(g)
        return out

    call()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(FFN_CALLS):
        out = call()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / FFN_CALLS
    launches = K.launch_counts()
    print(f"[fused_ffn] fused_feedforward post-norm [{b}, {s}, {h}] -> {f} "
          f"bf16, gelu, dropout 0.1/0.1, eps 1e-12, training, fwd+bwd: "
          f"ms_per_call={ms:.3f} (host clock, {FFN_CALLS} calls); "
          f"bias_dropout_residual_ln launches="
          f"{launches['bias_dropout_residual_ln']}", flush=True)
    if launches["bias_dropout_residual_ln"] != FFN_CALLS:
        raise AssertionError("[fused_ffn] bdrln did not launch once per "
                             "call")
    _profile_calls("profile:fused_ffn", call, "one forward+backward call")

    params = (x, w1, w2, b1, b2, s2, c2)
    dgen = torch.Generator(device=dev)

    def held(plain):
        """(out, grads, the kernel's out on the replay's pre-LN tensor):
        the path, or the replay of its ops with the plain bdrln."""
        dgen.manual_seed(1)
        for t in params:
            t.grad = None
        if not plain:
            o = IF.fused_feedforward(
                x, w1, w2, linear1_bias=b1, linear2_bias=b2, ln2_scale=s2,
                ln2_bias=c2, dropout1_rate=0.1, dropout2_rate=0.1,
                activation="gelu", ln_epsilon=1e-12, pre_layer_norm=False,
                training=True, generator=dgen)
            o.backward(g)
            return o.detach().float(), [t.grad.float() for t in params], None
        hid = torch.nn.functional.gelu(F.linear(x, w1, b1),
                                       approximate="tanh")
        hid = F.dropout(hid, 0.1, training=True, generator=dgen)
        pre = torch.matmul(hid, w2)
        seed = next_seed(dgen)
        o = K.bias_dropout_residual_ln_plain(pre, x, s2, c2, b2, 1e-12, 0.1,
                                             seed)[0]
        o.backward(g)
        kern = K.bias_dropout_residual_ln(
            *(t.detach() for t in (pre, x, s2, c2, b2)), 1e-12, 0.1, seed)[0]
        return (o.detach().float(), [t.grad.float() for t in params],
                kern.float())

    got, got_grads, _ = held(plain=False)
    want, want_grads, kern = held(plain=True)
    same_pre = torch.equal(got, kern)
    c2f, s2f = c2.detach().float(), s2.detach().float()
    allow = _ulp_bf16(want) + 2.0 ** -16 * (
        (want - c2f).abs() + c2f.abs() + s2f.abs())
    worst = float(((kern - want).abs() / allow).max())
    grad_rel = [float((a - w).norm() / w.norm())
                for a, w in zip(got_grads, want_grads)]
    print(f"[fused_ffn] held against the plain replay: out equal to the "
          f"kernel on the replay's pre-LN tensor: {same_pre}; kernel vs "
          f"plain bdrln there max_abs_err={_max_err(kern, want):.3e} worst "
          f"err/allowed={worst:.3f}; grads' |got - want| / |want| (x, w1, "
          f"w2, b1, b2, ln2 scale, ln2 bias)="
          + ", ".join(f"{r:.2e}" for r in grad_rel), flush=True)
    if not (same_pre and worst <= 1.0 and all(r <= 1e-2 for r in grad_rel)):
        raise AssertionError("[fused_ffn] the path disagrees with the plain "
                             "replay on the same inputs")

    layer = FusedBiasDropoutResidualLayerNorm(h, dropout_rate=0.1,
                                              epsilon=1e-12, device=dev,
                                              dtype=torch.bfloat16)
    xr, res = rnd(b, s, h), rnd(b, s, h)
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FFN_CALLS):
        o = layer(xr, res)
        o.backward(g)
    torch.cuda.synchronize()
    lms = (time.perf_counter() - t0) * 1e3 / FFN_CALLS
    n = K.launch_counts()["bias_dropout_residual_ln"]
    print(f"[fused_ffn] FusedBiasDropoutResidualLayerNorm({h}) [{b}, {s}, "
          f"{h}] bf16, p 0.1, fwd+bwd: ms_per_call={lms:.3f}; "
          f"bias_dropout_residual_ln launches={n}", flush=True)
    if n != FFN_CALLS or not bool(torch.isfinite(o).all()):
        raise AssertionError("[fused_ffn] the layer did not launch bdrln "
                             "once per call, or its output is not finite")
    return launches


# [train]: the config bench.py trains on the TPU (bench.py:150-154), at
# full width and depth: a 0.74B Llama, batch 4 x 2048, bf16 parameters,
# AdamW(1e-4, multi_precision=True)
TRAIN_CFG = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5504,
                 num_hidden_layers=12, num_attention_heads=16,
                 num_key_value_heads=16, max_position_embeddings=2048)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 5
# launches of each kernel in one training step of TRAIN_CFG: two RMSNorms
# per layer and the final one; one RoPE launch per layer each way (q and k
# together), none on the scalar path; every flash launch on the
# tensor-core route (bf16, head dim 128)
TRAIN_PER_STEP = {"flash_attention": 12, "flash_attention_bwd": 12,
                  "flash_attention.sm90": 12, "flash_attention_bwd.sm90": 12,
                  "rms_norm": 25, "swiglu": 12, "fused_rope": 12,
                  "fused_rope.qk": 12, "fused_rope_bwd": 12,
                  "fused_rope.scalar": 0, "fused_rope_bwd.scalar": 0}


def _train_flops(cfg, n_matmul):
    """(flops of one training step counted from the shapes, formula):
    6 N T for the matmul parameters N (every Linear, the lm_head
    included), attention's 2 forward and 5 backward causal products per
    layer (14 B H D pairs), and the fused loss's recompute of the logits
    in backward (2 T H V)."""
    t = TRAIN_BATCH * TRAIN_SEQ
    hd = cfg.hidden_size // cfg.num_attention_heads
    pairs = _causal_pairs(TRAIN_SEQ, TRAIN_SEQ)
    attn = 14 * TRAIN_BATCH * cfg.num_attention_heads * hd * pairs * \
        cfg.num_hidden_layers
    loss = 2 * t * cfg.hidden_size * cfg.vocab_size
    total = 6 * n_matmul * t + attn + loss
    formula = (f"6*N*T + 14*B*H*D*pairs*L + 2*T*h*V = 6*{n_matmul}*{t} + "
               f"14*{TRAIN_BATCH}*{cfg.num_attention_heads}*{hd}*{pairs}*"
               f"{cfg.num_hidden_layers} + 2*{t}*{cfg.hidden_size}*"
               f"{cfg.vocab_size} = {total:.4e}")
    return total, formula


def _run_steps(tag, K, step, batch, per_step, n_timed, on_step=None):
    """One warm-up and n_timed timed calls of step(*batch), each timed on
    the host clock around a step that ends in float(loss) (a sync), its
    launches counted and held to per_step ({launch_counts key: launches});
    on_step(i) runs after each step (a scheduler's step). Returns (losses,
    ms per step, the timed steps' summed launches)."""
    losses, ms = [], []
    totals = dict.fromkeys(K.launch_counts(), 0)
    for i in range(n_timed + 1):
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(step(*batch))       # float() waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        counts = K.launch_counts()
        bad = {k: counts[k] for k, n in per_step.items() if counts[k] != n}
        if bad:
            raise AssertionError(f"[{tag}] step {i} launched {bad}, "
                                 f"expected {per_step}")
        if i:                            # step 0 is the warm-up
            for k in totals:
                totals[k] += counts[k]
        if on_step is not None:
            on_step(i)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[{tag}] a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"[{tag}] the loss did not fall: {losses}")
    return losses, ms, totals


def _train_batch(vocab, batch, seq, dev):
    """(ids, labels) [batch, seq] from seed 1: random ids and labels, not
    shifted, as bench.py draws them."""
    rng = np.random.default_rng(1)
    return tuple(torch.from_numpy(rng.integers(0, vocab, (batch, seq))).to(
        dev) for _ in range(2))


def phase_train(K, dev):
    """TRAIN_CFG with random weights from seed 0 and a fixed batch from
    seed 1 (random ids and labels, not shifted, as bench.py draws them):
    one warm-up step and TRAIN_STEPS timed steps of compile_train_step.
    Every loss must be finite and the last below the first; each step must
    launch the kernels TRAIN_PER_STEP times. Returns (launch counts over
    the timed steps, model, optimizer, batch, {losses, step_ms, peak_gb}
    for [train:remat] to hold itself against)."""
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    _release()
    cfg = LlamaConfig(**TRAIN_CFG)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    weights.init_random_(model, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    n_embed = model.llama.embed_tokens.weight.numel()
    step, opt = _train_step(model, 1e-4, multi_precision=True)
    ids, lab = _train_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, dev)
    losses, ms, totals = _run_steps("train", K, step, (ids, lab),
                                    TRAIN_PER_STEP, TRAIN_STEPS)
    timed = ms[1:]
    step_ms = sum(timed) / len(timed)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    peak = torch.cuda.max_memory_allocated() / 1e9
    flops, formula = _train_flops(cfg, n_params - n_embed)
    print(f"[train] bench.py:150 config: hidden {cfg.hidden_size}, ffn "
          f"{cfg.intermediate_size}, {cfg.num_hidden_layers} layers, "
          f"{cfg.num_attention_heads} heads, vocab {cfg.vocab_size}; "
          f"params={n_params} bf16 (matmul N={n_params - n_embed}); batch "
          f"{TRAIN_BATCH}x{TRAIN_SEQ}; AdamW(1e-4, multi_precision=True)")
    print(f"[train] losses (warm-up first) {losses}")
    print(f"[train] step_ms {[round(x, 2) for x in ms]} mean_timed="
          f"{step_ms:.2f} tokens_per_s={tokens / step_ms * 1e3:.1f} "
          f"peak_mem_gb={peak:.2f}")
    print(f"[train] flops/step {formula}; MFU={flops / (step_ms / 1e3) / 989e12:.4f}"
          f" (of 989 TFLOP/s bf16 dense)")
    print(f"[train] launches per step {json.dumps(TRAIN_PER_STEP)} (held "
          f"every step)", flush=True)
    _time_loss(model, dev)
    base = {"losses": losses, "step_ms": step_ms, "peak_gb": peak,
            "median_ms": _median(timed), "n_params": n_params}
    return totals, model, opt, (ids, lab), base


def _time_loss(model, dev):
    """The fused linear cross-entropy alone at the step's shape (hidden
    [8192, 2048] bf16 against the [2048, 32000] lm_head, chunks of 4096,
    float32 products): forward and backward, CUDA events."""
    from paddle_tpu_torch.nn import functional as F

    t = TRAIN_BATCH * TRAIN_SEQ
    w = model.lm_head.weight
    hid = torch.randn(t, w.shape[0], device=dev, dtype=w.dtype,
                      requires_grad=True)
    lab = torch.randint(0, w.shape[1], (t,), device=dev)

    def run():
        F.fused_linear_cross_entropy(hid, w, lab).backward()

    run()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(3):
        run()
    e1.record()
    torch.cuda.synchronize()
    model.zero_grad(set_to_none=True)
    ms = e0.elapsed_time(e1) / 3
    f = 8 * t * w.shape[0] * w.shape[1]
    print(f"[train] fused loss fwd+bwd alone: {ms:.2f} ms for {f:.3e} "
          f"float32 flops (4 products of 2*T*h*V) = "
          f"{f / ms / 1e9:.1f} TFLOP/s", flush=True)


def phase_profile_train(model, opt, batch):
    """One more training step under torch.profiler, written out as
    compile_train_step runs it: device time by kernel and by kind, the
    device's idle share of the step's wall time, and the split of the step
    into forward+loss, backward and optimizer (CUDA events around each)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ids, lab = batch
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ev[0].record()
        loss = model(ids, labels=lab)
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        opt.clear_grad()
        ev[3].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    phases = {name: ev[i].elapsed_time(ev[i + 1]) for i, name in
              enumerate(("forward+loss", "backward", "optimizer"))}
    print(f"[profile:train] phases (CUDA events, ms) "
          f"{json.dumps({k: round(v, 2) for k, v in phases.items()})}")
    _print_profile("profile:train", prof, wall, "one training step")
    kinds = {}
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = (getattr(e, "self_device_time_total", 0)
              or getattr(e, "self_cuda_time_total", 0))
        kinds[_kernel_kind(e.key)] = kinds.get(_kernel_kind(e.key), 0) + us
    busy = sum(kinds.values()) or 1
    print("[profile:train] by kind: " + ", ".join(
        f"{k} {v / 1e3:.2f} ms ({100 * v / busy:.1f}%)"
        for k, v in sorted(kinds.items(), key=lambda kv: -kv[1])),
        flush=True)


def _kernel_kind(name):
    """Kind of a device kernel by its name: the port's kernels by their
    CUDA names, cuBLAS products split by operand type (the fused loss's
    products are the float32 ones), the rest as PyTorch's own."""
    n = name.lower()
    for key, kind in (("flash_bwd", "flash backward"),
                      ("flash_dq", "flash backward"),
                      ("flash_dkv", "flash backward"),
                      ("flash_fwd", "flash forward"),
                      ("rms_norm", "rmsnorm"), ("swiglu", "swiglu"),
                      ("rope", "rope")):
        if key in n:
            return kind
    if any(k in n for k in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return ("GEMM float32 (loss)" if any(k in n for k in (
            "f32f32", "sgemm", "tf32", "_s1688", "fp32")) else "GEMM bf16")
    return "other (elementwise, reductions, optimizer, copies)"


# the serving model's depth: Llama-2-7B's widths at SERVE_LAYERS of its
# 32 layers (cut to 20 when the vision and RNN phases joined: at 32 the
# smoke took 707.4-789.3 s of command on H100 hosts of different speeds,
# the serving and fleet phases ~320 s of it; cut to 10 when the deploy
# phases joined: at 20 it took 677.4 and 924.9 s on two hosts, the serving
# and fleet phases 160-245 s of it; cut to 4 when the distributed
# training phases joined: at 10 it took 753.6 s on a slow host, the
# serving and fleet phases 118 s of it; every per-layer fact is held as
# at 32)
SERVE_LAYERS = 4


def _serving_model(dev):
    """Llama-2-7B geometry at SERVE_LAYERS layers, bfloat16, random
    weights from seed 0."""
    import dataclasses

    from paddle_tpu_torch import weights
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = dataclasses.replace(LlamaConfig.llama2_7b(),
                              num_hidden_layers=SERVE_LAYERS)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    weights.init_random_(model, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[serve] llama2_7b geometry, layers={cfg.num_hidden_layers}, "
          f"params={n_params / 1e9:.3f}B bf16, init_s="
          f"{time.perf_counter() - t0:.2f}", flush=True)
    return model


def _fresh_pools(model):
    """Drop the previous runs' engines (and their KV pools; a profiled
    engine may sit in a reference cycle until the collector runs)."""
    model.__dict__.pop("_engines", None)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _print_twin_diff(tag, gen, twin):
    """The share of generated tokens that differ from the bf16 twin run's
    (printed, not checked: random weights give no accuracy to hold)."""
    if twin is None:
        return
    diff = sum(int(np.count_nonzero(a != b)) for a, b in zip(gen, twin))
    total = sum(len(a) for a in gen)
    first = [int(np.argmax(a != b)) if np.any(a != b) else len(a)
             for a, b in zip(gen, twin)]
    print(f"[{tag}] generated tokens differing from the bf16 run: "
          f"{diff}/{total} = {diff / total:.4f}; first differing position "
          f"per request {first}")


def _serve_wave(eng, prompts, n_new):
    """One timed wave of the workload through a (reused) engine, the
    prefix index dropped first so that a repeat wave has the first one's
    shapes. Returns (generated tokens, the wave's stats (counters as
    deltas, "engine_steps" added), wall seconds, kernel launches, ttft
    seconds)."""
    from paddle_tpu_torch.ops import kernels as K

    before = dict(eng.stats, spec_fallbacks=dict(eng.stats["spec_fallbacks"]))
    n_ttft = len(eng.ttft_s)
    eng.blocks.invalidate_index()
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng._submit(p, n_new, 0.0, None, 0, None) for p in prompts]
    n_steps = 0
    with torch.inference_mode():
        while eng.has_work():
            eng.step()
            n_steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    st = {k: (v - before[k] if isinstance(v, (int, float)) and
              not isinstance(v, bool) and k != "kv_pool_bytes" else v)
          for k, v in eng.stats.items()}
    st["spec_fallbacks"] = {
        r: n - before["spec_fallbacks"].get(r, 0)
        for r, n in eng.stats["spec_fallbacks"].items()
        if n - before["spec_fallbacks"].get(r, 0)}
    st["engine_steps"] = n_steps
    ttft = sorted(list(eng.ttft_s)[n_ttft:])
    # a preemption folds generated tokens into the prompt
    gen = [np.concatenate([r.prompt, np.asarray(r.out, np.int32)])[len(p):]
           for r, p in zip(reqs, prompts)]
    return gen, st, wall, launches, ttft


def phase_serve(K, model, kv_dtype=None, twin=None, name="serve",
                programs=False):
    """8 requests of 300-900 tokens (requests 0 and 5 share a 512-token
    prefix), 32 greedy tokens each, on float pools or (kv_dtype="int8")
    int8 pools, through one engine whose step programs are CUDA graphs: a
    cold wave (each program's first use runs eagerly and captures it),
    then a warm wave of the same shapes (replays only: it must build no
    program) whose numbers stand for the run, and a third wave with engine
    steps PROFILE_STEPS under torch.profiler. Then the eager twin
    (``_graphs = False``) on a fresh engine: a timed wave, which must
    give the warm wave's tokens and kernel launches, and a profiled one.
    Returns the warm wave's kernel launches, generated tokens and stats.
    `name` tags the lines ([name], [name:int8], [profile:name...]). With
    `programs`, the introspection registry is emptied before the engine
    is made and printed after the warm wave ([programs], _print_programs)."""
    from paddle_tpu_torch.inference import GenerationEngine

    cfg = model.config
    tag = name if kv_dtype is None else f"{name}:int8"
    _fresh_pools(model)
    rng = np.random.default_rng(0)
    prompts = _serving_prompts(rng, 8, 300, 900, cfg.vocab_size, 512, (0, 5))
    kw = dict(max_slots=4, page_size=16, prefill_chunk=256, mixed_step=True,
              prefix_cache=True, kv_dtype=kv_dtype)
    n_new = 32
    if programs:
        from paddle_tpu_torch.observability import xla_introspect
        xla_introspect.reset()
    eng = GenerationEngine(model, **kw)
    _, cold, cold_wall, _, _ = _serve_wave(eng, prompts, n_new)
    marks = _trace_counts(eng)
    gen, st, wall, launches, ttft = _serve_wave(eng, prompts, n_new)
    frozen = _trace_counts(eng) == marks
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{tag}] CUDA graphs: cold wave wall_s={cold_wall:.3f} (decode "
          f"tokens_per_s="
          f"{cold['decode_tokens'] / max(cold['decode_s'], 1e-9):.2f}, "
          f"captures included); programs captured "
          f"{json.dumps(_captures(eng))}; warm wave builds none: {frozen} "
          f"{json.dumps(_trace_counts(eng))}")
    print(f"[{tag}] requests={len(prompts)} prompt_tokens="
          f"{sum(map(len, prompts))} new_tokens={sum(map(len, gen))} "
          f"wall_s={wall:.3f} peak_mem_gb={peak:.2f} "
          f"kv_pool_bytes={st['kv_pool_bytes']} (warm wave, graphs)")
    print(f"[{tag}] ttft_s p50={ttft[len(ttft) // 2]:.4f} "
          f"max={ttft[-1]:.4f} (host clock, from submission)")
    st.update(ttft_p50=ttft[len(ttft) // 2], ttft_max=ttft[-1],
              peak_mem_gb=peak)
    print(f"[{tag}] decode chunks={st['decode_chunks']} tokens="
          f"{st['decode_tokens']} tokens_per_s="
          f"{st['decode_tokens'] / max(st['decode_s'], 1e-9):.2f}; "
          f"ragged steps={st['ragged_steps']} s={st['ragged_s']:.3f} "
          f"mixed_decode_tokens={st['mixed_decode_tokens']}")
    print(f"[{tag}] prefix_hits={st['prefix_hits']} hit_tokens="
          f"{st['prefix_hit_tokens']} preemptions={st['preemptions']}")
    print(f"[{tag}] launches {json.dumps(launches)}", flush=True)
    _print_decode_launches(tag, K, launches, eng, kv_dtype)
    if _is_llama(model):
        _check_rope_launches(tag, launches, cfg.num_hidden_layers)
    _print_twin_diff(tag, gen, twin)
    for g in gen:
        if len(g) != n_new or g.min() < 0 or g.max() >= cfg.vocab_size:
            raise AssertionError(f"[{tag}] a result is not prompt + "
                                 f"{n_new} tokens of the vocabulary")
    if len(set(np.concatenate(gen).tolist())) < 2:
        raise AssertionError("degenerate output: one token everywhere")
    if st["prefix_hits"] < 1:
        raise AssertionError("the serving run saw no prefix-cache hit")
    _require_launched(tag, launches, _path_kernels(model, kv_dtype, False))
    if kv_dtype is not None:
        _require_idle(tag, launches, FLOAT_PAGED_KERNELS)
    _require_sm90_ragged(tag, launches)
    if not frozen:
        raise AssertionError(f"[{tag}] the warm wave built programs")
    if programs:
        _print_programs(tag, eng)
    steps = st["engine_steps"]
    _profile_serve(eng, prompts, n_new, f"profile:{tag}")
    del eng
    _fresh_pools(model)

    # the eager twin
    twin_eng = GenerationEngine(model, **kw)
    twin_eng._graphs = False
    e_gen, e_st, e_wall, e_launches, _ = _serve_wave(twin_eng, prompts,
                                                     n_new)
    e_peak = torch.cuda.max_memory_allocated() / 1e9
    same = all(np.array_equal(a, b) for a, b in zip(gen, e_gen))
    print(f"[{tag}:eager] the eager twin (_graphs = False): wall_s="
          f"{e_wall:.3f} peak_mem_gb={e_peak:.2f} decode tokens_per_s="
          f"{e_st['decode_tokens'] / max(e_st['decode_s'], 1e-9):.2f} "
          f"ragged s={e_st['ragged_s']:.3f}; tokens == graphs' {same}; "
          f"kernel launches == graphs' {e_launches == launches} ("
          f"per engine step "
          f"{sum(launches[k] for k in K.KERNELS) / max(steps, 1):.1f} "
          f"wrapper launches over {steps} engine steps)", flush=True)
    if not same or e_launches != launches:
        raise AssertionError(f"[{tag}] graphs and the eager twin disagree "
                             "(tokens or kernel launches)")
    _profile_serve(twin_eng, prompts, n_new, f"profile:{tag}:eager")
    del twin_eng
    _fresh_pools(model)
    return launches, gen, st


def _is_llama(model):
    return hasattr(model, "llama")


def _path_kernels(model, kv_dtype, dense):
    """The kernels a serving run's path launches: decode attention, and
    ragged attention (chunked prefill) or flash (dense admission), their
    int8 twins over int8 pools; the Llama's layers add RMSNorm, SwiGLU and
    RoPE (GPT's LayerNorm, GELU and learned positions are plain)."""
    suffix = "" if kv_dtype is None else "_int8"
    out = (("flash_attention",) if dense else
           (f"ragged_paged_attention{suffix}",)) + \
        (f"paged_decode_attention{suffix}",)
    if _is_llama(model):
        out += ("rms_norm", "swiglu", "fused_rope")
    return out

# what an int8 run must never launch: no float pool behind the flag
FLOAT_PAGED_KERNELS = ("ragged_paged_attention", "paged_decode_attention")
RAGGED_KERNELS = ("ragged_paged_attention", "ragged_paged_attention_int8")


def _print_decode_launches(tag, K, launches, eng, kv_dtype):
    """Decode attention's wrapper calls over the run, the decode steps they
    make (one call a layer a step), the split plan at the engine's shapes
    and the CUDA launches that gives each decode step (split kernel, and
    the merge when there is more than one split)."""
    cfg = eng.model.config
    name = ("paged_decode_attention" if kv_dtype is None
            else "paged_decode_attention_int8")
    layers = cfg.num_hidden_layers
    p_max = eng.blocks.block_tables.shape[1]
    splits, pps = K.split_plan(eng.max_slots, cfg.num_attention_heads,
                               eng.model.paged_spec()["n_kv_heads"], p_max,
                               eng.page_size)
    per_call = 1 + (splits > 1)
    print(f"[{tag}] decode attention: {launches[name]} calls = "
          f"{launches[name] // layers} decode steps x {layers} layers; plan "
          f"at B={eng.max_slots}, table width {p_max}: splits={splits} "
          f"pages_per_split={pps}; CUDA launches per call {per_call}, per "
          f"decode step {per_call * layers}", flush=True)


# a kernel launched once per layer by every model step: paged decode,
# ragged, or dense admission (flash)
STEP_KERNELS = ("paged_decode_attention", "paged_decode_attention_int8",
                "ragged_paged_attention", "ragged_paged_attention_int8",
                "flash_attention")


def _check_rope_launches(tag, launches, layers):
    """RoPE's launches per model step (a decode step, a ragged step or a
    dense admission; an engine step's decode chunk makes several decode
    steps): one q + k launch per layer, on the vector path."""
    steps = sum(launches[n] for n in STEP_KERNELS) // layers
    n = launches["fused_rope"]
    print(f"[{tag}] RoPE: {n} launches ({launches['fused_rope.qk']} of q "
          f"and k together, {launches['fused_rope.scalar']} on the scalar "
          f"path) over {steps} model steps = {n / max(steps, 1):g} per "
          f"model step (one per layer: {layers})", flush=True)
    if n != layers * steps or launches["fused_rope.qk"] != n or \
            launches["fused_rope.scalar"]:
        raise AssertionError(f"[{tag}] RoPE launches {n} (q+k "
                             f"{launches['fused_rope.qk']}, scalar "
                             f"{launches['fused_rope.scalar']}), expected "
                             f"{layers} per model step x {steps} steps, all "
                             f"q+k on the vector path")


def _require_launched(tag, launches, names):
    idle = [k for k in names if launches[k] <= 0]
    if idle:
        raise AssertionError(f"[{tag}] kernels never launched on the path: "
                             f"{idle}")


def _require_sm90_ragged(tag, launches):
    """Every ragged launch of a bfloat16 serving run (float or int8 pages
    of 16, head dim 128) took the tensor-core route."""
    off = {n: (launches[n], launches[f"{n}.sm90"]) for n in RAGGED_KERNELS
           if launches[f"{n}.sm90"] != launches[n]}
    if off:
        raise AssertionError(f"[{tag}] ragged launches off the tensor-core "
                             f"route (launches, sm90): {off}")


def _require_idle(tag, launches, names):
    busy = {k: launches[k] for k in names if launches[k] != 0}
    if busy:
        raise AssertionError(f"[{tag}] float paged kernels launched in an "
                             f"int8 run: {busy}")


def phase_serve_dense(K, model, kv_dtype=None, twin=None,
                      name="serve:dense"):
    """The same model serves 8 cold requests of 64-256 tokens (no shared
    prefix), 32 greedy tokens each: every prompt fits the chunk of 256, so
    the engine admits them through the dense prefill. A cold wave captures
    the programs; the numbers are the warm wave's (replays, the same
    shapes); the first admission of a third wave is profiled. Then the
    eager twin (``_graphs = False``) on a fresh engine must give the warm
    wave's tokens and kernel launches. Returns the warm wave's kernel
    launch counts and generated tokens. `name` tags the lines as in
    phase_serve."""
    from paddle_tpu_torch.inference import GenerationEngine

    cfg = model.config
    tag = name if kv_dtype is None else f"{name}:int8"
    _fresh_pools(model)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size,
                            int(rng.integers(64, 257))).astype(np.int32)
               for _ in range(8)]
    kw = dict(max_slots=4, page_size=16, prefill_chunk=256, mixed_step=True,
              kv_dtype=kv_dtype)
    n_new = 32
    shapes = []                 # (c, s_pad) of every dense admission built
    prefill = model.paged_prefill

    def recorded_prefill(ids, lengths):
        shapes.append(tuple(ids.shape))
        return prefill(ids, lengths)

    model.paged_prefill = recorded_prefill
    eng = GenerationEngine(model, **kw)
    try:
        _serve_wave(eng, prompts, n_new)
        marks = _trace_counts(eng)
        gen, st, wall, launches, ttft = _serve_wave(eng, prompts, n_new)
    finally:
        del model.paged_prefill
    frozen = _trace_counts(eng) == marks
    admits = max(st["prefill_admits"], 1)
    print(f"[{tag}] requests={len(prompts)} prompt_tokens="
          f"{sum(map(len, prompts))} new_tokens={sum(map(len, gen))} "
          f"wall_s={wall:.3f} peak_mem_gb="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"kv_pool_bytes={st['kv_pool_bytes']} (warm wave, graphs; "
          f"programs captured {json.dumps(_captures(eng))}, the warm wave "
          f"builds none: {frozen})")
    print(f"[{tag}] ttft_s p50={ttft[len(ttft) // 2]:.4f} "
          f"max={ttft[-1]:.4f} (host clock, from submission)")
    print(f"[{tag}] prefill_admits={st['prefill_admits']} "
          f"buckets={sorted(set(shapes))} prefill_tokens="
          f"{st['prefill_tokens']} "
          f"prefill_s_per_admit={st['prefill_s'] / admits:.4f}; "
          f"decode chunks={st['decode_chunks']} tokens="
          f"{st['decode_tokens']} tokens_per_s="
          f"{st['decode_tokens'] / max(st['decode_s'], 1e-9):.2f}; "
          f"ragged steps={st['ragged_steps']} "
          f"preemptions={st['preemptions']}")
    print(f"[{tag}] launches {json.dumps(launches)}", flush=True)
    _print_decode_launches(tag, K, launches, eng, kv_dtype)
    if _is_llama(model):
        _check_rope_launches(tag, launches, cfg.num_hidden_layers)
    _print_twin_diff(tag, gen, twin)
    for g in gen:
        if len(g) != n_new or g.min() < 0 or g.max() >= cfg.vocab_size:
            raise AssertionError(f"[{tag}] a result is not prompt + "
                                 f"{n_new} tokens of the vocabulary")
    if st["prefill_admits"] < 2 or not shapes or shapes[0] != (4, 256):
        raise AssertionError(f"expected >= 2 dense admissions, the first "
                             f"with (c, s_pad) = (4, 256); got "
                             f"{st['prefill_admits']}, {shapes}")
    if not frozen:
        raise AssertionError(f"[{tag}] the warm wave built programs")
    _require_launched(tag, launches, _path_kernels(model, kv_dtype, True))
    if kv_dtype is not None:
        _require_idle(tag, launches, FLOAT_PAGED_KERNELS)
    _require_sm90_ragged(tag, launches)
    # one flash forward per layer and admission, on the tensor-core route
    want = cfg.num_hidden_layers * st["prefill_admits"]
    if launches["flash_attention"] != want or \
            launches["flash_attention.sm90"] != want:
        raise AssertionError(f"[{tag}] flash launches "
                             f"{launches['flash_attention']} (tensor-core "
                             f"route {launches['flash_attention.sm90']}), "
                             f"expected {want}")
    _profile_admission(eng, prompts, n_new,
                       "profile:" + tag[len("serve:"):])
    del eng
    _fresh_pools(model)

    twin_eng = GenerationEngine(model, **kw)
    twin_eng._graphs = False
    e_gen, e_st, e_wall, e_launches, _ = _serve_wave(twin_eng, prompts,
                                                     n_new)
    same = all(np.array_equal(a, b) for a, b in zip(gen, e_gen))
    print(f"[{tag}:eager] the eager twin (_graphs = False): wall_s="
          f"{e_wall:.3f} prefill_s_per_admit="
          f"{e_st['prefill_s'] / max(e_st['prefill_admits'], 1):.4f} "
          f"decode tokens_per_s="
          f"{e_st['decode_tokens'] / max(e_st['decode_s'], 1e-9):.2f}; "
          f"tokens == graphs' {same}; kernel launches == graphs' "
          f"{e_launches == launches}", flush=True)
    if not same or e_launches != launches:
        raise AssertionError(f"[{tag}] graphs and the eager twin disagree "
                             "(tokens or kernel launches)")
    del twin_eng
    _fresh_pools(model)
    return launches, gen


# the kernels a speculative serving run must launch (its decode rows ride
# the verify windows of the ragged kernel; the plain decode kernel serves
# fallback chunks and the draft model's steps)
SPEC_KERNELS = ("ragged_paged_attention", "rms_norm", "swiglu", "fused_rope")
SPEC_INT8_KERNELS = ("ragged_paged_attention_int8", "rms_norm", "swiglu",
                     "fused_rope")
# a first divergence from the spec-off twin is a near-tie when the dense
# forward over the common prefix scores the two candidate tokens within
# this many bf16 ulps (at the larger of the two logits) of each other:
# twice the worst gap measured on the H100 (bf16 pools 4 ulps, int8 pools
# 11: their KV carries the int8 rounding the dense forward does not)
SPEC_TIE_ULPS = {None: 8.0, "int8": 24.0}


def _model_steps(st):
    """Model steps (one launch of every layer) an engine's stats record."""
    return (st["prefill_admits"] + st["ragged_steps"] + st["decode_steps"]
            + st["spec_dispatches"])


def _first_divergences(tag, model, prompts, gen, twin, kv_dtype,
                       what="the spec-off twin", allowed=SPEC_TIE_ULPS):
    """Each request's tokens against its twin (`what`): at a first
    divergence, the dense forward over the common prefix scores both
    candidates, which must lie within `allowed[kv_dtype]` bf16 ulps."""
    found = []
    for i, (p, a, b) in enumerate(zip(prompts, gen, twin)):
        neq = np.flatnonzero(np.asarray(a) != np.asarray(b))
        if not neq.size:
            continue
        t = int(neq[0])
        ids = torch.as_tensor(np.concatenate([p, a[:t]])[None],
                              dtype=torch.long, device=model.device)
        with torch.inference_mode():
            logits = model(ids)[0, -1].float()
        la, lb = float(logits[int(a[t])]), float(logits[int(b[t])])
        ulp = 2.0 ** (math.floor(math.log2(max(abs(la), abs(lb), 1e-30)))
                      - 7)
        found.append((i, t, la, lb, abs(la - lb) / ulp,
                      float(logits.max())))
    worst = max((f[4] for f in found), default=0.0)
    print(f"[{tag}] first divergences from {what}: {len(found)} "
          f"of {len(prompts)} requests, (request, position) "
          f"{[(f[0], f[1]) for f in found]}; dense-forward logits of the "
          f"two candidates (this run's, {what}'s, gap in bf16 ulps, row "
          f"max) "
          f"{[(round(f[2], 4), round(f[3], 4), round(f[4], 2), round(f[5], 3)) for f in found]}; "
          f"worst gap {worst:.2f} ulps (allowed "
          f"{allowed[kv_dtype]:g})", flush=True)
    if worst > allowed[kv_dtype]:
        raise AssertionError(f"[{tag}] a divergence from {what} "
                             f"is no near-tie: {worst:.2f} ulps")
    return found


def _copying_prompts(model, kw, rng, n, length, rounds=3):
    """n random prompts of `length` tokens that hold their own next token:
    the engine (spec off) generates each prompt's first token, which is
    written into the prompt at its middle, `rounds` times at successive
    positions (a substitution can move the next token; each round writes
    the new one), so that the n-gram drafter finds the first generated
    token in the context and proposes what followed it. On random weights
    greedy text never repeats its context (32 tokens after prompts of a
    repeated segment: no n-gram hit), so prompts that merely repeat give
    the drafter nothing to draft."""
    from paddle_tpu_torch.inference import GenerationEngine

    vocab = model.config.vocab_size
    prompts = [rng.integers(1, vocab, length).astype(np.int32)
               for _ in range(n)]
    eng = GenerationEngine(model, **kw)
    for r in range(rounds):
        first = [int(g[0]) for g in _serve_wave(eng, prompts, 1)[0]]
        for p, t in zip(prompts, first):
            p[length // 2 + r] = t
    del eng
    return prompts


def phase_serve_spec(K, model, twin, twin_st, kv_dtype=None):
    """Speculative decoding at 7B with the step programs as CUDA graphs,
    each run a cold wave (captures) and then a warm wave of the same
    shapes, whose numbers stand for it: first self-drafting
    (DraftModelDrafter over the serving model itself, with pools like the
    target's) on the [serve] workload (the same 8 requests of 300-900
    tokens, 32 greedy tokens each), beside the [serve] warm wave (the
    spec-off twin, graphs too); then the n-gram drafter on prompts that
    hold their own next token (_copying_prompts), beside their own
    spec-off run, which must draft. Each run prints the spec accounting,
    drafting and verify ms per dispatch, dispatches and launches per
    generated token and the decode throughput beside its twin's, and the
    peak memory. A drafter error fails the phase; the verify windows must
    take the tensor-core ragged route; an int8 run must launch no float
    paged kernel; each request's first divergence from its twin must be a
    near-tie. Returns the kernel launch counts over the runs' warm
    waves."""
    from paddle_tpu_torch.inference import DraftModelDrafter, GenerationEngine

    cfg = model.config
    base = "serve:spec" if kv_dtype is None else "serve:spec:int8"
    kw = dict(max_slots=4, page_size=16, prefill_chunk=256, mixed_step=True,
              prefix_cache=True, kv_dtype=kv_dtype)
    n_new = 32
    total = dict.fromkeys(K.launch_counts(), 0)
    for drafter in ("draft_model", "ngram"):
        tag = f"{base}:{drafter}"
        if drafter == "draft_model":
            rng = np.random.default_rng(0)
            prompts = _serving_prompts(rng, 8, 300, 900, cfg.vocab_size,
                                       512, (0, 5))
            off_gen, off_st = twin, twin_st
        else:
            _fresh_pools(model)
            prompts = _copying_prompts(model, kw, np.random.default_rng(6),
                                       8, 1024)
            off = GenerationEngine(model, **kw)
            _serve_wave(off, prompts, n_new)
            off_gen, off_st = _serve_wave(off, prompts, n_new)[:2]
            del off
        n_gen = n_new * len(prompts)
        twin_tps = off_st["decode_tokens"] / max(off_st["decode_s"], 1e-9)
        twin_steps = _model_steps(off_st)
        _fresh_pools(model)
        spec = DraftModelDrafter(model, kv_dtype=kv_dtype) \
            if drafter == "draft_model" else "ngram"
        eng = GenerationEngine(model, spec_decode=spec, **kw)
        _serve_wave(eng, prompts, n_new)
        marks = _trace_counts(eng)
        inner = getattr(eng._spec, "_eng", None)
        d_before = None if inner is None else dict(inner.stats)
        gen, st, wall, launches, _ = _serve_wave(eng, prompts, n_new)
        frozen = _trace_counts(eng) == marks
        for k in total:
            total[k] += launches[k]
        d_steps = 0 if inner is None else sum(
            inner.stats[k] - d_before[k]
            for k in ("ragged_steps", "decode_steps"))
        disp = max(st["spec_dispatches"], 1)
        tps = (st["spec_tokens"] + st["decode_tokens"]) / max(
            st["spec_verify_s"] + st["spec_draft_s"] + st["decode_s"], 1e-9)
        n_launch = sum(launches[k] for k in K.KERNELS)
        steps = _model_steps(st)
        print(f"[{tag}] requests={len(prompts)} new_tokens="
              f"{sum(map(len, gen))} wall_s={wall:.3f} peak_mem_gb="
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} "
              f"kv_pool_bytes={st['kv_pool_bytes']}"
              + ("" if inner is None else
                 f" + the draft engine's {inner.stats['kv_pool_bytes']}")
              + f" (warm wave, graphs; captured "
              f"{json.dumps(_captures(eng))}; the warm wave builds none: "
              f"{frozen})")
        print(f"[{tag}] verify dispatches={st['spec_dispatches']} "
              f"drafted={st['spec_draft_tokens']} accepted="
              f"{st['spec_accepted_tokens']} acceptance="
              f"{st['spec_accepted_tokens'] / max(st['spec_draft_tokens'], 1):.4f}"
              f" rollbacks={st['spec_rollbacks']} fallbacks="
              f"{json.dumps(st['spec_fallbacks'])} tokens_per_verify_dispatch="
              f"{st['spec_tokens'] / disp:.3f} (per row "
              f"{st['spec_tokens'] / max(st['spec_rows'], 1):.3f}, rows "
              f"{st['spec_rows']}) verify_s={st['spec_verify_s']:.3f} "
              f"draft_s={st['spec_draft_s']:.3f} (host clock; per verify "
              f"dispatch {1e3 * st['spec_verify_s'] / disp:.2f} ms of "
              f"verify and {1e3 * st['spec_draft_s'] / disp:.2f} ms of "
              f"drafting)")
        print(f"[{tag}] decode tokens_per_s={tps:.2f} ((verify + plain "
              f"chunk tokens) / (verify + draft + chunk seconds), host "
              f"clock) beside the spec-off twin's {twin_tps:.2f} (graphs "
              f"both); decode chunks={st['decode_chunks']} tokens="
              f"{st['decode_tokens']}; ragged steps={st['ragged_steps']} "
              f"mixed_decode_tokens={st['mixed_decode_tokens']}")
        print(f"[{tag}] model steps per generated token: target "
              f"{steps / n_gen:.4f} (spec-off twin {twin_steps / n_gen:.4f}), "
              f"with the draft model's {(steps + d_steps) / n_gen:.4f}; "
              f"kernel launches per generated token {n_launch / n_gen:.2f}")
        print(f"[{tag}] launches {json.dumps(launches)}", flush=True)
        _no_drafter_error(tag, eng)
        if st["spec_dispatches"] < 1 or st["spec_draft_tokens"] < 1:
            raise AssertionError(f"[{tag}] no verify dispatch drafted "
                                 "anything")
        if not frozen:
            raise AssertionError(f"[{tag}] the warm wave built programs")
        for g in gen:
            if len(g) != n_new or g.min() < 0 or g.max() >= cfg.vocab_size:
                raise AssertionError(f"[{tag}] a result is not prompt + "
                                     f"{n_new} tokens of the vocabulary")
        _check_rope_launches(tag, launches, cfg.num_hidden_layers)
        if kv_dtype is None:
            _require_launched(tag, launches, SPEC_KERNELS)
        else:
            _require_launched(tag, launches, SPEC_INT8_KERNELS)
            _require_idle(tag, launches, FLOAT_PAGED_KERNELS)
        _require_sm90_ragged(tag, launches)
        _first_divergences(tag, model, prompts, gen, off_gen, kv_dtype)
        del eng, spec, inner
    _fresh_pools(model)
    return total


def _verify_plain(model, eng, ids, q_lens, start_pos, bt, wpid, woff,
                  p_dtype=None):
    """A verify dispatch's argmaxes [c, s_pad] again, with attention
    through the plain ragged version over a copy of the pages its rows
    read and write (the engine's pools are left as they are): P in
    float32 as the reference's ragged kernel keeps it, or with `p_dtype`
    rounded to that type before the P V product as the tensor-core kernel
    rounds it, every other rounding the plain version's."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import kernels as K

    dev = eng.device
    pages = np.unique(np.concatenate([[0], bt.ravel(), wpid.ravel()]))
    remap = np.zeros(eng.blocks.n_pages, np.int64)
    remap[pages] = np.arange(len(pages))
    idx = torch.as_tensor(pages, device=dev)
    kp = [p[idx] for p in eng.k_pages]
    vp = [p[idx] for p in eng.v_pages]
    scales = {} if eng.k_scales is None else {
        "k_scales": [x[idx] for x in eng.k_scales],
        "v_scales": [x[idx] for x in eng.v_scales]}

    def plain(q, k_pages, v_pages, block_tables, context_lens, q_lens,
              scale=None, k_scales=None, v_scales=None, name=None):
        if k_scales is None:
            return K.ragged_paged_attention_plain(
                q, k_pages, v_pages, block_tables, context_lens, q_lens,
                scale, p_dtype=p_dtype)
        return K.ragged_paged_attention_int8_plain(
            q, k_pages, v_pages, k_scales, v_scales, block_tables,
            context_lens, q_lens, scale, p_dtype=p_dtype)

    def put(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    kernel = F.ragged_paged_attention
    F.ragged_paged_attention = plain
    try:
        with torch.inference_mode():
            logits = model.paged_verify(
                put(ids), put(q_lens), put(start_pos), kp, vp,
                put(remap[bt].astype(np.int32)), put(remap[wpid]),
                put(woff), **scales)[0]
    finally:
        F.ragged_paged_attention = kernel
    return torch.argmax(logits.float(), dim=-1).cpu().numpy()


def phase_spec_rescore(model, kv_dtype=None):
    """[spec:rescore] (ROADMAP C.1): the self-drafting [serve:spec] run
    again (untimed). Each verify dispatch with a rejected draft is
    rescored twice through the plain ragged version (``_verify_plain``):
    with P in float32 (the reference's rounding) and with P rounded to
    the model's type as the tensor-core kernel rounds it, all else equal.
    Printed: the rejections; how many the float32-P rescoring accepts
    (flips against the kernel, which differs from the plain version in
    every rounding); how many decisions, rejections and acceptances, P's
    rounding alone changes (the 16-bit-P rescoring against the float32-P
    one); and the argmaxes over every verify position that differ between
    the two rescorings, and between the kernel and the float32-P one.
    Returns the counts."""
    from paddle_tpu_torch.inference import DraftModelDrafter, GenerationEngine

    cfg = model.config
    tag = "spec:rescore" if kv_dtype is None else "spec:rescore:int8"
    rng = np.random.default_rng(0)
    prompts = _serving_prompts(rng, 8, 300, 900, cfg.vocab_size, 512, (0, 5))
    _fresh_pools(model)
    eng = GenerationEngine(model, spec_decode=DraftModelDrafter(
        model, kv_dtype=kv_dtype), max_slots=4, page_size=16,
        prefill_chunk=256, mixed_step=True, prefix_cache=True,
        kv_dtype=kv_dtype)
    p16 = model.llama.embed_tokens.weight.dtype
    verify = eng._verify_launch
    n = dict.fromkeys(("rejections", "flips", "p_flips", "accepted",
                       "accept_flips", "p_accept_flips", "positions",
                       "p_argmax_diff", "kernel_argmax_diff",
                       "rescored_dispatches"), 0)

    def rescored(ids, q_lens, start_pos, bt, wpid, woff):
        g = verify(ids, q_lens, start_pos, bt, wpid, woff)
        rows = []                           # (row, drafts, accepted)
        for i in range(len(q_lens)):
            m = int(q_lens[i]) - 1
            a = 0
            while a < m and int(ids[i, 1 + a]) == int(g[i, a]):
                a += 1
            if m > 0:
                rows.append((i, m, a))
        if not any(a < m for _, m, a in rows):
            return g
        args = (model, eng, ids, q_lens, start_pos, bt, wpid, woff)
        g32 = _verify_plain(*args)
        g16 = _verify_plain(*args, p_dtype=p16)
        n["rescored_dispatches"] += 1
        for i, m, a in rows:
            draft = [int(t) for t in ids[i, 1:1 + m]]
            ok32 = [int(g32[i, j]) == draft[j] for j in range(m)]
            ok16 = [int(g16[i, j]) == draft[j] for j in range(m)]
            n["accepted"] += a
            n["accept_flips"] += a - sum(ok32[:a])
            n["p_accept_flips"] += sum(x != y for x, y in
                                       zip(ok32[:a], ok16[:a]))
            if a < m:
                n["rejections"] += 1
                n["flips"] += ok32[a]
                n["p_flips"] += ok32[a] != ok16[a]
            n["positions"] += m + 1
            n["p_argmax_diff"] += int((g32[i, :m + 1] != g16[i, :m + 1])
                                      .sum())
            n["kernel_argmax_diff"] += int((g32[i, :m + 1] != g[i, :m + 1])
                                           .sum())
        return g

    eng._verify_launch = rescored
    for p in prompts:
        eng.add_request(p, max_new_tokens=32)
    with torch.inference_mode():
        eng.run()
    st = eng.stats
    n["acceptance"] = st["spec_accepted_tokens"] / max(
        st["spec_draft_tokens"], 1)
    print(f"[{tag}] verify dispatches={st['spec_dispatches']} drafted="
          f"{st['spec_draft_tokens']} accepted={st['spec_accepted_tokens']} "
          f"(acceptance {n['acceptance']:.4f}); {n['rescored_dispatches']} "
          f"dispatches rescored through the plain version with P in "
          f"float32 and in {str(p16).split('.')[-1]}: rejections="
          f"{n['rejections']}, of which the float32-P rescoring accepts "
          f"(flips against the kernel) {n['flips']} and P's rounding alone "
          f"decides differently {n['p_flips']}; accepted drafts "
          f"{n['accepted']}, of which the float32-P rescoring rejects "
          f"{n['accept_flips']} and P's rounding alone decides differently "
          f"{n['p_accept_flips']}; argmaxes that differ over "
          f"{n['positions']} verify positions: 16-bit P against float32 P "
          f"(plain both) {n['p_argmax_diff']}, the kernel against float32 "
          f"P {n['kernel_argmax_diff']}", flush=True)
    _no_drafter_error(tag, eng)
    if st["spec_rollbacks"] != n["rejections"]:
        raise AssertionError(f"[{tag}] {n['rejections']} rejections seen, "
                             f"the engine counted {st['spec_rollbacks']} "
                             f"rollbacks")
    if n["rescored_dispatches"] < 1:
        raise AssertionError(f"[{tag}] no verify dispatch rejected a draft")
    del eng, verify, rescored
    _fresh_pools(model)
    return n


def _print_profile(tag, prof, wall, note, steps=None):
    """Device time by kernel from a finished torch.profiler window, and
    the device's busy share of the window's wall time; with `steps`, the
    window's engine steps, also its kernel launches per engine step."""
    def dev_us(e):
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))

    # kernel entries only: an operator's own entry repeats the device time
    # of the kernels it launched
    rows = [(dev_us(e), e.key, e.count) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    rows = sorted([r for r in rows if r[0] > 0], reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    n_kernels = sum(r[2] for r in rows)
    if not rows:
        print(f"[{tag}] the profiler recorded no device time: device "
              "breakdown not measured")
        return
    # host calls that put work on the card: kernel and graph launches
    # and copies (the CUDA runtime and driver calls the profiler records)
    calls = {e.key: e.count for e in prof.key_averages()
             if e.key in HOST_LAUNCH_CALLS}
    per = "" if steps is None else (
        f" kernel_launches_per_engine_step={n_kernels / steps:.1f}"
        f" host_launch_calls_per_engine_step="
        f"{sum(calls.values()) / steps:.1f} {json.dumps(calls)}")
    print(f"[{tag}] {note}: wall_s={wall:.3f} device_busy_s={busy:.3f} "
          f"idle_share={1 - busy / wall:.3f} kernel_launches={n_kernels}"
          f"{per}")
    # the paged decode attention kernels (split and merge, float and int8)
    # and the ragged kernels (tensor-core and SIMT)
    dec = [r for r in rows if "decode_" in r[1] and "ptt::" in r[1]]
    if dec:
        print(f"[{tag}] decode attention: "
              f"{sum(r[0] for r in dec) / 1e3:.2f} ms = "
              f"{100 * sum(r[0] for r in dec) / 1e6 / busy:.1f}% of busy "
              f"time, {sum(r[2] for r in dec)} launches (the merge's time "
              f"includes its wait on the split kernel)")
    rope = [r for r in rows if "rope_" in r[1]]
    if rope:
        print(f"[{tag}] RoPE: {sum(r[0] for r in rope) / 1e3:.2f} ms = "
              f"{100 * sum(r[0] for r in rope) / 1e6 / busy:.1f}% of busy "
              f"time, {sum(r[2] for r in rope)} launches")
    fl = [r for r in rows if "flash_fwd" in r[1]]
    if fl:
        print(f"[{tag}] flash attention: {sum(r[0] for r in fl) / 1e3:.2f} "
              f"ms = {100 * sum(r[0] for r in fl) / 1e6 / busy:.1f}% of "
              f"busy time, {sum(r[2] for r in fl)} launches")
    rag = [r for r in rows if "ragged_" in r[1]]
    if rag:
        print(f"[{tag}] ragged attention: "
              f"{sum(r[0] for r in rag) / 1e3:.2f} ms = "
              f"{100 * sum(r[0] for r in rag) / 1e6 / busy:.1f}% of busy "
              f"time, {sum(r[2] for r in rag)} launches "
              f"({', '.join(sorted({r[1].split('<')[0][-40:] for r in rag}))})")
    for us, key, count in rows[:14]:
        print(f"[{tag}] {us / 1e3:10.2f} ms {100 * us / 1e6 / busy:5.1f}% "
              f"x{count:<6d} {key[:90]}")


# the device kernels each counted wrapper launches, one per counted launch:
# (kernel templates as the profiler names them, "<namespace>::<name><",
# the launch_counts keys that count them); the decode merge follows its
# split kernel only when the plan has more than one split, so only the
# split kernel is held
DEVICE_KERNELS = (
    (("ragged_sm90_kernel",), ("ragged_paged_attention.sm90",
                               "ragged_paged_attention_int8.sm90")),
    (("ragged_kernel",), ("ragged_paged_attention.simt",
                          "ragged_paged_attention_int8.simt")),
    (("decode_split_kernel",), ("paged_decode_attention",
                                "paged_decode_attention_int8")),
    (("rms_norm_vec_kernel", "rms_norm_rows_kernel"), ("rms_norm",)),
    (("swiglu_vec", "swiglu_scalar"), ("swiglu",)),
    (("rope_vec_kernel", "rope_scalar_kernel"), ("fused_rope",
                                                 "fused_rope_bwd")),
    (("flash_fwd_sm90_kernel",), ("flash_attention.sm90",
                                  "flashmask_attention.sm90")),
    (("flash_fwd_kernel",), ("flash_attention.simt",
                             "flashmask_attention.simt")),
    (("bdrln_kernel",), ("bias_dropout_residual_ln",)))
TRACE_LOSS = 0.005     # share of a name's kernels the trace may drop
# host time left between the trace's start and the window's first launch,
# and between the window's last kernel and the trace's stop: the profiler
# keeps only device records whose times, moved onto the host's clock, fall
# inside [start, stop], and that move is not exact, so a kernel launched
# at once after the start (or ended just before the stop) can fall outside
TRACE_EDGE_S = 0.05


def _check_device_launches(tag, prof, counted):
    """The device kernels a profiled window ran, by DEVICE_KERNELS' names,
    against the launches the wrappers counted over the same window (with
    graphs: the counts each replay adds from its capture). The window's
    edges are padded by TRACE_EDGE_S of host time, since without that the
    trace dropped the first kernels of a window (up to a layer or two of
    them); a name may still run up to TRACE_LOSS of its counted launches
    (at least one) fewer, less than one replay's worth (32 a layer loop);
    never more. Some kernel must have run."""
    rows = [(e.key, e.count) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    seen, bad = {}, []
    for names, keys in DEVICE_KERNELS:
        ran = sum(c for k, c in rows
                  if any(f"::{n}<" in k for n in names))
        want = sum(counted[k] for k in keys)
        seen[names[0]] = [ran, want]
        if not want - max(1, int(want * TRACE_LOSS)) <= ran <= want:
            bad.append(names[0])
    shown = json.dumps({k: v for k, v in seen.items() if any(v)})
    print(f"[{tag}] device kernels against counted launches over the "
          f"window [traced, counted]: {shown}", flush=True)
    if bad or not any(ran for ran, _ in seen.values()):
        raise AssertionError(f"[{tag}] device kernels and counted launches "
                             f"differ for {bad or 'every kernel (none ran)'}"
                             f" [traced, counted]: {shown}")


def _profile_admission(eng, prompts, n_new, tag):
    """The dense workload again on `eng` (warm: its programs are built):
    the first dense admission of the wave (the `_admit` call of its first
    engine step: c = 4, s_pad = 256, a replayed graph) under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops import kernels as K

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    admit = eng._admit
    walls, counted = [], {}

    def profiled_admit(admissions):
        torch.cuda.synchronize()
        before = K.launch_counts()
        prof.start_trace()
        time.sleep(TRACE_EDGE_S)
        t0 = time.perf_counter()
        admit(admissions)                 # ends in a host sync
        walls.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        time.sleep(TRACE_EDGE_S)
        prof.stop_trace()
        after = K.launch_counts()
        counted.update({k: after[k] - before[k] for k in after})

    eng.blocks.invalidate_index()
    tokens = eng.stats["prefill_tokens"]
    eng._admit = profiled_admit
    try:
        with torch.inference_mode():
            for p in prompts:
                eng.add_request(p, max_new_tokens=n_new)
            # the profiler's warm-up, as _profile_serve's step before its
            # window: prepared just before the admission, the trace can
            # still miss its first layer's kernels, so some device work
            # is traced first
            prof.prepare_trace()
            x = torch.zeros(1 << 20, device=eng.device)
            for _ in range(256):
                x.add_(1.0)
            torch.cuda.synchronize()
            del x
            eng.step()
    finally:
        del eng._admit
    if len(walls) != 1:
        raise AssertionError("engine step 0 made no single dense admission")
    _print_profile(tag, prof, walls[0],
                   f"one dense admission (c=4, s_pad=256, "
                   f"{eng.stats['prefill_tokens'] - tokens} prompt tokens)")
    _check_device_launches(tag, prof, counted)


# engine steps [from, to) of the profiled serving window (once 2-7; cut
# to 3 steps, whose post-processing costs half as much, so that the smoke
# keeps under 760 s with the vision and RNN phases)
PROFILE_STEPS = (2, 5)
# the host calls counted as launches in a profile: each puts work on the
# card (a kernel, a whole CUDA graph, a copy)
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cudaLaunchKernelEx", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch",
                     "cudaMemcpyAsync", "cudaMemsetAsync")


def _profile_serve(eng, prompts, n_new, tag):
    """The same workload again on `eng` (warm: its programs are built),
    with engine steps PROFILE_STEPS under torch.profiler: device time by
    kernel, the device's busy share of the window's wall time, and host
    launch calls and device kernels per engine step. (Profiled apart so
    that the timed waves carry no tracing cost; a window rather than the
    whole run keeps the profiler's post-processing short.)"""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops import kernels as K

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    eng.blocks.invalidate_index()
    marks = _trace_counts(eng)
    with torch.inference_mode():
        for p in prompts:
            eng.add_request(p, max_new_tokens=n_new)
        n = 0
        while eng.has_work():
            if n == PROFILE_STEPS[0] - 1:
                # the profiler's warm-up: tracing set up a step before
                # the window (started cold, a trace can miss the window's
                # first kernels)
                prof.prepare_trace()
            if n == PROFILE_STEPS[0]:
                torch.cuda.synchronize()
                before = dict(eng.stats)
                counts = K.launch_counts()
                prof.start_trace()
                time.sleep(TRACE_EDGE_S)
                t0 = time.perf_counter()
            eng.step()
            n += 1
            if n == PROFILE_STEPS[1]:
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                time.sleep(TRACE_EDGE_S)
                prof.stop_trace()
                after = dict(eng.stats)
                counted = {k: v - counts[k]
                           for k, v in K.launch_counts().items()}
    if n < PROFILE_STEPS[1]:
        raise AssertionError(f"the workload took {n} engine steps, fewer "
                             f"than the profiled window {PROFILE_STEPS}")
    if _trace_counts(eng) != marks:
        raise AssertionError(f"[{tag}] the profiled wave built programs")
    window = {k: after[k] - before[k] for k in
              ("ragged_steps", "decode_chunks", "decode_tokens",
               "mixed_decode_tokens")}
    _print_profile(tag, prof, wall,
                   f"engine steps {PROFILE_STEPS[0]}-{PROFILE_STEPS[1] - 1} "
                   f"of {n} {json.dumps(window)}",
                   steps=PROFILE_STEPS[1] - PROFILE_STEPS[0])
    _check_device_launches(tag, prof, counted)


# ----------------------------------------------------------------------
# GPT and BERT: the second served model and the encoder
# ----------------------------------------------------------------------

# what the tiny GPT's agreement runs must launch on the card (decode and
# ragged attention, their int8 twins, the dense admission's flash)
GPT_AGREE_KERNELS = ("ragged_paged_attention", "paged_decode_attention",
                     "flash_attention", "ragged_paged_attention_int8",
                     "paged_decode_attention_int8")


def _tiny_gpt_pair(dev):
    """A 2-layer tiny GPT in float32 with one set of seeded weights on the
    CPU (plain versions) and on the card (kernels)."""
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    cfg = GPTConfig.tiny()
    cpu = GPTForCausalLM(cfg, device="cpu")
    state = weights.random_state(cpu, seed=0)
    weights.from_paddle_tpu_state(state, cpu)
    gpu = weights.from_paddle_tpu_state(state,
                                        GPTForCausalLM(cfg, device=dev))
    return cfg, cpu, gpu


def phase_agree_gpt(dev):
    """The tiny GPT (multi-head: 4 KV heads of 16), CPU plain versions
    against the card's kernels: greedy generate waves through the prefix
    cache, chunked prefill and mixed steps, through dense admissions, and
    with spec decoding (the n-gram and the draft-model drafters), each on
    float and int8 pools. On the card each runs with CUDA graphs and as
    the eager twin. Tokens must be equal three ways, the twins' kernel
    launches equal, and the card runs must launch decode, ragged and flash
    attention and the int8 twins."""
    from paddle_tpu_torch.inference import DraftModelDrafter, GenerationEngine
    from paddle_tpu_torch.ops import kernels as K

    cfg, cpu, gpu = _tiny_gpt_pair(dev)
    base = dict(max_slots=2, page_size=4, max_seq_len=64, prefix_cache=True,
                prefill_chunk=8, mixed_step=True)
    spec = dict(max_slots=4, page_size=4, max_seq_len=64, mixed_step=False)
    workloads = [
        ("chunked+prefix", _serving_prompts(np.random.default_rng(1), 6, 9,
                                            20, cfg.vocab_size, 12, (0, 4)),
         base, None),
        ("dense admission", _serving_prompts(np.random.default_rng(3), 6, 3,
                                             9, cfg.vocab_size, 4, (0, 4)),
         dict(base, max_slots=3), None),
        ("spec:ngram", SPEC_PROMPTS, spec, "ngram"),
        ("spec:draft_model", SPEC_PROMPTS, spec, "draft_model"),
    ]
    total = dict.fromkeys(K.launch_counts(), 0)
    bad = []
    for kv in (None, "int8"):
        for name, prompts, kw, drafter in workloads:
            tag = f"{'float' if kv is None else 'int8'} {name}"

            def engine(model, graphs):
                sd = DraftModelDrafter(model, kv_dtype=kv) \
                    if drafter == "draft_model" else (drafter or False)
                eng = GenerationEngine(model, kv_dtype=kv, spec_decode=sd,
                                       **kw)
                _set_graphs(eng, graphs)
                return eng

            want = _wave(engine(cpu, False), prompts, 12)
            runs = []
            for on in (True, False):
                eng = engine(gpu, on)
                K.reset_launch_counts()
                toks = _wave(eng, prompts, 12)
                runs.append((toks, K.launch_counts(), dict(eng.stats)))
            (g_tok, g_l, st), (e_tok, e_l, _) = runs
            same = all(np.array_equal(a, b) for a, b in zip(want, g_tok))
            twin = all(np.array_equal(a, b) for a, b in zip(g_tok, e_tok))
            drafted = st["spec_draft_tokens"]
            print(f"[agree:gpt] {tag}: cpu == cuda graphs {same}; graphs "
                  f"== eager {twin}; launches equal {g_l == e_l}; "
                  f"prefill_admits={st['prefill_admits']} ragged_steps="
                  f"{st['ragged_steps']} prefix_hits={st['prefix_hits']} "
                  f"spec drafted/accepted={drafted}/"
                  f"{st['spec_accepted_tokens']}; launches "
                  f"{json.dumps({k: g_l[k] for k in GPT_AGREE_KERNELS})}",
                  flush=True)
            if not (same and twin and g_l == e_l) or \
                    (drafter and drafted < 1):
                bad.append(tag)
            for k in total:
                total[k] += g_l[k]
    if bad:
        raise AssertionError(f"[agree:gpt] disagreements (or no draft) in "
                             f"{bad}")
    _require_launched("agree:gpt", total, GPT_AGREE_KERNELS)


# the serving runs of GPT-3 1.3B take its first SERVE_GPT_LAYERS of 24
# layers (cut: at 24 the three took 135.4 s of an 823.0 s smoke on an
# H100 host, at 12 71.8 s of a 767.5 s one, which must keep under 760 s;
# at 6 38.2 s of a 732.4 s one, after the UNet's phases joined, at 4
# 30.3 s of a 767.8 s one on a slow host; every per-layer fact is held as
# at 24)
SERVE_GPT_LAYERS = 2


def _serving_gpt(dev):
    """GPT-3 1.3B's widths (GPTConfig.gpt3_1p3b(): hidden 2048, 16 heads
    of 128, FFN 8192, vocab 50304, 2048 positions) at SERVE_GPT_LAYERS of
    its 24 layers, bfloat16, random weights from seed 0."""
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    cfg = GPTConfig.gpt3_1p3b()
    cfg.num_hidden_layers = SERVE_GPT_LAYERS
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    weights.init_random_(model, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[serve:gpt] gpt3_1p3b, layers={cfg.num_hidden_layers}, "
          f"params={n_params / 1e9:.3f}B bf16, init_s="
          f"{time.perf_counter() - t0:.2f}", flush=True)
    return model


def _agree_module(dev, tag, make, call, expect=None):
    """One module made by make(device) on the CPU and on the card with the
    same numpy-seeded parameters (N(0, 0.3): norms and biases too, so none
    is a no-op), called by call(module, device) -> tensor or tuple; every
    output's largest error must be within 1e-4 of its largest value.
    expect: {kernel: launches} the card's call must make. Returns the
    card's launches."""
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.ops import kernels as K

    cpu = make("cpu").eval()
    rng = np.random.default_rng(0)
    state = {n: (0.3 * rng.standard_normal(tuple(p.shape))).astype(
        np.float32) for n, p in cpu.named_parameters()}
    weights.from_paddle_tpu_state(state, cpu)
    gpu = weights.from_paddle_tpu_state(state, make(dev)).eval()
    with torch.no_grad():
        want = call(cpu, "cpu")
        K.reset_launch_counts()
        got = call(gpu, dev)
        torch.cuda.synchronize()
        launches = K.launch_counts()
    want = want if isinstance(want, (tuple, list)) else [want]
    got = got if isinstance(got, (tuple, list)) else [got]
    errs = [(_max_err(g.cpu(), w), float(w.float().abs().max()))
            for g, w in zip(got, want)]
    ok = len(got) == len(want) and all(e <= 1e-4 * m for e, m in errs)
    counted = {k: launches[k] for k in (expect or {})}
    print(f"[agree:bert] {tag}: max_abs_err/max|want| " + " ".join(
        f"{e:.2e}/{m:.2e}" for e, m in errs) + f" (<= 1e-4); launches "
        f"{json.dumps(counted)}", flush=True)
    if not ok:
        raise AssertionError(f"[agree:bert] {tag}: CPU plain path and CUDA "
                             f"kernel path disagree")
    if expect and counted != expect:
        raise AssertionError(f"[agree:bert] {tag}: launches {counted}, "
                             f"expected {expect}")
    return launches


def phase_agree_bert(dev):
    """The tiny BERT's three heads (with and without an attention mask, the
    masked-LM and classification losses), the transformer layers
    (MultiHeadAttention step by step through a Cache and over a
    StaticCache, a Transformer with a causal target mask) and the fused
    layers and functionals (the six incubate layers, fused_multi_transformer,
    block_multihead_attention), float32, CPU plain versions against the
    card's kernels. Attention without a mask must launch the flash kernel
    once a layer, with a mask never; the post-norm fused layers launch
    bdrln, block_multihead_attention the decode kernel."""
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.incubate import nn as tinn
    from paddle_tpu_torch.incubate.nn import functional as TIF
    from paddle_tpu_torch.models import bert as tbert

    cfg = tbert.BertConfig.tiny()
    layers = cfg.num_hidden_layers
    rng = np.random.default_rng(7)
    ids = rng.integers(1, cfg.vocab_size, (3, 16))
    types = rng.integers(0, 2, (3, 16))
    mask = np.ones((3, 16), np.int64)
    mask[1, 9:] = 0
    mask[2, 4:] = 0
    mlm_labels = rng.integers(0, cfg.vocab_size, (3, 16))
    mlm_labels[:, ::3] = -100
    cls_labels = rng.integers(0, 2, 3)
    x = rng.standard_normal((2, 6, 64)).astype(np.float32)

    def t(a, d):
        return torch.from_numpy(np.asarray(a)).to(d)

    total = {}

    def agree(tag, make, call, expect=None):
        for k, v in _agree_module(dev, tag, make, call, expect).items():
            total[k] = total.get(k, 0) + v

    for masked in (False, True):
        m = mask if masked else None
        flash = {"flash_attention": 0 if masked else layers}
        sfx = "masked" if masked else "unmasked"
        agree(f"BertModel {sfx}",
              lambda d: tbert.BertModel(cfg, device=d),
              lambda mod, d: mod(t(ids, d), t(types, d),
                                 None if m is None else t(m, d)), flash)
        agree(f"BertForMaskedLM {sfx} logits+loss",
              lambda d: tbert.BertForMaskedLM(cfg, device=d),
              lambda mod, d: (mod(t(ids, d), t(types, d),
                                  None if m is None else t(m, d)),
                              mod(t(ids, d), t(types, d),
                                  None if m is None else t(m, d),
                                  t(mlm_labels, d))))
        agree(f"BertForSequenceClassification {sfx} logits+loss",
              lambda d: tbert.BertForSequenceClassification(cfg, device=d),
              lambda mod, d: (mod(t(ids, d), t(types, d),
                                  None if m is None else t(m, d)),
                              mod(t(ids, d), t(types, d),
                                  None if m is None else t(m, d),
                                  t(cls_labels, d))))

    def mha_caches(mod, d):
        xd = t(x, d)
        cache, outs = mod.gen_cache(xd), []
        for lo, hi in ((0, 2), (2, 3), (3, 6)):
            out, cache = mod(xd[:, lo:hi], cache=cache)
            outs.append(out)
        static = mod.gen_cache(xd, xd, tnn.MultiHeadAttention.StaticCache)
        return outs + [cache.k, cache.v, mod(xd, cache=static)]
    agree("MultiHeadAttention Cache x3 + StaticCache",
          lambda d: tnn.MultiHeadAttention(64, 4, device=d), mha_caches,
          {"flash_attention": 4})

    def transformer(mod, d):
        return mod(t(x, d), t(x[:, :5], d), None,
                   mod.generate_square_subsequent_mask(5))
    # encoder self-attention and decoder cross-attention unmasked (flash),
    # decoder self-attention under the causal mask (dense)
    agree("Transformer (causal target mask)",
          lambda d: tnn.Transformer(64, 4, 2, 2, 128, dropout=0.0,
                                    device=d), transformer,
          {"flash_attention": 4})

    keep = np.ones((2, 1, 6, 6), bool)
    keep[0, :, :, 4:] = False
    agree("FusedLinear", lambda d: tinn.FusedLinear(64, 32, device=d),
          lambda mod, d: mod(t(x, d)))
    agree("FusedDropoutAdd (eval)", lambda d: tinn.FusedDropoutAdd(0.5),
          lambda mod, d: mod(t(x, d), t(x[::-1].copy(), d)))
    agree("FusedMultiHeadAttention post-norm, unmasked and masked",
          lambda d: tinn.FusedMultiHeadAttention(64, 4, device=d),
          lambda mod, d: (mod(t(x, d)), mod(t(x, d), attn_mask=t(keep, d))),
          {"flash_attention": 1, "bias_dropout_residual_ln": 2})
    agree("FusedFeedForward post-norm gelu",
          lambda d: tinn.FusedFeedForward(64, 128, activation="gelu",
                                          device=d),
          lambda mod, d: mod(t(x, d)), {"bias_dropout_residual_ln": 1})
    agree("FusedTransformerEncoderLayer post-norm",
          lambda d: tinn.FusedTransformerEncoderLayer(64, 4, 128, device=d),
          lambda mod, d: mod(t(x, d)),
          {"flash_attention": 1, "bias_dropout_residual_ln": 2})
    agree("FusedMultiTransformer pre-norm x2",
          lambda d: tinn.FusedMultiTransformer(64, 4, 128, num_layers=2,
                                               device=d),
          lambda mod, d: mod(t(x, d)), {"flash_attention": 2})

    class Stack(torch.nn.Module):
        """fused_multi_transformer's per-layer weight lists as
        parameters."""

        def __init__(self, d):
            super().__init__()
            shapes = {"ln_scales": [64], "ln_biases": [64],
                      "qkv_weights": [3, 4, 16, 64],
                      "qkv_biases": [3, 4, 16], "linear_weights": [64, 64],
                      "linear_biases": [64], "ffn_ln_scales": [64],
                      "ffn_ln_biases": [64], "ffn1_weights": [64, 128],
                      "ffn1_biases": [128], "ffn2_weights": [128, 64],
                      "ffn2_biases": [64]}
            self.names = list(shapes)
            for n, s in shapes.items():
                setattr(self, n, torch.nn.ParameterList(
                    [torch.nn.Parameter(torch.empty(s, device=d))
                     for _ in range(2)]))

        def forward(self, xd):
            return TIF.fused_multi_transformer(
                xd, *[list(getattr(self, n)) for n in self.names])
    agree("fused_multi_transformer", Stack, lambda mod, d: mod(t(x, d)),
          {"flash_attention": 2})

    class Paged(torch.nn.Module):
        """block_multihead_attention over a page pool (GQA 4 -> 2)."""

        def __init__(self, d):
            super().__init__()
            self.q = torch.nn.Parameter(torch.empty(2, 4, 16, device=d))
            self.kp = torch.nn.Parameter(torch.empty(8, 4, 2, 16, device=d))
            self.vp = torch.nn.Parameter(torch.empty(8, 4, 2, 16, device=d))

        def forward(self, d):
            bt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=d)
            ctx = torch.tensor([7, 5], dtype=torch.int32, device=d)
            return TIF.block_multihead_attention(self.q, self.kp, self.vp,
                                                 bt, ctx)
    agree("block_multihead_attention", Paged, lambda mod, d: mod(d),
          {"paged_decode_attention": 1})
    _require_launched("agree:bert", total, ("flash_attention",
                                            "bias_dropout_residual_ln",
                                            "paged_decode_attention"))


BERT_BATCH = (8, 512)
BERT_CALLS = 5


def _profile_forward(tag, fn):
    """One more call of fn (warm) under torch.profiler: device time by
    kernel, the idle share of its wall, and the device kernels against the
    launches the wrappers counted (as the serving windows are held)."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops import kernels as K

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.prepare_trace()
    torch.cuda.synchronize()
    before = K.launch_counts()
    prof.start_trace()
    time.sleep(TRACE_EDGE_S)
    t0 = time.perf_counter()
    with torch.inference_mode():
        fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    time.sleep(TRACE_EDGE_S)
    prof.stop_trace()
    after = K.launch_counts()
    _print_profile(tag, prof, wall, "one forward")
    _check_device_launches(tag, prof, {k: after[k] - before[k]
                                       for k in after})


def _time_calls(fn, n=BERT_CALLS):
    """(ms per call by CUDA events over n calls after one warm-up, the
    kernel launches the n calls counted, the last output)."""
    from paddle_tpu_torch.ops import kernels as K

    fn()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, K.launch_counts(), out


def phase_bert(K, dev):
    """BERT-base (BertConfig.bert_base(): 12 layers, hidden 768, 12 heads
    of 64, FFN 3072, vocab 30522) in bfloat16, eval, random weights from
    seed 0: BertForMaskedLM over 8 x 512 tokens unmasked (the flash kernel,
    non-causal, D = 64: 12 launches a forward on the tensor-core route)
    and with a padding mask (the dense path: no flash launch); the two
    must agree on the unpadded row 0 (within 0.1 of the largest logit: 12
    post-LN layers of bf16 attention computed two ways); one more unmasked
    forward runs under torch.profiler. Then
    FusedMultiTransformer at the same widths, 12 layers (pre-norm). Prints
    ms per forward. Returns the timed calls' kernel launches."""
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.incubate import nn as tinn
    from paddle_tpu_torch.models import BertConfig, BertForMaskedLM

    _release()
    cfg = BertConfig.bert_base()
    b, s = BERT_BATCH
    model = BertForMaskedLM(cfg, device=dev, dtype=torch.bfloat16).eval()
    weights.init_random_(model, seed=0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ids = torch.randint(1, cfg.vocab_size, (b, s), generator=gen,
                        device=dev)
    lens = torch.tensor([s - 48 * i for i in range(b)], device=dev)
    mask = (torch.arange(s, device=dev)[None] < lens[:, None]).long()
    total = dict.fromkeys(K.launch_counts(), 0)
    outs = {}
    for tag, m in (("unmasked", None), ("masked", mask)):
        with torch.inference_mode():
            ms, launches, out = _time_calls(lambda: model(ids,
                                                          attention_mask=m))
        want = 0 if m is not None else cfg.num_hidden_layers * BERT_CALLS
        flash = (launches["flash_attention"],
                 launches["flash_attention.sm90"])
        print(f"[bert] BertForMaskedLM {b}x{s} bf16 {tag}: "
              f"ms_per_forward={ms:.3f} flash launches (all, sm90) {flash} "
              f"over {BERT_CALLS} forwards; peak_mem_gb="
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", flush=True)
        if flash != (want, want):
            raise AssertionError(f"[bert] {tag}: flash launches {flash}, "
                                 f"expected {want} on the tensor-core route")
        if tuple(out.shape) != (b, s, cfg.vocab_size) or \
                not bool(torch.isfinite(out).all()):
            raise AssertionError(f"[bert] {tag}: logits not finite "
                                 f"[{b}, {s}, {cfg.vocab_size}]")
        outs[tag] = out[0].float()
        for k in total:
            total[k] += launches[k]
        if m is None:
            _profile_forward(f"profile:bert:{tag}",
                             lambda: model(ids, attention_mask=m))
    diff = float((outs["unmasked"] - outs["masked"]).abs().max())
    top = float(outs["unmasked"].abs().max())
    print(f"[bert] row 0 (no padding): flash vs dense path max_abs_diff="
          f"{diff:.4f} max|logit|={top:.4f} (<= 0.1 of it)", flush=True)
    if diff > 0.1 * top:
        raise AssertionError("[bert] the flash and dense paths disagree on "
                             "the unpadded row")
    del model, outs, out
    _release()
    fmt = tinn.FusedMultiTransformer(
        cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
        num_layers=cfg.num_hidden_layers, device=dev,
        dtype=torch.bfloat16).eval()
    weights.init_random_(fmt, seed=0)
    x = torch.randn(b, s, cfg.hidden_size, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    with torch.inference_mode():
        ms, launches, out = _time_calls(lambda: fmt(x))
    want = cfg.num_hidden_layers * BERT_CALLS
    flash = (launches["flash_attention"], launches["flash_attention.sm90"])
    print(f"[bert] FusedMultiTransformer 12 layers {b}x{s}x"
          f"{cfg.hidden_size} bf16: ms_per_forward={ms:.3f} flash launches "
          f"(all, sm90) {flash}; peak_mem_gb="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", flush=True)
    if flash != (want, want) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"[bert] FusedMultiTransformer: flash launches "
                             f"{flash} (expected {want}) or output not "
                             f"finite")
    for k in total:
        total[k] += launches[k]
    del fmt, out, x
    _release()
    return total


# [agree:train2]: the rest of training on tiny float32 problems, the CPU's
# plain path against the card
TRAIN2_SHAPES = ((64, 48), (48,), (33, 17))
TRAIN2_OPTIMIZERS = {
    "SGD": lambda o, ps: o.SGD(0.1, parameters=ps, weight_decay=0.01),
    "Momentum": lambda o, ps: o.Momentum(0.05, 0.9, parameters=ps,
                                         use_nesterov=True),
    "Adam(lazy_mode)": lambda o, ps: o.Adam(0.01, parameters=ps,
                                            lazy_mode=True),
    "Adamax": lambda o, ps: o.Adamax(0.02, parameters=ps),
    "Adagrad": lambda o, ps: o.Adagrad(0.1, parameters=ps,
                                       initial_accumulator_value=0.1),
    "Adadelta": lambda o, ps: o.Adadelta(1.0, parameters=ps),
    "RMSProp": lambda o, ps: o.RMSProp(0.01, rho=0.9, momentum=0.5,
                                       centered=True, parameters=ps),
    "Lamb": lambda o, ps: o.Lamb(0.01, parameters=ps),
    "NAdam": lambda o, ps: o.NAdam(0.01, parameters=ps),
    "RAdam": lambda o, ps: o.RAdam(0.01, beta2=0.9, parameters=ps),
    "ASGD": lambda o, ps: o.ASGD(0.05, parameters=ps),
    "Rprop": lambda o, ps: o.Rprop(0.01, parameters=ps),
}


def _warmup_cosine(lr_mod, peak, warmup, t_max, start=0.0):
    """LinearWarmup(CosineAnnealingDecay(peak, t_max), warmup, start,
    peak): the schedule the GPT phases train under."""
    return lr_mod.LinearWarmup(lr_mod.CosineAnnealingDecay(peak, t_max),
                               warmup, start, peak)


def _remat_per_step(layers):
    """Launches of each kernel in one Llama training step with
    apply_llama_remat over `layers` layers: every forward kernel of a
    layer runs twice (the forward and its replay in the backward), the
    final norm once, the backward kernels once."""
    return {"flash_attention": 2 * layers, "flash_attention_bwd": layers,
            "rms_norm": 4 * layers + 1, "swiglu": 2 * layers,
            "fused_rope": 2 * layers, "fused_rope.qk": 2 * layers,
            "fused_rope_bwd": layers}


def _agree_optimizers(dev):
    """3 steps of each optimizer on the same parameters and gradients on
    both devices; (worst max|err| / max(1, max|want|) over parameters and
    state, LBFGS's iterate error)."""
    from paddle_tpu_torch import optimizer as O

    worst = {}
    for name, make in TRAIN2_OPTIMIZERS.items():
        rng = np.random.default_rng(len(name))
        start = [rng.standard_normal(s).astype(np.float32)
                 for s in TRAIN2_SHAPES]
        grads = [[rng.standard_normal(s).astype(np.float32)
                  for s in TRAIN2_SHAPES] for _ in range(3)]
        runs = {}
        for d in ("cpu", dev):
            # torch.tensor copies: a CPU parameter made by from_numpy
            # would write its steps into `start`
            ps = [torch.nn.Parameter(torch.tensor(a, device=d))
                  for a in start]
            opt = make(O, ps)
            for gs in grads:
                for p, g in zip(ps, gs):
                    p.grad = torch.tensor(g, device=d)
                opt.step()
                opt.clear_grad()
            runs[str(d)] = [p.detach().cpu() for p in ps] + [
                v.cpu() for k, v in opt.state_dict().items()
                if k != "@step"]
        worst[name] = max(
            float((b - a).abs().max()) / max(1.0, float(a.abs().max()))
            for a, b in zip(runs["cpu"], runs[str(dev)]))
    rng = np.random.default_rng(4)
    m = rng.standard_normal((6, 6)).astype(np.float32)
    a = m @ m.T / 6 + np.eye(6, dtype=np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    xs = {}
    for d in ("cpu", dev):
        x = torch.nn.Parameter(torch.zeros(6, device=d))
        ta, tb = torch.from_numpy(a).to(d), torch.from_numpy(b).to(d)
        opt = O.LBFGS(1.0, max_iter=4, history_size=5, parameters=[x])

        def closure(x=x, ta=ta, tb=tb, opt=opt):
            opt.clear_grad()
            loss = 0.5 * (x * (ta @ x)).sum() - (tb * x).sum()
            loss.backward()
            return loss

        opt.step(closure)
        xs[str(d)] = x.detach().cpu()
    worst["LBFGS"] = float((xs["cpu"] - xs[str(dev)]).abs().max())
    return worst


def _bf16_ulp(x):
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def phase_agree_train2(dev):
    """The rest of training on tiny float32 problems, CPU plain versions
    against the card: each new optimizer over 3 steps (parameters and
    state within 1e-5 of max(1, max|value|): the same float32 elementwise
    operations, one rounding apart where CUDA fuses a multiply-add) and
    LBFGS on a quadratic (iterates within 1e-4); AdamW under
    LinearWarmup(CosineAnnealingDecay) driving the tiny Llama (losses
    within 1e-4, rates equal); on the card the tiny Llama with
    apply_llama_remat against itself without remat (losses within 1e-6,
    first gradients within 1e-5 of the largest, the launches of
    _remat_per_step); the tiny GPT, 3 AdamW steps (losses 1e-4); a tiny
    BERT (hidden 128, 2 heads of 64: the tensor-core flash route in bf16)
    under decorate(O2) + GradScaler(1024), dropout 0, 4 steps (first loss
    within 2 bf16 ulps, then within 5% or 0.0625: AdamW's first steps are
    ~lr sign(g), and the two devices' bf16 roundings decide the sign of
    some near-zero gradients apart); a checkpoint of the card's model and
    AdamW state loaded on the CPU bit for bit."""
    tag = "agree:train2"
    worst = _agree_optimizers(dev)
    print(f"[{tag}] optimizers, 3 steps, max|err| / max(1, max|want|) "
          f"(<= 1e-5; LBFGS iterate <= 1e-4): "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in worst.items()})}",
          flush=True)
    bad = [k for k, v in worst.items()
           if v > (1e-4 if k == "LBFGS" else 1e-5)]
    if bad:
        raise AssertionError(f"[{tag}] optimizers disagree: {bad}")
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(0, 128, (2, 16)))
    lab = torch.from_numpy(rng.integers(0, 128, (2, 16)))
    batch = {"cpu": (ids, lab), "gpu": (ids.to(dev), lab.to(dev))}
    _agree_schedule(tag, dev, batch)
    _agree_remat(tag, dev, batch)
    _agree_gpt_steps(tag, dev, batch)
    blab = ids.clone()
    blab[torch.from_numpy(rng.random(tuple(ids.shape)) >= 0.3)] = -100
    _agree_bert_o2(tag, dev, {"cpu": (ids, blab),
                              "gpu": (ids.to(dev), blab.to(dev))})
    _agree_checkpoint(tag, dev)


def _agree_schedule(tag, dev, batch):
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.jit import compile_train_step

    _, cpu, gpu = _tiny_pair(dev)
    losses, rates = {}, {}
    for key, model in (("cpu", cpu), ("gpu", gpu)):
        model.train()
        sched = _warmup_cosine(O.lr, 1e-3, 2, 10)
        opt = O.AdamW(sched, parameters=model.parameters())
        step = compile_train_step(model, lambda m, i, l: m(i, labels=l),
                                  opt)
        losses[key], rates[key] = [], []
        for _ in range(3):
            rates[key].append(opt.get_lr())
            losses[key].append(float(step(*batch[key])))
            sched.step()
    err = max(abs(a - b) for a, b in zip(losses["cpu"], losses["gpu"]))
    print(f"[{tag}] tiny Llama, AdamW under LinearWarmup(Cosine): rates "
          f"{rates['gpu']} losses cpu {losses['cpu']} cuda {losses['gpu']}"
          f" max_err={err:.3e} (<= 1e-4)", flush=True)
    if err > 1e-4 or rates["cpu"] != rates["gpu"]:
        raise AssertionError(f"[{tag}] the scheduled AdamW runs disagree")


def _agree_remat(tag, dev, batch):
    import copy

    from paddle_tpu_torch.models import apply_llama_remat
    from paddle_tpu_torch.ops import kernels as K

    _, _, plain = _tiny_pair(dev)
    remat = apply_llama_remat(copy.deepcopy(plain))
    got = {}
    for key, model in (("plain", plain), ("remat", remat)):
        model.train()
        K.reset_launch_counts()
        loss = model(batch["gpu"][0], labels=batch["gpu"][1])
        loss.backward()
        got[key] = (float(loss.detach()), K.launch_counts(),
                    [p.grad.detach().clone() for p in model.parameters()])
    top = max(float(g.abs().max()) for g in got["plain"][2])
    gerr = max(float((a - b).abs().max())
               for a, b in zip(got["plain"][2], got["remat"][2]))
    want = _remat_per_step(len(remat.llama.layers))
    counts = {k: got["remat"][1][k] for k in want}
    print(f"[{tag}] tiny Llama on the card, apply_llama_remat against "
          f"none: loss {got['remat'][0]} vs {got['plain'][0]}, first-step "
          f"grads max_err={gerr:.3e} (<= 1e-5 x {top:.3e}); remat launches "
          f"{json.dumps(counts)}", flush=True)
    if abs(got["remat"][0] - got["plain"][0]) > 1e-6 or gerr > 1e-5 * top:
        raise AssertionError(f"[{tag}] remat changed the numbers")
    if counts != want:
        raise AssertionError(f"[{tag}] remat launched {counts}, expected "
                             f"{want}")


def _agree_gpt_steps(tag, dev, batch):
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.jit import compile_train_step

    _, gcpu, ggpu = _tiny_gpt_pair(dev)
    losses = {}
    for key, model in (("cpu", gcpu), ("gpu", ggpu)):
        model.train()
        step = compile_train_step(model, lambda m, i, l: m(i, labels=l),
                                  O.AdamW(1e-3,
                                          parameters=model.parameters()))
        losses[key] = [float(step(*batch[key])) for _ in range(3)]
    err = max(abs(a - b) for a, b in zip(losses["cpu"], losses["gpu"]))
    print(f"[{tag}] tiny GPT, 3 AdamW steps: losses cpu {losses['cpu']} "
          f"cuda {losses['gpu']} max_err={err:.3e} (<= 1e-4)", flush=True)
    if err > 1e-4 or not losses["gpu"][-1] < losses["gpu"][0]:
        raise AssertionError(f"[{tag}] tiny GPT training disagrees")


def _agree_bert_o2(tag, dev, batch):
    from paddle_tpu_torch import amp, weights
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.models import BertConfig, BertForMaskedLM
    from paddle_tpu_torch.ops import kernels as K

    cfg = BertConfig.tiny(hidden=128, heads=2, ffn=256)
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    cpu = BertForMaskedLM(cfg, device="cpu")
    state = weights.random_state(cpu, seed=0)
    weights.from_paddle_tpu_state(state, cpu)
    gpu = weights.from_paddle_tpu_state(state, BertForMaskedLM(cfg,
                                                               device=dev))
    losses, scales = {}, {}
    K.reset_launch_counts()
    for key, model in (("cpu", cpu), ("gpu", gpu)):
        model.train()
        opt = O.AdamW(3e-3, parameters=model.parameters())
        model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
        scaler = amp.GradScaler(init_loss_scaling=1024.0)
        losses[key] = []
        for _ in range(4):
            with amp.auto_cast(level="O2"):
                loss = model(batch[key][0], labels=batch[key][1])
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            losses[key].append(float(loss.detach()))
        scales[key] = scaler._scale
    n = K.launch_counts()
    first = abs(losses["cpu"][0] - losses["gpu"][0])
    ok = first <= 2 * _bf16_ulp(losses["cpu"][0]) and all(
        abs(a - b) <= max(0.0625, 0.05 * abs(a))
        for a, b in zip(losses["cpu"], losses["gpu"]))
    print(f"[{tag}] tiny BERT (h 128, 2 heads of 64) decorate(O2) + "
          f"GradScaler(1024): losses cpu {losses['cpu']} cuda "
          f"{losses['gpu']} scale {scales}; flash launches (all, sm90) "
          f"{(n['flash_attention'], n['flash_attention.sm90'])}, backward "
          f"sm90 {n['flash_attention_bwd.sm90']}", flush=True)
    if not ok or scales["cpu"] != scales["gpu"]:
        raise AssertionError(f"[{tag}] the O2 BERT runs disagree")
    want = 4 * cfg.num_hidden_layers
    if n["flash_attention.sm90"] != want or \
            n["flash_attention_bwd.sm90"] != want:
        raise AssertionError(f"[{tag}] the O2 BERT did not take the "
                             f"tensor-core flash route every layer")


def _agree_checkpoint(tag, dev):
    import tempfile

    from paddle_tpu_torch.distributed import checkpoint as ckpt

    _, _, gpu = _tiny_pair(dev)
    sd = {**gpu.state_dict(), **_opt_state_of(gpu)}
    sd["wte_bf16"] = gpu.llama.embed_tokens.weight.detach().bfloat16()
    with tempfile.TemporaryDirectory() as d:
        ckpt.save_state_dict(sd, d)
        back = {k: torch.zeros(v.shape, dtype=v.dtype)
                for k, v in sd.items() if isinstance(v, torch.Tensor)}
        missing = ckpt.load_state_dict(back, d)
    same = all(torch.equal(back[k].reshape(-1).view(torch.uint8),
                           sd[k].detach().cpu().reshape(-1).view(
                               torch.uint8)) for k in back)
    print(f"[{tag}] checkpoint of the card's tiny Llama + AdamW state "
          f"({len(back)} tensors, bf16 among them) loaded on the CPU: "
          f"bit-equal={same}, missing={missing}", flush=True)
    if not same or missing:
        raise AssertionError(f"[{tag}] the checkpoint did not round-trip "
                             f"bit for bit")


def _opt_state_of(model):
    """The AdamW state of one more step of `model` (its live tensors, as
    a checkpoint saves them)."""
    from paddle_tpu_torch import optimizer as O

    opt = O.AdamW(1e-3, parameters=model.parameters())
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    opt.clear_grad()
    return opt.state_dict()


# [train:remat]: bench.py:147-170 exactly: TRAIN_CFG with recompute=True
# and apply_llama_remat
TRAIN_REMAT_PER_STEP = {**_remat_per_step(TRAIN_CFG["num_hidden_layers"]),
                        "flash_attention.sm90": 24,
                        "flash_attention_bwd.sm90": 12,
                        "fused_rope.scalar": 0, "fused_rope_bwd.scalar": 0}


def _remat_flops(cfg, n_matmul):
    """Flops the card does on top of the model's in a remat step: each
    decoder layer's forward again (2 T per matmul parameter of the layers,
    lm_head excluded, and attention's 2 forward causal products)."""
    t = TRAIN_BATCH * TRAIN_SEQ
    hd = cfg.hidden_size // cfg.num_attention_heads
    layer_params = n_matmul - cfg.hidden_size * cfg.vocab_size
    return 2 * layer_params * t + 4 * TRAIN_BATCH * \
        cfg.num_attention_heads * hd * _causal_pairs(TRAIN_SEQ, TRAIN_SEQ) * \
        cfg.num_hidden_layers


def _profile_step(tag, step, batch):
    """One more training step under torch.profiler, its device kernels
    held against the launches the wrappers counted (as the serving
    windows are held)."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops import kernels as K

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.prepare_trace()
    # device work traced before the window, as _profile_admission does:
    # prepared just before the step, the trace missed its first layer's
    # kernels (3 RMSNorms, a RoPE, a flash and a SwiGLU launch)
    x = torch.zeros(1 << 20, device=batch[0].device)
    for _ in range(256):
        x.add_(1.0)
    torch.cuda.synchronize()
    del x
    before = K.launch_counts()
    prof.start_trace()
    time.sleep(TRACE_EDGE_S)
    t0 = time.perf_counter()
    float(step(*batch))
    wall = time.perf_counter() - t0
    time.sleep(TRACE_EDGE_S)
    prof.stop_trace()
    after = K.launch_counts()
    _print_profile(tag, prof, wall, "one training step")
    _check_device_launches(tag, prof, {k: after[k] - before[k]
                                       for k in after})


def phase_train_remat(K, dev, base):
    """bench.py:147-170: TRAIN_CFG with recompute=True and
    apply_llama_remat, bf16, AdamW(1e-4, multi_precision=True), the same
    weights (seed 0) and batch (seed 1) as [train]; a warm-up and
    TRAIN_STEPS timed steps, each launching TRAIN_REMAT_PER_STEP; every
    loss within 2 bf16 ulps of [train]'s (remat replays the same kernels
    on the same inputs: it must not change the numbers); peak memory
    below [train]'s; then one step profiled, its device kernels held to
    the counted launches. Returns the timed steps' launches."""
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         apply_llama_remat)

    tag = "train:remat"
    _release()
    cfg = LlamaConfig(**TRAIN_CFG, recompute=True)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    weights.init_random_(model, seed=0)
    apply_llama_remat(model)
    model.train()
    n_params = sum(p.numel() for p in model.parameters())
    n_matmul = n_params - model.llama.embed_tokens.weight.numel()
    step, _ = _train_step(model, 1e-4, multi_precision=True)
    batch = _train_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, dev)
    losses, ms, totals = _run_steps(tag, K, step, batch,
                                    TRAIN_REMAT_PER_STEP, TRAIN_STEPS)
    step_ms = sum(ms[1:]) / len(ms[1:])
    peak = torch.cuda.max_memory_allocated() / 1e9
    flops, formula = _train_flops(cfg, n_matmul)
    hw = flops + _remat_flops(cfg, n_matmul)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    diffs = [abs(a - b) for a, b in zip(losses, base["losses"])]
    print(f"[{tag}] bench.py:147-170: TRAIN_CFG with recompute=True + "
          f"apply_llama_remat, bf16, AdamW(1e-4, multi_precision=True), "
          f"batch {TRAIN_BATCH}x{TRAIN_SEQ}")
    print(f"[{tag}] losses (warm-up first) {losses}; [train]'s "
          f"{base['losses']}; max |diff| {max(diffs):.4g} (<= 2 bf16 ulps)")
    print(f"[{tag}] step_ms {[round(x, 2) for x in ms]} mean_timed="
          f"{step_ms:.2f} (train {base['step_ms']:.2f}) tokens_per_s="
          f"{tokens / step_ms * 1e3:.1f} peak_mem_gb={peak:.2f} (train "
          f"{base['peak_gb']:.2f})")
    print(f"[{tag}] model flops/step {formula}; MFU={flops / (step_ms / 1e3) / 989e12:.4f}"
          f" (model flops, the replayed forward not counted); hardware "
          f"flops/step {hw:.4e} = model + the replayed layers' forward "
          f"{hw - flops:.4e}; hardware flops rate "
          f"{hw / (step_ms / 1e3) / 989e12:.4f} of 989 TFLOP/s")
    print(f"[{tag}] launches per step {json.dumps(TRAIN_REMAT_PER_STEP)} "
          f"(held every step)", flush=True)
    if any(d > 2 * _bf16_ulp(a) for d, a in zip(diffs, base["losses"])):
        raise AssertionError(f"[{tag}] remat changed the losses")
    if not peak < base["peak_gb"]:
        raise AssertionError(f"[{tag}] peak memory {peak:.2f} GB is not "
                             f"below [train]'s {base['peak_gb']:.2f}")
    _profile_step(f"profile:{tag}", step, batch)
    del model, step
    _release()
    return totals


GPT_TRAIN_BATCH, GPT_TRAIN_SEQ, GPT_TRAIN_STEPS = 4, 2048, 3
GPT_TRAIN_PER_STEP = {"flash_attention": 24, "flash_attention_bwd": 24,
                      "flash_attention.sm90": 24,
                      "flash_attention_bwd.sm90": 24, "rms_norm": 0,
                      "swiglu": 0, "fused_rope": 0, "fused_rope_bwd": 0}


def phase_train_gpt(K, dev):
    """GPT-3 1.3B (GPTConfig.gpt3_1p3b(): all 24 layers, hidden 2048, 16
    heads of 128, FFN 8192, vocab 50304) in bf16 with random weights from
    seed 0, AdamW(multi_precision=True) under LinearWarmup(
    CosineAnnealingDecay(1e-4, 100), 1, 1e-5, 1e-4), batch 4 x 2048 from
    seed 1: a warm-up and GPT_TRAIN_STEPS timed steps of
    compile_train_step, the scheduler stepped after each; each step
    launches the flash forward and backward once a layer (tensor-core
    route) and no Llama kernel; the rate each step equals the
    scheduler's; the loss falls. Returns the timed steps' launches."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.jit import compile_train_step
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    tag = "train:gpt"
    _release()
    cfg = GPTConfig.gpt3_1p3b()
    model = GPTForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    weights.init_random_(model, seed=0)
    model.train()
    n_params = sum(p.numel() for p in model.parameters())
    n_matmul = n_params - model.gpt.wpe.weight.numel() - sum(
        p.numel() for n, p in model.named_parameters()
        if "ln_" in n or n.endswith("bias"))
    sched = _warmup_cosine(O.lr, 1e-4, 1, 100, start=1e-5)
    opt = O.AdamW(sched, parameters=model.parameters(), multi_precision=True)
    step = compile_train_step(model, lambda m, i, l: m(i, labels=l), opt)
    batch = _train_batch(cfg.vocab_size, GPT_TRAIN_BATCH, GPT_TRAIN_SEQ, dev)
    rates = []

    def on_step(i):
        sched.step()
        rates.append((opt.get_lr(), sched()))

    rates.append((opt.get_lr(), sched()))       # the warm-up step's rate
    losses, ms, totals = _run_steps(tag, K, step, batch, GPT_TRAIN_PER_STEP,
                                    GPT_TRAIN_STEPS, on_step)
    step_ms = sum(ms[1:]) / len(ms[1:])
    t = GPT_TRAIN_BATCH * GPT_TRAIN_SEQ
    hd = cfg.hidden_size // cfg.num_attention_heads
    pairs = _causal_pairs(GPT_TRAIN_SEQ, GPT_TRAIN_SEQ)
    attn = 14 * GPT_TRAIN_BATCH * cfg.num_attention_heads * hd * pairs * \
        cfg.num_hidden_layers
    flops = 6 * n_matmul * t + attn
    print(f"[{tag}] GPTConfig.gpt3_1p3b(): {cfg.num_hidden_layers} layers, "
          f"hidden {cfg.hidden_size}, {cfg.num_attention_heads} heads, FFN "
          f"{cfg.intermediate_size}, vocab {cfg.vocab_size}; params="
          f"{n_params} bf16 (matmul N={n_matmul}, the tied head counted "
          f"once); batch {GPT_TRAIN_BATCH}x{GPT_TRAIN_SEQ}; AdamW("
          f"multi_precision=True) under LinearWarmup(CosineAnnealingDecay("
          f"1e-4, 100), 1, 1e-5, 1e-4)")
    print(f"[{tag}] losses (warm-up first) {losses}; rates (optimizer, "
          f"scheduler) of each step and after the last {rates}")
    print(f"[{tag}] step_ms {[round(x, 2) for x in ms]} mean_timed="
          f"{step_ms:.2f} tokens_per_s={t / step_ms * 1e3:.1f} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    print(f"[{tag}] flops/step 6*N*T + 14*B*H*D*pairs*L = 6*{n_matmul}*{t} "
          f"+ 14*{GPT_TRAIN_BATCH}*{cfg.num_attention_heads}*{hd}*{pairs}*"
          f"{cfg.num_hidden_layers} = {flops:.4e}; MFU="
          f"{flops / (step_ms / 1e3) / 989e12:.4f} (of 989 TFLOP/s bf16 "
          f"dense)")
    print(f"[{tag}] launches per step {json.dumps(GPT_TRAIN_PER_STEP)} "
          f"(held every step)", flush=True)
    if any(a != b for a, b in rates):
        raise AssertionError(f"[{tag}] the optimizer's rate is not the "
                             f"scheduler's: {rates}")
    del model, opt, step
    _release()
    return totals


BERT_TRAIN_BATCH, BERT_TRAIN_STEPS, BERT_MASKED = (32, 512), 5, 0.15


def phase_train_bert(K, dev):
    """BERT-base MLM (BASELINE config 2): BertForMaskedLM(bert_base()),
    random weights from seed 0, training mode with the configured dropout
    0.1, decorate(O2, bfloat16) + GradScaler(init_loss_scaling=1024),
    AdamW(1e-4), batch 32 x 512 from seed 1 with 15% of the positions
    labelled: a warm-up and BERT_TRAIN_STEPS timed steps (host clock to a
    sync), the scale after each. With dropout while training, attention
    is the dense plain path, as in the JAX package: no flash launch. The
    loss must fall; the parameters bf16 but LayerNorm's float32, with
    float32 masters. Returns the timed steps' launches."""
    from paddle_tpu_torch import amp, weights
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.models import BertConfig, BertForMaskedLM

    tag = "train:bert"
    _release()
    cfg = BertConfig.bert_base()
    b, s = BERT_TRAIN_BATCH
    model = BertForMaskedLM(cfg, device=dev)
    weights.init_random_(model, seed=0)
    model.train()
    opt = O.AdamW(1e-4, parameters=model.parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    scaler = amp.GradScaler(init_loss_scaling=1024.0)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab_size, (b, s))
    lab = ids.copy()
    lab[rng.random((b, s)) >= BERT_MASKED] = -100
    ids, lab = torch.from_numpy(ids).to(dev), torch.from_numpy(lab).to(dev)
    scales = []

    def step(i, l):
        with amp.auto_cast(level="O2"):
            loss = model(i, labels=l)
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        scales.append(scaler._scale)
        return loss.detach()

    per_step = {"flash_attention": 0, "flash_attention_bwd": 0}
    losses, ms, totals = _run_steps(tag, K, step, (ids, lab), per_step,
                                    BERT_TRAIN_STEPS)
    step_ms = sum(ms[1:]) / len(ms[1:])
    emb = model.bert.embeddings
    print(f"[{tag}] BertConfig.bert_base() BertForMaskedLM, dropout "
          f"{cfg.hidden_dropout_prob}/{cfg.attention_probs_dropout_prob}, "
          f"decorate(O2, bf16) + GradScaler(1024), AdamW(1e-4), batch "
          f"{b}x{s}, {int(BERT_MASKED * 100)}% labelled")
    print(f"[{tag}] losses (warm-up first) {losses}; scale after each "
          f"step {scales}; skipped {scaler.skipped_steps}")
    print(f"[{tag}] step_ms {[round(x, 2) for x in ms]} mean_timed="
          f"{step_ms:.2f} tokens_per_s={b * s / step_ms * 1e3:.1f} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}; "
          f"flash launches 0 a step (the dense path under dropout)",
          flush=True)
    if emb.word_embeddings.weight.dtype != torch.bfloat16 or \
            emb.layer_norm.weight.dtype != torch.float32 or \
            id(emb.word_embeddings.weight) not in opt._master_weights:
        raise AssertionError(f"[{tag}] O2 did not leave bf16 parameters, "
                             f"float32 LayerNorm and float32 masters")
    del model, opt
    _release()
    return totals



# ----------------------------------------------------------------------
# the fleet plane: KV pages on the wire, the router and its replicas
# ----------------------------------------------------------------------

FLEET_TINY_KW = dict(max_slots=2, page_size=4, max_seq_len=64, n_pages=65,
                     prefix_cache=True, prefill_chunk=8, mixed_step=True)


# the card's and the CPU's float32 K/V differ where their GEMMs sum in
# other orders: a page value is held within F32_PAGE_TOL of the export's
# largest |value|; int8 codes may then differ by one at a half-code
# boundary, at most one code in INT8_CODE_SHARE (the tests' rule), and
# scale rows within F32_PAGE_TOL relative
F32_PAGE_TOL = 1e-5
INT8_CODE_SHARE = 500


def _f32_pages_close(a, b):
    """Two float32 exports of the same pages: (crc32 equal, payload equal,
    max |a - b|, allowed, ok)."""
    from paddle_tpu_torch.serving import unpack_pages
    (am, ap), (bm, bp) = a, b
    fa = torch.cat([t.flatten() for t in unpack_pages(am, ap)])
    fb = torch.cat([t.flatten() for t in unpack_pages(bm, bp)])
    err = float((fa - fb).abs().max())
    allowed = F32_PAGE_TOL * float(fa.abs().max())
    return (am["crc32"] == bm["crc32"], ap == bp, err, allowed,
            am["tokens"] == bm["tokens"] and err <= allowed)


def _int8_pages_equal(a, b):
    """Two int8 exports' codes and scale rows, compared value for value:
    (codes equal, scales equal, differing codes, largest code gap, max
    relative scale difference, ok)."""
    from paddle_tpu_torch.serving import unpack_pages, unpack_scales
    (am, ap), (bm, bp) = a, b
    ka, va = unpack_pages(am, ap)
    kb, vb = unpack_pages(bm, bp)
    diff = torch.cat([(ka.int() - kb.int()).flatten(),
                      (va.int() - vb.int()).flatten()]).abs()
    sa, sb = unpack_scales(am), unpack_scales(bm)
    rel = max(float(np.max(np.abs(x - y) / np.maximum(np.abs(y), 1e-30)))
              for x, y in zip(sa, sb))
    n_diff = int(np.count_nonzero(diff.numpy()))
    ok = (am["tokens"] == bm["tokens"] and int(diff.max()) <= 1
          and n_diff * INT8_CODE_SHARE <= diff.numel()
          and rel <= F32_PAGE_TOL)
    return (int(diff.max()) == 0,
            all(np.array_equal(x, y) for x, y in zip(sa, sb)),
            n_diff, int(diff.max()), rel, ok)


def phase_agree_fleet(dev):
    """The KV transfer plane on the tiny f32 pair, float and int8 pools:
    the card and the CPU serve the same prompts and export each prompt's
    pages (``export_kv_pages``); the card's exports import into a CPU
    engine and the CPU's into a card engine, and both continue with the
    cold run's tokens (the prefix hits served by the imported pages, the
    card's paged kernels reading them); a request exported mid-stream
    with its KV (``export_request(with_kv=True)``) continues exactly once
    on the other device; a card engine whose pool cannot hold the prompts
    spills into a PrefixStore and refills token-exact. The card's and the
    CPU's exports of the same prompt are compared byte for byte (float)
    and code for code with their scale rows (int8)."""
    import zlib

    from paddle_tpu_torch.inference import GenerationEngine
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving import PrefixStore

    cfg, cpu, gpu = _tiny_pair(dev)
    prompts = _serving_prompts(np.random.default_rng(5), 4, 9, 22,
                               cfg.vocab_size, 8, (0, 2))
    n_new = 12
    for kv in (None, "int8"):
        tag = "agree:fleet" if kv is None else "agree:fleet:int8"
        kw = dict(FLEET_TINY_KW, kv_dtype=kv)
        want = [w[len(p):].tolist() for w, p in
                zip(_serve_tiny(cpu, prompts, n_new, **kw)[1], prompts)]
        exports = {}
        for name, model in (("cpu", cpu), ("cuda", gpu)):
            eng, got = _serve_tiny(model, prompts, n_new, **kw)
            if [g[len(p):].tolist() for g, p in zip(got, prompts)] != want:
                raise AssertionError(f"[{tag}] {name} cold run != the CPU's")
            exports[name] = [eng.export_kv_pages(p) for p in prompts]
        if any(e is None for e in exports["cuda"] + exports["cpu"]):
            raise AssertionError(f"[{tag}] a prompt exported no page")
        if kv is None:
            same = [_f32_pages_close(c, g)
                    for c, g in zip(exports["cpu"], exports["cuda"])]
            bytes_ok = all(ok for *_, ok in same)
            detail = (f"(crc32 equal, payload equal, max |card - cpu|, "
                      f"allowed) per prompt {same}")
        else:
            same = [_int8_pages_equal(c, g)
                    for c, g in zip(exports["cpu"], exports["cuda"])]
            bytes_ok = all(ok for *_, ok in same)
            detail = (f"(codes equal, scales equal, differing codes, "
                      f"largest gap, max scale rel diff, ok) per prompt "
                      f"{same}")
        n_pages = sum(m["n_pages"] for m, _ in exports["cuda"])
        n_bytes = sum(len(pl) for _, pl in exports["cuda"])
        crc = zlib.crc32(b"".join(pl for _, pl in exports["cuda"]))
        print(f"[{tag}] card vs CPU exports of the same prompts "
              f"({n_pages} pages, {n_bytes} bytes, crc32 of the card's "
              f"{crc:#010x}): {detail}", flush=True)
        if not bytes_ok:
            raise AssertionError(f"[{tag}] the card's and the CPU's exports "
                                 "of the same prompts differ")

        K.reset_launch_counts()
        crossed = {}
        for src, model in (("cuda", cpu), ("cpu", gpu)):
            eng = GenerationEngine(model, **kw)
            mapped = sum(eng.import_kv_pages(m, pl) for m, pl in exports[src])
            rids = [eng.add_request(p, max_new_tokens=n_new)
                    for p in prompts]
            with torch.inference_mode():
                out = eng.run()
            got = [out[r][len(p):].tolist() for r, p in zip(rids, prompts)]
            crossed[src] = (got == want, mapped,
                            eng.stats["prefix_hit_tokens"],
                            eng.upload_trace_count)
        launches = K.launch_counts()

        # mid-stream with KV: card -> CPU, then CPU -> card
        moved = []
        for a, b in ((gpu, cpu), (cpu, gpu)):
            src = GenerationEngine(a, **kw)
            rid = src.add_request(prompts[2], max_new_tokens=n_new)
            with torch.inference_mode():
                while len(src._reqs[rid].out) < 3:
                    src.step()
            snap = src.export_request(rid, with_kv=True)
            dst = GenerationEngine(b, **kw)
            drid = dst.import_request(snap)
            start = len(snap["tokens"]) - len(prompts[2])
            rest = [t for _, t in dst.stream_request(drid, start)]
            moved.append((snap["tokens"][len(prompts[2]):] + rest
                           == want[2], "kv" in snap,
                           dst.stats["prefix_hit_tokens"]))

        # a pool too small for the prompts: spill, then refill
        ps = PrefixStore()
        eng = GenerationEngine(gpu, **dict(kw, n_pages=14,
                                           prefix_store=ps))
        rng = np.random.default_rng(6)
        churn = [rng.integers(1, cfg.vocab_size, 30) for _ in range(4)]
        first = _serve_via(eng, [prompts[3]], n_new)
        for c in churn:
            _serve_via(eng, [c], 4)
        spilled = len(ps)
        again = _serve_via(eng, [prompts[3]], n_new)
        st = eng.stats
        refilled = eng.upload_trace_count
        print(f"[{tag}] imports: card exports -> CPU engine (tokens ok, "
              f"pages mapped, prefix hit tokens, upload programs) "
              f"{crossed['cuda']}; CPU exports -> card engine "
              f"{crossed['cpu']}; mid-stream export_request(with_kv=True) "
              f"(tokens ok, kv rode, hit tokens) card -> CPU {moved[0]}, "
              f"CPU -> card {moved[1]}; small pool (n_pages 14): "
              f"{spilled} pages spilled, refill upload programs "
              f"{refilled}, tokens ok {first == [want[3]]} / "
              f"{again == [want[3]]}, prefix hits {st['prefix_hits']}",
              flush=True)
        print(f"[{tag}] launches on the card while importing "
              f"{json.dumps({k: v for k, v in launches.items() if v})}",
              flush=True)
        ok = (all(c[0] and c[1] > 0 and c[2] > 0 for c in crossed.values())
              and all(m[0] and m[1] and m[2] > 0 for m in moved)
              and spilled > 0 and refilled > 0
              and first == [want[3]] and again == [want[3]])
        if not ok:
            raise AssertionError(f"[{tag}] the transfer plane disagrees "
                                 "with the cold run")
        suffix = "" if kv is None else "_int8"
        _require_launched(tag, launches, (f"ragged_paged_attention{suffix}",
                                          f"paged_decode_attention{suffix}"))
        if kv is not None:
            _require_idle(tag, launches, FLOAT_PAGED_KERNELS)


def _serve_via(eng, prompts, n_new):
    rids = [eng.add_request(np.asarray(p), max_new_tokens=n_new)
            for p in prompts]
    with torch.inference_mode():
        out = eng.run()
    return [out[r][len(p):].tolist() for r, p in zip(rids, prompts)]


def _fleet_counters():
    from paddle_tpu_torch.observability.metrics import REGISTRY
    return dict(REGISTRY.snapshot()["counters"])


def _stream_fleet(router, prompts, n_new, on_token=None, timeout=900):
    """Every prompt streamed through the router from its own thread.
    Returns (tokens per prompt, errors)."""
    import threading

    results, errors = [None] * len(prompts), []

    def client(i):
        try:
            toks = []
            for t in router.stream(prompts[i], max_new_tokens=n_new):
                toks.append(int(t))
                if on_token is not None:
                    on_token()
            results[i] = toks
        except Exception as e:  # noqa: BLE001 — graded by the caller
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if any(t.is_alive() for t in threads):
        raise AssertionError("fleet streams did not finish in time")
    return results, errors


def _delta(c1, c0, name):
    return c1.get(name, 0) - c0.get(name, 0)


# a fleet run's token is held within this many bf16 ulps (at the larger
# logit) of the dense forward's argmax at its position: the prefill
# replica's buckets hold other rows than one engine's, so its GEMMs round
# bf16 otherwise, and a failover re-prefills delivered tokens whose KV
# the decode steps wrote; int8 pages also carry their rounding, which the
# dense forward does not. Twice the worst gap the H100 showed over every
# position of the fleet waves (bf16 8 ulps, int8 19); a lost or misplaced
# token or a corrupted page leaves tokens far from the argmax
FLEET_TIE_ULPS = {None: 16.0, "int8": 38.0}


def _fleet_ties(tag, model, prompts, got, want, kv_dtype,
                allowed=FLEET_TIE_ULPS):
    """The fleet's tokens against [serve]'s (`want`) and against greedy
    decoding itself: at every position the dense forward over the prompt
    and the tokens before it must score the delivered token within
    `allowed[kv_dtype]` bf16 ulps of its argmax. A lost, repeated or
    misplaced token, or a page the handoff corrupted, would leave the
    argmax by far more."""
    rows = []
    for p, g, w in zip(prompts, got, want):
        ids = torch.as_tensor(np.concatenate([p, g[:-1]])[None],
                              dtype=torch.long, device=model.device)
        with torch.inference_mode():
            logits = model(ids)[0, len(p) - 1:].float()
        top = logits.max(dim=-1).values
        chosen = logits[torch.arange(len(g)), torch.as_tensor(g)]
        ulp = torch.exp2(torch.floor(torch.log2(
            torch.maximum(top.abs(), chosen.abs()).clamp_min(1e-30))) - 7)
        gaps = ((top - chosen) / ulp).cpu().numpy()
        neq = np.flatnonzero(np.asarray(g) != np.asarray(w))
        rows.append((int(neq[0]) if neq.size else None,
                     int(np.count_nonzero(gaps > 0)),
                     round(float(gaps.max()), 2)))
    worst = max(r[2] for r in rows)
    print(f"[{tag}] per request: (first position leaving [serve]'s tokens, "
          f"positions whose token is not the dense forward's argmax, "
          f"largest gap to the argmax in bf16 ulps) {rows}; worst "
          f"{worst:.2f} ulps (allowed {allowed[kv_dtype]:g})",
          flush=True)
    if worst > allowed[kv_dtype]:
        raise AssertionError(f"[{tag}] a delivered token is no near-tie of "
                             f"greedy decoding: {worst:.2f} ulps")


def _check_ragged_steps(tag, ragged, stats, layers):
    """The ragged kernel launched once a layer for every ragged step of
    the fleet's engines (the decode replica's among them)."""
    steps = sum(st["ragged_steps"] for st in stats)
    if ragged != steps * layers:
        raise AssertionError(f"[{tag}] ragged launches {ragged} != the "
                             f"engines' ragged steps {steps} x {layers}")


def _handoff_parts(tag, src, dst, prompt):
    """One prefill -> decode handoff of `prompt`'s pages timed by part on
    the host clock (export: gather, pack without the crc, the crc;
    import: unpack without the crc, the crc, the upload program), then
    the decode replica's TTFT after that handoff beside a re-prefill of
    the same prompt on it (each the second of two runs: the first
    captures the step programs of its shapes)."""
    import zlib

    rows = []
    for _ in range(2):
        _serve_via(src, [prompt], 1)    # its pages indexed on the source
        dst.blocks.invalidate_index()
        s0, d0 = dict(src.stats), dict(dst.stats)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        meta, payload = src.export_kv_pages(prompt)
        t1 = time.perf_counter()
        mapped = dst.import_kv_pages(meta, payload)
        t2 = time.perf_counter()
        same = _same_pages(src, dst, prompt)
        _serve_via(dst, [prompt], 1)
        t3 = time.perf_counter()
        c0 = time.perf_counter()
        zlib.crc32(payload)
        crc = time.perf_counter() - c0
        dst.blocks.invalidate_index()
        torch.cuda.synchronize()
        r0 = time.perf_counter()
        _serve_via(dst, [prompt], 1)
        reprefill = time.perf_counter() - r0
        rows.append(dict(
            pages=meta["n_pages"], mapped=mapped, bytes=len(payload),
            pages_bit_equal=same,
            gather_ms=(src.stats["kv_gather_s"] - s0["kv_gather_s"]) * 1e3,
            pack_ms=(src.stats["kv_pack_s"] - s0["kv_pack_s"] - crc) * 1e3,
            export_crc_ms=crc * 1e3,
            unpack_ms=(dst.stats["kv_unpack_s"] - d0["kv_unpack_s"] - crc)
            * 1e3,
            import_crc_ms=crc * 1e3,
            upload_ms=(dst.stats["kv_upload_s"] - d0["kv_upload_s"]) * 1e3,
            export_ms=(t1 - t0) * 1e3, import_ms=(t2 - t1) * 1e3,
            first_token_ms=(t3 - t2) * 1e3,
            handoff_ttft_ms=(t3 - t0) * 1e3,
            reprefill_ttft_ms=reprefill * 1e3))
    row = {k: (round(v, 3) if isinstance(v, float) else v)
           for k, v in rows[-1].items()}
    print(f"[{tag}] handoff of a {len(prompt)}-token prompt, by part (ms, "
          f"host clock; crc32 timed alone on the payload): "
          f"{json.dumps(row)}", flush=True)
    if not all(r["pages_bit_equal"] and r["mapped"] == r["pages"]
               for r in rows):
        raise AssertionError(f"[{tag}] the decode replica's pages (and "
                             "scale rows) are not the prefill replica's, "
                             "bit for bit")
    return row


def _same_pages(src, dst, tokens):
    """The pages (and int8 scale rows) that two engines index for the
    prefix chain of `tokens`, gathered from their pools: bit-equal?"""
    from paddle_tpu_torch.inference.engine import _prefix_chain

    def pids(eng):
        out = []
        for h, _, _ in _prefix_chain(tokens, eng.page_size):
            entry = eng.blocks._index.get(h)
            if entry is None:
                break
            out.append(entry[0])
        return out

    a, b = pids(src), pids(dst)
    if not a or len(a) != len(b):
        return False
    ga, gb = src._gather_pages(a), dst._gather_pages(b)
    return all((x is None and y is None) or
               torch.equal(x.view(torch.uint8), y.view(torch.uint8))
               for x, y in zip(ga, gb))


def phase_fleet(K, model, want, kv_dtype=None):
    """Two LocalReplicas over the one 7B model, each with its own engine
    and pools, roles prefill and decode behind one Router, serve
    [serve]'s workload: every request prefills on p0, hands its pages to
    d0 and decodes there. The tokens are held to greedy decoding and
    against [serve]'s (`want`) by ``_fleet_ties``, every
    request must cross the handoff with pages, p0 must never decode and
    d0 must run the ragged (suffix over imported pages) and the paged
    decode kernels. Then the handoff by part for the 512-token shared
    prefix's prompt, and a second wave on a fleet grown by a second
    decode replica d1: d0 is killed mid-stream, then d1 drained with
    transfer; zero failed requests, no duplicate token, the tokens held
    again. int8 pools (kv_dtype="int8") launch the int8 attention
    kernels and never the float paged ones."""
    from paddle_tpu_torch.inference import GenerationEngine
    from paddle_tpu_torch.serving import LocalReplica, Router

    cfg = model.config
    tag = "fleet" if kv_dtype is None else "fleet:int8"
    _fresh_pools(model)
    rng = np.random.default_rng(0)
    prompts = _serving_prompts(rng, 8, 300, 900, cfg.vocab_size, 512, (0, 5))
    want = [np.asarray(w).tolist() for w in want]
    n_new = 32
    kw = dict(max_slots=4, page_size=16, prefill_chunk=256, mixed_step=True,
              prefix_cache=True, kv_dtype=kv_dtype)
    reps = {"p0": LocalReplica("p0", model,
                               engine=GenerationEngine(model, **kw),
                               role="prefill"),
            "d0": LocalReplica("d0", model,
                               engine=GenerationEngine(model, **kw),
                               role="decode")}
    router = Router(reps, page_size=16)
    c0 = _fleet_counters()
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, errors = _stream_fleet(router, prompts, n_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    c1 = _fleet_counters()
    p_st, d_st = reps["p0"].engine.stats, reps["d0"].engine.stats
    moved = {k: _delta(c1, c0, f"fleet_{k}_total") for k in (
        "prefill_handoffs", "kv_transfers", "kv_transfer_pages",
        "kv_transfer_fallbacks", "requests_failed", "dup_tokens_suppressed")}
    same = [g == w for g, w in zip(got, want)]
    print(f"[{tag}] roles p0=prefill d0=decode, 8 requests x {n_new} "
          f"tokens: wall_s={wall:.3f}; tokens == [serve{'' if kv_dtype is None else ':int8'}]'s "
          f"{sum(same)}/{len(same)} {same}; errors {errors}; fleet counters "
          f"{json.dumps(moved)}", flush=True)
    print(f"[{tag}] pages/bytes moved: exported by p0 {p_st['kv_pages_out']} "
          f"pages {p_st['kv_bytes_out']} bytes (gather_s="
          f"{p_st['kv_gather_s']:.4f} pack_s={p_st['kv_pack_s']:.4f}), "
          f"imported by d0 {d_st['kv_pages_in']} pages "
          f"{d_st['kv_bytes_in']} bytes (unpack_s="
          f"{d_st['kv_unpack_s']:.4f} upload_s={d_st['kv_upload_s']:.4f}); "
          f"p0 ragged steps {p_st['ragged_steps']} decode steps "
          f"{p_st['decode_steps']}; d0 ragged steps {d_st['ragged_steps']} "
          f"decode steps {d_st['decode_steps']} prefix hit tokens "
          f"{d_st['prefix_hit_tokens']}; upload programs "
          f"{reps['d0'].engine.upload_trace_count}", flush=True)
    print(f"[{tag}] launches {json.dumps(launches)}", flush=True)
    suffix = "" if kv_dtype is None else "_int8"
    layers = cfg.num_hidden_layers
    if errors or any(g is None or len(g) != n_new for g in got):
        raise AssertionError(f"[{tag}] a request failed or came back short")
    _fleet_ties(tag, model, prompts, got, want, kv_dtype)
    if moved["prefill_handoffs"] != len(prompts) or \
            moved["kv_transfer_pages"] <= 0 or moved["requests_failed"]:
        raise AssertionError(f"[{tag}] not every request crossed the "
                             f"handoff with pages: {moved}")
    if p_st["decode_steps"] or not d_st["ragged_steps"] or \
            not d_st["decode_steps"] or not d_st["kv_pages_in"]:
        raise AssertionError(f"[{tag}] the roles did not split: p0 decoded "
                             "or d0 ran no ragged or decode step")
    _require_launched(tag, launches, (f"paged_decode_attention{suffix}",
                                      f"ragged_paged_attention{suffix}"))
    _check_ragged_steps(tag, launches[f"ragged_paged_attention{suffix}"],
                        (p_st, d_st), layers)
    if kv_dtype is not None:
        _require_idle(tag, launches, FLOAT_PAGED_KERNELS)
    totals = dict(launches)

    parts = _handoff_parts(tag, reps["p0"].engine, reps["d0"].engine,
                           prompts[0])
    peak = torch.cuda.max_memory_allocated() / 1e9

    # the second wave: a second decode replica; d0 killed mid-stream,
    # then d1 drained with transfer (its sequences move to p0)
    reps["d1"] = router.spawn(
        "d1", LocalReplica("d1", model, engine=GenerationEngine(model, **kw),
                           role="decode"), role="decode")
    for r in reps.values():
        r.engine.blocks.invalidate_index()
    c0 = _fleet_counters()
    K.reset_launch_counts()
    delivered, fired = [0], []

    def on_token():
        delivered[0] += 1
        if delivered[0] >= 3 * len(prompts) and "kill" not in fired:
            fired.append("kill")
            reps["d0"].kill()
        if delivered[0] >= 12 * len(prompts) and "drain" not in fired:
            fired.append("drain")
            router.drain("d1")

    t0 = time.perf_counter()
    got2, errors2 = _stream_fleet(router, prompts, n_new, on_token)
    wall2 = time.perf_counter() - t0
    c1 = _fleet_counters()
    for k, v in K.launch_counts().items():
        totals[k] = totals.get(k, 0) + v
    moved2 = {k: _delta(c1, c0, f"fleet_{k}_total") for k in (
        "prefill_handoffs", "requests_rerouted", "failovers",
        "drain_exports", "kv_transfers", "kv_transfer_pages",
        "kv_transfer_fallbacks", "requests_failed", "dup_tokens_suppressed")}
    same2 = [g == w for g, w in zip(got2, want)]
    print(f"[{tag}] second wave (d1 spawned; d0 killed after "
          f"{3 * len(prompts)} tokens, d1 drained with transfer after "
          f"{12 * len(prompts)}; fired {fired}): wall_s={wall2:.3f}; tokens "
          f"== [serve]'s {sum(same2)}/{len(same2)}; errors {errors2}; "
          f"fleet counters {json.dumps(moved2)}; peak_mem_gb={peak:.2f}",
          flush=True)
    router.stop()
    if errors2 or moved2["requests_failed"] or \
            moved2["dup_tokens_suppressed"] or \
            any(g is None or len(g) != n_new for g in got2):
        raise AssertionError(f"[{tag}] the second wave failed a request or "
                             "delivered a token twice")
    _fleet_ties(f"{tag}:wave2", model, prompts, got2, want, kv_dtype)
    if fired != ["kill", "drain"] or moved2["requests_rerouted"] <= 0 or \
            moved2["drain_exports"] <= 0:
        raise AssertionError(f"[{tag}] the kill or the drain did not land "
                             f"mid-stream: {fired} {moved2}")
    for r in reps.values():
        r.shutdown()
    del reps, router
    _fresh_pools(model)
    return totals, dict(parts, wall_s=wall, peak_gb=peak)


PROC_CONFIG = dict(num_hidden_layers=2, dtype="float32", seed=0)


def phase_fleet_proc(dev):
    """Two ProcessReplica workers (``python -m
    paddle_tpu_torch.serving.worker``) on the card, each building the
    Llama-2-7B width (hidden 4096, 32 heads, FFN 11008, vocab 32000) at 2
    layers in float32, sharing one FileStore fleet prefix store. A
    512-token prompt served by w0 and spilled there under pressure is a
    fleet-tier prefix hit on w1; w1's pages cross the sidecar frame back
    to w0; then the router streams 4 requests over both and w0 is
    SIGKILLed mid-stream: zero failed requests, exactly-once resume, and
    every token equal to an in-process engine's over the same model."""
    import shutil
    import tempfile
    import threading

    from paddle_tpu_torch.inference import (GenerationEngine,
                                            make_sequence_snapshot)
    from paddle_tpu_torch.inference.engine import prefix_chain_hashes
    from paddle_tpu_torch.serving import (FileStore, PrefixStore,
                                          ProcessReplica, Router)
    from paddle_tpu_torch.serving.worker import random_llama

    tag = "fleet:proc"
    _release()
    engine_kw = dict(max_slots=2, page_size=16, prefill_chunk=256,
                     mixed_step=True, prefix_cache=True, n_pages=97)
    spec = {"kind": "import",
            "path": "paddle_tpu_torch.serving.worker:random_llama",
            "config": PROC_CONFIG, "engine": engine_kw, "device": dev.type}
    rng = np.random.default_rng(9)
    vocab = 32000
    shared = rng.integers(1, vocab, 512)
    x = np.concatenate([shared, rng.integers(1, vocab, 37)])
    # three churn prompts: the third evicts the head of x's chain too
    churn = [rng.integers(1, vocab, 700) for _ in range(3)]
    prompts = [np.concatenate([shared, rng.integers(1, vocab, n)])
               for n in (20, 90)] + [rng.integers(1, vocab, n)
                                     for n in (300, 450)]
    n_new = 24

    model = random_llama(device=dev, **PROC_CONFIG)
    ref = GenerationEngine(model, **engine_kw)
    want_x = _serve_via(ref, [x], 8)[0]
    want = _serve_via(ref, prompts, n_new)
    del ref, model
    _release()

    root = tempfile.mkdtemp(prefix="fleet_proc_")
    reps, started = {}, {}
    try:
        kv_root = os.path.join(root, "kv")

        def start(name):
            t0 = time.perf_counter()
            reps[name] = ProcessReplica(name, spec, kv_store_root=kv_root,
                                        startup_timeout=300.0,
                                        read_timeout=300.0)
            started[name] = time.perf_counter() - t0

        threads = [threading.Thread(target=start, args=(n,))
                   for n in ("w0", "w1")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(330)
        if set(reps) != {"w0", "w1"}:
            raise AssertionError(f"[{tag}] workers did not start: {started}")

        def submit(name, prompt, n):
            snap = make_sequence_snapshot(prompt, remaining=n)
            return [t for _, t in reps[name].submit(snap)]

        got_x0 = submit("w0", x, 8)
        for c in churn:                  # evicts x's pages: they spill
            submit("w0", c, 4)
        # every full page of x in the fleet tier (the spills are written
        # by each worker's background writer)
        fs = FileStore(kv_root)
        keys = {PrefixStore(store=fs)._key(h, "init") for h in
                prefix_chain_hashes(x[:len(x) - 1], 16)}
        deadline = time.monotonic() + 120
        while not keys <= set(fs.keys("serve/kv/")) and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        spilled = len(keys & set(fs.keys("serve/kv/")))
        got_x1 = submit("w1", x, 8)
        series = reps["w1"].metrics()["series"]
        fleet_hits = sum(s["value"] for s in series
                         if s["name"] == "kv_store_fleet_hits_total")
        refilled = sum(s["value"] for s in series
                       if s["name"] == "engine_kv_pages_refilled_total")
        t0 = time.perf_counter()
        meta, payload = reps["w1"].export_kv(x)
        t1 = time.perf_counter()
        mapped = reps["w0"].import_kv(meta, payload)
        t2 = time.perf_counter()
        print(f"[{tag}] workers started in (s) "
              f"{json.dumps({k: round(v, 2) for k, v in started.items()})};"
              f" fleet tier: w0 served the {len(x)}-token prompt (== the "
              f"in-process engine: {got_x0 == want_x}), spilled all "
              f"{spilled}/{len(keys)} of its pages under churn; w1 served it with "
              f"{fleet_hits} fleet-tier hits, {refilled} pages refilled "
              f"(tokens == in-process: {got_x1 == want_x}); sidecar frames:"
              f" export_kv {len(payload)} bytes ({meta['n_pages']} pages) "
              f"in {(t1 - t0) * 1e3:.1f} ms, import_kv {mapped} pages "
              f"mapped in {(t2 - t1) * 1e3:.1f} ms", flush=True)
        if not (got_x0 == want_x == got_x1 and spilled == len(keys)
                and fleet_hits > 0 and refilled > 0 and mapped > 0):
            raise AssertionError(f"[{tag}] the fleet prefix tier or the "
                                 "sidecar frames failed")

        router = Router(reps, page_size=16)
        c0 = _fleet_counters()
        delivered, killed = [0], []

        def on_token():
            delivered[0] += 1
            if delivered[0] >= 2 * len(prompts) and not killed:
                killed.append(time.perf_counter())
                reps["w0"].kill()         # a real SIGKILL

        got, errors = _stream_fleet(router, prompts, n_new, on_token)
        c1 = _fleet_counters()
        moved = {k: _delta(c1, c0, f"fleet_{k}_total") for k in (
            "requests_completed", "requests_rerouted", "failovers",
            "requests_failed", "dup_tokens_suppressed")}
        same = [g == w for g, w in zip(got, want)]
        print(f"[{tag}] router over w0, w1; w0 SIGKILLed after "
              f"{2 * len(prompts)} tokens (alive after: "
              f"{reps['w0'].alive()}): tokens == in-process "
              f"{sum(same)}/{len(same)}; errors {errors}; fleet counters "
              f"{json.dumps(moved)}", flush=True)
        router.stop()
        if errors or not all(same) or not killed or reps["w0"].alive() or \
                moved["requests_failed"] or moved["dup_tokens_suppressed"] \
                or moved["requests_rerouted"] <= 0:
            raise AssertionError(f"[{tag}] the SIGKILL drill failed")
        return {"startup_s": started, "sidecar_bytes": len(payload)}
    finally:
        for r in reps.values():
            r.shutdown()
        shutil.rmtree(root, ignore_errors=True)


# ----------------------------------------------------------------------
# slice 16: tensor parallelism
# ----------------------------------------------------------------------

# a float32 collective against the host's float64 result over the same
# stacked values (rank-order sums of <= 4 values: a few float32 roundings)
COLL_RTOL = 1e-6
# [agree:mesh] and [serve:mesh]: where the mesh's tokens leave the single
# engine's, both candidates (or the delivered token and the argmax) within
# this many bf16 ulps under the single-device dense forward (the shards'
# bf16 partial products are summed after their own rounding, not inside
# one GEMM's accumulation)
MESH_TIE_ULPS = {None: 16.0, "int8": 38.0}
# the narrow models of [agree:mesh]: 4 heads of 64 (2 KV heads for the
# Llama, so tp 4 replicates its pools), 2 layers, bf16
MESH_NARROW = dict(vocab=512, hidden=256, layers=2, heads=4, ffn=512,
                   seq=256)
MESH_KW = dict(max_slots=4, page_size=16, max_seq_len=256, prefill_chunk=32,
               mixed_step=True, prefix_cache=True)
MESH_CASES = (("tp2", 2, 1), ("tp4", 4, 1), ("tp2fsdp2", 2, 2))


def phase_collectives(dev):
    """[collectives]: every collective of ``distributed`` on co-located 2-
    and 4-rank worlds on `dev`, each against the stacked result the host
    computes from the same values: integers exact, float32 within
    COLL_RTOL of the float64 result."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import parallel_base as PB
    from paddle_tpu_torch.distributed.communication import stream

    rng = np.random.default_rng(16)
    worst = {}

    def held(name, got, want, exact=False):
        got = got.detach().cpu().numpy() if torch.is_tensor(got) \
            else np.asarray(got)
        want = np.broadcast_to(np.asarray(want), got.shape)
        if exact:
            err = 0.0 if np.array_equal(got, want) else float("inf")
        else:
            err = float(np.max(np.abs(got - want) /
                               np.maximum(np.abs(want), 1e-30)))
        worst[name] = max(worst.get(name, 0.0), err)
        if err > (0.0 if exact else COLL_RTOL):
            raise AssertionError(f"[collectives] {name}: relative error "
                                 f"{err} (allowed {COLL_RTOL})")

    def on(a):
        return torch.tensor(a, device=dev)      # a copy of the host values

    try:
        for n in (2, 4):
            dist.destroy_process_group()
            dist.init_parallel_env(devices=[dev] * n)
            x = rng.uniform(0.5, 1.5, (n, 64, 257)).astype(np.float32)
            x64 = x.astype(np.float64)
            xi = rng.integers(-1000, 1000, (n, 4099)).astype(np.int32)
            ref = {"sum": x64.sum(0), "max": x64.max(0), "min": x64.min(0),
                   "avg": x64.mean(0), "prod": x64.prod(0)}
            for op, want in ref.items():
                t = on(x)
                dist.all_reduce(t, op=op)
                held(f"all_reduce.{op}", t, want)
                parts = [on(x[i]) for i in range(n)]
                dist.all_reduce(parts, op=op)
                for p_ in parts:
                    held(f"all_reduce.{op}.ranks", p_, want)
            for op, fn in (("sum", np.sum), ("max", np.max),
                           ("min", np.min)):
                t = on(xi)
                dist.all_reduce(t, op=op)
                held(f"all_reduce.{op}.int32", t, fn(xi, 0), exact=True)
            t = on(x[0])
            dist.all_reduce(t)                      # replicated: n * x
            held("all_reduce.replicated", t, x64[0] * n)
            t = on(x)
            stream.all_reduce(t)
            held("stream.all_reduce", t, ref["sum"])
            t = on(x)
            dist.reduce(t, dst=0)
            held("reduce", t, ref["sum"])
            got = dist.all_gather([], on(x))
            for i in range(n):
                held("all_gather", got[i], x[i], exact=True)
            got = dist.gather(on(xi), [])
            for i in range(n):
                held("gather", got[i], xi[i], exact=True)
            t = on(xi)
            dist.broadcast(t, src=1)
            held("broadcast", t, xi[1], exact=True)
            t = on(np.zeros_like(x[0]))
            dist.scatter(t, [on(x[i]) for i in range(n)])
            held("scatter", t, x[0], exact=True)
            t = on(np.zeros_like(x[0]))
            dist.reduce_scatter(t, [on(x[i]) for i in range(n)])
            held("reduce_scatter", t, ref["sum"])
            out = []
            dist.alltoall(out, [on(xi[i]) for i in range(n)])
            for i in range(n):
                held("alltoall", out[i], xi[i], exact=True)
            t = on(np.zeros_like(xi))
            dist.alltoall_single(t, on(xi))
            held("alltoall_single", t, xi, exact=True)
            dist.send(on(xi[1]), dst=0, tag=n)
            t = on(np.zeros_like(xi[1]))
            dist.recv(t, src=1, tag=n)
            held("send_recv", t, xi[1], exact=True)
            dist.isend(on(xi[0]), dst=0, tag=n + 10)
            t = on(np.zeros_like(xi[0]))
            dist.irecv(t, src=1, tag=n + 10).wait()
            held("isend_irecv", t, xi[0], exact=True)
            dist.barrier()
            objs = []
            dist.all_gather_object(objs, {"n": n})
            lst = [{"n": n}, "x"]
            dist.broadcast_object_list(lst, src=0)
            if objs != [{"n": n}] * n or lst != [{"n": n}, "x"]:
                raise AssertionError("[collectives] object collectives")
            parts = [on(x[i]) for i in range(n)]
            with PB.record_collectives() as found:
                PB.program_all_reduce(parts)
                full = PB.program_all_gather([on(x[i]) for i in range(n)],
                                             -1)[0]
            held("program_all_reduce", parts[-1], ref["sum"])
            held("program_all_gather", full,
                 np.concatenate(list(x), -1), exact=True)
            if found["all-reduce"] != {"count": 1, "bytes": x[0].nbytes,
                                       "max_group": n}:
                raise AssertionError(f"[collectives] harvest record {found}")
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            print(f"[collectives] {n} ranks co-located on {dev}: all held "
                  f"(all_reduce sum/max/min/avg/prod float32 [{n}, 64, 257] "
                  f"stacked and per-rank, int32 sum/max/min exact, "
                  f"replicated, stream, reduce, all_gather, gather, "
                  f"broadcast, scatter, reduce_scatter, alltoall, "
                  f"alltoall_single, send/recv, isend/irecv, barrier, "
                  f"object collectives, the program all-reduce and "
                  f"all-gather with their harvest record)", flush=True)
    finally:
        dist.destroy_process_group()
    print(f"[collectives] worst relative error by collective (float32 "
          f"allowed {COLL_RTOL:g}; int32 exact) "
          f"{json.dumps({k: float(f'{v:.3g}') for k, v in worst.items()})}",
          flush=True)


def _narrow_models(dev):
    """The narrow Llama and GPT of [agree:mesh] in bf16, random weights
    from seed 0."""
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         LlamaConfig, LlamaForCausalLM)
    llama = LlamaForCausalLM(LlamaConfig.tiny(kv_heads=2, **MESH_NARROW),
                             device=dev, dtype=torch.bfloat16)
    weights.init_random_(llama, seed=0)
    gpt = GPTForCausalLM(GPTConfig.tiny(**MESH_NARROW), device=dev,
                         dtype=torch.bfloat16)
    weights.init_random_(gpt, seed=0)
    return {"llama": llama, "gpt": gpt}


def _teacher_forced_diff(eng, model, prompts, want):
    """The largest |logit| difference between the mesh's sharded dense
    forward and the model's own over each prompt + the single engine's
    tokens."""
    worst = 0.0
    with torch.inference_mode():
        for p, w in zip(prompts, want):
            ids = torch.as_tensor(np.concatenate([p, w])[None],
                                  dtype=torch.long, device=model.device)
            d = (eng._fwd(ids).float() - model(ids).float()).abs().max()
            worst = max(worst, float(d))
    return worst


def phase_agree_mesh(dev):
    """[agree:mesh]: the narrow Llama and GPT in bf16 through the mesh
    engine (tp2, tp4 (the Llama's 2 KV heads: replicated pools),
    tp2 x fsdp2; float and int8 pools, CUDA graphs) against the
    single-device engine on the card, two waves each: greedy tokens equal
    wherever the single engine's choice is no near-tie (MESH_TIE_ULPS),
    the largest teacher-forced logit difference printed, programs built
    per kind equal to the single engine's, and at tp2 an export framed as
    2 shard streams that a single-device importer refuses (then serving
    the prompt by re-prefill, with a fresh engine's tokens)."""
    from paddle_tpu_torch.inference import GenerationEngine
    from paddle_tpu_torch.serving import MeshGenerationEngine

    models = _narrow_models(dev)
    rng = np.random.default_rng(161)
    prompts = _serving_prompts(rng, 6, 8, 120, MESH_NARROW["vocab"], 40,
                               (1, 4))
    n_new = 16
    for name, model in models.items():
        for kv in (None, "int8"):
            single = GenerationEngine(model, kv_dtype=kv, **MESH_KW)
            _wave(single, prompts, n_new)
            want = [np.asarray(o[len(p):]) for o, p in
                    zip(_wave(single, prompts, n_new), prompts)]
            for case, tp, fsdp in MESH_CASES:
                tag = f"agree:mesh:{name}{':int8' if kv else ''}:{case}"
                eng = MeshGenerationEngine(model, mesh_devices=tp,
                                           fsdp_devices=fsdp, kv_dtype=kv,
                                           **MESH_KW)
                _wave(eng, prompts, n_new)
                got = [np.asarray(o[len(p):]) for o, p in
                       zip(_wave(eng, prompts, n_new), prompts)]
                same = _trace_counts(eng) == _trace_counts(single)
                div = _first_divergences(tag, model, prompts, got, want, kv,
                                         "the single engine",
                                         MESH_TIE_ULPS)
                diff = _teacher_forced_diff(eng, model, prompts, want)
                print(f"[{tag}] kv_shards={eng.kv_shards} "
                      f"mesh_devices={eng.mesh_devices}: tokens == the "
                      f"single engine's on {len(prompts) - len(div)}/"
                      f"{len(prompts)} requests; teacher-forced max |logit "
                      f"diff| {diff:.4g}; programs built per kind == the "
                      f"single engine's: {same} "
                      f"{json.dumps(_trace_counts(eng))}; graphs "
                      f"{json.dumps(_captures(eng))}", flush=True)
                if not same:
                    raise AssertionError(f"[{tag}] programs built differ: "
                                         f"{_trace_counts(eng)} vs "
                                         f"{_trace_counts(single)}")
                if case == "tp2":
                    _agree_mesh_export(tag, eng, model, prompts[1], kv)
                del eng
            del single
            gc.collect()
    del models
    _release()


def _agree_mesh_export(tag, eng, model, prompt, kv):
    """A tp2 export carries the shards block; a single-device importer
    refuses it (an engine_kv_import_skipped event, reason kv_shards) and
    serves the prompt by re-prefill with a fresh engine's tokens."""
    from paddle_tpu_torch.inference import GenerationEngine
    from paddle_tpu_torch.observability.events import EVENTS

    meta, payload = eng.export_kv_pages(prompt)
    if (meta.get("shards") or {}).get("count") != 2:
        raise AssertionError(f"[{tag}] the export carries no 2-shard block")
    importer = GenerationEngine(model, kv_dtype=kv, **MESH_KW)
    n0 = len(EVENTS.events("engine_kv_import_skipped"))
    took = importer.import_kv_pages(meta, payload)
    skips = EVENTS.events("engine_kv_import_skipped")[n0:]
    fresh = GenerationEngine(model, kv_dtype=kv, **MESH_KW)
    a = _wave(importer, [prompt], 8)[0]
    b = _wave(fresh, [prompt], 8)[0]
    print(f"[{tag}] export: {meta['n_pages']} pages in "
          f"{len(meta['shards']['streams'])} shard streams, {len(payload)} "
          f"bytes; a single-device importer took {took} pages "
          f"({[e.get('reason') for e in skips]}) and re-prefilled: tokens "
          f"== a fresh engine's {np.array_equal(a, b)}", flush=True)
    if took != 0 or not skips or skips[-1].get("reason") != "kv_shards" \
            or not np.array_equal(a, b):
        raise AssertionError(f"[{tag}] the shard refusal failed")


# [serve:mesh] runs the first MESH_SERVE_LAYERS of the serving model's
# layers (cut to keep the smoke under 760 s with the compiler's phases,
# then to the serving model's 4; every per-layer fact is held as at 32)
MESH_SERVE_LAYERS = 4


def _first_layers(model, n):
    """A Llama that shares `model`'s embedding, norm, head and first n
    decoder layers (no weight is copied)."""
    import copy
    import dataclasses

    llama = copy.copy(model.llama)
    llama._modules = dict(model.llama._modules)
    llama.layers = torch.nn.ModuleList(list(model.llama.layers)[:n])
    llama.config = dataclasses.replace(model.config, num_hidden_layers=n)
    small = copy.copy(model)
    small._modules = dict(model._modules)
    small._modules["llama"] = llama
    small.config = llama.config
    small.__dict__.pop("_engines", None)
    return small


def phase_serve_mesh(K, model, want, serve_st):
    """[serve:mesh]: [serve]'s workload (8 prompts of 300-900 tokens,
    max_slots 4, pages of 16, chunks of 256, mixed steps, bf16 pools,
    CUDA graphs) through the mesh engine at tp=2 co-located on the card
    (16 heads and 16 KV heads a shard, FFN 5504 a shard) over the 7B
    model's first MESH_SERVE_LAYERS layers: a cold wave captures the
    programs, a warm wave (it must build none) gives the numbers, printed
    beside [serve]'s (SERVE_LAYERS layers) from this call, then engine
    steps PROFILE_STEPS run under the profiler. Every kernel of the path must launch, decode
    attention twice a layer a decode step (2 shards) and RoPE once a
    layer a shard a model step; every delivered token must be the
    single-device dense forward's argmax (of the same layers) or within
    MESH_TIE_ULPS of it (teacher-forced greedy agreement; `want`,
    [serve]'s tokens, are of the whole model and are not compared).
    Returns the warm wave's launches and the engine (for [sharding])."""
    from paddle_tpu_torch.observability import sharding, xla_introspect
    from paddle_tpu_torch.serving import MeshGenerationEngine

    tag = "serve:mesh"
    _fresh_pools(model)
    model = _first_layers(model, MESH_SERVE_LAYERS)
    cfg = model.config
    _fresh_pools(model)
    xla_introspect.reset()
    sharding.reset()
    rng = np.random.default_rng(0)
    prompts = _serving_prompts(rng, 8, 300, 900, cfg.vocab_size, 512, (0, 5))
    kw = dict(max_slots=4, page_size=16, prefill_chunk=256, mixed_step=True,
              prefix_cache=True)
    n_new = 32
    eng = MeshGenerationEngine(model, mesh_devices=2, **kw)
    _, cold, cold_wall, _, _ = _serve_wave(eng, prompts, n_new)
    marks = _trace_counts(eng)
    gen, st, wall, launches, ttft = _serve_wave(eng, prompts, n_new)
    frozen = _trace_counts(eng) == marks
    peak = torch.cuda.max_memory_allocated() / 1e9
    layers, tp = cfg.num_hidden_layers, eng._tp
    shard_bytes = eng._pool_bytes_by_position()
    print(f"[{tag}] tp=2 co-located on {model.device}, the 7B model's "
          f"first {cfg.num_hidden_layers} layers: kv_shards="
          f"{eng.kv_shards} mesh_devices={eng.mesh_devices}; "
          f"engine_kv_pool_shard_bytes by mesh position "
          f"{json.dumps(shard_bytes)} (the single engine's pool "
          f"{serve_st['kv_pool_bytes']}); CUDA graphs: cold wave wall_s="
          f"{cold_wall:.3f}, programs built {json.dumps(_trace_counts(eng))}"
          f", graphs captured {json.dumps(_captures(eng))}; warm wave "
          f"builds none: {frozen}")
    tps = st["decode_tokens"] / max(st["decode_s"], 1e-9)
    s_tps = serve_st["decode_tokens"] / max(serve_st["decode_s"], 1e-9)
    print(f"[{tag}] requests={len(prompts)} new_tokens="
          f"{sum(map(len, gen))} wall_s={wall:.3f} peak_mem_gb={peak:.2f} "
          f"decode tokens_per_s={tps:.2f} ttft_s p50="
          f"{ttft[len(ttft) // 2]:.4f} max={ttft[-1]:.4f} (warm wave, "
          f"graphs); [serve] in this call: decode tokens_per_s="
          f"{s_tps:.2f} ttft_s p50={serve_st['ttft_p50']:.4f} max="
          f"{serve_st['ttft_max']:.4f} peak_mem_gb="
          f"{serve_st['peak_mem_gb']:.2f}", flush=True)
    print(f"[{tag}] launches {json.dumps(launches)}", flush=True)
    dec = launches["paged_decode_attention"]
    per_step = dec / max(st["decode_steps"], 1)
    print(f"[{tag}] decode attention: {dec} calls over "
          f"{st['decode_steps']} decode steps = {per_step:g} per decode "
          f"step ({layers} layers x {tp} shards, {cfg.num_attention_heads
          // tp} query and "
          f"{model.paged_spec()['n_kv_heads'] // tp} KV heads a shard)",
          flush=True)
    if dec != st["decode_steps"] * layers * tp:
        raise AssertionError(f"[{tag}] decode attention {dec} calls for "
                             f"{st['decode_steps']} decode steps")
    steps = sum(launches[n] for n in STEP_KERNELS) // (layers * tp)
    if launches["fused_rope"] != layers * tp * steps:
        raise AssertionError(f"[{tag}] RoPE launches "
                             f"{launches['fused_rope']}, expected "
                             f"{layers * tp} a model step x {steps}")
    summ = sharding.collective_summary()
    for label in sorted(n for n in summ if n.startswith("engine:decode:")):
        k = int(label.split(":")[2])
        ar = summ[label]["ops"].get("all-reduce", {})
        print(f"[{tag}] {label}: {ar.get('count', 0) / k:g} all-reduces and "
              f"{ar.get('bytes', 0) / k:.0f} bytes a decode step (per "
              f"shard payload; harvest), comm fraction "
              f"{summ[label]['comm_fraction']}", flush=True)
        if ar.get("count") != 2 * layers * k:
            raise AssertionError(f"[{tag}] {label}: {ar} all-reduces")
    _require_launched(tag, launches, _path_kernels(model, None, False))
    _require_sm90_ragged(tag, launches)
    if not frozen:
        raise AssertionError(f"[{tag}] the warm wave built programs")
    _fleet_ties(tag, model, prompts, gen, gen, None, MESH_TIE_ULPS)
    _profile_serve(eng, prompts, n_new, f"profile:{tag}")
    return launches, eng


def phase_sharding(eng, dev):
    """[sharding]: the harvest of [serve:mesh]'s programs and the partition
    audit of its canonical tp2 engine, which must be green; then the
    narrow Llama at tp2 with q_proj.weight overridden to replicated,
    whose audit must be red and name the parameter."""
    from paddle_tpu_torch.observability import sharding, xla_introspect
    from paddle_tpu_torch.serving import MeshGenerationEngine

    xla_introspect.harvest()
    summ = sharding.collective_summary()
    for label, e in sorted(summ.items()):
        print(f"[sharding] {label}: {json.dumps(e['ops'])} comm_fraction="
              f"{e['comm_fraction']} flops={e['flops']}", flush=True)
    audit = sharding.partition_audit(eng)
    print(f"[sharding] partition audit of [serve:mesh]'s engine: ok="
          f"{audit['ok']} checked={audit['checked']} sharded="
          f"{audit['sharded']} replicated={audit['replicated']} "
          f"col_parallel_ok={audit['col_parallel_ok']} row_parallel_ok="
          f"{audit['row_parallel_ok']} hlo_params={audit['hlo_params']}",
          flush=True)
    if not audit["ok"] or not audit["col_parallel_ok"] \
            or not audit["row_parallel_ok"] or not summ:
        raise AssertionError("[sharding] the canonical engine's audit is "
                             f"not green: {audit['violations'][:4]}")
    model = _narrow_models(dev)["llama"]
    bad = MeshGenerationEngine(model, mesh_devices=2,
                               param_spec_overrides={"q_proj.weight": None},
                               **MESH_KW)
    red = sharding.partition_audit(bad)
    names = [v["param"] for v in red["violations"]]
    print(f"[sharding] q_proj.weight overridden to replicated: ok="
          f"{red['ok']} violations {red['violations']}", flush=True)
    if red["ok"] or "llama.layers.0.self_attn.q_proj.weight" not in names:
        raise AssertionError("[sharding] the misspecified engine's audit "
                             "did not name q_proj.weight")
    del bad, model
    sharding.reset()
    _release()



# ----------------------------------------------------------------------
# slice 17: the graph compiler
# ----------------------------------------------------------------------

FUSE_PATTERNS = ("attention", "rms_norm", "swiglu", "rope")


def _fuse_floors(layers):
    """Rewrites the architecture gives a Llama of `layers` layers."""
    return {"attention": layers, "rms_norm": 2 * layers + 1,
            "swiglu": layers, "rope": 2 * layers}


# launches of each kernel in one fused training step of the plain-op
# Llama at TRAIN_CFG: flash, RMSNorm and SwiGLU as [train]'s; RoPE twice
# a layer each way (q and k are rewritten apart, where the port's Llama
# rotates both in one launch)
FUSE_PER_STEP = {"flash_attention": 12, "flash_attention_bwd": 12,
                 "flash_attention.sm90": 12, "flash_attention_bwd.sm90": 12,
                 "rms_norm": 25, "swiglu": 12, "fused_rope": 24,
                 "fused_rope.qk": 0, "fused_rope_bwd": 24,
                 "fused_rope.scalar": 0, "fused_rope_bwd.scalar": 0}
# [train:fuse]'s loss tolerances (bf16, AdamW(1e-4)): the fused and the
# eager plain-op steps round at other places (the kernels compute in
# float32 and round once), so the first losses agree within
# FUSE_FIRST_RTOL and AdamW's ~lr sign(g) first steps amplify the
# near-zero gradients' signs: later losses within FUSE_LOSS_ATOL or
# FUSE_LOSS_RTOL (the [agree:train2] rule); the fused remat step recomputes
# the same products: within FUSE_REMAT_ULPS bf16 ulps of the fused step's
FUSE_FIRST_RTOL = 1e-2
FUSE_LOSS_ATOL, FUSE_LOSS_RTOL = 0.0625, 0.05
FUSE_REMAT_ULPS = 2


def _compiler_counts():
    """{counter: value} of the compiler's counters (by pattern)."""
    from paddle_tpu_torch.observability.metrics import REGISTRY

    def c(name, pattern=None):
        m = REGISTRY.get(name, {"pattern": pattern} if pattern else None)
        return m.value if m is not None else 0
    out = {"programs": c("compiler_programs_total"),
           "breaks": c("compiler_graph_breaks_total")}
    for p in FUSE_PATTERNS:
        out[f"rewrites.{p}"] = c("compiler_rewrites_total", p)
        out[f"fallbacks.{p}"] = c("compiler_fallbacks_total", p)
    return out


def _compiler_delta(before):
    after = _compiler_counts()
    d = {k: after[k] - before[k] for k in after}
    return ({p: d[f"rewrites.{p}"] for p in FUSE_PATTERNS},
            sum(d[f"fallbacks.{p}"] for p in FUSE_PATTERNS),
            d["programs"], d["breaks"])


def _ptt_nodes(gm):
    """{op name: nodes} of the kernels' custom ops in a captured graph."""
    out = {}
    for n in gm.graph.nodes:
        t = n.target
        if isinstance(t, torch._ops.OpOverload) and t.namespace == "ptt":
            name = t.name().split("::")[1]
            out[name] = out.get(name, 0) + 1
    return out


def _plain_llama(cfg, dev, dtype):
    """fusion_audit_torch.PlainLlama with the port Llama's seed-0 weights
    (weights.init_random_ on the port Llama, then loaded by name)."""
    import fusion_audit_torch as fa
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.models import LlamaForCausalLM

    ref = weights.init_random_(LlamaForCausalLM(cfg, device=dev,
                                                dtype=dtype), seed=0)
    plain = fa.PlainLlama(cfg, device=dev, dtype=dtype)
    plain.load_state_dict(ref.state_dict())
    del ref
    return plain


def phase_dispatch(K, dev):
    """[dispatch]: the host cost of a kernel called through its custom op
    (``K.RMSNorm.apply``, the route every model takes) beside the bare
    ctypes wrapper (``K.rms_norm``), at the decode shape [4, 4096] bf16,
    under inference_mode and with grad, N calls each, host clock over
    the enqueue (the kernel is ~6 us, so the host sets the pace)."""
    n = 2000
    x = torch.randn(4, 4096, device=dev, dtype=torch.bfloat16)
    w = torch.randn(4096, device=dev, dtype=torch.bfloat16)
    out = {}
    for label, call in (("wrapper", lambda: K.rms_norm(x, w, 1e-6)),
                        ("op", lambda: K.RMSNorm.apply(x, w, 1e-6))):
        for mode in ("inference", "grad"):
            ctx = torch.inference_mode() if mode == "inference" \
                else torch.enable_grad()
            with ctx:
                for _ in range(50):
                    call()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    call()
                torch.cuda.synchronize()
            out[f"{label}.{mode}"] = (time.perf_counter() - t0) / n * 1e6
    print(f"[dispatch] host us per call at [4, 4096] bf16 RMSNorm "
          f"({n} calls): {json.dumps({k: round(v, 2) for k, v in out.items()})}"
          f"; the op's dispatch adds {out['op.inference'] - out['wrapper.inference']:.2f}"
          f" us (inference_mode) and "
          f"{out['op.grad'] - out['wrapper.grad']:.2f} us (grad) a call",
          flush=True)
    return out


def phase_agree_fuse(dev):
    """[agree:fuse]: (a) the plain-op tiny Llama (fusion_audit_torch
    .PlainLlama, float32, 2 layers) through compile_train_step(fuse=True)
    on the CPU (the kernels' plain versions) and on the card (the
    kernels): the architecture's rewrites on both, 3 losses within
    1e-4 (relative) of each other, every kernel of the path launched on
    the card; (b) the port's own tiny Llama under fuse=True on the card:
    its capture holds its kernels as nodes, 0 rewrites, the kernels'
    launches a step equal to the eager step's, its losses equal to its
    eager losses (relative 1e-6: the replay runs the same ops)."""
    import fusion_audit_torch as fa
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.jit import compile_train_step
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.optimizer import AdamW

    tag = "agree:fuse"
    cfg = LlamaConfig.tiny(vocab=64, hidden=32, layers=2, heads=4,
                           kv_heads=2, ffn=64, seq=32)
    base = weights.init_random_(fa.PlainLlama(cfg), 0).state_dict()
    rng = np.random.default_rng(5)
    ids, lab = (torch.from_numpy(rng.integers(0, 64, (2, 16)))
                for _ in range(2))
    loss_fn = lambda m, i, l: m(i, labels=l)  # noqa: E731
    losses, launches = {}, {}
    for where in ("cpu", dev):
        m = fa.PlainLlama(cfg, device=where)
        m.load_state_dict(base)
        m.train()
        step = compile_train_step(m, loss_fn, AdamW(1e-3, parameters=list(
            m.parameters())), fuse=True)
        before = _compiler_counts()
        K.reset_launch_counts()
        losses[str(where)] = [float(step(ids.to(where), lab.to(where)))
                              for _ in range(3)]
        launches[str(where)] = K.launch_counts()
        rw, fb, progs, breaks = _compiler_delta(before)
        if rw != _fuse_floors(2) or fb or progs != 1 or breaks:
            raise AssertionError(f"[{tag}] {where}: rewrites {rw}, "
                                 f"fallbacks {fb}, programs {progs}, "
                                 f"breaks {breaks}")
    a, b = losses["cpu"], losses[str(dev)]
    rel = max(abs(x - y) / abs(x) for x, y in zip(a, b))
    card = launches[str(dev)]
    print(f"[{tag}] plain-op tiny Llama, fuse=True, 3 steps: losses CPU "
          f"{a} card {b} (max rel diff {rel:.2e} <= 1e-4); rewrites "
          f"{json.dumps(_fuse_floors(2))} on both; card launches "
          f"{json.dumps({k: card[k] for k in FUSE_PER_STEP})}", flush=True)
    if rel > 1e-4:
        raise AssertionError(f"[{tag}] the card's fused losses leave the "
                             f"CPU's: {rel:.3e}")
    _require_launched(tag, card, ("flash_attention", "flash_attention_bwd",
                                  "rms_norm", "swiglu", "fused_rope",
                                  "fused_rope_bwd"))
    # (b) the port's Llama: kernels already nodes, nothing to rewrite
    base = weights.init_random_(LlamaForCausalLM(cfg, device="cpu"),
                                1).state_dict()
    ids, lab = ids.to(dev), lab.to(dev)
    runs = {}
    for fuse in (False, True):
        m = LlamaForCausalLM(cfg, device=dev)
        m.load_state_dict(base)
        m.train()
        step = compile_train_step(m, loss_fn, AdamW(1e-3, parameters=list(
            m.parameters())), fuse=fuse)
        before = _compiler_counts()
        got, per = [], []
        for _ in range(3):
            K.reset_launch_counts()
            got.append(float(step(ids, lab)))
            per.append(K.launch_counts())
        rw, fb, progs, breaks = _compiler_delta(before)
        nodes = _ptt_nodes(step.programs.values()[0]) if fuse else None
        runs[fuse] = (got, per, rw, nodes)
    (e_loss, e_per, _, _), (f_loss, f_per, f_rw, nodes) = runs[False], \
        runs[True]
    rel = max(abs(x - y) / abs(x) for x, y in zip(e_loss, f_loss))
    print(f"[{tag}] port Llama (tiny, float32), fuse=True: capture nodes "
          f"{json.dumps(nodes)}, rewrites {json.dumps(f_rw)}, launches a "
          f"step == eager's: {f_per == e_per}; losses eager {e_loss} fused "
          f"{f_loss} (max rel diff {rel:.2e} <= 1e-6)", flush=True)
    want_nodes = {"flash_attention_fwd": 2, "rms_norm": 5, "swiglu": 2,
                  "fused_rope_qk": 2, "fused_linear_cross_entropy": 1}
    if nodes != want_nodes or any(f_rw.values()) or f_per != e_per or \
            rel > 1e-6:
        raise AssertionError(f"[{tag}] the port Llama's fused program "
                             f"differs from its eager step")


def phase_train_fuse(K, dev, base):
    """[train:fuse]: fusion_audit_torch.PlainLlama (the port Llama written
    from plain torch ops) at [train]'s full configuration (TRAIN_CFG, 4 x
    2048, bf16, AdamW(1e-4, multi_precision=True)) with [train]'s seed-0
    weights and batch, three ways, each one warm-up and TRAIN_STEPS timed
    steps: the eager unfused step (no kernel launches), compile_train_step
    (fuse=True) and fuse=True with remat_policy="fused". Held: rewrites
    by pattern equal to the architecture's with 0 fallbacks and 1 program
    built per fused step; each kernel's launches a step (FUSE_PER_STEP:
    flash, RMSNorm and SwiGLU as [train]'s); the loss curves against each
    other within the FUSE_* tolerances. Printed: median ms per step and
    peak memory of each beside [train]'s from this call. Returns the
    fused runs' summed launches."""
    from paddle_tpu_torch.jit import compile_train_step
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.optimizer import AdamW

    _release()
    cfg = LlamaConfig(**TRAIN_CFG)
    plain = _plain_llama(cfg, dev, torch.bfloat16)
    plain.train()
    init = {k: v.detach().clone() for k, v in plain.state_dict().items()}
    ids, lab = _train_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, dev)
    floors = _fuse_floors(cfg.num_hidden_layers)
    unfused = {k: 0 for k in FUSE_PER_STEP}
    res, totals = {}, {k: 0 for k in K.launch_counts()}
    for tag, kw, per_step in (
            ("train:fuse:eager", {"fuse": False}, unfused),
            ("train:fuse", {"fuse": True}, FUSE_PER_STEP),
            ("train:fuse:remat", {"fuse": True, "remat_policy": "fused"},
             FUSE_PER_STEP)):
        with torch.no_grad():
            for k, v in plain.state_dict().items():
                v.copy_(init[k])
        _release()
        opt = AdamW(1e-4, parameters=plain.parameters(),
                    multi_precision=True)
        step = compile_train_step(plain, lambda m, i, l: m(i, labels=l),
                                  opt, **kw)
        before = _compiler_counts()
        losses, ms, launched = _run_steps(tag, K, step, (ids, lab),
                                          per_step, TRAIN_STEPS)
        rw, fb, progs, breaks = _compiler_delta(before)
        peak = torch.cuda.max_memory_allocated() / 1e9
        med = float(np.median(ms[1:]))
        res[tag] = {"losses": losses, "ms": med, "peak": peak}
        print(f"[{tag}] {json.dumps(kw)}: losses (warm-up first) {losses}; "
              f"step_ms {[round(x, 2) for x in ms]} median_timed={med:.2f} "
              f"peak_mem_gb={peak:.2f}; [train] in this call: "
              f"mean_timed={base['step_ms']:.2f} peak_mem_gb="
              f"{base['peak_gb']:.2f}; rewrites {json.dumps(rw)} "
              f"fallbacks={fb} programs_built={progs} graph_breaks="
              f"{breaks}", flush=True)
        if kw["fuse"]:
            if rw != floors or fb or progs != 1 or breaks:
                raise AssertionError(
                    f"[{tag}] rewrites {rw} (want {floors}), fallbacks "
                    f"{fb}, programs {progs}, breaks {breaks}")
            for k in totals:
                totals[k] += launched[k]
            print(f"[{tag}] launches a step {json.dumps(per_step)} (held "
                  f"every step); [train]'s {json.dumps(TRAIN_PER_STEP)}",
                  flush=True)
        del step, opt
    eager, fused, remat = (res[t]["losses"] for t in (
        "train:fuse:eager", "train:fuse", "train:fuse:remat"))
    first = abs(fused[0] - eager[0]) / abs(eager[0])
    worst = max(abs(a - b) - max(FUSE_LOSS_ATOL, FUSE_LOSS_RTOL * abs(b))
                for a, b in zip(fused, eager))
    ulps = max(abs(a - b) / _bf16_ulp(b) for a, b in zip(remat, fused))
    print(f"[train:fuse] losses: eager {eager}, fused {fused}, fused remat "
          f"{remat}; fused vs eager first step rel {first:.2e} (<= "
          f"{FUSE_FIRST_RTOL}), every step within max({FUSE_LOSS_ATOL}, "
          f"{FUSE_LOSS_RTOL}|eager|): {worst <= 0}; fused remat vs fused "
          f"{ulps:.2f} bf16 ulps (<= {FUSE_REMAT_ULPS}); median ms eager "
          f"{res['train:fuse:eager']['ms']:.2f} fused "
          f"{res['train:fuse']['ms']:.2f} remat "
          f"{res['train:fuse:remat']['ms']:.2f} ([train] "
          f"{base['step_ms']:.2f}); peak GB eager "
          f"{res['train:fuse:eager']['peak']:.2f} fused "
          f"{res['train:fuse']['peak']:.2f} remat "
          f"{res['train:fuse:remat']['peak']:.2f} ([train] "
          f"{base['peak_gb']:.2f})", flush=True)
    if first > FUSE_FIRST_RTOL or worst > 0 or ulps > FUSE_REMAT_ULPS:
        raise AssertionError("[train:fuse] the loss curves disagree")
    del plain, init
    _release()
    return totals


# [to_static]'s rule on bf16 logits: held against the float32 forward of
# the same weights, the fused forward (kernels: float32 inside, one
# rounding) must be no further off than STATIC_FACTOR times the eager
# plain-op bf16 forward (bf16 at every op), in the largest and in the
# mean |difference|; the fused and eager bf16 logits differ from each
# other by 2-3% of their scale after 12 layers (on an H100, 700 W), held
# directly within STATIC_DIRECT of the eager logits' scale
STATIC_FACTOR = 1.5
STATIC_DIRECT = 5e-2


def _logit_err(got, want):
    """(max |diff| / max |want|, mean |diff| / mean |want|)."""
    d = (got.float() - want).abs()
    return (float(d.max()) / float(want.abs().max()),
            float(d.mean()) / float(want.abs().mean()))


def phase_to_static(K, dev):
    """[to_static]: to_static(fuse=True) on PlainLlama's forward at
    TRAIN_CFG (bf16, seed-0 weights, [train]'s batch of 4 x 2048 ids):
    two calls, one capture; the fused forward's kernel launches (flash 12,
    RMSNorm 25, SwiGLU 12, RoPE 24); its logits and the eager plain-op
    forward's against the float32 forward's (STATIC_FACTOR), and the two
    against each other (STATIC_DIRECT); ms of the eager and the fused
    forward."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.compiler import BuildStrategy
    from paddle_tpu_torch.models import LlamaConfig

    tag = "to_static"
    _release()
    cfg = LlamaConfig(**TRAIN_CFG)
    plain = _plain_llama(cfg, dev, torch.bfloat16).eval()
    ids, _ = _train_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, dev)
    st = jit.to_static(plain.forward,
                       build_strategy=BuildStrategy(fuse=True))
    before = _compiler_counts()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain(ids)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3
        st(ids)                          # the capture
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = st(ids)
        torch.cuda.synchronize()
        fused_ms = (time.perf_counter() - t0) * 1e3
        launches = K.launch_counts()
        plain32 = _plain_llama(cfg, dev, torch.float32).eval()
        ref = plain32(ids)
        del plain32
    rw, fb, progs, breaks = _compiler_delta(before)
    e_max, e_mean = _logit_err(want, ref)
    f_max, f_mean = _logit_err(got, ref)
    d_max, d_mean = _logit_err(got, want.float())
    per = {k: launches[k] for k in ("flash_attention", "rms_norm", "swiglu",
                                     "fused_rope")}
    print(f"[{tag}] PlainLlama.forward at TRAIN_CFG, bf16, [4, 2048]: "
          f"captures {len(st.programs())}, programs built {progs}, "
          f"rewrites {json.dumps(rw)} fallbacks {fb}; launches a forward "
          f"{json.dumps(per)}; against the float32 forward (max|diff|/"
          f"max|ref|, mean|diff|/mean|ref|): fused {f_max:.3e}, "
          f"{f_mean:.3e}, eager bf16 {e_max:.3e}, {e_mean:.3e} (fused <= "
          f"{STATIC_FACTOR}x eager's); fused vs eager {d_max:.3e}, "
          f"{d_mean:.3e} (<= {STATIC_DIRECT}); ms eager {eager_ms:.2f} "
          f"fused (replay) "
          f"{fused_ms:.2f}", flush=True)
    floors = _fuse_floors(cfg.num_hidden_layers)
    if len(st.programs()) != 1 or progs != 1 or rw != floors or fb or \
            breaks or per != {"flash_attention": floors["attention"],
                              "rms_norm": floors["rms_norm"],
                              "swiglu": floors["swiglu"],
                              "fused_rope": floors["rope"]} or \
            f_max > STATIC_FACTOR * e_max or \
            f_mean > STATIC_FACTOR * e_mean or \
            max(d_max, d_mean) > STATIC_DIRECT:
        raise AssertionError(f"[{tag}] the fused forward differs")
    del st, plain, want, got, ref
    _release()
    return launches


# ----------------------------------------------------------------------
# slice 18: the op surface
# ----------------------------------------------------------------------

# [ops:layer]: one Llama-2-7B decoder layer (hidden 4096, 32 heads of 128,
# FFN 11008) in bf16 over OPS_BATCH x OPS_SEQ tokens, written from the op
# surface and held against LlamaDecoderLayer with the same weights
OPS_BATCH, OPS_SEQ = 4, 512
# the kernels each run (forward and backward) must launch, and how often
OPS_LAYER_LAUNCHES = {"rms_norm": 2, "fused_rope": 1, "fused_rope.qk": 1,
                      "swiglu": 1, "flash_attention": 1,
                      "flash_attention_bwd": 1, "fused_rope_bwd": 1}
# BERT-base's post-norm tail: bias + dropout + residual + LayerNorm
OPS_BDRLN_ROWS, OPS_BDRLN_H, OPS_BDRLN_P = 16384, 768, 0.1


def _surface_layer(ptt, F, p, x, cos, sin, cfg):
    """LlamaDecoderLayer's forward from surface calls only: p holds the
    layer's parameters by name (weights [in, out])."""
    b, s, h = x.shape
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    hd = h // nh
    a = ptt.fused_rms_norm(x, p["input_layernorm.weight"], cfg.rms_norm_eps)
    q = ptt.reshape(ptt.matmul(a, p["self_attn.q_proj.weight"]),
                    [b, s, nh, hd])
    k = ptt.reshape(ptt.matmul(a, p["self_attn.k_proj.weight"]),
                    [b, s, nkv, hd])
    v = ptt.reshape(ptt.matmul(a, p["self_attn.v_proj.weight"]),
                    [b, s, nkv, hd])
    q, k, _ = ptt.fused_rotary_position_embedding(q, k, None, sin=sin,
                                                  cos=cos)
    att = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    x = ptt.add(x, ptt.matmul(ptt.reshape(att, [b, s, h]),
                              p["self_attn.o_proj.weight"]))
    m = ptt.fused_rms_norm(x, p["post_attention_layernorm.weight"],
                           cfg.rms_norm_eps)
    gu = ptt.swiglu(ptt.matmul(m, p["mlp.gate_proj.weight"]),
                    ptt.matmul(m, p["mlp.up_proj.weight"]))
    return ptt.add(x, ptt.matmul(gu, p["mlp.down_proj.weight"]))


def _ulps(got, want):
    """Largest |got - want| in bf16 ulps of want."""
    got, want = got.detach().float(), want.detach().float()
    return float(((got - want).abs() / _ulp_bf16(want)).max())


def phase_ops_layer(K, dev):
    """[ops:layer]: the slice's path at full width. One Llama-2-7B decoder
    layer from the op surface (matmul, fused_rms_norm,
    fused_rotary_position_embedding, reshape, swiglu, add and
    nn.functional.scaled_dot_product_attention), forward and backward
    (paddle_tpu_torch.grad: the input's and every weight's gradient),
    against LlamaDecoderLayer with the same seed-0 weights on the card.
    Rule: output and gradients within one bf16 ulp of the layer's, element
    by element (the same kernels and products: bit-equal is expected).
    Both runs must launch OPS_LAYER_LAUNCHES; the operator stats of one
    surface forward are printed; ms of a forward + backward each (CUDA
    events, 5 after a warm-up)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.amp import debugging as dbg
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.models.llama import LlamaDecoderLayer, _rope_tables
    from paddle_tpu_torch.nn import functional as F

    tag = "ops:layer"
    _release()
    cfg = LlamaConfig.llama2_7b()
    h = cfg.hidden_size
    layer = weights.init_random_(LlamaDecoderLayer(
        cfg, device=dev, dtype=torch.bfloat16), 0)
    params = dict(layer.named_parameters())
    names = sorted(params)
    cos, sin = (t[:OPS_SEQ].to(dev) for t in _rope_tables(
        h // cfg.num_attention_heads, cfg.max_position_embeddings,
        cfg.rope_theta))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    x = torch.randn(OPS_BATCH, OPS_SEQ, h, generator=gen, device=dev,
                    dtype=torch.bfloat16).requires_grad_(True)
    g = torch.randn(OPS_BATCH, OPS_SEQ, h, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    inputs = [x] + [params[n] for n in names]

    def surface():
        out = _surface_layer(ptt, F, params, x, cos, sin, cfg)
        return out, ptt.grad(out, inputs, grad_outputs=g)

    def model():
        out = layer(x, cos, sin)
        return out, torch.autograd.grad(out, inputs, g)

    runs, ms = {}, {}
    for label, fn in (("surface", surface), ("layer", model)):
        K.reset_launch_counts()
        out, grads = fn()
        torch.cuda.synchronize()
        runs[label] = (out, grads, K.launch_counts())
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(5):
            fn()
        end.record()
        end.synchronize()
        ms[label] = start.elapsed_time(end) / 5
    (s_out, s_grads, s_l), (m_out, m_grads, m_l) = runs["surface"], \
        runs["layer"]
    err = {"out": _ulps(s_out, m_out), "x": _ulps(s_grads[0], m_grads[0])}
    err["weights"] = max(_ulps(a, b) for a, b in zip(s_grads[1:],
                                                      m_grads[1:]))
    bit_equal = torch.equal(s_out, m_out) and all(
        torch.equal(a, b) for a, b in zip(s_grads, m_grads))
    with torch.no_grad(), dbg.collect_operator_stats():
        _surface_layer(ptt, F, params, x, cos, sin, cfg)
        stats = dbg.get_operator_stats()
    per = {k: s_l[k] for k in OPS_LAYER_LAUNCHES}
    per_m = {k: m_l[k] for k in OPS_LAYER_LAUNCHES}
    print(f"[{tag}] Llama-2-7B decoder layer (hidden {h}, "
          f"{cfg.num_attention_heads} heads of "
          f"{h // cfg.num_attention_heads}, FFN {cfg.intermediate_size}) "
          f"bf16, [{OPS_BATCH}, {OPS_SEQ}], from the op surface against "
          f"LlamaDecoderLayer: forward + grad of x and {len(names)} weights;"
          f" bf16 ulps (max) {json.dumps({k: round(v, 3) for k, v in err.items()})}"
          f", bit-equal {bit_equal}; launches surface {json.dumps(per)}, "
          f"layer {json.dumps(per_m)}; ms fwd+bwd surface "
          f"{ms['surface']:.3f} layer {ms['layer']:.3f}", flush=True)
    print(f"[{tag}] operator stats of one surface forward "
          f"{json.dumps(dict(sorted(stats.items())))}", flush=True)
    if max(err.values()) > 1.0 or per != OPS_LAYER_LAUNCHES or \
            per_m != OPS_LAYER_LAUNCHES or s_l != m_l:
        raise AssertionError(f"[{tag}] the surface layer differs from "
                             "LlamaDecoderLayer")
    launches = {k: s_l[k] + m_l[k] for k in s_l}
    del layer, params, inputs, runs, s_out, s_grads, m_out, m_grads
    _release()
    return launches


# BERT-base's attention shape [B, S, H, D] for the fused inference ops
OPS_FDPA_SHAPE = (8, 512, 12, 64)


def phase_ops_sweep(K, dev):
    """[ops:sweep]: every op of the surface once on the card against the
    port on the CPU (``ops_sweep_torch.sweep``: small float64/float32/int
    cases; float64 1e-9, float32 1e-4 relative, the special functions and
    decompositions 1e-7, integers exact, the random ops by shape, dtype,
    device and seeded repeatability); the fused names' kernels must
    launch. Then fused_bias_dropout_residual_layer_norm at BERT-base's
    [16384, 768] bf16, p = 0.1, through the surface: one bdrln launch, held
    against the plain version with the same seed (check_bdrln's rule:
    one bf16 ulp plus 2^-16 of the terms). Then the fused inference
    attention ops at OPS_FDPA_SHAPE bf16: one tensor-core flash launch
    each, against SDPA."""
    import ops_sweep_torch as sw
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework.random import next_seed

    tag = "ops:sweep"
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = sw.sweep(dev)
    secs = time.perf_counter() - t0
    launches = K.launch_counts()
    fused = {k: launches[k] for k in ("rms_norm", "swiglu", "fused_rope",
                                      "bias_dropout_residual_ln",
                                      "paged_decode_attention")}
    print(f"[{tag}] ops run {out['ops']}, failed {len(out['failed'])}, "
          f"worst {out['worst'][0]} at {out['worst'][1]:.3g} of its "
          f"tolerance, {secs:.1f} s; the fused names' launches "
          f"{json.dumps(fused)}", flush=True)
    for name, why in sorted(out["failed"].items()):
        print(f"[{tag}] FAILED {name}: {why}", flush=True)
    if out["failed"]:
        raise AssertionError(f"[{tag}] {len(out['failed'])} ops failed")
    _require_launched(tag, launches, fused)
    rng = np.random.default_rng(18)
    x, r = (torch.from_numpy(rng.standard_normal(
        (OPS_BDRLN_ROWS, OPS_BDRLN_H), dtype=np.float32)).to(
            dev, torch.bfloat16) for _ in range(2))
    w, b, bias = (torch.from_numpy(rng.standard_normal(
        (OPS_BDRLN_H,), dtype=np.float32)).to(dev, torch.bfloat16)
        for _ in range(3))
    before = K.launch_counts()["bias_dropout_residual_ln"]
    ptt.seed(7)
    got = ptt.fused_bias_dropout_residual_layer_norm(
        x, r, bias, w, b, dropout_rate=OPS_BDRLN_P, ln_epsilon=1e-12)
    n = K.launch_counts()["bias_dropout_residual_ln"] - before
    ptt.seed(7)
    seed = next_seed()
    want = K.bias_dropout_residual_ln_plain(x, r, w, b, bias, 1e-12,
                                            OPS_BDRLN_P, seed)[0].float()
    allow = _ulp_bf16(want) + 2.0 ** -16 * ((want - b.float()).abs() +
                                           b.float().abs())
    worst = float(((got.float() - want).abs() / allow).max())
    print(f"[{tag}] fused_bias_dropout_residual_layer_norm [{OPS_BDRLN_ROWS}"
          f", {OPS_BDRLN_H}] bf16 p={OPS_BDRLN_P}: bdrln launches {n}, "
          f"against the plain version {worst:.3f} of the allowance, max "
          f"|diff| {_max_err(got, want):.3e}", flush=True)
    if n != 1 or worst > 1.0:
        raise AssertionError(f"[{tag}] bdrln through the surface")
    # the fused inference attention ops at BERT-base's [8, 512, 12, 64]
    # bf16: each one flash launch on the tensor cores, held against
    # PyTorch's SDPA (float32 math on the same inputs) within TOL
    q, k, v = (torch.from_numpy(rng.standard_normal(
        OPS_FDPA_SHAPE, dtype=np.float32)).to(dev, torch.bfloat16)
        for _ in range(3))
    want = _sdpa(q.float(), k.float(), v.float(), False).transpose(1, 2)
    rows = {}
    for name, call in (
            ("fused_dot_product_attention",
             lambda: ptt.fused_dot_product_attention(q, k, v)),
            ("qkv_unpack_mha", lambda: ptt.qkv_unpack_mha(q, k, v))):
        before = K.launch_counts()
        got = call()
        after = K.launch_counts()
        sm90 = after["flash_attention.sm90"] - before["flash_attention.sm90"]
        err = _max_err(got, want) / float(want.abs().max())
        rows[name] = [sm90, float(f"{err:.3e}")]
        if sm90 != 1 or err > TOL[torch.bfloat16]:
            raise AssertionError(f"[{tag}] {name}: {sm90} sm90 flash "
                                 f"launches, error {err}")
    print(f"[{tag}] fused inference attention at {list(OPS_FDPA_SHAPE)} "
          f"bf16 [flash_attention.sm90 launches, max |err| vs SDPA of its "
          f"largest] {json.dumps(rows)}", flush=True)
    launches = K.launch_counts()
    _release()
    return launches


def _autograd_f(ptt, w):
    def f(x, y):
        h = ptt.tanh(ptt.matmul(x, w))
        return ptt.stack([ptt.sum(ptt.multiply(h, y)),
                          ptt.sum(ptt.pow(x, 3.0))])
    return f


def _swiglu_layer(ptt, ag):
    class SwiGLUGate(ag.PyLayer):
        """silu(g) * u through the kernel; the backward replays the op
        under autograd (a kernel launch in the backward)."""

        @staticmethod
        def forward(ctx, gate, up):
            ctx.save_for_backward(gate, up)
            return ptt.swiglu(gate, up)

        @staticmethod
        def backward(ctx, dy):
            gate, up = (t.detach().requires_grad_(True)
                        for t in ctx.saved_tensor())
            with torch.enable_grad():
                out = ptt.swiglu(gate, up)
            return tuple(torch.autograd.grad(out, [gate, up], dy))
    return SwiGLUGate


def phase_autograd(K, dev):
    """[autograd]: jacobian, hessian, vjp and jvp of one function written
    from surface ops (float64) on the card against the CPU (1e-10
    relative), and a PyLayer whose forward and backward call the SwiGLU
    kernel op (float32 [256, 1024]: output and gradients against the CPU
    within 1e-5 of each one's largest value; two swiglu launches a
    call)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import autograd as ag

    tag = "autograd"
    K.reset_launch_counts()
    rng = np.random.default_rng(19)
    arrs = [rng.standard_normal(s) for s in ((3,), (3,), (3, 3))]
    res = {}
    for where in ("cpu", dev):
        x, y, w = (torch.from_numpy(a).to(where) for a in arrs)
        f = _autograd_f(ptt, w)
        res[str(where)] = {
            "jacobian": ag.jacobian(lambda v: f(v, y), x).value,
            "hessian": ag.hessian(lambda v: ptt.sum(f(v, y)), x).value,
            "vjp": ag.vjp(f, [x, y], torch.tensor(
                [0.5, -2.0], dtype=torch.float64, device=where))[1][0],
            "jvp": ag.jvp(f, [x, y])[1]}
    errs = {}
    for k, v in res[str(dev)].items():
        want = res["cpu"][k]
        errs[k] = float(((v.cpu() - want).abs() /
                         (1e-12 + want.abs())).max())
    layer = _swiglu_layer(ptt, ag)
    gu = [rng.standard_normal((256, 1024)).astype(np.float32)
          for _ in range(2)]
    dy = rng.standard_normal((256, 1024)).astype(np.float32)
    outs = {}
    for where in ("cpu", dev):
        a, b = (torch.from_numpy(v).to(where).requires_grad_(True)
                for v in gu)
        before = K.launch_counts()["swiglu"]
        out = layer.apply(a, b)
        grads = torch.autograd.grad(out, [a, b], torch.from_numpy(dy).to(
            where))
        outs[str(where)] = ([out] + list(grads),
                            K.launch_counts()["swiglu"] - before)
    (c_t, _), (d_t, n) = outs["cpu"], outs[str(dev)]
    py_err = max(_max_err(d.detach().cpu(), c.detach()) /
                 float(c.detach().abs().max()) for d, c in zip(d_t, c_t))
    print(f"[{tag}] card against cpu, float64 (max relative): "
          f"{json.dumps({k: f'{v:.2e}' for k, v in errs.items()})}; "
          f"PyLayer over the SwiGLU kernel [256, 1024] float32: out and "
          f"grads max|diff| / max|cpu| {py_err:.2e}, swiglu launches a call "
          f"{n}", flush=True)
    if max(errs.values()) > 1e-10 or py_err > 1e-5 or n != 2:
        raise AssertionError(f"[{tag}] the card differs from the CPU")
    return K.launch_counts()


def phase_device(dev):
    """[device]: device.cuda.max_memory_allocated / memory_allocated equal
    to torch.cuda's; a bf16 [4096, 4096] matmul timed with device Events
    on a non-default Stream (stream_guard), its result equal to the
    default stream's; set_device("cpu") and back: creation follows."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import device as D

    tag = "device"
    _release()
    a, b = (torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16)
            for _ in range(2))
    mem = (D.cuda.max_memory_allocated(dev),
           torch.cuda.max_memory_allocated(dev),
           D.cuda.memory_allocated(dev), torch.cuda.memory_allocated(dev))
    want = ptt.matmul(a, b)
    s = D.Stream(dev)
    s.wait_stream(D.current_stream(dev))
    e0, e1 = (D.Event(dev, enable_timing=True) for _ in range(2))
    with D.stream_guard(s):
        ptt.matmul(a, b)                 # warm-up
        e0.record(s)
        for _ in range(10):
            got = ptt.matmul(a, b)
        e1.record(s)
    e1.synchronize()
    ms = e0.elapsed_time(e1) / 10
    side = s.cuda_stream != torch.cuda.default_stream(dev)
    same = torch.equal(got, want)
    prev = D._CURRENT[0]
    ptt.set_device("cpu")
    on_cpu = ptt.zeros([2]).device.type == "cpu" and \
        ptt.get_device() == "cpu"
    ptt.set_device(f"gpu:{dev.index or 0}")
    back = ptt.zeros([2]).device.type == "cuda" and \
        ptt.get_device() == f"gpu:{dev.index or 0}"
    D._CURRENT[0] = prev
    tflops = 2 * 4096 ** 3 / (ms / 1e3) / 1e12
    print(f"[{tag}] max_memory_allocated {mem[0]} (torch.cuda {mem[1]}), "
          f"memory_allocated {mem[2]} ({mem[3]}); bf16 [4096, 4096] matmul "
          f"on a side stream {ms:.4f} ms ({tflops:.1f} TFLOP/s), side "
          f"stream {side}, equal to the default stream's {same}; "
          f"set_device('cpu') round trip {on_cpu and back}", flush=True)
    if mem[0] != mem[1] or mem[2] != mem[3] or not (side and same and
                                                   on_cpu and back):
        raise AssertionError(f"[{tag}] the device surface")
    del a, b, got, want
    _release()


# ----------------------------------------------------------------------
# slice 19: nn's layers and the diffusion UNet
# ----------------------------------------------------------------------

UNET_AGREE_BATCH = 2          # tiny UNet, 16x16 images of 3 channels
UNET_BATCH = 16               # [train:unet]: 16 latents of 4x64x64 (SD 1.x
UNET_RES = 64                 # at 512 px)
UNET_STEPS = 10               # timed steps after one warm-up
UNET_LR = 1e-4
# flash launches of one UNet training step: the attention blocks of block
# 1 (32x32 positions, D 32: SIMT in bf16) down and up, 2 each, and of
# block 2 (16x16, D 64: tensor cores) down and up, 2 each, plus the middle
UNET_PER_STEP = {"flash_attention": 9, "flash_attention.simt": 4,
                 "flash_attention.sm90": 5, "flash_attention_bwd": 9,
                 "flash_attention_bwd.simt": 4, "flash_attention_bwd.sm90": 5}
# a strided entry point's result on the card against the CPU's plain
# version on float32 copies: bf16 inputs, errors of one bf16 rounding of
# the inputs and outputs, relative to the output's largest value
STRIDED_REL = 2e-2


def _unet_pair(dev):
    """The tiny UNet in float32 with one set of seeded weights
    (``weights.random_state``, seed 0) on the CPU and on the card."""
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.models.unet import UNet2DModel, UNetConfig

    cpu = UNet2DModel(UNetConfig.tiny(), device="cpu")
    arrays = weights.random_state(cpu, seed=0)
    weights.from_paddle_tpu_state(arrays, cpu)
    gpu = weights.from_paddle_tpu_state(
        arrays, UNet2DModel(UNetConfig.tiny(), device=dev))
    return cpu, gpu


def _unet_batch(n, c, res, dev, seed=0):
    """(x0, t, noise): seeded normal latents, timesteps uniform in
    [0, 1000), seeded normal noise."""
    r = np.random.default_rng(seed)
    x0 = torch.from_numpy(r.standard_normal((n, c, res, res),
                                            dtype=np.float32))
    t = torch.from_numpy(r.integers(0, 1000, (n,)).astype(np.int64))
    noise = torch.from_numpy(r.standard_normal((n, c, res, res),
                                               dtype=np.float32))
    return tuple(v.to(dev) for v in (x0, t, noise))


def phase_agree_unet(dev):
    """[agree:unet]: the tiny UNet in float32, the same weights on the CPU
    (plain versions, CPU convolutions) and the card (the flash kernels,
    cuDNN; TF32 off): the eval forward within 1e-5 of its largest value,
    the first backward's gradients within 1e-4 + 1e-4 |grad|, and 3
    AdamW(1e-3) ``compile_train_step`` steps of ``ddpm_loss`` within 1e-4
    (the same float32 products summed in other orders). The flash forward
    and backward must launch. Then the strided entry points in bf16
    (``_strided_entries``)."""
    from paddle_tpu_torch.jit import compile_train_step
    from paddle_tpu_torch.models.unet import ddpm_loss
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.optimizer import AdamW

    tag = "agree:unet"
    cpu, gpu = _unet_pair(dev)
    batch = {"cpu": _unet_batch(UNET_AGREE_BATCH, 3, 16, "cpu")}
    batch["gpu"] = tuple(v.to(dev) for v in batch["cpu"])
    K.reset_launch_counts()
    outs, grads = {}, {}
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        x0, t, noise = batch[name]
        model.eval()
        with torch.no_grad():
            outs[name] = model(x0, t).cpu()
        model.train()
        ddpm_loss(model, x0, t, noise).backward()
        grads[name] = {n: p.grad.detach().cpu().clone()
                       for n, p in model.named_parameters()}
        model.clear_gradients()
    fwd_err = _max_err(outs["gpu"], outs["cpu"]) / float(
        outs["cpu"].abs().max())
    worst = max(float(((grads["gpu"][n] - g).abs() - 1e-4 * g.abs()).max())
                for n, g in grads["cpu"].items())
    losses = {}
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        step = compile_train_step(model, ddpm_loss,
                                  AdamW(1e-3, parameters=model.parameters()))
        losses[name] = [float(step(*batch[name])) for _ in range(3)]
    loss_err = max(abs(a - b) for a, b in zip(losses["cpu"], losses["gpu"]))
    launches = K.launch_counts()
    print(f"[{tag}] tiny UNet f32 ({sum(p.numel() for p in cpu.parameters())}"
          f" params, batch {UNET_AGREE_BATCH}x3x16x16): forward max|diff| / "
          f"max|cpu| {fwd_err:.3e} (<= 1e-5); first grads max(|err| - 1e-4 "
          f"|grad|) {worst:.3e} (<= 1e-4); 3 AdamW steps: losses cpu "
          f"{losses['cpu']} cuda {losses['gpu']} max_err {loss_err:.3e} "
          f"(<= 1e-4); launches "
          f"{json.dumps({k: launches[k] for k in UNET_PER_STEP})}",
          flush=True)
    if fwd_err > 1e-5 or worst > 1e-4 or loss_err > 1e-4:
        raise AssertionError(f"[{tag}] the CPU and the card disagree")
    _require_launched(tag, launches, ("flash_attention",
                                      "flash_attention_bwd"))
    del cpu, gpu
    _strided_entries(K, dev)
    _release()


def _strided_view(r, shape, perm, dev, dtype):
    """(a non-contiguous view of `shape` on the card in `dtype`, its
    float32 CPU copy): a permutation of a dense tensor."""
    inv = np.argsort(perm)
    base = r.standard_normal([shape[i] for i in perm], dtype=np.float32)
    t = torch.from_numpy(base).to(dev, dtype).permute(*inv)
    assert tuple(t.shape) == tuple(shape) and not t.is_contiguous()
    return t, t.float().cpu()


def _strided_entries(K, dev):
    """[agree:unet:strided]: each entry point that hands a tensor to a
    kernel, called on the card with strided bf16 views (the UNet's q, k
    and v sliced out of one permuted qkv tensor at both of its attention
    shapes, forward and backward; permuted inputs of the others). Each
    result must equal the same call on dense copies bit for bit (the
    entry point makes the copies), and hold against the CPU's plain
    version on float32 copies within STRIDED_REL of its largest value
    (the CPU's, or, for the UNet-shaped attention, the plain functions on
    the card); every kernel must launch."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.nn import functional as F

    tag = "agree:unet:strided"
    r = np.random.default_rng(19)
    bf = torch.bfloat16
    cases = []
    for s, heads, d in ((1024, 4, 32), (256, 4, 64)):
        qkv = torch.from_numpy(r.standard_normal(
            (2, 3, heads, d, s), dtype=np.float32)).to(dev, bf).permute(
                0, 4, 1, 2, 3)
        q, k, v = (qkv[:, :, i] for i in range(3))
        # the plain version at the UNet's shapes runs on the card (on the
        # host it would take minutes): float32 dense copies
        cases.append((f"scaled_dot_product_attention[s{s},d{d}]",
                      F.scaled_dot_product_attention, (q, k, v),
                      tuple(x.float().contiguous() for x in (q, k, v)),
                      {}, True, lambda a, b, c: K.flash_attention_fwd_plain(
                          a, b, c, False)[0]))
    q, cq = _strided_view(r, (2, 300, 8, 64), (0, 2, 1, 3), dev, bf)
    k, ck = _strided_view(r, (2, 300, 4, 64), (0, 2, 1, 3), dev, bf)
    v, cv = _strided_view(r, (2, 300, 4, 64), (0, 2, 1, 3), dev, bf)
    cases.append(("flash_attention", lambda a, b, c: F.flash_attention(
        a, b, c, causal=True)[0], (q, k, v), (cq, ck, cv), {}, True))
    bounds = torch.full((2, 1, 300, 1), 250, dtype=torch.int32)
    cases.append(("flashmask_attention", lambda a, b, c, m: F.
                  flashmask_attention(a, b, c, m, causal=True),
                  (q, k, v, bounds.to(dev)), (cq, ck, cv, bounds), {}, True))
    x, cx = _strided_view(r, (512, 1024), (1, 0), dev, bf)
    w = torch.from_numpy(r.uniform(0.5, 1.5, 1024).astype(np.float32))
    cases.append(("rms_norm", lambda a, b: F.rms_norm(a, b), (x, w.to(dev,
                                                                   bf)),
                  (cx, w), {}, False))
    cases.append(("fused_rms_norm", lambda a, b: ptt.fused_rms_norm(
        a, b, 1e-6), (x, w.to(dev, bf)), (cx, w), {}, False))
    g, cg = _strided_view(r, (512, 1024), (1, 0), dev, bf)
    cases.append(("swiglu", F.swiglu, (x, g), (cx, cg), {}, False))
    ang = r.standard_normal((300, 32)).astype(np.float32)
    cos = torch.from_numpy(np.cos(np.concatenate([ang, ang], -1)))
    sin = torch.from_numpy(np.sin(np.concatenate([ang, ang], -1)))
    tables = (cos.to(dev, bf), sin.to(dev, bf))
    cases.append(("fused_rope", lambda a, c, s_: F.fused_rope(a, c, s_),
                  (q,) + tables, (cq, cos, sin), {}, False))
    cases.append(("fused_rope[op]", lambda a, c, s_: ptt.fused_rope(
        a, c, s_), (q,) + tables, (cq, cos, sin), {}, False))
    cases.append(("fused_rope_qk", lambda a, b, c, s_: torch.cat(
        F.fused_rope_qk(a, b, c, s_), 2), (q, k) + tables,
        (cq, ck, cos, sin), {}, False))
    res, cres = _strided_view(r, (512, 1024), (1, 0), dev, bf)
    cases.append(("fused_bias_dropout_residual_layer_norm",
                  lambda a, b: ptt.fused_bias_dropout_residual_layer_norm(
                      a, b, dropout_rate=0.0), (x, res), (cx, cres), {},
                  False))
    pages = torch.from_numpy(r.standard_normal(
        (64, 16, 128, 8), dtype=np.float32)).permute(0, 1, 3, 2)
    tab = torch.arange(64, dtype=torch.int32).reshape(4, 16)
    ctx = torch.tensor([200, 17, 256, 1], dtype=torch.int32)
    qd, cqd = _strided_view(r, (4, 32, 128), (2, 1, 0), dev, bf)
    gp = pages.to(dev, bf)
    cases.append(("paged_attention", lambda a, p, tb, cx_: F.paged_attention(
        a, p, p, tb, cx_), (qd, gp, tab.to(dev), ctx.to(dev)),
        (cqd, gp.float().cpu(), tab, ctx), {}, False))
    qr, cqr = _strided_view(r, (4, 8, 32, 128), (3, 1, 2, 0), dev, bf)
    ql = torch.tensor([8, 3, 8, 1], dtype=torch.int32)
    cases.append(("ragged_paged_attention", lambda a, p, tb, cx_, l_: F.
                  ragged_paged_attention(a, p, p, tb, cx_, l_),
                  (qr, gp, tab.to(dev), ctx.to(dev), ql.to(dev)),
                  (cqr, gp.float().cpu(), tab, ctx, ql), {}, False))
    K.reset_launch_counts()
    worst = 0.0
    for name, fn, args, cpu_args, kw, grad, *plain in cases:
        ref = plain[0] if plain else fn
        # the strided views as autograd leaves (detach keeps the strides)
        leaves = [a.detach().requires_grad_() if grad and a.is_floating_point()
                  else a for a in args]
        got = fn(*leaves, **kw)
        dense = fn(*[a.contiguous() for a in args], **kw)
        want = ref(*cpu_args, **kw)
        same = torch.equal(got.detach(), dense.detach())
        err = _max_err(got.detach().cpu(), want.cpu()) / max(
            float(want.abs().max()), 1e-30)
        line = (f"[{tag}] {name:42s} strided==dense {same} max|err| / "
                f"max|plain| {err:.3e}")
        if grad:
            do = torch.from_numpy(r.standard_normal(
                tuple(got.shape), dtype=np.float32))
            gs = torch.autograd.grad(got, [x for x in leaves
                                           if x.requires_grad],
                                     do.to(dev, bf))
            cl = [a.detach().requires_grad_() for a in cpu_args
                  if a.is_floating_point()]
            cw = ref(*cl, *cpu_args[len(cl):], **kw)
            cg = torch.autograd.grad(cw, cl, do.to(cw.device))
            gerr = max(_max_err(a.cpu(), b.cpu()) / max(
                float(b.abs().max()), 1e-30) for a, b in zip(gs, cg))
            err = max(err, gerr)
            line += f" grads max|err| / max|plain| {gerr:.3e}"
        worst = max(worst, err)
        print(line + f" (<= {STRIDED_REL})", flush=True)
        if not same or err > STRIDED_REL:
            raise AssertionError(f"[{tag}] {name}: strided inputs on the "
                                 f"card disagree")
    launches = K.launch_counts()
    _require_launched(tag, launches, (
        "flash_attention", "flash_attention_bwd", "flashmask_attention",
        "flashmask_attention_bwd", "rms_norm", "swiglu", "fused_rope",
        "bias_dropout_residual_ln", "paged_decode_attention",
        "ragged_paged_attention"))
    print(f"[{tag}] {len(cases)} entry points, worst {worst:.3e}; launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}",
          flush=True)


def phase_train_unet(K, dev):
    """[train:unet]: UNetConfig() at full width (12,625,604 parameters,
    float32; 4 latent channels, channels 64/128/256, 2 layers a block,
    16 groups; the layers' own initializers drawn from seed 0) trains on
    UNET_BATCH random 4x64x64 latents (Stable Diffusion 1.x's latent at
    512 px) with timesteps uniform in 0-999 (seed 0): ``ddpm_loss`` under
    ``amp.auto_cast(level="O1", dtype="bfloat16")``, AdamW(1e-4) over the
    float32 parameters (the masters) through ``compile_train_step``; one
    warm-up step and UNET_STEPS timed ones, each timed with CUDA events.
    Every loss finite, the last below the first; every step launches the
    flash kernels UNET_PER_STEP times by route and direction. Then one
    step under the profiler: the attention's share of the device time.
    Returns the timed steps' summed launches."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import compile_train_step
    from paddle_tpu_torch.models.unet import (UNet2DModel, UNetConfig,
                                              ddpm_loss)
    from paddle_tpu_torch.optimizer import AdamW

    tag = "train:unet"
    _release()
    cfg = UNetConfig()
    ptt.seed(0)
    model = UNet2DModel(cfg, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != 12625604:
        raise AssertionError(f"[{tag}] {n_params} parameters")

    def loss_fn(m, x0, t, noise):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return ddpm_loss(m, x0, t, noise)

    opt = AdamW(UNET_LR, parameters=model.parameters())
    step = compile_train_step(model, loss_fn, opt)
    batch = _unet_batch(UNET_BATCH, cfg.in_channels, UNET_RES, dev)
    losses, ms = [], []
    totals = dict.fromkeys(K.launch_counts(), 0)
    for i in range(UNET_STEPS + 1):
        K.reset_launch_counts()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        loss = step(*batch)
        e1.record()
        losses.append(float(loss))           # waits for the step
        ms.append(e0.elapsed_time(e1))
        counts = K.launch_counts()
        bad = {k: counts[k] for k, n in UNET_PER_STEP.items()
               if counts[k] != n}
        other = {k: v for k, v in counts.items()
                 if v and k.split(".")[0] not in ("flash_attention",
                                                  "flash_attention_bwd")}
        if bad or other:
            raise AssertionError(f"[{tag}] step {i} launched {bad or other}"
                                 f", expected {UNET_PER_STEP}")
        if i:
            for k in totals:
                totals[k] += counts[k]
    peak = torch.cuda.max_memory_allocated() / 1e9
    timed = sorted(ms[1:])
    med = timed[len(timed) // 2] if len(timed) % 2 else \
        0.5 * (timed[len(timed) // 2 - 1] + timed[len(timed) // 2])
    print(f"[{tag}] UNetConfig(): {n_params} params f32, channels "
          f"{cfg.block_channels}, {cfg.layers_per_block} layers a block, "
          f"{cfg.norm_groups} groups; batch {UNET_BATCH}x{cfg.in_channels}x"
          f"{UNET_RES}x{UNET_RES}; O1 bf16; AdamW({UNET_LR})")
    print(f"[{tag}] losses (warm-up first) {losses}")
    print(f"[{tag}] step_ms (CUDA events) {[round(x, 3) for x in ms]} "
          f"median_timed={med:.3f} images_per_s="
          f"{UNET_BATCH / med * 1e3:.1f} peak_mem_gb={peak:.3f}")
    print(f"[{tag}] flash launches per step {json.dumps(UNET_PER_STEP)} "
          f"(held every step)", flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[{tag}] losses {losses}")
    _profile_unet_step(tag, step, batch, med)
    del model, opt, step
    _release()
    return totals


def _profile_unet_step(tag, step, batch, med):
    """One more UNet training step under torch.profiler: device time by
    kernel and the flash kernels' share, by route (the SIMT kernels are
    ``flash_fwd_kernel`` / ``flash_bwd_*``, the tensor-core ones
    ``*_sm90_*``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(step(*batch))
        wall = time.perf_counter() - t0
    _print_profile(f"profile:{tag}", prof, wall, "one UNet training step")
    rows = [((getattr(e, "self_device_time_total", 0)
              or getattr(e, "self_cuda_time_total", 0)), e.key)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    busy = sum(us for us, _ in rows) or 1
    flash = [(us, k) for us, k in rows if "flash" in k and "ptt" in k]
    sm90 = sum(us for us, k in flash if "sm90" in k)
    simt = sum(us for us, k in flash) - sm90
    print(f"[{tag}] attention share of the profiled step's device time: "
          f"flash {100 * (sm90 + simt) / busy:.1f}% (SIMT D 32 "
          f"{simt / 1e3:.3f} ms = {100 * simt / busy:.1f}%, tensor-core "
          f"D 64 {sm90 / 1e3:.3f} ms = {100 * sm90 / busy:.1f}%); busy "
          f"{busy / 1e3:.3f} ms of a {med:.3f} ms median step", flush=True)


# ----------------------------------------------------------------------
# slice 20: the RNNs, nn's tail, and ResNet-50 on CIFAR-10 through hapi
# ----------------------------------------------------------------------

VISION_AGREE_BATCH = 16       # tiny ResNet-18 (4 classes) on 16 x 3x32x32
VISION_AGREE_LR = 0.01
VISION_STEPS = 3              # hapi Momentum steps, CPU against card
# the forward's bound on a loss: |cuda - cpu| / |cpu| of a loss computed
# before any update (float32, TF32 off, the same weights and batch)
VISION_FORWARD_REL = 1e-5
# The bound of each later step comes from the trajectory's own
# sensitivity to float32 rounding: the CPU's steps again from weights
# perturbed by one float32 ulp (x (1 +- 2^-24), a seeded sign per element)
# change the losses by S_k relative (9.7e-8, 6.2e-6 and 1.1e-3 at steps
# 0-2, on the CPU of an H100 host): each update amplifies a rounding
# difference ~60-200x. The card's sums differ from the CPU's by about
# three such perturbations at the forward (2.9e-7 against 9.7e-8 at step
# 0); the factor 20 leaves ~6x more for the spread of one perturbation's
# draw.
# Step 0 (before any update) is held to VISION_FORWARD_REL, step k >= 1 to
# max(VISION_FORWARD_REL, VISION_ULP_FACTOR * S_k), S_k measured in the run.
VISION_ULP_FACTOR = 20
RNN_SHAPE = (32, 128, 512)    # [rnn]: batch, steps, input width
RNN_HIDDEN, RNN_LAYERS = 1024, 2
RNN_TIMED = 3                 # timed forward + backward passes
# rows of the batch the CPU loop checks (rows are independent; the CPU's
# forward + backward over all 32 took ~23 s of an H100 host's 8 cores)
RNN_CHECK_ROWS = 8
# [tail]: flash_attn_qkvpacked at [4, 1024, 3, 16, 128] bf16 causal, and
# the varlen form over three sequences packed into one [2024, 3, 16, 128]
TAIL_PACKED = (4, 1024, 16, 128)
TAIL_VARLEN = (300, 700, 1024)
# bf16 against the float32 plain version, relative to the reference's
# largest value: the output (one bf16 rounding of the inputs and of the
# output) and each gradient (dq, dk, dv)
TAIL_OUT_REL, TAIL_GRAD_REL = 1e-2, 2e-2
# [train:resnet]: BASELINE config 1, ResNet-50 on CIFAR-10 at batch 128
RESNET_BATCH = 128
RESNET_TRAIN_BATCHES = (5, 1024)   # data_batch_1..5 of 1024 images each
RESNET_TEST = 1024
RESNET_STEPS = 40                  # num_iters: the whole archive, once
# Momentum's learning rate: from scratch, 0.1 blew the loss up to 20-76
# within the epoch, with or without a 10- or 25-step warm-up, and left
# evaluate's top-1 at 0.12-0.22 (CPU rehearsals of this phase at batch
# 128); 0.01 took the loss from 3.90 to 0.15 and top-1 to 0.51
RESNET_LR = 0.01
RESNET_TIMED = 10                  # bare train_batch calls, timed
CIFAR_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR_STD = (0.2470, 0.2435, 0.2616)


def _agree_tensors(tag, name, got, want, rel):
    """max |got - want| / max |want| <= rel, printed under `name`."""
    want = want.detach().cpu()
    err = _max_err(got.detach().cpu(), want) / max(
        float(want.abs().max()), 1e-30)
    if err > rel:
        raise AssertionError(f"[{tag}] {name}: error {err:.3e} > {rel}")
    return err


@contextlib.contextmanager
def _cudnn_deterministic():
    """FLAGS_cudnn_deterministic set for the block (the flag restored
    after)."""
    from paddle_tpu_torch.framework.flags import get_flag, set_flags
    prev = get_flag("cudnn_deterministic")
    set_flags({"FLAGS_cudnn_deterministic": True})
    try:
        if not (torch.backends.cudnn.deterministic and
                not torch.backends.cudnn.benchmark):
            raise AssertionError("FLAGS_cudnn_deterministic did not reach "
                                 "torch.backends.cudnn")
        yield
    finally:
        set_flags({"FLAGS_cudnn_deterministic": prev})


def phase_agree_vision(dev):
    """[agree:vision]: the port on the card against the port on the CPU,
    float32 (TF32 off), the same seeded weights on both, under
    FLAGS_cudnn_deterministic: a tiny ResNet-18
    (4 classes, VISION_AGREE_BATCH x 3x32x32): the forward in eval and in
    training mode within 1e-4 of the output's largest value, then 3
    ``hapi.Model.train_batch`` Momentum(0.01) losses, each within its
    step's bound (VISION_FORWARD_REL before any update, then
    VISION_ULP_FACTOR times the change that one float32 ulp of the
    weights makes to the CPU's loss), and the first step at which the
    card's loss departs from the CPU's by more than the forward's bound; a
    2-layer bidirectional LSTM(16, 32) and a GRU(16, 32) on
    [4, 10, 16]: outputs and final states within 1e-5, and the gradients
    of every parameter and of the input within 1e-4, of each one's
    largest value."""
    with _cudnn_deterministic():
        _agree_vision(dev)


def _agree_vision(dev):
    import copy

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import hapi, nn
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.vision import models

    tag = "agree:vision"
    ptt.set_device("cpu")
    try:
        ptt.seed(0)
        cpu = models.resnet18(num_classes=4)
        rnns = {"lstm": nn.LSTM(16, 32, num_layers=2, direction="bidirect"),
                "gru": nn.GRU(16, 32)}
    finally:
        ptt.set_device(dev)
    gpu = copy.deepcopy(cpu).to(dev)
    r = np.random.default_rng(0)
    x = torch.from_numpy(r.standard_normal(
        (VISION_AGREE_BATCH, 3, 32, 32), dtype=np.float32))
    y = torch.from_numpy(r.integers(0, 4, VISION_AGREE_BATCH))
    errs = {}
    for mode in ("eval", "train"):
        outs = {}
        for name, m in (("cpu", cpu), ("gpu", gpu)):
            getattr(m, mode)()
            with torch.no_grad():
                outs[name] = m(x.to(next(m.parameters()).device))
        errs[f"resnet18_{mode}"] = _agree_tensors(
            tag, f"resnet18 {mode} forward", outs["gpu"], outs["cpu"], 1e-4)
    ulp = copy.deepcopy(cpu)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in ulp.parameters():
            p.mul_(1 + 2.0 ** -24 * torch.randn(p.shape, generator=g).sign())
    losses = {}
    for name, m in (("cpu", cpu), ("gpu", gpu), ("ulp", ulp)):
        d = next(m.parameters()).device
        model = hapi.Model(m).prepare(
            topt.Momentum(VISION_AGREE_LR, momentum=0.9,
                          parameters=m.parameters()), nn.CrossEntropyLoss())
        losses[name] = [float(model.train_batch([x.to(d)], [y.to(d)])[0])
                        for _ in range(VISION_STEPS)]
    loss_errs, sens = ([abs(a - b) / abs(b) for a, b in zip(
        losses[k], losses["cpu"])] for k in ("gpu", "ulp"))
    bounds = [VISION_FORWARD_REL] + [
        max(VISION_FORWARD_REL, VISION_ULP_FACTOR * s) for s in sens[1:]]
    departs = next((k for k, e in enumerate(loss_errs)
                    if e > VISION_FORWARD_REL), None)
    print(f"[{tag}] Momentum losses, |cuda - cpu| / |cpu| by step "
          f"{[float(f'{e:.3e}') for e in loss_errs]}; the CPU's from "
          f"weights one ulp off {[float(f'{e:.3e}') for e in sens]}; bounds "
          f"{[float(f'{e:.3e}') for e in bounds]}; first step beyond the "
          f"forward's {VISION_FORWARD_REL}: {departs}", flush=True)
    if any(e > b for e, b in zip(loss_errs, bounds)):
        raise AssertionError(f"[{tag}] losses {losses}, bounds {bounds}")
    seq = torch.from_numpy(r.standard_normal((4, 10, 16), dtype=np.float32))
    w = None
    for name, layer in rnns.items():
        res = {}
        for where, m in (("cpu", layer), ("gpu", copy.deepcopy(layer).to(
                dev))):
            xi = seq.to(next(m.parameters()).device).detach().clone() \
                .requires_grad_(True)
            out, st = m(xi)
            flat = [out] + (list(st) if isinstance(st, tuple) else [st])
            if w is None or len(w) != len(flat):
                w = [torch.from_numpy(r.standard_normal(
                    tuple(t.shape), dtype=np.float32)) for t in flat]
            sum((t * wi.to(t.device)).sum() for t, wi in zip(flat, w)) \
                .backward()
            res[where] = ([t.detach().cpu() for t in flat],
                          [xi.grad.cpu()] + [p.grad.cpu()
                                             for p in m.parameters()])
        for i, (g, c) in enumerate(zip(res["gpu"][0], res["cpu"][0])):
            errs[f"{name}_out{i}"] = _agree_tensors(tag, f"{name} out {i}",
                                                    g, c, 1e-5)
        errs[f"{name}_grads"] = max(
            _agree_tensors(tag, f"{name} grad {i}", g, c, 1e-4)
            for i, (g, c) in enumerate(zip(res["gpu"][1], res["cpu"][1])))
    print(f"[{tag}] resnet18(num_classes=4) f32 batch {VISION_AGREE_BATCH}"
          f"x3x32x32, LSTM(16, 32, 2 layers, bidirect) and GRU(16, 32) on "
          f"[4, 10, 16]: max|cuda - cpu| / max|cpu| "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})} "
          f"(forwards <= 1e-4, rnn outputs <= 1e-5, rnn grads <= 1e-4); "
          f"{VISION_STEPS} Momentum({VISION_AGREE_LR}) losses cpu "
          f"{losses['cpu']} cuda {losses['gpu']}; FLAGS_cudnn_deterministic"
          f" set", flush=True)
    del cpu, gpu
    _release()


def phase_rnn(dev):
    """[rnn]: LSTM(512, 1024, num_layers=2, direction="bidirect") in
    float32 (TF32 off) forward and backward over RNN_SHAPE on the card:
    ms (CUDA events, median of RNN_TIMED after a warm-up); then the first
    RNN_CHECK_ROWS rows of the batch, forward and backward on the card
    and through the plain loop on the CPU with the same weights: outputs
    and final states within 1e-4, and the input's and every parameter's
    gradients within 1e-3, of each one's largest value (128 steps of
    float32 products summed in other orders)."""
    import copy

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import nn

    tag = "rnn"
    _release()
    ptt.seed(0)
    lstm = nn.LSTM(RNN_SHAPE[2], RNN_HIDDEN, num_layers=RNN_LAYERS,
                   direction="bidirect", device=dev)
    r = np.random.default_rng(0)
    x = torch.from_numpy(r.standard_normal(RNN_SHAPE, dtype=np.float32))
    w = torch.from_numpy(r.standard_normal(
        (RNN_SHAPE[0], RNN_SHAPE[1], 2 * RNN_HIDDEN), dtype=np.float32))

    def run(m, device, rows=None):
        xi = x[:rows].to(device).requires_grad_(True)
        out, (h, c) = m(xi)
        ((out * w[:rows].to(device)).sum() + h.sum() + c.sum()).backward()
        return out, h, c, xi.grad

    ms = []
    for i in range(RNN_TIMED + 1):
        lstm.clear_gradients()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        run(lstm, dev)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    peak = torch.cuda.max_memory_allocated() / 1e9
    lstm.clear_gradients()
    got = run(lstm, dev, RNN_CHECK_ROWS)
    grads = {n: p.grad.cpu() for n, p in lstm.named_parameters()}
    cpu = copy.deepcopy(lstm).to("cpu")
    cpu.clear_gradients()
    t0 = time.perf_counter()
    want = run(cpu, "cpu", RNN_CHECK_ROWS)
    cpu_s = time.perf_counter() - t0
    errs = {n: _agree_tensors(tag, n, g, c, 1e-4)
            for n, g, c in zip(("out", "h", "c"), got[:3], want[:3])}
    errs["x_grad"] = _agree_tensors(tag, "x grad", got[3], want[3], 1e-3)
    errs["param_grads"] = max(
        _agree_tensors(tag, f"{n} grad", grads[n], p.grad, 1e-3)
        for n, p in cpu.named_parameters())
    timed = sorted(ms[1:])
    print(f"[{tag}] LSTM({RNN_SHAPE[2]}, {RNN_HIDDEN}, num_layers="
          f"{RNN_LAYERS}, bidirect) f32 over {list(RNN_SHAPE)}: forward + "
          f"backward ms {[round(v, 3) for v in ms]} (warm-up first) "
          f"median_timed={timed[len(timed) // 2]:.3f} peak_mem_gb="
          f"{peak:.3f}; rows 0-{RNN_CHECK_ROWS - 1} on the card and through "
          f"the CPU plain loop ({cpu_s:.2f} s): max|cuda - cpu| "
          f"/ max|cpu| {json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}"
          f" (outputs and states <= 1e-4, gradients <= 1e-3)", flush=True)
    del lstm, cpu
    _release()


def phase_tail(K, dev):
    """[tail]: nn.functional's packed flash entry points on the card in
    bfloat16, causal, forward and backward: flash_attn_qkvpacked at
    TAIL_PACKED and flash_attn_varlen_qkvpacked over TAIL_VARLEN's three
    sequences. Each output and gradient is held against the float32
    plain flash forward and backward (``K.flash_attention_fwd_plain`` /
    ``bwd_plain``, per sequence for varlen) on the same bf16 inputs:
    TAIL_OUT_REL and TAIL_GRAD_REL of the reference's largest value. The
    counters must show the kernel, not SDPA, serving each call: one flash
    forward and one backward launch for the packed call, one of each per
    sequence for varlen, all on the tensor-core route. Returns the
    calls' launch counts."""
    from paddle_tpu_torch.nn import functional as F

    tag = "tail"
    r = np.random.default_rng(0)

    def reference(qkv, do):
        """(out, [dq, dk, dv] stacked like qkv) of the float32 plain
        versions on qkv [B, S, 3, H, D]."""
        f = [qkv[:, :, i].float() for i in range(3)]
        out, lse = K.flash_attention_fwd_plain(*f, True)
        grads = K.flash_attention_bwd_plain(*f, out, lse, do.float(), True)
        return out, torch.stack(grads, 2)

    def check(name, qkv, do, call, segments):
        leaf = qkv.detach().requires_grad_(True)
        K.reset_launch_counts()
        out = call(leaf)
        out.backward(do)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        if segments:        # per sequence, packed back: [total, ...]
            refs = [reference(qkv[None, a:b], do[None, a:b])
                    for a, b in segments]
            ref_out = torch.cat([o[0] for o, _ in refs])
            ref_g = torch.cat([g[0] for _, g in refs])
        else:
            ref_out, ref_g = reference(qkv, do)
        errs = {"out": _agree_tensors(tag, f"{name} out", out.float(),
                                      ref_out, TAIL_OUT_REL)}
        for i, n in enumerate(("dq", "dk", "dv")):
            errs[n] = _agree_tensors(tag, f"{name} {n}",
                                     leaf.grad[..., i, :, :].float(),
                                     ref_g[..., i, :, :], TAIL_GRAD_REL)
        want = {"flash_attention": len(segments) or 1,
                "flash_attention_bwd": len(segments) or 1}
        want.update({f"{k}.sm90": n for k, n in list(want.items())})
        bad = {k: launches[k] for k, n in want.items() if launches[k] != n}
        print(f"[{tag}] {name} {list(qkv.shape)} bf16 causal: max|err| / "
              f"max|ref| {json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}"
              f" (out <= {TAIL_OUT_REL}, grads <= {TAIL_GRAD_REL}); "
              f"launches {json.dumps({k: launches[k] for k in want})}",
              flush=True)
        if bad:
            raise AssertionError(f"[{tag}] {name} launches {bad}, expected "
                                 f"{want}")
        return launches

    b, s, h, d = TAIL_PACKED
    qkv = torch.from_numpy(r.standard_normal(
        (b, s, 3, h, d), dtype=np.float32)).to(dev, torch.bfloat16)
    do = torch.from_numpy(r.standard_normal(
        (b, s, h, d), dtype=np.float32)).to(dev, torch.bfloat16)
    total = check("flash_attn_qkvpacked", qkv, do,
                  lambda t: F.flash_attn_qkvpacked(t, causal=True)[0], [])
    n = sum(TAIL_VARLEN)
    cu = np.concatenate([[0], np.cumsum(TAIL_VARLEN)]).astype(np.int32)
    qkv = torch.from_numpy(r.standard_normal(
        (n, 3, h, d), dtype=np.float32)).to(dev, torch.bfloat16)
    do = torch.from_numpy(r.standard_normal(
        (n, h, d), dtype=np.float32)).to(dev, torch.bfloat16)
    cu_t = torch.from_numpy(cu).to(dev)
    varlen = check(
        "flash_attn_varlen_qkvpacked", qkv, do,
        lambda t: F.flash_attn_varlen_qkvpacked(
            t, cu_t, cu_t, max(TAIL_VARLEN), max(TAIL_VARLEN), causal=True),
        list(zip(cu[:-1], cu[1:])))
    _release()
    return {k: total[k] + varlen[k] for k in total}


def _write_cifar_archive(path, seed=0):
    """A CIFAR-10-format archive (``cifar-10-batches-py/data_batch_1..5``
    and ``test_batch``: pickled b"data" uint8 [N, 3072] and b"labels"),
    the images made from `seed`: uniform noise at 40% intensity, plus a
    colour of the class's own (one of ten RGB corners and mid-points of
    [0.15, 0.85]^3) over a centred 16x16 square, which random crops of 4
    pixels and horizontal flips keep learnable."""
    import io as _io
    import pickle
    import tarfile

    r = np.random.default_rng(seed)
    lv = (0.15, 0.85, 0.5)
    colours = np.array([(a, b, c) for a in lv[:2] for b in lv[:2]
                        for c in lv[:2]] + [(0.5, 0.15, 0.85),
                                            (0.85, 0.5, 0.15)])

    def batch(n):
        labels = r.integers(0, 10, n)
        img = r.uniform(0, 0.4, (n, 3, 32, 32))
        img[:, :, 8:24, 8:24] = 0.6 * img[:, :, 8:24, 8:24] + \
            colours[labels][:, :, None, None]
        data = np.clip(img * 255, 0, 255).astype(np.uint8).reshape(n, 3072)
        return pickle.dumps({b"data": data, b"labels": labels.tolist()})

    os.makedirs(os.path.dirname(path), exist_ok=True)
    n_batches, per = RESNET_TRAIN_BATCHES
    with tarfile.open(path, "w:gz") as tf:
        for name, n in [(f"data_batch_{i}", per)
                        for i in range(1, n_batches + 1)] + \
                [("test_batch", RESNET_TEST)]:
            raw = batch(n)
            info = tarfile.TarInfo(f"cifar-10-batches-py/{name}")
            info.size = len(raw)
            tf.addfile(info, _io.BytesIO(raw))


def _resnet_optimizer(net):
    from paddle_tpu_torch import optimizer as topt
    return topt.Momentum(RESNET_LR, momentum=0.9,
                         parameters=net.parameters())


def phase_train_resnet(dev, workdir="build/resnet_smoke"):
    """[train:resnet]: BASELINE config 1 at full width: ResNet-50 with a
    10-way head (``vision.models.resnet50(num_classes=10)``, 23,528,522
    parameters, float32 eager, TF32 off, the layers' own initializers
    from seed 0) on a CIFAR-10-format archive written from seed 0
    (``_write_cifar_archive``: 5 x 1024 training and 1024 test images)
    read by ``vision.datasets.Cifar10`` with ``RandomCrop(32,
    padding=4)``, ``RandomHorizontalFlip()`` and ``Normalize`` (CIFAR's
    mean and std); ``hapi.Model(net).prepare(Momentum(RESNET_LR,
    momentum=0.9), CrossEntropyLoss(), Accuracy(topk=(1, 5)))`` and
    ``fit(train, test, batch_size=128, epochs=1,
    num_iters=RESNET_STEPS)`` (each step with its eval-mode forward for
    the metrics, as hapi's fit does), then ``evaluate``; all under
    FLAGS_cudnn_deterministic. The fit and evaluate run twice from the
    same seeds: the losses and evaluate's top-1 must be equal. Prints the
    fit's ms a step (median of the host clock between step ends, each
    after a device synchronise; data loading included) and images/s, the
    peak memory, the first and last losses (the mean of the last 5 below
    the mean of the first 5), ``evaluate``'s top-1 and top-5 (top-1 above
    the 0.1 of chance), ``predict``'s outputs (finite, [1024, 10], their
    argmax agreeing with evaluate's top-1), a ``save`` / ``load`` round
    trip into a model built from another seed (bit-equal eval logits), a
    bare ``train_batch``'s ms (CUDA events, median of RESNET_TIMED) and
    one profiled ``train_batch`` (device idle share, kernel launches).
    Returns the trained network and RESNET_BATCH normalized test images
    (numpy) for ``[deploy]``."""
    with _cudnn_deterministic():
        return _train_resnet(dev, workdir)


def _resnet_fit(train, test):
    """One fit of a ResNet-50 built from seed 0 (the data order and
    augmentations from seed 0 too), then its evaluate: (net, model, the
    step losses, the step end times, the fit's seconds, evaluate's
    result)."""
    import random

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import hapi, metric, nn
    from paddle_tpu_torch.vision import models

    class StepClock(hapi.Callback):
        def __init__(self):
            self.ends = []

        def on_train_batch_end(self, step, logs=None):
            torch.cuda.synchronize()
            self.ends.append(time.perf_counter())

    ptt.seed(0)
    net = models.resnet50(num_classes=10)
    model = hapi.Model(net).prepare(_resnet_optimizer(net),
                                    nn.CrossEntropyLoss(),
                                    metric.Accuracy(topk=(1, 5)))
    clock = StepClock()
    random.seed(0)
    np.random.seed(0)
    t0 = time.perf_counter()
    hist = model.fit(train, test, batch_size=RESNET_BATCH, epochs=1,
                     num_iters=RESNET_STEPS, log_freq=10, verbose=2,
                     callbacks=[clock])
    fit_s = time.perf_counter() - t0
    ev = model.evaluate(test, batch_size=RESNET_BATCH)
    return net, model, hist["loss"], clock.ends, fit_s, ev


def _train_resnet(dev, workdir):
    import shutil

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import hapi, nn
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.vision import datasets, models, transforms as T

    tag = "train:resnet"
    _release()
    shutil.rmtree(workdir, ignore_errors=True)
    archive = os.path.join(workdir, "cifar-10-python.tar.gz")
    t0 = time.perf_counter()
    _write_cifar_archive(archive)
    norm = T.Normalize(CIFAR_MEAN, CIFAR_STD)
    train = datasets.Cifar10(archive, mode="train", transform=T.Compose([
        T.RandomCrop(32, padding=4), T.RandomHorizontalFlip(), norm]))
    test = datasets.Cifar10(archive, mode="test", transform=norm)
    data_s = time.perf_counter() - t0
    net, model, losses, ends, fit_s, ev = _resnet_fit(train, test)
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(p.numel() for p in net.parameters())
    if n_params != 23528522:
        raise AssertionError(f"[{tag}] {n_params} parameters")
    steps = sorted(np.diff(ends)[2:] * 1e3)
    fit_ms = steps[len(steps) // 2]
    top1, top5 = ev["acc_top1"]
    pred = model.predict(test, batch_size=RESNET_BATCH,
                         stack_outputs=True)[0]
    labels = np.array([int(test[i][1]) for i in range(len(test))])
    pred_top1 = float((pred.argmax(1) == labels).mean())
    ckpt = os.path.join(workdir, "ckpt", "resnet50")
    model.save(ckpt)
    images = np.stack([test[i][0] for i in range(RESNET_BATCH)])
    xt = torch.from_numpy(images[:64]).to(dev)
    net.eval()
    with torch.no_grad():
        logits = net(xt)
    ptt.seed(1)
    net2 = models.resnet50(num_classes=10)
    model2 = hapi.Model(net2).prepare(_resnet_optimizer(net2),
                                     nn.CrossEntropyLoss())
    model2.load(ckpt)
    net2.eval()
    with torch.no_grad():
        logits2 = net2(xt)
    same = bool(torch.equal(logits, logits2))
    opt_same = all(torch.equal(a, b) for (ka, a), (kb, b) in zip(
        model._optimizer.state_dict().items(),
        model2._optimizer.state_dict().items())
        if isinstance(a, torch.Tensor))
    net.train()
    del model2, net2
    # the second fit from the same seeds
    t0 = time.perf_counter()
    _, _, losses2, _, fit2_s, ev2 = _resnet_fit(train, test)
    again_s = time.perf_counter() - t0
    print(f"[{tag}] resnet50(num_classes=10): {n_params} params f32 eager; "
          f"{RESNET_TRAIN_BATCHES[0]} x {RESNET_TRAIN_BATCHES[1]} train / "
          f"{RESNET_TEST} test images of 3x32x32 (archive written and read "
          f"in {data_s:.2f} s); batch {RESNET_BATCH}, Momentum("
          f"{RESNET_LR}, 0.9), "
          f"{len(losses)} steps in {fit_s:.2f} s; FLAGS_cudnn_deterministic "
          f"set")
    print(f"[{tag}] losses first {losses[0]:.4f} last {losses[-1]:.4f} "
          f"(all: {[round(v, 4) for v in losses]})")
    print(f"[{tag}] evaluate: loss {ev['loss'][0]:.4f} top1 {top1:.4f} "
          f"top5 {top5:.4f} (chance 0.1 / 0.5); predict {list(pred.shape)} "
          f"argmax top1 {pred_top1:.4f}; save/load round trip: eval logits "
          f"bit-equal {same}, optimizer state equal {opt_same}",
          flush=True)
    first_diff = next((k for k, (a, b) in enumerate(zip(losses, losses2))
                       if a != b), None)
    print(f"[{tag}] second fit and evaluate from the same seeds "
          f"({fit2_s:.2f} s fit, {again_s:.2f} s in all): losses equal "
          f"{losses == losses2} (first differing step {first_diff}), top1 "
          f"{ev2['acc_top1'][0]:.4f} against {top1:.4f}, evaluate loss "
          f"{ev2['loss'][0]:.6f} against {ev['loss'][0]:.6f}", flush=True)
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not (np.all(np.isfinite(losses)) and last < first):
        raise AssertionError(f"[{tag}] the loss did not fall: {losses}")
    if not top1 > 0.1 or abs(pred_top1 - top1) > 1e-6 or \
            pred.shape != (RESNET_TEST, 10) or not np.isfinite(pred).all():
        raise AssertionError(f"[{tag}] evaluate top1 {top1}, predict "
                             f"{pred.shape} top1 {pred_top1}")
    if not (same and opt_same):
        raise AssertionError(f"[{tag}] the save/load round trip differs")
    if losses != losses2 or ev2["acc_top1"] != ev["acc_top1"]:
        raise AssertionError(f"[{tag}] two fits from one seed differ under "
                             f"FLAGS_cudnn_deterministic: losses {losses} "
                             f"and {losses2}, top1 {ev['acc_top1']} and "
                             f"{ev2['acc_top1']}")
    x0, y0 = next(iter(DataLoader(train, batch_size=RESNET_BATCH)))
    bare = []
    for _ in range(RESNET_TIMED):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        model.train_batch([x0], [y0])
        e1.record()
        torch.cuda.synchronize()
        bare.append(e0.elapsed_time(e1))
    bare = sorted(bare)
    bare_ms = bare[len(bare) // 2]
    print(f"[{tag}] fit ms_per_step={fit_ms:.3f} (median, host clock "
          f"between synchronised step ends: data, step, metrics forward) "
          f"images_per_s={RESNET_BATCH / fit_ms * 1e3:.1f}; train_batch "
          f"ms={bare_ms:.3f} (CUDA events, median of {RESNET_TIMED}) "
          f"images_per_s={RESNET_BATCH / bare_ms * 1e3:.1f}; peak_mem_gb="
          f"{peak:.3f}", flush=True)
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.train_batch([x0], [y0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _print_profile(f"profile:{tag}", prof, wall,
                   "one train_batch (forward, backward, Momentum)")
    del model
    shutil.rmtree(workdir, ignore_errors=True)
    _release()
    return net, images


# ----------------------------------------------------------------------
# slice 21: save and deploy
# ----------------------------------------------------------------------

# [deploy]: Llama-2-7B widths at DEPLOY_LAYERS of its 32 layers, bf16,
# random weights from seed 0, saved with a static [4, 512] int64 signature
# (2 layers first; cut to 1 with SERVE_LAYERS when the smoke took 924.9 s
# of command on a slow host)
DEPLOY_LAYERS = 1
DEPLOY_IDS = (4, 512)
DEPLOY_DIR = "build/deploy_smoke"
# the kernels of the exported Llama program (one ptt node each) and
# their launches a forward
DEPLOY_KERNELS = ("flash_attention", "rms_norm", "swiglu", "fused_rope")
# [deploy]'s ResNet-50: the Predictor's logits against the eager
# forward's, relative to the largest eager logit (float32, cuDNN
# deterministic), at these batches
DEPLOY_RESNET_REL = 1e-5
DEPLOY_RESNET_BATCHES = (1, 128)
DEPLOY_BATCHER = dict(max_batch=8, buckets=(1, 2, 4, 8), timeout_ms=2.0)
DEPLOY_BATCHER_IMAGES = 16


def _deploy_per_forward(layers):
    return {"flash_attention": layers, "rms_norm": 2 * layers + 1,
            "swiglu": layers, "fused_rope": layers}


def _check_deploy_launches(tag, launches, layers):
    """One forward's launches of the exported Llama's kernels: each
    kernel as often as the eager forward launches it, flash on the tensor
    cores, RoPE's q and k together on the vector path."""
    per = {k: launches[k] for k in DEPLOY_KERNELS}
    want = _deploy_per_forward(layers)
    print(f"[{tag}] launches a forward {json.dumps(per)} (expected "
          f"{json.dumps(want)}; flash sm90 {launches['flash_attention.sm90']}"
          f", RoPE q+k {launches['fused_rope.qk']}, scalar "
          f"{launches['fused_rope.scalar']})", flush=True)
    if per != want or launches["flash_attention.sm90"] != layers or \
            launches["fused_rope.qk"] != layers or \
            launches["fused_rope.scalar"]:
        raise AssertionError(f"[{tag}] kernel launches {per}, expected "
                             f"{want}, all on the kernels' main routes")


def _timed(fn, *args, **kwargs):
    """(fn(*args, **kwargs), its seconds with the card synchronised)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_deploy(K, dev, resnet):
    """[deploy]: the deploy path on the card. Llama-2-7B widths at
    DEPLOY_LAYERS layers (bf16, seed-0 weights) through ``jit.save`` with
    a static ``InputSpec([4, 512], "int64")`` (``.pt2`` + ``.pdiparams``
    + ``.native.json``), then ``inference.create_predictor(Config(path))``
    (``jit.load`` onto the card): the Predictor's logits bit-equal to the
    eager forward's, one run's launches of flash, RMSNorm, SwiGLU and RoPE
    (the eager forward's: 1, 2 + 1/L, 1, 1 a layer, counted, none plain);
    then `resnet` (``[train:resnet]``'s trained ResNet-50) saved with
    ``InputSpec([None, 3, 32, 32], "float32")`` under
    FLAGS_cudnn_deterministic: its Predictor at batches 1 and 128 within
    DEPLOY_RESNET_REL of the largest eager logit, a ``DynamicBatcher``
    over single images (every row the Predictor's batch-128 row, within
    the same bound), and ``ProgramAnalysis.summary()``. Prints each
    step's seconds (export, writing, load, a run). Returns the Llama
    run's launches and (path, ids, eager logits) for
    ``[deploy:native]``."""
    import dataclasses
    import shutil

    from paddle_tpu_torch import inference, jit, weights
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    tag = "deploy"
    _release()
    shutil.rmtree(DEPLOY_DIR, ignore_errors=True)
    cfg = dataclasses.replace(LlamaConfig.llama2_7b(),
                              num_hidden_layers=DEPLOY_LAYERS)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    weights.init_random_(model, seed=0)
    model.eval()
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, DEPLOY_IDS)
    with torch.no_grad():
        want = model(torch.from_numpy(ids).to(dev))
    path = os.path.join(DEPLOY_DIR, "llama")
    saved = jit.save(model, path,
                     input_spec=[jit.InputSpec(list(DEPLOY_IDS), "int64")])
    del model
    _release()
    pred, load_s = _timed(inference.create_predictor,
                          inference.Config(path + ".pt2"))
    _, first_s = _timed(pred.run, [ids])
    K.reset_launch_counts()
    outs, run_s = _timed(pred.run, [ids])
    launches = K.launch_counts()
    got = torch.from_numpy(np.asarray(outs[0], np.float32))
    equal = bool(torch.equal(got, want.float().cpu()))
    print(f"[{tag}] llama2_7b widths at {DEPLOY_LAYERS} layers bf16, "
          f"InputSpec({list(DEPLOY_IDS)}, int64): export_s="
          f"{saved['export_s']:.2f} write_s={saved['write_s']:.2f} "
          f"(.pt2 {saved['pt2_bytes']} bytes, .pdiparams "
          f"{saved['pdiparams_bytes']} bytes) load_s={load_s:.2f} "
          f"(create_predictor: jit.load onto the card) first_run_s="
          f"{first_s:.3f} run_s={run_s:.3f} (logits to the host as numpy); "
          f"Predictor logits {list(got.shape)} bit-equal to eager {equal}",
          flush=True)
    _check_deploy_launches(tag, launches, DEPLOY_LAYERS)
    if not equal:
        raise AssertionError(f"[{tag}] the Predictor's logits differ from "
                             f"eager: max |diff| "
                             f"{_max_err(got, want.cpu()):.3e}")
    del pred
    _release()
    with _cudnn_deterministic():
        _deploy_resnet(tag, dev, *resnet)
    return launches, (path, ids, want)


def _deploy_resnet(tag, dev, net, images):
    from paddle_tpu_torch import inference, jit

    path = os.path.join(DEPLOY_DIR, "resnet50")
    net.eval()
    saved = jit.save(net, path, input_spec=[
        jit.InputSpec([None, 3, 32, 32], "float32")])
    pred, load_s = _timed(inference.create_predictor,
                          inference.Config(path))
    errs, outs = {}, {}
    for b in DEPLOY_RESNET_BATCHES:
        x = images[:b]
        got, run_s = _timed(pred.run, [x])
        with torch.no_grad():
            ref = net(torch.from_numpy(x).to(dev)).cpu().numpy()
        outs[b] = got[0]
        errs[b] = (float(np.abs(got[0] - ref).max()),
                   float(np.abs(ref).max()), run_s)
    batcher = pred.make_batcher(**DEPLOY_BATCHER)
    try:
        futs = [batcher.submit(images[i])
                for i in range(DEPLOY_BATCHER_IMAGES)]
        rows = np.stack([f.result(timeout=60) for f in futs])
        served, batches = batcher.rows_served, batcher.batches_run
    finally:
        batcher.close()
    full = outs[max(DEPLOY_RESNET_BATCHES)][:DEPLOY_BATCHER_IMAGES]
    row_err = float(np.abs(rows - full).max())
    scale = float(np.abs(full).max())
    print(f"[{tag}] resnet50 (trained, eval) InputSpec([None, 3, 32, 32], "
          f"float32): export_s={saved['export_s']:.2f} write_s="
          f"{saved['write_s']:.2f} (.pdiparams {saved['pdiparams_bytes']} "
          f"bytes) load_s={load_s:.2f}; Predictor against eager, by batch "
          f"(max |diff|, max |logit|, run_s): {json.dumps(errs)} (<= "
          f"{DEPLOY_RESNET_REL} of the largest logit); DynamicBatcher "
          f"{DEPLOY_BATCHER}: {served} rows in {batches} batches, max "
          f"|row - Predictor's batch-{max(DEPLOY_RESNET_BATCHES)} row| "
          f"{row_err:.3e} (bit-equal {row_err == 0.0})", flush=True)
    # the summary's first line lists every program input (the 161
    # parameters and buffers): shortened here
    print("\n".join(line if not line.startswith("inputs:") else
                    line[:160] + " ..." for line in
                    pred.analysis().summary().splitlines()), flush=True)
    bad = {b: e for b, e in errs.items() if e[0] > DEPLOY_RESNET_REL * e[1]}
    if bad or served != DEPLOY_BATCHER_IMAGES or \
            row_err > DEPLOY_RESNET_REL * scale:
        raise AssertionError(f"[{tag}] ResNet-50's Predictor differs: "
                             f"{bad}, batcher rows {row_err:.3e} of "
                             f"{scale:.3e}, served {served}")
    del pred


def phase_deploy_native(K, path, ids, want):
    """[deploy:native]: ``inference.native.NativePredictor`` over
    ``[deploy]``'s Llama artifact: the AOTInductor compile of the loaded
    program for the card (seconds), one run's launches of flash, RMSNorm,
    SwiGLU and RoPE (the exported program's: the package calls the ptt ops
    back through the dispatcher), its logits (the output's bytes, read as
    bf16) within the bf16 rule |got - want| <= 2^-7 |want| + 2^-8
    rms(want) of the eager forward's (Inductor fuses the elementwise work
    around the kernels: bit-equality is not expected; the bit-equal share
    is printed), and a second construction that reuses the compiled
    package (no compile). The package runs through the C API
    (``ptt_predictor_*``), the package calling the Python ops back in
    this process. Returns the launches and the logits' bytes; the
    artifact stays for ``[deploy:cpp]``."""
    from paddle_tpu_torch.inference.native import NativePredictor

    tag = "deploy:native"
    _release()
    npred, construct_s = _timed(NativePredictor, path)
    if npred.platform() != "cuda":
        raise AssertionError(f"[{tag}] platform {npred.platform()}")
    _, first_s = _timed(npred.run, ids)
    K.reset_launch_counts()
    outs, run_s = _timed(npred.run, ids)
    launches = K.launch_counts()
    got = torch.from_numpy(outs[0].view(np.int16).copy()).view(
        torch.bfloat16).reshape(want.shape).float()
    ref = want.float().cpu()
    err = (got - ref).abs()
    allow = BWD_REL_BF16 * ref.abs() + \
        BWD_FLOOR_BF16 * float(ref.square().mean().sqrt())
    worst = float((err / allow).max())
    exact = float((err == 0).float().mean())
    again, reuse_s = _timed(NativePredictor, path)
    print(f"[{tag}] AOTInductor package of {path}.pt2: construct_s="
          f"{construct_s:.2f} (compile_s={npred.compile_s:.2f}) "
          f"first_run_s={first_s:.3f} run_s={run_s:.3f} (bytes to the "
          f"host); a second construction {reuse_s:.2f} s (compile_s="
          f"{again.compile_s:.2f}: the package reused); logits against "
          f"eager: max |diff| {float(err.max()):.3e}, worst err / "
          f"(2^-7 |want| + 2^-8 rms(want)) {worst:.3f} (<= 1), bit-equal "
          f"share {exact:.4f}", flush=True)
    _check_deploy_launches(tag, launches, DEPLOY_LAYERS)
    if worst > 1.0 or again.compile_s != 0.0:
        raise AssertionError(f"[{tag}] native logits worst {worst:.3f}, "
                             f"second compile {again.compile_s}")
    del npred, again
    _release()
    return launches, outs[0]


# [deploy:cpp]: ptt_run's timed runs of the package (the first is cold)
DEPLOY_CPP_RUNS = 3
# ptt_run --selftest: each C++ op once at the deploy widths (Llama-2-7B:
# hidden 4096, FFN 11008, 32 heads of 128, [4, 512] tokens), bf16, seed 24;
# bias-dropout-residual-LN at [2048, 4096] with p 0.1
SELFTEST_SEED = 24
SELFTEST_BDRLN = dict(eps=1e-5, p=0.1, seed=1234)


def _scrubbed_env():
    """This process's environment less every PYTHON* variable."""
    return {k: v for k, v in os.environ.items()
            if not k.startswith("PYTHON")}


def _selftest_calls(dev):
    """[(name, op, args)] of ptt_run --selftest: seeded inputs on the
    card, as the Python ops take them."""
    g = torch.Generator(device="cpu").manual_seed(SELFTEST_SEED)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g).to(dev, dtype)

    b, s, h, f, nh, d = 4, 512, 4096, 11008, 32, 128
    q, k, v = (rnd(b, s, nh, d) for _ in range(3))
    cos, sin = rnd(s, d, dtype=torch.float32), rnd(s, d, dtype=torch.float32)
    # two documents of 256 tokens: rows of the second cannot see the first
    start = torch.full((b, 1, s), s, dtype=torch.int32)
    start[:, :, : s // 2] = s // 2
    end = torch.full((b, 1, s), s, dtype=torch.int32)
    x = rnd(b * s, h)
    return [
        ("rms", "rms_norm", [rnd(b, s, h), rnd(h), 1e-6]),
        ("swiglu", "swiglu", [rnd(b, s, f), rnd(b, s, f)]),
        ("rope", "fused_rope", [q, cos, sin]),
        ("rope_qk", "fused_rope_qk", [q, k, cos, sin]),
        ("flash", "flash_attention_fwd", [q, k, v, True, None]),
        ("flashmask", "flashmask_attention_fwd",
         [q, k, v, start.to(dev), end.to(dev), None, None, True, 0.08]),
        ("bdrln", "bias_dropout_residual_ln",
         [x, rnd(b * s, h), rnd(h), rnd(h), rnd(h),
          SELFTEST_BDRLN["eps"], SELFTEST_BDRLN["p"],
          SELFTEST_BDRLN["seed"]]),
    ]


def _write_selftest(workdir, calls):
    """<workdir>/calls.txt and each tensor's bytes, in ptt_run's format."""
    from paddle_tpu_torch.runtime import DTYPE_CODES

    lines = []
    for name, op, args in calls:
        parts = [name, op]
        for j, a in enumerate(args):
            if isinstance(a, torch.Tensor):
                fname = f"{name}.in{j}.bin"
                a.contiguous().cpu().view(torch.uint8).numpy().tofile(
                    os.path.join(workdir, fname))
                code = DTYPE_CODES[str(a.dtype).removeprefix("torch.")]
                parts.append(f"t:{code}:{a.dim()}:"
                             f"{','.join(map(str, a.shape))}:{fname}")
            elif a is None:
                parts.append("none")
            elif isinstance(a, bool):
                parts.append(f"b:{int(a)}")
            elif isinstance(a, int):
                parts.append(f"i:{a}")
            else:
                parts.append(f"f:{a!r}")
        lines.append(" ".join(parts))
    with open(os.path.join(workdir, "calls.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")


def _stderr_field(text, key):
    """The values of `key: value` lines of ptt_run's stderr."""
    return [line.split(": ", 1)[1] for line in text.splitlines()
            if line.startswith(key + ": ")]


def phase_deploy_cpp(K, path, ids, want, native_logits):
    """[deploy:cpp]: ``[deploy:native]``'s AOTInductor package (no second
    compile) with no Python in the process. ``ptt_run`` (``ldd`` shows no
    libpython) runs it DEPLOY_CPP_RUNS times on the artifact's ids in a
    subprocess whose environment has no PYTHON* variables: its logits
    within the bf16 rule of the eager forward's (the share bit-equal to
    ``[deploy:native]``'s printed), the C++ ops' launches of its last run
    equal to one forward's (flash on the tensor cores, RoPE's q and k in
    one vector launch), the load's and each run's seconds printed. A
    plain C client (examples/ptt_c_client.c, compiled with gcc -x c
    against the header) gives ptt_run's bytes. ``ptt_run --selftest``
    calls each of the seven C++ ops once through the dispatcher on seeded
    inputs (``_selftest_calls``): every output bit-equal to the Python op's
    on the same inputs (both launch the same kernel), one launch each."""
    import shutil

    from paddle_tpu_torch import runtime

    tag = "deploy:cpp"
    p = runtime.paths()
    ldd = subprocess.run(["ldd", str(p["run"])], capture_output=True,
                         text=True, check=True).stdout
    if "libpython" in ldd:
        raise AssertionError(f"[{tag}] ptt_run links libpython:\n{ldd}")
    work = os.path.abspath(os.path.join(DEPLOY_DIR, "cpp"))
    os.makedirs(work, exist_ok=True)
    ids_bin = os.path.join(work, "ids.bin")
    np.ascontiguousarray(ids, dtype=np.int64).tofile(ids_bin)
    spec = f"7:2:{ids.shape[0]},{ids.shape[1]}:{ids_bin}"
    package = os.path.abspath(path + ".aoti.pt2")
    env = _scrubbed_env()
    t0 = time.perf_counter()
    r = subprocess.run([str(p["run"]), "--runs", str(DEPLOY_CPP_RUNS),
                        package, spec], cwd=work, env=env,
                       capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"[{tag}] ptt_run rc {r.returncode}:\n"
                             f"{r.stderr[-4000:]}")
    launches = json.loads(_stderr_field(r.stderr, "launches")[-1])
    load_s = float(_stderr_field(r.stderr, "load_s")[0])
    run_s = [float(t) for t in _stderr_field(r.stderr, "run_s")]
    platform = _stderr_field(r.stderr, "platform")[0]
    raw = open(os.path.join(work, "out_0.bin"), "rb").read()
    got = torch.frombuffer(bytearray(raw), dtype=torch.bfloat16).reshape(
        want.shape).float()
    ref = want.float().cpu()
    err = (got - ref).abs()
    allow = BWD_REL_BF16 * ref.abs() + \
        BWD_FLOOR_BF16 * float(ref.square().mean().sqrt())
    worst = float((err / allow).max())
    native = torch.frombuffer(bytearray(native_logits.tobytes()),
                              dtype=torch.bfloat16).reshape(want.shape)
    same_native = float((got == native.float()).float().mean())
    print(f"[{tag}] ptt_run {package} (no libpython in ldd, no PYTHON* "
          f"variables): platform {platform}, load_s={load_s:.3f}, run_s="
          f"{json.dumps([round(t, 4) for t in run_s])} (the first cold), "
          f"process wall {wall:.2f} s; logits against eager: max |diff| "
          f"{float(err.max()):.3e}, worst err / (2^-7 |want| + 2^-8 "
          f"rms(want)) {worst:.3f} (<= 1); share bit-equal to "
          f"[deploy:native]'s {same_native:.4f}", flush=True)
    _check_deploy_launches(tag, launches, DEPLOY_LAYERS)
    if worst > 1.0 or platform != "cuda":
        raise AssertionError(f"[{tag}] ptt_run logits worst {worst:.3f} "
                             f"on {platform}")

    client = os.path.join(work, "ptt_c_client")
    cc = subprocess.run(
        ["gcc", "-x", "c", os.path.abspath("examples/ptt_c_client.c"),
         "-x", "none", "-I", str(p["include"]), str(p["lib"]),
         f"-Wl,-rpath,{p['dir']}", "-o", client],
        capture_output=True, text=True)
    if cc.returncode != 0:
        raise AssertionError(f"[{tag}] the C client does not build:\n"
                             f"{cc.stderr[-4000:]}")
    t0 = time.perf_counter()
    c = subprocess.run([client, os.path.abspath(path), "cuda", "7", ids_bin,
                        *map(str, ids.shape)], cwd=work, env=env,
                       capture_output=True, text=True, timeout=600)
    c_wall = time.perf_counter() - t0
    if c.returncode != 0:
        raise AssertionError(f"[{tag}] the C client rc {c.returncode}:\n"
                             f"{c.stderr[-4000:]}")
    c_raw = open(os.path.join(work, "c_out_0.bin"), "rb").read()
    print(f"[{tag}] C client (gcc -x c, ptt_predictor_*): "
          f"{c.stdout.strip().splitlines()[0]}, process wall {c_wall:.2f} "
          f"s; bytes equal to ptt_run's {c_raw == raw}", flush=True)
    if c_raw != raw:
        raise AssertionError(f"[{tag}] the C client's logits differ from "
                             "ptt_run's")

    selftest = os.path.join(work, "selftest")
    os.makedirs(selftest, exist_ok=True)
    calls = _selftest_calls(torch.device("cuda", 0))
    _write_selftest(selftest, calls)
    st = subprocess.run([str(p["run"]), "--selftest", selftest], env=env,
                        capture_output=True, text=True, timeout=600)
    if st.returncode != 0:
        raise AssertionError(f"[{tag}] ptt_run --selftest rc "
                             f"{st.returncode}:\n{st.stderr[-4000:]}")
    st_launches = json.loads(_stderr_field(st.stderr, "launches")[-1])
    equal = {}
    for name, op, args in calls:
        outs = getattr(torch.ops.ptt, op)(*args)
        outs = outs if isinstance(outs, (tuple, list)) else [outs]
        equal[f"{name}:{op}"] = all(
            open(os.path.join(selftest, f"{name}.out{j}.bin"), "rb").read()
            == o.contiguous().cpu().view(torch.uint8).numpy().tobytes()
            for j, o in enumerate(outs))
    want_st = {"rms_norm": 1, "swiglu": 1, "fused_rope": 2,
               "fused_rope.qk": 1, "fused_rope.scalar": 0,
               "flash_attention": 1, "flash_attention.sm90": 1,
               "flashmask_attention": 1, "flashmask_attention.sm90": 1,
               "bias_dropout_residual_ln": 1}
    print(f"[{tag}] ptt_run --selftest at the deploy widths (bf16, seed "
          f"{SELFTEST_SEED}): bit-equal to the Python op {json.dumps(equal)};"
          f" C++ launches {json.dumps(st_launches)}", flush=True)
    bad = {k: v for k, v in want_st.items() if st_launches.get(k) != v}
    if not all(equal.values()) or bad:
        raise AssertionError(f"[{tag}] selftest: {equal}, launches off "
                             f"{bad}")
    shutil.rmtree(DEPLOY_DIR, ignore_errors=True)
    _release()



# ----------------------------------------------------------------------
# slice 22: the distributed strategies of BASELINE configs 3 and 4
# ----------------------------------------------------------------------

# [train:hybrid]: GPT-3 1.3B (all 24 layers) as a PipelineLayer at dp 2 x
# pp 2 on the one card, HYBRID_ACC micro-batches a step, stage-2 ZeRO over
# dp; a warm-up and HYBRID_STEPS timed train_batch calls. The losses are
# float32 cross-entropies of the bf16 logits (the model's own loss is
# bf16, whose ulp at ~10.8 is 0.0625, too coarse to compare).
HYBRID_ACC = 4
HYBRID_STEPS = 3
HYBRID_LR = 1e-4
HYBRID_FIRST_REL = 1e-3     # step 1 against the full-batch run
HYBRID_SENS_FACTOR = 20.0   # later steps: 20x the run's own sensitivity
SAME_REL = 1e-6             # runs of the same arithmetic
HYBRID_PER_STEP = {"flash_attention": 96, "flash_attention_bwd": 96,
                   "flash_attention.sm90": 96,
                   "flash_attention_bwd.sm90": 96, "rms_norm": 0,
                   "swiglu": 0, "fused_rope": 0, "fused_rope_bwd": 0}
# [train:pipeline]: CompiledPipeline over PIPE_LAYERS of GPT-3 1.3B's 24
# blocks (a depth cut, for time) at dp 2 x pp 2 x mp 2, the embeddings,
# final norm and tied head outside the stack; PIPE_STEPS steps under each
# schedule from the same weights
PIPE_LAYERS = 8
PIPE_STEPS = 2
PIPE_TP_RULES = {"qkv_proj.weight": 1, "out_proj.weight": 0,
                 "mlp.0.weight": 1, "mlp.2.weight": 0}
PIPE_PER_STEP = {"flash_attention": 32, "flash_attention_bwd": 32,
                 "flash_attention.sm90": 32, "flash_attention_bwd.sm90": 32,
                 "rms_norm": 0, "swiglu": 0, "fused_rope": 0,
                 "fused_rope_bwd": 0}
# [train:semi]: Llama-2-7B widths at SEMI_LAYERS of its 32 layers (a depth
# cut: AdamW's state of the whole 7B does not fit one card), dp 2 x mp 2
SEMI_LAYERS = 2
SEMI_STEPS = 3
SEMI_PER_STEP = {"flash_attention": 2, "flash_attention_bwd": 2,
                 "flash_attention.sm90": 2, "flash_attention_bwd.sm90": 2,
                 "rms_norm": 5, "swiglu": 2, "fused_rope": 2,
                 "fused_rope.qk": 2, "fused_rope_bwd": 2,
                 "fused_rope.scalar": 0, "fused_rope_bwd.scalar": 0}
TRAIN22_BATCH = (4, 2048)
COLL_OPS = ("send", "recv", "scatter", "all_gather", "reduce_scatter",
            "all_reduce")


def _coll_counts():
    from paddle_tpu_torch.observability.metrics import REGISTRY
    return {op: (REGISTRY.counter("collective_calls_total",
                                  labels={"op": op}).value,
                 REGISTRY.counter("collective_bytes_total",
                                  labels={"op": op}).value)
            for op in COLL_OPS}


def _coll_delta(before):
    now = _coll_counts()
    return {op: [int(now[op][0] - before[op][0]),
                 int(now[op][1] - before[op][1])] for op in COLL_OPS}


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _f32_ce(logits, labels):
    """Cross-entropy in float32 over bf16 logits [..., V]."""
    from paddle_tpu_torch.nn import functional as F
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def _timed_steps(tag, K, call, n_timed, per_step):
    """One warm-up and n_timed timed calls of call() -> loss, each timed
    with CUDA events, its launches held to per_step and its collectives
    (calls, bytes) by op counted. Returns (losses, ms, the timed steps'
    summed launches, per-step collectives)."""
    losses, ms, colls = [], [], []
    totals = dict.fromkeys(K.launch_counts(), 0)
    for i in range(n_timed + 1):
        K.reset_launch_counts()
        c0 = _coll_counts()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        loss = call()
        e1.record()
        losses.append(float(loss))            # waits for the step
        ms.append(e0.elapsed_time(e1))
        colls.append(_coll_delta(c0))
        counts = K.launch_counts()
        bad = {k: counts[k] for k, n in per_step.items() if counts[k] != n}
        if bad:
            raise AssertionError(f"[{tag}] step {i} launched {bad}, "
                                 f"expected {per_step}")
        if i:
            for k in totals:
                totals[k] += counts[k]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[{tag}] a loss is not finite: {losses}")
    return losses, ms, totals, colls


def _restore(model, state):
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(state[n])


def _ulp_perturbed(state, seed=2):
    """`state` with a random half of every tensor's elements moved one
    bf16 ulp (the bit pattern's last place)."""
    gen = torch.Generator(device=next(iter(state.values())).device)
    gen.manual_seed(seed)
    out = {}
    for n, t in state.items():
        bits = t.clone().view(torch.int16)
        bits.add_(torch.randint(0, 2, bits.shape, generator=gen,
                                device=bits.device, dtype=torch.int16))
        out[n] = bits.view(torch.bfloat16)
    return out


class _GPTEmbedPipe(torch.nn.Module):
    """GPT's token and position embeddings as one pipeline layer; its wte
    table is the tied head's weight (GPTModel.forward's first line)."""

    def __init__(self, cfg, device=None, dtype=None):
        from paddle_tpu_torch.nn import Embedding
        super().__init__()
        self.wte = Embedding(cfg.vocab_size, cfg.hidden_size, device=device,
                             dtype=dtype)
        self.wpe = Embedding(cfg.max_position_embeddings, cfg.hidden_size,
                             device=device, dtype=dtype)

    def forward(self, ids):
        from paddle_tpu_torch.amp import amp_add
        pos = torch.arange(ids.shape[1], device=ids.device)[None]
        return amp_add(self.wte(ids), self.wpe(pos))


def _gpt_tied_head(layer, hidden):
    """GPTForCausalLM._head over the shared layer's wte."""
    from paddle_tpu_torch.amp import amp_cast
    hidden, w = amp_cast("matmul", hidden, layer.wte.weight)
    return torch.matmul(hidden, w.t())


def _gpt_descs(cfg, dev, dtype):
    """GPT as pipeline descs: the embeddings (a SharedLayerDesc holding
    wte), the blocks, the final LayerNorm and the tied head (the shared
    layer again)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, SharedLayerDesc)
    from paddle_tpu_torch.models.gpt import GPTBlock
    from paddle_tpu_torch.nn import LayerNorm
    kw = {"device": dev, "dtype": dtype}
    return ([SharedLayerDesc("embed", _GPTEmbedPipe, cfg, **kw)]
            + [LayerDesc(GPTBlock, cfg, **kw)
               for _ in range(cfg.num_hidden_layers)]
            + [LayerDesc(LayerNorm, cfg.hidden_size, cfg.layer_norm_epsilon,
                         **kw),
               SharedLayerDesc("embed", _GPTEmbedPipe, cfg,
                               forward_func=_gpt_tied_head,
                               shared_weight_attr="wte.weight", **kw)])


def _pipe_name(name, n_layers):
    """GPTForCausalLM's parameter name -> the PipelineLayer's."""
    if name.startswith("gpt.wte.") or name.startswith("gpt.wpe."):
        return "0." + name[len("gpt."):]
    if name.startswith("gpt.h."):
        i, rest = name[len("gpt.h."):].split(".", 1)
        return f"{int(i) + 1}.{rest}"
    if name.startswith("gpt.ln_f."):
        return f"{n_layers + 1}." + name[len("gpt.ln_f."):]
    raise KeyError(name)


def _gpt_ref_run(model, state, batch, n_micro, n_steps, stats=None):
    """n_steps of AdamW(HYBRID_LR, multi_precision) from `state` on one
    device: compile_train_step over the whole batch (n_micro None), or
    the micro-batches' gradients accumulated (each loss / n_micro, the
    pipeline's arithmetic). Returns (the losses, the median ms of the
    steps after the first, CUDA events); `stats` (a dict) gets the
    optimizer's state bytes."""
    from paddle_tpu_torch.jit import compile_train_step
    from paddle_tpu_torch.optimizer import AdamW

    _restore(model, state)
    opt = AdamW(HYBRID_LR, parameters=model.parameters(),
                multi_precision=True)
    ids, lab = batch
    mb = ids.shape[0] // (n_micro or 1)
    whole = compile_train_step(model, lambda m, i, l: _f32_ce(m(i), l),
                               opt) if n_micro is None else None

    def accumulated():
        losses = []
        for k in range(n_micro):
            sl = slice(k * mb, (k + 1) * mb)
            loss = _f32_ce(model(ids[sl]), lab[sl])
            losses.append(loss.detach())
            (loss / n_micro).backward()
        opt.step()
        opt.clear_grad()
        total = losses[0]
        for l in losses[1:]:
            total = total + l
        return total / n_micro

    out, ms = [], []
    for _ in range(n_steps):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        loss = whole(ids, lab) if n_micro is None else accumulated()
        e1.record()
        out.append(float(loss))
        ms.append(e0.elapsed_time(e1))
    if stats is not None:
        stats["state_bytes"], stats["scalar_bytes"] = _opt_state_bytes(opt)
    return out, _median(ms[1:])


def _print_zero(tag, zero, replicated_ok=False):
    """Print each owner's optimizer-state bytes; each must hold 1/n of
    the sharded state (and nothing may stay whole unless
    replicated_ok: the compiled pipeline's outer weights)."""
    b = zero.state_bytes()
    print(f"[{tag}] optimizer state (float32 masters and moments, beta "
          f"powers) bytes per rank {b['per_rank']} of {b['local']}"
          f" (+ {b['replicated']} kept whole); {len(zero.shards)} "
          f"parameters sharded", flush=True)
    half = b["local"] / len(b["per_rank"])
    if len(set(b["per_rank"])) != 1 or b["per_rank"][0] != half or \
            (b["replicated"] and not replicated_ok):
        raise AssertionError(f"[{tag}] state bytes {b}: not 1/n a rank")


def _check_colls(tag, colls, want):
    """Each timed step's collective calls equal `want` ({op: calls})."""
    for i, c in enumerate(colls[1:], 1):
        got = {op: c[op][0] for op in want}
        if got != want:
            raise AssertionError(f"[{tag}] step {i} collectives {got}, "
                                 f"expected {want}")


def phase_train_hybrid(K, dev):
    """[train:hybrid], BASELINE config 3's strategies: GPTConfig.
    gpt3_1p3b() (24 layers, hidden 2048, 16 heads, FFN 8192, vocab 50304)
    in bf16 with [train:gpt]'s seed-0 weights and batch (4 x 2048, seed
    1), built as a PipelineLayer (_gpt_descs) under fleet.init with dp 2 x
    pp 2 (four ranks on the one card), HYBRID_ACC micro-batches a step,
    fleet.distributed_optimizer(DygraphShardingOptimizer(AdamW(
    multi_precision=True), stage=2)); a warm-up and HYBRID_STEPS timed
    train_batch calls. References from the same weights, released before
    the hybrid run: the single-device compile_train_step over the whole
    batch, the same with a random half of the weights one bf16 ulp off
    (the run's own sensitivity), and the micro-batches accumulated on one
    device (the pipeline's arithmetic). Held: every loss within SAME_REL
    of the accumulated run's; the first within HYBRID_FIRST_REL of the
    whole-batch run's, each later one within HYBRID_SENS_FACTOR times the
    sensitivity run's distance from it; 96 flash launches each way a step
    on the tensor cores; each dp rank's master and moment bytes half of
    the whole; a scatter and an all-gather per parameter a step and 16
    stage transfers (each micro-batch's activation and the tied wte across
    the stage boundary and their gradients back). Returns the timed
    steps' launches."""
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.base import topology
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        PipelineLayer)
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    tag = "train:hybrid"
    _release()
    cfg = GPTConfig.gpt3_1p3b()
    batch = _train_batch(cfg.vocab_size, *TRAIN22_BATCH, dev)
    model = GPTForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    weights.init_random_(model, seed=0)
    model.train()
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    n_steps = HYBRID_STEPS + 1
    t0 = time.perf_counter()
    full, full_ms = _gpt_ref_run(model, init, batch, None, n_steps)
    sens, _ = _gpt_ref_run(model, _ulp_perturbed(init), batch, None,
                           n_steps)
    micro, micro_ms = _gpt_ref_run(model, init, batch, HYBRID_ACC, n_steps)
    ref_s = time.perf_counter() - t0
    del model
    _release()

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 1,
                               "pp_degree": 2, "sharding_degree": 1,
                               "sep_degree": 1}
    strategy.pipeline_configs = {"accumulate_steps": HYBRID_ACC}
    fleet.init(strategy=strategy, devices=dev)
    try:
        hcg = fleet.get_hybrid_communicate_group()
        pl = PipelineLayer(_gpt_descs(cfg, dev, torch.bfloat16),
                           loss_fn=_f32_ce)
        pl.train()
        _restore(pl, {_pipe_name(n, cfg.num_hidden_layers): t
                      for n, t in init.items()})
        del init
        model = fleet.distributed_model(pl)
        inner = AdamW(HYBRID_LR, parameters=pl.parameters(),
                      multi_precision=True)
        opt = fleet.distributed_optimizer(
            fleet.DygraphShardingOptimizer(inner, hcg, stage=2))
        n_params = len(list(pl.parameters()))
        losses, ms, totals, colls = _timed_steps(
            tag, K, lambda: model.train_batch(batch, opt), HYBRID_STEPS,
            HYBRID_PER_STEP)
        peak = torch.cuda.max_memory_allocated() / 1e9
        print(f"[{tag}] GPTConfig.gpt3_1p3b() as a PipelineLayer of "
              f"{len(pl.run_function)} descs (chunks {pl._chunk_bounds}), "
              f"{type(model).__name__} at dp 2 x pp 2 on one card, "
              f"{HYBRID_ACC} micro-batches of {TRAIN22_BATCH[0] // HYBRID_ACC}"
              f"x{TRAIN22_BATCH[1]}, {type(opt).__name__}("
              f"DygraphShardingOptimizer(AdamW({HYBRID_LR}, "
              f"multi_precision=True), stage=2)); {n_params} parameters")
        print(f"[{tag}] losses (warm-up first; float32 CE) {losses}")
        print(f"[{tag}] one device: whole batch {full}; weights half one "
              f"bf16 ulp off {sens}; micro-batches accumulated {micro} "
              f"({ref_s:.1f} s for the three; median step_ms whole batch "
              f"{full_ms:.3f}, accumulated {micro_ms:.3f})")
        print(f"[{tag}] step_ms (CUDA events) {[round(x, 3) for x in ms]} "
              f"median_timed={_median(ms[1:]):.3f} tokens_per_s="
              f"{TRAIN22_BATCH[0] * TRAIN22_BATCH[1] / _median(ms[1:]) * 1e3:.1f}"
              f" peak_mem_gb={peak:.2f}")
        print(f"[{tag}] collectives per step (calls, bytes) by op "
              f"{json.dumps(colls[-1])}")
        print(f"[{tag}] launches per step {json.dumps(HYBRID_PER_STEP)} "
              f"(held every step)", flush=True)
        _print_zero(tag, inner._zero)
        _check_colls(tag, colls, {"scatter": n_params,
                                  "all_gather": n_params,
                                  "send": 4 * HYBRID_ACC,
                                  "recv": 4 * HYBRID_ACC,
                                  "reduce_scatter": 0, "all_reduce": 0})
        same = [_rel(a, b) for a, b in zip(losses, micro)]
        bounds = [HYBRID_FIRST_REL * abs(full[0])] + [
            HYBRID_SENS_FACTOR * abs(a - b) for a, b in zip(sens[1:],
                                                             full[1:])]
        dist_full = [abs(a - b) for a, b in zip(losses, full)]
        print(f"[{tag}] against the accumulated run: relative "
              f"{[f'{x:.3e}' for x in same]} (bit-equal "
              f"{losses == micro}); against the whole batch: |diff| "
              f"{[f'{x:.3e}' for x in dist_full]} within "
              f"{[f'{x:.3e}' for x in bounds]}", flush=True)
        if max(same) > SAME_REL or any(d > b for d, b in zip(dist_full,
                                                              bounds)):
            raise AssertionError(f"[{tag}] losses {losses} against the "
                                 f"references {micro} / {full}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"[{tag}] the loss did not fall: {losses}")
    finally:
        topology._HCG[0] = None
    del model, opt, inner, pl
    _release()
    return totals


def phase_train_pipeline(K, dev):
    """[train:pipeline], the JAX package's config-3 program
    (full_hybrid_demo) at width: CompiledPipeline over PIPE_LAYERS of
    GPT-3 1.3B's blocks (bf16, seed-0 weights, [train:gpt]'s batch as 4
    micro-batches of 1 x 2048) on a dp 2 x pp 2 x mp 2 mesh of the one
    card, apply_tp on the qkv, out and MLP weights (placements), the
    embeddings, final norm and tied head as outer parameters (embed_fn /
    loss_fn), zero_axis="dp"; PIPE_STEPS steps under "1F1B" and again
    under "ZBH1" from the same weights. Held: the first loss within
    HYBRID_FIRST_REL of the serial eager forward's; ZBH1's losses within
    SAME_REL of 1F1B's; 32 flash launches each way a step (tensor cores);
    each dp rank half the stack's optimizer state; a scatter and an
    all-gather per stack parameter and 16 stage transfers a step. Prints
    each step's forward, B-chain, W-phase and update ms. Returns the
    timed steps' launches (both schedules)."""
    import dataclasses
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.amp import amp_add
    from paddle_tpu_torch.distributed.auto_parallel.placement import \
        PartitionSpec
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        CompiledPipeline)
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    tag = "train:pipeline"
    _release()
    cfg = dataclasses.replace(GPTConfig.gpt3_1p3b(),
                              num_hidden_layers=PIPE_LAYERS)
    model = GPTForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    weights.init_random_(model, seed=0)
    model.train()
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    ids, lab = _train_batch(cfg.vocab_size, *TRAIN22_BATCH, dev)
    n_micro = TRAIN22_BATCH[0]
    with torch.no_grad():
        serial = float(_f32_ce(model(ids, labels=None), lab))
    mesh = dist.ProcessMesh(np.arange(8).reshape(2, 2, 2),
                            ["dp", "pp", "mp"], devices=dev)
    mx = ids.reshape(n_micro, 1, -1)
    my = lab.reshape(n_micro, 1, -1)
    g = model.gpt
    pos = torch.arange(ids.shape[1], device=dev)[None]

    def embed_fn(outer, x):
        return amp_add(g.wte(x), g.wpe(pos))

    def loss_fn(outer, outs, ys):
        return _f32_ce(model._head(g.ln_f(outs)), ys)

    runs, totals = {}, dict.fromkeys(K.launch_counts(), 0)
    for schedule in ("1F1B", "ZBH1"):
        _restore(model, init)
        cp = CompiledPipeline(g.h, mesh=mesh, axis="pp", n_micro=n_micro,
                              x_spec=PartitionSpec(None, "dp"))
        cp.apply_tp(PIPE_TP_RULES)
        outer = [g.wte.weight, g.wpe.weight, g.ln_f.weight, g.ln_f.bias]
        opt = AdamW(HYBRID_LR, parameters=model.parameters(),
                    multi_precision=True)
        step = cp.compile_train_step(opt, loss_fn, outer_params=outer,
                                     zero_axis="dp", embed_fn=embed_fn,
                                     schedule=schedule)
        timing = []

        def call():
            loss = step(mx, my)
            timing.append(dict(step.timing))
            return loss

        losses, ms, tot, colls = _timed_steps(f"{tag}:{schedule}", K, call,
                                              PIPE_STEPS - 1, PIPE_PER_STEP)
        for k in totals:
            totals[k] += tot[k]
        runs[schedule] = losses
        n_stack = sum(1 for layer in g.h for _ in layer.parameters())
        print(f"[{tag}:{schedule}] losses {losses}; step_ms (CUDA events) "
              f"{[round(x, 3) for x in ms]}; phases ms "
              f"{[{k: round(v, 3) for k, v in t.items()} for t in timing]}"
              f" (fwd, b: the backward ticks, w: the deferred weight "
              f"phase, update); peak_mem_gb="
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
        print(f"[{tag}:{schedule}] collectives per step (calls, bytes) by "
              f"op {json.dumps(colls[-1])}", flush=True)
        _print_zero(f"{tag}:{schedule}", step.zero, replicated_ok=True)
        _check_colls(f"{tag}:{schedule}", colls, {
            "scatter": n_stack, "all_gather": n_stack,
            "send": 4 * n_micro, "recv": 4 * n_micro,
            "reduce_scatter": 0, "all_reduce": 0})
        del cp, opt, step
        _release()
    a, b = runs["1F1B"], runs["ZBH1"]
    print(f"[{tag}] {PIPE_LAYERS} of GPT-3 1.3B's 24 blocks at dp 2 x pp 2 "
          f"x mp 2 (placements) with ZeRO-2 over dp; serial eager loss "
          f"{serial:.6f}; 1F1B {a}; ZBH1 {b} (bit-equal {a == b})",
          flush=True)
    if _rel(a[0], serial) > HYBRID_FIRST_REL or \
            max(_rel(x, y) for x, y in zip(b, a)) > SAME_REL or \
            not a[-1] < a[0]:
        raise AssertionError(f"[{tag}] losses 1F1B {a}, ZBH1 {b}, serial "
                             f"{serial}")
    del model, init
    _release()
    return totals


def phase_train_semi(K, dev):
    """[train:semi], BASELINE config 4's semi-auto path: Llama-2-7B widths
    at SEMI_LAYERS of its 32 layers in bf16 (seed-0 weights, batch 4 x
    2048 from seed 1), apply_llama_tp over a dp 2 x mp 2 ProcessMesh of
    the one card, shard_optimizer(AdamW(multi_precision=True),
    ShardingStage2("dp", mesh)), dist.to_static(model, loader, loss, opt)
    -> DistModel; SEMI_STEPS steps (the first a warm-up for the timing).
    Held: the losses within SAME_REL of the single-device
    compile_train_step's from the same weights (run first); every step's
    RMSNorm, SwiGLU, RoPE (q + k, forward and backward) and flash
    launches (tensor cores); each dp rank half the optimizer state; a
    scatter and an all-gather per parameter a step. Returns the timed
    steps' launches."""
    import dataclasses
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.jit import compile_train_step
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         apply_llama_tp)
    from paddle_tpu_torch.optimizer import AdamW

    tag = "train:semi"
    _release()
    cfg = dataclasses.replace(LlamaConfig.llama2_7b(),
                              num_hidden_layers=SEMI_LAYERS)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    weights.init_random_(model, seed=0)
    model.train()
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    ids, lab = _train_batch(cfg.vocab_size, *TRAIN22_BATCH, dev)
    opt = AdamW(HYBRID_LR, parameters=model.parameters(),
                multi_precision=True)
    step = compile_train_step(model, lambda m, i, l: _f32_ce(m(i), l), opt)
    ref, ref_ms, _, _ = _timed_steps(f"{tag}:ref", K,
                                     lambda: step(ids, lab),
                                     SEMI_STEPS - 1, SEMI_PER_STEP)
    del opt, step
    _restore(model, init)
    del init
    _release()
    mesh = dist.ProcessMesh(np.arange(4).reshape(2, 2), ["dp", "mp"],
                            devices=dev)
    apply_llama_tp(model, mesh)
    opt = dist.shard_optimizer(
        AdamW(HYBRID_LR, parameters=model.parameters(),
              multi_precision=True), dist.ShardingStage2("dp", mesh))
    dm = dist.to_static(model, [(ids, lab)], _f32_ce, opt)
    dm.train()
    losses, ms, totals, colls = _timed_steps(tag, K, lambda: dm(ids, lab),
                                             SEMI_STEPS - 1, SEMI_PER_STEP)
    n_params = len(list(model.parameters()))
    print(f"[{tag}] llama2_7b() widths at {SEMI_LAYERS} of 32 layers, bf16, "
          f"{sum(p.numel() for p in model.parameters())} parameters; "
          f"apply_llama_tp over ProcessMesh dp 2 x mp 2 (one card); "
          f"shard_optimizer(AdamW({HYBRID_LR}, multi_precision=True), "
          f"ShardingStage2('dp')); to_static -> {type(dm).__name__}; batch "
          f"{TRAIN22_BATCH[0]}x{TRAIN22_BATCH[1]}")
    print(f"[{tag}] losses (float32 CE) {losses}; single-device "
          f"compile_train_step {ref} (bit-equal {losses == ref})")
    print(f"[{tag}] step_ms (CUDA events) {[round(x, 3) for x in ms]} "
          f"median_timed={_median(ms[1:]):.3f} (single device "
          f"{_median(ref_ms[1:]):.3f}) peak_mem_gb="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    print(f"[{tag}] collectives per step (calls, bytes) by op "
          f"{json.dumps(colls[-1])}")
    print(f"[{tag}] launches per step {json.dumps(SEMI_PER_STEP)} (held "
          f"every step)", flush=True)
    _print_zero(tag, opt._zero)
    _check_colls(tag, colls, {"scatter": n_params, "all_gather": n_params,
                              "reduce_scatter": 0, "all_reduce": 0})
    if max(_rel(a, b) for a, b in zip(losses, ref)) > SAME_REL or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"[{tag}] losses {losses} against {ref}")
    del model, opt, dm
    _release()
    return totals


# ----------------------------------------------------------------------
# slice 23: quantization, MoE, incubate, geometric, text and audio
# ----------------------------------------------------------------------

# [quant:qat] / [quant:ptq]: Llama-2-7B widths (hidden 4096, FFN 11008, 32
# heads, vocab 32000) at QAT_LAYERS of its 32 layers, bf16, seed-0
# weights; QAT_STEPS AdamW steps (the first a warm-up for the timing) on
# batch QAT_BATCH; PTQ calibrates on PTQ_BATCHES batches of PTQ_BATCH
# tokens (the histogram observers read every activation on the host)
QAT_LAYERS = 2
QAT_STEPS = 3
QAT_BATCH = (1, 2048)
QAT_PER_STEP = SEMI_PER_STEP
PTQ_BATCHES = 4
PTQ_BATCH = (1, 256)
PTQ_KINDS = ("AbsmaxObserver", "HistObserver", "KLObserver")
# [quant:weight_only]: Llama-2-7B's gate_proj [in, out] and the two forms
WO_SHAPE = (4096, 11008)
WO_FORMS = (("weight_only_int8", -1), ("weight_only_int4", 128))
WO_ROWS = (4, 2048)
# [quant:pass]: TRAIN_CFG's widths at QPASS_LAYERS layers, batch
# QPASS_BATCH, bf16. The fused program (the kernels round once, in
# float32 inside) and the eager bf16 fake-quant composition (rounding at
# every op) both move activations across half-code boundaries, each
# moving an element by a whole code step; so the fused logits are held
# against the float32 composition of the same weights, no further off
# than QPASS_FACTOR times the eager bf16 composition (the [to_static]
# rule), in the mean and (QPASS_MAX_FACTOR) the largest |difference|
QPASS_LAYERS = 2
QPASS_BATCH = (1, 2048)
QPASS_FACTOR = 1.5
QPASS_MAX_FACTOR = 2.0
# [moe]: Mixtral-8x7B's published widths (mistralai/Mixtral-8x7B-v0.1
# config.json: hidden_size 4096, intermediate_size 14336,
# num_local_experts 8, num_experts_per_tok 2) in the JAX layer's FFN form
# (one w_gate_up, tanh GELU), capacity factor 1.5, 2 x 2048 tokens of bf16;
# each run one warm-up and MOE_TIMED timed forward + backward passes; the
# one-hot form against the sorted one, and the ep=4 run (outputs and
# every gradient) against the dense one, within MOE_REL of each tensor's
# largest |value|: one bf16 rounding (the forms sum a token's two
# weighted expert outputs in other orders in float32, and the ep run's
# float32 products may take other cuBLAS algorithms at 2 and at 8
# experts a batch, before the one cast to bf16; near-zero elements then
# differ by many of their own ulps, so ulps are printed, not held)
MOE_SHAPE = (4096, 14336, 8, 2)
MOE_CF = 1.5
MOE_TOKENS = (2, 2048)
MOE_TIMED = 2
MOE_EP = 4
MOE_REL = 2.0 ** -8
# [incubate] geometric: a graph of GEO_NODES nodes of GEO_FEAT float32
# features and GEO_EDGES random edges, card against CPU (sums in float32
# within GEO_REL of the largest, max / min exact)
GEO_NODES, GEO_FEAT, GEO_EDGES = 100_000, 64, 1_000_000
GEO_REL = 1e-5
# [text]: Viterbi over batch 32, 256 steps, 64 tags
VITERBI_SHAPE = (32, 256, 64)
# [audio]: 32 clips in ESC-50's format (5 s of 44.1 kHz mono); the dB
# features card against CPU within AUDIO_DB_ATOL dB, a 1.2% difference of
# a bin's power: the two libraries' float32 FFTs differ by ~1e-6 of a
# frame's largest bin in every bin, which the quietest mel bins (1e-4 -
# 1e-5 of the largest) carry as 0.004-0.04 dB (0.0089 dB on this data on
# an H100)
AUDIO_CLIPS, AUDIO_SR, AUDIO_SECONDS = 32, 44100, 5
AUDIO_DB_ATOL = 5e-2


def _kernels_in(fn):
    """(device kernels fn launched, their device ms) from one profiled
    call, the window's edges padded as _profile_step pads them."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.prepare_trace()
    x = torch.zeros(1 << 20, device="cuda")
    for _ in range(256):
        x.add_(1.0)
    torch.cuda.synchronize()
    del x
    prof.start_trace()
    time.sleep(TRACE_EDGE_S)
    fn()
    torch.cuda.synchronize()
    time.sleep(TRACE_EDGE_S)
    prof.stop_trace()
    rows = [((getattr(e, "self_device_time_total", 0)
              or getattr(e, "self_cuda_time_total", 0)), e.count)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    rows = [r for r in rows if r[0] > 0]
    return sum(c for _, c in rows), sum(us for us, _ in rows) / 1e3


def _quant_model(dev):
    """Llama-2-7B widths at QAT_LAYERS layers, bf16, seed-0 weights."""
    import dataclasses
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    _release()
    cfg = dataclasses.replace(LlamaConfig.llama2_7b(),
                              num_hidden_layers=QAT_LAYERS)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    return weights.init_random_(model, seed=0)


def phase_quant_ptq(model):
    """[quant:ptq]: PTQ(QuantConfig(activation=<kind>(),
    weight=AbsmaxObserver())) of the float model (a copy per kind) over
    PTQ_BATCHES batches of PTQ_BATCH tokens: the outputs must equal the
    float model's (observers pass their input through); printed: the
    first layer's activation and weight scales, and each kind's host
    seconds beyond the float forwards'."""
    from paddle_tpu_torch import quantization as Q

    tag = "quant:ptq"
    cfg = model.config
    rng = np.random.default_rng(3)
    dev = model.device
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, PTQ_BATCH))
               .to(dev) for _ in range(PTQ_BATCHES)]
    model.eval()
    with torch.no_grad():
        model(batches[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = [model(b) for b in batches]
        torch.cuda.synchronize()
        base = time.perf_counter() - t0
        for kind in PTQ_KINDS:
            q = Q.PTQ(Q.QuantConfig(getattr(Q, kind)(),
                                    Q.AbsmaxObserver())).quantize(model)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = [q(b) for b in batches]
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"[{tag}] {kind}: an observer changed "
                                     "the forward")
            layer = q.llama.layers[0]
            scales = {}
            for name, lin in (("q", layer.self_attn.q_proj),
                              ("o", layer.self_attn.o_proj),
                              ("gate", layer.mlp.gate_proj),
                              ("down", layer.mlp.down_proj)):
                a = lin.activation_quanter.scales()
                w = lin.weight_quanter.scales()
                scales[name] = [round(float(a), 5), round(float(w), 5)]
            n = sum(isinstance(m, Q.QuantedLinear) for m in q.modules())
            print(f"[{tag}] {kind} on the activations, AbsmaxObserver on "
                  f"the weights, {n} layers swapped: layer 0 [activation, "
                  f"weight] scales {json.dumps(scales)}; {PTQ_BATCHES} "
                  f"batches of {PTQ_BATCH[0]}x{PTQ_BATCH[1]} in "
                  f"{secs:.3f} s, observers' host s {secs - base:.3f} "
                  f"(float forwards {base:.3f} s)", flush=True)
            del q, got
    del want
    _release()


def _swapped(model):
    from paddle_tpu_torch import quantization as Q
    return sum(isinstance(m, Q.QuantedLinear) for m in model.modules())


def phase_quant_qat(K, model):
    """[quant:qat], the slice's main path: QAT_STEPS AdamW
    (multi_precision) steps of compile_train_step on the float model,
    then QAT(QuantConfig()).quantize(model, inplace=True) and
    QAT_STEPS steps from the same weights, then the same QAT steps in an
    eager loop (backward, step, clear_grad) from the same weights and
    fresh quanters. Held: QAT_PER_STEP launches every step of both
    trained runs (RMSNorm, SwiGLU, RoPE q + k and its backward, flash
    forward and backward on the tensor cores), the QAT losses different
    from the float ones (beyond SAME_REL) and within SAME_REL of the eager
    twin's. Printed: swapped layers, ms a step (CUDA events) and peak
    memory beside the float run's, and one profiled step of each (device
    kernels a step: the difference is the fake quant's launches).
    Returns the QAT run's timed launches."""
    from paddle_tpu_torch import quantization as Q
    from paddle_tpu_torch.jit import compile_train_step
    from paddle_tpu_torch.optimizer import AdamW

    tag = "quant:qat"
    cfg = model.config
    model.train()
    init = [(p, p.detach().clone()) for p in model.parameters()]

    def restore():
        with torch.no_grad():
            for p, v in init:
                p.copy_(v)

    ids, lab = _train_batch(cfg.vocab_size, *QAT_BATCH, model.device)

    def loss_fn(m, i, l):
        return _f32_ce(m(i), l)

    _release()
    opt = AdamW(HYBRID_LR, parameters=model.parameters(),
                multi_precision=True)
    step = compile_train_step(model, loss_fn, opt)
    flt, flt_ms, _, _ = _timed_steps(f"{tag}:float", K,
                                     lambda: step(ids, lab), QAT_STEPS - 1,
                                     QAT_PER_STEP)
    flt_peak = torch.cuda.max_memory_allocated() / 1e9
    flt_k, flt_dev = _kernels_in(lambda: float(step(ids, lab)))
    del step, opt
    restore()
    _release()
    Q.QAT(Q.QuantConfig()).quantize(model, inplace=True)
    n = _swapped(model)
    if n != 7 * QAT_LAYERS + 1:
        raise AssertionError(f"[{tag}] {n} layers swapped, want "
                             f"{7 * QAT_LAYERS + 1}")
    opt = AdamW(HYBRID_LR, parameters=model.parameters(),
                multi_precision=True)
    step = compile_train_step(model, loss_fn, opt)
    losses, ms, totals, _ = _timed_steps(tag, K, lambda: step(ids, lab),
                                         QAT_STEPS - 1, QAT_PER_STEP)
    peak = torch.cuda.max_memory_allocated() / 1e9
    q_k, q_dev = _kernels_in(lambda: float(step(ids, lab)))
    del step, opt
    restore()
    for m in model.modules():
        if isinstance(m, Q.BaseObserver):
            m._scale = None
    opt = AdamW(HYBRID_LR, parameters=model.parameters(),
                multi_precision=True)
    twin = []
    for _ in range(QAT_STEPS):
        loss = loss_fn(model, ids, lab)
        loss.backward()
        opt.step()
        opt.clear_grad()
        twin.append(float(loss))
    del opt
    print(f"[{tag}] llama2_7b() widths at {QAT_LAYERS} of 32 layers, bf16, "
          f"batch {QAT_BATCH[0]}x{QAT_BATCH[1]}, AdamW({HYBRID_LR}, "
          f"multi_precision=True): QAT(QuantConfig()) swapped {n} Linear "
          f"layers (FakeQuanterWithAbsMax on activations and weights)",
          flush=True)
    print(f"[{tag}] losses (float32 CE) QAT {losses}; float {flt}; QAT "
          f"eager twin {twin}", flush=True)
    print(f"[{tag}] step_ms (CUDA events) QAT {[round(x, 3) for x in ms]} "
          f"median_timed={_median(ms[1:]):.3f}; float "
          f"{[round(x, 3) for x in flt_ms]} median_timed="
          f"{_median(flt_ms[1:]):.3f}; peak_mem_gb QAT {peak:.2f} float "
          f"{flt_peak:.2f}", flush=True)
    print(f"[{tag}] one profiled step: device kernels QAT {q_k} ({q_dev:.3f}"
          f" device ms), float {flt_k} ({flt_dev:.3f} device ms): "
          f"fake-quant launches a step {q_k - flt_k}", flush=True)
    print(f"[{tag}] launches per step {json.dumps(QAT_PER_STEP)} (held "
          f"every step)", flush=True)
    if min(_rel(a, b) for a, b in zip(losses, flt)) <= SAME_REL:
        raise AssertionError(f"[{tag}] the QAT losses {losses} equal the "
                             f"float ones {flt}: the quantization is a "
                             "no-op")
    if max(_rel(a, b) for a, b in zip(losses, twin)) > SAME_REL:
        raise AssertionError(f"[{tag}] compile_train_step {losses} against "
                             f"the eager twin {twin}")
    _require_launched(tag, totals, [k for k, v in QAT_PER_STEP.items()
                                    if v])
    del init
    _release()
    return totals


def phase_quant_weight_only(dev):
    """[quant:weight_only]: weight_quantize of gate_proj's weight (bf16,
    WO_SHAPE, seed 4) in each WO_FORMS form and weight_only_linear at
    each of WO_ROWS rows of bf16 x: the error against the float32 product
    of x and the dequantized weight (held within 2^-7 of its largest, one
    bf16 rounding), the codes' and scales' bytes against the bf16
    weight's, and ms (the smoke's _time_ms: L2 emptied, mean of ITERS)
    beside torch.matmul on the bf16 weight."""
    from paddle_tpu_torch import quantization as Q

    tag = "quant:weight_only"
    k, n = WO_SHAPE
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    w = (torch.randn(k, n, generator=g, device=dev) * 0.02).to(
        torch.bfloat16)
    for algo, group in WO_FORMS:
        codes, scale = Q.weight_quantize(w, algo=algo, group_size=group)
        qmax = 127 if algo.endswith("int8") else 7
        if int(codes.abs().max()) != qmax or codes.dtype != torch.int8:
            raise AssertionError(f"[{tag}] {algo}: codes {codes.dtype} "
                                 f"max {int(codes.abs().max())}")
        deq = codes.float()
        if scale.dim() == 2:
            deq = (deq.reshape(n, scale.shape[1], -1)
                   * scale[:, :, None]).reshape(n, k)
        else:
            deq = deq * scale[:, None]
        wbytes = codes.numel() + scale.numel() * 4
        qerr = float((deq.t() - w.float()).abs().max())
        for rows in WO_ROWS:
            x = torch.randn(rows, k, generator=g, device=dev).to(
                torch.bfloat16)
            got = Q.weight_only_linear(x, codes, None, scale,
                                       group_size=group)
            want = x.float() @ deq.t()
            err = float((got.float() - want).abs().max() /
                        want.abs().max())
            ms = _time_ms(lambda: Q.weight_only_linear(
                x, codes, None, scale, group_size=group))
            ref_ms = _time_ms(lambda: torch.matmul(x, w))
            print(f"[{tag}] {algo} group_size={group} x [{rows}, {k}] "
                  f"bf16: max err vs the float32 dequantized product "
                  f"{err:.3e} of its largest; weight bytes {wbytes} vs "
                  f"bf16 {2 * k * n} ({wbytes / (2 * k * n):.3f}; int4 "
                  f"codes unpacked in int8); max |dequant - w| {qerr:.3e}"
                  f"; ms weight_only_linear {ms:.4f} torch.matmul(bf16) "
                  f"{ref_ms:.4f}", flush=True)
            if err > 2.0 ** -7:
                raise AssertionError(f"[{tag}] {algo} at {rows} rows: "
                                     f"error {err}")
    _release()


class _FakeQuantMatmuls(torch.overrides.TorchFunctionMode):
    """x @ W with W a rank-2 parameter computed as fq(x) @ fq(W), each
    with its own absmax: the eager composition quantize_pass rewrites a
    program into."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "__name__", "") in ("matmul", "__matmul__") and \
                len(args) == 2 and isinstance(args[1], torch.nn.Parameter) \
                and args[1].dim() == 2:
            from paddle_tpu_torch.quantization import fake_quant_dequant
            x, w = args
            return torch.matmul(
                fake_quant_dequant(x, x.abs().amax()),
                fake_quant_dequant(w, w.abs().amax()))
        return func(*args, **kwargs)


def phase_quant_pass(K, dev):
    """[quant:pass]: fusion_audit_torch.PlainLlama (plain torch ops) at
    TRAIN_CFG's widths and QPASS_LAYERS layers, bf16, seed-0 weights, its
    logits on QPASS_BATCH ids through compiler.optimize twice: with
    pattern fusion then quantize_pass (then DCE), and with quantize_pass
    alone. Held: quant_linear rewrites equal to the linear products (the
    2-d products of the capture: 7 a layer and the head), 0 fallbacks;
    the pass-alone program's logits bit-equal to the eager bf16
    fake-quant composition (_FakeQuantMatmuls); the fused program's
    within QPASS_FACTOR (mean) and QPASS_MAX_FACTOR (largest) times that
    composition's distance from the float32 composition of the same
    weights; the quantized logits different from the float ones. Printed: the kernels the
    fused program places (its ptt nodes) and one run's launches. Returns
    the fused run's launches."""
    import copy

    from paddle_tpu_torch import compiler
    from paddle_tpu_torch import quantization as Q
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.observability.metrics import REGISTRY

    tag = "quant:pass"
    _release()
    cfg = LlamaConfig(**{**TRAIN_CFG, "num_hidden_layers": QPASS_LAYERS})
    plain = _plain_llama(cfg, dev, torch.bfloat16)
    plain.eval()
    ids, _ = _train_batch(cfg.vocab_size, *QPASS_BATCH, dev)

    def count(name):
        c = REGISTRY.get(name, {"pattern": "quant_linear"})
        return c.value if c is not None else 0

    secs = {}
    with torch.no_grad():
        t0 = time.perf_counter()
        flt = plain(ids)
        with _FakeQuantMatmuls():
            eager = plain(ids)
            plain32 = copy.deepcopy(plain).float()     # the same weights
            ref = plain32(ids)
            del plain32
        torch.cuda.synchronize()
        secs["eager"] = time.perf_counter() - t0
        out = {}
        for name, passes in (
                ("fused", ["pattern_fusion", Q.quantize_pass(), "dce"]),
                ("alone", [Q.quantize_pass(), "dce"])):
            r0, f0 = (count("compiler_rewrites_total"),
                      count("compiler_fallbacks_total"))
            t0 = time.perf_counter()
            fn = compiler.optimize(lambda i: plain(i), name=f"qpass_{name}",
                                   pass_manager=compiler.PassManager(passes))
            fn(ids)
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
            K.reset_launch_counts()
            got = fn(ids)
            torch.cuda.synchronize()
            launches = K.launch_counts()
            (gm,) = fn.programs.values()
            # the 2-d products: each rewrite keeps its one mm, so the
            # pass-alone program has exactly the capture's
            n_mm = sum(nd.target is torch.ops.aten.mm.default
                       for nd in gm.graph.nodes)
            out[name] = (got, count("compiler_rewrites_total") - r0,
                         count("compiler_fallbacks_total") - f0,
                         _ptt_nodes(gm), launches, n_mm)
            del fn, gm
    n_linear = out["alone"][5]
    d_eager = (eager.float() - ref.float()).abs()
    e_mean, e_max = float(d_eager.mean()), float(d_eager.max())
    moved = float((eager.float() - flt.float()).abs().mean())
    print(f"[{tag}] plain-op Llama at TRAIN_CFG widths, {QPASS_LAYERS} "
          f"layers, bf16, {QPASS_BATCH[0]}x{QPASS_BATCH[1]}: the eager bf16 "
          f"fake-quant composition from the float32 one (the same "
          f"weights): mean |diff| {e_mean:.4e}, max {e_max:.4e} (logits' "
          f"largest {float(ref.abs().max()):.3f}); from the float logits "
          f"mean {moved:.4e}; seconds {json.dumps({k: round(v, 2) for k, v in secs.items()})}",
          flush=True)
    bad = []
    for name, (got, rw, fb, nodes, launches, _) in out.items():
        d = (got.float() - ref.float()).abs()
        mean, mx = float(d.mean()), float(d.max())
        same = torch.equal(got, eager)
        print(f"[{tag}] {name}: quant_linear rewrites {rw} (linear "
              f"products in the graph {n_linear}), fallbacks {fb}; fused "
              f"kernels placed {json.dumps(nodes)}; launches "
              f"{json.dumps({k: v for k, v in launches.items() if v})}; "
              f"from the float32 composition mean |diff| {mean:.4e} "
              f"({mean / e_mean:.3f}x the eager bf16's), max {mx:.4e} "
              f"({mx / e_max:.3f}x); bit-equal to the eager bf16 "
              f"composition {same}", flush=True)
        if rw != n_linear or n_linear != 7 * QPASS_LAYERS + 1 or fb:
            bad.append(f"{name}: {rw} rewrites, {n_linear} products, {fb} "
                       "fallbacks")
        if name == "alone" and not same:
            bad.append("the pass alone differs from the eager composition")
        if mean > QPASS_FACTOR * e_mean or mx > QPASS_MAX_FACTOR * e_max:
            bad.append(f"{name}: mean {mean} / max {mx} against the eager "
                       f"{e_mean} / {e_max}")
    if not moved > 0:
        bad.append("the quantized logits equal the float ones")
    fused = out["fused"][4]
    for k in ("flash_attention", "rms_norm", "swiglu", "fused_rope"):
        if fused[k] <= 0:
            bad.append(f"the fused program launched no {k}")
    if bad:
        raise AssertionError(f"[{tag}] " + "; ".join(bad))
    del plain, out, flt, eager, ref
    _release()
    return fused


def _moe_ulps(got, want):
    """Largest |got - want| in bf16 ulps of want (elementwise)."""
    w = want.float()
    return float(((got.float() - w).abs() / _ulp_bf16(w)).max())


def _moe_rel(got, want):
    """max |got - want| over max |want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def phase_moe(dev):
    """[moe]: MoELayer(4096, 14336, 8 experts, top-2, capacity factor 1.5)
    in bf16 (seed-0 weights: 1.88 GB of experts) on 2 x 2048 tokens:
    forward + backward (sum of out times a fixed random weight, plus the
    aux loss) under the sorted dispatch, the one-hot dispatch, and the
    sorted one at ep=MOE_EP (the expert weights annotated Shard(0) over a
    co-located ProcessMesh of the card). Held: finite outputs, the
    one-hot form within MOE_REL of the sorted one, the ep run's outputs
    and every gradient within MOE_REL of the dense run's (relative to the
    largest; bf16 ulps and the elements that differ printed). Printed:
    ms fwd + bwd (CUDA events, median of MOE_TIMED after a
    warm-up), peak memory, the tokens dropped, the naive, GShard and
    Switch gates' aux losses and dropped pairs on these tokens."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.incubate.distributed import moe_layer as ML

    tag = "moe"
    _release()
    h, f, e, k = MOE_SHAPE
    layer = weights.init_random_(
        ML.MoELayer(h, f, num_expert=e, topk=k, capacity_factor=MOE_CF,
                    device=dev, dtype=torch.bfloat16), seed=0)
    layer.train()
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    x = torch.randn(*MOE_TOKENS, h, generator=g, device=dev).to(
        torch.bfloat16)
    wout = torch.randn(*MOE_TOKENS, h, generator=g, device=dev)
    params = dict(layer.named_parameters())

    def run(name, sorted_flag):
        from paddle_tpu_torch.framework.flags import set_flags
        set_flags({"FLAGS_moe_sorted_dispatch": sorted_flag})
        ms = []
        for i in range(MOE_TIMED + 1):
            for p in params.values():
                p.grad = None
            xi = x.detach().requires_grad_(True)
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            out = layer(xi)
            ((out.float() * wout).sum() + layer._aux_loss).backward()
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
        set_flags({"FLAGS_moe_sorted_dispatch": True})
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"[{tag}] {name}: output not finite")
        grads = {"x": xi.grad.clone(),
                 **{n: p.grad.clone() for n, p in params.items()}}
        peak = torch.cuda.max_memory_allocated() / 1e9
        print(f"[{tag}] {name}: fwd+bwd ms {[round(t, 2) for t in ms]} "
              f"median_timed={_median(ms[1:]):.2f} peak_mem_gb={peak:.2f}",
              flush=True)
        return out.detach(), grads

    with torch.no_grad():
        logits = layer.gate(x.reshape(-1, h))
    stats = ML.dispatch_stats(logits, k, MOE_CF)
    sorted_out, sorted_g = run("sorted", True)
    _release()
    onehot_out, _ = run("onehot", False)
    _release()
    mesh = dist.ProcessMesh(np.arange(MOE_EP), ["ep"], devices=dev)
    for p in (layer.w_gate_up, layer.w_down):
        dist.shard_tensor(p, mesh, [dist.Shard(0)])
    shards = ML._ep_shards(layer.w_gate_up)
    ep_out, ep_g = run(f"ep{MOE_EP}", True)
    for p in (layer.w_gate_up, layer.w_down):
        del p._dist_attr
    oh = _moe_ulps(onehot_out, sorted_out)
    oh_rel = _moe_rel(onehot_out, sorted_out)
    ep = _moe_ulps(ep_out, sorted_out)
    ep_rel = _moe_rel(ep_out, sorted_out)
    ep_diff = int((ep_out != sorted_out).sum())
    gep = {n: _moe_ulps(ep_g[n], sorted_g[n]) for n in sorted_g}
    grel = {n: _moe_rel(ep_g[n], sorted_g[n]) for n in sorted_g}
    gdiff = {n: int((ep_g[n] != sorted_g[n]).sum()) for n in sorted_g}
    aux = {}
    with torch.no_grad():
        flat = x.reshape(-1, h)
        for name, gate in (
                ("naive", layer.gate),
                ("gshard", ML.GShardGate(h, e, topk=k, device=dev,
                                         dtype=torch.bfloat16)),
                ("switch", ML.SwitchGate(h, e, device=dev,
                                         dtype=torch.bfloat16))):
            if gate is not layer.gate:
                gate.gate.weight.copy_(layer.gate.gate.weight)
                gate.train()
            lg = gate(flat)
            a = gate.aux_loss(lg)
            a = ML.load_balance_loss(lg, gate.topk) if a is None else a
            st = ML.dispatch_stats(lg, gate.topk, MOE_CF)
            aux[name] = [round(float(a), 6), st["dropped"], st["pairs"]]
    print(f"[{tag}] Mixtral-8x7B widths (hidden {h}, FFN {f}, {e} experts, "
          f"top-{k}), capacity factor {MOE_CF} (capacity {stats['capacity']}"
          f" rows an expert), {MOE_TOKENS[0]}x{MOE_TOKENS[1]} bf16 tokens: "
          f"dropped pairs {stats['dropped']} of {stats['pairs']}; aux loss, "
          f"dropped, pairs by gate {json.dumps(aux)}", flush=True)
    print(f"[{tag}] one-hot vs sorted output: max |diff| {oh_rel:.3e} of "
          f"the largest, {oh:.2f} bf16 ulps at worst; ep{MOE_EP} "
          f"({len(shards)} positions, experts "
          f"{[(lo, hi) for lo, hi, _ in shards]}) vs dense: output "
          f"{ep_rel:.3e} of the largest ({ep:.2f} ulps, {ep_diff} elements "
          f"differ), gradients {json.dumps({n: float(f'{v:.3e}') for n, v in grel.items()})} "
          f"({json.dumps({n: round(v, 2) for n, v in gep.items()})} ulps; "
          f"elements differing {json.dumps(gdiff)}); bound {MOE_REL:.3e} of "
          f"the largest", flush=True)
    if oh_rel > MOE_REL or ep_rel > MOE_REL or max(grel.values()) > MOE_REL:
        raise AssertionError(f"[{tag}] the dispatch forms or the ep run "
                             "disagree beyond the bound")
    del layer, params, x, wout, sorted_out, onehot_out, ep_out, sorted_g, ep_g
    _release()


def phase_incubate(dev):
    """[incubate]: prune_model (2:4, mask_1d) of a Llama-2-7B decoder
    layer's seven projections (bf16, seed 0), one step of a decorated
    AdamW on a 1 x 512 forward (check_sparsity held on every projection,
    density 0.5), one LookAhead(AdamW, k=1) step (the slow weights
    taken) and a ModelAverage step with apply/restore on the same layer;
    then the geometric ops on a GEO_NODES x GEO_FEAT float32 graph with
    GEO_EDGES edges, card against CPU (sums and means within GEO_REL of
    the largest, max / min exact; seconds of each on the card)."""
    import paddle_tpu_torch.incubate as inc
    from paddle_tpu_torch import geometric as G
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.incubate import asp
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.models.llama import (LlamaDecoderLayer,
                                               _rope_tables)
    from paddle_tpu_torch.optimizer import AdamW

    tag = "incubate"
    _release()
    cfg = LlamaConfig.llama2_7b()
    layer = LlamaDecoderLayer(cfg, device=dev, dtype=torch.bfloat16)
    weights.init_random_(layer, seed=0)
    layer.train()
    projs = [m.weight for m in layer.modules()
             if type(m).__name__ == "Linear"]
    t0 = time.perf_counter()
    asp.prune_model(layer)
    torch.cuda.synchronize()
    prune_s = time.perf_counter() - t0
    cos, sin = (t[:512].to(dev) for t in _rope_tables(
        cfg.hidden_size // cfg.num_attention_heads, 512, cfg.rope_theta))
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    x = torch.randn(1, 512, cfg.hidden_size, generator=g, device=dev).to(
        torch.bfloat16)

    def loss():
        return layer(x, cos, sin).float().pow(2).mean()

    opt = asp.decorate(AdamW(1e-3, parameters=layer.parameters()))
    loss().backward()
    opt.step()
    opt.clear_grad()
    sparse = [asp.check_sparsity(w) for w in projs]
    dens = sorted({round(asp.calculate_density(w), 6) for w in projs})
    la = inc.LookAhead(AdamW(1e-3, parameters=layer.parameters()), k=1)
    ma = inc.ModelAverage(0.5, parameters=layer.parameters(),
                          min_average_window=2, max_average_window=2)
    before = projs[0].detach().clone()
    ma.step()
    la.minimize(loss())
    ma.step()
    moved = float((projs[0].float() - before.float()).abs().max())
    live = projs[0].detach().clone()
    with ma:
        avg = projs[0].detach().clone()
    restored = torch.equal(projs[0], live)
    want_avg = ((before.float() + live.float()) / 2).to(avg.dtype)
    avg_err = float((avg.float() - want_avg.float()).abs().max())
    print(f"[{tag}] Llama-2-7B decoder layer bf16: prune_model 2:4 of "
          f"{len(projs)} projections in {prune_s:.3f} s; after one "
          f"decorated AdamW step check_sparsity {sparse}, densities {dens};"
          f" LookAhead(k=1) step moved the first projection by "
          f"{moved:.3e}; ModelAverage over those 2 steps: applied average "
          f"max |diff| from (w1 + w2) / 2 {avg_err:.3e}, restored "
          f"{restored}", flush=True)
    if not all(sparse) or dens != [0.5] or not moved or not restored:
        raise AssertionError(f"[{tag}] sparsity {sparse} {dens}, LookAhead "
                             f"moved {moved}, restored {restored}")
    del layer, opt, la, ma, projs, x, before, live, avg, want_avg
    _release()
    rng = np.random.default_rng(7)
    xg = torch.from_numpy(rng.standard_normal(
        (GEO_NODES, GEO_FEAT), dtype=np.float32))
    yg = torch.from_numpy(rng.standard_normal(
        (GEO_EDGES, GEO_FEAT), dtype=np.float32))
    src = torch.from_numpy(rng.integers(0, GEO_NODES, GEO_EDGES))
    dst = torch.from_numpy(rng.integers(0, GEO_NODES, GEO_EDGES))
    seg = torch.sort(dst).values
    cases = [("send_u_recv", (xg, src, dst), {"reduce_op": r})
             for r in ("sum", "mean", "max", "min")]
    cases += [("send_ue_recv", (xg, yg, src, dst),
               {"message_op": "mul", "reduce_op": r})
              for r in ("sum", "max")]
    cases += [(f"segment_{r}", (yg, seg), {})
              for r in ("sum", "mean", "max", "min")]
    rows = {}
    for name, args, kw in cases:
        fn = getattr(G, name)
        want = fn(*args, **kw)
        dargs = [a.to(dev) for a in args]
        fn(*dargs, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(*dargs, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        err = float((got.cpu() - want).abs().max())
        exact = kw.get("reduce_op") in ("max", "min") or \
            name in ("segment_max", "segment_min")
        limit = 0.0 if exact else GEO_REL * float(want.abs().max())
        rows[f"{name}:{kw.get('reduce_op', '')}"] = [round(ms, 3),
                                                     float(f"{err:.3e}")]
        if got.device.type != "cuda" or err > limit:
            raise AssertionError(f"[{tag}] {name} {kw}: error {err} "
                                 f"(limit {limit})")
    print(f"[{tag}] geometric on {GEO_NODES} nodes x {GEO_FEAT} float32, "
          f"{GEO_EDGES} edges, card against CPU [ms on the card, max |diff|]"
          f" {json.dumps(rows)}", flush=True)
    _release()


def phase_text(dev):
    """[text]: viterbi_decode of VITERBI_SHAPE float32 potentials (seed 8)
    and 64 x 64 transitions, card against CPU: paths equal, scores within
    1e-5 of their largest; ms of the card's call (host clock)."""
    from paddle_tpu_torch import text

    tag = "text"
    b, t, n = VITERBI_SHAPE
    rng = np.random.default_rng(8)
    pot = torch.from_numpy(rng.standard_normal((b, t, n), dtype=np.float32))
    trans = torch.from_numpy(rng.standard_normal((n, n), dtype=np.float32))
    lens = torch.full((b,), t, dtype=torch.int64)
    t0 = time.perf_counter()
    ws, wp = text.viterbi_decode(pot, trans, lens)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    text.viterbi_decode(pot.to(dev), trans.to(dev), lens.to(dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gs, gp = text.viterbi_decode(pot.to(dev), trans.to(dev), lens.to(dev))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    err = float((gs.cpu() - ws).abs().max() / ws.abs().max())
    same = torch.equal(gp.cpu(), wp)
    print(f"[{tag}] viterbi_decode batch {b}, {t} steps, {n} tags: paths "
          f"equal {same}, scores rel err {err:.2e}; ms card {ms:.2f}, CPU "
          f"{cpu_ms:.2f}", flush=True)
    if not same or err > 1e-5 or gp.device.type != "cuda":
        raise AssertionError(f"[{tag}] card and CPU disagree")


def phase_audio(dev):
    """[audio]: LogMelSpectrogram and MFCC (sr 44100, the layers' other
    defaults) of AUDIO_CLIPS clips of AUDIO_SECONDS s (ESC-50's format;
    tones plus noise from seed 9), card against CPU within AUDIO_DB_ATOL
    dB; ms of each on the card (host clock)."""
    from paddle_tpu_torch import audio

    tag = "audio"
    n = AUDIO_SR * AUDIO_SECONDS
    rng = np.random.default_rng(9)
    t = np.arange(n) / AUDIO_SR
    clips = np.stack([0.4 * np.sin(2 * np.pi * (110.0 * (i + 1)) * t)
                      + 0.05 * rng.standard_normal(n)
                      for i in range(AUDIO_CLIPS)]).astype(np.float32)
    x = torch.from_numpy(clips)
    out = {}
    for name in ("LogMelSpectrogram", "MFCC"):
        cpu_layer = getattr(audio, name)(sr=AUDIO_SR, device="cpu")
        want = cpu_layer(x)
        layer = getattr(audio, name)(sr=AUDIO_SR, device=dev)
        xd = x.to(dev)
        layer(xd)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = layer(xd)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        err = float((got.cpu() - want).abs().max())
        out[name] = [list(got.shape), round(ms, 3), float(f"{err:.3e}")]
        if got.device.type != "cuda" or err > AUDIO_DB_ATOL or \
                not bool(torch.isfinite(got).all()):
            raise AssertionError(f"[{tag}] {name}: max |diff| {err} dB")
    print(f"[{tag}] {AUDIO_CLIPS} clips of {AUDIO_SECONDS} s at "
          f"{AUDIO_SR} Hz, card against CPU [shape, ms on the card, max "
          f"|diff| dB] {json.dumps(out)} (tolerance {AUDIO_DB_ATOL} dB)",
          flush=True)
    _release()


# ----------------------------------------------------------------------
# slice 25: the multi-process world, context parallelism, the auto-tuner
# ----------------------------------------------------------------------

# [dist:launch]: GPT-3 1.3B's widths (GPTConfig.gpt3_1p3b(), [train:hybrid]'s
# seed-0 weights and 4 x 2048 batch) at DIST_LAYERS of its 24 layers, two
# workers started by the launch CLI on the one card over gloo, each on its
# half of the batch: DIST_STEPS AdamW steps (the first also the warm-up)
# under DataParallel with ZeRO stage 2, then save_checkpoint(world_size=2).
# Depth: 12 of 24 (at 24 the phase took 96.9 s on an NVIDIA H100 80GB
# HBM3 at 700 W: 10.4 s a step, 9.5 of it gloo's reduce-scatter and
# all-gather of 2.6 GB each through the host)
DIST_LAYERS = 12
DIST_STEPS = 3
DIST_DIR = "build/dist_smoke"
DIST_TIMEOUT_S = 600
DIST_SAVE_STEP = DIST_STEPS
DIST_RANK1_DELAY_S = 1.0     # rank 1 saves later: the barrier must wait
DIST_PER_STEP = {"flash_attention": DIST_LAYERS,
                 "flash_attention_bwd": DIST_LAYERS,
                 "flash_attention.sm90": DIST_LAYERS,
                 "flash_attention_bwd.sm90": DIST_LAYERS}

DIST_WORKER = r'''
"""A [dist:launch] worker: one rank of the gloo world on the card. It
imports, then waits for the go file before it touches the card."""
import json, os, sys, time
T0 = float(os.environ["DIST_T0"])
sys.path.insert(0, os.environ["DIST_REPO"])
import numpy as np
import torch
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import weights
from paddle_tpu_torch.distributed import checkpoint as ck
from paddle_tpu_torch.distributed import multihost
from paddle_tpu_torch.distributed import parallel_base as pb
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.optimizer import AdamW

cfg_in = json.loads(os.environ["DIST_CFG"])
imported = time.time() - T0
while not os.path.exists(cfg_in["go"]):
    time.sleep(0.05)
T1 = time.time()
if not torch.cuda.is_available():
    print("[dist:launch] worker: no CUDA device", flush=True)
    sys.exit(3)
dist.init_parallel_env()
rank, dev = dist.get_rank(), pb.WORLD.device
assert dev.type == "cuda", dev
res = {"rank": rank, "device": str(dev), "backend": dist.get_backend(),
       "import_s": imported, "world_s": time.time() - T1}
res["reduce_value"] = [float(multihost.all_reduce_value(float(rank + 1), op))
                       for op in ("sum", "max")]
assert res["reduce_value"] == [3.0, 2.0], res["reduce_value"]

cfg = GPTConfig.gpt3_1p3b()
cfg.num_hidden_layers = cfg_in["layers"]
torch.backends.cuda.matmul.allow_tf32 = False
model = GPTForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
weights.init_random_(model, seed=0)
model.train()
rng = np.random.default_rng(1)
ids, lab = (torch.from_numpy(rng.integers(0, cfg.vocab_size, tuple(
    cfg_in["batch"]))).to(dev) for _ in range(2))
rows = cfg_in["batch"][0] // 2
ids, lab = ids[rank * rows:(rank + 1) * rows], lab[rank * rows:(rank + 1) * rows]
dp = dist.DataParallel(model)
opt = AdamW(cfg_in["lr"], parameters=model.parameters(), multi_precision=True)
dist.shard_optimizer(opt, dist.ShardingStage2(
    "dp", dist.ProcessMesh([0, 1], ["dp"])))
res["n_params"] = sum(p.numel() for p in model.parameters())
res["setup_s"] = time.time() - T1


def ce(logits, labels):
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


losses, ms, stats, launches = [], [], [], []
for i in range(cfg_in["steps"]):
    K.reset_launch_counts()
    pb.reset_proc_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    loss = ce(dp(ids), lab)
    loss.backward()
    opt.step()
    opt.clear_grad()
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t) * 1e3)
    stats.append(pb.proc_stats())
    c = K.launch_counts()
    launches.append({k: c[k] for k in cfg_in["per_step"]})
    losses.append(float(multihost.all_reduce_value(float(loss.detach()),
                                                   "mean")))
res.update(losses=losses, step_ms=ms, proc_stats=stats, launches=launches,
           state_bytes=opt._zero.state_bytes(),
           peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)

root = cfg_in["ckpt"]
state = {n: p for n, p in model.named_parameters()}
if rank == 1:
    time.sleep(cfg_in["rank1_delay"])
res["latest_before"] = ck.read_latest(root)
t = time.time()
ck.save_checkpoint(state, root, cfg_in["save_step"], world_size=2,
                   rank=rank, barrier_timeout=300.0)
res["save_s"] = time.time() - t
res["save_done_at"] = time.time()
dist.barrier()
res["wall_s"] = time.time() - T0
res["after_go_s"] = time.time() - T1
json.dump(res, open(os.path.join(cfg_in["out"], f"rank{rank}.json"), "w"))
dist.destroy_process_group()
print("[dist:launch] worker done", rank, flush=True)
'''


def _dist_free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _opt_state_bytes(opt):
    """(bytes of an unsharded optimizer's accumulators and masters, the
    bytes of its one-element accumulators: the beta powers, which every
    ZeRO owner keeps a copy of)."""
    accs = [t for a in opt._accumulators.values() for t in a.values()]
    n = sum(t.numel() * t.element_size() for t in accs)
    n += sum(t.numel() * t.element_size()
             for t in opt._master_weights.values())
    return n, sum(t.element_size() for t in accs if t.numel() == 1)


def _start_dist_workers(workdir, cfg):
    """Two launch-CLI processes (node ranks 0 and 1) running DIST_WORKER
    with `cfg`; they import, then wait for cfg["go"] to exist."""
    import shutil
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    worker = os.path.join(workdir, "worker.py")
    with open(worker, "w") as f:
        f.write(DIST_WORKER)
    port = _dist_free_port()
    t0 = time.time()
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, DIST_T0=repr(t0), DIST_REPO=repo,
               DIST_CFG=json.dumps(cfg),
               PYTHONPATH=os.pathsep.join(
                   [repo] + [x for x in [os.environ.get("PYTHONPATH")]
                             if x]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nnodes", "2", "--rank", str(r), "--master",
         f"127.0.0.1:{port}", "--log_dir", os.path.join(workdir, f"log{r}"),
         worker], env=env) for r in range(2)]
    return procs, t0


def _finish_dist_workers(tag, workdir, procs, t0, timeout):
    """Wait for the workers; returns each rank's result and its launcher's
    wall seconds. Kills both on any failure or timeout."""
    walls = [None, None]
    try:
        deadline = time.time() + timeout
        while None in walls:
            for r, p in enumerate(procs):
                if p.poll() is not None and walls[r] is None:
                    walls[r] = time.time() - t0
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.time() > deadline:
                raise AssertionError(f"[{tag}] workers still running after "
                                     f"{timeout} s")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if codes != [0, 0]:
        tails = {}
        for r in range(2):
            log = os.path.join(workdir, f"log{r}", f"workerlog.{r}.0")
            if os.path.exists(log):
                tails[r] = open(log).read()[-3000:]
        raise AssertionError(f"[{tag}] worker exit codes {codes}: {tails}")
    out = [json.load(open(os.path.join(workdir, f"rank{r}.json")))
           for r in range(2)]
    return out, [w if w is not None else time.time() - t0 for w in walls]


def phase_dist_launch(K, dev):
    """[dist:launch]: two workers started by `python -m
    paddle_tpu_torch.distributed.launch --nnodes 2 --rank r --master
    127.0.0.1:<port>` on the card, joined over gloo (NCCL refuses two
    ranks on one device). While they import, this process runs the
    reference: GPT-3 1.3B's widths at DIST_LAYERS layers, seed-0 weights
    ([train:hybrid]'s rule), the 4 x 2048 batch's two halves accumulated
    (`_gpt_ref_run` with 2 micro-batches, AdamW(HYBRID_LR,
    multi_precision)); then it frees the card and lets them go. Each
    worker checks multihost.all_reduce_value (sum 3, max 2), builds the
    same model, takes its half of the batch and runs DIST_STEPS steps
    under DataParallel with ZeRO stage 2 (each rank's gradients to their
    owners by a reduce-scatter, the new slices back by an all-gather),
    then save_checkpoint(world_size=2) through the commit barrier, rank 1
    DIST_RANK1_DELAY_S later. Held: both workers exit 0 on the card; each
    step's mean loss equal to the reference's within SAME_REL (the same
    arithmetic: bf16 gradients summed once over two ranks and halved,
    which is exact, equal the accumulated halves; bit-equality printed);
    DIST_PER_STEP flash launches a step on each rank, sm90; each rank's
    optimizer state half of the one process's, plus its own copy of the
    beta powers; LATEST written after both ranks' progress files and
    absent before. Returns the flash launches of both ranks' steps after
    the first."""
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.distributed import checkpoint as ck
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    tag = "dist:launch"
    _release()
    ckpt = os.path.join(DIST_DIR, "ckpt")
    go = os.path.join(DIST_DIR, "go")
    cfg = {"layers": DIST_LAYERS, "batch": list(TRAIN22_BATCH),
           "lr": HYBRID_LR, "steps": DIST_STEPS, "ckpt": ckpt,
           "out": DIST_DIR, "save_step": DIST_SAVE_STEP, "go": go,
           "rank1_delay": DIST_RANK1_DELAY_S, "per_step": DIST_PER_STEP}
    t0 = time.perf_counter()
    procs, t_start = _start_dist_workers(DIST_DIR, cfg)
    try:
        gcfg = GPTConfig.gpt3_1p3b()
        gcfg.num_hidden_layers = DIST_LAYERS
        model = GPTForCausalLM(gcfg, device=dev, dtype=torch.bfloat16)
        weights.init_random_(model, seed=0)
        model.train()
        init = {n: p.detach().clone() for n, p in model.named_parameters()}
        batch = _train_batch(gcfg.vocab_size, *TRAIN22_BATCH, dev)
        st = {}
        ref_losses, ref_ms = _gpt_ref_run(model, init, batch, 2, DIST_STEPS,
                                          st)
        ref_s = time.perf_counter() - t0
        del model, init, batch
        _release()
        open(go, "w").close()
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise
    out, walls = _finish_dist_workers(tag, DIST_DIR, procs, t_start,
                                      DIST_TIMEOUT_S)
    wall = time.perf_counter() - t0
    ref_bytes, pow_bytes = st["state_bytes"], st["scalar_bytes"]
    for r, res in enumerate(out):
        if not res["device"].startswith("cuda") or res["backend"] != "gloo":
            raise AssertionError(f"[{tag}] rank {r} ran on {res['device']} "
                                 f"over {res['backend']}")
        for i, got in enumerate(res["launches"]):
            if got != DIST_PER_STEP:
                raise AssertionError(f"[{tag}] rank {r} step {i} launched "
                                     f"{got}, expected {DIST_PER_STEP}")
    losses = out[0]["losses"]
    same = [_rel(a, b) for a, b in zip(losses, ref_losses)]
    print(f"[{tag}] GPTConfig.gpt3_1p3b() at {DIST_LAYERS} of 24 layers, "
          f"{out[0]['n_params']} parameters, two processes on one card "
          f"({out[0]['device']}, {out[1]['device']}) over "
          f"{out[0]['backend']}, each 2 x 2048 of the 4 x 2048 batch; "
          f"DataParallel + ZeRO stage 2, AdamW({HYBRID_LR}, "
          f"multi_precision=True); all_reduce_value sum/max "
          f"{out[0]['reduce_value']}", flush=True)
    print(f"[{tag}] losses (warm-up first) rank0 {losses} rank1 "
          f"{out[1]['losses']}; one process, the two halves accumulated "
          f"{ref_losses}: relative {[f'{x:.3e}' for x in same]} (bit-equal "
          f"{losses == ref_losses})")
    for r, res in enumerate(out):
        ms = res["step_ms"]
        last = res["proc_stats"][-1]
        per_op = {op: {"calls": v["calls"], "bytes": v["bytes"],
                       "s": round(v["seconds"], 4),
                       "host_staged_bytes": v["staged_bytes"]}
                  for op, v in sorted(last.items())}
        print(f"[{tag}] rank {r}: step_ms (host clock, ends in a sync) "
              f"{[round(x, 1) for x in ms]} median_timed="
              f"{_median(ms[1:]):.1f} (one process, accumulated: "
              f"{ref_ms:.1f}); gloo a step by op {json.dumps(per_op)}; "
              f"host-staged bytes a step "
              f"{sum(v['staged_bytes'] for v in last.values())}; flash "
              f"launches a step {json.dumps(res['launches'][-1])}; peak "
              f"{res['peak_gb']:.2f} GB; start-up: launcher and worker "
              f"imports {res['import_s']:.1f} s (beside the reference), "
              f"from the go to the gloo world {res['world_s']:.1f} s, to "
              f"the model, DataParallel and ZeRO {res['setup_s']:.1f} s; "
              f"worker wall {res['wall_s']:.1f} s ({res['after_go_s']:.1f}"
              f" s after the go), launcher wall {walls[r]:.1f} s; "
              f"save_checkpoint {res['save_s']:.2f} s", flush=True)
    local = [res["state_bytes"]["local"] for res in out]
    print(f"[{tag}] optimizer state (float32 masters and moments, beta "
          f"powers) bytes per rank {local} against one process's "
          f"{ref_bytes}, of which {pow_bytes} the beta powers each owner "
          f"copies (replicated "
          f"{[res['state_bytes']['replicated'] for res in out]}); the "
          f"reference {ref_s:.1f} s beside the workers' imports")
    prog = [ck.read_progress(ckpt, r) for r in range(2)]
    mt = [os.path.getmtime(os.path.join(ckpt, f".progress.{r}"))
          for r in range(2)]
    latest_mt = os.path.getmtime(os.path.join(ckpt, ck.LATEST_FILE))
    latest = ck.read_latest(ckpt)
    ok, reason = ck.verify_checkpoint(ck.checkpoint_dir(ckpt,
                                                        DIST_SAVE_STEP))
    print(f"[{tag}] commit barrier: progress {prog}, LATEST {latest[0]} "
          f"written {latest_mt - max(mt):.3f} s after the last progress "
          f"post (rank 1's, {mt[1] - mt[0]:.3f} s after rank 0's); LATEST "
          f"before the saves {out[0]['latest_before']}; step directory "
          f"verified {ok}; phase wall {wall:.1f} s", flush=True)
    if max(same) > SAME_REL:
        raise AssertionError(f"[{tag}] losses {losses} against the one-"
                             f"process run {ref_losses}")
    if out[1]["losses"] != losses:
        raise AssertionError(f"[{tag}] the ranks' mean losses differ")
    if local[0] != local[1] or 2 * local[0] != ref_bytes + pow_bytes or \
            any(res["state_bytes"]["replicated"] for res in out):
        raise AssertionError(f"[{tag}] state bytes {local}: not half of "
                             f"{ref_bytes} (+ the powers {pow_bytes}) each")
    if prog != [("-", DIST_SAVE_STEP)] * 2 or latest[0] != DIST_SAVE_STEP \
            or latest_mt < max(mt) or out[0]["latest_before"] is not None \
            or not ok:
        raise AssertionError(f"[{tag}] the commit: progress {prog}, LATEST "
                             f"{latest} at {latest_mt} against posts {mt}, "
                             f"before {out[0]['latest_before']}, {reason}")
    import shutil
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    totals = dict.fromkeys(K.launch_counts(), 0)
    for res in out:
        for step in res["launches"][1:]:
            for k, n in step.items():
                totals[k] += n
    return totals


# [ring]: Llama-2-7B's attention widths (32 heads of 128) over a 16384-token
# sequence, bf16, on a 4-rank sp / sep ProcessMesh of the one card
RING_SHAPE = (1, 16384, 32, 128)
RING_N = 4
RING_TIMED = 3
# The ring against flash over the whole sequence. Both end in a bf16
# rounding of nearly equal float32 values, which can land one bf16 ulp
# apart: 2^-7 |whole|. Before it the ring rounds P to bf16 against each
# block's own maximum (the whole-sequence kernel against its running one)
# and each block's output to bf16 before the float32 lse merge (the
# kernel writes it so): errors of 2^-9 of a block output, itself about
# sqrt(n) times the whole's scale, at the tensor's scale. So the output
# and the gradients are held alike, to c1 |whole| + c2 rms(whole), c2 a
# few such roundings: the output's from the worst the card read (see the
# [ring] line "floor read"), the gradients' eight bf16 roundings (their
# visited blocks' bf16 shares summed in float32 where the whole-sequence
# kernel rounds once, over P and dS rounded against the blocks' own
# tiles). The phase also holds two wrong rings against the output's rule:
# one that drops a block (a quarter of the keys, ~2^-1 rms) and one that
# averages the blocks without their lse weights; both must fail it.
RING_OUT_RULE = (2.0 ** -7, 2.0 ** -5)
RING_GRAD_RULE = (2.0 ** -6, 2.0 ** -5)
RING_CASES = (("ring", True, 10), ("ring", False, 16), ("ulysses", True, 4))


def _ring_worst(got, want, rule):
    """max over elements of |got - want| / (rule[0] |want| + rule[1]
    rms(want)), the rms over the tensor."""
    g, w = got.float(), want.float()
    allowed = rule[0] * w.abs() + rule[1] * w.square().mean().sqrt()
    return float(((g - w).abs() / allowed.clamp_min(1e-30)).max())


def _ring_floor(got, want, rel):
    """max over elements of (|got - want| - rel |want|) / rms(want): the
    least c2 with which (rel, c2) holds got."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() - rel * w.abs()).max()
                 / w.square().mean().sqrt())


def _ring_mutants(K, q, k, v, causal):
    """Two wrong rings over RING_N shards, from the same flash blocks as
    the ring's: one that drops each query shard's last visited block
    (where it visits two or more), and one that averages the blocks'
    outputs without their lse weights."""
    from paddle_tpu_torch.ops import ring_attention as ring
    qs, ks, vs = (t.chunk(RING_N, dim=1) for t in (q, k, v))
    dropped, unweighted = [], []
    for i in range(RING_N):
        blocks = [K.flash_attention_fwd(qs[i], ks[j], vs[j],
                                        causal=causal and j == i)
                  for j in ring._order(i, RING_N, causal)]
        acc = lse = None
        for o, l in blocks[:max(1, len(blocks) - 1)]:
            acc, lse = ring._merge_lse(acc, lse, o, l)
        dropped.append(acc.to(q.dtype))
        unweighted.append(torch.stack([o.float() for o, _ in blocks])
                          .mean(0).to(q.dtype))
    return torch.cat(dropped, dim=1), torch.cat(unweighted, dim=1)


def phase_ring(K, dev):
    """[ring]: ring_flash_attention (causal and not) and ulysses_attention
    (causal) at RING_SHAPE bf16 over a RING_N-rank ProcessMesh on the card
    (every rank's shard a tensor of its own), forward and backward
    (autograd: the ring's backward runs flash_attention_bwd a visited
    block with the merged out and lse), held against flash_attention_fwd /
    _bwd over the whole sequence by RING_OUT_RULE / RING_GRAD_RULE. Each
    call's flash launches by direction and route are held: the causal ring
    runs 10 of its 16 blocks each way (the later blocks add exactly
    nothing), the non-causal one 16, Ulysses one a rank. Prints ms forward
    and backward (CUDA events, median of RING_TIMED after a warm-up) and
    peak memory. Returns the launches of one forward + backward of each
    case."""
    from paddle_tpu_torch.distributed import ProcessMesh
    from paddle_tpu_torch.ops import ring_attention as ring

    tag = "ring"
    _release()
    gen = torch.Generator(device=dev)
    gen.manual_seed(25)
    # the comparisons' own launches (whole-sequence flash, the wrong
    # rings' blocks) are made before the counted calls
    q, k, v, do = (torch.randn(RING_SHAPE, generator=gen, device=dev,
                               dtype=torch.bfloat16) for _ in range(4))
    totals = dict.fromkeys(K.launch_counts(), 0)
    want, wrongs = {}, {}
    for causal in (True, False):
        out, lse = K.flash_attention_fwd(q, k, v, causal=causal)
        wrong = [_ring_worst(m, out, RING_OUT_RULE)
                 for m in _ring_mutants(K, q, k, v, causal)]
        print(f"[{tag}] wrong rings (causal={causal}) against the output "
              f"rule: a dropped block {wrong[0]:.3f}, an unweighted merge "
              f"{wrong[1]:.3f} of the allowance", flush=True)
        wrongs[causal] = wrong
        want[causal] = (out, K.flash_attention_bwd(q, k, v, out, lse, do,
                                                   causal=causal))
    for name, causal, n_blocks in RING_CASES:
        axis = "sp" if name == "ring" else "sep"
        fn = ring.ring_flash_attention if name == "ring" else \
            ring.ulysses_attention
        mesh = ProcessMesh(list(range(RING_N)), [axis], devices=dev)
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        fwd_ms, bwd_ms = [], []
        for i in range(RING_TIMED + 1):
            for t in ts:
                t.grad = None
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            e[0].record()
            out = fn(*ts, mesh, axis, causal=causal)
            e[1].record()
            out.backward(do)
            e[2].record()
            torch.cuda.synchronize()
            fwd_ms.append(e[0].elapsed_time(e[1]))
            bwd_ms.append(e[1].elapsed_time(e[2]))
            counts = K.launch_counts()
            if i == 0:
                first = counts
        peak = torch.cuda.max_memory_allocated() / 1e9
        launches = {k_: first[k_] for k_ in (
            "flash_attention", "flash_attention.sm90",
            "flash_attention.simt", "flash_attention_bwd",
            "flash_attention_bwd.sm90", "flash_attention_bwd.simt")}
        expect = {"flash_attention": n_blocks,
                  "flash_attention.sm90": n_blocks,
                  "flash_attention.simt": 0,
                  "flash_attention_bwd": n_blocks,
                  "flash_attention_bwd.sm90": n_blocks,
                  "flash_attention_bwd.simt": 0}
        if launches != expect or counts != first:
            raise AssertionError(f"[{tag}] {name} causal={causal} launched "
                                 f"{launches} (then {counts}), expected "
                                 f"{expect}")
        for k_ in totals:
            totals[k_] += first[k_]
        w_out, w_grads = want[causal]
        floor = _ring_floor(out.detach(), w_out, RING_OUT_RULE[0])
        worst = [_ring_worst(out.detach(), w_out, RING_OUT_RULE)] + [
            _ring_worst(t.grad, g, RING_GRAD_RULE)
            for t, g in zip(ts, w_grads)]
        errs = [_max_err(out.detach(), w_out)] + [
            _max_err(t.grad, g) for t, g in zip(ts, w_grads)]
        print(f"[{tag}] {name} causal={causal} {list(RING_SHAPE)} bf16 over "
              f"{RING_N} ranks on one card: fwd_ms {_median(fwd_ms[1:]):.3f}"
              f" bwd_ms {_median(bwd_ms[1:]):.3f} (medians of {RING_TIMED};"
              f" warm-up {fwd_ms[0]:.3f} / {bwd_ms[0]:.3f}); flash launches "
              f"a call {json.dumps(launches)}; peak {peak:.2f} GB; against "
              f"whole-sequence flash: max|err| out/dq/dk/dv "
              f"{[f'{x:.3e}' for x in errs]}, worst err/allowed "
              f"{[f'{x:.3f}' for x in worst]}; out floor read "
              f"{floor:.3e} rms", flush=True)
        if max(worst) > 1.0:
            raise AssertionError(f"[{tag}] {name} causal={causal}: "
                                 f"err/allowed {worst}")
        del out, ts
    print(f"[{tag}] rules: out |ring - whole| <= {RING_OUT_RULE[0]} "
          f"|whole| + {RING_OUT_RULE[1]} rms(whole); gradients <= "
          f"{RING_GRAD_RULE[0]} |whole| + {RING_GRAD_RULE[1]} rms(whole) (P "
          f"rounded to bf16 against each block's own maximum; block "
          f"outputs rounded to bf16 before the lse merge)", flush=True)
    if min(min(w) for w in wrongs.values()) <= 1.0:
        raise AssertionError(f"[{tag}] the output rule {RING_OUT_RULE} "
                             f"holds a wrong ring: {wrongs}")
    del q, k, v, do, want
    _release()
    return totals


def phase_auto_tuner(base):
    """[auto_tuner]: the port's auto-tuner with the h100 profile predicts
    [train]'s configuration (TRAIN_CFG, batch TRAIN_BATCH x TRAIN_SEQ, one
    device, no recompute, AdamW with float32 masters: ZeRO stage 1 over
    one rank) against [train]'s measured median step and peak memory from
    this call (`base`); prints the ratios against the JAX package's
    validation factors (5.0 in time, 2.5 in memory,
    tests/test_auto_tuner_validation.py:27-28). No extra training run."""
    from paddle_tpu_torch.distributed import auto_tuner as at

    tag = "auto_tuner"
    cfg = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
           "sharding_degree": 1, "micro_batch_size": TRAIN_BATCH,
           "recompute": False}
    n = base["n_params"]
    layers, hidden = TRAIN_CFG["num_hidden_layers"], TRAIN_CFG["hidden_size"]
    cm = at.CostModel(n, layers, hidden, hardware="h100")
    mm = at.MemoryCostModel(n, layers, hidden, vocab=TRAIN_CFG["vocab_size"])
    t_pred = cm.step_time(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_BATCH,
                          recompute=False) * 1e3
    m_pred = mm.estimate(cfg, TRAIN_BATCH, TRAIN_SEQ, recompute=False,
                         sharding_stage=1)
    t_meas, m_meas = base["median_ms"], base["peak_gb"] * 1e9
    t_ratio = max(t_pred, t_meas) / min(t_pred, t_meas)
    m_ratio = max(m_pred, m_meas) / min(m_pred, m_meas)
    tuner = at.AutoTuner(8, n, TRAIN_SEQ, hidden, layers, global_bsz=16,
                         vocab=TRAIN_CFG["vocab_size"],
                         n_heads=TRAIN_CFG["num_attention_heads"])
    best = tuner.search(top_k=1)[0]
    print(f"[{tag}] h100 profile {at.HARDWARE['h100']} (TFLOP/s, GB, GB/s; "
          f"mfu_assumed 0.45): [train] ({n} parameters, {layers} layers, "
          f"hidden {hidden}, {TRAIN_BATCH} x {TRAIN_SEQ}) predicted "
          f"{t_pred:.2f} ms and {m_pred / 1e9:.2f} GB against the measured "
          f"median {t_meas:.2f} ms and peak {m_meas / 1e9:.2f} GB: ratios "
          f"{t_ratio:.3f} (JAX's bound 5.0: "
          f"{'holds' if t_ratio <= 5.0 else 'does not hold'}) and "
          f"{m_ratio:.3f} (2.5: "
          f"{'holds' if m_ratio <= 2.5 else 'does not hold'}); an 8-card "
          f"search's best {json.dumps(best)}", flush=True)
    return {"t_ratio": t_ratio, "m_ratio": m_ratio}


if __name__ == "__main__":
    sys.exit(main())
