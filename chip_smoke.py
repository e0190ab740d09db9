#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``apex_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. build — nvcc builds every CUDA source (layer norm, flash attention,
   softmax cross entropy, fused softmax, the multi-tensor kernels, the
   int8 weight-only matmuls, the threefry bits and dropout, the paged
   decode and verify attention; one process per source, all at once); TF32
   is switched off so fp32 products and convolutions are full fp32.
2. kernel parity — each kernel against its plain PyTorch version on the
   same card inputs, max error beside the stated tolerance: the
   forwards of the serving path, then the LayerNorm and flash-attention
   backward kernels and the softmax cross entropy at the training
   path's shapes, held per element to their modules' error models (the
   bf16 flash forward, dq and dk/dv, on the tensor cores, also at
   ragged s, one row either side of the 64-row q tile and a causal run
   whose last q tile holds one row, d = 48, 100 and 128, dropout 0.1
   and 0.5, GPT and BERT views, by both load variants; the LayerNorm
   backward also at ragged h, 1000 and 1001; a second launch gives the
   same bits; the dropout keep masks read off the forward and dk/dv
   equal the plain mask); the
   fused softmax forwards (masked, causal) and backward, per element to
   their error model (uint8 and int32 masks read as vectors, a strided
   and a per-query mask, a query count off the block's rows, sk 130 and
   3000 on the generic path, a fully masked batch uniform at 1/sk, a
   repeat the same bits); ``flat_adam`` on BERT-Large's flat buffer, bit for
   bit; on the same buffer (336,232,448 elements) ``flat_scale`` and
   ``flat_axpby`` (outputs and finite flags bit for bit, with an
   injected inf and NaN), ``flat_l2norm_partials`` (to the sum-of-squares
   model, and the same bits on a repeat) and LAMB's stage 1 (m, v and u
   bit for bit, its partials to that model, the params through stage 2
   to ``lamb_p_limit``; found_inf writes the old values; two
   ``flat_lamb`` calls give the same bits); ``flat_sgd`` (five cases:
   first run, dampening, Nesterov, ``wd_after_momentum``, no momentum;
   each with an fp32 and a bf16 buffer, the latter with the cast-out),
   ``flat_adagrad`` (both modes, with and without the cast-out) and
   ``flat_novograd`` (fp32 m, and bf16 m with the cast-out;
   ``reg_inside_moment`` both ways; step 1 and step 2), all in place, bit
   for bit and the same bits on a repeat, found_inf leaving params and
   state as they were, NovoGrad's per-tensor v through the partials
   kernel to the sum-of-squares model; the int8 weight-only matmuls
   (``w8_matmul`` with and without bias, ``w8_matmul_nk``) at GPT-2
   medium's decode shapes and its prefill buckets M 128, 512 and 1024
   (bf16 x there on the tensor cores), M 37 and 100, a ragged shape and
   an x view 2 bytes past a 16-byte boundary, the logits head at M 1, 3
   and 8 (bf16 x on the tensor cores; N off its tile, K off its loads, an
   unaligned x), row 21 (no bias) at the tensor-parallel Row linears'
   M 8, K 512 and 2048 into N 1024 in fp32 and bf16 x, per element to
   ``quant.kernels.w8_limit``, two launches
   the same bits, and every call at M <= 8 the same bits across two
   CUDA-graph replays. The
   LayerNorm forward also at ragged h, at teams of several warps and on
   an unaligned row base. The threefry streams (``utils.prng``): a table
   of jax 0.9.0's known answers as constants; the bits kernel bit for bit
   against its plain int64 version at 1 and 3 words, the decode tick's 8
   keys x 50304 and one key over (64, 128, 1024); the fused dropout (fp32
   and bf16, BERT-Large's hidden shape and its unfused probabilities) bit
   for bit, twice and under a CUDA-graph replay. The sampler:
   ``sample_tokens`` on the card against the CPU on (8, 50304) logits at
   temperatures 0, 0.7 and 1.3 with top_k 50, top_p 0.9 and both: the
   same tokens, or a flip inside the gumbel error model.
3. serving — GPT-2 medium (h 1024, 24 layers, 16 heads, vocab 50304),
   random weights from seed 0, O2-cast to bf16, served by the port's
   ``DecodeEngine`` + ``ContinuousBatchingScheduler`` (8 slots, max_len
   1024): 16 greedy requests of 32 tokens. The kernels' launch counts
   are set to 0 before this run and read after it. Then the headline
   serving contract: decode logits over 4 steps equal the full
   forward's at the same positions (fp32 and bf16). The weight-only
   int8 path (``serving_w8``): the fp32 params quantized
   (``quantize_params``) and served with fp32 compute and cache, 4
   decode steps against the full forward of the dequantized tree; then
   the same 16 requests on the quantized O2 params with bf16 compute,
   counts set to 0 before and read after, exact launches of every
   kernel. ``serving_sampled``: the 16 requests on the O2 params with
   the odd ones sampled at temperature 0.8 (seed = index) on
   ``DecodeEngine(top_k=50)``, twice: the replay commits the same
   streams; the bits kernel once a sampled prefill and at most once a
   decode tick.
4. training — BERT-Large width (h 1024, 16 heads, ffn 4096, vocab
   30522). (a) Two layers, batch 8, seq 128: one step of
   ``make_bert_train_step`` on the card (kernels) against the same step
   on the CPU (plain versions) from the same weights, in O0 (fp32) and
   in O2 (the LAMB master per element to ``lamb_master_limit``, each
   side's step recomputed in float64). (b) All 24 layers, O2 with the dynamic loss scaler, batch 64,
   seq 128 (the JAX headline's shape): 6 steps on one fixed batch in
   each optimizer-state mode (``fp32``, ``bf16m_castout``), counts set
   to 0 before each run and read after it; losses finite and falling,
   no overflow, exact launches per step. Both (a) and (b) run three
   configurations: ``flash_tree``, flash attention with the tree-path
   FusedAdam; ``softmax_flat``, the unfused attention
   (``fused_attention=False``: the fused softmax kernels) with the flat
   FusedAdam (``use_flat_kernel=True``: one ``flat_adam`` kernel a
   step); ``flash_lamb_flat``, flash attention with the flat FusedLAMB
   (``FusedLAMB(lr=1e-3, weight_decay=0.01, use_flat_kernel=True)``: one
   ``flat_l2norm_partials`` and one ``flat_lamb_stage1`` a step). With
   dropout (``dropout_rng``): (a) again in ``flash_tree`` and
   ``softmax_flat`` at the unchanged limits (the masks are the same bits
   on both devices), and (b) six ``flash_tree`` steps in the fp32 mode
   with hidden and attention dropout 0.1, the dropout kernel 2 (L + 1)
   times a step.
5. ResNet training — ``examples/imagenet/main_amp.py``'s step
   (``make_resnet_train_step``) in three configurations:
   ``resnet_tree_o0`` (the JAX example's defaults, the tree-path
   FusedSGD), ``resnet_flat_o0`` (``use_flat_kernel=True``: one
   ``flat_sgd`` a step) and ``resnet_flat_o2`` (amp O2, dynamic loss
   scale, bf16 convolutions, fp32 BatchNorm leaves). (a) ResNet-50 at
   full width and depth, batch 4, 64 x 64, 1000 classes: one step on
   the card against the same step on the CPU from the same weights and
   batch, each held to the same step run in float64 on the CPU (loss,
   gradients and statistics: the card no further from it than 4 times
   the CPU in O0, 1.5 times in O2, since this random-init ResNet-50
   leaves any fp32 gradient far from float64 at this size), master and
   momentum buffer per element to ``sgd_master_limit``. (b) ResNet-50,
   batch 64, 224 x 224, lr 0.025 (the example's 0.1 scaled to batch 64):
   six steps of each configuration on one fixed synthetic batch, counts set
   to 0 before each run and read after it; losses finite and falling,
   exact launches (``flat_sgd`` once a step in the flat configurations,
   nothing else), the overflow count and the median step time.
6. optimizer steps — ``FusedSGD``, ``FusedAdagrad`` and
   ``FusedNovoGrad`` take three flat steps each on BERT-Large's fp32
   tree with seeded gradients, against the same optimizer's tree path
   on the card (SGD and Adagrad bit for bit, NovoGrad per element to its
   error model), exact launches a step.
7. times — each kernel at its path's shapes (the LayerNorm forward at
   (1024, 1024), (8, 1024) and the BERT O2 (8192, 1024); the w8 kernels at M
   8, 128 (rows 21-22), 1 (row 23, a prefill's logits) and 1024, rows 21-22
   also beside the bf16 serving linear on the dequantized weights;
   ``flat_sgd`` on ResNet-50's flat buffer and on BERT-Large's; the flash
   forward on contiguous tensors and on the GPT prefill's ``_split_qkv``
   views), its plain version, one library call computing the same function
   (device time: 20 calls captured in one CUDA graph, 3 for the flat kernels,
   replays timed with CUDA events), and the least time the card could take
   (bytes over 3.35 TB/s or operations over the peak rate for their type, the
   larger; for the threefry kernels the integer-ALU operations over 64
   lanes an SM at the card's maximum SM clock, with ``F.dropout`` beside
   as a different function, and the card's launch floor: a 1-element
   ``add_`` in the same harness).
8. GPT: RoPE and training — the JAX package's decode benchmark's RoPE
   model (``bench.py``'s ``_decode_bench_setup``) and its tp=1
   GPT-medium step (``gpt_tp_bench(on_tpu, n_devices=1)``). Kernel
   parity at the step's shapes: the causal flash forward, dq and dk/dv
   at b 8, h 16, s 1024, d 64 on RoPE'd q and k beside a view v (with
   and without a key mask), the cross entropy on (8192, 50304) bf16
   logits; RoPE on the card against the CPU (training shape, the decode
   tick with per-slot positions, the cached form's dcos and dsin) and
   its device time a call. ``serving_rope``: GPT-2 medium with
   ``use_rope=True`` (no position table), decode logits against the full
   forward (fp32 1e-5, O2 0.0625), the 16 requests twice on the O2
   params: the replay commits the same streams, exact launches. GPT
   training card vs CPU: GPT-medium width at 2 layers, batch 2, seq 256,
   one ``make_gpt_train_step`` step with fp32 and bf16 compute, each
   with learned positions and RoPE, and bf16 RoPE with dropout 0.1, to
   the BERT check's limits. ``gpt_training``: full GPT-medium (24
   layers, remat), batch 8, seq 1024, bf16 compute over fp32 params,
   six steps on one batch from ``randint(PRNGKey(1000))`` (labels =
   ids) as ``gpt_tree`` (the JAX step exactly, tree FusedAdam) and
   ``gpt_rope_dropout`` (RoPE, dropout 0.1 on ``fold_in(PRNGKey(0),
   step)``, flat FusedAdam): finite, falling losses and each kernel's
   launches a step exactly ``gpt_per_step_launches``. Then
   ``examples/gpt/pretrain_gpt.py`` at its defaults (finite losses,
   DONE), and the step's kernels timed at its shapes beside SDPA's
   causal forward and backward, ``F.cross_entropy`` on bf16 and
   ``torch._fused_adamw_`` over GPT-medium's tensors.

9. paged serving — ``PagedDecodeEngine`` (8 slots, max_len 1024, 2 + 8
   x 16 pages of 64 rows) on GPT-2 medium, seed 0. Kernel parity of the
   paged decode attention (``csrc/paged_attention.cu``) against its
   plain version per element to ``paged_attention.paged_limit``: bf16,
   fp32 and int8 pools at page 16 and 64, pos at 0, at a page's last row
   and at the next page's first; a repeat the same bits; the same
   logical rows under permuted physical pages the same bits.
   ``serving_paged``: decode logits against the full forward (fp32 pool
   1e-5, O2 bf16 0.0625), the 16 requests on the O2 params with exact
   launches (the paged attention L a decode tick), again with
   ``free_order`` reversed (the same streams; teacher-forced logits the
   same bits). ``serving_paged_prefix``: 16 prompts of one of two shared
   512-token prefixes plus a private suffix of 64-448 tokens:
   ``check_invariants()`` after every tick, pages matched from the
   prefix cache, exact launches; on a pool of 2 + 40 pages at least one
   preemption and every request finished. ``serving_paged_kv8``: the
   int8 pool, decode logits in fp32 compute within ``KV8_REL`` of the
   full forward's largest |logit| (the JAX package's kv8 envelope), the
   16 requests with exact launches. The paged attention's times at the
   JAX package's paged A/B configuration (32 slots, S_max 512, page 64,
   lengths 32..512; bf16 and int8 pools) and at ``serving_paged``'s,
   beside its plain version, its bound and SDPA on the already-gathered
   K and V (a different function).
10. speculative decoding and the host spill tier — kernel parity of the
   multi-query paged attention (the decode kernel's k1 > 1 instances:
   k1 1, 2, 5 and 9, linear and tree masks from ``tree_arrays``, fp32,
   bf16 and int8 pools, page 64 and 24, hd 64 and 48) per element to
   ``paged_limit`` per query row; a repeat, two page placements and
   column j of a linear verify against the decode kernel at pos + j, bit
   for bit; k1 65 refused. ``serving_spec``: the ``serving_paged``
   engine with ``spec_k`` 4 on 16 motif prompts (a random 8-32-token
   motif repeated to 64-960 tokens), half sampled at 0.8: verify rows
   against a teacher-forced decode (fp32 1e-5, O2 0.0625); the mix with
   ``spec_k`` 0, the n-gram drafter, the target as its own
   ``DraftModel``, tree speculation, the adaptive depth, an int8 pool
   and ``quantize_params`` (8 requests), each with exact launches (the
   multi-query kernel L a verify tick), its drafter's counters and
   tokens/s. ``serving_paged_tiered``: four 512-token prefixes cycling
   over 2 slots on 2 + 40 pages with ``host_tier=PrefixRegistry(1 <<
   30)``: spills and promotes, every promoted page (and int8 scale
   plane) the spilled bits, the int8 streams equal to the same pool's
   without a tier, the audit after every tick (the bf16 run's at its
   end). The multi-query kernel's times at k1 1 and 5 at
   ``serving_spec``'s shape and the A/B configuration, beside the decode
   kernel, its plain version, its bound and SDPA on the gathered K/V
   with the per-query mask. Each phase prints its seconds.
11. the verify attention past 64 queries and data parallelism — the
   wrapper ``paged_verify_attention`` at k1 80 (one launch a slice of
   ``verify_slices``: two), linear and tree, bf16 and int8 pools, per
   element to ``paged_limit`` and bit for bit against one-query launches
   (the decode kernel at pos + j, or the window's slice (j, 1)); in
   ``serving_spec`` the n-gram mix again at ``spec_k`` 64 (k1 65, two
   launches a layer a verify tick, exact launches). ``data parallelism
   at world 1``: ``initialize_model_parallel()`` brings up an NCCL process
   group of one rank; BERT-Large's ``flash_tree`` O2 step at the
   headline shape, two steps plain and two with
   ``DistributedDataParallel``, master, m, v and losses bit for bit,
   exact launches, both step times. ``two gloo ranks on the card``: two
   spawned processes, each a rank of a gloo group over CUDA tensors
   (NCCL refuses two ranks on one card; the all-reduce is staged through
   the host), one DDP step of BERT-Large width at 2 layers on the global
   batch of 8 split in two against the one-process step (``train_small``'s
   O2 bounds), and ``convert_syncbn_model(apply_resnet)`` at ResNet-50 on
   batch 4 at 64 x 64 split in two, held to the float64 step as
   ``resnet_small`` holds the card; the ranks' results bit for bit
   equal. Every process group is destroyed before the results.

12. chunked prefill and the serving tracer — kernel parity of the
   chunk attention at a prompt chunk's shape (one slot, 16 heads, hd
   64, 256 queries at pos 0, 256, 512 and 768, through a gather row):
   the bf16 pool on the chunk kernel (tensor cores, one launch) per
   element to ``chunk_limit``, two placements the same bits; the fp32
   pool on the verify kernel per element to ``paged_limit``, every
   query the decode kernel's bits at pos + j, one launch a slice of
   ``verify_slices``.
   ``serving_chunked``: the ``serving_paged`` engine and the dense
   ``DecodeEngine`` (GPT-2 medium O2 bf16, 8 slots, max_len 1024) on the
   16 prompts open-loop on the work clock (the 8 shortest at tick 0, the
   8 longest one every 16 ticks, submitted with ``at_tick``, the JAX
   package's ``_drive_poisson`` loop), with ``chunk_tokens`` 256 and
   monolithic: exact launches (a chunk's attention the chunk kernel L
   launches), the tick-clock TTFT and inter-token p50/p99 from the
   tracer's ``latency_summary`` (ticks, not seconds), wall time,
   tokens/s, the share of tokens equal to the monolithic run's; the
   chunked p99 gap below the monolithic one and the TTFT median within 2
   x monolithic + 1. At 2 layers of GPT-2 medium's width, a 700-token
   prompt chunked at 256 on both engines: the final chunk's logits
   against a one-shot prefill (fp32 1e-5, O2 0.0625). The chunk
   kernel's times at pos 0, 256, 512 and 768 beside its plain version,
   its bound, SDPA on the gathered K/V, the kernel without its split
   walk and the verify kernel's route the chunk took before.

13. the serving fault tier — ``serving_chaos``: the ``serving_paged``
   engine (GPT-2 medium O2 bf16, 8 slots, max_len 1024, pages of 64,
   EOS -1, 32 new tokens) with a ``FaultInjector``, an enabled
   ``Tracer`` and ``audit=True`` in every run, each configuration's
   fault-free run in this process its golden: (a) the prefix mix, half
   sampled, under a pinned schedule with a fault at each single-engine
   site (``pool_alloc``, ``cow_clone``, ``prefill_exec`` — four in a row
   end one request as ``retry_budget`` —, ``decode_exec``, ``sample``),
   on the bf16 pool and again on an fp32 pool; (b) chunked at 256,
   ``chunk_prefill_exec`` once mid-prompt and once on a final chunk;
   (c) n-gram speculation with ``draft_exec`` firing; (d) the tiered
   int8 pool with ``host_spill`` and ``host_promote`` firing; (e) three
   tenants with quotas, priorities, weights and an ITL SLO, streams on,
   ``stream_emit`` at 0.02; (f) a queued and a mid-decode request cut by
   ``deadline_ticks`` and a submit past ``max_queue``; (g) (a) again.
   Held: every outcome's reason in ``FINISH_REASONS``, degraded streams
   golden prefixes, every request no fault touched equal to its golden
   stream (every request on the fp32 pool and in (b) and (d)), each
   pinned site fired and its counter moved, the pool whole after each
   run (nothing leaked, the quota charge 0), (e)'s deliveries strict
   prefixes of the committed tokens, the replay identical (streams,
   outcomes, counters, tick stream), exact launches in (a) and (f). The
   touched requests' tokens equal to golden and the margins where they
   part are printed, with each run's wall time and tokens/s.

14. the cross-replica tier — ``serving_disagg``: replicas of the
   ``serving_paged`` engine (one O2 params tree for all) on one card, a
   shared ``FaultInjector`` and ``Tracer``, ``audit=True`` in every run,
   each mix's colocated run in this process its golden: (a) a
   ``DisaggregatedRouter`` pair on the serving mix and the prefix mix,
   half sampled, every admission prefilled on the remote replica and its
   pages shipped over the verified host-staged channel; (b) a 2x2
   ``PoolRouter`` on both mixes over the device-to-device tier and once
   host-staged, every request queued at tick 0; (c) the pair and the
   colocated scheduler open-loop on the work clock. Held: every stream
   the colocated one, the prefix mix's handoffs deduped, the pool's clock
   at most the pair's, (c)'s tick readings the CPU's prediction
   (``DISAGG_OPEN_LOOP``) with the pair's p99 inter-token gap at most the
   colocated one. (d) the router chaos: the 2x2 pool under a pinned
   schedule firing every cross-replica site (a reshard exhaustion
   degrading to host staging, a dropped send, two corrupt payloads, a
   routing fault, the active decode replica down mid-stream and failed
   over), with fp32 params and pool (every stream golden), and O2 bf16
   params over an fp32 pool and over the bf16 pool (the undrained
   requests golden, the drained ones' equal tokens and margins printed;
   the bf16 run twice, the same outcomes, counters and tick stream), and
   both decode replicas down in fp32 (a prefill replica borrowed, then
   the slots home). (e) the host-staged channel's wall ms a page for one
   8-page prompt: device to host, sha256, host to device, a whole
   ``ship``, beside the card's name and power limit. Exact launches in
   every run; the pair's runs and the pool's runs, each counted apart
   from the colocated goldens (``serving_disagg``, ``serving_pool``,
   ``serving_disagg_colocated``), launch the LayerNorm, flash forward,
   paged decode and threefry kernels and nothing else.

15. amp O1, LARC and FP16_Optimizer — ``training_o1``: BERT-Large (24
   layers, batch 64, seq 128) under ``amp.initialize("O1")``, each step's
   forward inside ``h.autocast()``, six steps on one batch in two
   configurations (flash attention with the tree FusedAdam; the unfused
   softmax with the flat FusedAdam): finite losses, the scaler's state
   after six clean steps, exact launches a step (``per_step_launches``,
   as at O2), and a ``TorchDispatchMode`` count of the forward's aten
   products: every ``mm``/``bmm``/``addmm``/convolution in bf16 inside
   ``autocast()``, none outside it; at 2 layers one O1 step on the card
   against the CPU, to O2's limits. ``resnet_larc``: ResNet-50 (batch
   64, 224 x 224) through ``make_resnet_train_step``'s ``optimizer=``
   with ``LARC(FusedSGD(use_flat_kernel=True))``, six steps, each step's
   update held bit for bit against the same LARC over the plain flat SGD
   on the same gradients on the card. ``fp16_optimizer``: ResNet-50
   ``network_to_half`` (fp16 convolutions, fp32 BatchNorm leaves) with
   ``FP16_Optimizer(FusedSGD(use_flat_kernel=True),
   dynamic_loss_scale=True)``, its first scale the largest power of two
   that keeps the gradients 8 times under fp16's range, six steps: the
   first step's gradients carry an inf (the forced overflow), it is
   skipped (params and masters bit for bit) and the scale halves; the
   others go through. ``optimizer step arguments``: each of the five
   optimizers' flat step on BERT-Large's tree with ``lr=``,
   ``weight_decay=`` and ``grad_scale=2**-16`` overriding its defaults,
   held bit for bit against the same step through the plain versions on
   the card (LAMB's params to ``lamb_master_limit``; the grad-norm
   partials from their kernel on both sides), exact launches, and
   ``flat_lamb`` with a caller's ``grad_norm=``: no
   ``flat_l2norm_partials`` launch. The LayerNorm
   forward and backward at the O1 step's fp32 x and fp32 w (8192, 1024)
   are held and timed with the other kernels.

16. tensor parallelism — (a) ``GPTModel(gpt_medium())`` (24 layers,
   remat) at tp 1 on an NCCL world of one, batch 8, seq 1024 from
   ``randint(PRNGKey(1000))``, bf16 compute over fp32 params: two steps
   of ``make_gpt_tp_train_step`` (the loss and gradients inside
   ``shard_map(in_specs=(specs, P(), P()), out_specs=(P(), specs))``,
   the tree FusedAdam), exact launches a step
   (``gpt_tp_per_step_launches``: the unsharded step's but no cross
   entropy, which is plain vocab-parallel ops), the first step's loss
   and gradients against ``gpt_loss_unsharded`` to ``train_small``'s O2
   bounds. (b) The same model and batch at tp 2 on two spawned gloo
   ranks on the card (every collective staged through the host), two
   steps with ``sequence_parallel`` off (the second after the sharded
   FusedAdam update) and one with it on (two until the card run's time
   called for the cut): both ranks
   drew (a)'s weights, their losses equal bit for bit and finite, exact
   launches on each rank, the first step's gathered gradients (the SP
   ones all-reduced first) against (a)'s to the same bound; each step's
   wall time and the host-staged bytes a step. (c) On the same ranks,
   ``ColumnParallelLinear(1024, 4096)`` and ``RowParallelLinear(4096,
   1024)`` with ``gradient_accumulation_fusion``, forward and backward
   on 8192 tokens, ``VocabParallelEmbedding(50304, 1024)`` and
   ``vocab_parallel_cross_entropy`` on (8192, 50304) logits, the gathered
   results against the dense computation on the card: each within twice
   the dense fp32 error from float64 (plus 4 u of the largest value), the
   embedding's forward bit for bit. Every process group is destroyed
   before the results; the phase prints its seconds and the card's name
   and power limit.

18. tensor-parallel serving — the ``make_tp_*_fn`` builders over
   ``GPTModel(gpt_medium())`` (seed 0, its biases and LayerNorm weights
   seeded, O2 bf16) on the serving mix's
   first 8 prompts, one a slot: prefill and 32 greedy decode ticks on the
   dense cache (then one verify tick at spec_k 4) and on the
   ``serving_paged`` pool geometry (every slot's 16 pages mapped up
   front), and the int8 tree (``quantize_params``, fp32 activations as in
   the JAX package) for 8 ticks. (a) tp 1 on an NCCL world of one: each
   mode beside the unsharded builders, the unsharded side greedy and the
   tensor-parallel side fed the same tokens, every row of logits within
   the O2 limit 0.0625 (the int8 tree's fp32 logits within 5e-4), exact
   launches. (b) tp 2 on two spawned gloo
   ranks (each rank its blocks of the params and of the cache, cut once):
   the same runs held to (a)'s unsharded logits, every rank's logits the
   same bits, exact launches on each rank (row 21, ``w8_matmul_nobias``,
   in the int8 run), the host-staged bytes a tick, and a decode tick's
   growth of the allocator's peak within the unsharded step's on the
   same tick plus 5 % of the rank's weight bytes (the raw share
   printed). (c) ``make_reshard_extract_fn`` against
   ``make_extract_pages_fn`` on the gathered pool, bit for bit. Row 21 is
   then timed at its tp 2 shapes (M 8; K 512 and 2048 into N 1024).

19. multihead_attn — ``SelfMultiheadAttn`` (s 512, b 16, embed 1024, 16
   heads, bf16, norm-add, dropout 0.1, causal, a key mask) and
   ``EncdecMultiheadAttn`` (tgt 256, src 512, b 16, a key mask),
   forward and backward through the kernels, exact launches; each
   recorded flash call (the module's sequence-first views, s_q != s_k
   in the encoder-decoder module) held to its plain version per element
   (``o_limit``, ``bwd_limits``), the LayerNorm's too, and the module's
   output and gradients against the same module on the plain versions.
   Each of 18 and 19 prints its seconds. Phase 17's two gloo ranks
   also run (f) ZeRO's sharded checkpoint (after the dp 2 step, a second
   step on each rank's rows held at rest, one ``save_sharded_checkpoint``
   file a rank, the third step uninterrupted and again from a fresh init
   loaded from the file: the params bit for bit, the rank's m its (R/2,
   128) rows throughout) and (g) the spatially parallel bottleneck at cp
   2 (ResNet-50's first identity block, batch 32, 56 x 56, 256 channels,
   fp32) against the unsharded block, forward within rtol = atol 1e-5
   and the gradient of x within 1e-4, the halos' host-staged bytes.

20. checkpoints, RNN, weight norm, ASP, profiler — (a) the imagenet
   example at ResNet-50, batch 64, 224 x 224, O2, ``--flat-kernel`` in
   child processes: 6 straight steps, 3 steps, then ``--resume`` to 6;
   steps 3-5's printed losses equal as strings, ``flat_sgd`` once a step
   (deterministic algorithms only if two straight runs part); (d) the
   byte-level mLSTM (4096 units, 64-dim embedding, 256 steps, batch 128)
   forward and backward in fp32 against float64 on the card, and a
   2-layer LSTM (hidden 1024) whose dropout keep mask, drawn by
   ``threefry_bits``, equals the plain draw bit for bit; (e)
   ``compute_weight`` on a (1024, 4096) kernel, fp32 and bf16 v, against
   float64 per element; (f) ASP's masks on BERT-Large's 300 leaves and
   three masked ``FusedAdam(use_flat_kernel=True)`` steps, ``flat_adam``
   bit for bit with its plain version, the pruned slots zero in params,
   m and v; (g) one 2-layer BERT O2 step under ``utils.profiler.trace``,
   the trace's LayerNorm and flash kernels by name as many as their
   launch counts. The LayerNorm kernels are also timed in both modes at
   (8192, 1024) and (8192, 4096).

21. the page handoff between two processes — two gloo ranks on the
   card, ``serving_paged``'s engine at GPT-2 medium's width as a 1x1
   ``PoolRouter``, the prefill replica on rank 0 and the decode replica
   on rank 1 (a ``RemoteReplica`` in each one's place on the other), the
   mix's first 8 prompts greedy x 32 tokens: the colocated streams
   fault-free and under a dropped reshard send, a corrupted reshard
   receive and an exhausted reshard budget (re-shipped host-staged),
   both ranks' stats, injector counts, event names and tick streams
   equal, each replica's kernels on its rank only (exact), the tile and
   logits bytes sent between the processes, the host ms a shipped page.

22. the L1 curves on the card against the port's own fp32 run (TF32
   off) — BERT-Large's widths at 2 layers, 50 steps, O1, O2, O2 with a
   bf16 m and O2 with the cast-out within 5 % of O0 at every step;
   GPT-medium's widths at 2 layers, bf16 over fp32 masters within 5 %;
   the ResNet-50 cross product (five cases at rtol 0.10 / 0.15, atol
   0.02); int8 eval parity on the trained GPT weights (w8 dense and
   paged, w8 over the int8 pool, the int8 pool alone within 2 % of the
   fp32 rows); exact launches a run.
23. the port's lint on the card's machine (no JAX there) —
   ``apex_tpu_torch.lint``'s ``lint_paths`` over the port, its tests
   (``tests/test_torch_*.py``) and this script with the determinism tier:
   clean over more than 200 files, with no ``jax`` imported; then a
   scratch copy of ``serving/scheduler.py`` in a ``serving`` directory,
   clean, and with one seeded APX801 bug (the preemption requeue
   iterating a set) exactly that finding at that line. The file count
   and the seconds.

It then prints the ``kernels`` JSON line (the rows redesigned since
their port carry ``redesigned`` and a ``note`` naming the design), the
card's name and power limit, and last ``{"ok": true, "device":
{...}}``. It imports neither
JAX nor the JAX package.
"""

import importlib
import itertools
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
BF16_TC_FLOPS = 989e12      # dense bf16 tensor-core peak
FP32_FLOPS = 67e12          # fp32 outside the tensor cores
N_REQUESTS, NEW_TOKENS, NUM_SLOTS, MAX_LEN = 16, 32, 8, 1024
# the host spill tier's counters (the JAX ServingStats names)
TIER_COUNTERS = ("host_spills", "host_spill_bytes", "host_promotes",
                 "host_promote_bytes", "host_promote_ticks",
                 "host_promote_failures")
BUCKETS = (128, 256, 512, 1024)


_PHASE = {"name": None, "t0": 0.0}


def phase(name):
    """Print a phase's name, and how long the previous phase took."""
    now = time.perf_counter()
    if _PHASE["name"] is not None:
        print(f"   ({now - _PHASE['t0']:.1f} s: {_PHASE['name'][:60]})",
              flush=True)
    _PHASE.update(name=name, t0=now)
    print(f"== {name}", flush=True)


def kernel_modules():
    """The eight wrapper modules (the packages re-export some functions
    under their modules' names, so import them by path)."""
    return (importlib.import_module(
                "apex_tpu_torch.normalization.fused_layer_norm"),
            importlib.import_module(
                "apex_tpu_torch.transformer.functional.flash_attention"),
            importlib.import_module("apex_tpu_torch.contrib.xentropy"),
            importlib.import_module(
                "apex_tpu_torch.transformer.functional.fused_softmax"),
            importlib.import_module(
                "apex_tpu_torch.multi_tensor_apply.kernels"),
            importlib.import_module("apex_tpu_torch.quant.kernels"),
            importlib.import_module("apex_tpu_torch.utils.prng"),
            importlib.import_module(
                "apex_tpu_torch.transformer.functional.paged_attention"))


def kernel_counters():
    """Each kernel's launch counter (``Kernel.launches``) by its name in
    :data:`KERNEL_NAMES`."""
    ln, fa, xent, fsm, mta, w8, prng, pa = kernel_modules()
    return dict(zip(KERNEL_NAMES, (
        ln.LN_FWD, ln.LN_BWD, fa.FLASH_FWD, fa.FLASH_BWD_DQ, fa.FLASH_BWD_DKV,
        xent.XENT_FWD, xent.XENT_BWD, fsm.SOFTMAX_FWD, fsm.SOFTMAX_CAUSAL_FWD,
        fsm.SOFTMAX_BWD, mta.FLAT_ADAM, mta.FLAT_SCALE, mta.FLAT_AXPBY,
        mta.FLAT_L2NORM, mta.FLAT_LAMB_STAGE1, w8.W8_MATMUL_NOBIAS,
        w8.W8_MATMUL, w8.W8_MATMUL_NK, mta.FLAT_SGD, mta.FLAT_ADAGRAD,
        mta.FLAT_NOVOGRAD, prng.THREEFRY_BITS, prng.THREEFRY_DROPOUT,
        pa.PAGED_DECODE, pa.PAGED_VERIFY, pa.PAGED_CHUNK)))


def check(ok, msg):
    print(("ok   " if ok else "FAIL ") + msg, flush=True)
    if not ok:
        sys.exit(1)


# ---------------------------------------------------------------------------
# 1. build
# ---------------------------------------------------------------------------

def build(libs):
    from apex_tpu_torch.utils.cuda_build import build_all

    phase("build")
    t0 = time.perf_counter()
    build_all(libs)
    print(f"built {[l.name for l in libs]} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for lib in libs:
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {lib.name}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}; "
          f"cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}",
          flush=True)


# ---------------------------------------------------------------------------
# 2. kernel parity
# ---------------------------------------------------------------------------

def _rand(gen, shape, dtype, dev, scale=1.0, shift=0.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale
            + shift).to(dtype)


def ln_parity(dev):
    ln = kernel_modules()[0]
    phase("kernel parity: layer norm (tolerance: fp32 1e-5; bf16 one "
          "bf16 ulp, i.e. 2^-7 relative + 1e-5)")
    gen = torch.Generator(device=dev).manual_seed(1)
    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # rows, h, x dtype, w/b dtype, mode, affine
        (1024, 1024, bf, bf, "ln", True),
        (8, 1024, bf, bf, "ln", True),
        (8192, 1024, bf, f32, "ln", True),    # the BERT O2 step
        (8192, 1024, f32, f32, "ln", True),   # the O1 step's residual LNs
        (333, 1000, f32, f32, "ln", True),
        (1024, 1024, bf, bf, "rms", True),
        (333, 1000, f32, f32, "ln", False),
        # ragged h, teams of several warps, a row base 2 bytes past a
        # 16-byte boundary (element loads)
        (16, 100, bf, bf, "ln", True),
        (33, 4096, bf, f32, "ln", True),
        (9, 8192, f32, f32, "rms", True),
        (1024, 4096, bf, f32, "ln", True),
        (40, 1024, bf, bf, "ln_unaligned", True),
    ]
    worst = 0.0
    for rows, h, xdt, wdt, mode, affine in cases:
        x = _rand(gen, (rows, h), xdt, dev, 2.0, 0.5)
        if mode == "ln_unaligned":
            mode = "ln"
            buf = torch.empty(rows * h + 1, dtype=xdt, device=dev)
            x = buf[1:].view(rows, h).copy_(x)
        w = _rand(gen, (h,), wdt, dev, 0.5, 1.0) if affine else None
        b = _rand(gen, (h,), wdt, dev, 0.3) \
            if affine and mode == "ln" else None
        y, mean, rstd = ln.layer_norm_fwd_kernel(x, w, b, mode, 1e-5)
        torch.cuda.synchronize()
        y0, mean0, rstd0 = ln.layer_norm_fwd_plain(x, w, b, mode, 1e-5)
        err = (y.float() - y0.float()).abs()
        rtol = 1e-5 if xdt == f32 else 2 ** -7
        ok = bool((err <= rtol * y0.float().abs() + 1e-5).all())
        ok &= bool(torch.allclose(rstd, rstd0, rtol=1e-5, atol=1e-6))
        if mode == "ln":
            ok &= bool(torch.allclose(mean, mean0, rtol=1e-5, atol=1e-6))
        e = float(err.max())
        worst = max(worst, e)
        check(ok, f"LN {mode} ({rows}, {h}) x {str(xdt)[6:]} w "
              f"{str(wdt)[6:] if affine else 'none'}: max_abs_err {e:.3g}")
    return worst


LSE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}  # base 2, absolute


def _load_variant(*ts):
    """How the flash C entries take these tensors' tiles: fp32 on the
    CUDA cores; bf16 by 16-byte cp.async copies where every row of each
    tensor starts on a 16-byte boundary and d fills whole copies, by
    element loads otherwise."""
    if ts[0].dtype == torch.float32:
        return "fp32 CUDA cores"
    rows16 = ts[0].shape[-1] % 8 == 0 and all(
        t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:3])
        for t in ts)
    return "cp.async" if rows16 else "element loads"


def _flash_qkv(gen, layout, b, h, s, d, dt, dev):
    """q, k, v as the model paths hand them over: GPT's prefill views of
    a fused (b, s, 3 h d) projection, BERT's views of a (b, s, 3, h, d)
    one, or contiguous (b, h, s, d) tensors."""
    from apex_tpu_torch.models.gpt import _split_qkv

    if layout == "gpt":
        return _split_qkv(_rand(gen, (b, s, 3 * h * d), dt, dev), d)
    if layout == "bert":
        qkv = _rand(gen, (b, s, 3, h, d), dt, dev)
        return tuple(qkv[:, :, j].transpose(1, 2) for j in range(3))
    return tuple(_rand(gen, (b, h, s, d), dt, dev) for _ in range(3))


def _flash_mask(b, s, dev, tail):
    """Batch 0's first key masked (under causal its row 0 sees nothing)
    and a padded tail of s // tail keys."""
    mask = torch.ones((b, s), dtype=torch.int32, device=dev)
    mask[0, 0] = 0
    mask[:, s - s // tail:] = 0
    return mask


def flash_parity(dev):
    fa = kernel_modules()[1]
    phase("kernel parity: flash attention (tolerance on o per element, "
          "flash_attention.o_limit: fp32 1e-5 (|o0| + 1), bf16 2^-7 |o0| "
          "+ 2^-5 sqrt(sum p^2 v^2); on the base-2 lse: fp32 1e-4, bf16 "
          "1e-2; a second launch gives the same bits; bf16 on the tensor "
          "cores, by cp.async or element loads)")
    gen = torch.Generator(device=dev).manual_seed(2)
    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # b, h, s, d, dtype, causal, masked, rate, q/k/v layout
        (1, 16, 1024, 64, bf, True, True, 0.0, "gpt"),
        (1, 16, 1024, 64, bf, True, True, 0.0, None),
        (2, 16, 300, 64, bf, False, True, 0.0, None),
        (1, 4, 256, 128, f32, True, False, 0.0, None),
        (1, 16, 1024, 64, bf, True, True, 0.1, None),
        (64, 16, 128, 64, bf, False, True, 0.0, "bert"),  # the BERT step
        (64, 16, 128, 64, bf, False, True, 0.1, "bert"),
        (1, 16, 1024, 64, bf, True, True, 0.5, "gpt"),
        (2, 16, 40, 64, bf, False, True, 0.5, None),
        (2, 16, 130, 64, bf, True, True, 0.1, "gpt"),
        (2, 16, 300, 128, bf, True, True, 0.5, None),
        (2, 16, 130, 100, bf, False, True, 0.1, None),   # element loads
        (2, 4, 200, 48, bf, True, True, 0.0, "bert"),
        (2, 2, 130, 64, f32, True, True, 0.2, "bert"),
    ]
    worst = 0.0
    for b, h, s, d, dt, causal, masked, rate, layout in cases:
        q, k, v = _flash_qkv(gen, layout, b, h, s, d, dt, dev)
        mask = _flash_mask(b, s, dev, 10) if masked else None
        seed = (0x1234ABCD, 0x9876FEDC)
        kw = dict(causal=causal, scale=d ** -0.5, rate=rate)
        o, lse = fa.attention_fwd_kernel(q, k, v, mask, seed, **kw)
        o2, lse2 = fa.attention_fwd_kernel(q, k, v, mask, seed, **kw)
        torch.cuda.synchronize()
        o0, lse0 = fa.attention_fwd_plain(q, k, v, mask, seed, **kw)
        err = (o.float() - o0.float()).abs()
        lim = fa.o_limit(q, k, v, mask, o0, causal=causal, scale=d ** -0.5)
        use = float(torch.where(err > 0, err / lim, 0.0).max())
        e = float(err.max())
        fin = torch.isfinite(lse0)
        le = float((lse - lse0)[fin].abs().max())
        ok = use <= 1.0 and le <= LSE_TOL[dt]
        ok &= bool(torch.equal(torch.isfinite(lse), fin))
        ok &= torch.equal(o, o2) and torch.equal(lse, lse2)
        if masked and causal:  # batch 0's row 0 sees no key
            ok &= bool((o[0, :, 0] == 0).all())
        worst = max(worst, e)
        check(ok, f"flash b{b} h{h} s{s} d{d} {str(dt)[6:]} causal={causal}"
              f" mask={masked} rate={rate}"
              f"{f' {layout} qkv views' if layout else ''} "
              f"({_load_variant(q, k, v)}): max_abs_err o "
              f"{e:.3g} ({use:.2f} of its tolerance), lse {le:.3g}; "
              "repeat bit-equal")
    return worst


def flash_keep_masks(dev):
    """The dropout keep mask read straight off the bf16 kernels, against
    the plain version's at every (head, q, k). Forward: q = 0 makes every
    p 1 before normalisation and v the identity (s_k = d), so o[q, j] is
    0 exactly where (q, j) is dropped. dk/dv: lse = log2 s_k makes p =
    1 / s_k and do the identity (s_q = d), so dv[k, j] = p_drop[j, k]."""
    fa = kernel_modules()[1]
    phase("kernel parity: flash dropout keep masks (forward and dk/dv, "
          "bit for bit)")
    gen = torch.Generator(device=dev).manual_seed(8)
    bf, b, h = torch.bfloat16, 2, 16
    seed = (0x1234ABCD, 0x9876FEDC)
    for d, sq, sk in ((64, 1024, 64), (128, 300, 128)):
        eye = torch.eye(d, dtype=bf, device=dev)
        for rate in (0.1, 0.5):
            kw = dict(causal=False, scale=d ** -0.5, rate=rate)
            zero = torch.zeros((b, h, sq, d), dtype=bf, device=dev)
            o, _ = fa.attention_fwd_kernel(zero, zero[:, :, :sk],
                                           eye[:sk].expand(b, h, sk, d),
                                           None, seed, **kw)
            k = _rand(gen, (b, h, sk, d), bf, dev)
            _, dv = fa.attention_dkv_kernel(
                torch.zeros((b, h, d, d), dtype=bf, device=dev), k, k, None,
                eye.expand(b, h, d, d),
                torch.full((b * h, d), float(np.log2(sk)), device=dev),
                torch.zeros((b * h, d), device=dev), seed, **kw)
            torch.cuda.synchronize()
            keep = fa._keep_mask(b, h, sq, sk, seed, rate, dev)
            keep_t = fa._keep_mask(b, h, d, sk, seed, rate, dev)
            ok = torch.equal(o != 0, keep)
            ok &= torch.equal(dv != 0, keep_t.transpose(-1, -2))
            check(ok, f"keep mask b{b} h{h} s_q {sq} s_k {sk} d{d} rate "
                  f"{rate}: forward and dk/dv equal the plain mask "
                  f"({float(keep.float().mean()):.4f} kept)")


def _held(got, want, lim):
    """(max abs error, worst share of the per-element limit)."""
    err = (got.float() - want.float()).abs()
    use = float(torch.where(err > 0, err / lim, torch.zeros(
        (), device=err.device)).max())
    return float(err.max()), use


def ln_bwd_parity(dev):
    ln = kernel_modules()[0]
    phase("kernel parity: layer norm backward (tolerance per element, "
          "fused_layer_norm.bwd_limits: the sum-order bound 2 (n - 1) "
          "2^-24 sum|terms| of each fp32 reduction, plus one ulp of a bf16 "
          "output; dgamma/dbeta must repeat bit for bit)")
    gen = torch.Generator(device=dev).manual_seed(4)
    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # rows, h, x dtype, w/b dtype, mode, affine
        (8192, 1024, bf, f32, "ln", True),    # the BERT O2 step
        (8192, 1024, f32, f32, "ln", True),   # the O1 step's residual LNs
        (1024, 1024, bf, bf, "ln", True),
        (1024, 1024, bf, bf, "rms", True),
        (333, 1000, f32, f32, "ln", False),
        (2048, 4096, bf, f32, "ln", True),    # the JAX column-split regime
        (2048, 4096, f32, f32, "ln", True),
        (1024, 1000, bf, bf, "ln", True),     # ragged h, 16-byte chunks
        (333, 1001, bf, f32, "ln", True),     # h off the chunk: elements
        (65, 8192, bf, f32, "rms", True),     # the largest h
    ]
    worst = 0.0
    for rows, h, xdt, wdt, mode, affine in cases:
        x = _rand(gen, (rows, h), xdt, dev, 2.0, 0.5)
        dy = _rand(gen, (rows, h), xdt, dev)
        w = _rand(gen, (h,), wdt, dev, 0.5, 1.0) if affine else None
        b = _rand(gen, (h,), wdt, dev, 0.3) \
            if affine and mode == "ln" else None
        _, mean, rstd = ln.layer_norm_fwd_plain(x, w, b, mode, 1e-5)
        got = ln.layer_norm_bwd_kernel(dy, x, w, b, mean, rstd)
        again = ln.layer_norm_bwd_kernel(dy, x, w, b, mean, rstd)
        torch.cuda.synchronize()
        want = ln.layer_norm_bwd_plain(dy, x, w, b, mean, rstd)
        lims = ln.bwd_limits(dy, x, w, mean, rstd, *want)
        ok, parts = True, []
        for name, g, g2, w0, lim in zip(("dx", "dgamma", "dbeta"), got,
                                        again, want, lims):
            if w0 is None:
                continue
            e, use = _held(g, w0, lim)
            ok &= use <= 1.0 and g.dtype == w0.dtype and torch.equal(g, g2)
            worst = max(worst, e)
            parts.append(f"{name} {e:.3g} ({use:.2f} of its tolerance)")
        check(ok, f"LN bwd {mode} ({rows}, {h}) x {str(xdt)[6:]} w "
              f"{str(wdt)[6:] if affine else 'none'}: max_abs_err "
              + ", ".join(parts))
    return worst


def flash_bwd_parity(dev):
    fa = kernel_modules()[1]
    phase("kernel parity: flash attention backward (tolerance per element, "
          "flash_attention.bwd_limits: the fp32 sum-order bounds carried "
          "through p and ds, one bf16 ulp of p and of ds, one ulp of the "
          "output per rounding; a second launch gives the same bits)")
    gen = torch.Generator(device=dev).manual_seed(5)
    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # b, h, s, d, dtype, causal, masked, rate, q/k/v layout
        (64, 16, 128, 64, bf, False, True, 0.0, "bert"),   # the BERT step
        (1, 16, 1024, 64, bf, True, False, 0.0, None),
        (2, 16, 300, 64, bf, True, True, 0.1, None),
        (1, 4, 256, 128, f32, True, False, 0.0, None),
        (64, 16, 128, 64, bf, False, True, 0.1, "bert"),
        (1, 16, 1024, 64, bf, True, True, 0.5, "gpt"),
        (2, 16, 40, 64, bf, False, True, 0.5, None),
        (2, 16, 130, 64, bf, True, True, 0.1, "bert"),
        (1, 16, 300, 128, bf, True, True, 0.5, None),
        (2, 16, 130, 100, bf, False, True, 0.1, None),   # element loads
        (2, 4, 200, 48, bf, True, True, 0.0, "gpt"),
        # the dq kernel's 64-row q tile: one row short, one over, and a
        # causal run whose last q tile holds one row
        (8, 16, 63, 64, bf, False, True, 0.0, "bert"),
        (8, 16, 65, 64, bf, False, True, 0.1, "bert"),
        (4, 16, 129, 64, bf, True, True, 0.0, "gpt"),
        (2, 16, 65, 100, bf, True, True, 0.0, None),     # element loads
    ]
    worst = {"dq": 0.0, "dkv": 0.0}
    for b, h, s, d, dt, causal, masked, rate, layout in cases:
        q, k, v = _flash_qkv(gen, layout, b, h, s, d, dt, dev)
        do = _rand(gen, (b, h, s, d), dt, dev)
        mask = _flash_mask(b, s, dev, 8) if masked else None
        seed = (0x1234ABCD, 0x9876FEDC)
        kw = dict(causal=causal, scale=d ** -0.5, rate=rate)
        o, lse = fa.attention_fwd_kernel(q, k, v, mask, seed, **kw)
        got = fa.attention_bwd_kernel(q, k, v, mask, o, lse, do, seed, **kw)
        again = fa.attention_bwd_kernel(q, k, v, mask, o, lse, do, seed,
                                         **kw)
        torch.cuda.synchronize()
        want = fa.attention_bwd_plain(q, k, v, mask, o, lse, do, seed, **kw)
        lims = fa.bwd_limits(q, k, v, mask, o, lse, do, *want, **kw)
        ok, parts = True, []
        for name, g, g2, w0, lim in zip(("dq", "dk", "dv"), got, again,
                                        want, lims):
            e, use = _held(g, w0, lim)
            ok &= use <= 1.0 and bool(torch.isfinite(g).all())
            ok &= torch.equal(g, g2)
            key = "dq" if name == "dq" else "dkv"
            worst[key] = max(worst[key], e)
            parts.append(f"{name} {e:.3g} ({use:.2f})")
        check(ok, f"flash bwd b{b} h{h} s{s} d{d} {str(dt)[6:]} "
              f"causal={causal} mask={masked} rate={rate}"
              f"{f' {layout} qkv views' if layout else ''} "
              f"({_load_variant(q, k, v, do)}): max_abs_err "
              "(share of its tolerance) " + ", ".join(parts)
              + "; repeat bit-equal")
    return worst


def xent_parity(dev):
    xent = kernel_modules()[2]
    phase("kernel parity: softmax cross entropy (tolerance per element, "
          "xentropy.limits: the sum-order bound of the row's logsumexp, "
          "one rounding per term; ignored rows exactly 0)")
    gen = torch.Generator(device=dev).manual_seed(6)
    n, v = 8192, 30522
    x = _rand(gen, (n, v), torch.float32, dev, 3.0)
    labels = torch.randint(0, v, (n,), generator=gen, device=dev)
    labels[torch.rand((n,), generator=gen, device=dev) < 0.15] = -1
    dloss = torch.rand((n,), generator=gen, device=dev) + 0.5
    worst = {"fwd": 0.0, "bwd": 0.0}
    for eps in (0.0, 0.1):
        loss, lse = xent.xentropy_fwd_kernel(x, labels, eps)
        dx = xent.xentropy_bwd_kernel(x, labels, lse, dloss, eps)
        torch.cuda.synchronize()
        loss0, lse0 = xent.xentropy_fwd_plain(x, labels, eps)
        dx0 = xent.xentropy_bwd_plain(x, labels, lse0, dloss, eps)
        lims = xent.limits(x, labels, eps, loss0, lse0, dloss, dx0)
        res = [_held(g, w0, lim) for g, w0, lim in zip(
            (loss, lse, dx), (loss0, lse0, dx0), lims)]
        ign = labels < 0
        ok = all(use <= 1.0 for _, use in res)
        ok &= bool((loss[ign] == 0).all()) and bool((dx[ign] == 0).all())
        worst["fwd"] = max(worst["fwd"], res[0][0], res[1][0])
        worst["bwd"] = max(worst["bwd"], res[2][0])
        check(ok, f"xentropy ({n}, {v}) fp32 eps={eps}, "
              f"{int(ign.sum())} ignored rows: max_abs_err (share of its "
              "tolerance) " + ", ".join(
                  f"{nm} {e:.3g} ({use:.2f})" for nm, (e, use) in zip(
                      ("loss", "lse", "dx"), res)))
    return worst


SM_SCALE = 0.125   # 1 / sqrt(64), BERT-Large's attention scale


def softmax_parity(dev):
    fsm = kernel_modules()[3]
    phase("kernel parity: fused softmax (tolerance per element, "
          "fused_softmax.fwd_limits: (2 (sk - 1) + 12) fp32 ulps of y for "
          "the row sums in other orders, plus one ulp of a bf16 y; "
          "backward fused_softmax.bwd_limits on the same y: 2 (sk + 1) "
          "ulps of sum |y dy| plus one ulp of a bf16 dx)")
    gen = torch.Generator(device=dev).manual_seed(8)
    bf, f32 = torch.bfloat16, torch.float32
    b, nh, s = BIG_BATCH, 16, SEQ
    worst = {"fwd": 0.0, "causal": 0.0, "bwd": 0.0}
    cases = [  # label, x dtype, fully masked rows
        ("padded tail", bf, False), ("padded tail + a fully masked row",
                                     bf, True), ("padded tail", f32, False)]
    for label, dt, full in cases:
        x = _rand(gen, (b, nh, s, s), dt, dev, 8.0)
        dy = _rand(gen, (b, nh, s, s), dt, dev)
        mask = torch.zeros((b, 1, 1, s), dtype=torch.int32, device=dev)
        mask[..., s - s // 10:] = 1          # BERT's (1 - mask): 1 = pad
        if full:
            mask[0] = 1
        y = fsm.masked_softmax_fwd_kernel(x, mask, SM_SCALE)
        dx = fsm.softmax_bwd_kernel(y, dy, SM_SCALE)
        torch.cuda.synchronize()
        y0 = fsm.masked_softmax_fwd_plain(x, mask, SM_SCALE)
        dx0 = fsm.softmax_bwd_plain(y, dy, SM_SCALE)
        ey, uy = _held(y, y0, fsm.fwd_limits(y0))
        ed, ud = _held(dx, dx0, fsm.bwd_limits(y, dy, SM_SCALE, dx0))
        ok = uy <= 1.0 and ud <= 1.0 and y.dtype == dx.dtype == dt
        if full:
            ok &= torch.equal(y[0].float(), torch.full_like(
                y[0].float(), 1.0 / s).to(dt).float())
        worst["fwd"] = max(worst["fwd"], ey)
        worst["bwd"] = max(worst["bwd"], ed)
        check(ok, f"masked softmax ({b}, {nh}, {s}, {s}) {str(dt)[6:]}, "
              f"(b, 1, 1, sk) mask, {label}: max_abs_err y {ey:.3g} "
              f"({uy:.2f} of its tolerance), dx {ed:.3g} ({ud:.2f})"
              + (", the masked rows uniform 1/sk" if full else ""))
    bc, sc = 16, 1024                        # the causal kernel's case
    x = _rand(gen, (bc, sc, sc), bf, dev, 4.0)
    dy = _rand(gen, (bc, sc, sc), bf, dev)
    y = fsm.causal_softmax_fwd_kernel(x, SM_SCALE)
    dx = fsm.softmax_bwd_kernel(y, dy, SM_SCALE)
    torch.cuda.synchronize()
    y0 = fsm.causal_softmax_fwd_plain(x, SM_SCALE)
    dx0 = fsm.softmax_bwd_plain(y, dy, SM_SCALE)
    ey, uy = _held(y, y0, fsm.fwd_limits(y0))
    ed, ud = _held(dx, dx0, fsm.bwd_limits(y, dy, SM_SCALE, dx0))
    above = bool((y[:, fsm._causal(sc, sc, dev)] == 0).all())
    worst["causal"] = ey
    worst["bwd"] = max(worst["bwd"], ed)
    check(uy <= 1.0 and ud <= 1.0 and above,
          f"causal softmax ({bc}, {sc}, {sc}) bf16: max_abs_err y {ey:.3g} "
          f"({uy:.2f} of its tolerance), dx {ed:.3g} ({ud:.2f}); zero "
          "above the diagonal")
    # the mask read as vectors (uint8 and int32, key stride 1) or element
    # by element (key stride 2), a (b, 1, sq, sk) mask, a query count off
    # the block's rows, and sk 130 and 3000 on the generic path; batch 0
    # masked everywhere
    layouts = [  # b, heads, sq, sk, mask dtype, layout
        (8, 16, 128, 128, torch.uint8, "key"),
        (8, 16, 128, 128, torch.int32, "query"),
        (4, 16, 100, 128, torch.uint8, "query"),
        (4, 16, 100, 128, torch.int32, "strided"),
        (2, 4, 37, 130, torch.uint8, "key"),
        (1, 2, 5, 3000, torch.int32, "query")]
    for b, nh, sq, sk, mdt, layout in layouts:
        x = _rand(gen, (b, nh, sq, sk), bf, dev, 8.0)
        dy = _rand(gen, (b, nh, sq, sk), bf, dev)
        ks = 2 * sk if layout == "strided" else sk
        m = torch.rand((b, 1, 1 if layout == "key" else sq, ks),
                       generator=gen, device=dev) < 0.2
        m[0] = True
        mask = m.to(mdt)[..., ::2] if layout == "strided" else m.to(mdt)
        y = fsm.masked_softmax_fwd_kernel(x, mask, SM_SCALE)
        same = torch.equal(y, fsm.masked_softmax_fwd_kernel(x, mask,
                                                            SM_SCALE))
        dx = fsm.softmax_bwd_kernel(y, dy, SM_SCALE)
        torch.cuda.synchronize()
        y0 = fsm.masked_softmax_fwd_plain(x, mask, SM_SCALE)
        dx0 = fsm.softmax_bwd_plain(y, dy, SM_SCALE)
        ey, uy = _held(y, y0, fsm.fwd_limits(y0))
        ed, ud = _held(dx, dx0, fsm.bwd_limits(y, dy, SM_SCALE, dx0))
        uniform = torch.equal(y[0], torch.full(
            y[0].shape, 1.0 / sk, device=dev).to(bf))
        worst["fwd"] = max(worst["fwd"], ey)
        worst["bwd"] = max(worst["bwd"], ed)
        check(uy <= 1.0 and ud <= 1.0 and same and uniform,
              f"masked softmax ({b}, {nh}, {sq}, {sk}) bf16, "
              f"{str(mdt)[6:]} {layout} mask: max_abs_err y {ey:.3g} "
              f"({uy:.2f} of its tolerance), dx {ed:.3g} ({ud:.2f}); a "
              "repeat the same bits, the masked batch uniform 1/sk")
    return worst


def bert_flat(dev):
    """BERT-Large's master tree packed as the flat FusedAdam packs it:
    (the fp32 params buffer, its spec)."""
    from apex_tpu_torch.models.bert import bert_large, init_bert
    from apex_tpu_torch.multi_tensor_apply.flatten import flatten_tensors
    from apex_tpu_torch.utils.tree import tree_flatten

    params = init_bert(bert_large(), torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    leaves, _ = tree_flatten(params)
    return flatten_tensors(leaves)


def adam_inputs(dev, m_dtype, gen):
    from apex_tpu_torch.multi_tensor_apply.kernels import adam_hparams

    p, spec = bert_flat(dev)
    g = _rand(gen, p.shape, torch.float32, dev, 1e-3)
    m = _rand(gen, p.shape, torch.float32, dev, 1e-4).to(m_dtype)
    v = _rand(gen, p.shape, torch.float32, dev, 1e-6).abs()
    hp = adam_hparams(lr=LR, beta1=0.9, beta2=0.999, eps=1e-8,
                      step=torch.tensor(3, device=dev), weight_decay=0.01,
                      adam_w_mode=True, bias_correction=True, grad_scale=1.0,
                      device=dev)
    return g, p, m, v, hp, spec


def flat_adam_parity(dev):
    mta = kernel_modules()[4]
    phase("kernel parity: flat_adam on BERT-Large's flat buffer (tolerance: "
          "bit for bit against the plain version, the same fp32 operations "
          "in the same order; the bf16 cast-out equal to the cast of the "
          "kernel's own p; found_inf True writes the old values)")
    gen = torch.Generator(device=dev).manual_seed(9)
    worst = 0.0
    for m_dtype, emit in ((torch.float32, None),
                          (torch.bfloat16, torch.bfloat16)):
        g, p, m, v, hp, spec = adam_inputs(dev, m_dtype, gen)
        for found in (False, True):
            fi = torch.tensor(found, device=dev)
            got = mta.flat_adam_kernel(g, p, m, v, hp, fi, emit)
            torch.cuda.synchronize()
            want = mta.flat_adam_plain(g, p, m, v, hp, fi, emit)
            errs = [float((a.float() - w.float()).abs().max())
                    for a, w in zip(got, want)]
            ok = all(torch.equal(a, w) for a, w in zip(got, want))
            if emit is not None:
                ok &= torch.equal(got[3], got[0].to(torch.bfloat16))
            if found:
                ok &= torch.equal(got[0], p) and torch.equal(got[1], m) \
                    and torch.equal(got[2], v)
            worst = max([worst] + errs)
            check(ok, f"flat_adam ({spec.total_rows}, 128) = "
                  f"{p.numel()} elements, m {str(m_dtype)[6:]}"
                  f"{', bf16 cast-out' if emit else ''}, found_inf {found}: "
                  f"max_abs_err {max(errs):.3g} (p, m, v"
                  f"{', compute' if emit else ''} bit-equal)")
            del got, want
        del g, p, m, v
        torch.cuda.empty_cache()
    return worst


def _same(a, b):
    """Equal values and dtypes, a NaN where the other has one (a NaN's
    payload may differ: the kernel rounds it to bf16 as
    ``__float2bfloat16_rn`` does, PyTorch as ``c10::BFloat16``)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return a.dtype == b.dtype and torch.equal(na, nb) and torch.equal(
        a.masked_fill(na, 0), b.masked_fill(nb, 0))


def flat_scale_axpby_parity(dev):
    """``flat_scale`` and ``flat_axpby`` on BERT-Large's flat buffer:
    the kernel's output and flag against the plain version's, bit for
    bit, clean and with an injected inf (scale) or NaN (axpby)."""
    mta = kernel_modules()[4]
    phase("kernel parity: flat_scale and flat_axpby on BERT-Large's flat "
          "buffer (tolerance: outputs bit for bit, a NaN where the plain "
          "version has one; finite "
          "flags equal, scale's judged on x, axpby's on the result)")
    gen = torch.Generator(device=dev).manual_seed(11)
    x, spec = bert_flat(dev)
    y = _rand(gen, x.shape, torch.float32, dev, 1e-2)
    s = torch.tensor(1.0 / 65536, device=dev)
    ab = torch.tensor([0.9, 0.1], device=dev)
    worst = {"scale": 0.0, "axpby": 0.0}
    for bad in (None, "inf", "nan"):
        if bad is not None:   # one element in the middle of the buffer
            x.view(-1)[x.numel() // 2 + 17] = float(bad)
        for odt in (torch.float32, torch.bfloat16):
            got = mta.flat_scale_kernel(x, s, odt)
            torch.cuda.synchronize()
            want = mta.flat_scale_plain(x, s, odt)
            ok = _same(got[0], want[0]) and bool(got[1]) == bool(
                want[1]) == (bad is not None)
            e = float((got[0].float() - want[0].float()).nan_to_num().abs()
                      .max())
            worst["scale"] = max(worst["scale"], e)
            check(ok, f"flat_scale ({spec.total_rows}, 128) fp32 -> "
                  f"{str(odt)[6:]}, {bad or 'all finite'}: bit-equal, "
                  f"found_inf {bool(got[1])}")
            del got, want
        got = mta.flat_axpby_kernel(y, x, ab, torch.float32)
        torch.cuda.synchronize()
        want = mta.flat_axpby_plain(y, x, ab, torch.float32)
        ok = _same(got[0], want[0]) and bool(got[1]) == bool(
            want[1]) == (bad is not None)
        e = float((got[0] - want[0]).nan_to_num().abs().max())
        worst["axpby"] = max(worst["axpby"], e)
        check(ok, f"flat_axpby ({spec.total_rows}, 128) fp32, "
              f"{bad or 'all finite'}: bit-equal, found_inf {bool(got[1])}")
        del got, want
    del x, y
    torch.cuda.empty_cache()
    return worst


def lamb_inputs(dev, m_dtype, gen):
    """BERT-Large's flat params with random grads, moments and the
    stage-1 vector of step 3 (grad_scale / clip = 0.5)."""
    mta = kernel_modules()[4]
    p, spec = bert_flat(dev)
    g = _rand(gen, p.shape, torch.float32, dev, 1e-3)
    m = _rand(gen, p.shape, torch.float32, dev, 1e-4).to(m_dtype)
    v = _rand(gen, p.shape, torch.float32, dev, 1e-6).abs()
    hp = mta.lamb_hparams(beta1=0.9, beta2=0.999, eps=1e-6,
                          step=torch.tensor(3, device=dev), weight_decay=0.01,
                          adam_w_mode=True,
                          gs_over_clip=torch.tensor(0.5, device=dev),
                          device=dev)
    segs = (spec.tile_tensor_ids(8).to(dev), spec.tile_counts(8).to(dev))
    return g, p, m, v, hp, spec, segs


def flat_lamb_parity(dev):
    mta = kernel_modules()[4]
    phase("kernel parity: flat_l2norm_partials and LAMB's stage 1 on "
          "BERT-Large's flat buffer (tolerance: partials per element to "
          "sum_sq_limit, 2 (1024 + 1) u of each sub-tile's sum for two "
          "orders of 1,024 squares; m, v and u bit for bit; params through "
          "stage 2 to lamb_p_limit, lr |u| |d ratio| plus an ulp; repeats "
          "and two flat_lamb calls bit for bit; found_inf True writes the "
          "old m and v, u = 0 and gives the old p)")
    gen = torch.Generator(device=dev).manual_seed(12)
    out = {"l2": 0.0, "stage1": 0.0}
    for m_dtype in (torch.float32, torch.bfloat16):
        g, p, m, v, hp, spec, segs = lamb_inputs(dev, m_dtype, gen)
        label = f"({spec.total_rows}, 128) = {p.numel()} elements"
        if m_dtype == torch.float32:
            got = mta.flat_l2norm_partials_kernel(g)
            again = mta.flat_l2norm_partials_kernel(g)
            torch.cuda.synchronize()
            want = mta.flat_l2norm_partials_plain(g)
            e, use = _held(got, want, mta.sum_sq_limit(want, mta.SUB))
            out["l2"] = e
            check(use <= 1.0 and torch.equal(got, again),
                  f"flat_l2norm_partials {label}: {got.numel()} partials, "
                  f"max_abs_err {e:.3g} ({use:.3f} of its tolerance), "
                  "repeat bit-equal")
            del got, again, want
        for found in (False, True):
            fi = torch.tensor(found, device=dev)
            got = mta.flat_lamb_stage1_kernel(g, p, m, v, hp, fi)
            torch.cuda.synchronize()
            want = mta.flat_lamb_stage1_plain(g, p, m, v, hp, fi)
            ok = all(torch.equal(a, w) for a, w in zip(got[:3], want[:3]))
            errs = [float((a.float() - w.float()).abs().max())
                    for a, w in zip(got[:3], want[:3])]
            parts = [_held(a, w, mta.sum_sq_limit(w, mta.SUB))
                     for a, w in zip(got[3:], want[3:])]
            ok &= all(use <= 1.0 for _, use in parts)
            if found:
                ok &= torch.equal(got[0], m) and torch.equal(got[1], v) \
                    and not bool(got[2].any())
            # stage 2 from each side's stage 1: the ratio's sum orders
            lim = None
            p_got = mta.lamb_stage2(p, got[2], got[3], got[4], *segs,
                                    lr=1e-3, weight_decay=0.01,
                                    use_nvlamb=False)
            u_want = want[2].clone()
            p_want = mta.lamb_stage2(p, want[2], want[3], want[4], *segs,
                                     lr=1e-3, weight_decay=0.01,
                                     use_nvlamb=False)
            lim = mta.lamb_p_limit(p_want, u_want, want[3], want[4], *segs,
                                   1e-3)
            ep, up = _held(p_got, p_want, lim)
            ok &= up <= 1.0
            if found:
                ok &= torch.equal(p_got, p)
            out["stage1"] = max([out["stage1"]] + errs)
            check(ok, f"flat_lamb_stage1 {label}, m {str(m_dtype)[6:]}, "
                  f"found_inf {found}: m, v, u bit-equal (max_abs_err "
                  f"{max(errs):.3g}); partials p {parts[0][0]:.3g} "
                  f"({parts[0][1]:.3f}), u {parts[1][0]:.3g} "
                  f"({parts[1][1]:.3f}); params {ep:.3g} ({up:.3f} of "
                  "lamb_p_limit)")
            del got, want, p_got, p_want, u_want, lim
            torch.cuda.empty_cache()
        kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-6, step=3,
                  weight_decay=0.01)
        a = mta.flat_lamb(g, p, m, v, *segs, **kw)
        b = mta.flat_lamb(g, p, m, v, *segs, **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"flat_lamb {label}, m {str(m_dtype)[6:]}: two calls give "
              "the same bits (p, m, v)")
        del a, b, g, p, m, v
        torch.cuda.empty_cache()
    return out


# flat_sgd's five cases, held bit for bit (the JAX package's FusedSGD
# cases and the first run); each also with a bf16 buffer and the cast-out
SGD_CASES = {
    "first_run": dict(momentum=0.9, weight_decay=1e-4, first_run=True),
    "dampening": dict(momentum=0.9, dampening=0.1, weight_decay=1e-4),
    "nesterov": dict(momentum=0.9, nesterov=True, weight_decay=1e-4),
    "wd_after_momentum": dict(momentum=0.9, weight_decay=1e-4,
                              wd_after_momentum=True),
    "no_momentum": dict(weight_decay=1e-4),
}
NOVO_BETAS, NOVO_EPS = (0.95, 0.98), 1e-8   # FusedNovoGrad's defaults


def _in_place_runs(kernel, plain, g, p, states, extra, found, emit):
    """An in-place kernel twice and its plain version once, each on its
    own clones of p and the states: [kernel, kernel again, plain]."""
    fi = torch.tensor(found, device=p.device)
    runs = [fn(g, p.clone(), *[s.clone() for s in states], *extra, fi, emit)
            for fn in (kernel, kernel, plain)]
    torch.cuda.synchronize()
    return runs


def _bitwise(runs, p, states, found, emit, label):
    """Check the kernel's outputs equal the plain version's and the
    repeat's, bit for bit, the cast-out the cast of its p, and a skipped
    step the old values; returns the max |kernel - plain|."""
    got, again, want = runs
    ok = len(got) == len(want) and all(
        a.dtype == w.dtype and torch.equal(a, w) and torch.equal(a, b)
        for a, b, w in zip(got, again, want))
    err = max(float((a.float() - w.float()).abs().max())
              for a, w in zip(got, want))
    if emit is not None:
        ok &= torch.equal(got[-1], got[0].to(torch.bfloat16))
    if found:
        ok &= torch.equal(got[0], p) and all(
            torch.equal(a, s) for a, s in zip(got[1:], states))
    check(ok, f"{label}, found_inf {found}: bit-equal to the plain version "
          f"and to a repeat (max_abs_err {err:.3g})")
    return err


def sgd_family_parity(dev):
    mta = kernel_modules()[4]
    phase("kernel parity: flat_sgd, flat_adagrad and flat_novograd on "
          "BERT-Large's flat buffer (tolerance: bit for bit against the "
          "plain versions, the same fp32 operations in the same order, and "
          "against a second launch; the bf16 cast-out equal to the cast of "
          "the kernel's own p; found_inf True leaves p and the state as "
          "they were. NovoGrad's per-tensor v through the L2 partials "
          "kernel: to sum_sq_limit's 2 (n + 1) u of each tensor's ||g||^2)")
    bf, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(14)
    p, spec = bert_flat(dev)
    g = _rand(gen, p.shape, f32, dev, 1e-3)
    label = f"({spec.total_rows}, 128) = {p.numel()} elements"
    worst = dict(flat_sgd=0.0, flat_adagrad=0.0, flat_novograd=0.0)
    buf32 = _rand(gen, p.shape, f32, dev, 1e-3)
    for case, kw in SGD_CASES.items():
        hp = mta.sgd_hparams(**dict(dict(
            lr=0.1, momentum=0.0, dampening=0.0, weight_decay=0.0,
            nesterov=False, wd_after_momentum=False, first_run=False,
            grad_scale=1.0, device=dev), **kw))
        for buf, emit in ((buf32, None), (buf32.to(bf), bf)):
            for found in (False, True):
                runs = _in_place_runs(mta.flat_sgd_kernel,
                                      mta.flat_sgd_plain, g, p, [buf], [hp],
                                      found, emit)
                worst["flat_sgd"] = max(worst["flat_sgd"], _bitwise(
                    runs, p, [buf], found, emit,
                    f"flat_sgd {label}, {case}, buf {str(buf.dtype)[6:]}"
                    f"{', bf16 cast-out' if emit else ''}"))
                del runs
    del buf32
    torch.cuda.empty_cache()
    s = _rand(gen, p.shape, f32, dev, 1e-3).abs()
    for w_mode in (False, True):
        hp = mta.adagrad_hparams(lr=1e-2, eps=1e-10, weight_decay=0.01,
                                 adagrad_w_mode=w_mode, grad_scale=1.0,
                                 device=dev)
        for emit in (None, bf):
            for found in (False, True):
                runs = _in_place_runs(mta.flat_adagrad_kernel,
                                      mta.flat_adagrad_plain, g, p, [s],
                                      [hp], found, emit)
                worst["flat_adagrad"] = max(worst["flat_adagrad"], _bitwise(
                    runs, p, [s], found, emit,
                    f"flat_adagrad {label}, adagrad_w_mode {w_mode}"
                    f"{', bf16 cast-out' if emit else ''}"))
                del runs
    del s
    torch.cuda.empty_cache()
    ids, counts = spec.tile_tensor_ids(8).to(dev), spec.tile_counts(8).to(dev)
    v = _rand(gen, (spec.num_tensors,), f32, dev, 1e-3).abs()
    parts_k = mta.flat_l2norm_partials_kernel(g)
    parts_p = mta.flat_l2norm_partials_plain(g)
    gsq = mta.segment_sums(parts_p[:ids.numel()], counts)
    rel = 2.0 * (counts.double() * mta.SUB + 1) * mta.U
    v_use = 0.0
    m32 = _rand(gen, p.shape, f32, dev, 1e-3)
    for step in (1, 2):
        kw = dict(beta2=NOVO_BETAS[1], eps=NOVO_EPS, step=step,
                  bias_correction=True, init_zero=False)
        v_k, den_k = mta.novograd_moments(parts_k, v, counts, ids, **kw)
        v_p, _ = mta.novograd_moments(parts_p, v, counts, ids, **kw)
        # step 1 seeds v with ||g||^2, step 2 takes (1 - b2) of it
        share = 1.0 if step == 1 else 1.0 - NOVO_BETAS[1]
        e, use = _held(v_k, v_p, share * rel * gsq + 4 * mta.U * v_p)
        v_use = max(v_use, use)
        check(use <= 1.0, f"flat_novograd {label}, step {step}: per-tensor "
              f"v through the partials kernel, max_abs_err {e:.3g} ({use:.3f}"
              " of sum_sq_limit's share)")
        for m, emit in ((m32, None), (m32.to(bf), bf)):
            for reg in (False, True):
                hp = mta.novograd_hparams(
                    lr=1e-3, beta1=NOVO_BETAS[0], step=step,
                    weight_decay=0.01, grad_averaging=True,
                    bias_correction=True, reg_inside_moment=reg,
                    grad_scale=1.0, device=dev)
                for found in (False, True):
                    runs = _in_place_runs(
                        mta.flat_novograd_kernel, mta.flat_novograd_plain,
                        g, p, [m], [den_k, hp], found, emit)
                    worst["flat_novograd"] = max(
                        worst["flat_novograd"], _bitwise(
                            runs, p, [m], found, emit,
                            f"flat_novograd {label}, step {step}, m "
                            f"{str(m.dtype)[6:]}"
                            f"{', bf16 cast-out' if emit else ''}, "
                            f"reg_inside_moment {reg}"))
                    del runs
    worst["novograd_v_share"] = v_use
    del g, p, m32
    torch.cuda.empty_cache()
    return worst


# GPT-2 medium's four linears (K, N): qkv, out, fc1, fc2; and (K, N) of
# the logits head over the (50304, 1024) int8 word table
W8_LINEARS = ((1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024))
W8_TABLE = (1024, 50304)


def w8_operands(gen, dev, m, k, n, xdt, nk=False, bias=True):
    """x (m, k) in ``xdt``, a quantized (k, n) (or (n, k)) weight and its
    fp32 scales, a bias in ``xdt`` (the O2 tree's)."""
    from apex_tpu_torch.quant import quantize_tensor

    w = _rand(gen, (n, k) if nk else (k, n), torch.float32, dev,
              k ** -0.5)
    wq, scale = quantize_tensor(w, -1 if nk else -2)
    x = _rand(gen, (m, k), xdt, dev)
    b = _rand(gen, (n,), xdt, dev, 0.1) if bias else None
    return x, wq, scale, b


def _graph_of(fn):
    """``fn`` captured in a CUDA graph (after a warm-up on a side
    stream), and the output tensor the replays write."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def w8_parity(dev):
    w8 = kernel_modules()[5]
    phase("kernel parity: int8 weight-only matmuls (tolerance per element, "
          "quant.kernels.w8_limit: 2 K 2^-24 sum_k |x||w| for two fp32 sum "
          "orders, 2^-23 of the bias sum, one ulp of a bf16 output; two "
          "launches the same bits; at M <= 8 also across two CUDA-graph "
          "replays)")
    gen = torch.Generator(device=dev).manual_seed(14)
    bf, f32 = torch.bfloat16, torch.float32
    cases = [(m, k, n, bf, "bias") for m in (8, 1024)
             for k, n in W8_LINEARS]
    cases += [(8, 1024, 3072, f32, "bias"), (1024, 1024, 3072, f32, "bias"),
              (8, 4096, 1024, bf, "nobias"), (1, *W8_TABLE, bf, "nk"),
              (8, *W8_TABLE, bf, "nk"), (8, *W8_TABLE, f32, "nk"),
              (37, 100, 201, bf, "bias"), (37, 100, 201, f32, "nobias"),
              (37, 201, 100, bf, "nk")]   # the ragged case: byte loads
    # row 21 at the tensor-parallel int8 Row linears' shapes (M 8, the
    # decode tick's slots; out and fc2 at tp 2), fp32 x as that path
    # gives it, and bf16 x
    cases += [(8, k, n, xdt, "nobias") for k, n in TPS_ROW21.values()
              for xdt in (f32, bf)]
    # the logits head's tensor-core kernel (bf16 x, M <= 8): M 3, N off
    # its 16-channel tile, K off its 16-byte loads (byte loads), an x view
    # 2 bytes past a 16-byte boundary
    cases += [(3, *W8_TABLE, bf, "nk"), (8, 1024, 50300, bf, "nk"),
              (5, 200, 1000, bf, "nk"), (8, *W8_TABLE, bf, "nk_unaligned")]
    # the tensor-core kernel at the other prefill buckets, an M between 9
    # and 127, K split or not, and an x view 2 bytes past a 16-byte
    # boundary (element loads)
    cases += [(128, *W8_LINEARS[0], bf, "bias"), (512, *W8_LINEARS[2], bf,
                                                   "bias"),
              (128, *W8_LINEARS[3], bf, "nobias"),
              (512, *W8_LINEARS[3], bf, "nobias"),
              (1024, *W8_LINEARS[3], bf, "nobias"),
              (37, *W8_LINEARS[1], bf, "bias"), (100, *W8_LINEARS[3], bf,
                                                  "bias"),
              (128, *W8_LINEARS[0], bf, "bias_unaligned"),
              (1, *W8_LINEARS[0], bf, "bias")]
    worst = dict.fromkeys(("w8_matmul", "w8_matmul_nobias", "w8_matmul_nk"),
                          0.0)
    for m, k, n, xdt, kind in cases:
        nk = kind.startswith("nk")
        x, wq, scale, b = w8_operands(gen, dev, m, k, n, xdt, nk,
                                      kind.startswith("bias"))
        if kind.endswith("_unaligned"):
            buf = torch.empty(m * k + 1, dtype=xdt, device=dev)
            xv = buf[1:].view(m, k)
            xv.copy_(x)
            x = xv
        if nk:
            args = (x, wq, scale, f32)
            fk, fp = w8.w8_matmul_nk_kernel, w8.w8_matmul_nk_plain
            lim = w8.w8_limit(x, wq, scale, None, f32, nk=True)
        else:
            args = (x, wq, scale, b, xdt)
            fk, fp = w8.w8_matmul_kernel, w8.w8_matmul_plain
            lim = w8.w8_limit(x, wq, scale, b, xdt)
        got, again = fk(*args), fk(*args)
        same = torch.equal(got, again)
        note = "repeat bit-equal"
        if m <= 8:
            graph, out = _graph_of(lambda: fk(*args))
            for _ in range(2):
                graph.replay()
                torch.cuda.synchronize()
                same &= torch.equal(out, got)
            note += ", and across two CUDA-graph replays"
            del graph, out
        torch.cuda.synchronize()
        e, use = _held(got, fp(*args), lim)
        name = "w8_matmul" + ("" if kind.startswith("bias")
                              else "_nk" if nk else f"_{kind}")
        worst[name] = max(worst[name], e)
        view = f" (x at {x.data_ptr() % 16} bytes past 16)" \
            if x.data_ptr() % 16 else ""
        check(use <= 1.0 and same and got.dtype == args[-1],
              f"{name} M {m} K {k} N {n}, x {str(xdt)[6:]}{view} -> "
              f"{str(args[-1])[6:]}: max_abs_err {e:.3g} ({use:.4f} of "
              f"w8_limit), {note}")
        del x, wq, scale, b, got, again, lim
    torch.cuda.empty_cache()
    return worst


# jax 0.9.0's threefry streams (jax_threefry_partitionable=True) as
# constants, since the card's machine has no JAX (tests/test_torch_prng.py
# holds this table to the installed jax on the CPU): (call, words).
THREEFRY_KNOWN = (
    ("split(PRNGKey(0), 2)", [0x6B200159, 0x99BA4EFE, 0x375F238F,
                              0xCDDB151D]),
    ("fold_in(PRNGKey(0), 1)", [0x375F238F, 0xCDDB151D]),
    ("bits(PRNGKey(0), (4,))", [0xF29A4FA7, 0xFA843692, 0x55110E28,
                                0x77FAA835]),
    ("split(PRNGKey(42), 3)", [0x6D3E048F, 0x1022172D, 0x03D7B32D,
                               0xADD083F4, 0x92FB20EA, 0x0F38D913]),
    ("fold_in(PRNGKey(7), 2**32 - 1)", [0xDA0AA245, 0x667B358E]),
    ("bits(PRNGKey(1), (6,))", [0x704A38B7, 0x88A4083E, 0x7227B57A,
                                0x703ABFF1, 0xE5B993A4, 0x8F1716BC]),
    ("bits(fold_in(PRNGKey(3), 5), (3,))", [0x5D4A0FCC, 0x60842230,
                                            0xC6633E99]),
    ("bits(PRNGKey(-1), (2,))", [0x84B8C06F, 0x8C00439D]),
    ("uniform(PRNGKey(0), (4,)) as fp32 bits", [0x3F729A4E, 0x3F7A8436,
                                                0x3EAA221C, 0x3EEFF550]),
    ("randint(PRNGKey(1000), (6,), 0, 1000)", [244, 176, 595, 213, 280,
                                               349]),
)


def threefry_call(call, dev):
    """One row of ``THREEFRY_KNOWN`` computed by the port on ``dev`` (the
    bulk draws through the kernel on the card)."""
    p = kernel_modules()[6]
    k = p.PRNGKey
    out = {
        "split(PRNGKey(0), 2)": lambda: p.split(k(0), 2),
        "fold_in(PRNGKey(0), 1)": lambda: p.fold_in(k(0), 1),
        "bits(PRNGKey(0), (4,))": lambda: p.bits(k(0), (4,), device=dev),
        "split(PRNGKey(42), 3)": lambda: p.split(k(42), 3),
        "fold_in(PRNGKey(7), 2**32 - 1)": lambda: p.fold_in(k(7),
                                                            2 ** 32 - 1),
        "bits(PRNGKey(1), (6,))": lambda: p.bits(k(1), (6,), device=dev),
        "bits(fold_in(PRNGKey(3), 5), (3,))": lambda: p.bits(
            p.fold_in(k(3), 5), (3,), device=dev),
        "bits(PRNGKey(-1), (2,))": lambda: p.bits(k(-1), (2,), device=dev),
        "uniform(PRNGKey(0), (4,)) as fp32 bits": lambda: p.uniform(
            k(0), (4,), device=dev).view(torch.int32).to(torch.int64)
        & p.M32,
        "randint(PRNGKey(1000), (6,), 0, 1000)": lambda: p.randint(
            k(1000), (6,), 0, 1000, device=dev),
    }[call]()
    return [int(w) for w in out.reshape(-1).tolist()]


# the shapes the paths draw at: the decode tick's gumbel noise (8 slots x
# GPT-2's vocabulary), BERT-Large's hidden dropout and its unfused
# attention probabilities (batch 64, seq 128)
BITS_SHAPES = ((1, 1), (1, 3), (8, 50304), (1, 64 * 128 * 1024))
HIDDEN_SHAPE, PROBS_SHAPE = (64, 128, 1024), (64, 16, 128, 128)


def threefry_parity(dev):
    """The bits kernel and the fused dropout against their plain int64
    versions on the same card inputs, bit for bit; the known answers."""
    p = kernel_modules()[6]
    phase("kernel parity: threefry bits and dropout (bit for bit against "
          "the plain int64 version; jax 0.9.0's known answers)")
    for call, want in THREEFRY_KNOWN:
        got = threefry_call(call, dev)
        check(got == want, f"{call}: {[hex(w) for w in got]}")
    for rows, n in BITS_SHAPES:
        keys = p.split(p.PRNGKey(rows * 7 + n), rows)
        got = p.threefry_bits_kernel(keys, n, dev)
        again = p.threefry_bits_kernel(keys, n, dev)
        want = p.threefry_bits_plain(keys, n, dev)
        torch.cuda.synchronize()
        check(torch.equal(got, want) and torch.equal(got, again),
              f"bits, {rows} key(s) x {n}: equal to the plain version, "
              "twice")
    gen = torch.Generator(device=dev).manual_seed(11)
    worst = 0.0
    for shape, dt, rate in ((HIDDEN_SHAPE, torch.bfloat16, 0.1),
                            (HIDDEN_SHAPE, torch.float32, 0.1),
                            (PROBS_SHAPE, torch.bfloat16, 0.1),
                            ((1001,), torch.float32, 0.5)):
        x = _rand(gen, shape, dt, dev)
        words = p.host_bits(p.PRNGKey(len(shape)), 2)
        got = p.dropout_kernel(x, words, rate)
        again = p.dropout_kernel(x, words, rate)
        want = p.dropout_plain(x, words, rate)
        static = torch.empty_like(x)
        graph, _ = _graph_of(lambda: static.copy_(p.dropout_kernel(
            x, words, rate)))
        graph.replay()
        torch.cuda.synchronize()
        worst = max(worst, float((got.float() - want.float()).abs().max()))
        kept = float((want != 0).float().mean())
        check(torch.equal(got, want) and torch.equal(got, again)
              and torch.equal(static, got),
              f"dropout {tuple(shape)} {str(dt)[6:]} rate {rate}: equal to "
              f"the plain version, twice and under a graph replay "
              f"({kept:.4f} kept)")
    return {"threefry_bits": 0.0, "threefry_dropout": worst}


def sampler_parity(dev):
    """``sample_tokens`` on the card against the CPU on the same logits and
    keys: tokens equal, or a flip of a sampled row inside the error model
    (its two best perturbed scores within twice ``prng.gumbel_limit``, or
    its top-k / nucleus support moved: the card's softmax and running sum
    round otherwise at the boundary)."""
    from apex_tpu_torch.serving.sampling import _restrict, sample_tokens

    p = kernel_modules()[6]
    phase("sampler parity: sample_tokens on the card vs the CPU, (8, 50304) "
          "fp32 logits, temperatures 0 / 0.7 / 1.3, top_k 50, top_p 0.9 and "
          "both")
    v = 50304
    logits = torch.randn(8, v, generator=torch.Generator().manual_seed(5)) \
        * 3
    temps = torch.tensor([0.0, 0.7, 1.3, 0.7, 1.3, 0.0, 0.7, 1.3])
    keys = torch.stack([p.fold_in(p.PRNGKey(i), 3) for i in range(8)])
    out = {}
    drawn = temps > 0
    for top_k, top_p in ((0, 0.0), (50, 0.0), (0, 0.9), (50, 0.9)):
        got = sample_tokens(logits.to(dev), keys, temps.to(dev), top_k,
                            top_p).cpu()
        want = sample_tokens(logits, keys, temps, top_k, top_p)
        support = torch.isfinite(_restrict(logits, top_k, top_p))
        moved = (torch.isfinite(_restrict(logits.to(dev), top_k, top_p))
                 .cpu() != support).any(-1)
        score = torch.where(support, logits, -torch.inf) / temps.clamp(
            min=1e-6)[:, None] + p.gumbel_rows(keys, v, "cpu")
        top2 = score.topk(2).values
        gap = top2[:, 0] - top2[:, 1]
        lim = 2 * p.gumbel_limit(top2[:, 0])
        flips = int((got != want).sum())
        ok = bool(((got == want) | (drawn & ((gap <= lim) | moved))).all())
        check(ok, f"top_k {top_k}, top_p {top_p}: {flips} of 8 tokens "
              f"differ from the CPU's; smallest top-two gap of a sampled "
              f"row {float(gap[drawn].min()):.3g} (limit "
              f"{float(lim[drawn].max()):.3g}); rows whose support moved "
              f"on the card: {int(moved.sum())}")
        out[f"k{top_k}_p{top_p}"] = dict(flips=flips, min_gap=float(
            gap[temps > 0].min()))
    return out


# ---------------------------------------------------------------------------
# 3. serving at full width
# ---------------------------------------------------------------------------

def _logits_full(params, cfg, seq):
    from apex_tpu_torch.models.gpt import apply_gpt_unsharded

    hidden = apply_gpt_unsharded(params, cfg, seq)
    table = params["embedding"]["word"]["embedding"]
    return torch.matmul(hidden, table.to(hidden.dtype).t()).float()


def decode_vs_full(params, cfg, dev, cache_dtype, label, tol, ref=None,
                   engine=None, tol_rel=False, **engine_kw):
    """Prefill one prompt, decode 4 greedy steps, and hold the 4 decode
    logits rows against the full forward of ``ref`` (default the same
    params) at the same positions. ``engine``: the engine class
    (``DecodeEngine`` by default; a paged engine gets
    ``prepare_decode`` before each step); ``tol_rel``: ``tol`` is a share
    of the full forward's largest |logit|."""
    from apex_tpu_torch.serving import DecodeEngine

    eng = (engine or DecodeEngine)(params, cfg, num_slots=1,
                                   max_len=MAX_LEN, cache_dtype=cache_dtype,
                                   buckets=BUCKETS, device=dev, **engine_kw)
    rng = np.random.RandomState(1)
    prompt = [int(t) for t in rng.randint(0, cfg.vocab_size, size=100)]
    tok = int(eng.prefill(0, prompt)[0].argmax())
    fed, rows = [], []
    for _ in range(4):
        fed.append(tok)
        check(eng.prepare_decode({0: len(prompt) + len(fed) - 1}) == [],
              "no preemption")
        logits = eng.decode([tok], [True])
        rows.append(logits[0])
        tok = int(logits[0].argmax())
    got = torch.stack(rows)
    seq = torch.tensor([prompt + fed], device=dev)
    want = _logits_full(params if ref is None else ref, cfg,
                        seq)[0, len(prompt):]
    err = float((got - want).abs().max())
    top = float(want.abs().max())
    lim = tol * top if tol_rel else tol
    check(err <= lim, f"decode vs full forward ({label}), 4 steps: "
          f"max_abs_err {err:.4g} <= {lim:.4g} (max|logit| {top:.3g})")
    return err


def dequantized(qparams):
    """The fp32 tree a weight-only int8 tree stands for: each int8 kernel
    and the word table dequantized (``dequantize_tensor``), the rest as
    it is."""
    from apex_tpu_torch.quant import dequantize_tensor

    word = qparams["embedding"]["word"]
    layers = {name: ({"kernel": dequantize_tensor(p["kernel"], p["scale"],
                                                  -2), "bias": p["bias"]}
                     if "scale" in p else p)
              for name, p in qparams["layers"].items()}
    return dict(qparams, layers=layers, embedding=dict(
        qparams["embedding"], word={"embedding": dequantize_tensor(
            word["embedding"], word["scale"], -1)}))


def mix_prompts(cfg):
    """The 16 prompts of the serving mix: 64-960 random tokens each."""
    rng = np.random.RandomState(0)
    lens = rng.randint(64, 961, size=N_REQUESTS)
    return [tuple(int(t) for t in rng.randint(0, cfg.vocab_size,
                                              size=int(n))) for n in lens]


def serve_mix(dev, cfg, params, kern, temps=None, engine=None, prompts=None,
              audit=False, cache_dtype=torch.bfloat16, num_slots=NUM_SLOTS,
              setup=None, **engine_kw):
    """The request mix on one engine (8 slots, bf16 cache), after a
    one-request warm-up; every kernel's count set to 0 just before the
    run and read just after. ``temps``: each request's temperature
    (greedy without), its seed its index. ``engine``: the engine class
    (``DecodeEngine`` by default); ``prompts``: other prompts than
    :func:`mix_prompts`'; ``audit``: ``check_invariants()`` after every
    tick; ``setup(engine)``: called on the new engine, returns counters
    (name -> zero-argument callable) read as deltas over the run.
    Returns the streams, launches, prefills, decode steps and wall time,
    the scheduler's speculation counters, and a paged engine's pool
    counts (pages matched from the prefix cache, copy-on-write clones,
    preemptions, refused admissions; a host tier's spills and
    promotions)."""
    from apex_tpu_torch.serving import (
        ContinuousBatchingScheduler, DecodeEngine, Request,
    )

    eng = (engine or DecodeEngine)(params, cfg, num_slots=num_slots,
                                   max_len=MAX_LEN, cache_dtype=cache_dtype,
                                   buckets=BUCKETS, device=dev, **engine_kw)
    probes = setup(eng) if setup is not None else {}
    # warm-up: one short request (library handles, allocator)
    warm = ContinuousBatchingScheduler(eng, eos_id=-1)
    warm.submit(Request(prompt=(1, 2, 3), max_new_tokens=2))
    warm.run()
    shared = [0]
    if eng.paged:
        matched = eng.pool.match_prefix

        def counting(keys):
            pages = matched(keys)
            shared[0] += len(pages)
            return pages

        eng.pool.match_prefix = counting
    sched = ContinuousBatchingScheduler(eng, eos_id=-1)
    prompts = mix_prompts(cfg) if prompts is None else prompts
    n_req = len(prompts)
    for i, prompt in enumerate(prompts):
        sched.submit(Request(prompt=prompt, max_new_tokens=NEW_TOKENS,
                             temperature=0.0 if temps is None else temps[i],
                             seed=i))
    torch.cuda.synchronize()
    for k in kern.values():
        k.launches = 0
    base = {n: f() for n, f in probes.items()}
    # the engine's counters, as deltas over the run (the warm-up's ticks
    # count on the same engine)
    st0 = eng.stats.as_dict()
    t0 = time.perf_counter()
    ticks = audits = 0
    while sched.busy:
        sched.step()
        ticks += 1
        if audit:
            audits += bool(eng.check_invariants())
    streams = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: k.launches for n, k in kern.items()}
    if audit:
        check(audits == ticks, f"check_invariants() true after each of "
              f"the {ticks} ticks")
    print(f"prompt lengths {[len(p) for p in prompts]}")
    reasons = [sched.outcomes[i].reason for i in range(n_req)]
    n_tok = sum(len(s) for s in streams)
    check(len(streams) == n_req
          and all(r == "length" for r in reasons)
          and all(len(s) == NEW_TOKENS for s in streams),
          f"{len(streams)} requests finished, reasons {set(reasons)}, "
          f"{n_tok} tokens")
    check(all(0 <= t < cfg.vocab_size for s in streams for t in s),
          "every token inside the vocabulary")
    print(f"served {n_tok} tokens in {wall:.3f} s wall: "
          f"{n_tok / wall:.1f} tokens/s (prefill included)", flush=True)
    print(f"first stream: {streams[0][:8]}...")
    out = dict(streams=streams, launches=launches, wall_s=wall,
               tokens=n_tok, tokens_per_s=n_tok / wall, ticks=ticks,
               clock=sched._tick_no, decode_steps=sched.decode_steps,
               **{n: sched.stats.as_dict()[n] - st0[n] for n in (
                   "plain_ticks", "spec_ticks", "tokens_drafted",
                   "tokens_accepted")},
               prefills=sum(o.prefill_ticks for o in sched.outcomes.values()),
               **{n: f() - base[n] for n, f in probes.items()})
    out["acceptance_rate"] = (out["tokens_accepted"] / out["tokens_drafted"]
                              if out["tokens_drafted"] else 0.0)
    if eng.paged:
        out.update(shared_pages=shared[0], cached=eng.pool.num_cached,
                   **{n: eng.stats.as_dict()[n] - st0[n] for n in (
                       "cow_copies", "preemptions", "pool_exhausted")})
        if eng.host_tier is not None:
            out.update({n: eng.stats.as_dict()[n] - st0[n]
                        for n in TIER_COUNTERS})
            out["host_hit_rate"] = eng.host_tier.hit_rate
    return out


def check_launches(launches, want, label):
    """Every kernel's count in the run equals ``want`` (0 where absent)."""
    want = {n: want.get(n, 0) for n in launches}
    got = {n: c for n, c in launches.items() if c}
    check(launches == want, f"launches during the {label} run: {got} "
          f"(expected {({n: c for n, c in want.items() if c})}, every "
          "other kernel 0)")


def serve(dev, kern):
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.gpt import gpt_medium, init_gpt
    from apex_tpu_torch.quant import quantize_params

    phase("serving: gpt_medium, 16 greedy requests x 32 tokens, 8 slots")
    cfg = gpt_medium()
    L = cfg.num_layers
    t0 = time.perf_counter()
    params = init_gpt(cfg, torch.Generator().manual_seed(0), device=dev)
    print(f"init_gpt (fp32, seed 0) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    out = {}
    with torch.inference_mode():
        # limits: 2x the error measured on an H100 at these seeds
        # (fp32 4.3e-6 -> 1e-5; bf16 0.031 -> 0.0625)
        out["decode_err_fp32"] = decode_vs_full(
            params, cfg, dev, torch.float32, "fp32 params and cache", 1e-5)
        # the w8 steps and the dequantized tree's forward read the same
        # fp32 weights and differ only in sum orders: the fp32 limit
        qparams = quantize_params(params)
        out["decode_err_w8_fp32"] = decode_vs_full(
            qparams, cfg, dev, torch.float32, "w8 of the fp32 params, fp32 "
            "compute and cache, against the dequantized tree", 1e-5,
            ref=dequantized(qparams))
        del qparams
        params = amp.initialize("O2", verbosity=0).cast_model(params)
        torch.cuda.empty_cache()
        out["decode_err_bf16"] = decode_vs_full(
            params, cfg, dev, torch.bfloat16,
            "O2 bf16 params and cache", 0.0625)
        bf = serve_mix(dev, cfg, params, kern)
        per = 2 * L + 1
        forwards = N_REQUESTS + bf["decode_steps"]
        check_launches(bf["launches"], {
            "layer_norm_fwd": per * forwards,
            "flash_attention_fwd": L * N_REQUESTS}, "bf16 serving")
        phase("serving_w8: the same 16 requests on quantize_params of the "
              "O2 params, bf16 compute and cache")
        w8 = serve_mix(dev, cfg, quantize_params(params), kern,
                       compute_dtype=torch.bfloat16)
        forwards_w8 = N_REQUESTS + w8["decode_steps"]
        check_launches(w8["launches"], {
            "layer_norm_fwd": per * forwards_w8,
            "flash_attention_fwd": L * N_REQUESTS,
            "w8_matmul": 4 * L * forwards_w8,
            "w8_matmul_nk": forwards_w8}, "w8 serving")
        sp = serve_sampled(dev, cfg, params, kern, bf["streams"])
    pairs = [(a, b) for s, t in zip(bf["streams"], w8["streams"])
             for a, b in zip(s, t)]
    same = sum(a == b for a, b in pairs)
    print(f"greedy tokens equal to the bf16 run's (for information): "
          f"{same} of {len(pairs)}; tokens/s bf16 {bf['tokens_per_s']:.1f},"
          f" w8 {w8['tokens_per_s']:.1f}", flush=True)
    dense_streams = bf.pop("streams")
    del w8["streams"]
    out.update(bf16=bf, w8=w8, sampled=sp, w8_tokens_equal_to_bf16=same,
               tokens_compared=len(pairs))
    return out, dense_streams


SAMPLED_T, SAMPLED_TOP_K = 0.8, 50   # examples/gpt/generate.py's example


def serve_sampled(dev, cfg, params, kern, greedy_streams):
    """The 16 requests again on the O2 params, the odd ones sampled at
    temperature 0.8 with their index as seed, on DecodeEngine(top_k=50),
    twice: the replay commits the same streams; exact launches of every
    kernel but the bits kernel, whose launches are one per sampled
    prefill and one per decode tick that holds a sampled slot."""
    L = cfg.num_layers
    phase(f"serving_sampled: the same 16 requests on the O2 params, the "
          f"odd ones sampled at temperature {SAMPLED_T} (seed = request "
          f"index), DecodeEngine(top_k={SAMPLED_TOP_K}), run twice")
    temps = [SAMPLED_T if i % 2 else 0.0 for i in range(N_REQUESTS)]
    runs = [serve_mix(dev, cfg, params, kern, temps=temps,
                      top_k=SAMPLED_TOP_K) for _ in range(2)]
    sp = runs[0]
    check(runs[0]["streams"] == runs[1]["streams"],
          f"replay: the second run commits the same {N_REQUESTS} streams")
    n_sampled, steps = N_REQUESTS // 2, sp["decode_steps"]
    bits = sp["launches"]["threefry_bits"]
    check(n_sampled <= bits <= n_sampled + steps,
          f"threefry_bits launches {bits}: {n_sampled} sampled prefills "
          f"and at most one a decode tick ({steps} ticks)")
    check_launches(sp["launches"], {
        "layer_norm_fwd": (2 * L + 1) * (N_REQUESTS + steps),
        "flash_attention_fwd": L * N_REQUESTS, "threefry_bits": bits},
        "sampled serving")
    same = sum(sp["streams"][i] == greedy_streams[i]
               for i in range(0, N_REQUESTS, 2))
    print(f"greedy requests equal to the serving phase's streams (for "
          f"information): {same} of {N_REQUESTS - n_sampled}; bits launches "
          f"a decode tick {(bits - n_sampled) / steps:.3f}; smoke reading, "
          f"not a benchmark: {sp['tokens_per_s']:.1f} tokens/s (greedy "
          "run's in the serving phase)", flush=True)
    del sp["streams"]
    sp.update(greedy_equal_to_serving=same,
              bits_per_decode_tick=(bits - n_sampled) / steps,
              replay_wall_s=runs[1]["wall_s"])
    return sp


# ---------------------------------------------------------------------------
# 4. training at full width
# ---------------------------------------------------------------------------

LR = 1e-4        # make_bert_train_step's FusedAdam
LAMB_LR = 1e-3   # and its FusedLAMB
SMALL_BATCH, SMALL_LAYERS, BIG_BATCH, SEQ, BIG_STEPS = 8, 2, 64, 128, 6
# card step vs CPU step (relative norm of the difference per leaf; loss
# relative; master absolute). O0: fp32 sums of up to 30522 terms in
# other orders, about sqrt(n) 2^-24 ~ 1e-5 relative per product,
# compounded through two layers and back: 1e-4 (v, a square: 2e-4).
# Master: an Adam step moves a leaf by at most lr (|m^|/sqrt(v^) <= 1
# on the first step) beside the weight decay both share, and a gradient
# within rounding of zero may change sign, so 2 lr (plus 1e-6 for the
# roundings of p - lr u) in both levels. O2: about 4x the error measured
# on an H100 (700 W) at these seeds: loss 5.2e-6, gradients and m
# 0.025, v 0.038, master 2.0e-4 (one sign flip).
STEP_LIMITS = {
    "O0": {"loss": 1e-5, "grads": 1e-4, "m": 1e-4, "v": 2e-4,
           "master": 2 * LR + 1e-6},
    "O2": {"loss": 2e-5, "grads": 0.1, "m": 0.1, "v": 0.15,
           "master": 2 * LR + 1e-6},
}
# The flat FusedLAMB configuration: loss, gradients, m and v as above (m
# = beta3 g / clip, v its square: the clip's norm agrees far inside
# these). Master is held per element to LAMB's own error model
# (``lamb_master_limit``), as tests/test_torch_bert_train.py holds the
# port to the JAX package: each side's step p - lr r u is recomputed in
# float64 from the master before it and that side's own new m and v (u =
# m^ / (sqrt(v^) + eps) + wd p, r = ||p|| / ||u|| over the leaf), and
# the two masters may differ by the difference of those two results
# plus each side's fp32 roundings: the ratio's sums of squares ((1024 +
# k) u for the flat path's two levels over a leaf of k sub-tiles, plus
# 3 u), 16 u of u (2^-8 more with a bf16 m), 2 u of the product and an
# ulp of p. A gradient near zero that changes sign between card and CPU
# moves an element by up to 2 lr r, and the model carries it exactly;
# a step that leaves master where it was, or moves it the wrong way,
# misses by lr r |u| on every element.
LAMB_EPS, LAMB_WD = 1e-6, 0.01   # make_bert_train_step's FusedLAMB
U32 = 2.0 ** -24                 # fp32 unit roundoff

def _relnorm(got_tree, want_tree):
    from apex_tpu_torch.utils.tree import tree_leaves

    worst = 0.0
    for g, w in zip(tree_leaves(got_tree), tree_leaves(want_tree)):
        g, w = g.detach().to(w.device).double(), w.detach().double()
        n = float(w.norm())
        worst = max(worst, float((g - w).norm()) / (n if n > 0 else 1.0))
    return worst


def _maxabs(got_tree, want_tree):
    from apex_tpu_torch.utils.tree import tree_leaves

    return max(float((g.cpu().double() - w.double()).abs().max())
               for g, w in zip(tree_leaves(got_tree), tree_leaves(want_tree)))


KERNEL_NAMES = ("layer_norm_fwd", "layer_norm_bwd", "flash_attention_fwd",
                "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                "xentropy_fwd", "xentropy_bwd", "scaled_masked_softmax_fwd",
                "scaled_upper_triang_softmax_fwd", "fused_softmax_bwd",
                "flat_adam", "flat_scale", "flat_axpby",
                "flat_l2norm_partials", "flat_lamb_stage1",
                "w8_matmul_nobias", "w8_matmul", "w8_matmul_nk", "flat_sgd",
                "flat_adagrad", "flat_novograd", "threefry_bits",
                "threefry_dropout", "paged_decode_attention",
                "paged_verify_attention", "paged_chunk_attention")
# kernels on no model path (held to their plain versions and timed)
OFF_PATH = ("scaled_upper_triang_softmax_fwd", "flat_scale", "flat_axpby",
            "w8_matmul_nobias")
# the step's three configurations, through the JAX package's own
# switches: name -> (cfg.fused_attention, the optimizer, its
# use_flat_kernel)
STEP_CONFIGS = {"flash_tree": (True, "adam", False),
                "softmax_flat": (False, "adam", True),
                "flash_lamb_flat": (True, "lamb", True)}


def _step_cfg(name, **kw):
    import dataclasses

    from apex_tpu_torch.models.bert import bert_large

    return dataclasses.replace(bert_large(),
                               fused_attention=STEP_CONFIGS[name][0], **kw)


def _key(name, label):
    """Result keys: the first configuration keeps its plain labels."""
    return label if name == "flash_tree" else f"{label} {name}"


# the configurations the dropout runs take: flash attention (the flash
# kernels' hash, seeded by bits(key, (2,))) and the unfused attention
# (Bernoulli draws on the probabilities through the dropout kernel)
DROPOUT_CONFIGS = ("flash_tree", "softmax_flat")
DROPOUT_SEED = 0


def train_small(dev):
    """One step of the 2-layer full-width model on the card and on the
    CPU from the same weights, in O0 and O2, in each configuration; then
    the same step with the model's dropout (``dropout_rng``) in the
    dropout configurations, held to the unchanged limits: the masks are
    the same bits on both devices."""
    out = {}
    for name, (_, opt, flat) in STEP_CONFIGS.items():
        cfg = _step_cfg(name, num_layers=SMALL_LAYERS)
        for level, lim in STEP_LIMITS.items():
            out[_key(name, level)] = _train_small_one(
                dev, cfg, opt, flat, level, lim, name)
    for name in DROPOUT_CONFIGS:
        _, opt, flat = STEP_CONFIGS[name]
        cfg = _step_cfg(name, num_layers=SMALL_LAYERS)
        for level, lim in STEP_LIMITS.items():
            out[_key(name, level) + " dropout"] = _train_small_one(
                dev, cfg, opt, flat, level, lim, name, dropout=True)
    return out


def lamb_master_limit(prev, state_d, state_c, lr=LAMB_LR, wd=LAMB_WD):
    """{leaf: per-element limit on |master_card - master_cpu|} (a tree
    like ``prev``) after the first flat FusedLAMB step (at ``lr`` and
    weight decay ``wd``) from master ``prev`` on both, the card's state
    ``state_d`` and the CPU's ``state_c`` (the model above), computed on
    ``prev``'s device."""
    from apex_tpu_torch.multi_tensor_apply.flatten import (
        make_spec, unflatten_tensors,
    )
    from apex_tpu_torch.utils.tree import tree_flatten, tree_unflatten

    leaves, treedef = tree_flatten(prev)
    spec = make_spec(leaves)
    dev = leaves[0].device
    # step 1's bias corrections as the kernel has them, in fp32
    c1 = float(1.0 - torch.tensor(0.9))
    c2 = float(1.0 - torch.tensor(0.999))
    bf = 2.0 ** -8 if state_c.m.dtype == torch.bfloat16 else 0.0
    sides = []
    for st in (state_d, state_c):
        steps = []
        for p, m, v in zip(leaves,
                           unflatten_tensors(st.m.to(dev), spec, False),
                           unflatten_tensors(st.v.to(dev), spec, False)):
            p = p.double()
            u = (m.double() / c1) / (torch.sqrt(v.double() / c2)
                                     + LAMB_EPS) + wd * p
            wn, un = float(p.norm()), float(u.norm())
            r = wn / un if wn > 0 and un > 0 else 1.0
            steps.append((p - lr * r * u, lr * r * u.abs()))
        sides.append(steps)
    lims = []
    for p, (pd, sd), (pc, sc) in zip(leaves, *sides):
        k = -(-max(p.numel(), 1) // 1024) + 32   # + the buffer's tail
        rel = (1024 + k + 3 + 16 + 2) * U32 + bf
        lims.append((pd - pc).abs() + (sd + sc) * rel
                    + 2 * U32 * (pd.abs() + pc.abs()))
    return tree_unflatten(treedef, lims)


def _share(got, want, lim):
    """The largest |got - want| / lim; an element with a zero limit must
    be equal (it counts 0 then, inf else)."""
    d = (got.to(want.device).double() - want.double()).abs()
    return float(torch.where(d <= lim, d / lim.clamp_min(1e-300),
                             torch.full_like(d, float("inf"))).max())


def _train_small_one(dev, cfg, opt, flat, level, lim, name, dropout=False):
    from apex_tpu_torch.examples.bert.train import make_bert_train_step
    from apex_tpu_torch.utils.tree import tree_leaves, tree_map

    p = kernel_modules()[6]
    key = p.PRNGKey(DROPOUT_SEED) if dropout else None
    with_drop = (f", dropout {cfg.hidden_dropout} on PRNGKey("
                 f"{DROPOUT_SEED})") if dropout else ""
    phase(f"training ({name}): BERT-Large width, {SMALL_LAYERS} layers, "
          f"batch {SMALL_BATCH}, seq {SEQ}, {level}{with_drop}: one step on "
          "the card (kernels) vs the same step on the CPU (plain versions)")
    step_d, make_state, (ids, mask) = make_bert_train_step(
        SMALL_BATCH, SEQ, cfg, device=dev, opt_level=level,
        use_flat_kernel=flat, optimizer=opt, dropout_rng=key)
    state_d = list(make_state())
    step_c, _, (ids_c, mask_c) = make_bert_train_step(
        SMALL_BATCH, SEQ, cfg, device="cpu", opt_level=level,
        use_flat_kernel=flat, optimizer=opt, dropout_rng=key)
    # the step's first call draws on fold_in(key, 0): so do its gradients
    key0 = None if key is None else p.fold_in(key, 0)
    master_c = tree_map(lambda t: t.cpu(), state_d[0])
    state_c = [master_c, step_c.opt.init(master_c),
               step_c.amp.init_state("cpu")]
    check(torch.equal(ids.cpu(), ids_c), "same ids on both devices")
    t0 = time.perf_counter()
    _, _, grads_d, found_d, _ = step_d.grads(state_d[0], state_d[2],
                                             ids, mask, dropout_rng=key0)
    new_d = step_d(*state_d, ids, mask)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, _, grads_c, found_c, _ = step_c.grads(state_c[0], state_c[2],
                                             ids_c, mask_c, dropout_rng=key0)
    new_c = step_c(*state_c, ids_c, mask_c)
    t2 = time.perf_counter()
    loss_d, loss_c = float(new_d[-1]), float(new_c[-1])
    got = {
        "loss": abs(loss_d - loss_c) / abs(loss_c),
        "grads": _relnorm(grads_d, grads_c),
        "m": _relnorm(new_d[1].m, new_c[1].m),
        "v": _relnorm(new_d[1].v, new_c[1].v),
        "master": _maxabs(new_d[0], new_c[0]),
    }
    if opt == "lamb":   # the share of the per-element model used
        lims = lamb_master_limit(master_c, new_d[1], new_c[1])
        got["master_share"] = max(
            _share(g, w, l) for g, w, l in zip(
                tree_leaves(new_d[0]), tree_leaves(new_c[0]),
                tree_leaves(lims)))
        # master: the largest of the per-element limits
        lim = dict(lim, master_share=1.0, master=max(
            float(l.max()) for l in tree_leaves(lims)))
    print(f"card {t1 - t0:.2f} s, CPU {t2 - t1:.2f} s; loss card "
          f"{loss_d:.6f}, CPU {loss_c:.6f}", flush=True)
    check(not bool(found_d) and not bool(found_c)
          and float(new_d[2].loss_scale) == float(new_c[2].loss_scale)
          and int(new_d[2].unskipped) == int(new_c[2].unskipped) == 1
          and int(new_d[1].step) == int(new_c[1].step) == 1,
          "found_inf False on both; scaler states and step counts equal")
    for key, val in got.items():
        what = {"master": "max abs", "master_share": "share of "
                "lamb_master_limit"}.get(key, "relative")
        # the share sits just under 1 by construction: print it in full
        shown = f"{val:.7f}" if key == "master_share" else f"{val:.3g}"
        check(val <= lim[key], f"{level} {key}: card vs CPU {what} "
              f"{shown} <= {lim[key]:g}")
    del state_d, new_d, grads_d
    torch.cuda.empty_cache()
    return got


def per_step_launches(name, L, dropout=False):
    """Exact launches of each kernel in one BERT step of ``L`` layers:
    with dropout, the dropout kernel once forward and once backward (the
    backward regenerates the mask) on the embeddings and each layer's
    attention output, and in the unfused attention on each layer's
    probabilities too; the bits kernel never (the flash seed is drawn on
    the host)."""
    flash, opt, flat = STEP_CONFIGS[name]
    out = dict.fromkeys(KERNEL_NAMES, 0)
    out.update(layer_norm_fwd=2 * L + 2, layer_norm_bwd=2 * L + 2,
               xentropy_fwd=1, xentropy_bwd=1)
    if flash:
        out.update(flash_attention_fwd=L, flash_attention_bwd_dq=L,
                   flash_attention_bwd_dkv=L)
    else:
        out.update(scaled_masked_softmax_fwd=L, fused_softmax_bwd=L)
    if flat and opt == "adam":
        out.update(flat_adam=1)
    elif flat:
        out.update(flat_l2norm_partials=1, flat_lamb_stage1=1)
    if dropout:
        out.update(threefry_dropout=2 * (L + 1) if flash else 2 * (2 * L + 1))
    return out


def train_big(dev, kern):
    """Six O2 steps of full BERT-Large at the headline's shape in each
    configuration and optimizer-state mode; ``kern`` maps names to the
    kernels counted."""
    from apex_tpu_torch.examples.bert.train import STATE_MODES

    out = {}
    for name in STEP_CONFIGS:
        for mode, (m_dtype, emit) in STATE_MODES.items():
            out[_key(name, mode)] = _train_big_one(dev, kern, name, mode,
                                                   m_dtype, emit)
    out["fp32 dropout"] = _train_big_one(dev, kern, "flash_tree", "fp32",
                                         *STATE_MODES["fp32"], dropout=True)
    return out


def _train_big_one(dev, kern, name, mode, m_dtype, emit, dropout=False,
                   level="O2"):
    from apex_tpu_torch.examples.bert.train import make_bert_train_step
    from apex_tpu_torch.utils.tree import tree_leaves

    cfg = _step_cfg(name)
    L = cfg.num_layers
    per_step = per_step_launches(name, L, dropout)
    with_drop = (f", hidden and attention dropout {cfg.hidden_dropout} on "
                 f"fold_in(PRNGKey({DROPOUT_SEED}), step)") if dropout else ""
    in_autocast = ", each forward inside h.autocast()" if level == "O1" \
        else ""
    phase(f"training ({name}): BERT-Large ({L} layers), {level} dynamic "
          f"loss scale{in_autocast}, batch {BIG_BATCH}, seq {SEQ}, "
          f"{BIG_STEPS} steps, state mode {mode}{with_drop}")
    _, opt, flat = STEP_CONFIGS[name]
    key = kernel_modules()[6].PRNGKey(DROPOUT_SEED) if dropout else None
    step, make_state, (ids, mask) = make_bert_train_step(
        BIG_BATCH, SEQ, cfg, m_dtype=m_dtype, emit_compute=emit,
        device=dev, use_flat_kernel=flat, optimizer=opt, dropout_rng=key,
        opt_level=level)
    state = list(make_state())
    products = o1_product_dtypes(step, state[0], ids, mask) \
        if level == "O1" else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kern.values():
        k.launches = 0
    losses, times, steps_ok = [], [], True
    for _ in range(BIG_STEPS):
        before = {n: k.launches for n, k in kern.items()}
        t0 = time.perf_counter()
        *state, loss = step(*state, ids, mask)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        steps_ok &= all(kern[n].launches - before[n] == per_step[n]
                        for n in kern)
    launches = {n: k.launches for n, k in kern.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(l) for l in losses]
    sc = state[2]
    print(f"losses {[round(l, 5) for l in losses]}", flush=True)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "every loss finite, the last below the first")
    check(int(sc.unskipped) == BIG_STEPS and int(sc.overflows) == 0,
          f"found_inf False on every step: scaler unskipped "
          f"{int(sc.unskipped)} == {BIG_STEPS}, overflows "
          f"{int(sc.overflows)}, loss scale {float(sc.loss_scale):g}")
    check(steps_ok and all(launches[n] == BIG_STEPS * per_step[n]
                           for n in kern),
          f"launches per step exactly {per_step} ({launches} over "
          f"{BIG_STEPS} steps)")
    if dropout:
        print(f"threefry dropout launches a step: "
              f"{launches['threefry_dropout'] / BIG_STEPS:g} (bits "
              f"{launches['threefry_bits'] / BIG_STEPS:g})", flush=True)
    if emit:
        m_ok = all(t.dtype == torch.bfloat16
                   for t in tree_leaves(state[1].m))
        cast = step.amp.cast_model(state[0])
        c_ok = all(c.dtype == w.dtype and torch.equal(c, w) for c, w in
                   zip(tree_leaves(state[3]), tree_leaves(cast)))
        check(m_ok and c_ok, "m leaves bf16; emitted compute tree "
              "array-equal to cast_model(master)")
    med = statistics.median(times[1:])
    print(f"smoke reading, not a benchmark: median step "
          f"{med * 1e3:.1f} ms over steps 2-{BIG_STEPS} "
          f"({BIG_BATCH / med:.1f} samples/s); first step "
          f"{times[0] * 1e3:.1f} ms; peak device memory {peak:.2f} GiB",
          flush=True)
    res = dict(losses=losses, step_ms=[t * 1e3 for t in times],
               median_step_ms=med * 1e3, samples_per_s=BIG_BATCH / med,
               launches=launches, peak_gib=peak)
    if products is not None:
        res["products"] = products
    del state, step
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# 5. the SGD-family optimizers on BERT-Large's parameter set
# ---------------------------------------------------------------------------

OPT_STEPS = 3
# name -> (constructor arguments, kernel launches per flat step); the
# cases of the JAX package's own tests (weight decay 0.01; SGD with the
# imagenet example's momentum and weight decay)
OPT_CASES = {
    "FusedSGD": (dict(lr=0.1, momentum=0.9, weight_decay=1e-4),
                 {"flat_sgd": 1}),
    "FusedAdagrad": (dict(lr=1e-2, weight_decay=0.01), {"flat_adagrad": 1}),
    "FusedNovoGrad": (dict(lr=1e-3, weight_decay=0.01),
                      {"flat_novograd": 1, "flat_l2norm_partials": 1}),
}


def _novograd_model(model, leaves_p, leaves_g, m_tree, v_tree, t, kw):
    """Advance NovoGrad's flat-vs-tree error model by step ``t`` (per
    element, float64, from the tree path's values): the per-tensor
    ||g||^2 is a sum in another order on each path (partials and span
    sums against ``torch.sum``), within r = 2 (n + 1) u of it (n the
    tensor's padded elements); v's difference D follows v's EMA; the
    denominator's relative difference is D / (2 v) + 8 u; m's difference
    M = b1 M + beta3 |g| / denom (that, + 4 u) + 4 u of m's terms; p's P
    = P + lr (M / c1 + 4 u (|m| / c1 + wd |p|)) + 2 u |p|. Returns the
    per-leaf (P, M, D) lists."""
    b1, b2 = NOVO_BETAS
    lr, wd = kw["lr"], kw["weight_decay"]
    beta3 = 1.0 - b1
    c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    u32 = U32
    out = []
    for i, (p, g, m, v) in enumerate(zip(leaves_p, leaves_g, m_tree,
                                         v_tree)):
        P, M, D = model[i] if model else (0.0, 0.0, 0.0)
        g, p, m = g.double(), p.double(), m.double()
        n = (-(-max(g.numel(), 1) // 1024)) * 1024
        gsq = float((g * g).sum())
        r = 2.0 * (n + 1) * u32
        D = r * gsq if t == 1 else b2 * D + (1.0 - b2) * r * gsq
        vv = float(v)
        den = (vv / c2) ** 0.5 + NOVO_EPS
        e = D / (2.0 * max(vv, 1e-300)) + 8 * u32
        gn = g.abs() / den
        M = b1 * M + beta3 * gn * (e + 4 * u32) + 4 * u32 * (
            b1 * m.abs() + beta3 * gn)
        P = P + lr * (M / c1 + 4 * u32 * (m.abs() / c1 + wd * p.abs())) \
            + 2 * u32 * p.abs()
        out.append((P, M, D + 4 * u32 * vv))
    return out


def opt_steps(dev, kern):
    """Three flat steps of FusedSGD, FusedAdagrad and FusedNovoGrad on
    the full BERT-Large fp32 tree, with seeded synthetic gradients, each
    against the same optimizer's tree path on the card: SGD and Adagrad
    bit for bit (their kernels take the tree path's fp32 operations: g * 1
    and (1 - 0) * wd are exact, and the skipped terms add 0), NovoGrad to
    its error model (``_novograd_model``); exact launches a step."""
    from apex_tpu_torch import optimizers
    from apex_tpu_torch.models.bert import bert_large, init_bert
    from apex_tpu_torch.multi_tensor_apply.flatten import (
        make_spec, unflatten_tensors,
    )
    from apex_tpu_torch.utils.tree import tree_flatten, tree_map

    params = init_bert(bert_large(), torch.Generator(device=dev).manual_seed(
        0), device=dev)
    spec = make_spec(tree_flatten(params)[0])
    out = {}
    for name, (kw, per_step) in OPT_CASES.items():
        phase(f"optimizer steps: {name}({kw}) on BERT-Large's parameter set "
              f"({spec.num_tensors} tensors), {OPT_STEPS} flat steps "
              "(use_flat_kernel=True) against the tree path on the card "
              "(tolerance: SGD and Adagrad bit for bit; NovoGrad per element "
              "to its flat-vs-tree error model)")
        cls = getattr(optimizers, name)
        flat, tree = cls(use_flat_kernel=True, **kw), cls(**kw)
        pf, sf = params, flat.init(params)
        pt, st = params, tree.init(params)
        want = {n: per_step.get(n, 0) for n in kern}
        for k in kern.values():
            k.launches = 0
        gen = torch.Generator(device=dev).manual_seed(100)
        model, times_f, shares = None, [], []
        for t in range(1, OPT_STEPS + 1):
            grads = tree_map(lambda x: torch.randn(
                x.shape, generator=gen, device=dev) * 1e-3, params)
            before = {n: k.launches for n, k in kern.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prev_t = pt
            pf, sf = flat.step(grads, pf, sf)
            torch.cuda.synchronize()
            times_f.append(time.perf_counter() - t0)
            step_l = {n: kern[n].launches - before[n] for n in kern}
            pt, st = tree.step(grads, pt, st)
            torch.cuda.synchronize()
            got = {n: c for n, c in step_l.items() if c}
            check(step_l == want and int(sf.step) == int(st.step) == t,
                  f"{name} step {t}: launches {got} (exactly {per_step}); "
                  f"step counts {int(sf.step)}")
            lf, lt = tree_flatten(pf)[0], tree_flatten(pt)[0]
            if name == "FusedNovoGrad":
                mf = unflatten_tensors(sf.m, spec, cast_back=False)
                mt, vt = tree_flatten(st.m)[0], tree_flatten(st.v)[0]
                model = _novograd_model(model, tree_flatten(prev_t)[0],
                                        tree_flatten(grads)[0], mt, vt, t,
                                        kw)
                share = max(max(_share(a, b, P), _share(c, d, M))
                            for a, b, c, d, (P, M, _) in zip(
                                lf, lt, mf, mt, model))
                vs = max(abs(float(sf.v[i]) - float(v)) / D
                         for i, (v, (_, _, D)) in enumerate(zip(vt, model)))
                share = max(share, vs)
                shares.append(share)
                check(share <= 1.0, f"{name} step {t}: flat p, m and v "
                      f"against the tree path, {share:.4f} of the model")
            else:
                state_f = sf[1]
                leaves_s = unflatten_tensors(state_f, spec, cast_back=False)
                same = all(torch.equal(a, b) for a, b in zip(lf, lt)) and \
                    all(torch.equal(a, b) for a, b in zip(
                        leaves_s, tree_flatten(st[1])[0]))
                err = max(float((a - b).abs().max()) for a, b in zip(lf, lt))
                shares.append(err)
                check(same, f"{name} step {t}: flat params and "
                      f"{sf._fields[1]} bit-equal to the tree path's "
                      f"(max_abs_err {err:.3g})")
            del grads, prev_t
        moved = max(float((a - b).abs().max()) for a, b in zip(
            tree_flatten(pf)[0], tree_flatten(params)[0]))
        check(moved > 0, f"{name}: the params moved (max |dp| {moved:.3g})")
        out[name] = dict(launches={n: k.launches for n, k in kern.items()
                                   if k.launches},
                         flat_step_ms=[x * 1e3 for x in times_f],
                         worst=max(shares))
        print(f"{name}: flat step {statistics.median(times_f) * 1e3:.1f} ms "
              f"(host clock, synchronised; median of {OPT_STEPS})", flush=True)
        del pf, sf, pt, st, flat, tree
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 6. ResNet-50 training (examples/imagenet/main_amp.py)
# ---------------------------------------------------------------------------

RESNET_DEPTH, RESNET_CLASSES = 50, 1000
RESNET_SMALL = (4, 64)     # batch, image size of the card-vs-CPU step
RESNET_BIG = (64, 224)     # the JAX example's defaults
RESNET_STEPS = 6
# The six steps run at lr 0.025, the JAX example's 0.1 scaled to batch 64
# by the reference apex example's rule (lr * batch / 256). At 0.1 on one
# fixed batch this phase's losses diverge from the third step (on an
# H100: 7.46, 5.52, 7.66, 11.18, 14.28, 14.98), so "the last below the
# first" would test the learning rate, not the step.
RESNET_BIG_LR = 0.025
# Card vs CPU. This random-init ResNet-50 amplifies rounding into its
# gradients so much that no fp32 result, card or CPU, is within BERT's
# 1e-4 of another: the float64 step below puts the CPU's own fp32
# gradients about three quarters of a percent from it (relative norm;
# this phase prints each device's distance). Each device's loss,
# gradients and new statistics are held instead to that float64 step:
# the card's distance from it at most RESNET_FACTOR[level] times the
# CPU's, plus 64 u (a floor for a CPU that lands close by chance). fp32:
# 4, because cuDNN may pick convolution algorithms (Winograd, FFT) that
# round more than a direct sum, while a wrong path (a padding shift, a
# missing term) lands at O(1). O2: bf16 rounding of every activation puts
# a large share of the gradient's norm in noise on either device (on
# ResNet-10, about a fifth for JAX and the port alike:
# tests/test_torch_resnet_train.py prints both), the same on both, so
# 1.5. Master and momentum buffer are held per element to the SGD model
# (``sgd_master_limit``). The card-vs-CPU differences are printed beside.
RESNET_FACTOR = {"O0": 4.0, "O2": 1.5}


def _sgd_first_step(p, g, lr, wd):
    """FusedSGD's first step with momentum, in float64: the buffer is
    seeded with d = g + wd p, and p - lr d."""
    d = g.double() + wd * p.double()
    return p.double() - lr * d, d


def sgd_master_limit(p, g_d, g_c, lr, wd):
    """(limit on |master_card - master_cpu|, on |buf_card - buf_cpu|)
    after FusedSGD's first momentum step from master ``p``: each side's
    step recomputed in float64 from its own gradient, the two results'
    difference plus each side's fp32 roundings (d = g + wd p: 2 u of its
    terms; p - lr d: u of lr |d| and u of |p_new|)."""
    pd, dd = _sgd_first_step(p, g_d, lr, wd)
    pc, dc = _sgd_first_step(p, g_c, lr, wd)
    terms = g_d.double().abs() + g_c.double().abs() + 2 * wd * p.double(
    ).abs()
    buf = (dd - dc).abs() + 2 * U32 * terms
    master = (pd - pc).abs() + lr * (3 * U32 * terms + buf) \
        + 2 * U32 * (pd.abs() + pc.abs())
    return master, buf


def _rel_global(got, want):
    """||got - want|| / ||want|| over all leaves together (float64, CPU)."""
    from apex_tpu_torch.utils.tree import tree_flatten

    num = den = 0.0
    for a, b in zip(tree_flatten(got)[0], tree_flatten(want)[0]):
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        num += float(((a - b) ** 2).sum())
        den += float((b ** 2).sum())
    return (num / den) ** 0.5


def resnet_small(dev):
    """One step of each configuration, ResNet-50 at full width and depth,
    batch 4, 64 x 64, on the card (kernels) and on the CPU (plain
    versions) from the same weights and batch. The gradient half runs
    once per opt level on each device (the two O0 configurations share
    it); each configuration then takes its own optimizer step."""
    from apex_tpu_torch.examples.imagenet.main_amp import (
        CONFIGS, LR, MOMENTUM, WEIGHT_DECAY, make_resnet_train_step,
        synthetic_batch,
    )
    from apex_tpu_torch.models.resnet import init_resnet
    from apex_tpu_torch.optimizers import FusedSGD
    from apex_tpu_torch.utils.tree import tree_flatten, tree_map

    batch, size = RESNET_SMALL
    phase(f"ResNet training, card vs CPU: ResNet-{RESNET_DEPTH}, "
          f"{RESNET_CLASSES} classes, batch {batch}, {size} x {size}: one "
          "step of each configuration on the card (kernels) against the "
          "same step on the CPU (plain versions)")
    params, stats = init_resnet(torch.Generator(device=dev).manual_seed(0),
                                RESNET_DEPTH, RESNET_CLASSES, device=dev)
    cpu = lambda tree: tree_map(lambda t: t.cpu(), tree)  # noqa: E731
    params_c, stats_c = cpu(params), cpu(stats)
    images, labels = synthetic_batch(0, batch, size, RESNET_CLASSES, dev)
    images_c, labels_c = images.cpu(), labels.cpu()
    t0 = time.perf_counter()
    ref = make_resnet_train_step(RESNET_DEPTH, "O0")
    f64 = lambda tree: tree_map(lambda t: t.double(), tree)  # noqa: E731
    (loss64, ns64), g64, _, _ = ref.amp.value_and_grad(
        ref.loss_fn, has_aux=True)(f64(params_c), ref.amp.init_state("cpu"),
                                   f64(stats_c), images_c.double(), labels_c)
    print(f"float64 reference step on the CPU in "
          f"{time.perf_counter() - t0:.2f} s; loss {float(loss64):.9f}",
          flush=True)
    out, halves = {}, {}
    for name, (level, flat) in CONFIGS.items():
        mk = lambda: FusedSGD(lr=LR, momentum=MOMENTUM,  # noqa: E731
                              weight_decay=WEIGHT_DECAY,
                              use_flat_kernel=flat)
        step_d = make_resnet_train_step(RESNET_DEPTH, level, optimizer=mk())
        step_c = make_resnet_train_step(RESNET_DEPTH, level, optimizer=mk())
        st_d = step_d.init_state(params, stats, dev)
        st_c = step_c.init_state(params_c, stats_c, "cpu")
        if level not in halves:
            t0 = time.perf_counter()
            hd = step_d.grads(st_d[0], st_d[1], st_d[3], images, labels)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            hc = step_c.grads(st_c[0], st_c[1], st_c[3], images_c, labels_c)
            t2 = time.perf_counter()
            halves[level] = (hd, hc)
            print(f"{level} gradient half: card {t1 - t0:.2f} s, CPU "
                  f"{t2 - t1:.2f} s; loss card {float(hd[0]):.6f}, CPU "
                  f"{float(hc[0]):.6f}", flush=True)
        (loss_d, ns_d, g_d, f_d, sc_d), (loss_c, ns_c, g_c, f_c, sc_c) = \
            halves[level]
        check(not bool(f_d) and not bool(f_c), f"{name}: found_inf False "
              "on both")
        m_d, o_d = step_d.opt.step(g_d, st_d[0], st_d[2], found_inf=f_d)
        m_c, o_c = step_c.opt.step(g_c, st_c[0], st_c[2], found_inf=f_c)
        torch.cuda.synchronize()
        res = {}
        for key, card, cpu, want in (
                ("loss", {"l": loss_d}, {"l": loss_c}, {"l": loss64}),
                ("grads", g_d, g_c, g64), ("stats", ns_d, ns_c, ns64)):
            if level == "O2" and key == "stats":
                continue   # bf16 activations: the statistics of another input
            d_card, d_cpu = _rel_global(card, want), _rel_global(cpu, want)
            res[key] = dict(card_vs_f64=d_card, cpu_vs_f64=d_cpu,
                            card_vs_cpu=_rel_global(card, cpu))
            check(d_card <= RESNET_FACTOR[level] * d_cpu + 64 * U32,
                  f"{name} {level} {key}: card {d_card:.3g} from the float64 "
                  f"step (relative norm), CPU {d_cpu:.3g}; card vs CPU "
                  f"{res[key]['card_vs_cpu']:.3g} (for information)")
        if level == "O0":
            from apex_tpu_torch.multi_tensor_apply.flatten import (
                make_spec, unflatten_tensors,
            )
            spec = make_spec(tree_flatten(params_c)[0])
            bufs_d = tree_flatten(o_d.momentum_buf)[0] if not flat else \
                unflatten_tensors(o_d.momentum_buf.cpu(), spec, False)
            bufs_c = tree_flatten(o_c.momentum_buf)[0] if not flat else \
                unflatten_tensors(o_c.momentum_buf, spec, False)
            share_m = share_b = 0.0
            for p, gd, gc, md, mc, bd, bc in zip(
                    tree_flatten(params_c)[0], tree_flatten(g_d)[0],
                    tree_flatten(g_c)[0], tree_flatten(m_d)[0],
                    tree_flatten(m_c)[0], bufs_d, bufs_c):
                lim_m, lim_b = sgd_master_limit(p, gd.cpu(), gc, LR,
                                                WEIGHT_DECAY)
                share_m = max(share_m, _share(md, mc, lim_m))
                share_b = max(share_b, _share(bd, bc, lim_b))
            res.update(master_share=share_m, buf_share=share_b)
            check(share_m <= 1.0 and share_b <= 1.0, f"{name} O0 master "
                  f"and momentum buffer per element: {share_m:.4f} and "
                  f"{share_b:.4f} of sgd_master_limit")
        else:
            finite = all(bool(torch.isfinite(t).all()) and t.dtype ==
                         torch.float32 for t in tree_flatten(m_d)[0])
            check(finite, f"{name}: fp32 master finite after the step")
        out[name] = res
        del step_d, step_c, st_d, st_c, m_d, m_c, o_d, o_c
    del halves, params, stats, g64, ns64
    torch.cuda.empty_cache()
    return out


def resnet_big(dev, kern):
    """Six steps of each configuration at the JAX example's size on one
    fixed synthetic batch through the example's step, counts set to 0
    before each run and read after it."""
    from apex_tpu_torch.examples.imagenet.main_amp import (
        CONFIGS, MOMENTUM, WEIGHT_DECAY, make_resnet_train_step,
        synthetic_batch,
    )
    from apex_tpu_torch.models.resnet import init_resnet
    from apex_tpu_torch.optimizers import FusedSGD

    batch, size = RESNET_BIG
    images, labels = synthetic_batch(0, batch, size, RESNET_CLASSES, dev)
    out = {}
    for name, (level, flat) in CONFIGS.items():
        phase(f"ResNet training ({name}): ResNet-{RESNET_DEPTH}, "
              f"{RESNET_CLASSES} classes, amp {level}, FusedSGD(lr="
              f"{RESNET_BIG_LR}, momentum={MOMENTUM}, weight_decay="
              f"{WEIGHT_DECAY}, use_flat_kernel={flat}), batch {batch}, "
              f"{size} x {size}, {RESNET_STEPS} steps on one fixed batch")
        step = make_resnet_train_step(RESNET_DEPTH, level, optimizer=FusedSGD(
            lr=RESNET_BIG_LR, momentum=MOMENTUM, weight_decay=WEIGHT_DECAY,
            use_flat_kernel=flat))
        params, stats = init_resnet(
            torch.Generator(device=dev).manual_seed(0), RESNET_DEPTH,
            RESNET_CLASSES, device=dev)
        state = list(step.init_state(params, stats, dev))
        del params, stats
        per_step = {n: 0 for n in kern}
        if flat:
            per_step["flat_sgd"] = 1
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kern.values():
            k.launches = 0
        losses, times, steps_ok = [], [], True
        for _ in range(RESNET_STEPS):
            before = {n: k.launches for n, k in kern.items()}
            t0 = time.perf_counter()
            *state, loss = step(*state, images, labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(loss)
            steps_ok &= all(kern[n].launches - before[n] == per_step[n]
                            for n in kern)
        launches = {n: k.launches for n, k in kern.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = [float(l) for l in losses]
        sc = state[3]
        print(f"losses {[round(l, 5) for l in losses]}", flush=True)
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              "every loss finite, the last below the first")
        print(f"overflows (found_inf True): {int(sc.overflows)}; loss scale "
              f"{float(sc.loss_scale):g}", flush=True)
        check(steps_ok and all(launches[n] == RESNET_STEPS * per_step[n]
                               for n in kern),
              f"launches per step exactly "
              f"{({n: c for n, c in per_step.items() if c})} (every other "
              f"kernel 0; {({n: c for n, c in launches.items() if c})} over "
              f"{RESNET_STEPS} steps)")
        med = statistics.median(times[1:])
        print(f"smoke reading, not a benchmark: median step "
              f"{med * 1e3:.1f} ms over steps 2-{RESNET_STEPS} "
              f"({batch / med:.1f} img/s); first step "
              f"{times[0] * 1e3:.1f} ms; peak device memory {peak:.2f} GiB",
              flush=True)
        out[name] = dict(losses=losses, step_ms=[t * 1e3 for t in times],
                         median_step_ms=med * 1e3, img_per_s=batch / med,
                         overflows=int(sc.overflows), launches=launches,
                         peak_gib=peak)
        del state, step
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 15. amp O1, LARC, FP16_Optimizer and the optimizers' step arguments
# ---------------------------------------------------------------------------

PRODUCT_OPS = ("mm", "bmm", "addmm", "baddbmm", "convolution")
O1_CONFIGS = ("flash_tree", "softmax_flat")
STEP_ARG_GS = 2.0 ** -16     # grad_scale= of the step-argument runs


def _product_counter():
    """A ``TorchDispatchMode`` recording the operand dtypes of every aten
    product (``PRODUCT_OPS``) dispatched inside it, in ``.seen``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class ProductDtypes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in PRODUCT_OPS:
                self.seen.append((name, tuple(
                    a.dtype for a in args if isinstance(a, torch.Tensor))))
            return func(*args, **(kwargs or {}))

    return ProductDtypes()


def o1_product_dtypes(step, master, ids, mask):
    """O1's dtype contract on the step's forward (``step.loss_fn``, no
    autograd): inside ``step.amp.autocast()`` every aten product runs in
    bf16; the same forward outside it runs none in bf16. Returns the
    counts by op and dtype."""
    bf = torch.bfloat16
    with torch.no_grad():
        with step.amp.autocast(), _product_counter() as hot:
            step.loss_fn(master, ids, mask)
        with _product_counter() as cold:
            step.loss_fn(master, ids, mask)
    torch.cuda.synchronize()

    def by_op(seen):
        out = {}
        for op, dts in seen:
            key = f"{op} {'/'.join(str(d)[6:] for d in dts)}"
            out[key] = out.get(key, 0) + 1
        return out

    hot_bf = sum(all(d == bf for d in dts) for _, dts in hot.seen)
    cold_bf = sum(any(d == bf for d in dts) for _, dts in cold.seen)
    check(hot.seen and hot_bf == len(hot.seen),
          f"inside autocast(): {hot_bf} of {len(hot.seen)} forward products "
          f"bf16 ({by_op(hot.seen)})")
    check(len(cold.seen) == len(hot.seen) and cold_bf == 0,
          f"outside autocast(): {cold_bf} of {len(cold.seen)} products bf16 "
          f"({by_op(cold.seen)})")
    return {"in_autocast": by_op(hot.seen), "outside": by_op(cold.seen)}


def train_small_o1(dev):
    """One O1 step of the 2-layer full-width model on the card and on the
    CPU from the same weights, in the two O1 configurations, held to
    O2's limits (bf16 products in both; the residual stream and the
    LayerNorms fp32)."""
    out = {}
    for name in O1_CONFIGS:
        _, opt, flat = STEP_CONFIGS[name]
        cfg = _step_cfg(name, num_layers=SMALL_LAYERS)
        out[_key(name, "O1")] = _train_small_one(
            dev, cfg, opt, flat, "O1", STEP_LIMITS["O2"], name)
    return out


def train_o1(dev, kern):
    """Six O1 steps of full BERT-Large at the headline's shape in the two
    O1 configurations (``training_o1``)."""
    return {_key(name, "O1"): _train_big_one(
        dev, kern, name, "fp32", torch.float32, False, level="O1")
        for name in O1_CONFIGS}


class plain_flat:
    """Within it the flat optimizer wrappers of ``multi_tensor_apply``
    take their plain versions on the card's tensors (``on_card`` answers
    False), but ``flat_l2norm_partials`` keeps its kernel with
    ``keep_partials`` (so a plain run's sums are the kernel run's). The
    launches made inside are put back: they compare, they are not the
    path's."""

    def __init__(self, kern, keep_partials=False):
        self.mta = kernel_modules()[4]
        self.kern = kern
        self.keep = keep_partials

    def __enter__(self):
        self.saved = self.mta.on_card
        self.counts = {n: k.launches for n, k in self.kern.items()}
        keep = self.keep
        self.mta.on_card = lambda t, what="": keep and what == "buf"
        return self

    def __exit__(self, *exc):
        self.mta.on_card = self.saved
        for n, k in self.kern.items():
            k.launches = self.counts[n]


def _clone(tree):
    from apex_tpu_torch.utils.tree import tree_map

    return tree_map(lambda t: t.clone(), tree)


def _same_leaves(a, b):
    from apex_tpu_torch.utils.tree import tree_leaves

    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def resnet_larc(dev, kern):
    """``resnet_larc``: six steps of ResNet-50 at the example's size with
    ``LARC(FusedSGD(use_flat_kernel=True))`` through the example's step
    (``grads`` then the optimizer's step), each step's update held bit
    for bit against the same LARC over the plain flat SGD on the same
    gradients and state on the card."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.examples.imagenet.main_amp import (
        MOMENTUM, WEIGHT_DECAY, make_resnet_train_step, synthetic_batch,
    )
    from apex_tpu_torch.models.resnet import init_resnet
    from apex_tpu_torch.optimizers import FusedSGD
    from apex_tpu_torch.parallel import LARC

    batch, size = RESNET_BIG
    phase(f"resnet_larc: ResNet-{RESNET_DEPTH}, {RESNET_CLASSES} classes, "
          f"amp O0, LARC(FusedSGD(lr={RESNET_BIG_LR}, momentum={MOMENTUM}, "
          f"weight_decay={WEIGHT_DECAY}, use_flat_kernel=True)) (trust "
          f"coefficient 0.02, clip), batch {batch}, {size} x {size}, "
          f"{RESNET_STEPS} steps on one fixed batch; each update bit for "
          "bit against LARC over the plain flat SGD on the same gradients")
    larc = LARC(FusedSGD(lr=RESNET_BIG_LR, momentum=MOMENTUM,
                         weight_decay=WEIGHT_DECAY, use_flat_kernel=True))
    step = make_resnet_train_step(RESNET_DEPTH, "O0", optimizer=larc)
    images, labels = synthetic_batch(0, batch, size, RESNET_CLASSES, dev)
    params, stats = init_resnet(torch.Generator(device=dev).manual_seed(0),
                                RESNET_DEPTH, RESNET_CLASSES, device=dev)
    master, stats, opt_state, sc = step.init_state(params, stats, dev)
    del params
    for k in kern.values():
        k.launches = 0
    losses, times, steps_ok, same = [], [], True, True
    for _ in range(RESNET_STEPS):
        t0 = time.perf_counter()
        loss, new_stats, grads, found, sc = step.grads(master, stats, sc,
                                                       images, labels)
        saved = _clone(opt_state)      # flat_sgd steps its buffer in place
        before = {n: k.launches for n, k in kern.items()}
        new_master, new_opt = larc.step(grads, master, opt_state,
                                        found_inf=found)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        steps_ok &= all(kern[n].launches - before[n]
                        == (1 if n == "flat_sgd" else 0) for n in kern)
        with plain_flat(kern):
            want_master, want_opt = larc.step(grads, master, saved,
                                              found_inf=found)
        same &= _same_leaves(new_master, want_master) and _same_leaves(
            new_opt, want_opt)
        stats = amp.apply_if_finite(new_stats, stats, found)
        master, opt_state = new_master, new_opt
        losses.append(float(loss))
        del grads, saved, want_master, want_opt
    launches = {n: k.launches for n, k in kern.items()}
    print(f"losses {[round(l, 5) for l in losses]}", flush=True)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "every loss finite, the last below the first")
    check(int(sc.overflows) == 0,
          f"no overflow (O0's static scale 1): overflows {int(sc.overflows)}")
    check(same, "every step's params and momentum buffer bit for bit "
          "against LARC over the plain flat SGD on the same inputs")
    check(steps_ok and launches["flat_sgd"] == RESNET_STEPS,
          f"launches: flat_sgd exactly one a step, every other kernel 0 "
          f"({({n: c for n, c in launches.items() if c})})")
    med = statistics.median(times[1:])
    print(f"smoke reading, not a benchmark: median step {med * 1e3:.1f} ms "
          f"over steps 2-{RESNET_STEPS} ({batch / med:.1f} img/s)",
          flush=True)
    out = dict(losses=losses, step_ms=[t * 1e3 for t in times],
               median_step_ms=med * 1e3, launches=launches)
    del master, opt_state, stats, step
    torch.cuda.empty_cache()
    return out


FP16_HEADROOM = 2.0 ** 3   # the first scale leaves the gradients this
FP16_MAX = 65504.0         # far below fp16's largest finite value


def fp16_optimizer_run(dev, kern):
    """``fp16_optimizer``: ResNet-50 ``network_to_half`` (fp16 params but
    the BatchNorm leaves) with ``FP16_Optimizer(FusedSGD(
    use_flat_kernel=True), dynamic_loss_scale=True)``. The first scale is
    the largest power of two that keeps the unscaled fp16 gradients'
    largest magnitude ``FP16_HEADROOM`` times under fp16's range (from a
    scale of 2^24 down, the gradients overflow at every halving through
    2^19 on an H100: six skipped steps in a row); the first step's
    gradients carry an inf, the forced overflow: it is skipped (params
    and masters bit for bit) and the scale halves; the others go
    through, any natural overflow held to the same rule."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.examples.imagenet.main_amp import (
        MOMENTUM, WEIGHT_DECAY, synthetic_batch,
    )
    from apex_tpu_torch.fp16_utils import FP16_Optimizer, network_to_half
    from apex_tpu_torch.models.resnet import (
        apply_resnet, cross_entropy_loss, init_resnet,
    )
    from apex_tpu_torch.optimizers import FusedSGD
    from apex_tpu_torch.utils.tree import tree_leaves, tree_map

    batch, size = RESNET_BIG
    phase(f"fp16_optimizer: ResNet-{RESNET_DEPTH} network_to_half (fp16 "
          f"convolutions, fp32 BatchNorm leaves), FP16_Optimizer(FusedSGD("
          f"lr={RESNET_BIG_LR}, momentum={MOMENTUM}, weight_decay="
          f"{WEIGHT_DECAY}, use_flat_kernel=True), dynamic_loss_scale=True), "
          f"the first scale {FP16_HEADROOM:g}x under fp16's range for the "
          f"largest gradient, an inf in step 1's gradients, batch {batch}, "
          f"{size} x {size}, {RESNET_STEPS} steps on one fixed batch")
    params, stats = init_resnet(torch.Generator(device=dev).manual_seed(0),
                                RESNET_DEPTH, RESNET_CLASSES, device=dev)
    model = network_to_half(params)
    del params
    images, labels = synthetic_batch(0, batch, size, RESNET_CLASSES, dev)
    images = images.half()

    def scaled_grads(scale_loss):
        p = tree_map(lambda t: t.detach().requires_grad_(True), model)
        with torch.enable_grad():
            logits, new_stats = apply_resnet(p, stats, images, RESNET_DEPTH,
                                             train=True)
            loss = cross_entropy_loss(logits, labels)
            gs = torch.autograd.grad(scale_loss(loss), tree_leaves(p))
        return loss.detach(), new_stats, _tree_like(p, gs)

    gmax = max(float(g.float().abs().max()) for g in tree_leaves(
        scaled_grads(lambda l: l)[2]))
    first = 2.0 ** math.floor(math.log2(FP16_MAX / (FP16_HEADROOM * gmax)))
    print(f"largest unscaled fp16 gradient {gmax:.4g}: first scale "
          f"{first:g}", flush=True)
    opt = FP16_Optimizer(
        FusedSGD(lr=RESNET_BIG_LR, momentum=MOMENTUM,
                 weight_decay=WEIGHT_DECAY, use_flat_kernel=True),
        dynamic_loss_scale=True, dynamic_loss_args={"init_scale": first})
    st = opt.init(model)
    for k in kern.values():
        k.launches = 0
    losses, scales, skipped, skips_ok, moved = [], [], 0, True, False
    for i in range(RESNET_STEPS):
        loss, new_stats, grads = scaled_grads(
            lambda l: opt.scale_loss(l, st))
        if i == 0:   # the forced overflow
            leaf = tree_leaves(grads)[0]
            leaf[(0,) * leaf.dim()] = float("inf")
        scale = float(opt.loss_scale(st))
        new_model, new_st = opt.step(grads, model, st)
        found = new_st.scaler.overflows > st.scaler.overflows
        if bool(found):
            skipped += 1
            skips_ok &= _same_leaves(new_model, model) and _same_leaves(
                new_st.master, st.master) and \
                float(opt.loss_scale(new_st)) == scale / 2
        else:
            moved |= not _same_leaves(new_st.master, st.master)
        stats = amp.apply_if_finite(new_stats, stats, found)
        model, st = new_model, new_st
        losses.append(float(loss))
        scales.append(scale)
        del grads
    launches = {n: k.launches for n, k in kern.items()}
    print(f"losses {[round(l, 5) for l in losses]}; loss scale before "
          f"each step {scales}; skipped {skipped}", flush=True)
    check(all(np.isfinite(losses)), "every loss finite")
    check(all(t.dtype == torch.float16 for t in tree_leaves(model)
              if t.is_floating_point() and t.dim() > 1),
          "the conv and dense kernels stay fp16")
    check(skipped >= 1 and scales[1] == scales[0] / 2 and skips_ok,
          f"{skipped} overflowing step(s) skipped, the forced first among "
          "them: model params and masters bit for bit, the scale halved "
          "each time")
    check(skipped < RESNET_STEPS and moved,
          f"{RESNET_STEPS - skipped} step(s) went through and moved the "
          "masters")
    check(launches["flat_sgd"] == RESNET_STEPS and sum(
        launches.values()) == RESNET_STEPS,
          f"launches: flat_sgd exactly one a step, skipped or not "
          f"({({n: c for n, c in launches.items() if c})})")
    out = dict(losses=losses, loss_scales=scales, skipped=skipped,
               largest_grad=gmax, launches=launches)
    del model, st, stats
    torch.cuda.empty_cache()
    return out


def _tree_like(tree, leaves):
    """``leaves`` (in ``tree_leaves`` order) in ``tree``'s structure."""
    from apex_tpu_torch.utils.tree import tree_map

    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


# name -> (constructor arguments, kernel launches of one flat step)
ARG_CASES = {
    "FusedAdam": (dict(lr=LR, weight_decay=0.01), {"flat_adam": 1}),
    "FusedLAMB": (dict(lr=LAMB_LR, weight_decay=LAMB_WD),
                  {"flat_l2norm_partials": 1, "flat_lamb_stage1": 1}),
    **OPT_CASES,
}


def opt_step_args(dev, kern):
    """Each of the five optimizers' flat step on BERT-Large's tree with
    ``lr=`` (twice its constructor's), ``weight_decay=0.02`` and
    ``grad_scale=2**-16`` (gradients 2^16 times too large) overriding its
    defaults, from a fresh state, against the same call through the
    plain versions on the card (``plain_flat``, the grad-norm partials on
    their kernel on both sides): bit for bit (LAMB's m and v; its params
    through the trust ratio's sums to ``lamb_master_limit``); exact
    launches. Then ``FusedLAMB.step(grad_norm=...)``: stage 1 alone, no
    ``flat_l2norm_partials`` launch."""
    from apex_tpu_torch import optimizers
    from apex_tpu_torch.models.bert import bert_large, init_bert
    from apex_tpu_torch.utils.tree import tree_leaves, tree_map

    params = init_bert(bert_large(), torch.Generator(device=dev).manual_seed(
        0), device=dev)
    gen = torch.Generator(device=dev).manual_seed(200)
    grads = tree_map(lambda x: torch.randn(
        x.shape, generator=gen, device=dev) * (1e-3 / STEP_ARG_GS), params)
    norm = torch.sqrt(sum(((g * STEP_ARG_GS) ** 2).sum()
                          for g in tree_leaves(grads)))
    out = {}
    cases = [(n, n, False) for n in ARG_CASES] + \
        [("FusedLAMB grad_norm", "FusedLAMB", True)]
    for label, name, with_norm in cases:
        kw, per_step = ARG_CASES[name]
        args = dict(lr=2 * kw["lr"], weight_decay=0.02,
                    grad_scale=STEP_ARG_GS)
        if with_norm:
            args["grad_norm"] = norm
            per_step = {"flat_lamb_stage1": 1}
        phase(f"optimizer step arguments: {name}({kw}, use_flat_kernel="
              f"True) on BERT-Large's parameter set, one step with lr="
              f"{args['lr']:g}, weight_decay=0.02, grad_scale=2**-16"
              + (", grad_norm= the scaled gradients' norm" if with_norm
                 else "") + " (tolerance: bit for bit against the plain "
              "versions on the card; LAMB's params to lamb_master_limit)")
        opt = getattr(optimizers, name)(use_flat_kernel=True, **kw)
        state0 = opt.init(params)
        for k in kern.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_k, s_k = opt.step(grads, params, _clone(state0), **args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {n: k.launches for n, k in kern.items()}
        with plain_flat(kern, keep_partials=True):
            p_p, s_p = opt.step(grads, params, _clone(state0), **args)
        want = {n: per_step.get(n, 0) for n in kern}
        check(launches == want, f"{label}: launches "
              f"{({n: c for n, c in launches.items() if c})} (exactly "
              f"{per_step})")
        err = max(float((a - b).abs().max()) for a, b in zip(
            tree_leaves(p_k), tree_leaves(p_p)))
        if name == "FusedLAMB":
            st_same = torch.equal(s_k.m, s_p.m) and torch.equal(s_k.v, s_p.v)
            lims = lamb_master_limit(params, s_k, s_p, lr=args["lr"],
                                     wd=args["weight_decay"])
            share = max(_share(a, b, l) for a, b, l in zip(
                tree_leaves(p_k), tree_leaves(p_p), tree_leaves(lims)))
            check(st_same and share <= 1.0,
                  f"{label}: m and v bit for bit; params {share:.4f} of "
                  f"lamb_master_limit (max_abs_err {err:.3g})")
        else:
            check(_same_leaves(p_k, p_p) and _same_leaves(s_k, s_p),
                  f"{label}: params and state bit for bit against the "
                  f"plain versions (max_abs_err {err:.3g})")
        moved = max(float((a - b).abs().max()) for a, b in zip(
            tree_leaves(p_k), tree_leaves(params)))
        check(moved > 0, f"{label}: the params moved (max |dp| {moved:.3g})")
        out[label] = dict(launches={n: c for n, c in launches.items() if c},
                          step_ms=ms, max_abs_err=err)
        del p_k, s_k, p_p, s_p, state0, opt
        torch.cuda.empty_cache()
    del params, grads
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 7. times
# ---------------------------------------------------------------------------

def time_ms(fn, reps=15, inner=20):
    """Device ms per call: ``inner`` calls captured in one CUDA graph
    (after a warm-up on a side stream), the graph replayed ``reps``
    times between CUDA events; the median. The card runs the calls back
    to back with no host dispatch between them, inputs L2-warm."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ts = []
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end) / inner)
    return statistics.median(ts)


def bound(nbytes, flops, peak):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def times(dev):
    ln, fa = kernel_modules()[:2]
    phase("times at the serving path's shapes (device ms per call; "
          "medians of CUDA-graph replays timed with CUDA events)")
    gen = torch.Generator(device=dev).manual_seed(3)
    res = {}
    with torch.inference_mode():
        for rows in (1024, 8):
            h = 1024
            x = _rand(gen, (rows, h), torch.bfloat16, dev)
            w = _rand(gen, (h,), torch.bfloat16, dev, 0.5, 1.0)
            b = _rand(gen, (h,), torch.bfloat16, dev, 0.3)
            t_k = time_ms(lambda: ln.layer_norm_fwd_kernel(
                x, w, b, "ln", 1e-5))
            t_p = time_ms(lambda: ln.layer_norm_fwd_plain(
                x, w, b, "ln", 1e-5))
            t_l = time_ms(lambda: F.layer_norm(x, (h,), w, b, 1e-5))
            nbytes = 2 * rows * h * 2 + 2 * h * 2 + 2 * rows * 4
            bd, by = bound(nbytes, 8 * rows * h, FP32_FLOPS)
            res[f"ln_{rows}x{h}"] = dict(ms=t_k, plain_ms=t_p,
                                         library_ms=t_l, bound_ms=bd,
                                         bound_by=by)
            print(f"LN ({rows}, {h}) bf16: kernel {t_k:.5f}, plain "
                  f"{t_p:.5f}, F.layer_norm {t_l:.5f}, bound {bd:.5f} "
                  f"({by})", flush=True)
        b_, h_, s, d = 1, 16, 1024, 64
        q, k, v = (_rand(gen, (b_, h_, s, d), torch.bfloat16, dev)
                   for _ in range(3))
        kw = dict(causal=True, scale=d ** -0.5, rate=0.0)
        t_k = time_ms(lambda: fa.attention_fwd_kernel(
            q, k, v, None, (0, 0), **kw))
        t_p = time_ms(lambda: fa.attention_fwd_plain(
            q, k, v, None, (0, 0), **kw))
        t_l = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=d ** -0.5))
        pairs = s * (s + 1) // 2
        nbytes = 4 * b_ * h_ * s * d * 2 + b_ * h_ * s * 4
        bd, by = bound(nbytes, 4 * d * pairs * b_ * h_, BF16_TC_FLOPS)
        res["flash_b1h16s1024d64"] = dict(ms=t_k, plain_ms=t_p,
                                          library_ms=t_l, bound_ms=bd,
                                          bound_by=by)
        print(f"flash b1 h16 s1024 d64 causal bf16: kernel {t_k:.5f}, "
              f"plain {t_p:.5f}, scaled_dot_product_attention {t_l:.5f}, "
              f"bound {bd:.5f} ({by})", flush=True)
        # what the serving prefill launches: _split_qkv views of the fused
        # projection, with the bucket's key mask
        from apex_tpu_torch.models.gpt import _split_qkv

        qv, kv_, vv = _split_qkv(_rand(gen, (b_, s, 3 * h_ * d),
                                       torch.bfloat16, dev), d)
        mask = torch.ones((b_, s), dtype=torch.int32, device=dev)
        _entry(res, "flash_b1h16s1024d64_gpt_views",
               time_ms(lambda: fa.attention_fwd_kernel(
                   qv, kv_, vv, mask, (0, 0), **kw)),
               time_ms(lambda: fa.attention_fwd_plain(
                   qv, kv_, vv, mask, (0, 0), **kw)),
               time_ms(lambda: F.scaled_dot_product_attention(
                   qv, kv_, vv, is_causal=True, scale=d ** -0.5)),
               nbytes + b_ * s * 4, 4 * d * pairs * b_ * h_, BF16_TC_FLOPS,
               "flash b1 h16 s1024 d64 causal bf16, GPT _split_qkv views "
               f"({_load_variant(qv, kv_, vv)})",
               "scaled_dot_product_attention")
    return res


def _entry(res, key, t_k, t_p, t_l, nbytes, flops, peak, label, lib):
    bd, by = bound(nbytes, flops, peak)
    res[key] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=bd,
                    bound_by=by)
    lib_ms = "" if t_l is None else f" {t_l:.5f}"
    print(f"{label}: kernel {t_k:.5f}, plain {t_p:.5f}, {lib}{lib_ms}, "
          f"bound {bd:.5f} ({by})", flush=True)


def train_times(dev):
    """The training path's kernels at the BERT-Large O2 step's shapes.
    Library calls needing autograd are timed as forward + backward minus
    forward; every call, autograd included, is captured in the graph."""
    ln, fa, xent = kernel_modules()[:3]
    phase("times at the training path's shapes (BERT-Large, batch 64, "
          "seq 128; device ms per call, CUDA-graph replays)")
    gen = torch.Generator(device=dev).manual_seed(7)
    bf, f32 = torch.bfloat16, torch.float32
    res = {}
    rows, h = BIG_BATCH * SEQ, 1024
    x = _rand(gen, (rows, h), bf, dev)
    dy = _rand(gen, (rows, h), bf, dev)
    w = _rand(gen, (h,), f32, dev, 0.5, 1.0)
    b = _rand(gen, (h,), f32, dev, 0.3)
    _, mean, rstd = ln.layer_norm_fwd_plain(x, w, b, "ln", 1e-12)
    w16, b16 = w.to(bf), b.to(bf)
    _entry(res, "ln_fwd_train",
           time_ms(lambda: ln.layer_norm_fwd_kernel(x, w, b, "ln", 1e-12)),
           time_ms(lambda: ln.layer_norm_fwd_plain(x, w, b, "ln", 1e-12)),
           time_ms(lambda: F.layer_norm(x, (h,), w16, b16, 1e-12)),
           2 * rows * h * 2 + 2 * h * 4 + 2 * rows * 4, 8 * rows * h,
           FP32_FLOPS, f"LN fwd ({rows}, {h}) bf16 x, fp32 w, b",
           "F.layer_norm (bf16 w, b)")
    _entry(res, "ln_bwd",
           time_ms(lambda: ln.layer_norm_bwd_kernel(dy, x, w, b, mean, rstd)),
           time_ms(lambda: ln.layer_norm_bwd_plain(dy, x, w, b, mean, rstd)),
           time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
               dy, x, [h], mean, rstd, w16, b16, [True, True, True])),
           3 * rows * h * 2 + h * 4 + 2 * rows * 4 + 2 * h * 4,
           12 * rows * h, FP32_FLOPS,
           f"LN bwd ({rows}, {h}) bf16 x, fp32 w, b",
           "native_layer_norm_backward (bf16 w, b)")
    # the O1 step's residual LayerNorms: fp32 x, fp32 w and b
    x32, dy32 = x.float(), dy.float()
    _, mean32, rstd32 = ln.layer_norm_fwd_plain(x32, w, b, "ln", 1e-12)
    _entry(res, "ln_fwd_train_fp32",
           time_ms(lambda: ln.layer_norm_fwd_kernel(x32, w, b, "ln",
                                                    1e-12)),
           time_ms(lambda: ln.layer_norm_fwd_plain(x32, w, b, "ln", 1e-12)),
           time_ms(lambda: F.layer_norm(x32, (h,), w, b, 1e-12)),
           2 * rows * h * 4 + 2 * h * 4 + 2 * rows * 4, 8 * rows * h,
           FP32_FLOPS, f"LN fwd ({rows}, {h}) fp32 x, fp32 w, b (O1)",
           "F.layer_norm")
    _entry(res, "ln_bwd_fp32",
           time_ms(lambda: ln.layer_norm_bwd_kernel(dy32, x32, w, b, mean32,
                                                    rstd32)),
           time_ms(lambda: ln.layer_norm_bwd_plain(dy32, x32, w, b, mean32,
                                                   rstd32)),
           time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
               dy32, x32, [h], mean32, rstd32, w, b, [True, True, True])),
           3 * rows * h * 4 + h * 4 + 2 * rows * 4 + 2 * h * 4,
           12 * rows * h, FP32_FLOPS,
           f"LN bwd ({rows}, {h}) fp32 x, fp32 w, b (O1)",
           "native_layer_norm_backward")
    # the regime where the JAX package splits columns (h >= 2731)
    r4, h4 = 2048, 4096
    x4, dy4 = _rand(gen, (r4, h4), bf, dev), _rand(gen, (r4, h4), bf, dev)
    w4, b4 = _rand(gen, (h4,), f32, dev, 0.5, 1.0), _rand(gen, (h4,), f32,
                                                          dev, 0.3)
    _, mean4, rstd4 = ln.layer_norm_fwd_plain(x4, w4, b4, "ln", 1e-12)
    _entry(res, "ln_bwd_4096",
           time_ms(lambda: ln.layer_norm_bwd_kernel(dy4, x4, w4, b4, mean4,
                                                    rstd4)),
           time_ms(lambda: ln.layer_norm_bwd_plain(dy4, x4, w4, b4, mean4,
                                                   rstd4)),
           time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
               dy4, x4, [h4], mean4, rstd4, w4.to(bf), b4.to(bf),
               [True, True, True])),
           3 * r4 * h4 * 2 + h4 * 4 + 2 * r4 * 4 + 2 * h4 * 4,
           12 * r4 * h4, FP32_FLOPS,
           f"LN bwd ({r4}, {h4}) bf16 x, fp32 w, b (JAX column split)",
           "native_layer_norm_backward (bf16 w, b)")

    bb, hh, s, d = BIG_BATCH, 16, SEQ, 64
    qkv = _rand(gen, (bb, s, 3, hh, d), bf, dev)
    q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
    do = _rand(gen, (bb, hh, s, d), bf, dev)
    mask = torch.ones((bb, s), dtype=torch.int32, device=dev)  # the step's
    kw = dict(causal=False, scale=d ** -0.5, rate=0.0)
    o, lse = fa.attention_fwd_kernel(q, k, v, mask, (0, 0), **kw)
    delta = (do.float() * o.float()).sum(-1).reshape(-1, s)
    qc, kc, vc = (t.contiguous().requires_grad_(True) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qc, kc, vc, scale=d ** -0.5)

    t_lf = time_ms(lambda: sdpa().detach())
    t_lfb = time_ms(lambda: torch.autograd.grad(sdpa(), (qc, kc, vc), do))
    t_pb = time_ms(lambda: fa.attention_bwd_plain(q, k, v, mask, o, lse, do,
                                                  (0, 0), **kw))
    pairs = bb * hh * s * s             # no causal cut, no masked key
    qkvo = 4 * bb * hh * s * d * 2
    rowstats = 2 * bb * hh * s * 4 + bb * s * 4
    label = f"b{bb} h{hh} s{s} d{d} bf16, BERT views"
    _entry(res, "flash_fwd_train",
           time_ms(lambda: fa.attention_fwd_kernel(q, k, v, mask, (0, 0),
                                                   **kw)),
           time_ms(lambda: fa.attention_fwd_plain(q, k, v, mask, (0, 0),
                                                  **kw)),
           t_lf, qkvo + bb * hh * s * 4 + bb * s * 4, 4 * d * pairs,
           BF16_TC_FLOPS, f"flash fwd {label}",
           "scaled_dot_product_attention")
    _entry(res, "flash_dq",
           time_ms(lambda: fa.attention_dq_kernel(q, k, v, mask, do, lse,
                                                  delta, (0, 0), **kw)),
           t_pb, t_lfb - t_lf, qkvo + rowstats + bb * hh * s * d * 2,
           6 * d * pairs, BF16_TC_FLOPS, f"flash dq {label}",
           "sdpa backward (fwd+bwd - fwd; plain: whole backward)")
    _entry(res, "flash_dkv",
           time_ms(lambda: fa.attention_dkv_kernel(q, k, v, mask, do, lse,
                                                   delta, (0, 0), **kw)),
           t_pb, t_lfb - t_lf, qkvo + rowstats + 2 * bb * hh * s * d * 2,
           8 * d * pairs, BF16_TC_FLOPS, f"flash dk/dv {label}",
           "sdpa backward (fwd+bwd - fwd; plain: whole backward)")

    n, vv = rows, 30522
    logits = _rand(gen, (n, vv), f32, dev, 3.0)
    labels = torch.randint(0, vv, (n,), generator=gen, device=dev)
    dloss = torch.full((n,), 1.0 / n, device=dev)   # the mean's gradient
    _, xlse = xent.xentropy_fwd_plain(logits, labels, 0.0)
    lr = logits.clone().requires_grad_(True)

    def ce():
        return F.cross_entropy(lr, labels, reduction="none", ignore_index=-1)

    t_cf = time_ms(lambda: ce().detach(), inner=5)
    t_cfb = time_ms(lambda: torch.autograd.grad(ce(), lr, dloss), inner=5)
    _entry(res, "xent_fwd",
           time_ms(lambda: xent.xentropy_fwd_kernel(logits, labels, 0.0),
                   inner=5),
           time_ms(lambda: xent.xentropy_fwd_plain(logits, labels, 0.0),
                   inner=5),
           t_cf, n * vv * 4 + n * 8 + 2 * n * 4, 4 * n * vv, FP32_FLOPS,
           f"xentropy fwd ({n}, {vv}) fp32", "F.cross_entropy")
    _entry(res, "xent_bwd",
           time_ms(lambda: xent.xentropy_bwd_kernel(logits, labels, xlse,
                                                    dloss, 0.0), inner=5),
           time_ms(lambda: xent.xentropy_bwd_plain(logits, labels, xlse,
                                                   dloss, 0.0), inner=5),
           t_cfb - t_cf, 2 * n * vv * 4 + n * (8 + 4 + 4), 4 * n * vv,
           FP32_FLOPS, f"xentropy bwd ({n}, {vv}) fp32",
           "F.cross_entropy backward (fwd+bwd - fwd)")
    return res


def _fused_adamw(tensors, m, v, dev):
    """One ``torch._fused_adamw_`` call over the tree's tensors: the
    library call computing the flat step's function in fp32 mode, timed
    only."""
    ps, gs = tensors
    steps = [torch.full((), 3.0, device=dev) for _ in ps]
    return lambda: torch._fused_adamw_(
        ps, gs, m, v, [], steps, lr=LR, beta1=0.9, beta2=0.999,
        weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False)


def step_times(dev):
    """The unfused-attention, flat-Adam step's kernels at its shapes. No
    single PyTorch call computes the scaled, masked softmax or its
    backward, so their library time is null; the nearest calls
    (``torch.softmax`` without scale or mask, ``_softmax_backward_data``
    without the scale) are printed beside them."""
    from apex_tpu_torch.multi_tensor_apply.flatten import unflatten_tensors

    fsm, mta = kernel_modules()[3:5]
    phase("times at the unfused-attention, flat-Adam step's shapes "
          "(BERT-Large, batch 64, seq 128; device ms per call, CUDA-graph "
          "replays)")
    gen = torch.Generator(device=dev).manual_seed(10)
    bf = torch.bfloat16
    res = {}
    b, nh, s = BIG_BATCH, 16, SEQ
    x = _rand(gen, (b, nh, s, s), bf, dev, 8.0)
    dy = _rand(gen, (b, nh, s, s), bf, dev)
    mask = torch.zeros((b, 1, 1, s), dtype=torch.int32, device=dev)
    n = x.numel()
    y = fsm.masked_softmax_fwd_kernel(x, mask, SM_SCALE)
    near_f = time_ms(lambda: torch.softmax(x, -1))
    near_b = time_ms(lambda: torch._softmax_backward_data(dy, y, -1, bf))
    _entry(res, "softmax_fwd",
           time_ms(lambda: fsm.masked_softmax_fwd_kernel(x, mask, SM_SCALE)),
           time_ms(lambda: fsm.masked_softmax_fwd_plain(x, mask, SM_SCALE)),
           None, 2 * n * 2 + b * s * 4, 5 * n, FP32_FLOPS,
           f"masked softmax fwd ({b}, {nh}, {s}, {s}) bf16",
           f"no single call (torch.softmax, no scale or mask: {near_f:.5f})")
    _entry(res, "softmax_bwd",
           time_ms(lambda: fsm.softmax_bwd_kernel(y, dy, SM_SCALE)),
           time_ms(lambda: fsm.softmax_bwd_plain(y, dy, SM_SCALE)),
           None, 3 * n * 2, 5 * n, FP32_FLOPS,
           f"softmax bwd ({b}, {nh}, {s}, {s}) bf16",
           f"no single call (_softmax_backward_data, no scale: "
           f"{near_b:.5f})")
    bc, sc = 16, 1024
    xc = _rand(gen, (bc, sc, sc), bf, dev, 4.0)
    nc = xc.numel()
    _entry(res, "softmax_causal",
           time_ms(lambda: fsm.causal_softmax_fwd_kernel(xc, SM_SCALE)),
           time_ms(lambda: fsm.causal_softmax_fwd_plain(xc, SM_SCALE)),
           None, 2 * nc * 2, 5 * nc, FP32_FLOPS,
           f"causal softmax fwd ({bc}, {sc}, {sc}) bf16", "no single call")
    del x, dy, y, xc
    for m_dtype, emit, key in ((torch.float32, None, "flat_adam"),
                               (bf, bf, "flat_adam_bf16m_castout")):
        g, p, m, v, hp, spec = adam_inputs(dev, m_dtype, gen)
        nel = p.numel()
        lib = None
        if emit is None:   # the library call over the tree's tensors
            views = [unflatten_tensors(t, spec) for t in (p, g, m, v)]
            lib = time_ms(_fused_adamw(views[:2], views[2], views[3], dev),
                          reps=5, inner=3)
        nbytes = nel * (4 * 3 + 4 * 2 + 2 * m.element_size()
                        + (2 if emit else 0))
        _entry(res, key,
               time_ms(lambda: mta.flat_adam_kernel(g, p, m, v, hp, None,
                                                    emit), reps=5, inner=3),
               time_ms(lambda: mta.flat_adam_plain(g, p, m, v, hp, None,
                                                   emit), reps=5, inner=3),
               lib, nbytes, 16 * nel, FP32_FLOPS,
               f"flat_adam ({spec.total_rows}, 128) m {str(m_dtype)[6:]}"
               f"{', bf16 cast-out' if emit else ''}",
               "torch._fused_adamw_ over the tree's tensors" if emit is None
               else "none (bf16 m)")
        del g, p, m, v
        torch.cuda.empty_cache()
    return res


def flat_times(dev):
    """The four flat kernels of this slice at BERT-Large's flat buffer
    (336,232,448 elements, fp32). Library calls: for the scale,
    ``torch._amp_foreach_non_finite_check_and_unscale_`` over the 300
    tensors (in place, scale 1, so the values stay put); for the
    partials, ``torch.linalg.vector_norm`` of the flat buffer (the same
    bytes; ``torch._foreach_norm`` over the tensors printed beside it);
    none computes axpby with its flag or LAMB's stage 1."""
    from apex_tpu_torch.multi_tensor_apply.flatten import unflatten_tensors

    mta = kernel_modules()[4]
    phase("times of the flat kernels on BERT-Large's flat buffer (device "
          "ms per call, CUDA-graph replays of 3 calls)")
    gen = torch.Generator(device=dev).manual_seed(13)
    res = {}
    kw = dict(reps=5, inner=3)
    x, spec = bert_flat(dev)
    nel = x.numel()
    label = f"({spec.total_rows}, 128) fp32"
    y = _rand(gen, x.shape, torch.float32, dev, 1e-2)
    s = torch.tensor(1.0 / 65536, device=dev)
    ab = torch.tensor([0.9, 0.1], device=dev)
    leaves = unflatten_tensors(x, spec)
    found = torch.zeros((), device=dev)
    one = torch.ones((), device=dev)
    _entry(res, "flat_scale",
           time_ms(lambda: mta.flat_scale_kernel(x, s, torch.float32), **kw),
           time_ms(lambda: mta.flat_scale_plain(x, s, torch.float32), **kw),
           time_ms(lambda: torch._amp_foreach_non_finite_check_and_unscale_(
               leaves, found, one), **kw),
           8 * nel, 2 * nel, FP32_FLOPS, f"flat_scale {label}",
           "_amp_foreach_non_finite_check_and_unscale_ over the tensors")
    _entry(res, "flat_axpby",
           time_ms(lambda: mta.flat_axpby_kernel(x, y, ab, torch.float32),
                   **kw),
           time_ms(lambda: mta.flat_axpby_plain(x, y, ab, torch.float32),
                   **kw),
           None, 12 * nel, 4 * nel, FP32_FLOPS, f"flat_axpby {label}",
           "none")
    t_fn = time_ms(lambda: torch._foreach_norm(leaves), **kw)
    _entry(res, "flat_l2norm",
           time_ms(lambda: mta.flat_l2norm_partials_kernel(x), **kw),
           time_ms(lambda: mta.flat_l2norm_partials_plain(x), **kw),
           time_ms(lambda: torch.linalg.vector_norm(x), **kw),
           4 * nel + 4 * (nel // mta.SUB), 2 * nel, FP32_FLOPS,
           f"flat_l2norm_partials {label}",
           f"torch._foreach_norm over the tensors {t_fn:.5f}; "
           "torch.linalg.vector_norm of the buffer")
    res["flat_l2norm"]["foreach_norm_ms"] = t_fn
    del x, y, leaves
    torch.cuda.empty_cache()
    for m_dtype, key in ((torch.float32, "flat_lamb_stage1"),
                         (torch.bfloat16, "flat_lamb_stage1_bf16m")):
        g, p, m, v, hp, spec, _ = lamb_inputs(dev, m_dtype, gen)
        # reads g, p, v and m; writes v, u and m; and the two partials
        nbytes = nel * (4 * 3 + 4 * 2 + 2 * m.element_size()) \
            + 2 * 4 * (nel // mta.SUB)
        _entry(res, key,
               time_ms(lambda: mta.flat_lamb_stage1_kernel(g, p, m, v, hp),
                       **kw),
               time_ms(lambda: mta.flat_lamb_stage1_plain(g, p, m, v, hp),
                       **kw),
               None, nbytes, 24 * nel, FP32_FLOPS,
               f"flat_lamb_stage1 {label}, m {str(m_dtype)[6:]}", "none")
        del g, p, m, v
        torch.cuda.empty_cache()
    return res


def resnet_flat(dev):
    """ResNet-50's params packed as the flat FusedSGD packs them: (the
    fp32 buffer, its spec)."""
    from apex_tpu_torch.models.resnet import init_resnet
    from apex_tpu_torch.multi_tensor_apply.flatten import flatten_tensors
    from apex_tpu_torch.utils.tree import tree_flatten

    params, _ = init_resnet(torch.Generator(device=dev).manual_seed(0),
                            RESNET_DEPTH, RESNET_CLASSES, device=dev)
    return flatten_tensors(tree_flatten(params)[0])


def _library_or_reason(fn, kw):
    """Time a PyTorch library call, or give the reason it has none on
    this card (its error's first line)."""
    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return None, str(e).splitlines()[0][:160]
    return time_ms(fn, **kw), None


def sgd_family_times(dev):
    """flat_sgd on ResNet-50's flat buffer (the main path's shape) and on
    BERT-Large's; flat_adagrad and flat_novograd's elementwise pass on
    BERT-Large's (their path). Library calls over the same tensors:
    ``torch._fused_sgd_`` (``torch.optim.SGD(fused=True)``'s kernel, in
    place, the momentum buffers seeded) and ``torch._fused_adagrad_``
    where the card's torch has a CUDA kernel for it; NovoGrad has
    none."""
    from apex_tpu_torch.multi_tensor_apply.flatten import unflatten_tensors

    mta = kernel_modules()[4]
    phase("times of flat_sgd, flat_adagrad and flat_novograd (device ms per "
          "call, CUDA-graph replays of 3 calls)")
    bf, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(15)
    kw = dict(reps=5, inner=3)
    res = {}
    sgd_kw = dict(lr=0.1, momentum=0.9, dampening=0.0, weight_decay=1e-4,
                  nesterov=False, wd_after_momentum=False,
                  first_run=False, grad_scale=1.0, device=dev)
    hp = mta.sgd_hparams(**sgd_kw)
    for where, make in (("resnet50", resnet_flat), ("bert", bert_flat)):
        p, spec = make(dev)
        g = _rand(gen, p.shape, f32, dev, 1e-3)
        nel = p.numel()
        label = f"({spec.total_rows}, 128) fp32"
        for buf_dt, emit in ((f32, None), (bf, bf)):
            buf = _rand(gen, p.shape, f32, dev, 1e-3).to(buf_dt)
            key = f"flat_sgd_{where}" + ("_bf16buf_castout" if emit else "")
            lib, why = None, "none (bf16 buffer and cast-out)"
            if emit is None:
                views = [unflatten_tensors(t, spec) for t in (p, g, buf)]
                lib, why = _library_or_reason(lambda: torch._fused_sgd_(
                    views[0], views[1], views[2], weight_decay=1e-4,
                    momentum=0.9, lr=0.1, dampening=0.0, nesterov=False,
                    maximize=False, is_first_step=False), kw)
                why = why or "torch._fused_sgd_ over the tree's tensors"
            # reads g, p, buf; writes p, buf (and the cast-out)
            nbytes = nel * (4 + 4 * 2 + 2 * buf.element_size()
                            + (2 if emit else 0))
            _entry(res, key,
                   time_ms(lambda: mta.flat_sgd_kernel(g, p, buf, hp, None,
                                                       emit), **kw),
                   time_ms(lambda: mta.flat_sgd_plain(g, p, buf, hp, None,
                                                      emit), **kw),
                   lib, nbytes, 8 * nel, FP32_FLOPS,
                   f"flat_sgd {where} {label}, buf {str(buf_dt)[6:]}"
                   f"{', bf16 cast-out' if emit else ''}", why)
            del buf
        if where == "bert":
            s = _rand(gen, p.shape, f32, dev, 1e-3).abs()
            hpa = mta.adagrad_hparams(lr=1e-2, eps=1e-10, weight_decay=0.01,
                                      adagrad_w_mode=False, grad_scale=1.0,
                                      device=dev)
            views = [unflatten_tensors(t, spec) for t in (p, g, s)]
            steps = [torch.ones((), device=dev) for _ in views[0]]
            lib, why = _library_or_reason(lambda: torch._fused_adagrad_(
                views[0], views[1], views[2], steps, lr=1e-2, lr_decay=0.0,
                weight_decay=0.01, eps=1e-10, maximize=False), kw)
            _entry(res, "flat_adagrad",
                   time_ms(lambda: mta.flat_adagrad_kernel(g, p, s, hpa),
                           **kw),
                   time_ms(lambda: mta.flat_adagrad_plain(g, p, s, hpa),
                           **kw),
                   lib, nel * 20, 10 * nel, FP32_FLOPS,
                   f"flat_adagrad bert {label}",
                   "torch._fused_adagrad_ over the tree's tensors" if why is
                   None else f"none: torch._fused_adagrad_ on CUDA raises "
                   f"'{why}'")
            res["flat_adagrad"]["library_note"] = why
            del s, views
            m = _rand(gen, p.shape, f32, dev, 1e-3)
            den = _rand(gen, (nel // mta.SUB,), f32, dev, 1.0).abs() + 0.1
            hpn = mta.novograd_hparams(lr=1e-3, beta1=0.95, step=2,
                                       weight_decay=0.01,
                                       grad_averaging=True,
                                       bias_correction=True,
                                       reg_inside_moment=False,
                                       grad_scale=1.0, device=dev)
            _entry(res, "flat_novograd",
                   time_ms(lambda: mta.flat_novograd_kernel(g, p, m, den,
                                                            hpn), **kw),
                   time_ms(lambda: mta.flat_novograd_plain(g, p, m, den,
                                                           hpn), **kw),
                   None, nel * 20 + 4 * (nel // mta.SUB), 10 * nel,
                   FP32_FLOPS, f"flat_novograd bert {label}, elementwise "
                   "pass (the L2 partials pre-pass is row 15)", "none")
            del m, den
        del p, g
        torch.cuda.empty_cache()
    return res


def _cycle(fns):
    """One callable that calls ``fns`` in turn."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def w8_times(dev):
    """Rows 21-23 at M 8 (a decode step's slots), M 128 (the smallest
    prefill bucket; rows 21-22), M 1 (row 23: a prefill takes the logits
    of its last real token) and M 1024 (a 1024-token prefill), bf16 x
    as on the O2 path. The linears are timed over 24 weight copies, one
    call each in turn, as a step reads its 24 layers (72-96 MB, past the
    50 MB L2); the word table is read once (51.5 MB). The library call is
    ``torch._weight_int8pack_mm`` where the card's torch has it for CUDA
    (bf16 scales and output, no bias; the KN rows on transposed copies
    made outside the timing); else ``torch.matmul``/``addmm`` over the
    weights dequantized to bf16, a different function (it reads bf16
    weights). Rows 21-22 also time the bf16 serving path's own linear on
    the dequantized bf16 weights (``torch.addmm(bias, x, w_bf16)``, or
    ``torch.matmul`` without the bias): a different function, reading
    twice the weight bytes, and the yardstick a w8 prefill has to
    approach."""
    from apex_tpu_torch.quant import dequantize_tensor

    w8 = kernel_modules()[5]
    phase("times of the int8 weight-only matmuls at M 8, 128, 1 and 1024 "
          "(bf16 x; device ms per call, CUDA-graph replays)")
    gen = torch.Generator(device=dev).manual_seed(15)
    bf, f32 = torch.bfloat16, torch.float32
    int8pack = torch._C._dispatch_has_kernel_for_dispatch_key(
        "aten::_weight_int8pack_mm", "CUDA")
    lib_name = ("torch._weight_int8pack_mm (bf16 scales and out, no bias)"
                if int8pack else "torch.matmul over the weights dequantized "
                "to bf16 (a different function)")
    res = {"w8_library": lib_name}
    for name, (k, n), kind, copies in (
            ("w8_matmul", W8_LINEARS[0], "bias", 24),
            ("w8_matmul_nobias", W8_LINEARS[3], "nobias", 24),
            ("w8_matmul_nk", W8_TABLE, "nk", 1)):
        nk = kind == "nk"
        ops = [w8_operands(gen, dev, 1, k, n, bf, nk, kind == "bias")
               for _ in range(copies)]
        deq = [dequantize_tensor(o[1], o[2], -1 if nk else -2, bf)
               for o in ops]
        for m in (8, 1, 1024) if nk else (8, 128, 1024):
            x = _rand(gen, (m, k), bf, dev)
            if nk:
                fk = [lambda o=o: w8.w8_matmul_nk_kernel(x, o[1], o[2], f32)
                      for o in ops]
                fp = [lambda o=o: w8.w8_matmul_nk_plain(x, o[1], o[2], f32)
                      for o in ops]
            else:
                fk = [lambda o=o: w8.w8_matmul_kernel(x, o[1], o[2], o[3], bf)
                      for o in ops]
                fp = [lambda o=o: w8.w8_matmul_plain(x, o[1], o[2], o[3], bf)
                      for o in ops]
            # the library baseline: one torch product at x's dtype on the
            # weights dequantized ahead (a timing, not a dequant path)
            if nk:
                # apxlint: disable=APX106
                lin = [lambda d=d: torch.matmul(x, d.t()) for d in deq]
            elif kind == "bias":
                lin = [lambda d=d, o=o: torch.addmm(o[3], x, d)
                       for d, o in zip(deq, ops)]
            else:
                # apxlint: disable=APX106
                lin = [lambda d=d: torch.matmul(x, d) for d in deq]
            if int8pack:
                packed = [(o[1] if nk else o[1].t().contiguous(),
                           o[2].to(bf)) for o in ops]
                fl = [lambda p=p: torch._weight_int8pack_mm(x, *p)
                      for p in packed]
            else:
                fl = lin
            kw = dict(inner=copies) if copies > 1 else dict(inner=5)
            nbytes = (m * k * 2 + k * n + n * 4 + (n * 2 if kind == "bias"
                                                   else 0)
                      + m * n * (4 if nk else 2))
            key = f"{name}_m{m}"
            _entry(res, key, time_ms(_cycle(fk), **kw),
                   time_ms(_cycle(fp), **kw), time_ms(_cycle(fl), **kw),
                   nbytes, 2 * m * k * n, BF16_TC_FLOPS,
                   f"{name} M {m} K {k} N {n} bf16 x", lib_name)
            if not nk:
                t = time_ms(_cycle(lin), **kw)
                res[key]["bf16_linear_ms"] = t
                print(f"  the bf16 serving linear on the dequantized bf16 "
                      f"weights ({'addmm' if kind == 'bias' else 'matmul'}; "
                      f"a different function): {t:.5f}", flush=True)
            del x, fk, fp, fl, lin
        del ops, deq
        torch.cuda.empty_cache()
    return res


# The integer-ALU operations an element (csrc/threefry.cu's note): the 20
# rounds' funnel shift and xor (40), the xor of the two words (1) and, for
# the dropout, the shift and or that build the uniform (2). Funnel shifts
# and logic ops run only on the integer ALU, 64 lanes an SM on Hopper;
# the 32 adds of the hash can run as IMAD on the FMA pipe beside them,
# so the ALU operations bound the kernels.
BITS_ALU_OPS, DROPOUT_ALU_OPS = 41, 43
ALU_LANES_PER_SM = 64


def max_sm_clock_mhz():
    """The card's maximum SM clock (``nvidia-smi``), or the H100 SXM's
    1980 MHz when it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60).stdout.split()
        return float(out[0]) if out else 1980.0
    except (OSError, subprocess.TimeoutExpired, ValueError):
        return 1980.0


def threefry_times(dev):
    """The bits kernel at the decode tick's (8, 50304) and at one key
    over BERT-Large's hidden shape; the dropout at the hidden shape and
    at the unfused attention's probabilities (bf16). Bounds: the
    integer-ALU operations over 64 lanes an SM at the maximum SM clock,
    or the bytes, the larger; ``F.dropout`` (Philox: a different
    function) beside."""
    p = kernel_modules()[6]
    clock = max_sm_clock_mhz()
    peak = (torch.cuda.get_device_properties(dev).multi_processor_count
            * ALU_LANES_PER_SM * clock * 1e6)
    phase(f"times of the threefry kernels (device ms per call; bound by "
          f"the integer ALU at {clock:.0f} MHz, {peak / 1e12:.2f} T op/s)")
    res = {}
    keys8 = p._to_int32(p.split(p.PRNGKey(1), 8)).to(dev)
    key1 = p._to_int32(p.PRNGKey(2)[None]).to(dev)
    for label, keys, n in (("threefry_bits_8x50304", keys8, 50304),
                           ("threefry_bits_hidden", key1,
                            64 * 128 * 1024)):
        elems = keys.shape[0] * n
        _entry(res, label,
               time_ms(lambda: p.threefry_bits_kernel(keys, n, dev)),
               time_ms(lambda: p.threefry_bits_plain(keys, n, dev)), None,
               4 * elems, BITS_ALU_OPS * elems, peak,
               f"threefry bits, {keys.shape[0]} key(s) x {n}", "no library")
    # the card's launch floor: one 1-element op in the same harness (a
    # floor on any launch's time, not a bound on the bits' work)
    one = torch.zeros(1, device=dev)
    floor = time_ms(lambda: one.add_(1))
    res["threefry_bits_8x50304"]["launch_floor_ms"] = floor
    print(f"  launch floor (a 1-element add_, CUDA-graph replays): "
          f"{floor:.5f}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(12)
    words = p.host_bits(p.PRNGKey(3), 2)
    for label, shape in (("threefry_dropout_hidden", HIDDEN_SHAPE),
                         ("threefry_dropout_probs", PROBS_SHAPE)):
        x = _rand(gen, shape, torch.bfloat16, dev)
        _entry(res, label,
               time_ms(lambda: p.dropout_kernel(x, words, 0.1)),
               time_ms(lambda: p.dropout_plain(x, words, 0.1)), None,
               2 * 2 * x.numel(), DROPOUT_ALU_OPS * x.numel(), peak,
               f"threefry dropout {shape} bf16 rate 0.1", "no library")
        t_f = time_ms(lambda: F.dropout(x, 0.1, training=True))
        res[label]["f_dropout_ms"] = t_f
        print(f"  F.dropout at the same shape (Philox bits: a different "
              f"function): {t_f:.5f}", flush=True)
    for v in res.values():
        v["bound_clock_mhz"] = clock
    del x
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# 8. GPT: RoPE serving and training (the JAX package's decode benchmark's
#    RoPE model, bench.py's _decode_bench_setup, and its tp=1 GPT-medium
#    step, gpt_tp_bench(on_tpu, n_devices=1))
# ---------------------------------------------------------------------------

GPT_BATCH, GPT_SEQ, GPT_STEPS = 8, 1024, 6
GPT_SMALL_BATCH, GPT_SMALL_SEQ, GPT_SMALL_LAYERS = 2, 256, 2
U32_ULP = 2.0 ** -24


def _gpt_qkv(gen, dev, b, h, s, d):
    """q, k, v as the GPT training path hands them to flash: q and k
    rotated by RoPE from the ``_split_qkv`` views of a fused (b, s, 3 h
    d) bf16 projection, v still a view."""
    from apex_tpu_torch.models.gpt import _split_qkv
    from apex_tpu_torch.transformer.functional import (
        fused_apply_rotary_pos_emb_bhsd, rope_frequencies,
    )

    q, k, v = _split_qkv(_rand(gen, (b, s, 3 * h * d), torch.bfloat16,
                               dev), d)
    freqs = rope_frequencies(d, s, device=dev)
    return (fused_apply_rotary_pos_emb_bhsd(q, freqs),
            fused_apply_rotary_pos_emb_bhsd(k, freqs), v)


def gpt_kernel_parity(dev):
    """The flash forward, dq and dk/dv at GPT-medium's training shape
    (causal, b 8, h 16, s 1024, d 64, bf16; q and k out of RoPE, v a
    view of the projection; with and without a key mask as prefill
    passes one), and the cross entropy on (8192, 50304) bf16 logits,
    each against its plain version per element to its error model."""
    fa, xent = kernel_modules()[1:3]
    phase("kernel parity at GPT-medium's training shapes (flash causal b8 "
          "h16 s1024 d64 bf16, RoPE'd q and k, v a view: o_limit and "
          "bwd_limits; cross entropy (8192, 50304) bf16: xentropy.limits; "
          "a second launch gives the same bits)")
    gen = torch.Generator(device=dev).manual_seed(21)
    b, h, s, d = GPT_BATCH, 16, GPT_SEQ, 64
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0, "xent_fwd": 0.0,
             "xent_bwd": 0.0}
    seed, kw = (0, 0), dict(causal=True, scale=d ** -0.5, rate=0.0)
    q, k, v = _gpt_qkv(gen, dev, b, h, s, d)
    do = _rand(gen, (b, s, h, d), torch.bfloat16, dev).transpose(1, 2)
    for mask in (None, _flash_mask(b, s, dev, 8)):
        o, lse = fa.attention_fwd_kernel(q, k, v, mask, seed, **kw)
        o2, lse2 = fa.attention_fwd_kernel(q, k, v, mask, seed, **kw)
        got = fa.attention_bwd_kernel(q, k, v, mask, o, lse, do, seed, **kw)
        again = fa.attention_bwd_kernel(q, k, v, mask, o, lse, do, seed,
                                         **kw)
        torch.cuda.synchronize()
        o0, lse0 = fa.attention_fwd_plain(q, k, v, mask, seed, **kw)
        e_o, use_o = _held(o, o0, fa.o_limit(q, k, v, mask, o0, causal=True,
                                             scale=d ** -0.5))
        fin = torch.isfinite(lse0)
        le = float((lse - lse0)[fin].abs().max())
        ok = use_o <= 1.0 and le <= LSE_TOL[torch.bfloat16]
        ok &= torch.equal(o, o2) and torch.equal(lse, lse2)
        want = fa.attention_bwd_plain(q, k, v, mask, o, lse, do, seed, **kw)
        lims = fa.bwd_limits(q, k, v, mask, o, lse, do, *want, **kw)
        parts = []
        for name, g, g2, w0, lim in zip(("dq", "dk", "dv"), got, again,
                                        want, lims):
            e, use = _held(g, w0, lim)
            ok &= use <= 1.0 and bool(torch.isfinite(g).all())
            ok &= torch.equal(g, g2)
            key = "dq" if name == "dq" else "dkv"
            worst[key] = max(worst[key], e)
            parts.append(f"{name} {e:.3g} ({use:.2f})")
        worst["fwd"] = max(worst["fwd"], e_o)
        check(ok, f"flash causal b{b} h{h} s{s} d{d} bf16, RoPE'd q and k "
              f"({_load_variant(q, k)}), v a view ({_load_variant(v)}), "
              f"mask={mask is not None}: max_abs_err (share of its "
              f"tolerance) o {e_o:.3g} ({use_o:.2f}), lse {le:.3g}, "
              + ", ".join(parts) + "; repeats bit-equal")
        del o, o2, got, again, want, lims, o0
    del q, k, v, do
    torch.cuda.empty_cache()
    n, vv = GPT_BATCH * GPT_SEQ, 50304
    x = _rand(gen, (n, vv), torch.bfloat16, dev, 3.0)
    labels = torch.randint(0, vv, (n,), generator=gen, device=dev)
    dloss = torch.full((n,), 1.0 / n, device=dev)   # the mean's gradient
    loss, lse = xent.xentropy_fwd_kernel(x, labels, 0.0)
    dx = xent.xentropy_bwd_kernel(x, labels, lse, dloss, 0.0)
    dx2 = xent.xentropy_bwd_kernel(x, labels, lse, dloss, 0.0)
    loss2, _ = xent.xentropy_fwd_kernel(x, labels, 0.0)
    torch.cuda.synchronize()
    loss0, lse0 = xent.xentropy_fwd_plain(x, labels, 0.0)
    dx0 = xent.xentropy_bwd_plain(x, labels, lse0, dloss, 0.0)
    lims = xent.limits(x, labels, 0.0, loss0, lse0, dloss, dx0)
    res = [_held(g, w0, lim) for g, w0, lim in zip(
        (loss, lse, dx), (loss0, lse0, dx0), lims)]
    ok = all(use <= 1.0 for _, use in res) and dx.dtype == torch.bfloat16
    ok &= torch.equal(dx, dx2) and torch.equal(loss, loss2)
    worst["xent_fwd"] = max(res[0][0], res[1][0])
    worst["xent_bwd"] = res[2][0]
    check(ok, f"xentropy ({n}, {vv}) bf16 (393 x 128 columns): max_abs_err "
          "(share of its tolerance) " + ", ".join(
              f"{nm} {e:.3g} ({use:.2f})" for nm, (e, use) in zip(
                  ("loss", "lse", "dx bf16"), res)) + "; repeats bit-equal")
    return worst


def _rope_limit(t, cos, sin, want):
    """The RoPE error model (``fused_rope``'s docstring): 8 u of |t| |cos|
    + |rotate_half(t)| |sin| on the rotated channels, plus one ulp of a
    bf16 output."""
    from apex_tpu_torch.transformer.functional.fused_rope import (
        _rotate_half,
    )

    t = t.float()
    lim = 8 * U32_ULP * (t.abs() * cos.abs()
                         + _rotate_half(t).abs() * sin.abs())
    if want.dtype == torch.bfloat16:
        lim = lim + 2.0 ** -7 * want.float().abs()
    return lim


def rope_parity(dev):
    """RoPE on the card against the same calls on the CPU: the forward
    and dt at the training shape (q of the fused projection, bf16) and
    at the decode tick with per-slot positions; dcos and dsin of the
    cached form; each call's device time."""
    from apex_tpu_torch.models.gpt import _split_qkv
    from apex_tpu_torch.transformer.functional import fused_rope as rope
    from apex_tpu_torch.transformer.functional.fused_rope import (
        _rotate_half,
    )

    phase("RoPE, card vs CPU (fused_rope's error model: 8 u (|t| |cos| + "
          "|rotate_half(t)| |sin|) plus one ulp of a bf16 output; dcos, "
          "dsin 2 n u sum |g t| over the n broadcast terms)")
    gen = torch.Generator(device=dev).manual_seed(22)
    b, h, d = GPT_BATCH, 16, 64
    out = {}
    cases = (("train", GPT_SEQ, None), ("decode", 1, "per-slot"))
    for name, s, positions in cases:
        t = _split_qkv(_rand(gen, (b, s, 3 * h * d), torch.bfloat16, dev),
                       d)[0].requires_grad_(True)
        g = _rand(gen, (b, h, s, d), torch.bfloat16, dev)
        # training rotates rows 0..s-1 of an s-row table; decode gathers
        # each slot's row of the cache's S_max-row table
        freqs = rope.rope_frequencies(d, s if positions is None else
                                      MAX_LEN, device=dev)
        pos = None if positions is None else torch.linspace(
            0, MAX_LEN - 1, b, device=dev).long()
        y = rope.fused_apply_rotary_pos_emb_bhsd(t, freqs, pos)
        (dt,) = torch.autograd.grad(y, (t,), g)
        tc = t.detach().cpu().requires_grad_(True)
        yc = rope.fused_apply_rotary_pos_emb_bhsd(
            tc, freqs.cpu(), None if pos is None else pos.cpu())
        (dtc,) = torch.autograd.grad(yc, (tc,), g.cpu())
        f2 = freqs.cpu().reshape(freqs.shape[0], d).double()
        idx = torch.arange(s) if pos is None else pos.cpu()[:, None]
        c = torch.cos(f2)[idx].reshape((1 if pos is None else b), 1, s, d)
        sn = torch.sin(f2)[idx].reshape(c.shape)
        yc = yc.detach()
        uy = _share(y.detach().cpu(), yc, _rope_limit(tc.detach(), c, sn,
                                                      yc))
        ud = _share(dt.cpu(), dtc, _rope_limit(g.cpu(), c, sn, dtc))
        check(uy <= 1.0 and ud <= 1.0 and y.dtype == torch.bfloat16,
              f"RoPE {name} ({b}, {h}, {s}, {d}) bf16"
              f"{', positions per slot' if pos is not None else ''}: "
              f"forward {uy:.3f} and dt {ud:.3f} of their limits")
        tv = t.detach()
        t_f = time_ms(lambda: rope.fused_apply_rotary_pos_emb_bhsd(
            tv, freqs, pos))
        # the backward's dt: the same form with -sin, on the tables the
        # forward gathered (autograd stays out of the captured graph)
        cd, sd = c.float().to(dev), sn.float().to(dev)
        t_fb = t_f + time_ms(lambda: rope._apply(g, cd, -sd))
        # one read of t and one write of the output, the table's rows
        nbytes = 2 * t.numel() * 2 + 2 * s * d * 4
        out[name] = dict(fwd_ms=t_f, fwd_bwd_ms=t_fb, bound_ms=bound(
            nbytes, 6 * t.numel(), FP32_FLOPS)[0], forward_share=uy,
            dt_share=ud)
        print(f"RoPE {name}: forward {t_f:.5f} ms, forward + dt "
              f"{t_fb:.5f} ms a call (CUDA-graph replays), bytes bound "
              f"{out[name]['bound_ms']:.5f}", flush=True)
    cos, sin = rope.rope_cos_sin(d, GPT_SEQ, device=dev)
    t = _rand(gen, (GPT_SEQ, b, h, d), torch.float32, dev)
    g = _rand(gen, (GPT_SEQ, b, h, d), torch.float32, dev)
    got, want = [], []
    for dv, lst in ((dev, got), ("cpu", want)):
        cc = cos.to(dv).requires_grad_(True)
        ss = sin.to(dv).requires_grad_(True)
        y = rope.fused_apply_rotary_pos_emb_cached(t.to(dv), cc, ss)
        lst += torch.autograd.grad(y, (cc, ss), g.to(dv))
    tt, gg = t.cpu().double(), g.cpu().double()
    lims = [2 * b * h * U32_ULP * (gg * x).abs().sum((1, 2), keepdim=True)
            for x in (tt, _rotate_half(tt))]
    uc = max(_share(a.cpu(), w, lim) for a, w, lim in zip(got, want, lims))
    check(uc <= 1.0, f"RoPE cached ({GPT_SEQ}, {b}, {h}, {d}) fp32: dcos "
          f"and dsin {uc:.3f} of their limits")
    out["cached_table_grads_share"] = uc
    return out


def gpt_per_step_launches(L, remat, dropout, flat):
    """Exact launches of each kernel in one GPT step of ``L`` layers
    (``examples/gpt/train.py``): forward 2L + 1 LayerNorms, L flash
    forwards, one cross entropy; backward the same LayerNorms, L dq and L
    dk/dv, one cross-entropy backward. With ``remat`` each layer's
    forward runs again in the backward up to its last saved result, the
    fc2 product (non-reentrant checkpoint's early stop): 2 more
    LayerNorms, one more flash forward and, with dropout, the attention
    output's dropout (salt 0) again, but not fc2's (salt 1). Dropout
    launches once forward and once backward (the backward regenerates
    the mask) after each layer's attention output and fc2: 2L + 2L,
    plus L under remat. The flat FusedAdam launches ``flat_adam`` once;
    the tree path no kernel."""
    rec = L if remat else 0
    out = dict.fromkeys(KERNEL_NAMES, 0)
    out.update(layer_norm_fwd=2 * L + 1 + 2 * rec, layer_norm_bwd=2 * L + 1,
               flash_attention_fwd=L + rec, flash_attention_bwd_dq=L,
               flash_attention_bwd_dkv=L, xentropy_fwd=1, xentropy_bwd=1)
    if dropout:
        out["threefry_dropout"] = 4 * L + rec
    if flat:
        out["flat_adam"] = 1
    return out


# The GPT card-vs-CPU step: gradients, m, v and master to STEP_LIMITS (the
# BERT check's). The loss with bf16 compute differs: GPT's tied logits are
# bf16 (BERT's MLM logits are cast to fp32 before the loss), and card and
# CPU sum each logit's products in other orders before that rounding, so a
# logit may land one bf16 ulp apart and the loss carries it: held to the
# bf16 loss limit the CPU parity tests give the port against JAX (2e-4
# relative, tests/test_torch_gpt_train.py and test_torch_bert_train.py;
# 2.98e-05 measured on an H100 at these seeds).
GPT_STEP_LIMITS = {"O0": STEP_LIMITS["O0"],
                   "O2": dict(STEP_LIMITS["O2"], loss=2e-4)}
GPT_SMALL_CASES = {  # name -> (compute dtype, use_rope, dropout)
    "fp32": (None, False, False), "fp32 rope": (None, True, False),
    "bf16": (torch.bfloat16, False, False),
    "bf16 rope": (torch.bfloat16, True, False),
    "bf16 rope dropout": (torch.bfloat16, True, True),
}


def gpt_train_small(dev):
    """One step of GPT-medium width (h 1024, 16 heads, vocab 50304) at 2
    layers on the card and on the CPU from the same weights and batch:
    fp32 and bf16 compute, each with learned positions and with RoPE,
    and bf16 with RoPE and dropout 0.1; held to the BERT check's limits
    (``STEP_LIMITS``: fp32 compute as O0, bf16 as O2), the bf16 loss to
    ``GPT_STEP_LIMITS``."""
    import dataclasses

    from apex_tpu_torch.examples.gpt.train import (
        make_gpt_train_step, make_state, synthetic_batch,
    )
    from apex_tpu_torch.models.gpt import gpt_medium
    from apex_tpu_torch.utils.tree import tree_map

    p = kernel_modules()[6]
    out = {}
    b, s, L = GPT_SMALL_BATCH, GPT_SMALL_SEQ, GPT_SMALL_LAYERS
    for name, (cdt, rope, drop) in GPT_SMALL_CASES.items():
        lim = GPT_STEP_LIMITS["O0" if cdt is None else "O2"]
        cfg = dataclasses.replace(gpt_medium(), num_layers=L, use_rope=rope)
        key = p.PRNGKey(DROPOUT_SEED) if drop else None
        phase(f"GPT training ({name}), card vs CPU: GPT-medium width, {L} "
              f"layers (remat), batch {b}, seq {s}, one step of "
              "make_gpt_train_step (FusedAdam lr 1e-4, wd 0.01)"
              + (f", dropout {cfg.hidden_dropout}" if drop else ""))
        step_d = make_gpt_train_step(cfg, compute_dtype=cdt, dropout_rng=key)
        step_c = make_gpt_train_step(cfg, compute_dtype=cdt, dropout_rng=key)
        params_d, opt_d = make_state(cfg, step_d.opt, 0, dev)
        params_c = tree_map(lambda t: t.cpu(), params_d)
        opt_c = step_c.opt.init(params_c)
        ids = synthetic_batch(0, b, s, cfg.vocab_size, dev)
        ids_c = synthetic_batch(0, b, s, cfg.vocab_size, "cpu")
        check(torch.equal(ids.cpu(), ids_c), "same ids on both devices")
        k0 = None if key is None else p.fold_in(key, 0)
        t0 = time.perf_counter()
        _, grads_d = step_d.grads(params_d, ids, ids, dropout_rng=k0)
        new_d = step_d(params_d, opt_d, ids, ids)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, grads_c = step_c.grads(params_c, ids_c, ids_c, dropout_rng=k0)
        new_c = step_c(params_c, opt_c, ids_c, ids_c)
        t2 = time.perf_counter()
        loss_d, loss_c = float(new_d[2]), float(new_c[2])
        got = {"loss": abs(loss_d - loss_c) / abs(loss_c),
               "grads": _relnorm(grads_d, grads_c),
               "m": _relnorm(new_d[1].m, new_c[1].m),
               "v": _relnorm(new_d[1].v, new_c[1].v),
               "master": _maxabs(new_d[0], new_c[0])}
        print(f"card {t1 - t0:.2f} s, CPU {t2 - t1:.2f} s; loss card "
              f"{loss_d:.6f}, CPU {loss_c:.6f}", flush=True)
        for k, val in got.items():
            what = "max abs" if k == "master" else "relative"
            check(val <= lim[k] and np.isfinite(val), f"{name} {k}: card "
                  f"vs CPU {what} {val:.3g} <= {lim[k]:g}")
        out[name] = got
        del params_d, opt_d, grads_d, new_d, step_d
        torch.cuda.empty_cache()
    return out


GPT_BIG = {  # name -> (use_rope, dropout, flat FusedAdam)
    "gpt_tree": (False, False, False),
    "gpt_rope_dropout": (True, True, True),
}


def gpt_train_big(dev, kern):
    """Six steps of full GPT-medium (24 layers, remat) at gpt_tp_bench's
    tp=1 shape, batch 8, seq 1024, bf16 compute over fp32 params, on one
    fixed batch from ``randint(PRNGKey(1000))`` with labels = ids:
    ``gpt_tree`` (the JAX benchmark's step exactly, tree FusedAdam) and
    ``gpt_rope_dropout`` (RoPE, dropout 0.1 on ``fold_in(PRNGKey(0),
    step)``, flat FusedAdam). Counts set to 0 before each run and read
    after it; losses finite and falling; exact launches a step."""
    import dataclasses

    from apex_tpu_torch.examples.gpt.train import (
        make_gpt_train_step, make_state, synthetic_batch,
    )
    from apex_tpu_torch.models.gpt import gpt_medium
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.utils.tree import tree_leaves

    p = kernel_modules()[6]
    out = {}
    for name, (rope, drop, flat) in GPT_BIG.items():
        cfg = dataclasses.replace(gpt_medium(), use_rope=rope)
        L = cfg.num_layers
        per_step = gpt_per_step_launches(L, cfg.remat, drop, flat)
        phase(f"GPT training ({name}): gpt_medium ({L} layers, remat "
              f"{cfg.remat}, {'RoPE' if rope else 'learned positions'}), "
              f"batch {GPT_BATCH}, seq {GPT_SEQ}, bf16 compute over fp32 "
              f"params, {'flat' if flat else 'tree'} FusedAdam(lr=1e-4, "
              f"weight_decay=0.01), {GPT_STEPS} steps"
              + (f", dropout {cfg.hidden_dropout} on fold_in(PRNGKey("
                 f"{DROPOUT_SEED}), step)" if drop else ""))
        step = make_gpt_train_step(
            cfg, FusedAdam(lr=1e-4, weight_decay=0.01, use_flat_kernel=flat),
            dropout_rng=p.PRNGKey(DROPOUT_SEED) if drop else None)
        params, opt_state = make_state(cfg, step.opt, 0, dev)
        ids = synthetic_batch(0, GPT_BATCH, GPT_SEQ, cfg.vocab_size, dev)
        n_params = sum(t.numel() for t in tree_leaves(params))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kern.values():
            k.launches = 0
        losses, times, steps_ok = [], [], True
        for _ in range(GPT_STEPS):
            before = {n: k.launches for n, k in kern.items()}
            t0 = time.perf_counter()
            params, opt_state, loss = step(params, opt_state, ids, ids)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(loss)
            steps_ok &= all(kern[n].launches - before[n] == per_step[n]
                            for n in kern)
        launches = {n: k.launches for n, k in kern.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = [float(x) for x in losses]
        print(f"losses {[round(x, 5) for x in losses]}", flush=True)
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              "every loss finite, the last below the first")
        check(steps_ok and all(launches[n] == GPT_STEPS * per_step[n]
                               for n in kern),
              f"launches per step exactly "
              f"{ {n: c for n, c in per_step.items() if c} } (every other "
              f"kernel 0; {launches} over {GPT_STEPS} steps)")
        med = statistics.median(times[1:])
        print(f"smoke reading, not a benchmark: median step "
              f"{med * 1e3:.1f} ms over steps 2-{GPT_STEPS} "
              f"({GPT_BATCH * GPT_SEQ / med:.0f} tokens/s); first step "
              f"{times[0] * 1e3:.1f} ms; peak device memory {peak:.2f} GiB; "
              f"{n_params} parameters", flush=True)
        out[name] = dict(losses=losses, step_ms=[t * 1e3 for t in times],
                         median_step_ms=med * 1e3,
                         tokens_per_s=GPT_BATCH * GPT_SEQ / med,
                         launches=launches, per_step=per_step,
                         peak_gib=peak, parameters=n_params)
        del params, opt_state, step
        torch.cuda.empty_cache()
    return out


def pretrain_defaults(dev):
    """``examples/gpt/pretrain_gpt.py`` at its defaults (the reference
    CLI's: 4 layers, h 64, seq 64, global batch 8 in 4 microbatches, 10
    steps) on the card: finite losses on its printed steps, then DONE."""
    import contextlib
    import io

    from apex_tpu_torch.examples.gpt import pretrain_gpt

    phase("pretrain_gpt.py at its defaults on the card")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = pretrain_gpt.main([])
    text = buf.getvalue()
    print(text, end="", flush=True)
    losses = [float(ln.split()[3]) for ln in text.splitlines()
              if ln.startswith("step ")]
    check(rc == 0 and len(losses) >= 3 and all(np.isfinite(losses))
          and text.strip().endswith("DONE"),
          f"{len(losses)} finite losses printed, then DONE")
    return losses


def serve_rope(dev, kern):
    """``serving_rope``: GPT-medium with ``use_rope=True`` (the JAX decode
    benchmark's model: bench.py's _decode_bench_setup), random weights
    from seed 0, no position table; decode logits against the full
    forward (fp32 and O2), then the 16 requests on the O2 params twice:
    the replay commits the same streams, exact launches."""
    import dataclasses

    from apex_tpu_torch import amp
    from apex_tpu_torch.models.gpt import gpt_medium, init_gpt

    phase("serving_rope: gpt_medium with use_rope=True (no position "
          "table), 16 greedy requests x 32 tokens, 8 slots, run twice")
    cfg = dataclasses.replace(gpt_medium(), use_rope=True)
    L = cfg.num_layers
    params = init_gpt(cfg, torch.Generator().manual_seed(0), device=dev)
    check("position" not in params["embedding"], "no position table")
    out = {}
    with torch.inference_mode():
        out["decode_err_fp32"] = decode_vs_full(
            params, cfg, dev, torch.float32, "RoPE, fp32 params and cache",
            1e-5)
        params = amp.initialize("O2", verbosity=0).cast_model(params)
        torch.cuda.empty_cache()
        out["decode_err_bf16"] = decode_vs_full(
            params, cfg, dev, torch.bfloat16,
            "RoPE, O2 bf16 params and cache", 0.0625)
        runs = [serve_mix(dev, cfg, params, kern) for _ in range(2)]
    check(runs[0]["streams"] == runs[1]["streams"],
          f"replay: the second run commits the same {N_REQUESTS} streams")
    sr = runs[0]
    forwards = N_REQUESTS + sr["decode_steps"]
    check_launches(sr["launches"], {
        "layer_norm_fwd": (2 * L + 1) * forwards,
        "flash_attention_fwd": L * N_REQUESTS}, "RoPE serving")
    print(f"smoke reading, not a benchmark: {sr['tokens_per_s']:.1f} and "
          f"{runs[1]['tokens_per_s']:.1f} tokens/s", flush=True)
    del sr["streams"]
    out.update(sr, replay_tokens_per_s=runs[1]["tokens_per_s"])
    return out


def _flash_times(res, prefix, dev, b, h, s, d, what, gen=None):
    """The causal flash forward, dq and dk/dv at (b, h, s, d) bf16 on
    RoPE'd q and k and a view v (``res[prefix + "_fwd" | "_dq" |
    "_dkv"]``), against SDPA's causal forward and backward."""
    gen = gen or torch.Generator(device=dev).manual_seed(23)
    fa = kernel_modules()[1]
    q, k, v = _gpt_qkv(gen, dev, b, h, s, d)
    do = _rand(gen, (b, s, h, d), torch.bfloat16, dev).transpose(1, 2)
    kw = dict(causal=True, scale=d ** -0.5, rate=0.0)
    o, lse = fa.attention_fwd_kernel(q, k, v, None, (0, 0), **kw)
    delta = (do.float() * o.float()).sum(-1).reshape(-1, s)
    qc, kc, vc = (t.contiguous().requires_grad_(True) for t in (q, k, v))
    doc = do.contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qc, kc, vc, is_causal=True,
                                              scale=d ** -0.5)

    t_lf = time_ms(lambda: sdpa().detach())
    t_lfb = time_ms(lambda: torch.autograd.grad(sdpa(), (qc, kc, vc), doc))
    t_pb = time_ms(lambda: fa.attention_bwd_plain(q, k, v, None, o, lse, do,
                                                  (0, 0), **kw), reps=5,
                   inner=3)
    pairs = b * h * s * (s + 1) // 2
    qkvo = 4 * b * h * s * d * 2
    rowstats = 2 * b * h * s * 4
    label = f"b{b} h{h} s{s} d{d} causal bf16, {what}"
    _entry(res, f"{prefix}_fwd",
           time_ms(lambda: fa.attention_fwd_kernel(q, k, v, None, (0, 0),
                                                   **kw)),
           time_ms(lambda: fa.attention_fwd_plain(q, k, v, None, (0, 0),
                                                  **kw), reps=5, inner=3),
           t_lf, qkvo + b * h * s * 4, 4 * d * pairs, BF16_TC_FLOPS,
           f"flash fwd {label}", "scaled_dot_product_attention causal")
    _entry(res, f"{prefix}_dq",
           time_ms(lambda: fa.attention_dq_kernel(q, k, v, None, do, lse,
                                                  delta, (0, 0), **kw)),
           t_pb, t_lfb - t_lf, qkvo + rowstats + b * h * s * d * 2,
           6 * d * pairs, BF16_TC_FLOPS, f"flash dq {label}",
           "sdpa causal backward (fwd+bwd - fwd; plain: whole backward)")
    _entry(res, f"{prefix}_dkv",
           time_ms(lambda: fa.attention_dkv_kernel(q, k, v, None, do, lse,
                                                   delta, (0, 0), **kw)),
           t_pb, t_lfb - t_lf, qkvo + rowstats + 2 * b * h * s * d * 2,
           8 * d * pairs, BF16_TC_FLOPS, f"flash dk/dv {label}",
           "sdpa causal backward (fwd+bwd - fwd; plain: whole backward)")
    del q, k, v, do, o, qc, kc, vc, doc
    torch.cuda.empty_cache()


def gpt_times(dev):
    """The GPT-medium step's kernels at its shapes (device ms per call,
    CUDA-graph replays): the causal flash forward, dq and dk/dv at b 8,
    h 16, s 1024, d 64 on RoPE'd q and k and a view v, against SDPA's
    causal forward and backward; the cross entropy on (8192, 50304) bf16
    against ``F.cross_entropy``; ``flat_adam`` on GPT-medium's flat
    buffer against ``torch._fused_adamw_``. The LayerNorm's (8192,
    1024) bf16 x, fp32 w is the BERT step's shape, timed above."""
    from apex_tpu_torch.multi_tensor_apply.flatten import (
        flatten_tensors, unflatten_tensors,
    )
    from apex_tpu_torch.multi_tensor_apply.kernels import adam_hparams
    from apex_tpu_torch.models.gpt import gpt_medium, init_gpt
    from apex_tpu_torch.utils.tree import tree_flatten

    xent = kernel_modules()[2]
    mta = kernel_modules()[4]
    phase("times at the GPT-medium step's shapes (batch 8, seq 1024; "
          "device ms per call, CUDA-graph replays)")
    gen = torch.Generator(device=dev).manual_seed(23)
    res = {}
    b, s = GPT_BATCH, GPT_SEQ
    _flash_times(res, "gpt_flash", dev, b, 16, s, 64,
                 "RoPE'd q, k and a view v", gen)
    n, vv = b * s, 50304
    logits = _rand(gen, (n, vv), torch.bfloat16, dev, 3.0)
    labels = torch.randint(0, vv, (n,), generator=gen, device=dev)
    dloss = torch.full((n,), 1.0 / n, device=dev)
    _, xlse = xent.xentropy_fwd_plain(logits, labels, 0.0)
    lr = logits.clone().requires_grad_(True)

    def ce():
        return F.cross_entropy(lr, labels, reduction="none")

    t_cf = time_ms(lambda: ce().detach(), inner=5)
    t_cfb = time_ms(lambda: torch.autograd.grad(ce(), lr, dloss.to(
        torch.bfloat16)), inner=5)
    _entry(res, "gpt_xent_fwd",
           time_ms(lambda: xent.xentropy_fwd_kernel(logits, labels, 0.0),
                   inner=5),
           time_ms(lambda: xent.xentropy_fwd_plain(logits, labels, 0.0),
                   reps=5, inner=3),
           t_cf, n * vv * 2 + n * 8 + 2 * n * 4, 4 * n * vv, FP32_FLOPS,
           f"xentropy fwd ({n}, {vv}) bf16", "F.cross_entropy (bf16)")
    _entry(res, "gpt_xent_bwd",
           time_ms(lambda: xent.xentropy_bwd_kernel(logits, labels, xlse,
                                                    dloss, 0.0), inner=5),
           time_ms(lambda: xent.xentropy_bwd_plain(logits, labels, xlse,
                                                   dloss, 0.0), reps=5,
                   inner=3),
           t_cfb - t_cf, 2 * n * vv * 2 + n * (8 + 4 + 4), 4 * n * vv,
           FP32_FLOPS, f"xentropy bwd ({n}, {vv}) bf16",
           "F.cross_entropy backward (bf16; fwd+bwd - fwd)")
    del logits, lr, xlse
    torch.cuda.empty_cache()
    params = init_gpt(gpt_medium(), torch.Generator(device=dev).manual_seed(
        0), device=dev)
    leaves, _ = tree_flatten(params)
    p, spec = flatten_tensors(leaves)
    del params, leaves
    g = _rand(gen, p.shape, torch.float32, dev, 1e-3)
    m = _rand(gen, p.shape, torch.float32, dev, 1e-4)
    vv2 = _rand(gen, p.shape, torch.float32, dev, 1e-6).abs()
    hp = adam_hparams(lr=LR, beta1=0.9, beta2=0.999, eps=1e-8,
                      step=torch.tensor(3, device=dev), weight_decay=0.01,
                      adam_w_mode=True, bias_correction=True, grad_scale=1.0,
                      device=dev)
    nel = p.numel()
    views = [unflatten_tensors(t, spec) for t in (p, g, m, vv2)]
    _entry(res, "gpt_flat_adam",
           time_ms(lambda: mta.flat_adam_kernel(g, p, m, vv2, hp, None,
                                                None), reps=5, inner=3),
           time_ms(lambda: mta.flat_adam_plain(g, p, m, vv2, hp, None, None),
                   reps=5, inner=3),
           time_ms(_fused_adamw(views[:2], views[2], views[3], dev), reps=5,
                   inner=3),
           nel * (4 * 4 + 4 * 3), 16 * nel, FP32_FLOPS,
           f"flat_adam GPT-medium's ({spec.total_rows}, 128) fp32, "
           f"{nel} parameters", "torch._fused_adamw_ over the tree's tensors")
    del p, g, m, vv2, views
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# 9. paged serving: the page pool, prefix sharing, preemption, int8 pages
# ---------------------------------------------------------------------------

PAGE = 64
PAGED_POOL = 2 + NUM_SLOTS * 16          # every slot can hold max_len rows
PAGED_TIGHT_POOL = 2 + 40
PREFIX_LEN, SUFFIX_LENS = 512, (64, 448)
# the JAX package's int8-pool envelope, 0.02 absolute on gpt_tiny whose
# teacher-forced logits reach 0.664 (tests/L0/run_serving/test_quant.py:44
# and its gate's fp32 golden): held as a share of the largest |logit|
KV8_REL = 0.02 / 0.664


def _paged_inputs(gen, dev, lengths, page, max_pages, kv, qdt, nh=16,
                  hd=64, contiguous=True):
    """One layer's paged attention operands at GPT-medium's heads: q
    (b, nh, hd), pools holding each slot's pages (a contiguous run a
    slot, or a random placement), the block tables (NULL past a slot's
    run) and ``pos = lengths`` (int32); int8 pools with fp32 scales."""
    from apex_tpu_torch.serving.cache import NULL_PAGE, RESERVED_PAGES

    b = len(lengths)
    s_len = page * max_pages
    runs = [min(-(-(int(n) + 1) // page), max_pages) for n in lengths]
    num_pages = RESERVED_PAGES + sum(runs)
    order = torch.arange(RESERVED_PAGES, num_pages) if contiguous else \
        RESERVED_PAGES + torch.randperm(num_pages - RESERVED_PAGES,
                                        generator=torch.Generator()
                                        .manual_seed(len(lengths)))
    rows, nxt = [], 0
    for n in runs:
        rows.append(order[nxt:nxt + n].tolist() + [NULL_PAGE] * (
            max_pages - n))
        nxt += n
    bt = torch.tensor(rows, dtype=torch.int32, device=dev)
    pos = torch.tensor([min(int(n), s_len) for n in lengths],
                       dtype=torch.int32, device=dev)
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}
    q = _rand(gen, (b, nh, hd), dt[qdt], dev)
    shape = (num_pages, nh, page, hd)
    if kv == "i8":
        k, v = (torch.randint(-127, 128, shape, generator=gen, device=dev,
                              dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((num_pages, nh), generator=gen, device=dev)
                  * 0.02 for _ in range(2))
    else:
        k, v = (_rand(gen, shape, dt[kv], dev) for _ in range(2))
        ks = vs = None
    return q, k, v, bt, pos, ks, vs


def serving_paged_lengths():
    """``serving_paged``'s 8 slots of a kernel timing: 64 to 992 rows,
    evenly spread (the mix's prompts, 64-960 tokens, mid-decode)."""
    return [64 + round(i * 928 / 7) for i in range(8)]


PAGED_DESIGN = (
    "redesigned: each slot's rows cut into parts of 128 logical positions, "
    "one 128-thread block a (part, head, slot), the part's K and V rows "
    "copied in the pool's own type by cp.async through the block table "
    "and converted in registers, scores "
    "a thread a row and P V 8 lanes an item, each for up to four queries "
    "at once, the part's softmax a warp a query; the parts' (m, l, acc) "
    "combined in part order by the last part to arrive (an integer "
    "counter it resets; no float atomics), one part written directly")


def paged_blocks(pos, k1, s_len, nh):
    """(working, grid): the decode and verify kernel's blocks that read
    a part of rows, and its grid, for slots at ``pos`` (a list) with k1
    queries (linear) over tables of ``s_len`` rows: a (part, head, slot)
    block a part of ``paged_attention.PART_ROWS`` positions up to
    ``pos + k1``; the grid holds every part of the table."""
    pa = kernel_modules()[7]
    working = nh * sum(pa.paged_parts(min(int(p) + k1, s_len)) for p in pos)
    return working, nh * len(pos) * pa.paged_parts(s_len)


def ab_lengths(slots=32, s_max=512):
    """The JAX package's paged-vs-dense A/B ladder (bench.py:1357-1359):
    ``s_max // 16`` to ``s_max``, evenly spread over the slots."""
    lo = s_max // 16
    return [lo + round(i * (s_max - lo) / (slots - 1)) for i in range(slots)]


def paged_parity(dev):
    """The paged decode attention kernel against its plain version, per
    element to ``paged_limit``, in bf16, fp32 and int8 pools at page 16
    and 64, with pos at 0, at a page's last row and at the next page's
    first row among ragged lengths; two launches the same bits; the same
    logical rows under two page placements the same bits."""
    pa = kernel_modules()[7]
    phase("kernel parity: paged decode attention (per element to "
          "paged_attention.paged_limit; bf16, fp32 and int8 pools at page "
          "16 and 64; two page placements give the same bits)")
    gen = torch.Generator(device=dev).manual_seed(14)
    max_err = 0.0
    for page in (16, 64):
        lengths = [0, page - 1, page, 2 * page - 1, 1023, 300, 517, 64]
        for qdt, kv in (("bf16", "bf16"), ("f32", "f32"), ("bf16", "i8"),
                        ("f32", "i8")):
            args = _paged_inputs(gen, dev, lengths, page, 1024 // page, kv,
                                 qdt, contiguous=False)
            got = pa.paged_decode_attention_kernel(*args)
            want = pa.paged_decode_attention_plain(*args)
            again = pa.paged_decode_attention_kernel(*args)
            lim = pa.paged_limit(*args[:5], want, *args[5:])
            err = (got.float() - want.float()).abs()
            share = float(torch.where(lim > 0, err / lim, err).max())
            max_err = max(max_err, float(err.max()))
            check(bool((err <= lim).all()) and torch.equal(got, again),
                  f"paged attention page {page}, q {qdt}, pool {kv}, pos "
                  f"{lengths}: max_abs_err {float(err.max()):.3g}, worst "
                  f"share of paged_limit {share:.3f}; a repeat the same "
                  "bits")
    for kv in ("bf16", "i8"):
        q, k, v, bt, pos, ks, vs = _paged_inputs(gen, dev, ab_lengths(),
                                                 PAGE, 8, kv, "bf16")
        base = pa.paged_decode_attention_kernel(q, k, v, bt, pos, ks, vs)
        # the same logical rows on other physical pages
        perm = torch.arange(k.shape[0], device=dev)
        perm[2:] = 2 + torch.randperm(k.shape[0] - 2, device=dev,
                                      generator=gen)
        moved = []
        for t in (k, v, ks, vs):
            m = None if t is None else torch.empty_like(t)
            if t is not None:
                m[perm] = t
            moved.append(m)
        got = pa.paged_decode_attention_kernel(
            q, moved[0], moved[1], perm[bt.long()].to(torch.int32), pos,
            moved[2], moved[3])
        check(torch.equal(got, base),
              f"placement ({kv} pool, 32 slots, lengths 32..512): the same "
              "logical rows on permuted physical pages give the same bits")
    return max_err


def paged_logits(params, cfg, dev, free_order, cache_dtype):
    """Two slots prefilled and decoded 4 teacher-forced steps on the
    paged engine: the logits, to compare placements bit for bit."""
    from apex_tpu_torch.serving import PagedDecodeEngine

    eng = PagedDecodeEngine(params, cfg, num_slots=NUM_SLOTS,
                            max_len=MAX_LEN, num_pages=PAGED_POOL,
                            page_size=PAGE, buckets=BUCKETS,
                            cache_dtype=cache_dtype, free_order=free_order,
                            device=dev)
    prompts = mix_prompts(cfg)[:2]
    rows = [eng.prefill(2, prompts[0]), eng.prefill(5, prompts[1])]
    toks = [0] * NUM_SLOTS
    act = [i in (2, 5) for i in range(NUM_SLOTS)]
    for t in range(4):
        check(eng.prepare_decode({2: len(prompts[0]) + t,
                                  5: len(prompts[1]) + t}) == [],
              "no preemption")
        toks[2], toks[5] = 11 + t, 13 + t
        rows.append(eng.decode(toks, act)[[2, 5]])
    return torch.cat(rows)


def _paged_launches(res, L, label):
    """Exact launches of a paged run: LN 2L + 1 a forward, flash L a
    prefill, the paged attention L a decode tick."""
    steps, prefills = res["decode_steps"], res["prefills"]
    check_launches(res["launches"], {
        "layer_norm_fwd": (2 * L + 1) * (prefills + steps),
        "flash_attention_fwd": L * prefills,
        "paged_decode_attention": L * steps}, label)


def _same_share(a, b):
    pairs = [(x, y) for s, t in zip(a, b) for x, y in zip(s, t)]
    return sum(x == y for x, y in pairs), len(pairs)


def serve_paged(dev, kern, dense_streams):
    """``serving_paged``: GPT-2 medium (the JAX ``gpt_medium``) on
    ``PagedDecodeEngine(8 slots, max_len 1024, 2 + 8 x 16 pages of 64)``:
    decode logits against the full forward (fp32 pool 1e-5, O2 bf16
    0.0625, the dense phase's limits); the 16 requests on the O2 params
    with exact launches; again with ``free_order`` reversed (the same
    streams, and teacher-forced logits the same bits). Returns the
    results and the fp32 and O2 params (the later paged phases reuse
    them)."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.gpt import gpt_medium, init_gpt
    from apex_tpu_torch.serving import PagedDecodeEngine

    phase(f"serving_paged: gpt_medium on PagedDecodeEngine({NUM_SLOTS} "
          f"slots, max_len {MAX_LEN}, {PAGED_POOL} pages of {PAGE}), the 16 "
          "requests, run twice (free_order reversed)")
    cfg = gpt_medium()
    L = cfg.num_layers
    kw = dict(engine=PagedDecodeEngine, num_pages=PAGED_POOL,
              page_size=PAGE)
    params = init_gpt(cfg, torch.Generator().manual_seed(0), device=dev)
    out = {}
    with torch.inference_mode():
        out["decode_err_fp32"] = decode_vs_full(
            params, cfg, dev, torch.float32, "paged, fp32 params and pool",
            1e-5, **kw)
        o2 = amp.initialize("O2", verbosity=0).cast_model(params)
        out["decode_err_bf16"] = decode_vs_full(
            o2, cfg, dev, torch.bfloat16, "paged, O2 bf16 params and pool",
            0.0625, **kw)
        usable = list(range(2, PAGED_POOL))
        runs = [serve_mix(dev, cfg, o2, kern, free_order=order, **kw)
                for order in (None, usable[::-1])]
        bits = [paged_logits(o2, cfg, dev, order, torch.bfloat16)
                for order in (None, usable[::-1])]
    pg = runs[0]
    _paged_launches(pg, L, "paged serving")
    check(runs[1]["streams"] == pg["streams"],
          "placement: the mix with free_order reversed commits the same "
          f"{N_REQUESTS} streams")
    check(torch.equal(bits[0], bits[1]),
          "placement: teacher-forced logits (2 slots, prefill + 4 decode "
          "steps) the same bits under free_order reversed")
    same, total = _same_share(pg["streams"], dense_streams)
    print(f"tokens equal to the dense serving phase's (for information): "
          f"{same} of {total}; smoke reading, not a benchmark: "
          f"{pg['tokens_per_s']:.1f} and {runs[1]['tokens_per_s']:.1f} "
          f"tokens/s; pages matched from the prefix cache "
          f"{pg['shared_pages']}", flush=True)
    del pg["streams"]
    out.update(pg, tokens_equal_to_dense=same, tokens_compared=total,
               reversed_tokens_per_s=runs[1]["tokens_per_s"])
    return out, params, o2


def prefix_prompts(cfg):
    """16 prompts: one of two shared 512-token prefixes (8 whole pages)
    plus a private suffix of 64-448 tokens."""
    rng = np.random.RandomState(7)
    prefixes = [tuple(int(t) for t in rng.randint(0, cfg.vocab_size,
                                                  size=PREFIX_LEN))
                for _ in range(2)]
    lens = rng.randint(SUFFIX_LENS[0], SUFFIX_LENS[1] + 1, size=N_REQUESTS)
    return [prefixes[i % 2] + tuple(int(t) for t in rng.randint(
        0, cfg.vocab_size, size=int(n))) for i, n in enumerate(lens)]


def serve_paged_prefix(dev, kern, o2):
    """``serving_paged_prefix``: the serving_paged engine on 16 prompts
    that share two 512-token prefixes: pages matched from the prefix
    cache, ``check_invariants()`` after every tick, exact launches; then
    a pool of 2 + 40 pages, where the engine must preempt and still
    finish every request."""
    from apex_tpu_torch.models.gpt import gpt_medium
    from apex_tpu_torch.serving import PagedDecodeEngine

    phase("serving_paged_prefix: the same engine, 16 prompts = one of two "
          f"shared {PREFIX_LEN}-token prefixes + a private suffix of "
          f"{SUFFIX_LENS[0]}-{SUFFIX_LENS[1]} tokens; then on "
          f"{PAGED_TIGHT_POOL} pages")
    cfg = gpt_medium()
    prompts = prefix_prompts(cfg)
    with torch.inference_mode():
        roomy = serve_mix(dev, cfg, o2, kern, engine=PagedDecodeEngine,
                          prompts=prompts, audit=True, num_pages=PAGED_POOL,
                          page_size=PAGE)
        _paged_launches(roomy, cfg.num_layers, "prefix-sharing serving")
        check(roomy["cached"] > 0 and roomy["shared_pages"] > 0,
              f"prefix sharing: {roomy['shared_pages']} pages matched from "
              f"the prefix cache at admission, {roomy['cached']} cached at "
              f"the end, {roomy['cow_copies']} copy-on-write clones")
        tight = serve_mix(dev, cfg, o2, kern, engine=PagedDecodeEngine,
                          prompts=prompts, audit=True,
                          num_pages=PAGED_TIGHT_POOL, page_size=PAGE)
    _paged_launches(tight, cfg.num_layers, "tight-pool serving")
    check(tight["preemptions"] > 0,
          f"tight pool: {tight['preemptions']} preemptions, "
          f"{tight['pool_exhausted']} admissions refused and retried, "
          f"every request finished")
    same, total = _same_share(tight["streams"], roomy["streams"])
    print(f"tight pool: tokens equal to the roomy pool's (for "
          f"information: a resumed request re-prefills its rows, so the "
          f"bits are not promised on the card) {same} of {total}",
          flush=True)
    for res in (roomy, tight):
        del res["streams"]
    return dict(roomy=roomy, tight=tight, tight_tokens_equal=same,
                tokens_compared=total)


def serve_paged_kv8(dev, kern, params, o2, paged_streams=None):
    """``serving_paged_kv8``: the serving_paged engine with an int8 pool:
    decode logits in fp32 compute against the full forward, held to
    ``KV8_REL`` of its largest |logit|; the 16 requests on the O2 params
    with exact launches."""
    from apex_tpu_torch.models.gpt import gpt_medium
    from apex_tpu_torch.serving import PagedDecodeEngine

    phase("serving_paged_kv8: the serving_paged engine with "
          "cache_dtype=torch.int8")
    cfg = gpt_medium()
    kw = dict(engine=PagedDecodeEngine, num_pages=PAGED_POOL,
              page_size=PAGE)
    with torch.inference_mode():
        err = decode_vs_full(params, cfg, dev, torch.int8,
                             f"int8 pool, fp32 params and compute; limit "
                             f"{KV8_REL:.4f} of max|logit|, the JAX "
                             "package's kv8 envelope", KV8_REL,
                             tol_rel=True, **kw)
        res = serve_mix(dev, cfg, o2, kern, cache_dtype=torch.int8, **kw)
    _paged_launches(res, cfg.num_layers, "int8-pool serving")
    del res["streams"]
    res["decode_err_fp32_compute"] = err
    return res


def paged_times(dev):
    """The paged decode attention at the JAX package's paged A/B
    configuration (RoPE GPT-2-medium heads, 32 slots, S_max 512, page 64,
    lengths 32..512; bf16 and int8 pools) and at ``serving_paged``'s (8
    slots, S_max 1024, lengths 64..992): kernel, plain version, bound
    (the live K/V rows plus q, ctx, tables and positions over 3.35 TB/s),
    and SDPA on the already-gathered (b, nh, S, hd) bf16 K and V with
    the ``s <= pos`` mask (a different function: it leaves out the
    gather)."""
    pa = kernel_modules()[7]
    phase("times of the paged decode attention (device ms a call, one "
          "layer; medians of CUDA-graph replays)")
    gen = torch.Generator(device=dev).manual_seed(16)
    res = {}
    cases = {"ab": (ab_lengths(), 8, "bf16"),
             "ab_kv8": (ab_lengths(), 8, "i8"),
             "serving_paged": (serving_paged_lengths(), 16, "bf16")}
    with torch.inference_mode():
        for key, (lengths, max_pages, kv) in cases.items():
            q, k, v, bt, pos, ks, vs = _paged_inputs(
                gen, dev, lengths, PAGE, max_pages, kv, "bf16")
            args = (q, k, v, bt, pos, ks, vs)
            t_k = time_ms(lambda: pa.paged_decode_attention_kernel(*args))
            t_p = time_ms(lambda: pa.paged_decode_attention_plain(*args))
            s_len = PAGE * max_pages
            live = sum(min(int(p) + 1, s_len) for p in pos.tolist())
            b, nh, hd = q.shape
            esz = k.element_size()
            nbytes = (2 * live * nh * hd * esz + 2 * b * nh * hd * 2
                      + bt.numel() * 4 + b * 4)
            if ks is not None:        # a K and a V scale a live page
                nbytes += 2 * nh * 4 * sum(
                    -(-min(int(p) + 1, s_len) // PAGE) for p in pos.tolist())
            flops = 4 * live * nh * hd
            t_l = None
            if ks is None:
                kg = k[bt.long()].transpose(1, 2).reshape(b, nh, s_len, hd)
                vg = v[bt.long()].transpose(1, 2).reshape(b, nh, s_len, hd)
                mask = (torch.arange(s_len, device=dev)[None, :]
                        <= pos[:, None].long())[:, None, None, :]
                q4 = q[:, :, None, :]
                t_l = time_ms(lambda: F.scaled_dot_product_attention(
                    q4, kg, vg, attn_mask=mask))
            _entry(res, f"paged_{key}", t_k, t_p, t_l, nbytes, flops,
                   FP32_FLOPS,
                   f"paged decode attention, {key} ({b} slots, S {s_len}, "
                   f"{kv} pool, {live} live rows)",
                   "SDPA on the gathered K/V (a different function)")
            res[f"paged_{key}"].update(live_rows=live, slots=b,
                                       per_tick_24_layers_ms=24 * t_k)
            working, grid = paged_blocks(pos.tolist(), 1, s_len, nh)
            print(f"  parts that read rows {working} of a grid of {grid} "
                  f"(part, head, slot) blocks (derived from "
                  f"paged_parts and the lengths, not measured)", flush=True)
    return res


# ---------------------------------------------------------------------------
# 10. speculative decoding and the host spill tier
# ---------------------------------------------------------------------------

SPEC_K = 4
SPEC_TEMPS = [0.8 if i % 2 else 0.0 for i in range(N_REQUESTS)]
# the self-drafter's catch-up chunk; its dense cache holds max_len +
# chunk rows, which the learned position table (1024 rows) bounds: max
# len 1008 covers every history of the mix (a 960-token prompt, 32 new
# tokens and 4 drafts)
SPEC_DRAFT_CHUNK = 16
SPEC_DRAFT_MAX_LEN = MAX_LEN - SPEC_DRAFT_CHUNK
# the tiered mix: four 512-token prefixes cycling A B C D over two slots,
# fewer slots than prefixes, so each prefix goes cold between its
# requests; 2 + 40 pages spill and promote without preempting (a CPU
# rehearsal at 2-layer width with the same lengths, pages and vocabulary)
TIER_PREFIXES, TIER_SLOTS, TIER_POOL = 4, 2, 2 + 40
VERIFY_K1 = (1, 2, 5, 9)


def _anc(b, k1, gen_seed):
    """(b, k1, k1) bool visibility of random valid draft trees (forced
    chains and trees of random shape, packed by ``tree_arrays``)."""
    from apex_tpu_torch.serving.draft import tree_arrays

    rng = np.random.RandomState(gen_seed)
    forced, trees = [], []
    for _ in range(b):
        f = rng.randint(1, k1 + 1)
        forced.append([1] * f)
        n = k1 - f
        trees.append(([2] * n, [int(rng.randint(-1, i)) for i in range(n)])
                     if n else None)
    return torch.from_numpy(tree_arrays(forced, trees, k1)[2])


def _verify_inputs(gen, dev, lengths, page, max_pages, kv, qdt, k1, tree,
                   nh=16, hd=64, contiguous=False):
    """:func:`_paged_inputs` for k1 queries a slot: q (b, nh, k1, hd),
    each slot's pages holding its rows 0 .. pos + k1 - 1, ``anc`` random
    trees or None (the linear mask)."""
    q, k, v, bt, pos, ks, vs = _paged_inputs(
        gen, dev, [n + k1 - 1 for n in lengths], page, max_pages, kv, qdt,
        nh, hd, contiguous)
    pos = pos - (k1 - 1)
    q = _rand(gen, (len(lengths), nh, k1, hd), q.dtype, dev)
    anc = _anc(len(lengths), k1, k1 + len(lengths)).to(dev) if tree \
        else None
    return q, k, v, bt, pos, anc, ks, vs


def paged_verify_parity(dev):
    """The multi-query paged attention against its plain version, per
    element to ``paged_limit`` (per query row): k1 1, 2, 5 and 9, linear
    and tree masks, fp32, bf16 and int8 pools, page 64 and 24, hd 64 and
    48; a repeat the same bits; two page placements the same bits; and
    column j of a linear verify the decode kernel's bits at pos + j."""
    pa = kernel_modules()[7]
    phase("kernel parity: multi-query paged attention (per element to "
          "paged_attention.paged_limit per query row; k1 1, 2, 5, 9; linear "
          "and tree masks; fp32, bf16 and int8 pools; page 64 and 24; hd 64 "
          "and 48; placements and decode columns bit for bit)")
    gen = torch.Generator(device=dev).manual_seed(15)
    max_err, worst = 0.0, 0.0
    for page, hd in ((64, 64), (24, 48)):
        mp = 1024 // page
        lengths = [0, page - 1, page, 2 * page - 1, mp * page - 9, 300, 517,
                   64]
        for qdt, kv in (("bf16", "bf16"), ("f32", "f32"), ("bf16", "i8")):
            for k1 in VERIFY_K1:
                for tree in (False, True):
                    args = _verify_inputs(gen, dev, lengths, page, mp, kv,
                                          qdt, k1, tree, hd=hd)
                    got = pa.paged_verify_attention_kernel(*args)
                    want = pa.paged_verify_attention_plain(*args)
                    again = pa.paged_verify_attention_kernel(*args)
                    q, k, v, bt, pos, anc, ks, vs = args
                    lim = pa.paged_limit(q, k, v, bt, pos, want, ks, vs,
                                         anc=anc)
                    err = (got.float() - want.float()).abs()
                    share = float(torch.where(lim > 0, err / lim, err).max())
                    max_err = max(max_err, float(err.max()))
                    worst = max(worst, share)
                    check(bool((err <= lim).all()) and torch.equal(got, again),
                          f"multi-query paged attention page {page}, hd {hd}, "
                          f"q {qdt}, pool {kv}, k1 {k1}, "
                          f"{'tree' if tree else 'linear'}: max_abs_err "
                          f"{float(err.max()):.3g}, worst share of "
                          f"paged_limit {share:.3f}; a repeat the same bits")
                    if tree:
                        continue
                    cols = all(torch.equal(
                        got[:, :, j], pa.paged_decode_attention_kernel(
                            q[:, :, j].contiguous(), k, v, bt, pos + j, ks,
                            vs)) for j in range(k1))
                    check(cols, f"k1 {k1}, {kv} pool, page {page}, hd {hd}: "
                          "column j of the linear verify is the decode "
                          "kernel's bits at pos + j")
    for kv in ("bf16", "i8"):
        q, k, v, bt, pos, anc, ks, vs = _verify_inputs(
            gen, dev, ab_lengths(), PAGE, 8, kv, "bf16", 5, True)
        base = pa.paged_verify_attention_kernel(q, k, v, bt, pos, anc, ks, vs)
        perm = torch.arange(k.shape[0], device=dev)
        perm[2:] = 2 + torch.randperm(k.shape[0] - 2, device=dev,
                                      generator=gen)
        moved = []
        for t in (k, v, ks, vs):
            m = None if t is None else torch.empty_like(t)
            if t is not None:
                m[perm] = t
            moved.append(m)
        got = pa.paged_verify_attention_kernel(
            q, moved[0], moved[1], perm[bt.long()].to(torch.int32), pos, anc,
            moved[2], moved[3])
        check(torch.equal(got, base),
              f"placement ({kv} pool, 32 slots, k1 5, tree): the same "
              "logical rows on permuted physical pages give the same bits")
    big = _verify_inputs(gen, dev, [100, 200], PAGE, 8, "bf16", "bf16",
                         pa.MAX_K1 + 1, False)
    try:
        pa.paged_verify_attention_kernel(*big)
        refused = False
    except RuntimeError as e:
        refused = "CUDA error" in str(e)
    check(refused, f"k1 {pa.MAX_K1 + 1} refused by the C entry (k1 "
          f"{pa.MAX_K1} is the most it holds)")
    print(f"multi-query paged attention: worst share of paged_limit "
          f"{worst:.3f}", flush=True)
    return max_err


def spec_prompts(cfg):
    """The 16 prompts of the speculative mix: a random 8-32-token motif
    repeated to 64-960 tokens (the JAX spec setup's repetitive prompts,
    bench.py:1138-1141, at full width) — the n-gram drafter's home
    turf."""
    rng = np.random.RandomState(3)
    lens = rng.randint(64, 961, size=N_REQUESTS)
    out = []
    for n in lens:
        motif = rng.randint(0, cfg.vocab_size, size=rng.randint(8, 33))
        out.append(tuple(int(t) for t in np.resize(motif, int(n))))
    return out


def verify_vs_decode(params, cfg, dev, cache_dtype, label, tol):
    """One 100-token prompt on a speculating and a plain paged engine:
    the first verify step's row j (the pending token and 4 drafts) held
    against a teacher-forced plain decode at pos + j fed the same
    tokens."""
    from apex_tpu_torch.serving import PagedDecodeEngine

    kw = dict(num_slots=1, max_len=MAX_LEN, num_pages=PAGED_POOL,
              page_size=PAGE, cache_dtype=cache_dtype, buckets=BUCKETS,
              device=dev)
    spec = PagedDecodeEngine(params, cfg, spec_k=SPEC_K, **kw)
    plain = PagedDecodeEngine(params, cfg, **kw)
    prompt = list(spec_prompts(cfg)[0][:100])
    tok = int(plain.prefill(0, prompt)[0].argmax())
    spec.prefill(0, prompt)
    fed, rows = [], []
    for j in range(SPEC_K + 1):
        fed.append(tok)
        check(plain.prepare_decode({0: len(prompt) + j}) == [],
              "no preemption")
        logits = plain.decode([tok], [True])
        rows.append(logits[0])
        tok = int(logits[0].argmax())
    check(spec.prepare_decode({0: len(prompt)}, n_new=SPEC_K + 1) == [],
          "no preemption")
    got = spec.verify([fed])[0]
    err = float((got - torch.stack(rows)).abs().max())
    check(err <= tol, f"verify rows vs teacher-forced decode ({label}), "
          f"k1 {SPEC_K + 1}: max_abs_err {err:.4g} <= {tol}")
    return err


def _spec_launches(res, L, label, w8=False, slices=1):
    """Exact launches of a speculative run: LN 2L + 1 a forward (the
    target's prefills and ticks, and a model drafter's forwards); flash
    L a prefill; the paged decode attention L a plain tick, the
    multi-query one L a verify tick times its ``slices`` (one launch a
    slice of ``verify_slices`` past 64 queries); the w8 products 4L and
    1 a target forward; the bits kernel at most once a sampled prefill
    and a tick."""
    fwd = res["prefills"] + res["decode_steps"]
    want = {"layer_norm_fwd": (2 * L + 1) * (fwd + res.get("draft_forwards",
                                                           0)),
            "flash_attention_fwd": L * res["prefills"],
            "paged_decode_attention": L * res["plain_ticks"],
            "paged_verify_attention": L * slices * res["spec_ticks"]}
    if w8:
        want.update(w8_matmul=4 * L * fwd, w8_matmul_nk=fwd)
    bits = res["launches"]["threefry_bits"]
    sampled = sum(t > 0 for t in SPEC_TEMPS[:len(res["streams"])])
    check(0 < bits <= sampled + res["decode_steps"],
          f"{label}: threefry_bits launches {bits}, at most {sampled} "
          f"sampled prefills and one a tick ({res['decode_steps']} ticks)")
    want["threefry_bits"] = bits
    check_launches(res["launches"], want, label)


def _count_drafter(dm):
    """Count the drafter's forwards (its verify-shaped catch-up chunks
    and greedy decode steps): each launches the LN kernel 2L + 1
    times."""
    calls = [0]
    for name in ("_verify", "_decode"):
        fn = getattr(dm, name)

        def counted(*a, _fn=fn, **kw):
            calls[0] += 1
            return _fn(*a, **kw)

        setattr(dm, name, counted)
    return lambda eng: {"draft_forwards": lambda: calls[0]}


def serve_spec(dev, kern, params, o2):
    """``serving_spec``: the serving_paged engine with ``spec_k`` 4 on the
    motif mix (half greedy, half sampled at 0.8): verify rows against a
    teacher-forced decode (fp32 1e-5, O2 0.0625); the mix plain and with
    the n-gram drafter, the target as its own ``DraftModel``, tree
    speculation, the adaptive depth, an int8 pool, and on
    ``quantize_params`` (8 requests), each with exact launches
    (:func:`_spec_launches`) and the drafter's counters."""
    from apex_tpu_torch.models.gpt import gpt_medium
    from apex_tpu_torch.quant import quantize_params
    from apex_tpu_torch.serving import DraftModel, PagedDecodeEngine

    phase(f"serving_spec: gpt_medium on PagedDecodeEngine({NUM_SLOTS} slots, "
          f"max_len {MAX_LEN}, {PAGED_POOL} pages of {PAGE}, spec_k "
          f"{SPEC_K}), 16 motif prompts of 64-960 tokens, half sampled at "
          "0.8: plain, n-gram, model, tree, adaptive, int8 pool, w8; "
          f"n-gram at spec_k {SPEC_K_WIDE}")
    cfg = gpt_medium()
    L = cfg.num_layers
    prompts = spec_prompts(cfg)
    out = {}
    kw = dict(engine=PagedDecodeEngine, num_pages=PAGED_POOL,
              page_size=PAGE, prompts=prompts, temps=SPEC_TEMPS)
    with torch.inference_mode():
        out["verify_err_fp32"] = verify_vs_decode(
            params, cfg, dev, torch.float32, "fp32 params and pool", 1e-5)
        out["verify_err_bf16"] = verify_vs_decode(
            o2, cfg, dev, torch.bfloat16, "O2 bf16 params and pool", 0.0625)
        runs = {"plain": serve_mix(dev, cfg, o2, kern, **kw)}
        runs["ngram"] = serve_mix(dev, cfg, o2, kern, spec_k=SPEC_K, **kw)
        for name, extra in (("model", {}), ("tree", {"tree_spec": True})):
            dm = DraftModel(o2, cfg, NUM_SLOTS, SPEC_DRAFT_MAX_LEN,
                            chunk=SPEC_DRAFT_CHUNK, device=dev)
            runs[name] = serve_mix(dev, cfg, o2, kern, spec_k=SPEC_K,
                                   draft_model=dm, setup=_count_drafter(dm),
                                   **extra, **kw)
            del dm
        runs["adaptive"] = serve_mix(dev, cfg, o2, kern, spec_k=SPEC_K,
                                     adaptive_spec=True, **kw)
        runs["kv8"] = serve_mix(dev, cfg, o2, kern, spec_k=SPEC_K,
                                cache_dtype=torch.int8, **kw)
        # C4: a linear verify of k1 = 65, one launch a slice
        runs["ngram_k64"] = serve_mix(dev, cfg, o2, kern,
                                      spec_k=SPEC_K_WIDE, **kw)
        w8 = dict(kw, prompts=prompts[:8])
        runs["w8"] = serve_mix(dev, cfg, quantize_params(o2), kern,
                               spec_k=SPEC_K, compute_dtype=torch.bfloat16,
                               **w8)
    plain = runs["plain"]
    _spec_launches(plain, L, "serving_spec, spec_k 0")
    for name, res in runs.items():
        if name == "plain":
            continue
        _spec_launches(res, L, f"serving_spec ({name})", w8=name == "w8",
                       slices=len(kernel_modules()[7].verify_slices(
                           SPEC_K_WIDE + 1, cfg.head_dim))
                       if name == "ngram_k64" else 1)
        # the self-drafter proposes the target's own greedy tokens: its
        # runs must accept; the n-gram runs' acceptance is a reading
        check(res["spec_ticks"] > 0 and res["tokens_drafted"] > 0
              and (res["tokens_accepted"] > 0
                   or name not in ("model", "tree")),
              f"serving_spec ({name}): {res['spec_ticks']} verify ticks, "
              f"{res['plain_ticks']} plain, {res['tokens_accepted']} of "
              f"{res['tokens_drafted']} drafts accepted "
              f"({res['acceptance_rate']:.3f})")
        # (the w8 run's weights differ: its streams are no reference's)
        same, total = _same_share(res["streams"], plain["streams"]) \
            if name != "w8" else (None, None)
        res.update(tokens_equal_to_plain=same, tokens_compared=total,
                   speedup_tokens_per_s=res["tokens_per_s"]
                   / plain["tokens_per_s"])
        print(f"serving_spec ({name}): tokens equal to the spec_k=0 run's "
              f"{same} of {total} (the card's verify sums other rows than "
              f"a decode step: bf16 near-ties may flip); "
              f"{res['tokens_per_s']:.1f} tokens/s against "
              f"{plain['tokens_per_s']:.1f}, {res['ticks']} ticks against "
              f"{plain['ticks']}", flush=True)
    for res in runs.values():
        del res["streams"]
    out.update(runs)
    return out


def tier_prompts(cfg):
    """16 prompts: one of four 512-token prefixes (four tenants'
    templates, 8 whole pages), cycling A B C D, plus a private suffix of
    64-448 tokens."""
    rng = np.random.RandomState(7)
    prefixes = [tuple(int(t) for t in rng.randint(0, cfg.vocab_size,
                                                  size=PREFIX_LEN))
                for _ in range(TIER_PREFIXES)]
    lens = rng.randint(SUFFIX_LENS[0], SUFFIX_LENS[1] + 1, size=N_REQUESTS)
    return [prefixes[i % TIER_PREFIXES] + tuple(int(t) for t in rng.randint(
        0, cfg.vocab_size, size=int(n))) for i, n in enumerate(lens)]


def _promote_checker(eng):
    """Wrap the engine's batched promote insert: after it, the promoted
    pages must hold the tiles it was given (the verified spill records'
    payload, the int8 scale planes too) bit for bit."""
    insert, extract = eng._tier_insert, eng._tier_extract
    seen = [0, 0]

    def checked(cache, pages, *tiles):
        cache = insert(cache, pages, *tiles)
        back = extract(cache, pages)
        for t, b in zip(tiles, back):
            host = torch.from_numpy(np.ascontiguousarray(t))
            b = b.cpu()
            if b.dtype == torch.bfloat16:
                b = b.view(torch.int16)
            seen[1] += not torch.equal(host, b)
        seen[0] += len(pages)
        return cache

    eng._tier_insert = checked
    return {"promoted_pages_checked": lambda: seen[0],
            "promoted_pages_differing": lambda: seen[1]}


def serve_tiered(dev, kern, o2):
    """``serving_paged_tiered``: four 512-token prefixes cycling over two
    slots on 2 + 40 pages with ``host_tier=PrefixRegistry(1 << 30)``, O2
    bf16 compute: an int8 pool (monolithic prefill; every promoted page
    and scale plane the spilled bits; the streams equal the same pool's
    without a tier, the reference's spill-disabled engine) and a bf16
    pool (the promoted prefix skipped, the suffix prefilled as one
    chunk); the audit at the end of each run (a per-tick audit of the
    int8 run was cut for time, PERF.md §4), exact launches, spills and
    promotes > 0; a suffix prefill's attention launches the chunk kernel
    once a layer. The int8 mix on a roomy pool without a
    tier is read
    beside them: a decode write requantizes its whole page, stale rows
    of a recycled page included (the JAX package's ``_q8_page_insert``),
    so a tight pool's streams are not the roomy pool's bit for bit."""
    from apex_tpu_torch.models.gpt import gpt_medium
    from apex_tpu_torch.serving import PagedDecodeEngine, PrefixRegistry

    phase(f"serving_paged_tiered: {TIER_PREFIXES} shared {PREFIX_LEN}-token "
          f"prefixes cycling over {TIER_SLOTS} slots, {TIER_POOL} pages, "
          "host_tier=PrefixRegistry(1 << 30); int8 and bf16 pools, and the "
          "int8 mix without a tier on the same and on a roomy pool")
    cfg = gpt_medium()
    L = cfg.num_layers
    prompts = tier_prompts(cfg)
    kw = dict(engine=PagedDecodeEngine, page_size=PAGE, prompts=prompts,
              temps=SPEC_TEMPS, num_slots=TIER_SLOTS)
    out, engines = {}, {}
    with torch.inference_mode():
        ref = {name: serve_mix(dev, cfg, o2, kern, num_pages=pages,
                               cache_dtype=torch.int8, audit=True, **kw)
               for name, pages in (("roomy", PAGED_POOL),
                                   ("no_tier", TIER_POOL))}
        # each run audits once at its end: the audit recomputes every
        # host record's sha256, some 0.2 s a tick over the int8 pool's
        # records and 0.3 s over the bf16 pool's
        # (tests/test_torch_host_tier.py audits every tick on the CPU)
        for name, dt in (("int8", torch.int8), ("bf16", torch.bfloat16)):
            # suffix-only prefills (each one chunk kernel launch a layer)
            chunks = [0]

            def setup(eng, chunks=chunks, name=name):
                engines[name] = eng
                run = eng._chunk_prefill

                def counted(*a, **k):
                    chunks[0] += 1
                    return run(*a, **k)

                eng._chunk_prefill = counted
                return dict(_promote_checker(eng),
                            suffix_chunk_prefills=lambda: chunks[0])

            out[name] = serve_mix(dev, cfg, o2, kern, num_pages=TIER_POOL,
                                  cache_dtype=dt,
                                  host_tier=PrefixRegistry(1 << 30),
                                  setup=setup, **kw)
        for name in ("int8", "bf16"):
            check(engines[name].check_invariants(),
                  f"tiered {name} pool: the audit (pool, block tables, "
                  "every host record's checksum) true at the end of the run")
    for name, res in ref.items():
        steps, prefills = res["decode_steps"], res["prefills"]
        check_launches(res["launches"], {
            "layer_norm_fwd": (2 * L + 1) * (prefills + steps),
            "flash_attention_fwd": L * prefills,
            "paged_decode_attention": L * steps,
            "threefry_bits": res["launches"]["threefry_bits"]},
            f"tiered mix without a tier ({name} pool)")
    for name, res in out.items():
        steps, prefills = res["decode_steps"], res["prefills"]
        chunked = res["suffix_chunk_prefills"]
        check_launches(res["launches"], {
            "layer_norm_fwd": (2 * L + 1) * (prefills + steps),
            "flash_attention_fwd": L * (prefills - chunked),
            "paged_decode_attention": L * steps,
            "paged_chunk_attention": L * chunked,
            "threefry_bits": res["launches"]["threefry_bits"]},
            f"tiered serving ({name} pool)")
        check(res["host_spills"] > 0 and res["host_promotes"] > 0
              and res["promoted_pages_checked"] == res["host_promotes"]
              and res["promoted_pages_differing"] == 0,
              f"host tier ({name} pool): {res['host_spills']} spills "
              f"({res['host_spill_bytes']} bytes), {res['host_promotes']} "
              f"promotes charged {res['host_promote_ticks']} ticks, every "
              "promoted page the spilled bits"
              f"{' (scale planes too)' if name == 'int8' else ''}; "
              f"{chunked} suffix-only prefills")
        for rname, r in ref.items():
            same, total = _same_share(res["streams"], r["streams"])
            res[f"tokens_equal_to_{rname}"] = same
        print(f"tiered ({name} pool): {res['tokens_per_s']:.1f} tokens/s "
              f"against {ref['no_tier']['tokens_per_s']:.1f} without a tier "
              f"and {ref['roomy']['tokens_per_s']:.1f} on the roomy pool; "
              f"tokens equal to the int8 runs without a tier: "
              f"{res['tokens_equal_to_no_tier']} (same pool), "
              f"{res['tokens_equal_to_roomy']} (roomy) of {total}; clock "
              f"{res['clock']} ticks against {ref['no_tier']['clock']}",
              flush=True)
    check(out["int8"]["streams"] == ref["no_tier"]["streams"],
          "tiered int8 pool: the streams equal the same pool's without a "
          "tier (the spill-disabled engine)")
    out.update(ref)
    for res in out.values():
        del res["streams"]
    return out


def verify_times(dev):
    """The multi-query paged attention at k1 1 and 5 (linear mask) at
    ``serving_spec``'s shape (8 slots, S_max 1024, the motif mix's
    lengths) and at the JAX package's paged A/B configuration (32 slots,
    S_max 512): kernel, the decode kernel at the same lengths, plain
    version, bound (the live K/V rows once, plus q, ctx, tables and anc,
    over 3.35 TB/s, or 4 k1 operations a K/V element pair over the bf16
    tensor-core peak, the operands' type) and SDPA on the
    already-gathered K/V with the same per-query mask (a different
    function: it leaves out the gather)."""
    pa = kernel_modules()[7]
    phase("times of the multi-query paged attention (device ms a call, one "
          "layer; medians of CUDA-graph replays)")
    gen = torch.Generator(device=dev).manual_seed(17)
    res = {}
    from apex_tpu_torch.models.gpt import gpt_medium

    spec_lens = sorted(len(p) + NEW_TOKENS // 2 for p in
                       spec_prompts(gpt_medium())[:NUM_SLOTS])
    cases = {"serving_spec": (spec_lens, 16), "ab": (ab_lengths(), 8)}
    with torch.inference_mode():
        for key, (lengths, max_pages) in cases.items():
            for k1 in (1, 5):
                q, k, v, bt, pos, anc, ks, vs = _verify_inputs(
                    gen, dev, [min(n, PAGE * max_pages - k1)
                               for n in lengths], PAGE, max_pages, "bf16",
                    "bf16", k1, False, contiguous=True)
                args = (q, k, v, bt, pos, anc, ks, vs)
                t_k = time_ms(lambda: pa.paged_verify_attention_kernel(*args))
                t_p = time_ms(lambda: pa.paged_verify_attention_plain(*args))
                qd = q[:, :, 0].contiguous()
                t_d = time_ms(lambda: pa.paged_decode_attention_kernel(
                    qd, k, v, bt, pos, ks, vs))
                s_len = PAGE * max_pages
                b, nh, _, hd = q.shape
                live = sum(min(int(p) + k1, s_len) for p in pos.tolist())
                nbytes = (2 * live * nh * hd * k.element_size()
                          + 2 * b * nh * k1 * hd * 2 + bt.numel() * 4 + b * 4)
                flops = 4 * k1 * live * nh * hd
                kg = k[bt.long()].transpose(1, 2).reshape(b, nh, s_len, hd)
                vg = v[bt.long()].transpose(1, 2).reshape(b, nh, s_len, hd)
                vis = pa.visible(pos, k1, s_len)[:, None]
                t_l = time_ms(lambda: F.scaled_dot_product_attention(
                    q, kg, vg, attn_mask=vis))
                _entry(res, f"verify_{key}_k{k1}", t_k, t_p, t_l, nbytes,
                       flops, BF16_TC_FLOPS,
                       f"multi-query paged attention, {key} ({b} slots, S "
                       f"{s_len}, k1 {k1}, {live} live rows; the decode "
                       f"kernel {t_d:.5f})",
                       "SDPA on the gathered K/V (a different function)")
                res[f"verify_{key}_k{k1}"].update(
                    live_rows=live, slots=b, decode_kernel_ms=t_d,
                    per_tick_24_layers_ms=24 * t_k)
                working, grid = paged_blocks(pos.tolist(), k1, s_len, nh)
                print(f"  parts that read rows {working} of a grid of "
                      f"{grid} (part, head, slot) blocks (derived from "
                      f"paged_parts and the lengths, not measured)",
                      flush=True)
    return res


# ---------------------------------------------------------------------------
# 11. the verify attention past 64 queries, and data parallelism
# ---------------------------------------------------------------------------

VERIFY_WIDE_K1 = 80     # a verify window wider than one launch holds
SPEC_K_WIDE = 64        # the spec_k of serving_spec's wide run: k1 65
DDP_STEPS = 2
DDP_RANKS = 2


def verify_past_max_k1(dev):
    """``paged_verify_attention`` (the wrapper) at k1 = 80, GPT-2
    medium's heads: one launch a slice of ``verify_slices`` (two),
    against its plain version per element to ``paged_limit``, and bit
    for bit against launches of one query each: the decode kernel at
    pos + j (linear) or the window's slice (j, 1) (tree)."""
    pa = kernel_modules()[7]
    k1 = VERIFY_WIDE_K1
    phase(f"kernel parity: the verify attention at k1 {k1} (past MAX_K1 "
          f"{pa.MAX_K1}: one launch a slice, {pa.verify_slices(k1, 64)}), "
          "linear and tree, bf16 and int8 pools, against the plain version "
          "and one-query launches")
    gen = torch.Generator(device=dev).manual_seed(17)
    max_err = 0.0
    lengths = [0, 63, 64, 300, 517, 1024 - k1 - 1, 700, 5]
    for kv in ("bf16", "i8"):
        for tree in (False, True):
            args = _verify_inputs(gen, dev, lengths, PAGE, 1024 // PAGE, kv,
                                  "bf16", k1, tree)
            q, k, v, bt, pos, anc, ks, vs = args
            n0 = pa.PAGED_VERIFY.launches
            got = pa.paged_verify_attention(*args)
            torch.cuda.synchronize()
            launched = pa.PAGED_VERIFY.launches - n0
            want = pa.paged_verify_attention_plain(*args)
            lim = pa.paged_limit(q, k, v, bt, pos, want, ks, vs, anc=anc)
            err = (got.float() - want.float()).abs()
            max_err = max(max_err, float(err.max()))
            one = [pa.paged_verify_attention_kernel(
                q, k, v, bt, pos, anc, ks, vs, q0=j, nq=1)[:, :, j] if tree
                else pa.paged_decode_attention_kernel(
                    q[:, :, j].contiguous(), k, v, bt, pos + j, ks, vs)
                for j in range(k1)]
            same = all(torch.equal(got[:, :, j], one[j]) for j in range(k1))
            check(launched == len(pa.verify_slices(k1, 64))
                  and bool((err <= lim).all()) and same,
                  f"verify k1 {k1}, {kv} pool, "
                  f"{'tree' if tree else 'linear'}: {launched} launches; "
                  f"max_abs_err {float(err.max()):.3g} within paged_limit; "
                  f"every query the bits of its one-query launch "
                  f"({'the window slice' if tree else 'the decode kernel'})")
    return max_err


def ddp_world_one(dev, kern):
    """BERT-Large's ``flash_tree`` O2 step at the headline shape, plain and
    with ``DistributedDataParallel`` on an NCCL world of one
    (``initialize_model_parallel()``): two steps each from the same
    seed, the DDP run's master, m, v and losses equal to the plain run's
    bit for bit, its kernels' launches exactly the plain step's, and
    both step times (a smoke reading)."""
    import torch.distributed as dist

    from apex_tpu_torch.examples.bert.train import make_bert_train_step
    from apex_tpu_torch.parallel import DistributedDataParallel
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.utils.tree import tree_leaves

    cfg = _step_cfg("flash_tree")
    L = cfg.num_layers
    phase(f"data parallelism at world 1: BERT-Large ({L} layers) flash_tree "
          f"O2, batch {BIG_BATCH}, seq {SEQ}, {DDP_STEPS} steps plain and "
          "with DistributedDataParallel on an NCCL process group of one "
          "rank, bit for bit")
    ps.initialize_model_parallel()
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1
              and ps.get_data_parallel_world_size() == 1,
              "initialize_model_parallel() brought up an NCCL world of one")
        per_step = per_step_launches("flash_tree", L)
        runs = {}
        for name, ddp in (("plain", None), ("ddp", DistributedDataParallel())):
            step, make_state, (ids, mask) = make_bert_train_step(
                BIG_BATCH, SEQ, cfg, device=dev, ddp=ddp)
            state = list(make_state())
            torch.cuda.synchronize()
            for k in kern.values():
                k.launches = 0
            losses, times = [], []
            for _ in range(DDP_STEPS):
                t0 = time.perf_counter()
                *state, loss = step(*state, ids, mask)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append(loss)
            runs[name] = dict(state=state, losses=losses,
                              step_ms=[t * 1e3 for t in times],
                              launches={n: k.launches
                                        for n, k in kern.items()})
            del step
        plain, ddp = runs["plain"], runs["ddp"]
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves((plain["state"][0], plain["state"][1].m,
                         plain["state"][1].v, plain["losses"])),
            tree_leaves((ddp["state"][0], ddp["state"][1].m,
                         ddp["state"][1].v, ddp["losses"]))))
        check(same, f"DDP at world 1: master, m, v and the {DDP_STEPS} "
              "losses equal the plain step's bit for bit")
        check_launches(ddp["launches"], {n: DDP_STEPS * c for n, c in
                                         per_step.items()},
                       "DDP world-1 training")
        out = dict(losses=[float(l) for l in ddp["losses"]],
                   step_ms_plain=plain["step_ms"], step_ms_ddp=ddp["step_ms"],
                   launches=ddp["launches"])
        print(f"smoke reading, not a benchmark: step ms plain "
              f"{[round(t, 1) for t in plain['step_ms']]}, DDP world 1 "
              f"{[round(t, 1) for t in ddp['step_ms']]} (first step with "
              "the warm-up)", flush=True)
    finally:
        ps.destroy_model_parallel()
        dist.destroy_process_group()
    del runs, plain, ddp
    torch.cuda.empty_cache()
    return out


def _replica_digest(tree):
    """sha256 of every leaf's bytes, in the tree's order."""
    import hashlib

    from apex_tpu_torch.utils.tree import tree_leaves

    h = hashlib.sha256()
    for t in tree_leaves(tree):
        h.update(t.detach().cpu().contiguous().reshape(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _ddp_bert_rank(dev, rank):
    """One O2 DDP step of BERT-Large width at ``SMALL_LAYERS`` on this
    rank's half of the global batch; on rank 0 also the one-process step
    on the whole batch, and the differences ``train_small`` bounds."""
    from apex_tpu_torch.examples.bert.train import make_bert_train_step
    from apex_tpu_torch.parallel import DistributedDataParallel
    from apex_tpu_torch.utils.tree import tree_map

    cfg = _step_cfg("flash_tree", num_layers=SMALL_LAYERS)
    ddp = DistributedDataParallel()
    step, make_state, (ids, mask) = make_bert_train_step(
        SMALL_BATCH, SEQ, cfg, device=dev, ddp=ddp)
    state = list(make_state())
    _, _, grads, found, _ = step.grads(state[0], state[2], ids, mask)
    grads = ddp.allreduce_grads(grads)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new = step(*state, ids, mask)
    torch.cuda.synchronize()
    out = dict(step_ms=(time.perf_counter() - t0) * 1e3,
               rows=int(ids.shape[0]), found_inf=bool(found),
               digest=_replica_digest(new[0]))
    if rank == 0:
        ref, make_ref, (ids1, mask1) = make_bert_train_step(
            SMALL_BATCH, SEQ, cfg, device=dev)
        st1 = list(make_ref())
        _, _, g1, _, _ = ref.grads(st1[0], st1[2], ids1, mask1)
        *new1, loss1 = ref(*st1, ids1, mask1)
        master1, opt1, g1 = tree_map(lambda t: t.cpu(),
                                     (new1[0], new1[1], g1))
        out.update(loss=abs(float(new[-1]) - float(loss1)) / abs(float(loss1)),
                   grads=_relnorm(grads, g1), m=_relnorm(new[1].m, opt1.m),
                   v=_relnorm(new[1].v, opt1.v),
                   master=_maxabs(new[0], master1))
    return out


def _ddp_resnet_rank(dev, rank):
    """One fp32 step of ``convert_syncbn_model(apply_resnet)`` at
    ResNet-``RESNET_DEPTH`` on this rank's half of ``RESNET_SMALL``'s
    batch (all-reduced gradients, synced BatchNorm statistics); on rank
    0 also the one-process step on the whole batch and the float64 step
    on the CPU, each result's distance from the latter (relative norm,
    as ``resnet_small`` holds the card to it)."""
    import torch.distributed as dist

    from apex_tpu_torch.examples.imagenet.main_amp import synthetic_batch
    from apex_tpu_torch.models.resnet import (
        apply_resnet, cross_entropy_loss, init_resnet,
    )
    from apex_tpu_torch.parallel import (
        DistributedDataParallel, convert_syncbn_model,
    )
    from apex_tpu_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

    batch, size = RESNET_SMALL
    params, stats = init_resnet(torch.Generator(device=dev).manual_seed(0),
                                RESNET_DEPTH, RESNET_CLASSES, device=dev)
    images, labels = synthetic_batch(0, batch, size, RESNET_CLASSES, dev)
    ddp = DistributedDataParallel()
    params = ddp.broadcast_params(params)

    def grads_of(apply, p, st, x, y):
        flat, treedef = tree_flatten(p)
        flat = [t.detach().requires_grad_(True) for t in flat]
        logits, ns = apply(tree_unflatten(treedef, flat), st, x,
                           RESNET_DEPTH, train=True)
        loss = cross_entropy_loss(logits, y)
        g = torch.autograd.grad(loss, flat)
        return loss.detach(), tree_unflatten(treedef, list(g)), ns

    x, y = ddp.shard_batch((images, labels))
    loss, g, ns = grads_of(convert_syncbn_model(apply_resnet), params, stats,
                           x, y)
    g = ddp.allreduce_grads(g)
    loss_all = loss.clone()
    dist.all_reduce(loss_all)
    loss_all = loss_all / DDP_RANKS
    out = dict(rows=int(x.shape[0]), digest=_replica_digest((g, ns)))
    if rank == 0:
        l1, g1, ns1 = grads_of(apply_resnet, params, stats, images, labels)
        f64 = lambda t: tree_map(lambda a: a.detach().cpu().double(), t)  # noqa: E731
        l64, g64, ns64 = grads_of(apply_resnet, f64(params), f64(stats),
                                  images.cpu().double(), labels.cpu())
        for key, a, b, w in (("loss", {"l": loss_all}, {"l": l1},
                              {"l": l64}), ("grads", g, g1, g64),
                             ("stats", ns, ns1, ns64)):
            out[key] = dict(ddp_vs_f64=_rel_global(a, w),
                            one_vs_f64=_rel_global(b, w),
                            ddp_vs_one=_rel_global(a, b))
    return out


def _ddp_rank(rank, tmp, port, device):
    """A rank of :func:`ddp_two_ranks` on ``device``: the default process
    group started here from a launcher's environment on gloo (NCCL
    refuses two ranks on one card), then the mesh over it, the BERT and
    ResNet steps, results to ``tmp/rank<r>.json``; a barrier before the
    groups go."""
    import os

    import torch.distributed as dist

    from apex_tpu_torch.transformer import parallel_state as ps

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(DDP_RANKS),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method="env://")
    ps.initialize_model_parallel(device=dev)
    try:
        out = {"backend": dist.get_backend(),
               "bert": _ddp_bert_rank(dev, rank),
               "resnet": _ddp_resnet_rank(dev, rank)}
        with open(f"{tmp}/rank{rank}.json", "w") as f:
            json.dump(out, f)
        # no rank tears its groups down while a peer may still be in
        # its last collective
        dist.barrier()
    finally:
        ps.destroy_model_parallel()
        dist.destroy_process_group()


def ddp_two_ranks(dev):
    """Two processes on the card, each a rank of a gloo process group
    over CUDA tensors (the model and its kernels on the card, the
    all-reduce staged through the host): one DDP step of BERT-Large width
    at ``SMALL_LAYERS`` layers on the global batch split in two, against
    the one-process step on the whole batch to ``train_small``'s O2
    bounds; ``convert_syncbn_model(apply_resnet)`` at ResNet-
    ``RESNET_DEPTH`` (fp32) on two ranks, held to the float64 step as
    ``resnet_small`` holds the card: its distance at most
    ``RESNET_FACTOR["O0"]`` times the one-process card step's, plus
    64 u. The ranks' results equal bit for bit."""
    import socket
    import tempfile

    import torch.multiprocessing as mp

    batch, size = RESNET_SMALL
    phase(f"data parallelism on two gloo ranks on the card (host-staged "
          f"all-reduce): BERT-Large width, {SMALL_LAYERS} layers, O2, global "
          f"batch {SMALL_BATCH}, one DDP step against the one-process step; "
          f"SyncBatchNorm ResNet-{RESNET_DEPTH}, global batch {batch} at "
          f"{size} x {size}, fp32, against the one-process step and the "
          "float64 step")
    torch.cuda.empty_cache()
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.spawn(_ddp_rank, args=(tmp, port, str(dev)),
                       nprocs=DDP_RANKS, join=False)
        deadline = time.monotonic() + 600
        while not ctx.join(timeout=max(deadline - time.monotonic(), 1.0)):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.terminate()
                check(False, "the two ranks finished within 600 s")
        res = []
        for r in range(DDP_RANKS):
            with open(f"{tmp}/rank{r}.json") as f:
                res.append(json.load(f))
    bert = res[0]["bert"]
    lim = STEP_LIMITS["O2"]
    check(all(r["backend"] == "gloo" for r in res)
          and [r["bert"]["rows"] for r in res] == [SMALL_BATCH // 2] * 2
          and not any(r["bert"]["found_inf"] for r in res),
          "two gloo ranks, each on half the batch, found_inf False on both")
    check(res[0]["bert"]["digest"] == res[1]["bert"]["digest"],
          "BERT: the two ranks' new masters equal bit for bit")
    for key in ("loss", "grads", "m", "v", "master"):
        what = "max abs" if key == "master" else "relative"
        check(bert[key] <= lim[key], f"BERT DDP vs one process, {key} "
              f"({what}): {bert[key]:.3g} <= {lim[key]:g}")
    rn = res[0]["resnet"]
    check(res[0]["resnet"]["digest"] == res[1]["resnet"]["digest"],
          "ResNet: the two ranks' all-reduced gradients and synced "
          "statistics equal bit for bit")
    for key in ("loss", "grads", "stats"):
        d = rn[key]
        check(d["ddp_vs_f64"] <= RESNET_FACTOR["O0"] * d["one_vs_f64"]
              + 64 * U32,
              f"ResNet SyncBN {key}: two ranks {d['ddp_vs_f64']:.3g} from the "
              f"float64 step (relative norm), one process "
              f"{d['one_vs_f64']:.3g}; two ranks vs one process "
              f"{d['ddp_vs_one']:.3g} (for information)")
    print(f"host-staged reading (gloo over the host, not a DDP speed): "
          f"BERT DDP step {[round(r['bert']['step_ms'], 1) for r in res]} ms "
          "on the two ranks", flush=True)
    return {"bert": bert, "bert_step_ms_host_staged":
            [r["bert"]["step_ms"] for r in res], "resnet": rn}



# ---------------------------------------------------------------------------
# 16. tensor parallelism
# ---------------------------------------------------------------------------

TP_RANKS = 2         # two gloo ranks on the one card
TP_STEPS = 2
# (b)'s steps on the gloo ranks by sequence_parallel: two with it off (a
# loss after the sharded update), one with it on (the card run's time)
TP_RANK_STEPS = {False: 2, True: 1}
TP_RANK_TIMEOUT_S = 600
TP_WIDTHS = (1024, 4096, 50304)   # the layers' h, ffn and vocab (GPT-medium)


def gpt_tp_per_step_launches(L, remat, dropout, flat):
    """Exact launches of each kernel in one tensor-parallel GPT step on
    each rank (``examples/gpt/train.py``'s ``GPTTPTrainStep``): the
    unsharded step's LayerNorm, flash and dropout launches
    (:func:`gpt_per_step_launches`) over the rank's local heads and
    tokens, and no cross-entropy launch: the vocab-parallel loss is plain
    ops, as in the JAX package."""
    out = gpt_per_step_launches(L, remat, dropout, flat)
    out.update(xentropy_fwd=0, xentropy_bwd=0)
    return out


def _checksum(tree):
    """A float64 sum of every leaf, where they lie (a cheap fingerprint
    of a params tree, to see that two processes drew the same
    weights)."""
    from apex_tpu_torch.utils.tree import tree_leaves

    return float(sum(t.detach().double().sum() for t in tree_leaves(tree)))


def _tp_steps(dev, kern, sequence_parallel=False, steps=TP_STEPS):
    """``steps`` steps of ``make_gpt_tp_train_step`` (gradients, then
    the tree FusedAdam) from seed-0 weights on one fixed batch, counts
    set to 0 before and read after. Returns the run's record and the
    first step's gradients."""
    import dataclasses

    from apex_tpu_torch.examples.gpt.train import (
        make_gpt_tp_train_step, make_state, synthetic_batch,
    )
    from apex_tpu_torch.models.gpt import GPTModel, gpt_medium
    from apex_tpu_torch.transformer.tensor_parallel import mappings

    cfg = dataclasses.replace(gpt_medium(),
                              sequence_parallel=sequence_parallel)
    per_step = gpt_tp_per_step_launches(cfg.num_layers, cfg.remat, False,
                                        False)
    step = make_gpt_tp_train_step(GPTModel(cfg))
    params, opt_state = make_state(cfg, step.opt, 0, dev)
    ids = synthetic_batch(0, GPT_BATCH, GPT_SEQ, cfg.vocab_size, dev)
    rec = {"params_checksum": _checksum(params), "per_step": per_step}
    for k in kern.values():
        k.launches = 0
    mappings.staged_bytes = 0
    losses, times, exact, first = [], [], True, None
    for i in range(steps):
        before = {n: k.launches for n, k in kern.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = step.grads(params, ids, ids)
        params, opt_state = step.opt.step(grads, params, opt_state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        exact &= all(kern[n].launches - before[n] == per_step[n]
                     for n in kern)
        if i == 0:
            first = (ids, loss, grads)
        del grads
    launches = {n: k.launches for n, k in kern.items()}
    rec.update(losses=losses, step_ms=[t * 1e3 for t in times],
               launches=launches,
               exact=exact and launches == {n: steps * per_step[n]
                                            for n in kern},
               staged_bytes_per_step=mappings.staged_bytes / steps)
    return rec, first


def tp_one(dev, kern, tmp):
    """(a) ``GPTModel(gpt_medium())`` at tp 1 on an NCCL world of one:
    ``TP_STEPS`` steps, exact launches a step; the first
    step's loss and gradients held against ``gpt_loss_unsharded`` on the
    same params and batch to ``train_small``'s O2 bounds; the gradients
    saved to ``tmp`` for (b)."""
    import torch.distributed as dist

    from apex_tpu_torch.examples.gpt.train import (
        make_gpt_train_step, make_state,
    )
    from apex_tpu_torch.models.gpt import gpt_medium
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.utils.tree import tree_map

    cfg = gpt_medium()
    phase(f"tensor parallelism (a): GPTModel(gpt_medium()) at tp 1 on an "
          f"NCCL world of one ({cfg.num_layers} layers, remat {cfg.remat}), "
          f"batch {GPT_BATCH}, seq {GPT_SEQ}, bf16 compute over fp32 params, "
          f"{TP_STEPS} steps of the loss and gradients inside shard_map and "
          "the tree FusedAdam, against gpt_loss_unsharded")
    ps.initialize_model_parallel()
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1
              and ps.get_tensor_model_parallel_world_size() == 1,
              "initialize_model_parallel() brought up an NCCL world of one")
        rec, (ids, loss0, grads0) = _tp_steps(dev, kern)
    finally:
        ps.destroy_model_parallel()
        dist.destroy_process_group()
    per_step = rec["per_step"]
    check(rec["exact"], f"tp 1 launches a step exactly "
          f"{ {n: c for n, c in per_step.items() if c} } (every other "
          f"kernel 0; { {n: c for n, c in rec['launches'].items() if c} } "
          f"over {TP_STEPS} steps)")
    check(all(np.isfinite(rec["losses"])),
          f"tp 1 losses finite: {rec['losses']}")
    plain = make_gpt_train_step(cfg)
    params, _ = make_state(cfg, plain.opt, 0, dev)
    check(_checksum(params) == rec["params_checksum"],
          "the unsharded step's weights are the tensor-parallel run's")
    loss_u, grads_u = plain.grads(params, ids, ids)
    lim = STEP_LIMITS["O2"]
    rec["vs_unsharded"] = {
        "loss": abs(float(loss0) - float(loss_u)) / abs(float(loss_u)),
        "grads": _relnorm(grads0, grads_u)}
    for k, v in rec["vs_unsharded"].items():
        check(v <= lim[k], f"tp 1 vs gpt_loss_unsharded, {k} (relative): "
              f"{v:.3g} <= {lim[k]:g}")
    torch.save(tree_map(lambda t: t.cpu(), grads0), f"{tmp}/tp1_grads.pt")
    print(f"smoke reading, not a benchmark: tp 1 step wall ms "
          f"{[round(t, 1) for t in rec['step_ms']]} (the first with the "
          f"warm-up); losses {rec['losses']}; unsharded loss "
          f"{float(loss_u):.6f}", flush=True)
    del params, grads0, grads_u, plain
    torch.cuda.empty_cache()
    return rec


def _tp_layers(dev):
    """(c) on this rank: the tensor-parallel layers at GPT-medium's widths
    through shard_map on the step's tokens, the gathered results
    against the dense computation on the same device and both against
    float64 (rank 0 makes the comparisons; every rank returns checksums
    of its results)."""
    import torch.distributed as dist

    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.transformer import tensor_parallel as tp

    P = ps.PartitionSpec
    h, f, v = TP_WIDTHS
    b, s = GPT_BATCH, GPT_SEQ
    m = b * s
    rank = dist.get_rank()
    gen = torch.Generator(device=dev).manual_seed(7)

    def rnd(*size, scale=1.0):
        return torch.randn(size, generator=gen, device=dev) * scale

    def grads_of(fn, *args):
        """(fn(*args), its gradients under a fixed cotangent)."""
        xs = [a.detach().requires_grad_(True) for a in args]
        with torch.enable_grad():
            y = fn(*xs)
            cot = torch.ones_like(y) if y.dim() == 0 else torch.linspace(
                -1, 1, y.numel(), device=y.device).reshape(y.shape)
            gs = torch.autograd.grad(y, xs, cot)
        return (y.detach(),) + tuple(gs)

    def worst(tp_res, dense_res, ref):
        """(max |tp - f64|, max |dense fp32 - f64|, max |f64|)."""
        e_tp = e_d = scale = 0.0
        for a, d, r in zip(tp_res, dense_res, ref):
            r = r.double()
            e_tp = max(e_tp, float((a.double() - r).abs().max()))
            e_d = max(e_d, float((d.double() - r).abs().max()))
            scale = max(scale, float(r.abs().max()))
        return e_tp, e_d, scale

    out, sums = {}, {}
    for name, layer, x_spec, fan in (
            ("column_parallel_linear",
             tp.ColumnParallelLinear(h, f, gather_output=True,
                                     gradient_accumulation_fusion=True),
             P(), (h, f)),
            ("row_parallel_linear",
             tp.RowParallelLinear(f, h, input_is_parallel=True,
                                  gradient_accumulation_fusion=True),
             P(None, ps.TENSOR_AXIS), (f, h))):
        p = {"kernel": rnd(*fan, scale=fan[0] ** -0.5),
             "bias": rnd(fan[1], scale=0.1)}
        x = rnd(m, fan[0])

        def fn(p, x, layer=layer):
            y, dk, db, dx = grads_of(lambda k, bias, x: layer.apply(
                {"kernel": k, "bias": bias}, x), p["kernel"], p["bias"], x)
            return y, {"kernel": dk, "bias": db}, dx

        specs = layer.partition_specs()
        y, g, dx = ps.shard_map(fn, in_specs=(specs, x_spec),
                                out_specs=(P(), specs, x_spec))(p, x)
        res = (y, g["kernel"], g["bias"], dx)
        sums[name] = [float(t.double().sum()) for t in res]
        if rank == 0:
            def dense(dt):
                return grads_of(lambda k, bias, x: x @ k + bias,
                                p["kernel"].to(dt), p["bias"].to(dt),
                                x.to(dt))

            out[name] = worst(res, dense(torch.float32),
                              dense(torch.float64))
        del y, g, dx, res

    emb = tp.VocabParallelEmbedding(v, h)
    table = rnd(v, h, scale=0.02)
    ids = torch.randint(0, v, (b, s), generator=gen, device=dev)
    cot = rnd(b, s, h)

    def emb_fn(p, ids):
        t = p["embedding"].detach().requires_grad_(True)
        with torch.enable_grad():
            y = emb.apply({"embedding": t}, ids)
            (g,) = torch.autograd.grad(y, [t], cot)
        return y.detach(), {"embedding": g}

    y, g = ps.shard_map(emb_fn, in_specs=(emb.partition_specs(), P()),
                        out_specs=(P(), emb.partition_specs()))(
        {"embedding": table}, ids)
    sums["vocab_parallel_embedding"] = [float(y.double().sum()),
                                        float(g["embedding"].double().sum())]
    if rank == 0:
        flat_ids, flat_cot = ids.reshape(-1), cot.reshape(-1, h)
        g64 = torch.zeros((v, h), dtype=torch.float64, device=dev)
        g64.index_add_(0, flat_ids, flat_cot.double())
        g32 = torch.zeros((v, h), device=dev).index_add_(0, flat_ids,
                                                         flat_cot)
        out["vocab_parallel_embedding"] = dict(
            forward_bitwise=bool(torch.equal(y, F.embedding(ids, table))),
            table_grad=worst((g["embedding"],), (g32,), (g64,)))
    del y, g, table

    logits = rnd(m, v, scale=3.0)
    target = torch.randint(0, v, (m,), generator=gen, device=dev)

    def ce_fn(lg, t):
        return grads_of(lambda a: tp.vocab_parallel_cross_entropy(a, t)
                        .mean(), lg)

    loss, dlogits = ps.shard_map(
        ce_fn, in_specs=(P(None, ps.TENSOR_AXIS), P()),
        out_specs=(P(), P(None, ps.TENSOR_AXIS)))(logits, target)
    sums["vocab_parallel_cross_entropy"] = [float(loss),
                                            float(dlogits.double().sum())]
    if rank == 0:
        def dense_ce(dt):
            return grads_of(lambda a: F.cross_entropy(a, target),
                            logits.to(dt))

        out["vocab_parallel_cross_entropy"] = worst(
            (loss, dlogits), dense_ce(torch.float32), dense_ce(torch.float64))
    return out, sums


def _tp_rank(rank, tmp, port, device):
    """A rank of :func:`tp_two_ranks`: the default process group on gloo
    from a launcher's environment (NCCL refuses two ranks on one card),
    the mesh of ``TP_RANKS`` model ranks over it; (b) the GPT-medium
    steps with ``sequence_parallel`` off and on, then (c) the layers;
    results to ``tmp/tp_rank<r>.json``; a barrier before the groups
    go."""
    import datetime
    import os

    import torch.distributed as dist

    from apex_tpu_torch.transformer import parallel_state as ps

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(TP_RANKS),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", init_method="env://",
        timeout=datetime.timedelta(seconds=TP_RANK_TIMEOUT_S))
    ps.initialize_model_parallel(TP_RANKS, device=dev)
    try:
        kern = kernel_counters()
        out = {"backend": dist.get_backend(),
               "tp": ps.get_tensor_model_parallel_world_size()}
        want = torch.load(f"{tmp}/tp1_grads.pt", map_location=dev) \
            if rank == 0 else None
        for sp in (False, True):
            rec, (_, _, grads0) = _tp_steps(dev, kern, sp,
                                            TP_RANK_STEPS[sp])
            rec["losses"] = [x.hex() for x in rec["losses"]]
            if rank == 0:
                rec["grads_vs_tp1"] = _relnorm(grads0, want)
            out["sp" if sp else "no_sp"] = rec
            del grads0
        del want
        torch.cuda.empty_cache()
        out["layers"], out["layer_sums"] = _tp_layers(dev)
        with open(f"{tmp}/tp_rank{rank}.json", "w") as fh:
            json.dump(out, fh)
        dist.barrier()
    finally:
        ps.destroy_model_parallel()
        dist.destroy_process_group()


def tp_two_ranks(dev, one, tmp):
    """(b) and (c) on ``TP_RANKS`` spawned gloo ranks on the card (the
    model and its kernels on the card, every collective staged through
    the host by ``tensor_parallel.mappings.collective``): GPT-medium's
    tensor-parallel step with ``sequence_parallel`` off and on, exact
    launches on each rank, the ranks' losses bit for bit, every loss
    finite, the first step's gathered gradients (all-reduced under SP
    first) against (a)'s to ``train_small``'s O2 bound; then the layers
    at GPT-medium's widths against the dense computation."""
    import socket

    import torch.multiprocessing as mp

    h, f, v = TP_WIDTHS
    phase(f"tensor parallelism (b, c): two gloo ranks on the card "
          f"(host-staged collectives), GPTModel(gpt_medium()) at tp "
          f"{TP_RANKS}, sequence_parallel off ({TP_RANK_STEPS[False]} "
          f"steps) then on ({TP_RANK_STEPS[True]}) against (a)'s "
          "gradients; the Column / Row / VocabParallel "
          "layers "
          f"and the vocab-parallel cross entropy at h {h}, ffn {f}, vocab "
          f"{v} against the dense computation")
    torch.cuda.empty_cache()
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    ctx = mp.spawn(_tp_rank, args=(tmp, port, str(dev)), nprocs=TP_RANKS,
                   join=False)
    deadline = time.monotonic() + TP_RANK_TIMEOUT_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 1.0)):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.terminate()
            check(False, f"the two ranks finished within "
                  f"{TP_RANK_TIMEOUT_S} s")
    res = []
    for r in range(TP_RANKS):
        with open(f"{tmp}/tp_rank{r}.json") as fh:
            res.append(json.load(fh))
    check(all(r["backend"] == "gloo" and r["tp"] == TP_RANKS for r in res),
          f"{TP_RANKS} gloo ranks, a model axis of {TP_RANKS}")
    lim = STEP_LIMITS["O2"]
    out = {}
    for key in ("no_sp", "sp"):
        recs = [r[key] for r in res]
        check(all(r["params_checksum"] == one["params_checksum"]
                  for r in recs),
              f"{key}: both ranks drew (a)'s weights (checksum "
              f"{one['params_checksum']!r})")
        check(recs[0]["losses"] == recs[1]["losses"],
              f"{key}: the ranks' losses equal bit for bit")
        losses = [float.fromhex(x) for x in recs[0]["losses"]]
        check(all(np.isfinite(losses)), f"{key}: every loss finite "
              f"{losses}")
        check(all(r["exact"] for r in recs),
              f"{key}: launches a step on each rank exactly "
              f"{ {n: c for n, c in recs[0]['per_step'].items() if c} } "
              f"({[{n: c for n, c in r['launches'].items() if c}
                   for r in recs]} over {TP_RANK_STEPS[key == 'sp']} "
              "steps)")
        g = recs[0]["grads_vs_tp1"]
        check(g <= lim["grads"], f"{key}: the first step's gathered "
              f"gradients vs (a)'s (relative norm) {g:.3g} <= "
              f"{lim['grads']:g}")
        staged = [r["staged_bytes_per_step"] for r in recs]
        print(f"host-staged reading (gloo over the host, not a tensor-"
              f"parallel speed): {key} step wall ms "
              f"{[[round(t, 1) for t in r['step_ms']] for r in recs]} on "
              f"the two ranks; host-staged bytes a step "
              f"{[int(x) for x in staged]}", flush=True)
        out[key] = dict(losses=losses, step_ms=[r["step_ms"] for r in recs],
                        staged_bytes_per_step=staged, grads_vs_tp1=g,
                        launches=[r["launches"] for r in recs])
    layers = res[0]["layers"]
    check(res[0]["layer_sums"] == res[1]["layer_sums"],
          "the layers' gathered results the same on both ranks")
    for name in ("column_parallel_linear", "row_parallel_linear",
                 "vocab_parallel_cross_entropy"):
        e_tp, e_d, scale = layers[name]
        check(e_tp <= 2 * e_d + 4 * U32 * scale,
              f"{name}: tp {TP_RANKS} vs float64 {e_tp:.3g}, the dense fp32 "
              f"computation {e_d:.3g} (max |float64| {scale:.3g}; held to "
              "twice the dense error plus 4 u of that)")
    e = layers["vocab_parallel_embedding"]
    e_tp, e_d, scale = e["table_grad"]
    check(e["forward_bitwise"] and e_tp <= 2 * e_d + 4 * U32 * scale,
          f"vocab_parallel_embedding: forward equal to F.embedding bit for "
          f"bit; table gradient vs float64 {e_tp:.3g}, index_add_ fp32 "
          f"{e_d:.3g}")
    out["layers"] = layers
    return out


def tensor_parallelism(dev, kern):
    """Phase 16: (a) tp 1 on an NCCL world of one, (b) and (c) on two
    gloo ranks; the phase's seconds and the card's name and power
    limit."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        one = tp_one(dev, kern, tmp)
        two = tp_two_ranks(dev, one, tmp)
    secs = time.perf_counter() - t0
    print(f"tensor parallelism phase: {secs:.1f} s on {card_line()}",
          flush=True)
    return {"tp1": one, "tp2": two, "seconds": secs}


# ---------------------------------------------------------------------------
# 17. pipeline and context parallelism
# ---------------------------------------------------------------------------

PP_RANKS = 2          # two gloo ranks on the one card
PP_STEPS = 1          # cut from 2 when phase 20 came (PERF.md §4)
PP_RANK_TIMEOUT_S = 900
PP_LAYERS, PP_BATCH, PP_MICRO, PP_SEQ, PP_HIDDEN = 24, 8, 2, 1024, 1024
# pretrain_gpt.py's flags for GPT-medium's widths at seq 1024, global
# batch 8 in microbatches of 2 (M 4)
PP_ARGS = ["--num-layers", str(PP_LAYERS), "--hidden-size", str(PP_HIDDEN),
           "--num-attention-heads", "16", "--padded-vocab-size", "50304",
           "--seq-length", str(PP_SEQ), "--max-position-embeddings",
           str(PP_SEQ), "--global-batch-size", str(PP_BATCH),
           "--micro-batch-size", str(PP_MICRO), "--steps", str(PP_STEPS)]
PP_RUNS = {"pp2": (2, None), "pp2_vpp2": (2, 2)}   # name -> (pp, vpp)
CP_BATCH, CP_SEQ = 2, 2048
ZERO_LR = 1e-4
PP_MEASURED = ("layer_norm_fwd", "layer_norm_bwd", "flash_attention_fwd",
               "flash_attention_bwd_dq", "flash_attention_bwd_dkv")


def pipeline_per_step_launches(L, pp, d, M):
    """Exact launches of each kernel in one ``pretrain_gpt.py`` step on
    pipeline stage ``d`` of ``pp`` (``L / pp`` layers, M microbatches;
    pp 1 is the no-pipelining schedule): each microbatch's stage forward
    runs twice (the forward without a graph, then the recompute from the
    saved input in its backward; at pp 1 the checkpointed stage), 2
    LayerNorms and one flash forward a layer each time, then 2 LayerNorm
    backwards, one dq and one dk/dv a layer; the last stage adds the
    final LayerNorm forward and backward once a microbatch. The loss is
    the vocab-parallel cross entropy (plain ops) and the tree FusedAdam
    launches nothing."""
    per = L // pp
    last = M if d == pp - 1 else 0
    out = dict.fromkeys(KERNEL_NAMES, 0)
    out.update(layer_norm_fwd=4 * per * M + last,
               layer_norm_bwd=2 * per * M + last,
               flash_attention_fwd=2 * per * M,
               flash_attention_bwd_dq=per * M,
               flash_attention_bwd_dkv=per * M)
    return out


def pretrain_main_launches(L, pp, d, M, steps):
    """``pretrain_gpt.main``'s launches on stage ``d``: ``steps`` times
    :func:`pipeline_per_step_launches`, and the threefry bits of its
    draws, one launch a draw: the weights' (``init_gpt_from_key``: the
    word and position tables and 4 kernels a layer) and each step's
    batch (``randint``: two draws)."""
    out = {n: steps * c for n, c in
           pipeline_per_step_launches(L, pp, d, M).items()}
    out["threefry_bits"] = 2 + 4 * L + 2 * steps
    return out


def cp_per_step_launches(L, impl):
    """Exact launches in one loss-and-gradients of ``GPTModel(gpt_medium()
    )`` with ``context_parallel`` on each rank: the tensor-parallel
    step's (remat on, :func:`gpt_tp_per_step_launches`) over the rank's
    block of the sequence; Ulysses' flash calls run over the whole
    sequence on h/cp heads, and the ring launches no flash kernel (its
    block is plain PyTorch, as in the JAX package)."""
    out = gpt_tp_per_step_launches(L, True, False, False)
    if impl == "ring":
        out.update(flash_attention_fwd=0, flash_attention_bwd_dq=0,
                   flash_attention_bwd_dkv=0)
    return out


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _paths(tree, path=()):
    """{path: leaf} of a dict tree."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_paths(tree[k], path + (k,)))
        return out
    return {path: tree}


def _run_main(argv, kern):
    """``pretrain_gpt.main(argv)`` with every count set to 0 just before
    and read just after: (rc, printed text, launches, host-staged bytes,
    wall seconds)."""
    import contextlib
    import io

    from apex_tpu_torch.examples.gpt import pretrain_gpt
    from apex_tpu_torch.transformer.tensor_parallel import mappings

    buf = io.StringIO()
    for k in kern.values():
        k.launches = 0
    mappings.staged_bytes = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = pretrain_gpt.main(argv)
    secs = time.perf_counter() - t0
    return (rc, buf.getvalue(), {n: k.launches for n, k in kern.items()},
            mappings.staged_bytes, secs)


def _step0(argv, dev):
    """The script's step-0 loss and gradients (its ``Pretrain`` pieces on
    the mesh its flags give), the seconds of that one loss-and-gradients
    on the host's clock, and the ``Pretrain`` run."""
    from apex_tpu_torch.examples.gpt import pretrain_gpt
    from apex_tpu_torch.transformer.testing import arguments

    ns = pretrain_gpt.parse_args(argv)
    arguments.initialize_from_args(ns, device=dev)
    run = pretrain_gpt.Pretrain(ns, dev)
    batch = run.batch(0)
    _sync(dev)
    t0 = time.perf_counter()
    loss, grads = run.loss_and_grads(run.params, batch)
    _sync(dev)
    return float(loss), grads, time.perf_counter() - t0, run


def pp_world_one(dev, kern, tmp):
    """(b) ``pretrain_gpt.py`` at pp 1 on an NCCL world of one, the
    reference's path through the schedules (no pipelining): ``PP_STEPS``
    steps, exact launches a step; then the step-0 loss and gradients of
    the same pieces, saved to ``tmp`` as the unsharded reference of
    (a)."""
    import torch.distributed as dist

    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.utils.tree import tree_map

    M = PP_BATCH // PP_MICRO
    phase(f"pipeline (b): pretrain_gpt.py at pp 1 on an NCCL world of one, "
          f"GPT-medium widths ({PP_LAYERS} layers, h 1024, 16 heads, vocab "
          f"50304), seq 1024, global batch {PP_BATCH} in {M} microbatches, "
          f"fp32, {PP_STEPS} steps")
    rc, text, launches, _, secs = _run_main(PP_ARGS, kern)
    print(text, end="", flush=True)
    losses = [float(ln.split()[3]) for ln in text.splitlines()
              if ln.startswith("step ")]
    check(rc == 0 and text.startswith("mesh: dp=1 tp=1 pp=1")
          and text.strip().endswith("DONE") and len(losses) == PP_STEPS
          and all(np.isfinite(losses)),
          f"pp 1: mesh dp=1 tp=1 pp=1, {len(losses)} finite losses, DONE")
    per = pipeline_per_step_launches(PP_LAYERS, 1, 0, M)
    want = pretrain_main_launches(PP_LAYERS, 1, 0, M, PP_STEPS)
    check(launches == want,
          f"pp 1: launches a step exactly "
          f"{ {n: c for n, c in per.items() if c} }, and "
          f"{want['threefry_bits']} threefry draws "
          f"({ {n: c for n, c in launches.items() if c} } over {PP_STEPS} "
          "steps)")
    try:
        loss0, grads, t_grads, _ = _step0(PP_ARGS, dev)
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              "the step-0 reference on an NCCL world of one")
        torch.save({"loss": loss0, "grads": tree_map(lambda t: t.cpu(),
                                                     grads)},
                   f"{tmp}/pp1_step0.pt")
    finally:
        ps.destroy_model_parallel()
        dist.destroy_process_group()
    check(abs(loss0 - losses[0]) <= 1e-6 * abs(losses[0]),
          f"the pieces' step-0 loss {loss0:.6f} is the script's "
          f"{losses[0]:.6f}")
    print(f"smoke reading, not a benchmark: pp 1 main() {secs:.1f} s for "
          f"{PP_STEPS} steps with set-up; one loss-and-gradients "
          f"{t_grads * 1e3:.1f} ms", flush=True)
    del grads
    torch.cuda.empty_cache()
    return {"losses": losses, "loss0": loss0, "launches": launches,
            "main_s": secs, "fwd_bwd_ms": t_grads * 1e3}


def _pp_grad_sums(grads, ref, pp, vpp, d, rank):
    """{leaf: [sum (got - want)^2, sum want^2]} of this stage's gradient
    blocks against the pp-1 reference's matching blocks (the embed and
    head leaves, whole on every stage, on rank 0 only)."""
    want = _paths(ref)
    out = {}
    for path, g in _paths(grads).items():
        w = want[path]
        if path[0] == "stages":
            w = w[0]                                   # (L, ...)
            rest = tuple(w.shape[1:])
            if vpp is None:
                w = w.reshape((pp, PP_LAYERS // pp) + rest)[d:d + 1]
            else:
                w = w.reshape((vpp, pp, PP_LAYERS // (pp * vpp))
                              + rest)[:, d:d + 1]
        elif rank != 0:
            continue
        w = w.to(g.device).double()
        out["/".join(path)] = [float(((g.double() - w) ** 2).sum()),
                               float((w ** 2).sum())]
    return out


def _pp_run(dev, kern, name, rank, ref):
    """(a) on this rank: ``pretrain_gpt.main`` at ``PP_RUNS[name]``; then
    the step-0 loss and gradients of the same pieces against the pp-1
    reference's."""
    from apex_tpu_torch.transformer import parallel_state as ps

    pp, vpp = PP_RUNS[name]
    argv = PP_ARGS + ["--pipeline-model-parallel-size", str(pp)]
    if vpp:
        argv += ["--virtual-pipeline-model-parallel-size", str(vpp)]
    rc, text, launches, staged, secs = _run_main(argv, kern)
    try:
        loss0, grads, t_grads, _ = _step0(argv, dev)
        d = ps.get_pipeline_model_parallel_rank()
        sums = _pp_grad_sums(grads, ref["grads"], pp, vpp, d, rank)
    finally:
        ps.destroy_model_parallel()
    del grads
    torch.cuda.empty_cache()
    return dict(rc=rc, text=text, launches=launches, stage=d,
                staged_bytes_per_step=staged / PP_STEPS, main_s=secs,
                loss0=loss0, fwd_bwd_ms=t_grads * 1e3, grad_sums=sums)


def _pp_memory(dev):
    """(c) on this rank: the peak device memory of one loss-and-gradients
    at pp 2, M 4 and M 8 (global batch 8 and 16, micro 2), and the
    activations one microbatch's stage forward keeps for its backward
    (the bound on the difference)."""
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.utils.tree import tree_map

    out = {}
    for M in (4, 8):
        argv = PP_ARGS + ["--pipeline-model-parallel-size", "2",
                          "--global-batch-size", str(M * PP_MICRO)]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            _, grads, _, run = _step0(argv, dev)
            out[f"peak_m{M}"] = torch.cuda.max_memory_allocated()
            del grads
            if M == 4:
                sp = tree_map(lambda a: a[0].detach().requires_grad_(True),
                              run.params["stages"])
                x = torch.zeros((PP_MICRO, PP_SEQ, PP_HIDDEN), device=dev,
                                requires_grad=True)
                _sync(dev)
                before = torch.cuda.memory_allocated()
                with torch.enable_grad():
                    y = run.pipe_model.stage_fn(sp, x)
                _sync(dev)
                out["stage_activations"] = \
                    torch.cuda.memory_allocated() - before
                del y, sp, x
        finally:
            ps.destroy_model_parallel()
        del run
    torch.cuda.empty_cache()
    return out


def _mean_over(tree, axis):
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.transformer.tensor_parallel.mappings import (
        collective,
    )
    from apex_tpu_torch.utils.tree import tree_map

    mesh = ps.get_mesh()
    n = mesh.shape[axis]
    return tree_map(lambda g: collective(
        "all_reduce", g, mesh.groups[axis], mesh.members(axis)) / n, tree)


def _cp_cfg(impl=None):
    import dataclasses

    from apex_tpu_torch.models.gpt import gpt_medium

    kw = dict(context_parallel=True, context_parallel_impl=impl) if impl \
        else {}
    return dataclasses.replace(gpt_medium(), use_rope=True, **kw)


def _cp_unsharded(dev):
    """(d)'s reference on rank 0: ``gpt_loss_unsharded`` and its
    gradients at seq ``CP_SEQ`` (RoPE, remat, bf16 compute over fp32
    params) on the run's weights and ids."""
    from apex_tpu_torch.examples.gpt.train import (
        synthetic_batch, value_and_grad,
    )
    from apex_tpu_torch.models.gpt import gpt_loss_unsharded, \
        init_gpt_from_key
    from apex_tpu_torch.utils import prng

    cfg = _cp_cfg()
    params = init_gpt_from_key(prng.PRNGKey(0), cfg, device=dev)
    ids = synthetic_batch(0, CP_BATCH, CP_SEQ, cfg.vocab_size, dev)
    loss, grads = value_and_grad(gpt_loss_unsharded)(
        params, cfg, ids, ids, compute_dtype=torch.bfloat16)
    return float(loss), grads


def _cp_run(dev, kern, impl, rank, ref):
    """(d) on this rank: ``GPTModel(gpt_medium())`` with
    ``context_parallel`` (``impl``) at cp ``PP_RANKS``, its loss and
    gradients (meaned over the context axis) inside shard_map on the ids
    split on s, counts set to 0 before and read after; rank 0 holds them
    to the unsharded ``ref``."""
    from apex_tpu_torch.examples.gpt.train import (
        synthetic_batch, value_and_grad,
    )
    from apex_tpu_torch.models.gpt import GPTModel, init_gpt_from_key
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.transformer.tensor_parallel import mappings
    from apex_tpu_torch.utils import prng

    P = ps.PartitionSpec
    cfg = _cp_cfg(impl)
    ps.initialize_model_parallel(context_parallel_size_=PP_RANKS,
                                 device=dev)
    try:
        model = GPTModel(cfg)
        params = init_gpt_from_key(prng.PRNGKey(0), cfg, device=dev)
        ids = synthetic_batch(0, CP_BATCH, CP_SEQ, cfg.vocab_size, dev)
        vg = value_and_grad(lambda p, i, lab: model.loss(
            p, i, lab, compute_dtype=torch.bfloat16))

        def run(p, i, lab):
            loss, grads = vg(p, i, lab)
            return loss, _mean_over(grads, ps.CONTEXT_AXIS)

        specs = model.partition_specs()
        seq = P(None, ps.CONTEXT_AXIS)
        for k in kern.values():
            k.launches = 0
        mappings.staged_bytes = 0
        _sync(dev)
        t0 = time.perf_counter()
        loss, grads = ps.shard_map(run, in_specs=(specs, seq, seq),
                                   out_specs=(P(), specs))(params, ids, ids)
        _sync(dev)
        secs = time.perf_counter() - t0
        launches = {n: k.launches for n, k in kern.items()}
        out = dict(loss=float(loss).hex(), launches=launches,
                   staged_bytes=mappings.staged_bytes, step_ms=secs * 1e3,
                   grads_checksum=_checksum(grads))
        if ref is not None:
            loss_u, grads_u = ref
            out["vs_unsharded"] = dict(
                loss=abs(float(loss) - loss_u) / abs(loss_u),
                grads=_relnorm(grads, grads_u))
    finally:
        ps.destroy_model_parallel()
    del grads, params
    torch.cuda.empty_cache()
    return out


def _zero_run(dev, rank, tmp):
    """(e) and (f) on this rank: a ``DistributedFusedAdam`` step at dp
    ``PP_RANKS`` on GPT-medium's params from the whole init (each rank's
    own seeded gradients), rank 0 holding the new params to
    ``FusedAdam`` on the ranks' mean gradient (the reference's 2e-5
    relative, 1e-6 absolute); the state's bytes a device at dp 2 and at
    dp 1. (f): a second step on the rank's rows held at rest
    (``in_specs`` and ``out_specs`` ``P()`` on the state), one
    ``save_sharded_checkpoint`` file a rank, and the third step
    uninterrupted and again from a fresh init loaded from the file: the
    params the same bits."""
    import os

    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
    from apex_tpu_torch.models.gpt import gpt_medium, init_gpt_from_key
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.transformer.tensor_parallel import mappings
    from apex_tpu_torch.utils import prng
    from apex_tpu_torch.utils.checkpoint import (
        load_sharded_checkpoint, save_sharded_checkpoint,
    )
    from apex_tpu_torch.utils.tree import tree_leaves, tree_map

    P = ps.PartitionSpec
    ps.initialize_model_parallel(device=dev)
    try:
        params = init_gpt_from_key(prng.PRNGKey(0), gpt_medium(), device=dev)

        def grads_of(r, k=0):
            gen = torch.Generator(device=dev).manual_seed(100 + r + 10 * k)
            return tree_map(lambda p: torch.randn(
                p.shape, generator=gen, device=dev) * 1e-3, params)

        opt = DistributedFusedAdam(lr=ZERO_LR, weight_decay=0.01)
        st = opt.init(params)
        sspec = opt.partition_spec()
        mappings.staged_bytes = 0
        _sync(dev)
        t0 = time.perf_counter()
        new_p, new_st = ps.shard_map(
            lambda g, p, s: opt.step(g, p, s),
            in_specs=(P(), P(), sspec), out_specs=(P(), P()))(
            grads_of(rank), params, st)
        _sync(dev)
        out = dict(step_ms=(time.perf_counter() - t0) * 1e3,
                   staged_bytes=mappings.staged_bytes,
                   rows=list(new_st.m.shape), full_rows=list(st.m.shape),
                   state_bytes_dp2=opt.state_bytes_per_device(params),
                   state_bytes_dp1=DistributedFusedAdam(
                       dp_size=1).state_bytes_per_device(params),
                   params_checksum=_checksum(new_p))
        del st
        if rank == 0:
            mean = tree_map(lambda a, b: (a + b) * 0.5, grads_of(0),
                            grads_of(1))
            ref = FusedAdam(lr=ZERO_LR, weight_decay=0.01)
            want, _ = ref.step(mean, params, ref.init(params))
            # the reference's allclose(rtol 2e-5, atol 1e-6) as one
            # number: the largest |got - want| - 2e-5 |want|
            out["excess"] = max(float(((g - w).abs() - 2e-5 * w.abs()).max())
                                for g, w in zip(tree_leaves(new_p),
                                                tree_leaves(want)))
            out["max_abs"] = max(float((g - w).abs().max()) for g, w in
                                 zip(tree_leaves(new_p), tree_leaves(want)))
            del mean, ref, want
        torch.cuda.empty_cache()

        def at_rest(p, s, g):
            return ps.shard_map(lambda g, p, s: opt.step(g, p, s),
                                in_specs=(P(), P(), P()),
                                out_specs=(P(), P()))(g, p, s)

        _sync(dev)
        t0 = time.perf_counter()
        p2, st2 = at_rest(new_p, new_st, grads_of(rank, 1))
        _sync(dev)
        out["rest_step_ms"] = (time.perf_counter() - t0) * 1e3
        out["held_rows"] = [list(new_st.m.shape), list(st2.m.shape)]
        del new_p, new_st
        path = os.path.join(tmp, f"zero_rank{rank}.ckpt")
        t0 = time.perf_counter()
        save_sharded_checkpoint(path, st2, specs=sspec)
        out["save_s"] = time.perf_counter() - t0
        out["ckpt_bytes"] = os.path.getsize(path)
        g3 = grads_of(rank, 2)
        want_p, _ = at_rest(p2, st2, g3)
        del st2
        torch.cuda.empty_cache()
        fresh = ps._map_specs(ps.shard_leaf, sspec, opt.init(params))
        t0 = time.perf_counter()
        loaded = load_sharded_checkpoint(path, fresh, specs=sspec)
        _sync(dev)
        out["load_s"] = time.perf_counter() - t0
        os.unlink(path)
        del fresh
        got_p, _ = at_rest(p2, loaded, g3)
        out["resumed_same"] = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(got_p), tree_leaves(want_p)))
        out["loaded_rows"] = list(loaded.m.shape)
        del loaded, got_p, want_p, p2, g3
    finally:
        ps.destroy_model_parallel()
    torch.cuda.empty_cache()
    return out


def _pp_rank(rank, tmp, port, device):
    """A rank of :func:`pp_cp_two_ranks`: the default process group on
    gloo from a launcher's environment (NCCL refuses two ranks on one
    card); (a) the two pipeline runs, (c) the memory, (d) ring and
    Ulysses, (e) ZeRO and (f) its sharded checkpoint, (g) the spatial
    bottleneck; results to ``tmp/pp_rank<r>.json``; a barrier before the
    groups go."""
    import datetime
    import os

    import torch.distributed as dist

    from apex_tpu_torch.transformer import parallel_state as ps

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(PP_RANKS),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", init_method="env://",
        timeout=datetime.timedelta(seconds=PP_RANK_TIMEOUT_S))
    try:
        kern = kernel_counters()
        out = {"backend": dist.get_backend()}
        ref = torch.load(f"{tmp}/pp1_step0.pt", mmap=True)
        for name in PP_RUNS:
            out[name] = _pp_run(dev, kern, name, rank, ref)
        del ref
        out["memory"] = _pp_memory(dev)
        unsharded = _cp_unsharded(dev) if rank == 0 else None
        for impl in ("ring", "ulysses"):
            out[f"cp_{impl}"] = _cp_run(dev, kern, impl, rank, unsharded)
        del unsharded
        torch.cuda.empty_cache()
        out["zero"] = _zero_run(dev, rank, tmp)
        t0 = time.perf_counter()
        out["bottleneck"] = _bottleneck_run(dev, rank)
        out["bottleneck"]["seconds"] = time.perf_counter() - t0
        with open(f"{tmp}/pp_rank{rank}.json", "w") as fh:
            json.dump(out, fh)
        dist.barrier()
    finally:
        ps.destroy_model_parallel()
        dist.destroy_process_group()


def pp_cp_two_ranks(dev, one, tmp):
    """(a), (c), (d) and (e) on ``PP_RANKS`` spawned gloo ranks on the
    card (the model and its kernels on the card, every exchange staged
    through the host)."""
    import socket

    import torch.multiprocessing as mp

    M = PP_BATCH // PP_MICRO
    lim = STEP_LIMITS["O2"]
    glim = GPT_STEP_LIMITS["O2"]
    phase(f"pipeline and context parallelism (a, c, d, e, f, g): two gloo "
          f"ranks "
          f"on the card (host-staged exchanges): pretrain_gpt.py at pp 2 "
          f"and at pp 2 with vpp 2 ({PP_STEPS} steps, M {M}), bounds: the "
          f"step-0 loss {lim['loss']:g} relative and gradients "
          f"{lim['grads']:g} in relative norm against (b); peak memory at M "
          f"4 and M 8 within one microbatch's stage activations; GPTModel "
          f"with context_parallel at cp 2, seq {CP_SEQ}, RoPE, bf16 compute, "
          f"ring and Ulysses, against gpt_loss_unsharded (loss "
          f"{glim['loss']:g}, gradients {glim['grads']:g}); "
          f"DistributedFusedAdam at dp 2 on GPT-medium's params against "
          "FusedAdam (2e-5 relative, 1e-6 absolute), (f) its sharded "
          "checkpoint and a resumed step bit for bit; (g) the spatial "
          f"bottleneck at cp 2 (rtol = atol {BN_FWD_TOL:g} forward, "
          f"{BN_DX_TOL:g} the gradient of x)")
    torch.cuda.empty_cache()
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    ctx = mp.spawn(_pp_rank, args=(tmp, port, str(dev)), nprocs=PP_RANKS,
                   join=False)
    deadline = time.monotonic() + PP_RANK_TIMEOUT_S
    while True:
        try:
            if ctx.join(timeout=max(deadline - time.monotonic(), 1.0)):
                break
        except mp.ProcessExitedException as e:
            check(False, f"pipeline ranks: rank {e.error_index} died "
                  f"({e.signal_name or f'exit code {e.exit_code}'})")
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.terminate()
            check(False, f"the two ranks finished within "
                  f"{PP_RANK_TIMEOUT_S} s")
    res = []
    for r in range(PP_RANKS):
        with open(f"{tmp}/pp_rank{r}.json") as fh:
            res.append(json.load(fh))
    check(all(r["backend"] == "gloo" for r in res), "two gloo ranks")
    out = {}
    for name, (pp, vpp) in PP_RUNS.items():
        recs = [r[name] for r in res]
        text = recs[0]["text"]
        losses = [float(ln.split()[3]) for ln in text.splitlines()
                  if ln.startswith("step ")]
        check(all(r["rc"] == 0 for r in recs)
              and text.startswith(f"mesh: dp=1 tp=1 pp={pp}")
              and text.strip().endswith("DONE") and recs[1]["text"] == ""
              and len(losses) == PP_STEPS and all(np.isfinite(losses)),
              f"{name}: main() on both ranks, mesh dp=1 tp=1 pp={pp}, "
              f"losses {losses}, DONE")
        for r in recs:
            per = pipeline_per_step_launches(PP_LAYERS, pp, r["stage"], M)
            want = pretrain_main_launches(PP_LAYERS, pp, r["stage"], M,
                                          PP_STEPS)
            check(r["launches"] == want,
                  f"{name}: stage {r['stage']} launches a step exactly "
                  f"{ {n: c for n, c in per.items() if c} }, and "
                  f"{want['threefry_bits']} threefry draws "
                  f"({ {n: c for n, c in r['launches'].items() if c} } "
                  f"over {PP_STEPS} steps)")
        d_loss = abs(losses[0] - one["losses"][0]) / abs(one["losses"][0])
        check(d_loss <= lim["loss"], f"{name}: printed step-0 loss "
              f"{losses[0]:.6f} vs pp 1's {one['losses'][0]:.6f}: "
              f"{d_loss:.3g} <= {lim['loss']:g} (relative)")
        check(recs[0]["loss0"] == recs[1]["loss0"],
              f"{name}: the ranks' step-0 losses equal bit for bit")
        sums = {}
        for r in recs:
            for k, (e, w) in r["grad_sums"].items():
                s = sums.setdefault(k, [0.0, 0.0])
                s[0] += e
                s[1] += w
        worst = max(math.sqrt(e / w) if w > 0 else math.sqrt(e)
                    for e, w in sums.values())
        check(worst <= lim["grads"], f"{name}: step-0 gradients vs pp 1's "
              f"(relative norm, worst leaf) {worst:.3g} <= "
              f"{lim['grads']:g}")
        staged = [r["staged_bytes_per_step"] for r in recs]
        print(f"host-staged reading (gloo over the host, not a pipeline "
              f"speed): {name} main() {[round(r['main_s'], 1) for r in recs]}"
              f" s for {PP_STEPS} steps with set-up, one loss-and-gradients "
              f"{[round(r['fwd_bwd_ms'], 1) for r in recs]} ms on the two "
              f"ranks; host-staged bytes a step {[int(x) for x in staged]}",
              flush=True)
        out[name] = dict(losses=losses, loss0_vs_pp1=d_loss,
                         grads_vs_pp1=worst, staged_bytes_per_step=staged,
                         main_s=[r["main_s"] for r in recs],
                         fwd_bwd_ms=[r["fwd_bwd_ms"] for r in recs],
                         launches=[r["launches"] for r in recs],
                         launches_per_step=[
                             {n: c // PP_STEPS for n, c in r["launches"].items()
                              if c and n in PP_MEASURED} for r in recs])
    mem = res[0]["memory"]
    grow = mem["peak_m8"] - mem["peak_m4"]
    check(grow <= mem["stage_activations"],
          f"memory: rank 0's peak at M 8 {mem['peak_m8']} B vs M 4 "
          f"{mem['peak_m4']} B: {grow} B <= one microbatch's stage "
          f"activations {mem['stage_activations']} B")
    out["memory"] = [r["memory"] for r in res]
    for impl in ("ring", "ulysses"):
        recs = [r[f"cp_{impl}"] for r in res]
        per = cp_per_step_launches(PP_LAYERS, impl)
        check(all(r["launches"] == per for r in recs),
              f"cp {impl}: launches on each rank exactly "
              f"{ {n: c for n, c in per.items() if c} } "
              f"({[{n: c for n, c in r['launches'].items() if c}
                   for r in recs]})")
        check(recs[0]["loss"] == recs[1]["loss"]
              and recs[0]["grads_checksum"] == recs[1]["grads_checksum"],
              f"cp {impl}: the ranks' loss and meaned gradients equal")
        vs = recs[0]["vs_unsharded"]
        check(vs["loss"] <= glim["loss"] and vs["grads"] <= glim["grads"],
              f"cp {impl} vs gpt_loss_unsharded at seq {CP_SEQ}: loss "
              f"{vs['loss']:.3g} <= {glim['loss']:g} (relative), gradients "
              f"{vs['grads']:.3g} <= {glim['grads']:g} (relative norm)")
        print(f"host-staged reading: cp {impl} loss-and-gradients "
              f"{[round(r['step_ms'], 1) for r in recs]} ms on the two "
              f"ranks; host-staged bytes {[r['staged_bytes'] for r in recs]}",
              flush=True)
        out[f"cp_{impl}"] = dict(
            vs_unsharded=vs, step_ms=[r["step_ms"] for r in recs],
            staged_bytes=[r["staged_bytes"] for r in recs],
            launches=[r["launches"] for r in recs],
            loss=float.fromhex(recs[0]["loss"]))
    z = [r["zero"] for r in res]
    check(z[0]["params_checksum"] == z[1]["params_checksum"],
          "ZeRO: the ranks' gathered params equal")
    check(z[0]["excess"] <= 1e-6, f"ZeRO step vs FusedAdam on the mean "
          f"gradient: max(|got - want| - 2e-5 |want|) {z[0]['excess']:.3g} "
          f"<= 1e-6 (max |got - want| {z[0]['max_abs']:.3g})")
    check(z[0]["state_bytes_dp2"] * PP_RANKS == z[0]["state_bytes_dp1"]
          and z[0]["rows"][0] * PP_RANKS == z[0]["full_rows"][0],
          f"ZeRO: state_bytes_per_device {z[0]['state_bytes_dp2']} at dp 2, "
          f"{z[0]['state_bytes_dp1']} at dp 1 (halved); this rank's rows "
          f"{z[0]['rows']} of {z[0]['full_rows']}")
    print(f"host-staged reading: ZeRO step {[round(r['step_ms'], 1) for r in z]}"
          f" ms on the two ranks, host-staged bytes "
          f"{[r['staged_bytes'] for r in z]}", flush=True)
    half = [z[0]["full_rows"][0] // PP_RANKS, z[0]["full_rows"][1]]
    check(all(r["held_rows"] == [half, half] and r["loaded_rows"] == half
              for r in z),
          f"ZeRO (f): each rank holds its {half} rows of m between steps "
          f"and loads {half} ({[r['held_rows'] for r in z]})")
    check(all(r["resumed_same"] for r in z),
          "ZeRO (f): the third step resumed from each rank's sharded file "
          "gives the uninterrupted step's params bit for bit")
    print(f"ZeRO sharded checkpoint: {[r['ckpt_bytes'] for r in z]} bytes a "
          f"rank's file (master, m and v fp32), written in "
          f"{[round(r['save_s'], 2) for r in z]} s, read in "
          f"{[round(r['load_s'], 2) for r in z]} s; a step on the rows at "
          f"rest {[round(r['rest_step_ms'], 1) for r in z]} ms", flush=True)
    out["zero"] = z
    b = [r["bottleneck"] for r in res]
    check(all(r["fwd_excess"] <= 0 and r["dx_excess"] <= 0 for r in b),
          f"spatial bottleneck (g) at cp {PP_RANKS} (batch {BN_BATCH}, "
          f"{BN_HW} x {BN_HW}, {BN_CH} channels, bottleneck {BN_MID}, fp32) "
          f"vs the unsharded block: forward max |diff| "
          f"{[r['fwd_max_abs'] for r in b]} within rtol = atol = "
          f"{BN_FWD_TOL:g}, the gradient of x {[r['dx_max_abs'] for r in b]} "
          f"within {BN_DX_TOL:g}")
    print(f"host-staged reading: the bottleneck's halos "
          f"{[r['halo_bytes_fwd'] for r in b]} bytes forward, "
          f"{[r['halo_bytes'] for r in b]} forward and backward a rank; "
          f"{[round(r['seconds'], 1) for r in b]} s with the unsharded "
          f"reference", flush=True)
    out["bottleneck"] = b
    return out


def pipeline_context_parallelism(dev, kern):
    """Phase 17: (b) pp 1 on an NCCL world of one, then (a), (c), (d) and
    (e) on two gloo ranks; the phase's seconds and the card's name and
    power limit."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        one = pp_world_one(dev, kern, tmp)
        two = pp_cp_two_ranks(dev, one, tmp)
    secs = time.perf_counter() - t0
    print(f"pipeline and context parallelism phase: {secs:.1f} s on "
          f"{card_line()}", flush=True)
    return {"pp1": one, **two, "seconds": secs}


def ulysses_times(dev):
    """The flash forward, dq and dk/dv at Ulysses' shape in
    ``pipeline_context_parallelism`` (the whole sequence on h/cp heads:
    b 2, h 8, s 2048, d 64, causal, bf16), as :func:`gpt_times` times
    them at the GPT step's."""
    phase("times of the flash kernels at the Ulysses shape (b 2, h 8, s "
          "2048, d 64, causal bf16; device ms per call, CUDA-graph replays)")
    res = {}
    _flash_times(res, "ulysses_flash", dev, CP_BATCH, 16 // PP_RANKS,
                 CP_SEQ, 64, "Ulysses' whole-sequence call")
    return res


# ---------------------------------------------------------------------------
# 18. tensor-parallel serving
# ---------------------------------------------------------------------------

TPS_PROMPTS = 8        # the serving mix's first 8 prompts, one a slot
TPS_TICKS = 32         # greedy decode ticks of the bf16 runs
TPS_W8_TICKS = 8       # decode ticks of the int8 run
TPS_SPEC_K = 4         # the verify tick's k1 is TPS_SPEC_K + 1
TPS_RANKS = 2          # two gloo ranks on the one card
TPS_RANK_TIMEOUT_S = 600
TPS_LIMIT = 0.0625     # the O2 logits limit (decode_vs_full's)
# the int8 tree's logits (fp32 activations): about six times the tp 2
# difference read on the H100 (8.4e-5), set before the seeded biases
TPS_W8_LIMIT = 5e-4
TPS_MEMORY_SHARE = 0.05
TPS_AFFINE_STD = 0.1   # the seeded biases and LayerNorm weights' spread
TPS_MODES = ("dense", "paged", "w8")
# row 21 (the int8 Row-parallel linear) at tp 2: (K, N) of out and fc2
TPS_ROW21 = {"out": (512, 1024), "fc2": (2048, 1024)}
TPS_RESHARD_PAGES = (2, 3, 4, 18, 19)


def tps_per_run_launches(L, prefills, ticks, mode, verify=0):
    """Exact launches of one tensor-parallel serving run on each rank:
    every prefill, decode tick and verify tick a forward of 2L + 1
    LayerNorms; the flash forward L a prefill; the paged decode kernel L
    a paged tick; the int8 tree's Column linears (row 22) and Row linears
    (row 21) 2L each a forward and its logits head (row 23) once."""
    fwd = prefills + ticks + verify
    out = {"layer_norm_fwd": (2 * L + 1) * fwd,
           "flash_attention_fwd": L * prefills}
    if mode == "paged":
        out["paged_decode_attention"] = L * ticks
    if mode == "w8":
        out.update(w8_matmul=2 * L * fwd, w8_matmul_nobias=2 * L * fwd,
                   w8_matmul_nk=fwd)
    return out


def _tps_row(slot, dev):
    """Slot ``slot``'s block-table row: its own 16 pages of the
    ``serving_paged`` pool (every row mapped up front, so no tick
    allocates)."""
    per = MAX_LEN // PAGE
    return torch.arange(2 + per * slot, 2 + per * (slot + 1),
                        dtype=torch.int32, device=dev)


def _tps_steps(mode, cfg, model=None):
    """(prefill, decode, verify) of the unsharded builders (model None)
    or of the tensor-parallel ones over ``model``."""
    from apex_tpu_torch.serving import decode as sd

    paged, w8 = mode == "paged", mode == "w8"
    pre = "paged_prefill" if paged else "prefill"
    dec = "paged_decode" if paged else "decode"
    if model is None:
        return tuple(getattr(sd, f"make_{n}_fn")(cfg, quantized=w8)
                     for n in (pre, dec, "verify"))
    return tuple(getattr(sd, f"make_tp_{n}_fn")(model, quantized=w8)
                 for n in (pre, dec, "verify"))


def _tps_cache(mode, cfg, dev):
    from apex_tpu_torch.serving import init_cache, init_paged_cache

    if mode == "paged":
        return init_paged_cache(cfg, TPS_PROMPTS, MAX_LEN, PAGED_POOL, PAGE,
                                torch.bfloat16, dev)
    return init_cache(cfg, TPS_PROMPTS, MAX_LEN, torch.bfloat16, dev)


def _tps_serve(dev, cfg, steps, params, cache, prompts, mode, feed=None,
               measure=False):
    """One side's run: each prompt prefilled into its slot (bucketed as
    the engines bucket), then the mode's decode ticks over every slot
    and, in the dense mode, one verify tick at k1 = ``TPS_SPEC_K`` + 1
    (the pending token and 4 drafts). ``feed``: the tokens each tick
    decodes (None: this side's own greedy tokens). Returns the cache, the
    logits (the prefills' (P, V), each tick's (P, V), the verify's (P,
    k1, V)), the tokens fed, the host-staged bytes over the decode ticks
    and, with ``measure``, the growth of the allocator's peak over tick
    1."""
    from apex_tpu_torch.transformer.tensor_parallel import mappings
    from apex_tpu_torch.utils.seqlen import pad_to_bucket

    prefill, decode, verify = steps
    first = []
    for s, prompt in enumerate(prompts):
        ids = torch.tensor([list(prompt)], dtype=torch.int64, device=dev)
        ids, mask = pad_to_bucket(ids, ids.shape[1], buckets=BUCKETS)
        if mode == "paged":
            row = _tps_row(s, dev)
            cache, lg = prefill(params, cache, ids, mask, s,
                                row[:ids.shape[1] // PAGE], row)
        else:
            cache, lg = prefill(params, cache, ids, mask, s)
        first.append(lg[0])
    logits = [torch.stack(first)]
    tok = logits[0].argmax(-1) if feed is None else feed[0]
    fed = [tok]
    active = torch.ones(len(prompts), dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    mappings.staged_bytes = 0
    growth = None
    ticks = TPS_W8_TICKS if mode == "w8" else TPS_TICKS
    for t in range(ticks):
        if measure and t == 1:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            m0 = torch.cuda.memory_allocated(dev)
        cache, lg = decode(params, cache, tok, active)
        if measure and t == 1:
            torch.cuda.synchronize()
            growth = torch.cuda.max_memory_allocated(dev) - m0
        logits.append(lg)
        tok = lg.argmax(-1) if feed is None else feed[t + 1]
        fed.append(tok)
    staged = mappings.staged_bytes
    if mode == "dense":
        drafts = (tok[:, None] + torch.arange(1, TPS_SPEC_K + 1,
                                              device=dev)) % cfg.vocab_size
        cache, lg = verify(params, cache, torch.cat([tok[:, None], drafts],
                                                    1))
        logits.append(lg)
    return cache, logits, fed, staged, growth


def _tps_compare(got, want):
    """(the largest |logit| difference over every row, the greedy tokens
    of ``got`` equal to ``want``'s, the tokens compared)."""
    err, same, n = 0.0, 0, 0
    for g, w in zip(got, want):
        w = w.to(g.device)
        err = max(err, float((g.float() - w.float()).abs().max()))
        eq = g.argmax(-1) == w.argmax(-1)
        same += int(eq.sum())
        n += eq.numel()
    return err, same, n


def _digest(tensors):
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _seed_affine(tree, gen, std, name=""):
    """``tree`` with every bias drawn from N(0, std) and every LayerNorm
    weight from 1 + N(0, std) (``init_gpt`` sets them to zeros and
    ones), so a Row linear's bias added on each rank, or a Column bias
    taken from another rank's block, shows in the logits."""
    if isinstance(tree, dict):
        return {k: _seed_affine(v, gen, std, k) for k, v in tree.items()}
    if name not in ("bias", "weight"):
        return tree
    noise = torch.randn(tree.shape, generator=gen) * std
    return noise.to(tree) + (1.0 if name == "weight" else 0.0)


def _tps_weights(dev):
    """GPT-2 medium's seed-0 weights, their biases and LayerNorm weights
    seeded (:func:`_seed_affine`), O2-cast."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.gpt import gpt_medium, init_gpt

    cfg = gpt_medium()
    gen = torch.Generator().manual_seed(0)
    params = _seed_affine(init_gpt(cfg, gen, device=dev), gen,
                          TPS_AFFINE_STD)
    o2 = amp.initialize("O2", verbosity=0).cast_model(params)
    del params
    torch.cuda.empty_cache()
    return cfg, o2


def _tps_limit(mode):
    return TPS_W8_LIMIT if mode == "w8" else TPS_LIMIT


def _tree_bytes(tree):
    from apex_tpu_torch.utils.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _tps_check_growth(what, growth, ref_growth, weight_bytes):
    """A decode tick's growth of the allocator's peak no larger than the
    unsharded step's on the same tick plus ``TPS_MEMORY_SHARE`` of the
    rank's weight bytes: no call copies the weights or the cache. The
    raw share (growth over weight bytes) is printed beside it."""
    check(growth <= ref_growth + TPS_MEMORY_SHARE * weight_bytes,
          f"{what}: a decode tick grows the allocator's peak by {growth} "
          f"bytes ({growth / weight_bytes:.4f} of the rank's "
          f"{weight_bytes} weight bytes); the unsharded step's same tick "
          f"{ref_growth} bytes; within it plus {TPS_MEMORY_SHARE} of the "
          "weight bytes (no call copies the weights or the cache)")


def tps_one(dev, kern, tmp):
    """(a) The tensor-parallel builders at tp 1 on an NCCL world of one
    against the unsharded builders, each mode's runs side by side on the
    same prompts: the unsharded side greedy, the tensor-parallel side fed
    the same tokens; every row of logits within ``TPS_LIMIT``, exact
    launches. The unsharded logits and tokens are saved to ``tmp`` for
    (b)."""
    import torch.distributed as dist

    from apex_tpu_torch.models.gpt import GPTModel
    from apex_tpu_torch.quant import quantize_params
    from apex_tpu_torch.serving import shard_tp_cache, shard_tp_params
    from apex_tpu_torch.transformer import parallel_state as ps

    phase(f"tensor-parallel serving (a): the make_tp_*_fn builders at tp 1 "
          f"on an NCCL world of one, gpt_medium O2, the serving mix's first "
          f"{TPS_PROMPTS} prompts: prefill + {TPS_TICKS} greedy ticks dense "
          f"and paged ({PAGED_POOL} pages of {PAGE}), one verify tick at "
          f"spec_k {TPS_SPEC_K}, the int8 tree ({TPS_W8_TICKS} ticks), "
          f"against the unsharded builders ({TPS_LIMIT})")
    ps.initialize_model_parallel()
    out = {}
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1
              and ps.get_tensor_model_parallel_world_size() == 1,
              "initialize_model_parallel() brought up an NCCL world of one")
        cfg, o2 = _tps_weights(dev)
        L = cfg.num_layers
        model = GPTModel(cfg)
        prompts = mix_prompts(cfg)[:TPS_PROMPTS]
        with torch.inference_mode():
            for mode in TPS_MODES:
                w8 = mode == "w8"
                full = quantize_params(o2) if w8 else o2
                _, ref, fed, _, ref_growth = _tps_serve(
                    dev, cfg, _tps_steps(mode, cfg), full,
                    _tps_cache(mode, cfg, dev), prompts, mode, measure=True)
                local = shard_tp_params(full, model, w8)
                weight_bytes = _tree_bytes(local)
                cache = shard_tp_cache(_tps_cache(mode, cfg, dev))
                torch.cuda.synchronize()
                for k in kern.values():
                    k.launches = 0
                t0 = time.perf_counter()
                cache, got, _, _, growth = _tps_serve(
                    dev, cfg, _tps_steps(mode, cfg, model), local, cache,
                    prompts, mode, feed=fed, measure=True)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = {n: k.launches for n, k in kern.items()}
                ticks = len(got) - 1 - (mode == "dense")
                check_launches(launches, tps_per_run_launches(
                    L, TPS_PROMPTS, ticks, mode, int(mode == "dense")),
                    f"tp 1 {mode}")
                err, same, n = _tps_compare(got, ref)
                lim = _tps_limit(mode)
                check(err <= lim, f"tp 1 {mode}: every row of logits "
                      f"within {lim} of the unsharded builders' "
                      f"(max |diff| {err:.4g}); greedy tokens equal {same} "
                      f"of {n}")
                _tps_check_growth(f"tp 1 {mode}", growth, ref_growth,
                                  weight_bytes)
                torch.save({"logits": [r.cpu() for r in ref],
                            "fed": [f.cpu() for f in fed],
                            "growth": ref_growth},
                           f"{tmp}/tps_{mode}.pt")
                out[mode] = dict(max_abs_err=err, tokens_equal=same,
                                 tokens_compared=n, launches=launches,
                                 wall_s=wall, tick_peak_growth_bytes=growth,
                                 unsharded_growth_bytes=ref_growth,
                                 weight_bytes=weight_bytes)
                print(f"tp 1 {mode}: max |logit diff| {err:.4g}, greedy "
                      f"tokens equal {same} of {n}; {wall:.2f} s wall",
                      flush=True)
                del full, local, cache, ref, got, fed
                torch.cuda.empty_cache()
    finally:
        ps.destroy_model_parallel()
        dist.destroy_process_group()
    del o2
    torch.cuda.empty_cache()
    return out


def _tps_reshard(dev, cache):
    """(c) on this rank: the reshard extract of ``TPS_RESHARD_PAGES``
    against the extract of the gathered pool (the pool's first pages up
    to the last of them, all-gathered over heads), bit for bit."""
    from apex_tpu_torch.serving import (
        gather_tp_cache, make_extract_pages_fn, make_reshard_extract_fn,
    )

    pages = list(TPS_RESHARD_PAGES)
    k, v = make_reshard_extract_fn()(cache, pages)
    top = max(pages) + 1
    whole = gather_tp_cache(cache._replace(k=cache.k[:, :top],
                                           v=cache.v[:, :top]))
    wk, wv = make_extract_pages_fn()(whole, pages)
    return dict(bitwise=torch.equal(k, wk) and torch.equal(v, wv),
                digest=_digest([k, v]), shape=list(k.shape))


def _tps_rank(rank, tmp, port, device):
    """A rank of :func:`tps_two_ranks`: the default process group on
    gloo from a launcher's environment, the model axis over
    ``TPS_RANKS`` ranks; each mode's tensor-parallel run fed (a)'s
    tokens, then (c); results to ``tmp/tps_rank<r>.json``; a barrier
    before the groups go."""
    import datetime
    import os

    import torch.distributed as dist

    from apex_tpu_torch.models.gpt import GPTModel
    from apex_tpu_torch.quant import quantize_params
    from apex_tpu_torch.serving import shard_tp_cache, shard_tp_params
    from apex_tpu_torch.transformer import parallel_state as ps

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(TPS_RANKS),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", init_method="env://",
        timeout=datetime.timedelta(seconds=TPS_RANK_TIMEOUT_S))
    ps.initialize_model_parallel(TPS_RANKS, device=dev)
    try:
        kern = kernel_counters()
        cfg, o2 = _tps_weights(dev)
        L = cfg.num_layers
        model = GPTModel(cfg)
        prompts = mix_prompts(cfg)[:TPS_PROMPTS]
        out = {"backend": dist.get_backend(),
               "tp": ps.get_tensor_model_parallel_world_size()}
        with torch.inference_mode():
            for mode in TPS_MODES:
                w8 = mode == "w8"
                local = shard_tp_params(quantize_params(o2) if w8 else o2,
                                        model, w8)
                weight_bytes = _tree_bytes(local)
                cache = shard_tp_cache(_tps_cache(mode, cfg, dev))
                torch.cuda.empty_cache()
                ref = torch.load(f"{tmp}/tps_{mode}.pt", map_location=dev)
                torch.cuda.synchronize()
                for k in kern.values():
                    k.launches = 0
                t0 = time.perf_counter()
                cache, got, _, staged, growth = _tps_serve(
                    dev, cfg, _tps_steps(mode, cfg, model), local, cache,
                    prompts, mode, feed=ref["fed"], measure=True)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = {n: k.launches for n, k in kern.items()}
                ticks = len(got) - 1 - (mode == "dense")
                err, same, n = _tps_compare(got, ref["logits"])
                out[mode] = dict(
                    max_abs_err=err, tokens_equal=same, tokens_compared=n,
                    launches=launches, wall_s=wall, digest=_digest(got),
                    exact=launches == {
                        k: tps_per_run_launches(
                            L, TPS_PROMPTS, ticks, mode,
                            int(mode == "dense")).get(k, 0)
                        for k in launches},
                    staged_bytes_per_tick=staged / ticks,
                    tick_peak_growth_bytes=growth,
                    unsharded_growth_bytes=ref["growth"],
                    weight_bytes=weight_bytes)
                if mode == "paged":
                    out["reshard"] = _tps_reshard(dev, cache)
                del local, cache, ref, got
                torch.cuda.empty_cache()
        with open(f"{tmp}/tps_rank{rank}.json", "w") as fh:
            json.dump(out, fh)
        dist.barrier()
    finally:
        ps.destroy_model_parallel()
        dist.destroy_process_group()


def tps_two_ranks(dev, tmp):
    """(b) and (c) on ``TPS_RANKS`` spawned gloo ranks on the card: each
    mode's run at tp 2 held to (a)'s unsharded logits, the ranks' logits
    the same bits, exact launches on each rank (row 21 among them in the
    int8 run), a decode tick's growth of the allocator's peak within the
    unsharded step's plus ``TPS_MEMORY_SHARE`` of the rank's weight
    bytes; then the reshard extract bit for bit."""
    import socket

    import torch.multiprocessing as mp

    phase(f"tensor-parallel serving (b, c): the same runs at tp "
          f"{TPS_RANKS} on two gloo ranks on the card (host-staged "
          "collectives) against (a)'s unsharded logits; "
          "make_reshard_extract_fn against the gathered pool")
    torch.cuda.empty_cache()
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    ctx = mp.spawn(_tps_rank, args=(tmp, port, str(dev)), nprocs=TPS_RANKS,
                   join=False)
    deadline = time.monotonic() + TPS_RANK_TIMEOUT_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 1.0)):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.terminate()
            check(False, f"the two ranks finished within "
                  f"{TPS_RANK_TIMEOUT_S} s")
    res = []
    for r in range(TPS_RANKS):
        with open(f"{tmp}/tps_rank{r}.json") as fh:
            res.append(json.load(fh))
    check(all(r["backend"] == "gloo" and r["tp"] == TPS_RANKS for r in res),
          f"{TPS_RANKS} gloo ranks, a model axis of {TPS_RANKS}")
    out = {}
    for mode in TPS_MODES:
        recs = [r[mode] for r in res]
        err = max(r["max_abs_err"] for r in recs)
        lim = _tps_limit(mode)
        check(err <= lim, f"tp {TPS_RANKS} {mode}: every rank's "
              f"logits within {lim} of the unsharded builders' (max "
              f"|diff| {err:.4g}); greedy tokens equal "
              f"{[r['tokens_equal'] for r in recs]} of "
              f"{recs[0]['tokens_compared']}")
        check(len({r["digest"] for r in recs}) == 1,
              f"tp {TPS_RANKS} {mode}: every rank's logits the same bits")
        used = [{n: c for n, c in r["launches"].items() if c} for r in recs]
        check(all(r["exact"] for r in recs),
              f"tp {TPS_RANKS} {mode}: exact launches on each rank {used}")
        growth = max(r["tick_peak_growth_bytes"] for r in recs)
        ref_growth = recs[0]["unsharded_growth_bytes"]
        _tps_check_growth(f"tp {TPS_RANKS} {mode}", growth, ref_growth,
                          recs[0]["weight_bytes"])
        if mode == "w8":
            check(all(r["launches"]["w8_matmul_nobias"] > 0 for r in recs),
                  "row 21 (w8_matmul_nobias) launched on every rank: "
                  f"{[r['launches']['w8_matmul_nobias'] for r in recs]}")
        staged = [r["staged_bytes_per_tick"] for r in recs]
        print(f"tp {TPS_RANKS} {mode}: host-staged bytes a decode tick "
              f"{[int(x) for x in staged]}; wall s "
              f"{[round(r['wall_s'], 2) for r in recs]} (gloo over the "
              "host, not a tensor-parallel speed)", flush=True)
        out[mode] = dict(max_abs_err=err,
                         tokens_equal=[r["tokens_equal"] for r in recs],
                         tokens_compared=recs[0]["tokens_compared"],
                         launches=[r["launches"] for r in recs],
                         staged_bytes_per_tick=staged,
                         tick_peak_growth_bytes=growth,
                         unsharded_growth_bytes=ref_growth,
                         weight_bytes=recs[0]["weight_bytes"],
                         wall_s=[r["wall_s"] for r in recs])
    rs = [r["reshard"] for r in res]
    check(all(r["bitwise"] for r in rs) and len({r["digest"] for r in rs})
          == 1, f"make_reshard_extract_fn at tp {TPS_RANKS}: the pages "
          f"{list(TPS_RESHARD_PAGES)} (tiles {rs[0]['shape']}) equal "
          "make_extract_pages_fn on the gathered pool bit for bit, the same "
          "bits on every rank")
    out["reshard"] = rs[0]
    return out


def tensor_parallel_serving(dev, kern):
    """Phase 18: (a) tp 1 on an NCCL world of one, (b) and (c) on two
    gloo ranks; the phase's seconds and the card's name and power
    limit."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        one = tps_one(dev, kern, tmp)
        two = tps_two_ranks(dev, tmp)
    secs = time.perf_counter() - t0
    print(f"tensor-parallel serving phase: {secs:.1f} s on {card_line()}",
          flush=True)
    return {"tp1": one, "tp2": two, "seconds": secs}


def tps_row21_times(dev):
    """Row 21 at its tensor-parallel shapes (M 8, the decode tick's
    slots; out K 512 and fc2 K 2048 into N 1024 at tp 2): fp32 x, as the
    int8 tensor-parallel path gives it, and bf16 x, as the row's M 8
    time; over 24 weight copies in turn, as a tick reads its layers.
    The library call is ``torch._weight_int8pack_mm`` on the bf16 x
    where the card's torch has it (bf16 scales and out), else
    ``torch.matmul`` over the dequantized bf16 weights."""
    from apex_tpu_torch.quant import dequantize_tensor

    w8 = kernel_modules()[5]
    phase("times of row 21 (w8_matmul_nobias) at its tensor-parallel "
          "shapes (M 8; K 512 and 2048, N 1024; device ms per call)")
    gen = torch.Generator(device=dev).manual_seed(18)
    bf, f32 = torch.bfloat16, torch.float32
    int8pack = torch._C._dispatch_has_kernel_for_dispatch_key(
        "aten::_weight_int8pack_mm", "CUDA")
    res = {}
    m, copies = 8, 24
    for name, (k, n) in TPS_ROW21.items():
        ops = [w8_operands(gen, dev, 1, k, n, bf, bias=False)
               for _ in range(copies)]
        if int8pack:
            packed = [(o[1].t().contiguous(), o[2].to(bf)) for o in ops]
        else:
            deq = [dequantize_tensor(o[1], o[2], -2, bf) for o in ops]
        for xdt, peak in ((f32, FP32_FLOPS), (bf, BF16_TC_FLOPS)):
            x = _rand(gen, (m, k), xdt, dev)
            xb = x.to(bf)
            fk = [lambda o=o: w8.w8_matmul_kernel(x, o[1], o[2], None, xdt)
                  for o in ops]
            fp = [lambda o=o: w8.w8_matmul_plain(x, o[1], o[2], None, xdt)
                  for o in ops]
            if int8pack:
                fl = [lambda p=p: torch._weight_int8pack_mm(xb, *p)
                      for p in packed]
            else:
                fl = [lambda d=d: torch.matmul(xb, d) for d in deq]
            size = 4 if xdt == f32 else 2
            nbytes = m * k * size + k * n + n * 4 + m * n * size
            _entry(res, f"w8_matmul_nobias_tp2_{name}_{str(xdt)[6:]}",
                   time_ms(_cycle(fk), inner=copies),
                   time_ms(_cycle(fp), inner=copies),
                   time_ms(_cycle(fl), inner=copies), nbytes, 2 * m * k * n,
                   peak, f"w8_matmul_nobias M {m} K {k} N {n} "
                   f"{str(xdt)[6:]} x (tp 2 {name})",
                   "torch._weight_int8pack_mm (bf16 x)" if int8pack
                   else "torch.matmul over dequantized bf16 weights")
        del ops
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# 19. contrib/multihead_attn
# ---------------------------------------------------------------------------

MHA_EMBED, MHA_HEADS, MHA_DROPOUT = 1024, 16, 0.1
MHA_SELF = (512, 16)            # seq, batch
MHA_ENCDEC = (256, 512, 16)     # tgt, src, batch
MHA_PLAIN_REL = 1e-2            # module vs plain versions, relative norm


class _mha_recording:
    """Within it the module's ``flash_attention`` and
    ``fused_layer_norm_affine`` record their inputs, outputs and the
    gradients that reach their outputs (the calls go through
    unchanged)."""

    def __init__(self, mod):
        self.mod = mod

    def __enter__(self):
        mod = self.mod
        self.saved = (mod.flash_attention, mod.fused_layer_norm_affine)
        fa_fn, ln_fn = self.saved
        rec = self.rec = {}

        def flash(q, k, v, mask=None, **kw):
            o = fa_fn(q, k, v, mask, **kw)
            r = rec["flash"] = dict(q=q.detach(), k=k.detach(),
                                    v=v.detach(), mask=mask, kw=kw,
                                    o=o.detach())
            o.register_hook(lambda g: r.__setitem__("do", g))
            return o

        def norm(x, w, b, shape, eps=1e-5):
            y = ln_fn(x, w, b, shape, eps)
            r = rec["ln"] = dict(x=x.detach(), w=w.detach(), b=b.detach(),
                                 eps=eps)
            y.register_hook(lambda g: r.__setitem__("dy", g))
            return y

        mod.flash_attention, mod.fused_layer_norm_affine = flash, norm
        return rec

    def __exit__(self, *exc):
        self.mod.flash_attention, self.mod.fused_layer_norm_affine = \
            self.saved


class _plain_kernels:
    """Within it the LayerNorm and flash wrappers take their plain
    versions on the card's tensors; the launches made inside are put
    back."""

    def __init__(self, kern):
        self.mods = kernel_modules()[:2]
        self.kern = kern

    def __enter__(self):
        self.saved = [m.on_card for m in self.mods]
        self.counts = {n: k.launches for n, k in self.kern.items()}
        for m in self.mods:
            m.on_card = lambda t, what="": False
        return self

    def __exit__(self, *exc):
        for m, f in zip(self.mods, self.saved):
            m.on_card = f
        for n, k in self.kern.items():
            k.launches = self.counts[n]


def _mha_kernel_parity(rec, label):
    """The recorded flash call's forward, dq and dk/dv kernels against
    their plain versions on its inputs (the module's sequence-first
    views), per element to ``o_limit`` and ``bwd_limits``, a second
    forward launch the recorded bits; the recorded LayerNorm's forward
    (one bf16 ulp) and backward (``bwd_limits``)."""
    from apex_tpu_torch.utils import prng

    ln, fa = kernel_modules()[:2]
    out = {}
    f = rec["flash"]
    q, k, v, kw = f["q"], f["k"], f["v"], f["kw"]
    rng = kw.get("dropout_rng")
    rate = float(kw.get("dropout_rate", 0.0)) if rng is not None else 0.0
    seed = prng.host_bits(rng, 2) if rate > 0 else (0, 0)
    mask = None if f["mask"] is None else f["mask"].to(torch.int32)
    fkw = dict(causal=bool(kw.get("causal", False)),
               scale=float(kw["softmax_scale"]), rate=rate)
    o, lse = fa.attention_fwd_kernel(q, k, v, mask, seed, **fkw)
    o0, lse0 = fa.attention_fwd_plain(q, k, v, mask, seed, **fkw)
    e, use = _held(o, o0, fa.o_limit(q, k, v, mask, o0,
                                     causal=fkw["causal"],
                                     scale=fkw["scale"]))
    check(use <= 1.0 and torch.equal(o, f["o"]),
          f"{label}: flash forward on the module's views (q "
          f"{tuple(q.shape)}, k {tuple(k.shape)}, strides q "
          f"{q.stride()}): max_abs_err {e:.3g} ({use:.2f} of o_limit); the "
          "module's launch the same bits")
    out["flash_attention_fwd"] = e
    do = f["do"] if f["do"].stride(-1) == 1 else f["do"].contiguous()
    got = fa.attention_bwd_kernel(q, k, v, mask, o, lse, do, seed, **fkw)
    want = fa.attention_bwd_plain(q, k, v, mask, o, lse, do, seed, **fkw)
    lims = fa.bwd_limits(q, k, v, mask, o, lse, do, *want, **fkw)
    parts = []
    for name, g, w0, lim in zip(("dq", "dk", "dv"), got, want, lims):
        e, use = _held(g, w0, lim)
        check(use <= 1.0 and bool(torch.isfinite(g).all()),
              f"{label}: flash backward {name}: max_abs_err {e:.3g} "
              f"({use:.2f} of bwd_limits)")
        key = ("flash_attention_bwd_dq" if name == "dq"
               else "flash_attention_bwd_dkv")
        out[key] = max(out.get(key, 0.0), e)
        parts.append(name)
    if "ln" in rec:
        r = rec["ln"]
        x2 = r["x"].reshape(-1, r["x"].shape[-1])
        y, _, _ = ln.layer_norm_fwd_kernel(x2, r["w"], r["b"], "ln",
                                           r["eps"])
        y0, mean0, rstd0 = ln.layer_norm_fwd_plain(x2, r["w"], r["b"], "ln",
                                                   r["eps"])
        err = (y.float() - y0.float()).abs()
        ok = bool((err <= 2 ** -7 * y0.float().abs() + 1e-5).all())
        check(ok, f"{label}: LayerNorm forward ({tuple(x2.shape)} bf16): "
              f"max_abs_err {float(err.max()):.3g} (one bf16 ulp)")
        out["layer_norm_fwd"] = float(err.max())
        dy = r["dy"].reshape(x2.shape).contiguous()
        got = ln.layer_norm_bwd_kernel(dy, x2, r["w"], r["b"], mean0, rstd0)
        want = ln.layer_norm_bwd_plain(dy, x2, r["w"], r["b"], mean0, rstd0)
        lims = ln.bwd_limits(dy, x2, r["w"], mean0, rstd0, *want)
        worst = 0.0
        for name, g, w0, lim in zip(("dx", "dgamma", "dbeta"), got, want,
                                    lims):
            e, use = _held(g, w0, lim)
            check(use <= 1.0, f"{label}: LayerNorm backward {name}: "
                  f"max_abs_err {e:.3g} ({use:.2f} of bwd_limits)")
            worst = max(worst, e)
        out["layer_norm_bwd"] = worst
    return out


def multihead_attn_phase(dev, kern):
    """Phase 19: ``SelfMultiheadAttn`` (s 512, b 16, embed 1024, 16 heads,
    bf16, norm-add, dropout 0.1, causal, a key mask) and
    ``EncdecMultiheadAttn`` (tgt 256, src 512, b 16, dropout 0.1, a key
    mask), forward and backward through the kernels with counts set to 0
    before and read after (exact launches), each kernel call held on its
    recorded inputs to its plain version per element, and the module's
    output and gradients against the same module on the plain versions
    (relative norm ``MHA_PLAIN_REL``)."""
    from apex_tpu_torch.utils import prng
    from apex_tpu_torch.utils.tree import tree_leaves, tree_map

    mod = importlib.import_module(
        "apex_tpu_torch.contrib.multihead_attn.multihead_attn")
    phase(f"multihead_attn: SelfMultiheadAttn (s {MHA_SELF[0]}, b "
          f"{MHA_SELF[1]}, norm-add, causal, key mask) and "
          f"EncdecMultiheadAttn (tgt {MHA_ENCDEC[0]}, src {MHA_ENCDEC[1]}, "
          f"b {MHA_ENCDEC[2]}, key mask), embed {MHA_EMBED}, {MHA_HEADS} "
          f"heads, bf16, dropout {MHA_DROPOUT}, forward and backward")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(19)
    bf = torch.bfloat16
    out = {"errors": {}}

    def key_mask(b, s):
        lens = s - (torch.arange(b, device=dev) * 29) % (s // 4)
        return (torch.arange(s, device=dev)[None, :]
                < lens[:, None]).to(torch.int32)

    for name in ("self", "encdec"):
        if name == "self":
            s, b = MHA_SELF
            m = mod.SelfMultiheadAttn(MHA_EMBED, MHA_HEADS,
                                      dropout=MHA_DROPOUT,
                                      include_norm_add=True,
                                      params_dtype=bf)
            inputs = (_rand(gen, (s, b, MHA_EMBED), bf, dev),)
            kw = dict(key_padding_mask=key_mask(b, s),
                      attn_mask_causal=True)
            want = {"layer_norm_fwd": 1, "layer_norm_bwd": 1,
                    "threefry_bits": 1}
        else:
            tgt, src, b = MHA_ENCDEC
            s = tgt
            m = mod.EncdecMultiheadAttn(MHA_EMBED, MHA_HEADS,
                                        dropout=MHA_DROPOUT,
                                        params_dtype=bf)
            inputs = (_rand(gen, (tgt, b, MHA_EMBED), bf, dev),
                      _rand(gen, (src, b, MHA_EMBED), bf, dev))
            kw = dict(key_padding_mask=key_mask(b, src))
            want = {}
        want.update(flash_attention_fwd=1, flash_attention_bwd_dq=1,
                    flash_attention_bwd_dkv=1)
        params = m.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
        dout = _rand(gen, (s, b, MHA_EMBED), bf, dev)

        def run():
            leaves = tree_map(lambda t: t.detach().requires_grad_(True),
                              params)
            ins = [t.detach().requires_grad_(True) for t in inputs]
            y = m.apply(leaves, *ins, dropout_rng=prng.PRNGKey(7), **kw)
            y.backward(dout)
            return [y.detach()] + [t.grad for t in ins] + [
                t.grad for t in tree_leaves(leaves)]

        with _mha_recording(mod) as rec:
            torch.cuda.synchronize()
            for k in kern.values():
                k.launches = 0
            got = run()
            torch.cuda.synchronize()
            launches = {n: k.launches for n, k in kern.items()}
        check_launches(launches, want, f"multihead_attn {name}")
        counts = {n: k.launches for n, k in kern.items()}
        errs = _mha_kernel_parity(rec, f"multihead_attn {name}")
        for n, k in kern.items():
            k.launches = counts[n]
        with _plain_kernels(kern):
            plain = run()
        rel = max(float((g.double() - p.double()).norm())
                  / max(float(p.double().norm()), 1e-30)
                  for g, p in zip(got, plain))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        check(finite and rel <= MHA_PLAIN_REL,
              f"multihead_attn {name}: output and every gradient finite and "
              f"within {MHA_PLAIN_REL} (relative norm) of the module on the "
              f"plain versions: {rel:.3g}")
        out[name] = dict(launches=launches, vs_plain_rel=rel)
        for n, e in errs.items():
            out["errors"][n] = max(out["errors"].get(n, 0.0), e)
        del params, inputs, got, plain, rec
        torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    out["seconds"] = secs
    used = {n: {k: c for k, c in out[n]["launches"].items() if c}
            for n in ("self", "encdec")}
    print(f"multihead_attn phase: {secs:.1f} s on {card_line()}; launches "
          f"{used}", flush=True)
    return out


# ---------------------------------------------------------------------------
# 12. chunked prefill and the serving tracer
# ---------------------------------------------------------------------------

CHUNK = 256          # the prompt chunk of serving_chunked
ARRIVAL_GAP = 16     # ticks between the long prompts' arrivals
CHUNK_LOGITS_LAYERS = 2


def chunked_arrivals(cfg):
    """The serving mix open-loop on the work clock: the 8 shortest
    prompts at tick 0, the 8 longest one every ``ARRIVAL_GAP`` ticks
    after it (each group in the mix's order)."""
    prompts = mix_prompts(cfg)
    order = sorted(range(len(prompts)), key=lambda i: (len(prompts[i]), i))
    half = len(order) // 2
    return ([(0, i) for i in sorted(order[:half])]
            + [(ARRIVAL_GAP * (j + 1), i)
               for j, i in enumerate(sorted(order[half:]))])


def drive_open_loop(sched, arrivals):
    """The JAX package's ``bench.py::_drive_poisson``: submit each
    arrival once the scheduler's work clock reaches its tick, backdated
    to it (``at_tick``), step while busy, and jump an idle clock to the
    next arrival. Returns the streams in submission order."""
    i = 0
    while i < len(arrivals) or sched.busy:
        while i < len(arrivals) and arrivals[i][0] <= sched.clock:
            t, req = arrivals[i]
            sched.submit(req, at_tick=t)
            i += 1
        if sched.busy:
            sched.step()
        elif i < len(arrivals):
            sched.advance_clock(arrivals[i][0])
    return [list(sched.outcomes[rid].tokens)
            for rid in sorted(sched.outcomes)]


def serve_open_loop(dev, cfg, params, kern, engine, chunk, **engine_kw):
    """:func:`chunked_arrivals` on one engine (8 slots, max_len 1024, bf16
    cache), chunked at ``chunk`` or monolithic (None), after a
    one-request warm-up; a fresh enabled ``Tracer`` on the engine for the
    measured run; every kernel's count set to 0 just before it and read
    just after. Returns the streams, launches, wall time, the work clock,
    the tracer's ``latency_summary()`` (ticks), chunks and prefills."""
    from apex_tpu_torch.serving import (
        ContinuousBatchingScheduler, Request, ServingStats, Tracer,
    )

    eng = engine(params, cfg, num_slots=NUM_SLOTS, max_len=MAX_LEN,
                 cache_dtype=torch.bfloat16, buckets=BUCKETS, device=dev,
                 **engine_kw)
    warm = ContinuousBatchingScheduler(eng, eos_id=-1, chunk_tokens=chunk)
    warm.submit(Request(prompt=(1, 2, 3), max_new_tokens=2))
    warm.run()
    eng.tracer = Tracer()
    eng.stats = ServingStats(registry=eng.tracer.registry)
    sched = ContinuousBatchingScheduler(eng, eos_id=-1, chunk_tokens=chunk)
    prompts = mix_prompts(cfg)
    arrivals = [(t, Request(prompt=prompts[i], max_new_tokens=NEW_TOKENS,
                            seed=i)) for t, i in chunked_arrivals(cfg)]
    torch.cuda.synchronize()
    for k in kern.values():
        k.launches = 0
    t0 = time.perf_counter()
    streams = drive_open_loop(sched, arrivals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: k.launches for n, k in kern.items()}
    outs = [sched.outcomes[i] for i in range(len(arrivals))]
    n_tok = sum(len(s) for s in streams)
    check(len(streams) == len(arrivals)
          and all(o.reason == "length" for o in outs)
          and all(len(s) == NEW_TOKENS for s in streams)
          and all(0 <= t < cfg.vocab_size for s in streams for t in s),
          f"{len(streams)} requests finished (length), {n_tok} tokens, "
          "every token inside the vocabulary")
    return dict(streams=streams, launches=launches, wall_s=wall,
                tokens=n_tok, tokens_per_s=n_tok / wall,
                clock=sched.clock, latency=eng.tracer.latency_summary(),
                prefill_chunks=sched.stats.prefill_chunks,
                decode_steps=sched.decode_steps,
                prefills=sum(o.prefill_ticks for o in outs),
                ttft_ticks=[o.ttft_ticks for o in outs])


def chunked_final_logits(dev):
    """GPT-2 medium's width at 2 layers, seed 0: one 700-token prompt
    prefilled in chunks of 256 (three: the last 188 tokens padded) on the
    paged and the dense engine, the final chunk's logits against a
    one-shot prefill of the same prompt on the same engine: fp32 params
    and cache within 1e-5, O2 bf16 within 0.0625 (the decode-vs-full
    limits); the paged chunks launch the chunk kernel once a layer (O2)
    or the verify kernel once a slice a layer (fp32)."""
    import dataclasses

    from apex_tpu_torch import amp
    from apex_tpu_torch.models.gpt import gpt_medium, init_gpt
    from apex_tpu_torch.serving import DecodeEngine, PagedDecodeEngine

    pa = kernel_modules()[7]
    L = CHUNK_LOGITS_LAYERS
    cfg = dataclasses.replace(gpt_medium(), num_layers=L)
    params = init_gpt(cfg, torch.Generator().manual_seed(0), device=dev)
    rng = np.random.RandomState(3)
    prompt = tuple(int(t) for t in rng.randint(0, cfg.vocab_size, size=700))
    n_chunks = -(-len(prompt) // CHUNK)
    out = {}
    with torch.inference_mode():
        o2 = amp.initialize("O2", verbosity=0).cast_model(params)
        for label, p, dt, tol in (("fp32", params, torch.float32, 1e-5),
                                  ("O2 bf16", o2, torch.bfloat16, 0.0625)):
            for engine, kw in ((PagedDecodeEngine, dict(
                    num_pages=PAGED_POOL, page_size=PAGE)),
                               (DecodeEngine, {})):

                def make():
                    return engine(p, cfg, num_slots=2, max_len=MAX_LEN,
                                  cache_dtype=dt, buckets=BUCKETS,
                                  device=dev, **kw)

                one_shot = make().prefill(1, prompt)
                eng = make()
                state = eng.begin_chunk_prefill(1, prompt)
                n0 = (pa.PAGED_CHUNK.launches, pa.PAGED_VERIFY.launches)
                for pos in range(0, len(prompt), CHUNK):
                    logits = eng.chunk_prefill(
                        1, prompt[pos:pos + CHUNK], pos, state, CHUNK,
                        pos + CHUNK >= len(prompt))
                eng.finish_chunk_prefill(1, state)
                torch.cuda.synchronize()
                launched = (pa.PAGED_CHUNK.launches - n0[0],
                            pa.PAGED_VERIFY.launches - n0[1])
                want = (0, 0)
                if eng.paged:
                    want = ((L * n_chunks, 0) if dt == torch.bfloat16 else
                            (0, L * n_chunks * len(pa.verify_slices(
                                CHUNK, cfg.head_dim))))
                err = float((logits - one_shot).abs().max())
                key = f"{engine.__name__}_{label.split()[-1]}"
                out[key] = err
                check(err <= tol and launched == want
                      and bool(eng.check_invariants()),
                      f"chunked final logits ({engine.__name__}, {label}, "
                      f"{L} layers, {n_chunks} chunks of {CHUNK}) against a "
                      f"one-shot prefill: max_abs_err {err:.3g} <= {tol}; "
                      f"launches (chunk, verify) {launched}")
    return out


def chunk_verify_parity(dev):
    """The chunk attention at a prompt chunk's shape: one slot, GPT-2
    medium's 16 heads, hd 64, 256 queries at pos 0, 256, 512 and 768
    over a table of 16 pages of 64, through a gather row (the slot's
    stored row parked on scratch). A bf16 pool: ``paged_chunk_attention``
    launches the chunk kernel once, per element within ``chunk_limit``,
    the same bits under a second page placement (pos 768 walks in
    parts). An fp32 pool (pos 0, 256 and 512): the verify kernel, one
    launch a slice of ``verify_slices``, per element within
    ``paged_limit``, every query the bits of the decode kernel at pos +
    j. Returns the largest error of each."""
    pa = kernel_modules()[7]
    phase(f"kernel parity: the chunk attention at a prompt chunk's shape "
          f"(one slot, {CHUNK} queries), the bf16 pool on the chunk "
          "kernel at pos 0, 256, 512 and 768, the fp32 pool on the verify "
          f"kernel ({pa.verify_slices(CHUNK, 64)}) at pos 0, 256 and 512")
    max_err = {"bf16": 0.0, "fp32": 0.0}
    for pos in (0, 256, 512, 768):
        q, k, v, row, p = _chunk_inputs(dev, torch.bfloat16, pos,
                                        seed=pos + 7)
        n0, v0 = pa.PAGED_CHUNK.launches, pa.PAGED_VERIFY.launches
        got = pa.paged_chunk_attention(q, k, v, row, p)
        torch.cuda.synchronize()
        launched = (pa.PAGED_CHUNK.launches - n0,
                    pa.PAGED_VERIFY.launches - v0)
        want = pa.paged_chunk_attention_plain(q, k, v, row, p)
        lim = pa.chunk_limit(q, k, v, row, p, want)
        err = (got.float() - want.float()).abs()
        max_err["bf16"] = max(max_err["bf16"], float(err.max()))
        perm = torch.arange(k.shape[0], device=dev)
        perm[2:] = 2 + torch.randperm(k.shape[0] - 2, device=dev)
        k2, v2 = torch.empty_like(k), torch.empty_like(v)
        k2[perm], v2[perm] = k, v
        moved = pa.paged_chunk_attention(q, k2, v2,
                                         perm[row.long()].to(torch.int32), p)
        check(launched == (1, 0) and bool((err <= lim).all())
              and torch.equal(moved, got),
              f"chunk attention, bf16 pool, pos {pos}: launches (chunk, "
              f"verify) {launched}; max_abs_err {float(err.max()):.3g}, "
              f"at most {float((err / lim).max()):.3g} of chunk_limit; "
              "another page placement the same bits")
        if pos == 768:
            continue
        q, k, v, row, p = _chunk_inputs(dev, torch.float32, pos,
                                        seed=pos + 7)
        n0, c0 = pa.PAGED_VERIFY.launches, pa.PAGED_CHUNK.launches
        got = pa.paged_chunk_attention(q, k, v, row, p)
        torch.cuda.synchronize()
        launched = (pa.PAGED_CHUNK.launches - c0,
                    pa.PAGED_VERIFY.launches - n0)
        want = pa.paged_verify_attention_plain(q, k, v, row, p, None)
        lim = pa.paged_limit(q, k, v, row, p, want)
        err = (got.float() - want.float()).abs()
        max_err["fp32"] = max(max_err["fp32"], float(err.max()))
        same = all(torch.equal(got[:, :, j],
                               pa.paged_decode_attention_kernel(
                                   q[:, :, j].contiguous(), k, v, row,
                                   p + j))
                   for j in range(CHUNK))
        check(launched == (0, len(pa.verify_slices(CHUNK, 64)))
              and bool((err <= lim).all()) and same,
              f"chunk attention, fp32 pool, pos {pos}: launches (chunk, "
              f"verify) {launched}; max_abs_err {float(err.max()):.3g} "
              "within paged_limit; every query the decode kernel's bits")
    return max_err


def _chunk_inputs(dev, kv, pos, seed):
    """One slot's chunk operands: q (1, 16, CHUNK, 64) in the pool's dtype,
    pools of 2 + 32 pages of 64, a gather row of distinct random pages for
    the rows 0 .. pos + CHUNK - 1 (NULL past them) in a table of 16, and
    ``pos``."""
    from apex_tpu_torch.serving.cache import NULL_PAGE, RESERVED_PAGES

    nh, hd, max_pages = 16, 64, MAX_LEN // PAGE
    g = torch.Generator(device=dev).manual_seed(seed)
    num_pages = RESERVED_PAGES + 2 * max_pages
    k, v = (_rand(g, (num_pages, nh, PAGE, hd), kv, dev) for _ in range(2))
    q = _rand(g, (1, nh, CHUNK, hd), kv, dev)
    live = (pos + CHUNK) // PAGE
    row = torch.full((1, max_pages), NULL_PAGE, dtype=torch.int32,
                     device=dev)
    row[0, :live] = (RESERVED_PAGES + torch.randperm(
        num_pages - RESERVED_PAGES, generator=g, device=dev)[:live]).to(
            torch.int32)
    return q, k, v, row, torch.tensor([pos], dtype=torch.int32, device=dev)


def serve_chunked(dev, kern, o2):
    """``serving_chunked``: the ``serving_paged`` engine (GPT-2 medium O2
    bf16, 8 slots, max_len 1024, pages of 64) and the dense
    ``DecodeEngine`` on :func:`chunked_arrivals` (EOS -1), each chunked at
    256 and monolithic: exact launches (a chunk's attention the chunk
    kernel once a layer), the
    tick-clock latency (TTFT and inter-token p50/p99, ticks), wall time,
    tokens/s and the share of tokens equal to the monolithic run's; the
    chunked p99 inter-token gap below the monolithic one and the TTFT
    median within 2 x monolithic + 1 (the JAX package's bound). Then the
    chunked final logits at 2 layers (:func:`chunked_final_logits`)."""
    from apex_tpu_torch.models.gpt import gpt_medium
    from apex_tpu_torch.serving import DecodeEngine, PagedDecodeEngine

    cfg = gpt_medium()
    L = cfg.num_layers
    phase(f"serving_chunked: the 16 requests open-loop (8 shortest at tick "
          f"0, 8 longest one every {ARRIVAL_GAP} ticks), chunk_tokens "
          f"{CHUNK} and monolithic, on PagedDecodeEngine and DecodeEngine")
    out = {}
    runs = {"paged": (PagedDecodeEngine, dict(num_pages=PAGED_POOL,
                                              page_size=PAGE)),
            "dense": (DecodeEngine, {})}
    with torch.inference_mode():
        for name, (engine, kw) in runs.items():
            for chunk in (CHUNK, None):
                key = name + ("_chunked" if chunk else "_monolithic")
                out[key] = serve_open_loop(dev, cfg, o2, kern, engine, chunk,
                                           **kw)
    for name in runs:
        ch, mono = out[name + "_chunked"], out[name + "_monolithic"]
        paged = name == "paged"
        check_launches(ch["launches"], {
            "layer_norm_fwd": (2 * L + 1) * (ch["prefill_chunks"]
                                             + ch["decode_steps"]),
            "paged_decode_attention": L * ch["decode_steps"] if paged else 0,
            "paged_chunk_attention": (L * ch["prefill_chunks"] if paged
                                      else 0)},
            f"chunked serving ({name})")
        check_launches(mono["launches"], {
            "layer_norm_fwd": (2 * L + 1) * (mono["prefills"]
                                             + mono["decode_steps"]),
            "flash_attention_fwd": L * mono["prefills"],
            "paged_decode_attention": (L * mono["decode_steps"] if paged
                                       else 0)},
            f"monolithic open-loop serving ({name})")
        same, total = _same_share(ch["streams"], mono["streams"])
        lc, lm = ch["latency"], mono["latency"]
        ch.update(tokens_equal_to_monolithic=same, tokens_compared=total,
                  chunk_launches_per_chunk=L if paged else 0)
        print(f"{name}: chunked {CHUNK}: {ch['prefill_chunks']} chunks, "
              f"{ch['decode_steps']} decode steps, clock {ch['clock']} "
              f"ticks, latency (ticks) {json.dumps(lc)}, "
              f"{ch['wall_s']:.3f} s wall, {ch['tokens_per_s']:.1f} "
              f"tokens/s; monolithic: {mono['prefills']} prefills, "
              f"{mono['decode_steps']} decode steps, clock {mono['clock']} "
              f"ticks, latency (ticks) {json.dumps(lm)}, "
              f"{mono['wall_s']:.3f} s wall, {mono['tokens_per_s']:.1f} "
              f"tokens/s; tokens equal to the monolithic run's: {same} of "
              f"{total}", flush=True)
        if paged:
            print(f"chunk kernel launches a {CHUNK}-token chunk: {L} (one "
                  f"a layer); in the run "
                  f"{ch['launches']['paged_chunk_attention']} for "
                  f"{ch['prefill_chunks']} chunks", flush=True)
        check(lc["itl_p99"] < lm["itl_p99"]
              and lc["ttft_p50"] <= 2.0 * lm["ttft_p50"] + 1.0,
              f"{name}: chunked p99 inter-token gap {lc['itl_p99']} ticks < "
              f"monolithic {lm['itl_p99']}; TTFT p50 {lc['ttft_p50']} <= 2 x "
              f"{lm['ttft_p50']} + 1")
    out["final_logits_max_abs_err"] = chunked_final_logits(dev)
    for res in out.values():
        res.pop("streams", None)
    return out


def chunk_times(dev):
    """The chunk kernel at a prompt chunk's shape (one slot, 16 heads, hd
    64, 256 queries at pos 0, 256, 512 and 768 over a table of 16 pages
    of 64, bf16; one launch of ``chunk_splits`` parts at most): the
    wrapper, its plain version, the bound (the live K/V rows once, q,
    ctx and the table over 3.35 TB/s, or 4 operations a query a visible
    K/V element over the bf16 tensor-core peak, the operands' type; the
    larger), SDPA on the already-gathered K/V with the same causal
    window mask (a different function: it leaves out the gather), the
    kernel without the split walk (``splits=1``), and the verify
    kernel's route the chunk took before (``paged_verify_attention``,
    one launch a slice of ``verify_slices``), on the bf16 chunk and on
    the same chunk in fp32 (the route an fp32 chunk takes), all in this
    call."""
    pa = kernel_modules()[7]
    phase(f"times of the chunk attention at a prompt chunk's shape (one "
          f"slot, {CHUNK} queries; device ms a call, one layer; medians "
          "of CUDA-graph replays)")
    res = {}
    with torch.inference_mode():
        for pos in (0, 256, 512, 768):
            q, k, v, row, p = _chunk_inputs(dev, torch.bfloat16, pos,
                                            seed=pos + 9)
            args = (q, k, v, row, p)
            t_k = time_ms(lambda: pa.paged_chunk_attention(*args))
            t_1 = time_ms(lambda: pa.paged_chunk_attention_kernel(
                *args, splits=1))
            t_v = time_ms(lambda: pa.paged_verify_attention(*args, None))
            f32 = _chunk_inputs(dev, torch.float32, pos, seed=pos + 9)
            t_vf = time_ms(lambda: pa.paged_verify_attention(*f32, None))
            del f32
            t_p = time_ms(lambda: pa.paged_chunk_attention_plain(*args))
            _, nh, sc, hd = q.shape
            s_len = row.shape[1] * PAGE
            live = pos + sc
            nbytes = (2 * live * nh * hd * 2 + 2 * sc * nh * hd * 2
                      + row.numel() * 4 + 4)
            seen = sum(pos + j + 1 for j in range(sc))
            flops = 4 * seen * nh * hd
            kg = k[row.long()].transpose(1, 2).reshape(1, nh, s_len, hd)
            vg = v[row.long()].transpose(1, 2).reshape(1, nh, s_len, hd)
            vis = pa.visible(p, sc, s_len)[:, None]
            t_l = time_ms(lambda: F.scaled_dot_product_attention(
                q, kg, vg, attn_mask=vis))
            key = f"chunk_pos{pos}"
            splits = pa.chunk_splits(s_len)
            _entry(res, key, t_k, t_p, t_l, nbytes, flops, BF16_TC_FLOPS,
                   f"chunk kernel (1 slot, {sc} queries, pos {pos}, {live} "
                   f"live rows, splits {splits})",
                   "SDPA on the gathered K/V (a different function)")
            res[key].update(live_rows=live, splits=splits, splits1_ms=t_1,
                            verify_route_ms=t_v, verify_route_fp32_ms=t_vf,
                            verify_route_launches=len(
                                pa.verify_slices(sc, hd)),
                            per_chunk_24_layers_ms=24 * t_k)
            print(f"  without the split walk {t_1:.5f}; the verify "
                  f"kernel's route {t_v:.5f}, an fp32 chunk's {t_vf:.5f}",
                  flush=True)
    return res


# -- the serving fault tier ------------------------------------------------

# (a)'s pinned schedule, one fault (or a run of them) at each single-engine
# site: an allocation refused during the first admissions; the first
# copy-on-write clone (a request's first decode tick); the first prefill and
# four in a row later (the head request then exhausts max_retries = 3); one
# decode tick's NaN row; one bad first token
CHAOS_PINNED = {"pool_alloc": (5,), "cow_clone": (0,),
                "prefill_exec": (0, 3, 4, 5, 6), "decode_exec": (10,),
                "sample": (1,)}
# the ServingStats counter each fired site moves
SITE_COUNTERS = {"pool_alloc": "pool_exhausted", "cow_clone": "preemptions",
                 "prefill_exec": "retries", "chunk_prefill_exec": "retries",
                 "decode_exec": "nan_events", "sample": "bad_samples",
                 "draft_exec": "draft_faults",
                 "host_spill": "host_spill_failures",
                 "host_promote": "host_promote_failures",
                 "stream_emit": "stream_failures"}
CHAOS_TIER_REQUESTS = 8    # the tiered mix's first 8: each prefix twice
CHAOS_GOLD_STEP = 3        # (e): the gold tenant's requests arrive then
# serving_paged's reading, the same mix on the same engine, before the
# engines carried fault sites (PERF.md section 6)
PAGED_BEFORE_FAULTS = ("413.4 tokens/s (1.238 s wall) before the fault "
                       "sites, NVIDIA H100 80GB HBM3, 700.00 W")
# the kernels the phase's paths launch (every other kernel stays at 0)
CHAOS_KERNELS = ("layer_norm_fwd", "flash_attention_fwd", "threefry_bits",
                 "paged_decode_attention", "paged_verify_attention",
                 "paged_chunk_attention")


def decision_scores(row, temp, key):
    """The sampler's scores of a logits row: the row (greedy), else
    row / T plus the key's Gumbel noise (``prng.categorical_rows``);
    ``examples/gpt/stream_ab.py`` reads its margins with it too."""
    from apex_tpu_torch.utils import prng

    if temp <= 0:
        return row
    return prng.gumbel_rows(key[None], row.shape[-1], row.device)[0] \
        + row / max(temp, 1e-6)


def capture_rows(eng, sched):
    """Keep every committed token's logits row with its temperature and
    key, under (request id, token index): wrappers on the engine's
    samplers and the scheduler's commit (``examples/gpt/stream_ab.py``
    captures its runs' rows with it too). Returns the dict, filled as
    the scheduler runs."""
    last, rows = {}, {}
    sample, grid, append = eng.sample, eng.sample_grid, sched._append

    def sampling(fn, is_grid):
        def run(logits, keys, temperature):
            last.update(logits=logits, keys=torch.as_tensor(keys),
                        temps=list(temperature), grid=is_grid, used={})
            return fn(logits, keys, temperature)
        return run

    def appending(i, tok):
        slot = sched._slots[i]
        if last["grid"]:
            j = last["used"].get(i, 0)
            last["used"][i] = j + 1
            at = (i, j)
        else:
            at = (i if last["logits"].shape[0] > 1 else 0,)
        rows[(slot.request_id, len(slot.generated))] = (
            last["logits"][at].float().clone(), float(last["temps"][at[0]]),
            last["keys"][at].clone())
        append(i, tok)

    eng.sample = sampling(sample, False)
    eng.sample_grid = sampling(grid, True)
    sched._append = appending
    return rows


def _pool_whole(eng, sched, label):
    """After a run: the audit holds, no slot holds a page, every page is
    free or the prefix registry's alone (no reference leaked), and a
    tenancy ledger's charge is back to 0; on every replica of a
    router."""
    check(eng.check_invariants(), f"{label}: check_invariants() at the end")
    charged = sched.tenancy.charged_total() if sched.tenancy else 0
    replicas = getattr(eng, "_replicas", {"engine": eng})
    for name, rep in replicas.items():
        snap = rep.pool.snapshot()
        pool = rep.pool
        check(all(not p for p in rep._slot_pages)
              and all(n == 1 for n in snap["refcounts"].values())
              and len(snap["refcounts"]) == snap["num_cached"]
              and pool.num_free + pool.num_cached == pool.num_usable
              and charged == 0,
              f"{label}: no page leaked on {name} ({pool.num_free} free + "
              f"{pool.num_cached} the registry's alone = "
              f"{pool.num_usable} usable), quota charge {charged}")


def chaos_run(dev, cfg, params, kern, prompts, temps, label, faults=None,
              capture=False, submit=None, arrivals=(), engine_kw=None,
              route=None, open_loop=None, **sched_kw):
    """One run of the ``serving_chaos`` phase on ``serving_paged``'s
    engine (8 slots, max_len 1024, pages of 64, bf16 pool unless
    ``engine_kw`` says otherwise) with an enabled ``Tracer``, ``audit=True``
    and a ``FaultInjector(**faults)`` (inert without). ``route``:
    ``"pair"`` serves through a ``DisaggregatedRouter`` over two such
    engines, ``"pool"`` through a 2x2 ``PoolRouter`` (one params tree,
    one injector and one tracer for all). The prompts are
    submitted with their temperatures (seed = index), or ``submit(sched)``
    submits; ``arrivals`` ((step, request) pairs) are submitted as the
    drain reaches their step; ``open_loop`` ((tick, request) pairs) is
    driven by :func:`drive_open_loop` instead. Every kernel's count is set
    to 0 just before the drain and read just after; every fired draw is
    logged with the clock and the resident requests; ``capture`` keeps
    each committed token's logits row. Every pool is audited whole at the
    end."""
    from apex_tpu_torch.serving import (
        ContinuousBatchingScheduler, DisaggregatedRouter, FaultInjector,
        PagedDecodeEngine, PoolRouter, Request, Tracer,
    )

    kw = dict(num_slots=NUM_SLOTS, num_pages=PAGED_POOL, page_size=PAGE,
              cache_dtype=torch.bfloat16)
    kw.update(engine_kw or {})
    inj, trc = FaultInjector(**(faults or {})), Tracer()
    engines = [PagedDecodeEngine(params, cfg, max_len=MAX_LEN,
                                 buckets=BUCKETS, injector=inj, tracer=trc,
                                 device=dev, **kw)
               for _ in range({None: 1, "pair": 2, "pool": 4}[route])]
    if route is None:
        sched = ContinuousBatchingScheduler(engines[0], eos_id=-1,
                                            audit=True, **sched_kw)
    elif route == "pair":
        sched = DisaggregatedRouter(*engines, eos_id=-1, audit=True,
                                    **sched_kw)
    else:
        sched = PoolRouter(engines[:2], engines[2:], eos_id=-1, audit=True,
                           **sched_kw)
    eng = sched.engine
    fired = []
    draw = eng.injector.draw

    def logged(site):
        hit = draw(site)
        if hit[0]:
            fired.append((site, sched.clock, sorted(
                s.request_id for s in sched._slots if s is not None)))
        return hit

    eng.injector.draw = logged
    rows = capture_rows(eng, sched) if capture else None
    if submit is not None:
        submit(sched)
    elif open_loop is None:
        for i, p in enumerate(prompts):
            sched.submit(Request(prompt=p, max_new_tokens=NEW_TOKENS,
                                 temperature=temps[i] if temps else 0.0,
                                 seed=i))
    torch.cuda.synchronize()
    for k in kern.values():
        k.launches = 0
    t0 = time.perf_counter()
    if open_loop is not None:
        drive_open_loop(sched, open_loop)
    pending = sorted(arrivals, key=lambda a: a[0])
    steps = 0
    while pending or sched.busy:
        while pending and pending[0][0] <= steps:
            sched.submit(pending.pop(0)[1])
        sched.step()
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: k.launches for n, k in kern.items()}
    _pool_whole(eng, sched, label)
    outs = [sched.outcomes[rid] for rid in sorted(sched.outcomes)]
    n_tok = sum(len(o.tokens) for o in outs)
    print(f"{label}: {len(outs)} requests, {n_tok} tokens in {wall:.3f} s "
          f"wall: {n_tok / wall:.1f} tokens/s (prefill included); faults "
          f"fired {({s: c for s, c in eng.injector.counts.items() if c})}",
          flush=True)
    # a handoff that lost its budget ran the remote forward, then the
    # colocated one: a forward with no prefill tick of its own
    lost = sched.stats.transfer_failures
    return dict(sched=sched, eng=eng, outs=outs,
                streams=[list(o.tokens) for o in outs], rows=rows,
                fired=fired, launches=launches, wall_s=wall, tokens=n_tok,
                tokens_per_s=n_tok / wall,
                prefills=sum(o.prefill_ticks or 0 for o in outs) + lost,
                decode_steps=sched.decode_steps, clock=sched.clock,
                latency=trc.latency_summary())


def _preempted(res):
    return {e.request_id for e in res["eng"].tracer.events
            if e.name == "preempted"}


def _parting(golden, res, rid):
    """Where request ``rid``'s stream parts from the golden run's, and how
    near a tie: both tokens, each run's decision margin between them (the
    sampler's scores) and the row's largest logit difference; None when
    the two streams are the same up to the shorter."""
    a, b = golden["streams"][rid], res["streams"][rid]
    t = next((j for j, (u, w) in enumerate(zip(a, b)) if u != w), None)
    if t is None or golden["rows"] is None or res["rows"] is None:
        return None if t is None else {"token": t}
    ga, temp, key = golden["rows"][(rid, t)]
    rb = res["rows"][(rid, t)][0]
    za = decision_scores(ga, temp, key)
    zb = decision_scores(rb, temp, key)
    return dict(token=t, golden_token=a[t], token_here=b[t],
                temperature=temp,
                golden_margin=float(za[a[t]] - za[b[t]]),
                margin_here=float(zb[b[t]] - zb[a[t]]),
                max_abs_logit_diff=float((ga - rb).abs().max()))


def chaos_contract(golden, res, label, touched=(), strict=False):
    """The reference's degradation contract on a chaos run (its
    ``_check_contract``, ``tests/L0/run_serving/test_faults.py:70-80``):
    every request has an outcome whose reason is in ``FINISH_REASONS``,
    a degraded stream is a golden prefix, and every request no fault
    touched equals the golden stream token for token. A touched request
    that finished ok is held the same with ``strict``; otherwise its
    tokens equal to golden and the margins where it parts are printed
    (a retried request re-prefills its committed tokens through the
    prefill's kernels, not the decode kernel's sums). Returns the
    partings."""
    from apex_tpu_torch.serving import FINISH_REASONS

    outs, gold = res["outs"], golden["streams"]
    check(len(outs) == len(gold)
          and all(o.reason in FINISH_REASONS for o in outs),
          f"{label}: every request has an outcome, reasons "
          f"{sorted({o.reason for o in outs})}")
    bad = [rid for rid, o in enumerate(outs)
           if not o.ok and list(o.tokens) != gold[rid][:len(o.tokens)]]
    check(not bad, f"{label}: every degraded stream a golden prefix "
          f"({sum(not o.ok for o in outs)} degraded)")
    loose = set(touched) if not strict else set()
    diff = [rid for rid, o in enumerate(outs) if o.ok and rid not in loose
            and list(o.tokens) != gold[rid]]
    held = sum(o.ok and rid not in loose for rid, o in enumerate(outs))
    check(not diff, f"{label}: {held} requests{' (every one)' if strict else ' no fault touched'} equal the golden "
          f"streams token for token (differing: {diff})")
    partings = {}
    for rid in sorted(loose):
        if outs[rid].ok:
            part = _parting(golden, res, rid)
            same = sum(u == w for u, w in zip(gold[rid], outs[rid].tokens))
            partings[rid] = dict(tokens_equal=same, tokens=len(gold[rid]),
                                 parting=part)
    if partings:
        print(f"{label}: touched requests (retried, preempted or resident "
              f"at a fault), tokens equal to golden and the margin where "
              f"each parts: {json.dumps(partings)}", flush=True)
    return partings


def _fired(res, sites, label):
    """Each pinned site fired, and its ServingStats counter moved."""
    counts = res["eng"].injector.counts
    stats = res["sched"].stats.as_dict()
    check(all(counts[s] >= 1 and stats[SITE_COUNTERS[s]] >= 1
              for s in sites),
          f"{label}: every pinned site fired: "
          f"{({s: counts[s] for s in sites})}, counters "
          f"{({SITE_COUNTERS[s]: stats[SITE_COUNTERS[s]] for s in sites})}")


def _summary(res):
    return ([(tuple(o.tokens), o.reason, o.retries, type(o.error).__name__,
              o.ttft_ticks, o.total_ticks, o.prefill_ticks)
             for o in res["outs"]], res["sched"].stats.as_dict(),
            res["eng"].injector.counts, res["eng"].tracer.tick_stream())


def _chaos_launches(res, L, label):
    """Exact launches of a monolithic paged run: LN 2L + 1 a forward,
    flash L a prefill forward, the paged attention L a decode tick; the
    sampler's bits as counted."""
    check_launches(res["launches"], {
        "layer_norm_fwd": (2 * L + 1) * (res["prefills"]
                                         + res["decode_steps"]),
        "flash_attention_fwd": L * res["prefills"],
        "paged_decode_attention": L * res["decode_steps"],
        "threefry_bits": res["launches"]["threefry_bits"]}, label)


def serve_chaos(dev, kern, o2, paged_run):
    """``serving_chaos``: the fault tier at GPT-2 medium's full width on
    ``serving_paged``'s engine (O2 bf16, 8 slots, max_len 1024, pages of
    64, EOS -1, 32 new tokens), each configuration's fault-free run in
    this process its golden, every run traced and audited after every
    tick: (a) the prefix mix, half sampled, under :data:`CHAOS_PINNED`
    (bf16 pool, and again over an fp32 pool, where every request must
    equal its golden); (b) chunked at 256, ``chunk_prefill_exec`` once
    mid-prompt and once on a final chunk (two runs, their indices read
    off the golden run); (c) n-gram speculation (``spec_k`` 4, the motif
    mix) with ``draft_exec`` firing; (d) the tiered int8 pool (2 slots, 2
    + 40 pages, a host tier) with ``host_spill`` and ``host_promote``
    firing; (e) three tenants (quotas, priorities, weights, an ITL SLO),
    streams on, ``stream_emit`` at 0.02; (f) a queued and a mid-decode
    request cut by ``deadline_ticks`` and a submit past ``max_queue``;
    (g) (a) again: the same streams, outcomes and tick stream."""
    from apex_tpu_torch.models.gpt import gpt_medium
    from apex_tpu_torch.serving import (
        AdmissionRejected, DeadlineExceeded, PrefixRegistry, Request,
        RetryBudgetExhausted, StreamFailed, Tenant, TenancyPolicy,
    )

    cfg = gpt_medium()
    L = cfg.num_layers
    phase("serving_chaos: the fault tier on the serving_paged engine: "
          "pinned faults at every single-engine site (bf16 and fp32 pools), "
          "chunked, n-gram, tiered int8, three tenants with streams, "
          "deadlines and backpressure, a replay")
    print(f"inert injector at every site: serving_paged in this run "
          f"{paged_run['tokens_per_s']:.1f} tokens/s ({paged_run['wall_s']:.3f}"
          f" s wall), beside {PAGED_BEFORE_FAULTS}; {card_line()}",
          flush=True)
    prompts = prefix_prompts(cfg)
    out, runs, tally = {}, {}, []

    def run(*args, **kw):
        res = chaos_run(dev, cfg, o2, kern, *args, **kw)
        tally.append(res["launches"])
        return res

    with torch.inference_mode():
        # (a), (g): pinned faults, bf16 pool, run twice; fp32 pool
        for name, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            ekw = dict(cache_dtype=dt)
            gold = run(prompts, SPEC_TEMPS,
                       f"(a) golden, {name} pool", capture=True,
                       engine_kw=ekw)
            res = run(prompts, SPEC_TEMPS,
                      f"(a) pinned faults, {name} pool",
                      faults=dict(schedule=CHAOS_PINNED),
                      capture=True, engine_kw=ekw)
            _chaos_launches(gold, L, f"(a) golden, {name} pool")
            _chaos_launches(res, L, f"(a) pinned faults, {name} pool")
            _fired(res, CHAOS_PINNED, f"(a) {name} pool")
            touched = {rid for rid, o in enumerate(res["outs"])
                       if o.retries} | _preempted(res)
            parts = chaos_contract(gold, res, f"(a) {name} pool", touched,
                                   strict=name == "fp32")
            budget = [o for o in res["outs"] if o.reason == "retry_budget"]
            print(f"(a) {name} pool: retries by request "
                  f"{[o.retries for o in res['outs']]}", flush=True)
            check(len(budget) == 1 and isinstance(budget[0].error,
                                                  RetryBudgetExhausted)
                  and budget[0].retries == 4,
                  f"(a) {name} pool: one request ended retry_budget with "
                  f"a RetryBudgetExhausted after 4 retries (max_retries "
                  f"3), {len(budget[0].tokens)} tokens committed before")
            runs[f"a_{name}"] = (gold, res)
            out[f"a_{name}"] = dict(
                golden_tokens_per_s=gold["tokens_per_s"],
                golden_wall_s=gold["wall_s"],
                tokens_per_s=res["tokens_per_s"], wall_s=res["wall_s"],
                counts=res["eng"].injector.counts,
                stats={k: v for k, v in res["sched"].stats.as_dict().items()
                       if v}, touched=sorted(touched), partings=parts,
                reasons=[o.reason for o in res["outs"]])
        replay = run(prompts, SPEC_TEMPS,
                     "(g) the bf16 pinned run again",
                     faults=dict(schedule=CHAOS_PINNED))
        first = runs["a_bf16"][1]
        check(replay["streams"] == first["streams"]
              and _summary(replay) == _summary(first),
              "(g) replay: streams, outcomes (reason, retries, error class, "
              "ticks), stats, injector counts and tracer.tick_stream() the "
              f"same ({len(replay['eng'].tracer.tick_stream())} events)")
        out["g_replay_tokens_per_s"] = replay["tokens_per_s"]
        del runs, replay, first

        # (b) chunked at 256: the golden run's chunk calls pick the indices
        calls = []

        def log_chunks(sched):
            eng = sched.engine
            orig = eng.chunk_prefill

            def logged(slot, chunk, pos, state, bucket, final):
                calls.append((pos != state.get("start", 0), final))
                return orig(slot, chunk, pos, state, bucket, final)

            eng.chunk_prefill = logged
            for i, p in enumerate(prompts):
                sched.submit(Request(prompt=p, max_new_tokens=NEW_TOKENS,
                                     temperature=SPEC_TEMPS[i], seed=i))

        gold = run(prompts, SPEC_TEMPS,
                   "(b) golden, chunked 256", submit=log_chunks,
                   chunk_tokens=CHUNK)
        mid = next(i for i, (inner, final) in enumerate(calls)
                   if inner and not final)
        fin = next(i for i, (_, final) in enumerate(calls) if final)
        out["b_chunked"] = {"golden_tokens_per_s": gold["tokens_per_s"]}
        for where, index in (("mid_prompt", mid), ("final_chunk", fin)):
            res = run(prompts, SPEC_TEMPS,
                      f"(b) chunk_prefill_exec[{index}], {where}",
                      faults=dict(schedule={
                          "chunk_prefill_exec": (index,)}),
                      chunk_tokens=CHUNK)
            _fired(res, ("chunk_prefill_exec",), f"(b) {where}")
            check(res["sched"].stats.retries == 1
                  and res["launches"]["paged_chunk_attention"] > 0,
                  f"(b) {where}: one retry; the chunk kernel launched "
                  f"{res['launches']['paged_chunk_attention']} times")
            # a faulted chunk's request had committed nothing: its retry
            # recomputes the same chunks, so every stream is held
            chaos_contract(gold, res, f"(b) {where}", strict=True)
            out["b_chunked"][where] = dict(
                index=index, tokens_per_s=res["tokens_per_s"],
                launches={n: c for n, c in res["launches"].items() if c})

        # (c) n-gram speculation, draft_exec firing
        spec = spec_prompts(cfg)
        ekw = dict(spec_k=SPEC_K)
        gold = run(spec, SPEC_TEMPS,
                   "(c) golden, n-gram spec_k 4", engine_kw=ekw)
        res = run(spec, SPEC_TEMPS,
                  "(c) draft_exec pinned", engine_kw=ekw,
                  faults=dict(schedule={"draft_exec": (3, 4, 5, 11,
                  40)}))
        _fired(res, ("draft_exec",), "(c)")
        touched = {rid for site, _, resident in res["fired"]
                   for rid in resident}
        check(res["sched"].stats.retries == 0
              and res["launches"]["paged_verify_attention"] > 0,
              f"(c): no retry charged; {res['sched'].stats.spec_ticks} "
              "verify ticks")
        out["c_spec"] = dict(
            tokens_per_s=res["tokens_per_s"],
            golden_tokens_per_s=gold["tokens_per_s"],
            draft_faults=res["sched"].stats.draft_faults,
            touched=sorted(touched),
            partings=chaos_contract(gold, res, "(c)", touched))

        # (d) the tiered int8 pool, host_spill and host_promote firing
        tier = tier_prompts(cfg)[:CHAOS_TIER_REQUESTS]

        def tiered():
            return dict(num_slots=TIER_SLOTS, num_pages=TIER_POOL,
                        cache_dtype=torch.int8,
                        host_tier=PrefixRegistry(1 << 30))

        gold = run(tier, SPEC_TEMPS,
                   "(d) golden, tiered int8 pool", engine_kw=tiered())
        res = run(tier, SPEC_TEMPS,
                  "(d) host_spill[0] and host_promote[0]",
                  engine_kw=tiered(), faults=dict(schedule={
                  "host_spill": (0,), "host_promote": (0,)}))
        gs = gold["sched"].stats
        check(gs.host_spills > 0 and gs.host_promotes > 0,
              f"(d) golden: {gs.host_spills} spills, {gs.host_promotes} "
              "promotes")
        _fired(res, ("host_spill", "host_promote"), "(d)")
        # an int8 pool recomputes a prompt's pages the same whether they
        # were promoted or re-prefilled (serving_paged_tiered's check)
        chaos_contract(gold, res, "(d)", strict=True)
        out["d_tiered"] = dict(
            tokens_per_s=res["tokens_per_s"],
            golden_tokens_per_s=gold["tokens_per_s"],
            stats={k: v for k, v in res["sched"].stats.as_dict().items()
                   if k.startswith("host_")})

        # (e) three tenants, streams on, stream_emit at a rate
        mix = mix_prompts(cfg)
        tenants = ("gold", "silver", "bronze")
        policy = [Tenant("gold", weight=3.0, priority=2),
                  Tenant("silver", weight=2.0, priority=1, page_quota=64),
                  Tenant("bronze", weight=1.0, page_quota=40,
                         itl_slo_ticks=1)]
        untenanted = run(mix, SPEC_TEMPS,
                         "(e) golden, untenanted")

        # silver and bronze at once, gold CHAOS_GOLD_STEP ticks later:
        # gold's higher rung finds the slots full of lower ones
        arrivals = [(CHAOS_GOLD_STEP if i % 3 == 0 else 0,
                     Request(prompt=p, max_new_tokens=NEW_TOKENS,
                             temperature=SPEC_TEMPS[i], seed=i,
                             tenant_id=tenants[i % 3]))
                    for i, p in enumerate(mix)]
        res = run(mix, SPEC_TEMPS,
                  "(e) three tenants, stream_emit at 0.02",
                  submit=lambda sched: None, arrivals=arrivals,
                  faults=dict(seed=0, rates={"stream_emit": 0.02}),
                  tenancy=TenancyPolicy(policy), streams=True)
        _fired(res, ("stream_emit",), "(e)")
        st = res["sched"].stats
        streams = res["sched"].streams.streams
        failed = [rid for rid, s in streams.items() if s.failed]
        check(all(o.ok for o in res["outs"])
              and all(s.closed for s in streams.values())
              and all(isinstance(streams[r].error, StreamFailed)
                      and len(streams[r].delivered)
                      < len(res["outs"][r].tokens)
                      and streams[r].delivered
                      == list(res["outs"][r].tokens)[:len(
                          streams[r].delivered)] for r in failed)
              and all(s.delivered == list(res["outs"][r].tokens)
                      for r, s in streams.items() if not s.failed)
              and len(failed) == st.stream_failures > 0,
              f"(e): every request ok; {len(failed)} streams dropped a "
              "batch (StreamFailed), each a strict prefix of its committed "
              "tokens, the others whole")
        check(st.slo_violations == sum(o.slo is not None
                                       for o in res["outs"]) > 0
              and st.quota_deferrals > 0 and st.tenant_preemptions > 0
              and {o.tenant_id for o in res["outs"]} == set(tenants),
              f"(e): {st.slo_violations} SLO violations stamped (bronze's "
              f"1-tick ITL bound), {st.quota_deferrals} quota deferrals, "
              f"{st.tenant_preemptions} priority preemptions")
        touched = _preempted(res)
        # request ids follow the arrival order; the golden run's, the mix's
        order = [i for _, i in sorted(
            ((CHAOS_GOLD_STEP if i % 3 == 0 else 0, i)
             for i in range(len(mix))), key=lambda a: a[0])]
        gold = dict(untenanted, rows=None,
                    streams=[untenanted["streams"][i] for i in order])
        out["e_tenants"] = dict(
            tokens_per_s=res["tokens_per_s"],
            golden_tokens_per_s=untenanted["tokens_per_s"],
            stream_failures=st.stream_failures,
            quota_deferrals=st.quota_deferrals,
            tenant_preemptions=st.tenant_preemptions,
            slo_violations=st.slo_violations,
            gauges=res["sched"].tenancy.gauge_snapshot(),
            partings=chaos_contract(gold, res, "(e)", touched))

        # (f) deadlines and backpressure
        dl = 1 + sum(len(p) - 1 for p in mix[:NUM_SLOTS]) + 10

        def deadlines(sched):
            for i in range(NUM_SLOTS + 1):
                sched.submit(Request(
                    prompt=mix[i], max_new_tokens=NEW_TOKENS,
                    temperature=SPEC_TEMPS[i], seed=i,
                    deadline_ticks={0: dl, NUM_SLOTS: 2}.get(i)))
            try:
                sched.submit(Request(prompt=mix[9], max_new_tokens=2))
                rejected = False
            except AdmissionRejected:
                rejected = True
            check(rejected, "(f): a submit past max_queue "
                  f"({NUM_SLOTS + 1}) raised AdmissionRejected")

        res = run(mix, SPEC_TEMPS,
                  "(f) deadlines and backpressure", submit=deadlines,
                  max_queue=NUM_SLOTS + 1)
        o, q = res["outs"][0], res["outs"][NUM_SLOTS]
        st = res["sched"].stats
        check(o.reason == "deadline" and isinstance(o.error, DeadlineExceeded)
              and 0 < len(o.tokens) < NEW_TOKENS
              and q.reason == "deadline" and not q.tokens
              and isinstance(q.error, DeadlineExceeded)
              and st.deadline_expired == 2 and st.admission_rejections == 1,
              f"(f): request 0 cut mid-decode at {len(o.tokens)} tokens "
              f"(deadline {dl} ticks), request {NUM_SLOTS} cut queued "
              "with none, one submit refused")
        gold = dict(untenanted, streams=untenanted["streams"][:NUM_SLOTS + 1])
        chaos_contract(gold, res, "(f)")
        _chaos_launches(res, L, "(f)")
        out["f_deadlines"] = dict(cut_at_tokens=len(o.tokens),
                                  deadline_ticks=dl,
                                  tokens_per_s=res["tokens_per_s"])
    launches = {n: sum(r[n] for r in tally) for n in kern}
    check(all(launches[n] > 0 for n in CHAOS_KERNELS)
          and not any(c for n, c in launches.items()
                      if n not in CHAOS_KERNELS),
          f"serving_chaos launched {({n: c for n, c in launches.items() if c})}"
          f": every kernel of its paths, nothing else")
    out["launches"] = launches
    return out


# -- the cross-replica tier ------------------------------------------------

# (c): the open-loop mix's tick-clock readings, the same on any device (the
# clock counts work, not time); tests/test_torch_router.py derives them on
# the CPU from a one-layer model
DISAGG_OPEN_LOOP = {
    "colocated": {"clock": 9506, "ttft_p50": 4930.0, "itl_p99": 3833.554},
    "pair": {"clock": 160, "ttft_p50": 1.727, "itl_p99": 1.724}}
# (d): the 2x2 pool's pinned schedule, every cross-replica site. The first
# handoff's device-to-device reshard loses its budget (reshard_send 0-2) and
# re-ships host-staged, whose first send drops (page_send 0) and first payload
# is corrupt (page_recv 0); the next reshard's payload is corrupt
# (reshard_recv 0); the third remote admission's pick degrades to fixed order
# (pool_route 2); the active decode0 fails its probes at ticks 10 and 11 (the
# probe order prefill0, prefill1, decode0, decode1 a tick: index 4 (t - 1) +
# 2), the slots fail over to decode1 and decode0 climbs back up its ladder
POOL_PINNED = {"reshard_send": (0, 1, 2), "page_send": (0,),
               "page_recv": (0,), "reshard_recv": (0,), "pool_route": (2,),
               "replica_health": (38, 42)}
# both decode replicas fail at ticks 10 and 11: the slots borrow a prefill
# replica, then move home once a decode replica is routable again
POOL_DECODE_DOWN = {"replica_health": (38, 39, 42, 43)}
# the ServingStats counter each fired cross-replica site moves
ROUTE_COUNTERS = {"reshard_send": "reshard_retries",
                  "reshard_recv": "reshard_corrupt",
                  "page_send": "transfer_retries",
                  "page_recv": "transfer_corrupt",
                  "pool_route": "route_fallbacks",
                  "replica_health": "failovers"}
DISAGG_KERNELS = ("layer_norm_fwd", "flash_attention_fwd", "threefry_bits",
                  "paged_decode_attention")
SHIP_PAGES = 8       # (e): one 512-token prompt's pages


def _route_metric(res, name, replicas):
    """A per-replica labeled counter of the run's registry, summed."""
    reg = res["eng"].tracer.registry
    got = [reg.get(name, labels={"replica": r}) for r in replicas]
    return sum(int(g.value) for g in got if g is not None)


def ship_cost(dev, cfg, params):
    """(e): the host-staged channel's cost on the card for one prompt of
    ``SHIP_PAGES`` pages of the ``serving_paged`` engine (bf16 pool):
    wall ms of the device -> host gather, the sha256 and the host ->
    device insert, each timed alone (the stream synchronized around it),
    and of a whole ``PageTransfer.ship`` (gather and two digests); the
    median of 5 repeats after one warm-up, per page. The inserted pages
    must equal the source pages bit for bit."""
    from apex_tpu_torch.serving import (
        PagedDecodeEngine, PageTransfer, prefix_page_keys, transfer_checksum,
    )
    from apex_tpu_torch.serving.transfer import (
        _default_gather, make_extract_pages_fn, make_insert_pages_fn,
    )

    eng = PagedDecodeEngine(params, cfg, num_slots=NUM_SLOTS,
                            max_len=MAX_LEN, num_pages=PAGED_POOL,
                            page_size=PAGE, buckets=BUCKETS, device=dev)
    prompt = list(prefix_prompts(cfg)[0][:SHIP_PAGES * PAGE])
    eng.prefill(0, prompt)
    src = list(eng._slot_pages[0])
    dst = [eng.pool.alloc() for _ in src]
    key = prefix_page_keys(prompt, PAGE)[-1]
    extract, insert = make_extract_pages_fn(), make_insert_pages_fn()
    transfer = PageTransfer(tracer=eng.tracer, stats=eng.stats)
    laps = {"device_to_host": [], "sha256": [], "host_to_device": [],
            "ship": []}
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k, v = _default_gather(*extract(eng.cache, src))
        t1 = time.perf_counter()
        transfer_checksum(k, v, key)
        t2 = time.perf_counter()
        insert(eng.cache, dst, k, v)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        transfer.ship(eng, prompt, src)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for name, t in zip(laps, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            laps[name].append(t)
    check(len(src) == SHIP_PAGES
          and torch.equal(eng.cache.k[:, dst], eng.cache.k[:, src])
          and torch.equal(eng.cache.v[:, dst], eng.cache.v[:, src]),
          f"(e) {len(src)} pages staged through the host and inserted bit "
          "for bit")
    nbytes = k.nbytes + v.nbytes
    out = {f"{n}_ms_per_page": statistics.median(t[1:]) * 1e3 / len(src)
           for n, t in laps.items()}
    out.update(pages=len(src), bytes=int(nbytes), card=card_line(),
               device_to_host_gb_per_s=nbytes / statistics.median(
                   laps["device_to_host"][1:]) / 1e9,
               sha256_gb_per_s=nbytes / statistics.median(
                   laps["sha256"][1:]) / 1e9)
    print(f"(e) the host-staged channel, {len(src)} pages of {PAGE} "
          f"({nbytes / 1e6:.1f} MB of bf16 tiles), ms a page: "
          + ", ".join(f"{n} {out[n + '_ms_per_page']:.3f}" for n in laps)
          + f"; {card_line()}", flush=True)
    return out


def serve_disagg(dev, kern, f32, o2):
    """``serving_disagg``: the cross-replica tier at GPT-2 medium's full
    width, replicas of ``serving_paged``'s engine (O2 bf16 params, one
    tree for all, 8 slots, max_len 1024, pages of 64, ``PAGED_POOL``
    pages, EOS -1) on one card, every run traced and audited every tick,
    each mix's colocated run in this process its golden: (a) a
    ``DisaggregatedRouter`` on the serving mix and the shared-prefix mix,
    half sampled: every stream golden, the prefix mix's handoffs deduped;
    (b) a 2x2 ``PoolRouter`` on both mixes over the reshard tier and once
    host-staged: (a)'s streams, every request queued at tick 0, the
    pool's clock at most the pair's; (c) the pair and the colocated
    scheduler open-loop (:func:`chunked_arrivals`): the same streams, and
    the tick readings :data:`DISAGG_OPEN_LOOP`; (d) the pool under
    :data:`POOL_PINNED` with fp32 params and pool (every stream golden),
    with O2 bf16 params over an fp32 pool and over the bf16 pool (the
    undrained requests golden, the drained ones' equal tokens and margins
    printed: a failover re-prefills their committed tokens through the
    prefill's sums, not the decode ticks', which bf16 compute rounds
    apart), the bf16 run twice (the same outcomes, counters and tick
    stream), and :data:`POOL_DECODE_DOWN` in fp32; (e)
    :func:`ship_cost`."""
    from apex_tpu_torch.models.gpt import gpt_medium
    from apex_tpu_torch.serving import Request

    cfg = gpt_medium()
    L = cfg.num_layers
    phase("serving_disagg: a DisaggregatedRouter pair and a 2x2 PoolRouter "
          "of serving_paged's engine on one card: fault-free against "
          "colocated, open-loop ticks, the router chaos, the host-staged "
          "channel's cost")
    mixes = {"mix": mix_prompts(cfg), "prefix": prefix_prompts(cfg)}
    out, tally = {}, {"pair": [], "pool": [], "colocated": []}

    def run(label, prompts=None, temps=SPEC_TEMPS, route=None,
            params=o2, **kw):
        res = chaos_run(dev, cfg, params, kern, prompts, temps, label,
                        route=route, **kw)
        tally[route or "colocated"].append(res["launches"])
        _chaos_launches(res, L, label)
        return res

    with torch.inference_mode():
        # (a), (b): fault-free, every request queued at tick 0
        gold = {}
        for name, prompts in mixes.items():
            gold[name] = run(f"(a) golden, colocated, {name}", prompts,
                             capture=name == "prefix")
            pair = run(f"(a) pair, {name}", prompts, route="pair")
            pool = run(f"(b) 2x2 pool, {name}", prompts, route="pool")
            runs = {"pair": pair, "pool": pool}
            if name == "mix":
                runs["pool_host_staged"] = run(
                    "(b) 2x2 pool, host-staged, mix", prompts,
                    route="pool", use_reshard=False)
            for rname, res in runs.items():
                st = res["sched"].stats
                check(res["streams"] == gold[name]["streams"]
                      and st.remote_prefills == len(prompts)
                      and st.colocated_prefills == 0,
                      f"{rname}, {name}: every stream the colocated one, "
                      f"{st.remote_prefills} remote prefills")
            check(pool["clock"] <= pair["clock"],
                  f"(b) {name}: the pool's clock {pool['clock']} <= the "
                  f"pair's {pair['clock']} (handoffs from two prefill "
                  "replicas overlap)")
            out[name] = {}
            for rname, res in runs.items():
                st = res["sched"].stats
                reps = (("prefill",) if rname == "pair"
                        else ("prefill0", "prefill1"))
                shipped = sum(_route_metric(res, f"{fam}_src_bytes_total",
                                            reps)
                              for fam in ("serving_transfer",
                                          "serving_reshard"))
                out[name][rname] = dict(
                    remote_prefills=st.remote_prefills,
                    transfers=st.transfers, reshards=st.reshards,
                    pages_deduped=st.transfer_pages_deduped,
                    bytes_shipped=shipped, clock=res["clock"],
                    wall_s=res["wall_s"], tokens_per_s=res["tokens_per_s"])
                print(f"{rname}, {name}: {json.dumps(out[name][rname])}",
                      flush=True)
            out[name]["golden"] = dict(clock=gold[name]["clock"],
                                       wall_s=gold[name]["wall_s"],
                                       tokens_per_s=gold[name][
                                           "tokens_per_s"])
            if name == "prefix":
                check(all(out[name][r]["pages_deduped"] > 0 for r in runs),
                      "(a), (b) prefix mix: pages deduped "
                      f"{[out[name][r]['pages_deduped'] for r in runs]}")
            del runs, pair, pool

        # (c) open-loop tick clock, greedy, no chunking
        prompts = mixes["mix"]

        def arrivals():
            return [(t, Request(prompt=prompts[i], max_new_tokens=NEW_TOKENS,
                                seed=i)) for t, i in chunked_arrivals(cfg)]

        ol = {r: run(f"(c) open loop, {r}", route=None if r == "colocated"
                     else "pair", open_loop=arrivals())
              for r in ("colocated", "pair")}
        ticks = {r: {"clock": res["clock"],
                     "ttft_p50": res["latency"]["ttft_p50"],
                     "itl_p99": res["latency"]["itl_p99"]}
                 for r, res in ol.items()}
        print(f"(c) open loop, tick-clock latency (ticks): "
              f"{json.dumps(ticks)}", flush=True)
        check(ol["pair"]["streams"] == ol["colocated"]["streams"]
              and ticks == DISAGG_OPEN_LOOP
              and ticks["pair"]["itl_p99"] <= ticks["colocated"]["itl_p99"],
              "(c) the pair's streams the colocated ones, and the ticks the "
              "CPU's prediction: inter-token p99 "
              f"{ticks['pair']['itl_p99']} <= {ticks['colocated']['itl_p99']}")
        out["c_open_loop"] = {r: dict(ticks[r], wall_s=res["wall_s"])
                              for r, res in ol.items()}
        del ol

        # (d) the router chaos on the pool
        prompts = mixes["prefix"]
        fp32 = dict(cache_dtype=torch.float32)
        gold32 = run("(d) golden, colocated, fp32", prompts, params=f32,
                     engine_kw=fp32)
        res32 = run("(d) pinned faults, fp32", prompts, route="pool",
                    params=f32, engine_kw=fp32,
                    faults=dict(schedule=POOL_PINNED))
        chaos_contract(gold32, res32, "(d) fp32", strict=True)
        # serving's own O2 bf16 params over the fp32 pool: the undrained
        # requests held, the drained ones' equal tokens and margins printed
        gold_o2 = run("(d) golden, colocated, O2 params, fp32 pool",
                      prompts, engine_kw=fp32, capture=True)
        o2f = run("(d) pinned faults, O2 params, fp32 pool", prompts,
                  route="pool", engine_kw=fp32,
                  faults=dict(schedule=POOL_PINNED), capture=True)
        touched_o2f = _preempted(o2f)
        parts_o2f = chaos_contract(gold_o2, o2f,
                                   "(d) O2 params, fp32 pool", touched_o2f)
        bf = run("(d) pinned faults, bf16 pool", prompts, route="pool",
                 faults=dict(schedule=POOL_PINNED), capture=True)
        touched = _preempted(bf)
        parts = chaos_contract(gold["prefix"], bf, "(d) bf16 pool", touched)
        replay = run("(d) the bf16 pinned run again", prompts,
                     route="pool", faults=dict(schedule=POOL_PINNED))
        check(replay["streams"] == bf["streams"]
              and _summary(replay) == _summary(bf),
              "(d) replay: streams, outcomes, stats, injector counts and "
              f"tracer.tick_stream() the same "
              f"({len(replay['eng'].tracer.tick_stream())} events)")
        for label, res in (("fp32", res32), ("O2 params, fp32 pool", o2f),
                           ("bf16", bf)):
            counts = res["eng"].injector.counts
            st = res["sched"].stats
            health = {n: h.state for n, h in res["sched"].health.items()}
            degrade = [dict(e.args) for e in res["eng"].tracer.events
                       if e.name == "failover"
                       and dict(e.args).get("cause") == "ReshardFailed"]
            check(all(counts[s] >= 1 and getattr(st, c) >= 1
                      for s, c in ROUTE_COUNTERS.items())
                  and st.reshard_failures == 1 and len(degrade) == 1
                  and st.failovers == 1
                  and res["eng"].active_name == "decode1"
                  and health["decode0"] != "down"
                  and st.colocated_prefills == 0,
                  f"(d) {label}: every cross-replica site fired "
                  f"({({s: counts[s] for s in POOL_PINNED})}); one "
                  f"ReshardFailed degraded to host staging; decode0 failed "
                  f"over to decode1 and climbed back ({health['decode0']})")
        down = run("(d) both decode replicas down, fp32", prompts,
                   route="pool", params=f32, engine_kw=fp32,
                   faults=dict(schedule=POOL_DECODE_DOWN))
        chaos_contract(gold32, down, "(d) decode replicas down", strict=True)
        ds = down["sched"].stats
        moves = [dict(e.args) for e in down["eng"].tracer.events
                 if e.name == "rebalance"]
        check(ds.failovers >= 1 and ds.rebalances >= 2
              and any(m["target"].startswith("prefill") for m in moves)
              and down["eng"].active_name in down["eng"].decode_names,
              f"(d) both decode replicas down: the slots moved {moves} "
              "(a prefill replica borrowed, then home)")
        out["d_chaos"] = dict(
            counts=bf["eng"].injector.counts, touched=sorted(touched),
            partings=parts, touched_o2_fp32_pool=sorted(touched_o2f),
            partings_o2_fp32_pool=parts_o2f, moves=moves,
            stats={k: v for k, v in bf["sched"].stats.as_dict().items()
                   if v},
            tokens_per_s=dict(fp32=res32["tokens_per_s"],
                              bf16=bf["tokens_per_s"],
                              o2_fp32_pool=o2f["tokens_per_s"],
                              fp32_golden=gold32["tokens_per_s"]),
            tick_events=len(bf["eng"].tracer.tick_stream()))
        del gold, gold32, res32, gold_o2, o2f, bf, replay, down
        torch.cuda.empty_cache()
        out["e_ship"] = ship_cost(dev, cfg, o2)
    launches = {path: {n: sum(r[n] for r in runs) for n in kern}
                for path, runs in tally.items()}
    for path in ("pair", "pool"):
        got = launches[path]
        check(all(got[n] > 0 for n in DISAGG_KERNELS)
              and not any(c for n, c in got.items()
                          if n not in DISAGG_KERNELS),
              f"serving_disagg's {path} runs launched "
              f"{({n: c for n, c in got.items() if c})}: every kernel of "
              "their path, nothing else")
    out["launches"] = launches
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 20. checkpoints and resume, the spatial tier, RNN, weight norm, ASP and
#     the profiler
# ---------------------------------------------------------------------------

# (a) the imagenet example's kill and resume at its full configuration
RESUME_ARGS = ("-a", f"resnet{RESNET_DEPTH}", "-b", str(RESNET_BIG[0]),
               "--image-size", str(RESNET_BIG[1]), "--num-classes",
               str(RESNET_CLASSES), "--print-freq", "1", "--opt-level", "O2",
               "--flat-kernel", "--lr", str(RESNET_BIG_LR))
RESUME_STEPS, RESUME_KILL = 6, 3
# main_amp's main(argv) in a child process on the card: deterministic
# algorithms when argv[1] is "1"; the kernels' launch counts on a line of
# their own after it returns
_MAIN_AMP = (
    "import json, sys\n"
    "import torch\n"
    "if sys.argv[1] == '1':\n"
    "    torch.use_deterministic_algorithms(True)\n"
    "sys.path.insert(0, sys.argv[2])\n"
    "import chip_smoke\n"
    "from apex_tpu_torch.examples.imagenet.main_amp import main\n"
    "rc = main(sys.argv[3:])\n"
    "print('LAUNCHES ' + json.dumps({n: k.launches for n, k in "
    "chip_smoke.kernel_counters().items()}), flush=True)\n"
    "sys.exit(rc)\n")
# (c) ResNet-50's first identity block (stage 1: 256 channels, bottleneck
# 64, 56 x 56), fp32, and the reference's bounds (rtol = atol)
BN_BATCH, BN_HW, BN_CH, BN_MID = 32, 56, 256, 64
BN_FWD_TOL, BN_DX_TOL = 1e-5, 1e-4
# (d) Radford et al. 2017's byte-level mLSTM (arXiv:1704.01444: 4096
# units, 64-dim byte embedding, 256 steps, batch 128), and a 2-layer
# LSTM with inter-layer dropout
MLSTM_H, MLSTM_E, MLSTM_S, MLSTM_B = 4096, 64, 256, 128
LSTM_H, LSTM_S, LSTM_B, LSTM_DROPOUT = 1024, 128, 64, 0.1
# fp32 against float64 on the card, relative norms: the output over 256
# steps of K-4096 fp32 products (u sqrt(K) ~ 4e-6 a product) and the
# gradients summed over 256 x 128 positions
RNN_F64_LIMITS = {"out": 1e-4, "grads": 1e-3}
# (e) BERT-Large's intermediate dense kernel (in, out); per element
# against float64: fp32 32 u (the norm's sum over 4096 squares, its sqrt,
# a divide and a multiply), a bf16 result its rounding more (half an ulp:
# at most 2^-8 of |w|)
WN_SHAPE = (1024, 4096)
WN_LIMITS = {torch.float32: 2.0 ** -19,
             torch.bfloat16: 2.0 ** -8 + 2.0 ** -19}
WN_GRAD_REL = 1e-5
# (f) masked FusedAdam steps on BERT-Large
ASP_STEPS = 3
# (g) the profiled step: BERT-Large width, 2 layers, O2, batch 8, seq 128;
# each kernel's device symbols in the trace (the LayerNorm backward's
# stage 1 names one launch of its wrapper)
PROF_LAYERS, PROF_BATCH = 2, 8
PROF_SYMBOLS = {"layer_norm_fwd": ("layer_norm_fwd_kernel",),
                "layer_norm_bwd": ("layer_norm_bwd_kernel",),
                "flash_attention_fwd": ("flash_fwd_kernel",
                                        "flash_fwd_tc_kernel"),
                "flash_attention_bwd_dq": ("flash_dq_kernel",
                                           "flash_dq_tc_kernel"),
                "flash_attention_bwd_dkv": ("flash_dkv_kernel",
                                            "flash_dkv_tc_kernel")}


def _excess(got, want, rtol, atol):
    """max(|got - want| - (atol + rtol |want|)): at most 0 where
    ``np.allclose(got, want, rtol, atol)`` holds."""
    g, w = got.detach().double(), want.detach().double()
    return float(((g - w).abs() - (atol + rtol * w.abs())).max())


def _main_amp_run(args, deterministic):
    """``main_amp.main`` in a child process on the card: its printed
    losses by step (as strings), its launch counts, its seconds."""
    import os
    import re

    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    if deterministic:
        env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", _MAIN_AMP,
                        "1" if deterministic else "0", repo, *RESUME_ARGS,
                        *args], cwd=repo, env=env, capture_output=True,
                       text=True, timeout=600)
    secs = time.perf_counter() - t0
    check(r.returncode == 0 and "LAUNCHES " in r.stdout,
          f"main_amp {' '.join(args)}: exit code {r.returncode}"
          + ("" if r.returncode == 0 else
             f"\n{r.stdout[-2000:]}\n{r.stderr[-3000:]}"))
    losses = {int(m.group(1)): m.group(2) for m in re.finditer(
        r"step\s+(\d+)\s+loss (\d+\.\d+)", r.stdout)}
    launches = json.loads(r.stdout.split("LAUNCHES ", 1)[1].splitlines()[0])
    return dict(losses=losses, launches=launches, seconds=secs,
                resumed="resumed from" in r.stdout)


def resume_phase(dev):
    """(a) The imagenet example (``apex_tpu_torch.examples.imagenet.
    main_amp``) at ResNet-50, batch 64, 224 x 224, 1000 classes, O2,
    ``--flat-kernel``, in child processes on the card: 6 straight steps
    with ``--checkpoint``, 3 steps (the kill), then ``--resume`` to 6.
    The two straight runs' common steps (0-2) say whether the card's
    steps repeat; if not, all three run again under
    ``torch.use_deterministic_algorithms(True)`` and
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8``. Steps 3-5's printed losses equal
    as strings; ``flat_sgd`` once a step in each run and
    ``threefry_bits`` three times (the synthetic batch's draws)."""
    import os
    import tempfile

    phase(f"checkpoints (a): main_amp --checkpoint / --resume, ResNet-"
          f"{RESNET_DEPTH}, batch {RESNET_BIG[0]}, {RESNET_BIG[1]} x "
          f"{RESNET_BIG[1]}, O2, --flat-kernel: {RESUME_STEPS} straight "
          f"steps against {RESUME_KILL} and a resume (child processes; "
          f"the printed losses of steps {RESUME_KILL}-{RESUME_STEPS - 1} "
          "equal as strings)")
    with tempfile.TemporaryDirectory() as tmp:
        ck_a, ck_b = os.path.join(tmp, "a.ckpt"), os.path.join(tmp, "b.ckpt")
        straight_args = ["--steps", str(RESUME_STEPS), "--checkpoint", ck_a]
        kill_args = ["--steps", str(RESUME_KILL), "--checkpoint", ck_b]
        det = False
        straight = _main_amp_run(straight_args, det)
        killed = _main_amp_run(kill_args, det)
        repeat = all(killed["losses"][s] == straight["losses"][s]
                     for s in range(RESUME_KILL))
        print(f"two straight runs on the card, steps 0-{RESUME_KILL - 1}: "
              f"{[straight['losses'][s] for s in range(RESUME_KILL)]} and "
              f"{[killed['losses'][s] for s in range(RESUME_KILL)]}: "
              f"{'the same' if repeat else 'they differ'}", flush=True)
        if not repeat:
            det = True
            straight = _main_amp_run(straight_args, det)
            killed = _main_amp_run(kill_args, det)
        nbytes = os.path.getsize(ck_b)
        resumed = _main_amp_run(["--steps", str(RESUME_STEPS),
                                 "--checkpoint", ck_b, "--resume", ck_b],
                                det)
    check(resumed["resumed"] and set(resumed["losses"]) == set(
        range(RESUME_KILL, RESUME_STEPS)),
          f"resumed at step {RESUME_KILL}, printed steps "
          f"{sorted(resumed['losses'])}")
    for s in range(RESUME_KILL, RESUME_STEPS):
        check(resumed["losses"][s] == straight["losses"][s],
              f"step {s}: resumed loss {resumed['losses'][s]} == straight "
              f"{straight['losses'][s]}")
    for name, run, steps in (("straight", straight, RESUME_STEPS),
                             ("killed", killed, RESUME_KILL),
                             ("resumed", resumed,
                              RESUME_STEPS - RESUME_KILL)):
        got = {n: c for n, c in run["launches"].items() if c}
        want = {"flat_sgd": steps, "threefry_bits": 3 * steps}
        check(got == want, f"{name} run: launches {got} = {want}: flat_sgd "
              "once a step, threefry_bits three times (the step's synthetic "
              "batch: normal and randint on its key), no other kernel")
    print(f"checkpoint of ResNet-{RESNET_DEPTH} (master, BatchNorm "
          f"statistics, FusedSGD's flat momentum buffer, scaler state): "
          f"{nbytes} bytes; deterministic algorithms "
          f"{'needed' if det else 'not needed'}; child runs "
          f"{round(straight['seconds'], 1)}, {round(killed['seconds'], 1)}, "
          f"{round(resumed['seconds'], 1)} s", flush=True)
    launches = {n: sum(r["launches"][n] for r in (straight, killed, resumed))
                for n in straight["launches"]}
    return dict(straight_losses=straight["losses"],
                resumed_losses=resumed["losses"], checkpoint_bytes=nbytes,
                deterministic=det, steps_repeat=repeat, launches=launches,
                seconds=[straight["seconds"], killed["seconds"],
                         resumed["seconds"]])


def _bottleneck_run(dev, rank):
    """(g) on this rank: the spatially parallel bottleneck at cp
    ``PP_RANKS`` (each rank half the rows of H) against the unsharded
    block on the whole input, forward and the gradient of x of
    sum(y**2); the halo's host-staged bytes."""
    from apex_tpu_torch.contrib.bottleneck import (
        init_spatial_bottleneck, spatial_bottleneck,
        spatial_parallel_bottleneck,
    )
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.transformer.tensor_parallel import mappings

    P = ps.PartitionSpec
    rows = P(None, ps.CONTEXT_AXIS)

    def grad_of(fn):
        def body(p, x):
            x = x.detach().requires_grad_(True)
            (fn(p, x) ** 2).sum().backward()
            return x.grad
        return body

    ps.initialize_model_parallel(context_parallel_size_=PP_RANKS,
                                 device=dev)
    try:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = init_spatial_bottleneck(gen, BN_CH, BN_MID, device=dev)
        x = torch.randn((BN_BATCH, BN_HW, BN_HW, BN_CH), generator=gen,
                        device=dev)
        mappings.staged_bytes = 0
        _sync(dev)
        t0 = time.perf_counter()
        y_local = ps.shard_map(spatial_parallel_bottleneck,
                               in_specs=(P(), rows), out_specs=P())(params, x)
        fwd_halo = mappings.staged_bytes
        dx_local = ps.shard_map(grad_of(spatial_parallel_bottleneck),
                                in_specs=(P(), rows),
                                out_specs=P())(params, x)
        _sync(dev)
        secs = time.perf_counter() - t0
        halo = mappings.staged_bytes
        y = ps.gather_leaf(y_local, rows)
        dx = ps.gather_leaf(dx_local, rows)
        y_ref = spatial_bottleneck(params, x)
        dx_ref = grad_of(spatial_bottleneck)(params, x)
        out = dict(fwd_excess=_excess(y, y_ref, BN_FWD_TOL, BN_FWD_TOL),
                   dx_excess=_excess(dx, dx_ref, BN_DX_TOL, BN_DX_TOL),
                   fwd_max_abs=float((y - y_ref).abs().max()),
                   dx_max_abs=float((dx - dx_ref).abs().max()),
                   local_rows=y_local.shape[1], halo_bytes_fwd=fwd_halo,
                   halo_bytes=halo, sharded_ms=secs * 1e3)
    finally:
        ps.destroy_model_parallel()
    torch.cuda.empty_cache()
    return out


def rnn_phase(dev, kern):
    """(d) The byte-level mLSTM (one layer, 4096 units, 64-dim
    embedding, 256 steps, batch 128) forward and backward in fp32 against
    the same module in float64 on the card (relative norms
    ``RNN_F64_LIMITS``); then a 2-layer LSTM at hidden 1024 with dropout
    0.1, counts set to 0 before and read after: ``threefry_bits`` once
    (layer 0's keep mask), the mask equal bit for bit to the plain int64
    draw of ``bernoulli(fold_in(key, 0), 0.9)``, and the stack's output
    the bits of its two layers run by hand around that mask."""
    from apex_tpu_torch.RNN import LSTM, mLSTM
    from apex_tpu_torch.utils import prng
    from apex_tpu_torch.utils.tree import tree_map

    phase(f"RNN (d): mLSTM (hidden {MLSTM_H}, embedding {MLSTM_E}, "
          f"{MLSTM_S} steps, batch {MLSTM_B}) forward and backward, fp32 "
          f"against float64 on the card (relative norm: output "
          f"{RNN_F64_LIMITS['out']:g}, gradients "
          f"{RNN_F64_LIMITS['grads']:g}); 2-layer LSTM (hidden {LSTM_H}, "
          f"{LSTM_S} steps, batch {LSTM_B}) with dropout {LSTM_DROPOUT}: the "
          "keep mask bit for bit")
    gen = torch.Generator(device=dev).manual_seed(0)
    model = mLSTM(MLSTM_E, MLSTM_H)
    params = model.init(gen, device=dev)
    table = torch.randn((256, MLSTM_E), generator=gen, device=dev)
    ids = torch.randint(0, 256, (MLSTM_S, MLSTM_B), generator=gen,
                        device=dev)
    xs = table[ids]
    cot = torch.randn((MLSTM_S, MLSTM_B, MLSTM_H), generator=gen,
                      device=dev)

    def run(p, xs, cot):
        p = tree_map(lambda a: a.detach().requires_grad_(True), p)
        xs = xs.detach().requires_grad_(True)
        out, _ = model.apply(p, xs)
        out.backward(cot)
        cell = p[0]["fwd"]
        return out.detach(), [cell[k].grad for k in sorted(cell)] + [xs.grad]

    _sync(dev)
    t0 = time.perf_counter()
    out32, g32 = run(params, xs, cot)
    _sync(dev)
    t32 = time.perf_counter() - t0
    out64, g64 = run(tree_map(lambda a: a.double(), params), xs.double(),
                     cot.double())
    _sync(dev)
    rel_out = _relnorm(out32, out64)
    rel_g = max(_relnorm(a, b) for a, b in zip(g32, g64))
    check(rel_out <= RNN_F64_LIMITS["out"] and rel_g <= RNN_F64_LIMITS[
        "grads"], f"mLSTM fp32 vs float64: output {rel_out:.3g} <= "
          f"{RNN_F64_LIMITS['out']:g}, worst gradient (w_hh, w_ih, w_mhh, "
          f"w_mih, b_hh, b_ih, xs) {rel_g:.3g} <= "
          f"{RNN_F64_LIMITS['grads']:g}; fp32 forward and backward "
          f"{t32 * 1e3:.1f} ms")
    del params, out32, g32, out64, g64, cot
    torch.cuda.empty_cache()

    lstm = LSTM(LSTM_H, LSTM_H, num_layers=2, dropout=LSTM_DROPOUT)
    lp = lstm.init(gen, device=dev)
    xs = torch.randn((LSTM_S, LSTM_B, LSTM_H), generator=gen, device=dev)
    key = prng.PRNGKey(5)
    for k in kern.values():
        k.launches = 0
    _sync(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        out, _ = lstm.apply(lp, xs, dropout_rng=key)
    _sync(dev)
    t_lstm = time.perf_counter() - t0
    launches = {n: k.launches for n, k in kern.items()}
    check(launches["threefry_bits"] == 1 and sum(launches.values()) == 1,
          f"2-layer LSTM with dropout: threefry_bits once (layer 0's keep "
          f"mask), no other kernel "
          f"({ {n: c for n, c in launches.items() if c} })")
    shape = (LSTM_S, LSTM_B, LSTM_H)
    k0 = prng.fold_in(key, 0)
    words = prng.threefry_bits_plain(k0.reshape(1, 2), math.prod(shape), dev)
    keep_plain = prng._scaled(prng._uniform01(words).reshape(shape), 0.0,
                              1.0) < prng._f32(1 - LSTM_DROPOUT).to(dev)
    keep_kernel = prng.bernoulli(k0, 1 - LSTM_DROPOUT, shape, device=dev)
    one = LSTM(LSTM_H, LSTM_H, num_layers=1)
    with torch.no_grad():
        h0, _ = one.apply(lp[:1], xs)
        h0 = h0 * keep_plain / torch.tensor(1 - LSTM_DROPOUT,
                                            dtype=h0.dtype, device=dev)
        by_hand, _ = one.apply(lp[1:], h0)
    check(torch.equal(keep_kernel, keep_plain)
          and torch.equal(out, by_hand),
          f"the keep mask ({int(keep_plain.sum())} of {keep_plain.numel()} "
          "kept) from the threefry_bits kernel equals its plain int64 draw "
          "bit for bit, and the stack's output equals its layers run by "
          "hand around that mask")
    return dict(mlstm=dict(out_rel=rel_out, grads_rel=rel_g,
                           fp32_fwd_bwd_ms=t32 * 1e3),
                lstm=dict(ms=t_lstm * 1e3, kept=int(keep_plain.sum())),
                launches=launches)


def weight_norm_phase(dev):
    """(e) ``compute_weight`` on BERT-Large's (1024, 4096) dense kernel
    with fp32 and bf16 v, per element against the same call in float64
    (``WN_LIMITS`` times |w|); the fp32 gradients of g and v against
    float64 (relative norm ``WN_GRAD_REL``)."""
    from apex_tpu_torch.reparameterization import (
        apply_weight_norm, compute_weight, remove_weight_norm,
    )

    phase(f"weight norm (e): compute_weight on a {WN_SHAPE} BERT-Large "
          f"kernel, fp32 and bf16 v, against float64 (per element "
          f"{WN_LIMITS[torch.float32]:.3g} and "
          f"{WN_LIMITS[torch.bfloat16]:.3g} of |w|)")
    gen = torch.Generator(device=dev).manual_seed(3)
    w = torch.randn(WN_SHAPE, generator=gen, device=dev) * 0.02
    scale = 1.0 + 0.1 * torch.randn((WN_SHAPE[0], 1), generator=gen,
                                    device=dev)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        g, v = apply_weight_norm(w.to(dt))
        g = (g.float() * scale).to(dt)
        got = compute_weight(g, v)
        ref = compute_weight(g.double(), v.double())
        err = (got.double() - ref).abs()
        share = float((err / (WN_LIMITS[dt] * ref.abs()))[ref != 0].max())
        check(got.dtype == dt and share <= 1.0
              and bool((err[ref == 0] == 0).all())
              and torch.equal(remove_weight_norm(g, v), got),
              f"{str(dt)[6:]} v: w in {str(got.dtype)[6:]}, worst |w - "
              f"w64| / ({WN_LIMITS[dt]:.3g} |w64|) {share:.3g} <= 1; "
              "remove_weight_norm the same bits")
        out[str(dt)[6:]] = share
    gq, vq = (t.detach().requires_grad_(True) for t in apply_weight_norm(w))
    gd, vd = (t.detach().double().requires_grad_(True) for t in (gq, vq))
    cot = torch.randn(WN_SHAPE, generator=gen, device=dev)
    compute_weight(gq, vq).backward(cot)
    compute_weight(gd, vd).backward(cot.double())
    rel = max(_relnorm(gq.grad, gd.grad), _relnorm(vq.grad, vd.grad))
    check(rel <= WN_GRAD_REL, f"fp32 gradients of g and v vs float64 "
          f"(relative norm) {rel:.3g} <= {WN_GRAD_REL:g}")
    out["grads_rel"] = rel
    return out


def asp_phase(dev, kern):
    """(f) ASP on BERT-Large's parameter tree: the masks and the
    prunable leaf count; ``ASP_STEPS`` masked
    ``FusedAdam(use_flat_kernel=True)`` steps with counts set to 0
    before and read after (``flat_adam`` once a step), each step's
    params, m and v the bits of ``flat_adam_plain`` on the same masked
    inputs; the pruned slots exactly zero in params, m and v."""
    from apex_tpu_torch.contrib.sparsity import ASP, apply_masks
    from apex_tpu_torch.models.bert import bert_large, init_bert
    from apex_tpu_torch.multi_tensor_apply import flatten as flat
    from apex_tpu_torch.multi_tensor_apply.kernels import (
        adam_hparams, flat_adam_plain,
    )
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.utils.tree import tree_flatten, tree_leaves, tree_map

    phase(f"ASP (f): 2:4 masks on BERT-Large's parameter tree, "
          f"{ASP_STEPS} masked FusedAdam(use_flat_kernel=True) steps "
          "(flat_adam bit for bit against its plain version on the same "
          "masked inputs; pruned slots exactly zero)")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_bert(bert_large(), gen, device=dev)
    n_leaves = len(tree_leaves(params))
    asp = ASP()
    _sync(dev)
    t0 = time.perf_counter()
    masks = asp.compute_sparse_masks(params)
    _sync(dev)
    mask_ms = (time.perf_counter() - t0) * 1e3
    mleaves = tree_leaves(masks)
    prunable = sum(m is not True for m in mleaves)
    kept = sum(int(m.sum()) for m in mleaves if m is not True)
    total = sum(m.numel() for m in mleaves if m is not True)
    check(0 < prunable < n_leaves and 2 * kept == total,
          f"{prunable} of {n_leaves} leaves prunable ({total} weights, "
          f"{kept} kept: half); masks in {mask_ms:.1f} ms")
    params = apply_masks(params, masks)
    opt = FusedAdam(lr=1e-4, weight_decay=0.01, use_flat_kernel=True)
    state = opt.init(params)
    step = asp.wrap_optimizer(opt, masks)
    leaves, treedef = tree_flatten(params)
    spec = flat.make_spec(leaves)
    same = True
    for k in kern.values():
        k.launches = 0
    for i in range(ASP_STEPS):
        grads = tree_map(lambda p: torch.randn(
            p.shape, generator=gen, device=dev) * 1e-3, params)
        gbuf, _ = flat.flatten_tensors(tree_flatten(
            apply_masks(grads, masks))[0], spec)
        pbuf, _ = flat.flatten_tensors(tree_flatten(params)[0], spec)
        hp = adam_hparams(lr=opt.lr, beta1=opt.beta1, beta2=opt.beta2,
                          eps=opt.eps, step=state.step + 1,
                          weight_decay=opt.weight_decay,
                          adam_w_mode=opt.adam_w_mode,
                          bias_correction=opt.bias_correction,
                          grad_scale=1.0, device=dev)
        p_plain, m_plain, v_plain = flat_adam_plain(gbuf, pbuf, state.m,
                                                    state.v, hp)
        want = apply_masks(flat.unflatten_pytree(p_plain, spec, treedef),
                           masks)
        params, state = step(grads, params, state)
        same &= (torch.equal(state.m, m_plain)
                 and torch.equal(state.v, v_plain)
                 and all(torch.equal(a, b) for a, b in zip(
                     tree_leaves(params), tree_leaves(want))))
        del grads, gbuf, pbuf, p_plain, m_plain, v_plain, want
    _sync(dev)
    launches = {n: k.launches for n, k in kern.items()}
    check(launches["flat_adam"] == ASP_STEPS
          and sum(launches.values()) == ASP_STEPS,
          f"flat_adam {launches['flat_adam']} launches = {ASP_STEPS} "
          f"steps, no other kernel "
          f"({ {n: c for n, c in launches.items() if c} })")
    check(same, "each step's params, m and v the bits of flat_adam_plain "
          "on the same masked inputs")
    zero = True
    m_leaves = tree_leaves(flat.unflatten_pytree(state.m, spec, treedef))
    v_leaves = tree_leaves(flat.unflatten_pytree(state.v, spec, treedef))
    for p, m, v, mask in zip(tree_leaves(params), m_leaves, v_leaves,
                             mleaves):
        if mask is not True:
            cut = ~mask
            zero &= bool((p[cut] == 0).all() and (m[cut] == 0).all()
                         and (v[cut] == 0).all())
    check(zero, f"after {ASP_STEPS} steps the pruned slots are exactly 0 "
          "in params, m and v")
    return dict(leaves=n_leaves, prunable=prunable, weights=total,
                mask_ms=mask_ms, launches=launches)


def profiler_phase(dev, kern):
    """(g) One BERT O2 step (BERT-Large width, ``PROF_LAYERS`` layers,
    batch 8, seq 128) traced by ``utils.profiler.trace`` after a step
    outside it (the kernels' libraries load at their first launch):
    ``summarize_trace(device_only=True)`` lists the LayerNorm and flash
    kernels by their device symbols, each count equal to its wrapper's
    launches in the traced step."""
    import dataclasses
    import tempfile

    from apex_tpu_torch.examples.bert.train import make_bert_train_step
    from apex_tpu_torch.models.bert import bert_large
    from apex_tpu_torch.utils.profiler import annotate, summarize_trace, trace

    phase(f"profiler (g): one BERT O2 step (BERT-Large width, {PROF_LAYERS} "
          f"layers, batch {PROF_BATCH}, seq {SEQ}) under "
          "utils.profiler.trace: the trace's kernel counts against the "
          "launch counters")
    cfg = dataclasses.replace(bert_large(), num_layers=PROF_LAYERS)
    step, make_state, (ids, mask) = make_bert_train_step(
        PROF_BATCH, SEQ, cfg, device=dev)
    state = make_state()
    *state, loss = step(*state, ids, mask)
    _sync(dev)
    for k in kern.values():
        k.launches = 0
    with tempfile.TemporaryDirectory() as d:
        with trace(d):
            with annotate("bert_o2_step"):
                *state, loss = step(*state, ids, mask)
        launches = {n: k.launches for n, k in kern.items()}
        rows = summarize_trace(d, top=10 ** 6, device_only=True)
        host = summarize_trace(d, top=10 ** 6, device_only=False)
    counts = {name: sum(r["count"] for r in rows
                        if any(s in r["name"] for s in syms))
              for name, syms in PROF_SYMBOLS.items()}
    device_us = sum(r["total_us"] for r in rows)
    for name in PROF_SYMBOLS:
        check(launches[name] > 0 and counts[name] == launches[name],
              f"trace: {name} {counts[name]} kernels by name = "
              f"{launches[name]} launches counted")
    check(any(r["name"] == "bert_o2_step" for r in host),
          "the annotate range is on the host lanes")
    print(f"profiled step: {len(rows)} device names, {device_us:.1f} us of "
          f"device time in {sum(r['count'] for r in rows)} kernels, copies "
          f"and sets; top: "
          f"{[(r['name'][:40], r['count'], round(r['total_us'], 1)) for r in rows[:5]]}",
          flush=True)
    return dict(counts=counts, device_us=device_us, loss=float(loss),
                launches=launches)


def new_modules_phase(dev, kern):
    """Phase 20: (a) resume, (d) RNN, (e) weight norm, (f) ASP and (g)
    the profiler, each printing its seconds ((b) and (c) run in phase
    17's two ranks); the phase's seconds and the card's name and power
    limit."""
    t0 = time.perf_counter()
    out = dict(resume=resume_phase(dev), rnn=rnn_phase(dev, kern),
               weight_norm=weight_norm_phase(dev), asp=asp_phase(dev, kern),
               profiler=profiler_phase(dev, kern))
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"checkpoint, RNN, weight norm, ASP and profiler phase: "
          f"{secs:.1f} s on {card_line()}", flush=True)
    out["seconds"] = secs
    return out


def norm_times(dev):
    """The LayerNorm kernels in both modes (``ln`` and ``rms``) at the
    JAX benchmark's hidden 1024 and 4096 (``BASELINE.json`` config #2),
    8192 rows, bf16 x, fp32 w (and b), forward and backward, beside
    their plain versions and ``F.layer_norm`` / ``F.rms_norm`` (bf16 w,
    b) and the backward library calls (``native_layer_norm_backward``;
    RMS: ``F.rms_norm``'s autograd, forward + backward minus forward)."""
    ln = kernel_modules()[0]
    phase("times of the LayerNorm kernels, LayerNorm and RMSNorm modes, at "
          "(8192, 1024) and (8192, 4096), bf16 x, fp32 w (device ms per "
          "call, CUDA-graph replays)")
    gen = torch.Generator(device=dev).manual_seed(11)
    bf, f32 = torch.bfloat16, torch.float32
    res = {}
    rows = 8192
    for h in (1024, 4096):
        x = _rand(gen, (rows, h), bf, dev)
        dy = _rand(gen, (rows, h), bf, dev)
        w = _rand(gen, (h,), f32, dev, 0.5, 1.0)
        b = _rand(gen, (h,), f32, dev, 0.3)
        w16, b16 = w.to(bf), b.to(bf)
        for mode in ("ln", "rms"):
            bb = b if mode == "ln" else None
            _, mean, rstd = ln.layer_norm_fwd_plain(x, w, bb, mode, 1e-5)
            n_stats = 2 if mode == "ln" else 1
            n_params = 2 if mode == "ln" else 1
            if mode == "ln":
                lib_f = time_ms(lambda: F.layer_norm(x, (h,), w16, b16, 1e-5))
                lib_b = time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
                    dy, x, [h], mean, rstd, w16, b16, [True, True, True]))
                lib_names = ("F.layer_norm (bf16 w, b)",
                             "native_layer_norm_backward (bf16 w, b)")
            elif hasattr(F, "rms_norm"):
                xg = x.detach().requires_grad_(True)
                wg = w16.detach().requires_grad_(True)
                lib_f = time_ms(lambda: F.rms_norm(x, (h,), w16, 1e-5))

                def fwd_bwd():
                    y = F.rms_norm(xg, (h,), wg, 1e-5)
                    torch.autograd.grad(y, (xg, wg), dy)

                lib_b = max(time_ms(fwd_bwd) - time_ms(
                    lambda: F.rms_norm(xg, (h,), wg, 1e-5)), 0.0)
                lib_names = ("F.rms_norm (bf16 w)", "F.rms_norm autograd "
                             "(fwd + bwd - fwd, bf16 w)")
            else:
                lib_f = lib_b = None
                lib_names = ("F.rms_norm (not in this torch)",) * 2
            _entry(res, f"{mode}_fwd_{h}",
                   time_ms(lambda: ln.layer_norm_fwd_kernel(x, w, bb, mode,
                                                            1e-5)),
                   time_ms(lambda: ln.layer_norm_fwd_plain(x, w, bb, mode,
                                                           1e-5)),
                   lib_f,
                   2 * rows * h * 2 + n_params * h * 4 + n_stats * rows * 4,
                   (8 if mode == "ln" else 5) * rows * h, FP32_FLOPS,
                   f"{mode.upper()} fwd ({rows}, {h}) bf16 x, fp32 w",
                   lib_names[0])
            _entry(res, f"{mode}_bwd_{h}",
                   time_ms(lambda: ln.layer_norm_bwd_kernel(dy, x, w, bb,
                                                            mean, rstd)),
                   time_ms(lambda: ln.layer_norm_bwd_plain(dy, x, w, bb,
                                                           mean, rstd)),
                   lib_b,
                   3 * rows * h * 2 + h * 4 + n_stats * rows * 4
                   + n_params * h * 4,
                   (12 if mode == "ln" else 9) * rows * h, FP32_FLOPS,
                   f"{mode.upper()} bwd ({rows}, {h}) bf16 x, fp32 w",
                   lib_names[1])
    return res


# ---------------------------------------------------------------------------
# 21. the page handoff between two processes (serving/transfer.py's
# channel between rank sets, serving/router.py's RemoteReplica)
# ---------------------------------------------------------------------------

HANDOFF_RANKS = 2
HANDOFF_PROMPTS = 8          # the serving mix's first 8, greedy
HANDOFF_TIMEOUT_S = 600
# name -> the pinned FaultInjector schedule of the run
HANDOFF_CASES = {"fault_free": None,
                 "reshard_send": {"reshard_send": (0,)},
                 "reshard_recv": {"reshard_recv": (0,)},
                 "reshard_exhausted": {"reshard_send": (0, 1, 2)}}
HANDOFF_STATS = ("remote_prefills", "colocated_prefills", "reshards",
                 "reshard_retries", "reshard_corrupt", "reshard_failures",
                 "transfers", "transfer_failures", "transfer_pages_deduped")


def _handoff_cfg():
    from apex_tpu_torch.models.gpt import gpt_medium

    return gpt_medium()


def _handoff_geometry():
    return dict(num_slots=NUM_SLOTS, max_len=MAX_LEN, num_pages=PAGED_POOL,
                page_size=PAGE, buckets=BUCKETS,
                cache_dtype=torch.bfloat16)


def _timed_ship(tier, laps):
    """``tier.ship`` wrapped: the host seconds of each call and the pages
    it was asked to move go to ``laps``."""
    ship = tier.ship

    def timed(src_engine, tokens, src_pages, **kw):
        t0 = time.perf_counter()
        try:
            return ship(src_engine, tokens, src_pages, **kw)
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            laps.append((time.perf_counter() - t0, len(src_pages)))

    tier.ship = timed


def _handoff_rank(rank, tmp, port, device):
    """A rank of :func:`handoff_phase`: the default process group on
    gloo; rank 0 holds the prefill replica (and serves the colocated
    golden first), rank 1 the decode replica, each given a
    ``RemoteReplica`` for the other; one ``PoolRouter`` run a case of
    :data:`HANDOFF_CASES`; results to ``tmp/handoff<r>.json``; a barrier
    before the groups go."""
    import datetime
    import os

    import torch.distributed as dist

    from apex_tpu_torch import amp
    from apex_tpu_torch.models.gpt import init_gpt
    from apex_tpu_torch.serving import (
        ContinuousBatchingScheduler, FaultInjector, PagedDecodeEngine,
        PoolRouter, Request, Tracer,
    )
    from apex_tpu_torch.serving.router import RemoteReplica

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(HANDOFF_RANKS),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", init_method="env://",
        timeout=datetime.timedelta(seconds=HANDOFF_TIMEOUT_S))
    try:
        kern = kernel_counters()
        cfg = _handoff_cfg()
        o2 = amp.initialize("O2", verbosity=0).cast_model(init_gpt(
            cfg, torch.Generator().manual_seed(0), device=dev))
        geo = _handoff_geometry()
        prompts = mix_prompts(cfg)[:HANDOFF_PROMPTS]

        def submit(sched):
            for p in prompts:
                sched.submit(Request(prompt=p, max_new_tokens=NEW_TOKENS))

        out = {"backend": dist.get_backend(), "cases": {}}
        with torch.inference_mode():
            if rank == 0:
                sched = ContinuousBatchingScheduler(PagedDecodeEngine(
                    o2, cfg, device=dev, **geo), eos_id=-1, audit=True)
                submit(sched)
                out["golden"] = sched.run()
                del sched
            for name, schedule in HANDOFF_CASES.items():
                inj, trc = FaultInjector(schedule=schedule), Tracer()
                mine = PagedDecodeEngine(o2, cfg, injector=inj, tracer=trc,
                                         device=dev, **geo)
                other = RemoteReplica(1 - rank, cfg, injector=inj,
                                      tracer=trc, **geo)
                reps = [mine, other] if rank == 0 else [other, mine]
                pool = PoolRouter(reps[:1], reps[1:], -1, audit=True)
                laps = []
                _timed_ship(pool.engine.reshard, laps)
                _timed_ship(pool.engine.transfer, laps)
                submit(pool)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                for k in kern.values():
                    k.launches = 0
                t0 = time.perf_counter()
                streams = pool.run()
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                reg = trc.registry
                shipped = sum(
                    int(g.value) for g in (
                        reg.get(f"serving_{t}_src_bytes_total",
                                labels={"replica": "prefill"})
                        for t in ("reshard", "transfer")) if g is not None)
                out["cases"][name] = dict(
                    streams=streams,
                    stats=pool.stats.as_dict(),
                    counts=dict(inj.counts),
                    names=[e.name for e in trc.events],
                    ticks=trc.tick_stream(),
                    launches={n: k.launches for n, k in kern.items()},
                    decode_steps=pool.decode_steps,
                    sent=dict(pool.engine.wire.sent),
                    shipped_tile_bytes=shipped,
                    ship_s=sum(t for t, _ in laps),
                    ship_pages=sum(n for _, n in laps),
                    wall_s=wall)
                del pool, mine, other
                torch.cuda.empty_cache()
        with open(f"{tmp}/handoff{rank}.json", "w") as fh:
            json.dump(out, fh)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def handoff_phase(dev, kern):
    """Phase 21, the page handoff between two processes: two gloo ranks
    on the one card, the prefill replica (``serving_paged``'s engine at
    GPT-2 medium's full width, O2 bf16, 8 slots, ``PAGED_POOL`` pages of
    64) on rank 0, the decode replica on rank 1, the serving mix's first
    8 prompts greedy, 32 tokens each, through a 1x1 ``PoolRouter`` on
    each rank. Held: every case's streams are the colocated streams of
    the same card and shapes; both ranks' stats, injector counts, event
    names and tick streams equal; the pinned faults land where they
    should (a dropped send retried, a corrupted receive quarantined, an
    exhausted reshard re-shipped host-staged); the prefills' kernels ran
    on rank 0 only and the decode ticks' on rank 1 only, exactly; the
    tile bytes rank 0 sent equal the tiles the runs shipped (re-sends
    included) and the logits bytes one fp32 row a remote prefill. Prints
    the bytes sent between the processes, the host time a shipped page
    takes on each rank, the phase's seconds and the card."""
    import socket
    import tempfile

    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    cfg = _handoff_cfg()
    L = cfg.num_layers
    phase(f"21. the page handoff between two processes: a 1x1 PoolRouter "
          f"over two gloo ranks on the card (prefill replica on rank 0, "
          f"decode replica on rank 1), gpt_medium O2 bf16, {NUM_SLOTS} "
          f"slots, {PAGED_POOL} pages of {PAGE}, the mix's first "
          f"{HANDOFF_PROMPTS} prompts greedy x {NEW_TOKENS} tokens; "
          f"fault-free and under {[n for n in HANDOFF_CASES if n != 'fault_free']}")
    torch.cuda.empty_cache()
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.spawn(_handoff_rank, args=(tmp, port, str(dev)),
                       nprocs=HANDOFF_RANKS, join=False)
        deadline = time.monotonic() + HANDOFF_TIMEOUT_S
        while not ctx.join(timeout=max(deadline - time.monotonic(), 1.0)):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.terminate()
                check(False, f"the two ranks finished within "
                      f"{HANDOFF_TIMEOUT_S} s")
        res = []
        for r in range(HANDOFF_RANKS):
            with open(f"{tmp}/handoff{r}.json") as fh:
                res.append(json.load(fh))
    check(all(r["backend"] == "gloo" for r in res), "two gloo ranks")
    golden = res[0]["golden"]
    vocab_row = cfg.vocab_size * 4
    out = {"card": card_line(), "cases": {}}
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    for name in HANDOFF_CASES:
        a, b = (r["cases"][name] for r in res)
        check(a["streams"] == golden and b["streams"] == golden,
              f"{name}: both ranks' streams are the colocated streams "
              f"({len(golden)} requests)")
        same = all(a[k] == b[k] for k in ("stats", "counts", "names",
                                          "ticks"))
        check(same, f"{name}: both ranks' stats, injector counts, event "
              f"names ({len(a['names'])}) and tick streams equal")
        st = a["stats"]
        remote, local = st["remote_prefills"], st["colocated_prefills"]
        # one pinned fault each: the 1x1 pool's only prefill replica walks
        # down its health ladder when the reshard budget goes (three
        # failed probes), so the next admission is served colocated
        want = {"fault_free": st["reshard_retries"] == 0
                and st["reshards"] == HANDOFF_PROMPTS and local == 0,
                "reshard_send": st["reshard_retries"] == 1
                and st["reshard_corrupt"] == 0 and local == 0,
                "reshard_recv": st["reshard_corrupt"] == 1
                and st["reshard_retries"] == 1 and local == 0,
                "reshard_exhausted": st["reshard_failures"] == 1
                and st["transfers"] >= 1}[name]
        check(want and remote + local == HANDOFF_PROMPTS and remote > 0,
              f"{name}: {({k: st[k] for k in HANDOFF_STATS})}")
        ticks = b["decode_steps"]
        # rank 0 runs the remote prefills (a handoff that lost both tiers
        # ran its forward too), rank 1 the decode ticks and the colocated
        # prefills
        fwd0 = remote + st["transfer_failures"]
        w0 = dict.fromkeys(KERNEL_NAMES, 0)
        w0.update(layer_norm_fwd=fwd0 * (2 * L + 1),
                  flash_attention_fwd=fwd0 * L)
        w1 = dict.fromkeys(KERNEL_NAMES, 0)
        w1.update(layer_norm_fwd=(ticks + local) * (2 * L + 1),
                  flash_attention_fwd=local * L,
                  paged_decode_attention=ticks * L)
        check(a["launches"] == w0 and b["launches"] == w1,
              f"{name}: the remote prefills' kernels on rank 0 only "
              f"({ {k: v for k, v in a['launches'].items() if v} }), the "
              f"{ticks} decode ticks' and {local} colocated prefills' on "
              f"rank 1 only "
              f"({ {k: v for k, v in b['launches'].items() if v} })")
        for r in (a, b):
            for n, c in r["launches"].items():
                launches[n] += c
        sent0, sent1 = a["sent"], b["sent"]
        tiles = sent0.get("tiles", 0)
        rows = sent0.get("logits", 0)
        if name == "fault_free":
            check(tiles == a["shipped_tile_bytes"] > 0,
                  f"{name}: rank 0 sent the shipped tiles' bytes "
                  f"({tiles})")
        else:
            check(tiles >= a["shipped_tile_bytes"] > 0,
                  f"{name}: rank 0 sent the shipped tiles and the "
                  f"re-sends ({tiles} >= {a['shipped_tile_bytes']})")
        check(rows == remote * vocab_row and "tiles" not in sent1,
              f"{name}: {rows} logits bytes sent, one fp32 row of "
              f"{cfg.vocab_size} a remote prefill; rank 1 sent no tile")
        per_page = [r["ship_s"] / max(r["ship_pages"], 1) * 1e3
                    for r in (a, b)]
        print(f"{name}: bytes sent between the processes: rank 0 "
              f"{sent0}, rank 1 {sent1}; tiles + logits rows = "
              f"{tiles + rows}; host ms a shipped page (rank 0 sends, rank "
              f"1 receives) {[round(x, 3) for x in per_page]} over "
              f"{a['ship_pages']} pages; wall s "
              f"{[round(r['wall_s'], 3) for r in (a, b)]}; {card_line()}",
              flush=True)
        out["cases"][name] = dict(
            stats={k: st[k] for k in HANDOFF_STATS}, sent=[sent0, sent1],
            tiles_plus_logits_bytes=tiles + rows,
            shipped_tile_bytes=a["shipped_tile_bytes"],
            ship_ms_per_page=per_page, ship_pages=a["ship_pages"],
            decode_steps=ticks, wall_s=[a["wall_s"], b["wall_s"]],
            launches=[a["launches"], b["launches"]])
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 21: {out['seconds']:.1f} s; {card_line()}", flush=True)
    return out


# ---------------------------------------------------------------------------
# 22. the L1 curves on the card against the port's own fp32 run
# ---------------------------------------------------------------------------

L1_STEPS = 50
L1_BERT_LAYERS, L1_BERT_BATCH, L1_BERT_SEQ = 2, 8, 128
L1_GPT_LAYERS, L1_GPT_BATCH, L1_GPT_SEQ = 2, 4, 128
# ResNet-50 at the reference's lr, each bottleneck's last BatchNorm scale
# zeroed at init (Goyal et al. 2017, arXiv:1706.02677 §5.1): with every
# scale 1 this depth's fixed-batch curve is chaotic (a 1e-6 change of the
# images moves step 8 by 6-9 %, and the fp32 golden rose 3.16 -> 4.76 at
# batch 16 on an H100; PERF.md §6), so no amp curve could track it
L1_RESNET = dict(depth=50, classes=10, batch=32, image=64, steps=8,
                 lr=0.01)
# the int8 eval: prompt, teacher-forced length, cache and pages
L1_EVAL = dict(prompt=64, total=96, s_max=128, page=16, buckets=(64, 128))
L1_RTOL = 0.05                 # tests/L1/test_loss_curve_parity.py
QUANT_EVAL_RTOL = 0.02         # tests/L1/test_quant_eval_parity.py
L1_BERT_CASES = {  # name -> (opt level, m dtype, cast-out)
    "O1": ("O1", torch.float32, False), "O2": ("O2", torch.float32, False),
    "O2 bf16 m": ("O2", torch.bfloat16, False),
    "O2 castout": ("O2", torch.bfloat16, True)}
L1_RESNET_CASES = [("O1", None, "dynamic"), ("O2", True, "dynamic"),
                   ("O2", False, 128.0), ("O3", True, 128.0),
                   ("O3", False, "dynamic")]


def _counted(kern, fn):
    """``fn()``'s result and each kernel's launches while it ran."""
    torch.cuda.synchronize()
    for k in kern.values():
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {n: k.launches for n, k in kern.items()}


def _scaled_launches(per, n, **extra):
    out = {k: v * n for k, v in per.items()}
    for k, v in extra.items():
        out[k] += v
    return out


def l1_bert_curve(dev, cfg, params, opt_level, loss_scale, m_dtype, emit):
    """The reference's ``bert_curve`` on the card: ``L1_STEPS`` steps of
    ``BertTrainStep`` from ``params`` (copied), ``FusedAdam(lr=5e-4,
    weight_decay=0.01)``, batch i ``randint(PRNGKey(10_000 + i))``."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.examples.bert.train import BertTrainStep
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.utils import prng

    h = amp.initialize(opt_level, loss_scale=loss_scale, verbosity=0)
    p = _clone(params)
    opt = FusedAdam(lr=5e-4, weight_decay=0.01, m_dtype=m_dtype,
                    emit_compute_params=emit)
    step = BertTrainStep(cfg, h, opt)
    state = [p, opt.init(p), h.init_state(dev)]
    if emit:
        state.append(h.cast_model(p))
    losses = []
    for i in range(L1_STEPS):
        ids = prng.randint(prng.PRNGKey(10_000 + i),
                           (L1_BERT_BATCH, L1_BERT_SEQ), 0, cfg.vocab_size,
                           device=dev).long()
        mask = torch.ones(ids.shape, dtype=torch.int32, device=dev)
        *state, loss = step(*state, ids, mask)
        losses.append(loss)
    return [float(x) for x in torch.stack(losses).cpu()]


def l1_gpt_curve(dev, cfg, params, compute_dtype, ids):
    """The reference's ``gpt_curve`` on the card: ``L1_STEPS`` steps of
    ``GPTTrainStep`` (``FusedAdam(lr=5e-4, weight_decay=0.01)``) on one
    fixed batch; returns the losses and the trained params."""
    from apex_tpu_torch.examples.gpt.train import GPTTrainStep
    from apex_tpu_torch.optimizers import FusedAdam

    opt = FusedAdam(lr=5e-4, weight_decay=0.01)
    p = _clone(params)
    state = opt.init(p)
    step = GPTTrainStep(cfg, opt, compute_dtype)
    losses = []
    for _ in range(L1_STEPS):
        p, state, loss = step(p, state, ids, ids)
        losses.append(loss)
    return [float(x) for x in torch.stack(losses).cpu()], p


def l1_resnet_curve(dev, params, stats, images, labels, opt_level, kbn,
                    loss_scale):
    """The reference's ``resnet_curve`` on the card (no ``autocast``
    block, as the reference's recipe): cast_model, cast_input,
    value_and_grad with the statistics as aux, FusedSGD(lr=L1_RESNET's,
    momentum=0.9, weight_decay=1e-4) gated on found_inf, apply_if_finite
    on the statistics."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.resnet import apply_resnet, cross_entropy_loss
    from apex_tpu_torch.optimizers import FusedSGD

    depth = L1_RESNET["depth"]
    h = amp.initialize(opt_level, keep_batchnorm_fp32=kbn,
                       loss_scale=loss_scale, verbosity=0)
    master, bn = _clone(params), _clone(stats)
    opt = FusedSGD(lr=L1_RESNET["lr"], momentum=0.9, weight_decay=1e-4)
    state, scaler = opt.init(master), h.init_state(dev)

    def loss_fn(p, bn, x, y):
        logits, new = apply_resnet(p, bn, x, depth, train=True)
        return cross_entropy_loss(logits, y), new

    vg = h.value_and_grad(loss_fn, has_aux=True)
    losses = []
    for _ in range(L1_RESNET["steps"]):
        (loss, new), grads, found_inf, scaler = vg(
            h.cast_model(master), scaler, bn, h.cast_input(images), labels)
        master, state = opt.step(grads, master, state, found_inf=found_inf)
        bn = amp.apply_if_finite(new, bn, found_inf)
        losses.append(loss)
    return [float(x) for x in torch.stack(losses).cpu()]


def _track(name, curve, golden, rtol, atol=0.0, differ=True):
    """The reference's curve contract: finite, within rtol (and atol) of
    the golden at every step, converging, and not the golden's bits."""
    c, g = np.asarray(curve), np.asarray(golden)
    worst = float(np.max(np.abs(c - g) / (atol + rtol * np.abs(g))))
    check(bool(np.all(np.isfinite(c))) and worst <= 1.0,
          f"{name}: every step within rtol {rtol}"
          + (f", atol {atol}" if atol else "") + f" of the fp32 golden "
          f"(worst share of the bound {worst:.3f}; first {c[0]:.5f}, last "
          f"{c[-1]:.5f})")
    check(c[-1] < c[0] - 0.1, f"{name}: converges ({c[0]:.4f} -> "
          f"{c[-1]:.4f})")
    if differ:
        check(bool(np.any(c != g)), f"{name}: not the fp32 curve's bits")
    return worst


def _teacher_forced_nll(dev, cfg, params, seq, *, paged, cache_dtype,
                        quantized):
    """The reference's ``_teacher_forced_rows`` and ``_nll_curve`` at
    :data:`L1_EVAL` on the card: the dense steps or the paged engine."""
    from apex_tpu_torch.serving import (
        PagedDecodeEngine, init_cache, make_decode_fn, make_prefill_fn,
    )

    ev = L1_EVAL
    n0, n1 = ev["prompt"], ev["total"]
    rows = []
    if paged:
        eng = PagedDecodeEngine(params, cfg, num_slots=2,
                                max_len=ev["s_max"],
                                num_pages=2 + 2 * ev["s_max"] // ev["page"],
                                page_size=ev["page"],
                                cache_dtype=cache_dtype,
                                buckets=ev["buckets"], device=dev)
        rows.append(eng.prefill(0, seq[:n0])[0])
        preempted = []
        for t in range(n0, n1):
            preempted += eng.prepare_decode({0: t})
            rows.append(eng.decode([seq[t], 0], [True, False])[0])
        check(not preempted, "the paged eval run preempted nothing")
    else:
        prefill = make_prefill_fn(cfg, quantized=quantized)
        decode = make_decode_fn(cfg, quantized=quantized)
        cache = init_cache(cfg, 2, ev["s_max"], torch.float32, dev)
        cache, logits = prefill(
            params, cache, torch.tensor([seq[:n0]], device=dev),
            torch.ones((n0,), dtype=torch.int32, device=dev), 0)
        rows.append(logits[0])
        for t in range(n0, n1):
            cache, logits = decode(
                params, cache, torch.tensor([seq[t], 0], device=dev),
                torch.tensor([True, False], device=dev))
            rows.append(logits[0])
    r = torch.stack(rows)[:-1].double()
    tgt = torch.tensor(seq[n0:n1], device=dev)
    nll = torch.logsumexp(r, dim=-1) - r[torch.arange(len(tgt)), tgt]
    return nll.cpu().numpy()


def l1_phase(dev, kern):
    """Phase 22, the L1 curves on the card against the port's own fp32
    run (TF32 off: ``build`` turns it off for the matmuls and cuDNN):
    (a) BERT-Large's widths (h 1024, 16 heads, ffn 4096, vocab 30522, seq
    128) at ``L1_BERT_LAYERS`` layers, ``L1_STEPS`` steps: O0 fp32 the
    golden, O1, O2, O2 with a bf16 m and O2 with the cast-out each within
    ``L1_RTOL`` at every step, converging, not its bits; (b) GPT-medium's
    widths at ``L1_GPT_LAYERS`` layers on one fixed batch: bf16 compute
    over fp32 masters against fp32; (c) the ImageNet cross product on
    ResNet-50 (:data:`L1_RESNET`): the five cases against O0 at the
    reference's rtol 0.10 (0.15 at O3), atol 0.02; (d) int8 eval parity
    on (b)'s trained fp32 weights: w8 dense and paged, w8 over the int8
    pool and the int8 pool alone within ``QUANT_EVAL_RTOL`` of the fp32
    rows at every position. Exact launches a run; the phase's seconds
    and the card."""
    import dataclasses

    from apex_tpu_torch.models.bert import bert_large, init_bert
    from apex_tpu_torch.models.gpt import gpt_medium, init_gpt
    from apex_tpu_torch.models.resnet import init_resnet
    from apex_tpu_torch.quant import quantize_params
    from apex_tpu_torch.utils import prng

    t_phase = time.perf_counter()
    phase(f"22. the L1 curves on the card against the port's fp32 run "
          f"(TF32 off): BERT-Large widths at {L1_BERT_LAYERS} layers "
          f"{L1_STEPS} steps (O0 golden; O1, O2, O2 bf16 m, O2 castout), "
          f"GPT-medium widths at {L1_GPT_LAYERS} layers (bf16 over fp32), "
          f"the ResNet-{L1_RESNET['depth']} cross product, int8 eval "
          "parity")
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32,
          "TF32 off for the matmuls and cuDNN")
    out = {"card": card_line(), "launches": {}}
    launches = dict.fromkeys(KERNEL_NAMES, 0)

    def tally(path, got, want):
        check(got == want, f"{path}: exact launches "
              f"{ {k: v for k, v in got.items() if v} }")
        for n, c in got.items():
            launches[n] += c
        out["launches"][path] = got

    # (a) BERT
    bcfg = dataclasses.replace(bert_large(), num_layers=L1_BERT_LAYERS)
    bparams = init_bert(bcfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    per = per_step_launches("flash_tree", L1_BERT_LAYERS)
    bert_want = _scaled_launches(per, L1_STEPS, threefry_bits=2 * L1_STEPS)
    golden, got = _counted(kern, lambda: l1_bert_curve(
        dev, bcfg, bparams, "O0", 1.0, torch.float32, False))
    tally("l1_bert_O0", got, bert_want)
    check(golden[-1] < golden[0] - 0.1, f"BERT O0 golden converges "
          f"({golden[0]:.4f} -> {golden[-1]:.4f})")
    out["bert"] = {"O0": golden}
    worst = {}
    for name, (level, m_dtype, emit) in L1_BERT_CASES.items():
        curve, got = _counted(kern, lambda: l1_bert_curve(
            dev, bcfg, bparams, level, "dynamic", m_dtype, emit))
        tally(f"l1_bert_{name.replace(' ', '_')}", got, bert_want)
        worst[name] = _track(f"BERT {name}", curve, golden, L1_RTOL)
        out["bert"][name] = curve
    out["bert_worst_share"] = worst
    del bparams
    # (b) GPT
    gcfg = dataclasses.replace(gpt_medium(), num_layers=L1_GPT_LAYERS)
    gparams = init_gpt(gcfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    ids = prng.randint(prng.PRNGKey(30_000), (L1_GPT_BATCH, L1_GPT_SEQ), 0,
                       gcfg.vocab_size, device=dev).long()
    gper = gpt_per_step_launches(L1_GPT_LAYERS, gcfg.remat, False, False)
    (fp32, trained), got = _counted(kern, lambda: l1_gpt_curve(
        dev, gcfg, gparams, None, ids))
    tally("l1_gpt_fp32", got, _scaled_launches(gper, L1_STEPS))
    check(fp32[-1] < fp32[0] - 0.1, f"GPT fp32 converges ({fp32[0]:.4f} "
          f"-> {fp32[-1]:.4f})")
    (bf16, _), got = _counted(kern, lambda: l1_gpt_curve(
        dev, gcfg, gparams, torch.bfloat16, ids))
    tally("l1_gpt_bf16", got, _scaled_launches(gper, L1_STEPS))
    out["gpt"] = {"fp32": fp32, "bf16": bf16,
                  "bf16_worst_share": _track("GPT bf16 over fp32 masters",
                                             bf16, fp32, L1_RTOL)}
    del gparams
    # (d) int8 eval parity on (b)'s trained fp32 weights
    ev = L1_EVAL
    seq = [int(t) for t in ids[0, :ev["total"]].tolist()]
    qp = quantize_params(trained)
    with torch.inference_mode():
        gold_nll, got = _counted(kern, lambda: _teacher_forced_nll(
            dev, gcfg, trained, seq, paged=False, cache_dtype=None,
            quantized=False))
        # the GPT curve trains labels = ids (the reference's recipe:
        # position t's target is its own token), so the next-token rows
        # of this eval sit above the uniform floor once (b) has learned
        # its batch; the parity below compares the same rows either way
        check(bool(np.all(np.isfinite(gold_nll))),
              f"int8 eval: the fp32 rows finite (mean NLL "
              f"{gold_nll.mean():.4f}; the uniform floor ln V "
              f"{math.log(gcfg.vocab_size):.4f})")
        forwards = ev["total"] - ev["prompt"] + 1
        ticks = forwards - 1
        Lg = L1_GPT_LAYERS
        out["quant"] = {"fp32_mean_nll": float(gold_nll.mean())}
        for name, p, paged, cdt, q in (
                ("w8_dense", qp, False, None, True),
                ("w8_paged", qp, True, torch.float32, True),
                ("w8_kv8", qp, True, torch.int8, True),
                ("kv8_only", trained, True, torch.int8, False)):
            nll, got = _counted(kern, lambda: _teacher_forced_nll(
                dev, gcfg, p, seq, paged=paged, cache_dtype=cdt,
                quantized=q))
            rel = float(np.max(np.abs(nll - gold_nll) / np.abs(gold_nll)))
            check(bool(np.all(np.isfinite(nll))) and rel <= QUANT_EVAL_RTOL
                  and bool(np.any(nll != gold_nll)),
                  f"int8 eval {name}: every position within "
                  f"{QUANT_EVAL_RTOL} of the fp32 rows (worst {rel:.3g}), "
                  "not their bits")
            check(got["w8_matmul"] == (4 * Lg * forwards if q else 0)
                  and got["w8_matmul_nk"] == (forwards if q else 0)
                  and got["paged_decode_attention"] == (
                      Lg * ticks if paged else 0)
                  and got["layer_norm_fwd"] == (2 * Lg + 1) * forwards,
                  f"int8 eval {name}: launches "
                  f"{ {k: v for k, v in got.items() if v} }")
            for n, c in got.items():
                launches[n] += c
            out["launches"][f"l1_quant_{name}"] = got
            out["quant"][name] = rel
    del trained, qp
    torch.cuda.empty_cache()
    # (c) the ImageNet cross product
    rn = L1_RESNET
    rparams, rstats = init_resnet(torch.Generator(device=dev).manual_seed(0),
                                  rn["depth"], rn["classes"], device=dev)
    for block in rparams.values():
        if isinstance(block, dict) and "bn3" in block:
            block["bn3"]["scale"].zero_()
    key = prng.PRNGKey(7_000)
    images = prng.normal(key, (rn["batch"], rn["image"], rn["image"], 3),
                         device=dev)
    labels = prng.randint(key, (rn["batch"],), 0, rn["classes"],
                          device=dev).long()
    zero = dict.fromkeys(KERNEL_NAMES, 0)
    rgold, got = _counted(kern, lambda: l1_resnet_curve(
        dev, rparams, rstats, images, labels, "O0", None, 1.0))
    tally("l1_resnet_O0", got, zero)
    check(rgold[-1] < rgold[0] - 0.1, f"ResNet O0 golden converges "
          f"({rgold[0]:.4f} -> {rgold[-1]:.4f})")
    out["resnet"] = {"O0": rgold}
    for level, kbn, ls in L1_RESNET_CASES:
        name = f"{level} kbn={kbn} loss_scale={ls}"
        curve, got = _counted(kern, lambda: l1_resnet_curve(
            dev, rparams, rstats, images, labels, level, kbn, ls))
        tally(f"l1_resnet_{level}_{kbn}_{ls}", got, zero)
        out["resnet"][name] = curve
        out["resnet"][name + " worst_share"] = _track(
            f"ResNet {name}", curve, rgold, 0.15 if level == "O3" else 0.10,
            atol=0.02, differ=level != "O1")
    del rparams, rstats
    torch.cuda.empty_cache()
    out["launches_total"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 22: {out['seconds']:.1f} s; {card_line()}", flush=True)
    return out


def lint_phase():
    """Phase 23, the port's lint (the AST and determinism tiers of
    ``apex_tpu_torch.lint``) where there is no JAX: clean over the port,
    its tests and this script; then one seeded APX801 bug in a scratch
    copy of the scheduler, which must give exactly that finding."""
    import glob
    import os
    import tempfile

    from apex_tpu_torch.lint.engine import lint_paths

    phase("23. the port's lint on the card's machine: the AST and "
          "determinism tiers over the port, its tests and this script, "
          "then one seeded APX801 bug (the preemption requeue over a set)")
    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    paths = [os.path.join(here, "apex_tpu_torch"),
             os.path.abspath(__file__)] + sorted(glob.glob(
                 os.path.join(here, "tests", "test_torch_*.py")))
    findings, n_files = lint_paths(paths, determinism=True)
    for f in findings:
        print(f.render())
    check(not findings and n_files > 200,
          f"apxlint clean over {n_files} files (determinism tier on)")
    check("jax" not in sys.modules, "the lint ran with no jax imported")
    t_repo = time.perf_counter() - t0
    with open(os.path.join(here, "apex_tpu_torch", "serving",
                           "scheduler.py")) as fh:
        src = fh.read()
    anchor = ("for i in sorted(preempted, key=lambda j: self._slots[j]."
              "request_id,\n                        reverse=True):")
    check(src.count(anchor) == 1, "the requeue loop to seed is there once")
    line = src[:src.index(anchor)].count("\n") + 1
    with tempfile.TemporaryDirectory() as tmp:
        serving = os.path.join(tmp, "serving")
        os.makedirs(serving)
        dst = os.path.join(serving, "scheduler.py")
        with open(dst, "w") as fh:
            fh.write(src)
        base, _ = lint_paths([dst], determinism=True)
        check(base == [], "the scratch scheduler lints clean")
        with open(dst, "w") as fh:
            fh.write(src.replace(anchor, "for i in set(preempted):"))
        seeded, _ = lint_paths([dst], determinism=True)
    for f in seeded:
        print("seeded: " + f.render().replace(tmp, "<tmp>"))
    check([(f.code, f.line) for f in seeded] == [("APX801", line)],
          f"the seeded set requeue gives exactly APX801 at line {line}")
    out = {"files": n_files, "seconds_repo": t_repo,
           "seconds": time.perf_counter() - t0,
           "seeded": [f"{f.code} scheduler.py:{f.line}" for f in seeded]}
    print(f"phase 23: {n_files} files in {t_repo:.2f} s, "
          f"{out['seconds']:.2f} s with the seeded bug; {card_line()}",
          flush=True)
    return out


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        line = out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else ""
    except (OSError, subprocess.TimeoutExpired):
        line = ""
    return line or f"{torch.cuda.get_device_name(0)}, power limit not read"


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script runs on a CUDA device", file=sys.stderr)
        return 2
    try:
        ln, fa, xent, fsm, mta, w8, prng, pa = kernel_modules()
    except ImportError as e:
        print(f"chip_smoke: cannot import apex_tpu_torch ({e}); run it "
              "from the root of the repository", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} ({card}); torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t_start = time.perf_counter()
    build([ln.LIB, fa.LIB, xent.LIB, fsm.LIB, mta.LIB, w8.LIB, prng.LIB,
           pa.LIB])
    err = {"layer_norm_fwd": ln_parity(dev),
           "flash_attention_fwd": flash_parity(dev),
           "layer_norm_bwd": ln_bwd_parity(dev)}
    flash_keep_masks(dev)
    fb = flash_bwd_parity(dev)
    xe = xent_parity(dev)
    sm = softmax_parity(dev)
    sa = flat_scale_axpby_parity(dev)
    lb = flat_lamb_parity(dev)
    err.update(w8_parity(dev))
    err.update(flash_attention_bwd_dq=fb["dq"],
               flash_attention_bwd_dkv=fb["dkv"], xentropy_fwd=xe["fwd"],
               xentropy_bwd=xe["bwd"], scaled_masked_softmax_fwd=sm["fwd"],
               scaled_upper_triang_softmax_fwd=sm["causal"],
               fused_softmax_bwd=sm["bwd"], flat_adam=flat_adam_parity(dev),
               flat_scale=sa["scale"], flat_axpby=sa["axpby"],
               flat_l2norm_partials=lb["l2"], flat_lamb_stage1=lb["stage1"])
    sf = sgd_family_parity(dev)
    err.update(flat_sgd=sf["flat_sgd"], flat_adagrad=sf["flat_adagrad"],
               flat_novograd=sf["flat_novograd"])
    err.update(threefry_parity(dev))
    samp = sampler_parity(dev)
    gk = gpt_kernel_parity(dev)
    for name, key in (("flash_attention_fwd", "fwd"),
                      ("flash_attention_bwd_dq", "dq"),
                      ("flash_attention_bwd_dkv", "dkv"),
                      ("xentropy_fwd", "xent_fwd"),
                      ("xentropy_bwd", "xent_bwd")):
        err[name] = max(err[name], gk[key])
    rope = rope_parity(dev)
    err["paged_decode_attention"] = paged_parity(dev)
    chunk_err = chunk_verify_parity(dev)
    err["paged_verify_attention"] = max(paged_verify_parity(dev),
                                        verify_past_max_k1(dev),
                                        chunk_err["fp32"])
    err["paged_chunk_attention"] = chunk_err["bf16"]
    kern = kernel_counters()
    torch.cuda.empty_cache()
    srv, dense_streams = serve(dev, kern)
    srv_rope = serve_rope(dev, kern)
    srv_paged, params_f32, params_o2 = serve_paged(dev, kern, dense_streams)
    srv_prefix = serve_paged_prefix(dev, kern, params_o2)
    srv_kv8 = serve_paged_kv8(dev, kern, params_f32, params_o2)
    srv_spec = serve_spec(dev, kern, params_f32, params_o2)
    srv_tier = serve_tiered(dev, kern, params_o2)
    srv_chunk = serve_chunked(dev, kern, params_o2)
    srv_chaos = serve_chaos(dev, kern, params_o2, srv_paged)
    srv_disagg = serve_disagg(dev, kern, params_f32, params_o2)
    del params_f32, params_o2
    torch.cuda.empty_cache()
    small = train_small(dev)
    gpt_small = gpt_train_small(dev)
    big = train_big(dev, kern)
    gpt_big = gpt_train_big(dev, kern)
    rn_small = resnet_small(dev)
    rn_big = resnet_big(dev, kern)
    opt = opt_steps(dev, kern)
    opt_args = opt_step_args(dev, kern)
    o1_small = train_small_o1(dev)
    o1 = train_o1(dev, kern)
    larc = resnet_larc(dev, kern)
    fp16 = fp16_optimizer_run(dev, kern)
    ddp1 = ddp_world_one(dev, kern)
    ddp2 = ddp_two_ranks(dev)
    tpar = tensor_parallelism(dev, kern)
    ppcp = pipeline_context_parallelism(dev, kern)
    tps = tensor_parallel_serving(dev, kern)
    mha = multihead_attn_phase(dev, kern)
    mods = new_modules_phase(dev, kern)
    hand = handoff_phase(dev, kern)
    l1 = l1_phase(dev, kern)
    lint = lint_phase()
    pre = pretrain_defaults(dev)
    tm = times(dev)
    tm.update(train_times(dev))
    tm.update(norm_times(dev))
    tm.update(step_times(dev))
    tm.update(flat_times(dev))
    tm.update(w8_times(dev))
    tm.update(tps_row21_times(dev))
    tm.update(sgd_family_times(dev))
    tm.update(threefry_times(dev))
    tm.update(gpt_times(dev))
    tm.update(ulysses_times(dev))
    tm.update(paged_times(dev))
    tm.update(verify_times(dev))
    tm.update(chunk_times(dev))
    by_path = {n: {"serving": srv["bf16"]["launches"][n],
                   "serving_w8": srv["w8"]["launches"][n],
                   "serving_sampled": srv["sampled"]["launches"][n],
                   "serving_rope": srv_rope["launches"][n],
                   "serving_paged": srv_paged["launches"][n],
                   "serving_paged_prefix": (
                       srv_prefix["roomy"]["launches"][n]
                       + srv_prefix["tight"]["launches"][n]),
                   "serving_paged_kv8": srv_kv8["launches"][n],
                   "serving_paged_tiered": sum(
                       srv_tier[r]["launches"][n]
                       for r in ("roomy", "no_tier", "int8", "bf16")),
                   **{f"serving_{k}": srv_chunk[k]["launches"][n]
                      for k in ("paged_chunked", "paged_monolithic",
                                "dense_chunked", "dense_monolithic")},
                   "serving_chaos": srv_chaos["launches"][n],
                   "serving_disagg": srv_disagg["launches"]["pair"][n],
                   "serving_pool": srv_disagg["launches"]["pool"][n],
                   "serving_disagg_colocated": (
                       srv_disagg["launches"]["colocated"][n]),
                   "training_dropout": big["fp32 dropout"]["launches"][n],
                   "training_ddp_world1": ddp1["launches"][n],
                   "gpt_tp1": tpar["tp1"]["launches"][n],
                   **{f"gpt_tp2{'_sp' if k == 'sp' else ''}": sum(
                       r[n] for r in tpar["tp2"][k]["launches"])
                      for k in ("no_sp", "sp")},
                   "gpt_pp1_nccl": ppcp["pp1"]["launches"][n],
                   **{f"gpt_{k}": sum(r[n] for r in ppcp[k]["launches"])
                      for k in ("pp2", "pp2_vpp2", "cp_ring",
                                "cp_ulysses")},
                   **{f"serving_tp1_{m}": tps["tp1"][m]["launches"][n]
                      for m in TPS_MODES},
                   **{f"serving_tp2_{m}": sum(
                       r[n] for r in tps["tp2"][m]["launches"])
                      for m in TPS_MODES},
                   **{f"multihead_attn_{k}": mha[k]["launches"][n]
                      for k in ("self", "encdec")},
                   "resnet_resume": mods["resume"]["launches"][n],
                   "rnn_lstm_dropout": mods["rnn"]["launches"][n],
                   "asp_bert_large": mods["asp"]["launches"][n],
                   "profiled_bert_step": mods["profiler"]["launches"][n],
                   "serving_handoff": hand["launches"][n],
                   **{path: got[n] for path, got in l1["launches"].items()}}
               for n in kern}
    for name, e in mha["errors"].items():
        err[name] = max(err[name], e)
    for name, res in gpt_big.items():
        for n in kern:
            by_path[n][name] = res["launches"][n]
    for name in ("plain", "ngram", "model", "tree", "adaptive", "kv8", "w8",
                 "ngram_k64"):
        path = "serving_spec" + ("" if name == "plain" else f"_{name}")
        for n in kern:
            by_path[n][path] = srv_spec[name]["launches"][n]
    for cfg_name in STEP_CONFIGS:
        path = _key(cfg_name, "training").replace(" ", "_")
        for n in kern:
            by_path[n][path] = sum(
                big[_key(cfg_name, m)]["launches"][n]
                for m in ("fp32", "bf16m_castout"))
    for n in kern:
        for name, res in rn_big.items():
            by_path[n][name] = res["launches"][n]
        by_path[n]["optimizer_steps_bert_large"] = sum(
            res["launches"].get(n, 0) for res in opt.values())
        by_path[n]["optimizer_step_args_bert_large"] = sum(
            res["launches"].get(n, 0) for res in opt_args.values())
        by_path[n]["training_o1"] = o1["O1"]["launches"][n]
        by_path[n]["training_o1_softmax_flat"] = \
            o1["O1 softmax_flat"]["launches"][n]
        by_path[n]["resnet_larc"] = larc["launches"][n]
        by_path[n]["fp16_optimizer"] = fp16["launches"][n]
    rows = [  # name, source, replaces (TPU kernel file:line), times key
        ("layer_norm_fwd", "layer_norm.cu",
         "normalization/fused_layer_norm.py:76", "ln_1024x1024"),
        ("layer_norm_bwd", "layer_norm.cu",
         "normalization/fused_layer_norm.py:107", "ln_bwd"),
        ("flash_attention_fwd", "flash_attention.cu",
         "transformer/functional/flash_attention.py:239",
         "flash_b1h16s1024d64"),
        ("flash_attention_bwd_dq", "flash_attention.cu",
         "transformer/functional/flash_attention.py:330", "flash_dq"),
        ("flash_attention_bwd_dkv", "flash_attention.cu",
         "transformer/functional/flash_attention.py:395", "flash_dkv"),
        ("xentropy_fwd", "xentropy.cu", "contrib/xentropy.py:38",
         "xent_fwd"),
        ("xentropy_bwd", "xentropy.cu", "contrib/xentropy.py:85",
         "xent_bwd"),
        ("scaled_masked_softmax_fwd", "fused_softmax.cu",
         "transformer/functional/fused_softmax.py:49", "softmax_fwd"),
        ("scaled_upper_triang_softmax_fwd", "fused_softmax.cu",
         "transformer/functional/fused_softmax.py:55", "softmax_causal"),
        ("fused_softmax_bwd", "fused_softmax.cu",
         "transformer/functional/fused_softmax.py:65", "softmax_bwd"),
        ("flat_adam", "multi_tensor.cu",
         "multi_tensor_apply/kernels.py:187", "flat_adam"),
        ("flat_scale", "multi_tensor.cu", "multi_tensor_apply/kernels.py:72",
         "flat_scale"),
        ("flat_axpby", "multi_tensor.cu",
         "multi_tensor_apply/kernels.py:107", "flat_axpby"),
        ("flat_l2norm_partials", "multi_tensor.cu",
         "multi_tensor_apply/kernels.py:146", "flat_l2norm"),
        ("flat_lamb_stage1", "multi_tensor.cu",
         "multi_tensor_apply/kernels.py:287", "flat_lamb_stage1"),
        ("w8_matmul_nobias", "w8_matmul.cu", "quant/kernels.py:96",
         "w8_matmul_nobias_m8"),
        ("w8_matmul", "w8_matmul.cu", "quant/kernels.py:85", "w8_matmul_m8"),
        ("w8_matmul_nk", "w8_matmul.cu", "quant/kernels.py:104",
         "w8_matmul_nk_m8"),
        ("flat_sgd", "multi_tensor.cu", "multi_tensor_apply/kernels.py:216",
         "flat_sgd_resnet50"),
        ("flat_adagrad", "multi_tensor.cu",
         "multi_tensor_apply/kernels.py:401", "flat_adagrad"),
        ("flat_novograd", "multi_tensor.cu",
         "multi_tensor_apply/kernels.py:459", "flat_novograd"),
    ]
    kernels = [dict(name=name, route="cuda",
                    source=f"apex_tpu_torch/csrc/{src}",
                    replaces=f"apex_tpu/{rep}",
                    launches=sum(by_path[name].values()),
                    launches_by_path=by_path[name],
                    max_abs_err=err[name], **tm[key])
               for name, src, rep, key in rows]
    # port kernels with no Pallas counterpart: the JAX package draws these
    # bits through jax.random, which XLA expands into integer ops
    kernels += [dict(
        name=name, route="cuda", source="apex_tpu_torch/csrc/threefry.cu",
        replaces=rep, tpu_row=None, launches=sum(by_path[name].values()),
        launches_by_path=by_path[name], max_abs_err=err[name], **tm[key],
        **{k: tm[x] for k, x in extra.items()}, note=note)
        for name, rep, key, extra, note in (
            ("threefry_bits",
             "jax/_src/prng.py:1184 (_threefry_random_bits_partitionable; "
             "the sampler's jax.random.categorical, "
             "apex_tpu/serving/sampling.py:70)", "threefry_bits_8x50304",
             {"at_bert_hidden_one_key": "threefry_bits_hidden"},
             "threefry2x32-20 words, one key a row (the decode tick's 8 "
             "slots), 20 rounds of add, funnel shift and xor in registers; "
             "bound by the integer ALU's funnel shifts and xors"),
            ("threefry_dropout",
             "apex_tpu/models/bert.py:149 (_maybe_dropout: x * "
             "jax.random.bernoulli(key, 1 - rate, x.shape) / (1 - rate))",
             "threefry_dropout_hidden",
             {"at_unfused_probs": "threefry_dropout_probs"},
             "the mask's bits, uniform and compare in registers, never "
             "stored; the backward regenerates it from the key (a second "
             "launch on the gradient); 16-byte loads and stores"))]
    kernels[KERNEL_NAMES.index("scaled_upper_triang_softmax_fwd")].update(
        redesigned=True,
        note="the masked forward's kernel with the causal mask k > q from "
        "the 32-bit query; on no model path: reached only through "
        "FusedScaleMaskSoftmax(attn_mask_type=causal); held to its plain "
        "version and timed at (16, 1024, 1024) bf16")
    for name in ("flat_scale", "flat_axpby"):
        kernels[KERNEL_NAMES.index(name)]["note"] = (
            "on no model path; the JAX package reaches them only from its "
            "lint tiers (apex_tpu/lint/traced/registry.py:1234-1237)")
    w8_design = (
        "one launch at M <= 8 (x fp32 or bf16): a gemv whose last block of "
        "a column strip, by an integer arrival counter, sums the K parts "
        "in part order (no float atomics; the counters reset by that "
        "block, so CUDA-graph replays find them zero); bf16 x at M > 8 on "
        "the tensor cores: mma.sync.m16n8k16 bf16 -> fp32 over 64 x 64 "
        "tiles, 16-byte cp.async rings, the int8 weights kept int8 in "
        "shared memory and widened in registers after ldmatrix.trans, "
        "y = s_n * sum_k x q + b (exact products, one scale multiply); fp32 "
        "x at M > 8 keeps the CUDA-core tile")
    kernels[KERNEL_NAMES.index("w8_matmul_nobias")].update(
        redesigned=True, note=w8_design + "; its path is the int8 "
        "tensor-parallel serving steps (launches_by_path serving_tp*_w8): "
        "the Row-parallel linear before its all-reduce "
        "(apex_tpu/serving/decode.py:880); main time at K 4096, N 1024, "
        "at_tp2_* at tp 2's out (K 512) and fc2 (K 2048) into N 1024 with "
        "fp32 x (the path's) and bf16 x",
        **{f"at_tp2_{name}_{dt}_x": tm[f"w8_matmul_nobias_tp2_{name}_{dt}"]
           for name in TPS_ROW21 for dt in ("float32", "bfloat16")})
    kernels[KERNEL_NAMES.index("w8_matmul")].update(redesigned=True,
                                                    note=w8_design)
    for k in (kernels[KERNEL_NAMES.index(n)] for n in (
            "w8_matmul_nobias", "w8_matmul", "w8_matmul_nk")):
        # the w8 rows: times at M 8, and M 1024 here
        k.update(at_m1024=tm[k["name"] + "_m1024"],
                 library_call=tm["w8_library"])
        # rows 21-22 also at the smallest prefill bucket, row 23 at a
        # prefill's M 1 (the logits of its last real token)
        extra = "_m1" if k["name"] == "w8_matmul_nk" else "_m128"
        k["at" + extra] = tm[k["name"] + extra]
    kernels[KERNEL_NAMES.index("w8_matmul_nk")].update(
        redesigned=True,
        note="bf16 x at M <= 8 on the tensor cores with the operands "
        "swapped: y^T = Wq . x^T by mma.sync.m16n8k16 bf16 -> fp32, 16 "
        "output channels the A rows, x's rows (zeros past M) the 8 B "
        "columns; each lane reads 16 contiguous bytes of each of its two "
        "int8 rows (coalesced, a stage of 256 bytes a row ahead of its "
        "use), widens them in registers without conversion instructions, "
        "and takes x's bf16 pairs at the same permuted k from a copy "
        "staged once a block in shared memory; y = s_n * sum_k x q; K "
        "not split (no scratch, no counters), a contiguous run of "
        "16-channel tiles a block, two blocks an SM; fp32 x keeps the "
        "CUDA-core gemv, M > 8 the CUDA-core tile")
    kernels[KERNEL_NAMES.index("xentropy_bwd")].update(
        redesigned=True,
        note="rebuilt for the bytes: a persistent grid (SMs x the blocks an "
        "SM holds) walking the rows with no barrier, each row's label, lse "
        "and dloss read once, a row ahead; 16-byte streaming loads (4 "
        "vectors a thread in flight) and stores from a 256-byte block of "
        "the row, a scalar head and tail around them; 32-bit columns; the "
        "label column patched in its one vector; an ignored row a zero "
        "stream; the parent's operations in its order (the same bits)")
    kernels[KERNEL_NAMES.index("scaled_masked_softmax_fwd")].update(
        redesigned=True,
        note="rebuilt for the bytes: a block's rows share one (batch, "
        "head) from the grid (no per-row 64-bit division), the row held "
        "in registers in 16-byte vectors, the mask's values of a vector "
        "read in one load where its key stride is 1, one correctly "
        "rounded reciprocal of the row sum and a multiply a score")
    kernels[KERNEL_NAMES.index("layer_norm_fwd")].update(
        redesigned=True,
        note="built for the bytes: a team of 32-1024 threads a row, 8 "
        "columns a thread up to 2^21 elements and 32 beyond, 16-byte loads "
        "of x, w and b and stores of y, the row held in registers from the "
        "load to the store (one read of device memory), warp shuffles and, "
        "for a team of several warps, the warps' sums in warp order; "
        "element loads where h or a row base is not aligned",
        at_8x1024=tm["ln_8x1024"], at_8192x1024_fp32_w=tm["ln_fwd_train"],
        at_8192x1024_fp32_x=tm["ln_fwd_train_fp32"],
        **{f"at_8192x{h}_{mode}": tm[f"{mode}_fwd_{h}"]
           for h in (1024, 4096) for mode in ("ln", "rms")})
    kernels[KERNEL_NAMES.index("flat_sgd")].update(
        at_bert_large=tm["flat_sgd_bert"],
        bf16_buf_castout=tm["flat_sgd_resnet50_bf16buf_castout"])
    design = ("mma.sync.m16n8k16 bf16 tensor cores (fp32 accumulators), "
              "ldmatrix fragments, 16-byte cp.async double-buffered tiles "
              "(element loads where rows are not 16-byte aligned); fp32 "
              "keeps the CUDA-core kernel")
    kernels[KERNEL_NAMES.index("flash_attention_fwd")].update(
        redesigned=True, note=design,
        at_bert_views=tm["flash_fwd_train"],
        at_gpt_views=tm["flash_b1h16s1024d64_gpt_views"])
    kernels[KERNEL_NAMES.index("flash_attention_bwd_dkv")].update(
        redesigned=True, note=design)
    kernels[KERNEL_NAMES.index("flash_attention_bwd_dq")].update(
        redesigned=True, note=design + "; one block a 64-row q tile, S = "
        "q~ K^T and dP = do V^T in registers, ds packed in place as the A "
        "fragment of dq += dS K (K through ldmatrix.trans); each dq "
        "element written once, no atomics")
    kernels[KERNEL_NAMES.index("layer_norm_bwd")].update(
        redesigned=True,
        note="two stages built for the bytes: stage 1 one 512-thread block "
        "an SM (grid from the SM count), a team of 32-512 threads a row, "
        "16-byte loads of dy and x and stores of dx, the row held in "
        "registers between the statistics and dx passes with the next "
        "row in flight, c1/c2 by warp shuffles and the team's named "
        "barrier, one fp32 partial row of dgamma and of dbeta a block; "
        "stage 2 sums the partial rows per column in a fixed order with "
        "coalesced 128-byte reads; no float atomics",
        at_2048x4096=tm["ln_bwd_4096"],
        at_8192x1024_fp32_x=tm["ln_bwd_fp32"],
        **{f"at_8192x{h}_{mode}": tm[f"{mode}_bwd_{h}"]
           for h in (1024, 4096) for mode in ("ln", "rms")})
    # GPT-medium's training step (gpt_tp_bench's tp=1 shape): the
    # LayerNorm's (8192, 1024) bf16 x, fp32 w and the dropout's 8.4M bf16
    # elements are the BERT step's shapes, timed above
    for name, key in (("layer_norm_fwd", "ln_fwd_train"),
                      ("layer_norm_bwd", "ln_bwd"),
                      ("flash_attention_fwd", "gpt_flash_fwd"),
                      ("flash_attention_bwd_dq", "gpt_flash_dq"),
                      ("flash_attention_bwd_dkv", "gpt_flash_dkv"),
                      ("xentropy_fwd", "gpt_xent_fwd"),
                      ("xentropy_bwd", "gpt_xent_bwd"),
                      ("flat_adam", "gpt_flat_adam")):
        kernels[KERNEL_NAMES.index(name)]["at_gpt_train"] = tm[key]
    kernels[KERNEL_NAMES.index("threefry_dropout")]["at_gpt_train"] = \
        tm["threefry_dropout_hidden"]
    # Ulysses' whole-sequence flash calls (b 2, h 8, s 2048, d 64)
    for name, key in (("flash_attention_fwd", "ulysses_flash_fwd"),
                      ("flash_attention_bwd_dq", "ulysses_flash_dq"),
                      ("flash_attention_bwd_dkv", "ulysses_flash_dkv")):
        kernels[KERNEL_NAMES.index(name)]["at_ulysses"] = tm[key]
    for name in ("flat_adagrad", "flat_novograd"):
        kernels[KERNEL_NAMES.index(name)]["note"] = (
            "on no model path of the JAX package: driven through its "
            "optimizer's flat step on BERT-Large's parameter set "
            "(launches_by_path optimizer_steps_bert_large)")
    # a port kernel with no Pallas counterpart: the JAX package runs this
    # attention as XLA (apex_tpu/models/gpt.py:403 and :951)
    kernels.append(dict(
        name="paged_decode_attention", route="cuda",
        source="apex_tpu_torch/csrc/paged_attention.cu",
        replaces="apex_tpu/models/gpt.py:403 (_paged_decode_attention) and "
        ":951 (_paged_decode_attention_q8), XLA gathers of each slot's "
        "block-table row", tpu_row=None,
        launches=sum(by_path["paged_decode_attention"].values()),
        launches_by_path=by_path["paged_decode_attention"],
        max_abs_err=err["paged_decode_attention"], **tm["paged_ab"],
        at_ab_kv8=tm["paged_ab_kv8"],
        at_serving_paged=tm["paged_serving_paged"], redesigned=True,
        note="library_ms is SDPA on K and V already gathered to (b, nh, S, "
        "hd) bf16 with the s <= pos mask: a different function (it leaves "
        "out the gather); times at the JAX package's paged A/B "
        "configuration (bench.py:1324, 32 slots, S_max 512, page 64, "
        "lengths 32..512), one layer; " + PAGED_DESIGN))
    # the slice's kernel: the verify steps of the paged engine; the JAX
    # package runs this attention as XLA (apex_tpu/models/gpt.py:537,
    # :816 and :1004)
    kernels.append(dict(
        name="paged_verify_attention", route="cuda",
        source="apex_tpu_torch/csrc/paged_attention.cu",
        replaces="apex_tpu/models/gpt.py:537 (_paged_verify_attention), "
        ":816 (_paged_tree_verify_attention) and :1004 "
        "(_paged_verify_attention_q8), XLA gathers of each slot's "
        "block-table row", tpu_row=None,
        launches=sum(by_path["paged_verify_attention"].values()),
        launches_by_path=by_path["paged_verify_attention"],
        max_abs_err=err["paged_verify_attention"], **tm["verify_ab_k5"],
        at_ab_k1=tm["verify_ab_k1"],
        at_serving_spec_k5=tm["verify_serving_spec_k5"],
        at_serving_spec_k1=tm["verify_serving_spec_k1"], redesigned=True,
        note="k1 queries a slot (5 in the main time: spec_k 4), any k1: "
        "one launch up to 64 queries, past that one launch a slice of "
        "verify_slices (serving_spec_ngram_k64: k1 65, two); library_ms is "
        "SDPA on K and V already gathered to (b, nh, S, hd) bf16 with the "
        "same per-query mask: a different function (it leaves out the "
        "gather); the decode step is its k1 = 1 instance, and column j of "
        "a linear verify gives the decode kernel's bits at pos + j; an "
        "fp32 prompt chunk is a linear window of k1 = the chunk, one slot, "
        "through its gather row (a bf16 chunk: paged_chunk_attention); "
        + PAGED_DESIGN))
    # the chunked prefill's attention over a bf16 pool; the JAX package
    # runs it as XLA (apex_tpu/models/gpt.py:659)
    kernels.append(dict(
        name="paged_chunk_attention", route="cuda",
        source="apex_tpu_torch/csrc/paged_attention.cu",
        replaces="apex_tpu/models/gpt.py:659 "
        "(_paged_chunk_prefill_attention), an XLA gather of the slot's "
        "block-table row", tpu_row=None,
        launches=sum(by_path["paged_chunk_attention"].values()),
        launches_by_path=by_path["paged_chunk_attention"],
        max_abs_err=err["paged_chunk_attention"], **tm["chunk_pos768"],
        **{f"at_pos{p}": tm[f"chunk_pos{p}"] for p in (0, 256, 512)},
        launches_per_prompt_chunk=srv_chunk["paged_chunked"][
            "chunk_launches_per_chunk"],
        note=f"one slot's chunk of {CHUNK} bf16 queries at pos 768 (at_pos*: "
        "0, 256, 512), one layer's call; one launch over a (64-query tile, "
        "part, head, slot) grid, mma.sync.m16n8k16 bf16 -> fp32 for q k^T "
        "and for P V with p split into bf16 hi + lo (two products into one "
        "fp32 accumulator), 16-byte cp.async rows through the gather row "
        "into a double-buffered ring, the walk over the rows cut into up "
        "to chunk_splits parts combined in part order by the last to "
        "arrive; library_ms is SDPA on K and V already gathered to (b, "
        "nh, S, hd) with the same mask: a different function (it leaves "
        "out the gather); splits1_ms the kernel in one part; "
        "verify_route_ms the verify kernel's slices, the route before"))
    check(all(sum(by_path[n].values()) > 0 for n in KERNEL_NAMES
              if n not in OFF_PATH),
          "every kernel of a path launched on that path")
    for key in ("ln_8x1024", "ln_fwd_train", "ln_bwd_4096",
                "ln_fwd_train_fp32", "ln_bwd_fp32",
                "flash_fwd_train", "flash_b1h16s1024d64_gpt_views",
                "flat_adam_bf16m_castout",
                "flat_lamb_stage1_bf16m", "flat_sgd_bert_bf16buf_castout",
                "w8_matmul_m1024", "w8_matmul_m128",
                "w8_matmul_nobias_m1024", "w8_matmul_nobias_m128",
                "w8_matmul_nk_m1024", "w8_matmul_nk_m1",
                "threefry_bits_hidden", "threefry_dropout_probs"):
        print(f"{key}: {json.dumps(tm[key])}")
    print(f"sampler parity: {json.dumps(samp)}")
    print(f"serving: {json.dumps(srv)}")
    print(f"training, card vs CPU: {json.dumps(small)}")
    print(f"training, BERT-Large: {json.dumps(big)}")
    print(f"ResNet, card vs CPU: {json.dumps(rn_small)}")
    print(f"ResNet-50 training: {json.dumps(rn_big)}")
    print(f"optimizer steps on BERT-Large's parameter set: "
          f"{json.dumps(opt)}")
    print(f"optimizer step arguments: {json.dumps(opt_args)}")
    print(f"training O1, card vs CPU: {json.dumps(o1_small)}")
    print(f"training_o1, BERT-Large: {json.dumps(o1)}")
    print(f"resnet_larc: {json.dumps(larc)}")
    print(f"fp16_optimizer: {json.dumps(fp16)}")
    for key in ("gpt_flash_fwd", "gpt_flash_dq", "gpt_flash_dkv",
                "gpt_xent_fwd", "gpt_xent_bwd", "gpt_flat_adam"):
        print(f"{key}: {json.dumps(tm[key])}")
    print(f"RoPE: {json.dumps(rope)}")
    print(f"serving_rope: {json.dumps(srv_rope)}")
    print(f"serving_paged: {json.dumps(srv_paged)}")
    print(f"serving_paged_prefix: {json.dumps(srv_prefix)}")
    print(f"serving_paged_kv8: {json.dumps(srv_kv8)}")
    for key in ("paged_ab", "paged_ab_kv8", "paged_serving_paged",
                "verify_ab_k1", "verify_ab_k5", "verify_serving_spec_k1",
                "verify_serving_spec_k5", "chunk_pos0", "chunk_pos256",
                "chunk_pos512", "chunk_pos768"):
        print(f"{key}: {json.dumps(tm[key])}")
    print(f"serving_spec: {json.dumps(srv_spec)}")
    print(f"serving_paged_tiered: {json.dumps(srv_tier)}")
    print(f"serving_chunked: {json.dumps(srv_chunk)}")
    print(f"serving_chaos: {json.dumps(srv_chaos)}")
    print(f"serving_disagg: {json.dumps(srv_disagg)}")
    print(f"GPT training, card vs CPU: {json.dumps(gpt_small)}")
    print(f"GPT-medium training: {json.dumps(gpt_big)}")
    print(f"pretrain_gpt losses: {json.dumps(pre)}")
    print(f"DDP world 1 (NCCL): {json.dumps(ddp1)}")
    print(f"DDP two gloo ranks on the card: {json.dumps(ddp2)}")
    print(f"tensor parallelism: {json.dumps(tpar)}")
    for key in ("ulysses_flash_fwd", "ulysses_flash_dq", "ulysses_flash_dkv"):
        print(f"{key}: {json.dumps(tm[key])}")
    print(f"pipeline and context parallelism: {json.dumps(ppcp)}")
    print(f"tensor-parallel serving: {json.dumps(tps)}")
    print(f"multihead_attn: {json.dumps(mha)}")
    print(f"checkpoints, RNN, weight norm, ASP, profiler: {json.dumps(mods)}")
    print(f"the page handoff between two processes: {json.dumps(hand)}")
    print(f"the L1 curves on the card: {json.dumps(l1)}")
    print(f"the port's lint on the card's machine: {json.dumps(lint)}")
    for key in (f"{mode}_{d}_{h}" for mode in ("ln", "rms")
                for d in ("fwd", "bwd") for h in (1024, 4096)):
        print(f"{key}: {json.dumps(tm[key])}")
    phase("results")
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
