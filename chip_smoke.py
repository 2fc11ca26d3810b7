#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``realhf_tpu_torch``) on the GPU.

    python3 chip_smoke.py [--out results.json]

Phases, all run every time (each prints one JSON line; any failure
exits non-zero):

1. device  -- the card's name and power limit, PyTorch and CUDA versions.
2. build   -- compiles every CUDA kernel of the port from this checkout.
3. kernels -- each kernel against its plain PyTorch version on the card,
   in bf16, at the main paths' shapes and at GQA / hd 64 / ragged /
   empty-row / non-causal shapes: max abs error, and the largest error
   of an output row over that row's RMS beside its limit. Planted
   faults must exceed the limits: a decode call with the newest slot of
   each stream dropped (K4), a decode merge with one warp's partial left
   out, the backward with delta taken as 0 (K3), the
   forward (K1) and the backward (K2 and K3) held against the plain
   version on segment boundaries shifted by one token. K1's and K2/K3's
   cases include the edges of their tile skipping: ids that recur out of
   order, one segment over many tiles then short ones, rows whose first q
   tiles are all padding; each prints the (query, key) pairs the kernel
   walks (``visited_key_tiles``; K3 ``visited_q_tiles``) beside the pairs
   the mask allows. Two launches of K2 and K3 must give the same bits.
   K1 and K2/K3 with a sliding window: the Mistral-7B prefill shape (B 1,
   L 8192, one segment, GQA 32/8, window 4096; timed, SDPA with the same
   boolean mask beside it), a packed stream with a ragged last tile at
   window 300, and a window of 24 (less than a tile) at hd 64; each
   prints the pairs walked beside the pairs allowed, two launches must
   give the same bits, a window of L the windowless launch's bits, and at
   window 24 the kernels with a window one key wider must exceed the
   limits.
   K4/K5 cases (gen and GQA shapes, B 1, a sliding window, a stream
   kept only in its last tile, interior holes, a stacked-cache layer, the
   inflight slots' masks over a gathered window of S 384) run twice (the
   same bits); K1 also at batch 1 over the serving prefill buckets 64,
   256 and 512; each prints the slots of the tiles walked
   beside the slots kept. Timed K4/K5 cases rotate over >= 200 MB of
   layer caches and queue the launches ahead of the device
   (``queued_ms``), for the kernel and the library call alike.
   Then each kernel's time, the plain version's time, one PyTorch
   library call's time (``scaled_dot_product_attention`` with the same
   boolean mask, forward or backward, a yardstick only) and the least
   time the card could take (bound).
   K6 (``ring_attention``) against ``ring_attention_plain`` (fp32 on the
   card) over members on ``member_devices(n)`` (cuda:0..3 on a machine of
   four cards, else all on cuda:0): at the ctx-7b-c4 stream (n 4, lc
   8192; timed; planted faults: member 1 skipping round 1, local in place
   of global offsets), GQA 8/2 at hd 64 with ragged tiles, non-causal, a
   sliding window, unidirectional, n 2, n 8, one member and ids that
   recur out of order across shards; each prints the pairs the kernel
   walks over the whole ring (``visited_key_tiles`` on global offsets)
   beside the pairs the mask allows. The library
   yardstick is SDPA over the gathered stream with the same boolean mask.
   Then the push kernel alone at the ctx path's halves (bit-exact).
4. main    -- the ``gen`` experiment through the port's
   ``GenerationConfig.build()`` and ``InlineRunner`` at full LLaMA-7B
   width and depth (random weights from the seed, integer tokenizer,
   8 prompts of 100-512 words per batch, 128 new tokens): two greedy
   steps, then one sampled step (top-k 50, top-p 0.9). Checks that the
   flash-forward kernel ran once per layer per step and flash-decode once
   per layer per decode step, and that the outputs are in range.
5. deep    -- the same experiment on a 49-layer model of 7B width, the
   depth at which decoding reads the stacked KV cache through the
   decode kernel's stacked-cache entry.
6. profile -- a torch.profiler trace of one 7B generate call (8 prompts,
   16 new tokens): kernel time and device busy share of prefill and of
   a decode step, and the kernels by time. Reports, never fails.
7. sft     -- the ``sft`` experiment through ``SFTConfig.build()`` and
   ``InlineRunner`` at LLaMA-7B width, 8 layers, bf16, gradient
   checkpointing on: 16 prompt-answer records (100-400 words each side)
   in 2 microbatches of one ~4 k-token stream, 3 epochs, lr 1e-5 (at
   1e-4 the loss rises on step 3; phase sft_lr), eval on the same file
   after the third. Checks that every step's loss is
   finite and below the one before, that step 1 gave every layer of
   every parameter leaf a finite, non-zero gradient, and the launch
   counts: K2 = K3 = 8 layers x 2 microbatches x 3 steps, K1 twice that
   (forward and checkpoint recompute) plus 8 per eval batch.
8. sft_profile -- a torch.profiler trace of one more sft step:
   device time of K1/K2/K3, GEMMs and the rest, and the optimizer step's time.
   Reports, never fails.
   sft_lr -- the same cell at lr 1e-4: 3 steps of the port (bf16, the
   kernels) and of a plain reference on the card (fp32 weights, compute
   and optimizer, attention through ``packed_attention_plain``) from the
   same initial weights and batch. Each step's loss must agree; the lr
   1e-5 trajectory of phase sft must not.
9. parity  -- 7B width, 2 layers, 2 prompts: prefill and 8 greedy decode
   steps through the port on the card (kernels, bf16) and on the CPU
   (plain versions, fp32) from the same weights; logits must agree. The
   LM head on bf16 hidden states must return fp32 sums, not bf16-rounded
   ones.
10. train_parity -- three SFT steps at lr 1e-4 on the card (bf16,
   kernels) and on the CPU (fp32, plain versions) from the same bf16
   weights and two microbatches (2 layers, hidden 1024, 8 heads of 128,
   FFN 2816, vocab 32000, ~510 tokens): step 1's loss, grad norm and the
   cosine similarity (in fp64) of every layer's slice of every gradient
   leaf, and the loss of steps 2-3, within limits; the same check with
   layer 1's wq/wk/wv gradients zeroed must fail them.

11. ppo    -- the ``ppo`` experiment through ``PPOConfig.build()`` and
   ``InlineRunner`` at LLaMA-7B width, 4 layers for each of actor,
   critic, ref and reward, bf16, gradient checkpointing on: 2 steps of
   16 prompts (100-512 words), up to 128 sampled new tokens (top-p 0.9,
   top-k 200, temperature 1, the logits mask kept), 4 minibatches per
   train MFC, lr 1e-5. Checks that all six MFCs ran on both steps, every
   stat is finite, tokens are in range and inside their logits mask,
   each step's first-minibatch importance weight and approximate KL are
   within their limits (the packed forward reproduces the decode path's
   log-probs), the versions advanced, and the launch counts, derived
   from the configuration and the decode steps taken: per step K1 = 4L
   + 2 x N x 2L, K2 = K3 = 2 x N x L, K4 = L x decode steps (L layers, N
   minibatches). Seconds per MFC (the script times ``host.execute``
   between device synchronisations), per step, tokens per second and
   the allocator's peak are reported. Then one step of a second runner
   with ``auto_offload``: ref and reward report ``offloaded``, the
   allocated device memory fell by their bytes, and their bits come back.
12. ppo_profile -- one more step, each MFC under torch.profiler: device
   time by MFC and by kernel class (K1-K4, GEMMs, the rest), the busy
   share, the optimizer steps' time. Reports, never fails.
   kernels (ppo shapes) -- K1-K4 against their plain versions, with the
   limits and planted faults of phase 3, at the segment matrices the
   ppo path's packer made: the prefill of 16 left-padded prompts, the
   ~6 k-token stream of 16 sequences of the three inference MFCs, the
   longest 4-sequence minibatch stream (forward and backward), and
   decode at 16 streams.
13. ppo_parity -- 2 layers, hidden 1024: one greedy rollout on the card,
   then the same batch through rew_inf, ref_inf and critic_inf on the
   card (bf16, kernels) and on the CPU (fp32, plain versions) from the
   same weights: rewards, reference log-probs and values within limits;
   then actor_train and critic_train on the card (bf16, kernels,
   optimizer state offloaded between train calls) against a plain fp32
   reference of the same step on the card: each first-minibatch loss,
   grad norm and importance weight within limits (the card's bf16 step
   with the plain attention, and the CPU's fp32 one, are reported
   beside). The generation log-probs shifted by one token must read an
   approximate KL over 10x its limit, the old values shifted by one
   token a value loss over 10x its limit.
14. ctx -- ``Engine.forward_logprobs`` of LLaMA-7B at 8 of its 32
   layers (random bf16 weights) over one packed stream of 32768 tokens (documents of 12288,
   7168, 6144, 4096 and 2816 tokens, then 256 of padding) on a c4 layout
   over ``member_devices(4)``, then on c1 with the same weight tensors
   (K1 over the whole stream): seconds, tokens/s, peak memory, exact
   launch counts (c4: K6 rounds 32 x 4 x 4, pushes 32 x 3 x 4, K1 none),
   and c4 against c1 on the log-probs of the valid positions.
15. ppo_ctx -- the ppo cell with ref and reward at
   ``context_parallel_size=4``: one step; ref_inf and rew_inf each launch
   K6 exactly (layers x 4 x 4 rounds) and K1 never; the step's batch then
   goes through ref_inf and rew_inf of a c1 host from the same seed:
   reference log-probs and rewards within limits.

16-21. The other algorithms at LLaMA-7B width, 4 layers a role, bf16,
   gradient checkpointing on, random weights and data from the seed;
   each checks its exact K1-K4 launch counts (L layers, N minibatches,
   the decode steps taken), finite stats, and one check of its own with
   a planted fault that must fail it, and reports step and per-MFC
   seconds and the peak beside the card:
   rw -- ``RWConfig``, 2 steps of 8 prompts x 2 (pos, neg) pairs
   (answers of 50-200 words); per step K1 = 2L, K2 = K3 = L. Then one
   ``paired_rw`` step card (bf16, kernels) vs CPU (fp32, plain) at
   ``train_parity``'s size: loss and grad norm; every pair swapped
   must miss the loss limit.
   dpo -- ``DPOConfig`` on the same data, the actor's weights copied into
   the ref: step 1's loss ln 2, its KL and scores 0; per step K1 = 3L,
   K2 = K3 = L. The ref's pos and neg sums swapped must miss by 10x.
   grpo -- ``GRPOConfig``, 4 prompts x group 4 = 16 decode streams, up
   to 128 new tokens at top-p 1, top-k 0, 4 minibatches, ref = actor:
   each id holds 4 sequences, first-minibatch importance weight within
   PPO's limit, step 1's |grpo_kl| within its own; per step K1 = 3L +
   2NL, K2 = K3 = NL, K4 = L x decode steps. Old log-probs shifted by
   one token must miss by 10x.
   reinforce -- ``ReinforceInterface`` on ``build_model``'s actor,
   reward and ref, 2 rounds of 8 prompts: the greedy halves bit-equal
   to a greedy ``PPOActorInterface.generate`` (the sampled halves not),
   the loss mask exactly the sampled halves' tokens; per round K1 = 4L +
   2NL, K2 = K3 = NL, K4 = L x (sampled + greedy decode steps).
   agentic -- ``AgenticPPOConfig`` on ``tool_game`` (3 turns, 32 new
   tokens a turn, top-p 1, top-k 0) with turn-level credit, 2 steps of
   16 episodes: none dropped, turn rewards summing to each episode's,
   first-minibatch importance weight within PPO's limit (shifted
   log-probs must miss by 10x); per step K1 = L x generate calls + 2L +
   4NL, K2 = K3 = 2NL, K4 = L x decode steps.
   profile_exp -- ``ProfileConfig(model_size="7b")`` cut to 4 layers, 16
   random prompts of 100-512 tokens, 128 new tokens, 1 step: the six
   MFCs with PPO's launch formula, per-MFC seconds.

22. ckpt_gen -- checkpoint IO at the gen cell's full width, 8 of its 32
   layers (bf16, ~3.7 GB): the model saved with the streamed save
   (``models/hf/registry.py``) under ``_ckpt_scratch/`` beside this
   script (the free disk checked first), then loaded into a new gen
   runner (``model.path``; ``build_model`` streams one layer at a time
   onto the card): every leaf ``torch.equal`` to the saved model's and
   to the registry's eager load of the same files
   (``hf.load_hf_checkpoint``, host numpy), a greedy batch of 8 prompts
   x 32 new tokens equal to the original model's tokens, exact K1/K4
   counts. Planted fault: a loader that skips q_proj's transpose (square
   at this width) must fail both checks. Reports bytes written, save
   and load seconds (GB/s), the host peak growth of the runner's load and
   of the eager read (VmHWM reset through ``/proc/self/clear_refs``,
   else sampled VmRSS) and the load's device peak growth.
23. ckpt_resume -- the sft cell at 7B width, 2 layers, lr 1e-5, gradient
   checkpointing, 3 steps of 16 records in one epoch: run A takes 3
   steps; run B takes 2 with ``save_freq_steps=1`` and
   ``recover_mode="auto"`` (weights ~1.3 GB, optimizer state ~8 GB
   per save); run C, a new ``InlineRunner(recover_mode="resume")``, takes
   step 3: its batch ids, loss, grad norm and updated weights must equal
   A's step 3 (bit for bit), with exact K1/K2/K3 counts. Planted fault:
   C with the optimizer state left fresh must move a weight by at least
   ten times the limit (1% of the step's largest update). Reports the
   weights' and the optimizer state's save seconds, the resume's setup
   seconds and host peak growth.

24. serve_gen -- the ``gen`` experiment with ``use_inflight_batching``
   and 4 slots (``engine/inflight.py``) through ``GenerationConfig.build()``
   and ``InlineRunner`` at LLaMA-7B, 8 of its 32 layers: 8 prompts of
   100-512 words, 128 greedy tokens. Each sequence's log-probs against one
   teacher-forced forward (K1) of prompt + tokens, each token that forward's
   argmax up to a tie margin, exact counts (K1 = 8 x fills, K4 = 8 x
   decode steps);
   token agreement with the batch path on the same batch is reported.
25. serve -- ``serving/scheduler.py`` ``ContinuousScheduler`` over the
   generator, composed from ``ServeConfig(...).build().serving`` as a
   rollout server composes them, at LLaMA-7B, 8 of its 32 layers: 24 requests
   (100-512 tokens from a phrase book, 8 behind one 256-token prefix, 128
   greedy tokens) in 3 waves over 8 slots, chunk 8, in four
   configurations: (a) dense bf16 with a weight push (version 1, the
   weights plus noise) mid-run under max_staleness 1, (b) paged bf16
   (block 16) with the pooled prefix cache, (c) paged int8, (d) dense with
   ``spec_decode_k=4`` (and 8 of its requests again with an oracle
   drafter proposing (d)'s own streams: drafts must be accepted, as the
   random model's prompt-lookup drafts never are). Each: one terminal
   event per request with its
   token stream in order, exact K1/K4 counts, the teacher-forced check
   (int8 at its own limit); (a): requests admitted after the push report
   version 1 and their tokens equal a generator built on the version-1
   weights; (b): prefill tokens saved. Reports tokens/s, time to first
   token and latency p50/p99, decode ms per chunk, peak memory, pool
   bytes, the spec acceptance rate and token agreement with (a). Then the
   KV check: a small paged run's exported rows against one forward's K/V
   (row_rel_err), with two planted faults that must exceed its limit (a
   fill whose positions are one off; a ``pool_scatter`` that clamps masked
   lanes onto live rows), and ``fill_slot`` ms per prompt bucket.

26. mixtral_gen -- the ``gen`` experiment at Mixtral-8x7B width
   (``mistralai/Mixtral-8x7B-v0.1``'s published config, through the
   port's ``models/hf/mixtral.py`` converter), 16 of its 32 layers (23.5
   B parameters; all 32 need more than one card), bf16, random weights:
   8 prompts of 100-512 words, 128 new tokens, one greedy and one sampled
   step. Exact counts (K1 = 16 a prefill, K4 = 16 a decode step, GQA
   32/8), tokens in range, the greedy step's log-probs against one packed
   teacher-forced forward (the mean gap gated, the max reported), which
   two planted faults (top-k gates not renormalised; the second expert's
   output dropped) must exceed. Reports the share of (token, layer) routings whose top-2
   differ between decode and the teacher-forced pass, the tokens each
   expert of layers 0 and 15 took, the group-size host reads a decode
   step, times and the peak.
27. mixtral_sft -- the ``sft`` experiment at Mixtral-8x7B width, 1 layer
   (2 run out of the card's memory in the optimizer step), bf16,
   gradient checkpointing, 16 records in 2 microbatches, 3 steps:
   falling loss, ``moe_aux_loss`` on every step with loss = nll + aux,
   step 1's gradient finite and non-zero for the router and every
   expert's wg/wu/wd, exact K1/K2/K3 counts; step seconds, tokens/s, peak.
28. mixtral_parity -- 2 layers, hidden 1024, 8 q / 2 kv heads of 128,
   FFN 2816, 8 experts top-2: card (bf16, kernels) against CPU (fp32,
   plain) from the same bf16 weights: the forward's logits (tokens whose
   CPU router margin between the second and third expert is under a
   floor at some layer left out and counted), one SFT step's loss and
   aux loss, and the cosine of every (layer, expert) slice of every
   gradient leaf; the router's gradient zeroed must fail.
29. mistral -- the ``gen`` experiment at Mistral-7B-v0.1, full width and
   depth (32 layers, window 4096): 8 prompts, two of 5200-5600 words, 64
   greedy tokens. K1 = 32 a prefill and K4 = 32 a decode step, every
   launch with the window; the log-probs against a packed teacher-forced
   windowed forward (the same pass without the window must fail); the
   long prompts' last-position logits against the same weights in fp32
   through ``packed_attention_plain`` over the window.
30. gemma_gen -- the ``gen`` experiment at ``google/gemma-7b``'s
   published config (through the port's ``models/hf/gemma.py``), full
   width and depth (28 layers, 16 heads of 256, tied 256000-word head),
   bf16, random weights: gen-7b-b8's traffic, one greedy and one sampled
   batch. K1 = 28 a prefill and K4 = 28 a decode step, all at hd 256;
   the greedy log-probs against a packed teacher-forced forward, which
   the same pass with gemma's (1 + w) norm scale dropped, or without the
   sqrt(hidden) embedding scale, must exceed; tokens/s, decode ms a
   token, peak.
31. gemma_sft -- the ``sft`` experiment at ``google/gemma-2b``, full width
   and depth (18 layers, 8 q heads on 1 KV head of 256), bf16, gradient
   checkpointing, the sft cell's 16 records a step in 2 microbatches, 3
   steps, eval: falling loss, every layer slice of every
   leaf with a non-zero step-1 gradient, exact K1/K2/K3 counts; step
   seconds, tokens/s, peak and the memory free at it.
32. gemma_parity -- Gemma-2B's architecture at 2 layers, hidden 1024, 4 q
   / 1 kv heads of 256, vocab 32000: card (bf16, kernels) against CPU
   (fp32, plain) from the same bf16 weights: a packed forward's logits,
   a prefill's and one decode step's logits, one SFT step's loss and
   grad norm, and the cosine of every layer slice of every gradient
   leaf; the wk gradient zeroed must fail.
33. gpt2_gen -- the ``gen`` experiment at ``openai-community/gpt2-xl``
   (48 layers, 25 heads of 64, absolute positions, LayerNorm with
   biases, tied head), gen-7b-b8's traffic: K1 = 48 a prefill, K4 = 48 a
   decode step; the teacher-forced gate, which the pass reading the
   position table one row later must exceed.
34. tp_gen -- gen-7b-b8's traffic (LLaMA-7B, 4 of its 32 layers: the
   depth cut for the script's time) through the
   ``gen`` experiment at d2t2 and at d1t4, members on
   ``member_devices``: K1 = 4 x members a prefill, K4 = 4 x members a
   decode step; the greedy tokens teacher-forced through the d1t1 model
   of the same weights (``PAR_LIMITS``), which d2t2 with member 1's
   row-parallel partial dropped must exceed; decode ms a token and
   prefill ms.
35. tp_sft -- the sft cell at 7B width, 4 layers, d2t2 with ZeRO-1, 3
   steps, against the d1t1 runner of the same seed: losses, grad norms,
   the fp32 master weights' update, exact K1-K3; gradients not summed
   over the data group must miss the grad-norm limit.
36. realloc -- the 4-layer LLaMA-7B moved d1t1 -> d1t2 -> d2t1 -> d2t2
   -> d1t1 (``parallel/realloc.py``): every target's canonical leaves
   digest-equal to the source's, the last bit-equal to a host copy of
   the first, an EMA move (eta 0.3) bit-equal to a plain fp32 lerp; a
   move with the vocabulary repad shifted one row must miss; seconds
   and GB/s of each move.
37. par_ppo -- ppo-7bw-l4's traffic with the actor on d1t2 generating on
   a d2t1 replica (``actor_gen_alloc``), ref on a d1t2 replica
   (``ref_inf_alloc``), the critic on d2t1 with ZeRO-1: the ppo phase's
   first-minibatch limits on both steps, exact K1-K4 per member; a
   runner whose replicas are not refreshed after a train step must miss
   them; per-MFC and reshard seconds.
   kernels (member shapes) -- K1-K4 against their plain versions, with
   the limits and planted faults of phase 3, at the segment matrices the
   members of phases 34-37 ran: K1 and K4 on each d2t2 data member's 4
   streams at 16/16 heads and on the d1t4 members' 8 streams at 8/8, K1
   and K2/K3 on each d2t2 member's sft stream and on the d1t2 actor's
   minibatch stream at 16/16, K1 on the d1t2 ref replica's stream.
38. pp_sft -- the sft cell at 7B width, 4 layers, 3 steps, at p2 (1F1B,
   8 microbatches), p2t2 (1F1B) and p2 under GPipe (4 microbatches),
   each against the d1t1 runner of the same seed: losses, grad norms,
   the fp32 master weights' update, exact K1-K3 (3 K1 and one K2/K3 a
   layer a microbatch a train pass); p2's ``forward_logprobs`` against
   a d1t1 engine of its weights (``PP_LIMITS``); a 1F1B backward sending
   dx to microbatch m - 1 must miss the grad-norm limit.
39. pp_gen -- gen-7b-b8's prompt shape (LLaMA-7B, 8 layers, 64 greedy
   tokens) on a p2 engine through its decode view (d2t1), at g2 (d1t2),
   after ``set_params`` of perturbed weights, and on a c4 engine at g4
   (d1t4): exact K1/K4 on the view's members, the teacher-forced gap
   against the d1t1 model of the same weights, ``drop_decode_view``
   freeing exactly the view's bytes; a ``set_params`` that leaves the
   view stale must exceed the gap limit. View build ms, decode ms a
   token, prefill ms.
40. pp_ppo -- ppo-7bw-l4's traffic with the actor at p2 (1F1B) dropping
   its decode view after each rollout and the critic at p2 under GPipe:
   the ppo phase's first-minibatch limits on both steps, exact K1-K4;
   a runner whose view's freshness is keyed on the weights object's
   identity must miss them. Per-MFC seconds, view build ms.
   kernels (pipeline shapes) -- K1-K3 on one pipeline microbatch of
   pp_sft's p2 (32/32 heads) and p2t2 (16/16), K1 and K4 on the members
   of pp_gen's d2t1 view (32/32) and d1t4 view (8/8).
41. cp_sft -- the ``sft`` experiment on one 16384-token stream a step
   (six records of 1536-3584 tokens packed across the shard boundaries)
   at 7B width, 4 layers, 3 steps, at c2, c4 and d1t2c2s, each against
   the d1t1 runner of the same seed: losses, grad norms, the fp32 master
   weights' update (``CP_LIMITS``), exact K6 (plain and lse rounds),
   push and K2/K3 ring-round counts; c4's ``forward_logprobs`` against a
   d1t1 engine of its weights, which K6 with its key offsets one shard
   off must exceed; a ring backward summing dk/dv into shard src + 1
   must miss the limits. Step seconds and peak memory beside d1t1's.
42. sp_sft -- the sft cell at 7B width, 4 layers, 3 steps, at d1t2s
   and d2t2s against d1t2 and d2t2: ``forward_logprobs`` bit-equal,
   losses, grad norms and the update on ``PAR_LIMITS``' tp_sft limits,
   exact K1-K3; a reduce-scatter handing member j member j + 1's slice
   must break the forward and miss the loss limit. Step seconds and peak
   memory beside the layout without ``s``.
   kernels (ring rounds) -- K2/K3 at ring rounds at each cp_sft layout's
   shard shape (B 1; c4: lc 4096, 32/32 heads of 128; c2: lc 8192,
   32/32; d1t2c2s: lc 8192, 16/16) on the stream it trained on: the
   diagonal round of the first shard a record crosses into and its round
   against the shard before (a k_off one 64-key tile off must exceed the
   limits); K6's lse at each layout's n and heads against
   ``flash_attention_plain``'s over the gathered stream, row by row, and
   its o bit-equal to a launch without the lse.
43. moe_tp -- (run right after mixtral_gen) mixtral_gen's d1t1 engine,
   its weights waiting on the host, reallocated to d1t2 and d1t4 (each
   model member its slice of every expert's FFN width, the router
   whole): mixtral_gen's greedy prompts, 64 greedy tokens; exact K1/K4,
   the mean teacher-forced gap against the d1t1 engine, which d1t2 with
   member 1's row-parallel partial dropped must exceed; the
   reallocation's seconds, decode ms a token, host reads a decode step.
44. kv_rep -- ``google/gemma-2b`` (8 q heads on one KV head of 256) at
   d1t2 and d1t4, its KV weights whole on every model member: full width
   at 9 of its 18 layers (the depth cut for the script's time), 8
   prompts of 100-512 tokens, 64 greedy tokens through the
   decode's "seq" route (each member its slice of the cache slots, K4
   with its softmax statistics, the flash merge); exact K1/K4 (K4 with
   statistics a layer a member a decode step), the teacher-forced gap
   against the d1t1 model of the same weights, which a merge leaving
   member 1's partial out must exceed. Then the sft cell at 6 of its 18
   layers (the depth cut), 3 steps at d1t2 against d1t1: loss, grad
   norm, update (``MOE_PAR_LIMITS``), exact K1-K3; the replicated wk/wv
   gradients left unsummed over the model members must miss them.
45. moe_sft_par -- mixtral_sft's model and records at d2t1 (ragged:
   router losses over data shards), d2t2 with expert parallelism at
   capacity 1.25 (4 experts a data member, dispatch over the whole
   batch) and c2 (ragged, one stream a step: router losses over context
   shards, K6 and the ring's K2/K3), each against a d1t1 engine of the
   same start weights replaying the same microbatches: loss, grad norm,
   the aux loss, the update, exact counts; routing per shard (the port
   before this slice) on a fresh d2t2/c2 runner's first step must miss
   the loss or aux limit.

46. cp_gemma -- ``google/gemma-2b`` (8 q heads on one KV head of 256)
   at 4 of its 18 layers on cp_sft's 16384-token stream, 3 steps at c2,
   c4 and d1t2c2 (the KV head replicated over t) against d1t1: losses,
   grad norms, the update (``CP_GEMMA_LIMITS``), exact K6 and ring
   K2/K3 counts at hd 256; c4's log-probs against d1t1, which K6 with
   direction 1's key offset one tile off must exceed.
   kernels (the ring at hd 256) -- at each cp_gemma layout's shard
   (``CP_GEMMA_KERNEL_SHARDS``: c4 lc 4096 8/1, c2 lc 8192 8/1, d1t2c2
   lc 8192 4/1) on the stream it trained on: one whole K6 ring, K6's
   lse, K2/K3 at the diagonal round and the crossing round (the k_off
   fault must exceed the limits); a ring over documents at Gemma-7B's
   16/16 with the ring's planted faults; small GQA, window and
   recurring-id cases.
47. moe_pp -- (after moe_tp) mixtral_gen's engine moved to d1t2p2 (MoE
   at t2 in each of two stages, GPipe, M 4): the greedy streams'
   log-probs against d1t2 on the same microbatches (max gap) and d1t1
   (mean gap); a stage output handed to microbatch m - 1 and router
   logits rounded to bf16 must exceed the d1t2 limit. Then its first 4
   layers at d1t2p2 generate 64 greedy tokens through the decode view
   (d2t2; at 16 layers two copies fit on no card): exact K1/K4 on the
   view's members, the mean teacher-forced gap against d1t1, which the
   view with member 1's row-parallel partial dropped must exceed.
48. sp_pp -- the sft cell at 7B width, 2 layers, at t2p2s and d2t2p2s
   (1F1B) against t2p2 and d2t2p2: forwards bit-equal, steps on
   ``PAR_LIMITS``, exact K1-K3; the shifted reduce-scatter must fail.

The kernel cases of phase 3 include K1-K4 at hd 256: K1 at the Gemma-7B
prefill and the Gemma-2B sft stream, K2/K3 at that stream and at 16/16,
K4 at the Gemma-7B and Gemma-2B decodes and K5 on a stacked layer at
the Gemma-7B decode (timed), non-causal and windowed cases
(``phase_kernels_hd256``), and K4 with its statistics at kv_rep's "seq"
slices (B 8, 8/1 heads, S 320 and 192, streams empty in the slice; o, m
and l against the plain version; ``seq_kernel_cases``).

The phases before 22 run with the saves of their trained roles switched
off (``without_saves``: ``enable_save=False`` on every train MFC's
interface), as they ran before the port could save.

Then a ``{"kernels": [...]}`` line (launches summed over the gen, deep,
sft, ppo, ctx, ppo_ctx, algorithm, checkpoint, serve, mixtral_gen,
moe_tp, mixtral_sft, mistral, gpt2_gen, tp_gen, tp_sft, par_ppo, pp_sft,
pp_gen, pp_ppo, cp_sft, sp_sft, moe_sft_par, moe_pp and sp_pp paths,
each counted from 0; rows ``*_hd256`` over gemma_gen, gemma_sft, kv_rep
and cp_gemma, of whose K4 launches ``flash_decode_seq_hd256`` counts
those with the statistics; rows ``flash_bwd_*_ring`` and
``ring_attention_lse`` for the ring's backward, ``*_ring_hd256`` and
``ring_attention_hd256`` for the ring at hd 256), the
``nvidia-smi`` name/power line
and, last, ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the package beside this script, it exits non-zero and prints no
result.
"""

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
NEG_INF = -2.0 ** 30
# Error limits, each about 3x the largest reading of a sound kernel over
# the cases of phase 3 (PERF.md, Findings): output rows as row_rel_err,
# the softmax statistics absolute (lse, m) or relative (l).
LIMITS = dict(flash_fwd_row_rel=0.1, flash_fwd_lse=6e-6,
              flash_decode_row_rel=0.08, flash_decode_m=5e-6,
              flash_decode_l_rel=5e-6, flash_bwd_dq_row_rel=0.07,
              flash_bwd_dk_row_rel=0.07, flash_bwd_dv_row_rel=0.07,
              ring_row_rel=0.06)

RESULTS = {}


#: the script's start (``main``); each emitted record carries its seconds
#: since then, so a run's stdout says where its time went
START = None


def emit(phase, **kw):
    rec = dict(phase=phase, **kw)
    if START is not None:
        rec["at_secs"] = time.monotonic() - START
    RESULTS[phase] = rec
    print(json.dumps(rec), flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def row_rel_err(out, ref, rows, floor_frac=0.0) -> float:
    """Largest |out - ref| of an output row over the RMS of that row of
    ``ref``, over the rows where ``rows`` (out's shape less its last
    dim) is true. Rows averaging many values are small, so an absolute
    limit would let a dropped key through where they are. With
    ``floor_frac``, a row's RMS counts as at least that share of the RMS
    over all such rows: a gradient row whose exact value is 0 (the first
    token of a segment attends to itself alone, so its ds = p (dp -
    delta) cancels) holds rounding noise on both sides."""
    d = (out.float() - ref.float()).abs().amax(-1)
    sq = ref.float().pow(2).mean(-1)
    floor = floor_frac * float(sq[rows].mean().sqrt())
    rms = sq.sqrt().clamp_min(max(floor, 1e-6))
    return float((d / rms)[rows].max())


# ----------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ----------------------------------------------------------------------
def left_padded_seg(lengths, L, device):
    import torch
    seg = torch.zeros((len(lengths), L), dtype=torch.int32, device=device)
    for i, n in enumerate(lengths):
        seg[i, L - n:] = 1
    return seg


def packed_seg(rng, b, L, n_segs, pad_rows, device):
    """Multi-segment packing, a padded tail on every row, and all-pad
    rows at ``pad_rows``."""
    import numpy as np
    import torch
    seg = np.zeros((b, L), np.int32)
    for bi in range(b):
        if bi in pad_rows:
            continue
        cuts = np.sort(rng.choice(np.arange(1, L - 1), n_segs - 1,
                                  replace=False))
        cuts = np.concatenate([[0], cuts, [L]])
        for s in range(n_segs):
            seg[bi, cuts[s]:cuts[s + 1]] = s + 1
        seg[bi, L - int(rng.integers(1, L // 8)):] = 0
    return torch.from_numpy(seg).to(device)


def recurring_seg(rng, b, L, device):
    """Pieces of 1-150 tokens whose ids, drawn from 1-4, recur out of
    order (3, 1, 3, 2, ...), some padding pieces among them."""
    import numpy as np
    import torch
    seg = np.zeros((b, L), np.int32)
    for bi in range(b):
        off = 0
        while off < L:
            n = int(rng.integers(1, 151))
            seg[bi, off:off + n] = int(rng.integers(0, 5))
            off += n
    return torch.from_numpy(seg).to(device)


def long_then_short_seg(rng, L, first, device):
    """One segment of ``first`` tokens, then segments of 5-60 tokens,
    then a padded tail."""
    import numpy as np
    import torch
    seg = np.zeros((1, L), np.int32)
    seg[0, :first] = 1
    off, sid = first, 2
    while off < L - 40:
        n = int(rng.integers(5, 61))
        seg[0, off:min(off + n, L - 40)] = sid
        off, sid = off + n, sid + 1
    return torch.from_numpy(seg).to(device)


def leading_pad_seg(rng, b, L, pads, device):
    """Row i starts with ``pads[i]`` padding tokens (a whole row of them
    when it is L), then 3 segments."""
    import numpy as np
    import torch
    seg = np.zeros((b, L), np.int32)
    for bi, pad in enumerate(pads):
        if pad >= L:
            continue
        cuts = np.sort(rng.choice(np.arange(pad + 1, L), 2, replace=False))
        for sid, (lo, hi) in enumerate(zip([pad, *cuts], [*cuts, L])):
            seg[bi, lo:hi] = sid + 1
    return torch.from_numpy(seg).to(device)


def allowed_pairs(seg, causal, window=None) -> int:
    """(query, key) pairs the mask allows: the attention work this
    input needs."""
    from realhf_tpu_torch.ops.flash_attention import segment_mask
    return int(segment_mask(seg, seg, causal, window).sum())


def tile_pairs(vis, lq, lk) -> int:
    """(query, key) pairs inside the visited tile pairs ``vis`` [B, q
    tiles, key tiles] of K1's grid, rows past ``lq`` and keys past ``lk``
    left out."""
    import torch
    from realhf_tpu_torch.ops import flash_attention as fa
    dev = vis.device
    rows = (lq - torch.arange(vis.shape[1], device=dev) * fa.K1_BQ
            ).clamp(max=fa.K1_BQ)
    keys = (lk - torch.arange(vis.shape[2], device=dev) * fa.K1_BK
            ).clamp(max=fa.K1_BK)
    return int((vis * rows[:, None] * keys[None, :]).sum())


def walked_pairs(seg, causal, window=None) -> int:
    """(query, key) pairs K1 computes: those of the (q tile, key tile)
    pairs ``visited_key_tiles`` keeps."""
    from realhf_tpu_torch.ops import flash_attention as fa
    L = seg.shape[1]
    return tile_pairs(fa.visited_key_tiles(seg, causal, window=window), L, L)


def dkv_walked_pairs(seg, causal, window=None) -> int:
    """(query, key) pairs K3 computes: those of the (key tile, q tile)
    pairs ``visited_q_tiles`` keeps (K1's and K2's pairs, transposed)."""
    from realhf_tpu_torch.ops import flash_attention as fa
    L = seg.shape[1]
    return tile_pairs(fa.visited_q_tiles(seg, causal, window=window), L, L)


def ring_walked_pairs(seg, n, n_dirs, causal, window=None) -> int:
    """(query, key) pairs K6 computes over a whole ring of ``n`` members
    on the stream ``seg`` [B, L]: summed over members, rounds and
    directions, those of the (warpgroup, key tile) pairs that
    ``visited_key_tiles`` keeps for the member's q shard against the KV
    half it holds, on global offsets."""
    from realhf_tpu_torch.ops import flash_attention as fa
    from realhf_tpu_torch.ops import ring_attention_fused as rf
    lc = seg.shape[1] // n
    lch = lc // n_dirs
    total = 0
    for j in range(n):
        seg_q = seg[:, j * lc:(j + 1) * lc]
        for r in range(n):
            for k_off in rf.round_key_offsets(j, r, n, lc, lch, n_dirs):
                vis = fa.visited_key_tiles(
                    seg_q, causal, seg_k=seg[:, k_off:k_off + lch],
                    q_off=j * lc, k_off=k_off, window=window)
                total += tile_pairs(vis, lc, lch)
    return total


def shifted_boundaries(seg):
    """The segment ids moved one token later along the stream: every
    segment boundary shifts by one token."""
    import torch
    out = seg.clone()
    out[:, 1:] = seg[:, :-1]
    return out


def check_flash_fwd(name, b, L, nq, nkv, hd, seg, causal, gen, timed,
                    plant_fault=False, window=None):
    """K1 against its plain version. With ``plant_fault``, the kernel's
    output is also held against the plain version on segment boundaries
    shifted by one token, which must exceed the row-error limit. With a
    ``window``, two launches must give the same bits, a window of L must
    give the windowless launch's bits, and (at a window of 32 or less)
    the kernel with a window one key wider must exceed the limit against
    the plain version."""
    import torch
    from realhf_tpu_torch.ops import flash_attention as fa
    dev = seg.device
    q = torch.randn((b, L, nq, hd), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, L, nkv, hd), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, L, nkv, hd), generator=gen, device=dev).bfloat16()
    o, lse = fa.flash_attention(q, k, v, seg, causal=causal, window=window)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, seg, causal=causal,
                                              window=window)
    valid_rows = (lse_ref > NEG_INF / 2)
    o_rows = valid_rows.transpose(1, 2)             # [B, L, nq]
    err_lse = max_err(torch.where(valid_rows, lse, 0.0),
                      torch.where(valid_rows, lse_ref, 0.0))
    lse_sentinel_ok = bool((lse[~valid_rows] == NEG_INF).all())
    rec = dict(kernel="flash_fwd", case=name, shape=[b, L, nq, nkv, hd],
               causal=causal, window=window, max_abs_err=max_err(o, o_ref),
               row_rel_err=row_rel_err(o, o_ref, o_rows),
               row_rel_limit=LIMITS["flash_fwd_row_rel"],
               lse_max_abs_err=err_lse, lse_limit=LIMITS["flash_fwd_lse"],
               masked_rows_zero=bool((o.float()[~o_rows] == 0).all()),
               lse_sentinel_ok=lse_sentinel_ok,
               finite=bool(torch.isfinite(o.float()).all()))
    rec["ok"] = (rec["row_rel_err"] <= LIMITS["flash_fwd_row_rel"]
                 and err_lse <= LIMITS["flash_fwd_lse"] and rec["finite"]
                 and rec["masked_rows_zero"] and lse_sentinel_ok)
    rec["walked_pairs"] = walked_pairs(seg, causal, window)
    rec["allowed_pairs"] = allowed_pairs(seg, causal, window)
    if window is not None:
        again = fa.flash_attention(q, k, v, seg, causal=causal, window=window)
        rec["deterministic"] = (torch.equal(o, again[0])
                                and torch.equal(lse, again[1]))
        full = fa.flash_attention(q, k, v, seg, causal=causal)
        at_l = fa.flash_attention(q, k, v, seg, causal=causal, window=L)
        rec["window_L_bit_equal_to_none"] = (torch.equal(full[0], at_l[0])
                                             and torch.equal(full[1], at_l[1]))
        rec["ok"] &= rec["deterministic"] and rec["window_L_bit_equal_to_none"]
        del again, full, at_l
        if window <= 32:
            wide, _ = fa.flash_attention(q, k, v, seg, causal=causal,
                                         window=window + 1)
            rec["planted_window_fault"] = "kernel window one key wider"
            rec["planted_window_fault_row_rel_err"] = row_rel_err(
                wide, o_ref, o_rows)
            rec["ok"] &= (rec["planted_window_fault_row_rel_err"]
                          > LIMITS["flash_fwd_row_rel"])
    if plant_fault:
        o_bad, lse_bad = fa.flash_attention_plain(
            q, k, v, shifted_boundaries(seg), causal=causal)
        rows = o_rows & (lse_bad > NEG_INF / 2).transpose(1, 2)
        rec["planted_fault"] = "segment boundaries shifted by one token"
        rec["planted_fault_row_rel_err"] = row_rel_err(o, o_bad, rows)
        rec["ok"] &= (rec["planted_fault_row_rel_err"]
                      > LIMITS["flash_fwd_row_rel"])
    if timed:
        scale = hd ** -0.5
        rec["ms"] = cuda_ms(lambda: fa.flash_attention(q, k, v, seg,
                                                       causal=causal,
                                                       window=window))
        rec["plain_ms"] = cuda_ms(lambda: fa.flash_attention_plain(
            q, k, v, seg, causal=causal, window=window), iters=5, warmup=1)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = fa.segment_mask(seg, seg, causal, window)[:, None]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        gqa = dict(enable_gqa=True) if nq != nkv else {}
        rec["library_ms"] = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                                 scale=scale, **gqa))
        flops = 4.0 * hd * rec["allowed_pairs"] * nq
        # q/k/v rows of pad tokens (seg 0) are never needed; o and lse
        # are written in full
        tokens = int((seg != 0).sum())
        nbytes = 2 * tokens * (nq + 2 * nkv) * hd + 2 * o.numel() \
            + 4 * (seg.numel() + lse.numel())
        rec["bound_ms"], rec["bound_by"] = bound_ms(flops, nbytes)
        rec["flops"], rec["bytes"] = flops, nbytes
    return rec


def check_flash_bwd(name, b, L, nq, nkv, hd, seg, causal, gen, timed,
                    plant_fault=False, window=None):
    """K2 (dq) and K3 (dk, dv) from K1's o and lse, against the plain
    backward on the same bf16 values widened to fp32; a second launch of
    each must give the same bits. With ``plant_fault``, the backward is
    also run with o = 0 (so delta = 0), which must exceed the dk limit,
    and the kernels' dq and dk are held against the plain backward on
    segment boundaries shifted by one token, which must exceed the dq and
    dk limits (a skip rule too tight at the edges of a segment would pass
    it). With a ``window``, a window of L must give the windowless
    launches' bits, and (at a window of 32 or less) the kernels with a
    window one key wider must exceed the dq and dk limits."""
    import torch
    from realhf_tpu_torch.ops import flash_attention as fa
    dev = seg.device
    q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
               for shape in ((b, L, nq, hd), (b, L, nkv, hd), (b, L, nkv, hd)))
    do = torch.randn((b, L, nq, hd), generator=gen, device=dev).bfloat16()
    win = dict(causal=causal, window=window)
    o, lse = fa.flash_attention(q, k, v, seg, **win)
    delta = fa.attention_delta(o, do)
    dq = fa.flash_bwd_dq(q, k, v, seg, do, lse, delta, **win)
    dk, dv = fa.flash_bwd_dkv(q, k, v, seg, do, lse, delta, **win)
    torch.cuda.synchronize()
    ref = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), seg,
                                       o.float(), lse, do.float(), **win)
    tok = seg != 0                                   # [B, L]
    q_rows = tok[:, :, None].expand(b, L, nq)
    kv_rows = tok[:, :, None].expand(b, L, nkv)
    rec = dict(kernel="flash_bwd", case=name, shape=[b, L, nq, nkv, hd],
               causal=causal, window=window, tokens=int(tok.sum()))
    for key, got, want, rows in (("dq", dq, ref[0], q_rows),
                                 ("dk", dk, ref[1], kv_rows),
                                 ("dv", dv, ref[2], kv_rows)):
        rec[f"{key}_max_abs_err"] = max_err(got, want)
        rec[f"{key}_row_rel_err"] = row_rel_err(got, want, rows, 0.01)
        rec[f"{key}_row_rel_limit"] = LIMITS[f"flash_bwd_{key}_row_rel"]
        rec[f"{key}_pad_rows_zero"] = bool((got.float()[~rows] == 0).all())
        rec[f"{key}_finite"] = bool(torch.isfinite(got.float()).all())
    dq2 = fa.flash_bwd_dq(q, k, v, seg, do, lse, delta, **win)
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, seg, do, lse, delta, **win)
    rec["deterministic"] = all(torch.equal(x, y) for x, y in
                               ((dq, dq2), (dk, dk2), (dv, dv2)))
    del dq2, dk2, dv2
    rec["ok"] = rec["deterministic"] and all(
        rec[f"{key}_row_rel_err"] <= rec[f"{key}_row_rel_limit"]
        and rec[f"{key}_pad_rows_zero"] and rec[f"{key}_finite"]
        for key in ("dq", "dk", "dv"))
    rec["walked_pairs"] = walked_pairs(seg, causal, window)
    rec["dkv_walked_pairs"] = dkv_walked_pairs(seg, causal, window)
    rec["allowed_pairs"] = allowed_pairs(seg, causal, window)
    if window is not None:
        # the windowless launches against those at a window of L, on the
        # windowless forward's o and lse
        o_n, lse_n = fa.flash_attention(q, k, v, seg, causal=causal)
        d_n = fa.attention_delta(o_n, do)
        outs = []
        for w in (None, L):
            kw = dict(causal=causal, window=w)
            outs.append((fa.flash_bwd_dq(q, k, v, seg, do, lse_n, d_n, **kw),
                         *fa.flash_bwd_dkv(q, k, v, seg, do, lse_n, d_n,
                                           **kw)))
        rec["window_L_bit_equal_to_none"] = all(
            torch.equal(x, y) for x, y in zip(*outs))
        rec["ok"] &= rec["window_L_bit_equal_to_none"]
        del o_n, lse_n, d_n, outs
        if window <= 32:
            kw = dict(causal=causal, window=window + 1)
            rec["planted_window_fault"] = "kernels' window one key wider"
            for key, got, want, heads in (
                    ("dq", fa.flash_bwd_dq(q, k, v, seg, do, lse, delta,
                                           **kw), ref[0], nq),
                    ("dk", fa.flash_bwd_dkv(q, k, v, seg, do, lse, delta,
                                            **kw)[0], ref[1], nkv)):
                err = row_rel_err(got, want,
                                  tok[:, :, None].expand(b, L, heads), 0.01)
                rec[f"planted_window_fault_{key}_row_rel_err"] = err
                rec["ok"] &= err > LIMITS[f"flash_bwd_{key}_row_rel"]
    if plant_fault:
        _, dk_bad, _ = fa.flash_attention_bwd(q, k, v, seg,
                                              torch.zeros_like(o), lse, do,
                                              causal=causal)
        rec["planted_fault"] = "delta taken as 0 (o = 0)"
        rec["planted_fault_dk_row_rel_err"] = row_rel_err(dk_bad, ref[1],
                                                          kv_rows, 0.01)
        rec["ok"] &= (rec["planted_fault_dk_row_rel_err"]
                      > LIMITS["flash_bwd_dk_row_rel"])
        del dk_bad
        shifted = shifted_boundaries(seg)
        bad = fa.flash_attention_bwd_plain(
            q.float(), k.float(), v.float(), shifted, o.float(), lse,
            do.float(), causal=causal)
        both = tok & (shifted != 0)
        rec["planted_fault_2"] = "segment boundaries shifted by one token"
        for key, got, want, heads in (("dq", dq, bad[0], nq),
                                      ("dk", dk, bad[1], nkv)):
            err = row_rel_err(got, want,
                              both[:, :, None].expand(b, L, heads), 0.01)
            rec[f"planted_fault_2_{key}_row_rel_err"] = err
            rec["ok"] &= err > LIMITS[f"flash_bwd_{key}_row_rel"]
        del bad
    if timed:
        rec["dq_ms"] = cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, seg, do, lse,
                                                       delta, **win))
        rec["dkv_ms"] = cuda_ms(lambda: fa.flash_bwd_dkv(q, k, v, seg, do,
                                                         lse, delta, **win))
        # the plain version computes dq, dk and dv together
        rec["plain_ms"] = cuda_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, seg, o, lse, do, **win), iters=3, warmup=1)
        rec["library_ms"] = sdpa_backward_ms(q, k, v, seg, do, causal,
                                             window)
        # only the (query, key) pairs the mask allows, and only the rows
        # of tokens with seg != 0; lse, delta and seg read once, outputs
        # written once in full
        pairs = allowed_pairs(seg, causal, window) * nq
        tokens = rec["tokens"]
        stats = 4 * (2 * lse.numel() + seg.numel())
        rec["dq_flops"] = 6.0 * hd * pairs
        rec["dq_bytes"] = 2 * tokens * (2 * nq + 2 * nkv) * hd + stats \
            + 2 * dq.numel()
        rec["dkv_flops"] = 8.0 * hd * pairs
        rec["dkv_bytes"] = 2 * tokens * (2 * nq + 2 * nkv) * hd + stats \
            + 2 * (dk.numel() + dv.numel())
        rec["dq_bound_ms"], rec["dq_bound_by"] = bound_ms(rec["dq_flops"],
                                                          rec["dq_bytes"])
        rec["dkv_bound_ms"], rec["dkv_bound_by"] = bound_ms(
            rec["dkv_flops"], rec["dkv_bytes"])
    del ref
    torch.cuda.empty_cache()
    return rec


def sdpa_backward_ms(q, k, v, seg, do, causal, window=None) -> float:
    """The yardstick: the backward of ``scaled_dot_product_attention``
    with the same boolean mask (dq, dk and dv together). Timed only;
    the port never calls it."""
    import torch
    from realhf_tpu_torch.ops.flash_attention import segment_mask
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    mask = segment_mask(seg, seg, causal, window)[:, None]
    gqa = dict(enable_gqa=True) if q.shape[2] != k.shape[2] else {}
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, **gqa)
    g = do.transpose(1, 2).contiguous()
    return cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), g,
                                               retain_graph=True))


def sft_stream_seg(rng, n_segs, L, device):
    """One packed stream of ``n_segs`` sequences of random lengths with
    a padded tail, as the SFT packer lays out a microbatch."""
    import numpy as np
    import torch
    lens = rng.integers(L // (2 * n_segs), 2 * L // n_segs, size=n_segs)
    lens = (lens * (L - 37) / lens.sum()).astype(int)
    seg = np.zeros((1, L), np.int32)
    off = 0
    for i, n in enumerate(lens):
        seg[0, off:off + n] = i + 1
        off += n
    return torch.from_numpy(seg).to(device)


def phase_kernels_bwd():
    """K2/K3 cases: the SFT microbatch shape (timed, with the planted
    faults), GQA 32/8 and 32/4, hd 64 (the "1b" shape), ragged L,
    non-causal, an all-padding row, and K1's tile-skipping edges: ids
    that recur out of order (causal and not), one long segment then short
    ones, rows whose first q tiles are all padding (hd 64)."""
    import numpy as np
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    rng = np.random.default_rng(1)
    recs = [check_flash_bwd("sft_microbatch", 1, 4096, 32, 32, 128,
                            sft_stream_seg(rng, 8, 4096, "cuda"), True, gen,
                            timed=True, plant_fault=True)]
    seg = packed_seg(rng, 2, 1024, 4, {1}, "cuda")   # row 1 all padding
    recs.append(check_flash_bwd("gqa_32_8_padrow", 2, 1024, 32, 8, 128, seg,
                                True, gen, timed=False))
    seg = sft_stream_seg(rng, 4, 2048, "cuda")
    recs.append(check_flash_bwd("gqa_32_4_hd64", 1, 2048, 32, 4, 64, seg,
                                True, gen, timed=False))
    seg = packed_seg(rng, 2, 700, 3, set(), "cuda")   # ragged last tile
    recs.append(check_flash_bwd("ragged_L700", 2, 700, 8, 8, 128, seg,
                                True, gen, timed=False))
    recs.append(check_flash_bwd("noncausal_ragged_gqa", 2, 700, 8, 2, 64,
                                seg, False, gen, timed=False))
    for causal in (True, False):
        recs.append(check_flash_bwd(
            f"recurring_ids_causal{int(causal)}", 2, 1000, 16, 8, 128,
            recurring_seg(rng, 2, 1000, "cuda"), causal, gen, timed=False,
            plant_fault=causal))
    recs.append(check_flash_bwd(
        "long_then_short", 1, 2100, 16, 16, 128,
        long_then_short_seg(rng, 2100, 1500, "cuda"), True, gen,
        timed=False, plant_fault=True))
    recs.append(check_flash_bwd(
        "leading_pad_tiles_hd64", 3, 777, 8, 2, 64,
        leading_pad_seg(rng, 3, 777, (300, 0, 777), "cuda"), True, gen,
        timed=False))
    del gen
    torch.cuda.empty_cache()
    return recs


def phase_kernels_window():
    import numpy as np
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    out = window_kernel_cases(gen, np.random.default_rng(13))
    del gen
    torch.cuda.empty_cache()
    return out


def window_kernel_cases(gen, rng):
    """K1 and K2/K3 with a sliding window, against their plain versions:
    the Mistral-7B prefill shape (B 1, L 8192, one segment, GQA 32/8, hd
    128, window 4096; timed), a packed stream with a ragged last tile at
    a window that is no tile multiple (300), and a window shorter than a
    tile at hd 64 (24, with the planted fault of a window one key
    wider). Each prints the pairs walked beside the pairs allowed."""
    import torch
    cases = [
        ("mistral_w4096", 1, 8192, 32, 8, 128,
         torch.ones((1, 8192), dtype=torch.int32, device="cuda"), True,
         4096),
        ("packed_ragged_w300", 2, 1500, 16, 4, 128,
         packed_seg(rng, 2, 1500, 3, set(), "cuda"), False, 300),
        ("narrow_w24_hd64", 2, 700, 8, 2, 64,
         packed_seg(rng, 2, 700, 2, set(), "cuda"), False, 24),
    ]
    fwd, bwd = [], []
    for name, b, L, nq, nkv, hd, seg, timed, w in cases:
        fwd.append(check_flash_fwd(name, b, L, nq, nkv, hd, seg, True, gen,
                                   timed=timed, window=w))
        torch.cuda.empty_cache()
        bwd.append(check_flash_bwd(name, b, L, nq, nkv, hd, seg, True, gen,
                                   timed=timed, window=w))
        torch.cuda.empty_cache()
    return fwd, bwd


def phase_kernels_hd256():
    """K1-K4 at hd 256 (Gemma), against their plain versions: K1 at the
    Gemma-7B prefill (B 8, L 512, 16/16; timed) and at the Gemma-2B sft
    stream (B 1, L 4096, 8/1, packed; timed, planted fault); K2/K3 at
    the Gemma-2B sft stream (timed, planted faults) and at 16/16 over
    packed rows; K1 and K2/K3 non-causal over a ragged last tile and with
    a window of 300; K4 at the Gemma-7B decode (B 8, S 640, 16/16) and
    the Gemma-2B decode (8/1), both timed by ``queued_ms``, with a window,
    and K5 on a stacked layer at the Gemma-7B decode (timed). Returns (K1 and K4/K5 records, K2/K3
    records), each record marked ``hd256``."""
    import numpy as np
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(256)
    rng = np.random.default_rng(256)
    fwd, bwd = [], []
    lengths = [int(x) for x in rng.integers(100, 513, size=8)]
    lengths[0] = 512
    prefill = left_padded_seg(lengths, 512, "cuda")
    sft = sft_stream_seg(rng, 8, 4096, "cuda")
    packed = packed_seg(rng, 2, 1024, 4, {1}, "cuda")
    ragged = packed_seg(rng, 2, 700, 3, set(), "cuda")
    fwd.append(check_flash_fwd("gemma7b_prefill_hd256", 8, 512, 16, 16, 256,
                               prefill, True, gen, timed=True))
    fwd.append(check_flash_fwd("gemma2b_sft_hd256", 1, 4096, 8, 1, 256, sft,
                               True, gen, timed=True, plant_fault=True))
    fwd.append(check_flash_fwd("noncausal_ragged_hd256", 2, 700, 8, 2, 256,
                               ragged, False, gen, timed=False))
    fwd.append(check_flash_fwd("window_w300_hd256", 2, 700, 8, 2, 256,
                               ragged, True, gen, timed=False, window=300))
    torch.cuda.empty_cache()
    bwd.append(check_flash_bwd("gemma2b_sft_hd256", 1, 4096, 8, 1, 256, sft,
                               True, gen, timed=True, plant_fault=True))
    bwd.append(check_flash_bwd("mha_16_16_packed_hd256", 2, 1024, 16, 16,
                               256, packed, True, gen, timed=False,
                               plant_fault=True))
    bwd.append(check_flash_bwd("noncausal_ragged_hd256", 2, 700, 8, 2, 256,
                               ragged, False, gen, timed=False))
    bwd.append(check_flash_bwd("window_w300_hd256", 2, 700, 8, 2, 256,
                               ragged, True, gen, timed=False, window=300))
    spans = [(512 - n, 512 + 64) for n in lengths]
    spans[5] = (0, 0)
    fwd.append(check_flash_decode("gemma7b_decode_hd256", 8, 640, 16, 16,
                                  256, spans, gen, timed=True))
    fwd.append(check_flash_decode("gemma2b_decode_hd256", 8, 640, 8, 1, 256,
                                  spans, gen, timed=True))
    fwd.append(check_flash_decode("window_96_hd256", 8, 640, 8, 1, 256,
                                  spans, gen, timed=False, window=96))
    fwd.append(check_flash_decode("stacked_mid_layer_hd256", 8, 640, 16, 16,
                                  256, spans, gen, timed=True,
                                  stacked_layers=3, layer=1))
    fwd += seq_kernel_cases(gen, lengths)
    for r in fwd + bwd:
        r["hd256"] = True
    del gen
    torch.cuda.empty_cache()
    return fwd, bwd


def queued_ms(calls, reps=3, tries=4):
    """Device ms per call of ``calls`` (thunks) run back to back, the
    launches queued ahead of the device: ``torch.cuda._sleep`` holds the
    stream while the host enqueues them all, so the events between the
    first and the last launch time the device alone, not the host's
    enqueue rate. The median of ``reps`` rounds (after one warm-up
    round), the host us per call of the same loop, and whether every
    round's enqueue ended inside the sleep: a round whose enqueue
    outlasts it (a host stall) is taken again with the sleep doubled, up
    to ``tries`` times, and a reading that never fits is still returned,
    marked ``False``."""
    import torch
    for c in calls:
        c()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(1_000_000)
    ev[1].record()
    ev[1].synchronize()
    cycles_per_ms = 1e6 / ev[0].elapsed_time(ev[1])
    sleep_ms = 5.0 + 0.2 * len(calls)
    dev, host, queued = [], [], True
    for _ in range(reps):
        for attempt in range(tries):
            torch.cuda.synchronize()
            ev[0].record()
            torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
            ev[1].record()
            t0 = time.perf_counter()
            for c in calls:
                c()
            host_s = time.perf_counter() - t0
            ev[2].record()
            ev[2].synchronize()
            fits = host_s * 1e3 < ev[0].elapsed_time(ev[1])
            if fits:
                break
            sleep_ms *= 2
        queued &= fits
        dev.append(ev[1].elapsed_time(ev[2]) / len(calls))
        host.append(host_s * 1e6 / len(calls))
    return sorted(dev)[reps // 2], sorted(host)[reps // 2], queued


def decode_valid(b, S, spans, device):
    """[b, S] bool: stream i valid on the slot intervals of ``spans[i]``,
    one (lo, hi) or a list of them (low invalid slots: left padding)."""
    import torch
    valid = torch.zeros((b, S), dtype=torch.bool, device=device)
    for i, sp in enumerate(spans):
        for lo, hi in ([sp] if isinstance(sp[0], int) else sp):
            valid[i, lo:hi] = True
    return valid


def walked_slots(keep) -> int:
    """Cache slots in the tiles the decode kernel walks (the tiles that
    hold a kept slot), over all streams (``decode_split_plan``)."""
    from realhf_tpu_torch.ops import decode_attention as da
    S = keep.shape[1]
    return sum(min(da.TILE, S - t * da.TILE)
               for tiles in da.decode_split_plan(keep.cpu()) for t in tiles)


def check_flash_decode(name, b, S, nq, nkv, hd, spans, gen, timed,
                       stacked_layers=0, layer=0, window=None):
    """K4 (or, with ``stacked_layers``, K5 at ``layer``) against
    ``decode_attention_plain`` at one shape: out rows, m and l (every
    stream, the empty ones included), empty rows exactly 0, two launches
    bit-equal; planted faults: the newest kept slot of every stream
    dropped, and warp 1's partial left out of the kernel's merge. Timed
    cases rotate over enough layer caches (>= 200 MB, four at least)
    that each launch finds its cache cold, as a decode step does, and time
    the kernel and SDPA queued ahead of the device (``queued_ms``;
    ``queued`` says whether every round's enqueue fitted its sleep);
    ``warm_ms`` is the older reading (CUDA events over 20 back-to-back
    calls on one cache)."""
    import torch
    from realhf_tpu_torch.ops import decode_attention as da
    dev = "cuda"
    q = torch.randn((b, nq, hd), generator=gen, device=dev).bfloat16()
    layer_bytes = 2 * b * nkv * S * hd * 2
    n_rot = max(4, -(-200_000_000 // layer_bytes)) if timed else 1
    nl = max(stacked_layers, n_rot)
    shape = (nl, b, nkv, S, hd)
    k_all = torch.randn(shape, generator=gen, device=dev).bfloat16()
    v_all = torch.randn(shape, generator=gen, device=dev).bfloat16()
    valid = decode_valid(b, S, spans, dev)
    slot = None
    if window is not None:  # the newest slot of each stream
        slot = (S - 1 - valid.flip(-1).int().argmax(-1)).int()
    keep = da.window_keep(valid, window, slot)
    kw = dict(sliding_window=window, slot=slot)

    def call(valid_mask, li=layer, **extra):
        if stacked_layers:
            return da.flash_decode_attention_stacked(
                q, k_all, v_all, valid_mask, li, **kw, **extra)
        return da.flash_decode_attention(q, k_all[li], v_all[li],
                                         valid_mask, **kw, **extra)

    out, m, l = call(valid, return_stats=True)
    again = call(valid, return_stats=True)
    torch.cuda.synchronize()
    ref = da.decode_attention_plain(q, k_all[layer], v_all[layer], keep,
                                    return_stats=True)
    rows = keep.any(-1)[:, None].expand(b, nq)     # non-empty streams
    limit = LIMITS["flash_decode_row_rel"]
    # planted fault: the newest kept slot of every stream dropped
    newest = S - 1 - keep.flip(-1).int().argmax(-1)
    dropped = valid.clone()
    dropped[torch.arange(b, device=dev)[rows[:, 0]], newest[rows[:, 0]]] = \
        False
    fault = row_rel_err(call(dropped), ref[0], rows)
    rec = dict(kernel="flash_decode_stacked" if stacked_layers
               else "flash_decode", case=name, shape=[b, S, nq, nkv, hd],
               layer=layer, window=window,
               max_abs_err=max_err(out, ref[0]),
               row_rel_err=row_rel_err(out, ref[0], rows),
               row_rel_limit=limit, planted_fault_row_rel_err=fault,
               empty_rows_zero=bool((out.float()[~rows] == 0).all()),
               finite=bool(torch.isfinite(out.float()).all()),
               deterministic=all(torch.equal(x, y)
                                 for x, y in zip((out, m, l), again)),
               kept_slots=int(keep.sum()), walked_slots=walked_slots(keep))
    rec["m_max_abs_err"] = max_err(m, ref[1])
    rec["l_max_rel_err"] = float(((l - ref[2]).abs()
                                  / ref[2].abs().clamp_min(1e-6)).max())
    rec["ok"] = (rec["row_rel_err"] <= limit and fault > limit
                 and rec["empty_rows_zero"] and rec["finite"]
                 and rec["deterministic"]
                 and rec["m_max_abs_err"] <= LIMITS["flash_decode_m"]
                 and rec["l_max_rel_err"] <= LIMITS["flash_decode_l_rel"])

    # planted fault in the merge: warp 1's partial left out
    rec["merge_fault_row_rel_err"] = row_rel_err(
        da._launch(q, k_all[layer], v_all[layer], valid, window, slot,
                   hd ** -0.5, False, drop_warp=1), ref[0], rows)
    rec["ok"] &= rec["merge_fault_row_rel_err"] > limit
    del out, m, l, again, ref
    if timed:
        n = n_rot * max(1, -(-24 // n_rot))
        rot = [i % n_rot for i in range(n)]
        rec["rotated_layers"], rec["rotated_mb"] = n_rot, n_rot * layer_bytes / 1e6
        rec["ms"], rec["host_us"], rec["queued"] = queued_ms(
            [lambda i=i: call(valid, i) for i in rot])
        rec["warm_ms"] = cuda_ms(lambda: call(valid))
        rec["plain_ms"] = cuda_ms(lambda: da.decode_attention_plain(
            q, k_all[layer], v_all[layer], keep), iters=5, warmup=1)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        q4, mask = q[:, :, None, :], keep[:, None, None, :] > 0
        gqa = dict(enable_gqa=True) if nq != nkv else {}
        rec["library_ms"], rec["library_host_us"], lib_queued = queued_ms(
            [lambda i=i: sdpa(q4, k_all[i], v_all[i], attn_mask=mask, **gqa)
             for i in rot])
        rec["queued"] &= lib_queued
        # K/V bytes of the kept slots only: the others are never needed
        kept = rec["kept_slots"]
        flops = 4.0 * hd * kept * nq
        nbytes = (2 * (q.numel() * 2 + 2 * kept * nkv * hd) + valid.numel()
                  + (4 * b if window is not None else 0))
        rec["bound_ms"], rec["bound_by"] = bound_ms(flops, nbytes)
        rec["flops"], rec["bytes"] = flops, nbytes
    del k_all, v_all
    return rec


def phase_kernels():
    import numpy as np
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rng = np.random.default_rng(0)
    recs = []
    # K1 at the main path's prefill shape: 8 left-padded prompts, L 512
    lengths = [int(x) for x in rng.integers(100, 513, size=8)]
    lengths[0] = 512
    seg = left_padded_seg(lengths, 512, "cuda")
    recs.append(check_flash_fwd("main_prefill", 8, 512, 32, 32, 128, seg,
                                True, gen, timed=True))
    # GQA 32/8, L 500 (ragged last tile), multi-segment rows, one all-pad row
    seg = packed_seg(rng, 4, 500, 3, {2}, "cuda")
    recs.append(check_flash_fwd("gqa_packed_ragged", 4, 500, 32, 8, 128, seg,
                                True, gen, timed=False))
    # the sft path's microbatch: one stream of ~4 k tokens in 8 segments
    seg = sft_stream_seg(rng, 8, 4096, "cuda")
    recs.append(check_flash_fwd("sft_microbatch", 1, 4096, 32, 32, 128, seg,
                                True, gen, timed=True, plant_fault=True))
    # hd 64, causal and not
    seg = packed_seg(rng, 3, 256, 2, {1}, "cuda")
    for causal in (True, False):
        recs.append(check_flash_fwd(f"hd64_causal{int(causal)}", 3, 256, 16,
                                    4, 64, seg, causal, gen, timed=False))
    # the tile-skipping rule at its edges: ids that recur out of order,
    # one segment over many tiles then short ones, and a row whose first
    # q tiles are all padding
    for causal in (True, False):
        recs.append(check_flash_fwd(
            f"recurring_ids_causal{int(causal)}", 2, 1000, 16, 8, 128,
            recurring_seg(rng, 2, 1000, "cuda"), causal, gen, timed=False,
            plant_fault=causal))
    recs.append(check_flash_fwd(
        "long_then_short", 1, 2100, 16, 16, 128,
        long_then_short_seg(rng, 2100, 1500, "cuda"), True, gen,
        timed=False, plant_fault=True))
    recs.append(check_flash_fwd(
        "leading_pad_tiles_hd64", 3, 777, 8, 2, 64,
        leading_pad_seg(rng, 3, 777, (300, 0, 777), "cuda"), True, gen,
        timed=False))
    # K4 at the main path's decode shape: B 8, S 640, MHA; low slots of
    # each stream invalid (left padding), stream 5 empty
    spans = [(512 - n, 512 + 64) for n in lengths]
    spans[5] = (0, 0)
    recs.append(check_flash_decode("main_decode_mha", 8, 640, 32, 32, 128,
                                   spans, gen, timed=True))
    recs.append(check_flash_decode("gqa_32_4", 8, 640, 32, 4, 128, spans,
                                   gen, timed=False))
    recs.append(check_flash_decode("gqa_32_8", 8, 640, 32, 8, 128, spans,
                                   gen, timed=True))
    recs.append(check_flash_decode("hd64_ragged_s", 4, 200, 8, 8, 64,
                                   [(10, 150), (0, 200), (0, 0), (199, 200)],
                                   gen, timed=False))
    # the tile walk at its edges: one stream, a sliding window, a stream
    # whose one kept slot is in the last tile, streams whose kept slots
    # leave whole tiles out in between
    recs.append(check_flash_decode("b1", 1, 640, 32, 32, 128, [(212, 576)],
                                   gen, timed=False))
    recs.append(check_flash_decode("window_96", 8, 640, 32, 8, 128, spans,
                                   gen, timed=False, window=96))
    recs.append(check_flash_decode(
        "last_tile_only", 4, 640, 32, 8, 128,
        [(639, 640), (0, 640), (300, 400), (0, 0)], gen, timed=False))
    recs.append(check_flash_decode(
        "interior_holes", 4, 700, 16, 4, 64,
        [[(10, 60), (300, 310), (600, 700)], [(0, 64), (192, 256)],
         [(5, 6), (699, 700)], [(130, 131), (131, 140), (450, 460)]],
        gen, timed=False))
    # K5: a middle layer of a stacked cache, same per-layer shape as K4
    recs.append(check_flash_decode("stacked_mid_layer", 8, 640, 32, 32, 128,
                                   spans, gen, timed=True, stacked_layers=4,
                                   layer=2))
    recs += serve_kernel_cases(gen)
    del gen
    torch.cuda.empty_cache()
    return recs


def serve_kernel_cases(gen):
    """K1 and K4 at the serving engine's shapes: K1 at batch 1 over the
    prefill buckets (one left-padded prompt), and K4 over a gathered
    window of S 384 with the masks inflight slots give it (a compacted
    paged window, left padding inside a bucket, a donor / suffix-bucket
    gap, an idle slot past its window (all valid), a short fill, rows
    left valid by a previous occupant, a lone last row, scattered
    single rows)."""
    recs = []
    for lp, n in ((64, 37), (256, 200), (512, 433)):
        recs.append(check_flash_fwd(
            f"serve_prefill_b1_{lp}", 1, lp, 32, 32, 128,
            left_padded_seg([n], lp, "cuda"), True, gen, timed=True))
    spans = [(0, 300), (56, 296), [(0, 100), (134, 174)], (0, 384),
             (0, 20), (10, 383), (383, 384), [(0, 1), (200, 201), (383, 384)]]
    recs.append(check_flash_decode("serve_inflight_window_s384", 8, 384, 32,
                                   32, 128, spans, gen, timed=True))
    return recs


# ----------------------------------------------------------------------
# phase 3, K6: the ring against the plain ring
# ----------------------------------------------------------------------
PEAK_LINK_BYTES = 450e9    # H100 SXM NVLink, each way
CTX_MEMBERS = 4
# the ctx-7b-c4 stream: five documents, then padding (32768 tokens)
CTX_DOCS = (12288, 7168, 6144, 4096, 2816)
CTX_PAD = 256


def member_devices(n):
    """Member i on ``cuda:(i mod cards)``: the members spread over four
    cards when the machine has them, and all sit on cuda:0 (passed
    explicitly) when it has one."""
    import torch
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n)]


def doc_stream_seg(docs, pad, device):
    """[1, L] segment ids: the documents one after another, then pad."""
    import torch
    seg = torch.zeros((1, sum(docs) + pad), dtype=torch.int32, device=device)
    off = 0
    for i, n in enumerate(docs):
        seg[0, off:off + n] = i + 1
        off += n
    return seg


def ring_shards(t, devs):
    """[B, L, ...] -> member i's contiguous i-th shard along L on devs[i]."""
    lc = t.shape[1] // len(devs)
    return [t[:, i * lc:(i + 1) * lc].to(d).contiguous()
            for i, d in enumerate(devs)]


def ring_gather(shards):
    import torch
    return torch.cat([s.to("cuda:0") for s in shards], dim=1)


def sync_all():
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def ring_bound(seg, devs, nq, nkv, hd, causal, window):
    """The least time for the ring's work on these cards, counting only
    what the function needs: per card the FLOPs of the (query, key) pairs
    its members' rows are allowed; the HBM bytes of their q/k/v rows of
    seg != 0 tokens, o and seg; and the NVLink bytes of the k/v/seg rows
    of its shards that a query on another card is allowed to see, once
    per such card (sent by this card, received by that one, each way at
    ``PEAK_LINK_BYTES``). Not what the ring schedule moves: a row no
    other card needs need not leave its card. The slowest card's largest
    term."""
    from realhf_tpu_torch.ops.flash_attention import segment_mask
    n = len(devs)
    b, L = seg.shape
    lc = L // n
    mask = segment_mask(seg, seg, causal, window)   # [B, Lq, Lk]
    row_bytes = 2 * 2 * nkv * hd + 4
    shards = {}
    for j, d in enumerate(devs):
        shards.setdefault(d, []).append(slice(j * lc, (j + 1) * lc))
    cards = {d: dict(flops=0.0, bytes=0.0, link_out=0.0, link_in=0.0)
             for d in shards}
    for d, rows in shards.items():
        c = cards[d]
        for r in rows:
            c["flops"] += 4.0 * hd * nq * float(mask[:, r].sum())
            tokens = int((seg[:, r] != 0).sum())
            c["bytes"] += 2 * tokens * (nq + 2 * nkv) * hd \
                + 2 * b * lc * nq * hd + 4 * b * lc
    for src, keys in shards.items():
        for dst, queries in shards.items():
            if dst == src:
                continue
            for kr in keys:
                need = keys_seen(mask, queries, kr)
                cards[src]["link_out"] += need * row_bytes
                cards[dst]["link_in"] += need * row_bytes
    times = []
    for c in cards.values():
        terms = {"operations": c["flops"] / PEAK_BF16_FLOPS,
                 "bytes": max(c["bytes"] / PEAK_BYTES,
                              max(c["link_out"], c["link_in"])
                              / PEAK_LINK_BYTES)}
        times.append((max(terms.values()), max(terms, key=terms.get)))
    t, by = max(times)
    return t * 1e3, by, {str(d): c for d, c in cards.items()}


def keys_seen(mask, query_slices, key_slice) -> int:
    """How many (stream, key) of ``key_slice`` some query of
    ``query_slices`` may see under ``mask`` [B, Lq, Lk]."""
    need = None
    for qr in query_slices:
        seen = mask[:, qr, key_slice].any(dim=1)
        need = seen if need is None else need | seen
    return int(need.sum())


def check_ring(name, b, n, nq, nkv, hd, seg, gen, **kw):
    """K6 on random bf16 q/k/v over the stream ``seg`` [B, L], sharded
    over ``member_devices(n)``: ``compare_ring``."""
    import torch
    devs = member_devices(n)
    q = torch.randn((b, seg.shape[1], nq, hd), generator=gen,
                    device="cuda").bfloat16()
    k, v = (torch.randn((b, seg.shape[1], nkv, hd), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    shards = [ring_shards(t, devs) for t in (q, k, v, seg)]
    del q, k, v
    return compare_ring(name, *shards, **kw)


def compare_ring(name, qs, ks, vs, segs, *, causal=True, window=None,
                 scale=None, bidirectional=True, timed=False,
                 plant_faults=False):
    """K6 (ring_attention_fused on CUDA members) against
    ring_attention_plain on the same bf16 values widened to fp32, with
    the members on the devices their shards lie on: the largest error of
    a row over that row's RMS, padding rows exactly 0. With
    ``plant_faults``, two broken rings must exceed the limit: member 1
    skipping round 1, and local in place of global offsets."""
    import torch
    from realhf_tpu_torch.ops import ring_attention as ra
    from realhf_tpu_torch.ops import ring_attention_fused as rf
    devs = [t.device for t in qs]
    n = len(qs)
    b, lc, nq, hd = qs[0].shape
    nkv = ks[0].shape[2]
    L = n * lc
    seg = ring_gather(segs)
    kw = dict(causal=causal, sliding_window=window, scale=scale)

    def call():
        return rf.ring_attention_fused(qs, ks, vs, segs,
                                       bidirectional=bidirectional, **kw)

    def plain():
        return ra.ring_attention_plain(
            [t.float() for t in qs], [t.float() for t in ks],
            [t.float() for t in vs], segs, block_q=1024, block_k=1024, **kw)

    with torch.no_grad():
        o = ring_gather(call())
        sync_all()
        ref = ring_gather(plain())
    rows = (seg != 0)[:, :, None].expand(b, L, nq)
    limit = LIMITS["ring_row_rel"]
    n_dirs = rf._plan_dirs(lc, 512, bidirectional)[0] if n > 1 else 1
    rec = dict(kernel="ring_attention", case=name, shape=[b, L, nq, nkv, hd],
               members=n, member_devices=[str(d) for d in devs], lc=lc,
               n_dirs=n_dirs, causal=causal, sliding_window=window,
               max_abs_err=max_err(o, ref), row_rel_err=row_rel_err(o, ref, rows),
               row_rel_limit=limit,
               masked_rows_zero=bool((o.float()[~rows] == 0).all()),
               finite=bool(torch.isfinite(o.float()).all()))
    rec["ok"] = (rec["row_rel_err"] <= limit and rec["masked_rows_zero"]
                 and rec["finite"])
    rec["walked_pairs"] = ring_walked_pairs(seg, n, n_dirs, causal, window)
    rec["allowed_pairs"] = allowed_pairs(seg, causal, window)
    if plant_faults:
        orig = rf._launch_round

        def broken(fault):
            calls = [0]

            def launch(q_, seg_q, kv, *a, q_off, k_offs, **kw_):
                i = calls[0]
                calls[0] += 1
                if fault == "skip" and i == n + 1:   # member 1, round 1
                    return
                if fault == "local":
                    lch = kv[0][0].shape[1]
                    q_off, k_offs = 0, [d * lch for d in range(len(kv))]
                orig(q_, seg_q, kv, *a, q_off=q_off, k_offs=k_offs, **kw_)

            rf._launch_round = launch
            try:
                with torch.no_grad():
                    bad = ring_gather(call())
            finally:
                rf._launch_round = orig
            return row_rel_err(bad, ref, rows)

        rec["planted_faults"] = {
            "member 1 skips round 1": broken("skip"),
            "local offsets in place of global": broken("local")}
        rec["ok"] &= all(e > limit for e in rec["planted_faults"].values())
    if timed:
        import torch.nn.functional as tf
        from realhf_tpu_torch.ops.flash_attention import segment_mask
        with torch.no_grad():
            rec["ms"] = cuda_ms(call, iters=3, warmup=1)
            rec["plain_ms"] = cuda_ms(plain, iters=1, warmup=0)
            mask = segment_mask(seg, seg, causal, window)[:, None]
            qt, kt, vt = (ring_gather(t).transpose(1, 2).contiguous()
                          for t in (qs, ks, vs))
            gqa = dict(enable_gqa=True) if nq != nkv else {}
            rec["library_ms"] = cuda_ms(lambda: tf.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=scale, **gqa), iters=3,
                warmup=1)
            del mask, qt, kt, vt
        rec["bound_ms"], rec["bound_by"], rec["bound_per_card"] = ring_bound(
            seg, devs, nq, nkv, hd, causal, window)
        if n > 1 and len(set(devs)) == 1:
            # the same work with one member per card, for the reading
            # of a machine of n cards (the bound needs no such card)
            rec["bound_ms_card_per_member"], rec["bound_by_card_per_member"], _ \
                = ring_bound(seg, [torch.device("cuda", j) for j in range(n)],
                             nq, nkv, hd, causal, window)
    del o, ref
    torch.cuda.empty_cache()
    return rec


def check_ring_push(b, lch, nkv, hd, gen, timed):
    """The push kernel alone at the ctx path's halves: member 0's six
    ranges (k, v and seg of each direction) into member 1 (direction 0)
    and member n - 1 (direction 1) of ``member_devices``; the copies must
    be bit-exact."""
    import torch
    from realhf_tpu_torch.ops import ring_attention_fused as rf
    devs = member_devices(CTX_MEMBERS)
    src, right, left = devs[0], devs[1], devs[-1]
    pairs = []
    for dst_dev in (right, left):
        k = torch.randn((b, lch, nkv, hd), generator=gen,
                        device="cuda").bfloat16().to(src)
        v = torch.randn_like(k)
        s = torch.randint(0, 9, (b, lch), dtype=torch.int32, device=src)
        pairs += [(t, torch.empty_like(t, device=dst_dev)) for t in (k, v, s)]
    for d in (right, left):
        if d != src:
            rf._enable_peer(src, d)
    with torch.cuda.device(src):
        rf._launch_push(pairs)
    sync_all()
    rec = dict(kernel="ring_push", case="ctx_7b_c4_halves",
               member_devices=[str(d) for d in devs],
               bytes=sum(s.numel() * s.element_size() for s, _ in pairs),
               max_abs_err=max(max_err(s, d.to(src)) for s, d in pairs))
    rec["ok"] = all(torch.equal(s, d.to(src)) for s, d in pairs)
    if timed:
        srcs, dsts = [s for s, _ in pairs], [d for _, d in pairs]
        with torch.cuda.device(src):
            rec["ms"] = cuda_ms(lambda: rf._launch_push(pairs))
            rec["plain_ms"] = cuda_ms(
                lambda: [d.copy_(s) for s, d in pairs])
            foreach = getattr(torch, "_foreach_copy_", None)
            rec["library_ms"] = (cuda_ms(lambda: foreach(dsts, srcs))
                                 if foreach is not None else None)
        half = rec["bytes"] // 2
        # each range read once and written once; to another card the
        # writes cross NVLink (both directions leave this card)
        link = sum(half for d in (right, left) if d != src)
        local = sum(half for d in (right, left) if d == src)
        t_bytes = (rec["bytes"] + local) / PEAK_BYTES
        t_link = link / PEAK_LINK_BYTES
        rec["bound_ms"], rec["bound_by"] = max(t_bytes, t_link) * 1e3, "bytes"
    del pairs
    torch.cuda.empty_cache()
    return rec


def phase_kernels_ring():
    """K6 cases: the ctx-7b-c4 stream (n 4, lc 8192, 32/32 heads, hd
    128; timed, with the planted faults), GQA 8/2 at hd 64 with ragged
    tiles and an all-padding row, non-causal, a sliding window,
    unidirectional, n 2, n 8, one member and ids that recur across
    shards; then the push kernel at the ctx path's halves."""
    import numpy as np
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    rng = np.random.default_rng(3)
    main = doc_stream_seg(CTX_DOCS, CTX_PAD, "cuda")
    recs = [check_ring("ctx_7b_c4", 1, CTX_MEMBERS, 32, 32, 128, main, gen,
                       timed=True, plant_faults=True)]
    seg = packed_seg(rng, 3, 800, 4, {1}, "cuda")   # lc 200, halves of 100
    recs.append(check_ring("gqa_8_2_hd64_ragged", 3, 4, 8, 2, 64, seg, gen))
    seg = packed_seg(rng, 2, 2048, 3, set(), "cuda")
    recs.append(check_ring("noncausal", 2, 4, 8, 8, 128, seg, gen,
                           causal=False))
    recs.append(check_ring("window_300", 2, 4, 8, 8, 128, seg, gen,
                           window=300))
    recs.append(check_ring("unidirectional", 2, 4, 8, 8, 128, seg, gen,
                           bidirectional=False))
    recs.append(check_ring("n2", 2, 2, 8, 4, 128, seg, gen))
    seg = packed_seg(rng, 1, 4096, 6, set(), "cuda")
    recs.append(check_ring("n8", 1, 8, 16, 16, 128, seg, gen))
    recs.append(check_ring("n1", 1, 1, 16, 16, 128, seg[:, :1024], gen))
    # ids that recur out of order more than 64 tokens apart, across
    # shards: the residue test on global offsets
    recs.append(check_ring("recurring_ids", 2, 4, 8, 8, 128,
                           recurring_seg(rng, 2, 2048, "cuda"), gen))
    lch = sum(CTX_DOCS + (CTX_PAD,)) // CTX_MEMBERS // 2
    recs.append(check_ring_push(1, lch, 32, 128, gen, timed=True))
    del gen
    torch.cuda.empty_cache()
    return recs


# ----------------------------------------------------------------------
# phases 4-6: the gen experiment through the port's entry points, and
# a profile of one generate call
# ----------------------------------------------------------------------
def write_prompts(path, n, seed, lo=100, hi=512):
    import numpy as np
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            words = rng.integers(0, 5000, size=int(rng.integers(lo, hi + 1)))
            f.write(json.dumps({"id": i, "prompt": " ".join(
                f"w{int(w)}" for w in words)}) + "\n")


def reset_counts():
    from realhf_tpu_torch.ops import decode_attention as da
    from realhf_tpu_torch.ops import flash_attention as fa
    from realhf_tpu_torch.ops import ring_attention_fused as rf
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    fa.dq_ring_launches = fa.dkv_ring_launches = 0
    da.launches = 0
    da.stacked_launches = 0
    da.stats_launches = 0
    rf.round_launches = rf.round_lse_launches = rf.push_launches = 0


def read_counts():
    from realhf_tpu_torch.ops import decode_attention as da
    from realhf_tpu_torch.ops import flash_attention as fa
    from realhf_tpu_torch.ops import ring_attention_fused as rf
    return dict(flash_fwd=fa.launches, flash_bwd_dq=fa.dq_launches,
                flash_bwd_dkv=fa.dkv_launches, flash_decode=da.launches,
                flash_decode_stacked=da.stacked_launches,
                ring_round=rf.round_launches, ring_push=rf.push_launches,
                flash_bwd_dq_ring=fa.dq_ring_launches,
                flash_bwd_dkv_ring=fa.dkv_ring_launches,
                ring_round_lse=rf.round_lse_launches,
                flash_decode_stats=da.stats_launches)


#: the launches of the ring's backward (K2/K3 at ring rounds, K6's last
#: round with the lse) in a path that trains no context-parallel layout,
#: and of K4 with its statistics (the "seq" route) in a path that decodes
#: on no replicated-KV layout
NO_RING_BWD = dict(flash_bwd_dq_ring=0, flash_bwd_dkv_ring=0,
                   ring_round_lse=0, flash_decode_stats=0)


def build_gen_spec(data_path, n_layers, max_new_tokens, benchmark_steps,
                   model_config=None, max_seqlen=512, seed=1):
    """The gen experiment over ``data_path`` with 8 prompts a batch, at
    LLaMA-7B with ``n_layers`` or at ``model_config`` (a
    ``random_init_config``)."""
    from realhf_tpu_torch.base.testing import IntegerTokenizer
    from realhf_tpu_torch.experiments.common import apply_overrides
    from realhf_tpu_torch.experiments.gen_exp import GenerationConfig
    from realhf_tpu_torch.models.config import llama_config
    cfg = GenerationConfig(experiment_name="chip-smoke", trial_name="t0",
                           benchmark_steps=benchmark_steps, seed=seed)
    apply_overrides(cfg, {"dataset.path": data_path,
                          "dataset.train_bs_n_seqs": "8",
                          "dataset.max_seqlen": str(max_seqlen),
                          "max_new_tokens": str(max_new_tokens),
                          "greedy": "true"})
    spec = cfg.build()
    mspec = spec.models["default"]
    mspec.random_init_config = (model_config
                                or llama_config("7b", n_layers=n_layers))
    mspec.bf16 = True
    vocab = mspec.random_init_config["vocab_size"]
    spec.tokenizer = IntegerTokenizer(vocab_size=vocab - 2)
    return spec, vocab


def check_gen_output(runner, vocab) -> bool:
    import numpy as np
    batch = runner.last_batch
    ids = batch.data["packed_input_ids"]
    return bool(ids.dtype == np.int32 and ids.min() >= 0
                and ids.max() < vocab
                and batch.total_len("packed_input_ids")
                > batch.total_len("packed_prompts"))


def step_summary(st, smi):
    steps = st["decode_steps"]
    return dict(decode_steps=steps, generated_tokens=st["generated_tokens"],
                prefill_ms=st["prefill_secs"] * 1e3,
                decode_ms_per_token=st["decode_secs"] * 1e3 / max(steps, 1),
                generated_tokens_per_s=st["generated_tokens"]
                / (st["prefill_secs"] + st["decode_secs"]),
                card=smi)


def phase_gen(n_layers, max_new_tokens, smi, with_sampled_step):
    """Two greedy steps (one for the deep model) of ``InlineRunner.run``,
    then, with ``with_sampled_step``, one sampled step of a second
    ``run`` call (its step count is already past ``benchmark_steps``)."""
    import torch
    from realhf_tpu_torch.ops.sampling import GenerationHyperparameters
    from realhf_tpu_torch.system.inline import InlineRunner
    greedy_steps = 2 if with_sampled_step else 1
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "prompts.jsonl")
        write_prompts(data, 8 * greedy_steps, seed=1)
        spec, vocab = build_gen_spec(data, n_layers, max_new_tokens,
                                     greedy_steps)
        t0 = time.monotonic()
        runner = InlineRunner(spec)  # device=None: the card
        torch.cuda.synchronize()
        setup = time.monotonic() - t0
        eng = runner.models["default"].engine
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        runner.run()
        outputs_ok = check_gen_output(runner, vocab)
        if with_sampled_step:
            runner.interfaces["gen"].gconfig = GenerationHyperparameters(
                max_new_tokens=max_new_tokens, greedy=False, top_k=50,
                top_p=0.9, force_no_logits_mask=True)
            runner.run()
            outputs_ok &= check_gen_output(runner, vocab)
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        stats = eng.generate_stats
        n_calls = len(stats)
        n_decode = sum(st["decode_steps"] for st in stats)
        decode_key = ("flash_decode_stacked" if n_layers > 48
                      else "flash_decode")
        other_key = ("flash_decode" if n_layers > 48
                     else "flash_decode_stacked")
        counts_ok = (counts["flash_fwd"] == n_layers * n_calls
                     and counts[decode_key] == n_layers * n_decode
                     and counts[other_key] == 0
                     and counts["flash_bwd_dq"] == 0
                     and counts["flash_bwd_dkv"] == 0
                     and counts["ring_round"] == counts["ring_push"] == 0)
        labels = ["greedy"] * greedy_steps + (
            ["sampled_topk50_topp0.9"] if with_sampled_step else [])
        steps = [dict(step=lab, **step_summary(st, smi))
                 for lab, st in zip(labels, stats)]
        del runner, eng
        torch.cuda.empty_cache()
    return dict(n_layers=n_layers, setup_secs=setup,
                steps=steps, generate_calls=n_calls,
                launches=counts, launches_ok=counts_ok,
                outputs_in_range=outputs_ok, peak_mem_gb=peak, card=smi,
                ok=counts_ok and outputs_ok and n_calls == len(labels))


def device_kernel_us(prof):
    """(total kernel time in us, top kernels by time) from a profiler
    run; (None, []) when the trace holds no device events."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.device_type == cuda]
    if not rows:
        return None, []
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    top = [dict(kernel=k[:80], us=us, calls=n, share=us / total)
           for k, us, n in rows[:12]]
    return total, top


def phase_profile(smi):
    """Device busy share and kernel breakdown of one 7B generate call
    (8 prompts, 16 greedy new tokens, EOS early-exit checks on): a
    torch.profiler trace of prefill alone, then of the whole call."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from realhf_tpu_torch.base import seeding
    from realhf_tpu_torch.engine import packing
    from realhf_tpu_torch.engine.engine import Engine
    from realhf_tpu_torch.models import transformer as T
    from realhf_tpu_torch.models.config import TransformerConfig, llama_config
    from realhf_tpu_torch.ops.sampling import GenerationHyperparameters
    cfg = TransformerConfig(**llama_config("7b"), param_dtype="bfloat16",
                            compute_dtype="bfloat16")
    eng = Engine(cfg, T.init_params(cfg, seeding.generator(11, "cuda"),
                                    "cuda"))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(2, 32000, size=int(n)).astype(np.int32)
               for n in rng.integers(100, 513, size=8)]
    ids, seg, pos = packing.left_padded_prompts(prompts, pad_id=0)
    gc = GenerationHyperparameters(max_new_tokens=16, greedy=True,
                                   force_no_logits_mask=True)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def call():
        return eng.generate(ids, seg, pos, None, gc, eos_token_id=1,
                            pad_token_id=0)

    call()  # warm up
    t = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=acts) as prof_p:
            t0 = time.monotonic()
            T.prefill(cfg, eng.params, t(ids), t(seg), t(pos),
                      total_len=ids.shape[1] + 16)
            torch.cuda.synchronize()
            prefill_wall = time.monotonic() - t0
    with profile(activities=acts) as prof_g:
        t0 = time.monotonic()
        out = call()
        wall = time.monotonic() - t0
    pre_us, pre_top = device_kernel_us(prof_p)
    all_us, all_top = device_kernel_us(prof_g)
    rec = dict(card=smi, decode_steps=out.stats["decode_steps"],
               prefill_wall_ms=prefill_wall * 1e3,
               generate_wall_ms=wall * 1e3)
    if pre_us is None or all_us is None:
        rec["device_time"] = "not measured (no device events in the trace)"
    else:
        steps = out.stats["decode_steps"]
        dec_wall = wall - out.stats["prefill_secs"]
        dec_us = all_us - pre_us
        rec.update(
            prefill_kernel_ms=pre_us / 1e3,
            prefill_busy_share=pre_us / 1e6 / prefill_wall,
            decode_kernel_ms_per_step=dec_us / 1e3 / steps,
            decode_wall_ms_per_step=dec_wall * 1e3 / steps,
            decode_busy_share=dec_us / 1e6 / dec_wall,
            prefill_top=pre_top, generate_top=all_top)
    del eng
    torch.cuda.empty_cache()
    return rec


# ----------------------------------------------------------------------
# phases 7-8: the sft experiment at 7B width, and a profile of one step
# ----------------------------------------------------------------------
SFT_LAYERS = 8


def write_prompt_answers(path, n, seed, lo=100, hi=400):
    import numpy as np
    rng = np.random.default_rng(seed)

    def words(k):
        return " ".join(f"w{int(w)}" for w in rng.integers(0, 5000, size=k))

    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps({
                "id": i, "prompt": words(int(rng.integers(lo, hi + 1))),
                "answer": " " + words(int(rng.integers(lo, hi + 1)))}) + "\n")


def build_sft_spec(data_path, n_layers, lr="1e-5", model_config=None,
                   overrides=None):
    """The sft cell's spec (``overrides`` replace its CLI settings)."""
    from realhf_tpu_torch.base.testing import IntegerTokenizer
    from realhf_tpu_torch.experiments.common import apply_overrides
    from realhf_tpu_torch.experiments.sft_exp import SFTConfig
    from realhf_tpu_torch.models.config import llama_config
    cfg = SFTConfig(experiment_name="chip-smoke", trial_name="sft",
                    total_train_epochs=3)
    apply_overrides(cfg, {"dataset.path": data_path,
                          "dataset.valid_path": data_path,
                          "dataset.train_bs_n_seqs": "16",
                          "dataset.max_seqlen": "1024",
                          "n_mbs": "2", "model.optimizer.lr": lr,
                          "eval_freq_epochs": "3", **(overrides or {})})
    spec = cfg.build()
    mspec = spec.models["default"]
    mspec.random_init_config = (model_config
                                or llama_config("7b", n_layers=n_layers))
    vocab = mspec.random_init_config["vocab_size"]
    spec.tokenizer = IntegerTokenizer(vocab_size=vocab - 2)
    return spec


def leaf_names(tree, prefix=""):
    """Dotted paths of a param tree in the engine's (sorted) leaf order."""
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out += leaf_names(tree[k], f"{prefix}{k}.")
        else:
            out.append(prefix + k)
    return out


def grad_slices(name, g, n_layers):
    """A leaf's gradient as rows to judge one by one: one per layer for
    the stacked block leaves, the whole leaf otherwise."""
    return g.reshape(n_layers, -1) if name.startswith("blocks.") \
        else g.reshape(1, -1)


def capture_first_grads(opt):
    """Record the fp32 gradient list of the next optimizer step (the
    accumulated, unclipped sums) by wrapping the optimizer's ``step``;
    the wrapper keeps a reference, which the caller drops."""
    seen = []
    orig = opt.step

    def step(params, grads):
        if not seen:
            seen.append([g.clone() for g in grads])
        return orig(params, grads)

    opt.step = step
    return seen


def phase_sft(smi):
    """The sft experiment through ``SFTConfig.build()`` and
    ``InlineRunner`` at 7B width and 8 layers, bf16, gradient
    checkpointing: 3 epochs over one batch of 16 prompt-answer records
    in 2 microbatches, then eval on the same file. Checks falling loss,
    a finite non-zero gradient for every layer of every leaf on step 1,
    and exact launch counts."""
    import torch
    from realhf_tpu_torch.system.inline import InlineRunner
    from realhf_tpu_torch.interfaces import common
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "sft.jsonl")
        write_prompt_answers(data, 16, seed=3)
        spec = build_sft_spec(data, SFT_LAYERS)
        t0 = time.monotonic()
        runner = InlineRunner(without_saves(spec))  # the card
        torch.cuda.synchronize()
        setup = time.monotonic() - t0
    eng = runner.models["default"].engine
    names = leaf_names(eng.params)
    seen = capture_first_grads(eng.optimizer)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    runner.run()
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del eng.optimizer.step  # drop the wrapper
    steps = [st["trainDefault"] for st in runner.step_stats]
    losses = [st["loss"] for st in steps]
    loss_ok = (len(losses) == 3
               and all(math.isfinite(x) for x in losses)
               and all(b < a for a, b in zip(losses, losses[1:])))
    grads = {}
    for name, g in zip(names, seen[0] if seen else []):
        rows = grad_slices(name, g, SFT_LAYERS).abs().amax(-1)
        grads[name] = dict(finite=bool(torch.isfinite(g).all()),
                           min_slice_absmax=float(rows.min()))
    grads_ok = (len(grads) == len(names)
                and all(v["finite"] and v["min_slice_absmax"] > 0
                        for v in grads.values()))
    n_eval_batches = len(runner.eval_dataloader)
    evals = [ev for _, _, ev in runner.eval_stats]
    n_bwd = SFT_LAYERS * 2 * 3  # layers x microbatches x steps
    want = dict(flash_fwd=2 * n_bwd + SFT_LAYERS * n_eval_batches * len(evals),
                flash_bwd_dq=n_bwd, flash_bwd_dkv=n_bwd, flash_decode=0,
                flash_decode_stacked=0, ring_round=0,
                ring_push=0, **NO_RING_BWD)
    tokens = runner.last_batch.total_len("packed_input_ids")
    mb_tokens = [mb.total_len("packed_input_ids") for mb in
                 common.split_minibatches(runner.last_batch, 2)]
    rec = dict(n_layers=SFT_LAYERS, setup_secs=setup, card=smi,
               tokens_per_step=tokens, microbatch_tokens=mb_tokens,
               losses=losses,
               grad_norms=[st["grad_norm"] for st in steps],
               step_secs=list(runner.step_secs),
               train_tokens_per_s=[tokens / t for t in runner.step_secs],
               peak_mem_gb=peak, evals=evals, launches=counts,
               launches_expected=want, launches_ok=counts == want,
               loss_strictly_falling=loss_ok, step1_grads_ok=grads_ok,
               step1_grads=grads)
    rec["eval_ok"] = len(evals) == 1 and math.isfinite(evals[0]["loss"])
    rec["ok"] = (loss_ok and grads_ok and rec["launches_ok"]
                 and rec["eval_ok"])
    return runner, rec


def kernel_category(name: str, kernels=("flash_fwd", "flash_bwd_dq",
                                         "flash_bwd_dkv")) -> str:
    for kernel in kernels:
        if f"{kernel}_kernel" in name:
            return kernel
    if any(t in name.lower() for t in ("gemm", "nvjet", "xmma", "cutlass")):
        return "gemm"
    return "other"


def phase_sft_profile(runner, smi):
    """A torch.profiler trace of one more sft step on the same batch:
    device time by kernel category, the optimizer step's device time
    (CUDA events around it) and the busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    opt = runner.models["default"].engine.optimizer
    orig = opt.step
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def timed(params, grads):
        ev[0].record()
        orig(params, grads)
        ev[1].record()

    opt.step = timed
    batch = runner.last_batch
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        runner.run_step(batch)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    del opt.step
    cuda = torch.autograd.DeviceType.CUDA
    by_cat = {}
    for e in prof.key_averages():
        if e.device_type == cuda:
            cat = kernel_category(e.key)
            by_cat[cat] = by_cat.get(cat, 0.0) + e.self_device_time_total
    total_us, top = device_kernel_us(prof)
    rec = dict(card=smi, step_wall_ms=wall * 1e3,
               optimizer_step_ms=ev[0].elapsed_time(ev[1]))
    if total_us is None:
        rec["device_time"] = "not measured (no device events in the trace)"
    else:
        rec.update(kernel_ms=total_us / 1e3,
                   busy_share=total_us / 1e6 / wall,
                   ms_by_category={k: v / 1e3 for k, v in by_cat.items()},
                   share_by_category={k: v / total_us
                                      for k, v in by_cat.items()},
                   optimizer_share=rec["optimizer_step_ms"] * 1e3 / total_us,
                   top=top)
    return rec


# the largest relative loss difference of a step, port against the plain
# fp32 reference at lr 1e-4: about 3x the sound reading (PERF.md, Findings)
LR_WITNESS_LIMIT = 0.025


def phase_sft_lr(smi):
    """The sft cell at lr 1e-4, where its loss rises on step 3: 3 steps
    of the port (bf16, the kernels, through ``InlineRunner``), then 3
    steps of a plain reference on the card from the same initial weights
    and batch: fp32 weights, compute and optimizer state, attention
    through ``packed_attention_plain`` (patched into the model here, for
    this run only) and an fp32 LM head. Each step's loss must agree
    within the limit, and the lr 1e-5 trajectory of phase sft must not
    (so the limit tells trajectories apart)."""
    import dataclasses
    import torch
    from realhf_tpu_torch.api.model import Model
    from realhf_tpu_torch.engine.engine import Engine
    from realhf_tpu_torch.interfaces.sft import SFTInterface
    from realhf_tpu_torch.models import transformer as T
    from realhf_tpu_torch.ops.attention import packed_attention_plain
    from realhf_tpu_torch.system.inline import InlineRunner
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "sft.jsonl")
        write_prompt_answers(data, 16, seed=3)
        runner = InlineRunner(without_saves(
            build_sft_spec(data, SFT_LAYERS, lr="1e-4")))
    model = runner.models["default"]
    init = _tree_map(lambda t: t.float(), model.engine.params)  # new fp32
    runner.run()
    port = [st["trainDefault"]["loss"] for st in runner.step_stats]
    batch, cfg = runner.last_batch, model.engine.cfg
    opt_cfg = model.engine.optimizer.cfg
    n_steps = len(port)
    del runner
    model.engine = None
    torch.cuda.empty_cache()
    ref_cfg = dataclasses.replace(cfg, param_dtype="float32",
                                  compute_dtype="float32")
    ref_model = Model(name=model.name, tokenizer=model.tokenizer,
                      engine=Engine(ref_cfg, init, "cuda", optimizer=opt_cfg,
                                    total_train_steps=n_steps))
    del init
    plain_fp32 = (torch.get_float32_matmul_precision() == "highest"
                  and not torch.backends.cuda.matmul.allow_tf32)
    attn, T.packed_attention = T.packed_attention, packed_attention_plain
    t0 = time.monotonic()
    try:
        ref = [SFTInterface().train_step(ref_model, batch, n_mbs=2)["loss"]
               for _ in range(n_steps)]
        torch.cuda.synchronize()
    finally:
        T.packed_attention = attn
    ref_secs = time.monotonic() - t0
    del ref_model
    torch.cuda.empty_cache()

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    rec = dict(card=smi, lr=1e-4, port_losses=port, reference_losses=ref,
               reference="fp32 weights/compute/optimizer, plain attention",
               reference_fp32_matmul=plain_fp32, reference_secs=ref_secs,
               rel_diff=rel(port, ref), limit=LR_WITNESS_LIMIT,
               port_rises_on_last_step=port[-1] > port[-2],
               reference_rises_on_last_step=ref[-1] > ref[-2])
    rec["ok"] = (len(port) == len(ref) == 3 and plain_fp32
                 and all(math.isfinite(x) for x in port + ref)
                 and rec["rel_diff"] <= LR_WITNESS_LIMIT)
    return rec


# ----------------------------------------------------------------------
# phase 9: card against CPU
# ----------------------------------------------------------------------
def phase_parity():
    import numpy as np
    import torch
    from realhf_tpu_torch.base import seeding
    from realhf_tpu_torch.engine import packing
    from realhf_tpu_torch.models import transformer as T
    from realhf_tpu_torch.models.config import TransformerConfig, llama_config
    from realhf_tpu_torch.ops import decode_attention as da
    from realhf_tpu_torch.ops import flash_attention as fa

    base = llama_config("7b", n_layers=2)
    cfg_gpu = TransformerConfig(**base, param_dtype="bfloat16",
                                compute_dtype="bfloat16")
    cfg_cpu = TransformerConfig(**base, param_dtype="float32",
                                compute_dtype="float32")
    params = T.init_params(cfg_gpu, seeding.generator(7, "cuda"), "cuda")
    params_cpu = _tree_map(lambda t: t.float().cpu(), params)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, 32000, size=n).astype(np.int32)
               for n in (100, 37)]
    ids, seg, pos = packing.left_padded_prompts(prompts, pad_id=0)
    n_steps = 8
    fwd0, dec0 = fa.launches, da.launches

    def run(cfg, p, device, tokens=None):
        with torch.inference_mode():
            t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
            hidden, cache = T.prefill(cfg, p, t(ids), t(seg), t(pos),
                                      total_len=ids.shape[1] + n_steps)
            h = hidden[:, -1]
            lens = t(seg).sum(-1).to(torch.int32)
            logits, chosen = [], []
            for step in range(n_steps):
                lg = T.lm_logits(cfg, p, h).float()
                logits.append(lg.cpu())
                tok = (lg.argmax(-1).to(torch.int32) if tokens is None
                       else t(tokens[step]))
                chosen.append(tok.cpu().numpy())
                h, cache = T.decode_step(cfg, p, cache, tok, lens + step,
                                         uniform_slot=True)
            return torch.stack(logits), chosen

    ref_logits, ref_tokens = run(cfg_cpu, params_cpu, "cpu")
    gpu_logits, gpu_tokens = run(cfg_gpu, params, "cuda", tokens=ref_tokens)
    launched = dict(flash_fwd=fa.launches - fwd0,
                    flash_decode=da.launches - dec0)
    # the LM head on bf16 hidden states against fp32 sums of the same
    # (exact) bf16 products: a result rounded to bf16 first is ~1e-3 off
    hb = torch.randn((4, base["hidden_dim"]), device="cuda",
                     generator=torch.Generator("cuda").manual_seed(5))
    hb = hb.bfloat16()
    head = T.lm_logits(cfg_gpu, params, hb)
    want = hb.float() @ T.head_weight(cfg_gpu, params).float()
    head_rel = float((head - want).abs().max() / want.abs().max())
    scale = float(ref_logits.abs().max())
    err = float((gpu_logits - ref_logits).abs().max())
    # the first greedy token must agree unless the reference's top two
    # logits are closer than the logits' error (not decidable then)
    first_ref = ref_logits[0]
    top2 = first_ref.topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1])
    first_gpu = gpu_logits[0].argmax(-1)
    same = first_gpu == first_ref.argmax(-1)
    first_ok = bool((same | (gap < 2 * err)).all())
    agree = float((gpu_logits.argmax(-1) == ref_logits.argmax(-1))
                  .float().mean())
    limit = 0.05
    ok = (err / scale <= limit and first_ok and head.dtype == torch.float32
          and head_rel <= 1e-4
          and bool(torch.isfinite(gpu_logits).all())
          and launched["flash_fwd"] == 2
          and launched["flash_decode"] == 2 * n_steps)
    del params
    torch.cuda.empty_cache()
    return dict(layers=2, prompts=[len(p) for p in prompts],
                decode_steps=n_steps, logits_max_abs_err=err,
                logits_max_abs=scale, rel_err=err / scale, rel_limit=limit,
                first_token_equal=[bool(x) for x in same],
                first_top2_gap=[float(x) for x in gap],
                greedy_agreement=agree, launches=launched,
                lm_head_fp32_rel_err=head_rel, lm_head_rel_limit=1e-4, ok=ok)


# ----------------------------------------------------------------------
# phase 10: one SFT step, card against CPU
# ----------------------------------------------------------------------
# about 3x the readings of a sound step (PERF.md, Findings)
TRAIN_PARITY_LIMITS = dict(loss_rel=1e-4, grad_norm_rel=3e-3, min_cos=0.9997,
                           later_loss_rel=0.022)
TRAIN_PARITY_STEPS = 3


def sft_microbatches(rng, vocab):
    """Two microbatches of two prompt-answer sequences (~510 tokens in
    all, unequal answer counts) and their answer-token weights."""
    import numpy as np
    from realhf_tpu_torch.interfaces import common
    sbs = []
    for lens, plens in (([150, 110], [40, 30]), ([90, 160], [60, 20])):
        ids = rng.integers(2, vocab, size=sum(lens)).astype(np.int32)
        pm = np.concatenate([np.arange(n) < p for n, p in zip(lens, plens)])
        sbs.append(common.build_stream_batch(
            lens, dict(input_ids=ids, prompt_mask=pm)))
    sbs = common.pad_stream_batches(sbs)
    weights = [float((~b.arrays["prompt_mask"] & (b.arrays["seg_ids"] != 0))
                     .sum()) for b in sbs]
    return [b.arrays for b in sbs], weights


def grad_agreement(names, got, ref, n_layers):
    """The cosine similarity of each layer slice of each leaf's
    gradient, card against CPU (0 where either side is all zero), summed
    in fp64: fp32 sums over the 32.8 M-element head read up to 1.0015."""
    cos = {}
    for name, a, b in zip(names, got, ref):
        a = grad_slices(name, a.double().cpu(), n_layers)
        b = grad_slices(name, b.double(), n_layers)
        den = (a.norm(dim=-1) * b.norm(dim=-1)).clamp_min(1e-30)
        cos[name] = ((a * b).sum(-1) / den).tolist()
    return cos


def phase_train_parity():
    """Three SFT optimizer steps at lr 1e-4 from the same weights and
    microbatches on the card (bf16, the kernels) and on the CPU (fp32,
    the plain versions): step 1's loss, grad norm, and the cosine
    similarity of every layer slice of every leaf's gradient, then the
    loss of steps 2-3. A copy of the card's gradients with layer 1's
    wq/wk/wv zeroed (the fault of a kernel output without a gradient)
    must fail the limits."""
    import numpy as np
    import torch
    from realhf_tpu_torch.base import seeding
    from realhf_tpu_torch.engine.engine import Engine
    from realhf_tpu_torch.engine.optim import OptimizerConfig
    from realhf_tpu_torch.interfaces import sft
    from realhf_tpu_torch.models import transformer as T
    from realhf_tpu_torch.models.config import TransformerConfig, llama_config
    from realhf_tpu_torch.models.convert import params_numpy
    nl = 2
    base = dict(llama_config("7b", n_layers=nl), hidden_dim=1024,
                n_q_heads=8, n_kv_heads=8, intermediate_dim=2816,
                gradient_checkpointing=True)
    cfgs = {dev: TransformerConfig(**base, param_dtype=dt, compute_dtype=dt)
            for dev, dt in (("cuda", "bfloat16"), ("cpu", "float32"))}
    # bf16 weights, the same numbers on both sides
    weights = params_numpy(T.init_params(cfgs["cuda"], seeding.generator(5),
                                         "cpu"))
    mbs, loss_w = sft_microbatches(np.random.default_rng(6),
                                   base["vocab_size"])
    opt = OptimizerConfig(lr=1e-4, lr_scheduler_type="constant",
                          warmup_steps_proportion=0.0)
    out, grads, traj = {}, {}, {}
    for dev, cfg in cfgs.items():
        eng = Engine(cfg, weights, dev, optimizer=opt)
        seen = capture_first_grads(eng.optimizer)
        steps = [eng.train_batch(mbs, sft._make_loss_fn(cfg), loss_w)
                 for _ in range(TRAIN_PARITY_STEPS)]
        out[dev], traj[dev] = steps[0], [st["loss"] for st in steps]
        grads[dev] = seen[0]
        names = leaf_names(eng.params)
        del eng, seen
    torch.cuda.empty_cache()
    cos = grad_agreement(names, grads["cuda"], grads["cpu"], nl)
    faulty = [g.clone() for g in grads["cuda"]]
    for name, g in zip(names, faulty):
        if name in ("blocks.attn.wq", "blocks.attn.wk", "blocks.attn.wv"):
            g[1] = 0
    cos_fault = grad_agreement(names, faulty, grads["cpu"], nl)
    lim = TRAIN_PARITY_LIMITS

    def rel(k):
        return abs(out["cuda"][k] - out["cpu"][k]) / abs(out["cpu"][k])

    min_cos = min(min(v) for v in cos.values())
    max_cos = max(max(v) for v in cos.values())
    fault_min_cos = min(min(v) for v in cos_fault.values())
    later = max(abs(a - b) / abs(b) for a, b in
                zip(traj["cuda"][1:], traj["cpu"][1:]))
    rec = dict(layers=nl, hidden=base["hidden_dim"], tokens=int(
        sum((m["seg_ids"] != 0).sum() for m in mbs)), loss=out,
        loss_rel_err=rel("loss"), grad_norm_rel_err=rel("grad_norm"),
        min_cos=min_cos, max_cos=max_cos, cos=cos, losses=traj,
        later_loss_rel_err=later, limits=lim,
        planted_fault="layer 1 wq/wk/wv gradients zeroed",
        planted_fault_min_cos=fault_min_cos)
    rec["ok"] = (rec["loss_rel_err"] <= lim["loss_rel"]
                 and rec["grad_norm_rel_err"] <= lim["grad_norm_rel"]
                 and lim["min_cos"] <= min_cos and max_cos <= 1 + 1e-6
                 and later <= lim["later_loss_rel"]
                 and all(math.isfinite(x) for x in traj["cuda"])
                 and fault_min_cos < lim["min_cos"])
    return rec


# ----------------------------------------------------------------------
# phases 11-13: the ppo experiment at 7B width, its profile, and card
# against CPU on the same rollout
# ----------------------------------------------------------------------
PPO_LAYERS = 4
PPO_MINIBATCHES = 4
PPO_ROLES = ("actor", "critic", "ref", "reward")
PPO_MFCS = ("actor_gen", "rew_inf", "ref_inf", "critic_inf", "actor_train",
            "critic_train")
# A step's first minibatch runs on the weights that generated, so the
# packed forward (K1, the replayed logits mask) must reproduce the decode
# path's log-probs (K4, per-token LM head): |importance_weight - 1| and
# |ppo_approx_kl|, each about 3x the largest sound reading (PERF.md,
# Findings)
PPO_FIRST_MINIBATCH_LIMITS = dict(importance_weight=3.5e-3,
                                  ppo_approx_kl=3.5e-3)


def build_ppo_spec(data_path, n_layers, benchmark_steps, auto_offload=False,
                   ctx=1, extra=None):
    from realhf_tpu_torch.base.testing import IntegerTokenizer
    from realhf_tpu_torch.experiments.common import apply_overrides
    from realhf_tpu_torch.experiments.ppo_exp import PPOConfig
    from realhf_tpu_torch.models.config import llama_config
    cfg = PPOConfig(experiment_name="chip-smoke", trial_name="ppo",
                    benchmark_steps=benchmark_steps)
    apply_overrides(cfg, {"dataset.path": data_path,
                          "dataset.train_bs_n_seqs": "16",
                          "dataset.max_seqlen": "512",
                          "ppo.max_new_tokens": "128",
                          "ppo.min_new_tokens": "32",
                          "ppo.ppo_n_minibatches": str(PPO_MINIBATCHES),
                          "actor.optimizer.lr": "1e-5",
                          "critic.optimizer.lr": "1e-5",
                          "ref.parallel.context_parallel_size": str(ctx),
                          "rew.parallel.context_parallel_size": str(ctx),
                          **(extra or {})})
    spec = cfg.build()
    spec.auto_offload = auto_offload
    for role in PPO_ROLES:
        spec.models[role].random_init_config = llama_config(
            "7b", n_layers=n_layers)
    vocab = spec.models["actor"].random_init_config["vocab_size"]
    spec.tokenizer = IntegerTokenizer(vocab_size=vocab - 2)
    return spec, vocab


def watch_ppo_runner(runner) -> dict:
    """Wrap, on this runner's own objects, what the script reads and the
    library does not keep: ``host.execute`` (host-clock seconds of each
    MFC, weight reload and offload hook included, up to a device
    synchronisation), each train engine's ``train_minibatches`` (every
    minibatch's own stats; the interface returns their mean) and the
    segment matrices the packer gave each engine call, which are the
    shapes the kernels ran at."""
    import numpy as np
    import torch
    host = runner.host
    seen = dict(mfc_secs={name: [] for name in host.nodes},
                minibatch_stats=dict(actor_train=[], critic_train=[]),
                segs=dict(prefill=[], inference=[], minibatch=[]))
    execute = host.execute

    def timed_execute(name, inp):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = execute(name, inp)
        torch.cuda.synchronize()
        seen["mfc_secs"][name].append(time.monotonic() - t0)
        return out

    host.execute = timed_execute

    def keep_seg(engine, method, kind):
        orig = getattr(engine, method)

        def call(ids, seg, *args, **kw):
            seen["segs"][kind].append(np.asarray(seg))
            return orig(ids, seg, *args, **kw)

        setattr(engine, method, call)

    keep_seg(runner.models["actor"].engine, "generate", "prefill")
    keep_seg(runner.models["reward"].engine, "forward_values", "inference")
    keep_seg(runner.models["ref"].engine, "forward_logprobs", "inference")
    keep_seg(runner.models["critic"].engine, "forward_values", "inference")
    for role in ("actor", "critic"):
        engine = runner.models[role].engine

        def train_minibatches(minibatches, *args, _role=role,
                              _orig=engine.train_minibatches, **kw):
            seen["segs"]["minibatch"] += [mb["seg_ids"] for mbs in minibatches
                                          for mb in mbs]
            out = _orig(minibatches, *args, **kw)
            seen["minibatch_stats"][f"{_role}_train"].append(out)
            return out

        engine.train_minibatches = train_minibatches
    return seen


def expected_ppo_launches(n_layers, n_minibatches, gen_stats):
    """Per generate call: K1 once per layer in prefill, K4 once per layer
    per decode step. Per step: K1 once per layer in each of rew_inf,
    ref_inf and critic_inf (one chunk each), and in each train MFC per
    minibatch (one microbatch) a forward and a checkpoint recompute;
    K2 and K3 once per layer per minibatch per train MFC."""
    steps = len(gen_stats)
    bwd = 2 * n_minibatches * n_layers * steps
    return dict(
        flash_fwd=(n_layers + 3 * n_layers) * steps + 2 * bwd,
        flash_bwd_dq=bwd, flash_bwd_dkv=bwd,
        flash_decode=n_layers * sum(st["decode_steps"] for st in gen_stats),
        flash_decode_stacked=0, ring_round=0, ring_push=0, **NO_RING_BWD)


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tree_leaves(tree))


def tree_checksum(tree) -> int:
    """Sum of every leaf's 16-bit words, on whichever device it lies."""
    import torch
    return sum(int(t.contiguous().view(torch.int16).sum(dtype=torch.int64))
               for t in _tree_leaves(tree))


def check_ppo_rollout(batch, vocab) -> dict:
    """Tokens in range, every generated token allowed by its own logits
    mask (stored True = masked out), log-probs finite and <= 0."""
    import numpy as np
    ids = batch.data["packed_input_ids"]
    gen_idx = np.flatnonzero(~batch.data["prompt_mask"])
    mask = batch.data["packed_logits_mask"]
    lp = batch.data["packed_logprobs"]
    return dict(
        tokens_in_range=bool(ids.dtype == np.int32 and ids.min() >= 0
                             and ids.max() < vocab),
        tokens_inside_mask=bool(
            not mask[gen_idx - 1, ids[gen_idx]].any()),
        masked_share=float(mask[gen_idx - 1].mean()),
        logprobs_ok=bool(np.isfinite(lp).all() and lp.max() <= 0),
        generated_tokens=int(len(gen_idx)))


def ppo_step_records(runner, mfc_secs, smi):
    recs = []
    eng = runner.models["actor"].engine
    for i, secs in enumerate(runner.step_secs):
        mfc = {name: v[i] for name, v in mfc_secs.items()}
        gen = eng.generate_stats[i]
        st = runner.step_stats[i]["actor_train"]
        tokens = int(st["avg_seq_len"] * st["n_seqs"] + 0.5)
        recs.append(dict(
            step=i + 1, step_secs=secs, mfc_secs=mfc,
            decode_steps=gen["decode_steps"],
            generated_tokens=gen["generated_tokens"],
            generated_tokens_per_s=gen["generated_tokens"] / mfc["actor_gen"],
            batch_tokens=tokens,
            actor_train_tokens_per_s=tokens / mfc["actor_train"],
            critic_train_tokens_per_s=tokens / mfc["critic_train"],
            batch_tokens_per_step_s=tokens / secs, card=smi))
    return recs


def phase_ppo(smi):
    """The ppo experiment through ``PPOConfig.build()`` and
    ``InlineRunner`` at 7B width and 4 layers for all four roles, bf16,
    gradient checkpointing on: 2 steps of 16 prompts (100-512 words), up
    to 128 sampled new tokens (top-p 0.9, top-k 200, logits mask kept),
    4 minibatches per train MFC. Then one step of a second runner with
    ``auto_offload``."""
    import torch
    from realhf_tpu_torch.system.inline import InlineRunner
    lim = PPO_FIRST_MINIBATCH_LIMITS
    # ``peak_mem_gb`` is the allocator's own peak over the two steps;
    # ``leftover_gb`` is what earlier phases still held when this one
    # began and ``resident_gb`` the four models' and optimizers' bytes
    gc.collect()
    torch.cuda.empty_cache()
    leftover = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "prompts.jsonl")
        # 10 batches in the file: the lr schedule spans 10 steps, so the
        # 8 optimizer steps of these 2 PPO steps stay inside it
        write_prompts(data, 160, seed=1)
        spec, vocab = build_ppo_spec(data, PPO_LAYERS, benchmark_steps=2)
        t0 = time.monotonic()
        runner = InlineRunner(without_saves(spec))  # device=None: the card
        torch.cuda.synchronize()
        setup = time.monotonic() - t0
        resident = torch.cuda.memory_allocated() - leftover
        seen = watch_ppo_runner(runner)
        per_mb = seen["minibatch_stats"]
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        runner.run()
        torch.cuda.synchronize()
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        actor = runner.models["actor"].engine
        want = expected_ppo_launches(PPO_LAYERS, PPO_MINIBATCHES,
                                     actor.generate_stats)
        firsts = [step[0] for step in per_mb["actor_train"]]
        stats_finite = all(
            math.isfinite(v) for step in runner.step_stats
            for st in step.values() for v in st.values()) and all(
            math.isfinite(v) for seen in per_mb.values() for step in seen
            for st in step for v in st.values())
        rec = dict(
            n_layers=PPO_LAYERS, setup_secs=setup, card=smi,
            leftover_gb=leftover / 2 ** 30,
            resident_gb=resident / 2 ** 30, peak_mem_gb=peak,
            steps=ppo_step_records(runner, seen["mfc_secs"], smi),
            mfc_runs={k: len(v) for k, v in seen["mfc_secs"].items()},
            stats=runner.step_stats,
            minibatch_stats=per_mb,
            first_minibatch=dict(
                importance_weight=[m["importance_weight"] for m in firsts],
                ppo_approx_kl=[m["ppo_approx_kl"] for m in firsts],
                limits=lim),
            rollout=check_ppo_rollout(runner.last_batch, vocab),
            versions={r: dict(model=runner.models[r].version.global_step,
                              engine=runner.models[r].engine.version)
                      for r in ("actor", "critic")},
            launches=counts, launches_expected=want)
        rec["first_minibatch_ok"] = len(firsts) == 2 and all(
            abs(m["importance_weight"] - 1) <= lim["importance_weight"]
            and abs(m["ppo_approx_kl"]) <= lim["ppo_approx_kl"]
            for m in firsts)
        rec["ok"] = bool(
            rec["mfc_runs"] == dict.fromkeys(PPO_MFCS, 2)
            and len(runner.step_stats) == 2 and stats_finite
            and all(rec["rollout"][k] for k in (
                "tokens_in_range", "tokens_inside_mask", "logprobs_ok"))
            and rec["first_minibatch_ok"] and counts == want
            and all(v == dict(model=2, engine=2 * PPO_MINIBATCHES)
                    for v in rec["versions"].values()))
        rec["launches_ok"] = counts == want
        segs = seen["segs"]
        # the wrappers tie each engine into a reference cycle
        del runner, actor, per_mb, seen
        gc.collect()
        torch.cuda.empty_cache()

        # one step with ref and reward offloaded after their MFCs
        spec, _ = build_ppo_spec(data, PPO_LAYERS, benchmark_steps=1,
                                 auto_offload=True)
        runner = InlineRunner(without_saves(spec))
        off_seen = watch_ppo_runner(runner)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        idle = {r: runner.models[r].engine for r in ("ref", "reward")}
        sums = {r: tree_checksum(e.params) for r, e in idle.items()}
        nbytes = sum(tree_bytes(e.params) for e in idle.values())
        reset_counts()
        runner.run()
        torch.cuda.synchronize()
        off_counts = read_counts()
        after = torch.cuda.memory_allocated()
        offloaded = {r: e.offloaded for r, e in idle.items()}
        host_sums_ok = all(tree_checksum(e.params) == sums[r]
                           for r, e in idle.items())
        for e in idle.values():
            e.ensure_on_device()
        back = torch.cuda.memory_allocated()
        off_want = expected_ppo_launches(
            PPO_LAYERS, PPO_MINIBATCHES,
            runner.models["actor"].engine.generate_stats)
        off = dict(
            offloaded=offloaded, offloaded_bytes=nbytes,
            allocated_before=before, allocated_after_step=after,
            allocated_after_reload=back, freed=before - after,
            step_secs=runner.step_secs[0],
            mfc_secs={k: v[0] for k, v in off_seen["mfc_secs"].items()},
            bits_kept_on_host=host_sums_ok,
            bits_kept_after_reload=all(
                tree_checksum(e.params) == sums[r]
                and all(t.is_cuda for t in _tree_leaves(e.params))
                for r, e in idle.items()),
            launches=off_counts, launches_expected=off_want)
        # the freed bytes are the two models' weights (the allocator
        # rounds each tensor up, so allow 1%)
        off["ok"] = bool(
            all(offloaded.values()) and host_sums_ok
            and off["bits_kept_after_reload"] and off_counts == off_want
            and abs((before - after) - nbytes) <= 0.01 * nbytes
            and abs(back - before) <= 0.01 * nbytes
            # the first runner is gone: only this one's models are held
            and abs(before - leftover - resident) <= 0.01 * resident
            and not runner.models["actor"].engine.offloaded)
        rec["auto_offload"] = off
        rec["ok"] = rec["ok"] and off["ok"]
        # hand the runner on as it was built
        del runner.host.execute
        for role in PPO_ROLES:
            for method in ("generate", "forward_values", "forward_logprobs",
                           "train_minibatches"):
                vars(runner.models[role].engine).pop(method, None)
    return runner, segs, rec


def phase_kernels_ppo(segs, max_new_tokens=128):
    """K1-K4 against their plain versions at the shapes the ppo path ran
    them at, from the segment matrices its packer made (``segs``, kept
    by ``watch_ppo_runner``): K1 on the prefill of 16 left-padded
    prompts, on the one ~6 k-token stream of 16 sequences that rew_inf,
    ref_inf and critic_inf each forward, and on the longest minibatch
    stream of the train MFCs (4 sequences); K2/K3 on that minibatch
    stream, with the planted fault; K4 at 16 streams over the cache of
    prompt length + ``max_new_tokens`` slots, half the new tokens
    written. Same limits as phase 3; all timed."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)

    def on_card(seg):
        return torch.as_tensor(seg, dtype=torch.int32, device="cuda")

    def longest(kind):
        return on_card(max(segs[kind], key=lambda a: a.size))

    prefill, stream, mb = (on_card(segs["prefill"][0]), longest("inference"),
                           longest("minibatch"))
    fwd = [check_flash_fwd(name, seg.shape[0], seg.shape[1], 32, 32, 128,
                           seg, True, gen, timed=True)
           for name, seg in (("ppo_prefill", prefill),
                             ("ppo_inference_stream", stream),
                             ("ppo_minibatch", mb))]
    for rec, seg in zip(fwd, (prefill, stream, mb)):
        rec["segments"] = int(seg.max()) if seg.shape[0] == 1 else 1
    b, lp = prefill.shape
    spans = [(lp - int(n), lp + max_new_tokens // 2)
             for n in (prefill != 0).sum(-1)]
    fwd.append(check_flash_decode("ppo_decode", b, lp + max_new_tokens, 32,
                                  32, 128, spans, gen, timed=True))
    bwd = [check_flash_bwd("ppo_minibatch", mb.shape[0], mb.shape[1], 32, 32,
                           128, mb, True, gen, timed=True, plant_fault=True)]
    bwd[0]["segments"] = int(mb.max())
    del gen
    torch.cuda.empty_cache()
    return fwd, bwd


PPO_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_decode")


def phase_ppo_profile(runner, smi):
    """One more ppo step (on the ``auto_offload`` runner), each MFC under
    its own torch.profiler trace: device time by kernel class (K1-K4,
    GEMMs, the rest), the device-busy share, and the optimizer steps'
    device time (CUDA events around each, inside the rest)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    host = runner.host
    orig_execute = host.execute
    per_mfc = {}
    cuda = torch.autograd.DeviceType.CUDA

    def execute(name, inp):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            out = orig_execute(name, inp)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        by_cat = {}
        for e in prof.key_averages():
            if e.device_type == cuda:
                cat = kernel_category(e.key, PPO_KERNELS)
                by_cat[cat] = by_cat.get(cat, 0.0) + e.self_device_time_total
        per_mfc[name] = dict(wall_ms=wall * 1e3, us_by_class=by_cat)
        return out

    events = {}
    for role in ("actor", "critic"):
        opt = runner.models[role].engine.optimizer
        events[role] = []

        def timed(params, grads, opt=opt, evs=events[role]):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            type(opt).step(opt, params, grads)
            ev[1].record()
            evs.append(ev)

        opt.step = timed
    host.execute = execute
    try:
        runner.run_step(next(iter(runner.dataloader)))
        torch.cuda.synchronize()
    finally:
        del host.execute
        for role in events:
            del runner.models[role].engine.optimizer.step
    mfc_wall = sum(m["wall_ms"] for m in per_mfc.values())
    rec = dict(card=smi, mfc_wall_ms=mfc_wall, optimizer_step_ms={
        role: sum(a.elapsed_time(b) for a, b in evs)
        for role, evs in events.items()})
    if not any(m["us_by_class"] for m in per_mfc.values()):
        rec["device_time"] = "not measured (no device events in the trace)"
        return rec
    total = {}
    for name, m in per_mfc.items():
        us = m.pop("us_by_class")
        kernel_us = sum(us.values())
        m.update(kernel_ms=kernel_us / 1e3,
                 busy_share=kernel_us / 1e3 / m["wall_ms"],
                 ms_by_class={k: v / 1e3 for k, v in us.items()})
        for k, v in us.items():
            total[k] = total.get(k, 0.0) + v
    all_us = sum(total.values())
    rec.update(by_mfc=per_mfc, kernel_ms=all_us / 1e3,
               busy_share=all_us / 1e3 / mfc_wall,
               ms_by_class={k: v / 1e3 for k, v in total.items()},
               share_by_class={k: v / all_us for k, v in total.items()},
               optimizer_share=sum(rec["optimizer_step_ms"].values()) * 1e3
               / all_us)
    return rec


# one greedy rollout through the inference MFCs: card (bf16, the
# kernels) against the CPU (fp32, the plain versions); then the train
# MFCs' first minibatch: card bf16 with the kernels against a plain fp32
# reference of the same step on the card. The inference limits are each
# about 3x the sound reading (PERF.md, Findings). The four train limits
# (loss, grad norms) are about 3x the largest of ten readings (seeds
# 12-16, two builds of K1), each within 1.5x of what the card's bf16
# step with the plain attention read: bf16 rounding, not the kernels
# (PERF.md, Findings).
PPO_PARITY_LIMITS = dict(
    rewards_rel=0.025, values_rel=0.03, ref_logprobs_abs=0.05,
    ref_logprobs_mean_abs=0.012, actor_loss_abs=1.6e-3,
    actor_grad_norm_rel=5e-3, importance_weight_abs=3.5e-3,
    approx_kl_abs=3.5e-3, value_loss_rel=6e-3, critic_grad_norm_rel=8e-3)
PPO_PARITY_SEED = 12


def phase_ppo_parity(seed=PPO_PARITY_SEED):
    """At ``train_parity``'s reduced size (2 layers, hidden 1024, 8 heads
    of 128, FFN 2816, vocab 32000): one greedy rollout on the card, then
    the same ``SequenceSample`` through rew_inf, ref_inf, critic_inf on
    the card (bf16, kernels) and on the CPU (fp32, plain versions) from
    the same weights: rewards, values and reference log-probs within
    limits. Then, with the card's inference outputs merged in,
    actor_train and critic_train (2 minibatches, the optimizer state
    offloaded to the host between train calls on the card) from the same
    weights four ways: on the card in bf16 with the kernels (the port),
    on the card in bf16 with the plain attention patched in (what bf16
    rounding alone gives), on the card in fp32 with the plain attention
    (the reference) and on the CPU in fp32. The port's first-minibatch
    loss and grad norm must sit within limits of the reference; the
    other two are reported beside it. Planted faults: the generation
    log-probs shifted by one token must read an approximate KL over 10x
    its limit (its importance weight, a mean of ratios on either side of
    1, moves little and decides nothing), and the old values shifted by
    one token must read a value loss over 10x its limit from the
    reference's."""
    import numpy as np
    import torch
    from realhf_tpu_torch.api.config import ModelName
    from realhf_tpu_torch.api.data import SequenceSample
    from realhf_tpu_torch.api.model import Model
    from realhf_tpu_torch.base import seeding
    from realhf_tpu_torch.base.testing import IntegerTokenizer
    from realhf_tpu_torch.engine.engine import Engine
    from realhf_tpu_torch.engine.optim import OptimizerConfig
    from realhf_tpu_torch.interfaces.ppo import (
        PPOActorInterface,
        PPOCriticInterface,
    )
    from realhf_tpu_torch.interfaces.rw import PairedRewardInterface
    from realhf_tpu_torch.models import transformer as T
    from realhf_tpu_torch.models.config import TransformerConfig, llama_config
    from realhf_tpu_torch.models.convert import params_numpy
    from realhf_tpu_torch.ops.attention import packed_attention_plain
    nl = 2
    base = dict(llama_config("7b", n_layers=nl), hidden_dim=1024,
                n_q_heads=8, n_kv_heads=8, intermediate_dim=2816,
                gradient_checkpointing=True)
    tok = IntegerTokenizer(vocab_size=base["vocab_size"] - 2)
    opt = OptimizerConfig(lr=1e-5, lr_scheduler_type="constant",
                          warmup_steps_proportion=0.0, offload=True)
    critics = dict(actor=False, ref=False, critic=True, reward=True)
    # bf16 weights, the same numbers on both sides
    weights = {
        role: params_numpy(T.init_params(
            TransformerConfig(**base, is_critic=c, param_dtype="bfloat16",
                              compute_dtype="bfloat16"),
            seeding.generator(20 + i), "cpu"))
        for i, (role, c) in enumerate(critics.items())}

    def model(role, dev, dt):
        return Model(ModelName(role, 0), Engine(
            TransformerConfig(**base, is_critic=critics[role],
                              param_dtype=dt, compute_dtype=dt),
            weights[role], dev,
            optimizer=opt if role in ("actor", "critic") else None), tok)

    def models(dev, dt):
        return {role: model(role, dev, dt) for role in critics}

    gconfig = dict(max_new_tokens=32, min_new_tokens=8, greedy=True)
    actor_kw = dict(n_minibatches=2, gconfig=gconfig, value_norm=True,
                    early_stop_imp_ratio=5.0)
    critic_kw = dict(n_minibatches=2, value_norm=True)
    rng = np.random.default_rng(seed)
    plens = [int(x) for x in rng.integers(30, 121, size=8)]
    prompts = SequenceSample.from_default(
        plens, list(range(8)), dict(packed_prompts=rng.integers(
            2, base["vocab_size"], size=sum(plens)).astype(np.int32)))

    card = models("cuda", "bfloat16")
    reset = read_counts()
    batch = PPOActorInterface(**actor_kw).generate(card["actor"], prompts)

    def inference(ms):
        out = {}
        for role, itf, key in (
                ("reward", PairedRewardInterface(), "rewards"),
                ("ref", PPOActorInterface(**actor_kw), "packed_ref_logprobs"),
                ("critic", PPOCriticInterface(**critic_kw), "values")):
            keys = ["packed_input_ids"] + (
                ["packed_logits_mask"] if role == "ref" else [])
            out[key] = itf.inference(ms[role], batch.select(keys))
        return out

    def train(model, itf, sample):
        """The first minibatch's own stats of one train MFC."""
        per_mb = []
        orig = model.engine.train_minibatches

        def train_minibatches(*args, **kw):
            per_mb.extend(orig(*args, **kw))
            return per_mb

        model.engine.train_minibatches = train_minibatches
        try:
            itf.train_step(model, sample, n_mbs=1)
        finally:
            del model.engine.train_minibatches
        return per_mb[0]

    def train_both(ms):
        return dict(
            actor=train(ms["actor"], PPOActorInterface(**actor_kw), batch),
            critic=train(ms["critic"], PPOCriticInterface(**critic_kw),
                         batch))

    def shifted(key):
        """A copy of the batch with ``key`` moved one token later."""
        out = batch.select(list(batch.keys))  # its own data dict
        x = batch.data[key].copy()
        x[1:] = x[:-1]
        out.data[key] = x
        return out

    def plain_attention(run):
        attn, T.packed_attention = T.packed_attention, packed_attention_plain
        try:
            return run()
        finally:
            T.packed_attention = attn

    inf_card = inference(card)
    for smp in inf_card.values():
        batch.update_(smp)
    # the actor's planted fault first, with an early stop that skips its
    # updates
    fault = train(card["actor"], PPOActorInterface(**dict(
        actor_kw, early_stop_imp_ratio=0.0)), shifted("packed_logprobs"))
    fault_skipped = (fault["early_stop_skipped"] == 1.0
                     and card["actor"].engine.optimizer.count == 0)
    got = train_both(card)
    opt_offloaded = all(card[r].engine.optimizer.offloaded
                        for r in ("actor", "critic"))
    launched = {k: v - reset[k] for k, v in read_counts().items()}
    del card
    # the critic's planted fault on a critic of its own, from the same
    # weights
    critic = model("critic", "cuda", "bfloat16")
    critic_fault = train(critic, PPOCriticInterface(**critic_kw),
                         shifted("values"))
    del critic
    torch.cuda.empty_cache()

    def train_on_card(dt):
        ms = {r: model(r, "cuda", dt) for r in ("actor", "critic")}
        out = plain_attention(lambda: train_both(ms))
        del ms
        torch.cuda.empty_cache()
        return out

    plain_bf16 = train_on_card("bfloat16")
    ref_fp32 = (torch.get_float32_matmul_precision() == "highest"
                and not torch.backends.cuda.matmul.allow_tf32)
    ref = train_on_card("float32")

    cpu = models("cpu", "float32")
    inf_cpu = inference(cpu)
    cpu_train = train_both(cpu)
    del cpu
    lim = PPO_PARITY_LIMITS

    def rel_max(key):
        a, b = inf_card[key].data[key], inf_cpu[key].data[key]
        return float(np.abs(a - b).max() / np.abs(b).max())

    def train_errs(x):
        """One run's first-minibatch stats against the reference's."""
        def rel(role, k):
            return abs(x[role][k] - ref[role][k]) / abs(ref[role][k])
        return dict(
            actor_loss_abs=abs(x["actor"]["actor_loss"]
                               - ref["actor"]["actor_loss"]),
            actor_grad_norm_rel=rel("actor", "grad_norm"),
            value_loss_rel=rel("critic", "value_loss"),
            critic_grad_norm_rel=rel("critic", "grad_norm"))

    d_ref = np.abs(inf_card["packed_ref_logprobs"].data["packed_ref_logprobs"]
                   - inf_cpu["packed_ref_logprobs"]
                   .data["packed_ref_logprobs"])
    errs = dict(
        rewards_rel=rel_max("rewards"), values_rel=rel_max("values"),
        ref_logprobs_abs=float(d_ref.max()),
        ref_logprobs_mean_abs=float(d_ref.mean()),
        **train_errs(got),
        importance_weight_abs=max(
            abs(got["actor"]["importance_weight"] - 1),
            abs(ref["actor"]["importance_weight"] - 1)),
        approx_kl_abs=max(abs(got["actor"]["ppo_approx_kl"]),
                          abs(ref["actor"]["ppo_approx_kl"])))
    fault_errs = dict(
        importance_weight_abs=abs(fault["importance_weight"] - 1),
        approx_kl_abs=abs(fault["ppo_approx_kl"]),
        value_loss_rel=abs(critic_fault["value_loss"]
                           - ref["critic"]["value_loss"])
        / abs(ref["critic"]["value_loss"]))
    seqlens = [l[0] for l in batch.seqlens["packed_input_ids"]]
    rec = dict(layers=nl, hidden=base["hidden_dim"], seed=seed,
               prompts=plens, seqlens=seqlens, card=got, reference=ref,
               reference_is="card, fp32 weights/compute/optimizer, plain "
               "attention", reference_fp32_matmul=ref_fp32,
               errors=errs, limits=lim,
               plain_bf16_errors=train_errs(plain_bf16),
               cpu_fp32_errors=train_errs(cpu_train),
               planted_faults=["generation log-probs shifted by one token",
                               "old values shifted by one token"],
               planted_fault_errors=fault_errs,
               planted_fault_update_skipped=fault_skipped,
               optimizer_state_offloaded=opt_offloaded, launches=launched)
    rec["ok"] = bool(
        all(math.isfinite(v) and v <= lim[k] for k, v in errs.items())
        and fault_errs["approx_kl_abs"] > 10 * lim["approx_kl_abs"]
        and fault_errs["value_loss_rel"] > 10 * lim["value_loss_rel"]
        and fault_skipped and opt_offloaded and ref_fp32
        and all(launched[k] > 0 for k in PPO_KERNELS))
    return rec


# ----------------------------------------------------------------------
# ctx and ppo_ctx: context-parallel inference through the entry points
# ----------------------------------------------------------------------
# c4 against c1 on the same bf16 weights (K6 against K1 over every layer):
# log-probs of the stream's valid positions, and ppo_ctx's reference
# log-probs and rewards, each about 3x the sound reading; and c4's mean
# distance from a plain fp32 reference at most ``fp32_mean_ratio`` times
# c1's (PERF.md, Findings)
CTX_LIMITS = dict(logprobs_abs=0.6, logprobs_mean_abs=0.033,
                  fp32_mean_ratio=1.5, ref_logprobs_abs=0.22,
                  ref_logprobs_mean_abs=0.024, rewards_rel=0.035)
# timed forward calls per engine in phase ctx, after the counted one
CTX_TIMED_CALLS = 3
# depth cut (the script's time): ctx at 8 of LLaMA-7B's 32 layers since
# the replicated-KV and MoE-over-members phases came; its limits were
# read at 32 layers, where the drift they bound is larger
CTX_LAYERS = 8


def reset_peaks(devs):
    import torch
    for d in dict.fromkeys(devs):
        torch.cuda.reset_peak_memory_stats(d)


def read_peaks(devs) -> dict:
    """``max_memory_allocated`` of every distinct member device, GiB."""
    import torch
    return {str(d): torch.cuda.max_memory_allocated(d) / 2 ** 30
            for d in dict.fromkeys(devs)}


def ctx_launches(n_layers, n_members):
    """K6 per context-parallel forward: one round launch per layer per
    round per member, one push per layer per round but the last per
    member; K1 none."""
    return dict(ring_round=n_layers * n_members * n_members,
                ring_push=n_layers * (n_members - 1) * n_members,
                flash_fwd=0)


def phase_ctx(smi):
    """``Engine.forward_logprobs`` of LLaMA-7B at ``CTX_LAYERS`` layers
    (random bf16 weights) over one packed stream of 32768 tokens (documents of 12288,
    7168, 6144, 4096 and 2816 tokens, then 256 of padding) on a c4
    layout over ``member_devices(4)``, then on c1 with the same weight
    tensors, where K1 runs over the whole stream. Each engine's first
    call is counted and checked; the seconds are the median of the
    ``CTX_TIMED_CALLS`` calls after it (host clock, every card
    synchronised), the peak memory that of every member device. Two bf16
    paths that round in other places drift apart over the layers; a plain fp32
    reference on the card (the same weights widened, ``forward_ctx`` at c4
    with ``ring_attention_plain``) tells rounding from a fault: c4 must be no
    further from it than c1, within ``fp32_mean_ratio``."""
    import dataclasses
    import functools

    import numpy as np
    import torch
    from realhf_tpu_torch.engine.engine import Engine
    from realhf_tpu_torch.models import transformer as T
    from realhf_tpu_torch.models.config import TransformerConfig, llama_config
    from realhf_tpu_torch.models.sharding import MemberParams
    from realhf_tpu_torch.ops import functional as F
    from realhf_tpu_torch.ops.ring_attention import ring_attention_plain
    from realhf_tpu_torch.parallel.mesh import ParallelismConfig
    gc.collect()
    torch.cuda.empty_cache()
    cfg = TransformerConfig(**llama_config("7b", n_layers=CTX_LAYERS),
                            param_dtype="bfloat16", compute_dtype="bfloat16")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    params = T.init_params(cfg, gen, "cuda")
    devs = member_devices(CTX_MEMBERS)
    engines = dict(
        c4=Engine(cfg, params, "cuda:0", parallel=ParallelismConfig(
            context_parallel_size=CTX_MEMBERS), devices=devs),
        c1=Engine(cfg, params, "cuda:0"))
    seg = doc_stream_seg(CTX_DOCS, CTX_PAD, "cpu").numpy()
    ids = np.random.default_rng(5).integers(
        2, cfg.vocab_size, size=seg.shape).astype(np.int32)
    # positions whose next token continues the document
    valid = np.zeros(seg.shape, bool)
    valid[:, :-1] = (seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] != 0)
    runs, lps = {}, {}
    for tag, eng in engines.items():
        gc.collect()
        torch.cuda.empty_cache()
        reset_peaks(devs)
        # the first call is the path whose launches are counted and whose
        # output is checked; it also warms the engine up; then
        # CTX_TIMED_CALLS timed calls, their median and spread reported
        reset_counts()
        sync_all()
        lp = eng.forward_logprobs(ids, seg)
        sync_all()
        counts = read_counts()
        lps[tag] = lp.float().cpu().numpy()
        secs = []
        for _ in range(CTX_TIMED_CALLS):
            t0 = time.monotonic()
            eng.forward_logprobs(ids, seg)
            sync_all()
            secs.append(time.monotonic() - t0)
        med = float(np.median(secs))
        peaks = read_peaks(devs)
        runs[tag] = dict(secs=med, secs_all=secs,
                         secs_spread=(max(secs) - min(secs)) / med,
                         tokens_per_s=seg.size / med,
                         peak_mem_gb=max(peaks.values()),
                         peak_mem_gb_by_device=peaks,
                         launches=counts, shape=list(lp.shape))
    # the plain fp32 reference over the c4 members
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    plain_fp32 = (torch.get_float32_matmul_precision() == "highest"
                  and not torch.backends.cuda.matmul.allow_tf32)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    p32 = {d: _tree_map(lambda t, d=d: t.to(d, torch.float32), params)
           for d in dict.fromkeys(devs)}
    members = MemberParams([p32[d] for d in devs], list(devs), 1, 1,
                           c=CTX_MEMBERS)
    ids_t = torch.as_tensor(ids, device="cuda")
    seg_t = torch.as_tensor(seg, device="cuda")
    t0 = time.monotonic()
    with torch.no_grad():
        hs, _ = T.forward_ctx(
            cfg32, members, ids_t, seg_t,
            attention_fn=functools.partial(ring_attention_plain,
                                           block_q=1024, block_k=1024))
        lps["fp32"] = F.shifted_logprobs_from_hidden(
            cfg32, members, hs, ids_t, seg_t).cpu().numpy()
    sync_all()
    ref_secs = time.monotonic() - t0
    del p32, members, hs
    gc.collect()
    torch.cuda.empty_cache()
    d = np.abs(lps["c4"] - lps["c1"])[valid]
    to_fp32 = {tag: np.abs(lps[tag] - lps["fp32"])[valid]
               for tag in ("c4", "c1")}
    want = ctx_launches(cfg.n_layers, CTX_MEMBERS)
    lim = CTX_LIMITS
    rec = dict(n_layers=cfg.n_layers, tokens=int(seg.size), docs=CTX_DOCS,
               pad=CTX_PAD, member_devices=[str(x) for x in devs], card=smi,
               runs=runs, logprobs_abs=float(d.max()),
               logprobs_mean_abs=float(d.mean()),
               logprob_mean=float(lps["c1"][valid].mean()),
               fp32_reference=dict(
                   secs=ref_secs, plain_fp32_matmul=plain_fp32,
                   **{f"{tag}_abs": float(x.max())
                      for tag, x in to_fp32.items()},
                   **{f"{tag}_mean_abs": float(x.mean())
                      for tag, x in to_fp32.items()}),
               limits={k: lim[k] for k in ("logprobs_abs",
                                            "logprobs_mean_abs",
                                            "fp32_mean_ratio")},
               launches_expected=dict(c4=want, c1=dict(
                   flash_fwd=cfg.n_layers, ring_round=0, ring_push=0)))
    # the c4 run's counts, for the kernels line
    rec["launches"] = runs["c4"]["launches"]
    c4, c1 = runs["c4"]["launches"], runs["c1"]["launches"]
    rec["launches_ok"] = (all(c4[k] == v for k, v in want.items())
                          and c1["flash_fwd"] == cfg.n_layers
                          and c1["ring_round"] == c1["ring_push"] == 0)
    rec["outputs_ok"] = bool(
        all(r["shape"] == list(seg.shape) for r in runs.values())
        and all(np.isfinite(x).all() and (x[~valid] == 0).all()
                and (x[valid] <= 0).all() for x in lps.values()))
    ref = rec["fp32_reference"]
    rec["ok"] = bool(rec["launches_ok"] and rec["outputs_ok"] and plain_fp32
                     and rec["logprobs_abs"] <= lim["logprobs_abs"]
                     and rec["logprobs_mean_abs"] <= lim["logprobs_mean_abs"]
                     and ref["c4_mean_abs"]
                     <= lim["fp32_mean_ratio"] * ref["c1_mean_abs"])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_ppo_ctx(smi):
    """The ppo-7bw-l4 cell's configuration and traffic with ref and
    reward at ``context_parallel_size=4`` on ``member_devices(4)``: one
    step through ``PPOConfig.build()`` and ``InlineRunner``. ref_inf and
    rew_inf must launch K6 exactly (layers x 4 rounds x 4 members) and K1
    never; then the step's rollout batch goes through ref_inf and rew_inf
    of a c1 host built from the same seed, whose reference log-probs and
    rewards must agree."""
    import numpy as np
    import torch
    from realhf_tpu_torch.models import transformer as T
    from realhf_tpu_torch.system.inline import InlineRunner
    from realhf_tpu_torch.system.model_host import ModelHost
    gc.collect()
    torch.cuda.empty_cache()
    devs = member_devices(CTX_MEMBERS)
    # the first ring call of ref_inf (its layer 0), kept for K6's case at
    # this path's own shapes
    mfc, first_ring = [None], {}
    ring = T.ring_attention_fused

    def watched_ring(qs, ks, vs, segs, **kw):
        if mfc[0] == "ref_inf" and not first_ring:
            first_ring.update(shards=[[t.detach().clone() for t in g]
                                      for g in (qs, ks, vs, segs)], kw=kw)
        return ring(qs, ks, vs, segs, **kw)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "prompts.jsonl")
        write_prompts(data, 160, seed=1)
        spec, _ = build_ppo_spec(data, PPO_LAYERS, benchmark_steps=1,
                                 ctx=CTX_MEMBERS)
        runner = InlineRunner(without_saves(spec),
                              role_devices=dict(ref=devs, reward=devs))
        seen = watch_ppo_runner(runner)
        host = runner.host
        timed_execute = host.execute
        per_mfc = {}

        def counted(name, inp):
            before = read_counts()
            mfc[0] = name
            out = timed_execute(name, inp)
            mfc[0] = None
            per_mfc[name] = {k: v - before[k]
                             for k, v in read_counts().items()}
            return out

        host.execute = counted
        T.ring_attention_fused = watched_ring
        try:
            reset_peaks(devs)
            reset_counts()
            runner.run()
            sync_all()
            counts = read_counts()
        finally:
            T.ring_attention_fused = ring
        peaks = read_peaks(devs)
        batch = runner.last_batch
        gen_stats = runner.models["actor"].engine.generate_stats
        want_ring = ctx_launches(PPO_LAYERS, CTX_MEMBERS)
        want = expected_ppo_launches(PPO_LAYERS, PPO_MINIBATCHES, gen_stats)
        want["flash_fwd"] -= 2 * PPO_LAYERS   # ref_inf and rew_inf: K6
        want["ring_round"] = 2 * want_ring["ring_round"]
        want["ring_push"] = 2 * want_ring["ring_push"]
        mfc_ok = all(per_mfc[m][k] == v for m in ("ref_inf", "rew_inf")
                     for k, v in want_ring.items())
        step = ppo_step_records(runner, seen["mfc_secs"], smi)[0]
        inf_tokens = batch.total_len("packed_input_ids")
        del host.execute
        for role in PPO_ROLES:
            for method in ("generate", "forward_values", "forward_logprobs",
                           "train_minibatches"):
                vars(runner.models[role].engine).pop(method, None)
        del seen, timed_execute, host
        runner_ref = {k: batch.data[k].copy()
                      for k in ("packed_ref_logprobs", "rewards")}
        # the same batch through a c1 host built from the same seed
        spec1, _ = build_ppo_spec(data, PPO_LAYERS, benchmark_steps=1)
        host1 = ModelHost(spec1, ["ref", "reward"],
                          [n for n in runner.dfg.nodes
                           if n.name in ("ref_inf", "rew_inf")],
                          spec1.tokenizer)
        reset_counts()
        c1 = {}
        for name, key in (("ref_inf", "packed_ref_logprobs"),
                          ("rew_inf", "rewards")):
            node = host1.nodes[name]
            inp = batch.select([k for k in node.input_keys
                                if k in batch.keys])
            c1[key] = host1.execute(name, inp).data[key]
        c1_counts = read_counts()
        del host1, runner
        gc.collect()
        torch.cuda.empty_cache()
    d = np.abs(runner_ref["packed_ref_logprobs"] - c1["packed_ref_logprobs"])
    rewards_rel = float(np.abs(runner_ref["rewards"] - c1["rewards"]).max()
                        / np.abs(c1["rewards"]).max())
    lim = CTX_LIMITS
    rec = dict(n_layers=PPO_LAYERS, member_devices=[str(x) for x in devs],
               card=smi, step=step, peak_mem_gb=max(peaks.values()),
               peak_mem_gb_by_device=peaks, ref_rew_tokens=int(inf_tokens),
               ref_rew_tokens_per_s={
                   m: inf_tokens / step["mfc_secs"][m]
                   for m in ("ref_inf", "rew_inf")},
               launches=counts, launches_expected=want,
               launches_by_mfc=per_mfc, c1_launches=c1_counts,
               ref_logprobs_abs=float(d.max()),
               ref_logprobs_mean_abs=float(d.mean()),
               rewards_rel=rewards_rel,
               limits={k: lim[k] for k in ("ref_logprobs_abs",
                                            "ref_logprobs_mean_abs",
                                            "rewards_rel")})
    rec["launches_ok"] = bool(counts == want and mfc_ok
                              and c1_counts["flash_fwd"] == 2 * PPO_LAYERS
                              and c1_counts["ring_round"] == 0)
    rec["ok"] = bool(
        rec["launches_ok"] and len(runner_ref["rewards"]) == len(c1["rewards"])
        and np.isfinite(runner_ref["rewards"]).all()
        and all(rec[k] <= v for k, v in rec["limits"].items()))
    return rec, first_ring


def check_ring_ppo_ctx(first_ring):
    """K6 against its plain version on the q/k/v/seg shards of ref_inf's
    first ring call in phase ppo_ctx (the path's own stream: ragged KV
    halves at hd 128), timed like the ctx-7b-c4 case."""
    kw = first_ring["kw"]
    return compare_ring("ppo_ctx_ref_inf", *first_ring["shards"],
                        causal=kw["causal"], window=kw["sliding_window"],
                        scale=kw["scale"], timed=True)


def _tree_leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tree_leaves(v)
        else:
            yield v


def _tree_map(fn, tree):
    return {k: (_tree_map(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


# ----------------------------------------------------------------------
# phases 16-21: the other algorithms (rw, dpo, grpo, reinforce, agentic,
# profile) at LLaMA-7B width, 4 layers a role, bf16, gradient
# checkpointing on
# ----------------------------------------------------------------------
ALGO_LAYERS = 4
ALGO_MINIBATCHES = 4
# each about 3x the largest sound reading of five seeds on the card
# (``scripts/torch_algo_limits.py``; PERF.md, Findings): rw card-vs-CPU
# loss 4.3e-3 and grad norm 2.8e-3 relative (the swapped-pairs fault
# 0.047-0.84); dpo step 1 |loss - ln 2| 5.7e-6, |kl| 1.5e-4, |score|
# 1.2e-5 (the swapped-ref fault 60-106); grpo step 1 |grpo_kl| 1.6e-4
RW_PARITY_LIMITS = dict(loss_rel=1.3e-2, grad_norm_rel=8.5e-3)
DPO_STEP1_LIMITS = dict(loss_ln2=2e-5, kl=5e-4, score=4e-5)
GRPO_KL_LIMIT = 5e-4


def algo_launches(fwd=0, bwd=0, decode=0):
    """A full launch-count dict: K1 ``fwd``, K2 = K3 = ``bwd``, K4
    ``decode``, nothing else."""
    return dict(flash_fwd=fwd, flash_bwd_dq=bwd, flash_bwd_dkv=bwd,
                flash_decode=decode, flash_decode_stacked=0, ring_round=0,
                ring_push=0, **NO_RING_BWD)


def seven_b_roles(spec, n_layers=ALGO_LAYERS):
    """Every role of ``spec`` at LLaMA-7B width and ``n_layers``, bf16,
    random weights from the seed; the integer tokenizer. -> vocab."""
    from realhf_tpu_torch.base.testing import IntegerTokenizer
    from realhf_tpu_torch.models.config import llama_config
    for mspec in spec.models.values():
        mspec.random_init_config = llama_config("7b", n_layers=n_layers)
        mspec.bf16 = True
    vocab = llama_config("7b")["vocab_size"]
    spec.tokenizer = IntegerTokenizer(vocab_size=vocab - 2)
    return vocab


def write_pairs(path, n, seed, lo=50, hi=200):
    """Prompts of 100-512 words, each with 2 (pos, neg) answer pairs of
    ``lo``-``hi`` words."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def words(a, b):
        return " ".join(f"w{int(w)}" for w in rng.integers(
            0, 5000, size=int(rng.integers(a, b + 1))))

    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps(dict(
                id=i, prompt=words(100, 512),
                pos_answers=[" " + words(lo, hi) for _ in range(2)],
                neg_answers=[" " + words(lo, hi) for _ in range(2)])) + "\n")


def watch_runner(runner) -> dict:
    """Wrap, on this runner's objects, what the script reads and the
    library does not keep: each MFC's host-clock seconds (up to a device
    synchronisation) and its output, and every minibatch's stats of each
    trained role's engine."""
    import torch
    from realhf_tpu_torch.api.config import ModelInterfaceType
    host = runner.host
    seen = dict(mfc_secs={name: [] for name in host.nodes},
                outputs={name: [] for name in host.nodes},
                minibatch_stats={})
    execute = host.execute

    def timed_execute(name, inp):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = execute(name, inp)
        torch.cuda.synchronize()
        seen["mfc_secs"][name].append(time.monotonic() - t0)
        seen["outputs"][name].append(out)
        return out

    host.execute = timed_execute
    for node in host.nodes.values():
        if node.interface_type != ModelInterfaceType.TRAIN_STEP:
            continue
        engine = runner.models[node.role].engine
        seen["minibatch_stats"][node.role] = got = []

        def train_minibatches(*args, _orig=engine.train_minibatches,
                              _got=got, **kw):
            _got.append(_orig(*args, **kw))
            return _got[-1]

        engine.train_minibatches = train_minibatches
    return seen


def unwatch(runner):
    vars(runner.host).pop("execute", None)
    for model in runner.models.values():
        vars(model.engine).pop("train_minibatches", None)


class no_update:
    """Train steps of ``model`` inside report their stats and change
    nothing: every loss asks the engine to skip its update
    (``__skip_update__``), and the versions are put back on exit.
    ``minibatch_stats`` keeps each call's per-minibatch stats."""

    def __init__(self, model):
        self.model, self.minibatch_stats = model, []

    def __enter__(self):
        import torch
        eng = self.model.engine
        self.versions = (eng.version, dataclasses.replace(self.model.version))
        orig = eng.train_minibatches

        def train_minibatches(minibatches, loss_fn, *args, **kw):
            def skip(params, mb):
                loss, stats = loss_fn(params, mb)
                return loss, dict(stats, __skip_update__=torch.ones_like(
                    loss.detach()))

            out = orig(minibatches, skip, *args, **kw)
            self.minibatch_stats.append(out)
            return out

        eng.train_minibatches = train_minibatches
        return self

    def __exit__(self, *exc):
        eng = self.model.engine
        del eng.train_minibatches
        eng.version, self.model.version = self.versions
        return False


def clone_params(src, dst):
    """``dst``'s engine takes a copy of ``src``'s weights (not the same
    tensors: the source's optimizer updates its own in place)."""
    dst.engine.set_params(_tree_map(lambda t: t.clone(), src.engine.params))


def probe_inputs(runner, batch):
    """Run every MFC but the train ones over ``batch``, in the graph's
    order, merging each output into it: the train MFCs' input of one
    step, outside any counted window."""
    from realhf_tpu_torch.api import data as data_api
    from realhf_tpu_torch.api.config import ModelInterfaceType
    for level in runner.dfg.topological_levels():
        for node in level:
            if node.interface_type == ModelInterfaceType.TRAIN_STEP:
                continue
            out = runner.host.execute(node.name, batch.select(
                [k for k in node.input_keys if k in batch.keys]))
            assert isinstance(out, data_api.SequenceSample)
            batch.update_(out)
    return batch


def shifted_logprobs(batch, node):
    """``node``'s input with the generation log-probs moved one token
    later (the fault of an off-by-one between decode and packed
    forward)."""
    inp = batch.select([k for k in node.input_keys if k in batch.keys])
    lp = inp.data["packed_logprobs"].copy()
    lp[1:] = lp[:-1]
    inp.data = dict(inp.data, packed_logprobs=lp)
    return inp


def algo_record(runner, seen, smi, counts, want, peak, setup):
    """What every algorithm phase reports: step and per-MFC seconds, the
    peak, launch counts against the expected ones, and whether every stat
    (the interface's and each minibatch's) is finite."""
    finite = all(math.isfinite(v) for step in runner.step_stats
                 for st in step.values() for v in st.values()) and all(
        math.isfinite(v) for calls in seen["minibatch_stats"].values()
        for call in calls for st in call for v in st.values())
    return dict(
        n_layers=ALGO_LAYERS, setup_secs=setup, card=smi,
        step_secs=runner.step_secs, mfc_secs=seen["mfc_secs"],
        mfc_runs={k: len(v) for k, v in seen["mfc_secs"].items()},
        peak_mem_gb=peak, stats=runner.step_stats, stats_finite=finite,
        launches=counts, launches_expected=want,
        launches_ok=counts == want)


def run_counted(runner):
    """``runner.run()`` between a count reset and a read, with the
    allocator's peak -> (counts, peak GB, generate calls' stats)."""
    import torch
    gen = [m.engine.generate_stats for m in runner.models.values()]
    before = [len(g) for g in gen]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    runner.run()
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    calls = [st for g, n in zip(gen, before) for st in g[n:]]
    return counts, peak, calls


def build_runner(spec):
    import torch
    from realhf_tpu_torch.system.inline import InlineRunner
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    runner = InlineRunner(without_saves(spec))  # device=None: the card
    torch.cuda.synchronize()
    return runner, time.monotonic() - t0


def drop_runner(runner):
    import torch
    unwatch(runner)
    del runner
    gc.collect()
    torch.cuda.empty_cache()


def rw_pairs_sample(rng, vocab, n_elems=4, lo=60, hi=160):
    """Elements of 2 interleaved (pos, neg) pairs of random tokens, and
    the same with every pair's pos and neg swapped."""
    import numpy as np
    from realhf_tpu_torch.api.data import SequenceSample
    seqs = [[rng.integers(2, vocab, size=int(rng.integers(lo, hi + 1)))
             .astype(np.int32) for _ in range(4)] for _ in range(n_elems)]

    def sample(elems):
        return SequenceSample(
            keys=["packed_input_ids"],
            trailing_shapes=dict(packed_input_ids=()),
            dtypes=dict(packed_input_ids=np.int32),
            ids=list(range(n_elems)),
            seqlens=dict(packed_input_ids=[[len(s) for s in e]
                                           for e in elems]),
            data=dict(packed_input_ids=np.concatenate(
                [s for e in elems for s in e])))

    swapped = [[e[1], e[0], e[3], e[2]] for e in seqs]
    return sample(seqs), sample(swapped)


def rw_parity(seed=7):
    """One ``paired_rw`` train step on the card (bf16, the kernels) and on
    the CPU (fp32, the plain versions) from the same bf16 weights and
    batch, at ``train_parity``'s size (2 layers, hidden 1024, 8 heads of
    128, FFN 2816, vocab 32000): loss and grad norm within limits; the
    card's step on the batch with every pair's pos and neg swapped must
    miss the loss limit."""
    import numpy as np
    from realhf_tpu_torch.api.config import ModelName
    from realhf_tpu_torch.api.model import Model
    from realhf_tpu_torch.base import seeding
    from realhf_tpu_torch.engine.engine import Engine
    from realhf_tpu_torch.engine.optim import OptimizerConfig
    from realhf_tpu_torch.interfaces.rw import PairedRewardInterface
    from realhf_tpu_torch.models import transformer as T
    from realhf_tpu_torch.models.config import TransformerConfig, llama_config
    from realhf_tpu_torch.models.convert import params_numpy
    base = dict(llama_config("7b", n_layers=2), hidden_dim=1024,
                n_q_heads=8, n_kv_heads=8, intermediate_dim=2816,
                gradient_checkpointing=True, is_critic=True)
    cfgs = {dev: TransformerConfig(**base, param_dtype=dt, compute_dtype=dt)
            for dev, dt in (("cuda", "bfloat16"), ("cpu", "float32"))}
    weights = params_numpy(T.init_params(cfgs["cuda"],
                                         seeding.generator(seed), "cpu"))
    sample, swapped = rw_pairs_sample(np.random.default_rng(seed + 1),
                                      base["vocab_size"])
    opt = OptimizerConfig(lr=1e-5, lr_scheduler_type="constant",
                          warmup_steps_proportion=0.0)

    def step(dev, s):
        eng = Engine(cfgs[dev], weights, dev, optimizer=opt)
        return PairedRewardInterface().train_step(
            Model(ModelName("reward", 0), eng, None), s)

    out = {dev: step(dev, sample) for dev in ("cuda", "cpu")}
    fault = step("cuda", swapped)
    lim = RW_PARITY_LIMITS

    def rel(a, k):
        return abs(a[k] - out["cpu"][k]) / abs(out["cpu"][k])

    rec = dict(layers=2, hidden=base["hidden_dim"], seed=seed,
               tokens=int(sample.total_len("packed_input_ids")), stats=out,
               loss_rel_err=rel(out["cuda"], "loss"),
               grad_norm_rel_err=rel(out["cuda"], "grad_norm"), limits=lim,
               planted_fault="every pair's pos and neg swapped",
               planted_fault_stats=fault,
               planted_fault_loss_rel_err=rel(fault, "loss"))
    rec["ok"] = (rec["loss_rel_err"] <= lim["loss_rel"]
                 and rec["grad_norm_rel_err"] <= lim["grad_norm_rel"]
                 and rec["planted_fault_loss_rel_err"] > lim["loss_rel"])
    return rec


def phase_rw(smi):
    """The ``rw`` experiment through ``RWConfig.build()`` and
    ``InlineRunner``: 2 steps of 8 prompts x 2 (pos, neg) pairs, one
    microbatch; per step K1 = 2L (forward and checkpoint recompute),
    K2 = K3 = L. Then ``rw_parity``."""
    from realhf_tpu_torch.experiments.common import apply_overrides
    from realhf_tpu_torch.experiments.rw_exp import RWConfig
    steps, L = 2, ALGO_LAYERS
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "pairs.jsonl")
        write_pairs(data, 80, seed=3)
        cfg = RWConfig(experiment_name="chip-smoke", trial_name="rw",
                       benchmark_steps=steps)
        apply_overrides(cfg, {"dataset.path": data,
                              "dataset.train_bs_n_seqs": "8",
                              "dataset.max_seqlen": "1024",
                              "model.optimizer.lr": "1e-5"})
        spec = cfg.build()
        seven_b_roles(spec)
        runner, setup = build_runner(spec)
        seen = watch_runner(runner)
        counts, peak, _ = run_counted(runner)
    want = algo_launches(fwd=2 * L * steps, bwd=L * steps)
    rec = algo_record(runner, seen, smi, counts, want, peak, setup)
    rec["last_batch_tokens"] = runner.last_batch.total_len("packed_input_ids")
    rec["versions"] = dict(model=runner.models["default"].version.global_step,
                           engine=runner.models["default"].engine.version)
    drop_runner(runner)
    rec["parity"] = rw_parity()
    rec["ok"] = bool(rec["launches_ok"] and rec["stats_finite"]
                     and rec["mfc_runs"] == dict(trainDefault=steps)
                     and rec["versions"] == dict(model=steps, engine=steps)
                     and rec["parity"]["ok"])
    return rec


def phase_dpo(smi, seed=1):
    """The ``dpo`` experiment through ``DPOConfig.build()`` and
    ``InlineRunner`` on phase rw's data, actor and ref: the script first
    copies the actor's weights into the ref (the library does not), so
    step 1's loss must be ln 2 and its KL and scores 0. Per step K1 = L
    (ref_inf) + 2L, K2 = K3 = L. Planted fault, before the counted run
    and without an update: the reference sums of each pair's pos and neg
    swapped must miss the loss limit by over 10x."""
    from realhf_tpu_torch.experiments.common import apply_overrides
    from realhf_tpu_torch.experiments.dpo_exp import DPOConfig
    steps, L = 2, ALGO_LAYERS
    lim = DPO_STEP1_LIMITS
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "pairs.jsonl")
        write_pairs(data, 80, seed=3)
        cfg = DPOConfig(experiment_name="chip-smoke", trial_name="dpo",
                        benchmark_steps=steps, seed=seed)
        apply_overrides(cfg, {"dataset.path": data,
                              "dataset.train_bs_n_seqs": "8",
                              "dataset.max_seqlen": "1024",
                              "actor.optimizer.lr": "1e-5"})
        spec = cfg.build()
        seven_b_roles(spec)
        runner, setup = build_runner(spec)
        actor = runner.models["actor"]
        clone_params(actor, runner.models["ref"])
        batch = probe_inputs(runner, next(iter(runner.dataloader)))
        node = runner.host.nodes["actor_train"]
        fault_in = batch.select(list(node.input_keys))
        pairs = fault_in.data["seqlogp"].reshape(-1, 2)
        fault_in.data = dict(fault_in.data, seqlogp=pairs[:, ::-1].ravel())
        with no_update(actor):
            fault = runner.interfaces["actor_train"].train_step(
                actor, fault_in)
        seen = watch_runner(runner)
        counts, peak, _ = run_counted(runner)
    want = algo_launches(fwd=3 * L * steps, bwd=L * steps)
    rec = algo_record(runner, seen, smi, counts, want, peak, setup)
    st = runner.step_stats[0]["actor_train"]
    step1 = dict(loss_ln2=abs(st["loss"] - math.log(2)), kl=abs(st["kl"]),
                 score=max(abs(st["pos_score"]), abs(st["neg_score"])))
    rec.update(step1=step1, limits=lim,
               planted_fault="reference sums of pos and neg swapped",
               planted_fault_loss_ln2=abs(fault["loss"] - math.log(2)),
               versions=dict(model=actor.version.global_step,
                             engine=actor.engine.version))
    rec["step1_ok"] = all(step1[k] <= lim[k] for k in lim)
    rec["ok"] = bool(rec["launches_ok"] and rec["stats_finite"]
                     and rec["step1_ok"]
                     and rec["planted_fault_loss_ln2"] > 10 * lim["loss_ln2"]
                     and rec["mfc_runs"] == dict(ref_inf=steps,
                                                 actor_train=steps)
                     and rec["versions"] == dict(model=steps, engine=steps))
    drop_runner(runner)
    return rec


def phase_grpo(smi, seed=1):
    """The ``grpo`` experiment through ``GRPOConfig.build()`` and
    ``InlineRunner``, actor, ref and reward: 2 steps of 4 prompts
    (100-512 words) x group 4 = 16 decode streams, up to 128 new tokens
    (min 32) sampled at top-p 1, top-k 0, temperature 1 (no logits mask to
    replay), 4 minibatches. The script copies the actor's weights into
    the ref. Per step K1 = 3L + 2NL, K2 = K3 = NL, K4 = L x decode steps.
    Each step's first minibatch runs on the weights that generated: its
    importance weight within PPO's limit of 1, and on step 1 |grpo_kl|
    (ref = actor) within its limit. Planted fault, before the counted run
    and without an update: old log-probs shifted by one token."""
    from realhf_tpu_torch.experiments.common import apply_overrides
    from realhf_tpu_torch.experiments.grpo_exp import GRPOConfig
    steps, L, N, g = 2, ALGO_LAYERS, ALGO_MINIBATCHES, 4
    lim = PPO_FIRST_MINIBATCH_LIMITS["importance_weight"]
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "prompts.jsonl")
        write_prompts(data, 40, seed=4)
        cfg = GRPOConfig(experiment_name="chip-smoke", trial_name="grpo",
                         benchmark_steps=steps, seed=seed)
        apply_overrides(cfg, {"dataset.path": data,
                              "dataset.train_bs_n_seqs": "4",
                              "dataset.max_seqlen": "512",
                              "grpo.group_size": str(g),
                              "grpo.max_new_tokens": "128",
                              "grpo.min_new_tokens": "32",
                              "grpo.top_p": "1.0", "grpo.top_k": "0",
                              "grpo.ppo_n_minibatches": str(N),
                              "actor.optimizer.lr": "1e-5"})
        spec = cfg.build()
        seven_b_roles(spec)
        runner, setup = build_runner(spec)
        actor = runner.models["actor"]
        clone_params(actor, runner.models["ref"])
        batch = probe_inputs(runner, next(iter(runner.dataloader)))
        with no_update(actor) as probe:
            runner.interfaces["actor_train"].train_step(
                actor, shifted_logprobs(batch,
                                        runner.host.nodes["actor_train"]))
        seen = watch_runner(runner)
        counts, peak, gen = run_counted(runner)
    want = algo_launches(fwd=(3 * L + 2 * N * L) * steps,
                         bwd=N * L * steps,
                         decode=L * sum(st["decode_steps"] for st in gen))
    rec = algo_record(runner, seen, smi, counts, want, peak, setup)
    firsts = [call[0] for call in seen["minibatch_stats"]["actor"]]
    fault_iw = probe.minibatch_stats[0][0]["importance_weight"]
    rollouts = seen["outputs"]["actor_gen"]
    rec.update(
        decode_steps=[st["decode_steps"] for st in gen],
        generated_tokens=[st["generated_tokens"] for st in gen],
        first_minibatch=dict(
            importance_weight=[m["importance_weight"] for m in firsts],
            grpo_kl=[m["grpo_kl"] for m in firsts],
            limits=dict(importance_weight=lim, grpo_kl=GRPO_KL_LIMIT)),
        nested_per_id=[sorted({len(x) for x in r.seqlens["packed_input_ids"]})
                       for r in rollouts],
        planted_fault="old log-probs shifted by one token",
        planted_fault_importance_weight=fault_iw)
    rec["first_minibatch_ok"] = len(firsts) == steps and all(
        abs(m["importance_weight"] - 1) <= lim for m in firsts) and abs(
        firsts[0]["grpo_kl"]) <= GRPO_KL_LIMIT
    rec["ok"] = bool(rec["launches_ok"] and rec["stats_finite"]
                     and rec["first_minibatch_ok"]
                     and abs(fault_iw - 1) > 10 * lim
                     and rec["nested_per_id"] == [[g]] * steps
                     and rec["mfc_runs"] == dict.fromkeys(
                         ("actor_gen", "rew_inf", "ref_inf", "actor_train"),
                         steps))
    drop_runner(runner)
    return rec


def phase_reinforce(smi):
    """``ReinforceInterface`` driven directly, as a user of the interface
    would, on models from ``build_model``: actor, reward and ref
    (``kl_coef`` 0.05): 2 rounds of 8 prompts (100-512 words), each a
    sampled decode (up to 128 new tokens, min 32, top-p 1, top-k 0) and
    its greedy twin, the reward and ref inference, and a train step of 4
    minibatches. Per round K1 = 2L (two prefills) + 2L (two inference
    MFCs) + 2NL, K2 = K3 = NL, K4 = L x (sampled + greedy decode steps).
    Checks: the greedy halves are bit-equal to a greedy
    ``PPOActorInterface.generate`` of the same prompts on the same
    weights (its launches are left out of the counts; the sampled halves
    must not be), and the train step's loss mask holds exactly the
    sampled halves' generated tokens (all halves' count must not)."""
    import numpy as np
    import torch
    from realhf_tpu_torch.api import data as data_api
    from realhf_tpu_torch.api.config import DatasetAbstraction
    from realhf_tpu_torch.api.experiment import ModelSpec
    from realhf_tpu_torch.base import seeding
    from realhf_tpu_torch.base.testing import IntegerTokenizer
    from realhf_tpu_torch.engine.optim import OptimizerConfig
    from realhf_tpu_torch.interfaces.ppo import PPOActorInterface
    from realhf_tpu_torch.interfaces.reinforce import ReinforceInterface
    from realhf_tpu_torch.interfaces.rw import PairedRewardInterface
    from realhf_tpu_torch.models.config import llama_config
    from realhf_tpu_torch.system.model_host import build_model
    rounds, L, N = 2, ALGO_LAYERS, ALGO_MINIBATCHES
    size = llama_config("7b", n_layers=L)
    tok = IntegerTokenizer(vocab_size=size["vocab_size"] - 2)
    seeding.set_random_seed(1)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    opt = OptimizerConfig(lr=1e-5, lr_scheduler_type="constant",
                          warmup_steps_proportion=0.0)
    models = {role: build_model(role, ModelSpec(
        random_init_config=dict(size), is_critic=role == "reward",
        optimizer=opt if role == "actor" else None), tok, init_seed=1)
        for role in ("actor", "reward", "ref")}
    torch.cuda.synchronize()
    setup = time.monotonic() - t0
    actor = models["actor"]
    gconfig = dict(max_new_tokens=128, min_new_tokens=32, top_p=1.0,
                   top_k=0, force_no_logits_mask=True)
    itf = ReinforceInterface(n_minibatches=N, gconfig=gconfig, kl_coef=0.05)
    twin = PPOActorInterface(gconfig=dict(gconfig, greedy=True))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "prompts.jsonl")
        write_prompts(path, 8 * rounds, seed=5)
        dataset = data_api.make_dataset(DatasetAbstraction(
            "prompt", dict(max_length=512, dataset_path=path)), 1, 0, 1, tok)
    loader = data_api.PackedDataLoader(dataset, batch_size=8, seed=1)
    masks = []
    eng = actor.engine
    orig_train = eng.train_minibatches

    def train_minibatches(minibatches, *args, **kw):
        masks.append(sum(float(mb["loss_mask"].sum()) for mbs in minibatches
                         for mb in mbs))
        return orig_train(minibatches, *args, **kw)

    eng.train_minibatches = train_minibatches
    recs, want = [], algo_launches()
    excluded = algo_launches()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for batch in loader:
        torch.cuda.synchronize()
        t_round = time.monotonic()
        n_gen = len(eng.generate_stats)
        sample = itf.generate(actor, batch)
        gen = eng.generate_stats[n_gen:]
        before = read_counts()
        greedy = twin.generate(actor, batch)
        excluded = {k: excluded[k] + v - before[k]
                    for k, v in read_counts().items()}
        torch.cuda.synchronize()
        t_gen = time.monotonic() - t_round
        parts, twins = sample.unpack(), greedy.unpack()
        halves_equal, sampled_equal, all_gen, sampled_gen = [], [], 0, 0
        for part, g in zip(parts, twins):
            ls, lg = part.seqlens["packed_input_ids"][0]
            ids = part.data["packed_input_ids"]
            halves_equal.append(bool(np.array_equal(
                ids[ls:], g.data["packed_input_ids"])))
            sampled_equal.append(bool(ids[:ls].shape == ids[ls:].shape
                                      and np.array_equal(ids[:ls], ids[ls:])))
            pm = part.data["prompt_mask"]
            sampled_gen += int((~pm[:ls]).sum())
            all_gen += int((~pm).sum())
        sample.update_(PairedRewardInterface().inference(
            models["reward"], sample.select(["packed_input_ids"])))
        sample.update_(itf.inference(models["ref"], sample.select(
            ["packed_input_ids"])))
        stats = itf.train_step(actor, sample)
        torch.cuda.synchronize()
        want = {k: want[k] + v for k, v in algo_launches(
            fwd=4 * L + 2 * N * L, bwd=N * L,
            decode=L * sum(st["decode_steps"] for st in gen)).items()}
        recs.append(dict(
            round_secs=time.monotonic() - t_round, generate_secs=t_gen,
            decode_steps=[st["decode_steps"] for st in gen],
            greedy_halves_bit_equal=all(halves_equal),
            sampled_halves_bit_equal_to_greedy=all(sampled_equal),
            loss_mask_tokens=masks[-1], sampled_generated_tokens=sampled_gen,
            all_generated_tokens=all_gen, stats=stats, card=smi))
    counts = {k: v - excluded[k] for k, v in read_counts().items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del eng.train_minibatches
    rec = dict(n_layers=L, setup_secs=setup, card=smi, rounds=recs,
               peak_mem_gb=peak, launches=counts, launches_expected=want,
               launches_excluded_twin=excluded, launches_ok=counts == want,
               versions=dict(model=actor.version.global_step,
                             engine=actor.engine.version))
    rec["ok"] = bool(
        len(recs) == rounds and rec["launches_ok"]
        and all(r["greedy_halves_bit_equal"]
                and not r["sampled_halves_bit_equal_to_greedy"]
                and r["loss_mask_tokens"] == r["sampled_generated_tokens"]
                and r["all_generated_tokens"] != r["sampled_generated_tokens"]
                and all(math.isfinite(v) for v in r["stats"].values())
                for r in recs)
        and rec["versions"] == dict(model=rounds, engine=rounds * N))
    del models, actor, itf, twin
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_agentic(smi):
    """The ``agentic`` experiment through ``AgenticPPOConfig.build()`` and
    ``InlineRunner`` on ``tool_game`` (3 turns an episode) with
    turn-level credit, actor, critic and ref: 2 steps of 16 episodes
    (prompts of 128 tokens), 32 new tokens a turn (top-p 1, top-k 0), 4
    minibatches. Per step K1 = L x generate calls + 2L (ref_inf,
    critic_inf) + 2 x 2NL, K2 = K3 = 2NL, K4 = L x the decode steps of
    all calls. No episode dropped, each sequence's turn rewards sum to its
    episode's, each step's first minibatch's importance weight (the
    packed forward over the whole multi-turn context against the per-turn
    decode log-probs) within PPO's limit; planted fault, before the
    counted run and without an update: old log-probs shifted by one
    token."""
    import numpy as np
    from realhf_tpu_torch.experiments.agentic_exp import AgenticPPOConfig
    from realhf_tpu_torch.experiments.common import apply_overrides
    steps, L, N, turns = 2, ALGO_LAYERS, ALGO_MINIBATCHES, 3
    lim = PPO_FIRST_MINIBATCH_LIMITS["importance_weight"]
    cfg = AgenticPPOConfig(experiment_name="chip-smoke", trial_name="agentic",
                           benchmark_steps=steps)
    apply_overrides(cfg, {"dataset.train_bs_n_seqs": "16",
                          "agentic.n_prompts": "48", "agentic.env": "tool_game",
                          "agentic.dataset_type": "tool_game",
                          "agentic.max_turns": str(turns),
                          "ppo.max_new_tokens": "32",
                          "ppo.min_new_tokens": "32", "ppo.top_p": "1.0",
                          "ppo.top_k": "0",
                          "ppo.ppo_n_minibatches": str(N),
                          "actor.optimizer.lr": "1e-5",
                          "critic.optimizer.lr": "1e-5"})
    spec = cfg.build()
    vocab = seven_b_roles(spec)
    spec.dataset.args.update(vocab_size=vocab, prompt_len=128)
    runner, setup = build_runner(spec)
    actor = runner.models["actor"]
    batch = probe_inputs(runner, next(iter(runner.dataloader)))
    with no_update(actor) as probe:
        runner.interfaces["actor_train"].train_step(
            actor, shifted_logprobs(batch, runner.host.nodes["actor_train"]))
    seen = watch_runner(runner)
    counts, peak, gen = run_counted(runner)
    calls = len(gen)
    want = algo_launches(
        fwd=L * calls + (2 * L + 2 * 2 * N * L) * steps,
        bwd=2 * N * L * steps,
        decode=L * sum(st["decode_steps"] for st in gen))
    rec = algo_record(runner, seen, smi, counts, want, peak, setup)
    firsts = [call[0] for call in seen["minibatch_stats"]["actor"]]
    fault_iw = probe.minibatch_stats[0][0]["importance_weight"]
    dense_ok, n_turns = True, []
    for out in seen["outputs"]["actor_gen"]:
        n_turns += out.metadata["n_turns"]
        off = 0
        for lens, r in zip(out.seqlens["dense_rewards"],
                           out.data["rewards"]):
            d = out.data["dense_rewards"][off:off + lens[0]]
            dense_ok &= bool(np.isclose(d.sum(), r, rtol=1e-6, atol=1e-6))
            off += lens[0]
    rec.update(
        generate_calls=calls, decode_steps=[st["decode_steps"] for st in gen],
        episodes=len(n_turns), turns=n_turns.count(turns),
        dense_rewards_sum_to_reward=dense_ok,
        task_reward=[s["actor_train"]["task_reward"]
                     for s in runner.step_stats],
        first_minibatch=dict(
            importance_weight=[m["importance_weight"] for m in firsts],
            limit=lim),
        planted_fault="old log-probs shifted by one token",
        planted_fault_importance_weight=fault_iw)
    rec["first_minibatch_ok"] = len(firsts) == steps and all(
        abs(m["importance_weight"] - 1) <= lim for m in firsts)
    rec["ok"] = bool(rec["launches_ok"] and rec["stats_finite"]
                     and rec["first_minibatch_ok"] and dense_ok
                     and abs(fault_iw - 1) > 10 * lim
                     and n_turns == [turns] * (16 * steps)
                     and calls == turns * steps
                     and rec["mfc_runs"] == dict.fromkeys(
                         ("actor_gen", "ref_inf", "critic_inf",
                          "actor_train", "critic_train"), steps))
    drop_runner(runner)
    return rec


def phase_profile_exp(smi):
    """The ``profile`` experiment through ``ProfileConfig(model_size=
    "7b").build()`` with every role's ``n_layers`` cut to 4: 16 random
    prompts of 100-512 tokens, up to 128 new tokens (min 32), PPO's
    sampling and 4 minibatches, 1 step: the six MFCs, PPO's launch
    formula, finite stats, per-MFC seconds through ``watch_ppo_runner``."""
    import torch
    from realhf_tpu_torch.experiments.common import apply_overrides
    from realhf_tpu_torch.experiments.profile_exp import ProfileConfig
    L, N = ALGO_LAYERS, ALGO_MINIBATCHES
    cfg = ProfileConfig(experiment_name="chip-smoke", trial_name="profile",
                        model_size="7b", benchmark_steps=1)
    apply_overrides(cfg, {"n_prompts": "16", "prompt_len_min": "100",
                          "prompt_len_max": "512",
                          "dataset.train_bs_n_seqs": "16",
                          "dataset.max_seqlen": "512",
                          "ppo.max_new_tokens": "128",
                          "ppo.min_new_tokens": "32",
                          "ppo.ppo_n_minibatches": str(N)})
    spec = cfg.build()
    for mspec in spec.models.values():
        mspec.random_init_config["n_layers"] = L
    runner, setup = build_runner(spec)
    seen = watch_ppo_runner(runner)
    counts, peak, gen = run_counted(runner)
    want = expected_ppo_launches(L, N, gen)
    firsts = [call[0] for call in seen["minibatch_stats"]["actor_train"]]
    finite = all(math.isfinite(v) for st in runner.step_stats[0].values()
                 for v in st.values())
    rec = dict(n_layers=L, setup_secs=setup, card=smi,
               step_secs=runner.step_secs,
               mfc_secs={k: v[0] for k, v in seen["mfc_secs"].items()
                         if v},
               mfc_runs={k: len(v) for k, v in seen["mfc_secs"].items()},
               decode_steps=[st["decode_steps"] for st in gen],
               peak_mem_gb=peak, stats=runner.step_stats,
               stats_finite=finite,
               importance_weight=[m["importance_weight"] for m in firsts],
               launches=counts, launches_expected=want,
               launches_ok=counts == want)
    rec["ok"] = bool(rec["launches_ok"] and finite
                     and rec["mfc_runs"] == dict.fromkeys(PPO_MFCS, 1))
    vars(runner.host).pop("execute", None)
    for model in runner.models.values():
        for method in ("generate", "forward_values", "forward_logprobs",
                       "train_minibatches"):
            vars(model.engine).pop(method, None)
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    return rec


ALGO_PHASES = (("rw", phase_rw), ("dpo", phase_dpo), ("grpo", phase_grpo),
               ("reinforce", phase_reinforce), ("agentic", phase_agentic),
               ("profile_exp", phase_profile_exp))


def run_algo_phases(smi):
    """Each algorithm phase in turn, its JSON line and a summary line
    (step seconds, per-MFC seconds, peak, the card) -> their records."""
    recs = {}
    for name, phase in ALGO_PHASES:
        rec = recs[name] = phase(smi)
        emit(name, **rec)
        summary = {k: rec[k] for k in ("step_secs", "mfc_secs", "rounds",
                                       "peak_mem_gb") if k in rec}
        if "rounds" in summary:
            summary["rounds"] = [{k: r[k] for k in (
                "round_secs", "generate_secs")} for r in rec["rounds"]]
        print(f"{name}-7bw-l{ALGO_LAYERS}: {json.dumps(summary)} ({smi})",
              flush=True)
    return recs


# ----------------------------------------------------------------------
# phases 22-23: checkpoint IO and resume
# ----------------------------------------------------------------------
CKPT_NEW_TOKENS = 32
# ckpt_gen saves and loads the gen cell's model at 4 of its 32 layers
# and ckpt_resume at 1 of the sft cell's 4 (8 and 2 before the hd 256
# ring, MoE-in-pipeline and s-with-p phases came), to keep the script
# inside its time: their checks are bit-equality, which depth does not
# change; the load rate and host peak are read at that size
CKPT_GEN_LAYERS = 4
CKPT_RESUME_LAYERS = 1
#: a sound resume is bit-equal (reads 0); the planted fault (fresh
#: moments) must move some parameter by at least ten times this share
#: of the step's largest update
CKPT_RESUME_LIMIT = 0.01


def without_saves(spec):
    """The runner saves its trained roles at the end of every ``run``.
    The phases before the checkpoint phases time their steps without
    those saves (~150 GB of writes at their sizes), as they did before
    the port could save: every train MFC's interface gets
    ``enable_save=False``. Returns the spec."""
    from realhf_tpu_torch.api.config import ModelInterfaceType
    for node in spec.mfcs:
        if node.interface_type == ModelInterfaceType.TRAIN_STEP:
            node.interface_impl.args["enable_save"] = False
    return spec


def ckpt_scratch(need_bytes: int) -> str:
    """A fresh directory under ``_ckpt_scratch/`` beside this script
    (gitignored), after checking that ``need_bytes`` fit on its disk."""
    import shutil
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "_ckpt_scratch")
    os.makedirs(root, exist_ok=True)
    free = shutil.disk_usage(root).free
    if free < need_bytes:
        raise RuntimeError(
            f"checkpoint phases need {need_bytes / 1e9:.1f} GB free under "
            f"{root}; the disk has {free / 1e9:.1f} GB")
    return tempfile.mkdtemp(dir=root)


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def _proc_status_kb(key) -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1])
    raise KeyError(key)


class HostPeak:
    """Growth of this process's resident memory over a block, in GB: the
    kernel's high-water mark (``VmHWM``) after resetting it through
    ``/proc/self/clear_refs``, or, where that is refused, the largest
    ``VmRSS`` a sampling thread saw."""

    def __enter__(self):
        import threading
        self.base = _proc_status_kb("VmRSS")
        try:
            with open("/proc/self/clear_refs", "w") as f:
                f.write("5")
            self.method = "VmHWM"
        except OSError:
            self.method = "sampled VmRSS"
        self._peak, self._stop = self.base, threading.Event()
        if self.method != "VmHWM":
            def sample():
                while not self._stop.wait(0.005):
                    self._peak = max(self._peak, _proc_status_kb("VmRSS"))
            self._thread = threading.Thread(target=sample, daemon=True)
            self._thread.start()
        return self

    def __exit__(self, *exc):
        if self.method == "VmHWM":
            self._peak = _proc_status_kb("VmHWM")
        else:
            self._stop.set()
            self._thread.join()
        self.growth_gb = (self._peak - self.base) / 2 ** 20


def named_leaves(tree, prefix=""):
    """(dotted path, leaf) in sorted-key order."""
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out += named_leaves(tree[k], f"{prefix}{k}.")
        else:
            out.append((prefix + k, tree[k]))
    return out


def leaves_equal(a, b) -> dict:
    """Per-leaf ``torch.equal`` of two trees -> {"all": bool, "differ":
    [paths]}. A numpy leaf of ``a`` is compared on its counterpart's
    device."""
    import torch
    from realhf_tpu_torch.base.safetensors_io import numpy_to_tensor
    la, lb = named_leaves(a), named_leaves(b)
    differ = [n for (n, x), (m, y) in zip(la, lb)
              if n != m or not torch.equal(
                  x if torch.is_tensor(x)
                  else numpy_to_tensor(x).to(y.device), y)]
    if len(la) != len(lb):
        differ.append("leaf count")
    return {"all": not differ, "differ": differ}


def skip_q_transpose():
    """Planted fault: the llama converter left q_proj in HF's (out, in)
    layout (square at 7B width, so the load goes through). Returns the
    function that restores it."""
    import numpy as np
    from realhf_tpu_torch.models import hf
    fam = hf.HF_FAMILIES["llama"]
    orig = fam.params_from_hf

    def faulty(state, cfg):
        params = orig(state, cfg)
        wq = params["blocks"]["attn"]["wq"]
        params["blocks"]["attn"]["wq"] = np.ascontiguousarray(
            wq.transpose(0, 2, 1))
        return params

    fam.params_from_hf = faulty

    def restore():
        fam.params_from_hf = orig
    return restore


def gen_tokens(runner):
    import numpy as np
    return np.array(runner.last_batch.data["packed_input_ids"])


def phase_ckpt_gen(smi):
    """The gen cell's 7B model at ``CKPT_GEN_LAYERS`` layers saved with
    the streamed save and loaded into a new gen runner (``model.path``, the streamed load):
    every leaf bit-equal to the saved model's and to the registry's eager
    load of the same files, a greedy batch's tokens equal to the original
    model's with exact K1/K4 counts; a loader that skips q_proj's
    transpose must fail both the leaves and the tokens."""
    import numpy as np
    import shutil
    import torch
    from realhf_tpu_torch.models import hf
    from realhf_tpu_torch.system.inline import InlineRunner
    n_layers = CKPT_GEN_LAYERS
    rec = dict(n_layers=n_layers, new_tokens=CKPT_NEW_TOKENS, card=smi)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "prompts.jsonl")
        write_prompts(data, 8, seed=1)
        spec, vocab = build_gen_spec(data, n_layers, CKPT_NEW_TOKENS, 1)
        runner = InlineRunner(spec)  # device=None: the card
        eng = runner.models["default"].engine
        runner.run()
        want_tokens = gen_tokens(runner)
        model_bytes = tree_bytes(eng.params)
        ckpt = ckpt_scratch(int(model_bytes * 1.05) + 2 ** 30)
        try:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            hf.save_hf_checkpoint_streamed(ckpt, "llama", eng.cfg,
                                           eng.params)
            save_s = time.monotonic() - t0
            written = dir_bytes(ckpt)
            rec.update(bytes_written=written, save_secs=save_s,
                       save_gb_per_s=written / save_s / 1e9)

            def load(compare_eager=False):
                lspec, _ = build_gen_spec(data, n_layers, CKPT_NEW_TOKENS, 1)
                apply_path(lspec, ckpt)
                gc.collect()
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                with HostPeak() as host:
                    t0 = time.monotonic()
                    lrunner = InlineRunner(lspec)
                    torch.cuda.synchronize()
                    secs = time.monotonic() - t0
                leng = lrunner.models["default"].engine
                out = dict(secs=secs, gb_per_s=written / secs / 1e9,
                           host_peak_growth_gb=host.growth_gb,
                           host_peak_method=host.method,
                           device_peak_growth_gb=(
                               torch.cuda.max_memory_allocated() - base)
                           / 2 ** 30,
                           leaves=leaves_equal(leng.params, eng.params))
                if compare_eager:
                    # the registry's eager load: every file read whole
                    # into host numpy, then converted
                    with HostPeak() as host:
                        t0 = time.monotonic()
                        _, eager = hf.load_hf_checkpoint(ckpt)
                        eager_s = time.monotonic() - t0
                    out["registry_eager"] = dict(
                        secs=eager_s, gb_per_s=written / eager_s / 1e9,
                        host_peak_growth_gb=host.growth_gb,
                        host_peak_method=host.method,
                        leaves=leaves_equal(eager, leng.params))
                    del eager
                    gc.collect()
                reset_counts()
                lrunner.run()
                torch.cuda.synchronize()
                counts = read_counts()
                n_decode = sum(st["decode_steps"]
                               for st in leng.generate_stats)
                want = dict(flash_fwd=n_layers, flash_bwd_dq=0,
                            flash_bwd_dkv=0, flash_decode=n_layers * n_decode,
                            flash_decode_stacked=0, ring_round=0,
                            ring_push=0, **NO_RING_BWD)
                out.update(tokens_equal=bool(np.array_equal(
                    gen_tokens(lrunner), want_tokens)),
                    decode_steps=n_decode, launches=counts,
                    launches_expected=want, launches_ok=counts == want)
                del lrunner, leng
                gc.collect()
                torch.cuda.empty_cache()
                return out

            rec["streamed"] = load(compare_eager=True)
            restore = skip_q_transpose()
            try:
                fault = load()
            finally:
                restore()
            rec["fault_skip_q_transpose"] = dict(
                leaves_equal=fault["leaves"]["all"],
                differ=fault["leaves"]["differ"],
                tokens_equal=fault["tokens_equal"])
        finally:
            shutil.rmtree(ckpt)
        del runner, eng
        gc.collect()
        torch.cuda.empty_cache()
    # the launches of the sound load's generate call
    got = rec["streamed"]
    rec["launches"] = got["launches"]
    rec["load_ok"] = (got["leaves"]["all"] and got["tokens_equal"]
                      and got["launches_ok"]
                      and got["registry_eager"]["leaves"]["all"])
    fault = rec["fault_skip_q_transpose"]
    rec["fault_caught"] = not fault["leaves_equal"] and not fault[
        "tokens_equal"]
    rec["ok"] = rec["load_ok"] and rec["fault_caught"]
    return rec


def apply_path(spec, path):
    """Point a built spec's default model at a checkpoint, as the
    ``model.path`` override does."""
    mspec = spec.models["default"]
    mspec.path, mspec.random_init_config = path, None


def build_resume_spec(data_path, trial, benchmark_steps, save_freq_steps=None):
    from realhf_tpu_torch.base.testing import IntegerTokenizer
    from realhf_tpu_torch.experiments.common import apply_overrides
    from realhf_tpu_torch.experiments.sft_exp import SFTConfig
    from realhf_tpu_torch.models.config import llama_config
    cfg = SFTConfig(experiment_name="chip-smoke", trial_name=trial,
                    total_train_epochs=1, benchmark_steps=benchmark_steps,
                    save_freq_steps=save_freq_steps)
    apply_overrides(cfg, {"dataset.path": data_path,
                          "dataset.train_bs_n_seqs": "16",
                          "dataset.max_seqlen": "1024", "n_mbs": "2",
                          "model.optimizer.lr": "1e-5"})
    spec = cfg.build()
    mspec = spec.models["default"]
    mspec.random_init_config = llama_config("7b",
                                            n_layers=CKPT_RESUME_LAYERS)
    spec.tokenizer = IntegerTokenizer(
        vocab_size=mspec.random_init_config["vocab_size"] - 2)
    return spec


def watch_steps(runner):
    """Record each step's batch ids on the runner's own ``run_step``."""
    seen, step = [], runner.run_step

    def watched(batch):
        out = step(batch)
        seen.append(list(batch.ids))
        return out

    runner.run_step = watched
    return seen


def param_snapshot(eng):
    return [(n, t.clone()) for n, t in named_leaves(eng.params)]


def update_diff(got, want, before) -> float:
    """The largest |got - want| over the largest |want - before|, over
    every parameter leaf (the step's update as the yardstick)."""
    num = max(float((g.float() - w.float()).abs().max())
              for (_, g), (_, w) in zip(got, want))
    den = max(float((w.float() - b.float()).abs().max())
              for (_, w), (_, b) in zip(want, before))
    return num / den


def phase_ckpt_resume(smi):
    """The sft cell at 7B width, ``CKPT_RESUME_LAYERS`` layers, lr 1e-5,
    gradient checkpointing, 3 steps of 16 records: run A takes 3 steps; run B takes 2 with
    ``save_freq_steps=1`` and ``recover_mode="auto"``; run C, a new runner
    with ``recover_mode="resume"``, takes step 3 from B's last save. C's
    batch, loss, grad norm and updated weights must equal A's step 3, with
    exact K1/K2/K3 counts. Planted fault D: C with its optimizer state
    left fresh must move the weights away from A's by >= 10x the limit."""
    import shutil
    import torch
    from realhf_tpu_torch.base import constants
    from realhf_tpu_torch.engine import opt_checkpoint
    from realhf_tpu_torch.system import model_host
    from realhf_tpu_torch.system.inline import InlineRunner
    L, mbs = CKPT_RESUME_LAYERS, 2
    rec = dict(n_layers=L, card=smi)
    tmp = tempfile.mkdtemp()
    data = os.path.join(tmp, "sft.jsonl")
    write_prompt_answers(data, 48, seed=5)

    def runner_of(trial, steps, save_freq=None, mode="disabled",
                  saves=True):
        gc.collect()
        torch.cuda.empty_cache()
        spec = build_resume_spec(data, trial, steps, save_freq)
        if not saves:
            without_saves(spec)
        with HostPeak() as host:
            t0 = time.monotonic()
            r = InlineRunner(spec, recover_mode=mode)
            torch.cuda.synchronize()
            secs = time.monotonic() - t0
        return r, dict(setup_secs=secs, host_peak_growth_gb=host.growth_gb,
                       host_peak_method=host.method)

    # A: the uninterrupted reference (its final save is not the subject)
    a, _ = runner_of("ckpt-a", 3, saves=False)
    a_ids = watch_steps(a)
    a.run()
    a_stats = [st["trainDefault"] for st in a.step_stats]
    a_after = param_snapshot(a.models["default"].engine)
    eng = a.models["default"].engine
    need = (tree_bytes(eng.params)
            + sum(4 * math.prod(s) for s, _ in eng.opt_state_spec()))
    del a, eng
    root = ckpt_scratch(int(need * 1.1) + 2 ** 30)
    orig_root, constants.ROOT_DIR = constants.ROOT_DIR, root
    orig_save_opt = opt_checkpoint.save_opt_state_iter
    try:
        # B: two steps, saving each, with the recover dump
        b, rec["b_setup"] = runner_of("ckpt-b", 2, save_freq=1, mode="auto")
        itf = b.interfaces["trainDefault"]
        saves = dict(weights=[], optimizer=[])

        def timed(kind, fn):
            def call(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.monotonic()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                saves[kind].append(time.monotonic() - t0)
                return out
            return call

        itf.save = timed("weights", itf.save)
        opt_checkpoint.save_opt_state_iter = timed("optimizer",
                                                   orig_save_opt)
        b.run()
        opt_checkpoint.save_opt_state_iter = orig_save_opt
        b_stats = [st["trainDefault"] for st in b.step_stats]
        del b, itf
        ckpt = os.path.join(constants.run_save_path("chip-smoke", "ckpt-b"),
                            "default")
        opt_bytes = os.path.getsize(os.path.join(ckpt,
                                                 opt_checkpoint.FILENAME))
        rec.update(saves_secs=saves, bytes_saved=dir_bytes(ckpt),
                   optimizer_bytes=opt_bytes,
                   b_losses=[s["loss"] for s in b_stats])

        def resume(fresh_moments=False):
            restore = model_host.opt_checkpoint.restore_engine_opt_state
            if fresh_moments:
                model_host.opt_checkpoint.restore_engine_opt_state = (
                    lambda *args, **kw: False)
            try:
                c, setup = runner_of("ckpt-b", 3, mode="resume")
            finally:
                model_host.opt_checkpoint.restore_engine_opt_state = restore
            # the fault's final save and dump would replace B's; the sound
            # run's is not the subject (B's saves are timed), and skipping
            # it keeps the script inside its time
            c._maybe_save = lambda *args, **kw: None
            ceng = c.models["default"].engine
            before = param_snapshot(ceng)
            ids = watch_steps(c)
            reset_counts()
            t0 = time.monotonic()
            c.run()
            torch.cuda.synchronize()
            run_s = time.monotonic() - t0
            counts = read_counts()
            st = c.step_stats[0]["trainDefault"] if c.step_stats else {}
            want = a_stats[2]
            after = param_snapshot(ceng)
            out = dict(setup, run_secs=run_s, step_secs=c.step_secs,
                       batch_ids_equal=ids[:1] == a_ids[2:3],
                       loss=st.get("loss"), grad_norm=st.get("grad_norm"),
                       loss_equal=st.get("loss") == want["loss"],
                       grad_norm_equal=st.get("grad_norm")
                       == want["grad_norm"],
                       global_step=c.global_step, launches=counts,
                       weights_equal=all(
                           torch.equal(x, y)
                           for (_, x), (_, y) in zip(after, a_after)),
                       update_diff=update_diff(after, a_after, before))
            del c, ceng, before, after
            return out

        # the fault first, then the sound run, both from B's last save
        rec["fault_fresh_moments"] = resume(fresh_moments=True)
        rec["c"] = resume()
    finally:
        opt_checkpoint.save_opt_state_iter = orig_save_opt
        constants.ROOT_DIR = orig_root
        shutil.rmtree(root)
        shutil.rmtree(tmp)
        gc.collect()
        torch.cuda.empty_cache()
    c = rec["c"]
    n = L * mbs  # one step: layers x microbatches
    want = dict(flash_fwd=2 * n, flash_bwd_dq=n, flash_bwd_dkv=n,
                flash_decode=0, flash_decode_stacked=0, ring_round=0,
                ring_push=0, **NO_RING_BWD)
    rec["launches"] = c["launches"]
    rec["launches_expected"] = want
    rec["launches_ok"] = c["launches"] == want
    rec["a_losses"] = [s["loss"] for s in a_stats]
    rec["limit"] = CKPT_RESUME_LIMIT
    rec["resume_ok"] = (c["batch_ids_equal"] and c["loss_equal"]
                        and c["grad_norm_equal"] and c["weights_equal"]
                        and c["update_diff"] <= CKPT_RESUME_LIMIT
                        and c["global_step"] == 3)
    d = rec["fault_fresh_moments"]
    rec["fault_caught"] = d["update_diff"] >= 10 * CKPT_RESUME_LIMIT
    rec["ok"] = rec["resume_ok"] and rec["launches_ok"] and rec[
        "fault_caught"]
    return rec


# ----------------------------------------------------------------------
# phase serve: the serving engine (inflight generator + scheduler)
# ----------------------------------------------------------------------
#: depth cut (the script's time): serve_gen and serve at 4 of
#: LLaMA-7B's 32 layers (8 since the replicated-KV and MoE-over-members
#: phases came, 4 since the hd 256 ring, MoE-in-pipeline and s-with-p
#: ones); the limits below were read at 32, where the bf16 drift they
#: bound is larger
SERVE_LAYERS = 4
SERVE_NEW_TOKENS = 128
SERVE_SLOTS = 8
SERVE_CHUNK = 8
SERVE_PROMPT_LEN = 512
SERVE_REQUESTS = 24
SERVE_SHARED_PREFIX = 256
#: the serve phase's limits, each about 3x the largest reading of
#: ``scripts/torch_serve_phases.py --seeds 1 2 3 4 5`` (H100 80GB HBM3,
#: 700 W): the largest |log-prob| gap between a decoded token
#: and one teacher-forced forward (K1) of the same sequence (0.301); the
#: largest gap between the forward's top logit and the decoded token's,
#: a near tie a bf16 decode may take either way (0.367, int8 0.485); the
#: log-prob gap of the int8 pool (0.455); the K/V rows a finished
#: sequence left in the pool against the forward's, row_rel_err over
#: every layer (0.316: the hidden states' bf16 drift, growing as the
#: square root of depth from 0.041-0.052 at layer 1). Layer 0's rows,
#: computed from the same tokens on both sides, read 0.0 (bit-equal) on
#: every seed; their limit is one bf16 unit (2^-8) of an element four
#: times its row's RMS. The planted faults read 3.3-7.5 on every one of
#: them, 3.7-6.3 at layer 0.
SERVE_LIMITS = dict(tf_logprob_abs=0.9, tie_margin=1.1,
                    int8_tf_logprob_abs=1.4, kv_row_rel=0.95,
                    kv_layer0_row_rel=2 ** -6)


def serve_model(seed=1):
    """LLaMA-7B at ``SERVE_LAYERS`` layers (bf16, random weights from ``seed``) as the
    rollout server builds it (``system/model_host.build_model``)."""
    from realhf_tpu_torch.api.experiment import ModelSpec
    from realhf_tpu_torch.models.config import llama_config
    from realhf_tpu_torch.system.model_host import build_model
    mspec = ModelSpec(random_init_config=llama_config(
        "7b", n_layers=SERVE_LAYERS), bf16=True)
    return build_model("default", mspec, tokenizer=None, init_seed=seed,
                       total_steps=1)


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def teacher_forced(cfg, params, prompt, tokens, with_kv=False):
    """One packed forward (K1) of prompt + tokens: each token's log-prob
    and the gap from the top logit to its logit at the position that
    emitted it; with ``with_kv`` also the forward's K/V rows [nl, nkv,
    len, hd] of every position."""
    import numpy as np
    import torch
    from realhf_tpu_torch.models import transformer as T
    seq = np.concatenate([prompt, tokens]).astype(np.int64)
    ids = seq if with_kv else seq[:-1]
    dev = params["embed"]["wte"].device
    ids_t = torch.as_tensor(ids, device=dev)[None]
    seg = torch.ones_like(ids_t, dtype=torch.int32)
    pos = torch.arange(len(ids), device=dev, dtype=torch.int32)[None]
    with torch.no_grad():
        hidden, kv = T.forward(cfg, params, ids_t, seg, pos,
                               return_kv=with_kv)
        n = len(prompt)
        logits = T.lm_logits(cfg, params, hidden[0, n - 1:n - 1 + len(tokens)])
        tok = torch.as_tensor(np.asarray(tokens, np.int64), device=dev)
        logp = torch.log_softmax(logits, -1).gather(-1, tok[:, None])[:, 0]
        gap = logits.amax(-1) - logits.gather(-1, tok[:, None])[:, 0]
        out = [logp.cpu().numpy(), gap.cpu().numpy()]
        if with_kv:
            out.append(tuple(x[:, 0].transpose(1, 2) for x in kv))
    return out


def tf_readings(cfg, params, items):
    """Teacher-forced readings over (prompt, tokens, logprobs) items."""
    import numpy as np
    errs, gaps = [], []
    for prompt, tokens, logprobs in items:
        lp, gap, *_ = teacher_forced(cfg, params, prompt, tokens)
        errs.append(float(np.abs(lp - logprobs).max()))
        gaps.append(float(gap.max()))
    return dict(tf_logprob_max_abs=max(errs), tf_logprob_mean_abs=float(
        np.mean(errs)), argmax_gap_max=max(gaps), sequences=len(items))


def tf_ok(r, limit_key="tf_logprob_abs"):
    return (r["tf_logprob_max_abs"] <= SERVE_LIMITS[limit_key]
            and r["argmax_gap_max"] <= SERVE_LIMITS["tie_margin"])


def serve_prompts(rng, n, vocab, shared=None, shared_every=3):
    """``n`` prompts of 100-512 tokens that repeat 6-token phrases of a
    small phrase book (n-grams recur, as in extractive traffic); every
    ``shared_every``-th starts with ``shared``."""
    import numpy as np
    book = rng.integers(2, vocab - 2, size=(24, 6))
    out = []
    for i in range(n):
        length = int(rng.integers(100, SERVE_PROMPT_LEN + 1))
        phrases = book[rng.integers(0, len(book), size=length // 6 + 1)]
        p = phrases.reshape(-1)[:length]
        if shared is not None and i % shared_every == 0:
            p = np.concatenate([shared, p])[:max(length, len(shared) + 8)]
        out.append(p.astype(np.int32))
    return out


def agreement(a, b) -> float:
    """Share of token positions where two runs' sequences agree, up to
    each pair's first difference (greedy streams part at a near tie
    and then differ for good)."""
    import numpy as np
    same = total = 0
    for x, y in zip(a, b):
        n = min(len(x), len(y))
        eq = np.asarray(x[:n]) == np.asarray(y[:n])
        same += int(np.argmin(eq)) if not eq.all() else n
        total += n
    return same / max(total, 1)


def phase_serve_gen(smi):
    """The ``gen`` experiment with ``use_inflight_batching`` and 4 slots
    through ``GenerationConfig.build()`` and ``InlineRunner`` at LLaMA-7B,
    ``SERVE_LAYERS`` layers: 8 prompts of 100-512 words, 128 greedy tokens. Gates: the
    returned log-probs against one teacher-forced forward of each
    sequence, each token the forward's argmax up to the tie margin,
    K1 = 32 x fills and K4 = 32 x decode steps. Reading: token agreement
    with the batch path on the same batch."""
    import copy
    import numpy as np
    import torch
    from realhf_tpu_torch.engine import inflight
    from realhf_tpu_torch.system.inline import InlineRunner
    rec = dict(card=smi, slots=4)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "prompts.jsonl")
        write_prompts(data, 8, seed=1)
        spec, vocab = build_gen_spec(data, SERVE_LAYERS, SERVE_NEW_TOKENS, 1)
        spec.mfcs[0].interface_impl.args.update(use_inflight_batching=True,
                                               inflight_slots=4)
        runner = InlineRunner(spec)  # device=None: the card
        eng = runner.models["default"].engine
        seen = []
        real = inflight.InflightBatchingGenerator.generate_all

        def watched(self, prompts, generator=None):
            out = real(self, prompts, generator)
            seen.append((self, [np.asarray(p) for p in prompts], out))
            return out

        torch.cuda.synchronize()
        reset_counts()
        t0 = time.monotonic()
        with patched(inflight.InflightBatchingGenerator, "generate_all",
                     watched):
            runner.run()
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
    counts = read_counts()
    gen, prompts, fins = seen[0]
    batch = runner.last_batch
    n_tok = sum(len(f.tokens) for f in fins)
    rec.update(secs=secs, generated_tokens=n_tok, tokens_per_s=n_tok / secs,
               launches=counts, decode_steps=gen.counts["decode_steps"],
               fills=gen.counts["full_prefills"],
               outputs_in_range=check_gen_output(runner, vocab))
    rec["launches_ok"] = (
        counts["flash_fwd"] == SERVE_LAYERS * gen.counts["full_prefills"]
        and counts["flash_decode"] == SERVE_LAYERS
        * gen.counts["decode_steps"]
        and gen.counts["full_prefills"] == 8
        and all(counts[k] == 0 for k in counts
                if k not in ("flash_fwd", "flash_decode")))
    rec.update(tf_readings(eng.cfg, eng.params, [
        (p, f.tokens, f.logprobs) for p, f in zip(prompts, fins)]))
    # the batch path on the same batch, for the token agreement reading
    itf = runner.interfaces["gen"]
    itf.use_inflight_batching = False
    again = copy.deepcopy(batch)
    runner.run_step(again)
    ids = again.data["packed_input_ids"]
    lens = [l[0] for l in again.seqlens["packed_input_ids"]]
    offs = np.cumsum([0] + lens)
    batch_tokens = [ids[offs[i] + len(p):offs[i + 1]]
                    for i, p in enumerate(prompts)]
    rec["token_agreement_with_batch_path"] = agreement(
        [f.tokens for f in fins], batch_tokens)
    rec["ok"] = (rec["launches_ok"] and rec["outputs_in_range"]
                 and tf_ok(rec) and len(fins) == 8
                 and all(len(f.tokens) == SERVE_NEW_TOKENS for f in fins))
    del runner, eng, seen, gen
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def perturbed(params, seed):
    """A second weight version: every leaf plus N(0, 0.01) noise in its
    own dtype, drawn on its device from ``seed``."""
    import torch
    gen = torch.Generator(device=params["embed"]["wte"].device)
    gen.manual_seed(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return t + 0.01 * torch.randn(t.shape, generator=gen,
                                      device=t.device).to(t.dtype)

    return walk(params)


def serve_run(model, serving, prompts, waves, push=None, params=None):
    """``ContinuousScheduler`` over an ``InflightBatchingGenerator``
    composed from ``serving`` (a ``ServingSpec``) by the package's
    ``serving/server.build_server``, as a rollout server composes them,
    over ``params`` (default the model's; a ``MemberParams`` serves over
    its members). ``waves``: (step, request indices) submissions;
    ``push``: (step, params, version) for ``WeightSync.push``. Returns
    the record, the per-request results and the generator. Expected
    launches: K1 once a layer on each of the owning group's t members a
    full fill, K4 once a layer on every member a decode step (with its
    statistics on the "seq" route)."""
    import numpy as np
    import torch
    from realhf_tpu_torch.models.sharding import MemberParams
    from realhf_tpu_torch.obs import tracing
    from realhf_tpu_torch.serving import protocol
    from realhf_tpu_torch.serving.request_queue import GenRequest
    from realhf_tpu_torch.serving.server import build_server
    params = model.engine.params if params is None else params
    engine = build_server(serving, model.config, params)
    gen, queue, ws = engine.generator, engine.queue, engine.weight_sync
    sched, kv_pool = engine.scheduler, engine.kv_pool
    fills = []  # (slot, cached_len) of every fill the scheduler made
    real_fill = gen.fill_slot

    def fill(slot, *a, **kw):
        real_fill(slot, *a, **kw)
        fills.append((slot, gen.last_fill["cached_len"]))

    gen.fill_slot = fill
    waves = {step: list(idx) for step, idx in waves}
    submitted, first_tok, done, streams, events = {}, {}, {}, {}, {}
    tracing.configure(enabled=True)
    tracing.drain()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.monotonic()
    step = 0
    while step < 10_000:
        if step in waves:
            for i in waves[step]:
                rid = f"r{i}"
                submitted[rid] = time.monotonic()
                assert queue.submit(GenRequest(rid, prompts[i])).accepted
        if push is not None and step == push[0]:
            ws.push(push[1], push[2])
        for ev in sched.step(None):
            events.setdefault(ev.rid, []).append(ev)
            now = time.monotonic()
            if ev.kind == protocol.TOKENS:
                first_tok.setdefault(ev.rid, now)
                streams.setdefault(ev.rid, []).append(ev.data)
            elif ev.kind in protocol.TERMINAL_KINDS:
                done[ev.rid] = now
        step += 1
        if sched.idle() and step > max(waves):
            break
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    counts = read_counts()
    spans = tracing.drain()
    tracing.configure(enabled=False)
    results, streams_ok, terminal_ok = {}, True, True
    for rid, evs in events.items():
        kinds = [e.kind for e in evs]
        terminal_ok &= (sum(k in protocol.TERMINAL_KINDS for k in kinds) == 1
                        and kinds[-1] == protocol.DONE)
        res = evs[-1].data.get("result")
        if res is None:
            continue
        results[rid] = res
        # the stream: contiguous deltas in order, the tokens of the result
        off, toks = 0, []
        for d in streams.get(rid, []):
            streams_ok &= d["offset"] == off
            off += len(d["tokens"])
            toks.extend(np.asarray(d["tokens"]).tolist())
        streams_ok &= toks == np.asarray(res.tokens).tolist()[:len(toks)]
    n_tok = sum(len(r.tokens) for r in results.values())
    ttft = [first_tok[r] - submitted[r] for r in results]
    lat = [done[r] - submitted[r] for r in results]
    chunk_ms = [s.secs * 1e3 for s in spans if s.name == "serve:decode_chunk"]
    rec = dict(
        secs=secs, requests=len(submitted), finished=len(results),
        generated_tokens=n_tok, tokens_per_s=n_tok / secs,
        ttft_p50_s=float(np.percentile(ttft, 50)),
        ttft_p99_s=float(np.percentile(ttft, 99)),
        latency_p50_s=float(np.percentile(lat, 50)),
        latency_p99_s=float(np.percentile(lat, 99)),
        decode_chunk_ms_mean=float(np.mean(chunk_ms)),
        decode_chunk_ms_p50=float(np.percentile(chunk_ms, 50)),
        decode_chunks=len(chunk_ms), steps=step,
        one_terminal_each=terminal_ok and len(events) == len(submitted),
        streams_in_order=streams_ok, launches=counts,
        counts=dict(gen.counts), fill_stats=dict(gen.fill_stats),
        spec_stats=dict(gen.spec_stats), scheduler_stats=dict(sched.stats),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    if kv_pool is not None:
        rec["pool"] = dict(kv_pool.stats())
    lay = gen._lay
    t, n = ((params.t, len(params.trees)) if isinstance(params, MemberParams)
            else (1, 1))
    want = launches_of(model.config.n_layers, 1,
                       fwd=t * gen.counts["full_prefills"],
                       decode=n * gen.counts["decode_steps"])
    if lay is not None and lay.seq:
        want["flash_decode_stats"] = want["flash_decode"]
    rec["members"] = [str(d) for d in lay.devices] if lay else ["one"]
    rec["launches_expected"] = want
    rec["launches_ok"] = counts == want
    if gen.counts["decode_steps"] == 0 and gen.spec_stats["rounds"] == 0:
        rec["launches_ok"] = False
    rec["decode_ms_per_step"] = (sum(chunk_ms) / gen.counts["decode_steps"]
                                 if gen.counts["decode_steps"] else None)
    rec["prefix_hit_groups"] = sorted({lay.group_of(s)[0] if lay else 0
                                       for s, c in fills if c > 0})
    gen.fill_slot = real_fill
    return rec, results, gen


def phase_serve(smi):
    """The scheduler over the port's generator at LLaMA-7B, ``SERVE_LAYERS`` layers:
    24 requests (prompts of 100-512 tokens from a phrase book, 8 of them
    behind one 256-token prefix, 128 greedy tokens, no EOS) in 3 waves
    over 8 slots, chunk 8, in four configurations composed from
    ``ServeConfig(...).build().serving``: (a) dense bf16 with a weight
    push (version 1) mid-run under max_staleness 1, (b) paged bf16
    (block 16) with the pooled prefix cache, (c) paged int8, (d) dense
    with ``spec_decode_k=4``. Then the KV check of a small paged run and
    its two planted faults, and prefill times per bucket."""
    import numpy as np
    import torch
    from realhf_tpu_torch.engine import inflight
    from realhf_tpu_torch.experiments.serve_exp import ServeConfig
    rec = dict(card=smi)
    t_phase = time.monotonic()
    model = serve_model()
    cfg, params = model.config, model.engine.params
    vocab = cfg.vocab_size
    rng = np.random.default_rng(11)
    shared = rng.integers(2, vocab - 2, size=SERVE_SHARED_PREFIX)
    prompts = serve_prompts(rng, SERVE_REQUESTS, vocab, shared)
    waves = [(0, range(0, 8)), (4, range(8, 16)), (24, range(16, 24))]
    base = dict(n_slots=SERVE_SLOTS, chunk_size=SERVE_CHUNK,
                max_prompt_len=SERVE_PROMPT_LEN, max_staleness=1,
                greedy=True, max_new_tokens=SERVE_NEW_TOKENS,
                prefix_cache_bytes=0)
    configs = dict(
        a_dense_bf16=dict(kv_cache_dtype="bf16"),
        b_paged_bf16=dict(paged_kv=True, kv_cache_dtype="bf16",
                          kv_block_len=16, kv_pool_blocks=480,
                          prefix_cache_bytes=4 << 30),
        c_paged_int8=dict(paged_kv=True, kv_cache_dtype="int8",
                          kv_block_len=16),
        d_dense_spec4=dict(kv_cache_dtype="bf16", spec_decode_k=4))
    runs, outs = {}, {}
    push_step = 20
    for name, over in configs.items():
        serving = ServeConfig(**dict(base, **over)).build().serving
        push = None
        if name.startswith("a_"):
            push = (push_step, perturbed(params, seed=2), 1)
        r, results, gen = serve_run(model, serving, prompts, waves, push)
        push = None
        if name.startswith("a_"):
            # after the push the generator holds WeightSync's copy of v1;
            # wave 1 ran under v0, wave 3 (submitted after the push)
            # under v1, wave 2 straddles the push
            late = [f"r{i}" for i in waves[2][1]]
            early = [f"r{i}" for i in waves[0][1]]
            r["versions"] = {x: [results[x].weight_version,
                                 results[x].weight_version_final]
                             for x in sorted(results, key=lambda x:
                                             int(x[1:]))}
            r["versions_ok"] = (
                all(results[x].weight_version == 1 for x in late)
                and all(results[x].weight_version_final == 0
                        for x in early))
            v1_params = gen.params
            direct = inflight.InflightBatchingGenerator(
                cfg, v1_params, gen.g, n_slots=SERVE_SLOTS,
                max_prompt_len=SERVE_PROMPT_LEN, eos_token_id=None,
                pad_token_id=0, chunk_size=SERVE_CHUNK,
                kv_cache_dtype="bf16")
            want = direct.generate_all([prompts[int(x[1:])] for x in late])
            r["v1_tokens_equal_direct"] = all(
                np.array_equal(results[x].tokens, w.tokens)
                for x, w in zip(late, want))
            r["tf_v1"] = tf_readings(cfg, v1_params, [
                (prompts[int(x[1:])], results[x].tokens, results[x].logprobs)
                for x in late])
            r["tf_v0"] = tf_readings(cfg, params, [
                (prompts[int(x[1:])], results[x].tokens, results[x].logprobs)
                for x in early])
            r["ok_checks"] = (r["versions_ok"] and r["v1_tokens_equal_direct"]
                              and tf_ok(r["tf_v1"]) and tf_ok(r["tf_v0"]))
            del direct, v1_params
        else:
            key = ("int8_tf_logprob_abs" if "int8" in name
                   else "tf_logprob_abs")
            r["tf"] = tf_readings(cfg, params, [
                (prompts[int(x[1:])], res.tokens, res.logprobs)
                for x, res in results.items()])
            r["ok_checks"] = tf_ok(r["tf"], key)
            if name.startswith("b_"):
                r["ok_checks"] &= r["fill_stats"]["prefill_tokens_saved"] > 0
            if name.startswith("d_"):
                sc = r["scheduler_stats"]
                r["spec_accept_rate"] = (sc["spec_accepted"]
                                         / max(sc["spec_proposed"], 1))
                r["oracle"] = serve_oracle_spec(
                    model, [prompts[i] for i in waves[0][1]],
                    [results[f"r{i}"].tokens for i in waves[0][1]])
                r["ok_checks"] &= r["oracle"]["ok"]
        r["ok"] = (r["ok_checks"] and r["launches_ok"]
                   and r["one_terminal_each"] and r["streams_in_order"]
                   and r["finished"] == SERVE_REQUESTS)
        runs[name] = r
        outs[name] = {rid: res.tokens for rid, res in results.items()}
        print(f"serve {name}: " + json.dumps({k: r[k] for k in (
            "tokens_per_s", "ttft_p50_s", "ttft_p99_s", "latency_p50_s",
            "latency_p99_s", "decode_chunk_ms_mean", "peak_mem_gb",
            "launches", "ok")}) + f" ({smi})", flush=True)
        del gen, results
        gc.collect()
        torch.cuda.empty_cache()
    # readings: token agreement with (a) on the requests served under v0
    v0 = [f"r{i}" for i in waves[0][1]]
    for name in ("b_paged_bf16", "c_paged_int8", "d_dense_spec4"):
        runs[name]["token_agreement_with_a_v0"] = agreement(
            [outs["a_dense_bf16"][x] for x in v0],
            [outs[name][x] for x in v0])
    # (a)'s first wave on one device, for serve_par's agreement reading
    rec["a_v0_tokens"] = {x: outs["a_dense_bf16"][x].tolist() for x in v0}
    rec["configs"] = runs
    rec["kv_check"] = serve_kv_check(model, prompts)
    rec["prefill_ms_per_bucket"] = serve_prefill_times(model)
    rec["secs"] = time.monotonic() - t_phase
    rec["ok"] = (all(r["ok"] for r in runs.values())
                 and rec["kv_check"]["ok"])
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def kv_rows_err(cfg, params, prompt, fs):
    """row_rel_err of the K and V rows a finished sequence left in the
    cache (``fs.kv``, exported) against one forward's K/V, per layer:
    over the prompt's rows (written by the fill's prefill, K1) and over
    the decoded tokens' rows (written by decode steps, K4), each the
    larger of K's and V's. {"prompt": [nl], "decode": [nl]}."""
    import torch
    _, _, (k, v) = teacher_forced(cfg, params, prompt, fs.tokens,
                                  with_kv=True)
    n_p = len(prompt)
    out = dict(prompt=[0.0] * cfg.n_layers, decode=[0.0] * cfg.n_layers)
    for got, ref in zip(fs.kv, (k, v)):
        g = torch.as_tensor(got, device=ref.device)
        n = g.shape[2]
        for part, sl in (("prompt", slice(0, n_p)), ("decode", slice(n_p, n))):
            gs, rs = g[:, :, sl], ref[:, :, sl]
            rows = torch.ones(rs.shape[1:-1], dtype=torch.bool,
                              device=ref.device)
            for li in range(cfg.n_layers):
                out[part][li] = max(out[part][li],
                                    row_rel_err(gs[li], rs[li], rows))
    return out


def serve_kv_check(model, prompts, n=6, new_tokens=32):
    """A paged bf16 run (4 slots, 6 requests, 32 greedy tokens) whose
    finished sequences' pool rows are exported and held against one
    forward's K/V of each sequence (row_rel_err per layer, over the
    prompt's rows and the decoded rows), beside the teacher-forced
    check. Layer 0, whose inputs are the same tokens on both sides, is
    held to its own limit of bf16 rounding; the deeper layers carry the
    drift of the hidden states. Planted faults that must fail both: a fill
    whose positions are one off, and a ``pool_scatter`` that clamps
    masked lanes onto live rows (the first row of the lane's sequence)
    instead of the scratch block."""
    import numpy as np
    from realhf_tpu_torch.base.safetensors_io import numpy_to_tensor
    from realhf_tpu_torch.engine import inflight
    from realhf_tpu_torch.engine import kv_pool as kvp
    from realhf_tpu_torch.ops.sampling import GenerationHyperparameters
    cfg, params = model.config, model.engine.params
    g = GenerationHyperparameters(max_new_tokens=new_tokens, greedy=True,
                                  force_no_logits_mask=True)
    ps = [p[:int(l)] for p, l in zip(prompts[:n], (100, 131, 250, 317, 400,
                                                   511))]

    def run():
        pool = kvp.KVPool(cfg, 4 * 40, 16, dtype="bf16")
        gen = inflight.InflightBatchingGenerator(
            cfg, params, g, n_slots=4, max_prompt_len=SERVE_PROMPT_LEN,
            eos_token_id=None, pad_token_id=0, chunk_size=SERVE_CHUNK,
            kv_pool=pool)
        queue = list(enumerate(ps))[::-1]
        fins = {}
        while queue or gen.n_live:
            for slot in gen.free_slots():
                if queue:
                    rid, p = queue.pop()
                    gen.fill_slot(slot, rid, p)
            gen.decode_chunk()
            for fs in gen.harvest(export_kv=True):
                fins[fs.request_id] = fs
        for fs in fins.values():
            fs.kv = tuple(np.asarray(numpy_to_tensor(x).float().numpy())
                          for x in fs.kv)
        per = [kv_rows_err(cfg, params, ps[i], fins[i])
               for i in range(len(ps))]
        by_layer = {part: [max(e[part][li] for e in per)
                           for li in range(cfg.n_layers)]
                    for part in ("prompt", "decode")}
        tf = tf_readings(cfg, params, [(ps[i], fins[i].tokens,
                                        fins[i].logprobs)
                                       for i in range(len(ps))])
        return dict(kv_row_rel_err=max(max(x) for x in by_layer.values()),
                    kv_layer0_row_rel_err=max(x[0] for x in
                                              by_layer.values()),
                    kv_row_rel_by_layer=by_layer, **tf)

    def kv_ok(r):
        return (r["kv_row_rel_err"] <= SERVE_LIMITS["kv_row_rel"]
                and r["kv_layer0_row_rel_err"]
                <= SERVE_LIMITS["kv_layer0_row_rel"])

    rec = dict(limit=SERVE_LIMITS["kv_row_rel"],
               layer0_limit=SERVE_LIMITS["kv_layer0_row_rel"], sound=run())
    real_window = inflight.InflightBatchingGenerator._prompt_window

    def off_by_one(self, prompt, width, start):
        return real_window(self, prompt, width, start + 1)

    with patched(inflight.InflightBatchingGenerator, "_prompt_window",
                 off_by_one):
        rec["fault_positions_off_by_one"] = run()
    real_scatter = kvp.pool_scatter

    def clamping_scatter(meta, arrays, rows, k_new, v_new, mask):
        # the sound scatter, then the masked lanes land on the first row
        # of their own sequence (a clamp) instead of the scratch block
        real_scatter(meta, arrays, rows, k_new, v_new, mask)
        return real_scatter(meta, arrays, rows[:, :1].expand_as(rows),
                            k_new, v_new, ~mask)

    with patched(kvp, "pool_scatter", clamping_scatter):
        rec["fault_scatter_clamps_onto_live_rows"] = run()
    rec["ok"] = kv_ok(rec["sound"]) and tf_ok(rec["sound"])
    for fault in ("fault_positions_off_by_one",
                  "fault_scatter_clamps_onto_live_rows"):
        rec[fault]["fails_kv_check"] = not kv_ok(rec[fault])
        rec[fault]["fails_layer0_check"] = (
            rec[fault]["kv_layer0_row_rel_err"] > rec["layer0_limit"])
        rec[fault]["fails_tf_check"] = not tf_ok(rec[fault])
        rec["ok"] &= (rec[fault]["fails_kv_check"]
                      and rec[fault]["fails_tf_check"])
    return rec


class OracleDrafter:
    """Drafts each request's continuation from a list of known token
    streams (matched by prompt), so the verify rounds see drafts that
    are right until the streams part. A verify round commits the greedy
    token at position e (e tokens out) itself and holds draft i against
    the token at e + 1 + i, so the drafts start one past the history."""

    def __init__(self, k, prompts, streams):
        import numpy as np
        self.k = k
        self.known = [(np.asarray(p), np.asarray(t))
                      for p, t in zip(prompts, streams)]

    def propose(self, history):
        import numpy as np
        h = np.asarray(history)
        out = np.zeros((self.k,), np.int32)
        for p, t in self.known:
            if len(h) >= len(p) and np.array_equal(h[:len(p)], p):
                cont = t[len(h) - len(p) + 1:][:self.k]
                out[:len(cont)] = cont
                break
        return out


def serve_oracle_spec(model, prompts, streams, k=4):
    """Speculative decoding with drafts taken from an earlier run's
    streams of the same prompts: the verify rounds must accept drafts
    on the card and the tokens pass the teacher-forced check."""
    from realhf_tpu_torch.engine import inflight
    from realhf_tpu_torch.ops.sampling import GenerationHyperparameters
    g = GenerationHyperparameters(max_new_tokens=SERVE_NEW_TOKENS,
                                  greedy=True, force_no_logits_mask=True)
    gen = inflight.InflightBatchingGenerator(
        model.config, model.engine.params, g, n_slots=SERVE_SLOTS,
        max_prompt_len=SERVE_PROMPT_LEN, eos_token_id=None, pad_token_id=0,
        chunk_size=SERVE_CHUNK, kv_cache_dtype="bf16", spec_decode_k=k,
        drafter=OracleDrafter(k, prompts, streams))
    t0 = time.monotonic()
    fins = gen.generate_all(prompts)
    secs = time.monotonic() - t0
    prop = sum(f.spec_proposed for f in fins)
    acc = sum(f.spec_accepted for f in fins)
    rec = dict(secs=secs, rounds=gen.spec_stats["rounds"],
               spec_proposed=prop, spec_accepted=acc,
               accept_rate=acc / max(prop, 1),
               token_agreement_with_drafts=agreement(
                   streams, [f.tokens for f in fins]),
               tokens_per_s=sum(len(f.tokens) for f in fins) / secs)
    rec.update(tf_readings(model.config, model.engine.params, [
        (p, f.tokens, f.logprobs) for p, f in zip(prompts, fins)]))
    rec["ok"] = acc > 0 and tf_ok(rec)
    return rec


def serve_prefill_times(model):
    """Device ms of one ``fill_slot`` (batch-1 prefill, K1) per prompt
    bucket: the median of 3 after a warm-up, between synchronisations."""
    import numpy as np
    import torch
    from realhf_tpu_torch.engine import inflight
    from realhf_tpu_torch.ops.sampling import GenerationHyperparameters
    g = GenerationHyperparameters(max_new_tokens=SERVE_NEW_TOKENS,
                                  greedy=True, force_no_logits_mask=True)
    gen = inflight.InflightBatchingGenerator(
        model.config, model.engine.params, g, n_slots=1,
        max_prompt_len=SERVE_PROMPT_LEN, eos_token_id=None, pad_token_id=0,
        chunk_size=SERVE_CHUNK, kv_cache_dtype="bf16")
    out = {}
    lengths = (60, 120, 250, 500)
    for n in lengths:  # every bucket once before any is timed
        gen.fill_slot(0, 0, np.full(n, 2, np.int32))
        gen.release_slot(0)
    for n in lengths:
        p = (np.arange(n) % (model.config.vocab_size - 2) + 2).astype(
            np.int32)
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen.fill_slot(0, 0, p)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            gen.release_slot(0)
        out[str(gen.last_fill["bucket"])] = float(np.median(times[1:]))
    return out


# ----------------------------------------------------------------------
# the serving engine over members: serve_par, serve_rep, serve_gen_view
# ----------------------------------------------------------------------
SERVE_PAR_REQUESTS = 12
SERVE_PAR_NEW_TOKENS = 64
#: (step, request indices): wave 0 (r0 and r3 behind the shared prefix)
#: fills slots 0-3, data group 0, and is harvested at step 7; wave 1 at
#: step 10 takes slots 0-5 (r6's prefix hit lands in group 0, r9's in
#: group 1); wave 2 the last two slots
SERVE_PAR_WAVES = ((0, range(0, 4)), (10, range(4, 10)),
                   (11, range(10, 12)))
#: the weight push of configuration (a): after wave 0, before wave 1
SERVE_PAR_PUSH_STEP = 9
SERVE_PAR_FAULT_TOKENS = 16
SERVE_REP_LAYERS = 6
SERVE_REP_REQUESTS = 8
SERVE_REP_NEW_TOKENS = 32
SERVE_VIEW_NEW_TOKENS = 64


@contextlib.contextmanager
def slot_map_shifted():
    """The planted serving-over-members fault: every slot's data group
    shifted by one, so a fill writes its prompt into the other group's
    caches (the row of another slot)."""
    from realhf_tpu_torch.engine import inflight_members as M
    real = M.Layout.group_of

    def shifted(self, slot):
        g, r = real(self, slot)
        return (g + 1) % self.d, r

    with patched(M.Layout, "group_of", shifted):
        yield


def layout_engine(cfg, params, layout):
    """An optimizer-free engine at ``layout`` over ``params`` (a d1t1
    tree), its members on ``member_devices``."""
    from realhf_tpu_torch.engine.engine import Engine
    from realhf_tpu_torch.parallel.mesh import parse_parallelism
    par = parse_parallelism(layout)
    return Engine(cfg, params, parallel=par,
                  devices=member_devices(par.world_size))


def phase_serve_par(smi, d1t1_tokens=None, only="abcd"):
    """The continuous scheduler over the members of a layout at LLaMA-7B
    width, ``SERVE_LAYERS`` layers: phase_serve's traffic cut to 12
    requests (the first 12 of its prompts, r0, r3, r6 and r9 behind the
    256-token prefix), 64 greedy tokens, 8 slots, chunk 8, in the waves
    of ``SERVE_PAR_WAVES``, composed by ``build_server`` over the
    engine's ``MemberParams``: (a) dense bf16 at d2t2 with a push of
    perturbed weights (version 1, a canonical tree the generator shards)
    at step 9 under max_staleness 1, (b) paged bf16 with the pooled
    prefix cache at d2t2, (c) paged int8 at d1t4, (d) dense with
    ``spec_decode_k=4`` at d1t4. Gates: every sequence's log-probs
    against one teacher-forced K1 forward of the d1t1 model with the
    same weights (``SERVE_LIMITS``); in (a) the requests submitted after
    the push equal a direct d2t2 generator under version 1 and the
    versions are stamped as in phase_serve; in (b) prefix hits taken in
    both data groups (the donor's blocks copied into group 1's arenas);
    exact K1/K4 counts. Planted fault: the slot-to-group map shifted by
    one must fail the teacher-forced gate. Reading: token agreement on
    wave 0 with phase_serve's d1t1 run (``d1t1_tokens``, its
    ``a_v0_tokens``). ``only`` picks configurations by letter."""
    import numpy as np
    import torch
    from realhf_tpu_torch.engine import inflight
    from realhf_tpu_torch.experiments.serve_exp import ServeConfig
    from realhf_tpu_torch.ops.sampling import GenerationHyperparameters
    rec = dict(card=smi, n_layers=SERVE_LAYERS,
               new_tokens=SERVE_PAR_NEW_TOKENS, limits=SERVE_LIMITS)
    t_phase = time.monotonic()
    model = serve_model()
    cfg, params = model.config, model.engine.params
    vocab = cfg.vocab_size
    rng = np.random.default_rng(11)
    shared = rng.integers(2, vocab - 2, size=SERVE_SHARED_PREFIX)
    prompts = serve_prompts(rng, SERVE_REQUESTS, vocab,
                            shared)[:SERVE_PAR_REQUESTS]
    waves = list(SERVE_PAR_WAVES)
    base = dict(n_slots=SERVE_SLOTS, chunk_size=SERVE_CHUNK,
                max_prompt_len=SERVE_PROMPT_LEN, max_staleness=1,
                greedy=True, max_new_tokens=SERVE_PAR_NEW_TOKENS,
                prefix_cache_bytes=0)
    configs = dict(
        a_d2t2_dense_bf16=("d2t2", dict(kv_cache_dtype="bf16")),
        b_d2t2_paged_bf16=("d2t2", dict(
            paged_kv=True, kv_cache_dtype="bf16", kv_block_len=16,
            kv_pool_blocks=480, prefix_cache_bytes=4 << 30)),
        c_d1t4_paged_int8=("d1t4", dict(paged_kv=True,
                                        kv_cache_dtype="int8",
                                        kv_block_len=16)),
        d_d1t4_dense_spec4=("d1t4", dict(kv_cache_dtype="bf16",
                                         spec_decode_k=4)))
    runs, eng, eng_layout = {}, None, None
    for name, (layout, over) in configs.items():
        if name[0] not in only:
            continue
        if layout != eng_layout:
            eng = None
            free()
            eng, eng_layout = layout_engine(cfg, params, layout), layout
        serving = ServeConfig(**dict(base, **over)).build().serving
        push = ((SERVE_PAR_PUSH_STEP, perturbed(params, seed=2), 1)
                if name.startswith("a_") else None)
        r, results, gen = serve_run(model, serving, prompts, waves, push,
                                    params=eng.params)
        r["layout"] = layout
        items = {x: (prompts[int(x[1:])], res.tokens, res.logprobs)
                 for x, res in results.items()}
        if name.startswith("a_"):
            early = [f"r{i}" for i in waves[0][1]]
            late = [f"r{i}" for w in waves[1:] for i in w[1]]
            r["versions"] = {x: [results[x].weight_version,
                                 results[x].weight_version_final]
                             for x in sorted(results,
                                             key=lambda x: int(x[1:]))}
            r["versions_ok"] = (
                all(results[x].weight_version == 1 for x in late)
                and all(results[x].weight_version_final == 0
                        for x in early))
            direct = inflight.InflightBatchingGenerator(
                cfg, gen.params, gen.g, n_slots=SERVE_SLOTS,
                max_prompt_len=SERVE_PROMPT_LEN, eos_token_id=None,
                pad_token_id=0, chunk_size=SERVE_CHUNK,
                kv_cache_dtype="bf16")
            want = direct.generate_all([prompts[int(x[1:])] for x in late])
            r["v1_tokens_equal_direct"] = all(
                np.array_equal(results[x].tokens, w.tokens)
                for x, w in zip(late, want))
            r["tf_v1"] = tf_readings(cfg, push[1], [items[x] for x in late])
            r["tf_v0"] = tf_readings(cfg, params, [items[x] for x in early])
            r["ok_checks"] = (r["versions_ok"] and r["v1_tokens_equal_direct"]
                              and tf_ok(r["tf_v1"]) and tf_ok(r["tf_v0"]))
            if d1t1_tokens:
                r["token_agreement_with_serve_d1t1_v0"] = agreement(
                    [d1t1_tokens[x] for x in early],
                    [results[x].tokens for x in early])
            del direct, want
            push = None
            free()
            # the planted fault: a direct d2t2 generator under version 0
            # with the slot map shifted by one
            fault = inflight.InflightBatchingGenerator(
                cfg, eng.params, GenerationHyperparameters(
                    max_new_tokens=SERVE_PAR_FAULT_TOKENS, greedy=True,
                    force_no_logits_mask=True),
                n_slots=SERVE_SLOTS, max_prompt_len=SERVE_PROMPT_LEN,
                eos_token_id=None, pad_token_id=0, chunk_size=SERVE_CHUNK,
                kv_cache_dtype="bf16")
            fps = prompts[:SERVE_SLOTS]
            with slot_map_shifted():
                fins = fault.generate_all(fps)
            r["planted_fault"] = dict(slot_map_shifted=tf_readings(
                cfg, params, [(p, f.tokens, f.logprobs)
                              for p, f in zip(fps, fins)]))
            r["fault_fails"] = not tf_ok(r["planted_fault"][
                "slot_map_shifted"])
            r["ok_checks"] &= r["fault_fails"]
            del fault, fins
        else:
            key = ("int8_tf_logprob_abs" if "int8" in name
                   else "tf_logprob_abs")
            r["tf"] = tf_readings(cfg, params, list(items.values()))
            r["ok_checks"] = tf_ok(r["tf"], key)
            if name.startswith("b_"):
                r["ok_checks"] &= (r["prefix_hit_groups"] == [0, 1]
                                   and r["fill_stats"]
                                   ["prefill_tokens_saved"] > 0)
            if name.startswith("d_"):
                sc = r["scheduler_stats"]
                r["spec_accept_rate"] = (sc["spec_accepted"]
                                         / max(sc["spec_proposed"], 1))
        r["ok"] = (r["ok_checks"] and r["launches_ok"]
                   and r["one_terminal_each"] and r["streams_in_order"]
                   and r["finished"] == SERVE_PAR_REQUESTS)
        runs[name] = r
        print(f"serve_par {name}: " + json.dumps({k: r[k] for k in (
            "layout", "tokens_per_s", "decode_ms_per_step",
            "decode_chunk_ms_mean", "ttft_p50_s", "latency_p50_s",
            "peak_mem_gb", "launches", "prefix_hit_groups", "ok")})
            + f" ({smi})", flush=True)
        del gen, results, items
        free()
    rec["configs"] = runs
    rec["secs"] = time.monotonic() - t_phase
    rec["ok"] = all(r["ok"] for r in runs.values())
    del model, params, eng
    free()
    return rec


def phase_serve_rep(smi, seed=1):
    """``google/gemma-2b`` (8 q heads on one KV head of 256) served at
    d1t2, where t does not divide the KV heads: the "seq" route (each
    member every KV head over its half of the cache slots, K4 with
    statistics and the flash merge), ``SERVE_REP_LAYERS`` of its 18
    layers, 8 requests of 100-512 tokens in one wave, 32 greedy tokens,
    dense bf16, through ``build_server``. Gates: every sequence's
    log-probs against one teacher-forced K1 forward of the d1t1 model
    (``GEMMA_LIMITS``), exact K1/K4 counts with every K4 launch taking
    the statistics entry."""
    import numpy as np
    from realhf_tpu_torch.api.experiment import ModelSpec
    from realhf_tpu_torch.experiments.serve_exp import ServeConfig
    from realhf_tpu_torch.system.model_host import build_model
    mcfg = hf_random_init_config("gemma", GEMMA_2B, SERVE_REP_LAYERS)
    model = build_model("default", ModelSpec(random_init_config=mcfg,
                                             bf16=True), None,
                        init_seed=seed, total_steps=1)
    cfg, params = model.config, model.engine.params
    eng = layout_engine(cfg, params, "d1t2")
    prompts = serve_prompts(np.random.default_rng(12), SERVE_REP_REQUESTS,
                            cfg.vocab_size)
    serving = ServeConfig(
        n_slots=SERVE_SLOTS, chunk_size=SERVE_CHUNK,
        max_prompt_len=SERVE_PROMPT_LEN, greedy=True,
        max_new_tokens=SERVE_REP_NEW_TOKENS, kv_cache_dtype="bf16",
        prefix_cache_bytes=0).build().serving
    r, results, gen = serve_run(model, serving, prompts,
                                [(0, range(SERVE_REP_REQUESTS))],
                                params=eng.params)
    lay = gen._lay
    r.update(layout="d1t2", n_layers=SERVE_REP_LAYERS, card=smi,
             heads=[cfg.n_q_heads, cfg.n_kv_heads], head_dim=cfg.head_dim,
             seq_route=lay.seq, cache_slots=lay.slots,
             slots_per_member=lay.s_loc, limits=GEMMA_LIMITS)
    r["tf"] = tf_readings(cfg, params, [
        (prompts[int(x[1:])], res.tokens, res.logprobs)
        for x, res in results.items()])
    r["tf_ok"] = (r["tf"]["tf_logprob_max_abs"]
                  <= GEMMA_LIMITS["gemma_tf_logprob_abs"])
    r["stats_launches"] = r["launches"]["flash_decode_stats"]
    r["ok"] = (r["tf_ok"] and r["launches_ok"] and lay.seq
               and r["stats_launches"] > 0 and r["one_terminal_each"]
               and r["finished"] == SERVE_REP_REQUESTS)
    del gen, results, model, params, eng
    free()
    return r


@contextlib.contextmanager
def measuring_drops(out):
    """Appends (``decode_view_param_bytes``, the bytes the allocator got
    back) of every ``Engine.drop_decode_view`` call to ``out``."""
    import torch
    from realhf_tpu_torch.engine.engine import Engine
    real = Engine.drop_decode_view

    def measured(self):
        devs = list(dict.fromkeys(self.members))
        held = self.decode_view_param_bytes()
        gc.collect()
        sync_all()
        before = sum(torch.cuda.memory_allocated(d) for d in devs)
        real(self)
        gc.collect()
        sync_all()
        out.append((held, before - sum(torch.cuda.memory_allocated(d)
                                       for d in devs)))

    with patched(Engine, "drop_decode_view", measured):
        yield


def phase_serve_gen_view(smi, seed=1):
    """The ``gen`` experiment with ``use_inflight_batching`` (8 prompts of
    100-512 words, one batch, 8 slots, 64 greedy tokens) at LLaMA-7B
    width, ``SERVE_LAYERS`` layers, on a p2 engine through its default
    decode view (d2t1) and on a c4 engine through its g4 view (d1t4),
    with ``drop_decode_view_after_rollout``, members on
    ``member_devices``. Gates: every sequence's log-probs against one
    teacher-forced K1 forward of the d1t1 model with the same weights
    (``SERVE_LIMITS``), exact K1/K4 counts on the view's members, the
    generator holding no weights after the call, and the drop returning
    exactly ``decode_view_param_bytes`` to the allocator."""
    import numpy as np
    from realhf_tpu_torch.engine import inflight
    from realhf_tpu_torch.parallel.mesh import parse_parallelism
    from realhf_tpu_torch.system.inline import InlineRunner
    rec = dict(card=smi, n_layers=SERVE_LAYERS,
               new_tokens=SERVE_VIEW_NEW_TOKENS, cases={})
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "prompts.jsonl")
        write_prompts(data, 8, seed=seed)
        for layout in ("p2", "c4g4"):
            spec, vocab = build_gen_spec(data, SERVE_LAYERS,
                                         SERVE_VIEW_NEW_TOKENS, 1, seed=seed)
            par = parse_parallelism(layout)
            mspec = spec.models["default"]
            mspec.parallel = par
            mspec.drop_decode_view_after_rollout = True
            spec.mfcs[0].interface_impl.args.update(
                use_inflight_batching=True)
            runner = InlineRunner(spec, role_devices={
                "default": member_devices(par.world_size)})
            eng = runner.models["default"].engine
            seen, drops = [], []
            real = inflight.InflightBatchingGenerator.generate_all

            def watched(self, prompts, generator=None):
                out = real(self, prompts, generator)
                seen.append((self, [np.asarray(p) for p in prompts], out))
                return out

            sync_all()
            reset_counts()
            t0 = time.monotonic()
            with patched(inflight.InflightBatchingGenerator, "generate_all",
                         watched), measuring_drops(drops):
                runner.run()
            sync_all()
            secs = time.monotonic() - t0
            counts = read_counts()
            gen, prompts, fins = seen[0]
            lay = gen._lay
            want = launches_of(SERVE_LAYERS, 1,
                               fwd=lay.t * gen.counts["full_prefills"],
                               decode=lay.d * lay.t
                               * gen.counts["decode_steps"])
            n_tok = sum(len(f.tokens) for f in fins)
            ref = eng.gathered_params()
            r = dict(layout=layout, view=f"d{lay.d}t{lay.t}", secs=secs,
                     generated_tokens=n_tok, tokens_per_s=n_tok / secs,
                     decode_steps=gen.counts["decode_steps"],
                     fills=gen.counts["full_prefills"], launches=counts,
                     launches_expected=want, launches_ok=counts == want,
                     outputs_in_range=check_gen_output(runner, vocab),
                     generator_holds_no_weights=gen.params is None,
                     drops=len(drops))
            r.update(tf_readings(eng.cfg, ref, [
                (p, f.tokens, f.logprobs) for p, f in zip(prompts, fins)]))
            r["view_param_bytes"], r["freed_bytes"] = drops[0] if drops \
                else (0, 0)
            r["drop_ok"] = (len(drops) == 1
                            and r["freed_bytes"] == r["view_param_bytes"] > 0)
            r["ok"] = (r["launches_ok"] and r["outputs_in_range"]
                       and tf_ok(r) and r["drop_ok"]
                       and r["generator_holds_no_weights"] and len(fins) == 8
                       and all(len(f.tokens) == SERVE_VIEW_NEW_TOKENS
                               for f in fins))
            rec["cases"][layout] = r
            print(f"serve_gen_view {layout}: " + json.dumps({k: r[k] for k in (
                "view", "tokens_per_s", "tf_logprob_max_abs", "launches",
                "view_param_bytes", "freed_bytes", "ok")}) + f" ({smi})",
                flush=True)
            del runner, eng, seen, gen, ref
            free()
    rec["ok"] = all(r["ok"] for r in rec["cases"].values())
    return rec


# ----------------------------------------------------------------------
# ----------------------------------------------------------------------
# phases 26-29: mixture of experts at Mixtral-8x7B width, and the sliding
# window at Mistral-7B
# ----------------------------------------------------------------------
#: the published configurations (each repository's ``config.json`` on the
#: Hugging Face hub, typed in: nothing is downloaded)
MIXTRAL_8X7B = dict(  # mistralai/Mixtral-8x7B-v0.1
    model_type="mixtral", hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    num_local_experts=8, num_experts_per_tok=2, router_aux_loss_coef=0.02,
    vocab_size=32000, rope_theta=1e6, rms_norm_eps=1e-5,
    sliding_window=None, max_position_embeddings=32768,
    tie_word_embeddings=False)
MISTRAL_7B = dict(  # mistralai/Mistral-7B-v0.1
    model_type="mistral", hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    vocab_size=32000, rope_theta=10000.0, rms_norm_eps=1e-5,
    sliding_window=4096, max_position_embeddings=32768,
    tie_word_embeddings=False)
#: depth cuts: all 32 Mixtral layers are 46.7 B parameters (93 GB in
#: bf16), more than one card holds. The train cell holds bf16 weights,
#: fp32 masters, both moments and the fp32 gradient sums: 2 layers (3.2 B
#: parameters) ran out of the card's 80 GB in the optimizer step, so 1
MIXTRAL_GEN_LAYERS = 16
MIXTRAL_SFT_LAYERS = 1
MIXTRAL_NEW_TOKENS = 128
MISTRAL_NEW_TOKENS = 64
MISTRAL_LONG_PROMPTS = (5600, 5200)  # words: past the 4096 window
# about 3x the largest sound reading of seeds 1-5, each with its planted
# faults above it (scripts/torch_moe_phases.py --seeds 1 2 3 4 5 on an
# H100 80GB HBM3 at 700 W; sound range, then the faults):
#   gen_tf_logprob_mean_abs  mixtral_gen mean gap 0.519-0.607 (max
#                            6.20-6.88); gates unnormalised 3.39-3.51,
#                            second expert dropped 4.12-4.25
#   parity_logits_rel        logits at the CPU's routing 0.0078-0.0094
#                            (at the card's own routing 0.40-0.62)
#   parity_loss_rel          7.5e-6-6.0e-4
#   parity_aux_rel           8.7e-6-2.9e-3
#   parity_min_cos           0.977-0.986; router gradient zeroed 0.0
#   parity_router_margin     CPU margin at the moved routings <= 0.253
#   parity_routing_moved     2-11 of 520 routings
#   mistral_tf_logprob_abs   gap max 0.191-0.227; no window 4.42-5.51
#   mistral_tf_logprob_mean_abs  long prompts' mean 0.037-0.042; no
#                            window 1.68-2.19
#   mistral_fp32_logits_rel  0.037-0.043; no window 0.73-0.93
# mixtral_gen gates the mean gap alone: 14-16% of the (token, layer)
# routings of random weights flip between the decode and teacher-forced
# passes under bf16 noise, and a flipped token's log-prob moves by up to
# 6-7 in sound runs, as far as under the planted faults; the mean tells
# them apart.
MOE_LIMITS = dict(gen_tf_logprob_mean_abs=1.8,
                  parity_logits_rel=0.03, parity_loss_rel=1.8e-3,
                  parity_aux_rel=9e-3, parity_min_cos=0.93,
                  parity_router_margin=0.76, parity_routing_moved=33,
                  mistral_tf_logprob_abs=0.68,
                  mistral_tf_logprob_mean_abs=0.13,
                  mistral_fp32_logits_rel=0.13)


def hf_random_init_config(family, hf, n_layers):
    """``random_init_config`` of a published config through the port's
    own converter (``models/hf``), cut to ``n_layers``."""
    from realhf_tpu_torch.models.hf import registry
    depth = "n_layer" if "n_layer" in hf else "num_hidden_layers"
    cfg = registry.config_from_hf(family, dict(hf, **{depth: n_layers}))
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "is_critic"}


def write_prompts_of(path, lengths, seed):
    """One prompt of each of ``lengths`` words."""
    import numpy as np
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i, n in enumerate(lengths):
            words = rng.integers(0, 5000, size=int(n))
            f.write(json.dumps({"id": i, "prompt": " ".join(
                f"w{int(w)}" for w in words)}) + "\n")


def _host(a):
    import numpy as np
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


@contextlib.contextmanager
def watching_generate(seen):
    """Keeps (prompt ids, prompt seg, host output) of every
    ``Engine.generate`` call: the gen interface returns no log-probs."""
    from realhf_tpu_torch.engine.engine import Engine
    real = Engine.generate

    def watched(self, prompt_ids, prompt_seg, *args, **kw):
        out = real(self, prompt_ids, prompt_seg, *args, **kw)
        seen.append((_host(prompt_ids), _host(prompt_seg), out.to_host()))
        return out

    with patched(Engine, "generate", watched):
        yield


@contextlib.contextmanager
def recording_routes(calls):
    """Appends (top-k indices, router logits) of every MoE layer call to
    ``calls``, on the device (no host read added)."""
    from realhf_tpu_torch.ops import moe
    real = moe.router_probs

    def rec(cfg_moe, logits):
        probs, idx = real(cfg_moe, logits)
        calls.append((idx.detach().clone(), logits.detach().clone()))
        return probs, idx

    with patched(moe, "router_probs", rec):
        yield


@contextlib.contextmanager
def replaying_routes(routes):
    """Makes each MoE layer call take the top-k experts of the next of
    ``routes`` (recorded (indices, logits) pairs, in call order), with
    its gates from its own logits as the default routing computes them
    for those experts."""
    import torch
    from realhf_tpu_torch.ops import moe
    recorded = iter(routes)

    def replay(cfg_moe, logits):
        idx = next(recorded)[0].to(logits.device)
        probs = torch.softmax(logits.float(), -1).gather(-1, idx)
        return probs / probs.sum(-1, keepdim=True).clamp_min(1e-9), idx

    with patched(moe, "router_probs", replay):
        yield


@contextlib.contextmanager
def moe_fault(kind):
    """A planted routing fault: ``"unnormalised"`` top-k gates (the
    softmax's probabilities as they are), or ``"second_dropped"`` (the
    second expert's gate set to 0)."""
    import torch
    from realhf_tpu_torch.ops import moe
    real = moe.router_probs

    def faulty(cfg_moe, logits):
        probs, idx = real(cfg_moe, logits)
        if kind == "unnormalised":
            full = torch.softmax(logits.float(), -1)
            return torch.gather(full, -1, idx), idx
        return torch.cat([probs[:, :1], torch.zeros_like(probs[:, 1:])],
                         -1), idx

    with patched(moe, "router_probs", faulty):
        yield


def sequences_of(seen, upto=None):
    """(prompt, generated tokens, their log-probs) per stream of each
    watched generate call."""
    out = []
    for ids, seg, gout in seen[:upto]:
        for b in range(ids.shape[0]):
            p = ids[b][seg[b] != 0]
            n = int(gout.lengths[b])
            out.append((p, gout.tokens[b, :n], gout.logprobs[b, :n]))
    return out


def packed_teacher_forced(cfg, params, items):
    """One packed forward (K1) of every (prompt, tokens, ...) item but
    its last token, each a segment of one stream: each token's log-prob
    at the position that emitted it, per item, and the stream offset of
    each item. ``params`` is a tree or a sharded engine's
    ``MemberParams``."""
    import numpy as np
    import torch
    from realhf_tpu_torch.models import transformer as T
    from realhf_tpu_torch.models.sharding import MemberParams
    seqs = [np.concatenate([p, t])[:-1] for p, t, *_ in items]
    offs = np.cumsum([0] + [len(x) for x in seqs])
    members = isinstance(params, MemberParams)
    dev = params.devices[0] if members else params["embed"]["wte"].device
    ids = torch.as_tensor(np.concatenate(seqs).astype(np.int64),
                          device=dev)[None]
    seg = torch.as_tensor(np.concatenate(
        [np.full(len(x), i + 1, np.int32) for i, x in enumerate(seqs)]),
        device=dev)[None]
    with torch.no_grad():
        hidden, _ = T.forward(cfg, params, ids, seg)
        out = []
        for (p, t, *_), off in zip(items, offs):
            at = slice(off + len(p) - 1, off + len(p) - 1 + len(t))
            rows = (hidden.map(lambda h, at=at: h[0, at]) if members
                    else hidden[0, at])
            lg = T.lm_logits(cfg, params, rows)
            tok = torch.as_tensor(np.asarray(t, np.int64), device=dev)
            out.append(torch.log_softmax(lg, -1).gather(
                -1, tok[:, None])[:, 0].cpu().numpy())
    return out, offs


def tf_gaps(lps, items, pick=None):
    """Max and mean |teacher-forced - generated log-prob| over the items
    (all, or those ``pick`` names)."""
    import numpy as np
    d = [np.abs(lp - it[2]) for i, (lp, it) in enumerate(zip(lps, items))
         if pick is None or i in pick]
    d = np.concatenate(d)
    return dict(max_abs=float(d.max()), mean_abs=float(d.mean()),
                tokens=int(d.size))


def phase_mixtral_gen(smi, seed=1, keep=None):
    """The gen experiment at Mixtral-8x7B width, 16 of its 32 layers
    (bf16, random weights from ``seed``): 8 prompts of 100-512 words, 128
    new tokens, one greedy step and one sampled step. Gates: exact K1/K4
    counts, tokens in range, the greedy step's log-probs against one
    packed teacher-forced forward (the mean gap), which the planted
    faults (top-k gates left unnormalised; the second expert's output
    dropped) must exceed. Readings: the share of (token, layer) routings
    whose top-2 differ between decode and the teacher-forced pass, the
    tokens each expert of layers 0 and 15 took there, the group-size host
    reads a decode step, times and the peak. With ``keep`` (a dict), the
    engine and the greedy step's items stay there for moe_tp."""
    import numpy as np
    import torch
    from realhf_tpu_torch.ops import moe
    from realhf_tpu_torch.ops.sampling import GenerationHyperparameters
    from realhf_tpu_torch.system.inline import InlineRunner
    nl = MIXTRAL_GEN_LAYERS
    mcfg = hf_random_init_config("mixtral", MIXTRAL_8X7B, nl)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "prompts.jsonl")
        write_prompts(data, 8, seed=seed)
        spec, vocab = build_gen_spec(data, nl, MIXTRAL_NEW_TOKENS, 1,
                                     model_config=mcfg, seed=seed)
        t0 = time.monotonic()
        runner = InlineRunner(spec)  # the card
        torch.cuda.synchronize()
        setup = time.monotonic() - t0
    eng = runner.models["default"].engine
    seen, routes = [], []
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    moe.host_reads = 0
    with watching_generate(seen), recording_routes(routes):
        runner.run()
    greedy_reads = moe.host_reads
    outputs_ok = check_gen_output(runner, vocab)
    runner.interfaces["gen"].gconfig = GenerationHyperparameters(
        max_new_tokens=MIXTRAL_NEW_TOKENS, greedy=False, top_k=50,
        top_p=0.9, force_no_logits_mask=True)
    with watching_generate(seen):
        runner.run()
    outputs_ok &= check_gen_output(runner, vocab)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    stats = eng.generate_stats
    n_decode = sum(st["decode_steps"] for st in stats)
    want = dict(flash_fwd=nl * len(stats), flash_bwd_dq=0, flash_bwd_dkv=0,
                flash_decode=nl * n_decode, flash_decode_stacked=0,
                ring_round=0, ring_push=0, **NO_RING_BWD)
    items = sequences_of(seen, 1)
    tf_routes = []
    with recording_routes(tf_routes):
        lps, offs = packed_teacher_forced(eng.cfg, eng.params, items)
    rec = dict(n_layers=nl, setup_secs=setup, card=smi, seed=seed,
               steps=[dict(step=lab, **step_summary(st, smi)) for lab, st
                      in zip(("greedy", "sampled_topk50_topp0.9"), stats)],
               launches=counts, launches_expected=want,
               launches_ok=counts == want, outputs_in_range=outputs_ok,
               peak_mem_gb=peak, limits=MOE_LIMITS)
    rec["tf"] = tf_gaps(lps, items)
    # decode step s of stream b fed token s at stream position p_b + s,
    # which the teacher-forced pass holds at offs[b] + p_b + s
    dec = routes[nl:nl * (1 + stats[0]["decode_steps"])]
    diff = total = 0
    for s in range(len(dec) // nl):
        for layer in range(nl):
            idx = dec[s * nl + layer][0].sort(-1).values.cpu().numpy()
            tf_idx = tf_routes[layer][0].sort(-1).values.cpu().numpy()
            for b, (p, t, _) in enumerate(items):
                if s < len(t) - 1:
                    total += 1
                    diff += not np.array_equal(
                        idx[b], tf_idx[offs[b] + len(p) + s])
    rec["routing_differs_share"] = diff / max(total, 1)
    rec["routed_token_layers"] = total
    rec["expert_tokens"] = {
        f"layer{layer}": np.bincount(
            tf_routes[layer][0].reshape(-1).cpu().numpy(),
            minlength=8).tolist() for layer in (0, nl - 1)}
    rec["host_reads_per_decode_step"] = (
        (greedy_reads - nl) / max(stats[0]["decode_steps"], 1))
    rec["host_reads_per_prefill"] = nl
    faults = {}
    for kind in ("unnormalised", "second_dropped"):
        with moe_fault(kind):
            bad, _ = packed_teacher_forced(eng.cfg, eng.params, items)
        faults[kind] = tf_gaps(bad, items)
    rec["planted_faults"] = faults
    lim = MOE_LIMITS
    rec["tf_ok"] = rec["tf"]["mean_abs"] <= lim["gen_tf_logprob_mean_abs"]
    rec["faults_fail"] = all(f["mean_abs"] > lim["gen_tf_logprob_mean_abs"]
                             for f in faults.values())
    rec["ok"] = (rec["launches_ok"] and outputs_ok and rec["tf_ok"]
                 and rec["faults_fail"] and len(stats) == 2)
    if keep is not None:
        keep.update(engine=eng, items=items)
    del runner, eng, routes, tf_routes
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def expert_slices(name, g, n_layers, n_experts):
    """A leaf's gradient as rows to judge one by one: one per (layer,
    expert) for the expert weights, one per layer for the other block
    leaves, the whole leaf otherwise."""
    if name in ("blocks.mlp.wg", "blocks.mlp.wu", "blocks.mlp.wd"):
        return g.reshape(n_layers * n_experts, -1)
    return grad_slices(name, g, n_layers)


def phase_mixtral_sft(smi):
    """The sft experiment at Mixtral-8x7B width, 2 layers, bf16, gradient
    checkpointing: 16 prompt-answer records in 2 microbatches, 3 steps,
    lr 1e-5, then eval. Gates: loss finite and falling; ``moe_aux_loss``
    on every step, finite and positive, and loss = nll + aux; step 1
    gives every layer's router and every expert's wg/wu/wd a finite
    non-zero gradient; exact K1/K2/K3 counts."""
    import torch
    from realhf_tpu_torch.interfaces import common
    from realhf_tpu_torch.system.inline import InlineRunner
    nl = MIXTRAL_SFT_LAYERS
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "sft.jsonl")
        write_prompt_answers(data, 16, seed=3)
        spec = build_sft_spec(data, nl, model_config=hf_random_init_config(
            "mixtral", MIXTRAL_8X7B, nl))
        t0 = time.monotonic()
        runner = InlineRunner(without_saves(spec))  # the card
        torch.cuda.synchronize()
        setup = time.monotonic() - t0
    eng = runner.models["default"].engine
    names = leaf_names(eng.params)
    seen = capture_first_grads(eng.optimizer)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    runner.run()
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del eng.optimizer.step
    steps = [st["trainDefault"] for st in runner.step_stats]
    losses = [st["loss"] for st in steps]
    aux = [st.get("moe_aux_loss", float("nan")) for st in steps]
    loss_ok = (len(losses) == 3 and all(math.isfinite(x) for x in losses)
               and all(b < a for a, b in zip(losses, losses[1:])))
    aux_ok = all(math.isfinite(a) and a > 0 for a in aux)
    sum_err = max(abs(st["loss"] - st["nll"] - st["moe_aux_loss"])
                  / abs(st["loss"]) for st in steps) if aux_ok else 1.0
    ne = eng.cfg.moe.num_experts
    grads = {}
    for name, g in zip(names, seen[0] if seen else []):
        rows = expert_slices(name, g, nl, ne).abs().amax(-1)
        grads[name] = dict(finite=bool(torch.isfinite(g).all()),
                           slices=int(rows.numel()),
                           min_slice_absmax=float(rows.min()))
    grads_ok = (len(grads) == len(names)
                and all(v["finite"] and v["min_slice_absmax"] > 0
                        for v in grads.values())
                and grads["blocks.mlp.wg"]["slices"] == nl * ne
                and "blocks.mlp.router" in grads)
    n_eval = len([ev for _, _, ev in runner.eval_stats])
    n_bwd = nl * 2 * 3
    want = dict(flash_fwd=2 * n_bwd + nl * len(runner.eval_dataloader)
                * n_eval, flash_bwd_dq=n_bwd, flash_bwd_dkv=n_bwd,
                flash_decode=0, flash_decode_stacked=0, ring_round=0,
                ring_push=0, **NO_RING_BWD)
    tokens = runner.last_batch.total_len("packed_input_ids")
    mb_tokens = [mb.total_len("packed_input_ids") for mb in
                 common.split_minibatches(runner.last_batch, 2)]
    total_gb = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    rec = dict(n_layers=nl, setup_secs=setup, card=smi,
               param_dtypes=sorted({str(t.dtype) for t in
                                    _tree_leaves(eng.params)}),
               n_params=sum(t.numel() for t in _tree_leaves(eng.params)),
               tokens_per_step=tokens, microbatch_tokens=mb_tokens,
               losses=losses, moe_aux_losses=aux,
               nlls=[st["nll"] for st in steps],
               loss_minus_nll_aux_rel=sum_err,
               grad_norms=[st["grad_norm"] for st in steps],
               step_secs=list(runner.step_secs),
               train_tokens_per_s=[tokens / t for t in runner.step_secs],
               peak_mem_gb=peak, free_at_peak_gb=total_gb - peak,
               launches=counts, launches_expected=want,
               launches_ok=counts == want, loss_strictly_falling=loss_ok,
               aux_ok=aux_ok, step1_grads_ok=grads_ok, step1_grads=grads)
    rec["ok"] = (loss_ok and aux_ok and sum_err <= 1e-6 and grads_ok
                 and rec["launches_ok"])
    del runner, eng, seen
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_mixtral_parity(seed=5):
    """Card (bf16, the kernels) against CPU (fp32, the plain versions)
    from the same bf16 weights at ``train_parity``'s shape with 8 experts
    top-2 (2 layers, hidden 1024, 8 q / 2 kv heads of 128, FFN 2816).
    The forward's routing: the (token, layer) pairs whose top-2 differ
    between the two sides are counted, and each must be a near tie (the
    CPU's margin between the second and third expert under a floor). The
    forward's logits with the card routed as the CPU routed
    (``replaying_routes``: a token whose experts flip takes other expert
    weights, and the later tokens of its sequence attend to it), every
    token gated; the logits of the card's own routing are reported. One
    SFT step's loss, aux loss, and the cosine of every (layer, expert)
    slice of every gradient leaf, every token counted; the router
    gradient zeroed must fail the cosine gate."""
    import numpy as np
    import torch
    from realhf_tpu_torch.base import seeding
    from realhf_tpu_torch.engine.engine import Engine
    from realhf_tpu_torch.engine.optim import OptimizerConfig
    from realhf_tpu_torch.interfaces import sft
    from realhf_tpu_torch.models import transformer as T
    from realhf_tpu_torch.models.config import TransformerConfig
    from realhf_tpu_torch.models.convert import params_from_numpy, params_numpy
    nl, ne = 2, 8
    base = dict(hf_random_init_config("mixtral", MIXTRAL_8X7B, nl),
                hidden_dim=1024, n_q_heads=8, n_kv_heads=2, head_dim=128,
                intermediate_dim=2816, gradient_checkpointing=True)
    # the card's side (bf16, the kernels) and the CPU's (fp32, plain)
    devs = dict(card="cuda", cpu="cpu")
    cfgs = {side: TransformerConfig(**dict(base, param_dtype=dt,
                                           compute_dtype=dt))
            for side, dt in (("card", "bfloat16"), ("cpu", "float32"))}
    weights = params_numpy(T.init_params(cfgs["card"],
                                         seeding.generator(seed), "cpu"))
    rng = np.random.default_rng(seed + 1)
    mbs, loss_w = sft_microbatches(rng, base["vocab_size"])
    # the forward of the first microbatch's stream: the CPU's, the
    # card's, and the card's again with the CPU's experts
    ids, seg = (torch.as_tensor(mbs[0][k]) for k in ("input_ids", "seg_ids"))
    logits, routes = {}, {}
    for run, side in (("cpu", "cpu"), ("card", "card"),
                      ("card_replayed", "card")):
        dev, cfg = devs[side], cfgs[side]
        p = params_from_numpy(weights, dev, torch.float32
                              if side == "cpu" else None)
        calls = []
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.no_grad())
            if run == "card_replayed":
                stack.enter_context(replaying_routes(routes["cpu"]))
            stack.enter_context(recording_routes(calls))
            h, _ = T.forward(cfg, p, ids.to(dev), seg.to(dev))
            logits[run] = T.lm_logits(cfg, p, h).float().cpu()
        routes[run] = [(i.cpu(), lg.cpu()) for i, lg in calls]
        del p, h
    valid = (seg != 0).reshape(-1)
    # (token, layer) routings whose top-2 set differs, card against CPU,
    # and the CPU's margin between the second and third expert there
    moved = torch.stack([(a[0].sort(-1).values != b[0].sort(-1).values)
                         .any(-1) for a, b in zip(routes["card"],
                                                  routes["cpu"])]) & valid
    top3 = torch.stack([lg.topk(3, -1).values for _, lg in routes["cpu"]])
    margin = top3[..., 1] - top3[..., 2]                   # [layers, T]
    router_err = max(float((a[1] - b[1]).abs().amax(-1)[
        valid & ~moved.any(0)].max()) for a, b in zip(routes["card"],
                                                      routes["cpu"]))
    lg_c, lg_g, lg_r = (logits[r].reshape(-1, logits[r].shape[-1])
                        for r in ("cpu", "card", "card_replayed"))
    scale = float(lg_c[valid].abs().max())
    logits_err = float((lg_r - lg_c).abs()[valid].max())
    logits_err_free = float((lg_g - lg_c).abs()[valid].max())
    # one SFT step
    opt = OptimizerConfig(lr=1e-4, lr_scheduler_type="constant",
                          warmup_steps_proportion=0.0)
    out, grads = {}, {}
    for side, cfg in cfgs.items():
        eng = Engine(cfg, weights, devs[side], optimizer=opt)
        seen = capture_first_grads(eng.optimizer)
        out[side] = eng.train_batch(mbs, sft._make_loss_fn(cfg), loss_w)
        grads[side] = seen[0]
        names = leaf_names(eng.params)
        del eng, seen
    torch.cuda.empty_cache()

    def cosines(got):
        cos = {}
        for name, a, b in zip(names, got, grads["cpu"]):
            a = expert_slices(name, a.double().cpu(), nl, ne)
            b = expert_slices(name, b.double(), nl, ne)
            den = (a.norm(dim=-1) * b.norm(dim=-1)).clamp_min(1e-30)
            cos[name] = ((a * b).sum(-1) / den).tolist()
        return cos

    cos = cosines(grads["card"])
    faulty = [g.clone() if n != "blocks.mlp.router" else torch.zeros_like(g)
              for n, g in zip(names, grads["card"])]
    fault_min = min(min(v) for v in cosines(faulty).values())

    def rel(k):
        return abs(out["card"][k] - out["cpu"][k]) / abs(out["cpu"][k])

    lim = MOE_LIMITS
    min_cos = min(min(v) for v in cos.values())
    rec = dict(layers=nl, experts=ne, hidden=base["hidden_dim"], seed=seed,
               tokens=int(valid.sum()), routing_moved=int(moved.sum()),
               moved_max_cpu_margin=float(margin[moved].max())
               if moved.any() else 0.0,
               router_logits_max_abs_err_unmoved=router_err,
               logits_max_abs_err=logits_err, logits_max_abs=scale,
               logits_rel_err=logits_err / scale,
               logits_rel_err_own_routing=logits_err_free / scale,
               step=out, loss_rel_err=rel("loss"),
               aux_rel_err=rel("moe_aux_loss"),
               grad_norm_rel_err=rel("grad_norm"), min_cos=min_cos,
               cos={k: min(v) for k, v in cos.items()}, limits=lim,
               planted_fault="router gradient zeroed",
               planted_fault_min_cos=fault_min)
    rec["ok"] = (rec["logits_rel_err"] <= lim["parity_logits_rel"]
                 and rec["routing_moved"] <= lim["parity_routing_moved"]
                 and rec["moved_max_cpu_margin"]
                 <= lim["parity_router_margin"]
                 and rec["loss_rel_err"] <= lim["parity_loss_rel"]
                 and rec["aux_rel_err"] <= lim["parity_aux_rel"]
                 and min_cos >= lim["parity_min_cos"]
                 and fault_min < lim["parity_min_cos"])
    return rec


@contextlib.contextmanager
def watching_windows(seen):
    """Records the window of every K1 and K4 launch (the port's kernel
    wrappers, called through ``ops/attention.py``)."""
    from realhf_tpu_torch.ops import decode_attention as da
    from realhf_tpu_torch.ops import flash_attention as fa
    real_fwd, real_dec = fa.flash_attention, da.flash_decode_attention

    def fwd(*a, window=None, **kw):
        if a[0].is_cuda:
            seen.add(("flash_fwd", window))
        return real_fwd(*a, window=window, **kw)

    def dec(*a, sliding_window=None, **kw):
        seen.add(("flash_decode", sliding_window))
        return real_dec(*a, sliding_window=sliding_window, **kw)

    with patched(fa, "flash_attention", fwd), \
            patched(da, "flash_decode_attention", dec):
        yield


def phase_mistral(smi, seed=1):
    """The gen experiment at Mistral-7B-v0.1, full width and depth (32
    layers, bf16, random weights from ``seed``; window 4096): 8 prompts,
    two of 5200-5600 words, 64 greedy tokens. Gates: K1 = 32 a prefill
    and K4 = 32 a decode step, every launch with the window; the
    generated log-probs against a packed teacher-forced windowed forward
    (all streams: max; the long prompts' tokens: mean), which the same
    pass without the window must exceed; the long prompts' last-position
    logits against the same weights in fp32 through
    ``packed_attention_plain`` over the same window."""
    import numpy as np
    import torch
    from realhf_tpu_torch.models import transformer as T
    from realhf_tpu_torch.ops.attention import packed_attention_plain
    from realhf_tpu_torch.system.inline import InlineRunner
    nl = 32
    mcfg = hf_random_init_config("mistral", MISTRAL_7B, nl)
    rng = np.random.default_rng(seed)
    lengths = [*MISTRAL_LONG_PROMPTS,
               *(int(x) for x in rng.integers(100, 513, size=6))]
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "prompts.jsonl")
        write_prompts_of(data, lengths, seed)
        spec, vocab = build_gen_spec(data, nl, MISTRAL_NEW_TOKENS, 1,
                                     model_config=mcfg, max_seqlen=6144,
                                     seed=seed)
        t0 = time.monotonic()
        runner = InlineRunner(spec)  # the card
        torch.cuda.synchronize()
        setup = time.monotonic() - t0
    eng = runner.models["default"].engine
    seen, windows = [], set()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with watching_generate(seen), watching_windows(windows):
        runner.run()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    st = eng.generate_stats[0]
    want = dict(flash_fwd=nl, flash_bwd_dq=0, flash_bwd_dkv=0,
                flash_decode=nl * st["decode_steps"], flash_decode_stacked=0,
                ring_round=0, ring_push=0, **NO_RING_BWD)
    items = sequences_of(seen)
    long_ = {i for i, (p, *_) in enumerate(items)
             if len(p) > eng.cfg.sliding_window}
    cfg = eng.cfg
    lps, _ = packed_teacher_forced(cfg, eng.params, items)
    rec = dict(n_layers=nl, setup_secs=setup, card=smi, seed=seed,
               window=cfg.sliding_window, prompt_lens=[len(p) for p, *_ in
                                                       items],
               step=step_summary(st, smi), launches=counts,
               launches_expected=want, launches_ok=counts == want,
               kernel_windows=sorted(f"{k}:{w}" for k, w in windows),
               outputs_in_range=check_gen_output(runner, vocab),
               peak_mem_gb=peak, limits=MOE_LIMITS)
    w = cfg.sliding_window
    rec["windows_ok"] = windows == {("flash_fwd", w), ("flash_decode", w)}
    rec["tf"] = tf_gaps(lps, items)
    rec["tf_long"] = tf_gaps(lps, items, long_)
    nowin = dataclasses.replace(cfg, sliding_window=None)
    bad, _ = packed_teacher_forced(nowin, eng.params, items)
    rec["planted_fault"] = "teacher-forced pass without the window"
    rec["planted_fault_tf"] = tf_gaps(bad, items)
    rec["planted_fault_tf_long"] = tf_gaps(bad, items, long_)
    # the long prompts' last-position logits: the card's bf16 path (K1)
    # against the same weights in fp32 through the plain attention
    p32 = _tree_map(lambda t: t.float(), eng.params)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    errs, fault_errs = [], []
    dev = eng.params["embed"]["wte"].device
    for i in sorted(long_):
        p = items[i][0]
        ids = torch.as_tensor(p.astype(np.int64), device=dev)[None]
        seg = torch.ones_like(ids, dtype=torch.int32)
        with torch.no_grad():
            got = T.lm_logits(cfg, eng.params, T.forward(
                cfg, eng.params, ids, seg)[0][0, -1])
            for c, sink in ((cfg32, errs), (dataclasses.replace(
                    cfg32, sliding_window=None), fault_errs)):
                want_lg = T.lm_logits(c, p32, T.forward(
                    c, p32, ids, seg,
                    attention_fn=packed_attention_plain)[0][0, -1])
                sink.append(float((got - want_lg).abs().max()
                                  / want_lg.abs().max()))
                torch.cuda.empty_cache()
    del p32
    rec["fp32_logits_rel_err"] = max(errs)
    rec["fp32_logits_rel_err_without_window"] = max(fault_errs)
    lim = MOE_LIMITS
    rec["tf_ok"] = (rec["tf"]["max_abs"] <= lim["mistral_tf_logprob_abs"]
                    and rec["tf_long"]["mean_abs"]
                    <= lim["mistral_tf_logprob_mean_abs"])
    rec["fault_fails"] = (
        rec["planted_fault_tf_long"]["mean_abs"]
        > lim["mistral_tf_logprob_mean_abs"]
        and rec["planted_fault_tf"]["max_abs"] > lim["mistral_tf_logprob_abs"]
        and rec["fp32_logits_rel_err_without_window"]
        > lim["mistral_fp32_logits_rel"])
    rec["ok"] = (rec["launches_ok"] and rec["windows_ok"]
                 and rec["outputs_in_range"] and rec["tf_ok"]
                 and rec["fault_fails"]
                 and rec["fp32_logits_rel_err"]
                 <= lim["mistral_fp32_logits_rel"])
    del runner, eng
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def run_moe_phases(smi):
    """phases 26-29, with moe_tp (43) and moe_pp (48) right after
    mixtral_gen on its engine, each freeing its models before the
    next"""
    recs, kept = {}, {}
    for name, fn in (("mixtral_gen", lambda s: phase_mixtral_gen(
                         s, keep=kept)),
                     ("moe_tp", lambda s: phase_moe_tp(
                         s, kept["engine"], kept["items"])),
                     ("moe_pp", lambda s: phase_moe_pp(
                         s, kept.pop("engine"), kept.pop("items"))),
                     ("mixtral_sft", phase_mixtral_sft),
                     ("mixtral_parity", lambda _smi: phase_mixtral_parity()),
                     ("mistral", phase_mistral)):
        t0 = time.monotonic()
        recs[name] = fn(smi)
        recs[name]["phase_secs"] = time.monotonic() - t0
        free()
        emit(name, **recs[name])
    return recs


# ----------------------------------------------------------------------
# phases 30-33: head dim 256 at Gemma-7B (generating) and Gemma-2B
# (training), and GPT-2 XL generating
# ----------------------------------------------------------------------
#: the published configurations (each repository's ``config.json`` on the
#: Hugging Face hub, typed in: nothing is downloaded)
GEMMA_7B = dict(  # google/gemma-7b
    model_type="gemma", hidden_size=3072, intermediate_size=24576,
    num_hidden_layers=28, num_attention_heads=16, num_key_value_heads=16,
    head_dim=256, vocab_size=256000, max_position_embeddings=8192,
    rms_norm_eps=1e-6, rope_theta=10000.0, hidden_act="gelu",
    hidden_activation="gelu_pytorch_tanh", attention_bias=False,
    tie_word_embeddings=True)
GEMMA_2B = dict(  # google/gemma-2b
    model_type="gemma", hidden_size=2048, intermediate_size=16384,
    num_hidden_layers=18, num_attention_heads=8, num_key_value_heads=1,
    head_dim=256, vocab_size=256000, max_position_embeddings=8192,
    rms_norm_eps=1e-6, rope_theta=10000.0, hidden_act="gelu",
    hidden_activation="gelu_pytorch_tanh", attention_bias=False,
    tie_word_embeddings=True)
GPT2_XL = dict(  # openai-community/gpt2-xl
    model_type="gpt2", n_layer=48, n_embd=1600, n_head=25, n_positions=1024,
    n_ctx=1024, vocab_size=50257, activation_function="gelu_new",
    layer_norm_epsilon=1e-5, tie_word_embeddings=True)
GEMMA_NEW_TOKENS = 128
# about 3x the largest sound reading of seeds 1-5 (for the cosine, 3x
# the largest 1 - cos), each with its planted faults above it (PERF.md,
# Findings; scripts/torch_gemma_phases.py --seeds): teacher-forced gaps
# 0.080-0.220 (Gemma-7B) and 0.044-0.066 (GPT-2 XL), faults 0.96-26.5
# and 1.45-2.28; parity logits 1.6e-3-2.4e-3, loss 7.2e-5-1.3e-4, grad
# norm 7.9e-4-8.5e-4, min cos 0.999869-0.999878, wk zeroed 0.0
GEMMA_LIMITS = dict(gemma_tf_logprob_abs=0.66, gpt2_tf_logprob_abs=0.2,
                    parity_logits_rel=7.5e-3, parity_decode_logits_rel=6e-3,
                    parity_loss_rel=4e-4, parity_grad_norm_rel=2.6e-3,
                    parity_min_cos=0.9996)


def tf_gen_phase(smi, family, hf, n_layers, faults, seed):
    """The gen experiment at a published config's full width (``hf``
    through the port's converter, ``n_layers`` deep, bf16, random
    weights from ``seed``): gen-7b-b8's traffic (8 prompts of 100-512
    words, 128 new tokens), one greedy and one sampled batch. Gates:
    exact K1/K4 counts (K1 = layers a prefill, K4 = layers a decode
    step), tokens in range, and the greedy batch's log-probs against one
    packed teacher-forced K1 forward, which each of ``faults`` (name ->
    a config that drops one feature of the architecture) must exceed.
    Returns the record and the limit's key."""
    import torch
    from realhf_tpu_torch.ops.sampling import GenerationHyperparameters
    from realhf_tpu_torch.system.inline import InlineRunner
    mcfg = hf_random_init_config(family, hf, n_layers)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "prompts.jsonl")
        write_prompts(data, 8, seed=seed)
        spec, vocab = build_gen_spec(data, n_layers, GEMMA_NEW_TOKENS, 1,
                                     model_config=mcfg, seed=seed)
        t0 = time.monotonic()
        runner = InlineRunner(spec)  # the card
        torch.cuda.synchronize()
        setup = time.monotonic() - t0
    eng = runner.models["default"].engine
    seen = []
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with watching_generate(seen):
        runner.run()
        outputs_ok = check_gen_output(runner, vocab)
        runner.interfaces["gen"].gconfig = GenerationHyperparameters(
            max_new_tokens=GEMMA_NEW_TOKENS, greedy=False, top_k=50,
            top_p=0.9, force_no_logits_mask=True)
        runner.run()
        outputs_ok &= check_gen_output(runner, vocab)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    stats = eng.generate_stats
    n_decode = sum(st["decode_steps"] for st in stats)
    want = dict(flash_fwd=n_layers * len(stats), flash_bwd_dq=0,
                flash_bwd_dkv=0, flash_decode=n_layers * n_decode,
                flash_decode_stacked=0, ring_round=0,
                ring_push=0, **NO_RING_BWD)
    cfg = eng.cfg
    items = sequences_of(seen, 1)
    lps, _ = packed_teacher_forced(cfg, eng.params, items)
    rec = dict(n_layers=n_layers, setup_secs=setup, card=smi, seed=seed,
               head_dim=cfg.head_dim, heads=[cfg.n_q_heads, cfg.n_kv_heads],
               n_params=sum(t.numel() for t in _tree_leaves(eng.params)),
               steps=[dict(step=lab, **step_summary(st, smi)) for lab, st
                      in zip(("greedy", "sampled_topk50_topp0.9"), stats)],
               launches=counts, launches_expected=want,
               launches_ok=counts == want, outputs_in_range=outputs_ok,
               peak_mem_gb=peak, tf=tf_gaps(lps, items), limits=GEMMA_LIMITS)
    rec["planted_faults"] = {
        name: tf_gaps(packed_teacher_forced(
            dataclasses.replace(cfg, **change), eng.params, items)[0], items)
        for name, change in faults.items()}
    key = f"{family}_tf_logprob_abs"
    rec["tf_ok"] = rec["tf"]["max_abs"] <= GEMMA_LIMITS[key]
    rec["faults_fail"] = all(f["max_abs"] > GEMMA_LIMITS[key]
                             for f in rec["planted_faults"].values())
    rec["ok"] = (rec["launches_ok"] and outputs_ok and rec["tf_ok"]
                 and rec["faults_fail"] and len(stats) == 2)
    del runner, eng
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_gemma_gen(smi, seed=1):
    """``google/gemma-7b`` at full width and depth (28 layers, 16 heads of
    256, tied 256000-word head): K1 and K4 at hd 256. Planted faults: the
    teacher-forced pass with the (1 + w) of gemma's RMSNorm dropped, and
    with the embeddings not scaled by sqrt(hidden)."""
    return tf_gen_phase(smi, "gemma", GEMMA_7B, 28, dict(
        norm_without_one_plus_w=dict(layer_norm_type="rms"),
        embed_not_normalized=dict(normalize_embed=False)), seed)


def phase_gpt2_gen(smi, seed=1):
    """``openai-community/gpt2-xl`` at full width and depth (48 layers, 25
    heads of 64, LayerNorm with biases, absolute positions, tied head):
    K1 and K4 at hd 64, the per-layer decode (48 is the deepest model
    that does not take the stacked cache). Planted fault: the
    teacher-forced pass reading the position table one row later."""
    return tf_gen_phase(smi, "gpt2", GPT2_XL, 48, dict(
        positions_shifted=dict(abs_position_embedding_offset=1)), seed)


def phase_gemma_sft(smi):
    """The sft experiment at ``google/gemma-2b``, full width and depth (18
    layers, 8 q heads on 1 KV head of 256), bf16, gradient checkpointing:
    16 prompt-answer records a step in the sft cell's 2 microbatches, 3
    epochs, lr 1e-5, then eval. The 256000-word vocabulary makes a
    microbatch's fp32 logits 1 GB a 1000 tokens a copy, but the step's
    peak is the optimizer's: 60.4 GB at 2 microbatches and at 4, 18.8 GB
    free (H100 80GB HBM3, 700 W). Gates: loss finite and falling, every layer slice
    of every leaf with a finite non-zero step-1 gradient, exact K1/K2/K3
    counts (K3 sums the group of 8 q heads). Step seconds, tokens/s,
    peak and the memory left free at it."""
    import torch
    from realhf_tpu_torch.interfaces import common
    from realhf_tpu_torch.system.inline import InlineRunner
    nl = GEMMA_2B["num_hidden_layers"]
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "sft.jsonl")
        write_prompt_answers(data, 16, seed=3)
        spec = build_sft_spec(data, nl, model_config=hf_random_init_config(
            "gemma", GEMMA_2B, nl))
        t0 = time.monotonic()
        runner = InlineRunner(without_saves(spec))  # the card
        torch.cuda.synchronize()
        setup = time.monotonic() - t0
    eng = runner.models["default"].engine
    names = leaf_names(eng.params)
    seen = capture_first_grads(eng.optimizer)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    runner.run()
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del eng.optimizer.step
    steps = [st["trainDefault"] for st in runner.step_stats]
    losses = [st["loss"] for st in steps]
    loss_ok = (len(losses) == 3 and all(math.isfinite(x) for x in losses)
               and all(b < a for a, b in zip(losses, losses[1:])))
    grads = {}
    for name, g in zip(names, seen[0] if seen else []):
        rows = grad_slices(name, g, nl).abs().amax(-1)
        grads[name] = dict(finite=bool(torch.isfinite(g).all()),
                           min_slice_absmax=float(rows.min()))
    grads_ok = (len(grads) == len(names)
                and all(v["finite"] and v["min_slice_absmax"] > 0
                        for v in grads.values()))
    evals = [ev for _, _, ev in runner.eval_stats]
    n_mbs = 2
    n_bwd = nl * n_mbs * 3
    want = dict(flash_fwd=2 * n_bwd + nl * len(runner.eval_dataloader)
                * len(evals), flash_bwd_dq=n_bwd, flash_bwd_dkv=n_bwd,
                flash_decode=0, flash_decode_stacked=0, ring_round=0,
                ring_push=0, **NO_RING_BWD)
    tokens = runner.last_batch.total_len("packed_input_ids")
    mb_tokens = [mb.total_len("packed_input_ids") for mb in
                 common.split_minibatches(runner.last_batch, n_mbs)]
    total_gb = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    rec = dict(n_layers=nl, n_mbs=n_mbs, setup_secs=setup, card=smi,
               n_params=sum(t.numel() for t in _tree_leaves(eng.params)),
               tokens_per_step=tokens, microbatch_tokens=mb_tokens,
               losses=losses, grad_norms=[st["grad_norm"] for st in steps],
               step_secs=list(runner.step_secs),
               train_tokens_per_s=[tokens / t for t in runner.step_secs],
               peak_mem_gb=peak, free_at_peak_gb=total_gb - peak,
               evals=evals, launches=counts, launches_expected=want,
               launches_ok=counts == want, loss_strictly_falling=loss_ok,
               step1_grads_ok=grads_ok, step1_grads=grads)
    rec["eval_ok"] = len(evals) == 1 and math.isfinite(evals[0]["loss"])
    rec["ok"] = (loss_ok and grads_ok and rec["launches_ok"]
                 and rec["eval_ok"])
    del runner, eng, seen
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_gemma_parity(seed=1):
    """Card (bf16, the kernels at hd 256) against CPU (fp32, the plain
    versions) from the same bf16 weights, at Gemma-2B's architecture cut
    to 2 layers, hidden 1024, 4 q / 1 kv heads of 256, FFN 4096, vocab
    32000: the packed forward's logits (the first SFT microbatch's
    stream), the logits of a prefill and of one decode step after it (two
    left-padded prompts), one SFT step's loss and grad norm (two
    microbatches, lr 1e-4), and the cosine of every layer slice of every
    gradient leaf; the card's gradients with wk zeroed must fail the
    cosine gate."""
    import numpy as np
    import torch
    from realhf_tpu_torch.base import seeding
    from realhf_tpu_torch.engine import packing
    from realhf_tpu_torch.engine.engine import Engine
    from realhf_tpu_torch.engine.optim import OptimizerConfig
    from realhf_tpu_torch.interfaces import sft
    from realhf_tpu_torch.models import transformer as T
    from realhf_tpu_torch.models.config import TransformerConfig
    from realhf_tpu_torch.models.convert import params_from_numpy, params_numpy
    nl = 2
    base = dict(hf_random_init_config("gemma", GEMMA_2B, nl),
                hidden_dim=1024, n_q_heads=4, n_kv_heads=1, head_dim=256,
                intermediate_dim=4096, vocab_size=32000,
                gradient_checkpointing=True)
    devs = dict(card="cuda", cpu="cpu")
    cfgs = {side: TransformerConfig(**dict(base, param_dtype=dt,
                                           compute_dtype=dt))
            for side, dt in (("card", "bfloat16"), ("cpu", "float32"))}
    weights = params_numpy(T.init_params(cfgs["card"],
                                         seeding.generator(seed), "cpu"))
    rng = np.random.default_rng(seed + 1)
    mbs, loss_w = sft_microbatches(rng, base["vocab_size"])
    prompts = [rng.integers(2, base["vocab_size"], size=n).astype(np.int32)
               for n in (100, 37)]
    pids, pseg, ppos = packing.left_padded_prompts(prompts, pad_id=0)
    token = rng.integers(2, base["vocab_size"], size=2).astype(np.int32)
    before = read_counts()
    logits = {}
    for side, cfg in cfgs.items():
        dev = devs[side]
        p = params_from_numpy(weights, dev, torch.float32
                              if side == "cpu" else None)
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        with torch.no_grad():
            h, _ = T.forward(cfg, p, t(mbs[0]["input_ids"]),
                             t(mbs[0]["seg_ids"]))
            stream = T.lm_logits(cfg, p, h).float().cpu()
            h, cache = T.prefill(cfg, p, t(pids), t(pseg), t(ppos),
                                 total_len=pids.shape[1] + 1)
            last = T.lm_logits(cfg, p, h[:, -1]).float().cpu()
            lens = t(pseg).sum(-1).to(torch.int32)
            h, _ = T.decode_step(cfg, p, cache, t(token), lens,
                                 uniform_slot=True)
            step = T.lm_logits(cfg, p, h).float().cpu()
        logits[side] = (stream, last, step)
        del p, h, cache
    launched = {k: v - before[k] for k, v in read_counts().items()}
    valid = torch.as_tensor(mbs[0]["seg_ids"] != 0)

    def rel(got, want, rows=None):
        d = (got - want).abs()
        if rows is not None:
            d, want = d[rows], want[rows]
        return float(d.max() / want.abs().max())

    stream_err = rel(logits["card"][0], logits["cpu"][0], valid)
    prefill_err = rel(logits["card"][1], logits["cpu"][1])
    decode_err = rel(logits["card"][2], logits["cpu"][2])
    opt = OptimizerConfig(lr=1e-4, lr_scheduler_type="constant",
                          warmup_steps_proportion=0.0)
    out, grads = {}, {}
    for side, cfg in cfgs.items():
        eng = Engine(cfg, weights, devs[side], optimizer=opt)
        seen = capture_first_grads(eng.optimizer)
        out[side] = eng.train_batch(mbs, sft._make_loss_fn(cfg), loss_w)
        grads[side] = seen[0]
        names = leaf_names(eng.params)
        del eng, seen
    torch.cuda.empty_cache()
    cos = grad_agreement(names, grads["card"], grads["cpu"], nl)
    faulty = [torch.zeros_like(g) if n == "blocks.attn.wk" else g
              for n, g in zip(names, grads["card"])]
    fault_min = min(min(v) for v in grad_agreement(
        names, faulty, grads["cpu"], nl).values())
    lim = GEMMA_LIMITS
    min_cos = min(min(v) for v in cos.values())

    def step_rel(k):
        return abs(out["card"][k] - out["cpu"][k]) / abs(out["cpu"][k])

    rec = dict(layers=nl, hidden=base["hidden_dim"], head_dim=256,
               heads=[4, 1], seed=seed,
               tokens=int(sum((m["seg_ids"] != 0).sum() for m in mbs)),
               launches=launched, stream_logits_rel_err=stream_err,
               prefill_logits_rel_err=prefill_err,
               decode_logits_rel_err=decode_err, step=out,
               loss_rel_err=step_rel("loss"),
               grad_norm_rel_err=step_rel("grad_norm"), min_cos=min_cos,
               cos={k: min(v) for k, v in cos.items()}, limits=lim,
               planted_fault="wk gradient zeroed",
               planted_fault_min_cos=fault_min)
    rec["launches_ok"] = (launched["flash_fwd"] == 2 * nl
                          and launched["flash_decode"] == nl)
    rec["ok"] = (rec["launches_ok"]
                 and max(stream_err, prefill_err) <= lim["parity_logits_rel"]
                 and decode_err <= lim["parity_decode_logits_rel"]
                 and rec["loss_rel_err"] <= lim["parity_loss_rel"]
                 and rec["grad_norm_rel_err"] <= lim["parity_grad_norm_rel"]
                 and min_cos >= lim["parity_min_cos"]
                 and fault_min < lim["parity_min_cos"])
    return rec


def run_gemma_phases(smi):
    """phases 30-33, each freeing its models before the next"""
    recs = {}
    for name, fn in (("gemma_gen", phase_gemma_gen),
                     ("gemma_sft", phase_gemma_sft),
                     ("gemma_parity", lambda _smi: phase_gemma_parity()),
                     ("gpt2_gen", phase_gpt2_gen)):
        t0 = time.monotonic()
        recs[name] = fn(smi)
        recs[name]["phase_secs"] = time.monotonic() - t0
        emit(name, **recs[name])
    return recs


# ----------------------------------------------------------------------
# Data and tensor parallelism, ZeRO-1 and parameter reallocation
# ----------------------------------------------------------------------
#: depth cut (the script's time): tp_gen and realloc at 4 of LLaMA-7B's
#: 32 layers since the replicated-KV and MoE-over-members phases came
PAR_GEN_LAYERS = 4
PAR_NEW_TOKENS = 128
PAR_FAULT_TOKENS = 16
PAR_SFT_LAYERS = 4
PAR_SFT_STEPS = 3
PAR_GEN_LAYOUTS = ("d2t2", "d1t4")
PAR_REALLOC_CHAIN = ("d1t1", "d1t2", "d2t1", "d2t2", "d1t1")
PAR_EMA_ETA = 0.3
#: about 3x the largest sound reading of ``scripts/torch_par_phases.py
#: --seeds 1 2 3 4 5`` (H100 80GB HBM3, 700 W), each with its planted
#: fault far above it: tp_gen's greedy tokens against the d1t1
#: teacher-forced pass, max |log-prob gap| 0.205-0.234 at d2t2 and
#: 0.222-0.279 at d1t4 (member 1's row-parallel partial dropped:
#: 8.37-10.29); tp_sft against d1t1 over 3 steps, loss 2.2e-5-4.2e-5
#: and grad norm 4.5e-5-1.5e-4 relative, the master weights' update
#: 0.0109-0.0113 relative (gradients not summed over the data group:
#: grad norm 0.46-0.51 off); the EMA move against a plain fp32 lerp 0.0
#: (bit-equal, so its limit is 0)
PAR_LIMITS = dict(tp_gen_tf_logprob_abs=0.85, tp_sft_loss_rel=1.25e-4,
                  tp_sft_grad_norm_rel=4.5e-4, tp_sft_update_rel=0.034,
                  realloc_ema_abs=0.0)
#: the par_ppo cell's layouts: the actor on d1t2 generating on a d2t1
#: replica, ref inferring on a d1t2 replica, the critic on d2t1 (ZeRO-1)
PAR_PPO = {"actor.parallel.tensor_parallel_size": "2",
           "critic.parallel.data_parallel_size": "2",
           "actor_gen_alloc": "d2t1", "ref_inf_alloc": "d1t2"}


def launches_of(layers, members, fwd=0, bwd=0, decode=0):
    """Kernel counts of ``members`` members each running ``fwd`` K1
    passes, ``bwd`` K2/K3 passes and ``decode`` K4 steps over ``layers``
    layers."""
    return dict(flash_fwd=layers * members * fwd,
                flash_bwd_dq=layers * members * bwd,
                flash_bwd_dkv=layers * members * bwd,
                flash_decode=layers * members * decode,
                flash_decode_stacked=0, ring_round=0,
                ring_push=0, **NO_RING_BWD)


def add_counts(*ds):
    return {k: sum(d[k] for d in ds) for k in ds[0]}


@contextlib.contextmanager
def row_partial_dropped(member=1):
    """The planted tensor-parallel fault: model member ``member``'s
    row-parallel (``wo``/``wd``) partial output left out of the sum."""
    import torch
    from realhf_tpu_torch.models import transformer as T
    real = T._row_parallel

    def faulty(parts, devs):
        return real([torch.zeros_like(p) if i == member else p
                     for i, p in enumerate(parts)], devs)

    with patched(T, "_row_parallel", faulty):
        yield


def phase_tp_gen(smi, seed=1):
    """gen-7b-b8's traffic (LLaMA-7B at ``PAR_GEN_LAYERS`` layers, 8
    prompts of 100-512 words, 128 new tokens; one greedy and one sampled
    batch) through the gen experiment at d2t2 and at d1t4, the members on
    ``member_devices``. Gates per layout: exact K1/K4 counts (each member
    runs K1 once a layer a prefill and K4 once a layer a decode step),
    tokens in range, and the greedy tokens' log-probs against one packed
    teacher-forced K1 forward of the d1t1 model with the same weights.
    Planted fault: d2t2's greedy tokens regenerated
    (``PAR_FAULT_TOKENS``) with member 1's row-parallel partial dropped
    must read a gap over the limit. ``rec["_segs"]`` keeps the greedy
    batch's prompt segments for ``phase_kernels_par``."""
    import torch
    from realhf_tpu_torch.api.experiment import ModelSpec
    from realhf_tpu_torch.engine import packing
    from realhf_tpu_torch.models.config import llama_config
    from realhf_tpu_torch.ops.sampling import GenerationHyperparameters
    from realhf_tpu_torch.parallel.mesh import parse_parallelism
    from realhf_tpu_torch.system.inline import InlineRunner
    from realhf_tpu_torch.system.model_host import build_model
    lim = PAR_LIMITS["tp_gen_tf_logprob_abs"]
    ref = build_model("default", ModelSpec(random_init_config=llama_config(
        "7b", n_layers=PAR_GEN_LAYERS), bf16=True), None, init_seed=seed)
    rcfg, rparams = ref.engine.cfg, ref.engine.params
    rec = dict(n_layers=PAR_GEN_LAYERS, seed=seed, card=smi, layouts={},
               limits=PAR_LIMITS)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "prompts.jsonl")
        write_prompts(data, 8, seed=seed)
        for layout in PAR_GEN_LAYOUTS:
            spec, vocab = build_gen_spec(data, PAR_GEN_LAYERS,
                                         PAR_NEW_TOKENS, 1, seed=seed)
            par = parse_parallelism(layout)
            spec.models["default"].parallel = par
            t0 = time.monotonic()
            runner = InlineRunner(spec, role_devices={
                "default": member_devices(par.world_size)})
            sync_all()
            setup = time.monotonic() - t0
            eng = runner.models["default"].engine
            seen = []
            reset_peaks(eng.members)
            reset_counts()
            with watching_generate(seen):
                runner.run()
                outputs_ok = check_gen_output(runner, vocab)
                runner.interfaces["gen"].gconfig = GenerationHyperparameters(
                    max_new_tokens=PAR_NEW_TOKENS, greedy=False, top_k=50,
                    top_p=0.9, force_no_logits_mask=True)
                runner.run()
                outputs_ok &= check_gen_output(runner, vocab)
            counts = read_counts()
            stats = list(eng.generate_stats)
            want = launches_of(PAR_GEN_LAYERS, par.world_size,
                               fwd=len(stats),
                               decode=sum(s["decode_steps"] for s in stats))
            items = sequences_of(seen, 1)
            r = dict(setup_secs=setup, members=[str(d) for d in eng.members],
                     steps=[dict(step=lab, **step_summary(st, smi))
                            for lab, st in zip(
                                ("greedy", "sampled_topk50_topp0.9"), stats)],
                     launches=counts, launches_expected=want,
                     launches_ok=counts == want, outputs_in_range=outputs_ok,
                     peak_mem_gb=read_peaks(eng.members),
                     tf=tf_gaps(packed_teacher_forced(rcfg, rparams,
                                                      items)[0], items))
            r["tf_ok"] = r["tf"]["max_abs"] <= lim
            if layout == PAR_GEN_LAYOUTS[0]:
                rec["_segs"] = dict(prefill=seen[0][1])
                prompts = [p for p, *_ in items]
                ids, seg, pos = packing.left_padded_prompts(prompts, 0)
                g = GenerationHyperparameters(
                    max_new_tokens=PAR_FAULT_TOKENS, greedy=True)
                with row_partial_dropped():
                    fo = eng.generate(ids, seg, pos, None, g, None,
                                      0).to_host()
                fitems = [(p, fo.tokens[b, :int(fo.lengths[b])],
                           fo.logprobs[b, :int(fo.lengths[b])])
                          for b, p in enumerate(prompts)]
                r["planted_fault"] = dict(row_partial_dropped=tf_gaps(
                    packed_teacher_forced(rcfg, rparams, fitems)[0], fitems))
                r["fault_fails"] = (r["planted_fault"]["row_partial_dropped"]
                                    ["max_abs"] > lim)
            r["ok"] = (r["launches_ok"] and outputs_ok and r["tf_ok"]
                       and len(stats) == 2 and r.get("fault_fails", True))
            rec["layouts"][layout] = r
            del runner, eng, seen
            gc.collect()
            torch.cuda.empty_cache()
    del ref, rparams
    gc.collect()
    torch.cuda.empty_cache()
    rec["launches"] = add_counts(*(r["launches"]
                                   for r in rec["layouts"].values()))
    rec["ok"] = all(r["ok"] for r in rec["layouts"].values())
    return rec


def sft_runner(data, layout, seed, schedule=None, n_layers=PAR_SFT_LAYERS):
    """The sft cell (16 prompt-answer records, 2 microbatches, lr 1e-5,
    3 epochs of one step) at 7B width and ``n_layers`` layers on
    ``layout`` (a pipeline layout under ``schedule`` when given), its
    members on ``member_devices``."""
    import dataclasses
    from realhf_tpu_torch.parallel.mesh import parse_parallelism
    from realhf_tpu_torch.system.inline import InlineRunner
    spec = build_sft_spec(data, n_layers)
    spec.seed = seed
    par = parse_parallelism(layout)
    if schedule:
        par = dataclasses.replace(par, pipeline_schedule=schedule)
    spec.models["default"].parallel = par
    t0 = time.monotonic()
    runner = InlineRunner(without_saves(spec), role_devices={
        "default": member_devices(par.world_size)})
    sync_all()
    return runner, time.monotonic() - t0


def canonical_masters(eng):
    """Every leaf's fp32 master copy, canonical (whole, unpadded), on
    the engine's first device, in the engine's leaf order."""
    if not eng.sharded:
        return list(eng.optimizer.master)
    return list(eng._canonical_state(eng.optimizer.master, eng.device))


def sft_steps(runner):
    return [st["trainDefault"] for st in runner.step_stats]


def phase_tp_sft(smi, seed=1):
    """The sft cell's traffic at 7B width and 4 layers, d2t2 with ZeRO-1
    (the default), 3 steps, against the d1t1 runner of the same seed on
    the card. Gates: each step's loss and grad norm (relative), the
    update of the fp32 master weights over the 3 steps (|master(d2t2) -
    master(d1t1)| / |master(d1t1) - start| over every leaf), exact K1-K3
    counts. Planted fault: gradients not summed over the data group (a
    fresh d2t2 runner, 2 steps) must miss the grad-norm limit.
    ``rec["_segs"]`` keeps the d2t2 microbatches' streams (one row a
    data member) for ``phase_kernels_par``."""
    import torch
    from realhf_tpu_torch.engine.engine import Engine, _leaves
    lim = PAR_LIMITS
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "sft.jsonl")
        write_prompt_answers(data, 16, seed=3)
        ref, _ = sft_runner(data, "d1t1", seed)
        reng = ref.models["default"].engine
        start = [p.detach().clone() for p in _leaves(reng.params)]
        ref.run()
        sync_all()
        rsteps = sft_steps(ref)
        rsecs = list(ref.step_secs)
        rmaster = canonical_masters(reng)
        upd = math.sqrt(sum(float((m - w.float()).pow(2).sum())
                            for m, w in zip(rmaster, start)))
        del start, ref, reng
        gc.collect()
        torch.cuda.empty_cache()
        runner, setup = sft_runner(data, "d2t2", seed)
        eng = runner.models["default"].engine
        mb_segs = []
        train_batch = eng.train_batch

        def keep_streams(microbatches, *args, **kw):
            mb_segs.extend(mb["seg_ids"] for mb in microbatches)
            return train_batch(microbatches, *args, **kw)

        eng.train_batch = keep_streams
        reset_peaks(eng.members)
        reset_counts()
        runner.run()
        sync_all()
        counts = read_counts()
        steps = sft_steps(runner)
        diff = math.sqrt(sum(float((m - r).pow(2).sum()) for m, r in zip(
            canonical_masters(eng), rmaster)))
        n, n_mb = len(eng.members), 2
        n_eval = len(runner.eval_dataloader) * len(runner.eval_stats)
        want = launches_of(PAR_SFT_LAYERS, n,
                           fwd=2 * n_mb * PAR_SFT_STEPS + n_eval,
                           bwd=n_mb * PAR_SFT_STEPS)
        tokens = runner.last_batch.total_len("packed_input_ids")
        rec = dict(n_layers=PAR_SFT_LAYERS, seed=seed, card=smi,
                   setup_secs=setup, members=[str(d) for d in eng.members],
                   losses=[s["loss"] for s in steps],
                   ref_losses=[s["loss"] for s in rsteps],
                   grad_norms=[s["grad_norm"] for s in steps],
                   ref_grad_norms=[s["grad_norm"] for s in rsteps],
                   step_secs=list(runner.step_secs), ref_step_secs=rsecs,
                   train_tokens_per_s=[tokens / t for t in runner.step_secs],
                   peak_mem_gb=read_peaks(eng.members), launches=counts,
                   launches_expected=want, launches_ok=counts == want,
                   update_norm=upd, limits=lim, _segs=dict(minibatch=mb_segs))
        rec["loss_rel"] = max(abs(a - b) / abs(b) for a, b in zip(
            rec["losses"], rec["ref_losses"]))
        rec["grad_norm_rel"] = max(abs(a - b) / abs(b) for a, b in zip(
            rec["grad_norms"], rec["ref_grad_norms"]))
        rec["update_rel"] = diff / upd
        del runner, eng, rmaster
        gc.collect()
        torch.cuda.empty_cache()
        frunner, _ = sft_runner(data, "d2t2", seed)
        batch = next(iter(frunner.dataloader))
        with patched(Engine, "_sum_grads", lambda self, acc: acc):
            fgn = [frunner.run_step(batch)["trainDefault"]["grad_norm"]
                   for _ in range(2)]
        del frunner
        gc.collect()
        torch.cuda.empty_cache()
    rec["planted_fault"] = dict(grads_not_summed_over_data=dict(
        grad_norms=fgn, grad_norm_rel=max(abs(a - b) / abs(b) for a, b in zip(
            fgn, rec["ref_grad_norms"]))))
    rec["fault_fails"] = (rec["planted_fault"]["grads_not_summed_over_data"]
                          ["grad_norm_rel"] > lim["tp_sft_grad_norm_rel"])
    rec["ok"] = (rec["launches_ok"] and rec["fault_fails"]
                 and rec["loss_rel"] <= lim["tp_sft_loss_rel"]
                 and rec["grad_norm_rel"] <= lim["tp_sft_grad_norm_rel"]
                 and rec["update_rel"] <= lim["tp_sft_update_rel"]
                 and len(steps) == PAR_SFT_STEPS)
    return rec


def leaf_digest(t) -> int:
    """A position-weighted sum of a leaf's 16-bit words (a row moved
    changes it), in int64 on the leaf's device."""
    import torch
    x = t.contiguous().view(-1).view(torch.int16)
    total, step = 0, 1 << 26
    for s in range(0, x.numel(), step):
        c = x[s:s + step].long()
        w = torch.arange(s, s + c.numel(), device=x.device) % 65521 + 1
        total += int((c * w).sum())
    return total


def canonical_leaves(eng):
    """(path, canonical leaf on the engine's first device) one at a time;
    a sharded engine's from its first data group, after checking every
    data group holds the same shards."""
    import torch
    from realhf_tpu_torch.models import sharding
    from realhf_tpu_torch.parallel.realloc import _get
    cfg = eng.cfg
    for path, spec in sharding.flat_specs(cfg):
        if not eng.sharded:
            yield path, _get(eng.params, path)
            continue
        groups = [[_get(tr, path).to(eng.device) for tr in
                   eng.params.group(g)[0]] for g in range(eng.params.d)]
        sd = sharding.split_dim(spec)
        whole = [torch.cat(g, dim=sd) if sd is not None else g[0]
                 for g in groups]
        if not all(torch.equal(whole[0], w) for w in whole[1:]):
            raise AssertionError(f"{path}: data groups differ")
        yield path, sharding.repad_vocab_leaf(cfg, path, whole[0], 1)


def digests(eng):
    return {"/".join(p): leaf_digest(x) for p, x in canonical_leaves(eng)}


@contextlib.contextmanager
def vocab_repad_shifted():
    """The planted reallocation fault: the vocabulary repad shifts the
    embedding's rows by one."""
    import torch
    from realhf_tpu_torch.models import sharding
    real = sharding.repad_vocab_leaf

    def faulty(cfg, path, arr, tp):
        out = real(cfg, path, arr, tp)
        if tuple(path) == ("embed", "wte"):
            out = torch.roll(out, 1, dims=0)
        return out

    with patched(sharding, "repad_vocab_leaf", faulty):
        yield


def par_engine(layout, seed):
    """An inference engine of LLaMA-7B at ``PAR_GEN_LAYERS`` layers (bf16) on
    ``layout``, its members on ``member_devices``, weights from
    ``seed``."""
    from realhf_tpu_torch.api.experiment import ModelSpec
    from realhf_tpu_torch.models.config import llama_config
    from realhf_tpu_torch.parallel.mesh import parse_parallelism
    from realhf_tpu_torch.system.model_host import build_model
    par = parse_parallelism(layout)
    return build_model("default", ModelSpec(
        random_init_config=llama_config("7b", n_layers=PAR_GEN_LAYERS),
        bf16=True, parallel=par), None, init_seed=seed,
        devices=member_devices(par.world_size)).engine


def phase_realloc(smi, seed=1):
    """LLaMA-7B at ``PAR_GEN_LAYERS`` layers moved (``parallel/realloc.reallocate``)
    around d1t1 -> d1t2 -> d2t1 -> d2t2 -> d1t1, each target built with
    other weights and each source dropped after its move. Gates: every
    target's canonical leaves read the first's position-weighted digest
    (and every data group holds the same shards), and the last d1t1 is
    bit-equal to the first, drawn again from its seed; an EMA move at eta
    0.3 into a d1t2 engine is bit-equal to a plain fp32 lerp of the two.
    Planted fault: a move with the vocabulary repad shifted by one row
    must miss the digest. Reported: each move's seconds and GB/s
    (canonical bytes)."""
    import torch
    from realhf_tpu_torch.parallel.realloc import reallocate
    t0 = time.monotonic()
    src = par_engine(PAR_REALLOC_CHAIN[0], seed)
    cfg = src.cfg
    want = digests(src)
    nbytes = sum(x.numel() * x.element_size()
                 for _, x in canonical_leaves(src))
    moves = []
    for i, layout in enumerate(PAR_REALLOC_CHAIN[1:]):
        dst = par_engine(layout, seed + 100 + i)
        sync_all()
        secs = reallocate(cfg, src.params, dst)
        moves.append(dict(src=PAR_REALLOC_CHAIN[i], dst=layout, secs=secs,
                          gb_per_s=nbytes / secs / 1e9,
                          digest_equal=digests(dst) == want))
        del src
        gc.collect()
        torch.cuda.empty_cache()
        src = dst
    first = par_engine(PAR_REALLOC_CHAIN[0], seed)
    last_equal = all(torch.equal(x, y) for (_, x), (_, y) in zip(
        canonical_leaves(src), canonical_leaves(first)))
    del first
    gc.collect()
    torch.cuda.empty_cache()
    chain_secs = time.monotonic() - t0
    # EMA into a d1t2 engine of other weights, against a plain fp32
    # lerp of the source's and the target's old leaves
    ema_dst = par_engine("d1t2", seed + 200)
    old = {p: x.clone() for p, x in canonical_leaves(ema_dst)}
    secs = reallocate(cfg, src.params, ema_dst, eta=PAR_EMA_ETA)
    ema_err = 0.0
    for (p, x), (_, s) in zip(canonical_leaves(ema_dst),
                              canonical_leaves(src)):
        plain = (PAR_EMA_ETA * s.float()
                 + (1 - PAR_EMA_ETA) * old[p].float()).to(x.dtype)
        ema_err = max(ema_err, float((x.float() - plain.float())
                                     .abs().max()))
    del old
    # the planted fault: the same move with the repad shifted
    with vocab_repad_shifted():
        reallocate(cfg, src.params, ema_dst)
    fault_digest_equal = digests(ema_dst) == want
    del src, ema_dst
    gc.collect()
    torch.cuda.empty_cache()
    rec = dict(n_layers=PAR_GEN_LAYERS, seed=seed, card=smi,
               model_bytes=nbytes, moves=moves, last_bit_equal=last_equal,
               chain_secs=chain_secs,
               ema=dict(eta=PAR_EMA_ETA, secs=secs, max_abs_err=ema_err),
               planted_fault=dict(vocab_repad_shifted=dict(
                   digest_equal=fault_digest_equal)),
               limits=PAR_LIMITS)
    rec["ok"] = (all(m["digest_equal"] for m in moves) and last_equal
                 and ema_err <= PAR_LIMITS["realloc_ema_abs"]
                 and not fault_digest_equal)
    return rec


def par_ppo_spec(data, benchmark_steps):
    spec, vocab = build_ppo_spec(data, PPO_LAYERS, benchmark_steps,
                                 extra=PAR_PPO)
    return without_saves(spec), vocab


def par_ppo_runner(spec):
    """The par_ppo cell's runner: the actor's and critic's two members,
    and the replicas' (``devices``), on ``member_devices``."""
    from realhf_tpu_torch.system.inline import InlineRunner
    return InlineRunner(spec, role_devices={"actor": member_devices(2),
                                            "critic": member_devices(2)},
                        devices=member_devices(4))


def expected_par_ppo_launches(runner, n_layers, n_minibatches):
    """Per step and member of the engine that runs the MFC: K1 once a
    layer in actor_gen's prefill and K4 once a layer a decode step (the
    d2t1 gen replica); K1 once a layer in rew_inf (d1t1), ref_inf (the
    d1t2 ref replica) and critic_inf (d2t1); in each train MFC per
    minibatch a forward and a checkpoint recompute (K1) and one backward
    (K2, K3), on actor (d1t2) and critic (d2t1)."""
    host = runner.host
    m = {n: len((host.replicas.get(n) or host.models[host.nodes[n].role])
                .engine.members) for n in host.nodes}
    gen = host.replicas["actor_gen"].engine.generate_stats
    steps = len(gen)
    out = [launches_of(n_layers, m["actor_gen"], fwd=steps,
                       decode=sum(s["decode_steps"] for s in gen))]
    for name in ("rew_inf", "ref_inf", "critic_inf"):
        out.append(launches_of(n_layers, m[name], fwd=steps))
    for name in ("actor_train", "critic_train"):
        out.append(launches_of(n_layers, m[name],
                               fwd=2 * n_minibatches * steps,
                               bwd=n_minibatches * steps))
    return add_counts(*out)


@contextlib.contextmanager
def refresh_skipped_after_train():
    """The planted reallocation fault: ``ensure_fresh`` syncs a replica
    once and never again, so after the train step the gen replica keeps
    the old weights."""
    from realhf_tpu_torch.parallel.realloc import ReplicaManager
    real = ReplicaManager.ensure_fresh

    def once(self, role, primary, replica, eta=1.0):
        if id(replica) in self._synced.get(role, {}):
            return
        return real(self, role, primary, replica, eta)

    with patched(ReplicaManager, "ensure_fresh", once):
        yield


def first_minibatches(seen):
    return [step[0] for step in seen["minibatch_stats"]["actor_train"]]


def first_minibatch_ok(firsts):
    lim = PPO_FIRST_MINIBATCH_LIMITS
    return len(firsts) == 2 and all(
        abs(m["importance_weight"] - 1) <= lim["importance_weight"]
        and abs(m["ppo_approx_kl"]) <= lim["ppo_approx_kl"] for m in firsts)


def phase_par_ppo(smi):
    """ppo-7bw-l4's traffic (7B width, 4 layers a role, 16 prompts, up
    to 128 sampled tokens, 4 minibatches, 2 steps) with the actor on
    d1t2 generating on a d2t1 replica, ref inferring on a d1t2 replica,
    the critic on d2t1 with ZeRO-1 and the reward on one device. Gates:
    the ppo phase's first-minibatch limits on both steps (the second
    after the gen replica's reallocation), exact K1-K4 counts per
    member, rollouts in range. Planted fault: a second runner whose
    replicas are refreshed once and never after a train step must miss
    them on step 2. Reported: per-MFC seconds and the reshard seconds
    of each step. ``rec["_segs"]`` keeps the streams the d1t2 members
    ran (the ref replica's inference stream, the actor's minibatches)
    for ``phase_kernels_par``."""
    import numpy as np
    import torch
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "prompts.jsonl")
        write_prompts(data, 160, seed=1)
        spec, vocab = par_ppo_spec(data, 2)
        t0 = time.monotonic()
        runner = par_ppo_runner(spec)
        sync_all()
        setup = time.monotonic() - t0
        seen = watch_ppo_runner(runner)
        ref_segs = []
        ref_eng = runner.replicas["ref_inf"].engine
        ref_logprobs = ref_eng.forward_logprobs

        def keep_ref_stream(ids, seg, *args, **kw):
            ref_segs.append(np.asarray(seg))
            return ref_logprobs(ids, seg, *args, **kw)

        ref_eng.forward_logprobs = keep_ref_stream
        reset_peaks(member_devices(4))
        reset_counts()
        runner.run()
        sync_all()
        counts = read_counts()
        want = expected_par_ppo_launches(runner, PPO_LAYERS, PPO_MINIBATCHES)
        firsts = first_minibatches(seen)
        mfc = seen["mfc_secs"]
        rec = dict(
            n_layers=PPO_LAYERS, card=smi, setup_secs=setup,
            layouts={r: str(runner.models[r].engine.parallel)
                     for r in PPO_ROLES},
            replicas={n: str(m.engine.parallel)
                      for n, m in runner.replicas.items()},
            step_secs=list(runner.step_secs),
            mfc_secs={k: list(v) for k, v in mfc.items()},
            reshard_secs=list(runner.replica_mgr.reshard_secs),
            first_minibatch=dict(
                importance_weight=[m["importance_weight"] for m in firsts],
                ppo_approx_kl=[m["ppo_approx_kl"] for m in firsts],
                limits=PPO_FIRST_MINIBATCH_LIMITS),
            rollout=check_ppo_rollout(runner.last_batch, vocab),
            peak_mem_gb=read_peaks(member_devices(4)),
            launches=counts, launches_expected=want,
            launches_ok=counts == want,
            # the actor trains on d1t2 (one stream a minibatch); the
            # critic's d2t1 minibatches have two
            _segs=dict(inference=ref_segs, minibatch=[
                a for a in seen["segs"]["minibatch"] if a.shape[0] == 1]))
        rec["first_minibatch_ok"] = first_minibatch_ok(firsts)
        del runner, seen
        gc.collect()
        torch.cuda.empty_cache()
        spec, _ = par_ppo_spec(data, 2)
        with refresh_skipped_after_train():
            runner = par_ppo_runner(spec)
            seen = watch_ppo_runner(runner)
            runner.run()
        ffirsts = first_minibatches(seen)
        del runner, seen
        gc.collect()
        torch.cuda.empty_cache()
    rec["planted_fault"] = dict(refresh_skipped_after_train=dict(
        importance_weight=[m["importance_weight"] for m in ffirsts],
        ppo_approx_kl=[m["ppo_approx_kl"] for m in ffirsts]))
    rec["fault_fails"] = not first_minibatch_ok(ffirsts)
    rec["ok"] = bool(
        rec["first_minibatch_ok"] and rec["fault_fails"]
        and rec["launches_ok"] and len(rec["step_secs"]) == 2
        and all(rec["rollout"][k] for k in (
            "tokens_in_range", "tokens_inside_mask", "logprobs_ok")))
    return rec


PAR_PHASES = (("tp_gen", phase_tp_gen), ("tp_sft", phase_tp_sft),
              ("realloc", phase_realloc), ("par_ppo", phase_par_ppo))


def run_par_phases(smi):
    """phases 34-37, each freeing its models before the next. Returns
    the records and the segment matrices the members ran at (each
    phase's ``_segs``, keyed by phase)."""
    recs, segs = {}, {}
    for name, fn in PAR_PHASES:
        t0 = time.monotonic()
        recs[name] = fn(smi)
        recs[name]["phase_secs"] = time.monotonic() - t0
        if "_segs" in recs[name]:
            segs[name] = recs[name].pop("_segs")
        emit(name, **recs[name])
    return recs, segs


def phase_kernels_par(segs):
    """K1-K4 against their plain versions at the shapes the members of
    the parallel phases launched them at, from the segment matrices
    those phases kept (``run_par_phases``), with the limits and planted
    faults of phase 3. tp_gen: K1 on each d2t2 data member's rows of the
    8-prompt prefill at 16/16 heads (B 4) and on the d1t4 members' 8 rows
    at 8/8 heads, K4 at the same streams and heads over the cache of
    prompt length + ``PAR_NEW_TOKENS`` slots, half the new tokens
    written. tp_sft: K1 and K2/K3 on each data member's stream of the
    longest d2t2 microbatch at 16/16 heads. par_ppo: K1 on the d1t2 ref
    replica's inference stream and K1, K2/K3 on the d1t2 actor's longest
    minibatch stream, at 16/16 heads. hd 128 throughout; the first case
    of each kind timed."""
    import torch
    from realhf_tpu_torch.models.transformer import data_rows
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)

    def on_card(seg):
        return torch.as_tensor(seg, dtype=torch.int32, device="cuda")

    def longest(arrays):
        return on_card(max(arrays, key=lambda a: (a != 0).sum()))

    nq, hd = 32, 128
    fwd, bwd = [], []
    prefill = on_card(segs["tp_gen"]["prefill"])
    b, lp = prefill.shape
    for layout, d, t in (("d2t2", 2, 2), ("d1t4", 1, 4)):
        for j, (r0, r1) in enumerate(data_rows(b, d)):
            seg, first = prefill[r0:r1], j == 0
            h = nq // t
            fwd.append(check_flash_fwd(
                f"tp_gen_{layout}_prefill_member{j * t}", r1 - r0, lp, h, h,
                hd, seg, True, gen, timed=first, plant_fault=first))
            spans = [(lp - int(n), lp + PAR_NEW_TOKENS // 2)
                     for n in (seg != 0).sum(-1)]
            fwd.append(check_flash_decode(
                f"tp_gen_{layout}_decode_member{j * t}", r1 - r0,
                lp + PAR_NEW_TOKENS, h, h, hd, spans, gen, timed=first))
    mb = longest(segs["tp_sft"]["minibatch"])
    for j, (r0, r1) in enumerate(data_rows(mb.shape[0], 2)):
        seg, first = mb[r0:r1], j == 0
        fwd.append(check_flash_fwd(
            f"tp_sft_d2t2_stream_member{2 * j}", 1, seg.shape[1], 16, 16, hd,
            seg, True, gen, timed=first, plant_fault=first))
        bwd.append(check_flash_bwd(
            f"tp_sft_d2t2_stream_member{2 * j}", 1, seg.shape[1], 16, 16, hd,
            seg, True, gen, timed=first, plant_fault=first))
    for name, seg in (("par_ppo_ref_d1t2_stream",
                       longest(segs["par_ppo"]["inference"])),
                      ("par_ppo_actor_d1t2_minibatch",
                       longest(segs["par_ppo"]["minibatch"]))):
        fwd.append(check_flash_fwd(name, 1, seg.shape[1], 16, 16, hd, seg,
                                   True, gen, timed=False, plant_fault=True))
    seg = longest(segs["par_ppo"]["minibatch"])
    bwd.append(check_flash_bwd("par_ppo_actor_d1t2_minibatch", 1,
                               seg.shape[1], 16, 16, hd, seg, True, gen,
                               timed=False, plant_fault=True))
    for rec in fwd + bwd:
        rec["member_shape"] = True
    del gen
    torch.cuda.empty_cache()
    return fwd, bwd


PP_SFT_LAYOUTS = (("p2", "1f1b"), ("p2t2", "1f1b"), ("p2", "gpipe"))
#: depth cut (the script's time): 8 of LLaMA-7B's 32 layers since the
#: replicated-KV and MoE-over-members phases came
PP_GEN_LAYERS = 8
PP_NEW_TOKENS = 64
PP_FAULT_TOKENS = 16
PP_PERTURB_SEED = 101
#: about 3x the largest sound reading of ``scripts/torch_pp_phases.py
#: --seeds 1 2 3 4 5`` (NVIDIA H100 80GB HBM3, 700.00 W), each with its
#: planted fault far above it: pp_sft against d1t1 over 3 steps at p2,
#: p2t2 and p2 under GPipe, loss 1.03e-5-8.0e-5 and grad norm
#: 3.4e-5-1.64e-4 relative, the master weights' update 0.0083-0.0113
#: relative (dx sent to microbatch m - 1: grad norm 0.097-0.108, step-2
#: loss 0.0157-0.0164 off); p2's GPipe log-probs against a d1t1 engine
#: of its weights 0.0 (bit-equal, so its limit is 0; stage outputs sent
#: to microbatch m - 1: 7.2-8.2); pp_gen's greedy tokens against the d1t1
#: teacher-forced pass, max |log-prob gap| 0.183-0.346 over the p2, p2g2,
#: after-set_params and c4g4 cases (a view left stale by set_params:
#: 8.9-10.0)
PP_LIMITS = dict(pp_sft_loss_rel=2.4e-4, pp_sft_grad_norm_rel=5e-4,
                 pp_sft_update_rel=0.034, pp_sft_logprobs_abs=0.0,
                 pp_gen_tf_logprob_abs=1.05)
#: the pp_ppo cell's layouts: the actor at p2 (1F1B) dropping its decode
#: view after each rollout, the critic at p2 under GPipe
PP_PPO = {"actor.parallel.pipeline_parallel_size": "2",
          "actor.drop_decode_view_after_rollout": "true",
          "critic.parallel.pipeline_parallel_size": "2",
          "critic.parallel.pipeline_schedule": "gpipe"}


def pipeline_launches(layers, members, n_mb, train_passes=0, infer_passes=0,
                      recompute=3):
    """Kernel counts of a pipelined engine: every stage member runs its
    slab on each of the ``n_mb`` microbatches of a pass; a train pass
    launches K1 ``recompute`` times a layer (the forward, the stage's
    recompute in the backward, the block checkpoint's recompute inside
    it) and K2/K3 once, an inference pass K1 once."""
    return launches_of(layers, members,
                       fwd=n_mb * (recompute * train_passes + infer_passes),
                       bwd=n_mb * train_passes)


@contextlib.contextmanager
def output_to_previous_microbatch():
    """The planted GPipe fault: stage s's output of microbatch m goes to
    stage s + 1's microbatch m - 1."""
    from realhf_tpu_torch.parallel import pipeline
    with patched(pipeline, "_next_key",
                 lambda s, m, n: (s + 1, (m - 1) % n)):
        yield


@contextlib.contextmanager
def dx_to_previous_microbatch():
    """The planted 1F1B fault: the backward sends stage s's input
    cotangent of microbatch m to stage s - 1's microbatch m - 1."""
    from realhf_tpu_torch.parallel import schedule
    with patched(schedule, "_dx_key", lambda s, m, n: (s - 1, (m - 1) % n)):
        yield


def logprob_gap(eng, ref_eng, mbs):
    """Max |log-prob| gap over the valid tokens of each microbatch dict
    between two engines (``forward_logprobs``)."""
    import numpy as np
    gap = 0.0
    for mb in mbs:
        a = eng.forward_logprobs(mb["input_ids"], mb["seg_ids"]).cpu()
        b = ref_eng.forward_logprobs(mb["input_ids"], mb["seg_ids"]).cpu()
        keep = np.asarray(mb["seg_ids"]) != 0
        gap = max(gap, float((a - b).abs()[keep].max()))
    return gap


def phase_pp_sft(smi, seed=1):
    """The sft cell's traffic at 7B width and 4 layers, 3 steps, at p2
    (1F1B, M 8), p2t2 (1F1B) and p2 under GPipe (M 4), each against the
    d1t1 runner of the same seed on the card. Gates per layout: each
    step's loss and grad norm (relative), the fp32 master weights'
    update over the 3 steps, exact K1-K3 (``pipeline_launches``: 3 K1
    and one K2/K3 a layer a microbatch a train pass, one K1 an eval
    pass); for p2 (1F1B) also ``forward_logprobs`` (GPipe) of the
    trained engine against a d1t1 engine holding its weights, which a
    GPipe forward sending each stage's output to microbatch m - 1 must
    miss. Planted fault: a fresh p2 runner whose 1F1B backward sends dx
    to microbatch m - 1 (2 steps) must miss the grad-norm limit and, on
    step 2, the loss limit. Reported: step
    seconds beside d1t1's, peak memory, the stage inputs the 1F1B
    forward keeps and the tick inputs GPipe's keep. ``rec["_segs"]``
    keeps the microbatch streams for ``phase_kernels_pp``."""
    import torch
    from realhf_tpu_torch.engine.engine import Engine, _leaves
    from realhf_tpu_torch.parallel import pipeline, schedule
    lim = PP_LIMITS
    rec = dict(n_layers=PAR_SFT_LAYERS, seed=seed, card=smi, layouts={},
               limits=lim)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "sft.jsonl")
        write_prompt_answers(data, 16, seed=3)
        ref, _ = sft_runner(data, "d1t1", seed)
        reng = ref.models["default"].engine
        start = [p.detach().clone() for p in _leaves(reng.params)]
        reset_peaks([reng.device])
        ref.run()
        sync_all()
        rsteps = sft_steps(ref)
        rec["ref"] = dict(losses=[s["loss"] for s in rsteps],
                          grad_norms=[s["grad_norm"] for s in rsteps],
                          step_secs=list(ref.step_secs),
                          peak_mem_gb=read_peaks([reng.device]))
        rmaster = canonical_masters(reng)
        upd = math.sqrt(sum(float((m - w.float()).pow(2).sum())
                            for m, w in zip(rmaster, start)))
        del start, ref, reng
        gc.collect()
        torch.cuda.empty_cache()
        segs = {}
        for layout, sched in PP_SFT_LAYOUTS:
            name = layout + ("-gpipe" if sched == "gpipe" else "")
            runner, setup = sft_runner(data, layout, seed, sched)
            eng = runner.models["default"].engine
            mbs = []
            train_batch = eng.train_batch

            def keep_streams(microbatches, *args, **kw):
                mbs.extend(microbatches)
                return train_batch(microbatches, *args, **kw)

            eng.train_batch = keep_streams
            reset_peaks(eng.members)
            reset_counts()
            runner.run()
            sync_all()
            counts = read_counts()
            steps = sft_steps(runner)
            diff = math.sqrt(sum(float((m - r).pow(2).sum()) for m, r in zip(
                canonical_masters(eng), rmaster)))
            pipe, t = eng.pipeline_ctx, eng.parallel.tensor_parallel_size
            n_eval = len(runner.eval_dataloader) * len(runner.eval_stats)
            want = pipeline_launches(PAR_SFT_LAYERS, t, pipe.n_microbatches,
                                     train_passes=2 * PAR_SFT_STEPS,
                                     infer_passes=n_eval)
            r = dict(layout=str(eng.parallel), schedule=pipe.schedule,
                     n_microbatches=pipe.n_microbatches, setup_secs=setup,
                     members=[str(d) for d in eng.members],
                     losses=[s["loss"] for s in steps],
                     grad_norms=[s["grad_norm"] for s in steps],
                     step_secs=list(runner.step_secs),
                     peak_mem_gb=read_peaks(eng.members),
                     saved_input_bytes=(schedule.last_saved_bytes
                                        if sched == "1f1b"
                                        else pipeline.last_saved_bytes),
                     launches=counts, launches_expected=want,
                     launches_ok=counts == want, card=smi)
            r["loss_rel"] = max(abs(a - b) / abs(b) for a, b in zip(
                r["losses"], rec["ref"]["losses"]))
            r["grad_norm_rel"] = max(abs(a - b) / abs(b) for a, b in zip(
                r["grad_norms"], rec["ref"]["grad_norms"]))
            r["update_rel"] = diff / upd
            r["ok"] = (r["launches_ok"] and len(steps) == PAR_SFT_STEPS
                       and r["loss_rel"] <= lim["pp_sft_loss_rel"]
                       and r["grad_norm_rel"] <= lim["pp_sft_grad_norm_rel"]
                       and r["update_rel"] <= lim["pp_sft_update_rel"])
            if name == "p2":
                one = Engine(eng.cfg, eng.gathered_params(), eng.device)
                r["logprobs_abs"] = logprob_gap(eng, one, mbs[:2])
                with output_to_previous_microbatch():
                    r["fault_logprobs_abs"] = logprob_gap(eng, one, mbs[:2])
                r["ok"] &= (r["logprobs_abs"] <= lim["pp_sft_logprobs_abs"]
                            < r["fault_logprobs_abs"])
                del one
            segs[name] = [mb["seg_ids"] for mb in mbs]
            rec["layouts"][name] = r
            del runner, eng, mbs
            gc.collect()
            torch.cuda.empty_cache()
        del rmaster
        frunner, _ = sft_runner(data, "p2", seed, "1f1b")
        batch = next(iter(frunner.dataloader))
        with dx_to_previous_microbatch():
            fsteps = [frunner.run_step(batch)["trainDefault"]
                      for _ in range(2)]
        del frunner
        gc.collect()
        torch.cuda.empty_cache()
    fault = dict(grad_norms=[s["grad_norm"] for s in fsteps],
                 losses=[s["loss"] for s in fsteps])
    fault["grad_norm_rel"] = max(abs(a - b) / abs(b) for a, b in zip(
        fault["grad_norms"], rec["ref"]["grad_norms"]))
    fault["loss_rel"] = max(abs(a - b) / abs(b) for a, b in zip(
        fault["losses"], rec["ref"]["losses"]))
    rec["planted_fault"] = dict(dx_to_previous_microbatch=fault)
    rec["fault_fails"] = (fault["grad_norm_rel"] > lim["pp_sft_grad_norm_rel"]
                          and fault["loss_rel"] > lim["pp_sft_loss_rel"])
    rec["launches"] = add_counts(*(r["launches"]
                                   for r in rec["layouts"].values()))
    rec["ok"] = rec["fault_fails"] and all(
        r["ok"] for r in rec["layouts"].values())
    rec["_segs"] = segs
    return rec


def pp_prompts(seed, vocab, n=8, lo=100, hi=512):
    """gen-7b-b8's prompt shape: ``n`` prompts of ``lo``-``hi`` tokens,
    drawn from ``seed``, left-padded -> (ids, seg, pos, prompts)."""
    import numpy as np
    from realhf_tpu_torch.engine import packing
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(2, vocab, size=int(rng.integers(lo, hi + 1)))
               .astype(np.int32) for _ in range(n)]
    return (*packing.left_padded_prompts(prompts, 0), prompts)


@contextlib.contextmanager
def view_not_refreshed_after_set_params():
    """The planted decode-view fault: ``set_params`` leaves the engine's
    weight epoch where it was, so the view keeps the old weights."""
    from realhf_tpu_torch.engine.engine import Engine
    real = Engine.set_params

    def stale(self, params):
        epoch = self.params_epoch
        real(self, params)
        self.params_epoch = epoch

    with patched(Engine, "set_params", stale):
        yield


def view_generate(eng, ids, seg, pos, new_tokens):
    """One greedy generate through ``eng``'s decode view -> (the view's
    build or refresh ms, stats, items (prompt, tokens, log-probs),
    launches)."""
    from realhf_tpu_torch.ops.sampling import GenerationHyperparameters
    reset_counts()
    sync_all()
    t0 = time.monotonic()
    view = eng.decode_engine()
    sync_all()
    build_ms = (time.monotonic() - t0) * 1e3
    out = eng.generate(ids, seg, pos, None, GenerationHyperparameters(
        max_new_tokens=new_tokens, greedy=True), None, 0).to_host()
    sync_all()
    counts = read_counts()
    items = [(ids[b][seg[b] != 0], out.tokens[b, :int(out.lengths[b])],
              out.logprobs[b, :int(out.lengths[b])])
             for b in range(ids.shape[0])]
    return view, build_ms, eng.generate_stats[-1], items, counts


def freed_by_drop(eng):
    """(``decode_view_param_bytes``, the bytes the allocator got back
    from ``drop_decode_view``) over the members' distinct cards."""
    import torch
    devs = list(dict.fromkeys(eng.members))
    held = eng.decode_view_param_bytes()
    sync_all()
    gc.collect()
    before = sum(torch.cuda.memory_allocated(d) for d in devs)
    eng.drop_decode_view()
    gc.collect()
    sync_all()
    after = sum(torch.cuda.memory_allocated(d) for d in devs)
    return held, before - after


def phase_pp_gen(smi, seed=1):
    """gen-7b-b8's prompt shape (8 prompts of 100-512 tokens, greedy, 64
    new tokens) at LLaMA-7B width, ``PP_GEN_LAYERS`` layers (half a stage):
    a p2 engine generating through its default decode view (d2t1), then
    at g2 (view d1t2), and a c4 engine through its view at g4 (d1t4),
    members on ``member_devices``. Gates per case: exact K1/K4 counts on
    the view's members, the greedy tokens' log-probs against one packed
    teacher-forced K1 forward of the d1t1 model with the same weights,
    and ``drop_decode_view`` returning exactly
    ``decode_view_param_bytes`` to the allocator. Then the p2 engine's
    ``set_params`` of perturbed weights: its view must follow (gap
    against the perturbed d1t1 model). Planted fault: ``set_params``
    that leaves the weight epoch, back to the first weights (16 tokens),
    must exceed the limit. Reported: the view's build ms, decode ms a
    token, prefill ms."""
    import torch
    from realhf_tpu_torch.api.experiment import ModelSpec
    from realhf_tpu_torch.models.config import llama_config
    from realhf_tpu_torch.parallel.mesh import parse_parallelism
    from realhf_tpu_torch.system.model_host import build_model
    lim = PP_LIMITS["pp_gen_tf_logprob_abs"]
    ref = build_model("default", ModelSpec(random_init_config=llama_config(
        "7b", n_layers=PP_GEN_LAYERS), bf16=True), None, init_seed=seed)
    rcfg, rparams = ref.engine.cfg, ref.engine.params
    ids, seg, pos, _ = pp_prompts(seed, rcfg.vocab_size)
    rec = dict(n_layers=PP_GEN_LAYERS, new_tokens=PP_NEW_TOKENS, seed=seed,
               card=smi, cases={}, limits=PP_LIMITS)

    def case(eng, tf_params):
        view, build_ms, st, items, counts = view_generate(
            eng, ids, seg, pos, PP_NEW_TOKENS)
        want = launches_of(PP_GEN_LAYERS, len(view.members), fwd=1,
                           decode=st["decode_steps"])
        r = dict(layout=str(eng.parallel), view=str(view.parallel),
                 view_build_ms=build_ms, **step_summary(st, smi),
                 launches=counts, launches_expected=want,
                 launches_ok=counts == want,
                 tf=tf_gaps(packed_teacher_forced(rcfg, tf_params,
                                                  items)[0], items),
                 peak_mem_gb=read_peaks(eng.members))
        r["tf_ok"] = r["tf"]["max_abs"] <= lim
        r["view_param_bytes"], r["freed_bytes"] = freed_by_drop(eng)
        r["drop_ok"] = r["freed_bytes"] == r["view_param_bytes"] > 0
        r["ok"] = r["launches_ok"] and r["tf_ok"] and r["drop_ok"]
        return r

    def build(layout):
        par = parse_parallelism(layout)
        return build_model("default", ModelSpec(
            random_init_config=llama_config("7b", n_layers=PP_GEN_LAYERS),
            bf16=True, parallel=par), None, init_seed=seed,
            devices=member_devices(par.world_size)).engine

    eng = build("p2")
    reset_peaks(eng.members)
    rec["cases"]["p2"] = case(eng, rparams)
    eng.set_gen_tp(2)
    rec["cases"]["p2g2"] = case(eng, rparams)
    moved = perturbed(rparams, PP_PERTURB_SEED)
    eng.set_params(moved)
    follow = case(eng, moved)
    rec["cases"]["p2g2_after_set_params"] = follow
    del moved
    gc.collect()
    eng.decode_engine()  # the view holds the perturbed weights again
    with view_not_refreshed_after_set_params():
        eng.set_params(rparams)
    _, _, _, items, _ = view_generate(eng, ids, seg, pos, PP_FAULT_TOKENS)
    rec["planted_fault"] = dict(view_not_refreshed=tf_gaps(
        packed_teacher_forced(rcfg, rparams, items)[0], items))
    rec["fault_fails"] = rec["planted_fault"]["view_not_refreshed"][
        "max_abs"] > lim
    del eng, items
    gc.collect()
    torch.cuda.empty_cache()
    eng = build("c4g4")
    reset_peaks(eng.members)
    rec["cases"]["c4g4"] = case(eng, rparams)
    del eng, ref, rparams
    gc.collect()
    torch.cuda.empty_cache()
    rec["launches"] = add_counts(*(r["launches"]
                                   for r in rec["cases"].values()))
    rec["ok"] = rec["fault_fails"] and all(
        r["ok"] for r in rec["cases"].values())
    rec["_segs"] = dict(prefill=seg)
    return rec


def expected_pp_ppo_launches(runner, n_layers, n_minibatches):
    """Per step: actor_gen's prefill (K1) and decode steps (K4) on each
    member of the actor's decode view; rew_inf and ref_inf on one device
    (K1); critic_inf one GPipe pass of the critic's M microbatches; each
    train MFC per minibatch one pipelined train pass (3 K1 and one K2/K3
    a layer a microbatch) over its engine's M."""
    host = runner.host
    actor = host.models["actor"].engine
    critic = host.models["critic"].engine
    gen = actor.generate_stats
    steps = len(gen)
    view_members = len(actor._decode_view.members)
    out = [launches_of(n_layers, view_members, fwd=steps,
                       decode=sum(s["decode_steps"] for s in gen)),
           launches_of(n_layers, 1, fwd=2 * steps),
           pipeline_launches(n_layers, 1, critic.pipeline_ctx.n_microbatches,
                             infer_passes=steps)]
    for eng in (actor, critic):
        out.append(pipeline_launches(
            n_layers, 1, eng.pipeline_ctx.n_microbatches,
            train_passes=n_minibatches * steps))
    return add_counts(*out)


@contextlib.contextmanager
def view_keyed_on_tree_identity():
    """The planted refresh fault: the decode view's freshness keyed on
    the identity of the weights object (the JAX package's key, whose
    train step replaces the tree) in place of the version: the port
    trains in place, so the view keeps the rollout-1 weights."""
    from realhf_tpu_torch.engine.engine import Engine
    with patched(Engine, "_weights_key", lambda self: id(self.params)):
        yield


def timed_view_builds(eng, out):
    """Wraps ``eng.decode_engine`` to append each call's ms (the view's
    build or refresh, synchronised) to ``out``."""
    real = eng.decode_engine

    def timed():
        sync_all()
        t0 = time.monotonic()
        view = real()
        sync_all()
        out.append((time.monotonic() - t0) * 1e3)
        return view

    eng.decode_engine = timed


def phase_pp_ppo(smi):
    """ppo-7bw-l4's traffic (7B width, 4 layers a role, 16 prompts, up
    to 128 sampled tokens, 4 minibatches, 2 steps) with the actor at p2
    (1F1B, M 8) dropping its decode view after each rollout, the critic
    at p2 under GPipe (M 4), ref and reward on one device. Gates: the
    ppo phase's first-minibatch limits on both steps (the second after
    the view was rebuilt from the trained weights), exact K1-K4, the
    rollout in range, the view dropped after the last rollout. Planted
    fault: a runner without the drop whose view's freshness is keyed on
    the weights object's identity must miss the limits on step 2.
    Reported: per-MFC seconds and the view build ms of each step."""
    import torch
    from realhf_tpu_torch.system.inline import InlineRunner
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "prompts.jsonl")
        write_prompts(data, 160, seed=1)
        spec, vocab = build_ppo_spec(data, PPO_LAYERS, 2, extra=PP_PPO)
        t0 = time.monotonic()
        runner = InlineRunner(without_saves(spec), role_devices={
            "actor": member_devices(2), "critic": member_devices(2)})
        sync_all()
        setup = time.monotonic() - t0
        seen = watch_ppo_runner(runner)
        actor = runner.models["actor"].engine
        builds = []
        timed_view_builds(actor, builds)
        reset_peaks(member_devices(2))
        reset_counts()
        runner.run()
        sync_all()
        counts = read_counts()
        want = expected_pp_ppo_launches(runner, PPO_LAYERS, PPO_MINIBATCHES)
        firsts = first_minibatches(seen)
        rec = dict(
            n_layers=PPO_LAYERS, card=smi, setup_secs=setup,
            layouts={r: str(runner.models[r].engine.parallel)
                     for r in PPO_ROLES},
            schedules={r: runner.models[r].engine.pipeline_ctx.schedule
                       for r in ("actor", "critic")},
            view=str(actor._decode_view.parallel),
            view_build_ms=builds,
            view_dropped=actor.decode_view_param_bytes() == 0,
            step_secs=list(runner.step_secs),
            mfc_secs={k: list(v) for k, v in seen["mfc_secs"].items()},
            first_minibatch=dict(
                importance_weight=[m["importance_weight"] for m in firsts],
                ppo_approx_kl=[m["ppo_approx_kl"] for m in firsts],
                limits=PPO_FIRST_MINIBATCH_LIMITS),
            rollout=check_ppo_rollout(runner.last_batch, vocab),
            peak_mem_gb=read_peaks(member_devices(2)),
            launches=counts, launches_expected=want,
            launches_ok=counts == want)
        rec["first_minibatch_ok"] = first_minibatch_ok(firsts)
        del runner, seen, actor
        gc.collect()
        torch.cuda.empty_cache()
        spec, _ = build_ppo_spec(data, PPO_LAYERS, 2, extra=dict(
            PP_PPO, **{"actor.drop_decode_view_after_rollout": "false"}))
        with view_keyed_on_tree_identity():
            runner = InlineRunner(without_saves(spec), role_devices={
                "actor": member_devices(2), "critic": member_devices(2)})
            seen = watch_ppo_runner(runner)
            runner.run()
        ffirsts = first_minibatches(seen)
        del runner, seen
        gc.collect()
        torch.cuda.empty_cache()
    rec["planted_fault"] = dict(view_keyed_on_tree_identity=dict(
        importance_weight=[m["importance_weight"] for m in ffirsts],
        ppo_approx_kl=[m["ppo_approx_kl"] for m in ffirsts]))
    rec["fault_fails"] = not first_minibatch_ok(ffirsts)
    rec["ok"] = bool(
        rec["first_minibatch_ok"] and rec["fault_fails"]
        and rec["launches_ok"] and rec["view_dropped"]
        and len(rec["step_secs"]) == 2
        and all(rec["rollout"][k] for k in (
            "tokens_in_range", "tokens_inside_mask", "logprobs_ok")))
    return rec


PP_PHASES = (("pp_sft", phase_pp_sft), ("pp_gen", phase_pp_gen),
             ("pp_ppo", phase_pp_ppo))


def run_pp_phases(smi):
    """The pipeline and decode-view phases, each freeing its models
    before the next. Returns the records and the segment matrices their
    members ran at."""
    recs, segs = {}, {}
    for name, fn in PP_PHASES:
        t0 = time.monotonic()
        recs[name] = fn(smi)
        recs[name]["phase_secs"] = time.monotonic() - t0
        if "_segs" in recs[name]:
            segs[name] = recs[name].pop("_segs")
        emit(name, **recs[name])
    return recs, segs


def phase_kernels_pp(segs):
    """K1-K4 against their plain versions at the shapes the pipeline
    phases launched them at, with the limits and planted faults of phase
    3: K1 and K2/K3 on one pipeline microbatch (one stream) of pp_sft's
    p2 at 32/32 heads and of its p2t2 at 16/16 heads (the longest
    stream of each; one record a stream, so without the shifted-boundary
    fault); K1 and K4 on each member of pp_gen's d2t1 view (4
    prompt rows at 32/32 heads, the cache of prompt length +
    ``PP_NEW_TOKENS`` slots, half the new tokens written) and on the
    d1t4 view's members (8 rows at 8/8). hd 128; the first case of each
    kind timed."""
    import torch
    from realhf_tpu_torch.models.transformer import data_rows
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)

    def on_card(seg):
        return torch.as_tensor(seg, dtype=torch.int32, device="cuda")

    def longest_row(arrays):
        rows = [a[i:i + 1] for a in arrays for i in range(a.shape[0])]
        return on_card(max(rows, key=lambda a: (a != 0).sum()))

    nq, hd = 32, 128
    fwd, bwd = [], []
    for name, h, first in (("p2", nq, True), ("p2t2", nq // 2, False)):
        # one record a stream: no segment boundary to shift, no fault
        seg = longest_row(segs["pp_sft"][name])
        label = f"pp_sft_{name}_microbatch"
        fwd.append(check_flash_fwd(label, 1, seg.shape[1], h, h, hd, seg,
                                   True, gen, timed=first))
        bwd.append(check_flash_bwd(label, 1, seg.shape[1], h, h, hd, seg,
                                   True, gen, timed=first))
    prefill = on_card(segs["pp_gen"]["prefill"])
    b, lp = prefill.shape
    for view, d, t in (("d2t1", 2, 1), ("d1t4", 1, 4)):
        for j, (r0, r1) in enumerate(data_rows(b, d)):
            seg, first = prefill[r0:r1], j == 0 and view == "d2t1"
            h = nq // t
            fwd.append(check_flash_fwd(
                f"pp_gen_{view}_prefill_member{j * t}", r1 - r0, lp, h, h,
                hd, seg, True, gen, timed=first, plant_fault=j == 0))
            spans = [(lp - int(n), lp + PP_NEW_TOKENS // 2)
                     for n in (seg != 0).sum(-1)]
            fwd.append(check_flash_decode(
                f"pp_gen_{view}_decode_member{j * t}", r1 - r0,
                lp + PP_NEW_TOKENS, h, h, hd, spans, gen, timed=first))
    for rec in fwd + bwd:
        rec["member_shape"] = True
    del gen
    torch.cuda.empty_cache()
    return fwd, bwd


# ----------------------------------------------------------------------
# Training on context-parallel layouts and sequence parallelism
# ----------------------------------------------------------------------
#: the cp_sft records (tokens, the end-of-sequence one included): one
#: batch of six, 16384 tokens packed into one stream a step in the
#: dataloader's order; no length is a multiple of 1024, so records cross
#: the members' shard boundaries
CP_RECORDS = (3584, 1536, 3000, 2616, 2824, 2824)
CP_LAYOUTS = ("c2", "c4", "d1t2c2s")
#: depth cut (the script's time): cp_sft and sp_sft train 2 of the 7B
#: width's layers (4 before the phases of the hd 256 ring, MoE in
#: pipelines and s with p); every layer runs the same ring and the same
#: sequence-parallel block, and the limits were read at 4
CP_SFT_LAYERS = 2
#: each sequence-parallel layout and the layout without ``s`` it is held
#: against
SP_LAYOUTS = (("d1t2s", "d1t2"), ("d2t2s", "d2t2"))
#: about 3x the largest sound reading of ``scripts/torch_cp_phases.py
#: --seeds 1 2 3 4 5`` (H100 80GB HBM3, 700 W), each with its planted
#: fault far above it: cp_sft against d1t1 over 3 steps at c2, c4 and
#: d1t2c2s, loss 7.6e-5-1.34e-4 and grad norm 9.1e-4-1.18e-3 relative
#: (two bf16 attentions that round in other orders; tp_sft, whose K1
#: rows are d1t1's, reads 10x less), the master weights' update
#: 0.0021-0.0048 relative (dk/dv summed into shard src + 1: loss
#: 0.0073-0.0085, grad norm 0.019-0.025, update 0.318-0.325 off); c4's
#: log-probs against d1t1 of its weights 0.056-0.067 (K6's key offsets
#: one shard off: 10.6-12.0); sp_sft's forward against the layout
#: without ``s`` 0.0 (bit-equal, so its limit is 0; the reduce-scatter
#: handing member j member j + 1's slice: 5.8-6.5), its steps on
#: ``PAR_LIMITS`` (loss 1.4e-5-7.2e-5, grad norm 3.5e-5-1.34e-4, update
#: 0.0057-0.0059; the shifted slice: step-1 loss 2.9e-4-4.7e-3 off)
CP_LIMITS = dict(cp_sft_loss_rel=4e-4, cp_sft_grad_norm_rel=3.5e-3,
                 cp_sft_update_rel=0.0145, cp_sft_logprobs_abs=0.2,
                 sp_sft_forward_abs=0.0)


def cp_launches(layers, t, n, train_passes=0, infer_passes=0):
    """Kernel counts of a context-parallel engine of ``n`` members a ring
    and ``t`` model members (one ring a layer a model index a forward): a
    train forward launches K6's first n - 1 rounds plainly and its last
    with the lse, n members each, and pushes in every round but the last;
    its backward launches K2 and K3 once a round not out of reach (n (n +
    1) / 2 causal); an inference forward launches all n rounds plainly.
    No K1, and no K6 recompute: the ring lies outside the checkpoint
    regions."""
    rings = layers * t
    out = launches_of(0, 0)
    out["ring_round"] = rings * n * ((n - 1) * train_passes
                                     + n * infer_passes)
    out["ring_push"] = rings * n * (n - 1) * (train_passes + infer_passes)
    if train_passes:
        out["ring_round_lse"] = rings * n * train_passes
        out["flash_bwd_dq_ring"] = out["flash_bwd_dkv_ring"] = (
            rings * n * (n + 1) // 2 * train_passes)
    return out


@contextlib.contextmanager
def dkv_into_next_shard():
    """The planted ring-backward fault: the dk/dv partials of round (i,
    src) are summed into shard src + 1."""
    import torch
    from realhf_tpu_torch.ops import ring_attention as ra
    from realhf_tpu_torch.ops import ring_attention_fused as rf

    def faulty(qs, ks, vs, segs, outs, lses, dos, *, causal, sliding_window,
               round_fn):
        n, lc = len(qs), qs[0].shape[1]
        deltas = [ra.attention_delta(o, do) for o, do in zip(outs, dos)]
        dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
              for q in qs]
        dk = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
              for k in ks]
        dv = [torch.zeros_like(x) for x in dk]
        for _, i, src in ra.ring_bwd_rounds(n, lc, causal, sliding_window):
            dev = qs[i].device
            pq, pk, pv = round_fn(qs[i], ks[src].to(dev), vs[src].to(dev),
                                  segs[i], segs[src].to(dev), dos[i],
                                  lses[i], deltas[i], i * lc, src * lc)
            dq[i] += pq
            bad = (src + 1) % n
            dk[bad] += pk.to(dk[bad].device)
            dv[bad] += pv.to(dv[bad].device)
        return ([g.to(q.dtype) for g, q in zip(dq, qs)],
                [g.to(k.dtype) for g, k in zip(dk, ks)],
                [g.to(v.dtype) for g, v in zip(dv, vs)])

    with patched(rf, "ring_attention_bwd", faulty):
        yield


@contextlib.contextmanager
def key_offsets_one_shard_off():
    """The planted ring-forward fault: K6 takes every KV half at the
    global offset of the next shard (the causal mask on wrong
    positions)."""
    from realhf_tpu_torch.ops import ring_attention_fused as rf
    real = rf.round_key_offsets

    def shifted(member, rnd, n, lc, lch, n_dirs):
        return [o + lc for o in real(member, rnd, n, lc, lch, n_dirs)]

    with patched(rf, "round_key_offsets", shifted):
        yield


@contextlib.contextmanager
def reduce_scatter_shifted():
    """The planted sequence-parallel fault: the reduce-scatter hands
    member j the slice of member j + 1."""
    from realhf_tpu_torch.parallel import collectives

    real = collectives.reduce_scatter

    def shifted(xs, devices, dim):
        outs = real(xs, devices, dim)
        return [outs[(j + 1) % len(outs)].to(d)
                for j, d in enumerate(devices)]

    with patched(collectives, "reduce_scatter", shifted):
        yield


def write_cp_records(path, seed):
    """The cp_sft dataset: the ``CP_RECORDS`` records, each a prompt of
    a quarter to a half of its words and the answer the rest."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def words(k):
        return " ".join(f"w{int(w)}" for w in rng.integers(0, 5000, size=k))

    with open(path, "w") as f:
        for i, n in enumerate(CP_RECORDS):
            p = int(rng.integers(n // 4, n // 2))
            f.write(json.dumps({"id": i, "prompt": words(p),
                                "answer": " " + words(n - 1 - p)}) + "\n")


def cp_runner(data, layout, seed, model_config):
    """The sft experiment (``SFTConfig.build``) on the cp_sft records at
    ``model_config``, one microbatch of one stream a step, 3 epochs of
    one step, on ``layout`` over ``member_devices``."""
    from realhf_tpu_torch.parallel.mesh import parse_parallelism
    from realhf_tpu_torch.system.inline import InlineRunner
    spec = build_sft_spec(data, model_config["n_layers"],
                          model_config=model_config,
                          overrides={
        "dataset.train_bs_n_seqs": str(len(CP_RECORDS)),
        "dataset.max_seqlen": str(max(CP_RECORDS)), "n_mbs": "1"})
    spec.seed = seed
    par = parse_parallelism(layout)
    spec.models["default"].parallel = par
    t0 = time.monotonic()
    runner = InlineRunner(without_saves(spec), role_devices={
        "default": member_devices(par.world_size)})
    sync_all()
    return runner, time.monotonic() - t0


def start_weights(eng):
    """The engine's canonical weights in fp32, in its leaf order, on the
    host (so the run's peak does not count them)."""
    from realhf_tpu_torch.engine.engine import _leaves
    tree = eng.gathered_params() if eng.sharded else eng.params
    return [p.detach().float().cpu() for p in _leaves(tree)]


def counted_run(runner):
    """Run the runner's steps with the launches counted -> a record of
    its steps, seconds, peak memory and counts, the fp32 masters'
    update norm over the run, the masters, and the microbatch dicts the
    engine trained on."""
    eng = runner.models["default"].engine
    start = start_weights(eng)
    mbs = []
    train_batch = eng.train_batch

    def keep(microbatches, *args, **kw):
        mbs.extend(microbatches)
        return train_batch(microbatches, *args, **kw)

    eng.train_batch = keep
    reset_peaks(eng.members)
    reset_counts()
    runner.run()
    sync_all()
    counts = read_counts()
    del eng.train_batch
    steps = sft_steps(runner)
    master = canonical_masters(eng)
    upd = math.sqrt(sum(float((m - w.to(m.device)).pow(2).sum())
                        for m, w in zip(master, start)))
    peaks = read_peaks(eng.members)
    rec = dict(layout=str(eng.parallel), members=[str(d) for d in eng.members],
               losses=[s["loss"] for s in steps],
               grad_norms=[s["grad_norm"] for s in steps],
               step_secs=list(runner.step_secs),
               peak_mem_gb=max(peaks.values()), peak_mem_gb_by_device=peaks,
               launches=counts, update_norm=upd)
    return rec, master, mbs


def to_host(tensors):
    """A reference's fp32 masters moved to the host, so they hold no
    device memory while the layouts held against them run (their peak
    would count them)."""
    return [t.cpu() for t in tensors]


def held_against(rec, ref, master, ref_master, lim, prefix):
    """loss and grad norm (max relative gap over the steps) and the fp32
    masters' update (|master - ref master| / |ref's update|) of a run
    against its reference, and whether each is within ``lim``. The
    reference's masters may wait on the host (``to_host``), one leaf at
    a time coming back."""
    rec["loss_rel"] = max(abs(a - b) / abs(b) for a, b in zip(
        rec["losses"], ref["losses"]))
    rec["grad_norm_rel"] = max(abs(a - b) / abs(b) for a, b in zip(
        rec["grad_norms"], ref["grad_norms"]))
    rec["update_rel"] = math.sqrt(sum(
        float((m - r.to(m.device)).pow(2).sum())
        for m, r in zip(master, ref_master))) / ref["update_norm"]
    rec["step_secs_vs_ref"] = [a / b for a, b in zip(rec["step_secs"],
                                                     ref["step_secs"])]
    rec["peak_mem_vs_ref"] = rec["peak_mem_gb"] / ref["peak_mem_gb"]
    return (len(rec["losses"]) == PAR_SFT_STEPS
            and rec["loss_rel"] <= lim[f"{prefix}_loss_rel"]
            and rec["grad_norm_rel"] <= lim[f"{prefix}_grad_norm_rel"]
            and rec["update_rel"] <= lim[f"{prefix}_update_rel"])


def free():
    """Collect what the caller dropped and give the cache back."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def phase_cp_sft(smi, seed=1):
    """The sft experiment on one 16384-token stream a step (six records
    of 1024-4096 tokens packed across the shard boundaries) at 7B width
    and ``CP_SFT_LAYERS`` layers, 3 steps, at c2, c4 and d1t2c2s
    (``cp_phase`` on
    ``CP_LIMITS``; c4's log-probs with every key shard's offset one shard
    off must miss). Planted training fault: a fresh c2 runner whose ring
    backward sums round (i, src)'s dk/dv into shard src + 1 (3 steps)
    must miss the loss, grad-norm or update limit (wk and wv then learn
    from the wrong shard's keys)."""
    from realhf_tpu_torch.models.config import llama_config
    return cp_phase(smi, seed, llama_config("7b", n_layers=CP_SFT_LAYERS),
                    CP_SFT_LAYERS, CP_LAYOUTS, CP_LIMITS, "cp_sft",
                    key_offsets_one_shard_off, dkv_fault=True)


def cp_phase(smi, seed, model_config, n_layers, layouts, lim, prefix,
             logprob_fault, dkv_fault=False):
    """The sft experiment on the cp_sft stream (``model_config``, default
    7B width, at ``n_layers`` layers), 3 steps, at each of ``layouts``
    (every member on ``member_devices``), each against the d1t1 runner
    of the same seed on the card. Gates per layout (``lim``, keys
    ``prefix`` + ``_*``): each step's loss and grad norm (relative), the
    fp32 master weights' update over the 3 steps, exact K6 (plain and lse
    rounds), push and K2/K3 ring-entry counts (``cp_launches``); for c4
    also ``forward_logprobs`` of the trained engine against a d1t1
    engine of its weights, which the same forward under
    ``logprob_fault()`` must miss. ``dkv_fault``: the planted training
    fault of ``phase_cp_sft``. Reported: step seconds and peak memory
    beside d1t1's. ``rec["_segs"]`` keeps each layout's streams for the
    kernel phases."""
    from realhf_tpu_torch.engine.engine import Engine
    rec = dict(n_layers=n_layers, seed=seed, card=smi, layouts={},
               records=list(CP_RECORDS), limits=lim)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "cp.jsonl")
        write_cp_records(data, seed=3)
        ref, setup = cp_runner(data, "d1t1", seed, model_config)
        rec["ref"], rmaster, _ = counted_run(ref)
        rmaster = to_host(rmaster)
        rec["ref"]["setup_secs"] = setup
        del ref
        free()
        for layout in layouts:
            runner, setup = cp_runner(data, layout, seed, model_config)
            eng = runner.models["default"].engine
            r, master, mbs = counted_run(runner)
            r["setup_secs"] = setup
            n_eval = len(runner.eval_dataloader) * len(runner.eval_stats)
            par = eng.parallel
            r["launches_expected"] = cp_launches(
                n_layers, par.tensor_parallel_size,
                par.context_parallel_size, train_passes=PAR_SFT_STEPS,
                infer_passes=n_eval)
            r["launches_ok"] = r["launches"] == r["launches_expected"]
            r["stream_len"] = int(mbs[0]["seg_ids"].shape[1])
            r["ok"] = held_against(r, rec["ref"], master, rmaster, lim,
                                   prefix) and r["launches_ok"]
            if layout == "c4":
                one = Engine(eng.cfg, eng.gathered_params(), eng.device)
                r["logprobs_abs"] = logprob_gap(eng, one, mbs[:1])
                with logprob_fault():
                    r["fault_logprobs_abs"] = logprob_gap(eng, one, mbs[:1])
                r["ok"] &= (r["logprobs_abs"] <= lim[f"{prefix}_logprobs_abs"]
                            < r["fault_logprobs_abs"])
                del one
            rec.setdefault("_segs", {})[layout] = [mb["seg_ids"]
                                                   for mb in mbs]
            r["card"] = smi
            rec["layouts"][layout] = r
            del runner, eng, master, mbs
            free()
        if dkv_fault:
            frunner, _ = cp_runner(data, "c2", seed, model_config)
            with dkv_into_next_shard():
                fault, fmaster, _ = counted_run(frunner)
            fault["within_limits"] = held_against(
                fault, rec["ref"], fmaster, rmaster, lim, prefix)
            rec["planted_fault"] = dict(dkv_into_next_shard={
                k: fault[k] for k in ("losses", "grad_norms", "loss_rel",
                                      "grad_norm_rel", "update_rel")})
            rec["fault_fails"] = not fault["within_limits"]
            del frunner, fmaster
        del rmaster
        free()
    rec["launches"] = add_counts(*(r["launches"]
                                   for r in rec["layouts"].values()))
    rec["ok"] = rec.get("fault_fails", True) and all(
        r["ok"] for r in rec["layouts"].values())
    return rec


def phase_sp_sft(smi, seed=1):
    """The sft cell's traffic (16 records a step, 2 microbatches) at 7B
    width and ``CP_SFT_LAYERS`` layers, 3 steps, at d1t2s and d2t2s,
    each against the
    same layout without ``s`` (d1t2, d2t2) of the same seed on the card
    (``sp_phase``). Exact K1-K3 counts: K1 twice a layer a member a
    train pass (each member's attention half is one checkpoint region,
    as at d x t)."""
    def launches(runner, eng):
        n_eval = len(runner.eval_dataloader) * len(runner.eval_stats)
        n, n_mb = len(eng.members), 2
        return launches_of(CP_SFT_LAYERS, n,
                           fwd=2 * n_mb * PAR_SFT_STEPS + n_eval,
                           bwd=n_mb * PAR_SFT_STEPS)

    return sp_phase(smi, seed, SP_LAYOUTS, CP_SFT_LAYERS, launches)


def sp_phase(smi, seed, layouts, n_layers, launches):
    """Each sequence-parallel layout of ``layouts`` (the sft cell at 7B
    width and ``n_layers`` layers, 3 steps) against the same layout
    without ``s`` of the same seed on the card. Gates:
    ``forward_logprobs`` of the untrained engines bit-equal
    (``sp_sft_forward_abs`` 0: the reduce-scatter sums in the
    all-reduce's order and the norms are per token), each step's loss and
    grad norm and the masters' update on ``PAR_LIMITS``' tp_sft limits,
    exact kernel counts (``launches(runner, engine)``). Planted fault:
    the reduce-scatter handing member j the slice of member j + 1 must
    break each forward's bit-equality and miss the loss limit on the
    first layout's first step. Reported: step seconds and peak memory
    beside the layout without ``s``."""
    import numpy as np
    plim, lim = PAR_LIMITS, CP_LIMITS
    rec = dict(n_layers=n_layers, seed=seed, card=smi, layouts={},
               limits=dict(sp_sft_forward_abs=lim["sp_sft_forward_abs"],
                           **{k: v for k, v in plim.items()
                              if k.startswith("tp_sft")}))
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "sft.jsonl")
        write_prompt_answers(data, 16, seed=3)
        for layout, base in layouts:
            lps, runs = {}, {}
            for lay in (base, layout):
                runner, setup = sft_runner(data, lay, seed,
                                           n_layers=n_layers)
                eng = runner.models["default"].engine
                # the first batch's tokens as two streams of one record
                ids = next(iter(runner.dataloader)).data["packed_input_ids"]
                ids = ids[:ids.shape[0] // 2 * 2].reshape(2, -1)
                mb = dict(input_ids=ids, seg_ids=np.ones_like(ids))
                lps[lay] = eng.forward_logprobs(mb["input_ids"],
                                                mb["seg_ids"]).cpu()
                if lay == layout:
                    with reduce_scatter_shifted():
                        bad = eng.forward_logprobs(mb["input_ids"],
                                                   mb["seg_ids"]).cpu()
                r, master, mbs = counted_run(runner)
                r["setup_secs"] = setup
                r["launches_expected"] = launches(runner, eng)
                r["launches_ok"] = r["launches"] == r["launches_expected"]
                runs[lay] = (r, to_host(master) if lay == base else master)
                del runner, eng, mbs, master
                free()
            r, master = runs[layout]
            base_rec, base_master = runs[base]
            r["ok"] = held_against(r, base_rec, master, base_master, plim,
                                   "tp_sft") and r["launches_ok"]
            r["forward_abs"] = float((lps[layout] - lps[base]).abs().max())
            r["forward_bit_equal"] = bool((lps[layout] == lps[base]).all())
            r["fault_forward_abs"] = float((bad - lps[base]).abs().max())
            r["ok"] &= (r["forward_abs"] <= lim["sp_sft_forward_abs"]
                        < r["fault_forward_abs"])
            r["base"] = base_rec
            r["card"] = smi
            rec["layouts"][layout] = r
            del master, base_master, runs
            free()
        first = layouts[0][0]
        frunner, _ = sft_runner(data, first, seed, n_layers=n_layers)
        batch = next(iter(frunner.dataloader))
        with reduce_scatter_shifted():
            floss = [frunner.run_step(batch)["trainDefault"]["loss"]]
        del frunner
        free()
    ref_loss = rec["layouts"][first]["base"]["losses"][0]
    fault = dict(losses=floss, loss_rel=abs(floss[0] - ref_loss) / ref_loss)
    rec["planted_fault"] = dict(reduce_scatter_shifted=fault)
    rec["fault_fails"] = fault["loss_rel"] > plim["tp_sft_loss_rel"]
    rec["launches"] = add_counts(*(r["launches"]
                                   for r in rec["layouts"].values()))
    rec["ok"] = rec["fault_fails"] and all(
        r["ok"] for r in rec["layouts"].values())
    return rec


CP_PHASES = (("cp_sft", phase_cp_sft), ("sp_sft", phase_sp_sft))


def run_cp_phases(smi):
    """The context- and sequence-parallel training phases, each freeing
    its models before the next. Returns the records and the streams each
    cp_sft layout trained on."""
    recs, segs = {}, None
    for name, fn in CP_PHASES:
        t0 = time.monotonic()
        recs[name] = fn(smi)
        recs[name]["phase_secs"] = time.monotonic() - t0
        if "_segs" in recs[name]:
            segs = recs[name].pop("_segs")
        emit(name, **recs[name])
    return recs, segs


def cp_round_inputs(seg, n, gen, nq=32, hd=128, nkv=None):
    """Random bf16 q/k/v/do over the stream ``seg`` [1, L] of ``n``
    shards (``nkv`` KV heads, default ``nq``), K1's o and lse over the
    whole stream (what K6's last round gives the ring's backward) and
    delta."""
    import torch
    from realhf_tpu_torch.ops import flash_attention as fa
    L = seg.shape[1]
    q, do = (torch.randn((1, L, nq, hd), generator=gen,
                         device="cuda").bfloat16() for _ in range(2))
    k, v = (torch.randn((1, L, nkv or nq, hd), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    o, lse = fa.flash_attention(q, k, v, seg)
    return q, k, v, do, o, lse, fa.attention_delta(o, do)


def check_ring_bwd_round(name, inputs, seg, n, i, src, timed=False,
                         plant_fault=False):
    """K2 and K3 at one ring round (member i's q shard against shard
    src's keys, global offsets, the keys' own segment ids, fp32 out)
    against their plain arithmetic on the same values widened to fp32, on
    the row-RMS limits of ``LIMITS``. With ``plant_fault`` the kernels
    also run with k_off one 64-key tile off, which must miss the dq and
    dk limits. Timed: both kernels, the plain round, SDPA's backward on
    the same (q shard, key shard) pairs (the mask at global positions)
    and the bound of the pairs the mask allows."""
    import torch
    from realhf_tpu_torch.ops import flash_attention as fa
    q, k, v, do, o, lse, delta = inputs
    L = seg.shape[1]
    lc = L // n
    rows, cols = slice(i * lc, (i + 1) * lc), slice(src * lc, (src + 1) * lc)
    qi, doi = q[:, rows].contiguous(), do[:, rows].contiguous()
    ks, vs = k[:, cols].contiguous(), v[:, cols].contiguous()
    si, sk = seg[:, rows].contiguous(), seg[:, cols].contiguous()
    li, di = lse[:, :, rows].contiguous(), delta[:, :, rows].contiguous()
    nq, nkv, hd = q.shape[2], k.shape[2], q.shape[3]
    kw = dict(causal=True, seg_k=sk, q_off=i * lc, k_off=src * lc,
              out_dtype=torch.float32)
    args = (qi, ks, vs, si, doi, li, di)
    dq = fa.flash_bwd_dq(*args, **kw)
    dk, dv = fa.flash_bwd_dkv(*args, **kw)
    torch.cuda.synchronize()
    ref = fa._bwd_plain(qi.float(), ks.float(), vs.float(), si, li,
                        doi.float(), di, scale=hd ** -0.5, window=None,
                        **kw)
    tok_q, tok_k = si != 0, sk != 0
    q_rows = tok_q[:, :, None].expand(1, lc, nq)
    kv_rows = tok_k[:, :, None].expand(1, lc, nkv)
    crossing = bool(i and seg[0, i * lc] != 0
                    and seg[0, i * lc - 1] == seg[0, i * lc])
    rec = dict(kernel="flash_bwd_ring", case=name, shape=[1, lc, nq, nkv, hd],
               q_off=i * lc, k_off=src * lc, record_crosses_into_shard=crossing,
               tokens=int(tok_q.sum()))
    for key, got, want, rws in (("dq", dq, ref[0], q_rows),
                                ("dk", dk, ref[1], kv_rows),
                                ("dv", dv, ref[2], kv_rows)):
        rec[f"{key}_max_abs_err"] = max_err(got, want)
        rec[f"{key}_row_rel_err"] = row_rel_err(got, want, rws, 0.01)
        rec[f"{key}_row_rel_limit"] = LIMITS[f"flash_bwd_{key}_row_rel"]
        rec[f"{key}_finite"] = bool(torch.isfinite(got).all())
    dq2 = fa.flash_bwd_dq(*args, **kw)
    rec["deterministic"] = bool(torch.equal(dq, dq2))
    rec["ok"] = rec["deterministic"] and all(
        rec[f"{key}_row_rel_err"] <= rec[f"{key}_row_rel_limit"]
        and rec[f"{key}_finite"] for key in ("dq", "dk", "dv"))
    if plant_fault:
        bad = dict(kw, k_off=src * lc + 64)
        rec["planted_fault"] = "k_off one 64-key tile off"
        for key, got, want, rws, heads in (
                ("dq", fa.flash_bwd_dq(*args, **bad), ref[0], q_rows, nq),
                ("dk", fa.flash_bwd_dkv(*args, **bad)[0], ref[1], kv_rows,
                 nkv)):
            err = row_rel_err(got, want, rws, 0.01)
            rec[f"planted_fault_{key}_row_rel_err"] = err
            rec["ok"] &= err > LIMITS[f"flash_bwd_{key}_row_rel"]
    if timed:
        rec["dq_ms"] = cuda_ms(lambda: fa.flash_bwd_dq(*args, **kw))
        rec["dkv_ms"] = cuda_ms(lambda: fa.flash_bwd_dkv(*args, **kw))
        rec["plain_ms"] = cuda_ms(lambda: fa._bwd_plain(
            qi, ks, vs, si, li, doi, di, scale=hd ** -0.5, window=None,
            **kw), iters=3, warmup=1)
        mask = fa.segment_mask(si, sk, True, q_off=i * lc, k_off=src * lc)
        rec["library_ms"] = sdpa_masked_backward_ms(qi, ks, vs, doi, mask)
        pairs = int(mask.sum()) * nq
        stats = 4 * (2 * li.numel() + si.numel() + sk.numel())
        rows_bytes = 2 * (int(tok_q.sum()) * 2 * nq
                          + int(tok_k.sum()) * 2 * nkv) * hd
        rec["dq_flops"] = 6.0 * hd * pairs
        rec["dq_bytes"] = rows_bytes + stats + 4 * dq.numel()
        rec["dkv_flops"] = 8.0 * hd * pairs
        rec["dkv_bytes"] = rows_bytes + stats + 4 * (dk.numel() + dv.numel())
        rec["dq_bound_ms"], rec["dq_bound_by"] = bound_ms(rec["dq_flops"],
                                                          rec["dq_bytes"])
        rec["dkv_bound_ms"], rec["dkv_bound_by"] = bound_ms(
            rec["dkv_flops"], rec["dkv_bytes"])
    del ref
    torch.cuda.empty_cache()
    return rec


def sdpa_masked_backward_ms(q, k, v, do, mask) -> float:
    """SDPA's backward (dq, dk and dv) under a boolean mask [B, Lq, Lk];
    timed only, never called by the port."""
    import torch
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    gqa = dict(enable_gqa=True) if q.shape[2] != k.shape[2] else {}
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask[:, None], **gqa)
    g = do.transpose(1, 2).contiguous()
    return cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), g,
                                               retain_graph=True))


def check_ring_lse(name, seg, n, gen, nq=32, hd=128, timed=False,
                   nkv=None):
    """K6 with the lse output over ``member_devices(n)`` (``nkv`` KV
    heads, default ``nq``): its lse row by row against
    ``flash_attention_plain``'s over the gathered stream (NEG_INF exactly
    on rows with no valid key; ``LIMITS["flash_fwd_lse"]`` on the
    others), and its o bit-equal to a launch without the lse. Timed: the
    ring with and without the lse, the bound as ``ring_bound``, SDPA's
    forward on the whole stream."""
    import torch
    from realhf_tpu_torch.ops import flash_attention as fa
    from realhf_tpu_torch.ops import ring_attention_fused as rf
    devs = member_devices(n)
    L = seg.shape[1]
    nkv = nkv or nq
    q = torch.randn((1, L, nq, hd), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((1, L, nkv, hd), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    shards = [ring_shards(t, devs) for t in (q, k, v, seg)]
    opts = dict(causal=True, scale=hd ** -0.5, sliding_window=None,
                block_q=256, block_k=512, bidirectional=True)
    outs, lses = rf._ring_forward(*shards, with_lse=True, **opts)
    plain_o = rf._ring_forward(*shards, **opts)
    sync_all()
    got = torch.cat([x.to("cuda:0") for x in lses], dim=-1)

    def plain_lse(dtype=torch.float32):
        # a few KV heads at a time (four q heads, or one KV head's
        # group): the whole stream's fp32 scores of every head would not
        # fit on the card
        g = nq // nkv
        per = max(1, 4 // g)
        return torch.cat([fa.flash_attention_plain(
            q[:, :, h * g:(h + per) * g].to(dtype),
            k[:, :, h:h + per].to(dtype), v[:, :, h:h + per].to(dtype),
            seg)[1] for h in range(0, nkv, per)], dim=1)

    want = plain_lse()
    valid = (want > NEG_INF / 2)
    rec = dict(kernel="ring_attention_lse", case=name,
               shape=[1, L // n, nq, nkv, hd], members=n,
               lse_max_abs_err=float((got - want).abs()[valid].max()),
               lse_limit=LIMITS["flash_fwd_lse"],
               empty_rows_neg_inf=bool((got[~valid] == NEG_INF).all()),
               o_bit_equal_without_lse=all(torch.equal(a, b) for a, b
                                           in zip(outs, plain_o)))
    rec["max_abs_err"] = rec["lse_max_abs_err"]
    rec["ok"] = (rec["lse_max_abs_err"] <= rec["lse_limit"]
                 and rec["empty_rows_neg_inf"]
                 and rec["o_bit_equal_without_lse"])
    if timed:
        rec["ms"] = cuda_ms(lambda: rf._ring_forward(*shards, with_lse=True,
                                                     **opts), iters=5)
        rec["without_lse_ms"] = cuda_ms(lambda: rf._ring_forward(
            *shards, **opts), iters=5)
        rec["plain_ms"] = cuda_ms(lambda: plain_lse(torch.bfloat16),
                                  iters=1, warmup=1)
        rec["bound_ms"], rec["bound_by"], _ = ring_bound(
            seg, devs, nq, nkv, hd, True, None)
        mask = fa.segment_mask(seg, seg, True)[:, None]
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        gqa = dict(enable_gqa=True) if nq != nkv else {}
        rec["library_ms"] = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, **gqa), iters=5)
    del q, k, v, shards, outs, lses, plain_o
    torch.cuda.empty_cache()
    return rec


#: the ring shards of cp_sft's layouts that K2/K3 at ring rounds and K6's
#: lse are held at: (layout, members a ring, q = kv heads of a member)
CP_KERNEL_SHARDS = (("c4", 4, 32), ("c2", 2, 32), ("d1t2c2s", 2, 16))


def phase_kernels_cp(segs):
    """K2/K3 at ring rounds and K6's lse at each of cp_sft's shard shapes
    (``CP_KERNEL_SHARDS``: B 1, lc 4096 with 32/32 heads of 128 at c4;
    lc 8192 with 32/32 at c2 and 16/16, a model member's heads, at
    d1t2c2s), each on the stream that layout trained on (``segs``: layout
    -> its streams): the diagonal round of shard i, and the off-diagonal
    round of shard i against shard i - 1 (q_off = i lc, k_off = (i - 1)
    lc) with the k_off fault, i the first shard a record crosses into
    (shard 1 when none does, which the record says); K6's lse over the
    same stream at that layout's n. The c4 cases timed."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    bwd, lse = [], []
    for layout, n, heads in CP_KERNEL_SHARDS:
        timed = not bwd
        seg = torch.as_tensor(segs[layout][0], dtype=torch.int32,
                              device="cuda")
        lc = seg.shape[1] // n
        i = next((j for j in range(1, n) if seg[0, j * lc] != 0
                  and seg[0, j * lc - 1] == seg[0, j * lc]), 1)
        inputs = cp_round_inputs(seg, n, gen, nq=heads)
        bwd += [check_ring_bwd_round(f"cp_sft_{layout}_shard{i}_diagonal",
                                     inputs, seg, n, i, i, timed=timed),
                check_ring_bwd_round(f"cp_sft_{layout}_shard{i}_keys{i - 1}",
                                     inputs, seg, n, i, i - 1,
                                     plant_fault=True)]
        del inputs
        torch.cuda.empty_cache()
        lse.append(check_ring_lse(f"cp_sft_{layout}", seg, n, gen, nq=heads,
                                  timed=timed))
        torch.cuda.empty_cache()
    del gen
    return bwd, lse


# ----------------------------------------------------------------------
# phases 40-42: KV heads replicated over the model members (t not
# dividing the KV heads; the decode's "seq" route) at google/gemma-2b,
# and mixture-of-experts over members (t > 1, expert parallelism, router
# losses over data and context shards) at Mixtral-8x7B width
# ----------------------------------------------------------------------
KV_REP_LAYOUTS = ("d1t2", "d1t4")
#: depth cut (the script's time): kv_rep generates at 6 of Gemma-2B's 18
#: layers (9 before the hd 256 ring, MoE-in-pipeline and s-with-p phases
#: came); every layer runs the same "seq" route
KV_REP_GEN_LAYERS = 6
KV_REP_NEW_TOKENS = 64
KV_REP_FAULT_TOKENS = 16
#: depth cut of kv_rep's training (Gemma-2B has 18 layers): d1t1 and
#: d1t2 train one after the other on one card, and the sft cell at 18
#: layers peaks at 60.4 GB alone; 4 layers (6 before the phases of the
#: hd 256 ring, MoE in pipelines and s with p) keep the phase's seconds
#: and peak small, and every layer runs the same replicated-KV path
KV_REP_SFT_LAYERS = 4
MOE_TP_LAYOUTS = ("d1t2", "d1t4")
#: the script's time: 32 greedy tokens a layout (64 before the phases of
#: the hd 256 ring, MoE in pipelines and s with p)
MOE_TP_NEW_TOKENS = 32
#: moe_sft_par's layouts: router losses over data shards (ragged), expert
#: parallelism over the data index with capacity dispatch, and router
#: losses over context shards (ragged, one stream a step)
MOE_SFT_LAYOUTS = ("d2t1", "d2t2ep", "c2")
MOE_EP_CAPACITY = 1.25
#: about 3x the largest sound reading of ``scripts/torch_moe_par_phases.py
#: --seeds 1 2 3 4 5`` (H100 80GB HBM3, 700 W), each with its planted
#: fault above it (PERF.md, Findings, PR 18):
#:   kv_rep_tf_*       greedy log-probs against d1t1's teacher-forced
#:                     pass, max 0.024-0.096 and mean 0.0013-0.0035 at
#:                     d1t2 / d1t4; member 1's partial dropped from the
#:                     merge max 0.107-0.908, mean 0.016-0.074 (the
#:                     attention of random weights moves a log-prob
#:                     little, so the mean gates beside the max)
#:   kv_sft_*          d1t2 against d1t1 over 3 steps: loss 3.4e-5-1.2e-4,
#:                     grad norm 1.5e-4-2.0e-4, update 0.0071-0.0077;
#:                     wk/wv gradients unsummed: 4.4e-3-5.3e-3 / 0.077-0.079
#:   moe_tp_*          mean gap 0.54-0.72 (d1t2), 0.68-0.81 (d1t4); row
#:                     partial dropped 4.85-5.34
#:   moe_sft_*         d2t1 / d2t2ep / c2 against the replayed d1t1: loss
#:                     up to 3.9e-4, grad norm 2.2e-3, update 0.040 (d2t1
#:                     0.004-0.009, c2 0.017-0.023), aux 1.3e-3; routing
#:                     per shard at d2t2ep: step-1 update 0.15-0.31 (its
#:                     loss 2.3e-5-2.2e-3 and aux 1.9e-3-4.3e-3 move
#:                     inside the sound spread on some seeds)
MOE_PAR_LIMITS = dict(kv_rep_tf_logprob_abs=0.29,
                      kv_rep_tf_logprob_mean_abs=0.0105,
                      kv_sft_loss_rel=3.5e-4, kv_sft_grad_norm_rel=6e-4,
                      kv_sft_update_rel=0.023,
                      moe_tp_tf_logprob_mean_abs=2.4,
                      moe_sft_loss_rel=1.2e-3, moe_sft_grad_norm_rel=6.7e-3,
                      moe_sft_update_rel=0.12, moe_sft_aux_rel=3.9e-3)


@contextlib.contextmanager
def merge_partial_dropped(member=1):
    """The planted "seq"-route fault: model member ``member``'s K4
    partial left out of the flash merge."""
    from realhf_tpu_torch.ops import decode_attention as da
    real = da.seqsplit_merge

    def faulty(parts, dtype):
        return real([p for i, p in enumerate(parts) if i != member], dtype)

    with patched(da, "seqsplit_merge", faulty):
        yield


@contextlib.contextmanager
def kv_grad_not_summed():
    """The planted replicated-KV fault: each model member keeps its own
    ``wk``/``wv`` gradient, not summed over the members that hold the
    replicated leaf."""
    from realhf_tpu_torch.engine.engine import Engine
    real = Engine._sum_grads

    def faulty(self, acc):
        out = real(self, acc)
        for k, (path, _, _) in enumerate(self._leaf_specs()):
            if path[-1] in ("wk", "wv"):
                for u, row in enumerate(out):
                    row[k] = acc[u][k]
        return out

    with patched(Engine, "_sum_grads", faulty):
        yield


@contextlib.contextmanager
def routing_per_shard():
    """The planted MoE fault, the port's routing before this slice: each
    data or context shard routes as a batch of its own (its share of the
    tokens for the capacity, queue positions from its own tokens alone),
    and the router losses are the mean of each shard's own."""
    import torch
    from realhf_tpu_torch.models import transformer as T
    from realhf_tpu_torch.ops import moe

    class PerShard(moe.MoEShards):
        def base(self, layer, key):
            own = self._counts[(layer, *key)]
            return torch.cumsum(own, 0) - own

        def losses(self, cfg_moe):
            out = {}
            n = len({k[1:] for k in self._stats})
            for k in sorted(self._stats):
                for name, val in moe.router_losses(
                        cfg_moe, self._stats[k]).items():
                    val = val.to(self.device) / n
                    out[name] = out[name] + val if name in out else val
            return out

    real = T._moe_shards

    def per_shard(cfg, mp, n_tokens):
        s = real(cfg, mp, n_tokens)
        if s is not None:
            s.__class__ = PerShard
            s.n_tokens = n_tokens // (mp.d * mp.c)
        return s

    with patched(T, "_moe_shards", per_shard):
        yield


def kv_gap_over(gap, lim) -> bool:
    """Whether a ``tf_gaps`` reading exceeds kv_rep's max or mean limit."""
    return (gap["max_abs"] > lim["kv_rep_tf_logprob_abs"]
            or gap["mean_abs"] > lim["kv_rep_tf_logprob_mean_abs"])


def greedy_items(eng, ids, seg, pos, new_tokens):
    """One greedy generate of ``eng`` over left-padded prompts -> (items
    (prompt, tokens, log-probs) per stream, the call's stats)."""
    from realhf_tpu_torch.ops.sampling import GenerationHyperparameters
    out = eng.generate(ids, seg, pos, None, GenerationHyperparameters(
        max_new_tokens=new_tokens, greedy=True), None, 0).to_host()
    items = [(ids[b][seg[b] != 0], out.tokens[b, :int(out.lengths[b])],
              out.logprobs[b, :int(out.lengths[b])])
             for b in range(ids.shape[0])]
    return items, eng.generate_stats[-1]


def decode_record(st, counts, want, smi):
    return dict(decode_steps=st["decode_steps"],
                prefill_secs=st["prefill_secs"],
                decode_secs=st["decode_secs"],
                decode_ms_per_token=st["decode_secs"]
                / max(st["decode_steps"], 1) * 1e3,
                launches=counts, launches_expected=want,
                launches_ok=counts == want, card=smi)


def model_sft_runner(data, layout, seed, model_config, overrides=None,
                     schedule=None):
    """The sft cell (``build_sft_spec``) at ``model_config`` on
    ``layout`` (a pipeline layout under ``schedule`` when given), its
    members on ``member_devices``."""
    from realhf_tpu_torch.parallel.mesh import parse_parallelism
    from realhf_tpu_torch.system.inline import InlineRunner
    spec = build_sft_spec(data, model_config["n_layers"],
                          model_config=model_config, overrides=overrides)
    spec.seed = seed
    par = parse_parallelism(layout)
    if schedule:
        par = dataclasses.replace(par, pipeline_schedule=schedule)
    spec.models["default"].parallel = par
    t0 = time.monotonic()
    runner = InlineRunner(without_saves(spec), role_devices={
        "default": member_devices(par.world_size)})
    sync_all()
    return runner, time.monotonic() - t0


def sft_launches(runner, n_layers, n_mb):
    """K1-K3 counts of the sft cell on a d x t layout (``launches_of``:
    each member's attention half one checkpoint region, so K1 twice a
    layer a train pass, once an eval pass)."""
    n = len(runner.models["default"].engine.members)
    n_eval = len(runner.eval_dataloader) * len(runner.eval_stats)
    return launches_of(n_layers, n, fwd=2 * n_mb * PAR_SFT_STEPS + n_eval,
                       bwd=n_mb * PAR_SFT_STEPS)


def phase_kv_rep(smi, seed=1):
    """``google/gemma-2b`` (8 q heads on one KV head of 256) at d1t2 and
    d1t4, members on ``member_devices``: its KV weights held whole on
    every model member. Generation: full width, ``KV_REP_GEN_LAYERS`` of
    its 18 layers (random weights from ``seed``), gen-7b-b8's prompt
    shape (8 prompts of 100-512 tokens), 64 greedy tokens through the
    "seq" route (each
    member its slice of the cache slots, K4 with statistics, the flash
    merge). Gates per layout: exact K1/K4 counts (K4 with statistics
    once a layer a member a decode step), and the greedy log-probs
    against one packed teacher-forced K1 forward of the d1t1 model of
    the same weights; planted fault: d1t2's tokens regenerated
    (``KV_REP_FAULT_TOKENS``) with member 1's partial dropped from the
    merge. Training: the sft cell's records at ``KV_REP_SFT_LAYERS``
    layers (the depth cut), 3 steps at d1t2 against d1t1 of the same
    seed: loss, grad norm and the masters' update; planted fault: the
    replicated wk/wv gradients not summed over the model members.
    Reported: decode ms a token, peaks, step seconds."""
    from realhf_tpu_torch.api.experiment import ModelSpec
    from realhf_tpu_torch.engine.engine import Engine
    from realhf_tpu_torch.models.transformer import round_cache_len
    from realhf_tpu_torch.ops.decode_attention import seq_cache_len
    from realhf_tpu_torch.parallel.mesh import parse_parallelism
    from realhf_tpu_torch.system.model_host import build_model
    lim = MOE_PAR_LIMITS
    nl = KV_REP_GEN_LAYERS
    mcfg = hf_random_init_config("gemma", GEMMA_2B, nl)
    ref = build_model("default", ModelSpec(random_init_config=mcfg,
                                           bf16=True), None,
                      init_seed=seed).engine
    cfg = ref.cfg
    ids, seg, pos, _ = pp_prompts(seed, cfg.vocab_size)
    rec = dict(n_layers=nl, seed=seed, card=smi, gen={}, limits=lim,
               heads=[cfg.n_q_heads, cfg.n_kv_heads], head_dim=cfg.head_dim)
    launches = []
    for layout in KV_REP_LAYOUTS:
        par = parse_parallelism(layout)
        n = par.world_size
        eng = Engine(cfg, ref.params, parallel=par,
                     devices=member_devices(n))
        reset_peaks(eng.members)
        reset_counts()
        items, st = greedy_items(eng, ids, seg, pos, KV_REP_NEW_TOKENS)
        sync_all()
        counts = read_counts()
        want = launches_of(nl, n, fwd=1, decode=st["decode_steps"])
        want["flash_decode_stats"] = want["flash_decode"]
        r = decode_record(st, counts, want, smi)
        r["cache_slots"] = seq_cache_len(round_cache_len(
            ids.shape[1] + KV_REP_NEW_TOKENS), n)
        r["slots_per_member"] = r["cache_slots"] // n
        r["peak_mem_gb"] = read_peaks(eng.members)
        r["tf"] = tf_gaps(packed_teacher_forced(cfg, ref.params, items)[0],
                          items)
        r["tf_ok"] = not kv_gap_over(r["tf"], lim)
        if layout == KV_REP_LAYOUTS[0]:
            with merge_partial_dropped():
                fitems, _ = greedy_items(eng, ids, seg, pos,
                                         KV_REP_FAULT_TOKENS)
            r["planted_fault"] = dict(merge_partial_dropped=tf_gaps(
                packed_teacher_forced(cfg, ref.params, fitems)[0], fitems))
            r["fault_fails"] = kv_gap_over(
                r["planted_fault"]["merge_partial_dropped"], lim)
        r["ok"] = r["launches_ok"] and r["tf_ok"] and r.get("fault_fails",
                                                            True)
        launches.append(counts)
        rec["gen"][layout] = r
        del eng
        free()
    del ref
    free()
    # training at the depth cut, d1t2 against d1t1
    scfg = hf_random_init_config("gemma", GEMMA_2B, KV_REP_SFT_LAYERS)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "sft.jsonl")
        write_prompt_answers(data, 16, seed=3)
        base, setup = model_sft_runner(data, "d1t1", seed, scfg)
        rec["sft_ref"], rmaster, _ = counted_run(base)
        rec["sft_ref"]["setup_secs"] = setup
        rmaster = to_host(rmaster)
        del base
        free()
        runner, setup = model_sft_runner(data, "d1t2", seed, scfg)
        r, master, _ = counted_run(runner)
        r["setup_secs"] = setup
        r["launches_expected"] = sft_launches(runner, KV_REP_SFT_LAYERS, 2)
        r["launches_ok"] = r["launches"] == r["launches_expected"]
        r["ok"] = held_against(r, rec["sft_ref"], master, rmaster, lim,
                               "kv_sft") and r["launches_ok"]
        launches.append(r["launches"])
        del runner, master
        free()
        frunner, _ = model_sft_runner(data, "d1t2", seed, scfg)
        with kv_grad_not_summed():
            fault, fmaster, _ = counted_run(frunner)
        fault["within_limits"] = held_against(fault, rec["sft_ref"], fmaster,
                                              rmaster, lim, "kv_sft")
        del frunner, fmaster, rmaster
        free()
    r["planted_fault"] = dict(kv_grad_not_summed={
        k: fault[k] for k in ("losses", "grad_norms", "loss_rel",
                              "grad_norm_rel", "update_rel")})
    r["fault_fails"] = not fault["within_limits"]
    r["card"] = smi
    rec["sft"] = r
    rec["sft_layers"] = KV_REP_SFT_LAYERS
    rec["launches"] = add_counts(*launches)
    rec["ok"] = (all(g["ok"] for g in rec["gen"].values()) and r["ok"]
                 and r["fault_fails"])
    return rec


def phase_moe_tp(smi, ref_eng, ref_items):
    """Mixtral-8x7B width at ``MIXTRAL_GEN_LAYERS`` (mixtral_gen's d1t1
    engine ``ref_eng``, its weights waiting on the host while the
    layouts run, so the 46 GB model is never built twice) reallocated to
    d1t2 and d1t4 (members on ``member_devices``): each model member
    holds its slice of every expert's FFN width and the router whole.
    mixtral_gen's greedy prompts (``ref_items``), 64 greedy tokens.
    Gates per layout: exact K1/K4 counts, and the tokens' log-probs
    against one packed teacher-forced K1 forward of the d1t1 engine (the
    mean gap, as mixtral_gen: routings of random weights flip under bf16
    noise); planted fault: d1t2's tokens regenerated with member 1's
    row-parallel partial dropped. Reported: the reallocation's seconds,
    decode ms a token, the group-size host reads a decode step (each
    member's ragged dispatch reads its own), peaks."""
    from realhf_tpu_torch.engine import packing
    from realhf_tpu_torch.engine.engine import Engine
    from realhf_tpu_torch.ops import moe
    from realhf_tpu_torch.parallel.mesh import parse_parallelism
    from realhf_tpu_torch.parallel.realloc import reallocate
    lim = MOE_PAR_LIMITS["moe_tp_tf_logprob_mean_abs"]
    nl = ref_eng.cfg.n_layers
    cfg = ref_eng.cfg
    ids, seg, pos = packing.left_padded_prompts(
        [p for p, *_ in ref_items], 0)
    rec = dict(n_layers=nl, card=smi, layouts={}, limits=MOE_PAR_LIMITS)
    t0 = time.monotonic()
    ref_eng.offload()
    rec["offload_secs"] = time.monotonic() - t0
    runs = {}
    for layout in MOE_TP_LAYOUTS:
        par = parse_parallelism(layout)
        n = par.world_size
        eng = Engine(cfg, None, parallel=par, devices=member_devices(n))
        realloc_secs = reallocate(cfg, ref_eng.params, eng)
        reset_peaks(eng.members)
        reset_counts()
        moe.host_reads = 0
        items, st = greedy_items(eng, ids, seg, pos, MOE_TP_NEW_TOKENS)
        sync_all()
        counts = read_counts()
        reads = moe.host_reads
        want = launches_of(nl, n, fwd=1, decode=st["decode_steps"])
        r = decode_record(st, counts, want, smi)
        r["realloc_secs"] = realloc_secs
        r["peak_mem_gb"] = read_peaks(eng.members)
        r["host_reads_per_prefill"] = nl * n
        r["host_reads_per_decode_step"] = ((reads - nl * n)
                                           / max(st["decode_steps"], 1))
        fitems = None
        if layout == MOE_TP_LAYOUTS[0]:
            with row_partial_dropped():
                fitems, _ = greedy_items(eng, ids, seg, pos,
                                         PAR_FAULT_TOKENS)
        runs[layout] = (r, items, fitems)
        del eng
        free()
    t0 = time.monotonic()
    ref_eng.ensure_on_device()
    rec["onload_secs"] = time.monotonic() - t0
    for layout, (r, items, fitems) in runs.items():
        r["tf"] = tf_gaps(packed_teacher_forced(cfg, ref_eng.params,
                                                items)[0], items)
        r["tf_ok"] = r["tf"]["mean_abs"] <= lim
        if fitems is not None:
            r["planted_fault"] = dict(row_partial_dropped=tf_gaps(
                packed_teacher_forced(cfg, ref_eng.params, fitems)[0],
                fitems))
            r["fault_fails"] = (r["planted_fault"]["row_partial_dropped"]
                                ["mean_abs"] > lim)
        r["ok"] = r["launches_ok"] and r["tf_ok"] and r.get("fault_fails",
                                                            True)
        rec["layouts"][layout] = r
    rec["launches"] = add_counts(*(r["launches"]
                                   for r in rec["layouts"].values()))
    rec["ok"] = all(r["ok"] for r in rec["layouts"].values())
    return rec


def moe_sft_config(layout):
    """mixtral_sft's model (Mixtral-8x7B width, ``MIXTRAL_SFT_LAYERS``)
    as ``layout`` runs it: the ragged dispatch, or for ``d2t2ep`` expert
    parallelism with capacity dispatch at ``MOE_EP_CAPACITY``."""
    mcfg = hf_random_init_config("mixtral", MIXTRAL_8X7B, MIXTRAL_SFT_LAYERS)
    if layout.endswith("ep"):
        mcfg["moe"] = dataclasses.replace(
            mcfg["moe"], capacity_factor=MOE_EP_CAPACITY,
            use_grouped_gemm=False, expert_parallel=True)
    return mcfg


def recorded_train_calls(eng):
    """Keep every ``train_batch`` call's microbatches, loss function and
    weights, in order: the reference replays them."""
    calls = []
    real = eng.train_batch

    def keep(microbatches, loss_fn, loss_weights=None, loss_fn_key=None):
        calls.append((microbatches, loss_fn, loss_weights))
        return real(microbatches, loss_fn, loss_weights)

    eng.train_batch = keep
    return calls


def replayed_reference(cfg, opt_cfg, schedule, start, calls):
    """A d1t1 engine on cuda:0 from the canonical weights ``start`` (a
    host tree) with a layout engine's optimizer settings ``opt_cfg`` and
    ``schedule``, trained on ``calls`` -> the record ``held_against``
    reads (losses, grad norms, aux losses, step seconds, peak, the
    masters' update norm), its fp32 masters, those after the first step
    and the start weights in fp32 (all on the card). The same
    microbatches at the same streams, so the capacity (over the batch's
    tokens) is the layout's."""
    import torch
    from realhf_tpu_torch.engine.engine import Engine, _leaves
    ref = Engine(cfg, start, device="cuda:0", optimizer=opt_cfg,
                 total_train_steps=1)
    ref.optimizer.schedule = schedule
    w0 = [p.detach().float().clone() for p in _leaves(ref.params)]
    torch.cuda.reset_peak_memory_stats(0)
    steps, secs, first = [], [], None
    for mbs, loss_fn, weights in calls:
        torch.cuda.synchronize(0)
        t0 = time.monotonic()
        steps.append(ref.train_batch(mbs, loss_fn, weights))
        torch.cuda.synchronize(0)
        secs.append(time.monotonic() - t0)
        if first is None:
            first = [m.clone() for m in canonical_masters(ref)]
    master = canonical_masters(ref)
    out = dict(losses=[s["loss"] for s in steps],
               grad_norms=[s["grad_norm"] for s in steps],
               aux=[s.get("moe_aux_loss") for s in steps],
               step_secs=secs, update_norm=norm_of_diff(master, w0),
               peak_mem_gb=torch.cuda.max_memory_allocated(0) / 2 ** 30)
    del ref
    free()
    return out, master, first, w0


def norm_of_diff(xs, ys) -> float:
    """|xs - ys| over two lists of tensors (ys moved to xs' devices)."""
    return math.sqrt(sum(float((x - y.to(x.device)).pow(2).sum())
                         for x, y in zip(xs, ys)))


def phase_moe_sft_par(smi, seed=1):
    """mixtral_sft's model and records (Mixtral-8x7B width, 1 layer, the
    16 prompt-answer records, 3 steps, lr 1e-5) through the sft
    experiment at d2t1 (ragged: the router losses over data shards),
    d2t2 with expert parallelism at capacity 1.25 (each data member 4 of
    the 8 experts, each model member half their width; tokens dispatched
    over the whole batch and sent to the experts' owners), and c2
    (ragged, the 16 records as one stream a step: the router losses over
    context shards, K6 and the ring's K2/K3), members on
    ``member_devices``. Each is held against a d1t1 engine of the same
    start weights replaying the same microbatches (``replayed_reference``;
    the same streams, so the same capacity): loss, grad norm, the
    ``moe_aux_loss`` term and the masters' update; exact kernel counts.
    Planted fault: routing per shard (``routing_per_shard``, the port
    before this slice) in a fresh d2t2ep runner's engine, trained on the
    first step's microbatches, must miss the loss, aux or update limit
    (the update of that one step against the reference's first). At c2
    (ragged) the same fault moves only the aux term, by about its sound
    spread (PERF.md, PR 18), so the CPU test holds it there."""
    import torch
    from realhf_tpu_torch.parallel.mesh import parse_parallelism
    lim = MOE_PAR_LIMITS
    rec = dict(n_layers=MIXTRAL_SFT_LAYERS, seed=seed, card=smi, layouts={},
               limits=lim, ep_capacity=MOE_EP_CAPACITY)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "sft.jsonl")
        write_prompt_answers(data, 16, seed=3)
        for layout in MOE_SFT_LAYOUTS:
            lay = layout[:-2] if layout.endswith("ep") else layout
            par = parse_parallelism(lay)
            n_mb = 1 if par.context_parallel_size > 1 else 2
            over = {"n_mbs": str(n_mb)}
            mcfg = moe_sft_config(layout)
            runner, setup = model_sft_runner(data, lay, seed, mcfg, over)
            eng = runner.models["default"].engine
            start = _tree_map(lambda a: a.detach().clone(),
                              eng.gathered_params("cpu"))
            calls = recorded_train_calls(eng)
            r, master, mbs = counted_run(runner)
            r["setup_secs"] = setup
            r["aux"] = [s.get("moe_aux_loss") for s in sft_steps(runner)]
            r["stream_lens"] = [int(mb["seg_ids"].shape[1]) for mb in mbs]
            n_eval = len(runner.eval_dataloader) * len(runner.eval_stats)
            if par.context_parallel_size > 1:
                want = cp_launches(MIXTRAL_SFT_LAYERS, 1, 2,
                                   train_passes=PAR_SFT_STEPS,
                                   infer_passes=n_eval)
            else:
                want = sft_launches(runner, MIXTRAL_SFT_LAYERS, n_mb)
            r["launches_expected"] = want
            r["launches_ok"] = r["launches"] == want
            cfg, opt = eng.cfg, (eng.optimizer.cfg, eng.optimizer.schedule)
            # the layout's masters wait on the host while the reference
            # trains (the card then holds one engine and two master sets)
            master = to_host(master)
            del runner, eng, mbs
            free()
            r["mem_gb_before_ref"] = torch.cuda.memory_allocated(0) / 2 ** 30
            ref, rmaster, rfirst, w0 = replayed_reference(cfg, *opt, start,
                                                          calls)
            first_call = calls[0]
            del calls, start
            r["ref"] = ref
            master = [m.to(rmaster[0].device) for m in master]
            ok = held_against(r, ref, master, rmaster, lim, "moe_sft")
            del master, rmaster
            free()
            r["aux_rel"] = max(abs(a - b) / abs(b)
                               for a, b in zip(r["aux"], ref["aux"]))
            r["ok"] = (ok and r["aux_rel"] <= lim["moe_sft_aux_rel"]
                       and r["launches_ok"])
            if layout == "d2t2ep":
                frunner, _ = model_sft_runner(data, lay, seed, mcfg, over)
                feng = frunner.models["default"].engine
                with routing_per_shard():
                    fst = feng.train_batch(*first_call)
                upd = norm_of_diff(canonical_masters(feng), rfirst)
                del frunner, feng
                free()
                f = dict(loss=fst["loss"], aux=fst.get("moe_aux_loss"),
                         loss_rel=abs(fst["loss"] - ref["losses"][0])
                         / abs(ref["losses"][0]),
                         aux_rel=abs(fst["moe_aux_loss"] - ref["aux"][0])
                         / abs(ref["aux"][0]),
                         update_rel=upd / norm_of_diff(rfirst, w0))
                r["planted_fault"] = dict(routing_per_shard=f)
                r["fault_fails"] = (f["loss_rel"] > lim["moe_sft_loss_rel"]
                                    or f["aux_rel"] > lim["moe_sft_aux_rel"]
                                    or f["update_rel"]
                                    > lim["moe_sft_update_rel"])
                r["ok"] &= r["fault_fails"]
            r["card"] = smi
            rec["layouts"][layout] = r
            del rfirst, w0, first_call
            free()
    rec["launches"] = add_counts(*(r["launches"]
                                   for r in rec["layouts"].values()))
    rec["ok"] = all(r["ok"] for r in rec["layouts"].values())
    return rec


MOE_PAR_PHASES = (("kv_rep", phase_kv_rep),
                  ("moe_sft_par", phase_moe_sft_par))


def run_moe_par_phases(smi):
    """kv_rep and moe_sft_par (moe_tp runs in ``run_moe_phases``), each
    freeing its models before the next."""
    recs = {}
    for name, fn in MOE_PAR_PHASES:
        t0 = time.monotonic()
        recs[name] = fn(smi)
        recs[name]["phase_secs"] = time.monotonic() - t0
        free()
        emit(name, **recs[name])
    return recs


def seq_kernel_cases(gen, lengths):
    """K4 with statistics at the Gemma-2B "seq" route's slices (B 8, 8 q
    heads on 1 KV head of 256): the gen traffic's 640-slot cache split in
    two (slice 0 of 320 slots, where short prompts leave streams empty,
    and slice 1) and a 768-slot cache in four (slice 1 of 192), each
    held against the plain version: o, m and l; slice 0 timed."""
    recs = []
    for name, S_all, t, j, timed in (("t2_slice0", 640, 2, 0, True),
                                     ("t2_slice1", 640, 2, 1, False),
                                     ("t4_slice1", 768, 4, 1, False)):
        s = S_all // t
        lo = j * s
        spans = []
        for i, n in enumerate(lengths):
            a, b = max(512 - n, lo), min(512 + 64, lo + s)
            spans.append((a - lo, b - lo) if a < b and i != 5 else (0, 0))
        r = check_flash_decode(f"gemma2b_seq_{name}_hd256", 8, s, 8, 1, 256,
                               spans, gen, timed=timed)
        r["kernel"] = "flash_decode_seq"
        r["empty_streams"] = sum(sp == (0, 0) for sp in spans)
        recs.append(r)
    return recs


def phase_mixtral_full_d1t4(smi, seed=1, new_tokens=64):
    """Mixtral-8x7B at its full 32 layers (46.7 B parameters, 93 GB in
    bf16: more than one card) at d1t4, one member a card: random weights
    drawn on each member from ``seed`` as ``init_params`` draws them (std
    0.02, the output projections 0.02 / sqrt(2 n_layers), norm scales
    1; a replicated leaf the same on every member), then mixtral_gen's prompt shape (8 prompts of 100-512 tokens) and
    ``new_tokens`` greedy tokens. Gates: exact K1/K4 counts, and the
    greedy log-probs against one packed teacher-forced K1 forward of the
    same engine (the mean gap, ``MOE_LIMITS``). Reported: the peak a
    card, decode ms a token, the host reads a decode step, and the
    shortest stream's first 16 tokens against the plain bf16 forward on
    the host (the weights gathered there)."""
    import torch
    from realhf_tpu_torch.base import seeding
    from realhf_tpu_torch.engine.engine import Engine
    from realhf_tpu_torch.models import sharding
    from realhf_tpu_torch.models.config import TransformerConfig
    from realhf_tpu_torch.ops import moe
    from realhf_tpu_torch.parallel.mesh import parse_parallelism
    nl = MIXTRAL_8X7B["num_hidden_layers"]
    cfg = TransformerConfig(**hf_random_init_config("mixtral", MIXTRAL_8X7B,
                                                    nl))
    cfg.param_dtype = cfg.compute_dtype = "bfloat16"
    t0 = time.monotonic()
    eng = Engine(cfg, None, parallel=parse_parallelism("d1t4"),
                 devices=member_devices(4))
    proj_std = 0.02 / (2 * nl) ** 0.5  # init_params' output projections
    specs = {".".join(path): spec
             for path, spec in sharding.flat_specs(cfg, 4)}
    with torch.no_grad():
        for i in eng.units:
            # a replicated leaf (the router) draws the same values on
            # every member, a split one its own
            rep = seeding.generator(seed, eng.members[i])
            own = seeding.generator(seed + 1 + i, eng.members[i])
            for path, leaf in named_leaves(eng.params.trees[i]):
                if path.endswith("scale"):
                    leaf.fill_(1.0)
                    continue
                gen = own if sharding.split_dim(specs[path]) is not None \
                    else rep
                leaf.normal_(0.0, proj_std if path.endswith(
                    ("attn.wo", "mlp.wd")) else 0.02, generator=gen)
    sync_all()
    init_secs = time.monotonic() - t0
    ids, seg, pos, _ = pp_prompts(seed, cfg.vocab_size)
    reset_peaks(eng.members)
    reset_counts()
    moe.host_reads = 0
    items, st = greedy_items(eng, ids, seg, pos, new_tokens)
    sync_all()
    counts = read_counts()
    reads = moe.host_reads
    want = launches_of(nl, 4, fwd=1, decode=st["decode_steps"])
    r = decode_record(st, counts, want, smi)
    r.update(n_layers=nl, init_secs=init_secs,
             n_params=sum(t.numel() for i in eng.units
                          for t in _tree_leaves(eng.params.trees[i])),
             members=[str(d) for d in eng.members],
             peak_mem_gb=read_peaks(eng.members),
             host_reads_per_decode_step=(reads - nl * 4)
             / max(st["decode_steps"], 1))
    r["tf_self"] = tf_gaps(packed_teacher_forced(cfg, eng.params,
                                                 items)[0], items)
    sub = [min(((p, t[:16], lp[:16]) for p, t, lp in items),
               key=lambda it: len(it[0]))]
    t0 = time.monotonic()
    host = eng.gathered_params("cpu")
    r["tf_host"] = tf_gaps(packed_teacher_forced(cfg, host, sub)[0], sub)
    r["tf_host_secs"] = time.monotonic() - t0
    r["ok"] = (r["launches_ok"] and r["tf_self"]["mean_abs"]
               <= MOE_LIMITS["gen_tf_logprob_mean_abs"])
    del eng, host
    free()
    return r


# ----------------------------------------------------------------------
# phases 47-50: hd 256 on the ring (Gemma-2B at c > 1: K6 and the ring's
# K2/K3 at hd 256), MoE inside pipeline stages (Mixtral-8x7B width at
# d1t2p2; its training at d2p2 with expert parallelism on four cards),
# and sequence parallelism with pipeline parallelism (7B width)
# ----------------------------------------------------------------------
#: depth cut (the script's time): Gemma-2B trains 4 of its 18 layers at
#: each context layout; every layer runs the same ring
CP_GEMMA_LAYERS = 4
CP_GEMMA_LAYOUTS = ("c2", "c4", "d1t2c2")
#: about 3x the largest sound reading of ``scripts/torch_cp_phases.py
#: --phases cp_gemma --seeds 1 2 3 4 5`` (H100 80GB HBM3, 700 W; PERF.md,
#: Findings): c2, c4 and d1t2c2 against d1t1 over 3 steps, loss
#: 8.6e-5-1.87e-4, grad norm 3.09e-3-4.27e-3 relative (K6's and the ring
#: K2/K3's bf16 sums in another order than K1's and K2/K3's), the masters'
#: update 0.0019-0.0032; c4's log-probs against d1t1 of its weights
#: 0.084-0.100, with direction 1's key offset one tile off 5.3-8.1
CP_GEMMA_LIMITS = dict(cp_gemma_loss_rel=5.6e-4, cp_gemma_grad_norm_rel=0.013,
                       cp_gemma_update_rel=0.0096,
                       cp_gemma_logprobs_abs=0.3)
#: the pipelined MoE forward: mixtral_gen's engine moved to this layout
MOE_PP_LAYOUT = "d1t2p2"
#: its training on four cards (``scripts/torch_moe_par_phases.py
#: --phases moe_pp_train``): Mixtral width at 2 layers, d2p2 with
#: expert parallelism under GPipe, against p2 (d1t1p2) replaying the
#: same microbatches
MOE_PP_TRAIN_LAYERS = 2
#: moe_pp: about 3x the largest sound mean gap of
#: ``scripts/torch_moe_par_phases.py --phases moe_pp --seeds 1 2 3 4 5``
#: (H100 80GB HBM3, 700 W): d1t2p2's pipelined forward against d1t1's,
#: both teacher-forced, 0.51-0.62 (max 5.2-7.5: random experts' near-tie
#: routings flip under bf16 order, as in mixtral_gen); a stage's output
#: handed to microbatch m - 1 4.70-4.79. Against d1t2 run on the same
#: microbatches (the same members' arithmetic on the same rows):
#: bit-equal on every seed, so the limit is 0; router logits rounded to
#: bf16 4.5-7.3 (max; against d1t1 its mean 0.48-0.62 passes that gate),
#: the stage output to m - 1 8.6-9.6. The generation through the d2t2
#: view at 4 layers, against d1t1 of those layers: mean gap 0.072-0.089
#: (max 2.8-5.2), member 1's row-parallel partial dropped 4.67-4.98.
#: moe_pp_train, about 3x the
#: largest of ``--phases moe_pp_train --seeds 1 2 3 4 5`` on four cards:
#: d2p2ep against p2 loss 1.09e-4-3.72e-4, grad norm 1.29e-3-3.46e-3,
#: the update 0.0235-0.0287, aux 5.0e-4-2.44e-3 (relative); the first
#: stage's router sums dropped 0.53-0.57 on the aux
MOE_PP_LIMITS = dict(moe_pp_tf_logprob_mean_abs=1.85,
                     moe_pp_tp_logprob_max_abs=0.0,
                     moe_pp_gen_tf_logprob_mean_abs=0.27,
                     moe_pp_train_loss_rel=1.1e-3,
                     moe_pp_train_grad_norm_rel=0.0104,
                     moe_pp_train_update_rel=0.086,
                     moe_pp_train_aux_rel=7.3e-3)
#: depth cut of moe_pp's generation: the decode view of d1t2p2 over one
#: card's four members is d2t2, two copies of the model; at
#: mixtral_gen's 16 layers the engine (46 GB) and its view (92 GB) fit
#: on no card, and at 8 they leave too little for the move's leaf in
#: flight (7.5 GB); at 4 layers the engine takes 12 GB and the view 24
MOE_PP_VIEW_LAYERS = 4
MOE_PP_NEW_TOKENS = 64
#: each sequence-parallel pipeline layout and the layout without ``s``
SP_PP_LAYOUTS = (("t2p2s", "t2p2"), ("d2t2p2s", "d2t2p2"))
#: depth cut (the script's time): sp_pp trains 2 layers, one a stage;
#: every layer runs the same sequence-parallel block
SP_PP_LAYERS = 2


@contextlib.contextmanager
def one_direction_k_off_one_tile_off():
    """The planted hd 256 ring fault: K6 takes direction 1's KV half at a
    global offset 64 keys (one tile) later than it lies (the causal test
    and the tile marks on wrong positions)."""
    from realhf_tpu_torch.ops import ring_attention_fused as rf
    real = rf.round_key_offsets

    def shifted(member, rnd, n, lc, lch, n_dirs):
        offs = list(real(member, rnd, n, lc, lch, n_dirs))
        offs[-1] += 64 if n_dirs == 2 else 0
        return offs

    with patched(rf, "round_key_offsets", shifted):
        yield


def phase_cp_gemma(smi, seed=1):
    """Gemma-2B (google/gemma-2b: 8 q heads on one KV head of 256, vocab
    256000) at ``CP_GEMMA_LAYERS`` layers through ``cp_phase`` at c2, c4
    and d1t2c2 (the KV head replicated over t, each member's ring
    carrying it; K6 and the ring's K2/K3 at hd 256), on
    ``CP_GEMMA_LIMITS``; c4's log-probs with K6 taking direction 1's key
    offset one tile off must miss."""
    return cp_phase(smi, seed,
                    hf_random_init_config("gemma", GEMMA_2B, CP_GEMMA_LAYERS),
                    CP_GEMMA_LAYERS, CP_GEMMA_LAYOUTS, CP_GEMMA_LIMITS,
                    "cp_gemma", one_direction_k_off_one_tile_off)


#: cp_gemma's ring shards that K6, its lse and the ring's K2/K3 at hd 256
#: are held at: (layout, members a ring, q heads, KV heads of a member);
#: the wide K2/K3 size their tile marks by the shard's length
CP_GEMMA_KERNEL_SHARDS = (("c4", 4, 8, 1), ("c2", 2, 8, 1),
                          ("d1t2c2", 2, 4, 1))


def phase_kernels_cp_hd256(segs):
    """K6 and the ring's K2/K3 at hd 256 against their plain versions
    at each of cp_gemma's shard shapes (``CP_GEMMA_KERNEL_SHARDS``: B 1,
    lc 4096 with Gemma-2B's 8/1 heads at c4, lc 8192 with 8/1 at c2 and
    4/1, a model member's q heads on the replicated KV head, at
    d1t2c2), each on the stream that layout trained on (``segs``:
    layout -> its streams): one whole ring, K6's lse over the stream,
    K2/K3 at the diagonal round of shard i and at the round of shard i
    against shard i - 1 with the k_off fault, i the first shard a record
    crosses into (shard 1 when none does); the c4 cases timed. Then one
    ring over five documents of 16384 tokens at Gemma-7B's heads (16/16;
    timed, with the planted faults: the first document crosses shard 1,
    so member 1's round 1 has keys to see, which a training stream need
    not give), and small cases (GQA 8/1 with ragged tiles and a padding
    row, a window of 300, ids recurring across shards). Returns (K6
    records, K2/K3 records), each marked ``hd256``."""
    import numpy as np
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    rng = np.random.default_rng(19)
    k6, bwd = [], []
    for layout, n, nq, nkv in CP_GEMMA_KERNEL_SHARDS:
        timed = layout == "c4"
        seg = torch.as_tensor(segs[layout][0], dtype=torch.int32,
                              device="cuda")
        lc = seg.shape[1] // n
        k6.append(check_ring(f"cp_gemma_{layout}_hd256", 1, n, nq, nkv, 256,
                             seg, gen, timed=timed))
        i = next((j for j in range(1, n) if seg[0, j * lc] != 0
                  and seg[0, j * lc - 1] == seg[0, j * lc]), 1)
        inputs = cp_round_inputs(seg, n, gen, nq=nq, hd=256, nkv=nkv)
        bwd += [check_ring_bwd_round(
                    f"cp_gemma_{layout}_shard{i}_diagonal_hd256", inputs,
                    seg, n, i, i, timed=timed),
                check_ring_bwd_round(
                    f"cp_gemma_{layout}_shard{i}_keys{i - 1}_hd256", inputs,
                    seg, n, i, i - 1, plant_fault=True)]
        del inputs
        torch.cuda.empty_cache()
        k6.append(check_ring_lse(f"cp_gemma_{layout}_hd256", seg, n, gen,
                                 nq=nq, hd=256, nkv=nkv))
        del seg
        torch.cuda.empty_cache()
    docs = doc_stream_seg((6144, 4096, 3072, 2048, 768), 256, "cuda")
    k6 += [check_ring("docs_c4_gemma7b_hd256", 1, 4, 16, 16, 256, docs, gen,
                      timed=True, plant_faults=True),
           check_ring("gqa_8_1_ragged_hd256", 3, 4, 8, 1, 256,
                      packed_seg(rng, 3, 800, 4, {1}, "cuda"), gen),
           check_ring("window_300_hd256", 2, 4, 8, 2, 256,
                      packed_seg(rng, 2, 2048, 3, set(), "cuda"), gen,
                      window=300),
           check_ring("recurring_ids_hd256", 2, 4, 8, 8, 256,
                      recurring_seg(rng, 2, 2048, "cuda"), gen)]
    for r in k6 + bwd:
        r["hd256"] = True
    del gen
    torch.cuda.empty_cache()
    return k6, bwd


def moe_pp_batch(items):
    """mixtral_gen's greedy streams (prompt, then its tokens) as one
    right-padded batch -> (ids, seg, the token positions of each)."""
    import numpy as np
    seqs = [np.concatenate([p, t]) for p, t, *_ in items]
    width = max(len(x) for x in seqs)
    ids = np.zeros((len(seqs), width), np.int64)
    seg = np.zeros((len(seqs), width), np.int32)
    at = []
    for b, ((p, t, *_), x) in enumerate(zip(items, seqs)):
        ids[b, :len(x)], seg[b, :len(x)] = x, 1
        at.append(slice(len(p) - 1, len(p) - 1 + len(t)))
    return ids, seg, at


@contextlib.contextmanager
def router_logits_in_bf16():
    """The small planted pipelined-MoE fault: every MoE layer takes its
    top-2 from router logits rounded to bf16 (the near-tie routings flip
    and the gates move by bf16's rounding, as a capacity or queue
    position slip would move a few tokens)."""
    from realhf_tpu_torch.ops import moe
    real = moe.router_probs

    def rounded(cfg_moe, logits):
        return real(cfg_moe, logits.bfloat16().float())

    with patched(moe, "router_probs", rounded):
        yield


def first_layers(tree, n):
    """A model tree with its first ``n`` layers (views of its block
    leaves)."""
    def narrow(t):
        return {k: narrow(v) if isinstance(v, dict) else v[:n]
                for k, v in t.items()}

    return dict(tree, blocks=narrow(tree["blocks"]))


def phase_moe_pp(smi, ref_eng, ref_items):
    """Mixtral-8x7B width at ``MIXTRAL_GEN_LAYERS`` (mixtral_gen's d1t1
    engine ``ref_eng``, its weights on the host while the layouts run)
    moved to ``MOE_PP_LAYOUT`` (two stages of two model members, MoE at
    t2 inside each stage: each member's slice of every expert's width,
    one routing per microbatch). mixtral_gen's 8 greedy streams, prompt
    and tokens, through the pipelined GPipe forward (M 4, 2 streams a
    microbatch) -> the tokens' log-probs, held against d1t2 (the same
    model members' arithmetic without stages) run on each microbatch's
    rows on the max gap (``moe_pp_tp_logprob_max_abs``), and against
    ``ref_eng``'s K1 forward of the whole batch on the mean gap (both
    teacher-forced: bf16 order and routing flips only). Gates: those
    gaps, exact K1 counts (``pipeline_launches``); planted faults, each
    of which must miss the d1t2 limit: each stage's output handed to the
    next stage's microbatch m - 1 (also the d1t1 limit), and the router
    logits rounded to bf16. Then generation through the layout's decode
    view (d2t2 over the same four members) at the first
    ``MOE_PP_VIEW_LAYERS`` layers (the depth cut): mixtral_gen's
    prompts, ``MOE_PP_NEW_TOKENS`` greedy tokens, exact K1/K4 counts on
    the view's members, the tokens' log-probs against one packed
    teacher-forced K1 forward of the d1t1 model of those layers on the
    mean gap; the view's member 1 of each group with its row-parallel
    partial dropped must miss it. Reported: the moves' seconds, the
    forward's seconds, the view's build ms and decode ms a token,
    peaks."""
    import dataclasses
    import numpy as np
    from realhf_tpu_torch.engine.engine import Engine
    from realhf_tpu_torch.parallel.mesh import parse_parallelism
    from realhf_tpu_torch.parallel.realloc import reallocate
    lim = MOE_PP_LIMITS
    cfg, nl = ref_eng.cfg, ref_eng.cfg.n_layers
    ids, seg, at = moe_pp_batch(ref_items)
    keep = np.zeros(seg.shape, bool)
    for b, sl in enumerate(at):
        keep[b, sl] = True
    want = ref_eng.forward_logprobs(ids, seg).cpu().numpy()
    ref_eng.offload()
    par = dataclasses.replace(parse_parallelism(MOE_PP_LAYOUT),
                              pipeline_schedule="gpipe")
    eng = Engine(cfg, None, parallel=par, devices=member_devices(4))
    rec = dict(layout=MOE_PP_LAYOUT, n_layers=nl, card=smi,
               limits=MOE_PP_LIMITS, streams=int(ids.shape[0]),
               tokens=int(keep.sum()))
    rec["realloc_secs"] = reallocate(cfg, ref_eng.params, eng)
    reset_peaks(eng.members)
    reset_counts()
    t0 = time.monotonic()
    got = eng.forward_logprobs(ids, seg).cpu().numpy()
    sync_all()
    rec["forward_secs"] = time.monotonic() - t0
    rec["launches"] = read_counts()
    n_mb = eng.pipeline_ctx_infer.n_microbatches
    rec["launches_expected"] = pipeline_launches(
        nl, par.tensor_parallel_size, n_mb, infer_passes=1)
    rec["launches_ok"] = rec["launches"] == rec["launches_expected"]
    rec["peak_mem_gb"] = read_peaks(eng.members)
    faults = {}
    with output_to_previous_microbatch():
        faults["output_to_previous_microbatch"] = eng.forward_logprobs(
            ids, seg).cpu().numpy()
    with router_logits_in_bf16():
        faults["router_logits_in_bf16"] = eng.forward_logprobs(
            ids, seg).cpu().numpy()
    del eng
    free()
    # d1t2 on the pipeline's microbatches: rows [m Bm, (m + 1) Bm)
    tp = Engine(cfg, None, parallel=parse_parallelism("d1t2"),
                devices=member_devices(2))
    rec["tp_realloc_secs"] = reallocate(cfg, ref_eng.params, tp)
    bm = -(-ids.shape[0] // n_mb)
    tp_want = np.concatenate([
        tp.forward_logprobs(ids[r:r + bm], seg[r:r + bm]).cpu().numpy()
        for r in range(0, ids.shape[0], bm)])
    del tp
    free()

    def gaps(a, b):
        g = np.abs(a - b)[keep]
        return dict(max_abs=float(g.max()), mean_abs=float(g.mean()),
                    tokens=int(g.size))

    rec["tf"] = gaps(got, want)
    rec["tp"] = gaps(got, tp_want)
    rec["tp_bit_equal"] = bool(np.array_equal(got[keep], tp_want[keep]))
    rec["planted_fault"] = {k: dict(tp=gaps(v, tp_want), tf=gaps(v, want))
                            for k, v in faults.items()}
    tp_lim = lim["moe_pp_tp_logprob_max_abs"]
    rec["faults_fail"] = all(f["tp"]["max_abs"] > tp_lim
                             for f in rec["planted_fault"].values())
    rec["ok"] = (rec["launches_ok"] and rec["faults_fail"]
                 and rec["tp"]["max_abs"] <= tp_lim
                 and rec["tf"]["mean_abs"] <= lim["moe_pp_tf_logprob_mean_abs"]
                 < rec["planted_fault"]["output_to_previous_microbatch"][
                     "tf"]["mean_abs"])
    rec["gen"] = moe_pp_view_gen(smi, ref_eng, ref_items, par)
    rec["launches"] = add_counts(rec["launches"], rec["gen"]["launches"])
    rec["launches_expected"] = add_counts(rec["launches_expected"],
                                          rec["gen"]["launches_expected"])
    rec["ok"] &= rec["gen"]["ok"]
    return rec


def moe_pp_view_gen(smi, ref_eng, ref_items, par):
    """moe_pp's generation: the first ``MOE_PP_VIEW_LAYERS`` layers of
    ``ref_eng``'s host weights on a ``par`` engine, ``MOE_PP_NEW_TOKENS``
    greedy tokens through its decode view, then ``ref_eng`` back on the
    card for the teacher-forced pass (``phase_moe_pp``)."""
    import dataclasses
    from realhf_tpu_torch.engine import packing
    from realhf_tpu_torch.engine.engine import Engine
    from realhf_tpu_torch.parallel.realloc import reallocate
    lim = MOE_PP_LIMITS["moe_pp_gen_tf_logprob_mean_abs"]
    nl = MOE_PP_VIEW_LAYERS
    cfg = dataclasses.replace(ref_eng.cfg, n_layers=nl)
    ids, seg, pos = packing.left_padded_prompts(
        [p for p, *_ in ref_items], 0)
    eng = Engine(cfg, None, parallel=par, devices=member_devices(4))
    r = dict(n_layers=nl, new_tokens=MOE_PP_NEW_TOKENS,
             limit=lim, realloc_secs=reallocate(
                 cfg, first_layers(ref_eng.params, nl), eng))
    reset_peaks(eng.members)
    view, build_ms, st, items, counts = view_generate(
        eng, ids, seg, pos, MOE_PP_NEW_TOKENS)
    want = launches_of(nl, len(view.members), fwd=1,
                       decode=st["decode_steps"])
    r.update(decode_record(st, counts, want, smi), view=str(view.parallel),
             view_build_ms=build_ms, peak_mem_gb=read_peaks(eng.members))
    with row_partial_dropped():
        fitems = view_generate(eng, ids, seg, pos, PAR_FAULT_TOKENS)[3]
    del view, eng
    free()
    ref_eng.ensure_on_device()
    tree = first_layers(ref_eng.params, nl)
    r["tf"] = tf_gaps(packed_teacher_forced(cfg, tree, items)[0], items)
    r["planted_fault"] = dict(row_partial_dropped=tf_gaps(
        packed_teacher_forced(cfg, tree, fitems)[0], fitems))
    r["fault_fails"] = (r["planted_fault"]["row_partial_dropped"]
                        ["mean_abs"] > lim)
    r["ok"] = (r["launches_ok"] and r["fault_fails"]
               and r["tf"]["mean_abs"] <= lim)
    return r


@contextlib.contextmanager
def stage_router_sums_dropped():
    """The planted pipelined-MoE fault: the first stage's router sums are
    left out of the microbatches' router losses."""
    from realhf_tpu_torch.ops import moe
    real = moe.MoEShards.layer_sums

    def dropped(self, layers, key):
        return {} if layers[0] == 0 else real(self, layers, key)

    with patched(moe.MoEShards, "layer_sums", dropped):
        yield


def phase_moe_pp_train(smi, seed=1):
    """Four cards: Mixtral-8x7B width at ``MOE_PP_TRAIN_LAYERS`` layers
    (no card holds it with its optimizer state), the sft experiment (16
    records, 2 microbatches, 3 steps) at d2p2 under GPipe with expert
    parallelism at capacity ``MOE_EP_CAPACITY`` (each stage's data
    members 4 of the 8 experts each; every microbatch routed over both
    data groups' rows), against p2 (d1t1p2, GPipe, the same microbatch
    count) replaying the same microbatches from the same weights: the
    pipelined microbatches, their capacity and router losses are the
    same, and experts over d and data groups move no number. Gates:
    loss, grad norm, ``moe_aux_loss``, the masters' update
    (``MOE_PP_LIMITS``); planted fault: a fresh runner's first step with
    the first stage's router sums dropped must miss the aux limit."""
    import dataclasses
    from realhf_tpu_torch.engine.engine import Engine
    from realhf_tpu_torch.parallel.mesh import parse_parallelism
    lim = MOE_PP_LIMITS
    mcfg = hf_random_init_config("mixtral", MIXTRAL_8X7B,
                                 MOE_PP_TRAIN_LAYERS)
    mcfg["moe"] = dataclasses.replace(
        mcfg["moe"], capacity_factor=MOE_EP_CAPACITY, use_grouped_gemm=False,
        expert_parallel=True)
    rec = dict(n_layers=MOE_PP_TRAIN_LAYERS, seed=seed, card=smi,
               limits=lim, layout="d2p2ep", reference="p2")
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "sft.jsonl")
        write_prompt_answers(data, 16, seed=3)
        runner, setup = model_sft_runner(data, "d2p2", seed, mcfg,
                                         {"n_mbs": "2"}, schedule="gpipe")
        eng = runner.models["default"].engine
        start = _tree_map(lambda a: a.detach().clone(),
                          eng.gathered_params("cpu"))
        calls = recorded_train_calls(eng)
        r, master, _ = counted_run(runner)
        r["setup_secs"] = setup
        r["aux"] = [st.get("moe_aux_loss") for st in sft_steps(runner)]
        cfg, opt_cfg = eng.cfg, eng.optimizer.cfg
        schedule = eng.optimizer.schedule
        n_mb = eng.pipeline_ctx.n_microbatches
        master = to_host(master)
        del runner, eng
        free()
        par = dataclasses.replace(parse_parallelism("p2"),
                                  pipeline_schedule="gpipe",
                                  pipeline_microbatches=n_mb)
        ref = Engine(cfg, start, parallel=par, devices=member_devices(2),
                     optimizer=opt_cfg, total_train_steps=1)
        ref.optimizer.schedule = schedule
        w0 = [m.clone() for m in canonical_masters(ref)]
        steps, secs = [], []
        for mbs, loss_fn, weights in calls:
            sync_all()
            t0 = time.monotonic()
            steps.append(ref.train_batch(mbs, loss_fn, weights))
            sync_all()
            secs.append(time.monotonic() - t0)
        rmaster = canonical_masters(ref)
        rref = dict(losses=[st["loss"] for st in steps],
                    grad_norms=[st["grad_norm"] for st in steps],
                    aux=[st.get("moe_aux_loss") for st in steps],
                    step_secs=secs, update_norm=norm_of_diff(rmaster, w0),
                    peak_mem_gb=max(read_peaks(ref.members).values()))
        del ref
        free()
        master = [m.to(rmaster[0].device) for m in master]
        ok = held_against(r, rref, master, rmaster, lim, "moe_pp_train")
        r["aux_rel"] = max(abs(a - b) / abs(b)
                           for a, b in zip(r["aux"], rref["aux"]))
        r["ok"] = ok and r["aux_rel"] <= lim["moe_pp_train_aux_rel"]
        r["ref"] = rref
        del master, rmaster, w0
        free()
        frunner, _ = model_sft_runner(data, "d2p2", seed, mcfg,
                                      {"n_mbs": "2"}, schedule="gpipe")
        feng = frunner.models["default"].engine
        with stage_router_sums_dropped():
            fst = feng.train_batch(*calls[0])
        del frunner, feng, calls
        free()
    f = dict(aux=fst.get("moe_aux_loss"),
             aux_rel=abs(fst["moe_aux_loss"] - rref["aux"][0])
             / abs(rref["aux"][0]))
    rec.update(r)
    rec["planted_fault"] = dict(stage_router_sums_dropped=f)
    rec["fault_fails"] = f["aux_rel"] > lim["moe_pp_train_aux_rel"]
    rec["ok"] = r["ok"] and rec["fault_fails"]
    return rec


def phase_sp_pp(smi, seed=1):
    """``sp_phase`` at t2p2s and d2t2p2s (1F1B, M 8: the stage boundary
    passes each model member's token shard) against t2p2 and d2t2p2,
    ``SP_PP_LAYERS`` layers. Exact K1-K3 counts (``pipeline_launches``
    over the d x t members of a stage)."""
    def launches(runner, eng):
        n_eval = len(runner.eval_dataloader) * len(runner.eval_stats)
        par = eng.parallel
        return pipeline_launches(
            SP_PP_LAYERS, par.data_parallel_size * par.tensor_parallel_size,
            eng.pipeline_ctx.n_microbatches, train_passes=2 * PAR_SFT_STEPS,
            infer_passes=n_eval)

    return sp_phase(smi, seed, SP_PP_LAYOUTS, SP_PP_LAYERS, launches)


def run_ring_pp_phases(smi):
    """cp_gemma, then K6 and the ring's K2/K3 at hd 256 at each of its
    layouts' shards (``phase_kernels_cp_hd256``), then sp_pp, each
    freeing its models
    before the next (moe_pp runs in ``run_moe_phases``). Returns the
    records and the kernel records."""
    recs = {}
    t0 = time.monotonic()
    recs["cp_gemma"] = phase_cp_gemma(smi)
    recs["cp_gemma"]["phase_secs"] = time.monotonic() - t0
    segs = recs["cp_gemma"].pop("_segs")
    emit("cp_gemma", **recs["cp_gemma"])
    ring256, bwd256 = phase_kernels_cp_hd256(segs)
    t0 = time.monotonic()
    recs["sp_pp"] = phase_sp_pp(smi)
    recs["sp_pp"]["phase_secs"] = time.monotonic() - t0
    free()
    emit("sp_pp", **recs["sp_pp"])
    return recs, ring256, bwd256


def kernels_line(kernel_recs, bwd_recs, ring_recs, paths, hd256_paths,
                 cp_bwd_recs, cp_lse_recs, ring_hd256_recs,
                 cp_bwd_hd256_recs):
    """One row per kernel, and one per kernel at hd 256 (``_hd256``: its
    own instantiation, or its own kernel for K2/K3, timed on the hd 256
    cases). ``launches`` sums the kernel's counts over the paths at hd
    64 and 128 (gen, deep, sft, the two ppo steps, ctx, ppo_ctx, rw,
    dpo, grpo, reinforce, agentic, profile_exp, ckpt_gen's load,
    ckpt_resume's resumed step, serve_gen, the four serve
    configurations, the four serve_par configurations, serve_gen_view's
    two cases, mixtral_gen, mixtral_sft, mistral, gpt2_gen, tp_gen,
    tp_sft, par_ppo, pp_sft, pp_gen, pp_ppo, cp_sft and sp_sft), each
    counted from 0 just before its path and read just after it; an
    ``_hd256`` row sums the hd 256 paths (gemma_gen, gemma_sft, kv_rep,
    cp_gemma and serve_rep). The
    ``_ring`` rows are K2/K3 launched at a ring round (a round of the
    ring's backward, timed at cp_sft's c4 rounds) and
    ``ring_attention_lse`` K6's last round with the lse output; the
    ``_ring_hd256`` rows and ``ring_attention_hd256`` are the same at hd
    256, timed at cp_gemma's c4 stream, their launches from the hd 256
    paths (cp_gemma among them)."""
    def sums(ps):
        keys = dict.fromkeys(k for p in ps for k in p["launches"])
        return {k: sum(p["launches"].get(k, 0) for p in ps) for k in keys}

    def fwd_row(name, src, replaces, wide, counts):
        recs = [r for r in kernel_recs
                if r["kernel"] == name and r.get("hd256", False) == wide]
        t = next(r for r in recs if "ms" in r)
        return dict(name=name + ("_hd256" if wide else ""), route="cuda",
                    source=src, replaces=replaces, launches=counts[name],
                    max_abs_err=max(r["max_abs_err"] for r in recs),
                    ms=t["ms"], plain_ms=t["plain_ms"],
                    bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                    library_ms=t["library_ms"])

    def bwd_rows(wide, counts):
        recs = [r for r in bwd_recs if r.get("hd256", False) == wide]
        t = next(r for r in recs if "dq_ms" in r)
        for name, key, outs, replaces in (
                ("flash_bwd_dq", "dq", ("dq",),
                 "realhf_tpu/ops/flash_attention.py:157"),
                ("flash_bwd_dkv", "dkv", ("dk", "dv"),
                 "realhf_tpu/ops/flash_attention.py:195")):
            yield dict(
                name=name + ("_hd256" if wide else ""), route="cuda",
                source="realhf_tpu_torch/csrc/flash_bwd.cu",
                replaces=replaces, launches=counts[name],
                max_abs_err=max(r[f"{o}_max_abs_err"] for r in recs
                                for o in outs),
                ms=t[f"{key}_ms"], plain_ms=t["plain_ms"],
                bound_ms=t[f"{key}_bound_ms"], bound_by=t[f"{key}_bound_by"],
                library_ms=t["library_ms"])

    launches, wide_launches = sums(paths), sums(hd256_paths)
    rows = [
        ("flash_fwd", "realhf_tpu_torch/csrc/flash_fwd.cu",
         "realhf_tpu/ops/flash_attention.py:55"),
        ("flash_decode", "realhf_tpu_torch/csrc/flash_decode.cu",
         "realhf_tpu/ops/decode_attention.py:114"),
        ("flash_decode_stacked", "realhf_tpu_torch/csrc/flash_decode.cu",
         "realhf_tpu/ops/decode_attention.py:135"),
    ]
    out = [fwd_row(*row, False, launches) for row in rows]
    out += list(bwd_rows(False, launches))
    out += [fwd_row(*row, True, wide_launches) for row in rows]
    # of the hd 256 K4 launches, those with the softmax statistics: the
    # "seq" route's slices
    wide_launches["flash_decode_seq"] = wide_launches["flash_decode_stats"]
    out.append(fwd_row("flash_decode_seq",
                       "realhf_tpu_torch/csrc/flash_decode.cu",
                       "realhf_tpu/ops/decode_attention.py:124", True,
                       wide_launches))
    out += list(bwd_rows(True, wide_launches))
    t = next(r for r in cp_bwd_recs if "dq_ms" in r)
    for name, key, outs, replaces in (
            ("flash_bwd_dq_ring", "dq", ("dq",),
             "realhf_tpu/ops/flash_attention.py:157"),
            ("flash_bwd_dkv_ring", "dkv", ("dk", "dv"),
             "realhf_tpu/ops/flash_attention.py:195")):
        out.append(dict(
            name=name, route="cuda",
            source="realhf_tpu_torch/csrc/flash_bwd.cu", replaces=replaces,
            launches=launches[name],
            max_abs_err=max(r[f"{o}_max_abs_err"] for r in cp_bwd_recs
                            for o in outs),
            ms=t[f"{key}_ms"], plain_ms=t["plain_ms"],
            bound_ms=t[f"{key}_bound_ms"], bound_by=t[f"{key}_bound_by"],
            library_ms=t["library_ms"]))
    t = next(r for r in cp_lse_recs if "ms" in r)
    out.append(dict(
        name="ring_attention_lse", route="cuda",
        source="realhf_tpu_torch/csrc/ring_attention.cu",
        replaces="realhf_tpu/ops/ring_attention_fused.py:103",
        launches=launches["ring_round_lse"],
        max_abs_err=max(r["max_abs_err"] for r in cp_lse_recs), ms=t["ms"],
        plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=t["library_ms"]))
    t = next(r for r in cp_bwd_hd256_recs if "dq_ms" in r)
    for name, key, outs, replaces in (
            ("flash_bwd_dq_ring", "dq", ("dq",),
             "realhf_tpu/ops/flash_attention.py:157"),
            ("flash_bwd_dkv_ring", "dkv", ("dk", "dv"),
             "realhf_tpu/ops/flash_attention.py:195")):
        out.append(dict(
            name=name + "_hd256", route="cuda",
            source="realhf_tpu_torch/csrc/flash_bwd.cu", replaces=replaces,
            launches=wide_launches[name],
            max_abs_err=max(r[f"{o}_max_abs_err"] for r in cp_bwd_hd256_recs
                            for o in outs),
            ms=t[f"{key}_ms"], plain_ms=t["plain_ms"],
            bound_ms=t[f"{key}_bound_ms"], bound_by=t[f"{key}_bound_by"],
            library_ms=t["library_ms"]))
    recs = [r for r in ring_hd256_recs if r["kernel"] == "ring_attention"]
    t = next(r for r in recs if "ms" in r)
    out.append(dict(
        name="ring_attention_hd256", route="cuda",
        source="realhf_tpu_torch/csrc/ring_attention.cu",
        replaces="realhf_tpu/ops/ring_attention_fused.py:103",
        launches=wide_launches["ring_round"],
        max_abs_err=max(r["max_abs_err"] for r in recs), ms=t["ms"],
        plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=t["library_ms"]))
    for name, count in (("ring_attention", "ring_round"),
                        ("ring_push", "ring_push")):
        recs = [r for r in ring_recs if r["kernel"] == name]
        t = next(r for r in recs if "ms" in r)
        out.append(dict(
            name=name, route="cuda",
            source="realhf_tpu_torch/csrc/ring_attention.cu",
            replaces="realhf_tpu/ops/ring_attention_fused.py:103",
            launches=launches[count],
            max_abs_err=max(r["max_abs_err"] for r in recs), ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"]))
    return {"kernels": out}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None,
                        help="also write every phase's record to this file")
    args = parser.parse_args(argv)
    global START
    START = time.monotonic()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run.", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "realhf_tpu_torch")):
        print("chip_smoke: realhf_tpu_torch is not beside this script.",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    import realhf_tpu_torch  # noqa: F401
    from realhf_tpu_torch.ops import _build

    smi = nvidia_smi_line()
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    t0 = time.monotonic()
    built = _build.build()
    per_lib = {n: [ln.strip() for ln in _build.build_log.get(n, "")
                   .splitlines() if "registers" in ln or "spill" in ln
                   or "wgmma" in ln]
               for n in _build.SOURCES}
    emit("build", seconds=time.monotonic() - t0, per_library_secs=built,
         ptxas=per_lib)

    kernel_recs = phase_kernels()
    bwd_recs = phase_kernels_bwd()
    win_fwd, win_bwd = phase_kernels_window()
    kernel_recs += win_fwd
    bwd_recs += win_bwd
    wide_fwd, wide_bwd = phase_kernels_hd256()
    kernel_recs += wide_fwd
    bwd_recs += wide_bwd
    ring_recs = phase_kernels_ring()
    for r in kernel_recs + bwd_recs + ring_recs:
        print(json.dumps(dict(phase="kernels", card=smi, **r)), flush=True)
    RESULTS["kernels"] = kernel_recs + bwd_recs + ring_recs
    ok = all(r["ok"] for r in kernel_recs + bwd_recs + ring_recs)
    main_rec = phase_gen(32, 128, smi, with_sampled_step=True)
    emit("main", **main_rec)
    deep_rec = phase_gen(49, 16, smi, with_sampled_step=False)
    emit("deep", **deep_rec)
    emit("profile", **phase_profile(smi))
    runner, sft_rec = phase_sft(smi)
    emit("sft", **sft_rec)
    for key in ("step_secs", "train_tokens_per_s", "peak_mem_gb"):
        print(f"sft-7bw-l8 {key}: {sft_rec[key]}", flush=True)
    emit("sft_profile", **phase_sft_profile(runner, smi))
    del runner
    torch.cuda.empty_cache()
    lr_rec = phase_sft_lr(smi)
    # the limit must tell the lr 1e-4 trajectory from the lr 1e-5 one
    lr_rec["lr_1e-5_rel_diff"] = max(
        abs(x - y) / abs(y)
        for x, y in zip(sft_rec["losses"], lr_rec["reference_losses"]))
    lr_rec["ok"] &= lr_rec["lr_1e-5_rel_diff"] > LR_WITNESS_LIMIT
    emit("sft_lr", **lr_rec)
    par = phase_parity()
    emit("parity", **par)
    train_par = phase_train_parity()
    emit("train_parity", **train_par)
    runner, ppo_segs, ppo_rec = phase_ppo(smi)
    emit("ppo", **ppo_rec)
    for st in ppo_rec["steps"]:
        print(f"ppo-7bw-l4 step {st['step']}: {json.dumps(st)}", flush=True)
    print(f"ppo-7bw-l4 peak_mem_gb: {ppo_rec['peak_mem_gb']} "
          f"(max_memory_allocated; {ppo_rec['leftover_gb']} of it left by "
          f"earlier phases; {smi})", flush=True)
    emit("ppo_profile", **phase_ppo_profile(runner, smi))
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    ppo_fwd, ppo_bwd = phase_kernels_ppo(ppo_segs)
    for r in ppo_fwd + ppo_bwd:
        print(json.dumps(dict(phase="kernels", card=smi, **r)), flush=True)
    kernel_recs += ppo_fwd
    bwd_recs += ppo_bwd
    RESULTS["kernels"] = kernel_recs + bwd_recs + ring_recs
    ok &= all(r["ok"] for r in ppo_fwd + ppo_bwd)
    ppo_par = phase_ppo_parity()
    emit("ppo_parity", **ppo_par)
    ctx_rec = phase_ctx(smi)
    emit("ctx", **ctx_rec)
    for tag, run in ctx_rec["runs"].items():
        print(f"ctx-7b-c4 {tag}: {json.dumps(run)} ({smi})", flush=True)
    ppo_ctx_rec, first_ring = phase_ppo_ctx(smi)
    emit("ppo_ctx", **ppo_ctx_rec)
    ring_ppo = check_ring_ppo_ctx(first_ring)
    del first_ring
    torch.cuda.empty_cache()
    print(json.dumps(dict(phase="kernels", card=smi, **ring_ppo)), flush=True)
    ring_recs.append(ring_ppo)
    RESULTS["kernels"] = kernel_recs + bwd_recs + ring_recs
    ok &= ring_ppo["ok"]
    algo_recs = run_algo_phases(smi)
    ckpt_gen_rec = phase_ckpt_gen(smi)
    emit("ckpt_gen", **ckpt_gen_rec)
    load_rec = ckpt_gen_rec["streamed"]
    print(f"ckpt-gen-7b-l{CKPT_GEN_LAYERS}: " + json.dumps({
        k: ckpt_gen_rec[k] for k in ("bytes_written", "save_secs",
                                     "save_gb_per_s")} | {
        "streamed": {k: load_rec[k] for k in (
            "secs", "gb_per_s", "host_peak_growth_gb",
            "device_peak_growth_gb")},
        "registry_eager": {k: load_rec["registry_eager"][k] for k in (
            "secs", "gb_per_s", "host_peak_growth_gb")}})
        + f" ({smi})", flush=True)
    ckpt_resume_rec = phase_ckpt_resume(smi)
    emit("ckpt_resume", **ckpt_resume_rec)
    c = ckpt_resume_rec["c"]
    print(f"ckpt-resume-7bw-l{CKPT_RESUME_LAYERS}: " + json.dumps(dict(
        saves_secs=ckpt_resume_rec["saves_secs"],
        bytes_saved=ckpt_resume_rec["bytes_saved"],
        resume_setup_secs=c["setup_secs"],
        resume_host_peak_growth_gb=c["host_peak_growth_gb"],
        update_diff=c["update_diff"],
        fault_update_diff=ckpt_resume_rec["fault_fresh_moments"][
            "update_diff"])) + f" ({smi})", flush=True)
    serve_gen_rec = phase_serve_gen(smi)
    emit("serve_gen", **serve_gen_rec)
    serve_rec = phase_serve(smi)
    d1t1_tokens = serve_rec.pop("a_v0_tokens")
    emit("serve", **serve_rec)
    serve_par_rec = phase_serve_par(smi, d1t1_tokens)
    emit("serve_par", **serve_par_rec)
    serve_rep_rec = phase_serve_rep(smi)
    emit("serve_rep", **serve_rep_rec)
    serve_view_rec = phase_serve_gen_view(smi)
    emit("serve_gen_view", **serve_view_rec)
    moe_recs = run_moe_phases(smi)
    ok &= all(r["ok"] for r in moe_recs.values())
    gemma_recs = run_gemma_phases(smi)
    ok &= all(r["ok"] for r in gemma_recs.values())
    par_recs, par_segs = run_par_phases(smi)
    ok &= all(r["ok"] for r in par_recs.values())
    par_fwd, par_bwd = phase_kernels_par(par_segs)
    del par_segs
    for r in par_fwd + par_bwd:
        print(json.dumps(dict(phase="kernels", card=smi, **r)), flush=True)
    kernel_recs += par_fwd
    bwd_recs += par_bwd
    RESULTS["kernels"] = kernel_recs + bwd_recs + ring_recs
    ok &= all(r["ok"] for r in par_fwd + par_bwd)
    pp_recs, pp_segs = run_pp_phases(smi)
    ok &= all(r["ok"] for r in pp_recs.values())
    pp_fwd, pp_bwd = phase_kernels_pp(pp_segs)
    del pp_segs
    for r in pp_fwd + pp_bwd:
        print(json.dumps(dict(phase="kernels", card=smi, **r)), flush=True)
    kernel_recs += pp_fwd
    bwd_recs += pp_bwd
    RESULTS["kernels"] = kernel_recs + bwd_recs + ring_recs
    ok &= all(r["ok"] for r in pp_fwd + pp_bwd)
    cp_recs, cp_segs = run_cp_phases(smi)
    ok &= all(r["ok"] for r in cp_recs.values())
    cp_bwd, cp_lse = phase_kernels_cp(cp_segs)
    del cp_segs
    for r in cp_bwd + cp_lse:
        print(json.dumps(dict(phase="kernels", card=smi, **r)), flush=True)
    RESULTS["kernels"] = kernel_recs + bwd_recs + ring_recs + cp_bwd + cp_lse
    ok &= all(r["ok"] for r in cp_bwd + cp_lse)
    moe_par_recs = run_moe_par_phases(smi)
    ok &= all(r["ok"] for r in moe_par_recs.values())
    ring_pp_recs, ring256, bwd256 = run_ring_pp_phases(smi)
    ok &= all(r["ok"] for r in ring_pp_recs.values())
    for r in ring256 + bwd256:
        print(json.dumps(dict(phase="kernels", card=smi, **r)), flush=True)
    RESULTS["kernels"] = (kernel_recs + bwd_recs + ring_recs + cp_bwd
                          + cp_lse + ring256 + bwd256)
    ok &= all(r["ok"] for r in ring256 + bwd256)
    ok &= (main_rec["ok"] and deep_rec["ok"] and par["ok"]
           and sft_rec["ok"] and lr_rec["ok"] and train_par["ok"]
           and ppo_rec["ok"] and ppo_par["ok"] and ctx_rec["ok"]
           and ppo_ctx_rec["ok"] and all(r["ok"] for r in algo_recs.values())
           and ckpt_gen_rec["ok"] and ckpt_resume_rec["ok"]
           and serve_gen_rec["ok"] and serve_rec["ok"]
           and serve_par_rec["ok"] and serve_rep_rec["ok"]
           and serve_view_rec["ok"])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(RESULTS, f, indent=1)
    if not ok:
        print("chip_smoke: a phase failed (see its JSON line).",
              file=sys.stderr)
        return 1
    print(json.dumps(kernels_line(
        kernel_recs, bwd_recs, ring_recs,
        [main_rec, deep_rec, sft_rec, ppo_rec, ctx_rec, ppo_ctx_rec]
        + list(algo_recs.values()) + [ckpt_gen_rec, ckpt_resume_rec,
                                       serve_gen_rec]
        + list(serve_rec["configs"].values())
        + list(serve_par_rec["configs"].values())
        + list(serve_view_rec["cases"].values())
        + [moe_recs[k] for k in ("mixtral_gen", "moe_tp", "mixtral_sft",
                                 "mistral")]
        + [gemma_recs["gpt2_gen"]]
        + [par_recs[k] for k in ("tp_gen", "tp_sft", "par_ppo")]
        + [pp_recs[k] for k in ("pp_sft", "pp_gen", "pp_ppo")]
        + [cp_recs[k] for k in ("cp_sft", "sp_sft")]
        + [moe_par_recs["moe_sft_par"], moe_recs["moe_pp"],
           ring_pp_recs["sp_pp"]],
        [gemma_recs["gemma_gen"], gemma_recs["gemma_sft"],
         moe_par_recs["kv_rep"], ring_pp_recs["cp_gemma"], serve_rep_rec],
        cp_bwd, cp_lse,
        ring256, bwd256)))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
