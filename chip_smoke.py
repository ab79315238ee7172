#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's paths at the full published widths of gemma-2b
(random weights drawn on the card from ``PRNGKey(0)``, as the JAX
package draws them) on one NVIDIA GPU: paged serving, with decode
attention in a hand-written CUDA kernel (split-KV decoding with a
fixed-order merge); training with SNGM and with
LAMB on the multi-tensor engine, with SNGM and LARS on the per-leaf
path, and with three gradient-transform chains compiled onto the engine
(a clip before the chain, mid-chain, and after the schedule, the last
through ``fused_update``'s deferred apply), every optimizer pass a
hand-written CUDA kernel; a save and resume of SNGM and LAMB training
on the engine; and the RMSNorm and flash attention op entry points,
each a hand-written CUDA kernel; and training from a packed dataset on
disk through the streaming loader and host-to-device prefetch; and the
paper's own experiments: the Fig. 1 / Table 2 convnet and the Table 3
LM proxy through the port's training loops, on the engine; and SNGM
with EMA shadow parameters (``--ema-decay``) on the engine and through a
checkpoint; and the dense serving engine (``--engine dense``), against
both paged paths and on a rotated ring past a long-context window; and
the DeepSeek-V2 family (MLA attention, capacity-dispatched MoE):
deepseek-v2-lite-16b served at full width on both engines and trained
with SNGM on the engine; and the Mamba2 (SSD) family, a pure SSM stack:
mamba2-1.3b served at full width on both engines and trained with SNGM
on the engine; and the jamba hybrid; and the Whisper encoder-decoder,
whisper-large-v3 served through ``greedy_generate`` at full width and
depth and trained with SNGM on the engine; and the reference's precision
and remat switches (bf16-in, f32-out score and logits products with
JAX's backward, the loss's bf16 weight cast, sqrt-remat grouping).  Holds every kernel (11 rows: the deferred apply has its own) against
its plain PyTorch version.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. the card (nvidia-smi name and power limit, printed again before
     the JSON lines), versions, the build time of each kernel library
     (one nvcc per library, run side by side) and a summary of its
     ptxas register and spill lines;
  2. the paged kernel against its plain version on the card, fp32 and
     bf16, over head-group, kv-head, head-dim and block-size grids,
     window and softcap, frontiers on and inside blocks, an inactive
     row, and the gemma-2b decode shape; then the split design's edges:
     forced split lengths with boundaries inside pool blocks and
     frontiers on the first and last position of a split, splits wholly
     past the frontier and before the window, G = 3, tables of 1 and 512
     columns, B * K of 1 and 160, out-of-pool block ids, and the three
     long shapes of phase 5 in fp32 and bf16; every output computed
     twice, bitwise the same; every bf16 output also within one bf16 step
     of the value plus the fp32 bound; the gemma2-27b case must fail the
     plain version with its softcap dropped or its window edge moved by
     one position;
  3. full-width serving (the time of the on-card ``materialize`` is
     printed): 16 requests arriving two per scheduler round on
     8 slots, four prompts sharing a 256-token prefix, a pool small
     enough to preempt; the kernel's launch count must be
     n_layers x decode steps;
  4. the whole decode path through the kernel against the model's plain
     gather path on the card, teacher-forced on the same tokens, at the
     served bf16 compute and at fp32 compute;
  5. the paged kernel's time at four shapes (phase 3's decode shape,
     gemma-2b at long context, for 8 sequences and for one, and a
     gemma2-27b local layer) against its
     byte bound, beside its plain version, gather + SDPA (no softcap
     only) and ``index_select`` of the live pool blocks, with its split
     plan and its registers and spills (none allowed; phase 1 fails on a
     paged spill too);
  6. ``chunk_sumsq`` and ``fused_update`` against their plain versions,
     bitwise: fp32 and bf16, wd 0 and 1e-4, both cast orders, nesterov,
     per-row coefficients, signed zeros, and the full gemma-2b buffer;
     then their times on that buffer against their byte bounds;
  7. ``adam_update`` and ``scale_apply`` (LAMB) against their plain
     versions, bitwise: fp32 and bf16, wd 0 and 1e-4, signed zeros, a
     zero-padded tail, per-row coefficients, and the full gemma-2b
     buffer; then their times there;
  8. ``fused_sngm_update``, ``lars_sqnorm`` and ``lars_update`` (the
     per-leaf path) against their plain versions, bitwise: ragged
     leaves of 1, 1023, 1025 and 32,769 elements, fp32 and bf16, signed
     zeros, wd 0 and 1e-4, and the 11 gemma-2b leaves; then their times
     over those leaves, ``lars_sqnorm`` beside ``vector_norm``;
  9. full-width training through ``repro_torch.launch.train``'s own
     functions (batch 8 x 512 tokens, 2 micro-batches, wd 1e-4), each
     path with the launch counts set to 0 just before it and read just
     after: 4 SNGM steps on the engine (1 ``chunk_sumsq`` + 1
     ``fused_update`` a step), 4 LAMB steps on the engine at lr 0.01 (1
     ``adam_update`` + 1 ``scale_apply``), 3 SNGM steps per leaf (11
     ``fused_sngm_update``) and 3 LARS steps per leaf (22
     ``lars_sqnorm`` + 11 ``lars_update``); loss, grad_norm, step time,
     tokens/s, peak memory, the optimizer step's share of a step and a
     profiled step;
 10. the port's ``fused=None`` against ``fused="multi_tensor"`` (every
     kind and LAMB) and ``fused="per_leaf"`` (sngm, lars) from one
     state and the same full-width gradients, bitwise over 3 steps,
     fp32 and bf16 (depth cut to 2 layers to fit both states and the
     plain path's temporaries beside each other);
 11. the ``rmsnorm`` and flash attention kernels against their plain
     versions at small shapes over every build variant (rmsnorm: a warp
     or a block a row, staged or read twice, 16-, 8-byte and one-element
     loads, fp32 and bf16 x and scale; flash: hd 64, 128, 256, MHA and
     GQA, ragged S, causal, window, softcap, non-causal, fp32 and bf16,
     and in fp32 every shape and option of the ``cuda``-marked test too,
     each fp32 output the same bits on a second call);
 12. this slice's path: ``kernels.rmsnorm.ops.rmsnorm`` on x of
     gemma-2b's d_model at phase 9's batch (fp32, bf16) and a d = 300
     tail case, ``kernels.flash_attention.ops.attention`` at gemma-2b
     prefill and a gemma2-27b local layer (S 8192, window 4096, softcap
     50, scores of std 2), each in fp32 and bf16, with the launch counts
     set to 0 just before and read just after;
 13. each of those outputs against the kernel's plain version and the
     port's model function (``layers.rmsnorm``, ``layers._sdpa_seq``):
     rmsnorm fp32 1e-5, flash attention fp32 2e-5 abs, and in bf16 that
     plus one bf16 step of the value (2^-7 |y|); each fp32 flash output
     the same bits on a second call; the window/softcap cases must fail
     against the plain version with the softcap dropped or the window
     edge moved by one key;
 14. every fp32 flash kernel's registers, spills and tensor-core
     instructions (``cuobjdump -sass``; a spill or no HMMA/HGMMA fails);
     then the times against their bounds (fp32 flash: three TF32
     products at the TF32 rate, the CUDA-core bound logged beside it),
     beside the plain versions and ``F.rms_norm`` /
     ``F.scaled_dot_product_attention`` (causal, no window or softcap
     only); for each flash case its TFLOP/s, its time over SDPA's (bf16:
     and over the fp32 kernel's), and its kernel's registers, spills and
     tensor-core instructions;
 15. ``fused_update(apply=False)`` (the deferred apply a trailing clip
     runs) against its plain version, bitwise: phase 6's grid, fp32
     updates beside bf16 params (what a promoting chain stage hands the
     engine; also the apply mode and the decayed norm), and the full
     gemma-2b buffer in fp32 and bf16; p keeps its bits and a second call
     gives the same bits; then its time on that buffer against its bound
     and, in turns, the apply kernel's;
 16. full-width training through the launcher's functions (phase 9's
     batch) for three chains compiled with ``compile_chain(tx,
     fused="multi_tensor")``, 3 steps each, the launch counts set to 0
     just before each and read just after: a clip before adw ->
     normalize -> trace -> schedule (2 ``chunk_sumsq`` + 1
     ``fused_update`` a step), a clip mid-chain (1 + 1), a clip after the
     schedule (1 ``chunk_sumsq`` + 1 deferred ``fused_update`` + 1
     ``scale_apply``), each the plan's launch count; losses, stats, the
     trailing clip's factor (it must act), peak memory, and each chain's
     optimizer step against plain SNGM's on the same buffers;
 17. each chain on the engine against the port's interpreter
     (``compile_chain(tx, interpret=True)``) from one state on the same
     full-width gradients, 3 steps, fp32 and bf16 params, within the JAX
     grid's bound for clipped chains (fp32 rtol 5e-4 / atol 1e-6, bf16
     rtol 5e-2 / atol 1e-2), and whether bitwise (depth cut to 2 layers,
     as in phase 10);
 18. checkpoints and resume at full width through the launcher's own
     functions (``plan_run``, ``build``, ``Saves``, ``train``, ``resume``):
     SNGM on the engine at all 18 layers, its batches read from a pack
     on disk with ``--data-dir --prefetch 2``, and LAMB on the engine at
     2 on ``SyntheticLM`` (depth cut further only if the disk cannot hold
     the checkpoint about twice, logged), phase 9's batch: steps 0-1 with
     ``--save-every 2 --async-save`` (the async save's blocking copy
     timed at the step boundary beside the step time, its commit, and a
     sync save of the same state; the step-2 checkpoint's
     ``loader_state`` the host loader's cursor after 2 batches), then a
     fresh run from the saved ``train_meta.json`` with ``--resume`` (load
     timed): every restored byte bitwise the live state's at step 2, the
     spec, horizon and data cursor adopted; steps 2-3 from the restored
     state (1 ``chunk_sumsq`` + 1 ``fused_update`` a step; LAMB: 1
     ``adam_update`` + 1 ``scale_apply``; counts set to 0 just before,
     read just after) within twice the difference between two runs of
     steps 2-3 from the live state (0 if they repeat), and the batches
     they consumed, read back from the card, bitwise the live runs' and
     the host loader's batches 2-3; the files in a scratch dir under
     ``build/``, removed at the end.  The pack (made once before this
     phase, timed, through ``repro_torch.data.pack``): a synthetic-LM
     dataset at gemma-2b's vocab (256000) and seq 512, 56 examples in 7
     shards of 8, so an epoch is 7 batches of 8;
 19. the data pipeline at full width through the launcher's own
     functions: SNGM on the engine at all 18 layers, 9 steps from the
     pack (across the epoch boundary at step 7), once with ``--prefetch
     2`` and once with ``--prefetch 0``, the launch counts (1
     ``chunk_sumsq`` + 1 ``fused_update`` a step) set to 0 just before
     each run and read just after; every batch a step consumed, read
     back from the card, bitwise the host loader's; the two runs' losses,
     grad norms and update norms equal (bitwise, or within twice the
     difference between two ``--prefetch 0`` runs if steps do not
     repeat); logged per step: the input stall, the prefetch depth and
     the step time, and once the host-to-device copy of one batch (its
     bytes, timed with events on the training stream);
 20. the paper's convnet (width 32, 545,098 fp32 params in 8 leaves,
     ``synthetic_images`` 4096 train and 1024 test) through
     ``repro_torch.training.loops``: (a) SNGM, MSGD, LARS and LAMB on the
     engine against ``fused=None`` from one state on the same gradient
     tensors, 3 steps, bitwise (params, slots, stats, sign of zero), and
     each one's optimizer step timed; (b) ``train_convnet`` at B 1024 in
     8 micro-batches of 128 for 3 steps with each of them, the launch
     counts set to 0 just before and read just after (SNGM and MSGD 1
     ``chunk_sumsq`` + 1 ``fused_update`` a step, LARS 2 + 1, LAMB 1
     ``adam_update`` + 1 ``scale_apply``), the call counts
     (``count_kernel_calls``) equal to them, and the port's counters
     (``engine_counters``, ``plan_launches_per_step``, the resident
     ``param_bytes_live`` 1x) equal to the counts read; (c) SNGM's first 3
     losses on the card against the same call on the CPU (step 0 within
     1e-5 relative, steps 1-2 within 1e-4); (d) the five Table 2 jobs of
     ``benchmarks/bench_table2_cifar_proxy.py`` on the engine (16 epochs,
     B 64 and 1024) and SNGM at B 1024 with ghost batch norm (128):
     final loss, test accuracy, examples/s and median step time,
     reported, not asserted; one profiled SNGM run (the device's busy
     share); (e) ``train_lm`` at the Table 3 proxy config (deepseek-7b
     smoke, vocab 256, fp32), SNGM on the engine, B 256 x seq 64 in 16
     micro-batches, 5 steps: 1 + 1 launches a step, tokens/s;
 21. EMA shadow parameters (``sngm(ema_decay=)``, the resident f32
     ``e_flats`` slots; the advance is plain PyTorch and launches no
     kernel of the table): (a) full-width gemma-2b through the launcher's
     functions (phase 9's batch), plain SNGM, SNGM with ``--ema-decay
     0.999`` and the same with ``--nesterov``, 3 steps each on the
     engine, the launch counts set to 0 just before each and read just
     after (1 ``chunk_sumsq`` + 1 ``fused_update`` a step); step time and
     peak memory with and without EMA; the optimizer step with EMA
     against plain SNGM's on the same buffers; the EMA advance alone
     (CUDA events) against its byte bound (e read, p read, e written);
     (b) the engine against the port's interpreter (``fused=None``) from
     one state on the same full-width gradients at 2 layers, decay 0.5,
     fp32 and bf16 params, with and without nesterov, 3 steps: params,
     momentum, EMA slots and stats bitwise (sign of zero included); (c)
     one EMA advance on the card against the same call on the CPU, fp32
     and bf16 params, decay 0.999, 0.99 and 0.5 (two slices of a buffer,
     signed zeros; and the interpreter's stage): bitwise, which a
     contracted multiply-add would break; (d) phase 18's round trip for
     SNGM + EMA at 2 layers through ``Saves`` and ``resume``: saved at
     step 2, the archive's keys the live state's pytree form, every
     restored byte (the EMA slots too) bitwise, steps 2-3 within twice the
     live-live difference (0 if they repeat);
 22. the dense serving engine at full width (run after phase 5; it
     launches no kernel of its own: dense decode attention is the model's
     plain ``_sdpa``, as in the JAX package): (a) phase 3's 16 requests,
     queued at once, on 8 slots at ctx 544 through the launcher's
     ``ContinuousBatcher`` and ``serve_dense`` at bf16 compute, the launch
     counts set to 0 just before and read just after (the paged kernel
     must launch 0 times); every request 64 in-vocabulary tokens;
     tok/s, latency p50/p99, ms a decode step, prefill calls and distinct
     shapes and peak memory, beside phase 3's paged figures; (b) phase
     4's prompts, teacher-forced on the dense engine's greedy tokens
     through the dense engine, the paged plain gather path and the paged
     kernel path, bf16 and fp32: dense against plain gather at matched
     geometry (dense context = nbmax x block size) bitwise in fp32 (else
     within ``DENSE_REL`` of the max logit, logged), dense against the
     kernel path within ``LOGIT_REL``, greedy agreement logged; (c)
     gemma-2b ``for_long_context()`` (18 layers, window 8192) at fp32:
     one prompt of 8448 tokens rotates every ring at prefill, 4 decode
     steps on the rings unpadded, each within ``LOGIT_REL["float32"]`` of
     the same decode on the same prefill kept whole (the linear layout,
     the window a mask only); each layout's distance to a teacher-forced
     prefill of the prefix logged beside the logits' move under a
     one-ulp scale of one weight leaf (at this length the random stack
     turns that alone into ~1e-3 of the max logit, so decode against
     prefill is a reading, not a bound); ``pad_cache`` must refuse the
     rotated cache; peak memory; (d) the phase's seconds;
 23. the DeepSeek-V2 family (run after phase 21; no kernel of its own:
     the reference computes MLA and MoE outside any Pallas kernel, and
     MLA decode gathers its latent pools in plain PyTorch, so the paged
     kernel must launch 0 times): (a) deepseek-v2-lite-16b at full width
     and all 27 layers, bf16, its weights drawn on the card with each
     matmul leaf cast as it is drawn (seconds, resident and peak
     memory): 8 requests (prompts 96-480, 32 new tokens) on 8 slots on
     the paged engine (tok/s, latency p50/p99, ms a decode step, peak
     memory, a profiled decode chunk) and on the dense engine, the launch
     counts set to 0 just before each and read just after; the dense
     engine teacher-forced on the paged tokens, each paged token within
     ``MOE_REGRET`` of the dense top logit; the two engines' free-running
     greedy tokens compared at the config's capacity and at capacity 16
     (logged: under capacity drops the two compute other functions, and
     the random bf16 stack moves the logits as much between a prefill
     alone and in a padded batch as under one bf16 step of one weight
     leaf, both logged); (b) at full width and 2 layers (the dense prefix
     layer and one MoE layer), one prefill feeding the dense ring and the
     paged latent pools, 4 decode steps: bitwise in fp32 (bf16 logged);
     (c) one full-width MoE layer (64 experts, top-6, 2 shared, 4096
     tokens, fp32): capacity dispatch with nothing dropped against
     ``moe_ref`` within ``MOE_REL`` of the max, and at capacity factor 1.0
     on inputs whose router logits are exact (many ties) the card's ids,
     positions and keep mask equal to the CPU's; the layer's time (bf16)
     beside ``moe_ref``'s, a reading; (d) depth cut to 1 dense prefix + 3
     MoE layers (2,254,983,168 params), SNGM on the engine through the
     launcher's functions, batch 8 x 512 in 2 micro-batches with remat, 4
     steps: 1 ``chunk_sumsq`` + 1 ``fused_update`` a step, a finite
     ``aux_loss``, step time, tokens/s, peak memory; and the engine
     against ``fused=None`` from one state on one set of gradients (2
     layers), 3 steps, bitwise.  Every line carries the card's name and
     power limit;
 24. the Mamba2 (SSD) family (run after phase 23; no kernel of its own:
     the reference computes SSD outside any Pallas kernel, and the stack
     has no attention layer, so the paged kernel must launch 0 times):
     (a) mamba2-1.3b at full width and all 48 layers, bf16, its weights
     drawn on the card with each matmul leaf cast as it is drawn
     (seconds, resident and peak memory): 8 requests (distinct prompt
     lengths in 96-480, 32 new tokens) on 8 slots on the paged engine
     (tok/s, latency p50/p99, ms a decode step, peak memory, a profiled
     decode chunk; every prefill at a prompt's exact length) and on the
     dense engine, the launch counts set to 0 just before each and read
     just after; the dense engine teacher-forced on the paged tokens,
     each paged token within ``MOE_REGRET`` of the dense top logit; the
     free-running greedy tokens the two share, logged; (b) at full width
     and 2 layers, one prefill of 8 prompts of one length feeding the
     dense and the paged cache, 4 decode steps: bitwise in fp32 and
     bf16; (c) at full width and 2 layers, fp32, a prompt of 300 tokens
     (the chunk's padded tail runs), 4 decode steps within
     ``SSM_TF_REL`` of a teacher-forced prefill of each prefix, beside
     the logits' move under a one-ulp scale of one weight leaf; (d)
     ``ssd_chunked`` at full-width dims (B 4, S 512, H 64, P 64, N 128,
     chunk 256, fp32) against the token-by-token recurrence within
     ``SSM_SSD_REL`` of max|y| and max|h|, one ``mamba_block``'s time in
     bf16 a reading; (e) all 48 layers (1,343,740,928 params), SNGM on
     the engine through the launcher's functions, batch 8 x 512 in 2
     micro-batches with remat, 4 steps: 1 ``chunk_sumsq`` + 1
     ``fused_update`` a step, finite stats, step time, tokens/s, peak
     memory; and the engine against ``fused=None`` from one state on one
     set of gradients (2 layers), 3 steps, bitwise.  Every line carries
     the card's name and power limit;
 25. the jamba hybrid (run after phase 24; no kernel of its own: the
     reference computes SSD and MoE outside any Pallas kernel; its one
     attention layer a period decodes through the paged kernel): (a)
     jamba-1.5-large-398b cut to one period (8 layers, L4 attention, 4
     experts, top-2, every published width; 16,153,237,504 params stored
     bf16, drawn on the card from PRNGKey(0): seconds, resident and peak
     memory): 8 requests (distinct prompt lengths, four sharing a
     256-token prefix, 2 arriving a round, 32 new tokens) on 8 slots on
     the paged engine (tok/s, latency p50/p99, ms a decode step, peak
     memory, a profiled decode chunk; every prefill at a prompt's exact
     length; prefix blocks shared; the paged kernel launched once a
     decode step) and on the dense engine (0 launches), the launch
     counts set to 0 just before each and read just after, at the
     config's capacity factor and at 16, where the free-running greedy
     tokens are compared (logged) and the dense engine is teacher-forced
     on the paged tokens within ``MOE_REGRET``; (b) the training cut
     (one period at half width: d 4096, 32 heads, 8 kv heads, d_ff =
     d_expert 12288, 4 experts; the attention projections scaled to
     their true fan-in), one prefill of 8 prompts of 200 feeding the
     dense and two paged caches, 4 decode steps: the paged plain
     gather bitwise the dense engine, the kernel's attention output at
     each launch within ``TOL`` of its plain version on the same inputs
     (bf16 also within 2e-5 plus one bf16 step of the value), in fp32
     and bf16; (c) fp32 at that cut, capacity factor 16: a prompt of 300,
     4 decode steps within ``SSM_TF_REL`` of a teacher-forced prefill,
     beside the one-ulp nudge; ``for_long_context()`` (the attention
     layer stays global, as the reference's ``layer_pattern`` has it): a
     prompt of 4352, the cache unrotated, 4 decode steps bitwise the
     config without the window, teacher forcing a reading; (d) the paged
     kernel alone at jamba's decode shape (B 8, H 64, K 8, hd 128, 25a's
     contexts, bf16) against its plain version: its time, byte bound,
     plain and gather+SDPA times, split plan, registers, 0 spills; (e)
     SNGM at the training cut (4,314,856,832 bf16 params, fp32
     momentum) through the launcher's functions, batch 8 x 512 in 2
     micro-batches, remat, 3 steps on the engine (1 ``chunk_sumsq`` + 1
     ``fused_update`` a step; step time, tokens/s, peak memory); then at
     2 experts the engine and ``--fused none`` from the same seed, in
     turn: stats, params and momentum bitwise (digests).  Every line
     carries the card's name and power limit;
 26. the Whisper encoder-decoder (run after phase 25; no kernel of its
     own: the reference's LayerNorm, GELU MLP, encoder and cross
     attention reach no Pallas kernel, and its paged engine refuses an
     encoder-decoder; its SNGM steps run rows 1 and 2): (a)
     whisper-large-v3 at full width and depth (32 + 32 layers,
     1,535,219,200 params, matmul weights bf16 as drawn on the card from
     PRNGKey(0)) through ``greedy_generate`` on the dense cache: 8
     prompts of 32 tokens, (8, 1500, 1280) frame embeddings from
     ``WHISPER_SEED``, 32 new tokens, run twice, the tokens bitwise
     equal and equal to a timed prefill + decode loop; resident bytes,
     the cross cache (1,966,080,000 B), encoder, prefill and decode-step
     ms, tok/s, peak memory; (b) fp32 at full depth, the matmul weights
     at their true fan-in, B 2, prompt 24, 4 decode steps each within
     ``WHISPER_TF_REL`` of a teacher-forced prefill, beside the one-ulp
     nudge; (c) the card against the CPU: fp32 ``forward`` at 2 + 2
     layers on the same weights (true fan-in) and frames, prefill
     logits within ``WHISPER_CPU_REL``; (d) SNGM on the engine through the launcher's
     functions at full depth, batch 8 x 128 in 2 micro-batches with
     remat, 3 steps (one fp32 bucket, 1 ``chunk_sumsq`` + 1
     ``fused_update`` a step, finite losses, step time, peak memory);
     then at 2 + 2 layers the engine and ``--fused none`` from the same
     seed, in turn: stats, params and momentum bitwise (digests).
     Every line carries the card's name and power limit;
 27. the reference's precision and remat switches (run after phase 26;
     no kernel of their own: the reference's bf16-in, f32-out products
     are plain ``dot_general``s, so ``bf16_dot`` runs library GEMMs on the
     tensor cores): (a) ``bf16_dot`` against its plain form
     (``bf16_dot_ref``) on the same inputs at gemma-2b's logits chunk
     (2048 x 2048 @ 2048 x 256000) and its and whisper's score shapes:
     forward within 1e-5 of max, both cotangents within one bf16 step of
     the value plus 1e-5 of max; the forward product and the backward's
     cotangent products timed beside the plain form's and the bf16
     bound; (c) full-width gemma-2b (18 periods), one micro-batch of
     ``loss_fn`` and backward with remat, per-block (``_remat_group``
     forced to 1), grouped, grouped, per-block in turn: the grouped
     gradients bitwise the per-block ones (or within twice the two
     per-block runs' difference), each run's time and peak; (d) a
     full-width prefill of 2 prompts of 480 and 4 teacher-forced dense
     decode steps at fp32 compute with ``sdpa_bf16``, the card's path
     against the plain form and beside a one-ulp nudge of one weight leaf,
     at the reference init (chaotic: a reading) and with the matmul
     weights at their true fan-in (``true_fan_in``), there within
     ``LOGIT_REL["float32"]``; (b) phase 9's
     SNGM engine run (4 steps) with ``logits_bf16``, ``sdpa_bf16`` and
     ``gather_dtype="bfloat16"`` all off and all on (``config_cut`` and a
     ``make_runtime`` patch: the launcher has no flag for them), one run
     each: 1 ``chunk_sumsq`` + 1 ``fused_update`` a step, finite stats,
     the step-0 loss and ||g|| on within 5e-2 relative of off, step time,
     tokens/s, peak memory.  ``--precision-only`` runs 27b six times in
     turn (per-block off, off, on, on, off, per-block off; per-block is
     remat without groups), profiles the first run of each kind (its GEMM
     device time by input dtype), and adds to 27c a reading of the
     gradient norm with each switch, with ``sdpa_bf16`` on its plain
     form, and with one weight leaf nudged by an ulp.  Every line carries
     the card's name and power limit;
 28. one JSON line of kernel timings against their bounds (11 rows;
     flash attention's row is the bf16 gemma-2b prefill), then the JSON
     result line.

Every time is the median of CUDA-event timings with L2 flushed and a
device spin before the start event, so the host's enqueue (logged as
``enqueue_ms``) stays out of the window (``time_kernel``).

    python3 chip_smoke.py --ops-only    # phases 1 and 11-14: the two ops
    python3 chip_smoke.py --paged-only  # phases 1, 2 and 5: the paged kernel
    python3 chip_smoke.py --chains-only # phases 1 and 15-17: the chains
    python3 chip_smoke.py --ckpt-only   # phases 1 and 18: checkpoints, resume
    python3 chip_smoke.py --data-only   # phases 1 and 19, with the pack
    python3 chip_smoke.py --convnet-only  # phases 1 and 20: the paper's convnet
    python3 chip_smoke.py --ema-only    # phases 1 and 21: EMA shadow params
    python3 chip_smoke.py --dense-only  # phases 1 and 22: the dense engine
    python3 chip_smoke.py --moe-only    # phases 1 and 23: DeepSeek-V2
    python3 chip_smoke.py --ssm-only    # phases 1 and 24: Mamba2
    python3 chip_smoke.py --hybrid-only # phases 1 and 25: jamba
    python3 chip_smoke.py --whisper-only  # phases 1 and 26: Whisper
    python3 chip_smoke.py --precision-only  # phases 1 and 27: the switches

It exits non-zero, printing no result, without a CUDA device or outside
a checkout of the repository.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12                 # CUDA cores: the kernel's fp32 FMAs
BF16_FLOPS = 989e12                # tensor cores, dense bf16
TF32_FLOPS = 495e12                # tensor cores, dense TF32: fp32 flash
# attention's products run in 3xTF32, three TF32 products for each fp32
# one, so its bound is 3 x its fp32 flops at this rate
TF32_PRODUCTS = 3
TOL = {"float32": 2e-5, "bfloat16": 3e-2}     # kernel vs plain, max abs
# phase 4: |logits(kernel path) - logits(gather path)| <= LOGIT_REL x max|logits|.
# fp32 compute holds the whole path tightly: the two attention paths sum
# in other orders (~1e-7), and the random stack amplifies that to ~1e-4
# (measured on narrow 18-layer stand-ins on the CPU).  At the served
# bf16 compute the gather path rounds the softmax probabilities to bf16
# before the PV product while the kernel keeps them in fp32; the random
# weights (drawn at fan-in n_layers, as in the JAX package) turn that
# bf16-level difference into logit differences of 0.2-0.3 of the largest
# logit on the same stand-ins, so the bf16 bound only rules out garbage
# (unrelated logits differ by 1-2).
LOGIT_REL = {"float32": 1e-2, "bfloat16": 1.0}

ARCH = "gemma-2b"
SLOTS, BLOCK_SIZE, DECODE_CHUNK, MAX_NEW = 8, 16, 4, 64
N_REQUESTS, PER_ROUND, PROMPT_LO, PROMPT_HI = 16, 2, 96, 480
SHARED_PREFIX, SHARERS = 256, (0, 3, 5, 6)
POOL_BLOCKS = 120                  # 119 usable: below the peak demand, so it preempts


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def traffic(vocab: int, seed: int = 0):
    """Prompt token arrays: lengths drawn from the seed in
    [PROMPT_LO, PROMPT_HI]; the SHARERS begin with one shared prefix."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(PROMPT_LO, PROMPT_HI + 1, N_REQUESTS)
    prefix = rng.randint(0, vocab, SHARED_PREFIX)
    prompts = []
    for i, n in enumerate(lengths):
        p = rng.randint(0, vocab, int(n))
        if i in SHARERS:
            p = np.concatenate([prefix, p[:max(16, int(n) - SHARED_PREFIX)]])
        prompts.append(p.astype(np.int32))
    return prompts


# ---------------------------------------------------------------------------
# phase 1: the card
# ---------------------------------------------------------------------------

def phase_card(torch, build, sources):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = build.build_libraries(sources)
    log(f"kernel libraries ready in {time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", " ".join(lib.ptxas))]
        spills = [line for line in lib.ptxas
                  if re.search(r"[1-9]\d* bytes spill stores", line)]
        if name == "paged_attention" and spills:
            raise AssertionError(f"the paged kernel spills: {spills}")
        log(f"{'built' if lib.built else 'loaded'} {lib.path.relative_to(ROOT)} "
            f"in {lib.seconds:.2f} s: {len(regs)} kernels, {min(regs, default=0)}-"
            f"{max(regs, default=0)} registers, {len(spills)} with spills "
            f"{spills[:3]}")
        for line in lib.ptxas:             # e.g. wgmma serialised by ptxas
            if "wgmma" in line:
                log(f"  ptxas: {line}")
    return card


# ---------------------------------------------------------------------------
# phase 2: kernel against plain
# ---------------------------------------------------------------------------

def make_case(torch, B, H, K, hd, bs, nbmax, n_blocks, pos, dtype, seed,
              inactive_last=False):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn(B, H, hd, device="cuda", generator=g).to(dt)
    kp = torch.randn(n_blocks, bs, K, hd, device="cuda", generator=g).to(dt)
    vp = torch.randn(n_blocks, bs, K, hd, device="cuda", generator=g).to(dt)
    ids = torch.randperm(n_blocks - 1, device="cuda", generator=g)[:B * nbmax] + 1
    bt = ids.reshape(B, nbmax).to(torch.int32)
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    if inactive_last:                  # a free slot: table at scratch, pos 0
        bt[-1] = 0
        pos[-1] = 0
    return q, kp, vp, bt, pos


def max_err(torch, ops, ref, case, split_len=None, ref_case=None, **kw):
    """max |kernel - plain| on one case.  The kernel runs twice and must
    give the same bits both times (its merge order is fixed).
    ``split_len`` forces the splits (``ops.launch_split``; else the
    wrapper's ``split_plan``); ``ref_case`` is the plain version's input
    where it differs."""
    if split_len is None:
        run = lambda: ops.paged_attention(*case, **kw)  # noqa: E731
    else:
        run = lambda: ops.launch_split(*case, split_len=split_len, **kw)  # noqa: E731
    o, o2 = run(), run()
    r = ref(*(ref_case or case), **kw)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(o).all()):
        raise AssertionError("kernel output is not finite")
    if not same_bits(torch, o, o2):
        raise AssertionError("two calls on the same inputs gave other bits")
    if o.dtype == torch.bfloat16 and over_bound(torch, o, r, TOL["float32"]) > 1:
        raise AssertionError(f"bf16 output more than one step plus {TOL['float32']} "
                             f"from the plain version ({over_bound(torch, o, r, TOL['float32']):.3g}"
                             f"x that bound)")
    return (o.float() - r.float()).abs().max().item()


def phase_kernel(torch, ops, ref):
    worst = {}
    n = 0
    for dtype in ("float32", "bfloat16"):
        worst[dtype] = 0.0
        for G in (1, 4, 8):
            for K in (1, 2):
                for hd in (64, 128, 256):
                    for bs in (4, 16):
                        nbmax = 5
                        # frontiers: first slot, end of block 0, start of
                        # block 1, inside a partial block, the last slot
                        pos = [0, bs - 1, bs, 2 * bs + bs // 2 + 1,
                               nbmax * bs - 1, 0]
                        case = make_case(torch, 6, G * K, K, hd, bs, nbmax,
                                         1 + 6 * nbmax + 2, pos, dtype,
                                         seed=n, inactive_last=True)
                        kws = [{}]
                        if hd == 128:
                            kws += [dict(window=9), dict(softcap=30.0),
                                    dict(window=2 * bs + 3, softcap=20.0)]
                        for kw in kws:
                            e = max_err(torch, ops, ref, case, **kw)
                            if e > TOL[dtype]:
                                raise AssertionError(
                                    f"{dtype} G={G} K={K} hd={hd} bs={bs} "
                                    f"{kw}: max abs err {e:.3g} > {TOL[dtype]}")
                            worst[dtype] = max(worst[dtype], e)
                            n += 1
        log(f"kernel vs plain {dtype}: max abs err {worst[dtype]:.3g} "
            f"(tolerance {TOL[dtype]})")
    decode = decode_case(torch, seed=1)
    e = max_err(torch, ops, ref, decode)
    if e > TOL["bfloat16"]:
        raise AssertionError(f"gemma-2b decode shape: max abs err {e:.3g}")
    log(f"kernel vs plain at the gemma-2b decode shape (bf16, B=8 H=8 K=1 "
        f"hd=256 bs=16): max abs err {e:.3g}; {n + 1} cases agree, each "
        f"bitwise the same on a second call")
    phase_kernel_splits(torch, ops, ref)
    return e


def check(torch, ops, ref, what, case, dtype, **kw):
    """max_err of one case, raising above TOL[dtype]."""
    e = max_err(torch, ops, ref, case, **kw)
    if e > TOL[dtype]:
        raise AssertionError(f"{what} {dtype}: max abs err {e:.3g} > {TOL[dtype]}")
    return e


def phase_kernel_splits(torch, ops, ref):
    """The split design's edges, each case run twice (same bits) and held
    to TOL against the plain version: split boundaries inside a pool
    block, frontiers on the first and the last position of a split,
    splits wholly past the frontier and wholly before the window, G not a
    power of two, tables of 1 and 512 columns, B * K of 1 and of 160
    (more than the card's 132 SMs), block ids outside the pool (read as
    the scratch block), and the three long cases of phase 5 in fp32 and
    bf16."""
    worst, n = {"float32": 0.0, "bfloat16": 0.0}, 0
    for dtype in ("float32", "bfloat16"):
        for G, K, hd in ((8, 1, 256), (3, 2, 128), (2, 4, 64)):
            for bs, split_len in ((16, 24), (16, 16), (4, 6), (16, 40)):
                nbmax = 8
                T = nbmax * bs
                # frontiers: the first and the last position of splits 0-2,
                # inside a pool block, the last slot, an inactive row
                pos = [0, split_len - 1, split_len, 2 * split_len - 1,
                       2 * split_len, 3 * split_len - 1, bs + bs // 2 + 1, T - 1, 0]
                case = make_case(torch, len(pos), G * K, K, hd, bs, nbmax,
                                 1 + len(pos) * nbmax + 2, pos, dtype,
                                 seed=1000 + n, inactive_last=True)
                for kw in ({}, dict(window=split_len + 1), dict(window=5, softcap=20.0)):
                    e = check(torch, ops, ref, f"G={G} K={K} hd={hd} bs={bs} split "
                              f"{split_len} {kw}", case, dtype, split_len=split_len, **kw)
                    worst[dtype] = max(worst[dtype], e)
                    n += 1
        for nbmax, pos in ((1, [0, 7, 15]), (512, [0, 4095, 8191])):
            case = make_case(torch, len(pos), 8, 1, 256, 16, nbmax,
                             1 + len(pos) * nbmax, pos, dtype, seed=2000 + n)
            for kw in ({}, dict(window=100)):
                e = check(torch, ops, ref, f"table of {nbmax} columns {kw}", case,
                          dtype, **kw)
                worst[dtype] = max(worst[dtype], e)
                n += 1
        for B, H, K, pos in ((1, 8, 1, [3000]), (20, 8, 8, list(range(20, 420, 20)))):
            case = make_case(torch, B, H, K, 128, 16, 256, 1 + B * 256, pos, dtype,
                             seed=3000 + n)
            e = check(torch, ops, ref, f"B*K={B * K}", case, dtype)
            worst[dtype] = max(worst[dtype], e)
            n += 1
        q, kp, vp, bt, pos = make_case(torch, 3, 8, 2, 128, 16, 6, 1 + 18 + 2,
                                       [90, 40, 70], dtype, seed=4000 + n)
        bad = bt.clone()
        bad[0, 1], bad[1, 0], bad[2, 4] = kp.shape[0] + 7, -3, kp.shape[0]
        clamped = torch.where((bad < 0) | (bad >= kp.shape[0]), 0, bad)
        e = check(torch, ops, ref, "out-of-pool block ids", (q, kp, vp, bad, pos),
                  dtype, ref_case=(q, kp, vp, clamped, pos))
        worst[dtype] = max(worst[dtype], e)
        n += 1
    for dtype in ("float32", "bfloat16"):
        for name, (case, kw) in long_cases(torch, seed=3, dtype=dtype).items():
            e = check(torch, ops, ref, name, case, dtype, **kw)
            worst[dtype] = max(worst[dtype], e)
            n += 1
            if "softcap" in kw:
                faulty_plain_fails(torch, ops, ref, name, case, kw)
            del case
            torch.cuda.empty_cache()
    log(f"split edges: {n} cases agree with the plain version, each bitwise the "
        f"same on a second call; max abs err fp32 {worst['float32']:.3g}, bf16 "
        f"{worst['bfloat16']:.3g}")


def faulty_plain_fails(torch, ops, ref, name, case, kw):
    """The window/softcap case can fail a wrong kernel: the plain version
    with the softcap dropped, or the window edge moved by one position
    either way, must break the bound against the kernel's output."""
    o = ops.paged_attention(*case, **kw)
    tol = TOL[str(o.dtype).split(".")[-1]]
    shares = {}
    for fault, kw_bad in {"no softcap": dict(kw, softcap=0.0),
                          "window + 1": dict(kw, window=kw["window"] + 1),
                          "window - 1": dict(kw, window=kw["window"] - 1)}.items():
        shares[fault] = (o.float() - ref(*case, **kw_bad).float()).abs().max().item()
        if shares[fault] <= tol:
            raise AssertionError(f"{name}: the plain version with {fault} passes "
                                 f"against the kernel ({shares[fault]:.3g})")
    log(f"  {name}: a kernel with a fault would fail: the plain version with "
        + ", ".join(f"{f} is {e:.3g}" for f, e in shares.items())
        + f" from the kernel's output ({o.dtype}, bound {tol})")


def long_cases(torch, seed, dtype="bfloat16"):
    """Phase 5's three long cases, each with its keyword arguments.
    gemma-2b at long context: B 8, H 8, K 1, hd 256, 512 columns of 16,
    frontiers 8000-8191 (66 MB of K and V in bf16); the same for one
    sequence at 8191 (128 splits: the merge's two levels).  A gemma2-27b
    local layer:
    B 8, H 32, K 16, hd 128, window 4096, softcap 50, frontiers 6000-8191,
    q scaled to scores of std 2; at the window's edge (the first position
    inside and the last outside) and 7 positions before the frontier, each
    kv head's key is set so that its G queries score 40, 40 and 35 there,
    so moving the edge by one position or dropping the softcap moves the
    output by far more than the bound."""
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    fr2 = (8000 + torch.randint(0, 192, (8,), generator=g)).tolist()
    fr2[:2] = [8000, 8191]
    fr27 = (6000 + torch.randint(0, 2192, (8,), generator=g)).tolist()
    fr27[:2] = [6000, 8191]
    cases = {"gemma-2b long": (make_case(torch, 8, 8, 1, 256, 16, 512, 1 + 8 * 512,
                                         fr2, dtype, seed), {}),
             "gemma-2b long, one sequence": (make_case(
                 torch, 1, 8, 1, 256, 16, 512, 1 + 512, [8191], dtype, seed + 2), {})}
    q, kp, vp, bt, pos = make_case(torch, 8, 32, 16, 128, 16, 512, 1 + 8 * 512,
                                   fr27, dtype, seed + 1)
    window, softcap = 4096, 50.0
    q = (Q_SCALE_LOCAL * q.float()).to(q.dtype)
    B, H, hd = q.shape
    K, G = kp.shape[2], H // kp.shape[2]
    qg = q.float().reshape(B, K, G, hd)
    gram_inv = torch.linalg.inv(qg @ qg.transpose(-1, -2))           # (B, K, G, G)
    for offset, score in ((window, 40.0), (window - 1, 40.0), (7, 35.0)):
        want = torch.full((B, K, G, 1), score / hd ** -0.5, device="cuda")
        k = (qg.transpose(-1, -2) @ gram_inv @ want)[..., 0]         # (B, K, hd)
        t = (pos.long() - offset).tolist()
        for b in range(B):
            kp[bt[b, t[b] // 16], t[b] % 16] = k[b].to(kp.dtype)
    cases["gemma2-27b local"] = ((q, kp, vp, bt, pos),
                                 dict(window=window, softcap=softcap))
    return cases


def decode_case(torch, seed):
    """Phase 3's decode shape: 8 slots of gemma-2b (H 8, K 1, hd 256),
    block size 16, a table for the longest context, bf16 pools, and
    frontiers 32 tokens into the generation of the first 8 prompts.
    Every slot owns distinct blocks."""
    lengths = [len(p) for p in traffic(256000)[:SLOTS]]
    nbmax = -(-(PROMPT_HI + MAX_NEW) // BLOCK_SIZE)
    return make_case(torch, SLOTS, 8, 1, 256, BLOCK_SIZE, nbmax,
                     1 + SLOTS * nbmax, [n + 32 for n in lengths], "bfloat16",
                     seed)


# ---------------------------------------------------------------------------
# phase 3: full-width serving
# ---------------------------------------------------------------------------

def phase_serve(torch, kernels, serve_mod, cfg, rt):
    t0 = time.perf_counter()
    params, n_params = serve_mod.load_model(cfg, rt, seed=0)
    torch.cuda.synchronize()
    log(f"{cfg.name}: {n_params:,} params drawn on the card from PRNGKey(0) "
        f"as the JAX package draws them (fp32, matmul weights then cast once "
        f"to {cfg.compute_dtype}) in {time.perf_counter() - t0:.2f} s")
    prompts = traffic(cfg.vocab_size)
    sched = serve_mod.build_scheduler(
        cfg, params, rt, slots=SLOTS, block_size=BLOCK_SIZE,
        blocks=POOL_BLOCKS, ctx=PROMPT_HI + MAX_NEW, decode_chunk=DECODE_CHUNK)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    finished = serve_mod.serve(sched, prompts, MAX_NEW, per_round=PER_ROUND)
    dt = time.perf_counter() - t0
    launches = kernels.launch_counts()["paged_decode_attention"]
    st = sched.stats
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    lats = [r.t_done - r.t_submit for r in finished]
    tokens = sum(len(r.out) for r in finished)
    log(f"served {len(finished)} requests, {tokens} tokens in {dt:.2f} s: "
        f"{tokens / dt:.1f} tok/s; latency p50 {np.percentile(lats, 50):.3f} s "
        f"p99 {np.percentile(lats, 99):.3f} s")
    log(f"peak blocks {st['peak_used_blocks']}/{POOL_BLOCKS - 1}, preemptions "
        f"{st['preemptions']}, COW-shared blocks {st['cow_shared_blocks']}, "
        f"prefill calls {st['prefill_calls']}, decode steps {st['decode_steps']}, "
        f"peak device memory {peak_gib:.2f} GiB")
    log(f"paged_decode_attention launches {launches} = {cfg.n_layers} layers x "
        f"{st['decode_steps']} decode steps")
    log(f"host time: prefill {st['prefill_s']:.3f} s over {st['prefill_calls']} "
        f"calls, decode {st['decode_s']:.3f} s = "
        f"{st['decode_s'] / st['decode_steps'] * 1e3:.2f} ms per decode step")
    if sorted(r.rid for r in finished) != list(range(N_REQUESTS)):
        raise AssertionError("not every request finished")
    if any(len(r.out) != MAX_NEW or not all(0 <= t < cfg.vocab_size for t in r.out)
           for r in finished):
        raise AssertionError("a request emitted the wrong number of tokens or "
                             "a token outside the vocabulary")
    if launches != cfg.n_layers * st["decode_steps"] or launches == 0:
        raise AssertionError(f"{launches} kernel launches for "
                             f"{st['decode_steps']} decode steps")
    if st["preemptions"] < 1 or st["cow_shared_blocks"] < 1:
        raise AssertionError("the traffic did not preempt or share a prefix")
    sched.alloc.check()
    if sched.alloc.used_blocks:
        raise AssertionError(f"{sched.alloc.used_blocks} blocks leaked")
    summary = {"tok_s": tokens / dt, "p50_s": np.percentile(lats, 50),
               "p99_s": np.percentile(lats, 99),
               "step_ms": st["decode_s"] / st["decode_steps"] * 1e3,
               "prefill_calls": st["prefill_calls"],
               "prefill_shapes": len(st["prefill_shapes"]), "peak_gib": peak_gib}
    return params, launches, summary


# ---------------------------------------------------------------------------
# phase 4: whole decode path, kernel against plain gather
# ---------------------------------------------------------------------------

def phase_path(torch, cfg, params, Runtime, device, serving, steps=4,
               dense=False):
    """Prefill 8 prompts once, splice them into two pools, and run
    ``steps`` teacher-forced decode steps through the kernel path and
    through the model's plain gather path.  With ``dense`` (phase 22b)
    the same prefill, padded to the pools' gathered length, also feeds
    the dense engine, and every engine is fed the dense engine's greedy
    tokens: dense against the plain gather path at matched geometry
    (bitwise in fp32, else DENSE_REL), dense against the kernel path
    within LOGIT_REL."""
    from repro_torch.serving import paged_cache as pc
    prompts = traffic(cfg.vocab_size, seed=1)[:SLOTS]
    S = max(len(p) for p in prompts)
    toks = np.zeros((SLOTS, S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    last = np.array([len(p) - 1 for p in prompts], np.int32)
    rt_k, rt_p = Runtime(device, paged_kernel=True), Runtime(device, paged_kernel=False)
    logits, prefilled = serving.make_prefill_step(cfg, rt_k)(
        params, torch.from_numpy(toks).to(device),
        last_pos=torch.from_numpy(last).to(device))
    nbmax = pc.n_blocks_for(S + steps, BLOCK_SIZE)
    caches = []
    for _ in range(2):
        paged = pc.paged_cache_init(cfg, SLOTS, BLOCK_SIZE, 1 + SLOTS * nbmax,
                                    nbmax, device)
        for row in range(SLOTS):
            ids = list(range(1 + row * nbmax, 1 + (row + 1) * nbmax))
            pc.set_block_table(paged, row, ids)
            pc.splice_prefill(paged, prefilled, row, row, ids)
        caches.append(paged)
    if dense:
        caches.append(serving.pad_cache(prefilled, nbmax * BLOCK_SIZE - S))
    del prefilled
    step_k = serving.make_serve_step(cfg, rt_k)
    step_p = serving.make_serve_step(cfg, rt_p)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    pos = torch.from_numpy(last + 1).to(device)
    worst = worst_dk = worst_dp = 0.0
    agree = agree_dk = 0
    bitwise = True
    for i in range(steps):
        nk, lk, caches[0] = step_k(params, caches[0], tok, pos)
        npl, lp, caches[1] = step_p(params, caches[1], tok, pos)
        if not bool(torch.isfinite(lk).all()):
            raise AssertionError("kernel-path logits are not finite")
        rel = ((lk - lp).abs().max() / lp.abs().max()).item()
        worst = max(worst, rel)
        agree += int((nk == npl).sum())
        msg = (f"decode step {i}: max|dlogits|/max|logits| {rel:.3g}, "
               f"max|logits| {lp.abs().max().item():.4g}")
        nxt = nk
        if dense:
            nd, ld, caches[2] = step_p(params, caches[2], tok, pos)
            if not bool(torch.isfinite(ld).all()):
                raise AssertionError("dense-engine logits are not finite")
            bitwise &= bool(torch.equal(ld, lp))
            dp = ((ld - lp).abs().max() / lp.abs().max()).item()
            dk = ((ld - lk).abs().max() / lk.abs().max()).item()
            worst_dp, worst_dk = max(worst_dp, dp), max(worst_dk, dk)
            agree_dk += int((nd == nk).sum())
            msg = (f"decode step {i}: dense vs plain gather {dp:.3g} (bitwise "
                   f"{bool(torch.equal(ld, lp))}), dense vs kernel {dk:.3g}, "
                   f"kernel vs plain gather {rel:.3g} of max|logits| "
                   f"{lp.abs().max().item():.4g}")
            nxt = nd
        log(msg)
        tok, pos = nxt[:, None], pos + 1          # teacher-force every path
    bound = LOGIT_REL[cfg.compute_dtype]
    log(f"whole path ({cfg.compute_dtype} compute), kernel vs plain gather "
        f"over {steps} steps: worst {worst:.3g} (bound {bound}); greedy tokens "
        f"agree {agree}/{steps * SLOTS}")
    if worst > bound:
        raise AssertionError(f"kernel path logits differ by {worst:.3g}")
    if not dense:
        return
    log(f"22b ({cfg.compute_dtype}): dense engine vs paged plain gather at "
        f"matched geometry (context {nbmax * BLOCK_SIZE}) over {steps} steps: "
        f"{'bitwise' if bitwise else 'not bitwise'}, worst {worst_dp:.3g} of "
        f"max|logits|; dense vs paged kernel worst {worst_dk:.3g} (bound "
        f"{bound}); greedy tokens agree {agree_dk}/{steps * SLOTS}")
    if cfg.compute_dtype == "float32" and not bitwise and worst_dp > DENSE_REL:
        raise AssertionError(f"dense vs plain gather differ by {worst_dp:.3g} "
                             f"(bound {DENSE_REL})")
    if worst_dk > bound:
        raise AssertionError(f"dense vs kernel path logits differ by {worst_dk:.3g}")


# ---------------------------------------------------------------------------
# phase 22: the dense serving engine
# ---------------------------------------------------------------------------

# 22b: in fp32 the dense engine and the paged plain gather path run the
# same ops on the same values at matched geometry, so they should agree
# bitwise, as the JAX package's test holds them; if the card's GEMMs pick
# another algorithm for the two (other pointers), their logits may differ
# in the last bits, which the stack can grow to ~1e-6 of the max logit
DENSE_REL = 2e-5
LONG_PROMPT, LONG_STEPS = 8448, 4      # past for_long_context()'s window of 8192


def phase_dense_serve(torch, kernels, serve_mod, cfg, rt, params, paged_fig):
    """22a: phase 3's traffic (all 16 requests queued at once) on the
    dense engine through the launcher's ``ContinuousBatcher`` and
    ``serve_dense``; the launch counts set to 0 just before, read just
    after: the paged kernel must not launch."""
    prompts = traffic(cfg.vocab_size)
    batcher = serve_mod.ContinuousBatcher(cfg, params, SLOTS,
                                          PROMPT_HI + MAX_NEW, rt=rt)
    step_s, admit_s = [], []

    def timed(fn, into):
        def run(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            into.append(time.perf_counter() - t0)
            return out
        return run
    batcher.decode_step = timed(batcher.decode_step, step_s)   # ends in a sync
    batcher._admit = timed(batcher._admit, admit_s)            # ends in a sync
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    finished = serve_mod.serve_dense(batcher, prompts, MAX_NEW)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    lats = [r.t_done - r.t_submit for r in finished]
    tokens = sum(len(r.out) for r in finished)
    ms = np.array(step_s) * 1e3
    log(f"22a dense: served {len(finished)} requests, {tokens} tokens in "
        f"{dt:.2f} s: {tokens / dt:.1f} tok/s; latency p50 "
        f"{np.percentile(lats, 50):.3f} s p99 {np.percentile(lats, 99):.3f} s; "
        f"{len(step_s)} decode steps, {np.median(ms):.2f} ms median "
        f"({ms.min():.2f}-{ms.max():.2f}); {len(admit_s)} prefill calls, "
        f"{len(batcher.prefill_shapes)} distinct shapes, {sum(admit_s):.3f} s "
        f"(with the splice); peak device memory {peak_gib:.2f} GiB; "
        f"paged_decode_attention launches {launches['paged_decode_attention']}")
    if paged_fig is None:
        log("22a paged: phase 3 not run (--dense-only)")
    else:
        log(f"22a paged (phase 3, 2 arrivals a round, a pool that preempts): "
            f"{paged_fig['tok_s']:.1f} tok/s; latency p50 {paged_fig['p50_s']:.3f} "
            f"s p99 {paged_fig['p99_s']:.3f} s; {paged_fig['step_ms']:.2f} ms a "
            f"decode step; {paged_fig['prefill_calls']} prefill calls, "
            f"{paged_fig['prefill_shapes']} distinct shapes; peak device memory "
            f"{paged_fig['peak_gib']:.2f} GiB (a reading beside the dense "
            f"engine's, not a benchmark)")
    if sorted(r.rid for r in finished) != list(range(N_REQUESTS)):
        raise AssertionError("dense: not every request finished")
    if any(len(r.out) != MAX_NEW or not all(0 <= t < cfg.vocab_size for t in r.out)
           for r in finished):
        raise AssertionError("dense: a request emitted the wrong number of "
                             "tokens or a token outside the vocabulary")
    if any(launches.values()):
        raise AssertionError(f"the dense engine launched kernels: {launches}")
    if len(admit_s) != N_REQUESTS or len(batcher.prefill_shapes) != len(
            {len(p) for p in prompts}):
        raise AssertionError("dense: one prefill a request, one shape a length")


@contextlib.contextmanager
def unrotated_prefill(layers):
    """Prefill caches kept whole past the window (``ring_cache`` called
    with no window): the linear layout, position t at index t, that a
    rotated ring is held against.  The attention masks are untouched."""
    ring_cache = layers.ring_cache
    layers.ring_cache = lambda entries, S, window: ring_cache(entries, S, 0)
    try:
        yield
    finally:
        layers.ring_cache = ring_cache


def phase_dense_rotation(torch, serving, layers, cfg, rt, params):
    """22c: gemma-2b ``for_long_context()`` (every layer windowed, W
    8192) at fp32 compute: prefill one prompt of LONG_PROMPT tokens (the
    rings rotate) and decode LONG_STEPS steps on the rings as they are
    (no ``pad_cache``); the same prefill kept whole (``unrotated_prefill``),
    padded, and decoded on the same tokens, where the window is a mask
    only.  Held: ring against linear within LOGIT_REL["float32"] each
    step, and ``pad_cache`` refusing the ring.  Logged: each layout
    against a teacher-forced prefill of the prefix, and the logits' move
    under a one-ulp scale of one weight leaf (the stack's own noise
    scale at this length)."""
    lc = cfg.for_long_context()
    toks = np.random.RandomState(7).randint(
        0, lc.vocab_size, (1, LONG_PROMPT + LONG_STEPS)).astype(np.int32)
    toks = torch.from_numpy(toks).to(rt.device)
    prefill = serving.make_prefill_step(lc, rt)
    step = serving.make_serve_step(lc, rt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, ring = prefill(params, toks[:, :LONG_PROMPT])
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    sp = ring["blocks.L0.attn.slot_pos"]
    if tuple(sp.shape) != (lc.n_layers, 1, lc.window) or int(sp.min()) != \
            LONG_PROMPT - lc.window or int(sp[0, 0, 0]) == 0:
        raise AssertionError(f"the prefill did not rotate the rings: "
                             f"{tuple(sp.shape)}, first slot {int(sp[0, 0, 0])}")
    with unrotated_prefill(layers):
        _, linear = prefill(params, toks[:, :LONG_PROMPT])
    linear = serving.pad_cache(linear, LONG_STEPS)
    worst = {"ring-linear": 0.0, "ring-teacher": 0.0, "linear-teacher": 0.0}
    step_ms = []
    for i in range(LONG_STEPS):
        pos = torch.full((1,), LONG_PROMPT + i, dtype=torch.int32,
                         device=rt.device)
        feed = toks[:, LONG_PROMPT + i:][:, :1]
        t0 = time.perf_counter()
        _, lr, ring = step(params, ring, feed, pos)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        _, ll, linear = step(params, linear, feed, pos)
        ref, _ = prefill(params, toks[:, :LONG_PROMPT + i + 1])
        ref = ref[:, -1]
        if i == 0:
            first_ref = ref
        if not bool(torch.isfinite(lr).all()):
            raise AssertionError("rotated-ring logits are not finite")
        rel = {k: ((a - b).abs().max() / b.abs().max()).item() for k, a, b in
               (("ring-linear", lr, ll), ("ring-teacher", lr, ref),
                ("linear-teacher", ll, ref))}
        worst = {k: max(worst[k], rel[k]) for k in worst}
        log(f"22c step {i} (position {LONG_PROMPT + i}): max|dlogits|/max|logits| "
            f"ring vs linear {rel['ring-linear']:.3g}, ring vs teacher-forced "
            f"prefill {rel['ring-teacher']:.3g}, linear vs teacher-forced "
            f"{rel['linear-teacher']:.3g}, max|logits| {ref.abs().max().item():.4g}; "
            f"ring decode {step_ms[-1]:.2f} ms")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    leaf = "blocks.L0.attn.wq"
    nudged = dict(params, **{leaf: params[leaf] * (1 + 2**-23)})
    moved, _ = prefill(nudged, toks[:, :LONG_PROMPT + 1])
    del nudged
    ulp = ((moved[:, -1] - first_ref).abs().max() / first_ref.abs().max()).item()
    try:
        serving.pad_cache(ring, 1)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("pad_cache accepted a rotated ring")
    bound = LOGIT_REL["float32"]
    log(f"22c rotated ring ({lc.n_layers} layers, window {lc.window}, prompt "
        f"{LONG_PROMPT}, fp32) over {LONG_STEPS} steps: worst ring vs linear "
        f"{worst['ring-linear']:.3g} (bound {bound}); against teacher forcing "
        f"(a reading) ring {worst['ring-teacher']:.3g}, linear "
        f"{worst['linear-teacher']:.3g}; {leaf} scaled by 1 + 2^-23 moves the "
        f"prefill's logits by {ulp:.3g} of max|logits|; prefill "
        f"{t_prefill:.2f} s; ring decode {np.median(step_ms):.2f} ms median; "
        f"peak device memory {peak_gib:.2f} GiB (the teacher-forced prefills' "
        f"fp32 scores, 1 x {lc.n_heads} x {LONG_PROMPT + LONG_STEPS - 1} "
        f"squared); pad_cache refused the ring: {refused}")
    if worst["ring-linear"] > bound:
        raise AssertionError(f"ring decode differs from the linear layout's by "
                             f"{worst['ring-linear']:.3g}")


def phase_dense(torch, kernels, serve_mod, serving, layers, Runtime, cfg, rt,
                paged_fig):
    """Phase 22, the dense serving engine at full width: (a) serving at
    the served bf16 compute, (b) teacher-forced against both paged paths
    in bf16 and fp32, (c) the rotated ring at long context, (d) its
    seconds."""
    t0 = time.perf_counter()
    params, _ = serve_mod.load_model(cfg, rt, seed=0)
    phase_dense_serve(torch, kernels, serve_mod, cfg, rt, params, paged_fig)
    t_a = time.perf_counter()
    phase_path(torch, cfg, params, Runtime, rt.device, serving, dense=True)
    del params
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    params32, _ = serve_mod.load_model(cfg32, rt, seed=0)
    phase_path(torch, cfg32, params32, Runtime, rt.device, serving, dense=True)
    t_b = time.perf_counter()
    phase_dense_rotation(torch, serving, layers, cfg32, rt, params32)
    del params32
    torch.cuda.empty_cache()
    t_c = time.perf_counter()
    log(f"phase 22: {t_c - t0:.1f} s (22a {t_a - t0:.1f} s with the bf16 "
        f"weights, 22b {t_b - t_a:.1f} s with the fp32 weights, 22c "
        f"{t_c - t_b:.1f} s)")


# ---------------------------------------------------------------------------
# phase 5: timing against the bound
# ---------------------------------------------------------------------------

SPIN_CYCLES_PER_US = 1980          # the H100's highest SM clock, 1.98 GHz


def time_kernel(torch, fn, n=50, flush_bytes=128 << 20):
    """(median device ms, median host enqueue ms) of ``fn()`` over n
    calls.  Before each call a write of ``flush_bytes`` leaves L2 cold,
    as a decode step finds it, and a device spin (``torch.cuda._sleep``)
    follows it before the start event: the host enqueues ``fn`` while the
    card is still busy, so the two events bracket device work only.  The
    spin lasts about 100 us, or twice the slower enqueue of the last two
    warm-up calls if that is longer (the first may set something up).
    The enqueue time is the host clock around ``fn()``."""
    scratch = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        warm.append((time.perf_counter() - t0) * 1e6)
    spin = int(SPIN_CYCLES_PER_US * max(100.0, 2 * max(warm[1:])))
    times, host = [], []
    for _ in range(n):
        scratch.zero_()
        torch.cuda._sleep(spin)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times)), float(np.median(host))


def time_calls(torch, fn, n=50, flush_bytes=128 << 20):
    """Median device ms of ``fn()`` (``time_kernel``)."""
    return time_kernel(torch, fn, n, flush_bytes)[0]


PAGED_SOURCE = "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu"


def paged_work(torch, case, kw):
    """(bytes, flops) the function needs on this case: each live K and V
    row read once, q read and o written once, the table and frontiers;
    4 flops (QK and PV, 2 a FMA) per live position, head and element."""
    q, kp, vp, bt, pos = case
    B, H, hd = q.shape
    _, bs, K, _ = kp.shape
    hi = pos.long().clamp(max=bt.shape[1] * bs - 1)
    lo = (pos.long() - kw.get("window", 0) + 1).clamp(min=0) if kw.get("window") else 0
    n_t = int((hi - lo + 1).sum())
    item = q.element_size()
    nbytes = 2 * n_t * K * hd * item + 2 * q.numel() * item + bt.numel() * 4 + pos.numel() * 4
    return nbytes, 4 * n_t * K * (H // K) * hd


def block_copy(torch, case, kw):
    """(ms, bytes) of ``index_select`` copying the pool blocks that hold
    live positions, K and V: the rate at which a PyTorch call moves
    these blocks in their scattered order, beside the kernel's."""
    q, kp, vp, bt, pos = case
    bs = kp.shape[1]
    cols = torch.arange(bt.shape[1], device=bt.device)[None, :]
    hi = pos.long()[:, None] // bs
    lo = ((pos.long() - kw["window"] + 1).clamp(min=0) // bs)[:, None] if kw.get("window") else 0
    ids = bt[(cols <= hi) & (cols >= lo)].long()
    ms = time_calls(torch, lambda: (kp.index_select(0, ids), vp.index_select(0, ids)))
    return ms, 4 * ids.numel() * kp[0].numel() * kp.element_size()


def paged_resources(torch, ops, dtype, hd, G):
    """Registers and spill bytes of the instantiation a case runs, from
    the library's ptxas lines (``kernel_resources``)."""
    gp = 1 << (G - 1).bit_length()
    tname = "bf16" if dtype == torch.bfloat16 else "float"
    res = kernel_resources(ops.library())
    hits = [r for k, r in res.items() if "paged_split_kernel" in k and (
        re.search(rf"{tname}\w*, (\(int\))?{hd}, (\(int\))?{gp}>", k)
        or re.search(rf"{'bf16_tE' if tname == 'bf16' else 'If'}Li{hd}ELi{gp}E", k))]
    return hits[0] if len(hits) == 1 else None


def phase_timing(torch, ops, ref, launches, err, n_layers, step_ms):
    """The paged kernel's time at four shapes: phase 3's decode shape
    (the kernels line's row) and the bf16 ``long_cases``, each beside its
    plain version, gather + SDPA (no softcap only), its byte bound and
    the share of it, its split plan and its instantiation's registers
    and spills (none allowed)."""
    import torch.nn.functional as F
    shapes = {"decode": (decode_case(torch, seed=2), {})}
    shapes.update(long_cases(torch, seed=4))
    row = None
    for name, (case, kw) in shapes.items():
        q, kp, vp, bt, pos = case
        B, H, hd = q.shape
        _, bs, K, _ = kp.shape
        G, T = H // K, bt.shape[1] * bs
        nbytes, flops = paged_work(torch, case, kw)
        bound_s = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)
        bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS else "operations"
        split_len, n_split = ops.split_plan(T, bs, B * K, ops.sm_count(q.device))
        res = paged_resources(torch, ops, q.dtype, hd, G)
        if res is None or res["spill_bytes"]:
            raise AssertionError(f"{name}: its kernel's ptxas lines {res}: no spills allowed")
        call = lambda: ops.paged_attention(q, kp, vp, bt, pos, **kw)  # noqa: E731
        lib_ms, lib_note = None, "no single PyTorch call has softcap"
        if "softcap" not in kw:
            valid = torch.arange(T, device="cuda")[None, :] <= pos[:, None].long()
            if kw.get("window"):
                valid &= torch.arange(T, device="cuda")[None, :] > pos[:, None].long() - kw["window"]

            def library():                          # gather + SDPA: the yardstick
                kd = kp[bt.long()].reshape(B, T, K, hd).transpose(1, 2)
                vd = vp[bt.long()].reshape(B, T, K, hd).transpose(1, 2)
                return F.scaled_dot_product_attention(
                    q[:, :, None], kd, vd, attn_mask=valid[:, None, None, :],
                    enable_gqa=True)[:, :, 0]
            lib_err = (library().float() - ref(*case, **kw).float()).abs().max().item()
            lib_ms = time_calls(torch, library)
            lib_note = f"gather+SDPA {lib_ms:.4f} ms (max abs err vs plain {lib_err:.3g})"
        ms, enq = time_kernel(torch, call)
        ms2 = time_calls(torch, call)
        plain_ms = time_calls(torch, lambda: ref(*case, **kw), n=10)
        copy_ms, copy_bytes = block_copy(torch, case, kw)
        log(f"paged_decode_attention {name} (B {B} H {H} K {K} hd {hd} bs {bs}, "
            f"{bt.shape[1]} columns, frontiers {int(pos.min())}-{int(pos.max())}, {kw}): "
            f"kernel {ms:.4f} / {ms2:.4f} ms (host enqueue {enq:.4f} ms), plain "
            f"{plain_ms:.4f} ms, {lib_note}; bound {bound_s * 1e3:.4f} ms by {bound_by} "
            f"({nbytes:,} bytes, {flops:,} flops), {100 * bound_s * 1e3 / ms:.1f} % of "
            f"it; split_len {split_len}, n_split {n_split}, {B * K * n_split} blocks; "
            f"{res['registers']} registers, {res['spill_bytes']} bytes spilled; "
            f"index_select of the live pool blocks {copy_ms:.4f} ms, "
            f"{copy_bytes / copy_ms / 1e9:.3f} TB/s counting reads and writes")
        if name == "decode" and step_ms:
            log(f"  {n_layers} launches take {100 * n_layers * ms / step_ms:.1f} % of "
                f"a {step_ms:.2f} ms decode step")
        if name == "decode":
            row = {"name": "paged_decode_attention", "route": "cuda",
                   "source": PAGED_SOURCE,
                   "replaces": "src/repro/kernels/paged_attention/kernel.py:88",
                   "launches": launches, "max_abs_err": err, "ms": ms,
                   "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
                   "bound_by": bound_by, "library_ms": lib_ms, "enqueue_ms": enq}
        del case, q, kp, vp
        torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# phase 6: the multi-tensor kernels against plain, and their times
# ---------------------------------------------------------------------------

MT_SOURCE = "src/repro_torch/kernels/multi_tensor/csrc/multi_tensor.cu"
REPLACES = {"chunk_sumsq": "src/repro/kernels/multi_tensor/kernel.py:156",
            "fused_update": "src/repro/kernels/multi_tensor/kernel.py:211",
            "fused_update_deferred": "src/repro/kernels/multi_tensor/kernel.py:211",
            "scale_apply": "src/repro/kernels/multi_tensor/kernel.py:273",
            "adam_update": "src/repro/kernels/multi_tensor/kernel.py:340",
            "fused_sngm_update": "src/repro/kernels/fused_sngm/kernel.py:41",
            "lars_sqnorm": "src/repro/kernels/fused_lars/kernel.py:37",
            "lars_update": "src/repro/kernels/fused_lars/kernel.py:64",
            "rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:28",
            "flash_attention": "src/repro/kernels/flash_attention/kernel.py:83"}


def mt_inputs(torch, n, dtype, seed, signed_zeros=False):
    """Flat p, g (dtype), u (f32) of n elements and per-row coefficients."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    dt = getattr(torch, dtype)
    p = torch.randn(n, device="cuda", generator=gen).to(dt)
    g = torch.randn(n, device="cuda", generator=gen).to(dt)
    u = torch.randn(n, device="cuda", generator=gen)
    a = torch.rand(n // 1024, device="cuda", generator=gen) + 0.5
    if signed_zeros:                   # zeros of both signs in p, g and u
        for t in (p, g, u):
            t[::7] = 0.0
            t[3::7] = -0.0
    return p, g, u, a


def same_bits(torch, a, b):
    """Equal bit patterns (torch.equal calls -0.0 and 0.0 equal)."""
    iview = {2: torch.int16, 4: torch.int32}
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(iview[a.element_size()]), b.view(iview[b.element_size()])))


def mt_compare(torch, ops, ref, p, g, u, a, errs, rows=1 << 16, **kw):
    """Kernels (fused_update on clones of p and u) against the plain
    versions, bitwise, ``rows`` rows at a time so that the plain
    version's temporaries stay small.  Folds the largest absolute
    difference seen into ``errs`` (0.0 unless it raises)."""
    c = torch.tensor(0.37)
    kp, ku = p.clone(), u.clone()
    kq = ops.fused_update(kp, g, ku, a, c, **kw)
    ks = ops.chunk_sumsq(g, p, wd=kw["wd"])
    kr = ops.chunk_sumsq(g)
    step = rows * 1024
    for lo in range(0, p.numel(), step):
        sl = slice(lo, min(lo + step, p.numel()))
        rl = slice(lo // 1024, sl.stop // 1024)
        rp, ru, rq = ref.fused_update_ref(p[sl], g[sl], u[sl], a[rl], c, **kw)
        pairs = {"fused_update": ((kp[sl], rp), (ku[sl], ru), (kq[rl], rq)),
                 "chunk_sumsq": ((ks[rl], ref.chunk_sumsq_ref(g[sl], p[sl], wd=kw["wd"])),
                                 (kr[rl], ref.chunk_sumsq_ref(g[sl])))}
        for name, ps in pairs.items():
            for k, r in ps:
                errs[name] = max(errs[name], (k.float() - r.float()).abs().max().item())
                if not same_bits(torch, k, r):
                    raise AssertionError(
                        f"{name} differs from its plain version at rows "
                        f"{rl.start}-{rl.stop} ({kw}, {p.dtype}): max abs "
                        f"diff {errs[name]:.3g}")
    torch.cuda.synchronize()


def gemma_layout(torch, cfg):
    """The layout of gemma-2b's params: one fp32 bucket."""
    from repro_torch.core.multi_tensor import build_layout
    from repro_torch.models import model_defs
    from repro_torch.models.param import flatten_defs
    meta = {k: torch.empty(d.shape, dtype=d.dtype, device="meta")
            for k, d in flatten_defs(model_defs(cfg)).items()}
    layout = build_layout(meta)
    if len(layout.buckets) != 1:
        raise AssertionError(f"{len(layout.buckets)} buckets, expected one")
    return layout


def phase_mt_kernels(torch, ops, ref, cfg):
    errs = {"chunk_sumsq": 0.0, "fused_update": 0.0}
    n_cases = 0
    for dtype in ("float32", "bfloat16"):
        for seed, signed_zeros in ((0, False), (1, True)):
            p, g, u, a = mt_inputs(torch, 4 * ref.TILE, dtype, seed, signed_zeros)
            for wd in (0.0, 1e-4):
                for cast_g_first in (False, True):
                    for nesterov in (False, True):
                        mt_compare(torch, ops, ref, p, g, u, a, errs, beta=0.9, wd=wd,
                                   cast_g_first=cast_g_first, nesterov=nesterov)
                        n_cases += 1
    n = gemma_layout(torch, cfg).buckets[0].n_elems
    p, g, u, a = mt_inputs(torch, n, "float32", seed=2)
    a.fill_(1.0 / 300.0)               # SNGM's one global coefficient
    mt_compare(torch, ops, ref, p, g, u, a, errs, beta=0.9, wd=1e-4)
    log(f"chunk_sumsq and fused_update equal their plain versions bitwise in "
        f"{n_cases} cases of 262,144 elements (fp32/bf16, wd 0/1e-4, both cast "
        f"orders, nesterov, per-row coefficients, signed zeros) and on the full "
        f"gemma-2b fp32 buffer of {n:,} elements (sngm, wd 1e-4); max abs "
        f"diff {errs}")
    return (p, g, u, a), errs


def phase_mt_timing(torch, ops, ref, p, g, u, a, errs, n=20):
    """Times on the full gemma-2b fp32 buffer, in the variants an SNGM
    step launches (decayed norm, wd 1e-4; update without nesterov)."""
    c, wd = torch.tensor(1.6), 1e-4
    n_el, n_rows = p.numel(), p.numel() // 1024
    rows = {}
    # the plain versions' temporaries on the whole buffer would not fit
    # beside it, so each plain call walks it in 4 slices of rows
    q = n_el // 4

    def quarters(fn):
        return lambda: [fn(slice(i, i + q)) for i in range(0, n_el, q)]
    # chunk_sumsq, decayed (the main path's variant): reads g and p
    nbytes = 2 * 4 * n_el + 4 * n_rows
    flops = 4 * n_el                   # wd*p, +g, square, add
    ms, enq = time_kernel(torch, lambda: ops.chunk_sumsq(g, p, wd=wd), n)
    plain_ms = time_calls(torch, quarters(
        lambda sl: ref.chunk_sumsq_ref(g[sl], p[sl], wd=wd)), n)
    ms2 = time_calls(torch, lambda: ops.chunk_sumsq(g, p, wd=wd), n)
    raw_ms = time_calls(torch, lambda: ops.chunk_sumsq(g), n)
    lib = lambda: torch.linalg.vector_norm(g.view(-1, 1024), dim=1).square()  # noqa: E731
    lib_err = max((lib()[i // 1024:(i + q) // 1024] - ref.chunk_sumsq_ref(
        g[i:i + q])).abs().max().item() for i in range(0, n_el, q))
    lib_ms = time_calls(torch, lib, n)
    raw_bound = (4 * n_el + 4 * n_rows) / HBM_BYTES_PER_S * 1e3
    rows["chunk_sumsq"] = kernel_row("chunk_sumsq", MT_SOURCE, errs["chunk_sumsq"],
                                     ms, plain_ms, nbytes, flops, enqueue_ms=enq)
    log(f"chunk_sumsq on {n_el:,} fp32 elements, decayed: kernel {ms:.3f} / "
        f"{ms2:.3f} ms, plain {plain_ms:.3f} ms, bound {rows['chunk_sumsq']['bound_ms']:.3f} "
        f"ms by bytes ({nbytes:,} bytes); raw: kernel {raw_ms:.3f} ms, "
        f"vector_norm(dim=1)^2 {lib_ms:.3f} ms (max abs err vs plain "
        f"{lib_err:.3g}), bound {raw_bound:.3f} ms")
    # fused_update: reads p, g, u, a; writes p, u, usq
    nbytes = 5 * 4 * n_el + 2 * 4 * n_rows
    flops = 11 * n_el
    upd = lambda: ops.fused_update(p, g, u, a, c, beta=0.9, wd=wd)  # noqa: E731
    ms, enq = time_kernel(torch, upd, n)
    plain_ms = time_calls(torch, quarters(lambda sl: ref.fused_update_ref(
        p[sl], g[sl], u[sl], a[sl.start // 1024:sl.stop // 1024], c,
        beta=0.9, wd=wd)), n)
    ms2 = time_calls(torch, upd, n)
    rows["fused_update"] = kernel_row("fused_update", MT_SOURCE, errs["fused_update"],
                                      ms, plain_ms, nbytes, flops, enqueue_ms=enq)
    log(f"fused_update on {n_el:,} fp32 elements: kernel {ms:.3f} / {ms2:.3f} ms, "
        f"plain {plain_ms:.3f} ms, bound {rows['fused_update']['bound_ms']:.3f} ms "
        f"by bytes ({nbytes:,} bytes); no single PyTorch call computes it")
    return rows


def kernel_row(name, source, err, ms, plain_ms, nbytes, flops, library_ms=None,
               flop_rate=FP32_FLOPS, enqueue_ms=None):
    """A kernels-line row; ``launches`` is filled in from the path's run.
    ``library_ms`` is None where no single PyTorch call computes the
    function as the path runs it; ``flop_rate`` is the card's peak for
    the inputs' type; ``enqueue_ms`` the host's time to enqueue one call
    (outside the timed window, see ``time_kernel``)."""
    b, f = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return {"name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(b, f) * 1e3,
            "bound_by": "bytes" if b >= f else "operations",
            "library_ms": library_ms, "enqueue_ms": enqueue_ms}


# ---------------------------------------------------------------------------
# phase 7: LAMB's two kernels against plain, and their times
# ---------------------------------------------------------------------------

LAMB = dict(b1=0.9, b2=0.999, eps=1e-6)


def same_or_raise(torch, name, pairs, errs, where):
    """Every (kernel, plain) pair bitwise equal; folds the largest absolute
    difference into ``errs[name]`` (0.0 unless it raises)."""
    for k, r in pairs:
        errs[name] = max(errs[name], (k.float() - r.float()).abs().max().item())
        if not same_bits(torch, k, r):
            raise AssertionError(f"{name} differs from its plain version "
                                 f"({where}): max abs diff {errs[name]:.3g}")


def lamb_compare(torch, ops, ref, p, g, moments, a, errs, wd, rows=1 << 16):
    """adam_update then scale_apply against their plain versions,
    bitwise, ``rows`` rows at a time.  ``moments(sl)`` gives the starting
    m and v of a slice (made anew, so the full buffer needs no copies)."""
    from repro_torch.core.multi_tensor import bias_corrections
    bc1, bc2 = bias_corrections(2, LAMB["b1"], LAMB["b2"])
    c = torch.tensor(0.01)
    km, kv = moments(slice(None))
    u, usq, psq, gsq = ops.adam_update(p, g, km, kv, bc1, bc2, wd=wd, **LAMB)
    step = rows * 1024
    where = f"{p.dtype}, wd {wd}, {p.numel():,} elements"
    for lo in range(0, p.numel(), step):
        sl = slice(lo, min(lo + step, p.numel()))
        rl = slice(lo // 1024, sl.stop // 1024)
        m0, v0 = moments(sl)
        want = ref.adam_update_ref(p[sl], g[sl], m0, v0, bc1, bc2, wd=wd, **LAMB)
        same_or_raise(torch, "adam_update", zip(
            (km[sl], kv[sl], u[sl], usq[rl], psq[rl], gsq[rl]), want), errs, where)
    del km, kv
    kp = p.clone()
    kq = ops.scale_apply(kp, u, a, c)
    for lo in range(0, p.numel(), step):
        sl = slice(lo, min(lo + step, p.numel()))
        rl = slice(lo // 1024, sl.stop // 1024)
        same_or_raise(torch, "scale_apply", zip(
            (kp[sl], kq[rl]), ref.scale_apply_ref(p[sl], u[sl], a[rl], c)),
            errs, where)
    torch.cuda.synchronize()


def derived_moments(g):
    """Starting Adam moments made from g, slice by slice (v > 0)."""
    def moments(sl):
        gs = g[sl].float()
        return gs * 0.1, gs * gs * 0.01 + 1e-8
    return moments


def phase_lamb_kernels(torch, ops, ref, p, g):
    """Small cases (fp32/bf16, wd 0/1e-4, signed zeros, a zero-padded
    tail, per-row coefficients), then the full gemma-2b fp32 buffer."""
    errs = {"adam_update": 0.0, "scale_apply": 0.0}
    n_cases = 0
    for dtype in ("float32", "bfloat16"):
        for seed, signed_zeros in ((0, False), (1, True)):
            sp, sg, su, sa = mt_inputs(torch, 4 * ref.TILE, dtype, seed, signed_zeros)
            sv = su * su * 0.01
            if not signed_zeros:                  # a segment's zero padding
                for t in (sp, sg, su, sv):
                    t[-3 * 1024 - 100:] = 0.0
            for wd in (0.0, 1e-4):
                lamb_compare(torch, ops, ref, sp, sg,
                             lambda sl: (su[sl].clone(), sv[sl].clone()), sa,
                             errs, wd)
                n_cases += 1
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    a = torch.rand(p.numel() // 1024, device="cuda", generator=gen) + 0.5
    lamb_compare(torch, ops, ref, p, g, derived_moments(g), a, errs, 1e-4)
    log(f"adam_update and scale_apply equal their plain versions bitwise in "
        f"{n_cases} cases of 262,144 elements (fp32/bf16, wd 0/1e-4, signed "
        f"zeros, a zero-padded tail, per-row coefficients) and on the full "
        f"gemma-2b fp32 buffer of {p.numel():,} elements (wd 1e-4); max abs "
        f"diff {errs}")
    return errs


def parts(n_el, k):
    """``k`` slices covering [0, n_el) on row boundaries."""
    step = -(-n_el // (k * 1024)) * 1024
    return [slice(lo, min(lo + step, n_el)) for lo in range(0, n_el, step)]


def phase_lamb_timing(torch, ops, ref, p, g, errs, n=20):
    """Times on the full gemma-2b fp32 buffer as a LAMB step runs them."""
    from repro_torch.core.multi_tensor import bias_corrections
    n_el, n_rows = p.numel(), p.numel() // 1024
    m, v = derived_moments(g)(slice(None))
    bc1, bc2 = bias_corrections(1, LAMB["b1"], LAMB["b2"])
    adam = lambda: ops.adam_update(p, g, m, v, bc1, bc2, wd=1e-4, **LAMB)  # noqa: E731
    # the plain versions' temporaries on the whole buffer would not fit
    # beside it, so each plain call walks it in 8 slices of rows
    slices = parts(n_el, 8)
    ms, enq = time_kernel(torch, adam, n)
    plain_ms = time_calls(torch, lambda: [ref.adam_update_ref(
        p[sl], g[sl], m[sl], v[sl], bc1, bc2, wd=1e-4, **LAMB) for sl in slices], 5)
    ms2 = time_calls(torch, adam, n)
    rows = {"adam_update": kernel_row("adam_update", MT_SOURCE, errs["adam_update"],
                                      ms, plain_ms, 28 * n_el + 12 * n_rows, 22 * n_el,
                                      enqueue_ms=enq)}
    log(f"adam_update on {n_el:,} fp32 elements: kernel {ms:.3f} / {ms2:.3f} ms, "
        f"plain {plain_ms:.3f} ms, bound {rows['adam_update']['bound_ms']:.3f} ms "
        f"by bytes (reads p, g, m, v; writes m, v, u); no single PyTorch call "
        f"computes it")
    u = adam()[0]
    del m, v
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    a = torch.rand(n_rows, device="cuda", generator=gen) + 0.5
    c = torch.tensor(0.01)
    scale = lambda: ops.scale_apply(p, u, a, c)  # noqa: E731
    ms, enq = time_kernel(torch, scale, n)
    plain_ms = time_calls(torch, lambda: [ref.scale_apply_ref(
        p[sl], u[sl], a[sl.start // 1024:sl.stop // 1024], c) for sl in slices], 5)
    ms2 = time_calls(torch, scale, n)
    rows["scale_apply"] = kernel_row("scale_apply", MT_SOURCE, errs["scale_apply"],
                                     ms, plain_ms, 12 * n_el + 8 * n_rows, 5 * n_el,
                                     enqueue_ms=enq)
    log(f"scale_apply on {n_el:,} fp32 elements: kernel {ms:.3f} / {ms2:.3f} ms, "
        f"plain {plain_ms:.3f} ms, bound {rows['scale_apply']['bound_ms']:.3f} ms "
        f"by bytes (reads p, u; writes p); no single PyTorch call computes it")
    return rows


# ---------------------------------------------------------------------------
# phase 8: the per-leaf kernels against plain, and their times
# ---------------------------------------------------------------------------

SNGM_SOURCE = "src/repro_torch/kernels/fused_sngm/csrc/fused_sngm.cu"
LARS_SOURCE = "src/repro_torch/kernels/fused_lars/csrc/fused_lars.cu"
LEAF_LENGTHS = (1, 1023, 1025, 32769)


def per_leaf_compare(torch, sngm, lars, p, g, u, errs, where, wds=(0.0, 1e-4)):
    """One leaf through each per-leaf kernel against its plain version,
    bitwise; the kernels write into clones."""
    inv = torch.tensor(1.0 / 300.0, device="cuda")
    lr = torch.tensor(1.6)
    kp, ku = p.clone(), u.clone()
    sngm.ops.fused_sngm_update(kp, g, ku, inv, lr, beta=0.9)
    same_or_raise(torch, "fused_sngm_update", zip(
        (kp, ku), sngm.ref.sngm_update_ref(p, g, u, inv, lr, beta=0.9)),
        errs, where)
    del kp, ku
    for x in (p, g):
        same_or_raise(torch, "lars_sqnorm", [(lars.ops.lars_sqnorm(x),
                                              lars.ref.lars_sqnorm_ref(x))],
                      errs, where)
    a = torch.tensor(1.6 * 0.0021, device="cuda")
    for wd in wds:
        kw_, kv = p.clone(), u.clone()
        lars.ops.fused_lars_update(kw_, g, kv, a, beta=0.9, wd=wd)
        same_or_raise(torch, "lars_update", zip(
            (kw_, kv), lars.ref.lars_update_ref(p, g, u, a, beta=0.9, wd=wd)),
            errs, f"{where}, wd {wd}")
    torch.cuda.synchronize()


def phase_per_leaf_kernels(torch, sngm, lars, p, g, layout):
    """Ragged leaves (fp32/bf16, signed zeros, wd 0/1e-4), then the 11
    gemma-2b leaves as views into the full buffers.  Returns the leaves
    (params, grads, f32 momentum) for the timings."""
    from repro_torch.core.multi_tensor import unflatten
    errs = {"fused_sngm_update": 0.0, "lars_sqnorm": 0.0, "lars_update": 0.0}
    for dtype in ("float32", "bfloat16"):
        for n in LEAF_LENGTHS:
            lp, lg, lu, _ = mt_inputs(torch, 64 * 1024, dtype, n, signed_zeros=True)
            per_leaf_compare(torch, sngm, lars, lp[:n], lg[:n], lu[:n], errs,
                             f"{dtype}, {n} elements")
    u = (g * 0.01).float()
    leaves = [unflatten([x], layout) for x in (p, g, u)]
    for k in layout.paths:
        per_leaf_compare(torch, sngm, lars, *(t[k] for t in leaves), errs,
                         f"gemma-2b leaf {k} {tuple(leaves[0][k].shape)}",
                         wds=(1e-4,))
    log(f"fused_sngm_update, lars_sqnorm and lars_update equal their plain "
        f"versions bitwise on leaves of {', '.join(map(str, LEAF_LENGTHS))} "
        f"elements (fp32/bf16, signed zeros, wd 0/1e-4) and on the "
        f"{layout.n_leaves} gemma-2b fp32 leaves; max abs diff {errs}")
    return leaves, errs


def phase_per_leaf_timing(torch, sngm, lars, leaves, errs, n=20):
    """Each kernel over the 11 gemma-2b leaves, as one per-leaf step
    launches it (11 fused_sngm_update, 22 lars_sqnorm, 11 lars_update)."""
    P, G, U = leaves
    order = list(P)
    n_el = sum(P[k].numel() for k in order)
    n_rows = sum(max(1, -(-P[k].numel() // 1024)) for k in order)
    inv = torch.tensor(1.0 / 300.0, device="cuda")
    lr = torch.tensor(1.6)
    a = torch.tensor(1.6 * 0.0021, device="cuda")
    rows = {}

    def each(fn):
        return lambda: [fn(k) for k in order]
    kernel = each(lambda k: sngm.ops.fused_sngm_update(P[k], G[k], U[k], inv, lr, beta=0.9))
    ms, enq = time_kernel(torch, kernel, n)
    plain_ms = time_calls(torch, each(lambda k: sngm.ref.sngm_update_ref(
        P[k], G[k], U[k], inv, lr, beta=0.9)), 5)
    ms2 = time_calls(torch, kernel, n)
    rows["fused_sngm_update"] = kernel_row("fused_sngm_update", SNGM_SOURCE,
                                           errs["fused_sngm_update"], ms, plain_ms,
                                           20 * n_el, 4 * n_el, enqueue_ms=enq)
    log(f"fused_sngm_update over the {len(order)} gemma-2b leaves ({n_el:,} fp32 "
        f"elements, {len(order)} launches): kernel {ms:.3f} / {ms2:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {rows['fused_sngm_update']['bound_ms']:.3f} ms "
        f"by bytes; no single PyTorch call computes it")
    both = [x for k in order for x in (P[k], G[k])]
    kernel = lambda: [lars.ops.lars_sqnorm(x) for x in both]  # noqa: E731
    ms, enq = time_kernel(torch, kernel, n)
    plain_ms = time_calls(torch, lambda: [lars.ref.lars_sqnorm_ref(x) for x in both], 5)
    library_ms = time_calls(torch, lambda: [torch.linalg.vector_norm(x) for x in both], n)
    ms2 = time_calls(torch, kernel, n)
    rows["lars_sqnorm"] = kernel_row("lars_sqnorm", LARS_SOURCE, errs["lars_sqnorm"],
                                     ms, plain_ms, 2 * (4 * n_el + 4 * n_rows),
                                     2 * 2 * n_el, library_ms, enqueue_ms=enq)
    log(f"lars_sqnorm over w and g of the {len(order)} leaves ({2 * len(order)} "
        f"launches): kernel {ms:.3f} / {ms2:.3f} ms, plain {plain_ms:.3f} ms, "
        f"vector_norm {library_ms:.3f} ms, bound "
        f"{rows['lars_sqnorm']['bound_ms']:.3f} ms by bytes")
    kernel = each(lambda k: lars.ops.fused_lars_update(P[k], G[k], U[k], a,
                                                       beta=0.9, wd=1e-4))
    ms, enq = time_kernel(torch, kernel, n)
    plain_ms = time_calls(torch, each(lambda k: lars.ref.lars_update_ref(
        P[k], G[k], U[k], a, beta=0.9, wd=1e-4)), 5)
    ms2 = time_calls(torch, kernel, n)
    rows["lars_update"] = kernel_row("lars_update", LARS_SOURCE, errs["lars_update"],
                                     ms, plain_ms, 20 * n_el, 6 * n_el,
                                     enqueue_ms=enq)
    log(f"lars_update over the {len(order)} leaves ({len(order)} launches): "
        f"kernel {ms:.3f} / {ms2:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{rows['lars_update']['bound_ms']:.3f} ms by bytes; no single PyTorch "
        f"call computes it")
    return rows


# ---------------------------------------------------------------------------
# phase 9: full-width training, each slice's main path
# ---------------------------------------------------------------------------

OPT_KERNELS = ("chunk_sumsq", "fused_update", "fused_update_deferred",
               "adam_update", "scale_apply", "fused_sngm_update", "lars_sqnorm",
               "lars_update")
# (what, launcher flags, steps, kernel launches per step): each slice's path
TRAIN_RUNS = {
    "sngm": ("SNGM on the engine", ["--optimizer", "sngm", "--fused", "multi_tensor"],
             4, {"chunk_sumsq": 1, "fused_update": 1}),
    "lamb": ("LAMB on the engine (lr 0.01)",
             ["--optimizer", "lamb", "--fused", "multi_tensor", "--lr", "0.01"],
             4, {"adam_update": 1, "scale_apply": 1}),
    "sngm_per_leaf": ("SNGM per leaf", ["--optimizer", "sngm", "--fused", "per_leaf"],
                      3, {"fused_sngm_update": 11}),
    "lars_per_leaf": ("LARS per leaf", ["--optimizer", "lars", "--fused", "per_leaf"],
                      3, {"lars_sqnorm": 22, "lars_update": 11}),
}


def phase_train(torch, kernels, train_mod, run_name):
    """``steps`` steps of full-width gemma-2b through the launcher's own
    ``build``/``train`` (batch 8 x 512 tokens, 2 micro-batches, wd 1e-4),
    the launch counts set to 0 just before and read just after: each
    optimizer kernel of the path the expected number of times a step,
    every other one never."""
    what, flags, steps, per_step = {**TRAIN_RUNS, **EMA_RUNS}[run_name]
    args = train_mod.parse_args(
        ["--arch", ARCH, "--steps", str(steps), "--batch", "8", "--seq", "512",
         "--n-micro", "2", "--weight-decay", "1e-4", "--log-every", "1",
         "--device", "cuda", "--seed", "0", *flags])
    t0 = time.perf_counter()
    run = train_mod.build(args)
    torch.cuda.synchronize()
    log(f"{run.cfg.name}: {run.n_params:,} fp32 params (PRNGKey(0) on the card), "
        f"{type(run.state.opt_state).__name__}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    state, mem = train_mod.train(args, run)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    recs = [m for _, m in mem.steps]
    if len(recs) != args.steps:
        raise AssertionError(f"{len(recs)} step records for {args.steps} steps")
    for t, m in enumerate(recs):
        if not all(np.isfinite(m[k]) for k in ("loss", "grad_norm", "lr", "update_norm")):
            raise AssertionError(f"step {t}: non-finite stats {m}")
    want = {k: per_step.get(k, 0) * args.steps for k in OPT_KERNELS}
    if {k: launches[k] for k in OPT_KERNELS} != want:
        raise AssertionError(f"{what}: launches {launches} for {args.steps} "
                             f"steps, want {want}")
    steady = [m["step_time_s"] for m in recs[1:]]
    step_s = float(np.median(steady))
    tokens = args.batch * args.seq
    losses = ", ".join(f"{m['loss']:.4f}" for m in recs)
    log(f"trained {args.steps} steps of {what}: losses {losses}; "
        f"step 0 {recs[0]['step_time_s']:.3f} s (first use), then "
        f"{', '.join(f'{s:.3f}' for s in steady)} s; median {step_s:.3f} s = "
        f"{tokens / step_s:.0f} tokens/s; peak device memory {peak_gib:.2f} GiB; "
        f"launches per step: " + ", ".join(
            f"{k} {launches[k] / args.steps:g}" for k in per_step))
    return run, state, launches, step_s


def phase_split(torch, run, state, step_s, launches):
    """The optimizer step alone on the trained state, with gradients of the
    same size (the engine's flat buffers, or a dict on the per-leaf
    path), against the whole step; then one profiled step."""
    from repro_torch.core.multi_tensor import FlatGrads, zeros_flats
    if state.params is None:
        layout = state.opt_state.layout
        g = zeros_flats(layout, device="cuda")
        for f in g:
            f.normal_().mul_(1e-3)
        grads = FlatGrads(tuple(g), layout)
    else:
        grads = {k: torch.randn_like(v).mul_(1e-3) for k, v in state.params.items()}
    holder = {"s": state}

    def opt_step():
        holder["s"], _ = run.opt.step_state(grads, holder["s"])
    opt_ms = time_calls(torch, opt_step, n=5)
    log(f"{run.opt.name} optimizer step ({launches} launches + the host's "
        f"norm folds) {opt_ms:.2f} ms = {100 * opt_ms / (step_s * 1e3):.2f} % "
        f"of a {step_s * 1e3:.0f} ms step; forward+backward of 2 micro-batches "
        f"~ {step_s * 1e3 - opt_ms:.0f} ms")
    del grads
    profile_step(torch, run, holder["s"])
    return opt_ms


def profile_step(torch, run, state, top=8):
    """One more train step under torch.profiler: the device's busy share
    of the step's wall time and the kernels that take the most of it."""
    from torch.profiler import ProfilerActivity, profile
    batch = run.data.batch_at(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run.step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    log_profile(prof, wall_ms, "profiled step", top)


def log_profile(prof, wall_ms, what, top=8, prefix=""):
    """The device's busy share of a profiled window's wall time and the
    kernels that take the most of it (each kernel's line led by
    ``prefix``)."""
    from torch.autograd import DeviceType
    # device-side events only (kernels, copies): a CPU op's device time
    # repeats its kernels'
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if busy_ms == 0:
        log(f"{what}: the profiler saw no device time (not measured)")
        return
    log(f"{what}: {wall_ms:.0f} ms wall (profiler on), device busy "
        f"{busy_ms:.0f} ms = {100 * busy_ms / wall_ms:.1f} %, idle "
        f"{100 - 100 * busy_ms / wall_ms:.1f} %; top kernels by device time:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"{prefix}  {e.self_device_time_total / 1e3:8.2f} ms x{e.count:<5d} "
            f"{e.key[:90]}")


# ---------------------------------------------------------------------------
# phase 10: fused=None against the engine and per-leaf paths, same gradients
# ---------------------------------------------------------------------------

# (optimizer, its keyword arguments, execution mode held against fused=None)
AGAINST_PLAIN = [("sngm", {"beta": 0.9}, "multi_tensor"),
                 ("sngm", {"beta": 0.9, "norm_mode": "per_tensor"}, "multi_tensor"),
                 ("msgd", {"beta": 0.9}, "multi_tensor"),
                 ("lars", {"beta": 0.9}, "multi_tensor"),
                 ("sngm", {"beta": 0.9, "nesterov": True}, "multi_tensor"),
                 ("lamb", {}, "multi_tensor"),
                 ("sngm", {"beta": 0.9}, "per_leaf"),
                 ("lars", {"beta": 0.9}, "per_leaf")]


def opt_slots(state):
    """The optimizer's f32 slots as dicts: momentum, or LAMB's m and v."""
    opt = state.opt_state
    if hasattr(opt, "m"):
        return [opt.m, opt.v]
    if getattr(opt, "m_flats", ()):
        return list(opt.moments)
    return [opt.momentum]


def phase_fused_vs_plain(torch, cfg, n_layers=2):
    from repro_torch import prng
    from repro_torch.core.optim import make_optimizer
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Runtime, materialize, model_defs
    from repro_torch.training.step import _grad_leaves, loss_fn
    checked = []
    for param_dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, n_layers=n_layers, param_dtype=param_dtype)
        params = materialize(model_defs(c), prng.PRNGKey(1), torch.device("cuda"))
        # one set of full-width gradients, from one backward pass
        opt = make_optimizer("sngm", {"name": "constant", "kwargs": {"lr": 0.1}},
                             fused="multi_tensor")
        leaves, grads = _grad_leaves(opt.init_state(params))
        batch = SyntheticLM(c.vocab_size, 512, 2, seed=1,
                            device=torch.device("cuda")).batch_at(0)
        loss_fn(leaves, batch, c, Runtime(torch.device("cuda"), remat=True))[0].backward()
        del leaves
        for name, kw, mode in AGAINST_PLAIN:
            lr0 = 0.01 if name == "lamb" else 1.6
            sched = {"name": "poly_power", "kwargs": {"lr0": lr0, "total_steps": 4}}
            opts = [make_optimizer(name, sched, weight_decay=1e-4, fused=f, **kw)
                    for f in (None, mode)]
            # the per-leaf path updates its params in place: each state
            # gets its own copy
            states = [o.init_state({k: v.clone() for k, v in params.items()})
                      for o in opts]
            for t in range(3):
                outs = [o.step_state(grads if f == "multi_tensor" else grads.tree, s)
                        for o, s, f in zip(opts, states, (None, mode))]
                states = [s for s, _ in outs]
                sa, sb = (st for _, st in outs)
                pa, pb = (s.params_view for s in states)
                same = (all(same_bits(torch, sa[k], sb[k]) for k in sa)
                        and all(same_bits(torch, pa[k], pb[k]) for k in pa)
                        and all(same_bits(torch, ua[k], ub[k])
                                for ua, ub in zip(*map(opt_slots, states))
                                for k in ua))
                if not same:
                    raise AssertionError(f"{name} {kw} {param_dtype} step {t}: "
                                         f"fused=None and {mode} differ")
            checked.append(f"{name}{kw} {mode}")
            del states, outs
        del params, grads
    log(f"fused=None equals each other path bitwise over 3 steps on the same "
        f"gradients (params, optimizer slots, stats), fp32 and bf16 params, "
        f"gemma-2b widths at {n_layers} layers: "
        f"{'; '.join(sorted(set(checked)))}")


# ---------------------------------------------------------------------------
# phases 15-17: gradient-transform chains on the engine, and fused_update's
# deferred apply
# ---------------------------------------------------------------------------

def chain_builders():
    """The three chains of this phase over the port's transform module:
    a clip before the chain's head (compiled as its clip round), a clip
    mid-chain (prefix stages, then an msgd tail with the clip round), a
    clip after the schedule (the deferred apply), as
    ``tests/test_chain_differential.py:376-389`` builds the last two; the
    trailing clip's 0.01 is far below lr * ||u|| at gemma-2b, so it acts."""
    from repro_torch.core import transform as T

    def clip_prefix(sched):
        return T.chain(T.clip_by_global_norm(1.0), T.add_decayed_weights(1e-4),
                       T.normalize_by_global_norm(), T.trace(0.9),
                       T.scale_by_schedule(sched))

    def clip_mid(sched):
        return T.chain(T.add_decayed_weights(1e-4), T.normalize_by_global_norm(),
                       T.clip_by_global_norm(5.0), T.trace(0.9),
                       T.scale_by_schedule(sched))

    def clip_trailing(sched):
        return T.chain(T.add_decayed_weights(1e-4), T.normalize_by_global_norm(),
                       T.trace(0.9), T.scale_by_schedule(sched),
                       T.clip_by_global_norm(0.01))
    return {"clip_prefix": clip_prefix, "clip_mid": clip_mid,
            "clip_trailing": clip_trailing}


# each chain's kernel launches per step on the one fp32 bucket of gemma-2b
CHAIN_LAUNCHES = {
    "clip_prefix": {"chunk_sumsq": 2, "fused_update": 1},
    "clip_mid": {"chunk_sumsq": 1, "fused_update": 1},
    "clip_trailing": {"chunk_sumsq": 1, "fused_update_deferred": 1,
                      "scale_apply": 1},
}


def deferred_compare(torch, ops, ref, p, g, u, a, errs, rows=1 << 16,
                     again=True, **kw):
    """fused_update(apply=False) against its plain version, bitwise, rows
    at a time; p must come back with the same bits, and (``again``) a
    second call on the same inputs must give the same bits."""
    c = torch.tensor(0.37)
    p0 = p.clone()
    ku = u.clone()
    ko, kq = ops.fused_update(p, g, ku, a, c, apply=False, **kw)
    step = rows * 1024
    where = f"{p.dtype} p, {g.dtype} g, {kw}, {p.numel():,} elements"
    for lo in range(0, p.numel(), step):
        sl = slice(lo, min(lo + step, p.numel()))
        rl = slice(lo // 1024, sl.stop // 1024)
        same_or_raise(torch, "fused_update_deferred", zip(
            (ko[sl], ku[sl], kq[rl]),
            ref.fused_update_ref(p0[sl], g[sl], u[sl], a[rl], c, apply=False,
                                 **kw)), errs, where)
    if not same_bits(torch, p, p0):
        raise AssertionError(f"the deferred fused_update wrote p ({where})")
    del p0
    if again:
        ku2 = u.clone()
        ko2, kq2 = ops.fused_update(p, g, ku2, a, c, apply=False, **kw)
        if not all(same_bits(torch, x, y) for x, y in
                   ((ko, ko2), (ku, ku2), (kq, kq2))):
            raise AssertionError(f"a second deferred call differs ({where})")
    torch.cuda.synchronize()


def phase_chain_kernels(torch, ops, ref, cfg):
    """Phase 15: the deferred apply against its plain version on phase 6's
    grid, with fp32 updates beside bf16 params (what a promoting chain
    stage hands the engine) in both modes and in the decayed norm pass,
    then on the full gemma-2b buffer in fp32 and bf16."""
    errs = {"fused_update_deferred": 0.0, "fused_update": 0.0,
            "chunk_sumsq": 0.0}
    n_cases = 0
    for dtype in ("float32", "bfloat16"):
        for seed, signed_zeros in ((0, False), (1, True)):
            p, g, u, a = mt_inputs(torch, 4 * ref.TILE, dtype, seed, signed_zeros)
            for wd in (0.0, 1e-4):
                for cast_g_first in (False, True):
                    for nesterov in (False, True):
                        deferred_compare(torch, ops, ref, p, g, u, a, errs,
                                         beta=0.9, wd=wd,
                                         cast_g_first=cast_g_first,
                                         nesterov=nesterov)
                        n_cases += 1
            if dtype == "bfloat16":            # fp32 updates, bf16 params
                g32 = (g.float() * 1.37).contiguous()
                for nesterov in (False, True):
                    deferred_compare(torch, ops, ref, p, g32, u, a, errs,
                                     beta=0.9, wd=1e-2, nesterov=nesterov)
                    mt_compare(torch, ops, ref, p, g32, u, a, errs, beta=0.9,
                               wd=1e-2, nesterov=nesterov)
                    n_cases += 2
    n = gemma_layout(torch, cfg).buckets[0].n_elems
    for dtype in ("float32", "bfloat16"):
        p, g, u, a = mt_inputs(torch, n, dtype, seed=5)
        a.fill_(1.0 / 300.0)                   # SNGM's one global coefficient
        deferred_compare(torch, ops, ref, p, g, u, a, errs, beta=0.9, wd=1e-4)
        del p, g, u, a
        torch.cuda.empty_cache()
    log(f"fused_update(apply=False) equals its plain version bitwise in "
        f"{n_cases} cases of 262,144 elements (fp32/bf16, wd 0/1e-4, both cast "
        f"orders, nesterov, signed zeros; fp32 updates beside bf16 params, "
        f"apply on and off and the decayed norm) and on the full gemma-2b "
        f"buffer of {n:,} elements in fp32 and bf16 (sngm, wd 1e-4); p keeps "
        f"its bits, a second call gives the same bits; max abs diff {errs}")
    return errs


def phase_chain_timing(torch, ops, ref, cfg, errs, n=20):
    """The deferred kernel on the full gemma-2b buffer as the trailing
    clip's pass 2 runs it (fp32, wd 1e-4), against its bound, its plain
    version and the apply kernel on the same inputs (in turns); and the
    bf16-params variant."""
    n_el = gemma_layout(torch, cfg).buckets[0].n_elems
    n_rows = n_el // 1024
    c, wd = torch.tensor(1.6), 1e-4
    p, g, u, a = mt_inputs(torch, n_el, "float32", seed=6)
    a.fill_(1.0 / 300.0)
    out = torch.empty(n_el, dtype=torch.float32, device="cuda")
    deferred = lambda: ops.fused_update(p, g, u, a, c, beta=0.9, wd=wd,  # noqa: E731
                                        apply=False, out=out)
    apply = lambda: ops.fused_update(p, g, u, a, c, beta=0.9, wd=wd)  # noqa: E731
    ms, enq = time_kernel(torch, deferred, n)
    apply_ms = time_calls(torch, apply, n)
    apply_ms2 = time_calls(torch, apply, n)
    ms2 = time_calls(torch, deferred, n)
    slices = parts(n_el, 4)
    plain_ms = time_calls(torch, lambda: [ref.fused_update_ref(
        p[sl], g[sl], u[sl], a[sl.start // 1024:sl.stop // 1024], c, beta=0.9,
        wd=wd, apply=False) for sl in slices], 5)
    # reads p (for the decay), g, u, a; writes out, u and the row sums
    nbytes = 5 * 4 * n_el + 2 * 4 * n_rows
    row = kernel_row("fused_update_deferred", MT_SOURCE,
                     errs["fused_update_deferred"], ms, plain_ms, nbytes,
                     9 * n_el, enqueue_ms=enq)
    apply_bound = (5 * 4 * n_el + 2 * 4 * n_rows) / HBM_BYTES_PER_S * 1e3
    log(f"fused_update(apply=False) on {n_el:,} fp32 elements (wd 1e-4): kernel "
        f"{ms:.3f} / {ms2:.3f} ms (host enqueue {enq:.4f} ms), plain "
        f"{plain_ms:.3f} ms, bound {row['bound_ms']:.3f} ms by bytes ({nbytes:,} "
        f"bytes: p, g, u read, out, u written), {100 * row['bound_ms'] / ms:.1f} % "
        f"of it; apply=True on the same inputs {apply_ms:.3f} / {apply_ms2:.3f} ms "
        f"(bound {apply_bound:.3f}); no single PyTorch call computes it")
    del p, g, u, a, out
    torch.cuda.empty_cache()
    p, g, u, a = mt_inputs(torch, n_el, "bfloat16", seed=7)
    a.fill_(1.0 / 300.0)
    bf_ms = time_calls(torch, lambda: ops.fused_update(
        p, g, u, a, c, beta=0.9, wd=wd, apply=False), n)
    bf_bound = (2 * 2 * n_el + 3 * 4 * n_el + 2 * 4 * n_rows) / HBM_BYTES_PER_S * 1e3
    log(f"fused_update(apply=False), bf16 params and updates on {n_el:,} "
        f"elements: {bf_ms:.3f} ms, bound {bf_bound:.3f} ms by bytes (p, g 2 B; "
        f"u, out 4 B), {100 * bf_bound / bf_ms:.1f} % of it")
    del p, g, u, a
    torch.cuda.empty_cache()
    return row


def chain_run(torch, train_mod, name, steps=3):
    """The launcher's full-width gemma-2b run (phase 9's batch) with its
    optimizer replaced by the chain ``name`` compiled onto the engine."""
    from repro_torch.core import schedules as S
    from repro_torch.core import transform as T
    from repro_torch.models import make_runtime
    from repro_torch.training import make_train_step
    args = train_mod.parse_args(
        ["--arch", ARCH, "--steps", str(steps), "--batch", "8", "--seq", "512",
         "--n-micro", "2", "--weight-decay", "1e-4", "--log-every", "1",
         "--device", "cuda", "--seed", "0", "--optimizer", "sngm",
         "--fused", "multi_tensor"])
    run = train_mod.build(args)
    sched = S.poly_power(args.lr, args.steps, 1.1)
    opt = T.compile_chain(chain_builders()[name](sched), fused="multi_tensor")
    state = opt.init_state(run.state.params_view)
    run = dataclasses.replace(
        run, opt=opt, state=state,
        step=make_train_step(run.cfg, make_runtime("cuda", remat=True), opt,
                             n_micro=args.n_micro))
    return args, run


def fmt_all(recs, key, spec):
    return ", ".join(format(m[key], spec) for m in recs)


def phase_chain_train(torch, kernels, train_mod, name):
    """Phase 16: 3 steps of full-width gemma-2b training with the chain on
    the engine, launch counts set to 0 just before and read just after
    (each kernel of the chain's plan the planned number of times a step,
    every other optimizer kernel never); loss, stats, the trailing clip's
    factor, peak memory; then the optimizer step alone against plain
    SNGM's on the same buffers."""
    from repro_torch.core.multi_tensor import FlatGrads, zeros_flats
    from repro_torch.core.optim import TrainState, make_optimizer
    args, run = chain_run(torch, train_mod, name)
    plan = run.opt.plan
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    state, mem = train_mod.train(args, run)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    recs = [m for _, m in mem.steps]
    if len(recs) != args.steps:
        raise AssertionError(f"{len(recs)} step records for {args.steps} steps")
    for t, m in enumerate(recs):
        if not all(np.isfinite(m[k]) for k in ("loss", "grad_norm", "lr", "update_norm")):
            raise AssertionError(f"{name} step {t}: non-finite stats {m}")
    per_step = CHAIN_LAUNCHES[name]
    want = {k: per_step.get(k, 0) * args.steps for k in OPT_KERNELS}
    if {k: launches[k] for k in OPT_KERNELS} != want:
        raise AssertionError(f"{name}: launches {launches} for {args.steps} "
                             f"steps, want {want}")
    n_buckets = len(state.opt_state.layout.buckets)
    if sum(per_step.values()) != plan.fused.launches * n_buckets:
        raise AssertionError(f"{name}: {per_step} against the plan's "
                             f"{plan.fused.launches} a bucket")
    extra = ""
    if name == "clip_trailing":
        clip = dict(plan.fused.kwargs)["suffix_clip"]
        cs = [clip / max(m["grad_norm"], clip) for m in recs]
        if not all(x < 1.0 for x in cs):
            raise AssertionError(f"the trailing clip did not act: cscale {cs}")
        extra = (f"; the clip sees lr*||u|| = {fmt_all(recs, 'grad_norm', '.4g')}"
                 f", cscale {', '.join(format(x, '.4g') for x in cs)}")
    steady = [m["step_time_s"] for m in recs[1:]]
    log(f"{name} [{plan.describe()}]: {args.steps} steps of full-width gemma-2b, "
        f"losses {fmt_all(recs, 'loss', '.4f')}, grad_norm "
        f"{fmt_all(recs, 'grad_norm', '.4g')}; steps "
        f"{fmt_all(recs, 'step_time_s', '.3f')} s (median after the first "
        f"{float(np.median(steady)):.3f}); peak device memory "
        f"{peak_gib:.2f} GiB; launches per step: "
        + ", ".join(f"{k} {launches[k] / args.steps:g}" for k in per_step)
        + f" (the plan's {plan.fused.launches} a bucket){extra}")
    # the optimizer step alone, this chain and plain SNGM on the same buffers
    layout = state.opt_state.layout
    g = zeros_flats(layout, device="cuda")
    for f in g:
        f.normal_().mul_(1e-3)
    grads = FlatGrads(tuple(g), layout)
    sngm = make_optimizer("sngm", {"name": "poly_power", "kwargs": {
        "lr0": 1.6, "total_steps": 100}}, weight_decay=1e-4, fused="multi_tensor")
    as_sngm = TrainState(None, dataclasses.replace(state.opt_state, form="momentum"))
    holder = {"chain": state, "sngm": as_sngm}

    def step(opt, key):
        def go():
            holder[key], _ = opt.step_state(grads, holder[key])
        return go
    torch.cuda.reset_peak_memory_stats()
    chain_ms = time_calls(torch, step(run.opt, "chain"), n=5)
    opt_peak = torch.cuda.max_memory_allocated() / 2**30
    sngm_ms = time_calls(torch, step(sngm, "sngm"), n=5)
    chain_ms2 = time_calls(torch, step(run.opt, "chain"), n=5)
    sngm_ms2 = time_calls(torch, step(sngm, "sngm"), n=5)
    log(f"{name} optimizer step {chain_ms:.2f} / {chain_ms2:.2f} ms against plain "
        f"SNGM {sngm_ms:.2f} / {sngm_ms2:.2f} ms on the same buffers (in turns); "
        f"peak device memory in the chain's steps {opt_peak:.2f} GiB")
    return launches


def chain_phases(torch, kernels, ops, ref, train_mod, cfg):
    """Phases 15-17; returns the kernels line's fused_update_deferred row,
    its launches those of the trailing clip's training run."""
    errs = phase_chain_kernels(torch, ops, ref, cfg)
    row = phase_chain_timing(torch, ops, ref, cfg, errs)
    for name in CHAIN_LAUNCHES:
        launches = phase_chain_train(torch, kernels, train_mod, name)
        if name == "clip_trailing":
            row["launches"] = launches["fused_update_deferred"]
        torch.cuda.empty_cache()
    phase_chain_vs_interp(torch, cfg)
    return {"fused_update_deferred": row}


def phase_chain_vs_interp(torch, cfg, n_layers=2):
    """Phase 17: each chain on the engine against the port's interpreter
    (``compile_chain(tx, interpret=True)``) from one state and the same
    full-width gradients, 3 steps, fp32 and bf16 params, within the JAX
    grid's policy (``tests/test_chain_differential.py:140-168``: these
    chains all clip, so fp32 rtol 5e-4 / atol 1e-6, bf16 rtol 5e-2 / atol
    1e-2), with the launches of each engine step equal to the plan's.
    Depth cut to 2 layers so both states and the interpreter's
    temporaries fit beside each other, as in phase 10."""
    from repro_torch import kernels, prng
    from repro_torch.core import schedules as S
    from repro_torch.core import transform as T
    from repro_torch.core.optim import make_optimizer
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Runtime, materialize, model_defs
    from repro_torch.training.step import _grad_leaves, loss_fn

    def close(x, y, what):
        """(bitwise, max |x - y| / (atol + rtol |y|)) under the policy."""
        rtol, atol = (5e-2, 1e-2) if x.dtype == torch.bfloat16 else (5e-4, 1e-6)
        xf, yf = x.float(), y.float()
        ratio = ((xf - yf).abs() / (atol + rtol * yf.abs())).max().item() \
            if x.numel() else 0.0
        if x.dtype != y.dtype or ratio > 1.0:
            raise AssertionError(f"{what}: {x.dtype}/{y.dtype}, {ratio:.3g} of "
                                 f"the bound")
        return same_bits(torch, x, y), ratio

    report = []
    for param_dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, n_layers=n_layers, param_dtype=param_dtype)
        params = materialize(model_defs(c), prng.PRNGKey(1), torch.device("cuda"))
        sched = S.poly_power(1.6, 4, 1.1)
        # one set of full-width gradients, from one backward pass
        opt = make_optimizer("sngm", {"name": "constant", "kwargs": {"lr": 0.1}},
                             fused="multi_tensor")
        leaves, grads = _grad_leaves(opt.init_state(params))
        batch = SyntheticLM(c.vocab_size, 512, 2, seed=1,
                            device=torch.device("cuda")).batch_at(0)
        loss_fn(leaves, batch, c, Runtime(torch.device("cuda"), remat=True))[0].backward()
        del leaves
        for name, build in chain_builders().items():
            tx = build(sched)
            eng = T.compile_chain(tx, fused="multi_tensor")
            interp = T.compile_chain(tx, interpret=True)
            a = interp.init_state({k: v.clone() for k, v in params.items()})
            b = eng.init_state(params)
            worst, bits = 0.0, True
            for t in range(3):
                a, sa = interp.step_state(grads.tree, a)
                kernels.reset_launches()
                b, sb = eng.step_state(grads, b)
                torch.cuda.synchronize()
                n = sum(kernels.launch_counts().values())
                if n != eng.plan.fused.launches * len(b.opt_state.layout.buckets):
                    raise AssertionError(f"{name} {param_dtype} step {t}: {n} "
                                         f"launches, plan {eng.plan.describe()}")
                pairs = [(sb[k], sa[k], f"stat {k}") for k in sa]
                pairs += [(b.params_view[k], a.params[k], f"param {k}")
                          for k in a.params]
                mom = next(s for s in a.opt_state.inner
                           if isinstance(s, T.TraceState)).momentum
                pairs += [(b.opt_state.momentum[k], mom[k], f"momentum {k}")
                          for k in mom]
                for x, y, what in pairs:
                    same, ratio = close(x, y, f"{name} {param_dtype} step {t} {what}")
                    bits &= same
                    worst = max(worst, ratio)
            report.append(f"{name} {param_dtype}: "
                          + ("bitwise" if bits else f"{worst:.3g} of the bound"))
            del a, b
            torch.cuda.empty_cache()
        del params, grads
    log(f"each chain on the engine against the port's interpreter, 3 steps from "
        f"one state on the same gradients, gemma-2b widths at {n_layers} layers, "
        f"launches a step = the plan's: {'; '.join(report)}")


# ---------------------------------------------------------------------------
# phase 18: checkpoints and resume at full width
# ---------------------------------------------------------------------------

# (what, launcher flags, depth (None: the full 18 layers), kernel launches
# per resumed step, whether it reads the pack with --prefetch 2)
CKPT_RUNS = {
    "sngm": ("SNGM on the engine", ["--optimizer", "sngm", "--fused", "multi_tensor"],
             None, {"chunk_sumsq": 1, "fused_update": 1}, True),
    "lamb": ("LAMB on the engine (lr 0.01)",
             ["--optimizer", "lamb", "--fused", "multi_tensor", "--lr", "0.01"],
             2, {"adam_update": 1, "scale_apply": 1}, False),
    # phase 21d: a full-width EMA checkpoint would be ~30 GB
    "sngm_ema": ("SNGM + EMA 0.999 on the engine",
                 ["--optimizer", "sngm", "--fused", "multi_tensor",
                  "--ema-decay", "0.999"],
                 2, {"chunk_sumsq": 1, "fused_update": 1}, False),
}
PHASE18_RUNS = ("sngm", "lamb")
# the resumed steps against the live state's: within this many times the
# difference between two runs from the live state themselves (0 if the
# steps repeat), since each pair of runs is a fresh draw of the token
# gather backward's atomic sum order
RESUME_SLACK = 2.0


@contextlib.contextmanager
def config_cut(train_mod, change):
    """The launcher's ``get_config`` handing back ``change(cfg)``: a cut of
    the arch, built here with ``dataclasses.replace`` (the launcher has no
    flag for one, as the JAX launcher has none)."""
    get = train_mod.get_config
    train_mod.get_config = lambda name: change(get(name))
    try:
        yield
    finally:
        train_mod.get_config = get


def depth_cut(train_mod, n_layers):
    """The launcher's config at ``n_layers`` layers (widths unchanged;
    None keeps the arch's depth)."""
    return config_cut(train_mod, lambda c: c if n_layers is None else
                      dataclasses.replace(c, n_layers=n_layers))


def state_buffers(state):
    """A resident state's flat buffers: params, then its f32 slots (EMA
    shadows last)."""
    o = state.opt_state
    return (list(o.p_flats) + list(o.u_flats) + list(o.m_flats)
            + list(o.v_flats) + [f for e in o.e_flats for f in e])


def max_abs_diff(torch, xs, ys, chunk=1 << 26):
    """max |x - y| over pairs of flat buffers, a chunk at a time."""
    worst = 0.0
    for x, y in zip(xs, ys):
        for i in range(0, x.numel(), chunk):
            d = (x[i:i + chunk].float() - y[i:i + chunk].float()).abs().max()
            worst = max(worst, float(d))
    return worst


def ckpt_layers(name, root, need_x=2.1):
    """The depth for ``name``'s round trip: its own, or the most layers
    whose checkpoint fits ``need_x`` times in the free bytes of ``root``
    (the family's save and the timed sync save sit there at once)."""
    from repro_torch.configs import get_config
    from repro_torch.models import count, model_defs
    own = CKPT_RUNS[name][2]
    cfg = get_config(ARCH)
    slots = {"sngm": 1, "lamb": 2, "sngm_ema": 2}[name]  # f32 slots a param

    def nbytes(n):                 # fp32 params and their f32 slots
        return count(model_defs(dataclasses.replace(cfg, n_layers=n))) * 4 * (1 + slots)
    free = shutil.disk_usage(root).free
    n = own or cfg.n_layers
    while n > 1 and need_x * nbytes(n) > free:
        n -= 1
    cut = "" if n == (own or cfg.n_layers) else \
        f" (DEPTH CUT from {own or cfg.n_layers} layers for the disk)"
    log(f"checkpoint dir {root}: {free:,} bytes free; {name} at {n} of "
        f"{cfg.n_layers} layers: {nbytes(n):,} bytes a checkpoint{cut}")
    return None if n == cfg.n_layers else n


def record_batches(run):
    """Wrap ``run.step`` to keep a device copy of every batch a step
    consumes (cloned on the training stream, read back later)."""
    seen = []
    step = run.step

    def recorded(state, batch):
        seen.append({k: v.clone() for k, v in batch.items()})
        return step(state, batch)
    run.step = recorded
    return seen


def host_stream(pack, n):
    """The host loader's first ``n`` batches of the pack (batch 8, seed 0,
    the launcher's) and its cursor after each (the first: before any)."""
    from repro_torch.data import DiskShardedSource, StreamingLoader
    loader = StreamingLoader(DiskShardedSource(str(pack)), 8, seed=0)
    batches, states = [], [loader.state]
    for _ in range(n):
        batches.append(next(loader))
        states.append(loader.state)
    loader.close()
    return batches, states


def same_batches(torch, what, got, want):
    """Batches read back from the card against host batches, bitwise."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} batches, want {len(want)}")
    for t, (g, w) in enumerate(zip(got, want)):
        if sorted(g) != sorted(w) or not all(
                same_bits(torch, g[k].cpu(), w[k]) for k in w):
            raise AssertionError(f"{what}: batch {t} differs")


def phase_ckpt(torch, kernels, train_mod, name, root, pack):
    """Phase 18 for one optimizer, through the launcher's own functions:
    steps 0-1 with ``--save-every 2 --async-save`` (the async save's
    blocking copy timed at the step boundary, its commit, then a sync save
    of the same state, timed); a fresh run from the saved train_meta.json
    with ``--resume`` (load timed): every buffer bitwise the live state's
    at step 2, the spec and horizon adopted; steps 2-3 from the restored
    state (launch counts set to 0 just before and read just after) held
    against steps 2-3 from the live state, run twice."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.checkpoint.io import _flatten, archive_keys
    from repro_torch.checkpoint import load_loader_state
    what, flags, _, per_step, reads_pack = CKPT_RUNS[name]
    n_layers = ckpt_layers(name, root)
    ck = root / name
    common = ["--arch", ARCH, "--batch", "8", "--seq", "512", "--n-micro", "2",
              "--weight-decay", "1e-4", "--log-every", "1", "--device", "cuda",
              "--seed", "0", *flags]
    if reads_pack:
        common += ["--data-dir", str(pack), "--prefetch", "2"]
        host_batches, host_states = host_stream(pack, 4)
    with depth_cut(train_mod, n_layers):
        args = train_mod.parse_args(common + [
            "--steps", "2", "--total-steps", "4", "--ckpt", str(ck),
            "--save-every", "2", "--async-save"])
        plan = train_mod.plan_run(args)
        run = train_mod.build(args, plan.spec)
    ck_bytes = sum(v.numel() * v.element_size() if torch.is_tensor(v) else 4
                   for v in _flatten({"params": run.state.params_view,
                                      "opt": run.state.opt_state}).values())
    saves = train_mod.Saves(args, plan, run.loader_state)
    seen_a = record_batches(run)
    timing = {}
    save_step = saves.save_step

    def timed_save(step_no, st):
        torch.cuda.synchronize()       # the step's kernels out of the window
        timing["t0"] = time.perf_counter()
        save_step(step_no, st)
        timing["block"] = time.perf_counter() - timing["t0"]
    saves.save_step = timed_save
    state, mem = train_mod.train(args, run, 0, saves.step_hook)
    saves.finish(state, 0)             # drains the background commit
    async_s = time.perf_counter() - timing["t0"]
    tree = {"params": state.params_view, "opt": state.opt_state}
    step_s = mem.steps[-1][1]["step_time_s"]      # step 1: step 0 is first use
    t0 = time.perf_counter()
    save_checkpoint(str(root / f"{name}_sync"), tree, step=2)
    sync_s = time.perf_counter() - t0
    shutil.rmtree(root / f"{name}_sync")
    gb = ck_bytes / 1e9
    log(f"{what}, {run.cfg.n_layers} layers: checkpoint {ck_bytes:,} bytes "
        f"(params + f32 slots, the pytree form); async save: the step "
        f"boundary blocked {timing['block']:.3f} s (a pageable device-to-host "
        f"copy, {gb / timing['block']:.2f} GB/s) beside the {step_s:.3f} s "
        f"step before it, committed {async_s:.2f} s after it began "
        f"({gb / async_s:.2f} GB/s); sync save {sync_s:.2f} s "
        f"({gb / sync_s:.2f} GB/s)")
    live = [b.to("cpu", copy=True) for b in state_buffers(state)]   # step 2
    cursor = run.loader_state()               # the live stream at batch 2
    if reads_pack:
        saved = load_loader_state(str(ck / "step_00000002"))
        if saved != host_states[2].to_dict() or cursor != host_states[2]:
            raise AssertionError(f"{what}: step-2 loader_state {saved}, the "
                                 f"live stream's {cursor}, want {host_states[2]}")
        same_batches(torch, f"{what} steps 0-1", seen_a, host_batches[:2])
        log(f"{what}: the step-2 checkpoint's loader_state {saved} is the host "
            f"loader's cursor after 2 batches; steps 0-1 read the host "
            f"loader's batches 0-1, bitwise")

    with depth_cut(train_mod, n_layers):
        args_b = train_mod.parse_args(common + ["--steps", "4", "--ckpt", str(ck),
                                                "--resume"])
        plan_b = train_mod.plan_run(args_b)
        run_b = train_mod.build(args_b, plan_b.spec)
    if (plan_b.horizon, plan_b.spec) != (4, plan.spec):
        raise AssertionError(f"resume adopted {plan_b.horizon} {plan_b.spec}, "
                             f"saved 4 {plan.spec}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start = train_mod.resume(run_b, plan_b.resume_path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if start != 2 or run_b.state.step != 2 or not plan_b.resume_path.endswith(
            "step_00000002"):
        raise AssertionError(f"resumed {plan_b.resume_path} at {start}")
    keys = archive_keys(plan_b.resume_path)
    if keys != set(_flatten({"params": run_b.state.params_view,
                             "opt": run_b.state.opt_state})):
        raise AssertionError(f"{what}: the archive's keys are not the live "
                             f"state's pytree form")
    same = [same_bits(torch, a, b) for a, b in
            zip(state_buffers(state), state_buffers(run_b.state))]
    if len(same) != len(state_buffers(run_b.state)) or not all(same):
        raise AssertionError(f"{what}: restored buffers differ from the live "
                             f"state at step 2: {same}")
    if run_b.loader_state() != cursor:
        raise AssertionError(f"{what}: resumed data cursor "
                             f"{run_b.loader_state()}, saved {cursor}")
    seen_b = record_batches(run_b)
    log(f"loaded {load_s:.2f} s ({gb / load_s:.2f} GB/s; the file was written "
        f"moments before, the page cache not dropped); every restored byte "
        f"(params, f32 slots, padding) and the step equal the live state's at "
        f"step 2")

    kernels.reset_launches()
    state_b, mem_b = train_mod.train(args_b, run_b, start)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    want = {k: per_step.get(k, 0) * 2 for k in OPT_KERNELS}
    if {k: launches[k] for k in OPT_KERNELS} != want:
        raise AssertionError(f"{what}: resumed launches {launches}, want {want}")
    resumed = state_buffers(state_b)   # B's buffers, kept for the diffs
    if reads_pack:
        run_b.data.close()
    del run_b, state_b

    # steps 2-3 from the live state, twice, with at most two states and
    # the activations on the card at once (80 GB)
    recs, seen_live = [], []
    for i in range(2):
        for b, h in zip(state_buffers(state), live):
            b.copy_(h)
        run.state = state
        if reads_pack:
            run.data.seek(cursor)
        seen_a.clear()
        _, m = train_mod.train(args_b, run, 2)
        seen_live.append(list(seen_a))
        recs.append([r for _, r in m.steps])
        if i == 0:
            d_res = max_abs_diff(torch, state_buffers(state), resumed)
            del resumed
            torch.cuda.empty_cache()
            buf1 = [b.clone() for b in state_buffers(state)]
        else:
            d_live = max_abs_diff(torch, state_buffers(state), buf1)
    rec1, rec2 = recs
    recb = [r for _, r in mem_b.steps]
    keys = ("loss", "grad_norm", "update_norm")
    s_live = max(abs(a[k] - b[k]) for a, b in zip(rec1, rec2) for k in keys)
    s_res = max(abs(a[k] - b[k]) for a, b in zip(rec1, recb) for k in keys)
    log(f"steps 2-3: live run 1 losses {fmt_all(rec1, 'loss', '.6f')}, live run 2 "
        f"{fmt_all(rec2, 'loss', '.6f')}, resumed {fmt_all(recb, 'loss', '.6f')}; "
        f"max |state| difference live-live {d_live:.3e}, resumed-live "
        f"{d_res:.3e}; max stats difference live-live {s_live:.3e}, "
        f"resumed-live {s_res:.3e}; resumed launches: " + ", ".join(
            f"{k} {launches[k]}" for k in per_step))
    if d_res > RESUME_SLACK * d_live or s_res > RESUME_SLACK * s_live:
        raise AssertionError(f"{what}: the resumed steps differ from the live "
                             f"ones by {d_res} (state) / {s_res} (stats), two "
                             f"live runs by {d_live} / {s_live}")
    if reads_pack:
        for i, seen in enumerate(seen_live):
            same_batches(torch, f"{what} live run {i + 1}", seen,
                         host_batches[2:])
        same_batches(torch, f"{what} resumed", seen_b,
                     [{k: v.cpu() for k, v in b.items()} for b in seen_live[0]])
        log(f"{what}: the resumed run's batches 2-3, read back from the card, "
            f"are bitwise the live runs' and the host loader's batches 2-3")
        run.data.close()
    del run, state, live, buf1
    torch.cuda.empty_cache()
    shutil.rmtree(ck)


def ckpt_phases(torch, kernels, train_mod, pack):
    """Phase 18: both round trips in a git-ignored scratch dir under
    ``build/``, removed at the end."""
    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="ckpt_smoke_", dir=ROOT / "build"))
    try:
        for name in PHASE18_RUNS:
            phase_ckpt(torch, kernels, train_mod, name, root, pack)
            gc.collect()               # the timed hook's cycle holds the run
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# the pack (phases 18-19) and phase 19: the data pipeline at full width
# ---------------------------------------------------------------------------

# 56 examples in 7 shards of 8: an epoch is 7 batches of phase 9's 8
PACK_EXAMPLES, PACK_SHARD, PACK_SEQ = 56, 8, 512
DATA_STEPS = 9                     # crosses the epoch boundary at step 7
DATA_FLAGS = ["--optimizer", "sngm", "--fused", "multi_tensor"]


@contextlib.contextmanager
def scratch_pack(vocab):
    """A synthetic-LM pack at ``vocab`` through ``repro_torch.data.pack``'s
    CLI, timed, in a git-ignored scratch dir under ``build/`` that is
    removed at the end."""
    from repro_torch.data import DiskShardedSource
    from repro_torch.data import pack as pack_mod
    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="data_smoke_", dir=ROOT / "build"))
    try:
        out = root / "pack"
        t0 = time.perf_counter()
        pack_mod.main([str(out), "--synthetic-lm", "--vocab", str(vocab),
                       "--seq", str(PACK_SEQ), "--n", str(PACK_EXAMPLES),
                       "--shard-size", str(PACK_SHARD), "--seed", "0"])
        pack_s = time.perf_counter() - t0
        src = DiskShardedSource(str(out))
        if src.shard_lengths() != (PACK_SHARD,) * (PACK_EXAMPLES // PACK_SHARD) \
                or src.meta["vocab_size"] != vocab:
            raise AssertionError(f"pack: shards {src.shard_lengths()}, "
                                 f"meta {src.meta}")
        nbytes = sum(f.stat().st_size for f in out.iterdir())
        log(f"pack: {PACK_EXAMPLES} synthetic-LM examples (vocab {vocab}, seq "
            f"{PACK_SEQ}) in {len(src.shard_lengths())} shards of {PACK_SHARD}, "
            f"{nbytes:,} bytes on disk, packed in {pack_s:.2f} s on the host")
        yield out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def time_h2d(torch, batch, n=20):
    """The host-to-device copy of one host batch as the launcher stages
    it (one ``HostToDevice``: a pinned ring, its side stream, an event),
    waited for on the training stream: the median ms between events
    recorded on that stream around ``place(batch).wait()``, and the host
    ms of the call."""
    from repro_torch.data.prefetch import HostToDevice
    place = HostToDevice("cuda", slots=4)
    dev, host = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        place(batch).wait()
        end.record()
        host.append((time.perf_counter() - t0) * 1e3)
        end.synchronize()
        dev.append(start.elapsed_time(end))
    return float(np.median(dev)), float(np.median(host))


def data_run(torch, kernels, train_mod, pack, prefetch):
    """One 9-step SNGM run of full-width gemma-2b from the pack, through
    the launcher's ``build``/``train``: the step records, the stall and
    depth per step (``--prefetch 0``: the time each ``next()`` of the
    training thread took, the depth 0), the batches the steps consumed
    (read back from the card) and the launch counts, set to 0 just
    before the run and read just after."""
    args = train_mod.parse_args(
        ["--arch", ARCH, "--steps", str(DATA_STEPS), "--batch", "8",
         "--seq", "512", "--n-micro", "2", "--weight-decay", "1e-4",
         "--log-every", "1", "--device", "cuda", "--seed", "0",
         "--data-dir", str(pack), "--prefetch", str(prefetch), *DATA_FLAGS])
    run = train_mod.build(args)
    if run.seq != PACK_SEQ:
        raise AssertionError(f"the run's seq {run.seq}, the pack's {PACK_SEQ}")
    seen = record_batches(run)
    sync_stalls = []
    if prefetch == 0:
        start = run.data.start

        def timed_start():
            it = start()
            while True:
                t0 = time.perf_counter()
                try:
                    b = next(it)
                except StopIteration:
                    return
                sync_stalls.append(time.perf_counter() - t0)
                yield b
        run.data.start = timed_start
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    _, mem = train_mod.train(args, run)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    recs = [m for _, m in mem.steps]
    if prefetch:
        stalls = [m["input_stall_s"] for m in recs]
        depths = [m["prefetch_depth"] for m in recs]
    else:
        stalls, depths = sync_stalls, [0] * len(recs)
    batches = [{k: v.cpu() for k, v in b.items()} for b in seen]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    run.data.close()
    del run, seen
    gc.collect()
    torch.cuda.empty_cache()
    return recs, stalls, depths, batches, launches, peak_gib


def phase_data(torch, kernels, train_mod, pack):
    """Phase 19: 9 steps with ``--prefetch 2`` and with ``--prefetch 0``
    (and a second ``--prefetch 0`` run if the two differ), each batch
    bitwise the host loader's, the runs' stats equal or within twice the
    difference of two ``--prefetch 0`` runs; the per-step input stall,
    depth and step time, and one batch's host-to-device copy."""
    host_batches, host_states = host_stream(pack, DATA_STEPS)
    per_epoch = PACK_EXAMPLES // 8
    if host_states[per_epoch].epoch != 0 or host_states[per_epoch + 1].epoch != 1:
        raise AssertionError(f"epoch boundary not at step {per_epoch}: "
                             f"{host_states}")
    nbytes = sum(v.numel() * v.element_size() for v in host_batches[0].values())
    copy_ms, copy_host_ms = time_h2d(torch, host_batches[0])
    log(f"one batch ({nbytes:,} bytes: tokens int32 + loss_mask fp32, 8 x "
        f"{PACK_SEQ}) host to device (a pinned ring, a side stream), waited for on "
        f"the training stream: {copy_ms * 1e3:.1f} us between events "
        f"({nbytes / (copy_ms * 1e-3) / 1e9:.3f} GB/s), the call {copy_host_ms * 1e3:.1f} "
        f"us on the host (median of 20)")
    keys = ("loss", "grad_norm", "update_norm")
    runs = {}
    for label, prefetch in (("prefetch 2", 2), ("prefetch 0", 0)):
        recs, stalls, depths, batches, launches, peak = data_run(
            torch, kernels, train_mod, pack, prefetch)
        want = {k: {"chunk_sumsq": DATA_STEPS, "fused_update": DATA_STEPS}.get(k, 0)
                for k in OPT_KERNELS}
        if {k: launches[k] for k in OPT_KERNELS} != want:
            raise AssertionError(f"{label}: launches {launches}, want {want}")
        if len(recs) != DATA_STEPS or not all(
                np.isfinite(m[k]) for m in recs for k in keys):
            raise AssertionError(f"{label}: step records {recs}")
        same_batches(torch, label, batches, host_batches)
        step_s = [m["step_time_s"] for m in recs]
        log(f"{label}: {DATA_STEPS} steps, launches chunk_sumsq "
            f"{launches['chunk_sumsq']}, fused_update {launches['fused_update']}; "
            f"every batch, read back from the card, bitwise the host loader's "
            f"(steps 7-8 from epoch 1); peak device memory {peak:.2f} GiB; "
            f"losses {fmt_all(recs, 'loss', '.6f')}")
        for t in range(DATA_STEPS):
            log(f"  {label} step {t}: input stall {stalls[t] * 1e3:.3f} ms, "
                f"depth {depths[t]}, step {step_s[t]:.3f} s")
        steady = slice(1, None)
        log(f"{label}: input stall median {np.median(stalls[steady]) * 1e3:.3f} ms "
            f"(max {max(stalls[steady]) * 1e3:.3f}) beside a median step of "
            f"{np.median(step_s[steady]):.3f} s, steps 1-{DATA_STEPS - 1}; step 0 "
            f"stall {stalls[0] * 1e3:.3f} ms, depth avg "
            f"{np.mean(depths):.2f}")
        runs[label] = recs
    diff = max(abs(a[k] - b[k]) for a, b in zip(runs["prefetch 2"], runs["prefetch 0"])
               for k in keys)
    if diff == 0:
        log("prefetch 2 against prefetch 0: losses, grad norms and update "
            "norms bitwise equal at every step")
        return
    recs = data_run(torch, kernels, train_mod, pack, 0)[0]
    slack = max(abs(a[k] - b[k]) for a, b in zip(runs["prefetch 0"], recs)
                for k in keys)
    log(f"prefetch 2 against prefetch 0: max stats difference {diff:.3e}; two "
        f"prefetch 0 runs {slack:.3e}")
    if diff > RESUME_SLACK * slack:
        raise AssertionError(f"prefetch 2 and 0 differ by {diff}, two prefetch "
                             f"0 runs by {slack}")


# ---------------------------------------------------------------------------
# phase 20: the paper's convnet (Fig. 1 / Table 2) and the two training
# loops of its benches, on the engine
# ---------------------------------------------------------------------------

# benchmarks/bench_table2_cifar_proxy.py: 4096 train and 1024 test images,
# 16 epochs, B 64 and 1024, micro-batches of 128
CONVNET_TRAIN, CONVNET_TEST, CONVNET_EPOCHS = 4096, 1024, 16
B_SMALL, B_LARGE, ACCUM_MICRO, GHOST = 64, 1024, 128, 128
CONVNET_PARAMS, CONVNET_LEAVES = 545_098, 8
CONVNET_STEPS = 3                  # phases 20b and 20c
CARD_CPU_STEP0_REL = 1e-5          # the card's first loss against the CPU's
CARD_CPU_REL = 1e-4                # steps 1-2 (a few fp32 ulps, grown by a step)
# phase 20b: launches a step on the convnet path, each optimizer on the engine
CONVNET_LAUNCHES = {"sngm": {"chunk_sumsq": 1, "fused_update": 1},
                    "msgd": {"chunk_sumsq": 1, "fused_update": 1},
                    "lars": {"chunk_sumsq": 2, "fused_update": 1},
                    "lamb": {"adam_update": 1, "scale_apply": 1}}
# benchmarks/bench_table3_lm_proxy.py: SNGM at B 256, seq 64, 16 micro-batches
LM_BATCH, LM_SEQ, LM_MICRO, LM_STEPS = 256, 64, 16, 5
LM_BUDGET = 64 * 64 * 160


def convnet_optimizer(name, fused, steps):
    """``name`` with its Table 2 hyperparameters at B 1024 over ``steps``
    (lamb, which Table 2 lacks: lr 0.01, wd 1e-4, poly power)."""
    from repro_torch.core import lamb, lars, msgd, sngm
    from repro_torch.core.schedules import poly_power, step_decay
    if name == "sngm":
        return sngm(poly_power(0.2, steps, 1.1), beta=0.9, weight_decay=1e-4,
                    fused=fused)
    if name == "msgd":
        return msgd(step_decay(0.4, [int(steps * .6), int(steps * .85)]),
                    beta=0.9, weight_decay=1e-4, fused=fused)
    if name == "lars":
        return lars(poly_power(4.0, steps, 1.1), beta=0.9, weight_decay=1e-4,
                    trust=0.01, fused=fused)
    return lamb(poly_power(0.01, steps, 1.1), weight_decay=1e-4, fused=fused)


def table2_jobs(steps_small, steps_large):
    """benchmarks/bench_table2_cifar_proxy.py's five jobs on the engine,
    and SNGM at B 1024 with ghost batch norm: (name, batch, optimizer,
    steps, ghost_batch)."""
    from repro_torch.core import lars, msgd
    from repro_torch.core.schedules import poly_power, step_decay, warmup
    f = "multi_tensor"
    large = lambda name: convnet_optimizer(name, f, steps_large)   # noqa: E731
    return [
        ("msgd_small", B_SMALL,
         msgd(step_decay(0.05, [int(steps_small * .6), int(steps_small * .85)]),
              beta=0.9, weight_decay=1e-4, fused=f), steps_small, None),
        ("msgd_large", B_LARGE, large("msgd"), steps_large, None),
        ("lars_large", B_LARGE, large("lars"), steps_large, None),
        ("lars_large_warmup", B_LARGE,
         lars(warmup(poly_power(6.0, steps_large, 2.0), max(steps_large // 8, 1),
                     0.4), beta=0.9, weight_decay=1e-4, trust=0.01, fused=f),
         steps_large, None),
        ("sngm_large", B_LARGE, large("sngm"), steps_large, None),
        (f"sngm_large_ghost{GHOST}", B_LARGE, large("sngm"), steps_large, GHOST),
    ]


def convnet_grads(torch, ts, x, y, batch, seed=0):
    """One global batch's accumulated gradients on ``ts`` (micro-batches
    of ACCUM_MICRO, as ``train_convnet`` takes them): ``FlatGrads`` on a
    resident state."""
    from repro_torch.models.convnet import ce_loss
    from repro_torch.training.step import _grad_leaves, _mean_grads
    idx = torch.from_numpy(np.random.RandomState(seed).randint(
        0, x.shape[0], size=(batch,))).to(x.device)
    params, flat = _grad_leaves(ts)
    n_micro = batch // ACCUM_MICRO
    for m in range(n_micro):
        sl = idx[m * ACCUM_MICRO:(m + 1) * ACCUM_MICRO]
        ce_loss(params, x[sl], y[sl]).backward()
    return _mean_grads(params, flat, n_micro)


def phase_convnet_vs_plain(torch, data):
    """20a: each optimizer on the engine against ``fused=None`` from one
    state on the same gradient tensors, 3 steps, bitwise (params, slots,
    stats, sign of zero included); then each one's optimizer step timed
    on those gradients, engine and plain."""
    from repro_torch.models.convnet import init_convnet
    from repro_torch.tracker.counters import param_bytes_live
    x, y = data[0], data[1]
    params = init_convnet(0, device="cuda")
    n = sum(v.numel() for v in params.values())
    if n != CONVNET_PARAMS or len(params) != CONVNET_LEAVES:
        raise AssertionError(f"convnet: {n} params in {len(params)} leaves")
    probe = convnet_optimizer("sngm", "multi_tensor", 64)
    grads = convnet_grads(torch, probe.init_state(params), x, y, B_LARGE)
    opt_ms = {}
    for name in CONVNET_LAUNCHES:
        opts = [convnet_optimizer(name, f, 64) for f in (None, "multi_tensor")]
        states = [o.init_state({k: v.clone() for k, v in params.items()})
                  for o in opts]
        live = param_bytes_live(states[1])
        for t in range(3):
            outs = [opts[0].step_state(grads.tree, states[0]),
                    opts[1].step_state(grads, states[1])]
            states = [s for s, _ in outs]
            sa, sb = (st for _, st in outs)
            pa, pb = (s.params_view for s in states)
            same = (all(same_bits(torch, sa[k], sb[k]) for k in sa)
                    and all(same_bits(torch, pa[k], pb[k]) for k in pa)
                    and all(same_bits(torch, ua[k], ub[k])
                            for ua, ub in zip(*map(opt_slots, states))
                            for k in ua))
            if not same:
                raise AssertionError(f"convnet {name} step {t}: fused=None and "
                                     f"multi_tensor differ")
        holders = [{"s": s} for s in states]

        def stepper(o, h, g):
            def step():
                h["s"], _ = o.step_state(g, h["s"])
            return step
        plain_ms = time_calls(torch, stepper(opts[0], holders[0], grads.tree), n=20)
        engine_ms = time_calls(torch, stepper(opts[1], holders[1], grads), n=20)
        host_ms = wall_ms(torch, stepper(opts[1], holders[1], grads))
        opt_ms[name] = engine_ms
        log(f"convnet {name}: engine equals fused=None bitwise over 3 steps on "
            f"the same gradients (params, slots, stats); optimizer step on the "
            f"device {engine_ms:.4f} ms engine, {plain_ms:.4f} ms plain; the "
            f"engine's step {host_ms:.4f} ms on the host's clock (synchronized); "
            f"resident param bytes {live:,} = "
            f"{live / (4 * CONVNET_PARAMS):.4f}x the raw fp32 bytes")
        del states, outs, holders
    log(f"20a: convnet {CONVNET_PARAMS:,} fp32 params in {CONVNET_LEAVES} "
        f"leaves; SNGM, MSGD, LARS and LAMB on the engine bitwise fused=None")
    return opt_ms


def wall_ms(torch, fn, n=20):
    """Median host ms of ``fn()`` with the card synchronized after each."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_convnet_launches(torch, kernels, data):
    """20b: ``train_convnet`` at B 1024 in 8 micro-batches for 3 steps on
    the engine, each optimizer's run with the launch counts set to 0 just
    before and read just after, the call counts beside them; the port's
    counters (``engine_counters``, ``plan_launches_per_step``) against
    the counts read, and the resident state's live param bytes (1x)."""
    from repro_torch.kernels import count_kernel_calls
    from repro_torch.models.convnet import init_convnet
    from repro_torch.tracker import MemoryTracker
    from repro_torch.tracker.counters import (engine_counters,
                                              param_bytes_live,
                                              plan_launches_per_step)
    from repro_torch.training import train_convnet
    out = {}
    for name, per_step in CONVNET_LAUNCHES.items():
        opt = convnet_optimizer(name, "multi_tensor", 64)
        mem = MemoryTracker()
        torch.cuda.synchronize()
        kernels.reset_launches()
        with count_kernel_calls() as calls:
            r = train_convnet(opt, *data, B_LARGE, CONVNET_STEPS,
                              accum_micro=ACCUM_MICRO, tracker=mem, device="cuda")
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        want = {k: per_step.get(k, 0) * CONVNET_STEPS for k in OPT_KERNELS}
        if {k: launches[k] for k in OPT_KERNELS} != want:
            raise AssertionError(f"convnet {name}: launches {launches}, want {want}")
        if calls["calls"] != launches:
            raise AssertionError(f"convnet {name}: calls {calls['calls']} against "
                                 f"launches {launches}")
        if not all(np.isfinite(r["losses"])) or len(r["losses"]) != CONVNET_STEPS:
            raise AssertionError(f"convnet {name}: losses {r['losses']}")
        params = init_convnet(0, device="cuda")
        counters = engine_counters(opt, params)
        plan = plan_launches_per_step(opt, params)
        n_step = sum(per_step.values())
        if counters["launches_per_step"] != n_step or plan != n_step:
            raise AssertionError(f"convnet {name}: counters {counters}, plan "
                                 f"{plan}, launches a step {n_step}")
        ts = opt.init_state(params)
        flat_bytes = sum(f.numel() * f.element_size() for f in ts.opt_state.p_flats)
        if not (ts.params is None and counters["param_bytes_live"]
                == param_bytes_live(ts) == flat_bytes < 2 * 4 * CONVNET_PARAMS):
            raise AssertionError(f"convnet {name}: live param bytes "
                                 f"{counters['param_bytes_live']}, flat {flat_bytes}")
        steps = [m["step_time_s"] for _, m in mem.steps]
        log(f"20b: convnet {name} on the engine, B {B_LARGE} in "
            f"{B_LARGE // ACCUM_MICRO} micro-batches, {CONVNET_STEPS} steps: "
            f"launches " + ", ".join(f"{k} {launches[k]}" for k in per_step)
            + f" (= calls); counters {counters}, plan {plan}; resident param "
            f"bytes {counters['param_bytes_live']:,} "
            f"({counters['param_bytes_live'] / (4 * CONVNET_PARAMS):.4f}x raw); "
            f"losses {', '.join(f'{v:.6f}' for v in r['losses'])}; step times "
            f"{', '.join(f'{s * 1e3:.2f}' for s in steps)} ms")
        out[name] = {"launches": {k: launches[k] for k in per_step},
                     "losses": r["losses"]}
    return out


def phase_convnet_card_vs_cpu(torch, data, card_losses):
    """20c: the first 3 losses of SNGM-engine ``train_convnet`` at B 1024
    on the card against the same call on the CPU; and 20b's SNGM run
    against this one (whether the card repeats itself)."""
    from repro_torch.training import train_convnet
    cpu = train_convnet(convnet_optimizer("sngm", "multi_tensor", 64),
                        *(t.cpu() for t in data), B_LARGE, CONVNET_STEPS,
                        accum_micro=ACCUM_MICRO, device="cpu")["losses"]
    card = train_convnet(convnet_optimizer("sngm", "multi_tensor", 64), *data,
                         B_LARGE, CONVNET_STEPS, accum_micro=ACCUM_MICRO,
                         device="cuda")["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
    repeat = max(abs(a - b) for a, b in zip(card, card_losses))
    log(f"20c: SNGM convnet losses, card {', '.join(f'{v:.9f}' for v in card)}; "
        f"CPU {', '.join(f'{v:.9f}' for v in cpu)}; relative differences "
        f"{', '.join(f'{v:.3e}' for v in rel)} (bounds: step 0 "
        f"{CARD_CPU_STEP0_REL}, steps 1-2 {CARD_CPU_REL}); two card runs "
        + ("bitwise equal" if repeat == 0 else f"differ by {repeat:.3e}"))
    if rel[0] > CARD_CPU_STEP0_REL or max(rel[1:]) > CARD_CPU_REL:
        raise AssertionError(f"card against CPU: relative differences {rel}")
    return rel, repeat


def phase_convnet_rungs(torch, data):
    """20d: the Table 2 jobs on the engine and SNGM with ghost batch norm,
    reported (loss, test accuracy, examples/s, median step time), not
    asserted beyond a finite first loss."""
    from repro_torch.tracker import MemoryTracker
    from repro_torch.training import train_convnet
    steps_small = CONVNET_EPOCHS * CONVNET_TRAIN // B_SMALL
    steps_large = CONVNET_EPOCHS * CONVNET_TRAIN // B_LARGE
    results = {}
    for name, batch, opt, steps, ghost in table2_jobs(steps_small, steps_large):
        mem = MemoryTracker()
        t0 = time.perf_counter()
        r = train_convnet(opt, *data, batch, steps, accum_micro=ACCUM_MICRO,
                          tracker=mem, ghost_batch=ghost, device="cuda")
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        if not np.isfinite(r["losses"][0]):
            raise AssertionError(f"{name}: step-0 loss {r['losses'][0]}")
        step_ms = 1e3 * float(np.median([m["step_time_s"] for _, m in mem.steps[1:]]))
        results[name] = dict(r, median_step_ms=step_ms)
        log(f"20d: {name:22s} B {batch:5d} x {len(r['losses'])} steps: final "
            f"loss {r['final_loss']:.4f}, test acc {r['test_acc']:.4f}, "
            f"{r['examples_per_s']:.0f} examples/s, median step {step_ms:.3f} ms, "
            f"run {total:.2f} s{' (diverged)' if r['diverged'] else ''}")
    s, l = results["msgd_small"], results["msgd_large"]
    log(f"20d: Fig. 1 drop (MSGD B {B_SMALL} -> {B_LARGE}): test acc "
        f"{s['test_acc']:.4f} -> {l['test_acc']:.4f}, loss "
        f"{s['final_loss']:.4f} -> {l['final_loss']:.4f}; Table 2 gaps to "
        f"msgd_small: " + ", ".join(
            f"{k} {s['test_acc'] - r['test_acc']:+.4f}" for k, r in results.items()
            if k != "msgd_small"))
    return results


def profile_convnet(torch, data, steps=8, top=6):
    """SNGM ``train_convnet`` at B 1024 for 8 steps under torch.profiler:
    the device's busy share of the call's wall time (set-up included: the
    weights drawn, the state packed) and the kernels that take the most
    of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.training import train_convnet
    opt = convnet_optimizer("sngm", "multi_tensor", 64)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_convnet(opt, *data, B_LARGE, steps, accum_micro=ACCUM_MICRO,
                      device="cuda")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    if busy == 0:
        log("20d profile: the profiler saw no device time (not measured)")
        return None
    log(f"20d profile: SNGM convnet B {B_LARGE}, {steps} steps: {wall:.1f} ms "
        f"wall (profiler on), device busy {busy:.1f} ms = {100 * busy / wall:.1f} "
        f"%, idle {100 - 100 * busy / wall:.1f} %; top kernels by device time:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<5d} {e.key[:90]}")
    return busy / wall


def phase_lm_proxy(torch, kernels):
    """20e: ``train_lm`` at the Table 3 proxy config (deepseek-7b smoke,
    vocab 256, fp32), SNGM on the engine, B 256, seq 64, 16 micro-batches,
    5 steps, the launch counts set to 0 just before and read just after."""
    from repro_torch.configs import ARCHS, smoke_variant
    from repro_torch.core import sngm
    from repro_torch.core.schedules import poly_power
    from repro_torch.training import train_lm
    cfg = dataclasses.replace(smoke_variant(ARCHS["deepseek-7b"]),
                              vocab_size=256, compute_dtype="float32")
    opt = sngm(poly_power(2.0, LM_BUDGET // (LM_BATCH * LM_SEQ), 1.1), beta=0.9,
               weight_decay=1e-4, fused="multi_tensor")
    torch.cuda.synchronize()
    kernels.reset_launches()
    r = train_lm(opt, cfg, LM_BATCH, LM_SEQ, LM_STEPS, n_micro=LM_MICRO,
                 device="cuda")
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    want = {k: {"chunk_sumsq": LM_STEPS, "fused_update": LM_STEPS}.get(k, 0)
            for k in OPT_KERNELS}
    if {k: launches[k] for k in OPT_KERNELS} != want:
        raise AssertionError(f"train_lm: launches {launches}, want {want}")
    if not (all(np.isfinite(r["losses"])) and r["tokens_per_s"] > 0):
        raise AssertionError(f"train_lm: {r}")
    log(f"20e: train_lm {cfg.name} vocab 256 fp32, SNGM on the engine, B "
        f"{LM_BATCH} x seq {LM_SEQ} in {LM_MICRO} micro-batches, {LM_STEPS} steps: "
        f"losses {', '.join(f'{v:.4f}' for v in r['losses'])} (chain entropy "
        f"{r['optimal_loss']:.4f}); {r['tokens_per_s']:.0f} tokens/s over "
        f"{r['wall_time_s']:.3f} s; launches chunk_sumsq "
        f"{launches['chunk_sumsq']}, fused_update {launches['fused_update']}")
    return r


def phase_convnet(torch, kernels):
    """Phase 20: the convnet path and the LM loop, 20a-20e."""
    from repro_torch.data import synthetic_images
    x, y = synthetic_images(CONVNET_TRAIN, seed=0)
    xt, yt = synthetic_images(CONVNET_TEST, seed=99)
    data = tuple(t.to("cuda") for t in (x, y, xt, yt))
    t0 = time.perf_counter()
    opt_ms = phase_convnet_vs_plain(torch, data)
    runs = phase_convnet_launches(torch, kernels, data)
    phase_convnet_card_vs_cpu(torch, data, runs["sngm"]["losses"])
    t1 = time.perf_counter()
    results = phase_convnet_rungs(torch, data)
    profile_convnet(torch, data)
    t2 = time.perf_counter()
    phase_lm_proxy(torch, kernels)
    step_ms = results["sngm_large"]["median_step_ms"]
    log(f"phase 20: 20a-20c {t1 - t0:.1f} s, 20d {t2 - t1:.1f} s, 20e "
        f"{time.perf_counter() - t2:.1f} s; at B {B_LARGE} SNGM's optimizer step "
        f"{opt_ms['sngm']:.4f} ms on the device = "
        f"{100 * opt_ms['sngm'] / step_ms:.2f} % of a {step_ms:.3f} ms step "
        f"(sngm_large's median)")
    return runs, results


# ---------------------------------------------------------------------------
# phase 21: EMA shadow parameters on the engine
# ---------------------------------------------------------------------------

EMA_DECAY = 0.999
EMA_FLAGS = ["--optimizer", "sngm", "--fused", "multi_tensor"]
SNGM_LAUNCHES = {"chunk_sumsq": 1, "fused_update": 1}
# (what, launcher flags, steps, kernel launches per step), as TRAIN_RUNS;
# plain SNGM is the baseline of the step time and the peak memory
EMA_RUNS = {
    "sngm_no_ema": ("SNGM on the engine, no EMA", EMA_FLAGS, 3, SNGM_LAUNCHES),
    "sngm_ema": ("SNGM + EMA 0.999 on the engine",
                 EMA_FLAGS + ["--ema-decay", str(EMA_DECAY)], 3, SNGM_LAUNCHES),
    "sngm_ema_nesterov": ("nesterov SNGM + EMA 0.999 on the engine",
                          EMA_FLAGS + ["--ema-decay", str(EMA_DECAY),
                                       "--nesterov"], 3, SNGM_LAUNCHES),
}


def ema_step_timing(torch, run, state):
    """21a: the optimizer step with EMA against plain SNGM's on the same
    buffers (in turns), each step's transient device memory, and the EMA
    advance alone against its byte bound (e read, p read, e written)."""
    from repro_torch.core.multi_tensor import (EMA_SLICE, FlatGrads,
                                               ema_flats_update, zeros_flats)
    from repro_torch.core.optim import TrainState, make_optimizer
    layout = state.opt_state.layout
    g = zeros_flats(layout, device="cuda")
    for f in g:
        f.normal_().mul_(1e-3)
    grads = FlatGrads(tuple(g), layout)
    sngm = make_optimizer("sngm", {"name": "poly_power", "kwargs": {
        "lr0": 1.6, "total_steps": 100}}, weight_decay=1e-4, fused="multi_tensor")
    as_sngm = TrainState(None, dataclasses.replace(
        state.opt_state, form="momentum", e_flats=()))
    holder = {"ema": state, "sngm": as_sngm}

    def step(opt, key):
        def go():
            holder[key], _ = opt.step_state(grads, holder[key])
        return go

    def timed(opt, key):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = time_calls(torch, step(opt, key), n=5)
        return ms, (torch.cuda.max_memory_allocated() - base) / 2**30
    ema_ms, ema_extra = timed(run.opt, "ema")
    sngm_ms, sngm_extra = timed(sngm, "sngm")
    ema_ms2, _ = timed(run.opt, "ema")
    sngm_ms2, _ = timed(sngm, "sngm")
    e, p = state.opt_state.e_flats[0], state.opt_state.p_flats
    adv_ms, enq = time_kernel(torch, lambda: ema_flats_update(e, p, EMA_DECAY),
                              n=10)
    nbytes = sum(f.numel() * (8 + f.element_size()) for f in p)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"optimizer step with EMA {ema_ms:.2f} / {ema_ms2:.2f} ms against plain "
        f"SNGM {sngm_ms:.2f} / {sngm_ms2:.2f} ms on the same buffers (in turns), "
        f"+{ema_ms - sngm_ms:.2f} / +{ema_ms2 - sngm_ms2:.2f} ms; the step's "
        f"transient device memory {ema_extra:.3f} GiB with EMA, {sngm_extra:.3f} "
        f"without; the EMA advance alone (plain PyTorch, slices of "
        f"{EMA_SLICE:,} elements, no kernel of the table) {adv_ms:.3f} ms "
        f"(host enqueue {enq:.3f} ms) against its bound {bound_ms:.3f} ms "
        f"({nbytes:,} bytes: e read, p read, e written; "
        f"{100 * bound_ms / adv_ms:.1f} % of it)")
    del grads, g, holder, as_sngm
    return {"opt_ms": (ema_ms, ema_ms2), "sngm_ms": (sngm_ms, sngm_ms2),
            "advance_ms": adv_ms, "bound_ms": bound_ms}


def phase_ema_train(torch, kernels, train_mod):
    """21a: full-width gemma-2b through the launcher's functions (phase 9's
    batch), plain SNGM, SNGM + EMA and nesterov SNGM + EMA, 3 steps each,
    the launch counts set to 0 just before each and read just after (1
    ``chunk_sumsq`` + 1 ``fused_update`` a step: the advance launches no
    kernel of the table); step time and peak memory with and without EMA;
    the shadow finite and f32; then ``ema_step_timing``."""
    runs = {}
    for name in EMA_RUNS:
        run, state, launches, step_s = phase_train(torch, kernels, train_mod, name)
        peak = torch.cuda.max_memory_allocated() / 2**30
        opt = state.opt_state
        n_ema = len(opt.e_flats)
        if n_ema != (0 if name == "sngm_no_ema" else 1):
            raise AssertionError(f"{name}: {n_ema} EMA slot sets")
        if not all(f.dtype == torch.float32 and bool(torch.isfinite(f).all())
                   for es in opt.e_flats for f in es):
            raise AssertionError(f"{name}: an EMA slot is not f32, or not finite")
        if n_ema:
            moved = max(float((e.float() - p.float()).abs().max())
                        for e, p in zip(opt.e_flats[0], opt.p_flats))
            log(f"{name} [{run.opt.plan.describe()}]: max |ema - params| "
                f"after 3 steps {moved:.3e}")
        runs[name] = {"step_s": step_s, "peak_gib": peak}
        if name == "sngm_ema":
            runs[name].update(ema_step_timing(torch, run, state))
        del run, state, opt
        gc.collect()
        torch.cuda.empty_cache()
    base = runs["sngm_no_ema"]
    log("EMA at full width against plain SNGM: " + "; ".join(
        f"{name} step {r['step_s']:.3f} s ({100 * (r['step_s'] / base['step_s'] - 1):+.1f} %), "
        f"peak {r['peak_gib']:.2f} GiB ({r['peak_gib'] - base['peak_gib']:+.2f})"
        for name, r in runs.items()))
    return runs


def ema_slots(state):
    """Params, momentum and the EMA shadow of an SNGM + EMA state, as
    dicts, in either form."""
    from repro_torch.core import transform as T
    o = state.opt_state
    if hasattr(o, "e_flats"):
        return [state.params_view, o.momentum, o.ema_views[0]]
    by = {type(s): s for s in o.inner}
    return [state.params, by[T.TraceState].momentum, by[T.EmaParamsState].ema]


def phase_ema_vs_interp(torch, kernels, cfg, n_layers=2, decay=0.5):
    """21b: SNGM + EMA on the engine against the port's interpreter
    (``fused=None``) from one state and the same full-width gradients, 3
    steps, fp32 and bf16 params, with and without nesterov: params,
    momentum, EMA slots and stats bitwise (sign of zero included), and
    each engine step's launches the plan's.  Depth cut to 2 layers, as
    in phases 10 and 17."""
    from repro_torch import prng
    from repro_torch.core.optim import make_optimizer
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Runtime, materialize, model_defs
    from repro_torch.training.step import _grad_leaves, loss_fn
    sched = {"name": "poly_power", "kwargs": {"lr0": 1.6, "total_steps": 4}}
    checked = []
    for param_dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, n_layers=n_layers, param_dtype=param_dtype)
        params = materialize(model_defs(c), prng.PRNGKey(1), torch.device("cuda"))
        opt = make_optimizer("sngm", {"name": "constant", "kwargs": {"lr": 0.1}},
                             fused="multi_tensor")
        leaves, grads = _grad_leaves(opt.init_state(params))
        batch = SyntheticLM(c.vocab_size, 512, 2, seed=1,
                            device=torch.device("cuda")).batch_at(0)
        loss_fn(leaves, batch, c, Runtime(torch.device("cuda"), remat=True))[0].backward()
        del leaves
        for nesterov in (False, True):
            interp, eng = (make_optimizer("sngm", sched, weight_decay=1e-4,
                                          nesterov=nesterov, ema_decay=decay,
                                          fused=f)
                           for f in (None, "multi_tensor"))
            a = interp.init_state({k: v.clone() for k, v in params.items()})
            b = eng.init_state(params)
            plan_launches = (eng.plan.launches_per_bucket()
                             * len(b.opt_state.layout.buckets))
            for t in range(3):
                a, sa = interp.step_state(grads.tree, a)
                kernels.reset_launches()
                b, sb = eng.step_state(grads, b)
                torch.cuda.synchronize()
                n = sum(kernels.launch_counts().values())
                if n != plan_launches:
                    raise AssertionError(f"nesterov={nesterov} {param_dtype} "
                                         f"step {t}: {n} launches, the plan "
                                         f"{plan_launches}")
                same = all(same_bits(torch, sa[k], sb[k]) for k in sa) and all(
                    same_bits(torch, x[k], y[k])
                    for x, y in zip(ema_slots(a), ema_slots(b)) for k in x)
                if not same:
                    raise AssertionError(f"SNGM + EMA {decay} nesterov={nesterov} "
                                         f"{param_dtype} step {t}: the engine "
                                         f"and the interpreter differ")
            checked.append(f"{param_dtype}{' nesterov' if nesterov else ''}")
            del a, b
            torch.cuda.empty_cache()
        del params, grads
    log(f"SNGM + EMA {decay} on the engine equals the port's interpreter bitwise "
        f"over 3 steps on the same gradients (params, momentum, EMA slots, "
        f"stats), gemma-2b widths at {n_layers} layers, launches a step the "
        f"plan's: {', '.join(checked)}")


def phase_ema_card_vs_cpu(torch):
    """21c: one EMA advance on the card against the same call on the CPU
    from the same inputs, bitwise: the engine's (two slices, the second
    ragged; signed zeros) and the interpreter stage's, fp32 and bf16
    params.  A contracted multiply-add would differ in the last bit."""
    from repro_torch.core import transform as T
    from repro_torch.core.multi_tensor import EMA_SLICE, ema_flats_update
    gen = torch.Generator().manual_seed(21)
    n = EMA_SLICE + 4099
    done = []
    for dtype in (torch.float32, torch.bfloat16):
        e = torch.randn(n, generator=gen)
        p = torch.randn(n, generator=gen).to(dtype)
        e[:64], p[:64] = -0.0, -0.0
        tree = {"a": torch.randn(1000, 7, generator=gen).to(dtype),
                "b": torch.randn((), generator=gen).to(dtype)}
        for decay in (0.999, 0.99, 0.5):
            cpu = ema_flats_update([e.clone()], [p], decay)[0]
            card = ema_flats_update([e.cuda()], [p.cuda()], decay)[0].cpu()
            if not same_bits(torch, card, cpu):
                raise AssertionError(f"EMA advance {dtype} {decay}: card != CPU "
                                     f"at {int((card != cpu).sum())} elements")
            stage = T.ema_params(decay)
            st = stage.init(tree)
            st_c = stage.init({k: v.cuda() for k, v in tree.items()})
            moved = {k: (v * 3).to(dtype) for k, v in tree.items()}
            _, st, _ = stage.update({}, st, moved)
            _, st_c, _ = stage.update({}, st_c, {k: v.cuda()
                                                 for k, v in moved.items()})
            if not all(same_bits(torch, st_c.ema[k].cpu(), st.ema[k]) for k in tree):
                raise AssertionError(f"ema_params {dtype} {decay}: card != CPU")
            done.append(f"{str(dtype).rsplit('.', 1)[-1]} {decay}")
    log(f"one EMA advance on the card equals the CPU's bitwise ({n:,} elements, "
        f"two slices; the interpreter's stage on a small tree): {', '.join(done)}")


def phase_ema(torch, kernels, train_mod, cfg):
    """Phase 21, 21a-21d; 21d is phase 18's round trip for SNGM + EMA at 2
    layers, in a git-ignored scratch dir under ``build/``."""
    t0 = time.perf_counter()
    runs = phase_ema_train(torch, kernels, train_mod)
    t1 = time.perf_counter()
    phase_ema_vs_interp(torch, kernels, cfg)
    phase_ema_card_vs_cpu(torch)
    t2 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="ema_ckpt_", dir=ROOT / "build"))
    try:
        phase_ckpt(torch, kernels, train_mod, "sngm_ema", root, None)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 21: 21a {t1 - t0:.1f} s, 21b-21c {t2 - t1:.1f} s, 21d "
        f"{time.perf_counter() - t2:.1f} s")
    return runs


# ---------------------------------------------------------------------------
# phases 11-14: RMSNorm and flash attention, the two op entry points
# ---------------------------------------------------------------------------

RMS_SOURCE = "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu"
FA_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
# fp32 bounds, max abs; in bf16 one rounding step of the value is added
# (see over_bound)
OPS_TOL = {"rmsnorm": 1e-5, "flash_attention": 2e-5}
BF16_STEP = 2.0 ** -7              # a bf16 step is at most this times |y|
TRAIN_ROWS = 8 * 512               # phase 9's batch: 8 sequences of 512 tokens
Q_SCALE_LOCAL = 2.0                # gemma2-27b local case: scores of std 2


def over_bound(torch, o, ref, abs_tol):
    """max |o - ref| / bound over the elements (<= 1 passes).  The bound
    is ``abs_tol``, plus in bf16 one bf16 step of the larger of the two
    values: outputs rounded to bf16 from fp32 values that differ by less
    than ``abs_tol`` land at most one step apart, and a step is up to
    2^-7 |y|, so no fixed bound fits every magnitude."""
    of, rf = o.float(), ref.float()
    bound = abs_tol
    if o.dtype == torch.bfloat16:
        bound = abs_tol + BF16_STEP * torch.maximum(of.abs(), rf.abs())
    return ((of - rf).abs() / bound).max().item()


def ops_inputs(torch, gen, rms_spec, fa_spec):
    """Seeded rmsnorm and flash inputs: rms_spec {name: (shape, dtype,
    scale_dtype)}, fa_spec {name: ((B, S, H, K, hd), kw, dtype, q_mul)}.
    x is N(0, 1) and the norm scale 1 + N(0, 0.5^2), so |y| runs past 8;
    q, k, v are N(0, 1), q times q_mul."""
    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)
    rms = {name: (randn(*shape, dtype=dtype),
                  (1.0 + 0.5 * randn(shape[-1])).to(s_dtype))
           for name, (shape, dtype, s_dtype) in rms_spec.items()}
    fa = {}
    for name, ((B, S, H, K, hd), kw, dtype, q_mul) in fa_spec.items():
        fa[name] = (((q_mul * randn(B, S, H, hd)).to(dtype),
                     randn(B, S, K, hd, dtype=dtype),
                     randn(B, S, K, hd, dtype=dtype)), kw)
    return rms, fa


def phase_ops_grid(torch, rms_ops, rms_ref, fa_ops, fa_ref):
    """Each op's kernel against its plain version at small shapes over
    every build variant: rmsnorm fp32/bf16 x with fp32/bf16 scales, a
    warp a row (d <= 2048; bf16 up to 4096) and a block a row (4100 and
    up), the row staged in shared memory or, past 226 KB, read twice
    (fp32 70,000; 120,002), loads of 16 bytes, of 8 (bf16 d = 300, 4100)
    and of one element (4102, 120,002, and a d = 256 x that starts 4
    bytes into its buffer); flash attention at hd 64, 128, 256, MHA
    and GQA, ragged S, causal, window, softcap (scores of std 2), both
    together, non-causal and non-causal with a window, fp32 and bf16;
    fp32 also at every shape and option of the ``cuda``-marked
    ``test_cuda_kernel_matches_plain`` (gemma-2b prefill's shape, a
    window of 128), each fp32 output the same bits on a second call."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    rms_spec = {}
    for dtype in (torch.float32, torch.bfloat16):
        for s_dtype in (torch.float32, torch.bfloat16):
            for shape in ((4, 128), (3, 7, 256), (2, 33, 300), (16, 2048), (5, 4608),
                          (3, 4100), (3, 4102), (2, 70000), (2, 120002)):
                rms_spec[(shape, dtype, s_dtype)] = (shape, dtype, s_dtype)
    kws = [dict(causal=True), dict(causal=True, window=100),
           dict(causal=True, softcap=50.0), dict(causal=True, window=100, softcap=30.0),
           dict(causal=False), dict(causal=False, window=64)]
    shapes = [(2, 256, 4, 4, 64), (2, 512, 4, 2, 64), (2, 256, 8, 1, 128),
              (1, 200, 4, 2, 128), (2, 130, 8, 1, 256)]
    fa_spec = {}
    for dtype in (torch.float32, torch.bfloat16):
        fp32 = dtype == torch.float32          # fp32: the cuda test's grid as well
        for shape in shapes + ([(8, 512, 8, 1, 256)] if fp32 else []):
            for i, kw in enumerate(kws + ([dict(causal=True, window=128)] if fp32 else [])):
                fa_spec[(shape, i, dtype)] = (shape, kw, dtype,
                                              Q_SCALE_LOCAL if "softcap" in kw else 1.0)
    rms, fa = ops_inputs(torch, gen, rms_spec, fa_spec)
    worst, n_rms = {}, 0
    for (shape, dtype, s_dtype), (x, s) in rms.items():
        cases = [x]
        if shape == (3, 7, 256):       # the same rows at a 4-byte offset
            buf = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
            cases.append(buf[1:].view(shape).copy_(x))
        for xc in cases:
            r = over_bound(torch, rms_ops.rmsnorm(xc, s), rms_ref.rmsnorm_ref(xc, s),
                           OPS_TOL["rmsnorm"])
            if r > 1:
                raise AssertionError(f"rmsnorm {shape} {dtype} scale {s_dtype} "
                                     f"offset {xc.data_ptr() % 16}: {r:.3g} x the bound")
            worst[("rmsnorm", dtype)] = max(worst.get(("rmsnorm", dtype), 0.0), r)
            n_rms += 1
    n_again = 0
    for (shape, i, dtype), ((q, k, v), kw) in fa.items():
        o = fa_ops.attention(q, k, v, **kw)
        r = over_bound(torch, o, fa_ref.attention_ref(q, k, v, **kw),
                       OPS_TOL["flash_attention"])
        if r > 1 or not bool(torch.isfinite(o).all()):
            raise AssertionError(f"flash_attention {shape} {kw} {dtype}: "
                                 f"{r:.3g} x the bound")
        if dtype == torch.float32:
            if not torch.equal(fa_ops.attention(q, k, v, **kw), o):
                raise AssertionError(f"flash_attention {shape} {kw} {dtype}: a "
                                     f"second call gave other bits")
            n_again += 1
        worst[("flash_attention", dtype)] = max(
            worst.get(("flash_attention", dtype), 0.0), r)
    torch.cuda.synchronize()
    log(f"op kernels vs plain on {n_rms} rmsnorm and {len(fa)} flash "
        f"cases ({n_again} fp32 ones the same bits on a second call): "
        f"largest share of the bound "
        + ", ".join(f"{n} {str(d).split('.')[-1]} {r:.3g}"
                    for (n, d), r in worst.items()))


def ops_cases(torch, seed=5):
    """The full-width inputs of the two ops, from a seed.  rmsnorm: x of
    gemma-2b's d_model at phase 9's batch, fp32 and bf16, of gemma2-27b's
    (4608: a block a row) in bf16, and a (33*7, 300) tail case; flash
    attention: gemma-2b prefill (B 8, S 512, H 8, K 1, hd 256, causal)
    and a gemma2-27b local layer (B 1, S 8192, H 32, K 16, hd 128,
    window 4096, softcap 50, q scaled so that the scores have std 2 and
    the softcap bends the largest), each in fp32 and bf16."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    f32, b16 = torch.float32, torch.bfloat16
    local = dict(causal=True, window=4096, softcap=50.0)
    return ops_inputs(
        torch, gen,
        {"gemma-2b fp32": ((TRAIN_ROWS, 2048), f32, f32),
         "gemma-2b bf16": ((TRAIN_ROWS, 2048), b16, f32),
         "gemma2-27b bf16": ((TRAIN_ROWS, 4608), b16, f32),
         "tail d=300 fp32": ((33 * 7, 300), f32, f32),
         "tail d=300 bf16": ((33 * 7, 300), b16, f32)},
        {"gemma-2b prefill fp32": ((8, 512, 8, 1, 256), dict(causal=True), f32, 1.0),
         "gemma-2b prefill bf16": ((8, 512, 8, 1, 256), dict(causal=True), b16, 1.0),
         "gemma2-27b local fp32": ((1, 8192, 32, 16, 128), local, f32, Q_SCALE_LOCAL),
         "gemma2-27b local bf16": ((1, 8192, 32, 16, 128), local, b16, Q_SCALE_LOCAL)})


def phase_ops_path(torch, kernels, rms_ops, fa_ops, cases):
    """This slice's path: ``kernels.rmsnorm.ops.rmsnorm`` and
    ``kernels.flash_attention.ops.attention`` called as a user calls them
    on every full-width case, with the launch counts set to 0 just before
    and read just after: one launch of its kernel per call, no other."""
    rms, fa = cases
    kernels.reset_launches()
    outs = {("rmsnorm", k): rms_ops.rmsnorm(x, s) for k, (x, s) in rms.items()}
    outs.update({("flash_attention", k): fa_ops.attention(*qkv, **kw)
                 for k, (qkv, kw) in fa.items()})
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    want = {k: 0 for k in launches}
    want.update(rmsnorm=len(rms), flash_attention=len(fa))
    if launches != want:
        raise AssertionError(f"op path launches {launches}, want {want}")
    for (name, case), o in outs.items():
        if not bool(torch.isfinite(o).all()):
            raise AssertionError(f"{name} {case}: output is not finite")
    log(f"op path: rmsnorm x{launches['rmsnorm']}, flash_attention "
        f"x{launches['flash_attention']} launches on {len(outs)} full-width "
        f"calls, outputs finite")
    return outs, launches


def phase_ops_check(torch, rms_ref, fa_ops, fa_ref, layers, cases, outs):
    """Each op's path output against its plain version and against the
    port's model function (``layers.rmsnorm``, ``layers._sdpa_seq``):
    fp32 within OPS_TOL, bf16 within one bf16 step of the value more
    (over_bound).  ``_sdpa_seq`` rounds the probabilities to bf16 before
    the PV product, which moves its bf16 output by up to 2^-9 max|v|
    more; that is added to its bound.  Then the window/softcap cases
    show that they can fail a wrong kernel: the plain version with the
    softcap dropped, or with the window edge moved by one key either
    way, must break the bound against the kernel's output.  A second call
    of the fp32 flash kernel must give the same bits."""
    rms, fa = cases
    errs = {"rmsnorm": {}, "flash_attention": {}}
    for (name, case), o in outs.items():
        tol = OPS_TOL[name]
        tol_model = tol
        if name == "rmsnorm":
            x, s = rms[case]
            plain = rms_ref.rmsnorm_ref(x, s)
            model = layers.rmsnorm(s, x)
        else:
            (q, k, v), kw = fa[case]
            plain = fa_ref.attention_ref(q, k, v, **kw)
            model = layers._sdpa_seq(q, k, v, kw["causal"], kw.get("window", 0),
                                     kw.get("softcap", 0.0), q.shape[-1] ** -0.5)
            if o.dtype == torch.bfloat16:
                tol_model = tol + 2.0 ** -9 * v.float().abs().max().item()
        e_plain = (o.float() - plain.float()).abs().max().item()
        e_model = (o.float() - model.float()).abs().max().item()
        r_plain = over_bound(torch, o, plain, tol)
        r_model = over_bound(torch, o, model, tol_model)
        log(f"{name} {case}: vs plain max abs err {e_plain:.3g}, {r_plain:.3g} of "
            f"the bound (bitwise {bool(torch.equal(o, plain))}: "
            f"{int((o != plain).sum())} of {o.numel()} elements differ); vs the "
            f"model's {'rmsnorm' if name == 'rmsnorm' else '_sdpa_seq'} "
            f"{e_model:.3g}, {r_model:.3g} of its bound; max |y| "
            f"{plain.float().abs().max().item():.3g}")
        if r_plain > 1 or r_model > 1:
            raise AssertionError(f"{name} {case}: {r_plain:.3g} / {r_model:.3g} "
                                 f"x the bound")
        errs[name][case] = e_plain
        del plain, model
        if name == "flash_attention" and o.dtype == torch.float32:
            if not torch.equal(fa_ops.attention(q, k, v, **kw), o):
                raise AssertionError(f"{case}: a second call gave other bits")
            log(f"  {case}: a second call gave the same bits")
        if name == "flash_attention" and "softcap" in kw:
            faults = {"no softcap": dict(kw, softcap=0.0),
                      "window + 1": dict(kw, window=kw["window"] + 1),
                      "window - 1": dict(kw, window=kw["window"] - 1)}
            shares = {}
            for fault, kw_bad in faults.items():
                shares[fault] = over_bound(
                    torch, o, fa_ref.attention_ref(q, k, v, **kw_bad), tol)
                if shares[fault] <= 1:
                    raise AssertionError(f"{case}: the plain version with "
                                         f"{fault} passes against the kernel")
            log(f"  {case}: a kernel with a fault would fail: the plain version "
                f"with " + ", ".join(f"{f} is {r:.3g}" for f, r in shares.items())
                + " x the bound from the kernel's output")
    torch.cuda.empty_cache()
    return errs


def visible_pairs(S, causal, window):
    """(query, key) pairs the mask lets through, per (batch, head)."""
    total = 0
    for i in range(S):
        lo = max(0, i - window + 1) if window > 0 else 0
        hi = i if causal else S - 1
        total += hi - lo + 1
    return total


def kernel_resources(lib):
    """{demangled kernel: {"registers", "spill_bytes", "HGMMA", "HMMA"}}
    of a built library: registers and spill stores from its ``ptxas -v``
    lines, the tensor-core instructions counted in ``cuobjdump -sass``
    (None where the toolkit lacks it)."""
    from repro_torch.kernels import build
    res, name = {}, None
    for line in lib.ptxas:
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            res[name] = {"registers": 0, "spill_bytes": 0, "HGMMA": None, "HMMA": None}
        elif name and (m := re.search(r"(\d+) bytes spill stores", line)):
            res[name]["spill_bytes"] = int(m.group(1))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            res[name]["registers"] = int(m.group(1))
    tools = Path(build.nvcc()).parent
    if (tools / "cuobjdump").exists():
        sass = subprocess.run([str(tools / "cuobjdump"), "-sass", str(lib.path)],
                              capture_output=True, text=True, timeout=300).stdout
        for chunk in sass.split("Function : ")[1:]:
            fn = chunk.split()[0]
            if fn in res:
                res[fn]["HGMMA"] = len(re.findall(r"\bHGMMA\b", chunk))
                res[fn]["HMMA"] = len(re.findall(r"\bHMMA\b", chunk))
    filt = next((str(f) for f in (tools / "cu++filt", shutil.which("c++filt"))
                 if f and Path(f).exists()), None)
    if filt and res:
        names = subprocess.run([filt], input="\n".join(res), capture_output=True,
                               text=True, timeout=60).stdout.split("\n")
        if len(names) >= len(res):
            res = dict(zip(names, res.values()))
    return res


def flash_resources(resources, kind, hd):
    """The entries of ``kernel_resources`` for a flash kernel at head dim
    hd: the one whose name says ``kind`` (``bf16`` or ``tf32``, the fp32
    kernel) and whose first template argument is hd (``<hd,``, ``<hd>``
    or with ``(int)`` demangled, ``ILi<hd>E`` mangled)."""
    return {k: r for k, r in resources.items()
            if f"{kind}_kernel" in k and re.search(rf"(<|ILi)(\(int\))?{hd}(,|>|E)", k)}


def phase_ops_timing(torch, rms_ops, rms_ref, fa_ops, fa_ref, cases, errs,
                     launches, n=20):
    """Kernel, plain and library times of each full-width case (L2 flushed
    and the host's enqueue kept out of the window, see ``time_kernel``),
    against the bound worked out from its shapes, the operations at the
    card's peak for the inputs' type (rmsnorm fp32 on CUDA cores; flash
    attention bf16 on tensor cores, fp32 as three TF32 products on
    tensor cores, the CUDA-core bound logged beside it).  Each flash case
    also logs its rate, its time over SDPA's (and a bf16 case over the
    fp32 kernel's) from this call, and its kernel's registers, spills and
    tensor-core instructions.  The kernels line carries
    gemma-2b's bf16 rmsnorm and bf16 prefill, SDPA's time as the
    latter's library call."""
    import torch.nn.functional as F
    rms, fa = cases
    rows = {}
    for case, (x, s) in rms.items():
        nbytes = 2 * x.numel() * x.element_size() + s.numel() * s.element_size()
        flops = 4 * x.numel()          # square, sum, two products
        ms, enq = time_kernel(torch, lambda: rms_ops.rmsnorm(x, s), n)
        plain_ms = time_calls(torch, lambda: rms_ref.rmsnorm_ref(x, s), n)
        w = s.to(x.dtype)
        lib = lambda: F.rms_norm(x, (x.shape[-1],), weight=w, eps=1e-6)  # noqa: E731
        lib_err = (lib().float() - rms_ref.rmsnorm_ref(x, s).float()).abs().max().item()
        lib_ms = time_calls(torch, lib, n)
        ms2 = time_calls(torch, lambda: rms_ops.rmsnorm(x, s), n)
        row = kernel_row("rmsnorm", RMS_SOURCE, errs["rmsnorm"][case], ms,
                         plain_ms, nbytes, flops, lib_ms, enqueue_ms=enq)
        log(f"rmsnorm {case} {tuple(x.shape)}: kernel {ms:.4f} / {ms2:.4f} ms "
            f"(host enqueue {enq:.4f} ms), plain {plain_ms:.4f} ms, F.rms_norm "
            f"{lib_ms:.4f} ms (scale in x's dtype; max abs err vs plain "
            f"{lib_err:.3g}), bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
            f"({nbytes:,} bytes), {100 * row['bound_ms'] / ms:.1f} % of it")
        rows[case] = row
    resources = kernel_resources(fa_ops.library())
    for hd in fa_ops.HEAD_DIMS:            # every fp32 variant: tensor cores, no spill
        found = flash_resources(resources, "tf32", hd)
        if len(found) != 1:
            raise AssertionError(f"fp32 flash kernel at hd {hd}: {list(found)} in "
                                 f"{list(resources)}")
        for name, r in found.items():
            log(f"fp32 flash kernel {name}: {r['registers']} registers, "
                f"{r['spill_bytes']} bytes spilled, SASS HGMMA {r['HGMMA']} HMMA "
                f"{r['HMMA']}")
            if r["spill_bytes"] or (r["HMMA"] is not None and not (r["HMMA"] or r["HGMMA"])):
                raise AssertionError(f"fp32 flash kernel {name}: spills or runs off "
                                     f"the tensor cores: {r}")
    for case, ((q, k, v), kw) in fa.items():
        B, S, H, hd = q.shape
        pairs = visible_pairs(S, kw["causal"], kw.get("window", 0))
        flops = 4 * hd * pairs * B * H         # QK^T and PV, 2 flops an FMA
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        ms, enq = time_kernel(torch, lambda: fa_ops.attention(q, k, v, **kw), n)
        plain_ms = time_calls(torch, lambda: fa_ref.attention_ref(q, k, v, **kw),
                              max(3, n // 4))
        lib_ms, lib_note = None, "no single PyTorch call has softcap"
        if "window" not in kw and "softcap" not in kw:
            qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qh, kh, vh, is_causal=True, enable_gqa=True)
            lib_err = (lib().transpose(1, 2).float()
                       - fa_ref.attention_ref(q, k, v, **kw).float()).abs().max().item()
            lib_ms = time_calls(torch, lib, n)
            lib_note = (f"SDPA(is_causal, enable_gqa) {lib_ms:.4f} ms (max abs "
                        f"err vs plain {lib_err:.3g})")
            del qh, kh, vh
        ms2 = time_calls(torch, lambda: fa_ops.attention(q, k, v, **kw), n)
        bf16 = q.dtype == torch.bfloat16
        work, rate, peak = (flops, BF16_FLOPS, "bf16 tensor-core") if bf16 else (
            TF32_PRODUCTS * flops, TF32_FLOPS,
            f"TF32 tensor-core peak, x{TF32_PRODUCTS} for 3xTF32; on CUDA cores "
            f"{flops / FP32_FLOPS * 1e3:.4f} ms at the fp32")
        row = kernel_row("flash_attention", FA_SOURCE, errs["flash_attention"][case],
                         ms, plain_ms, nbytes, work, lib_ms, rate, enqueue_ms=enq)
        log(f"flash_attention {case} {kw}: kernel {ms:.4f} / {ms2:.4f} ms (host "
            f"enqueue {enq:.4f} ms), plain {plain_ms:.4f} ms, {lib_note}; bound "
            f"{row['bound_ms']:.4f} ms by {row['bound_by']} ({flops:,} flops over "
            f"{pairs:,} visible pairs a head at the {peak} peak, {nbytes:,} "
            f"bytes), {100 * row['bound_ms'] / ms:.1f} % of it; "
            f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
        vs_lib = f"{ms / lib_ms:.3g}x SDPA's time" if lib_ms else "no SDPA"
        vs_fp32 = ""
        if bf16:
            fp32 = rows[case.replace("bf16", "fp32")]["ms"]
            vs_fp32 = f"{ms / fp32:.3g}x the fp32 kernel's time ({fp32:.4f} ms), "
        log(f"  {case}: {flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, {vs_fp32}{vs_lib}; "
            f"kernel "
            + "; ".join(f"{k}: {r['registers']} registers, {r['spill_bytes']} "
                        f"bytes spilled, SASS HGMMA {r['HGMMA']} HMMA {r['HMMA']}"
                        for k, r in flash_resources(resources, "bf16" if bf16 else "tf32",
                                                    hd).items()))
        rows[case] = row
        torch.cuda.empty_cache()
    picked = {"rmsnorm": rows["gemma-2b bf16"],
              "flash_attention": rows["gemma-2b prefill bf16"]}
    for name, row in picked.items():
        row["launches"] = launches[name]
    return picked


# ---------------------------------------------------------------------------
# phase 23: the DeepSeek-V2 family (MLA attention, capacity-dispatched MoE)
# ---------------------------------------------------------------------------

MOE_ARCH = "deepseek-v2-lite-16b"
MOE_SLOTS, MOE_REQUESTS, MOE_MAX_NEW = 8, 8, 32
MOE_TOKENS = 4096                    # 23c: one MoE layer's tokens (8 x 512)
MOE_REL = 5e-5                       # 23c: dispatch vs moe_ref, fp32, of max
MOE_TRAIN_LAYERS = 4                 # 23d: 1 dense prefix + 3 MoE layers


def moe_traffic(vocab: int):
    """23a's prompts: MOE_REQUESTS lengths drawn in [PROMPT_LO, PROMPT_HI]."""
    rng = np.random.RandomState(23)
    return [rng.randint(0, vocab, int(n)).astype(np.int32)
            for n in rng.randint(PROMPT_LO, PROMPT_HI + 1, MOE_REQUESTS)]


def moe_serve_paged(torch, kernels, serve_mod, cfg, params, rt, prompts, card,
                    label, tag="23a"):
    """The prompts on the paged engine (the scheduler, all queued at once,
    a pool for every slot at full context), the launch counts set to 0
    just before and read just after: no kernel of the table may launch.
    Returns {rid: tokens}."""
    sched = serve_mod.build_scheduler(cfg, params, rt, slots=MOE_SLOTS,
                                      block_size=BLOCK_SIZE, blocks=0,
                                      ctx=PROMPT_HI + MOE_MAX_NEW,
                                      decode_chunk=DECODE_CHUNK)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    finished = serve_mod.serve(sched, prompts, MOE_MAX_NEW)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = kernels.launch_counts()
    st = sched.stats
    lats = [r.t_done - r.t_submit for r in finished]
    tokens = sum(len(r.out) for r in finished)
    log(f"[{card}] {tag} paged, {label}: {len(finished)} requests (prompts "
        f"{min(map(len, prompts))}-{max(map(len, prompts))}), {tokens} tokens "
        f"in {dt:.2f} s: {tokens / dt:.1f} tok/s; latency p50 "
        f"{np.percentile(lats, 50):.3f} s p99 {np.percentile(lats, 99):.3f} s; "
        f"{st['decode_steps']} decode steps, "
        f"{st['decode_s'] / st['decode_steps'] * 1e3:.2f} ms a decode step; "
        f"prefill {st['prefill_s']:.3f} s in {st['prefill_calls']} calls "
        f"({len(st['prefill_shapes'])} shapes); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"paged_decode_attention launches {launches['paged_decode_attention']}")
    if any(launches.values()):
        raise AssertionError(f"{tag} paged: kernels launched: {launches}")
    sched.alloc.check()
    if sched.alloc.used_blocks:
        raise AssertionError(f"{tag}: {sched.alloc.used_blocks} blocks leaked")
    return moe_tokens(cfg, "paged", finished, tag), st


def moe_serve_dense(torch, kernels, serve_mod, cfg, params, rt, prompts, card,
                    label, tag="23a"):
    """The prompts on the dense engine (the launcher's ContinuousBatcher
    and ``serve_dense``), counts as ``moe_serve_paged``."""
    batcher = serve_mod.ContinuousBatcher(cfg, params, MOE_SLOTS,
                                          PROMPT_HI + MOE_MAX_NEW, rt=rt)
    steps = []
    decode_step = batcher.decode_step

    def timed_step():
        t = time.perf_counter()
        out = decode_step()                      # ends in a host sync
        steps.append(time.perf_counter() - t)
        return out
    batcher.decode_step = timed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    finished = serve_mod.serve_dense(batcher, prompts, MOE_MAX_NEW)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = kernels.launch_counts()
    lats = [r.t_done - r.t_submit for r in finished]
    tokens = sum(len(r.out) for r in finished)
    ms = np.array(steps) * 1e3
    log(f"[{card}] {tag} dense, {label}: {len(finished)} requests, {tokens} tokens "
        f"in {dt:.2f} s: {tokens / dt:.1f} tok/s; latency p50 "
        f"{np.percentile(lats, 50):.3f} s p99 {np.percentile(lats, 99):.3f} s; "
        f"{len(steps)} decode steps, {np.median(ms):.2f} ms median "
        f"({ms.min():.2f}-{ms.max():.2f}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"paged_decode_attention launches {launches['paged_decode_attention']}")
    if any(launches.values()):
        raise AssertionError(f"{tag} dense: kernels launched: {launches}")
    return moe_tokens(cfg, "dense", finished, tag)


def moe_tokens(cfg, what, finished, tag):
    if sorted(r.rid for r in finished) != list(range(MOE_REQUESTS)) or any(
            len(r.out) != MOE_MAX_NEW or not all(0 <= t < cfg.vocab_size
                                                 for t in r.out)
            for r in finished):
        raise AssertionError(f"{tag} {what}: a request is missing, short or out "
                             f"of the vocabulary")
    return {r.rid: list(r.out) for r in finished}


def moe_agreement(want, got, card, label, tag="23a"):
    """Dense against paged greedy tokens: (requests equal, first tokens
    equal, tokens equal), logged."""
    same = sum(want[rid] == got[rid] for rid in want)
    first = sum(want[rid][0] == got[rid][0] for rid in want)
    agree = sum(a == b for rid in want for a, b in zip(want[rid], got[rid]))
    log(f"[{card}] {tag} dense vs paged greedy tokens, {label}: {same}/"
        f"{MOE_REQUESTS} requests equal, first tokens {first}/{MOE_REQUESTS}, "
        f"tokens {agree}/{MOE_REQUESTS * MOE_MAX_NEW}")
    return same, first, agree


def moe_profile_decode(torch, serve_mod, cfg, params, rt, prompts, card,
                       tag="23a"):
    """One paged decode chunk (DECODE_CHUNK steps) of 23a's requests under
    torch.profiler, after their prefill: the device's busy share and the
    kernels that take the most of it."""
    from torch.profiler import ProfilerActivity, profile
    sched = serve_mod.build_scheduler(cfg, params, rt, slots=MOE_SLOTS,
                                      block_size=BLOCK_SIZE, blocks=0,
                                      ctx=PROMPT_HI + MOE_MAX_NEW,
                                      decode_chunk=DECODE_CHUNK)
    for i, p in enumerate(prompts):
        sched.submit(serve_mod.ServeRequest(rid=i, prompt=p, max_new=MOE_MAX_NEW))
    sched.admit()
    sched.decode()                                   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched.decode()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    log_profile(prof, wall_ms, f"[{card}] {tag} profiled paged decode chunk "
                f"({DECODE_CHUNK} steps)", prefix=f"[{card}] {tag}")
    sched.run()


def moe_prefill_noise(torch, serving, cfg, params, rt, prompts, card):
    """23a, a reading: each prompt's last-position logits from a prefill
    of the prompt alone (the dense engine's) against its row of one
    prefill of all prompts right-padded to one length (the paged
    engine's, ``last_pos``), where nothing drops; beside them, the
    alone prefill against itself with one weight leaf scaled by one bf16
    step (the stack's own sensitivity to a rounding)."""
    prefill = serving.make_prefill_step(cfg, rt)
    S = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    last = torch.tensor([len(p) - 1 for p in prompts], device=rt.device)
    group, _ = prefill(params, torch.from_numpy(toks).to(rt.device), last_pos=last)
    leaf = "blocks.L0.attn.wo"
    nudged = dict(params, **{leaf: (params[leaf].float() * (1 + 2**-7))
                             .to(params[leaf].dtype)})
    rel = {"group": 0.0, "nudge": 0.0}
    same = {"group": 0, "nudge": 0}
    for i, p in enumerate(prompts):
        t = torch.from_numpy(p[None]).to(rt.device)
        alone = prefill(params, t)[0][0, -1]
        for k, other in (("group", group[i, -1]), ("nudge", prefill(nudged, t)[0][0, -1])):
            rel[k] = max(rel[k], ((other - alone).abs().max() / alone.abs().max()).item())
            same[k] += int(torch.argmax(other) == torch.argmax(alone))
    log(f"[{card}] 23a prefill alone vs in a padded batch (capacity factor "
        f"{cfg.moe.capacity_factor}, nothing drops): worst {rel['group']:.3g} of "
        f"max|logits|, argmax equal {same['group']}/{len(prompts)}; {leaf} "
        f"scaled by one bf16 step: {rel['nudge']:.3g}, argmax equal "
        f"{same['nudge']}/{len(prompts)} (a reading)")
    return rel


# 23a: the dense engine teacher-forced on the paged engine's tokens; each
# paged token's regret under the dense engine's logits, (top logit - its
# logit) / max|logits|, must stay below this.  A token the dense engine
# would not consider sits near the logits' mean, a regret near 1; the two
# engines' own difference (a prefill alone or in a padded batch, 0.188 of
# max|logits| on the card, as large as one weight leaf moved by one bf16
# step, 0.101) allows at most twice that.
MOE_REGRET = 0.5


def moe_teacher_forced(torch, serve_mod, cfg, params, rt, prompts, paged, card,
                       label, tag="23a"):
    """23a: the dense engine (the ContinuousBatcher: each prompt prefilled
    alone and spliced into its slot) decoding the paged engine's tokens:
    the regret of each paged token under the dense logits, at most
    MOE_REGRET; how often the two engines' argmax agree, logged."""
    b = serve_mod.ContinuousBatcher(cfg, params, MOE_SLOTS,
                                    PROMPT_HI + MOE_MAX_NEW, rt=rt)
    for i, p in enumerate(prompts):
        b._admit(serve_mod.Request(i, torch.from_numpy(p[None]).to(rt.device),
                                   MOE_MAX_NEW), i)
    worst, agree = 0.0, 0
    for t in range(MOE_MAX_NEW - 1):
        feed = torch.tensor([[paged[i][t]] for i in range(MOE_SLOTS)],
                            dtype=torch.int32, device=rt.device)
        want = torch.tensor([paged[i][t + 1] for i in range(MOE_SLOTS)],
                            device=rt.device)
        nxt, logits, b.cache = b.step(params, b.cache, feed, b.pos)
        b.pos = b.pos + 1
        regret = ((logits.max(-1).values - logits.gather(1, want[:, None])[:, 0])
                  / logits.abs().max(-1).values)
        worst = max(worst, regret.max().item())
        agree += int((nxt == want).sum())
    log(f"[{card}] {tag} dense engine teacher-forced on the paged tokens "
        f"({label}): worst regret of a "
        f"paged token {worst:.3g} of max|logits| (bound {MOE_REGRET}); argmax "
        f"equal {agree}/{MOE_SLOTS * (MOE_MAX_NEW - 1)}")
    if worst > MOE_REGRET:
        raise AssertionError(f"{tag}: a paged token sits {worst:.3g} of "
                             f"max|logits| below the dense engine's top")
    return worst


def phase_moe_serve(torch, kernels, serve_mod, cfg, rt, card):
    """23a: deepseek-v2-lite-16b at full width and depth, bf16, on the
    paged engine and then the dense one, each with the launch counts set
    to 0 just before and read just after: no kernel of the table
    launches (MLA decode gathers its latent pools in plain PyTorch, as
    the reference does).  The engines' greedy tokens are compared at the
    config's capacity factor, where they compute other functions (MoE
    capacity counts the batch: a prompt prefilled alone and the same
    prompt in a padded bucket drop other assignments, and a decode step's
    drops depend on every row), and at capacity factor 16, where nothing
    drops and the two run the same arithmetic on other batch shapes."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, n_params = serve_mod.load_model(cfg, rt, seed=0)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    w_gib = torch.cuda.memory_allocated() / 2**30
    log(f"[{card}] 23a {cfg.name}: {n_params:,} params drawn on the card from "
        f"PRNGKey(0), each matmul leaf cast to {cfg.compute_dtype} as it is "
        f"drawn, in {t_load:.2f} s; {w_gib:.2f} GiB resident, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB while drawing")
    prompts = moe_traffic(cfg.vocab_size)
    label = f"capacity factor {cfg.moe.capacity_factor}"
    paged, _ = moe_serve_paged(torch, kernels, serve_mod, cfg, params, rt,
                               prompts, card, label)
    moe_profile_decode(torch, serve_mod, cfg, params, rt, prompts, card)
    dense = moe_serve_dense(torch, kernels, serve_mod, cfg, params, rt, prompts,
                            card, label)
    agree = {"config": moe_agreement(paged, dense, card, label)}
    moe_teacher_forced(torch, serve_mod, cfg, params, rt, prompts, paged, card,
                       label)
    nodrop = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=16.0))
    label = "capacity factor 16 (nothing drops)"
    paged, _ = moe_serve_paged(torch, kernels, serve_mod, nodrop, params, rt,
                               prompts, card, label)
    dense = moe_serve_dense(torch, kernels, serve_mod, nodrop, params, rt,
                            prompts, card, label)
    agree["nodrop"] = moe_agreement(paged, dense, card, label)
    from repro_torch import serving
    moe_prefill_noise(torch, serving, nodrop, params, rt, prompts, card)
    return params, agree


def phase_moe_dense_paged(torch, kernels, serve_mod, serving, cfg, rt, card,
                          steps=4, prompts=None, tag="23b", strict=False):
    """23b: at full width and 2 layers (the dense prefix layer and one MoE
    layer), one prefill of 8 prompts feeds both the dense ring (padded to
    the pools' gathered length) and the latent pools; ``steps`` decode
    steps teacher-forced on the dense engine's tokens: bitwise in fp32
    (the same ops on the same shapes), bf16 logged (``strict``: bitwise
    in bf16 too)."""
    from repro_torch.serving import paged_cache as pc
    c = dataclasses.replace(cfg, n_layers=2)
    params, _ = serve_mod.load_model(c, rt, seed=0)
    prompts = moe_traffic(c.vocab_size) if prompts is None else prompts
    S = max(len(p) for p in prompts)
    toks = np.zeros((MOE_SLOTS, S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    last = np.array([len(p) - 1 for p in prompts], np.int32)
    logits, prefilled = serving.make_prefill_step(c, rt)(
        params, torch.from_numpy(toks).to(rt.device),
        last_pos=torch.from_numpy(last).to(rt.device))
    nbmax = pc.n_blocks_for(S + steps, BLOCK_SIZE)
    paged = pc.paged_cache_init(c, MOE_SLOTS, BLOCK_SIZE, 1 + MOE_SLOTS * nbmax,
                                nbmax, rt.device)
    for row in range(MOE_SLOTS):
        ids = list(range(1 + row * nbmax, 1 + (row + 1) * nbmax))[::-1]
        pc.set_block_table(paged, row, ids)
        pc.splice_prefill(paged, prefilled, row, row, ids)
    dense = serving.pad_cache(prefilled, nbmax * BLOCK_SIZE - S)
    del prefilled
    step = serving.make_serve_step(c, rt)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    pos = torch.from_numpy(last + 1).to(rt.device)
    kernels.reset_launches()
    worst, bitwise, agree = 0.0, True, 0
    for i in range(steps):
        nd, ld, dense = step(params, dense, tok, pos)
        npg, lp, paged = step(params, paged, tok, pos)
        if not bool(torch.isfinite(ld).all()):
            raise AssertionError(f"{tag}: dense logits are not finite")
        bitwise &= bool(torch.equal(ld, lp))
        worst = max(worst, ((ld - lp).abs().max() / ld.abs().max()).item())
        agree += int((nd == npg).sum())
        tok, pos = nd[:, None], pos + 1
    launches = kernels.launch_counts()
    log(f"[{card}] {tag} ({c.compute_dtype}, {c.n_layers} layers, context "
        f"{nbmax * BLOCK_SIZE}): dense vs paged cache over {steps} "
        f"steps: {'bitwise' if bitwise else 'not bitwise'}, worst "
        f"{worst:.3g} of max|logits|; greedy tokens agree "
        f"{agree}/{steps * MOE_SLOTS}; kernel launches {sum(launches.values())}")
    if any(launches.values()):
        raise AssertionError(f"{tag}: kernels launched: {launches}")
    if (c.compute_dtype == "float32" or strict) and not bitwise:
        raise AssertionError(f"{tag}: dense and paged differ in "
                             f"{c.compute_dtype} by {worst:.3g}")
    return bitwise, worst


def phase_moe_layer(torch, cfg, card):
    """23c: one full-width MoE layer (64 experts, top-6, 2 shared) on
    MOE_TOKENS tokens, fp32: capacity dispatch with nothing dropped
    (factor 16) against the dense oracle ``moe_ref`` within MOE_REL of
    the max; then at capacity factor 1.0 on inputs whose router logits
    are exact in fp32 (x and the router in {-1, 0, 1}, the router times
    2^-8, so the card and the CPU sum them to the same bits; tied
    experts in many rows): the card's ids,
    capacity positions and keep mask equal the CPU port's.  Times of the
    layer (bf16, the config's capacity) and of ``moe_ref`` are readings."""
    from repro_torch import prng
    from repro_torch.models import materialize, moe
    dev = torch.device("cuda")
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    p = materialize(moe.moe_defs(c32), prng.PRNGKey(3), dev)
    x = torch.randn((8, MOE_TOKENS // 8, c32.d_model), generator=torch.Generator(
        device=dev).manual_seed(3), device=dev)
    nodrop = dataclasses.replace(c32, moe=dataclasses.replace(c32.moe,
                                                              capacity_factor=16.0))
    y, aux = moe.moe_apply(p, x, nodrop)
    yr, auxr = moe.moe_ref(p, x, nodrop)
    err = ((y - yr).abs().max() / yr.abs().max()).item()
    _, _, _, _, keep, cap = moe.dispatch_plan(p["router"], x.reshape(-1, c32.d_model),
                                              nodrop)
    log(f"[{card}] 23c one MoE layer ({c32.moe.n_experts} experts, top-"
        f"{c32.moe.top_k}, {c32.moe.n_shared} shared, {MOE_TOKENS} tokens, "
        f"fp32): dispatch (capacity {cap}, {int((~keep).sum())} dropped) vs "
        f"moe_ref {err:.3g} of max|y| (bound {MOE_REL}); aux {aux.item():.6g} "
        f"vs {auxr.item():.6g}")
    if err > MOE_REL or not bool(keep.all()) or aux.item() != auxr.item():
        raise AssertionError(f"23c: dispatch vs moe_ref {err:.3g}")
    del y, yr
    one = dataclasses.replace(c32, moe=dataclasses.replace(c32.moe,
                                                           capacity_factor=1.0))
    g = np.random.RandomState(5)
    xq = torch.from_numpy(g.randint(-1, 2, (MOE_TOKENS, c32.d_model))
                          .astype(np.float32))
    rq = torch.from_numpy(g.randint(-1, 2, (c32.d_model, c32.moe.n_experts))
                          .astype(np.float32) * 2.0**-8)
    card_plan = moe.dispatch_plan(rq.to(dev), xq.to(dev), one)
    cpu_plan = moe.dispatch_plan(rq, xq, one)
    ties = int((torch.sort(cpu_plan[0], dim=-1).values.diff(dim=-1) == 0).any(-1).sum())
    names = ("weights", "ids", "aux", "pos", "keep")
    diff = [n for n, a, b in zip(names, card_plan[:5], cpu_plan[:5])
            if n in ("ids", "pos", "keep") and not torch.equal(a.cpu(), b)]
    n_keep = int(cpu_plan[4].sum())
    log(f"[{card}] 23c capacity factor 1.0 (capacity {cpu_plan[5]}): the card "
        f"keeps {int(card_plan[4].sum())} and the CPU {n_keep} of "
        f"{cpu_plan[4].numel()} assignments; ids, positions, keep "
        f"{'equal' if not diff else 'differ in ' + ', '.join(diff)}; rows with "
        f"tied router weights {ties}")
    if diff or n_keep == cpu_plan[4].numel():
        raise AssertionError(f"23c: the card's plan differs in {diff} or "
                             f"nothing dropped")
    pb = {k: v.bfloat16() if v.dim() == 3 or k.startswith("shared.") else v
          for k, v in p.items()}
    xb = x.bfloat16()
    ms = time_calls(torch, lambda: moe.moe_apply(pb, xb, cfg), n=10)
    ref_ms = time_calls(torch, lambda: moe.moe_ref(pb, xb, cfg), n=5)
    log(f"[{card}] 23c one MoE layer at bf16, capacity factor "
        f"{cfg.moe.capacity_factor}: {ms:.3f} ms (moe_ref, every expert on every "
        f"token: {ref_ms:.3f} ms), a reading")
    return err, ms


def phase_moe_train(torch, kernels, train_mod, card, arch=MOE_ARCH,
                    n_layers=MOE_TRAIN_LAYERS, tag="23d"):
    """23d: deepseek-v2-lite-16b at full width, depth cut to 1 dense prefix
    layer + 3 MoE layers (``n_layers``; None keeps the arch's depth), SNGM
    on the engine through the launcher's own ``build``/``train`` (batch 8
    x 512 in 2 micro-batches, remat, wd 1e-4), 4 steps, the launch counts
    set to 0 just before and read just after: 1 chunk_sumsq + 1
    fused_update a step; aux_loss finite."""
    args = train_mod.parse_args(
        ["--arch", arch, "--steps", "4", "--batch", "8", "--seq", "512",
         "--n-micro", "2", "--weight-decay", "1e-4", "--log-every", "1",
         "--device", "cuda", "--seed", "0", "--optimizer", "sngm", "--fused",
         "multi_tensor"])
    t0 = time.perf_counter()
    with depth_cut(train_mod, n_layers):
        run = train_mod.build(args)
    torch.cuda.synchronize()
    log(f"[{card}] {tag} {run.cfg.name} at {run.cfg.n_layers} layers: "
        f"{run.n_params:,} fp32 params, built in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    state, mem = train_mod.train(args, run)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    recs = [m for _, m in mem.steps]
    want = {k: (args.steps if k in ("chunk_sumsq", "fused_update") else 0)
            for k in launches}
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, want {want}")
    if len(recs) != args.steps or not all(
            np.isfinite(m[k]) for m in recs
            for k in ("loss", "grad_norm", "lr", "aux_loss")):
        raise AssertionError(f"{tag}: missing or non-finite stats {recs}")
    steady = [m["step_time_s"] for m in recs[1:]]
    step_s = float(np.median(steady))
    losses = ", ".join(f"{m['loss']:.4f}" for m in recs)
    auxes = ", ".join(f"{m['aux_loss']:.6f}" for m in recs)
    log(f"[{card}] {tag} SNGM on the engine, 4 steps: losses {losses}; "
        f"aux_loss {auxes}; step 0 {recs[0]['step_time_s']:.3f} s, then "
        f"{', '.join(f'{s:.3f}' for s in steady)} s; median {step_s:.3f} s = "
        f"{args.batch * args.seq / step_s:.0f} tokens/s; peak device memory "
        f"{peak_gib:.2f} GiB; launches per step: chunk_sumsq "
        f"{launches['chunk_sumsq'] / args.steps:g}, fused_update "
        f"{launches['fused_update'] / args.steps:g}")
    del run, state, mem
    gc.collect()
    torch.cuda.empty_cache()
    return launches, step_s, peak_gib


def phase_moe_engine_vs_plain(torch, cfg, card, n_layers=2, steps=3,
                              tag="23d"):
    """23d: SNGM on the engine against ``fused=None`` from one state on one
    set of full-width gradients (a backward pass of the stack),
    ``steps`` steps: params, momentum and stats bitwise.  Depth cut to 2
    layers (the prefix layer and one MoE layer), as phase 10 does, to
    hold both states and the plain path's temporaries side by side."""
    from repro_torch import prng
    from repro_torch.core.optim import make_optimizer
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Runtime, materialize, model_defs
    from repro_torch.training.step import _grad_leaves, loss_fn
    dev = torch.device("cuda")
    c = dataclasses.replace(cfg, n_layers=n_layers)
    params = materialize(model_defs(c), prng.PRNGKey(1), dev)
    sched = {"name": "poly_power", "kwargs": {"lr0": 1.6, "total_steps": 4}}
    opts = [make_optimizer("sngm", sched, weight_decay=1e-4, fused=f, beta=0.9)
            for f in (None, "multi_tensor")]
    states = [opts[0].init_state({k: v.clone() for k, v in params.items()}),
              opts[1].init_state(params)]
    del params
    leaves, grads = _grad_leaves(opts[1].init_state(states[1].params_view))
    batch = SyntheticLM(c.vocab_size, 512, 2, seed=1, device=dev).batch_at(0)
    loss, metrics = loss_fn(leaves, batch, c, Runtime(dev, remat=True))
    loss.backward()
    del leaves
    for t in range(steps):
        outs = [o.step_state(g, s) for o, s, g in
                zip(opts, states, (grads.tree, grads))]
        states = [s for s, _ in outs]
        sa, sb = (st for _, st in outs)
        pa, pb = (s.params_view for s in states)
        same = (all(same_bits(torch, sa[k], sb[k]) for k in sa)
                and all(same_bits(torch, pa[k], pb[k]) for k in pa)
                and all(same_bits(torch, ua[k], ub[k])
                        for ua, ub in zip(*map(opt_slots, states)) for k in ua))
        if not same:
            raise AssertionError(f"{tag}: fused=None and the engine differ at "
                                 f"step {t}")
    log(f"[{card}] {tag} SNGM engine vs fused=None on one set of gradients "
        f"({c.n_layers} layers, loss {loss.item():.4f}, aux_loss "
        f"{metrics['aux_loss'].item():.6f}): bitwise over {steps} steps "
        f"(params, momentum, stats)")
    del states, outs, grads


def phase_moe(torch, kernels, serve_mod, train_mod, serving, card):
    """Phase 23, 23a-23d, each sub-phase's seconds logged."""
    from repro_torch.configs import get_config
    from repro_torch.models import make_runtime
    cfg = get_config(MOE_ARCH)
    rt = make_runtime("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params, agree = phase_moe_serve(torch, kernels, serve_mod, cfg, rt, card)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t_a = time.perf_counter()
    for dtype in ("float32", "bfloat16"):
        phase_moe_dense_paged(torch, kernels, serve_mod, serving,
                              dataclasses.replace(cfg, compute_dtype=dtype), rt,
                              card)
        gc.collect()
        torch.cuda.empty_cache()
    t_b = time.perf_counter()
    phase_moe_layer(torch, cfg, card)
    gc.collect()
    torch.cuda.empty_cache()
    t_c = time.perf_counter()
    phase_moe_train(torch, kernels, train_mod, card)
    phase_moe_engine_vs_plain(torch, cfg, card)
    gc.collect()
    torch.cuda.empty_cache()
    t_d = time.perf_counter()
    log(f"[{card}] phase 23: {t_d - t0:.1f} s (23a {t_a - t0:.1f} s, 23b "
        f"{t_b - t_a:.1f} s, 23c {t_c - t_b:.1f} s, 23d {t_d - t_c:.1f} s)")


# ---------------------------------------------------------------------------
# phase 24: the Mamba2 (SSD) family, a pure SSM stack
# ---------------------------------------------------------------------------

SSM_ARCH = "mamba2-1.3b"
SSM_PROMPT_24B = 200                 # 24b: 8 prompts of one length
SSM_PROMPT_24C = 300                 # 24c: not a multiple of the chunk (256)
SSM_TF_REL = 1e-2                    # 24c: decode vs teacher forcing, fp32
SSM_SSD = (4, 512)                   # 24d: B, S of ssd_chunked's check
SSM_SSD_REL = 1e-4                   # 24d: chunked vs recurrence, of max


class CardLines:
    """A stdout that leads every line lacking the card's name with it (the
    launchers' own ``[serve:...]`` and step lines), so that each line of a
    phase names the card it ran on."""

    def __init__(self, out, card):
        self.out, self.card, self.buf = out, card, ""

    def write(self, text):
        self.buf += text
        *lines, self.buf = self.buf.split("\n")
        for line in lines:
            if self.card not in line:
                line = f"[chip_smoke] [{self.card}] {line}"
            self.out.write(line + "\n")
        return len(text)

    def flush(self):
        self.out.flush()


def ssm_traffic(vocab: int):
    """24a's prompts: MOE_REQUESTS distinct lengths in [PROMPT_LO,
    PROMPT_HI] (the paged engine prefills each at its exact length)."""
    rng = np.random.RandomState(24)
    lengths = rng.choice(np.arange(PROMPT_LO, PROMPT_HI + 1), MOE_REQUESTS,
                         replace=False)
    return [rng.randint(0, vocab, int(n)).astype(np.int32) for n in lengths]


def phase_ssm_serve(torch, kernels, serve_mod, cfg, rt, card):
    """24a: mamba2-1.3b at full width and all 48 layers, bf16, its weights
    drawn on the card with each matmul leaf cast as it is drawn: the 8
    requests on the paged engine and then the dense one, each with the
    launch counts set to 0 just before and read just after (no attention
    layer: the paged kernel launches 0 times); every paged prefill at a
    prompt's exact length (an SSM scans through padding); the dense
    engine teacher-forced on the paged tokens within ``MOE_REGRET``; the
    engines' free-running greedy tokens compared, logged."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, n_params = serve_mod.load_model(cfg, rt, seed=0)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    log(f"[{card}] 24a {cfg.name}: {n_params:,} params drawn on the card from "
        f"PRNGKey(0), each matmul leaf cast to {cfg.compute_dtype} as it is "
        f"drawn, in {t_load:.2f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB while drawing")
    prompts = ssm_traffic(cfg.vocab_size)
    label = cfg.compute_dtype
    paged, st = moe_serve_paged(torch, kernels, serve_mod, cfg, params, rt,
                                prompts, card, label, tag="24a")
    shapes = sorted(st["prefill_shapes"])
    want = sorted((MOE_SLOTS, len(p)) for p in prompts)
    log(f"[{card}] 24a paged prefill shapes {shapes} (each a prompt's exact "
        f"length: {shapes == want})")
    if shapes != want:
        raise AssertionError(f"24a: prefill shapes {shapes}, want {want}")
    moe_profile_decode(torch, serve_mod, cfg, params, rt, prompts, card, tag="24a")
    dense = moe_serve_dense(torch, kernels, serve_mod, cfg, params, rt, prompts,
                            card, label, tag="24a")
    agree = moe_agreement(paged, dense, card, label, tag="24a")
    moe_teacher_forced(torch, serve_mod, cfg, params, rt, prompts, paged, card,
                       label, tag="24a")
    return agree


def phase_ssm_teacher(torch, serve_mod, serving, cfg, rt, card, steps=4):
    """24c: at full width and 2 layers, fp32: a prompt of SSM_PROMPT_24C
    tokens (not a multiple of the chunk, so the padded tail runs) and
    ``steps`` decode steps, each step's logits against a prefill of the
    prefix it completes, within SSM_TF_REL of the max logit; beside it,
    how far a one-ulp scale of one weight leaf moves the prefill (the
    random stack's own noise at this depth)."""
    c = dataclasses.replace(cfg, n_layers=2, compute_dtype="float32")
    params, _ = serve_mod.load_model(c, rt, seed=0)
    S = SSM_PROMPT_24C
    toks = torch.from_numpy(np.random.RandomState(25).randint(
        0, c.vocab_size, (1, S + steps)).astype(np.int32)).to(rt.device)
    prefill = serving.make_prefill_step(c, rt)
    step = serving.make_serve_step(c, rt)
    first, cache = prefill(params, toks[:, :S])
    cache = serving.pad_cache(cache, steps)
    worst = 0.0
    for i in range(steps):
        pos = torch.full((1,), S + i, dtype=torch.int32, device=rt.device)
        _, got, cache = step(params, cache, toks[:, S + i:S + i + 1], pos)
        ref = prefill(params, toks[:, :S + i + 1])[0][:, -1]
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("24c: decode logits are not finite")
        worst = max(worst, ((got - ref).abs().max() / ref.abs().max()).item())
    leaf = "blocks.L0.mamba.out_proj"
    nudged = dict(params, **{leaf: params[leaf] * (1 + 2**-23)})
    moved = prefill(nudged, toks[:, :S])[0]
    ulp = ((moved - first).abs().max() / first.abs().max()).item()
    log(f"[{card}] 24c ({c.n_layers} layers, fp32, prompt {S}, chunk "
        f"{c.ssm.chunk}): decode vs a teacher-forced prefill over {steps} "
        f"steps, worst {worst:.3g} of max|logits| (bound {SSM_TF_REL}); "
        f"{leaf} scaled by 1 + 2^-23 moves the prefill's logits by {ulp:.3g}")
    if worst > SSM_TF_REL:
        raise AssertionError(f"24c: decode differs from teacher forcing by "
                             f"{worst:.3g}")
    return worst, ulp


def naive_ssd(torch, x, dt, A, B_, C_):
    """``ssd_chunked``'s oracle (``tests/test_ssd.py``): the token-by-token
    recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = C_t h_t."""
    Bb, S, H, P = x.shape
    rep = H // B_.shape[2]
    Bh, Ch = B_.repeat_interleave(rep, 2), C_.repeat_interleave(rep, 2)
    h = torch.zeros((Bb, H, P, B_.shape[3]), device=x.device)
    ys = []
    for t in range(S):
        h = (h * torch.exp(dt[:, t] * A)[..., None, None]
             + torch.einsum("bhp,bhn->bhpn", x[:, t] * dt[:, t][..., None],
                            Bh[:, t]))
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    return torch.stack(ys, 1), h


def phase_ssm_ssd(torch, cfg, card):
    """24d: ``ssd_chunked`` at full-width dims (B, S = SSM_SSD, H 64, P 64,
    N 128, chunk 256, fp32) against the token-by-token recurrence within
    SSM_SSD_REL of max|y| and of max|h|; one ``mamba_block``'s time at
    that shape in bf16, a reading."""
    from repro_torch import prng
    from repro_torch.models import mamba, materialize
    from repro_torch.models.transformer import compute_cast
    dev = torch.device("cuda")
    s, d_in, H, P, N, G = mamba._dims(cfg)
    B, S = SSM_SSD
    g = torch.Generator(device=dev).manual_seed(24)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    x, Bm, Cm = rn(B, S, H, P), rn(B, S, G, N), rn(B, S, G, N)
    dt = torch.nn.functional.softplus(rn(B, S, H))
    A = -torch.exp(rn(H) * 0.5)
    y, h = mamba.ssd_chunked(x, dt, A, Bm, Cm, s.chunk)
    yr, hr = naive_ssd(torch, x, dt, A, Bm, Cm)
    err_y = ((y - yr).abs().max() / yr.abs().max()).item()
    err_h = ((h - hr).abs().max() / hr.abs().max()).item()
    del x, Bm, Cm, dt, y, h, yr, hr
    p = materialize(mamba.mamba_defs(cfg), prng.PRNGKey(24), dev,
                    cast=compute_cast(cfg))
    xb = rn(B, S, cfg.d_model).to(getattr(torch, cfg.compute_dtype))
    ms = time_calls(torch, lambda: mamba.mamba_block(p, xb, cfg,
                                                     build_cache=False), n=10)
    log(f"[{card}] 24d ssd_chunked (B {B}, S {S}, H {H}, P {P}, N {N}, chunk "
        f"{s.chunk}, fp32) vs the token-by-token recurrence: y {err_y:.3g}, "
        f"h {err_h:.3g} of max (bound {SSM_SSD_REL}); one mamba_block at "
        f"(B {B}, S {S}, d {cfg.d_model}) in {cfg.compute_dtype}: {ms:.3f} ms, "
        f"a reading")
    if max(err_y, err_h) > SSM_SSD_REL:
        raise AssertionError(f"24d: ssd_chunked vs the recurrence: y {err_y:.3g}, "
                             f"h {err_h:.3g}")
    return err_y, err_h, ms


def phase_ssm(torch, kernels, serve_mod, train_mod, serving, card):
    """Phase 24, 24a-24e, each sub-phase's seconds logged, every line
    printed led by the card's name and power limit."""
    from repro_torch.configs import get_config
    from repro_torch.models import make_runtime
    cfg = get_config(SSM_ARCH)
    rt = make_runtime("cuda")
    with contextlib.redirect_stdout(CardLines(sys.stdout, card)):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        phase_ssm_serve(torch, kernels, serve_mod, cfg, rt, card)
        gc.collect()
        torch.cuda.empty_cache()
        t_a = time.perf_counter()
        rng = np.random.RandomState(26)
        same_len = [rng.randint(0, cfg.vocab_size, SSM_PROMPT_24B)
                    .astype(np.int32) for _ in range(MOE_SLOTS)]
        for dtype in ("float32", "bfloat16"):
            phase_moe_dense_paged(torch, kernels, serve_mod, serving,
                                  dataclasses.replace(cfg, compute_dtype=dtype),
                                  rt, card, prompts=same_len, tag="24b",
                                  strict=True)
            gc.collect()
            torch.cuda.empty_cache()
        t_b = time.perf_counter()
        phase_ssm_teacher(torch, serve_mod, serving, cfg, rt, card)
        gc.collect()
        torch.cuda.empty_cache()
        t_c = time.perf_counter()
        phase_ssm_ssd(torch, cfg, card)
        gc.collect()
        torch.cuda.empty_cache()
        t_d = time.perf_counter()
        phase_moe_train(torch, kernels, train_mod, card, arch=SSM_ARCH,
                        n_layers=None, tag="24e")
        phase_moe_engine_vs_plain(torch, cfg, card, tag="24e")
        gc.collect()
        torch.cuda.empty_cache()
        t_e = time.perf_counter()
        log(f"[{card}] phase 24: {t_e - t0:.1f} s (24a {t_a - t0:.1f} s, 24b "
            f"{t_b - t_a:.1f} s, 24c {t_c - t_b:.1f} s, 24d {t_d - t_c:.1f} s, "
            f"24e {t_e - t_d:.1f} s)")


# ---------------------------------------------------------------------------
# phase 25: the jamba hybrid (Mamba2, GQA attention and top-2 MoE in a period)
# ---------------------------------------------------------------------------

HYBRID_ARCH = "jamba-1.5-large-398b"
HYBRID_PROMPT_25B = 200              # 25b: 8 prompts of one length
HYBRID_LONG = 4352                   # 25c: the long-context window 4096 + 256
HYBRID_TRAIN_STEPS = 3               # 25e


def hybrid_cuts(cfg):
    """The two configurations the card holds (the full model's 72 layers
    of 16 experts are 398 G params): serving, one period (8 layers, the
    attention layer L4) with 4 experts at every published width; and
    training, the same period at half width (d 4096, 32 heads of 128, 8
    kv heads, d_ff = d_expert 12288), since SNGM's bf16 params and
    gradients and fp32 momentum take 8 B a param."""
    serve = dataclasses.replace(cfg, n_layers=8, moe=dataclasses.replace(
        cfg.moe, n_experts=4))
    train = dataclasses.replace(serve, d_model=4096, n_heads=32, n_kv_heads=8,
                                d_ff=12288, moe=dataclasses.replace(
                                    serve.moe, d_expert=12288))
    return serve, train


def hybrid_traffic(vocab: int):
    """25a's prompts: MOE_REQUESTS distinct lengths in [PROMPT_LO,
    PROMPT_HI]; the SHARERS begin with one SHARED_PREFIX-token prefix (their
    lengths drawn past it), so copy-on-write shares the attention layer's
    pool blocks while each slot keeps its own SSM state."""
    rng = np.random.RandomState(25)
    long_ = rng.choice(np.arange(SHARED_PREFIX + 16, PROMPT_HI + 1),
                       len(SHARERS), replace=False)
    rest = [n for n in range(PROMPT_LO, PROMPT_HI + 1) if n not in long_]
    short = rng.choice(rest, MOE_REQUESTS - len(SHARERS), replace=False)
    prefix = rng.randint(0, vocab, SHARED_PREFIX)
    lengths = iter(short)
    shared = iter(long_)
    prompts = []
    for i in range(MOE_REQUESTS):
        if i in SHARERS:
            n = int(next(shared))
            p = np.concatenate([prefix, rng.randint(0, vocab, n - SHARED_PREFIX)])
        else:
            p = rng.randint(0, vocab, int(next(lengths)))
        prompts.append(p.astype(np.int32))
    return prompts


def hybrid_serve_paged(torch, kernels, serve_mod, cfg, params, rt, prompts, card,
                       label):
    """25a: the prompts on the paged engine, PER_ROUND arriving a round (so
    a sharer admitted after the first finds its prefix's blocks
    registered), the launch counts set to 0 just before and read just
    after: the paged kernel once a decode step (one attention layer),
    nothing else; every prefill at a prompt's exact length; prefix
    blocks shared.  Returns ({rid: tokens}, stats)."""
    sched = serve_mod.build_scheduler(cfg, params, rt, slots=MOE_SLOTS,
                                      block_size=BLOCK_SIZE, blocks=0,
                                      ctx=PROMPT_HI + MOE_MAX_NEW,
                                      decode_chunk=DECODE_CHUNK)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    finished = serve_mod.serve(sched, prompts, MOE_MAX_NEW, per_round=PER_ROUND)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = kernels.launch_counts()
    st = sched.stats
    lats = [r.t_done - r.t_submit for r in finished]
    tokens = sum(len(r.out) for r in finished)
    shapes = sorted(st["prefill_shapes"])
    n_attn = sum(s.mixer != "mamba" for s in layer_specs(cfg))
    log(f"[{card}] 25a paged, {label}: {len(finished)} requests (prompts "
        f"{min(map(len, prompts))}-{max(map(len, prompts))}, {PER_ROUND} "
        f"arrivals a round), {tokens} tokens in {dt:.2f} s: {tokens / dt:.1f} "
        f"tok/s; latency p50 {np.percentile(lats, 50):.3f} s p99 "
        f"{np.percentile(lats, 99):.3f} s; {st['decode_steps']} decode steps, "
        f"{st['decode_s'] / st['decode_steps'] * 1e3:.2f} ms a decode step; "
        f"prefill {st['prefill_s']:.3f} s in {st['prefill_calls']} calls, "
        f"shapes {shapes}; COW-shared blocks {st['cow_shared_blocks']}; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"paged_decode_attention launches {launches['paged_decode_attention']} "
        f"= {n_attn} attention layer x {st['decode_steps']} decode steps")
    want = dict.fromkeys(launches, 0)
    want["paged_decode_attention"] = n_attn * st["decode_steps"]
    if launches != want or not st["decode_steps"]:
        raise AssertionError(f"25a paged: launches {launches}, want {want}")
    if shapes != sorted((MOE_SLOTS, len(p)) for p in prompts):
        raise AssertionError(f"25a: prefill shapes {shapes} are not the prompts' "
                             f"exact lengths")
    if st["cow_shared_blocks"] < 1:
        raise AssertionError("25a: no prefix block was shared")
    sched.alloc.check()
    if sched.alloc.used_blocks:
        raise AssertionError(f"25a: {sched.alloc.used_blocks} blocks leaked")
    return moe_tokens(cfg, "paged", finished, "25a"), st


def layer_specs(cfg):
    from repro_torch.configs.base import layer_pattern
    prefix, period, n_periods = layer_pattern(cfg)
    return list(prefix) + list(period) * n_periods


def phase_hybrid_serve(torch, kernels, serve_mod, cfg, rt, card):
    """25a: the serving cut (one period, 4 experts, full widths), bf16,
    drawn on the card from PRNGKey(0): the 8 requests on the paged engine
    and then the dense one at the config's capacity factor, then both at
    capacity factor 16 (nothing drops), where the free-running greedy
    tokens are compared (logged) and the dense engine is teacher-forced
    on the paged tokens (each within MOE_REGRET of the dense top)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, n_params = serve_mod.load_model(cfg, rt, seed=0)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    log(f"[{card}] 25a {cfg.name} cut to one period ({cfg.n_layers} layers, "
        f"{cfg.moe.n_experts} experts, top-{cfg.moe.top_k}, d {cfg.d_model}): "
        f"{n_params:,} params stored {cfg.param_dtype}, drawn on the card from "
        f"PRNGKey(0) in {t_load:.2f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB while drawing")
    prompts = hybrid_traffic(cfg.vocab_size)
    profiled = False
    for c, label in ((cfg, f"capacity factor {cfg.moe.capacity_factor}"),
                     (dataclasses.replace(cfg, moe=dataclasses.replace(
                         cfg.moe, capacity_factor=16.0)),
                      "capacity factor 16 (nothing drops)")):
        paged, _ = hybrid_serve_paged(torch, kernels, serve_mod, c, params, rt,
                                      prompts, card, label)
        if not profiled:
            moe_profile_decode(torch, serve_mod, c, params, rt, prompts, card,
                               tag="25a")
            profiled = True
        dense = moe_serve_dense(torch, kernels, serve_mod, c, params, rt, prompts,
                                card, label, tag="25a")
        moe_agreement(paged, dense, card, label, tag="25a")
    moe_teacher_forced(torch, serve_mod, c, params, rt, prompts, paged, card,
                       label, tag="25a")


def attention_at_true_fan_in(params, cfg):
    """Scale the attention layer's stacked q, k and v projections, in
    place, from the reference init's std 1 to 1/sqrt(d_model), their
    true fan-in (2^-6 at d 4096: exact).  The reference reads a stacked
    4-dim leaf's fan-in from its layer axis (1 here), so its scores run
    to ~1e3 and the softmax is one-hot: an fp32 rounding of a score then
    moves the output by ~1e-2, far past row 9's absolute bounds, which
    were set for unit-scale inputs."""
    k = cfg.d_model ** -0.5
    for name, t in params.items():
        if name.rsplit(".", 1)[-1] in ("wq", "wk", "wv") and ".attn." in name:
            t.mul_(k)


def phase_hybrid_dense_paged(torch, kernels, serving, layers, ops, ref, cfg,
                             params, rt, card, steps=4):
    """25b: at the training cut's widths (the attention projections at
    their true fan-in, ``attention_at_true_fan_in``), one prefill of 8
    prompts of one length feeds the dense cache (padded to the pools' gathered length)
    and two paged caches; ``steps`` decode steps teacher-forced on the
    dense engine's tokens: the paged plain gather bitwise the dense
    engine; the kernel path's attention output, at each launch, within
    row 9's bounds of its plain version on the same inputs (TOL, and in
    bf16 also 2e-5 plus one bf16 step of the value); its logits logged."""
    from repro_torch.models import Runtime
    from repro_torch.serving import paged_cache as pc
    rng = np.random.RandomState(26)
    toks = rng.randint(0, cfg.vocab_size, (MOE_SLOTS, HYBRID_PROMPT_25B)).astype(np.int32)
    S = HYBRID_PROMPT_25B
    logits, prefilled = serving.make_prefill_step(cfg, rt)(
        params, torch.from_numpy(toks).to(rt.device))
    nbmax = pc.n_blocks_for(S + steps, BLOCK_SIZE)
    caches = []
    for _ in range(2):
        paged = pc.paged_cache_init(cfg, MOE_SLOTS, BLOCK_SIZE, 1 + MOE_SLOTS * nbmax,
                                    nbmax, rt.device)
        for row in range(MOE_SLOTS):
            ids = list(range(1 + row * nbmax, 1 + (row + 1) * nbmax))[::-1]
            pc.set_block_table(paged, row, ids)
            pc.splice_prefill(paged, prefilled, row, row, ids)
        caches.append(paged)
    dense = serving.pad_cache(prefilled, nbmax * BLOCK_SIZE - S)
    del prefilled
    step_d = serving.make_serve_step(cfg, rt)
    step_g = serving.make_serve_step(cfg, Runtime(rt.device, paged_kernel=False))
    step_k = serving.make_serve_step(cfg, Runtime(rt.device, paged_kernel=True))
    worst = {"kernel": 0.0, "over": 0.0, "logits": 0.0}
    kernel = layers.paged_attention

    def checked(q, kp, vp, bt, pos, **kw):
        o = kernel(q, kp, vp, bt, pos, **kw)
        r = ref(q, kp, vp, bt, pos, **kw)
        if not bool(torch.isfinite(o).all()):
            raise AssertionError("25b: kernel output is not finite")
        worst["kernel"] = max(worst["kernel"], (o.float() - r.float()).abs().max().item())
        worst["over"] = max(worst["over"], over_bound(torch, o, r, TOL["float32"])
                            if o.dtype == torch.bfloat16 else 0.0)
        return o
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    pos = torch.full((MOE_SLOTS,), S, dtype=torch.int32, device=rt.device)
    bitwise, agree = True, 0
    layers.paged_attention = checked
    kernels.reset_launches()
    try:
        for i in range(steps):
            nd, ld, dense = step_d(params, dense, tok, pos)
            _, lg, caches[0] = step_g(params, caches[0], tok, pos)
            nk, lk, caches[1] = step_k(params, caches[1], tok, pos)
            if not bool(torch.isfinite(ld).all()):
                raise AssertionError("25b: dense logits are not finite")
            bitwise &= bool(torch.equal(ld, lg))
            worst["logits"] = max(worst["logits"],
                                  ((lk - ld).abs().max() / ld.abs().max()).item())
            agree += int((nk == nd).sum())
            tok, pos = nd[:, None], pos + 1
    finally:
        layers.paged_attention = kernel
    launches = kernels.launch_counts()
    n_attn = sum(s.mixer != "mamba" for s in layer_specs(cfg))
    tol = TOL[cfg.compute_dtype]
    log(f"[{card}] 25b ({cfg.compute_dtype}, {cfg.n_layers} layers, d "
        f"{cfg.d_model}, context {nbmax * BLOCK_SIZE}): dense vs paged plain "
        f"gather over {steps} steps: {'bitwise' if bitwise else 'NOT bitwise'}; "
        f"the kernel's attention output vs its plain version on the same "
        f"inputs, worst {worst['kernel']:.3g} (bound {tol}"
        + (f"; {worst['over']:.3g} of 2e-5 + one bf16 step" if cfg.compute_dtype
           == "bfloat16" else "") +
        f"); kernel path vs dense logits {worst['logits']:.3g} of max|logits|, "
        f"greedy tokens agree {agree}/{steps * MOE_SLOTS} (readings); "
        f"paged_decode_attention launches {launches['paged_decode_attention']}")
    if not bitwise:
        raise AssertionError(f"25b: dense and paged plain gather differ in "
                             f"{cfg.compute_dtype}")
    if worst["kernel"] > tol or worst["over"] > 1:
        raise AssertionError(f"25b: the kernel's output is {worst} from plain")
    if launches["paged_decode_attention"] != n_attn * steps or sum(
            launches.values()) != n_attn * steps:
        raise AssertionError(f"25b: launches {launches}")


def phase_hybrid_teacher(torch, serving, cfg, params, rt, card, steps=4):
    """25c, fp32 at the training cut's widths, capacity factor 16 (a
    prefill of many tokens and a decode step of one then drop nothing
    alike): a prompt of SSM_PROMPT_24C tokens, ``steps`` decode steps
    within SSM_TF_REL of a teacher-forced prefill of each prefix, beside
    the one-ulp nudge; then ``for_long_context()``, which leaves the
    attention layer global as the reference's ``layer_pattern`` does (its
    hybrid branch never returns "attn_local"): a prompt of HYBRID_LONG
    tokens, past the window, whose cache must not rotate, ``steps``
    decode steps bitwise the same decode on the config without the
    window, and against teacher forcing a reading."""
    c = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                         capacity_factor=16.0))
    prefill = serving.make_prefill_step(c, rt)
    step = serving.make_serve_step(c, rt)
    S = SSM_PROMPT_24C
    toks = torch.from_numpy(np.random.RandomState(25).randint(
        0, c.vocab_size, (1, HYBRID_LONG + steps)).astype(np.int32)).to(rt.device)
    first, cache = prefill(params, toks[:, :S])
    cache = serving.pad_cache(cache, steps)
    worst = 0.0
    for i in range(steps):
        pos = torch.full((1,), S + i, dtype=torch.int32, device=rt.device)
        _, got, cache = step(params, cache, toks[:, S + i:S + i + 1], pos)
        want = prefill(params, toks[:, :S + i + 1])[0][:, -1]
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("25c: decode logits are not finite")
        worst = max(worst, ((got - want).abs().max() / want.abs().max()).item())
    leaf = "blocks.L0.mamba.out_proj"
    nudged = dict(params, **{leaf: params[leaf] * (1 + 2**-23)})
    ulp = ((prefill(nudged, toks[:, :S])[0] - first).abs().max()
           / first.abs().max()).item()
    del nudged
    log(f"[{card}] 25c ({c.n_layers} layers, d {c.d_model}, fp32, capacity "
        f"factor 16, prompt {S}, chunk {c.ssm.chunk}): decode vs a "
        f"teacher-forced prefill over {steps} steps, worst {worst:.3g} of "
        f"max|logits| (bound {SSM_TF_REL}); {leaf} scaled by 1 + 2^-23 moves "
        f"the prefill's logits by {ulp:.3g}")
    if worst > SSM_TF_REL:
        raise AssertionError(f"25c: decode differs from teacher forcing by {worst:.3g}")
    lc = c.for_long_context()
    kinds = sorted({s.mixer for s in layer_specs(lc)})
    out, t_prefill = {}, 0.0
    for name, cc in (("long", lc), ("base", c)):
        t0 = time.perf_counter()
        _, cache = serving.make_prefill_step(cc, rt)(params, toks[:, :HYBRID_LONG])
        torch.cuda.synchronize()
        t_prefill = t_prefill or time.perf_counter() - t0
        sp = [v for k, v in cache.items() if k.endswith("attn.slot_pos")]
        if [t.shape[-1] for t in sp] != [HYBRID_LONG] or bool(sp[0][..., 0].any()):
            raise AssertionError(f"25c: the {name} cache rotated: "
                                 f"{[tuple(t.shape) for t in sp]}")
        cache = serving.pad_cache(cache, steps)
        st = serving.make_serve_step(cc, rt)
        out[name] = []
        for i in range(steps):
            pos = torch.full((1,), HYBRID_LONG + i, dtype=torch.int32, device=rt.device)
            _, got, cache = st(params, cache, toks[:, HYBRID_LONG + i:][:, :1], pos)
            out[name].append(got)
        del cache
    same = all(torch.equal(a, b) for a, b in zip(out["long"], out["base"]))
    want = prefill(params, toks[:, :HYBRID_LONG + 1])[0][:, -1]
    tf = ((out["long"][0] - want).abs().max() / want.abs().max()).item()
    log(f"[{card}] 25c for_long_context() (window {lc.window}; mixers "
        f"{kinds}: the attention layer stays global, as in the reference): "
        f"prompt {HYBRID_LONG} in {t_prefill:.2f} s, the cache unrotated "
        f"({HYBRID_LONG} slots); {steps} decode steps "
        f"{'bitwise' if same else 'NOT bitwise'} the config without the "
        f"window; the first step vs a teacher-forced prefill {tf:.3g} of "
        f"max|logits| (a reading); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not same or kinds != ["attn", "mamba"]:
        raise AssertionError(f"25c: the long-context variant decodes otherwise "
                             f"({kinds}, bitwise {same})")


def phase_hybrid_kernel(torch, ops, ref, prompts, card):
    """25d: the paged kernel alone at jamba's decode shape (B 8, H 64, K 8,
    hd 128, block size 16, bf16, 25a's contexts 32 tokens into the
    generation) against its plain version; its time, byte bound, plain
    and gather+SDPA times, split plan, registers and spills (none)."""
    import torch.nn.functional as F
    nbmax = -(-(PROMPT_HI + MOE_MAX_NEW) // BLOCK_SIZE)
    case = make_case(torch, MOE_SLOTS, 64, 8, 128, BLOCK_SIZE, nbmax,
                     1 + MOE_SLOTS * nbmax, [len(p) + 32 for p in prompts],
                     "bfloat16", seed=25)
    q, kp, vp, bt, pos = case
    B, H, hd = q.shape
    K, T = kp.shape[2], nbmax * BLOCK_SIZE
    err = max_err(torch, ops, ref, case)
    nbytes, flops = paged_work(torch, case, {})
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
    split_len, n_split = ops.split_plan(T, BLOCK_SIZE, B * K, ops.sm_count(q.device))
    res = paged_resources(torch, ops, q.dtype, hd, H // K)
    valid = torch.arange(T, device="cuda")[None, :] <= pos[:, None].long()

    def library():
        kd = kp[bt.long()].reshape(B, T, K, hd).transpose(1, 2)
        vd = vp[bt.long()].reshape(B, T, K, hd).transpose(1, 2)
        return F.scaled_dot_product_attention(q[:, :, None], kd, vd,
                                              attn_mask=valid[:, None, None, :],
                                              enable_gqa=True)[:, :, 0]
    lib_err = (library().float() - ref(*case).float()).abs().max().item()
    ms, enq = time_kernel(torch, lambda: ops.paged_attention(*case))
    lib_ms = time_calls(torch, library)
    plain_ms = time_calls(torch, lambda: ref(*case), n=10)
    log(f"[{card}] 25d paged_decode_attention at jamba's decode shape (B {B} "
        f"H {H} K {K} hd {hd} bs {BLOCK_SIZE}, {nbmax} columns, frontiers "
        f"{int(pos.min())}-{int(pos.max())}, bf16): max abs err vs plain "
        f"{err:.3g} (bound {TOL['bfloat16']}, and 2e-5 + one bf16 step); kernel "
        f"{ms:.4f} ms (host enqueue {enq:.4f} ms), bound {bound_ms:.4f} ms by "
        f"bytes ({nbytes:,} bytes), {100 * bound_ms / ms:.1f} % of it; plain "
        f"{plain_ms:.4f} ms; gather+SDPA {lib_ms:.4f} ms (max abs err vs plain "
        f"{lib_err:.3g}); split_len {split_len}, n_split {n_split}, "
        f"{B * K * n_split} blocks; {res and res['registers']} registers, "
        f"{res and res['spill_bytes']} bytes spilled")
    if err > TOL["bfloat16"]:
        raise AssertionError(f"25d: max abs err {err:.3g}")
    if res is None or res["spill_bytes"]:
        raise AssertionError(f"25d: its kernel's ptxas lines {res}: no spills allowed")


def state_digest(torch, leaves, chunk=1 << 26):
    """Per leaf (sorted by name), per chunk of ``chunk`` elements: the sum,
    modulo 2^64, of each element's bit pattern times a fixed random
    odd weight.  Equal states give equal digests (integer sums do not
    depend on their order); a changed bit changes its chunk's sum."""
    g = torch.Generator(device="cuda").manual_seed(25)
    w = torch.randint(0, 1 << 30, (chunk,), generator=g, device="cuda") * 2 + 1
    iview = {2: torch.int16, 4: torch.int32}
    out = {}
    for name in sorted(leaves):
        x = leaves[name].detach().reshape(-1).view(iview[leaves[name].element_size()])
        out[name] = [int((x[i:i + chunk].to(torch.int64) * w[:x[i:i + chunk].numel()])
                         .sum()) for i in range(0, x.numel(), chunk)]
    return out


def hybrid_train_run(torch, kernels, train_mod, cfg, card, fused, label):
    """One SNGM run through the launcher's own ``build``/``train`` at
    ``cfg`` (batch 8 x 512 in 2 micro-batches, remat, wd 1e-4,
    HYBRID_TRAIN_STEPS steps), the launch counts set to 0 just before and
    read just after: 1 chunk_sumsq + 1 fused_update a step on the engine,
    nothing with ``--fused none``.  Returns (step records, the final
    params' and momentum's digests)."""
    from repro_torch.core.optim import to_pytree
    args = train_mod.parse_args(
        ["--arch", HYBRID_ARCH, "--steps", str(HYBRID_TRAIN_STEPS), "--batch",
         "8", "--seq", "512", "--n-micro", "2", "--weight-decay", "1e-4",
         "--log-every", "1", "--device", "cuda", "--seed", "0", "--optimizer",
         "sngm", "--fused", fused])
    t0 = time.perf_counter()
    with config_cut(train_mod, lambda _: cfg):
        run = train_mod.build(args)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    state, mem = train_mod.train(args, run)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    recs = [m for _, m in mem.steps]
    final = {"params": state.params_view,
             "momentum": to_pytree(state.opt_state).momentum}
    kinds = {what: sorted({str(v.dtype).removeprefix("torch.")
                           for v in leaves.values()})
             for what, leaves in final.items()}
    steady = [m["step_time_s"] for m in recs[1:]]
    step_s = float(np.median(steady))
    losses = ", ".join(f"{m['loss']:.4f}" for m in recs)
    auxes = ", ".join(f"{m['aux_loss']:.6f}" for m in recs)
    log(f"[{card}] 25e SNGM fused={fused}, {label}: {run.n_params:,} params "
        f"{kinds['params']}, momentum {kinds['momentum']}, built in "
        f"{t_build:.1f} s; losses {losses}; aux_loss {auxes}; step 0 "
        f"{recs[0]['step_time_s']:.3f} s, then "
        f"{', '.join(f'{s:.3f}' for s in steady)} s; median {step_s:.3f} s = "
        f"{args.batch * args.seq / step_s:.0f} tokens/s; peak device memory "
        f"{peak_gib:.2f} GiB; launches a step: chunk_sumsq "
        f"{launches['chunk_sumsq'] / args.steps:g}, fused_update "
        f"{launches['fused_update'] / args.steps:g}")
    want = dict.fromkeys(launches, 0)
    if fused == "multi_tensor":
        want.update(chunk_sumsq=args.steps, fused_update=args.steps)
    if launches != want:
        raise AssertionError(f"25e {fused}: launches {launches}, want {want}")
    if len(recs) != args.steps or not all(
            np.isfinite(m[k]) for m in recs
            for k in ("loss", "grad_norm", "lr", "aux_loss")):
        raise AssertionError(f"25e {fused}: missing or non-finite stats")
    if kinds != {"params": ["bfloat16"], "momentum": ["float32"]}:
        raise AssertionError(f"25e: state dtypes {kinds}")
    digest = {what: state_digest(torch, leaves) for what, leaves in final.items()}
    del run, state, mem, final
    gc.collect()
    torch.cuda.empty_cache()
    return recs, digest


def phase_hybrid_train(torch, kernels, train_mod, cfg, card):
    """25e: SNGM at the training cut (one period at half width, bf16
    params and gradients, fp32 momentum) on the engine; then the engine
    against ``fused=None`` from the same seed, run in turn, at the same
    cut with 2 experts (3,106,864,512 params): the plain path's
    functional step holds a second momentum and params beside the first
    (about 18 B a param at its peak, past the card at 4 experts): every
    step's stats and the final params and momentum bitwise (digests,
    ``state_digest``)."""
    hybrid_train_run(torch, kernels, train_mod, cfg, card, "multi_tensor",
                     f"the training cut (d {cfg.d_model}, {cfg.moe.n_experts} "
                     f"experts)")
    two = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=2))
    runs = {f: hybrid_train_run(torch, kernels, train_mod, two, card, f,
                                "2 experts") for f in ("multi_tensor", "none")}
    (ra, da), (rb, db) = runs["multi_tensor"], runs["none"]
    keys = ("loss", "grad_norm", "lr", "aux_loss")
    same = {"stats": all(a[k] == b[k] for a, b in zip(ra, rb) for k in keys)}
    same.update({what: da[what] == db[what] for what in da})
    log(f"[{card}] 25e the engine vs fused=None from the same seed, run in "
        f"turn, {HYBRID_TRAIN_STEPS} steps (2 experts): "
        + ", ".join(f"{what} {'bitwise' if ok else 'NOT bitwise'}"
                    for what, ok in same.items()))
    if not all(same.values()):
        raise AssertionError(f"25e: the engine and fused=None differ: {same}")


def phase_hybrid(torch, kernels, serve_mod, train_mod, serving, layers, ops, ref,
                 card):
    """Phase 25, 25a-25e, each sub-phase's seconds logged, every line
    printed led by the card's name and power limit."""
    from repro_torch.configs import get_config
    from repro_torch.models import make_runtime
    serve_cfg, train_cfg = hybrid_cuts(get_config(HYBRID_ARCH))
    rt = make_runtime("cuda")
    with contextlib.redirect_stdout(CardLines(sys.stdout, card)):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        phase_hybrid_serve(torch, kernels, serve_mod, serve_cfg, rt, card)
        gc.collect()
        torch.cuda.empty_cache()
        t_a = time.perf_counter()
        t_bc = {}
        for dtype in ("float32", "bfloat16"):
            t = time.perf_counter()
            c = dataclasses.replace(train_cfg, compute_dtype=dtype)
            params, _ = serve_mod.load_model(c, rt, seed=0)
            attention_at_true_fan_in(params, c)
            phase_hybrid_dense_paged(torch, kernels, serving, layers, ops, ref, c,
                                     params, rt, card)
            t_bc["b"] = t_bc.get("b", 0.0) + time.perf_counter() - t
            if dtype == "float32":
                t = time.perf_counter()
                torch.cuda.reset_peak_memory_stats()
                phase_hybrid_teacher(torch, serving, c, params, rt, card)
                t_bc["c"] = time.perf_counter() - t
            del params
            gc.collect()
            torch.cuda.empty_cache()
        t_c = time.perf_counter()
        phase_hybrid_kernel(torch, ops, ref, hybrid_traffic(serve_cfg.vocab_size),
                            card)
        torch.cuda.empty_cache()
        t_d = time.perf_counter()
        phase_hybrid_train(torch, kernels, train_mod, train_cfg, card)
        t_e = time.perf_counter()
        log(f"[{card}] phase 25: {t_e - t0:.1f} s (25a {t_a - t0:.1f} s, 25b "
            f"{t_bc['b']:.1f} s, 25c {t_bc['c']:.1f} s, 25d {t_d - t_c:.1f} s, "
            f"25e {t_e - t_d:.1f} s)")


# ---------------------------------------------------------------------------
# phase 26: the Whisper encoder-decoder
# ---------------------------------------------------------------------------

WHISPER_ARCH = "whisper-large-v3"
WHISPER_SEED = 0                     # weights PRNGKey(0); frames PRNGKey(1 + seed)
WHISPER_SERVE = (8, 32, 32)          # 26a: prompts, prompt length, new tokens
WHISPER_CROSS_BYTES = 1_966_080_000  # 26a: 32 x 8 x 1500 x 20 x 64 x 2 (ck, cv) x 2 B
WHISPER_TF_REL = 2e-3                # 26b: decode vs teacher forcing, fp32, of max
WHISPER_CPU_REL = 1e-4               # 26c: the card vs the CPU, fp32, of max
WHISPER_TRAIN_STEPS = 3              # 26d


def whisper_frames(torch, cfg, B, seed, device):
    """(B, encoder_len, d) fp32 frame embeddings drawn on ``device`` from
    ``PRNGKey(1 + seed)`` (the weights take ``PRNGKey(seed)``)."""
    from repro_torch import prng
    return prng.normal(prng.PRNGKey(1 + seed), (B, cfg.encoder_len, cfg.d_model),
                       device)


def true_fan_in(params, cfg, leaves=("wq", "wk", "wv", "wo", "w1", "w2")):
    """Scale every stacked matmul weight named in ``leaves`` (whisper's q,
    k, v, o, w1, w2 by default), in place, from the reference init's std
    to 1/sqrt(its true fan-in).  The
    reference reads a stacked leaf's fan-in from its layer axis (32, or 2
    at a 2-layer cut), so q, k and w1 are drawn 6.3x (25x) too wide and
    the random 32 + 32-layer stack is chaotic: decode and a teacher-forced
    prefill of the same tokens part by ~0.3 of max|logits| in fp32 (PR
    35's first card run), as far as float rounding moves it."""
    from repro_torch.models import model_defs
    from repro_torch.models.param import _fan_in, flatten_defs
    for name, d in flatten_defs(model_defs(cfg)).items():
        if name.rsplit(".", 1)[-1] in leaves:
            one = d._replace(shape=d.shape[1:], axes=d.axes[1:])
            params[name].mul_((_fan_in(d) / _fan_in(one)) ** 0.5)


def phase_whisper_serve(torch, serve_mod, serving, cfg, rt, card):
    """26a: full width and depth, bf16 matmul weights cast as drawn (the
    serve launcher's ``load_model``), through ``greedy_generate`` twice
    (tokens bitwise equal; the second call timed), beside a timed
    prefill (encoder alone timed too) and decode loop whose tokens must
    be greedy_generate's."""
    from repro_torch.models.transformer import encode
    B, S0, max_new = WHISPER_SERVE
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, n_params = serve_mod.load_model(cfg, rt, seed=WHISPER_SEED)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated()
    if n_params != 1_535_219_200:
        raise AssertionError(f"26a: {n_params:,} params, want 1,535,219,200")
    frames = whisper_frames(torch, cfg, B, WHISPER_SEED, rt.device)
    prompt = torch.from_numpy(np.random.RandomState(WHISPER_SEED).randint(
        0, cfg.vocab_size, (B, S0)).astype(np.int32)).to(rt.device)
    toks = serving.greedy_generate(cfg, rt, params, prompt, max_new,
                                   encoder_embeds=frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = serving.greedy_generate(cfg, rt, params, prompt, max_new,
                                    encoder_embeds=frames)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3
    enc_ms = wall_ms(torch, lambda: encode(params, cfg, rt, frames), n=3)
    prefill = serving.make_prefill_step(cfg, rt)
    pre_ms = wall_ms(torch, lambda: prefill(params, prompt, frames), n=3)
    logits, cache = prefill(params, prompt, frames)
    cross = sum(v.numel() * v.element_size() for k, v in cache.items()
                if k.rsplit(".", 1)[-1] in ("ck", "cv"))
    cache = serving.pad_cache(cache, max_new)
    step = serving.make_serve_step(cfg, rt)
    tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
    out = [tok]
    pos = torch.full((B,), S0, dtype=torch.int32, device=rt.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(max_new - 1):
        tok, _, cache = step(params, cache, tok[:, None], pos)
        out.append(tok)
        pos = pos + 1
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (max_new - 1)
    loop = torch.stack(out, dim=1)
    peak = torch.cuda.max_memory_allocated()
    log(f"[{card}] 26a {cfg.name}: {n_params:,} params (32 + 32 layers) drawn "
        f"on the card from PRNGKey({WHISPER_SEED}), matmul weights and MLP "
        f"biases cast to {cfg.compute_dtype} as drawn, in {t_load:.2f} s; "
        f"{resident:,} B resident; cross cache {cross:,} B (want "
        f"{WHISPER_CROSS_BYTES:,})")
    log(f"[{card}] 26a greedy_generate, {B} prompts of {S0} tokens, "
        f"({B}, {cfg.encoder_len}, {cfg.d_model}) frames, {max_new} new "
        f"tokens: {gen_ms:.1f} ms a call = {B * max_new / gen_ms * 1e3:.1f} "
        f"tok/s; encoder {enc_ms:.2f} ms, prefill (encoder included) "
        f"{pre_ms:.2f} ms, decode step {step_ms:.3f} ms "
        f"({B * 1e3 / step_ms:.1f} tok/s in decode); peak device memory "
        f"{peak:,} B; tokens of two calls bitwise equal: "
        f"{torch.equal(toks, again)}; equal to the timed prefill + decode "
        f"loop: {torch.equal(toks, loop)}")
    if cross != WHISPER_CROSS_BYTES:
        raise AssertionError(f"26a: cross cache {cross:,} B")
    if toks.shape != (B, max_new) or not (torch.equal(toks, again)
                                          and torch.equal(toks, loop)):
        raise AssertionError("26a: greedy tokens differ between runs")
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError("26a: a token outside the vocabulary")
    return {"enc_ms": enc_ms, "prefill_ms": pre_ms, "step_ms": step_ms,
            "gen_ms": gen_ms, "peak": peak}


def phase_whisper_teacher(torch, serve_mod, serving, cfg, rt, card, steps=4):
    """26b: fp32 at full width and depth, B 2, the matmul weights at their
    true fan-in (``true_fan_in``): a prompt of 24 tokens and
    ``steps`` decode steps on the cross cache, each step's logits against
    a prefill (with the frames) of the prefix it completes, within
    ``WHISPER_TF_REL`` of its max |logit|; beside it, how far a one-ulp
    scale of one weight leaf moves the prefill (a reading)."""
    c = dataclasses.replace(cfg, compute_dtype="float32")
    params, _ = serve_mod.load_model(c, rt, seed=WHISPER_SEED)
    true_fan_in(params, c)
    B, S = 2, 24
    frames = whisper_frames(torch, c, B, WHISPER_SEED, rt.device)
    toks = torch.from_numpy(np.random.RandomState(WHISPER_SEED + 1).randint(
        0, c.vocab_size, (B, S + steps)).astype(np.int32)).to(rt.device)
    prefill = serving.make_prefill_step(c, rt)
    step = serving.make_serve_step(c, rt)
    first, cache = prefill(params, toks[:, :S], frames)
    cache = serving.pad_cache(cache, steps)
    errs = []
    for i in range(steps):
        pos = torch.full((B,), S + i, dtype=torch.int32, device=rt.device)
        _, got, cache = step(params, cache, toks[:, S + i:S + i + 1], pos)
        ref = prefill(params, toks[:, :S + i + 1], frames)[0][:, -1]
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("26b: decode logits are not finite")
        errs.append(((got - ref).abs().max() / ref.abs().max()).item())
    leaf = "blocks.L0.cross.wq"
    nudged = dict(params, **{leaf: params[leaf] * (1 + 2**-23)})
    moved = prefill(nudged, toks[:, :S], frames)[0]
    ulp = ((moved - first).abs().max() / first.abs().max()).item()
    log(f"[{card}] 26b (32 + 32 layers, fp32, true fan-in, B {B}, prompt "
        f"{S}): decode on the cross cache vs a teacher-forced prefill, each "
        f"step {', '.join(f'{e:.3g}' for e in errs)} of max|logits| (bound "
        f"{WHISPER_TF_REL}); {leaf} scaled by 1 + 2^-23 moves the prefill's "
        f"logits by {ulp:.3g}")
    del params, cache, nudged
    if max(errs) > WHISPER_TF_REL:
        raise AssertionError(f"26b: decode differs from teacher forcing by "
                             f"{max(errs):.3g}")
    return errs


def phase_whisper_cpu(torch, serve_mod, cfg, rt, card):
    """26c: the port's fp32 ``forward`` at full width, 2 encoder + 2
    decoder layers, on the card and on the CPU with the same weights (at
    their true fan-in) and frames (drawn on the card, copied): the
    prefill logits within ``WHISPER_CPU_REL`` of their max; the
    train-mode hidden states a reading."""
    from repro_torch.models import Runtime, forward
    c = dataclasses.replace(cfg, n_layers=2, n_encoder_layers=2,
                            compute_dtype="float32")
    params, _ = serve_mod.load_model(c, rt, seed=WHISPER_SEED)
    true_fan_in(params, c)
    frames = whisper_frames(torch, c, 2, WHISPER_SEED, rt.device)
    toks = torch.from_numpy(np.random.RandomState(WHISPER_SEED + 2).randint(
        0, c.vocab_size, (2, 24)).astype(np.int32)).to(rt.device)
    cpu = torch.device("cpu")
    host = ({k: v.cpu() for k, v in params.items()}, toks.cpu(), frames.cpu())
    outs = {}
    t_cpu = time.perf_counter()
    for where, (p, t, f), r in (("cpu", host, Runtime(cpu)),
                                ("card", (params, toks, frames), rt)):
        logits, _ = forward(p, c, r, t, mode="prefill", encoder_embeds=f)
        h, _ = forward(p, c, r, t, mode="train", encoder_embeds=f)
        outs[where] = (logits.cpu(), h.cpu())
        if where == "cpu":
            t_cpu = time.perf_counter() - t_cpu
    (lc, hc), (lg, hg) = outs["cpu"], outs["card"]
    err = ((lg - lc).abs().max() / lc.abs().max()).item()
    err_h = ((hg - hc).abs().max() / hc.abs().max()).item()
    log(f"[{card}] 26c (2 + 2 layers, fp32, B 2, prompt 24, the CPU's forward "
        f"{t_cpu:.1f} s): the card against the CPU, prefill logits {err:.3g} "
        f"of max (bound {WHISPER_CPU_REL}); train-mode hidden states "
        f"{err_h:.3g} of max, a reading")
    del params, host
    if not (err <= WHISPER_CPU_REL):
        raise AssertionError(f"26c: the card and the CPU differ by {err:.3g}")
    return err, err_h


def whisper_train_run(torch, kernels, train_mod, card, fused, n_layers, label):
    """One SNGM run through the launcher's ``build``/``train`` (batch 8 x
    128 in 2 micro-batches, remat, wd 1e-4, ``WHISPER_TRAIN_STEPS``
    steps), at ``n_layers`` encoder and decoder layers (None: 32 + 32),
    the launch counts set to 0 just before and read just after.  Returns
    (step records, the final params' and momentum's digests)."""
    from repro_torch.core.multi_tensor import FlatOptState
    from repro_torch.core.optim import to_pytree
    args = train_mod.parse_args(
        ["--arch", WHISPER_ARCH, "--steps", str(WHISPER_TRAIN_STEPS), "--batch",
         "8", "--seq", "128", "--n-micro", "2", "--weight-decay", "1e-4",
         "--log-every", "1", "--device", "cuda", "--seed", str(WHISPER_SEED),
         "--optimizer", "sngm", "--fused", fused])
    cut = (lambda c: c) if n_layers is None else (
        lambda c: dataclasses.replace(c, n_layers=n_layers,
                                      n_encoder_layers=n_layers))
    t0 = time.perf_counter()
    with config_cut(train_mod, cut):
        run = train_mod.build(args)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    buckets = ([str(b.dtype).removeprefix("torch.")
                for b in run.state.opt_state.layout.buckets]
               if isinstance(run.state.opt_state, FlatOptState) else None)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    state, mem = train_mod.train(args, run)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    recs = [m for _, m in mem.steps]
    steady = [m["step_time_s"] for m in recs[1:]]
    step_s = float(np.median(steady))
    losses = ", ".join(f"{m['loss']:.4f}" for m in recs)
    log(f"[{card}] 26d SNGM fused={fused}, {label}: {run.n_params:,} fp32 "
        f"params, buckets {buckets}, built in {t_build:.1f} s; losses "
        f"{losses}; step 0 "
        f"{recs[0]['step_time_s']:.3f} s, then "
        f"{', '.join(f'{s:.3f}' for s in steady)} s; median {step_s:.3f} s = "
        f"{args.batch * args.seq / step_s:.0f} decoder tokens/s "
        f"({args.batch * run.cfg.encoder_len / step_s:.0f} frames/s); peak "
        f"device memory {peak:,} B; launches: chunk_sumsq "
        f"{launches['chunk_sumsq']} in {args.steps} steps, fused_update "
        f"{launches['fused_update']} in {args.steps} steps")
    want = dict.fromkeys(launches, 0)
    if fused == "multi_tensor":
        want.update(chunk_sumsq=args.steps, fused_update=args.steps)
        if buckets != ["float32"]:
            raise AssertionError(f"26d: buckets {buckets}, want one fp32 bucket")
    if launches != want:
        raise AssertionError(f"26d {fused}: launches {launches}, want {want}")
    if len(recs) != args.steps or not all(
            np.isfinite(m[k]) for m in recs for k in ("loss", "grad_norm", "lr")):
        raise AssertionError(f"26d {fused}: missing or non-finite stats")
    final = {"params": state.params_view,
             "momentum": to_pytree(state.opt_state).momentum}
    digest = {what: state_digest(torch, leaves) for what, leaves in final.items()}
    del run, state, mem, final
    gc.collect()
    torch.cuda.empty_cache()
    return recs, digest, step_s, peak


def phase_whisper_train(torch, kernels, train_mod, card):
    """26d: full depth on the engine; then at 2 + 2 layers the engine and
    ``--fused none`` from the same seed, in turn: every step's stats and
    the final params and momentum bitwise (``state_digest``)."""
    _, _, step_s, peak = whisper_train_run(torch, kernels, train_mod, card,
                                           "multi_tensor", None, "32 + 32 layers")
    runs = {f: whisper_train_run(torch, kernels, train_mod, card, f, 2,
                                 "2 + 2 layers") for f in ("multi_tensor", "none")}
    (ra, da, _, _), (rb, db, _, _) = runs["multi_tensor"], runs["none"]
    keys = ("loss", "grad_norm", "lr")
    same = {"stats": all(a[k] == b[k] for a, b in zip(ra, rb) for k in keys)}
    same.update({what: da[what] == db[what] for what in da})
    log(f"[{card}] 26d the engine vs --fused none from the same seed, run in "
        f"turn, {WHISPER_TRAIN_STEPS} steps (2 + 2 layers): "
        + ", ".join(f"{what} {'bitwise' if ok else 'NOT bitwise'}"
                    for what, ok in same.items()))
    if not all(same.values()):
        raise AssertionError(f"26d: the engine and --fused none differ: {same}")
    return step_s, peak


def phase_whisper(torch, kernels, serve_mod, train_mod, serving, card):
    """Phase 26, 26a-26d, each sub-phase's seconds logged, every line
    printed led by the card's name and power limit."""
    from repro_torch.configs import get_config
    from repro_torch.models import make_runtime
    cfg = get_config(WHISPER_ARCH)
    rt = make_runtime("cuda")
    with contextlib.redirect_stdout(CardLines(sys.stdout, card)):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        phase_whisper_serve(torch, serve_mod, serving, cfg, rt, card)
        gc.collect()
        torch.cuda.empty_cache()
        t_a = time.perf_counter()
        phase_whisper_teacher(torch, serve_mod, serving, cfg, rt, card)
        gc.collect()
        torch.cuda.empty_cache()
        t_b = time.perf_counter()
        phase_whisper_cpu(torch, serve_mod, cfg, rt, card)
        gc.collect()
        torch.cuda.empty_cache()
        t_c = time.perf_counter()
        phase_whisper_train(torch, kernels, train_mod, card)
        t_d = time.perf_counter()
        log(f"[{card}] phase 26: {t_d - t0:.1f} s (26a {t_a - t0:.1f} s, 26b "
            f"{t_b - t_a:.1f} s, 26c {t_c - t_b:.1f} s, 26d {t_d - t_c:.1f} s)")


# ---------------------------------------------------------------------------
# phase 27: the precision and remat switches
# ---------------------------------------------------------------------------

PRECISION_STEPS = 4                  # 27b: steps a run
PRECISION_REL = 5e-2                 # 27b: step-0 loss and ||g||, on vs off
PRECISION_DECODE = (2, 480, 4)       # 27d: prompts, prompt length, decode steps
# 27a: (what, a's shape, b's shape): a (M, K) or (n, M, K) times b
BF16_DOT_SHAPES = [
    ("gemma-2b logits chunk", (2048, 2048), (2048, 256000)),
    ("gemma-2b scores (B 4, S 512, G 8, hd 256)", (4, 4096, 256), (4, 256, 512)),
    ("whisper encoder scores (B 4, T 1500, H 20, hd 64)", (80, 1500, 64),
     (80, 64, 1500)),
]


def bf16_excess(torch, ref, got):
    """max(|ref - got| - one bf16 step of the value, 0) over max|ref|."""
    ref, got = ref.float(), got.float()
    step = 2.0 ** -7 * torch.maximum(ref.abs(), got.abs())
    return float((torch.clamp((ref - got).abs() - step, min=0).max()
                  / ref.abs().max()))


def phase_bf16_dot(torch, layers, card):
    """27a: ``bf16_dot`` on the card (tensor cores, ``out_dtype``) against
    its plain form (``bf16_dot_ref``: the rounded operands lifted to fp32,
    an fp32 GEMM with TF32 off) on the same inputs, forward and both
    cotangents through autograd; then the forward product and the
    backward's two cotangent products timed (``time_kernel``) beside the
    plain form's and the bf16 bound (2 M N K flops a product at 989
    TFLOP/s, or the bytes: bf16 operands read once, the fp32 output
    written once; the backward six bf16 products of the fp32 cotangent's
    three terms)."""
    gen = torch.Generator(device="cuda").manual_seed(27)
    for what, sa, sb in BF16_DOT_SHAPES:
        a = torch.randn(sa, device="cuda", generator=gen)
        if len(sb) == 2:          # the unembedding is the embedding's transpose
            b = (torch.randn(sb[::-1], device="cuda", generator=gen) * 0.02).T
        else:
            b = torch.randn(sb, device="cuda", generator=gen)
        g = torch.randn(sa[:-1] + sb[-1:], device="cuda", generator=gen)
        outs = {}
        for fn in (layers.bf16_dot, layers.bf16_dot_ref):
            ta, tb = a.clone().requires_grad_(), b.clone().requires_grad_()
            o = fn(ta, tb)
            o.backward(g)
            outs[fn.__name__] = (o.detach(), ta.grad, tb.grad)
            del ta, tb, o
        (o1, da1, db1), (o0, da0, db0) = outs["bf16_dot"], outs["bf16_dot_ref"]
        errs = {"forward": float((o1 - o0).abs().max() / o0.abs().max()),
                "da": bf16_excess(torch, da0, da1),
                "db": bf16_excess(torch, db0, db1)}
        del outs, o1, da1, db1, o0, da0, db0
        a16, b16 = a.bfloat16(), b.bfloat16()
        *lead, M, K = a16.shape
        N = b16.shape[-1]
        n = lead[0] if lead else 1
        flops = 2.0 * n * M * N * K
        nbytes = 2 * (a16.numel() + b16.numel()) + 4 * n * M * N
        fwd_ms = time_calls(torch, lambda: layers._mm_f32(a16, b16), n=10)
        plain_ms = time_calls(torch, lambda: a16.float() @ b16.float(), n=3)
        bwd_ms = time_calls(torch, lambda: layers._bf16_dot_grads(a16, b16, g),
                            n=5)
        plain_bwd_ms = time_calls(torch, lambda: (
            (g @ b16.float().mT).bfloat16(), (a16.float().mT @ g).bfloat16()),
            n=3)
        bound = max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
        bwd_bound = max(6 * flops / BF16_FLOPS, (4 * g.numel() + nbytes
                                                 - 4 * n * M * N)
                        / HBM_BYTES_PER_S) * 1e3
        log(f"[{card}] 27a bf16_dot, {what}: a {tuple(sa)} @ b {tuple(sb)}; "
            f"card vs plain form: forward {errs['forward']:.3g} of max "
            f"(bound 1e-5); cotangents beyond one bf16 step of the value, of "
            f"max: a {errs['da']:.3g}, b {errs['db']:.3g} (bound 1e-5); "
            f"forward {fwd_ms:.4f} ms = {flops / fwd_ms / 1e9:.1f} TFLOP/s "
            f"(bound {bound:.4f} ms, {100 * bound / fwd_ms:.1f} %; plain form "
            f"{plain_ms:.4f} ms); backward (two cotangents, six bf16 "
            f"products) {bwd_ms:.4f} ms (bound {bwd_bound:.4f} ms; plain form "
            f"{plain_bwd_ms:.4f} ms)")
        if max(errs.values()) > 1e-5:
            raise AssertionError(f"27a {what}: card vs plain form {errs}")
        del a, b, g, a16, b16
        gc.collect()
        torch.cuda.empty_cache()


GEMM_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")


def gemm_split(prof):
    """Device ms of the profiled GEMMs (the kernels that ``aten::mm``,
    ``bmm``, ``addmm`` and ``baddbmm`` launched) by the dtype of the
    product's first matrix, read from the profile's trace: a kernel's
    ``External id`` (or its runtime call's) names the op that launched
    it, whose ``Input type`` the trace records with ``record_shapes``."""
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    ops, launch = {}, {}
    for e in events:
        args = e.get("args") or {}
        if e.get("cat") == "cpu_op" and e.get("name") in GEMM_OPS:
            types = args.get("Input type") or ["?", "?"]
            ops[args.get("External id")] = types[1 if "add" in e["name"] else 0]
        elif e.get("cat") == "cuda_runtime" and "correlation" in args:
            launch[args["correlation"]] = args.get("External id")
    out = {}
    for e in events:
        args = e.get("args") or {}
        if e.get("cat") == "kernel":
            xid = args.get("External id")
            if xid not in ops:
                xid = launch.get(args.get("correlation"))
            if xid in ops:
                out[ops[xid]] = out.get(ops[xid], 0.0) + e.get("dur", 0) / 1e3
    return out


@contextlib.contextmanager
def per_block_remat(on=True):
    """``transformer._remat_group`` forced to 1 while ``on``: remat per
    block only, no sqrt-remat groups."""
    from repro_torch.models import transformer
    group = transformer._remat_group
    if on:
        transformer._remat_group = lambda n: 1
    try:
        yield
    finally:
        transformer._remat_group = group


@contextlib.contextmanager
def runtime_patch(train_mod, **kw):
    """The launcher's ``make_runtime`` with ``kw`` added (the launcher has
    no flag for ``gather_dtype``, as the JAX launcher has none)."""
    make = train_mod.make_runtime
    train_mod.make_runtime = lambda *a, **k: make(*a, **{**k, **kw})
    try:
        yield
    finally:
        train_mod.make_runtime = make


def precision_train_run(torch, kernels, train_mod, card, on, profile,
                        per_block=False):
    """27b: phase 9's SNGM engine run (batch 8 x 512 in 2 micro-batches,
    remat, wd 1e-4, ``PRECISION_STEPS`` steps) through the launcher's
    ``build``/``train``, with ``logits_bf16``, ``sdpa_bf16`` and
    ``gather_dtype="bfloat16"`` all on or all off, the launch counts set
    to 0 just before and read just after; ``profile``: one more step under
    ``torch.profiler``, its GEMM device time by dtype; ``per_block``:
    ``_remat_group`` forced to 1 (per-block remat, no groups)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    args = train_mod.parse_args(
        ["--arch", ARCH, "--steps", str(PRECISION_STEPS), "--batch", "8",
         "--seq", "512", "--n-micro", "2", "--weight-decay", "1e-4",
         "--log-every", "1", "--device", "cuda", "--seed", "0",
         "--optimizer", "sngm", "--fused", "multi_tensor"])
    label = ("switches on" if on else "switches off") + (
        ", per-block remat" if per_block else "")
    cut = ((lambda c: dataclasses.replace(c, logits_bf16=True, sdpa_bf16=True))
           if on else (lambda c: c))
    t0 = time.perf_counter()
    with config_cut(train_mod, cut), runtime_patch(
            train_mod, gather_dtype="bfloat16" if on else "float32"):
        run = train_mod.build(args)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with per_block_remat(per_block):
        state, mem = train_mod.train(args, run)
        torch.cuda.synchronize()
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    recs = [m for _, m in mem.steps]
    steady = [m["step_time_s"] for m in recs[1:]]
    step_s = float(np.median(steady))
    want = dict.fromkeys(launches, 0)
    want.update(chunk_sumsq=args.steps, fused_update=args.steps)
    losses = ", ".join(f"{m['loss']:.4f}" for m in recs)
    log(f"[{card}] 27b gemma-2b SNGM on the engine, {label} (logits_bf16 "
        f"{run.cfg.logits_bf16}, sdpa_bf16 {run.cfg.sdpa_bf16}, gather_dtype "
        f"{'bfloat16' if on else 'float32'}), built in {t_build:.1f} s: "
        f"losses {losses}; "
        f"||g|| step 0 {recs[0]['grad_norm']:.6g}; step 0 "
        f"{recs[0]['step_time_s']:.3f} s, then "
        f"{', '.join(f'{s:.3f}' for s in steady)} s; median {step_s:.3f} s = "
        f"{args.batch * args.seq / step_s:.0f} tokens/s; peak device memory "
        f"{peak:,} B; launches chunk_sumsq {launches['chunk_sumsq']}, "
        f"fused_update {launches['fused_update']} in {args.steps} steps")
    if launches != want:
        raise AssertionError(f"27b {label}: launches {launches}, want {want}")
    if len(recs) != args.steps or not all(
            np.isfinite(m[k]) for m in recs for k in ("loss", "grad_norm", "lr")):
        raise AssertionError(f"27b {label}: missing or non-finite stats")
    if profile:
        batch = run.data.batch_at(0)
        torch.cuda.synchronize()
        with per_block_remat(per_block), tprofile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                record_shapes=True) as prof:
            t0 = time.perf_counter()
            run.step(state, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        split = gemm_split(prof)
        log(f"[{card}] 27b {label}, profiled step ({wall:.0f} ms wall): GEMM "
            f"device ms by input dtype " + (", ".join(
                f"{k} {v:.1f}" for k, v in sorted(split.items()))
                if split else "not measured (no GEMM kernel in the trace)"))
        log_profile(prof, wall, f"[{card}] 27b {label} profiled step", top=6)
        del prof
    out = {"loss0": recs[0]["loss"], "gnorm0": recs[0]["grad_norm"],
           "step_s": step_s, "peak": peak}
    del run, state, mem
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_precision_train(torch, kernels, train_mod, card, full):
    """27b: the switches off and on, one run each; ``full``: in turns
    per-block off, off, on, on, off, per-block off, where per-block runs
    remat without groups (``_remat_group`` forced to 1) beside the grouped
    one, the first run of each kind profiled.  Each "on" run's step-0
    loss and ||g|| within ``PRECISION_REL`` relative of the first "off"
    run's."""
    order = ([("per-block off", False, True), ("off", False, False),
              ("on", True, False), ("on", True, False), ("off", False, False),
              ("per-block off", False, True)] if full
             else [("off", False, False), ("on", True, False)])
    runs, profiled = [], set()
    for kind, on, per_block in order:
        runs.append(precision_train_run(torch, kernels, train_mod, card, on,
                                        full and kind not in profiled,
                                        per_block))
        profiled.add(kind)
    off = runs[[k for k, _, _ in order].index("off")]
    for (kind, on, _), r in zip(order, runs):
        for k in ("loss0", "gnorm0"):
            rel = abs(r[k] - off[k]) / abs(off[k])
            if on and rel > PRECISION_REL:
                raise AssertionError(f"27b: switches on, {k} {r[k]:.6g} vs off "
                                     f"{off[k]:.6g} ({rel:.3g} relative)")
    for kind in dict.fromkeys(k for k, _, _ in order):
        sel = [r for (k, _, _), r in zip(order, runs) if k == kind]
        steps = ", ".join(f"{r['step_s']:.3f}" for r in sel)
        peaks = ", ".join(f"{r['peak']:,}" for r in sel)
        log(f"[{card}] 27b switches {kind}: step s {steps}; peak B {peaks}; "
            f"step-0 loss {sel[0]['loss0']:.6f}, ||g|| {sel[0]['gnorm0']:.6g}")


def phase_remat_groups(torch, layers, cfg, card, params, full):
    """27c: full-width gemma-2b (18 periods, fp32 params, bf16 compute),
    one micro-batch (4 x 512) of ``loss_fn`` and backward with remat, in
    turns per-block (``_remat_group`` forced to 1: remat without groups),
    grouped (4 groups of 4, 2 periods ungrouped), grouped,
    per-block: grouped gradients bitwise the first per-block run's, or,
    if the two per-block runs differ on the card, within twice their
    difference (phase 18's rule); each run's time and its peak above
    the memory held before it.  ``full``: then ``switch_norms``."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Runtime, transformer
    from repro_torch.training.step import loss_fn
    rt = Runtime(torch.device("cuda"), remat=True)
    batch = SyntheticLM(cfg.vocab_size, 512, 4, seed=0, branching=4,
                        device=rt.device).batch_at(0)
    ref, diffs, rows = None, {}, []
    for grouped in (False, True, True, False):
        with per_block_remat(not grouped):
            for v in params.values():
                v.grad = None
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss, _ = loss_fn(params, batch, cfg, rt)
            loss.backward()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
        label = "grouped" if grouped else "per-block"
        rows.append(f"{label} {secs:.3f} s, peak +{peak:,} B")
        grads = {k: v.grad for k, v in params.items()}
        if ref is None:
            ref = {k: g.clone() for k, g in grads.items()}
            continue
        d = max(float((grads[k] - ref[k]).abs().max()) for k in ref)
        diffs.setdefault(label, []).append(d)
    off = {k: float(g.norm()) for k, g in ref.items()}
    del ref, grads
    live = max(diffs["per-block"])
    worst = max(diffs["grouped"])
    log(f"[{card}] 27c remat at {cfg.n_layers} periods (groups of "
        f"{transformer._remat_group(cfg.n_layers)}), one micro-batch: "
        + "; ".join(rows) + f"; max |grad - first per-block run's|: grouped "
        f"{', '.join(f'{d:.3g}' for d in diffs['grouped'])}, per-block "
        f"{live:.3g}")
    if worst > 2 * live:
        raise AssertionError(f"27c: grouped gradients {worst:.3g} from "
                             f"per-block, per-block runs {live:.3g} apart")
    if full:
        switch_norms(torch, layers, cfg, card, params, batch, off)
    for v in params.values():
        v.grad = None
    gc.collect()
    torch.cuda.empty_cache()


def switch_norms(torch, layers, cfg, card, params, batch, off):
    """27c's reading: the gradient norm of one micro-batch (remat on)
    with each switch, with ``sdpa_bf16`` on its plain form
    (``bf16_dot_ref``), and with the switches off and one weight leaf
    scaled by one fp32 ulp, beside ``off``, the per-leaf norms with the
    switches off."""
    from repro_torch.models import Runtime
    from repro_torch.training.step import loss_fn
    leaf = "blocks.L0.attn.wq"
    dot = layers.bf16_dot
    norms = {"off": off}
    for name, kw, gather in (("logits_bf16", {"logits_bf16": True}, "float32"),
                             ("sdpa_bf16", {"sdpa_bf16": True}, "float32"),
                             ("sdpa_bf16 plain form", {"sdpa_bf16": True},
                              "float32"),
                             ("gather_dtype", {}, "bfloat16"),
                             ("all", {"logits_bf16": True, "sdpa_bf16": True},
                              "bfloat16"),
                             (f"off, one ulp on {leaf}", {}, "float32")):
        for v in params.values():
            v.grad = None
        nudge = name.startswith("off")
        if nudge:
            with torch.no_grad():
                keep = params[leaf].clone()
                params[leaf].mul_(1 + 2**-23)
        layers.bf16_dot = layers.bf16_dot_ref if "plain" in name else dot
        try:
            loss, _ = loss_fn(params, batch, dataclasses.replace(cfg, **kw),
                              Runtime(torch.device("cuda"), remat=True,
                                      gather_dtype=gather))
            loss.backward()
        finally:
            layers.bf16_dot = dot
            if nudge:
                with torch.no_grad():
                    params[leaf].copy_(keep)
        norms[name] = {k: float(v.grad.norm()) for k, v in params.items()}
    total = {n: sum(x * x for x in g.values()) ** 0.5 for n, g in norms.items()}
    moved = max(off, key=lambda k: abs(norms["all"][k] - off[k]))
    log(f"[{card}] 27c switches at one micro-batch (a reading): ||g|| "
        + ", ".join(f"{n} {t:.6g}" for n, t in total.items())
        + f"; the leaf whose norm moves most with all three: {moved} "
        f"{off[moved]:.6g} -> {norms['all'][moved]:.6g}")


GEMMA_MATMULS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")


def phase_precision_decode(torch, layers, serving, cfg, card, params):
    """27d: full-width gemma-2b at fp32 compute with ``sdpa_bf16``: a
    prefill of ``PRECISION_DECODE`` prompts and teacher-forced dense
    decode steps after ``pad_cache``, on the card's path (``bf16_dot``),
    on its plain form (``bf16_dot_ref`` in its place) and on the card's
    path with one weight leaf scaled by one fp32 ulp.  At the reference
    init (stacked weights drawn at fan-in 18) the random stack is
    chaotic under ``sdpa_bf16``: an ulp of difference in a layer's
    output flips a bf16 rounding of a score operand in the next, so the
    two forms part as far as the nudge moves the logits (a reading).
    With the matmul weights scaled to their true fan-in (``true_fan_in``,
    in place) every logits of the card's path is held within
    ``LOGIT_REL["float32"]`` of the plain form's."""
    from repro_torch.models import Runtime, forward
    B, S0, steps = PRECISION_DECODE
    cfg = dataclasses.replace(cfg, compute_dtype="float32", sdpa_bf16=True)
    rt = Runtime(torch.device("cuda"))
    toks = torch.from_numpy(np.random.RandomState(27).randint(
        0, cfg.vocab_size, (B, S0 + steps)).astype(np.int32)).cuda()
    dot = layers.bf16_dot
    leaf = "blocks.L0.attn.wq"

    def run(p, plain=False):
        layers.bf16_dot = layers.bf16_dot_ref if plain else dot
        try:
            with torch.no_grad():
                out, cache = forward(p, cfg, rt, toks[:, :S0], mode="prefill")
                outs = [out]
                cache = serving.pad_cache(cache, steps)
                for i in range(steps):
                    pos = torch.full((B,), S0 + i, dtype=torch.int32,
                                     device=rt.device)
                    out, cache = forward(p, cfg, rt, toks[:, S0 + i:S0 + i + 1],
                                         mode="decode", cache=cache, pos=pos)
                    outs.append(out)
        finally:
            layers.bf16_dot = dot
        return outs

    def rel(xs, ys):
        return [float((a - b).abs().max() / b.abs().max()) for a, b in zip(xs, ys)]

    worst = None
    for init in ("reference", "true fan-in"):
        if init != "reference":
            with torch.no_grad():
                true_fan_in(params, cfg, GEMMA_MATMULS)
        card_, plain = run(params), run(params, plain=True)
        nudged = run(dict(params, **{leaf: params[leaf] * (1 + 2**-23)}))
        got, moved = rel(card_, plain), rel(nudged, card_)
        fine = all(bool(torch.isfinite(x).all()) for x in card_)
        log(f"[{card}] 27d gemma-2b fp32 compute, sdpa_bf16, {init} init, {B} "
            f"prompts of {S0}, prefill + {steps} dense decode steps: card vs "
            f"plain form {', '.join(f'{r:.3g}' for r in got)} of max; one "
            f"ulp on {leaf} moves the card's {', '.join(f'{r:.3g}' for r in moved)}"
            f"; finite {fine}" + (f" (bound {LOGIT_REL['float32']})"
                                  if init != "reference" else " (a reading)"))
        if not fine:
            raise AssertionError(f"27d {init}: non-finite logits")
        worst = max(got)
    if worst > LOGIT_REL["float32"]:
        raise AssertionError(f"27d true fan-in: card vs plain form {worst:.3g}")


def phase_precision(torch, kernels, train_mod, serving, layers, card, full):
    """Phase 27, 27a-27d, each sub-phase's seconds logged, every line led
    by the card's name and power limit.  ``full`` (``--precision-only``)
    runs 27b in six turns, per-block remat among them, else one run of
    the switches off and one on."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.models import materialize, model_defs
    cfg = get_config(ARCH)
    with contextlib.redirect_stdout(CardLines(sys.stdout, card)):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        phase_bf16_dot(torch, layers, card)
        t_a = time.perf_counter()
        params = {k: v.requires_grad_() for k, v in materialize(
            model_defs(cfg), prng.PRNGKey(0), torch.device("cuda")).items()}
        phase_remat_groups(torch, layers, cfg, card, params, full)
        t_c = time.perf_counter()
        phase_precision_decode(torch, layers, serving, cfg, card, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        t_d = time.perf_counter()
        phase_precision_train(torch, kernels, train_mod, card, full)
        t_b = time.perf_counter()
        log(f"[{card}] phase 27: {t_b - t0:.1f} s (27a {t_a - t0:.1f} s, 27c "
            f"{t_c - t_a:.1f} s, 27d {t_d - t_c:.1f} s, 27b {t_b - t_d:.1f} s)")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="On-card smoke run of the port.")
    ap.add_argument("--ops-only", action="store_true",
                    help="phase 1 and the op phases 11-14 only (a quick check "
                         "of the rmsnorm and flash kernels); prints their rows")
    ap.add_argument("--paged-only", action="store_true",
                    help="phases 1, 2 and 5 only (a quick check of the paged "
                         "kernel); prints its row")
    ap.add_argument("--chains-only", action="store_true",
                    help="phases 1 and 15-17 only (gradient-transform chains "
                         "on the engine, fused_update's deferred apply); "
                         "prints its row")
    ap.add_argument("--ckpt-only", action="store_true",
                    help="phases 1 and 18 only (checkpoints and resume at "
                         "full width); prints no kernel rows")
    ap.add_argument("--data-only", action="store_true",
                    help="phase 1, the pack and phase 19 only (the data "
                         "pipeline at full width); prints no kernel rows")
    ap.add_argument("--convnet-only", action="store_true",
                    help="phases 1 and 20 only (the paper's convnet and the "
                         "two training loops on the engine); prints no "
                         "kernel rows")
    ap.add_argument("--dense-only", action="store_true",
                    help="phases 1 and 22 only (the dense serving engine at "
                         "full width: serving, against both paged paths, the "
                         "rotated ring at long context); prints no kernel rows")
    ap.add_argument("--moe-only", action="store_true",
                    help="phases 1 and 23 only (the DeepSeek-V2 family at full "
                         "width: serving on both engines, dense vs paged, one "
                         "MoE layer, SNGM training on the engine); prints no "
                         "kernel rows")
    ap.add_argument("--ssm-only", action="store_true",
                    help="phases 1 and 24 only (the Mamba2 family at full "
                         "width: serving on both engines, dense vs paged, "
                         "teacher forcing, ssd_chunked, SNGM training on the "
                         "engine); prints no kernel rows")
    ap.add_argument("--hybrid-only", action="store_true",
                    help="phases 1 and 25 only (the jamba hybrid: one period "
                         "served at full width on both engines, dense vs "
                         "paged, teacher forcing and the long-context variant, "
                         "the paged kernel at its decode shape, SNGM training "
                         "on the engine); prints no kernel rows")
    ap.add_argument("--whisper-only", action="store_true",
                    help="phases 1 and 26 only (the Whisper encoder-decoder "
                         "at full width and depth: greedy_generate on the "
                         "dense cache, teacher forcing, the card against the "
                         "CPU, SNGM training on the engine); prints no "
                         "kernel rows")
    ap.add_argument("--precision-only", action="store_true",
                    help="phases 1 and 27 only (the precision and remat "
                         "switches: bf16_dot against its plain form, gemma-2b "
                         "training with the switches off and on and per-block "
                         "remat, six runs in turn, grouped against per-block "
                         "remat, decode with sdpa_bf16); prints no kernel "
                         "rows")
    ap.add_argument("--ema-only", action="store_true",
                    help="phases 1 and 21 only (EMA shadow parameters on the "
                         "engine at full width, against the interpreter and "
                         "the CPU, and through a checkpoint); prints no "
                         "kernel rows")
    args = ap.parse_args(argv)
    if not (SRC / "repro_torch" / "kernels").is_dir():
        print("chip_smoke.py: src/repro_torch not found next to this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch import kernels, serving
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_lars import ops as lars_ops
    from repro_torch.kernels.fused_lars import ref as lars_ref
    from repro_torch.kernels.fused_sngm import ops as sngm_ops
    from repro_torch.kernels.fused_sngm import ref as sngm_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm import ref as rms_ref
    from repro_torch.kernels.multi_tensor import ops as mt_ops
    from repro_torch.kernels.multi_tensor import ref as mt_ref
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref as ref
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models import Runtime, layers, make_runtime

    sngm = SimpleNamespace(ops=sngm_ops, ref=sngm_ref)
    lars = SimpleNamespace(ops=lars_ops, ref=lars_ref)
    t_start = time.perf_counter()
    libs = {"paged_attention": [ops.SOURCE]}
    if (args.convnet_only or args.ema_only or args.moe_only or args.ssm_only
            or args.whisper_only or args.precision_only):
        libs = {mt_ops.LIB_NAME: [mt_ops.SOURCE]}
    elif args.chains_only or args.ckpt_only or args.data_only or args.hybrid_only:
        libs[mt_ops.LIB_NAME] = [mt_ops.SOURCE]
    elif not (args.paged_only or args.dense_only):
        libs.update({mt_ops.LIB_NAME: [mt_ops.SOURCE],
                     sngm.ops.LIB_NAME: [sngm.ops.SOURCE],
                     lars.ops.LIB_NAME: [lars.ops.SOURCE],
                     rms_ops.LIB_NAME: [rms_ops.SOURCE],
                     fa_ops.LIB_NAME: [fa_ops.SOURCE]})
    card = phase_card(torch, build, libs)
    rows, kernel_rows = {}, []
    t_serve = t_kernels = t_train = t_start
    if args.dense_only:
        phase_dense(torch, kernels, serve_mod, serving, layers, Runtime,
                    get_config(ARCH), make_runtime("cuda"), None)
        t_serve = t_kernels = t_train = time.perf_counter()
    elif args.paged_only:
        err = phase_kernel(torch, ops, ref)
        kernel_rows.append(phase_timing(torch, ops, ref, None, err, 0, None))
    elif args.chains_only:
        rows.update(chain_phases(torch, kernels, mt_ops, mt_ref, train_mod,
                                 get_config(ARCH)))
    elif args.ckpt_only:
        with scratch_pack(get_config(ARCH).vocab_size) as pack:
            ckpt_phases(torch, kernels, train_mod, pack)
    elif args.data_only:
        with scratch_pack(get_config(ARCH).vocab_size) as pack:
            phase_data(torch, kernels, train_mod, pack)
    elif args.convnet_only:
        phase_convnet(torch, kernels)
    elif args.ema_only:
        phase_ema(torch, kernels, train_mod, get_config(ARCH))
    elif args.moe_only:
        phase_moe(torch, kernels, serve_mod, train_mod, serving, card)
    elif args.ssm_only:
        phase_ssm(torch, kernels, serve_mod, train_mod, serving, card)
    elif args.hybrid_only:
        phase_hybrid(torch, kernels, serve_mod, train_mod, serving, layers, ops,
                     ref, card)
    elif args.whisper_only:
        phase_whisper(torch, kernels, serve_mod, train_mod, serving, card)
    elif args.precision_only:
        phase_precision(torch, kernels, train_mod, serving, layers, card, True)
    elif not args.ops_only:
        err = phase_kernel(torch, ops, ref)
        rt = make_runtime("cuda")
        cfg = get_config(ARCH)
        params, launches, paged_fig = phase_serve(torch, kernels, serve_mod,
                                                  cfg, rt)
        phase_path(torch, cfg, params, Runtime, rt.device, serving)
        del params
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        params32, _ = serve_mod.load_model(cfg32, rt, seed=0)
        phase_path(torch, cfg32, params32, Runtime, rt.device, serving)
        del params32
        kernel_rows.append(phase_timing(torch, ops, ref, launches, err,
                                        cfg.n_layers, paged_fig["step_ms"]))
        phase_dense(torch, kernels, serve_mod, serving, layers, Runtime, cfg,
                    rt, paged_fig)
        t_serve = time.perf_counter()

        (p, g, u, a), errs = phase_mt_kernels(torch, mt_ops, mt_ref, cfg)
        rows.update(phase_mt_timing(torch, mt_ops, mt_ref, p, g, u, a, errs))
        del u, a
        torch.cuda.empty_cache()
        errs.update(phase_lamb_kernels(torch, mt_ops, mt_ref, p, g))
        torch.cuda.empty_cache()
        rows.update(phase_lamb_timing(torch, mt_ops, mt_ref, p, g, errs))
        torch.cuda.empty_cache()
        leaves, pl_errs = phase_per_leaf_kernels(torch, sngm, lars, p, g,
                                                 gemma_layout(torch, cfg))
        rows.update(phase_per_leaf_timing(torch, sngm, lars, leaves, pl_errs))
        del p, g, leaves
        torch.cuda.empty_cache()
        t_kernels = time.perf_counter()

        for run_name in TRAIN_RUNS:
            run, state, run_launches, step_s = phase_train(torch, kernels,
                                                           train_mod, run_name)
            phase_split(torch, run, state, step_s,
                        sum(TRAIN_RUNS[run_name][3].values()))
            for name in TRAIN_RUNS[run_name][3]:
                rows[name]["launches"] = run_launches[name]
            del run, state
            torch.cuda.empty_cache()
        phase_fused_vs_plain(torch, cfg)
        rows.update(chain_phases(torch, kernels, mt_ops, mt_ref, train_mod, cfg))
        with scratch_pack(cfg.vocab_size) as pack:
            ckpt_phases(torch, kernels, train_mod, pack)
            phase_data(torch, kernels, train_mod, pack)
        gc.collect()
        torch.cuda.empty_cache()
        phase_convnet(torch, kernels)
        phase_ema(torch, kernels, train_mod, cfg)
        phase_moe(torch, kernels, serve_mod, train_mod, serving, card)
        phase_ssm(torch, kernels, serve_mod, train_mod, serving, card)
        phase_hybrid(torch, kernels, serve_mod, train_mod, serving, layers, ops,
                     ref, card)
        phase_whisper(torch, kernels, serve_mod, train_mod, serving, card)
        phase_precision(torch, kernels, train_mod, serving, layers, card, False)
        t_train = time.perf_counter()

    if not (args.paged_only or args.chains_only or args.ckpt_only
            or args.data_only or args.convnet_only or args.ema_only
            or args.dense_only or args.moe_only or args.ssm_only
            or args.hybrid_only or args.whisper_only or args.precision_only):
        phase_ops_grid(torch, rms_ops, rms_ref, fa_ops, fa_ref)
        cases = ops_cases(torch)
        outs, ops_launches = phase_ops_path(torch, kernels, rms_ops, fa_ops, cases)
        ops_errs = phase_ops_check(torch, rms_ref, fa_ops, fa_ref, layers, cases, outs)
        del outs
        rows.update(phase_ops_timing(torch, rms_ops, rms_ref, fa_ops, fa_ref, cases,
                                     ops_errs, ops_launches))
    log(f"total {time.perf_counter() - t_start:.1f} s (serving phases "
        f"{t_serve - t_start:.1f} s, optimizer kernel phases "
        f"{t_kernels - t_serve:.1f} s, training phases "
        f"{t_train - t_kernels:.1f} s, op phases "
        f"{time.perf_counter() - t_train:.1f} s)")
    print(card, flush=True)            # name and power limit, again at the end
    print(json.dumps({"kernels": kernel_rows + [rows[k] for k in OPT_KERNELS
                                                 + ("rmsnorm", "flash_attention")
                                                 if k in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
