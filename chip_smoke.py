#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cadence_gemma_tpu_torch``) on one GPU.

  python3 chip_smoke.py

Phases, each of which raises on failure (so the script exits non-zero):

  1. card: the device's name, and its name and power limit from nvidia-smi;
  2. build: ``nvcc`` compiles every kernel under
     ``cadence_gemma_tpu_torch/csrc`` (one process per source, in parallel)
     and prints ptxas' registers and spills of each kernel, and the Hopper
     kernels' (the real and complex scans' TMA ring, the window forward,
     dq, dk/dv and the MHA) registers, local bytes and shared memory as
     launched;
  3. each forward kernel against its plain PyTorch version at the shapes of
     the serving path's prefill (batch 2 of 3000 tokens, the shorter prompt
     left-padded), with its time, the plain version's time, the least time
     the card could take (bound) and, where one PyTorch call computes the
     same function, that call's; for the attention kernels also the achieved
     TFLOP/s, the share of the bound and the ratio to SDPA, and the window
     forward again at the training step's [2, 4096, 10, 256]. The RG-LRU
     scans (here and in 5, 9 and 11) are timed by their device time with
     the launch queue full on copies of their inputs that exceed the L2,
     with GB/s, the share of the bound and the host's microseconds a call;
  4. the serving path: a full-width, full-depth RecurrentGemma-2B (random
     bf16 weights from a seeded ``torch.Generator``) behind a ``Sampler``
     generates 32 greedy tokens for two prompts longer than the attention
     window, its decode one step captured as a CUDA graph and replayed (a
     warm-up call of the same shapes captures it; here and in 8, 10 and 16
     a captured step's launches are counted by the wrappers' counters at
     its capture and multiplied by the replays, and decode ms a step comes
     from CUDA events around the decode loop). The kernels' launch
     counters, reset just before, must show that the prefill ran the RG-LRU
     kernel once per recurrent block and the attention kernel once per
     attention block, and that decode ran none;
     here and in 6, 8, 10 and 12 every real scan launch must have taken the
     TMA ring of ``csrc/lru_scan.cu``, none the per-thread walk.
     The inputs the prefill gave each kernel's first call are captured and
     the kernel's output on them held against its plain version; the same
     model's logits through the kernels are held against its plain path
     (sequential scan, einsum attention);
  5. each backward kernel (the RG-LRU cotangent scan, the attention's dq
     and dk/dv) against its plain version at the shapes of the training
     step (batch 2 of 4096 tokens, row 1 right-padded after 3000), timed
     as in 3; dq and dk/dv also print their TFLOP/s, share of the bound and
     resources, and their summed time against SDPA's backward (one
     boolean-masked call that computes dq, dk and dv together);
  6. the training path: ``train_loop`` takes 3 AdamW steps of full
     fine-tuning of a full-width, full-depth RecurrentGemma-2B (seeded
     random bf16 weights) on one repeated batch of 2 x 4096 tokens, the loss
     over the second half. The loss must be finite and fall, and the
     counters, reset just before, must show per step 36 forward and 18
     backward LRU launches and 16 forward, 8 dq and 8 dk/dv attention
     launches (each block's forward runs again in the backward under
     per-block rematerialization). The inputs the first step gave each
     backward kernel are captured and held against its plain version. On
     one 2100-token sequence the trained model's loss and gradient tree
     through the kernels are held, leaf by leaf, against its plain path;
  7. the towers' bidirectional MHA kernel against its plain version at the
     DINOv2-L and SigLIP-so400m shapes at 384 px ([2, 734, 16, 64] and
     [2, 729, 16, 72]) and at a longer sequence ([2, 1600, 16, 72], where
     the TPU needed its tiled kernel), and the fused residual add + RMSNorm
     kernel at the multimodal prefill's and a decode step's shapes, each
     timed by its device time with the launch queue full (CUDA events around
     calls enqueued behind a sleep on the card; add_rmsnorm's on copies of
     its inputs that exceed the L2 together), with the host's time a call
     beside it; the MHA's yardstick is one unmasked SDPA call,
     and each shape prints its TFLOP/s, share of the bound and ratio to it;
  8. the multimodal serving path: the DINOv2-L || SigLIP-so400m encoder at
     its published widths (blocks 0-22 of each) and a full-width, full-depth
     RecurrentGemma-2B with the fused epilogue, seeded random weights, behind
     a ``ModalSampler`` that takes raw [2, 3, 480, 640] pixels (resized on
     the card) and two 1400-token prompts, so the spliced prefill holds 2129
     tokens, and generates 32 greedy tokens. The counters, reset just
     before, must show 46 MHA launches (23 blocks of each tower), 18 LRU and
     8 window-attention launches in the prefill and none in decode, and 26
     add_rmsnorm launches in each of the 32 forwards (the prefill's and 31
     replays of the captured step's). Each kernel is held
     against its plain version on the inputs of its first call; the resize
     on the card against the CPU's; the fused features and the last
     position's logits against the plain path of the same weights (towers
     on the einsum, Griffin unfused, sequential scan, einsum attention).
     Then decode ms a step fused and unfused in turns, and an image turn
     with ``return_state`` followed by a text turn from its state (18 LRU
     launches with a carry, add_rmsnorm replayed in the captured step), the
     follow-up's first logits held against one teacher-forced call of the
     whole history with the image;

  9. the sequence-parallel variants of two kernels at the shapes of the SP
     prefill's shards: the RG-LRU kernel with the running product of ``a``
     (forward and backward walks, ``reverse`` false and true, [2, 4096,
     2560] bf16, bit for bit against the plain loops) and the window
     attention with a 2048-key halo (q [2, 4096, 10, 256], k and v
     [2, 6144, 1, 256]; a later shard's continuous positions, and shard 0's
     zero halo with a row left-padded by 1384), timed as in 3 with one
     boolean-masked SDPA call over the same band as the yardstick, and the
     same figures as in 3;
 10. the sequence-parallel serving path: a full-width, full-depth
     RecurrentGemma-2B (seeded random bf16 weights) with
     ``scan_sharding_spec`` on a (1, 4) data x sequence mesh (four shards on
     one card, or one on each of four) behind a ``Sampler``: prompts of 16384
     and 15000 tokens (the second left-padded by 1384, 4096 tokens a shard)
     and 32 greedy tokens. The counters, reset just before, must show 72 LRU
     launches with the running product (18 recurrent blocks x 4 shards) and
     32 attention launches with the halo (8 x 4) in the prefill, no
     unsharded scan or attention launch, and none in decode. Each kernel is
     held against its plain version on the inputs of its first call; the
     last position's logits against the same weights unsharded (a second
     ``Griffin`` from the same seed, through the unsharded kernels), whose
     generation's token agreement is printed; SP and unsharded prefill are
     timed in balanced turns;
 11. the sequence-parallel backward variants at the shapes of the SP
     training step's shards: the RG-LRU cotangent scan with the running
     product of ``a`` ([1, 4096, 2560] bf16, bit for bit against the plain
     loop) and the window attention's dq and dk/dv with a 2048-key halo
     (q [1, 4096, 10, 256], k and v [1, 6144, 1, 256]; shard 0's zero halo
     and a later shard), timed as in 5 with SDPA's backward over the same
     band as the yardstick;
 12. the sequence-parallel training path: ``train_loop`` takes 3 AdamW
     steps of a full-width, full-depth RecurrentGemma-2B (seeded random
     bf16 weights) with ``scan_sharding_spec`` on the (1, 4) mesh, on one
     repeated row of 16384 tokens right-padded after 15000, the loss over
     the second half of the real tokens. The loss must be finite and fall;
     the counters, reset just before, must show per step 144 LRU launches
     with the product (18 recurrent blocks x 4 shards, twice under remat),
     72 LRU backward launches with it, 64 halo attention forwards, 32 halo
     dq and 32 halo dk/dv, and none of the unsharded kernels. The first
     step's inputs to each backward kernel are held against its plain
     version; the SP gradients against the unsharded gradients of the same
     model on the same batch, leaf by leaf; SP and unsharded steps are
     timed in balanced turns;
 13. the complex-valued RG-LRU scan's four entry points (forward and
     backward walks, each with and without the running product of ``a``)
     at the 2B's ``lru_width``, [2, 4096, 2560] bf16 components with
     ``reverse`` and ``h0`` both ways and one float32 case, bit for bit
     against their plain loops, timed as the real scans in 3 (device time
     with the launch queue full on cold copies, GB/s, share of the bound,
     host us a call), on the TMA ring and, on copies TMA cannot describe,
     on the per-thread walk that ran them before the ring;
 14. the complex path: ``ops.scan.linear_scan`` of ``complex_lib.Complex``
     operands, forward and ``torch.autograd.grad`` of x, a and h0.
     Unsharded at [2, 4096, 2560] the counters, reset just before, must
     show one complex forward and one complex backward launch, and the
     kernel path is held against ``LINEAR_NATIVE`` on the same card;
     sequence-sharded over the (1, 4) mesh at [1, 16384, 2560] they must
     show 4 forwards and 4 backwards with the product and no unsharded
     complex launch; every complex launch of both runs must have taken the
     TMA ring of ``csrc/lru_scan_complex.cu``. The first shard's inputs to
     each kernel are held against its plain loop and timed as in 13 (batch
     1), and the results against the same call with no spec;
 15. the kernel lab: ``cadence_gemma_tpu_torch.benchmarks.kernel_lab.main()``
     at [1, 2048, 2560] bf16 (the scan kernel, variant A's sweep and
     variant B's, the JAX lab's own tiles), then variant A at every st and
     variant B at every tile of their sweeps against their plain versions,
     bit for bit, B's worst tile within one bf16 step of the sequential
     scan, A at st = 128 within 10 % of the scan kernel's line, and the
     spread of B's three st = 256 lines; then the probe: B at st = 256 and
     the library's forward scan on one SP shard's [1, 4096, 2560] bf16,
     timed as the scans in 3, B bit for bit there too;
 16. the serving features, run right after 4 on its 2B: the same prompts
     with ``prefill_chunk_size=1024`` (padded to 3072, three chunks: 54 LRU
     launches, all on the ring, no window-attention launch; the second
     chunk's first scan, whose carry comes from the cache, bit for bit
     against its plain loop; last logits against the single-shot prefill,
     time to the first token and peak memory of both in turns); a
     2048-token prefix at batch 1 continued by two calls of 2 x 512 tokens
     (18 LRU launches each with a carry; last logits against the full
     prompts in one call; the prefix's cache unchanged; time to the first
     token against the full prompts' in turns); three conversation turns
     with ``return_state``, each turn's first logits against a
     teacher-forced call of the whole history; captured against eager
     decode in turns (decode ms a step, greedy tokens identical, logits'
     largest difference), and categorical sampling (temperature 0.8, top-k
     50, top-p 0.95) and greedy with ``repetition_penalty=1.3``, each
     captured and eager from generators seeded alike: identical tokens and
     generator offsets.
 17. continuous batching and the HTTP front end, run after 16 on 4's 2B:
     (a) a one-slot ``ContinuousBatcher`` with one 3000-token request,
     whose greedy tokens must equal the solo Sampler's; (b) an eight-slot
     batcher (``admission_chunks_per_tick=1``, ``per_request_sampling``,
     ``record_logprobs``) takes 16 requests of 64 tokens that join over its
     ticks -- a 3000-token single shot (the window kernel), the same length
     in chunks of 1024, two continuations of one shared 2048-token prefix,
     four categorical and eight greedy prompts of 300-1500 tokens, each
     with a repetition penalty (the random weights otherwise repeat a
     token at probability ~1) -- in two join orders: the counters, reset
     before each, must show the admissions' LRU and attention launches as
     their chunks and lengths predict, all on the ring, and none in the
     ticks; the window kernel's
     and a continued chunk's scan inputs held against their plain versions;
     every request's tokens, greedy and categorical, identical between the
     orders; its recorded log-probabilities held against a teacher-forced
     batch-1 forward; the greedy ones' token agreement with solo batch-1
     calls printed; (c) time to the first token from submission (p50,
     p90), each tick's time by the admission work it did (the stall of one
     chunk), and the eight-slot tick's ms a step and tokens/s against the
     Sampler's captured batch-2 step in turns (with ``--profile`` the
     tick's idle share); (d) ``ServingHTTPServer`` on 127.0.0.1 (its driver
     thread captures its own tick): ``/v1/generate`` plain (tokens equal to
     a direct batcher run at the same width) and streaming, a two-turn
     session, ``/v1/chat/completions`` streaming, ``/v1/completions`` with
     ``n=2``, ``/v1/cancel``, ``/v1/health`` and ``/metrics``, every body
     well-formed.
 18. int8 serving: a full-width, full-depth RecurrentGemma-2B drawn by
     ``checkpoint.synthetic.realistic_params`` (bf16) and its
     ``quantize_params`` copy (``Griffin(quantized=True)``), and the two
     towers in float32 and int8 with ``act_quant``. The int8 text run (the
     phase-4 prompts, 32 greedy steps, ``prefill_act_quant=True``): the
     counters, reset just before, must show the prefill's weight-only
     launches (the gates' 36 at 6000 rows on the wgmma kernel, the logits'
     one on the mma.sync kernel) and ``torch._int_mm`` products (every
     other projection), and a captured decode step that launches the
     mma.sync kernel once for each int8 layer and the logits (175) and no
     ``_int_mm``; a weight-only prefill (``prefill_act_quant=False``) its
     174 block products on the wgmma kernel. The kernels are held against
     their plain version on the inputs of their first call at every shape
     the run gave them, each into its own row, and timed
     there (device time, queue full, cold copies) beside its plain version,
     a bf16 product on a stored bf16 weight, dequantize + matmul and its
     byte or operation bound; at one projection's prefill shape ([6000,
     2560] x [2560, 2560]) also ``quantize_activations``, ``torch._int_mm``
     and the whole ``act_quant`` layer. Int8 against bf16 on the same weights: the
     first-token logits' largest difference over the largest bf16 logit
     (with act_quant, and weight-only) and the greedy tokens' agreement;
     then, in turns, the text prefill (bf16, ``act_quant``, weight-only)
     and the captured decode step, pixels
     to the first token through the int8 towers (their encode: 46 MHA and
     184 ``_int_mm`` launches, no weight-only one) and the eight-slot
     captured tick.
 19. multimodal fine-tuning, after 21: a full-width, full-depth
     RecurrentGemma-2B (seeded bf16) and the two towers as in 8 (384 px,
     blocks 0-22, frozen), one batch of seeded [2, 3, 384, 384] pixels and
     2 x 2048 text tokens (row 1 right-padded after 1500), 2777 spliced
     tokens a row. (a) ``two_stage_sft``: 3 frozen-connector steps, which
     must leave every other parameter bit for bit and move the connector,
     then 2 full steps, which must move the embedder; the counters, reset
     just before, must show per step 36 LRU, 18 LRU backward, 16 window
     attention, 8 dq, 8 dk/dv and 46 MHA launches and no int8 one, for
     each stage. (b) 3 ``train_loop(lora=True)`` steps of rank-8 adapters
     on the bf16 base (the base bit for bit, every ``lora_b`` moved),
     prefetching 2 batches and saving ``step_2`` asynchronously (the save's
     host seconds, the device time its snapshot holds the stream, the
     write's bytes and seconds), and
     ``merge_lora``'s plain model against the LoRA model (last prefill
     logits, rel. RMS within 5e-2 and within half the base's without
     adapters). (c) 3 QLoRA steps on the base's ``quantize_params`` copy
     with fresh bf16 adapters: every int8 product on the wgmma forward and
     input-gradient kernels and none on the mma.sync pair (the others as
     in (a)), the base bit for bit; both int8
     kernels held against their plain versions on the first inputs of each
     shape the step gave them (the logits' [1, 4096, 2560] x [256000,
     2560] forward and [1, 4096, 256000] x [256000, 2560] gradient, the
     fused up-projection's shared activation and summed pair among them)
     and both timed at the logits', a [2560 -> 2560] projection's and the
     up-projection's beside the library composition;
     the adapters' gradients through the kernels against the plain path
     (every int8 product plain; rel. RMS 0.1, cosine 0.99 a leaf); 16
     greedy steps of the QLoRA model through the ``Sampler``, captured and
     eager identical. Each stage's step ms, real tokens/s and peak memory.
 20. adapters end to end, after 19 on its models: (a) ``load_parameters``
     of 19(b)'s ``step_2`` onto the card (bytes, seconds); a fresh model of
     its base with re-drawn adapters runs ``train_loop`` with a
     ``PreemptionHandler`` triggered after step 1, which must write
     ``preempted_step_2`` synchronously and return, then resumes from
     ``step_2`` for step 3, whose adapters must equal the uninterrupted
     run's bit for bit (or within 1e-3 rel. RMS a leaf); (b) an 8-slot
     ``multi_lora`` batcher on that base (its own adapters zero) takes 16
     greedy requests of 32 tokens with a repetition penalty (one of 3000
     tokens, on the window kernel, the rest of 300-1500), their adapters
     cycling through the step-2 ones, the final ones and none, in two join
     orders on the captured tick and once on the eager tick: identical
     tokens; the counters, reset before each, must show the admissions' LRU
     and window launches and none in the ticks; the tick's twin shares
     every base tensor with the sampler's model; each request's first-token
     logits within 5e-2 rel. RMS of a solo batch-1 ``Sampler`` on the
     merged weights (token agreement printed); the multi-LoRA tick against
     the plain tick of the same model in turns, and one admission's stall
     with and without adapters; (c) a 4-slot ``multi_lora`` batcher on
     19(c)'s QLoRA model (its trained adapters, fresh ones, zeros and none):
     a tick step launches the mma.sync int8 kernel 175 times and nothing
     else, the kernel held against its plain version on the first tick's
     inputs, captured and eager tokens identical; (d) ``ServingHTTPServer``
     with an ``adapter_resolver`` over the loaded adapters: ``/v1/generate``
     with ``"adapter"`` gives the direct batcher's tokens, an unknown name
     and a server without a resolver answer 400. The checkpoints live in a
     temporary directory removed at the end.
 21. speculative decoding, right after 18 on its ``realistic_params`` 2B,
     its int8 copy and its bf16 towers (draft_len 7, ngram 2): (a) the
     verify's fp32-carry walk (``lru_scan.lru_scan_carries``: the forward
     kernel on float32 copies of x and a) at [2, 8, 2560] and [8, 8, 2560]
     with h0, bit for bit against its plain loop, its bf16 cast equal to
     the bf16 walk's y, timed (a row of the kernels line); (b) a
     ``SpeculativeSampler`` over the bf16 Sampler on JAX's speculative
     workload (batch 1, a 128-token prompt cycling through 8 words, 256
     steps), a seeded non-repeating 128-token prompt (128 steps) and
     phase 4's prompts (32 steps): a captured verify step must launch the
     fp32-carry walk once for each recurrent block (18) and no other
     kernel of the table; greedy tokens against the captured plain
     Sampler's, identical or first differing where the plain run's two
     largest logits lie within 1 % of the larger (each first difference
     printed with that gap); ``tokens_per_verify_step``; captured against
     eager speculation, greedy and categorical from one generator seed,
     identical; verify ms a step against decode ms a step and speculative
     against plain tokens/s, in turns; (c) the same on the int8 copy,
     whose verify step launches the ``mma.sync`` int8 kernel once for each
     int8 layer and the logits (175); (d) one image encoded by the towers
     (46 MHA launches) through the fused-epilogue view of the 2B (26
     add_rmsnorm launches a verify step), against the plain Sampler; (e)
     an 8-slot batcher with ``draft_len`` taking phase 17's sixteen
     requests (greedy, no penalty) in two join orders (identical tokens;
     each request against a solo plain Sampler by the rule above), the
     speculative tick against the plain tick in turns (ms a step, emitted
     tokens/s), a 4-slot ``multi_lora`` speculative batcher on a rank-8
     model of the same base against solo Samplers on the merged weights,
     and ``ServingHTTPServer`` at 4 slots over a speculative batcher
     (``/v1/generate`` plain, streamed, cut by ``max_tokens`` and in a
     two-turn session, each as the direct batcher's tokens);
 22. grammar-constrained decoding (right after 21, on phase 18's models
     and towers) over a seeded 256000-piece vocabulary (the printable
     ASCII characters, JSON pieces, digit runs, words of 2-16 letters):
     (a) a choice of three words, JSON mode (``json_regex``, depth 3) and
     a JSON schema with enum-bounded strings, each compiled by the native
     walker (``native/constrain.cc``; a missing build fails), with its
     host seconds, states, atoms, unique token rows and table MB; (b) each
     grammar's device tables against the host mirrors on 4096 seeded
     (state, token) pairs and 16 whole rows; (c) the constrained Sampler
     on two 3000-token prompts, bf16 and int8 (a captured int8 step
     launches 175 ``mma.sync``), every output a live prefix of its grammar
     and every stopped one a full match (the choice must stop on an
     option), greedy and categorical captured against eager in turns
     (identical tokens and generator states); (d) the captured constrained
     decode step against the plain one in turns, kernels a step by the
     profiler; (e) the constrained ``ModalSampler`` on one image through
     the fused-epilogue view (46 MHA, 26 ``add_rmsnorm`` a step); (f)
     ``SpeculativeSampler`` with a grammar against constrained plain
     greedy (identical, or a near tie among the allowed logits), the
     constrained verify step against the plain one in turns; (g) the
     8-slot batcher with three static grammars, free slots and a grammar
     registered while it runs, plain and speculative, its free slots'
     tokens equal to an unconstrained batcher's, and the constrained tick
     against the plain tick in turns; (h) HTTP: ``response_format``
     ``json_object`` and ``json_schema``, a forced ``tool_choice`` and its
     stream, each answer inside its grammar.
 23. the serving export (right after 22, on phase 18's models): the first
     3 blocks of the bf16 2B at full width (R, R, A: one window attention),
     their fused-epilogue view and their weight-only int8 copy exported by
     ``checkpoint.export.export_serving`` at phase 4's bucket (2 x 3000,
     row 2 left-padded from 2300), each artifact's bytes and host seconds
     to export; saved, loaded here and in a fresh ``python3`` process that
     builds no ``Griffin`` and reads the weights from ``checkpoint/io``
     checkpoints. Each loaded prefill's logits and cache against the live
     ``Griffin.forward`` (bit for bit, or rel. RMS 5e-2), the greedy
     tokens of each loaded chain (eager steps, the loaded step captured in
     a CUDA graph, and the fresh process's) against the Sampler's captured
     decode, token for token, and the fresh process's prefill logits bit
     for bit. The counters of a loaded prefill and decode step must show
     4 LRU and 2 window launches (bf16), 6 add_rmsnorm a forward more
     with the fused epilogue, 40 ``wgmma`` + 1 ``mma.sync`` (int8
     prefill) and 41 ``mma.sync`` (int8 step). ``torch.library.opcheck``
     (schema, fake tensor) of every operator on the card: at the loaded
     path's first inputs and, for the operators no loaded program calls,
     at small shapes. The loaded prefill, eager decode step and captured
     step against the live path in turns (bf16, int8), and the host us a
     call through an operator against the direct launch.
 24. the command-line programs (right after 23, on phase 18's 2B: its
     bf16 checkpoint, phase 22's vocabulary written as a SentencePiece
     model, seeded towers and two rank-8 adapter trees as port
     checkpoints): (a) ``python3 -m cadence_gemma_tpu_torch.examples.
     sampling`` in a fresh process on a 2540- and a 340-token prompt, 32
     steps, its printed texts equal to an in-process ``Sampler``'s (whose
     prefill must launch 18 LRU and 8 window kernels); (b) ``serve.main``
     in its requests mode (4 requests, 4 slots) plain, ``--int8``,
     ``--speculative`` (texts equal to plain, or the in-process pair
     differing first at a near tie) and ``--adapter_path`` twice, then
     ``--http_port 0 --json_mode`` in a fresh process: ``/v1/generate``, a
     ``json_object`` chat that must parse as JSON, SIGINT and a clean exit;
     (c) ``cadence.main`` on ``tests/fixtures/dog.jpg``, its text equal to
     an in-process ``ModalSampler``'s (46 MHA launches); (d)
     ``finetune.main`` with QLoRA rank 8, 4 records at 729 + 2560 tokens, 2
     + 2 steps logged to jsonl at every step (the stage configs'
     ``eval_every_n`` set to 1 for the run): 4 finite losses, the backward
     kernels and both int8 kernels launched, ``{output_dir}/final`` loaded
     and sampled; (e) ``simple_run.main`` at 2560 x 26, then
     ``utils.profiling.trace`` around a Sampler call (its Chrome trace must
     name the LRU scan's kernel) and ``device_memory_stats`` (a peak above
     0 and at most the card's memory). Each run's host seconds and launches
     are printed, and its launches added to the kernels line.
 25. tensor-parallel serving (right after 22, on phase 18's models) over a
     (1, 2) mesh that repeats the card: the TP Sampler, its kernels'
     first shard calls against their plain versions and timed, the
     unsharded model in turns, TP-4, the fused epilogue, int8, an 8-slot
     TP batcher and TP speculation.
 26. tensor-parallel training (right after 25): a copy of phase 18's 2B
     at the training batch (2 x 4096, row 1 padded after 3000, remat on).
     One step's loss and every leaf's gradient on TP-2 (1, 2), DP x TP
     (2, 2) and TP-4 (1, 4) against the unsharded model's (loss within
     1e-2, rel. RMS 0.1 and cosine 0.99 a leaf); the counters must show a
     step's 2 x 18 LRU, 18 LRU backward, 2 x 8 window, 8 dq and 8 dk/dv
     launches a shard (72, 36, 32, 16, 16 on TP-2). Each kernel held
     against its plain version on the first inputs the run gave it (the
     scans bit for bit, dq / dk / dv within 2e-2 of the largest gradient)
     and timed at those shard shapes. ``train_loop(mesh=)`` on TP-2 for 3
     steps in turns with the unsharded loop (step ms, peak GB). QLoRA on
     the int8 copy's own tensors with rank-8 adapters: one TP-2 step's
     adapter gradients against the unsharded QLoRA step's, on the wgmma
     forward and input-gradient kernels alone, both held against their
     plain versions at every shard shape and timed at the row- and
     column-parallel pieces and the vocabulary shard's logits. The phase's
     launches, errors and shard-shape figures join the kernels line's rows.
 27. the sharded towers, TP multi-LoRA and the TP export (right after 26,
     on phase 18's models, meshes repeating the card): (a) a TP-2
     ``ModalSampler`` (towers placed by the ViT rules, float32 pieces
     views) against the unsharded one on [2,3,480,640] pixels and two
     1400-token prompts, 32 greedy steps, the 2B with the fused epilogue:
     92 MHA launches an encode at 8 heads a shard (184 at TP-4, 4 heads),
     no input copied, each shard shape's kernel within 2e-2 of its plain
     version and timed; features and first-token logits rel. RMS <= 5e-2,
     tokens identical or first differing at a 1 % tie; the image
     prefill's first shard calls of the scan, window attention and fused
     epilogue against their plain versions and timed; encode and pixels ->
     first token ms in turns; the int8 towers (act_quant, then
     weight-only: 368 wgmma launches at the shard shapes) against their
     unsharded encodes. (b) 8-slot multi-LoRA batchers (rank 8, lora_b std
     2.0) over TP-2 and unsharded samplers on 8 requests: TP captured =
     eager = a second join order, each request against a solo TP Sampler
     and the unsharded batcher (identical or a 1 % tie), float32 copies'
     TP and unsharded logits along the unsharded tokens within 1e-3
     (rel. RMS); the steady tick in turns. (c) the bf16 2B's first 3
     blocks at full width exported at (2, 3000) over a (1, 2) mesh, saved
     and loaded: the loaded prefill bit for bit the live TP forward, its
     greedy chain token for token the TP Sampler's; a TP-4 mesh refused.
     The phase's launches and shard-shape figures join the kernels line.
 28. pipeline parallelism (right after 27, on phase 18's models: the
     whole 2B, 24 blocks pipelined and 2 in the tail) over stage meshes
     from ``multihost.make_hybrid_mesh`` that repeat the card, at 4 x 4096
     tokens (row 1 right-padded after 3000, the loss over the second half
     of each row): (a) GPipe, S = 4, M = 4 (microbatches of 1 x 4096): a
     forward with no gradient must launch 16 x 4 + 2 = 66 LRU and 8 x 4 =
     32 window kernels, none in the schedule's 12 bubble slots, every scan
     on the ring, its last logits within 5e-2 (rel. RMS) of the unsharded
     forward; one training step (per-chunk remat) must launch 130 LRU, 66
     LRU backward, 64 window, 32 dq and 32 dk/dv kernels, its loss within
     1e-2 and every unstacked leaf's gradient within rel. RMS 0.1 and
     cosine 0.99 of the unsharded model's; the kernels on the first
     microbatch inputs the step gave them against their plain versions
     (scans bit for bit, the rest within 2e-2) and timed there; (b)
     interleaved v = 2 (eight chunks of 3 blocks) and (c) PP x DP on a
     (stage 2, data 2) mesh with M = 2: the same launches, loss and
     gradient checks, schedule steps and bubble fractions printed; (d) the
     int8 copy's forward: its ``wgmma`` launches (each microbatch's int8
     layers, the tail's on the whole batch) and one ``mma.sync`` (the last
     logits), the kernel against its plain version at every shape and
     timed at the microbatch's, its last logits within 5e-2 of the
     unsharded int8 forward; (e) three ``make_train_step`` AdamW steps
     (the loss must fall) in turns with three unsharded
     ``trainer.train_step`` steps (step ms, peak GB; the ratio printed, not
     bounded: one card runs every stage in turn). The phase's launches,
     errors and microbatch shapes join the kernels line.
 29. one process a card (after 24, where the parent holds no model):
     ranks spawned as fresh interpreters of this script (torch and the
     port alone). (a) Two gloo ranks on the card: the pmap-regime scan
     (each rank half of [2, 8192, 2560] bf16, axis ``seq`` bound to the
     group) and the channel-split scan over a (seq 2, model 2) process
     mesh, forward and backward on the kernel path, bit for bit against
     the single-controller meshes that repeat the card, and rank 0's
     product scans (forward and backward, both regimes' shapes) bit for
     bit against their plain versions; (b) the same ranks
     train the 2B at width 2560 and 6 blocks (two replicas with AdamW fit
     on one card) with three ``train_loop(mesh=)`` steps a turn over
     ``make_hybrid_mesh((1,), ("model",), dcn_axis_names=("data",))``,
     one row of phase 6's batch a rank: the replicas' bits equal after
     every step, 8 LRU, 4 LRU backward, 4 window, 2 dq and 2 dk/dv
     launches a rank and step, the losses within 1e-6 of the
     single-controller loop over a (2,) data mesh, every step's loss
     within 1e-2 nats of the unsharded loop's, step 1's gradients, the
     final weights and the three steps' updates within phase 26's leaf
     limits of the unsharded loop's, each training kernel on rank 0's first inputs against its plain version;
     the DP turns in turns with rank 0's single-controller and unsharded
     loops (steady step ms, the gradient all-reduce's ms and share, peak GB
     a rank); on a machine with two cards, (b) again over NCCL, a card a
     rank; (c) one process, NCCL in a group of one: a step over two data
     rows whose gradient all-reduces go through the communicator, its loss
     equal to (b)'s single-controller first step. The launches of every
     rank join the kernels line.

  python3 chip_smoke.py --profile

adds kernel time by name (torch.profiler) for the prefill and decode of the
serving path (and the idle share of captured and eager decode, and of the
eight-slot batcher's tick), for one training step, for the encode and the
image-conditioned prefill, for the sequence-parallel prefill and for one
sequence-parallel training step, with the device's idle share; for
phase 18, the int8 and bf16 text serving and the int8 eight-slot tick; for
phase 19, one QLoRA step.

Needs a CUDA card and the CUDA toolkit (``nvcc``); without a card it exits
with status 1 and prints no result. The line before the last is a JSON
object ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import inspect
import io
import itertools
import json
import math
import os
import re
import shutil
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

from cadence_gemma_tpu_torch import _build
from cadence_gemma_tpu_torch import common
from cadence_gemma_tpu_torch import complex_lib
from cadence_gemma_tpu_torch import tokenizers
from cadence_gemma_tpu_torch.benchmarks import kernel_lab
from cadence_gemma_tpu_torch.benchmarks.kernel_lab import cuda_ms
from cadence_gemma_tpu_torch.benchmarks.kernel_lab import device_ms
from cadence_gemma_tpu_torch.checkpoint import export as export_lib
from cadence_gemma_tpu_torch.checkpoint import io as checkpoint_io
from cadence_gemma_tpu_torch.checkpoint import synthetic
from cadence_gemma_tpu_torch.examples import cadence as cli_cadence
from cadence_gemma_tpu_torch.examples import finetune as cli_finetune
from cadence_gemma_tpu_torch.examples import serve as cli_serve
from cadence_gemma_tpu_torch.examples import simple_run as cli_simple_run
from cadence_gemma_tpu_torch.inference import constrain
from cadence_gemma_tpu_torch.inference import modal_sampler
from cadence_gemma_tpu_torch.inference import sampler as sampler_lib
from cadence_gemma_tpu_torch.inference import server as server_lib
from cadence_gemma_tpu_torch.inference import serving
from cadence_gemma_tpu_torch.inference import speculative
from cadence_gemma_tpu_torch.models import griffin
from cadence_gemma_tpu_torch.models import vit
from cadence_gemma_tpu_torch.ops import fused_epilogue
from cadence_gemma_tpu_torch.ops import int8_matmul
from cadence_gemma_tpu_torch.ops import library as op_library
from cadence_gemma_tpu_torch.ops import lru_scan
from cadence_gemma_tpu_torch.ops import mha_attention
from cadence_gemma_tpu_torch.ops import quantization
from cadence_gemma_tpu_torch.ops import scan as scan_lib
from cadence_gemma_tpu_torch.ops import window_attention as wa
from cadence_gemma_tpu_torch.parallel import data_parallel as data_parallel_lib
from cadence_gemma_tpu_torch.parallel import multihost
from cadence_gemma_tpu_torch.parallel import partitioning
from cadence_gemma_tpu_torch.parallel import pipeline
from cadence_gemma_tpu_torch.parallel import sharding
from cadence_gemma_tpu_torch.parallel import tensor_parallel
from cadence_gemma_tpu_torch.tokenizers import SimpleVocab
from cadence_gemma_tpu_torch.training import data as data_lib
from cadence_gemma_tpu_torch.training import lora as sft_lora
from cadence_gemma_tpu_torch.training import train_loop as train_loop_lib
from cadence_gemma_tpu_torch.training import trainer
from cadence_gemma_tpu_torch.utils import constrain_cpp
from cadence_gemma_tpu_torch.utils import profiling
from cadence_gemma_tpu_torch.utils import resilience

# Published peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
INT8_TENSOR_OPS = 1979e12
FP32_FLOPS = 67e12

SEED = 0
PROMPT_TOKENS = (3000, 2300)
DECODE_STEPS = 32
# The main path's RecurrentGemma-2B prefill: batch 2, padded to the longer
# prompt; lru_width 2560; 10 query heads of 256 over one KV head, window 2048.
PREFILL_TOKENS = max(PROMPT_TOKENS)
LRU_SHAPE = (2, PREFILL_TOKENS, 2560)
ATTN_SHAPE = (2, PREFILL_TOKENS, 10, 256)
ATTN_WINDOW = 2048
# Row 1 is left-padded as the Sampler pads the shorter prompt
# (segment_pos = -1 on its first ATTN_PAD positions); row 0 starts a second
# document at ATTN_BOUNDARY.
ATTN_PAD = PREFILL_TOKENS - min(PROMPT_TOKENS)
ATTN_BOUNDARY = 1500
REFERENCE_PROMPT_TOKENS = 2100

# The kernel and the plain loop do the same two separately rounded float32
# operations per step in the same order: the results are bit-identical.
LRU_MAX_ABS_ERR = 0.0
# Same bf16 inputs; the kernel rounds its unnormalized probabilities to bf16
# before PV (the plain version keeps float32), and both round the output to
# bf16: 2e-2 covers those roundings at |out| < 2.
ATTN_OUT_MAX_ABS_ERR = 2e-2
# Softmax statistics are float32 on both sides, summed in another order.
ATTN_LSE_MAX_ABS_ERR = 1e-3
# Kernel path vs plain path of the whole bf16 model: bf16 rounding at other
# places (probabilities before PV) compounds over 26 blocks. Relative RMS of
# the difference of the last position's logits.
MODEL_LOGITS_REL_RMS = 5e-2

# The training path: RecurrentGemma-2B, batch 2 x 4096 tokens, row 1 holds
# 3000 real tokens and is right-padded (its positions repeat the last one);
# the loss covers the second half of each row's real tokens.
TRAIN_TOKENS = 4096
TRAIN_REAL_TOKENS = (4096, 3000)
TRAIN_STEPS = 3
# AdamW's learning rate for the smoke: large enough that 3 steps on one
# repeated batch lower the loss of bf16 weights.
TRAIN_LEARNING_RATE = 1e-3
LRU_TRAIN_SHAPE = (2, TRAIN_TOKENS, 2560)
ATTN_TRAIN_SHAPE = (2, TRAIN_TOKENS, 10, 256)
GRAD_REFERENCE_TOKENS = 2100

# The cotangent scan repeats its plain loop's float32 add and multiply in the
# same order: bit-identical.
LRU_BWD_MAX_ABS_ERR = 0.0
# dq, dk, dv: the kernels round p and ds to bf16 before their products and
# the results to bf16; the plain versions keep float32 to the end. Error
# bound as a fraction of the largest gradient (about 2^-8 expected).
ATTN_BWD_REL_ERR = 2e-2
# Kernel path vs plain path of the bf16 2B's loss and gradients (the plain
# path's einsum attention and autograd of the sequential scan round at other
# places), per parameter leaf.
MODEL_LOSS_REL_ERR = 1e-2
GRAD_LEAF_REL_RMS = 0.1
GRAD_LEAF_MIN_COSINE = 0.99
# Against the plain path of a float32 copy of the model both bf16 paths are
# off by bf16's own rounding (~6e-2 per leaf at the median); the kernels may
# add at most a tenth to the plain path's median distance.
GRAD_F32_MEDIAN_RATIO = 1.1

LRU_REPLACES = "cadence_gemma_tpu/ops/pallas_lru.py:265"
ATTN_REPLACES = "cadence_gemma_tpu/ops/pallas_attention.py:207"
LRU_BWD_REPLACES = "cadence_gemma_tpu/ops/pallas_lru.py:265"
DQ_REPLACES = "cadence_gemma_tpu/ops/pallas_attention.py:295"
DKV_REPLACES = "cadence_gemma_tpu/ops/pallas_attention.py:360"
# One CUDA kernel replaces both TPU MHA kernels: the one-pass
# _flash_mha_onepass (:749, the towers' regime) and the tiled
# _flash_mha_forward (:776, t_pad > 1024).
MHA_REPLACES = "cadence_gemma_tpu/ops/pallas_attention.py:749"
RMSNORM_REPLACES = "cadence_gemma_tpu/ops/fused_epilogue.py:70"
# The sequence-parallel variants: _lru_pallas_call with compute_a_prod=True
# (called from _sharded_scan, pallas_lru.py:471) and _flash_window_forward
# with kv_prefix.
LRU_A_PROD_REPLACES = "cadence_gemma_tpu/ops/pallas_lru.py:265"
ATTN_PREFIX_REPLACES = "cadence_gemma_tpu/ops/pallas_attention.py:207"
# The backward walk with the product: the same pallas_call, launched from
# _lru_bwd (:516) through _sharded_scan(backprop=True).
LRU_BWD_A_PROD_REPLACES = "cadence_gemma_tpu/ops/pallas_lru.py:265"

# The towers' attention: DINOv2-L (729 patches + 5 prefix tokens, head_dim
# 64) and SigLIP-so400m (729, head_dim 72) at 384 px, batch 2; then a longer
# sequence, where the TPU needed its tiled kernel. The first is the row of
# the kernels line.
MHA_SHAPES = ((2, 734, 16, 64), (2, 729, 16, 72), (2, 1600, 16, 72))
# Same bf16 inputs; both round unnormalized probabilities to bf16 before PV
# (the kernel against the running max of its tiles) and the output to bf16:
# 2e-2 covers those roundings at |out| < 2.
MHA_MAX_ABS_ERR = 2e-2
# The fused epilogue at the multimodal prefill (2 x 2129 rows) and at a
# decode step (2 rows); the first is the row of the kernels line.
RMSNORM_SHAPES = ((2, 2129, 2560), (2, 1, 2560))
# y: one rounding of the same float32 sum on both sides (exact). normed:
# float32 statistics summed in another order, then one bf16 rounding: at
# most one bf16 ulp, 2^-8 relative; 2^-7 of |normed| allows for both.
RMSNORM_NORMED_REL_ERR = 2**-7

# The multimodal serving path: raw pixels resized on the card, two prompts
# of 1400 tokens (BOS + 1399 words), 729 visual tokens spliced after BOS.
MM_PIXELS = (2, 3, 480, 640)
MM_PROMPT_TOKENS = 1400
MM_DECODE_STEPS = 32
# The resize on the card vs on the CPU: the same float32 weights summed in
# another order.
RESIZE_MAX_ABS_ERR = 1e-4
# Kernel path vs plain path of the bf16 encoder: the kernel rounds
# unnormalized probabilities to bf16 where the einsum rounds normalized
# ones, and each path rounds its own activations to bf16, over 23 blocks of
# each tower. Relative RMS of the difference of the fused features.
MM_FEATURES_REL_RMS = 5e-2
# Kernel path vs plain path from pixels to the last position's logits: the
# towers' difference above carried through the connector and 26 blocks in
# which the fused epilogue also reduces in float32 where the plain RMSNorm
# reduces in bf16 (as MODEL_LOGITS_REL_RMS for the text path).
MM_LOGITS_REL_RMS = 5e-2

# The sequence-parallel serving path: a (1, 4) data x sequence mesh, prompts
# of 16384 and 15000 tokens (the second left-padded by 1384, inside shard 0),
# 4096 tokens a shard, each shard's attention against a 2048-key halo.
SP_SHARDS = 4
SP_PROMPT_TOKENS = (16384, 15000)
SP_DECODE_STEPS = 32
SP_LOCAL_TOKENS = max(SP_PROMPT_TOKENS) // SP_SHARDS
SP_PAD = max(SP_PROMPT_TOKENS) - min(SP_PROMPT_TOKENS)
LRU_SP_SHAPE = (2, SP_LOCAL_TOKENS, 2560)
ATTN_SP_SHAPE = (2, SP_LOCAL_TOKENS, 10, 256)
# The running product is one more separately rounded float32 multiply a step
# on both sides: bit-identical, as the scan itself.
LRU_A_PROD_MAX_ABS_ERR = 0.0
# SP vs unsharded logits of the same bf16 weights: the correction
# y + h0 * a_prod is a bf16 multiply and add (as the JAX package computes
# it), which the unsharded scan does not round; the kernels' own differences
# as MODEL_LOGITS_REL_RMS.
SP_LOGITS_REL_RMS = 5e-2
# Turns of SP (True) and unsharded (False) prefills, balanced against linear
# and quadratic drift as EPILOGUE_TURNS below.
SP_TURNS = (True, False, False, True, False, True, True, False)

# The sequence-parallel training path: the same (1, 4) mesh, one row of
# 16384 tokens right-padded after 15000 (inside shard 3), 4096 tokens a
# shard, the loss over the second half of the real tokens.
SP_TRAIN_TOKENS = 16384
SP_TRAIN_REAL_TOKENS = 15000
SP_TRAIN_STEPS = 3
SP_TRAIN_LOCAL_TOKENS = SP_TRAIN_TOKENS // SP_SHARDS
LRU_SP_TRAIN_SHAPE = (1, SP_TRAIN_LOCAL_TOKENS, 2560)
ATTN_SP_TRAIN_SHAPE = (1, SP_TRAIN_LOCAL_TOKENS, 10, 256)
# Turns of SP (True) and unsharded (False) training steps.
SP_TRAIN_TURNS = (True, False, False, True)

# The complex scan at the 2B's lru_width: batch 2 x 4096 steps, bf16
# components (and one float32 case); its path through ops.scan.linear_scan
# unsharded at that shape and sequence-sharded over the (1, 4) mesh at
# 1 x 16384.
LRU_COMPLEX_SHAPE = (2, 4096, 2560)
LRU_COMPLEX_SP_SHAPE = (1, 16384, 2560)
# Every product and sum rounded alone in the same order on both sides.
LRU_COMPLEX_MAX_ABS_ERR = 0.0
# The replaced TPU kernel: the complex body of _lru_pallas_call, in all four
# of its uses (forward, backward; each with compute_a_prod).
LRU_COMPLEX_REPLACES = "cadence_gemma_tpu/ops/pallas_lru.py:171"
# Kernel path vs LINEAR_NATIVE on one card: y and h_last bit for bit (the
# kernels' bits are the plain loop's); the gradients of x and h0 (the
# cotangent walk against autograd of the loop) by relative RMS. The decay's
# gradient differs by bf16 rounding: the kernel path, as JAX's _lru_bwd,
# multiplies dx by the bf16 outputs y in bf16, autograd of the loop by the
# float32 carry in float32; one bf16 step is 2^-8 relative.
COMPLEX_PATH_GRAD_REL_RMS = 1e-6
COMPLEX_PATH_DA_REL_RMS = 1e-2
# SP vs unsharded: the correction y + h0 * a_prod in bf16 (as the JAX
# package computes it), which the unsharded scan does not round; h_last in
# float32 relative to its largest value; gradients per operand. Each limit
# is about ten times the reading on an H100 (y 1.3e-4, h_last 0, gradients
# 2.2e-4 and cosine 1.000000): the product of `a` decays within a few steps
# of a shard's start, so few outputs take a correction at all.
COMPLEX_SP_Y_REL_RMS = 2e-3
COMPLEX_SP_H_REL_ERR = 1e-5
COMPLEX_SP_GRAD_REL_RMS = 5e-3
COMPLEX_SP_GRAD_MIN_COSINE = 0.9999

# The kernel lab: one configuration of each variant, held bit for bit
# against its plain version (A's is the sequential scan); B's association
# differs from the sequential scan's, so against that it is held within one
# bf16 step of y (2^-7 of |y|) and 1e-4 of h_last. Near y = 0 the two
# float32 carries' difference (~5e-7 on an H100) exceeds a bf16 step of y,
# so y also has 1e-6 absolute, as the lab's card test. Variant A is held at
# every st of its sweep; at st = 128 it runs the code of the library's
# forward scan, which the lab times on its first line, so the two lines
# agree within 10 %. Variant B is held at every tile of its sweep, and
# timed at st = 256 beside the library's scan on one SP shard's shape (the
# probe). The lab's replaced TPU kernels.
LAB_UNROLLED_ST = 128
LAB_SAME_AS_SCAN_REL = 0.10
LAB_LOGSCAN_TILE = (256, 512)  # the st = 256 lines tie on the H100
LAB_PROBE_SHAPE = (1, 4096, 2560)
LAB_PROBE_TILE = (256, 2560)
LAB_Y_REL_ERR = 2.0**-7
LAB_Y_ABS_ERR = 1e-6
LAB_H_MAX_ABS_ERR = 1e-4
LAB_UNROLLED_REPLACES = "benchmarks/kernel_lab.py:74"
LAB_LOGSCAN_REPLACES = "benchmarks/kernel_lab.py:128"

# The serving features on the main path's 2B (phase 16): the main path's
# prompts prefilled in chunks of CHUNK_TOKENS (padded to 3072, three
# chunks); a PREFIX_TOKENS prefix at batch 1, continued by two calls of 2 x
# CONTINUATION_TOKENS; conversation turns of TURN_TOKENS prompt tokens and
# TURN_STEPS generated ones; captured and eager decode in GRAPH_TURNS
# (True: captured), balanced against drift as EPILOGUE_TURNS below.
CHUNK_TOKENS = 1024
PREFIX_TOKENS = 2048
CONTINUATION_TOKENS = 512
TURN_TOKENS = (300, 200, 120)
TURN_STEPS = 8
GRAPH_TURNS = (False, True, True, False)
CATEGORICAL = dict(temperature=0.8, top_k=50, top_p=0.95)
SERVING_PENALTY = 1.3
# The ModalSampler's image turn and its text follow-up (phase 8).
MODAL_TURN_STEPS = 8
MODAL_FOLLOWUP_TOKENS = 64

# Continuous batching on the main path's 2B (phase 17): BATCH_SLOTS slots
# take BATCH_REQUESTS requests of BATCH_STEPS tokens, one joining a tick
# while a slot is free, in ticks of BATCH_TICK steps: one
# BATCH_LONG_TOKENS-token single shot, one as long in CHUNK_TOKENS chunks,
# two continuations of BATCH_CONTINUATION_TOKENS after one PREFIX_TOKENS
# prefix, BATCH_CATEGORICAL categorical (CATEGORICAL's knobs) and the rest
# greedy (top_k 1), of BATCH_PROMPT_RANGE tokens.
BATCH_SLOTS = 8
BATCH_REQUESTS = 16
BATCH_STEPS = 64
BATCH_TICK = 8
BATCH_LONG_TOKENS = 3000
BATCH_PROMPT_RANGE = (300, 1500)
BATCH_CONTINUATION_TOKENS = 200
BATCH_CATEGORICAL = 4
# Every batching request (and the one-slot run) carries this repetition
# penalty: the random-weight 2B repeats the last prompt token at probability
# ~1 (its tied embedding dominates the soft-capped logits), which would make
# identical tokens and log-probabilities hold trivially. Divided by it, an
# emitted token's logit (<= 30) falls below the other tokens' largest.
BATCH_PENALTY = 30.0
# Recorded log-probabilities (decode at eight slots, one closed-form LRU step
# and the ring's einsum a token) against one teacher-forced batch-1 forward
# (the scan kernel and multi-token attention): the whole bf16 model's
# rounding at other places, as MODEL_LOGITS_REL_RMS. Relative RMS of the
# difference over every emitted token.
LOGPROB_REL_RMS = 5e-2
# The eight-slot tick (True) and the Sampler's batch-2 decode step (False),
# in turns; TICK_REPEATS ticks a turn.
TICK_TURNS = (False, True, True, False)
TICK_REPEATS = 4
# The HTTP front end: HTTP_SLOTS slots, HTTP_PROMPT_TOKENS-word prompts,
# HTTP_STEPS tokens; a streamed request of HTTP_CANCEL_STEPS is cancelled.
HTTP_SLOTS = 4
HTTP_PROMPT_TOKENS = 200
HTTP_STEPS = 16
HTTP_CANCEL_STEPS = 1024
HTTP_TIMEOUT_S = 300
# Int8 serving (phase 18): the text-serving prompts, the image run's pixels
# and prompts, and the eight-slot tick, each int8 against bf16 in these
# turns.
INT8_TURNS = ("bf16", "int8", "int8", "bf16")
# The text prefill's turns: bf16, int8 with act_quant, weight-only int8
# (every product through the wgmma forward kernel).
INT8_TEXT_TURNS = ("bf16", "int8", "int8 weight-only", "int8 weight-only",
                   "int8", "bf16")
INT8_REPS = 24
INT8_PREFILL_ROWS = 2 * max(PROMPT_TOKENS)
# The int8 kernel and its plain version sum in other orders, round the sum
# to bf16, multiply by the bf16 scale and round again: one step of the first
# rounding and the second together reach 1.5 x 2^-7 of the larger value;
# sums that cancel keep 1e-4 of the largest output.
INT8_REL = 2**-6
INT8_ABS_OF_MAX = 1e-4
INT8_REPLACES = ("none (no pl.pallas_call): XLA's int8 dot with the convert "
                 "fused, cadence_gemma_tpu/models/layers.py:166")
INT8_WGMMA_SOURCE = "cadence_gemma_tpu_torch/csrc/int8_wgmma.cu"


# Multimodal fine-tuning (phase 19): batch 2 of seeded [2, 3, 384, 384]
# pixels (729 visual tokens) and 2048 text tokens (row 1 right-padded after
# 1500), the loss over the second half of each row's real text; 3
# frozen-connector steps then 2 full steps (two_stage_sft), 3 LoRA steps on
# the bf16 base and 3 on its int8 copy (QLoRA), rank 8.
SFT_PIXELS = (2, 3, 384, 384)
SFT_TEXT_TOKENS = 2048
SFT_REAL_TOKENS = (2048, 1500)
SFT_FROZEN_STEPS = 3
SFT_FULL_STEPS = 2
SFT_LORA_STEPS = 3
SFT_LORA_RANK = 8
SFT_LEARNING_RATE = 1e-3
SFT_DECODE_STEPS = 16
SFT_PROMPT_TOKENS = 1000
# The merged model's logits against the LoRA model's: the merge rounds
# W + a @ b * s to bf16 once, the LoRA model adds the term in bf16. Also
# within SFT_MERGE_OF_BASE of the base's (no adapters), which a merge that
# dropped the adapters would not be.
SFT_MERGE_REL_RMS = 5e-2
SFT_MERGE_OF_BASE = 0.5
# The input-gradient kernel and its plain version round the bf16-scaled
# cotangent the same way and their float32 sums once each: the forward's
# INT8_REL covers one bf16 step; the adapters' gradients through the kernel
# path against the plain path, per leaf, as the training phase's.
INT8_DGRAD_REPLACES = ("none (no pl.pallas_call): XLA's transposed int8 dot, "
                       "cadence_gemma_tpu/models/layers.py:171")
INT8_DGRAD_REPS = 12
# Adapters end to end (phase 20). 19(b)'s LoRA run saves step_2 (async,
# prefetching two batches); a fresh model resumes from it for the third
# step, whose adapters must equal the uninterrupted run's bit for bit, or
# within RESUME_REL_RMS a leaf where a kernel's sum order varies. The
# multi-LoRA batcher: ML_SLOTS slots take ML_REQUESTS greedy requests of
# ML_STEPS tokens (one of BATCH_LONG_TOKENS, the rest of ML_PROMPT_RANGE;
# BATCH_PENALTY), their adapters cycling through the step-2 ones, the final
# ones and none; the QLoRA base takes ML_Q_REQUESTS at ML_Q_SLOTS slots.
RESUME_REL_RMS = 1e-3
ML_SLOTS = 8
ML_REQUESTS = 16
ML_STEPS = 32
ML_PROMPT_RANGE = (300, 1500)
ML_Q_SLOTS = 4
ML_Q_REQUESTS = 6
ML_STALL_REPEATS = 5
# The multi-LoRA tick (True) against the plain tick of the same model
# (False), in turns: the first turn has read several times the later ones.
ML_TICK_TURNS = (False, True, True, False, False, True, True, False)
ML_STALL_TOKENS = 1000

# Phase 23, the serving export: phase 4's prompts (2 x 3000 tokens, the
# second left-padded from 2300) as one bucket; the loaded programs against
# the live path in turns (True: the loaded program); an artifact must stay
# under this share of its model's weight bytes (graph, not weights); host
# us a call through an operator against the direct launch, over this many
# calls a turn.
EXPORT_BUCKET = (2, PREFILL_TOKENS)
# The exported models are phase 18's first 3 blocks at full width (R, R, A:
# the window kernel's operator is in the graphs): the whole 2B took
# 209.9-226.1 s of the smoke's 1200 on a slow host, 6 blocks 64.5-79.1 s;
# 3 since phase 29 came.
EXPORT_BLOCKS = 3
EXPORT_TURNS = (False, True, True, False)
EXPORT_MAX_WEIGHT_SHARE = 0.01
HOST_CALLS = 200


def log(*args) -> None:
  print(*args, flush=True)


# The H100's L2 cache.
L2_BYTES = 50e6


def cold_copies(*tensors: torch.Tensor, copy=None) -> list[tuple]:
  """Copies of ``tensors`` that together hold more than twice the L2, for
  :func:`device_ms` to rotate through; the tensors themselves if they hold
  less than 1 MB (a decode step's inputs, which its caller leaves warm).
  With ``copy``, every set (the first too) is made by it."""
  n_bytes = sum(t.numel() * t.element_size() for t in tensors)
  if n_bytes < 1e6 and copy is None:
    return [tensors]
  count = int(np.ceil(2 * L2_BYTES / n_bytes)) + 1
  if copy is not None:
    return [tuple(copy(t) for t in tensors) for _ in range(count)]
  return [tensors] + [tuple(t.clone() for t in tensors)
                      for _ in range(count - 1)]


def bound(n_bytes: float, flops: float, flops_per_s: float):
  """(least ms the card could take, what bounds it)."""
  t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
  t_ops = flops / flops_per_s * 1e3
  return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Calls a scan's device time averages over.
SCAN_REPS = 48


def time_scan(call, inputs: tuple, n_bytes: float, flops: float,
              copy=None) -> dict:
  """A scan's figures as the paths call it: the device time of a call
  with the launch queue full, on copies of its inputs that exceed the L2
  (:func:`device_ms`: at ~0.05 ms a call, CUDA events around calls launched
  one after another would time the host's launch; ``copy`` makes them, see
  :func:`cold_copies`), the host's time to launch one call, the bound of
  these inputs, GB/s and the share of the bound."""
  copies = cold_copies(*inputs, copy=copy)
  ms = device_ms(call, SCAN_REPS, inputs=copies)
  torch.cuda.synchronize()
  start = time.perf_counter()
  for _ in range(SCAN_REPS):
    call(*copies[0])
  host_us = (time.perf_counter() - start) / SCAN_REPS * 1e6
  torch.cuda.synchronize()
  bound_ms, bound_by = bound(n_bytes, flops, FP32_FLOPS)
  return dict(ms=ms, bound_ms=bound_ms, bound_by=bound_by,
              gbps=n_bytes / ms / 1e6, bound_share=bound_ms / ms,
              host_us=host_us)


def log_scan(f: dict, plain_ms: float, n_bytes: float) -> None:
  log(f"  ms {f['ms']:.4f} (a call with the launch queue full, cold inputs)"
      f"  plain_ms {plain_ms:.3f}  bound_ms {f['bound_ms']:.4f} "
      f"({f['bound_by']}, {n_bytes / 1e6:.1f} MB): {f['gbps']:.0f} GB/s, "
      f"{100 * f['bound_share']:.1f}% of the bound; host "
      f"{f['host_us']:.1f} us a call")


def reset_scan_routes() -> None:
  lru_scan.ring_launches = lru_scan.thread_walk_launches = 0


def check_scan_routes(scans: int) -> None:
  """Every real scan launch since :func:`reset_scan_routes` (``scans`` of
  them) took the TMA ring of ``csrc/lru_scan.cu``."""
  routes = (lru_scan.ring_launches, lru_scan.thread_walk_launches)
  log(f"  scan routes: {routes[0]} launches on the TMA ring, {routes[1]} on "
      f"the per-thread walk (want {scans}, 0)")
  if routes != (scans, 0):
    raise AssertionError(f"Scan routes (ring, per-thread walk) {routes}, "
                         f"want ({scans}, 0).")


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
  return (got.float() - want.float()).abs().max().item()


def phase_card() -> dict:
  kind = torch.cuda.get_device_name(0)
  count = torch.cuda.device_count()
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True, timeout=60,
  ).stdout.strip()
  log(f"== card: {kind} (count {count}); torch {torch.__version__}, "
      f"CUDA {torch.version.cuda}")
  log(smi)
  return {"platform": "gpu", "kind": kind, "count": count}


def template_args(mangled: str) -> str:
  """A kernel's mangled template arguments as ptxas names them, readable:
  ``13__nv_bfloat16Li32ELb0E`` -> ``bf16, 32, 0``; a ring kernel's walk
  leads (``NS0_8RealWalkIfLi16E...`` -> ``RealWalk: f32, 16, ...``)."""
  walk = re.search(r"\d+([A-Z][A-Za-z]*Walk)I", mangled)
  args = ", ".join(
      "bf16" if m.group(0) == "13__nv_bfloat16" else
      "f32" if m.group(1) is None else m.group(1)
      for m in re.finditer(r"13__nv_bfloat16|(?:^|I)f(?=L)|L[ib](\d+)E",
                           mangled))
  return f"{walk.group(1)}: {args}" if walk else args


def phase_build() -> None:
  start = time.perf_counter()
  reports = _build.build()
  log(f"== build: {time.perf_counter() - start:.2f} s "
      f"(built {sorted(reports) or 'nothing: up to date'})")
  for name, report in reports.items():
    for line in report.splitlines():
      entry = "Compiling entry function" in line and re.search(
          r"([a-z][a-z_]*_kernel)(?:I(.*?E)Ev)?", line)
      if entry:
        kernel = entry.group(1) + (f"<{template_args(entry.group(2))}>"
                                   if entry.group(2) else "")
        log(f"  {name}: {kernel}")
      elif "registers" in line or "spill" in line:
        log(f"  {name}: {line.strip()}")
  # The scans' TMA-ring kernels as launched, bf16, for each entry point at
  # both channel counts (32 a block at batch 2 of the 2B, 16 at batch 1).
  for library in ("lru_scan", "lru_scan_complex"):
    for backprop, a_prod in ((0, 0), (1, 0), (0, 1), (1, 1)):
      for channels in (32, 16):
        info = _build.kernel_attributes(library, f"cg_{library}_attributes",
                                        backprop, a_prod, 1, channels)
        log(f"  {library} ring_kernel "
            f"{'cotangent' if backprop else 'forward'}"
            f"{' + product' if a_prod else ''}, C = {channels}: "
            f"{info['registers']} registers a thread at launch, "
            f"{info['local_bytes']} local (spilled) bytes, "
            f"{info['shared_bytes']} bytes of shared memory, "
            f"{info['threads']} threads")
  # The kernel lab's log-scan (variant B) at every st it is built for.
  for dtype, label in ((1, "bf16"), (0, "f32")):
    for st in kernel_lab.LOGSCAN_STEPS:
      info = _build.kernel_attributes("kernel_lab",
                                      "cg_lab_logscan_attributes", dtype, st)
      log(f"  kernel_lab lab_logscan_kernel {label} st {st}: "
          f"{info['registers']} registers a thread at launch, "
          f"{info['local_bytes']} local (spilled) bytes, "
          f"{info['shared_bytes']} bytes of shared memory, "
          f"{info['threads']} threads")
  # The Hopper attention kernels' resources as launched (setmaxnreg moves
  # the window kernels' producer registers to their consumers).
  for library, kernel, dims in (
      ("window_attention", "window_attention", wa.KERNEL_HEAD_DIMS),
      ("window_attention_backward", "window_attention_dq",
       wa.KERNEL_HEAD_DIMS),
      ("window_attention_backward", "window_attention_dkv",
       wa.KERNEL_HEAD_DIMS),
      ("mha_attention", "mha_attention", mha_attention.KERNEL_HEAD_DIMS)):
    for head_dim in dims:
      info = resources(library, head_dim, kernel)
      log(f"  {kernel} head_dim {head_dim}: {info['registers']} registers a "
          f"thread at launch, {info['local_bytes']} local (spilled) bytes, "
          f"{info['shared_bytes']} bytes of shared memory")
  # The int8 wgmma kernels (setmaxnreg: producers 40, consumers 232).
  for which, kernel in ((0, "int8_wgmma_forward"), (1, "int8_wgmma_dgrad")):
    info = _build.kernel_attributes("int8_wgmma", "cg_int8_wgmma_attributes",
                                    which)
    log(f"  {kernel}: {info['registers']} registers a thread at launch, "
        f"{info['local_bytes']} local (spilled) bytes, "
        f"{info['shared_bytes']} bytes of shared memory")


def phase_lru(dev) -> dict:
  b, t, d = LRU_SHAPE
  rng = np.random.default_rng(SEED)
  x = torch.tensor(rng.standard_normal(LRU_SHAPE, dtype=np.float32),
                   device=dev).bfloat16()
  a = torch.sigmoid(torch.tensor(
      rng.standard_normal(LRU_SHAPE, dtype=np.float32), device=dev
  )).bfloat16()
  h0 = torch.tensor(rng.standard_normal((b, d), dtype=np.float32), device=dev)
  log(f"== lru_scan vs plain at [{b},{t},{d}] bf16 "
      f"(tolerance {LRU_MAX_ABS_ERR})")
  worst = 0.0
  for reverse in (False, True):
    for init in (None, h0):
      err = check_lru(x, a, init, reverse)
      log(f"  reverse={reverse} h0={init is not None}: max_abs_err {err}")
      worst = max(worst, err)

  # Timed as the prefill calls it: forward, no initial state. Read x and a,
  # write y (bf16) and h_last (fp32); two fp32 flops a step.
  n_bytes = 3 * b * t * d * 2 + b * d * 4
  figures = time_scan(lru_scan.lru_scan_forward, (x, a), n_bytes,
                      2 * b * t * d)
  plain_ms = cuda_ms(lambda: lru_scan.lru_scan_plain(x, a), reps=2)
  log_scan(figures, plain_ms, n_bytes)
  return dict(name="lru_scan", route="cuda",
              source="cadence_gemma_tpu_torch/csrc/lru_scan.cu",
              replaces=LRU_REPLACES, max_abs_err=worst, plain_ms=plain_ms,
              library_ms=None, **figures)


def window_forward_figures(q, k, v, seg, kv_prefix=0, plain=True) -> dict:
  """Times the window forward on these inputs beside one SDPA call with the
  same visibility as a boolean mask (the yardstick) and, if ``plain``, the
  plain version; the bound of this run's band, the achieved rate, the share
  of the bound and the ratio to SDPA."""
  b, t, n, h = q.shape
  visible = wa.band_mask(seg, t, ATTN_WINDOW, kv_prefix)  # [b, t, P + t]
  qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))

  def library():
    return torch.nn.functional.scaled_dot_product_attention(
        qt, kt.expand(-1, n, -1, -1), vt.expand(-1, n, -1, -1),
        attn_mask=visible[:, None],
    )

  ms = cuda_ms(lambda: wa.window_attention_forward(q, k, v, seg, ATTN_WINDOW,
                                                   kv_prefix), 20)
  library_ms = cuda_ms(library, 5)
  plain_ms = cuda_ms(lambda: wa.window_attention_plain(
      q, k, v, seg, ATTN_WINDOW, kv_prefix), 2) if plain else None
  # Work of this run's band: QK^T and PV, 2 * h flops each per visible
  # (query, key) pair and head; bytes: q, k, v, segment_pos in, out, lse out.
  pairs = int(visible.sum().item())
  flops = 4 * n * h * pairs
  n_bytes = (2 * (2 * b * t * n * h + 2 * b * (kv_prefix + t) * h)
             + 4 * b * t + 4 * b * n * t)
  bound_ms, bound_by = bound(n_bytes, flops, BF16_TENSOR_FLOPS)
  return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
              bound_ms=bound_ms, bound_by=bound_by, pairs=pairs, flops=flops,
              **speed(ms, flops, bound_ms, library_ms))


def speed(ms: float, flops: float, bound_ms: float, library_ms) -> dict:
  """What a redesign is judged on: achieved TFLOP/s, the share of the bound
  reached and the time as a multiple of the library call's."""
  return dict(tflops=flops / ms / 1e9, bound_share=bound_ms / ms,
              sdpa_ratio=None if library_ms is None else ms / library_ms)


def log_figures(label: str, f: dict) -> None:
  plain = "" if f["plain_ms"] is None else f"  plain_ms {f['plain_ms']:.3f}"
  log(f"  {label}: ms {f['ms']:.4f}{plain}  library_ms (SDPA) "
      f"{f['library_ms']:.4f}  bound_ms {f['bound_ms']:.4f} "
      f"({f['bound_by']}, {f['flops'] / 1e9:.1f} GFLOP over {f['pairs']} "
      f"visible pairs): {f['tflops']:.1f} TFLOP/s, "
      f"{100 * f['bound_share']:.1f}% of the bound, "
      f"{f['sdpa_ratio']:.3f} x SDPA")


def phase_attention(dev) -> dict:
  b, t, n, h = ATTN_SHAPE
  rng = np.random.default_rng(SEED + 1)
  q, k, v = (
      torch.tensor(rng.standard_normal(s, dtype=np.float32),
                   device=dev).bfloat16()
      for s in ((b, t, n, h), (b, t, 1, h), (b, t, 1, h))
  )
  seg = np.tile(np.arange(t, dtype=np.int32), (b, 1))
  seg[0, ATTN_BOUNDARY:] = np.arange(t - ATTN_BOUNDARY, dtype=np.int32)
  seg[1] = np.maximum(np.arange(t, dtype=np.int32) - ATTN_PAD, -1)
  seg = torch.tensor(seg, device=dev)
  log(f"== window_attention vs plain at [{b},{t},{n},{h}] bf16, window "
      f"{ATTN_WINDOW} (tolerance out {ATTN_OUT_MAX_ABS_ERR}, "
      f"lse {ATTN_LSE_MAX_ABS_ERR})")

  out_err, lse_err = check_attention(q, k, v, seg, ATTN_WINDOW)
  figures = window_forward_figures(q, k, v, seg)
  log_figures(f"[{b},{t},{n},{h}], the prefill's", figures)
  del q, k, v

  # The training step's shape: batch 2 x 4096, row 1 right-padded after
  # 3000 (its forward runs twice a block under remat).
  b, t, n, h = ATTN_TRAIN_SHAPE
  q, k, v = (
      torch.tensor(rng.standard_normal(s, dtype=np.float32),
                   device=dev).bfloat16()
      for s in ((b, t, n, h), (b, t, 1, h), (b, t, 1, h))
  )
  train = window_forward_figures(q, k, v, training_segment_pos(dev),
                                 plain=False)
  log_figures(f"[{b},{t},{n},{h}], the training step's", train)
  keys = ("ms", "library_ms", "bound_ms", "tflops", "bound_share",
          "sdpa_ratio")
  return dict(name="window_attention", route="cuda",
              source="cadence_gemma_tpu_torch/csrc/window_attention.cu",
              replaces=ATTN_REPLACES, max_abs_err=max(out_err, lse_err),
              **{key: figures[key] for key in (
                  "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                  "tflops", "bound_share", "sdpa_ratio")},
              train_shape={"shape": list(ATTN_TRAIN_SHAPE),
                           **{key: train[key] for key in keys}},
              **resources("window_attention", h))


def resources(library: str, head_dim: int, kernel: str | None = None) -> dict:
  """The registers, spilled bytes and shared memory at head_dim of
  ``kernel`` (default: the library's name) of library ``library``."""
  info = _build.kernel_attributes(
      library, f"cg_{kernel or library}_attributes", head_dim)
  return dict(registers=info["registers"], local_bytes=info["local_bytes"],
              shared_bytes=info["shared_bytes"])


def check_lru(x, a, h0=None, reverse=False) -> float:
  """Max abs error of the kernel against its plain version; raises above
  the tolerance."""
  y, h_last = lru_scan.lru_scan(x, a, h0, reverse)
  y_ref, h_ref = lru_scan.lru_scan_plain(x, a, h0, reverse)
  err = max(max_err(y, y_ref), max_err(h_last, h_ref))
  if not err <= LRU_MAX_ABS_ERR:
    raise AssertionError(f"lru_scan disagrees with its plain version: {err}")
  return err


def check_attention(q, k, v, seg, window, kv_prefix=0) -> tuple[float, float]:
  """Max abs errors (out, lse) of the kernel against its plain version;
  raises above the tolerances or if a padded row is not zero."""
  out, lse = wa.window_attention(q, k, v, seg, window, kv_prefix=kv_prefix)
  out_ref, lse_ref = wa.window_attention_plain(q, k, v, seg, window,
                                               kv_prefix)
  out_err, lse_err = max_err(out, out_ref), max_err(lse, lse_ref)
  log(f"  out max_abs_err {out_err}  lse max_abs_err {lse_err}")
  if not (out_err <= ATTN_OUT_MAX_ABS_ERR and lse_err <= ATTN_LSE_MAX_ABS_ERR):
    raise AssertionError("window_attention disagrees with its plain version.")
  padded = seg < 0
  if out[padded].any() or not (lse.transpose(1, 2)[padded] == wa.MASKED_LSE).all():
    raise AssertionError("Padded rows must give zeros and the masked lse.")
  return out_err, lse_err


class CaptureFirstCall:
  """Stands in for a kernel wrapper in a module and keeps a copy of the
  arguments of its first call (its ``index``-th with ``index``)."""

  def __init__(self, module, name: str, index: int = 0):
    self.module, self.name = module, name
    self.wrapper = getattr(module, name)
    self.args = self.kwargs = None
    self.calls, self.index = 0, index
    setattr(module, name, self)

  def __call__(self, *args, **kwargs):
    if self.args is None and self.calls == self.index:
      copy = lambda z: z.clone() if isinstance(z, torch.Tensor) else z
      self.args = tuple(copy(z) for z in args)
      self.kwargs = {key: copy(z) for key, z in kwargs.items()}
    self.calls += 1
    return self.wrapper(*args, **kwargs)

  def restore(self):
    setattr(self.module, self.name, self.wrapper)


class DecodeProbe:
  """Sees the samplers' decode loops, captured as CUDA graphs or eager.

  CUDA events around each ``Sampler._decode`` call and the steps it ran give
  decode ms a step. A replay of a captured step runs no Python, so the
  kernel wrappers' counters miss its launches: ``counts()`` (the counters)
  read around a decode step's Python, which runs at a graph's warm-up and
  capture, give one step's launches, and a run's launches are the
  counters' plus those times the replays (:meth:`run_launches`).
  """

  def __init__(self, counts):
    self.counts = counts
    self.step_launches = None
    self.decodes = []  # [start event, end event, steps]
    self.replays = 0
    self._saved = (sampler_lib.Sampler._decode, sampler_lib._DecodeGraph._step,
                   sampler_lib._DecodeGraph.replay)
    decode, step, replay = self._saved
    probe = self

    def timed_decode(sampler, state, *args, **kwargs):
      first = int(state.step)
      start = torch.cuda.Event(enable_timing=True)
      start.record()
      state = decode(sampler, state, *args, **kwargs)
      end = torch.cuda.Event(enable_timing=True)
      end.record()
      probe.decodes.append([start, end, int(state.step) - first])
      return state

    def counted_step(graph, sampler):
      before = probe.counts()
      logits = step(graph, sampler)
      after = probe.counts()
      probe.step_launches = {k: after[k] - before[k] for k in after}
      return logits

    def counted_replay(graph):
      probe.replays += 1
      return replay(graph)

    sampler_lib.Sampler._decode = timed_decode
    sampler_lib._DecodeGraph._step = counted_step
    sampler_lib._DecodeGraph.replay = counted_replay

  def reset(self) -> None:
    self.decodes.clear()
    self.replays = 0

  def decode_ms(self) -> float:
    """Decode ms a step of the last decode loop."""
    start, end, steps = self.decodes[-1]
    end.synchronize()
    return start.elapsed_time(end) / steps

  def run_launches(self, counted: dict[str, int]) -> dict[str, int]:
    """The launches of a run: the counters' and the replays'."""
    if not self.replays:
      return dict(counted)
    return {k: counted[k] + self.step_launches[k] * self.replays
            for k in counted}

  def close(self) -> None:
    (sampler_lib.Sampler._decode, sampler_lib._DecodeGraph._step,
     sampler_lib._DecodeGraph.replay) = self._saved


def _use_plain_path(model: griffin.Griffin, plain: bool) -> None:
  """Routes the model through the plain scan and einsum attention, or back."""
  for block in model.blocks:
    if block.temporal_block_type is common.TemporalBlockType.RECURRENT:
      block.recurrent_block.rg_lru.scan_type = (
          common.ScanType.LINEAR_NATIVE if plain else model.config.scan_type
      )
    else:
      block.attention_block.use_flash_attention = False if plain else None


def phase_main_path(dev, kernels: list[dict], profile: bool) -> None:
  config = common.GriffinConfig.from_preset(
      common.Preset.RECURRENT_GEMMA_2B_V1
  )
  start = time.perf_counter()
  model = griffin.Griffin(
      config, device=dev, dtype=torch.bfloat16,
      generator=torch.Generator(dev).manual_seed(SEED),
  )
  torch.cuda.synchronize()
  n_params = sum(p.numel() for p in model.parameters())
  log(f"== main path: RecurrentGemma-2B, {config.num_layers} blocks, width "
      f"{config.width}, {n_params / 1e9:.3f} B parameters in bf16 "
      f"(built in {time.perf_counter() - start:.1f} s)")
  n_recurrent = sum(
      bt is common.TemporalBlockType.RECURRENT for bt in config.block_types
  )
  n_attention = config.num_layers - n_recurrent
  if (n_recurrent, n_attention) != (18, 8):
    raise AssertionError(f"2B has 18 R and 8 A blocks, got {n_recurrent}, "
                         f"{n_attention}.")

  vocab = SimpleVocab([f"w{i}" for i in range(config.vocab_size - 4)])
  rng = np.random.default_rng(SEED + 2)
  # BOS plus n - 1 words; the shorter prompt is left-padded.
  prompts = [
      " ".join(f"w{i}" for i in rng.integers(0, config.vocab_size - 4, n - 1))
      for n in PROMPT_TOKENS
  ]
  sampler = sampler_lib.Sampler(model, vocab, device=dev)

  # Per model forward: [start event, end event, the two launch counters at
  # its end]. The first forward of a call is the prefill; the decode steps
  # replay a captured graph, which the probe sees.
  calls = []

  def before_forward(*_):
    calls.append([torch.cuda.Event(enable_timing=True)])
    calls[-1][0].record()

  def after_forward(*_):
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    calls[-1] += [end, lru_scan.launches, wa.launches]

  hooks = [model.register_forward_pre_hook(before_forward),
           model.register_forward_hook(after_forward)]
  counts = lambda: {"lru_scan": lru_scan.launches,
                    "window_attention": wa.launches}
  probe = DecodeProbe(counts)
  run_kw = dict(total_generation_steps=DECODE_STEPS, return_logits=True,
                end_sampling_at_eos_token=False)
  try:
    # Warm-up with the measured run's shapes (its decode graph is captured
    # here), which also keeps the inputs that this prefill (the same as the
    # measured run's) gives each kernel's first call.
    captures = [CaptureFirstCall(lru_scan, "lru_scan"),
                CaptureFirstCall(wa, "window_attention")]
    try:
      sampler(prompts, **run_kw)
    finally:
      for capture in captures:
        capture.restore()
    torch.cuda.synchronize()
    calls.clear()
    probe.reset()
    torch.cuda.reset_peak_memory_stats()
    lru_scan.launches = 0
    wa.launches = 0
    reset_scan_routes()
    start = time.perf_counter()
    out = sampler(prompts, **run_kw)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    launches = probe.run_launches(counts())
    replays, step_launches = probe.replays, probe.step_launches
    decode_ms = probe.decode_ms()
  finally:
    probe.close()
    for hook in hooks:
      hook.remove()
  peak_gb = torch.cuda.max_memory_allocated() / 1e9
  check_scan_routes(lru_scan.launches)

  if len(calls) + replays != DECODE_STEPS or replays != DECODE_STEPS - 1:
    raise AssertionError(f"{len(calls)} forwards and {replays} replays of "
                         f"the captured step for {DECODE_STEPS} tokens.")
  prefill = tuple(calls[0][2:])
  if prefill != (n_recurrent, n_attention):
    raise AssertionError(f"Prefill launched (lru, attention) = {prefill}, "
                         f"want {(n_recurrent, n_attention)}.")
  if tuple(launches.values()) != prefill or any(step_launches.values()):
    raise AssertionError(f"Decode launched kernels: {launches} after "
                         f"prefill {prefill}; a captured step "
                         f"{step_launches}.")
  tokens = torch.stack(out.tokens)
  logits = torch.stack(out.logits)
  if tokens.shape != (2, DECODE_STEPS) or logits.shape != (
      2, DECODE_STEPS, config.vocab_size):
    raise AssertionError(f"Shapes {tokens.shape}, {logits.shape}.")
  if not torch.isfinite(logits).all():
    raise AssertionError("Non-finite logits.")
  if not ((tokens >= 0) & (tokens < config.vocab_size)).all():
    raise AssertionError("Token out of range.")

  prefill_ms = calls[0][0].elapsed_time(calls[0][1])
  padded = max(PROMPT_TOKENS)
  log(f"  prompts {PROMPT_TOKENS} tokens (padded to {padded}), "
      f"{DECODE_STEPS} greedy steps, decode captured ({replays} replays of "
      f"one step, whose capture launched {step_launches})")
  log(f"  launches in the run {launches}; prefill {prefill}")
  prompt_rate = sum(PROMPT_TOKENS) / prefill_ms * 1e3  # real tokens only
  log(f"  prefill_ms {prefill_ms:.2f} ({prompt_rate:.0f} prompt tokens/s)  "
      f"decode_ms_per_step {decode_ms:.3f}  "
      f"wall {wall_s:.3f} s ({2 * DECODE_STEPS / wall_s:.1f} generated "
      f"tokens/s)  peak {peak_gb:.2f} GB")
  log(f"  first tokens {tokens[:, :8].tolist()}")

  # Each kernel against its plain version on the inputs the prefill gave it.
  for kernel, capture in zip(kernels, captures):
    args, kwargs = capture.args, capture.kwargs
    if args is None:
      raise AssertionError(f"The prefill never called {kernel['name']}.")
    tensors = [z for z in (*args, *kwargs.values())
               if isinstance(z, torch.Tensor)]
    log(f"  {kernel['name']} on the prefill's inputs "
        f"{[(tuple(z.shape), str(z.dtype)) for z in tensors]}:")
    if kernel["name"] == "lru_scan":
      err = check_lru(*args, **kwargs)
      log(f"  max_abs_err {err} (tolerance {LRU_MAX_ABS_ERR})")
    else:
      err = max(check_attention(*args, **kwargs))
    kernel["max_abs_err"] = max(kernel["max_abs_err"], err)
    kernel["launches"] = launches[kernel["name"]]

  # The same weights through the plain path, one prompt longer than the
  # window, compared at the last position's logits.
  ids = torch.tensor(
      [[1, *rng.integers(4, config.vocab_size, REFERENCE_PROMPT_TOKENS - 1)]],
      device=dev,
  )
  pos = torch.arange(REFERENCE_PROMPT_TOKENS, device=dev)[None]
  with torch.inference_mode():
    got, _ = model(ids, pos, return_cache=False, last_logits_only=True)
    _use_plain_path(model, True)
    want, _ = model(ids, pos, return_cache=False, last_logits_only=True)
    _use_plain_path(model, False)
  diff = (got.float() - want.float())
  rel = (diff.square().mean().sqrt() / want.float().square().mean().sqrt())
  rel = rel.item()
  log(f"  kernel path vs plain path, {REFERENCE_PROMPT_TOKENS} tokens: "
      f"logits rel_rms {rel:.3e} (tolerance {MODEL_LOGITS_REL_RMS}), "
      f"max_abs {diff.abs().max().item():.3e}, same argmax "
      f"{bool(got.argmax() == want.argmax())}")
  if not (torch.isfinite(got).all() and rel <= MODEL_LOGITS_REL_RMS):
    raise AssertionError("Kernel path and plain path disagree.")
  if profile:
    profile_main_path(sampler, prompts, prefill_ms, decode_ms)
  return model, vocab, prompts, sampler, out


def decode_kernel_times(sampler, prompts):
  """(prefill's, DECODE_STEPS decode steps') kernel times by name: a
  prefill-only call's trace and the difference of a call with DECODE_STEPS
  more tokens. That call's decode graph is captured before its trace."""
  longer = lambda: sampler(prompts, total_generation_steps=1 + DECODE_STEPS,
                           end_sampling_at_eos_token=False)
  longer()
  prefill_k = kernel_times(lambda: sampler(prompts, total_generation_steps=1))
  both_k = kernel_times(longer)
  return prefill_k, {
      name: (ms - prefill_k.get(name, (0.0, 0))[0],
             count - prefill_k.get(name, (0.0, 0))[1])
      for name, (ms, count) in both_k.items()
  }


def profile_main_path(sampler, prompts, prefill_ms, decode_ms) -> None:
  """Logs kernel time by name, per step, for prefill and for decode."""
  prefill_k, decode_k = decode_kernel_times(sampler, prompts)
  for label, times, steps, wall_ms in (
      ("prefill", prefill_k, 1, prefill_ms),
      ("decode", decode_k, DECODE_STEPS, decode_ms),
  ):
    busy = sum(ms for ms, _ in times.values()) / steps
    log(f"  {label}: kernels busy {busy:.3f} ms of {wall_ms:.3f} ms a step "
        f"(device idle share {1 - busy / wall_ms:.3f}); top kernels:")
    for name, (ms, count) in sorted(
        times.items(), key=lambda kv: -kv[1][0])[:8]:
      log(f"    {ms / steps:9.4f} ms  x{count / steps:6.1f}  {name[:160]}")


# Traces of one call to take before giving up when the profiler hands back no
# device event: a short trace (50 launches of a 2 µs kernel) has come back
# empty once in a run whose kernels all launched and agreed.
PROFILE_ATTEMPTS = 3


def kernel_times(fn) -> dict[str, tuple[float, int]]:
  """{kernel name: (device ms, launches)} of one call, from torch.profiler.

  Raises if the profiler records no device event in PROFILE_ATTEMPTS traces
  of the call."""
  activities = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
  for attempt in range(PROFILE_ATTEMPTS):
    with torch.profiler.profile(activities=activities) as prof:
      fn()
      torch.cuda.synchronize()
    times = {
        e.key: (e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
    }
    if times:
      return times
    log(f"  torch.profiler recorded no device event (trace {attempt + 1} of "
        f"{PROFILE_ATTEMPTS})")
  raise RuntimeError("torch.profiler recorded no kernel on the card.")


def _timed_call(fn) -> tuple[float, float]:
  """(ms, peak GB) of one call: CUDA events around it, the peak of the
  memory it allocated."""
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  start.record()
  fn()
  end.record()
  end.synchronize()
  return start.elapsed_time(end), torch.cuda.max_memory_allocated() / 1e9


def _turns(turns, calls: dict) -> dict:
  """{side: [ms, ...]} of ``calls[side]()`` timed in ``turns``."""
  times = {side: [] for side in calls}
  for side in turns:
    times[side].append(_timed_call(calls[side])[0])
  return times


def _check_carry(capture: CaptureFirstCall, what: str) -> float:
  """The captured LRU call had a carry from the cache; its kernel output
  bit for bit against the plain loop."""
  if capture.args is None:
    raise AssertionError(f"{what} never called lru_scan.")
  h0 = capture.args[2] if len(capture.args) > 2 else capture.kwargs.get("h0")
  if h0 is None or not bool(h0.any()):
    raise AssertionError(f"{what}: the scan took no carry from the cache.")
  err = check_lru(*capture.args, **capture.kwargs)
  log(f"  {what}: lru_scan on {tuple(capture.args[0].shape)} with a carry "
      f"from the cache, max_abs_err {err} vs lru_scan_plain (tolerance "
      f"{LRU_MAX_ABS_ERR})")
  return err


def phase_serving(dev, model, vocab, prompts, sampler, single,
                  kernels: list[dict], profile: bool) -> None:
  """The Sampler's serving features on the main path's 2B."""
  config = model.config
  n_recurrent = sum(
      bt is common.TemporalBlockType.RECURRENT for bt in config.block_types
  )
  log(f"== serving features on the main path's 2B: chunked prefill "
      f"({CHUNK_TOKENS}-token chunks), prefix caching, conversational "
      f"state, captured vs eager decode")
  by_name = {kernel["name"]: kernel for kernel in kernels}
  counts = lambda: {"lru_scan": lru_scan.launches,
                    "window_attention": wa.launches}
  rng = np.random.default_rng(SEED + 50)

  def words(n):
    return " ".join(f"w{i}" for i in rng.integers(0, config.vocab_size - 4, n))

  def launched(fn, want, what):
    """Runs ``fn`` with the counters reset; checks its launches."""
    lru_scan.launches = wa.launches = 0
    reset_scan_routes()
    result = fn()
    torch.cuda.synchronize()
    got = counts()
    log(f"  {what}: launches {got}")
    check_scan_routes(got["lru_scan"])
    if got != want:
      raise AssertionError(f"{what} launched {got}, want {want}.")
    return result

  run_kw = dict(total_generation_steps=DECODE_STEPS, return_logits=True,
                end_sampling_at_eos_token=False)
  served = 0  # LRU launches of the serving runs below

  # Chunked prefill of the main path's prompts.
  chunked = sampler_lib.Sampler(model, vocab, device=dev,
                                prefill_chunk_size=CHUNK_TOKENS)
  chunked(prompts, **run_kw)  # warm-up; captures its decode graph
  n_chunks = -(-max(PROMPT_TOKENS) // CHUNK_TOKENS)
  # The first scan of the second chunk: its carry comes from the cache.
  capture = CaptureFirstCall(lru_scan, "lru_scan", index=n_recurrent)
  try:
    out = launched(lambda: chunked(prompts, **run_kw),
                   {"lru_scan": n_chunks * n_recurrent,
                    "window_attention": 0},
                   f"chunked prefill ({n_chunks} chunks) + decode")
  finally:
    capture.restore()
  served += n_chunks * n_recurrent
  err = _check_carry(capture, "chunk 2")
  by_name["lru_scan"]["max_abs_err"] = max(by_name["lru_scan"]["max_abs_err"],
                                           err)
  chunk_logits = torch.stack(out.logits)
  single_logits = torch.stack(single.logits)
  rel = _rel_rms(chunk_logits[:, 0], single_logits[:, 0])
  agree = (torch.stack(out.tokens) == torch.stack(single.tokens)).float()
  log(f"  chunked vs single-shot prefill, last prompt position: logits "
      f"rel_rms {rel:.3e} (tolerance {MODEL_LOGITS_REL_RMS}); token "
      f"agreement of the {DECODE_STEPS}-token generations "
      f"{agree.mean().item():.4f}")
  if not (torch.isfinite(chunk_logits).all() and rel <= MODEL_LOGITS_REL_RMS):
    raise AssertionError("Chunked and single-shot prefill disagree.")
  ttft = {True: lambda: chunked(prompts, total_generation_steps=1),
          False: lambda: sampler(prompts, total_generation_steps=1)}
  peaks = {side: _timed_call(fn)[1] for side, fn in ttft.items()}
  times = _turns(GRAPH_TURNS, ttft)
  log(f"  prefill (time to the first token) ms in turns {GRAPH_TURNS} "
      f"(True: chunked): chunked {[round(t, 2) for t in times[True]]}, "
      f"single-shot {[round(t, 2) for t in times[False]]}; peak memory "
      f"chunked {peaks[True]:.2f} GB, single-shot {peaks[False]:.2f} GB")
  if profile:
    for side, label in ((True, "chunked"), (False, "single-shot")):
      profile_call(ttft[side], float(np.median(times[side])),
                   f"{label} prefill")

  # Prefix caching: a batch-1 prefix (two chunks) continued by two calls.
  prefix = words(PREFIX_TOKENS - 1)
  state = chunked.prefill_prefix(prefix)
  before = [t.clone() for t in sampler_lib._cache_leaves(state.cache)]
  for call in range(2):
    rows = [words(CONTINUATION_TOKENS) for _ in range(2)]
    capture = CaptureFirstCall(lru_scan, "lru_scan")
    try:
      got = launched(
          lambda: chunked(rows, total_generation_steps=1, return_logits=True,
                          prefix_state=state),
          {"lru_scan": n_recurrent, "window_attention": 0},
          f"continuation {call + 1} (2 x {CONTINUATION_TOKENS} tokens after "
          f"{PREFIX_TOKENS})")
    finally:
      capture.restore()
    served += n_recurrent
    err = _check_carry(capture, f"continuation {call + 1}")
    by_name["lru_scan"]["max_abs_err"] = max(
        by_name["lru_scan"]["max_abs_err"], err)
    full_rows = [f"{prefix} {r}" for r in rows]
    full = sampler(full_rows, total_generation_steps=1, return_logits=True)
    rel = _rel_rms(got.logits[0][0][None], full.logits[0][0][None])
    rel = max(rel, _rel_rms(got.logits[1][0][None], full.logits[1][0][None]))
    log(f"  continuation {call + 1} vs the full "
        f"{PREFIX_TOKENS + CONTINUATION_TOKENS}-token prompts in one call: "
        f"last logits "
        f"rel_rms {rel:.3e} (tolerance {MODEL_LOGITS_REL_RMS})")
    if not rel <= MODEL_LOGITS_REL_RMS:
      raise AssertionError("A prefix continuation disagrees with its full "
                           "prompt.")
  for a, b in zip(before, sampler_lib._cache_leaves(state.cache)):
    if not torch.equal(a, b):
      raise AssertionError("A continuation changed the prefix's cache.")
  times = _turns(GRAPH_TURNS, {
      True: lambda: chunked(rows, total_generation_steps=1,
                            prefix_state=state),
      False: lambda: sampler(full_rows, total_generation_steps=1)})
  log(f"  time to the first token, ms in turns {GRAPH_TURNS} (True: the "
      f"continuation from the prefix): continuation "
      f"{[round(t, 2) for t in times[True]]}, full prompt "
      f"{[round(t, 2) for t in times[False]]}; ratio of medians "
      f"{np.median(times[True]) / np.median(times[False]):.4f}")
  if profile:
    profile_call(lambda: chunked(rows, total_generation_steps=1,
                                 prefix_state=state),
                 float(np.median(times[True])), "continuation prefill")
  del state, before

  # Conversational state: each turn continues the last one's state.
  state, history = None, [vocab.bos_id()]
  for turn, n in enumerate(TURN_TOKENS):
    text = words(n)
    got = launched(
        lambda: sampler([text], total_generation_steps=TURN_STEPS,
                        return_logits=True, end_sampling_at_eos_token=False,
                        return_state=True, prefix_state=state),
        {"lru_scan": n_recurrent, "window_attention": 0},
        f"turn {turn + 1} ({n} prompt tokens)")
    served += n_recurrent
    history += vocab.EncodeAsIds(text)
    ids = torch.tensor([history], device=dev)
    with torch.inference_mode():
      whole, _ = model(ids, torch.arange(len(history), device=dev)[None],
                       return_cache=False, last_logits_only=True)
    rel = _rel_rms(got.logits[0][0], whole[0, 0])
    log(f"  turn {turn + 1} vs the {len(history)}-token history in one "
        f"call (teacher-forced): first logits rel_rms {rel:.3e} (tolerance "
        f"{MODEL_LOGITS_REL_RMS})")
    if not rel <= MODEL_LOGITS_REL_RMS:
      raise AssertionError(f"Turn {turn + 1} disagrees with its history.")
    history += got.tokens[0].tolist()
    state = got.state
  del state

  # Captured decode against eager decode, in turns.
  eager = sampler_lib.Sampler(model, vocab, device=dev, jit_compile=False)
  sides = {True: sampler, False: eager}
  per_step, outs = {True: [], False: []}, {True: [], False: []}
  probe = DecodeProbe(counts)
  try:
    for graph in GRAPH_TURNS:
      outs[graph].append(sides[graph](prompts, **run_kw))
      per_step[graph].append(probe.decode_ms())
  finally:
    probe.close()
  ref_tokens = torch.stack(outs[True][0].tokens)
  same = all(torch.equal(torch.stack(o.tokens), ref_tokens)
             for side in outs.values() for o in side)
  diff = max_err(torch.stack(outs[True][0].logits),
                 torch.stack(outs[False][0].logits))
  log(f"  decode ms a step in turns {GRAPH_TURNS} (True: captured): captured "
      f"{[round(ms, 3) for ms in per_step[True]]} (median "
      f"{np.median(per_step[True]):.3f}), eager "
      f"{[round(ms, 3) for ms in per_step[False]]} (median "
      f"{np.median(per_step[False]):.3f}); greedy tokens identical {same}; "
      f"logits max_abs_diff {diff:.3e}")
  if not same:
    raise AssertionError("Captured and eager greedy decode disagree.")
  for label, kw in (("categorical " + str(CATEGORICAL),
                     dict(deterministic_sampling=False, **CATEGORICAL)),
                    (f"greedy, repetition_penalty {SERVING_PENALTY}",
                     dict(repetition_penalty=SERVING_PENALTY))):
    got = {}
    for graph in (True, False):
      gen = torch.Generator(dev).manual_seed(SEED + 51)
      s = sampler_lib.Sampler(model, vocab, device=dev, jit_compile=graph,
                              **kw)
      got[graph] = (torch.stack(s(prompts, generator=gen, **run_kw).tokens),
                    gen.get_state())
    same = torch.equal(got[True][0], got[False][0])
    same_gen = torch.equal(got[True][1], got[False][1])
    log(f"  {label}: captured and eager tokens identical {same}, "
        f"generators at the same offset {same_gen}; first tokens "
        f"{got[True][0][:, :6].tolist()}")
    if not (same and same_gen):
      raise AssertionError(f"Captured and eager decode disagree ({label}).")
  if profile:
    for graph in (True, False):
      profile_decode(sides[graph], prompts, float(np.median(per_step[graph])),
                     "captured" if graph else "eager")

  by_name["lru_scan"]["launches"] += served
  log(f"  LRU launches of the serving runs: {served} (added to the "
      f"lru_scan row)")


class CaptureFirstCarry(CaptureFirstCall):
  """Keeps the arguments of the first scan that takes a carry (``h0``)."""

  def __call__(self, *args, **kwargs):
    h0 = args[2] if len(args) > 2 else kwargs.get("h0")
    if self.args is None and h0 is not None and bool(h0.any()):
      copy = lambda z: z.clone() if isinstance(z, torch.Tensor) else z
      self.args = tuple(copy(z) for z in args)
      self.kwargs = {key: copy(z) for key, z in kwargs.items()}
    self.calls += 1
    return self.wrapper(*args, **kwargs)


def _quantile(xs, q: float) -> float:
  xs = sorted(xs)
  return xs[min(len(xs) - 1, int(q * len(xs)))]


class BatcherRun:
  """Drives one ``ContinuousBatcher`` through a join schedule: one request
  joins a tick while a slot is free, every tick decodes BATCH_TICK steps.

  Records each request's tokens and log-probabilities, its time to the first
  token from its submission (host clock; a tick ends in a host fetch), each
  tick's host time with the admission work it did (prefill calls and their
  tokens), and the kernel launches of the ticks' decode (``_tick``)."""

  def __init__(self, batcher, sampler, counts):
    self.batcher, self.sampler, self.counts = batcher, sampler, counts
    self.tokens, self.logprobs, self.ttft_ms = {}, {}, {}
    self.ticks = []  # (host ms, [(prefill call, tokens), ...])
    self.tick_launches = {k: 0 for k in counts()}
    self._submitted, self._first, self._work = {}, {}, []
    batcher.stream_callback = self._on_tokens
    self._saved = (sampler._prefill_chunk_step, sampler._prefill)
    chunk_step, prefill = self._saved

    def counted_chunk(tokens, *args, **kwargs):
      self._work.append(("chunk", tokens.shape[1]))
      return chunk_step(tokens, *args, **kwargs)

    def counted_prefill(tokens, *args, **kwargs):
      self._work.append(("final", tokens.shape[1]))
      return prefill(tokens, *args, **kwargs)

    sampler._prefill_chunk_step = counted_chunk
    sampler._prefill = counted_prefill
    tick = batcher._tick

    def counted_tick(n):
      before = counts()
      tick(n)
      after = counts()
      for k in after:
        self.tick_launches[k] += after[k] - before[k]

    batcher._tick = counted_tick

  def close(self) -> None:
    del self.sampler._prefill_chunk_step, self.sampler._prefill
    del self.batcher._tick

  def _on_tokens(self, rid, tokens, done) -> None:
    if tokens and rid not in self._first:
      self._first[rid] = time.perf_counter()

  def run(self, specs: list[dict]) -> None:
    b, queue, names = self.batcher, list(specs), {}
    while queue or b.active_count:
      if queue and b.has_capacity:
        spec = queue.pop(0)
        # The chunk plan is made at add_request: the sampler's chunk size
        # is set for the chunked request alone.
        self.sampler.prefill_chunk_size = spec["chunk"]
        try:
          rid = b.add_request(spec["prompt"], **spec["kwargs"]())
        finally:
          self.sampler.prefill_chunk_size = None
        names[rid] = spec["name"]
        self._submitted[rid] = time.perf_counter()
      self._work = []
      start = time.perf_counter()
      b.step(BATCH_TICK)
      self.ticks.append(((time.perf_counter() - start) * 1e3, self._work))
      for rid, tokens, _ in b.pop_finished():
        name = names[rid]
        self.tokens[name] = tokens
        self.logprobs[name] = b.take_logprobs(rid)["token_logprobs"]
        self.ttft_ms[name] = (self._first[rid] - self._submitted[rid]) * 1e3


def _batch_specs(vocab, config, prefix_state, prefix_ids, seed: int):
  """The 16 requests of phase 17 (b): name, prompt, the chunk size of its
  plan, its add_request arguments (a fresh generator each run), and its
  token ids as the model sees them (for the teacher-forced check)."""
  rng = np.random.default_rng(seed)

  def words(n):
    return " ".join(f"w{i}" for i in rng.integers(0, config.vocab_size - 4, n))

  specs = []

  def add(name, n_tokens, chunk=None, categorical=False, prefix=False):
    text = words(n_tokens - (0 if prefix else 1))
    gen_seed = seed + len(specs)
    greedy = {} if categorical else {"top_k": 1}

    def kwargs():
      kw = dict(generator=torch.Generator("cuda").manual_seed(gen_seed),
                repetition_penalty=BATCH_PENALTY, **greedy)
      if prefix:
        kw["prefix_state"] = prefix_state
      return kw

    ids = (prefix_ids + vocab.EncodeAsIds(text) if prefix
           else [vocab.bos_id()] + vocab.EncodeAsIds(text))
    specs.append(dict(name=name, prompt=text, chunk=chunk, kwargs=kwargs,
                      ids=ids, categorical=categorical, prefix=prefix,
                      prefill_calls=-(-n_tokens // chunk) if chunk else 1,
                      window=not prefix and chunk is None
                      and n_tokens > ATTN_WINDOW))

  add("single_3000", BATCH_LONG_TOKENS)
  add("chunked_3000", BATCH_LONG_TOKENS, chunk=CHUNK_TOKENS)
  for i in range(2):
    add(f"prefix_{i}", BATCH_CONTINUATION_TOKENS, prefix=True)
  lengths = rng.integers(*BATCH_PROMPT_RANGE,
                         size=BATCH_REQUESTS - len(specs))
  for i, n in enumerate(lengths):
    categorical = i < BATCH_CATEGORICAL
    add(f"{'categorical' if categorical else 'greedy'}_{i}", int(n),
        categorical=categorical)
  return specs


def _teacher_logprobs(model, ids: list[int], tokens: list[int], dev):
  """Log-probabilities of ``tokens`` after ``ids`` from one batch-1 forward
  of the prompt (its cache) and one of the tokens, teacher-forced."""
  n = len(ids)
  with torch.inference_mode():
    first, cache = model(torch.tensor([ids], device=dev),
                         torch.arange(n, device=dev)[None],
                         last_logits_only=True)
    rest, _ = model(torch.tensor([tokens[:-1]], device=dev),
                    torch.arange(n, n + len(tokens) - 1, device=dev)[None],
                    cache, return_cache=False)
  logits = torch.cat([first, rest], dim=1)[0].float()
  lp = torch.log_softmax(logits, dim=-1)
  return lp.gather(1, torch.tensor(tokens, device=dev)[:, None])[:, 0]


def phase_batcher(dev, model, vocab, prompts, sampler, kernels: list[dict],
                  profile: bool) -> None:
  """Continuous batching and the HTTP front end on the main path's 2B."""
  config = model.config
  n_recurrent = sum(
      bt is common.TemporalBlockType.RECURRENT for bt in config.block_types
  )
  n_attention = config.num_layers - n_recurrent
  by_name = {kernel["name"]: kernel for kernel in kernels}
  counts = lambda: {"lru_scan": lru_scan.launches,  # noqa: E731
                    "window_attention": wa.launches}
  log(f"== continuous batching on the main path's 2B: one slot against the "
      f"solo Sampler, {BATCH_SLOTS} slots x {BATCH_REQUESTS} requests in two "
      f"join orders, the {BATCH_SLOTS}-slot tick against the batch-2 decode "
      f"step, the HTTP front end")
  served = {k: 0 for k in counts()}

  # (a) One slot against the solo Sampler: the same batch-1 prefill, and a
  # captured one-row decode step on each side.
  rng = np.random.default_rng(SEED + 60)
  one = " ".join(f"w{i}" for i in rng.integers(0, config.vocab_size - 4,
                                               BATCH_LONG_TOKENS - 1))
  penalized = sampler_lib.Sampler(model, vocab, device=dev,
                                  repetition_penalty=BATCH_PENALTY)
  solo = penalized([one], total_generation_steps=DECODE_STEPS,
                   end_sampling_at_eos_token=False).tokens[0].tolist()
  b1 = serving.ContinuousBatcher(penalized, num_slots=1,
                                 max_steps_default=DECODE_STEPS)
  before = counts()
  b1.add_request(one)
  ((_, got, _),) = b1.run_until_drained(BATCH_TICK)
  for k, v in counts().items():
    served[k] += v - before[k]
  log(f"  (a) one slot, a {BATCH_LONG_TOKENS}-token prompt, {DECODE_STEPS} "
      f"greedy steps, repetition penalty {BATCH_PENALTY}: tokens identical to "
      f"the solo Sampler's {got == solo}; {len(set(got))} distinct tokens, "
      f"first {got[:6]}")
  if got != solo or len(got) != len(solo):
    raise AssertionError("The one-slot batcher and the solo Sampler "
                         "disagree.")
  del b1, penalized

  # (b) Eight slots, sixteen requests joining over the ticks, twice.
  cat = sampler_lib.Sampler(model, vocab, device=dev,
                            deterministic_sampling=False, **CATEGORICAL)
  prefix_text = " ".join(f"w{i}" for i in rng.integers(
      0, config.vocab_size - 4, PREFIX_TOKENS - 1))
  prefix_state = cat.prefill_prefix(prefix_text)
  prefix_ids = cat.tokenize(prefix_text)
  specs = _batch_specs(vocab, config, prefix_state, prefix_ids, SEED + 61)
  want = {"lru_scan": n_recurrent * sum(s["prefill_calls"] for s in specs),
          "window_attention": n_attention * sum(s["window"] for s in specs)}
  orders = {"A": specs, "B": specs[::-1][1::2] + specs[::-1][0::2]}
  runs = {}
  for label, order in orders.items():
    batcher = serving.ContinuousBatcher(
        cat, num_slots=BATCH_SLOTS, max_steps_default=BATCH_STEPS,
        admission_chunks_per_tick=1, per_request_sampling=True,
        record_logprobs=1)
    run = BatcherRun(batcher, cat, counts)
    window_cap = CaptureFirstCall(wa, "window_attention")
    carry_cap = CaptureFirstCarry(lru_scan, "lru_scan")
    lru_scan.launches = wa.launches = 0
    reset_scan_routes()
    start = time.perf_counter()
    try:
      run.run(order)
      torch.cuda.synchronize()
    finally:
      window_cap.restore()
      carry_cap.restore()
      run.close()
    wall_s = time.perf_counter() - start
    got = counts()
    check_scan_routes(got["lru_scan"])
    for k, v in got.items():
      served[k] += v
    log(f"  (b) order {label}: {len(run.ticks)} ticks in {wall_s:.2f} s; "
        f"launches {got} (want {want}), in the ticks {run.tick_launches}")
    if got != want or any(run.tick_launches.values()):
      raise AssertionError(f"Order {label} launched {got} (ticks "
                           f"{run.tick_launches}), want {want} and none in "
                           f"the ticks.")
    if sorted(run.tokens) != sorted(s["name"] for s in specs):
      raise AssertionError(f"Order {label} finished {sorted(run.tokens)}.")
    if label == "A":
      err = max(check_attention(*window_cap.args, **window_cap.kwargs))
      by_name["window_attention"]["max_abs_err"] = max(
          by_name["window_attention"]["max_abs_err"], err)
      err = _check_carry(carry_cap, "an admission's continued chunk")
      by_name["lru_scan"]["max_abs_err"] = max(
          by_name["lru_scan"]["max_abs_err"], err)
    runs[label] = (run, batcher)

  run_a, batcher_a = runs["A"]
  run_b, _ = runs["B"]
  same = {s["name"]: run_a.tokens[s["name"]] == run_b.tokens[s["name"]]
          for s in specs}
  distinct = [len(set(t)) for t in run_a.tokens.values()]
  log(f"  distinct tokens a request: min {min(distinct)}, median "
      f"{int(np.median(distinct))}, max {max(distinct)} of {BATCH_STEPS}")
  log(f"  tokens identical between the join orders: "
      f"{sum(same.values())} of {len(same)} (greedy "
      f"{sum(v for n, v in same.items() if 'categorical' not in n)}, "
      f"categorical {sum(v for n, v in same.items() if 'categorical' in n)})")
  if not all(same.values()):
    raise AssertionError(f"Join orders disagree: "
                         f"{[n for n, v in same.items() if not v]}.")
  diffs, refs = [], []
  for s in specs:
    tokens = run_a.tokens[s["name"]]
    if not (len(tokens) == BATCH_STEPS or (
        0 < len(tokens) < BATCH_STEPS and tokens[-1] == vocab.eos_id())):
      raise AssertionError(f"{s['name']} emitted {len(tokens)} tokens.")
    teacher = _teacher_logprobs(model, s["ids"], tokens, dev)
    got_lp = torch.tensor(run_a.logprobs[s["name"]], device=dev)
    diffs.append(got_lp - teacher)
    refs.append(teacher)
  diff, ref = torch.cat(diffs), torch.cat(refs)
  rel = (diff.square().mean().sqrt() / ref.square().mean().sqrt()).item()
  log(f"  recorded log-probabilities vs one teacher-forced batch-1 forward "
      f"of each request's prompt and tokens ({diff.numel()} tokens): rel_rms "
      f"{rel:.3e} (tolerance {LOGPROB_REL_RMS}), max_abs "
      f"{diff.abs().max().item():.3e}, mean log-probability "
      f"{ref.mean().item():.3f}")
  if not rel <= LOGPROB_REL_RMS:
    raise AssertionError("Recorded log-probabilities disagree with the "
                         "teacher-forced forward.")
  # Against solo batch-1 calls the shapes differ (cuBLAS may take other
  # algorithms for one row than for eight): printed, not required.
  solo_sampler = sampler_lib.Sampler(model, vocab, device=dev,
                                     repetition_penalty=BATCH_PENALTY)
  agree = total = 0
  for s in specs:
    if s["categorical"]:
      continue
    kw = {"prefix_state": prefix_state} if s["prefix"] else {}
    want_tokens = solo_sampler([s["prompt"]], BATCH_STEPS,
                               **kw).tokens[0].tolist()
    got_tokens = run_a.tokens[s["name"]]
    agree += sum(a == b for a, b in zip(got_tokens, want_tokens))
    total += len(got_tokens)
  log(f"  greedy requests against solo batch-1 Sampler calls (penalty "
      f"{BATCH_PENALTY}): token agreement {agree} of {total}")
  del solo_sampler

  # (c) Numbers: time to the first token under load, the admission stall,
  # and the eight-slot tick against the batch-2 decode step in turns.
  ttfts = [ms for r in (run_a, run_b) for ms in r.ttft_ms.values()]
  log(f"  time to the first token from submission under load (both orders, "
      f"{len(ttfts)} requests): p50 {_quantile(ttfts, 0.5):.1f} ms, p90 "
      f"{_quantile(ttfts, 0.9):.1f} ms, max {max(ttfts):.1f} ms")
  kinds = {}
  for ms, work in run_a.ticks[1:] + run_b.ticks[1:]:  # not the captures
    if not work:
      key = "no admission"
    elif work == [("chunk", CHUNK_TOKENS)]:
      key = f"one {CHUNK_TOKENS}-token chunk"
    elif len(work) == 1 and work[0][0] == "final":
      key = ("a 3000-token single shot" if work[0][1] > ATTN_WINDOW
             else "a final prefill of <= 1500 tokens")
    else:
      key = "other"
    kinds.setdefault(key, []).append(ms)
  idle_tick = float(np.median(kinds["no admission"]))
  for key, values in sorted(kinds.items()):
    med = float(np.median(values))
    log(f"    tick ({BATCH_TICK} steps) with {key}: median {med:.2f} ms over "
        f"{len(values)} ticks (stall {med - idle_tick:+.2f} ms)")

  steady = serving.ContinuousBatcher(sampler, num_slots=BATCH_SLOTS,
                                     max_steps_default=4096)
  for i in range(BATCH_SLOTS):
    steady.add_request(" ".join(f"w{j}" for j in rng.integers(
        0, config.vocab_size - 4, 300)))
  steady.step(BATCH_TICK)  # admits all eight and captures the tick
  probe = DecodeProbe(counts)
  tick_ms, step2_ms = [], []
  try:
    for tick in TICK_TURNS:
      if tick:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        with torch.inference_mode():
          for _ in range(TICK_REPEATS):
            steady._tick(BATCH_TICK)
        end.record()
        end.synchronize()
        tick_ms.append(start.elapsed_time(end) / TICK_REPEATS)
      else:
        sampler(prompts, total_generation_steps=DECODE_STEPS,
                end_sampling_at_eos_token=False)
        step2_ms.append(probe.decode_ms())
  finally:
    probe.close()
  live = steady.active_count
  per_step = [ms / BATCH_TICK for ms in tick_ms]
  log(f"  decode ms a step in turns {TICK_TURNS} (True: the "
      f"{BATCH_SLOTS}-slot tick of {BATCH_TICK} steps, {live} rows live, "
      f"CUDA events around {TICK_REPEATS} ticks; False: the Sampler's "
      f"captured batch-2 step): {BATCH_SLOTS} slots "
      f"{[round(ms, 3) for ms in per_step]}, batch 2 "
      f"{[round(ms, 3) for ms in step2_ms]}; ratio of medians "
      f"{np.median(per_step) / np.median(step2_ms):.3f}; aggregate "
      f"{live * 1e3 / np.median(per_step):.1f} tokens/s at "
      f"{BATCH_SLOTS} slots against {2 * 1e3 / np.median(step2_ms):.1f} at "
      f"batch 2")
  if live != BATCH_SLOTS:
    raise AssertionError(f"{live} of {BATCH_SLOTS} steady rows live.")
  if profile:
    with torch.inference_mode():
      profile_call(lambda: steady._tick(BATCH_TICK),
                   float(np.median(tick_ms)),
                   f"{BATCH_SLOTS}-slot tick of {BATCH_TICK} steps")
  del steady, runs, run_a, run_b, batcher_a, prefix_state

  # (d) The HTTP front end, on a driver thread that captures its own tick.
  http_rng = np.random.default_rng(SEED + 62)
  http_prompt = " ".join(f"w{i}" for i in http_rng.integers(
      0, config.vocab_size - 4, HTTP_PROMPT_TOKENS))
  direct = serving.ContinuousBatcher(sampler, num_slots=HTTP_SLOTS,
                                     max_steps_default=HTTP_STEPS,
                                     preserve_states=True,
                                     per_request_sampling=True)
  direct.add_request(http_prompt, repetition_penalty=BATCH_PENALTY)
  ((_, direct_tokens, _),) = direct.run_until_drained(BATCH_TICK)
  del direct
  frontend = server_lib.ServingFrontend(
      serving.ContinuousBatcher(sampler, num_slots=HTTP_SLOTS,
                                max_steps_default=HTTP_STEPS,
                                preserve_states=True,
                                per_request_sampling=True,
                                reuse_programs=False),
      step_size=BATCH_TICK)
  srv = server_lib.ServingHTTPServer(frontend, host="127.0.0.1", port=0,
                                     model_name="recurrentgemma-2b")
  before = counts()
  try:
    http_checks(srv.port, http_prompt, direct_tokens)
  finally:
    srv.close()
  for k, v in counts().items():
    served[k] += v - before[k]
  if frontend._error is not None:
    raise AssertionError(f"The serving driver died: {frontend._error}")

  for name in served:
    by_name[name]["launches"] += served[name]
  log(f"  launches of the batching runs: {served} (added to their rows)")


def _http(port: int, path: str, body: dict | None = None, stream=False):
  url = f"http://127.0.0.1:{port}{path}"
  data = None if body is None else json.dumps(body).encode()
  req = urllib.request.Request(url, data=data,
                               headers={"Content-Type": "application/json"})
  resp = urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S)
  if stream:
    return resp
  with resp:
    raw = resp.read()
    return (resp.status, resp.headers["Content-Type"],
            json.loads(raw) if raw.startswith(b"{") else raw.decode())


def http_checks(port: int, prompt: str, direct_tokens: list[int]) -> None:
  """Every route of the front end once; each body must be well-formed.
  Generation requests carry BATCH_PENALTY (a per-request sampling
  batcher)."""
  gen = {"max_tokens": HTTP_STEPS, "repetition_penalty": BATCH_PENALTY}
  status, _, out = _http(port, "/v1/generate", {"prompt": prompt, **gen})
  log(f"  (d) /v1/generate: status {status}, {len(out['tokens'])} tokens "
      f"({len(set(out['tokens']))} distinct), identical to a direct "
      f"{HTTP_SLOTS}-slot batcher run {out['tokens'] == direct_tokens}")
  if status != 200 or out["tokens"] != direct_tokens or not isinstance(
      out["text"], str):
    raise AssertionError(f"/v1/generate answered {out}.")
  with _http(port, "/v1/generate", {"prompt": prompt, "stream": True, **gen},
             stream=True) as resp:
    lines = [json.loads(line) for line in resp]
  streamed = [t for line in lines for t in line.get("tokens", [])]
  log(f"  /v1/generate streaming: {len(lines)} NDJSON lines, tokens equal "
      f"to the plain call's {streamed == direct_tokens}")
  if not lines[-1].get("done") or streamed != direct_tokens:
    raise AssertionError(f"Streaming /v1/generate answered {lines}.")
  turns = []
  for text in (prompt, "w1 w2 w3"):
    _, _, out = _http(port, "/v1/generate",
                      {"prompt": text, "session": "s1", **gen})
    turns.append(out["tokens"])
  log(f"  a two-turn session: {[len(t) for t in turns]} tokens; turn 1 as "
      f"the plain call {turns[0] == direct_tokens}")
  if turns[0] != direct_tokens or not turns[1]:
    raise AssertionError(f"The session answered {turns}.")
  events = []
  with _http(port, "/v1/chat/completions", {
      "messages": [{"role": "user", "content": prompt}], "stream": True,
      **gen}, stream=True) as resp:
    for line in resp:
      line = line.decode().strip()
      if line.startswith("data: "):
        events.append(line[len("data: "):])
  chunks = [json.loads(e) for e in events[:-1]]
  content = "".join(c["choices"][0]["delta"].get("content", "")
                    for c in chunks)
  log(f"  /v1/chat/completions streaming: {len(chunks)} chunks, "
      f"{len(content)} characters, finish "
      f"{chunks[-1]['choices'][0]['finish_reason']}")
  if events[-1] != "[DONE]" or not content or chunks[-1]["choices"][0][
      "finish_reason"] not in ("stop", "length"):
    raise AssertionError(f"Chat streaming answered {events}.")
  _, _, out = _http(port, "/v1/completions", {"prompt": prompt, "n": 2, **gen})
  texts = [c["text"] for c in out["choices"]]
  log(f"  /v1/completions n=2: choices {[c['index'] for c in out['choices']]}"
      f", usage {out['usage']}, texts identical (greedy) "
      f"{texts[0] == texts[1]}")
  if [c["index"] for c in out["choices"]] != [0, 1] or texts[0] != texts[1]:
    raise AssertionError(f"/v1/completions answered {out}.")
  with _http(port, "/v1/generate",
             {"prompt": prompt, "stream": True, **gen,
              "max_tokens": HTTP_CANCEL_STEPS}, stream=True) as resp:
    first = json.loads(resp.readline())
    _, _, cancelled = _http(port, "/v1/cancel", {"id": first["id"]})
    rest = [json.loads(line) for line in resp]
  log(f"  /v1/cancel of request {first['id']} after its first "
      f"{len(first['tokens'])} tokens: {cancelled}; the stream ended with "
      f"{rest[-1]}")
  if cancelled != {"cancelled": True} or not rest[-1].get("cancelled"):
    raise AssertionError("/v1/cancel did not end the stream.")
  _, _, health = _http(port, "/v1/health")
  _, kind, metrics = _http(port, "/metrics")
  log(f"  /v1/health: {health}")
  log(f"  /metrics ({kind}): {len(metrics.splitlines())} lines, "
      f"{[l for l in metrics.splitlines() if 'completed' in l]}")
  if not (health["ok"] and health["completed"] >= 6
          and health["cancelled"] == 1 and "cadence_up 1" in metrics):
    raise AssertionError("/v1/health or /metrics is wrong.")


def profile_call(fn, wall_ms: float, label: str) -> None:
  """Kernel time of one call against its time: the device's idle share."""
  times = kernel_times(fn)
  busy = sum(ms for ms, _ in times.values())
  log(f"  {label}: kernels busy {busy:.3f} ms of {wall_ms:.3f} ms (device "
      f"idle share {1 - busy / wall_ms:.3f}), "
      f"{sum(n for _, n in times.values())} kernels")


def profile_decode(sampler, prompts, decode_ms: float, label: str) -> None:
  """Kernel time of a decode step against its time: the idle share."""
  _, decode_k = decode_kernel_times(sampler, prompts)
  busy = sum(ms for ms, _ in decode_k.values()) / DECODE_STEPS
  kernels = sum(n for _, n in decode_k.values()) / DECODE_STEPS
  log(f"  {label} decode: kernels busy {busy:.3f} ms of {decode_ms:.3f} ms "
      f"a step (device idle share {1 - busy / decode_ms:.3f}), {kernels:.1f} "
      f"kernels a step")


def training_segment_pos(dev) -> torch.Tensor:
  """The training batch's positions: row 1 right-padded after 3000 tokens,
  its pad positions repeating the last real one (``get_positions``)."""
  tokens = torch.ones(2, TRAIN_TOKENS, dtype=torch.long, device=dev)
  tokens[1, TRAIN_REAL_TOKENS[1]:] = 0
  return trainer.get_positions(tokens, 0)


def phase_lru_backward(dev) -> dict:
  b, t, d = LRU_TRAIN_SHAPE
  rng = np.random.default_rng(SEED + 3)
  g = torch.tensor(rng.standard_normal(LRU_TRAIN_SHAPE, dtype=np.float32),
                   device=dev).bfloat16()
  a = torch.sigmoid(torch.tensor(
      rng.standard_normal(LRU_TRAIN_SHAPE, dtype=np.float32), device=dev
  )).bfloat16()
  dh_last = torch.tensor(rng.standard_normal((b, d), dtype=np.float32),
                         device=dev)
  log(f"== lru_scan_backward vs plain at [{b},{t},{d}] bf16 "
      f"(tolerance {LRU_BWD_MAX_ABS_ERR})")
  worst = 0.0
  for reverse in (False, True):
    for carry in (None, dh_last):
      err = check_lru_backward(g, a, carry, reverse)
      log(f"  reverse={reverse} dh_last={carry is not None}: max_abs_err {err}")
      worst = max(worst, err)
  # Timed as training calls it: the forward scan's cotangents, dh_last
  # given. Read g and a, write dx (bf16); read dh_last, write dh0 (fp32);
  # two fp32 flops a step.
  n_bytes = 3 * b * t * d * 2 + 2 * b * d * 4
  figures = time_scan(
      lambda g, a: lru_scan.lru_scan_backward(g, a, dh_last), (g, a),
      n_bytes, 2 * b * t * d)
  plain_ms = cuda_ms(
      lambda: lru_scan.lru_scan_backward_plain(g, a, dh_last), reps=2
  )
  log_scan(figures, plain_ms, n_bytes)
  return dict(name="lru_scan_backward", route="cuda",
              source="cadence_gemma_tpu_torch/csrc/lru_scan.cu",
              replaces=LRU_BWD_REPLACES, max_abs_err=worst,
              plain_ms=plain_ms, library_ms=None, **figures)


def phase_attention_backward(dev) -> list[dict]:
  b, t, n, h = ATTN_TRAIN_SHAPE
  rng = np.random.default_rng(SEED + 4)
  q, k, v, g = (
      torch.tensor(rng.standard_normal(s, dtype=np.float32),
                   device=dev).bfloat16()
      for s in ((b, t, n, h), (b, t, 1, h), (b, t, 1, h), (b, t, n, h))
  )
  seg = training_segment_pos(dev)
  log(f"== window_attention dq and dk/dv vs plain at [{b},{t},{n},{h}] bf16, "
      f"window {ATTN_WINDOW}, row 1 right-padded after "
      f"{TRAIN_REAL_TOKENS[1]} (tolerance {ATTN_BWD_REL_ERR} of the largest "
      f"gradient)")
  out, lse = wa.window_attention(q, k, v, seg, ATTN_WINDOW)
  delta = wa.attention_delta(out, g)
  args = (q, k, v, seg, lse, delta, g, ATTN_WINDOW)
  dq_err = check_dq(*args)
  dkv_err = check_dkv(*args)
  return backward_rows(args, dq_err, dkv_err)


def backward_rows(args, dq_err: float, dkv_err: float,
                  suffix: str = "") -> list[dict]:
  """Times dq and dk/dv on ``args`` (the wrappers' arguments) and their
  plain versions; their bounds over this run's visible (query, key) pairs,
  TFLOP/s, shares of the bound and resources, and the pair's summed time
  against SDPA's backward, which computes dq, dk and dv in one call."""
  q, k, v, seg, _, _, g, window, *rest = args
  kv_prefix = rest[0] if rest else 0
  b, t, n, h = q.shape
  kv_len = k.shape[1]
  # The yardstick: SDPA's backward with the same visibility as a boolean
  # mask (forward + backward, minus the forward), k and v expanded to the
  # n query heads.
  visible = wa.band_mask(seg, t, window, kv_prefix)  # [b, t, P + t]
  pairs = int(visible.sum().item())
  qt, kt, vt = (z.transpose(1, 2).detach().requires_grad_()
                for z in (q, k, v))
  gt = g.transpose(1, 2)

  def sdpa():
    return torch.nn.functional.scaled_dot_product_attention(
        qt, kt.expand(-1, n, -1, -1), vt.expand(-1, n, -1, -1),
        attn_mask=visible[:, None],
    )

  def sdpa_forward_backward():
    torch.autograd.grad(sdpa(), (qt, kt, vt), gt)

  with torch.no_grad():
    sdpa_fwd_ms = cuda_ms(sdpa, 5)
  library_ms = cuda_ms(sdpa_forward_backward, 5) - sdpa_fwd_ms
  del qt, kt, vt, gt, visible
  dq_ms = cuda_ms(lambda: wa.window_attention_dq(*args), 10)
  dkv_ms = cuda_ms(lambda: wa.window_attention_dkv(*args), 10)
  dq_plain_ms = cuda_ms(lambda: wa.window_attention_dq_plain(*args), 2)
  dkv_plain_ms = cuda_ms(lambda: wa.window_attention_dkv_plain(*args), 2)
  pair_ms = dq_ms + dkv_ms
  # Bytes: q and dO, k and v over all kv_len keys in bf16, segment_pos, lse
  # and delta in 32 bits, and the outputs (dq; dk and dv over kv_len keys).
  # Operations: 2 h flops per product per visible pair and head; dq does 3
  # products (s, dO.v, ds k), dk/dv 4 (s, dO.v, p dO, ds q).
  inputs = 2 * (2 * b * t * n * h + 2 * b * kv_len * h) + 4 * b * t + (
      2 * 4 * b * n * t)
  rows = []
  for name, ms, plain_ms, err, products, n_out, replaces in (
      ("window_attention_dq", dq_ms, dq_plain_ms, dq_err, 3, b * t * n * h,
       DQ_REPLACES),
      ("window_attention_dkv", dkv_ms, dkv_plain_ms, dkv_err, 4,
       2 * b * kv_len * h, DKV_REPLACES),
  ):
    flops = 2 * products * n * h * pairs
    bound_ms, bound_by = bound(inputs + 2 * n_out, flops, BF16_TENSOR_FLOPS)
    figures = speed(ms, flops, bound_ms, None)
    log(f"  {name + suffix}: ms {ms:.4f}  plain_ms {plain_ms:.3f}  bound_ms "
        f"{bound_ms:.4f} ({bound_by}, {flops / 1e9:.1f} GFLOP over {pairs} "
        f"visible pairs): {figures['tflops']:.1f} TFLOP/s, "
        f"{100 * figures['bound_share']:.1f}% of the bound")
    rows.append(dict(
        name=name + suffix, route="cuda",
        source="cadence_gemma_tpu_torch/csrc/window_attention_backward.cu",
        replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        tflops=figures["tflops"], bound_share=figures["bound_share"],
        pair_ms=pair_ms, pair_sdpa_ratio=pair_ms / library_ms,
        **resources("window_attention_backward", h, name),
    ))
  log(f"  the pair dq + dk/dv {pair_ms:.4f} ms against SDPA's backward "
      f"{library_ms:.4f} ms (dq, dk and dv together; k and v expanded to {n} "
      f"heads): {pair_ms / library_ms:.3f} x SDPA")
  return rows


def check_lru_backward(g, a, dh_last=None, reverse=False) -> float:
  """Max abs error of the cotangent-scan kernel against its plain version;
  raises above the tolerance."""
  dx, dh0 = lru_scan.lru_scan_backward(g, a, dh_last, reverse)
  dx_ref, dh0_ref = lru_scan.lru_scan_backward_plain(g, a, dh_last, reverse)
  err = max(max_err(dx, dx_ref), max_err(dh0, dh0_ref))
  if not err <= LRU_BWD_MAX_ABS_ERR:
    raise AssertionError(
        f"lru_scan_backward disagrees with its plain version: {err}"
    )
  return err


def _check_relative(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
  scale = want.float().abs().max().item()
  err = max_err(got, want)
  log(f"  {name}: max_abs_err {err:.4e} (largest |gradient| {scale:.4e}, "
      f"ratio {err / scale:.3e})")
  if not (torch.isfinite(got).all() and err <= ATTN_BWD_REL_ERR * scale):
    raise AssertionError(f"{name} disagrees with its plain version.")
  return err


def check_dq(*args) -> float:
  """Max abs error of the dq kernel against its plain version; raises above
  the tolerance or if a row that sees no key gets a gradient."""
  return _check_relative("dq", wa.window_attention_dq(*args),
                         wa.window_attention_dq_plain(*args))


def check_dkv(*args) -> float:
  dk, dv = wa.window_attention_dkv(*args)
  dk_ref, dv_ref = wa.window_attention_dkv_plain(*args)
  return max(_check_relative("dk", dk, dk_ref),
             _check_relative("dv", dv, dv_ref))


def training_batch(vocab_size: int) -> data_lib.TrainingInput:
  """Two rows of random tokens after BOS: row 0 fills 4096, row 1 holds
  3000 and is right-padded; the loss covers the second half of each."""
  rng = np.random.default_rng(SEED + 5)
  tokens = rng.integers(4, vocab_size, (2, TRAIN_TOKENS)).astype(np.int32)
  tokens[:, 0] = 1
  mask = np.zeros(tokens.shape, bool)
  for row, real in enumerate(TRAIN_REAL_TOKENS):
    tokens[row, real:] = 0
    mask[row, real // 2:real] = True
  return data_lib.TrainingInput(input_tokens=tokens, target_mask=mask)


def _launch_counts() -> dict[str, int]:
  return {"lru_scan": lru_scan.launches,
          "lru_scan_backward": lru_scan.backward_launches,
          "window_attention": wa.launches,
          "window_attention_dq": wa.dq_launches,
          "window_attention_dkv": wa.dkv_launches}


def _reset_launch_counts() -> None:
  lru_scan.launches = lru_scan.backward_launches = 0
  wa.launches = wa.dq_launches = wa.dkv_launches = 0
  reset_scan_routes()


def phase_training(dev, kernels: list[dict], profile: bool) -> None:
  config = common.GriffinConfig.from_preset(
      common.Preset.RECURRENT_GEMMA_2B_V1
  )
  start = time.perf_counter()
  model = griffin.Griffin(
      config, device=dev, dtype=torch.bfloat16,
      generator=torch.Generator(dev).manual_seed(SEED + 6),
  )
  torch.cuda.synchronize()
  log(f"== training path: RecurrentGemma-2B, {config.num_layers} blocks, "
      f"width {config.width}, bf16 weights (built in "
      f"{time.perf_counter() - start:.1f} s); train_loop, {TRAIN_STEPS} "
      f"AdamW steps at learning rate {TRAIN_LEARNING_RATE}, batch 2 x "
      f"{TRAIN_TOKENS} ({sum(TRAIN_REAL_TOKENS)} real tokens)")
  batch = training_batch(config.vocab_size)
  n_recurrent = sum(
      bt is common.TemporalBlockType.RECURRENT for bt in config.block_types
  )
  n_attention = config.num_layers - n_recurrent

  steps = []  # (step, loss, host time after the loss reached the host)

  def log_metrics(metrics, step):
    steps.append((step, metrics["train_loss"], time.perf_counter()))

  # The first step's inputs to each backward kernel, for the checks below.
  captures = [CaptureFirstCall(lru_scan, "lru_scan_backward"),
              CaptureFirstCall(wa, "window_attention_dq"),
              CaptureFirstCall(wa, "window_attention_dkv")]
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  _reset_launch_counts()
  start = time.perf_counter()
  try:
    train_loop_lib.train_loop(
        model, [batch] * TRAIN_STEPS,
        train_loop_lib.TrainingConfig(learning_rate=TRAIN_LEARNING_RATE,
                                      eval_every_n=1, max_steps=TRAIN_STEPS),
        log_metrics=log_metrics, device=dev,
    )
  finally:
    for capture in captures:
      capture.restore()
  torch.cuda.synchronize()
  launches = _launch_counts()
  peak_gb = torch.cuda.max_memory_allocated() / 1e9

  per_step = {"lru_scan": 2 * n_recurrent, "lru_scan_backward": n_recurrent,
              "window_attention": 2 * n_attention,
              "window_attention_dq": n_attention,
              "window_attention_dkv": n_attention}
  want = {name: TRAIN_STEPS * count for name, count in per_step.items()}
  log(f"  launches in the {TRAIN_STEPS} steps {launches}")
  if launches != want:
    raise AssertionError(f"Training launched {launches}, want {want} "
                         f"({per_step} a step).")
  check_scan_routes(launches["lru_scan"] + launches["lru_scan_backward"])
  losses = [loss for _, loss, _ in steps]
  times = [start] + [t for _, _, t in steps]
  step_ms = [(b - a) * 1e3 for a, b in zip(times, times[1:])]
  log(f"  losses {losses}")
  if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
    raise AssertionError(f"Non-finite or missing losses: {losses}.")
  if not losses[-1] < losses[0]:
    raise AssertionError(f"The loss did not fall: {losses}.")
  steady_ms = float(np.mean(step_ms[1:]))
  real_tokens = sum(TRAIN_REAL_TOKENS)
  log(f"  ms per step {[round(ms, 1) for ms in step_ms]} (the first "
      f"includes warm-up); steady {steady_ms:.1f} ms "
      f"({real_tokens / steady_ms * 1e3:.0f} real tokens/s); peak "
      f"{peak_gb:.2f} GB")

  # Each backward kernel against its plain version on the inputs the first
  # training step gave it.
  checks = {"lru_scan_backward": check_lru_backward,
            "window_attention_dq": check_dq,
            "window_attention_dkv": check_dkv}
  by_name = {kernel["name"]: kernel for kernel in kernels}
  for capture in captures:
    name = capture.name
    if capture.args is None:
      raise AssertionError(f"Training never called {name}.")
    tensors = [z for z in (*capture.args, *capture.kwargs.values())
               if isinstance(z, torch.Tensor)]
    log(f"  {name} on the training step's inputs "
        f"{[(tuple(z.shape), str(z.dtype)) for z in tensors]}:")
    err = checks[name](*capture.args, **capture.kwargs)
    log(f"  {name} max_abs_err {err}")
    by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], err)
    by_name[name]["launches"] = launches[name]
    capture.args = capture.kwargs = None
  del captures
  compare_gradient_paths(model, config, dev)
  if profile:
    profile_training(model, batch, dev, steady_ms)


def _leaf_stats(grads, grads_ref) -> list[tuple[float, float, str]]:
  """(relative RMS of the difference, cosine, name) per parameter leaf."""
  stats = []
  for name, g in grads.items():
    g, r = g.float(), grads_ref[name].float()
    rel_rms = ((g - r).square().mean().sqrt()
               / r.square().mean().sqrt().clamp_min(1e-30)).item()
    cosine = torch.nn.functional.cosine_similarity(
        g.flatten(), r.flatten(), dim=0).item()
    stats.append((rel_rms, cosine, name))
  return sorted(stats, reverse=True)


def _log_leaf_stats(label: str, stats) -> None:
  worst_cos = min(stats, key=lambda s: s[1])
  log(f"  {label}: median rel_rms {stats[len(stats) // 2][0]:.3e}, worst "
      f"{stats[0][2]} {stats[0][0]:.3e}; lowest cosine {worst_cos[2]} "
      f"{worst_cos[1]:.6f}")


def compare_gradient_paths(model, config, dev) -> None:
  """Loss and gradients of one sequence through the kernels vs the plain
  path (autograd of the sequential scan and of the einsum attention), both
  in bf16 and held against the plain path of a float32 copy of the model."""
  model.zero_grad(set_to_none=True)
  torch.cuda.empty_cache()
  rng = np.random.default_rng(SEED + 7)
  tokens = torch.tensor(
      [[1, *rng.integers(4, config.vocab_size, GRAD_REFERENCE_TOKENS - 1)]],
      device=dev,
  )
  mask = torch.zeros_like(tokens, dtype=torch.bool)
  mask[:, GRAD_REFERENCE_TOKENS // 2:] = True

  def loss_and_grads(net):
    loss = trainer.accumulate_gradients(net, 0, tokens, mask)
    # The text loss does not reach the vision-language connector.
    grads = {n: p.grad for n, p in net.named_parameters()
             if p.grad is not None}
    net.zero_grad(set_to_none=True)
    return loss.item(), grads

  before = _launch_counts()
  loss, grads = loss_and_grads(model)
  after = _launch_counts()
  if not all(after[name] > before[name] for name in after):
    raise AssertionError(f"The kernel path missed a kernel: {before} -> "
                         f"{after}.")
  _use_plain_path(model, True)
  try:
    loss_plain, grads_plain = loss_and_grads(model)
  finally:
    _use_plain_path(model, False)
  # The float32 reference: the same weights, the plain path, no TF32.
  model32 = griffin.Griffin(config, device="meta", dtype=torch.float32)
  model32.to_empty(device=dev)
  model32.load_state_dict(model.state_dict())
  _use_plain_path(model32, True)
  loss_f32, grads_f32 = loss_and_grads(model32)
  del model32
  if _launch_counts() != after:
    raise AssertionError("A plain path launched a kernel.")

  rel_loss = abs(loss - loss_plain) / abs(loss_plain)
  log(f"  kernel path vs plain path, {GRAD_REFERENCE_TOKENS} tokens: loss "
      f"{loss:.6f} vs {loss_plain:.6f} (rel {rel_loss:.2e}, tolerance "
      f"{MODEL_LOSS_REL_ERR}); float32 plain path {loss_f32:.6f}")
  stats = _leaf_stats(grads, grads_plain)
  stats_f32 = _leaf_stats(grads, grads_f32)
  stats_plain_f32 = _leaf_stats(grads_plain, grads_f32)
  log(f"  gradients of {len(stats)} leaves; limits per leaf, kernel vs "
      f"plain: rel_rms <= {GRAD_LEAF_REL_RMS}, cosine >= "
      f"{GRAD_LEAF_MIN_COSINE}")
  _log_leaf_stats("bf16 kernel path vs bf16 plain path", stats)
  _log_leaf_stats("bf16 kernel path vs float32 plain path", stats_f32)
  _log_leaf_stats("bf16 plain path vs float32 plain path", stats_plain_f32)
  bad = [s for s in stats
         if not (s[0] <= GRAD_LEAF_REL_RMS and s[1] >= GRAD_LEAF_MIN_COSINE)]
  if not (np.isfinite(loss) and rel_loss <= MODEL_LOSS_REL_ERR) or bad:
    raise AssertionError(f"Kernel and plain gradients disagree: {bad[:5]}.")
  median, median_plain = (x[len(x) // 2][0]
                          for x in (stats_f32, stats_plain_f32))
  log(f"  median distance to float32, kernel path / plain path "
      f"{median / median_plain:.4f} (limit {GRAD_F32_MEDIAN_RATIO})")
  if not median <= GRAD_F32_MEDIAN_RATIO * median_plain:
    raise AssertionError("The kernel path is farther from float32 than the "
                         "plain path.")


def profile_training(model, batch, dev, step_ms: float) -> None:
  """Logs kernel time by name for one more training step (after one more
  unprofiled step that allocates a fresh optimizer's state), against the
  step time measured without the profiler."""
  optimizer = trainer.make_optimizer(model, TRAIN_LEARNING_RATE)
  tokens = torch.as_tensor(batch.input_tokens, device=dev).long()
  mask = torch.as_tensor(batch.target_mask, device=dev)

  def step():
    trainer.train_step(model, optimizer, 0, tokens, mask)

  step()
  times = kernel_times(step)
  busy = sum(ms for ms, _ in times.values())
  log(f"  training step under the profiler: kernels busy {busy:.1f} ms of "
      f"{step_ms:.1f} ms a step (device idle share {1 - busy / step_ms:.3f}); "
      f"top kernels:")
  for name, (ms, count) in sorted(times.items(), key=lambda kv: -kv[1][0])[:14]:
    log(f"    {ms:9.3f} ms  x{count:5d}  {name[:90]}")
  del optimizer
  model.zero_grad(set_to_none=True)
  torch.cuda.empty_cache()


def check_mha(q, k, v) -> float:
  """Max abs error of the MHA kernel against its plain version; raises
  above the tolerance."""
  out = mha_attention.flash_mha_attention(q, k, v)
  err = max_err(out, mha_attention.mha_attention_plain(q, k, v))
  if not (torch.isfinite(out).all() and err <= MHA_MAX_ABS_ERR):
    raise AssertionError(f"mha_attention disagrees with its plain version: "
                         f"{err}")
  return err


def check_add_rmsnorm(x, residual, scale, eps=1e-6) -> float:
  """Max abs error of normed against the plain version; raises unless y is
  exact and normed within its relative tolerance."""
  y, normed = fused_epilogue.fused_add_rmsnorm(x, residual, scale, eps)
  y_ref, normed_ref = fused_epilogue.reference_add_rmsnorm(x, residual,
                                                            scale, eps)
  if not torch.equal(y, y_ref):
    raise AssertionError(f"add_rmsnorm's y differs: {max_err(y, y_ref)}")
  diff = (normed.float() - normed_ref.float()).abs()
  rel = (diff / normed_ref.float().abs().clamp_min(1e-6)).max().item()
  if not rel <= RMSNORM_NORMED_REL_ERR:
    raise AssertionError(f"add_rmsnorm's normed differs: relative {rel}")
  return diff.max().item()


def phase_mha(dev) -> dict:
  log(f"== mha_attention vs plain, bf16 (tolerance {MHA_MAX_ABS_ERR}); "
      f"library: one unmasked SDPA call on the same [b, n, t, h] tensors; "
      f"ms: device time a call with the launch queue full (CUDA events)")
  rows = []
  worst = 0.0
  for i, (b, t, n, h) in enumerate(MHA_SHAPES):
    rng = np.random.default_rng(SEED + 20 + i)
    q, k, v = (torch.tensor(rng.standard_normal((b, t, n, h),
                                                dtype=np.float32),
                            device=dev).bfloat16() for _ in range(3))
    err = check_mha(q, k, v)
    worst = max(worst, err)
    qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
    kernel = lambda: mha_attention.mha_attention_forward(q, k, v)
    library = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt)
    ms, call_ms = device_ms(kernel, 20), cuda_ms(kernel, 20)
    plain_ms = device_ms(
        lambda: mha_attention.mha_attention_plain(q, k, v), 3)
    library_ms, library_call_ms = device_ms(library, 20), cuda_ms(library, 20)
    # QK^T and PV: 2 h flops each per (query, key) pair and head; q, k, v
    # read and out written once in bf16.
    flops = 4 * b * n * t * t * h
    n_bytes = 4 * b * t * n * h * 2
    bound_ms, bound_by = bound(n_bytes, flops, BF16_TENSOR_FLOPS)
    figures = speed(ms, flops, bound_ms, library_ms)
    log(f"  [{b},{t},{n},{h}]: max_abs_err {err:.3e}  ms {ms:.4f}  plain_ms "
        f"{plain_ms:.3f}  library_ms (SDPA) {library_ms:.4f}  bound_ms "
        f"{bound_ms:.5f} ({bound_by}, {flops / 1e9:.2f} GFLOP): "
        f"{figures['tflops']:.1f} TFLOP/s, "
        f"{100 * figures['bound_share']:.1f}% of the bound, "
        f"{figures['sdpa_ratio']:.3f} x SDPA; a call with the host's launch "
        f"(CUDA events): kernel {call_ms:.4f}, SDPA {library_call_ms:.4f}")
    rows.append(dict(shape=[b, t, n, h], ms=ms, call_ms=call_ms,
                     plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=library_ms, **figures))
  # The first shape (DINOv2-L's) is the row of the kernels line.
  first = rows[0]
  return dict(name="mha_attention", route="cuda",
              source="cadence_gemma_tpu_torch/csrc/mha_attention.cu",
              replaces=MHA_REPLACES, max_abs_err=worst,
              **{key: first[key] for key in (
                  "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                  "tflops", "bound_share", "sdpa_ratio")},
              shapes=rows[1:], **resources("mha_attention", first["shape"][3]))


def phase_add_rmsnorm(dev) -> dict:
  log(f"== add_rmsnorm vs plain, bf16 (y exact, normed within "
      f"{RMSNORM_NORMED_REL_ERR} relative); library: none (no one PyTorch "
      f"call adds the residual and applies the (scale + 1) gain); ms: device "
      f"time a call with the launch queue full (CUDA events), on copies of "
      f"the inputs that exceed the L2")
  row = None
  worst = 0.0
  for i, shape in enumerate(RMSNORM_SHAPES):
    gen = torch.Generator(dev).manual_seed(SEED + 30 + i)
    x, r = (torch.randn(shape, device=dev, generator=gen).bfloat16()
            for _ in range(2))
    scale = (0.1 * torch.randn(shape[-1], device=dev,
                               generator=gen)).bfloat16()
    err = check_add_rmsnorm(x, r, scale)
    worst = max(worst, err)
    kernel = lambda: fused_epilogue.add_rmsnorm_forward(x, r, scale)
    plain = lambda: fused_epilogue.reference_add_rmsnorm(x, r, scale)
    # Byte-bound: timed on copies of x and r that exceed the L2 together.
    ms = device_ms(lambda x, r: fused_epilogue.add_rmsnorm_forward(x, r, scale),
                   48, inputs=cold_copies(x, r))
    call_ms = cuda_ms(kernel, 50)
    plain_ms, plain_call_ms = device_ms(plain, 20), cuda_ms(plain, 50)
    rows = x.numel() // shape[-1]
    # x and residual read, y and normed written (bf16), scale read; about 6
    # float32 operations an element.
    n_bytes = 4 * x.numel() * 2 + shape[-1] * 2
    bound_ms, bound_by = bound(n_bytes, 6 * x.numel(), FP32_FLOPS)
    log(f"  {list(shape)} ({rows} rows): max_abs_err {err:.3e}  ms "
        f"{ms:.4f}  plain_ms {plain_ms:.4f}  bound_ms {bound_ms:.5f} "
        f"({bound_by}, {n_bytes / 1e6:.2f} MB); a call with the host's "
        f"launch (CUDA events): kernel {call_ms:.4f}, plain "
        f"{plain_call_ms:.4f}")
    if row is None:
      row = dict(name="add_rmsnorm", route="cuda",
                 source="cadence_gemma_tpu_torch/csrc/add_rmsnorm.cu",
                 replaces=RMSNORM_REPLACES, ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
  row["max_abs_err"] = worst
  return row


def _mm_counts() -> dict[str, int]:
  return {"mha_attention": mha_attention.launches,
          "lru_scan": lru_scan.launches,
          "window_attention": wa.launches,
          "add_rmsnorm": fused_epilogue.launches}


def _use_plain_multimodal(model, encoder, plain: bool) -> None:
  """Routes the towers through the einsum (padded to 128 tokens) and the
  Griffin through the unfused epilogue, sequential scan and einsum
  attention; or back to the kernels."""
  _use_plain_path(model, plain)
  for block in model.blocks:
    block.fused_epilogue = not plain
  for tower in (encoder.dino, encoder.siglip):
    tower.use_flash_attention = False if plain else None
    for block in tower.blocks:
      block.use_flash_attention = tower.use_flash_attention


def _rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
  diff = got.float() - want.float()
  return (diff.square().mean().sqrt()
          / want.float().square().mean().sqrt()).item()


def phase_multimodal(dev, kernels: list[dict], profile: bool) -> None:
  config = common.GriffinConfig.from_preset(
      common.Preset.RECURRENT_GEMMA_2B_V1
  )
  start = time.perf_counter()
  model = griffin.Griffin(
      config, device=dev, dtype=torch.bfloat16, fused_epilogue=True,
      generator=torch.Generator(dev).manual_seed(SEED + 8),
  )
  encoder = vit.DinoSigLIPEncoder(
      device=dev, generator=torch.Generator(dev).manual_seed(SEED + 9)
  )
  torch.cuda.synchronize()
  n_vision = sum(p.numel() for p in encoder.parameters())
  log(f"== multimodal path: DINOv2-L || SigLIP-so400m (blocks 0-22 of "
      f"each, {n_vision / 1e6:.1f} M float32 parameters, bf16 compute) -> "
      f"connector -> RecurrentGemma-2B with the fused epilogue (built in "
      f"{time.perf_counter() - start:.1f} s)")
  vocab = SimpleVocab([f"w{i}" for i in range(config.vocab_size - 4)])
  rng = np.random.default_rng(SEED + 10)
  prompts = [
      " ".join(f"w{i}" for i in rng.integers(0, config.vocab_size - 4,
                                             MM_PROMPT_TOKENS - 1))
      for _ in range(2)
  ]
  pixels = torch.rand(MM_PIXELS, device=dev,
                      generator=torch.Generator(dev).manual_seed(SEED + 11))
  sampler = modal_sampler.ModalSampler(model, vocab, encoder, device=dev)
  n_blocks = len(encoder.dino.blocks) + len(encoder.siglip.blocks)
  n_recurrent = sum(
      bt is common.TemporalBlockType.RECURRENT for bt in config.block_types
  )
  size = encoder.dino_config.image_size

  # The resize on the card against the CPU's.
  resized = vit.preprocess(pixels, vit.DINO_MEAN, vit.DINO_STD, size)
  resize_err = max_err(resized.cpu(), vit.preprocess(
      pixels.cpu(), vit.DINO_MEAN, vit.DINO_STD, size))
  log(f"  resize {list(MM_PIXELS)} -> {size} on the card vs the CPU: "
      f"max_abs_err {resize_err:.3e} (tolerance {RESIZE_MAX_ABS_ERR})")
  if not resize_err <= RESIZE_MAX_ABS_ERR:
    raise AssertionError("The resize on the card disagrees with the CPU's.")

  # Events around the encode and around each model forward, with the
  # counters at the end of each.
  marks = {}
  calls = []

  def event():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e

  def encode_start(*_):
    marks["encode_start"] = event()

  def encode_end(*_):
    marks["encode_end"] = event()
    marks["encode_counts"] = _mm_counts()

  def forward_start(*_):
    calls.append([event()])

  def forward_end(*_):
    calls[-1] += [event(), _mm_counts()]

  hooks = [encoder.register_forward_pre_hook(encode_start),
           encoder.register_forward_hook(encode_end),
           model.register_forward_pre_hook(forward_start),
           model.register_forward_hook(forward_end)]
  probe = DecodeProbe(_mm_counts)
  run_kw = dict(total_generation_steps=MM_DECODE_STEPS, pixels=pixels,
                return_logits=True, end_sampling_at_eos_token=False)
  try:
    # Warm-up with the measured run's shapes (its decode graph is captured
    # here); it also keeps the inputs that this run (the same as the
    # measured one) gives each kernel's first call.
    captures = [CaptureFirstCall(mha_attention, "flash_mha_attention"),
                CaptureFirstCall(fused_epilogue, "fused_add_rmsnorm"),
                CaptureFirstCall(lru_scan, "lru_scan"),
                CaptureFirstCall(wa, "window_attention")]
    try:
      sampler(prompts, **run_kw)
    finally:
      for capture in captures:
        capture.restore()
    torch.cuda.synchronize()
    calls.clear()
    probe.reset()
    torch.cuda.reset_peak_memory_stats()
    mha_attention.launches = fused_epilogue.launches = 0
    lru_scan.launches = wa.launches = 0
    reset_scan_routes()
    start = time.perf_counter()
    out = sampler(prompts, **run_kw)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    launches = probe.run_launches(_mm_counts())
    replays, step_launches = probe.replays, probe.step_launches
    decode_ms = probe.decode_ms()
  finally:
    probe.close()
    for hook in hooks:
      hook.remove()
  check_scan_routes(lru_scan.launches)
  peak_gb = torch.cuda.max_memory_allocated() / 1e9

  log(f"  launches in the run {launches}; after the encode "
      f"{marks['encode_counts']}; after the prefill {calls[0][2]}; a "
      f"captured decode step {step_launches}, replayed {replays} times")
  want_encode = {"mha_attention": n_blocks, "lru_scan": 0,
                 "window_attention": 0, "add_rmsnorm": 0}
  want_prefill = {"mha_attention": n_blocks, "lru_scan": n_recurrent,
                  "window_attention": config.num_layers - n_recurrent,
                  "add_rmsnorm": config.num_layers}
  want_run = dict(want_prefill,
                  add_rmsnorm=config.num_layers * MM_DECODE_STEPS)
  if (len(calls) + replays != MM_DECODE_STEPS
      or marks["encode_counts"] != want_encode
      or calls[0][2] != want_prefill or launches != want_run):
    raise AssertionError(
        f"Launches: {len(calls)} forwards and {replays} replays, encode "
        f"{marks['encode_counts']} (want {want_encode}), prefill "
        f"{calls[0][2]} (want {want_prefill}), run {launches} (want "
        f"{want_run}).")
  # Each of the 31 decode forwards (replays of the captured step) launched
  # add_rmsnorm once per block, and no other kernel.
  want_step = dict.fromkeys(want_prefill, 0)
  want_step["add_rmsnorm"] = config.num_layers
  if step_launches != want_step or replays != MM_DECODE_STEPS - 1:
    raise AssertionError(f"A captured decode step launched {step_launches} "
                         f"(want {want_step}), replayed {replays} times.")
  tokens = torch.stack(out.tokens)
  logits = torch.stack(out.logits)
  if tokens.shape != (2, MM_DECODE_STEPS) or logits.shape != (
      2, MM_DECODE_STEPS, config.vocab_size):
    raise AssertionError(f"Shapes {tokens.shape}, {logits.shape}.")
  if not torch.isfinite(logits).all():
    raise AssertionError("Non-finite logits.")

  encode_ms = marks["encode_start"].elapsed_time(marks["encode_end"])
  ttft_ms = marks["encode_start"].elapsed_time(calls[0][1])
  prefill_ms = calls[0][0].elapsed_time(calls[0][1])
  spliced = MM_PROMPT_TOKENS + config.vision_tokens
  log(f"  pixels {list(MM_PIXELS)}, prompts 2 x {MM_PROMPT_TOKENS} tokens, "
      f"spliced prefill 2 x {spliced} tokens, {MM_DECODE_STEPS} greedy steps")
  log(f"  encode_ms {encode_ms:.2f}  prefill_ms (model) {prefill_ms:.2f}  "
      f"ttft_ms (pixels -> prefill logits) {ttft_ms:.2f}  decode_ms_per_step "
      f"{decode_ms:.3f}  wall {wall_s:.3f} s ({2 * MM_DECODE_STEPS / wall_s:.1f}"
      f" generated tokens/s)  peak {peak_gb:.2f} GB")
  log(f"  first tokens {tokens[:, :8].tolist()}")

  # Each kernel against its plain version on the inputs of its first call.
  checks = {"flash_mha_attention": ("mha_attention", check_mha),
            "fused_add_rmsnorm": ("add_rmsnorm", check_add_rmsnorm),
            "lru_scan": ("lru_scan", check_lru),
            "window_attention": ("window_attention",
                                 lambda *a: max(check_attention(*a)))}
  by_name = {kernel["name"]: kernel for kernel in kernels}
  for capture in captures:
    name, check = checks[capture.name]
    if capture.args is None:
      raise AssertionError(f"The multimodal path never called {name}.")
    tensors = [z for z in capture.args if isinstance(z, torch.Tensor)]
    log(f"  {name} on the path's inputs "
        f"{[(tuple(z.shape), str(z.dtype)) for z in tensors]}:")
    err = check(*capture.args, **capture.kwargs)
    log(f"  {name} max_abs_err {err:.3e}")
    by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], err)
    if name in ("mha_attention", "add_rmsnorm"):
      by_name[name]["launches"] = launches[name]
    capture.args = capture.kwargs = None

  compare_multimodal_paths(model, encoder, config, pixels, dev)
  compare_epilogue_decode(sampler, prompts, pixels)
  modal_conversation(sampler, prompts, pixels, by_name)
  if profile:
    profile_multimodal(sampler, prompts, pixels, encode_ms, ttft_ms)


def compare_multimodal_paths(model, encoder, config, pixels, dev) -> None:
  """Fused features and the spliced prefill's last logits through the
  kernels vs the plain path of the same weights."""
  ids = torch.tensor(
      [[1, *np.random.default_rng(SEED + 12).integers(
          4, config.vocab_size, MM_PROMPT_TOKENS - 1)]] * 2, device=dev)
  pos = torch.arange(MM_PROMPT_TOKENS, device=dev)[None].expand(2, -1)

  @torch.inference_mode()
  def run(plain):
    _use_plain_multimodal(model, encoder, plain)
    try:
      features = encoder(pixels).to(torch.bfloat16)
      logits, _ = model(ids, pos, image=features, return_cache=False,
                        last_logits_only=True)
    finally:
      _use_plain_multimodal(model, encoder, False)
    return features, logits

  before = _mm_counts()
  f_k, l_k = run(False)
  after = _mm_counts()
  f_p, l_p = run(True)
  if not all(after[k] > before[k] for k in before):
    raise AssertionError(f"The kernel path missed a kernel: {before} -> "
                         f"{after}.")
  if _mm_counts() != after:
    raise AssertionError("The plain path launched a kernel.")
  f_rel, l_rel = _rel_rms(f_k, f_p), _rel_rms(l_k, l_p)
  log(f"  kernel path vs plain path from pixels: features rel_rms "
      f"{f_rel:.3e} (tolerance {MM_FEATURES_REL_RMS}); last logits of the "
      f"{MM_PROMPT_TOKENS + config.vision_tokens}-token prefill rel_rms "
      f"{l_rel:.3e} (tolerance {MM_LOGITS_REL_RMS}), same argmax "
      f"{(l_k.argmax(-1) == l_p.argmax(-1)).tolist()}")
  if not (torch.isfinite(f_k).all() and torch.isfinite(l_k).all()
          and f_rel <= MM_FEATURES_REL_RMS and l_rel <= MM_LOGITS_REL_RMS):
    raise AssertionError("Kernel path and plain path disagree.")


# Turns of the fused / unfused decode comparison: each side takes positions
# whose sums and sums of squares match (0+3+5+6 = 1+2+4+7, 70 = 70), so a
# host that slows down linearly or quadratically over the run favours
# neither side.
EPILOGUE_TURNS = (True, False, False, True, False, True, True, False)


def compare_epilogue_decode(sampler, prompts, pixels) -> None:
  """Decode ms a step with the fused epilogue and with the unfused one, in
  turns from the same image features: what the kernel does to a step. A
  captured step keeps the model's code path as captured, so each side has a
  sampler (and a graph) of its own, warmed up before the turns."""
  features = sampler.encode(pixels)
  model = sampler.model
  samplers = {True: sampler,
              False: modal_sampler.ModalSampler(model, sampler.vocab,
                                                device=sampler.device)}
  per_step = {True: [], False: []}
  probe = DecodeProbe(_mm_counts)

  def run(fused):
    for block in model.blocks:
      block.fused_epilogue = fused
    samplers[fused](prompts, total_generation_steps=MM_DECODE_STEPS,
                    img_embed=features, end_sampling_at_eos_token=False)
    torch.cuda.synchronize()

  try:
    for fused in (True, False):
      run(fused)
    for fused in EPILOGUE_TURNS:
      run(fused)
      per_step[fused].append(probe.decode_ms())
  finally:
    probe.close()
    for block in model.blocks:
      block.fused_epilogue = True
  log(f"  decode ms a step (captured), in turns {EPILOGUE_TURNS}: fused "
      f"epilogue {[round(ms, 3) for ms in per_step[True]]} (median "
      f"{np.median(per_step[True]):.3f}), unfused "
      f"{[round(ms, 3) for ms in per_step[False]]} (median "
      f"{np.median(per_step[False]):.3f})")


def modal_conversation(sampler, prompts, pixels, by_name) -> None:
  """A pixel first turn with ``return_state``, then a text follow-up from
  its state: the image is encoded and prefilled once, and the follow-up's
  decode steps replay add_rmsnorm inside the captured step. Its first
  logits are held against one teacher-forced call of the whole history
  with the image."""
  model = sampler.model
  config = model.config
  n_recurrent = sum(
      bt is common.TemporalBlockType.RECURRENT for bt in config.block_types
  )
  rng = np.random.default_rng(SEED + 13)
  follow_up = [" ".join(f"w{i}" for i in rng.integers(
      0, config.vocab_size - 4, MODAL_FOLLOWUP_TOKENS)) for _ in prompts]
  kw = dict(total_generation_steps=MODAL_TURN_STEPS,
            end_sampling_at_eos_token=False)
  probe = DecodeProbe(_mm_counts)
  try:
    first = sampler(prompts, pixels=pixels, return_state=True, **kw)
    torch.cuda.synchronize()
    mha_attention.launches = fused_epilogue.launches = 0
    lru_scan.launches = wa.launches = 0
    reset_scan_routes()
    probe.reset()
    got = sampler(follow_up, prefix_state=first.state, return_logits=True,
                  **kw)
    torch.cuda.synchronize()
    launches = probe.run_launches(_mm_counts())
    replays, step_launches = probe.replays, probe.step_launches
  finally:
    probe.close()
  check_scan_routes(lru_scan.launches)
  want = {"mha_attention": 0, "lru_scan": n_recurrent, "window_attention": 0,
          "add_rmsnorm": config.num_layers * MODAL_TURN_STEPS}
  log(f"  image turn ({MODAL_TURN_STEPS} steps, return_state) then a text "
      f"follow-up of 2 x {MODAL_FOLLOWUP_TOKENS} tokens: launches {launches} "
      f"(a captured step {step_launches}, replayed {replays} times)")
  if (launches != want or replays != MODAL_TURN_STEPS - 1
      or step_launches["add_rmsnorm"] != config.num_layers):
    raise AssertionError(f"The follow-up launched {launches}, want {want}.")
  for name in ("lru_scan", "add_rmsnorm"):
    by_name[name]["launches"] += launches[name]

  # The whole history in one call: BOS + prompt, the first turn's tokens
  # and the follow-up, with the image spliced after BOS.
  ids = torch.tensor(
      [sampler.tokenize(p) + t.tolist() + sampler.vocab.EncodeAsIds(f)
       for p, t, f in zip(prompts, first.tokens, follow_up)],
      device=sampler.device)
  pos = torch.arange(ids.shape[1], device=ids.device)[None].expand(2, -1)
  with torch.inference_mode():
    whole, _ = model(ids, pos, image=sampler.encode(pixels),
                     return_cache=False, last_logits_only=True)
  rel = _rel_rms(torch.stack([l[0] for l in got.logits]), whole[:, 0])
  log(f"  follow-up vs the {ids.shape[1]}-token history and the image in "
      f"one call: first logits rel_rms {rel:.3e} (tolerance "
      f"{MM_LOGITS_REL_RMS})")
  if not rel <= MM_LOGITS_REL_RMS:
    raise AssertionError("The follow-up disagrees with its history.")


def profile_multimodal(sampler, prompts, pixels, encode_ms, ttft_ms) -> None:
  """Logs kernel time by name for the encode and for the image-conditioned
  prefill (encode included), against their times without the profiler."""
  for label, fn, wall_ms in (
      ("encode", lambda: sampler.encode(pixels), encode_ms),
      ("multimodal prefill (encode, splice, 2B prefill)",
       lambda: sampler(prompts, total_generation_steps=1, pixels=pixels),
       ttft_ms),
  ):
    times = kernel_times(fn)
    busy = sum(ms for ms, _ in times.values())
    log(f"  {label}: kernels busy {busy:.3f} ms of {wall_ms:.3f} ms (device "
        f"idle share {1 - busy / wall_ms:.3f}); top kernels:")
    for name, (ms, count) in sorted(
        times.items(), key=lambda kv: -kv[1][0])[:12]:
      log(f"    {ms:9.4f} ms  x{count:5d}  {name[:90]}")


def check_lru_a_prod(x, a, h0=None, reverse=False, return_a_prod=True,
                     backprop=False) -> float:
  """Max abs error of the scan kernel with the running product of ``a``
  against its plain loop (all four outputs); raises above the tolerance.
  Takes the wrapper's own arguments, so a captured call replays as it is."""
  del return_a_prod  # always on here
  if backprop:
    kernel, plain = lru_scan.lru_scan_backward, lru_scan.lru_scan_backward_plain
  else:
    kernel, plain = lru_scan.lru_scan_forward, lru_scan.lru_scan_plain
  (y, h), (p, p_last) = kernel(x, a, h0, reverse, return_a_prod=True)
  (y_r, h_r), (p_r, pl_r) = plain(x, a, h0, reverse, return_a_prod=True)
  err = max(max_err(y, y_r), max_err(h, h_r), max_err(p, p_r),
            max_err(p_last, pl_r))
  if not err <= LRU_A_PROD_MAX_ABS_ERR:
    raise AssertionError(f"lru_scan with a_prod disagrees with its plain "
                         f"version: {err}")
  return err


def phase_lru_a_prod(dev) -> dict:
  b, t, d = LRU_SP_SHAPE
  rng = np.random.default_rng(SEED + 40)
  x = torch.tensor(rng.standard_normal(LRU_SP_SHAPE, dtype=np.float32),
                   device=dev).bfloat16()
  a = torch.sigmoid(torch.tensor(
      rng.standard_normal(LRU_SP_SHAPE, dtype=np.float32), device=dev
  )).bfloat16()
  log(f"== lru_scan with the running product of a vs plain at [{b},{t},{d}] "
      f"bf16, the SP prefill's shard (tolerance {LRU_A_PROD_MAX_ABS_ERR} on "
      f"y, h_last, a_prod, a_prod_last)")
  worst = 0.0
  for backprop in (False, True):
    for reverse in (False, True):
      err = check_lru_a_prod(x, a, None, reverse, backprop=backprop)
      log(f"  {'backward' if backprop else 'forward'} walk, reverse={reverse}:"
          f" max_abs_err {err}")
      worst = max(worst, err)
  # Timed as the SP prefill calls it: forward, no carry. Read x and a, write
  # y and a_prod (bf16), h_last and a_prod_last (fp32); three fp32 flops a
  # step (the scan's multiply-add, the product's multiply).
  n_bytes = 4 * b * t * d * 2 + 2 * b * d * 4
  figures = time_scan(
      lambda x, a: lru_scan.lru_scan_forward(x, a, None, False, True), (x, a),
      n_bytes, 3 * b * t * d)
  plain_ms = cuda_ms(lambda: lru_scan.lru_scan_plain(x, a, None, False, True),
                     2)
  log_scan(figures, plain_ms, n_bytes)
  without = device_ms(lru_scan.lru_scan_forward, SCAN_REPS,
                      inputs=cold_copies(x, a))
  log(f"  the scan without the product on the same inputs {without:.4f} ms")
  return dict(name="lru_scan_a_prod", route="cuda",
              source="cadence_gemma_tpu_torch/csrc/lru_scan.cu",
              replaces=LRU_A_PROD_REPLACES, max_abs_err=worst,
              plain_ms=plain_ms, library_ms=None, **figures)


def _halo_case(rng, dev, shard0: bool):
  """q, [halo || local] k and v, segment_pos of one SP shard: shard 0 (a
  zero halo, row 1 left-padded by SP_PAD) or shard 1 (positions continue
  from 4096, a halo of the previous shard's keys)."""
  b, t, n, h = ATTN_SP_SHAPE
  q, k, v = (torch.tensor(rng.standard_normal(s, dtype=np.float32),
                          device=dev).bfloat16()
             for s in ((b, t, n, h), (b, ATTN_WINDOW + t, 1, h),
                       (b, ATTN_WINDOW + t, 1, h)))
  if shard0:
    k[:, :ATTN_WINDOW] = 0
    v[:, :ATTN_WINDOW] = 0
    seg = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    seg[1] = np.maximum(np.arange(t, dtype=np.int32) - SP_PAD, -1)
  else:
    seg = np.tile(np.arange(t, 2 * t, dtype=np.int32), (b, 1))
  return q, k, v, torch.tensor(seg, device=dev)


def phase_attention_kv_prefix(dev) -> dict:
  b, t, n, h = ATTN_SP_SHAPE
  rng = np.random.default_rng(SEED + 41)
  log(f"== window_attention with a {ATTN_WINDOW}-key halo (kv_prefix) vs "
      f"plain: q [{b},{t},{n},{h}], k and v [{b},{ATTN_WINDOW + t},1,{h}] "
      f"bf16, window {ATTN_WINDOW} (tolerance out {ATTN_OUT_MAX_ABS_ERR}, "
      f"lse {ATTN_LSE_MAX_ABS_ERR})")
  errs = []
  for shard0, label in ((False, f"shard 1: continuous positions from {t}"),
                        (True, f"shard 0: zero halo, row 1 left-padded by "
                               f"{SP_PAD}")):
    log(f"  {label}:")
    case = _halo_case(rng, dev, shard0)
    errs += check_attention(*case, ATTN_WINDOW, ATTN_WINDOW)
    if not shard0:
      timed = case
  figures = window_forward_figures(*timed, ATTN_WINDOW)
  log_figures(f"shard 1, the [{t}, {ATTN_WINDOW + t}] band", figures)
  return dict(name="window_attention_kv_prefix", route="cuda",
              source="cadence_gemma_tpu_torch/csrc/window_attention.cu",
              replaces=ATTN_PREFIX_REPLACES, max_abs_err=max(errs),
              **{key: figures[key] for key in (
                  "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                  "tflops", "bound_share", "sdpa_ratio")})


def _sp_counts() -> dict[str, int]:
  return {"lru_scan_a_prod": lru_scan.a_prod_launches,
          "window_attention_kv_prefix": wa.kv_prefix_launches,
          "lru_scan": lru_scan.launches,
          "window_attention": wa.launches}


def _reset_sp_counts() -> None:
  lru_scan.a_prod_launches = wa.kv_prefix_launches = 0
  lru_scan.launches = wa.launches = 0
  reset_scan_routes()


def sp_mesh_spec() -> sharding.ShardingSpec:
  """The (1, 4) data x sequence mesh: four shards on one card, or one on
  each of four."""
  count = torch.cuda.device_count()
  mesh = sharding.make_mesh(
      (1, SP_SHARDS), ("data", "sequence"),
      [f"cuda:{i % count}" for i in range(SP_SHARDS)],
  )
  return sharding.ShardingSpec(mesh=mesh, batch_axis_name="data",
                               sequence_axis_name="sequence")


def phase_sequence_parallel(dev, kernels: list[dict], profile: bool) -> None:
  config = common.GriffinConfig.from_preset(
      common.Preset.RECURRENT_GEMMA_2B_V1
  )
  spec = sp_mesh_spec()
  start = time.perf_counter()
  model = griffin.Griffin(
      config, device=dev, dtype=torch.bfloat16, scan_sharding_spec=spec,
      generator=torch.Generator(dev).manual_seed(SEED + 42),
  )
  ref_model = griffin.Griffin(
      config, device=dev, dtype=torch.bfloat16,
      generator=torch.Generator(dev).manual_seed(SEED + 42),
  )
  torch.cuda.synchronize()
  for (name, p), p_ref in zip(model.named_parameters(),
                              ref_model.parameters()):
    if not torch.equal(p, p_ref):
      raise AssertionError(f"The two models' {name} differ.")
  log(f"== sequence-parallel serving: RecurrentGemma-2B with "
      f"scan_sharding_spec on {spec.mesh}, and the same weights unsharded "
      f"(both built in {time.perf_counter() - start:.1f} s)")
  n_recurrent = sum(
      bt is common.TemporalBlockType.RECURRENT for bt in config.block_types
  )
  n_attention = config.num_layers - n_recurrent

  # Placing a shard on the operands' card makes a view, not a copy.
  probe = torch.empty(2, max(SP_PROMPT_TOKENS), config.width,
                      dtype=torch.bfloat16, device=dev)
  views = sum(z.untyped_storage().data_ptr() == probe.untyped_storage().data_ptr()
              for row in sharding.shard_activations(probe, spec) for z in row)
  log(f"  shards of a [2, {max(SP_PROMPT_TOKENS)}, {config.width}] "
      f"activation that are views of it: {views} of {SP_SHARDS}")
  if torch.cuda.device_count() == 1 and views != SP_SHARDS:
    raise AssertionError("Sharding on one card copied an activation.")
  del probe

  vocab = SimpleVocab([f"w{i}" for i in range(config.vocab_size - 4)])
  rng = np.random.default_rng(SEED + 43)
  prompts = [
      " ".join(f"w{i}" for i in rng.integers(0, config.vocab_size - 4, n - 1))
      for n in SP_PROMPT_TOKENS
  ]
  samplers = {True: sampler_lib.Sampler(model, vocab, device=dev),
              False: sampler_lib.Sampler(ref_model, vocab, device=dev)}
  calls = []  # per forward: [start event, end event, counts at its end]

  def before_forward(*_):
    calls.append([torch.cuda.Event(enable_timing=True)])
    calls[-1][0].record()

  def after_forward(*_):
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    calls[-1] += [end, _sp_counts()]

  hooks = [m.register_forward_pre_hook(before_forward) for m in
           (model, ref_model)]
  hooks += [m.register_forward_hook(after_forward) for m in
            (model, ref_model)]

  probe = DecodeProbe(_sp_counts)
  run_kw = dict(total_generation_steps=SP_DECODE_STEPS, return_logits=True,
                end_sampling_at_eos_token=False)
  try:
    # Warm-up of both with the measured runs' shapes (their decode graphs
    # are captured here); the SP one keeps the inputs of each kernel's
    # first call.
    captures = [CaptureFirstCall(lru_scan, "lru_scan_forward"),
                CaptureFirstCall(wa, "window_attention")]
    try:
      samplers[True](prompts, **run_kw)
    finally:
      for capture in captures:
        capture.restore()
    samplers[False](prompts, **run_kw)
    torch.cuda.synchronize()

    calls.clear()
    probe.reset()
    torch.cuda.reset_peak_memory_stats()
    _reset_sp_counts()
    start = time.perf_counter()
    out = samplers[True](prompts, **run_kw)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    launches = probe.run_launches(_sp_counts())
    replays, step_launches = probe.replays, probe.step_launches
    decode_ms = probe.decode_ms()
  finally:
    probe.close()
  peak_gb = torch.cuda.max_memory_allocated() / 1e9
  sp_calls = list(calls)

  want_prefill = {"lru_scan_a_prod": n_recurrent * SP_SHARDS,
                  "window_attention_kv_prefix": n_attention * SP_SHARDS,
                  "lru_scan": 0, "window_attention": 0}
  log(f"  launches in the run {launches}; after the prefill {sp_calls[0][2]}"
      f"; a captured decode step {step_launches}, replayed {replays} times")
  check_scan_routes(launches["lru_scan_a_prod"] + launches["lru_scan"])
  if (len(sp_calls) + replays != SP_DECODE_STEPS
      or replays != SP_DECODE_STEPS - 1 or sp_calls[0][2] != want_prefill
      or launches != want_prefill or any(step_launches.values())):
    raise AssertionError(
        f"Launches: {len(sp_calls)} forwards and {replays} replays, prefill "
        f"{sp_calls[0][2]}, run {launches}, a captured step "
        f"{step_launches}; want {want_prefill} in the prefill and none in "
        f"decode.")
  tokens = torch.stack(out.tokens)
  logits = torch.stack(out.logits)
  if tokens.shape != (2, SP_DECODE_STEPS) or logits.shape != (
      2, SP_DECODE_STEPS, config.vocab_size):
    raise AssertionError(f"Shapes {tokens.shape}, {logits.shape}.")
  if not torch.isfinite(logits).all():
    raise AssertionError("Non-finite logits.")
  prefill_ms = sp_calls[0][0].elapsed_time(sp_calls[0][1])
  prompt_rate = sum(SP_PROMPT_TOKENS) / prefill_ms * 1e3
  log(f"  prompts {SP_PROMPT_TOKENS} tokens (padded to "
      f"{max(SP_PROMPT_TOKENS)}, {SP_LOCAL_TOKENS} a shard), "
      f"{SP_DECODE_STEPS} greedy steps, decode captured")
  log(f"  SP prefill_ms {prefill_ms:.2f} ({prompt_rate:.0f} prompt tokens/s) "
      f" decode_ms_per_step {decode_ms:.3f}  wall {wall_s:.3f} s  peak "
      f"{peak_gb:.2f} GB (both models' weights included)")

  # Each kernel against its plain version on the inputs of its first call.
  checks = {"lru_scan_forward": ("lru_scan_a_prod", check_lru_a_prod),
            "window_attention": ("window_attention_kv_prefix",
                                 lambda *a, **k: max(check_attention(*a, **k)))}
  by_name = {kernel["name"]: kernel for kernel in kernels}
  for capture in captures:
    name, check = checks[capture.name]
    if capture.args is None:
      raise AssertionError(f"The SP prefill never called {name}.")
    tensors = [z for z in capture.args if isinstance(z, torch.Tensor)]
    log(f"  {name} on the path's inputs "
        f"{[(tuple(z.shape), str(z.dtype)) for z in tensors]} "
        f"{capture.kwargs}:")
    err = check(*capture.args, **capture.kwargs)
    log(f"  {name} max_abs_err {err:.3e}")
    by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], err)
    by_name[name]["launches"] = launches[name]
    capture.args = capture.kwargs = None

  # The same weights unsharded: the first step's logits (the prefill's last
  # position) and the generation's tokens.
  calls.clear()
  ref = samplers[False](prompts, total_generation_steps=SP_DECODE_STEPS,
                        return_logits=True, end_sampling_at_eos_token=False)
  torch.cuda.synchronize()
  ref_counts = calls[0][2]
  if ref_counts["lru_scan"] != n_recurrent or ref_counts[
      "window_attention"] != n_attention:
    raise AssertionError(f"The unsharded prefill launched {ref_counts}.")
  ref_tokens = torch.stack(ref.tokens)
  ref_logits = torch.stack(ref.logits)
  rel = _rel_rms(logits[:, 0], ref_logits[:, 0])
  agree = (tokens == ref_tokens).float().mean().item()
  first_diff = [int((row_a != row_b).nonzero()[0]) if (row_a != row_b).any()
                else None for row_a, row_b in zip(tokens, ref_tokens)]
  log(f"  SP vs unsharded, last prompt position: logits rel_rms {rel:.3e} "
      f"(tolerance {SP_LOGITS_REL_RMS}), max_abs "
      f"{max_err(logits[:, 0], ref_logits[:, 0]):.3e}, same argmax "
      f"{(logits[:, 0].argmax(-1) == ref_logits[:, 0].argmax(-1)).tolist()}")
  log(f"  token agreement of the two {SP_DECODE_STEPS}-token generations "
      f"{agree:.4f} (first difference per row {first_diff})")
  if not (torch.isfinite(ref_logits).all() and rel <= SP_LOGITS_REL_RMS):
    raise AssertionError("SP and unsharded logits disagree.")

  # SP and unsharded prefill in balanced turns.
  per_side = {True: [], False: []}
  for sp in SP_TURNS:
    calls.clear()
    samplers[sp](prompts, total_generation_steps=1)
    torch.cuda.synchronize()
    per_side[sp].append(calls[0][0].elapsed_time(calls[0][1]))
  for hook in hooks:
    hook.remove()
  log(f"  prefill ms in turns {SP_TURNS}: SP "
      f"{[round(ms, 2) for ms in per_side[True]]} (median "
      f"{np.median(per_side[True]):.2f}), unsharded "
      f"{[round(ms, 2) for ms in per_side[False]]} (median "
      f"{np.median(per_side[False]):.2f}); ratio of medians "
      f"{np.median(per_side[True]) / np.median(per_side[False]):.4f}")
  if profile:
    profile_sequence_parallel(samplers, prompts,
                              float(np.median(per_side[True])))


def profile_sequence_parallel(samplers, prompts, prefill_ms) -> None:
  """Logs kernel time by name for one SP prefill and its idle share, and the
  copies (memcpy, memset) of an SP and an unsharded prefill."""
  for sp in (True, False):
    times = kernel_times(lambda: samplers[sp](prompts,
                                              total_generation_steps=1))
    copies = {name: count for name, (_, count) in times.items()
              if "Memcpy" in name or "Memset" in name}
    if not sp:
      log(f"  unsharded prefill: memcpy/memset {copies}")
      continue
    busy = sum(ms for ms, _ in times.values())
    log(f"  SP prefill: kernels busy {busy:.3f} ms of {prefill_ms:.3f} ms "
        f"(device idle share {1 - busy / prefill_ms:.3f}); memcpy/memset "
        f"{copies}; top kernels:")
    for name, (ms, count) in sorted(times.items(),
                                    key=lambda kv: -kv[1][0])[:14]:
      log(f"    {ms:9.4f} ms  x{count:5d}  {name[:90]}")


def phase_lru_backward_a_prod(dev) -> dict:
  b, t, d = LRU_SP_TRAIN_SHAPE
  rng = np.random.default_rng(SEED + 50)
  g = torch.tensor(rng.standard_normal(LRU_SP_TRAIN_SHAPE, dtype=np.float32),
                   device=dev).bfloat16()
  a = torch.sigmoid(torch.tensor(
      rng.standard_normal(LRU_SP_TRAIN_SHAPE, dtype=np.float32), device=dev
  )).bfloat16()
  dh_last = torch.tensor(rng.standard_normal((b, d), dtype=np.float32),
                         device=dev)
  log(f"== lru_scan_backward with the running product of a vs plain at "
      f"[{b},{t},{d}] bf16, the SP training step's shard (tolerance "
      f"{LRU_A_PROD_MAX_ABS_ERR} on dx, dh0, a_prod, a_prod_last)")
  worst = 0.0
  for reverse in (False, True):
    for carry in (None, dh_last):
      err = check_lru_a_prod(g, a, carry, reverse, backprop=True)
      log(f"  reverse={reverse} dh_last={carry is not None}: max_abs_err "
          f"{err}")
      worst = max(worst, err)
  # Timed as SP training calls it: the forward scan's cotangents, no carry
  # (the loss does not reach h_last). Read g and a, write dx and a_prod
  # (bf16), dh0 and a_prod_last (fp32); three fp32 flops a step.
  n_bytes = 4 * b * t * d * 2 + 2 * b * d * 4
  figures = time_scan(
      lambda g, a: lru_scan.lru_scan_backward(g, a, None, False, True),
      (g, a), n_bytes, 3 * b * t * d)
  plain_ms = cuda_ms(lambda: lru_scan.lru_scan_backward_plain(
      g, a, None, False, True), 2)
  log_scan(figures, plain_ms, n_bytes)
  without = device_ms(lru_scan.lru_scan_backward, SCAN_REPS,
                      inputs=cold_copies(g, a))
  log(f"  the cotangent scan without the product on the same inputs "
      f"{without:.4f} ms")
  return dict(name="lru_scan_backward_a_prod", route="cuda",
              source="cadence_gemma_tpu_torch/csrc/lru_scan.cu",
              replaces=LRU_BWD_A_PROD_REPLACES, max_abs_err=worst,
              plain_ms=plain_ms, library_ms=None, **figures)


def _halo_training_case(rng, dev, shard0: bool):
  """q, [halo || local] k and v, segment_pos and an output cotangent of one
  SP training shard: shard 0 (a zero halo, positions from 0) or shard 2
  (positions from 8192, a halo of the previous shard's keys)."""
  b, t, n, h = ATTN_SP_TRAIN_SHAPE
  q, k, v, g = (torch.tensor(rng.standard_normal(s, dtype=np.float32),
                             device=dev).bfloat16()
                for s in ((b, t, n, h), (b, ATTN_WINDOW + t, 1, h),
                          (b, ATTN_WINDOW + t, 1, h), (b, t, n, h)))
  start = 0 if shard0 else 2 * t
  if shard0:
    k[:, :ATTN_WINDOW] = 0
    v[:, :ATTN_WINDOW] = 0
  seg = torch.arange(start, start + t, device=dev)[None].repeat(b, 1)
  return q, k, v, seg, g


def phase_attention_kv_prefix_backward(dev) -> list[dict]:
  b, t, n, h = ATTN_SP_TRAIN_SHAPE
  rng = np.random.default_rng(SEED + 51)
  log(f"== window_attention dq and dk/dv with a {ATTN_WINDOW}-key halo vs "
      f"plain: q [{b},{t},{n},{h}], k and v [{b},{ATTN_WINDOW + t},1,{h}] "
      f"bf16, window {ATTN_WINDOW} (tolerance {ATTN_BWD_REL_ERR} of the "
      f"largest gradient)")
  errs = {"dq": 0.0, "dkv": 0.0}
  for shard0, label in ((True, "shard 0: zero halo"),
                        (False, f"shard 2: continuous positions from "
                                f"{2 * t}")):
    log(f"  {label}:")
    q, k, v, seg, g = _halo_training_case(rng, dev, shard0)
    out, lse = wa.window_attention_forward(q, k, v, seg, ATTN_WINDOW,
                                           ATTN_WINDOW)
    args = (q, k, v, seg, lse, wa.attention_delta(out, g), g, ATTN_WINDOW,
            ATTN_WINDOW)
    errs["dq"] = max(errs["dq"], check_dq(*args))
    errs["dkv"] = max(errs["dkv"], check_dkv(*args))
    if shard0:
      dk, dv = wa.window_attention_dkv(*args)
      if dk[:, :ATTN_WINDOW].any() or dv[:, :ATTN_WINDOW].any():
        raise AssertionError("Shard 0's zero halo got a gradient.")
  log(f"  timed at shard 2 over the [{t}, {ATTN_WINDOW + t}] band:")
  return backward_rows(args, errs["dq"], errs["dkv"], suffix="_kv_prefix")


def _sp_training_counts() -> dict[str, int]:
  return {"lru_scan_a_prod": lru_scan.a_prod_launches,
          "lru_scan_backward_a_prod": lru_scan.backward_a_prod_launches,
          "window_attention_kv_prefix": wa.kv_prefix_launches,
          "window_attention_dq_kv_prefix": wa.dq_kv_prefix_launches,
          "window_attention_dkv_kv_prefix": wa.dkv_kv_prefix_launches,
          **_launch_counts()}


def _reset_sp_training_counts() -> None:
  _reset_launch_counts()
  lru_scan.a_prod_launches = lru_scan.backward_a_prod_launches = 0
  wa.kv_prefix_launches = wa.dq_kv_prefix_launches = 0
  wa.dkv_kv_prefix_launches = 0


def _use_sharding(model: griffin.Griffin, spec) -> None:
  """Puts the model's scans and attention on ``spec`` (None: unsharded),
  as ``_use_plain_path`` routes its kernels; the weights stay."""
  model.scan_sharding_spec = spec
  for block in model.blocks:
    if block.temporal_block_type is common.TemporalBlockType.RECURRENT:
      block.recurrent_block.rg_lru.scan_sharding_spec = spec
    else:
      block.attention_block.sharding_spec = spec


def sp_training_batch(vocab_size: int) -> data_lib.TrainingInput:
  """One row of random tokens after BOS: 15000 real ones, right-padded to
  16384; the loss covers the second half of the real tokens."""
  rng = np.random.default_rng(SEED + 52)
  tokens = rng.integers(4, vocab_size, (1, SP_TRAIN_TOKENS)).astype(np.int32)
  tokens[:, 0] = 1
  tokens[:, SP_TRAIN_REAL_TOKENS:] = 0
  mask = np.zeros(tokens.shape, bool)
  mask[:, SP_TRAIN_REAL_TOKENS // 2:SP_TRAIN_REAL_TOKENS] = True
  return data_lib.TrainingInput(input_tokens=tokens, target_mask=mask)


def phase_sp_training(dev, kernels: list[dict], profile: bool) -> None:
  config = common.GriffinConfig.from_preset(
      common.Preset.RECURRENT_GEMMA_2B_V1
  )
  spec = sp_mesh_spec()
  start = time.perf_counter()
  model = griffin.Griffin(
      config, device=dev, dtype=torch.bfloat16, scan_sharding_spec=spec,
      generator=torch.Generator(dev).manual_seed(SEED + 53),
  )
  torch.cuda.synchronize()
  log(f"== sequence-parallel training: RecurrentGemma-2B with "
      f"scan_sharding_spec on {spec.mesh} (built in "
      f"{time.perf_counter() - start:.1f} s); train_loop, {SP_TRAIN_STEPS} "
      f"AdamW steps at learning rate {TRAIN_LEARNING_RATE}, one row of "
      f"{SP_TRAIN_TOKENS} tokens ({SP_TRAIN_REAL_TOKENS} real, "
      f"{SP_TRAIN_LOCAL_TOKENS} a shard)")
  batch = sp_training_batch(config.vocab_size)
  n_recurrent = sum(
      bt is common.TemporalBlockType.RECURRENT for bt in config.block_types
  )
  n_attention = config.num_layers - n_recurrent

  steps = []

  def log_metrics(metrics, step):
    steps.append((step, metrics["train_loss"], time.perf_counter()))

  captures = [CaptureFirstCall(lru_scan, "lru_scan_backward"),
              CaptureFirstCall(wa, "window_attention_dq"),
              CaptureFirstCall(wa, "window_attention_dkv")]
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  _reset_sp_training_counts()
  start = time.perf_counter()
  try:
    train_loop_lib.train_loop(
        model, [batch] * SP_TRAIN_STEPS,
        train_loop_lib.TrainingConfig(learning_rate=TRAIN_LEARNING_RATE,
                                      eval_every_n=1,
                                      max_steps=SP_TRAIN_STEPS),
        log_metrics=log_metrics, device=dev,
    )
  finally:
    for capture in captures:
      capture.restore()
  torch.cuda.synchronize()
  launches = _sp_training_counts()
  peak_gb = torch.cuda.max_memory_allocated() / 1e9

  per_step = {"lru_scan_a_prod": 2 * n_recurrent * SP_SHARDS,
              "lru_scan_backward_a_prod": n_recurrent * SP_SHARDS,
              "window_attention_kv_prefix": 2 * n_attention * SP_SHARDS,
              "window_attention_dq_kv_prefix": n_attention * SP_SHARDS,
              "window_attention_dkv_kv_prefix": n_attention * SP_SHARDS,
              **{name: 0 for name in _launch_counts()}}
  want = {name: SP_TRAIN_STEPS * count for name, count in per_step.items()}
  log(f"  launches in the {SP_TRAIN_STEPS} steps {launches}")
  if launches != want:
    raise AssertionError(f"SP training launched {launches}, want {want} "
                         f"({per_step} a step).")
  check_scan_routes(sum(launches[name] for name in (
      "lru_scan", "lru_scan_backward", "lru_scan_a_prod",
      "lru_scan_backward_a_prod")))
  losses = [loss for _, loss, _ in steps]
  times = [start] + [t for _, _, t in steps]
  step_ms = [(b - a) * 1e3 for a, b in zip(times, times[1:])]
  log(f"  losses {losses}")
  if len(losses) != SP_TRAIN_STEPS or not all(np.isfinite(losses)):
    raise AssertionError(f"Non-finite or missing losses: {losses}.")
  if not losses[-1] < losses[0]:
    raise AssertionError(f"The loss did not fall: {losses}.")
  steady_ms = float(np.mean(step_ms[1:]))
  log(f"  ms per step {[round(ms, 1) for ms in step_ms]} (the first "
      f"includes warm-up); steady {steady_ms:.1f} ms "
      f"({SP_TRAIN_REAL_TOKENS / steady_ms * 1e3:.0f} real tokens/s); peak "
      f"{peak_gb:.2f} GB")

  # Each backward kernel against its plain version on the inputs the first
  # step gave it (for the scan: the first shard's cotangent walk).
  checks = {
      "lru_scan_backward": ("lru_scan_backward_a_prod",
                            lambda *a, **k: check_lru_a_prod(
                                *a, **k, backprop=True)),
      "window_attention_dq": ("window_attention_dq_kv_prefix", check_dq),
      "window_attention_dkv": ("window_attention_dkv_kv_prefix", check_dkv),
  }
  by_name = {kernel["name"]: kernel for kernel in kernels}
  for capture in captures:
    name, check = checks[capture.name]
    if capture.args is None:
      raise AssertionError(f"SP training never called {name}.")
    tensors = [z for z in capture.args if isinstance(z, torch.Tensor)]
    log(f"  {name} on the SP step's inputs "
        f"{[(tuple(z.shape), str(z.dtype)) for z in tensors]} "
        f"{[z for z in capture.args if not isinstance(z, torch.Tensor)]}:")
    err = check(*capture.args, **capture.kwargs)
    log(f"  {name} max_abs_err {err}")
    by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], err)
    by_name[name]["launches"] = launches[name]
    capture.args = capture.kwargs = None
  del captures
  compare_sp_gradients(model, batch, spec, dev)
  if profile:
    profile_training(model, batch, dev, steady_ms)
  del model
  torch.cuda.empty_cache()


def compare_sp_gradients(model, batch, spec, dev) -> None:
  """The SP gradients of one batch against the unsharded gradients of the
  same model (its spec switched off), leaf by leaf; then SP and unsharded
  training steps in balanced turns."""
  model.zero_grad(set_to_none=True)
  torch.cuda.empty_cache()
  tokens = torch.as_tensor(batch.input_tokens, device=dev).long()
  mask = torch.as_tensor(batch.target_mask, device=dev)

  def loss_and_grads():
    loss = trainer.accumulate_gradients(model, 0, tokens, mask)
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads

  _reset_sp_training_counts()
  loss_sp, grads_sp = loss_and_grads()
  sp_counts = _sp_training_counts()
  _use_sharding(model, None)
  try:
    loss_ref, grads_ref = loss_and_grads()
  finally:
    _use_sharding(model, spec)
  ref_counts = {name: count - sp_counts[name]
                for name, count in _sp_training_counts().items()}
  if ref_counts["lru_scan_backward"] == 0 or ref_counts[
      "window_attention_dq"] == 0 or ref_counts["lru_scan_a_prod"]:
    raise AssertionError(f"The unsharded step launched {ref_counts}.")
  rel_loss = abs(loss_sp - loss_ref) / abs(loss_ref)
  stats = _leaf_stats(grads_sp, grads_ref)
  log(f"  SP vs unsharded, same weights and batch: loss {loss_sp:.6f} vs "
      f"{loss_ref:.6f} (rel {rel_loss:.2e}, tolerance {MODEL_LOSS_REL_ERR}); "
      f"gradients of {len(stats)} leaves, limits per leaf rel_rms <= "
      f"{GRAD_LEAF_REL_RMS}, cosine >= {GRAD_LEAF_MIN_COSINE}")
  _log_leaf_stats("SP vs unsharded", stats)
  del grads_sp, grads_ref
  bad = [x for x in stats
         if not (x[0] <= GRAD_LEAF_REL_RMS and x[1] >= GRAD_LEAF_MIN_COSINE)]
  if not (np.isfinite(loss_sp) and rel_loss <= MODEL_LOSS_REL_ERR) or bad:
    raise AssertionError(f"SP and unsharded gradients disagree: {bad[:5]}.")

  # Whole steps (forward, backward, AdamW) in turns, from one optimizer.
  optimizer = trainer.make_optimizer(model, TRAIN_LEARNING_RATE)
  per_side = {True: [], False: []}
  for sp in (True, *SP_TRAIN_TURNS):  # the first SP step allocates state
    _use_sharding(model, spec if sp else None)
    torch.cuda.synchronize()
    start = time.perf_counter()
    trainer.train_step(model, optimizer, 0, tokens, mask).item()
    per_side[sp].append((time.perf_counter() - start) * 1e3)
  _use_sharding(model, spec)
  sp_ms, ref_ms = per_side[True][1:], per_side[False]
  log(f"  training step ms in turns {SP_TRAIN_TURNS}: SP "
      f"{[round(ms, 1) for ms in sp_ms]}, unsharded "
      f"{[round(ms, 1) for ms in ref_ms]}; ratio of means "
      f"{np.mean(sp_ms) / np.mean(ref_ms):.4f}")
  del optimizer
  model.zero_grad(set_to_none=True)
  torch.cuda.empty_cache()


def _components(*values) -> list[torch.Tensor]:
  """The real and imaginary tensors of Complex values, in order."""
  return [z for v in values for z in (v.real, v.imag)]


def _complex_operands(shape, dev, seed: int, dtype=torch.bfloat16):
  """x, a and h0 of the complex scan as Complex pairs from a seeded numpy
  generator: x and h0 normal, a a sigmoid plus 0.1i times a normal (a decay
  of modulus near the real scan's); x and a in ``dtype``, h0 float32."""
  b, t, d = shape
  rng = np.random.default_rng(seed)
  normal = lambda *s: torch.tensor(rng.standard_normal(s, dtype=np.float32),
                                   device=dev)
  x = complex_lib.Complex(normal(b, t, d), normal(b, t, d)).to(dtype)
  a = complex_lib.Complex(torch.sigmoid(normal(b, t, d)),
                          0.1 * normal(b, t, d)).to(dtype)
  return x, a, complex_lib.Complex(normal(b, d), normal(b, d))


def check_lru_complex(x, a, h0=None, reverse=False, return_a_prod=False,
                      backprop=False) -> float:
  """Max abs error of a complex scan entry point against its plain loop
  over every output component; raises above the tolerance. Takes the
  wrapper's own arguments, so a captured call replays as it is."""
  if backprop:
    kernel, plain = lru_scan.lru_scan_backward, lru_scan.lru_scan_backward_plain
  else:
    kernel, plain = lru_scan.lru_scan_forward, lru_scan.lru_scan_plain
  got = kernel(x, a, h0, reverse, return_a_prod=return_a_prod)
  want = plain(x, a, h0, reverse, return_a_prod=return_a_prod)
  if return_a_prod:
    got, want = (*got[0], *got[1]), (*want[0], *want[1])
  err = max(max_err(g, w)
            for g, w in zip(_components(*got), _components(*want)))
  if not err <= LRU_COMPLEX_MAX_ABS_ERR:
    raise AssertionError(f"The complex scan ({'backward' if backprop else 'forward'}"
                         f", a_prod={return_a_prod}) disagrees with its "
                         f"plain version: {err}")
  return err


# The complex scan's four entry points: (name, backward walk, product).
COMPLEX_ENTRIES = (("lru_scan_complex", False, False),
                   ("lru_scan_complex_backward", True, False),
                   ("lru_scan_complex_a_prod", False, True),
                   ("lru_scan_complex_backward_a_prod", True, True))


def _off_ring(z: torch.Tensor) -> torch.Tensor:
  """A copy of ``z`` whose base lies 4 bytes past a 16-byte boundary: TMA
  cannot describe it, so a complex scan over such copies takes the
  per-thread walk (with bf16 pairs, 4-byte aligned)."""
  buf = torch.empty(z.numel() * z.element_size() + 4, dtype=torch.uint8,
                    device=z.device)
  out = buf[4:].view(z.dtype).view(z.shape)
  out.copy_(z)
  return out


def complex_scan_call(kernel, a_prod: bool, reverse: bool = False):
  """The complex scan wrapper ``kernel`` as a function of its operands'
  components (x.real, x.imag, a.real, a.imag and, if given, h0's two), for
  :func:`time_scan`."""
  def call(xr, xi, ar, ai, *h):
    return kernel(complex_lib.Complex(xr, xi), complex_lib.Complex(ar, ai),
                  complex_lib.Complex(*h) if h else None, reverse, a_prod)
  return call


def complex_scan_work(shape, with_carry: bool, a_prod: bool):
  """(bytes, float32 operations) a complex scan must move and do: read x
  and a, write y (and a_prod), two components each in the input type
  (bf16 here); the carry in, h_last (and a_prod_last) out, two float32
  components each; per element and step 8 operations, 14 with the
  product."""
  b, t, d = shape
  states = 1 + with_carry + a_prod
  n_bytes = (8 if a_prod else 6) * b * t * d * 2 + 2 * states * b * d * 4
  return n_bytes, (14 if a_prod else 8) * b * t * d


def reset_complex_routes() -> None:
  lru_scan.complex_ring_launches = lru_scan.complex_thread_walk_launches = 0


def complex_routes() -> tuple[int, int]:
  return (lru_scan.complex_ring_launches,
          lru_scan.complex_thread_walk_launches)


def phase_lru_complex(dev) -> list[dict]:
  b, t, d = LRU_COMPLEX_SHAPE
  x, a, h0 = _complex_operands(LRU_COMPLEX_SHAPE, dev, SEED + 60)
  log(f"== the complex scan's four entry points vs plain at [{b},{t},{d}] "
      f"bf16 components (tolerance {LRU_COMPLEX_MAX_ABS_ERR} on every "
      f"output component)")
  entries = []
  for name, backprop, a_prod in COMPLEX_ENTRIES:
    worst = 0.0
    for reverse in (False, True):
      for carry in (None, h0):
        err = check_lru_complex(x, a, carry, reverse, a_prod, backprop)
        worst = max(worst, err)
    kernel = lru_scan.lru_scan_backward if backprop else lru_scan.lru_scan_forward
    plain = (lru_scan.lru_scan_backward_plain if backprop
             else lru_scan.lru_scan_plain)
    # Timed as the complex path calls it: the unsharded walks with a carry,
    # a shard's (with the product) without.
    carry = None if a_prod else h0
    inputs = tuple(_components(x, a, *([] if carry is None else [carry])))
    call = complex_scan_call(kernel, a_prod)
    n_bytes, flops = complex_scan_work(LRU_COMPLEX_SHAPE, carry is not None,
                                       a_prod)
    reset_complex_routes()
    figures = time_scan(call, inputs, n_bytes, flops)
    ring_routes = complex_routes()
    # The per-thread walk, the route before the ring, on copies TMA cannot
    # describe: the same bits, timed the same way.
    reset_complex_routes()
    walk = time_scan(call, inputs, n_bytes, flops, copy=_off_ring)
    walk_routes = complex_routes()
    if not (ring_routes[0] and not ring_routes[1]
            and walk_routes[1] and not walk_routes[0]):
      raise AssertionError(f"{name}: routes (ring, per-thread walk) "
                           f"{ring_routes} timing the ring, {walk_routes} "
                           f"timing the per-thread walk.")
    got = call(*(_off_ring(z) for z in inputs))
    want = plain(x, a, carry, False, return_a_prod=a_prod)
    if a_prod:
      got, want = (*got[0], *got[1]), (*want[0], *want[1])
    walk_err = max(max_err(g, w)
                   for g, w in zip(_components(*got), _components(*want)))
    if walk_err != 0.0:
      raise AssertionError(f"{name}: the per-thread walk differs from the "
                           f"plain loop by {walk_err}.")
    plain_ms = cuda_ms(lambda: plain(x, a, carry, False, a_prod), 1)
    log(f"  {name}: max_abs_err {worst} (reverse and carry both ways)")
    log_scan(figures, plain_ms, n_bytes)
    log(f"  per-thread walk (inputs off 16 B; max_abs_err {walk_err}): ms "
        f"{walk['ms']:.4f}, {walk['gbps']:.0f} GB/s, "
        f"{100 * walk['bound_share']:.1f}% of the bound, host "
        f"{walk['host_us']:.1f} us a call; the ring takes "
        f"{figures['ms'] / walk['ms']:.4f} of its time")
    entries.append(dict(name=name, route="cuda",
                        source="cadence_gemma_tpu_torch/csrc/lru_scan_complex.cu",
                        replaces=LRU_COMPLEX_REPLACES, max_abs_err=worst,
                        plain_ms=plain_ms, library_ms=None,
                        **{k: figures[k] for k in ("ms", "bound_ms",
                                                   "bound_by")}))
  # float32 components: the ring's fp32 stages and the unpaired loads.
  err = check_lru_complex(x.to(torch.float32), a.to(torch.float32), h0, True)
  log(f"  float32 components, forward, reverse, with h0: max_abs_err {err}")
  entries[0]["max_abs_err"] = max(entries[0]["max_abs_err"], err)
  return entries


def _complex_counts() -> dict[str, int]:
  return {"lru_scan_complex": lru_scan.complex_launches,
          "lru_scan_complex_backward": lru_scan.complex_backward_launches,
          "lru_scan_complex_a_prod": lru_scan.complex_a_prod_launches,
          "lru_scan_complex_backward_a_prod":
              lru_scan.complex_backward_a_prod_launches}


def _reset_complex_counts() -> None:
  lru_scan.complex_launches = lru_scan.complex_backward_launches = 0
  lru_scan.complex_a_prod_launches = 0
  lru_scan.complex_backward_a_prod_launches = 0
  reset_complex_routes()


def check_complex_routes(routes: tuple[int, int], scans: int) -> None:
  """Every complex scan launch of a run (``scans`` of them) took the TMA
  ring of ``csrc/lru_scan_complex.cu``."""
  log(f"  complex scan routes: {routes[0]} launches on the TMA ring, "
      f"{routes[1]} on the per-thread walk (want {scans}, 0)")
  if routes != (scans, 0):
    raise AssertionError(f"Complex scan routes (ring, per-thread walk) "
                         f"{routes}, want ({scans}, 0).")


def _complex_scan_and_grads(x, a, h0, gy, gh, **kwargs):
  """``ops.scan.linear_scan`` of Complex operands: (y and h_last
  components, gradients of <y, gy> + <h_last, gh> with respect to the
  components of x, a and h0), the host's ms of the forward and backward."""
  leaves = [z.clone().requires_grad_() for z in _components(x, a, h0)]
  pairs = [complex_lib.Complex(*leaves[i:i + 2]) for i in range(0, 6, 2)]
  torch.cuda.synchronize()
  start = time.perf_counter()
  y, h = scan_lib.linear_scan(*pairs, **kwargs)
  loss = sum((u.float() * g).sum() for u, g in zip(_components(y, h),
                                                   _components(gy, gh)))
  grads = torch.autograd.grad(loss, leaves)
  torch.cuda.synchronize()
  ms = (time.perf_counter() - start) * 1e3
  return [z.detach() for z in _components(y, h)], grads, ms


_COMPLEX_LEAVES = ("x.real", "x.imag", "a.real", "a.imag", "h0.real",
                   "h0.imag")


def phase_complex_path(dev, kernels: list[dict]) -> None:
  """The slice's path: ``ops.scan.linear_scan`` with Complex operands,
  forward and gradients, unsharded and over the (1, 4) mesh."""
  by_name = {kernel["name"]: kernel for kernel in kernels}
  b, t, d = LRU_COMPLEX_SHAPE
  x, a, h0 = _complex_operands(LRU_COMPLEX_SHAPE, dev, SEED + 61)
  gy, _, gh = _complex_operands(LRU_COMPLEX_SHAPE, dev, SEED + 62,
                                torch.float32)
  log(f"== the complex path: ops.scan.linear_scan of Complex [{b},{t},{d}] "
      f"bf16 operands with h0, forward and torch.autograd.grad of x, a, h0; "
      f"AUTO (the kernels) vs LINEAR_NATIVE (the plain loop through "
      f"autograd) on the same card")
  _reset_complex_counts()
  out, grads, ms = _complex_scan_and_grads(x, a, h0, gy, gh)
  launches, routes = _complex_counts(), complex_routes()
  want = {"lru_scan_complex": 1, "lru_scan_complex_backward": 1,
          "lru_scan_complex_a_prod": 0, "lru_scan_complex_backward_a_prod": 0}
  log(f"  launches {launches}; forward + backward {ms:.1f} ms")
  if launches != want:
    raise AssertionError(f"The complex path launched {launches}, want {want}.")
  check_complex_routes(routes, 2)
  for name in ("lru_scan_complex", "lru_scan_complex_backward"):
    by_name[name]["launches"] = launches[name]
  out_ref, grads_ref, ms_ref = _complex_scan_and_grads(
      x, a, h0, gy, gh, scan_type=common.ScanType.LINEAR_NATIVE)
  y_err = max(max_err(u, v) for u, v in zip(out, out_ref))
  rel = [_rel_rms(g, r) for g, r in zip(grads, grads_ref)]
  limits = [COMPLEX_PATH_DA_REL_RMS if name.startswith("a.")
            else COMPLEX_PATH_GRAD_REL_RMS for name in _COMPLEX_LEAVES]
  log(f"  LINEAR_NATIVE {ms_ref:.1f} ms; y and h_last max_abs_err {y_err} "
      f"(tolerance 0.0); gradients rel_rms "
      f"{dict(zip(_COMPLEX_LEAVES, (f'{r:.3e}' for r in rel)))} (limits: a "
      f"{COMPLEX_PATH_DA_REL_RMS}, x and h0 {COMPLEX_PATH_GRAD_REL_RMS})")
  if not (y_err == 0.0 and all(r <= lim for r, lim in zip(rel, limits))):
    raise AssertionError("The complex kernel path and the plain path differ.")
  del out, grads, out_ref, grads_ref, x, a, h0, gy, gh
  torch.cuda.empty_cache()

  spec = sp_mesh_spec()
  b, t, d = LRU_COMPLEX_SP_SHAPE
  x, a, h0 = _complex_operands(LRU_COMPLEX_SP_SHAPE, dev, SEED + 63)
  gy, _, gh = _complex_operands(LRU_COMPLEX_SP_SHAPE, dev, SEED + 64,
                                torch.float32)
  log(f"== the complex path sequence-sharded: [{b},{t},{d}] bf16 with h0 on "
      f"{spec.mesh} ({t // SP_SHARDS} steps a shard), forward and "
      f"gradients, vs the same call with no spec")
  captures = [CaptureFirstCall(lru_scan, "lru_scan_forward"),
              CaptureFirstCall(lru_scan, "lru_scan_backward")]
  _reset_complex_counts()
  try:
    out, grads, ms = _complex_scan_and_grads(x, a, h0, gy, gh,
                                             sharding_spec=spec)
  finally:
    for capture in captures:
      capture.restore()
  launches, routes = _complex_counts(), complex_routes()
  want = {"lru_scan_complex": 0, "lru_scan_complex_backward": 0,
          "lru_scan_complex_a_prod": SP_SHARDS,
          "lru_scan_complex_backward_a_prod": SP_SHARDS}
  log(f"  launches {launches}; forward + backward {ms:.1f} ms")
  if launches != want:
    raise AssertionError(f"The SP complex path launched {launches}, want "
                         f"{want}.")
  check_complex_routes(routes, 2 * SP_SHARDS)
  for name in ("lru_scan_complex_a_prod", "lru_scan_complex_backward_a_prod"):
    by_name[name]["launches"] = launches[name]
  # Each kernel with the product against its plain loop on the inputs the
  # path gave its first call (the first shard's).
  for capture, name, backprop in zip(
      captures, ("lru_scan_complex_a_prod", "lru_scan_complex_backward_a_prod"),
      (False, True)):
    err = check_lru_complex(*capture.args, **capture.kwargs,
                            backprop=backprop)
    log(f"  {name} on the path's first shard [{capture.args[0].shape}]: "
        f"max_abs_err {err}")
    by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], err)
    # The shard timed as phase 13 times batch 2: a batch-1 walk takes as
    # long, for half the bytes.
    args = inspect.signature(capture.wrapper).bind(
        *capture.args, **capture.kwargs).arguments
    operands = list(args.values())[:2]
    n_bytes, flops = complex_scan_work(operands[0].shape, False, True)
    figures = time_scan(
        complex_scan_call(capture.wrapper, True, args["reverse"]),
        tuple(_components(*operands)), n_bytes, flops)
    log(f"  {name} on the shard: ms {figures['ms']:.4f} (queue full, cold "
        f"inputs), {figures['gbps']:.0f} GB/s, "
        f"{100 * figures['bound_share']:.1f}% of its bound "
        f"{figures['bound_ms']:.4f} ms; host {figures['host_us']:.1f} us a "
        f"call")
  del captures
  out_ref, grads_ref, ms_ref = _complex_scan_and_grads(x, a, h0, gy, gh)
  y_rel = max(_rel_rms(u, v) for u, v in zip(out[:2], out_ref[:2]))
  h_rel = max(max_err(u, v) / v.abs().max().item()
              for u, v in zip(out[2:], out_ref[2:]))
  stats = [(_rel_rms(g, r), torch.nn.functional.cosine_similarity(
      g.float().flatten(), r.float().flatten(), dim=0).item())
           for g, r in zip(grads, grads_ref)]
  log(f"  unsharded {ms_ref:.1f} ms; y rel_rms {y_rel:.3e} (limit "
      f"{COMPLEX_SP_Y_REL_RMS}); h_last max err / max {h_rel:.3e} (limit "
      f"{COMPLEX_SP_H_REL_ERR}); gradients (rel_rms, cosine) "
      f"{dict(zip(_COMPLEX_LEAVES, ((f'{r:.3e}', f'{c:.6f}') for r, c in stats)))}"
      f" (limits {COMPLEX_SP_GRAD_REL_RMS}, {COMPLEX_SP_GRAD_MIN_COSINE})")
  if not (y_rel <= COMPLEX_SP_Y_REL_RMS and h_rel <= COMPLEX_SP_H_REL_ERR
          and all(r <= COMPLEX_SP_GRAD_REL_RMS
                  and c >= COMPLEX_SP_GRAD_MIN_COSINE for r, c in stats)):
    raise AssertionError("The SP complex path and the unsharded one differ.")
  del out, grads, out_ref, grads_ref
  # Both again, warm, in turns.
  turns = {True: [], False: []}
  for sharded in (True, False, False, True):
    turns[sharded].append(_complex_scan_and_grads(
        x, a, h0, gy, gh, sharding_spec=spec if sharded else None)[2])
  log(f"  forward + backward ms in turns (SP, unsharded, unsharded, SP): SP "
      f"{[round(v, 2) for v in turns[True]]}, unsharded "
      f"{[round(v, 2) for v in turns[False]]}")


def logscan_flops(st: int) -> float:
  """Variant B's float32 operations an element: three on each row r >= k
  of the log2(st) rounds (rows below k do none), two in the fix-up."""
  rounds = st.bit_length() - 1
  return 3 * (rounds - (st - 1) / st) + 2


def phase_kernel_lab(dev) -> list[dict]:
  """The lab's entry point, then every configuration of each variant
  against its plain version, and the probe."""
  b, t, d = kernel_lab.SHAPE
  log(f"== kernel lab: cadence_gemma_tpu_torch.benchmarks.kernel_lab.main() "
      f"at [{b},{t},{d}] bf16")
  kernel_lab.unrolled_launches = kernel_lab.logscan_launches = 0
  lines = {line["name"]: line for line in kernel_lab.main(dev)}
  launches = {"kernel_lab_unrolled": kernel_lab.unrolled_launches,
              "kernel_lab_logscan": kernel_lab.logscan_launches}
  log(f"  launches {launches}")
  if not all(launches.values()):
    raise AssertionError(f"The lab launched {launches}.")
  x, a, h0 = kernel_lab.make_inputs(device=dev)
  st = LAB_UNROLLED_ST
  st_b, dl = LAB_LOGSCAN_TILE
  y_seq, h_seq = kernel_lab.reference(x, a, h0)
  # Variant A at every tile length of its sweep, bit for bit.
  errs_a = {}
  for st_a in kernel_lab.UNROLLED_SWEEP:
    y, h = kernel_lab.run_unrolled(x, a, h0, st_a)
    errs_a[st_a] = max(max_err(y, y_seq), max_err(h, h_seq))
  err_a = max(errs_a.values())
  # Variant B at every tile of its sweep, bit for bit; its worst tile
  # against the sequential scan.
  errs_b, y_excess, h_seq_err = {}, -np.inf, 0.0
  for tile in kernel_lab.LOGSCAN_SWEEP:
    y, h = kernel_lab.run_logscan(x, a, h0, *tile)
    y_ref, h_ref = kernel_lab.logscan_plain(x, a, h0, *tile)
    errs_b[tile] = max(max_err(y, y_ref), max_err(h, h_ref))
    y_excess = max(y_excess, ((y.float() - y_seq.float()).abs()
                              - LAB_Y_ABS_ERR - LAB_Y_REL_ERR
                              * y_seq.float().abs()).max().item())
    h_seq_err = max(h_seq_err, max_err(h, h_seq))
  err_b = max(errs_b.values())
  log(f"  unrolled vs its plain version (the sequential scan), max_abs_err "
      f"by st: {errs_a} (tolerance 0.0); logscan vs its plain version, "
      f"max_abs_err by (st, dl): {errs_b} (tolerance 0.0); the worst tile "
      f"vs the sequential scan: y within {LAB_Y_REL_ERR} of |y| + "
      f"{LAB_Y_ABS_ERR} (excess {y_excess:.3e}), h_last {h_seq_err} "
      f"(tolerance {LAB_H_MAX_ABS_ERR})")
  if err_a != 0.0 or err_b != 0.0:
    raise AssertionError("A lab kernel disagrees with its plain version.")
  if y_excess > 0.0 or h_seq_err > LAB_H_MAX_ABS_ERR:
    raise AssertionError("The log-scan kernel strays from the sequential "
                         "scan beyond one bf16 step.")
  st256 = {tile: lines[f"logscan st={tile[0]} dl={tile[1]}"]["us"] / 1e3
           for tile in kernel_lab.LOGSCAN_SWEEP if tile[0] == 256}
  log(f"  logscan's st = 256 lines (the same kernel on the same work), ms: "
      f"{ {k: round(v, 5) for k, v in st256.items()} }, spread "
      f"{max(st256.values()) / min(st256.values()) - 1:.4f} of the fastest")
  # Each logscan call zeroes its scratch buffer (ticket and carry words)
  # on the stream before its kernel; its lines above include that.
  scratch = kernel_lab.logscan_scratch(x, st_b)
  zero_ms = kernel_lab.device_ms(
      lambda: kernel_lab.logscan_scratch(x, st_b), 20)
  log(f"  logscan's scratch zero-fill alone ({scratch.numel() * 8} bytes at "
      f"st={st_b}): ms {zero_ms:.4f}, part of each logscan call")
  # Read x and a, write y (bf16); h0 in, h_last out (float32). A does two
  # float32 operations a step.
  n_bytes = 3 * b * t * d * 2 + 2 * b * d * 4
  row1 = lines[kernel_lab.SCAN_ROW]["us"] / 1e3
  same = lines[f"unrolled st={st}"]["us"] / 1e3 / row1
  log(f"  unrolled st={st} / the library's scan: {same:.4f} (limit 1 +- "
      f"{LAB_SAME_AS_SCAN_REL})")
  if abs(same - 1.0) > LAB_SAME_AS_SCAN_REL:
    raise AssertionError(f"Variant A at st={st} takes "
                         f"{same:.4f} x the library's scan, which runs its "
                         f"code.")
  entries = []
  for name, label, flops, plain, err, replaces in (
      ("kernel_lab_unrolled", f"unrolled st={st}", 2,
       lambda: kernel_lab.reference(x, a, h0), err_a,
       LAB_UNROLLED_REPLACES),
      ("kernel_lab_logscan", f"logscan st={st_b} dl={dl}",
       logscan_flops(st_b),
       lambda: kernel_lab.logscan_plain(x, a, h0, st_b, dl), err_b,
       LAB_LOGSCAN_REPLACES)):
    ms = lines[label]["us"] / 1e3
    plain_ms = cuda_ms(plain, 1)
    bound_ms, bound_by = bound(n_bytes, flops * b * t * d, FP32_FLOPS)
    log(f"  {name} ({label}): ms {ms:.4f} (the library's scan kernel at the "
        f"same shape {row1:.4f})  plain_ms {plain_ms:.3f}  bound_ms "
        f"{bound_ms:.4f} ({bound_by}, {n_bytes / 1e6:.2f} MB): "
        f"{100 * bound_ms / ms:.1f}% of the bound")
    entries.append(dict(name=name, route="cuda",
                        source="cadence_gemma_tpu_torch/csrc/kernel_lab.cu",
                        replaces=replaces, launches=launches[name],
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
  phase_lab_probe(dev)
  return entries


def phase_lab_probe(dev) -> None:
  """Variant B, time-parallel, beside the library's sequential walk on one
  SP shard's shape: what a parallel-in-time walk could save the batch-1
  shards."""
  b, t, d = LAB_PROBE_SHAPE
  st_b, dl = LAB_PROBE_TILE
  x, a, h0 = kernel_lab.make_inputs(LAB_PROBE_SHAPE, device=dev, seed=1)
  y, h = kernel_lab.run_logscan(x, a, h0, st_b, dl)
  y_ref, h_ref = kernel_lab.logscan_plain(x, a, h0, st_b, dl)
  err = max(max_err(y, y_ref), max_err(h, h_ref))
  log(f"== lab probe at [{b},{t},{d}] bf16 (one SP shard of the 2B): logscan "
      f"st={st_b} vs its plain version max_abs_err {err} (tolerance 0.0)")
  if err != 0.0:
    raise AssertionError("The log-scan kernel disagrees with its plain "
                         "version at the probe's shape.")
  n_bytes = 3 * b * t * d * 2 + 2 * b * d * 4
  walk = time_scan(lru_scan.lru_scan_forward, (x, a, h0), n_bytes,
                   2 * b * t * d)
  tree = time_scan(lambda *xs: kernel_lab.run_logscan(*xs, st_b, dl),
                   (x, a, h0), n_bytes, logscan_flops(st_b) * b * t * d)
  for label, f in (("lru_scan_forward (the ring's batch-1 walk)", walk),
                   (f"logscan st={st_b} (time-parallel)", tree)):
    log(f"  {label}: ms {f['ms']:.4f} (cold inputs, queue full), bound_ms "
        f"{f['bound_ms']:.4f} ({f['bound_by']}): {f['gbps']:.0f} GB/s, "
        f"{100 * f['bound_share']:.1f}% of the bound; host "
        f"{f['host_us']:.1f} us a call")
  log(f"  logscan / lru_scan_forward: {tree['ms'] / walk['ms']:.4f}")


# -- phase 18: int8 serving --------------------------------------------------


def _shared(a: torch.Tensor, q: torch.Tensor) -> bool:
  """Whether the product's batches share one activation (a batch-1 ``a``,
  or batch stride 0)."""
  return q.shape[0] > 1 and (a.shape[0] == 1 or a.stride(0) == 0)


class CaptureInt8Calls:
  """Stands in for ``int8_matmul.int8_weight_matmul`` and keeps the inputs
  of its first call at each distinct shape (batches, rows, width, depth,
  shared activation): a copy of the activation (a shared one as its one
  row block; on the host with ``host``, out of a measured peak), the
  weights themselves (parameters)."""

  def __init__(self, host: bool = False):
    self.wrapper = int8_matmul.int8_weight_matmul
    self.calls = {}
    self.host = host
    int8_matmul.int8_weight_matmul = self

  def __call__(self, a, q, scale):
    shared = _shared(a, q)
    key = (*q.shape, a.shape[1], shared)
    if key not in self.calls:
      kept = (a[:1] if shared else a).detach().to(
          "cpu" if self.host else a.device, copy=True)
      self.calls[key] = (kept, q, scale)
    return self.wrapper(a, q, scale)

  def inputs(self):
    for key, (a, q, scale) in self.calls.items():
      yield key, (a.to(q.device), q, scale)

  def restore(self):
    int8_matmul.int8_weight_matmul = self.wrapper


def check_int8(a, q, scale) -> float:
  """The kernel against its plain version (JAX's expression) on the same
  inputs: within INT8_REL of the larger value plus INT8_ABS_OF_MAX of the
  largest output (see the constants). Returns the largest difference."""
  got = int8_matmul.int8_weight_matmul(a, q, scale).float()
  want = int8_matmul.int8_weight_matmul_plain(a, q, scale).float()
  diff = (got - want).abs()
  allowed = (torch.maximum(got.abs(), want.abs()) * INT8_REL
             + INT8_ABS_OF_MAX * want.abs().max())
  if not bool(torch.isfinite(got).all()) or bool((diff > allowed).any()):
    raise AssertionError(f"int8_weight_matmul disagrees with its plain "
                         f"version at {tuple(a.shape)} x {tuple(q.shape)}: "
                         f"max_abs_err {diff.max().item():.3e}.")
  return diff.max().item()


def int8_figures(a, q, scale) -> dict:
  """The kernel's device time (queue full, copies of its inputs larger than
  the L2), the plain version's, a bf16 product of the same shape on a stored
  bf16 weight (``F.linear`` / ``torch.matmul``), the dequantize + matmul
  composition, and ``torch._weight_int8pack_mm`` at decode rows where the
  card has it (a decode kernel: at prefill rows it takes ~500 x the wgmma
  kernel's time, at the logits' training rows seconds a call)."""
  _, m, k = a.shape
  batches, n = q.shape[:2]
  ms = device_ms(int8_matmul.int8_weight_matmul, INT8_REPS,
                 inputs=cold_copies(a.contiguous(), q, scale))
  plain_ms = cuda_ms(lambda: int8_matmul.int8_weight_matmul_plain(
      a, q, scale), reps=5)
  w = quantization.dequantize_tensor(q, scale, (2,), torch.bfloat16)
  bf16_ms = device_ms(
      lambda a_, w_: torch.matmul(a_, w_.transpose(1, 2)), INT8_REPS,
      inputs=cold_copies(a.contiguous(), w))
  dequant_ms = cuda_ms(lambda: torch.matmul(
      a, quantization.dequantize_tensor(q, scale, (2,)).transpose(1, 2)),
      reps=5)
  library_ms = None
  if batches == 1 and not int8_matmul.uses_wgmma(m):
    try:
      library_ms = cuda_ms(lambda: torch._weight_int8pack_mm(  # pylint: disable=protected-access
          a[0], q[0], scale[0].bfloat16()), reps=10)
    except (RuntimeError, NotImplementedError) as e:
      log(f"    torch._weight_int8pack_mm is not available here: "
          f"{str(e).splitlines()[0][:100]}")
  del w
  n_bytes = (q.numel() + 2 * batches * m * k + 4 * scale.numel()
             + 2 * batches * m * n)
  if _shared(a, q):
    n_bytes -= 2 * (batches - 1) * m * k  # one activation, read once
  bound_ms, bound_by = bound(n_bytes, 2.0 * batches * m * n * k,
                             BF16_TENSOR_FLOPS)
  return dict(ms=ms, plain_ms=plain_ms, bf16_ms=bf16_ms,
              dequant_ms=dequant_ms, library_ms=library_ms,
              bound_ms=bound_ms, bound_by=bound_by, n_bytes=n_bytes)


def int8_prefill_products(qmodel, dev) -> dict:
  """One [2560 -> 2560] projection at the text prefill's 2 x 3000 rows:
  the weight-only kernel (the wgmma forward, bound by operations here), and
  the act_quant layer's parts: ``quantize_activations``, ``torch._int_mm``
  and the whole layer, beside a bf16 product. Returns the weight-only
  kernel's figures."""
  layer = qmodel.blocks[0].recurrent_block.linear_x
  q, scale = layer.kernel_q, layer.kernel_scale
  gen = torch.Generator(dev).manual_seed(SEED + 85)
  a = torch.randn(1, INT8_PREFILL_ROWS, q.shape[1], device=dev,
                  generator=gen).bfloat16()
  f = int8_figures(a, q[None], scale[None])
  xq, _ = quantization.quantize_activations(a[0])
  m, n, k = INT8_PREFILL_ROWS, q.shape[0], q.shape[1]
  int_mm_ms = device_ms(lambda: quantization.int8_act_matmul(xq, q),
                        INT8_REPS)
  int_mm_bound, int_mm_by = bound(m * k + n * k + 4 * m * n, 2.0 * m * n * k,
                                  INT8_TENSOR_OPS)
  quantize_ms = cuda_ms(lambda: quantization.quantize_activations(a[0]))
  layer.act_quant = True
  try:
    act_layer_ms = cuda_ms(lambda: layer(a[0]))
  finally:
    layer.act_quant = False
  log(f"  a [{m}, {k}] x [{n}, {k}] (a projection at the text prefill's "
      f"rows): weight-only int8 kernel (wgmma) {f['ms']:.4f} ms (bound "
      f"{f['bound_ms']:.4f}, {f['bound_by']}: "
      f"{100 * f['bound_ms'] / f['ms']:.1f}%), plain {f['plain_ms']:.4f}, "
      f"bf16 {f['bf16_ms']:.4f}, dequant {f['dequant_ms']:.4f}; act_quant: "
      f"quantize_activations "
      f"{quantize_ms:.4f}, torch._int_mm {int_mm_ms:.4f} (bound "
      f"{int_mm_bound:.4f}, {int_mm_by}: "
      f"{100 * int_mm_bound / int_mm_ms:.1f}%), the whole layer "
      f"{act_layer_ms:.4f}")
  return f


def int8_rows(row: dict, wgmma_row: dict, m: int) -> dict:
  """The kernel row of a product of ``m`` rows: the wgmma kernel's at or
  above the crossover, the mma.sync kernel's below."""
  return wgmma_row if int8_matmul.uses_wgmma(m) else row


def _int8_counts() -> dict[str, int]:
  return {"int8_weight_matmul": int8_matmul.launches,
          "int8_weight_matmul_wgmma": int8_matmul.wgmma_launches,
          "int_mm": quantization.int_mm_calls,
          "lru_scan": lru_scan.launches,
          "window_attention": wa.launches,
          "mha_attention": mha_attention.launches}


def _reset_int8_counts() -> None:
  int8_matmul.launches = int8_matmul.wgmma_launches = 0
  quantization.int_mm_calls = 0
  lru_scan.launches = wa.launches = mha_attention.launches = 0


def _weight_only_launches(model) -> int:
  """The int8 kernel's launches in one weight-only text forward of a
  quantized model: one for each int8 layer of the blocks (``Dense``,
  ``Einsum``, ``BlockDiagonalLinear``) and one for the logits."""
  return 1 + sum(hasattr(module, "kernel_q") or hasattr(module, "w_q")
                 for module in model.blocks.modules())


class ForwardTimes:
  """CUDA events around every forward of the given modules (hooks), with
  the counters at each end."""

  def __init__(self, modules):
    self.calls = []
    self.hooks = []
    for label, module in modules.items():
      self.hooks += [
          module.register_forward_pre_hook(
              lambda *_, label=label: self.calls.append(
                  [label, self._event()])),
          module.register_forward_hook(
              lambda *_: self.calls[-1].extend(
                  [self._event(), _int8_counts()])),
      ]

  @staticmethod
  def _event():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e

  def first(self, label):
    return next(c for c in self.calls if c[0] == label)

  def close(self):
    for hook in self.hooks:
      hook.remove()


def depth_cut(model: griffin.Griffin, blocks: int) -> griffin.Griffin:
  """``model``'s first ``blocks`` blocks at its width and with its flags,
  over its own tensors (nothing is copied)."""
  config = model.config._replace(block_types=model.config.block_types[:blocks])
  cut = griffin.Griffin(config, device="meta",
                        **tensor_parallel.model_flags(model))
  names = set(cut.state_dict())
  cut.load_state_dict({n: t for n, t in model.state_dict().items()
                       if n in names}, assign=True)
  return cut


def realistic_2b(dev) -> dict:
  """Phase 18's text models, which phases 21-24 reuse: RecurrentGemma-2B in
  bf16 redrawn by ``realistic_params`` (seeds SEED and SEED + 80) and its
  weight-only int8 copy, with phase 18's vocabulary, text prompts and the
  prompts' numpy generator (``rng``, for phase 18's later draws)."""
  config = common.GriffinConfig.from_preset(
      common.Preset.RECURRENT_GEMMA_2B_V1)
  model = griffin.Griffin(config, device=dev, dtype=torch.bfloat16,
                          generator=torch.Generator(dev).manual_seed(SEED))
  state = synthetic.realistic_params(
      model, torch.Generator(dev).manual_seed(SEED + 80))
  qmodel = griffin.Griffin(config, device="meta", quantized=True)
  qmodel.to_empty(device=dev)
  qmodel.load_state_dict(quantization.quantize_params(state))
  vocab = SimpleVocab([f"w{i}" for i in range(config.vocab_size - 4)])
  rng = np.random.default_rng(SEED + 82)
  prompts = [" ".join(f"w{i}" for i in rng.integers(
      0, config.vocab_size - 4, n - 1)) for n in PROMPT_TOKENS]
  return dict(model=model, qmodel=qmodel, vocab=vocab, prompts=prompts,
              rng=rng)


def phase_int8(dev, kernels: list[dict], profile: bool) -> dict:
  """Int8 serving on the 2B and both towers: the weight-only kernel and the
  act_quant prefill against bf16 in turns. Returns phase 21's models: the
  bf16 2B, its int8 copy and the bf16 towers, with the vocabulary and the
  text prompts."""
  phase_start = time.perf_counter()
  built = realistic_2b(dev)
  model, qmodel, vocab, prompts, rng = (
      built[k] for k in ("model", "qmodel", "vocab", "prompts", "rng"))
  config = model.config
  state = model.state_dict()
  encoder = vit.DinoSigLIPEncoder(
      device=dev, generator=torch.Generator(dev).manual_seed(SEED + 81))
  qencoder = vit.DinoSigLIPEncoder(device="meta", quantized=True,
                                   act_quant=True)
  qencoder.to_empty(device=dev)
  qencoder.load_state_dict(quantization.quantize_params(
      encoder.state_dict()))
  torch.cuda.synchronize()
  bytes_ = {"bf16": quantization.quantized_bytes(state),
            "int8": quantization.quantized_bytes(qmodel.state_dict()),
            "towers f32": quantization.quantized_bytes(encoder.state_dict()),
            "towers int8": quantization.quantized_bytes(
                qencoder.state_dict())}
  log(f"== int8 serving: RecurrentGemma-2B from realistic_params (norm "
      f"scales N(0, 0.35), table + 0.3 N(0, 1)) and its quantize_params "
      f"copy; DINOv2-L || SigLIP-so400m and their int8 (act_quant) copy "
      f"(built in {time.perf_counter() - phase_start:.1f} s)")
  log(f"  weight bytes: {', '.join(f'{k} {v / 1e9:.4f} GB' for k, v in bytes_.items())}"
      f"; int8 / bf16 {bytes_['int8'] / bytes_['bf16']:.4f}")

  samplers = {
      "bf16": sampler_lib.Sampler(model, vocab, device=dev),
      "int8": sampler_lib.Sampler(qmodel, vocab, device=dev,
                                  prefill_act_quant=True),
      "int8 weight-only": sampler_lib.Sampler(qmodel, vocab, device=dev),
  }
  module_of = {"bf16": "bf16", "int8": "int8", "int8 weight-only": "int8"}
  run_kw = dict(total_generation_steps=DECODE_STEPS, return_logits=True,
                end_sampling_at_eos_token=False)

  # (a) The int8 text run: launches, and the kernel on its inputs.
  times = ForwardTimes({"bf16": model, "int8": qmodel})
  probe = DecodeProbe(_int8_counts)
  captures = CaptureInt8Calls()
  try:
    try:
      for side in samplers:  # warm-ups: capture the decode graphs
        samplers[side](prompts, **run_kw)
    finally:
      captures.restore()
    torch.cuda.synchronize()
    times.calls.clear()
    probe.reset()
    _reset_int8_counts()
    reset_scan_routes()
    out = {"int8": samplers["int8"](prompts, **run_kw)}
    torch.cuda.synchronize()
    launches = probe.run_launches(_int8_counts())
    step_launches, replays = probe.step_launches, probe.replays
    prefill_counts = times.first("int8")[3]
    check_scan_routes(lru_scan.launches)
    # (b) Text serving in turns, two runs of each; the first weight-only
    # prefill's launches.
    text = {side: [] for side in samplers}
    weight_only_counts = None
    for side in INT8_TEXT_TURNS:
      times.calls.clear()
      if side == "int8 weight-only" and weight_only_counts is None:
        _reset_int8_counts()
      out[side] = samplers[side](prompts, **run_kw)
      first = times.first(module_of[side])
      if side == "int8 weight-only" and weight_only_counts is None:
        weight_only_counts = first[3]
      text[side].append((first[1].elapsed_time(first[2]),
                         probe.decode_ms()))
  finally:
    probe.close()
    times.close()
  n_recurrent = sum(bt is common.TemporalBlockType.RECURRENT
                    for bt in config.block_types)
  per_step = _weight_only_launches(qmodel)
  # The decode step's products (2 rows) take the mma.sync kernel, the
  # prefill's gates (6000 rows) the wgmma kernel and its logits (the last
  # row of each prompt) the mma.sync kernel; the weight-only prefill sends
  # every block's product through the wgmma kernel.
  want_step = {"int8_weight_matmul": per_step, "int8_weight_matmul_wgmma": 0,
               "int_mm": 0, "lru_scan": 0, "window_attention": 0,
               "mha_attention": 0}
  want_prefill = {"int8_weight_matmul": 1,
                  "int8_weight_matmul_wgmma": 2 * n_recurrent,
                  "int_mm": per_step - 1 - 2 * n_recurrent,
                  "lru_scan": n_recurrent,
                  "window_attention": config.num_layers - n_recurrent,
                  "mha_attention": 0}
  want_weight_only = dict(want_prefill, int8_weight_matmul_wgmma=per_step - 1,
                          int_mm=0)
  log(f"  int8 run: prefill launched {prefill_counts}; a captured decode "
      f"step {step_launches}, replayed {replays} times; the run {launches}; "
      f"a weight-only prefill {weight_only_counts}")
  if (prefill_counts != want_prefill or step_launches != want_step
      or replays != DECODE_STEPS - 1
      or weight_only_counts != want_weight_only):
    raise AssertionError(f"int8 launches: prefill {prefill_counts} (want "
                         f"{want_prefill}), step {step_launches} (want "
                         f"{want_step}), {replays} replays, weight-only "
                         f"prefill {weight_only_counts} (want "
                         f"{want_weight_only}).")
  row = {"name": "int8_weight_matmul", "route": "cuda",
         "source": "cadence_gemma_tpu_torch/csrc/int8_matmul.cu",
         "replaces": INT8_REPLACES,
         "launches": launches["int8_weight_matmul"], "max_abs_err": 0.0}
  wgmma_row = {"name": "int8_weight_matmul_wgmma", "route": "cuda",
               "source": INT8_WGMMA_SOURCE, "replaces": INT8_REPLACES,
               "launches": launches["int8_weight_matmul_wgmma"],
               "max_abs_err": 0.0}
  for key, args in captures.inputs():
    err = check_int8(*args)
    target = int8_rows(row, wgmma_row, key[3])
    target["max_abs_err"] = max(target["max_abs_err"], err)
    log(f"  {target['name']} on the path's inputs a {tuple(args[0].shape)}"
        f"{' (shared)' if key[-1] else ''} x q {tuple(args[1].shape)}: "
        f"max_abs_err {err:.3e} (tolerance {INT8_REL} of the larger value "
        f"+ {INT8_ABS_OF_MAX} of the largest)")

  # (c) The kernel's time at the decode step's shapes (the step's layouts)
  # and at the prefill's block-diagonal; the JSON row is the logits product.
  log(f"  int8_weight_matmul timed (ms; device time, queue full, cold "
      f"copies; plain = its plain version; bf16 = matmul on a stored bf16 "
      f"weight; dequant = dequantize + matmul; int8pack = "
      f"torch._weight_int8pack_mm):")
  for key, args in captures.inputs():
    f = int8_figures(*args)
    log(f"    {int8_rows(row, wgmma_row, key[3])['name']} a "
        f"{tuple(args[0].shape)} x q {tuple(args[1].shape)}: ms "
        f"{f['ms']:.4f}  plain {f['plain_ms']:.4f}  bf16 {f['bf16_ms']:.4f}"
        f"  dequant {f['dequant_ms']:.4f}  int8pack "
        f"{'n/a' if f['library_ms'] is None else round(f['library_ms'], 4)}"
        f"  bound {f['bound_ms']:.4f} ({f['bound_by']}, "
        f"{f['n_bytes'] / 1e6:.1f} MB): {100 * f['bound_ms'] / f['ms']:.1f}%"
        f" of the bound")
    if key == (1, config.vocab_size, config.width, 2, False):
      row.update(ms=f["ms"], plain_ms=f["plain_ms"], bound_ms=f["bound_ms"],
                 bound_by=f["bound_by"], library_ms=f["library_ms"])
  if "ms" not in row:
    raise AssertionError("The path never ran the logits product.")
  kernels.append(row)
  f = int8_prefill_products(qmodel, dev)
  # The library figure at prefill rows is the dequantize + matmul
  # composition (torch._weight_int8pack_mm is a decode kernel: ~500 x this
  # kernel's time here); int8pack stays the decode row's.
  wgmma_row.update(ms=f["ms"], plain_ms=f["plain_ms"], bound_ms=f["bound_ms"],
                   bound_by=f["bound_by"], library_ms=f["dequant_ms"])
  kernels.append(wgmma_row)

  # (d) Greedy int8 vs bf16 on realistic weights.
  agree = synthetic.greedy_token_agreement(torch.stack(out["int8"].tokens),
                                           torch.stack(out["bf16"].tokens))
  l8 = torch.stack(out["int8"].logits)[:, 0].float()
  l16 = torch.stack(out["bf16"].logits)[:, 0].float()
  ids = torch.tensor([samplers["bf16"].tokenize(prompts[0])], device=dev)
  pos = torch.arange(ids.shape[1], device=dev)[None]
  with torch.inference_mode():
    weight_only, _ = qmodel(ids, pos, return_cache=False,
                            last_logits_only=True)
    ref, _ = model(ids, pos, return_cache=False, last_logits_only=True)
  rel = lambda a, b: ((a.float() - b.float()).abs().max()
                      / b.float().abs().max()).item()
  log(f"  first-token logits vs bf16: int8 + act_quant prefill "
      f"int8_logit_rel_err {rel(l8, l16):.5f} (max |bf16| "
      f"{l16.abs().max().item():.2f}); weight-only int8 {rel(weight_only, ref):.5f}"
      f" (prompt 0); greedy tokens over {DECODE_STEPS} steps, 2 rows: "
      f"{agree}")
  log(f"  text serving in turns {INT8_TEXT_TURNS}: prefill ms (2 x 3000 "
      f"tokens padded) bf16 {[round(p, 2) for p, _ in text['bf16']]}, int8 "
      f"with act_quant {[round(p, 2) for p, _ in text['int8']]}, "
      f"weight-only int8 "
      f"{[round(p, 2) for p, _ in text['int8 weight-only']]}; captured "
      f"decode ms a step (batch 2) bf16 "
      f"{[round(d, 3) for _, d in text['bf16']]}, int8 "
      f"{[round(d, 3) for _, d in text['int8']]}, weight-only int8 "
      f"{[round(d, 3) for _, d in text['int8 weight-only']]}")
  if profile:
    for side in samplers:
      log(f"  {side} text serving, kernel time by name:")
      profile_main_path(samplers[side], prompts,
                        float(np.median([p for p, _ in text[side]])),
                        float(np.median([d for _, d in text[side]])))

  # (e) Pixels -> first token, int8 towers with act_quant.
  mm_rng = np.random.default_rng(SEED + 83)
  mm_prompts = [" ".join(f"w{i}" for i in mm_rng.integers(
      0, config.vocab_size - 4, MM_PROMPT_TOKENS - 1)) for _ in range(2)]
  pixels = torch.rand(MM_PIXELS, device=dev,
                      generator=torch.Generator(dev).manual_seed(SEED + 84))
  modal = {"bf16": modal_sampler.ModalSampler(model, vocab, encoder,
                                              device=dev),
           "int8": modal_sampler.ModalSampler(qmodel, vocab, qencoder,
                                              device=dev,
                                              prefill_act_quant=True)}
  times = ForwardTimes({"bf16 encode": encoder, "int8 encode": qencoder,
                        "bf16": model, "int8": qmodel})
  ttft = {"bf16": [], "int8": []}
  try:
    features = {side: modal[side].encode(pixels) for side in modal}
    for side in modal:  # warm-ups
      modal[side](mm_prompts, total_generation_steps=1, pixels=pixels)
    for i, side in enumerate(INT8_TURNS):
      times.calls.clear()
      if i == 1:  # the first int8 turn's launches
        _reset_int8_counts()
      mm_out = modal[side](mm_prompts, total_generation_steps=1,
                           pixels=pixels)
      torch.cuda.synchronize()
      enc, fwd = times.first(f"{side} encode"), times.first(side)
      ttft[side].append((enc[1].elapsed_time(enc[2]),
                         enc[1].elapsed_time(fwd[2])))
      if i == 1:
        encode_counts, mm_counts = enc[3], fwd[3]
  finally:
    times.close()
  log(f"  int8 image run: the encode launched {encode_counts}; through the "
      f"prefill {mm_counts}; int8 features vs bf16 rel_rms "
      f"{_rel_rms(features['int8'], features['bf16']):.4f}; first tokens "
      f"{[int(t[0]) for t in mm_out.tokens]}")
  n_towers = len(encoder.dino.blocks) + len(encoder.siglip.blocks)
  if (encode_counts["mha_attention"] != n_towers
      or encode_counts["int_mm"] != 4 * n_towers
      or encode_counts["int8_weight_matmul"] != 0):
    raise AssertionError(f"The int8 encode launched {encode_counts}; want "
                         f"{n_towers} MHA, {4 * n_towers} int8 products.")
  log(f"  pixels {list(MM_PIXELS)} -> first token, 2 x {MM_PROMPT_TOKENS} "
      f"tokens, in turns {INT8_TURNS}: (encode ms, ttft ms) bf16 "
      f"{[(round(e, 2), round(t, 2)) for e, t in ttft['bf16']]}, int8 "
      f"{[(round(e, 2), round(t, 2)) for e, t in ttft['int8']]}")
  del modal, qencoder, features

  # (f) The eight-slot batcher's captured tick, int8 against bf16.
  steady = {}
  for side in ("bf16", "int8"):
    steady[side] = serving.ContinuousBatcher(samplers[side],
                                             num_slots=BATCH_SLOTS,
                                             max_steps_default=4096)
    for _ in range(BATCH_SLOTS):
      steady[side].add_request(" ".join(f"w{j}" for j in rng.integers(
          0, config.vocab_size - 4, 300)))
    steady[side].step(BATCH_TICK)  # admits all eight, captures the tick
  tick_ms = {"bf16": [], "int8": []}
  for side in INT8_TURNS:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    with torch.inference_mode():
      for _ in range(TICK_REPEATS):
        steady[side]._tick(BATCH_TICK)
    end.record()
    end.synchronize()
    tick_ms[side].append(start.elapsed_time(end) / TICK_REPEATS / BATCH_TICK)
  log(f"  {BATCH_SLOTS}-slot captured tick, ms a step in turns "
      f"{INT8_TURNS}: bf16 {[round(t, 3) for t in tick_ms['bf16']]}, int8 "
      f"{[round(t, 3) for t in tick_ms['int8']]}")
  if profile:
    with torch.inference_mode():
      profile_call(lambda: steady["int8"]._tick(BATCH_TICK),
                   float(np.median(tick_ms["int8"])) * BATCH_TICK,
                   f"int8 {BATCH_SLOTS}-slot tick of {BATCH_TICK} steps")
  del steady, samplers, state
  log(f"  phase 18 took {time.perf_counter() - phase_start:.1f} s")
  return dict(model=model, qmodel=qmodel, encoder=encoder, vocab=vocab,
              prompts=prompts)


class CaptureDgradCalls:
  """Stands in for ``int8_matmul.int8_weight_matmul_dgrad`` (the backward
  looks it up at each call) and keeps the inputs of its first call at each
  distinct shape: a host copy of the cotangent, the weights themselves."""

  def __init__(self):
    self.wrapper = int8_matmul.int8_weight_matmul_dgrad
    self.calls = {}
    int8_matmul.int8_weight_matmul_dgrad = self

  def __call__(self, g, q, scale, reduce_batches=False):
    key = (*q.shape, g.shape[1], reduce_batches)
    if key not in self.calls:  # kept on the host: out of the stage's peak
      self.calls[key] = (g.detach().to("cpu", copy=True), q, scale,
                         reduce_batches)
    return self.wrapper(g, q, scale, reduce_batches)

  def inputs(self):
    for key, (g, q, scale, reduce_batches) in self.calls.items():
      yield key, (g.to(q.device), q, scale, reduce_batches)

  def restore(self):
    int8_matmul.int8_weight_matmul_dgrad = self.wrapper


def check_int8_dgrad(g, q, scale, reduce_batches) -> float:
  """The input-gradient kernel against its plain version on the same
  inputs, within INT8_REL of the larger value plus INT8_ABS_OF_MAX of the
  largest. Returns the largest difference."""
  got = int8_matmul.int8_weight_matmul_dgrad(g, q, scale,
                                             reduce_batches).float()
  want = int8_matmul.int8_weight_matmul_dgrad_plain(g, q, scale,
                                                    reduce_batches).float()
  diff = (got - want).abs()
  allowed = (torch.maximum(got.abs(), want.abs()) * INT8_REL
             + INT8_ABS_OF_MAX * want.abs().max())
  if not bool(torch.isfinite(got).all()) or bool((diff > allowed).any()):
    raise AssertionError(f"int8_weight_matmul_dgrad disagrees with its plain "
                         f"version at g {tuple(g.shape)} x q "
                         f"{tuple(q.shape)}: max_abs_err "
                         f"{diff.max().item():.3e}.")
  return diff.max().item()


def int8_dgrad_figures(g, q, scale, reduce_batches) -> dict:
  """The input-gradient kernel's time (device time with the queue full on
  cold copies; CUDA events over a few calls where one call's inputs exceed
  the L2 many times over), its plain version's, the library composition
  ``matmul(dy * scale, q.to(bf16))`` (a bf16 copy of the weight written
  and read each call; for a shared activation the batches folded into the
  contraction), and the bound: each input read once, the output written
  once, or the bf16 operations."""
  batches, m, n = g.shape
  k = q.shape[2]
  fn = lambda g_, q_, s_: int8_matmul.int8_weight_matmul_dgrad(  # pylint: disable=g-long-lambda
      g_, q_, s_, reduce_batches)
  if g.numel() * 2 > 4 * L2_BYTES:
    ms = cuda_ms(lambda: fn(g, q, scale), reps=5)
  else:
    ms = device_ms(fn, INT8_DGRAD_REPS, inputs=cold_copies(g, q, scale))
  plain_ms = cuda_ms(lambda: int8_matmul.int8_weight_matmul_dgrad_plain(
      g, q, scale, reduce_batches), reps=3)
  scaled = g * scale.to(g.dtype)[..., None, :]
  if reduce_batches:
    library = lambda: torch.matmul(  # pylint: disable=g-long-lambda
        scaled.transpose(0, 1).reshape(m, batches * n),
        q.to(torch.bfloat16).reshape(batches * n, k))
  else:
    library = lambda: torch.matmul(scaled, q.to(torch.bfloat16))
  library_ms = cuda_ms(library, reps=3)
  del scaled
  out_batches = 1 if reduce_batches else batches
  n_bytes = (2 * batches * m * n + q.numel() + 4 * scale.numel()
             + 2 * out_batches * m * k)
  flops = 2.0 * batches * m * n * k
  bound_ms, bound_by = bound(n_bytes, flops, BF16_TENSOR_FLOPS)
  return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
              bound_ms=bound_ms, bound_by=bound_by, n_bytes=n_bytes,
              tflops=flops / ms / 1e9)


def _sft_counts() -> dict[str, int]:
  return {"lru_scan": lru_scan.launches,
          "lru_scan_backward": lru_scan.backward_launches,
          "window_attention": wa.launches,
          "window_attention_dq": wa.dq_launches,
          "window_attention_dkv": wa.dkv_launches,
          "mha_attention": mha_attention.launches,
          "int8_weight_matmul": int8_matmul.launches,
          "int8_weight_matmul_wgmma": int8_matmul.wgmma_launches,
          "int8_weight_matmul_dgrad_wgmma": int8_matmul.dgrad_wgmma_launches}


def _reset_sft_counts() -> None:
  lru_scan.launches = lru_scan.backward_launches = 0
  wa.launches = wa.dq_launches = wa.dkv_launches = 0
  mha_attention.launches = 0
  int8_matmul.launches = int8_matmul.wgmma_launches = 0
  int8_matmul.dgrad_wgmma_launches = 0
  reset_scan_routes()


def sft_batch(vocab_size: int) -> data_lib.TrainingInput:
  """Two rows of random text after BOS (row 1 right-padded after 1500), the
  loss over the second half of each row's real tokens, and seeded pixels in
  [0, 1]."""
  rng = np.random.default_rng(SEED + 90)
  tokens = rng.integers(4, vocab_size, (2, SFT_TEXT_TOKENS)).astype(np.int32)
  tokens[:, 0] = 1
  mask = np.zeros(tokens.shape, bool)
  for row, real in enumerate(SFT_REAL_TOKENS):
    tokens[row, real:] = 0
    mask[row, real // 2:real] = True
  pixels = rng.random(SFT_PIXELS, dtype=np.float32)
  return data_lib.TrainingInput(input_tokens=tokens, target_mask=mask,
                                pixels=pixels)


class StageClock:
  """``log_metrics`` of a training stage: each step's loss and the host
  clock after it reached the host (the loss read syncs the card)."""

  def __init__(self):
    self.steps = []
    self.start = time.perf_counter()

  def __call__(self, metrics, step):
    self.steps.append((step, metrics["train_loss"], time.perf_counter()))

  def restart(self):
    self.steps.clear()
    self.start = time.perf_counter()

  def summary(self, label: str, real_tokens: int, peak_gb: float,
              steady_steps: int | None = None) -> dict:
    """``steady_steps`` limits the steady mean to that many steps after the
    first (a later step that waited on a checkpoint's snapshot is left
    out)."""
    losses = [loss for _, loss, _ in self.steps]
    times = [self.start] + [t for _, _, t in self.steps]
    step_ms = [(b - a) * 1e3 for a, b in zip(times, times[1:])]
    steady = (float(np.mean(step_ms[1:][:steady_steps])) if len(step_ms) > 1
              else step_ms[0])
    log(f"  {label}: losses {losses}; ms per step "
        f"{[round(ms, 1) for ms in step_ms]} (the first includes warm-up); "
        f"steady {steady:.1f} ms ({real_tokens / steady * 1e3:.0f} real "
        f"tokens/s); peak {peak_gb:.2f} GB")
    if not losses or not all(np.isfinite(losses)):
      raise AssertionError(f"{label}: non-finite or missing losses {losses}.")
    return dict(losses=losses, step_ms=step_ms, steady_ms=steady,
                peak_gb=peak_gb)


def _snapshot(model, keep) -> dict[str, torch.Tensor]:
  """Host copies of the parameters ``keep`` selects (out of the peak)."""
  return {n: p.detach().to("cpu", copy=True)
          for n, p in model.named_parameters() if keep(n)}


def _unchanged(model, snapshot) -> list[str]:
  """The names of ``snapshot`` whose parameter is no longer bit for bit
  what it holds."""
  params = dict(model.named_parameters())
  return [n for n, v in snapshot.items()
          if not torch.equal(params[n].detach().cpu(), v)]


def _lora_gradients(model, tokens, mask, img, plain: bool):
  """Loss and adapter gradients of one batch; ``plain`` routes every int8
  product (forward and input gradient) through its plain version."""
  params = sft_lora.lora_parameters(model)
  model.zero_grad(set_to_none=True)
  saved = int8_matmul.int8_weight_matmul
  if plain:
    int8_matmul.int8_weight_matmul = int8_matmul.int8_weight_matmul_plain
  try:
    with trainer.trainable_only(model, params):
      loss = trainer.accumulate_gradients(model, 0, tokens, mask,
                                          img_embed=img)
  finally:
    int8_matmul.int8_weight_matmul = saved
  grads = {n: p.grad.clone() for n, p in model.named_parameters()
           if sft_lora.is_lora_path(n)}
  model.zero_grad(set_to_none=True)
  return loss.item(), grads


def phase_multimodal_sft(dev, kernels: list[dict], profile: bool,
                         ckpt_dir: str) -> dict:
  """Multimodal fine-tuning on the 2B at full width and depth: the two-stage
  recipe, LoRA on the bf16 base (saving ``step_2`` under ``ckpt_dir``,
  asynchronously, with prefetching), QLoRA on its int8 copy (the input
  gradient kernel), each stage's step time and peak memory; with
  ``profile`` the kernel time by name of one QLoRA step. Returns what
  phase 20 continues from: the towers, the batch, the LoRA run's config,
  final adapters and checkpoint clock, and the QLoRA model."""
  phase_start = time.perf_counter()
  config = common.GriffinConfig.from_preset(
      common.Preset.RECURRENT_GEMMA_2B_V1)
  model = griffin.Griffin(config, device=dev, dtype=torch.bfloat16,
                          generator=torch.Generator(dev).manual_seed(SEED + 91))
  encoder = vit.DinoSigLIPEncoder(
      device=dev, generator=torch.Generator(dev).manual_seed(SEED + 92))
  torch.cuda.synchronize()
  batch = sft_batch(config.vocab_size)
  spliced = SFT_TEXT_TOKENS + config.vision_tokens
  real_tokens = sum(SFT_REAL_TOKENS) + 2 * config.vision_tokens
  n_recurrent = sum(bt is common.TemporalBlockType.RECURRENT
                    for bt in config.block_types)
  n_attention = config.num_layers - n_recurrent
  n_towers = len(encoder.dino.blocks) + len(encoder.siglip.blocks)
  log(f"== multimodal fine-tuning: RecurrentGemma-2B (bf16, seeded) with "
      f"DINOv2-L || SigLIP-so400m (blocks 0-22, 384 px) frozen; pixels "
      f"{list(SFT_PIXELS)}, 2 x {SFT_TEXT_TOKENS} text tokens "
      f"({SFT_REAL_TOKENS} real), {spliced} spliced tokens a row; "
      f"{real_tokens} real tokens a step (text + visual); built in "
      f"{time.perf_counter() - phase_start:.1f} s")
  per_step = {"lru_scan": 2 * n_recurrent, "lru_scan_backward": n_recurrent,
              "window_attention": 2 * n_attention,
              "window_attention_dq": n_attention,
              "window_attention_dkv": n_attention,
              "mha_attention": n_towers}
  stats = {}

  # (a) two_stage_sft: the connector alone, then everything. The data
  # factory's second call comes between the stages: it reads and checks
  # stage 1, then sets the counts to 0 for stage 2.
  clock = StageClock()
  connector = lambda n: n.startswith("vl_connector.")  # pylint: disable=g-long-lambda
  frozen = _snapshot(model, lambda n: not connector(n))
  connector_before = _snapshot(model, connector)
  embedding_before = model.embedder.input_embedding.detach().to(
      "cpu", copy=True)
  stage_counts = {}
  factory_calls = 0

  def factory():
    nonlocal factory_calls
    factory_calls += 1
    if factory_calls == 2:
      torch.cuda.synchronize()
      stage_counts["frozen"] = _sft_counts()
      check_scan_routes(lru_scan.ring_launches
                        + lru_scan.thread_walk_launches)
      stats["frozen"] = clock.summary(
          f"stage 1 (frozen LM, connector trains), {SFT_FROZEN_STEPS} steps",
          real_tokens, torch.cuda.max_memory_allocated() / 1e9)
      moved = _unchanged(model, frozen)
      if moved:
        raise AssertionError(f"Stage 1 moved frozen weights: {moved[:5]}.")
      if not set(_unchanged(model, connector_before)) == set(
          connector_before):
        raise AssertionError("Stage 1 left part of the connector in place.")
      log(f"  stage 1 left all {len(frozen)} non-connector parameters bit "
          f"for bit and moved all {len(connector_before)} of the "
          f"connector's")
      frozen.clear()
      torch.cuda.reset_peak_memory_stats()
      _reset_sft_counts()
      clock.restart()
    return [batch] * 4

  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  _reset_sft_counts()
  clock.restart()
  train_loop_lib.two_stage_sft(
      model, factory,
      train_loop_lib.TrainingConfig(learning_rate=SFT_LEARNING_RATE,
                                    eval_every_n=1,
                                    max_steps=SFT_FROZEN_STEPS),
      train_loop_lib.TrainingConfig(learning_rate=SFT_LEARNING_RATE,
                                    eval_every_n=1, max_steps=SFT_FULL_STEPS),
      encode_image=encoder, log_metrics=clock, device=dev)
  torch.cuda.synchronize()
  stats["full"] = clock.summary(
      f"stage 2 (full fine-tune), {SFT_FULL_STEPS} steps", real_tokens,
      torch.cuda.max_memory_allocated() / 1e9)
  stage_counts["full"] = _sft_counts()
  del frozen, connector_before
  for stage, steps in (("frozen", SFT_FROZEN_STEPS),
                       ("full", SFT_FULL_STEPS)):
    want = {name: steps * count for name, count in per_step.items()}
    want.update(int8_weight_matmul=0, int8_weight_matmul_wgmma=0,
                int8_weight_matmul_dgrad_wgmma=0)
    log(f"  {stage} stage launches {stage_counts[stage]}")
    if stage_counts[stage] != want:
      raise AssertionError(f"The {stage} stage launched "
                           f"{stage_counts[stage]}, want {want}.")
  check_scan_routes(lru_scan.ring_launches + lru_scan.thread_walk_launches)
  if torch.equal(model.embedder.input_embedding.detach().cpu(),
                 embedding_before):
    raise AssertionError("Stage 2 left the embedder in place.")
  del embedding_before

  # (b) LoRA on the bf16 base: the two-stage model's weights, fresh rank-8
  # adapters, train_loop(lora=True).
  lmodel = griffin.Griffin(config, device="meta", dtype=torch.bfloat16,
                           lora_rank=SFT_LORA_RANK)
  lmodel.to_empty(device=dev)
  adapters = sft_lora.init_adapters(
      lmodel, torch.Generator(dev).manual_seed(SEED + 93))
  lmodel.load_state_dict(sft_lora.merge_params(model.state_dict(), adapters))
  del model, adapters
  n_adapter = sum(p.numel() for p in sft_lora.lora_parameters(lmodel))
  base_before = _snapshot(lmodel, lambda n: not sft_lora.is_lora_path(n))
  b_before = _snapshot(lmodel, lambda n: n.endswith("lora_b"))
  lora_cfg = train_loop_lib.TrainingConfig(
      learning_rate=SFT_LEARNING_RATE, eval_every_n=1,
      max_steps=SFT_LORA_STEPS, lora=True)
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  _reset_sft_counts()
  clock = StageClock()
  # Phase 20 resumes from this run's step_2, saved on the saver's thread.
  ckpt_clock = CheckpointClock()
  log(f"  the LoRA run saves step_2 under {ckpt_dir} asynchronously, "
      f"prefetching 2 batches; {shutil.disk_usage(ckpt_dir).free / 1e9:.1f} "
      f"GB free there")
  try:
    train_loop_lib.train_loop(
        lmodel, [batch] * SFT_LORA_STEPS,
        dataclasses.replace(lora_cfg, checkpoint_dir=ckpt_dir,
                            checkpoint_every_n=2, async_checkpoints=True,
                            prefetch_batches=2),
        encode_image=encoder, log_metrics=clock, device=dev)
  finally:
    ckpt_clock.restore()
  torch.cuda.synchronize()
  stats["lora"] = clock.summary(
      f"LoRA rank {SFT_LORA_RANK} on the bf16 base ({n_adapter / 1e6:.2f} M "
      f"adapter parameters), {SFT_LORA_STEPS} steps (steady: step 2; step 3 "
      f"follows step 2's asynchronous save)", real_tokens,
      torch.cuda.max_memory_allocated() / 1e9, steady_steps=1)
  step_ms = stats["lora"]["step_ms"]
  log(f"  step 3 took {step_ms[2] - step_ms[1]:+.1f} ms against step 2: the "
      f"asynchronous save's cost to the run")
  ckpt_clock.report()
  log(f"  LoRA launches {_sft_counts()}")
  if _unchanged(lmodel, base_before):
    raise AssertionError("LoRA moved base weights.")
  if not any(n for n in _unchanged(lmodel, b_before)):
    raise AssertionError("LoRA left every lora_b at zero.")
  log(f"  LoRA left all {len(base_before)} base parameters bit for bit; "
      f"{len(_unchanged(lmodel, b_before))} of {len(b_before)} lora_b moved")
  del base_before, b_before

  # The merged model against the LoRA model: prefill logits of the batch.
  tokens = torch.as_tensor(batch.input_tokens, device=dev).long()
  positions = trainer.get_positions(tokens, 0)
  with torch.no_grad():
    img = encoder(torch.as_tensor(batch.pixels, device=dev))
  # The base without its adapters sets the scale: a merge that dropped
  # them would be as far from the LoRA model as the base is.
  merged = griffin.Griffin(config, device="meta", dtype=torch.bfloat16)
  merged.to_empty(device=dev)
  merged.load_state_dict(sft_lora.split_lora(lmodel.state_dict())[1])
  logits_of = lambda m: m(tokens, positions, image=img, return_cache=False,  # pylint: disable=g-long-lambda
                          last_logits_only=True)[0]
  with torch.inference_mode():
    want = logits_of(lmodel)
    base_rel = _rel_rms(logits_of(merged), want)
    merged.load_state_dict(sft_lora.merge_lora(lmodel.state_dict()))
    got = logits_of(merged)
  merge_rel = _rel_rms(got, want)
  log(f"  merge_lora: the merged bf16 model's last prefill logits vs the "
      f"LoRA model's rel_rms {merge_rel:.3e} (tolerance {SFT_MERGE_REL_RMS} "
      f"and {SFT_MERGE_OF_BASE} of the base's); the base without adapters "
      f"{base_rel:.3e}; same argmax "
      f"{(got.argmax(-1) == want.argmax(-1)).tolist()}")
  if not (torch.isfinite(got).all() and merge_rel <= SFT_MERGE_REL_RMS
          and merge_rel <= SFT_MERGE_OF_BASE * base_rel):
    raise AssertionError("The merged model disagrees with the LoRA model.")
  del merged, got, want

  # (c) QLoRA: quantize_params of the base, fresh bf16 adapters.
  final_adapters = {n: v.clone() for n, v in
                    sft_lora.split_lora(lmodel.state_dict())[0].items()}
  base_state = sft_lora.split_lora(lmodel.state_dict())[1]
  qmodel = griffin.Griffin(config, device="meta", quantized=True,
                           lora_rank=SFT_LORA_RANK)
  qmodel.to_empty(device=dev)
  qstate = quantization.quantize_params(base_state)
  del lmodel, base_state
  adapters = sft_lora.init_adapters(
      qmodel, torch.Generator(dev).manual_seed(SEED + 94))
  qmodel.load_state_dict(sft_lora.merge_params(qstate, adapters))
  del qstate, adapters
  base_before = _snapshot(qmodel, lambda n: not sft_lora.is_lora_path(n))
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  _reset_sft_counts()
  clock = StageClock()
  forward_capture = CaptureInt8Calls(host=True)
  capture = CaptureDgradCalls()
  try:
    train_loop_lib.train_loop(qmodel, [batch] * SFT_LORA_STEPS, lora_cfg,
                              encode_image=encoder, log_metrics=clock,
                              device=dev)
  finally:
    capture.restore()
    forward_capture.restore()
  torch.cuda.synchronize()
  stats["qlora"] = clock.summary(
      f"QLoRA rank {SFT_LORA_RANK} on the int8 base, {SFT_LORA_STEPS} "
      f"steps", real_tokens, torch.cuda.max_memory_allocated() / 1e9)
  qlora_counts = _sft_counts()
  int8_layers = _weight_only_launches(qmodel) - 1
  log(f"  QLoRA launches {qlora_counts}; {int8_layers} int8 layers in the "
      f"blocks and the logits")
  # The int8 products run forward twice a step (remat; the logits' under
  # the loss chunks' checkpoints), and their input gradient wherever the
  # activation requires one: everywhere after the splice (the connector's
  # adapters reach every position through attention and the scan), not in
  # the connector's up-projection, whose input is the towers' features.
  # Every forward has thousands of rows: the wgmma kernel takes them all.
  if (qlora_counts["int8_weight_matmul_dgrad_wgmma"] == 0
      or qlora_counts["int8_weight_matmul_wgmma"] == 0
      or qlora_counts["int8_weight_matmul"]
      or any(qlora_counts[k] != SFT_LORA_STEPS * v
             for k, v in per_step.items())):
    raise AssertionError(f"QLoRA launched {qlora_counts}; want the int8 "
                         f"wgmma kernels > 0, the mma.sync one 0 and "
                         f"{per_step} a step.")
  log(f"  QLoRA int8 launches a step by route: forward wgmma "
      f"{qlora_counts['int8_weight_matmul_wgmma'] / SFT_LORA_STEPS:g}, "
      f"mma.sync {qlora_counts['int8_weight_matmul'] / SFT_LORA_STEPS:g}; "
      f"input gradient (wgmma) "
      f"{qlora_counts['int8_weight_matmul_dgrad_wgmma'] / SFT_LORA_STEPS:g}")
  if _unchanged(qmodel, base_before):
    raise AssertionError("QLoRA moved base weights.")
  del base_before

  # The forward kernel on the inputs the step passed it (phase 18 checked
  # it at the serving shapes; its row takes the larger error and adds the
  # step's launches), timed at the step's largest shapes.
  int8_row = next(r for r in kernels
                  if r["name"] == "int8_weight_matmul_wgmma")
  int8_row["launches"] += qlora_counts["int8_weight_matmul_wgmma"]
  for key, args in forward_capture.inputs():
    err = check_int8(*args)
    int8_row["max_abs_err"] = max(int8_row["max_abs_err"], err)
    log(f"  int8_weight_matmul_wgmma on the QLoRA step's inputs a "
        f"{tuple(args[0].shape)}{' (shared)' if key[-1] else ''} x q "
        f"{tuple(args[1].shape)}: max_abs_err {err:.3e} (tolerance "
        f"{INT8_REL} of the larger value + {INT8_ABS_OF_MAX} of the largest)")
  log("  int8_weight_matmul_wgmma timed at the QLoRA step's shapes (ms; "
      "plain = its plain version, the library composition matmul(a, "
      "q.to(bf16)) * scale; dequant = dequantize + matmul; bf16 = matmul on "
      "a stored bf16 weight):")
  for key, args in forward_capture.inputs():
    if not (key[:3] in ((1, config.vocab_size, config.width),
                        (1, config.width, config.width)) or key[-1]):
      continue
    f = int8_figures(*args)
    log(f"    a {tuple(args[0].shape)}{' (shared)' if key[-1] else ''} x q "
        f"{tuple(args[1].shape)}: ms {f['ms']:.4f} "
        f"({2e-9 * args[1].numel() * key[3] / f['ms']:.1f} TFLOP/s)  plain "
        f"{f['plain_ms']:.4f}  dequant {f['dequant_ms']:.4f}  bf16 "
        f"{f['bf16_ms']:.4f}  bound "
        f"{f['bound_ms']:.4f} ({f['bound_by']}): "
        f"{100 * f['bound_ms'] / f['ms']:.1f}% of the bound")
  forward_capture.calls.clear()

  # The input-gradient kernel on the inputs the step passed it.
  row = {"name": "int8_weight_matmul_dgrad_wgmma", "route": "cuda",
         "source": INT8_WGMMA_SOURCE, "replaces": INT8_DGRAD_REPLACES,
         "launches": qlora_counts["int8_weight_matmul_dgrad_wgmma"],
         "max_abs_err": 0.0}
  logits_key = (1, config.vocab_size, config.width)
  dense_key = (1, config.width, config.width)
  for key, args in capture.inputs():
    err = check_int8_dgrad(*args)
    row["max_abs_err"] = max(row["max_abs_err"], err)
    log(f"  int8_weight_matmul_dgrad on the step's inputs g "
        f"{tuple(args[0].shape)} x q {tuple(args[1].shape)}"
        f"{' (summed over the batches)' if args[3] else ''}: max_abs_err "
        f"{err:.3e} (tolerance {INT8_REL} of the larger value + "
        f"{INT8_ABS_OF_MAX} of the largest)")
  if not any(k[:3] == logits_key for k in capture.calls) or not any(
      k[4] for k in capture.calls):
    raise AssertionError(f"The QLoRA step never passed the logits' or an "
                         f"Einsum's gradient: {list(capture.calls)}.")
  log("  int8_weight_matmul_dgrad_wgmma timed (ms; plain = its plain "
      "version; library = matmul(dy * scale, q.to(bf16)), a bf16 weight copy "
      "each call):")
  for key, args in capture.inputs():
    if not (key[:3] in (logits_key, dense_key) or key[4]):
      continue
    f = int8_dgrad_figures(*args)
    log(f"    g {tuple(args[0].shape)} x q {tuple(args[1].shape)}: ms "
        f"{f['ms']:.4f} ({f['tflops']:.1f} TFLOP/s)  plain "
        f"{f['plain_ms']:.4f}  library {f['library_ms']:.4f}  bound "
        f"{f['bound_ms']:.4f} ({f['bound_by']}, {f['n_bytes'] / 1e6:.1f} MB)"
        f": {100 * f['bound_ms'] / f['ms']:.1f}% of the bound")
    if key[:3] == logits_key and "ms" not in row:
      row.update(ms=f["ms"], plain_ms=f["plain_ms"], bound_ms=f["bound_ms"],
                 bound_by=f["bound_by"], library_ms=f["library_ms"])
  capture.calls.clear()
  kernels.append(row)

  # The adapters' gradients, kernel path against plain path.
  mask = torch.as_tensor(batch.target_mask, device=dev)
  torch.cuda.empty_cache()
  _reset_sft_counts()
  loss_k, grads_k = _lora_gradients(qmodel, tokens, mask, img, plain=False)
  if _sft_counts()["int8_weight_matmul_dgrad_wgmma"] == 0:
    raise AssertionError("The kernel path launched no input gradient.")
  _reset_sft_counts()
  loss_p, grads_p = _lora_gradients(qmodel, tokens, mask, img, plain=True)
  plain_counts = _sft_counts()
  if any(plain_counts[k] for k in (
      "int8_weight_matmul", "int8_weight_matmul_wgmma",
      "int8_weight_matmul_dgrad_wgmma")):
    raise AssertionError("The plain path launched an int8 kernel.")
  rel_loss = abs(loss_k - loss_p) / abs(loss_p)
  leaf_stats = _leaf_stats(grads_k, grads_p)
  log(f"  QLoRA kernel path vs plain path (every int8 product plain): loss "
      f"{loss_k:.6f} vs {loss_p:.6f} (rel {rel_loss:.2e}, tolerance "
      f"{MODEL_LOSS_REL_ERR}); {len(leaf_stats)} adapter leaves, limits "
      f"rel_rms <= {GRAD_LEAF_REL_RMS}, cosine >= {GRAD_LEAF_MIN_COSINE}")
  _log_leaf_stats("adapters' gradients, kernel vs plain", leaf_stats)
  bad = [x for x in leaf_stats
         if not (x[0] <= GRAD_LEAF_REL_RMS and x[1] >= GRAD_LEAF_MIN_COSINE)]
  if not (np.isfinite(loss_k) and rel_loss <= MODEL_LOSS_REL_ERR) or bad:
    raise AssertionError(f"QLoRA gradients disagree: {bad[:5]}.")
  del grads_k, grads_p

  if profile:
    optimizer = sft_lora.make_optimizer(sft_lora.lora_parameters(qmodel),
                                        SFT_LEARNING_RATE)
    step = lambda: sft_lora.lora_train_step(qmodel, optimizer, 0, tokens,  # pylint: disable=g-long-lambda
                                            mask, img)
    step()
    times = kernel_times(step)
    busy = sum(ms for ms, _ in times.values())
    top = sorted(times.items(), key=lambda kv: -kv[1][0])[:10]
    log(f"  one QLoRA step, kernel time by name: busy {busy:.1f} ms of "
        f"{stats['qlora']['steady_ms']:.1f} (idle share "
        f"{1 - busy / stats['qlora']['steady_ms']:.3f}), "
        f"{sum(n for _, n in times.values())} kernels; top: " +
        "; ".join(f"{name[:60]} {ms:.1f} ms x{n}" for name, (ms, n) in top))
    del optimizer, step

  # The QLoRA model serves: captured and eager greedy decode agree.
  vocab = SimpleVocab([f"w{i}" for i in range(config.vocab_size - 4)])
  rng = np.random.default_rng(SEED + 95)
  prompts = [" ".join(f"w{i}" for i in rng.integers(
      0, config.vocab_size - 4, SFT_PROMPT_TOKENS - 1)) for _ in range(2)]
  run_kw = dict(total_generation_steps=SFT_DECODE_STEPS,
                end_sampling_at_eos_token=False)
  tokens_by_mode = {}
  for captured in (True, False):
    qsampler = sampler_lib.Sampler(qmodel, vocab, device=dev,
                                   jit_compile=captured)
    qsampler(prompts, **run_kw)  # warm-up (captures the decode step)
    out = qsampler(prompts, **run_kw)
    tokens_by_mode[captured] = torch.stack(out.tokens).cpu()
    del qsampler
  log(f"  QLoRA Sampler, {SFT_DECODE_STEPS} greedy steps on 2 x "
      f"{SFT_PROMPT_TOKENS} tokens: captured == eager "
      f"{torch.equal(tokens_by_mode[True], tokens_by_mode[False])}; first "
      f"tokens {tokens_by_mode[True][:, :8].tolist()}")
  if not torch.equal(tokens_by_mode[True], tokens_by_mode[False]):
    raise AssertionError("QLoRA captured and eager decode disagree.")

  log(f"  fine-tuning stages (step ms steady, real tokens/s, peak GB): " +
      "; ".join(f"{k} {v['steady_ms']:.1f} ms, "
                f"{real_tokens / v['steady_ms'] * 1e3:.0f}/s, "
                f"{v['peak_gb']:.2f} GB" for k, v in stats.items()))
  del img
  log(f"  phase 19 took {time.perf_counter() - phase_start:.1f} s")
  return dict(config=config, encoder=encoder, batch=batch, lora_cfg=lora_cfg,
              final_adapters=final_adapters, qmodel=qmodel, vocab=vocab)


class CheckpointClock:
  """Times the port's checkpoint I/O while installed: each train-state
  write (a synchronous save, or the async saver's thread) with its bytes,
  each ``AsyncTrainStateSaver.save`` call on the host with the device time
  its snapshot holds the stream (CUDA events around the call), each
  train-state load."""

  def __init__(self):
    self.writes, self.saves, self.loads = [], [], []
    self._saved = (checkpoint_io.save_train_state,
                   checkpoint_io.AsyncTrainStateSaver.save,
                   checkpoint_io.load_train_state)
    write, save, load = self._saved
    clock = self

    def timed_write(path, *args, **kwargs):
      start = time.perf_counter()
      write(path, *args, **kwargs)
      clock.writes.append(dict(
          name=os.path.basename(path), s=time.perf_counter() - start,
          thread=threading.current_thread().name,
          bytes=os.path.getsize(path)))

    def timed_save(saver, path, *args, **kwargs):
      events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
      events[0].record()
      start = time.perf_counter()
      save(saver, path, *args, **kwargs)
      host_s = time.perf_counter() - start
      events[1].record()
      clock.saves.append(dict(name=os.path.basename(path), host_s=host_s,
                              events=events))

    def timed_load(path, *args, **kwargs):
      start = time.perf_counter()
      out = load(path, *args, **kwargs)
      clock.loads.append(dict(name=os.path.basename(path),
                              s=time.perf_counter() - start))
      return out

    checkpoint_io.save_train_state = timed_write
    checkpoint_io.AsyncTrainStateSaver.save = timed_save
    checkpoint_io.load_train_state = timed_load

  def restore(self) -> None:
    (checkpoint_io.save_train_state, checkpoint_io.AsyncTrainStateSaver.save,
     checkpoint_io.load_train_state) = self._saved

  def report(self) -> None:
    for save in self.saves:
      save["events"][1].synchronize()
      log(f"  async save of {save['name']}: save() returned after "
          f"{save['host_s'] * 1e3:.1f} ms on the host (clones enqueued); "
          f"the stream spent "
          f"{save['events'][0].elapsed_time(save['events'][1]):.1f} ms "
          f"across the call")
    for w in self.writes:
      how = "on the saver's thread" if "writer" in w["thread"] else "in line"
      log(f"  wrote {w['name']} {how}: {w['bytes'] / 1e9:.3f} GB in "
          f"{w['s']:.2f} s ({w['bytes'] / 1e9 / w['s']:.2f} GB/s)")
    for load in self.loads:
      log(f"  loaded {load['name']} (train state, host, mapped): "
          f"{load['s']:.2f} s")


def _tick_counts() -> dict[str, int]:
  return {"lru_scan": lru_scan.launches, "window_attention": wa.launches,
          "int8_weight_matmul": int8_matmul.launches,
          "int8_weight_matmul_wgmma": int8_matmul.wgmma_launches}


class TickProbe:
  """Counts the kernel launches of each ``serving._tick_step`` call (the
  eager steps, and a captured tick's warm-up and capture: one step's
  launches) and of each batcher's ``_tick`` (the counters miss a captured
  tick's replays); ``replays`` are the captured steps replayed."""

  def __init__(self, counts=_tick_counts):
    self.counts = counts
    self.step_launches = None
    self.tick_launches = {k: 0 for k in counts()}
    self._step = serving._tick_step  # pylint: disable=protected-access
    probe = self

    def counted_step(*args, **kwargs):
      before = counts()
      probe._step(*args, **kwargs)
      after = counts()
      probe.step_launches = {k: after[k] - before[k] for k in after}

    serving._tick_step = counted_step  # pylint: disable=protected-access

  def watch(self, batcher) -> None:
    tick = batcher._tick  # pylint: disable=protected-access

    def counted_tick(n):
      before = self.counts()
      tick(n)
      after = self.counts()
      for k in after:
        self.tick_launches[k] += after[k] - before[k]

    batcher._tick = counted_tick  # pylint: disable=protected-access

  def close(self) -> None:
    serving._tick_step = self._step  # pylint: disable=protected-access


def _capture_first_logits(batcher, store: list):
  """Appends each admission's first-token logits (the prefill's, float32)
  to ``store``, for the batcher's sampler and its adapter twin's; returns
  the function that takes the wrappers off (before another batcher copies
  the sampler)."""
  samplers = (batcher.sampler, batcher._prefill_sampler)  # pylint: disable=protected-access
  for s in samplers:
    prefill = s._prefill  # pylint: disable=protected-access

    def wrapped(*args, _prefill=prefill, **kwargs):
      state = _prefill(*args, **kwargs)
      store.append(state.logits_buffer[0, 0].float().clone())
      return state

    s._prefill = wrapped  # pylint: disable=protected-access

  def restore():
    for s in samplers:
      del s._prefill  # pylint: disable=protected-access

  return restore


def _drive_batcher(batcher, specs, adapters_of) -> dict:
  """One request joins a tick while a slot is free; every tick decodes
  BATCH_TICK steps. Returns {name: tokens}."""
  queue, names, tokens = list(specs), {}, {}
  while queue or batcher.active_count:
    if queue and batcher.has_capacity:
      spec = queue.pop(0)
      names[batcher.add_request(
          spec["prompt"], adapters=adapters_of(spec["kind"]))] = spec["name"]
    batcher.step(BATCH_TICK)
    for rid, got, _ in batcher.pop_finished():
      tokens[names[rid]] = got
  return tokens


def _adapter_specs(config, seed: int, n: int, kinds, lengths) -> list[dict]:
  rng = np.random.default_rng(seed)
  return [dict(name=f"{kinds[i % len(kinds)]}_{i}", kind=kinds[i % len(kinds)],
               tokens=int(length),
               prompt=" ".join(f"w{j}" for j in rng.integers(
                   0, config.vocab_size - 4, int(length) - 1)))
          for i, length in zip(range(n), lengths)]


def _http_error(port: int, body: dict) -> tuple[int, str]:
  try:
    _http(port, "/v1/generate", body)
  except urllib.error.HTTPError as e:
    return e.code, json.loads(e.read()).get("error", "")
  raise AssertionError(f"/v1/generate accepted {body}.")


def phase_adapters(dev, kernels: list[dict], handoff: dict,
                   ckpt_dir: str) -> None:
  """Adapters end to end on phase 19's models: resume and preemption from
  the LoRA run's checkpoints, multi-LoRA serving on the bf16 and the QLoRA
  base (captured against eager ticks, two join orders, solo calls), and
  per-request adapters over HTTP."""
  phase_start = time.perf_counter()
  config, encoder, batch = (handoff[k] for k in ("config", "encoder",
                                                  "batch"))
  final_adapters, vocab = handoff["final_adapters"], handoff["vocab"]
  by_name = {kernel["name"]: kernel for kernel in kernels}
  n_recurrent = sum(bt is common.TemporalBlockType.RECURRENT
                    for bt in config.block_types)
  n_attention = config.num_layers - n_recurrent
  launched = {k: 0 for k in _sft_counts()}

  def add_launches():
    for k, v in _sft_counts().items():
      launched[k] += v
    _reset_sft_counts()

  log(f"== adapters end to end (after 19, on its models): resume and "
      f"preemption, multi-LoRA serving on the bf16 and the QLoRA base, "
      f"per-request adapters over HTTP; "
      f"{shutil.disk_usage(ckpt_dir).free / 1e9:.1f} GB free under the "
      f"checkpoints' directory")

  # (a) Checkpoints. The serving model is step_2's combined tree with its
  # adapters re-drawn; a preempted run, then a resume from step_2.
  step2 = os.path.join(ckpt_dir, "step_2")
  start = time.perf_counter()
  state = checkpoint_io.load_parameters(step2, device=dev)
  torch.cuda.synchronize()
  load_s = time.perf_counter() - start
  step2_adapters, base = sft_lora.split_lora(state)
  model = griffin.Griffin(config, device="meta",
                          dtype=base["final_norm.scale"].dtype,
                          lora_rank=SFT_LORA_RANK)
  model.to_empty(device=dev)
  model.load_state_dict(sft_lora.merge_params(base, sft_lora.init_adapters(
      model, torch.Generator(dev).manual_seed(SEED + 100))))
  log(f"  (a) load_parameters(step_2) onto the card: "
      f"{sum(v.numel() * v.element_size() for v in state.values()) / 1e9:.3f}"
      f" GB in {load_s:.2f} s; a fresh model of its base with adapters "
      f"re-drawn")
  del state, base
  clock = CheckpointClock()
  handler = resilience.PreemptionHandler()
  logged = []

  def notice(metrics, step):
    logged.append((step, sorted(metrics)))
    if step == 1:
      handler.trigger()  # the notice arrives while step 2 runs

  lora_cfg = handoff["lora_cfg"]
  _reset_sft_counts()
  try:
    train_loop_lib.train_loop(
        model, [batch] * SFT_LORA_STEPS,
        dataclasses.replace(lora_cfg, checkpoint_dir=ckpt_dir,
                            checkpoint_every_n=None),
        encode_image=encoder, log_metrics=notice, device=dev,
        preemption=handler)
    preempted = os.path.join(ckpt_dir, "preempted_step_2")
    _, _, saved_step = checkpoint_io.load_train_state(preempted, device="cpu")
    log(f"  preemption triggered after step 1: the loop logged {logged}, "
        f"saved {sorted(os.listdir(ckpt_dir))}, preempted_step_2 holds step "
        f"{saved_step}")
    if logged[-1] != (2, ["preempted_at"]) or saved_step != 2:
      raise AssertionError("The preempted run did not save step 2.")
    os.remove(preempted)
    step_clock = StageClock()
    clock.loads.clear()
    train_loop_lib.train_loop(
        model, [batch] * SFT_LORA_STEPS,
        dataclasses.replace(lora_cfg, resume_from=step2),
        encode_image=encoder, log_metrics=step_clock, device=dev)
  finally:
    clock.restore()
  add_launches()
  clock.report()
  if [s for s, _, _ in step_clock.steps] != [SFT_LORA_STEPS]:
    raise AssertionError(f"The resumed run logged {step_clock.steps}.")
  named = dict(model.named_parameters())
  exact, worst = 0, (0.0, "")
  for name, want in final_adapters.items():
    got = named[name].detach()
    if torch.equal(got, want):
      exact += 1
    else:
      worst = max(worst, (_rel_rms(got, want), name))
  log(f"  resumed from step_2, step 3 against the uninterrupted run's: "
      f"{exact} of {len(final_adapters)} adapter leaves bit for bit; the "
      f"worst other leaf rel_rms {worst[0]:.3e} {worst[1]} (tolerance "
      f"{RESUME_REL_RMS}); step {step_clock.steps[0][1]:.6f} loss")
  if worst[0] > RESUME_REL_RMS:
    raise AssertionError("The resumed step disagrees with the uninterrupted "
                         "run.")
  with torch.no_grad():
    for name, p in named.items():
      if name.endswith("lora_b"):
        p.zero_()  # the serving model's own adapters: none (the base)
  del encoder, batch, handoff["encoder"], handoff["batch"]
  torch.cuda.empty_cache()

  # (b) Multi-LoRA serving on the bf16 base.
  kinds = {"step_2": step2_adapters, "final": final_adapters, "none": None}
  rng = np.random.default_rng(SEED + 101)
  lengths = [BATCH_LONG_TOKENS] + list(rng.integers(
      *ML_PROMPT_RANGE, size=ML_REQUESTS - 1))
  specs = _adapter_specs(config, SEED + 102, ML_REQUESTS, list(kinds),
                         lengths)
  want = {"lru_scan": n_recurrent * ML_REQUESTS,
          "window_attention": n_attention * sum(
              s["tokens"] > ATTN_WINDOW for s in specs),
          "int8_weight_matmul": 0, "int8_weight_matmul_wgmma": 0}
  samplers = {captured: sampler_lib.Sampler(
      model, vocab, device=dev, repetition_penalty=BATCH_PENALTY,
      jit_compile=captured) for captured in (True, False)}
  orders = {"A captured": (specs, True),
            "B captured": (specs[::-1][1::2] + specs[::-1][0::2], True),
            "A eager": (specs, False)}
  runs, first_logits = {}, {}
  for label, (order, captured) in orders.items():
    b = serving.ContinuousBatcher(samplers[captured], num_slots=ML_SLOTS,
                                  max_steps_default=ML_STEPS,
                                  multi_lora=True, record_logprobs=1)
    firsts = []
    uncapture = _capture_first_logits(b, firsts)
    probe = TickProbe()
    probe.watch(b)
    lru_scan.launches = wa.launches = 0
    int8_matmul.launches = int8_matmul.wgmma_launches = 0
    reset_scan_routes()
    start = time.perf_counter()
    try:
      runs[label] = _drive_batcher(b, order, kinds.__getitem__)
      torch.cuda.synchronize()
    finally:
      probe.close()
      uncapture()
    got = _tick_counts()
    check_scan_routes(got["lru_scan"])
    add_launches()
    first_logits[label] = dict(zip((s["name"] for s in order), firsts))
    log(f"  (b) {ML_SLOTS}-slot multi-LoRA batcher, order {label}: "
        f"{time.perf_counter() - start:.2f} s; launches {got} (want {want}),"
        f" in the ticks {probe.tick_launches}; a tick step "
        f"{probe.step_launches}")
    if got != want or any(probe.tick_launches.values()):
      raise AssertionError(f"Order {label} launched {got} (ticks "
                           f"{probe.tick_launches}), want {want}, none in "
                           f"the ticks.")
    if label == "A captured":
      twin = b._model_ml  # pylint: disable=protected-access
      shared = [p.data_ptr() == named[n].data_ptr()
                for n, p in twin.named_parameters()
                if not sft_lora.is_lora_path(n)]
      stacks = sum(p.numel() * p.element_size()
                   for n, p in twin.named_parameters()
                   if sft_lora.is_lora_path(n))
      log(f"  the tick's twin: {sum(shared)} of {len(shared)} base tensors "
          f"share the sampler model's storage; its stacks "
          f"{stacks / 1e6:.1f} MB ({stacks / ML_SLOTS / 1e6:.1f} MB a slot)")
      if not all(shared):
        raise AssertionError("The twin copied base tensors.")
      del twin
    del b
  same = {s["name"]: len({tuple(r[s["name"]]) for r in runs.values()}) == 1
          for s in specs}
  distinct = [len(set(t)) for t in runs["A captured"].values()]
  log(f"  tokens identical across the two join orders and the eager tick: "
      f"{sum(same.values())} of {len(same)}; distinct tokens a request min "
      f"{min(distinct)}, max {max(distinct)} of {ML_STEPS}")
  if not all(same.values()):
    raise AssertionError(f"Runs disagree: "
                         f"{[n for n, v in same.items() if not v]}.")

  # Each request against a solo batch-1 Sampler on merge_params(base, its
  # adapters): the first token's logits, and the tokens (printed).
  rels, agree, total = [], 0, 0
  for kind, adapters in kinds.items():
    with torch.no_grad():
      for name, p in named.items():
        if sft_lora.is_lora_path(name):
          p.copy_(adapters[name] if adapters is not None
                  else torch.zeros_like(p))
    solo = sampler_lib.Sampler(model, vocab, device=dev,
                               repetition_penalty=BATCH_PENALTY)
    for s in specs:
      if s["kind"] != kind:
        continue
      out = solo([s["prompt"]], total_generation_steps=ML_STEPS,
                 return_logits=True)
      rels.append(_rel_rms(first_logits["A captured"][s["name"]],
                           out.logits[0][0].float()))
      got = runs["A captured"][s["name"]]
      agree += sum(a == b for a, b in zip(got, out.tokens[0].tolist()))
      total += len(got)
    del solo
  with torch.no_grad():
    for name, p in named.items():
      if name.endswith("lora_b"):
        p.zero_()
  log(f"  first-token logits against solo batch-1 Samplers on the merged "
      f"weights: rel_rms max {max(rels):.3e}, median "
      f"{float(np.median(rels)):.3e} (tolerance {MODEL_LOGITS_REL_RMS}); "
      f"token agreement {agree} of {total}")
  if not max(rels) <= MODEL_LOGITS_REL_RMS:
    raise AssertionError("A request's first logits disagree with its solo "
                         "Sampler's.")

  # The multi-LoRA tick against the plain tick of the same model, in turns,
  # and one admission's stall.
  steady = {}
  for multi in (False, True):
    b = serving.ContinuousBatcher(samplers[True], num_slots=ML_SLOTS,
                                  max_steps_default=4096, multi_lora=multi)
    for i, kind in zip(range(ML_SLOTS), itertools.cycle(list(kinds))):
      b.add_request(" ".join(f"w{j}" for j in rng.integers(
          0, config.vocab_size - 4, 300)),
                    adapters=kinds[kind] if multi else None)
    b.step(BATCH_TICK)  # admits all eight and captures the tick
    steady[multi] = b
  with torch.inference_mode():
    for b in steady.values():
      b._tick(BATCH_TICK)  # pylint: disable=protected-access
  tick_ms = {False: [], True: []}
  for multi in ML_TICK_TURNS:
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    events[0].record()
    with torch.inference_mode():
      for _ in range(TICK_REPEATS):
        steady[multi]._tick(BATCH_TICK)  # pylint: disable=protected-access
    events[1].record()
    events[1].synchronize()
    tick_ms[multi].append(events[0].elapsed_time(events[1]) / TICK_REPEATS
                          / BATCH_TICK)
  med = {k: float(np.median(v)) for k, v in tick_ms.items()}
  log(f"  decode ms a step in turns {ML_TICK_TURNS} (True: the multi-LoRA "
      f"{ML_SLOTS}-slot tick, False: the plain {ML_SLOTS}-slot tick of the "
      f"same model, {BATCH_TICK} steps a tick, CUDA events around "
      f"{TICK_REPEATS} ticks): multi-LoRA "
      f"{[round(t, 3) for t in tick_ms[True]]}, plain "
      f"{[round(t, 3) for t in tick_ms[False]]}; ratio of medians "
      f"{med[True] / med[False]:.3f}; {ML_SLOTS * 1e3 / med[True]:.1f} "
      f"against {ML_SLOTS * 1e3 / med[False]:.1f} tokens/s")
  b = steady[True]
  rid = next(iter(b._requests.values())).request_id  # pylint: disable=protected-access
  b.cancel(rid)
  stall = {"no admission": [], "an admission with adapters": [],
           "an admission without": []}
  writes = {key: [] for key in stall}  # host ms writing adapters
  admission_sampler = b._admission_sampler  # pylint: disable=protected-access
  scatter = sft_lora.scatter_adapters
  spent = [0.0]

  def timed(fn):
    def call(*args, **kwargs):
      start = time.perf_counter()
      out = fn(*args, **kwargs)
      spent[0] += (time.perf_counter() - start) * 1e3
      return out
    return call

  b._admission_sampler = timed(admission_sampler)  # pylint: disable=protected-access
  sft_lora.scatter_adapters = timed(scatter)
  prompt = " ".join(f"w{j}" for j in rng.integers(0, config.vocab_size - 4,
                                                    ML_STALL_TOKENS - 1))
  for _ in range(ML_STALL_REPEATS):
    for key in stall:
      new = None
      if key != "no admission":
        new = b.add_request(prompt, adapters=final_adapters
                            if key.endswith("adapters") else None)
      spent[0] = 0.0
      start = time.perf_counter()
      b.step(BATCH_TICK)
      stall[key].append((time.perf_counter() - start) * 1e3)
      writes[key].append(spent[0])
      if new is not None:
        b.cancel(new)
  del b._admission_sampler  # pylint: disable=protected-access
  sft_lora.scatter_adapters = scatter
  base_ms = float(np.median(stall["no admission"]))
  for key, values in stall.items():
    log(f"    tick ({BATCH_TICK} steps, {ML_SLOTS - 1} rows live) with "
        f"{key} ({ML_STALL_TOKENS} tokens): "
        f"{[round(v, 2) for v in values]} ms, median "
        f"{float(np.median(values)):.2f} (stall "
        f"{float(np.median(values)) - base_ms:+.2f}); host ms choosing the "
        f"admission's sampler and writing its adapters "
        f"{[round(v, 2) for v in writes[key]]}")
  del steady, b

  # (c) Multi-LoRA on the QLoRA base: 19(c)'s trained adapters (the
  # sampler's own), fresh ones, explicit zeros and none.
  qmodel = handoff.pop("qmodel")
  trained = {n: p.detach().clone() for n, p in qmodel.named_parameters()
             if sft_lora.is_lora_path(n)}
  gen = torch.Generator(dev).manual_seed(SEED + 103)
  fresh = sft_lora.init_adapters(qmodel, gen)
  for name, leaf in fresh.items():
    if name.endswith("lora_b"):
      leaf.normal_(0.0, 1e-2, generator=gen)
  qkinds = {"trained": trained, "fresh": fresh,
            "zero": {n: torch.zeros_like(v) for n, v in trained.items()},
            "none": None}
  qspecs = _adapter_specs(config, SEED + 104, ML_Q_REQUESTS, list(qkinds),
                          rng.integers(*ML_PROMPT_RANGE, size=ML_Q_REQUESTS))
  qtokens = {}
  per_step = _weight_only_launches(qmodel)
  for captured in (True, False):
    qsampler = sampler_lib.Sampler(qmodel, vocab, device=dev,
                                   repetition_penalty=BATCH_PENALTY,
                                   jit_compile=captured)
    b = serving.ContinuousBatcher(qsampler, num_slots=ML_Q_SLOTS,
                                  max_steps_default=ML_STEPS,
                                  multi_lora=True)
    probe = TickProbe()
    probe.watch(b)
    capture = CaptureInt8Calls() if captured else None
    try:
      qtokens[captured] = _drive_batcher(b, qspecs, qkinds.__getitem__)
    finally:
      probe.close()
      if capture is not None:
        capture.restore()
    add_launches()
    step = probe.step_launches
    replays = sum(g.replays for g in b._programs.values())  # pylint: disable=protected-access
    log(f"  (c) QLoRA base, {ML_Q_SLOTS}-slot multi-LoRA batcher "
        f"({'captured' if captured else 'eager'} tick): a tick step "
        f"launches {step}; {replays} captured steps replayed")
    if step != {"lru_scan": 0, "window_attention": 0,
                "int8_weight_matmul": per_step,
                "int8_weight_matmul_wgmma": 0}:
      raise AssertionError(f"The QLoRA tick step launched {step}; want "
                           f"{per_step} mma.sync launches and nothing else.")
    if captured:
      by_name["int8_weight_matmul"]["launches"] += per_step * replays
      for key, args in capture.inputs():
        if key[3] != ML_Q_SLOTS:
          continue  # an admission's prefill
        err = check_int8(*args)
        by_name["int8_weight_matmul"]["max_abs_err"] = max(
            by_name["int8_weight_matmul"]["max_abs_err"], err)
        log(f"    int8_weight_matmul on the first tick's inputs a "
            f"{tuple(args[0].shape)} x q {tuple(args[1].shape)}: "
            f"max_abs_err {err:.3e}")
    del b, qsampler
  same = sum(qtokens[True][s["name"]] == qtokens[False][s["name"]]
             for s in qspecs)
  log(f"  QLoRA multi-LoRA tokens, captured == eager: {same} of "
      f"{len(qspecs)}")
  if same != len(qspecs):
    raise AssertionError("The QLoRA multi-LoRA captured and eager ticks "
                         "disagree.")
  del qmodel, trained, fresh, qkinds
  torch.cuda.empty_cache()

  # (d) HTTP: the resolver maps names to the loaded adapters.
  http_rng = np.random.default_rng(SEED + 105)
  http_prompt = " ".join(f"w{i}" for i in http_rng.integers(
      0, config.vocab_size - 4, HTTP_PROMPT_TOKENS))
  direct = serving.ContinuousBatcher(samplers[True], num_slots=HTTP_SLOTS,
                                     max_steps_default=HTTP_STEPS,
                                     multi_lora=True)
  direct.add_request(http_prompt, adapters=step2_adapters)
  ((_, direct_tokens, _),) = direct.run_until_drained(BATCH_TICK)
  del direct
  frontend = server_lib.ServingFrontend(
      serving.ContinuousBatcher(samplers[True], num_slots=HTTP_SLOTS,
                                max_steps_default=HTTP_STEPS,
                                multi_lora=True, reuse_programs=False),
      step_size=BATCH_TICK,
      adapter_resolver={"step_2": step2_adapters,
                        "final": final_adapters}.__getitem__)
  srv = server_lib.ServingHTTPServer(frontend, host="127.0.0.1", port=0)
  bare = server_lib.ServingHTTPServer(server_lib.ServingFrontend(
      serving.ContinuousBatcher(samplers[True], num_slots=1,
                                max_steps_default=HTTP_STEPS),
      step_size=BATCH_TICK), host="127.0.0.1", port=0)
  try:
    status, _, out = _http(srv.port, "/v1/generate", {
        "prompt": http_prompt, "max_tokens": HTTP_STEPS, "adapter": "step_2"})
    unknown = _http_error(srv.port, {"prompt": http_prompt,
                                     "adapter": "unknown"})
    no_resolver = _http_error(bare.port, {"prompt": http_prompt,
                                          "adapter": "step_2"})
  finally:
    srv.close()
    bare.close()
  add_launches()
  log(f"  (d) /v1/generate with adapter step_2: status {status}, tokens "
      f"identical to the direct batcher's {out['tokens'] == direct_tokens}; "
      f"an unknown adapter {unknown}; a server without a resolver "
      f"{no_resolver}")
  if (status != 200 or out["tokens"] != direct_tokens or unknown[0] != 400
      or no_resolver[0] != 400 or frontend._error is not None):  # pylint: disable=protected-access
    raise AssertionError("The HTTP adapter checks failed.")

  for name, count in launched.items():
    by_name[name]["launches"] += count
  log(f"  launches of phase 20's runs: {launched} (added to their rows)")
  del samplers, model, kinds, step2_adapters
  handoff.clear()
  log(f"  phase 20 took {time.perf_counter() - phase_start:.1f} s")


# Speculative decoding (phase 21): JAX's speculative workload
# (``benchmarks/multimodal_bench.py:1337-1440``: batch 1, a 128-token
# prompt cycling through 8 words, 256 steps, draft 7, ngram 2), a seeded
# non-repeating prompt of the same length, and the smoke's 2 x 3000/2300
# prompts (the window kernel in the prefill), on phase 18's models.
SPEC_DRAFT = 7
SPEC_NGRAM = 2
SPEC_PROMPT_TOKENS = 128
SPEC_CYCLE_STEPS = 256
SPEC_FREE_STEPS = 128
# The fp32-carry walk at a verify step's shapes: batch 2 and an 8-slot tick
# of draft_len + 1 tokens.
CARRY_SHAPES = ((2, SPEC_DRAFT + 1, 2560), (8, SPEC_DRAFT + 1, 2560))
CARRY_MAX_ABS_ERR = 0.0
CARRY_REPLACES = ("cadence_gemma_tpu/ops/scan.py:57 (lru_linear_scan with "
                  "y_in_acc_dtype; the verify's lax.scan, "
                  "cadence_gemma_tpu/models/layers.py:428)")
# Tokens of speculative and plain greedy runs agree, or first differ where
# the plain run's two largest logits lie within this share of the larger
# one's magnitude (the verify's products run at b * (k + 1) rows, decode's
# at b: the library may round them differently).
SPEC_TIE_REL = 0.01
SPEC_TURNS = ("plain", "spec", "spec", "plain")
SPEC_MM_TOKENS = 200
SPEC_LORA_RANK = 8
SPEC_LORA_SLOTS = 4
SPEC_LORA_STEPS = 32
SPEC_LORA_TOKENS = (600, 300, 900, 450)
SPEC_LORA_B_STD = 0.02
SPEC_HTTP_CUT = 5


def _spec_counts() -> dict[str, int]:
  return {"lru_scan_carries": lru_scan.carry_launches,
          "lru_scan": lru_scan.launches, "window_attention": wa.launches,
          "int8_weight_matmul": int8_matmul.launches,
          "int8_weight_matmul_wgmma": int8_matmul.wgmma_launches,
          "add_rmsnorm": fused_epilogue.launches,
          "mha_attention": mha_attention.launches}


class SpecProbe:
  """Sees the speculative loops, captured or eager: CUDA events around each
  ``SpeculativeSampler._loop`` give verify ms a step, and the counters read
  around a verify step's Python (a graph's warm-up and capture) give one
  step's launches; a run's launches are the counters' plus those times the
  replays (:meth:`run_launches`)."""

  def __init__(self, counts):
    self.counts = counts
    self.step_launches = None
    self.loops = []  # [start event, end event, steps]
    self.replays = 0
    self._saved = (speculative.SpeculativeSampler._loop,  # pylint: disable=protected-access
                   speculative._SpecGraph._step,  # pylint: disable=protected-access
                   speculative._SpecGraph.replay)  # pylint: disable=protected-access
    loop, step, replay = self._saved
    probe = self

    def timed_loop(spec, state, generator, *args):
      start = torch.cuda.Event(enable_timing=True)
      start.record()
      out, steps = loop(spec, state, generator, *args)
      end = torch.cuda.Event(enable_timing=True)
      end.record()
      probe.loops.append([start, end, steps])
      return out, steps

    def counted_step(graph, fn):
      before = probe.counts()
      step(graph, fn)
      after = probe.counts()
      probe.step_launches = {k: after[k] - before[k] for k in after}

    def counted_replay(graph):
      probe.replays += 1
      return replay(graph)

    speculative.SpeculativeSampler._loop = timed_loop  # pylint: disable=protected-access
    speculative._SpecGraph._step = counted_step  # pylint: disable=protected-access
    speculative._SpecGraph.replay = counted_replay  # pylint: disable=protected-access

  def reset(self) -> None:
    self.loops.clear()
    self.replays = 0

  def verify_ms(self) -> float:
    start, end, steps = self.loops[-1]
    end.synchronize()
    return start.elapsed_time(end) / max(steps, 1)

  def run_launches(self, counted: dict[str, int]) -> dict[str, int]:
    if not self.replays:
      return dict(counted)
    return {k: counted[k] + self.step_launches[k] * self.replays
            for k in counted}

  def close(self) -> None:
    (speculative.SpeculativeSampler._loop, speculative._SpecGraph._step,  # pylint: disable=protected-access
     speculative._SpecGraph.replay) = self._saved  # pylint: disable=protected-access


def _trim_at_stop(tokens, stops) -> list[int]:
  tokens = [int(t) for t in tokens]
  for i, t in enumerate(tokens):
    if t in stops:
      return tokens[:i + 1]
  return tokens


def token_agreement(label: str, got, want, logits, stops) -> dict:
  """``got`` (speculative, batched) against the reference ``want`` (plain,
  solo; one row each, cut at the first stop token): identical, or the first
  difference where the reference's two largest ``logits`` (its [steps,
  vocab] row) lie within SPEC_TIE_REL of the larger's magnitude; raises
  otherwise."""
  got, want = _trim_at_stop(got, stops), _trim_at_stop(want, stops)
  n = min(len(got), len(want))
  first = next((i for i in range(n) if got[i] != want[i]),
               None if len(got) == len(want) else n)
  if first is None:
    return dict(identical=True, tokens=n)
  top = logits[first].float().topk(2).values
  gap = ((top[0] - top[1]) / top[0].abs()).item()
  log(f"    {label}: first difference at token {first} of {n} (this run "
      f"{got[first:first + 1]}, the reference {want[first:first + 1]}); the "
      f"reference's two largest logits there {top.tolist()}, gap "
      f"{gap:.3e} of the larger (rule: within {SPEC_TIE_REL})")
  if gap > SPEC_TIE_REL:
    raise AssertionError(f"{label}: the tokens differ from the reference's "
                         f"at {first} outside a near tie (gap {gap:.3e}).")
  return dict(identical=False, tokens=n, first=first, gap=gap)


def phase_carry_walk(dev) -> dict:
  """The fp32-carry walk (``lru_scan.lru_scan_carries``) at the verify's
  shapes against its plain loop, bit for bit; its bf16 cast against the
  bf16 walk's y; timed at batch 2 (the widening copies included)."""
  rng = np.random.default_rng(SEED + 90)
  log(f"== lru_scan_carries (the verify's fp32-carry walk) vs plain at "
      f"{[list(s) for s in CARRY_SHAPES]} bf16 with h0 (tolerance "
      f"{CARRY_MAX_ABS_ERR}; its y cast to bf16 against the bf16 walk)")
  worst = 0.0
  for shape in CARRY_SHAPES:
    b, t, d = shape
    x = torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                     device=dev).bfloat16()
    a = torch.sigmoid(torch.tensor(rng.standard_normal(
        shape, dtype=np.float32), device=dev)).bfloat16()
    h0 = torch.tensor(rng.standard_normal((b, d), dtype=np.float32),
                      device=dev)
    y, h = lru_scan.lru_scan_carries(x, a, h0)
    want_y, want_h = lru_scan.lru_scan_plain(x, a, h0, y_in_acc_dtype=True)
    err = max(max_err(y, want_y), max_err(h, want_h))
    same_bf16 = torch.equal(y.bfloat16(),
                            lru_scan.lru_scan_forward(x, a, h0)[0])
    log(f"  {list(shape)}: y {y.dtype}, max_abs_err {err}; y.to(bf16) equals "
        f"the bf16 walk's y {same_bf16}")
    if err > CARRY_MAX_ABS_ERR or not same_bf16 or y.dtype != torch.float32:
      raise AssertionError(f"The fp32-carry walk disagrees at {shape}.")
    worst = max(worst, err)
    if shape == CARRY_SHAPES[0]:
      inputs = (x, a, h0)
  # Read x and a (bf16) and h0, write y and h_last (fp32); 2 fp32 flops a
  # step.
  b, t, d = CARRY_SHAPES[0]
  n_bytes = 2 * b * t * d * 2 + b * d * 4 + b * t * d * 4 + b * d * 4
  figures = time_scan(lru_scan.lru_scan_carries, inputs, n_bytes, 2 * b * t * d)
  plain_ms = cuda_ms(lambda: lru_scan.lru_scan_plain(
      *inputs, y_in_acc_dtype=True), reps=5)
  log_scan(figures, plain_ms, n_bytes)
  return dict(name="lru_scan_carries", route="cuda",
              source="cadence_gemma_tpu_torch/csrc/lru_scan.cu",
              replaces=CARRY_REPLACES, max_abs_err=worst, plain_ms=plain_ms,
              library_ms=None, launches=0, **figures)


def _spec_text_runs(side: str, sampler, workloads: dict, probe: SpecProbe,
                    stops, served: dict, want_step: dict):
  """Each workload through a SpeculativeSampler over ``sampler`` and through
  ``sampler`` itself: launches a verify step, the token rule, acceptance.
  Returns the SpeculativeSampler (its graphs captured) and {workload: its
  output}."""
  spec = speculative.SpeculativeSampler(sampler, SPEC_DRAFT, SPEC_NGRAM)
  outs = {}
  for name, (prompts, steps) in workloads.items():
    probe.reset()
    before = _spec_counts()
    reset_scan_routes()
    out = spec(prompts, steps)
    torch.cuda.synchronize()
    counted = {k: v - before[k] for k, v in _spec_counts().items()}
    check_scan_routes(counted["lru_scan"])
    run = probe.run_launches(counted)
    for k, v in run.items():
      served[k] += v
    step = {k: probe.step_launches[k] for k in want_step}
    stats = spec.last_stats
    log(f"  {side} {name} ({len(prompts)} x {len(sampler.tokenize(prompts[0]))}"
        f" tokens, {steps} steps): {stats['verify_steps']} verify steps "
        f"({probe.replays} replays of one captured step), tokens_emitted "
        f"{stats['tokens_emitted']}, tokens_per_verify_step "
        f"{stats['tokens_per_verify_step']:.3f}; a verify step launched "
        f"{step}; the run {run}")
    if step != want_step or probe.replays != stats["verify_steps"]:
      raise AssertionError(f"{side} {name}: a verify step launched {step}, "
                           f"want {want_step}; {probe.replays} replays for "
                           f"{stats['verify_steps']} steps.")
    plain = sampler(prompts, steps, return_logits=True)
    for row, (g, w, lg) in enumerate(zip(out.tokens, plain.tokens,
                                         plain.logits)):
      agree = token_agreement(f"{side} {name} row {row}", g.tolist(),
                              w.tolist(), lg, stops)
      log(f"    row {row} against the captured plain Sampler: {agree}")
    outs[name] = out
  return spec, outs


def _spec_turns(sampler, spec, prompts, steps, decode_probe: DecodeProbe,
                probe: SpecProbe, stops) -> dict:
  """Plain and speculative calls in SPEC_TURNS: wall ms, tokens/s (host
  clock around the call, synchronized), captured decode / verify ms a
  step."""
  out = {"plain": [], "spec": []}
  for side in SPEC_TURNS:
    torch.cuda.synchronize()
    start = time.perf_counter()
    if side == "plain":
      res = sampler(prompts, steps)
      torch.cuda.synchronize()
      wall = time.perf_counter() - start
      emitted = sum(len(_trim_at_stop(t.tolist(), stops))
                    for t in res.tokens)
      step_ms = decode_probe.decode_ms()
    else:
      res = spec(prompts, steps)
      torch.cuda.synchronize()
      wall = time.perf_counter() - start
      emitted = spec.last_stats["tokens_emitted"]
      step_ms = probe.verify_ms()
    out[side].append((wall * 1e3, emitted / wall, step_ms))
  return out


def _log_turns(label: str, turns: dict) -> None:
  med = {side: [float(np.median([r[i] for r in rows])) for i in range(3)]
         for side, rows in turns.items()}
  log(f"  {label} in turns {SPEC_TURNS}: plain (wall ms, tokens/s, captured "
      f"decode ms a step) {[tuple(round(v, 3) for v in r) for r in turns['plain']]}"
      f"; speculative (wall ms, tokens/s, captured verify ms a step) "
      f"{[tuple(round(v, 3) for v in r) for r in turns['spec']]}; verify / "
      f"decode step {med['spec'][2] / med['plain'][2]:.3f}, speculative / "
      f"plain tokens/s {med['spec'][1] / med['plain'][1]:.3f}")


def _spec_batch_specs(vocab, config, seed: int) -> list[dict]:
  """Phase 17's sixteen requests, greedy and without a penalty (a
  speculative batcher takes neither): a 3000-token single shot, the same
  length in chunks of 1024, two 200-token continuations of one 2048-token
  prefix, twelve of 300-1500 tokens."""
  rng = np.random.default_rng(seed)

  def words(n):
    return " ".join(f"w{i}" for i in rng.integers(0, config.vocab_size - 4, n))

  specs = [dict(name="single_3000", prompt=words(BATCH_LONG_TOKENS - 1),
                chunk=None, prefix=False),
           dict(name="chunked_3000", prompt=words(BATCH_LONG_TOKENS - 1),
                chunk=CHUNK_TOKENS, prefix=False)]
  specs += [dict(name=f"prefix_{i}", prompt=words(BATCH_CONTINUATION_TOKENS),
                 chunk=None, prefix=True) for i in range(2)]
  for i, n in enumerate(rng.integers(*BATCH_PROMPT_RANGE,
                                     size=BATCH_REQUESTS - len(specs))):
    specs.append(dict(name=f"greedy_{i}", prompt=words(int(n) - 1),
                      chunk=None, prefix=False))
  return specs


def _drive_spec_batcher(batcher, sampler, specs, prefix_state) -> dict:
  """One request joins a tick while a slot is free (its chunk plan made with
  its chunk size); every tick decodes BATCH_TICK steps. Returns
  {name: tokens}."""
  queue, names, tokens = list(specs), {}, {}
  while queue or batcher.active_count:
    if queue and batcher.has_capacity:
      spec = queue.pop(0)
      sampler.prefill_chunk_size = spec["chunk"]
      try:
        kw = {"prefix_state": prefix_state} if spec["prefix"] else {}
        names[batcher.add_request(spec["prompt"], **kw)] = spec["name"]
      finally:
        sampler.prefill_chunk_size = None
    batcher.step(BATCH_TICK)
    for rid, got, _ in batcher.pop_finished():
      tokens[names[rid]] = got
  return tokens


def _graph_replays(batcher) -> int:
  return sum(g.replays for g in batcher._programs.values())  # pylint: disable=protected-access


def phase_speculative(dev, kernels: list[dict], handoff: dict) -> None:
  """Speculative decoding end to end on phase 18's realistic_params 2B, its
  int8 copy and its towers: the fp32-carry walk, SpeculativeSampler (bf16,
  int8, an image prompt with the fused epilogue), speculation in the
  batcher (two join orders, multi-LoRA) and the HTTP front end over it."""
  phase_start = time.perf_counter()
  model, qmodel, encoder, vocab, prompts = (
      handoff[k] for k in ("model", "qmodel", "encoder", "vocab", "prompts"))
  config = model.config
  by_name = {kernel["name"]: kernel for kernel in kernels}
  n_recurrent = sum(bt is common.TemporalBlockType.RECURRENT
                    for bt in config.block_types)
  stops = {vocab.eos_id()}
  served = {k: 0 for k in _spec_counts()}
  carry_row = phase_carry_walk(dev)
  kernels.append(carry_row)
  log(f"== speculative decoding on phase 18's models (draft_len "
      f"{SPEC_DRAFT}, ngram {SPEC_NGRAM}): SpeculativeSampler bf16 and int8, "
      f"an image prompt, the batcher and the HTTP front end")

  # (b), (c) Text: the cycling prompt (JAX's workload), a non-repeating
  # one, and the smoke's two long prompts.
  rng = np.random.default_rng(SEED + 91)
  cycle = [f"w{i}" for i in range(8)]
  cycling = " ".join(cycle[i % 8] for i in range(SPEC_PROMPT_TOKENS - 1))
  free = " ".join(f"w{i}" for i in rng.integers(0, config.vocab_size - 4,
                                                SPEC_PROMPT_TOKENS))
  workloads = {"cycling": ([cycling + " w1"], SPEC_CYCLE_STEPS),
               "non-repeating": ([free], SPEC_FREE_STEPS),
               "long prompts": (prompts, DECODE_STEPS)}
  n_int8 = _weight_only_launches(qmodel)
  zero = {k: 0 for k in _spec_counts()}
  want = {"bf16": dict(zero, lru_scan_carries=n_recurrent,
                       lru_scan=n_recurrent),
          "int8": dict(zero, lru_scan_carries=n_recurrent,
                       lru_scan=n_recurrent, int8_weight_matmul=n_int8)}
  samplers = {"bf16": sampler_lib.Sampler(model, vocab, device=dev),
              "int8": sampler_lib.Sampler(qmodel, vocab, device=dev,
                                          prefill_act_quant=True)}
  probe = SpecProbe(_spec_counts)
  decode_probe = DecodeProbe(_spec_counts)
  try:
    specs, outs = {}, {}
    for side in samplers:
      specs[side], outs[side] = _spec_text_runs(
          side, samplers[side], workloads, probe, stops, served, want[side])
    # Captured against eager speculation: greedy, and categorical from one
    # generator seed; identical tokens (and generator state).
    eager = sampler_lib.Sampler(model, vocab, device=dev, jit_compile=False)
    got = speculative.SpeculativeSampler(eager, SPEC_DRAFT, SPEC_NGRAM)(
        prompts, DECODE_STEPS)
    same = [a.tolist() == b.tolist() for a, b in
            zip(got.tokens, outs["bf16"]["long prompts"].tokens)]
    cats, gens = [], []
    for jit in (True, False):
      cat = sampler_lib.Sampler(model, vocab, device=dev, jit_compile=jit,
                                deterministic_sampling=False, **CATEGORICAL)
      gens.append(torch.Generator(dev).manual_seed(SEED + 92))
      cats.append(speculative.SpeculativeSampler(cat, SPEC_DRAFT, SPEC_NGRAM)(
          prompts, DECODE_STEPS, generator=gens[-1]))
    cat_same = [a.tolist() == b.tolist()
                for a, b in zip(cats[0].tokens, cats[1].tokens)]
    gen_same = torch.equal(gens[0].get_state(), gens[1].get_state())
    log(f"  captured against eager speculation on the long prompts: greedy "
        f"rows identical {same}; categorical ({CATEGORICAL}) rows identical "
        f"{cat_same}, generators at the same state {gen_same}")
    if not (all(same) and all(cat_same) and gen_same):
      raise AssertionError("Captured and eager speculation disagree.")
    del eager, cats
    # Verify step against decode step, speculative against plain tokens/s,
    # on the graphs the runs above captured.
    for side, name in (("bf16", "cycling"), ("bf16", "non-repeating"),
                       ("bf16", "long prompts"), ("int8", "cycling"),
                       ("int8", "non-repeating")):
      ps, steps = workloads[name]
      _log_turns(f"{side} {name} (batch {len(ps)})", _spec_turns(
          samplers[side], specs[side], ps, steps, decode_probe, probe,
          stops))

    # (d) An image prompt: the towers encode one image (the MHA kernel),
    # the fused-epilogue view of the 2B prefills it and verifies (the
    # add_rmsnorm kernel in every block of every verify step).
    fused = griffin._share_parameters(model)  # pylint: disable=protected-access
    for block in fused.blocks:
      block.fused_epilogue = True
    modal = modal_sampler.ModalSampler(fused, vocab, encoder, device=dev)
    pixels = torch.rand((1, *MM_PIXELS[1:]), device=dev,
                        generator=torch.Generator(dev).manual_seed(SEED + 93))
    mm_prompt = [" ".join(f"w{i}" for i in rng.integers(
        0, config.vocab_size - 4, SPEC_MM_TOKENS - 1))]
    before = _spec_counts()
    features = modal.encode(pixels)
    torch.cuda.synchronize()
    encoded = {k: v - before[k] for k, v in _spec_counts().items()}
    probe.reset()
    before = _spec_counts()
    spec = speculative.SpeculativeSampler(modal, SPEC_DRAFT, SPEC_NGRAM)
    out = spec(mm_prompt, DECODE_STEPS, img_embed=features)
    torch.cuda.synchronize()
    counted = {k: v - before[k] for k, v in _spec_counts().items()}
    run = probe.run_launches(counted)
    for k in served:
      served[k] += run[k] + encoded[k]
    step = probe.step_launches
    log(f"  (d) an image ({list(pixels.shape)} pixels, {features.shape[1]} "
        f"visual tokens) and {SPEC_MM_TOKENS} tokens through the "
        f"fused-epilogue 2B: the encode launched {encoded['mha_attention']} "
        f"MHA; a verify step {step}; {spec.last_stats}")
    n_towers = len(encoder.dino.blocks) + len(encoder.siglip.blocks)
    if (encoded["mha_attention"] != n_towers
        or step["add_rmsnorm"] != config.num_layers
        or step["lru_scan_carries"] != n_recurrent):
      raise AssertionError(f"The image run launched {encoded} in the encode "
                           f"and {step} a verify step.")
    plain = modal(mm_prompt, DECODE_STEPS, img_embed=features,
                  return_logits=True)
    # The plain run's logits include no visual positions after the prefill.
    agree = token_agreement("image", out.tokens[0].tolist(),
                            plain.tokens[0].tolist(), plain.logits[0], stops)
    log(f"    against the plain fused-epilogue Sampler: {agree}")
    del modal, fused, features
  finally:
    probe.close()
    decode_probe.close()
  del encoder  # phase 22 runs the towers again
  torch.cuda.empty_cache()

  # (e) Speculation in the batcher: phase 17's sixteen requests (greedy,
  # no penalty) in two join orders at 8 slots, against solo plain Samplers.
  sampler = samplers["bf16"]
  prefix_text = " ".join(f"w{i}" for i in rng.integers(
      0, config.vocab_size - 4, PREFIX_TOKENS - 1))
  prefix_state = sampler.prefill_prefix(prefix_text)
  specs = _spec_batch_specs(vocab, config, SEED + 94)
  tick_probe = TickProbe(_spec_counts)
  runs = {}
  try:
    for label, order in (("A", specs),
                         ("B", specs[::-1][1::2] + specs[::-1][0::2])):
      batcher = serving.ContinuousBatcher(
          sampler, num_slots=BATCH_SLOTS, max_steps_default=BATCH_STEPS,
          admission_chunks_per_tick=1, draft_len=SPEC_DRAFT,
          ngram=SPEC_NGRAM, reuse_programs=False)
      tick_probe.watch(batcher)
      before = _spec_counts()
      start = time.perf_counter()
      runs[label] = _drive_spec_batcher(batcher, sampler, order, prefix_state)
      torch.cuda.synchronize()
      wall = time.perf_counter() - start
      counted = {k: v - before[k] for k, v in _spec_counts().items()}
      replays = _graph_replays(batcher)
      for k in served:
        served[k] += counted[k] + tick_probe.step_launches[k] * replays
      log(f"  (e) 8-slot speculative batcher, order {label}: {wall:.2f} s, "
          f"{replays} replays of the captured verify step, which launched "
          f"{tick_probe.step_launches}")
      if tick_probe.step_launches["lru_scan_carries"] != n_recurrent:
        raise AssertionError("The batcher's verify step launched "
                             f"{tick_probe.step_launches}.")
      del batcher
  finally:
    tick_probe.close()
  same = {n: runs["A"][n] == runs["B"][n] for n in runs["A"]}
  log(f"  tokens identical between the join orders: {sum(same.values())} of "
      f"{len(same)}")
  if len(same) != BATCH_REQUESTS or not all(same.values()):
    raise AssertionError(f"Join orders disagree: "
                         f"{[n for n, v in same.items() if not v]}.")
  identical = 0
  for s in specs:
    sampler.prefill_chunk_size = s["chunk"]
    try:
      kw = {"prefix_state": prefix_state} if s["prefix"] else {}
      solo = sampler([s["prompt"]], BATCH_STEPS, return_logits=True, **kw)
    finally:
      sampler.prefill_chunk_size = None
    agree = token_agreement(f"batcher {s['name']}", runs["A"][s["name"]],
                            solo.tokens[0].tolist(), solo.logits[0], stops)
    identical += agree["identical"]
  log(f"  against solo plain Samplers: {identical} of {len(specs)} requests "
      f"identical, the rest first differ at a near tie")
  del runs, prefix_state

  # The speculative tick against the plain tick, 8 slots of 300-token
  # prompts, in turns: ms a step and emitted tokens/s.
  steady = {}
  for draft in (0, SPEC_DRAFT):
    steady[draft] = serving.ContinuousBatcher(
        sampler, num_slots=BATCH_SLOTS, max_steps_default=4096,
        draft_len=draft, ngram=SPEC_NGRAM)
    for _ in range(BATCH_SLOTS):
      steady[draft].add_request(" ".join(f"w{j}" for j in rng.integers(
          0, config.vocab_size - 4, 300)))
    steady[draft].step(BATCH_TICK)  # admits all eight, captures the tick
  ticks = {0: [], SPEC_DRAFT: []}
  for draft in (0, SPEC_DRAFT, SPEC_DRAFT, 0):
    b = steady[draft]
    emitted = b._state["write_idx"].sum().item()  # pylint: disable=protected-access
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    with torch.inference_mode():
      for _ in range(TICK_REPEATS):
        b._tick(BATCH_TICK)  # pylint: disable=protected-access
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    emitted = b._state["write_idx"].sum().item() - emitted  # pylint: disable=protected-access
    ticks[draft].append((ms / TICK_REPEATS / BATCH_TICK, emitted / ms * 1e3))
  med = {d: [float(np.median([t[i] for t in v])) for i in range(2)]
         for d, v in ticks.items()}
  log(f"  {BATCH_SLOTS}-slot captured tick in turns (plain, speculative, "
      f"speculative, plain), (ms a step, emitted tokens/s): plain "
      f"{[tuple(round(x, 3) for x in t) for t in ticks[0]]}, speculative "
      f"{[tuple(round(x, 3) for x in t) for t in ticks[SPEC_DRAFT]]}; "
      f"speculative / plain step {med[SPEC_DRAFT][0] / med[0][0]:.3f}, "
      f"tokens/s {med[SPEC_DRAFT][1] / med[0][1]:.3f}")
  del steady

  # multi-LoRA x speculation: a rank-8 model over the same base weights,
  # its own adapters zero, requests with seeded adapters or none.
  lmodel = griffin.Griffin(config, device="meta", dtype=torch.bfloat16,
                           lora_rank=SPEC_LORA_RANK)
  lmodel.to_empty(device=dev)
  gen = torch.Generator(dev).manual_seed(SEED + 95)
  lmodel.load_state_dict(sft_lora.merge_params(
      model.state_dict(), sft_lora.init_adapters(lmodel, gen)))
  own = {n: p.detach().clone() for n, p in lmodel.named_parameters()
         if sft_lora.is_lora_path(n)}

  def drawn():
    out = sft_lora.init_adapters(lmodel, gen)
    for n, v in out.items():
      if n.endswith("lora_b"):
        v.normal_(0.0, SPEC_LORA_B_STD, generator=gen)
    return out

  adapters = {"a": drawn(), "b": drawn(), "none": None}
  kinds = ("a", "b", "none", "a")
  lora_specs = _adapter_specs(config, SEED + 96, SPEC_LORA_SLOTS, kinds,
                              SPEC_LORA_TOKENS)
  lsampler = sampler_lib.Sampler(lmodel, vocab, device=dev)
  batcher = serving.ContinuousBatcher(
      lsampler, num_slots=SPEC_LORA_SLOTS, max_steps_default=SPEC_LORA_STEPS,
      multi_lora=True, draft_len=SPEC_DRAFT, ngram=SPEC_NGRAM)
  before = _spec_counts()
  got = _drive_batcher(batcher, lora_specs, lambda kind: adapters[kind])
  counted = {k: v - before[k] for k, v in _spec_counts().items()}
  for k in served:  # the admissions' launches; the ticks are captured
    served[k] += counted[k]
  del batcher
  identical = 0
  for s in lora_specs:
    with torch.no_grad():
      for n, p in lmodel.named_parameters():
        if sft_lora.is_lora_path(n):
          src = adapters[s["kind"]]
          p.copy_(own[n] if src is None else src[n])
    solo = lsampler([s["prompt"]], SPEC_LORA_STEPS, return_logits=True)
    agree = token_agreement(f"multi-LoRA {s['name']}", got[s["name"]],
                            solo.tokens[0].tolist(), solo.logits[0], stops)
    identical += agree["identical"]
  log(f"  multi-LoRA speculative batcher ({SPEC_LORA_SLOTS} slots, rank "
      f"{SPEC_LORA_RANK}, adapters {kinds}) against solo Samplers on the "
      f"merged weights: {identical} of {len(lora_specs)} identical, the rest "
      f"first differ at a near tie")
  del lmodel, lsampler, own, adapters
  torch.cuda.empty_cache()

  # The HTTP front end at 4 slots over a speculative batcher.
  http_rng = np.random.default_rng(SEED + 97)
  http_prompt = " ".join(f"w{i}" for i in http_rng.integers(
      0, config.vocab_size - 4, HTTP_PROMPT_TOKENS))
  kw = dict(num_slots=HTTP_SLOTS, max_steps_default=HTTP_STEPS,
            preserve_states=True, draft_len=SPEC_DRAFT, ngram=SPEC_NGRAM)
  direct = serving.ContinuousBatcher(sampler, **kw)
  direct.add_request(http_prompt)
  ((_, direct_tokens, _),) = direct.run_until_drained(BATCH_TICK)
  del direct
  frontend = server_lib.ServingFrontend(
      serving.ContinuousBatcher(sampler, reuse_programs=False, **kw),
      step_size=BATCH_TICK)
  srv = server_lib.ServingHTTPServer(frontend, host="127.0.0.1", port=0,
                                     model_name="recurrentgemma-2b")
  try:
    _, _, out = _http(srv.port, "/v1/generate", {"prompt": http_prompt})
    with _http(srv.port, "/v1/generate", {"prompt": http_prompt,
                                          "stream": True},
               stream=True) as resp:
      lines = [json.loads(line) for line in resp]
    _, _, cut = _http(srv.port, "/v1/generate",
                      {"prompt": http_prompt, "max_tokens": SPEC_HTTP_CUT})
    turns = [_http(srv.port, "/v1/generate",
                   {"prompt": text, "session": "s1"})[2]["tokens"]
             for text in (http_prompt, "w1 w2 w3")]
    _, _, health = _http(srv.port, "/v1/health")
  finally:
    srv.close()
  streamed = [t for line in lines for t in line.get("tokens", [])]
  widest = max(len(line.get("tokens", [])) for line in lines)
  log(f"  HTTP over a {HTTP_SLOTS}-slot speculative batcher: /v1/generate "
      f"identical to a direct batcher run {out['tokens'] == direct_tokens} "
      f"({len(direct_tokens)} tokens); streaming {len(lines)} lines, up to "
      f"{widest} tokens a line, equal {streamed == direct_tokens}; "
      f"max_tokens {SPEC_HTTP_CUT} gives the first {SPEC_HTTP_CUT} "
      f"{cut['tokens'] == direct_tokens[:SPEC_HTTP_CUT]}; a two-turn "
      f"session {[len(t) for t in turns]} tokens; health {health}")
  if (out["tokens"] != direct_tokens or streamed != direct_tokens
      or cut["tokens"] != direct_tokens[:SPEC_HTTP_CUT]
      or turns[0] != direct_tokens or not turns[1] or not health["ok"]
      or frontend._error is not None):  # pylint: disable=protected-access
    raise AssertionError("The front end over a speculative batcher "
                         "disagrees with the direct batcher.")

  carry_row["launches"] = served["lru_scan_carries"]
  for name, n in (("lru_scan", served["lru_scan"] - served["lru_scan_carries"]),
                  ("window_attention", served["window_attention"]),
                  ("int8_weight_matmul", served["int8_weight_matmul"]),
                  ("int8_weight_matmul_wgmma",
                   served["int8_weight_matmul_wgmma"]),
                  ("add_rmsnorm", served["add_rmsnorm"]),
                  ("mha_attention", served["mha_attention"])):
    by_name[name]["launches"] += n
  log(f"  launches of phase 21's runs {served} (added to their rows)")
  log(f"  phase 21 took {time.perf_counter() - phase_start:.1f} s")


# -- phase 22: grammar-constrained decoding ------------------------------------

CONSTRAIN_CHOICES = ("positive", "negative", "neutral")
CONSTRAIN_SCHEMA = {
    "type": "object",
    "properties": {
        "label": {"enum": list(CONSTRAIN_CHOICES)},
        "score": {"type": "integer"},
        "ok": {"type": "boolean"},
        "tags": {"type": "array", "items": {"enum": ["red", "green", "blue"]},
                 "maxItems": 2},
    },
    "required": ["label", "score", "ok", "tags"],
}
# The grammar registered while the batcher runs, and the forced tool call's
# parameters.
CONSTRAIN_DYNAMIC_SCHEMA = {
    "type": "object",
    "properties": {"city": {"enum": ["Paris", "Oslo", "Lima"]},
                   "days": {"type": "integer"}},
    "required": ["city", "days"],
}
CONSTRAIN_TOOLS = [
    {"type": "function", "function": {"name": "get_weather",
                                      "parameters": CONSTRAIN_DYNAMIC_SCHEMA}},
    {"type": "function", "function": {"name": "get_time"}},
]
# Multi-character pieces of JSON text (beside every printable ASCII
# character and the digit runs 10-999) in the synthetic vocabulary.
CONSTRAIN_JSON_PIECES = (
    '{"', '":', '",', '"}', '":"', '":[', '":{', '],', '},', '[{', '}]',
    '"]', '["', 'true', 'false', 'null', ', ', ': ', '{ "', '" }', '\\"',
    '\\n', '"label":"', '"score":', '"ok":', '"tags":[', '"name":"',
    '"arguments":', '"city":"', '"days":')
CONSTRAIN_PROMPT_TOKENS = 3000
CONSTRAIN_MM_TOKENS = 200
CONSTRAIN_TICK_TOKENS = 300
CONSTRAIN_STEPS = 32
# Decode steps a kernel count covers (a verify count covers a whole run:
# each call's copies into the graph divide over its steps).
CONSTRAIN_PROFILE_STEPS = 8
CONSTRAIN_PAIRS = 4096
CONSTRAIN_ROWS = 16
CONSTRAIN_MASK_CHUNK = 256
CONSTRAIN_TURNS = ("plain", "constrained", "constrained", "plain")
CONSTRAIN_CAPTURE_TURNS = ("captured", "eager", "eager", "captured")
CONSTRAIN_BATCH_KINDS = ("choice", "json", "free", "schema", "free", "json",
                         "free", "dynamic")
CONSTRAIN_HTTP_STEPS = 48


class PieceVocab:
  """A synthetic SentencePiece-style vocabulary of ``size`` pieces made from
  a seed: pad, bos, eos, unk (control pieces), the printable ASCII
  characters one piece each, multi-character JSON pieces and the digit runs
  10-999, and the rest words of 2-16 lowercase letters, half of them with
  SentencePiece's leading word marker, so that a JSON string state allows
  most of the vocabulary, as a real one does. ``EncodeAsIds`` splits text
  before each space and looks each word up (characters one by one when it is
  not a piece), so a prompt made of marked words encodes to those words."""

  def __init__(self, size: int, seed: int):
    rng = np.random.default_rng(seed)
    pieces = ["<pad>", "<bos>", "<eos>", "<unk>"]
    pieces += [chr(c) for c in range(0x20, 0x7F)]
    for p in CONSTRAIN_JSON_PIECES + tuple(str(i) for i in range(10, 1000)):
      if p not in pieces:
        pieces.append(p)
    seen, words = set(pieces), []
    while len(pieces) + len(words) < size:
      m = 2 * (size - len(pieces) - len(words))
      lengths = rng.integers(2, 17, m)
      codes = rng.integers(ord("a"), ord("z") + 1, (m, 16)).astype(np.uint8)
      codes[np.arange(16)[None] >= lengths[:, None]] = 0
      drawn = codes.view("S16").ravel().astype("U16")
      drawn = np.where(rng.random(m) < 0.5, np.char.add("▁", drawn), drawn)
      for w in drawn.tolist():
        if w not in seen:
          seen.add(w)
          words.append(w)
    self.pieces = pieces + words[:size - len(pieces)]
    self._ids = {p: i for i, p in enumerate(self.pieces)}
    self.marked_words = np.array([i for i, p in enumerate(self.pieces)
                                  if p.startswith("▁")])

  def pad_id(self) -> int:
    return 0

  def bos_id(self) -> int:
    return 1

  def eos_id(self) -> int:
    return 2

  def GetPieceSize(self) -> int:  # noqa: N802
    return len(self.pieces)

  def IdToPiece(self, i: int) -> str:  # noqa: N802
    return self.pieces[i]

  def IsControl(self, i: int) -> bool:  # noqa: N802
    return i < 4

  def EncodeAsIds(self, text: str) -> list[int]:  # noqa: N802
    ids = []
    for word in re.split("(?= )", text):
      piece = word.replace(" ", "▁")
      if piece in self._ids:
        ids.append(self._ids[piece])
      elif word:
        ids.extend(self._ids.get(ch, 3) for ch in word)
    return ids

  def DecodeIds(self, ids) -> str:  # noqa: N802
    return "".join(self.pieces[i] for i in ids if i >= 4).replace("▁", " ")

  def prompt(self, rng, n: int) -> str:
    """``n`` marked words drawn by ``rng``, as text."""
    return self.DecodeIds(rng.choice(self.marked_words, n).tolist())


def _generated(vocab, tokens, stops) -> tuple[str, bool]:
  """The text of a row's tokens before its first stop, and whether one came."""
  ids = []
  for t in (int(t) for t in tokens):
    if t in stops:
      return vocab.DecodeIds(ids), True
    ids.append(t)
  return vocab.DecodeIds(ids), False


def _check_grammar(label: str, dfa, vocab, tokens, stops,
                   must_stop=False) -> tuple[str, bool]:
  """A row's output is a live prefix of the grammar; a stopped one matches
  it whole."""
  text, stopped = _generated(vocab, tokens, stops)
  ok = dfa.allows_text(text) if stopped else dfa.is_live_prefix(text)
  if not ok or (must_stop and not stopped):
    raise AssertionError(f"{label}: {text!r} (stopped {stopped}) is not in "
                         f"the grammar.")
  return text, stopped


def _host_row(dfa, state: int) -> np.ndarray:
  """The host's allowed bits of one state, unpacked to [vocab] bool."""
  row = np.ascontiguousarray(dfa._allowed_bits[state]).view(np.uint8)  # pylint: disable=protected-access
  return np.unpackbits(row, bitorder="little")[:dfa.vocab_size].astype(bool)


def check_constraint_tables(name: str, dfa, dev, rng) -> dict:
  """The device tables' mask and advance against the host mirrors
  (``token_allowed`` / ``token_advance``) on CONSTRAIN_PAIRS seeded (state,
  token) pairs, half of them drawn among the tokens CONSTRAIN_ROWS seeded
  states allow, and those states' whole rows against the host's bits."""
  tables = dfa.tables(device=dev)
  vocab_size, n_states = dfa.vocab_size, dfa.n_states
  rows = rng.choice(n_states, min(CONSTRAIN_ROWS, n_states), replace=False)
  host_rows = {int(s): _host_row(dfa, int(s)) for s in rows}
  half = CONSTRAIN_PAIRS // 2
  states = rng.integers(0, n_states, CONSTRAIN_PAIRS)
  tokens = rng.integers(0, vocab_size, CONSTRAIN_PAIRS)
  for i in range(half):
    s = int(rows[i % len(rows)])
    allowed = np.flatnonzero(host_rows[s])
    states[i], tokens[i] = s, allowed[rng.integers(0, len(allowed))]
  st = torch.as_tensor(states, dtype=torch.int32, device=dev)
  tok = torch.as_tensor(tokens, dtype=torch.int32, device=dev)
  allowed_dev = []
  for i in range(0, CONSTRAIN_PAIRS, CONSTRAIN_MASK_CHUNK):
    s = st[i:i + CONSTRAIN_MASK_CHUNK]
    masked = tables.mask(s, torch.zeros(len(s), vocab_size, device=dev))
    allowed_dev.append(masked.gather(1, tok[i:i + len(s), None].long())[:, 0]
                       .isfinite())
  allowed_dev = torch.cat(allowed_dev).cpu().numpy()
  advanced = tables.advance(st, tok).cpu().numpy()
  want_allowed = np.array([dfa.token_allowed(int(s), int(t))
                           for s, t in zip(states, tokens)])
  want_adv = np.array([dfa.token_advance(int(s), int(t))
                       for s, t in zip(states, tokens)])
  rows_t = torch.as_tensor(rows, dtype=torch.int32, device=dev)
  full = tables.mask(rows_t, torch.zeros(len(rows), vocab_size, device=dev))
  full = full.isfinite().cpu().numpy()
  rows_same = all(np.array_equal(full[i], host_rows[int(s)])
                  for i, s in enumerate(rows))
  bad_mask = int((allowed_dev != want_allowed).sum())
  bad_adv = int((advanced != want_adv).sum())
  log(f"  {name}: {CONSTRAIN_PAIRS} (state, token) pairs ({int(want_allowed.sum())}"
      f" allowed): mask disagreements {bad_mask}, advance disagreements "
      f"{bad_adv}; {len(rows)} whole rows equal to the host's bits "
      f"{rows_same}")
  if bad_mask or bad_adv or not rows_same:
    raise AssertionError(f"{name}: the device tables disagree with the host "
                         "mirrors.")
  return dict(pairs=CONSTRAIN_PAIRS, allowed=int(want_allowed.sum()))


def _first_masked_gap(dfa, tokens, logits, first: int) -> float:
  """The gap of the two largest grammar-allowed logits at ``first`` (the
  DFA state walked on the host over ``tokens[:first]``), relative to the
  larger's magnitude."""
  state = dfa.char_dfa.start
  for t in tokens[:first]:
    state = dfa.token_advance(state, int(t))
  row = logits[first].float().cpu().numpy()
  allowed = row[_host_row(dfa, state)]
  top = np.sort(allowed)[-2:] if len(allowed) > 1 else np.array([0.0, 1.0])
  return float((top[1] - top[0]) / abs(top[1]))


def constrained_agreement(label, got, want, logits, dfa, stops) -> dict:
  """Constrained speculative ``got`` against constrained plain ``want``:
  identical, or the first difference where the plain run's two largest
  allowed logits lie within SPEC_TIE_REL of the larger's magnitude."""
  got, want = _trim_at_stop(got, stops), _trim_at_stop(want, stops)
  n = min(len(got), len(want))
  first = next((i for i in range(n) if got[i] != want[i]),
               None if len(got) == len(want) else n)
  if first is None:
    return dict(identical=True, tokens=n)
  gap = _first_masked_gap(dfa, want, logits, first)
  log(f"    {label}: first difference at token {first} of {n}; the two "
      f"largest allowed logits there {gap:.3e} apart (rule: within "
      f"{SPEC_TIE_REL})")
  if gap > SPEC_TIE_REL:
    raise AssertionError(f"{label}: constrained speculative and plain tokens "
                         f"differ at {first} outside a near tie.")
  return dict(identical=False, tokens=n, first=first, gap=gap)


def _step_kernels(long_call, short_call, steps: int) -> tuple[float, float]:
  """(kernels a step, busy ms a step): the profiler's difference between a
  call and a shorter one, over the steps between them. Each call runs once
  before its trace, so a graph it captures is not in the trace."""
  long_call()
  short_call()
  long_k, short_k = kernel_times(long_call), kernel_times(short_call)
  count = (sum(n for _, n in long_k.values())
           - sum(n for _, n in short_k.values()))
  busy = (sum(ms for ms, _ in long_k.values())
          - sum(ms for ms, _ in short_k.values()))
  return count / steps, busy / steps


def _sse_data(port: int, path: str, body: dict) -> list[dict]:
  with _http(port, path, body, stream=True) as resp:
    events = []
    for line in resp:
      line = line.decode().strip()
      if line.startswith("data: ") and line != "data: [DONE]":
        events.append(json.loads(line[len("data: "):]))
  return events


def _constrained_http(port: int, grammars: dict, prompt: str) -> dict:
  """JSON mode, a JSON schema, a forced tool call and its stream over HTTP;
  raises where an answer leaves its grammar."""
  def chat(content, **kw):
    return _http(port, "/v1/chat/completions", dict(
        messages=[{"role": "user", "content": content}],
        max_tokens=CONSTRAIN_HTTP_STEPS, **kw))[2]["choices"][0]

  results = {}
  out = _http(port, "/v1/completions", {
      "prompt": prompt, "max_tokens": CONSTRAIN_HTTP_STEPS,
      "response_format": {"type": "json_object"}})[2]["choices"][0]
  text, finish = out["text"], out["finish_reason"]
  if not (grammars["json"].allows_text(text) if finish == "stop"
          else grammars["json"].is_live_prefix(text)):
    raise AssertionError(f"json_object answered {text!r} ({finish}).")
  if finish == "stop":
    json.loads(text)
  results["json_object"] = (finish, len(text))
  out = chat(prompt, response_format={"type": "json_schema", "json_schema": {
      "name": "row", "schema": CONSTRAIN_SCHEMA}})
  text, finish = out["message"]["content"], out["finish_reason"]
  if not (grammars["schema"].allows_text(text) if finish == "stop"
          else grammars["schema"].is_live_prefix(text)):
    raise AssertionError(f"json_schema answered {text!r} ({finish}).")
  if finish == "stop":
    doc = json.loads(text)
    if doc["label"] not in CONSTRAIN_CHOICES:
      raise AssertionError(f"json_schema answered {doc}.")
  results["json_schema"] = (finish, len(text))
  out = chat(prompt, tools=CONSTRAIN_TOOLS, tool_choice="required")
  if out["finish_reason"] == "tool_calls":
    (call,) = out["message"]["tool_calls"]
    args = json.loads(call["function"]["arguments"])
    if not ((call["function"]["name"] == "get_time" and args == {})
            or (call["function"]["name"] == "get_weather"
                and args["city"] in ("Paris", "Oslo", "Lima")
                and isinstance(args["days"], int))):
      raise AssertionError(f"The forced tool call was {call}.")
    results["tool_choice required"] = (call["function"]["name"], args)
  elif not out["message"]["content"].startswith('{"name":"'):
    raise AssertionError(f"The forced tool call answered {out}.")
  else:
    results["tool_choice required"] = ("length", out["message"]["content"])
  events = _sse_data(port, "/v1/chat/completions", dict(
      messages=[{"role": "user", "content": prompt}],
      max_tokens=CONSTRAIN_HTTP_STEPS, stream=True, tools=CONSTRAIN_TOOLS,
      tool_choice={"type": "function", "function": {"name": "get_weather"}}))
  finish = events[-1]["choices"][0]["finish_reason"]
  calls = [tc for e in events
           for tc in e["choices"][0]["delta"].get("tool_calls", [])]
  headers = [tc for tc in calls if "id" in tc]
  if finish == "tool_calls":
    args = json.loads("".join(tc["function"].get("arguments", "")
                              for tc in calls))
    if (len(headers) != 1 or headers[0]["function"]["name"] != "get_weather"
        or args["city"] not in ("Paris", "Oslo", "Lima")
        or not isinstance(args["days"], int)):
      raise AssertionError(f"The streamed tool call was {calls}.")
    results["stream"] = (len(events), args)
  elif finish != "length" or len(headers) > 1:
    raise AssertionError(f"The streamed tool call ended {finish}: {calls}.")
  else:
    results["stream"] = (len(events), "length")
  return results


def phase_constrained(dev, kernels: list[dict], handoff: dict) -> None:
  """Grammar-constrained decoding end to end on phase 18's realistic_params
  2B, its int8 copy and its towers, over a synthetic 256000-piece
  vocabulary: three grammars compiled by the native walker, the device
  tables against the host mirrors, the constrained Sampler (bf16, int8,
  captured against eager), the ModalSampler, SpeculativeSampler, the 8-slot
  batcher with static and dynamic grammars (plain and speculative) and the
  HTTP front end; the constrained decode step, verify step and tick timed
  against the plain ones in turns."""
  phase_start = time.perf_counter()
  model, qmodel, encoder = (handoff[k] for k in ("model", "qmodel",
                                                 "encoder"))
  config = model.config
  by_name = {kernel["name"]: kernel for kernel in kernels}
  n_recurrent = sum(bt is common.TemporalBlockType.RECURRENT
                    for bt in config.block_types)
  rng = np.random.default_rng(SEED + 100)
  start = time.perf_counter()
  vocab = PieceVocab(config.vocab_size, SEED + 100)
  strings = constrain.token_strings_from_vocab(vocab, config.vocab_size)
  stops = {vocab.eos_id()}
  log(f"== grammar-constrained decoding on phase 18's models over a seeded "
      f"{config.vocab_size}-piece vocabulary (built in "
      f"{time.perf_counter() - start:.2f} s; the native walker "
      f"{'available' if constrain_cpp.available() else 'MISSING'})")
  if not constrain_cpp.available():
    raise RuntimeError("native/libconstrain.so did not build (make, g++).")

  # (a) Three grammars, each compiled with the native walker.
  patterns = {"choice": constrain.choice_regex(CONSTRAIN_CHOICES),
              "json": constrain.json_regex(),
              "schema": constrain.schema_regex(CONSTRAIN_SCHEMA),
              "dynamic": constrain.schema_regex(CONSTRAIN_DYNAMIC_SCHEMA)}
  grammars, compiled = {}, {}
  for name, pattern in patterns.items():
    start = time.perf_counter()
    grammars[name] = constrain.TokenDFA(pattern, strings,
                                        eos_id=vocab.eos_id(),
                                        _use_native=True)
    dfa = grammars[name]
    compiled[name] = dict(
        seconds=round(time.perf_counter() - start, 3), states=dfa.n_states,
        atoms=int(dfa.char_dfa.trans.shape[1]),
        unique_rows=dfa.n_unique_tokens, token_len=int(
            dfa._token_atoms.shape[1]),  # pylint: disable=protected-access
        table_mb=round(sum(t.numel() * t.element_size() for t in
                           dfa.tables(device=dev).tensors()) / 1e6, 3))
  log(f"  compiled (host seconds, states, atoms, unique token rows, longest "
      f"token in atoms, device table MB): {compiled}")

  # (b) The device tables against the host mirrors.
  for name in ("choice", "json", "schema"):
    check_constraint_tables(name, grammars[name], dev, rng)

  served = {k: 0 for k in _spec_counts()}
  dprobe, sprobe = DecodeProbe(_spec_counts), SpecProbe(_spec_counts)
  tick_probe = TickProbe(_spec_counts)

  def tally(fn):
    dprobe.reset()
    sprobe.reset()
    before = _spec_counts()
    result = fn()
    torch.cuda.synchronize()
    for k, v in _spec_counts().items():
      served[k] += v - before[k]
      for probe in (dprobe, sprobe):
        if probe.replays:
          served[k] += probe.step_launches[k] * probe.replays
    return result

  prompts = [vocab.prompt(rng, CONSTRAIN_PROMPT_TOKENS - 1) for _ in range(2)]
  try:
    # (c) The constrained Sampler, bf16 and int8: each grammar captured;
    # greedy and categorical captured against eager in turns on JSON.
    samplers = {}
    for side, m, kw in (("bf16", model, {}),
                        ("int8", qmodel, dict(prefill_act_quant=True))):
      s = samplers[side] = sampler_lib.Sampler(m, vocab, device=dev, **kw)
      texts = {}
      for name in ("choice", "json", "schema"):
        out = tally(lambda: s(prompts, CONSTRAIN_STEPS,
                              constraint=grammars[name]))
        texts[name] = [_check_grammar(f"{side} {name} row {r}",
                                      grammars[name], vocab, t.tolist(),
                                      stops, must_stop=name == "choice")
                       for r, t in enumerate(out.tokens)]
        step = dprobe.step_launches
        if side == "int8" and step["int8_weight_matmul"] != _weight_only_launches(qmodel):
          raise AssertionError(f"An int8 constrained step launched {step}.")
      log(f"  {side} constrained Sampler, 2 x {CONSTRAIN_PROMPT_TOKENS} "
          f"tokens, {CONSTRAIN_STEPS} steps: "
          f"{ {n: [(t[:48], st) for t, st in v] for n, v in texts.items()} }")
      same = {}
      for mode, skw in (("greedy", {}),
                        ("categorical", dict(deterministic_sampling=False,
                                             **CATEGORICAL))):
        runs = []
        by_turn = {turn: sampler_lib.Sampler(
            m, vocab, device=dev, jit_compile=turn == "captured", **kw, **skw)
                   for turn in set(CONSTRAIN_CAPTURE_TURNS)}
        for turn in CONSTRAIN_CAPTURE_TURNS:
          t_s = by_turn[turn]
          gen = (torch.Generator(dev).manual_seed(SEED + 101)
                 if mode == "categorical" else None)
          out = tally(lambda: t_s(prompts, CONSTRAIN_STEPS, generator=gen,
                                  constraint=grammars["json"]))
          for r, t in enumerate(out.tokens):
            _check_grammar(f"{side} {mode} {turn} row {r}", grammars["json"],
                           vocab, t.tolist(), stops)
          runs.append(([t.tolist() for t in out.tokens],
                       None if gen is None else gen.get_state()))
        same[mode] = all(r[0] == runs[0][0] for r in runs) and (
            mode == "greedy"
            or all(torch.equal(r[1], runs[0][1]) for r in runs))
      log(f"  {side} JSON-constrained decode, captured and eager in turns "
          f"{CONSTRAIN_CAPTURE_TURNS}: tokens (and generators) identical "
          f"{same}")
      if not all(same.values()):
        raise AssertionError(f"{side}: captured and eager constrained decode "
                             "disagree.")

    # (d) The captured constrained decode step against the plain one, in
    # turns (bf16, JSON), and kernels a step.
    s = samplers["bf16"]
    step_ms = {"plain": [], "constrained": []}
    for turn in ("plain", "constrained"):  # captures both steps first
      s(prompts, CONSTRAIN_STEPS, end_sampling_at_eos_token=False,
        constraint=grammars["json"] if turn == "constrained" else None)
    for turn in CONSTRAIN_TURNS:
      c = grammars["json"] if turn == "constrained" else None
      tally(lambda: s(prompts, CONSTRAIN_STEPS, constraint=c,
                      end_sampling_at_eos_token=False))
      step_ms[turn].append(dprobe.decode_ms())
    step_kernels = {}
    for turn in ("plain", "constrained"):
      c = grammars["json"] if turn == "constrained" else None
      step_kernels[turn] = _step_kernels(
          lambda: s(prompts, 1 + CONSTRAIN_PROFILE_STEPS, constraint=c,
                    end_sampling_at_eos_token=False),
          lambda: s(prompts, 1, constraint=c), CONSTRAIN_PROFILE_STEPS)
    med = {k: float(np.median(v)) for k, v in step_ms.items()}
    log(f"  captured decode step in turns {CONSTRAIN_TURNS} (ms a step): "
        f"plain {[round(x, 4) for x in step_ms['plain']]}, JSON-constrained "
        f"{[round(x, 4) for x in step_ms['constrained']]}; constrained / plain "
        f"{med['constrained'] / med['plain']:.4f}, mask-and-advance share "
        f"{1 - med['plain'] / med['constrained']:.4f}; (kernels, busy ms) a "
        f"step {step_kernels}")

    # (e) The constrained ModalSampler: one image through the towers and
    # the fused-epilogue 2B, the choice grammar.
    fused = griffin._share_parameters(model)  # pylint: disable=protected-access
    for block in fused.blocks:
      block.fused_epilogue = True
    modal = modal_sampler.ModalSampler(fused, vocab, encoder, device=dev)
    pixels = torch.rand((1, *MM_PIXELS[1:]), device=dev,
                        generator=torch.Generator(dev).manual_seed(SEED + 102))
    mm_prompt = [vocab.prompt(rng, CONSTRAIN_MM_TOKENS - 1)]
    before = _spec_counts()
    out = tally(lambda: modal(mm_prompt, CONSTRAIN_STEPS, pixels=pixels,
                              constraint=grammars["choice"]))
    mm_counts = {k: v - before[k] for k, v in _spec_counts().items()}
    text, _ = _check_grammar("image", grammars["choice"], vocab,
                             out.tokens[0].tolist(), stops, must_stop=True)
    log(f"  the constrained ModalSampler ({list(pixels.shape)} pixels, "
        f"{CONSTRAIN_MM_TOKENS} tokens): {text!r}; the encode and prefill "
        f"launched {mm_counts}, a decode step {dprobe.step_launches}")
    n_towers = len(encoder.dino.blocks) + len(encoder.siglip.blocks)
    if (mm_counts["mha_attention"] != n_towers
        or dprobe.step_launches["add_rmsnorm"] != config.num_layers):
      raise AssertionError("The constrained image run launched "
                           f"{mm_counts}, a step {dprobe.step_launches}.")
    del modal, fused

    # (f) SpeculativeSampler with a grammar: greedy equals constrained plain
    # greedy (near ties aside); the constrained verify against the plain.
    spec = speculative.SpeculativeSampler(s, SPEC_DRAFT, SPEC_NGRAM)
    for name in ("json", "choice"):
      got = tally(lambda: spec(prompts, CONSTRAIN_STEPS,
                               constraint=grammars[name]))
      if sprobe.step_launches["lru_scan_carries"] != n_recurrent:
        raise AssertionError(f"A constrained verify step launched "
                             f"{sprobe.step_launches}.")
      want = s(prompts, CONSTRAIN_STEPS, constraint=grammars[name],
               return_logits=True)
      for r in range(len(prompts)):
        _check_grammar(f"speculative {name} row {r}", grammars[name], vocab,
                       got.tokens[r].tolist(), stops,
                       must_stop=name == "choice")
        agree = constrained_agreement(
            f"speculative {name} row {r}", got.tokens[r].tolist(),
            want.tokens[r].tolist(), want.logits[r], grammars[name], stops)
        log(f"  constrained SpeculativeSampler ({name}) row {r} against "
            f"constrained plain greedy: {agree}; {spec.last_stats}")
    verify_ms = {"plain": [], "constrained": []}
    spec(prompts, CONSTRAIN_STEPS)  # captures the plain verify step first
    for turn in CONSTRAIN_TURNS:
      c = grammars["json"] if turn == "constrained" else None
      tally(lambda: spec(prompts, CONSTRAIN_STEPS, constraint=c))
      verify_ms[turn].append(sprobe.verify_ms())
    verify_kernels = {}
    for turn in ("plain", "constrained"):
      c = grammars["json"] if turn == "constrained" else None
      spec(prompts, CONSTRAIN_STEPS, constraint=c)
      steps = spec.last_stats["verify_steps"]
      verify_kernels[turn] = _step_kernels(
          lambda: spec(prompts, CONSTRAIN_STEPS, constraint=c),
          lambda: spec(prompts, 1, constraint=c), steps)
    vmed = {k: float(np.median(v)) for k, v in verify_ms.items()}
    log(f"  captured verify step (draft_len {SPEC_DRAFT}) in turns "
        f"{CONSTRAIN_TURNS} (ms a step): plain "
        f"{[round(x, 4) for x in verify_ms['plain']]}, JSON-constrained "
        f"{[round(x, 4) for x in verify_ms['constrained']]}; constrained / "
        f"plain {vmed['constrained'] / vmed['plain']:.4f}; (kernels, busy ms) "
        f"a verify step {verify_kernels}")
    del spec
  finally:
    dprobe.close()
    sprobe.close()
  handoff.pop("encoder")
  del encoder
  torch.cuda.empty_cache()

  # (g) The 8-slot batcher: static grammars, free slots and a grammar
  # registered while it runs, plain and speculative; the free slots' tokens
  # equal an unconstrained batcher's.
  s = samplers["bf16"]
  lengths = rng.integers(*BATCH_PROMPT_RANGE, size=len(CONSTRAIN_BATCH_KINDS))
  batch_prompts = [vocab.prompt(rng, int(n) - 1) for n in lengths]
  static = ("choice", "json", "schema")
  try:
    runs = {}
    for draft in (0, SPEC_DRAFT):
      for constrained in (True, False):
        kw = dict(num_slots=BATCH_SLOTS, max_steps_default=CONSTRAIN_STEPS,
                  draft_len=draft, ngram=SPEC_NGRAM)
        if constrained:
          kw.update(constraints=[grammars[n] for n in static],
                    dynamic_grammar_slots=1)
        b = serving.ContinuousBatcher(s, **kw)
        tick_probe.watch(b)
        before = _spec_counts()
        names = {}
        for i, (kind, p) in enumerate(zip(CONSTRAIN_BATCH_KINDS,
                                          batch_prompts)):
          if kind == "dynamic":
            b.step(BATCH_TICK)  # the others decode; then the new grammar
          c = None
          if constrained and kind in static:
            c = static.index(kind)
          elif constrained and kind == "dynamic":
            c = grammars["dynamic"]
          names[b.add_request(p, constraint=c)] = i
        got = {names[r]: t for r, t, _ in b.run_until_drained(BATCH_TICK)}
        torch.cuda.synchronize()
        replays = _graph_replays(b)
        for k, v in _spec_counts().items():
          served[k] += v - before[k] + tick_probe.step_launches[k] * replays
        runs[(draft, constrained)] = got
        if constrained:
          for i, kind in enumerate(CONSTRAIN_BATCH_KINDS):
            if kind != "free":
              _check_grammar(f"batcher draft {draft} slot {i} ({kind})",
                             grammars[kind], vocab, got[i], stops,
                             must_stop=kind == "choice")
          registered = dict(b._dynamic_by_key)  # pylint: disable=protected-access
          if len(registered) != 1:
            raise AssertionError(f"Dynamic grammars {registered}.")
        log(f"  8-slot batcher, draft_len {draft}, "
            f"{'grammars' if constrained else 'no grammars'}: {replays} "
            f"replays of the captured step, which launched "
            f"{tick_probe.step_launches}")
        del b
      free_same = [runs[(draft, True)][i] == runs[(draft, False)][i]
                   for i, k in enumerate(CONSTRAIN_BATCH_KINDS)
                   if k == "free"]
      texts = [_generated(vocab, runs[(draft, True)][i], stops)
               for i in range(len(CONSTRAIN_BATCH_KINDS))]
      log(f"  draft_len {draft}: constrained slots "
          f"{[(k, t[:40], st) for k, (t, st) in zip(CONSTRAIN_BATCH_KINDS, texts) if k != 'free']}"
          f"; free slots equal to the unconstrained batcher's {free_same}")
      if not all(free_same):
        raise AssertionError(f"draft_len {draft}: a free slot's tokens "
                             "changed beside the grammars.")

    # The constrained tick against the plain tick (every slot on the JSON
    # grammar), in turns.
    steady = {}
    for turn in ("plain", "constrained"):
      kw = {} if turn == "plain" else dict(constraints=[grammars["json"]])
      steady[turn] = serving.ContinuousBatcher(
          s, num_slots=BATCH_SLOTS, max_steps_default=4096, **kw)
      for _ in range(BATCH_SLOTS):
        steady[turn].add_request(
            vocab.prompt(rng, CONSTRAIN_TICK_TOKENS - 1),
            constraint=None if turn == "plain" else 0)
      steady[turn].step(BATCH_TICK)  # admits all eight, captures the tick
    tick_ms = {"plain": [], "constrained": []}
    for turn in CONSTRAIN_TURNS:
      start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
      start.record()
      with torch.inference_mode():
        for _ in range(TICK_REPEATS):
          steady[turn]._tick(BATCH_TICK)  # pylint: disable=protected-access
      end.record()
      end.synchronize()
      tick_ms[turn].append(start.elapsed_time(end) / TICK_REPEATS
                           / BATCH_TICK)
    tick_kernels = {}
    for turn, b in steady.items():
      with torch.inference_mode():
        times = kernel_times(lambda: b._tick(BATCH_TICK))  # pylint: disable=protected-access
      tick_kernels[turn] = (sum(n for _, n in times.values()) / BATCH_TICK,
                            sum(ms for ms, _ in times.values()) / BATCH_TICK)
    tmed = {k: float(np.median(v)) for k, v in tick_ms.items()}
    log(f"  {BATCH_SLOTS}-slot captured tick in turns {CONSTRAIN_TURNS} (ms a "
        f"step): plain {[round(x, 4) for x in tick_ms['plain']]}, "
        f"JSON-constrained {[round(x, 4) for x in tick_ms['constrained']]}; "
        f"constrained / plain {tmed['constrained'] / tmed['plain']:.4f}; "
        f"(kernels, busy ms) a step {tick_kernels}")
    del steady
  finally:
    tick_probe.close()

  # (h) HTTP: JSON mode, a JSON schema, a forced tool call and its stream.
  budget = (max(1024, grammars["json"].n_states), 96,
            int(grammars["json"]._token_atoms.shape[1]))  # pylint: disable=protected-access
  frontend = server_lib.ServingFrontend(
      serving.ContinuousBatcher(
          s, num_slots=HTTP_SLOTS, max_steps_default=CONSTRAIN_HTTP_STEPS,
          constraints=[grammars["json"]], dynamic_grammar_slots=2,
          dynamic_grammar_budget=budget),
      step_size=BATCH_TICK, constraint_names={"json_object": 0})
  srv = server_lib.ServingHTTPServer(frontend, host="127.0.0.1", port=0,
                                     model_name="recurrentgemma-2b")
  try:
    before = _spec_counts()
    http = _constrained_http(srv.port, grammars,
                             vocab.prompt(rng, HTTP_PROMPT_TOKENS))
    for k, v in _spec_counts().items():  # the admissions; ticks are captured
      served[k] += v - before[k]
  finally:
    srv.close()
  log(f"  HTTP over a {HTTP_SLOTS}-slot batcher with a JSON grammar and 2 "
      f"dynamic slots: {http}")
  if frontend._error is not None:  # pylint: disable=protected-access
    raise AssertionError(f"The front end died: {frontend._error}.")  # pylint: disable=protected-access

  by_name["lru_scan_carries"]["launches"] += served["lru_scan_carries"]
  for name, n in (("lru_scan", served["lru_scan"] - served["lru_scan_carries"]),
                  ("window_attention", served["window_attention"]),
                  ("int8_weight_matmul", served["int8_weight_matmul"]),
                  ("int8_weight_matmul_wgmma",
                   served["int8_weight_matmul_wgmma"]),
                  ("add_rmsnorm", served["add_rmsnorm"]),
                  ("mha_attention", served["mha_attention"])):
    by_name[name]["launches"] += n
  log(f"  launches of phase 22's runs {served} (added to their rows)")
  log(f"  phase 22 took {time.perf_counter() - phase_start:.1f} s")


# The fresh process of phase 23: loads serving artifacts and checkpoints
# written by checkpoint/io and runs each artifact's prefill and greedy decode
# chain, with no Griffin built (its constructor raises there). Prints one
# JSON line a run: the tokens and a digest of the prefill's logits.
_EXPORT_FRESH = r"""
import hashlib, json, sys, time
import torch
from cadence_gemma_tpu_torch.checkpoint import export as export_lib
from cadence_gemma_tpu_torch.checkpoint import io as checkpoint_io
from cadence_gemma_tpu_torch.models import griffin

def refuse(*args, **kwargs):
  raise AssertionError("the fresh process built a Griffin")

griffin.Griffin.__init__ = refuse
spec = json.loads(sys.argv[1])
data = torch.load(spec["inputs"], weights_only=True)
tokens, positions = data["tokens"].cuda(), data["positions"].cuda()
weights = {}
for name, artifact, path in spec["runs"]:
  start = time.perf_counter()
  if path not in weights:
    weights[path] = checkpoint_io.load_parameters(path, device="cuda")
  loaded = export_lib.load_serving_export(artifact)
  logits, cache = loaded.prefill(weights[path], tokens, positions)
  digest = hashlib.sha256(logits.float().cpu().numpy().tobytes()).hexdigest()
  tok = logits[:, -1].argmax(-1, keepdim=True).int()
  chain, pos = [tok], positions[:, -1:] + 1
  for step in range(spec["steps"] - 1):
    logits, cache = loaded.decode_step(weights[path], cache, tok, pos + step)
    tok = logits[:, -1].argmax(-1, keepdim=True).int()
    chain.append(tok)
  print(json.dumps({"name": name, "digest": digest,
                    "tokens": torch.cat(chain, 1).tolist(),
                    "seconds": time.perf_counter() - start}), flush=True)
"""


def _export_inputs(sampler, prompts, dev):
  """The bucket's int32 ids and positions as the Sampler pads a batch: left
  padding with the pad id at position -1, the real tokens' positions
  ending at each prompt's length - 1."""
  ids = [sampler.tokenize(p) for p in prompts]
  length = max(len(i) for i in ids)
  pad = sampler.vocab.pad_id()
  tokens = torch.tensor([[pad] * (length - len(i)) + i for i in ids],
                        dtype=torch.int32, device=dev)
  lengths = torch.tensor([len(i) for i in ids], device=dev)
  positions = (torch.arange(length, device=dev)[None] - length
               + lengths[:, None]).clamp(min=-1).to(torch.int32)
  return tokens, positions


def _greedy(logits) -> torch.Tensor:
  return logits[:, -1].argmax(-1, keepdim=True).int()


def _digest(logits: torch.Tensor) -> str:
  """The digest the fresh process prints of a prefill's logits."""
  return hashlib.sha256(logits.float().cpu().numpy().tobytes()).hexdigest()


def _loaded_chain(loaded, params, tokens, positions, steps: int):
  """Greedy tokens [b, steps] of a loaded prefill and ``steps - 1`` eager
  loaded decode steps, and the prefill's logits."""
  logits, cache = loaded.prefill(params, tokens, positions)
  first = logits
  tok = _greedy(logits)
  chain, pos = [tok], positions[:, -1:] + 1
  for step in range(steps - 1):
    logits, cache = loaded.decode_step(params, cache, tok, pos + step)
    tok = _greedy(logits)
    chain.append(tok)
  return torch.cat(chain, 1), first


class CapturedLoadedStep:
  """A loaded decode step captured in a CUDA graph, greedy: each replay
  feeds ``tok`` at ``pos``, writes the new cache over the static one, the
  argmax over ``tok`` and advances ``pos``. ``reset`` puts back the state
  after the prefill."""

  def __init__(self, loaded, params, cache, tok, pos):
    self.loaded, self.params = loaded, params
    self.initial = [t.clone() for t in
                    (*torch.utils._pytree.tree_leaves(cache), tok, pos)]  # pylint: disable=protected-access
    self.cache = torch.utils._pytree.tree_map(torch.clone, cache)  # pylint: disable=protected-access
    self.tok, self.pos = tok.clone(), pos.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
      self._step()
    torch.cuda.current_stream().wait_stream(stream)
    self.reset()
    self.graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(self.graph):
      self.logits = self._step()
    self.reset()

  def _state(self) -> list[torch.Tensor]:
    return [*torch.utils._pytree.tree_leaves(self.cache), self.tok, self.pos]  # pylint: disable=protected-access

  def _step(self):
    logits, cache = self.loaded.decode_step(self.params, self.cache, self.tok,
                                            self.pos)
    for static, new in zip(torch.utils._pytree.tree_leaves(self.cache),  # pylint: disable=protected-access
                           torch.utils._pytree.tree_leaves(cache)):  # pylint: disable=protected-access
      static.copy_(new)
    self.tok.copy_(_greedy(logits))
    self.pos.add_(1)
    return logits

  def reset(self) -> None:
    for static, initial in zip(self._state(), self.initial):
      static.copy_(initial)

  def chain(self, steps: int) -> torch.Tensor:
    """The greedy tokens of ``steps`` replays after the prefill's token."""
    self.reset()
    out = [self.tok.clone()]
    for _ in range(steps):
      self.graph.replay()
      out.append(self.tok.clone())
    return torch.cat(out, 1)

  def step_ms(self, steps: int) -> float:
    self.reset()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(steps):
      self.graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps


class FirstOpInputs(torch.utils._python_dispatch.TorchDispatchMode):  # pylint: disable=protected-access
  """Keeps the arguments of the first call of each of the port's operators
  under the mode, the int8 product's once a route (references: the
  operators do not write their inputs)."""

  def __init__(self):
    super().__init__()
    self.first = {}

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    name = func.name()
    if name.startswith(op_library.NAMESPACE + "::"):
      key = name.split("::")[1]
      if key == "int8_weight_matmul":
        key += (" (wgmma)" if int8_matmul.uses_wgmma(args[0].shape[1])
                else " (mma.sync)")
      self.first.setdefault(key, (func, args))
    return func(*args, **(kwargs or {}))

  def items(self):
    return self.first.items()


def _opcheck(label: str, op, args) -> None:
  """``torch.library.opcheck``'s schema and fake-tensor checks of a CUDA
  call: the fake implementation's outputs against the kernel's shapes,
  dtypes and strides, and no output aliasing an input."""
  result = torch.library.opcheck(op, args,
                                 test_utils=("test_schema", "test_faketensor"))
  if set(result.values()) != {"SUCCESS"}:
    raise AssertionError(f"opcheck {label}: {result}")


def _small_op_cases(dev):
  """The operators no loaded program calls, at small shapes on the card."""
  gen = torch.Generator(dev).manual_seed(SEED + 110)
  bf16 = lambda *shape: torch.randn(  # noqa: E731
      *shape, generator=gen, device=dev).bfloat16()
  decay = lambda *shape: torch.rand(  # noqa: E731
      *shape, generator=gen, device=dev).bfloat16()
  f32 = lambda *shape: torch.randn(*shape, generator=gen, device=dev)  # noqa: E731
  ops = getattr(torch.ops, op_library.NAMESPACE)
  b, t, d = 2, 64, 256
  cases = []
  for kind in ("", "complex_"):
    parts = 2 if kind else 1
    for walk in ("forward", "backward"):
      for product in ("", "_a_prod"):
        name = f"lru_scan_{kind}{walk}{product}"
        args = ([bf16(b, t, d) for _ in range(parts)]
                + [decay(b, t, d) for _ in range(parts)]
                + [f32(b, d) for _ in range(parts)] + [walk == "backward"])
        cases.append((name, getattr(ops, name).default, args))
  cases.append(("lru_scan_carries", ops.lru_scan_carries.default,
                [bf16(b, 8, 2560), decay(b, 8, 2560), f32(b, 2560)]))
  q, k, v = bf16(1, 128, 2, 256), bf16(1, 192, 1, 256), bf16(1, 192, 1, 256)
  seg = torch.arange(64, 192, device=dev, dtype=torch.int32)[None]
  out, lse = wa.window_attention_forward(q, k, v, seg, 96, 64)
  d_out = bf16(*q.shape)
  delta = wa.attention_delta(out, d_out)
  for name in ("window_attention_dq", "window_attention_dkv"):
    cases.append((name, getattr(ops, name).default,
                  [q, k, v, seg, lse, delta, d_out, 96, 64]))
  qw = torch.randint(-127, 128, (2, 256, 128), generator=gen, device=dev,
                     dtype=torch.int8)
  scale = torch.rand(2, 256, generator=gen, device=dev) * 1e-2
  for reduce in (False, True):
    cases.append((f"int8_weight_matmul_dgrad (reduce_batches={reduce})",
                  ops.int8_weight_matmul_dgrad.default,
                  [bf16(2, 64, 256), qw, scale, reduce]))
  return cases


def _host_us_turns(calls: dict) -> dict[str, list[float]]:
  """Host us a call of each side of ``calls`` ({label: fn}), in turns
  (first, second, second, first), ``HOST_CALLS`` calls a turn enqueued
  back to back after a warm-up; the card runs them after the clock
  stops."""
  (a, fa), (b, fb) = calls.items()
  times = {a: [], b: []}
  for fn in (fa, fb):
    fn()
  torch.cuda.synchronize()
  for label, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
    start = time.perf_counter()
    for _ in range(HOST_CALLS):
      fn()
    times[label].append((time.perf_counter() - start) / HOST_CALLS * 1e6)
    torch.cuda.synchronize()
  return times


def phase_export(dev, kernels: list[dict], handoff: dict,
                 profile: bool, root: str) -> None:
  """The serving export end to end on the first EXPORT_BLOCKS blocks of phase
  18's realistic_params 2B at full width (bf16, bf16 with the fused epilogue,
  its weight-only int8 copy) at phase 4's bucket: export, save and load; the
  loaded programs against the live forward, the Sampler's captured decode and
  a fresh process; their operator launches; the loaded prefill and decode step
  (eager and captured) against the live path in turns; opcheck of every
  operator on the card; host us a call through an operator against the direct
  launch. With ``profile`` the kernel time of a loaded and a live prefill
  against their times: the device's idle share."""
  phase_start = time.perf_counter()
  model, qmodel = (depth_cut(handoff[k], EXPORT_BLOCKS)
                   for k in ("model", "qmodel"))
  vocab, prompts = handoff["vocab"], handoff["prompts"]
  config = model.config
  by_name = {kernel["name"]: kernel for kernel in kernels}
  n_recurrent = sum(bt is common.TemporalBlockType.RECURRENT
                    for bt in config.block_types)
  n_attention = config.num_layers - n_recurrent
  int8_step = _weight_only_launches(qmodel)
  fused = griffin._share_parameters(model)  # pylint: disable=protected-access
  for block in fused.blocks:
    block.fused_epilogue = True
  params = {"bf16": dict(model.named_parameters()),
            "int8": dict(qmodel.named_parameters())}
  runs = {  # name: (model, parameters)
      "bf16": (model, "bf16"), "bf16 fused": (fused, "bf16"),
      "int8": (qmodel, "int8")}
  zero = {k: 0 for k in _spec_counts()}
  want = {  # name: (prefill launches, decode-step launches)
      "bf16": (dict(zero, lru_scan=n_recurrent,
                    window_attention=n_attention), zero),
      "bf16 fused": (dict(zero, lru_scan=n_recurrent,
                          window_attention=n_attention,
                          add_rmsnorm=config.num_layers),
                     dict(zero, add_rmsnorm=config.num_layers)),
      "int8": (dict(zero, lru_scan=n_recurrent, window_attention=n_attention,
                    int8_weight_matmul=1,
                    int8_weight_matmul_wgmma=int8_step - 1),
               dict(zero, int8_weight_matmul=int8_step)),
  }
  samplers = {name: sampler_lib.Sampler(m, vocab, device=dev)
              for name, (m, _) in runs.items()}
  tokens, positions = _export_inputs(samplers["bf16"], prompts, dev)
  if tuple(tokens.shape) != EXPORT_BUCKET:
    raise AssertionError(f"The prompts make {tuple(tokens.shape)}, not the "
                         f"bucket {EXPORT_BUCKET}.")
  log(f"== the serving export: the first {EXPORT_BLOCKS} blocks of phase "
      f"18's realistic_params 2B (bf16, bf16 with the fused epilogue, "
      f"weight-only int8) at the bucket "
      f"{EXPORT_BUCKET} (row 2 left-padded from {min(PROMPT_TOKENS)}); "
      f"torch {torch.__version__}")
  served = dict(zero)
  fresh_proc = None
  try:
    # (a) Export and save; the artifacts' bytes.
    loaded, paths = {}, {}
    for name, (m, side) in runs.items():
      start = time.perf_counter()
      exp = export_lib.export_serving(m, params[side], *EXPORT_BUCKET)
      seconds = time.perf_counter() - start
      paths[name] = os.path.join(root, name.replace(" ", "-"))
      export_lib.save_serving_export(exp, paths[name])
      size = sum(os.path.getsize(os.path.join(paths[name], f))
                 for f in os.listdir(paths[name]))
      weight_bytes = quantization.quantized_bytes(params[side])
      log(f"  {name}: exported in {seconds:.2f} s (host); artifact "
          f"{size} bytes (prefill {len(exp.prefill)}, decode step "
          f"{len(exp.decode_step)}), {size / weight_bytes:.2e} of the "
          f"{weight_bytes / 1e9:.3f} GB of weights; meta {exp.meta}")
      if size > EXPORT_MAX_WEIGHT_SHARE * weight_bytes:
        raise AssertionError(f"The {name} artifact holds {size} bytes: "
                             "weights, not graph.")

    # (b) A fresh process: the artifacts and checkpoint/io weights, no
    # Griffin. It runs beside (c)-(e) here, which time nothing; its tokens
    # and prefill digests are held against this process's before the
    # timed turns.
    start = time.perf_counter()
    weights = {}
    for side, m in (("bf16", model), ("int8", qmodel)):
      # Not bf16.pt: phase 24 writes the whole 2B's under that name.
      weights[side] = os.path.join(root, f"export-{side}.pt")
      checkpoint_io.save_parameters(weights[side], m.state_dict())
    inputs = os.path.join(root, "inputs.pt")
    torch.save({"tokens": tokens.cpu(), "positions": positions.cpu()}, inputs)
    write_s = time.perf_counter() - start
    spec = {"inputs": inputs, "steps": DECODE_STEPS,
            "runs": [[name, paths[name], weights[side]]
                     for name, (_, side) in runs.items()]}
    fresh_start = time.perf_counter()
    with open(os.path.join(root, "fresh.out"), "w") as out, open(
        os.path.join(root, "fresh.err"), "w") as err:
      fresh_proc = subprocess.Popen(
          [sys.executable, "-c", _EXPORT_FRESH, json.dumps(spec)],
          stdout=out, stderr=err, text=True,
          env=dict(os.environ, PYTHONPATH=os.path.dirname(
              os.path.abspath(__file__))))

    for name in runs:
      start = time.perf_counter()
      loaded[name] = export_lib.load_serving_export(paths[name])
      log(f"  {name}: loaded in {time.perf_counter() - start:.2f} s (host)")

    # (c) Load; each loaded prefill against the live forward, its launches
    # and those of one loaded decode step; the operators' first inputs.
    firsts = {}
    for name, (m, side) in runs.items():
      p = params[side]
      with torch.no_grad():
        want_logits, want_cache = m(tokens, positions, return_cache=True,
                                    last_logits_only=True)
      torch.cuda.synchronize()
      before = _spec_counts()
      logits, cache = loaded[name].prefill(p, tokens, positions)
      torch.cuda.synchronize()
      prefill_counts = {k: v - before[k] for k, v in _spec_counts().items()}
      before = _spec_counts()
      step_logits, _ = loaded[name].decode_step(
          p, cache, _greedy(logits), positions[:, -1:] + 1)
      torch.cuda.synchronize()
      step_counts = {k: v - before[k] for k, v in _spec_counts().items()}
      for k in served:
        served[k] += prefill_counts[k] + step_counts[k]
      log(f"  {name}: a loaded prefill launched {prefill_counts}, a loaded "
          f"decode step {step_counts}")
      if (prefill_counts, step_counts) != want[name]:
        raise AssertionError(f"{name}: want {want[name]}.")
      same = torch.equal(logits, want_logits)
      leaves = list(zip(torch.utils._pytree.tree_leaves(cache),  # pylint: disable=protected-access
                        torch.utils._pytree.tree_leaves(want_cache)))  # pylint: disable=protected-access
      same_cache = all(torch.equal(a, b) for a, b in leaves)
      rel = _rel_rms(logits, want_logits)
      cache_rel = max(_rel_rms(a, b) for a, b in leaves
                      if b.is_floating_point())
      log(f"    loaded prefill against the live forward: logits "
          f"{'bit for bit' if same else f'rel. RMS {rel:.3e}'}, cache "
          f"{'bit for bit' if same_cache else f'rel. RMS {cache_rel:.3e}'}; "
          f"decode step logits finite {bool(torch.isfinite(step_logits).all())}")
      counters_equal = all(torch.equal(a, b) for a, b in leaves
                           if not b.is_floating_point())
      if not (same or rel <= MODEL_LOGITS_REL_RMS) or not (
          same_cache or cache_rel <= MODEL_LOGITS_REL_RMS) or not (
              counters_equal):
        raise AssertionError(f"{name}: the loaded prefill disagrees with the "
                             "live forward.")
      mode = FirstOpInputs()
      with mode:
        out = loaded[name].prefill(p, tokens, positions)
        loaded[name].decode_step(p, out[1], _greedy(out[0]),
                                 positions[:, -1:] + 1)
      torch.cuda.synchronize()
      for op, (func, args) in mode.items():
        firsts.setdefault(op, (name, func, args))
      del mode, out, want_logits, want_cache, cache, logits

    # (d) opcheck of every operator on the card: the path's own first
    # inputs, then the rest at small shapes.
    for op, (name, func, args) in firsts.items():
      shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
      _opcheck(f"{op} ({name})", func, args)
      log(f"  opcheck {op} at the {name} path's first inputs {shapes}: "
          "schema and fake tensor pass")
    del firsts
    small = _small_op_cases(dev)
    for label, func, args in small:
      _opcheck(label, func, args)
    log(f"  opcheck of {len(small)} calls of the operators no loaded program "
        "launches, at small shapes: schema and fake tensor pass")
    del small

    # (e) The greedy tokens of each loaded chain (eager, and its step
    # captured) and of the fresh process against the Sampler's captured
    # decode; then the prefill and the decode step, eager and captured,
    # in turns with the live path.
    probe = DecodeProbe(_spec_counts)
    captured, reference = {}, {}
    try:
      for name, (m, side) in runs.items():
        p = params[side]
        samplers[name](prompts, total_generation_steps=DECODE_STEPS,
                       end_sampling_at_eos_token=False)  # captures its step
        out = samplers[name](prompts, total_generation_steps=DECODE_STEPS,
                             end_sampling_at_eos_token=False)
        want_tokens = torch.stack([t[:DECODE_STEPS] for t in out.tokens])
        got, first = _loaded_chain(loaded[name], p, tokens, positions,
                                   DECODE_STEPS)
        logits, cache = loaded[name].prefill(p, tokens, positions)
        captured[name] = CapturedLoadedStep(
            loaded[name], p, cache, _greedy(logits), positions[:, -1:] + 1)
        got_captured = captured[name].chain(DECODE_STEPS - 1)
        agree = (got.cpu() == want_tokens.cpu()).all().item()
        agree_captured = (got_captured.cpu() == want_tokens.cpu()).all().item()
        log(f"  {name}: greedy tokens of the loaded chain (eager steps) "
            f"{'identical to' if agree else 'DIFFER from'} the Sampler's "
            f"captured decode over {DECODE_STEPS} tokens, the loaded step "
            f"captured {'identical' if agree_captured else 'DIFFERENT'}")
        if not (agree and agree_captured):
          raise AssertionError(f"{name}: loaded {got.tolist()} / captured "
                               f"{got_captured.tolist()} against the "
                               f"Sampler's {want_tokens.tolist()}.")
        reference[name] = (want_tokens.cpu().tolist(), _digest(first))
        del logits, cache, first

      try:
        fresh_proc.wait(timeout=600)
      finally:
        if fresh_proc.poll() is None:
          fresh_proc.kill()
      fresh_s = time.perf_counter() - fresh_start
      with open(os.path.join(root, "fresh.out")) as out:
        lines = out.read().splitlines()
      if fresh_proc.returncode:
        with open(os.path.join(root, "fresh.err")) as err:
          raise AssertionError(f"The fresh process failed:\n"
                               f"{chr(10).join(lines)[-3000:]}\n"
                               f"{err.read()[-6000:]}")
      fresh = [json.loads(line) for line in lines if line.startswith("{")]
      each = ", ".join(f"{r['name']} {r['seconds']:.1f} s" for r in fresh)
      log(f"  a fresh python3 process (no Griffin built), run beside the "
          f"checks above: checkpoints written in {write_s:.1f} s, the "
          f"process {fresh_s:.1f} s ({each})")
      if [r["name"] for r in fresh] != list(runs):
        raise AssertionError(f"The fresh process ran {fresh}.")
      for r in fresh:
        want_tokens, digest = reference[r["name"]]
        log(f"    {r['name']}: greedy tokens "
            f"{'identical to' if r['tokens'] == want_tokens else 'DIFFER from'}"
            f" the Sampler's captured decode; prefill logits "
            f"{'bit for bit' if r['digest'] == digest else 'DIFFERENT'}")
        if r["tokens"] != want_tokens or r["digest"] != digest:
          raise AssertionError(f"The fresh process's {r['name']} run "
                               "disagrees.")

      for name, (m, side) in runs.items():
        if name == "bf16 fused":
          continue
        p = params[side]
        times = {figure: {"loaded": [], "live": []}
                 for figure in ("prefill", "prefill host enqueue",
                                "eager step", "captured step")}
        for loaded_turn in EXPORT_TURNS:
          key = "loaded" if loaded_turn else "live"
          # The prefill.
          start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
          start.record()
          host = time.perf_counter()
          if loaded_turn:
            logits, cache = loaded[name].prefill(p, tokens, positions)
          else:
            with torch.no_grad():
              logits, cache = m(tokens, positions, return_cache=True,
                                last_logits_only=True)
          host = (time.perf_counter() - host) * 1e3
          end.record()
          end.synchronize()
          times["prefill"][key].append(start.elapsed_time(end))
          times["prefill host enqueue"][key].append(host)
          # The eager decode step, 31 steps.
          tok, pos = _greedy(logits), positions[:, -1:] + 1
          start.record()
          for step in range(DECODE_STEPS - 1):
            if loaded_turn:
              logits, cache = loaded[name].decode_step(p, cache, tok,
                                                       pos + step)
            else:
              with torch.no_grad():
                logits, cache = m(tok, pos + step, cache)
            tok = _greedy(logits)
          end.record()
          end.synchronize()
          times["eager step"][key].append(
              start.elapsed_time(end) / (DECODE_STEPS - 1))
          # The captured step: the loaded one's replays, the Sampler's
          # decode loop.
          if loaded_turn:
            ms = captured[name].step_ms(DECODE_STEPS - 1)
          else:
            samplers[name](prompts, total_generation_steps=DECODE_STEPS,
                           end_sampling_at_eos_token=False)
            ms = probe.decode_ms()
          times["captured step"][key].append(ms)
          del logits, cache
        if profile:
          for key, fn in (
              ("loaded", lambda: loaded[name].prefill(p, tokens, positions)),
              ("live", lambda: m(tokens, positions, return_cache=True,
                                 last_logits_only=True))):
            with torch.no_grad():
              profile_call(fn, float(np.median(times["prefill"][key])),
                           f"{name} {key} prefill")
        for figure, values in times.items():
          ratio = (float(np.median(values["loaded"]))
                   / float(np.median(values["live"])))
          log(f"  {name} {figure} ms in turns {EXPORT_TURNS} (True: the "
              f"loaded program): loaded "
              f"{[round(v, 4) for v in values['loaded']]}, live "
              f"{[round(v, 4) for v in values['live']]}"
              f"{' (the Sampler captured)' if figure == 'captured step' else ''}"
              f"; loaded / live {ratio:.4f}")
    finally:
      probe.close()
    del captured

  finally:
    if fresh_proc is not None and fresh_proc.poll() is None:
      fresh_proc.kill()
      fresh_proc.wait()

  # (f) Host us a call through an operator against the direct launch (the
  # CUDA implementation called as the ctypes launch was before the
  # operators), at decode and prefill shapes.
  gen = torch.Generator(dev).manual_seed(SEED + 111)
  x = torch.randn(2, 1, config.width, generator=gen, device=dev).bfloat16()
  scale = torch.zeros(config.width, device=dev, dtype=torch.bfloat16)
  layer = qmodel.blocks[0].mlp_block.ffw_down
  a = torch.randn(1, 2, layer.kernel_q.shape[1], generator=gen,
                  device=dev).bfloat16()
  q, s = layer.kernel_q[None], layer.kernel_scale[None]
  lx = torch.randn(2, 16, config.lru_width or config.width, generator=gen,
                   device=dev).bfloat16()
  la = torch.rand(*lx.shape, generator=gen, device=dev).bfloat16()

  def lru_direct():
    lru_scan._check(lx, la, None)  # pylint: disable=protected-access
    out = lru_scan._launch("cg_lru_scan_forward", lx, la, None, False)  # pylint: disable=protected-access
    lru_scan.launches += 1
    return out

  def rmsnorm_direct():
    fused_epilogue._check(x, x, scale)  # pylint: disable=protected-access
    return fused_epilogue._cuda(x, x, scale, 1e-6)  # pylint: disable=protected-access

  pairs = {
      "add_rmsnorm [2,1,2560]": {
          "direct": rmsnorm_direct,
          "operator": lambda: fused_epilogue.add_rmsnorm_forward(x, x,
                                                                 scale)},
      "int8_weight_matmul [2,7680] x [2560,7680]": {
          "direct": lambda: (int8_matmul._check(a, q, s),  # pylint: disable=protected-access
                             int8_matmul._forward_cuda(a, q, s)),  # pylint: disable=protected-access
          "operator": lambda: int8_matmul.int8_weight_matmul(a, q, s)},
      "lru_scan_forward [2,16,2560]": {
          "direct": lru_direct,
          "operator": lambda: lru_scan.lru_scan_forward(lx, la)},
  }
  for label, calls in pairs.items():
    times = _host_us_turns(calls)
    med = {k: float(np.median(v)) for k, v in times.items()}
    log(f"  host us a call, {label}, {HOST_CALLS} calls a turn in turns "
        f"(direct, operator, operator, direct): operator "
        f"{[round(v, 2) for v in times['operator']]}, direct "
        f"{[round(v, 2) for v in times['direct']]}; the operator adds "
        f"{med['operator'] - med['direct']:+.2f} us")

  for name, n in (("lru_scan", served["lru_scan"]),
                  ("window_attention", served["window_attention"]),
                  ("int8_weight_matmul", served["int8_weight_matmul"]),
                  ("int8_weight_matmul_wgmma",
                   served["int8_weight_matmul_wgmma"]),
                  ("add_rmsnorm", served["add_rmsnorm"])):
    by_name[name]["launches"] += n
  log(f"  launches of phase 23's counted loaded runs {served} (added to their "
      f"rows)")
  log(f"  phase 23 took {time.perf_counter() - phase_start:.1f} s")


# Phase 24, the command-line programs: phase 22's vocabulary as a
# SentencePiece model; the prompts of the fresh sampling process (one longer
# than the window) and of the serve program's four requests; decode steps;
# the adapters' rank and the fine-tuning run's sequence length (the 729
# visual tokens and this many text tokens, above the window) and steps.
CLI_PROMPT_WORDS = (2500, 300)
CLI_STEPS = 32
CLI_SERVE_WORDS = (2500, 900, 600, 300)
CLI_SERVE_STEPS = 16
CLI_ADAPTER_RANK = 8
# lora_b's std for the served adapters. These weights' logits sit at the
# soft cap (30), and adapters drawn at 0.2, 0.5 or 1.0 left every greedy
# text as it was; from 2.0 each adapter changes them.
CLI_ADAPTER_B_STD = 2.0
CLI_TUNE_SEQ = 2560
CLI_TUNE_RECORDS = 4
CLI_MODAL_STEPS = 16
CLI_HTTP_STEPS = 32
CLI_TIMEOUT_S = 600
# A sentencepiece.ModelProto's piece types (sentencepiece_model.proto).
SP_NORMAL, SP_UNKNOWN, SP_CONTROL = 1, 2, 3


def _proto_varint(value: int) -> bytes:
  value &= (1 << 64) - 1
  out = bytearray()
  while True:
    byte, value = value & 0x7F, value >> 7
    out.append(byte | (0x80 if value else 0))
    if not value:
      return bytes(out)


def _proto_field(number: int, payload, wire: int) -> bytes:
  key = _proto_varint(number << 3 | wire)
  if wire == 0:
    return key + _proto_varint(payload)
  if wire == 5:
    return key + struct.pack("<f", payload)
  return key + _proto_varint(len(payload)) + payload


def sentencepiece_model(vocab: PieceVocab) -> bytes:
  """``vocab`` as a serialized unigram ``sentencepiece.ModelProto``: pad,
  bos, eos control pieces and unk, the single characters at score -10 and
  every longer piece at -1 (so a marked word segments whole); pad 0, bos 1,
  eos 2, unk 3, by id and by piece name."""
  out = bytearray()
  for i, piece in enumerate(vocab.pieces):
    kind = (SP_CONTROL if i < 3 else SP_UNKNOWN if i == 3 else SP_NORMAL)
    score = 0.0 if i < 4 else (-10.0 if len(piece) == 1 else -1.0)
    out += _proto_field(1, _proto_field(1, piece.encode(), 2)
                        + _proto_field(2, score, 5)
                        + _proto_field(3, kind, 0), 2)
  trainer_spec = b"".join(_proto_field(f, v, 0) for f, v in
                          ((3, 1), (40, 3), (41, 1), (42, 2), (43, 0)))
  # The sentencepiece library finds bos, eos, pad and unk by these pieces'
  # names (its defaults are <s>, </s>, <pad>, <unk>); the Gemma model names
  # them as the vocabulary does.
  trainer_spec += b"".join(_proto_field(f, vocab.pieces[i].encode(), 2)
                           for f, i in ((45, 3), (46, 1), (47, 2), (48, 0)))
  return bytes(out + _proto_field(2, trainer_spec, 2))


def _cli_counts() -> dict[str, int]:
  return {"lru_scan": lru_scan.launches,
          "lru_scan_backward": lru_scan.backward_launches,
          "lru_scan_carries": lru_scan.carry_launches,
          "window_attention": wa.launches,
          "window_attention_dq": wa.dq_launches,
          "window_attention_dkv": wa.dkv_launches,
          "mha_attention": mha_attention.launches,
          "int8_weight_matmul": int8_matmul.launches,
          "int8_weight_matmul_wgmma": int8_matmul.wgmma_launches,
          "int8_weight_matmul_dgrad_wgmma": int8_matmul.dgrad_wgmma_launches}


class CliRun:
  """One in-process run: its host seconds, the wrappers' launches in it
  (a captured graph's kernels count once, at its capture) and its standard
  output."""

  def __init__(self, label: str, totals: dict[str, int]):
    self.label, self.totals = label, totals

  def __enter__(self) -> "CliRun":
    torch.cuda.synchronize()
    self._before = _cli_counts()
    self._out = io.StringIO()
    self._redirect = contextlib.redirect_stdout(self._out)
    self._redirect.__enter__()
    self._start = time.perf_counter()
    return self

  def __exit__(self, *exc_info) -> bool:
    torch.cuda.synchronize()
    self.seconds = time.perf_counter() - self._start
    self._redirect.__exit__(*exc_info)
    self.stdout = self._out.getvalue()
    self.launches = {k: v - self._before[k] for k, v in _cli_counts().items()}
    if exc_info[0] is not None:
      log(f"  {self.label} failed; its output ended {self.stdout[-3000:]!r}")
    for k, v in self.launches.items():
      self.totals[k] += v
    if exc_info[0] is None:
      log(f"  {self.label}: {self.seconds:.2f} s (host); launches "
          f"{ {k: v for k, v in self.launches.items() if v} }")
    return False


class ServedTokens:
  """While entered, records the token ids of each request that a
  ``ContinuousBatcher`` finishes, by its prompt (``tokens``), as the serving
  program's ``pop_finished`` loop reads them."""

  def __enter__(self) -> "ServedTokens":
    cls = serving.ContinuousBatcher
    self._saved = add, pop = cls.add_request, cls.pop_finished
    self.tokens, prompts = {}, {}

    def add_request(batcher, prompt, *args, **kwargs):
      request_id = add(batcher, prompt, *args, **kwargs)
      prompts[request_id] = prompt
      return request_id

    def pop_finished(batcher):
      finished = pop(batcher)
      for request_id, ids, _ in finished:
        self.tokens[prompts[request_id]] = list(ids)
      return finished

    cls.add_request, cls.pop_finished = add_request, pop_finished
    return self

  def __exit__(self, *exc_info) -> bool:
    cls = serving.ContinuousBatcher
    cls.add_request, cls.pop_finished = self._saved
    return False


def _served_texts(stdout: str) -> dict[str, str]:
  """{the request's repr: its text} of a serve run's finished requests."""
  return dict(re.findall(r"^=== (?:\[\d+\] )?('.*')\n(.*)$", stdout, re.M))


def _sampled_texts(stdout: str, prompts) -> list[str]:
  """The texts the sampling program printed after each ``>>> prompt``."""
  texts, rest = [], stdout
  for prompt in prompts:
    head = f">>> {prompt}\n"
    if head not in rest:
      raise AssertionError(
          f"The sampling program did not print {prompt[:40]!r}.")
    rest = rest[rest.index(head) + len(head):]
    texts.append(rest.split("\n\n>>> ", 1)[0].rstrip("\n"))
  return texts


def _fresh_cli(root: str, name: str, *argv: str) -> tuple[subprocess.Popen,
                                                         str, str]:
  """``python3 -m cadence_gemma_tpu_torch.examples.<name> argv`` started in
  a fresh process (its output into files under ``root``)."""
  repo = os.path.dirname(os.path.abspath(__file__))
  out = os.path.join(root, f"{name}.out")
  err = os.path.join(root, f"{name}.err")
  with open(out, "w") as f_out, open(err, "w") as f_err:
    proc = subprocess.Popen(
        [sys.executable, "-m", f"cadence_gemma_tpu_torch.examples.{name}",
         *argv], stdout=f_out, stderr=f_err, text=True, cwd=repo,
        env=dict(os.environ, PYTHONPATH=repo, PYTHONUNBUFFERED="1"))
  return proc, out, err


def _read_file(path: str) -> str:
  with open(path) as f:
    return f.read()


def _wait_for_line(path: str, pattern: str, proc, timeout: float) -> str:
  """The first match of ``pattern`` in the file a running process writes."""
  deadline = time.perf_counter() + timeout
  while time.perf_counter() < deadline:
    match = re.search(pattern, _read_file(path))
    if match:
      return match.group(1)
    if proc.poll() is not None:
      break
    time.sleep(0.5)
  raise AssertionError(f"No {pattern!r} from the serve process (exit "
                       f"{proc.poll()}).")


@dataclasses.dataclass(frozen=True)
class _LogEveryStep(train_loop_lib.TrainingConfig):
  """The fine-tuning program's stage configs with metrics logged at every
  step (its flags leave ``eval_every_n`` at 200, as JAX's)."""

  eval_every_n: int = 1


def _cli_world(root: str, dev, model, vocab: PieceVocab) -> dict:
  """The programs' inputs under ``root``: the 2B's ``bf16.pt``, the towers,
  two rank-8 adapter trees, the tokenizer model and a LLaVA-style JSON over
  the test images. Returns their paths, the towers and the adapter trees."""
  paths = {"weights": os.path.join(root, "bf16.pt"),
           "tokenizer": os.path.join(root, "tokenizer.model"),
           "towers": os.path.join(root, "towers.pt"),
           "tune_json": os.path.join(root, "tune.json"),
           "tune_out": os.path.join(root, "tune")}
  checkpoint_io.save_parameters(paths["weights"], model.state_dict())
  with open(paths["tokenizer"], "wb") as f:
    f.write(sentencepiece_model(vocab))
  encoder = vit.DinoSigLIPEncoder(
      device=dev, generator=torch.Generator(dev).manual_seed(SEED + 81))
  checkpoint_io.save_parameters(paths["towers"], encoder.state_dict())
  adapter_model = griffin.Griffin(model.config, device="meta",
                                  lora_rank=CLI_ADAPTER_RANK)
  trees = []
  for i in range(2):
    gen = torch.Generator(dev).manual_seed(SEED + 140 + i)
    trees.append(sft_lora.init_adapters(adapter_model, gen))
    for name, leaf in trees[-1].items():
      if name.endswith("lora_b"):  # drawn zero: give the adapters an effect
        leaf.normal_(0.0, CLI_ADAPTER_B_STD, generator=gen)
    paths[f"adapter{i}"] = os.path.join(root, f"adapter{i}.pt")
    checkpoint_io.save_parameters(paths[f"adapter{i}"], trees[-1])
  fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                          "fixtures")
  rng = np.random.default_rng(SEED + 142)
  images = ["dog.jpg", "car.jpg", "cart.jpg"]
  records = [{"image": os.path.join(fixtures, images[i % 3]),
              "conversations": [
                  {"from": "human",
                   "value": "<image>\n" + vocab.prompt(rng, 400)},
                  {"from": "gpt", "value": vocab.prompt(rng, 2000)}]}
             for i in range(CLI_TUNE_RECORDS)]
  with open(paths["tune_json"], "w") as f:
    json.dump(records, f)
  os.makedirs(paths["tune_out"])
  return dict(paths, encoder=encoder, adapters=trees)


def phase_cli(dev, handoff: dict, root: str) -> dict[str, int]:
  """The five command-line programs on the card at the 2B's full width and
  depth, on phase 18's realistic_params weights (phase 23's checkpoint in
  ``root``), phase 22's vocabulary as a SentencePiece model, seeded towers
  and two rank-8 adapter trees: (a) ``sampling`` in a fresh process against
  an in-process ``Sampler``; (b) ``serve``'s requests mode plain, int8,
  speculative (equal to plain) and with both adapters (each changing a text,
  the served tokens a solo Sampler's with the request's adapter), in this
  process, and ``--http_port 0 --json_mode`` in a fresh process
  (``/v1/generate``, a ``json_object`` chat that must parse, SIGINT);
  (c) ``cadence`` on
  ``dog.jpg`` against an in-process ``ModalSampler``; (d) ``finetune`` with
  QLoRA rank 8 at 729 + 2560 tokens (4 finite losses, a ``final`` that loads
  and samples); (e) ``simple_run`` at 2560 x 26, ``profiling.trace`` around
  a Sampler call, ``device_memory_stats``. Returns the in-process runs'
  launches by kernel row."""
  phase_start = time.perf_counter()
  model = handoff["model"]
  config = model.config
  vocab = PieceVocab(config.vocab_size, SEED + 100)
  totals = {k: 0 for k in _cli_counts()}
  log(f"== the command-line programs (cadence_gemma_tpu_torch.examples) on "
      f"phase 18's realistic_params 2B, phase 22's {config.vocab_size}-piece "
      f"vocabulary as a SentencePiece model, seeded towers, two rank-"
      f"{CLI_ADAPTER_RANK} adapter trees")
  start = time.perf_counter()
  world = _cli_world(root, dev, model, vocab)
  sp_vocab = tokenizers.load_sentencepiece(world["tokenizer"])
  special = (sp_vocab.pad_id(), sp_vocab.bos_id(), sp_vocab.eos_id(),
             sp_vocab.GetPieceSize())
  log(f"  inputs written and the tokenizer loaded ({type(sp_vocab).__name__};"
      f" pad, bos, eos, pieces {special}) in "
      f"{time.perf_counter() - start:.1f} s (host)")
  if special != (0, 1, 2, config.vocab_size):
    raise AssertionError(f"The tokenizer reads pad, bos, eos, pieces "
                         f"{special}.")
  rng = np.random.default_rng(SEED + 143)
  prompts = [vocab.prompt(rng, n).strip() for n in CLI_PROMPT_WORDS]
  requests = [vocab.prompt(rng, n).strip() for n in CLI_SERVE_WORDS]
  common_argv = [f"--checkpoint_path={world['weights']}",
                 f"--tokenizer_path={world['tokenizer']}"]
  procs = []
  try:
    # (a) and (b)'s HTTP program start first, in fresh processes.
    start, sampling_wall = time.perf_counter(), time.time()
    sampling_proc, sampling_out, sampling_err = _fresh_cli(
        root, "sampling", *common_argv,
        *[f"--prompt={p}" for p in prompts],
        f"--total_generation_steps={CLI_STEPS}")
    procs.append(sampling_proc)
    http_wall = time.time()
    http_proc, http_out, http_err = _fresh_cli(
        root, "serve", *common_argv, "--http_port=0", "--json_mode",
        "--per_request_sampling", "--nodeterministic",
        f"--max_steps={CLI_HTTP_STEPS}")
    procs.append(http_proc)

    # (a) the in-process Sampler on the same weights, tokenizer and prompts.
    sampler = sampler_lib.Sampler(model, sp_vocab, device=dev,
                                  is_it_model=True)
    lengths = [len(sampler.tokenize(p)) for p in prompts]
    with CliRun(f"(a) in-process Sampler, prompts of {lengths} tokens, "
                f"{CLI_STEPS} steps", totals) as run:
      want = sampler(prompts, CLI_STEPS).text
    n_recurrent = sum(bt is common.TemporalBlockType.RECURRENT
                      for bt in config.block_types)
    if (run.launches["lru_scan"], run.launches["window_attention"]) != (
        n_recurrent, config.num_layers - n_recurrent):
      raise AssertionError(f"(a) the prefill launched {run.launches}.")
    sampling_proc.wait(timeout=CLI_TIMEOUT_S)
    sampling_s = time.perf_counter() - start
    if sampling_proc.returncode != 0:
      raise AssertionError(f"sampling exited {sampling_proc.returncode}: "
                           f"{_read_file(sampling_err)[-4000:]}")
    got = _sampled_texts(_read_file(sampling_out), prompts)
    # The program prints its texts in one loop once every prompt is done:
    # its output's last write is its first token on the screen.
    log(f"  (a) python3 -m ...examples.sampling, a fresh process: "
        f"{os.path.getmtime(sampling_out) - sampling_wall:.1f} s (host) from "
        f"its start to its printed texts, {sampling_s:.1f} s to its exit; "
        f"its texts equal to the in-process Sampler's: {got == want}")
    if got != want:
      raise AssertionError(f"(a) {got} != {want}.")

    # (b) serve's requests mode, four ways, in this process.
    serve_argv = [*common_argv, *[f"--request={r}" for r in requests],
                  f"--max_steps={CLI_SERVE_STEPS}", "--num_slots=4"]
    modes = {"plain": [], "int8": ["--int8"], "speculative": ["--speculative"],
             "adapters": [f"--adapter_path={world['adapter0']}",
                          f"--adapter_path={world['adapter1']}"]}
    served = {}
    for mode, extra in modes.items():
      with CliRun(f"(b) serve {mode}", totals) as run, ServedTokens() as ids:
        if cli_serve.main([*serve_argv, *extra]) != 0:
          raise AssertionError(f"serve {mode} failed.")
      served[mode] = _served_texts(run.stdout)
      if len(served[mode]) != len(requests) or not all(served[mode].values()):
        raise AssertionError(f"serve {mode} printed {run.stdout[-2000:]}")
      if mode == "adapters":
        adapter_tokens = ids.tokens
    differ = {mode: [i for i, r in enumerate(requests)
                     if served[mode][repr(r)] != served["plain"][repr(r)]]
              for mode in ("int8", "speculative", "adapters")}
    log(f"    requests whose texts differ from plain: {differ}")
    if differ["speculative"]:
      raise AssertionError(f"(b) serve --speculative printed other texts "
                           f"than plain decode for requests "
                           f"{differ['speculative']}.")
    # Request i serves adapter i % 2: each adapter changes a text, and the
    # served tokens are a solo Sampler's on the base with that adapter.
    if {i % 2 for i in differ["adapters"]} != {0, 1}:
      raise AssertionError(f"(b) an adapter changed no text: requests "
                           f"{differ['adapters']} differ from plain.")
    lmodel = griffin.Griffin(config, device="meta", dtype=torch.bfloat16,
                             lora_rank=CLI_ADAPTER_RANK)
    lmodel.to_empty(device=dev)
    lmodel.load_state_dict(model.state_dict(), strict=False)
    eot = sp_vocab.EncodeAsIds("<end_of_turn>")
    stop_ids = eot if len(eot) == 1 else None
    lsampler = sampler_lib.Sampler(lmodel, sp_vocab, device=dev,
                                   is_it_model=True, stop_token_ids=stop_ids)
    identical = 0
    for i, prompt in enumerate(requests):
      lmodel.load_state_dict(world["adapters"][i % 2], strict=False)
      solo = lsampler([prompt], CLI_SERVE_STEPS, return_logits=True)
      agree = token_agreement(
          f"(b) serve --adapter_path request {i}", adapter_tokens[prompt],
          solo.tokens[0].tolist(), solo.logits[0],
          {int(sp_vocab.eos_id()), *(stop_ids or ())})
      identical += agree["identical"]
    log(f"    the adapters' served tokens against solo Samplers on the base "
        f"with request i's adapter: {identical} of {len(requests)} "
        f"identical, the rest first differ at a near tie")
    del lmodel, lsampler
    torch.cuda.empty_cache()

    # (c) cadence on dog.jpg against the in-process ModalSampler.
    image = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                         "fixtures", "dog.jpg")
    prompt = vocab.prompt(rng, 40).strip()
    with CliRun("(c) cadence --img_path dog.jpg", totals) as run:
      cli_cadence.main([*common_argv,
                        f"--vision_checkpoint={world['towers']}",
                        f"--img_path={image}", f"--prompt={prompt}",
                        f"--total_generation_steps={CLI_MODAL_STEPS}"])
    modal = modal_sampler.ModalSampler(model, sp_vocab,
                                       vision_encoder=world["encoder"],
                                       device=dev, is_it_model=True)
    want = modal([prompt], CLI_MODAL_STEPS, img_path=image).text[0]
    log(f"    its text equal to the in-process ModalSampler's: "
        f"{run.stdout.rstrip(chr(10)) == want}")
    if run.stdout.rstrip("\n") != want or run.launches["mha_attention"] != 46:
      raise AssertionError(f"(c) {run.stdout!r} != {want!r}, or MHA "
                           f"{run.launches['mha_attention']} != 46.")
    del modal, world["encoder"]
    torch.cuda.empty_cache()

    # (d) finetune: stage 1, then QLoRA rank 8, the final save.
    saved_config = train_loop_lib.TrainingConfig
    train_loop_lib.TrainingConfig = _LogEveryStep
    metrics = os.path.join(world["tune_out"], "metrics.jsonl")
    try:
      with CliRun(f"(d) finetune --lora_rank {CLI_ADAPTER_RANK} "
                  f"--lora_int8_base, {CLI_TUNE_RECORDS} records, 2 + 2 "
                  f"steps at 729 + {CLI_TUNE_SEQ} tokens", totals) as run:
        cli_finetune.main([
            *common_argv, f"--vision_checkpoint={world['towers']}",
            f"--train_json={world['tune_json']}",
            f"--output_dir={world['tune_out']}",
            f"--max_seq_len={CLI_TUNE_SEQ}", "--stage1_steps=2",
            "--stage2_steps=2", "--stage1_lr=1e-3", "--stage2_lr=1e-3",
            f"--lora_rank={CLI_ADAPTER_RANK}", "--lora_int8_base",
            "--metrics=jsonl", f"--metrics_target={metrics}"])
    finally:
      train_loop_lib.TrainingConfig = saved_config
    with open(metrics) as f:
      losses = [json.loads(line)["train_loss"] for line in f]
    final = checkpoint_io.load_parameters(
        os.path.join(world["tune_out"], "final"), dev)
    tuned = griffin.Griffin(config, device="meta", quantized=True,
                            lora_rank=CLI_ADAPTER_RANK)
    tuned.to_empty(device=dev)
    tuned.load_state_dict(final)
    del final
    text = sampler_lib.Sampler(tuned, sp_vocab, device=dev)(
        [prompts[1]], 8).text[0]
    log(f"    losses {losses}; {{output_dir}}/final loaded into a QLoRA "
        f"Griffin and sampled {text!r}")
    want_rows = ("lru_scan_backward", "window_attention_dq",
                 "window_attention_dkv", "int8_weight_matmul_wgmma",
                 "int8_weight_matmul_dgrad_wgmma")
    if (len(losses) != 4 or not all(math.isfinite(x) for x in losses)
        or not all(run.launches[k] for k in want_rows)):
      raise AssertionError(f"(d) losses {losses}, launches {run.launches}.")
    del tuned
    torch.cuda.empty_cache()

    # (e) simple_run at the 2B's width and depth; a trace; memory figures.
    with CliRun("(e) simple_run --width 2560 --layers 26 --steps 32",
                totals) as run:
      cli_simple_run.main(["--width", "2560", "--layers", "26", "--steps",
                           "32"])
    lines = run.stdout.splitlines()
    log(f"    {lines}")
    if len(lines) != 3 or not lines[2].strip().startswith("sample: n=1"):
      raise AssertionError(f"(e) simple_run printed {lines}.")
    trace_dir = os.path.join(root, "trace")
    with profiling.trace(trace_dir):
      sampler([prompts[1]], 8)
    (trace_file,) = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
    with open(trace_file) as f:
      names = {e.get("name", "") for e in json.load(f)["traceEvents"]
               if e.get("cat") == "kernel"}
    scans = sorted(n for n in names if "ring_kernel" in n
                   or "thread_walk_kernel" in n)
    stats = profiling.device_memory_stats()
    log(f"    profiling.trace: {len(names)} kernel names, the LRU scan's "
        f"{[n[:80] for n in scans]}; device_memory_stats {stats}")
    if not scans or not (0 < stats["peak_bytes_in_use"]
                         <= stats["bytes_limit"]):
      raise AssertionError("(e) no LRU scan kernel in the trace, or memory "
                           f"figures {stats}.")
    # (b) HTTP, last (its process started first): /v1/generate, a
    # json_object chat, SIGINT.
    try:
      port = int(_wait_for_line(http_out, r"HTTP serving on :(\d+)", http_proc,
                                CLI_TIMEOUT_S))
      # The port line is the program's last write before it serves.
      to_port_line = os.path.getmtime(http_out) - http_wall
      start = time.perf_counter()
      _, _, generated = _http(port, "/v1/generate", {
          "prompt": requests[-1], "max_tokens": CLI_SERVE_STEPS, "top_k": 1})
      ids = {p: sp_vocab.PieceToId(p) for p in ("{", "}")}
      _, _, chat = _http(port, "/v1/chat/completions", {
          "messages": [{"role": "user", "content": requests[-1]}],
          "max_tokens": CLI_HTTP_STEPS, "temperature": 0,
          "response_format": {"type": "json_object"},
          "logit_bias": {str(ids["{"]): 100, str(ids["}"]): 100,
                         str(vocab.eos_id()): 100}})
      content = chat["choices"][0]["message"]["content"]
      parsed = json.loads(content)
      http_proc.send_signal(signal.SIGINT)
      http_proc.wait(timeout=120)
      log(f"  (b) serve --http_port 0 --json_mode in a fresh process: "
          f"{to_port_line:.1f} s (host) from its start to its port line; "
          f"{_read_file(http_out).splitlines()[0][:120]}; /v1/generate "
          f"{len(generated['tokens'])} tokens; the json_object chat "
          f"(logit_bias +100 on '{{', '}}' and EOS; the grammar orders them) "
          f"answered "
          f"{content!r} ({chat['choices'][0]['finish_reason']}), parsed "
          f"{parsed!r}; both in {time.perf_counter() - start:.2f} s; SIGINT: "
          f"exit {http_proc.returncode}")
      if http_proc.returncode != 0 or not generated["tokens"]:
        raise AssertionError(f"serve over HTTP: {_read_file(http_err)[-4000:]}")
    except BaseException as e:
      body = e.read().decode() if isinstance(e, urllib.error.HTTPError) else ""
      log(f"  (b) over HTTP: {body} the serve process's stderr ended "
          f"{_read_file(http_err)[-6000:]}")
      raise
  finally:
    for proc in procs:
      if proc.poll() is None:
        proc.kill()
        proc.wait()

  log(f"  launches of phase 24's in-process runs {totals} (added to their "
      f"rows once phase 19 has made the int8 input gradient's; the fresh "
      f"processes' are not seen here)")
  log(f"  phase 24 took {time.perf_counter() - phase_start:.1f} s")
  return totals


# -- phase 25: tensor-parallel serving ------------------------------------------

# The model-axis widths: TP-2 runs the whole phase, TP-4 (the 10 gate heads
# do not divide: they replicate) one prefill against the unsharded logits.
TP_SHARDS = 2
TP4_SHARDS = 4
TP_TURNS = ("one", "tp", "tp", "one")
TP_BATCH_REQUESTS = 16
TP_BATCH_PROMPT_RANGE = (64, 400)
TP_BATCH_STEPS = 16
TP_TICK_REPEATS = 4
TP_SPEC_STEPS = 64


def _tp_counts() -> dict[str, int]:
  return {"lru_scan": lru_scan.launches, "window_attention": wa.launches,
          "lru_scan_carries": lru_scan.carry_launches,
          "add_rmsnorm": fused_epilogue.launches,
          "int8_weight_matmul": int8_matmul.launches,
          "int8_weight_matmul_wgmma": int8_matmul.wgmma_launches}


def _delta(before: dict[str, int]) -> dict[str, int]:
  return {k: v - before[k] for k, v in _tp_counts().items()}


def _add(total: dict[str, int], launches: dict[str, int]) -> None:
  for k, v in launches.items():
    total[k] += v


def _tp_mesh(dev, n: int) -> sharding.Mesh:
  """A ``(1, n)`` mesh whose n model-axis positions repeat the card."""
  return sharding.make_mesh((1, n), ("data", "model"), devices=[dev] * n)


class PrefillClock:
  """CUDA events, the host clock and the counters around every forward of
  a model: a forward's event ms far above its host enqueue ms waits on the
  card, one close to it on the host's launches."""

  def __init__(self, model):
    self.calls = []
    self.hooks = [model.register_forward_pre_hook(self._before),
                  model.register_forward_hook(self._after)]

  @staticmethod
  def _event():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e

  def _before(self, *_):
    self.calls.append([self._event(), _tp_counts(), time.perf_counter()])

  def _after(self, *_):
    self.calls[-1] += [self._event(), _tp_counts(), time.perf_counter()]

  def first(self) -> tuple[float, dict[str, int]]:
    """The first forward's ms and launches (a Sampler call's prefill)."""
    start, before, _, end, after, _ = self.calls[0]
    end.synchronize()
    return start.elapsed_time(end), {k: after[k] - before[k] for k in after}

  def first_host_ms(self) -> float:
    """The host's ms to enqueue the first forward."""
    return (self.calls[0][5] - self.calls[0][2]) * 1e3

  def close(self) -> None:
    for hook in self.hooks:
      hook.remove()


def _rel_rms_rows(got, want) -> float:
  return max(_rel_rms(g, w) for g, w in zip(got, want))


def _agreement(label: str, got, want, stops) -> list:
  """Each row of ``got`` against the reference output ``want`` (its logits
  decide a near tie)."""
  return [token_agreement(f"{label} row {row}", g.tolist(), w.tolist(), lg,
                          stops)
          for row, (g, w, lg) in enumerate(zip(got.tokens, want.tokens,
                                               want.logits))]


def _tp_int8_launches(model) -> int:
  """The int8 kernel's launches in one weight-only TP forward: each shard's
  int8 layers (the single KV head's once) and each shard's logits."""
  return (sum(hasattr(m, "kernel_q") or hasattr(m, "w_q")
              for m in model.blocks.modules())
          + len(model.embedder.s.shards))


def _check_captured(capture, label: str, check) -> tuple[float, tuple]:
  if capture.args is None:
    raise AssertionError(f"The TP path never called {label}.")
  shapes = [tuple(z.shape) for z in capture.args
            if isinstance(z, torch.Tensor)]
  err = check(*capture.args, **capture.kwargs)
  if not isinstance(err, float):
    err = max(err)
  log(f"  {label} on the first shard call's inputs {shapes}: max_abs_err "
      f"{err}")
  return err, shapes


def _tp_batch_specs(vocab, config, seed: int) -> list[dict]:
  rng = np.random.default_rng(seed)
  lo, hi = TP_BATCH_PROMPT_RANGE
  return [dict(name=f"r{i}", prompt=" ".join(
      f"w{j}" for j in rng.integers(0, config.vocab_size - 4,
                                    int(rng.integers(lo, hi)))))
          for i in range(TP_BATCH_REQUESTS)]


def _drive_plain(batcher, specs) -> dict[str, list[int]]:
  """One request joins a tick while a slot is free; BATCH_TICK steps a
  tick."""
  queue, names, tokens = list(specs), {}, {}
  while queue or batcher.active_count:
    if queue and batcher.has_capacity:
      spec = queue.pop(0)
      names[batcher.add_request(spec["prompt"],
                                max_steps=TP_BATCH_STEPS)] = spec["name"]
    batcher.step(BATCH_TICK)
    for rid, got, _ in batcher.pop_finished():
      tokens[names[rid]] = got
  return tokens


def phase_tensor_parallel(dev, kernels: list[dict],
                          handoff: dict) -> dict[str, int]:
  """Tensor-parallel serving on phase 18's models over a (1, 2) mesh that
  repeats the card: the TP Sampler (text prompts, captured decode), each
  kernel against its plain version on its first shard call's inputs and
  timed at the shard shapes, the unsharded model in turns, a TP-4 prefill,
  the fused epilogue, int8, an 8-slot TP batcher and TP speculation.
  Returns the launches to add to the kernels line."""
  phase_start = time.perf_counter()
  model, qmodel, vocab, prompts = (
      handoff[k] for k in ("model", "qmodel", "vocab", "prompts"))
  config = model.config
  by_name = {kernel["name"]: kernel for kernel in kernels}
  n_rec = sum(bt is common.TemporalBlockType.RECURRENT
              for bt in config.block_types)
  n_att = config.num_layers - n_rec
  stops = {vocab.eos_id()}
  total = {k: 0 for k in _tp_counts()}
  mesh = _tp_mesh(dev, TP_SHARDS)
  log(f"== phase 25: tensor-parallel serving of phase 18's 2B over {mesh} "
      f"(TP-{TP_SHARDS}; the card repeats, so no speed-up is possible)")
  torch.cuda.synchronize()
  base_gb = torch.cuda.memory_allocated() / 1e9
  start = time.perf_counter()
  tp = sampler_lib.Sampler(model, vocab, mesh=mesh)
  torch.cuda.synchronize()
  log(f"  placed by griffin_param_shardings in "
      f"{time.perf_counter() - start:.2f} s: +"
      f"{torch.cuda.memory_allocated() / 1e9 - base_gb:.3f} GB (bf16 pieces "
      f"are views of the model's weights)")
  shard = tp.model.blocks[0].temporal.s.shards[0]
  log(f"  shard 0 of block 0: linear_x {tuple(shard.linear_x.kernel.shape)}, "
      f"linear_out {tuple(shard.linear_out.kernel.shape)}, a_param "
      f"{tuple(shard.rg_lru.a_param.shape)}; attention shard 0 proj_q "
      f"{tuple(tp.model.blocks[2].temporal.s.shards[0].proj_q.kernel.shape)}")
  one = sampler_lib.Sampler(model, vocab, device=dev)
  run_kw = dict(total_generation_steps=DECODE_STEPS, return_logits=True,
                end_sampling_at_eos_token=False)

  # (a) The TP Sampler on the text prompts; the warm-up captures its decode
  # graph and keeps each kernel's first shard call.
  probe = DecodeProbe(_tp_counts)
  clocks = {"tp": PrefillClock(tp.model), "one": PrefillClock(model)}
  captures = [CaptureFirstCall(lru_scan, "lru_scan"),
              CaptureFirstCall(wa, "window_attention")]
  try:
    tp(prompts, **run_kw)
  finally:
    for capture in captures:
      capture.restore()
  try:
    for clock in clocks.values():
      clock.calls.clear()
    probe.reset()
    reset_scan_routes()
    before = _tp_counts()
    out_tp = tp(prompts, **run_kw)
    torch.cuda.synchronize()
    counted = _delta(before)
    check_scan_routes(counted["lru_scan"])
    run = probe.run_launches(counted)
    prefill_ms, prefill = clocks["tp"].first()
    step = probe.step_launches
    _add(total, run)
    log(f"  TP Sampler, prompts {PROMPT_TOKENS}, {DECODE_STEPS} greedy steps "
        f"({probe.replays} replays of one captured step): prefill launched "
        f"{prefill}; a captured step {step}; the run {run}")
    want = (TP_SHARDS * n_rec, TP_SHARDS * n_att)
    if ((prefill["lru_scan"], prefill["window_attention"]) != want
        or step["lru_scan"] or step["window_attention"]
        or (run["lru_scan"], run["window_attention"]) != want):
      raise AssertionError(f"TP prefill launches (lru, window) "
                           f"{(prefill['lru_scan'], prefill['window_attention'])}"
                           f", want {want}; none in decode.")
    lru_err, lru_shapes = _check_captured(captures[0], "lru_scan", check_lru)
    attn_err, attn_shapes = _check_captured(captures[1], "window_attention",
                                            check_attention)
    if lru_shapes[0] != (2, max(PROMPT_TOKENS), config.lru_width // TP_SHARDS):
      raise AssertionError(f"The first shard scan ran at {lru_shapes[0]}.")
    if attn_shapes[0][2] != config.num_heads // TP_SHARDS:
      raise AssertionError(f"The first shard attention ran at "
                           f"{attn_shapes[0]}.")
    by_name["lru_scan"]["max_abs_err"] = max(by_name["lru_scan"][
        "max_abs_err"], lru_err)
    by_name["window_attention"]["max_abs_err"] = max(
        by_name["window_attention"]["max_abs_err"], attn_err)
    out_one = one(prompts, **run_kw)
    rel = _rel_rms_rows(out_tp.logits, out_one.logits)
    agree = _agreement("TP-2 against unsharded", out_tp, out_one, stops)
    log(f"  TP-2 against the unsharded model: logits rel_rms {rel:.3e} "
        f"(tolerance {MODEL_LOGITS_REL_RMS}); tokens {agree}")
    if not rel <= MODEL_LOGITS_REL_RMS:
      raise AssertionError("TP-2 and unsharded logits disagree.")

    # In turns with the unsharded model: prefill ms, captured decode ms a
    # step, peak memory of the call.
    samplers = {"tp": tp, "one": one}
    turns = {side: [] for side in samplers}
    for side in TP_TURNS:
      for clock in clocks.values():
        clock.calls.clear()
      probe.reset()
      torch.cuda.synchronize()
      torch.cuda.reset_peak_memory_stats()
      samplers[side](prompts, **run_kw)
      turns[side].append((clocks[side].first()[0],
                          clocks[side].first_host_ms(), probe.decode_ms(),
                          torch.cuda.max_memory_allocated() / 1e9))
    for side, rows in turns.items():
      log(f"  {side}: prefill ms {[round(r[0], 2) for r in rows]} (host "
          f"enqueue ms {[round(r[1], 2) for r in rows]}), captured decode ms "
          f"a step {[round(r[2], 3) for r in rows]}, peak GB "
          f"{[round(r[3], 2) for r in rows]}")
  finally:
    probe.close()
    for clock in clocks.values():
      clock.close()

  # Kernel figures at the shard shapes, on the first shard calls' inputs.
  x, a = captures[0].args[:2]
  b, t, d = x.shape
  n_bytes = 3 * b * t * d * 2 + b * d * 4
  lru_fig = time_scan(lru_scan.lru_scan_forward, (x, a), n_bytes,
                      2 * b * t * d)
  lru_fig["plain_ms"] = cuda_ms(lambda: lru_scan.lru_scan_plain(x, a), reps=1)
  log(f"  lru_scan at the shard shape {[b, t, d]}:")
  log_scan(lru_fig, lru_fig["plain_ms"], n_bytes)
  q, k, v, seg = captures[1].args[:4]
  attn_fig = window_forward_figures(q, k, v, seg)
  log_figures(f"window_attention at the shard shape {list(q.shape)}",
              attn_fig)
  by_name["lru_scan"]["tp_shape"] = dict(shape=[b, t, d], **{
      key: lru_fig[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "bound_share")})
  by_name["window_attention"]["tp_shape"] = dict(shape=list(q.shape), **{
      key: attn_fig[key] for key in ("ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by", "bound_share")})
  del captures, x, a, q, k, v, seg

  # (b) TP-4: the 10 gate heads replicate; one prefill against the
  # unsharded logits. (c) The fused epilogue on the TP-2 model.
  rng = np.random.default_rng(SEED + 95)
  ids = torch.tensor([[1, *rng.integers(4, config.vocab_size,
                                        REFERENCE_PROMPT_TOKENS - 1)]],
                     device=dev)
  pos = torch.arange(REFERENCE_PROMPT_TOKENS, device=dev)[None]
  fwd = dict(return_cache=False, last_logits_only=True)
  tp4 = tensor_parallel.tensor_parallel(model, _tp_mesh(dev, TP4_SHARDS))
  with torch.inference_mode():
    want_logits, _ = model(ids, pos, **fwd)
    before = _tp_counts()
    reset_scan_routes()
    got, _ = tp4(ids, pos, **fwd)
    torch.cuda.synchronize()
    launches = _delta(before)
  check_scan_routes(launches["lru_scan"])
  _add(total, launches)
  rel = _rel_rms(got, want_logits)
  log(f"  TP-4 prefill ({REFERENCE_PROMPT_TOKENS} tokens; gates replicated: "
      f"{not tp4.blocks[0].temporal.gates_split}): launched {launches}; "
      f"logits rel_rms {rel:.3e} against unsharded, same argmax "
      f"{bool(got.argmax() == want_logits.argmax())}")
  if (launches["lru_scan"] != TP4_SHARDS * n_rec
      or launches["window_attention"] != TP4_SHARDS * n_att
      or not rel <= MODEL_LOGITS_REL_RMS):
    raise AssertionError("The TP-4 prefill disagrees.")
  del tp4
  torch.cuda.empty_cache()
  blocks = [*model.blocks, *tp.model.blocks]
  fused = [block.fused_epilogue for block in blocks]
  for block in blocks:
    block.fused_epilogue = True
  capture = CaptureFirstCall(fused_epilogue, "fused_add_rmsnorm")
  try:
    with torch.inference_mode():
      want_logits, _ = model(ids, pos, **fwd)
      before = _tp_counts()
      got, _ = tp.model(ids, pos, **fwd)
      torch.cuda.synchronize()
      launches = _delta(before)
  finally:
    capture.restore()
    for block, flag in zip(blocks, fused):
      block.fused_epilogue = flag
  _add(total, launches)
  rel = _rel_rms(got, want_logits)
  norm_err, _ = _check_captured(capture, "add_rmsnorm", check_add_rmsnorm)
  by_name["add_rmsnorm"]["max_abs_err"] = max(
      by_name["add_rmsnorm"]["max_abs_err"], norm_err)
  log(f"  TP-2 prefill with the fused epilogue: launched {launches}; logits "
      f"rel_rms {rel:.3e} against the unsharded fused forward")
  if launches["add_rmsnorm"] != config.num_layers or not (
      rel <= MODEL_LOGITS_REL_RMS):
    raise AssertionError("The fused-epilogue TP prefill disagrees.")
  del capture

  # (d) Int8 (weight-only) over the same mesh.
  torch.cuda.synchronize()
  base_gb = torch.cuda.memory_allocated() / 1e9
  qtp = sampler_lib.Sampler(qmodel, vocab, mesh=mesh)
  torch.cuda.synchronize()
  log(f"  int8 placed: +{torch.cuda.memory_allocated() / 1e9 - base_gb:.3f} "
      f"GB (int8 pieces made contiguous once, for the kernels' TMA)")
  qone = sampler_lib.Sampler(qmodel, vocab, device=dev)
  n_int8 = _tp_int8_launches(qtp.model)
  logits_shards = len(qtp.model.embedder.s.shards)
  int8_cap = CaptureInt8Calls()
  clock = PrefillClock(qtp.model)
  probe = DecodeProbe(_tp_counts)
  try:
    qtp(prompts, **run_kw)
    int8_cap.restore()
    clock.calls.clear()
    probe.reset()
    before = _tp_counts()
    out_q = qtp(prompts, **run_kw)
    torch.cuda.synchronize()
    run = probe.run_launches(_delta(before))
    _, prefill = clock.first()
    step = probe.step_launches
  finally:
    int8_cap.restore()
    clock.close()
    probe.close()
  _add(total, run)
  log(f"  int8 TP Sampler: prefill launched {prefill}; a captured step "
      f"{step}; the run {run}")
  if (prefill["int8_weight_matmul_wgmma"] != n_int8 - logits_shards
      or prefill["int8_weight_matmul"] != logits_shards
      or step["int8_weight_matmul"] != n_int8):
    raise AssertionError(f"int8 TP launches: prefill {prefill}, a step "
                         f"{step}; want {n_int8 - logits_shards} wgmma + "
                         f"{logits_shards} mma.sync, {n_int8} a step.")
  worst, int8_fig = 0.0, {}
  for key, args in int8_cap.inputs():
    worst = max(worst, check_int8(*args))
    batches, n, kdim, rows, _ = key
    if (n, kdim, rows) in ((config.width, config.lru_width // TP_SHARDS,
                            INT8_PREFILL_ROWS),
                           (config.vocab_size // TP_SHARDS, config.width, 2)):
      int8_fig[(batches, n, kdim, rows)] = int8_figures(*args)
  log(f"  int8 kernels against their plain versions at the "
      f"{len(int8_cap.calls)} shard shapes of the run: max_abs_err {worst} "
      f"(tolerance {INT8_REL} of the larger value)")
  for (batches, n, kdim, rows), f in int8_fig.items():
    route = "wgmma" if int8_matmul.uses_wgmma(rows) else "mma.sync"
    log(f"  int8 {route} at [{rows}, {kdim}] x [{n}, {kdim}]: ms "
        f"{f['ms']:.4f}, bound {f['bound_ms']:.4f} ({f['bound_by']}: "
        f"{100 * f['bound_ms'] / f['ms']:.1f}%), plain {f['plain_ms']:.4f}, "
        f"dequant + matmul {f['dequant_ms']:.4f}, library "
        f"{f['library_ms']}")
    row = by_name["int8_weight_matmul_wgmma" if route == "wgmma"
                  else "int8_weight_matmul"]
    row["tp_shape"] = dict(shape=[rows, kdim, n], **{
        key: f[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "dequant_ms")})
  for name in ("int8_weight_matmul", "int8_weight_matmul_wgmma"):
    by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], worst)
  out_qone = qone(prompts, **run_kw)
  rel = _rel_rms_rows(out_q.logits, out_qone.logits)
  agree = _agreement("int8 TP-2 against unsharded int8", out_q, out_qone,
                     stops)
  log(f"  int8 TP-2 against the unsharded int8 model: logits rel_rms "
      f"{rel:.3e}; tokens {agree}")
  if not rel <= MODEL_LOGITS_REL_RMS:
    raise AssertionError("int8 TP-2 and unsharded logits disagree.")
  del qtp, qone, int8_cap, out_q, out_qone
  torch.cuda.empty_cache()

  # (e) An 8-slot TP batcher taking 16 requests, against the unsharded
  # batcher on the same schedule; then the steady tick in turns.
  specs = _tp_batch_specs(vocab, config, SEED + 96)
  batchers = {side: serving.ContinuousBatcher(s, num_slots=BATCH_SLOTS,
                                              max_steps_default=256)
              for side, s in (("tp", tp), ("one", one))}
  before = _tp_counts()
  got = _drive_plain(batchers["tp"], specs)
  _add(total, _delta(before))
  ref = _drive_plain(batchers["one"], specs)
  identical = 0
  for spec in specs:
    name = spec["name"]
    if got[name] == ref[name]:
      identical += 1
      continue
    solo = one([spec["prompt"]], TP_BATCH_STEPS, return_logits=True)
    token_agreement(f"TP batcher {name}", got[name], solo.tokens[0].tolist(),
                    solo.logits[0], stops)
  state = batchers["tp"]._cache["blocks.0.shard1"].rg_lru_state  # pylint: disable=protected-access
  log(f"  8-slot TP batcher, {TP_BATCH_REQUESTS} requests of "
      f"{TP_BATCH_PROMPT_RANGE} tokens, {TP_BATCH_STEPS} steps: {identical} "
      f"of {len(specs)} identical to the unsharded batcher's (the rest at a "
      f"near tie against solo Samplers); its recurrent state shard "
      f"{tuple(state.shape)}")
  if tuple(state.shape) != (BATCH_SLOTS, config.lru_width // TP_SHARDS):
    raise AssertionError("The TP batcher's cache is not split.")
  for b in batchers.values():
    for i in range(BATCH_SLOTS):
      b.add_request(specs[i]["prompt"], max_steps=200)
    b.step(BATCH_TICK)
  ticks = {side: [] for side in batchers}
  for side in TP_TURNS * (TP_TICK_REPEATS // 2):
    ms, _ = _timed_call(lambda: batchers[side].step(BATCH_TICK))
    ticks[side].append(ms / BATCH_TICK)
  log(f"  the steady 8-slot tick, ms a step in turns: "
      f"{ {s: [round(v, 3) for v in vs] for s, vs in ticks.items()} }")
  del batchers

  # (f) TP speculation against TP plain decode (JAX's cycling prompt).
  cycle = [f"w{i}" for i in range(8)]
  cycling = [" ".join(cycle[i % 8] for i in range(SPEC_PROMPT_TOKENS))]
  spec_probe = SpecProbe(_tp_counts)
  carry = CaptureFirstCall(lru_scan, "lru_scan_carries")
  try:
    spec = speculative.SpeculativeSampler(tp, SPEC_DRAFT, SPEC_NGRAM)
    spec_probe.reset()
    before = _tp_counts()
    out_spec = spec(cycling, TP_SPEC_STEPS)
    torch.cuda.synchronize()
    run = spec_probe.run_launches(_delta(before))
    step = spec_probe.step_launches
  finally:
    carry.restore()
    spec_probe.close()
  _add(total, run)
  plain = tp(cycling, TP_SPEC_STEPS, return_logits=True)
  agree = _agreement("TP speculative against TP plain", out_spec, plain,
                     stops)
  log(f"  TP SpeculativeSampler (draft {SPEC_DRAFT}): "
      f"{spec.last_stats['verify_steps']} verify steps, tokens per verify "
      f"step {spec.last_stats['tokens_per_verify_step']:.3f}; a verify step "
      f"launched {step}; tokens against TP plain decode {agree}")
  if step["lru_scan_carries"] != TP_SHARDS * n_rec:
    raise AssertionError(f"A TP verify step launched {step}.")
  carry_err, carry_shapes = _check_captured(
      carry, "lru_scan_carries",
      lambda x, a, h0: max_err(
          lru_scan.lru_scan_carries(x, a, h0)[0],
          lru_scan.lru_scan_plain(x, a, h0, y_in_acc_dtype=True)[0]))
  if carry_err > CARRY_MAX_ABS_ERR:
    raise AssertionError("The TP carry walk disagrees with its plain loop.")
  x, a, h0 = carry.args[:3]
  b, t, d = x.shape
  n_bytes = 2 * b * t * d * 2 + b * d * 4 + b * t * d * 4 + b * d * 4
  carry_fig = time_scan(lru_scan.lru_scan_carries, (x, a, h0), n_bytes,
                        2 * b * t * d)
  log(f"  lru_scan_carries at the shard shape {[b, t, d]}:")
  carry_fig["plain_ms"] = cuda_ms(lambda: lru_scan.lru_scan_plain(
      x, a, h0, y_in_acc_dtype=True), reps=5)
  log_scan(carry_fig, carry_fig["plain_ms"], n_bytes)
  by_name["lru_scan_carries"]["tp_shape"] = dict(shape=[b, t, d], **{
      key: carry_fig[key] for key in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "bound_share")})
  by_name["lru_scan_carries"]["max_abs_err"] = max(
      by_name["lru_scan_carries"]["max_abs_err"], carry_err)
  del tp, one, spec, carry
  torch.cuda.empty_cache()
  log(f"== phase 25 {time.perf_counter() - phase_start:.1f} s; its launches "
      f"{total}")
  return total


# -- phase 26: tensor-parallel training -----------------------------------------

# The meshes of phase 26, each repeating the card: TP-2 (gradients, then
# train_loop in turns with the unsharded loop), DP x TP (2, 2) (row 1 of
# the batch is padded after 3000 tokens, so the two data rows hold
# different target counts: the check of the global token-weighted mean) and
# TP-4 (the 10 gate heads replicate; 3 covering query heads a shard).
TPT_MESHES = (("TP-2", (1, 2)), ("DP x TP (2, 2)", (2, 2)), ("TP-4", (1, 4)))
TPT_STEPS = 3
TPT_TURNS = ("one", "tp", "tp", "one")
TPT_LORA_RANK = 8
# lora_b's std in the QLoRA check: nonzero, so lora_a takes a gradient.
# (Phase 24 needed 2.0 to move a greedy text; a gradient needs none of that,
# and small adapters keep the bf16 activations where the base has them.)
TPT_LORA_B_STD = 0.02
# The loss's vocabulary chunks at 4096 tokens (4095 targets a row).
TPT_LOSS_CHUNKS = 2
TPT_NAMES = ("lru_scan", "lru_scan_backward", "window_attention",
             "window_attention_dq", "window_attention_dkv",
             "int8_weight_matmul", "int8_weight_matmul_wgmma",
             "int8_weight_matmul_dgrad_wgmma")


def _tpt_counts() -> dict[str, int]:
  return {**_launch_counts(),
          "int8_weight_matmul": int8_matmul.launches,
          "int8_weight_matmul_wgmma": int8_matmul.wgmma_launches,
          "int8_weight_matmul_dgrad_wgmma": int8_matmul.dgrad_wgmma_launches}


def _tpt_delta(before: dict[str, int]) -> dict[str, int]:
  return {k: v - before[k] for k, v in _tpt_counts().items()}


def _tpt_per_step(shards: int, n_rec: int, n_att: int) -> dict[str, int]:
  """One training step's scan and attention launches over ``shards``
  model-axis shards in all (the rows times the model axis): each block's
  forward twice (remat), its backward once."""
  return {"lru_scan": 2 * shards * n_rec,
          "lru_scan_backward": shards * n_rec,
          "window_attention": 2 * shards * n_att,
          "window_attention_dq": shards * n_att,
          "window_attention_dkv": shards * n_att}


def _int8_layers(blocks) -> int:
  return sum(hasattr(m, "kernel_q") or hasattr(m, "w_q")
             for m in blocks.modules())


class _TrainingCaptures:
  """The first call's inputs of each training kernel of a run."""

  NAMES = ((lru_scan, "lru_scan_forward"), (lru_scan, "lru_scan_backward"),
           (wa, "window_attention_forward"), (wa, "window_attention_dq"),
           (wa, "window_attention_dkv"))

  def __init__(self, skip: dict[str, int] | None = None):
    """``skip``: calls of a kernel to let pass before the one kept."""
    skip = skip or {}
    self.captures = {name: CaptureFirstCall(module, name, skip.get(name, 0))
                     for module, name in self.NAMES}

  def restore(self):
    for capture in self.captures.values():
      capture.restore()

  def __getitem__(self, name):
    capture = self.captures[name]
    if capture.args is None:
      raise AssertionError(f"The TP training path never called {name}.")
    return capture.args


def _unsharded_gradients(model, tokens, mask, lora: bool = False):
  """One batch's loss and gradients (by name) on the unsharded model."""
  params = (sft_lora.lora_parameters(model) if lora
            else list(model.parameters()))
  model.zero_grad(set_to_none=True)
  with trainer.trainable_only(model, params):
    loss = trainer.accumulate_gradients(model, 0, tokens, mask)
  grads = {n: p.grad for n, p in model.named_parameters()
           if p.grad is not None}
  model.zero_grad(set_to_none=True)
  return loss.item(), grads


def _sharded(model, mesh, lora: bool = False):
  """``model`` placed over ``mesh`` by the sharded steps' own placement."""
  state = model.state_dict()
  if lora:
    factory = lambda p: sft_lora.make_optimizer(  # pylint: disable=g-long-lambda
        sft_lora.lora_parameters(p), SFT_LEARNING_RATE)
    adapters, base = sft_lora.split_lora(state)
    _, shard_fn = sft_lora.make_sharded_lora_step(model, factory, mesh, 0,
                                                  adapters, base)
    return shard_fn(adapters, base)
  factory = lambda p: trainer.make_optimizer(p, TRAIN_LEARNING_RATE)
  _, shard_params = trainer.make_sharded_train_step(model, factory, mesh, 0,
                                                    example_params=state)
  return shard_params(state)


def _sharded_gradients(sharded, tokens, mask):
  """One batch's loss, reduced gradients (whole leaves by name), launches,
  ms of the forward and backward (the first call: it includes allocating
  the gradients) and peak GB over the sharded model."""
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  before = _tpt_counts()
  reset_scan_routes()
  start = time.perf_counter()
  loss = trainer.sharded_accumulate_gradients(sharded, 0, tokens, mask)
  sharded.reduce_gradients()
  torch.cuda.synchronize()
  ms = (time.perf_counter() - start) * 1e3
  launches = _tpt_delta(before)
  check_scan_routes(launches["lru_scan"] + launches["lru_scan_backward"])
  peak_gb = torch.cuda.max_memory_allocated() / 1e9
  grads = sharded.gradients()
  sharded.zero_grad()
  return loss.item(), grads, launches, ms, peak_gb


def _hold_gradients(label: str, loss: float, grads: dict, want_loss: float,
                    want: dict) -> None:
  """The sharded step's loss and every leaf's gradient against the
  unsharded one's: the smoke's gradient rule."""
  rel_loss = abs(loss - want_loss) / abs(want_loss)
  if set(grads) != set(want):
    raise AssertionError(f"{label}: gradients of {sorted(set(grads) ^ set(want))[:4]} "
                         f"on one side only.")
  stats = _leaf_stats(grads, want)
  log(f"  {label}: loss {loss:.6f} vs unsharded {want_loss:.6f} (rel "
      f"{rel_loss:.2e}, tolerance {MODEL_LOSS_REL_ERR}); {len(stats)} "
      f"leaves, limits rel_rms <= {GRAD_LEAF_REL_RMS}, cosine >= "
      f"{GRAD_LEAF_MIN_COSINE}")
  _log_leaf_stats(f"{label} vs unsharded", stats)
  bad = [s for s in stats
         if not (s[0] <= GRAD_LEAF_REL_RMS and s[1] >= GRAD_LEAF_MIN_COSINE)]
  if not (np.isfinite(loss) and rel_loss <= MODEL_LOSS_REL_ERR) or bad:
    raise AssertionError(f"{label} and unsharded gradients disagree: "
                         f"{bad[:5]}.")


def _hold_kernels(label: str, captures: _TrainingCaptures, rows: dict,
                  time_them: bool,
                  shapes_key: str = "tp_training_shapes") -> None:
  """Each training kernel against its plain version on the first inputs
  the run gave it: the scans bit for bit, dq / dk / dv within
  ATTN_BWD_REL_ERR of the largest gradient; with ``time_them``, each timed
  at those shapes beside its plain version and its bound (into each row's
  ``shapes_key`` list)."""
  x, a, h0, reverse = captures["lru_scan_forward"][:4]
  g, ga, dh_last, g_reverse = captures["lru_scan_backward"][:4]
  q, k, v, seg, window, kv_prefix = captures["window_attention_forward"][:6]
  dq_args = captures["window_attention_dq"]
  errs = {"lru_scan": check_lru(x, a, h0, reverse),
          "lru_scan_backward": check_lru_backward(g, ga, dh_last, g_reverse),
          "window_attention": max(check_attention(q, k, v, seg, window,
                                                  kv_prefix)),
          "window_attention_dq": check_dq(*dq_args),
          "window_attention_dkv": check_dkv(*captures["window_attention_dkv"])}
  log(f"  {label} kernels vs plain at lru {list(x.shape)}, attention q "
      f"{list(q.shape)} (dq/dkv q {list(dq_args[0].shape)}): {errs}")
  for name, err in errs.items():
    rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
  if not time_them:
    return
  b, t, d = x.shape
  n_bytes = 3 * b * t * d * 2 + b * d * 4
  f = time_scan(lru_scan.lru_scan_forward, (x, a), n_bytes, 2 * b * t * d)
  f["plain_ms"] = cuda_ms(lambda: lru_scan.lru_scan_plain(x, a), reps=1)
  log(f"  lru_scan at {label}'s shard shape {[b, t, d]}:")
  log_scan(f, f["plain_ms"], n_bytes)
  rows["lru_scan"][shapes_key].append(dict(
      mesh=label, shape=[b, t, d], **{key: f[key] for key in (
          "ms", "plain_ms", "bound_ms", "bound_by", "bound_share")}))
  n_bytes = 3 * b * t * d * 2 + 2 * b * d * 4
  f = time_scan(lambda g_, a_: lru_scan.lru_scan_backward(  # pylint: disable=g-long-lambda
      g_, a_, dh_last, g_reverse), (g, ga), n_bytes, 2 * b * t * d)
  f["plain_ms"] = cuda_ms(lambda: lru_scan.lru_scan_backward_plain(
      g, ga, dh_last, g_reverse), reps=2)
  log(f"  lru_scan_backward at {label}'s shard shape {[b, t, d]}:")
  log_scan(f, f["plain_ms"], n_bytes)
  rows["lru_scan_backward"][shapes_key].append(dict(
      mesh=label, shape=[b, t, d], **{key: f[key] for key in (
          "ms", "plain_ms", "bound_ms", "bound_by", "bound_share")}))
  f = window_forward_figures(q, k, v, seg, kv_prefix)
  log_figures(f"window_attention at {label}'s shard shape {list(q.shape)}", f)
  rows["window_attention"][shapes_key].append(dict(
      mesh=label, shape=list(q.shape), **{key: f[key] for key in (
          "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
          "bound_share")}))
  for row in backward_rows(dq_args, errs["window_attention_dq"],
                           errs["window_attention_dkv"], f" ({label})"):
    name = row["name"].split(" ")[0]
    rows[name][shapes_key].append(dict(
        mesh=label, shape=list(dq_args[0].shape), **{key: row[key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "bound_share")}))


def _hold_int8(forward_capture, dgrad_capture, config, rows: dict) -> None:
  """Both int8 kernels against their plain versions on the first inputs of
  each shape the QLoRA TP-2 step gave them, and timed at the shard shapes:
  the row-parallel pieces (K = lru / 2 and mlp / 2), a column-parallel one
  (N = lru / 2), the fused up-projection's shared activation and the
  vocabulary shard's logits."""
  half = TP_SHARDS
  timed = {(1, config.width, config.lru_width // half),
           (1, config.width, config.mlp_expanded_width // half),
           (1, config.lru_width // half, config.width),
           (2, config.mlp_expanded_width // half, config.width),
           (1, config.vocab_size // half, config.width)}
  row = rows["int8_weight_matmul_wgmma"]
  for key, args in forward_capture.inputs():
    row["max_abs_err"] = max(row["max_abs_err"], check_int8(*args))
    if key[:3] not in timed:
      continue
    f = int8_figures(*args)
    log(f"  int8_weight_matmul_wgmma at the shard shape a "
        f"{tuple(args[0].shape)}{' (shared)' if key[-1] else ''} x q "
        f"{tuple(args[1].shape)}: ms {f['ms']:.4f}  plain {f['plain_ms']:.4f}"
        f"  dequant {f['dequant_ms']:.4f}  bf16 {f['bf16_ms']:.4f}  bound "
        f"{f['bound_ms']:.4f} ({f['bound_by']}): "
        f"{100 * f['bound_ms'] / f['ms']:.1f}% of the bound")
    row["tp_training_shapes"].append(dict(
        mesh="QLoRA TP-2", shape=[key[3], key[2], key[1]], batches=key[0],
        **{k: f[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "dequant_ms")}))
  log(f"  int8_weight_matmul_wgmma on the QLoRA TP-2 step's "
      f"{len(forward_capture.calls)} shapes: max_abs_err {row['max_abs_err']:.3e}")
  row = rows["int8_weight_matmul_dgrad_wgmma"]
  for key, args in dgrad_capture.inputs():
    row["max_abs_err"] = max(row["max_abs_err"], check_int8_dgrad(*args))
    if key[:3] not in timed:
      continue
    f = int8_dgrad_figures(*args)
    log(f"  int8_weight_matmul_dgrad_wgmma at the shard shape g "
        f"{tuple(args[0].shape)} x q {tuple(args[1].shape)}: ms "
        f"{f['ms']:.4f} ({f['tflops']:.1f} TFLOP/s)  plain "
        f"{f['plain_ms']:.4f}  library {f['library_ms']:.4f}  bound "
        f"{f['bound_ms']:.4f} ({f['bound_by']}): "
        f"{100 * f['bound_ms'] / f['ms']:.1f}% of the bound")
    row["tp_training_shapes"].append(dict(
        mesh="QLoRA TP-2", shape=[key[3], key[1], key[2]], batches=key[0],
        **{k: f[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms")}))
  log(f"  int8_weight_matmul_dgrad_wgmma on the step's "
      f"{len(dgrad_capture.calls)} shapes: max_abs_err {row['max_abs_err']:.3e}")
  forward_capture.calls.clear()
  dgrad_capture.calls.clear()


def phase_tp_training(dev, handoff: dict) -> dict[str, dict]:
  """Tensor-parallel training on a copy of phase 18's 2B and on its int8
  copy with rank-8 adapters, over meshes that repeat the card, at the
  training cell's batch (2 x 4096, row 1 padded after 3000, remat on):
  one step's loss and gradients against the unsharded model's on TP-2,
  DP x TP (2, 2) and TP-4; train_loop(mesh=) on TP-2 in turns with the
  unsharded loop; one QLoRA TP-2 step's adapter gradients against the
  unsharded QLoRA step's. Each kernel held against its plain version on the
  inputs the path gave it and timed at the new shard shapes. Returns the
  phase's rows: {name: launches, max_abs_err, tp_training_shapes}."""
  phase_start = time.perf_counter()
  base, qbase = handoff["model"], handoff["qmodel"]
  config = base.config
  n_rec = sum(bt is common.TemporalBlockType.RECURRENT
              for bt in config.block_types)
  n_att = config.num_layers - n_rec
  rows = {name: dict(launches=0, max_abs_err=0.0, tp_training_shapes=[])
          for name in TPT_NAMES}
  batch = training_batch(config.vocab_size)
  tokens = torch.as_tensor(batch.input_tokens, device=dev).long()
  mask = torch.as_tensor(batch.target_mask, device=dev)
  real_tokens = sum(TRAIN_REAL_TOKENS)
  model = griffin.Griffin(config, device="meta", dtype=torch.bfloat16)
  model.to_empty(device=dev)
  model.load_state_dict(base.state_dict())
  log(f"== phase 26: tensor-parallel training of a copy of phase 18's 2B, "
      f"batch 2 x {TRAIN_TOKENS} (row 1 padded after "
      f"{TRAIN_REAL_TOKENS[1]}), remat on; the meshes repeat the card, so "
      f"no speed-up is possible")

  # (a-c) One step's loss and gradients on each mesh against the unsharded
  # model's on the same batch.
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  start = time.perf_counter()
  want_loss, want = _unsharded_gradients(model, tokens, mask)
  torch.cuda.synchronize()
  log(f"  unsharded: loss {want_loss:.6f}, {len(want)} gradient leaves, "
      f"{(time.perf_counter() - start) * 1e3:.1f} ms (the process's first "
      f"training step of this model: warm-up), peak "
      f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (the sharded runs' "
      f"peaks below hold these gradients too: "
      f"{sum(g.numel() * g.element_size() for g in want.values()) / 1e9:.2f}"
      f" GB)")
  for label, shape in TPT_MESHES:
    mesh = sharding.make_mesh(shape, ("data", "model"),
                              devices=[dev] * (shape[0] * shape[1]))
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    sharded = _sharded(model, mesh)
    tp = sharded.rows[0]
    att = next(b.temporal for b in tp.blocks if not b.recurrent)
    log(f"  {label} {mesh}: placed, +"
        f"{torch.cuda.memory_allocated() / 1e9 - base_gb:.3f} GB (bf16 "
        f"pieces are views of the model's weights); gates split "
        f"{tp.blocks[0].temporal.gates_split}; query heads a shard "
        f"{(att.cover[0][1] - att.cover[0][0]) // att.head_dim}")
    del tp, att
    captures = _TrainingCaptures()
    try:
      loss, grads, launches, ms, peak_gb = _sharded_gradients(sharded, tokens,
                                                              mask)
    finally:
      captures.restore()
    shards = shape[0] * shape[1]
    want_launches = _tpt_per_step(shards, n_rec, n_att)
    log(f"  {label} step (forward and backward, reduced): {ms:.1f} ms, peak "
        f"{peak_gb:.2f} GB; launched {launches}")
    if any(launches[k] != v for k, v in want_launches.items()):
      raise AssertionError(f"{label} launched {launches}, want "
                           f"{want_launches}.")
    add_launches(rows, launches)
    _hold_gradients(label, loss, grads, want_loss, want)
    del grads, sharded
    _hold_kernels(label, captures, rows, time_them=True)
    del captures
    torch.cuda.empty_cache()
  del want

  # (a) train_loop(mesh=) on TP-2, in turns with the unsharded loop, each
  # turn from the copy's first weights (a fresh AdamW restarted on trained
  # weights moves them by ~lr each and the loss jumps).
  mesh = _tp_mesh(dev, TP_SHARDS)
  cfg = train_loop_lib.TrainingConfig(
      learning_rate=TRAIN_LEARNING_RATE, eval_every_n=1, max_steps=TPT_STEPS,
      checkpoint_every_n=None)
  turns = {"one": [], "tp": []}
  for side in TPT_TURNS:
    model.load_state_dict(base.state_dict())
    clock = StageClock()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = _tpt_counts()
    train_loop_lib.train_loop(model, [batch] * TPT_STEPS, cfg,
                              log_metrics=clock, device=dev,
                              mesh=mesh if side == "tp" else None)
    torch.cuda.synchronize()
    launches = _tpt_delta(before)
    turns[side].append(clock.summary(
        f"train_loop {'TP-2' if side == 'tp' else 'unsharded'}, "
        f"{TPT_STEPS} steps", real_tokens,
        torch.cuda.max_memory_allocated() / 1e9))
    if side == "tp":
      want_launches = {k: TPT_STEPS * v for k, v in
                       _tpt_per_step(TP_SHARDS, n_rec, n_att).items()}
      if any(launches[k] != v for k, v in want_launches.items()):
        raise AssertionError(f"train_loop(mesh=) launched {launches}, want "
                             f"{want_launches}.")
      add_launches(rows, launches)
    torch.cuda.empty_cache()
  first = [s["losses"][0] for stats in turns.values() for s in stats]
  if not max(first) - min(first) <= MODEL_LOSS_REL_ERR * abs(first[0]):
    raise AssertionError(f"The turns' first losses differ: {first}.")
  steady = {side: float(np.mean([s["steady_ms"] for s in stats]))
            for side, stats in turns.items()}
  log(f"  train_loop steady ms a step in turns {TPT_TURNS}: unsharded "
      f"{[round(s['steady_ms'], 1) for s in turns['one']]}, TP-2 "
      f"{[round(s['steady_ms'], 1) for s in turns['tp']]}: TP-2 / unsharded "
      f"{steady['tp'] / steady['one']:.3f}; peak GB unsharded "
      f"{[round(s['peak_gb'], 2) for s in turns['one']]}, TP-2 "
      f"{[round(s['peak_gb'], 2) for s in turns['tp']]}")
  del model
  torch.cuda.empty_cache()

  # (d) QLoRA TP-2 over the int8 copy's own tensors (frozen; phases 23-24
  # see them unchanged), fresh rank-8 adapters with lora_b nonzero.
  qmodel = griffin.Griffin(config, device="meta", quantized=True,
                           lora_rank=TPT_LORA_RANK)
  gen = torch.Generator(dev).manual_seed(SEED + 130)
  adapters = sft_lora.init_adapters(qmodel, gen)
  for name, leaf in adapters.items():
    if name.endswith("lora_b"):
      leaf.normal_(0.0, TPT_LORA_B_STD, generator=gen)
  qmodel.load_state_dict(sft_lora.merge_params(qbase.state_dict(), adapters),
                         assign=True)
  del adapters
  before = _tpt_counts()
  torch.cuda.synchronize()
  start = time.perf_counter()
  want_loss, want = _unsharded_gradients(qmodel, tokens, mask, lora=True)
  torch.cuda.synchronize()
  one_launches = _tpt_delta(before)
  log(f"  QLoRA unsharded: loss {want_loss:.6f}, "
      f"{(time.perf_counter() - start) * 1e3:.1f} ms; launched "
      f"{one_launches}")
  torch.cuda.synchronize()
  base_gb = torch.cuda.memory_allocated() / 1e9
  sharded = _sharded(qmodel, mesh, lora=True)
  torch.cuda.synchronize()
  log(f"  QLoRA TP-2 placed: +"
      f"{torch.cuda.memory_allocated() / 1e9 - base_gb:.3f} GB (int8 pieces "
      f"made contiguous once, for the kernels' TMA)")
  forward_capture = CaptureInt8Calls(host=True)
  dgrad_capture = CaptureDgradCalls()
  captures = _TrainingCaptures()
  try:
    loss, grads, launches, ms, peak_gb = _sharded_gradients(sharded, tokens,
                                                            mask)
  finally:
    captures.restore()
    dgrad_capture.restore()
    forward_capture.restore()
  tp = sharded.rows[0]
  want_wgmma = (2 * _int8_layers(tp.blocks)
                + 2 * TPT_LOSS_CHUNKS * len(tp.embedder.s.shards))
  want_one = 2 * _int8_layers(qmodel.blocks) + 2 * TPT_LOSS_CHUNKS
  log(f"  QLoRA TP-2 step: {ms:.1f} ms, peak {peak_gb:.2f} GB; launched "
      f"{launches} (int8 forward want {want_wgmma}: each shard's int8 layers "
      f"twice (remat), the {TPT_LOSS_CHUNKS} loss chunks' logits twice a "
      f"shard; unsharded {one_launches['int8_weight_matmul_wgmma']}, want "
      f"{want_one})")
  want_launches = _tpt_per_step(TP_SHARDS, n_rec, n_att)
  if (any(launches[k] != v for k, v in want_launches.items())
      or launches["int8_weight_matmul_wgmma"] != want_wgmma
      or one_launches["int8_weight_matmul_wgmma"] != want_one
      or launches["int8_weight_matmul"]
      or not launches["int8_weight_matmul_dgrad_wgmma"]):
    raise AssertionError(f"QLoRA TP-2 launched {launches}; want "
                         f"{want_launches}, {want_wgmma} int8 wgmma, the "
                         f"input gradient's > 0 and no mma.sync.")
  add_launches(rows, launches)
  _hold_gradients("QLoRA TP-2 adapters", loss, grads, want_loss, want)
  del grads, want, sharded, tp
  _hold_kernels("QLoRA TP-2", captures, rows, time_them=False)
  _hold_int8(forward_capture, dgrad_capture, config, rows)
  del captures, qmodel
  torch.cuda.empty_cache()
  log(f"== phase 26 {time.perf_counter() - phase_start:.1f} s; its launches "
      f"{ {k: r['launches'] for k, r in rows.items()} }")
  return rows


# -- phase 27: the sharded towers, TP multi-LoRA and the TP export ------------

# Phase 27 runs on phase 18's models (the realistic_params 2B, its towers)
# over meshes that repeat the one H100: shard shapes, launches and
# agreement with the unsharded path, never a speed-up.
TPX_TURNS = ("one", "tp", "tp", "one")
TPX_LORA_RANK = 8
# lora_b's std: phase 24's, at which adapters change the random 2B's greedy
# text (tools/adapter_std_sweep.py).
TPX_LORA_B_STD = CLI_ADAPTER_B_STD
TPX_ML_REQUESTS = 8
TPX_ML_STEPS = 16
TPX_ML_KINDS = ("a", "b", "none", "a")
# Float32 copies of the LoRA model, TP-2 against unsharded along the same
# tokens: the summation order alone (2.5e-6 on the CPU at lora_b std 2.0;
# a zeroed adapter piece moves them by ~1: tools/tp_lora_noise.py).
TPX_F32_LOGITS_REL_RMS = 1e-3
TPX_TICK_REPEATS = 4
# The TP export holds the 2B's first three blocks (R, R, A) at its full
# width: tracing and loading take time in proportion to the depth, and the
# whole smoke must stay inside its time limit.
TPX_EXPORT_BLOCKS = 3
# Each tower block's four products, DINOv2-L's 23 blocks and SigLIP's 23.
TPX_TOWER_KERNELS = ("attn_qkv", "attn_proj", "mlp_fc1", "mlp_fc2")


def _tpx_counts() -> dict[str, int]:
  return {"mha_attention": mha_attention.launches,
          "lru_scan": lru_scan.launches, "window_attention": wa.launches,
          "add_rmsnorm": fused_epilogue.launches,
          "int8_weight_matmul": int8_matmul.launches,
          "int8_weight_matmul_wgmma": int8_matmul.wgmma_launches}


def _tpx_delta(before: dict[str, int]) -> dict[str, int]:
  return {k: v - before[k] for k, v in _tpx_counts().items()}


class CaptureByShape:
  """Stands in for ``mha_attention.flash_mha_attention`` and keeps a copy
  of its inputs at the first call of each shape, with their strides (the
  head groups' views of the gathered qkv)."""

  def __init__(self):
    self.wrapper = mha_attention.flash_mha_attention
    self.inputs = {}
    mha_attention.flash_mha_attention = self

  def __call__(self, q, k, v):
    if tuple(q.shape) not in self.inputs:
      self.inputs[tuple(q.shape)] = tuple(
          torch.empty_strided(z.shape, z.stride(), dtype=z.dtype,
                              device=z.device).copy_(z) for z in (q, k, v))
    return self.wrapper(q, k, v)

  def restore(self):
    mha_attention.flash_mha_attention = self.wrapper


class ImageClock:
  """CUDA events at an encoder's start and end and at the end of a model's
  first forward after it: encode ms and pixels -> first-token logits ms."""

  def __init__(self, encoder, model):
    self.marks = {}
    event = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731

    def mark(name):
      def hook(*_):
        if name != "prefill" or "prefill" not in self.marks:
          self.marks[name] = event()
          self.marks[name].record()
      return hook

    self.hooks = [encoder.register_forward_pre_hook(mark("start")),
                  encoder.register_forward_hook(mark("encoded")),
                  model.register_forward_hook(mark("prefill"))]

  def reset(self):
    self.marks.clear()

  def read(self) -> tuple[float, float]:
    self.marks["prefill"].synchronize()
    start = self.marks["start"]
    return (start.elapsed_time(self.marks["encoded"]),
            start.elapsed_time(self.marks["prefill"]))

  def close(self):
    for hook in self.hooks:
      hook.remove()


def _mha_figures(q, k, v) -> dict:
  """The MHA kernel at a shard's head group, on inputs with the path's
  strides: device ms (queue full), the plain version, one SDPA call, the
  bound."""
  b, t, n, h = q.shape
  kernel = lambda: mha_attention.mha_attention_forward(q, k, v)  # noqa: E731
  qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
  ms = device_ms(kernel, 20)
  plain_ms = device_ms(lambda: mha_attention.mha_attention_plain(q, k, v), 3)
  library_ms = device_ms(
      lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt),
      20)
  flops = 4 * b * n * t * t * h
  bound_ms, bound_by = bound(4 * b * t * n * h * 2, flops, BF16_TENSOR_FLOPS)
  return dict(shape=[b, t, n, h], ms=ms, plain_ms=plain_ms,
              library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
              bound_share=bound_ms / ms)


def _split_tower_kernels(tp_encoder, encoder) -> tuple[int, int]:
  """(kernels whose shards each hold a piece smaller than the leaf, of
  those the pieces that are views of the encoder's own weights)."""
  full = dict(encoder.named_parameters())
  split = views = 0
  for tower in ("dino", "siglip"):
    for i, block in enumerate(getattr(tp_encoder, tower).blocks):
      for name in TPX_TOWER_KERNELS:
        leaf = full[f"{tower}.block{i}.{name}.kernel"]
        pieces = [s.kernel for s in getattr(block, name).shards]
        split += len(pieces) > 1 and all(
            p.numel() * len(pieces) == leaf.numel() for p in pieces)
        views += all(p.untyped_storage().data_ptr()
                     == leaf.untyped_storage().data_ptr() for p in pieces)
  return split, views


def _set_act_quant(encoder, flag: bool) -> None:
  for module in encoder.modules():
    if getattr(module, "quantized", False) and hasattr(module, "act_quant"):
      module.act_quant = flag


def _tpx_towers(dev, handoff, rows, total) -> None:
  """(a) The sharded towers: TP-2 and TP-4 encodes against the unsharded
  one, the MHA kernel at each shard's head group, a TP-2 ModalSampler from
  pixels to 32 greedy tokens against the unsharded one (launches, first
  shard calls against their plain versions, encode and pixels -> first
  token ms in turns), the int8 towers."""
  model, encoder, vocab = (handoff[k] for k in ("model", "encoder", "vocab"))
  config = model.config
  n_blocks = len(encoder.dino.blocks) + len(encoder.siglip.blocks)
  n_rec = sum(bt is common.TemporalBlockType.RECURRENT
              for bt in config.block_types)
  stops = {vocab.eos_id()}
  rng = np.random.default_rng(SEED + 270)
  prompts = [" ".join(f"w{i}" for i in rng.integers(
      0, config.vocab_size - 4, MM_PROMPT_TOKENS - 1)) for _ in range(2)]
  pixels = torch.rand(MM_PIXELS, device=dev,
                      generator=torch.Generator(dev).manual_seed(SEED + 271))
  mesh = _tp_mesh(dev, TP_SHARDS)
  one = modal_sampler.ModalSampler(model, vocab, encoder, device=dev)
  torch.cuda.synchronize()
  base_gb = torch.cuda.memory_allocated() / 1e9
  start = time.perf_counter()
  tp = modal_sampler.ModalSampler(model, vocab, encoder, mesh=mesh)
  torch.cuda.synchronize()
  split, views = _split_tower_kernels(tp.vision_encoder, encoder)
  log(f"  TP-2 ModalSampler placed in {time.perf_counter() - start:.2f} s: +"
      f"{torch.cuda.memory_allocated() / 1e9 - base_gb:.3f} GB (float32 "
      f"tower pieces and bf16 LM pieces are views); {split} of "
      f"{len(TPX_TOWER_KERNELS) * n_blocks} tower kernels split, {views} "
      f"of them views of the encoder's weights")
  if split != len(TPX_TOWER_KERNELS) * n_blocks or views != split:
    raise AssertionError("The TP towers' kernels are not split as views.")

  # Encodes: TP-2 (and its MHA calls by shape), TP-4, unsharded.
  features = {}
  with torch.inference_mode():
    features["one"] = one.encode(pixels)
    capture = CaptureByShape()
    copies = mha_attention.strided_copies
    try:
      before = _tpx_counts()
      features["tp"] = tp.encode(pixels)
      torch.cuda.synchronize()
      launches = _tpx_delta(before)
    finally:
      capture.restore()
    copies = mha_attention.strided_copies - copies
    _add(total, launches)
    tp4 = tensor_parallel.tensor_parallel_encoder(encoder,
                                                  _tp_mesh(dev, TP4_SHARDS))
    capture4 = CaptureByShape()
    try:
      before = _tpx_counts()
      features["tp4"] = tp4(pixels).to(torch.bfloat16)
      torch.cuda.synchronize()
      launches4 = _tpx_delta(before)
    finally:
      capture4.restore()
    _add(total, launches4)
  rel = {k: _rel_rms(features[k], features["one"]) for k in ("tp", "tp4")}
  log(f"  encode [{', '.join(map(str, MM_PIXELS))}] pixels: TP-2 launched "
      f"{launches['mha_attention']} MHA ({copies} inputs copied), TP-4 "
      f"{launches4['mha_attention']}; features rel. RMS against unsharded "
      f"TP-2 {rel['tp']:.3e}, TP-4 {rel['tp4']:.3e} (tolerance "
      f"{MM_FEATURES_REL_RMS}); shapes {sorted(capture.inputs)}")
  if (launches["mha_attention"] != TP_SHARDS * n_blocks
      or launches4["mha_attention"] != TP4_SHARDS * n_blocks or copies
      or not max(rel.values()) <= MM_FEATURES_REL_RMS):
    raise AssertionError("The sharded encodes disagree.")
  worst, figures = 0.0, []
  for shape, (q, k, v) in sorted({**capture.inputs,
                                  **capture4.inputs}.items()):
    err = check_mha(q, k, v)
    worst = max(worst, err)
    f = _mha_figures(q, k, v)
    figures.append(f)
    log(f"  mha_attention at the shard's head group {list(shape)} (strides "
        f"{q.stride()}): max_abs_err {err:.3e}; ms {f['ms']:.4f}, plain "
        f"{f['plain_ms']:.3f}, SDPA {f['library_ms']:.4f}, bound "
        f"{f['bound_ms']:.5f} ({f['bound_by']}, "
        f"{100 * f['bound_share']:.1f}%)")
  rows["mha_attention"]["max_abs_err"] = max(
      rows["mha_attention"]["max_abs_err"], worst)
  rows["mha_attention"]["tp_shapes"] = figures
  del capture, capture4, tp4, features

  # Pixels -> 32 greedy tokens, TP-2 against unsharded; the warm-up captures
  # the decode step and keeps each text kernel's first shard call.
  run_kw = dict(total_generation_steps=MM_DECODE_STEPS, pixels=pixels,
                return_logits=True, end_sampling_at_eos_token=False)
  # The probe sees the TP step's capture last: its launches a replay.
  probe = DecodeProbe(_tpx_counts)
  clocks = {"tp": ImageClock(tp.vision_encoder, tp.model),
            "one": ImageClock(encoder, model)}
  try:
    one(prompts, **run_kw)
    captures = [CaptureFirstCall(lru_scan, "lru_scan"),
                CaptureFirstCall(wa, "window_attention"),
                CaptureFirstCall(fused_epilogue, "fused_add_rmsnorm")]
    try:
      tp(prompts, **run_kw)
    finally:
      for capture in captures:
        capture.restore()
    probe.reset()
    reset_scan_routes()
    before = _tpx_counts()
    out_tp = tp(prompts, **run_kw)
    torch.cuda.synchronize()
    run = probe.run_launches(_tpx_delta(before))
    check_scan_routes(run["lru_scan"])
    _add(total, run)
    want = dict(mha_attention=TP_SHARDS * n_blocks,
                lru_scan=TP_SHARDS * n_rec,
                window_attention=TP_SHARDS * (config.num_layers - n_rec),
                add_rmsnorm=config.num_layers * MM_DECODE_STEPS)
    log(f"  TP-2 ModalSampler, 2 x {MM_PROMPT_TOKENS} tokens + pixels, "
        f"{MM_DECODE_STEPS} greedy steps ({probe.replays} replays): launched "
        f"{run}")
    if any(run[k] != n for k, n in want.items()):
      raise AssertionError(f"TP-2 image run launched {run}, want {want}.")
    out_one = one(prompts, **run_kw)
    first_rel = max(_rel_rms(a[0], b[0])
                    for a, b in zip(out_tp.logits, out_one.logits))
    agree = _agreement("TP-2 image run against unsharded", out_tp, out_one,
                       stops)
    log(f"  first-token logits rel. RMS {first_rel:.3e} (tolerance "
        f"{MM_LOGITS_REL_RMS}); tokens {agree}")
    if not first_rel <= MM_LOGITS_REL_RMS:
      raise AssertionError("TP-2 and unsharded first-token logits disagree.")
    samplers = {"tp": tp, "one": one}
    turns = {side: [] for side in samplers}
    for side in TPX_TURNS:
      clocks[side].reset()
      probe.reset()
      samplers[side](prompts, **run_kw)
      turns[side].append((*clocks[side].read(), probe.decode_ms()))
    for side, got in turns.items():
      log(f"  {side}: encode ms {[round(r[0], 2) for r in got]}, pixels -> "
          f"first token ms {[round(r[1], 2) for r in got]}, captured decode "
          f"ms a step {[round(r[2], 3) for r in got]}")
  finally:
    probe.close()
    for clock in clocks.values():
      clock.close()

  # The text kernels' first shard calls of the image prefill, against their
  # plain versions and timed at those shapes.
  checks = (("lru_scan", check_lru), ("window_attention",
                                      lambda *a: max(check_attention(*a))),
            ("add_rmsnorm", check_add_rmsnorm))
  for capture, (name, check) in zip(captures, checks):
    err, shapes = _check_captured(capture, name, check)
    rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
    if name == "lru_scan":
      x, a = capture.args[:2]
      b, t, d = x.shape
      n_bytes = 3 * b * t * d * 2 + b * d * 4
      f = time_scan(lru_scan.lru_scan_forward, (x, a), n_bytes, 2 * b * t * d)
      f["plain_ms"] = cuda_ms(lambda: lru_scan.lru_scan_plain(x, a), reps=1)
      log(f"  lru_scan at the image prefill's shard shape {[b, t, d]}:")
      log_scan(f, f["plain_ms"], n_bytes)
      rows[name]["tp_image_shape"] = dict(shape=[b, t, d], **{
          key: f[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")})
    elif name == "window_attention":
      f = window_forward_figures(*capture.args[:4])
      log_figures(f"window_attention at the image prefill's shard shape "
                  f"{shapes[0]}", f)
      rows[name]["tp_image_shape"] = dict(shape=list(shapes[0]), **{
          key: f[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                   "bound_by")})
  del captures, out_tp, out_one

  # The int8 towers (phase 18's: quantize_params, act_quant) on TP-2, and
  # the same towers weight-only (row 10's wgmma route at the shard shapes).
  qencoder = vit.DinoSigLIPEncoder(encoder.dino_config, encoder.siglip_config,
                                   device="meta", quantized=True,
                                   act_quant=True)
  qencoder.to_empty(device=dev)
  qencoder.load_state_dict(quantization.quantize_params(encoder.state_dict()))
  torch.cuda.synchronize()
  base_gb = torch.cuda.memory_allocated() / 1e9
  qtp = tensor_parallel.tensor_parallel_encoder(qencoder, mesh)
  torch.cuda.synchronize()
  placed_gb = torch.cuda.memory_allocated() / 1e9 - base_gb
  int8_cap = CaptureInt8Calls()
  try:
    with torch.inference_mode():
      want_q = qencoder(pixels)
      got_q = qtp(pixels)
      _set_act_quant(qencoder, False)
      _set_act_quant(qtp, False)
      want_w = qencoder(pixels)
      int8_cap.calls.clear()
      before = _tpx_counts()
      got_w = qtp(pixels)
      torch.cuda.synchronize()
      launches = _tpx_delta(before)
  finally:
    int8_cap.restore()
  _add(total, launches)
  rel_q, rel_w = _rel_rms(got_q, want_q), _rel_rms(got_w, want_w)
  worst = 0.0
  for _, args in int8_cap.inputs():
    worst = max(worst, check_int8(*args))
  log(f"  int8 towers TP-2: placed +{placed_gb:.3f} GB (int8 pieces made "
      f"contiguous); act_quant features rel. RMS {rel_q:.3e}, weight-only "
      f"{rel_w:.3e} against their unsharded encodes; the weight-only encode "
      f"launched {launches['int8_weight_matmul_wgmma']} wgmma + "
      f"{launches['int8_weight_matmul']} mma.sync at "
      f"{len(int8_cap.calls)} shard shapes, max_abs_err {worst:.3e} from "
      "plain")
  if (not max(rel_q, rel_w) <= MM_FEATURES_REL_RMS
      or launches["int8_weight_matmul_wgmma"]
      != TP_SHARDS * len(TPX_TOWER_KERNELS) * n_blocks):
    raise AssertionError("The int8 TP towers disagree.")
  for name in ("int8_weight_matmul", "int8_weight_matmul_wgmma"):
    rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], worst)
  key = next(k for k in int8_cap.calls if k[2] % 16)  # SigLIP's fc2 shard
  f = int8_figures(*next(a for k, a in int8_cap.inputs() if k == key))
  log(f"  int8 wgmma at the SigLIP mlp_fc2 shard {list(key[:4])} (depth "
      f"{key[2]}, rows stored padded to 16): ms {f['ms']:.4f}, bound "
      f"{f['bound_ms']:.4f} ({f['bound_by']}), plain {f['plain_ms']:.4f}, "
      f"dequant + matmul "
      f"{f['dequant_ms']:.4f}")
  rows["int8_weight_matmul_wgmma"]["tp_tower_shape"] = dict(
      shape=list(key[:4]), **{k: f[k] for k in (
          "ms", "plain_ms", "bound_ms", "bound_by", "dequant_ms")})
  del qencoder, qtp, int8_cap, tp, one
  torch.cuda.empty_cache()


def _forced_logits(model, ids, chain, dev) -> torch.Tensor:
  """``model``'s float32 logits after the prompt ``ids`` and after each token
  of ``chain`` fed back (teacher forced): [len(chain) + 1, vocab]."""
  seq = ids + list(chain)
  tokens = torch.tensor([seq], device=dev)
  positions = torch.arange(len(seq), device=dev)[None]
  with torch.no_grad():
    logits, _ = model(tokens, positions, return_cache=False)
  return logits[0, len(ids) - 1:].float()


def _tpx_multi_lora(dev, handoff, total) -> None:
  """(b) An 8-slot multi-LoRA batcher over a TP-2 sampler against the
  unsharded one: the same TPX_ML_REQUESTS requests, adapters drawn with
  lora_b std TPX_LORA_B_STD; captured and eager ticks identical; each TP
  request against a solo TP Sampler on its merged weights and against the
  unsharded batcher's tokens (identical or a 1 % tie of the unsharded
  model's logits along them); the float32 copies' TP and unsharded logits
  along those tokens within TPX_F32_LOGITS_REL_RMS (bf16's logged); the
  steady tick in turns."""
  model, vocab = handoff["model"], handoff["vocab"]
  config = model.config
  stops = {vocab.eos_id()}
  lmodel = griffin.Griffin(config, device="meta", dtype=torch.bfloat16,
                           lora_rank=TPX_LORA_RANK)
  lmodel.to_empty(device=dev)
  gen = torch.Generator(dev).manual_seed(SEED + 272)
  lmodel.load_state_dict(sft_lora.merge_params(
      model.state_dict(), sft_lora.init_adapters(lmodel, gen)))
  own = {name: leaf.clone() for name, leaf in lmodel.adapter_leaves().items()}

  def drawn():
    out = sft_lora.init_adapters(lmodel, gen)
    for name, leaf in out.items():
      if name.endswith("lora_b"):
        leaf.normal_(0.0, TPX_LORA_B_STD, generator=gen)
    return out

  adapters = {"a": drawn(), "b": drawn(), "none": None}
  rng = np.random.default_rng(SEED + 273)
  specs = _adapter_specs(config, SEED + 274, TPX_ML_REQUESTS, TPX_ML_KINDS,
                         rng.integers(*TP_BATCH_PROMPT_RANGE,
                                      size=TPX_ML_REQUESTS))
  mesh = _tp_mesh(dev, TP_SHARDS)
  samplers = {"one": sampler_lib.Sampler(lmodel, vocab, device=dev),
              "tp": sampler_lib.Sampler(lmodel, vocab, mesh=mesh),
              "tp eager": sampler_lib.Sampler(lmodel, vocab, mesh=mesh,
                                              jit_compile=False)}
  runs = {}
  for label, side, order in (("tp", "tp", specs), ("one", "one", specs),
                             ("tp eager", "tp eager", specs),
                             ("tp order B", "tp",
                              specs[::-1][1::2] + specs[::-1][0::2])):
    batcher = serving.ContinuousBatcher(samplers[side], num_slots=BATCH_SLOTS,
                                        max_steps_default=TPX_ML_STEPS,
                                        multi_lora=True)
    before = _tpx_counts()
    runs[label] = _drive_batcher(batcher, order, adapters.__getitem__)
    torch.cuda.synchronize()
    if side != "one":
      _add(total, _tpx_delta(before))
    del batcher
  if runs["tp"] != runs["tp eager"] or runs["tp"] != runs["tp order B"]:
    raise AssertionError("TP multi-LoRA: captured, eager and the second "
                         "join order disagree.")
  # Float32 copies of the LoRA model, unsharded and TP-2 over its tensors:
  # their logits differ by the summation order alone.
  lmodel32 = griffin.Griffin(config, device="meta", dtype=torch.float32,
                             lora_rank=TPX_LORA_RANK)
  lmodel32.to_empty(device=dev)
  lmodel32.load_state_dict(lmodel.state_dict())
  identical, solo_identical, distinct = 0, 0, set()
  worst = dict(f32=0.0, bf16=0.0, bf16_first=0.0)
  for kind, source in adapters.items():
    with torch.no_grad():
      for m in (lmodel, lmodel32):
        for name, leaf in m.adapter_leaves().items():
          leaf.copy_(own[name] if source is None else source[name])
    solo = sampler_lib.Sampler(lmodel, vocab, mesh=mesh)
    tp32 = tensor_parallel.tensor_parallel(lmodel32, mesh)
    for spec in specs:
      if spec["kind"] != kind:
        continue
      out = solo([spec["prompt"]], TPX_ML_STEPS, return_logits=True)
      got, ref = runs["tp"][spec["name"]], out.tokens[0].tolist()
      solo_identical += token_agreement(
          f"TP multi-LoRA {spec['name']} against its solo TP Sampler", got,
          ref, out.logits[0], stops)["identical"]
      # The unsharded batcher's tokens, and the models' logits along them.
      want = _trim_at_stop(runs["one"][spec["name"]], stops)
      ids = solo.tokenize(spec["prompt"])
      want_logits, tp_logits = (_forced_logits(m, ids, want, dev)
                                for m in (lmodel, solo.model))
      worst["bf16"] = max(worst["bf16"], _rel_rms(tp_logits, want_logits))
      worst["bf16_first"] = max(worst["bf16_first"],
                                _rel_rms(tp_logits[0], want_logits[0]))
      rel = _rel_rms(*(_forced_logits(m, ids, want, dev)
                       for m in (tp32, lmodel32)))
      worst["f32"] = max(worst["f32"], rel)
      if not rel <= TPX_F32_LOGITS_REL_RMS:
        raise AssertionError(
            f"TP multi-LoRA {spec['name']}: the float32 TP logits along the "
            f"unsharded batcher's tokens are {rel:.3e} (rel. RMS) from the "
            f"unsharded model's (tolerance {TPX_F32_LOGITS_REL_RMS}).")
      del tp_logits
      identical += token_agreement(
          f"TP multi-LoRA {spec['name']} against the unsharded batcher", got,
          want, want_logits, stops)["identical"]
      distinct.add(tuple(got[:4]))
  with torch.no_grad():
    for name, leaf in lmodel.adapter_leaves().items():
      leaf.copy_(own[name])
  log(f"  8-slot multi-LoRA batcher, {TPX_ML_REQUESTS} requests of "
      f"{TP_BATCH_PROMPT_RANGE} tokens, adapters {TPX_ML_KINDS} (lora_b std "
      f"{TPX_LORA_B_STD}): TP-2 captured = eager = the second join order; "
      f"{identical} of {len(specs)} identical to the unsharded batcher's, "
      f"{solo_identical} to solo TP Samplers on the merged weights (the rest "
      f"first differ at a near tie of the unsharded model's logits); along "
      f"the unsharded batcher's tokens the TP logits are at most "
      f"{worst['f32']:.3e} (rel. RMS) from the unsharded model's in float32 "
      f"(tolerance {TPX_F32_LOGITS_REL_RMS}), {worst['bf16']:.3e} in bf16 "
      f"({worst['bf16_first']:.3e} at the first token; not bounded: the "
      f"adapters amplify bf16 rounding); {len(distinct)} distinct openings")

  # The steady 8-slot multi-LoRA tick, TP-2 against unsharded, in turns.
  batchers = {side: serving.ContinuousBatcher(
      samplers[side], num_slots=BATCH_SLOTS, max_steps_default=256,
      multi_lora=True) for side in ("tp", "one")}
  for b in batchers.values():
    for i in range(BATCH_SLOTS):
      b.add_request(specs[i]["prompt"], max_steps=200,
                    adapters=adapters[specs[i]["kind"]])
    b.step(BATCH_TICK)
  ticks = {side: [] for side in batchers}
  for side in TPX_TURNS * (TPX_TICK_REPEATS // 2):
    ms, _ = _timed_call(lambda: batchers[side].step(BATCH_TICK))
    ticks[side].append(ms / BATCH_TICK)
  log(f"  the steady 8-slot multi-LoRA tick, ms a step in turns: "
      f"{ {s: [round(v, 3) for v in vs] for s, vs in ticks.items()} }; "
      f"tokens/s { {s: [round(BATCH_SLOTS * 1e3 / v, 1) for v in vs]
                    for s, vs in ticks.items()} }")
  del batchers, samplers, lmodel, lmodel32, tp32
  torch.cuda.empty_cache()


def _tpx_export(dev, handoff, total) -> None:
  """(c) The bf16 2B's first TPX_EXPORT_BLOCKS blocks at full width, exported
  over a (1, 2) mesh at the bucket (2, 3000), saved and loaded: the loaded
  prefill bit for bit the live TP forward, the loaded greedy chain token
  for token the TP Sampler's captured decode; artifact bytes, export and
  load seconds."""
  vocab, prompts = handoff["vocab"], handoff["prompts"]
  model = depth_cut(handoff["model"], TPX_EXPORT_BLOCKS)
  mesh = _tp_mesh(dev, TP_SHARDS)
  params = dict(model.named_parameters())
  start = time.perf_counter()
  exp = export_lib.export_serving(model, params, *EXPORT_BUCKET, mesh=mesh)
  export_s = time.perf_counter() - start
  root = tempfile.mkdtemp(prefix="chip-smoke-tp-export-")
  path = os.path.join(root, "tp-bf16")
  export_lib.save_serving_export(exp, path)
  size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
  del exp
  start = time.perf_counter()
  loaded = export_lib.load_serving_export(path, mesh=mesh)
  load_s = time.perf_counter() - start
  try:
    export_lib.load_serving_export(path, mesh=_tp_mesh(dev, TP4_SHARDS))
    raise AssertionError("A TP-2 artifact loaded under a TP-4 mesh.")
  except ValueError as e:
    refused = str(e)
  placed = sharding.place_state_dict(
      params, partitioning.griffin_param_shardings(mesh, params))
  tps = sampler_lib.Sampler(model, vocab, mesh=mesh)
  tokens, positions = _export_inputs(tps, prompts, dev)
  before = _tpx_counts()
  got, _ = loaded.prefill(placed, tokens, positions)
  torch.cuda.synchronize()
  launches = _tpx_delta(before)
  with torch.no_grad():
    want, _ = tps.model(tokens, positions, last_logits_only=True)
  _add(total, launches)
  config = model.config
  n_rec = sum(bt is common.TemporalBlockType.RECURRENT
              for bt in config.block_types)
  if (launches["lru_scan"], launches["window_attention"]) != (
      TP_SHARDS * n_rec, TP_SHARDS * (config.num_layers - n_rec)):
    raise AssertionError(f"The loaded TP prefill launched {launches}.")
  tps(prompts, total_generation_steps=DECODE_STEPS,
      end_sampling_at_eos_token=False)  # captures its step
  out = tps(prompts, total_generation_steps=DECODE_STEPS,
            end_sampling_at_eos_token=False)
  want_tokens = torch.stack([t[:DECODE_STEPS] for t in out.tokens])
  before = _tpx_counts()
  chain, _ = _loaded_chain(loaded, placed, tokens, positions, DECODE_STEPS)
  _add(total, _tpx_delta(before))
  same = torch.equal(got, want)
  agree = bool((chain.cpu() == want_tokens.cpu()).all())
  log(f"  TP-2 export of the bf16 2B's first {TPX_EXPORT_BLOCKS} blocks at "
      f"{EXPORT_BUCKET}: exported in "
      f"{export_s:.2f} s, loaded in {load_s:.2f} s (host); artifact {size} "
      f"bytes; meta mesh_axes {loaded.meta['mesh_axes']}, num_devices "
      f"{loaded.meta['num_devices']}; a TP-4 mesh refused ({refused}); the "
      f"loaded prefill launched {launches} and is "
      f"{'bit for bit' if same else 'not'} the live TP forward; its greedy "
      f"chain of {DECODE_STEPS} {'equals' if agree else 'differs from'} the "
      "TP Sampler's captured decode")
  shutil.rmtree(root, ignore_errors=True)
  if not (same and agree):
    raise AssertionError("The loaded TP export disagrees with the live TP "
                         "path.")
  del loaded, placed, tps


def phase_tp_extras(dev, handoff: dict) -> dict[str, dict]:
  """The sharded towers, multi-LoRA over a TP-2 sampler and the TP export on
  phase 18's models, each over meshes that repeat the card. Returns the
  kernels line's rows it adds to: launches, errors, shard-shape figures."""
  phase_start = time.perf_counter()
  log("== phase 27: the sharded towers, TP multi-LoRA and the TP export on "
      "phase 18's models (meshes repeat the card: no speed-up is possible)")
  model = handoff["model"]
  if "encoder" not in handoff:  # phase 22 freed phase 18's towers: redrawn
    handoff = dict(handoff, encoder=vit.DinoSigLIPEncoder(
        device=dev, generator=torch.Generator(dev).manual_seed(SEED + 81)))
  rows = {name: dict(max_abs_err=0.0) for name in _tpx_counts()}
  total = {k: 0 for k in _tpx_counts()}
  fused = [block.fused_epilogue for block in model.blocks]
  for block in model.blocks:  # the image cell's 2B
    block.fused_epilogue = True
  seconds = {}
  try:
    start = time.perf_counter()
    _tpx_towers(dev, handoff, rows, total)
    seconds["towers"] = time.perf_counter() - start
  finally:
    for block, flag in zip(model.blocks, fused):
      block.fused_epilogue = flag
  torch.cuda.empty_cache()
  for name, part in (("multi-LoRA", _tpx_multi_lora), ("export", _tpx_export)):
    start = time.perf_counter()
    part(dev, handoff, total)
    seconds[name] = time.perf_counter() - start
  torch.cuda.empty_cache()
  log(f"  phase 27's parts (s): "
      f"{ {k: round(v, 1) for k, v in seconds.items()} }")
  log(f"== phase 27 {time.perf_counter() - phase_start:.1f} s; its launches "
      f"{total}")
  for name, n in total.items():
    rows[name]["launches"] = n
  return rows


# -- phase 28: pipeline parallelism --------------------------------------------

# Phase 28 runs on phase 18's models over stage meshes that repeat the one
# H100 (from multihost.make_hybrid_mesh, the dcn axis of size 1): launches,
# agreement with the unsharded model and the microbatch's kernel shapes,
# never a speed-up (every stage runs in turn on the one card).
PP_STAGES = 4
PP_MICROBATCHES = 4
PP_INTERLEAVE = 2
PP_DP_MESH = (2, 2)  # (stage, data)
PP_DP_MICROBATCHES = 2
# Four rows of 4096 tokens (one microbatch row each at M = 4); row 1 is
# right-padded after 3000, as in the training cell.
PP_REAL_TOKENS = (4096, 3000, 4096, 4096)
PP_STEPS = 3
PP_TURNS = ("one", "pp", "pp", "one")


def pp_batch(vocab_size: int, dev) -> tuple[torch.Tensor, ...]:
  """(tokens, mask, positions) of phase 28: random tokens after BOS, the
  loss over the second half of each row's real tokens."""
  rng = np.random.default_rng(SEED + 150)
  tokens = rng.integers(4, vocab_size,
                        (len(PP_REAL_TOKENS), TRAIN_TOKENS)).astype(np.int64)
  tokens[:, 0] = 1
  mask = np.zeros(tokens.shape, bool)
  for row, real in enumerate(PP_REAL_TOKENS):
    tokens[row, real:] = 0
    mask[row, real // 2:real] = True
  tokens = torch.as_tensor(tokens, device=dev)
  return (tokens, torch.as_tensor(mask, device=dev),
          trainer.get_positions(tokens, 0))


def _pp_mesh(dev, shape, names) -> sharding.Mesh:
  return multihost.make_hybrid_mesh(shape, names,
                                    devices=[dev] * int(np.prod(shape)))


def _pp_placed(pipe, model):
  """``model``'s weights stacked and placed by ``pipe``, and the GB the
  stacked copy took."""
  torch.cuda.synchronize()
  before = torch.cuda.memory_allocated()
  stacked, shared = pipe.stack_params(model.state_dict())
  placed = sharding.place_state_dict(stacked, pipe.stage_sharding(stacked))
  torch.cuda.synchronize()
  return placed, shared, (torch.cuda.memory_allocated() - before) / 1e9


def _pp_forward_launches(pipe) -> dict[str, int]:
  """One pipelined forward's scan and window launches: the pipelined blocks
  once a microbatch of every data slice (nothing in a bubble slot), the
  tail once on the whole batch."""
  types = pipe.model.config.block_types
  runs = pipe.num_microbatches * math.prod(
      n for axis, n in pipe.mesh.shape.items() if axis != pipe.axis_name)
  rec = lambda ids: sum(types[i] is common.TemporalBlockType.RECURRENT
                        for i in ids)
  prefix, tail = range(pipe.pipelined_layers), pipe.tail_layers
  return {"lru_scan": runs * rec(prefix) + rec(tail),
          "window_attention": (runs * (len(prefix) - rec(prefix))
                               + len(tail) - rec(tail))}


def _pp_step_launches(pipe) -> dict[str, int]:
  """One pipelined training step's launches under per-chunk remat: each
  chunk's forward twice (the pass and the recompute), its backward once;
  the tail, not rematerialized, once each way."""
  fwd = _pp_forward_launches(pipe)
  tail_rec = sum(pipe.model.config.block_types[i]
                 is common.TemporalBlockType.RECURRENT
                 for i in pipe.tail_layers)
  tail_att = len(pipe.tail_layers) - tail_rec
  rec, att = fwd["lru_scan"] - tail_rec, fwd["window_attention"] - tail_att
  return {"lru_scan": 2 * rec + tail_rec,
          "lru_scan_backward": rec + tail_rec,
          "window_attention": 2 * att + tail_att,
          "window_attention_dq": att + tail_att,
          "window_attention_dkv": att + tail_att}


def _pp_gradients(pipe, placed, shared, tokens, mask, positions):
  """One batch's loss and gradients (whole leaves by block name) through
  the pipeline, its launches, ms (forward and backward) and peak GB."""
  params = pipe.parameters(placed, shared)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  before = _tpt_counts()
  reset_scan_routes()
  start = time.perf_counter()
  loss = pipe.loss_fn(placed, shared, tokens, mask, positions)
  loss.backward()
  torch.cuda.synchronize()
  ms = (time.perf_counter() - start) * 1e3
  launches = _tpt_delta(before)
  check_scan_routes(launches["lru_scan"] + launches["lru_scan_backward"])
  peak_gb = torch.cuda.max_memory_allocated() / 1e9
  grads = pipe.unstack_params(*pipe.gradients(placed, shared))
  for p in params:
    p.grad = None
  return loss.item(), grads, launches, ms, peak_gb


def _hold_pp_int8(capture, rows: dict, config, microbatch_rows: int) -> None:
  """The int8 kernel against its plain version on the first inputs of each
  shape the int8 pipeline gave it, into its route's row; timed at a
  projection's and the fused up-projection's microbatch shapes."""
  timed = {(1, config.width, config.width, microbatch_rows),
           (2, config.mlp_expanded_width, config.width, microbatch_rows)}
  for key, args in capture.inputs():
    route = ("int8_weight_matmul_wgmma"
             if int8_matmul.uses_wgmma(args[0].shape[1])
             else "int8_weight_matmul")
    row = rows[route]
    row["max_abs_err"] = max(row["max_abs_err"], check_int8(*args))
    batches, n, k, m, shared_a = key
    if key[:4] not in timed:
      continue
    f = int8_figures(*args)
    log(f"  int8_weight_matmul_wgmma at the microbatch's a "
        f"{tuple(args[0].shape)}{' (shared)' if shared_a else ''} x q "
        f"{tuple(args[1].shape)}: ms {f['ms']:.4f}  plain {f['plain_ms']:.4f}"
        f"  dequant {f['dequant_ms']:.4f}  bf16 {f['bf16_ms']:.4f}  bound "
        f"{f['bound_ms']:.4f} ({f['bound_by']}): "
        f"{100 * f['bound_ms'] / f['ms']:.1f}% of the bound")
    row["pp_shapes"].append(dict(
        mesh=f"PP-{PP_STAGES}", shape=[m, n, k], batches=batches,
        **{x: f[x] for x in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "dequant_ms")}))
  log(f"  int8 kernels on the int8 pipeline's {len(capture.calls)} shapes: "
      f"max_abs_err {rows['int8_weight_matmul_wgmma']['max_abs_err']:.3e} "
      f"(wgmma), {rows['int8_weight_matmul']['max_abs_err']:.3e} (mma.sync)")


def phase_pipeline(dev, handoff: dict) -> dict[str, dict]:
  """Pipeline parallelism on phase 18's 2B (full width and depth: 24 blocks
  pipelined, 2 in the tail) and its int8 copy, over meshes of
  ``multihost.make_hybrid_mesh`` that repeat the card, at 4 x 4096 tokens
  (row 1 right-padded after 3000): (a) GPipe S = 4, M = 4: a forward's
  launches (66 LRU + 32 window, none in a bubble slot, every scan on the
  ring) and last logits against the unsharded forward; one step's loss,
  gradients and launches against the unsharded model's; the kernels on the
  microbatch's first inputs against their plain versions, timed; (b)
  interleaved v = 2 and (c) PP x DP on (stage 2, data 2), M = 2: the same
  loss and gradient checks; (d) the int8 copy's forward, its int8 launches
  by route, its last logits against the unsharded int8 forward; (e) three
  ``make_train_step`` AdamW steps in turns with three unsharded
  ``trainer.train_step`` steps. Returns the kernels line's rows it adds to:
  launches, errors, the microbatch's shapes (``pp_shapes``)."""
  phase_start = time.perf_counter()
  base, qbase = handoff["model"], handoff["qmodel"]
  config = base.config
  rows = {name: dict(launches=0, max_abs_err=0.0, pp_shapes=[])
          for name in TPT_NAMES}
  tokens, mask, positions = pp_batch(config.vocab_size, dev)
  b, t = tokens.shape
  mesh = _pp_mesh(dev, (PP_STAGES,), ("stage",))
  pipes = {
      "(a) GPipe": pipeline.GriffinPipeline(base, mesh, PP_MICROBATCHES),
      "(b) interleaved": pipeline.GriffinPipeline(
          base, mesh, PP_MICROBATCHES, interleave=PP_INTERLEAVE),
      "(c) PP x DP": pipeline.GriffinPipeline(
          base, _pp_mesh(dev, PP_DP_MESH, ("stage", "data")),
          PP_DP_MICROBATCHES)}
  log(f"== phase 28: pipeline parallelism on phase 18's 2B, batch {b} x {t} "
      f"(row 1 padded after {PP_REAL_TOKENS[1]}); meshes repeat the card "
      f"(no speed-up is possible); {mesh}")
  for label, pipe in pipes.items():
    log(f"  {label}: {pipe.num_stages} stages x {pipe.interleave} chunks of "
        f"{pipe.layers_per_chunk} blocks, {pipe.pipelined_layers} pipelined, "
        f"tail {pipe.tail_layers}, M = {pipe.num_microbatches}, "
        f"schedule_steps {pipe.schedule_steps}, bubble_fraction "
        f"{pipe.bubble_fraction:.4f}; mesh axes {pipe.mesh.axis_names} "
        f"{pipe.mesh.shape}")

  # (a) The GPipe forward, no gradient: launches, none in a bubble slot.
  pipe = pipes["(a) GPipe"]
  placed, shared, stack_gb = _pp_placed(pipe, base)
  with torch.no_grad():
    want, _ = base(tokens, positions, return_cache=False,
                   last_logits_only=True)
    torch.cuda.synchronize()
    before = _tpt_counts()
    reset_scan_routes()
    start = time.perf_counter()
    hidden = pipe(placed, shared, tokens, positions, return_hidden=True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - start) * 1e3
    launches = _tpt_delta(before)
    got = base.decode_hidden(hidden[:, -1:])
  del hidden
  check_scan_routes(launches["lru_scan"])
  with torch.no_grad():  # the unsharded forward's time, uncounted
    start = time.perf_counter()
    base(tokens, positions, return_cache=False, last_logits_only=True)
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - start) * 1e3
  want_launches = _pp_forward_launches(pipe)
  bubbles = pipe.schedule_steps * pipe.num_stages - (
      pipe.num_microbatches * pipe.num_chunks)
  rel = _rel_rms(got, want)
  log(f"  (a) stacked copy of {pipe.pipelined_layers} blocks +{stack_gb:.3f} "
      f"GB; forward {ms:.1f} ms (host clock; the unsharded forward after it "
      f"{one_ms:.1f} ms), launched {launches} (want "
      f"{want_launches}: {bubbles} bubble slots of {pipe.schedule_steps} x "
      f"{pipe.num_stages} launch nothing); last logits rel. RMS {rel:.3e} "
      f"against the unsharded forward (limit {MODEL_LOGITS_REL_RMS})")
  if any(launches[k] != v for k, v in want_launches.items()) or any(
      launches[k] for k in ("lru_scan_backward", "window_attention_dq",
                            "window_attention_dkv", "int8_weight_matmul",
                            "int8_weight_matmul_wgmma")):
    raise AssertionError(f"The GPipe forward launched {launches}, want "
                         f"{want_launches}.")
  if not (torch.isfinite(got).all() and rel <= MODEL_LOGITS_REL_RMS):
    raise AssertionError("The pipelined logits disagree with unsharded.")
  add_launches(rows, launches)
  del got, want

  # (a-c) One step's loss and gradients on each schedule against the
  # unsharded model's on the same batch.
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  start = time.perf_counter()
  want_loss, want = _unsharded_gradients(base, tokens, mask)
  torch.cuda.synchronize()
  log(f"  unsharded: loss {want_loss:.6f}, {len(want)} gradient leaves, "
      f"{(time.perf_counter() - start) * 1e3:.1f} ms, peak "
      f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
  tail_rec = sum(config.block_types[i] is common.TemporalBlockType.RECURRENT
                 for i in pipe.tail_layers)
  for label, pipe in pipes.items():
    if label != "(a) GPipe":
      placed, shared, stack_gb = _pp_placed(pipe, base)
    # The first backward scans are the tail's, on the whole batch: keep the
    # first microbatch's.
    captures = _TrainingCaptures(skip={"lru_scan_backward": tail_rec})
    try:
      loss, grads, launches, ms, peak_gb = _pp_gradients(
          pipe, placed, shared, tokens, mask, positions)
    finally:
      captures.restore()
    want_launches = _pp_step_launches(pipe)
    log(f"  {label} step (forward and backward): {ms:.1f} ms, peak "
        f"{peak_gb:.2f} GB (the unsharded gradients held beside); launched "
        f"{launches}, want {want_launches}")
    if any(launches[k] != v for k, v in want_launches.items()):
      raise AssertionError(f"{label} launched {launches}, want "
                           f"{want_launches}.")
    add_launches(rows, launches)
    _hold_gradients(label, loss, grads, want_loss, want)
    del grads, placed, shared
    _hold_kernels(label, captures, rows, time_them=label == "(a) GPipe",
                  shapes_key="pp_shapes")
    del captures
    torch.cuda.empty_cache()
  del want

  # (d) The int8 copy's forward: its int8 launches by route.
  pipe = pipeline.GriffinPipeline(qbase, mesh, PP_MICROBATCHES)
  placed, shared, stack_gb = _pp_placed(pipe, qbase)
  with torch.no_grad():
    want, _ = qbase(tokens, positions, return_cache=False,
                    last_logits_only=True)
    torch.cuda.synchronize()
    before = _tpt_counts()
    capture = CaptureInt8Calls(host=True)
    try:
      hidden = pipe(placed, shared, tokens, positions, return_hidden=True)
      got = qbase.decode_hidden(hidden[:, -1:])
    finally:
      capture.restore()
    torch.cuda.synchronize()
    launches = _tpt_delta(before)
  del hidden
  layers = lambda ids: sum(_int8_layers(qbase.blocks[i]) for i in ids)
  want_wgmma = (pipe.num_microbatches * layers(range(pipe.pipelined_layers))
                + layers(pipe.tail_layers))
  rel = _rel_rms(got, want)
  log(f"  (d) int8 copy: stacked +{stack_gb:.3f} GB; forward launched "
      f"{launches} (want {want_wgmma} wgmma: each microbatch's int8 layers "
      f"of the pipelined blocks and the tail's on the whole batch; 1 "
      f"mma.sync: the last position's logits at {b} rows); last logits rel. "
      f"RMS {rel:.3e} against the unsharded int8 forward")
  if (launches["int8_weight_matmul_wgmma"], launches["int8_weight_matmul"]) != (
      want_wgmma, 1) or any(launches[k] != v for k, v in
                            _pp_forward_launches(pipe).items()):
    raise AssertionError(f"The int8 pipeline launched {launches}.")
  if not (torch.isfinite(got).all() and rel <= MODEL_LOGITS_REL_RMS):
    raise AssertionError("The int8 pipeline's logits disagree.")
  add_launches(rows, launches)
  del got, want, placed, shared
  _hold_pp_int8(capture, rows, config, t)
  del capture
  torch.cuda.empty_cache()

  # (e) Three make_train_step steps of (a)'s pipeline in turns with three
  # unsharded trainer.train_step steps, each turn from phase 18's weights:
  # the pipeline's stacked copy and a copy of its shared leaves, or a copy
  # of the model (one at a time: each turn's optimizer holds ~11 GB).
  pipe = pipes["(a) GPipe"]
  adamw = functools.partial(torch.optim.AdamW, lr=TRAIN_LEARNING_RATE,
                            betas=(0.9, 0.96), eps=1e-8, weight_decay=0.1)
  step = pipe.make_train_step(adamw)
  real = sum(PP_REAL_TOKENS)
  turns = {"one": [], "pp": []}
  # Each turn's backward asks for a 7.8-GiB loss chunk beside ~11 GB of
  # optimizer state; in the whole smoke the earlier phases' holes left 20
  # GiB reserved but unallocated and no block that large. Segments that
  # grow (the allocator's own remedy) serve it; the setting is restored.
  torch.cuda.memory._set_allocator_settings("expandable_segments:True")  # pylint: disable=protected-access
  try:
    for side in PP_TURNS:
      torch.cuda.synchronize()
      torch.cuda.reset_peak_memory_stats()
      clock = StageClock()
      before = _tpt_counts()
      if side == "pp":
        placed, shared, _ = _pp_placed(pipe, base)
        shared = {k: v.clone() for k, v in shared.items()}
        opt = adamw(pipe.parameters(placed, shared))
        clock.restart()
        for i in range(PP_STEPS):
          loss, placed, shared, opt = step(placed, shared, opt, tokens, mask,
                                           positions)
          clock({"train_loss": loss.item()}, i)
        del placed, shared, opt
      else:
        model = griffin.Griffin(config, device="meta", dtype=torch.bfloat16)
        model.to_empty(device=dev)
        model.load_state_dict(base.state_dict())
        opt = trainer.make_optimizer(model, TRAIN_LEARNING_RATE)
        clock.restart()
        for i in range(PP_STEPS):
          loss = trainer.train_step(model, opt, 0, tokens, mask)
          clock({"train_loss": loss.item()}, i)
        del opt, model
      torch.cuda.synchronize()
      launches = _tpt_delta(before)
      turns[side].append(clock.summary(
          f"(e) {'PP-4 make_train_step' if side == 'pp' else 'unsharded train_step'}"
          f", {PP_STEPS} steps", real, torch.cuda.max_memory_allocated() / 1e9))
      if side == "pp":
        want_launches = {k: PP_STEPS * v
                         for k, v in _pp_step_launches(pipe).items()}
        if any(launches[k] != v for k, v in want_launches.items()):
          raise AssertionError(f"make_train_step launched {launches}, want "
                               f"{want_launches}.")
        add_launches(rows, launches)
        losses = turns[side][-1]["losses"]
        if not losses[-1] < losses[0]:
          raise AssertionError(f"The pipelined loss did not fall: {losses}.")
      torch.cuda.empty_cache()
  finally:
    torch.cuda.memory._set_allocator_settings("expandable_segments:False")  # pylint: disable=protected-access
  steady = {side: float(np.mean([s["steady_ms"] for s in stats]))
            for side, stats in turns.items()}
  log(f"  (e) steady ms a step in turns {PP_TURNS}: unsharded "
      f"{[round(s['steady_ms'], 1) for s in turns['one']]}, PP-4 "
      f"{[round(s['steady_ms'], 1) for s in turns['pp']]}: PP-4 / unsharded "
      f"{steady['pp'] / steady['one']:.3f} (one card runs every stage in "
      f"turn); peak GB unsharded "
      f"{[round(s['peak_gb'], 2) for s in turns['one']]}, PP-4 "
      f"{[round(s['peak_gb'], 2) for s in turns['pp']]}")
  torch.cuda.empty_cache()
  log(f"== phase 28 {time.perf_counter() - phase_start:.1f} s; its launches "
      f"{ {k: r['launches'] for k, r in rows.items()} }")
  return rows


# Phase 29: one process a card. The pmap-regime scan's operands, the
# data-parallel model's depth (two (R, R, A) cycles: two replicas of the 2B
# with AdamW fit beside each other on one 80-GB card; full depth does not)
# and its steps; a rank's time limit.
PPC_SCAN_SHAPE = (2, 8192, 2560)
PPC_BLOCKS = 6
PPC_STEPS = 3
PPC_WORLD = 2
PPC_LOSS_REL_ERR = 1e-6
# Nats between the DP run's token-mean loss and the unsharded loop's, at
# every step (their bf16 paths differ).
PPC_LOSS_ABS_ERR = 1e-2
PPC_TIMEOUT_S = 400
PPC_RANK_FLAG = "--process-per-card-rank"
PPC_NAMES = TPT_NAMES[:5] + ("lru_scan_a_prod", "lru_scan_backward_a_prod")


def _ppc_counts() -> dict[str, int]:
  return {**_launch_counts(), "lru_scan_a_prod": lru_scan.a_prod_launches,
          "lru_scan_backward_a_prod": lru_scan.backward_a_prod_launches}


def _ppc_delta(before: dict[str, int]) -> dict[str, int]:
  return {k: v - before[k] for k, v in _ppc_counts().items()}


def _ppc_digest(model) -> list[int]:
  """Two 64-bit sums of every leaf's bit patterns (plain and weighted by
  position), in chunks on the card: equal digests on two replicas mean
  equal bits."""
  out = []
  for t in model.state_dict().values():
    flat = t.detach().reshape(-1)
    bits = flat.view(torch.int16 if flat.element_size() == 2 else torch.int32)
    total = weighted = 0
    for start in range(0, bits.numel(), 1 << 26):
      chunk = bits[start:start + (1 << 26)].to(torch.int64)
      weight = torch.arange(start, start + chunk.numel(), device=chunk.device)
      total += int(chunk.sum())
      weighted += int((chunk * (weight % 65521 + 1)).sum())
    out += [total, weighted]
  return out


def _ppc_scan_inputs(dev) -> list[torch.Tensor]:
  g = torch.Generator(dev).manual_seed(SEED + 290)
  b, t, d = PPC_SCAN_SHAPE
  x = torch.randn(b, t, d, generator=g, device=dev).to(torch.bfloat16)
  a = (0.5 + 0.5 * torch.rand(b, t, d, generator=g, device=dev)).to(
      torch.bfloat16)
  h0 = torch.randn(b, d, generator=g, device=dev)
  gy = torch.randn(b, t, d, generator=g, device=dev).to(torch.bfloat16)
  gh = torch.randn(b, d, generator=g, device=dev)
  return [x, a, h0, gy, gh]


def _ppc_scan(x, a, h0, gy, gh, spec, take_h=True):
  """``linear_scan`` (the kernel path) under ``spec`` and its gradients
  for cotangents ``gy`` and (with ``take_h``) ``gh``."""
  leaves = [v.clone().requires_grad_() for v in (x, a, h0)]
  y, h = scan_lib.linear_scan(*leaves, sharding_spec=spec)
  loss = (y * gy).sum() + ((h * gh).sum() if take_h else 0)
  loss.backward()
  torch.cuda.synchronize()
  return [y.detach(), h.detach(), *(v.grad for v in leaves)]


def _ppc_a_prod_captures(rank: int) -> list[CaptureFirstCall]:
  """In rank 0, the first call of each product-scan wrapper (the sharded
  scan calls both with ``return_a_prod``); none in the other ranks."""
  if rank:
    return []
  return [CaptureFirstCall(lru_scan, "lru_scan_forward"),
          CaptureFirstCall(lru_scan, "lru_scan_backward")]


def _ppc_hold_a_prod(label: str, captures) -> dict[str, float]:
  """The captured product scans against their plain versions, bit for bit
  (``check_lru_a_prod`` raises above LRU_A_PROD_MAX_ABS_ERR); their errors
  by row (0 where nothing was captured)."""
  errs = {"lru_scan_a_prod": 0.0, "lru_scan_backward_a_prod": 0.0}
  if not captures:
    return errs
  shapes = []
  for capture, (name, backprop) in zip(captures, (
      ("lru_scan_a_prod", False), ("lru_scan_backward_a_prod", True))):
    if capture.args is None:
      raise AssertionError(f"{label} never called {capture.name}.")
    errs[name] = check_lru_a_prod(*capture.args, **capture.kwargs,
                                  backprop=backprop)
    shapes.append(list(capture.args[0].shape))
  log(f"  (a) rank 0: {label}'s product scans vs plain at forward "
      f"{shapes[0]}, backward {shapes[1]} bf16: {errs} (tolerance "
      f"{LRU_A_PROD_MAX_ABS_ERR})")
  return errs


def _ppc_scans(dev, rank: int, world: int) -> dict:
  """(a) In a rank: the pmap-regime scan of this rank's half of
  PPC_SCAN_SHAPE (axis ``seq`` bound to the default group) and the
  channel-split scan over a (seq world, model 2) process mesh, each
  forward and backward on the kernel path, bit for bit against the
  single-controller scan over a mesh that repeats the card."""
  x, a, h0, gy, gh = _ppc_scan_inputs(dev)
  t = x.shape[1] // world
  mine = slice(rank * t, (rank + 1) * t)
  spec = sharding.ShardingSpec(
      mesh=sharding.make_mesh((world,), ("seq",), [dev] * world),
      sequence_axis_name="seq")
  want = _ppc_scan(x, a, h0, gy, gh, spec)
  before = _ppc_counts()
  reset_scan_routes()
  captures = _ppc_a_prod_captures(rank)
  start = time.perf_counter()
  try:
    with sharding.axis_env(seq=None):
      got = _ppc_scan(x[:, mine], a[:, mine], h0, gy[:, mine], gh,
                      sharding.ShardingSpec(mesh=None,
                                            sequence_axis_name="seq"),
                      take_h=rank == 0)
  finally:
    for capture in captures:
      capture.restore()
  pmap_ms = (time.perf_counter() - start) * 1e3
  pmap_launches = _ppc_delta(before)
  check_scan_routes(pmap_launches["lru_scan_a_prod"]
                    + pmap_launches["lru_scan_backward_a_prod"])
  errs = _ppc_hold_a_prod("the pmap-regime scan", captures)
  # Rank 0's shard is the forward's first: its dh0 is the whole one.
  dh0_want = want[4] if rank == 0 else torch.zeros_like(want[4])
  pairs = {"y": (got[0], want[0][:, mine]), "h_last": (got[1], want[1]),
           "dx": (got[2], want[2][:, mine]), "da": (got[3], want[3][:, mine]),
           "dh0": (got[4], dh0_want)}
  bad = [k for k, (g, w) in pairs.items() if not torch.equal(g, w)]
  log(f"  (a) rank {rank}: pmap-regime scan of [{x.shape[0]}, {t}, "
      f"{x.shape[2]}] bf16 (axis 'seq' over {world} processes), forward + "
      f"backward in {pmap_ms:.1f} ms, launches {pmap_launches}; y, h_last, "
      f"dx, da, dh0 bit for bit vs the single-controller mesh: "
      f"{'yes' if not bad else bad}")
  if bad:
    raise AssertionError(f"The pmap-regime scan differs from the "
                         f"single-controller scan in {bad}.")
  mesh = multihost.make_hybrid_mesh((2,), ("model",), dcn_axis_shapes=(world,),
                                    dcn_axis_names=("seq",),
                                    devices=[dev] * 2)
  ref = sharding.ShardingSpec(
      mesh=sharding.make_mesh((world, 2), ("seq", "model"), [dev] * 2 * world),
      sequence_axis_name="seq", activations_axis_name="model")
  want = _ppc_scan(x, a, h0, gy, gh, ref)
  before = _ppc_counts()
  reset_scan_routes()
  captures = _ppc_a_prod_captures(rank)
  try:
    got = _ppc_scan(x, a, h0, gy, gh, ref._replace(mesh=mesh))
  finally:
    for capture in captures:
      capture.restore()
  channel_launches = _ppc_delta(before)
  check_scan_routes(channel_launches["lru_scan_a_prod"]
                    + channel_launches["lru_scan_backward_a_prod"])
  for name, err in _ppc_hold_a_prod("the channel-split scan",
                                    captures).items():
    errs[name] = max(errs[name], err)
  bad = [k for k, g, w in zip(("y", "h_last", "dx", "da", "dh0"), got, want)
         if not torch.equal(g, w)]
  log(f"  (a) rank {rank}: channel-split scan over {mesh} (global "
      f"[{', '.join(map(str, x.shape))}] on every process), launches "
      f"{channel_launches}; bit for bit vs the single-controller (seq "
      f"{world}, model 2) mesh: {'yes' if not bad else bad}")
  if bad:
    raise AssertionError(f"The channel-split scan differs in {bad}.")
  launches = {k: pmap_launches[k] + channel_launches[k] for k in pmap_launches}
  return {"launches": launches, "pmap_ms": pmap_ms, "max_abs_err": errs}


def _ppc_config():
  config = common.GriffinConfig.from_preset(common.Preset.RECURRENT_GEMMA_2B_V1)
  return config._replace(block_types=config.block_types[:PPC_BLOCKS])


def _ppc_model(dev):
  return griffin.Griffin(_ppc_config(), device=dev, dtype=torch.bfloat16,
                         generator=torch.Generator(dev).manual_seed(SEED + 291))


class _PpcClock:
  """``log_metrics`` of a DP run: each step's loss, its host-clock ms (the
  digest taken after the step left out) and the replica's digest."""

  def __init__(self, model):
    self.model, self.losses, self.ms, self.digests = model, [], [], []
    self.last = time.perf_counter()

  def __call__(self, metrics, step):
    del step
    now = time.perf_counter()
    self.losses.append(metrics["train_loss"])
    self.ms.append((now - self.last) * 1e3)
    self.digests.append(_ppc_digest(self.model))
    self.last = time.perf_counter()


def _ppc_train(model, dev, mesh, steps: int = PPC_STEPS) -> _PpcClock:
  clock = _PpcClock(model)
  train_loop_lib.train_loop(
      model, [training_batch(model.config.vocab_size)] * steps,
      train_loop_lib.TrainingConfig(learning_rate=TRAIN_LEARNING_RATE,
                                    eval_every_n=1, max_steps=steps,
                                    checkpoint_every_n=None),
      log_metrics=clock, device=dev, mesh=mesh)
  return clock


def _ppc_turn(model, dev, mesh, rank, world, label, grads=None) -> dict:
  """One DP turn of PPC_STEPS train_loop(mesh=) steps in every rank: the
  replicas' digests equal after every step, the launches a step the
  phase-6 counts at PPC_BLOCKS blocks, the all-reduce's time; ``grads``
  (a dict) receives the first step's reduced gradients."""
  reduce_ms = []
  real = data_parallel_lib.ShardedGriffin.all_reduce_gradients

  def timed(self):
    torch.cuda.synchronize()
    start = time.perf_counter()
    real(self)
    torch.cuda.synchronize()
    reduce_ms.append((time.perf_counter() - start) * 1e3)
    if grads is not None and not grads:
      grads.update({k: g.clone() for k, g in self.gradients().items()})

  data_parallel_lib.ShardedGriffin.all_reduce_gradients = timed
  before = _ppc_counts()
  reset_scan_routes()
  try:
    clock = _ppc_train(model, dev, mesh)
  finally:
    data_parallel_lib.ShardedGriffin.all_reduce_gradients = real
  torch.cuda.synchronize()
  launches = _ppc_delta(before)
  config = model.config
  n_rec = sum(bt is common.TemporalBlockType.RECURRENT
              for bt in config.block_types)
  want = {k: PPC_STEPS * v for k, v in _tpt_per_step(
      1, n_rec, config.num_layers - n_rec).items()}
  if any(launches[k] != v for k, v in want.items()):
    raise AssertionError(f"{label}: rank {rank} launched {launches}, want "
                         f"{want}.")
  check_scan_routes(launches["lru_scan"] + launches["lru_scan_backward"])
  every = [None] * world
  torch.distributed.all_gather_object(every, clock.digests)
  if any(d != clock.digests for d in every):
    raise AssertionError(f"{label}: the replicas' bits differ after a step.")
  every = [None] * world
  torch.distributed.all_gather_object(every, clock.losses)
  if any(l != clock.losses for l in every):
    raise AssertionError(f"{label}: the ranks' losses differ: {every}.")
  steady = float(np.mean(clock.ms[1:]))
  share = float(np.mean(reduce_ms[1:])) / steady
  log(f"  (b) rank {rank} {label}: losses {clock.losses}; ms a step "
      f"{[round(ms, 1) for ms in clock.ms]} (steady {steady:.1f}); gradient "
      f"all-reduce ms {[round(ms, 1) for ms in reduce_ms]} ({100 * share:.1f} "
      f"% of a steady step); launches {launches}; replicas' digests equal "
      f"after each of the {PPC_STEPS} steps")
  return {"losses": clock.losses, "ms": clock.ms, "steady_ms": steady,
          "reduce_ms": reduce_ms, "reduce_share": share, "launches": launches}


def _ppc_references(dev, world: int, dp_state, dp_grads) -> dict:
  """In rank 0, between the DP turns: the single-controller
  train_loop(mesh=) over a (world,) data mesh that repeats the card and
  the unsharded loop, from the same weights and batches (timed); with
  ``dp_grads``, the unsharded first step's gradients against them."""
  out = {}
  if dp_grads is not None:
    batch = training_batch(_ppc_config().vocab_size)
    tokens = torch.as_tensor(batch.input_tokens, device=dev).long()
    mask = torch.as_tensor(batch.target_mask, device=dev)
    model = _ppc_model(dev)
    _, grads = _unsharded_gradients(model, tokens, mask)
    stats = _leaf_stats(dp_grads, grads)
    _log_leaf_stats("(b) DP step 1's gradients vs the unsharded step's",
                    stats)
    out["grad_stats"] = [stats[0][0], min(s[1] for s in stats)]
    del model, grads
    torch.cuda.empty_cache()
  order = ("sc", "one") if dp_state is not None else ("one", "sc")
  for side in order:
    model = _ppc_model(dev)
    mesh = (sharding.make_mesh((world, 1), ("data", "model"), [dev] * world)
            if side == "sc" else None)
    clock = _ppc_train(model, dev, mesh)
    out[side] = {"losses": clock.losses, "ms": clock.ms,
                 "steady_ms": float(np.mean(clock.ms[1:]))}
    if dp_state is not None and side == "sc":
      state = model.state_dict()
      out["sc_max_leaf_diff"] = max(max_err(state[k], v)
                                    for k, v in dp_state.items())
    if dp_state is not None and side == "one":
      out["leaf_stats"] = _ppc_leaf_stats(dev, dp_state, model.state_dict())
    del model
    torch.cuda.empty_cache()
  return out


def _ppc_leaf_stats(dev, dp_state, state) -> dict:
  """The DP run's weights after PPC_STEPS steps against the unsharded
  loop's. Adam moves a weight by about lr a step whatever its gradient's
  size, so a gradient at the bf16 paths' noise level may move it either
  way: every element is held within Adam's bound (2 lr a step, plus one
  bf16 rounding of the weight a step), and the steps' updates (each
  leaf's change from the seeded start) are compared over the whole tree
  (rel RMS, cosine) and leaf by leaf (the leaves that differ)."""
  start = _ppc_model(dev).state_dict()
  lr = TRAIN_LEARNING_RATE
  worst_ratio, beyond_lr, elements, equal = 0.0, 0, 0, 0
  diff_sq = ref_sq = dot = got_sq = 0.0
  per_leaf = []
  for name, got in dp_state.items():
    want = state[name]
    elements += want.numel()
    if torch.equal(got, want):
      equal += 1
      continue
    g, w = got.float(), want.float()
    gap = (g - w).abs()
    bound = PPC_STEPS * (2 * lr + 2.0 ** -7 * torch.maximum(g.abs(), w.abs()))
    worst_ratio = max(worst_ratio, (gap / bound).max().item())
    beyond_lr += int((gap > lr).sum())
    u, v = g - start[name].float(), w - start[name].float()
    diff_sq += (u - v).double().square().sum().item()
    ref_sq += v.double().square().sum().item()
    got_sq += u.double().square().sum().item()
    dot += (u.double() * v.double()).sum().item()
    per_leaf.append(_leaf_stats({name: u}, {name: v})[0])
  per_leaf.sort(reverse=True)
  out = {"adam_bound_ratio": worst_ratio,
         "beyond_lr_share": beyond_lr / elements,
         "equal_leaves": equal, "leaves": len(dp_state),
         "update_rel_rms": (diff_sq / ref_sq) ** 0.5,
         "update_cosine": dot / (got_sq * ref_sq) ** 0.5,
         "leaf_worst_rel_rms": per_leaf[0][0] if per_leaf else 0.0,
         "leaf_median_rel_rms": (per_leaf[len(per_leaf) // 2][0]
                                 if per_leaf else 0.0),
         "leaf_lowest_cosine": min((c for _, c, _ in per_leaf), default=1.0)}
  if per_leaf:
    _log_leaf_stats(f"(b) DP updates over {PPC_STEPS} steps vs the unsharded "
                    f"loop's, the {len(per_leaf)} leaves that differ",
                    per_leaf)
  return out


def _ppc_dp(dev, rank: int, world: int) -> dict:
  """(b) In a rank: train_loop(mesh=) of the 2B at PPC_BLOCKS blocks over a
  data axis of ``world`` processes (one row of the 2 x 4096 batch each),
  in turns with rank 0's single-controller and unsharded loops; the
  kernels held against their plain versions on rank 0's inputs."""
  config = _ppc_config()
  mesh = multihost.make_hybrid_mesh((1,), ("model",), dcn_axis_shapes=(world,),
                                    dcn_axis_names=("data",), devices=[dev])
  log(f"  (b) rank {rank}: RecurrentGemma-2B at width {config.width}, "
      f"{config.num_layers} blocks, bf16, {PPC_STEPS} AdamW steps a turn over "
      f"{mesh}")
  model = _ppc_model(dev)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  captures = _TrainingCaptures() if rank == 0 else None
  dp_grads = {} if rank == 0 else None
  try:
    turns = [_ppc_turn(model, dev, mesh, rank, world, "DP turn 1",
                       dp_grads)]
  finally:
    if captures is not None:
      captures.restore()
  peak_gb = torch.cuda.max_memory_allocated() / 1e9
  out = {"turns": turns, "peak_gb": peak_gb}
  if rank == 0:
    rows = {name: dict(launches=0, max_abs_err=0.0) for name in PPC_NAMES}
    _hold_kernels("the DP rank", captures, rows, time_them=False)
    out["max_abs_err"] = {k: r["max_abs_err"] for k, r in rows.items()}
    del captures
    dp_state = {k: v.clone() for k, v in model.state_dict().items()}
    out["references"] = [_ppc_references(dev, world, dp_state, dp_grads)]
    del dp_state, dp_grads
  torch.cuda.empty_cache()
  torch.distributed.barrier()
  torch.cuda.reset_peak_memory_stats()
  turns.append(_ppc_turn(model, dev, mesh, rank, world, "DP turn 2"))
  out["peak_gb"] = max(peak_gb, torch.cuda.max_memory_allocated() / 1e9)
  del model
  torch.cuda.empty_cache()
  if rank == 0:
    out["references"].append(_ppc_references(dev, world, None, None))
  torch.distributed.barrier()
  return out


def _ppc_nccl_one(dev) -> dict:
  """(c) One process, NCCL in a group of one: one train_loop(mesh=) step
  over a process mesh of two data rows repeating the card, its gradient
  all-reduce through the NCCL communicator."""
  mesh = multihost.make_hybrid_mesh((2, 1), ("data", "model"),
                                    devices=[dev] * 2)
  calls = []
  real = sharding.psum_

  def counted(tensor, domain):
    calls.append(torch.distributed.get_backend(domain.group))
    return real(tensor, domain)

  sharding.psum_ = counted
  before = _ppc_counts()
  try:
    clock = _ppc_train(_ppc_model(dev), dev, mesh, steps=1)
  finally:
    sharding.psum_ = real
  torch.cuda.synchronize()
  log(f"  (c) NCCL in a group of one: {mesh}; loss {clock.losses}; "
      f"{len(calls)} gradient all-reduces on {sorted(set(calls))}")
  if not calls or set(calls) != {"nccl"}:
    raise AssertionError(f"The NCCL step ran {calls} all-reduces.")
  return {"losses": clock.losses, "all_reduces": len(calls),
          "launches": _ppc_delta(before)}


def process_per_card_rank(argv: list[str]) -> int:
  """A rank of phase 29, spawned by :func:`phase_process_per_card`:
  ``RANK WORLD PORT BACKEND DIR PARTS`` (PARTS: ``scans``, ``dp``,
  ``nccl1``, comma-separated). Writes ``rank{RANK}.json`` into DIR."""
  rank, world, port = int(argv[0]), int(argv[1]), int(argv[2])
  backend, root, parts = argv[3], argv[4], argv[5].split(",")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  multihost.initialize(f"localhost:{port}", world, rank, backend=backend)
  dev = torch.device("cuda", torch.cuda.current_device())
  out = {"rank": rank, "device": str(dev), "backend": backend}
  if "scans" in parts:
    out["scans"] = _ppc_scans(dev, rank, world)
  if "dp" in parts:
    out["dp"] = _ppc_dp(dev, rank, world)
  if "nccl1" in parts:
    out["nccl1"] = _ppc_nccl_one(dev)
  with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
  torch.distributed.barrier()
  torch.distributed.destroy_process_group()
  return 0


def _ppc_spawn(world: int, backend: str, parts: str, root: str) -> list[dict]:
  """Starts ``world`` ranks of this script (fresh interpreters that import
  torch and the port), waits for them (a failed rank ends the others) and
  relays their output; returns their results."""
  with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
  here = os.path.dirname(os.path.abspath(__file__))
  procs = []
  for rank in range(world):
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "RANK")}
    env.update(PYTHONPATH=here, LOCAL_RANK=str(rank))
    procs.append(subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), PPC_RANK_FLAG, str(rank),
         str(world), str(port), backend, root, parts],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
  outputs = [[] for _ in procs]
  readers = [threading.Thread(target=lambda p=p, o=o: o.extend(p.stdout),
                              daemon=True) for p, o in zip(procs, outputs)]
  for reader in readers:
    reader.start()
  deadline = time.monotonic() + PPC_TIMEOUT_S
  try:
    while any(p.poll() is None for p in procs):
      if (time.monotonic() > deadline
          or any(p.poll() not in (None, 0) for p in procs)):
        break
      time.sleep(0.2)
  finally:
    for p in procs:
      if p.poll() is None:
        p.kill()
      p.wait()
    for reader in readers:
      reader.join(timeout=10)
  for rank, lines in enumerate(outputs):
    for line in lines:
      log(f"  [rank {rank}] {line.rstrip()}")
  codes = [p.returncode for p in procs]
  if codes != [0] * world:
    raise AssertionError(f"Phase 29's {backend} ranks ({parts}) exited with "
                         f"{codes}.")
  results = []
  for rank in range(world):
    with open(os.path.join(root, f"rank{rank}.json")) as f:
      results.append(json.load(f))
  return results


def phase_process_per_card(dev) -> dict[str, dict]:
  """Phase 29: one process a card. (a) two gloo ranks on the card: the
  pmap-regime scan and the channel-split scan over a process mesh, bit for
  bit against the single-controller meshes, and their product-scan calls
  against the plain versions; (b) the same ranks: train_loop(mesh=) of
  the 2B at PPC_BLOCKS blocks over a data axis of two processes (one row
  of phase 6's batch each), the replicas bit for bit equal after every
  step, the losses within PPC_LOSS_REL_ERR of the single-controller loop
  over a (2,) data mesh, every step's loss within PPC_LOSS_ABS_ERR of the
  unsharded loop's, step 1's gradients, the last weights and the updates
  within phase 26's leaf limits of it, in turns; where
  the machine has two cards, the same over NCCL one card a rank; (c) one
  process, NCCL in a group of one, one step equal to (b)'s
  single-controller first step. Returns the kernels line's rows it adds
  to."""
  del dev  # the ranks take their own cards
  phase_start = time.perf_counter()
  rows = {name: dict(launches=0, max_abs_err=0.0) for name in PPC_NAMES}
  log(f"== phase 29: one process a card ({PPC_WORLD} gloo ranks share the "
      f"card: no speed-up is possible, and gloo stages CUDA tensors through "
      f"the host)")
  root = tempfile.mkdtemp(prefix="chip-smoke-ppc-")
  try:
    ranks = _ppc_spawn(PPC_WORLD, "gloo", "scans,dp", root)
    if torch.cuda.device_count() >= 2:
      _ppc_spawn(PPC_WORLD, "nccl", "dp", root)
    for name in os.listdir(root):
      os.remove(os.path.join(root, name))
    (one,) = _ppc_spawn(1, "nccl", "nccl1", root)
  finally:
    shutil.rmtree(root, ignore_errors=True)
  for r in ranks:
    add_launches(rows, r["scans"]["launches"])
    for turn in r["dp"]["turns"]:
      add_launches(rows, turn["launches"])
  add_launches(rows, one["nccl1"]["launches"])
  for name, err in {**ranks[0]["dp"]["max_abs_err"],
                    **ranks[0]["scans"]["max_abs_err"]}.items():
    rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
  dp = [turn for r in ranks[:1] for turn in r["dp"]["turns"]]
  refs = ranks[0]["dp"]["references"]
  sc, unsharded = refs[0]["sc"], refs[0]["one"]
  rel = max(abs(g - w) / abs(w) for g, w in zip(dp[0]["losses"], sc["losses"]))
  log(f"  (b) DP losses {dp[0]['losses']} vs single-controller "
      f"{sc['losses']}: largest rel {rel:.3e} (tolerance "
      f"{PPC_LOSS_REL_ERR}); largest leaf difference after {PPC_STEPS} steps "
      f"{refs[0]['sc_max_leaf_diff']:.3e} (predicted 0: two-term sums)")
  if not rel <= PPC_LOSS_REL_ERR:
    raise AssertionError(f"DP losses {dp[0]['losses']} vs single-controller "
                         f"{sc['losses']}.")
  # Against the unsharded loop: every step's loss within PPC_LOSS_ABS_ERR
  # nats (the repeated batch drives the loss towards 0, where a relative
  # gap says nothing); step 1's gradients by phase 26's leaf rule; the
  # weights after the last step within Adam's bound, and the steps'
  # updates over the whole tree by phase 26's limits.
  gaps = [abs(g - w) for g, w in zip(dp[0]["losses"], unsharded["losses"])]
  rms, cosine = refs[0]["grad_stats"]
  leaves = refs[0]["leaf_stats"]
  log(f"  (b) vs the unsharded loop {unsharded['losses']}: the losses' gaps "
      f"{[f'{g:.3e}' for g in gaps]} nats (limit {PPC_LOSS_ABS_ERR}); step "
      f"1's gradients' worst leaf rel RMS {rms:.3e}, lowest cosine "
      f"{cosine:.6f} (limits {GRAD_LEAF_REL_RMS}, {GRAD_LEAF_MIN_COSINE}); "
      f"the weights after {PPC_STEPS} steps: {leaves['equal_leaves']} of "
      f"{leaves['leaves']} leaves bit for bit, the largest gap "
      f"{leaves['adam_bound_ratio']:.3f} of Adam's bound (limit 1), "
      f"{100 * leaves['beyond_lr_share']:.4f} % of the elements apart by "
      f"more than lr; the updates over the tree: rel RMS "
      f"{leaves['update_rel_rms']:.3e}, cosine {leaves['update_cosine']:.6f} "
      f"(limits {GRAD_LEAF_REL_RMS}, {GRAD_LEAF_MIN_COSINE}); by leaf: "
      f"worst rel RMS {leaves['leaf_worst_rel_rms']:.3e}, median "
      f"{leaves['leaf_median_rel_rms']:.3e}, lowest cosine "
      f"{leaves['leaf_lowest_cosine']:.6f}")
  if not (len(gaps) == PPC_STEPS and max(gaps) <= PPC_LOSS_ABS_ERR
          and rms <= GRAD_LEAF_REL_RMS and cosine >= GRAD_LEAF_MIN_COSINE
          and leaves["adam_bound_ratio"] <= 1.0
          and leaves["update_rel_rms"] <= GRAD_LEAF_REL_RMS
          and leaves["update_cosine"] >= GRAD_LEAF_MIN_COSINE):
    raise AssertionError("The DP run and the unsharded loop disagree.")
  (nccl_loss,), want = one["nccl1"]["losses"], sc["losses"][0]
  log(f"  (c) NCCL group of one: loss {nccl_loss} vs (b)'s single-controller "
      f"first step {want} (rel {abs(nccl_loss - want) / abs(want):.3e}); "
      f"{one['nccl1']['all_reduces']} all-reduces")
  if not abs(nccl_loss - want) <= PPC_LOSS_REL_ERR * abs(want):
    raise AssertionError("The NCCL step's loss differs from the "
                         "single-controller step's.")
  steady = {
      "DP (2 ranks)": [t["steady_ms"] for t in dp],
      "single-controller (2,) mesh": [r["sc"]["steady_ms"] for r in refs],
      "unsharded": [r["one"]["steady_ms"] for r in refs]}
  log(f"  (d) steady ms a step in turns (DP, single-controller, unsharded, "
      f"DP, unsharded, single-controller): "
      f"{ {k: [round(v, 1) for v in vs] for k, vs in steady.items()} }; "
      f"the gradient all-reduce "
      f"{[round(100 * t['reduce_share'], 1) for t in dp]} % of a DP step "
      f"({[round(float(np.mean(t['reduce_ms'][1:])), 1) for t in dp]} ms); "
      f"peak GB per rank {[round(r['dp']['peak_gb'], 2) for r in ranks]}")
  log(f"== phase 29 {time.perf_counter() - phase_start:.1f} s; its launches "
      f"{ {k: r['launches'] for k, r in rows.items()} }")
  return rows


def add_launches(rows: dict[str, dict], launches: dict[str, int]) -> None:
  for name, n in launches.items():
    rows[name]["launches"] += n


def add_phase_rows(kernels: list[dict], rows: dict[str, dict]) -> None:
  """Adds a phase's launches, errors and shard-shape figures (every other
  key a row holds) to the kernels line's rows by name."""
  by_name = {kernel["name"]: kernel for kernel in kernels}
  for name, row in rows.items():
    kernel = by_name[name]
    kernel["launches"] += row["launches"]
    kernel["max_abs_err"] = max(kernel["max_abs_err"], row["max_abs_err"])
    kernel.update({key: value for key, value in row.items()
                   if value and key not in ("launches", "max_abs_err")})


def add_row_launches(kernels: list[dict], launches: dict[str, int]) -> None:
  """Adds ``launches`` to the kernels line's rows by name."""
  by_name = {kernel["name"]: kernel for kernel in kernels}
  for name, n in launches.items():
    by_name[name]["launches"] += n


def main() -> int:
  if sys.argv[1:2] == [PPC_RANK_FLAG]:
    return process_per_card_rank(sys.argv[2:])
  profile = "--profile" in sys.argv[1:]
  if not torch.cuda.is_available():
    print("chip_smoke.py needs a CUDA device; none is available.",
          file=sys.stderr)
    return 1
  # References in float32 mean full float32.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device("cuda", 0)
  torch.cuda.set_device(dev)
  start = time.perf_counter()

  device = phase_card()
  phase_build()
  kernels = [phase_lru(dev), phase_attention(dev)]
  model, vocab, prompts, sampler, single = phase_main_path(dev, kernels,
                                                           profile)
  phase_serving(dev, model, vocab, prompts, sampler, single, kernels, profile)
  phase_batcher(dev, model, vocab, prompts, sampler, kernels, profile)
  del model, vocab, prompts, sampler, single
  torch.cuda.empty_cache()
  kernels += [phase_lru_backward(dev), *phase_attention_backward(dev)]
  torch.cuda.empty_cache()
  phase_training(dev, kernels, profile)
  torch.cuda.empty_cache()
  kernels += [phase_mha(dev), phase_add_rmsnorm(dev)]
  phase_multimodal(dev, kernels, profile)
  torch.cuda.empty_cache()
  kernels += [phase_lru_a_prod(dev), phase_attention_kv_prefix(dev)]
  torch.cuda.empty_cache()
  phase_sequence_parallel(dev, kernels, profile)
  torch.cuda.empty_cache()
  kernels += [phase_lru_backward_a_prod(dev),
              *phase_attention_kv_prefix_backward(dev)]
  torch.cuda.empty_cache()
  phase_sp_training(dev, kernels, profile)
  torch.cuda.empty_cache()
  phase_start = time.perf_counter()
  kernels += phase_lru_complex(dev)
  torch.cuda.empty_cache()
  phase_complex_path(dev, kernels)
  torch.cuda.empty_cache()
  kernels += phase_kernel_lab(dev)
  log(f"== the complex scan and lab phases {time.perf_counter() - phase_start:.1f}"
      f" s; total {time.perf_counter() - start:.1f} s")
  torch.cuda.empty_cache()
  handoff = phase_int8(dev, kernels, profile)
  torch.cuda.empty_cache()
  phase_speculative(dev, kernels, handoff)
  torch.cuda.empty_cache()
  phase_constrained(dev, kernels, handoff)
  torch.cuda.empty_cache()
  tp_launches = phase_tensor_parallel(dev, kernels, handoff)
  torch.cuda.empty_cache()
  tp_training_rows = phase_tp_training(dev, handoff)
  torch.cuda.empty_cache()
  tp_extras_rows = phase_tp_extras(dev, handoff)
  torch.cuda.empty_cache()
  pp_rows = phase_pipeline(dev, handoff)
  torch.cuda.empty_cache()
  # Phase 23 writes its checkpoints into ``root``; phase 24 reads the bf16
  # one.
  root = tempfile.mkdtemp(prefix="chip-smoke-export-")
  try:
    phase_export(dev, kernels, handoff, profile, root)
    torch.cuda.empty_cache()
    cli_launches = phase_cli(dev, handoff, root)
  finally:
    shutil.rmtree(root, ignore_errors=True)
  del handoff
  torch.cuda.empty_cache()
  ppc_rows = phase_process_per_card(dev)
  torch.cuda.empty_cache()
  ckpt_dir = tempfile.mkdtemp(prefix="chip-smoke-checkpoints-")
  try:
    handoff = phase_multimodal_sft(dev, kernels, profile, ckpt_dir)
    torch.cuda.empty_cache()
    phase_adapters(dev, kernels, handoff, ckpt_dir)
  finally:
    shutil.rmtree(ckpt_dir, ignore_errors=True)
  add_row_launches(kernels, cli_launches)
  add_row_launches(kernels, tp_launches)
  add_phase_rows(kernels, tp_training_rows)
  add_phase_rows(kernels, tp_extras_rows)
  add_phase_rows(kernels, pp_rows)
  add_phase_rows(kernels, ppc_rows)
  log(f"== total {time.perf_counter() - start:.1f} s")
  print(json.dumps({"kernels": kernels}))
  print(json.dumps({"ok": True, "device": device}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
