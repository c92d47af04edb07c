#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (src/repro_torch) runs on an H100.

    python3 chip_smoke.py          # from the repo root, one card, no arguments

Phases (any failure exits non-zero; nothing is caught and passed over):

1. Kernels. Builds every kernel of the main paths from the sources in the
   checkout (nvcc for the CUDA C++ flash and paged attention, range_count,
   hadd, to_integral and softmax, all started at once; Triton JIT for rmsnorm
   and swiglu), runs each wrapper on the
   card at the main paths' shapes and holds it against its plain PyTorch
   version on the same inputs within the stated tolerance; times kernel,
   plain version and the one PyTorch library call that computes the same
   function (a yardstick only: the port never calls it), and computes each
   case's bound from the bytes and operations its inputs need against the
   H100 SXM datasheet peaks. Every kernel row (here and in 5a) is timed by
   one timer, _timed_device: device time, CUDA events around replays of a
   CUDA graph that captured the calls (DEVICE_TIMING), since a kernel
   shorter than the host's enqueue leaves events around a loop of calls
   timing the host; the events time and the host enqueue stand beside it.
   The paged plain version reads the block tables on the host, which a
   graph cannot capture: it alone is timed by events. Phase 1 also prints,
   per instantiation of the flash forward and backward and the paged
   libraries, ptxas's registers and spills and the tensor-core (HMMA /
   HGMMA) instructions in its SASS (cuobjdump -sass), and fails if a bf16
   one (forward, dq, dk/dv, paged at D 64 and 128; forward and paged at D
   112 too) spills or has none, or a float32 one has any; per softmax instantiation its registers, shared
   memory and spills (any spill fails). The paged cases (serving, the
   serving verify span of SPEC_K + 1 rows, edges, GQA span, a long context,
   batch-1 GQA, float32, and zamba2-7b's decode and verify shapes at D 112
   in both dtypes) print their split plan, the softmax cases theirs
   (kernel.plan: regime, cluster size, chunk, load), and the main paged,
   serving verify, hadd, to_integral and softmax cases their kernels per
   call (torch.profiler; more than one fails). Each softmax case that runs a
   cluster of 16 is also timed and checked at a cluster of 8. No single
   PyTorch call
   computes paged attention: its yardstick is scaled_dot_product_attention
   on the same rows already gathered into contiguous lanes (gather not
   timed). torch.histc(x, bins=1, min=lo, max=hi) counts a range (both ends
   inclusive, NaN ignored): the range count's yardstick on float32 data,
   and on int32 data with whole bounds (it casts its bounds to the data's
   type); none packs a mask
   (library "—"). For the paged serving shape it also times the host's
   enqueue of one call: wrapper, bare launcher and the yardstick. The app's kernels
   run at the app's sizes (2^30 float32, 2^28 int32, the (2^25, 32) mask)
   and at edge lengths (0, 1, 31, 33, 2^20 + 7; bit 31; a view off 16-byte
   alignment; fractional bounds on int32 data; NaN data; masks of random
   bytes); their integer results must equal the plain versions' bit for
   bit. Each to_integral case records the body it took (kernel.body): the
   app's mask must take the vector body, a base off alignment the ballot;
   a softmax row off 16-byte alignment must take element loads.
2. Model. qwen1.5-0.5b at full width (24 layers, d=1024, vocab 151936 padded
   to 152064, bf16, seeded init): Model.prefill on a (2, 512) prompt then 8
   greedy decode steps through the h100 library; the same prefill with the
   plain versions bound on the card (torch_cpu library) must agree. Then one
   fused paged decode step at batch 8 over 256 prefilled rows, through the
   paged kernel and through its plain version on the same pools: logits
   must agree as the prefill's do. Both checks give each row an argmax
   verdict (argmax_verdicts): equal argmaxes agree; differing ones get no
   verdict where the plain logits of the two tokens lie within TIE_ULPS
   bf16 ulps at the row's largest |plain logit| (a tie the bf16 output
   cannot order), and fail otherwise.
2b. Verify step. One fused paged verify step at batch 8, a span of SPEC_K + 1
   tokens at 256 prefilled rows, through the paged kernel and through its
   plain version on copies of the same pools: all 40 span rows under the
   same check; row 0 of the span against a fused decode step from the same
   pools (a verify span of one is the decode step).
3. Serve. repro_torch.launch.serve.main at full width: 8 requests of 256
   prompt tokens and 64 generated tokens over 8 slots, 64-token chunks.
   Every serve of phases 3, 3b and 3e but 3e(i) runs twice on the same
   requests (paired_serve; 3e(i)'s eager twin is dropped for time): with the engine's captured steps (CUDA graphs, the
   default) and under serve.disable_graphs(), the order alternating from
   pair to pair, each under device tracing (torch.profiler, CUDA activity
   only) with its launches read around it. A pair fails unless the greedy
   outputs, every report counter (SERVE_COUNTED, report["paged"] and
   report["spec"] in full, the per-request counts) and the launch counters
   are equal, the graphs run captured its steps (report["jit_cache"]) and
   the eager run none; it prints both ways' decode tokens/s, TTFT mean,
   wall and the device's idle share over the serve (1 - busy / host wall,
   busy the union of the device records).
3b. Paged serve. ServeEngine(paged=PagedConfig(page_size=64)) at full width
   with phase 2's params: 16 requests sharing a 128-token system prompt plus
   128 tokens each, 64 generated, 8 slots, max_len 320, 64-token chunks,
   greedy. Fails unless decode ran fused (no lane activation), the prefix
   was shared, nothing was refused, every request got 64 tokens and the
   paged kernel launched 24 times per decode step; prints the share of
   requests whose tokens equal a lane-mode run's on the same requests
   (information only: bf16 kernels may flip a near-tied argmax).
3e. Speculative paged serve. ServeEngine(paged=..., speculation=...) at 3b's
   shape with phase 2's params, greedy: (i) depth SPEC_K on 3b's 16
   requests; (ii) the cost-priced depth with the n-gram drafter on 8
   prompts that repeat a seeded 16-token pattern to 256 tokens, beside the
   same requests without speculation (a pair of its own: the two graphs
   runs give what speculation buys end to end); (iii) the draft-model drafter
   (qwen1.5-0.5b with the target's weights) at depth SPEC_K on 8 of them.
   Each fails unless decode ran fused (no lane activation), nothing was
   refused, every request got 64 tokens and the paged kernel launched 24
   times per decode or verify step; (i) and (ii) unless verify steps ran,
   (iii) unless drafts were accepted. Prints tokens/s, the accepted rate,
   the mean accepted span, slot steps per emitted token and the mean
   depth, and the share of (i)'s requests whose tokens equal 3b's
   (information only).
3f. int8 paged serve. 3b's requests and engine shape under
   PagedConfig(int8=True), the page budget the bytes of 3b's default bf16
   pool, paired (graphs first; both sides untraced: reading a side's ~1.7
   million device records took longer than the serve; a captured int8
   decode step's idle share is phase 4's). Fails unless
   report["paged"]["int8"] is true, decode ran fused, every request got 64
   tokens and the paged kernel launched no time (int8 pools take the plain
   version by their dtype, as the reference's take its jnp scan), rmsnorm
   and swiglu launching. Prints the pages against 3b's, tokens/s, TTFT, and
   the share of requests whose tokens equal 3b's (information only). Then
   one fused int8 decode step at batch 8 over 256 rows against the same
   step through the
   CUDA kernel over bf16 pools holding the dequantized rows
   (_require_logits), and captured against eager through the engine's step
   code: logits and pools bit-equal, launches equal.
3g. Long-context serve. 4 requests sharing a 3584-token document plus 512
   tokens each, 64 generated, batch 4, max_len 4160, page 64, 256-token
   chunks, one bucket of 4096: fails unless kernel.plan splits each KV
   head's keys at the engine's table width (65); paired (eager first) under
   3b's checks (24 paged launches a decode step, the document shared).
3h. Streaming. run() on 4 of 3b's requests while a thread submit()s 12 more
   at seeded Poisson times once decoding is under way, then a duplicate rid
   and a gen_len of 0: every valid request answered with the tokens of an
   all-at-once run of the 16 (run first, not counted), both invalid ones
   refused, the streamed run under 3b's checks (fused, 24 paged launches a
   decode step), a streamed request admitted after the first step; prints
   arrival-to-first-token times.
3c. App. The paper's range-count app (Fig 8) through
   repro_torch.launch.quickstart.main on 2^30 float32 uniforms in
   [0, 100000) (4 GiB, the paper's size) and 2^28 int32 in [0, 100), each
   with the quickstart's range and one that selects about half: the fused,
   popcount, composed and hand-written counts must be equal, and a 2^20
   prefix's count equal the torch_cpu library's on the host. Each way is
   timed (GiB/s against 3.35 TB/s), and the composed way's peak memory read.
3d. Generated suite. The h100 library generated with its tests (paper
   §4.1); every generated test function runs on the card; any failure
   fails the phase.
4. Step profile. The step kinds the serving engines run, on phase 2's
   model at the serve phases' shapes, each through the engine's own step
   code (serve/graphs.py, input staging included) — a lane decode step, a
   fused paged decode step on bf16 and on int8 pools and a fused paged
   verify step (span SPEC_K + 1)
   over 8 slots at position 256, one 64-token prefill chunk into a batch-1
   donor, and the draft model's decode step (3e(iii)'s drafter) — captured
   (one replay a call) and under disable_graphs(), each timed on the host
   clock (synchronised wall per step) and traced with torch.profiler
   (device busy time, kernels per step, the kernels that take the time).
   The device's idle share is 1 - busy / wall. The verify step's tokens at
   full acceptance are printed beside the decode step's (40 against 8).
4b. Multi-split step. One captured fused paged decode step at batch 1 over
   MULTI_SPLIT_FILL prefilled rows, where kernel.plan splits each KV head's
   keys (it fails on one split), so the merge runs in the step's fixed
   workspace: its replay's logits against the same step under
   disable_graphs() (_require_logits; the largest difference printed), and
   the replay must add the paged launches its capture recorded.
5. Train. qwen1.5-0.5b at full width (bf16 params, float32 AdamW moments),
   batch 8 x 512 seeded random tokens, through Model.loss (remat) and
   repro_torch.train.
5a. The training kernels (flash forward with lse, dq, dk/dv) against their
   plain versions at the train shape (8, 16, 512, 64) causal bf16, the GQA
   case (2, 40 over 8 KV heads, 512, 128), a kv_len < Sk and an Sq > Sk case
   (rows that see no key: lse and dq exactly 0) and float32, under the
   scale-relative gates of repro_torch.gates; each timed by device time
   only beside its plain version, its bound and its library yardstick (the
   forward: aten._scaled_dot_product_flash_attention, which returns a logsumexp;
   dq + dk/dv: the backward of F.scaled_dot_product_attention through
   autograd, one number for the three gradients).
5b. The loss and every parameter's gradient on one batch, through the h100
   library (the kernels) and through the plain versions bound on the card
   (torch_cpu library): losses within 5e-3 relative, every leaf's gradient
   non-zero and within 5e-2 relative L2 of the plain path's.
5c. make_train_step for 5 AdamW steps (lr 3e-4, no warmup) on that batch:
   each step's loss, grad_norm, synchronised wall ms, device busy share
   (torch.profiler) and peak memory; every loss finite and the fifth below
   the first; the same 5 steps through the plain versions, each loss
   within 5e-3 of the kernels'. Where the step's device time goes: the top
   kernels, the three training kernels' share, the GEMMs' share and the
   152064-wide cross-entropy's forward + backward (timed alone).
5d. The compiled train step (train/graphs.py: compile_train_step, one CUDA
   graph over the donated train state) against the eager step under
   disable_graphs(), from clones of one state on the same SyntheticTokens
   batches of 8 x 512, with warmup over every step (lr and both bias
   corrections change each step): float32 moments for 6 steps; int8
   moments, 2 microbatches and --compress-grads for 3 each. Fails unless
   every metric at every step (loss, ce, aux, grad_norm, lr, compress_err)
   and every param and moment leaf at the end are bit-equal, each run's
   launches per step are phase 5c's (twice with 2 microbatches), lr changes
   every step, the compiled step has one entry and replays every step after
   the first. Prints per configuration, captured and eager: host wall of
   the synchronised steps, the traced step's host wall, device busy, idle
   share and device records, kernels per step, the first call's and the
   capture's seconds, peak allocated and reserved memory (absolute, and
   above the run's start: the eager run holds its input state and makes a
   new one, the captured run updates its state in place beside the pool).
6. Train CLI. repro_torch.launch.train.main at full width (phase 5's
   model and batch, SyntheticTokens batches), checkpoints in a temporary
   directory removed at the end; each run's launch counters are set to 0
   just before it and read just after. The CLI runs the compiled step
   (a restart restores into a fresh compiled step).
6a. int8 optimizer moments and two microbatches: 6 steps with a checkpoint
   every 3, a restart at --steps 9 that restores step 6, and the same 9
   steps uninterrupted. Fails unless step_3, step_6 and step_9 are
   committed, step_9's data state is 9, every loss is finite, the restarted
   steps 7-9 are within LOSS_REL of the uninterrupted run's (the largest
   difference is printed), every run launches exactly twice phase 5c's
   kernels per step, and the int8 moments (q + scale, from the manifest)
   take at most INT8_STATE_SHARE of float32 moments' bytes. The same 9
   steps again under disable_graphs() (the eager twin): every logged loss,
   the first and the final loss equal to the compiled run's, the same
   launches. Prints tokens/s of each run, peak memory and the loop's
   seconds in checkpoint saves.
6b. --compress-grads against none, 5 steps each: every loss finite and
   within LOSS_REL; compress_err of make_train_step on the first batch in
   (0, max|g| (1/254 + 2^-8)]: the wire format's amax/254 plus one bf16
   rounding of the cast back.
6c. make_train_step(OptConfig(moment_dtype="int8", warmup_steps=0),
   microbatches=2) for 3 steps on three SyntheticTokens batches through the
   kernels, and at each step the plain versions' step from the same state:
   each loss within LOSS_REL, each grad_norm within full_width_bf16's 5e-2
   (|d ||g||| <= ||d g||). int8 moments diverge from the third step at this
   vocabulary, in the reference's arithmetic too, so two trajectories would
   compare the divergence, not the kernels.
7. rwkv6-7b at full width (32 layers, d 4096, 64 WKV heads of 64, d_ff
   14336, vocab 65536, bf16, layernorm; 7.53 B parameters), seeded weights
   from the port's init on the card, after every earlier model is freed.
   No hand-written kernel but rmsnorm (ln_x) lies on its path: its WKV
   recurrence, token shift, silu and sigmoid are plain torch, as jnp in the
   reference.
7a. The h100 library's wkv6_scan (the chunked form, chunk 32) against the
   torch_cpu library's time-step scan, float32, at RWKV_PREFILL x (64, 64)
   with decays from layer 0's _decay: the largest difference relative to
   max |y| and to max |s| within WKV_REL_TOL. Then a model on each library,
   sharing the params: one prefill of RWKV_PREFILL tokens and DECODE_STEPS
   greedy decode steps, every logits row under _require_logits.
7b. Lane serve at phase 3's shapes (8 x (256 + 64), 8 slots, chunk 64),
   7c paged (PagedConfig(), phase 3b's requests: nothing pages, so fused is
   false, requests activate through lanes, the system prompt is shared as
   the tail state at its 128-row boundary; tokens equal a lane-mode run's),
   7d the n-gram drafter at depth SPEC_K on 8 of 3e(ii)'s prompts (verify steps
   each followed by their commit, jit_cache "commit"; the share of requests
   equal to a non-speculative serve's is information only). Each a
   paired_serve (captured vs eager: equal outputs, counters, launches; 7b's
   graphs side traced) under rwkv_launch_check: rmsnorm exactly n_layers a
   decode step, a prefill chunk and twice a verify step (its commit), and
   swiglu, flash and paged attention never. Phase 4's rwkv rows: the
   decode step and the verify step with its commit at depth SPEC_K,
   captured vs eager. 7b-7d and phase 4's rwkv rows run RWKV_SERVE_LAYERS
   (4) of its 32 layers, its widths kept (the first layers of 7a's
   weights), for phase 8's room in the script's time.
8. zamba2-7b at full width (81 layers: 13 groups of 6 Mamba2 layers, each
   followed by the one shared attention block, then 3; d 3584, 32 attention
   heads of 112, d_inner 7168 in 112 SSD heads of 64, N 64, conv 4, vocab
   32000, bf16; 6.60 B parameters), seeded weights from the port's init on
   the card, after rwkv6-7b's are freed. Its path runs three kernels: rmsnorm
   (every block norm, the gated norm at width 7168), the flash forward at D
   112 (Model.prefill) and the paged kernel at D 112 (fused paged decode,
   verify and commit); the SSD, conv, silu and discretization are plain
   torch, as jnp in the reference.
8a. The main path, counted: Model.prefill of ZAMBA_PREFILL tokens (the flash
   kernel ZAMBA_SHARED = 13 times) and DECODE_STEPS bf16 decode steps. Not
   counted: the flash kernel against its plain version at each of the 13
   applications of a bf16 prefill, and the paged kernel at each of a bf16
   fused paged decode step's and verify span's (batch 8 over 256 rows), on
   the activations the model gives them (TOLERANCE); ssd_scan chunked (h100,
   chunk 64) against the time-step scan (torch_cpu), float32, within
   SSD_REL_TOL; at ZAMBA_F32_LAYERS (7) of its layers, widths kept, the
   float32 model's prefill and decode steps on each library, and its fused
   paged decode and verify steps kernel vs plain, within ZAMBA_F32_REL_L2.
   The full-depth model against the plain library's is printed, not gated:
   the seeded layers amplify a difference layer after layer (a float32
   prefill apart by 9.5e-3 at 81 layers, 1.1e-4 at 13, from the SSD's
   summation order and the kernels' roundings), and in bf16 one ulp moves a head's bf16-rounded decay (a decode
   step from a shared state apart by rel L2 0.42, parting at layer 4).
8b. The serve CLI (--arch zamba2-7b) at phase 3's shapes, lane mode; 8c
   fused paged mode on phase 3b's requests (one prefix miss, 15 hits plus
   one a preemption, the tails in the slot table, the KV in the pools; the
   share of the first wave's tokens equal to a lane-mode run's printed); 8d
   the n-gram drafter at depth SPEC_K on 8 of 3e(ii)'s prompts,
   fused paged (the graphs run must capture the paged commit). Each a
   paired_serve under zamba_launch_check: rmsnorm 2 n_layers + applications
   + 1 a pass (a decode step or chunk; two a verify step, its commit
   replaying the span), the paged kernel once an application a fused
   decode, verify or commit step, flash and swiglu never. Phase 4's zamba
   rows: the lane and the fused paged decode step, and the fused paged
   verify step with its commit on the pools, captured vs eager. 8c, 8d and
   phase 4's zamba rows run ZAMBA_SERVE_LAYERS (12) of its 81 layers, its
   widths kept (two groups, two applications of the shared block), for
   phase 9's room in the script's time; 8a and 8b keep all 81.
9. whisper-tiny at full width (4 encoder and 4 decoder layers, d 384, 6
   heads of 64, d_ff 1536, vocab 51865 padded to 51968, layernorm, gelu,
   bf16), seeded weights from the port's init on the card, the encoder
   over WHISPER_ENC_LEN (1500) seeded frames (the conv frontend is a stub,
   as in the reference). Its path runs two kernels: the flash forward, non
   causal over the frames in the encoder and as the cross-attention (Sq 64,
   1 and SPEC_K + 1 against 1500 keys, a ragged last key tile), causal in
   Model.prefill's decoder; and the paged kernel (6 heads, group 1) in
   fused paged decode and verify. Layernorm and gelu are plain torch, as
   jnp in the reference.
9a. The main path, counted: Model.prefill of WHISPER_PREFILL tokens over
   (8, 1500, 384) frames (the flash kernel exactly 12 times) and
   WHISPER_DECODE_STEPS bf16 decode steps (exactly 4 each), every one
   against the torch_cpu library's from the same state (LOGITS_REL_L2 and
   the argmax verdicts). Not counted: the flash kernel call by call against
   its plain version in a prefill, a decode step and a first prefill chunk,
   and the paged and flash kernels in a fused paged decode and verify step,
   bf16 and float32 (TOLERANCE), the whole steps kernel vs plain; the
   float32 model at full depth on both libraries within WHISPER_F32_REL_L2.
9b. Lane serve: 16 requests of 64 tokens over their own frames, 192
   generated, 8 slots, chunk 64; 9c fused paged (page and chunk 32): 32
   requests in groups of a clip, the clip again, a twin of other frames and
   that twin again: 16 prefix hits (plus the preemptions') and 16 misses
   exactly, every first token equal to a lane run's; 9d n-gram depth
   SPEC_K on 8 of 3e(ii)'s prompts over seeded frames, fused paged. Each a
   paired_serve under whisper_launch_check: the flash kernel 4 times a
   request's first chunk (the encoder) and 4 times a chunk, decode and
   verify step (the cross-attention), the paged kernel 4 times a fused
   decode or verify step, rmsnorm and swiglu never. Phase 4's whisper rows:
   the lane and the fused paged decode step, captured vs eager.
10. internvl2-2b (the vlm family) at full width (24 layers, d 2048, 16
   heads of 128 over 8 KV heads, d_ff 8192, vocab 92553 padded to 92672,
   bf16), seeded weights from the port's init on the card, VLM_PREFIX (256)
   seeded vision rows (the ViT frontend is a stub, as in the reference)
   projected ahead of every prompt. Its path runs rmsnorm, swiglu, the
   flash forward (GQA 16/8 in Model.prefill) and the paged kernel (group
   2) in fused paged decode and verify.
10a. The main path, counted (lm_steps_vs_plain): Model.prefill of
   VLM_PREFILL tokens behind the vision rows (the flash kernel exactly 24
   times, rmsnorm 49, swiglu 24) and VLM_DECODE_STEPS bf16 decode steps
   (rmsnorm 49 and swiglu 24 each), every one against the torch_cpu
   library's from the same state (LOGITS_REL_L2 and the argmax verdicts).
   Not counted: every flash, rmsnorm and swiglu call of a prefill and a
   decode step (lm_calls_vs_plain) and every paged, rmsnorm and swiglu call
   of a fused paged decode and verify step (lm_paged_check) against its
   plain version, bf16 and float32 (TOLERANCE), the whole steps kernel vs
   plain; the float32 model at full depth on both libraries within
   VLM_F32_REL_L2.
10b. Lane serve: 16 requests of 128 tokens behind their own images, 64
   generated, 8 slots, chunk 64 (the first chunk, with the vision rows, a
   captured step of its own); 10c fused paged (page and chunk 64): 32
   requests in groups over one 128-token head, an image, the image again,
   another image and it again: 16 prefix hits (plus the preemptions') and
   16 misses exactly (the key covers the image), every first token equal to
   a lane run's; 10d n-gram depth SPEC_K on 8 of 3e(ii)'s prompts behind
   seeded images, fused paged. Each a paired_serve under lm_launch_check:
   rmsnorm 2 n_layers + 1 and swiglu n_layers a prefill chunk, decode or
   verify step, the paged kernel n_layers a fused decode or verify step,
   flash never (the chunks attend by the plain chunk attention). Phase 4's
   internvl2 rows: the lane and the fused paged decode step at position
   VLM_PROFILE_FILL, captured vs eager, beside their bound
   (lm_decode_bound_ms).
11. The moe family at full width with a stated cut of layers: no card
   holds a whole grok-1-314b (628 GB in bf16) or arctic-480b (958 GB).
   Their path runs rmsnorm, the flash forward (GQA 48/8, 56/8), the paged
   kernel (group 6) and swiglu inside the h100 expert_ffn (and in arctic's
   dense residual); routing, dispatch and combine are plain torch, as jnp
   in the reference.
11a. grok-1-314b at MOE_LAYERS (4) of 64 layers (42.6 GB): the main path,
   counted (lm_steps_vs_plain: flash exactly 4 a prefill, rmsnorm 9 and
   swiglu 4 a pass), each step against the torch_cpu library under ONE
   routing (its expert ids recorded from a rerun through the h100 library:
   a near-tied router flips on bf16 roundings, and a row routed apart is a
   different result; each library's own routing is printed); every flash,
   rmsnorm and expert_ffn (the swiglu kernel inside against the plain
   swiglu) call of a prefill and a decode step against its plain version,
   and every moe_dispatch against the torch_cpu library's on the same
   operands, exactly (the kept mask, the drops counted); the fused paged
   steps' calls; then, after 11b and phase 4's row, the float32 model at
   MOE_F32_LAYERS layer (26 GB, the bf16 weights freed first) within
   MOE_F32_REL_L2.
11b. grok at 11a's cut, lane and fused paged serves of 8 × (128 + 32) at
   batch 8, chunk and page 64, the even requests sharing a 64-token head
   (fused: 1 miss for it and one for each other request's first page, the
   rest hits), paired_serve under lm_launch_check, every first token equal
   across the modes. Phase 4's row: a captured grok decode step (every
   expert read: expert_ffn computes each expert's capacity rows).
11c. arctic-480b at ARCTIC_LAYERS (1) of 35 layers (28.2 GB): 11a's main
   path and kernel calls (swiglu twice a pass: the experts' and the dense
   residual's).

A captured step adds to each counter, on every replay, the launches its
capture recorded, so the counters read the same with graphs and without.
The launch counters are set to 0 before phase 2 and read after phase 3
(both runs of its pair):
every kernel of that main path must have launched on it (flash attention in
Model.prefill, rmsnorm and swiglu in every layer of serving). They are set
to 0 again just before phase 3b and read just after it for the paged path
(paged attention, rmsnorm and swiglu; both runs of its pair), just before
phase 3e and read just
after it for the speculative paged path (the paged row's launches_phase3e;
each 3e run's own counts are read around it), just before phase 3f and read
just after it for the int8 paged path (launches_phase3f: the paged kernel
none), just before phase 3g and read just after it for the long-context path
(launches_phase3g), just before phase 3h's streamed run and read just
after it for the streaming path (launches_phase3h; 3h's all-at-once
comparison run comes before and is not counted), just before phase 3c and read
just after it for the app path (range_count, hadd, to_integral), and just
before phase 3d and read just after it for the suite (softmax), and just
before phase 5c and read just after it for training (flash forward with
lse, dq, dk/dv: 48, 24 and 24 per step with remat; rmsnorm 4L + 1 and
swiglu 2L per step), around each run of phase 5d (the same per step), and
around each train CLI run of phase 6 (twice those per step: two
microbatches). The training kernels' rows carry the three paths' counts
(launches_phase5c; launches_phase5d: the compiled float32 run's 6 steps;
launches_phase6: the 9 uninterrupted steps). They are set to 0 again just
before each of phase 7b, 7c and 7d and read just after it (rmsnorm's row:
launches_phase7b, launches_phase7c, launches_phase7d). They are set to 0
just before phase 8a's main path and read just after it (rows 1 and 3:
launches_phase8a), and just before each of 8b, 8c and 8d and read just
after it (row 1: launches_phase8b-8d; row 7: launches_phase8c, 8d), and
likewise around phase 9a's main path and each of 9b, 9c and 9d (row 3:
launches_phase9a-9d; row 7: launches_phase9c, 9d), around phase 10a's, 11a's
and 11c's main paths and each of 10b, 10c, 10d and 11b's two serves (rows 1
and 2: launches_phase10a-11c; row 3: 10a, 11a, 11c; row 7: 10c, 10d,
11b-paged).
Launches made to compare a kernel with its plain version, and those of
phases 4 and 4b (measurements), are not counted.

The [done] line prints each phase's seconds of command time.
Stdout ends with the card's name and power limit (nvidia-smi), one JSON line
{"kernels": [...]}, and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import io
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM datasheet peaks (dense): the roofline the bounds are taken against
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"torch.bfloat16": 989e12, "torch.float32": 67e12,
                  # int32 outside the tensor cores: half the f32 rate (an
                  # H100 SM has 64 INT32 lanes beside its 128 FP32 lanes)
                  "torch.int32": 33.5e12}

# |kernel - plain| <= ATOL + RTOL * |plain|, per dtype: bf16 output may differ
# by one rounding step (2^-7 relative) where the f32 sums round differently;
# f32 differs only by summation order. Softmax scales ATOL by 1/d on rows
# of width d (check_case's atol_scale): a probability is ~1/d, not ~1.
# float16 (softmax only) as bf16: one rounding step, 2^-11 relative, or 2^-24
# absolute below 2^-14, where a vocabulary row's probabilities lie (under
# ATOL/d for d < 167772)
TOLERANCE = {"torch.bfloat16": (1e-2, 1e-2), "torch.float32": (1e-4, 1e-4),
             "torch.float16": (1e-2, 1e-2)}

ARCH = "qwen1.5-0.5b"
PREFILL_SHAPE = (2, 512)
DECODE_STEPS = 8
# end-to-end bf16 bound for prefill logits, kernels vs plain versions:
# ||kernels - plain||_2 / ||plain||_2 over the last-position logits
LOGITS_REL_L2 = 3e-2
# phase 2's argmax verdict (argmax_verdicts): a row whose kernel argmax
# differs from the plain one gets no verdict only where the plain logits of
# the two tokens lie within TIE_ULPS bf16 steps (ulps) at the row's largest
# |plain logit|: the logits are bf16, so one step there is the finest
# difference the plain output can state. Fixed here, never taken from a
# run's measured error (every flip has a gap below the kernel's error). One
# ulp at |x| is at most 2^-7 |x|, so tau <= 2^-7 max|logit|, inside the
# LOGITS_REL_L2 max|logit| the prefill check allowed before.
TIE_ULPS = 1
# phase 3: the serve CLI, one wave of 8 slots (the script's time; no gate
# needs more)
SERVE_ARGS = ["--arch", ARCH, "--batch", "8", "--prompt-len", "256", "--gen-len", "64",
              "--requests", "8", "--prefill-chunk", "64", "--device", "cuda"]
# phase 3b: paged serving with a shared system prompt, twice the slots in
# requests (3e(i), 3f, 7c and 8c serve the same requests)
PAGED_REQUESTS, PAGED_SYSTEM, PAGED_UNIQUE, PAGED_GEN = 16, 128, 128, 64
PAGED_BATCH, PAGED_MAX_LEN, PAGED_CHUNK, PAGE = 8, 320, 64, 64
# phase 3e: speculative paged serving at 3b's shapes; the draft depth of
# 3e(i) and (iii) (attention_verify's k_max); (ii)'s prompts repeat a seeded
# pattern of SPEC_PATTERN tokens up to SPEC_PROMPT tokens, SPEC_REQUESTS of
# them
SPEC_K = 4
SPEC_REQUESTS, SPEC_PROMPT, SPEC_PATTERN, SPEC_DRAFT_REQUESTS = 8, 256, 16, 8
# phase 4: the serve phase's slot table (8 slots of 256 + 64 rows), decode at
# the first generated position, a chunk that ends there; 10 traced steps
PROFILE_BATCH, PROFILE_FILL, PROFILE_CHUNK, PROFILE_GEN = 8, 256, 64, 64
PROFILE_STEPS = 10
# phase 4b: one fused paged decode step at batch 1 over MULTI_SPLIT_FILL
# prefilled rows, where kernel.plan splits the keys of each KV head
MULTI_SPLIT_FILL = 4096
# phase 3g: a long-context fused paged serve on which the paged kernel splits:
# LONG_REQUESTS requests share a LONG_DOC-token document and add LONG_OWN
# tokens each (one bucket), then generate LONG_GEN; batch LONG_BATCH,
# LONG_CHUNK-token chunks, room for LONG_MAX_LEN rows (a table of 65 pages);
# one wave of LONG_BATCH
LONG_REQUESTS, LONG_DOC, LONG_OWN, LONG_GEN = 4, 3584, 512, 64
LONG_BATCH, LONG_CHUNK, LONG_MAX_LEN = 4, 256, 4160
# phase 3h: run() starts on STREAM_FIRST of 3b's requests; a thread submits
# the rest of the first STREAM_TOTAL at seeded Poisson times, STREAM_GAP_S
# apart on average, once decoding is under way
STREAM_FIRST, STREAM_TOTAL, STREAM_GAP_S = 4, 16, 0.01
# phase 7: rwkv6-7b at full width. 7a holds the h100 library's wkv6_scan
# (chunked, chunk 32) to the torch_cpu time-step scan at RWKV_PREFILL x
# (64 heads, 64) in float32: their largest difference relative to max |y|
# and to max |s| within WKV_REL_TOL (the two sum the same products in other
# orders, through log-space decay products; a structural fault errs by
# O(1)); its prefill is RWKV_PREFILL tokens. 7b serves phase 3's shapes
RWKV_ARCH = "rwkv6-7b"
RWKV_PREFILL = (4, 256)
WKV_REL_TOL = 1e-3
# 7a's float32 model, h100 vs torch_cpu library: phase 5b's float32 bound
RWKV_F32_REL_L2 = 1e-4
RWKV_SERVE_REQUESTS, RWKV_PROMPT, RWKV_GEN = 8, 256, 64     # phase 3's
# 7b-7d serve rwkv6-7b at RWKV_SERVE_LAYERS of its 32 layers, its widths kept
# (the first RWKV_SERVE_LAYERS layers of the seeded weights): room in the
# script's time for phase 8; 7a and phase 4's rwkv rows keep all 32
RWKV_SERVE_LAYERS = 4
# phase 8: zamba2-7b at full width. 8a holds the h100 library's ssd_scan
# (chunked, chunk 64) to the torch_cpu time-step scan at ZAMBA_PREFILL x
# (112 heads, P 64, N 64) in float32: their largest difference relative to
# max |y| and to max |h| within SSD_REL_TOL (the two sum the same products in
# other orders, through log-space decay products; a structural fault errs by
# O(1)); its prefill is ZAMBA_PREFILL tokens. The serves take phase 7's
# shapes, at full depth
ZAMBA_ARCH = "zamba2-7b"
ZAMBA_PREFILL = (2, 512)
SSD_REL_TOL = 1e-5
ZAMBA_F32_REL_L2 = 1e-4         # 8a's float32 model, h100 vs torch_cpu: phase 5b's bound
ZAMBA_SHARED = 13               # applications of zamba2-7b's shared attention block
ZAMBA_GATED_WIDTH = 7168        # zamba2-7b's d_inner, the gated rmsnorm's row (phase 1)
ZAMBA_SERVE_ARGS = ["--arch", ZAMBA_ARCH] + SERVE_ARGS[2:]
ZAMBA_SPEC_GEN = 32             # 8d's tokens a request (the script's time)
# 8c, 8d and phase 4's zamba rows run ZAMBA_SERVE_LAYERS of its 81 layers,
# its widths kept (two groups of 6 and two applications of the shared
# block, zamba_cut): room in the script's time for phase 9; 8a and the 8b
# CLI serve keep all 81
ZAMBA_SERVE_LAYERS = 12
# 8a's float32 gates run zamba2-7b at ZAMBA_F32_LAYERS of its 81 layers,
# widths kept (one group of 6, the shared block, 1 remainder layer): its
# seeded layers amplify a difference layer after layer (phase 8a's
# chunked-vs-scan SSD, 8e-7 in a layer, reaches 9.5e-3 of the float32
# prefill's logits at 81 layers and 1.1e-4 at 13)
ZAMBA_F32_LAYERS = 7
# phase 9: whisper-tiny at full width over WHISPER_ENC_LEN frames (Whisper's
# 30-second window after its conv frontend, which is a stub: the frames are
# seeded embeddings). 9a: Model.prefill of WHISPER_PREFILL decoder tokens and
# WHISPER_DECODE_STEPS decode steps; 9b: WHISPER_REQUESTS requests of
# WHISPER_PROMPT + WHISPER_GEN rows (256 of its 448-token decoder context) at
# batch WHISPER_BATCH, chunks of WHISPER_CHUNK; 9c: WHISPER_PAGED_REQUESTS at
# 9b's lengths, fused paged at page and chunk WHISPER_PAGE, so that a
# 64-token prompt shares its first WHISPER_SHARED rows (a page); phase 9a's
# paged steps at fill WHISPER_FILL
WHISPER_ARCH = "whisper-tiny"
WHISPER_ENC_LEN = 1500
WHISPER_PREFILL = (8, 64)
WHISPER_DECODE_STEPS = 16
WHISPER_F32_REL_L2 = 1e-4       # 9a's float32 model, h100 vs torch_cpu: phase 5b's bound
WHISPER_REQUESTS, WHISPER_PROMPT, WHISPER_GEN = 16, 64, 192
WHISPER_BATCH, WHISPER_CHUNK, WHISPER_FILL = 8, 64, 128
WHISPER_PAGED_REQUESTS, WHISPER_PAGE, WHISPER_PAGED_CHUNK, WHISPER_SHARED = 32, 32, 32, 32
# phase 10: internvl2-2b at full width, VLM_PREFIX seeded vision rows (one
# ViT tile of patch embeddings: the frontend is a stub, as in the reference)
# ahead of every prompt. 10a: Model.prefill of VLM_PREFILL tokens and
# VLM_DECODE_STEPS decode steps, the float32 model at full depth within
# VLM_F32_REL_L2; 10b: VLM_REQUESTS requests of VLM_PROMPT + VLM_GEN at batch
# VLM_BATCH, chunks of VLM_CHUNK; 10c: VLM_PAGED_REQUESTS fused paged at page
# PAGE, a VLM_SHARED-token head (the share boundary, vision rows included, on
# a page) + VLM_OWN tokens each, VLM_PAGED_GEN generated; 10d: n-gram depth
# SPEC_K, VLM_PAGED_GEN tokens; phase 4's rows at position VLM_PROFILE_FILL
# (10b's mid-generation)
VLM_ARCH = "internvl2-2b"
VLM_PREFIX = 256
VLM_PREFILL = (4, 256)
VLM_DECODE_STEPS = 8
VLM_F32_REL_L2 = 1e-4           # 10a's float32 model, h100 vs torch_cpu: phase 5b's bound
VLM_REQUESTS, VLM_PROMPT, VLM_GEN, VLM_BATCH, VLM_CHUNK = 16, 128, 64, 8, 64
VLM_PAGED_REQUESTS, VLM_SHARED, VLM_OWN, VLM_PAGED_GEN = 32, 128, 64, 32
VLM_PROFILE_FILL = VLM_PREFIX + VLM_PROMPT + VLM_GEN // 2
# phase 11: the moe family at full width with a stated cut of layers (a
# whole grok-1-314b is 628 GB in bf16, arctic-480b 958 GB: no 80 GB card
# holds either). 11a: grok at MOE_LAYERS of its 64 layers (42.6 GB),
# Model.prefill of MOE_PREFILL and MOE_DECODE_STEPS decode steps, the float32
# model at MOE_F32_LAYERS layer (26 GB) within MOE_F32_REL_L2; 11b: its
# serves, MOE_REQUESTS requests of MOE_PROMPT + MOE_GEN at batch
# PROFILE_BATCH, chunks and pages of PAGE, the even requests sharing a
# MOE_SHARED-token head; 11c: arctic at ARCTIC_LAYERS of its 35 layers (28
# GB), ARCTIC_PREFILL and ARCTIC_DECODE_STEPS
MOE_ARCH = "grok-1-314b"
MOE_LAYERS, MOE_PREFILL, MOE_DECODE_STEPS = 4, (2, 128), 8
MOE_F32_LAYERS = 1
MOE_F32_REL_L2 = 1e-4           # 11a's float32 model, h100 vs torch_cpu: phase 5b's bound
MOE_REQUESTS, MOE_PROMPT, MOE_GEN, MOE_SHARED = 8, 128, 32, 64
ARCTIC_ARCH = "arctic-480b"
ARCTIC_LAYERS, ARCTIC_PREFILL, ARCTIC_DECODE_STEPS = 1, (1, 64), 4
# the report entries two serves of the same requests must share, graphs on
# and off (counts, not times; report["paged"] and report["spec"] in full)
SERVE_COUNTED = ("requests", "generated_tokens", "steps", "padded_slot_steps_steady",
                 "prefill_chunk", "buckets", "prefill_tokens", "slot_reuse", "refused",
                 "step_log", "outputs", "paged", "spec")
PER_REQUEST_COUNTED = ("rid", "slot", "prompt_len", "gen_len", "bucket", "tokens_out",
                       "admitted_at_step", "spec_proposed", "spec_accepted",
                       "verify_rounds", "preemptions")
# app phase: the paper's range-count data (bench_fig10_applicability: 2^30
# uniform floats in [0, 100000), 4 GiB) and 2^28 int32 in [0, 100); the
# quickstart's range and one that selects about half
APP_F32_N, APP_I32_N = 1 << 30, 1 << 28
APP_CASES = (("float32", APP_F32_N, ((5.0, 15.0), (25000.0, 75000.0))),
             ("int32", APP_I32_N, ((5, 15), (25, 74))))
# phase 1: edge lengths of the app's kernels (0, 1, around a warp, and a
# length no power of two divides); the vocabulary row width for softmax
EDGE = (1 << 20) + 7
EDGE_LENGTHS = (0, 1, 31, 33, EDGE)
VOCAB_ROW = 152064
APP_CHECK_N = 1 << 20       # prefix also counted on the host (torch_cpu)
# phase 5: the train batch, the steps and the optimizer (no warmup, so the
# loss must fall on a batch it sees again)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 5
TRAIN_OPT = dict(lr=3e-4, warmup_steps=0)
# phase 6: the train CLI at phase 5's batch, on SyntheticTokens; 6a restarts
# a 6-step run at 9 steps (the schedule is (total 10, warmup 2) for both),
# 6b runs 5 steps with and without compression, 6c 3 steps both ways
CLI_ARGS = ["--arch", ARCH, "--device", "cuda", "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--log-every", "1"]
CLI_INT8 = ["--microbatches", "2", "--moment-dtype", "int8"]
CLI_STEPS, CLI_RESTART_STEPS, CLI_CKPT_EVERY, CLI_COMPRESS_STEPS = 6, 9, 3, 5
# phase 5d: the compiled train step against eager at phase 5's batch, on
# SyntheticTokens batches; warmup over every step, so lr and both bias
# corrections change each step (a scalar baked into the graph would show as
# a diverging trajectory). Case: (OptConfig kwargs, make_train_step kwargs,
# steps)
GRAPH_TRAIN_OPT = dict(lr=3e-4, warmup_steps=10, total_steps=100)
GRAPH_TRAIN_CASES = {
    "float32": ({}, {}, 6),
    "int8": ({"moment_dtype": "int8"}, {}, 3),
    "microbatches2": ({}, {"microbatches": 2}, 3),
    "compress": ({}, {"compress_grads": True}, 3),
}
# int8 moments: 1 byte per element plus a float32 scale per row, against 4
# bytes per element for each float32 moment (0.25 + 1/row width)
INT8_STATE_SHARE = 0.26


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls
    after a warm-up (inputs stay L2-warm, as on the main path, where each
    input was just written by the previous op)."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


DEVICE_TIMING = "CUDA events around replays of a CUDA graph that captured the calls"
_CAPTURE_STREAM = []


def capture_stream():
    """The side stream every CUDA graph here is captured on (an op whose
    backward is captured must run its forward on it too)."""
    import torch

    if not _CAPTURE_STREAM:
        _CAPTURE_STREAM.append(torch.cuda.Stream())
    return _CAPTURE_STREAM[0]


def graph_ms(fn, iters: int, replays: int = 5) -> float:
    """Mean device time of one call (DEVICE_TIMING): ``iters`` calls are
    captured in one CUDA graph, after a warm-up on the capture stream, and
    CUDA events time ``replays`` replays of it. The device runs the calls
    back to back, so unlike events around a loop of calls the time holds
    no wait for the host's enqueue. Kernels that merge splits take a fixed
    workspace of the graph's own, allocated by the warm-up."""
    import torch

    from repro_torch.kernels.common import fixed_workspaces

    s = capture_stream()
    s.wait_stream(torch.cuda.current_stream())
    # ``spaces`` lives to the last replay: the graph points at its buffers
    with fixed_workspaces({}) as spaces:
        with torch.cuda.stream(s):
            for _ in range(3):
                fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=s):
            for _ in range(iters):
                fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    del g, spaces
    return start.elapsed_time(end) / (replays * iters)


def _timed_device(case: dict, kernel_fn, plain_fn, library_fn, iters: int,
                  plain_in_graph: bool = True) -> dict:
    """The one timer of every kernel row: kernel, plain version and
    yardstick by device time (``ms``, ``plain_ms``, ``library_ms``;
    DEVICE_TIMING), with the events time of each and the kernel's host
    enqueue beside them. The plain version (the flash ones hold the (Sq, Sk)
    scores) is captured 3 calls at a time; ``plain_in_graph=False`` times a
    plain version that reads device data on the host, which a graph cannot
    capture, by events only (``plain_timing`` says so)."""
    case["ms"], case["events_ms"] = graph_ms(kernel_fn, iters), cuda_ms(kernel_fn, iters)
    case["host_us"] = host_us(kernel_fn, 50)
    case["plain_events_ms"] = cuda_ms(plain_fn, iters)
    case["plain_ms"] = graph_ms(plain_fn, 3) if plain_in_graph else case["plain_events_ms"]
    case["library_ms"] = case["library_events_ms"] = None
    if library_fn is not None:
        case["library_ms"] = graph_ms(library_fn, iters)
        case["library_events_ms"] = cuda_ms(library_fn, iters)
    case["timing"] = DEVICE_TIMING
    if not plain_in_graph:
        case["plain_timing"] = "CUDA events around a loop of calls"
    return case


def kernel_label(mangled: str) -> str | None:
    """"flash_bwd_dkv_mma_kernel<64, 64>" for a flash, paged or softmax
    kernel's mangled name (template arguments: ints, bools, float,
    __nv_bfloat16, __half), None for any other symbol. The name is the one
    right after its length (the Itanium ABI's prefix), not a file name inside
    nvcc's namespace for the source."""
    import re

    m = re.search(r"\d((?:flash_(?:fwd|bwd)|paged|softmax)_\w+?_kernel)I(.+?)EEv", mangled)
    if m is None:
        return None
    args = [n or {"1": "true", "0": "false"}.get(b) or t or "float" for n, b, _, t in
            re.findall(r"Li(\d+)|Lb([01])|(f)|\d+(__nv_bfloat16|__half)", m[2])]
    return f"{m[1]}<{', '.join(args)}>"


def tensor_core_counts(lib_path: Path) -> dict | None:
    """HMMA / HGMMA instructions per flash or paged kernel instantiation in
    the library's SASS (cuobjdump -sass), keyed by kernel_label; None when the
    toolkit has no cuobjdump."""
    from repro_torch.kernels.common import nvcc

    tool = Path(nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], check=True, capture_output=True,
                          text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = kernel_label(line)
            if name is not None:
                counts[name] = 0
        elif name is not None and ("HMMA" in line or "HGMMA" in line):
            counts[name] += 1
    return counts


# the bf16 kernels of each family, which must run on the tensor cores
MMA_KERNELS = {"flash": ("flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel",
                         "flash_bwd_dkv_mma_kernel"),
               "paged": ("paged_mma_kernel",)}


# the serving kernels built at D 112 too (zamba2-7b's shared attention)
MMA_KERNELS_D112 = {"flash_fwd_mma_kernel", "paged_mma_kernel"}


def tensor_core_gate(counts: dict, family: str = "flash") -> None:
    """Raise unless every bf16 kernel of ``family`` (MMA_KERNELS) has an
    instantiation at D 64 and at D 128 (the serving forward and the paged
    kernel at D 112 too, MMA_KERNELS_D112) and each has tensor-core
    instructions, and no float32 instantiation has any (``counts``: HMMA /
    HGMMA per kernel_label, all libraries of the family)."""
    bf16 = {k: n for k, n in counts.items() if "_mma_" in k}
    f32 = {k: n for k, n in counts.items() if "_mma_" not in k}
    have = {(k.split("<")[0], k.split("<")[1].split(",")[0].rstrip(">")) for k in bf16}
    want = {(name, d) for name in MMA_KERNELS[family] for d in ("64", "128")}
    want |= {(name, "112") for name in MMA_KERNELS[family] if name in MMA_KERNELS_D112}
    if not want <= have or not all(bf16.values()) or not f32 or any(f32.values()):
        raise AssertionError(f"{family} instantiations: want HMMA in every bf16 one "
                             f"({', '.join(MMA_KERNELS[family])} at D 64 and 128, "
                             f"{', '.join(sorted(MMA_KERNELS_D112))} at D 112 too) and none "
                             f"in the float32 ones; got {counts}")


def ptxas_report(build_log: str) -> dict:
    """Registers, spill bytes and static shared memory (where ptxas states
    it) per flash, paged or softmax kernel from ``nvcc -Xptxas -v``'s output
    (the library's build.log), keyed by kernel_label."""
    import re

    out, name = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = kernel_label(m[1])
            if name is not None:
                out[name] = {}
        elif name is not None and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[name]["spill_bytes"] = int(m[1]) + int(m[2])
        elif name is not None and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m[1])
            if smem := re.search(r"(\d+) bytes smem", line):
                out[name]["smem_bytes"] = int(smem[1])
    return out


def host_us(fn, iters: int = 200) -> float:
    """Mean host time of one call in microseconds, enqueue only: the loop
    does not synchronise (the device drains it afterwards)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return t


def launches_per_call(fn, calls: int = 20) -> float | str:
    """CUDA kernels per call of ``fn``, by torch.profiler over ``calls``
    calls after a warm-up. The profiler may drop records but never adds
    one, so more than one per call is a fault of the call (it raises here);
    no record at all reads "not measured"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    n = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())
    if n > calls:
        raise AssertionError(f"{n} kernels in {calls} calls: more than one launch per call")
    return n / calls if n else "not measured (the profiler recorded no kernel)"


def check_case(name, shape, got, want, dtype, nan_ok: bool = False,
               atol_scale: float = 1.0) -> dict:
    """Kernel vs plain within TOLERANCE; ``nan_ok``: NaN where (and only
    where) the plain version has NaN, the rest compared. ``atol_scale``
    puts ATOL in the output's own units where a typical value is not ~1:
    softmax passes 1/d, so on a row of width d it compares
    |kernel - plain| <= ATOL/d + RTOL |plain| (d·softmax has mean 1)."""
    import torch

    torch.cuda.synchronize()
    if nan_ok:
        if not torch.equal(torch.isnan(got), torch.isnan(want)):
            raise AssertionError(f"{name} {shape}: NaN where the plain version has none "
                                 f"or the reverse")
        keep = ~torch.isnan(want)
        got, want = got[keep], want[keep]
    diff = (got.float() - want.float()).abs()
    atol, rtol = TOLERANCE[str(dtype)]
    atol *= atol_scale
    limit = atol + rtol * want.float().abs()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name} {shape}: non-finite output")
    bad = int((diff > limit).sum())
    if bad:
        raise AssertionError(f"{name} {shape} {dtype}: {bad} elements exceed "
                             f"atol {atol} + rtol {rtol}; max abs err {diff.max().item()}")
    big = want.float().abs() >= atol          # relative error where it means something
    rel = (diff[big] / want.float().abs()[big]).max().item() if bool(big.any()) else 0.0
    return {"max_abs_err": diff.max().item(), "max_rel_err": rel,
            "tolerance_used": (diff / limit).max().item(), "atol": atol, "rtol": rtol}


def check_exact(name, shape, got, want) -> dict:
    """Integer results (counts, sums, bit words): kernel == plain, bit for bit."""
    import torch

    torch.cuda.synchronize()
    g, w = (t.view(torch.int32) if t.dtype == torch.uint32 else t for t in (got, want))
    if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
        err = (g.long() - w.long()).abs().max().item() if g.shape == w.shape else "shape"
        raise AssertionError(f"{name} {shape}: kernel != plain ({got.dtype} "
                             f"{tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}; "
                             f"max abs err {err})")
    return {"max_abs_err": 0.0, "max_rel_err": 0.0, "tolerance_used": 0.0, "atol": 0,
            "rtol": 0}


def bound(bytes_moved: float, ops: float, dtype) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[str(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_ulp(x: float) -> float:
    """The gap between consecutive bf16 values at magnitude ``x`` (8
    significant bits: 2^(floor(log2 |x|) - 7)); 0 for 0."""
    if x == 0:
        return 0.0
    return math.ldexp(1.0, math.frexp(abs(x))[1] - 8)


def argmax_verdicts(got, want) -> dict:
    """The per-row argmax verdict of kernel logits ``got`` against plain
    logits ``want`` ((rows, vocab), float). A row with equal argmaxes
    agrees. A row whose argmaxes differ gets no verdict when the plain gap
    between the two tokens is at most tau = TIE_ULPS bf16 ulps at the row's
    largest |plain logit|, and fails otherwise. tau depends on the plain
    logits alone. Per row: both argmaxes, the plain gap (to the kernel's
    token where they differ, else to the plain runner-up), tau and the
    verdict; then the rows of each verdict."""
    import torch

    top2 = torch.topk(want, 2, dim=-1).indices.tolist()
    rows, by = [], {"agree": [], "no verdict": [], "fail": []}
    for row, (k, p) in enumerate(zip(got.argmax(-1).tolist(), want.argmax(-1).tolist())):
        other = k if k != p else top2[row][top2[row][0] == p]   # else the runner-up
        gap = (want[row, p] - want[row, other]).item()
        tau = TIE_ULPS * bf16_ulp(want[row].abs().max().item())
        verdict = "agree" if k == p else "no verdict" if gap <= tau else "fail"
        rows.append({"row": row, "kernel": k, "plain": p, "plain_gap": gap, "tau": tau,
                     "verdict": verdict})
        by[verdict].append(row)
    return {"tie_ulps": TIE_ULPS, "rows": rows, "agree_rows": by["agree"],
            "no_verdict_rows": by["no verdict"], "failed_rows": by["fail"]}


def require_argmax(name: str, verdicts: dict) -> None:
    """Raise if any row of ``verdicts`` (argmax_verdicts) failed."""
    if verdicts["failed_rows"]:
        bad = [r for r in verdicts["rows"] if r["verdict"] == "fail"]
        raise AssertionError(f"{name}: argmax differs beyond a tie on rows "
                             f"{verdicts['failed_rows']}: {bad}")


def kernel_phase(dev) -> list[dict]:
    """Phase 1: every kernel against its plain version at main-path shapes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.common import KERNEL_BUILD_ROOT, build_shared_library
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.hadd import kernel as ha_kernel
    from repro_torch.kernels.paged import kernel as pa_kernel
    from repro_torch.kernels.paged import ops as pa
    from repro_torch.kernels.range_count import kernel as rc_kernel
    from repro_torch.kernels.rmsnorm import ops as rn
    from repro_torch.kernels.softmax import kernel as sm_kernel
    from repro_torch.kernels.swiglu import ops as sw
    from repro_torch.kernels.to_integral import kernel as ti_kernel

    t0 = time.perf_counter()
    # nvcc builds of the CUDA sources (cached by digest), one per source, at once
    cuda = {"flash_attention": fa_kernel._fn, "flash_attention_bwd": fa_kernel._bwd_fns,
            "paged_attention": pa_kernel._fn, "range_count": rc_kernel._fn,
            "hadd": ha_kernel._fn, "to_integral": ti_kernel._fn, "softmax": sm_kernel._fn}
    with ThreadPoolExecutor(len(cuda)) as pool:
        list(pool.map(lambda build: build(), cuda.values()))
    print(f"[phase1] {', '.join(cuda)} built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    # (family, sources, headers) of the libraries read per instantiation
    mma_libs = {"flash_attention": ("flash", fa_kernel.SOURCES, []),
                "flash_attention_bwd": ("flash", fa_kernel.BWD_SOURCES, []),
                "paged_attention": ("paged", pa_kernel.SOURCES, pa_kernel.HEADERS)}
    for name in cuda.keys() - mma_libs.keys() - {"softmax"}:
        digest = "[0-9a-f]" * 12
        for log in sorted(KERNEL_BUILD_ROOT.glob(f"{name}_{digest}/build.log")):
            regs = [ln.strip() for ln in log.read_text().splitlines()
                    if "registers" in ln or "spill" in ln]
            print(f"[phase1] ptxas {name}:", "; ".join(regs), flush=True)
    # the flash and paged libraries per instantiation: registers, spills,
    # tensor-core instructions (the bf16 ones run on the tensor cores without
    # spilling; the float32 ones are scalar)
    mma = {"flash": {}, "paged": {}}
    for name, (family, sources, headers) in mma_libs.items():
        lib = build_shared_library(name, sources, headers)
        regs = ptxas_report((lib.parent / "build.log").read_text())
        print(f"[phase1] ptxas {name} per instantiation: {json.dumps(regs)}", flush=True)
        spilled = {k: r for k, r in regs.items() if "_mma_" in k and r.get("spill_bytes")}
        if spilled:
            raise AssertionError(f"bf16 {family} instantiations that spill: {spilled}")
        counts = tensor_core_counts(lib)
        if counts is None:
            print(f"[phase1] SASS: the toolkit has no cuobjdump; HMMA / HGMMA of {name} "
                  f"not counted", flush=True)
            continue
        mma[family].update(counts)
        print(f"[phase1] SASS HMMA / HGMMA instructions per {name} instantiation: "
              f"{json.dumps(counts)}", flush=True)
    for family, counts in mma.items():
        if counts:
            tensor_core_gate(counts, family)
    # the softmax library per instantiation: none may spill
    lib = build_shared_library("softmax", sm_kernel.SOURCES)
    regs = ptxas_report((lib.parent / "build.log").read_text())
    print(f"[phase1] ptxas softmax per instantiation: {json.dumps(regs)}", flush=True)
    if not regs or any(r.get("spill_bytes") for r in regs.values()):
        raise AssertionError(f"softmax instantiations missing or spilling: {regs}")

    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    rows_list = (4, 8, 64, 1024, 4096)   # 8: decode batch, 64: chunk, 1024: B*S
    results = []

    cases = []
    # (rows, width): qwen1.5's norms, and zamba2-7b's gated norm (d_inner 7168)
    for rows, width in [(r, 1024) for r in rows_list] + [(1024, ZAMBA_GATED_WIDTH)]:
        x, w = rnd(rows, width), rnd(width)
        got = rn.rmsnorm(x, w)
        want = rn.ref.rmsnorm(x, w)
        c = {"shape": [rows, width], "dtype": "bfloat16",
             **check_case("rmsnorm", (rows, width), got, want, x.dtype)}
        _timed_device(c, lambda: rn.rmsnorm(x, w), lambda: rn.ref.rmsnorm(x, w),
                      lambda: F.rms_norm(x, (width,), w, 1e-6), 100)
        c["bound_ms"], c["bound_by"] = bound((2 * rows * width + width) * 2,
                                             4 * rows * width, x.dtype)
        cases.append(c)
    results.append(("rmsnorm", "triton", "src/repro_torch/kernels/rmsnorm/kernel.py",
                    "src/repro/kernels/rmsnorm/kernel.py:31", [1024, 1024], cases))

    cases = []
    for rows in rows_list:
        gt, up = rnd(rows, 2816), rnd(rows, 2816)
        got = sw.swiglu(gt, up)
        want = sw.ref.swiglu(gt, up)
        c = {"shape": [rows, 2816], "dtype": "bfloat16",
             **check_case("swiglu", (rows, 2816), got, want, gt.dtype)}
        _timed_device(c, lambda: sw.swiglu(gt, up), lambda: sw.ref.swiglu(gt, up),
                      lambda: F.silu(gt) * up, 100)
        c["bound_ms"], c["bound_by"] = bound(3 * rows * 2816 * 2, 4 * rows * 2816,
                                             gt.dtype)
        cases.append(c)
    results.append(("swiglu", "triton", "src/repro_torch/kernels/swiglu/kernel.py",
                    "src/repro/kernels/swiglu/kernel.py:22", [1024, 2816], cases))

    # (B, H, KH, Sq, Sk, D, dtype, causal, kv_len)
    fa_cases = [
        (2, 16, 16, 512, 512, 64, torch.bfloat16, True, None),   # Model.prefill
        (4, 16, 16, 512, 512, 64, torch.bfloat16, True, None),
        (1, 8, 2, 256, 256, 128, torch.bfloat16, True, None),    # GQA, D=128
        (2, 16, 16, 64, 320, 64, torch.bfloat16, True, 300),     # continuation
        (2, 16, 16, 512, 512, 64, torch.float32, True, None),
        # zamba2-7b's shared attention block in Model.prefill, D 112
        (2, 32, 32, 512, 512, 112, torch.bfloat16, True, None),
        (2, 32, 32, 512, 512, 112, torch.float32, True, None),
        # whisper-tiny (phase 9), non-causal against 1500 keys, 23 key tiles
        # of 64 and a ragged 28: the encoder's self-attention, and the
        # cross-attention of a prefill chunk, a decode step and a verify span
        (8, 6, 6, WHISPER_ENC_LEN, WHISPER_ENC_LEN, 64, torch.bfloat16, False, None),
        (8, 6, 6, WHISPER_ENC_LEN, WHISPER_ENC_LEN, 64, torch.float32, False, None),
        (1, 6, 6, WHISPER_CHUNK, WHISPER_ENC_LEN, 64, torch.bfloat16, False, None),
        (8, 6, 6, 1, WHISPER_ENC_LEN, 64, torch.bfloat16, False, None),
        (8, 6, 6, SPEC_K + 1, WHISPER_ENC_LEN, 64, torch.bfloat16, False, None),
        # internvl2-2b's Model.prefill (10a): 16 heads of 128 over 8 KV heads,
        # the 256 vision rows + 256 tokens; grok-1-314b's (11a): 48 over 8
        (4, 16, 8, VLM_PREFIX + VLM_PREFILL[1], VLM_PREFIX + VLM_PREFILL[1], 128,
         torch.bfloat16, True, None),
        (MOE_PREFILL[0], 48, 8, MOE_PREFILL[1], MOE_PREFILL[1], 128, torch.bfloat16, True,
         None),
    ]
    cases = []
    for b, h, kh, sq, sk, d, dt, causal, kv_len in fa_cases:
        q, k, v = rnd(b, h, sq, d, dtype=dt), rnd(b, kh, sk, d, dtype=dt), \
            rnd(b, kh, sk, d, dtype=dt)
        got = fa.flash_attention(q, k, v, causal=causal, kv_len=kv_len)
        want = fa.ref.attention(q, k, v, causal=causal, kv_len=kv_len)
        shape = [b, h, kh, sq, sk, d]
        c = {"shape": shape, "dtype": str(dt).removeprefix("torch."),
             "kv_len": kv_len, **check_case("flash_attention", shape, got, want, dt)}
        kvl = sk if kv_len is None else kv_len
        qi = torch.arange(sq, device=dev)[:, None] + (kvl - sq)
        kj = torch.arange(sk, device=dev)[None, :]
        allowed = (kj < kvl) & ((kj <= qi) if causal else torch.ones_like(qi, dtype=bool))
        pairs = int(allowed.sum())                   # what this data needs
        mask = None if (kv_len is None and (sq == sk or not causal)) else allowed
        _timed_device(
            c, lambda: fa.flash_attention(q, k, v, causal=causal, kv_len=kv_len),
            lambda: fa.ref.attention(q, k, v, causal=causal, kv_len=kv_len),
            lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=h != kh), 20)
        itemsize = q.element_size()
        c["bound_ms"], c["bound_by"] = bound(
            (2 * b * h * sq * d + 2 * b * kh * sk * d) * itemsize,
            4 * b * h * pairs * d, dt)
        cases.append(c)
    results.append(("flash_attention", "cuda",
                    "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                    "src/repro/kernels/flash_attention/kernel.py:185",
                    [2, 16, 16, 512, 512, 64], cases))
    results.append(("paged_attention", "cuda",
                    "src/repro_torch/kernels/paged/csrc/paged_attention.cu",
                    "src/repro/kernels/paged/kernel.py:88", None,
                    paged_cases(dev, pa)))
    results.append(("range_count", "cuda",
                    "src/repro_torch/kernels/range_count/csrc/range_count.cu",
                    "src/repro/kernels/range_count/kernel.py:52", None,
                    range_count_cases(dev)))
    results.append(("hadd", "cuda", "src/repro_torch/kernels/hadd/csrc/hadd.cu",
                    "src/repro/kernels/hadd/kernel.py:46", None, hadd_cases(dev)))
    results.append(("to_integral", "cuda",
                    "src/repro_torch/kernels/to_integral/csrc/to_integral.cu",
                    "src/repro/kernels/to_integral/kernel.py:31", None,
                    to_integral_cases(dev)))
    results.append(("softmax", "cuda", "src/repro_torch/kernels/softmax/csrc/softmax.cu",
                    "src/repro/kernels/softmax/kernel.py:24", None, softmax_cases(dev)))

    rows = []
    for name, route, source, replaces, main_shape, cs in results:
        top = next(c for c in cs if c.get("main", c["shape"] == main_shape))
        rows.append({"name": name, "route": route, "source": source,
                     "replaces": replaces, "launches": 0,
                     "max_abs_err": max(c["max_abs_err"] for c in cs),
                     "tolerance_used": max(c["tolerance_used"] for c in cs),
                     "ms": top["ms"], "plain_ms": top["plain_ms"],
                     "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
                     "library_ms": top["library_ms"], "shape": top["shape"],
                     "cases": cs})
        for c in cs:
            lib = "—" if c["library_ms"] is None else f"{c['library_ms']:.4f} ms"
            print(f"[phase1] {name} {c['shape']} {c['dtype']}: err {c['max_abs_err']:.3g} "
                  f"(rel {c['max_rel_err']:.3g}, {c['tolerance_used']:.2f} of tolerance) "
                  f"kernel {c['ms']:.4f} ms plain {c['plain_ms']:.4f} ms "
                  f"library {lib} bound {c['bound_ms']:.4f} ms "
                  f"({c['bound_by']})"
                  + (f" {c['note']}" if "note" in c else "")
                  + f"; events: kernel {c['events_ms']:.4f} ms plain "
                    f"{c['plain_events_ms']:.4f} ms library "
                    + ("—" if c["library_events_ms"] is None
                       else f"{c['library_events_ms']:.4f} ms")
                  + (f"; kernels per call {c['launches_per_call']}"
                     if "launches_per_call" in c else "")
                  + f"; device times by {c['timing']}"
                  + (f" (plain version: {c['plain_timing']})" if "plain_timing" in c else "")
                  + f"; host enqueue us {json.dumps(c['host_us'])}", flush=True)
    return rows


def paged_operands(dev, dtype, b, h, kh, d, page, sq, kv_lens, width, seed=0):
    """q, pools and tables for one paged case: each sequence's pages are a
    slice of one permutation of the pool; page 0 is the scratch page that
    pads every table row past its coverage."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    used = [-(-n // page) for n in kv_lens]
    n_pages = 1 + sum(used) + 2
    perm = (torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(seed))
            + 1).tolist()
    tables = torch.zeros(b, width, dtype=torch.int32)
    for i, u in enumerate(used):
        tables[i, :u] = torch.tensor(perm[:u], dtype=torch.int32)
        perm = perm[u:]
    q = torch.randn(b, h, sq, d, generator=g, device=dev).to(dtype)
    k = torch.randn(kh, n_pages, page, d, generator=g, device=dev).to(dtype)
    v = torch.randn(kh, n_pages, page, d, generator=g, device=dev).to(dtype)
    kv_len = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    return q, k, v, tables.to(dev), kv_len


def paged_cases(dev, pa) -> list[dict]:
    """Phase 1, paged attention: the serving path's decode shape with the
    kv_len of a steady decode step (the main case) and with edge lengths (0,
    1, partial pages, a full table), the serving verify span (SQ 5 at the
    same fills, a table as wide as phase 3e's, cdiv(max_len + k_max, page)),
    a GQA verify-shaped span, a long context (kv_len 3900-4096), batch-1 GQA
    at kv_len 4096 (qwen3-14b's 40 over 8 heads of 128), f32, zamba2-7b's
    32 heads of 112, whisper-tiny's 6 heads of 64 at page 32, and the decode
    step and verify span of internvl2-2b (16 over 8 heads of 128) and
    grok-1-314b (48 over 8). Each case
    records its split plan (kernel.plan on this card); the main and the
    serving verify case also their kernels per call (more than 1 fails)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.common import sm_count

    steady = [260, 268, 276, 284, 292, 300, 308, 316]
    edges = [0, 1, 100, 320, 257, 64, 63, 200]
    long = [3900, 3928, 3956, 3984, 4012, 4040, 4068, 4096]
    verify_width = -(-(PAGED_MAX_LEN + SPEC_K) // PAGE)
    whisper = [65, 90, 115, 140, 165, 190, 215, 240]
    whisper_width = -(-(WHISPER_PROMPT + WHISPER_GEN) // WHISPER_PAGE)
    vlm = [VLM_PROFILE_FILL + 4 * i for i in range(-4, 4)]
    vlm_width = -(-(VLM_PREFIX + VLM_SHARED + VLM_OWN + VLM_PAGED_GEN + SPEC_K) // PAGE)
    moe = [MOE_PROMPT + 4 * i + 1 for i in range(8)]
    moe_width = -(-(MOE_PROMPT + MOE_GEN + SPEC_K) // PAGE)
    # (B, H, KH, D, page, SQ, kv_len per sequence, table width, dtype, main)
    specs = [
        (8, 16, 16, 64, PAGE, 1, steady, 5, torch.bfloat16, True),
        (8, 16, 16, 64, PAGE, SPEC_K + 1, [n + SPEC_K + 1 for n in steady], verify_width,
         torch.bfloat16, False),
        (8, 16, 16, 64, PAGE, 1, edges, 5, torch.bfloat16, False),
        (3, 40, 8, 128, 16, 4, [2, 37, 64], 4, torch.bfloat16, False),
        (8, 16, 16, 64, PAGE, 1, long, 64, torch.bfloat16, False),
        (1, 40, 8, 128, PAGE, 1, [4096], 64, torch.bfloat16, False),
        (8, 16, 16, 64, PAGE, 1, edges, 5, torch.float32, False),
        # zamba2-7b's shared attention block (32 heads of 112): the fused
        # decode step and the verify span of phase 8, both dtypes
        (8, 32, 32, 112, PAGE, 1, steady, 5, torch.bfloat16, False),
        (8, 32, 32, 112, PAGE, SPEC_K + 1, [n + SPEC_K + 1 for n in steady], verify_width,
         torch.bfloat16, False),
        (8, 32, 32, 112, PAGE, 1, steady, 5, torch.float32, False),
        (8, 32, 32, 112, PAGE, SPEC_K + 1, [n + SPEC_K + 1 for n in steady], verify_width,
         torch.float32, False),
        # whisper-tiny's decoder self-attention (6 heads of 64, group 1) in
        # phase 9's fused paged serve (page WHISPER_PAGE, 64-token prompts
        # and up to 192 generated): the decode step and the verify span
        (8, 6, 6, 64, WHISPER_PAGE, 1, whisper, whisper_width, torch.bfloat16, False),
        (8, 6, 6, 64, WHISPER_PAGE, SPEC_K + 1, [n + SPEC_K + 1 for n in whisper],
         whisper_width + 1, torch.bfloat16, False),
        # internvl2-2b (16 heads of 128 over 8: group 2) in phase 10's fused
        # paged serves behind 256 vision rows, and grok-1-314b (48 over 8:
        # group 6, a span of 5 is 30 rows) in phase 11b's: decode and verify
        (8, 16, 8, 128, PAGE, 1, vlm, vlm_width, torch.bfloat16, False),
        (8, 16, 8, 128, PAGE, SPEC_K + 1, [n + SPEC_K + 1 for n in vlm], vlm_width,
         torch.bfloat16, False),
        (8, 48, 8, 128, PAGE, 1, moe, moe_width, torch.bfloat16, False),
        (8, 48, 8, 128, PAGE, SPEC_K + 1, [n + SPEC_K + 1 for n in moe], moe_width,
         torch.bfloat16, False),
    ]
    cases = []
    for b, h, kh, d, page, sq, kv_lens, width, dt, main in specs:
        q, k, v, tables, kv_len = paged_operands(dev, dt, b, h, kh, d, page, sq, kv_lens,
                                                 width)
        assert not torch.equal(k, v)
        shape = [b, h, kh, d, page, sq, width]
        splits, pps = pa.kernel.plan(b, kh, width, page, sm_count(q.device))
        got = pa.paged_attention(q, k, v, tables, kv_len)
        want = pa.ref.paged_attention_ref(q, k, v, tables, kv_len)
        c = {"shape": shape, "dtype": str(dt).removeprefix("torch."), "kv_len": kv_lens,
             "main": main, "splits": splits, "pages_per_split": pps,
             "note": f"{splits} splits of {pps} pages",
             **check_case("paged_attention", shape, got, want, dt)}
        # yardstick: SDPA on the same rows gathered into contiguous lanes
        lanes_k = k[:, tables.long()].permute(1, 0, 2, 3, 4).reshape(b, kh, -1, d)
        lanes_v = v[:, tables.long()].permute(1, 0, 2, 3, 4).reshape(b, kh, -1, d)
        qpos = kv_len.long()[:, None] - sq + torch.arange(sq, device=dev)[None, :]
        mask = (torch.arange(width * page, device=dev)[None, None, :]
                <= qpos[:, :, None])[:, None]                    # (B, 1, SQ, S)
        # the plain version reads the tables on the host: not graph-captured
        _timed_device(c, lambda: pa.paged_attention(q, k, v, tables, kv_len),
                      lambda: pa.ref.paged_attention_ref(q, k, v, tables, kv_len),
                      lambda: F.scaled_dot_product_attention(
                          q, lanes_k, lanes_v, attn_mask=mask, enable_gqa=h != kh), 50,
                      plain_in_graph=False)
        if sq == SPEC_K + 1:
            c["note"] += "; the serving verify span (phase 3e)"
        if main or sq == SPEC_K + 1:
            # more than one kernel a call raises (launches_per_call)
            c["launches_per_call"] = launches_per_call(
                lambda: pa.paged_attention(q, k, v, tables, kv_len))
        if main:
            # host time to enqueue one call (no synchronise inside the loop)
            out = torch.empty_like(q)
            c["host_us"] = {
                "wrapper": c["host_us"],
                "launcher": host_us(lambda: pa.kernel.paged_attention_4d(
                    q, k, v, tables, kv_len, out, tile=64, scale=d ** -0.5, splits=splits,
                    pps=pps)),
                "library": host_us(lambda: F.scaled_dot_product_attention(
                    q, lanes_k, lanes_v, attn_mask=mask, enable_gqa=h != kh))}
        # what this data needs: the kv_len rows of K and V (not the rest of
        # their last pages), q and the output once, the table entries read
        # and kv_len; 4*D flops per visible (query row, key) pair
        touched = sum(-(-n // page) for n in kv_lens)
        itemsize = q.element_size()
        pairs = sum(max(0, n - sq + s + 1) for n in kv_lens for s in range(sq)) * h
        c["bound_ms"], c["bound_by"] = bound(
            2 * kh * sum(kv_lens) * d * itemsize + 2 * b * h * sq * d * itemsize
            + 4 * touched + 4 * b, 4 * pairs * d, dt)
        cases.append(c)
    return cases


def range_count_cases(dev) -> list[dict]:
    """Phase 1, range_count: the app's 2^30 float32 uniforms (the main
    case) and 2^28 int32, edge lengths (0, 1, 31, 33, 2^20 + 7, a view off
    16-byte alignment), a fractional bound on int32 data and NaN data.
    Counts must be equal. The yardstick is torch.histc(x, bins=1, min=lo,
    max=hi), which counts [lo, hi] with NaN ignored: on float32 data, and on
    int32 data with whole bounds (histc casts its bounds to the data's type;
    fractional bounds keep "—")."""
    import torch

    from repro_torch.kernels.range_count import ops as rc

    g = torch.Generator(device=dev).manual_seed(10)
    big = torch.rand(APP_F32_N, generator=g, device=dev).mul_(100_000)
    ints = torch.randint(0, 100, (APP_I32_N,), generator=g, device=dev, dtype=torch.int32)
    nan = torch.rand(EDGE, generator=g, device=dev).mul_(20)
    nan[::3] = float("nan")
    # (label, data, lo, hi, main)
    specs = [("f32", big, 5.0, 15.0, True), ("f32", big, 25000.0, 75000.0, False),
             ("i32", ints, 5, 15, False), ("i32", ints, 25, 74, False)]
    for n in EDGE_LENGTHS:
        specs += [("f32", big[:n].mul(1e-3), 5.0, 15.0, False),
                  ("i32", ints[:n], 10, 40, False)]
    small = big[:EDGE + 1].mul(1e-3)
    specs += [("f32 view 4 bytes off 16-byte alignment", small[1:], 5.0, 15.0, False),
              ("i32 fractional bounds", ints[:EDGE], 5.5, 7.9, False),
              ("i32 int lo, float hi", ints[:EDGE], 5, 7.9, False),
              ("f32 NaN data", nan, 2.0, 9.0, False)]
    cases = []
    for label, data, lo, hi, main in specs:
        n = data.numel()
        shape = [n, label, lo, hi]
        c = {"shape": shape, "dtype": str(data.dtype).removeprefix("torch."), "main": main,
             **check_exact("range_count", shape, rc.range_count(data, lo, hi),
                           rc.ref.range_count(data, lo, hi))}
        iters = 10 if n >= APP_I32_N else 50
        # histc casts its bounds to the data's type: on int32 data only whole
        # bounds count what the kernel counts; an empty input is not timed
        histc = n > 0 and (data.dtype == torch.float32
                           or isinstance(lo, int) and isinstance(hi, int))
        _timed_device(c, lambda: rc.range_count(data, lo, hi),
                      lambda: rc.ref.range_count(data, lo, hi),
                      (lambda: torch.histc(data, bins=1, min=lo, max=hi)) if histc else None,
                      iters)
        c["bound_ms"], c["bound_by"] = bound(n * data.element_size() + 4, 3 * n,
                                             torch.int32 if data.dtype == torch.int32
                                             else torch.float32)
        cases.append(c)
    return cases


def hadd_cases(dev) -> list[dict]:
    """Phase 1, hadd: the composed app's one row of 2^30 int32 0/1 lanes
    (the main case), (64, 512) rows (the bench shape) in f32 and bf16, row
    lengths 0, 1, 31, 33 and 2^20 + 7 in f32 / bf16 / int32, and an int32
    row whose sum passes 2^24 (exact) and one that wraps past 2^31."""
    import torch

    from repro_torch.kernels.hadd import ops as ha

    g = torch.Generator(device=dev).manual_seed(11)

    def rand(shape, dtype):
        if dtype == torch.int32:
            return torch.randint(-1000, 1000, shape, generator=g, device=dev,
                                 dtype=torch.int32)
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    lanes = torch.randint(0, 2, (APP_F32_N,), generator=g, device=dev, dtype=torch.int32)
    specs = [(lanes, True, "the composed app's lanes"),
             (rand((64, 512), torch.float32), False, "bench shape"),
             (rand((64, 512), torch.bfloat16), False, "bench shape")]
    for n in EDGE_LENGTHS:
        for dt in (torch.float32, torch.bfloat16, torch.int32):
            specs.append((rand((3, n), dt), False, ""))
    specs += [
        (torch.randint(0, 1 << 10, (EDGE,), generator=g, device=dev,
                       dtype=torch.int32), False, "int32 sum past 2^24"),
        (torch.full((5000,), 1 << 20, device=dev, dtype=torch.int32), False,
         "int32 sum wraps past 2^31"),
        (rand((8, VOCAB_ROW), torch.bfloat16), False, "vocab rows"),
    ]
    cases = []
    for x, main, note in specs:
        shape = list(x.shape)
        got, want = ha.hadd(x), ha.ref.hadd(x)
        check = (check_exact("hadd", shape, got, want) if x.dtype == torch.int32
                 else check_case("hadd", shape, got, want, x.dtype))
        c = {"shape": shape, "dtype": str(x.dtype).removeprefix("torch."), "main": main,
             **check}
        if note:
            c["note"] = note
        iters = 10 if x.numel() >= APP_I32_N else 50
        _timed_device(c, lambda: ha.hadd(x), lambda: ha.ref.hadd(x),
                      lambda: torch.sum(x, -1, dtype=x.dtype), iters)
        if main:
            c["launches_per_call"] = launches_per_call(lambda: ha.hadd(x), 5)
        rows = math.prod(x.shape[:-1])
        c["bound_ms"], c["bound_by"] = bound(
            (x.numel() + rows) * x.element_size(), x.numel(),
            torch.int32 if x.dtype == torch.int32 else torch.float32)
        cases.append(c)
    return cases


def to_integral_cases(dev) -> list[dict]:
    """Phase 1, to_integral: the app's mask packed 32 lanes a word ((2^25,
    32) bool, the main case, which must take the vector body and launch one
    kernel a call), row counts 1, 31, 33, 2^20 + 7 and others no multiple of
    a thread's 4 rows or a block's 1024, lane counts 1, 31 and 32 with bit 31
    (every lane set; only lane 31 set), uint8 masks of 0/1 and of random
    bytes 0-255 (every nonzero byte sets its lane), and 32-lane masks 1 byte
    off 16-byte alignment (a view of a flat buffer at offset 1: the ballot
    body). Words must be equal; each case records its body. No PyTorch call
    packs a mask."""
    import torch

    from repro_torch.kernels.to_integral import kernel as ti_kernel
    from repro_torch.kernels.to_integral import ops as ti

    g = torch.Generator(device=dev).manual_seed(12)

    def mask(rows, n):
        return torch.rand((rows, n), generator=g, device=dev) > 0.5

    def random_bytes(rows):
        b = torch.randint(0, 256, (rows, 32), generator=g, device=dev, dtype=torch.uint8)
        return b * mask(rows, 32)

    def off_alignment(m):
        flat = torch.empty(m.numel() + 1, dtype=m.dtype, device=dev)
        view = flat[1:].view(m.shape)
        view.copy_(m)
        return view

    full = torch.ones((4, 32), dtype=torch.bool, device=dev)
    top = torch.zeros((4, 32), dtype=torch.bool, device=dev)
    top[:, 31] = True
    specs = [(mask(APP_F32_N // 32, 32), True, "the app's mask"), (full, False, ""),
             (top, False, ""), (mask(7, 1), False, ""), (mask(7, 31), False, ""),
             (mask(0, 32), False, ""), (mask(5, 32).to(torch.uint8), False, ""),
             (random_bytes(5), False, "random bytes"),
             (random_bytes(EDGE), False, "random bytes"),
             (off_alignment(mask(EDGE, 32)), False, "1 byte off alignment"),
             (off_alignment(random_bytes(1029)), False, "1 byte off alignment")]
    for rows in EDGE_LENGTHS[1:] + (130, 1029, (1 << 16) + 3):
        specs.append((mask(rows, 32), False, ""))
    cases = []
    for m, main, note in specs:
        shape = list(m.shape)
        c = {"shape": shape, "dtype": str(m.dtype).removeprefix("torch."), "main": main,
             "body": ti_kernel.body(m) if m.numel() else "none (no rows)",
             **check_exact("to_integral", shape, ti.to_integral(m), ti.ref.to_integral(m))}
        c["note"] = f"{note}; {c['body']} body" if note else f"{c['body']} body"
        _timed_device(c, lambda: ti.to_integral(m), lambda: ti.ref.to_integral(m), None,
                      10 if m.numel() >= APP_I32_N else 50)
        if main:
            c["launches_per_call"] = launches_per_call(lambda: ti.to_integral(m), 5)
        c["bound_ms"], c["bound_by"] = bound(m.numel() + 4 * shape[0], m.numel(),
                                             torch.int32)
        cases.append(c)
    if not torch.equal(ti.to_integral(full).view(torch.int32),
                       torch.full((4,), -1, dtype=torch.int32, device=dev)):
        raise AssertionError("to_integral: 32 set lanes are not 0xFFFFFFFF")
    if next(c for c in cases if c["main"])["body"] != "vector":
        raise AssertionError("to_integral: the app's mask did not take the vector body")
    if {c["body"] for c in cases if "off alignment" in c["note"]} != {"ballot"}:
        raise AssertionError("to_integral: a base off 16-byte alignment took the vector body")
    return cases


def softmax_specs(dev) -> list[tuple]:
    """Phase 1's softmax inputs, (x, main, note): vocabulary rows ((8,
    152064) bf16, the main case: a cluster of CTAs per row) with -inf lanes
    and a first half of only -inf in row 0, the same in f32 and with a row of
    only -inf (NaN, as the plain version gives), flat rows (unit logits: no
    entry dominates, so a fault in the small entries or a chunk's edge shows
    against ATOL/d), rows that fit a warp ((4096, 1024) f32, (64, 512) bf16),
    the generated suite's shapes, widths 1, 31, 33 and 2^20 + 7 (f32: a chunk
    over the shared-memory budget streams); then batch-1 sampling rows
    ((1, 152064) bf16 and f32), float16, a width whose rows break 16-byte
    alignment ((2, 152063) bf16), a view whose base is 2 bytes off 16-byte
    alignment (element loads), and an aligned streaming row ((2, 2^20 + 8)
    f32: 16-byte loads)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(13)

    def rand(shape, dtype, neg_inf=False, dead_row=False, scale=4.0):
        x = torch.randn(shape, generator=g, device=dev).mul_(scale)
        if neg_inf:
            x[:, ::7] = float("-inf")
            x[0, : shape[1] // 2] = float("-inf")
        if dead_row:
            x[1] = float("-inf")
        return x.to(dtype)

    def off_alignment(x):
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        view = flat[1:].view(x.shape)
        view.copy_(x)
        return view

    specs = [(rand((8, VOCAB_ROW), torch.bfloat16, neg_inf=True), True, ""),
             (rand((8, VOCAB_ROW), torch.float32, neg_inf=True), False, ""),
             (rand((8, VOCAB_ROW), torch.float32, dead_row=True), False, "a row of only -inf"),
             (rand((8, VOCAB_ROW), torch.bfloat16, neg_inf=True, scale=1.0), False, "flat"),
             (rand((8, VOCAB_ROW), torch.float32, scale=1.0), False, "flat"),
             (rand((4096, 1024), torch.float32), False, ""),
             (rand((64, 512), torch.bfloat16, neg_inf=True), False, ""),
             (rand((7, 33), torch.float32), False, ""), (rand((4, 16), torch.bfloat16), False, ""),
             (rand((3, 9000), torch.float32, neg_inf=True), False, "")]
    for d in EDGE_LENGTHS[1:]:
        specs.append((rand((2, d), torch.float32), False, ""))
    specs += [(rand((1, VOCAB_ROW), torch.bfloat16, neg_inf=True), False, "batch-1 sampling"),
              (rand((1, VOCAB_ROW), torch.float32, neg_inf=True), False, "batch-1 sampling"),
              (rand((8, VOCAB_ROW), torch.float16, neg_inf=True), False, ""),
              (rand((2, VOCAB_ROW - 1), torch.bfloat16, neg_inf=True), False,
               "rows off 16-byte alignment"),
              (off_alignment(rand((8, VOCAB_ROW), torch.bfloat16, neg_inf=True)), False,
               "base 2 bytes off alignment"),
              (rand((2, EDGE + 1), torch.float32, neg_inf=True), False, "")]
    return specs


def softmax_cases(dev) -> list[dict]:
    """Phase 1, softmax: every softmax_specs input against the plain version
    (NaN exactly where it has NaN), each with its plan (kernel.plan on this
    card); the main case with its kernels per call; each case planned with a
    cluster of 16 also timed and checked at a cluster of 8."""
    import torch

    from repro_torch.kernels.softmax import kernel as sm_kernel
    from repro_torch.kernels.softmax import ops as sm

    cases = []
    for x, main, note in softmax_specs(dev):
        shape, d = list(x.shape), x.shape[-1]
        got = sm.softmax(x)
        plan = sm_kernel.plan_for(x, got)
        c = {"shape": shape, "dtype": str(x.dtype).removeprefix("torch."), "main": main,
             **check_case("softmax", shape, got, sm.ref.softmax(x), x.dtype, nan_ok=True,
                          atol_scale=1 / d),
             "plan": {k: getattr(plan, k) for k in ("regime", "cluster", "chunk", "load",
                                                   "smem", "lane")}}
        c["note"] = (f"{note}; " if note else "") + (
            f"plan {plan.regime}, {plan.load} loads" if plan.regime == "narrow" else
            f"plan {plan.regime}, cluster {plan.cluster} x {plan.chunk} elements, "
            f"{plan.load} loads")
        _timed_device(c, lambda: sm.softmax(x), lambda: sm.ref.softmax(x),
                      lambda: torch.softmax(x, -1), 20)
        if main:
            c["launches_per_call"] = launches_per_call(lambda: sm.softmax(x), 5)
        if plan.cluster == 16:
            out8 = torch.empty_like(x)
            sm_kernel.softmax_2d(x, out8, max_cluster=8)
            c["cluster_8"] = {
                "chunk": sm_kernel.plan_for(x, out8, max_cluster=8).chunk,
                **check_case("softmax S=8", shape, out8, sm.ref.softmax(x), x.dtype,
                             nan_ok=True, atol_scale=1 / d),
                "ms": graph_ms(lambda: sm_kernel.softmax_2d(x, out8, max_cluster=8), 20)}
            c["note"] += f"; cluster 8: {c['cluster_8']['ms']:.4f} ms"
        c["bound_ms"], c["bound_by"] = bound(2 * x.numel() * x.element_size(),
                                             5 * x.numel(), torch.float32)
        cases.append(c)
    main = next(c for c in cases if c["main"])
    if (main["plan"]["regime"], main["plan"]["load"]) != ("wide", "bulk"):
        raise AssertionError(f"softmax: the main case did not take a cluster with bulk "
                             f"copies: {main['plan']}")
    if {c["plan"]["load"] for c in cases if "off" in c.get("note", "")} != {"element"}:
        raise AssertionError("softmax: a row off 16-byte alignment took 16-byte loads")
    return cases


def counters() -> dict:
    from repro_torch.kernels import launch_counters

    return launch_counters()


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def device_busy(prof) -> tuple[float, int]:
    """(seconds in which the card ran at least one kernel, copy or memset,
    device records) of a torch.profiler window: the union of the device
    records' intervals, read from the raw records (no event tree)."""
    from torch.autograd import DeviceType

    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e9, len(spans)


def traced(fn):
    """(fn(), trace): fn run synchronised under torch.profiler with device
    tracing only; the trace holds the host wall of the call, the card's
    busy seconds in it and its idle share (1 - busy / wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, records = device_busy(prof)
    return result, {"host_wall_s": wall, "device_busy_s": busy,
                    "device_idle_share": 1.0 - busy / wall, "device_records": records}


def serve_counted(report: dict) -> dict:
    out = {k: report[k] for k in SERVE_COUNTED if k in report}
    out["per_request"] = [{k: m[k] for k in PER_REQUEST_COUNTED}
                          for m in report["per_request"]]
    return out


def _fmt(x) -> str:
    """A measured number to 3 decimals, or the text that stands in its place."""
    return f"{x:.3f}" if isinstance(x, float) else str(x)


def paired_serve(tag: str, name: str, gpu: str, run, check, graphs_first: bool | None,
                 trace: tuple = ("graphs", "eager")) -> dict:
    """One serve twice on the same requests: with the captured steps (the
    default) and under disable_graphs(), in the order ``graphs_first`` says
    (None: the graphs run alone, without its eager twin), each side named
    in ``trace`` traced (device tracing only; a side left out runs
    untraced, where reading millions of its device records would take more
    host time than the serve: its busy time and idle share are then not
    measured) and its launches read around it.
    ``run()`` serves and returns the report; ``check(report, launched)``
    returns the problems of one run. Fails unless both pass their checks,
    the greedy outputs and every counter (SERVE_COUNTED, the per-request
    counts) are equal, the launch counters are equal, the graphs run
    captured its steps and the eager run none. Returns per side tokens/s,
    TTFT, wall and idle share, and the graphs run's report."""
    from repro_torch.serve import disable_graphs

    sides = {}
    order = ("graphs",) if graphs_first is None else \
        ("graphs", "eager") if graphs_first else ("eager", "graphs")
    for side in order:
        before = read_counts()
        with contextlib.nullcontext() if side == "graphs" else disable_graphs():
            if side in trace:
                report, record = traced(run)
            else:
                report = run()
                record = {"host_wall_s": report["wall_s"], "device_busy_s": "not measured",
                          "device_idle_share": "not measured",
                          "device_records": "not measured"}
        after = read_counts()
        launched = {k: after[k] - before[k] for k in after}
        problems = check(report, launched)
        if problems:
            raise AssertionError(f"{tag} {name} ({side}): " + "; ".join(problems))
        sides[side] = {"report": report, "launched": launched, "trace": record}
    g = sides["graphs"]
    jc_g = g["report"]["jit_cache"]
    if not jc_g["prefill_chunk"] or not (jc_g["decode"] or jc_g.get("verify")):
        raise AssertionError(f"{tag} {name}: the graphs run captured {jc_g}")
    out = {"graphs_first": graphs_first, "launches": g["launched"]}
    if "eager" not in sides:
        rep = g["report"]
        out["graphs"] = {"decode_tokens_per_s": rep["decode_tokens_per_s"],
                         "ttft_s_mean": rep["ttft_s_mean"], "wall_s": rep["wall_s"],
                         "jit_cache": jc_g, **g["trace"]}
        print(f"[{tag}] {name}, graphs only (no eager twin) on {gpu}: "
              f"{json.dumps(out['graphs'])}", flush=True)
        return {**out, "report": rep}
    e = sides["eager"]
    problems = []
    differ = sorted(r for r in g["report"]["outputs"]
                    if g["report"]["outputs"][r] != e["report"]["outputs"].get(r))
    if differ or set(g["report"]["outputs"]) != set(e["report"]["outputs"]):
        problems.append(f"greedy outputs differ for {differ}")
    cg, ce = serve_counted(g["report"]), serve_counted(e["report"])
    bad = sorted(k for k in cg if cg[k] != ce.get(k))
    if bad:
        problems.append(f"counters differ: {bad}")
    if g["launched"] != e["launched"]:
        problems.append(f"launches {g['launched']} with graphs, {e['launched']} without")
    if any(e["report"]["jit_cache"].values()):
        problems.append(f"the eager run captured {e['report']['jit_cache']}")
    if problems:
        raise AssertionError(f"{tag} {name}, graphs vs eager: " + "; ".join(problems))
    for side, r in sides.items():
        rep = r["report"]
        out[side] = {"decode_tokens_per_s": rep["decode_tokens_per_s"],
                     "ttft_s_mean": rep["ttft_s_mean"], "wall_s": rep["wall_s"],
                     "jit_cache": rep["jit_cache"], **r["trace"]}
    out["tokens_per_s_ratio"] = (out["graphs"]["decode_tokens_per_s"]
                                 / out["eager"]["decode_tokens_per_s"])
    print(f"[{tag}] {name}, graphs vs eager ({'graphs' if graphs_first else 'eager'} "
          f"first) on {gpu}: outputs, counters and launches equal; "
          + "; ".join(f"{side}: decode_tokens_per_s {out[side]['decode_tokens_per_s']:.2f}, "
                      f"ttft_s_mean {out[side]['ttft_s_mean']:.4f}, wall_s "
                      f"{out[side]['wall_s']:.3f}, device busy "
                      f"{_fmt(out[side]['device_busy_s'])} s of "
                      f"{out[side]['host_wall_s']:.3f}, idle share "
                      f"{_fmt(out[side]['device_idle_share'])}, jit_cache "
                      f"{out[side]['jit_cache']}, device records "
                      f"{out[side]['device_records']}" for side in ("graphs", "eager"))
          + f"; tokens/s graphs / eager {out['tokens_per_s_ratio']:.3f}", flush=True)
    return {**out, "report": g["report"]}


def model_phase(dev, gpu: str) -> tuple[dict, object, dict]:
    """Phase 2: full-width prefill + greedy decode through the kernels, and
    the same prefill through the plain versions on the card. Returns the
    result, the model and its params."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.nn.model import build_model
    from repro_torch.train.optimizer import tree_leaves

    cfg = get_config(ARCH)
    model = build_model(cfg, device=dev)
    assert model.lib.TARGET_NAME == "h100", model.lib.TARGET_NAME
    params = model.init(0)
    n_params = sum(t.numel() for t in tree_leaves(params))
    g = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, PREFILL_SHAPE, generator=g, device=dev)
    max_len = PREFILL_SHAPE[1] + DECODE_STEPS
    out = {"params": n_params}
    with torch.inference_mode():
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, state = model.prefill(params, {"tokens": tokens}, max_len)
        torch.cuda.synchronize()
        out["prefill_s"] = time.perf_counter() - t0
        after = read_counts()
        out["prefill_launches"] = {k: after[k] - before[k] for k in after}
        if out["prefill_launches"]["flash_attention"] < cfg.n_layers:
            raise AssertionError(f"flash attention launched "
                                 f"{out['prefill_launches']['flash_attention']} times "
                                 f"in a {cfg.n_layers}-layer prefill")
        if tuple(last.shape) != (PREFILL_SHAPE[0], cfg.padded_vocab) \
                or not torch.isfinite(last.float()).all():
            raise AssertionError(f"prefill logits {tuple(last.shape)} not finite/shaped")
        toks = last[:, :cfg.vocab].argmax(-1)
        generated = []
        for i in range(DECODE_STEPS):
            before = read_counts()
            logits, state = model.decode_step(params, state, toks[:, None],
                                              PREFILL_SHAPE[1] + i)
            after = read_counts()
            if not torch.isfinite(logits.float()).all():
                raise AssertionError(f"decode step {i}: non-finite logits")
            toks = logits[:, :cfg.vocab].argmax(-1)
            generated.append(toks.tolist())
        out["decode_step_launches"] = {k: after[k] - before[k] for k in after}
        out["greedy_tokens"] = generated
        # one serving-shape prefill chunk (64 tokens into a batch-1 donor)
        donor = model.init_decode_state(1, max_len)
        before = read_counts()
        model.prefill_chunk(params, donor, tokens[:1, :64], 0)
        after = read_counts()
        out["prefill_chunk_launches"] = {k: after[k] - before[k] for k in after}

        plain = build_model(cfg, device=dev, target="torch_cpu")
        want, _ = plain.prefill(params, {"tokens": tokens}, max_len)
        got, want = last.float(), want.float()
        rel = ((got - want).norm() / want.norm()).item()
        out["logits_rel_l2"] = rel
        out["logits_max_abs_err"] = (got - want).abs().max().item()
        out["argmax"] = argmax_verdicts(got[:, :cfg.vocab], want[:, :cfg.vocab])
        if rel > LOGITS_REL_L2:
            raise AssertionError(f"prefill logits: kernels vs plain rel L2 {rel:.3g} "
                                 f"> {LOGITS_REL_L2}")
        require_argmax("prefill", out["argmax"])
        # launches made to compare a kernel with its plain version do not
        # count on the main path
        saved = read_counts()
        out["paged_step"] = paged_model_check(dev, model, params)
        out["paged_verify"] = paged_verify_check(dev, model, params)
        for name, fn in counters().items():
            fn.launches = saved[name]
    print(f"[phase2] {ARCH} {n_params / 1e9:.3f}B params bf16 on {gpu}: "
          f"prefill {PREFILL_SHAPE} {out['prefill_s']:.3f} s (first call, includes "
          f"kernel JIT); launches per prefill {out['prefill_launches']}, per decode "
          f"step {out['decode_step_launches']}, per 64-token prefill chunk "
          f"{out['prefill_chunk_launches']}; logits vs plain rel L2 "
          f"{out['logits_rel_l2']:.3g}, max abs {out['logits_max_abs_err']:.3g}, "
          f"argmax {json.dumps(out['argmax'])}; fused paged decode step, kernel vs "
          f"plain: {json.dumps(out['paged_step'])}", flush=True)
    pv = out["paged_verify"]
    print(f"[phase2b] fused paged verify step, batch {pv['batch']} span {pv['span']} at "
          f"kv_len {pv['kv_len']} on {gpu}: {pv['span_rows']['rows']} span rows kernel vs "
          f"plain rel L2 {pv['span_rows']['logits_rel_l2']:.3g}, max abs "
          f"{pv['span_rows']['logits_max_abs_err']:.3g}; row 0 vs the decode step rel L2 "
          f"{pv['row0_vs_decode']['logits_rel_l2']:.3g}; {json.dumps(pv)}", flush=True)
    return out, model, params


def paged_state(dev, model, params, batch: int, fill: int, seed: int,
                max_len: int = PAGED_MAX_LEN, page: int = PAGE, extra: dict | None = None):
    """(tails, pools, tables): ``batch`` prefilled prompts of ``fill``
    tokens (``extra``: more of the prefill's batch, whisper's frames), each
    leaf that pages (``model.state_page_axes``: (stack, B, KH, S, hd), token
    axis 3) moved into fused pools (stack, 1, KH, n_pages, ``page``, hd)
    behind permuted page tables (page 0 is the scratch page that pads every
    table row past its coverage), room for ``max_len`` rows (default the
    serve phase's); the other leaves, a family's tails (none for the dense
    family), as a tails-only slot table; the (B, P) tables on the device."""
    import torch

    cfg = model.cfg
    g = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (batch, fill), generator=g, device=dev)
    _, state = model.prefill(params, {"tokens": tokens, **(extra or {})}, fill)
    axes = model.state_page_axes(state)
    width = -(-max_len // page)
    n_pages = 1 + batch * width
    perm = (torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(seed))
            + 1).view(batch, width)
    pools = {n: torch.zeros((x.shape[0], 1, x.shape[2], n_pages, page, x.shape[4]),
                            dtype=model.dtype, device=dev)
             for n, x in state.items() if axes[n] is not None}
    for b in range(batch):
        for p in range(-(-fill // page)):
            rows = slice(p * page, min((p + 1) * page, fill))
            n_rows = rows.stop - rows.start
            for n in pools:
                pools[n][:, 0, :, int(perm[b, p]), :n_rows] = state[n][:, b, :, rows]
    tails = {n: x for n, x in state.items() if axes[n] is None}
    return tails, pools, perm.to(device=dev, dtype=torch.int32)


def paged_pools(dev, model, params, batch: int, fill: int, seed: int,
                max_len: int = PAGED_MAX_LEN):
    """paged_state's (pools, tables), for a family whose every leaf pages."""
    return paged_state(dev, model, params, batch, fill, seed, max_len)[1:]


class _PlainOps:
    """A library's ops with the kernels named in ``plain`` bound to their
    plain versions, every other primitive the same: a model step through the
    kernels vs through the plain versions. ``plain`` defaults to the paged
    kernel's two primitives."""

    def __init__(self, ops, plain: dict | None = None):
        if plain is None:
            from repro_torch.kernels.paged.ref import paged_attention_ref
            plain = {"attention_decode_paged": paged_attention_ref,
                     "attention_verify_paged": paged_attention_ref}
        self._ops, self._plain = ops, plain

    def __getattr__(self, name):
        return self._plain[name] if name in self._plain else getattr(self._ops, name)


def paged_step_compare(dev, model, params) -> dict:
    """One fused paged decode step at batch 8 over 256 prefilled rows
    (kv_len 257), through the paged kernel and through its plain version on
    copies of the same pools: _logits_check of the kernel's logits against
    the plain version's. Checks nothing."""
    import torch

    from repro_torch.nn import lm

    batch, fill = PROFILE_BATCH, PROFILE_FILL
    pools, tables = paged_pools(dev, model, params, batch, fill, seed=3)
    g = torch.Generator(device=dev).manual_seed(4)
    tokens = torch.randint(0, model.cfg.vocab, (batch, 1), generator=g, device=dev)
    pos = torch.full((batch,), fill, dtype=torch.int64, device=dev)
    logits = {}
    for name, tsl in (("kernel", model.tsl), ("plain", _PlainOps(model.tsl))):
        copy = {n: t.clone() for n, t in pools.items()}
        logits[name], _, _ = lm.lm_decode_step_paged(tsl, params, {}, copy, tables,
                                                     tokens, pos, model.cfg)
    return {"batch": batch, "kv_len": fill + 1,
            **_logits_check(logits["kernel"], logits["plain"], model.cfg.vocab)}


def _logits_check(got, want, vocab: int) -> dict:
    """Finiteness, rel L2, max abs error and the argmax verdicts of (rows, V)
    logits ``got`` against ``want``."""
    import torch

    got, want = got.float(), want.float()
    return {"rows": got.shape[0], "finite": bool(torch.isfinite(got).all()),
            "logits_rel_l2": ((got - want).norm() / want.norm()).item(),
            "logits_max_abs_err": (got - want).abs().max().item(),
            "argmax": argmax_verdicts(got[:, :vocab], want[:, :vocab])}


def _require_logits(name: str, r: dict, rel_l2: float = LOGITS_REL_L2) -> None:
    """Raise unless ``r`` (_logits_check) is finite, within ``rel_l2``
    (LOGITS_REL_L2, the bf16 bound) and without a failed argmax verdict."""
    if not r["finite"]:
        raise AssertionError(f"{name}: non-finite logits")
    if r["logits_rel_l2"] > rel_l2:
        raise AssertionError(f"{name}: rel L2 {r['logits_rel_l2']:.3g} > {rel_l2}")
    require_argmax(f"{name} (rel L2 {r['logits_rel_l2']:.3g})", r["argmax"])


def paged_verify_check(dev, model, params) -> dict:
    """Phase 2b: one fused paged verify step at batch 8, a span of
    SPEC_K + 1 tokens at 256 prefilled rows, through the paged kernel and
    through its plain version on copies of the same pools (the step writes
    them in place): all 40 span rows must pass _require_logits. Row 0 of the
    kernel's span must pass it against a fused decode step from the same
    pools with the span's first token (the span-of-one contract)."""
    import torch

    from repro_torch.nn import lm

    cfg, batch, fill = model.cfg, PROFILE_BATCH, PROFILE_FILL
    pools, tables = paged_pools(dev, model, params, batch, fill, seed=7)
    g = torch.Generator(device=dev).manual_seed(8)
    span = torch.randint(0, cfg.vocab, (batch, SPEC_K + 1), generator=g, device=dev)
    pos = torch.full((batch,), fill, dtype=torch.int64, device=dev)
    logits = {}
    for name, tsl in (("kernel", model.tsl), ("plain", _PlainOps(model.tsl))):
        copy = {n: t.clone() for n, t in pools.items()}
        logits[name], _, _ = lm.lm_verify_step_paged(tsl, params, {}, copy, tables, span,
                                                     pos, cfg)
    copy = {n: t.clone() for n, t in pools.items()}
    decode, _, _ = lm.lm_decode_step_paged(model.tsl, params, {}, copy, tables, span[:, :1],
                                           pos, cfg)
    vocab = cfg.padded_vocab
    out = {"batch": batch, "span": SPEC_K + 1, "kv_len": fill + SPEC_K + 1,
           "span_rows": _logits_check(logits["kernel"].reshape(-1, vocab),
                                      logits["plain"].reshape(-1, vocab), cfg.vocab),
           "row0_vs_decode": _logits_check(logits["kernel"][:, 0], decode, cfg.vocab)}
    _require_logits("fused paged verify step, kernel vs plain", out["span_rows"])
    _require_logits("fused paged verify row 0 vs the fused decode step",
                    out["row0_vs_decode"])
    return out


def paged_model_check(dev, model, params) -> dict:
    """Phase 2, paged: paged_step_compare, which must pass _require_logits
    (finite, within LOGITS_REL_L2 of the plain version's, and no failed
    argmax verdict: an equal argmax on every row but a plain tie)."""
    out = paged_step_compare(dev, model, params)
    _require_logits("fused paged decode step, kernel vs plain", out)
    return out


def serve_phase(gpu: str) -> dict:
    """Phase 3: the serving CLI at full width, with the captured steps and
    under disable_graphs() (paired_serve, graphs first)."""
    from repro_torch.launch import serve

    n_req = int(SERVE_ARGS[SERVE_ARGS.index("--requests") + 1])
    gen = int(SERVE_ARGS[SERVE_ARGS.index("--gen-len") + 1])

    def check(report, launched):
        problems = []
        if report["target"] != "h100":
            problems.append(f"served with target {report['target']!r}")
        if report["requests"] != n_req or report["refused"]:
            problems.append(f"{report['requests']} of {n_req} answered, refused "
                            f"{report['refused']}")
        short = {r: len(t) for r, t in report["outputs"].items() if len(t) != gen}
        if short or len(report["outputs"]) != n_req:
            problems.append(f"requests without {gen} tokens: {short}")
        if report["padded_slot_steps_steady"] != 0:
            problems.append(f"padded_slot_steps_steady {report['padded_slot_steps_steady']}")
        for name in ("rmsnorm", "swiglu"):
            if launched[name] <= 0:
                problems.append(f"{name} kernel never launched while serving")
        return problems

    out = paired_serve("phase3", f"serve {ARCH}", gpu,
                       lambda: serve.main(SERVE_ARGS)["report"], check, graphs_first=True)
    return out


def paged_requests(vocab: int, request_cls) -> list:
    import numpy as np

    rng = np.random.default_rng(5)
    system = rng.integers(0, vocab, PAGED_SYSTEM)
    return [request_cls(rid=f"p{i}", gen_len=PAGED_GEN, shared_prefix_len=PAGED_SYSTEM,
                        tokens=np.concatenate([system, rng.integers(0, vocab, PAGED_UNIQUE)])
                        .astype(np.int32))
            for i in range(PAGED_REQUESTS)]


def paged_check(cfg, n_req: int, speculation=None, int8: bool = False,
                refused: set = frozenset()):
    """The problems of one fused paged serve (paired_serve's ``check``):
    decode ran fused with no lane activation, the rids refused are
    ``refused`` (none by default), every
    request got PAGED_GEN tokens, the paged kernel launched n_layers times
    per decode or verify step (``int8``: the pages are int8, and the kernel
    launched no time: int8 pools take the plain version by their dtype),
    rmsnorm and swiglu launched, and with ``speculation`` verify steps
    ran."""
    def check(report, launched):
        paged = report["paged"]
        steps = paged["decode_steps"] + paged["verify_steps"]
        per_step = 0 if int8 else cfg.n_layers
        problems = []
        if paged["int8"] != int8:
            problems.append(f"report['paged']['int8'] is {paged['int8']}")
        if report["target"] != "h100":
            problems.append(f"served with target {report['target']!r}")
        if not paged["fused"] or paged["lane_activations"]:
            problems.append(f"fused {paged['fused']}, lane_activations "
                            f"{paged['lane_activations']}")
        if {r["rid"] for r in report["refused"]} != set(refused) \
                or len(report["refused"]) != len(refused) or report["requests"] != n_req:
            problems.append(f"{report['requests']} of {n_req} answered, refused "
                            f"{report['refused']}")
        short = {r: len(t) for r, t in report["outputs"].items() if len(t) != PAGED_GEN}
        if short or len(report["outputs"]) != n_req:
            problems.append(f"requests without {PAGED_GEN} tokens: {short}")
        if launched["paged_attention"] != per_step * steps:
            problems.append(f"paged kernel launched {launched['paged_attention']} times in "
                            f"{steps} decode or verify steps of {cfg.n_layers} layers "
                            f"(want {per_step} a step)")
        for name in ("rmsnorm", "swiglu"):
            if launched[name] <= 0:
                problems.append(f"{name} kernel never launched while serving paged")
        if speculation is not None and not report["spec"]["verify_steps"]:
            problems.append("no verify step ran")
        return problems
    return check


def paged_serve_phase(dev, params, gpu: str) -> dict:
    """Phase 3b: fused paged serving at full width, with the captured steps
    and under disable_graphs() (paired_serve, eager first); the counters are
    set to 0 just before the pair and read just after it."""
    from repro_torch.configs import get_config
    from repro_torch.serve import PagedConfig, Request, ServeEngine

    cfg = get_config(ARCH)
    kw = dict(batch=PAGED_BATCH, max_len=PAGED_MAX_LEN, device=dev, params=params,
              prefill_chunk=PAGED_CHUNK)
    for fn in counters().values():
        fn.launches = 0

    def run():
        engine = ServeEngine(cfg, paged=PagedConfig(page_size=PAGE), **kw)
        requests = paged_requests(cfg.vocab, Request)
        return engine.run(requests)

    pair = paired_serve("phase3b", f"paged serve {ARCH}", gpu, run,
                        paged_check(cfg, PAGED_REQUESTS), graphs_first=False)
    launched = read_counts()
    # where the host's wall goes once the steps are captured: one more
    # graphs run under cProfile (its launches are not counted)
    pair["host_top_functions_ms"] = _host_top_functions(run, 15, calls=1)
    for name, fn in counters().items():
        fn.launches = launched[name]
    print(f"[phase3b] paged serve with graphs on {gpu}, host time by Python function "
          f"(cProfile, ms in one serve): {json.dumps(pair['host_top_functions_ms'])}",
          flush=True)
    report = pair.pop("report")
    paged = report["paged"]
    if paged["prefix_hits"] <= 0:
        raise AssertionError("paged serve: no prefix hit")
    # information, not a bar: the same requests through the lane-mode engine
    lane = ServeEngine(cfg, **kw).run(paged_requests(cfg.vocab, Request))
    same = sum(report["outputs"][r] == lane["outputs"][r] for r in report["outputs"])
    # where a request's tokens first differ from lane mode's (a kernel fault
    # would show at the first decoded tokens, a near-tied argmax anywhere)
    first_diff = sorted(next(i for i, (a, b) in enumerate(zip(toks, lane["outputs"][r]))
                             if a != b)
                        for r, toks in report["outputs"].items()
                        if toks != lane["outputs"][r])
    out = {"decode_tokens_per_s": report["decode_tokens_per_s"],
           "ttft_s_mean": report["ttft_s_mean"], "wall_s": report["wall_s"],
           "steps": report["steps"], "launches": launched, "paged": paged,
           "prefill_tokens": report["prefill_tokens"], "pair": pair,
           "lane_decode_tokens_per_s": lane["decode_tokens_per_s"],
           "lane_ttft_s_mean": lane["ttft_s_mean"],
           "lane_prefill_tokens": lane["prefill_tokens"],
           "share_equal_to_lane": same / PAGED_REQUESTS,
           "first_differing_token": first_diff, "outputs": report["outputs"]}
    print(f"[phase3b] paged serve {ARCH} on {gpu} (graphs): decode_tokens_per_s "
          f"{out['decode_tokens_per_s']:.1f}, ttft_s_mean {out['ttft_s_mean']:.3f}, "
          f"prefill_tokens {out['prefill_tokens']}, launches of the pair {launched}, paged "
          f"{json.dumps(paged)}; lane-mode run on the same requests "
          f"{out['lane_decode_tokens_per_s']:.1f} tokens/s, ttft "
          f"{out['lane_ttft_s_mean']:.3f} s, prefill_tokens {out['lane_prefill_tokens']}, "
          f"requests with equal tokens "
          f"{same}/{PAGED_REQUESTS}, first differing token of the others {first_diff}",
          flush=True)
    return out


def spec_requests(vocab: int, request_cls, n: int, gen: int = PAGED_GEN) -> list:
    """Phase 3e(ii)/(iii): ``n`` requests whose SPEC_PROMPT-token prompts
    repeat a seeded SPEC_PATTERN-token pattern, ``gen`` generated."""
    import numpy as np

    rng = np.random.default_rng(9)
    return [request_cls(rid=f"s{i}", gen_len=gen,
                        tokens=np.tile(rng.integers(0, vocab, SPEC_PATTERN),
                                       SPEC_PROMPT // SPEC_PATTERN).astype(np.int32))
            for i in range(n)]


def spec_serve_phase(dev, params, gpu: str, paged_outputs: dict) -> dict:
    """Phase 3e: speculative fused paged serving at full width, phase 2's
    params, 3b's engine shape (page 64, 8 slots, max_len 320, 64-token
    chunks), greedy. Each run is a paired_serve (graphs on and off, the
    order alternating from run to run; (i) runs with graphs alone, its eager
    twin dropped to keep the script's time) under paged_check: the paged kernel
    launches n_layers times per decode or verify step, no run activates a
    lane or refuses a request, every request gets PAGED_GEN tokens.
    (i) fixed depth SPEC_K on 3b's requests: verify steps must run; the
        share of requests whose tokens equal 3b's is information only (bf16
        may flip a near-tied argmax).
    (ii) the cost-priced depth with the n-gram drafter on SPEC_REQUESTS
        pattern prompts, beside the same requests without speculation (its
        own pair): verify steps must run. The two graphs runs, in one call,
        give what speculation buys end to end.
    (iii) the draft-model drafter, qwen1.5-0.5b given the target's own
        weights (``draft_params``; the engine's default would draw them from
        seed + 2), at fixed depth SPEC_K on SPEC_DRAFT_REQUESTS of (ii)'s
        requests: its drafts are the target's greedy tokens up to bf16
        rounding, so drafts must be accepted."""
    from repro_torch.configs import get_config
    from repro_torch.serve import PagedConfig, Request, ServeEngine, SpeculationConfig

    cfg = get_config(ARCH)
    kw = dict(batch=PAGED_BATCH, max_len=PAGED_MAX_LEN, device=dev, params=params,
              prefill_chunk=PAGED_CHUNK, paged=PagedConfig(page_size=PAGE))
    t_phase = time.perf_counter()

    def serve(name, requests, speculation, n_req, graphs_first, draft_params=None):
        def run():
            engine = ServeEngine(cfg, speculation=speculation, draft_params=draft_params,
                                 **kw)
            return engine.run(requests())

        pair = paired_serve("phase3e", name, gpu, run,
                            paged_check(cfg, n_req, speculation), graphs_first)
        report = pair.pop("report")
        paged, spec = report["paged"], report.get("spec")
        r = {"decode_tokens_per_s": report["decode_tokens_per_s"],
             "ttft_s_mean": report["ttft_s_mean"], "wall_s": report["wall_s"],
             "steps": report["steps"], "decode_steps": paged["decode_steps"],
             "verify_steps": paged["verify_steps"], "launches": pair["launches"],
             "pair": pair}
        if spec is not None:
            r["spec"] = {k: spec[k] for k in (
                "drafter", "k_max", "drafted_tokens", "accepted_tokens", "accepted_rate",
                "mean_accepted_span", "steps_per_emitted_token",
                "slot_steps_per_emitted_token")}
            r["depth_mean"] = spec["drafted_tokens"] / max(
                sum(m["verify_rounds"] for m in report["per_request"]), 1)
        print(f"[phase3e] {name} on {gpu} (graphs): "
              f"{json.dumps({k: v for k, v in r.items() if k != 'pair'})}", flush=True)
        return r, report["outputs"]

    out = {}
    out["i"], outputs = serve("(i) fixed depth, 3b's requests",
                              lambda: paged_requests(cfg.vocab, Request),
                              SpeculationConfig(fixed_k=SPEC_K), PAGED_REQUESTS, None)
    same = sum(outputs[r] == paged_outputs[r] for r in outputs)
    out["i"]["share_equal_to_3b"] = same / PAGED_REQUESTS
    print(f"[phase3e] (i) requests with tokens equal to 3b's: {same}/{PAGED_REQUESTS} "
          f"(information only)", flush=True)
    out["ii"], _ = serve("(ii) cost-priced depth, n-gram drafter",
                         lambda: spec_requests(cfg.vocab, Request, SPEC_REQUESTS),
                         SpeculationConfig(), SPEC_REQUESTS, False)
    out["ii_plain"], _ = serve("(ii) the same requests without speculation",
                               lambda: spec_requests(cfg.vocab, Request, SPEC_REQUESTS),
                               None, SPEC_REQUESTS, True)
    out["iii"], _ = serve("(iii) draft-model drafter, the target's weights",
                          lambda: spec_requests(cfg.vocab, Request, SPEC_DRAFT_REQUESTS),
                          SpeculationConfig(drafter="draft_model", draft_arch=ARCH,
                                            fixed_k=SPEC_K),
                          SPEC_DRAFT_REQUESTS, False, draft_params=params)
    if out["iii"]["spec"]["accepted_tokens"] <= 0:
        raise AssertionError("speculative paged serve (iii): the draft model's drafts "
                             "were never accepted")
    out["seconds"] = time.perf_counter() - t_phase
    ii, plain = out["ii"]["pair"], out["ii_plain"]["pair"]
    out["speculation_speedup"] = {
        side: ii[side]["decode_tokens_per_s"] / plain[side]["decode_tokens_per_s"]
        for side in ("graphs", "eager")}
    print(f"[phase3e] speculative paged serve {ARCH} on {gpu}: decode_tokens_per_s "
          f"graphs / eager (i) {out['i']['pair']['graphs']['decode_tokens_per_s']:.1f} / "
          f"(no twin), (ii) "
          f"{ii['graphs']['decode_tokens_per_s']:.1f} / "
          f"{ii['eager']['decode_tokens_per_s']:.1f} vs "
          f"{plain['graphs']['decode_tokens_per_s']:.1f} / "
          f"{plain['eager']['decode_tokens_per_s']:.1f} without speculation "
          f"(speculation x{out['speculation_speedup']['graphs']:.3f} graphs, "
          f"x{out['speculation_speedup']['eager']:.3f} eager), (iii) "
          f"{out['iii']['pair']['graphs']['decode_tokens_per_s']:.1f} / "
          f"{out['iii']['pair']['eager']['decode_tokens_per_s']:.1f}; accepted "
          f"rate (i) {out['i']['spec']['accepted_rate']:.3f}, (ii) "
          f"{out['ii']['spec']['accepted_rate']:.3f}, (iii) "
          f"{out['iii']['spec']['accepted_rate']:.3f}; phase {out['seconds']:.1f} s",
          flush=True)
    return out


def int8_pools(pools: dict) -> dict:
    """Absmax-int8 copies of bf16 fused pools (repro_torch.dist.compression,
    per (token, head) row): the int8 payloads and their float32 scale pools
    as ``{leaf}__scale``, the layout PagedKVStore(int8=True) keeps."""
    from repro_torch.dist.compression import quantize_absmax_int8

    out = {}
    for n in ("k", "v"):
        out[n], out[f"{n}__scale"] = quantize_absmax_int8(pools[n])
    return out


def int8_step_check(dev, model, params) -> dict:
    """Phase 3f's step check: one fused paged decode step at batch 8 over 256
    prefilled rows held as int8 pools (the plain version, which dequantizes
    per touched page), against the same step run by the CUDA kernel over
    bf16 pools holding the dequantized rows: _require_logits. Then the same
    int8 step through the engine's step code, captured (a capture and a
    replay) against its eager twin under disable_graphs(): logits and
    every pool bit-equal, the replay's recorded launches equal to an eager
    step's, and the paged kernel launched no time."""
    import numpy as np
    import torch

    from repro_torch.nn import lm
    from repro_torch.serve import StepGraphs, disable_graphs
    from repro_torch.serve.graphs import run_model_step

    cfg, batch, fill = model.cfg, PROFILE_BATCH, PROFILE_FILL
    with torch.inference_mode():
        pools, tables = paged_pools(dev, model, params, batch, fill, seed=13)
        q8 = int8_pools(pools)
        deq = {n: (q8[n].float() * q8[f"{n}__scale"]).to(model.dtype) for n in ("k", "v")}
        tokens = np.random.default_rng(14).integers(0, cfg.vocab, (batch, 1))
        pos = np.full(batch, fill, np.int64)
        t_tokens = torch.from_numpy(tokens).to(dev)
        t_pos = torch.from_numpy(pos).to(dev)
        got, _, _ = lm.lm_decode_step_paged(model.tsl, params, {},
                                            {n: t.clone() for n, t in q8.items()}, tables,
                                            t_tokens, t_pos, cfg)
        want, _, _ = lm.lm_decode_step_paged(model.tsl, params, {}, deq, tables, t_tokens,
                                             t_pos, cfg)
        out = {"batch": batch, "kv_len": fill + 1,
               "vs_kernel_on_dequantized": _logits_check(got, want, cfg.vocab)}
        _require_logits("fused int8 decode step vs the kernel over the dequantized rows",
                        out["vs_kernel_on_dequantized"])
        tables_np = tables.cpu().numpy()
        captured = {n: t.clone() for n, t in q8.items()}
        eager_pools = {n: t.clone() for n, t in q8.items()}
        graphs = StepGraphs(dev)
        before = read_counts()
        for _ in range(2):          # the capture (after its warm-up), then a replay
            replayed = run_model_step(graphs, "decode", model, params, {}, tokens, pos,
                                      pools=captured, tables=tables_np)
        replayed = replayed.clone()
        mid = read_counts()
        with disable_graphs():
            eager = run_model_step(StepGraphs(dev), "decode", model, params, {}, tokens,
                                   pos, pools=eager_pools, tables=tables_np).clone()
        after = read_counts()
        torch.cuda.synchronize()
    entry = graphs.steps["decode", 1]
    eager_launches = {k: after[k] - mid[k] for k in after if after[k] != mid[k]}
    both = {k: mid[k] - before[k] for k in mid if mid[k] != before[k]}
    out.update({
        "replays": entry.replays, "launches_per_replay": entry.launches,
        "eager_launches": eager_launches,
        "logits_bit_equal": bool(torch.equal(replayed, eager)),
        "pools_bit_equal": all(bool(torch.equal(captured[n], eager_pools[n]))
                               for n in captured),
        "max_abs_diff_vs_eager": (replayed.float() - eager.float()).abs().max().item()})
    problems = []
    if not (out["logits_bit_equal"] and out["pools_bit_equal"]):
        problems.append(f"captured vs eager not bit-equal (logits {out['logits_bit_equal']}, "
                        f"pools {out['pools_bit_equal']}, max abs diff "
                        f"{out['max_abs_diff_vs_eager']:.3g})")
    if entry.replays != 1 or entry.launches != eager_launches \
            or both != {k: 2 * v for k, v in eager_launches.items()}:
        problems.append(f"launches: replay {entry.launches}, eager {eager_launches}, "
                        f"capture + replay {both} ({entry.replays} replays)")
    if "paged_attention" in eager_launches or "paged_attention" in both:
        problems.append("the paged kernel launched on int8 pools")
    if problems:
        raise AssertionError("phase 3f, int8 step: " + "; ".join(problems))
    return out


def int8_serve_phase(dev, model, params, gpu: str, paged_out: dict) -> dict:
    """Phase 3f: 3b's requests and engine shape under PagedConfig(int8=True),
    the page budget set to the bytes of 3b's default bf16 pool: paired_serve
    (graphs first, both sides untraced) under paged_check(int8=True): the
    pages are int8, the
    paged kernel launches no time (int8 pools route to the plain version by
    their dtype), rmsnorm and swiglu launch. Prints, as information, the
    pages against 3b's, tokens/s, TTFT, the share of requests
    whose tokens equal 3b's and where the others first differ. Then
    int8_step_check."""
    from repro_torch.configs import get_config
    from repro_torch.serve import PagedConfig, Request, ServeEngine

    cfg = get_config(ARCH)
    budget = paged_out["paged"]["hbm_budget_bytes"]
    config = PagedConfig(page_size=PAGE, int8=True, hbm_budget_bytes=budget)
    kw = dict(batch=PAGED_BATCH, max_len=PAGED_MAX_LEN, device=dev, params=params,
              prefill_chunk=PAGED_CHUNK)
    t_phase = time.perf_counter()

    def run():
        return ServeEngine(cfg, paged=config, **kw).run(paged_requests(cfg.vocab, Request))

    pair = paired_serve("phase3f", f"int8 paged serve {ARCH}", gpu, run,
                        paged_check(cfg, PAGED_REQUESTS, int8=True), graphs_first=True,
                        trace=())
    report = pair.pop("report")
    paged = report["paged"]
    ref = paged_out["outputs"]
    same = sum(report["outputs"][r] == ref[r] for r in report["outputs"])
    first_diff = sorted(next(i for i, (a, b) in enumerate(zip(toks, ref[r])) if a != b)
                        for r, toks in report["outputs"].items() if toks != ref[r])
    saved = read_counts()
    step = int8_step_check(dev, model, params)
    for name, fn in counters().items():       # a comparison, not the main path
        fn.launches = saved[name]
    out = {"n_pages": paged["n_pages"], "n_pages_3b": paged_out["paged"]["n_pages"],
           "page_bytes": paged["page_bytes"], "page_bytes_3b": paged_out["paged"]["page_bytes"],
           "pages_ratio": paged["n_pages"] / paged_out["paged"]["n_pages"],
           "hbm_budget_bytes": budget, "paged": paged, "launches": pair["launches"],
           "share_equal_to_3b": same / PAGED_REQUESTS, "first_differing_token": first_diff,
           "pair": pair, "step": step, "seconds": time.perf_counter() - t_phase}
    g = pair["graphs"]
    print(f"[phase3f] int8 paged serve {ARCH} on {gpu}: {out['n_pages']} pages of "
          f"{out['page_bytes']} B against 3b's {out['n_pages_3b']} of {out['page_bytes_3b']} B "
          f"in {budget} B (x{out['pages_ratio']:.3f}); graphs decode_tokens_per_s "
          f"{g['decode_tokens_per_s']:.2f}, ttft_s_mean {g['ttft_s_mean']:.4f} (both sides "
          f"untraced; a captured int8 decode step's idle share is phase 4's "
          f"decode_step_paged_int8 row); requests with tokens equal to 3b's {same}/"
          f"{PAGED_REQUESTS}, first differing token of the others {first_diff} (information "
          f"only); one int8 step vs the kernel on the dequantized rows rel L2 "
          f"{step['vs_kernel_on_dequantized']['logits_rel_l2']:.3g}, captured vs eager "
          f"bit-equal, launches per replay {step['launches_per_replay']}; phase "
          f"{out['seconds']:.1f} s", flush=True)
    return out


def long_requests(vocab: int, request_cls) -> list:
    """Phase 3g: LONG_REQUESTS requests sharing a LONG_DOC-token document,
    each with LONG_OWN tokens of its own, LONG_GEN generated."""
    import numpy as np

    rng = np.random.default_rng(17)
    doc = rng.integers(0, vocab, LONG_DOC)
    return [request_cls(rid=f"l{i}", gen_len=LONG_GEN, shared_prefix_len=LONG_DOC,
                        tokens=np.concatenate([doc, rng.integers(0, vocab, LONG_OWN)])
                        .astype(np.int32))
            for i in range(LONG_REQUESTS)]


def long_context_phase(dev, params, gpu: str) -> dict:
    """Phase 3g: a long-context fused paged serve on which the paged kernel
    splits: batch LONG_BATCH, max_len LONG_MAX_LEN, page PAGE, chunk
    LONG_CHUNK, one bucket of LONG_DOC + LONG_OWN. Fails unless kernel.plan
    gives more than one split at the engine's table width; paired_serve
    (eager first) under paged_check (the paged kernel n_layers times a
    decode step). The counters are set to 0 just before the pair and read
    just after it (row 7's launches_phase3g)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.common import sm_count
    from repro_torch.kernels.paged import kernel as paged_kernel
    from repro_torch.serve import PagedConfig, Request, ServeEngine

    cfg = get_config(ARCH)
    kw = dict(batch=LONG_BATCH, max_len=LONG_MAX_LEN, device=dev, params=params,
              prefill_chunk=LONG_CHUNK, buckets=(LONG_DOC + LONG_OWN,),
              paged=PagedConfig(page_size=PAGE))
    t_phase = time.perf_counter()
    width = -(-LONG_MAX_LEN // PAGE)
    splits, pps = paged_kernel.plan(LONG_BATCH, cfg.n_kv_heads, width, PAGE, sm_count(dev))
    if splits < 2:
        raise AssertionError(f"phase 3g: kernel.plan gives {splits} split(s) at batch "
                             f"{LONG_BATCH}, table width {width}")
    widths = []

    def run():
        engine = ServeEngine(cfg, **kw)
        widths.append(engine._table_width)
        return engine.run(long_requests(cfg.vocab, Request))

    for fn in counters().values():
        fn.launches = 0
    pair = paired_serve("phase3g", f"long-context paged serve {ARCH}", gpu, run,
                        paged_check(cfg, LONG_REQUESTS), graphs_first=False)
    launched = read_counts()
    if set(widths) != {width}:
        raise AssertionError(f"phase 3g: the engines' table widths {widths}, want {width}")
    report = pair.pop("report")
    paged = report["paged"]
    if paged["prefix_hits"] <= 0:
        raise AssertionError("phase 3g: the document was never shared")
    out = {"batch": LONG_BATCH, "max_len": LONG_MAX_LEN, "table_width": width,
           "splits": splits, "pps": pps, "launches": launched, "paged": paged,
           "decode_steps": paged["decode_steps"], "pair": pair,
           "seconds": time.perf_counter() - t_phase}
    print(f"[phase3g] long-context paged serve {ARCH} on {gpu}: {LONG_REQUESTS} x "
          f"({LONG_DOC} shared + {LONG_OWN} + {LONG_GEN}) at batch {LONG_BATCH}, table "
          f"width {width}: plan {splits} splits x {pps} entries per decode step; "
          + "; ".join(f"{side}: decode_tokens_per_s {pair[side]['decode_tokens_per_s']:.2f}, "
                      f"ttft_s_mean {pair[side]['ttft_s_mean']:.4f}, idle share "
                      f"{pair[side]['device_idle_share']:.3f}" for side in ("graphs", "eager"))
          + f"; launches of the pair {launched}, decode steps {paged['decode_steps']}, "
          f"pool {paged['n_pages']} pages of {paged['page_bytes']} B, prefix hits "
          f"{paged['prefix_hits']}; phase {out['seconds']:.1f} s", flush=True)
    return out


def stream_phase(dev, params, gpu: str) -> dict:
    """Phase 3h: submit() into a running engine. run() starts on the first
    STREAM_FIRST of 3b's requests; a host thread waits until the paged
    kernel has launched (decoding is under way), then submits the next
    STREAM_TOTAL - STREAM_FIRST at seeded Poisson times (mean
    STREAM_GAP_S apart), then one with a duplicate rid and one with
    gen_len 0. The all-at-once run of the same STREAM_TOTAL requests comes
    first; the counters are set to 0 just before the streamed run and read
    just after it (row 7's launches_phase3h). Fails unless every valid
    request is answered with the all-at-once run's tokens, the streamed run
    passes paged_check (fused, the paged kernel n_layers times a decode
    step) with exactly the two invalid submissions in report["refused"],
    their reasons invalid, and a streamed request was admitted after the
    loop's first step. Prints each streamed request's arrival-to-first-token
    time."""
    import threading

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.paged import ops as paged_ops
    from repro_torch.serve import PagedConfig, Request, ServeEngine

    cfg = get_config(ARCH)
    kw = dict(batch=PAGED_BATCH, max_len=PAGED_MAX_LEN, device=dev, params=params,
              prefill_chunk=PAGED_CHUNK, paged=PagedConfig(page_size=PAGE))
    t_phase = time.perf_counter()
    reqs = paged_requests(cfg.vocab, Request)[:STREAM_TOTAL]
    want = ServeEngine(cfg, **kw).run(paged_requests(cfg.vocab, Request)[:STREAM_TOTAL])
    invalid = [Request(rid=reqs[1].rid, tokens=reqs[1].tokens, gen_len=4),
               Request(rid="zero", tokens=reqs[2].tokens, gen_len=0)]
    engine = ServeEngine(cfg, **kw)
    gaps = np.random.default_rng(19).exponential(STREAM_GAP_S, len(reqs) - STREAM_FIRST + 2)
    submitted = {}
    t0 = time.perf_counter()

    def feed():
        start = paged_ops.paged_attention.launches
        while paged_ops.paged_attention.launches == start:
            time.sleep(0.001)
        for gap, r in zip(gaps, reqs[STREAM_FIRST:] + invalid):
            time.sleep(gap)
            engine.submit(r)
            submitted.setdefault(r.rid, time.perf_counter() - t0)

    for fn in counters().values():
        fn.launches = 0
    thread = threading.Thread(target=feed, daemon=True)
    thread.start()
    got = engine.run(reqs[:STREAM_FIRST])
    launched = read_counts()
    thread.join(timeout=60)
    problems = paged_check(cfg, STREAM_TOTAL, refused={reqs[1].rid, "zero"})(got, launched)
    if thread.is_alive():
        problems.append("the submitting thread did not finish")
    differ = sorted(r for r in want["outputs"] if got["outputs"].get(r) != want["outputs"][r])
    if differ or set(got["outputs"]) != set(want["outputs"]):
        problems.append(f"outputs differ from the all-at-once run for {differ} (answered "
                        f"{len(got['outputs'])} of {len(want['outputs'])})")
    if not all(r["reason"].startswith("invalid:") for r in got["refused"]):
        problems.append(f"refused {got['refused']}")
    admitted = {m["rid"]: m["admitted_at_step"] for m in got["per_request"]}
    streamed = [r.rid for r in reqs[STREAM_FIRST:]]
    if not streamed or max(admitted.get(r, 0) for r in streamed) <= 0:
        problems.append(f"no streamed request was admitted after the first step: {admitted}")
    if problems:
        raise AssertionError("phase 3h: " + "; ".join(problems))
    ttft = {m["rid"]: m["ttft_s"] for m in got["per_request"] if m["rid"] in streamed}
    out = {"first": STREAM_FIRST, "streamed": len(streamed), "refused": got["refused"],
           "launches": launched, "decode_steps": got["paged"]["decode_steps"],
           "submitted_s": submitted, "admitted_at_step": admitted,
           "arrival_to_first_token_s": ttft,
           "decode_tokens_per_s": got["decode_tokens_per_s"],
           "all_at_once_decode_tokens_per_s": want["decode_tokens_per_s"],
           "seconds": time.perf_counter() - t_phase}
    print(f"[phase3h] submit() into a running engine, {ARCH} on {gpu}: {STREAM_FIRST} "
          f"requests at start, {len(streamed)} streamed (mean gap {STREAM_GAP_S} s) and 2 "
          f"invalid; outputs equal to the all-at-once run; refused {got['refused']}; "
          f"arrival-to-first-token s {json.dumps(ttft)}; admitted at step "
          f"{json.dumps(admitted)}; decode_tokens_per_s {got['decode_tokens_per_s']:.2f} "
          f"(all at once {want['decode_tokens_per_s']:.2f}); launches of the streamed run "
          f"{launched} in {out['decode_steps']} decode steps; phase {out['seconds']:.1f} s",
          flush=True)
    return out


def app_phase(dev, gpu: str) -> dict:
    """The paper's range-count app on the card: quickstart.main (the entry
    point a user runs) on each APP_CASES data set and range, whose four
    ways must give equal counts; the fused count of a prefix held against
    the torch_cpu library's on the host; each way timed by CUDA events
    (GiB/s of data against the 3.35 TB/s datasheet rate: Fig 10's generated
    vs hand-written, no claim) and the composed way's peak memory."""
    import torch

    from repro_torch import tsl_api
    from repro_torch.launch import quickstart

    ops = tsl_api.ops(dev)
    host_ops = tsl_api.ops("cpu")
    out = []
    for dtype, n, ranges in APP_CASES:
        data = quickstart.make_data(n, dtype, dev, seed=0)
        gib = data.numel() * data.element_size() / 2**30
        for lo, hi in ranges:
            result = quickstart.main(["--device", "cuda", "--n", str(n), "--dtype", dtype,
                                      "--low", str(lo), "--high", str(hi), "--seed", "0"])
            counts = result["counts"]
            prefix = data[:APP_CHECK_N]
            on_card = int(ops.range_count(prefix, lo, hi))
            on_host = int(host_ops.range_count(prefix.cpu(), lo, hi))
            if on_card != on_host:
                raise AssertionError(f"app {dtype} [{lo}, {hi}]: card count {on_card} of "
                                     f"the first {APP_CHECK_N} != host count {on_host}")
            if len(set(counts.values())) != 1:
                raise AssertionError(f"app {dtype} [{lo}, {hi}]: {counts}")
            times = {}
            for name, fn in quickstart.routes(ops).items():
                times[name] = cuda_ms(lambda: fn(data, lo, hi), 5)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            quickstart.composed(ops, data, lo, hi)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
            row = {"dtype": dtype, "n": n, "low": lo, "high": hi,
                   "count": counts["fused"], "counts": counts, "prefix_count": on_card,
                   "ms": times,
                   "gib_per_s": {k: gib / (t / 1e3) for k, t in times.items()},
                   "share_of_3_35_tb_s": {k: n * data.element_size() / (t / 1e3) / 3.35e12
                                          for k, t in times.items()},
                   "composed_peak_gib_beyond_data": peak}
            print(f"[app] {dtype} n={n} [{lo}, {hi}] on {gpu}: {json.dumps(row)}",
                  flush=True)
            out.append(row)
        del data
        torch.cuda.empty_cache()
    return {"cases": out}


def suite_phase(gpu: str) -> dict:
    """The h100 library generated with its tests (paper §4.1), every
    generated test function run on the card in the file's (topological)
    order. Any failure fails the phase, after all have run."""
    import warnings

    from repro_torch.core import GenConfig, generate_library, load_library

    pkg_dir, _ = generate_library(GenConfig(target="h100"))
    lib = load_library("h100")
    if Path(lib.__file__).parent != pkg_dir:
        raise AssertionError(f"loaded {lib.__file__}, generated {pkg_dir}")
    mod = importlib.import_module(lib.__name__ + ".tests.test_generated")
    names = [n for n in vars(mod) if n.startswith("test_")]     # file order
    failed = {}
    t0 = time.perf_counter()
    for name in names:
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")     # "unsafe test" warnings
                getattr(mod, name)()
        except Exception as e:  # noqa: BLE001 - counted, then raised below
            failed[name] = f"{type(e).__name__}: {e}"[:300]
    out = {"package": lib.__name__, "tests": len(names), "passed": len(names) - len(failed),
           "failed": len(failed), "seconds": time.perf_counter() - t0}
    print(f"[suite] generated h100 tests on {gpu}: {json.dumps(out)}", flush=True)
    if failed or not names:
        raise AssertionError(f"generated h100 suite: {len(failed)} of {len(names)} "
                             f"failed: {json.dumps(failed)[:3000]}")
    return out


def _host_top_functions(fn, n: int = 10, calls: int = PROFILE_STEPS) -> dict:
    """Host time by Python function over ``calls`` calls, ms per call: the
    top ``n`` by cProfile self time and by cumulative time (where a
    host-bound step spends its wall)."""
    import cProfile
    import pstats

    import torch

    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats

    def top(col):
        rows = sorted(stats.items(), key=lambda kv: -kv[1][col])[:n]
        return {f"{Path(file).name}:{line}({name}) x{v[1] / calls:g}":
                v[col] * 1e3 / calls for (file, line, name), v in rows}

    return {"self": top(2), "cumulative": top(3)}


def _profile(fn, host_top: bool = True) -> dict:
    """Host wall per call (synchronised), host time by Python function
    (``host_top``) and, from one window of PROFILE_STEPS calls under device
    tracing (CUDA activity only, read from the raw records), device busy
    time, kernels per call and top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
    busy_us = sum(e.duration_ns() for e in kernels) / 1e3
    by_name: dict[str, float] = {}       # kernel name (first 80 chars) -> us
    for e in kernels:
        name = e.name()[:80]
        by_name[name] = by_name.get(name, 0.0) + e.duration_ns() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    out = {"wall_ms": wall_ms, "launches": len(kernels) / PROFILE_STEPS}
    if host_top:
        out["host_top_functions_ms"] = _host_top_functions(fn)
    if busy_us > 0:
        out["device_busy_ms"] = busy_us / 1e3 / PROFILE_STEPS
        out["device_idle_share"] = 1.0 - out["device_busy_ms"] / wall_ms
        out["top_kernels_ms"] = {name: t / 1e3 / PROFILE_STEPS for name, t in top}
    else:
        out["device_busy_ms"] = "not measured (the profiler recorded no device time)"
    return out


def profile_phase(dev, model, params, gpu: str) -> dict:
    """Phase 4: where the time of one serving step goes, per step kind, each
    step through the engine's own code (serve/graphs.py: its input staging
    included), captured (one replay a call) and eager (disable_graphs())."""
    import numpy as np
    import torch

    from repro_torch.serve import DraftModelDrafter, StepGraphs, disable_graphs
    from repro_torch.serve.graphs import run_model_step, run_prefill_chunk

    cfg = model.cfg
    max_len = PROFILE_FILL + PROFILE_GEN          # the engine's slot-table length
    rng = np.random.default_rng(2)
    state = model.init_decode_state(PROFILE_BATCH, max_len)
    donor = model.init_decode_state(1, max_len)
    tokens = rng.integers(0, cfg.vocab, (PROFILE_BATCH, 1))
    chunk = rng.integers(0, cfg.vocab, (1, PROFILE_CHUNK))
    span = rng.integers(0, cfg.vocab, (PROFILE_BATCH, SPEC_K + 1))
    pos = np.full(PROFILE_BATCH, PROFILE_FILL, np.int64)
    start = PROFILE_FILL - PROFILE_CHUNK
    with torch.inference_mode():
        pools, tables = paged_pools(dev, model, params, PROFILE_BATCH, PROFILE_FILL,
                                    seed=6)
        tables = tables.cpu().numpy()
        q8 = int8_pools(pools)
        lane, fused, fused8 = StepGraphs(dev), StepGraphs(dev), StepGraphs(dev)
        drafter = DraftModelDrafter(cfg, cfg, batch=PROFILE_BATCH,
                                    state_len=max_len + SPEC_K, device=dev, params=params)
        steps = {
            "decode_step": ({"batch": PROFILE_BATCH, "pos": PROFILE_FILL,
                             "max_len": max_len},
                            lambda: run_model_step(lane, "decode", model, params, state,
                                                   tokens, pos)),
            "decode_step_paged": ({"batch": PROFILE_BATCH, "pos": PROFILE_FILL, "page": PAGE,
                                   "table_width": tables.shape[1]},
                                  lambda: run_model_step(fused, "decode", model, params, {},
                                                         tokens, pos, pools=pools,
                                                         tables=tables)),
            "decode_step_paged_int8": ({"batch": PROFILE_BATCH, "pos": PROFILE_FILL,
                                        "page": PAGE, "table_width": tables.shape[1],
                                        "pools": "int8 + float32 scales"},
                                       lambda: run_model_step(fused8, "decode", model, params,
                                                              {}, tokens, pos, pools=q8,
                                                              tables=tables)),
            "verify_step_paged": ({"batch": PROFILE_BATCH, "pos": PROFILE_FILL,
                                   "span": SPEC_K + 1, "page": PAGE,
                                   "table_width": tables.shape[1],
                                   # tokens a step emits when every draft is
                                   # accepted, against a decode step's
                                   "emitted_at_full_acceptance": PROFILE_BATCH * (SPEC_K + 1),
                                   "decode_emits": PROFILE_BATCH},
                                  lambda: run_model_step(fused, "verify", model, params, {},
                                                         span, pos, pools=pools,
                                                         tables=tables)),
            "prefill_chunk": ({"chunk": PROFILE_CHUNK, "pos": start},
                              lambda: run_prefill_chunk(lane, model, params, donor, chunk,
                                                        start, PROFILE_CHUNK)),
            # the draft model's step of 3e(iii): a lane decode step and the
            # greedy tokens read back to the host
            "draft_decode_step": ({"batch": PROFILE_BATCH, "pos": PROFILE_FILL,
                                   "state_len": max_len + SPEC_K},
                                  lambda: drafter._feed(tokens[:, 0], pos)),
        }
        out = {}
        for kind, (info, fn) in steps.items():
            def eager(fn=fn):
                with disable_graphs():
                    return fn()
            out[kind] = {**info, "captured": _profile(fn), "eager": _profile(eager)}
    out["jit_cache"] = {"lane": lane.sizes(("prefill_chunk", "decode")),
                        "fused": fused.sizes(("decode", "verify")),
                        "fused_int8": fused8.sizes(("decode",)),
                        "drafter": drafter.graphs.sizes(("decode",))}
    for kind, r in out.items():
        print(f"[phase4] {kind} on {gpu}: {json.dumps(r)}", flush=True)
    for kind in steps:
        c, e = out[kind]["captured"], out[kind]["eager"]
        print(f"[phase4] {kind} on {gpu}, captured vs eager: host wall {c['wall_ms']:.3f} vs "
              f"{e['wall_ms']:.3f} ms, device busy {c['device_busy_ms']} vs "
              f"{e['device_busy_ms']} ms, idle share {c.get('device_idle_share')} vs "
              f"{e.get('device_idle_share')}, kernels per step {c['launches']} vs "
              f"{e['launches']}", flush=True)
    return out


def multi_split_phase(dev, model, params, gpu: str) -> dict:
    """Phase 4b: one captured fused paged decode step at batch 1 over
    MULTI_SPLIT_FILL prefilled rows, where kernel.plan splits the keys of
    each KV head (fails if it plans one split), so the step's fixed
    workspace carries the merge. The step runs twice (the capture, then a
    replay) on one copy of the pools and once under disable_graphs() on
    another: the replay's logits must pass _require_logits against the eager
    step's, and the replay must add the paged launches its capture
    recorded."""
    import numpy as np
    import torch

    from repro_torch.kernels.common import sm_count
    from repro_torch.kernels.paged import kernel as paged_kernel
    from repro_torch.serve import StepGraphs, disable_graphs
    from repro_torch.serve.graphs import run_model_step

    cfg = model.cfg
    fill = MULTI_SPLIT_FILL
    with torch.inference_mode():
        pools, tables = paged_pools(dev, model, params, 1, fill, seed=11,
                                    max_len=fill + PAGE)
        tables = tables.cpu().numpy()
        splits, pps = paged_kernel.plan(1, cfg.n_kv_heads, tables.shape[1], PAGE,
                                        sm_count(dev))
        if splits < 2:
            raise AssertionError(f"phase 4b: kernel.plan gives {splits} split(s) at batch 1, "
                                 f"kv_len {fill + 1}, width {tables.shape[1]}")
        tokens = np.random.default_rng(12).integers(0, cfg.vocab, (1, 1))
        pos = np.full(1, fill, np.int64)
        graphs = StepGraphs(dev)
        captured = {n: t.clone() for n, t in pools.items()}
        before = read_counts()["paged_attention"]

        def step(g, p):
            return run_model_step(g, "decode", model, params, {}, tokens, pos, pools=p,
                                  tables=tables)
        step(graphs, captured)
        replayed = step(graphs, captured).clone()
        launched = read_counts()["paged_attention"] - before
        with disable_graphs():
            eager = step(StepGraphs(dev), pools)
        entry = graphs.steps["decode", 1]
    r = {"batch": 1, "kv_len": fill + 1, "table_width": int(tables.shape[1]),
         "splits": splits, "pps": pps, "replays": entry.replays,
         "launches_per_replay": entry.launches, "paged_launches": launched,
         "workspace_words": entry.workspaces["paged_attention"][0].numel(),
         **_logits_check(replayed, eager, cfg.vocab),
         "max_abs_diff_vs_eager": (replayed.float() - eager.float()).abs().max().item()}
    _require_logits("phase 4b: the captured multi-split step vs its eager twin", r)
    if entry.replays != 1 or launched != 2 * cfg.n_layers \
            or entry.launches.get("paged_attention") != cfg.n_layers:
        raise AssertionError(f"phase 4b: {entry.replays} replays, {launched} paged launches "
                             f"(recorded {entry.launches}); want 1 replay and "
                             f"{2 * cfg.n_layers} launches")
    print(f"[phase4b] captured fused paged decode step, batch 1 at kv_len {fill + 1} on "
          f"{gpu}: plan {splits} splits x {pps} entries, replay vs eager max abs diff "
          f"{r['max_abs_diff_vs_eager']:.3g}, rel L2 {r['logits_rel_l2']:.3g}; {json.dumps(r)}",
          flush=True)
    return r

# (B, H, KH, Sq, Sk, D, dtype, causal, kv_len, main)
TRAIN_FA_CASES = [
    (8, 16, 16, 512, 512, 64, "bfloat16", True, None, True),     # the train step's shape
    (2, 40, 8, 512, 512, 128, "bfloat16", True, None, False),    # GQA, qwen3-14b's heads
    (2, 16, 16, 64, 320, 64, "bfloat16", True, 300, False),      # kv_len < Sk
    (1, 8, 4, 200, 72, 64, "bfloat16", True, None, False),       # Sq > Sk: rows see no key
    (2, 16, 16, 512, 512, 64, "float32", True, None, False),
]


def train_kernel_cases(dev) -> dict[str, list[dict]]:
    """Phase 5a: the lse forward, dq and dk/dv kernels against their plain
    versions (on the plain version's lse and delta, so each kernel sees the
    same inputs as its plain version) under the card gates; each case timed
    with its bound and library yardstick."""
    import torch
    import torch.nn.functional as F

    from repro_torch import gates
    from repro_torch.kernels.flash_attention import ops as fa

    ref = fa.ref
    g = torch.Generator(device=dev).manual_seed(20)
    out = {"flash_attention_fwd_lse": [], "flash_attention_bwd_dq": [],
           "flash_attention_bwd_dkv": []}
    for b, h, kh, sq, sk, d, dt_name, causal, kv_len, main in TRAIN_FA_CASES:
        dt = getattr(torch, dt_name)
        gate = {"bfloat16": "card_bf16", "float32": "card_f32"}[dt_name]

        def rnd(*shape):
            return torch.randn(*shape, generator=g, device=dev).to(dt)

        q, k, v, do = rnd(b, h, sq, d), rnd(b, kh, sk, d), rnd(b, kh, sk, d), rnd(b, h, sq, d)
        kw = dict(causal=causal, kv_len=kv_len)
        seen = ref.visible(sq, sk, device=dev, **kw)
        no_key = ~seen.any(-1)
        pairs = int(seen.sum())                      # visible (row, key) pairs per head
        shape = [b, h, kh, sq, sk, d]
        base = {"shape": shape, "dtype": dt_name, "kv_len": kv_len, "main": main}
        itemsize = q.element_size()
        qbytes, kvbytes, rows = b * h * sq * d * itemsize, b * kh * sk * d * itemsize, b * h * sq

        o, lse = fa.flash_attention_fwd_lse(q, k, v, **kw)
        o_r, lse_r = ref.attention_fwd_lse(q, k, v, **kw)
        m = gates.check(o, o_r, gate, f"fwd_lse out {shape}")
        lse_over = gates.check_lse(lse, lse_r, no_key, f"fwd_lse lse {shape}")
        c = {**base, "rel": m["rel"], "worst_of_limit": m["worst"],
             "lse_worst_of_limit": lse_over, "rows_without_key": int(no_key.sum()),
             "max_abs_err": max((o.float() - o_r.float()).abs().max().item(),
                                (lse - lse_r).abs().max().item())}
        library = None
        if sq == sk and kv_len is None and dt == torch.bfloat16:
            ke, ve = (t.repeat_interleave(h // kh, 1) for t in (k, v))
            library = lambda: torch.ops.aten._scaled_dot_product_flash_attention(  # noqa: E731
                q, ke, ve, 0.0, causal)
        _timed_device(c, lambda: fa.flash_attention_fwd_lse(q, k, v, **kw),
                      lambda: ref.attention_fwd_lse(q, k, v, **kw), library, 10)
        if main:   # the same kernel's serving instantiation, which stores no lse
            c["serving_forward_ms"] = graph_ms(lambda: fa.flash_attention(q, k, v, **kw), 10)
        c["bound_ms"], c["bound_by"] = bound(2 * qbytes + 2 * kvbytes + 4 * rows,
                                             4 * b * h * pairs * d, dt)
        out["flash_attention_fwd_lse"].append(c)

        delta = (do.float() * o_r.float()).sum(-1)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse_r, delta, **kw)
        dq_r = ref.attention_bwd_dq(q, k, v, do, lse_r, delta, **kw)
        m = gates.check(dq, dq_r, gate, f"dq {shape}")
        if bool((dq[:, :, no_key] != 0).any()):
            raise AssertionError(f"dq {shape}: not 0 on a row that sees no key")
        c = {**base, "rel": m["rel"], "worst_of_limit": m["worst"],
             "max_abs_err": (dq.float() - dq_r.float()).abs().max().item()}
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse_r, delta, **kw)
        dk_r, dv_r = ref.attention_bwd_dkv(q, k, v, do, lse_r, delta, **kw)
        mk = gates.check(dk, dk_r, gate, f"dk {shape}")
        mv = gates.check(dv, dv_r, gate, f"dv {shape}")
        c2 = {**base, "rel": max(mk["rel"], mv["rel"]),
              "worst_of_limit": max(mk["worst"], mv["worst"]),
              "max_abs_err": max((dk - dk_r).abs().max().item(),
                                 (dv - dv_r).abs().max().item())}
        library = None
        if kv_len is None and sq == sk:
            qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
            with torch.cuda.stream(capture_stream()):   # its backward is captured there
                o_lib = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                                       enable_gqa=h != kh)
            torch.cuda.current_stream().wait_stream(capture_stream())
            library = lambda: torch.autograd.grad(o_lib, (qs, ks, vs), do,  # noqa: E731
                                                  retain_graph=True)
        _timed_device(c, lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse_r, delta, **kw),
                      lambda: ref.attention_bwd_dq(q, k, v, do, lse_r, delta, **kw), library,
                      10)
        _timed_device(c2, lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse_r, delta, **kw),
                      lambda: ref.attention_bwd_dkv(q, k, v, do, lse_r, delta, **kw), None, 10)
        c2["library_ms"], c2["library_events_ms"] = c["library_ms"], c["library_events_ms"]
        if library is not None:
            c["note"] = c2["note"] = ("library: SDPA's whole backward (dq, dk and dv), "
                                      "beside dq + dk/dv")
        # bytes: q, k, v, dO once, lse and delta; dq out (dq) / f32 dk, dv per
        # query head out (dk/dv). ops: 2 flops per MAC of S = QK^T and
        # dP = dO V^T, then dq = dS K (dq) / dv = P^T dO and dk = dS^T Q (dk/dv)
        c["bound_ms"], c["bound_by"] = bound(3 * qbytes + 2 * kvbytes + 8 * rows,
                                             6 * b * h * pairs * d, dt)
        c2["bound_ms"], c2["bound_by"] = bound(
            2 * qbytes + 2 * kvbytes + 8 * rows + 2 * b * h * sk * d * 4,
            8 * b * h * pairs * d, dt)
        out["flash_attention_bwd_dq"].append(c)
        out["flash_attention_bwd_dkv"].append(c2)
        for name, cs in out.items():
            x = cs[-1]
            lib = "—" if x["library_ms"] is None else f"{x['library_ms']:.4f} ms"
            print(f"[phase5a] {name} {shape} {dt_name} kv_len {kv_len}: rel {x['rel']:.3g} "
                  f"worst {x['worst_of_limit']:.3g} of the {gate} limit, max abs err "
                  f"{x['max_abs_err']:.3g}; kernel {x['ms']:.4f} ms plain "
                  f"{x['plain_ms']:.4f} ms library {lib} bound {x['bound_ms']:.4f} ms "
                  f"({x['bound_by']})" + (f"; serving instantiation (no lse) "
                                          f"{x['serving_forward_ms']:.4f} ms"
                                          if "serving_forward_ms" in x else "")
                  + f"; events: kernel {x['events_ms']:.4f} ms; host enqueue "
                    f"{x['host_us']:.1f} us; device times by {x['timing']}", flush=True)
        del q, k, v, do, o, o_r, dq, dq_r, dk, dk_r, dv, dv_r
    out["plain_backward_ms"] = plain_backward_ms(dev)
    return out


def plain_backward_ms(dev) -> dict:
    """The backward of rmsnorm and swiglu at the train step's shapes (8 x 512
    rows of d_model 1024 and d_ff 2816, bf16): plain torch (autograd through
    the plain version recomputed from the saved inputs) behind the Triton
    forward, as the train step runs them."""
    import torch

    from repro_torch.kernels.rmsnorm import ops as rn
    from repro_torch.kernels.swiglu import ops as sw

    g = torch.Generator(device=dev).manual_seed(22)
    rows = TRAIN_BATCH * TRAIN_SEQ

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16).requires_grad_()

    out = {}
    for name, fn, args in (("rmsnorm", rn.rmsnorm, (rnd(rows, 1024), rnd(1024))),
                           ("swiglu", sw.swiglu, (rnd(rows, 2816), rnd(rows, 2816)))):
        y = fn(*args)
        gy = torch.randn(y.shape, generator=g, device=dev).to(y.dtype)
        out[name] = {"shape": list(args[0].shape),
                     "ms": cuda_ms(lambda: torch.autograd.grad(y, args, gy, retain_graph=True),
                                   20)}
    print(f"[phase5a] plain-torch backward behind the Triton forward: {json.dumps(out)}",
          flush=True)
    return out


def _train_batch(dev, vocab: int) -> dict:
    import torch

    g = torch.Generator(device=dev).manual_seed(21)
    seq = torch.randint(0, vocab, (TRAIN_BATCH, TRAIN_SEQ + 1), generator=g, device=dev)
    return {"tokens": seq[:, :-1].contiguous(), "labels": seq[:, 1:].contiguous()}


def _step_profile(fn) -> tuple[object, dict]:
    """Run ``fn`` once under torch.profiler, tracing the device only (no
    host op records, which would slow the host): its result, the
    synchronised wall ms of that run, the device busy ms in it and their
    ratio, and device time by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    return result, {"wall_ms_profiled": wall_ms, "device_busy_ms": busy,
                    "device_busy_share": busy / wall_ms, "launches": len(kernels),
                    "by_kernel_ms": by_name}     # busy 0: the profiler saw no device


def train_phase(dev, gpu: str) -> dict:
    """Phase 5: the training kernels (5a), full-width gradients through the
    kernels vs the plain versions (5b), and 5 AdamW steps both ways (5c)."""
    import torch

    from repro_torch import gates
    from repro_torch.configs import get_config
    from repro_torch.nn.model import build_model
    from repro_torch.train import (OptConfig, init_opt_state, init_train_state,
                                   loss_and_grads, make_train_step)
    from repro_torch.train.optimizer import tree_items, tree_map

    t_phase = time.perf_counter()
    cases = train_kernel_cases(dev)

    cfg = get_config(ARCH)
    model = build_model(cfg, device=dev)
    plain = build_model(cfg, device=dev, target="torch_cpu")
    assert model.lib.TARGET_NAME == "h100" and plain.lib.TARGET_NAME == "torch_cpu"
    opt_cfg = OptConfig(**TRAIN_OPT)
    state = init_train_state(model, opt_cfg, seed=0)
    batch = _train_batch(dev, cfg.vocab)

    # 5b: one batch, loss and every gradient both ways
    loss_k, _, grads_k = loss_and_grads(model, state["params"], batch)
    loss_p, _, grads_p = loss_and_grads(plain, state["params"], batch)
    grads = {"loss_kernels": loss_k.item(), "loss_plain": loss_p.item(), "leaves": {}}
    if abs(grads["loss_kernels"] - grads["loss_plain"]) > gates.LOSS_REL * grads["loss_plain"]:
        raise AssertionError(f"full-width loss: kernels {grads['loss_kernels']} vs plain "
                             f"{grads['loss_plain']}")
    plain_grads, kernel_grads = dict(tree_items(grads_p)), dict(tree_items(grads_k))
    for name, gk in kernel_grads.items():
        gp = plain_grads[name]
        if not bool((gk != 0).any()) or not bool((gp != 0).any()):
            raise AssertionError(f"full-width grad {name}: all zeros (kernels "
                                 f"{bool((gk != 0).any())}, plain {bool((gp != 0).any())})")
        grads["leaves"][name] = gates.check(gk, gp, "full_width_bf16", f"grad {name}")["rel"]
    # the same with float32 params (gate full_width_f32): no bf16 rounding
    # carried through 24 layers to hide a fault in the kernels or their glue
    f32_cfg = cfg.replace(dtype="float32")
    f32_kernels = build_model(f32_cfg, device=dev)
    f32_plain = build_model(f32_cfg, device=dev, target="torch_cpu")
    params_f32 = tree_map(lambda t: t.float(), state["params"])
    loss_f, _, grads_f = loss_and_grads(f32_plain, params_f32, batch)
    loss_fk, _, grads_fk = loss_and_grads(f32_kernels, params_f32, batch)
    grads.update(loss_f32_plain=loss_f.item(), loss_f32_kernels=loss_fk.item(),
                 leaves_f32={})
    if abs(loss_fk.item() - loss_f.item()) > gates.LOSS_REL_F32 * abs(loss_f.item()):
        raise AssertionError(f"full-width float32 loss: kernels {loss_fk.item()} vs plain "
                             f"{loss_f.item()}")
    f32_plain_grads = dict(tree_items(grads_f))
    for name, gk in tree_items(grads_fk):
        if not bool((gk != 0).any()):
            raise AssertionError(f"full-width float32 grad {name}: all zeros (kernels)")
        grads["leaves_f32"][name] = gates.check(gk, f32_plain_grads[name], "full_width_f32",
                                                f"float32 grad {name}")["rel"]
    # information: how far each bf16 path is from the float32 plain path on
    # the same params (the bf16 rounding both paths carry)
    grads["vs_f32"] = {
        name: {path: gates.measure(g, gf, "full_width_bf16")["rel"]
               for path, g in (("kernels", kernel_grads[name]), ("plain", plain_grads[name]))}
        for name, gf in f32_plain_grads.items()}
    del grads_k, grads_p, plain_grads, kernel_grads, grads_f, grads_fk, f32_plain_grads, \
        params_f32
    worst_leaf = max(grads["leaves"], key=grads["leaves"].get)
    worst_f32 = max(grads["leaves_f32"], key=grads["leaves_f32"].get)
    print(f"[phase5b] {ARCH} loss kernels {grads['loss_kernels']:.6f} plain "
          f"{grads['loss_plain']:.6f}; float32 kernels {grads['loss_f32_kernels']:.8f} plain "
          f"{grads['loss_f32_plain']:.8f}; grad rel L2 per leaf, kernels vs plain, bf16 "
          f"(gate 5e-2): {json.dumps(grads['leaves'])}; worst {worst_leaf}; float32 (gate "
          f"1e-4): {json.dumps(grads['leaves_f32'])}; worst {worst_f32}; each bf16 path vs "
          f"float32 plain (information): {json.dumps(grads['vs_f32'])}", flush=True)

    # 5c: 5 AdamW steps through the kernels (counted), then through the plain versions
    for fn in counters().values():
        fn.launches = 0
    step = make_train_step(model, opt_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    steps, s = [], state
    for i in range(TRAIN_STEPS):
        if i == TRAIN_STEPS - 1:           # one profiled step: where the device time goes
            (s, metrics), prof = _step_profile(lambda: step(s, batch))
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s, metrics = step(s, batch)
            torch.cuda.synchronize()
            prof = {"wall_ms": (time.perf_counter() - t0) * 1e3}
        steps.append({"loss": metrics["loss"].item(), "grad_norm": metrics["grad_norm"].item(),
                      "lr": metrics["lr"], **prof})
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    launched = read_counts()
    per_step = {k: n / TRAIN_STEPS for k, n in launched.items()}
    want = {"flash_attention_fwd_lse": 2 * cfg.n_layers, "flash_attention_bwd_dq": cfg.n_layers,
            "flash_attention_bwd_dkv": cfg.n_layers, "rmsnorm": 4 * cfg.n_layers + 1,
            "swiglu": 2 * cfg.n_layers}
    bad = {k: per_step[k] for k, n in want.items() if per_step[k] != n}
    if bad:
        raise AssertionError(f"launches per train step {bad}, want {want}")
    losses = [x["loss"] for x in steps]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses {losses}: not finite, or not falling")
    del s
    s = state
    plain_step = make_train_step(plain, opt_cfg)
    plain_losses = []
    for _ in range(TRAIN_STEPS):
        s, metrics = plain_step(s, batch)
        plain_losses.append(metrics["loss"].item())
    for i, (a, p) in enumerate(zip(losses, plain_losses)):
        if abs(a - p) > gates.LOSS_REL * abs(p):
            raise AssertionError(f"train step {i + 1}: loss kernels {a} vs plain {p}")
    # the same 5 steps with float32 params, both ways (LOSS_REL_F32)
    params_f32 = tree_map(lambda t: t.float(), state["params"])
    del s, state
    curves_f32 = {}
    for name, m in (("kernels", f32_kernels), ("plain", f32_plain)):
        s = {"params": params_f32, "opt": init_opt_state(opt_cfg, params_f32)}
        f32_step, curves_f32[name] = make_train_step(m, opt_cfg), []
        for _ in range(TRAIN_STEPS):
            s, metrics = f32_step(s, batch)
            curves_f32[name].append(metrics["loss"].item())
    del s, params_f32
    for i, (a, p) in enumerate(zip(curves_f32["kernels"], curves_f32["plain"])):
        if abs(a - p) > gates.LOSS_REL_F32 * abs(p):
            raise AssertionError(f"float32 train step {i + 1}: loss kernels {a} vs plain {p}")

    # where the profiled step's device time goes
    prof = steps[-1]
    by = prof.pop("by_kernel_ms")
    # the flash keys match both paths' kernel names (the bf16 *_mma_kernel and
    # the float32 *_kernel); which names each key took is kept beside it
    share = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0, "gemm": 0.0}
    matched: dict[str, list] = {k: [] for k in share}
    for name, ms in by.items():
        low = name.lower()
        key = next((k for k in share if k + "_" in name), None)
        if key is None and any(t in low for t in ("gemm", "cutlass", "xmma", "cublas",
                                                  "nvjet")):
            key = "gemm"
        if key is not None:
            share[key] += ms
            matched[key].append(name[:100])
    busy = prof["device_busy_ms"]
    if busy > 0 and not all(share[k] > 0 for k in ("flash_fwd", "flash_bwd_dq",
                                                   "flash_bwd_dkv")):
        raise AssertionError(f"the traced step shows no time for a flash kernel that "
                             f"launched in it: {share}; kernels {sorted(by)[:40]}")
    logits = torch.randn(TRAIN_BATCH * TRAIN_SEQ, cfg.padded_vocab, device=dev,
                         dtype=torch.bfloat16, requires_grad=True)
    labels = batch["labels"].reshape(-1)

    def xent():
        loss = model.tsl.cross_entropy(logits, labels).mean()
        torch.autograd.grad(loss, logits)

    where = {"top_kernels_ms": dict(sorted(by.items(), key=lambda kv: -kv[1])[:12]),
             "share_of_busy": ({k: v / busy for k, v in share.items()} if busy > 0 else
                               "not measured (the profiler recorded no device time)"),
             "ms": share, "kernels_matched": matched,
             "cross_entropy_fwd_bwd_ms": cuda_ms(xent, 5)}
    if busy > 0:
        where["cross_entropy_share_of_busy"] = where["cross_entropy_fwd_bwd_ms"] / busy
    del logits
    out = {"kernel_cases": cases, "grads": grads, "steps": steps, "plain_losses": plain_losses,
           "losses_f32": curves_f32, "peak_gib": peak_gib, "launches": launched,
           "launches_per_step": per_step, "where": where, "seconds": time.perf_counter() - t_phase}
    print(f"[phase5c] {ARCH} train {TRAIN_BATCH}x{TRAIN_SEQ} bf16 AdamW {TRAIN_OPT} on {gpu}: "
          f"steps {json.dumps(steps)}; plain losses {plain_losses}; float32 losses "
          f"{json.dumps(curves_f32)}; peak "
          f"{peak_gib:.2f} GiB; launches per step {per_step}; where the profiled step's "
          f"device time goes {json.dumps(where)}; phase {out['seconds']:.1f} s", flush=True)
    return out


def train_launches_want(cfg, microbatches: int = 1) -> dict:
    """Kernel launches of one train step (remat: the forward twice)."""
    L = cfg.n_layers
    return {k: microbatches * n for k, n in (
        ("flash_attention_fwd_lse", 2 * L), ("flash_attention_bwd_dq", L),
        ("flash_attention_bwd_dkv", L), ("rmsnorm", 4 * L + 1), ("swiglu", 2 * L))}


def _clone_state(state: dict) -> dict:
    import torch

    from repro_torch.train.optimizer import tree_map

    opt = state["opt"]
    return {"params": tree_map(torch.clone, state["params"]),
            "opt": {"m": tree_map(torch.clone, opt["m"]), "v": tree_map(torch.clone, opt["v"]),
                    "count": opt["count"]}}


def _run_steps(dev, fn, state, batches) -> tuple[dict, dict]:
    """len(batches) steps of ``fn`` (the launch counters set to 0 just
    before and read just after): the last state and the run's record, each
    step's metrics (host floats) and host wall (synchronised), and peak
    memory, absolute and above what was allocated (reserved) when the run
    began, the allocator's cache emptied; the last step runs under device
    tracing (``traced``)."""
    import torch

    for c in counters().values():
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)
    steps = []
    for i, b in enumerate(batches):
        if i == len(batches) - 1:
            (state, m), rec = traced(lambda s=state, b=b: fn(s, b))
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = fn(state, b)
            torch.cuda.synchronize()
            rec = {"host_wall_s": time.perf_counter() - t0}
        steps.append({**{k: (v if isinstance(v, float) else v.item()) for k, v in m.items()},
                      **rec})
    peak = torch.cuda.max_memory_allocated(dev), torch.cuda.max_memory_reserved(dev)
    return state, {"steps": steps, "launches": read_counts(),
                   "peak_allocated_gib": peak[0] / 2**30, "peak_reserved_gib": peak[1] / 2**30,
                   "peak_allocated_above_start_gib": (peak[0] - start[0]) / 2**30,
                   "peak_reserved_above_start_gib": (peak[1] - start[1]) / 2**30}


def _tensor_leaves(state: dict) -> list:
    from repro_torch.train.optimizer import tree_items

    return tree_items({"params": state["params"], "m": state["opt"]["m"],
                       "v": state["opt"]["v"]})


def compiled_train_phase(dev, gpu: str) -> dict:
    """Phase 5d: compile_train_step (one CUDA graph over the donated state)
    against the eager step under disable_graphs(), from clones of one state
    on the same SyntheticTokens batches, in four configurations: every
    metric at every step and every param and moment leaf at the end equal
    bit for bit, the same launches per step; host wall, device busy and
    idle share, kernels per step, capture seconds and peak memory of each."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.graphs import disable_graphs
    from repro_torch.nn.model import build_model
    from repro_torch.train import (OptConfig, compile_train_step, init_train_state,
                                   make_train_step)

    t_phase = time.perf_counter()
    cfg = get_config(ARCH)
    model = build_model(cfg, device=dev)
    source = SyntheticTokens(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=5)
    out: dict = {"gpu": gpu, "opt": GRAPH_TRAIN_OPT, "cases": {}}
    failures = []
    for name, (opt_kw, step_kw, n) in GRAPH_TRAIN_CASES.items():
        opt_cfg = OptConfig(**GRAPH_TRAIN_OPT, **opt_kw)
        step = make_train_step(model, opt_cfg, **step_kw)
        init = init_train_state(model, opt_cfg, seed=0)
        host = [source.batch_at(i) for i in range(n)]
        on_card = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()} for b in host]

        def eager(s, b):
            with disable_graphs():
                return step(s, b)

        e_state, e_run = _run_steps(dev, eager, init, on_card)
        compiled = compile_train_step(step)
        t0 = time.perf_counter()
        c_state, c_run = _run_steps(dev, compiled, _clone_state(init), host)
        c_run["first_call_s"] = c_run["steps"][0]["host_wall_s"]
        c_run["capture_s"] = compiled.step.capture_s
        c_run["entries"] = compiled.entries
        c_run["run_s"] = time.perf_counter() - t0
        want = train_launches_want(cfg, step_kw.get("microbatches", 1))
        for run, tag in ((c_run, "captured"), (e_run, "eager")):
            got = {k: run["launches"][k] / n for k in want}
            run["launches_per_step"] = got
            if got != want:
                failures.append(f"{name} {tag}: launches per step {got}, want {want}")
            untimed = run["steps"][1:-1] if tag == "captured" else run["steps"][:-1]
            run["host_wall_ms"] = [x["host_wall_s"] * 1e3 for x in untimed]
            last = run["steps"][-1]
            run["traced_step"] = {"host_wall_ms": last["host_wall_s"] * 1e3,
                                  "device_busy_ms": last["device_busy_s"] * 1e3,
                                  "device_idle_share": last["device_idle_share"],
                                  "device_records": last["device_records"]}
        differ = [f"step {i + 1} {k}: captured {c[k]!r} eager {e[k]!r}"
                  for i, (c, e) in enumerate(zip(c_run["steps"], e_run["steps"]))
                  for k in e if k not in ("host_wall_s", "device_busy_s",
                                          "device_idle_share", "device_records")
                  and c[k] != e[k]]
        leaves = list(zip(_tensor_leaves(c_state), _tensor_leaves(e_state)))
        differ += [f"leaf {p}: max |captured - eager| "
                   f"{(a.double() - b.double()).abs().max().item()!r}"
                   for (p, a), (_, b) in leaves if not torch.equal(a, b)]
        lrs = [x["lr"] for x in e_run["steps"]]
        if len(set(lrs)) != n:
            differ.append(f"lr does not change every step: {lrs}")
        if not all(math.isfinite(x["loss"]) for x in e_run["steps"]):
            differ.append("a loss is not finite")
        if compiled.entries != 1 or compiled.step.replays != n - 1:
            differ.append(f"entries {compiled.entries}, replays {compiled.step.replays}")
        failures += [f"{name}: {d}" for d in differ]
        rec = {"steps": n, "bit_equal": not differ, "leaves_compared": len(leaves),
               "differences": differ[:20], "losses": [x["loss"] for x in e_run["steps"]],
               "lr": lrs, "captured": c_run, "eager": e_run}
        out["cases"][name] = rec
        c, e = c_run, e_run
        print(f"[phase5d] {name} ({n} steps, {TRAIN_BATCH}x{TRAIN_SEQ}) on {gpu}, captured vs "
              f"eager: host wall {json.dumps(c['host_wall_ms'])} vs "
              f"{json.dumps(e['host_wall_ms'])} ms a step; traced step host wall "
              f"{c['traced_step']['host_wall_ms']:.2f} vs {e['traced_step']['host_wall_ms']:.2f}"
              f" ms, device busy {c['traced_step']['device_busy_ms']:.2f} vs "
              f"{e['traced_step']['device_busy_ms']:.2f} ms, idle share "
              f"{c['traced_step']['device_idle_share']:.4f} vs "
              f"{e['traced_step']['device_idle_share']:.4f}, device records "
              f"{c['traced_step']['device_records']} vs {e['traced_step']['device_records']}; "
              f"kernels per step {json.dumps(c['launches_per_step'])} vs "
              f"{json.dumps(e['launches_per_step'])}; first call {c['first_call_s']:.3f} s "
              f"(capture {c['capture_s']:.3f} s); peak allocated "
              f"{c['peak_allocated_gib']:.2f} vs {e['peak_allocated_gib']:.2f} GiB "
              f"({c['peak_allocated_above_start_gib']:.2f} vs "
              f"{e['peak_allocated_above_start_gib']:.2f} above the run's start), reserved "
              f"{c['peak_reserved_gib']:.2f} vs {e['peak_reserved_gib']:.2f} GiB "
              f"({c['peak_reserved_above_start_gib']:.2f} vs "
              f"{e['peak_reserved_above_start_gib']:.2f}); losses "
              f"{rec['losses']}; bit-equal {rec['bit_equal']} ({len(leaves)} leaves)"
              + (f"; differences {differ[:20]}" if differ else ""), flush=True)
        del compiled, c_state, e_state, init, on_card, step
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[phase5d] compiled train step vs eager, {len(GRAPH_TRAIN_CASES)} configurations "
          f"on {gpu}: {json.dumps({k: v['bit_equal'] for k, v in out['cases'].items()})}; "
          f"phase {out['seconds']:.1f} s", flush=True)
    if failures:
        raise AssertionError(f"phase 5d: {failures}")
    return out


class _Tee(io.TextIOBase):
    """Writes to ``out`` and keeps a copy (the train CLI's log lines)."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, text: str) -> int:
        self.out.write(text)
        return self.buf.write(text)

    def flush(self):
        self.out.flush()


def run_train_cli(args: list[str]) -> tuple[dict, dict, str, dict]:
    """repro_torch.launch.train.main(args) with the launch counters set to 0
    just before and read just after: (result, {0-based step: loss} from the
    log lines, the log, the launches)."""
    import gc

    import torch

    from repro_torch.launch import train as train_cli

    for fn in counters().values():
        fn.launches = 0
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        result = train_cli.main(args)
    launched = read_counts()
    gc.collect()                  # the run's compiled step and its graph pool go
    torch.cuda.empty_cache()
    log = tee.buf.getvalue()
    losses = {int(s): float(v) for s, v in
              re.findall(r"^\[train\] step (\d+) loss=(\S+)", log, re.MULTILINE)}
    return result, losses, log, launched


def _all_finite(name: str, losses) -> None:
    if not losses or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: losses {losses} are not all finite")


def train_cli_phase(dev, gpu: str) -> dict:
    """Phase 6: the train CLI at full width. 6a int8 moments, two
    microbatches, checkpoints and a restart, against an uninterrupted run;
    6b gradient compression against none; 6c the int8 / microbatch step
    through the kernels against the plain versions."""
    import torch

    from repro_torch import gates
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.graphs import disable_graphs
    from repro_torch.nn.model import build_model
    from repro_torch.train import OptConfig, init_train_state, loss_and_grads, make_train_step
    from repro_torch.train.optimizer import tree_leaves

    t_phase = time.perf_counter()
    cfg = get_config(ARCH)
    L = cfg.n_layers
    want = {"flash_attention_fwd_lse": 2 * 2 * L, "flash_attention_bwd_dq": 2 * L,
            "flash_attention_bwd_dkv": 2 * L, "rmsnorm": 2 * (4 * L + 1), "swiglu": 2 * 2 * L}

    def per_step(name, launched, steps):
        got = {k: launched[k] / steps for k in want}
        if got != want:
            raise AssertionError(f"{name}: launches per step {got}, want {want} (twice "
                                 f"phase 5c's: two microbatches)")
        return got

    # 6a: 6 steps with checkpoints every 3, a restart to 9, and 9 uninterrupted
    out: dict = {"gpu": gpu}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = ["--ckpt-dir", tmp, "--ckpt-every", str(CLI_CKPT_EVERY)]
        first, losses1, _, launched1 = run_train_cli(
            CLI_ARGS + CLI_INT8 + ckpt + ["--steps", str(CLI_STEPS)])
        second, losses2, log2, launched2 = run_train_cli(
            CLI_ARGS + CLI_INT8 + ckpt + ["--steps", str(CLI_RESTART_STEPS)])
        if f"restored checkpoint at step {CLI_STEPS}" not in log2:
            raise AssertionError(f"the restart did not restore step {CLI_STEPS}")
        root = Path(tmp)
        committed = sorted(int(p.name.split("_")[1]) for p in root.glob("step_*")
                           if (p / "manifest.json").exists())
        if committed != [3, 6, 9]:
            raise AssertionError(f"committed checkpoints {committed}, want [3, 6, 9]")
        manifest = json.loads((root / "step_9" / "manifest.json").read_text())
        if manifest["extra"]["data"]["step"] != CLI_RESTART_STEPS:
            raise AssertionError(f"step_9's data state {manifest['extra']}")
        # the optimizer state's bytes, int8 (q + scale) against float32 moments
        size = {"int8": 1, "float32": 4, "bfloat16": 2, "int32": 4}
        nbytes = {"moments": 0, "param_elems": 0}
        for path, shape, dt in zip(manifest["structure"], manifest["shapes"],
                                   manifest["dtypes"]):
            n = math.prod(shape)
            if path.startswith(("opt/m/", "opt/v/")):
                nbytes["moments"] += n * size[dt]
            elif path.startswith("params/"):
                nbytes["param_elems"] += n
        share = nbytes["moments"] / (2 * 4 * nbytes["param_elems"])
        if share > INT8_STATE_SHARE:
            raise AssertionError(f"int8 optimizer state is {share:.4f} of float32 "
                                 f"moments' bytes, want <= {INT8_STATE_SHARE}")
    whole, losses3, _, launched3 = run_train_cli(
        CLI_ARGS + CLI_INT8 + ["--steps", str(CLI_RESTART_STEPS)])
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    # the eager twin of the uninterrupted run, in the same call
    with disable_graphs():
        twin, losses3e, _, launched3e = run_train_cli(
            CLI_ARGS + CLI_INT8 + ["--steps", str(CLI_RESTART_STEPS)])
    if losses3e != losses3 or (twin["first_loss"], twin["final_loss"]) != (
            whole["first_loss"], whole["final_loss"]):
        raise AssertionError(f"6a: the compiled run's losses {losses3} (final "
                             f"{whole['final_loss']!r}) differ from its eager twin's "
                             f"{losses3e} (final {twin['final_loss']!r})")
    _all_finite("6a", list(losses1.values()) + list(losses2.values())
                + list(losses3.values()))
    if sorted(losses2) != list(range(CLI_STEPS, CLI_RESTART_STEPS)):
        raise AssertionError(f"the restarted run logged steps {sorted(losses2)}")
    diffs = {s: abs(losses2[s] - losses3[s]) for s in losses2}
    for s, d in diffs.items():
        if d > gates.LOSS_REL * abs(losses3[s]):
            raise AssertionError(f"step {s + 1}: restarted loss {losses2[s]} vs "
                                 f"uninterrupted {losses3[s]}")
    for name, launched, steps in (("6a run", launched1, CLI_STEPS),
                                  ("6a restart", launched2, CLI_RESTART_STEPS - CLI_STEPS),
                                  ("6a uninterrupted", launched3, CLI_RESTART_STEPS),
                                  ("6a eager twin", launched3e, CLI_RESTART_STEPS)):
        out.setdefault("launches_per_step", {})[name] = per_step(name, launched, steps)
    out["launches"] = launched3
    out["6a"] = {"losses_first": losses1, "losses_restart": losses2,
                 "losses_uninterrupted": losses3, "restart_max_abs_diff_logged": max(
                     diffs.values()),
                 "final_loss_diff": abs(second["final_loss"] - whole["final_loss"]),
                 "tokens_per_s": {"run": first["tokens_per_s"],
                                  "restart": second["tokens_per_s"],
                                  "uninterrupted": whole["tokens_per_s"],
                                  "uninterrupted_eager_twin": twin["tokens_per_s"]},
                 "losses_eager_twin": losses3e,
                 "final_loss": {"compiled": whole["final_loss"], "eager": twin["final_loss"]},
                 "ckpt_save_s": {"run": first["ckpt_save_s"],
                                 "restart": second["ckpt_save_s"]},
                 "peak_gib": peak_gib, "int8_state_share": share}
    print(f"[phase6a] train CLI {ARCH} {TRAIN_BATCH}x{TRAIN_SEQ} int8 moments, 2 "
          f"microbatches, restart at {CLI_STEPS} of {CLI_RESTART_STEPS} on {gpu}: "
          f"{json.dumps(out['6a'])}; launches per step {json.dumps(out['launches_per_step'])}",
          flush=True)

    # 6b: compression against none, float32 moments, one microbatch
    steps = ["--steps", str(CLI_COMPRESS_STEPS)]
    comp, losses_c, _, _ = run_train_cli(CLI_ARGS + steps + ["--compress-grads"])
    plain_run, losses_n, _, _ = run_train_cli(CLI_ARGS + steps)
    _all_finite("6b", list(losses_c.values()) + list(losses_n.values()))
    for s in losses_n:
        if abs(losses_c[s] - losses_n[s]) > gates.LOSS_REL * abs(losses_n[s]):
            raise AssertionError(f"step {s + 1}: compressed loss {losses_c[s]} vs "
                                 f"uncompressed {losses_n[s]}")
    model = build_model(cfg, device=dev)
    opt_cfg = OptConfig(total_steps=10, warmup_steps=2)
    state = init_train_state(model, opt_cfg, seed=0)
    batch0 = {k: torch.from_numpy(v).to(dev) for k, v in
              SyntheticTokens(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=0).batch_at(0).items()}
    _, metrics = make_train_step(model, opt_cfg, compress_grads=True)(state, batch0)
    gmax = max(g.abs().max().item() for g in tree_leaves(
        loss_and_grads(model, state["params"], batch0)[2]))
    err, limit = metrics["compress_err"].item(), gmax * (1 / 254 + 2.0 ** -8)
    if not 0 < err <= limit:
        raise AssertionError(f"compress_err {err}: want in (0, {limit}] (max|g| {gmax})")
    out["6b"] = {"losses_compressed": losses_c, "losses_uncompressed": losses_n,
                 "max_rel_diff": max(abs(losses_c[s] - losses_n[s]) / abs(losses_n[s])
                                     for s in losses_n),
                 "compress_err": err, "compress_err_limit": limit, "max_abs_grad": gmax,
                 "tokens_per_s": {"compressed": comp["tokens_per_s"],
                                  "uncompressed": plain_run["tokens_per_s"]}}
    print(f"[phase6b] train CLI {ARCH} --compress-grads vs none, {CLI_COMPRESS_STEPS} "
          f"steps on {gpu}: {json.dumps(out['6b'])}", flush=True)
    del state

    # 6c: the int8 / two-microbatch step through the kernels and the plain
    # versions, each step from the same state (the kernels' trajectory): with
    # int8 moments the loss diverges from the third step at this vocabulary,
    # in the reference's arithmetic too (tests/test_torch_train_rest.py), so
    # two trajectories would compare the divergence's amplification of bf16
    # rounding, not the kernels
    plain = build_model(cfg, device=dev, target="torch_cpu")
    assert model.lib.TARGET_NAME == "h100" and plain.lib.TARGET_NAME == "torch_cpu"
    opt_cfg = OptConfig(moment_dtype="int8", warmup_steps=0)
    source = SyntheticTokens(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in source.batch_at(i).items()}
               for i in range(3)]
    k_step = make_train_step(model, opt_cfg, microbatches=2)
    p_step = make_train_step(plain, opt_cfg, microbatches=2)
    curves = {"kernels": [], "plain": [], "grad_norm_kernels": [], "grad_norm_plain": []}
    s = init_train_state(model, opt_cfg, seed=0)
    for b in batches:
        # both steps eager and functional (no donation): s serves both
        _, pm = p_step(s, b)
        s, km = k_step(s, b)
        for name, m in (("kernels", km), ("plain", pm)):
            curves[name].append(m["loss"].item())
            curves["grad_norm_" + name].append(m["grad_norm"].item())
    del s
    _all_finite("6c", curves["kernels"] + curves["plain"])
    for i, (a, p) in enumerate(zip(curves["kernels"], curves["plain"])):
        if abs(a - p) > gates.LOSS_REL * abs(p):
            raise AssertionError(f"6c step {i + 1}: loss kernels {a} vs plain {p}")
    # |d ||g||| <= ||d g||: the grads' full_width_bf16 rel bound holds for the norm
    rel_gn = gates.GATES["full_width_bf16"][0]
    for i, (a, p) in enumerate(zip(curves["grad_norm_kernels"], curves["grad_norm_plain"])):
        if abs(a - p) > rel_gn * abs(p):
            raise AssertionError(f"6c step {i + 1}: grad_norm kernels {a} vs plain {p}")
    out["6c"] = curves
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[phase6c] int8 moments, 2 microbatches, kernels vs plain from the same state "
          f"each step on {gpu}: "
          f"{json.dumps(curves)}; phase 6 {out['seconds']:.1f} s", flush=True)
    return out


def rwkv_launch_check(cfg, launched, report, *, verify_steps: int = 0) -> list:
    """The problems of one rwkv serve's launch counts: rmsnorm (ln_x, once a
    layer a step) exactly n_layers per decode step, per prefill chunk and,
    with speculation, twice per verify step (the verify span and its
    commit replay); swiglu, flash and paged attention never."""
    chunks = sum(e["chunks"] for e in report["step_log"])
    decode = sum(e["decoded"] > 0 for e in report["step_log"]) - verify_steps
    want = cfg.n_layers * (decode + chunks + 2 * verify_steps)
    problems = []
    if launched["rmsnorm"] != want:
        problems.append(f"rmsnorm launched {launched['rmsnorm']} times, want {want} "
                        f"({cfg.n_layers} x ({decode} decode steps + {chunks} prefill "
                        f"chunks + 2 x {verify_steps} verify steps))")
    for name in ("swiglu", "flash_attention", "paged_attention"):
        if launched[name]:
            problems.append(f"{name} launched {launched[name]} times on rwkv")
    return problems


def rwkv_requests(vocab: int, request_cls) -> list:
    """Phase 7b: phase 3's requests (the serve CLI's: RWKV_SERVE_REQUESTS of
    RWKV_PROMPT seeded tokens, RWKV_GEN generated)."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [request_cls(rid=f"req{i}", tokens=rng.integers(0, vocab, RWKV_PROMPT)
                        .astype(np.int32), gen_len=RWKV_GEN)
            for i in range(RWKV_SERVE_REQUESTS)]


def rwkv_layers_phase(dev, model, params, gpu: str) -> dict:
    """Phase 7a: the layers against their plain versions on the card.

    The h100 library's wkv6_scan (the chunked form) against the torch_cpu
    library's time-step scan, float32, at RWKV_PREFILL x (64, 64) with
    decays from layer 0's _decay on seeded activations: the largest error
    relative to max |y| and to max |s| must be within WKV_REL_TOL.

    Then the model on the h100 library against the model on torch_cpu,
    sharing the params. In float32 (a float32 copy of the params): one
    prefill of RWKV_PREFILL tokens and DECODE_STEPS greedy decode steps
    after it, each model on its own state (the h100 model's tokens fed to
    both), every logits row under _require_logits at RWKV_F32_REL_L2. In
    bf16 each decode step starts both models from the same state (the h100
    model's, copied), every row under _require_logits at LOGITS_REL_L2. A
    bf16 prefill of 256 tokens is not compared under a bound: the decay is
    cast to bf16 before the scan, as in the reference, where
    exp(-exp(-6)) lies between 0.99609 and 1.0, so a one-ulp difference
    upstream can move a channel's decay by 0.4 % a token and the state
    apart over 256 tokens. Its rel L2 is printed beside the same
    difference between two plain prefills that group the rows otherwise
    (row 0 of the batch of 4 against it alone: the GEMMs round
    differently)."""
    import torch

    from repro_torch.nn.lm import unstack_layers
    from repro_torch.nn.model import build_model
    from repro_torch.nn.rwkv6 import _decay, dims
    from repro_torch.train.optimizer import tree_map

    cfg = model.cfg
    plain = build_model(cfg, device=dev, target="torch_cpu")
    b, t = RWKV_PREFILL
    nh, hk = dims(cfg)
    g = torch.Generator(device=dev).manual_seed(11)
    r, k, v = (torch.randn((b, t, nh, hk), generator=g, device=dev) for _ in range(3))
    xw = torch.randn((b, t, cfg.d_model), generator=g, device=dev).to(model.dtype)
    p0 = unstack_layers(params["blocks"], cfg.n_layers)[0]["mix"]
    w = _decay(model.tsl, p0, xw).reshape(b, t, nh, hk)
    u = p0["u_bonus"].float()
    out = {"shape": [b, t, nh, hk], "decay_range": [w.min().item(), w.max().item()]}
    y, s = model.tsl.wkv6_scan(r, k, v, w, u)
    y_ref, s_ref = plain.tsl.wkv6_scan(r, k, v, w, u)
    out["wkv6_y_rel_err"] = ((y - y_ref).abs().max() / y_ref.abs().max()).item()
    out["wkv6_s_rel_err"] = ((s - s_ref).abs().max() / s_ref.abs().max()).item()
    print(f"[phase7a] wkv6_scan, h100 library (chunked, chunk 32) vs torch_cpu (time-step "
          f"scan) on {gpu}, float32 {tuple(r.shape)}: decays in "
          f"[{out['decay_range'][0]:.6f}, {out['decay_range'][1]:.6f}], max |dy| / max |y| "
          f"{out['wkv6_y_rel_err']:.3g}, max |ds| / max |s| {out['wkv6_s_rel_err']:.3g} "
          f"(tolerance {WKV_REL_TOL})", flush=True)
    if max(out["wkv6_y_rel_err"], out["wkv6_s_rel_err"]) > WKV_REL_TOL:
        raise AssertionError(f"phase 7a: wkv6_scan chunked vs scan {out['wkv6_y_rel_err']:.3g}"
                             f" / {out['wkv6_s_rel_err']:.3g} > {WKV_REL_TOL}")
    del r, k, v, w, y, s, y_ref, s_ref
    tokens = torch.randint(0, cfg.vocab, RWKV_PREFILL, generator=g, device=dev)

    # float32: prefill and decode steps, each model on its own state
    cfg32 = cfg.replace(dtype="float32")
    m32, p32 = build_model(cfg32, device=dev), build_model(cfg32, device=dev, target="torch_cpu")
    params32 = tree_map(lambda x: x.float(), params)
    checks = {}
    got, st = m32.prefill(params32, {"tokens": tokens}, t + DECODE_STEPS)
    want, pst = p32.prefill(params32, {"tokens": tokens}, t + DECODE_STEPS)
    checks["f32_prefill"] = _logits_check(got, want, cfg.vocab)
    toks = got[:, :cfg.vocab].argmax(-1)
    for i in range(DECODE_STEPS):
        got, st = m32.decode_step(params32, st, toks[:, None], t + i)
        want, pst = p32.decode_step(params32, pst, toks[:, None], t + i)
        checks[f"f32_decode_{i}"] = _logits_check(got, want, cfg.vocab)
        toks = got[:, :cfg.vocab].argmax(-1)
    del params32, st, pst
    for name, c in checks.items():
        _require_logits(f"phase 7a rwkv {name}, h100 vs torch_cpu library", c,
                        rel_l2=RWKV_F32_REL_L2)

    # bf16: each decode step from a shared state; the prefill as information
    got, state = model.prefill(params, {"tokens": tokens}, t + DECODE_STEPS)
    want, _ = plain.prefill(params, {"tokens": tokens}, t + DECODE_STEPS)
    row0, _ = plain.prefill(params, {"tokens": tokens[:1]}, t)
    out["bf16_prefill"] = _logits_check(got, want, cfg.vocab)
    out["bf16_prefill_plain_floor"] = _logits_check(row0, want[:1], cfg.vocab)
    toks = got[:, :cfg.vocab].argmax(-1)
    for i in range(DECODE_STEPS):
        shared = {n: x.clone() for n, x in state.items()}
        got, state = model.decode_step(params, state, toks[:, None], t + i)
        want, _ = plain.decode_step(params, shared, toks[:, None], t + i)
        checks[f"bf16_decode_{i}"] = _logits_check(got, want, cfg.vocab)
        _require_logits(f"phase 7a rwkv bf16 decode step {i} from a shared state, h100 vs "
                        f"torch_cpu library", checks[f"bf16_decode_{i}"])
        toks = got[:, :cfg.vocab].argmax(-1)
    out["logits"] = checks

    def worst(prefix):
        return max(c["logits_rel_l2"] for n, c in checks.items() if n.startswith(prefix))

    print(f"[phase7a] {RWKV_ARCH} prefill {RWKV_PREFILL} + {DECODE_STEPS} decode steps, h100 "
          f"vs torch_cpu library on {gpu}: float32 worst rel L2 {worst('f32'):.3g} "
          f"(bound {RWKV_F32_REL_L2}); bf16 decode steps from a shared state worst rel L2 "
          f"{worst('bf16'):.3g} (bound {LOGITS_REL_L2}); bf16 prefill rel L2 "
          f"{out['bf16_prefill']['logits_rel_l2']:.3g} (information; two plain prefills, "
          f"row 0 of batch 4 vs batch 1: "
          f"{out['bf16_prefill_plain_floor']['logits_rel_l2']:.3g}); "
          f"bf16 prefill argmax {json.dumps(out['bf16_prefill']['argmax'])}; "
          f"{json.dumps(checks)}", flush=True)
    return out


def rwkv_serve_phase(dev, params, gpu: str) -> dict:
    """Phases 7b-7d: rwkv6-7b served at its full widths and RWKV_SERVE_LAYERS
    of its 32 layers (the first layers of the seeded weights), each serve a
    paired_serve (captured and eager: equal outputs, counters and launches)
    under rwkv_launch_check, the counters set to 0 just before each pair and
    read just after it.
    7b lane mode, phase 3's shapes (graphs side traced).
    7c paged mode (PagedConfig()) on phase 3b's requests: no leaf pages, so
       fused is false, requests activate through lanes, and the shared
       system prompt is shared as the tail state at its 128-row boundary;
       tokens equal a lane-mode run's of the same requests.
    7d the n-gram drafter at fixed depth SPEC_K on SPEC_DRAFT_REQUESTS of
       phase 3e(ii)'s pattern prompts (one wave of the 8 slots), lane mode: verify steps run and each is followed by its
       commit (jit_cache "commit"); the share of requests equal to a
       non-speculative serve's is information only (the verify span runs
       the chunked scan, decode the step form)."""
    from repro_torch.configs import get_config
    from repro_torch.serve import PagedConfig, Request, ServeEngine, SpeculationConfig

    cfg = get_config(RWKV_ARCH).replace(n_layers=RWKV_SERVE_LAYERS)
    kw = dict(batch=PAGED_BATCH, max_len=RWKV_PROMPT + RWKV_GEN, device=dev, params=params,
              prefill_chunk=PAGED_CHUNK)
    out = {}

    def lane_check(n_req, spec=False):
        def check(report, launched):
            problems = []
            if report["target"] != "h100":
                problems.append(f"served with target {report['target']!r}")
            if report["requests"] != n_req or report["refused"]:
                problems.append(f"{report['requests']} of {n_req} answered, refused "
                                f"{report['refused']}")
            short = {r: len(t) for r, t in report["outputs"].items() if len(t) != RWKV_GEN}
            if short or len(report["outputs"]) != n_req:
                problems.append(f"requests without {RWKV_GEN} tokens: {short}")
            verify = report["spec"]["verify_steps"] if spec else 0
            if spec and (not verify or "commit" not in report["jit_cache"]):
                problems.append(f"verify steps {verify}, jit_cache {report['jit_cache']}")
            if "paged" in report:
                paged = report["paged"]
                if paged["fused"] or paged["lane_activations"] <= 0 \
                        or paged["prefix_hits"] <= 0:
                    problems.append(f"paged: fused {paged['fused']}, lane activations "
                                    f"{paged['lane_activations']}, prefix hits "
                                    f"{paged['prefix_hits']}")
            return problems + rwkv_launch_check(cfg, launched, report, verify_steps=verify)
        return check

    def serve(tag, name, run, check, graphs_first, trace=()):
        for fn in counters().values():
            fn.launches = 0
        pair = paired_serve(tag, name, gpu, run, check, graphs_first, trace=trace)
        pair["launches"] = read_counts()
        return pair

    t0 = time.perf_counter()
    out["7b"] = serve("phase7b", f"lane serve {RWKV_ARCH}",
                      lambda: ServeEngine(cfg, **kw).run(rwkv_requests(cfg.vocab, Request)),
                      lane_check(RWKV_SERVE_REQUESTS), True, trace=("graphs",))
    out["7b"]["seconds"] = time.perf_counter() - t0
    lane_steps = out["7b"]["report"]["step_log"]
    print(f"[phase7b] lane serve {RWKV_ARCH} on {gpu}: decode steps "
          f"{sum(e['decoded'] > 0 for e in lane_steps)}, prefill chunks "
          f"{sum(e['chunks'] for e in lane_steps)}, launches of the pair "
          f"{out['7b']['launches']}; phase {out['7b']['seconds']:.1f} s", flush=True)

    t0 = time.perf_counter()
    paged_kw = dict(kw, max_len=PAGED_MAX_LEN)
    out["7c"] = serve("phase7c", f"paged serve {RWKV_ARCH} (lane fallback)",
                      lambda: ServeEngine(cfg, paged=PagedConfig(), **paged_kw).run(
                          paged_requests(cfg.vocab, Request)),
                      lane_check(PAGED_REQUESTS), False)
    paged_report = out["7c"]["report"]
    contiguous = ServeEngine(cfg, **paged_kw).run(paged_requests(cfg.vocab, Request))
    differ = sorted(r for r, toks in paged_report["outputs"].items()
                    if toks != contiguous["outputs"][r])
    if differ:
        raise AssertionError(f"phase 7c: paged outputs differ from lane mode's for {differ}")
    out["7c"]["seconds"] = time.perf_counter() - t0
    print(f"[phase7c] paged serve {RWKV_ARCH} on {gpu}: outputs equal the contiguous run's "
          f"for all {PAGED_REQUESTS} requests; paged {json.dumps(paged_report['paged'])}; "
          f"launches of the pair {out['7c']['launches']}; phase "
          f"{out['7c']['seconds']:.1f} s", flush=True)

    t0 = time.perf_counter()
    spec_kw = dict(kw, max_len=SPEC_PROMPT + PAGED_GEN)
    out["7d"] = serve("phase7d", f"speculative serve {RWKV_ARCH}, n-gram depth {SPEC_K}",
                      lambda: ServeEngine(cfg, speculation=SpeculationConfig(fixed_k=SPEC_K),
                                          **spec_kw).run(
                          spec_requests(cfg.vocab, Request, SPEC_DRAFT_REQUESTS)),
                      lane_check(SPEC_DRAFT_REQUESTS, spec=True), False)
    spec_report = out["7d"]["report"]
    if out["7d"]["graphs"]["jit_cache"]["commit"] <= 0:
        raise AssertionError(f"phase 7d: the graphs run captured no commit step: "
                             f"{out['7d']['graphs']['jit_cache']}")
    plain = ServeEngine(cfg, **spec_kw).run(spec_requests(cfg.vocab, Request,
                                                          SPEC_DRAFT_REQUESTS))
    same = sum(spec_report["outputs"][r] == plain["outputs"][r] for r in plain["outputs"])
    first_diff = sorted(next(i for i, (a, b) in enumerate(zip(toks, plain["outputs"][r]))
                             if a != b)
                        for r, toks in spec_report["outputs"].items()
                        if toks != plain["outputs"][r])
    spec = spec_report["spec"]
    out["7d"].update(share_equal_to_plain=same / SPEC_DRAFT_REQUESTS,
                     first_differing_token=first_diff,
                     plain_decode_tokens_per_s=plain["decode_tokens_per_s"],
                     seconds=time.perf_counter() - t0,
                     spec={k: spec[k] for k in ("verify_steps", "decode_steps",
                                                "drafted_tokens", "accepted_tokens",
                                                "accepted_rate", "mean_accepted_span")})
    print(f"[phase7d] speculative serve {RWKV_ARCH} on {gpu}: {json.dumps(out['7d']['spec'])}, "
          f"jit_cache {spec_report['jit_cache']}; requests equal to the non-speculative "
          f"serve {same}/{SPEC_DRAFT_REQUESTS} (information only), first differing token "
          f"{first_diff}; non-speculative {plain['decode_tokens_per_s']:.1f} tokens/s; "
          f"launches of the pair {out['7d']['launches']}; phase {out['7d']['seconds']:.1f} s",
          flush=True)
    for r in out.values():
        r.pop("report")
    return out


def rwkv_profile_phase(dev, model, params, gpu: str) -> dict:
    """Phase 4's step table for rwkv6-7b (run in phase 7, where its model
    lives): the lane decode step at batch PROFILE_BATCH and the verify step
    of a span SPEC_K + 1 followed by its commit (every slot committing the
    whole span), each through the engine's step code (serve/graphs.py),
    captured and eager, by _profile: host wall, device busy, kernels per
    step. Not a main path: its launches are not counted."""
    import numpy as np
    import torch

    from repro_torch.serve import StepGraphs, disable_graphs
    from repro_torch.serve.graphs import run_commit, run_model_step

    cfg = model.cfg
    rng = np.random.default_rng(12)
    state = model.init_decode_state(PROFILE_BATCH, PROFILE_FILL + PROFILE_GEN)
    tokens = rng.integers(0, cfg.vocab, (PROFILE_BATCH, 1))
    span = rng.integers(0, cfg.vocab, (PROFILE_BATCH, SPEC_K + 1))
    pos = np.full(PROFILE_BATCH, PROFILE_FILL, np.int64)
    n_commit = np.full(PROFILE_BATCH, SPEC_K + 1, np.int64)
    graphs = StepGraphs(dev)

    def verify_commit():
        logits = run_model_step(graphs, "verify", model, params, state, span, pos)
        run_commit(graphs, model, params, state, span, pos, n_commit)
        return logits

    steps = {"rwkv_decode_step": lambda: run_model_step(graphs, "decode", model, params,
                                                        state, tokens, pos),
             "rwkv_verify_commit": verify_commit}
    out = {}
    with torch.inference_mode():
        for kind, fn in steps.items():
            def eager(fn=fn):
                with disable_graphs():
                    return fn()
            out[kind] = {"batch": PROFILE_BATCH, "span": 1 if "decode" in kind else SPEC_K + 1,
                         "layers": cfg.n_layers, "captured": _profile(fn, host_top=False),
                         "eager": _profile(eager, host_top=False)}
    out["jit_cache"] = graphs.sizes(("decode", "verify", "commit"))
    for kind in steps:
        c, e = out[kind]["captured"], out[kind]["eager"]
        print(f"[phase4] {kind} ({RWKV_ARCH}) on {gpu}, captured vs eager: host wall "
              f"{c['wall_ms']:.3f} vs {e['wall_ms']:.3f} ms, device busy "
              f"{c['device_busy_ms']} vs {e['device_busy_ms']} ms, idle share "
              f"{c.get('device_idle_share')} vs {e.get('device_idle_share')}, kernels per "
              f"step {c['launches']} vs {e['launches']}; top kernels (captured) "
              f"{json.dumps(c.get('top_kernels_ms'))}", flush=True)
    return out


def rwkv_phase(dev, gpu: str) -> dict:
    """Phase 7: rwkv6-7b at full width (32 layers, d 4096, 64 WKV heads of
    64, d_ff 14336, vocab 65536, bf16, layernorm), seeded weights from the
    port's init on the card: 7a the layers, 7b-7d serving, and its rows of
    phase 4's step table. Every earlier model is freed before it."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.nn.model import RwkvModel, build_model
    from repro_torch.train.optimizer import tree_leaves, tree_map

    t_phase = time.perf_counter()
    cfg = get_config(RWKV_ARCH)
    model = build_model(cfg, device=dev)
    assert isinstance(model, RwkvModel) and model.lib.TARGET_NAME == "h100"
    params = model.init(0)
    n_params = sum(t.numel() for t in tree_leaves(params))
    state_slot = sum(t[:, :1].numel() * t.element_size()
                     for t in model.init_decode_state(1, 1).values())
    print(f"[phase7] {RWKV_ARCH} on {gpu}: {n_params / 1e9:.4f}B params "
          f"({sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9:.3f} GB), "
          f"w_base {params['blocks']['mix']['w_base'].dtype}, a decode-state slot "
          f"{state_slot / 1e6:.2f} MB; init {time.perf_counter() - t_phase:.1f} s", flush=True)
    out = {"params": n_params, "state_slot_bytes": state_slot}
    t0 = time.perf_counter()
    with torch.inference_mode():
        saved = read_counts()
        out["7a"] = rwkv_layers_phase(dev, model, params, gpu)
        for name, fn in counters().items():      # kernel vs plain: not a main path
            fn.launches = saved[name]
    out["7a"]["seconds"] = time.perf_counter() - t0
    # 7b-7d and phase 4's rows at RWKV_SERVE_LAYERS of the depth, widths kept
    cut = {**params, "blocks": tree_map(lambda x: x[:RWKV_SERVE_LAYERS], params["blocks"])}
    out.update(rwkv_serve_phase(dev, cut, gpu))
    t0 = time.perf_counter()
    saved = read_counts()
    out["phase4"] = rwkv_profile_phase(
        dev, build_model(cfg.replace(n_layers=RWKV_SERVE_LAYERS), device=dev), cut, gpu)
    for name, fn in counters().items():
        fn.launches = saved[name]
    out["phase4"]["seconds"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[phase7] {RWKV_ARCH} done on {gpu}: phase {out['seconds']:.1f} s (7a "
          f"{out['7a']['seconds']:.1f}, 7b {out['7b']['seconds']:.1f}, 7c "
          f"{out['7c']['seconds']:.1f}, 7d {out['7d']['seconds']:.1f}, phase 4's rows "
          f"{out['phase4']['seconds']:.1f})", flush=True)
    return out


def zamba_launch_check(cfg, launched, report, *, fused: bool) -> list:
    """The problems of one zamba serve's launch counts. rmsnorm launches
    2 n_layers + n_shared + 1 times a pass (each Mamba2 layer's block norm
    and its gated norm at d_inner, the shared block's norm, the final norm):
    once per decode step and prefill chunk, twice per verify step (the span
    and its commit replay). The paged kernel launches n_shared times per
    decode step, verify step and paged commit fused, never in lanes; swiglu
    and flash attention never (the engine's chunks attend by the plain
    chunk attention)."""
    from repro_torch.nn.zamba import layout

    g, _, _ = layout(cfg)
    chunks = sum(e["chunks"] for e in report["step_log"])
    spec = report.get("spec") or {}
    verify = spec.get("verify_steps", 0)
    decode = sum(e["decoded"] > 0 for e in report["step_log"]) - verify
    per_pass = 2 * cfg.n_layers + g + 1
    want = {"rmsnorm": per_pass * (decode + chunks + 2 * verify),
            "paged_attention": g * (decode + 2 * verify) if fused else 0,
            "swiglu": 0, "flash_attention": 0}
    return [f"{name} launched {launched[name]} times, want {n} ({decode} decode steps, "
            f"{chunks} prefill chunks, {verify} verify steps + commits; {per_pass} norms "
            f"and {g} shared attention applications a pass)"
            for name, n in want.items() if launched[name] != n]


class _Compared:
    """A library's ops whose kernel wrappers named in ``plain`` also run
    their plain version on the same operands right after the kernel (the
    operands are not written by either), each pair held to TOLERANCE by
    check_case and recorded in ``results``; the kernel's output is
    returned. Holds a kernel against its plain version inside the model, on
    the activations the model gives it, call by call."""

    def __init__(self, ops, plain: dict, label: str):
        self._ops, self._plain, self._label, self.results = ops, plain, label, []

    def __getattr__(self, name):
        if name not in self._plain:
            return getattr(self._ops, name)
        kernel, ref = getattr(self._ops, name), self._plain[name]

        def both(*args, **kw):
            got = kernel(*args, **kw)
            shape = tuple(got.shape)
            self.results.append(check_case(f"{self._label} {name} call {len(self.results)}",
                                           shape, got, ref(*args, **kw), got.dtype))
            return got
        return both


def _worst(results: list) -> dict:
    return {"calls": len(results),
            "max_abs_err": max(r["max_abs_err"] for r in results),
            "tolerance_used": max(r["tolerance_used"] for r in results)}


def zamba_cut(cfg, params, n_layers: int):
    """(cfg, params) of zamba at ``n_layers`` of its depth, its widths kept:
    the first n_layers // attn_every groups and the first layers of the
    remainder stack (views of ``params``)."""
    from repro_torch.train.optimizer import tree_map

    k = cfg.attn_every
    g, rem = n_layers // k, n_layers % k
    cut = {**params, "groups": tree_map(lambda x: x[:g], params["groups"])}
    if rem:
        cut["rest"] = tree_map(lambda x: x[:rem], params["rest"])
    else:
        cut.pop("rest", None)
    return cfg.replace(n_layers=n_layers), cut


def zamba_paged_check(dev, runs) -> dict:
    """8a, paged: one fused paged decode step and one verify span of
    SPEC_K + 1 at batch 8 over 256 prefilled rows, per (label, model,
    params, rel_l2) of ``runs``. The paged kernel against its plain version
    at each shared-attention application of both steps, on the activations
    and pools the step gives it (_Compared, TOLERANCE); the whole step's
    logits against the step through the plain version on copies of the same
    tails and pools, under _require_logits at ``rel_l2`` (None: printed
    only: at 81 layers one ulp of difference grows to a few 1e-2 in bf16 and
    1e-2 in float32, see zamba_layers_phase). Row 0 of the span against the
    decode step is printed (the span's Mamba2 layers run the chunked form,
    the step the decode form)."""
    import torch

    from repro_torch.kernels.paged.ref import paged_attention_ref
    from repro_torch.nn import zamba

    batch, fill = PROFILE_BATCH, PROFILE_FILL
    out = {"batch": batch, "kv_len": fill + 1, "span": SPEC_K + 1}
    for label, m, p, rel_l2 in runs:
        cfg, vocab = m.cfg, m.cfg.padded_vocab
        g = torch.Generator(device=dev).manual_seed(14)
        span = torch.randint(0, cfg.vocab, (batch, SPEC_K + 1), generator=g, device=dev)
        pos = torch.full((batch,), fill, dtype=torch.int64, device=dev)
        steps = (("decode", zamba.zamba_decode_step_paged, span[:, :1]),
                 ("verify", zamba.zamba_verify_step_paged, span))
        tails, pools, tables = paged_state(dev, m, p, batch, fill, seed=13)
        compared = _Compared(m.tsl, {"attention_decode_paged": paged_attention_ref,
                                     "attention_verify_paged": paged_attention_ref},
                             f"phase 8a {label} fused paged step")
        logits = {}
        for name, tsl in (("kernel", compared), ("plain", _PlainOps(m.tsl))):
            for kind, fn, toks in steps:
                st = {n: t.clone() for n, t in tails.items()}
                pl = {n: t.clone() for n, t in pools.items()}
                logits[name, kind] = fn(tsl, p, st, pl, tables, toks, pos, cfg)[0].reshape(
                    -1, vocab)
        r = {kind: _logits_check(logits["kernel", kind], logits["plain", kind], cfg.vocab)
             for kind, _, _ in steps}
        r["kernel_calls_vs_plain"] = _worst(compared.results)
        r["verify_row0_vs_decode"] = _logits_check(
            logits["kernel", "verify"].reshape(batch, -1, vocab)[:, 0],
            logits["kernel", "decode"], cfg.vocab)
        r["layers"] = cfg.n_layers
        out[label] = r
        del tails, pools
        if rel_l2 is not None:
            for kind, _, _ in steps:
                _require_logits(f"phase 8a {label} fused paged {kind} step, kernel vs plain",
                                r[kind], rel_l2=rel_l2)
    return out


def zamba_layers_phase(dev, model, params, params32, gpu: str) -> dict:
    """Phase 8a: zamba2-7b's main path and its layers against the plain
    versions on the card.

    The main path, counted (the counters set to 0 just before it and read
    just after): Model.prefill of ZAMBA_PREFILL tokens through the h100
    library (the flash kernel ZAMBA_SHARED times, at D 112), then
    DECODE_STEPS greedy bf16 decode steps: finite logits of the right shape.

    Then, not counted:
    * the flash kernel against its plain version at each of the 13
      applications of a full-width bf16 prefill, on the activations the
      prefill gives it (_Compared, TOLERANCE);
    * the h100 library's ssd_scan (the chunked form) against the torch_cpu
      library's time-step scan, float32, at ZAMBA_PREFILL x (112, 64, N 64)
      with decays from layer 0's discretization on seeded activations,
      within SSD_REL_TOL of max |y| and of max |h|;
    * the model in float32 (``params32``) at ZAMBA_F32_LAYERS of its depth,
      widths kept (one group, the shared block, a remainder layer), on
      each library: one prefill and DECODE_STEPS decode steps each on its
      own state, every row within ZAMBA_F32_REL_L2;
    * zamba_paged_check: the paged kernel call by call at full depth in
      bf16 and float32, and the whole fused steps in float32 at
      ZAMBA_F32_LAYERS.
    The full-depth model against the plain library's is printed, not gated:
    zamba2-7b's seeded layers amplify a difference layer after layer (the
    SSD's summation order, chunked against the scan, 8e-7 in a layer,
    reaches 9.5e-3 of the float32 prefill's logits at 81 layers, 1.1e-4 at
    13), and
    in bf16 one ulp also moves a head's bf16-rounded decay (a decode step
    from a shared state apart by rel L2 0.42, parting at layer 4)."""
    import torch

    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.nn import zamba
    from repro_torch.nn.lm import unstack_layers
    from repro_torch.nn.mamba2 import _discretize, _split_proj, dims
    from repro_torch.nn.model import build_model
    from repro_torch.nn.zamba import layout

    cfg = model.cfg
    plain = build_model(cfg, device=dev, target="torch_cpu")
    b, t = ZAMBA_PREFILL
    max_len = t + DECODE_STEPS
    g = torch.Generator(device=dev).manual_seed(21)
    tokens = torch.randint(0, cfg.vocab, ZAMBA_PREFILL, generator=g, device=dev)
    out, checks = {}, {}

    # the main path: prefill + decode steps through the kernels, counted
    for fn in counters().values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, state = model.prefill(params, {"tokens": tokens}, max_len)
    torch.cuda.synchronize()
    out["prefill_s"] = time.perf_counter() - t0
    out["prefill_launches"] = read_counts()
    if out["prefill_launches"]["flash_attention"] != ZAMBA_SHARED:
        raise AssertionError(f"phase 8a: the flash kernel launched "
                             f"{out['prefill_launches']['flash_attention']} times in a prefill, "
                             f"want {ZAMBA_SHARED}")
    first = got
    toks = got[:, :cfg.vocab].argmax(-1)
    generated = []
    for i in range(DECODE_STEPS):
        shared = {n: x.clone() for n, x in state.items()}
        got, state = model.decode_step(params, state, toks[:, None], t + i)
        want, _ = plain.decode_step(params, shared, toks[:, None], t + i)
        checks[f"bf16_decode_{i}"] = _logits_check(got, want, cfg.vocab)
        toks = got[:, :cfg.vocab].argmax(-1)
        generated.append(toks.tolist())
    for logits in (first, got):
        if tuple(logits.shape) != (b, cfg.padded_vocab) \
                or not torch.isfinite(logits.float()).all():
            raise AssertionError(f"phase 8a: logits {tuple(logits.shape)} not finite/shaped")
    if not all(c["finite"] for c in checks.values()):
        raise AssertionError("phase 8a: a bf16 decode step's logits are not finite")
    out["launches"] = read_counts()
    out["greedy_tokens"] = generated
    del state, shared
    saved = read_counts()

    # the flash kernel in context: each of the 13 applications vs plain
    compared = _Compared(model.tsl, {"flash_attention": flash_ref.attention},
                         "phase 8a bf16 prefill")
    zamba.zamba_prefill(compared, params, tokens, cfg, max_len=max_len)
    out["flash_calls_vs_plain"] = _worst(compared.results)
    if out["flash_calls_vs_plain"]["calls"] != ZAMBA_SHARED:
        raise AssertionError(f"phase 8a: {out['flash_calls_vs_plain']['calls']} flash calls "
                             f"compared, want {ZAMBA_SHARED}")

    # the SSD: chunked (h100) against the time-step scan (torch_cpu), float32
    n_groups, k, _ = layout(cfg)
    p0 = unstack_layers(unstack_layers(params["groups"], n_groups)[0], k)[0]["mamba"]
    d_in, _, n, _ = dims(cfg)
    xn = torch.randn((b, t, cfg.d_model), generator=g, device=dev).to(model.dtype)
    _, _, bb, cc, dt_raw = _split_proj(model.tsl.matmul(xn, p0["in_proj"]), cfg)
    xs = torch.randn((b, t, d_in), generator=g, device=dev)
    a, x_scaled, _ = _discretize(p0, dt_raw, xs, cfg)
    y, h = model.tsl.ssd_scan(x_scaled, a, bb.float(), cc.float())
    y_ref, h_ref = plain.tsl.ssd_scan(x_scaled, a, bb.float(), cc.float())
    out["ssd"] = {"shape": list(x_scaled.shape) + [n],
                  "decay_range": [a.min().item(), a.max().item()],
                  "y_rel_err": ((y - y_ref).abs().max() / y_ref.abs().max()).item(),
                  "h_rel_err": ((h - h_ref).abs().max() / h_ref.abs().max()).item()}
    print(f"[phase8a] ssd_scan, h100 library (chunked, chunk 64) vs torch_cpu (time-step "
          f"scan) on {gpu}, float32 {tuple(x_scaled.shape)} N {n}: decays in "
          f"[{out['ssd']['decay_range'][0]:.6f}, {out['ssd']['decay_range'][1]:.6f}], "
          f"max |dy| / max |y| {out['ssd']['y_rel_err']:.3g}, max |dh| / max |h| "
          f"{out['ssd']['h_rel_err']:.3g} (tolerance {SSD_REL_TOL})", flush=True)
    if max(out["ssd"]["y_rel_err"], out["ssd"]["h_rel_err"]) > SSD_REL_TOL:
        raise AssertionError(f"phase 8a: ssd_scan chunked vs scan {out['ssd']['y_rel_err']:.3g}"
                             f" / {out['ssd']['h_rel_err']:.3g} > {SSD_REL_TOL}")
    del y, h, y_ref, h_ref, x_scaled, a, xs, xn

    # the bf16 prefill against the plain library's (information)
    want, _ = plain.prefill(params, {"tokens": tokens}, max_len)
    row0, _ = plain.prefill(params, {"tokens": tokens[:1]}, t)
    out["bf16_prefill"] = _logits_check(first, want, cfg.vocab)
    out["bf16_prefill_plain_floor"] = _logits_check(row0, want[:1], cfg.vocab)

    # float32 at ZAMBA_F32_LAYERS of the depth, widths kept: prefill and
    # decode steps, each library on its own state; at full depth the
    # prefill is printed only (one ulp grows through 81 layers)
    cfg32 = cfg.replace(dtype="float32")
    m32 = build_model(cfg32, device=dev)
    got, _ = m32.prefill(params32, {"tokens": tokens}, max_len)
    want, _ = build_model(cfg32, device=dev, target="torch_cpu").prefill(
        params32, {"tokens": tokens}, max_len)
    out["f32_prefill_full_depth"] = _logits_check(got, want, cfg.vocab)
    cut_cfg, cut_params = zamba_cut(cfg32, params32, ZAMBA_F32_LAYERS)
    mc, pc = build_model(cut_cfg, device=dev), build_model(cut_cfg, device=dev,
                                                           target="torch_cpu")
    got, st = mc.prefill(cut_params, {"tokens": tokens}, max_len)
    want, pst = pc.prefill(cut_params, {"tokens": tokens}, max_len)
    checks["f32_prefill"] = _logits_check(got, want, cfg.vocab)
    toks = got[:, :cfg.vocab].argmax(-1)
    for i in range(DECODE_STEPS):
        got, st = mc.decode_step(cut_params, st, toks[:, None], t + i)
        want, pst = pc.decode_step(cut_params, pst, toks[:, None], t + i)
        checks[f"f32_decode_{i}"] = _logits_check(got, want, cfg.vocab)
        toks = got[:, :cfg.vocab].argmax(-1)
    del st, pst
    for name, c in checks.items():
        if name.startswith("f32"):
            _require_logits(f"phase 8a zamba {name} at {ZAMBA_F32_LAYERS} layers, h100 vs "
                            f"torch_cpu library", c, rel_l2=ZAMBA_F32_REL_L2)
    out["logits"] = checks
    out["paged"] = zamba_paged_check(dev, [("bf16", model, params, None),
                                           ("f32", m32, params32, None),
                                           (f"f32 at {ZAMBA_F32_LAYERS} layers", mc, cut_params,
                                            ZAMBA_F32_REL_L2)])
    torch.cuda.empty_cache()
    for name, fn in counters().items():      # kernel vs plain: not a main path
        fn.launches = saved[name]

    def worst(prefix):
        return max(c["logits_rel_l2"] for n, c in checks.items() if n.startswith(prefix))

    pg = out["paged"]
    cut = pg[f"f32 at {ZAMBA_F32_LAYERS} layers"]
    print(f"[phase8a] {ZAMBA_ARCH} prefill {ZAMBA_PREFILL} ({out['prefill_s']:.3f} s, first "
          f"call) + {DECODE_STEPS} decode steps on {gpu}: launches per prefill "
          f"{out['prefill_launches']}, main path {out['launches']}; flash kernel vs plain at "
          f"each shared-attention application of a bf16 prefill "
          f"{json.dumps(out['flash_calls_vs_plain'])}; paged kernel vs plain at each "
          f"application of a fused decode and verify step, bf16 "
          f"{json.dumps(pg['bf16']['kernel_calls_vs_plain'])}, float32 "
          f"{json.dumps(pg['f32']['kernel_calls_vs_plain'])}; at {ZAMBA_F32_LAYERS} layers in "
          f"float32: h100 vs torch_cpu worst rel L2 {worst('f32'):.3g}, fused paged step "
          f"kernel vs plain rel L2 decode {cut['decode']['logits_rel_l2']:.3g}, verify "
          f"{cut['verify']['logits_rel_l2']:.3g} (bound {ZAMBA_F32_REL_L2}); information, at "
          f"full depth: float32 prefill rel L2 "
          f"{out['f32_prefill_full_depth']['logits_rel_l2']:.3g}, float32 fused paged step "
          f"kernel vs plain decode {pg['f32']['decode']['logits_rel_l2']:.3g}, verify "
          f"{pg['f32']['verify']['logits_rel_l2']:.3g}; bf16 decode steps from a shared state "
          f"rel L2 "
          f"{[round(checks[f'bf16_decode_{i}']['logits_rel_l2'], 4) for i in range(DECODE_STEPS)]}"
          f", bf16 prefill rel L2 {out['bf16_prefill']['logits_rel_l2']:.3g} (two plain "
          f"prefills, row 0 of batch 2 vs batch 1: "
          f"{out['bf16_prefill_plain_floor']['logits_rel_l2']:.3g}), bf16 fused paged step "
          f"kernel vs plain rel L2 decode {pg['bf16']['decode']['logits_rel_l2']:.3g}, verify "
          f"{pg['bf16']['verify']['logits_rel_l2']:.3g}; {json.dumps(checks)}; paged "
          f"{json.dumps(pg)}", flush=True)
    return out


def zamba_serve_phase(dev, params, gpu: str) -> dict:
    """Phases 8b-8d: zamba2-7b served at full width, each serve a
    paired_serve (captured and eager: equal outputs, counters and launches)
    under zamba_launch_check, the counters set to 0 just before each pair
    and read just after it.
    8b the serve CLI (repro_torch.launch.serve --arch zamba2-7b) at phase 3's
       shapes, lane mode (its own seeded weights; untraced: reading its ~1.1
       million device records took longer than the serve; phase 4's rows
       give a captured step's idle share).
    8c and 8d run ZAMBA_SERVE_LAYERS of its 81 layers, its widths kept
       (zamba_cut: the first two groups of 6 of 8a's weights, two
       applications of the shared block), for phase 9's room in the
       script's time.
    8c fused paged mode (PagedConfig(page_size=PAGE)) on phase 3b's
       requests: the tails in the slot table, the shared block's KV in the
       pools through the paged kernel (once an application a decode step),
       the system prompt shared at its 128-row boundary (15 prefix hits, the
       tail restored by copy, and each preemption's continuation hitting it
       again). The share of the first wave's requests whose tokens equal a
       lane-mode run's is printed (information: lane mode attends by the
       plain version, and a difference grows through zamba's 81 layers, see
       zamba_layers_phase).
    8d the n-gram drafter at fixed depth SPEC_K on SPEC_DRAFT_REQUESTS of
       phase 3e(ii)'s pattern prompts, ZAMBA_SPEC_GEN tokens each (the
       script's time), fused paged: verify steps run and
       each is followed by its commit on the pools (jit_cache
       "commit_paged" in the graphs run; a paged launch an application a
       decode, verify or commit step)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serve import PagedConfig, Request, ServeEngine, SpeculationConfig

    full = get_config(ZAMBA_ARCH)
    cfg, cut = zamba_cut(full, params, ZAMBA_SERVE_LAYERS)
    kw = dict(batch=PAGED_BATCH, max_len=PAGED_MAX_LEN, device=dev, params=cut,
              prefill_chunk=PAGED_CHUNK)
    out = {}

    def check(n_req, fused, spec=False, gen=PAGED_GEN, cfg=cfg):
        def run_check(report, launched):
            problems = []
            if report["target"] != "h100":
                problems.append(f"served with target {report['target']!r}")
            if report["requests"] != n_req or report["refused"]:
                problems.append(f"{report['requests']} of {n_req} answered, refused "
                                f"{report['refused']}")
            short = {r: len(t) for r, t in report["outputs"].items() if len(t) != gen}
            if short or len(report["outputs"]) != n_req:
                problems.append(f"requests without {gen} tokens: {short}")
            if spec and not report["spec"]["verify_steps"]:
                problems.append("no verify step ran")
            if fused:
                # more requests than slots park, and activate by a tail restore
                paged = report["paged"]
                parked = n_req > PAGED_BATCH
                if not paged["fused"] or paged["lane_activations"] or \
                        parked != (paged["tail_restores"] > 0):
                    problems.append(f"paged: fused {paged['fused']}, lane activations "
                                    f"{paged['lane_activations']}, tail restores "
                                    f"{paged['tail_restores']}")
            return problems + zamba_launch_check(cfg, launched, report, fused=fused)
        return run_check

    def serve(tag, name, run, run_check, graphs_first, trace=()):
        for fn in counters().values():
            fn.launches = 0
        t0 = time.perf_counter()
        pair = paired_serve(tag, name, gpu, run, run_check, graphs_first, trace=trace)
        pair["launches"] = read_counts()
        pair["seconds"] = time.perf_counter() - t0
        return pair

    out["8b"] = serve("phase8b", f"serve CLI --arch {ZAMBA_ARCH}",
                      lambda: serve_cli.main(ZAMBA_SERVE_ARGS)["report"],
                      check(RWKV_SERVE_REQUESTS, fused=False, cfg=full), True)
    steps = out["8b"]["report"]["step_log"]
    print(f"[phase8b] lane serve {ZAMBA_ARCH} on {gpu}: decode steps "
          f"{sum(e['decoded'] > 0 for e in steps)}, prefill chunks "
          f"{sum(e['chunks'] for e in steps)}, launches of the pair {out['8b']['launches']}; "
          f"phase {out['8b']['seconds']:.1f} s", flush=True)

    out["8c"] = serve("phase8c", f"fused paged serve {ZAMBA_ARCH} at {cfg.n_layers} layers",
                      lambda: ServeEngine(cfg, paged=PagedConfig(page_size=PAGE), **kw).run(
                          paged_requests(cfg.vocab, Request)),
                      check(PAGED_REQUESTS, fused=True), False)
    t0 = time.perf_counter()
    paged_report = out["8c"]["report"]
    # one miss publishes the system prompt; every other request hits it, and
    # so does each continuation of a preemption (its prompt starts with it)
    pg = paged_report["paged"]
    if pg["prefix_misses"] != 1 or \
            pg["prefix_hits"] != PAGED_REQUESTS - 1 + pg["preemptions"]:
        raise AssertionError(f"phase 8c: {pg['prefix_hits']} prefix hits and "
                             f"{pg['prefix_misses']} misses with {pg['preemptions']} "
                             f"preemptions, want {PAGED_REQUESTS - 1} + preemptions and 1")
    # information: the first wave's requests in lane mode
    lane = ServeEngine(cfg, **kw).run(paged_requests(cfg.vocab, Request)[:PAGED_BATCH])

    differ = {r: next(i for i, (x, y) in enumerate(zip(lane["outputs"][r], toks)) if x != y)
              for r, toks in paged_report["outputs"].items()
              if r in lane["outputs"] and toks != lane["outputs"][r]}
    out["8c"].update(lane_decode_tokens_per_s=lane["decode_tokens_per_s"],
                     share_equal_to_lane=1 - len(differ) / PAGED_BATCH,
                     first_differing_token=differ)
    out["8c"]["seconds"] += time.perf_counter() - t0
    print(f"[phase8c] fused paged serve {ZAMBA_ARCH} on {gpu}: tokens of "
          f"{PAGED_BATCH - len(differ)}/{PAGED_BATCH} first-wave requests equal a lane-mode run's "
          f"(information; first differing token of the others {differ}); lane "
          f"{lane['decode_tokens_per_s']:.1f} tokens/s; paged "
          f"{json.dumps(paged_report['paged'])}; launches of the pair "
          f"{out['8c']['launches']}; phase {out['8c']['seconds']:.1f} s", flush=True)

    spec_kw = dict(kw, max_len=SPEC_PROMPT + PAGED_GEN)
    out["8d"] = serve("phase8d", f"speculative fused paged serve {ZAMBA_ARCH} at "
                      f"{cfg.n_layers} layers, n-gram depth {SPEC_K}",
                      lambda: ServeEngine(cfg, paged=PagedConfig(page_size=PAGE),
                                          speculation=SpeculationConfig(fixed_k=SPEC_K),
                                          **spec_kw).run(
                          spec_requests(cfg.vocab, Request, SPEC_DRAFT_REQUESTS, ZAMBA_SPEC_GEN)),
                      check(SPEC_DRAFT_REQUESTS, fused=True, spec=True, gen=ZAMBA_SPEC_GEN),
                      True)
    jit = out["8d"]["graphs"]["jit_cache"]
    if jit.get("commit_paged", 0) <= 0:
        raise AssertionError(f"phase 8d: the graphs run captured no paged commit: {jit}")
    spec = out["8d"]["report"]["spec"]
    out["8d"]["spec"] = {k: spec[k] for k in ("verify_steps", "decode_steps", "drafted_tokens",
                                              "accepted_tokens", "accepted_rate",
                                              "mean_accepted_span")}
    print(f"[phase8d] speculative fused paged serve {ZAMBA_ARCH} on {gpu}: "
          f"{json.dumps(out['8d']['spec'])}, jit_cache {jit}; launches of the pair "
          f"{out['8d']['launches']}; phase {out['8d']['seconds']:.1f} s", flush=True)
    for r in out.values():
        r.pop("report")
    return out


def zamba_profile_phase(dev, model, params, gpu: str) -> dict:
    """Phase 4's step table for zamba2-7b (run in phase 8, where its model
    lives, at ZAMBA_SERVE_LAYERS of its layers), through the engine's step
    code (serve/graphs.py) at batch
    PROFILE_BATCH and position PROFILE_FILL, captured and eager, by
    _profile: the lane decode step, the fused paged decode step, and the
    fused paged verify step of a span SPEC_K + 1 followed by its commit on
    the pools (every slot committing the whole span). Not a main path: its
    launches are not counted."""
    import numpy as np
    import torch

    from repro_torch.serve import StepGraphs, disable_graphs
    from repro_torch.serve.graphs import run_commit, run_model_step

    cfg = model.cfg
    rng = np.random.default_rng(22)
    state = model.init_decode_state(PROFILE_BATCH, PROFILE_FILL + PROFILE_GEN)
    tokens = rng.integers(0, cfg.vocab, (PROFILE_BATCH, 1))
    span = rng.integers(0, cfg.vocab, (PROFILE_BATCH, SPEC_K + 1))
    pos = np.full(PROFILE_BATCH, PROFILE_FILL, np.int64)
    n_commit = np.full(PROFILE_BATCH, SPEC_K + 1, np.int64)
    lane, fused = StepGraphs(dev), StepGraphs(dev)
    out = {}
    with torch.inference_mode():
        tails, pools, tables = paged_state(dev, model, params, PROFILE_BATCH,
                                                 PROFILE_FILL, seed=23)
        tables = tables.cpu().numpy()
        paged = {"pools": pools, "tables": tables}

        def verify_commit():
            logits = run_model_step(fused, "verify", model, params, tails, span, pos, **paged)
            run_commit(fused, model, params, tails, span, pos, n_commit, **paged)
            return logits

        steps = {"zamba_decode_step": lambda: run_model_step(lane, "decode", model, params,
                                                             state, tokens, pos),
                 "zamba_decode_step_paged": lambda: run_model_step(
                     fused, "decode", model, params, tails, tokens, pos, **paged),
                 "zamba_verify_commit_paged": verify_commit}
        for kind, fn in steps.items():
            def eager(fn=fn):
                with disable_graphs():
                    return fn()
            out[kind] = {"batch": PROFILE_BATCH, "pos": PROFILE_FILL,
                         "span": SPEC_K + 1 if "verify" in kind else 1,
                         "captured": _profile(fn, host_top=False),
                         "eager": _profile(eager, host_top=False)}
    out["jit_cache"] = {"lane": lane.sizes(("decode",)),
                        "fused": fused.sizes(("decode", "verify", "commit_paged"))}
    for kind in steps:
        c, e = out[kind]["captured"], out[kind]["eager"]
        print(f"[phase4] {kind} ({ZAMBA_ARCH}, {cfg.n_layers} layers) on {gpu}, captured vs "
              f"eager: host wall "
              f"{c['wall_ms']:.3f} vs {e['wall_ms']:.3f} ms, device busy "
              f"{c['device_busy_ms']} vs {e['device_busy_ms']} ms, idle share "
              f"{c.get('device_idle_share')} vs {e.get('device_idle_share')}, kernels per "
              f"step {c['launches']} vs {e['launches']}; top kernels (captured) "
              f"{json.dumps(c.get('top_kernels_ms'))}", flush=True)
    return out


def zamba_phase(dev, gpu: str) -> dict:
    """Phase 8: zamba2-7b at full width (81 layers: 13 groups of 6 Mamba2
    layers, each followed by the one shared attention block, then 3; d 3584,
    32 attention heads of 112, d_inner 7168 in 112 SSD heads of 64, N 64,
    conv 4, vocab 32000, bf16), seeded weights from the port's init on the
    card: 8a the main path and the layers, 8b-8d serving, and its rows of
    phase 4's step table. Every earlier model is freed before it."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.nn.model import ZambaModel, build_model
    from repro_torch.nn.zamba import layout
    from repro_torch.train.optimizer import tree_leaves, tree_map

    t_phase = time.perf_counter()
    cfg = get_config(ZAMBA_ARCH)
    model = build_model(cfg, device=dev)
    assert isinstance(model, ZambaModel) and model.lib.TARGET_NAME == "h100"
    params = model.init(0)
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    one = model.init_decode_state(1, 1)
    tail_slot = sum(t.numel() * t.element_size() for n, t in one.items()
                    if not n.startswith("attn"))
    kv_token = sum(t.numel() * t.element_size() for n, t in one.items() if n.startswith("attn"))
    f32_leaves = sorted({n for n in ("A_log", "dt_bias", "D_skip")
                         if params["groups"]["mamba"][n].dtype == torch.float32})
    print(f"[phase8] {ZAMBA_ARCH} on {gpu}: {n_params / 1e9:.4f}B params "
          f"({sum(t.numel() * t.element_size() for t in leaves) / 1e9:.3f} GB), layout "
          f"{layout(cfg)}, float32 leaves {f32_leaves}, a decode-state slot "
          f"{tail_slot / 1e6:.2f} MB of tails + {kv_token / 1e3:.1f} KB of KV a token; init "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    out = {"params": n_params, "tail_slot_bytes": tail_slot, "kv_token_bytes": kv_token}
    t0 = time.perf_counter()
    params32 = tree_map(lambda x: x.float(), params)     # 26.4 GB, 8a's alone
    with torch.inference_mode():
        out["8a"] = zamba_layers_phase(dev, model, params, params32, gpu)
    del params32
    torch.cuda.empty_cache()
    out["8a"]["seconds"] = time.perf_counter() - t0
    out.update(zamba_serve_phase(dev, params, gpu))
    t0 = time.perf_counter()
    saved = read_counts()
    # phase 4's rows at 8c's and 8d's depth, widths kept
    cut_cfg, cut = zamba_cut(cfg, params, ZAMBA_SERVE_LAYERS)
    out["phase4"] = zamba_profile_phase(dev, build_model(cut_cfg, device=dev), cut, gpu)
    for name, fn in counters().items():
        fn.launches = saved[name]
    out["phase4"]["seconds"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[phase8] {ZAMBA_ARCH} done on {gpu}: phase {out['seconds']:.1f} s (8a "
          f"{out['8a']['seconds']:.1f}, 8b {out['8b']['seconds']:.1f}, 8c "
          f"{out['8c']['seconds']:.1f}, 8d {out['8d']['seconds']:.1f}, phase 4's rows "
          f"{out['phase4']['seconds']:.1f})", flush=True)
    return out


def whisper_launch_check(cfg, launched, report, *, fused: bool) -> list:
    """The problems of one whisper serve's launch counts. The flash kernel
    launches n_enc_layers times for each request's first chunk (the encoder,
    non-causal over enc_len frames; a prefix hit skips it, a preemption's
    continuation that misses runs it again) and n_layers times a prefill
    chunk, decode step and verify step (the cross-attention, non-causal over
    enc_len keys). The paged kernel launches n_layers times a fused decode or
    verify step, never in lanes; rmsnorm and swiglu never (layernorm and gelu
    are plain torch, as jnp in the reference)."""
    chunks = sum(e["chunks"] for e in report["step_log"])
    spec = report.get("spec") or {}
    verify = spec.get("verify_steps", 0)
    decode = sum(e["decoded"] > 0 for e in report["step_log"]) - verify
    paged = report.get("paged") or {}
    first = report["requests"] + paged.get("preemptions", 0) - paged.get("prefix_hits", 0)
    want = {"flash_attention": cfg.n_enc_layers * first
            + cfg.n_layers * (chunks + decode + verify),
            "paged_attention": cfg.n_layers * (decode + verify) if fused else 0,
            "rmsnorm": 0, "swiglu": 0}
    return [f"{name} launched {launched[name]} times, want {n} ({first} first chunks, "
            f"{chunks} prefill chunks, {decode} decode steps, {verify} verify steps)"
            for name, n in want.items() if launched[name] != n]


def whisper_frames(rng, n: int, d: int) -> list:
    """``n`` seeded (WHISPER_ENC_LEN, d) float32 frame embeddings (the conv
    frontend's output: a stub in the reference too)."""
    import numpy as np

    return [rng.standard_normal((WHISPER_ENC_LEN, d), dtype=np.float32) for _ in range(n)]


def whisper_requests(vocab: int, d: int, request_cls, n: int, seed: int = 41) -> list:
    """9b: ``n`` requests of WHISPER_PROMPT seeded tokens over their own
    seeded frames, WHISPER_GEN generated."""
    import numpy as np

    rng = np.random.default_rng(seed)
    frames = whisper_frames(rng, n, d)
    return [request_cls(rid=f"w{i}", tokens=rng.integers(0, vocab, WHISPER_PROMPT)
                        .astype(np.int32), gen_len=WHISPER_GEN, embeds=frames[i])
            for i in range(n)]


def whisper_paged_requests(vocab: int, d: int, request_cls) -> list:
    """9c: WHISPER_PAGED_REQUESTS requests in groups of four over one
    prompt: a (frames A), a clip transcribed twice (A again), b (frames B:
    a twin of the first that differs only in its frames), and b again. Each
    shares its first WHISPER_SHARED rows: the repeats hit the prefix store,
    the first and the twin of other frames miss."""
    import numpy as np

    rng = np.random.default_rng(43)
    out = []
    for grp in range(WHISPER_PAGED_REQUESTS // 4):
        toks = rng.integers(0, vocab, WHISPER_PROMPT).astype(np.int32)
        fa, fb = whisper_frames(rng, 2, d)
        for name, frames in (("a", fa), ("a2", fa), ("b", fb), ("b2", fb)):
            out.append(request_cls(rid=f"c{grp}{name}", tokens=toks.copy(),
                                   gen_len=WHISPER_GEN, embeds=frames,
                                   shared_prefix_len=WHISPER_SHARED))
    return out


def whisper_paged_check(dev, runs, frames) -> dict:
    """9a, paged: one fused paged decode step and one verify span of
    SPEC_K + 1 at batch WHISPER_BATCH over WHISPER_FILL prefilled rows (page
    WHISPER_PAGE; the cross K/V tails from ``frames``), per (label, model,
    params, rel_l2) of ``runs``: every paged call (the self-attention) and
    every flash call (the cross-attention at Sq 1 and SPEC_K + 1 against
    enc_len keys) against its plain version on the operands the step gives
    it (_Compared, TOLERANCE); the whole step's logits against the step
    through the plain versions on copies of the same tails and pools, under
    _require_logits at ``rel_l2``; row 0 of the span against the decode step
    at the same bound."""
    import torch

    from repro_torch.kernels.flash_attention.ref import attention
    from repro_torch.kernels.paged.ref import paged_attention_ref
    from repro_torch.nn import encdec

    batch, fill = WHISPER_BATCH, WHISPER_FILL
    plain = {"attention_decode_paged": paged_attention_ref,
             "attention_verify_paged": paged_attention_ref, "flash_attention": attention}
    out = {"batch": batch, "kv_len": fill + 1, "span": SPEC_K + 1, "page": WHISPER_PAGE}
    for label, m, p, rel_l2 in runs:
        cfg, vocab = m.cfg, m.cfg.padded_vocab
        g = torch.Generator(device=dev).manual_seed(34)
        span = torch.randint(0, cfg.vocab, (batch, SPEC_K + 1), generator=g, device=dev)
        pos = torch.full((batch,), fill, dtype=torch.int64, device=dev)
        tails, pools, tables = paged_state(
            dev, m, p, batch, fill, seed=33, max_len=fill + 2 * WHISPER_PAGE,
            page=WHISPER_PAGE, extra={"audio_embeds": frames.to(m.dtype)})
        compared = _Compared(m.tsl, plain, f"phase 9a {label} fused paged step")
        steps = (("decode", encdec.encdec_decode_step_paged, span[:, :1]),
                 ("verify", encdec.encdec_verify_step_paged, span))
        logits = {}
        for name, tsl in (("kernel", compared), ("plain", _PlainOps(m.tsl, plain))):
            for kind, fn, toks in steps:
                st = {n: t.clone() for n, t in tails.items()}
                pl = {n: t.clone() for n, t in pools.items()}
                logits[name, kind] = fn(tsl, p, st, pl, tables, toks, pos, cfg)[0].reshape(
                    -1, vocab)
        r = {kind: _logits_check(logits["kernel", kind], logits["plain", kind], cfg.vocab)
             for kind, _, _ in steps}
        r["verify_row0_vs_decode"] = _logits_check(
            logits["kernel", "verify"].reshape(batch, -1, vocab)[:, 0],
            logits["kernel", "decode"], cfg.vocab)
        r["kernel_calls_vs_plain"] = _worst(compared.results)
        if r["kernel_calls_vs_plain"]["calls"] != 4 * cfg.n_layers:
            raise AssertionError(f"phase 9a {label}: {r['kernel_calls_vs_plain']['calls']} "
                                 f"paged and flash calls compared, want {4 * cfg.n_layers}")
        for kind in ("decode", "verify", "verify_row0_vs_decode"):
            _require_logits(f"phase 9a {label} fused paged {kind}, kernel vs plain", r[kind],
                            rel_l2=rel_l2)
        out[label] = r
        del tails, pools
    return out


def whisper_layers_phase(dev, model, params, params32, gpu: str) -> dict:
    """Phase 9a: whisper-tiny's main path and its layers against the plain
    versions on the card.

    The main path, counted (the counters set to 0 just before it and read
    just after): Model.prefill of WHISPER_PREFILL decoder tokens over
    (batch, WHISPER_ENC_LEN, d) seeded frames through the h100 library (the
    flash kernel n_enc_layers times non-causal over the frames, n_layers
    times causal over the tokens and n_layers times as the cross-attention:
    12, gated exactly), then WHISPER_DECODE_STEPS greedy bf16 decode steps
    (the flash kernel n_layers times each, the cross-attention at Sq 1),
    each against the torch_cpu library's step from a copy of the same state
    (phase 2's bar: _require_logits, LOGITS_REL_L2 and the argmax verdicts);
    the prefill too.

    Then, not counted:
    * the flash kernel against its plain version at each call of a bf16
      and a float32 prefill (12), a decode step (4) and a first prefill
      chunk of 64 tokens into a batch-1 donor (the encoder at (1, 6, 1500,
      1500) and the cross-attention at Sq 64: 8), on the operands the model
      gives it (_Compared, TOLERANCE);
    * the float32 model at full depth on both libraries: one prefill and
      WHISPER_DECODE_STEPS decode steps, each library on its own state,
      every row within WHISPER_F32_REL_L2 (8 layers: no amplification to
      stand in the way, unlike zamba2-7b's 81);
    * whisper_paged_check: the fused paged decode and verify steps, bf16
      (LOGITS_REL_L2) and float32 (WHISPER_F32_REL_L2)."""
    import torch

    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.nn import encdec
    from repro_torch.nn.model import build_model

    cfg = model.cfg
    plain = build_model(cfg, device=dev, target="torch_cpu")
    b, t = WHISPER_PREFILL
    max_len = t + WHISPER_DECODE_STEPS
    g = torch.Generator(device=dev).manual_seed(31)
    tokens = torch.randint(0, cfg.vocab, (b, t), generator=g, device=dev)
    frames = torch.randn((b, WHISPER_ENC_LEN, cfg.d_model), generator=g, device=dev)
    batch = {"tokens": tokens, "audio_embeds": frames.to(model.dtype)}
    per_prefill = cfg.n_enc_layers + 2 * cfg.n_layers
    out, checks = {}, {}

    # the main path: prefill + decode steps through the kernels, counted
    for fn in counters().values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, state = model.prefill(params, batch, max_len)
    torch.cuda.synchronize()
    out["prefill_s"] = time.perf_counter() - t0
    out["prefill_launches"] = read_counts()
    if out["prefill_launches"]["flash_attention"] != per_prefill \
            or out["prefill_launches"]["paged_attention"]:
        raise AssertionError(f"phase 9a: launches per prefill {out['prefill_launches']}, "
                             f"want flash {per_prefill} and paged 0")
    want, _ = plain.prefill(params, batch, max_len)
    checks["bf16_prefill"] = _logits_check(got, want, cfg.vocab)
    toks = got[:, :cfg.vocab].argmax(-1)
    generated = []
    for i in range(WHISPER_DECODE_STEPS):
        shared = {n: x.clone() for n, x in state.items()}
        before = read_counts()
        got, state = model.decode_step(params, state, toks[:, None], t + i)
        after = read_counts()
        step = {k: after[k] - before[k] for k in after}
        if step["flash_attention"] != cfg.n_layers or step["paged_attention"]:
            raise AssertionError(f"phase 9a: decode step {i} launched {step}, want flash "
                                 f"{cfg.n_layers} and paged 0")
        want, _ = plain.decode_step(params, shared, toks[:, None], t + i)
        checks[f"bf16_decode_{i}"] = _logits_check(got, want, cfg.vocab)
        toks = got[:, :cfg.vocab].argmax(-1)
        generated.append(toks.tolist())
    out["decode_step_launches"] = step
    if tuple(got.shape) != (b, cfg.padded_vocab):
        raise AssertionError(f"phase 9a: decode logits {tuple(got.shape)}")
    out["launches"] = read_counts()
    out["greedy_tokens"] = generated
    for name, c in checks.items():
        _require_logits(f"phase 9a {name}, h100 vs torch_cpu library", c)
    del state, shared
    saved = read_counts()

    # the flash kernel in context, bf16 and float32: a prefill, a decode
    # step and a first prefill chunk, call by call
    cfg32 = cfg.replace(dtype="float32")
    m32 = build_model(cfg32, device=dev)
    calls = {}
    for label, m, p in (("bf16", model, params), ("f32", m32, params32)):
        fr = frames.to(m.dtype)
        compared = _Compared(m.tsl, {"flash_attention": flash_ref.attention},
                             f"phase 9a {label}")
        _, st = encdec.encdec_prefill(compared, p, tokens, cfg, audio_embeds=fr,
                                      max_len=max_len)
        encdec.encdec_decode_step(compared, p, st, tokens[:, :1], t, cfg)
        donor = m.init_decode_state(1, max_len, enc_len=WHISPER_ENC_LEN)
        encdec.encdec_prefill_chunk(compared, p, donor, tokens[:1], 0, cfg,
                                    audio_embeds=fr[:1])
        calls[label] = _worst(compared.results)
        want_calls = per_prefill + cfg.n_layers + cfg.n_enc_layers + cfg.n_layers
        if calls[label]["calls"] != want_calls:
            raise AssertionError(f"phase 9a {label}: {calls[label]['calls']} flash calls "
                                 f"compared, want {want_calls}")
        del st, donor
    out["flash_calls_vs_plain"] = calls

    # float32 at full depth: prefill and decode steps, each library on its
    # own state
    pc = build_model(cfg32, device=dev, target="torch_cpu")
    batch32 = {"tokens": tokens, "audio_embeds": frames}
    got, st = m32.prefill(params32, batch32, max_len)
    want, pst = pc.prefill(params32, batch32, max_len)
    checks["f32_prefill"] = _logits_check(got, want, cfg.vocab)
    toks = got[:, :cfg.vocab].argmax(-1)
    for i in range(WHISPER_DECODE_STEPS):
        got, st = m32.decode_step(params32, st, toks[:, None], t + i)
        want, pst = pc.decode_step(params32, pst, toks[:, None], t + i)
        checks[f"f32_decode_{i}"] = _logits_check(got, want, cfg.vocab)
        toks = got[:, :cfg.vocab].argmax(-1)
    del st, pst
    for name, c in checks.items():
        if name.startswith("f32"):
            _require_logits(f"phase 9a whisper {name}, h100 vs torch_cpu library", c,
                            rel_l2=WHISPER_F32_REL_L2)
    out["logits"] = checks
    out["paged"] = whisper_paged_check(dev, [("bf16", model, params, LOGITS_REL_L2),
                                             ("f32", m32, params32, WHISPER_F32_REL_L2)],
                                       frames)
    torch.cuda.empty_cache()
    for name, fn in counters().items():      # kernel vs plain: not a main path
        fn.launches = saved[name]

    def worst(prefix):
        return max(c["logits_rel_l2"] for n, c in checks.items() if n.startswith(prefix))

    pg = out["paged"]
    print(f"[phase9a] {WHISPER_ARCH} prefill {WHISPER_PREFILL} over {WHISPER_ENC_LEN} frames "
          f"({out['prefill_s']:.3f} s, first call) + {WHISPER_DECODE_STEPS} decode steps on "
          f"{gpu}: launches per prefill {out['prefill_launches']}, per decode step "
          f"{out['decode_step_launches']}, main path {out['launches']}; bf16 h100 vs torch_cpu "
          f"rel L2 prefill {checks['bf16_prefill']['logits_rel_l2']:.3g}, decode steps worst "
          f"{worst('bf16_decode'):.3g} (bound {LOGITS_REL_L2}, argmax verdicts), failed "
          f"argmax rows none; float32 worst rel L2 {worst('f32'):.3g} (bound "
          f"{WHISPER_F32_REL_L2}); flash kernel vs plain at each call of a prefill, a decode "
          f"step and a first chunk: {json.dumps(calls)}; fused paged steps, paged and flash "
          f"calls vs plain: bf16 {json.dumps(pg['bf16']['kernel_calls_vs_plain'])}, float32 "
          f"{json.dumps(pg['f32']['kernel_calls_vs_plain'])}, whole step kernel vs plain rel "
          f"L2 bf16 decode {pg['bf16']['decode']['logits_rel_l2']:.3g}, verify "
          f"{pg['bf16']['verify']['logits_rel_l2']:.3g}, float32 decode "
          f"{pg['f32']['decode']['logits_rel_l2']:.3g}, verify "
          f"{pg['f32']['verify']['logits_rel_l2']:.3g}; {json.dumps(checks)}; paged "
          f"{json.dumps(pg)}", flush=True)
    return out


def whisper_first_difference(dev, cfg, params, requests, lane: dict, paged: dict,
                             differ: dict, n: int = 4) -> dict:
    """The argmax verdict at the first token where a fused paged request's
    output parts from lane mode's, for the ``n`` earliest partings: the
    request replayed at batch 1 through the h100 library in lane mode (the
    plain decode attention, as lane mode's) on the common history, and the
    plain gap between lane mode's token and the paged run's at that step
    against TIE_ULPS bf16 ulps at the row's largest |logit| (argmax_verdicts'
    tau). Information: the replay's roundings (batch 1, whole-prompt
    prefill) are not the serve's."""
    import torch

    from repro_torch.nn.model import build_model

    model = build_model(cfg, device=dev)
    by_rid = {r.rid: r for r in requests}
    out = {}
    for rid, j in sorted(differ.items(), key=lambda kv: kv[1])[:n]:
        r = by_rid[rid]
        batch = {"tokens": torch.as_tensor(r.tokens, device=dev).long()[None],
                 "audio_embeds": torch.as_tensor(r.embeds, device=dev)[None].to(model.dtype)}
        logits, st = model.prefill(params, batch, WHISPER_PROMPT + WHISPER_GEN)
        for i in range(j):
            tok = torch.tensor([[lane[rid][i]]], device=dev)
            logits, st = model.decode_step(params, st, tok, WHISPER_PROMPT + i)
        row = logits.float()[0, :cfg.vocab]
        gap = (row[lane[rid][j]] - row[paged[rid][j]]).item()
        tau = TIE_ULPS * bf16_ulp(row.abs().max().item())
        out[rid] = {"token": j, "lane": lane[rid][j], "paged": paged[rid][j],
                    "replay_argmax": int(row.argmax()), "plain_gap": gap, "tau": tau,
                    "verdict": "within a tie" if abs(gap) <= tau else "beyond a tie"}
    return out


def whisper_serve_phase(dev, params, gpu: str) -> dict:
    """Phases 9b-9d: whisper-tiny served at full width with enc_len
    WHISPER_ENC_LEN, each serve a paired_serve (captured and eager: equal
    outputs, counters and launches; both sides untraced) under
    whisper_launch_check, the counters set to 0 just before each pair and
    read just after it.
    9b lane mode: WHISPER_REQUESTS requests of WHISPER_PROMPT tokens over
       their own seeded frames, WHISPER_GEN generated (256 rows of Whisper's
       448-token decoder context), WHISPER_BATCH slots, chunks of
       WHISPER_CHUNK: the first chunk's captured step runs the encoder.
    9c fused paged mode (page and chunk WHISPER_PAGE) on
       whisper_paged_requests: the cross K/V tails in the slot table, the
       self-attention off the pools (n_layers paged launches a decode step);
       the 16 repeats hit the prefix store (plus one hit a preemption's
       continuation) and the 16 firsts and twins of other frames miss,
       exactly. Against a lane-mode run of the same requests: every first
       token equal (prefill is the same code in both; a prefix hit restores
       its rows and cross K/V bit for bit), the rest printed (lane mode
       attends by the plain decode attention, paged by the kernel: bf16
       roundings may flip a near-tied argmax, which the per-call gates of 9a
       bound; whisper_first_difference prints the argmax verdict where the
       earliest four part), and so is the sameness of each clip transcribed
       twice.
    9d the n-gram drafter at fixed depth SPEC_K on SPEC_DRAFT_REQUESTS of
       phase 3e(ii)'s pattern prompts over seeded frames, fused paged: verify
       steps run, their cross-attention the flash kernel at Sq SPEC_K + 1."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.serve import PagedConfig, Request, ServeEngine, SpeculationConfig

    cfg = get_config(WHISPER_ARCH)
    kw = dict(batch=WHISPER_BATCH, max_len=WHISPER_PROMPT + WHISPER_GEN, device=dev,
              params=params, enc_len=WHISPER_ENC_LEN)
    out = {}

    def check(n_req, fused, gen=WHISPER_GEN, spec=False):
        def run_check(report, launched):
            problems = []
            if report["target"] != "h100":
                problems.append(f"served with target {report['target']!r}")
            if report["requests"] != n_req or report["refused"]:
                problems.append(f"{report['requests']} of {n_req} answered, refused "
                                f"{report['refused']}")
            short = {r: len(t) for r, t in report["outputs"].items() if len(t) != gen}
            if short or len(report["outputs"]) != n_req:
                problems.append(f"requests without {gen} tokens: {short}")
            if spec and not report["spec"]["verify_steps"]:
                problems.append("no verify step ran")
            if fused:
                # more requests than slots park, and activate by a tail restore
                paged = report["paged"]
                parked = n_req > WHISPER_BATCH
                if not paged["fused"] or paged["lane_activations"] or \
                        parked != (paged["tail_restores"] > 0):
                    problems.append(f"paged: fused {paged['fused']}, lane activations "
                                    f"{paged['lane_activations']}, tail restores "
                                    f"{paged['tail_restores']}")
            return problems + whisper_launch_check(cfg, launched, report, fused=fused)
        return run_check

    def serve(tag, name, run, run_check, graphs_first):
        for fn in counters().values():
            fn.launches = 0
        t0 = time.perf_counter()
        pair = paired_serve(tag, name, gpu, run, run_check, graphs_first, trace=())
        pair["launches"] = read_counts()
        pair["seconds"] = time.perf_counter() - t0
        return pair

    out["9b"] = serve("phase9b", f"lane serve {WHISPER_ARCH}, enc_len {WHISPER_ENC_LEN}",
                      lambda: ServeEngine(cfg, prefill_chunk=WHISPER_CHUNK, **kw).run(
                          whisper_requests(cfg.vocab, cfg.d_model, Request,
                                           WHISPER_REQUESTS)),
                      check(WHISPER_REQUESTS, fused=False), True)
    jit = out["9b"]["graphs"]["jit_cache"]
    if jit != {"prefill_chunk": 1 + (WHISPER_PROMPT > WHISPER_CHUNK), "decode": 1}:
        raise AssertionError(f"phase 9b: the graphs run captured {jit}")
    steps = out["9b"]["report"]["step_log"]
    print(f"[phase9b] lane serve {WHISPER_ARCH} on {gpu}: decode steps "
          f"{sum(e['decoded'] > 0 for e in steps)}, prefill chunks "
          f"{sum(e['chunks'] for e in steps)}, jit_cache {jit}, launches of the pair "
          f"{out['9b']['launches']}; phase {out['9b']['seconds']:.1f} s", flush=True)

    paged_kw = dict(kw, prefill_chunk=WHISPER_PAGED_CHUNK)

    def requests():
        return whisper_paged_requests(cfg.vocab, cfg.d_model, Request)

    out["9c"] = serve("phase9c", f"fused paged serve {WHISPER_ARCH}",
                      lambda: ServeEngine(cfg, paged=PagedConfig(page_size=WHISPER_PAGE),
                                          **paged_kw).run(requests()),
                      check(WHISPER_PAGED_REQUESTS, fused=True), False)
    t0 = time.perf_counter()
    report = out["9c"]["report"]
    pg = report["paged"]
    n_miss = WHISPER_PAGED_REQUESTS // 2
    if pg["prefix_misses"] != n_miss or \
            pg["prefix_hits"] != WHISPER_PAGED_REQUESTS - n_miss + pg["preemptions"]:
        raise AssertionError(f"phase 9c: {pg['prefix_hits']} prefix hits and "
                             f"{pg['prefix_misses']} misses with {pg['preemptions']} "
                             f"preemptions, want {WHISPER_PAGED_REQUESTS - n_miss} + "
                             f"preemptions and {n_miss}")
    lane = ServeEngine(cfg, **paged_kw).run(requests())
    outs = report["outputs"]
    firsts = [r for r in outs if outs[r][0] != lane["outputs"][r][0]]
    if firsts:
        raise AssertionError(f"phase 9c: first tokens differ from lane mode's for {firsts}")
    differ = {r: next(i for i, (x, y) in enumerate(zip(lane["outputs"][r], toks)) if x != y)
              for r, toks in outs.items() if toks != lane["outputs"][r]}
    verdicts = whisper_first_difference(dev, cfg, params, requests(), lane["outputs"], outs,
                                        differ)
    twins = {r[:-1] for r in outs if r.endswith("2")}
    same_twice = sum(outs[f"{r}"] == outs[f"{r}2"] for r in twins)
    other_frames = sum(outs[r[:-1] + "a"] != outs[r[:-1] + "b"] for r in outs
                       if r.endswith("a"))
    out["9c"].update(lane_decode_tokens_per_s=lane["decode_tokens_per_s"],
                     share_equal_to_lane=1 - len(differ) / WHISPER_PAGED_REQUESTS,
                     first_differing_token=differ, first_difference_verdicts=verdicts,
                     clips_equal_twice=same_twice,
                     twins_of_other_frames_differing=other_frames)
    out["9c"]["seconds"] += time.perf_counter() - t0
    print(f"[phase9c] fused paged serve {WHISPER_ARCH} on {gpu}: prefix hits "
          f"{pg['prefix_hits']}, misses {pg['prefix_misses']}, preemptions "
          f"{pg['preemptions']}; first tokens of all {WHISPER_PAGED_REQUESTS} equal a "
          f"lane-mode run's; whole outputs equal for "
          f"{WHISPER_PAGED_REQUESTS - len(differ)}/{WHISPER_PAGED_REQUESTS} (information; "
          f"first differing token of the others {differ}; the argmax verdict there, "
          f"replayed at batch 1 through the plain decode attention: {json.dumps(verdicts)}); "
          f"clips transcribed twice with "
          f"equal outputs {same_twice}/{len(twins)}, twins of other frames with other "
          f"outputs {other_frames}/{len(twins) // 2}; lane {lane['decode_tokens_per_s']:.1f} "
          f"tokens/s; paged {json.dumps(pg)}; launches of the pair {out['9c']['launches']}; "
          f"phase {out['9c']['seconds']:.1f} s", flush=True)

    def spec_reqs():
        reqs = spec_requests(cfg.vocab, Request, SPEC_DRAFT_REQUESTS)
        frames = whisper_frames(np.random.default_rng(45), len(reqs), cfg.d_model)
        for r, f in zip(reqs, frames):
            r.embeds = f
        return reqs

    spec_kw = dict(kw, max_len=SPEC_PROMPT + PAGED_GEN, prefill_chunk=PAGED_CHUNK)
    out["9d"] = serve("phase9d", f"speculative fused paged serve {WHISPER_ARCH}, n-gram "
                      f"depth {SPEC_K}",
                      lambda: ServeEngine(cfg, paged=PagedConfig(page_size=WHISPER_PAGE),
                                          speculation=SpeculationConfig(fixed_k=SPEC_K),
                                          **spec_kw).run(spec_reqs()),
                      check(SPEC_DRAFT_REQUESTS, fused=True, gen=PAGED_GEN, spec=True), True)
    jit = out["9d"]["graphs"]["jit_cache"]
    if jit.get("verify", 0) <= 0:
        raise AssertionError(f"phase 9d: the graphs run captured no verify step: {jit}")
    spec = out["9d"]["report"]["spec"]
    out["9d"]["spec"] = {k: spec[k] for k in ("verify_steps", "decode_steps", "drafted_tokens",
                                              "accepted_tokens", "accepted_rate",
                                              "mean_accepted_span")}
    print(f"[phase9d] speculative fused paged serve {WHISPER_ARCH} on {gpu}: "
          f"{json.dumps(out['9d']['spec'])}, jit_cache {jit}; launches of the pair "
          f"{out['9d']['launches']}; phase {out['9d']['seconds']:.1f} s", flush=True)
    for r in out.values():
        r.pop("report")
    return out


def whisper_profile_phase(dev, model, params, gpu: str) -> dict:
    """Phase 4's step table for whisper-tiny (run in phase 9, where its model
    lives), through the engine's step code (serve/graphs.py) at batch
    WHISPER_BATCH and position PROFILE_FILL, cross K/V of WHISPER_ENC_LEN
    rows, captured and eager, by _profile: the lane decode step and the
    fused paged decode step (page WHISPER_PAGE). Not a main path: its
    launches are not counted."""
    import numpy as np
    import torch

    from repro_torch.serve import StepGraphs, disable_graphs
    from repro_torch.serve.graphs import run_model_step

    cfg = model.cfg
    rng = np.random.default_rng(42)
    state = model.init_decode_state(WHISPER_BATCH, PROFILE_FILL + PROFILE_GEN,
                                    enc_len=WHISPER_ENC_LEN)
    for leaf in state.values():
        leaf.normal_(generator=torch.Generator(device=dev).manual_seed(44))
    tokens = rng.integers(0, cfg.vocab, (WHISPER_BATCH, 1))
    pos = np.full(WHISPER_BATCH, PROFILE_FILL, np.int64)
    frames = torch.randn((WHISPER_BATCH, WHISPER_ENC_LEN, cfg.d_model),
                         generator=torch.Generator(device=dev).manual_seed(46), device=dev)
    lane, fused = StepGraphs(dev), StepGraphs(dev)
    out = {}
    with torch.inference_mode():
        tails, pools, tables = paged_state(
            dev, model, params, WHISPER_BATCH, PROFILE_FILL, seed=47,
            max_len=PROFILE_FILL + PROFILE_GEN, page=WHISPER_PAGE,
            extra={"audio_embeds": frames.to(model.dtype)})
        tables = tables.cpu().numpy()
        steps = {"whisper_decode_step": lambda: run_model_step(lane, "decode", model, params,
                                                               state, tokens, pos),
                 "whisper_decode_step_paged": lambda: run_model_step(
                     fused, "decode", model, params, tails, tokens, pos, pools=pools,
                     tables=tables)}
        for kind, fn in steps.items():
            def eager(fn=fn):
                with disable_graphs():
                    return fn()
            out[kind] = {"batch": WHISPER_BATCH, "pos": PROFILE_FILL,
                         "enc_len": WHISPER_ENC_LEN,
                         "captured": _profile(fn, host_top=False),
                         "eager": _profile(eager, host_top=False)}
    out["jit_cache"] = {"lane": lane.sizes(("decode",)), "fused": fused.sizes(("decode",))}
    for kind in steps:
        c, e = out[kind]["captured"], out[kind]["eager"]
        print(f"[phase4] {kind} ({WHISPER_ARCH}) on {gpu}, captured vs eager: host wall "
              f"{c['wall_ms']:.3f} vs {e['wall_ms']:.3f} ms, device busy "
              f"{c['device_busy_ms']} vs {e['device_busy_ms']} ms, idle share "
              f"{c.get('device_idle_share')} vs {e.get('device_idle_share')}, kernels per "
              f"step {c['launches']} vs {e['launches']}; top kernels (captured) "
              f"{json.dumps(c.get('top_kernels_ms'))}", flush=True)
    return out


def whisper_phase(dev, gpu: str) -> dict:
    """Phase 9: whisper-tiny at full width (4 encoder and 4 decoder layers,
    d 384, 6 heads of 64, d_ff 1536, vocab 51865 padded to 51968,
    layernorm, gelu, bf16) over WHISPER_ENC_LEN frames, seeded weights from
    the port's init on the card: 9a the main path and the layers, 9b-9d
    serving, and its rows of phase 4's step table."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.nn.model import EncDecModel, build_model
    from repro_torch.train.optimizer import tree_leaves, tree_map

    t_phase = time.perf_counter()
    cfg = get_config(WHISPER_ARCH)
    model = build_model(cfg, device=dev)
    assert isinstance(model, EncDecModel) and model.lib.TARGET_NAME == "h100"
    params = model.init(0)
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    one = model.init_decode_state(1, 1, enc_len=WHISPER_ENC_LEN)
    cross_slot = sum(t.numel() * t.element_size() for n, t in one.items()
                     if n.startswith("cross"))
    kv_token = sum(t.numel() * t.element_size() for n, t in one.items() if n in ("k", "v"))
    print(f"[phase9] {WHISPER_ARCH} on {gpu}: {n_params / 1e6:.3f}M params "
          f"({sum(t.numel() * t.element_size() for t in leaves) / 1e6:.2f} MB; the "
          f"reference's param_count {cfg.param_count() / 1e6:.3f}M), a decode-state slot "
          f"{cross_slot / 1e6:.3f} MB of cross K/V at enc_len {WHISPER_ENC_LEN} + "
          f"{kv_token / 1e3:.3f} KB of self K/V a token; init "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    out = {"params": n_params, "cross_slot_bytes": cross_slot, "kv_token_bytes": kv_token}
    t0 = time.perf_counter()
    params32 = tree_map(lambda x: x.float(), params)
    with torch.inference_mode():
        out["9a"] = whisper_layers_phase(dev, model, params, params32, gpu)
    del params32
    out["9a"]["seconds"] = time.perf_counter() - t0
    out.update(whisper_serve_phase(dev, params, gpu))
    t0 = time.perf_counter()
    saved = read_counts()
    out["phase4"] = whisper_profile_phase(dev, model, params, gpu)
    for name, fn in counters().items():
        fn.launches = saved[name]
    out["phase4"]["seconds"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[phase9] {WHISPER_ARCH} done on {gpu}: phase {out['seconds']:.1f} s (9a "
          f"{out['9a']['seconds']:.1f}, 9b {out['9b']['seconds']:.1f}, 9c "
          f"{out['9c']['seconds']:.1f}, 9d {out['9d']['seconds']:.1f}, phase 4's rows "
          f"{out['phase4']['seconds']:.1f})", flush=True)
    return out


def lm_ffn_calls(cfg) -> int:
    """swiglu launches (and, for the moe family, expert_ffn calls) a pass of
    the lm backbone: one a layer (the MLP, or the activation inside the
    experts' FFN), two for arctic (its dense residual MLP too)."""
    return cfg.n_layers * (2 if cfg.moe_dense_residual else 1)


def lm_launch_check(cfg, launched, report, *, fused: bool) -> list:
    """The problems of one vlm or moe serve's launch counts: rmsnorm
    2 n_layers + 1 a pass (a prefill chunk, decode step or verify step),
    swiglu lm_ffn_calls a pass, the paged kernel n_layers a fused decode or
    verify step and never in lanes, the flash kernel never (the engine's
    chunks attend by the plain chunk attention, as jnp in the reference)."""
    chunks = sum(e["chunks"] for e in report["step_log"])
    verify = (report.get("spec") or {}).get("verify_steps", 0)
    decode = sum(e["decoded"] > 0 for e in report["step_log"]) - verify
    passes = chunks + decode + verify
    want = {"rmsnorm": (2 * cfg.n_layers + 1) * passes,
            "swiglu": lm_ffn_calls(cfg) * passes,
            "paged_attention": cfg.n_layers * (decode + verify) if fused else 0,
            "flash_attention": 0}
    return [f"{name} launched {launched[name]} times, want {n} ({chunks} prefill chunks, "
            f"{decode} decode steps, {verify} verify steps of {cfg.n_layers} layers)"
            for name, n in want.items() if launched[name] != n]


def lm_serve_check(cfg, n_req: int, gen: int, *, fused: bool, batch: int,
                   spec: bool = False):
    """paired_serve's ``check`` for a vlm or moe serve: served on h100, every
    request answered with ``gen`` tokens, verify steps ran where ``spec``;
    fused: decode straight off the pools, requests beyond the slots parked
    and activated by a tail restore; and lm_launch_check."""
    def check(report, launched):
        problems = []
        if report["target"] != "h100":
            problems.append(f"served with target {report['target']!r}")
        if report["requests"] != n_req or report["refused"]:
            problems.append(f"{report['requests']} of {n_req} answered, refused "
                            f"{report['refused']}")
        short = {r: len(t) for r, t in report["outputs"].items() if len(t) != gen}
        if short or len(report["outputs"]) != n_req:
            problems.append(f"requests without {gen} tokens: {short}")
        if spec and not report["spec"]["verify_steps"]:
            problems.append("no verify step ran")
        if fused:
            paged = report["paged"]
            if not paged["fused"] or paged["lane_activations"] or \
                    (n_req > batch) != (paged["tail_restores"] > 0):
                problems.append(f"paged: fused {paged['fused']}, lane activations "
                                f"{paged['lane_activations']}, tail restores "
                                f"{paged['tail_restores']}")
        return problems + lm_launch_check(cfg, launched, report, fused=fused)
    return check


class _Routing:
    """A library's ops that record, in call order, the (T, k) expert ids of
    every topk_gating call (``picked``) and the (T·k,) kept mask of every
    moe_dispatch call (``kept``). With ``pinned`` (another run's
    ``picked``), topk_gating returns those ids, in their order, weighted by
    the softmax of this library's own float32 logits at them (the
    definition's arithmetic): one routing for two libraries."""

    def __init__(self, ops, pinned=None):
        self._ops, self.picked, self.kept = ops, [], []
        self._pinned = None if pinned is None else list(pinned)

    def __getattr__(self, name):
        return {"topk_gating": self._topk, "moe_dispatch": self._dispatch}.get(
            name) or getattr(self._ops, name)

    def _topk(self, logits, k=2):
        import torch

        if self._pinned is None:
            w, idx = self._ops.topk_gating(logits, k=k)
        else:
            idx = self._pinned.pop(0)
            w = torch.softmax(logits.float().gather(-1, idx), dim=-1).to(logits.dtype)
        self.picked.append(idx)
        return w, idx

    def _dispatch(self, *args, **kw):
        xe, info = self._ops.moe_dispatch(*args, **kw)
        self.kept.append(info[2])
        return xe, info


class _SameDispatch:
    """Ops whose moe_dispatch also runs ``other``'s (the torch_cpu
    library's) on the same operands: the dispatched block, each row's
    expert, slot and weight, and the kept mask must be EXACTLY equal (a row
    dropped on one side only is a different result); the drops are
    counted."""

    def __init__(self, ops, other, label: str):
        self._ops, self._other, self._label = ops, other, label
        self.calls, self.rows, self.dropped = 0, 0, 0

    def __getattr__(self, name):
        return self._dispatch if name == "moe_dispatch" else getattr(self._ops, name)

    def _dispatch(self, *args, **kw):
        import torch

        xe, info = self._ops.moe_dispatch(*args, **kw)
        xe2, info2 = self._other.moe_dispatch(*args, **kw)
        same = torch.equal(xe, xe2) and info[4] == info2[4] and all(
            torch.equal(a, b) for a, b in zip(info[:4], info2[:4]))
        if not same:
            raise AssertionError(f"{self._label} moe_dispatch call {self.calls}: the h100 "
                                 f"and torch_cpu libraries dispatch the same rows apart "
                                 f"(kept rows {int(info[2].sum())} vs "
                                 f"{int(info2[2].sum())})")
        self.calls += 1
        self.rows += info[2].numel()
        self.dropped += int((~info[2]).sum())
        return xe, info


def lm_plain_calls(cfg) -> dict:
    """The plain version of every kernel the lm backbone's steps call
    (_Compared): flash, paged, rmsnorm, swiglu, and the h100 expert_ffn
    with the plain swiglu (its activation is the swiglu kernel)."""
    import functools

    from repro_torch.kernels.flash_attention.ref import attention
    from repro_torch.kernels.moe import ops as moe_ops
    from repro_torch.kernels.paged.ref import paged_attention_ref
    from repro_torch.kernels.rmsnorm.ref import rmsnorm
    from repro_torch.kernels.swiglu.ref import swiglu

    return {"flash_attention": attention, "attention_decode_paged": paged_attention_ref,
            "attention_verify_paged": paged_attention_ref, "rmsnorm": rmsnorm,
            "swiglu": swiglu, "expert_ffn": functools.partial(moe_ops.expert_ffn, act=swiglu)}


def _uncounted(fn):
    """fn() with the launch counters left as they were (a comparison run)."""
    saved = read_counts()
    try:
        return fn()
    finally:
        for name, f in counters().items():
            f.launches = saved[name]


def lm_steps_vs_plain(tag: str, dev, model, params, batch: dict, steps: int, *,
                      counted: bool, rel_l2: float) -> dict:
    """Model.prefill of ``batch`` (tokens, and vlm vision_embeds) and
    ``steps`` greedy decode steps through the model's library (the main
    path where ``counted``: the counters set to 0 just before and read just
    after, launches gated exactly per pass), each against the torch_cpu
    library's on the card from a copy of the same state under
    _require_logits at ``rel_l2`` (phase 2's bar).

    The moe family is compared under ONE routing: a rerun through the h100
    library records each layer's expert ids (uncounted), and the other side
    takes them (_Routing, pinned); the kept masks must then be equal. Its
    torch_cpu library computes the experts' FFN in float32 (the reference's
    arithmetic) where h100 rounds the products and the activation to bf16,
    so against it the logits are held to ``rel_l2`` and the argmax verdicts
    printed (``logits_vs_torch_cpu``); phase 2's whole bar holds the step
    against the same library with every kernel bound to its plain version
    (_PlainOps over lm_plain_calls: the flash, rmsnorm and swiglu kernels'
    roundings alone, as for the dense family). Each library's own routing
    is compared as information (rows routed apart, kept rows apart, drops
    on each side, the unpinned rel L2: a near-tied router picks another
    expert on bf16 roundings, and a row routed apart is a different
    result)."""
    import torch

    from repro_torch.nn import lm
    from repro_torch.nn.model import build_model

    cfg = model.cfg
    plain = build_model(cfg, device=dev, target="torch_cpu")
    moe = bool(cfg.n_experts)
    b, t = batch["tokens"].shape
    vision = batch.get("vision_embeds")
    rows = t + (cfg.vision_prefix if vision is not None else 0)
    max_len = rows + steps
    per_pass = {"rmsnorm": 2 * cfg.n_layers + 1, "swiglu": lm_ffn_calls(cfg),
                "paged_attention": 0}
    out, checks, routing, vs_lib = {"rows": rows}, {}, {}, {}

    def versus(name, got, run):
        """got: the library's (rows, V) logits; run(tsl) -> the same step's
        logits through ``tsl`` on a copy of the same inputs."""
        if not moe:
            checks[name] = _logits_check(got, run(plain.tsl), cfg.vocab)
            return
        rec = _Routing(model.tsl)
        again = _uncounted(lambda: run(rec))
        own, pin = _Routing(plain.tsl), _Routing(plain.tsl, pinned=rec.picked)
        kplain = _Routing(_PlainOps(model.tsl, lm_plain_calls(cfg)), pinned=rec.picked)
        want_own, want, want_k = run(own), run(pin), run(kplain)
        for side in (pin, kplain):
            kept_apart = sum(int((a != c).sum()) for a, c in zip(rec.kept, side.kept))
            if kept_apart:
                raise AssertionError(f"{tag} {name}: under one routing {kept_apart} rows "
                                     f"kept on one side only")
        checks[name] = _logits_check(got, want_k, cfg.vocab)
        vs_lib[name] = _logits_check(got, want, cfg.vocab)
        if vs_lib[name]["logits_rel_l2"] > rel_l2 or not vs_lib[name]["finite"]:
            raise AssertionError(f"{tag} {name}, h100 vs torch_cpu library under one "
                                 f"routing: rel L2 {vs_lib[name]['logits_rel_l2']:.3g} > "
                                 f"{rel_l2}")
        routing[name] = {
            "rerun_equal": bool(torch.equal(again, got)),
            "rows_routed_apart": sum(int((a.sort(-1).values != c.sort(-1).values).any(-1)
                                         .sum()) for a, c in zip(rec.picked, own.picked)),
            "kept_rows_apart": sum(int((a != c).sum()) for a, c in zip(rec.kept, own.kept)),
            "dropped_h100": sum(int((~k).sum()) for k in rec.kept),
            "dropped_torch_cpu": sum(int((~k).sum()) for k in own.kept),
            "rows_routed": sum(k.numel() for k in rec.kept),
            "own_routing_rel_l2": _logits_check(got, want_own, cfg.vocab)["logits_rel_l2"]}

    if counted:
        for fn in counters().values():
            fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, state = model.prefill(params, batch, max_len)
    torch.cuda.synchronize()
    out["prefill_s"] = time.perf_counter() - t0
    if counted:
        out["prefill_launches"] = read_counts()
        want = {**per_pass, "flash_attention": cfg.n_layers}
        if {k: out["prefill_launches"][k] for k in want} != want:
            raise AssertionError(f"{tag}: launches per prefill {out['prefill_launches']}, "
                                 f"want {want}")
    if tuple(got.shape) != (b, cfg.padded_vocab):
        raise AssertionError(f"{tag}: prefill logits {tuple(got.shape)}")
    versus("prefill", got, lambda tsl: lm.lm_prefill(
        tsl, params, batch["tokens"], cfg, max_len=max_len, vision_embeds=vision)[0])
    toks = got[:, :cfg.vocab].argmax(-1)
    generated = []
    for i in range(steps):
        shared = {n: x.clone() for n, x in state.items()}
        before = read_counts()
        got, state = model.decode_step(params, state, toks[:, None], rows + i)
        after = read_counts()
        step = {k: after[k] - before[k] for k in after}
        want = {**per_pass, "flash_attention": 0}
        if counted and {k: step[k] for k in want} != want:
            raise AssertionError(f"{tag}: decode step {i} launched {step}, want {want}")
        versus(f"decode_{i}", got, lambda tsl, i=i, toks=toks: lm.lm_decode_step(
            tsl, params, {n: x.clone() for n, x in shared.items()}, toks[:, None], rows + i,
            cfg)[0])
        toks = got[:, :cfg.vocab].argmax(-1)
        generated.append(toks.tolist())
    if counted:
        out["decode_step_launches"] = step
        out["launches"] = read_counts()
    out["greedy_tokens"] = generated
    against = "kernels vs their plain versions" if moe else "h100 vs torch_cpu library"
    for name, c in checks.items():
        _require_logits(f"{tag} {name}, {against}", c, rel_l2=rel_l2)
    out["logits"], out["routing"] = checks, routing
    out["worst_rel_l2"] = max(c["logits_rel_l2"] for c in checks.values())
    if moe:
        out["logits_vs_torch_cpu"] = vs_lib
        out["vs_torch_cpu_worst_rel_l2"] = max(c["logits_rel_l2"] for c in vs_lib.values())
        out["vs_torch_cpu_argmax_failed"] = {n: c["argmax"]["failed_rows"]
                                             for n, c in vs_lib.items()
                                             if c["argmax"]["failed_rows"]}
    return out


def lm_calls_vs_plain(tag: str, dev, model, params, batch: dict) -> dict:
    """Every kernel call of a prefill of ``batch`` and of one decode step
    after it against its plain version on the operands the model gives it
    (_Compared over lm_plain_calls, TOLERANCE): flash n_layers times,
    rmsnorm 2 n_layers + 1 a pass, swiglu / expert_ffn lm_ffn_calls a pass;
    for the moe family every moe_dispatch against the torch_cpu library's
    (_SameDispatch: exactly equal, drops counted). Uncounted."""
    from repro_torch.nn import lm
    from repro_torch.nn.model import build_model

    cfg = model.cfg
    plain = build_model(cfg, device=dev, target="torch_cpu")
    compared = _Compared(model.tsl, lm_plain_calls(cfg), tag)
    tsl = _SameDispatch(compared, plain.tsl, tag) if cfg.n_experts else compared
    vision = batch.get("vision_embeds")
    t = batch["tokens"].shape[1] + (cfg.vision_prefix if vision is not None else 0)

    def run():
        _, st = lm.lm_prefill(tsl, params, batch["tokens"], cfg, max_len=t + 1,
                              vision_embeds=vision)
        lm.lm_decode_step(tsl, params, st, batch["tokens"][:, :1], t, cfg)
    _uncounted(run)
    want = cfg.n_layers + 2 * (2 * cfg.n_layers + 1 + lm_ffn_calls(cfg))
    out = _worst(compared.results)
    if out["calls"] != want:
        raise AssertionError(f"{tag}: {out['calls']} kernel calls compared, want {want}")
    if cfg.n_experts:
        out["dispatch"] = {"calls": tsl.calls, "rows": tsl.rows, "dropped": tsl.dropped}
    return out


def lm_paged_check(tag: str, dev, runs) -> dict:
    """One fused paged decode step and one verify span of SPEC_K + 1 at batch
    PROFILE_BATCH over PROFILE_FILL prefilled rows (page PAGE), per (label,
    model, params, rel_l2) of ``runs``: every paged, rmsnorm, swiglu and
    expert_ffn call against its plain version on the operands the step
    gives it (_Compared, TOLERANCE); the whole step's logits against the
    step through the plain versions on copies of the same pools, under
    _require_logits at ``rel_l2`` (None: printed only: a moe step through
    the plain versions routes on its own activations); row 0 of the span
    against the decode step likewise. Uncounted."""
    import torch

    from repro_torch.nn import lm

    batch, fill = PROFILE_BATCH, PROFILE_FILL
    out = {"batch": batch, "kv_len": fill + 1, "span": SPEC_K + 1, "page": PAGE}
    for label, m, p, rel_l2 in runs:
        cfg, vocab = m.cfg, m.cfg.padded_vocab
        plain = lm_plain_calls(cfg)
        g = torch.Generator(device=dev).manual_seed(54)
        span = torch.randint(0, cfg.vocab, (batch, SPEC_K + 1), generator=g, device=dev)
        pos = torch.full((batch,), fill, dtype=torch.int64, device=dev)
        _, pools, tables = _uncounted(lambda: paged_state(dev, m, p, batch, fill, seed=53))
        compared = _Compared(m.tsl, plain, f"{tag} {label} fused paged step")
        steps = (("decode", lm.lm_decode_step_paged, span[:, :1]),
                 ("verify", lm.lm_verify_step_paged, span))
        logits = {}

        def run():
            for name, tsl in (("kernel", compared), ("plain", _PlainOps(m.tsl, plain))):
                for kind, fn, toks in steps:
                    pl = {n: x.clone() for n, x in pools.items()}
                    logits[name, kind] = fn(tsl, p, {}, pl, tables, toks, pos, cfg)[0] \
                        .reshape(-1, vocab)
        _uncounted(run)
        r = {kind: _logits_check(logits["kernel", kind], logits["plain", kind], cfg.vocab)
             for kind, _, _ in steps}
        r["verify_row0_vs_decode"] = _logits_check(
            logits["kernel", "verify"].reshape(batch, -1, vocab)[:, 0],
            logits["kernel", "decode"], cfg.vocab)
        r["kernel_calls_vs_plain"] = _worst(compared.results)
        want = 2 * (cfg.n_layers + 2 * cfg.n_layers + 1 + lm_ffn_calls(cfg))
        if r["kernel_calls_vs_plain"]["calls"] != want:
            raise AssertionError(f"{tag} {label}: {r['kernel_calls_vs_plain']['calls']} "
                                 f"kernel calls compared, want {want}")
        if rel_l2 is not None:
            for kind in ("decode", "verify", "verify_row0_vs_decode"):
                _require_logits(f"{tag} {label} fused paged {kind}, kernel vs plain",
                                r[kind], rel_l2=rel_l2)
        out[label] = r
        del pools
    return out


def lm_decode_bound_ms(params, cfg, batch: int, kv_rows: int) -> float:
    """The least device time of one decode step at ``batch`` over
    ``kv_rows`` cached rows a slot: every parameter read once (the embedding
    only at the batch's rows; a moe layer's every expert, as expert_ffn
    computes each expert's capacity rows), each slot's K/V of every layer
    read once and its new row written, and the (batch, padded_vocab) logits
    written, over HBM_BYTES_PER_S."""
    from repro_torch.train.optimizer import tree_leaves

    item = params["embed"].element_size()
    weights = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    weights -= (cfg.padded_vocab - batch) * cfg.d_model * item
    kv = 2 * cfg.n_layers * batch * cfg.n_kv_heads * (kv_rows + 1) * cfg.hd * item
    logits = batch * cfg.padded_vocab * item
    return (weights + kv + logits) / HBM_BYTES_PER_S * 1e3


def lm_profile_rows(tag: str, dev, model, params, gpu: str, fill: int, kinds) -> dict:
    """Phase 4's rows for the vlm or moe family (run in its phase, where its
    model lives), through the engine's step code at batch PROFILE_BATCH,
    position ``fill``, captured and eager (_profile): ``kinds`` of "lane"
    (the lane decode step) and "fused" (the fused paged decode step, page
    PAGE), each beside lm_decode_bound_ms. Not a main path: uncounted."""
    import numpy as np
    import torch

    from repro_torch.serve import StepGraphs, disable_graphs
    from repro_torch.serve.graphs import run_model_step

    cfg = model.cfg
    rng = np.random.default_rng(52)
    tokens = rng.integers(0, cfg.vocab, (PROFILE_BATCH, 1))
    pos = np.full(PROFILE_BATCH, fill, np.int64)
    out = {}
    saved = read_counts()
    with torch.inference_mode():
        steps = {}
        if "lane" in kinds:
            state = model.init_decode_state(PROFILE_BATCH, fill + 2)
            for leaf in state.values():
                leaf.normal_(generator=torch.Generator(device=dev).manual_seed(55))
            lane = StepGraphs(dev)
            steps["decode_step"] = lambda: run_model_step(lane, "decode", model, params,
                                                          state, tokens, pos)
        if "fused" in kinds:
            _, pools, tables = paged_state(dev, model, params, PROFILE_BATCH, fill, seed=56,
                                           max_len=fill + 2)
            tables = tables.cpu().numpy()
            fused = StepGraphs(dev)
            steps["decode_step_paged"] = lambda: run_model_step(
                fused, "decode", model, params, {}, tokens, pos, pools=pools, tables=tables)
        bound_ms = lm_decode_bound_ms(params, cfg, PROFILE_BATCH, fill)
        for kind, fn in steps.items():
            def eager(fn=fn):
                with disable_graphs():
                    return fn()
            out[kind] = {"batch": PROFILE_BATCH, "pos": fill, "bound_ms": bound_ms,
                         "captured": _profile(fn, host_top=False),
                         "eager": _profile(eager, host_top=False)}
    for name, f in counters().items():
        f.launches = saved[name]
    for kind in steps:
        c, e = out[kind]["captured"], out[kind]["eager"]
        print(f"[phase4] {tag} {kind} ({cfg.name}, {cfg.n_layers} layers) on {gpu}, captured "
              f"vs eager: host wall {c['wall_ms']:.3f} vs {e['wall_ms']:.3f} ms, device busy "
              f"{c['device_busy_ms']} vs {e['device_busy_ms']} ms (bound "
              f"{bound_ms:.3f} ms, bytes), idle share {c.get('device_idle_share')} vs "
              f"{e.get('device_idle_share')}, kernels per step {c['launches']} vs "
              f"{e['launches']}; top kernels (captured) "
              f"{json.dumps(c.get('top_kernels_ms'))}", flush=True)
    return out


def _serve_pair(tag, name, gpu, run, check, graphs_first):
    """paired_serve (both sides untraced) with the counters set to 0 just
    before it and read just after it, and its seconds."""
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    pair = paired_serve(tag, name, gpu, run, check, graphs_first, trace=())
    pair["launches"] = read_counts()
    pair["seconds"] = time.perf_counter() - t0
    return pair


def vlm_images(rng, n: int, d: int) -> list:
    """``n`` seeded (VLM_PREFIX, d) float32 patch embeddings (the ViT
    frontend's output: a stub in the reference too)."""
    import numpy as np

    return [rng.standard_normal((VLM_PREFIX, d), dtype=np.float32) for _ in range(n)]


def vlm_requests(vocab: int, d: int, request_cls, n: int) -> list:
    """10b: ``n`` requests of VLM_PROMPT seeded tokens behind their own
    seeded images, VLM_GEN generated."""
    import numpy as np

    rng = np.random.default_rng(61)
    images = vlm_images(rng, n, d)
    return [request_cls(rid=f"v{i}", tokens=rng.integers(0, vocab, VLM_PROMPT)
                        .astype(np.int32), gen_len=VLM_GEN, embeds=images[i])
            for i in range(n)]


def vlm_paged_requests(vocab: int, d: int, request_cls) -> list:
    """10c: VLM_PAGED_REQUESTS requests in groups of four over one
    VLM_SHARED-token head, each with VLM_OWN tokens of its own: a (image A),
    a2 (image A again: a hit on a's entry), b (image B, the same head: a
    miss, the key covers the image) and b2 (image B again: a hit). The
    share boundary is the 256 vision rows + VLM_SHARED tokens, whole pages."""
    import numpy as np

    rng = np.random.default_rng(63)
    out = []
    for grp in range(VLM_PAGED_REQUESTS // 4):
        head = rng.integers(0, vocab, VLM_SHARED)
        ia, ib = vlm_images(rng, 2, d)
        for name, image in (("a", ia), ("a2", ia), ("b", ib), ("b2", ib)):
            toks = np.concatenate([head, rng.integers(0, vocab, VLM_OWN)]).astype(np.int32)
            out.append(request_cls(rid=f"i{grp}{name}", tokens=toks, gen_len=VLM_PAGED_GEN,
                                   embeds=image, shared_prefix_len=VLM_SHARED))
    return out


def vlm_serve_phase(dev, params, gpu: str) -> dict:
    """Phases 10b-10d: internvl2-2b served at full width behind VLM_PREFIX
    vision rows a request, each serve a paired_serve (captured and eager:
    equal outputs, counters and launches; both untraced) under
    lm_serve_check, the counters set to 0 just before each pair and read
    just after it.
    10b lane mode: VLM_REQUESTS requests of VLM_PROMPT tokens behind their
       own images, VLM_GEN generated, VLM_BATCH slots, chunks of VLM_CHUNK
       (the first chunk's captured step carries the 256 vision rows: its own
       entry, jit_cache prefill_chunk 2).
    10c fused paged (page PAGE, chunk VLM_CHUNK) on vlm_paged_requests: the
       repeats hit the prefix store (plus one a preemption's continuation)
       and the firsts and the same heads behind another image miss, exactly;
       every first token equal to a lane run's of the same requests (the
       rest printed: lane mode attends by the plain decode attention).
    10d the n-gram drafter at fixed depth SPEC_K on SPEC_DRAFT_REQUESTS of
       3e(ii)'s pattern prompts behind seeded images, fused paged."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.serve import PagedConfig, Request, ServeEngine, SpeculationConfig

    cfg = get_config(VLM_ARCH)
    kw = dict(batch=VLM_BATCH, device=dev, params=params, prefill_chunk=VLM_CHUNK)
    out = {}
    out["10b"] = _serve_pair(
        "phase10b", f"lane serve {VLM_ARCH}", gpu,
        lambda: ServeEngine(cfg, max_len=VLM_PREFIX + VLM_PROMPT + VLM_GEN, **kw).run(
            vlm_requests(cfg.vocab, cfg.d_model, Request, VLM_REQUESTS)),
        lm_serve_check(cfg, VLM_REQUESTS, VLM_GEN, fused=False, batch=VLM_BATCH), True)
    jit = out["10b"]["graphs"]["jit_cache"]
    if jit != {"prefill_chunk": 2, "decode": 1}:
        raise AssertionError(f"phase 10b: the graphs run captured {jit}")
    steps = out["10b"]["report"]["step_log"]
    print(f"[phase10b] lane serve {VLM_ARCH} on {gpu}: decode steps "
          f"{sum(e['decoded'] > 0 for e in steps)}, prefill chunks "
          f"{sum(e['chunks'] for e in steps)}, jit_cache {jit}, launches of the pair "
          f"{out['10b']['launches']}; phase {out['10b']['seconds']:.1f} s", flush=True)

    # one bucket of the whole prompt: the declared ones past 128 do not fit
    # behind the vision rows in this table
    paged_kw = dict(kw, max_len=VLM_PREFIX + VLM_SHARED + VLM_OWN + VLM_PAGED_GEN,
                    buckets=(VLM_SHARED + VLM_OWN,))

    def requests():
        return vlm_paged_requests(cfg.vocab, cfg.d_model, Request)

    out["10c"] = _serve_pair(
        "phase10c", f"fused paged serve {VLM_ARCH}", gpu,
        lambda: ServeEngine(cfg, paged=PagedConfig(page_size=PAGE), **paged_kw).run(
            requests()),
        lm_serve_check(cfg, VLM_PAGED_REQUESTS, VLM_PAGED_GEN, fused=True, batch=VLM_BATCH),
        False)
    t0 = time.perf_counter()
    report = out["10c"]["report"]
    pg = report["paged"]
    n_miss = VLM_PAGED_REQUESTS // 2
    if pg["prefix_misses"] != n_miss or \
            pg["prefix_hits"] != VLM_PAGED_REQUESTS - n_miss + pg["preemptions"]:
        raise AssertionError(f"phase 10c: {pg['prefix_hits']} prefix hits and "
                             f"{pg['prefix_misses']} misses with {pg['preemptions']} "
                             f"preemptions, want {VLM_PAGED_REQUESTS - n_miss} + preemptions "
                             f"and {n_miss}")
    lane = ServeEngine(cfg, **paged_kw).run(requests())
    outs = report["outputs"]
    firsts = [r for r in outs if outs[r][0] != lane["outputs"][r][0]]
    if firsts:
        raise AssertionError(f"phase 10c: first tokens differ from lane mode's for {firsts}")
    differ = {r: next(i for i, (x, y) in enumerate(zip(lane["outputs"][r], toks)) if x != y)
              for r, toks in outs.items() if toks != lane["outputs"][r]}
    other_image = sum(outs[r] != outs[r[:-1] + "b"] for r in outs if r.endswith("a"))
    out["10c"].update(share_equal_to_lane=1 - len(differ) / VLM_PAGED_REQUESTS,
                      first_differing_token=differ,
                      lane_decode_tokens_per_s=lane["decode_tokens_per_s"],
                      heads_of_other_images_differing=other_image)
    out["10c"]["seconds"] += time.perf_counter() - t0
    print(f"[phase10c] fused paged serve {VLM_ARCH} on {gpu}: prefix hits "
          f"{pg['prefix_hits']}, misses {pg['prefix_misses']}, preemptions "
          f"{pg['preemptions']}; first tokens of all {VLM_PAGED_REQUESTS} equal a lane-mode "
          f"run's; whole outputs equal for {VLM_PAGED_REQUESTS - len(differ)}/"
          f"{VLM_PAGED_REQUESTS} (information; first differing token of the others "
          f"{differ}); one head behind two images with other outputs {other_image}/"
          f"{VLM_PAGED_REQUESTS // 4}; lane {lane['decode_tokens_per_s']:.1f} tokens/s; "
          f"paged {json.dumps(pg)}; launches of the pair {out['10c']['launches']}; phase "
          f"{out['10c']['seconds']:.1f} s", flush=True)

    def spec_reqs():
        reqs = spec_requests(cfg.vocab, Request, SPEC_DRAFT_REQUESTS, gen=VLM_PAGED_GEN)
        for r, image in zip(reqs, vlm_images(np.random.default_rng(65), len(reqs),
                                             cfg.d_model)):
            r.embeds = image
        return reqs

    out["10d"] = _serve_pair(
        "phase10d", f"speculative fused paged serve {VLM_ARCH}, n-gram depth {SPEC_K}", gpu,
        lambda: ServeEngine(cfg, max_len=VLM_PREFIX + SPEC_PROMPT + VLM_PAGED_GEN,
                            paged=PagedConfig(page_size=PAGE),
                            speculation=SpeculationConfig(fixed_k=SPEC_K), **kw).run(
            spec_reqs()),
        lm_serve_check(cfg, SPEC_DRAFT_REQUESTS, VLM_PAGED_GEN, fused=True, batch=VLM_BATCH,
                       spec=True), True)
    jit = out["10d"]["graphs"]["jit_cache"]
    if jit.get("verify", 0) <= 0:
        raise AssertionError(f"phase 10d: the graphs run captured no verify step: {jit}")
    spec = out["10d"]["report"]["spec"]
    out["10d"]["spec"] = {k: spec[k] for k in ("verify_steps", "decode_steps", "drafted_tokens",
                                              "accepted_tokens", "accepted_rate",
                                              "mean_accepted_span")}
    print(f"[phase10d] speculative fused paged serve {VLM_ARCH} on {gpu}: "
          f"{json.dumps(out['10d']['spec'])}, jit_cache {jit}; launches of the pair "
          f"{out['10d']['launches']}; phase {out['10d']['seconds']:.1f} s", flush=True)
    for r in out.values():
        r.pop("report")
    return out


def vlm_phase(dev, gpu: str) -> dict:
    """Phase 10: internvl2-2b at full width (24 layers, d 2048, 16 heads of
    128 over 8 KV heads, d_ff 8192, vocab 92553 padded to 92672, bf16),
    seeded weights from the port's init on the card, VLM_PREFIX (256) seeded
    vision rows ahead of every prompt. 10a the main path and the layers,
    10b-10d serving, and its rows of phase 4's step table."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.nn.model import Model, build_model
    from repro_torch.train.optimizer import tree_leaves, tree_map

    t_phase = time.perf_counter()
    cfg = get_config(VLM_ARCH)
    model = build_model(cfg, device=dev)
    assert type(model) is Model and model.lib.TARGET_NAME == "h100"
    params = model.init(0)
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    kv_token = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd * 2
    print(f"[phase10] {VLM_ARCH} on {gpu}: {n_params / 1e9:.4f}B params "
          f"({sum(t.numel() * t.element_size() for t in leaves) / 1e9:.3f} GB; the "
          f"reference's param_count {cfg.param_count() / 1e9:.4f}B), {kv_token / 1024:.1f} KiB "
          f"of K/V a cached row; init {time.perf_counter() - t_phase:.1f} s", flush=True)
    out = {"params": n_params, "kv_row_bytes": kv_token}
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(60)
    b, t = VLM_PREFILL
    tokens = torch.randint(0, cfg.vocab, (b, t), generator=g, device=dev)
    vision = torch.randn((b, VLM_PREFIX, cfg.d_model), generator=g, device=dev)
    with torch.inference_mode():
        r = lm_steps_vs_plain("phase 10a", dev, model, params,
                              {"tokens": tokens, "vision_embeds": vision.to(model.dtype)},
                              VLM_DECODE_STEPS, counted=True, rel_l2=LOGITS_REL_L2)
        out["10a"] = r
        cfg32 = cfg.replace(dtype="float32")
        m32 = build_model(cfg32, device=dev)
        params32 = tree_map(lambda x: x.float(), params)
        calls = {"bf16": lm_calls_vs_plain("phase 10a bf16", dev, model, params,
                                           {"tokens": tokens,
                                            "vision_embeds": vision.to(model.dtype)}),
                 "f32": lm_calls_vs_plain("phase 10a f32", dev, m32, params32,
                                          {"tokens": tokens, "vision_embeds": vision})}
        r["calls_vs_plain"] = calls
        r32 = _uncounted(lambda: lm_steps_vs_plain(
            "phase 10a f32", dev, m32, params32, {"tokens": tokens, "vision_embeds": vision},
            VLM_DECODE_STEPS, counted=False, rel_l2=VLM_F32_REL_L2))
        r["f32_worst_rel_l2"] = r32["worst_rel_l2"]
        r["paged"] = lm_paged_check("phase 10a", dev,
                                    [("bf16", model, params, LOGITS_REL_L2),
                                     ("f32", m32, params32, VLM_F32_REL_L2)])
        del params32, m32
        torch.cuda.empty_cache()
    r["seconds"] = time.perf_counter() - t0
    pg = r["paged"]
    print(f"[phase10a] {VLM_ARCH} prefill {VLM_PREFILL} behind {VLM_PREFIX} vision rows "
          f"({r['rows']} rows; {r['prefill_s']:.3f} s, first call) + {VLM_DECODE_STEPS} decode "
          f"steps on {gpu}: launches per prefill {r['prefill_launches']}, per decode step "
          f"{r['decode_step_launches']}, main path {r['launches']}; bf16 h100 vs torch_cpu "
          f"worst rel L2 {r['worst_rel_l2']:.3g} (bound {LOGITS_REL_L2}, argmax verdicts); "
          f"float32 at full depth worst rel L2 {r['f32_worst_rel_l2']:.3g} (bound "
          f"{VLM_F32_REL_L2}); kernel calls vs plain in a prefill and a decode step "
          f"{json.dumps(calls)}; fused paged steps, calls vs plain bf16 "
          f"{json.dumps(pg['bf16']['kernel_calls_vs_plain'])}, float32 "
          f"{json.dumps(pg['f32']['kernel_calls_vs_plain'])}, whole step rel L2 bf16 decode "
          f"{pg['bf16']['decode']['logits_rel_l2']:.3g}, verify "
          f"{pg['bf16']['verify']['logits_rel_l2']:.3g}; {json.dumps(r['logits'])}; "
          f"phase {r['seconds']:.1f} s", flush=True)
    out.update(vlm_serve_phase(dev, params, gpu))
    t0 = time.perf_counter()
    out["phase4"] = lm_profile_rows("phase 10", dev, model, params, gpu, VLM_PROFILE_FILL,
                                    ("lane", "fused"))
    out["phase4"]["seconds"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[phase10] {VLM_ARCH} done on {gpu}: phase {out['seconds']:.1f} s (10a "
          f"{r['seconds']:.1f}, 10b {out['10b']['seconds']:.1f}, 10c "
          f"{out['10c']['seconds']:.1f}, 10d {out['10d']['seconds']:.1f}, phase 4's rows "
          f"{out['phase4']['seconds']:.1f})", flush=True)
    return out


def moe_requests(vocab: int, request_cls) -> list:
    """11b: MOE_REQUESTS requests of MOE_PROMPT seeded tokens, MOE_GEN
    generated; the even ones share a MOE_SHARED-token head (a page)."""
    import numpy as np

    rng = np.random.default_rng(71)
    head = rng.integers(0, vocab, MOE_SHARED)
    out = []
    for i in range(MOE_REQUESTS):
        toks = rng.integers(0, vocab, MOE_PROMPT)
        if i % 2 == 0:
            toks[:MOE_SHARED] = head
        out.append(request_cls(rid=f"m{i}", tokens=toks.astype(np.int32), gen_len=MOE_GEN,
                               shared_prefix_len=MOE_SHARED if i % 2 == 0 else None))
    return out


def sliced_init(model, seed: int) -> dict:
    """``model``'s parameter tree from the port's init_leaf, each stacked
    leaf (the layer axis and, for experts, the expert axis in front of a
    (fan-in, width) matrix) drawn one matrix at a time into its bf16 leaf:
    the same distribution as ``model.init``, without the whole leaf's
    float32 draw beside it (25.8 GB for grok-1-314b's four layers of one
    expert weight; the earlier phases leave ~18 GiB the allocator cannot
    hand back, PERF.md §7)."""
    import itertools

    import torch

    from repro_torch.nn import lm
    from repro_torch.nn.common import init_leaf

    g = torch.Generator(device=model.device).manual_seed(seed)

    def make(kind, shape, **kw):
        if kind not in ("dense", "embed") or len(shape) < 3:
            return init_leaf(kind, shape, dtype=model.dtype, device=model.device,
                             generator=g, **kw)
        out = torch.empty(shape, dtype=kw.get("leaf_dtype") or model.dtype,
                          device=model.device)
        for lead in itertools.product(*map(range, shape[:-2])):
            out[lead] = init_leaf(kind, shape[-2:], dtype=model.dtype, device=model.device,
                                  generator=g, **kw)
        return out
    return lm.lm_params(model.cfg, make)


def moe_layers(dev, gpu: str, arch: str, n_layers: int, prefill: tuple, steps: int,
               tag: str) -> tuple:
    """(cfg, model, params, result): ``arch`` at full width cut to its first
    ``n_layers`` layers (seeded from the port's init on the card, bf16,
    sliced_init), its
    main path counted (lm_steps_vs_plain) and every kernel call of a prefill
    and a decode step against its plain version (lm_calls_vs_plain, the
    moe_dispatch calls against the torch_cpu library's)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.nn.model import Model, build_model
    from repro_torch.nn.moe import capacity_for
    from repro_torch.train.optimizer import tree_leaves

    t0 = time.perf_counter()
    full = get_config(arch)
    cfg = full.replace(n_layers=n_layers)
    model = build_model(cfg, device=dev)
    assert type(model) is Model and model.lib.TARGET_NAME == "h100"
    params = sliced_init(model, 0)
    leaves = tree_leaves(params)
    size = sum(x.numel() * x.element_size() for x in leaves)
    print(f"[{tag}] {arch} at {n_layers} of {full.n_layers} layers on {gpu}: "
          f"{sum(x.numel() for x in leaves) / 1e9:.3f}B params ({size / 1e9:.2f} GB bf16; the "
          f"whole model {full.param_count() / 1e9:.1f}B, "
          f"{full.param_count() * 2 / 1e9:.0f} GB: no card holds it); capacity "
          f"{capacity_for(cfg, prefill[0] * prefill[1])} rows an expert at the prefill, "
          f"{capacity_for(cfg, prefill[0])} at a decode step; init "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)
    g = torch.Generator(device=dev).manual_seed(70)
    tokens = torch.randint(0, cfg.vocab, prefill, generator=g, device=dev)
    with torch.inference_mode():
        r = lm_steps_vs_plain(tag, dev, model, params, {"tokens": tokens}, steps,
                              counted=True, rel_l2=LOGITS_REL_L2)
        r["calls_vs_plain"] = lm_calls_vs_plain(tag, dev, model, params, {"tokens": tokens})
    r["bytes"] = size
    return cfg, model, params, r


def moe_phase(dev, gpu: str) -> dict:
    """Phase 11: the moe family at full width with a stated cut of layers
    (grok-1-314b is 628 GB in bf16, arctic-480b 958 GB: no card holds
    either).
    11a grok-1-314b at MOE_LAYERS of its 64 layers (d 6144, 48 heads of 128
       over 8, 8 experts of d_ff 32768, top-2, vocab 131072): the main path
       (Model.prefill of MOE_PREFILL tokens and MOE_DECODE_STEPS decode
       steps, counted, each against the torch_cpu library under one routing,
       lm_steps_vs_plain), every kernel call of a prefill and a decode step
       against its plain version (the swiglu kernel inside expert_ffn) and
       every moe_dispatch against the torch_cpu library's (exact), the fused
       paged steps' calls; then the float32 model at MOE_F32_LAYERS layer on
       both libraries within MOE_F32_REL_L2 (after the serves: the bf16
       weights go first).
    11b grok served at 11a's cut: MOE_REQUESTS requests of MOE_PROMPT +
       MOE_GEN at batch PROFILE_BATCH, chunks and pages of PAGE, lane and
       fused paged, each a paired_serve under lm_serve_check; the fused run
       shares the even requests' head (a miss, then hits); every first token
       equal across the two modes. Phase 4's row: a captured grok decode
       step.
    11c arctic-480b at ARCTIC_LAYERS of its 35 layers (128 experts of d_ff
       4864 and a dense residual MLP of 7168): its main path (ARCTIC_PREFILL,
       ARCTIC_DECODE_STEPS decode steps, counted) and its kernel calls, as
       11a (swiglu twice a layer: the experts' and the dense residual's)."""
    import torch

    from repro_torch.nn.model import build_model
    from repro_torch.serve import PagedConfig, Request, ServeEngine

    t_phase = time.perf_counter()
    out = {}
    t0 = time.perf_counter()
    cfg, model, params, r = moe_layers(dev, gpu, MOE_ARCH, MOE_LAYERS, MOE_PREFILL,
                                       MOE_DECODE_STEPS, "phase 11a")
    with torch.inference_mode():
        r["paged"] = lm_paged_check("phase 11a", dev, [("bf16", model, params, None)])
    out["11a"] = r
    pg = r["paged"]["bf16"]
    print(f"[phase11a] {MOE_ARCH} prefill {MOE_PREFILL} + {MOE_DECODE_STEPS} decode steps "
          f"at {MOE_LAYERS} layers on {gpu} ({r['prefill_s']:.3f} s, first call): launches "
          f"per prefill {r['prefill_launches']}, per decode step {r['decode_step_launches']}, "
          f"main path {r['launches']}; under one routing, bf16 kernels vs their plain "
          f"versions worst rel L2 {r['worst_rel_l2']:.3g} (bound {LOGITS_REL_L2}, argmax "
          f"verdicts), h100 vs torch_cpu library {r['vs_torch_cpu_worst_rel_l2']:.3g} (bound "
          f"{LOGITS_REL_L2}; argmax beyond a tie on {r['vs_torch_cpu_argmax_failed']}, "
          f"information: float32 experts there); each library's "
          f"own routing (information) {json.dumps(r['routing'])}; kernel calls vs plain "
          f"{json.dumps(r['calls_vs_plain'])}; fused paged steps, calls vs plain "
          f"{json.dumps(pg['kernel_calls_vs_plain'])}, whole step rel L2 decode "
          f"{pg['decode']['logits_rel_l2']:.3g}, verify {pg['verify']['logits_rel_l2']:.3g} "
          f"(information: the plain step routes on its own activations); "
          f"{json.dumps(r['logits'])}; {time.perf_counter() - t0:.1f} s", flush=True)

    kw = dict(batch=PROFILE_BATCH, max_len=MOE_PROMPT + MOE_GEN, device=dev, params=params,
              prefill_chunk=PAGE)
    check = lm_serve_check(cfg, MOE_REQUESTS, MOE_GEN, fused=False, batch=PROFILE_BATCH)
    out["11b-lane"] = _serve_pair(
        "phase11b", f"lane serve {MOE_ARCH} at {MOE_LAYERS} layers", gpu,
        lambda: ServeEngine(cfg, **kw).run(moe_requests(cfg.vocab, Request)), check, True)
    out["11b-paged"] = _serve_pair(
        "phase11b", f"fused paged serve {MOE_ARCH} at {MOE_LAYERS} layers", gpu,
        lambda: ServeEngine(cfg, paged=PagedConfig(page_size=PAGE), **kw).run(
            moe_requests(cfg.vocab, Request)),
        lm_serve_check(cfg, MOE_REQUESTS, MOE_GEN, fused=True, batch=PROFILE_BATCH), False)
    lane, paged = (out[k].pop("report") for k in ("11b-lane", "11b-paged"))
    pg = paged["paged"]
    # the even requests' head: one miss, then hits; each odd request's own
    # first page: a miss
    n_shared = (MOE_REQUESTS + 1) // 2
    want_miss = 1 + MOE_REQUESTS - n_shared
    if pg["prefix_misses"] != want_miss or \
            pg["prefix_hits"] != n_shared - 1 + pg["preemptions"]:
        raise AssertionError(f"phase 11b: {pg['prefix_hits']} prefix hits and "
                             f"{pg['prefix_misses']} misses with {pg['preemptions']} "
                             f"preemptions, want {n_shared - 1} + preemptions and "
                             f"{want_miss}")
    firsts = [r for r in lane["outputs"]
              if lane["outputs"][r][0] != paged["outputs"][r][0]]
    if firsts:
        raise AssertionError(f"phase 11b: first tokens of lane and fused paged mode differ "
                             f"for {firsts}")
    same = sum(lane["outputs"][r] == paged["outputs"][r] for r in lane["outputs"])
    out["11b-paged"]["whole_outputs_equal_to_lane"] = same
    print(f"[phase11b] {MOE_ARCH} at {MOE_LAYERS} layers on {gpu}: lane "
          f"{out['11b-lane']['graphs']['decode_tokens_per_s']:.1f} tokens/s (eager "
          f"{out['11b-lane']['eager']['decode_tokens_per_s']:.1f}), fused paged "
          f"{out['11b-paged']['graphs']['decode_tokens_per_s']:.1f} (eager "
          f"{out['11b-paged']['eager']['decode_tokens_per_s']:.1f}), prefix hits "
          f"{pg['prefix_hits']}, misses {pg['prefix_misses']}; every first token equal "
          f"across the modes, whole outputs equal for {same}/{MOE_REQUESTS} (information); "
          f"launches lane {out['11b-lane']['launches']}, fused paged "
          f"{out['11b-paged']['launches']}; {out['11b-lane']['seconds']:.1f} + "
          f"{out['11b-paged']['seconds']:.1f} s", flush=True)
    t0 = time.perf_counter()
    out["phase4"] = lm_profile_rows("phase 11", dev, model, params, gpu,
                                    MOE_PROMPT + MOE_GEN // 2, ("lane",))
    out["phase4"]["seconds"] = time.perf_counter() - t0

    # float32 at MOE_F32_LAYERS layer: the bf16 weights go first (``kw``
    # holds them too)
    del model, params, kw
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg32 = cfg.replace(n_layers=MOE_F32_LAYERS, dtype="float32")
    m32 = build_model(cfg32, device=dev)
    params32 = sliced_init(m32, 0)
    g = torch.Generator(device=dev).manual_seed(72)
    tokens = torch.randint(0, cfg.vocab, MOE_PREFILL, generator=g, device=dev)
    with torch.inference_mode():
        r32 = _uncounted(lambda: lm_steps_vs_plain(
            "phase 11a f32", dev, m32, params32, {"tokens": tokens}, MOE_DECODE_STEPS,
            counted=False, rel_l2=MOE_F32_REL_L2))
        r32["calls_vs_plain"] = lm_calls_vs_plain("phase 11a f32", dev, m32, params32,
                                                  {"tokens": tokens})
    out["11a"]["f32"] = {k: r32[k] for k in ("worst_rel_l2", "vs_torch_cpu_worst_rel_l2",
                                              "routing", "calls_vs_plain")}
    out["11a"]["f32"]["seconds"] = time.perf_counter() - t0
    print(f"[phase11a] {MOE_ARCH} float32 at {MOE_F32_LAYERS} layer on {gpu}: under one "
          f"routing, kernels vs plain worst rel L2 {r32['worst_rel_l2']:.3g}, h100 vs "
          f"torch_cpu {r32['vs_torch_cpu_worst_rel_l2']:.3g} (bound {MOE_F32_REL_L2}); own "
          f"routing {json.dumps(r32['routing'])}; kernel calls vs "
          f"plain {json.dumps(r32['calls_vs_plain'])}; "
          f"{out['11a']['f32']['seconds']:.1f} s", flush=True)
    del m32, params32
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg, model, params, r = moe_layers(dev, gpu, ARCTIC_ARCH, ARCTIC_LAYERS, ARCTIC_PREFILL,
                                       ARCTIC_DECODE_STEPS, "phase 11c")
    r["seconds"] = time.perf_counter() - t0
    out["11c"] = r
    print(f"[phase11c] {ARCTIC_ARCH} prefill {ARCTIC_PREFILL} + {ARCTIC_DECODE_STEPS} decode "
          f"steps at {ARCTIC_LAYERS} layer on {gpu}: launches per prefill "
          f"{r['prefill_launches']}, per decode step {r['decode_step_launches']} (swiglu: the "
          f"experts' and the dense residual's), main path {r['launches']}; under one "
          f"routing, bf16 kernels vs plain worst rel L2 {r['worst_rel_l2']:.3g}, h100 vs "
          f"torch_cpu {r['vs_torch_cpu_worst_rel_l2']:.3g} (bound {LOGITS_REL_L2}; argmax "
          f"beyond a tie on {r['vs_torch_cpu_argmax_failed']}, information); own routing "
          f"{json.dumps(r['routing'])}; kernel calls vs plain "
          f"{json.dumps(r['calls_vs_plain'])}; {r['seconds']:.1f} s", flush=True)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[phase11] done on {gpu}: phase {out['seconds']:.1f} s (11b "
          f"{out['11b-lane']['seconds'] + out['11b-paged']['seconds']:.1f}, phase 4's row "
          f"{out['phase4']['seconds']:.1f}, 11a float32 {out['11a']['f32']['seconds']:.1f}, "
          f"11c {out['11c']['seconds']:.1f})", flush=True)
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found: run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.device import resolve_device

    t_start = time.perf_counter()
    gpu = gpu_line()
    print(gpu, flush=True)
    dev = resolve_device("cuda")

    # each phase's seconds of command time, printed on the [done] line
    phase_s: dict[str, float] = {}

    def timed(name: str, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        phase_s[name] = round(time.perf_counter() - t0, 1)
        return result

    kernels = timed("1", kernel_phase, dev)
    for fn in counters().values():
        fn.launches = 0
    model, lm, params = timed("2", model_phase, dev, gpu)
    serve = timed("3", serve_phase, gpu)
    counts = read_counts()
    paged = timed("3b", paged_serve_phase, dev, params, gpu)
    for fn in counters().values():
        fn.launches = 0
    spec = timed("3e", spec_serve_phase, dev, params, gpu, paged["outputs"])
    spec["launches"] = read_counts()
    for fn in counters().values():
        fn.launches = 0
    int8 = timed("3f", int8_serve_phase, dev, lm, params, gpu, paged)
    int8["launches"] = read_counts()
    long = timed("3g", long_context_phase, dev, params, gpu)
    stream = timed("3h", stream_phase, dev, params, gpu)
    for fn in counters().values():
        fn.launches = 0
    app = timed("3c", app_phase, dev, gpu)
    app["launches"] = read_counts()
    for fn in counters().values():
        fn.launches = 0
    suite = timed("3d", suite_phase, gpu)
    suite["launches"] = read_counts()
    path_of = {"paged_attention": paged["launches"], "range_count": app["launches"],
               "hadd": app["launches"], "to_integral": app["launches"],
               "softmax": suite["launches"]}
    for row in kernels:
        row["launches"] = path_of.get(row["name"], counts)[row["name"]]
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} never launched on its main path")
        if row["name"] == "paged_attention":
            # the speculative paged path (3e): decode and verify steps; the
            # int8 paged path (3f: none, int8 pools take the plain version);
            # the long-context path (3g, several splits a step); streaming
            # (3h)
            row["launches_phase3e"] = spec["launches"]["paged_attention"]
            row["launches_phase3f"] = int8["launches"]["paged_attention"]
            row["launches_phase3g"] = long["launches"]["paged_attention"]
            row["launches_phase3h"] = stream["launches"]["paged_attention"]
    saved = read_counts()
    timed("4", profile_phase, dev, lm, params, gpu)
    timed("4b", multi_split_phase, dev, lm, params, gpu)
    for name, fn in counters().items():       # measurements, not a main path
        fn.launches = saved[name]
    train = timed("5a-5c", train_phase, dev, gpu)
    sources = {"flash_attention_fwd_lse": ("flash_attention.cu", "kernel.py:197"),
               "flash_attention_bwd_dq": ("flash_attention_bwd.cu", "kernel.py:300"),
               "flash_attention_bwd_dkv": ("flash_attention_bwd.cu", "kernel.py:333")}
    for name, (src, line) in sources.items():
        cs = train["kernel_cases"][name]
        top = next(c for c in cs if c["main"])
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/flash_attention/csrc/{src}",
               "replaces": f"src/repro/kernels/flash_attention/{line}",
               "launches": train["launches"][name],
               "max_abs_err": max(c["max_abs_err"] for c in cs),
               "tolerance_used": max(c["worst_of_limit"] for c in cs),
               **{k: top[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms", "shape")},
               "cases": cs}
        if row["launches"] <= 0:
            raise AssertionError(f"{name} never launched on its main path")
        kernels.append(row)
    for row in kernels:
        if row["name"] in train["kernel_cases"]["plain_backward_ms"]:
            row["plain_backward_ms"] = train["kernel_cases"]["plain_backward_ms"][row["name"]]
    compiled = timed("5d", compiled_train_phase, dev, gpu)
    cli = timed("6", train_cli_phase, dev, gpu)
    for row in kernels:           # the training kernels: launches on every train path
        if row["name"] in cli["launches_per_step"]["6a uninterrupted"]:
            row["launches_phase5c"] = train["launches"][row["name"]]
            row["launches_phase5d"] = compiled["cases"]["float32"]["captured"]["launches"][
                row["name"]]
            row["launches_phase6"] = cli["launches"][row["name"]]
    # phase 7 holds rwkv6-7b's 15 GB of weights: every earlier model goes first
    del lm, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[phase7] before: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved", flush=True)
    rwkv = timed("7", rwkv_phase, dev, gpu)
    for row in kernels:           # rmsnorm (ln_x) on each rwkv serving path
        if row["name"] == "rmsnorm":
            for part in ("7b", "7c", "7d"):
                row[f"launches_phase{part}"] = rwkv[part]["launches"]["rmsnorm"]
    # phase 8 holds zamba2-7b's 13.2 GB of weights (and 8a a float32 copy):
    # rwkv6-7b's go first
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[phase8] before: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved", flush=True)
    zamba = timed("8", zamba_phase, dev, gpu)
    # phase 9 holds whisper-tiny's weights: zamba2-7b's go first
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[phase9] before: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved", flush=True)
    whisper = timed("9", whisper_phase, dev, gpu)
    # phase 10 holds internvl2-2b's 3.8 GB of weights: whisper-tiny's go first
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[phase10] before: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved", flush=True)
    vlm = timed("10", vlm_phase, dev, gpu)
    # phase 11 holds 42.6 GB of grok-1-314b's layers: internvl2-2b's go first
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[phase11] before: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved", flush=True)
    moe = timed("11", moe_phase, dev, gpu)
    # each phase-8 to phase-11 path's launches: 8a, 9a, 10a, 11a and 11c the
    # main path (prefill + decode steps), the others each serve's pair
    paths = {"8a": zamba["8a"]["launches"], "9a": whisper["9a"]["launches"],
             **{part: zamba[part]["launches"] for part in ("8b", "8c", "8d")},
             **{part: whisper[part]["launches"] for part in ("9b", "9c", "9d")},
             "10a": vlm["10a"]["launches"],
             **{part: vlm[part]["launches"] for part in ("10b", "10c", "10d")},
             **{part: moe[part]["launches"] for part in ("11a", "11b-lane", "11b-paged",
                                                         "11c")}}
    lm_paths = ("10a", "10b", "10c", "10d", "11a", "11b-lane", "11b-paged", "11c")
    want = {"rmsnorm": ("8a", "8b", "8c", "8d") + lm_paths,
            "swiglu": lm_paths,
            "flash_attention": ("8a", "9a", "9b", "9c", "9d", "10a", "11a", "11c"),
            "paged_attention": ("8c", "8d", "9c", "9d", "10c", "10d", "11b-paged")}
    for row in kernels:
        for part in want.get(row["name"], ()):
            row[f"launches_phase{part}"] = paths[part][row["name"]]
            if row[f"launches_phase{part}"] <= 0:
                raise AssertionError(f"{row['name']} never launched on phase {part}'s path")
    print(f"[done] main-path launches {counts}, paged path {paged['launches']}, app "
          f"{app['launches']}, generated suite {suite['launches']} "
          f"({suite['passed']}/{suite['tests']} passed); per prefill "
          f"{model['prefill_launches']}, per decode step {model['decode_step_launches']}, "
          f"per prefill chunk {model['prefill_chunk_launches']}; "
          f"serve decode_tokens_per_s {serve['graphs']['decode_tokens_per_s']:.1f} "
          f"(eager {serve['eager']['decode_tokens_per_s']:.1f}) ttft_s_mean "
          f"{serve['graphs']['ttft_s_mean']:.3f}, paged serve decode_tokens_per_s "
          f"{paged['decode_tokens_per_s']:.1f} ttft_s_mean {paged['ttft_s_mean']:.3f}, "
          f"speculative paged path {spec['launches']} ({spec['seconds']:.1f} s), int8 "
          f"paged path {int8['launches']} ({int8['n_pages']} pages against "
          f"{int8['n_pages_3b']}), long-context path {long['launches']} ({long['splits']} "
          f"splits a step), streaming path {stream['launches']}, "
          f"train launches {train['launches']}, train losses "
          f"{[x['loss'] for x in train['steps']]}, compiled train step bit-equal to eager "
          f"{ {k: v['bit_equal'] for k, v in compiled['cases'].items()} } "
          f"({compiled['seconds']:.1f} s), train CLI launches (9 uninterrupted "
          f"steps) {cli['launches']}, restart max |loss diff| "
          f"{cli['6a']['restart_max_abs_diff_logged']}, {RWKV_ARCH} serving launches "
          f"{ {p: rwkv[p]['launches'] for p in ('7b', '7c', '7d')} } "
          f"({rwkv['seconds']:.1f} s), {ZAMBA_ARCH} launches "
          f"{ {p: zamba[p]['launches'] for p in ('8a', '8b', '8c', '8d')} } "
          f"({zamba['seconds']:.1f} s), {WHISPER_ARCH} launches "
          f"{ {p: whisper[p]['launches'] for p in ('9a', '9b', '9c', '9d')} } "
          f"({whisper['seconds']:.1f} s), {VLM_ARCH} launches "
          f"{ {p: vlm[p]['launches'] for p in ('10a', '10b', '10c', '10d')} } "
          f"({vlm['seconds']:.1f} s), moe launches "
          f"{ {p: moe[p]['launches'] for p in ('11a', '11b-lane', '11b-paged', '11c')} } "
          f"({moe['seconds']:.1f} s) on {gpu}; seconds per phase "
          f"{json.dumps(phase_s)}; total {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
