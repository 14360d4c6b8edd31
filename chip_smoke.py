#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each
printing one line and exiting non-zero on failure:

1. environment: the card's name and power limit, torch/CUDA versions, the
   seconds to build the CUDA kernels from ``flow_factory_tpu_torch/ops/csrc``
   (one nvcc per source, all started together), and what ``-Xptxas -v``
   and the SASS say of the forward and backward kernels (registers,
   spills, the wgmma warnings C7512/C7515, shared memory, setmaxnreg);
2. kernels: K1 (fused qk-norm flash forward), K2a/K2b (flash backward for dq
   and for dk/dv, head dim 64 and 128), K3 (plain flash forward, head dim 128 and 64; all CUDA
   C++), K5 (norm-modulate) and K6 (residual-gate-modulate) and their
   backward kernels (all four Triton) against their plain PyTorch versions
   at the SD3.5-M and Wan2.1-1.3B shapes, K2 also at the FLUX.1 1024-px
   geometry, and small ragged shapes, with stated tolerances, negative
   controls and CUDA-event timings (K5/K6 also their profiler device time,
   batch slices and the backwards against autograd through the plain
   forwards); for
   K1, K3 and K2 at head dim 128 also the profiler's device time (K2: with
   ``_bwd_prologue`` and SDPA's whole backward by the same method), for K1
   and K3 the wrapper's host cost a call, the bound with the ex2 term, the
   ratios to SDPA and to the bound, and a batch slice's bits; then the
   masked dispatch on the card (native, no K3 launch; flash raises); then
   the fp32 kernels at the JAX presets' head dims (K3, K2a, K2b at 16, 64,
   128; K1 at 16 and 128: the Wan self and cross shapes, SD3.5-M's self
   shape at 64, a tiny D=16 shape, ragged Sq != Sk shapes) against their
   plain versions with their bars,
   controls, repeated bits, times and bounds at the fp32 CUDA-core rate,
   and the pairs without a kernel (fp32 at D=32, fp16) raising;
3. the serving slice at full width: SD3.5-M (random weights from a seed,
   bf16) through ``load_adapter`` → ``inference`` (2 prompts x group 4 = 8
   samples, 512 px, 10 steps, CFG 4.5, Flow-SDE with log-probs, decode) →
   brightness reward → group advantages → no-grad replay of every stored
   transition, whose ratio ``exp(new_lp - old_lp)`` must be exactly 1.0;
   then a torch.profiler breakdown of one replayed step (device time by
   kernel, idle share; the trace goes to ``chiprun_out/``);
3a. import: SD3.5-M at full width and depth written by one adapter (A,
   seed 42) to a diffusers-layout directory (transformer, both CLIPs and
   the VAE as safetensors under their upstream names, each with its
   config.json; no T5-XXL) and built from it by ``load_adapter`` with
   ``strict_import`` and init seed 7 (B): B's imported tensors, its 10-step
   CFG rollout's latents, log-probs and images on A's prompt embeddings all
   equal A's bit for bit, its replay ratio is exactly 1.0, one grad step of
   its LoRA is finite and launches one training forward's and backward's
   kernels; seconds to write and to import, GB/s and peak memory;
3b. wan: the Wan2.1-T2V-1.3B serving slice at full width (random weights
   from a seed, bf16: the 30-layer DiT, UMT5-XXL, the causal video VAE)
   through ``load_adapter`` → ``inference`` (2 prompts x group 4 = 8
   videos, 256 px x 5 frames, 10 steps, CFG 5.0, Flow-SDE with log-probs,
   decode) → brightness reward → group advantages → no-grad replay (ratio
   exactly 1.0 on every stored step), K3 and K5 launched exactly as often
   as the code predicts, a 28-step UniPC eval rollout, and a profile of one
   replayed step;
4. grad: the LoRA gradient of a log-prob loss through the kernels at
   SD3.5-M width and reduced depth (2 blocks, one with dual attention,
   B=16), against the same gradient through the plain attention and plain
   norms, with negative controls (K2a's dq zeroed, K5's backward without
   its dmul term), and a non-zero gradient
   on every LoRA leaf of the attention projections and AdaLN linears;
5. train: the GRPO training slice at full width through ``load_trainer``
   (LoRA rank 32 on the default targets, fp32 master weights, the rollout
   geometry of phase 3, two grad steps accumulated into one AdamW update
   per epoch, EMA 0.99 every 4) for two epochs: the replay ratio is exactly
   1.0 on every grad step of both epochs (epoch 1 rolls out with the LoRA
   that epoch 0 moved), the gradient norm is finite and non-zero, the LoRA
   moves, and every kernel launches on the path; then F18's gate (a serving
   rollout of 8 replayed as micro-batches of 4 + 4, 2 x 4 and 5 + 3, ratio
   exactly 1.0 on every stored step of each; the first block's AdaLN
   modulation gives 4 rows the same bits alone as in the 8; the same 8 rows
   through the trainer's grad step as micro-batches of 5 + 3, GRPO's ratio
   exactly 1.0 on every row) and a torch.profiler breakdown of one grad
   step (forward, backward, optimizer);
5b. resume: the run plumbing on the SD3.5-M GRPO path at full width. The
   training config of 5 goes to a YAML file for ``python -m
   flow_factory_tpu_torch.cli`` in a subprocess on the card, which takes
   SIGTERM once epoch 0's row is in ``metrics.jsonl`` and must write a full
   state ``preempt/`` checkpoint (recorded epoch 0) and exit 0; then
   ``load_trainer`` with ``model.resume_path`` on it restores the trainable
   tree, the EMA and every AdamW tensor bit-equal to the files and runs
   epoch 1, whose rewards, advantages, losses, ratios (exactly 1.0) and LoRA
   after the update must equal 5's uninterrupted epoch 1 bit for bit; save
   and load seconds and bytes;
5c. parity (after 5b): the port's parity harness (``flow_factory_tpu_torch
   /parity``) on the card. The five families of the JAX package's golden
   test (SD3.5, Wan2.1 T2V, LTX-2 T2AV, FLUX.1-Kontext, Wan2.1 V2V) at their
   tiny size in fp32 under ``attn_backend: native`` with TF32 off, on the
   JAX tiny adapters' weights and draws (tests/goldens_torch), against the
   JAX goldens (tests/goldens) at ``DEFAULT_TOLERANCES`` with L1 exact: max
   |Δ| by level, K5 (and K6) launched in fp32, no attention kernel; the same
   five again under ``auto``: every attention through the fp32 K1 (SD3.5)
   or K3 (the rest) at head dim 16, no other kernel variant, the goldens at
   the same tolerances, L1 exact but for ``attn_backend``, each level's max
   |Δ| beside the native pass's; then SD3.5-M at full width and depth in
   bf16 under ``auto`` at 256 px, its own ``record`` checked on the card at
   max |Δ| exactly 0 on every key, the L3
   replay's log-prob the rollout's bit for bit;
5d. hybrid (after 5c): ``attn_backend: hybrid`` (the plain forward; K3's
   recompute, then K2a and K2b, in the backward): dq/dk/dv bit-equal to
   ``flash``'s at SD3.5-M's joint shape (B16 H24 S1357 D64) and Wan2.1's self
   shape (B16 H12 S512 D128) on the same q, k, v, dO, the forward within
   K3's bar of K3's plain version, no library attention op; K3 through the
   checks of 2 at SD3.5-M's joint and self shapes; one epoch of 5's GRPO
   slice under ``hybrid``: ratio exactly 1.0 on every grad step, no K1, 37
   K3 / K2a / K2b a grad step and no K3 in the rollout, its rollout and
   grad-step seconds and peak beside 5's;
6. the Wan counterpart of 4 (``[grad]``): LoRA gradients through K3, K2a/K2b
   at head dim 128 and K5 at Wan2.1-1.3B width, depth 2, B=16, against the
   plain path, with the dq-zeroed negative control;
7. wan-train: the Wan2.1-T2V-1.3B GRPO training slice at full width through
   ``load_trainer`` (the rollout geometry of 3b, LoRA rank 32 on the 300
   default targets, fp32 master weights, two grad steps accumulated into
   one AdamW update per epoch, EMA 0.99 every 4) for two epochs: ratio
   exactly 1.0 on every grad step, K2a/K2b 60 launches a grad step and K3
   60 a training forward, the LoRA moves; then the 28-step UniPC evaluation
   of the 2 test prompts under the EMA weights, and a profile of one grad
   step;
8. flux-kernels (run right after 2): K3 and K2a/K2b at the FLUX.1 512 px
   joint attention (B2 and B8, H24 S1536 D128) and K5 with its backward at
   width 3072 ((2, 1024), (2, 512), (2, 1536) rows), each against its plain
   version with the controls, bits, times and bounds of 2;
9. flux-grad: the counterpart of 4 at FLUX.1-dev width, one double and one
   single block, B=2, 1024 image + 512 text tokens, the dq-zeroed control;
10. flux-dpo: FLUX.1-dev LoRA DPO at full width through ``load_trainer`` on
   tests/fixtures/flux1_dpo.yaml for two epochs: K3 and K5 launched as
   predicted in each rollout and grad step, epoch 0's grad step at the zero
   LoRA with the implicit margin exactly 0 and the loss exactly
   -logsigmoid(0), a moved LoRA and another loss in epoch 1, peak memory
   against its prediction, and a profile of one grad step;
8b. kontext-kernels (run right after 8): K3, K2a/K2b and K5 at the
   FLUX.1-Kontext 512 px shapes (joint length 2560 = 512 text + 1024 target
   + 1024 condition tokens; B 8), with the condition tail padded, and a
   ragged S 2497, through the checks of 8;
11. kontext-grpo, kontext-nft, kontext-awm: FLUX.1-Kontext-dev LoRA image
   editing at full width through ``load_trainer`` on
   tests/fixtures/flux1_kontext_{grpo,nft,awm}.yaml, two epochs each on two
   records with one 512 px reference each (made from the seed under
   build/): 1024 condition tokens a row, K3/K5 launched as predicted in each
   rollout and K3/K2a/K2b/K5 and K5's backward in each grad step; on every
   grad step GRPO's replay ratio exactly 1.0, NFT's positive and negative
   losses equal, AWM's ratio exactly 1.0 on every row; a moved LoRA, peak
   memory against its prediction, and for GRPO a profile of one grad step;
8c. decoupled-kernels (run right after 8b): every kernel of the DGPO and
   CRD grad steps at their B 8 shapes (no CFG): K1 and K2a/K2b D=64 at
   SD3.5-M's joint and self attention, K3 and K2a/K2b D=128 at Wan's self
   and cross attention, K5 at SD3.5-M's and Wan's norms, K6 at SD3.5-M's,
   with their backwards, through the checks of 2;
12. dgpo, crd-wan: SD3.5-M LoRA DGPO (tests/fixtures/sd35_dgpo.yaml) and
   Wan2.1-T2V-1.3B LoRA CRD (tests/fixtures/wan21_crd.yaml) at full width
   through ``load_trainer``, two epochs each (one rollout batch and one
   micro-batch of 8, 4 grad steps and one optimizer step an epoch): the
   rollout's kernels launched as one CFG forward a step, under the policy
   the trainer must sample with (DGPO: the live tree, then its ``ema_ref``
   snapshot; CRD: its ``_crd_sampling`` snapshot); epoch 0's grad steps at
   θ = the snapshot = the zero LoRA with the invariants exact (DGPO
   pref_mean 0, group_weight_mean 0.5, kl 0, clip_ratio 0; CRD
   r_theta_mean 0, old_deviate 0, kl 0); three forwards and one backward a
   grad step in launches; a moved LoRA, peak memory beside the family's
   GRPO phase, and a profile of one grad step with its frozen forwards.
8d. ltx2-kernels (run right after 8c): K3 and K2a/K2b at head dim 128 and
   K5-RMS with its backward at every LTX-2 shape of a block (B 16 H 16:
   video self 128/128, audio self 9/9, video and audio to the 512 text
   tokens, a2v 128/9, v2a 9/128; the block norms bf16 -> bf16, the heads
   bf16 -> fp32, the I2AV video stream's per-token modulation), through the
   checks of 2 (a K2 control without the last of 9 keys, a K5 control
   without the RMS term of dx), then timed at 512 px x 97 frames (3328
   video, 94 audio tokens);
13. ltx2-grad, ltx2, ltx2-train: the LoRA gradient of both streams'
   log-probs through the kernels at LTX-2 width, depth 2, B 16 (the
   dq-zeroed and the K5-without-its-RMS-term controls); then LTX-2 T2AV GRPO
   at full width through ``load_trainer`` on
   tests/fixtures/ltx2_t2av_grpo.yaml (28 blocks, Gemma3-12B at 24 of its
   48 layers (tests/fixtures/ltx2_cut), the LTX
   video VAE and the audio VAE with its vocoder; 256 px x 9 frames, 10
   steps, CFG 3; 2 prompts x group 4), two epochs: videos (8, 9, 3, 256,
   256) and waveforms finite, K3/K5 launched as predicted a rollout and a
   grad step, a no-grad replay of every stored step with ratio exactly 1.0,
   the audio latents staged into every grad step, ratio exactly 1.0 on every
   grad step, a moved LoRA, peak memory against the prediction, a profiled
   grad step;
14. ltx2-i2av: LTX-2 I2AV GRPO at full width on
   tests/fixtures/ltx2_i2av_grpo.yaml, one epoch on two records of
   dataset/sharegpt4o_image_mini resized to 256 px: the planted first-frame
   tokens bit-equal in every stored latent and out of the log-prob, K5 on
   the per-token modulation, ratio exactly 1.0 on every grad step.
8e. wan22-kernels (run right after 8d): K3 and K2a/K2b at head dim 128 at
   the Wan2.2-A14B's attentions (B 16 H 40, 512 tokens, self and to the 512
   UMT5 tokens) and TI2V-5B's (H 24, 320 tokens), K5 and its backward at
   width 5120 and with the per-token modulation at width 3072, through the
   checks of 2;
15. wan22-grad, wan22-ti2v, wan22-moe, wan-v2v: the LoRA gradients at the
   A14B width, depth 2, at per-sample and per-frame timesteps; Wan2.2-TI2V-5B
   at full size on tests/fixtures/wan22_ti2v_grpo.yaml (256 px x 17 frames):
   a T2V serving rollout and its replay, then two I2V GRPO epochs with
   frame 0 the encoded image at every transformer call and at the decode;
   the A14B MoE at full width, 4 layers an expert, on
   tests/fixtures/wan22_a14b_grpo.yaml: two T2V GRPO epochs with each
   step's expert as JAX's rule gives it and the routed expert's LoRA alone
   with a gradient on each grad step, then one epoch of channel-concat I2V;
   channel-concat V2V on Wan2.1-1.3B (tests/fixtures/wan21_v2v_grpo.yaml):
   a rollout on condition clips given as arrays, its replay and an
   optimize phase. Each: launches as predicted, ratio exactly 1.0, peak
   memory, seconds, a profiled grad step.
8h. wan-i2v-kernels (run right after 8e): K3 and K2a/K2b at head dim 128
   at Wan2.1-I2V-14B's image cross-attention (B 16 H 40, 512 video tokens
   against the 257 CLIP tokens: one key in the last 64-key tile), through
   the checks of 2 (the one-key ragged tail's control among them);
8i. ring (run right after the family kernel checks): ``ops/ring_attention.py``
   as a loopback ring of 4 virtual ranks in one process through the
   module's hop and merge functions: at B1 H4 S2048 D128 bf16 against the
   plain versions on the whole sequence (a merge without the lse weights
   rejected), at B1 H40 S75600 D128 (Wan2.1-T2V-14B's self-attention at
   720 px x 81 frames, a hop 18900 x 18900) against K3 and K2 on the whole
   sequence at their bars, 16 K3 / 16 K2a / 16 K2b launches a ring call and
   no library attention op; the ring's forward and backward ms, a hop's
   K3/K2a/K2b beside their bounds, plain versions and SDPA (the kernel
   table's ``ring-hop`` rows), the merge's ms;
7c. wan-fp32 (right after 7): Wan2.1-T2V-1.3B LoRA GRPO in fp32 at full
   width and depth (tests/fixtures/wan21_fp32_grpo.yaml: mixed precision
   off, fp32 master and inference weights, ``auto``, remat, 4 steps, one
   grad step) for one epoch through ``load_trainer``: every attention call
   K3, K2a or K2b in fp32 at head dim 128, the launches predicted, ratio
   exactly 1.0, the LoRA moved, finite log-probs, a profiled grad step
   without a library attention kernel, seconds and peak against their
   prediction;
10b. dist1 (right after 7c): ``examples/multinode/wan21_fsdp.yaml`` at world
   size 1 (tests/fixtures/wan21_dist1.yaml: Wan2.1-1.3B at full width and
   depth, 256 px x 5 frames, 4 steps, micro-batch 1, 1 prompt x group 4,
   fsdp 1, the brightness reward): one epoch through ``torchrun --standalone
   --nproc_per_node 1 -m flow_factory_tpu_torch.cli`` (NCCL, the mesh
   (1, 1, 1)) and one in this process without a launcher, the LoRA bit for
   bit, ratio exactly 1.0, the collective calls; then
   ``tools/f18_bisect.py``'s bisection of the DiT at the per-rank CFG
   batch of 2 against its first row;
15b. wan-i2v14b (after 15): Wan2.1-I2V-14B GRPO with the CLIP image stream
   at full width, 7 of 40 layers, the 32-layer ViT-H/14, on
   tests/fixtures/wan21_i2v14b_grpo.yaml (256 px x 5 frames; two records of
   dataset/sharegpt4o_image_mini; the native PickScore scored
   asynchronously and the brightness reward), two epochs: the image tokens
   on every sample and staged into every grad step, 3 K3 a block, a no-grad
   replay of every stored step and every grad step at ratio exactly 1.0,
   the async CLIP scores equal to a synchronous rescoring bit for bit,
   F18's rollout of 4 rows and replay of rows 0-1 at 1.0,
   ``tools/f18_bisect.py``'s bisection of the DiT at B 16 against its first
   4 rows, launches as predicted, peak memory, a profiled grad step.
8f. qwen-kernels (run right after 8e): K3 at B 16 x 1536 tokens (Z-Image
   and Qwen-Image at 512 px) and B 8 x 3151 (Edit-Plus, ragged), K2a/K2b at
   B 16 x 1536 and B 4 x 3151, K5 and its backward at width 3072 (the
   AdaLN norms of both, Z-Image's final layer to fp32), through the checks
   of 2;
16. qwen-grad, z-image, qwen-image, qwen-edit: the LoRA gradients of both
   transformers at width 3072, depth 2; Z-Image at full width, 19 of 38
   layers (tests/fixtures/z_image_cut), on tests/fixtures/z_image_grpo.yaml (two GRPO epochs, then the Turbo
   serving rollout and its replay); Qwen-Image at full width, 16 double
   blocks (tests/fixtures/qwen_image_cut) on
   tests/fixtures/qwen_image_grpo.yaml (a serving rollout and its replay,
   two epochs); Qwen-Image-Edit-Plus with the full vision tower on
   tests/fixtures/qwen_image_edit_plus_grpo.yaml (the vision scatter, one
   epoch at the joint length 3151). Each: launches as predicted, ratio
   exactly 1.0, the negatives on every sample, peak memory, seconds, a
   profiled grad step.
8g. flux2-kernels (run right after 8f): K3 and K2a/K2b at FLUX.2's B8 H32
   S2560 D128 (512 text + 1024 target + 1024 condition tokens), K2a/K2b at
   Klein's grad step B8 H24 S1536, K5 and its backward at width 4096 ((8,
   2048 / 512 / 2560) rows), through the checks of 2;
17. klein, flux2: FLUX.2-Klein at full size (8 + 24 blocks at width 3072,
   the whole Mistral-Small) on tests/fixtures/flux2_klein_grpo.yaml, and
   FLUX.2 multi-reference I2I at full width with the gated FFN, 4 + 8
   blocks and an 8-layer Mistral-Small (tests/fixtures/flux2_cut) on
   tests/fixtures/flux2_grpo.yaml, both with the caption upsampler: the
   upsampler's strings the same on a second call, a serving rollout and its
   replay (Klein's also as micro-batches of 4 + 4, 2 x 4 and 5 + 3: F18's
   gate, with the first double block's AdaLN modulation and the first
   single block's ``linear1`` giving 4 rows the same bits alone), then two
   (Klein) or one (FLUX.2) GRPO epochs. Each: launches as predicted, ratio
   exactly 1.0, peak memory against its prediction, seconds, a profiled
   grad step.
18. ltx2-nft, ltx2-i2av-dpo, wan22-moe-awm, wan22-ti2v-dgpo, z-image-crd,
   qwen-image-nft, qwen-edit-awm: one epoch of a decoupled trainer on each
   family at the width of its GRPO phase (tests/fixtures/ltx2_t2av_nft.yaml,
   ltx2_i2av_dpo.yaml, wan22_a14b_awm.yaml, wan22_ti2v_dgpo.yaml,
   z_image_crd.yaml, qwen_image_nft.yaml, qwen_image_edit_plus_awm.yaml)
   through ``load_trainer``: the trainer's own rollout (the final latent
   alone), then a rollout of the batch's first 4 rows that keeps every step
   and a no-grad replay of its rows 0-1 (another micro-batch size than the
   rollout's) with ratio exactly 1.0 on every stored step, the trainer's
   step-0 invariants on every grad step of the epoch, a non-zero LoRA
   gradient on the component each grad step reaches (the A14B: the expert
   of its host timestep, both over the epoch), the launches predicted a
   grad step, no read of the timestep from the device for routing, a moved
   LoRA, peak memory against its prediction, seconds.
7b. full-grad, full-sd35, full-wan-dpo (run right after 7): full
   finetuning, the fp32 master the only copy of the trained weights on the
   card. The full-finetune gradient of every weight at SD3.5-M width and
   depth 2 through the kernels against the plain path (the position grid
   and the qk-norm scales through K1's backward included), with the
   controls K1's backward without dγ and K5's without dmul (a key
   projection's bias on its weight's gradient scale), and the port's
   update (in-place clip, AdamW's grouped path in groups of bounded size)
   against the update as it was, bit for bit; SD3.5-M full GRPO at full width and depth on
   tests/fixtures/sd35_full_grpo.yaml (remat, text encoders offloaded): two
   epochs with ratio exactly 1.0 on every stored step and grad step, every
   weight moved but the zero-gradient ones, the EMA off θ, launches as
   predicted, a grad step's and an update's seconds, the peak split by
   site, then a full-layout save and a fresh adapter resumed from it
   (master and replayed log-probs bit for bit); Wan2.1-1.3B full DPO on
   tests/fixtures/wan21_full_dpo.yaml, one epoch: the reference store equal
   to θ, the first loss exactly ln 2 and margin 0, launches as predicted,
   the peak.

The line before the last holds the kernel table as JSON (the FLUX.1,
FLUX.1-Kontext, B 8, LTX-2, Wan2.2, Qwen/Z-Image and FLUX.2 shapes nested
under their kernels' entries, with their launches in the DPO epochs, the
three Kontext phases, the DGPO or CRD epochs, the LTX-2 T2AV epochs, the
TI2V-5B I2V or A14B T2V epochs, the Wan2.1-I2V-14B epochs, the
Qwen/Z-Image epochs and the Klein or FLUX.2 epochs, each family's with its
decoupled phase of 18); ``[time]``
lines give the seconds since the start after each group of phases; the last
line is
``{"ok": true, "device": {...}}``.
Exits non-zero without a result when no CUDA device is visible or the
package is not beside the script.

``python3 chip_smoke.py --k2-d128 DIR`` times K2a/K2b at head dim 128 of the
port in the checkout DIR alone (``k2_d128_only``): run it on this checkout
and on a ``git archive`` of another commit in one call to compare the two
by one method on one card. ``python3 chip_smoke.py --norms DIR [--sweep]``
does the same for K5/K6 and their backwards (``norms_only``).
``python3 chip_smoke.py --import`` runs the build and 3a alone;
``python3 chip_smoke.py --kontext`` runs the build, 8b and 11 alone;
``python3 chip_smoke.py --decoupled`` the build, 8c and 12;
``python3 chip_smoke.py --ltx2`` the build, 8d, 13 and 14;
``python3 chip_smoke.py --wan22`` the build, 8e and 15;
``python3 chip_smoke.py --qwen`` and/or ``--z-image`` the build, 8f and
16 (Qwen-Image and Edit-Plus, and/or Z-Image);
``python3 chip_smoke.py --flux2`` the build, 8g and 17;
``python3 chip_smoke.py --decoupled-families`` the build and 18;
``python3 chip_smoke.py --wan-i2v`` the build, 8h, 15b and the device
times of 8h's shapes;
``python3 chip_smoke.py --full`` the build and 7b;
``python3 chip_smoke.py --full-grad SEED [SEED ...]`` the build and
``[full-grad]`` at each seed;
``python3 chip_smoke.py --ring`` and/or ``--dist1`` the build and 8i and/or 10b;
``python3 chip_smoke.py --parity`` and/or ``--hybrid`` the build and 5c and/or
5d (without 5's figures beside 5d's);
``python3 chip_smoke.py --fp32`` the build, 2's fp32 kernel rows, 5c and 7c
(``fp32_only``).
"""
from __future__ import annotations

import collections
import contextlib
import functools
import gc
import gzip
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate (data sheet)
#: H100 SXM fp32 rate outside the tensor cores: 132 SMs x 128 lanes x 2 (an
#: FMA) x 1.98 GHz, 66.9 TFLOP/s (the data sheet rounds it to 67)
PEAK_FP32_FLOPS = 132 * 128 * 2 * 1.98e9
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth
#: H100 SXM special-function rate: 16 ex2 a clock an SM (CUDA C Programming
#: Guide, arithmetic throughput, compute capability 9.0) x 132 SMs x 1.98 GHz
PEAK_EX2 = 16 * 132 * 1.98e9
#: the kernels of the SD3.5 GRPO path (K3 runs on the Wan path only)
SD35_KERNELS = ("qknorm_flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "ln_mul_add", "residual_gate_modulate",
                "ln_mul_add_backward", "residual_gate_modulate_backward")
#: K5 and K6 launches of one SD3.5-M training forward, and of its backward:
#: 62 K5 (24 + 13 dual norm1, 24 norm1_context, norm_out) and 47 K6 (24 x
#: side, 23 context side); block 0's three K5 norms take only frozen
#: inputs (the patch and context embeddings, the AdaLN vectors) and so have
#: no backward node: 59
SD35_NORMS_A_STEP = {"ln_mul_add": 62, "residual_gate_modulate": 47, "ln_mul_add_backward": 59,
                     "residual_gate_modulate_backward": 47}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 10, warmup: int = 2, reps: int = 5) -> float:
    """Milliseconds per call of ``fn``: the CUDA-event time of ``iters``
    back-to-back calls over ``iters``, the median of ``reps`` such runs. The
    host keeps the queue full, so a call's launch overhead counts only where
    it is longer than the device's work."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude x (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(x, 1e-30))) - 7)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def gpu_state() -> str:
    """The card's SM clock, its maximum, power draw and temperature now, as
    nvidia-smi reads them (clocks move kernel times between phases)."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    except OSError:
        return "not read"
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "not read"


def card_name() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"


def phase_environment():
    import torch

    card = card_name()
    from concurrent.futures import ThreadPoolExecutor

    from flow_factory_tpu_torch.ops import cuda_build

    sources = sorted(p.stem for p in cuda_build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        list(pool.map(cuda_build.build, sources))
    build_s = time.perf_counter() - t0
    log(f"[env] card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | nvcc build of {sources} "
        f"{build_s:.2f} s")
    import importlib.util

    present = {name: importlib.util.find_spec(name) is not None for name in ("yaml", "PIL", "imageio")}
    log(f"[env] optional packages importable: {present} (the CLI reads its config with PyYAML; "
        f"media logging needs PIL)")
    _log_ptxas_figures(cuda_build)
    return card


def _log_ptxas_figures(cuda_build, names=("flash_fwd", "qknorm_flash_fwd", "flash_bwd")) -> None:
    """What ``nvcc -Xptxas -v`` said of the kernels of the sources ``names``
    (registers at launch, spills, and its C75xx warnings: wgmma serialized,
    C7512 for want of registers, C7515 for accumulators touched between issue
    and wait), their dynamic shared memory, and the registers that setmaxnreg
    gives each warpgroup, read from the SASS where cuobjdump is there."""
    import ctypes

    def smem_fn(name: str, fn: str):  # None where the source exports no such query
        return getattr(ctypes.CDLL(str(cuda_build.library_path(name))), fn, None)

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name in names:
        lib = cuda_build.library_path(name)
        text = lib.with_suffix(".log").read_text()
        sass = {}
        if os.path.exists(cuobjdump):
            out = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True).stdout
            for fn in out.split("Function : ")[1:]:
                regs = re.findall(r"USETMAXREG\S*\s+(?:\S+,\s*)?0x([0-9a-f]+)", fn)
                sass[fn.splitlines()[0].strip()] = [int(v, 16) for v in regs]
        for m in re.finditer(r"Function properties for (\S+)\n\s+(\d+) bytes stack frame, (\d+) bytes spill stores, "
                             r"(\d+) bytes spill loads\n[^\n]*Used (\d+) registers", text):
            mangled, stack, st, ld, regs = m.groups()
            fwd = re.search(r"flash_fwd_wgmma_kernelILi(\d+)ELb([01])E", mangled)
            f32 = re.search(r"flash_fwd_f32_kernelILi(\d+)ELb([01])E", mangled)
            bwd = re.search(r"(flash_bwd_\w*?_kernel)(?:ILi(\d+)E)?", mangled)
            smem = None
            if f32:
                what = f"flash_fwd_f32_kernel<{f32.group(1)}, {'true' if f32.group(2) == '1' else 'false'}> ({name}.cu)"
            elif fwd:
                D, norm = int(fwd.group(1)), fwd.group(2)
                what = f"flash_fwd_wgmma_kernel<{D}, {'true' if norm == '1' else 'false'}> ({name}.cu)"
                fn = smem_fn(name, "flash_fwd_smem_bytes" if norm == "0" else "qknorm_flash_fwd_smem_bytes")
                smem = fn(D) if norm == "0" else fn()
            elif "key_norm_kernel" in mangled:
                what = f"key_norm_kernel ({name}.cu)"
            elif bwd and name == "flash_bwd":
                what = f"{bwd.group(1)}{f'<{bwd.group(2)}>' if bwd.group(2) else ''} ({name}.cu)"
                fn = smem_fn(name, "flash_bwd_smem_bytes")
                if fn is not None and "wgmma" in what:
                    smem = fn(128 if "wgmma128" in what else 64)
            else:
                continue
            warns = sorted(set(re.findall(r"\((C75\d\d)\)[^\n]*" + re.escape(mangled), text)))
            extra = "" if smem is None else f", dynamic shared memory {smem} B"
            if "wgmma" in what:
                extra += f", setmaxnreg {sass.get(mangled, 'not read') if sass else 'not read'}"
                extra += f", wgmma warnings {', '.join(warns) if warns else 'none'}"
            log(f"[env] ptxas {what}: {regs} registers at launch, {st} bytes spill stores, {ld} bytes spill "
                f"loads, {stack} bytes stack{extra}")


def _check(name: str, err: float, tol: float) -> None:
    status = "ok" if err <= tol else "FAILED"
    log(f"[kernels] {name}: max|d| {err:.3e} (tol {tol:.3e}) {status}")
    if not err <= tol:
        fail(f"{name} disagrees with its plain version: {err} > {tol}")


def _k1_errors(out, lse, ref, ref_lse):
    return (out.float() - ref.float()).abs().max().item(), (lse - ref_lse).abs().max().item()


def _negative_control(name: str, kernel, wrong_ref, tol_o: float, tol_lse: float) -> None:
    """The K1 check must reject a reference that computes something else."""
    err_o, err_lse = _k1_errors(*kernel, *wrong_ref)
    caught = err_o > tol_o or err_lse > tol_lse
    log(f"[kernels] negative control, {name}: max|d| O {err_o:.3e} (tol {tol_o:.3e}), lse {err_lse:.3e} "
        f"(tol {tol_lse:.3e}) {'rejected as it must be' if caught else 'NOT REJECTED'}")
    if not caught:
        fail(f"the K1 check cannot tell the kernel from a wrong one: {name}")


def _record(results: dict, tag: str, entry: dict) -> None:
    """The first (largest) shape of a kernel is its entry; later shapes nest
    under ``shapes``."""
    first = results.setdefault(entry["name"], {**entry, "shape": tag, "shapes": {}})
    if first is not entry and first["shape"] != tag:
        first["shapes"][tag] = {k: entry[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                                      "library_ms")}


#: the kernel shapes whose device time the profiler takes after the
#: end-to-end phases: callables that make fresh inputs of the shape and log
#: the line
DEVICE_TIME_JOBS: list = []


def _k1_call(B: int, H: int, S: int, D: int, strided: bool, scale: float):
    """K1 on fresh bf16 inputs of a timed shape and layout, as a call."""
    import torch

    from flow_factory_tpu_torch.ops import attention as A

    q, k, v = (torch.randn((B, S, H, D) if strided else (B, H, S, D), device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    if strided:
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    g = (1.0 + 0.1 * torch.randn(S, D, device="cuda")).contiguous()
    return functools.partial(A.qknorm_flash_attention, q, k, v, g, g.clone(), scale, 1e-6)


def _k3_call(B: int, H: int, Sq: int, Sk: int, D: int, q_contiguous: bool, scale: float):
    """K3 on fresh bf16 inputs of a timed shape: k/v (and q unless
    ``q_contiguous``) head-split views of (B, S, H*D) projections."""
    import torch

    from flow_factory_tpu_torch.ops import attention as A

    view = lambda S: torch.randn(B, S, H, D, device="cuda", dtype=torch.bfloat16).transpose(1, 2)
    q = torch.randn(B, H, Sq, D, device="cuda", dtype=torch.bfloat16) if q_contiguous else view(Sq)
    return functools.partial(A.flash_attention, q, view(Sk), view(Sk), scale)


def _device_ms(fn, calls: int = 20, sessions: int = 10) -> float:
    """Device time of one call of ``fn`` by torch.profiler over ``calls``
    back-to-back calls (the CUDA-event time of back-to-back calls is the
    host's where the wrapper takes longer to enqueue than the kernel to run):
    each CUDA kernel's mean over the records the profiler kept, times its
    launches a call (its records over ``calls``, rounded, at least one),
    summed over kernels. Sessions late in this long process lose records: a
    sum over the records over ``calls`` read low (K2b at the FLUX.1 shape
    0.64 ms from 12-13 records of 20, against 1.03 ms by events and in a
    fresh process), one session kept none, and once five sessions in a row
    kept none. So a session that lost records is repeated, up to
    ``sessions`` in all, the one that kept the
    most kernels and records is used, and its share of records kept is
    logged where it is below 1. Profiling leaves the host slower for the
    rest of the process (the host-bound Wan eval took longer after a profile
    on the card), so these profiles run after the end-to-end phases."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    dev = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
    best = None
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA and e.count]
        if not kernels:
            continue
        per_call = [max(1, round(e.count / calls)) for e in kernels]
        kept = sum(e.count for e in kernels) / (calls * sum(per_call))
        if best is None or (len(kernels), kept) > (len(best[1]), best[0]):
            best = (kept, kernels, per_call)
        if kept >= 0.999:
            break
    if best is None:
        fail(f"torch.profiler kept no kernel record in {sessions} sessions of {calls} calls")
    kept, kernels, per_call = best
    if kept < 0.999:
        log(f"[kernels] the profiler kept {kept:.3f} of the kernel records over {calls} calls (best of "
            f"{sessions} sessions); device time from each kernel's mean over the records kept")
    return sum(dev(e) / e.count * n for e, n in zip(kernels, per_call)) / 1e3


def _host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn`` takes to enqueue (at a shape so
    small that the card never holds the host back, or a few calls of a real
    one, whose work queues behind)."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _fwd_bound(B: int, H: int, Sq: int, Sk: int, D: int, byts: int):
    """The least time of a flash forward on the card, in ms, and what sets
    it: the bytes, the products (4 B H Sq Sk D FLOP) or the exponentials (one
    ex2 a score, B H Sq Sk, at PEAK_EX2). Also the products' and the
    exponentials' times, the bound without the ex2 term (as the forward rows
    had it before) and the two terms one after the other."""
    t_bytes, t_ops = byts / PEAK_BYTES, 4 * B * H * Sq * Sk * D / PEAK_BF16_FLOPS
    t_ex2 = B * H * Sq * Sk / PEAK_EX2
    bound = max(t_bytes, t_ops, t_ex2)
    return bound * 1e3, "bytes" if bound == t_bytes else "operations", t_ops * 1e3, t_ex2 * 1e3, \
        max(t_bytes, t_ops) * 1e3, (t_ops + t_ex2) * 1e3


def _fwd_batch_slice_same(name: str, run, *inputs) -> None:
    """A kernel on the first half of the batch gives the bits of the first
    half of its output on the whole batch: no row depends on another batch
    row (rollout under CFG against replay and training forwards)."""
    import torch

    out, lse = run(*inputs)
    half = inputs[0].shape[0] // 2
    part, part_lse = run(*(t[:half] for t in inputs[:3]), *inputs[3:])
    same = torch.equal(part, out[:half]) and torch.equal(part_lse, lse[:half])
    log(f"[kernels] {name}: the first {half} batch rows alone give the bits of the whole batch's: {same}")
    if not same:
        fail(f"{name}: a batch slice changes the bits")


def _fwd_time_line(name: str, ms: float, plain_ms: float, lib_ms: float, bound, dev_ms=None, host_us=None) -> None:
    """A K1/K3 timing line: by CUDA events and the wrapper's host time a
    call here, again with the profiler's device time at the end of the run
    (``phase_device_times``)."""
    bound_ms, bound_by, ops_ms, ex2_ms, old_bound, serial = bound
    t, what = (ms, "events") if dev_ms is None else (dev_ms, "device")
    head = (f"kernel {ms:.3f} ms (events) | host {host_us:.1f} us a call | plain {plain_ms:.3f} ms"
            if dev_ms is None else f"device {dev_ms:.4f} ms (profiler) | kernel {ms:.3f} ms (events)")
    log(f"[kernels] {name}: {head} | sdpa {lib_ms:.3f} ms ({what}/sdpa {t / lib_ms:.2f}x) | bound {bound_ms:.4f} ms "
        f"by {bound_by} ({what}/bound {t / bound_ms:.2f}x; products {ops_ms:.4f}, ex2 {ex2_ms:.4f}, the two one "
        f"after the other {serial:.4f}, bound without ex2 {old_bound:.4f}) | "
        f"{ops_ms * PEAK_BF16_FLOPS / 1e12 / t:.1f} TFLOP/s")


def _fwd_device_job(name: str, make_call, ms: float, lib_ms: float, bound) -> None:
    _fwd_time_line(name, ms, None, lib_ms, bound, _device_ms(make_call()))


def phase_device_times() -> None:
    """The profiler's device time of each K1/K2 D=128/K3 shape the kernel
    phase kept, after the end-to-end phases (see ``_device_ms``)."""
    log(f"[kernels] card before the device times (SM clock, max, power, temperature): {gpu_state()}")
    for job in DEVICE_TIME_JOBS:
        job()
    log(f"[kernels] card after the device times: {gpu_state()}")
    DEVICE_TIME_JOBS.clear()


#: K1 shapes: tag, B, H, S, D, dtype, strided, timed. joint: SD3.5-M's joint
#: attention (1024 image + 333 text tokens) at the CFG-doubled B 16 of the
#: rollout and the GRPO grad step; self: its dual blocks' image
#: self-attention; the -b8 shapes: both at the B 8 of DGPO's grad-step
#: forwards (no CFG); ragged: small shapes with a ragged key tail
K1_SHAPES = (("joint", 16, 24, 1357, 64, "bfloat16", False, True),
             ("self", 16, 24, 1024, 64, "bfloat16", True, True),
             ("ragged-fp32", 2, 3, 197, 64, "float32", False, False),
             ("ragged-bf16", 2, 3, 77, 64, "bfloat16", True, False))


def _k1_shape_checks(results: dict, randn, tag: str, B: int, H: int, S: int, D: int, dtype, strided: bool,
                     timed: bool) -> None:
    """One K1 shape of ``phase_kernels`` (``K1_SHAPES``): O and lse against
    the plain version, for the joint shape the negative controls; for timed
    shapes a batch slice's bits, the CUDA-event, plain and SDPA times, the
    bound, the table entry and the device-time job."""
    import torch
    import torch.nn.functional as F

    from flow_factory_tpu_torch.ops import attention as A

    dtype = getattr(torch, dtype)
    if strided:
        q, k, v = (randn(B, S, H, D, dtype=dtype).transpose(1, 2) for _ in range(3))
    else:
        q, k, v = (randn(B, H, S, D, dtype=dtype) for _ in range(3))
    gq = (1.0 + 0.1 * randn(S, D, dtype=torch.float32)).contiguous()
    gk = (1.0 + 0.1 * randn(S, D, dtype=torch.float32)).contiguous()
    scale = D ** -0.5
    out, lse = A.qknorm_flash_attention(q, k, v, gq, gk, scale, 1e-6, return_lse=True)
    ref, ref_lse = A.qknorm_attention_plain(q, k, v, gq, gk, scale, 1e-6, return_lse=True)
    torch.cuda.synchronize()
    tol_o, tol_lse = ((1e-4, 1e-3) if dtype == torch.float32
                      else (4 * bf16_ulp(ref.float().abs().max().item()), 1e-2))
    err_o, err_lse = _k1_errors(out, lse, ref, ref_lse)
    layout = "strided" if strided else "contiguous"
    _check(f"K1 {tag} O {tuple(q.shape)} {dtype} {layout}", err_o, tol_o)
    _check(f"K1 {tag} lse", err_lse, tol_lse)
    if tag == "joint":
        ones = torch.ones_like(gq)
        _negative_control("K1 joint vs a plain version without the gamma maps", (out, lse),
                          A.qknorm_attention_plain(q, k, v, ones, ones, scale, 1e-6, return_lse=True),
                          tol_o, tol_lse)
        n = S // 64 * 64  # the kernel's last whole key tile
        _negative_control(f"K1 joint vs a plain version without the {S - n}-key ragged tail", (out, lse),
                          A.qknorm_attention_plain(q, k[:, :, :n], v[:, :, :n], gq, gk[:n], scale, 1e-6,
                                                   return_lse=True), tol_o, tol_lse)
    if not timed:
        return
    log(f"[kernels] card before K1 {tag}'s timings (SM clock, max, power, temperature): {gpu_state()}")
    k1 = lambda *t: A.qknorm_flash_attention(*t, scale, 1e-6, return_lse=True)
    _fwd_batch_slice_same(f"K1 {tag}", k1, q, k, v, gq, gk)
    call = lambda: A.qknorm_flash_attention(q, k, v, gq, gk, scale, 1e-6)
    ms, host_us = time_ms(call), _host_us(call, 50)
    plain_ms = time_ms(lambda: A.qknorm_attention_plain(q, k, v, gq, gk, scale, 1e-6), iters=3)
    qn = A._rms_scale(q, gq, 1e-6).to(dtype)
    kn = A._rms_scale(k, gk, 1e-6).to(dtype)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qn, kn, v, scale=scale))
    bound = _fwd_bound(B, H, S, S, D, nbytes(q, k, v, gq, gk, out, lse))
    _record(results, tag, dict(
        name="qknorm_flash_fwd", route="cuda",
        source="flow_factory_tpu_torch/ops/csrc/qknorm_flash_fwd.cu",
        replaces="flow_factory_tpu/ops/attention.py:368",
        max_abs_err=err_o, ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
        library_ms=lib_ms))
    _fwd_time_line(f"K1 {tag}", ms, plain_ms, lib_ms, bound, host_us=host_us)
    DEVICE_TIME_JOBS.append(functools.partial(_fwd_device_job, f"K1 {tag}",
                                              functools.partial(_k1_call, B, H, S, D, strided, scale), ms,
                                              lib_ms, bound))
    del q, k, v, out, ref, qn, kn
    torch.cuda.empty_cache()


def phase_kernels(results: dict) -> None:
    import torch

    from flow_factory_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *shape, dtype=torch.bfloat16: torch.randn(
        shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    # ---- K1: fused qk-norm flash forward -------------------------------------
    # Tolerances. fp32 inputs differ from the plain version only by summation
    # order and exp2 vs exp: 1e-4 on O, 1e-3 on lse. bf16: after the RMS norm
    # q.k.D^-1/2 has a std of ~1, so O, a softmax-weighted mean of ~1000 V
    # rows, stays below ~0.5. The kernel rounds the normalised q once with
    # scale*log2(e) folded in, the plain version rounds it unscaled; that moves
    # logits by a fraction of a bf16 ulp and O by 1-2 ulp of max|O| (measured
    # on the card), so the bar is 4 ulp of max|O| on O and 1e-2 on lse
    # (measured <= 3e-3). Wrong kernels miss these bars: the negative controls
    # below compare the kernel with a plain version that ignores the gamma
    # maps, or drops the ragged key tail, and must FAIL the same check.
    # The self case has the head-split strided layout that SelfAttention
    # passes, (B, S, H, D).transpose(1, 2); the joint case is the contiguous
    # output of JointAttention's context/image concatenation.
    for shape in K1_SHAPES:
        _k1_shape_checks(results, randn, *shape)
    g = torch.ones(64, 64, device=dev)
    tiny = [randn(1, 1, 64, 64) for _ in range(3)]
    log(f"[kernels] K1 host cost a call (B1 H1 S64 bf16, the wrapper, its key pre-pass and wgmma launches, "
        f"3 tensor maps): {_host_us(lambda: A.qknorm_flash_attention(*tiny, g, g, 0.125, 1e-6)):.1f} us")

    phase_kernels_k2(results, randn)
    phase_kernels_k3(results, randn)
    phase_kernels_f32(results)

    phase_kernels_norms(results, gen)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# K5 / K6: the norm-and-modulate forwards and their backward kernels
# ---------------------------------------------------------------------------

#: K5 shapes: tag, B, S, D, x dtype, out dtype, per-token modulation, fold,
#: rms, timed. image/context: the SD3.5-M AdaLN norms (a grad step runs 62,
#: 59 of them with a backward); wan: the Wan2.1-1.3B block norms; wan-norm2:
#: its affine norm2 (the fold path: F.layer_norm computes the same function);
#: wan-head: bf16 in, fp32 out; degenerate: constant and near-constant rows.
NormShape = collections.namedtuple("NormShape", "tag B S D dtype out_dtype per_token fold rms timed")
K5_SHAPES = tuple(NormShape(*shape) for shape in (
    ("image", 16, 1024, 1536, "bfloat16", "bfloat16", False, False, False, True),
    ("context", 16, 333, 1536, "bfloat16", "bfloat16", False, False, False, True),
    ("wan", 16, 512, 1536, "bfloat16", "bfloat16", False, False, False, True),
    ("wan-norm2", 16, 512, 1536, "bfloat16", "bfloat16", False, True, False, True),
    ("wan-head", 16, 512, 1536, "bfloat16", "float32", False, False, False, False),
    ("ragged-fold", 3, 77, 200, "float32", "float32", False, True, False, False),
    ("ragged-rms-token", 3, 77, 200, "float32", "float32", True, False, True, False),
    ("bf16-token", 2, 45, 1536, "bfloat16", "bfloat16", True, False, False, False),
    ("degenerate", 4, 64, 256, "float32", "float32", False, False, False, False),
))
#: K6 shapes: tag, B, S, D, dtype, timed (SD3.5-M: 24 image, 23 context calls a grad step)
K6_SHAPES = tuple(NormShape(tag, B, S, D, dt, dt, False, False, False, timed) for tag, B, S, D, dt, timed in (
    ("image", 16, 1024, 1536, "bfloat16", True),
    ("context", 16, 333, 1536, "bfloat16", True),
    ("ragged-fp32", 3, 77, 200, "float32", False),
    ("ragged-bf16", 2, 45, 1536, "bfloat16", False),
    ("degenerate", 4, 64, 256, "float32", False),
))
#: what the grad steps ask of each backward: dx alone from K5 (the AdaLN
#: vectors, norm2's weight and the head's table are frozen under LoRA), dx
#: and dbranch from K6; the checks also ask for every gradient
K5_MAIN_NEEDS, K6_MAIN_NEEDS = (True, False, False), (True, True, False, False, False)


def _norm_inputs(gen, B: int, S: int, D: int, dtype, out_dtype, per_token: bool, k6: bool, degenerate: bool):
    """Fresh inputs of a K5 (``k6`` False) or K6 case on the card: x (and
    branch, gate), mul, add and the cotangents. ``degenerate``: every fourth
    row from row 0 constant (0.75: its sums are exact in any order, its fast
    variance exactly 0), every fourth from row 1 near-constant (2^-6 plus
    1e-8 noise: the fast variance rounds to about +-3e-11, at or below 0 on
    many rows, far below eps, so r = rsqrt(eps) to 1.5e-5 whatever the sum
    order); K6 takes branch 0 on those rows, so x_new is x there."""
    import torch

    randn = lambda *shape, dt=torch.float32: torch.randn(shape, generator=gen, device="cuda").to(dt)
    x = randn(B, S, D, dt=dtype)
    if degenerate:
        x[:, 0::4] = 0.75
        x[:, 1::4] = 2.0 ** -6 + 1e-8 * randn(B, len(range(1, S, 4)), D)
    mshape = (B, S if per_token else 1, D)
    case = dict(x=x, mul=(1.0 + 0.1 * randn(*mshape)).contiguous(), add=(0.1 * randn(*mshape)).contiguous())
    if k6:
        branch = randn(B, S, D, dt=dtype)
        if degenerate:
            branch[:, 0::4] = 0.0
            branch[:, 1::4] = 0.0
        case.update(branch=branch, gate=randn(B, D), g_new=randn(B, S, D, dt=dtype))
    case["g"] = randn(B, S, D, dt=out_dtype)
    return case


def _norm_calls(N, case: dict, eps: float, out_dtype, fold: bool, rms: bool, k6: bool, needs):
    """(forward, backward) calls of the kernel wrappers on a case."""
    c = case
    if k6:
        return (lambda: N.residual_gate_modulate_rows(c["x"], c["branch"], c["gate"], c["mul"], c["add"], eps,
                                                      out_dtype),
                lambda: N.residual_gate_modulate_backward(c["x"], c["branch"], c["gate"], c["mul"], c["g_new"],
                                                          c["g"], eps, needs))
    return (lambda: N.ln_mul_add(c["x"], c["mul"], c["add"], eps, out_dtype, fold=fold, rms=rms),
            lambda: N.ln_mul_add_backward(c["x"], c["mul"], c["g"], eps, rms, needs))


def _bytes_or_ops(byts: int, flops: int):
    """The least time in ms of a pass that moves ``byts`` and does ``flops``
    fp32 operations outside the tensor cores, and which of the two sets it."""
    t_bytes, t_ops = byts / PEAK_BYTES, flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _norm_device_job(name: str, make_case, which: int, ms: float, bound: float, plain_ms: float,
                     lib_ms=None) -> None:
    """The profiler's device time of a K5/K6 forward (``which`` 0) or
    backward (1) on fresh inputs, at the end of the run."""
    dev = _device_ms(make_case()[which])
    lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms (events)"
    log(f"[kernels] {name}: device {dev:.4f} ms (profiler) | kernel {ms:.4f} ms (events) | bound {bound:.4f} ms "
        f"(device/bound {dev / bound:.2f}x) | plain {plain_ms:.3f} ms | library {lib}")


def _norm_case_calls(N, gen_seed: int, shape: NormShape, k6: bool, needs):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(gen_seed)
    out_dtype = getattr(torch, shape.out_dtype)
    case = _norm_inputs(gen, shape.B, shape.S, shape.D, getattr(torch, shape.dtype), out_dtype, shape.per_token, k6,
                        shape.tag == "degenerate")
    return _norm_calls(N, case, 1e-6, out_dtype, shape.fold, shape.rms, k6, needs)


def _bar(dtype, ref, ulps: float = 1.0, rel: float = 1e-5) -> float:
    """``ulps`` bf16 ulp of max|ref| for a bf16 tensor, else ``rel`` of it."""
    import torch

    mag = ref.float().abs().max().item()
    return ulps * bf16_ulp(mag) if ref.dtype == torch.bfloat16 else rel * max(mag, 1e-30)


def _grads_check(name: str, got, ref, names, bars) -> list:
    """Each gradient of ``got`` against ``ref`` within its bar (None where
    not asked, in both); returns the errors."""
    errs = []
    for what, a, b, bar in zip(names, got, ref, bars):
        if (a is None) != (b is None):
            fail(f"{name}: {what} is {'missing' if a is None else 'there but not asked for'}")
        if a is None:
            continue
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"{name}: {what} {a.dtype} {tuple(a.shape)}, expected {b.dtype} {tuple(b.shape)}")
        err = (a.float() - b.float()).abs().max().item()
        errs.append(err)
        _check(f"{name} {what}", err, bar if isinstance(bar, float) else bar(b))
    return errs


def _backward_controls(name: str, got, wrong_dx, dmul_index: int, dx_bar) -> None:
    """The backward checks must reject a backward without the
    x_hat * mean(g_hat * x_hat) term and one with dmul zeroed."""
    for what, a, b, bar in (("without the x_hat * mean(g_hat * x_hat) term", got[0], wrong_dx, dx_bar),
                            ("with dmul zeroed", got[dmul_index], None, None)):
        b = b if b is not None else a.new_zeros(a.shape)
        bar = bar(b) if bar is not None else 1e-5 * a.abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        caught = err > bar
        log(f"[kernels] negative control, {name} vs a backward {what}: max|d| {err:.3e} (bar {bar:.3e}) "
            f"{'rejected as it must be' if caught else 'NOT REJECTED'}")
        if not caught:
            fail(f"the {name} check cannot tell the kernel from a backward {what}")


def _k5_shape_checks(results: dict, gen, shape: NormShape, controls: bool) -> None:
    """One K5 shape of ``phase_kernels_norms``: the forward and backward
    against their plain versions and autograd through the plain forward, two
    backward launches' bits; with ``controls`` the backward's negative
    controls and a batch slice; timings and table entries if ``shape.timed``."""
    import torch

    from flow_factory_tpu_torch.ops import norms as N

    eps = 1e-6
    tag, B, S, D, dt, odt, per_token, fold, rms, timed = shape
    name = f"K5 {tag} {(B, S, D)} {dt}->{odt}{' fold' if fold else ''}{' rms' if rms else ''}" \
           f"{' per-token' if per_token else ''}"
    dtype, out_dtype = getattr(torch, dt), getattr(torch, odt)
    rel = 1e-4 if tag == "degenerate" else 1e-5  # fp32 dx, see phase_kernels_norms
    case = _norm_inputs(gen, B, S, D, dtype, out_dtype, per_token, False, tag == "degenerate")
    x, mul, add, g = case["x"], case["mul"], case["add"], case["g"]
    out = N.ln_mul_add(x, mul, add, eps, out_dtype, fold=fold, rms=rms)
    ref = N._native_ln_mul_add(x, mul, add, eps, out_dtype, fold, rms)
    err = (out.float() - ref.float()).abs().max().item()
    _check(f"{name} forward", err, _bar(dtype, ref))
    if tag == "degenerate":
        x32 = x.float()
        raw = (x32 * x32).mean(-1) - x32.mean(-1) ** 2
        log(f"[kernels] {name}: rows whose fast variance the plain version rounds to 0: "
            f"{int((raw == 0).sum())}, below 0: {int((raw < 0).sum())} of {B * S}")
    # backward, every gradient asked for and the main path's subset
    leaves = [t.detach().clone().requires_grad_() for t in (x, mul, add)]
    eager = torch.autograd.grad(N._native_ln_mul_add(*leaves, eps, out_dtype, fold, rms), leaves, g)
    for needs in ((True, True, True), K5_MAIN_NEEDS):
        got = N.ln_mul_add_backward(x, mul, g, eps, rms, needs)
        plain = N._native_ln_mul_add_backward(x, mul, g, eps, rms, needs)
        bars = (lambda r: _bar(dtype, r, rel=rel), lambda r: _bar(torch.float32, r),
                lambda r: _bar(torch.float32, r))
        _grads_check(f"{name} backward {needs} vs plain", got, plain, ("dx", "dmul", "dadd"), bars)
    got = N.ln_mul_add_backward(x, mul, g, eps, rms, (True, True, True))
    eager_bars = (lambda r: _bar(dtype, r, 2.0, 1e-4), lambda r: _bar(torch.float32, r, rel=1e-4),
                  lambda r: _bar(torch.float32, r, rel=1e-4))
    _grads_check(f"{name} backward vs autograd through the plain forward", got, eager,
                 ("dx", "dmul", "dadd"), eager_bars)
    again = N.ln_mul_add_backward(x, mul, g, eps, rms, (True, True, True))
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"[kernels] {name} backward: two launches give the same bits: {same}")
    if not same:
        fail(f"{name}: the backward is not deterministic")
    if controls:
        x32 = x.float()
        r, xhat, raw = N._ln_stats(x32, eps, rms)
        # LayerNorm: the x_hat term dropped as on clamped rows; RMS: its only
        # projection term, -x_hat * mean(g_hat * x_hat), dropped
        wrong = (r * g.float() * mul if rms else N._ln_dx(g.float(), mul, r, xhat, torch.full_like(raw, -1.0)))
        wrong = wrong.to(dtype)
        _backward_controls(name, got, wrong, 1, lambda r: _bar(dtype, r))
        n = min(4, B // 2)
        part = N.ln_mul_add(x[:n], mul[:n], add[:n], eps, out_dtype, fold=fold, rms=rms)
        same = torch.equal(part, out[:n])
        log(f"[kernels] {name}: the first {n} batch rows alone give the bits of the whole batch's: {same}")
        if not same:
            fail(f"{name}: a batch slice changes the bits")
    if timed:
        _norm_timings(results, "ln_mul_add", f"K5 {tag}", shape, False, case, out, err, (x, mul, add, out),
                      N, eps)
    del case, x, mul, add, g, out, ref, leaves, eager, got, again
    torch.cuda.empty_cache()


def _k6_shape_checks(results: dict, gen, shape: NormShape, controls: bool) -> None:
    """One K6 shape of ``phase_kernels_norms``: the forward and backward
    against their plain versions and autograd through the plain forward, two
    backward launches' bits; with ``controls`` the backward's negative
    control and a batch slice; timings and table entries if ``shape.timed``."""
    import torch

    from flow_factory_tpu_torch.ops import norms as N

    eps = 1e-6
    tag, B, S, D, dt, _, _, _, _, timed = shape
    name = f"K6 {tag} {(B, S, D)} {dt}"
    dtype = getattr(torch, dt)
    case = _norm_inputs(gen, B, S, D, dtype, dtype, False, True, tag == "degenerate")
    x, br, gate, mul, add = (case[k] for k in ("x", "branch", "gate", "mul", "add"))
    g_new, g = case["g_new"], case["g"]
    xn, xm = N.residual_gate_modulate_rows(x, br, gate, mul, add, eps, dtype)
    rn, rm = N._native_residual_gate_modulate(x, br, gate, mul, add, eps, dtype)
    err_n = (xn.float() - rn.float()).abs().max().item()
    err_m = (xm.float() - rm.float()).abs().max().item()
    _check(f"{name} forward x_new", err_n, 0.0 if dtype == torch.bfloat16 else 1e-6 * max(
        1.0, rn.float().abs().max().item()))
    _check(f"{name} forward x_mod", err_m, _bar(dtype, rm))
    leaves = [t.detach().clone().requires_grad_() for t in (x, br, gate, mul, add)]
    eager = torch.autograd.grad(N._native_residual_gate_modulate(*leaves, eps, dtype), leaves, (g_new, g))
    names = ("dx", "dbranch", "dgate", "dmul", "dadd")
    for needs in ((True,) * 5, K6_MAIN_NEEDS):
        got = N.residual_gate_modulate_backward(x, br, gate, mul, g_new, g, eps, needs)
        plain = N._native_residual_gate_modulate_backward(x, br, gate, mul, g_new, g, eps, needs)
        rel = 1e-4 if tag == "degenerate" else 1e-5  # as K5's
        bars = (lambda r: _bar(dtype, r, rel=rel), lambda r: _bar(dtype, r, rel=rel),
                lambda r: _bar(dtype, r.to(dtype)), lambda r: _bar(torch.float32, r),
                lambda r: _bar(torch.float32, r))
        _grads_check(f"{name} backward {needs} vs plain", got, plain, names, bars)
    got = N.residual_gate_modulate_backward(x, br, gate, mul, g_new, g, eps, (True,) * 5)
    eager_bars = (lambda r: _bar(dtype, r, 2.0, 1e-4), lambda r: _bar(dtype, r, 2.0, 1e-4),
                  lambda r: _bar(dtype, r.to(dtype), 2.0, 1e-4), lambda r: _bar(torch.float32, r, rel=1e-4),
                  lambda r: _bar(torch.float32, r, rel=1e-4))
    _grads_check(f"{name} backward vs autograd through the plain forward", got, eager, names, eager_bars)
    again = N.residual_gate_modulate_backward(x, br, gate, mul, g_new, g, eps, (True,) * 5)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"[kernels] {name} backward: two launches give the same bits: {same}")
    if not same:
        fail(f"{name}: the backward is not deterministic")
    if controls:
        gate_c = gate[:, None, :].to(dtype)
        r, xhat, raw = N._ln_stats((x + gate_c * br).float(), eps, False)
        wrong = (g_new.float() + N._ln_dx(g.float(), mul, r, xhat, torch.full_like(raw, -1.0))).to(dtype)
        _backward_controls(name, got, wrong, 3, lambda r: _bar(dtype, r))
        pn, pm = N.residual_gate_modulate_rows(x[:4], br[:4], gate[:4], mul[:4], add[:4], eps, dtype)
        same = torch.equal(pn, xn[:4]) and torch.equal(pm, xm[:4])
        log(f"[kernels] {name}: the first 4 batch rows alone give the bits of the whole batch's: {same}")
        if not same:
            fail(f"{name}: a batch slice changes the bits")
    if timed:
        _norm_timings(results, "residual_gate_modulate", f"K6 {tag}", shape, True, case, xm,
                      max(err_n, err_m), (x, br, gate, mul, add, xn, xm), N, eps)
    del case, x, br, gate, mul, add, g_new, g, xn, xm, rn, rm, leaves, eager, got, again
    torch.cuda.empty_cache()


def phase_kernels_norms(results: dict, gen) -> None:
    """K5 and K6, forward and backward, against their plain versions.

    Forward bars (both compute fp32 stats in another summation order and
    round once to the output type): one bf16 ulp of max|out|, 1e-5 relative
    in fp32; K6's x_new rounds where eager PyTorch rounds (bf16: 0). A batch
    slice gives the bits of the whole batch's rows. Backward bars, against the
    closed-form plain backward (same formula, the sums in another order, dx
    rounded once): one bf16 ulp of max|ref| for bf16, 1e-5 of it for fp32
    (dmul, dadd, dgate sums are fp32; dgate rounded once to x's dtype); the
    degenerate rows' fp32 dx 1e-4 (their r = rsqrt(eps) moves with the sum
    order by up to 1.5e-5 of itself, and they hold max|dx|). Against
    autograd through the plain forward (the eager path: another formula; for
    K6 it rounds the LN part of the x_new cotangent and their sum to bf16,
    dbranch from that rounded sum, and dgate's products before their sum,
    where the kernel rounds each once): 2 bf16 ulp of max|ref| (1 seen on
    the card, H100 80GB HBM3), 1e-4 of it in fp32 (2.4e-5 seen, on the
    degenerate rows). Negative controls:
    a backward without the x_hat * mean(g_hat * x_hat) term, one with dmul
    zeroed; two launches give the same bits."""
    import torch

    from flow_factory_tpu_torch.ops import norms as N

    eps = 1e-6
    for shape in K5_SHAPES:
        _k5_shape_checks(results, gen, shape, shape.tag == "image")

    for shape in K6_SHAPES:
        _k6_shape_checks(results, gen, shape, shape.tag == "image")

    tiny = _norm_inputs(gen, 1, 4, 1536, torch.bfloat16, torch.bfloat16, False, True, False)
    fwd5, bwd5 = _norm_calls(N, tiny, eps, torch.bfloat16, False, False, False, K5_MAIN_NEEDS)
    fwd6, bwd6 = _norm_calls(N, tiny, eps, torch.bfloat16, False, False, True, K6_MAIN_NEEDS)
    log(f"[kernels] K5/K6 host cost a call (B1 S4 D1536 bf16, the wrapper and its launches; the backward of a "
        f"per-sample modulation with dmul/dadd asked for adds the chunk sum's launch): K5 {_host_us(fwd5):.1f} us, "
        f"K5 backward {_host_us(bwd5):.1f} us, K6 {_host_us(fwd6):.1f} us, K6 backward {_host_us(bwd6):.1f} us")


def _norm_timings(results: dict, kernel: str, tag: str, shape: NormShape, k6: bool, case: dict, out, err: float,
                  fwd_tensors, N, eps: float) -> None:
    """CUDA-event times, bounds, plain and library times of a K5/K6 forward
    and backward at a main-path shape, their table entries, and their
    device-time jobs for the end of the run."""
    import torch
    import torch.nn.functional as F

    c = case
    x, mul, g = c["x"], c["mul"], c["g"]
    out_dtype, fold, rms = out.dtype, shape.fold, shape.rms
    needs = K6_MAIN_NEEDS if k6 else K5_MAIN_NEEDS
    fwd, bwd = _norm_calls(N, case, eps, out_dtype, fold, rms, k6, needs)
    ms, bwd_ms = time_ms(fwd), time_ms(bwd)
    grads = bwd()
    torch.cuda.synchronize()
    if k6:
        plain_fwd = lambda: N._native_residual_gate_modulate(x, c["branch"], c["gate"], mul, c["add"], eps, out_dtype)
        plain_bwd = lambda: N._native_residual_gate_modulate_backward(x, c["branch"], c["gate"], mul, c["g_new"],
                                                                      g, eps, needs)
        leaves = [t.detach().clone().requires_grad_(n) for t, n in zip((x, c["branch"], c["gate"], mul, c["add"]),
                                                                       needs)]
        outs = N._native_residual_gate_modulate(*leaves, eps, out_dtype)
        cots = (c["g_new"], g)
        bwd_bytes = nbytes(x, c["branch"], c["gate"], mul, c["g_new"], g, *(t for t in grads if t is not None))
    else:
        plain_fwd = lambda: N._native_ln_mul_add(x, mul, c["add"], eps, out_dtype, fold, rms)
        plain_bwd = lambda: N._native_ln_mul_add_backward(x, mul, g, eps, rms, needs)
        leaves = [t.detach().clone().requires_grad_(n) for t, n in zip((x, mul, c["add"]), needs)]
        outs = N._native_ln_mul_add(*leaves, eps, out_dtype, fold, rms)
        cots = g
        bwd_bytes = nbytes(x, mul, g, *(t for t in grads if t is not None))
    wanted = [t for t in leaves if t.requires_grad]
    plain_ms, plain_bwd_ms = time_ms(plain_fwd, iters=3), time_ms(plain_bwd, iters=3)
    eager_ms = time_ms(lambda: torch.autograd.grad(outs, wanted, cots, retain_graph=True), iters=3)
    lib_ms = lib_bwd_ms = None
    if fold:  # an affine LayerNorm with a (D,) weight: one PyTorch call computes it
        D = x.shape[-1]
        w, b = (torch.randn(D, device="cuda", dtype=x.dtype) for _ in range(2))
        xl, wl, bl = (t.detach().clone().requires_grad_() for t in (x, w, b))
        lib_ms = time_ms(lambda: F.layer_norm(x, (D,), w, b, eps))
        lib_bwd_ms = time_ms(lambda: torch.autograd.grad(F.layer_norm(xl, (D,), wl, bl, eps), (xl, wl, bl), g))
    elif rms:  # a yardstick, not the same function: F.rms_norm alone, without the modulation
        D = x.shape[-1]
        xl = x.detach().clone().requires_grad_()
        lib_ms = time_ms(lambda: F.rms_norm(x, (D,), None, eps))
        lib_bwd_ms = time_ms(lambda: torch.autograd.grad(F.rms_norm(xl, (D,), None, eps), (xl,), g.to(x.dtype)))
    # the modulated LayerNorm has no one-call equivalent: F.layer_norm alone, logged as a yardstick only
    yard_ms = None if fold or rms else time_ms(lambda: F.layer_norm(x, (x.shape[-1],), None, None, eps))
    # fp32 operations an element (two sums, centring, scaling, modulation;
    # the backward's two more sums and its dx terms; K6 its residual and dbranch)
    flops = x.numel() * (12 if k6 else 10), x.numel() * (18 if k6 else 14)
    fwd_bound, fwd_by = _bytes_or_ops(nbytes(*fwd_tensors), flops[0])
    bwd_bound, bwd_by = _bytes_or_ops(bwd_bytes, flops[1])
    source, line = "flow_factory_tpu_torch/ops/norms.py", ("300", "358") if k6 else ("93", "158")
    _record(results, tag.split()[1], dict(
        name=kernel, route="triton", source=source, replaces=f"flow_factory_tpu/ops/norms.py:{line[0]}",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=fwd_bound, bound_by=fwd_by, library_ms=lib_ms))
    bwd_err = max((a.float() - r.float()).abs().max().item() for a, r in zip(grads, plain_bwd()) if a is not None)
    _record(results, tag.split()[1], dict(
        name=f"{kernel}_backward", route="triton", source=source,
        replaces=f"flow_factory_tpu/ops/norms.py:{line[1]}", max_abs_err=bwd_err, ms=bwd_ms,
        plain_ms=plain_bwd_ms, bound_ms=bwd_bound, bound_by=bwd_by, library_ms=lib_bwd_ms))
    lib = lambda v: "none" if v is None else f"{v:.4f} ms"
    yard = "" if yard_ms is None else f" (F.layer_norm alone, a yardstick without the modulation: {yard_ms:.4f} ms)"
    log(f"[kernels] {tag} forward: kernel {ms:.4f} ms (events) | plain {plain_ms:.3f} ms | library "
        f"{lib(lib_ms)}{yard} | bound {fwd_bound:.4f} ms ({nbytes(*fwd_tensors) / ms / 1e6:.0f} GB/s)")
    log(f"[kernels] {tag} backward {needs}: kernel {bwd_ms:.4f} ms (events) | plain {plain_bwd_ms:.3f} ms | "
        f"autograd through the plain forward (the parent's backward) {eager_ms:.3f} ms | library "
        f"{lib(lib_bwd_ms)} | bound {bwd_bound:.4f} ms ({bwd_bytes / bwd_ms / 1e6:.0f} GB/s)")
    make = functools.partial(_norm_case_calls, N, 7, shape, k6, needs)
    DEVICE_TIME_JOBS.append(functools.partial(_norm_device_job, f"{tag} forward", make, 0, ms, fwd_bound, plain_ms,
                                              lib_ms))
    DEVICE_TIME_JOBS.append(functools.partial(_norm_device_job, f"{tag} backward", make, 1, bwd_ms, bwd_bound,
                                              plain_bwd_ms, lib_bwd_ms))


def _k2_check(tag: str, got, ref, dtype) -> None:
    """K2 tolerances. fp32 differs from the plain version by summation order
    only: 1e-5 of max|ref|. bf16: both versions round q*scale*log2(e), ds and
    p to bf16 before their products and accumulate in fp32, so an output
    moves only where a ds or p value near a rounding boundary rounds the
    other way after another summation order, and by the final rounding:
    the card tests saw at most half a bf16 ulp of max|ref|; the bar is 2
    ulp of max|ref| per output."""
    import torch

    errs, tols = [], []
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        mag = r.float().abs().max().item()
        tol = 1e-5 * max(mag, 1.0) if dtype == torch.float32 else 2 * bf16_ulp(mag)
        errs.append((g.float() - r.float()).abs().max().item())
        tols.append(tol)
        _check(f"K2 {tag} {name} {tuple(g.shape)} {dtype}", errs[-1], tol)
    return errs, tols


def _k2_negative_control(name: str, got, wrong, tols) -> None:
    """The K2 check must reject a plain version that computes something
    else: some output (``None`` where it is not comparable) misses its bar."""
    errs = [None if w is None else (g.float() - w.float()).abs().max().item() for g, w in zip(got, wrong)]
    caught = any(e is not None and e > t for e, t in zip(errs, tols))
    shown = ", ".join(f"{n} {e:.3e} (tol {t:.3e})" for n, e, t in zip(("dq", "dk", "dv"), errs, tols)
                      if e is not None)
    log(f"[kernels] negative control, {name}: max|d| {shown} {'rejected as it must be' if caught else 'NOT REJECTED'}")
    if not caught:
        fail(f"the K2 check cannot tell the kernels from wrong ones: {name}")


def _k2_d64_shape_checks(results: dict, randn, tag: str, B: int, H: int, S: int, D: int, dtype, strided: bool,
                         timed: bool) -> None:
    """One K2 D=64 shape of ``phase_kernels_k2`` (the shapes of K1 whose
    backward it is): K2a/K2b against the plain version; for the joint shape
    the negative controls and two passes' bits; timings and table entries if
    ``timed``."""
    import torch

    from flow_factory_tpu_torch.ops import attention as A

    dtype = getattr(torch, dtype)
    if strided:
        q, k, v = (randn(B, S, H, D, dtype=dtype).transpose(1, 2) for _ in range(3))
    else:
        q, k, v = (randn(B, H, S, D, dtype=dtype) for _ in range(3))
    gq = (1.0 + 0.1 * randn(S, D, dtype=torch.float32)).contiguous()
    gk = (1.0 + 0.1 * randn(S, D, dtype=torch.float32)).contiguous()
    scale = D ** -0.5
    out, lse = A.qknorm_flash_attention(q, k, v, gq, gk, scale, 1e-6, return_lse=True)
    qn = A._rms_scale(q, gq, 1e-6).to(dtype)
    kn = A._rms_scale(k, gk, 1e-6).to(dtype)
    dout = randn(B, S, H, D, dtype=dtype).transpose(1, 2)
    got = A.flash_backward(qn, kn, v, out, lse, dout, scale)
    ref = A.flash_backward_plain(qn, kn, v, out, lse, dout, scale)
    torch.cuda.synchronize()
    layout = "strided" if strided else "contiguous"
    errs, tols = _k2_check(f"{tag} {layout}", got, ref, dtype)
    del ref
    d_, delta, lse2 = A._bwd_prologue(qn, out, lse, dout)
    if tag == "joint":
        zero = torch.zeros_like(delta)
        _k2_negative_control("K2 joint vs a plain version without Delta", got,
                             (A.flash_bwd_dq_plain(qn, kn, v, d_, lse2, zero, scale),
                              *A.flash_bwd_dkv_plain(qn, kn, v, d_, lse2, zero, scale)), tols)
        n = S // 64 * 64  # the last whole key tile of K2a's ring (64 keys)
        _k2_negative_control(f"K2 joint vs a plain version without the {S - n}-key ragged tail", got,
                             (A.flash_bwd_dq_plain(qn, kn[:, :, :n], v[:, :, :n], d_, lse2, delta, scale),
                              None, None), tols)
        again = A.flash_backward(qn, kn, v, out, lse, dout, scale)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"[kernels] K2 joint: two backward passes give the same bits: {same}")
        if not same:
            fail("K2 is not deterministic")
        del again
    if timed:
        _k2_time_and_record(results, tag, "", qn, kn, v, dout, d_, lse2, delta, scale, got, errs)
    del q, k, v, out, qn, kn, dout, got
    torch.cuda.empty_cache()


def phase_kernels_k2(results: dict, randn) -> None:
    """K2a (dq) and K2b (dk, dv) on the inputs K1's backward gives them: the
    normalised q and k, v, O and the natural-log lse from K1's forward of the
    same q/k/v (so p is the softmax the forward computed), and dO in the
    head-interleaved layout of K1's output. The joint case is the
    concatenated contiguous tensor, the self case the head-split strided
    views; the small cases have a ragged tail in fp32 and bf16; then the
    head-dim-128 shapes of the Wan blocks."""
    for shape in K1_SHAPES:
        _k2_d64_shape_checks(results, randn, *shape)

    _k2_host_cost(randn)
    phase_kernels_k2_wan(results, randn)


def _k2_host_cost(randn, calls: int = 200) -> None:
    """Host microseconds a K2a wrapper call takes to enqueue at a tiny shape
    (B1 H1 S64, so the card never holds the host back), at head dim 64 and
    128: both compute the TMA geometry of four views and encode four tensor
    maps on the host for every call (64 x 64 boxes, two a tile at 128); and
    the Python geometry alone (``_tma_args``)."""
    import torch

    from flow_factory_tpu_torch.ops import attention as A

    host_us, geometry_us = {}, {}
    for D in (64, 128):
        q, k, v, dout = (randn(1, 1, 64, D) for _ in range(4))
        lse2 = torch.zeros(1, 1, 64, device="cuda")
        delta = torch.zeros_like(lse2)
        host_us[D] = _host_us(lambda: A.flash_bwd_dq(q, k, v, dout, lse2, delta, D ** -0.5), calls)
        t0 = time.perf_counter()
        for _ in range(calls):
            A._tma_args(q, k, v, dout)
        geometry_us[D] = (time.perf_counter() - t0) / calls * 1e6
    log(f"[kernels] K2 host cost a call (K2a wrapper: TMA geometry + 4 tensor maps + launch): D64 {host_us[64]:.1f} us "
        f"(Python geometry {geometry_us[64]:.1f} us) | D128 {host_us[128]:.1f} us (Python geometry "
        f"{geometry_us[128]:.1f} us)")


def _k2_time_and_record(results: dict, tag: str, suffix: str, q, k, v, dout, d_, lse2, delta, scale, got,
                        errs) -> None:
    """CUDA-event times of K2a and K2b, their plain versions and SDPA's whole
    backward (dq, dk and dv in one call, the yardstick) on the same q/k/v,
    and each kernel's bound; recorded under ``flash_bwd_dq<suffix>`` and
    ``flash_bwd_dkv<suffix>``."""
    import torch
    import torch.nn.functional as F

    from flow_factory_tpu_torch.ops import attention as A

    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    ms_dq = time_ms(lambda: A.flash_bwd_dq(q, k, v, d_, lse2, delta, scale))
    ms_dkv = time_ms(lambda: A.flash_bwd_dkv(q, k, v, d_, lse2, delta, scale))
    plain_dq = time_ms(lambda: A.flash_bwd_dq_plain(q, k, v, d_, lse2, delta, scale), iters=3)
    plain_dkv = time_ms(lambda: A.flash_bwd_dkv_plain(q, k, v, d_, lse2, delta, scale), iters=3)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o_lib = F.scaled_dot_product_attention(*leaves, scale=scale)
    lib_ms = time_ms(lambda: torch.autograd.grad(o_lib, leaves, dout, retain_graph=True))
    log(f"[kernels] K2{suffix} {tag}: K2a + K2b {ms_dq + ms_dkv:.3f} ms = {(ms_dq + ms_dkv) / lib_ms:.2f}x "
        f"SDPA's whole backward ({lib_ms:.3f} ms)")
    inputs = nbytes(q, k, v, d_, lse2, delta)
    for name, fn_ms, plain_ms, flops, outs, err, replaces in (
            ("flash_bwd_dq", ms_dq, plain_dq, _k2_flops(B, H, Sq, Sk, D)[0], (got[0],), errs[0], ":601"),
            ("flash_bwd_dkv", ms_dkv, plain_dkv, _k2_flops(B, H, Sq, Sk, D)[1], got[1:], max(errs[1:]), ":653")):
        byts = inputs + nbytes(*outs)
        bound = max(flops / PEAK_BF16_FLOPS, byts / PEAK_BYTES) * 1e3
        _record(results, tag, dict(
            name=name + suffix, route="cuda", source="flow_factory_tpu_torch/ops/csrc/flash_bwd.cu",
            replaces=f"flow_factory_tpu/ops/attention.py{replaces}",
            max_abs_err=err, ms=fn_ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by="operations" if flops / PEAK_BF16_FLOPS > byts / PEAK_BYTES else "bytes",
            library_ms=lib_ms))
        log(f"[kernels] {name}{suffix} {tag}: kernel {fn_ms:.3f} ms | plain {plain_ms:.3f} ms | sdpa backward "
            f"{lib_ms:.3f} ms ({fn_ms / lib_ms:.2f}x) | bound {bound:.4f} ms ({fn_ms / bound:.2f}x) | "
            f"{flops / fn_ms / 1e9:.1f} TFLOP/s")
    del leaves, o_lib


#: K2 at head dim 128: (tag, B, H, Sq, Sk, timed). wan-self and wan-cross
#: are the Wan2.1-1.3B blocks; flux-1024px the FLUX.1 joint attention at
#: 1024 px (4096 image + 512 text tokens, 24 heads of 128), the long-sequence
#: geometry of the head-dim-128 families; ragged-d128 a small ragged shape.
K2_D128_SHAPES = (("wan-self", 16, 12, 512, 512, True), ("wan-cross", 16, 12, 512, 512, True),
                  ("flux-1024px", 1, 24, 4608, 4608, True), ("ragged-d128", 2, 3, 300, 77, False))


def _k2_d128_inputs(tag: str, B: int, H: int, Sq: int, Sk: int, randn):
    """q, k, v and dO of a K2 D=128 shape in the layouts its caller hands
    over, with O and lse from K3's forward of them: wan-self q/k contiguous
    as ``apply_rope`` returns them, v a head-split view of its projection;
    wan-cross k/v head-split views of the context projections; flux-1024px,
    flux-512px and the kontext shapes q/k/v contiguous (the joint sequence,
    concatenated, q and k as RoPE returns them); the ltx2 and wan22 shapes
    q/k contiguous (the across-heads qk-norm and RoPE return them so), v a
    head-split view (wan-i2v's image cross-attention too: its k through the
    k-only norm); ragged-d128 every
    operand a view; dO always head-interleaved, as the head merge's backward
    hands it over."""
    from flow_factory_tpu_torch.ops import attention as A

    D = 128
    view = lambda S: randn(B, S, H, D).transpose(1, 2)  # head-split view of a (B, S, H*D) projection
    q = view(Sq) if tag == "ragged-d128" else randn(B, H, Sq, D)
    k = randn(B, H, Sk, D) if tag.startswith(("wan-self", "flux", "kontext", "ltx2", "wan22", "wan-i2v")) else view(Sk)
    v = randn(B, H, Sk, D) if tag.startswith(("flux", "kontext")) else view(Sk)
    dout = view(Sq)
    out, lse = A.flash_attention(q, k, v, D ** -0.5, return_lse=True)
    return q, k, v, dout, out, lse


def _k2_flops(B: int, H: int, Sq: int, Sk: int, D: int):
    """K2a's and K2b's matmul FLOP: S, dP and dQ; S, dP, dK and dV."""
    return 6 * B * H * Sq * Sk * D, 8 * B * H * Sq * Sk * D


def _k2_device_line(tag: str, q, k, v, dout, out, lse, events=None) -> None:
    """The profiler's device time of K2a, K2b, the prologue (``_bwd_prologue``:
    Delta and the base-2 lse) and SDPA's whole backward (dq, dk and dv in one
    autograd call) on the same inputs, with each kernel's TFLOP/s and ratio to
    its bound, and the pair plus prologue against SDPA; ``events`` adds the
    CUDA-event ms of K2a, K2b and SDPA taken beside them."""
    import torch
    import torch.nn.functional as F

    from flow_factory_tpu_torch.ops import attention as A

    B, H, Sq, D = q.shape
    Sk, scale = k.shape[2], D ** -0.5
    d_, delta, lse2 = A._bwd_prologue(q, out, lse, dout)
    dev = {"dq": _device_ms(lambda: A.flash_bwd_dq(q, k, v, d_, lse2, delta, scale)),
           "dkv": _device_ms(lambda: A.flash_bwd_dkv(q, k, v, d_, lse2, delta, scale)),
           "prologue": _device_ms(lambda: A._bwd_prologue(q, out, lse, dout))}
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o_lib = F.scaled_dot_product_attention(*leaves, scale=scale)
    dev["sdpa"] = _device_ms(lambda: torch.autograd.grad(o_lib, leaves, dout, retain_graph=True))
    flops = dict(zip(("dq", "dkv"), _k2_flops(B, H, Sq, Sk, D)))
    parts = []
    for key, name in (("dq", "K2a"), ("dkv", "K2b")):
        bound = flops[key] / PEAK_BF16_FLOPS * 1e3
        ev = f", events {events[key]:.4f} ms" if events else ""
        parts.append(f"{name} {dev[key]:.4f} ms ({flops[key] / dev[key] / 1e9:.1f} TFLOP/s, "
                     f"{dev[key] / bound:.2f}x its bound {bound:.4f}{ev})")
    whole = dev["dq"] + dev["dkv"] + dev["prologue"]
    ev = f"; by events K2a + K2b {events['dq'] + events['dkv']:.4f} ms, SDPA {events['sdpa']:.4f} ms" if events else ""
    log(f"[kernels] K2_d128 {tag} {(B, H, Sq, Sk, D)} device (profiler): {' | '.join(parts)} | _bwd_prologue "
        f"{dev['prologue']:.4f} ms | K2a + K2b + prologue {whole:.4f} ms = {whole / dev['sdpa']:.2f}x SDPA's whole "
        f"backward {dev['sdpa']:.4f} ms{ev}")
    del leaves, o_lib


def _k2_d128_device_job(tag: str, B: int, H: int, Sq: int, Sk: int, randn) -> None:
    import torch

    _k2_device_line(tag, *_k2_d128_inputs(tag, B, H, Sq, Sk, randn))
    torch.cuda.empty_cache()


def _k2_d128_shape_checks(results: dict, tag: str, B: int, H: int, Sq: int, Sk: int, timed: bool, randn) -> None:
    """One K2 D=128 shape of ``phase_kernels_k2_wan`` (and of
    ``phase_flux_kernels``): K2a/K2b against the plain version, the negative
    controls, two passes' bits; timings, table entries and the device-time
    job if ``timed``."""
    import torch

    from flow_factory_tpu_torch.ops import attention as A

    scale = 128 ** -0.5
    q, k, v, dout, out, lse = _k2_d128_inputs(tag, B, H, Sq, Sk, randn)
    got = A.flash_backward(q, k, v, out, lse, dout, scale)
    ref = A.flash_backward_plain(q, k, v, out, lse, dout, scale)
    torch.cuda.synchronize()
    errs, tols = _k2_check(f"{tag} D128", got, ref, torch.bfloat16)
    del ref
    d_, delta, lse2 = A._bwd_prologue(q, out, lse, dout)
    if tag in ("wan-self", "flux-512px", "kontext-2560", "qwen-1536", "wan-i2v-image") or (
            tag.startswith("wan22") and tag.endswith("-self")):
        zero = torch.zeros_like(delta)
        _k2_negative_control(f"K2 D128 {tag} vs a plain version without Delta", got,
                             (A.flash_bwd_dq_plain(q, k, v, d_, lse2, zero, scale),
                              *A.flash_bwd_dkv_plain(q, k, v, d_, lse2, zero, scale)), tols)
    if tag in ("ragged-d128", "kontext-ragged", "qwen-edit-3151", "wan-i2v-image") or (
            tag.startswith("ltx2") and Sk % 64):
        # the kernels' last whole key tile; under one tile (LTX-2's 9 audio
        # keys) a plain version without the last key
        n = Sk // 64 * 64 if Sk > 64 else Sk - 1
        _k2_negative_control(f"K2 D128 {tag} vs a plain version without the {Sk - n}-key ragged tail", got,
                             (A.flash_bwd_dq_plain(q, k[:, :, :n], v[:, :, :n], d_, lse2, delta, scale),
                              None, None), tols)
    again = A.flash_backward(q, k, v, out, lse, dout, scale)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"[kernels] K2 D128 {tag}: two backward passes give the same bits: {same}")
    if not same:
        fail("K2 at head dim 128 is not deterministic")
    if timed:
        _k2_time_and_record(results, tag, "_d128", q, k, v, dout, d_, lse2, delta, scale, got, errs)
        DEVICE_TIME_JOBS.append(functools.partial(_k2_d128_device_job, tag, B, H, Sq, Sk, randn))
    del q, k, v, out, dout, got, again
    torch.cuda.empty_cache()


def phase_kernels_k2_wan(results: dict, randn) -> None:
    """K2a/K2b at head dim 128 on the inputs K3's backward gives them
    (``K2_D128_SHAPES``, ``_k2_d128_inputs``). Bars are ``_k2_check``'s (2
    bf16 ulp of max|ref|). Negative controls that must miss them: a plain
    version without Delta (wan-self), and one without the 13-key ragged tail
    (ragged-d128: Sk 77 = 64 + 13). The timed shapes' device times are taken
    after the end-to-end phases."""
    for tag, B, H, Sq, Sk, timed in K2_D128_SHAPES:
        _k2_d128_shape_checks(results, tag, B, H, Sq, Sk, timed, randn)


def k2_d128_only(root: str) -> int:
    """``python3 chip_smoke.py --k2-d128 DIR``: K2a/K2b at head dim 128 of the
    port in the checkout DIR alone (this one, or a ``git archive`` of another
    commit, so that two commits' kernels are timed by one method in one call
    on one card): the ptxas figures of its ``flash_bwd.cu``, each timed
    shape of ``K2_D128_SHAPES`` checked against the plain version, then
    CUDA-event and profiler device times of K2a, K2b, the prologue and
    SDPA's whole backward. Prints no result line."""
    import torch

    sys.path.insert(0, os.path.abspath(root))
    import flow_factory_tpu_torch
    from flow_factory_tpu_torch.ops import attention as A
    from flow_factory_tpu_torch.ops import cuda_build

    where = os.path.dirname(os.path.dirname(os.path.abspath(flow_factory_tpu_torch.__file__)))
    if where != os.path.abspath(root):
        fail(f"--k2-d128 {root}: imported the port from {where}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    log(f"[k2-d128] port at {root} | card {smi.stdout.strip()} | {gpu_state()}")
    for name in ("flash_bwd", "flash_fwd"):
        cuda_build.build(name)
    _log_ptxas_figures(cuda_build, ("flash_bwd",))
    gen = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *shape, dtype=torch.bfloat16: torch.randn(
        shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)
    for tag, B, H, Sq, Sk, timed in K2_D128_SHAPES:
        if not timed:
            continue
        q, k, v, dout, out, lse = _k2_d128_inputs(tag, B, H, Sq, Sk, randn)
        scale = 128 ** -0.5
        got = A.flash_backward(q, k, v, out, lse, dout, scale)
        _k2_check(f"{tag} D128", got, A.flash_backward_plain(q, k, v, out, lse, dout, scale), torch.bfloat16)
        d_, delta, lse2 = A._bwd_prologue(q, out, lse, dout)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o_lib = torch.nn.functional.scaled_dot_product_attention(*leaves, scale=scale)
        events = {"dq": time_ms(lambda: A.flash_bwd_dq(q, k, v, d_, lse2, delta, scale)),
                  "dkv": time_ms(lambda: A.flash_bwd_dkv(q, k, v, d_, lse2, delta, scale)),
                  "sdpa": time_ms(lambda: torch.autograd.grad(o_lib, leaves, dout, retain_graph=True))}
        del leaves, o_lib, got
        _k2_device_line(tag, q, k, v, dout, out, lse, events)
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
    log(f"[k2-d128] card after: {gpu_state()}")
    return 0


def _graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device milliseconds a call of ``fn``: ``calls`` calls captured in one
    CUDA graph, replayed and timed by CUDA events (no host time between the
    launches), the median of ``reps`` replays."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def _triton_figures(N) -> str:
    """Registers and spills of each compiled Triton kernel of ``N``, where
    this Triton version's kernel cache shows them."""
    figures = []
    for name, kernel in sorted(N._triton_kernels().items()):
        caches = list(getattr(kernel, "cache", {}).values())
        caches += [entry[0] if isinstance(entry, tuple) else entry
                   for entry in getattr(kernel, "device_caches", {}).values()]
        for per_device in caches:
            for compiled in per_device.values():
                regs, spills = getattr(compiled, "n_regs", None), getattr(compiled, "n_spills", None)
                warps = getattr(getattr(compiled, "metadata", None), "num_warps", "?")
                figures.append(f"{name} ({warps} warps): {regs} registers, {spills} spills")
    return "; ".join(figures) or "not read"


def norms_only(root: str, sweep: bool) -> int:
    """``python3 chip_smoke.py --norms DIR [--sweep]``: K5 and K6 of the port
    in the checkout DIR alone, through the public wrappers and autograd (so a
    commit without the backward kernels times its own backward by the same
    method), after ``phase_kernels_norms`` and its device times where the
    port has the backward kernels: at the SD3.5-M image and context shapes and the Wan2.1-1.3B
    shape (K5, and its fold path), the forward and the backward of the
    main path's gradients (x for K5, x and branch for K6), each by the
    profiler's device time and by CUDA-event time of back-to-back calls (the
    forwards also by CUDA-graph replay). ``--sweep`` also times the kernels of this port over
    rows a program (the target program count) and warps, by graph replay.
    Prints no result line."""
    import torch

    sys.path.insert(0, os.path.abspath(root))
    import flow_factory_tpu_torch
    from flow_factory_tpu_torch.ops import norms as N

    where = os.path.dirname(os.path.dirname(os.path.abspath(flow_factory_tpu_torch.__file__)))
    if where != os.path.abspath(root):
        fail(f"--norms {root}: imported the port from {where}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    import triton

    log(f"[norms] port at {root} | card {smi.stdout.strip()} | torch {torch.__version__} triton "
        f"{triton.__version__} | {gpu_state()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    eps = 1e-6
    if hasattr(N, "ln_mul_add_backward"):  # a port with the backward kernels: their checks and device times
        phase_kernels_norms({}, gen)
        phase_device_times()
    for tag, B, S, D, k6, fold in (("K5 image", 16, 1024, 1536, False, False),
                                   ("K5 context", 16, 333, 1536, False, False),
                                   ("K5 wan", 16, 512, 1536, False, False),
                                   ("K5 wan-norm2 fold", 16, 512, 1536, False, True),
                                   ("K6 image", 16, 1024, 1536, True, False),
                                   ("K6 context", 16, 333, 1536, True, False)):
        c = _norm_inputs(gen, B, S, D, torch.bfloat16, torch.bfloat16, False, k6, False)
        if k6:
            fwd = lambda: N.residual_gate_modulate_rows(c["x"], c["branch"], c["gate"], c["mul"], c["add"], eps,
                                                        torch.bfloat16)
            leaves = [c["x"].detach().requires_grad_(), c["branch"].detach().requires_grad_()]
            outs = N.residual_gate_modulate_rows(*leaves, c["gate"], c["mul"], c["add"], eps, torch.bfloat16)
            cots = (c["g_new"], c["g"])
        else:
            fwd = lambda: N.ln_mul_add(c["x"], c["mul"], c["add"], eps, torch.bfloat16, fold=fold)
            leaves = [c["x"].detach().requires_grad_()]
            outs = N.ln_mul_add(leaves[0], c["mul"], c["add"], eps, torch.bfloat16, fold=fold)
            cots = c["g"]
        bwd = lambda: torch.autograd.grad(outs, leaves, cots, retain_graph=True)
        line = []
        for what, fn in (("forward", fwd), ("backward", bwd)):
            dev, ev = _device_ms(fn), time_ms(fn)
            graph = f", graph {_graph_ms(fn):.4f}" if what == "forward" else ""
            line.append(f"{what} device {dev:.4f} ms, events {ev:.4f}{graph}")
        log(f"[norms] {tag} ({B}, {S}, {D}) bf16: {' | '.join(line)}")
        del c, leaves, outs, cots
        torch.cuda.empty_cache()
    if hasattr(N, "ln_mul_add_backward"):
        log(f"[norms] compiled: {_triton_figures(N)}")
    if sweep:
        config = dict(N._CONFIG)
        for lanes in (256, 512):
            for programs in (132 * 8, 132 * 16, 132 * 32, 132 * 64):
                N._CONFIG.update({k: (lanes, programs) for k in config})
                row = []
                for tag, B, S, k6 in (("K5 image", 16, 1024, False), ("K5 context", 16, 333, False),
                                      ("K6 image", 16, 1024, True), ("K6 context", 16, 333, True)):
                    c = _norm_inputs(gen, B, S, 1536, torch.bfloat16, torch.bfloat16, False, k6, False)
                    fwd, bwd = _norm_calls(N, c, eps, torch.bfloat16, False, False, k6,
                                           K6_MAIN_NEEDS if k6 else K5_MAIN_NEEDS)
                    row.append(f"{tag} fwd {_graph_ms(fwd):.4f} bwd {_graph_ms(bwd):.4f}")
                    del c
                _, warps, image_rows, _ = N._launch_config("rgm", 16, 1024, 1536)
                log(f"[norms] sweep {warps} warps a 1536-wide row, {programs} programs "
                    f"({image_rows} / {N._launch_config('rgm', 16, 333, 1536)[2]} rows): {' | '.join(row)} ms")
        N._CONFIG.update(config)
    log(f"[norms] card after: {gpu_state()}")
    return 0


def _k3_shape_checks(results: dict, tag: str, q, k, v, layout: str, device_call) -> None:
    """One K3 shape of ``phase_kernels_k3`` (and of ``phase_flux_kernels``)
    on q/k/v in the layout its caller hands over: O and lse against the
    plain version, the negative controls, two launches' bits, a batch
    slice's bits, the CUDA-event, plain and SDPA times and the bound, the
    table entry, and the device-time job (``device_call`` makes fresh
    inputs of the shape as a call)."""
    import torch
    import torch.nn.functional as F

    from flow_factory_tpu_torch.ops import attention as A

    B, H, Sq, D = q.shape
    Sk, scale = k.shape[2], D ** -0.5
    out, lse = A.flash_attention(q, k, v, scale, return_lse=True)
    ref, ref_lse = A.flash_attention_plain(q, k, v, scale, return_lse=True)
    torch.cuda.synchronize()
    tol_o, tol_lse = 4 * bf16_ulp(ref.float().abs().max().item()), 1e-2
    err_o, err_lse = _k1_errors(out, lse, ref, ref_lse)
    _check(f"K3 {tag} O q{tuple(q.shape)} k{tuple(k.shape)} bf16 {layout}", err_o, tol_o)
    _check(f"K3 {tag} lse", err_lse, tol_lse)
    _negative_control(f"K3 {tag} vs a plain version without log2(e) in its logits", (out, lse),
                      A.flash_attention_plain(q, k, v, scale / A._LOG2E, return_lse=True), tol_o, tol_lse)
    pad = (-Sk) % 64
    if pad:
        padded = lambda t: F.pad(t, (0, 0, 0, pad))
        _negative_control(f"K3 {tag} vs a plain version that takes the {pad} padded keys for real",
                          (out, lse), A.flash_attention_plain(q, padded(k), padded(v), scale, return_lse=True),
                          tol_o, tol_lse)
    again = A.flash_attention(q, k, v, scale)
    same = torch.equal(out, again)
    log(f"[kernels] K3 {tag}: two launches give the same bits: {same}")
    if not same:
        fail("K3 is not deterministic")
    _fwd_batch_slice_same(f"K3 {tag}", lambda *t: A.flash_attention(*t, scale, return_lse=True), q, k, v)
    call = lambda: A.flash_attention(q, k, v, scale)
    ms, host_us = time_ms(call), _host_us(call, 50)
    plain_ms = time_ms(lambda: A.flash_attention_plain(q, k, v, scale), iters=3)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
    bound = _fwd_bound(B, H, Sq, Sk, D, nbytes(q, k, v, out, lse))
    _record(results, tag, dict(
        name="flash_fwd", route="cuda", source="flow_factory_tpu_torch/ops/csrc/flash_fwd.cu",
        replaces="flow_factory_tpu/ops/attention.py:101", max_abs_err=err_o, ms=ms, plain_ms=plain_ms,
        bound_ms=bound[0], bound_by=bound[1], library_ms=lib_ms))
    _fwd_time_line(f"K3 {tag}", ms, plain_ms, lib_ms, bound, host_us=host_us)
    DEVICE_TIME_JOBS.append(functools.partial(_fwd_device_job, f"K3 {tag}", device_call, ms, lib_ms, bound))
    del q, k, v, out, ref, again
    torch.cuda.empty_cache()


def phase_kernels_k3(results: dict, randn) -> None:
    """K3 (the plain flash forward) at the Wan2.1-1.3B shapes: self-attention
    over the 512 video tokens of 256 px x 5 frames (q/k/v the head-split
    views of the projections), cross-attention to the 512 UMT5 tokens (q
    contiguous, k/v head-split views of the context projections), the
    reference's eval geometry 480 px x 13 frames (4*30*30 = 3600 tokens, a
    ragged 16-key tail) and a small ragged head-dim-64 shape.

    Tolerances are K1's: 4 bf16 ulp of max|O| on O and 1e-2 on lse. Both
    versions round q*scale*log2(e) once and p to bf16 before PV; the
    kernel's online softmax rounds p against a running max over 64-key
    tiles, the plain version against the row max, which moves O by an ulp
    or two. Negative controls that must miss these bars: a plain version
    whose logits carry the scale but not log2(e) (every shape), and one that
    takes the zero-padded key tail for real keys (the ragged shapes)."""
    import torch

    from flow_factory_tpu_torch.ops import attention as A

    for tag, B, H, Sq, Sk, D in (
            ("wan-self", 16, 12, 512, 512, 128),
            ("wan-cross", 16, 12, 512, 512, 128),
            ("eval-480px-13f", 4, 12, 3600, 3600, 128),
            ("ragged-d64", 2, 3, 300, 77, 64)):
        heads = lambda S: randn(B, S, H, D).transpose(1, 2)  # view of a (B, S, H*D) projection
        q = randn(B, H, Sq, D) if tag == "wan-cross" else heads(Sq)
        k, v = heads(Sk), heads(Sk)
        layout = "q contiguous, k/v views" if tag == "wan-cross" else "q/k/v views"
        _k3_shape_checks(results, tag, q, k, v, layout,
                         functools.partial(_k3_call, B, H, Sq, Sk, D, tag == "wan-cross", D ** -0.5))
        del q, k, v
    tiny = [randn(1, 1, 64, 128) for _ in range(3)]
    log(f"[kernels] K3 host cost a call (B1 H1 S64 D128, the wrapper and its launch, 3 tensor maps): "
        f"{_host_us(lambda: A.flash_attention(*tiny)):.1f} us")

    # F6: the JAX rule for a dense mask on the card. auto runs native
    # attention (bit-equal to native_attention's) and launches no K3; flash
    # raises.
    q, k, v = (randn(2, 12, 77, 128) for _ in range(3))
    mask = torch.rand(77, 77, device="cuda") > 0.3
    before = A.flash_attention.launches
    masked = A.dot_product_attention(q, k, v, mask=mask)
    same = torch.equal(masked, A.native_attention(q, k, v, mask=mask))
    try:
        A.dot_product_attention(q, k, v, mask=mask, backend="flash")
        raised = False
    except NotImplementedError:
        raised = True
    added = A.flash_attention.launches - before
    log(f"[kernels] F6: masked auto on the card equals native_attention: {same}, K3 launches it added: {added}; "
        f"masked flash raises NotImplementedError: {raised}")
    if not (same and added == 0 and raised):
        fail("the masked dispatch does not follow the JAX rule")


#: the fp32 attention kernels' shapes (tag, B, H, Sq, Sk, D, timed): the
#: Wan2.1-1.3B self- and cross-attention of [wan-fp32] (q/k contiguous from
#: the across-heads qk-norm and RoPE, v a head-split view; cross: k/v views of
#: the context projections), SD3.5-M's dual self-attention at head dim 64 (q/k
#: contiguous from the RMS scale, as ``hybrid`` and ``ring`` compose it with
#: K3 in fp32), the JAX tiny presets' head dim 16 at a [parity] width, and
#: ragged Sq != Sk shapes at each head dim (keys in a partial last tile, q
#: rows in a partial last tile)
F32_SHAPES = (("wan-self-f32", 16, 12, 512, 512, 128, True), ("wan-cross-f32", 16, 12, 512, 512, 128, True),
              ("sd35-self-f32", 16, 24, 1024, 1024, 64, True),
              ("tiny-d16-f32", 2, 4, 256, 256, 16, True), ("ragged-d16-f32", 2, 3, 200, 77, 16, False),
              ("ragged-d64-f32", 2, 3, 300, 77, 64, False), ("ragged-d128-f32", 2, 3, 77, 300, 128, False))
#: K1 in fp32: (tag, B, H, S, D, timed): head dim 16 at the tiny SD3.5's
#: [parity] shapes' width and at Wan's width and head dim 128
K1_F32_SHAPES = (("tiny-d16-f32", 2, 4, 256, 16, True), ("d128-f32", 16, 12, 512, 128, True),
                 ("ragged-d16-f32", 2, 3, 77, 16, False))
#: bars of the fp32 kernels against their plain versions, relative to
#: max(max|ref|, 1): summation order alone separates them, the forwards' online
#: softmax against the plain version's one max (seen on an H100: K3 and K1
#: 2.1e-7 to 1.2e-6 on O, at most 9.5e-7 on lse; K2a and K2b 0, since both
#: they and cuBLAS's SIMT products add the keys in order by FMA)
F32_REL_BAR = 1e-5


def _f32_err(got, ref) -> tuple:
    """(max|got - ref|, the bar: F32_REL_BAR of max(max|ref|, 1))."""
    return (got - ref).abs().max().item(), F32_REL_BAR * max(ref.abs().max().item(), 1.0)


def _f32_heads(randn, tag: str, B: int, H: int, Sq: int, Sk: int, D: int):
    """fp32 q, k, v and dO of an F32_SHAPES shape in its layout; dO
    head-interleaved, as the head merge's backward gives it."""
    import torch

    view = lambda S: randn(B, S, H, D, dtype=torch.float32).transpose(1, 2)
    contiguous = lambda S: randn(B, H, S, D, dtype=torch.float32)
    q = contiguous(Sq)
    k = view(Sk) if tag.startswith(("wan-cross", "ragged")) else contiguous(Sk)
    return q, k, view(Sk), view(Sq)


def _f32_record(results: dict, name: str, tag: str, source: str, replaces: str, err: float, ms: float,
                plain_ms: float, lib_ms: float, byts: int, flops: int, what: str) -> None:
    bound, by = _bytes_or_ops(byts, flops)
    _record(results, tag, dict(name=name, route="cuda", source=source, replaces=replaces, max_abs_err=err, ms=ms,
                               plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=lib_ms))
    log(f"[kernels] {name} {tag}: kernel {ms:.4f} ms (events) | plain {plain_ms:.4f} ms | {what} {lib_ms:.4f} ms "
        f"({ms / lib_ms:.2f}x) | bound {bound:.4f} ms by {by} ({ms / bound:.2f}x; {flops / 1e9:.3g} GFLOP at "
        f"{PEAK_FP32_FLOPS / 1e12:.1f} TFLOP/s fp32, {byts / 1e6:.1f} MB at 3.35 TB/s) | "
        f"{flops / ms / 1e9:.1f} TFLOP/s")


def _f32_device_job(name: str, tag: str, make_call, ms: float) -> None:
    import torch

    dev_ms = _device_ms(make_call())
    log(f"[kernels] {name} {tag} device {dev_ms:.4f} ms (profiler) | kernel {ms:.4f} ms (events)")
    torch.cuda.empty_cache()


def _f32_call(kind: str, tag: str, B: int, H: int, Sq: int, Sk: int, D: int):
    """A call of an fp32 kernel on fresh inputs of a shape (the device-time
    jobs): K1 (q/k/v contiguous, Sq = Sk), K3, K2a or K2b."""
    import torch

    from flow_factory_tpu_torch.ops import attention as A

    randn = lambda *shape, dtype: torch.randn(shape, device="cuda", dtype=dtype)
    if kind == "K1":
        q, k, v = (randn(B, H, Sq, D, dtype=torch.float32) for _ in range(3))
        gq, gk = ((1.0 + 0.1 * randn(Sq, D, dtype=torch.float32)).contiguous() for _ in range(2))
        return functools.partial(A.qknorm_flash_attention, q, k, v, gq, gk, D ** -0.5, 1e-6)
    q, k, v, dout = _f32_heads(randn, tag, B, H, Sq, Sk, D)
    if kind == "K3":
        return functools.partial(A.flash_attention, q, k, v, D ** -0.5)
    out, lse = A.flash_attention(q, k, v, D ** -0.5, return_lse=True)
    d_, delta, lse2 = A._bwd_prologue(q, out, lse, dout)
    fn = A.flash_bwd_dq if kind == "K2a" else A.flash_bwd_dkv
    return functools.partial(fn, q, k, v, d_, lse2, delta, D ** -0.5)


def _f32_shape_checks(results: dict, randn, tag: str, B: int, H: int, Sq: int, Sk: int, D: int,
                      timed: bool) -> None:
    """One F32_SHAPES shape: K3 in fp32 (O and lse) and K2a/K2b on its O and
    lse against their plain versions within F32_REL_BAR of max|ref|; the
    negative controls (K3 without log2(e) in its logits, K2 without Delta,
    and without the ragged key tail where Sk is ragged); two launches' bits;
    for timed shapes the CUDA-event, plain and SDPA times (fp32, TF32 off),
    the bound, the table entries and the device-time jobs."""
    import torch
    import torch.nn.functional as F

    from flow_factory_tpu_torch.ops import attention as A

    q, k, v, dout = _f32_heads(randn, tag, B, H, Sq, Sk, D)
    scale = D ** -0.5
    out, lse = A.flash_attention(q, k, v, scale, return_lse=True)
    ref, ref_lse = A.flash_attention_plain(q, k, v, scale, return_lse=True)
    torch.cuda.synchronize()
    layout = f"q{tuple(q.shape)} k{tuple(k.shape)} fp32 " + ("k/v views" if tag.startswith(("wan-cross", "ragged"))
                                                          else "q/k contiguous, v a view")
    err_o, tol_o = _f32_err(out, ref)
    err_lse, tol_lse = _f32_err(lse, ref_lse)
    _check(f"K3 f32 {tag} O {layout}", err_o, tol_o)
    _check(f"K3 f32 {tag} lse", err_lse, tol_lse)
    _negative_control(f"K3 f32 {tag} vs a plain version without log2(e) in its logits", (out, lse),
                      A.flash_attention_plain(q, k, v, scale / A._LOG2E, return_lse=True), tol_o, tol_lse)
    n = Sk // 64 * 64
    if n and n != Sk:
        _negative_control(f"K3 f32 {tag} vs a plain version without the {Sk - n}-key ragged tail", (out, lse),
                          A.flash_attention_plain(q, k[:, :, :n], v[:, :, :n], scale, return_lse=True),
                          tol_o, tol_lse)
    again = A.flash_attention(q, k, v, scale)
    got = A.flash_backward(q, k, v, out, lse, dout, scale)
    want = A.flash_backward_plain(q, k, v, out, lse, dout, scale)
    errs, tols = zip(*(_f32_err(g, w) for g, w in zip(got, want)))
    for name, g, e, t in zip(("dq", "dk", "dv"), got, errs, tols):
        _check(f"K2 f32 {tag} {name} {tuple(g.shape)}", e, t)
    d_, delta, lse2 = A._bwd_prologue(q, out, lse, dout)
    zero = torch.zeros_like(delta)
    _k2_negative_control(f"K2 f32 {tag} vs a plain version without Delta", got,
                         (A.flash_bwd_dq_plain(q, k, v, d_, lse2, zero, scale),
                          *A.flash_bwd_dkv_plain(q, k, v, d_, lse2, zero, scale)), tols)
    if n and n != Sk:
        _k2_negative_control(f"K2 f32 {tag} vs a plain version without the {Sk - n}-key ragged tail", got,
                             (A.flash_bwd_dq_plain(q, k[:, :, :n], v[:, :, :n], d_, lse2, delta, scale),
                              None, None), tols)
    got2 = A.flash_backward(q, k, v, out, lse, dout, scale)
    same = torch.equal(out, again) and all(torch.equal(a, b) for a, b in zip(got, got2))
    log(f"[kernels] K3 and K2 f32 {tag}: two launches of each give the same bits: {same}")
    if not same:
        fail(f"the fp32 K3 or K2 is not deterministic at {tag}")
    if timed:
        src_fwd = "flow_factory_tpu_torch/ops/csrc/flash_fwd_f32.cuh"
        src_bwd = "flow_factory_tpu_torch/ops/csrc/flash_bwd.cu"
        fwd_flops = 4 * B * H * Sq * Sk * D
        ms = time_ms(lambda: A.flash_attention(q, k, v, scale))
        plain_ms = time_ms(lambda: A.flash_attention_plain(q, k, v, scale), iters=3)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
        _f32_record(results, "flash_fwd_f32", tag, src_fwd, "flow_factory_tpu/ops/attention.py:101", err_o, ms,
                    plain_ms, lib_ms, nbytes(q, k, v, out, lse), fwd_flops, "sdpa fp32")
        DEVICE_TIME_JOBS.append(functools.partial(_f32_device_job, "flash_fwd_f32", tag,
                                                  functools.partial(_f32_call, "K3", tag, B, H, Sq, Sk, D), ms))
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o_lib = F.scaled_dot_product_attention(*leaves, scale=scale)
        lib_bwd = time_ms(lambda: torch.autograd.grad(o_lib, leaves, dout, retain_graph=True))
        inputs = nbytes(q, k, v, d_, lse2, delta)
        flops_dq, flops_dkv = _k2_flops(B, H, Sq, Sk, D)
        for name, kind, fn, plain, flops, outs, err, replaces in (
                ("flash_bwd_dq_f32", "K2a", A.flash_bwd_dq, A.flash_bwd_dq_plain, flops_dq, got[:1], errs[0], ":601"),
                ("flash_bwd_dkv_f32", "K2b", A.flash_bwd_dkv, A.flash_bwd_dkv_plain, flops_dkv, got[1:],
                 max(errs[1:]), ":653")):
            ms = time_ms(lambda: fn(q, k, v, d_, lse2, delta, scale))
            plain_ms = time_ms(lambda: plain(q, k, v, d_, lse2, delta, scale), iters=3)
            _f32_record(results, name, tag, src_bwd, f"flow_factory_tpu/ops/attention.py{replaces}", err, ms,
                        plain_ms, lib_bwd, inputs + nbytes(*outs), flops, "sdpa fp32 whole backward")
            DEVICE_TIME_JOBS.append(functools.partial(_f32_device_job, name, tag,
                                                      functools.partial(_f32_call, kind, tag, B, H, Sq, Sk, D), ms))
        del leaves, o_lib
    del q, k, v, dout, out, ref, again, got, got2, want
    torch.cuda.empty_cache()


def _k1_f32_shape_checks(results: dict, randn, tag: str, B: int, H: int, S: int, D: int, timed: bool) -> None:
    """K1 in fp32 at one K1_F32_SHAPES shape against its plain version
    (``qknorm_attention_plain``) within F32_REL_BAR of max|ref|, the control
    without the gamma maps, two launches' bits; timed: events, plain, SDPA
    on the normalised q/k, the bound, the table entry and the device-time
    job."""
    import torch
    import torch.nn.functional as F

    from flow_factory_tpu_torch.ops import attention as A

    f32 = torch.float32
    q, k, v = (randn(B, H, S, D, dtype=f32) for _ in range(3))
    gq, gk = ((1.0 + 0.1 * randn(S, D, dtype=f32)).contiguous() for _ in range(2))
    scale = D ** -0.5
    out, lse = A.qknorm_flash_attention(q, k, v, gq, gk, scale, 1e-6, return_lse=True)
    ref, ref_lse = A.qknorm_attention_plain(q, k, v, gq, gk, scale, 1e-6, return_lse=True)
    torch.cuda.synchronize()
    err_o, tol_o = _f32_err(out, ref)
    err_lse, tol_lse = _f32_err(lse, ref_lse)
    _check(f"K1 f32 {tag} O {tuple(q.shape)}", err_o, tol_o)
    _check(f"K1 f32 {tag} lse", err_lse, tol_lse)
    ones = torch.ones_like(gq)
    _negative_control(f"K1 f32 {tag} vs a plain version without the gamma maps", (out, lse),
                      A.qknorm_attention_plain(q, k, v, ones, ones, scale, 1e-6, return_lse=True), tol_o, tol_lse)
    same = torch.equal(out, A.qknorm_flash_attention(q, k, v, gq, gk, scale, 1e-6))
    log(f"[kernels] K1 f32 {tag}: two launches give the same bits: {same}")
    if not same:
        fail(f"the fp32 K1 is not deterministic at {tag}")
    if timed:
        ms = time_ms(lambda: A.qknorm_flash_attention(q, k, v, gq, gk, scale, 1e-6))
        plain_ms = time_ms(lambda: A.qknorm_attention_plain(q, k, v, gq, gk, scale, 1e-6), iters=3)
        qn, kn = A._rms_scale(q, gq, 1e-6), A._rms_scale(k, gk, 1e-6)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qn, kn, v, scale=scale))
        _f32_record(results, "qknorm_flash_fwd_f32", tag, "flow_factory_tpu_torch/ops/csrc/flash_fwd_f32.cuh",
                    "flow_factory_tpu/ops/attention.py:368", err_o, ms, plain_ms, lib_ms,
                    nbytes(q, k, v, gq, gk, out, lse), 4 * B * H * S * S * D, "sdpa fp32 on the normalised q/k")
        DEVICE_TIME_JOBS.append(functools.partial(_f32_device_job, "qknorm_flash_fwd_f32", tag,
                                                  functools.partial(_f32_call, "K1", tag, B, H, S, S, D), ms))
    del q, k, v, out, ref
    torch.cuda.empty_cache()


def phase_kernels_f32(results: dict) -> None:
    """The fp32 kernels at the head dims of the JAX presets: K3, K2a/K2b
    (F32_SHAPES) and K1 (K1_F32_SHAPES) against their plain versions, then
    the pairs that have no kernel raising on the card: fp32 at head dim 32
    and fp16 at 128, for K3, K2a, K2b and K1."""
    import torch

    from flow_factory_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(24)
    randn = lambda *shape, dtype=torch.float32: torch.randn(shape, generator=gen, device=dev, dtype=torch.float32
                                                            ).to(dtype)
    for shape in F32_SHAPES:
        _f32_shape_checks(results, randn, *shape)
    for shape in K1_F32_SHAPES:
        _k1_f32_shape_checks(results, randn, *shape)
    refused = {}
    for dtype, D in ((torch.float32, 32), (torch.float16, 128)):
        q = randn(1, 2, 64, D, dtype=dtype)
        lse2 = torch.zeros(1, 2, 64, device=dev)
        g = torch.ones(64, D, device=dev)
        for name, call in (("K3", lambda: A.flash_attention(q, q, q)),
                           ("K2a", lambda: A.flash_bwd_dq(q, q, q, q, lse2, lse2, 0.125)),
                           ("K2b", lambda: A.flash_bwd_dkv(q, q, q, q, lse2, lse2, 0.125)),
                           ("K1", lambda: A.qknorm_flash_attention(q, q, q, g, g, 0.125, 1e-6))):
            try:
                call()
                refused[f"{name} {dtype} D{D}"] = "launched"
            except (TypeError, ValueError) as e:
                refused[f"{name} {dtype} D{D}"] = type(e).__name__
    log(f"[kernels] the pairs without a kernel on the card: {refused}")
    if any(v == "launched" for v in refused.values()):
        fail(f"a pair the admission table refuses launched: {refused}")


def _config(**overrides):
    from flow_factory_tpu_torch.hparams import Arguments

    return Arguments.from_dict(_config_dict(**overrides))


def _config_dict(**overrides) -> dict:
    # the SD3.5-M GRPO workload (tests/fixtures/sd35_grpo.yaml) cut to
    # 2 prompts x group 4 and random weights
    cfg = {
        "data": {"dataset_dir": "tests/fixtures/tiny_prompts"},
        "model": {"model_type": "sd3-5", "model_name_or_path": "", "variant": "medium",
                  "attn_backend": "auto", "master_dtype": "float32", "inference_dtype": "bfloat16"},
        "scheduler": {"dynamics_type": "Flow-SDE", "noise_level": 0.8, "num_sde_steps": 2,
                      "sde_steps": [1, 2, 3, 4, 5], "seed": 42},
        "train": {"trainer_type": "grpo", "advantage_aggregation": "sum", "global_std": True,
                  "resolution": 512, "num_inference_steps": 10, "guidance_scale": 4.5,
                  "per_device_batch_size": 8, "group_size": 4, "unique_sample_num_per_epoch": 2,
                  "latent_storage_dtype": "fp16", "seed": 42},
        "eval": {}, "log": {},
        "rewards": [{"name": "brightness", "reward_model": "MyReward", "batch_size": 8}],
    }
    for section, values in overrides.items():
        cfg[section] = {**cfg[section], **values}
    return cfg


def phase_slice() -> None:
    import numpy as np
    import torch

    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.advantage import AdvantageProcessor
    from flow_factory_tpu_torch.models import load_adapter
    from flow_factory_tpu_torch.rewards import RewardProcessor, load_reward_models

    cfg = _config()
    ta = cfg.training_args
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "tests/fixtures/tiny_prompts/train.txt")) as f:
        prompts = [line.strip() for line in f if line.strip()][:2]
    batch = [p for p in prompts for _ in range(ta.group_size)]
    secs = {}

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    adapter = load_adapter(cfg)  # cuda
    torch.cuda.synchronize()
    secs["load_adapter"] = time.perf_counter() - t0
    tcfg = adapter.component_configs["transformer"]
    log(f"[slice] SD3.5-M loaded: hidden {tcfg.hidden_dim}, depth {tcfg.depth}, heads {tcfg.num_heads}, "
        f"dual blocks {len(tcfg.dual_attention_layers)}, params "
        f"{sum(p.numel() for m in adapter.modules.values() for p in m.parameters()) / 1e9:.2f} B "
        f"in {secs['load_adapter']:.1f} s")

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    enc = adapter.encode_prompt(batch)
    neg = adapter.encode_prompt([""] * len(batch))
    torch.cuda.synchronize()
    secs["encode"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    samples = adapter.inference(
        prompt=batch, prompt_embeds=enc["prompt_embeds"], pooled_prompt_embeds=enc["pooled_prompt_embeds"],
        negative_prompt_embeds=neg["prompt_embeds"], negative_pooled_prompt_embeds=neg["pooled_prompt_embeds"],
        height=512, width=512, num_inference_steps=10, guidance_scale=4.5, compute_log_prob=True,
        trajectory_indices="all", seed=ta.seed, decode=True)
    torch.cuda.synchronize()
    secs["rollout+decode"] = time.perf_counter() - t0
    rollout_counts = ops.launch_counts()

    t0 = time.perf_counter()
    reward_models = load_reward_models(cfg.reward_args)
    RewardProcessor(reward_models, cfg.reward_args.reward_weights).score_and_attach(samples)
    metrics = AdvantageProcessor(
        group_size=ta.group_size, aggregation=ta.advantage_aggregation,
        std_mode="global" if ta.global_std else "per_group",
        reward_weights=cfg.reward_args.reward_weights).compute_advantages(samples)
    secs["reward+advantage"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    new_lp = adapter.replay_log_probs(samples)
    torch.cuda.synchronize()
    secs["replay"] = time.perf_counter() - t0
    counts = ops.launch_counts()

    old = np.stack([s.log_probs for s in samples], axis=1)  # (T, B)
    sde_steps = [int(i) for i in np.nonzero(samples[0].extra_kwargs["noise_levels"])[0]]
    ratios = {i: np.exp(lp.double().cpu().numpy() - old[i].astype(np.float64)) for i, lp in new_lp.items()}
    bad = {i: r.tolist() for i, r in ratios.items() if not np.all(r == 1.0)}
    images = np.stack([s.image for s in samples])
    rewards = np.asarray([s.extra_kwargs["reward"] for s in samples])
    advantages = np.asarray([s.extra_kwargs["advantage"] for s in samples])
    log(f"[slice] images {images.shape} range [{images.min():.3f}, {images.max():.3f}] | rewards "
        f"{np.round(rewards, 4).tolist()} | advantages {np.round(advantages, 3).tolist()}")
    log(f"[slice] replayed steps {sorted(new_lp)} (SDE steps {sde_steps}); ratio==1.0 exactly on "
        f"{len(ratios) - len(bad)}/{len(ratios)}; old lp at SDE steps "
        f"{np.round(old[sde_steps].mean(axis=1), 4).tolist()}")
    if len(images) != 8 or images.shape[1:] != (3, 512, 512):
        fail(f"unexpected image batch {images.shape}")
    for name, arr in (("images", images), ("log-probs", old), ("rewards", rewards), ("advantages", advantages)):
        if not np.all(np.isfinite(arr)):
            fail(f"non-finite {name}")
    if bad or not ratios:
        fail(f"replay ratio != 1.0 at steps {sorted(bad)}: {bad}")
    # the serving path runs the forward kernels; K2a/K2b belong to the training path
    if any(counts[name] <= 0 for name in ("qknorm_flash_fwd", "ln_mul_add", "residual_gate_modulate")):
        fail(f"a kernel of the serving path never launched: {counts}")
    phase_profile(adapter, samples, sde_steps[0])
    samples_per_s = len(samples) / secs["rollout+decode"]
    log(f"[slice] launches rollout {rollout_counts} | rollout+replay {counts}")
    log(f"[slice] phase seconds {json.dumps({k: round(v, 3) for k, v in secs.items()})} | "
        f"{samples_per_s:.3f} samples/s (rollout+decode) | peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | advantage/std {metrics['advantage/std']:.4f}")


#: [import]: the components written, and each one's
#: ``config.json`` in its upstream spelling, made from the adapter's configs
IMPORT_COMPONENTS = ("transformer", "text_encoder", "text_encoder_2", "vae")
#: predicted before the first chip run: seconds to write and to import the
#: ~6.8 GB directory, import GB/s, and peak GiB while B loads beside A
IMPORT_PREDICTED = {"write_s": (3.0, 15.0), "import_s": (1.5, 8.0), "GB/s": (1.0, 5.0), "peak_GiB": (30.0, 32.0)}


def _upstream_config_json(comp: str, cfg) -> dict:
    """A component's diffusers/transformers ``config.json`` at ``cfg``'s values."""
    if comp == "transformer":
        return {"_class_name": "SD3Transformer2DModel", "num_layers": cfg.depth, "num_attention_heads": cfg.num_heads,
                "attention_head_dim": cfg.hidden_dim // cfg.num_heads, "in_channels": cfg.in_channels,
                "out_channels": cfg.out_channels, "patch_size": cfg.patch_size, "joint_attention_dim": cfg.context_dim,
                "pooled_projection_dim": cfg.pooled_dim, "pos_embed_max_size": cfg.pos_embed_max_size,
                "dual_attention_layers": list(cfg.dual_attention_layers), "qk_norm": "rms_norm" if cfg.qk_norm else None}
    if comp == "vae":
        return {"_class_name": "AutoencoderKL", "in_channels": cfg.in_channels, "latent_channels": cfg.latent_channels,
                "block_out_channels": [cfg.base_channels * m for m in cfg.channel_mults],
                "layers_per_block": cfg.layers_per_block, "scaling_factor": cfg.scaling_factor,
                "shift_factor": cfg.shift_factor, "mid_block_add_attention": cfg.use_mid_attention}
    return {"model_type": "clip_text_model", "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_dim,
            "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
            "max_position_embeddings": cfg.max_positions, "projection_dim": cfg.projection_dim,
            "eos_token_id": cfg.eos_token_id, "hidden_act": cfg.hidden_act, "layer_norm_eps": cfg.layer_norm_eps}


def _write_checkpoint(adapter, root: str) -> int:
    """Write ``IMPORT_COMPONENTS`` of ``adapter`` as a diffusers-layout
    directory: each component's tensors under the upstream names its import
    map reads, and its config.json; returns the bytes of the safetensors."""
    from flow_factory_tpu_torch.utils.checkpoint import upstream_key
    from flow_factory_tpu_torch.utils.safetensors_io import save_file

    maps = adapter.pretrained_component_maps()
    nbytes = 0
    for comp in IMPORT_COMPONENTS:
        renames = maps[comp].renames
        d = os.path.join(root, maps[comp].subfolder)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(_upstream_config_json(comp, adapter.component_configs[comp]), f)
        tensors = {upstream_key(k, renames): v for k, v in adapter.modules[comp].state_dict().items()}
        if None in tensors:
            fail(f"[import] {comp} has tensors its import map reads from no upstream key")
        path = os.path.join(d, "model.safetensors")
        save_file(tensors, path)
        nbytes += os.path.getsize(path)
    return nbytes


def _sd35_grad_step_batch(adapter, samples, step: int) -> dict:
    """One stored transition of every sample as the GRPO trainer stages it."""
    import numpy as np
    import torch

    first, dev, B = samples[0], adapter.device, len(samples)
    lat = torch.from_numpy(np.stack([s.all_latents for s in samples])).to(dev)
    li, lni = first.latent_index_map[step], first.latent_index_map[step + 1]
    sigmas, levels = first.extra_kwargs["sigmas"], first.extra_kwargs["noise_levels"]
    full = lambda v: torch.full((B,), float(v), dtype=torch.float32, device=dev)
    embeds = {k: torch.from_numpy(np.stack([getattr(s, k) for s in samples])).to(dev) for k in adapter.embed_keys}
    return dict(latents=lat[:, li].contiguous(), next_latents=lat[:, lni].contiguous(),
                guidance_scale=float(first.extra_kwargs["guidance_scale"]), sigma_max=full(sigmas[1]),
                timestep=full(first.timesteps[step]), timestep_host=float(first.timesteps[step]),
                sigma=full(sigmas[step]), sigma_next=full(sigmas[step + 1]), noise_level=full(levels[step]), **embeds)


def phase_import(card: str) -> None:
    """SD3.5-M at full width and depth written to a diffusers-layout
    directory and imported back: adapter A (random weights, seed 42) writes
    the transformer, both CLIPs and the VAE with their config.json files (no
    T5-XXL: its subfolder is absent, and B keeps its own init there); B is
    built from the directory through ``load_adapter`` with ``strict_import``
    and init seed 7. Every imported tensor of B must equal A's bit for bit;
    fed A's prompt embeddings, B's 10-step CFG rollout (the seed of
    ``[slice]``) must give A's latents, log-probs and images bit for bit;
    B's replay ratio exactly 1.0; one grad step of B's LoRA finite, with
    one training forward's and backward's launches; then seconds to write
    and to import, GB/s, and peak memory, beside the card."""
    import tempfile

    import numpy as np
    import torch

    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.models import load_adapter

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "tests/fixtures/tiny_prompts/train.txt")) as f:
        prompts = [line.strip() for line in f if line.strip()][:2]
    batch = [p for p in prompts for _ in range(4)]
    roll = dict(height=512, width=512, num_inference_steps=10, guidance_scale=4.5, compute_log_prob=True,
                trajectory_indices="all", seed=42, decode=True)
    secs = {}
    t0 = time.perf_counter()
    a = load_adapter(_config())
    torch.cuda.synchronize()
    secs["load A (random init)"] = time.perf_counter() - t0
    enc = a.encode_prompt(batch)
    neg = a.encode_prompt([""] * len(batch))
    embeds = dict(prompt_embeds=enc["prompt_embeds"], pooled_prompt_embeds=enc["pooled_prompt_embeds"],
                  negative_prompt_embeds=neg["prompt_embeds"], negative_pooled_prompt_embeds=neg["pooled_prompt_embeds"])
    ops.reset_launch_counts()
    a_samples = a.inference(prompt=batch, **embeds, **roll)
    a_counts = ops.launch_counts()
    root = tempfile.mkdtemp(prefix="sd35_import_")
    try:
        t0 = time.perf_counter()
        nbytes = _write_checkpoint(a, root)
        secs["write"] = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        b = load_adapter(_config(model={"model_name_or_path": root, "strict_import": True}, train={"seed": 7}))
        torch.cuda.synchronize()
        secs["load B (init + import)"] = time.perf_counter() - t0
        peak_load = torch.cuda.max_memory_allocated() / 2**30
        imported = {comp: {k: v for k, v in b.modules[comp].state_dict().items()} for comp in IMPORT_COMPONENTS}
        unequal = [f"{comp}.{k}" for comp, sd in imported.items() for k, v in sd.items()
                   if not torch.equal(v, a.modules[comp].state_dict()[k])]
        differs_t5 = any(not torch.equal(v, a.modules["text_encoder_3"].state_dict()[k])
                         for k, v in b.modules["text_encoder_3"].state_dict().items())
        same_cfg = all(b.component_configs[c] == a.component_configs[c] for c in a.component_configs)
        n_tensors = sum(len(sd) for sd in imported.values())
        n_params = sum(v.numel() for sd in imported.values() for v in sd.values())
        log(f"[import] wrote {nbytes / 1e9:.3f} GB ({n_params / 1e9:.3f} B bf16 values in {n_tensors} tensors: "
            f"{', '.join(IMPORT_COMPONENTS)}) in {secs['write']:.2f} s; B from the directory: strict import, "
            f"init seed 7; {len(unequal)} of {n_tensors} imported tensors differ from A's; B's T5-XXL (no "
            f"text_encoder_3/ written) kept its own init: {differs_t5}; configs read back from config.json equal "
            f"A's: {same_cfg}")
        if unequal or not differs_t5 or not same_cfg:
            fail(f"[import] B is not A: {unequal[:5]}, T5 re-initialised {differs_t5}, configs equal {same_cfg}")
        del imported
        # the import alone, once more into B's built modules (the files in the page cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b.import_pretrained_weights()
        torch.cuda.synchronize()
        secs["import"] = time.perf_counter() - t0
        del a
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        b_samples = b.inference(prompt=batch, **embeds, **roll)
        torch.cuda.synchronize()
        secs["rollout+decode B"] = time.perf_counter() - t0
        b_counts = ops.launch_counts()
        same = {what: all(np.array_equal(getattr(x, what), getattr(y, what)) for x, y in zip(a_samples, b_samples))
                for what in ("all_latents", "log_probs", "image")}
        new_lp = b.replay_log_probs(b_samples)
        old = np.stack([s.log_probs for s in b_samples], axis=1)
        bad = [i for i, lp in new_lp.items() if not np.all(np.exp(lp.double().cpu().numpy() - old[i]) == 1.0)]
        sde_steps = [int(i) for i in np.nonzero(b_samples[0].extra_kwargs["noise_levels"])[0]]
        step_batch = _sd35_grad_step_batch(b, b_samples, sde_steps[0])
        old_lp = torch.from_numpy(old[b_samples[0].log_prob_index_map[sde_steps[0]]]).to(b.device)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = b.training_forward(b.trainable, step_batch)
        ratio = torch.exp(out.log_prob - old_lp)
        leaves = b.trainable_leaves()
        grads = torch.autograd.grad(-(ratio.mean()), leaves)
        torch.cuda.synchronize()
        secs["grad step B"] = time.perf_counter() - t0
        step_counts = ops.launch_counts()
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        live = sum(bool(g.abs().max() > 0) for g in grads)
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        shutil.rmtree(root)
    remat = b.component_configs["transformer"].remat
    want_step = {"qknorm_flash_fwd": 37 * (2 if remat else 1), "flash_bwd_dq": 37, "flash_bwd_dkv": 37,
                 **SD35_NORMS_A_STEP}
    gbps = nbytes / 1e9 / secs["import"]
    log(f"[import] B's rollout against A's, bit for bit: {json.dumps(same)}; launches A {a_counts} | B "
        f"{b_counts}; B's replay ratio exactly 1.0 on {len(new_lp) - len(bad)}/{len(new_lp)} steps")
    log(f"[import] B's grad step at SDE step {sde_steps[0]} (LoRA rank {b.model_args.lora_rank}): ratio "
        f"{ratio.min().item()!r}..{ratio.max().item()!r}, {live}/{len(grads)} LoRA leaves with a gradient, all "
        f"finite {finite}, launches {step_counts}")
    log(f"[import] {card}: write {secs['write']:.2f} s, import {secs['import']:.2f} s = {gbps:.2f} GB/s "
        f"(predicted {IMPORT_PREDICTED['write_s']} s, {IMPORT_PREDICTED['import_s']} s, "
        f"{IMPORT_PREDICTED['GB/s']} GB/s); peak while B loads beside A {peak_load:.2f} GiB "
        f"({before / 2**30:.2f} GiB before it; predicted {IMPORT_PREDICTED['peak_GiB']}), B's rollout, replay "
        f"and grad step {peak:.2f} GiB; phase seconds {json.dumps({k: round(v, 3) for k, v in secs.items()})}")
    if not all(same.values()):
        fail(f"[import] B's rollout differs from A's: {same}")
    if bad or not new_lp:
        fail(f"[import] B's replay ratio != 1.0 at steps {bad}")
    if b_counts != a_counts or b_counts["qknorm_flash_fwd"] != 37 * 10:
        fail(f"[import] rollout launches A {a_counts}, B {b_counts}, expected 370 K1 each")
    if not (finite and live > 0 and bool((ratio == 1.0).all())):
        fail(f"[import] B's grad step: finite {finite}, {live} live leaves, ratio {ratio.tolist()}")
    if any(step_counts[k] != n for k, n in want_step.items()):
        fail(f"[import] grad-step launches {step_counts}, expected {want_step}")
    del b, b_samples, a_samples, grads, out, step_batch, leaves, ratio
    gc.collect()
    torch.cuda.empty_cache()


def import_only() -> int:
    """``--import``: the environment (the kernels' build) and ``[import]`` alone."""
    from flow_factory_tpu_torch.utils.base import use_full_fp32

    use_full_fp32()
    phase_import(phase_environment())
    return 0


def _wan_config(**overrides):
    from flow_factory_tpu_torch.hparams import Arguments

    # examples/grpo/lora/wan21/t2v.yaml (Wan2.1-T2V-1.3B GRPO) cut to size:
    # 2 prompts x group 4 = 8 videos (B = 16 under CFG) instead of 48 x 24;
    # random bf16 weights from seed 42 (no checkpoint in the repo) for the
    # DiT, UMT5-XXL and the VAE; HashTokenizer ids; the brightness reward
    # instead of PickScore. Widths, depth and geometry are the config's own.
    cfg = {
        "data": {"dataset_dir": "dataset/vid_prompt"},
        "model": {"model_type": "wan2-t2v", "model_name_or_path": "", "variant": "1.3b",
                  "finetune_type": "lora", "lora_rank": 32, "lora_alpha": 64, "target_modules": "default",
                  "attn_backend": "auto", "master_dtype": "float32", "inference_dtype": "bfloat16"},
        "scheduler": {"dynamics_type": "Flow-SDE", "noise_level": 0.8, "num_sde_steps": 2,
                      "sde_steps": [1, 2, 3, 4, 5], "seed": 42},
        "train": {"trainer_type": "grpo", "advantage_aggregation": "sum", "resolution": 256,
                  "num_inference_steps": 10, "guidance_scale": 5.0, "per_device_batch_size": 8,
                  "group_size": 4, "unique_sample_num_per_epoch": 2, "num_frames": 5, "seed": 42},
        "eval": {"resolution": 256, "num_inference_steps": 28, "guidance_scale": 5.0},
        "log": {},
        "rewards": [{"name": "brightness", "reward_model": "MyReward", "batch_size": 8}],
    }
    for section, values in overrides.items():
        cfg[section] = {**cfg[section], **values}
    return Arguments.from_dict(cfg)


def phase_wan() -> dict:
    """The Wan2.1-T2V-1.3B serving slice at full width; returns the launch
    counts of the 10-step rollout."""
    import numpy as np
    import torch

    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.advantage import AdvantageProcessor
    from flow_factory_tpu_torch.models import load_adapter
    from flow_factory_tpu_torch.rewards import RewardProcessor, load_reward_models

    cfg = _wan_config()
    ta = cfg.training_args
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "dataset/vid_prompt/train.txt")) as f:
        prompts = [line.strip() for line in f if line.strip()][:2]
    batch = [p for p in prompts for _ in range(ta.group_size)]
    secs = {}

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    adapter = load_adapter(cfg)  # cuda
    torch.cuda.synchronize()
    secs["load_adapter"] = time.perf_counter() - t0
    tcfg = adapter.component_configs["transformer"]
    n_params = {c: sum(p.numel() for p in m.parameters()) / 1e9 for c, m in adapter.modules.items()}
    log(f"[wan] Wan2.1-T2V-1.3B loaded: hidden {tcfg.hidden_dim}, layers {tcfg.num_layers}, heads "
        f"{tcfg.num_heads} of {tcfg.head_dim}, ffn {tcfg.ffn_dim}; params (B) "
        f"{ {c: round(n, 3) for c, n in n_params.items()} }; scheduler {type(adapter.scheduler).__name__}; "
        f"LoRA on {len(adapter.trainable['transformer'])} weights; {secs['load_adapter']:.1f} s")

    t0 = time.perf_counter()
    enc = adapter.encode_prompt(batch)
    neg = adapter.encode_prompt([""] * len(batch))
    torch.cuda.synchronize()
    secs["encode"] = time.perf_counter() - t0
    kw = dict(height=256, width=256, num_frames=5, guidance_scale=5.0, trajectory_indices="all")
    adapter.rollout()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    samples = adapter.inference(prompt=batch, prompt_embeds=enc["prompt_embeds"],
                                negative_prompt_embeds=neg["prompt_embeds"], num_inference_steps=10,
                                compute_log_prob=True, seed=ta.seed, decode=True, **kw)
    torch.cuda.synchronize()
    secs["rollout+decode"] = time.perf_counter() - t0
    rollout_counts = ops.launch_counts()

    t0 = time.perf_counter()
    RewardProcessor(load_reward_models(cfg.reward_args), cfg.reward_args.reward_weights).score_and_attach(samples)
    metrics = AdvantageProcessor(group_size=ta.group_size, aggregation=ta.advantage_aggregation,
                                 reward_weights=cfg.reward_args.reward_weights).compute_advantages(samples)
    secs["reward+advantage"] = time.perf_counter() - t0

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    new_lp = adapter.replay_log_probs(samples)
    torch.cuda.synchronize()
    secs["replay"] = time.perf_counter() - t0
    replay_counts = ops.launch_counts()

    old = np.stack([s.log_probs for s in samples], axis=1)  # (T, B)
    sde_steps = [int(i) for i in np.nonzero(samples[0].extra_kwargs["noise_levels"])[0]]
    ratios = {i: np.exp(lp.double().cpu().numpy() - old[i].astype(np.float64)) for i, lp in new_lp.items()}
    bad = {i: r.tolist() for i, r in ratios.items() if not np.all(r == 1.0)}
    videos = np.stack([s.video for s in samples])
    rewards = np.asarray([s.extra_kwargs["reward"] for s in samples])
    advantages = np.asarray([s.extra_kwargs["advantage"] for s in samples])
    log(f"[wan] videos {videos.shape} range [{videos.min():.3f}, {videos.max():.3f}] | rewards "
        f"{np.round(rewards, 4).tolist()} | advantages {np.round(advantages, 3).tolist()}")
    log(f"[wan] replayed steps {sorted(new_lp)} (SDE steps {sde_steps}); ratio==1.0 exactly on "
        f"{len(ratios) - len(bad)}/{len(ratios)}; old lp at SDE steps "
        f"{np.round(old[sde_steps].mean(axis=1), 4).tolist()}")
    if videos.shape != (8, 5, 3, 256, 256):
        fail(f"unexpected video batch {videos.shape}")
    for name, arr in (("videos", videos), ("log-probs", old), ("rewards", rewards), ("advantages", advantages)):
        if not np.all(np.isfinite(arr)):
            fail(f"non-finite {name}")
    if bad or len(ratios) != 10:
        fail(f"replay ratio != 1.0 at steps {sorted(bad)}: {bad}")
    # per DiT forward: 2 attentions and 3 K5 norms a block, 1 K5 in the head
    per_forward = {"flash_fwd": 2 * tcfg.num_layers, "ln_mul_add": 3 * tcfg.num_layers + 1}
    want = {name: 10 * n for name, n in per_forward.items()}
    got = {name: rollout_counts[name] for name in want}
    got_replay = {name: replay_counts[name] for name in want}
    log(f"[wan] launches rollout {rollout_counts} | replay of {len(new_lp)} steps {replay_counts} "
        f"(predicted {want} each)")
    if got != want or got_replay != want:
        fail(f"K3/K5 launches differ from the prediction: rollout {got}, replay {got_replay}, want {want}")

    # the decode alone, again on the last stored latents (its share of rollout+decode)
    last = torch.from_numpy(np.stack([s.all_latents[-1] for s in samples])).to(adapter.device)
    t0 = time.perf_counter()
    adapter.decode_latents(last, num_frames=5)
    torch.cuda.synchronize()
    secs["decode alone"] = time.perf_counter() - t0
    phase_profile(adapter, samples, sde_steps[0], "wan_replay_step_trace.json")
    peak = torch.cuda.max_memory_allocated() / 2**30

    # eval: UniPC order 2 predictor-corrector, 28 steps, ODE (log-probs zero)
    adapter.eval()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ev = adapter.inference(prompt=batch[::ta.group_size], prompt_embeds=enc["prompt_embeds"][::ta.group_size],
                           negative_prompt_embeds=neg["prompt_embeds"][::ta.group_size],
                           num_inference_steps=28, seed=ta.seed, **kw)
    torch.cuda.synchronize()
    secs["eval 28 steps+decode"] = time.perf_counter() - t0
    eval_counts = ops.launch_counts()
    adapter.rollout()
    ev_videos = np.stack([s.video for s in ev])
    log(f"[wan] eval (UniPC order {adapter.scheduler.solver_order}, 28 steps, {len(ev)} prompts): videos "
        f"{ev_videos.shape} range [{ev_videos.min():.3f}, {ev_videos.max():.3f}], launches {eval_counts}")
    if ev_videos.shape != (2, 5, 3, 256, 256) or not np.all(np.isfinite(ev_videos)):
        fail(f"eval videos {ev_videos.shape} not finite or of the wrong shape")
    if eval_counts["flash_fwd"] != 28 * per_forward["flash_fwd"] or \
            eval_counts["ln_mul_add"] != 28 * per_forward["ln_mul_add"]:
        fail(f"eval launches {eval_counts} differ from 28 x {per_forward}")

    log(f"[wan] phase seconds {json.dumps({k: round(v, 3) for k, v in secs.items()})} | "
        f"{len(samples) / secs['rollout+decode']:.3f} samples/s (rollout+decode) | peak memory "
        f"{peak:.2f} GiB | advantage/std {metrics['advantage/std']:.4f}")
    del adapter, samples, ev
    return rollout_counts


def _profile(what: str, fn, trace: str) -> dict:
    """torch.profiler over one call of ``fn`` after a warm call: device time
    by kernel, launches, and the device's idle share of the wall time, read
    from the exported trace (``prof.key_averages()`` takes tens of seconds
    of host time on a grad step's hundreds of thousands of events). The
    trace goes to chiprun_out/<trace>.gz."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    os.makedirs("chiprun_out", exist_ok=True)
    path = os.path.join("chiprun_out", trace)
    prof.export_chrome_trace(path)
    by_kernel, calls, by_op = _trace_device_ms(path)
    with open(path, "rb") as src, gzip.open(path + ".gz", "wb", compresslevel=1) as dst:  # ~10x smaller
        shutil.copyfileobj(src, dst)
    os.remove(path)
    busy_ms = sum(by_kernel.values())
    launches = sum(calls.values())
    log(f"[profile] {what}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
        f"idle share {1 - busy_ms / wall_ms:.3f}, {launches} kernel launches (the trace read in "
        f"{time.perf_counter() - t0:.1f} s)")
    for name, ms in by_kernel.most_common(14):
        log(f"[profile]   {ms:9.3f} ms {100 * ms / busy_ms:5.1f}% x{calls[name]:<4d} {name[:90]}")
    for name, ms in by_op.most_common(10):
        log(f"[profile]   by op {ms:9.3f} ms {100 * ms / busy_ms:5.1f}% {name}")
    for name in ("backward _LnMulAddBackward", "backward _ResidualGateModulateBackward"):  # K5/K6's backwards
        if name in by_op:
            log(f"[profile]   {name}: {by_op[name]:.3f} ms of device time ({100 * by_op[name] / busy_ms:.1f}%)")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "launches": launches, "by_kernel": by_kernel}


def _trace_device_ms(trace_path: str):
    """The device time of a torch.profiler chrome trace (kernels, copies and
    memsets): (ms by kernel name, launches by kernel name, ms by what
    launched it: in the backward the outermost autograd node, a Function's
    own backward including the VJPs it runs inside; in the forward the
    outermost op)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    ops = sorted((e for e in events if e.get("cat") == "cpu_op" and e.get("ph") == "X"),
                 key=lambda e: (e["tid"], e["ts"], -e["dur"]))
    parent, stack, launcher = {}, [], {}
    for e in ops:  # nesting per thread from one sweep over start times
        while stack and (stack[-1]["tid"] != e["tid"] or stack[-1]["ts"] + stack[-1]["dur"] < e["ts"] + e["dur"]):
            stack.pop()
        parent[id(e)] = stack[-1] if stack else None
        stack.append(e)
        launcher.setdefault(e["args"].get("External id"), e)

    def phase(op):
        outer, node = op, None
        while parent[id(op)] is not None:
            op = parent[id(op)]
            if op["name"].startswith("autograd::engine::evaluate_function: "):
                node = op["name"].split(": ", 1)[1]
            outer = op
        return f"backward {node}" if node else f"forward {outer['name']}"

    by_kernel, calls, by_op = collections.Counter(), collections.Counter(), collections.Counter()
    for k in events:
        if k.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            ms = k["dur"] / 1e3
            by_kernel[k["name"]] += ms
            calls[k["name"]] += 1
            op = launcher.get(k["args"].get("External id"))
            by_op[phase(op) if op else "unattributed"] += ms
    return by_kernel, calls, by_op


def phase_profile(adapter, samples, step: int, trace: str = "replay_step_trace.json") -> None:
    """One replayed step (the CFG-doubled transformer forward plus the SDE
    step, as in the rollout)."""
    _profile("one replay step", lambda: adapter.replay_log_probs(samples, steps=[step]), trace)


@contextlib.contextmanager
def _swapped(module, **attrs):
    """Module attributes replaced for the duration of a check."""
    old = {name: getattr(module, name) for name in attrs}
    for name, value in attrs.items():
        setattr(module, name, value)
    try:
        yield
    finally:
        for name, value in old.items():
            setattr(module, name, value)


def _k5_backward_controls(N):
    """Stand-ins for K5's backward that drop one term: the dmul term (the
    AdaLN scale's gradient) and, on RMS rows, the −x̂·mean(ĝ·x̂) term of dx.
    Each counts no launch of its own (the kernel counts its launch on what
    stands in its name)."""
    import torch

    k5_backward = N.ln_mul_add_backward

    def without_dmul(*args, **kwargs):
        dx, dmul, dadd = k5_backward(*args, **kwargs)
        return dx, None if dmul is None else torch.zeros_like(dmul), dadd

    def without_rms_term(x, mul, g, eps, rms, needs):
        dx, dmul, dadd = k5_backward(x, mul, g, eps, rms, needs)
        if rms and dx is not None:  # r * g_hat alone: the -x_hat * mean(g_hat * x_hat) term dropped
            x32 = x.float()
            r = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
            dx = (r * g.float() * mul).to(x.dtype)
        return dx, dmul, dadd

    without_dmul.launches = without_rms_term.launches = 0
    return without_dmul, without_rms_term


def _grad_paths_check(tag: str, what: str, model, names, leaves, velocity, x, gen, controls: dict, bar,
                      kind: str = "LoRA", scale_by=None, kinds=None, own=None):
    """The gradients of ``leaves`` (named ``names``) of the summed Flow-SDE
    log-prob of one transition (drawn once, near the step's mean) through
    the kernels (the K5/K6 backward kernels included), against the same
    gradients through the plain path (attention backend ``native``, the
    norm wrappers swapped for their plain versions under autograd), each
    leaf within ``bar`` of its max (one bar, or one a leaf; ``scale_by[i]``,
    where given, names the leaf whose plain gradient's max scales leaf
    ``i``'s error instead) and each leaf ``i`` of ``own`` ({i: bar}) also
    within ``own[i]`` of its own max; then each of ``controls`` ({name: a
    context manager swapping a kernel's backward for a wrong one}) must miss
    a leaf's bar, its worst error by each of ``kinds`` (a kind a leaf)
    logged. ``velocity()`` is the velocity of ``model`` at latents ``x``
    on the current leaves; a tuple of velocities at a tuple of latents
    (LTX-2's video and audio) sums the streams' log-probs. Returns (the
    per-leaf errors, kernel-path grads, plain-path grads, launch counts of
    the kernel path)."""
    import torch

    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.ops import norms as N
    from flow_factory_tpu_torch.scheduler.flow_match_euler import sde_step

    xs = x if isinstance(x, tuple) else (x,)
    full = lambda value: torch.full((xs[0].shape[0],), value, device=xs[0].device)
    sigma, sigma_next = full(0.75), full(0.65)
    step = dict(dynamics_type="Flow-SDE", noise_level=full(0.8), sigma_max=full(0.95), storage_dtype=torch.float16)
    drawn = []

    def grads():
        vs = velocity()
        vs = [v.float() for v in (vs if isinstance(vs, tuple) else (vs,))]
        if not drawn:
            drawn.extend(sde_step(v.detach(), xi, sigma, sigma_next, generator=gen, compute_log_prob=False,
                                  **step).next_latents for v, xi in zip(vs, xs))
        loss = sum(sde_step(v, xi, sigma, sigma_next, next_latents=d, **step).log_prob.sum()
                   for v, xi, d in zip(vs, xs, drawn))
        return torch.autograd.grad(loss, leaves)

    t0 = time.perf_counter()
    ops.reset_launch_counts()
    kern = grads()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    secs = time.perf_counter() - t0
    with contextlib.ExitStack() as stack:
        for m in model.modules():
            if hasattr(m, "attn_backend"):
                stack.enter_context(_swapped(m, attn_backend="native"))
        stack.enter_context(_swapped(
            N, ln_mul_add=lambda x, m, a, eps, dt, fold, rms=False: N._native_ln_mul_add(x, m, a, eps, dt, fold, rms),
            residual_gate_modulate_rows=N._native_residual_gate_modulate))
        plain = grads()

    scales = [plain[i if scale_by is None else scale_by[i]].abs().max().clamp_min(1e-30)
              for i in range(len(leaves))]
    own = own or {}

    def rel_errors(got):
        return [((g - r).abs().max() / c).item() for g, r, c in zip(got, plain, scales)]

    def own_errors(got):
        return {i: ((got[i] - plain[i]).abs().max() / plain[i].abs().max().clamp_min(1e-30)).item() for i in own}

    bars = [bar] * len(leaves) if isinstance(bar, float) else list(bar)
    errs, own_errs = rel_errors(kern), own_errors(kern)
    worst = max(range(len(errs)), key=lambda i: errs[i] / bars[i])
    held = all(e <= b for e, b in zip(errs, bars)) and all(e <= own[i] for i, e in own_errs.items())
    log(f"[{tag}] {what}: {len(leaves)} {kind} leaves, kernel-path grad in {secs:.2f} s, launches {counts}")
    log(f"[{tag}] kernel path vs plain path, per-leaf max|d|/max|ref|: worst {errs[worst]:.3e} ({names[worst]}), "
        f"median {statistics.median(errs):.3e} (bar {bars[worst]:.1e}) {'ok' if held else 'FAILED'}")
    if own:
        log(f"[{tag}] on their own scale (max|d| over their own max|ref|; a gradient of zeros reads 1): "
            f"{json.dumps({names[i]: float(f'{e:.3e}') for i, e in own_errs.items()})} (bars "
            f"{sorted(set(own.values()))})")
    if not held:
        bad = [names[i] for i, e in own_errs.items() if e > own[i]]
        fail(f"{what}: {kind} gradients through the kernels disagree with the plain path: {names[worst]} "
             f"{errs[worst]}{f'; on their own scale {bad}' if bad else ''}")
    for name, swap in controls.items():
        with swap():
            got = grads()
            off, own_off = rel_errors(got), own_errors(got)
        caught = any(e > b for e, b in zip(off, bars)) or any(e > own[i] for i, e in own_off.items())
        top = max(range(len(off)), key=lambda i: off[i] / bars[i])
        by_kind = {k: float(f"{max(e for e, ki in zip(off, kinds) if ki == k):.3e}") for k in sorted(set(kinds))} \
            if kinds else {}
        top_own = max(own_off, key=lambda i: own_off[i] / own[i]) if own else None
        on_own = f"; on their own scale worst {own_off[top_own]:.3e} ({names[top_own]}; bar {own[top_own]:.1e})" \
            if own else ""
        log(f"[{tag}] negative control, {name}: worst leaf {off[top]:.3e} ({names[top]}; bar {bars[top]:.1e}){on_own} "
            f"{'rejected as it must be' if caught else 'NOT REJECTED'}{f'; worst by kind {json.dumps(by_kind)}' if kinds else ''}")
        if not caught:
            fail(f"{what}: the [{tag}] check cannot tell the right backward from one with {name}")
    return errs, kern, plain, counts


def _lora_grad_check(what: str, model, lora, forward, x, gen, k5_control: bool = False,
                     k5_rms_control: bool = False):
    """LoRA gradients through the kernels against the plain path
    (:func:`_grad_paths_check`), with the control K2a's dq zeroed; with
    ``k5_control`` also K5's backward without its dmul term (the AdaLN
    scale's gradient, which reaches the LoRA on the AdaLN linears), with
    ``k5_rms_control`` K5's backward without the RMS term of dx.
    ``forward(params)`` is the velocity of ``model`` on the LoRA-merged
    weights ``params``. The bar: both paths run the same math in bf16 but
    round in other places (the kernels' folded softmax scale and bf16 p,
    the fp32 norms' summation order), which the backward carries into every
    LoRA leaf: worst leaf 1.2e-2 (SD3.5) and 1.4e-2 (Wan) of its max on the
    card, so 3e-2. Returns (leaf names, kernel-path grads, plain-path grads,
    launch counts of the kernel path)."""
    import torch

    from flow_factory_tpu_torch.models.lora import merge_lora
    from flow_factory_tpu_torch.ops import attention as A
    from flow_factory_tpu_torch.ops import norms as N

    names = [f"{path}.{k}" for path in sorted(lora) for k in ("lora_A", "lora_B")]
    leaves = [lora[path][k] for path in sorted(lora) for k in ("lora_A", "lora_B")]
    without_dmul, without_rms_term = _k5_backward_controls(N)
    controls = {"K2a's dq zeroed": lambda: _swapped(A, flash_bwd_dq=lambda q, *args: torch.zeros_like(q))}
    if k5_control:
        controls["K5's backward without its dmul term"] = lambda: _swapped(N, ln_mul_add_backward=without_dmul)
    if k5_rms_control:
        controls["K5's backward without the RMS term of dx"] = lambda: _swapped(
            N, ln_mul_add_backward=without_rms_term)
    _, kern, plain, counts = _grad_paths_check("grad", what, model, names, leaves,
                                               lambda: forward(merge_lora(model, lora, 2.0)), x, gen, controls, 3e-2)
    return names, kern, plain, counts


def phase_grad() -> None:
    """LoRA gradients through the kernels at SD3.5-M width, reduced depth:
    two MMDiT-X blocks (the first with the dual self-attention, the second
    context-pre-only), B=16, 1024 image + 333 context tokens, rank-32 LoRA on
    the default targets and on the AdaLN linears (norm1, norm1_context),
    ``lora_B`` drawn non-zero, checked by :func:`_lora_grad_check`; and a
    non-zero gradient on every LoRA leaf of the attention projections and
    AdaLN linears."""
    import dataclasses

    import torch
    from torch.func import functional_call

    from flow_factory_tpu_torch.models.layers import build_module
    from flow_factory_tpu_torch.models.lora import DEFAULT_TARGET_PATTERNS, init_lora
    from flow_factory_tpu_torch.models.sd3.adapter import _preset
    from flow_factory_tpu_torch.models.sd3.transformer import SD3Transformer

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    cfg = dataclasses.replace(_preset("medium", "auto", "bfloat16")["transformer"], depth=2,
                              dual_attention_layers=(0,))
    model = build_module(lambda: SD3Transformer(cfg), dev, torch.bfloat16, gen)
    adaln = (r".*\.norm1(_context)?\.linear\.weight$",)
    lora = init_lora(model, 32, gen, DEFAULT_TARGET_PATTERNS + adaln)
    for ab in lora.values():  # b != 0, else the gradient of a is zero
        ab["lora_B"].data.normal_(0.0, 1e-2, generator=gen)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
    B = 16
    x = randn(B, 64, 64, cfg.in_channels)
    ctx, pooled = randn(B, 333, cfg.context_dim), randn(B, cfg.pooled_dim)
    t = torch.full((B,), 750.0, device=dev)
    names, kern, plain, counts = _lora_grad_check(
        f"SD3.5-M width, depth 2 (dual block 0), B={B}, S=1357", model, lora,
        lambda params: functional_call(model, params, (x.bfloat16(), t, ctx, pooled)), x, gen, k5_control=True)
    watched = ("attn.to_q", "attn.to_k", "attn.to_v", "attn.add_q_proj", "attn.add_k_proj", "attn.add_v_proj",
               "attn2.to_q", "attn2.to_k", "attn2.to_v", "norm1.linear", "norm1_context.linear")
    # the last block is context-pre-only: its context queries feed no output,
    # so that projection's gradient is zero on both paths
    unused = f"transformer_blocks.{cfg.depth - 1}.attn.add_q_proj."
    live = lambda grads: {n for n, g in zip(names, grads) if g.abs().max().item() > 0}
    checked = [n for n in names if any(w in n for w in watched) and not n.startswith(unused)]
    dead = sorted(set(checked) - live(kern))
    log(f"[grad] non-zero gradient on {len(checked) - len(dead)}/{len(checked)} LoRA leaves of the attention "
        f"projections and AdaLN linears (the last block's context queries feed no output: zero on both paths: "
        f"{not any(n.startswith(unused) for n in live(kern) | live(plain))})")
    if dead or not checked or any(n.startswith(unused) for n in live(plain)):
        fail(f"LoRA leaves with no gradient through the kernels: {dead}")
    if any(counts[k] <= 0 for k in SD35_KERNELS):
        fail(f"a kernel never launched in the [grad] run: {counts}")
    del model, lora, kern, plain
    torch.cuda.empty_cache()


def _loss_value(info: dict, key: str, stat: str) -> float:
    """The min or max of a per-grad-step metric over an optimize phase (the
    phase reduces several steps into ``<key>_min``/``_max``, one step into
    ``<key>``)."""
    return info.get(f"{key}_{stat}", info[key])


def _train_epochs(trainer, tag: str, want_in_optimize, record=None, figures=None) -> dict:
    """The epochs of ``trainer`` driven phase by phase, each timed: the
    replay ratio exactly 1.0 and clip_frac 0 on every grad step (epoch 1
    rolls out with the LoRA that epoch 0 moved), a finite non-zero grad
    norm, the LoRA B moved after the first update, one optimizer step an
    epoch, and the launches of each optimize phase equal to
    ``want_in_optimize(grad steps)``. Returns the launch counts of the
    epochs; ``record`` (a list) gets each epoch's :func:`_epoch_record`,
    ``figures`` (a list) its rollout seconds, grad steps and seconds a grad
    step, and the peak memory so far."""
    import numpy as np
    import torch

    from flow_factory_tpu_torch import ops

    ta = trainer.training_args
    lora = trainer.adapter.trainable["transformer"]
    b0 = {path: ab["lora_B"].detach().clone() for path, ab in lora.items()}
    ops.reset_launch_counts()
    grad_steps = 0
    for epoch in range(ta.max_epochs):
        trainer.epoch = epoch
        trainer.scheduler.set_seed(ta.seed + epoch)
        secs = {}
        t0 = time.perf_counter()
        samples = trainer.sample(epoch)
        torch.cuda.synchronize()
        secs["sample"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        metrics = trainer.prepare_feedback(samples)
        secs["feedback"] = time.perf_counter() - t0
        before = ops.launch_counts()
        t0 = time.perf_counter()
        info = trainer.optimize(samples, epoch)
        torch.cuda.synchronize()
        secs["optimize"] = time.perf_counter() - t0
        during = {k: v - before[k] for k, v in ops.launch_counts().items()}
        trainer.adapter.ema_step(epoch)
        steps = len(list(trainer._micro_batches(len(samples), epoch))) * len(trainer.scheduler.train_timesteps)
        grad_steps += steps
        ratio_lo, ratio_hi = _loss_value(info, "train/ratio_min", "min"), _loss_value(info, "train/ratio_max", "max")
        clip_hi = _loss_value(info, "train/clip_frac", "max")
        gnorm = info["train/grad_norm"]
        log(f"[{tag}] epoch {epoch}: {len(samples)} samples, reward mean {metrics['reward/mean']:.4f}, {steps} "
            f"grad steps, launches in optimize {during}, ratio min {ratio_lo!r} max {ratio_hi!r} on every grad "
            f"step, clip_frac max {clip_hi}, loss {info['train/loss']:.4e}, grad_norm {gnorm:.4e}, global step "
            f"{trainer.global_step}")
        log(f"[{tag}] epoch {epoch} phase seconds {json.dumps({k: round(v, 3) for k, v in secs.items()})} | "
            f"{secs['optimize'] / steps:.3f} s per grad step (optimizer step included)")
        if not (ratio_lo == 1.0 and ratio_hi == 1.0 and clip_hi == 0.0):
            fail(f"[{tag}] epoch {epoch}: replay ratio not exactly 1.0 on every grad step: {info}")
        if not (np.isfinite(gnorm) and gnorm > 0 and np.isfinite(info["train/loss"])):
            fail(f"[{tag}] epoch {epoch}: grad norm {gnorm}, loss {info['train/loss']}")
        want = want_in_optimize(steps)
        if any(during[k] != n for k, n in want.items()):
            fail(f"[{tag}] epoch {epoch}: launches in optimize {during}, expected {want}")
        if record is not None:
            record.append(_epoch_record(trainer, samples, {**metrics, **info}))
        if figures is not None:
            figures.append({"sample": secs["sample"], "steps": steps, "per_step": secs["optimize"] / steps,
                            "peak": torch.cuda.max_memory_allocated() / 2**30})
        if epoch == 0:
            moved = max((lora[p]["lora_B"] - b).abs().max().item() for p, b in b0.items())
            log(f"[{tag}] LoRA B after the first update: max|change| {moved:.3e}")
            if not moved > 0:
                fail(f"[{tag}] the LoRA did not move after the optimizer step")
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{tag}] launches over two epochs (rollouts and grad steps) {counts} | {grad_steps} grad steps | "
        f"peak memory {peak:.2f} GiB")
    if trainer.global_step != ta.max_epochs:
        fail(f"[{tag}] the optimizer did not step once per epoch: global step {trainer.global_step}")
    return counts


def _epoch_record(trainer, samples, scalars: dict) -> dict:
    """What an epoch leaves that a resumed run must reproduce bit for bit:
    each sample's reward and advantage, the epoch's reward statistics and
    grad-step metrics, and a digest of every trainable tensor after the
    update (by its path)."""
    import hashlib

    leaves = {}
    for comp, tree in sorted(trainer.adapter.trainable.items()):
        for path in sorted(tree):
            for k, t in sorted(tree[path].items()):
                leaves[f"{comp}/{path}.{k}"] = hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()
    return {"rewards": [float(s.extra_kwargs["reward"]) for s in samples],
            "advantages": [float(s.extra_kwargs["advantage"]) for s in samples],
            "scalars": {k: float(v) for k, v in scalars.items()}, "leaves": leaves}


def _one_grad_step(trainer):
    """A closure of one grad step as ``optimize`` runs it (forward, the
    backward into the leaves' ``.grad``, the update) on the first batch of
    the last epoch's rollout."""
    batch = next(trainer.grad_step_batches(trainer.reward_buffer.samples, trainer.training_args.max_epochs - 1))

    def grad_step():
        trainer.backward_step(batch)
        trainer.apply_accumulated()

    return grad_step


def _profile_grad_step(trainer, what: str, trace: str) -> dict:
    """One grad step (:func:`_one_grad_step`), profiled: :func:`_profile`'s
    figures."""
    return _profile(what, _one_grad_step(trainer), trace)


def _peak_breakdown(tag: str, fn, top: int = 10) -> None:
    """Run ``fn`` with the allocator's history on and log what was live at
    its peak: the bytes allocated before it, then the blocks it allocated
    and had not freed, grouped by the innermost frame of the port that
    allocated them (autograd's backward allocates with no Python frame).
    Stacks are recorded for allocations alone (so recorded, a remat
    recompute runs under it)."""
    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(max_entries=2_000_000, context="alloc", stacks="python")
    try:
        fn()
        torch.cuda.synchronize()
        events = torch.cuda.memory._snapshot()["device_traces"][torch.cuda.current_device()]
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    cur, top_bytes, at = 0, 0, -1
    for i, e in enumerate(events):
        cur += e["size"] if e["action"] == "alloc" else -e["size"] if e["action"] == "free_completed" else 0
        if cur > top_bytes:
            top_bytes, at = cur, i
    live: dict = {}
    for e in events[:at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
        elif e["action"] == "free_completed":
            live.pop(e["addr"], None)
    groups: dict = collections.Counter()
    for e in live.values():
        site = next((f"{os.path.relpath(f['filename'], here)}:{f['line']} {f['name']}" for f in e.get("frames", [])
                     if "flow_factory_tpu_torch" in f["filename"]), "no port frame (autograd's backward)")
        groups[site] += e["size"]
    gib = lambda n: round(n / 2**30, 3)
    log(f"[{tag}] memory at one grad step's peak: {gib(base)} GiB allocated before it + {gib(top_bytes)} GiB it "
        f"allocated = {gib(base + top_bytes)} GiB (allocator peak {gib(torch.cuda.max_memory_allocated())}); "
        f"its live blocks by site, GiB: {json.dumps({k: gib(v) for k, v in groups.most_common(top)})}; "
        f"{len(events)} allocator events")


def _train_config_dict() -> dict:
    """The config of the GRPO training slice (phases 5 and 5b)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return _config_dict(
        data={"cache_dir": os.path.join(here, "build", "preprocess_cache"), "sampler_type": "group_contiguous"},
        model={"finetune_type": "lora", "lora_rank": 32, "lora_alpha": 64, "target_modules": "default"},
        train={"clip_range": 1e-4, "adv_clip_range": 5.0, "kl_beta": 0.0, "learning_rate": 3e-4,
               "ema_decay": 0.99, "ema_update_interval": 4, "gradient_accumulation_steps": 2,
               "max_epochs": 2},
        eval={"eval_freq": 0},
        log={"logging_backend": "none", "save_freq": 0, "run_name": "chip_smoke_grpo",
             "save_dir": os.path.join(here, "chiprun_out", "train")},
    )


def phase_train(record: list, figures: list = None) -> dict:
    """The GRPO training slice at full width through ``load_trainer``, two
    epochs, each phase timed, each epoch's outcome appended to ``record``
    and its seconds and peak to ``figures``; then a profile of one grad
    step."""
    import torch

    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.trainers import load_trainer

    cfg = Arguments.from_dict(_train_config_dict())
    ta = cfg.training_args
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = load_trainer(cfg)  # cuda
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    lora = trainer.adapter.trainable["transformer"]
    log(f"[train] load_trainer (SD3.5-M, LoRA rank {cfg.model_args.lora_rank} on {len(lora)} weights, "
        f"{sum(v.numel() for ab in lora.values() for v in ab.values()) / 1e6:.1f} M trainable, preprocess "
        f"included) {load_s:.1f} s; remat {trainer.adapter.component_configs['transformer'].remat}; "
        f"gradient_accumulation_steps {ta.gradient_accumulation_steps}")
    # a backward per attention: 24 joint + 13 dual self-attentions; the norms as SD35_NORMS_A_STEP
    counts = _train_epochs(trainer, "train", lambda steps: {
        "flash_bwd_dq": 37 * steps, "flash_bwd_dkv": 37 * steps,
        **{name: n * steps for name, n in SD35_NORMS_A_STEP.items()}}, record, figures)
    if any(counts[k] <= 0 for k in SD35_KERNELS):
        fail(f"a kernel never launched in the SD3.5 GRPO epochs: {counts}")
    # F18: a serving rollout of 2 prompts x 4 under the trained LoRA, replayed at other micro-batch sizes
    ad = trainer.adapter
    prompts = _prompts(os.path.join(os.path.dirname(os.path.abspath(__file__)), "dataset", "pickscore"))
    ad.rollout()
    samples = ad.inference(prompt=[p for p in prompts for _ in range(ta.group_size)], compute_log_prob=True,
                           trajectory_indices="all", seed=ta.seed)
    _microbatch_replay_probe("train", ad, samples, _f18_products(ad, "single_transformer_blocks", 0))
    ad.train()
    _microbatch_grad_probe("train", trainer, samples)
    del samples
    _profile_grad_step(trainer, "one grad step (forward, backward, AdamW)", "grad_step_trace.json")
    trainer.cleanup()
    return counts


# ---------------------------------------------------------------------------
# [parity] and [hybrid]: the parity harness on the card, the hybrid backend
# ---------------------------------------------------------------------------

#: the five families of the JAX package's own golden test
#: (tests/test_parity_harness.py:26-34), by golden name
PARITY_FAMILIES = ("sd35", "wan2_t2v", "ltx2_t2av", "flux1_kontext", "wan2_v2v")
#: SD3.5-M's round trip at 256 px: 16 x 16 patches, the seq_len 256 at which
#: the L2 probe sets the schedule, so that L3 replays the rollout's own step
PARITY_SD35_RESOLUTION = 256
#: the hybrid backend's direct check (tag, B, H, S, D, head-split views):
#: SD3.5-M's joint attention (the concatenated, contiguous q/k/v) and
#: Wan2.1-1.3B's self-attention
HYBRID_SHAPES = (("sd35-joint", 16, 24, 1357, 64, False), ("wan-self", 16, 12, 512, 128, True))
#: K3 at SD3.5-M's attentions, the hybrid backward's recompute (tag, B, H,
#: S, D, head-split views, attentions of that shape a grad step: 24 joint,
#: 13 dual self)
HYBRID_K3_SHAPES = (("sd35-joint", 16, 24, 1357, 64, False, 24), ("sd35-self", 16, 24, 1024, 64, True, 13))


def _parity_paths(name: str):
    here = os.path.dirname(os.path.abspath(__file__))
    return (os.path.join(here, "tests", "goldens", f"{name}.npz"),
            os.path.join(here, "tests", "goldens_torch", f"{name}.inputs.npz"))


def _max_by_level(max_diffs: dict) -> dict:
    out: dict = {}
    for key, d in max_diffs.items():
        level = key.split("/", 1)[0]
        out[level] = max(out.get(level, 0.0), d)
    return dict(sorted(out.items()))


@contextlib.contextmanager
def _kernel_variants():
    """Record the (kernel, dtype, head dim) of every attention kernel call
    inside the block: each wrapper checks its operands with
    ``attention._check_heads`` on a CUDA tensor right before it launches, so
    a spy there sees every K1, K2a, K2b and K3 call; yields the Counter."""
    from flow_factory_tpu_torch.ops import attention as A

    seen = collections.Counter()
    check = A._check_heads

    def spy(name, kernel, q, *rest):
        check(name, kernel, q, *rest)
        seen[(kernel, str(q.dtype).replace("torch.", ""), q.shape[-1])] += 1

    A._check_heads = spy
    try:
        yield seen
    finally:
        A._check_heads = check


def phase_parity() -> dict:
    """[parity]: (a) the five families of the JAX package's golden test at
    their tiny size on the card (fp32, ``attn_backend: native``, TF32 off),
    on the JAX tiny adapters' weights and draws (``tests/goldens_torch``),
    checked against the JAX goldens (``tests/goldens``) at
    ``DEFAULT_TOLERANCES`` with L1 exact: every key, K5 (and SD3's K6) in
    fp32 on the path, no attention kernel; then again under ``auto``
    through the fp32 K1/K3 at head dim 16 (:func:`_parity_auto`, whose
    launch counts it returns); (b) SD3.5-M at full width and
    depth, bf16, ``auto`` (K1, K5, K6), at 256 px: ``record``, then
    ``check`` against that record, max |Δ| exactly 0 at every key, and the
    L3 replay's log-prob equal to the rollout's bit for bit."""
    import numpy as np
    import torch

    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.models import load_adapter
    from flow_factory_tpu_torch.parity import DEFAULT_TOLERANCES, ParityHarness, ProbeInputs
    from flow_factory_tpu_torch.parity.__main__ import make_config

    attention = ("qknorm_flash_fwd", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("[parity] TF32 is on for fp32 matmuls or convolutions")
    native_levels = {}
    for name in PARITY_FAMILIES:
        golden, inputs = _parity_paths(name)
        with open(golden + ".json") as f:
            model_type = json.load(f)["model_type"]
        t0 = time.perf_counter()
        ad = load_adapter(make_config(model_type, "tiny"), device="cuda")
        ops.reset_launch_counts()
        rep = ParityHarness(ad, inputs=ProbeInputs.load(inputs)).check(golden)
        torch.cuda.synchronize()
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        n_keys = len(np.load(golden).files)
        log(f"[parity] {name} ({model_type}, tiny, fp32, native, cuda) against the JAX golden: max|Δ| by level "
            f"{_max_by_level(rep.max_diffs)} (tolerances {DEFAULT_TOLERANCES}), L1 config "
            f"{'equal' if not any(f.startswith('L1') for f in rep.failures) else 'DIFFERS'}, "
            f"{len(rep.max_diffs)}/{n_keys} keys, missing {rep.missing}, extra {rep.extra} | launches {counts} | "
            f"{time.perf_counter() - t0:.1f} s")
        if not rep.passed or rep.missing or rep.extra or len(rep.max_diffs) != n_keys:
            fail(f"[parity] {name} misses the JAX golden:\n{rep.summary()}")
        if not counts.get("ln_mul_add") or any(counts.get(k) for k in attention):
            fail(f"[parity] {name}: K5 must run and no attention kernel under native: {counts}")
        native_levels[name] = _max_by_level(rep.max_diffs)
        del ad
    gc.collect()
    torch.cuda.empty_cache()
    auto_counts = _parity_auto(native_levels)

    # (b) SD3.5-M's own record and check on the card
    cfg = make_config("sd3-5", "", resolution=PARITY_SD35_RESOLUTION, attn_backend="auto", dtype="bfloat16",
                      variant="medium")
    t0 = time.perf_counter()
    ad = load_adapter(cfg, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "parity", "sd35m.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ParityHarness(ad).save(path)
    torch.cuda.synchronize()
    record_s = time.perf_counter() - t0
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    t0 = time.perf_counter()
    rep = ParityHarness(ad).check(path)
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0
    rec = dict(np.load(path))
    zero = bool(rep.max_diffs) and all(d == 0.0 for d in rep.max_diffs.values())
    l3 = rec["L3/log_prob"], rec["L3/rollout_log_prob"]
    l3_same = l3[0].shape == l3[1].shape and np.array_equal(l3[0].view(np.uint32), l3[1].view(np.uint32))
    log(f"[parity] sd35m (SD3.5-M, medium, bf16, auto, {PARITY_SD35_RESOLUTION} px, 4 steps): record then check "
        f"on the card: {len(rec)} keys, max|Δ| exactly 0 at every key: {zero} (largest "
        f"{max(rep.max_diffs.values()) if rep.max_diffs else None}), missing {rep.missing}, extra {rep.extra}, "
        f"L1 config equal: {not rep.failures}; L3 log-prob {l3[0].tolist()} against the rollout's "
        f"{l3[1].tolist()}: bit for bit {l3_same} | launches of one record {counts} | load {load_s:.1f} s, record "
        f"{record_s:.1f} s, check {check_s:.1f} s")
    if not (rep.passed and zero and not rep.missing and not rep.extra and len(rep.max_diffs) == len(rec)):
        fail(f"[parity] SD3.5-M's record and check differ on the card:\n{rep.summary()}")
    if not l3_same:
        fail(f"[parity] SD3.5-M: the L3 replay's log-prob {l3[0]} is not the rollout's {l3[1]}")
    if any(not counts.get(k) for k in ("qknorm_flash_fwd", "ln_mul_add", "residual_gate_modulate")):
        fail(f"[parity] SD3.5-M under auto did not run K1, K5 and K6: {counts}")
    del ad
    gc.collect()
    torch.cuda.empty_cache()
    return auto_counts


#: the attention kernel each tiny family's transformer runs under ``auto``:
#: K1 for SD3.5's qk-norm joint attention, K3 for the rest
PARITY_AUTO_KERNEL = {"sd35": "K1", "wan2_t2v": "K3", "ltx2_t2av": "K3", "flux1_kontext": "K3", "wan2_v2v": "K3"}


def _parity_auto(native_levels: dict) -> dict:
    """[parity] (a) again under ``attn_backend: auto``: the five tiny
    families in fp32 (TF32 off) against the same JAX goldens at
    ``DEFAULT_TOLERANCES``, every attention through the fp32 kernels at head
    dim 16 (K1 for SD3.5, K3 for the rest; no bf16 kernel, no other head
    dim), each level's max |Δ| beside the native pass's. L1 is exact but for
    the field the pass changes, the transformers' ``attn_backend`` ('native'
    in the goldens). Returns the launch counts of the five checks."""
    import numpy as np
    import torch

    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.models import load_adapter
    from flow_factory_tpu_torch.parity import DEFAULT_TOLERANCES, ParityHarness, ProbeInputs
    from flow_factory_tpu_torch.parity.__main__ import make_config

    total: dict = {}
    for name in PARITY_FAMILIES:
        golden, inputs = _parity_paths(name)
        with open(golden + ".json") as f:
            model_type = json.load(f)["model_type"]
        t0 = time.perf_counter()
        ad = load_adapter(make_config(model_type, "tiny", attn_backend="auto"), device="cuda")
        ops.reset_launch_counts()
        with _kernel_variants() as variants:
            rep = ParityHarness(ad, inputs=ProbeInputs.load(inputs)).check(golden)
            torch.cuda.synchronize()
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        total = _add(total, counts)
        backend = [f for f in rep.failures if f.startswith("L1 config: ") and f.endswith(".attn_backend: 'native' != 'auto'")]
        other = [f for f in rep.failures if f not in backend]
        n_keys = len(np.load(golden).files)
        want = PARITY_AUTO_KERNEL[name]
        l1 = [f for f in other if f.startswith("L1")]
        log(f"[parity] {name} ({model_type}, tiny, fp32, auto, cuda) against the JAX golden: max|Δ| by level "
            f"{_max_by_level(rep.max_diffs)}, native's {native_levels[name]} (tolerances {DEFAULT_TOLERANCES}), L1 "
            f"config {f'DIFFERS: {l1}' if l1 else f'equal but for {backend}'}, "
            f"{len(rep.max_diffs)}/{n_keys} keys, missing {rep.missing}, extra {rep.extra} | attention "
            f"kernel calls by (kernel, dtype, head dim) {dict(variants)} | launches {counts} | "
            f"{time.perf_counter() - t0:.1f} s")
        if other or not backend or rep.missing or rep.extra or len(rep.max_diffs) != n_keys:
            fail(f"[parity] {name} under auto misses the JAX golden:\n{rep.summary()}")
        if set(variants) != {(want, "float32", 16)}:
            fail(f"[parity] {name} under auto: attention calls {dict(variants)}, expected {want} in fp32 at D=16 alone")
        if not counts.get("ln_mul_add") or not counts.get("qknorm_flash_fwd" if want == "K1" else "flash_fwd"):
            fail(f"[parity] {name} under auto: launches {counts}")
        del ad
    gc.collect()
    torch.cuda.empty_cache()
    return total


def _hybrid_direct_check(tag: str, B: int, H: int, S: int, D: int, strided: bool, randn) -> None:
    """The hybrid backend against ``flash`` at one shape on the same q, k, v
    and dO: dq, dk, dv bit for bit (the same K3 recompute feeds the same
    K2), the forward (the plain product) within K3's bar of K3's plain
    version, one K3, K2a and K2b launch and no library attention op in its
    forward and backward."""
    import torch

    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.ops import attention as A

    def heads():
        t = randn(B, S, H, D).transpose(1, 2) if strided else randn(B, H, S, D)
        return t.detach().requires_grad_()

    q, k, v = heads(), heads(), heads()
    dout = randn(B, S, H, D).transpose(1, 2)  # head-interleaved, as the head merge's backward gives it
    scale = D ** -0.5

    def run(backend):
        out = A.dot_product_attention(q, k, v, scale=scale, backend=backend)
        return (out.detach(), *torch.autograd.grad(out, (q, k, v), dout))

    before = ops.launch_counts()
    hybrid, called = _aten_ops_called(lambda: run("hybrid"))
    torch.cuda.synchronize()
    mid = ops.launch_counts()
    flash = run("flash")
    torch.cuda.synchronize()
    launched = {k: n - before[k] for k, n in mid.items() if n != before[k]}
    same = [torch.equal(a, b) for a, b in zip(hybrid[1:], flash[1:])]
    with torch.no_grad():
        ref = A.flash_attention_plain(q, k, v, scale)
    tol = 4 * bf16_ulp(ref.float().abs().max().item())
    err = (hybrid[0].float() - ref.float()).abs().max().item()
    library = sorted(n for n in called if any(op in n for op in LIBRARY_ATTENTION_OPS))
    layout = "q/k/v views" if strided else "contiguous"
    log(f"[hybrid] {tag} B{B} H{H} S{S} D{D} bf16 {layout}: dq/dk/dv against flash's bit for bit {same}; "
        f"launches of its forward and backward {launched}; library attention ops {library} of {len(called)} "
        f"ops dispatched")
    _check(f"hybrid {tag} forward (the plain product) against K3's plain version", err, tol)
    if not all(same):
        fail(f"[hybrid] {tag}: the gradients differ from flash's")
    if launched != {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1} or library:
        fail(f"[hybrid] {tag}: launches {launched}, library ops {library}")
    del q, k, v, dout, hybrid, flash, ref
    torch.cuda.empty_cache()


def _k3_sd35_call(B: int, H: int, S: int, D: int, strided: bool):
    """K3 on fresh bf16 inputs of an SD3.5-M attention's shape and layout, as a call."""
    import torch

    from flow_factory_tpu_torch.ops import attention as A

    make = (lambda: torch.randn(B, S, H, D, device="cuda", dtype=torch.bfloat16).transpose(1, 2)) if strided \
        else (lambda: torch.randn(B, H, S, D, device="cuda", dtype=torch.bfloat16))
    return functools.partial(A.flash_attention, make(), make(), make(), D ** -0.5)


def phase_hybrid(results: dict, train_figures: list) -> dict:
    """[hybrid]: ``attn_backend: hybrid`` (the plain forward, K3's recompute
    and K2a/K2b in the backward) on the card. The direct check at SD3.5-M's
    joint and Wan2.1's self shapes (:func:`_hybrid_direct_check`); K3 at
    SD3.5-M's joint and self shapes through the checks of 2 (the kernel
    table's rows of the recompute); then one epoch of the GRPO training
    slice of 5 at the same geometry under ``hybrid``: ratio exactly 1.0 on
    every grad step, no K1 anywhere, 37 K3 / 37 K2a / 37 K2b a grad step and
    no K3 in the rollout, no library attention op in a grad step; its
    rollout and grad-step seconds and peak beside [train]'s (flash) from
    ``train_figures``. Returns the epoch's launch counts."""
    import torch

    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.trainers import load_trainer

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(torch.bfloat16)
    for shape in HYBRID_SHAPES:
        _hybrid_direct_check(*shape, randn)
    for tag, B, H, S, D, strided, _ in HYBRID_K3_SHAPES:
        heads = (lambda: randn(B, S, H, D).transpose(1, 2)) if strided else (lambda: randn(B, H, S, D))
        q, k, v = heads(), heads(), heads()
        _k3_shape_checks(results, tag, q, k, v, "q/k/v views" if strided else "contiguous",
                         functools.partial(_k3_sd35_call, B, H, S, D, strided))
        del q, k, v

    cfg_dict = _train_config_dict()
    cfg_dict["model"] = {**cfg_dict["model"], "attn_backend": "hybrid"}
    cfg_dict["train"] = {**cfg_dict["train"], "max_epochs": 1}
    cfg_dict["log"] = {**cfg_dict["log"], "run_name": "chip_smoke_hybrid"}
    cfg = Arguments.from_dict(cfg_dict)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    retries0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    t0 = time.perf_counter()
    trainer = load_trainer(cfg)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if trainer.adapter.component_configs["transformer"].attn_backend != "hybrid":
        fail("[hybrid] the trainer's transformer does not run the hybrid backend")
    figures: list = []
    counts = _train_epochs(trainer, "hybrid", lambda steps: {
        "qknorm_flash_fwd": 0, "flash_fwd": 37 * steps, "flash_bwd_dq": 37 * steps, "flash_bwd_dkv": 37 * steps,
        **{name: n * steps for name, n in SD35_NORMS_A_STEP.items()}}, figures=figures)
    steps = figures[0]["steps"]
    if counts["qknorm_flash_fwd"] or counts["flash_fwd"] != 37 * steps:
        fail(f"[hybrid] K1 launched, or K3 outside the grad steps' backwards: {counts}")
    _, called = _aten_ops_called(_one_grad_step(trainer))
    torch.cuda.synchronize()
    library = sorted(n for n in called if any(op in n for op in LIBRARY_ATTENTION_OPS))
    log(f"[hybrid] one grad step (forward, backward, AdamW) under a dispatch recorder: library attention ops "
        f"{library} of {len(called)} ops dispatched")
    if library:
        fail(f"[hybrid] a library attention op ran in the grad step: {library}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries0
    h = figures[0]
    f = train_figures[0] if train_figures else None
    line = (f"[hybrid] hybrid (the plain forward, K3 + K2 backward) against flash (K1 forward, K2 backward) at "
            f"the [train] geometry (8 samples, 512 px, 10 steps, CFG 4.5, B 16): load_trainer {load_s:.1f} s; "
            f"epoch 0 rollout {h['sample']:.3f} s, {h['per_step']:.3f} s a grad step; peak {peak:.2f} GiB; the "
            f"allocator's retries {retries}")
    if f is not None:
        line += (f" | [train] epoch 0 (flash, the same LoRA at zero): rollout {f['sample']:.3f} s, "
                 f"{f['per_step']:.3f} s a grad step, peak {f['peak']:.2f} GiB over its two epochs | hybrid/flash: "
                 f"rollout {h['sample'] / f['sample']:.2f}x, grad step {h['per_step'] / f['per_step']:.2f}x")
    log(line)
    _profile_grad_step(trainer, "one hybrid grad step (forward, backward, AdamW)", "hybrid_grad_step_trace.json")
    trainer.cleanup()
    del trainer
    return counts


def parity_hybrid_only(flags) -> int:
    """``--parity`` and/or ``--hybrid``: the build, then [parity] and/or
    [hybrid] (without [train]'s figures beside it) and the device times of
    [hybrid]'s K3 shapes."""
    from flow_factory_tpu_torch.utils.base import use_full_fp32

    use_full_fp32()
    phase_environment()
    if "--parity" in flags:
        phase_parity()
    if "--hybrid" in flags:
        phase_hybrid({}, [])
        for job in DEVICE_TIME_JOBS:
            job()
    log("parity/hybrid phases: ok")
    return 0


def fp32_only() -> int:
    """``python3 chip_smoke.py --fp32``: the build, the fp32 kernels' checks
    and timings (:func:`phase_kernels_f32`), [parity] (the native pass, the
    auto pass through the fp32 K1/K3 at head dim 16, SD3.5-M's record and
    check), [wan-fp32], then the fp32 rows' device times."""
    from flow_factory_tpu_torch.utils.base import use_full_fp32

    use_full_fp32()
    phase_environment()
    phase_kernels_f32({})
    phase_parity()
    phase_wan_fp32()
    for job in DEVICE_TIME_JOBS:
        job()
    log("fp32 phases: ok")
    return 0


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path) for f in files)


def _first_difference(got: dict, want: dict):
    """The first key (in ``want``'s order) whose value differs, else None."""
    return next((k for k in want if got.get(k) != want[k]), None)


def _preempt_through_the_cli(cfg_path: str, save_dir: str, run: str, out_dir: str, card: str) -> str:
    """``python -m flow_factory_tpu_torch.cli`` on the training config in a
    subprocess, sent SIGTERM as soon as epoch 0's row is in its
    ``metrics.jsonl`` (polled every 0.1 s): it must write ``preempt/`` and
    exit 0. Returns the preempt directory."""
    import signal

    here = os.path.dirname(os.path.abspath(__file__))
    metrics = os.path.join(save_dir, run, "metrics.jsonl")
    cmd = [sys.executable, "-m", "flow_factory_tpu_torch.cli", cfg_path, "--set", "log.save_freq=0",
           "--set", f"log.run_name={run}", "--set", f"log.save_dir={save_dir}"]
    log_path = os.path.join(out_dir, "cli.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as out:
        proc = subprocess.Popen(cmd, cwd=here, stdout=out, stderr=subprocess.STDOUT)
        try:
            sent = None
            while proc.poll() is None and time.perf_counter() - t0 < 600:
                rows = []
                if os.path.exists(metrics):
                    with open(metrics) as f:
                        rows = [json.loads(line) for line in f if line.strip()]
                if any(r.get("step") == 0 and "media_tag" not in r for r in rows):
                    proc.send_signal(signal.SIGTERM)
                    sent = time.perf_counter() - t0
                    break
                time.sleep(0.1)
            if sent is None:
                fail(f"[resume] the CLI run ended (rc {proc.poll()}) or stalled before epoch 0's row was "
                     f"written; log in {log_path}")
            try:
                rc = proc.wait(timeout=300)
            except subprocess.TimeoutExpired:
                fail("[resume] the CLI run did not exit within 300 s of SIGTERM")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    text = open(log_path).read()
    pdir = os.path.join(save_dir, run, "preempt")
    saved = re.search(r"Saved checkpoint to \S+ in ([0-9.]+) s", text)
    log(f"[resume] CLI subprocess (fft-train-torch on the phase-5 config): SIGTERM sent {sent:.1f} s after "
        f"launch, exit code {rc} after {time.perf_counter() - t0:.1f} s; preempt save "
        f"{saved.group(1) if saved else 'not logged'} s in the subprocess | {card}")
    if rc != 0 or not os.path.isdir(pdir):
        fail(f"[resume] the preempted CLI run exited {rc} with preempt/ {'present' if os.path.isdir(pdir) else 'missing'}; "
             f"log tail: {text[-2000:]}")
    return pdir


def phase_resume(record: list, card: str) -> None:
    """The run plumbing on the SD3.5-M GRPO path: a SIGTERM preemption of
    the CLI in a subprocess, then a resume through ``load_trainer`` whose
    restored state equals the files bit for bit and whose epoch 1 equals
    phase 5's uninterrupted epoch 1 bit for bit."""
    import torch
    import yaml

    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models.abc import BaseAdapter
    from flow_factory_tpu_torch.trainers import load_trainer

    here = os.path.dirname(os.path.abspath(__file__))
    save_dir = os.path.join(here, "build", "resume")  # ~1 GB of checkpoint: not brought back
    out_dir = os.path.join(here, "chiprun_out", "resume")
    shutil.rmtree(save_dir, ignore_errors=True)
    os.makedirs(out_dir, exist_ok=True)
    cfg_dict = _train_config_dict()
    cfg_path = os.path.join(out_dir, "train_config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg_dict, f)
    pdir = _preempt_through_the_cli(cfg_path, save_dir, "chip_smoke_preempt", out_dir, card)

    lora_file = os.path.join(pdir, "lora_transformer.safetensors")
    state_file = os.path.join(pdir, "train_state", BaseAdapter.TRAIN_STATE_FILE)
    have = sorted(os.listdir(pdir))
    if have != ["adapter_config.json", "lora_transformer.safetensors", "train_state"]:
        fail(f"[resume] preempt/ holds {have}")
    t0 = time.perf_counter()
    state = torch.load(state_file, map_location="cpu", weights_only=True)
    read_s = time.perf_counter() - t0
    n_lora = sum(t.numel() for tree in state["trainable"].values() for ab in tree.values() for t in ab.values())
    log(f"[resume] preempt/: {_dir_bytes(pdir) / 1e6:.1f} MB in all; lora_transformer.safetensors "
        f"{os.path.getsize(lora_file) / 1e6:.1f} MB ({n_lora / 1e6:.1f} M fp32 LoRA parameters, the EMA's), "
        f"train_state/ {_dir_bytes(os.path.join(pdir, 'train_state')) / 1e6:.1f} MB (trainable, EMA, AdamW, epoch, "
        f"step; torch.load {read_s:.2f} s); recorded epoch {state['epoch']}, global step {state['global_step']}")
    if state["epoch"] != 0 or state["global_step"] != 1:
        fail(f"[resume] the preempt save records epoch {state['epoch']}, global step {state['global_step']}; "
             f"expected epoch 0 (SIGTERM after epoch 0) and step 1")

    cfg = Arguments.from_dict({**cfg_dict, "log": {**cfg_dict["log"], "save_dir": save_dir,
                                                   "run_name": "chip_smoke_resumed"},
                               "model": {**cfg_dict["model"], "resume_path": pdir}})
    load = {}
    original = BaseAdapter.load_checkpoint

    def timed_load(adapter, *args, **kwargs):
        t = time.perf_counter()
        original(adapter, *args, **kwargs)
        load["s"] = time.perf_counter() - t

    t0 = time.perf_counter()
    with _swapped(BaseAdapter, load_checkpoint=timed_load):
        trainer = load_trainer(cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if "s" not in load:
        fail("[resume] model.resume_path was not loaded at construction")
    log(f"[resume] load_trainer with model.resume_path: {build_s:.1f} s (model build and preprocess included), "
        f"of which load_checkpoint {load['s']:.2f} s | {card}")

    # the restored state against the files, bit for bit
    def same(live, saved) -> bool:
        return len(live) == len(saved) and all(torch.equal(a.detach().cpu(), b) for a, b in zip(live, saved))

    leaves = trainer.adapter.trainable_leaves
    saved = leaves(state["trainable"])
    opt_live, opt_saved = trainer.optimizer.state_dict()["state"], state["opt_state"]["state"]
    opt_tensors = [(i, k) for i in sorted(opt_saved) for k in sorted(opt_saved[i])]
    checks = {
        f"trainable ({sum(t.numel() for t in saved)} elements)": same(leaves(), saved),
        f"EMA params ({sum(t.numel() for t in leaves(state['ema']['params']))} elements)":
            same(leaves(trainer.adapter.ema.params), leaves(state["ema"]["params"])),
        f"EMA step ({state['ema']['step']})": trainer.adapter.ema.step == state["ema"]["step"],
        f"AdamW state ({len(opt_tensors)} tensors, "
        f"{sum(opt_saved[i][k].numel() for i, k in opt_tensors)} elements)":
            sorted(opt_live) == sorted(opt_saved)
            and same([opt_live[i][k] for i, k in opt_tensors], [opt_saved[i][k] for i, k in opt_tensors]),
        f"epoch {trainer.epoch} / global step {trainer.global_step}": (trainer.epoch, trainer.global_step) == (1, 1),
    }
    for name, ok in checks.items():
        log(f"[resume] restored {name} equal to the files: {ok}")
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        fail(f"[resume] the restored state differs from the files: {bad}")
    del state

    # epoch 1 through start(), against phase 5's uninterrupted epoch 1
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.start()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    with open(os.path.join(save_dir, "chip_smoke_resumed", "metrics.jsonl")) as f:
        rows = [r for r in map(json.loads, f) if "media_tag" not in r]
    got = _epoch_record(trainer, trainer.reward_buffer.samples, rows[-1] if rows else {})
    want = record[1]
    ratio = (_loss_value(got["scalars"], "train/ratio_min", "min"), _loss_value(got["scalars"], "train/ratio_max", "max"))
    log(f"[resume] resumed epoch 1 through start(): {epoch_s:.1f} s, logged epochs {[r['step'] for r in rows]}, "
        f"global step {trainer.global_step}, launches {counts}, ratio min {ratio[0]!r} max {ratio[1]!r} | {card}")
    diffs = []
    for what in ("rewards", "advantages"):
        i = _first_difference(dict(enumerate(got[what])), dict(enumerate(want[what])))
        if i is not None or len(got[what]) != len(want[what]):
            diffs.append(f"{what} (sample {i})")
    key = _first_difference(got["scalars"], want["scalars"])
    if key is not None:
        diffs.append(f"metric {key}: {got['scalars'].get(key)!r} vs {want['scalars'][key]!r}")
    leaf = _first_difference(got["leaves"], want["leaves"])
    if leaf is not None:
        diffs.append(f"LoRA tensor {leaf} after the update")
    log(f"[resume] resumed epoch 1 vs the uninterrupted epoch 1 of phase 5: {len(want['rewards'])} rewards and "
        f"advantages, {len(want['scalars'])} reward and grad-step metrics, {len(want['leaves'])} LoRA tensors "
        f"after the update: {'all bit-equal' if not diffs else 'DIFFER: ' + '; '.join(diffs)}")
    if [r["step"] for r in rows] != [1] or trainer.global_step != 2:
        fail(f"[resume] the resumed run logged epochs {[r['step'] for r in rows]}, global step {trainer.global_step}")
    if ratio != (1.0, 1.0):
        fail(f"[resume] replay ratio not exactly 1.0 on every grad step of the resumed epoch: {ratio}")
    if any(counts[k] <= 0 for k in SD35_KERNELS):
        fail(f"[resume] a kernel never launched in the resumed epoch: {counts}")
    if diffs:
        fail(f"[resume] the resumed epoch differs from the uninterrupted one: {diffs[0]}")

    t0 = time.perf_counter()
    trainer.save_checkpoint(os.path.join(save_dir, "resave"), model_only=False)
    torch.cuda.synchronize()
    save_s = time.perf_counter() - t0
    log(f"[resume] the same full-state save in this process: {save_s:.2f} s for "
        f"{_dir_bytes(os.path.join(save_dir, 'resave')) / 1e6:.1f} MB | {card}")
    trainer.cleanup()
    shutil.rmtree(save_dir, ignore_errors=True)


def phase_grad_wan() -> None:
    """LoRA gradients through the kernels at Wan2.1-1.3B width, reduced
    depth: two blocks, B=16 (the CFG batch), 512 video tokens (256 px x 5
    frames) and 512 UMT5 context tokens, rank-32 LoRA on the 20 Wan targets
    of the two blocks, ``lora_B`` drawn non-zero, checked by
    :func:`_lora_grad_check`; a non-zero gradient on every leaf, and K3,
    K2a and K2b launched once per attention."""
    import dataclasses

    import torch
    from torch.func import functional_call

    from flow_factory_tpu_torch.models.layers import build_module
    from flow_factory_tpu_torch.models.lora import init_lora
    from flow_factory_tpu_torch.models.wan.t2v import WAN_LORA_TARGETS
    from flow_factory_tpu_torch.models.wan.transformer import WanConfig, WanTransformer

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    cfg = dataclasses.replace(WanConfig.wan21_1_3b(), num_layers=2)
    model = build_module(lambda: WanTransformer(cfg), dev, torch.bfloat16, gen)
    lora = init_lora(model, 32, gen, WAN_LORA_TARGETS)
    for ab in lora.values():  # b != 0, else the gradient of a is zero
        ab["lora_B"].data.normal_(0.0, 1e-2, generator=gen)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
    B = 16
    x = randn(B, 2, 32, 32, cfg.in_channels)  # 2 latent frames of 32 x 32: 512 tokens
    ctx = randn(B, 512, cfg.context_dim)
    t = torch.full((B,), 750.0, device=dev)
    names, kern, _, counts = _lora_grad_check(
        f"Wan2.1-1.3B width, depth 2, B={B}, 512 video + 512 context tokens", model, lora,
        lambda params: functional_call(model, params, (x, t, ctx)), x, gen)
    dead = [n for n, g in zip(names, kern) if not g.abs().max().item() > 0]
    log(f"[grad] Wan: non-zero gradient on {len(names) - len(dead)}/{len(names)} LoRA leaves")
    per_forward = 2 * cfg.num_layers
    want = {"flash_fwd": per_forward, "flash_bwd_dq": per_forward, "flash_bwd_dkv": per_forward}
    if dead or any(counts[k] != n for k, n in want.items()) or min(counts["ln_mul_add"],
                                                                   counts["ln_mul_add_backward"]) <= 0:
        fail(f"Wan [grad]: LoRA leaves without gradient {dead}, or launches {counts} differ from {want}")
    del model, lora, kern
    torch.cuda.empty_cache()


def phase_wan_train() -> dict:
    """The Wan2.1-T2V-1.3B GRPO training slice at full width through
    ``load_trainer``: the rollout geometry of ``[wan]``, LoRA rank 32 on the
    300 default targets, fp32 master weights, AdamW 3e-4, clip 1e-4, adv
    clip 5, two grad steps accumulated into one update per epoch, EMA 0.99
    every 4, two epochs; then the evaluation that ``eval_freq: 2`` runs at
    the start of epoch 2 (a 28-step UniPC rollout of the 2 test prompts
    under the EMA weights) and a profile of one grad step. Returns the
    launch counts of the two epochs."""
    import numpy as np
    import torch

    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.trainers import load_trainer

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = _wan_config(
        data={"cache_dir": os.path.join(here, "build", "preprocess_cache"), "sampler_type": "group_contiguous"},
        train={"clip_range": 1e-4, "adv_clip_range": 5.0, "kl_beta": 0.0, "learning_rate": 3e-4,
               "ema_decay": 0.99, "ema_update_interval": 4, "gradient_accumulation_steps": 2, "max_epochs": 2},
        eval={"eval_freq": 2, "per_device_batch_size": 8, "seed": 42},
        log={"logging_backend": "none", "save_freq": 0, "run_name": "chip_smoke_wan_grpo",
             "save_dir": os.path.join(here, "chiprun_out", "train")},
    )
    ta = cfg.training_args
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = load_trainer(cfg)  # cuda
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    tcfg = trainer.adapter.component_configs["transformer"]
    lora = trainer.adapter.trainable["transformer"]
    log(f"[wan-train] load_trainer (Wan2.1-T2V-1.3B, LoRA rank {cfg.model_args.lora_rank} on {len(lora)} weights, "
        f"{sum(v.numel() for ab in lora.values() for v in ab.values()) / 1e6:.2f} M trainable, preprocess "
        f"included) {load_s:.1f} s; remat {tcfg.remat}; gradient_accumulation_steps "
        f"{ta.gradient_accumulation_steps}; EMA {ta.ema_decay} every {ta.ema_update_interval}")
    # K3 launches of one DiT forward, K2a/K2b of one backward: self + cross per
    # block; K5: 3 a block and the head, each with a backward but block 0's
    # first norm, whose inputs (the patch embedding, the AdaLN vectors) are frozen
    per_forward = 2 * tcfg.num_layers
    runs = 2 if tcfg.remat else 1  # remat runs each forward again
    counts = _train_epochs(trainer, "wan-train", lambda steps: {
        "flash_bwd_dq": per_forward * steps, "flash_bwd_dkv": per_forward * steps,
        "flash_fwd": per_forward * steps * runs, "ln_mul_add": (3 * tcfg.num_layers + 1) * steps * runs,
        "ln_mul_add_backward": 3 * tcfg.num_layers * steps})

    # the evaluation that eval_freq 2 runs before epoch 2: UniPC, 28 steps, EMA weights
    before = ops.launch_counts()
    t0 = time.perf_counter()
    eval_metrics = trainer.evaluate(ta.max_epochs)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    during = {k: v - before[k] for k, v in ops.launch_counts().items()}
    steps = cfg.eval_args.num_inference_steps
    log(f"[wan-train] evaluate ({type(trainer.scheduler).__name__} order {trainer.scheduler.solver_order}, "
        f"{steps} steps, EMA weights): {json.dumps({k: round(v, 5) for k, v in eval_metrics.items()})}, "
        f"launches {during}, {eval_s:.2f} s")
    if not (eval_metrics.get("eval/num_samples") == 2.0 and all(np.isfinite(v) for v in eval_metrics.values())):
        fail(f"Wan evaluate: {eval_metrics}")
    if during["flash_fwd"] != steps * per_forward:
        fail(f"Wan evaluate: K3 launches {during['flash_fwd']}, expected {steps} steps x {per_forward}")
    _profile_grad_step(trainer, "one Wan grad step (forward, backward, AdamW)", "wan_grad_step_trace.json")
    trainer.cleanup()
    return counts


#: [wan-fp32]'s phase seconds (load, the epoch and the profiled grad step)
#: and peak memory in GiB, predicted in PERF.md before its first run
WAN_FP32_PREDICTED = {"seconds": (20.0, 35.0), "peak_GiB": (33.0, 45.0)}
#: the attention kernels [wan-fp32] may call: (kernel, dtype, head dim)
WAN_FP32_VARIANTS = {("K3", "float32", 128), ("K2a", "float32", 128), ("K2b", "float32", 128)}


def phase_wan_fp32() -> dict:
    """[wan-fp32]: Wan2.1-T2V-1.3B LoRA GRPO in fp32 at full width and
    depth through ``load_trainer`` (tests/fixtures/wan21_fp32_grpo.yaml:
    mixed precision off, fp32 master and inference weights, ``auto``, remat,
    4 steps, one grad step) for one epoch (:func:`_train_epochs`: ratio
    exactly 1.0 on the grad step, the LoRA moved, the optimize phase's
    launches); every attention call K3, K2a or K2b in fp32 at head dim 128,
    the rollout's launches as predicted, the log-probs finite; a profiled
    grad step whose attention kernels are the fp32 ones alone (no library
    attention op); seconds and peak against WAN_FP32_PREDICTED. Returns the
    epoch's launch counts."""
    import numpy as np
    import torch

    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.trainers import load_trainer

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = Arguments.load_from_yaml(os.path.join(here, "tests", "fixtures", "wan21_fp32_grpo.yaml"))
    cfg.data_args.cache_dir = os.path.join(here, "build", "preprocess_cache_fp32")
    cfg.log_args.save_dir = os.path.join(here, "chiprun_out", "train")
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    trainer = load_trainer(cfg)  # cuda
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t_phase
    ad, ta = trainer.adapter, trainer.training_args
    tcfg = ad.component_configs["transformer"]
    lora = ad.trainable["transformer"]
    dtypes = sorted({str(p.dtype) for m in ad.modules.values() for p in m.parameters()}
                    | {str(t.dtype) for ab in lora.values() for t in ab.values()})
    log(f"[wan-fp32] load_trainer ({type(ad).__name__}: {tcfg.num_layers} blocks, width {tcfg.hidden_dim}, "
        f"{tcfg.num_heads} heads of {tcfg.hidden_dim // tcfg.num_heads}; mixed precision "
        f"{cfg.mixed_precision!r}; parameter dtypes {dtypes}; attn_backend {tcfg.attn_backend}; remat {tcfg.remat}; "
        f"LoRA rank {cfg.model_args.lora_rank} on {len(lora)} weights; {ta.num_inference_steps} steps; preprocess "
        f"included) {load_s:.1f} s; allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    if dtypes != ["torch.float32"] or not tcfg.remat or tcfg.attn_backend != "auto":
        fail(f"[wan-fp32] not the fixture's fp32 model: dtypes {dtypes}, remat {tcfg.remat}, {tcfg.attn_backend}")
    # a forward: K3 for the self- and the cross-attention of each block, K5
    # three a block and the head; a grad step under remat: the blocks twice
    # (the head's K5 once), K2a/K2b once an attention, K5's backward for all
    # but block 0's first norm
    forward = {"flash_fwd": 2 * tcfg.num_layers, "ln_mul_add": 3 * tcfg.num_layers + 1}
    grad_step = {"flash_fwd": 4 * tcfg.num_layers, "ln_mul_add": 6 * tcfg.num_layers + 1,
                 "flash_bwd_dq": 2 * tcfg.num_layers, "flash_bwd_dkv": 2 * tcfg.num_layers,
                 "ln_mul_add_backward": 3 * tcfg.num_layers}
    figures: list = []
    with _kernel_variants() as variants:
        counts = _train_epochs(trainer, "wan-fp32", lambda steps: _mul(grad_step, steps), figures=figures)
    samples = trainer.reward_buffer.samples
    batches = -(-len(samples) // ta.per_device_batch_size)
    rollout = {k: counts[k] - figures[0]["steps"] * grad_step.get(k, 0) for k in forward}
    want = _mul(forward, ta.num_inference_steps * batches)
    finite = all(np.isfinite(s.log_probs).all() for s in samples)
    log(f"[wan-fp32] the rollout's launches {rollout} (expected {want}: {ta.num_inference_steps} steps x {batches} "
        f"batch of B {2 * ta.per_device_batch_size} under CFG); attention calls by (kernel, dtype, head dim) "
        f"{dict(variants)}; log-probs finite on every sample: {finite}")
    if rollout != want or set(variants) != WAN_FP32_VARIANTS or not finite:
        fail(f"[wan-fp32] rollout launches {rollout}, attention calls {dict(variants)}, log-probs finite {finite}")
    prof = _profile_grad_step(trainer, "one fp32 Wan grad step (remat; LoRA merge, forward, recompute, backward, "
                              "AdamW)", "wan_fp32_grad_step_trace.json")
    attn = sorted(n for n in prof["by_kernel"] if any(w in n.lower() for w in ("flash", "fmha", "attention", "sdpa")))
    library = [n for n in attn if "_f32_kernel<128" not in n]
    log(f"[wan-fp32] the attention kernels of the profiled grad step: {[n[:90] for n in attn]}; others (a library "
        f"attention op) {library}")
    if library or len(attn) != 3:
        fail(f"[wan-fp32] the grad step's attention kernels are not the fp32 K3, K2a and K2b: {attn}")
    secs = time.perf_counter() - t_phase
    peak = torch.cuda.max_memory_allocated() / 2**30
    inside = lambda x, r: "inside" if r[0] <= x <= r[1] else "outside"
    lo, hi = WAN_FP32_PREDICTED["seconds"]
    plo, phi = WAN_FP32_PREDICTED["peak_GiB"]
    log(f"[wan-fp32] {card_name()}: phase {secs:.1f} s (predicted {lo:.0f}-{hi:.0f} s: {inside(secs, (lo, hi))}); "
        f"peak {peak:.2f} GiB (predicted {plo:.0f}-{phi:.0f} GiB: {inside(peak, (plo, phi))}); rollout "
        f"{figures[0]['sample']:.3f} s, {figures[0]['per_step']:.3f} s a grad step (the optimizer step included); "
        f"launches {counts}")
    trainer.cleanup()
    return counts


# ---------------------------------------------------------------------------
# FLUX.1-dev: the kernels at its shapes, its LoRA gradients, and LoRA DPO
# ---------------------------------------------------------------------------

#: K5 at FLUX.1's width (D = 3072: a 4096 block, 8 warps forward, 16
#: backward), the 512 px grad step's B = 2 shapes: the image stream (1024
#: tokens, the double blocks' img norms), the text stream (512, their txt
#: norms) and the joint stream (1536, the single blocks' norm)
FLUX_K5_SHAPES = tuple(NormShape(tag, 2, S, 3072, "bfloat16", "bfloat16", False, False, False, True)
                       for tag, S in (("flux-img", 1024), ("flux-txt", 512), ("flux-joint", 1536)))
#: kernel launches of one FLUX.1-dev transformer forward (19 double + 38
#: single blocks): K3 once a block; K5 4 a double block, 1 a single block and
#: norm_out. A backward launches K2a/K2b once a block and K5's backward for
#: every K5 but block 0's first two, whose inputs (the embeddings, the
#: AdaLN vectors) are frozen.
FLUX_FORWARD = {"flash_fwd": 57, "ln_mul_add": 19 * 4 + 38 + 1}
#: one DPO grad step at num_train_timesteps 1 with remat: the two reference
#: forwards (no grad), the two θ forwards, each block recomputed once in the
#: two backwards (norm_out is outside the blocks, so not recomputed), the two
#: backwards
FLUX_DPO_A_STEP = {"flash_fwd": 6 * 57, "flash_bwd_dq": 2 * 57, "flash_bwd_dkv": 2 * 57,
                   "ln_mul_add": 4 * 115 + 2 * 114, "ln_mul_add_backward": 2 * 113}
#: peak device memory predicted for the [flux-dpo] phase, GiB (PERF.md §6)
FLUX_DPO_PEAK_PREDICTED = (62.0, 72.0)


def _k3_flux_call(B: int, H: int, S: int, D: int):
    """K3 on fresh contiguous bf16 inputs of a FLUX.1 joint-attention shape."""
    import torch

    from flow_factory_tpu_torch.ops import attention as A

    q, k, v = (torch.randn(B, H, S, D, device="cuda", dtype=torch.bfloat16) for _ in range(3))
    return functools.partial(A.flash_attention, q, k, v, D ** -0.5)


def phase_flux_kernels(results: dict) -> None:
    """[flux-kernels]: K3 at the FLUX.1 512 px joint attention (B H24 S1536
    D128: 512 text + 1024 image tokens, q/k contiguous as RoPE returns them,
    v the concatenation) at B = 2 (a grad step's forwards) and B = 8 (the
    rollout), K2a/K2b at B = 2 on K3's O and lse, and K5 with its backward at
    ``FLUX_K5_SHAPES``, each through the checks of its Wan and SD3.5 shapes
    (``_k3_shape_checks``, ``_k2_d128_shape_checks`` with the control
    without Delta, ``_k5_shape_checks`` with the backward controls). The
    entries join the table under the tags flux-512px-b2, flux-512px-b8,
    flux-512px, flux-img, flux-txt and flux-joint."""
    import torch

    from flow_factory_tpu_torch.ops import norms as N

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    randn = lambda *shape, dtype=torch.bfloat16: torch.randn(
        shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)
    H, S, D = 24, 1536, 128
    log(f"[flux-kernels] card (SM clock, max, power, temperature): {gpu_state()}")
    for tag, B in (("flux-512px-b2", 2), ("flux-512px-b8", 8)):
        q, k, v = (randn(B, H, S, D) for _ in range(3))
        _k3_shape_checks(results, tag, q, k, v, "q/k/v contiguous", functools.partial(_k3_flux_call, B, H, S, D))
        del q, k, v
    _k2_d128_shape_checks(results, "flux-512px", 2, H, S, S, True, randn)
    for shape in FLUX_K5_SHAPES:
        _k5_shape_checks(results, gen, shape, True)
    log(f"[flux-kernels] Triton kernels compiled so far (at D 3072: K5 8 warps, its backward 16): "
        f"{_triton_figures(N)}")


def _flux_ids(h: int, w: int, txt_len: int):
    import torch

    from flow_factory_tpu_torch.models.flux.adapter import Flux1Adapter

    img_ids = torch.from_numpy(Flux1Adapter.latent_image_ids(h, w)).cuda()
    return img_ids, torch.zeros(txt_len, 3, device="cuda")


def phase_flux_grad() -> None:
    """[flux-grad]: LoRA gradients through the kernels at FLUX.1-dev width,
    reduced depth: one double and one single block, B = 2, 1024 image + 512
    T5 tokens (512 px), guidance 3.5, rank-32 LoRA on the FLUX targets of the
    two blocks (the fused ``linear1``/``linear2`` included), ``lora_B`` drawn
    non-zero, checked by :func:`_lora_grad_check` (the dq-zeroed control
    must be rejected); a non-zero gradient on every leaf, and K3, K2a, K2b
    and K5 (and its backward) launched exactly as the two blocks predict."""
    import dataclasses

    import torch
    from torch.func import functional_call

    from flow_factory_tpu_torch.models.flux.adapter import FLUX_LORA_TARGETS
    from flow_factory_tpu_torch.models.flux.transformer import FluxConfig, FluxTransformer
    from flow_factory_tpu_torch.models.layers import build_module
    from flow_factory_tpu_torch.models.lora import init_lora

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    cfg = dataclasses.replace(FluxConfig.flux1_dev(), num_double_blocks=1, num_single_blocks=1)
    model = build_module(lambda: FluxTransformer(cfg), dev, torch.bfloat16, gen)
    lora = init_lora(model, 32, gen, FLUX_LORA_TARGETS)
    for ab in lora.values():  # b != 0, else the gradient of a is zero
        ab["lora_B"].data.normal_(0.0, 1e-2, generator=gen)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
    B = 2
    x = randn(B, 1024, cfg.in_channels)  # 32 x 32 packed tokens: 512 px
    ctx, pooled = randn(B, 512, cfg.context_dim), randn(B, cfg.pooled_dim)
    t, guidance = torch.full((B,), 750.0, device=dev), torch.full((B,), 3.5, device=dev)
    img_ids, txt_ids = _flux_ids(64, 64, 512)
    names, kern, _, counts = _lora_grad_check(
        f"FLUX.1-dev width, 1 double + 1 single block, B={B}, 1024 image + 512 text tokens", model, lora,
        lambda params: functional_call(model, params, (x, t, ctx, pooled, img_ids, txt_ids, guidance)), x, gen)
    dead = [n for n, g in zip(names, kern) if not g.abs().max().item() > 0]
    log(f"[flux-grad] non-zero gradient on {len(names) - len(dead)}/{len(names)} LoRA leaves (the fused linear1/"
        f"linear2 among them: {sum('linear' in n and 'single' in n for n in names)})")
    want = {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2, "ln_mul_add": 6, "ln_mul_add_backward": 4}
    if dead or any(counts[k] != n for k, n in want.items()):
        fail(f"[flux-grad]: LoRA leaves without gradient {dead}, or launches {counts} differ from {want}")
    del model, lora, kern
    torch.cuda.empty_cache()


def phase_flux_dpo() -> dict:
    """[flux-dpo]: FLUX.1-dev LoRA DPO at full width through ``load_trainer``
    on tests/fixtures/flux1_dpo.yaml (19 double + 38 single blocks, random
    bf16 weights from seed 42, rank-32 LoRA on the JAX FLUX targets, 512 px,
    10 steps, guidance 3.5, Flow-SDE η 0.8, 2 prompts x group 4, β 2000, one
    logit-normal timestep, AdamW 3e-4, EMA 0.99 every 4, remat on), two
    epochs phase by phase: each rollout finite with K3 and K5 launched as
    ``FLUX_FORWARD`` predicts per step, finite rewards, advantages and 2
    pairs; epoch 0's grad step at the zero LoRA with the implicit margin
    exactly 0.0 and the loss exactly −logsigmoid(0) in fp32 (θ is the
    reference, bit for bit); epoch 1's at the moved LoRA with another loss;
    a finite non-zero gradient norm, launches as ``FLUX_DPO_A_STEP``, peak
    memory against the prediction; then a profile of one grad step. Returns
    the launch counts of the two epochs."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.trainers import load_trainer

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = Arguments.load_from_yaml(os.path.join(here, "tests", "fixtures", "flux1_dpo.yaml"))
    cfg.data_args.cache_dir = os.path.join(here, "build", "preprocess_cache")
    cfg.log_args.save_dir = os.path.join(here, "chiprun_out", "train")
    ta = cfg.training_args
    log(f"[flux-dpo] device memory allocated before the FLUX.1 trainer loads: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = load_trainer(cfg)  # cuda
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    ad = trainer.adapter
    lora = ad.trainable["transformer"]
    sizes = {comp: sum(p.numel() for p in m.parameters()) for comp, m in ad.modules.items()}
    log(f"[flux-dpo] load_trainer (FLUX.1-dev, {sizes['transformer'] / 1e9:.3f} B transformer, T5-XXL "
        f"{sizes['text_encoder_2'] / 1e9:.3f} B, CLIP-L {sizes['text_encoder'] / 1e9:.3f} B, VAE "
        f"{sizes['vae'] / 1e9:.3f} B; LoRA rank {cfg.model_args.lora_rank} on {len(lora)} weights, "
        f"{sum(v.numel() for ab in lora.values() for v in ab.values()) / 1e6:.3f} M trainable; preprocess "
        f"included) {load_s:.1f} s; remat {ad.component_configs['transformer'].remat}; "
        f"gradient_accumulation_steps {ta.gradient_accumulation_steps}; allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    log2 = -F.logsigmoid(torch.zeros((), dtype=torch.float32)).item()
    b0 = {path: ab["lora_B"].detach().clone() for path, ab in lora.items()}
    ops.reset_launch_counts()
    samples = []
    for epoch in range(ta.max_epochs):
        trainer.epoch = epoch
        trainer.scheduler.set_seed(ta.seed + epoch)
        secs = {}
        before = ops.launch_counts()
        t0 = time.perf_counter()
        samples = trainer.sample(epoch)
        torch.cuda.synchronize()
        secs["sample"] = time.perf_counter() - t0
        in_sample = {k: v - before[k] for k, v in ops.launch_counts().items()}
        steps = ta.num_inference_steps * -(-len(samples) // ta.per_device_batch_size)
        want = {k: n * steps for k, n in FLUX_FORWARD.items()}
        images = np.stack([s.image for s in samples])
        finals = np.stack([s.all_latents for s in samples])
        t0 = time.perf_counter()
        metrics = trainer.prepare_feedback(samples)
        secs["feedback"] = time.perf_counter() - t0
        adv = np.asarray([s.extra_kwargs["advantage"] for s in samples])
        log(f"[flux-dpo] epoch {epoch} rollout: images {images.shape} in [{images.min():.3f}, {images.max():.3f}], "
            f"final latents {finals.shape}, reward mean {metrics['reward/mean']:.5f}, advantages "
            f"{np.round(adv, 4).tolist()}, launches {in_sample} (expected {want})")
        if not (images.shape == (8, 3, 512, 512) and finals.shape == (8, 1, 1024, 64) and np.isfinite(images).all()
                and np.isfinite(finals).all() and np.isfinite(adv).all() and np.isfinite(metrics["reward/mean"])):
            fail(f"[flux-dpo] epoch {epoch}: the rollout or its rewards are not as expected")
        if any(in_sample[k] != n for k, n in want.items()):
            fail(f"[flux-dpo] epoch {epoch}: rollout launches {in_sample}, expected {want}")
        before = ops.launch_counts()
        t0 = time.perf_counter()
        info = trainer.optimize(samples, epoch)
        torch.cuda.synchronize()
        secs["optimize"] = time.perf_counter() - t0
        in_optimize = {k: v - before[k] for k, v in ops.launch_counts().items()}
        ad.ema_step(epoch)
        grad_steps = ta.get_num_train_timesteps(cfg)
        want = {k: n * grad_steps for k, n in FLUX_DPO_A_STEP.items()}
        loss, margin, gnorm = info["train/loss"], info["train/implicit_margin"], info["train/grad_norm"]
        log(f"[flux-dpo] epoch {epoch}: {info['train/dpo_num_pairs']:.0f} pairs, {grad_steps} grad step(s), loss "
            f"{loss!r} (-logsigmoid(0) in fp32: {log2!r}), implicit margin {margin!r}, implicit acc "
            f"{info['train/implicit_acc']}, theta errs w {info['train/theta_w_err']:.6f} l "
            f"{info['train/theta_l_err']:.6f}, grad_norm {gnorm:.4e}, launches in optimize {in_optimize} "
            f"(expected {want})")
        log(f"[flux-dpo] epoch {epoch} phase seconds {json.dumps({k: round(v, 3) for k, v in secs.items()})} | "
            f"{secs['optimize'] / grad_steps:.3f} s per grad step (optimizer step included)")
        if info["train/dpo_num_pairs"] != 2.0 or not (np.isfinite(gnorm) and gnorm > 0):
            fail(f"[flux-dpo] epoch {epoch}: pairs {info['train/dpo_num_pairs']}, grad norm {gnorm}")
        if epoch == 0 and not (margin == 0.0 and loss == log2):
            fail(f"[flux-dpo] epoch 0 at the zero LoRA: margin {margin!r}, loss {loss!r}, expected 0.0 and {log2!r}")
        if epoch > 0 and not (np.isfinite(loss) and loss != log2):
            fail(f"[flux-dpo] epoch {epoch}: the loss {loss!r} did not move off -logsigmoid(0)")
        if any(in_optimize[k] != n for k, n in want.items()):
            fail(f"[flux-dpo] epoch {epoch}: launches in optimize {in_optimize}, expected {want}")
        if epoch == 0:
            moved = max((lora[p]["lora_B"] - b).abs().max().item() for p, b in b0.items())
            log(f"[flux-dpo] LoRA B after the first update: max|change| {moved:.3e}")
            if not moved > 0:
                fail("[flux-dpo] the LoRA did not move after the optimizer step")
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    lo, hi = FLUX_DPO_PEAK_PREDICTED
    log(f"[flux-dpo] launches over two epochs {counts} | peak memory {peak:.2f} GiB (predicted {lo:.0f}-{hi:.0f} "
        f"GiB: {'inside' if lo <= peak <= hi else 'outside'}) | global step {trainer.global_step}")
    if trainer.global_step != ta.max_epochs:
        fail(f"[flux-dpo] the optimizer did not step once per epoch: global step {trainer.global_step}")
    batch = next(trainer.grad_step_batches(samples, ta.max_epochs - 1))

    def grad_step():
        trainer.backward_step(batch, trainer.reference_trainable())
        trainer.apply_accumulated()

    _profile("one FLUX.1-dev DPO grad step (2 reference + 2 θ forwards, remat, 2 backwards, AdamW)", grad_step,
             "flux_dpo_grad_step_trace.json")
    trainer.cleanup()
    return counts


#: FLUX.1-Kontext at 512 px: 512 text + 1024 target + 1024 condition tokens
KONTEXT_S = 2560
KONTEXT_K5_SHAPES = tuple(NormShape(tag, 8, S, 3072, "bfloat16", "bfloat16", False, False, False, True)
                          for tag, S in (("kontext-img", 2048), ("kontext-txt", 512), ("kontext-joint", KONTEXT_S)))
#: the table's Kontext shapes of each kernel (their launches: the three Kontext phases')
KONTEXT_TAGS = {"flash_fwd": ("kontext-2560-b8", "kontext-padded", "kontext-ragged"),
                "flash_bwd_dq_d128": ("kontext-2560",), "flash_bwd_dkv_d128": ("kontext-2560",),
                "ln_mul_add": tuple(shape.tag for shape in KONTEXT_K5_SHAPES),
                "ln_mul_add_backward": tuple(shape.tag for shape in KONTEXT_K5_SHAPES)}
#: peak device memory predicted for each [kontext-*] phase at the depth of
#: tests/fixtures/flux1_kontext_cut (5 + 10 blocks), GiB (PERF.md §6)
KONTEXT_PEAK_PREDICTED = (23.0, 28.0)


def phase_kontext_kernels(results: dict) -> None:
    """[kontext-kernels]: K3, K2a/K2b and K5 at the FLUX.1-Kontext 512 px
    shapes, through the checks of their FLUX.1 shapes: K3 at B8 H24 S2560
    D128 (the rollout's and a grad step's batch of 8; 40 key tiles of 64),
    the same with the last 512 condition positions all one row in q, k and v
    (the projections of the zero tokens that pad a record with fewer
    references; ids −1 change only RoPE, which runs before the kernel), and
    B2 S2497 (a 496 px reference: 961 condition tokens, a ragged 1-key tail,
    with the padded-key control); K2a/K2b at B8 S2560 (with the control
    without Delta) and at the ragged S2497 (with the control without the
    tail); K5 and its backward at ``KONTEXT_K5_SHAPES``. The entries join the
    table under the ``KONTEXT_TAGS``."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    randn = lambda *shape, dtype=torch.bfloat16: torch.randn(
        shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)
    H, D = 24, 128
    log(f"[kontext-kernels] card (SM clock, max, power, temperature): {gpu_state()}")
    for tag, B, S in (("kontext-2560-b8", 8, KONTEXT_S), ("kontext-padded", 8, KONTEXT_S),
                      ("kontext-ragged", 2, KONTEXT_S - 63)):
        q, k, v = (randn(B, H, S, D) for _ in range(3))
        if tag == "kontext-padded":
            for t in (q, k, v):
                t[:, :, -512:] = t[:, :, -512:-511].clone()
        _k3_shape_checks(results, tag, q, k, v, "q/k/v contiguous", functools.partial(_k3_flux_call, B, H, S, D))
        del q, k, v
    _k2_d128_shape_checks(results, "kontext-2560", 8, H, KONTEXT_S, KONTEXT_S, True, randn)
    _k2_d128_shape_checks(results, "kontext-ragged", 2, H, KONTEXT_S - 63, KONTEXT_S - 63, False, randn)
    for shape in KONTEXT_K5_SHAPES:
        _k5_shape_checks(results, gen, shape, True)


def _kontext_dataset(root: str) -> str:
    """An editing dataset under build/: two records, each one instruction
    and one 512 px reference image made from seed 42 (smooth colour fields,
    bilinear from 8 x 8 random cells), as PNG files that the loader reads
    with PIL as the JAX loader does. One reference geometry for every record:
    with references of different counts or sizes in one micro-batch, F13
    (ROADMAP Queue 3: every row takes row 0's condition ids) would move the
    GRPO ratio off 1.0, and the ratio gate is to measure the kernels."""
    import numpy as np
    from PIL import Image

    path = os.path.join(root, "build", "kontext_data")
    os.makedirs(os.path.join(path, "assets"), exist_ok=True)
    rng = np.random.default_rng(42)
    prompts = ["turn the scene into a snowy winter evening", "repaint everything in warm autumn colours"]
    with open(os.path.join(path, "train.jsonl"), "w") as f:
        for i, prompt in enumerate(prompts):
            cells = Image.fromarray((rng.random((8, 8, 3)) * 255).astype(np.uint8))
            cells.resize((512, 512), Image.BILINEAR).save(os.path.join(path, "assets", f"ref_{i}.png"))
            f.write(json.dumps({"prompt": prompt, "images": [f"assets/ref_{i}.png"]}) + "\n")
    return path


def phase_kontext(trainer_type: str) -> dict:
    """[kontext-<trainer>]: FLUX.1-Kontext-dev LoRA image editing at full
    width through ``load_trainer`` on tests/fixtures/flux1_kontext_<trainer>.yaml
    (10 of 19 double and 19 of 38 single blocks, the depth of
    tests/fixtures/flux1_kontext_cut; random bf16 weights from seed 42, rank-32
    LoRA on the JAX FLUX targets, 512 px, 10 steps, guidance 3.5, Flow-SDE η
    0.8, 2 records x group 4 in one rollout batch of 8, AdamW 3e-4, EMA 0.99
    every 4, remat on; the optimizer once an epoch) on ``_kontext_dataset``,
    two epochs phase by phase. Each rollout: images (8, 3, 512, 512) finite,
    1024 condition tokens a row and a joint sequence of 2560, K3 and K5
    launched as ``_flux2_launches`` predicts a forward per step. Each grad step, recorded
    as it runs: GRPO's replay ratio min and max exactly 1.0 and clip_frac 0;
    NFT's positive and negative losses equal (at β 1 both are ‖x0(v)−x1‖²/w
    when v = v_old); AWM's weighted log-prob equal to the precomputed one bit
    for bit on every row (ratio exactly 1.0, clip_frac 0). A finite loss, a
    finite non-zero grad norm, the LoRA moved, launches in optimize as its
    rematted grad step (NFT and AWM: with one no-grad old-policy forward a
    grad step), peak memory against ``KONTEXT_PEAK_PREDICTED``; for
    GRPO a profile of one grad step. Returns the launch counts of the two
    epochs."""
    import numpy as np
    import torch

    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.trainers import awm, load_trainer

    tag = f"kontext-{trainer_type}"
    here = os.path.dirname(os.path.abspath(__file__))
    cfg = Arguments.load_from_yaml(os.path.join(here, "tests", "fixtures", f"flux1_kontext_{trainer_type}.yaml"))
    cfg.data_args.dataset_dir = _kontext_dataset(here)
    cfg.data_args.cache_dir = os.path.join(here, "build", "preprocess_cache")
    cfg.log_args.save_dir = os.path.join(here, "build", "train")
    ta = cfg.training_args
    log(f"[{tag}] two records, each one 512 px reference: one reference geometry for every record, so that F13 "
        f"(every row takes row 0's condition ids) cannot move a ratio; device memory allocated before the trainer "
        f"loads: {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = load_trainer(cfg)  # cuda
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    ad = trainer.adapter
    lora = ad.trainable["transformer"]
    tcfg = ad.component_configs["transformer"]
    forward, grad_step = _flux2_launches(tcfg.num_double_blocks, tcfg.num_single_blocks)
    if trainer_type in ("nft", "awm"):  # the old-policy forward, no grad, one a grad step
        grad_step = _add(grad_step, forward)
    log(f"[{tag}] load_trainer ({type(ad).__name__}, {type(trainer).__name__}; {tcfg.num_double_blocks} double + "
        f"{tcfg.num_single_blocks} single blocks at width {tcfg.hidden_dim}; LoRA rank {cfg.model_args.lora_rank} "
        f"on {len(lora)} weights; the VAE encode of the references and the prompt encode included) {load_s:.1f} s; "
        f"remat {tcfg.remat}; gradient_accumulation_steps "
        f"{ta.gradient_accumulation_steps}; allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    steps, lps = [], []
    loss_fn, real_wlp = trainer.loss_fn, awm.weighted_log_prob

    def recording_loss_fn(*args, **kwargs):
        loss, aux = loss_fn(*args, **kwargs)
        steps.append(dict(aux))
        return loss, aux

    def recording_wlp(*args):
        lp = real_wlp(*args)
        lps.append(lp.detach().clone())
        return lp

    trainer.loss_fn = recording_loss_fn
    awm.weighted_log_prob = recording_wlp
    b0 = {path: ab["lora_B"].detach().clone() for path, ab in lora.items()}
    ops.reset_launch_counts()
    try:
        for epoch in range(ta.max_epochs):
            trainer.epoch = epoch
            trainer.scheduler.set_seed(ta.seed + epoch)
            secs = {}
            before = ops.launch_counts()
            t0 = time.perf_counter()
            samples = trainer.sample(epoch)
            torch.cuda.synchronize()
            secs["sample"] = time.perf_counter() - t0
            in_sample = {k: v - before[k] for k, v in ops.launch_counts().items()}
            rollout_steps = ta.num_inference_steps * -(-len(samples) // ta.per_device_batch_size)
            want = {k: n * rollout_steps for k, n in forward.items()}
            images = np.stack([s.image for s in samples])
            cond = np.stack([s.extra_kwargs["cond_latents"] for s in samples])
            joint = samples[0].all_latents.shape[-2] + cond.shape[1] + samples[0].prompt_embeds.shape[0]
            t0 = time.perf_counter()
            metrics = trainer.prepare_feedback(samples)
            secs["feedback"] = time.perf_counter() - t0
            log(f"[{tag}] epoch {epoch} rollout: images {images.shape} in [{images.min():.3f}, {images.max():.3f}], "
                f"condition tokens {cond.shape}, joint length {joint}, reward mean {metrics['reward/mean']:.5f}, "
                f"launches {in_sample} (expected {want}), {len(samples) / secs['sample']:.3f} samples/s")
            if not (images.shape == (8, 3, 512, 512) and np.isfinite(images).all() and cond.shape[1] == 1024
                    and joint == KONTEXT_S and np.isfinite(cond).all() and np.isfinite(metrics["reward/mean"])):
                fail(f"[{tag}] epoch {epoch}: the rollout is not as expected")
            if any(in_sample[k] != n for k, n in want.items()):
                fail(f"[{tag}] epoch {epoch}: rollout launches {in_sample}, expected {want}")
            before, first, lp0 = ops.launch_counts(), len(steps), len(lps)
            t0 = time.perf_counter()
            info = trainer.optimize(samples, epoch)
            torch.cuda.synchronize()
            secs["optimize"] = time.perf_counter() - t0
            in_optimize = {k: v - before[k] for k, v in ops.launch_counts().items()}
            ad.ema_step(epoch)
            epoch_steps = [{k: float(v) for k, v in aux.items()} for aux in steps[first:]]
            grad_steps = len(epoch_steps)
            want = {k: n * grad_steps for k, n in grad_step.items()}
            gnorm = info["train/grad_norm"]
            if trainer_type == "grpo":
                lo, hi = min(a["train/ratio_min"] for a in epoch_steps), max(a["train/ratio_max"] for a in epoch_steps)
                held = lo == 1.0 and hi == 1.0 and all(a["train/clip_frac"] == 0.0 for a in epoch_steps)
                what = f"replay ratio min {lo!r} max {hi!r} over every row of every grad step, clip_frac 0: {held}"
            elif trainer_type == "nft":
                held = all(a["train/positive_loss"] == a["train/negative_loss"] for a in epoch_steps)
                what = (f"positive == negative loss on every grad step: {held} "
                        f"({[a['train/positive_loss'] for a in epoch_steps]})")
            else:
                # the precompute's T log-probs of a micro-batch, then its T grad steps'
                T = ta.get_num_train_timesteps(cfg)
                mb = lps[lp0:]
                ratios = torch.cat([torch.exp(new.double() - old.double()) for i in range(0, len(mb), 2 * T)
                                    for old, new in zip(mb[i:i + T], mb[i + T:i + 2 * T])])
                lo, hi = ratios.min().item(), ratios.max().item()
                held = (lo == 1.0 and hi == 1.0 and len(mb) == 2 * grad_steps
                        and all(a["train/ratio_mean"] == 1.0 and a["train/clip_frac"] == 0.0 for a in epoch_steps))
                what = (f"per-row ratio min {lo!r} max {hi!r} over {ratios.numel()} rows of every grad step, "
                        f"ratio_mean 1.0 and clip_frac 0 on every step: {held}; matching_lp "
                        f"{[round(a['train/matching_lp'], 6) for a in epoch_steps]}")
            log(f"[{tag}] epoch {epoch}: {grad_steps} grad steps, {what}; loss {info['train/loss']:.4e}, grad_norm "
                f"{gnorm:.4e}, launches in optimize {in_optimize} (expected {want}), global step {trainer.global_step}")
            log(f"[{tag}] epoch {epoch} phase seconds {json.dumps({k: round(v, 3) for k, v in secs.items()})} | "
                f"{secs['optimize'] / grad_steps:.3f} s per grad step (optimizer step included)")
            if not held:
                fail(f"[{tag}] epoch {epoch}: the current policy is not the sampling policy bit for bit: {epoch_steps}")
            if not (np.isfinite(gnorm) and gnorm > 0 and all(np.isfinite(a["train/loss"]) for a in epoch_steps)):
                fail(f"[{tag}] epoch {epoch}: grad norm {gnorm}, losses {epoch_steps}")
            if any(in_optimize[k] != n for k, n in want.items()):
                fail(f"[{tag}] epoch {epoch}: launches in optimize {in_optimize}, expected {want}")
            if epoch == 0:
                moved = max((lora[p]["lora_B"] - b).abs().max().item() for p, b in b0.items())
                log(f"[{tag}] LoRA B after the first update: max|change| {moved:.3e}")
                if not moved > 0:
                    fail(f"[{tag}] the LoRA did not move after the optimizer step")
    finally:
        awm.weighted_log_prob = real_wlp
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    lo, hi = KONTEXT_PEAK_PREDICTED
    log(f"[{tag}] launches over two epochs {counts} | peak memory {peak:.2f} GiB (predicted {lo:.0f}-{hi:.0f} GiB: "
        f"{'inside' if lo <= peak <= hi else 'outside'}) | global step {trainer.global_step}")
    if trainer.global_step != ta.max_epochs:
        fail(f"[{tag}] the optimizer did not step once per epoch: global step {trainer.global_step}")
    if trainer_type == "grpo":
        _profile_grad_step(trainer, "one FLUX.1-Kontext GRPO grad step (B 8, 2560 joint tokens, remat, AdamW)",
                           "kontext_grpo_grad_step_trace.json")
    trainer.cleanup()
    return counts


def _kontext_phases() -> dict:
    """The three [kontext-*] phases, each trainer freed before the next
    loads; the launch counts summed over them."""
    import torch

    total = collections.Counter()
    for trainer_type in ("grpo", "nft", "awm"):
        gc.collect()
        torch.cuda.empty_cache()
        total.update(phase_kontext(trainer_type))
    gc.collect()
    torch.cuda.empty_cache()
    return dict(total)


def kontext_only() -> int:
    """``--kontext``: the environment (the kernels' build), the Kontext
    kernel shapes and the three [kontext-*] phases alone."""
    import torch

    from flow_factory_tpu_torch.utils.base import use_full_fp32

    use_full_fp32()
    phase_environment()
    results: dict = {}
    phase_kontext_kernels(results)
    counts = _kontext_phases()
    log(f"[kontext] launches over the three phases {counts}; device memory still allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return 0


# ---------------------------------------------------------------------------
# DGPO on SD3.5-M and CRD on Wan2.1-1.3B: the kernels at their grad steps'
# B 8, and two epochs of each trainer
# ---------------------------------------------------------------------------

#: the B 8 shapes of the DGPO (SD3.5-M) and CRD (Wan2.1-1.3B) grad steps,
#: whose forwards and backward run without CFG: K1 and K2 D=64 at SD3.5-M's
#: joint and self attention; K3 and K2 D=128 at Wan's self and cross
#: attention; K5 at SD3.5-M's image and context norms and Wan's block norms
#: (norm2 the fold path), K6 at SD3.5-M's
DECOUPLED_K1_SHAPES = (("joint-b8", 8, 24, 1357, 64, "bfloat16", False, True),
                       ("self-b8", 8, 24, 1024, 64, "bfloat16", True, True))
DECOUPLED_WAN_ATTENTION = (("wan-self-b8", 8, 12, 512, 512), ("wan-cross-b8", 8, 12, 512, 512))
DECOUPLED_K5_SHAPES = tuple(NormShape(tag, 8, S, 1536, "bfloat16", "bfloat16", False, fold, False, True)
                            for tag, S, fold in (("image-b8", 1024, False), ("context-b8", 333, False),
                                                 ("wan-b8", 512, False), ("wan-norm2-b8", 512, True)))
DECOUPLED_K6_SHAPES = tuple(NormShape(tag, 8, S, 1536, "bfloat16", "bfloat16", False, False, False, True)
                            for tag, S in (("image-b8", 1024), ("context-b8", 333)))
#: the table's B 8 shapes of each kernel and the phase whose launches they take
DECOUPLED_TAGS = {
    "dgpo": {"qknorm_flash_fwd": ("joint-b8", "self-b8"), "flash_bwd_dq": ("joint-b8", "self-b8"),
             "flash_bwd_dkv": ("joint-b8", "self-b8"), "ln_mul_add": ("image-b8", "context-b8"),
             "ln_mul_add_backward": ("image-b8", "context-b8"),
             "residual_gate_modulate": ("image-b8", "context-b8"),
             "residual_gate_modulate_backward": ("image-b8", "context-b8")},
    "crd": {"flash_fwd": ("wan-self-b8", "wan-cross-b8"), "flash_bwd_dq_d128": ("wan-self-b8", "wan-cross-b8"),
            "flash_bwd_dkv_d128": ("wan-self-b8", "wan-cross-b8"), "ln_mul_add": ("wan-b8", "wan-norm2-b8"),
            "ln_mul_add_backward": ("wan-b8", "wan-norm2-b8")},
}
#: kernel launches of one SD3.5-M transformer forward and backward (24
#: joint + 13 dual self-attentions; the norms as ``SD35_NORMS_A_STEP``), and
#: of one Wan2.1-1.3B forward and backward (self + cross a block; 3 K5 a
#: block and the head, each with a backward but block 0's first)
SD35_FORWARD = {"qknorm_flash_fwd": 37, "ln_mul_add": 62, "residual_gate_modulate": 47}
SD35_BACKWARD = {"flash_bwd_dq": 37, "flash_bwd_dkv": 37, "ln_mul_add_backward": 59,
                 "residual_gate_modulate_backward": 47}
WAN_FORWARD = {"flash_fwd": 60, "ln_mul_add": 91}
WAN_BACKWARD = {"flash_bwd_dq": 60, "flash_bwd_dkv": 60, "ln_mul_add_backward": 90}
#: the two phases: fixture, the GRPO phase of the same family and the peak
#: memory it showed (GiB, on an H100 80GB HBM3 at 700 W; PERF.md), the exact
#: invariants of epoch 0's grad steps, each epoch's rollout policy
DECOUPLED_PHASES = {
    "dgpo": dict(tag="dgpo", fixture="sd35_dgpo", forward=SD35_FORWARD, backward=SD35_BACKWARD,
                 grpo_peak=("[train]", 48.91),
                 invariants={"train/pref_mean": 0.0, "train/group_weight_mean": 0.5, "train/kl": 0.0,
                             "train/clip_ratio": 0.0},
                 rollouts=[("live", None), ("ema_ref", False)]),
    "crd": dict(tag="crd-wan", fixture="wan21_crd", forward=WAN_FORWARD, backward=WAN_BACKWARD,
                grpo_peak=("[wan-train]", 41.25),
                invariants={"train/r_theta_mean": 0.0, "train/old_deviate": 0.0, "train/kl": 0.0},
                rollouts=[("_crd_sampling", True), ("_crd_sampling", True)]),
}


def phase_decoupled_kernels(results: dict) -> None:
    """[decoupled-kernels]: every kernel of the DGPO and CRD grad steps at
    their B 8 shapes, through the checks of its B 16 shapes: K1 and K2a/K2b
    D=64 (``_k1_shape_checks``, ``_k2_d64_shape_checks``), K3 and K2a/K2b
    D=128 (``_k3_shape_checks``, ``_k2_d128_shape_checks``: self q/k
    contiguous as RoPE returns them, v a view; cross q contiguous, k/v
    views), K5 and K6 with their backwards. The entries join the table under
    ``DECOUPLED_TAGS``."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    randn = lambda *shape, dtype=torch.bfloat16: torch.randn(
        shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)
    log(f"[decoupled-kernels] card (SM clock, max, power, temperature): {gpu_state()}")
    for shape in DECOUPLED_K1_SHAPES:
        _k1_shape_checks(results, randn, *shape)
        _k2_d64_shape_checks(results, randn, *shape)
    for tag, B, H, Sq, Sk in DECOUPLED_WAN_ATTENTION:
        cross = tag.startswith("wan-cross")
        heads = lambda S: randn(B, S, H, 128).transpose(1, 2)  # view of a (B, S, H*D) projection
        q, k, v = (randn(B, H, Sq, 128), heads(Sk), heads(Sk)) if cross else \
            (randn(B, H, Sq, 128), randn(B, H, Sk, 128), heads(Sk))
        _k3_shape_checks(results, tag, q, k, v, "q contiguous, k/v views" if cross else "q/k contiguous, v a view",
                         functools.partial(_k3_call, B, H, Sq, Sk, 128, True, 128 ** -0.5))
        del q, k, v
        _k2_d128_shape_checks(results, tag, B, H, Sq, Sk, True, randn)
    for shape in DECOUPLED_K5_SHAPES:
        _k5_shape_checks(results, gen, shape, False)
    for shape in DECOUPLED_K6_SHAPES:
        _k6_shape_checks(results, gen, shape, False)


def _policy_recorder(ad, snapshot: str, rollouts: list):
    """``ad.inference`` wrapped to append, per call, the policy it samples
    under: ("live", None) for the live tree, (``snapshot``, whether it equals
    the live tree bit for bit) for that named snapshot, ("other", None) else."""
    import torch

    inference = ad.inference

    def recording(*args, **kwargs):
        tr = kwargs.get("trainable")
        if tr is None or tr is ad.trainable:
            rollouts.append(("live", None))
        elif ad.has_named_parameters(snapshot) and tr is ad.get_named_parameters(snapshot):
            rollouts.append((snapshot, all(torch.equal(a, b) for a, b in
                                           zip(ad.trainable_leaves(tr), ad.trainable_leaves()))))
        else:
            rollouts.append(("other", None))
        return inference(*args, **kwargs)

    return recording


def _profile_decoupled_grad_step(trainer, what: str, trace: str) -> None:
    """One grad step with its share of the frozen forwards, on the first
    batch of the last epoch: DGPO's ``ema_ref`` and reference velocities at
    its timestep, CRD's old policy's (its reference runs in the loss, for the
    KL), each snapshot merged once before, as a micro-batch's T grad steps
    share the merge; then the θ forward, the backward and AdamW."""
    import torch

    from flow_factory_tpu_torch.trainers.decoupled import uncfg

    ad = trainer.adapter
    batch = next(trainer.grad_step_batches(trainer.reward_buffer.samples, trainer.training_args.max_epochs - 1))
    base = {k: v for k, v in batch.items() if k not in ("old_v", "ref_v")}
    dgpo = hasattr(trainer, "with_frozen_velocities")
    with torch.no_grad():
        old = (ad.merged_params(ad.velocity_component, ad.get_named_parameters(trainer.EMA_REF)) if dgpo
               else trainer.old_policy_params())

    @torch.no_grad()
    def frozen():
        if dgpo:
            return trainer.with_frozen_velocities(base, old)
        return {**base, "old_v": ad.training_velocity_tree(None, uncfg(trainer.noised_batch(base)), params=old)}

    ref = trainer.reference_trainable()

    def grad_step():
        trainer.backward_step(frozen(), ref)
        trainer.apply_accumulated()

    return _profile(what, grad_step, trace)


def phase_decoupled(trainer_type: str) -> dict:
    """[dgpo] / [crd-wan]: SD3.5-M LoRA DGPO on tests/fixtures/sd35_dgpo.yaml
    and Wan2.1-T2V-1.3B LoRA CRD on tests/fixtures/wan21_crd.yaml at full
    width through ``load_trainer`` (random bf16 weights from seed 42, rank-32
    LoRA, 2 prompts x group 4 in one rollout batch and one micro-batch of 8,
    4 train timesteps, the optimizer once an epoch after its 4 grad steps),
    two epochs phase by phase. Each rollout: finite images (8, 3, 512, 512)
    or videos (8, 5, 3, 256, 256), the forward's kernels launched 10 times
    (CFG: one B 16 forward a step), under the policy ``DECOUPLED_PHASES``
    names (DGPO: the live tree, then ``ema_ref``; CRD: ``_crd_sampling``,
    equal to θ by then). Each grad step, recorded as it runs: epoch 0's at θ
    = the snapshot = the zero LoRA = the reference, so the invariants hold
    exactly (DGPO pref_mean 0, group_weight_mean 0.5, kl 0, clip_ratio 0;
    CRD r_theta_mean 0, old_deviate 0, kl 0); every metric finite; launches
    in optimize three forwards (the snapshot's, the reference's, θ's) and a
    backward a grad step. A moved LoRA, the peak memory beside the GRPO
    phase's of the family, seconds a rollout and a grad step, and a profile
    of one grad step (idle share). Returns the launch counts of the two
    epochs."""
    import numpy as np
    import torch

    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.trainers import load_trainer

    spec = DECOUPLED_PHASES[trainer_type]
    tag = spec["tag"]
    here = os.path.dirname(os.path.abspath(__file__))
    cfg = Arguments.load_from_yaml(os.path.join(here, "tests", "fixtures", f"{spec['fixture']}.yaml"))
    cfg.data_args.cache_dir = os.path.join(here, "build", "preprocess_cache")
    cfg.log_args.save_dir = os.path.join(here, "build", "train")
    ta = cfg.training_args
    log(f"[{tag}] device memory allocated before the trainer loads: {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = load_trainer(cfg)  # cuda
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    ad = trainer.adapter
    lora = ad.trainable["transformer"]
    if ad.component_configs["transformer"].remat:
        fail(f"[{tag}] the launch counts below assume no remat")
    snapshot = spec["rollouts"][1][0]
    log(f"[{tag}] load_trainer ({type(ad).__name__}, {type(trainer).__name__}; LoRA rank {cfg.model_args.lora_rank} "
        f"on {len(lora)} weights, {sum(v.numel() for ab in lora.values() for v in ab.values()) / 1e6:.2f} M "
        f"trainable; preprocess included) {load_s:.1f} s; gradient_accumulation_steps "
        f"{ta.gradient_accumulation_steps}; allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    steps, rollouts, seconds = [], [], collections.defaultdict(list)
    loss_fn = trainer.loss_fn

    def recording_loss_fn(*args, **kwargs):
        loss, aux = loss_fn(*args, **kwargs)
        steps.append(dict(aux))
        return loss, aux

    trainer.loss_fn = recording_loss_fn
    ad.inference = _policy_recorder(ad, snapshot, rollouts)
    per_step = {k: 3 * spec["forward"].get(k, 0) + spec["backward"].get(k, 0)
                for k in {**spec["forward"], **spec["backward"]}}
    b0 = {path: ab["lora_B"].detach().clone() for path, ab in lora.items()}
    ops.reset_launch_counts()
    for epoch in range(ta.max_epochs):
        trainer.epoch = epoch
        trainer.scheduler.set_seed(ta.seed + epoch)
        secs = {}
        before = ops.launch_counts()
        t0 = time.perf_counter()
        samples = trainer.sample(epoch)
        torch.cuda.synchronize()
        secs["sample"] = time.perf_counter() - t0
        in_sample = {k: v - before[k] for k, v in ops.launch_counts().items()}
        want = {k: n * ta.num_inference_steps for k, n in spec["forward"].items()}
        media = np.stack([s.video if trainer_type == "crd" else s.image for s in samples])
        t0 = time.perf_counter()
        metrics = trainer.prepare_feedback(samples)
        secs["feedback"] = time.perf_counter() - t0
        log(f"[{tag}] epoch {epoch} rollout under {rollouts[-1]}: {media.shape} in [{media.min():.3f}, "
            f"{media.max():.3f}], reward mean {metrics['reward/mean']:.5f}, launches {in_sample} (expected {want}), "
            f"{len(samples) / secs['sample']:.3f} samples/s")
        shape = (8, 5, 3, 256, 256) if trainer_type == "crd" else (8, 3, 512, 512)
        if media.shape != shape or not np.isfinite(media).all() or not np.isfinite(metrics["reward/mean"]):
            fail(f"[{tag}] epoch {epoch}: the rollout is not as expected")
        if any(in_sample[k] != n for k, n in want.items()):
            fail(f"[{tag}] epoch {epoch}: rollout launches {in_sample}, expected {want}")
        if rollouts[-1] != spec["rollouts"][epoch]:
            fail(f"[{tag}] epoch {epoch}: the rollout ran under {rollouts[-1]}, expected {spec['rollouts'][epoch]}")
        before, first = ops.launch_counts(), len(steps)
        t0 = time.perf_counter()
        info = trainer.optimize(samples, epoch)
        torch.cuda.synchronize()
        secs["optimize"] = time.perf_counter() - t0
        in_optimize = {k: v - before[k] for k, v in ops.launch_counts().items()}
        ad.ema_step(epoch)
        epoch_steps = [{k: float(v) for k, v in aux.items()} for aux in steps[first:]]
        grad_steps = len(epoch_steps)
        want = {k: n * grad_steps for k, n in per_step.items()}
        gnorm = info["train/grad_norm"]
        shown = {k: [round(a[k], 6) for a in epoch_steps] for k in spec["invariants"]}
        log(f"[{tag}] epoch {epoch}: {grad_steps} grad steps, {shown}; loss {info['train/loss']:.4e}, grad_norm "
            f"{gnorm:.4e}, launches in optimize {in_optimize} (expected {want}), global step {trainer.global_step}")
        log(f"[{tag}] epoch {epoch} phase seconds {json.dumps({k: round(v, 3) for k, v in secs.items()})} | "
            f"{secs['optimize'] / grad_steps:.3f} s per grad step (its frozen forwards and the optimizer step "
            f"included)")
        seconds["rollout"].append(round(secs["sample"], 3))
        seconds["grad step"].append(round(secs["optimize"] / grad_steps, 3))
        if epoch == 0:
            first_step = {k: epoch_steps[0][k] for k in spec["invariants"]}
            log(f"[{tag}] epoch 0's first grad step at θ = the snapshot = the zero LoRA: {first_step} (expected "
                f"exactly {spec['invariants']})")
            if first_step != spec["invariants"]:
                fail(f"[{tag}] epoch 0's first grad step: {first_step}, expected exactly {spec['invariants']}")
        if not (grad_steps == ta.get_num_train_timesteps(cfg) and np.isfinite(gnorm) and gnorm > 0
                and all(np.isfinite(v) for a in epoch_steps for v in a.values())):
            fail(f"[{tag}] epoch {epoch}: grad norm {gnorm}, grad steps {epoch_steps}")
        if any(in_optimize[k] != n for k, n in want.items()):
            fail(f"[{tag}] epoch {epoch}: launches in optimize {in_optimize}, expected {want}")
        if epoch == 0:
            moved = max((lora[p]["lora_B"] - b).abs().max().item() for p, b in b0.items())
            log(f"[{tag}] LoRA B after the first update: max|change| {moved:.3e}")
            if not moved > 0:
                fail(f"[{tag}] the LoRA did not move after the optimizer step")
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    name, grpo_peak = spec["grpo_peak"]
    log(f"[{tag}] launches over two epochs {counts} | a grad step {per_step} | peak memory {peak:.2f} GiB (the "
        f"family's GRPO phase {name}: {grpo_peak} GiB) | global step {trainer.global_step}")
    if trainer.global_step != ta.max_epochs:
        fail(f"[{tag}] the optimizer did not step once per epoch: global step {trainer.global_step}")
    prof = _profile_decoupled_grad_step(trainer, f"one {tag} grad step with its frozen forwards (B 8, AdamW)",
                                        f"{tag.replace('-', '_')}_grad_step_trace.json")
    log(f"[{tag}] summary on {card_name()}: seconds a rollout {seconds['rollout']}, a grad step "
        f"{seconds['grad step']} (epochs 0, 1) | peak memory {peak:.2f} GiB | idle share of a profiled grad step "
        f"{1 - prof['busy_ms'] / prof['wall_ms']:.3f} | kernel launches of that grad step (all kernels) "
        f"{prof['launches']} | launches of the port's kernels a grad step {per_step}, over two epochs {counts}")
    trainer.cleanup()
    return counts


def _decoupled_phases() -> dict:
    """[dgpo] then [crd-wan], each trainer freed before the next loads:
    {trainer type: launch counts}."""
    import torch

    out = {}
    for trainer_type in DECOUPLED_PHASES:
        gc.collect()
        torch.cuda.empty_cache()
        out[trainer_type] = phase_decoupled(trainer_type)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def decoupled_only() -> int:
    """``--decoupled``: the environment (the kernels' build), the B 8 kernel
    shapes and the [dgpo] and [crd-wan] phases alone."""
    import torch

    from flow_factory_tpu_torch.utils.base import use_full_fp32

    use_full_fp32()
    phase_environment()
    phase_decoupled_kernels({})
    counts = _decoupled_phases()
    log(f"[decoupled] launches {counts}; device memory still allocated {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB")
    return 0


# ---------------------------------------------------------------------------
# LTX-2 joint audio-video: kernels at its shapes, the LoRA gradient, T2AV and
# I2AV GRPO at full width
# ---------------------------------------------------------------------------

#: the attentions of one LTX-2 block (tag, Sq, Sk) at 256 px x 9 frames (Lv
#: 2 x 8 x 8 = 128 video tokens, La 9 audio tokens, 512 text tokens), and at
#: 512 px x 97 frames (Lv 13 x 16 x 16 = 3328, La 94), the latter timed only
LTX2_LV, LTX2_LA, LTX2_LC, LTX2_LONG_LV, LTX2_LONG_LA = 128, 9, 512, 3328, 94
LTX2_ATTENTION = (("ltx2-video-self", 128, 128), ("ltx2-audio-self", 9, 9), ("ltx2-video-text", 128, 512),
                  ("ltx2-audio-text", 9, 512), ("ltx2-a2v", 128, 9), ("ltx2-v2a", 9, 128))
LTX2_LONG_ATTENTION = (("ltx2-97f-video-self", 3328, 3328), ("ltx2-97f-audio-self", 94, 94),
                       ("ltx2-97f-video-text", 3328, 512), ("ltx2-97f-audio-text", 94, 512),
                       ("ltx2-97f-a2v", 3328, 94), ("ltx2-97f-v2a", 94, 3328))
#: K5-RMS at width 2048: the block norms (bf16 -> bf16), the two heads (bf16
#: -> fp32), the I2AV video stream's per-token modulation (blocks and head)
LTX2_K5_SHAPES = tuple(NormShape(*shape) for shape in (
    ("ltx2-video", 16, 128, 2048, "bfloat16", "bfloat16", False, False, True, True),
    ("ltx2-audio", 16, 9, 2048, "bfloat16", "bfloat16", False, False, True, True),
    ("ltx2-video-head", 16, 128, 2048, "bfloat16", "float32", False, False, True, True),
    ("ltx2-audio-head", 16, 9, 2048, "bfloat16", "float32", False, False, True, True),
    ("ltx2-i2av-token", 16, 128, 2048, "bfloat16", "bfloat16", True, False, True, True),
    ("ltx2-i2av-token-head", 16, 128, 2048, "bfloat16", "float32", True, False, True, True),
    ("ltx2-97f-video", 16, 3328, 2048, "bfloat16", "bfloat16", False, False, True, True),
    ("ltx2-97f-audio", 16, 94, 2048, "bfloat16", "bfloat16", False, False, True, True),
))


def _k3_qk_contiguous_call(B: int, H: int, Sq: int, Sk: int):
    """K3 on fresh bf16 inputs in LTX-2's and Wan2.2's layout: q/k
    contiguous, v a view."""
    import torch

    from flow_factory_tpu_torch.ops import attention as A

    q, k = (torch.randn(B, H, S, 128, device="cuda", dtype=torch.bfloat16) for S in (Sq, Sk))
    v = torch.randn(B, Sk, H, 128, device="cuda", dtype=torch.bfloat16).transpose(1, 2)
    return functools.partial(A.flash_attention, q, k, v, 128 ** -0.5)


def phase_ltx2_kernels(results: dict) -> None:
    """[ltx2-kernels]: K3 and K2a/K2b at head dim 128 and K5-RMS with its
    backward at every LTX-2 shape of one block (B 16: 8 samples under CFG;
    16 heads), through the checks, controls, bits and times of
    ``_k3_shape_checks``, ``_k2_d128_shape_checks`` and ``_k5_shape_checks``
    (the K3 control that takes the zero-padded keys for real, the K2 control
    without the last key of a key run under one tile, the K5 control without
    the RMS term of dx); then the same kernels at one longer clip, 512 px x
    97 frames, timed. The entries join the table under their tags."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    randn = lambda *shape, dtype=torch.bfloat16: torch.randn(
        shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)
    log(f"[ltx2-kernels] card (SM clock, max, power, temperature): {gpu_state()}")
    B, H = 16, 16
    for tag, Sq, Sk in LTX2_ATTENTION + LTX2_LONG_ATTENTION:
        q, k = randn(B, H, Sq, 128), randn(B, H, Sk, 128)
        v = randn(B, Sk, H, 128).transpose(1, 2)  # a head-split view of the value projection
        _k3_shape_checks(results, tag, q, k, v, "q/k contiguous, v a view",
                         functools.partial(_k3_qk_contiguous_call, B, H, Sq, Sk))
        del q, k, v
        _k2_d128_shape_checks(results, tag, B, H, Sq, Sk, True, randn)
    for shape in LTX2_K5_SHAPES:
        _k5_shape_checks(results, gen, shape, shape.tag in ("ltx2-audio", "ltx2-video-head", "ltx2-i2av-token"))


def _ltx2_launches(num_layers: int):
    """Kernel launches of one LTX-2 forward, and of the backward of a loss
    on one stream or on both. Forward: 6 K3 a block; 4 K5-RMS a block and
    the two heads. Backward of both streams: K2a/K2b for every K3, K5's
    backward for every K5 but block 0's two self-attention norms (their
    input is ``proj_in``'s and ``audio_proj_in``'s frozen output). Backward
    of the video log-prob alone: besides, the last block's
    video_to_audio_attn, its audio FFN norm and the audio head feed only the
    audio velocity, so autograd runs no backward for them."""
    forward = {"flash_fwd": 6 * num_layers, "ln_mul_add": 4 * num_layers + 2}
    both = {"flash_bwd_dq": 6 * num_layers, "flash_bwd_dkv": 6 * num_layers, "ln_mul_add_backward": 4 * num_layers}
    video = {"flash_bwd_dq": 6 * num_layers - 1, "flash_bwd_dkv": 6 * num_layers - 1,
             "ln_mul_add_backward": 4 * num_layers - 2}
    return forward, both, video


#: peak device memory predicted for the LTX-2 GRPO phases (GiB; PERF.md §6)
LTX2_PEAK_PREDICTED = (47.0, 51.0)
#: the LTX-2 kernel tags of the table and the phases whose launches they take
LTX2_TAGS = {
    "flash_fwd": tuple(t for t, _, _ in LTX2_ATTENTION + LTX2_LONG_ATTENTION),
    "flash_bwd_dq_d128": tuple(t for t, _, _ in LTX2_ATTENTION + LTX2_LONG_ATTENTION),
    "flash_bwd_dkv_d128": tuple(t for t, _, _ in LTX2_ATTENTION + LTX2_LONG_ATTENTION),
    "ln_mul_add": tuple(s.tag for s in LTX2_K5_SHAPES),
    "ln_mul_add_backward": tuple(s.tag for s in LTX2_K5_SHAPES),
}


def phase_ltx2_grad() -> None:
    """[ltx2-grad]: LoRA gradients through K3, K2a/K2b and K5-RMS at LTX-2
    width, reduced depth: two dual-stream blocks, B 16 (the CFG batch), 128
    video + 9 audio + 512 text tokens, rank-32 LoRA on the 56 targets of the
    two blocks, ``lora_B`` drawn non-zero. The loss is the summed Flow-SDE
    log-prob of a transition of each stream (the video's and the audio's:
    so the last block's audio side has a path to it), checked by
    :func:`_lora_grad_check` against the plain path, with the dq-zeroed
    control and a K5 backward without the RMS term of dx (−x̂·mean(ĝ·x̂)),
    both of which must miss the bar; a non-zero gradient on every leaf; and
    the launches of one forward and backward of both streams."""
    import dataclasses

    import torch
    from torch.func import functional_call

    from flow_factory_tpu_torch.models.layers import build_module
    from flow_factory_tpu_torch.models.lora import init_lora
    from flow_factory_tpu_torch.models.ltx2.t2av import LTX2_LORA_TARGETS, LTX2T2AVAdapter
    from flow_factory_tpu_torch.models.ltx2.transformer import LTX2Config, LTX2Transformer

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    cfg = dataclasses.replace(LTX2Config.ltx2(), num_layers=2)
    model = build_module(lambda: LTX2Transformer(cfg), dev, torch.bfloat16, gen)
    lora = init_lora(model, 32, gen, LTX2_LORA_TARGETS)
    for ab in lora.values():  # b != 0, else the gradient of a is zero
        ab["lora_B"].data.normal_(0.0, 1e-2, generator=gen)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
    B = 16
    x = (randn(B, LTX2_LV, cfg.video_channels), randn(B, LTX2_LA, cfg.audio_channels))
    ctx = randn(B, LTX2_LC, cfg.context_dim)
    t = torch.full((B,), 750.0, device=dev)
    vid_ids = torch.as_tensor(LTX2T2AVAdapter._video_ids(2, 8, 8), device=dev)
    aud_ids = torch.as_tensor(LTX2T2AVAdapter._audio_ids(LTX2_LA, 2), device=dev)
    names, kern, _, counts = _lora_grad_check(
        f"LTX-2 width, depth 2, B={B}, {LTX2_LV} video + {LTX2_LA} audio + {LTX2_LC} text tokens", model, lora,
        lambda params: functional_call(model, params, (x[0].bfloat16(), x[1].bfloat16(), t, ctx, vid_ids, aud_ids)),
        x, gen, k5_rms_control=True)
    dead = [n for n, g in zip(names, kern) if not g.abs().max().item() > 0]
    log(f"[ltx2-grad] non-zero gradient on {len(names) - len(dead)}/{len(names)} LoRA leaves (six attentions and "
        f"two FFNs a block)")
    forward, backward, _ = _ltx2_launches(cfg.num_layers)
    want = {**forward, **backward}
    log(f"[ltx2-grad] launches of one forward and backward: {counts} (expected {want})")
    if dead or len(names) != 2 * 28 * cfg.num_layers or any(counts[k] != n for k, n in want.items()):
        fail(f"[ltx2-grad]: LoRA leaves without gradient {dead}, or launches {counts} differ from {want}")
    del model, lora, kern
    torch.cuda.empty_cache()


def _ltx2_load(fixture: str, tag: str, **data):
    import torch

    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.trainers import load_trainer

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = Arguments.load_from_yaml(os.path.join(here, "tests", "fixtures", fixture))
    cfg.data_args.cache_dir = os.path.join(here, "build", "preprocess_cache")
    for k, v in data.items():
        setattr(cfg.data_args, k, v)
    cfg.log_args.save_dir = os.path.join(here, "chiprun_out", "train")
    log(f"[{tag}] device memory allocated before the LTX-2 trainer loads: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = load_trainer(cfg)  # cuda
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    ad = trainer.adapter
    lora = ad.trainable["transformer"]
    sizes = {comp: sum(p.numel() for p in m.parameters()) / 1e9 for comp, m in ad.modules.items()}
    log(f"[{tag}] load_trainer ({cfg.model_args.model_type}, parameters in B {json.dumps(sizes)}; LoRA rank "
        f"{cfg.model_args.lora_rank} on {len(lora)} weights, "
        f"{sum(v.numel() for ab in lora.values() for v in ab.values()) / 1e6:.3f} M trainable; preprocess "
        f"included) {load_s:.1f} s; remat {ad.component_configs['transformer'].remat}; allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return cfg, trainer


def _ltx2_epoch(trainer, tag: str, epoch: int, forward: dict, backward: dict, check_rollout) -> dict:
    """:func:`_grpo_epoch` on LTX-2: besides, finite waveforms (B, 1, n)
    from every rollout, and the audio latents of its slot staged into every
    grad step."""
    import numpy as np

    def check(samples):
        waves = np.stack([s.audio for s in samples])
        log(f"[{tag}] epoch {epoch} waveforms {waves.shape} in [{waves.min():.3f}, {waves.max():.3f}], audio "
            f"latents {samples[0].extra_kwargs['audio_all_latents'].shape}")
        if not (np.isfinite(waves).all() and waves.shape[:2] == (len(samples), 1)):
            fail(f"[{tag}] epoch {epoch}: the rollout's waveforms are not as expected")
        check_rollout(samples)

    run = _grpo_epoch(trainer, tag, epoch, forward, backward, check, staged_keys=("audio_latents",))
    audio = (trainer.training_args.per_device_batch_size, *run["samples"][0].extra_kwargs["audio_all_latents"].shape[1:])
    if any(staged.get("audio_latents") != audio for _, _, staged in run["steps"]):
        fail(f"[{tag}] epoch {epoch}: the audio latents did not reach every training forward: {run['steps']}")
    return run


def phase_ltx2() -> dict:
    """[ltx2] and [ltx2-train]: LTX-2 T2AV GRPO at full width through
    ``load_trainer`` on tests/fixtures/ltx2_t2av_grpo.yaml (28 blocks, width
    2048; Gemma3-12B at 24 of its 48 layers (tests/fixtures/ltx2_cut), at
    512 tokens; random bf16 weights from seed 42; LoRA rank 32 on the 784
    default targets; 256 px x 9 frames: 128 video and 9
    audio tokens; 10 steps, CFG 3, Flow-SDE η 0.8 on the video stream, the
    audio ODE on its own grid; 2 prompts x group 4 in one batch), two epochs
    phase by phase: K3 and K5 launched as predicted in each rollout, finite
    videos and waveforms, in epoch 0 a no-grad replay of every stored
    transition with ratio exactly 1.0; per epoch 2 grad steps with the audio
    latents staged into each, ratio exactly 1.0, the launches predicted a
    grad step, a moved LoRA; peak memory against the prediction; a profile
    of one grad step. Returns the launch counts of the two epochs."""
    import numpy as np
    import torch

    from flow_factory_tpu_torch import ops

    cfg, trainer = _ltx2_load("ltx2_t2av_grpo.yaml", "ltx2")
    ad, ta = trainer.adapter, cfg.training_args
    forward, _, video = _ltx2_launches(ad.component_configs["transformer"].num_layers)
    lora = ad.trainable["transformer"]
    b0 = {path: ab["lora_B"].detach().clone() for path, ab in lora.items()}

    def replay_ratio(samples):
        before = ops.launch_counts()
        t0 = time.perf_counter()
        new = ad.replay_log_probs(samples)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        old = np.stack([s.log_probs for s in samples], axis=1)  # (stored slots, B)
        lp_map = samples[0].log_prob_index_map
        ratios = {i: np.exp(lp.cpu().numpy().astype(np.float64) - old[lp_map[i]]) for i, lp in new.items()}
        launched = {k: v - before[k] for k, v in ops.launch_counts().items()}
        ok = all(np.all(r == 1.0) for r in ratios.values())
        log(f"[ltx2] no-grad replay of the stored steps {sorted(new)} with the stored audio latents: ratio exactly "
            f"1.0 on {sum(np.all(r == 1.0) for r in ratios.values())}/{len(ratios)} steps, launches {launched}, "
            f"{secs:.2f} s")
        if not ok:
            fail(f"[ltx2] replay ratio not exactly 1.0: {ratios}")

    ops.reset_launch_counts()
    runs = []
    for epoch in range(ta.max_epochs):
        runs.append(_ltx2_epoch(trainer, "ltx2-train" if epoch else "ltx2", epoch, forward, video,
                                replay_ratio if epoch == 0 else (lambda samples: None)))
        if epoch == 0:
            moved = max((lora[p]["lora_B"] - b).abs().max().item() for p, b in b0.items())
            log(f"[ltx2-train] LoRA B after the first update: max|change| {moved:.3e}")
            if not moved > 0:
                fail("[ltx2-train] the LoRA did not move after the optimizer step")
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    lo, hi = LTX2_PEAK_PREDICTED
    log(f"[ltx2-train] launches over two epochs {counts} | peak memory {peak:.2f} GiB (predicted {lo:.0f}-{hi:.0f} "
        f"GiB: {'inside' if lo <= peak <= hi else 'outside'}) | seconds a rollout "
        f"{[round(r['secs']['rollout'], 2) for r in runs]}, a grad step "
        f"{[round(r['secs']['optimize'] / len(r['steps']), 3) for r in runs]} | global step {trainer.global_step}")
    if trainer.global_step != ta.max_epochs:
        fail(f"[ltx2-train] the optimizer did not step once per epoch: global step {trainer.global_step}")
    _profile_grad_step(trainer, "one LTX-2 T2AV grad step (LoRA merge, forward, backward, AdamW)",
                       "ltx2_grad_step_trace.json")
    trainer.cleanup()
    return counts


def _ltx2_i2av_dataset(root: str) -> str:
    """The first two records of dataset/sharegpt4o_image_mini under build/,
    their 64 px images resized (bilinear) to the 256 px geometry."""
    from PIL import Image

    src = os.path.join(root, "dataset", "sharegpt4o_image_mini")
    path = os.path.join(root, "build", "ltx2_i2av_data")
    os.makedirs(os.path.join(path, "assets"), exist_ok=True)
    with open(os.path.join(src, "train.jsonl")) as f:
        records = [json.loads(line) for line in f if line.strip()][:2]
    with open(os.path.join(path, "train.jsonl"), "w") as f:
        for rec in records:
            Image.open(os.path.join(src, rec["image"])).convert("RGB").resize((256, 256), Image.BILINEAR).save(
                os.path.join(path, rec["image"]))
            f.write(json.dumps(rec) + "\n")
    return path


def phase_ltx2_i2av() -> dict:
    """[ltx2-i2av]: LTX-2 I2AV GRPO at full width through ``load_trainer`` on
    tests/fixtures/ltx2_i2av_grpo.yaml (the geometry of [ltx2] on two
    records of dataset/sharegpt4o_image_mini at 256 px, group 4, one epoch):
    the 64 planted first-frame tokens equal bit for bit in every stored
    latent of every sample; the log-prob over the generated tokens only (a
    stored SDE step's log-prob equals ``sde_step``'s with the token mask and
    not without it, on the replayed velocity); K5 takes the per-token
    modulation (57 per-token calls a forward: the video stream's two norms a
    block and the video head); ratio exactly 1.0 on every grad step."""
    import torch

    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.ops import norms as N
    from flow_factory_tpu_torch.scheduler.flow_match_euler import sde_step

    here = os.path.dirname(os.path.abspath(__file__))
    cfg, trainer = _ltx2_load("ltx2_i2av_grpo.yaml", "ltx2-i2av", dataset_dir=_ltx2_i2av_dataset(here))
    ad = trainer.adapter
    L = ad.component_configs["transformer"].num_layers
    forward, _, video = _ltx2_launches(L)
    per_token = []
    real_k5 = N.ln_mul_add

    def k5_spy(x, mul, add, *args, **kwargs):
        per_token.append(mul.shape[1] != 1)
        return real_k5(x, mul, add, *args, **kwargs)

    k5_spy.launches = 0  # the kernel counts its launch on what stands in its name

    def check_rollout(samples):
        import numpy as np

        hw = int(samples[0].extra_kwargs["cond_mask"].sum())  # the first latent frame's tokens
        # every stored latent holds the planted tokens as the storage dtype rounds them
        st = lambda a: torch.from_numpy(a).to(ad.storage_dtype).float().numpy()
        bad = [i for i, s in enumerate(samples) for slot in range(s.all_latents.shape[0])
               if not np.array_equal(s.all_latents[slot, :hw], st(s.extra_kwargs["cond_tokens"][:hw]))]
        s0 = samples
        first = s0[0]
        step = int(np.asarray(trainer.scheduler.train_timesteps)[0])  # an SDE step with a stored log-prob
        li, lni = int(first.latent_index_map[step]), int(first.latent_index_map[step + 1])
        dev = ad.device
        stack = lambda key: torch.from_numpy(np.stack([getattr(s, key) for s in s0])).to(dev)
        embeds = {k: stack(k) for k in ad.embed_keys}
        lat = torch.from_numpy(np.stack([s.all_latents for s in s0])).to(dev)
        embeds["audio_latents"] = torch.from_numpy(
            np.stack([s.extra_kwargs["audio_all_latents"] for s in s0])[:, li]).to(dev)
        full = lambda v: torch.full((len(s0),), float(v), device=dev)
        sig = first.extra_kwargs["sigmas"]
        N.ln_mul_add = k5_spy
        try:
            with torch.no_grad():
                v = ad._velocity(lat[:, li].contiguous(), full(first.timesteps[step]), embeds,
                                 float(first.extra_kwargs["guidance_scale"]), True, ad.merged_params("transformer"))
        finally:
            N.ln_mul_add = real_k5
        step_kw = dict(noise_level=full(first.extra_kwargs["noise_levels"][step]), next_latents=lat[:, lni],
                       storage_dtype=ad.storage_dtype, sigma_max=full(sig[1]))
        masked = sde_step(v, lat[:, li], full(sig[step]), full(sig[step + 1]), token_mask=ad.token_mask(embeds),
                          **step_kw).log_prob.cpu().numpy()
        whole = sde_step(v, lat[:, li], full(sig[step]), full(sig[step + 1]), **step_kw).log_prob.cpu().numpy()
        stored = np.asarray([s.log_probs[s.log_prob_index_map[step]] for s in s0])
        n_tok = sum(per_token)
        log(f"[ltx2-i2av] planted first-frame tokens ({hw} of {first.all_latents.shape[1]}) equal bit for bit in "
            f"every stored latent of every sample: {not bad}; step {step}: stored log-prob equals the masked "
            f"sde_step's {np.array_equal(masked, stored)}, the unmasked one's {np.array_equal(whole, stored)}; "
            f"K5 calls with a per-token modulation in one forward: {n_tok} of {len(per_token)}")
        if bad or not np.array_equal(masked, stored) or np.array_equal(whole, stored):
            fail(f"[ltx2-i2av] planted tokens moved in {bad} or the log-prob counts them")
        if n_tok != 2 * L + 1:
            fail(f"[ltx2-i2av] K5 took the per-token modulation {n_tok} times, expected {2 * L + 1}")

    ops.reset_launch_counts()
    run = _ltx2_epoch(trainer, "ltx2-i2av", 0, forward, video, check_rollout)
    counts = ops.launch_counts()
    log(f"[ltx2-i2av] launches {counts} | peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | "
        f"seconds {json.dumps({k: round(v, 3) for k, v in run['secs'].items()})}")
    trainer.cleanup()
    return counts


def _ltx2_phases() -> dict:
    """[ltx2-grad], [ltx2]/[ltx2-train] and [ltx2-i2av], each trainer freed
    before the next loads; returns the launch counts of the T2AV epochs."""
    import torch

    phase_ltx2_grad()
    counts = phase_ltx2()
    gc.collect()
    torch.cuda.empty_cache()
    phase_ltx2_i2av()
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def ltx2_only() -> int:
    """``python3 chip_smoke.py --ltx2``: the build, [ltx2-kernels] and the
    LTX-2 phases alone."""
    import torch

    from flow_factory_tpu_torch.utils.base import use_full_fp32

    use_full_fp32()
    phase_environment()
    phase_ltx2_kernels({})
    counts = _ltx2_phases()
    log(f"[ltx2] launches {counts}; device memory still allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return 0


# ---------------------------------------------------------------------------
# The rest of Wan: Wan2.2-TI2V-5B at full size, the Wan2.2-A14B two-expert
# MoE at full width, channel-concat I2V and V2V
# ---------------------------------------------------------------------------

#: the attentions of the Wan2.2 models at B 16 (8 samples under CFG), head
#: dim 128 (tag, heads, Sq, Sk): the A14B (40 heads) at 256 px x 5 frames
#: (2 x 16 x 16 = 512 tokens) and TI2V-5B (24 heads) at 256 px x 17 frames
#: (5 x 8 x 8 = 320 tokens, not a multiple of K3's 128-row q tile), each
#: self and to the 512 UMT5 tokens
WAN22_ATTENTION = (("wan22-a14b-self", 40, 512, 512), ("wan22-a14b-cross", 40, 512, 512),
                   ("wan22-ti2v-self", 24, 320, 320), ("wan22-ti2v-cross", 24, 320, 512))
#: K5 at the A14B width (D 5120: an 8192 block, 37.5% of its lanes masked)
#: on its block norms, norm2 (fold) and head (bf16 -> fp32), and K5's
#: LayerNorm with TI2V's per-token modulation at width 3072 (the blocks at B
#: 16 and B 8, the head), with its per-sample norm2
WAN22_K5_SHAPES = tuple(NormShape(*shape) for shape in (
    ("wan22-a14b", 16, 512, 5120, "bfloat16", "bfloat16", False, False, False, True),
    ("wan22-a14b-norm2", 16, 512, 5120, "bfloat16", "bfloat16", False, True, False, True),
    ("wan22-a14b-head", 16, 512, 5120, "bfloat16", "float32", False, False, False, False),
    ("wan22-ti2v-token", 16, 320, 3072, "bfloat16", "bfloat16", True, False, False, True),
    ("wan22-ti2v-token-b8", 8, 320, 3072, "bfloat16", "bfloat16", True, False, False, True),
    ("wan22-ti2v-token-head", 16, 320, 3072, "bfloat16", "float32", True, False, False, True),
    ("wan22-ti2v-norm2", 16, 320, 3072, "bfloat16", "bfloat16", False, True, False, True),
))
#: the Wan2.2 kernel tags of the table and the phase whose launches they take
WAN22_TAGS = {
    "wan22-moe": {"flash_fwd": ("wan22-a14b-self", "wan22-a14b-cross"),
                  "flash_bwd_dq_d128": ("wan22-a14b-self", "wan22-a14b-cross"),
                  "flash_bwd_dkv_d128": ("wan22-a14b-self", "wan22-a14b-cross"),
                  "ln_mul_add": ("wan22-a14b", "wan22-a14b-norm2"),
                  "ln_mul_add_backward": ("wan22-a14b", "wan22-a14b-norm2")},
    "wan22-ti2v": {"flash_fwd": ("wan22-ti2v-self", "wan22-ti2v-cross"),
                   "flash_bwd_dq_d128": ("wan22-ti2v-self", "wan22-ti2v-cross"),
                   "flash_bwd_dkv_d128": ("wan22-ti2v-self", "wan22-ti2v-cross"),
                   "ln_mul_add": ("wan22-ti2v-token", "wan22-ti2v-token-b8", "wan22-ti2v-token-head",
                                  "wan22-ti2v-norm2"),
                   "ln_mul_add_backward": ("wan22-ti2v-token", "wan22-ti2v-token-b8", "wan22-ti2v-token-head",
                                           "wan22-ti2v-norm2")},
}
#: peak device memory predicted for the Wan2.2 and V2V trainers (GiB; PERF.md §6)
WAN22_PEAK_PREDICTED = {"wan22-ti2v": (35.0, 50.0), "wan22-moe": (33.0, 41.0), "wan-v2v": (35.0, 45.0)}


def phase_wan22_kernels(results: dict) -> None:
    """[wan22-kernels]: K3 and K2a/K2b at head dim 128 at the A14B's and
    TI2V-5B's attentions (``WAN22_ATTENTION``), and K5 with its backward at
    width 5120 and with the per-token modulation at width 3072
    (``WAN22_K5_SHAPES``), through the checks, controls, bits and times of
    ``_k3_shape_checks`` (the control without log2(e)),
    ``_k2_d128_shape_checks`` (the control without Delta on the self shapes)
    and ``_k5_shape_checks`` (the backward's controls on the A14B block norm
    and the per-token block norm). The entries join the table under their
    tags."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    randn = lambda *shape, dtype=torch.bfloat16: torch.randn(
        shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)
    log(f"[wan22-kernels] card (SM clock, max, power, temperature): {gpu_state()}")
    t0 = time.perf_counter()
    B = 16
    for tag, H, Sq, Sk in WAN22_ATTENTION:
        q, k = randn(B, H, Sq, 128), randn(B, H, Sk, 128)
        v = randn(B, Sk, H, 128).transpose(1, 2)  # a head-split view of the value projection
        _k3_shape_checks(results, tag, q, k, v, "q/k contiguous, v a view",
                         functools.partial(_k3_qk_contiguous_call, B, H, Sq, Sk))
        del q, k, v
        _k2_d128_shape_checks(results, tag, B, H, Sq, Sk, True, randn)
    for shape in WAN22_K5_SHAPES:
        _k5_shape_checks(results, gen, shape, shape.tag in ("wan22-a14b", "wan22-ti2v-token"))
    log(f"[wan22-kernels] every shape within its tolerance, the controls rejected: "
        f"{len(WAN22_ATTENTION)} attentions, {len(WAN22_K5_SHAPES)} K5 shapes, {time.perf_counter() - t0:.1f} s")


def _wan_launches(num_layers: int):
    """Kernel launches of one Wan DiT forward and of its backward: 2 K3 a
    block (self, cross) and 3 K5 a block (two AdaLN norms, norm2) plus the
    head; K2a/K2b for every K3, K5's backward for every K5 but block 0's
    first norm (its inputs, the patch embedding and the AdaLN vectors, are
    frozen)."""
    forward = {"flash_fwd": 2 * num_layers, "ln_mul_add": 3 * num_layers + 1}
    backward = {"flash_bwd_dq": 2 * num_layers, "flash_bwd_dkv": 2 * num_layers,
                "ln_mul_add_backward": 3 * num_layers}
    return forward, backward


def phase_wan22_grad() -> None:
    """[wan22-grad]: LoRA gradients through K3, K2a/K2b and K5 at the A14B
    width (5120, 40 heads of 128, FFN 13824), depth 2, B 16, 512 video + 512
    context tokens, rank-32 LoRA on the 20 Wan targets of the two blocks,
    ``lora_B`` drawn non-zero. The loss sums the Flow-SDE log-probs of two
    transitions: one at a per-sample t and one at per-frame t with frame 0
    at 0 (TI2V's form: every AdaLN modulation per token). Checked by
    :func:`_lora_grad_check` against the plain path with the dq-zeroed
    control; a non-zero gradient on every leaf; the launches of two forwards
    and their backward."""
    import dataclasses

    import torch
    from torch.func import functional_call

    from flow_factory_tpu_torch.models.layers import build_module
    from flow_factory_tpu_torch.models.lora import init_lora
    from flow_factory_tpu_torch.models.wan.t2v import WAN_LORA_TARGETS
    from flow_factory_tpu_torch.models.wan.transformer import WanConfig, WanTransformer

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    cfg = dataclasses.replace(WanConfig.wan21_14b(), num_layers=2)
    model = build_module(lambda: WanTransformer(cfg), dev, torch.bfloat16, gen)
    lora = init_lora(model, 32, gen, WAN_LORA_TARGETS)
    for ab in lora.values():  # b != 0, else the gradient of a is zero
        ab["lora_B"].data.normal_(0.0, 1e-2, generator=gen)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
    B = 16
    x = (randn(B, 2, 32, 32, cfg.in_channels), randn(B, 2, 32, 32, cfg.in_channels))  # 2 frames of 16 x 16 tokens
    ctx = randn(B, 512, cfg.context_dim)
    t = torch.full((B,), 750.0, device=dev)
    t_frames = torch.tensor([0.0, 750.0], device=dev).expand(B, 2).contiguous()
    names, kern, _, counts = _lora_grad_check(
        f"Wan2.2-A14B width, depth 2, B={B}, 512 video + 512 context tokens, per-sample and per-frame t", model,
        lora, lambda params: (functional_call(model, params, (x[0], t, ctx)),
                              functional_call(model, params, (x[1], t_frames, ctx))), x, gen)
    dead = [n for n, g in zip(names, kern) if not g.abs().max().item() > 0]
    forward, backward = _wan_launches(cfg.num_layers)
    want = {k: 2 * n for k, n in {**forward, **backward}.items()}
    log(f"[wan22-grad] non-zero gradient on {len(names) - len(dead)}/{len(names)} LoRA leaves; launches of two "
        f"forwards and their backward {counts} (expected {want})")
    if dead or len(names) != 2 * 10 * cfg.num_layers or any(counts[k] != n for k, n in want.items()):
        fail(f"[wan22-grad]: LoRA leaves without gradient {dead}, or launches {counts} differ from {want}")
    del model, lora, kern
    torch.cuda.empty_cache()


def _wan22_image_dataset(root: str, name: str, size: int) -> str:
    """The first two records of dataset/sharegpt4o_image_mini under build/,
    their 64 px images resized (bilinear) to ``size`` px."""
    from PIL import Image

    src = os.path.join(root, "dataset", "sharegpt4o_image_mini")
    path = os.path.join(root, "build", name)
    os.makedirs(os.path.join(path, "assets"), exist_ok=True)
    with open(os.path.join(src, "train.jsonl")) as f:
        records = [json.loads(line) for line in f if line.strip()][:2]
    with open(os.path.join(path, "train.jsonl"), "w") as f:
        for rec in records:
            Image.open(os.path.join(src, rec["image"])).convert("RGB").resize((size, size), Image.BILINEAR).save(
                os.path.join(path, rec["image"]))
            f.write(json.dumps(rec) + "\n")
    return path


def _wan22_config(fixture: str, model_type=None, **data):
    from flow_factory_tpu_torch.hparams import Arguments

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = Arguments.load_from_yaml(os.path.join(here, "tests", "fixtures", fixture))
    cfg.data_args.cache_dir = os.path.join(here, "build", "preprocess_cache")
    for k, v in data.items():
        setattr(cfg.data_args, k, v)
    if model_type:
        cfg.model_args.model_type = model_type
    cfg.log_args.save_dir = os.path.join(here, "chiprun_out", "train")
    return cfg


def _wan22_sizes(tag: str, ad, load_s: float) -> None:
    import torch

    tcfg = ad.component_configs["transformer"]
    lora = ad.trainable
    sizes = {comp: round(sum(p.numel() for p in m.parameters()) / 1e9, 3) for comp, m in ad.modules.items()}
    layers = getattr(tcfg, "num_layers", None) or getattr(tcfg, "num_double_blocks", None)
    log(f"[{tag}] loaded {ad.model_args.model_type} (variant {ad.model_args.variant}): width {tcfg.hidden_dim}, "
        f"{tcfg.num_heads} heads, {layers} layers, in_channels {tcfg.in_channels}; parameters in B "
        f"{json.dumps(sizes)}; LoRA rank {ad.model_args.lora_rank} on "
        f"{json.dumps({c: len(t) for c, t in lora.items()})} weights, "
        f"{sum(v.numel() for t in lora.values() for ab in t.values() for v in ab.values()) / 1e6:.3f} M trainable "
        f"(preprocess included) {load_s:.1f} s; allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")


def _wan22_load_trainer(tag: str, cfg):
    import torch

    from flow_factory_tpu_torch.trainers import load_trainer

    log(f"[{tag}] allocated before the trainer loads {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = load_trainer(cfg)  # cuda
    torch.cuda.synchronize()
    _wan22_sizes(tag, trainer.adapter, time.perf_counter() - t0)
    return trainer


def _replay_check(tag: str, ad, samples, want: dict) -> dict:
    """A no-grad replay of every stored step: ratio exactly 1.0 on each,
    the launches ``want`` (per replayed step) and the seconds."""
    import numpy as np
    import torch

    from flow_factory_tpu_torch import ops

    before = ops.launch_counts()
    t0 = time.perf_counter()
    new = ad.replay_log_probs(samples)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    old = np.stack([s.log_probs for s in samples], axis=1)
    lp_map = samples[0].log_prob_index_map
    ones = sum(bool(np.all(np.exp(lp.cpu().numpy().astype(np.float64) - old[lp_map[i]]) == 1.0))
               for i, lp in new.items())
    launched = {k: v - before[k] for k, v in ops.launch_counts().items()}
    expected = {k: n * len(new) for k, n in want.items()}
    log(f"[{tag}] no-grad replay of the stored steps {sorted(new)}: ratio exactly 1.0 on {ones}/{len(new)}, "
        f"launches {launched} (expected {expected}), {secs:.2f} s")
    if ones != len(new) or not new:
        fail(f"[{tag}] replay ratio not exactly 1.0 on every stored step")
    if any(launched[k] != n for k, n in expected.items()):
        fail(f"[{tag}] replay launches {launched}, expected {expected}")
    return launched


def _route_recorder(ad, routes: list):
    """Record each rollout step's expert (True: the high-noise one) as the
    adapter picks it; returns the undo."""
    real = ad.step_params

    def spy(params, t_host):
        out = real(params, t_host)
        if ad.mode == "rollout":
            routes.append((None if t_host is None else float(t_host), getattr(out, "high", None)))
        return out

    ad.step_params = spy
    return lambda: delattr(ad, "step_params")


def _grad_recorder(trainer, steps: list, staged_keys=()):
    """Record each grad step (``trainer.backward_step``, which adds its
    gradient into the leaves' ``.grad``): its host timestep, each trainable
    component's change in the summed L1 norms of its ``.grad`` over the step
    as a device scalar (fused norms, no host sync inside the timed steps;
    :func:`_live_components` reads them after), and the shapes of the
    batch's ``staged_keys``; returns the undo."""
    import torch

    real, ad = trainer.backward_step, trainer.adapter

    def l1(comp):
        grads = [p.grad for p in ad.trainable_leaves({comp: ad.trainable[comp]}) if p.grad is not None]
        if not grads:
            return torch.zeros((), device=ad.device)
        return torch.stack(torch._foreach_norm(grads, 1)).sum()

    def spy(batch, ref_trainable=None):
        before = {comp: l1(comp) for comp in sorted(ad.trainable)}
        out = real(batch, ref_trainable)
        changes = {comp: (l1(comp) - norm).abs() for comp, norm in before.items()}
        staged = {k: tuple(batch[k].shape) for k in staged_keys if batch.get(k) is not None}
        steps.append((float(batch["timestep_host"]), changes, staged))
        return out

    trainer.backward_step = spy
    return lambda: delattr(trainer, "backward_step")


def _live_components(steps: list) -> None:
    """Replace each recorded step's device scalars by the sorted components
    whose gradient the step reached (one host read of each)."""
    for i, (t, peaks, staged) in enumerate(steps):
        steps[i] = (t, [c for c, v in sorted(peaks.items()) if v.item() > 0], staged)


def _grpo_epoch(trainer, tag: str, epoch: int, forward: dict, backward: dict, check_rollout=None,
                staged_keys=(), sample=None, grad_step=None) -> dict:
    """One GRPO epoch phase by phase: the rollout (``trainer.sample``, or
    ``sample(epoch)`` where the caller draws it; finite videos or images,
    ``forward`` launches a step, ``check_rollout(samples)``), the feedback,
    the optimize phase with each grad step recorded by
    :func:`_grad_recorder`, the ratio exactly 1.0 and clip_frac 0 on every
    grad step, ``forward`` and ``backward`` launches a grad step (or
    ``grad_step``'s: a rematted forward's blocks run twice); the seconds of
    each."""
    import numpy as np
    import torch

    from flow_factory_tpu_torch import ops

    ta = trainer.training_args
    trainer.epoch = epoch
    trainer.scheduler.set_seed(ta.seed + epoch)
    secs = {}
    before = ops.launch_counts()
    t0 = time.perf_counter()
    samples = (sample or trainer.sample)(epoch)
    torch.cuda.synchronize()
    secs["rollout"] = time.perf_counter() - t0
    in_sample = {k: v - before[k] for k, v in ops.launch_counts().items()}
    batches = -(-len(samples) // ta.per_device_batch_size)
    want = {k: n * ta.num_inference_steps * batches for k, n in forward.items()}
    media = np.stack([s.video if s.video is not None else s.image for s in samples])
    kind = "videos" if samples[0].video is not None else "images"
    log(f"[{tag}] epoch {epoch} rollout: {kind} {media.shape} in [{media.min():.3f}, {media.max():.3f}], "
        f"latents {samples[0].all_latents.shape}, launches {in_sample} (expected {want}), {secs['rollout']:.2f} s")
    if not (np.isfinite(media).all() and media.shape[-3:] == (3, ta.height, ta.width)):
        fail(f"[{tag}] epoch {epoch}: the rollout's {kind} are not as expected: {media.shape}")
    if any(in_sample[k] != n for k, n in want.items()):
        fail(f"[{tag}] epoch {epoch}: rollout launches {in_sample}, expected {want}")
    if check_rollout is not None:
        check_rollout(samples)
    t0 = time.perf_counter()
    metrics = trainer.prepare_feedback(samples)
    secs["feedback"] = time.perf_counter() - t0
    steps: list = []
    undo = _grad_recorder(trainer, steps, staged_keys)
    before = ops.launch_counts()
    t0 = time.perf_counter()
    try:
        info = trainer.optimize(samples, epoch)
        torch.cuda.synchronize()
    finally:
        undo()
    secs["optimize"] = time.perf_counter() - t0
    _live_components(steps)
    in_optimize = {k: v - before[k] for k, v in ops.launch_counts().items()}
    ad = trainer.adapter
    ad.ema_step(epoch)
    want = {k: n * len(steps) for k, n in (grad_step or {**forward, **backward}).items()}
    ratio_lo, ratio_hi = _loss_value(info, "train/ratio_min", "min"), _loss_value(info, "train/ratio_max", "max")
    clip_hi, gnorm = _loss_value(info, "train/clip_frac", "max"), info["train/grad_norm"]
    log(f"[{tag}] epoch {epoch}: reward mean {metrics['reward/mean']:.5f}, {len(steps)} grad steps (host t, "
        f"components the step's gradient reached, staged shapes): {steps}, ratio min {ratio_lo!r} max "
        f"{ratio_hi!r} on every grad step, clip_frac max {clip_hi}, loss {info['train/loss']:.4e}, grad_norm "
        f"{gnorm:.4e}, launches in optimize {in_optimize} (expected {want}), global step {trainer.global_step}")
    log(f"[{tag}] epoch {epoch} phase seconds {json.dumps({k: round(v, 3) for k, v in secs.items()})} | "
        f"{secs['optimize'] / max(len(steps), 1):.3f} s per grad step (optimizer step included)")
    if not (steps and ratio_lo == 1.0 and ratio_hi == 1.0 and clip_hi == 0.0):
        fail(f"[{tag}] epoch {epoch}: replay ratio not exactly 1.0 on every grad step: {info}")
    if not (np.isfinite(gnorm) and gnorm > 0 and np.isfinite(info["train/loss"])):
        fail(f"[{tag}] epoch {epoch}: grad norm {gnorm}, loss {info['train/loss']}")
    if any(in_optimize[k] != n for k, n in want.items()):
        fail(f"[{tag}] epoch {epoch}: launches in optimize {in_optimize}, expected {want}")
    return dict(samples=samples, secs=secs, steps=steps)


def _wan22_finish(trainer, tag: str, runs: list, counts: dict, what: str, predicted=None, then=None) -> None:
    """Peak memory against the prediction (``WAN22_PEAK_PREDICTED`` unless
    ``predicted``), seconds a rollout and a grad step, what was live at one
    grad step's peak (not under remat: the allocator history's Python
    stacks break the recompute's unpack hook with a ``SystemError``), a
    profiled grad step with its idle share, ``then()``; the trainer freed."""
    import torch

    peak = torch.cuda.max_memory_allocated() / 2**30
    lo, hi = (predicted or WAN22_PEAK_PREDICTED)[tag]
    log(f"[{tag}] launches {counts} | peak memory {peak:.2f} GiB (predicted {lo:.0f}-{hi:.0f} GiB: "
        f"{'inside' if lo <= peak <= hi else 'outside'}) | seconds a rollout "
        f"{[round(r['secs']['rollout'], 2) for r in runs]}, a grad step "
        f"{[round(r['secs']['optimize'] / max(len(r['steps']), 1), 3) for r in runs]} | global step "
        f"{trainer.global_step}")
    if not trainer.adapter.component_configs["transformer"].remat:
        _peak_breakdown(tag, _one_grad_step(trainer))
    _profile_grad_step(trainer, what, f"{tag}_grad_step_trace.json")
    if then is not None:
        then()
    trainer.cleanup()
    gc.collect()
    torch.cuda.empty_cache()


def _ti2v_frame0_spies(ad, record: dict):
    """Hooks that take, at every transformer call of a rollout (not of a
    grad step), frame 0 of the latents it sees (the composite), and at the
    decode frame 0 of the latents it decodes; returns the undo."""
    vae = ad.modules["vae"]

    def velocity(module, args):
        if ad.mode == "rollout":
            record["velocity"].append(args[0][:, 0].detach().clone())

    hook = ad.modules["transformer"].register_forward_pre_hook(velocity)
    real_decode = vae.decode

    def decode(latents, *args, **kwargs):
        record["decode"].append(latents[:, 0].detach().clone())
        return real_decode(latents, *args, **kwargs)

    vae.decode = decode

    def undo():
        hook.remove()
        del vae.decode

    return undo


def phase_wan22_ti2v() -> dict:
    """[wan22-ti2v]: Wan2.2-TI2V-5B at full size (30 layers, width 3072, 24
    heads of 128, FFN 14336, 48 latent channels; the Wan 2.2 VAE; UMT5-XXL)
    on tests/fixtures/wan22_ti2v_grpo.yaml (256 px x 17 frames: 320 tokens;
    10 steps, CFG 5, Flow-SDE eta 0.8; random bf16 weights from seed 42).
    First the T2V mode (``wan2-t2v``): a serving rollout of 2 prompts x 4
    and the no-grad replay of its 10 stored steps, ratio exactly 1.0, 600 K3
    / 910 K5 each. Then the I2V mode (``expand_timesteps``) under GRPO for
    two epochs on two dataset/sharegpt4o_image_mini records at 256 px: the
    transformer sees frame 0 as the encoded image, bit for bit, at every
    step of every rollout (the SDE step evolves the raw latents, frame 0
    included, as in the JAX package) and the decode composites it back; 61
    of a forward's 91 K5 calls per token; ratio exactly 1.0 on every grad
    step; launches as predicted; a moved LoRA; peak memory, seconds, a
    profiled grad step. Returns the launch counts of the I2V epochs."""
    import numpy as np
    import torch

    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.models import load_adapter
    from flow_factory_tpu_torch.ops import norms as N

    here = os.path.dirname(os.path.abspath(__file__))
    data_dir = _wan22_image_dataset(here, "wan22_image_data_256", 256)

    # the T2V mode: serving rollout and replay
    cfg = _wan22_config("wan22_ti2v_grpo.yaml", "wan2-t2v", dataset_dir=data_dir)
    ta = cfg.training_args
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ad = load_adapter(cfg)  # cuda
    torch.cuda.synchronize()
    _wan22_sizes("wan22-ti2v", ad, time.perf_counter() - t0)
    L = ad.component_configs["transformer"].num_layers
    forward, backward = _wan_launches(L)
    with open(os.path.join(data_dir, "train.jsonl")) as f:
        prompts = [json.loads(line)["prompt"] for line in f][:2]
    batch = [p for p in prompts for _ in range(ta.group_size)]
    ops.reset_launch_counts()
    ad.rollout()
    t0 = time.perf_counter()
    samples = ad.inference(prompt=batch, compute_log_prob=True, trajectory_indices="all", seed=ta.seed)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    videos = np.stack([s.video for s in samples])
    want = {k: n * ta.num_inference_steps for k, n in forward.items()}
    log(f"[wan22-ti2v] T2V serving rollout of {len(batch)}: videos {videos.shape} in [{videos.min():.3f}, "
        f"{videos.max():.3f}], latents {samples[0].all_latents.shape}, launches {counts} (expected {want}), "
        f"{secs:.2f} s with the decode ({len(batch) / secs:.3f} samples/s)")
    if not (np.isfinite(videos).all() and videos.shape == (len(batch), ta.num_frames, 3, ta.height, ta.width)):
        fail(f"[wan22-ti2v] the T2V rollout's videos are not as expected: {videos.shape}")
    if any(counts[k] != n for k, n in want.items()):
        fail(f"[wan22-ti2v] T2V rollout launches {counts}, expected {want}")
    _replay_check("wan22-ti2v", ad, samples, forward)
    log(f"[wan22-ti2v] T2V peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del ad, samples
    gc.collect()
    torch.cuda.empty_cache()

    # the I2V mode under GRPO
    trainer = _wan22_load_trainer("wan22-ti2v", _wan22_config("wan22_ti2v_grpo.yaml", dataset_dir=data_dir))
    ad = trainer.adapter
    lora = ad.trainable["transformer"]
    b0 = {path: ab["lora_B"].detach().clone() for path, ab in lora.items()}
    per_token = []
    real_k5 = N.ln_mul_add

    def k5_spy(x, mul, add, *args, **kwargs):
        per_token.append(mul.shape[1] != 1)
        return real_k5(x, mul, add, *args, **kwargs)

    k5_spy.launches = 0  # the kernel counts its launch on what stands in its name

    def check_rollout(samples):
        cond = torch.from_numpy(np.stack([s.extra_kwargs["cond_latents"] for s in samples])[:, 0]).to(ad.device)
        seen_frames = record["velocity"]
        cfg_cond = torch.cat([cond, cond]).to(seen_frames[0].dtype)  # the CFG batch, cast as the DiT casts it
        composite = all(torch.equal(f, cfg_cond) for f in seen_frames)
        decoded = all(torch.equal(f, cond) for f in record["decode"])
        raw = np.stack([s.all_latents[-1][0] for s in samples])
        moved = not np.array_equal(raw, cond.cpu().numpy())
        log(f"[wan22-ti2v] frame 0 of the latents the transformer saw equals the encoded image bit for bit at "
            f"{sum(torch.equal(f, cfg_cond) for f in seen_frames)}/{len(seen_frames)} calls; frame 0 of the "
            f"decoded latents equals it: {decoded} ({len(record['decode'])} decode); the raw stored frame 0 "
            f"evolves with the SDE step as in JAX: {moved}")
        if not (composite and decoded and len(seen_frames) == trainer.training_args.num_inference_steps
                and record["decode"]):
            fail("[wan22-ti2v] frame 0 is not the encoded image at every step or at the decode")
        record["velocity"].clear()
        record["decode"].clear()

    record = {"velocity": [], "decode": []}
    undo = _ti2v_frame0_spies(ad, record)
    ops.reset_launch_counts()
    runs = []
    try:
        for epoch in range(trainer.training_args.max_epochs):
            runs.append(_grpo_epoch(trainer, "wan22-ti2v", epoch, forward, backward, check_rollout,
                                    staged_keys=("cond_latents",)))
    finally:
        undo()
    counts = ops.launch_counts()
    moved = max((lora[p]["lora_B"] - b).abs().max().item() for p, b in b0.items())
    batch = next(trainer.grad_step_batches(runs[-1]["samples"], trainer.training_args.max_epochs - 1))
    N.ln_mul_add = k5_spy
    try:
        with torch.no_grad():
            trainer.adapter.training_forward(ad.trainable, batch)
    finally:
        N.ln_mul_add = real_k5
    log(f"[wan22-ti2v] LoRA B moved by max|change| {moved:.3e}; K5 calls with a per-token modulation in one "
        f"training forward: {sum(per_token)} of {len(per_token)} (expected {2 * L + 1} of {3 * L + 1})")
    if not moved > 0:
        fail("[wan22-ti2v] the LoRA did not move")
    if sum(per_token) != 2 * L + 1 or len(per_token) != 3 * L + 1:
        fail(f"[wan22-ti2v] K5 took the per-token modulation {sum(per_token)} of {len(per_token)} times")
    _wan22_finish(trainer, "wan22-ti2v", runs, counts,
                  "one Wan2.2-TI2V-5B I2V grad step (LoRA merge, forward, backward, AdamW)")
    return counts


def phase_wan22_moe() -> dict:
    """[wan22-moe]: the Wan2.2-A14B two-expert MoE at full width, 4 layers
    an expert, on tests/fixtures/wan22_a14b_grpo.yaml (256 px x 5 frames:
    512 tokens; 10 steps, CFG 5 on the high-noise expert and
    ``guidance_scale_2`` 3 on the low-noise one; random bf16 weights). T2V
    GRPO for two epochs: each rollout step's expert as JAX's fp32 rule
    t >= 875 gives it (steps 0-3, 875.0 included, on ``transformer_2``),
    the kernels launched as one 4-layer forward a step; on every grad step
    the routed expert's LoRA gets a gradient and the other's exact zeros;
    an expert's LoRA B moves exactly when a trained step routed to it;
    ratio exactly 1.0. Returns the launch counts of the two epochs;
    :func:`_wan22_moe_concat_i2v` runs the experts' channel-concat I2V
    after it (``wan2-i2v``: in_channels 16 + 17 = 33) on two dataset
    records at 256 px, with the ``cond_latents`` staged into every grad
    step."""
    import numpy as np

    from flow_factory_tpu_torch import ops

    trainer = _wan22_load_trainer("wan22-moe", _wan22_config("wan22_a14b_grpo.yaml"))
    ad = trainer.adapter
    L = ad.component_configs["transformer"].num_layers
    forward, backward = _wan_launches(L)
    if sorted(ad.trainable) != ["transformer", "transformer_2"] or L != 4:
        fail(f"[wan22-moe] expected two trained experts of 4 layers: {sorted(ad.trainable)}, {L}")
    b0 = {c: {p: ab["lora_B"].detach().clone() for p, ab in t.items()} for c, t in ad.trainable.items()}
    routes: list = []

    def check_rollout(samples):
        ts = samples[0].timesteps
        want = [bool(np.float32(t) >= np.float32(ad.boundary_ratio * 1000.0)) for t in ts]
        got = [high for _, high in routes]
        log(f"[wan22-moe] rollout steps' experts (t, high-noise): "
            f"{[(round(t, 3), h) for t, h in routes]}; JAX's rule gives {want}")
        if got != want * (len(got) // len(want)) or not got:
            fail(f"[wan22-moe] the rollout's experts {got} differ from the rule's {want}")
        routes.clear()

    undo = _route_recorder(ad, routes)
    ops.reset_launch_counts()
    runs = []
    try:
        for epoch in range(trainer.training_args.max_epochs):
            runs.append(_grpo_epoch(trainer, "wan22-moe", epoch, forward, backward, check_rollout))
    finally:
        undo()
    counts = ops.launch_counts()
    trained = set()
    for run in runs:
        for t, live, _ in run["steps"]:
            want = ["transformer_2" if ad.routes_high(t) else "transformer"]
            if live != want:
                fail(f"[wan22-moe] the grad step at t {t} gave non-zero LoRA gradients to {live}, expected {want}")
            trained.update(want)
    moved = {c: max((ad.trainable[c][p]["lora_B"] - b).abs().max().item() for p, b in tree.items())
             for c, tree in b0.items()}
    log(f"[wan22-moe] experts with a trained step {sorted(trained)}; LoRA B max|change| {moved}")
    if any((moved[c] > 0) != (c in trained) for c in moved):
        fail(f"[wan22-moe] an expert's LoRA moved without a trained step or stayed without one: {moved}")
    _wan22_finish(trainer, "wan22-moe", runs, counts,
                  "one Wan2.2-A14B (4 layers an expert) grad step (LoRA merge of the routed expert, forward, "
                  "backward, AdamW)")
    return counts


def _wan22_moe_concat_i2v() -> None:
    """[wan22-moe]'s one epoch of channel-concat I2V on the A14B experts."""
    import torch

    from flow_factory_tpu_torch import ops

    here = os.path.dirname(os.path.abspath(__file__))
    data_dir = _wan22_image_dataset(here, "wan22_image_data_256", 256)
    cfg = _wan22_config("wan22_a14b_grpo.yaml", "wan2-i2v", dataset_dir=data_dir)
    cfg.training_args.max_epochs = 1
    trainer = _wan22_load_trainer("wan22-moe", cfg)
    if trainer.adapter.component_configs["transformer"].in_channels != 33:
        fail("[wan22-moe] the concat I2V transformer is not 33 channels wide")
    forward, backward = _wan_launches(trainer.adapter.component_configs["transformer"].num_layers)
    ops.reset_launch_counts()
    run = _grpo_epoch(trainer, "wan22-moe", 0, forward, backward, staged_keys=("cond_latents",))
    if not all("cond_latents" in staged for _, _, staged in run["steps"]):
        fail("[wan22-moe] the concat I2V grad steps did not stage cond_latents")
    log(f"[wan22-moe] concat I2V epoch: launches {ops.launch_counts()} | peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | seconds "
        f"{json.dumps({k: round(v, 3) for k, v in run['secs'].items()})}")
    trainer.cleanup()


def phase_wan_v2v() -> dict:
    """[wan-v2v]: channel-concat V2V on Wan2.1-T2V-1.3B at full width
    (tests/fixtures/wan21_v2v_grpo.yaml: 256 px x 5 frames, 10 steps, CFG 5;
    the patch embedding 33 channels wide). One GRPO epoch by
    :func:`_grpo_epoch` whose rollout of 2 prompts x 4 takes two 5-frame
    condition clips given as arrays (made from the seed): 600 K3 / 910 K5;
    each sample keeps its clip; the no-grad replay of every stored step with
    ratio exactly 1.0; then the feedback and the optimize phase (2 grad
    steps, one optimizer step), the ``cond_latents`` staged into each, ratio
    exactly 1.0, a moved LoRA, peak memory, a profiled grad step. Returns
    the launch counts of the epoch."""
    import numpy as np

    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.utils.base import make_generator
    from flow_factory_tpu_torch.utils.trajectory import compute_trajectory_indices

    trainer = _wan22_load_trainer("wan-v2v", _wan22_config("wan21_v2v_grpo.yaml"))
    ad, ta = trainer.adapter, trainer.training_args
    L = ad.component_configs["transformer"].num_layers
    forward, backward = _wan_launches(L)
    lora = ad.trainable["transformer"]
    b0 = {path: ab["lora_B"].detach().clone() for path, ab in lora.items()}
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "dataset", "vid_prompt", "train.txt")) as f:
        prompts = [line.strip() for line in f if line.strip()][:2]
    rng = np.random.default_rng(ta.seed)
    clips = [rng.uniform(0.0, 1.0, (ta.num_frames, 3, ta.height, ta.width)).astype(np.float32) for _ in prompts]
    batch = [p for p in prompts for _ in range(ta.group_size)]
    videos_in = [c for c in clips for _ in range(ta.group_size)]

    def sample(epoch):
        """The trainer's rollout, with the clips as arrays (no video decoder here)."""
        ad.rollout()
        trainer.reward_buffer.clear()
        samples = ad.inference(prompt=batch, condition_video=videos_in, compute_log_prob=True,
                               trajectory_indices=compute_trajectory_indices(trainer.scheduler.train_timesteps,
                                                                             ta.num_inference_steps),
                               generator=make_generator(ad.device, "rollout", ta.seed, epoch, 0, 0))
        trainer.reward_buffer.add_samples(samples)
        ad.train()
        return samples

    def check_rollout(samples):
        kept = all(np.array_equal(s.condition_video, v) for s, v in zip(samples, videos_in))
        log(f"[wan-v2v] rollout on two 5-frame condition clips: cond_latents "
            f"{samples[0].extra_kwargs['cond_latents'].shape}, each sample keeps its clip: {kept}")
        if not (kept and ad.component_configs["transformer"].in_channels == 33):
            fail("[wan-v2v] the rollout's clips or width are not as expected")
        _replay_check("wan-v2v", ad, samples, forward)

    ops.reset_launch_counts()
    run = _grpo_epoch(trainer, "wan-v2v", 0, forward, backward, check_rollout, ("cond_latents",), sample)
    counts = ops.launch_counts()
    moved = max((lora[p]["lora_B"] - b).abs().max().item() for p, b in b0.items())
    log(f"[wan-v2v] LoRA B max|change| {moved:.3e}")
    if not (all("cond_latents" in st for _, _, st in run["steps"]) and moved > 0):
        fail(f"[wan-v2v] the grad steps: {run['steps']}, LoRA moved {moved}")
    _wan22_finish(trainer, "wan-v2v", [run], counts,
                  "one Wan2.1-1.3B V2V grad step (LoRA merge, forward, backward, AdamW)")
    return counts


def _wan22_phases() -> dict:
    """[wan22-grad], [wan22-ti2v], [wan22-moe] and [wan-v2v], each trainer
    freed before the next loads; returns the launch counts of the TI2V and
    MoE epochs by tag."""
    import torch

    phase_wan22_grad()
    counts = {"wan22-ti2v": phase_wan22_ti2v(), "wan22-moe": phase_wan22_moe()}
    for phase in (_wan22_moe_concat_i2v, phase_wan_v2v):  # each trainer freed before the next loads
        gc.collect()
        torch.cuda.empty_cache()
        phase()
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def wan22_only() -> int:
    """``python3 chip_smoke.py --wan22``: the build, [wan22-kernels] and the
    Wan2.2 and V2V phases alone."""
    import torch

    from flow_factory_tpu_torch.utils.base import use_full_fp32

    use_full_fp32()
    phase_environment()
    phase_wan22_kernels({})
    counts = _wan22_phases()
    log(f"[wan22] launches {counts}; device memory still allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return 0


# ---------------------------------------------------------------------------
# Wan2.1-I2V-14B with the CLIP image stream at full width, under GRPO
# ---------------------------------------------------------------------------

#: the image cross-attention of Wan2.1-I2V-14B at 256 px x 5 frames (tag,
#: heads, Sq, Sk): 512 video tokens against the 257 CLIP tokens (four 64-key
#: tiles and one key in the last), at the rollout's B 16 (8 samples under
#: CFG) for K3 and at the grad step's, a micro-batch of 8 under CFG (B 16),
#: for K2a/K2b; the self and text attentions are the A14B's shapes
#: (``WAN22_ATTENTION``)
WAN_I2V_IMAGE = ("wan-i2v-image", 40, 512, 257)
#: the Wan2.1-I2V kernel tags of the table and the kernels whose launches in
#: [wan-i2v14b]'s epochs they take, a third of each (the image
#: cross-attention is one of a block's three attentions, the only K3 and K2
#: calls there: :func:`_wan_i2v_launches`)
WAN_I2V_TAGS = {name: (WAN_I2V_IMAGE[0],) for name in ("flash_fwd", "flash_bwd_dq_d128", "flash_bwd_dkv_d128")}
#: peak device memory predicted for [wan-i2v14b] (GiB; PERF.md §6)
WAN_I2V_PEAK_PREDICTED = {"wan-i2v14b": (42.0, 48.0)}


def phase_wan_i2v_kernels(results: dict) -> None:
    """[wan-i2v-kernels]: K3 and K2a/K2b at head dim 128 at the image
    cross-attention (``WAN_I2V_IMAGE``: q and k contiguous, the text
    stream's normed query and the k-only norm's output, v a head-split view
    of ``add_v_proj``), through ``_k3_shape_checks`` (the controls without
    log2(e) and with the 63 padded keys taken for real) and
    ``_k2_d128_shape_checks`` (the controls without Delta and without the
    one-key ragged tail), timed by events and by device time beside SDPA;
    the entries join the table under their tag."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    randn = lambda *shape, dtype=torch.bfloat16: torch.randn(
        shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)
    log(f"[wan-i2v-kernels] card (SM clock, max, power, temperature): {gpu_state()}")
    t0 = time.perf_counter()
    tag, H, Sq, Sk = WAN_I2V_IMAGE
    B = 16
    q, k = randn(B, H, Sq, 128), randn(B, H, Sk, 128)
    v = randn(B, Sk, H, 128).transpose(1, 2)
    _k3_shape_checks(results, tag, q, k, v, "q/k contiguous, v a view",
                     functools.partial(_k3_qk_contiguous_call, B, H, Sq, Sk))
    del q, k, v
    _k2_d128_shape_checks(results, tag, B, H, Sq, Sk, True, randn)
    log(f"[wan-i2v-kernels] K3 and K2a/K2b at B{B} H{H} Sq{Sq} Sk{Sk} D128 within their tolerances, the controls "
        f"rejected, {time.perf_counter() - t0:.1f} s")


def _wan_i2v_launches(num_layers: int):
    """A Wan2.1-I2V forward's launches and its backward's: 3 K3 a block
    (self, text cross, image cross; the image embedder's LayerNorms are
    plain), K5 as in :func:`_wan_launches`, K2a/K2b for every K3."""
    forward, backward = _wan_launches(num_layers)
    return ({**forward, "flash_fwd": 3 * num_layers},
            {**backward, "flash_bwd_dq": 3 * num_layers, "flash_bwd_dkv": 3 * num_layers})


def _f18_bisect_module():
    """``tools/f18_bisect.py`` of this checkout, as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", "f18_bisect.py")
    spec = importlib.util.spec_from_file_location("f18_bisect", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_wan_i2v() -> dict:
    """[wan-i2v14b]: Wan2.1-I2V-14B GRPO with the CLIP image stream through
    ``load_trainer`` on tests/fixtures/wan21_i2v14b_grpo.yaml (width 5120,
    40 heads of 128, FFN 13824, 7 of 40 layers; the 32-layer ViT-H/14 with
    257 tokens; UMT5-XXL; 256 px x 5 frames = 512 tokens of 33 channels; 10
    steps, CFG 5, Flow-SDE; two records x group 4; the native PickScore
    scored asynchronously and the brightness reward), two epochs phase by
    phase: ``image_embeds`` (257, 1280) finite on every sample, K3 and K5 as
    predicted in every rollout (3 K3 a block) and in every grad step with
    ``cond_latents`` and ``image_embeds`` staged into it, a no-grad replay of
    every stored step and every grad step at ratio exactly 1.0 (epoch 1
    under the LoRA epoch 0 moved), the async CLIP scores equal to a
    synchronous rescoring of the same samples in the same batches bit for
    bit; then F18's case (a rollout of 4 rows, rows 0-1 replayed at 1.0),
    peak memory against ``WAN_I2V_PEAK_PREDICTED``, what was live at a grad
    step's peak, a profiled grad step, and ``tools/f18_bisect.py``'s
    bisection of the DiT at B 16 against its first 4 rows (every product the
    same bits). Returns the launch counts of the two epochs."""
    import numpy as np
    import torch

    from flow_factory_tpu_torch import ops

    tag = "wan-i2v14b"
    here = os.path.dirname(os.path.abspath(__file__))
    data_dir = _wan22_image_dataset(here, "wan22_image_data_256", 256)
    trainer = _wan22_load_trainer(tag, _wan22_config("wan21_i2v14b_grpo.yaml", dataset_dir=data_dir))
    ad, ta = trainer.adapter, trainer.training_args
    tcfg, vcfg = ad.component_configs["transformer"], ad.component_configs["image_encoder"]
    L = tcfg.num_layers
    forward, backward = _wan_i2v_launches(L)
    log(f"[{tag}] image stream: {tcfg.image_context_tokens} tokens of {tcfg.image_context_dim} from the ViT "
        f"({vcfg.num_layers} layers, width {vcfg.hidden_dim}, {vcfg.image_size} px / {vcfg.patch_size}, post-LN "
        f"{vcfg.use_post_ln}); embed keys {ad.embed_keys}; predicted launches a forward {forward}, a backward "
        f"{backward}")
    if (tcfg.hidden_dim, tcfg.num_heads, tcfg.ffn_dim, tcfg.in_channels, tcfg.image_context_tokens,
            tcfg.image_context_dim, vcfg.num_layers, vcfg.use_post_ln) != (5120, 40, 13824, 33, 257, 1280, 32, False):
        fail(f"[{tag}] not the Wan2.1-I2V-14B geometry: {tcfg}, {vcfg}")
    clip = trainer.reward_buffer.async_pointwise[0]
    lora = ad.trainable["transformer"]
    b0 = {p: ab["lora_B"].detach().clone() for p, ab in lora.items()}

    image = (tcfg.image_context_tokens, tcfg.image_context_dim)

    def check_rollout(samples):
        embeds = [s.extra_kwargs.get("image_embeds") for s in samples]
        ok = all(e is not None and e.shape == image and np.isfinite(e).all() for e in embeds)
        log(f"[{tag}] image_embeds {image} finite on every sample: {ok}")
        if not ok:
            fail(f"[{tag}] a sample lacks its image_embeds: {[None if e is None else e.shape for e in embeds]}")
        _replay_check(tag, ad, samples, forward)

    calls, undo = _first_inference(ad)
    ops.reset_launch_counts()
    runs = []
    for epoch in range(ta.max_epochs):
        try:
            run = _grpo_epoch(trainer, tag, epoch, forward, backward, check_rollout,
                              staged_keys=("cond_latents", "image_embeds"))
        finally:
            if epoch == 0:
                undo()
        runs.append(run)
        got = np.asarray([s.extra_kwargs["rewards"][clip.name] for s in run["samples"]])
        again = trainer.reward_buffer.processor._score_pointwise(clip, run["samples"])
        log(f"[{tag}] epoch {epoch}: async {clip.name} scores {got.tolist()} equal a synchronous rescoring bit for "
            f"bit: {np.array_equal(got, again)}")
        if not (np.isfinite(got).all() and np.array_equal(got, again)):
            fail(f"[{tag}] epoch {epoch}: the async CLIP scores {got} differ from the rescoring {again}")
        staged = [st for _, _, st in run["steps"]]
        if not all(st.get("image_embeds", (0,))[1:] == image and "cond_latents" in st for st in staged):
            fail(f"[{tag}] epoch {epoch}: a grad step lacks its cond_latents or image_embeds: {staged}")
        if epoch == 0:
            moved = max((lora[p]["lora_B"] - b).abs().max().item() for p, b in b0.items())
            log(f"[{tag}] LoRA B after the first update: max|change| {moved:.3e}")
            if not moved > 0:
                fail(f"[{tag}] the LoRA did not move after the optimizer step")
    counts = ops.launch_counts()  # the two epochs alone: the F18 probe below is not the main path
    secs: dict = {}
    _f18_rows_replay(tag, ad, calls[0], forward, secs)

    def bisect():
        gen = torch.Generator(device=ad.device).manual_seed(18)
        randn = lambda *shape: torch.randn(shape, generator=gen, device=ad.device)
        B = 16
        T, h, w, _ = ad.latent_shape(ta.height, ta.width, int(ta.num_frames))
        inputs = (randn(B, T, h, w, tcfg.in_channels), torch.linspace(980.0, 120.0, B, device=ad.device),
                  randn(B, ad.t5_max_length, tcfg.context_dim), randn(B, *image))
        same, varying = _f18_bisect_module().bisect(tag, ad.modules["transformer"], inputs, B, 4)
        if not same or varying:
            fail(f"[{tag}] F18: the DiT's first 4 rows differ at B {B} ({same}) or products vary: {varying}")

    _wan22_finish(trainer, tag, runs, counts, f"one Wan2.1-I2V-14B ({L} layers) grad step with the image stream "
                  "(LoRA merge, forward, backward, AdamW)", predicted=WAN_I2V_PEAK_PREDICTED, then=bisect)
    log(f"[{tag}] F18 rollout and replay seconds {json.dumps({k: round(v, 3) for k, v in secs.items()})}")
    return counts


def wan_i2v_only() -> int:
    """``python3 chip_smoke.py --wan-i2v``: the build, [wan-i2v-kernels],
    [wan-i2v14b] and the device times of the new shapes."""
    import torch

    from flow_factory_tpu_torch.utils.base import use_full_fp32

    use_full_fp32()
    phase_environment()
    phase_wan_i2v_kernels({})
    counts = phase_wan_i2v()
    phase_device_times()
    log(f"[wan-i2v14b] launches {counts}; device memory still allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return 0


# ---------------------------------------------------------------------------
# The Qwen-conditioned image families: Z-Image at full size, Qwen-Image and
# Qwen-Image-Edit-Plus at full width and 16 double blocks, under GRPO
# ---------------------------------------------------------------------------

#: joint lengths at 512 px: 512 text + 1024 image tokens (Z-Image and
#: Qwen-Image); Edit-Plus's 1103 text positions (512 + room for three
#: references of 197) + 1024 target + 1024 condition tokens
QWEN_S, QWEN_EDIT_S = 1536, 3151
#: K3 at the B 16 CFG batch of both 1536 shapes, and at Edit-Plus's 3151
#: (not a multiple of the 64-key tile) at B 8: the plain version's fp32
#: logits at B 16 would take 15 GB a matrix
QWEN_ATTENTION = (("qwen-1536-b16", 16, QWEN_S), ("qwen-edit-3151-b8", 8, QWEN_EDIT_S))
#: K2 at the grad steps' B 16 x 1536 (the control without Delta) and at
#: 3151 at B 4 (the control without the ragged 15-key tail)
QWEN_K2 = (("qwen-1536", 16, QWEN_S), ("qwen-edit-3151", 4, QWEN_EDIT_S))
#: K5's LayerNorm form at width 3072: Qwen-Image's four AdaLN norms a block
#: (image and text rows) and Edit-Plus's (2048 target + condition rows,
#: 1103 text rows), all bf16 -> bf16; Z-Image's one call, the final layer
#: over the whole joint row to fp32
QWEN_K5_SHAPES = tuple(NormShape(*shape) for shape in (
    ("qwen-img", 16, 1024, 3072, "bfloat16", "bfloat16", False, False, False, True),
    ("qwen-txt", 16, 512, 3072, "bfloat16", "bfloat16", False, False, False, True),
    ("qwen-edit-img", 16, 2048, 3072, "bfloat16", "bfloat16", False, False, False, True),
    ("qwen-edit-txt", 16, 1103, 3072, "bfloat16", "bfloat16", False, False, False, True),
    ("z-image-final", 16, QWEN_S, 3072, "bfloat16", "float32", False, False, False, True),
))
#: the table's shapes of each kernel and the phases whose launches they take
QWEN_TAGS = {
    "flash_fwd": {"qwen-1536-b16": ("z-image", "qwen-image"), "qwen-edit-3151-b8": ("qwen-edit",)},
    **{name: {"qwen-1536": ("z-image", "qwen-image"), "qwen-edit-3151": ("qwen-edit",)}
       for name in ("flash_bwd_dq_d128", "flash_bwd_dkv_d128")},
    **{name: {"qwen-img": ("qwen-image",), "qwen-txt": ("qwen-image",), "qwen-edit-img": ("qwen-edit",),
              "qwen-edit-txt": ("qwen-edit",), "z-image-final": ("z-image",)}
       for name in ("ln_mul_add", "ln_mul_add_backward")},
}
#: peak device memory predicted for each phase, GiB (PERF.md §6)
QWEN_PEAK_PREDICTED = {"z-image": (26.0, 33.0), "qwen-image": (37.0, 41.0), "qwen-edit": (45.0, 49.0)}
#: the double blocks of Qwen-Image and Edit-Plus on the card, of 60: the
#: depth tests/fixtures/qwen_image_cut/transformer/config.json sets
QWEN_CUT_BLOCKS = 16
#: the kernels no model of these phases runs (K1, K6): zero launches expected
_NOT_ON_PATH = {"qknorm_flash_fwd": 0, "residual_gate_modulate": 0}


def _qwen_launches(depth: int):
    """Launches of one forward of Qwen-Image's transformer (double blocks
    only) and of one rematted grad step: a K3 and four K5 a block, norm_out;
    the blocks recomputed in the backward (norm_out is outside them); K2a/K2b
    for every K3; K5's backward for every K5 but three: block 0's two first
    norms, whose inputs (the embedded latents and context, the AdaLN
    vectors) are frozen, and the last block's text FFN norm, whose output no
    later block reads (off the loss's path)."""
    forward = {"flash_fwd": depth, "ln_mul_add": 4 * depth + 1, **_NOT_ON_PATH}
    step = {"flash_fwd": 2 * depth, "flash_bwd_dq": depth, "flash_bwd_dkv": depth, "ln_mul_add": 8 * depth + 1,
            "ln_mul_add_backward": 4 * depth - 2, **_NOT_ON_PATH}
    return forward, step


def _z_image_launches(layers: int):
    """Launches of one Z-Image forward (a K3 a block; its block norms are
    plain RMSNorms, so one K5: the final layer) and of one rematted grad
    step."""
    forward = {"flash_fwd": layers, "ln_mul_add": 1, **_NOT_ON_PATH}
    step = {"flash_fwd": 2 * layers, "flash_bwd_dq": layers, "flash_bwd_dkv": layers, "ln_mul_add": 1,
            "ln_mul_add_backward": 1, **_NOT_ON_PATH}
    return forward, step


def phase_qwen_kernels(results: dict) -> None:
    """[qwen-kernels]: K3 at ``QWEN_ATTENTION``, K2a/K2b at ``QWEN_K2`` and
    K5 with its backward at ``QWEN_K5_SHAPES``, through the checks,
    controls, bits and times of ``_k3_shape_checks`` (the control without
    log2(e); at 3151 the padded-key control), ``_k2_d128_shape_checks`` and
    ``_k5_shape_checks`` (the backward's controls, among them K5's backward
    without its dmul term, on the Qwen-Image image norm and Z-Image's fp32
    final layer). The entries join the table under their tags."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    randn = lambda *shape, dtype=torch.bfloat16: torch.randn(
        shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)
    H, D = 24, 128
    log(f"[qwen-kernels] card (SM clock, max, power, temperature): {gpu_state()}")
    t0 = time.perf_counter()
    for tag, B, S in QWEN_ATTENTION:
        q, k, v = (randn(B, H, S, D) for _ in range(3))
        _k3_shape_checks(results, tag, q, k, v, "q/k/v contiguous", functools.partial(_k3_flux_call, B, H, S, D))
        del q, k, v
    for tag, B, S in QWEN_K2:
        _k2_d128_shape_checks(results, tag, B, H, S, S, True, randn)
    for shape in QWEN_K5_SHAPES:
        _k5_shape_checks(results, gen, shape, shape.tag in ("qwen-img", "z-image-final"))
    log(f"[qwen-kernels] every shape within its tolerance, the controls rejected: {len(QWEN_ATTENTION)} K3, "
        f"{len(QWEN_K2)} K2, {len(QWEN_K5_SHAPES)} K5 shapes, {time.perf_counter() - t0:.1f} s")


def phase_qwen_grad() -> None:
    """[qwen-grad]: LoRA gradients through K3, K2a/K2b and K5 at width 3072,
    depth 2, B 2, 1024 image + 512 text tokens: Qwen-Image's transformer (two
    double blocks, ``txt_norm``, context 3584) and Z-Image's (two blocks,
    context 2560), rank-32 LoRA on each family's targets with ``lora_B``
    drawn non-zero; checked by :func:`_lora_grad_check` against the plain
    path with the dq-zeroed control; every LoRA leaf live but those off the
    loss's path (Qwen-Image's last block's text-stream outputs and the text
    queries that only they read: ``add_q_proj``, ``to_add_out`` and
    ``ff_context``, which no later block reads; zero gradients in both
    packages' grad steps); the launches of one forward and its backward as
    predicted."""
    import dataclasses

    import torch
    from torch.func import functional_call

    from flow_factory_tpu_torch.models.flux.adapter import FLUX_LORA_TARGETS
    from flow_factory_tpu_torch.models.flux.transformer import FluxTransformer
    from flow_factory_tpu_torch.models.layers import build_module
    from flow_factory_tpu_torch.models.lora import init_lora
    from flow_factory_tpu_torch.models.qwen_image import adapter as qwen
    from flow_factory_tpu_torch.models.z_image import adapter as zimage
    from flow_factory_tpu_torch.models.z_image.transformer import ZImageTransformer

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
    B = 2
    img_ids, txt_ids = _flux_ids(64, 64, 512)
    t = torch.full((B,), 750.0, device=dev)
    cases = (
        ("Qwen-Image", dataclasses.replace(qwen._preset("qwen-image", "auto", "bfloat16")["transformer"],
                                           num_double_blocks=2), FluxTransformer, FLUX_LORA_TARGETS,
         lambda x, ctx: (x, t, ctx, None, img_ids, txt_ids, None), 12, _qwen_launches(2)),  # 4 off the path
        ("Z-Image", dataclasses.replace(zimage._preset("z-image", "auto", "bfloat16")["transformer"], num_layers=2),
         ZImageTransformer, zimage.Z_IMAGE_LORA_TARGETS, lambda x, ctx: (x, t, ctx, img_ids, txt_ids), 7,
         _z_image_launches(2)),
    )
    for what, cfg, cls, targets, args, per_block, (forward, step) in cases:
        model = build_module(lambda: cls(cfg), dev, torch.bfloat16, gen)
        lora = init_lora(model, 32, gen, targets)
        for ab in lora.values():  # b != 0, else the gradient of a is zero
            ab["lora_B"].data.normal_(0.0, 1e-2, generator=gen)
        last = f"transformer_blocks.{getattr(cfg, 'num_double_blocks', 0) - 1}."
        off_path = sorted(p for p in lora if p.startswith(last) and (".to_add_out" in p or ".ff_context." in p
                                                                     or ".add_q_proj" in p))
        lora = {p: ab for p, ab in lora.items() if p not in off_path}
        x, ctx = randn(B, 1024, cfg.in_channels), randn(B, 512, cfg.context_dim)
        names, kern, _, counts = _lora_grad_check(
            f"{what} width {cfg.hidden_dim}, depth 2, B={B}, 1024 image + 512 text tokens", model, lora,
            lambda params: functional_call(model, params, args(x, ctx)), x, gen)
        dead = [n for n, g in zip(names, kern) if not g.abs().max().item() > 0]
        want = {**forward, "flash_bwd_dq": forward["flash_fwd"], "flash_bwd_dkv": forward["flash_fwd"],
                "ln_mul_add_backward": step["ln_mul_add_backward"]}
        log(f"[qwen-grad] {what}: non-zero gradient on {len(names) - len(dead)}/{len(names)} LoRA leaves; off the "
            f"loss's path and left out: {off_path}; launches of one forward and its backward {counts} (expected "
            f"{want})")
        if dead or len(names) != 2 * (2 * per_block - len(off_path)) or any(counts[k] != n for k, n in want.items()):
            fail(f"[qwen-grad] {what}: LoRA leaves without gradient {dead}, or launches {counts} differ from {want}")
        del model, lora, kern
        torch.cuda.empty_cache()


def _qwen_config(fixture: str, **data):
    """A fixture's config for the card, its relative model directory (the
    depth cut) made absolute."""
    cfg = _wan22_config(fixture, **data)
    here = os.path.dirname(os.path.abspath(__file__))
    path = cfg.model_args.model_name_or_path
    if path and not os.path.isabs(path):
        cfg.model_args.model_name_or_path = os.path.join(here, path)
    return cfg


def _prompts(data_dir: str, n: int = 2) -> list:
    with open(os.path.join(data_dir, "train.txt")) as f:
        return [line.strip() for line in f if line.strip()][:n]


def _negatives_kept(tag: str, samples, shape) -> None:
    import numpy as np

    got = {tuple(np.shape(s.negative_prompt_embeds)) if s.negative_prompt_embeds is not None else None
           for s in samples}
    log(f"[{tag}] each sample keeps its negative embeddings for the replay: shapes {sorted(map(str, got))}")
    if got != {shape}:
        fail(f"[{tag}] the samples' negative embeddings are {got}, expected {shape}")


def _lora_moved(tag: str, lora, b0) -> None:
    moved = max((lora[p]["lora_B"] - b).abs().max().item() for p, b in b0.items())
    log(f"[{tag}] LoRA B max|change| {moved:.3e}")
    if not moved > 0:
        fail(f"[{tag}] the LoRA did not move")


def phase_z_image() -> dict:
    """[z-image]: Z-Image at full width on tests/fixtures/z_image_grpo.yaml (19
    of 38 layers, width 3072, the Qwen3-sized LM; 512 px: a joint length of
    1536; 10 steps, CFG 4 with the negatives "", B 16 a forward; remat): two
    GRPO epochs by :func:`_grpo_epoch` (19 K3 and 1 K5 a rollout step; 38
    K3, 19 K2a, 19 K2b, 1 K5 and its backward a grad step; ratio exactly 1.0 on
    every grad step; each sample keeps its negatives), a moved LoRA, peak
    memory, a profiled grad step; then a serving rollout at the Turbo
    geometry (6 steps, guidance 0, no negatives: B 8, no CFG) and its
    replay, ratio exactly 1.0. Returns the launch counts of the epochs."""
    import numpy as np
    import torch

    from flow_factory_tpu_torch import ops

    here = os.path.dirname(os.path.abspath(__file__))
    trainer = _wan22_load_trainer("z-image", _qwen_config("z_image_grpo.yaml"))
    ad, ta = trainer.adapter, trainer.training_args
    tcfg, lm = ad.component_configs["transformer"], ad.component_configs["text_encoder"]
    if (tcfg.num_layers, tcfg.hidden_dim, lm.num_layers, lm.hidden_dim, tcfg.remat) != (19, 3072, 36, 2560, True):
        fail(f"[z-image] not the cut preset (tests/fixtures/z_image_cut) under remat: {tcfg}, {lm}")
    forward, step = _z_image_launches(tcfg.num_layers)
    lora = ad.trainable["transformer"]
    b0 = {p: ab["lora_B"].detach().clone() for p, ab in lora.items()}
    ops.reset_launch_counts()
    runs = [_grpo_epoch(trainer, "z-image", epoch, forward, {},
                        lambda samples: _negatives_kept("z-image", samples, (512, lm.hidden_dim)), grad_step=step)
            for epoch in range(ta.max_epochs)]
    counts = ops.launch_counts()
    _lora_moved("z-image", lora, b0)

    def turbo():
        """The Turbo geometry's serving rollout of 2 prompts x 4 and its replay."""
        batch = [p for p in _prompts(os.path.join(here, "dataset", "pickscore")) for _ in range(ta.group_size)]
        before = ops.launch_counts()
        ad.rollout()
        t0 = time.perf_counter()
        samples = ad.inference(prompt=batch, num_inference_steps=6, guidance_scale=0.0, compute_log_prob=True,
                               trajectory_indices="all", seed=ta.seed)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = {k: v - before[k] for k, v in ops.launch_counts().items()}
        want = {k: 6 * n for k, n in forward.items()}
        images = np.stack([s.image for s in samples])
        log(f"[z-image] Turbo serving rollout (6 steps, guidance 0, no negatives, B {len(batch)}): images "
            f"{images.shape} in [{images.min():.3f}, {images.max():.3f}], launches {launched} (expected {want}), "
            f"{secs:.2f} s with the prompt encode and the decode ({len(batch) / secs:.3f} samples/s)")
        if not (np.isfinite(images).all() and images.shape == (len(batch), 3, 512, 512)
                and all(s.negative_prompt_embeds is None for s in samples)):
            fail("[z-image] the Turbo rollout's images or negatives are not as expected")
        if any(launched[k] != n for k, n in want.items()):
            fail(f"[z-image] Turbo rollout launches {launched}, expected {want}")
        _replay_check("z-image", ad, samples, forward)
        ad.train()

    _wan22_finish(trainer, "z-image", runs, counts,
                  "one Z-Image grad step (B 16 x 1536 tokens, 19 layers, remat; LoRA merge, forward, backward, AdamW)",
                  QWEN_PEAK_PREDICTED, turbo)
    return counts


def phase_qwen_image() -> dict:
    """[qwen-image]: Qwen-Image at full width, 16 of 60 double blocks, on
    tests/fixtures/qwen_image_grpo.yaml (the depth read from
    tests/fixtures/qwen_image_cut/transformer/config.json; Qwen2.5-7B; 512
    px: a joint length of 1536; CFG 4 with the negatives " ", B 16; remat):
    a serving rollout of 2 prompts x 4 through ``inference`` (16 K3 and 65
    K5 a step) and its no-grad replay, ratio exactly 1.0 on every stored
    step; then two GRPO epochs (32 K3, 16 K2a, 16 K2b, 129 K5 and 62 K5
    backwards a grad step, ratio exactly 1.0), a moved LoRA, peak memory, a
    profiled grad step. Returns the launch counts of the epochs."""
    import numpy as np
    import torch

    from flow_factory_tpu_torch import ops

    here = os.path.dirname(os.path.abspath(__file__))
    trainer = _wan22_load_trainer("qwen-image", _qwen_config("qwen_image_grpo.yaml"))
    ad, ta = trainer.adapter, trainer.training_args
    tcfg, lm = ad.component_configs["transformer"], ad.component_configs["text_encoder"]
    log(f"[qwen-image] transformer: {tcfg.num_double_blocks} double + {tcfg.num_single_blocks} single blocks, "
        f"txt_norm {tcfg.txt_norm}, pooled {tcfg.pooled_dim}, guidance embed {tcfg.guidance_embeds}, context "
        f"{tcfg.context_dim}; LM {lm.num_layers} layers, width {lm.hidden_dim}, q/k/v biases {lm.attn_bias}")
    if (tcfg.num_double_blocks, tcfg.num_single_blocks, tcfg.hidden_dim, tcfg.txt_norm, lm.attn_bias,
            lm.hidden_dim) != (QWEN_CUT_BLOCKS, 0, 3072, True, True, 3584):
        fail(f"[qwen-image] not the cut Qwen-Image preset: {tcfg}, {lm}")
    forward, step = _qwen_launches(tcfg.num_double_blocks)
    batch = [p for p in _prompts(os.path.join(here, "dataset", "pickscore")) for _ in range(ta.group_size)]
    ops.reset_launch_counts()
    ad.rollout()
    t0 = time.perf_counter()
    samples = ad.inference(prompt=batch, compute_log_prob=True, trajectory_indices="all", seed=ta.seed)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = {k: n * ta.num_inference_steps for k, n in forward.items()}
    images = np.stack([s.image for s in samples])
    log(f"[qwen-image] serving rollout of {len(batch)}: images {images.shape} in [{images.min():.3f}, "
        f"{images.max():.3f}], latents {samples[0].all_latents.shape}, launches {counts} (expected {want}), "
        f"{secs:.2f} s with the prompt encode and the decode ({len(batch) / secs:.3f} samples/s)")
    if not (np.isfinite(images).all() and images.shape == (len(batch), 3, ta.height, ta.width)):
        fail(f"[qwen-image] the serving rollout's images are not as expected: {images.shape}")
    if any(counts[k] != n for k, n in want.items()):
        fail(f"[qwen-image] serving rollout launches {counts}, expected {want}")
    _negatives_kept("qwen-image", samples, (512, lm.hidden_dim))
    _replay_check("qwen-image", ad, samples, forward)
    ad.train()
    del samples
    lora = ad.trainable["transformer"]
    b0 = {p: ab["lora_B"].detach().clone() for p, ab in lora.items()}
    ops.reset_launch_counts()
    runs = [_grpo_epoch(trainer, "qwen-image", epoch, forward, {}, grad_step=step) for epoch in range(ta.max_epochs)]
    counts = ops.launch_counts()
    _lora_moved("qwen-image", lora, b0)
    _wan22_finish(trainer, "qwen-image", runs, counts,
                  "one Qwen-Image grad step (16 double blocks, B 16 x 1536 tokens, remat; LoRA merge, forward, "
                  "backward, AdamW)", QWEN_PEAK_PREDICTED)
    return counts


def _vision_scatter_check(ad, data_dir: str) -> None:
    """The Edit-Plus prompt encode with images: the embeddings that enter the
    LM's first layer are the vision tower's merged tokens, bit for bit in
    the compute dtype, at each record's image-pad rows, and the token
    embeddings elsewhere; 196 merged tokens a 512 px reference (the 392²
    grid of 28 x 28 patches, 2 x 2 merged), with their M-RoPE (t, h, w)
    ids."""
    import torch

    from flow_factory_tpu_torch.data.dataset import _load_media_fields, load_raw_records

    recs = [_load_media_fields(r, data_dir) for r in load_raw_records(os.path.join(data_dir, "train.jsonl"))]
    prompts, images = [r["prompt"] for r in recs], [r["images"] for r in recs]
    lm = ad.modules["text_encoder"]
    dt = lm.cfg.compute_dtype
    host, vis = ad.vision_rows(prompts, images)
    seen = []
    hook = lm.model.layers[0].register_forward_pre_hook(lambda m, args: seen.append(args[0].detach().clone()))
    t0 = time.perf_counter()
    try:
        emb = ad.encode_prompt(prompts, images=images)["prompt_embeds"]
        torch.cuda.synchronize()
    finally:
        hook.remove()
    secs = time.perf_counter() - t0
    x = seen[0]
    ids = torch.as_tensor(host["ids"], device=x.device)
    table = lm.model.embed_tokens.weight.to(dt)
    pads, ok = [], True
    for b in range(len(prompts)):
        rows = torch.as_tensor(host["vis_mask"][b], device=x.device)
        n = int(rows.sum())
        pads.append(n)
        ok &= torch.equal(x[b, rows], vis[b, :n].to(dt)) and torch.equal(x[b, ~rows], table[ids[b, ~rows]])
    pos = host["pos_ids"][0]
    log(f"[qwen-edit] vision scatter: image-pad rows a record {pads} of {ad.vl_total_length} (196 merged tokens a "
        f"reference), the first layer's input equals the vision tower's tokens there and the token embeddings "
        f"elsewhere, bit for bit: {ok}; M-RoPE ids (t, h, w) of the first image row {pos[:, 0].tolist()}, of its "
        f"last {pos[:, pads[0] - 1].tolist()}, of the first text row {pos[:, pads[0]].tolist()}; sections "
        f"{lm.cfg.mrope_sections}; prompt states {tuple(emb.shape)} finite {bool(torch.isfinite(emb).all())}; the "
        f"vision tower and the 7B LM over both records {secs:.2f} s")
    if not (ok and pads == [196] * len(prompts) and torch.isfinite(emb).all()
            and pos[:, pads[0] - 1].tolist() == [0.0, 13.0, 13.0] and pos[:, pads[0]].tolist() == [14.0] * 3):
        fail("[qwen-edit] the vision tower's merged tokens did not land in the prompt's image-pad rows")


def phase_qwen_edit() -> dict:
    """[qwen-edit]: Qwen-Image-Edit-Plus at the width and depth of
    [qwen-image] with the full Qwen2.5-VL vision tower and M-RoPE, on
    tests/fixtures/qwen_image_edit_plus_grpo.yaml over two records with one
    512 px reference each (``_kontext_dataset``): the vision scatter
    (:func:`_vision_scatter_check`), then one GRPO epoch (1024 condition
    tokens a row after the 1024 target tokens and 1103 text positions: a
    joint length of 3151; the launches of [qwen-image]; ratio exactly 1.0 on
    every grad step, the condition tokens staged into each), a moved LoRA,
    peak memory, a profiled grad step. Returns the launch counts of the
    epoch."""
    import numpy as np

    from flow_factory_tpu_torch import ops

    here = os.path.dirname(os.path.abspath(__file__))
    data_dir = _kontext_dataset(here)
    trainer = _wan22_load_trainer("qwen-edit", _qwen_config("qwen_image_edit_plus_grpo.yaml", dataset_dir=data_dir))
    ad, ta = trainer.adapter, trainer.training_args
    tcfg, lm, vcfg = (ad.component_configs[c] for c in ("transformer", "text_encoder", "vision_tower"))
    log(f"[qwen-edit] vision tower depth {vcfg.depth}, width {vcfg.hidden_dim}, {vcfg.num_heads} heads of "
        f"{vcfg.head_dim}, full attention at {vcfg.fullatt_block_indexes}; LM M-RoPE sections {lm.mrope_sections}; "
        f"vl_total_length {ad.vl_total_length}; {tcfg.num_double_blocks} double blocks")
    if (vcfg.depth, vcfg.hidden_dim, lm.mrope_sections, ad.vl_total_length, tcfg.num_double_blocks) != (
            32, 1280, (16, 24, 24), 1103, QWEN_CUT_BLOCKS):
        fail("[qwen-edit] not the full vision tower, M-RoPE and text length over the cut transformer")
    _vision_scatter_check(ad, data_dir)
    forward, step = _qwen_launches(tcfg.num_double_blocks)

    def check_rollout(samples):
        cond = np.stack([s.extra_kwargs["cond_latents"] for s in samples])
        joint = samples[0].all_latents.shape[-2] + cond.shape[1] + samples[0].prompt_embeds.shape[0]
        log(f"[qwen-edit] condition tokens {cond.shape}, joint length {joint}")
        if not (cond.shape[1:] == (1024, 64) and joint == QWEN_EDIT_S and np.isfinite(cond).all()):
            fail(f"[qwen-edit] the rollout's condition tokens or joint length are not as expected: {cond.shape}")
        _negatives_kept("qwen-edit", samples, (ad.vl_total_length, lm.hidden_dim))

    lora = ad.trainable["transformer"]
    b0 = {p: ab["lora_B"].detach().clone() for p, ab in lora.items()}
    ops.reset_launch_counts()
    run = _grpo_epoch(trainer, "qwen-edit", 0, forward, {}, check_rollout, staged_keys=("cond_latents",),
                      grad_step=step)
    counts = ops.launch_counts()
    if not all("cond_latents" in staged for _, _, staged in run["steps"]):
        fail("[qwen-edit] the grad steps did not stage cond_latents")
    _lora_moved("qwen-edit", lora, b0)
    _wan22_finish(trainer, "qwen-edit", [run], counts,
                  "one Qwen-Image-Edit-Plus grad step (16 double blocks, B 16 x 3151 tokens, remat; LoRA merge, "
                  "forward, backward, AdamW)", QWEN_PEAK_PREDICTED)
    return counts


def _qwen_phases(which=("z-image", "qwen-image", "qwen-edit")) -> dict:
    """[qwen-grad], then [z-image], [qwen-image] and [qwen-edit] (those of
    ``which``), each trainer freed before the next loads; returns the launch
    counts of each phase's epochs by tag."""
    import torch

    phase_qwen_grad()
    phases = {"z-image": phase_z_image, "qwen-image": phase_qwen_image, "qwen-edit": phase_qwen_edit}
    counts = {}
    for tag in which:
        gc.collect()
        torch.cuda.empty_cache()
        counts[tag] = phases[tag]()
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def qwen_only(flags) -> int:
    """``python3 chip_smoke.py --qwen`` (Qwen-Image and Edit-Plus) and/or
    ``--z-image``: the build, [qwen-kernels], [qwen-grad] and the chosen
    phases alone."""
    import torch

    from flow_factory_tpu_torch.utils.base import use_full_fp32

    use_full_fp32()
    phase_environment()
    phase_qwen_kernels({})
    which = (("z-image",) if "--z-image" in flags else ()) + (("qwen-image", "qwen-edit") if "--qwen" in flags else ())
    counts = _qwen_phases(which)
    log(f"[qwen] launches {counts}; device memory still allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return 0


# ---------------------------------------------------------------------------
# FLUX.2-Klein at full size and FLUX.2 at full width (4 + 8 blocks, the
# gated FFN), both conditioned on Mistral-Small, under GRPO
# ---------------------------------------------------------------------------

#: FLUX.2 multi-reference I2I at 512 px: 512 text + 1024 target + 1024
#: condition tokens, 32 heads of 128; Klein's joint length is FLUX.1's 1536
FLUX2_S, KLEIN_S = 2560, 1536
#: K5's LayerNorm form at width 4096: FLUX.2's image + condition rows, its
#: text rows and the single blocks' joint rows, all bf16 -> bf16
FLUX2_K5_SHAPES = tuple(NormShape(tag, 8, S, 4096, "bfloat16", "bfloat16", False, False, False, True)
                        for tag, S in (("flux2-img", 2048), ("flux2-txt", 512), ("flux2-joint", FLUX2_S)))
#: the table's shapes of each kernel and the phases whose launches they take;
#: Klein's K3 shape is FLUX.1's 512 px rollout shape, flux-512px-b8, whose
#: entry also counts the FLUX.1 DPO epochs' launches
FLUX2_TAGS = {
    "flash_fwd": {"flux2-2560-b8": ("flux2",), "flux-512px-b8": ("klein",)},
    **{name: {"flux2-2560": ("flux2",), "klein-1536": ("klein",)}
       for name in ("flash_bwd_dq_d128", "flash_bwd_dkv_d128")},
    **{name: {shape.tag: ("flux2",) for shape in FLUX2_K5_SHAPES} for name in ("ln_mul_add", "ln_mul_add_backward")},
}
#: peak device memory predicted for each phase, GiB (PERF.md §6)
FLUX2_PEAK_PREDICTED = {"klein": (65.0, 73.0), "flux2": (32.0, 40.0)}


def _flux2_launches(num_double: int, num_single: int):
    """Launches of one forward of the FLUX transformer (a K3 a block; four
    K5 a double block, one a single block, norm_out) and of one rematted
    grad step: the blocks recomputed in the backward (norm_out is outside
    them); K2a/K2b for every K3; K5's backward for every K5 but block 0's
    two first norms, whose inputs (the embedded latents and context, the
    AdaLN vectors) are frozen."""
    blocks, norms = num_double + num_single, 4 * num_double + num_single + 1
    forward = {"flash_fwd": blocks, "ln_mul_add": norms, **_NOT_ON_PATH}
    step = {"flash_fwd": 2 * blocks, "flash_bwd_dq": blocks, "flash_bwd_dkv": blocks,
            "ln_mul_add": 2 * norms - 1, "ln_mul_add_backward": norms - 2, **_NOT_ON_PATH}
    return forward, step


def phase_flux2_kernels(results: dict) -> None:
    """[flux2-kernels]: K3 at FLUX.2's B8 H32 S2560 D128, K2a/K2b there (the
    control without Delta) and at Klein's grad-step shape B8 H24 S1536 (the
    control without Delta), K5 and its backward at ``FLUX2_K5_SHAPES``
    (width 4096, the backward's controls on the image rows), through the
    checks, bits and times of the earlier shapes. Klein's K3 shape is
    checked in [flux-kernels]. The entries join the table under the
    ``FLUX2_TAGS``."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    randn = lambda *shape, dtype=torch.bfloat16: torch.randn(
        shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)
    D = 128
    log(f"[flux2-kernels] card (SM clock, max, power, temperature): {gpu_state()}")
    t0 = time.perf_counter()
    q, k, v = (randn(8, 32, FLUX2_S, D) for _ in range(3))
    _k3_shape_checks(results, "flux2-2560-b8", q, k, v, "q/k/v contiguous",
                     functools.partial(_k3_flux_call, 8, 32, FLUX2_S, D))
    del q, k, v
    _k2_d128_shape_checks(results, "flux2-2560", 8, 32, FLUX2_S, FLUX2_S, True, randn)
    _k2_d128_shape_checks(results, "klein-1536", 8, 24, KLEIN_S, KLEIN_S, True, randn)
    for shape in FLUX2_K5_SHAPES:
        _k5_shape_checks(results, gen, shape, shape.tag == "flux2-img")
    log(f"[flux2-kernels] every shape within its tolerance, the controls rejected: 1 K3, 2 K2, "
        f"{len(FLUX2_K5_SHAPES)} K5 shapes, {time.perf_counter() - t0:.1f} s")


def _caption_check(tag: str, ad, prompts) -> None:
    """The caption upsampler twice on the same prompts: the same strings
    (greedy over the card's deterministic kernels), a rewrite for every
    prompt, and the seconds of one call."""
    import torch

    t0 = time.perf_counter()
    first = ad.caption_upsampler(prompts)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    second = ad.caption_upsampler(prompts)
    up = ad.caption_upsampler
    log(f"[{tag}] caption upsampler ({up.max_new_tokens} new tokens over {up.max_length} slots, B {len(prompts)}): "
        f"{first}; the same strings on a second call: {first == second}; {secs:.2f} s a call")
    if first != second or any(a == b for a, b in zip(first, prompts)):
        fail(f"[{tag}] the caption upsampler is not deterministic or left a prompt as it was: {first} / {second}")


#: F18's gate: the rollout's 8 rows replayed in these micro-batches
F18_SPLITS = ((4, 4), (2, 2, 2, 2), (5, 3))


def _microbatch_replay_probe(tag: str, ad, samples, products) -> None:
    """F18's gate: the rollout's rows replayed as the micro-batches of
    ``F18_SPLITS`` (other GEMM shapes than the rollout's), the ratio
    exactly 1.0 on every stored step of each, and the largest |log-ratio|;
    then each of ``products`` ((name, module, input rows)) gives its first 4
    rows the same bits alone as beside the others. Fails otherwise."""
    import numpy as np
    import torch

    lp_map = samples[0].log_prob_index_map
    held, worst = {}, 0.0
    for split in F18_SPLITS:
        ok, start = True, 0
        for size in split:
            part = samples[start:start + size]
            start += size
            old = np.stack([s.log_probs for s in part], axis=1)
            for j, lp in ad.replay_log_probs(part).items():
                d = lp.cpu().numpy().astype(np.float64) - old[lp_map[j]]
                ok &= bool(np.all(np.exp(d) == 1.0))
                worst = max(worst, float(np.abs(d).max()))
        held[" + ".join(map(str, split))] = ok
    same = {}
    with torch.no_grad():
        for name, module, x in products:
            whole, alone = _tensors(module(x)), _tensors(module(x[:4]))
            same[f"{name} ({x.shape[0]} rows x {module.in_features} -> {module.out_features}, {x.dtype})"] = all(
                torch.equal(a[:4], b) for a, b in zip(whole, alone))
    log(f"[{tag}] F18: the {len(samples)} rows replayed as micro-batches of {list(held)}: ratio exactly 1.0 on "
        f"every stored step of each: {list(held.values())}; max |log-ratio| {worst!r}; each product gives its "
        f"first 4 rows the same bits alone as in the batch: {same}")
    if not all(held.values()) or not all(same.values()):
        fail(f"[{tag}] F18: a replay at another micro-batch size is not bit-exact: {held}, {same}")


def _tensors(x) -> list:
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


def _microbatch_grad_probe(tag: str, trainer, samples, split=(5, 3)) -> None:
    """F18's case in the trainer's own grad step: the rollout's rows staged
    by ``grad_step_batches`` as micro-batches of ``split`` (the last one
    partial against the first, both other sizes than the rollout's) and put
    through ``loss_and_grads`` (the training forward with a gradient) at
    every train timestep: GRPO's ratio exactly 1.0 on every row of each.
    The advantages are set to 0 (the ratio does not read them); the
    gradients are dropped. Fails otherwise."""
    import numpy as np

    for s in samples:
        s.extra_kwargs["advantage"] = 0.0
    size0, ratios, start = trainer.micro_batch_size, [], 0
    try:
        for size in split:
            rows = np.arange(start, start + size)
            start += size
            trainer.micro_batch_size = size
            trainer._micro_batches = lambda n, epoch, rows=rows: [rows]
            for batch in trainer.grad_step_batches(samples, 0):
                (_, aux), _ = trainer.loss_and_grads(batch)
                ratios.append((size, float(aux["train/ratio_min"]), float(aux["train/ratio_max"])))
    finally:
        trainer.micro_batch_size = size0
        del trainer._micro_batches
    held = bool(ratios) and all(lo == 1.0 and hi == 1.0 for _, lo, hi in ratios)
    log(f"[{tag}] F18: the {len(samples)} rows through the trainer's grad step as micro-batches of "
        f"{' + '.join(map(str, split))}: (rows, ratio min, ratio max) at each train timestep {ratios}; exactly 1.0 "
        f"on every row: {held}")
    if not held:
        fail(f"[{tag}] F18: a grad step at another micro-batch size is not bit-exact: {ratios}")


def _f18_products(ad, single: str, tokens: int):
    """F18's products on the adapter's transformer at a batch of 8: the
    first double block's AdaLN modulation (the op F18's bisection named:
    fp32, the rows are the batch) on SiLU-like fp32 rows and, where the
    model has single blocks, the first one's bf16 ``linear1`` over
    ``tokens`` tokens a row (a product whose M is the batch times the
    tokens)."""
    import torch

    model = ad.modules["transformer"]
    block = model.transformer_blocks[0]
    mod = block.norm1.linear
    dev = mod.weight.device
    gen = torch.Generator(device=dev).manual_seed(3)
    out = [("transformer_blocks.0.norm1.linear", mod,
            torch.randn(8, mod.in_features, generator=gen, device=dev))]
    blocks = getattr(model, single, None)
    if blocks:
        lin = blocks[0].linear1
        out.append((f"{single}.0.linear1", lin,
                    torch.randn(8, tokens, lin.in_features, generator=gen, device=dev).to(torch.bfloat16)))
    return out


def _flux2_serving(tag: str, ad, ta, batch, forward: dict, **inputs) -> list:
    """A serving rollout of ``batch`` through ``inference`` (the caption
    upsampler and the prompt encode included), its images and launches, and
    its no-grad replay (ratio exactly 1.0); returns the samples."""
    import numpy as np
    import torch

    from flow_factory_tpu_torch import ops

    ops.reset_launch_counts()
    ad.rollout()
    t0 = time.perf_counter()
    samples = ad.inference(prompt=batch, compute_log_prob=True, trajectory_indices="all", seed=ta.seed, **inputs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = {k: n * ta.num_inference_steps for k, n in forward.items()}
    images = np.stack([s.image for s in samples])
    log(f"[{tag}] serving rollout of {len(batch)}: images {images.shape} in [{images.min():.3f}, {images.max():.3f}], "
        f"latents {samples[0].all_latents.shape}, prompt states {samples[0].prompt_embeds.shape}, launches {counts} "
        f"(expected {want}), {secs:.2f} s with the caption upsampler, the encodes and the decode "
        f"({len(batch) / secs:.3f} samples/s)")
    if not (np.isfinite(images).all() and images.shape == (len(batch), 3, ta.height, ta.width)):
        fail(f"[{tag}] the serving rollout's images are not as expected: {images.shape}")
    if any(counts[k] != n for k, n in want.items()):
        fail(f"[{tag}] serving rollout launches {counts}, expected {want}")
    _replay_check(tag, ad, samples, forward)
    return samples


def phase_klein() -> dict:
    """[klein]: FLUX.2-Klein at full size on tests/fixtures/flux2_klein_grpo.yaml
    (8 + 24 blocks at width 3072, the whole Mistral-Small, 512 px: a joint
    length of 1536; 8 steps, guidance 3.5 embedded, B 8; remat; the caption
    upsampler on): the upsampler twice (:func:`_caption_check`), a serving
    rollout of 2 prompts x 4 (32 K3 and 57 K5 a step) and its no-grad
    replay, ratio exactly 1.0 on every stored step, also replayed as two
    micro-batches of 4 (Queue 3's watch); then two GRPO epochs (64 K3, 32
    K2a, 32 K2b, 113 K5 and 55 K5 backwards a grad step, ratio exactly 1.0),
    a moved LoRA, peak memory against ``FLUX2_PEAK_PREDICTED``, a profiled
    grad step. Returns the launch counts of the epochs."""
    from flow_factory_tpu_torch import ops

    here = os.path.dirname(os.path.abspath(__file__))
    trainer = _wan22_load_trainer("klein", _qwen_config("flux2_klein_grpo.yaml"))
    ad, ta = trainer.adapter, trainer.training_args
    tcfg, lm = ad.component_configs["transformer"], ad.component_configs["text_encoder"]
    log(f"[klein] transformer: {tcfg.num_double_blocks} double + {tcfg.num_single_blocks} single blocks, width "
        f"{tcfg.hidden_dim}, {tcfg.num_heads} heads, FFN {tcfg.mlp_style}, pooled {tcfg.pooled_dim}, context "
        f"{tcfg.context_dim}; LM {lm.num_layers} layers, width {lm.hidden_dim}, {lm.num_heads}/{lm.num_kv_heads} "
        f"heads, vocabulary {lm.vocab_size}; the single-adapter route (predicted peak under 74 GiB)")
    if (tcfg.num_double_blocks, tcfg.num_single_blocks, tcfg.hidden_dim, tcfg.pooled_dim, lm.num_layers,
            lm.hidden_dim, tcfg.remat) != (8, 24, 3072, 0, 40, 5120, True) or ad.caption_upsampler is None:
        fail(f"[klein] not the full-size Klein preset with the upsampler under remat: {tcfg}, {lm}")
    forward, step = _flux2_launches(tcfg.num_double_blocks, tcfg.num_single_blocks)
    prompts = _prompts(os.path.join(here, "dataset", "pickscore"))
    _caption_check("klein", ad, prompts)
    samples = _flux2_serving("klein", ad, ta, [p for p in prompts for _ in range(ta.group_size)], forward)
    _microbatch_replay_probe("klein", ad, samples, _f18_products(ad, "single_transformer_blocks", KLEIN_S))
    ad.train()
    del samples
    lora = ad.trainable["transformer"]
    b0 = {p: ab["lora_B"].detach().clone() for p, ab in lora.items()}
    ops.reset_launch_counts()
    runs = [_grpo_epoch(trainer, "klein", epoch, forward, {}, grad_step=step) for epoch in range(ta.max_epochs)]
    counts = ops.launch_counts()
    _lora_moved("klein", lora, b0)
    _wan22_finish(trainer, "klein", runs, counts,
                  "one FLUX.2-Klein grad step (8 + 24 blocks, B 8 x 1536 tokens, remat; LoRA merge, forward, "
                  "backward, AdamW)", FLUX2_PEAK_PREDICTED)
    return counts


def phase_flux2() -> dict:
    """[flux2]: FLUX.2 multi-reference I2I at full width, 4 + 8 blocks with
    the gated FFN and an 8-layer Mistral-Small (tests/fixtures/flux2_cut), on
    tests/fixtures/flux2_grpo.yaml over two records with one 512 px
    reference each (``_kontext_dataset``): 1024 condition tokens a row after
    the 1024 target and 512 text tokens, a joint length of 2560; 10 steps,
    guidance 3.5 embedded, B 8; remat; the caption upsampler on. The
    upsampler twice, a serving rollout of the two records x 4 with their
    references (12 K3 and 25 K5 a step) and its replay, ratio exactly 1.0;
    one GRPO epoch (24 K3, 12 K2a, 12 K2b, 49 K5 and 23 K5 backwards a grad
    step, ratio exactly 1.0, the condition tokens staged into each), a moved
    LoRA, peak memory, a profiled grad step. Returns the launch counts of
    the epoch."""
    import numpy as np

    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.data.dataset import _load_media_fields, load_raw_records

    here = os.path.dirname(os.path.abspath(__file__))
    data_dir = _kontext_dataset(here)
    trainer = _wan22_load_trainer("flux2", _qwen_config("flux2_grpo.yaml", dataset_dir=data_dir))
    ad, ta = trainer.adapter, trainer.training_args
    tcfg, lm = ad.component_configs["transformer"], ad.component_configs["text_encoder"]
    log(f"[flux2] transformer: {tcfg.num_double_blocks} double + {tcfg.num_single_blocks} single blocks, width "
        f"{tcfg.hidden_dim}, {tcfg.num_heads} heads, FFN {tcfg.mlp_style}, RoPE axes {tcfg.axes_dim}, pooled "
        f"{tcfg.pooled_dim}; LM {lm.num_layers} layers, width {lm.hidden_dim}")
    if (tcfg.num_double_blocks, tcfg.num_single_blocks, tcfg.hidden_dim, tcfg.mlp_style, tcfg.pooled_dim,
            lm.num_layers, lm.hidden_dim, tcfg.remat) != (4, 8, 4096, "swiglu", 0, 8, 5120, True):
        fail(f"[flux2] not the cut FLUX.2 preset with the gated FFN under remat: {tcfg}, {lm}")
    forward, step = _flux2_launches(tcfg.num_double_blocks, tcfg.num_single_blocks)
    recs = [_load_media_fields(r, data_dir) for r in load_raw_records(os.path.join(data_dir, "train.jsonl"))]
    _caption_check("flux2", ad, [r["prompt"] for r in recs])
    _flux2_serving("flux2", ad, ta, [r["prompt"] for r in recs for _ in range(ta.group_size)], forward,
                   images=[r["images"] for r in recs for _ in range(ta.group_size)])
    ad.train()

    def check_rollout(samples):
        cond = np.stack([s.extra_kwargs["cond_latents"] for s in samples])
        joint = samples[0].all_latents.shape[-2] + cond.shape[1] + samples[0].prompt_embeds.shape[0]
        log(f"[flux2] condition tokens {cond.shape}, joint length {joint}")
        if not (cond.shape[1:] == (1024, 64) and joint == FLUX2_S and np.isfinite(cond).all()):
            fail(f"[flux2] the rollout's condition tokens or joint length are not as expected: {cond.shape}")

    lora = ad.trainable["transformer"]
    b0 = {p: ab["lora_B"].detach().clone() for p, ab in lora.items()}
    ops.reset_launch_counts()
    run = _grpo_epoch(trainer, "flux2", 0, forward, {}, check_rollout, staged_keys=("cond_latents",),
                      grad_step=step)
    counts = ops.launch_counts()
    if not all("cond_latents" in staged for _, _, staged in run["steps"]):
        fail("[flux2] the grad steps did not stage cond_latents")
    _lora_moved("flux2", lora, b0)
    _wan22_finish(trainer, "flux2", [run], counts,
                  "one FLUX.2 grad step (8 + 16 blocks at width 4096, gated FFN, B 8 x 2560 tokens, remat; LoRA "
                  "merge, forward, backward, AdamW)", FLUX2_PEAK_PREDICTED)
    return counts


def _flux2_phases() -> dict:
    """[klein] then [flux2], each trainer freed before the next loads;
    returns the launch counts of each phase's epochs by tag."""
    import torch

    counts = {}
    for tag, phase in (("klein", phase_klein), ("flux2", phase_flux2)):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        counts[tag] = phase()
        log(f"[{tag}] phase seconds {time.perf_counter() - t0:.1f} (load and preprocess included)")
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def flux2_only() -> int:
    """``python3 chip_smoke.py --flux2``: the build, [flux2-kernels],
    [klein] and [flux2] alone."""
    import torch

    from flow_factory_tpu_torch.utils.base import use_full_fp32

    use_full_fp32()
    phase_environment()
    phase_flux2_kernels({})
    counts = _flux2_phases()
    log(f"[flux2] launches {counts}; device memory still allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return 0


# ---------------------------------------------------------------------------
# The decoupled trainers on LTX-2, Wan2.2 and the Qwen-conditioned families
# ---------------------------------------------------------------------------

def _add(*counts) -> dict:
    return {k: sum(c.get(k, 0) for c in counts) for k in set().union(*counts)}


def _mul(counts: dict, n: int) -> dict:
    return {k: n * v for k, v in counts.items()}


def _family_launches(family: str, ad):
    """(one forward's launches, one grad step's forward and backward) of the
    phase's transformer (a rematted grad step runs its blocks twice)."""
    tcfg = ad.component_configs["transformer"]
    if family == "ltx2":
        forward, both, _ = _ltx2_launches(tcfg.num_layers)  # the decoupled losses reach both streams
        return forward, _add(forward, both)
    if family == "wan":
        forward, backward = _wan_launches(tcfg.num_layers)
        return forward, _add(forward, backward)
    if family == "z-image":
        return _z_image_launches(tcfg.num_layers)
    return _qwen_launches(tcfg.num_double_blocks)


#: −log σ(0) in fp32, DPO's loss where θ is the reference
_LOG2_FP32 = 0.6931471824645996
#: the step-0 invariants of each trainer, held on every grad step of epoch 0
#: (θ = the sampling policy = every snapshot = the zero LoRA = the
#: reference; the optimizer steps once, after all of them)
DECOUPLED_INVARIANTS = {
    "nft": lambda a: a["train/positive_loss"] == a["train/negative_loss"],
    "awm": lambda a: a["train/ratio_mean"] == 1.0 and a["train/clip_frac"] == 0.0,
    "dpo": lambda a: a["train/loss"] == _LOG2_FP32 and a["train/implicit_margin"] == 0.0,
    "dgpo": lambda a: (a["train/pref_mean"], a["train/group_weight_mean"], a["train/kl"],
                       a["train/clip_ratio"]) == (0.0, 0.5, 0.0, 0.0),
    "crd": lambda a: (a["train/r_theta_mean"], a["train/old_deviate"], a["train/kl"]) == (0.0, 0.0, 0.0),
}
#: the decoupled phases: fixture, family, the trainer's frozen forwards and
#: forwards with a gradient a grad step, the dataset maker, the predicted
#: peak (GiB, PERF.md §6)
FAMILY_PHASES = {
    "ltx2-nft": dict(fixture="ltx2_t2av_nft.yaml", family="ltx2", frozen=1, grads=1, peak=(45.0, 52.0)),
    "ltx2-i2av-dpo": dict(fixture="ltx2_i2av_dpo.yaml", family="ltx2", frozen=2, grads=2, peak=(35.0, 48.0),
                          data=_ltx2_i2av_dataset),
    "wan22-moe-awm": dict(fixture="wan22_a14b_awm.yaml", family="wan", frozen=1, grads=1, peak=(32.0, 42.0)),
    "wan22-ti2v-dgpo": dict(fixture="wan22_ti2v_dgpo.yaml", family="wan", frozen=2, grads=1, peak=(45.0, 58.0),
                            data=lambda root: _wan22_image_dataset(root, "wan22_image_data_256", 256)),
    "z-image-crd": dict(fixture="z_image_crd.yaml", family="z-image", frozen=2, grads=1, peak=(26.0, 33.0)),
    "qwen-image-nft": dict(fixture="qwen_image_nft.yaml", family="qwen", frozen=1, grads=1, peak=(37.0, 41.0)),
    "qwen-edit-awm": dict(fixture="qwen_image_edit_plus_awm.yaml", family="qwen", frozen=1, grads=1,
                          peak=(45.0, 49.0), data=_kontext_dataset),
}


#: the rows of a decoupled phase's F18 rollout, and of its replay
F18_ROLLOUT_ROWS, F18_REPLAY_ROWS = 4, 2


def _first_inference(ad):
    """A spy on ``ad.inference`` that keeps the keyword arguments of its
    first call and passes every call on as it came; returns (the kept
    calls, the undo)."""
    inference = ad.inference
    calls: list = []

    def spy(*args, **kwargs):
        if not calls:
            calls.append(dict(kwargs))
        return inference(*args, **kwargs)

    ad.inference = spy
    return calls, lambda: delattr(ad, "inference")


def _first_rows(kwargs: dict, n: int) -> dict:
    """Inference arguments cut to their batch's first ``n`` rows: every list,
    array or tensor that leads with the batch of ``prompt``."""
    B = len(kwargs["prompt"])
    leads = lambda v: (len(v) == B if isinstance(v, (list, tuple))
                       else getattr(v, "ndim", 0) > 0 and v.shape[0] == B)
    return {k: v[:n] if leads(v) else v for k, v in kwargs.items()}


def _f18_rows_replay(tag: str, ad, kwargs: dict, forward: dict, secs: dict):
    """F18's case: a rollout of the first ``F18_ROLLOUT_ROWS`` rows of the
    inference call ``kwargs`` that keeps every step and its log-prob (one
    forward's launches a step), its rows 0-1 replayed without a gradient (a
    micro-batch of 2 against 4) with ratio exactly 1.0 on every stored step;
    the adapter back in train mode. Returns the launch counts of the rollout
    and of the replay."""
    import torch

    from flow_factory_tpu_torch import ops

    ta = ad.training_args
    ad.rollout()
    kwargs = {k: v for k, v in _first_rows(kwargs, F18_ROLLOUT_ROWS).items() if k != "generator"}
    before = ops.launch_counts()
    t0 = time.perf_counter()
    kept = ad.inference(**{**kwargs, "compute_log_prob": True, "trajectory_indices": "all", "seed": ta.seed})
    torch.cuda.synchronize()
    secs[f"F18 rollout of {F18_ROLLOUT_ROWS}"] = time.perf_counter() - t0
    f18_rollout = {k: v - before[k] for k, v in ops.launch_counts().items()}
    want = _mul(forward, ta.num_inference_steps)
    log(f"[{tag}] F18: a rollout of the batch's first {len(kept)} rows keeping every step, launches {f18_rollout} "
        f"(expected {want}), {secs[f'F18 rollout of {F18_ROLLOUT_ROWS}']:.2f} s; its rows 0-1 replayed:")
    if len(kept) != F18_ROLLOUT_ROWS or any(f18_rollout[k] != n for k, n in want.items()):
        fail(f"[{tag}] the F18 rollout: {len(kept)} rows, launches {f18_rollout}, expected {want}")
    t0 = time.perf_counter()
    replayed = _replay_check(tag, ad, kept[:F18_REPLAY_ROWS], forward)
    secs[f"replay of {F18_REPLAY_ROWS} rows"] = time.perf_counter() - t0
    ad.train()
    return f18_rollout, replayed


def phase_decoupled_family(tag: str) -> dict:
    """One epoch of a decoupled trainer on its family at the width of the
    family's GRPO phase (``FAMILY_PHASES``), through ``load_trainer``: the
    trainer's own rollout (the final latent alone, no log-probs; finite
    media, one forward's launches a step); F18's case on a rollout of the
    first ``F18_ROLLOUT_ROWS`` rows of the same batch that keeps every step
    and its log-prob, its rows 0-1 replayed without a gradient (a
    micro-batch of 2 against 4) with ratio exactly 1.0 on every stored step
    (this rollout's launches join the phase's); the optimize phase with
    every grad step recorded: the trainer's step-0 invariants
    (``DECOUPLED_INVARIANTS``) on each, finite losses, a non-zero LoRA
    gradient on the component each reaches (on the MoE the expert of the
    step's host timestep alone, both over the epoch), the launches predicted
    a grad step (frozen forwards x one forward + forwards with a gradient x
    the grad step), no read of the timestep from the device for routing; a
    moved LoRA, peak memory against the prediction and seconds. Returns the
    launch counts of the rollout, the replay and the optimize phase."""
    import numpy as np
    import torch

    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.models.wan.t2v import WanT2VAdapter

    spec = FAMILY_PHASES[tag]
    here = os.path.dirname(os.path.abspath(__file__))
    data = {"dataset_dir": spec["data"](here)} if "data" in spec else {}
    t_phase = time.perf_counter()
    if spec["family"] == "ltx2":
        _, trainer = _ltx2_load(spec["fixture"], tag, **data)
    else:
        config = _qwen_config if spec["family"] in ("qwen", "z-image") else _wan22_config
        trainer = _wan22_load_trainer(tag, config(spec["fixture"], **data))
    ad, ta = trainer.adapter, trainer.training_args
    kind = ta.trainer_type.lower()
    forward, grad_step = _family_launches(spec["family"], ad)
    per_step = _add(_mul(forward, spec["frozen"]), _mul(grad_step, spec["grads"]))
    lora = ad.trainable
    b0 = {c: {p: ab["lora_B"].detach().clone() for p, ab in t.items()} for c, t in lora.items()}
    log(f"[{tag}] {type(trainer).__name__} on {type(ad).__name__}: remat "
        f"{ad.component_configs['transformer'].remat}, {ta.get_num_train_timesteps(trainer.config)} train timesteps, "
        f"B {ta.per_device_batch_size}; predicted launches a rollout step {forward}, a grad step {per_step}")
    trainer.epoch = 0
    trainer.scheduler.set_seed(ta.seed)
    WanT2VAdapter.route_reads = 0
    ops.reset_launch_counts()
    secs = {}
    calls, undo = _first_inference(ad)
    t0 = time.perf_counter()
    try:
        samples = trainer.sample(0)
        torch.cuda.synchronize()
    finally:
        undo()
    secs["rollout"] = time.perf_counter() - t0
    in_sample = ops.launch_counts()
    batches = -(-len(samples) // ta.per_device_batch_size)
    want = _mul(forward, ta.num_inference_steps * batches)
    media = np.stack([s.video if s.video is not None else s.image for s in samples])
    log(f"[{tag}] the trainer's rollout of {len(samples)} (compute_log_prob {calls[0]['compute_log_prob']}, "
        f"trajectory {calls[0]['trajectory_indices']}): media {media.shape} in [{media.min():.3f}, "
        f"{media.max():.3f}], stored latents {samples[0].all_latents.shape}, launches {in_sample} (expected {want}), "
        f"{secs['rollout']:.2f} s")
    if not (np.isfinite(media).all() and media.shape[-2:] == (ta.height, ta.width)):
        fail(f"[{tag}] the rollout's media are not as expected: {media.shape}")
    if any(in_sample[k] != n for k, n in want.items()):
        fail(f"[{tag}] rollout launches {in_sample}, expected {want}")
    if spec["family"] == "ltx2":
        waves = np.stack([s.audio for s in samples])
        log(f"[{tag}] waveforms {waves.shape}, audio latents {samples[0].extra_kwargs['audio_all_latents'].shape}")
        if not np.isfinite(waves).all():
            fail(f"[{tag}] the rollout's waveforms are not finite")
    f18_rollout, replayed = _f18_rows_replay(tag, ad, calls[0], forward, secs)
    metrics = trainer.prepare_feedback(samples)
    steps: list = []
    auxes: list = []
    loss_fn = trainer.loss_fn

    streams: list = []

    def recording_loss_fn(trainable, batch, *args):
        loss, aux = loss_fn(trainable, batch, *args)
        auxes.append(dict(aux))
        streams.append(sorted(batch["chosen" if kind == "dpo" else "clean"]))
        return loss, aux

    trainer.loss_fn = recording_loss_fn
    undo = _grad_recorder(trainer, steps)
    before = ops.launch_counts()
    t0 = time.perf_counter()
    try:
        info = trainer.optimize(samples, 0)
        torch.cuda.synchronize()
    finally:
        undo()
        del trainer.loss_fn
    secs["optimize"] = time.perf_counter() - t0
    _live_components(steps)
    in_optimize = {k: v - before[k] for k, v in ops.launch_counts().items()}
    auxes = [{k: float(v) for k, v in a.items()} for a in auxes]
    want = _mul(per_step, len(steps))
    shown = {k: [round(a[k], 6) for a in auxes] for k in sorted(auxes[0])} if auxes else {}
    log(f"[{tag}] reward mean {metrics['reward/mean']:.5f}; {len(steps)} grad steps (host t, components with a "
        f"non-zero LoRA gradient): {[(round(t, 2), live) for t, live, _ in steps]}; aux {shown}; loss "
        f"{info['train/loss']:.4e}, grad_norm {info['train/grad_norm']:.4e}; launches in optimize {in_optimize} "
        f"(expected {want}); global step {trainer.global_step}; device reads of the timestep for routing "
        f"{WanT2VAdapter.route_reads}")
    want_streams = sorted(ad.decoupled_latent_keys)
    log(f"[{tag}] the latent streams of every grad step's tree: {streams[0] if streams else None} (expected "
        f"{want_streams} on each)")
    if any(st != want_streams for st in streams):
        fail(f"[{tag}] a grad step's latent tree lacks a stream: {streams}")
    moe = len(lora) == 2
    reached = [["transformer_2" if ad.routes_high(t) else "transformer"] if moe else sorted(lora)
               for t, _, _ in steps]
    if not steps or any(live != want_live for (_, live, _), want_live in zip(steps, reached)):
        fail(f"[{tag}] the grad steps' non-zero LoRA gradients {steps} are not on {reached}")
    if moe and {c for live in reached for c in live} != {"transformer", "transformer_2"}:
        fail(f"[{tag}] not both experts trained in the epoch: {steps}")
    if not all(DECOUPLED_INVARIANTS[kind](a) for a in auxes):
        fail(f"[{tag}] the {kind} step-0 invariants do not hold on every grad step of epoch 0: {auxes}")
    if not (np.isfinite(info["train/grad_norm"]) and info["train/grad_norm"] > 0
            and all(np.isfinite(v) for a in auxes for v in a.values())):
        fail(f"[{tag}] a loss or the grad norm is not finite and positive: {info}")
    if any(in_optimize[k] != n for k, n in want.items()):
        fail(f"[{tag}] launches in optimize {in_optimize}, expected {want}")
    if WanT2VAdapter.route_reads or trainer.global_step != 1:
        fail(f"[{tag}] {WanT2VAdapter.route_reads} device reads for routing, global step {trainer.global_step}")
    moved = {c: max((lora[c][p]["lora_B"] - b).abs().max().item() for p, b in t.items()) for c, t in b0.items()}
    if not all(v > 0 for v in moved.values()):
        fail(f"[{tag}] a trained component's LoRA did not move: {moved}")
    counts = _add(in_sample, f18_rollout, replayed, in_optimize)
    peak = torch.cuda.max_memory_allocated() / 2**30
    lo, hi = spec["peak"]
    grad_s = secs["optimize"] / len(steps)
    log(f"[{tag}] {card_name()}: peak memory {peak:.2f} GiB (predicted {lo:.0f}-{hi:.0f} GiB: "
        f"{'inside' if lo <= peak <= hi else 'outside'}); seconds {json.dumps({k: round(v, 3) for k, v in secs.items()})}"
        f", {grad_s:.3f} s a grad step (its frozen forwards and the optimizer step included); LoRA B max|change| "
        f"{moved}; launches {counts}")
    trainer.cleanup()
    log(f"[{tag}] phase seconds {time.perf_counter() - t_phase:.1f} (load and preprocess included)")
    return counts


def _decoupled_family_phases() -> dict:
    """Every phase of ``FAMILY_PHASES``, each trainer freed before the next
    loads: {tag: launch counts}."""
    import torch

    out = {}
    for tag in FAMILY_PHASES:
        gc.collect()
        torch.cuda.empty_cache()
        out[tag] = phase_decoupled_family(tag)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def decoupled_families_only() -> int:
    """``python3 chip_smoke.py --decoupled-families``: the build and the
    phases of ``FAMILY_PHASES`` alone."""
    import torch

    from flow_factory_tpu_torch.utils.base import use_full_fp32

    use_full_fp32()
    phase_environment()
    counts = _decoupled_family_phases()
    log(f"[decoupled-families] launches {counts}; device memory still allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return 0


# ---------------------------------------------------------------------------
# Full finetuning: SD3.5-M under GRPO and Wan2.1-1.3B under DPO at full width
# ---------------------------------------------------------------------------

#: launches of one SD3.5-M full-finetune grad step under per-block remat:
#: the blocks' K1 (37), K5 (61: all but ``norm_out``) and K6 (47) run twice,
#: in the forward and in the recompute, ``norm_out``'s K5 once; every K5 has
#: a backward node now (block 0's three norms read the trained patch and
#: context embeddings and AdaLN weights): 62
SD35_FULL_A_STEP = {"qknorm_flash_fwd": 74, "flash_bwd_dq": 37, "flash_bwd_dkv": 37, "ln_mul_add": 123,
                    "residual_gate_modulate": 94, "ln_mul_add_backward": 62, "residual_gate_modulate_backward": 47}
#: launches of one Wan2.1-1.3B full DPO grad step: θ and the reference on
#: the chosen and the rejected latents (four forwards of ``WAN_FORWARD``),
#: one backward through θ's two; every K5 has a backward node now (block 0's
#: first norm reads the trained patch and time embeddings): 2 x 91
WAN_FULL_DPO_A_STEP = {"flash_fwd": 240, "flash_bwd_dq": 120, "flash_bwd_dkv": 120, "ln_mul_add": 364,
                       "ln_mul_add_backward": 182}
#: launches of one Wan2.1-1.3B full-finetune forward with its backward (no
#: remat): a forward of ``WAN_FORWARD``, a K2a/K2b pair an attention, every
#: K5 with a backward node
WAN_FULL_A_STEP = {"flash_fwd": 60, "flash_bwd_dq": 60, "flash_bwd_dkv": 60, "ln_mul_add": 91,
                   "ln_mul_add_backward": 91}
#: [full-grad]'s per-leaf bars by the kind of weight (:func:`_full_grad_kind`),
#: from the rounding observed on an H100 80GB HBM3 at 700 W (both paths run the same math in
#: bf16 but round in other places, which the backward carries into every
#: weight): the worst weight 1.21e-2, bias 9.1e-3, qk-norm scale 1.28e-2,
#: position grid 8.3e-3, so the LoRA check's 3e-2 for every kind. A key
#: projection's bias is held to the max of its weight's gradient: the bias's
#: own gradient, a sum over every key of terms the size of the weight's,
#: nearly cancels (the softmax is blind to a shift shared by all keys but
#: for the qk-norm) and read 5.03e-2 of its own max
FULL_GRAD_BARS = {"weight": 3e-2, "bias": 3e-2, "key bias": 3e-2, "qk-norm scale": 3e-2, "pos_embed": 3e-2}
#: [full-grad]'s second bar of a key projection's bias, on its own scale
#: (its error over the max of its own plain gradient): there a gradient of
#: zeros reads exactly 1 at any seed, so a bar of 1/5 has zeros read 5x it by
#: construction; the right backward reads the kernels' bf16 rounding of the
#: per-row key gradients, summed over the B x S rows of a sum that nearly
#: cancels (PERF.md §6 gives the argument). It holds beside the weight-scale
#: bar above, which stays.
FULL_KEY_BIAS_OWN_BAR = 1 / 5
#: device memory peaks predicted before the first run (PERF.md §6)
FULL_PEAK_PREDICTED = {"full-sd35": (48.0, 58.0), "full-wan-dpo": (30.0, 40.0),
                       "full-nft-sd35": (46.0, 50.0), "full-awm-sd35": (46.0, 50.0), "full-dgpo-sd35": (64.0, 69.0),
                       "full-crd-wan": (55.0, 64.0), "full-sd35 evaluate": (38.0, 44.0)}
#: the seconds predicted before the first run (PERF.md §6): a grad step (the
#: trainer's ``backward_step``: the forwards with and without a gradient in
#: it, the backward into ``.grad``), the update (the clip and AdamW), each
#: store's blend after it, ``evaluate``
FULL_SECONDS_PREDICTED = {"full-nft-sd35": {"grad step": (0.6, 0.95), "update": (0.13, 0.2)},
                          "full-awm-sd35": {"grad step": (0.6, 0.95), "update": (0.13, 0.2)},
                          "full-dgpo-sd35": {"grad step": (0.35, 0.7), "update": (0.13, 0.2),
                                             "ema_ref blend": (0.03, 0.1)},
                          "full-crd-wan": {"grad step": (0.25, 0.5), "update": (0.08, 0.12),
                                           "snapshots": (0.04, 0.13)},
                          "full-sd35 evaluate": {"evaluate": (1.5, 3.5)}}
#: the frozen components offloaded to the host after preprocessing
_SD35_ENCODERS, _UMT5 = ("text_encoder", "text_encoder_2", "text_encoder_3"), ("text_encoder",)
FULL_OFFLOADED = {"full-sd35": _SD35_ENCODERS, "full-wan-dpo": _UMT5, "full-nft-sd35": _SD35_ENCODERS,
                  "full-awm-sd35": _SD35_ENCODERS, "full-dgpo-sd35": _SD35_ENCODERS, "full-crd-wan": _UMT5}
#: the full-finetune phases of the decoupled trainers: the fixture, the
#: family and the forwards without a gradient a grad step (the old policy's,
#: the reference's for the KL)
FULL_DECOUPLED_PHASES = {
    "full-nft-sd35": dict(fixture="sd35_full_nft.yaml", family="sd35", frozen=1),
    "full-awm-sd35": dict(fixture="sd35_full_awm.yaml", family="sd35", frozen=1),
    "full-dgpo-sd35": dict(fixture="sd35_full_dgpo.yaml", family="sd35", frozen=2),
    "full-crd-wan": dict(fixture="wan21_full_crd.yaml", family="wan", frozen=2),
}


def _sd35_zero_grad(depth: int) -> set:
    """The SD3.5 weights whose gradient is exactly zero in both packages (F4's
    kind): the last block is context-pre-only, so its context queries and
    their qk-norm scale feed no output (tests/test_torch_port_full.py holds
    the tiny SD3.5's list to JAX's)."""
    b = f"transformer_blocks.{depth - 1}.attn"
    return {f"{b}.add_q_proj.weight", f"{b}.add_q_proj.bias", f"{b}.norm_added_q.weight"}


def _full_grad_kind(name: str) -> str:
    """The kind of an SD3.5 weight for [full-grad]'s bars: the key
    projections' biases (a bias shared by every key, which the softmax
    cancels but for the qk-norm, so their gradient is small beside its
    rounding: held to their weight's scale), the other biases, the qk-norm scales, the position grid, and
    the weights."""
    if "pos_embed.pos_embed" in name:
        return "pos_embed"
    if re.search(r"\.(norm_q|norm_k|norm_added_q|norm_added_k)\.weight$", name):
        return "qk-norm scale"
    if re.search(r"\.(to_k|add_k_proj)\.bias$", name):
        return "key bias"
    return "bias" if name.endswith(".bias") else "weight"


def _old_update(optimizer, params, grads, max_norm: float) -> None:
    """The update as the port ran it before per-leaf clipping: the clipped
    gradients built beside the raw ones by ``torch.where``, then the
    optimizer's step (a reference for ``[full-grad]``'s bit check)."""
    import torch

    gnorm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
    keep = gnorm < max_norm
    for p, g in zip(params, grads):
        p.grad = torch.where(keep, g, g / gnorm * max_norm).to(p.dtype)
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)


def phase_full_grad(seed: int = 3) -> None:
    """[full-grad]: the full-finetune gradient of every weight through the
    kernels at SD3.5-M width, reduced depth (two MMDiT-X blocks, the first
    with the dual self-attention, the second context-pre-only; weights
    and inputs drawn from ``seed``), B=16, 1024
    image + 333 context tokens: the fp32 master of every parameter (the
    position grid, and the qk-norm scales, whose gradient K1's backward
    gives), against the same gradient through the plain path
    (:func:`_grad_paths_check`; the bar from the rounding observed), each key
    projection's bias also within ``FULL_KEY_BIAS_OWN_BAR`` of its own max;
    the controls K1's backward with dγ zeroed, K5's backward without dmul
    and the dual block's ``attn2.to_k.bias`` without dk's sum over the rows
    (a gradient of zeros) must miss it. The context-pre-only block's context
    queries have exact zeros on both paths and every other weight a non-zero
    gradient. Then the
    update on these gradients, twice (the clip binding, then not): the
    port's (in-place clip a leaf at a time, AdamW's grouped path over
    parameter groups of at most ``GROUP_BYTES``) gives the θ of the
    update as it was (``torch.where`` clip, one group) bit for bit, each
    with its peak; whether AdamW's per-tensor and fused paths would is
    logged."""
    import dataclasses
    import types

    import torch
    from torch.func import functional_call

    from flow_factory_tpu_torch.models.layers import build_module
    from flow_factory_tpu_torch.models.sd3.adapter import _preset
    from flow_factory_tpu_torch.models.sd3.transformer import SD3Transformer
    from flow_factory_tpu_torch.ops import attention as A
    from flow_factory_tpu_torch.ops import norms as N
    from flow_factory_tpu_torch.trainers.abc import GROUP_BYTES, apply_updates, make_optimizer

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg = dataclasses.replace(_preset("medium", "auto", "bfloat16")["transformer"], depth=2,
                              dual_attention_layers=(0,))
    model = build_module(lambda: SD3Transformer(cfg), dev, torch.bfloat16, gen)
    masters = {name: p.detach().float().requires_grad_() for name, p in model.named_parameters()}
    names = sorted(masters)
    leaves = [masters[n] for n in names]
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
    B = 16
    x = randn(B, 64, 64, cfg.in_channels)
    ctx, pooled = randn(B, 333, cfg.context_dim), randn(B, cfg.pooled_dim)
    t = torch.full((B,), 750.0, device=dev)
    real_k1_backward = A.qknorm_flash_backward

    def k1_without_dgamma(*args, **kwargs):
        dq, dk, dv, dgq, dgk = real_k1_backward(*args, **kwargs)
        zero = lambda g: None if g is None else torch.zeros_like(g)
        return dq, dk, dv, zero(dgq), zero(dgk)

    class DroppedSum(torch.autograd.Function):
        """The identity, whose backward drops what reaches it: on a key
        projection's bias, the sum over the rows of dk that is its gradient."""

        @staticmethod
        def forward(ctx, bias):
            return bias.view_as(bias)

        @staticmethod
        def backward(ctx, grad):
            return torch.zeros_like(grad)

    dual_key_bias = "transformer_blocks.0.attn2.to_k.bias"

    @contextlib.contextmanager
    def without_bias_sum():
        real = masters[dual_key_bias]
        masters[dual_key_bias] = DroppedSum.apply(real)
        try:
            yield
        finally:
            masters[dual_key_bias] = real

    without_dmul, _ = _k5_backward_controls(N)
    controls = {"K1's backward with dγ zeroed": lambda: _swapped(A, qknorm_flash_backward=k1_without_dgamma),
                "K5's backward without its dmul term": lambda: _swapped(N, ln_mul_add_backward=without_dmul),
                f"{dual_key_bias} without dk's sum over the rows": without_bias_sum}
    kinds = [_full_grad_kind(n) for n in names]
    scale_by = [names.index(n[:-len("bias")] + "weight") if k == "key bias" else i
                for i, (n, k) in enumerate(zip(names, kinds))]
    keys = [i for i, k in enumerate(kinds) if k == "key bias"]
    errs, kern, plain, counts = _grad_paths_check(
        "full-grad", f"SD3.5-M width, depth 2 (dual block 0), B={B}, S=1357, every weight, seed {seed}", model,
        names, leaves, lambda: functional_call(model, masters, (x.bfloat16(), t, ctx, pooled)), x, gen, controls,
        [FULL_GRAD_BARS[k] for k in kinds], kind="full-finetune", scale_by=scale_by, kinds=kinds,
        own={i: FULL_KEY_BIAS_OWN_BAR for i in keys})
    on_weight = {names[i]: float(f"{errs[i]:.3e}") for i in keys}
    on_own = {names[i]: float(f"{((kern[i] - plain[i]).abs().max() / plain[i].abs().max()).item():.3e}")
              for i in keys}
    as_zeros = {names[i]: float(f"{(plain[i].abs().max() / plain[scale_by[i]].abs().max()).item():.3e}")
                for i in keys}
    log(f"[full-grad] the key biases' error over their weight's max gradient (the first bar's scale) {on_weight}, "
        f"over their own max gradient (the second's, bar {FULL_KEY_BIAS_OWN_BAR:.1e}) {on_own}; a gradient of zeros "
        f"would read {as_zeros} on the first scale and 1 on the second: "
        f"{json.dumps({names[i]: round(1 / FULL_KEY_BIAS_OWN_BAR, 2) for i in keys})} x the second bar")
    by_kind = collections.defaultdict(float)
    for kind, e in zip(kinds, errs):
        by_kind[kind] = max(by_kind[kind], e)
    top = sorted(range(len(errs)), key=errs.__getitem__)[-8:]
    log(f"[full-grad] the 8 largest per-leaf errors: {[(names[i], float(f'{errs[i]:.3e}')) for i in top]}")
    zero = {n for n, g, r in zip(names, kern, plain) if not g.any().item() and not r.any().item()}
    dead = sorted(n for n, g in zip(names, kern) if not g.any().item())
    log(f"[full-grad] worst per-leaf error by kind {json.dumps({k: float(f'{v:.3e}') for k, v in by_kind.items()})}; "
        f"pos_embed grad max {kern[names.index('pos_embed.pos_embed')].abs().max().item():.3e}; exactly zero on both "
        f"paths: {sorted(zero)} (expected {sorted(_sd35_zero_grad(cfg.depth))}); zero on the kernel path alone: "
        f"{sorted(set(dead) - zero)}")
    if zero != _sd35_zero_grad(cfg.depth) or set(dead) != zero:
        fail(f"[full-grad] the weights with a zero gradient are not the context-pre-only block's context queries")
    if any(counts[k] <= 0 for k in SD35_KERNELS):
        fail(f"a kernel never launched in the [full-grad] run: {counts}")

    ta = types.SimpleNamespace(learning_rate=1e-5, adam_betas=(0.9, 0.999), adam_epsilon=1e-8,
                               adam_weight_decay=1e-4)
    hyper = dict(lr=ta.learning_rate, betas=ta.adam_betas, eps=ta.adam_epsilon, weight_decay=ta.adam_weight_decay)
    copies = {key: [p.detach().clone().requires_grad_() for p in leaves]
              for key in ("before", "port", "per-tensor", "fused")}
    opts = {"before": torch.optim.AdamW(copies["before"], **hyper),
            "port": make_optimizer(copies["port"], ta),
            "per-tensor": torch.optim.AdamW(copies["per-tensor"], foreach=False, **hyper),
            "fused": torch.optim.AdamW(copies["fused"], fused=True, **hyper)}
    grad_norm = torch.sqrt(sum(torch.sum(g * g) for g in kern)).item()
    peaks, same = collections.defaultdict(list), collections.defaultdict(list)
    for max_norm in (grad_norm / 4, grad_norm * 4):  # the clip binding, then not
        for key, params in copies.items():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            if key == "before":
                _old_update(opts[key], params, [g.clone() for g in kern], max_norm)
            else:  # each gradient in its leaf's layout, as the backward leaves it in .grad
                for p, g in zip(params, kern):
                    p.grad = torch.empty_like(p).copy_(g)
                apply_updates(opts[key], params, max_norm)
            torch.cuda.synchronize()
            peaks[key].append(round((torch.cuda.max_memory_allocated() - base) / 2**30, 3))
        for key in ("port", "per-tensor", "fused"):
            same[key].append(all(torch.equal(a.detach(), b.detach()) for a, b in zip(copies["before"], copies[key])))
    log(f"[full-grad] the update on these gradients ({sum(p.numel() for p in leaves) / 1e6:.1f} M fp32 weights, "
        f"{len(leaves)} leaves; max_grad_norm {grad_norm / 4:.4e}, then {grad_norm * 4:.4e}): θ equal bit for bit to "
        f"the update as it was (torch.where clip, AdamW's grouped path, one group), with the in-place clip and AdamW "
        f"grouped in {len(opts['port'].param_groups)} groups of at most {GROUP_BYTES / 2**20:.0f} MiB (the "
        f"port's): {same['port']}, per-tensor: {same['per-tensor']}, fused: {same['fused']}; GiB allocated above "
        f"the state by each step (the first makes the moments) {json.dumps(dict(peaks))}")
    if not all(same["port"]):
        fail("[full-grad] the port's update does not give the θ of the update as it was")
    del copies, opts
    del model, masters, leaves, kern, plain
    gc.collect()
    torch.cuda.empty_cache()


def _leaf_fingerprints(tree: dict) -> dict:
    """Each tensor's float64 sum and sum of magnitudes, on the device."""
    import torch

    with torch.no_grad():
        return {name: torch.stack([t.double().sum(), t.double().abs().sum()]) for name, t in tree.items()}


def _bits(tree: dict) -> dict:
    """Each fp32 tensor's bit patterns summed, and their squares summed, as
    int64 on the device (integer sums wrap, in any order the same): a change
    of any bit changes them."""
    import torch

    with torch.no_grad():
        out = {}
        for name, t in tree.items():
            b = t.detach().reshape(-1).view(torch.int32).long()
            out[name] = torch.stack([b.sum(), (b * b).sum()])
        return out


def _same_bits(a: dict, b: dict) -> bool:
    import torch

    return set(a) == set(b) and all(torch.equal(a[n], b[n]) for n in a)


def _full_trainer(tag: str, fixture: str):
    """``load_trainer`` on ``fixture`` (full finetuning), then the frozen
    encoders offloaded to the host
    (``offload_component``): logs the master tree's size, the bytes of the
    module copy its release freed and of the encoders the offload freed,
    the EMA's, the reference store's and the named snapshots' (where each
    lives), the optimizer's groups. Returns (config, trainer)."""
    import torch

    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.trainers import load_trainer

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = Arguments.load_from_yaml(os.path.join(here, "tests", "fixtures", fixture))
    cfg.data_args.cache_dir = os.path.join(here, "build", "preprocess_cache")
    cfg.log_args.save_dir = os.path.join(here, "chiprun_out", "train")
    log(f"[{tag}] device memory allocated before the trainer loads: {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = load_trainer(cfg)  # cuda
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    ad = trainer.adapter
    gib = lambda n: n / 2**30
    tree_bytes = lambda tree: sum(t.numel() * t.element_size() for t in tree.values())
    master = ad.trainable["transformer"]
    released = sum(p.numel() * p.element_size() for p in ad.modules["transformer"].parameters())
    loaded = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    for comp in FULL_OFFLOADED[tag]:
        ad.offload_component(comp)
    torch.cuda.synchronize()
    offload_s = time.perf_counter() - t0
    stores = {"EMA": ad.ema.params if ad.ema is not None else None,
              "reference": ad.ref_trainable() if ad._ref_store is not None else None,
              **{name: store.params for name, store in ad._named_stores.items()}}
    placed = {name: f"{gib(tree_bytes(tree['transformer'])):.2f} GiB on "
              f"{next(iter(tree['transformer'].values())).device}" for name, tree in stores.items() if tree is not None}
    log(f"[{tag}] load_trainer ({sum(t.numel() for t in master.values()) / 1e9:.4f} B trained weights in "
        f"{len(master)} fp32 leaves, {gib(tree_bytes(master)):.2f} GiB; preprocess included) {load_s:.1f} s; the "
        f"module's own copy released: {gib(released):.2f} GiB ({sorted(ad._released)}); offloaded "
        f"{list(FULL_OFFLOADED[tag])} in {offload_s:.2f} s, freeing {gib(loaded - torch.cuda.memory_allocated()):.2f} "
        f"GiB; the stores, fp32 and full size: {json.dumps(placed)}; remat "
        f"{ad.component_configs['transformer'].remat}; gradient_accumulation_steps "
        f"{trainer.training_args.gradient_accumulation_steps}; AdamW parameter groups "
        f"{len(trainer.optimizer.param_groups)}; allocated {gib(torch.cuda.memory_allocated()):.2f} GiB, "
        f"peak so far {gib(torch.cuda.max_memory_allocated()):.2f} GiB")
    if ad.is_lora or "transformer" not in ad._released or len(trainer.optimizer.param_groups) < 2:
        fail(f"[{tag}] not a full finetune with the module copy released and AdamW in groups")
    return cfg, trainer


def _full_peak(tag: str, earlier: float = 0.0) -> float:
    """The allocator's peak since its last reset (or ``earlier``, a peak
    read before that reset, where larger) against ``FULL_PEAK_PREDICTED``."""
    import torch

    peak = max(earlier, torch.cuda.max_memory_allocated() / 2**30)
    lo, hi = FULL_PEAK_PREDICTED[tag]
    log(f"[{tag}] peak memory {peak:.2f} GiB (predicted {lo:.0f}-{hi:.0f} GiB: "
        f"{'inside' if lo <= peak <= hi else 'outside'}; the card's 79.65 GiB)")
    if peak >= 79.65:
        fail(f"[{tag}] peak memory {peak:.2f} GiB")
    return peak


def phase_full_sd35() -> dict:
    """[full-sd35]: SD3.5-M full finetuning under GRPO at full width and
    depth through ``load_trainer`` on tests/fixtures/sd35_full_grpo.yaml
    (the geometry of examples/grpo/full/sd3_5/default.yaml: 512 px, 10
    steps, CFG 4.5, micro-batch 8, EMA 0.99 every 4, AdamW 1e-5, per-block
    remat; 2 prompts x group 4 and the brightness reward), the three text
    encoders offloaded after preprocessing, two epochs phase by phase: each
    rollout and its no-grad replay with ratio exactly 1.0 on every stored
    step, every grad step's ratio exactly 1.0, launches as
    ``SD35_FORWARD`` and ``SD35_FULL_A_STEP`` predict; after them every
    trained weight moved (the position grid included) but the ones with an
    exactly zero gradient (:func:`_sd35_zero_grad`), the EMA differs from θ.
    Then the seconds of a grad step and of an update, a profiled grad
    step, what was live at a grad step's peak (:func:`_peak_breakdown`), the
    peak against its prediction; ``evaluate`` under the full EMA
    (:func:`_full_evaluate`, on the fixture's test split of 8 prompts); a
    ``save_model_only`` full-layout save of θ, the trainer
    freed, and a fresh adapter resumed from it (``resume_type: full``): its
    master equal to θ bit for bit, its replay of a stored step giving the
    saving adapter's log-probs bit for bit; the seconds and bytes of the
    save and the load. Returns the launch counts of the two epochs."""
    import shutil

    import torch

    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models import load_adapter

    tag = "full-sd35"
    cfg, trainer = _full_trainer(tag, "sd35_full_grpo.yaml")
    ad, ta = trainer.adapter, trainer.training_args
    depth = ad.component_configs["transformer"].depth
    before = _leaf_fingerprints(ad.trainable["transformer"])
    ops.reset_launch_counts()
    runs = [_grpo_epoch(trainer, tag, epoch, SD35_FORWARD, {}, grad_step=SD35_FULL_A_STEP,
                        check_rollout=lambda samples: _replay_check(tag, ad, samples, SD35_FORWARD))
            for epoch in range(ta.max_epochs)]
    counts = ops.launch_counts()
    after = _leaf_fingerprints(ad.trainable["transformer"])
    still = {n for n in before if torch.equal(before[n], after[n])}
    theta, ema = ad.trainable["transformer"], ad.ema.params["transformer"]
    differs = sum(not torch.equal(ema[n], theta[n].detach()) for n in theta)
    log(f"[{tag}] after two epochs (global step {trainer.global_step}): {len(before) - len(still)}/{len(before)} "
        f"trained weights moved, pos_embed among them: {'pos_embed.pos_embed' not in still}; unmoved {sorted(still)} "
        f"(expected the zero-gradient {sorted(_sd35_zero_grad(depth))}); the EMA (updated at epoch 0) differs from θ "
        f"on {differs}/{len(theta)} weights; launches {counts}")
    if still != _sd35_zero_grad(depth) or trainer.global_step != ta.max_epochs:
        fail(f"[{tag}] the trained weights did not move as they should: unmoved {sorted(still)}")
    if differs < len(theta) - len(still):
        fail(f"[{tag}] the EMA equals θ on a moved weight")
    samples = runs[-1]["samples"]
    batch = next(trainer.grad_step_batches(samples, ta.max_epochs - 1))
    secs = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.backward_step(batch)
    torch.cuda.synchronize()
    secs["grad step"] = time.perf_counter() - t0
    trainer.apply_accumulated()
    torch.cuda.synchronize()
    secs["update"] = time.perf_counter() - t0 - secs["grad step"]
    log(f"[{tag}] seconds of one grad step (forward, remat backward into .grad) and of one update (the clip, "
        f"AdamW over {len(theta)} leaves in groups): {json.dumps({k: round(v, 4) for k, v in secs.items()})}")

    def grad_step():
        trainer.backward_step(batch)
        trainer.apply_accumulated()

    _profile("one SD3.5-M full-finetune grad step (forward, remat backward into .grad, the update)", grad_step,
             "full_sd35_grad_step_trace.json")
    _peak_breakdown(tag, grad_step)
    _full_peak(tag)
    _full_evaluate(trainer, tag)

    here = os.path.dirname(os.path.abspath(__file__))
    save_dir = os.path.join(here, "build", "full_sd35_ckpt")
    shutil.rmtree(save_dir, ignore_errors=True)
    t0 = time.perf_counter()
    ad.save_checkpoint(save_dir, model_only=True, save_ema=False)
    save_s = time.perf_counter() - t0
    saved_bytes = _dir_bytes(save_dir)
    lat_map, lp_map = samples[0].latent_index_map, samples[0].log_prob_index_map
    steps = [i for i in range(len(lp_map)) if lp_map[i] >= 0 and lat_map[i] >= 0 and lat_map[i + 1] >= 0][:1]
    want = ad.replay_log_probs(samples, steps=steps)[steps[0]].cpu()
    theta = {n: t.detach() for n, t in theta.items()}
    trainer.cleanup()
    del trainer, ad, runs, batch, ema
    gc.collect()
    torch.cuda.empty_cache()
    cfg2 = Arguments.load_from_yaml(os.path.join(here, "tests", "fixtures", "sd35_full_grpo.yaml"))
    cfg2.model_args.resume_path, cfg2.model_args.resume_type = save_dir, "full"
    cfg2.model_args.load_components = ["transformer"]
    t0 = time.perf_counter()
    fresh = load_adapter(cfg2)  # cuda
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    master = fresh.trainable["transformer"]
    same = set(master) == set(theta) and all(torch.equal(master[n].detach(), theta[n]) for n in theta)
    got = fresh.replay_log_probs(samples, steps=steps)[steps[0]].cpu()
    bits = torch.equal(got, want)
    log(f"[{tag}] save_model_only full-layout save of θ: {saved_bytes / 1e9:.3f} GB in {save_s:.2f} s "
        f"({saved_bytes / 1e9 / save_s:.2f} GB/s); a fresh adapter with resume_type full (transformer only, "
        f"build and read) {load_s:.2f} s ({saved_bytes / 1e9 / load_s:.2f} GB/s): its master equal to θ bit for "
        f"bit: {same}; its replay of stored step {steps[0]} gives the saving adapter's log-probs bit for bit: "
        f"{bits} ({got.tolist()})")
    if not (same and bits):
        fail(f"[{tag}] the resumed full checkpoint does not reproduce θ and its log-probs")
    del fresh, master, theta
    shutil.rmtree(save_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_full_wan_dpo() -> dict:
    """[full-wan-dpo]: Wan2.1-T2V-1.3B full finetuning under DPO at full
    width and depth through ``load_trainer`` on
    tests/fixtures/wan21_full_dpo.yaml (the geometry of
    examples/dpo/full/wan21/default.yaml: 256 px x 5 frames, 10 steps, CFG
    5.0, β 2000, one logit-normal timestep; 2 prompts x group 4, the
    brightness reward), UMT5-XXL offloaded after preprocessing, one epoch:
    the reference store (``init_ref_parameters``, fp32, full size) equal to
    θ bit for bit before the update; the rollout's launches as
    ``WAN_FORWARD`` predicts; the grad step at θ = the reference with the
    loss exactly −logsigmoid(0) = ln 2 in fp32 and the implicit margin
    exactly 0; launches as ``WAN_FULL_DPO_A_STEP``; the update moves θ; what
    was live at a grad step's peak, the peak against its prediction.
    Returns the launch counts of the epoch."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from flow_factory_tpu_torch import ops

    tag = "full-wan-dpo"
    cfg, trainer = _full_trainer(tag, "wan21_full_dpo.yaml")
    ad, ta = trainer.adapter, trainer.training_args
    theta, ref = ad.trainable["transformer"], ad.ref_trainable()["transformer"]
    equal = set(ref) == set(theta) and all(torch.equal(ref[n], theta[n].detach()) for n in theta)
    log(f"[{tag}] the reference store equal to θ bit for bit before the update: {equal}")
    if not equal:
        fail(f"[{tag}] the reference store is not θ")
    before = _leaf_fingerprints(theta)
    log2 = -F.logsigmoid(torch.zeros((), dtype=torch.float32)).item()
    ops.reset_launch_counts()
    secs = {}
    t0 = time.perf_counter()
    samples = trainer.sample(0)
    torch.cuda.synchronize()
    secs["sample"] = time.perf_counter() - t0
    in_sample = ops.launch_counts()
    want = {k: n * ta.num_inference_steps * -(-len(samples) // ta.per_device_batch_size)
            for k, n in WAN_FORWARD.items()}
    videos = np.stack([s.video for s in samples])
    t0 = time.perf_counter()
    metrics = trainer.prepare_feedback(samples)
    secs["feedback"] = time.perf_counter() - t0
    log(f"[{tag}] rollout: videos {videos.shape} in [{videos.min():.3f}, {videos.max():.3f}], reward mean "
        f"{metrics['reward/mean']:.5f}, launches {in_sample} (expected {want})")
    if not (videos.shape == (8, 5, 3, 256, 256) and np.isfinite(videos).all()):
        fail(f"[{tag}] the rollout's videos are not as expected: {videos.shape}")
    if any(in_sample[k] != n for k, n in want.items()):
        fail(f"[{tag}] rollout launches {in_sample}, expected {want}")
    base = ops.launch_counts()
    t0 = time.perf_counter()
    info = trainer.optimize(samples, 0)
    torch.cuda.synchronize()
    secs["optimize"] = time.perf_counter() - t0
    in_optimize = {k: v - base[k] for k, v in ops.launch_counts().items()}
    ad.ema_step(0)
    grad_steps = ta.get_num_train_timesteps(cfg)
    want = {k: n * grad_steps for k, n in WAN_FULL_DPO_A_STEP.items()}
    loss, margin, gnorm = info["train/loss"], info["train/implicit_margin"], info["train/grad_norm"]
    moved = sum(not torch.equal(a, b) for a, b in zip(before.values(), _leaf_fingerprints(theta).values()))
    log(f"[{tag}] {info['train/dpo_num_pairs']:.0f} pairs, {grad_steps} grad step(s) at θ = the reference: loss "
        f"{loss!r} (-logsigmoid(0) in fp32: {log2!r}), implicit margin {margin!r}, theta errs w "
        f"{info['train/theta_w_err']:.6f} l {info['train/theta_l_err']:.6f}, grad_norm {gnorm:.4e}, launches in "
        f"optimize {in_optimize} (expected {want}); {moved}/{len(before)} weights moved by the update; phase seconds "
        f"{json.dumps({k: round(v, 3) for k, v in secs.items()})}")
    if not (margin == 0.0 and loss == log2 and np.isfinite(gnorm) and gnorm > 0):
        fail(f"[{tag}] the first grad step at θ = the reference: margin {margin!r}, loss {loss!r}, grad norm {gnorm}")
    if any(in_optimize[k] != n for k, n in want.items()):
        fail(f"[{tag}] launches in optimize {in_optimize}, expected {want}")
    if not moved:
        fail(f"[{tag}] the update moved no weight")
    counts = ops.launch_counts()
    batch = next(trainer.grad_step_batches(samples, 0))

    def grad_step():
        trainer.backward_step(batch, trainer.reference_trainable())
        trainer.apply_accumulated()

    _peak_breakdown(tag, grad_step)
    _full_peak(tag)
    trainer.cleanup()
    del trainer, ad, theta, ref, batch
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _full_evaluate(trainer, tag: str) -> None:
    """``evaluate`` under the full EMA (two epochs after the load it differs
    from θ) at the eval geometry of examples/grpo/full/sd3_5 (512 px, 28
    steps, CFG 4.5, one batch of 8 prompts, each from its own generator),
    timed, its peak (and the memory at the start of its decode) read against
    ``FULL_PEAK_PREDICTED``: the EMA store itself goes through
    ``inference(trainable=…)``; its images differ from an ``evaluate``
    under θ on every prompt; θ, AdamW's moments and the EMA are unchanged bit
    for bit by both; the 8 prompts in reversed order (each at another place
    among other batch-mates) give their images again bit for bit. Then two
    of them in a batch of 2 (F18's watch: another M): the images' and the
    final latents' largest difference to the batch of 8, logged."""
    import numpy as np
    import torch

    from flow_factory_tpu_torch.utils.base import generators_for_prompts

    ad, ea = trainer.adapter, trainer.eval_args
    theta, ema = ad.trainable["transformer"], ad.ema.params
    moments = {f"{i}.{k}": v for i, st in enumerate(trainer.optimizer.state.values()) for k, v in st.items()
               if torch.is_tensor(v) and v.numel() > 1}
    state = lambda: [_bits(theta), _bits(moments), _bits(ema["transformer"])]
    before = state()
    real, real_decode, seen, secs, at_decode = ad.inference, ad.decode_latents, [], {}, []

    def spy(**kwargs):
        out = real(**kwargs)
        seen.append((kwargs["trainable"], out))
        return out

    def decode(latents):
        torch.cuda.synchronize()
        at_decode.append((torch.cuda.memory_allocated() / 2**30, torch.cuda.max_memory_allocated() / 2**30))
        return real_decode(latents)

    ad.inference, ad.decode_latents = spy, decode
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer.evaluate(2)
        torch.cuda.synchronize()
        secs["evaluate"] = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        with _swapped(ad, ema=None):  # ema_trainable is θ then
            t0 = time.perf_counter()
            trainer.evaluate(2)
            torch.cuda.synchronize()
            secs["evaluate under θ"] = time.perf_counter() - t0
    finally:
        del ad.inference, ad.decode_latents
    (under_ema, ema_out), (under_theta, theta_out) = seen
    batch = next(iter(trainer.test_loader))
    B = len(batch["prompt"])

    def rollout(order, what):
        rows = {k: ([v[i] for i in order] if isinstance(v, (list, tuple)) and len(v) == B
                    else v[order] if getattr(v, "ndim", 0) > 0 and v.shape[0] == B else v) for k, v in batch.items()}
        ad.eval()
        t0 = time.perf_counter()
        out = ad.inference(prompt=rows["prompt"], prompt_embeds=rows.get("prompt_embeds"),
                           pooled_prompt_embeds=rows.get("pooled_prompt_embeds"),
                           negative_prompt_embeds=rows.get("negative_prompt_embeds"),
                           negative_pooled_prompt_embeds=rows.get("negative_pooled_prompt_embeds"), height=ea.height,
                           width=ea.width, num_inference_steps=ea.num_inference_steps,
                           guidance_scale=ea.guidance_scale, compute_log_prob=False, trajectory_indices=[-1],
                           generator=generators_for_prompts(rows["prompt"], ea.seed or 0, ad.device),
                           trainable=ad.ema_trainable)
        torch.cuda.synchronize()
        secs[what] = time.perf_counter() - t0
        ad.train()
        return out

    reverse, pick = list(range(B))[::-1], [5, 2]
    again, two = rollout(reverse, "reversed batch of 8"), rollout(pick, "2 of the prompts in a batch of 2")
    images = np.stack([s.image for s in ema_out])
    apart = [float(np.abs(a.image - b.image).max()) for a, b in zip(ema_out, theta_out)]
    bitwise = all(np.array_equal(s.image, ema_out[i].image) for s, i in zip(again, reverse))
    final = {i: s.all_latents[-1] for s, i in zip(again, reverse)}
    two_images = [float(np.abs(s.image - ema_out[i].image).max()) for s, i in zip(two, pick)]
    two_latents = [float(np.abs(s.all_latents[-1] - final[i]).max()) for s, i in zip(two, pick)]
    unchanged = [_same_bits(a, b) for a, b in zip(before, state())]
    lo, hi = FULL_PEAK_PREDICTED[f"{tag} evaluate"]
    slo, shi = FULL_SECONDS_PREDICTED[f"{tag} evaluate"]["evaluate"]
    log(f"[{tag}] evaluate under the full EMA ({ea.height} px, {ea.num_inference_steps} steps, CFG "
        f"{ea.guidance_scale}, {len(ema_out)} prompts in one batch): images {images.shape} in [{images.min():.3f}, "
        f"{images.max():.3f}]; the EMA store itself passed as trainable: {under_ema is ema}, θ under the second: "
        f"{under_theta is ad.trainable}; max|image under the EMA - under θ| a prompt {[round(a, 4) for a in apart]}; "
        f"θ, AdamW's moments ({len(moments)} tensors), the EMA unchanged bit for bit: {unchanged}; the prompts in "
        f"reversed order give their images bit for bit: {bitwise}; prompts {pick} in a batch of 2 (F18's watch): "
        f"max|d| images {two_images}, final latents {two_latents}")
    log(f"[{tag}] evaluate's seconds {json.dumps({k: round(v, 3) for k, v in secs.items()})} (predicted {slo}-{shi} s: "
        f"{'inside' if slo <= secs['evaluate'] <= shi else 'outside'}); {card_name()}: peak {peak:.2f} GiB with "
        f"{base:.2f} GiB allocated before it (predicted {lo:.0f}-{hi:.0f} GiB: "
        f"{'inside' if lo <= peak <= hi else 'outside'}); allocated and peak at the start of each decode, GiB: "
        f"{[(round(a, 2), round(b, 2)) for a, b in at_decode]}")
    if not (under_ema is ema and under_theta is ad.trainable and np.isfinite(images).all()
            and images.shape == (8, 3, ea.height, ea.width)):
        fail(f"[{tag}] evaluate did not run the EMA store at the eval geometry")
    if min(apart) == 0.0 or not all(unchanged) or not bitwise:
        fail(f"[{tag}] evaluate under the EMA: apart {apart}, state unchanged {unchanged}, reversed bit for bit "
             f"{bitwise}")
    if peak >= 79.65:
        fail(f"[{tag}] evaluate's peak {peak:.2f} GiB")


def phase_full_decoupled(tag: str) -> dict:
    """One epoch of a decoupled trainer under full finetuning at full width
    and depth (``FULL_DECOUPLED_PHASES``) through ``load_trainer``, the
    frozen encoders offloaded after preprocessing: every store (the EMA, the
    reference, the named snapshots: fp32, full size, on the card) equal to θ
    bit for bit after the load and again before the update; the trainer's
    rollout (the sampling policy's: θ, or CRD's ``_crd_sampling``) with
    finite media and ``forward`` launches a step; every grad step of the
    epoch with the trainer's step-0 invariants (``DECOUPLED_INVARIANTS``)
    exact, timed, with the launches of its forwards without a gradient and
    its forward and backward; one update, timed; then the reference
    unchanged, DGPO's ``ema_ref`` and CRD's two snapshots (and the EMA,
    after its step) equal to their blend recomputed here in fp32 from the
    reference (θ before the update) and θ bit for bit, every trained weight
    moved but the exactly-zero-gradient ones, what was live at a grad step's
    peak and the peak against ``FULL_PEAK_PREDICTED``. Returns the launch
    counts of the epoch."""
    import numpy as np
    import torch

    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.trainers.crd import compute_decay

    spec = FULL_DECOUPLED_PHASES[tag]
    t_phase = time.perf_counter()
    cfg, trainer = _full_trainer(tag, spec["fixture"])
    ad, ta = trainer.adapter, trainer.training_args
    kind = ta.trainer_type.lower()
    sd35 = spec["family"] == "sd35"
    forward, grad = (SD35_FORWARD, SD35_FULL_A_STEP) if sd35 else (WAN_FORWARD, WAN_FULL_A_STEP)
    per_step = _add(_mul(forward, spec["frozen"]), grad)
    theta = ad.trainable["transformer"]
    ref = ad.ref_trainable()["transformer"] if ad._ref_store is not None else None

    def stores():
        out = {"EMA": ad.ema.params["transformer"], **{n: st.params["transformer"] for n, st in ad._named_stores.items()}}
        return out if ref is None else {**out, "reference": ref}

    def equal_theta(when: str) -> None:
        same = {name: all(torch.equal(tree[n], theta[n].detach()) for n in theta) for name, tree in stores().items()}
        log(f"[{tag}] every store equal to θ bit for bit {when}: {same}")
        if not all(same.values()):
            fail(f"[{tag}] a store differs from θ {when}: {same}")

    equal_theta("after the load")
    ref_bits = None if ref is None else _bits(ref)
    before = _leaf_fingerprints(theta)
    log(f"[{tag}] {type(trainer).__name__} on {type(ad).__name__}, full finetuning: remat "
        f"{ad.component_configs['transformer'].remat}, {ta.get_num_train_timesteps(cfg)} train timesteps, B "
        f"{ta.per_device_batch_size}, gradient_accumulation_steps {ta.gradient_accumulation_steps}; predicted launches "
        f"a rollout step {forward}, a grad step {per_step}")
    trainer.epoch = 0
    trainer.scheduler.set_seed(ta.seed)
    ops.reset_launch_counts()
    secs = {}
    t0 = time.perf_counter()
    samples = trainer.sample(0)
    torch.cuda.synchronize()
    secs["rollout"] = time.perf_counter() - t0
    in_sample = ops.launch_counts()
    want = _mul(forward, ta.num_inference_steps * -(-len(samples) // ta.per_device_batch_size))
    media = np.stack([s.image if sd35 else s.video for s in samples])
    shape = (8, 3, 512, 512) if sd35 else (8, 5, 3, 256, 256)
    log(f"[{tag}] the trainer's rollout: {'images' if sd35 else 'videos'} {media.shape} in [{media.min():.3f}, "
        f"{media.max():.3f}], launches {in_sample} (expected {want}), {secs['rollout']:.2f} s")
    if not (media.shape == shape and np.isfinite(media).all()):
        fail(f"[{tag}] the rollout's media are not as expected: {media.shape}")
    if any(in_sample[k] != n for k, n in want.items()):
        fail(f"[{tag}] rollout launches {in_sample}, expected {want}")
    metrics = trainer.prepare_feedback(samples)

    auxes, timing = [], collections.defaultdict(list)
    loss_fn, apply_accumulated = trainer.loss_fn, trainer.apply_accumulated

    def recording_loss_fn(trainable, batch, *args):
        loss, aux = loss_fn(trainable, batch, *args)
        auxes.append(dict(aux))
        return loss, aux

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            timing[name].append(time.perf_counter() - t)
            return out

        return run

    zero_grad: set = set()

    def update():
        equal_theta("before the update")
        names = sorted(theta)
        live = torch.stack([theta[n].grad.abs().max() if theta[n].grad is not None else torch.zeros((), device=ad.device)
                            for n in names]).cpu()
        zero_grad.update(n for n, v in zip(names, live.tolist()) if v == 0.0)
        return timed("update", apply_accumulated)()

    wrapped = {"loss_fn": recording_loss_fn, "backward_step": timed("grad step", trainer.backward_step),
               "apply_accumulated": update}
    if kind == "dgpo":
        wrapped["after_optimizer_step"] = timed("ema_ref blend", trainer.after_optimizer_step)
    if kind == "crd":
        wrapped["update_snapshots"] = timed("snapshots", trainer.update_snapshots)
    for name, fn in wrapped.items():
        setattr(trainer, name, fn)
    base = ops.launch_counts()
    t0 = time.perf_counter()
    try:
        info = trainer.optimize(samples, 0)
        torch.cuda.synchronize()
    finally:
        for name in wrapped:
            delattr(trainer, name)
    secs["optimize"] = time.perf_counter() - t0
    in_optimize = {k: v - base[k] for k, v in ops.launch_counts().items()}
    timed("EMA step", ad.ema_step)(0)  # the epoch's EMA step, as the trainer's loop takes it after optimize
    counts = ops.launch_counts()
    auxes = [{k: float(v) for k, v in a.items()} for a in auxes]
    want = _mul(per_step, len(auxes))
    shown = {k: [round(a[k], 6) for a in auxes] for k in sorted(auxes[0])} if auxes else {}
    log(f"[{tag}] reward mean {metrics['reward/mean']:.5f}; {len(auxes)} grad steps at θ = the old policy = every "
        f"store: aux {shown}; loss {info['train/loss']:.4e}, grad_norm {info['train/grad_norm']:.4e}; launches in "
        f"optimize {in_optimize} (expected {want}); global step {trainer.global_step}")
    if not (auxes and all(DECOUPLED_INVARIANTS[kind](a) for a in auxes)):
        fail(f"[{tag}] the {kind} step-0 invariants do not hold on every grad step of epoch 0: {auxes}")
    if not (np.isfinite(info["train/grad_norm"]) and info["train/grad_norm"] > 0
            and all(np.isfinite(v) for a in auxes for v in a.values())):
        fail(f"[{tag}] a loss or the grad norm is not finite and positive: {info}")
    if any(in_optimize[k] != n for k, n in want.items()) or trainer.global_step != 1:
        fail(f"[{tag}] launches in optimize {in_optimize}, expected {want}; global step {trainer.global_step}")

    # after the update: the blends against their fp32 recomputation from the reference (θ before the
    # update, bit for bit) and θ, leaf by leaf
    blends = {}
    if ref is not None:
        blends["EMA"] = ad.ema.decay_fn(0)
        if kind == "dgpo":
            blends[trainer.EMA_REF] = min(float(ta.ema_ref_max_decay), float(ta.ema_ref_ramp_rate) * trainer.global_step)
        if kind == "crd":
            blends[trainer.OLD] = compute_decay(trainer.global_step, ta.old_model_decay)
            blends[trainer.SAMPLING] = compute_decay(trainer.global_step, ta.sampling_model_decay)
    now = stores()
    exact = {}
    with torch.no_grad():
        for name, decay in blends.items():
            d = torch.tensor(decay, dtype=torch.float32, device=ad.device)
            exact[f"{name} at decay {decay}"] = all(
                torch.equal(now[name][n], theta[n].detach() if decay <= 0.0 else ref[n] * d + theta[n].detach() * (1 - d))
                for n in theta)
    ref_same = ref is None or _same_bits(_bits(ref), ref_bits)
    after = _leaf_fingerprints(theta)
    still = {n for n in before if torch.equal(before[n], after[n])}
    zero = _sd35_zero_grad(ad.component_configs["transformer"].depth) if sd35 else set()
    log(f"[{tag}] after the update: the reference unchanged bit for bit: {ref_same}; each blend equal to its fp32 "
        f"recomputation bit for bit: {exact}; {len(before) - len(still)}/{len(before)} trained weights moved, unmoved "
        f"{sorted(still)}; an exactly zero gradient at the update {sorted(zero_grad)} (expected {sorted(zero)})")
    if not (ref_same and all(exact.values())):
        fail(f"[{tag}] after the update: reference unchanged {ref_same}, blends {exact}")
    if kind in ("dgpo", "crd") and len(exact) < (2 if kind == "dgpo" else 3):
        fail(f"[{tag}] the snapshots were not checked: {exact}")
    if not still == zero_grad == zero:
        fail(f"[{tag}] the trained weights did not move as they should: unmoved {sorted(still)}, zero gradient "
             f"{sorted(zero_grad)}")

    epoch_peak = torch.cuda.max_memory_allocated() / 2**30
    batch = next(trainer.grad_step_batches(samples, 0))
    ref_tree = trainer.reference_trainable() if ta.requires_ref_model else None

    def grad_step():
        trainer.backward_step(batch, ref_tree)
        trainer.apply_accumulated()

    _peak_breakdown(tag, grad_step)
    log(f"[{tag}] {card_name()}: the epoch's peak {epoch_peak:.2f} GiB (before the breakdown's grad step)")
    _full_peak(tag, epoch_peak)
    predicted = FULL_SECONDS_PREDICTED[tag]
    got = {k: [round(v, 4) for v in vs] for k, vs in timing.items()}
    inside = {k: all(lo <= v <= hi for v in timing[k]) for k, (lo, hi) in predicted.items()}
    stats = torch.cuda.memory_stats()
    log(f"[{tag}] seconds {json.dumps({k: round(v, 3) for k, v in secs.items()})}; timed {json.dumps(got)} "
        f"(predicted {json.dumps(predicted)}: inside {inside}); the allocator: {stats.get('num_alloc_retries', 0)} "
        f"allocations retried after freeing its cache, {stats.get('num_device_alloc', 0)} device allocations, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved; launches {counts}")
    trainer.cleanup()
    del trainer, ad, theta, ref, batch, ref_tree, samples
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{tag}] phase seconds {time.perf_counter() - t_phase:.1f} (load and preprocess included)")
    return counts


def _full_phases() -> dict:
    """[full-grad], [full-sd35] (with its evaluate under the EMA),
    [full-wan-dpo], then the phases of ``FULL_DECOUPLED_PHASES``; their
    launch counts."""
    import torch

    phase_full_grad()
    out = {"full-sd35": phase_full_sd35(), "full-wan-dpo": phase_full_wan_dpo()}
    for tag in FULL_DECOUPLED_PHASES:
        out[tag] = phase_full_decoupled(tag)
    log(f"[full] device memory still allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return out


def full_only() -> int:
    """``python3 chip_smoke.py --full``: the build and every full-finetune phase (``_full_phases``)."""
    from flow_factory_tpu_torch.utils.base import use_full_fp32

    use_full_fp32()
    phase_environment()
    _full_phases()
    return 0


def full_grad_only(seeds) -> int:
    """``python3 chip_smoke.py --full-grad SEED [SEED ...]``: the build and
    ``[full-grad]`` at each seed."""
    from flow_factory_tpu_torch.utils.base import use_full_fp32

    use_full_fp32()
    phase_environment()
    for seed in seeds:
        phase_full_grad(seed)
    return 0


#: [ring]: the self-attention of Wan2.1-T2V-14B at 720 px x 81 frames (21 x 45
#: x 80 latent tokens, 40 heads of 128) over a loopback ring of 4 virtual
#: ranks, each hop Sq = Sk = 18900; and the small shape held to the plain version
RING_SHAPE = ("ring-hop", 1, 40, 75600, 128, 4)
RING_SMALL = (1, 4, 2048, 128)
#: the names of PyTorch's attention ops (SDPA's backends), which the ring must not call
LIBRARY_ATTENTION_OPS = ("scaled_dot_product", "flash_attention", "efficient_attention", "cudnn_attention")


def _aten_ops_called(fn):
    """``fn()`` and the names of the aten ops it dispatched (a dispatch mode
    records them; no profiler session)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    names = set()

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            names.add(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    with Record():
        out = fn()
    return out, names


def _by_heads(fn, *tensors, chunk: int = 4):
    """``fn`` (a plain version) on head slices of (B, H, ...) tensors, the
    results concatenated on the head axis: the plain versions' score
    matrices at a hop of 18900 keys do not fit the card in one call."""
    import torch

    H = tensors[0].shape[1]
    parts = [fn(*(t[:, h : h + chunk] for t in tensors)) for h in range(0, H, chunk)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(list(p), dim=1) for p in zip(*parts))
    return torch.cat(parts, dim=1)


def _ring_checks(tag: str, got, ref, got_lse=None, ref_lse=None) -> list:
    """The ring's O (and lse) and dq/dk/dv against a reference at K3's bars
    (4 bf16 ulp of max|O|, lse 1e-2) and K2's (``_k2_check``: 2 bf16 ulp of
    max|ref| per output)."""
    import torch

    out, grads = got
    ref_out, ref_grads = ref
    tol_o = 4 * bf16_ulp(ref_out.float().abs().max().item())
    err_o = (out.float() - ref_out.float()).abs().max().item()
    _check(f"ring {tag} O {tuple(out.shape)} bf16", err_o, tol_o)
    if got_lse is not None:
        _check(f"ring {tag} lse", (got_lse - ref_lse).abs().max().item(), 1e-2)
    errs, _ = _k2_check(f"ring {tag}", grads, ref_grads, torch.bfloat16)
    return [err_o, *errs]


def phase_ring(results: dict) -> dict:
    """[ring]: ``ops/ring_attention.py`` on the card as a loopback ring of 4
    virtual ranks in one process, through the module's own hop and merge
    functions (what a rank of a tensor group runs, its P2P rotation a list
    rotation): every hop of the forward one K3 launch, every hop of the
    backward one K2a and one K2b launch under the global O and lse. At
    B1 H4 S2048 D128 against the plain versions on the whole sequence (and a
    merge without the lse weights rejected); at ``RING_SHAPE``, the
    self-attention of Wan2.1-T2V-14B at 720 px x 81 frames, against K3 and
    K2 on the whole sequence, with 16 / 16 / 16 launches a ring call and no
    library attention op. Times the ring's forward and backward, a hop's K3,
    K2a and K2b (recorded in the kernel table under ``ring-hop`` with their
    plain versions by head slices and SDPA at the hop's shape) and the
    merge. Returns the launches of the one ring call."""
    import torch
    import torch.nn.functional as F

    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.ops import attention as A
    from flow_factory_tpu_torch.ops import ring_attention as R

    log(f"[ring] card (SM clock, max, power, temperature): {gpu_state()}")
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(22)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(torch.bfloat16)
    tag, B, H, S, D, n = RING_SHAPE
    scale = D ** -0.5

    # the small shape against the plain versions on the whole sequence
    q, k, v, do = (randn(*RING_SMALL) for _ in range(4))
    out, lse, backward = R.loopback_ring_attention(q, k, v, n)
    grads = backward(do)
    ref, ref_lse = A.flash_attention_plain(q, k, v, scale, return_lse=True)
    _ring_checks(f"B1 H4 S2048 D128 x{n} vs plain", (out, grads),
                 (ref, A.flash_backward_plain(q, k, v, ref, ref_lse, do, scale)), lse, ref_lse)
    shards = lambda t: t.chunk(n, dim=2)
    partials = [[R.hop_forward(qs, ks, vs, scale)[0].float() for ks, vs in zip(shards(k), shards(v))]
                for qs in shards(q)]
    unweighted = torch.cat([torch.stack(p).mean(0) for p in partials], dim=2).to(torch.bfloat16)
    _negative_control(f"ring vs a merge without the lse weights (the mean of the {n} partials)", (out, lse),
                      (unweighted, ref_lse), 4 * bf16_ulp(ref.float().abs().max().item()), 1e-2)
    del q, k, v, do, out, lse, backward, grads, ref, ref_lse, partials, unweighted

    # the whole sequence: K3 and K2 on it, then the ring of n virtual ranks
    q, k, v, do = (randn(B, H, S, D) for _ in range(4))
    whole_out, whole_lse = A.flash_forward(q, k, v, scale)
    whole_grads = A.flash_backward(q, k, v, whole_out, whole_lse, do, scale)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    (out, lse, backward), called = _aten_ops_called(lambda: R.loopback_ring_attention(q, k, v, n))
    fwd_counts = ops.launch_counts()
    grads, called_b = _aten_ops_called(lambda: backward(do))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    library = sorted(n for n in called | called_b if any(op in n for op in LIBRARY_ATTENTION_OPS))
    want_f = {name: (n * n if name == "flash_fwd" else 0) for name in counts}
    want = {name: (n * n if name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv") else 0) for name in counts}
    log(f"[ring] launches of one loopback ring call at B{B} H{H} S{S} D{D} over {n} virtual ranks: forward "
        f"{fwd_counts}, forward + backward {counts} ({n * n} K3 / K2a / K2b predicted, nothing else); library "
        f"attention ops called: {library or 'none'}; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if fwd_counts != want_f or counts != want or library:
        fail("the ring launched other kernels than n² K3, K2a and K2b, or called a library attention")
    errs = _ring_checks(f"B{B} H{H} S{S} D{D} x{n} vs K3 and K2 on the whole sequence", (out, grads),
                        (whole_out, whole_grads), lse, whole_lse)
    del grads, whole_grads, backward
    torch.cuda.empty_cache()

    # times: the ring, the whole-sequence kernels, a hop's kernels and the merge
    events = lambda fn: time_ms(fn, iters=1, warmup=1, reps=3)
    ring_fwd = events(lambda: R.loopback_ring_attention(q, k, v, n)[:2])
    holder = {}

    def ring_backward():
        holder["bwd"](do)

    holder["bwd"] = R.loopback_ring_attention(q, k, v, n)[2]
    ring_bwd = events(ring_backward)
    del holder
    whole_fwd = events(lambda: A.flash_forward(q, k, v, scale))
    whole_bwd = events(lambda: A.flash_backward(q, k, v, whole_out, whole_lse, do, scale))
    fwd_flops, (dq_flops, dkv_flops) = 4 * B * H * S * S * D, _k2_flops(B, H, S, S, D)
    bound = lambda flops: flops / PEAK_BF16_FLOPS * 1e3
    log(f"[ring] forward {ring_fwd:.2f} ms (K3 on the whole sequence {whole_fwd:.2f} ms; bound {bound(fwd_flops):.1f} "
        f"ms) | backward {ring_bwd:.2f} ms (K2a + K2b with the prologue on the whole sequence {whole_bwd:.2f} ms; "
        f"bound {bound(dq_flops):.1f} + {bound(dkv_flops):.1f} ms) | ring / whole: forward "
        f"{ring_fwd / whole_fwd:.3f}x, backward {ring_bwd / whole_bwd:.3f}x")
    del whole_out, whole_lse, out, lse
    torch.cuda.empty_cache()

    c = S // n
    hq, hk, hv, hdo = (t[:, :, :c] for t in (q, k, v, do))
    h_out, h_lse = A.flash_forward(hq, hk, hv, scale)
    d_, delta, lse2 = A._bwd_prologue(hq, h_out, h_lse, hdo)
    o32 = h_out.float()
    hop_ms = lambda fn: time_ms(fn, iters=4, warmup=1, reps=3)  # a hop's kernels run 14-35 ms
    merge_ms = time_ms(lambda: R._merge(o32, h_lse, o32, h_lse))
    hop_fwd_ms = hop_ms(lambda: R.hop_forward(hq, hk, hv, scale))
    hop_dq_ms = hop_ms(lambda: A.flash_bwd_dq(hq, hk, hv, d_, lse2, delta, scale))
    hop_dkv_ms = hop_ms(lambda: A.flash_bwd_dkv(hq, hk, hv, d_, lse2, delta, scale))
    lib_fwd = hop_ms(lambda: F.scaled_dot_product_attention(hq, hk, hv, scale=scale))
    leaves = [t.detach().requires_grad_() for t in (hq, hk, hv)]
    o_lib = F.scaled_dot_product_attention(*leaves, scale=scale)
    lib_bwd = hop_ms(lambda: torch.autograd.grad(o_lib, leaves, hdo, retain_graph=True))
    del leaves, o_lib
    # the hop kernels against their plain versions on head slices, the plain times over every head
    slices = lambda *t: tuple(x[:, :4] for x in t)
    ref_h, _ = A.flash_attention_plain(*slices(hq, hk, hv), scale, return_lse=True)
    err_fwd = (h_out[:, :4].float() - ref_h.float()).abs().max().item()
    got_dq = A.flash_bwd_dq(hq, hk, hv, d_, lse2, delta, scale)
    got_dk, got_dv = A.flash_bwd_dkv(hq, hk, hv, d_, lse2, delta, scale)
    ref_dq = A.flash_bwd_dq_plain(*slices(hq, hk, hv, d_, lse2, delta), scale)
    ref_dk, ref_dv = A.flash_bwd_dkv_plain(*slices(hq, hk, hv, d_, lse2, delta), scale)
    err_dq = (got_dq[:, :4].float() - ref_dq.float()).abs().max().item()
    err_dkv = max((got_dk[:, :4].float() - ref_dk.float()).abs().max().item(),
                  (got_dv[:, :4].float() - ref_dv.float()).abs().max().item())
    _check(f"K3 {tag} (B{B} H{H} S{c} D{D}) heads 0-3 vs plain", err_fwd, 4 * bf16_ulp(ref_h.float().abs().max().item()))
    _k2_check(f"{tag} D128 heads 0-3", (got_dq[:, :4], got_dk[:, :4], got_dv[:, :4]), (ref_dq, ref_dk, ref_dv),
              torch.bfloat16)
    del ref_h, got_dq, got_dk, got_dv, ref_dq, ref_dk, ref_dv
    torch.cuda.empty_cache()
    once = lambda fn: time_ms(fn, iters=1, warmup=0, reps=1)
    plain_fwd = once(lambda: _by_heads(lambda a, b, c_: A.flash_attention_plain(a, b, c_, scale), hq, hk, hv))
    plain_dq = once(lambda: _by_heads(lambda *t: A.flash_bwd_dq_plain(*t, scale), hq, hk, hv, d_, lse2, delta))
    plain_dkv = once(lambda: _by_heads(lambda *t: A.flash_bwd_dkv_plain(*t, scale), hq, hk, hv, d_, lse2, delta))
    hop_bytes = nbytes(hq, hk, hv)
    fwd_bound = _fwd_bound(B, H, c, c, D, hop_bytes + nbytes(h_out, h_lse))
    _record(results, tag, dict(
        name="flash_fwd", route="cuda", source="flow_factory_tpu_torch/ops/csrc/flash_fwd.cu",
        replaces="flow_factory_tpu/ops/attention.py:101", max_abs_err=err_fwd, ms=hop_fwd_ms, plain_ms=plain_fwd,
        bound_ms=fwd_bound[0], bound_by=fwd_bound[1], library_ms=lib_fwd))
    for name, ms, plain_ms, flops, outs, err, line in (
            ("flash_bwd_dq", hop_dq_ms, plain_dq, _k2_flops(B, H, c, c, D)[0], 1, err_dq, ":601"),
            ("flash_bwd_dkv", hop_dkv_ms, plain_dkv, _k2_flops(B, H, c, c, D)[1], 2, err_dkv, ":653")):
        byts = hop_bytes + nbytes(d_, lse2, delta) + outs * nbytes(hq)
        hop_bound = max(flops / PEAK_BF16_FLOPS, byts / PEAK_BYTES) * 1e3
        _record(results, tag, dict(
            name=f"{name}_d128", route="cuda", source="flow_factory_tpu_torch/ops/csrc/flash_bwd.cu",
            replaces=f"flow_factory_tpu/ops/attention.py{line}", max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=hop_bound, bound_by="operations" if flops / PEAK_BF16_FLOPS > byts / PEAK_BYTES else "bytes",
            library_ms=lib_bwd))
    log(f"[ring] a hop (B{B} H{H} Sq {c} Sk {c} D{D}): K3 {hop_fwd_ms:.3f} ms (bound {fwd_bound[0]:.3f}, sdpa "
        f"{lib_fwd:.3f}, plain by head slices {plain_fwd:.1f}) | K2a {hop_dq_ms:.3f} ms, K2b {hop_dkv_ms:.3f} ms "
        f"(bounds {bound(_k2_flops(B, H, c, c, D)[0]):.3f}, {bound(_k2_flops(B, H, c, c, D)[1]):.3f}; SDPA's whole "
        f"backward {lib_bwd:.3f}; plain {plain_dq:.1f}, {plain_dkv:.1f}) | the merge (fp32 O and lse of a hop) "
        f"{merge_ms:.3f} ms | {n * n} hops each way: forward {n * n * hop_fwd_ms:.1f} + {n * (n - 1)} merges "
        f"{n * (n - 1) * merge_ms:.1f} ms, backward {n * n * (hop_dq_ms + hop_dkv_ms):.1f} ms of kernels")
    log(f"[ring] done in {time.perf_counter() - t0:.1f} s; worst ring error vs the whole-sequence kernels "
        f"{max(errs):.3e}")
    del q, k, v, do, hq, hk, hv, hdo, h_out, h_lse, d_, delta, lse2, o32
    torch.cuda.empty_cache()
    return {"flash_fwd": counts["flash_fwd"], "flash_bwd_dq_d128": counts["flash_bwd_dq"],
            "flash_bwd_dkv_d128": counts["flash_bwd_dkv"]}


#: [dist1]: tests/fixtures/wan21_dist1.yaml, the multi-node example cut to one GPU
DIST1_FIXTURE = os.path.join("tests", "fixtures", "wan21_dist1.yaml")


def _lora_file_tensors(path: str) -> dict:
    from flow_factory_tpu_torch.utils.safetensors_io import load_file

    return load_file(path)


def phase_dist1(card: str) -> None:
    """[dist1]: ``examples/multinode/wan21_fsdp.yaml`` at world size 1 on the
    card (``DIST1_FIXTURE``: Wan2.1-T2V-1.3B at full width and depth, 256 px,
    5 frames, 4 steps, micro-batch 1; 1 prompt x group 4, ``fsdp_size`` 1,
    the brightness reward): one epoch through ``torchrun --standalone
    --nproc_per_node 1 -m flow_factory_tpu_torch.cli`` (an NCCL process group
    of one, the mesh (1, 1, 1): the gradient all-reduce over the replica
    group), then the same epoch in this process without a launcher. The
    LoRA each run saves must be the same bits, the ratio exactly 1.0 on
    every grad step of the launched run; prints its collective calls. Then
    ``tools/f18_bisect.py``'s bisection of the Wan2.1-1.3B DiT at the
    per-rank shape: the CFG batch of 2 against its first row alone."""
    import torch

    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.trainers import load_trainer

    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(here, "chiprun_out", "dist1")
    os.makedirs(out_dir, exist_ok=True)
    cache = os.path.join(here, "build", "preprocess_cache")
    runs = {kind: os.path.join(here, "build", "dist1", kind) for kind in ("torchrun", "plain")}
    shutil.rmtree(os.path.join(here, "build", "dist1"), ignore_errors=True)
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
           "-m", "flow_factory_tpu_torch.cli", DIST1_FIXTURE, "--set", f"data.cache_dir={cache}",
           "--set", f"log.save_dir={runs['torchrun']}"]
    log_path = os.path.join(out_dir, "cli.log")
    with open(log_path, "w") as f:
        proc = subprocess.run(cmd, cwd=here, stdout=f, stderr=subprocess.STDOUT, timeout=600)
    launched_s = time.perf_counter() - t0
    text = open(log_path).read()
    calls = re.findall(r"collective calls of rank 0 \(backend (\w+), world (\d+)\): (\{.*\})", text)
    log(f"[dist1] torchrun --standalone --nproc_per_node 1 -m flow_factory_tpu_torch.cli {DIST1_FIXTURE}: exit "
        f"{proc.returncode} in {launched_s:.1f} s (log chiprun_out/dist1/cli.log); collective calls: "
        f"{calls[-1] if calls else 'not logged'}")
    if proc.returncode != 0 or not calls or calls[-1][:2] != ("nccl", "1"):
        fail(f"[dist1] the launched run failed or ran without an NCCL group of one: {text[-3000:]}")
    cfg = Arguments.load_from_yaml(os.path.join(here, DIST1_FIXTURE))
    cfg.data_args.cache_dir, cfg.log_args.save_dir = cache, runs["plain"]
    t1 = time.perf_counter()
    trainer = load_trainer(cfg)
    try:
        trainer.start()
    finally:
        trainer.cleanup()
    plain_s = time.perf_counter() - t1
    run = cfg.log_args.run_name
    lora = {kind: _lora_file_tensors(os.path.join(path, run, "final", "lora_transformer.safetensors"))
            for kind, path in runs.items()}
    same = set(lora["torchrun"]) == set(lora["plain"]) and all(
        torch.equal(lora["torchrun"][k], lora["plain"][k]) for k in lora["plain"])
    rows = [json.loads(line) for line in open(os.path.join(runs["torchrun"], run, "metrics.jsonl"))]
    train = [r for r in rows if "train/loss" in r]
    lo = min(r.get("train/ratio_min_min", r.get("train/ratio_min")) for r in train)
    hi = max(r.get("train/ratio_max_max", r.get("train/ratio_max")) for r in train)
    log(f"[dist1] the LoRA after the epoch ({len(lora['plain'])} tensors) launched and without a launcher: bit for "
        f"bit {same}; the launched run's ratio min {lo!r} max {hi!r} over its grad steps; the run without a "
        f"launcher {plain_s:.1f} s | {card}")
    if not same or not (lo == hi == 1.0):
        fail("[dist1] the launched epoch differs from the one without a launcher, or its ratio left 1.0")
    model = trainer.adapter.modules["transformer"]
    gen = torch.Generator(device="cuda").manual_seed(22)
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    inputs = (randn(2, 2, 32, 32, 16), torch.tensor([980.0, 980.0], device="cuda"), randn(2, 512, 4096))
    _f18_bisect_module().bisect("wan21-1.3b dist1 per-rank", model, inputs, 2, 1)
    del trainer, model, inputs
    gc.collect()
    torch.cuda.empty_cache()


def dist_only(flags) -> int:
    """``--ring`` and/or ``--dist1``: the build, then those phases alone."""
    import torch

    from flow_factory_tpu_torch.utils.base import use_full_fp32

    use_full_fp32()
    card = phase_environment()
    if "--ring" in flags:
        phase_ring({})
    if "--dist1" in flags:
        phase_dist1(card)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _mark(what: str) -> None:
    """Log the seconds since the whole script's first phase began, after ``what``."""
    log(f"[time] {what} done: {time.perf_counter() - _mark.start:.1f} s since the start")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "--k2-d128":
        return k2_d128_only(sys.argv[2])
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--norms":
        return norms_only(sys.argv[2], sys.argv[3:] == ["--sweep"])
    try:
        import flow_factory_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the flow_factory_tpu_torch package is not beside this script: {e}", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--import"]:
        return import_only()
    if sys.argv[1:] == ["--kontext"]:
        return kontext_only()
    if sys.argv[1:] == ["--decoupled"]:
        return decoupled_only()
    if sys.argv[1:] == ["--ltx2"]:
        return ltx2_only()
    if sys.argv[1:] == ["--wan22"]:
        return wan22_only()
    if sys.argv[1:] and set(sys.argv[1:]) <= {"--qwen", "--z-image"}:
        return qwen_only(sys.argv[1:])
    if sys.argv[1:] == ["--flux2"]:
        return flux2_only()
    if sys.argv[1:] == ["--decoupled-families"]:
        return decoupled_families_only()
    if sys.argv[1:] == ["--wan-i2v"]:
        return wan_i2v_only()
    if sys.argv[1:] == ["--full"]:
        return full_only()
    if sys.argv[1:] and set(sys.argv[1:]) <= {"--ring", "--dist1"}:
        return dist_only(sys.argv[1:])
    if sys.argv[1:] and set(sys.argv[1:]) <= {"--parity", "--hybrid"}:
        return parity_hybrid_only(sys.argv[1:])
    if sys.argv[1:] == ["--fp32"]:
        return fp32_only()
    if len(sys.argv) > 2 and sys.argv[1] == "--full-grad":
        return full_grad_only([int(a) for a in sys.argv[2:]])
    # fp32 convolutions (the VAE's last conv) run in full fp32, as the JAX reference does and as
    # the port's entry points set it
    from flow_factory_tpu_torch.utils.base import use_full_fp32

    use_full_fp32()

    _mark.start = time.perf_counter()
    card = phase_environment()
    results: dict = {}
    phase_kernels(results)
    _mark("kernel checks")
    phase_flux_kernels(results)
    phase_kontext_kernels(results)
    phase_decoupled_kernels(results)
    phase_ltx2_kernels(results)
    phase_wan22_kernels(results)
    phase_wan_i2v_kernels(results)
    phase_qwen_kernels(results)
    phase_flux2_kernels(results)
    _mark("family kernel checks")
    ring_counts = phase_ring(results)
    _mark("[ring]")
    phase_slice()
    _mark("[slice]")
    gc.collect()
    torch.cuda.empty_cache()  # the SD3.5 adapter is gone before the import's two load
    phase_import(card)
    _mark("[import]")
    gc.collect()
    torch.cuda.empty_cache()  # and gone again before Wan loads
    wan_counts = phase_wan()
    _mark("[wan]")
    gc.collect()
    torch.cuda.empty_cache()
    phase_grad()
    train_record: list = []
    train_figures: list = []
    counts = phase_train(train_record, train_figures)
    _mark("[grad], [train]")
    gc.collect()
    torch.cuda.empty_cache()  # the SD3.5 trainer is gone before the CLI's and the resumed trainer load
    phase_resume(train_record, card)
    _mark("[resume]")
    gc.collect()
    torch.cuda.empty_cache()  # and gone again before the Wan trainer loads
    log(f"[resume] device memory allocated once the SD3.5 trainers are freed: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    parity_counts = phase_parity()
    _mark("[parity]")
    hybrid_counts = phase_hybrid(results, train_figures)
    _mark("[hybrid]")
    gc.collect()
    torch.cuda.empty_cache()  # the hybrid trainer is gone before the Wan trainer loads
    phase_grad_wan()
    wan_train_counts = phase_wan_train()
    _mark("[grad] Wan, [wan-train]")
    gc.collect()
    torch.cuda.empty_cache()  # the Wan trainer is gone before the fp32 one loads
    wan_fp32_counts = phase_wan_fp32()
    _mark("[wan-fp32]")
    gc.collect()
    torch.cuda.empty_cache()  # and gone before the launched run and the full finetunes load
    phase_dist1(card)
    _mark("[dist1]")
    full_counts = _full_phases()
    _mark("full-finetune phases")
    phase_flux_grad()
    flux_counts = phase_flux_dpo()
    _mark("[flux-grad], [flux-dpo]")
    kontext_counts = _kontext_phases()
    _mark("Kontext phases")
    decoupled_counts = _decoupled_phases()
    _mark("[dgpo], [crd-wan]")
    ltx2_counts = _ltx2_phases()
    _mark("LTX-2 phases")
    wan22_counts = _wan22_phases()
    _mark("Wan2.2 phases")
    wan_i2v_counts = phase_wan_i2v()
    _mark("[wan-i2v14b]")
    qwen_counts = _qwen_phases()
    _mark("Qwen-conditioned phases")
    flux2_counts = _flux2_phases()
    _mark("FLUX.2 phases")
    family_counts = _decoupled_family_phases()
    _mark("decoupled family phases")
    phase_device_times()
    _mark("device times")
    # each kernel's launches on its main path: K3 in the Wan rollout, K2a/K2b
    # at head dim 128 in the Wan GRPO epochs, the others in the SD3.5 GRPO epochs
    counts["flash_fwd"] = wan_counts["flash_fwd"]
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        counts[f"{name}_d128"] = wan_train_counts[name]
    # the full finetunes run them at the same shapes: SD3.5-M's kernels in the SD3.5-M full phases' epochs,
    # K3 and K2a/K2b at head dim 128 in the Wan2.1 full phases'
    for tag, phase_counts in full_counts.items():
        if tag in ("full-sd35",) or FULL_DECOUPLED_PHASES.get(tag, {}).get("family") == "sd35":
            counts = _add(counts, {k: v for k, v in phase_counts.items() if k in SD35_KERNELS})
        else:
            counts["flash_fwd"] += phase_counts["flash_fwd"]
            for name in ("flash_bwd_dq", "flash_bwd_dkv"):
                counts[f"{name}_d128"] += phase_counts[name]
    # the FLUX.1 shapes: their kernels' launches in the two FLUX.1 DPO epochs
    for name, tags in (("flash_fwd", ("flux-512px-b2", "flux-512px-b8")),
                       ("flash_bwd_dq_d128", ("flux-512px",)), ("flash_bwd_dkv_d128", ("flux-512px",)),
                       ("ln_mul_add", ("flux-img", "flux-txt", "flux-joint")),
                       ("ln_mul_add_backward", ("flux-img", "flux-txt", "flux-joint"))):
        for tag in tags:
            results[name]["shapes"][tag]["launches"] = flux_counts[name.replace("_d128", "")]
    # the FLUX.1-Kontext shapes: their kernels' launches in the three Kontext phases
    for name, tags in KONTEXT_TAGS.items():
        for tag in tags:
            results[name]["shapes"][tag]["launches"] = kontext_counts[name.replace("_d128", "")]
    # the B 8 shapes: their kernels' launches in the DGPO and the CRD epochs
    for trainer_type, tags_of in DECOUPLED_TAGS.items():
        for name, tags in tags_of.items():
            for tag in tags:
                results[name]["shapes"][tag]["launches"] = decoupled_counts[trainer_type][name.replace("_d128", "")]
    # the decoupled trainers' phases run at their family's shapes: their launches join the family's
    ltx2_counts = _add(ltx2_counts, family_counts["ltx2-nft"], family_counts["ltx2-i2av-dpo"])
    for phase, tag in (("wan22-moe", "wan22-moe-awm"), ("wan22-ti2v", "wan22-ti2v-dgpo")):
        wan22_counts[phase] = _add(wan22_counts[phase], family_counts[tag])
    for phase, tag in (("z-image", "z-image-crd"), ("qwen-image", "qwen-image-nft"), ("qwen-edit", "qwen-edit-awm")):
        qwen_counts[phase] = _add(qwen_counts[phase], family_counts[tag])
    # the LTX-2 shapes: their kernels' launches in the two LTX-2 T2AV GRPO epochs and the LTX-2 decoupled phases
    for name, tags in LTX2_TAGS.items():
        for tag in tags:
            results[name]["shapes"][tag]["launches"] = ltx2_counts[name.replace("_d128", "")]
    # the Wan2.2 shapes: their kernels' launches in the TI2V-5B I2V and A14B T2V GRPO epochs
    for phase, tags_of in WAN22_TAGS.items():
        for name, tags in tags_of.items():
            for tag in tags:
                results[name]["shapes"][tag]["launches"] = wan22_counts[phase][name.replace("_d128", "")]
    # the Wan2.1-I2V image cross-attention: its share of its kernels' launches in [wan-i2v14b]'s epochs
    for name, tags in WAN_I2V_TAGS.items():
        for tag in tags:
            results[name]["shapes"][tag]["launches"] = wan_i2v_counts[name.replace("_d128", "")] // 3
    # the Qwen-conditioned shapes: their kernels' launches in the Z-Image, Qwen-Image and Edit-Plus epochs
    for name, tags in QWEN_TAGS.items():
        for tag, phases in tags.items():
            results[name]["shapes"][tag]["launches"] = sum(qwen_counts[p][name.replace("_d128", "")] for p in phases)
    # the FLUX.2 and Klein shapes: their kernels' launches in the [flux2] and [klein] epochs (Klein's K3 shape
    # is FLUX.1's rollout shape: its entry counts the FLUX.1 DPO epochs' and the Klein epochs' launches)
    for name, tags in FLUX2_TAGS.items():
        for tag, phases in tags.items():
            shape = results[name]["shapes"][tag]
            shape["launches"] = shape.get("launches", 0) + sum(flux2_counts[p][name.replace("_d128", "")]
                                                               for p in phases)
    # the hybrid backend's epoch: its K2a/K2b join SD3.5-M's D=64 rows; its K3 recomputes are the
    # SD3.5-M rows of K3, 24 joint and 13 self attentions a grad step
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        counts[name] += hybrid_counts[name]
    for tag, *_, per_step in HYBRID_K3_SHAPES:
        results["flash_fwd"]["shapes"][tag]["launches"] = hybrid_counts["flash_fwd"] * per_step // 37
    # the ring's hop shape: its kernels' launches in the one ring call of [ring]
    for name, launches in ring_counts.items():
        results[name]["shapes"][RING_SHAPE[0]]["launches"] = launches
    # the fp32 kernels: K3 and K2a/K2b at head dim 128 in [wan-fp32]'s epoch, K1 and K3 at head dim 16 in
    # [parity]'s auto pass (the tiny-d16 rows)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "qknorm_flash_fwd"):
        counts[f"{name}_f32"] = wan_fp32_counts[name] + parity_counts.get(name, 0)
    for name in ("flash_fwd_f32", "flash_bwd_dq_f32", "flash_bwd_dkv_f32"):
        shapes = results[name]["shapes"]
        shapes["tiny-d16-f32"]["launches"] = parity_counts.get(name[:-4], 0)  # the auto pass runs no backward
        shapes["sd35-self-f32"]["launches"] = 0  # no fp32 path at head dim 64 runs here
    results["qknorm_flash_fwd_f32"]["shapes"]["d128-f32"]["launches"] = 0  # nor a qk-norm one at 128
    # the other nested shapes (SD3.5's self, Wan's cross, the ragged checks) are the entry's path
    for name, entry in results.items():
        for shape in entry["shapes"].values():
            shape.setdefault("launches", counts[name])
    kernels = [{**entry, "launches": counts[name]} for name, entry in results.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
