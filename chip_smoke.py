#!/usr/bin/env python3
"""Drive the PyTorch port's Stage-1, Stage-2 (and its serving path) and Stage-3
paths once on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --mesh-cards   # a host of several cards: the
                                         # serving mesh over all of them

Phases (any failure raises and exits non-zero, without the result line):
  1. device: a CUDA card is required; prints its name and power limit;
  2. build: compiles every kernel of the paths (csrc/attention.cu,
     csrc/attention_block.cu, csrc/attention_variants.cu,
     csrc/mlp_int8.cu, csrc/linear_int8.cu, csrc/xlogy_rowsum.cu,
     csrc/smith_head.cu, csrc/packed_heads.cu, csrc/tile_gemm.cu,
     csrc/jpeg_decode.cu (linked to the toolkit's nvJPEG); nvcc, sm_90a,
     one process each, all started together) and the tar reader
     (csrc/host_io.cc, g++) from this checkout, with each one's time;
  3. attention kernel vs plain at the ViT-L/14 shape (B=64, T=257, H=16,
     Dh=64) and the ViT-B/32 shape (T=50, H=12), bf16 and fp32, with
     errors and CUDA-event times; F.scaled_dot_product_attention timed
     beside it as the yardstick (library_ms; the port never calls it).
     The same for the split-key and packed-pair schedules at ViT-L/14
     (bf16, fp32) and packed at T=50, and one-block at SigLIP's T=256
     (no class token, no remainder row) and, bf16, one-block and packed
     at ViT-L/14 at 336 px (T=577) and packed at T=1024; at T=50
     split_key takes the one-block schedule (its count is the one that
     moves). bf16 packed must equal bf16 one-block bit for bit at every
     shape. Beside each time: the body the launch took (bf16 every
     schedule the tensor-core body, "mma"; fp32 the CUDA-core body,
     "simt"), its shared memory a block, registers a thread and blocks
     an SM. Then, at ViT-L/14 bf16, the shipped packed pair (two heads
     side by side in a block) timed in turns beside the in-turn design
     (two heads walked in turn, the probes' group kernel at 2 heads a
     block) and one-block. Then each schedule's entry point,
     fused_attention(..., split_key=True) and (..., packed_heads=True),
     driven once with every count set to 0;
  3b. the attention sublayer kernel chain (fused_attention_block) vs
     plain at the ViT-L/14 sublayer (B=64, T=257, D=1024, H=16), bf16 and
     fp32, and a ragged small shape; beside it, for reference only (no
     single PyTorch call computes the sublayer), the chain F.layer_norm
     -> F.linear (QKV) -> SDPA -> F.linear -> add; the body, shared
     memory, registers and blocks an SM of its attention core; and, bf16,
     its two projections' (the wgmma body with the bias epilogue) shared
     memory, registers and blocks an SM, each launch of a call (LN, QKV,
     core, out-projection) timed apart by torch.profiler, and the
     projections alone (QKV; the out-projection with and without its
     residual) by CUDA events;
  4. int8 kernels vs plain at the ViT-L/14 shapes in bf16 (M = 64*257):
     mlp_int8 plain and fused pre-LN (D=1024, F=4096, tanh-GELU), once
     with 4-bit weights; linear_int8 for the fused QKV (N=3072, three
     outputs) and the out-projection (N=1024); and a ragged M. Beside
     them, for reference only (no single PyTorch call computes the W8A8
     function): the bf16 cuBLAS sublayer each replaces and torch._int_mm
     on the same int8 operands; the body (both GEMMs on the wgmma body
     of csrc/wgmma_gemm.cuh), shared memory, blocks an SM and registers
     of their GEMMs, and each call's launches (quantize, GEMM1, activation
     + requantize, GEMM2) timed apart by torch.profiler;
  5. EPIG joint-entropy kernel vs plain at the reference operating point
     (pool 4000, targets 2000, C=65, K=100 MC samples: a [260000, 130000]
     joint), bf16 and int8, a ragged small shape, and K=400 (the streamed
     instantiation; pool 1000, targets 500): row sums and EPIG
     scores within a stated tolerance, top-50 overlap with the plain
     ranking (printed), times, bound and the cuBLAS bf16 product of the
     same shape as a yardstick (reference only), and each instantiation's
     shared memory, registers, local memory and blocks an SM (the wgmma
     body: resident at K=100, streamed at K=400). The int8 kernel's path,
     `epig_from_probs_fused(use_int8=True)`, is read with its count;
  5b. fused probit head kernel (fused_probit_probs, csrc/smith_head.cu)
     vs plain in fp32 at B=2048 with C=1000, D=768 (ImageNet, ViT-L/14
     widths) and C=102, D=1024 (flowers102, SigLIP-L), at predict's head
     (B=64, C=100, D=768) and a ragged B=37, C=13, D=80: max |d| within
     rtol 1e-4 / atol 1e-5 at SigLIP's logit scale, rows summing to 1
     within 1e-5, the kernel's resources (registers, shared memory, local
     memory, cluster width), CUDA-event times and two bounds (3xTF32 on
     the tensor cores, the old fp32 CUDA-core one); a C past the
     shared-memory limit must raise;
  6. bf16 main path: ProbabilisticVLM.from_pretrained("clip-large", bf16,
     seeded random towers, synthetic full-dimension K-FAC factors) ->
     set_class_prompts(100 prompts) -> predict on [64, 224, 224, 3]
     pixels; checks shape, finiteness, row sums, 24 attention launches
     per image-tower forward and agreement with an fp32 predict;
  6b. serving, on that VLM: the uint8 lane's device-normalised pixels
     against the host float transform's (ulps) and the H2D ms of a
     B=64 batch in uint8 and fp32 (pageable and pinned); compile_serving
     on the pow2 ladder to 64 with uint8 input (one CUDA graph a size):
     seconds and #1's launches (24) counted while each size is captured,
     each size's replay equal to eager predict bit for bit; B=1 p50 / p95
     latency and B=64 img/s, graph against eager (host clock, the card
     synchronised); serve.BatchingServer with 8 client threads x 32
     requests at pipeline_depth 0 and 2 (every future resolved, no eager
     call, each row against eager predict within the run's bf16-vs-fp32
     log-prob difference, the stats); serve_cli's HTTP app on 127.0.0.1: 16 uint8 octet-stream
     requests, /healthz, /stats, a /class_prompts swap of the same count
     (labels copied in place) and of another count (the ladder captured
     again), rows against eager predict under the new prompts;
  6c. (run last: its ladder captures and child processes leave later
     torch.profiler sessions of the process short of kernel records)
     several models on one card: clip-large (pow2 ladder to 64) and
     siglip-large (google/siglip-large-patch16-256 widths, pow2 to 32),
     each from_pretrained (bf16, seeded towers, synthetic factors, 100
     prompts) with its uint8 ladder captured (#1's 24 launches counted at
     each capture, each replay equal to eager predict bit for bit);
     multiserve.MultiModelServer(max_wait_ms=2) with 8 closed-loop
     clients x 32 requests alternating models, at pipeline_depth 0 and 2:
     every row against its own model's eager predict within 6b's log-p
     limit, no eager call, img/s, fill and latency p50 / p95 a model,
     hbm_footprint() beside torch.cuda.memory_allocated(); save_serving
     and from_serving_cache a model, timed (wall, the card synchronised)
     against the from_pretrained + prompts + ladder it replaces, the
     restored replays bit-equal to the saved VLM's; serve_cli's HTTP app
     built by --models_json naming both with --aot_cache over those files
     (both restored): /predict/<model>, /predict without a model (400),
     /healthz with hbm_gib, /stats, a same-count /class_prompts/<model>
     swap (that lane serves the new labels, the other lane's rows are
     unchanged); then `python -m bayesvlm_tpu_torch.serve_cli
     --aot_cache` run twice as a child process on one directory, the
     second with its Hessian directory deleted: its log says it
     restored and its answers equal the first run's bit for bit;
  7. int8 main path: the same with mlp_int8=True, attn_int8=True; checks
     24 mlp_int8, 48 linear_int8 and 24 attention launches per forward,
     none from the text tower, and the image embeddings' cosine against
     the bf16 lane's; prints img/s beside the bf16 lane's; then a B=64
     CUDA graph of the lane (24 / 24 / 48 launches at capture, the
     replay equal to eager predict bit for bit);
  7b. block lane: the bf16 lane's towers, with the vision tower rebuilt
     from dataclasses.replace(vision, attn_pallas_block=True) and the
     same weights (as the JAX package reaches the lane), then
     set_class_prompts -> predict; checks 24 attention_block launches
     and no other per forward, none from the text tower, and the
     embeddings' cosine against the bf16 lane's; prints img/s; then a
     B=64 CUDA graph of the lane (24 launches at capture, the replay
     equal to eager predict bit for bit);
  7c. Stage 1 at clip-large width through the port's CLI,
     hessian_estimation.main: seeded bf16 towers, `synthetic` with 8192
     pairs of 224 px and 8192 distinct captions, batch 64, one class
     batch of 8192 (GGN block 2048), 300 lambda steps; prints the seconds
     of each step (features img / txt, GGN img / txt, lambda img / txt),
     pairs/s of the feature pass and the GGN's share of the wall; checks
     24 attention launches per image forward (3,072) and no other, the
     artifact directory (feature caches, A/B factors, prior precision),
     the factors finite, symmetric and SPD once regularized (Cholesky),
     and from_pretrained on that directory -> predict on 64 images;
  7e. the native decode lane (data/native_io.py): (b) nvJPEG's planes and
     ycc_to_rgb on the JPEG fixtures of tests/torch_jpeg/ (4:2:0, 4:4:4,
     4:2:2, progressive, grey, iid noise, 500x1 and 1x300 strips, cut in
     half, CMYK, not a JPEG): statuses equal to the goldens (the JAX
     lane's, libjpeg), the RGB against libjpeg's by chroma subsampling
     (max and mean |d|, share exact) within NATIVE_RGB_BOUND, the half-cut
     image's planes equal to NATIVE_TRUNCATED_SHA256, each 224 crop's
     difference printed; (c) ycc_to_rgb (csrc/jpeg_decode.cu) bit-equal to
     its plain version on the same nvJPEG planes at the lane's batch
     (B=64), and resize_crop on the same nvJPEG RGB (224 crops, uint8 and
     fp32), each directly and in a CUDA graph: CUDA-event times of the
     kernel alone (the graph's replay) and of the wrapper, the bound (for
     resize_crop on the source bytes under the crops' grids), the
     F.interpolate (+ crop slice) yardstick a image; nvJPEG's img/s alone
     and with ycc_to_rgb, the loader's samples/s; (d) the Stage-1 CLI,
     hessian_estimation.main (dataset="laion400m", native_decode=True,
     u8_pipeline=True) at clip-large on a tar of 1024 samples written from
     the fixtures (838 decode; the rest dropped with a warning, as the JAX
     lane drops them), batch 64, one class batch of 512, 100 lambda steps:
     #1's 24 launches a batch, ycc_to_rgb's and resize_crop's one a batch
     and pass, the artifact set, finite factors, the feature pass's img/s
     beside 7c's; (e) clip-large (bf16, seeded) embeddings of nvJPEG's
     crops against the goldens' crops, cosine >= NATIVE_COS_MIN a fixture,
     but for those in NATIVE_COS_APART (each with its range and reason);
  7d. kfac_ggn alone at one class batch of 32,768 seeded pairs (block
     2048): InfoNCE at clip-large's dims (embeddings 768, activations
     1024) and SigLIP at siglip-large's (1024, 4096 + bias, targets in
     chunks of 8000), at "highest" (fp32) and "high" (3xTF32): ms and
     pairs/s beside the fp32 bound, and B against a float64 evaluation of
     the same formula (max |d| / max |ref| <= 1e-4 and 1e-3);
  8. Stage-3 online EPIG path at clip-large width: from_pretrained, 6000
     pool and 2000 target images of seeded pixels and 65 prompts encoded,
     then select_epig_online(budget=3, num_samples=100,
     pool_subsampling="knn_wasserstein", the active-learning defaults);
     checks 3 distinct indices, finite scores, one kernel launch per step
     and pool chunk, and lambda moved; ms per step and its split;
  8d. active fine-tuning at clip-large width through the port's CLIs:
     activelearning.run (bf16, seeded towers, phase 6's synthetic
     full-dimension factors) on `synthetic` with 6000 train, 1000 val
     and 2000 test images of 224 px and 65 classes (HomeOffice's count),
     every other setting the CLI's default (subset 50, k_nearest 1, kNN
     wasserstein, 100 EPIG samples, batch 30, lr 1e-5, wd 5e-2) but 10
     fine-tune epochs in place of 100; then activelearning_kmeans.run on
     the same experiment directory (features from the cache) and the
     main CLI once more (a resume). Checks #1's launches (24 a vision
     forward of step [1], none from the text tower; none in the k-means
     run and the resume), #8's (one a step and pool chunk of epig_knn
     and of epig_direct, none in the resume), no other kernel, the 14
     strategies of each CLI with 50 unique train indices each, the 28
     img_projection.pt loaded with strict keys into the port's encoder,
     the best test accuracy and ECE finite and in [0, 1], and no
     strategy or subset redone by the resume; prints each step's and
     strategy's seconds, the feature pass's img/s, the ms of an EPIG
     step and the fine-tune's s a subset and steps/s. Then
     activelearning_elg.run on a fresh experiment directory with the same
     settings (its own feature pass: #1 864, #8 50; 15 strategies,
     egl_test among them) and activelearning_llm.run on that directory
     (features from the cache: #1 none, #8 50) with run_llm_difficulty and
     run_llm_value, a deterministic stub client (a score from the
     prompt's crc32) and no pacing: 16 strategies, 4000 stub calls, every
     subset's scores finite, 31 more checkpoints loaded strictly; EGL's
     ms (the strategy, and expected_gradient_length alone at 2000 x 65);
  8e. the partial-backbone fine-tune (train/backbone.py) at clip-large
     width: load_model(fp32, seeded), B=32 seeded 224 px images, the CE of
     cosine logits x 10 against 65 seeded targets, the last 2 layers and
     the projection trained (AdamW, lr 1e-4, wd 5e-2), three steps: the
     loss finite and falling, every frozen parameter bit-identical and
     every trained one moved, #1's 24 launches a forward (the gradient
     through its autograd.Function); step 1's gradients against the same
     step through the plain attention (fused_attention_reference) by
     relative norm a tensor, at BB_GRAD_TOL; the same three steps with
     remat=True: gradients, losses and parameters bit-equal, 26 launches a
     step (the two trained blocks recomputed), the device memory the
     steps add in both; one bf16 step (the tensor-core body differentiated): finite
     gradients, against the plain version at BB_GRAD_TOL["bf16"];
  8b. Stage-2 zero-shot evaluation at siglip-large width through the
     port's CLI, zeroshot.run (the steps under zeroshot.main): seeded
     bf16 towers (24 x 1024 vision at 256 px / 16, T=256; 24 x 1024
     text, length 64), synthetic
     full-dimension K-FAC factors (A 4097 image, 1025 text), `synthetic`
     with 2048 test images of 256 px and 100 classes, batch 64,
     pseudo_data_count 10 and the CLI's 1000 lambda steps; then the fused
     head on the run's own features and sigma. Checks ACC, NLPD, ECE
     finite (ECE in [0, 1]), lambda moved, 24 attention launches per
     image-tower forward (none from the text tower or the probe), one
     fused-head launch, and the fused head's probabilities against the
     CLI's (rtol 1e-4, atol 1e-5); prints the seconds of steps [1]-[4],
     img/s of the image features and the head's times at the run's shape
     beside the CLI's eager chain;
  8c. the HF checkpoint path at clip-large and siglip-large width: each
     model's seeded towers written as an HF snapshot under HF's names
     (to_hf_state_dict, below) with a trained-looking head, once
     as fp32 pytorch_model.bin (torch.save) and once as fp16
     model.safetensors (this script's writer); load_model (fp32) of each
     must give back the source tensors bit for bit (fp16-rounded for the
     safetensors copy) and the head; convert_weights on the snapshot,
     then load_model of its directory, the same tensors bit for bit;
     from_pretrained(bf16, weights_dir=the snapshot) -> predict at B=64
     must launch #1 24 times and nothing else. Prints each file's MB,
     the seconds load_model takes to read it (MB/s) and convert_weights'
     seconds, beside the card's name and power limit. No tokenizer or
     dataset phase: the card machine has no transformers and no PIL;
  9. tiny-clip on the card against tiny-clip on the CPU, in the default
     lane and in the block lane; tiny-siglip the same, default lane;
  10. (10 and 10b run right after 5, before the paths: torch.profiler
     sessions, which 10b reads, lost their kernel records in a process
     that had run 6-8e) the attention-schedule probes
     (bayesvlm_tpu_torch/probes, csrc/attention_variants.cu): v2, v3, v4, v5 (H/2 heads a block) and
     v6 (2 batch rows a block) vs plain at the probes' shape (B=80,
     T=257, H=16, Dh=64) and a ragged T=50, H=12, bf16 and fp32, v2 and
     v3 also in bf16 at T=1024, Dh 64 and 80; v5 and v6 also equal to #1
     of their dtype bit for bit; each with the body it took (bf16 the
     tensor-core body, fp32 the CUDA-core body);
  10b. the packed-head and GEMM probe kernels (csrc/packed_heads.cu,
     csrc/tile_gemm.cu) vs plain: qk scores and p . v, per head and
     packed (wgmma; q, k, v, o by TMA, the fp32 tensor by bulk copies),
     at B=80, T=257, H=16 and the ragged PACKED_SHAPES (qk rtol = atol =
     1e-4; pv one bf16 ulp and a mean |d| limit that a single bf16
     rounding of p must exceed, both means printed), with each kernel's
     threads, registers, shared memory, blocks an SM and local memory,
     the qk staging plan at each T, and at the probe's shape each
     kernel's CUDA-event time beside its device time a call by
     torch.profiler; the GEMM at the
     probes' M, K, N = 16384, 1024, 4096, a ragged 1000 x 128 x 1008 and
     1000 x 128 x 2144 (N past the last full epilogue box) and 1000 x 96
     x 1008 (K not a multiple of 64), bf16 and s8 on the wgmma body at
     each of its 8 configurations, s4 x s4 and s8 x s4 on its tile 0
     after their unpacking prepass (the prepass alone equal to the plain
     unpacking; s8, s4 x s4, s8 x s4 exact; bf16 within 1e-5 of max
     |ref|; at the probes' shape each s4 kind's prepass and GEMM timed
     apart by torch.profiler); then
     the probes' entry points, each probe module's run and report (the
     attention probes: the check against #1 and against plain,
     CUDA-event times beside #1, the bound and SDPA; probe_packed_heads,
     bench_int8_mxu, bench_int8_sweep (all 8 tiles) and bench_int4_mxu:
     their checks, then times beside the bound, plain and the library
     call of the same function where there is one: torch.baddbmm (fp32
     out) for qk, torch.mm (fp32 out) for the bf16 GEMM, torch._int_mm
     for s8), with every count set to 0 just before and read just after;
  12. (last, after 6c: its child processes leave nothing in this
     process) distribution (dist/) in child processes started as
     `chip_smoke.py --dist-worker nccl|gloo <spec>`: (a) NCCL at world
     size 1 through initialize_distributed's tcp://127.0.0.1 rendezvous
     (NCCL_SOCKET_IFNAME=lo): kfac_ggn(mesh=world) and the sharded GGN
     (its all_reduce) at 8192 pairs against one device's kfac_ggn, A and
     B within 1e-4 of their largest entry; epig_from_probs_sharded (its
     all_gather) at 4000 x 2000 against the dense scores, #8 counted;
     (b) two gloo ranks on cuda:0 (NCCL takes one rank a card, so this
     checks the multi-rank logic), joined through COORDINATOR_ADDRESS /
     NUM_PROCESSES / PROCESS_ID: each rank encodes its stripe of 2048
     synthetic pairs into its per-host caches (#1 counted a rank), then
     the Stage-1 CLI in both modes (empty tars name the shards; the
     caches make it skip its feature pass), its factors against a replay
     on the card (per host: one device's kfac_ggn on each shard and the
     allreduce arithmetic in float64; --dist_global_batch: float64, at 4x
     one device's own fp32 error), rank 1 writing nothing;
     select_epig_online over the world mesh equal to mesh=None (#8 a
     rank); the activelearning CLI in 8d's configuration, its indices
     and test metrics equal to 8d's main run, its files outside
     `_replica_host1` 8d's, rank 1's only its fine-tune logs there;
     each step's seconds a rank and the phase's;
  13. `parallel` (right after 6, before any graph capture or child
     process of this process, so that its trace reads torch.profiler's
     kernel records): the last modules of the port on one bf16 clip-large
     VLM on the serving mesh ["cuda:0", "cuda:0"] (two replicas on the
     one card; prior re-opt cut to 100 steps). (d) profiling first:
     `trace` over one eager sharded predict writes a Chrome trace that
     lists mha_mma_kernel, `debug_nans` raises on log(-1) on the card
     and lets a predict through, `StepTimer` over 5 predicts; (a) the
     serving mesh: the eager sharded predict (#1 24 launches a replica a
     forward) within phase 6's bf16-vs-fp32 max |log p| of the mesh-less
     predict, the uint8 ladder [2, 64] captured a replica (24 launches
     each) with each replay bit-equal to the eager sharded predict, B=64
     img/s against one replica's graph, a BatchingServer on the mesh,
     save_serving -> from_serving_cache bit-equal and a mesh of 3
     refused, and the int8 and block lanes of the same weights on the
     mesh (each replica its own int8 cache; launches eager and at
     capture; replay bit-equal); (b) tensor parallelism: two gloo ranks
     on cuda:0 (`chip_smoke.py --dist-worker tp <spec>`), the vision
     tower split over ("data", "model") = (1, 2), B=8, #1 24 launches a
     rank on 8 heads, held to the unsplit tower at TP_COS_MIN and
     TP_MAX_REL, forward ms a rank beside the unsplit; (c) the DCP lane: clip-large-sized
     factors .pt -> factors_dcp -> .pt bit for bit, an async save from
     the card read back bit-equal; (e) the preflight
     (`preflight.main`) on 8c's seeded clip-large snapshot (fp16
     safetensors and its config.json) with 128 synthetic images and
     --skip_parity (the parity step, fp32 on the CPU, is held by the CPU
     tests; at this width its elementwise tolerance is met by fp32
     summation order alone: preflight.step_parity), said so;
  11. prints the kernels line (the attention and probe entries with the
     body they launched, their shared memory, registers and blocks an
     SM), then the result line {"ok": true, "device": {...}} last.

Each path's launch counts (the Stage-1 CLI's too) are set to 0 just
before it and read just after; each phase's wall seconds are printed
("[phase <name>] s"); the launches of phases 3, 4, 5, 5b, 10's
and 10b's comparisons are not counted. A CUDA graph's replay runs no
Python, so a serving program's kernels are counted while it is captured
(each size's counts read between its capture's begin and end) and the
replay is shown to run them by its output, equal to eager predict's.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

MODEL = "clip-large"
BATCH = 64
NUM_PROMPTS = 100
PREDICT_CALLS = 5
SEED = 0
# bf16 kernel vs plain: both round p and the output to bf16; a different
# fp32 summation order moves a value across a rounding boundary by one
# bf16 ulp (2^-8 relative), and a p flip and an output flip can stack.
# fp32: summation order only.
KERNEL_TOL = {"bf16": 2.0 ** -6, "fp32": 1e-4}
# attention sublayer kernel vs plain: LN, q, k, v, p, the attention output,
# the out-projection and x + out are each rounded to bf16 once, at the same
# points in both. A flip upstream (one ulp of one q, k, v or a element)
# moves the fp32 sums after it by far less than an ulp of their result
# (it is one term of a 1024-term sum, ~2^-8 of its size), so what reaches
# the output is the last two roundings, out and x + out, one ulp each:
# the attention kernel's tolerance again. fp32: summation order only.
BLOCK_TOL = KERNEL_TOL
# block lane vs bf16 lane of the same weights: both bf16 with the same
# rounding points but one per projection (the block kernel adds the bias
# before it rounds) and the summation order; each changes a value by at
# most an ulp (2^-8), a random walk over 24 layers of ~1e-2 relative at
# worst, a cosine above 0.9999. 0.999 leaves room and still catches a
# wrong weight, head or layout (a cosine far below 0.99).
BLOCK_EMBED_COS_MIN = 0.999
# bf16 towers vs fp32 towers of the same weights. With random weights
# the probit probs are near uniform (max ~0.014 over 100 classes), so
# top-1 agreement is decided by noise-sized margins and is only printed.
# Checked instead: the log-probs, whose error is at most twice the
# largest logit error; a logit is a cosine times e^4.6 = 100 (divided by
# sqrt(1 + pi/8 var) >= 1), and bf16 keeps 2^-9 relative per rounding,
# which over 24 layers leaves cosine errors of a few 1e-3, i.e. logit
# errors of ~0.1-0.3. And the image embeddings' cosine similarity.
BF16_LOGP_ATOL = 0.5
BF16_EMBED_COS_MIN = 0.99
# int8 lane vs bf16 lane of the same weights: W8A8 rounds every
# activation row and weight channel to 1/127 of its absmax, a relative
# error of ~1-2% per sublayer output (the JAX package bounds one MLP at
# 5% relative L2, tests/test_mlp_int8.py). 48 such sublayers feed the
# residual stream; their errors are independent, so they add as a random
# walk, ~sqrt(48) * 2% = 14% relative L2 at worst-typical, a cosine of
# ~0.99. 0.95 leaves room for ~30% and still catches a lane that is
# wrong (a wrong scale or layout gives a cosine near 0).
INT8_EMBED_COS_MIN = 0.95
# tiny-clip fp32 on the card vs on the CPU: fp32 summation order only
TINY_TOL = 1e-4
# serving: the pow2 ladder up to BATCH, 8 clients x 32 requests each
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_WAIT_MS = 8, 32, 2.0
SERVE_LATENCY_CALLS, SERVE_THROUGHPUT_CALLS = 50, 10
# 6c: two models resident on one card behind one dispatcher, each on a
# uint8 pow2 ladder to its batch size (name -> model, batch size); the
# clients alternate models
MULTI_MODELS = {"clip": ("clip-large", BATCH), "siglip": ("siglip-large", 32)}
MULTI_TEXT_PROMPT = "a photo of a {class_name}"
MULTI_CLI_REQUESTS = 4  # uint8 requests to each serve_cli --aot_cache run
# A served row (a replay at the row's bucket) vs eager predict of the
# same image in a batch of BATCH: the same bf16 weights and kernels, but
# cuBLAS picks its GEMM by M, so a GEMM output may round the other way
# (one bf16 ulp, 2^-8) wherever its fp32 sum lands near a rounding
# boundary. Only some roundings flip, where bf16 against fp32 differs at
# every one, so the bound is the run's own bf16-vs-fp32 max |log p|
# difference (phase 6), measured on the same weights.
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and operations/s
# of the tensor cores by operand type (fp32: the CUDA cores)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12, "tf32": 494.7e12}
# transcendentals (MUFU lg2) per SM per clock; the card's rate is this
# times its SM count and maximum SM clock, read in phase_device
MUFU_PER_SM_CLOCK = 16
DEVICE = {}
# the EPIG reference operating point (the JAX package's bench.py)
EPIG_POOL, EPIG_TARG, EPIG_C, EPIG_K = 4000, 2000, 65, 100
# EPIG kernel vs plain, row sums: both take the same fp32 s (bf16 products
# are exact; int8 sums exact in both), so they differ by the fp32
# summation order of N = 130,000 terms of one sign (a kernel thread adds
# a row's N / 4 as tile sums of 16: at worst (16 + N / 64) * 2^-24 =
# 1.2e-4 of the sum, typically about the square root of that count times
# 2^-24, 3e-6) and by lg2.approx (<= 3e-7 s a term).
# A score is (sum over the C rows of a pool item) / N_t, so its error is
# at most 1e-4 * sum_c |r| / N_t.
ROWSUM_RTOL = 1e-4
# Stage-3 online EPIG path, the active-learning script's settings
# (scripts/activelearning.py:67-71, 185-210)
EPIG_POOL_IMAGES, EPIG_TARGET_IMAGES, EPIG_CLASSES = 6000, 2000, 65
EPIG_BUDGET, EPIG_CHUNK = 3, 4096
# 8d: active fine-tuning through the CLIs (scripts/activelearning.py's
# defaults; HomeOffice's 65 classes) on synthetic splits of 224 px, cut
# to 10 fine-tune epochs (the CLI's default is 100)
AL_SPLITS = dict(num_train=6000, num_val=1000, num_test=2000, num_classes=65)
AL_SUBSET, AL_EPOCHS, AL_PRECOMPUTE_BATCH = 50, 10, 256
# 8e: the partial-backbone fine-tune (train/backbone.py) at clip-large
# width: B seeded 224 px images, tests/test_backbone_finetune.py's loss
# (CE of cosine logits x 10) against 65 seeded targets, the last 2 layers
# and the projection trained, at lr 1e-4 (ten times the CLIs' 1e-5, so
# that three steps move the loss clearly) and the CLIs' wd 5e-2
BB_BATCH, BB_CLASSES, BB_K, BB_STEPS, BB_LR, BB_WD = 32, 65, 2, 3, 1e-4, 5e-2
# step 1's gradients through the kernel vs through its plain version, by
# relative norm a tensor. The backward is the plain version's in both, so
# they differ only where the forward does: by at most KERNEL_TOL a value
# of each attention output (phase 3: fp32 summation order; bf16 a rounding
# flip), in each of the 24 layers that feed the trained blocks. Were every
# output off by that much, the 24 would add as a random walk, sqrt(24) x
# KERNEL_TOL relative on what reaches the loss, and the gradients move in
# proportion; twice that is the bound.
BB_GRAD_TOL = {k: 2.0 * math.sqrt(24) * v for k, v in KERNEL_TOL.items()}
# fused probit head vs plain: both fp32, summation order only; the JAX
# package's tolerance (tests/test_pallas_smith.py:30)
SMITH_RTOL, SMITH_ATOL, SMITH_ROW_TOL = 1e-4, 1e-5, 1e-5
SMITH_SHAPES = {"imagenet vit-l/14": (2048, 1000, 768),
                "flowers102 siglip-l": (2048, 102, 1024),
                "predict head": (BATCH, NUM_PROMPTS, 768),
                "ragged": (37, 13, 80)}
# Stage-2 zero-shot evaluation (scripts/zeroshot.py's chain) at full width
ZS_MODEL, ZS_IMAGES, ZS_CLASSES, ZS_BATCH, ZS_IMAGE_SIZE = (
    "siglip-large", 2048, 100, 64, 256)
# Stage 1 (scripts/hessian_estimation.py) at full width through the CLI:
# synthetic pairs with distinct captions, one class batch
S1_MODEL, S1_PAIRS, S1_BATCH, S1_IMAGE_SIZE, S1_LA_BATCH, S1_LAMBDA_STEPS = (
    "clip-large", 8192, 64, 224, 2048, 300)
# the native decode lane (phase 7e): the Stage-1 CLI with --native_decode
# --u8_pipeline at S1_MODEL's widths over one tar of NATIVE_SAMPLES samples
# that cycle through tests/torch_jpeg/'s fixtures (two of the eleven fail to
# decode, as a web crawl's do), batch NATIVE_BATCH, one class batch of
# NATIVE_CLASSES, NATIVE_LAMBDA_STEPS lambda steps
NATIVE_SAMPLES, NATIVE_BATCH, NATIVE_CLASSES, NATIVE_LAMBDA_STEPS = 1024, 64, 512, 100
NATIVE_FIXTURES = Path(__file__).resolve().parent / "tests" / "torch_jpeg"
NATIVE_GRAPH_LAUNCHES = 20  # a kernel's launches in the graph that times it (_graph_ms)
# nvJPEG's planes + ycc_to_rgb against libjpeg's RGB (the JAX lane's
# decoder, the goldens' same-size square decodes), by chroma subsampling:
# (max |d|, mean |d|) allowed. The colour stage is libjpeg's, integer for
# integer, so what is left is the two IDCTs' rounding. Set from the first
# measurement on an H100 (nvJPEG of CUDA 12.9: 3 / 0.0288, 3 / 0.0266, 3 /
# 0.0268; nvJPEG's own RGBI read 15 / 2.125, 4 / 0.510, 13 / 1.438) and
# never to be loosened
NATIVE_RGB_BOUND = {"4:2:0": (3, 0.03), "4:4:4": (3, 0.03), "4:2:2": (3, 0.03)}
NATIVE_COS_MIN = 0.999  # clip-large embeddings, nvJPEG crops vs the goldens'
# the fixture where the decoders part, with its range and the reason, set
# from the first measurement on an H100 (cosine 0.392697) and never to be
# loosened. The range pins it both ways, with the bits of its planes
# (NATIVE_TRUNCATED_SHA256), so that any change in how nvJPEG fills past
# the cut fails the phase
NATIVE_COS_APART = {
    "truncated.jpg": ((0.383, 0.403), "an open fault (ROADMAP Queue 3): past the cut "
                      "libjpeg fills grey (128), nvJPEG keeps each component's last DC "
                      "value, a flat tint"),
}
# sha256 of nvJPEG's planes (Y, Cb, Cr) of tests/torch_jpeg/truncated.jpg
# (CUDA 12.9 on an H100; deterministic, whatever the buffer held before)
NATIVE_TRUNCATED_SHA256 = "8072b985bf80a7fa69774be01a10091ec2ce53ec10fbff7abde7005b68afb6cf"
# kfac_ggn alone at the CLI's default class batch (--la_num_classes 32768,
# --la_batch_size 2048, --siglip_chunk_size 8000): likelihood -> (model
# whose dims it takes, embedding dim, activation dim, logit scale, bias)
GGN_PAIRS, GGN_BLOCK, GGN_CHUNK_J = 32768, 2048, 8000
GGN_CASES = {"info_nce": ("clip-large", 768, 1024, 4.6052, 0.0),
             "siglip": ("siglip-large", 1024, 4096, 4.7651, -16.5)}
# max |B - B_fp64| / max |B_fp64|: fp32 at tests/test_hessians.py's rtol,
# 3xTF32 at the bound of JAX's test_infonce_precision_high_close_to_highest
GGN_TOL = {"highest": 1e-4, "high": 1e-3}
# kfac_ggn's device time by kind (torch.profiler kernel names; cuBLAS
# GEMMs by their library names, anything else "other": elementwise)
GGN_PARTS = (("GEMM", r"gemm|xmma|cutlass|Kernel2"), ("softmax", r"softmax"),
             ("reductions", r"reduce"))
# EPIG past the resident block's shared memory: the streamed instantiation
EPIG_LONG_POOL, EPIG_LONG_TARG, EPIG_LONG_K = 1000, 500, 400
# the dist phase (12): Stage 1 on two ranks at S1_MODEL's widths, DIST_S1_PAIRS
# synthetic pairs striped over the ranks by batch, class batches of
# DIST_S1_CLASSES (two a rank, four when gathered), DIST_S1_LAMBDA_STEPS
# lambda steps; each child's time limit
DIST_S1_PAIRS, DIST_S1_CLASSES, DIST_S1_LAMBDA_STEPS = 2048, 512, 50
DIST_TIMEOUT_S = 420
# a factor against its replay, and (a)'s sharded factors against one
# device's: 1e-4 of the largest entry (B at CLIP's scale is a difference of
# terms ~1e4 times larger than itself)
DIST_FACTOR_TOL = 1e-4
# the AL subsets' kNN similarities against one device's (the indices are
# held equal)
DIST_SIM_RTOL = 1e-4
# the probes of scripts/dev/, each run through its module's run and report
PROBES = ("bench_attn_variants", "bench_attn_variants2", "bench_attn_variants3",
          "bench_split_attn", "probe_packed_heads", "bench_int8_mxu", "bench_int8_sweep",
          "bench_int4_mxu")
# each probe kernel: the probe whose run gives its line, its source under
# bayesvlm_tpu_torch/csrc/ and the TPU body it replaces (under scripts/dev/)
PROBE_KERNELS = {
    "attention_v2": ("bench_attn_variants", "attention_variants.cu",
                     "bench_attn_variants.py:45"),
    "attention_v3": ("bench_attn_variants", "attention_variants.cu",
                     "bench_attn_variants.py:45"),
    "attention_v4": ("bench_attn_variants2", "attention_variants.cu",
                     "bench_attn_variants2.py:46"),
    "attention_group_heads": ("bench_attn_variants2", "attention_variants.cu",
                              "bench_attn_variants2.py:68"),
    "attention_group_rows": ("bench_attn_variants3", "attention_variants.cu",
                             "bench_attn_variants3.py:37"),
    "qk_scores": ("probe_packed_heads", "packed_heads.cu", "probe_packed_heads.py:46"),
    "qk_scores_packed": ("probe_packed_heads", "packed_heads.cu",
                         "probe_packed_heads.py:58"),
    "pv": ("probe_packed_heads", "packed_heads.cu", "probe_packed_heads.py:86"),
    "pv_packed": ("probe_packed_heads", "packed_heads.cu", "probe_packed_heads.py:97"),
    "tile_gemm_bf16": ("bench_int8_mxu", "tile_gemm.cu", "bench_int8_mxu.py:64"),
    "tile_gemm_s8": ("bench_int8_mxu", "tile_gemm.cu", "bench_int8_mxu.py:64"),
    "tile_gemm_s4": ("bench_int4_mxu", "tile_gemm.cu", "bench_int4_mxu.py:49"),
    "tile_gemm_s8s4": ("bench_int4_mxu", "tile_gemm.cu", "bench_int4_mxu.py:49"),
}
# what a probe kernel's line carries beside the contract's keys, where its
# probe gives it (reference_ms: a product of another function, timed for
# reference only)
PROBE_EXTRAS = ("smem_bytes", "blocks_per_sm", "base_ms", "vs_base", "tops", "tile", "mma",
                "yardstick", "reference_ms")
# the body of each kernel source other than the attention kernel, the
# attention probes and the GEMM probes (which report their own: the GEMMs
# "wgmma" for all four kinds, the s4 kinds after an unpacking prepass
# that widens their nibbles to s8): "wgmma" where its
# products run on wgmma fed by TMA with the PTX of csrc/wgmma_gemm.cuh
# (the attention sublayer's bf16 projections, the int8 lane's two kernels,
# the EPIG kernel, the fused head's 3xTF32 products), "mma" where they run
# on the tensor cores by mma.sync, "simt" where they run as fp32 FMAs on
# the CUDA cores
SOURCE_BODY = {"attention_block.cu": "wgmma", "mlp_int8.cu": "wgmma", "linear_int8.cu": "wgmma",
               "xlogy_rowsum.cu": "wgmma", "smith_head.cu": "wgmma", "packed_heads.cu": "wgmma",
               "jpeg_decode.cu": "simt"}
# the packed-head kernels at the probe's shape (first: the one timed) and
# ragged ones (B, T, H): T mod 4 = 2, 3, 0, 1 (a last strip of one row), T =
# 1, and T = 577 (two p chunks a side, qk strips of fewer than 64 rows
# packed); probes/compare_builds.py --packed checks the same
PACKED_SHAPES = {"probe": (80, 257, 16), "ragged": (3, 50, 12), "t63": (4, 63, 6),
                 "t64": (3, 64, 4), "t65": (2, 65, 8), "t1": (3, 1, 2), "t577": (2, 577, 4)}
# the launches inside one packed-head kernel call (csrc/packed_heads.cu)
PACKED_PARTS = (("qk_kernel", r"qk_kernel"), ("pv_kernel", r"pv_kernel"))
# the GEMM at the probes' shape and three ragged ones (M, K, N); N a
# multiple of 16; "ragged-n" (N = 96 mod 128 and 256: the wgmma epilogue
# skips the boxes past N); "ragged-k" (K not a multiple of a wgmma stage,
# 64 bf16 or 128 s8, nor of 64: the s4 kinds' packed A rows are 48 bytes)
GEMM_SHAPES = {"probe": (16384, 1024, 4096), "ragged": (1000, 128, 1008),
               "ragged-n": (1000, 128, 2144), "ragged-k": (1000, 96, 1008)}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float, op_type: str,
          transcendentals: float = 0.0) -> dict:
    """The least time the card could take: the largest of the bytes over
    the memory rate, the operations over the peak rate of their type and
    the transcendentals over the MUFU rate."""
    times = {"bytes": nbytes / HBM_BYTES_S * 1e3,
             "operations": ops / PEAK_OPS_S[op_type] * 1e3,
             "transcendentals": transcendentals / DEVICE.get("mufu_s", 1.0) * 1e3}
    by = max(times, key=times.get)
    return {"bound_ms": times[by], "bound_by": by}


def phase_device(torch) -> str:
    check(torch.cuda.is_available(), "no CUDA device: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    DEVICE["card"] = smi.stdout.strip().splitlines()[0]
    print(f"card: {DEVICE['card']}")
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    check(clk.returncode == 0, f"nvidia-smi failed: {clk.stderr.strip()}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(clk.stdout.strip().splitlines()[0])
    DEVICE["mufu_s"] = MUFU_PER_SM_CLOCK * sms * mhz * 1e6
    print(f"SMs {sms}, max SM clock {mhz:.0f} MHz: {DEVICE['mufu_s']:.4e} "
          f"transcendentals/s")
    # cuDNN runs fp32 convolutions in TF32 by default; fp32 matmuls stay
    # full fp32 (the default, left as it is)
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    return torch.cuda.get_device_name(0)


def phase_build(kernels, modules) -> None:
    t0 = time.perf_counter()
    seconds = kernels.build_all()
    wall = time.perf_counter() - t0
    for name, sec in seconds.items():
        took = "already built" if sec is None else f"{sec:.2f} s"
        print(f"build: {kernels.library_path(name).name} {took}")
    print(f"build: {len(seconds)} kernels in {wall:.2f} s wall (in parallel)")
    check(set(seconds) == {"attention", "attention_block", "attention_variants",
                           "mlp_int8", "linear_int8", "xlogy_rowsum", "smith_head",
                           "packed_heads", "tile_gemm", "jpeg_decode"},
          f"kernel sources {sorted(seconds)}")
    sec = kernels.build_host("host_io")  # the tar reader (g++)
    took = "already built" if sec is None else f"{sec:.2f} s"
    print(f"build: {kernels.host_library_path('host_io').name} {took} (g++)")
    for module in modules:
        module._library()


def _attention_case(torch, attention, label: str, B: int, T: int, H: int, Dh: int,
                    dname: str, **schedule) -> dict:
    """One schedule of the attention kernel vs plain on seeded q, k, v."""
    import torch.nn.functional as F

    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dname]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn(B, T, H * Dh, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    out = attention.fused_attention(q, k, v, H, **schedule)
    ref = attention.fused_attention_reference(q, k, v, H)
    torch.cuda.synchronize()
    if schedule.get("packed_heads") and dname == "bf16":
        # each warp of the pair does a one-block warp's work for its head
        same = torch.equal(out, attention.fused_attention(q, k, v, H))
        print(f"attention {label} bf16 equal to one-block bit for bit: {same}")
        check(same, f"{label} bf16 packed pair differs from one-block")
    err = (out.float() - ref.float()).abs()
    tol = KERNEL_TOL[dname]
    worst = float((err / (tol + tol * ref.float().abs())).max())
    ms = cuda_ms(torch, lambda: attention.fused_attention(q, k, v, H, **schedule))
    plain_ms = cuda_ms(torch, lambda: attention.fused_attention_reference(q, k, v, H))
    heads = [t.view(B, T, H, Dh).transpose(1, 2) for t in (q, k, v)]
    library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(*heads))
    # the real work whatever the schedule: q, k, v read and o written once,
    # 4 B H T^2 Dh operations (no padded keys, no zero blocks)
    b = bound(4 * B * T * H * Dh * q.element_size(), 4 * B * H * T * T * Dh, dname)
    max_err = float(err.max())
    res = attention.kernel_resources(T, Dh, dtype, attention.schedule_for(T, **schedule))
    print(f"attention {label} vs plain {dname} B={B} T={T} H={H} Dh={Dh}: "
          f"max_abs_err={max_err:.3e} (tol {tol:.3e} abs + rel, worst/bound="
          f"{worst:.3f}) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"sdpa_ms={library_ms:.4f} bound_ms={b['bound_ms']:.4f} ({b['bound_by']})"
          f"\n  body {res['body']}: {res['smem_bytes']} B shared memory, "
          f"{res['registers']} registers a thread, {res['blocks_per_sm']} blocks/SM")
    check(worst <= 1.0, f"{label} {dname} attention kernel disagrees with plain "
                        f"(max_abs_err {max_err})")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                **b, **res)


def phase_attention_vs_plain(torch, attention) -> dict:
    """The three schedules of csrc/attention.cu vs plain."""
    shapes = {"vit-l/14": (BATCH, 257, 16, 64), "vit-b/32": (BATCH, 50, 12, 64),
              "siglip-l/16": (BATCH, 256, 16, 64)}
    results = {}
    for shape_name, shape in shapes.items():
        for dname in ("bf16", "fp32"):
            results[(shape_name, dname)] = _attention_case(
                torch, attention, f"one-block {shape_name}", *shape, dname)
    for sched in ("split_key", "packed_heads"):
        for dname in ("bf16", "fp32"):
            results[("vit-l/14", dname, sched)] = _attention_case(
                torch, attention, f"{sched} vit-l/14", *shapes["vit-l/14"], dname,
                **{sched: True})
    results[("vit-b/32", "bf16", "packed_heads")] = _attention_case(
        torch, attention, "packed_heads vit-b/32", *shapes["vit-b/32"], "bf16",
        packed_heads=True)
    # ViT-L/14 at 336 px: T=577, past what the CUDA-core body's bf16 score
    # tile held at its speed (the tensor-core body takes any T); the
    # packed pair there, and at T=1024, past what its two score tiles held
    results[("vit-l/14-336", "bf16")] = _attention_case(
        torch, attention, "one-block vit-l/14-336", BATCH, 577, 16, 64, "bf16")
    results[("vit-l/14-336", "bf16", "packed_heads")] = _attention_case(
        torch, attention, "packed_heads vit-l/14-336", BATCH, 577, 16, 64, "bf16",
        packed_heads=True)
    results[("t1024", "bf16", "packed_heads")] = _attention_case(
        torch, attention, "packed_heads T=1024", 16, 1024, 16, 64, "bf16",
        packed_heads=True)
    # T=50 has no 128-key main block: split_key takes the one-block
    # schedule, as in JAX, and counts there
    fa = attention.fused_attention
    before = fa.launches, fa.launches_split
    _attention_case(torch, attention, "split_key vit-b/32", *shapes["vit-b/32"], "bf16",
                    split_key=True)
    moved = fa.launches - before[0], fa.launches_split - before[1]
    print(f"attention split_key at T=50 (t_main = 0) took the one-block schedule: "
          f"one-block launches +{moved[0]}, split-key +{moved[1]}")
    check(moved[0] > 0 and moved[1] == 0, "split_key at T=50 must run one-block")
    return results


def phase_packed_pair_designs(torch, attention, av) -> dict:
    """The packed pair's two tensor-core designs at ViT-L/14 bf16, timed
    in turns (side, in turn, #1, #1, in turn, side; each the best of its
    two): the shipped one, two heads side by side in a block of 8 warps
    (fused_attention(..., packed_heads=True)), and two heads walked in
    turn by a block of 4 warps (mha_mma_kernel<64, kOneBlock, 2, 1>, the
    probes' group kernel at 2 heads a block, launched through the probe
    library for this timing only). Both must equal #1 bit for bit."""
    from bayesvlm_tpu_torch import kernels

    B, T, H, Dh = BATCH, 257, 16, 64
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    q, k, v = (torch.randn(B, T, H * Dh, generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    lib = av._library()
    o = torch.empty_like(q)

    def in_turn():
        err = lib.bvt_attn_variant(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                   B, T, H, Dh, 1, 1.0 / math.sqrt(Dh), av.GROUP, 2, 1,
                                   torch.cuda.current_stream().cuda_stream)
        kernels.check(lib, err, "in-turn packed pair")
        return o

    designs = {"side_by_side": lambda: attention.fused_attention(q, k, v, H,
                                                                 packed_heads=True),
               "in_turn": in_turn,
               "one_block": lambda: attention.fused_attention(q, k, v, H)}
    base = designs["one_block"]()
    for name in ("side_by_side", "in_turn"):
        same = torch.equal(designs[name](), base)
        check(same, f"packed pair {name} differs from one-block")
    ms = {name: math.inf for name in designs}
    for name in ("side_by_side", "in_turn", "one_block", "one_block", "in_turn",
                 "side_by_side"):
        ms[name] = min(ms[name], cuda_ms(torch, designs[name], iters=50))
    print(f"packed pair designs B={B} T={T} H={H} Dh={Dh} bf16 (both equal to one-block "
          f"bit for bit): side by side {ms['side_by_side']:.4f} ms (shipped), in turn "
          f"{ms['in_turn']:.4f} ms, one-block {ms['one_block']:.4f} ms")
    return ms


def phase_schedule_paths(torch, attention, counters) -> dict:
    """The entry point that reaches the split-key and packed-pair kernels
    in JAX, fused_attention(q, k, v, 16, split_key=True) and
    (..., packed_heads=True), at the ViT-L/14 shape in bf16, each driven
    once with every count set to 0 just before and read just after."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    q, k, v = (torch.randn(BATCH, 257, 1024, generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    launches = {}
    for sched, count in (("split_key", "attention_split"),
                         ("packed_heads", "attention_packed")):
        for c in counters.values():
            c.launches = 0
        out = attention.fused_attention(q, k, v, 16, **{sched: True})
        torch.cuda.synchronize()
        got = {n: c.launches for n, c in counters.items()}
        print(f"{sched} path fused_attention(..., {sched}=True) B={BATCH} T=257: "
              f"launches={got}")
        check(got == {n: int(n == count) for n in counters}, f"{sched} path launches")
        check(bool(torch.isfinite(out.float()).all()), f"{sched}: non-finite output")
        launches[count] = got[count]
    return launches


def phase_block_vs_plain(torch, attention) -> dict:
    """The attention sublayer kernel chain vs plain."""
    import torch.nn.functional as F

    results = {}
    for label, (B, T, D, H) in (("vit-l/14", (BATCH, 257, 1024, 16)),
                                ("ragged", (3, 37, 80, 1))):
        for dname in ("bf16", "fp32"):
            dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dname]
            gen = torch.Generator(device="cuda").manual_seed(SEED + 8)

            def randn(*shape, scale=1.0):
                return torch.randn(*shape, generator=gen, device="cuda") * scale

            x = randn(B, T, D).to(dtype)
            ln_w, ln_b = 1.0 + randn(D, scale=0.1), randn(D, scale=0.1)
            ws = [randn(D, D, scale=D ** -0.5).to(dtype) for _ in range(4)]
            bs = [randn(D, scale=0.02).to(dtype) for _ in range(4)]
            params = [t for pair in zip(ws, bs) for t in pair]
            run = lambda: attention.fused_attention_block(x, ln_w, ln_b, *params,
                                                          num_heads=H)
            plain = lambda: attention.fused_attention_block_reference(
                x, ln_w, ln_b, *params, num_heads=H)
            out, ref = run(), plain()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            tol = BLOCK_TOL[dname]
            worst = float((err / (tol + tol * ref.float().abs())).max())
            r = {"max_abs_err": float(err.max())}
            print(f"attention block {label} vs plain {dname} B={B} T={T} D={D} H={H}: "
                  f"max_abs_err={r['max_abs_err']:.3e} (tol {tol:.3e} abs + rel, "
                  f"worst/bound={worst:.3f})")
            check(worst <= 1.0, f"{label} {dname} attention block kernel disagrees "
                                f"with plain (max_abs_err {r['max_abs_err']})")
            if label == "ragged":
                continue
            r["ms"], r["plain_ms"] = cuda_ms(torch, run), cuda_ms(torch, plain, iters=5)
            r["core"] = attention.kernel_resources(T, D // H, dtype)
            if dname == "bf16":
                # the two projections on the wgmma body: what they take, and
                # each launch of a call timed apart
                r["gemms"] = attention.block_gemm_resources()
                r["parts_ms"] = _launch_parts(torch, run, BLOCK_PARTS)
                r["projections_ms"] = _block_projections_ms(torch, attention, x, ws, bs)
                print(f"  bf16 GEMMs (wgmma_gemm_kernel, EpiBias): {r['gemms']}")
                _print_parts(f"attention block {label}", r["parts_ms"])
                print(f"  the projections alone (CUDA events, on x as the input): "
                      f"{r['projections_ms']}")
            # yardstick (reference only): the cuBLAS / SDPA chain on the same
            # tensors, the QKV weights concatenated once outside the timing
            wqkv, bqkv = torch.cat(ws[:3]), torch.cat(bs[:3])

            def chain():
                h = F.layer_norm(x.float(), (D,), ln_w, ln_b, 1e-5).to(dtype)
                q, k, v = (t.view(B, T, H, D // H).transpose(1, 2)
                           for t in F.linear(h, wqkv, bqkv).split(D, dim=-1))
                a = F.scaled_dot_product_attention(q, k, v)
                return x + F.linear(a.transpose(1, 2).reshape(B, T, D), ws[3], bs[3])

            r["chain_ms"] = cuda_ms(torch, chain)
            # the function's bytes: x read, out written, the four weights,
            # biases and LN parameters; its operations: the four products
            # and the attention core (attention_pallas.py:344)
            Dh = D // H
            nbytes = ((2 * B * T * D + 4 * D * D + 4 * D) * x.element_size()
                      + 2 * D * 4)
            r.update(bound(nbytes, B * (8 * T * D * D + 4 * H * T * T * Dh), dname))
            print(f"  kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                  f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}); yardstick "
                  f"(reference only) LN -> F.linear QKV -> SDPA -> F.linear -> add "
                  f"{r['chain_ms']:.4f} ms; attention core: {r['core']}")
            results[dname] = r
    return results


def _block_projections_ms(torch, attention, x, ws, bs) -> dict:
    """The sublayer's bf16 projections alone through their C entry, on x
    [B, T, D] as the input: QKV (three weights), the out-projection with
    the residual x, and without it (the residual's cost)."""
    a = x.view(-1, x.shape[-1])
    out = torch.empty(3, *a.shape, device=x.device, dtype=x.dtype)

    def gemm(idx, residual):
        return lambda: attention._block_projection(a, [ws[i] for i in idx],
                                                   [bs[i] for i in idx], residual, out)

    return {"qkv": cuda_ms(torch, gemm((0, 1, 2), None), iters=50),
            "out_proj": cuda_ms(torch, gemm((3,), a), iters=50),
            "out_proj_no_residual": cuda_ms(torch, gemm((3,), None), iters=50)}


def _flip_check(torch, name: str, out, ref) -> dict:
    """An int8 kernel against its plain version, to the lane's flip
    tolerance (the JAX package's, tests/test_mlp_int8.py:50-62)."""
    from bayesvlm_tpu_torch.models.mlp_int8 import FLIP_TOL_MAX, FLIP_TOL_MEAN

    d = (out.float() - ref.float()).abs()
    scale = float(ref.float().abs().max()) + 1e-12
    max_err, mean_err = float(d.max()), float(d.mean())
    print(f"  {name}: max_abs_err={max_err:.3e} (tol {FLIP_TOL_MAX * scale:.3e}) "
          f"mean_abs_err={mean_err:.3e} (tol {FLIP_TOL_MEAN * scale:.3e}) "
          f"flipped={int((d > 0).sum())}/{d.numel()}")
    check(max_err <= FLIP_TOL_MAX * scale and mean_err <= FLIP_TOL_MEAN * scale,
          f"{name}: the kernel disagrees with its plain version")
    return {"max_abs_err": max_err, "mean_abs_err": mean_err}


# the launches inside one int8 kernel call, by the name the profiler gives
# them (the first pattern that matches)
INT8_PARTS = (("GEMM1 (EpiDequant<float, false>)", r"EpiDequant<float, false>"),
              ("GEMM2 or linear (EpiDequant<out, residual>)", r"EpiDequant<"),
              ("activation + requantize (act_quant_rows_kernel)", r"act_quant_rows_kernel"),
              ("quantize x (quant_rows_kernel)", r"quant_rows_kernel"))
# the same for one attention sublayer call (csrc/attention_block.cu)
BLOCK_PARTS = (("QKV (wgmma_gemm_kernel, EpiBias<false>)", r"EpiBias<false>"),
               ("out-projection + residual (EpiBias<true>)", r"EpiBias<true>"),
               ("LayerNorm (ln_rows_kernel)", r"ln_rows_kernel"),
               ("attention core (mha_mma_kernel)", r"mha_mma_kernel|mha_kernel"))


def _launch_parts(torch, fn, table=INT8_PARTS, calls: int = 5,
                  sessions: int = 3) -> dict:
    """Each launch of a kernel call timed apart: torch.profiler over
    `calls` calls, device ms a call by `table` (anything else under
    "other"). A profiler session now and then records no device event
    at all; such a session is taken again, up to `sessions` in all."""
    import re

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(sessions):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        parts: dict = {}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            label = next((lb for lb, pat in table if re.search(pat, e.key)), "other")
            parts[label] = parts.get(label, 0.0) + us / 1e3 / calls
        if sum(parts.values()) > 0:
            return parts
        print("  torch.profiler recorded no device time; session taken again")
    check(False, f"the profiler recorded no device time for a kernel call in "
                 f"{sessions} sessions")


def _print_parts(label: str, parts: dict) -> None:
    total = sum(parts.values())
    print(f"  {label} by launch (torch.profiler, device ms a call; shares of "
          f"{total:.4f}): " + ", ".join(f"{k} {v:.4f} ({v / total:.1%})"
                                       for k, v in sorted(parts.items(), key=lambda kv: -kv[1])))


def phase_int8_vs_plain(torch, mlp, linear) -> dict:
    """Both int8 kernels at the ViT-L/14 int8 lane's shapes, bf16: each
    against plain, its time beside the bound and the yardsticks, its GEMMs'
    resources, and the share of each launch inside a call."""
    import torch.nn.functional as F

    M, D, Fd = BATCH * 257, 1024, 4096
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    x = randn(M, D).bfloat16()
    w1 = randn(Fd, D, scale=D ** -0.5).bfloat16()
    w2 = randn(D, Fd, scale=Fd ** -0.5).bfloat16()
    b1, b2 = randn(Fd, scale=0.02), randn(D, scale=0.02)
    ln = dict(ln_weight=1.0 + randn(D, scale=0.1), ln_bias=randn(D, scale=0.1),
              ln_eps=1e-5)
    results = {}

    print(f"int8 kernels vs plain (bf16, M={M}):")
    for label, bits, kw in (("mlp_int8 plain", 8, {}), ("mlp_int8 fused-LN", 8, ln),
                            ("mlp_int8 fused-LN w4", 4, ln)):
        quant = mlp.quantize_mlp_weights(w1, w2, bits)
        run = lambda: mlp.mlp_int8(x, w1, b1, w2, b2, "gelu_tanh", quant=quant, **kw)
        plain = lambda: mlp.mlp_int8_reference(x, w1, b1, w2, b2, "gelu_tanh",
                                               quant=quant, **kw)
        out, ref = run(), plain()
        torch.cuda.synchronize()
        r = _flip_check(torch, f"{label} D={D} F={Fd}", out, ref)
        r["ms"], r["plain_ms"] = cuda_ms(torch, run), cuda_ms(torch, plain, iters=5)
        # the function's bytes: x read, out written, int8 weights, fp32
        # scales, biases and LN parameters; its operations: the two int8
        # products (the fp32 epilogues are ~1% of them)
        nbytes = (2 * M * D * x.element_size() + 2 * D * Fd
                  + 4 * (2 * Fd + 2 * D + (2 * D if kw else 0)))
        r.update(bound(nbytes, 4 * M * D * Fd, "int8"))
        r.update(mlp.kernel_resources(x.dtype))
        print(f"  {label}: kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}); body {r['body']}: "
              f"{r['smem_bytes']} B shared memory, {r['blocks_per_sm']} blocks/SM, "
              f"registers at launch GEMM1 / GEMM2 {r['registers_gemm']}")
        r["parts_ms"] = _launch_parts(torch, run)
        _print_parts(label, r["parts_ms"])
        results[label] = r

    xq, _ = mlp._quant_rows(x.float())
    w1q, w2q = mlp.quantize_weight(w1)[0], mlp.quantize_weight(w2)[0]
    aq = torch.randint(-127, 128, (M, Fd), generator=gen, device="cuda",
                       dtype=torch.int8)
    yard = {
        "bf16_cublas_ms": cuda_ms(torch, lambda: F.linear(
            F.gelu(F.linear(x, w1, b1.bfloat16()), approximate="tanh"),
            w2, b2.bfloat16())),
        "int_mm_ms": cuda_ms(torch, lambda: (torch._int_mm(xq, w1q.t()),
                                             torch._int_mm(aq, w2q.t()))),
    }
    print(f"  yardsticks mlp (reference only): bf16 F.linear->GELU->F.linear "
          f"{yard['bf16_cublas_ms']:.4f} ms, torch._int_mm x2 "
          f"{yard['int_mm_ms']:.4f} ms")
    results["mlp_int8 yardsticks"] = yard
    del aq

    wqkv = randn(3 * D, D, scale=D ** -0.5).bfloat16()
    bqkv = randn(3 * D, scale=0.02)
    wo, bo = randn(D, D, scale=D ** -0.5).bfloat16(), randn(D, scale=0.02)
    for label, w, b, chunks in (("linear_int8 qkv", wqkv, bqkv, 3),
                                ("linear_int8 out_proj", wo, bo, 1)):
        N = w.shape[0]
        run = lambda: linear.linear_int8(x, w, b, chunks=chunks)
        plain = lambda: linear.linear_int8_reference(x, w, b)
        out = run()
        out = torch.cat(out, dim=-1) if chunks > 1 else out
        ref = plain()
        torch.cuda.synchronize()
        r = _flip_check(torch, f"{label} K={D} N={N}", out, ref)
        r["ms"], r["plain_ms"] = cuda_ms(torch, run), cuda_ms(torch, plain, iters=5)
        # bytes: x read, out written, the bf16 weight (quantized per call,
        # as in the JAX package), the fp32 bias
        nbytes = (M * D + M * N) * x.element_size() + N * D * w.element_size() + 4 * N
        r.update(bound(nbytes, 2 * M * D * N, "int8"))
        wq = linear.quantize_weight(w)[0]
        r["bf16_cublas_ms"] = cuda_ms(torch, lambda: F.linear(x, w, b.bfloat16()))
        r["int_mm_ms"] = cuda_ms(torch, lambda: torch._int_mm(xq, wq.t()))
        r.update(linear.kernel_resources(x.dtype, N, chunks))
        print(f"  {label}: kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}); yardsticks "
              f"(reference only): bf16 F.linear {r['bf16_cublas_ms']:.4f} ms, "
              f"torch._int_mm {r['int_mm_ms']:.4f} ms; body {r['body']}: "
              f"{r['smem_bytes']} B shared memory, {r['blocks_per_sm']} blocks/SM, "
              f"{r['registers']} registers at launch, TMA store {r['tma_store']}")
        check(r["tma_store"], f"{label}: the chunked output should go out by the TMA")
        r["parts_ms"] = _launch_parts(torch, run)
        _print_parts(label, r["parts_ms"])
        results[label] = r

    # a ragged M (no multiple of the 128-row tile or of 32)
    Mr = 333
    xr = x[:Mr]
    quant = mlp.quantize_mlp_weights(w1, w2)
    _flip_check(torch, f"mlp_int8 fused-LN ragged M={Mr}",
                mlp.mlp_int8(xr, w1, b1, w2, b2, quant=quant, **ln),
                mlp.mlp_int8_reference(xr, w1, b1, w2, b2, quant=quant, **ln))
    _flip_check(torch, f"linear_int8 qkv ragged M={Mr}",
                torch.cat(linear.linear_int8(xr, wqkv, bqkv, chunks=3), dim=-1),
                linear.linear_int8_reference(xr, wqkv, bqkv))
    return results


def _drive(torch, counters, hessian_dir: str, pixels, prompts, per_forward: dict,
           vision=None, **lanes):
    """from_pretrained -> set_class_prompts -> predict x (PREDICT_CALLS+1)
    with every launch count set to 0 just before and read just after;
    checks each kernel's launches per image-tower forward (every count
    per_forward does not name: 0) and that the text tower launches none.
    `vision`: VisionConfig fields the image tower is rebuilt with, on the
    same weights (a lane from_pretrained has no keyword for, as in JAX).
    Returns (vlm, probs, launches, img/s, from_pretrained seconds, first
    call seconds, row-sum error)."""
    from bayesvlm_tpu_torch.models.encoders import rebuild_image_encoder
    from bayesvlm_tpu_torch.pipeline import ProbabilisticVLM

    per_forward = {**dict.fromkeys(counters, 0), **per_forward}
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    vlm = ProbabilisticVLM.from_pretrained(MODEL, hessian_dir, dtype="bf16",
                                           device="cuda", seed=SEED, mesh=None, **lanes)
    if vision:
        vlm.image_encoder = rebuild_image_encoder(vlm.image_encoder, **vision)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    vlm.set_class_prompts(prompts)
    check(all(c.launches == 0 for c in counters.values()),
          "the causal text tower must launch no kernel of the vision lanes")
    times, probs = [], None
    for _ in range(PREDICT_CALLS + 1):
        before = {n: c.launches for n, c in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs = vlm.predict(pixels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        got = {n: c.launches - before[n] for n, c in counters.items()}
        check(got == per_forward, f"launches per image-tower forward: expected "
                                  f"{per_forward}, got {got}")
    launches = {n: c.launches for n, c in counters.items()}
    check(tuple(probs.shape) == (BATCH, NUM_PROMPTS), f"shape {tuple(probs.shape)}")
    check(bool(torch.isfinite(probs).all()), "non-finite probabilities")
    row_err = float((probs.sum(-1) - 1.0).abs().max())
    check(row_err <= 1e-5, f"rows sum to 1 within {row_err:.2e}")
    steady = times[1:]  # the first call pays cuBLAS/cuDNN warm-up
    img_s = BATCH * len(steady) / sum(steady)
    return vlm, probs, launches, img_s, t_load, times[0], row_err


def phase_main_path(torch, counters, hessian_dir: str, pixels, prompts):
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME
    from bayesvlm_tpu_torch.pipeline import ProbabilisticVLM

    L = CONFIGS_BY_NAME[MODEL].vision.num_layers
    vlm, probs, launches, img_s, t_load, t_first, row_err = _drive(
        torch, counters, hessian_dir, pixels, prompts, {"attention": L})
    print(f"bf16 main path: lambda_img={vlm.info['lambda_img']!r} "
          f"lambda_txt={vlm.info['lambda_txt']!r} from_pretrained_s={t_load:.2f} "
          f"predict_first_s={t_first:.3f} predict_img_s_B{BATCH}={img_s:.1f} "
          f"launches={launches} row_sum_err={row_err:.2e}")
    embeds = vlm.encode_images(pixels).embeds

    vlm32 = ProbabilisticVLM.from_pretrained(MODEL, hessian_dir, dtype="fp32",
                                             device="cuda", seed=SEED, mesh=None)
    vlm32.set_class_prompts(prompts)
    probs32 = vlm32.predict(pixels)
    logp_diff = float((probs.float().log() - probs32.log()).abs().max())
    top1 = float((probs.argmax(-1) == probs32.argmax(-1)).float().mean())
    cos = float(torch.nn.functional.cosine_similarity(
        embeds, vlm32.encode_images(pixels).embeds, dim=-1).min())
    print(f"bf16 vs fp32 predict: max_abs_logp_diff={logp_diff:.3e} "
          f"(tol {BF16_LOGP_ATOL}) max_abs_prob_diff="
          f"{float((probs.float() - probs32).abs().max()):.3e} "
          f"min_embed_cos={cos:.6f} (min {BF16_EMBED_COS_MIN}) "
          f"top1_agreement={top1:.3f} max_prob_fp32={float(probs32.max()):.4f} "
          f"lambda_img_fp32={vlm32.info['lambda_img']!r}")
    check(logp_diff <= BF16_LOGP_ATOL, "bf16 log-probs stray from fp32")
    check(cos >= BF16_EMBED_COS_MIN, "bf16 image embeddings stray from fp32")
    del vlm32
    return vlm, launches, img_s, embeds, probs, logp_diff


def phase_int8_path(torch, counters, hessian_dir: str, pixels, prompts,
                    bf16_embeds, bf16_probs, bf16_img_s):
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME

    L = CONFIGS_BY_NAME[MODEL].vision.num_layers
    vlm, probs, launches, img_s, t_load, t_first, row_err = _drive(
        torch, counters, hessian_dir, pixels, prompts,
        {"attention": L, "mlp_int8": L, "linear_int8": 2 * L},
        mlp_int8=True, attn_int8=True)
    cos = float(torch.nn.functional.cosine_similarity(
        vlm.encode_images(pixels).embeds, bf16_embeds, dim=-1).min())
    logp_diff = float((probs.float().log() - bf16_probs.float().log()).abs().max())
    print(f"int8 main path (mlp_int8 + attn_int8): from_pretrained_s={t_load:.2f} "
          f"predict_first_s={t_first:.3f} predict_img_s_B{BATCH}={img_s:.1f} "
          f"(bf16 lane {bf16_img_s:.1f}) launches={launches} "
          f"row_sum_err={row_err:.2e}")
    print(f"int8 vs bf16 lane: min_embed_cos={cos:.6f} (min {INT8_EMBED_COS_MIN}) "
          f"max_abs_logp_diff={logp_diff:.3e}")
    check(cos >= INT8_EMBED_COS_MIN, "int8 image embeddings stray from the bf16 lane")
    graph = _capture_lane(torch, counters, vlm, pixels, probs, "int8 lane",
                          {"attention": L, "mlp_int8": L, "linear_int8": 2 * L})
    del vlm
    return launches, img_s, graph


def phase_block_path(torch, counters, hessian_dir: str, pixels, prompts,
                     bf16_embeds, bf16_probs, bf16_img_s):
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME

    L = CONFIGS_BY_NAME[MODEL].vision.num_layers
    vlm, probs, launches, img_s, t_load, t_first, row_err = _drive(
        torch, counters, hessian_dir, pixels, prompts, {"attention_block": L},
        vision={"attn_pallas_block": True})
    cos = float(torch.nn.functional.cosine_similarity(
        vlm.encode_images(pixels).embeds, bf16_embeds, dim=-1).min())
    logp_diff = float((probs.float().log() - bf16_probs.float().log()).abs().max())
    print(f"block lane (attn_pallas_block): from_pretrained_s={t_load:.2f} "
          f"predict_first_s={t_first:.3f} predict_img_s_B{BATCH}={img_s:.1f} "
          f"(bf16 lane {bf16_img_s:.1f}) launches={launches} "
          f"row_sum_err={row_err:.2e}")
    print(f"block vs bf16 lane: min_embed_cos={cos:.6f} (min {BLOCK_EMBED_COS_MIN}) "
          f"max_abs_logp_diff={logp_diff:.3e}")
    check(cos >= BLOCK_EMBED_COS_MIN, "block-lane image embeddings stray from the "
                                      "bf16 lane")
    graph = _capture_lane(torch, counters, vlm, pixels, probs, "block lane",
                          {"attention_block": L})
    del vlm
    return launches, img_s, graph


class _CaptureLog:
    """While entered, records each CUDA-graph capture's seconds (capture
    begin to end) and the launches each counter took inside it: a replay
    calls no Python, so the kernels a graph holds are counted as it is
    captured."""

    def __init__(self, torch, counters):
        self.graph_cls, self.counters, self.captures = torch.cuda.CUDAGraph, counters, []

    def __enter__(self):
        cls, log = self.graph_cls, self
        self.saved = (cls.capture_begin, cls.capture_end)

        def begin(graph, *args, **kwargs):
            log.before = {n: c.launches for n, c in log.counters.items()}
            log.t0 = time.perf_counter()
            return log.saved[0](graph, *args, **kwargs)

        def end(graph, *args, **kwargs):
            out = log.saved[1](graph, *args, **kwargs)
            log.captures.append((time.perf_counter() - log.t0, {
                n: c.launches - log.before[n] for n, c in log.counters.items()
                if c.launches != log.before[n]}))
            return out

        cls.capture_begin, cls.capture_end = begin, end
        return self

    def __exit__(self, *exc):
        self.graph_cls.capture_begin, self.graph_cls.capture_end = self.saved


def _capture_lane(torch, counters, vlm, pixels, eager_probs, label: str,
                  per_program: dict) -> dict:
    """compile_serving(BATCH) on a lane's VLM (float32 input): the kernels
    counted while the graph is captured, and its replay against the eager
    predict of the same pixels, bit for bit."""
    with _CaptureLog(torch, counters) as log:
        vlm.compile_serving(BATCH)
    (seconds, launches), = log.captures
    replays = vlm.replays
    out = vlm.predict(pixels)
    torch.cuda.synchronize()
    diff = float((out - eager_probs).abs().max())
    print(f"{label} graph B={BATCH}: capture_s={seconds:.3f} launches={launches} "
          f"replay vs eager predict: equal={bool(torch.equal(out, eager_probs))} "
          f"max_abs_diff={diff:.3e}")
    check(launches == per_program, f"{label} graph launches {launches} != {per_program}")
    check(vlm.replays == replays + 1, f"{label}: predict did not replay the graph")
    check(torch.equal(out, eager_probs), f"{label}: the replay differs from eager predict")
    return launches


def _host_ms(torch, fn, calls: int) -> list:
    """Host-clock ms of each of `calls` calls, the card synchronised."""
    out = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _pct(values, q: float) -> float:
    v = sorted(values)
    return v[int(q * (len(v) - 1))]


def _max_logp_diff(torch, rows, ref) -> float:
    rows = torch.as_tensor(np.asarray(rows), dtype=torch.float32)
    return float((rows.log() - ref.float().cpu().log()).abs().max())


def _http(port: int, path: str, body, headers: dict):
    """One request to 127.0.0.1:port (GET without a body): (status, JSON)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST" if body is not None else "GET", path, body=body,
                     headers=headers)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def phase_serving(torch, counters, vlm, prompts, logp_tol: float) -> dict:
    """The serving path on the bf16 main-path VLM: the uint8 lane's
    normalisation and H2D bytes, compile_serving's pow2 CUDA-graph ladder
    (launches counted at capture, each size's replay against eager
    predict), B=1 latency and B=64 throughput graph against eager, the
    BatchingServer at pipeline_depth 0 and 2, and serve_cli's HTTP app
    with both kinds of prompt swap. Served rows are held to eager predict
    within `logp_tol`, the run's bf16-vs-fp32 max |log p| difference."""
    import threading
    from http.server import ThreadingHTTPServer

    from bayesvlm_tpu_torch import serve_cli
    from bayesvlm_tpu_torch.data.transforms import NORMALIZATION_BY_FAMILY, _normalize
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME
    from bayesvlm_tpu_torch.serve import BatchingServer

    t_phase = time.perf_counter()
    L = CONFIGS_BY_NAME[MODEL].vision.num_layers
    size = vlm.image_encoder.config.vision.image_size
    n_images = SERVE_CLIENTS * SERVE_REQUESTS
    u8 = np.random.default_rng(SEED + 5).integers(0, 256, (n_images, size, size, 3),
                                                  dtype=np.uint8)
    enc = vlm.image_encoder

    # the uint8 lane: the device's normalisation against the host transform's
    dev = enc.normalize(torch.from_numpy(u8[:BATCH]).cuda()).cpu()
    host = torch.from_numpy(_normalize(u8[:BATCH].astype(np.float32) / 255.0,
                                       *NORMALIZATION_BY_FAMILY["clip"]))
    ulps = (dev.view(torch.int32).long() - host.view(torch.int32).long()).abs()
    h2d = {}
    for name, arr in (("uint8", u8[:BATCH]), ("fp32", host.numpy())):
        src = torch.from_numpy(np.ascontiguousarray(arr))
        pinned = src.pin_memory()
        h2d[name] = {"pageable": cuda_ms(torch, lambda: src.to("cuda")),
                     "pinned": cuda_ms(torch, lambda: pinned.to("cuda", non_blocking=True)),
                     "mb": src.numel() * src.element_size() / 1e6}
    print(f"uint8 lane ({DEVICE['card']}): device-normalised pixels vs the host float "
          f"transform: max_ulps={int(ulps.max())} differing={int((ulps > 0).sum())} of "
          f"{ulps.numel()}; H2D B={BATCH}: " + "; ".join(
              f"{n} {r['mb']:.2f} MB pageable {r['pageable']:.4f} ms pinned "
              f"{r['pinned']:.4f} ms" for n, r in h2d.items()))
    check(int(ulps.max()) == 0, "the uint8 lane's normalisation differs from the host's")

    # eager references (the general path, counted in no predict counter)
    with torch.no_grad():
        eager = torch.cat([vlm.logits(u8[i:i + BATCH]).softmax(num_samples=0).cpu()
                           for i in range(0, n_images, BATCH)])

    # the ladder, launches counted at capture
    ladder = [1 << k for k in range(BATCH.bit_length()) if 1 << k <= BATCH]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _CaptureLog(torch, counters) as log:
        vlm.compile_serving(ladder, input_dtype=torch.uint8)
    compile_s = time.perf_counter() - t0
    sizes = sorted(ladder, reverse=True)  # captured largest first
    graph_launches = {b: launches for b, (_, launches) in zip(sizes, log.captures)}
    capture_s = {b: sec for b, (sec, _) in zip(sizes, log.captures)}
    print(f"ladder (uint8, pow2 to {BATCH}): compile_serving {compile_s:.2f} s; capture_s "
          + " ".join(f"B={b}:{capture_s[b]:.3f}" for b in ladder)
          + f"; launches per captured program {graph_launches}")
    check(len(log.captures) == len(ladder), f"{len(log.captures)} captures for {ladder}")
    check(all(graph_launches[b] == {"attention": L} for b in ladder),
          f"#1 launches per captured program: {graph_launches}")
    equal, diffs = {}, {}
    for b in ladder:
        replays = vlm.replays
        out = vlm.predict(u8[:b])
        with torch.no_grad():
            ref = vlm.logits(u8[:b]).softmax(num_samples=0)
        torch.cuda.synchronize()
        check(vlm.replays == replays + 1, f"B={b} did not replay")
        equal[b], diffs[b] = bool(torch.equal(out, ref)), float((out - ref).abs().max())
    print("replay vs eager predict, bit for bit: " + " ".join(
        f"B={b}:{equal[b]}({diffs[b]:.1e})" for b in ladder))
    check(all(equal.values()), f"a replay differs from eager predict: {diffs}")

    # latency and throughput, graph against eager (the ladder detached)
    def eager_predict(x):
        srv, vlm._serving = vlm._serving, None
        try:
            return vlm.predict(x)
        finally:
            vlm._serving = srv

    times = {}
    for name, fn in (("graph", vlm.predict), ("eager", eager_predict)):
        fn(u8[:1])
        fn(u8[:BATCH])
        times[name] = {"b1": _host_ms(torch, lambda: fn(u8[:1]), SERVE_LATENCY_CALLS),
                       "b64": _host_ms(torch, lambda: fn(u8[:BATCH]), SERVE_THROUGHPUT_CALLS)}
    lat = {n: (_pct(t["b1"], 0.5), _pct(t["b1"], 0.95)) for n, t in times.items()}
    img_s = {n: BATCH * len(t["b64"]) / sum(t["b64"]) * 1e3 for n, t in times.items()}
    print(f"B=1 latency ms p50/p95 ({SERVE_LATENCY_CALLS} calls, host clock, card "
          f"synchronised; {DEVICE['card']}): graph {lat['graph'][0]:.3f}/{lat['graph'][1]:.3f}"
          f" eager {lat['eager'][0]:.3f}/{lat['eager'][1]:.3f}; B={BATCH} uint8 img/s: "
          f"graph {img_s['graph']:.1f} eager {img_s['eager']:.1f}")
    # the host work a graph call does before its replay, at B=64: the
    # check of the tensors the graph reads, and the copy into the pinned
    # staging buffer (the H2D copy from it is h2d["uint8"]["pinned"])
    pinned = vlm._serving["programs"][BATCH].pinned.numpy()
    host_ms = {}
    for name, fn in (("runtime_key", vlm._runtime_key),
                     ("staging_copy", lambda: np.copyto(pinned, u8[:BATCH]))):
        t0 = time.perf_counter()
        for _ in range(SERVE_THROUGHPUT_CALLS):
            fn()
        host_ms[name] = (time.perf_counter() - t0) * 1e3 / SERVE_THROUGHPUT_CALLS
    print(f"graph call host work before the replay, B={BATCH}: runtime-key check "
          f"{host_ms['runtime_key']:.3f} ms, copy into the pinned staging buffer "
          f"{host_ms['staging_copy']:.3f} ms (then H2D {h2d['uint8']['pinned']:.4f} ms; "
          f"eager's pageable H2D {h2d['uint8']['pageable']:.4f} ms)")

    # BatchingServer: 8 clients x 32 requests, inline then pipelined
    server_stats = {}
    for depth in (0, 2):
        eager_calls = vlm.eager_calls
        results = [None] * n_images
        errors = []
        with BatchingServer(vlm, BATCH, max_wait_ms=SERVE_WAIT_MS, input_dtype=torch.uint8,
                            buckets="pow2", pipeline_depth=depth) as srv:
            def client(c):
                try:
                    for r in range(SERVE_REQUESTS):
                        i = c * SERVE_REQUESTS + r
                        results[i] = srv.predict(u8[i], timeout=120)
                except Exception as exc:  # noqa: BLE001 — reported below
                    errors.append(exc)

            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(SERVE_CLIENTS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            wall = time.perf_counter() - t0
            stats = srv.stats()
        check(not errors and not any(t.is_alive() for t in threads),
              f"BatchingServer depth {depth}: {errors[:1]}")
        check(all(r is not None for r in results), "a future did not resolve")
        logp = _max_logp_diff(torch, results, eager)
        server_stats[depth] = dict(vars(stats), img_s=n_images / wall,
                                   max_abs_logp_diff=logp)
        print(f"BatchingServer pipeline_depth={depth}: {n_images} requests from "
              f"{SERVE_CLIENTS} clients in {wall:.3f} s ({n_images / wall:.1f} img/s), "
              f"batches={stats.batches} fill={stats.fill:.3f} padded_rows={stats.padded_rows}"
              f" latency_ms p50={stats.latency_ms_p50:.3f} p95={stats.latency_ms_p95:.3f} "
              f"max={stats.latency_ms_max:.3f} errors={stats.errors} eager_calls="
              f"{vlm.eager_calls - eager_calls}; rows vs eager predict B={BATCH}: "
              f"max_abs_logp_diff={logp:.3e} (tol {logp_tol:.3e})")
        check(vlm.eager_calls == eager_calls, "the server ran the eager path")
        check(stats.requests == n_images and stats.errors == 0, f"stats {stats}")
        check(logp <= logp_tol, "served rows stray from eager predict")

    # HTTP: serve_cli's app in this process
    app = serve_cli.ServingApp(vlm, BATCH, SERVE_WAIT_MS, "uint8", buckets="pow2")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve_cli.make_handler(app))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]
    octet = {"Content-Type": "application/octet-stream",
             "X-Image-Shape": f"{size},{size},3", "X-Image-Dtype": "uint8"}
    http = {}
    try:
        eager_calls = vlm.eager_calls
        replies = [_http(port, "/predict", u8[i].tobytes(), octet) for i in range(16)]
        check(all(s == 200 for s, _ in replies), f"HTTP statuses {[s for s, _ in replies]}")
        http["logp"] = _max_logp_diff(torch, [r["probs"] for _, r in replies], eager[:16])
        check(http["logp"] <= logp_tol, "HTTP rows stray from eager predict")
        status, health = _http(port, "/healthz", None, {})
        check(status == 200 and health["ok"] and health["buckets"] == ladder,
              f"/healthz {status} {health}")
        status, stats = _http(port, "/stats", None, {})
        check(status == 200 and stats["requests"] == 16, f"/stats {status} {stats}")
        for label, new in (("same count", [f"a picture of object {i}"
                                           for i in range(NUM_PROMPTS)]),
                           ("another count", [f"a picture of object {i}"
                                              for i in range(NUM_PROMPTS // 2)])):
            labels, replays = vlm._label_features, vlm.replays
            t0 = time.perf_counter()
            status, out = _http(port, "/class_prompts", json.dumps({"prompts": new}).encode(),
                                {"Content-Type": "application/json"})
            swap_s = time.perf_counter() - t0
            check(status == 200 and out["num_classes"] == len(new), f"swap {status} {out}")
            replies = [_http(port, "/predict", u8[i].tobytes(), octet) for i in range(4)]
            check(all(s == 200 for s, _ in replies), "HTTP predict after the swap")
            with torch.no_grad():
                want = vlm.logits(u8[:4], class_prompts=new).softmax(num_samples=0)
            logp = _max_logp_diff(torch, [r["probs"] for _, r in replies], want)
            in_place = vlm._label_features is labels
            http[label] = {"swap_s": swap_s, "logp": logp, "labels_in_place": in_place}
            print(f"HTTP /class_prompts swap ({label}, {len(new)} classes): {swap_s:.3f} s, "
                  f"labels copied in place={in_place}, replays={vlm.replays - replays}, "
                  f"rows vs eager predict under the new prompts: max_abs_logp_diff="
                  f"{logp:.3e}")
            check(logp <= logp_tol, f"HTTP rows after the {label} swap stray")
            check(vlm.replays == replays + 4, f"{label} swap: predict did not replay")
            check(in_place == (label == "same count"), f"{label} swap: labels in place")
        check(vlm.eager_calls == eager_calls, "the HTTP path ran the eager path")
        check(sorted(vlm._serving["programs"]) == ladder, "the ladder after the swap")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
        app.server.stop(drain=False, timeout=60)
    print(f"HTTP serve_cli app: 16 uint8 octet-stream requests, rows vs eager predict "
          f"max_abs_logp_diff={http['logp']:.3e}; /healthz {health['buckets']}; /stats "
          f"requests={stats['requests']} fill={stats['fill']:.3f}")
    print(f"serving phase: {time.perf_counter() - t_phase:.1f} s")
    return {"graph_launches": graph_launches, "capture_s": capture_s,
            "latency_ms": lat, "img_s": img_s, "h2d_ms": h2d, "host_ms": host_ms,
            "server": server_stats, "http": http}


def _multi_clients(predict, names, u8) -> tuple:
    """SERVE_CLIENTS closed-loop client threads of SERVE_REQUESTS requests
    each, alternating models: client c's request r goes to model
    names[(c + r) % 2] with that model's image c * SERVE_REQUESTS + r.
    -> ({name: {image index: row}}, wall seconds, errors)."""
    import threading

    rows = {n: {} for n in names}
    errors = []

    def client(c):
        try:
            for r in range(SERVE_REQUESTS):
                n, i = names[(c + r) % len(names)], c * SERVE_REQUESTS + r
                rows[n][i] = predict(n, u8[n][i])
        except Exception as exc:  # noqa: BLE001 — reported by the caller
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        errors.append(RuntimeError("a client thread did not finish in 300 s"))
    return rows, wall, errors


def _read_until(lines, prefix: str, timeout: float) -> list:
    """Lines of a child's output up to the first one starting with
    `prefix`; raises if it does not come within `timeout` seconds."""
    import queue

    seen, deadline = [], time.monotonic() + timeout
    while not any(x.startswith(prefix) for x in seen):
        try:
            seen.append(lines.get(timeout=max(deadline - time.monotonic(), 0.01)))
        except queue.Empty:
            raise RuntimeError(f"no {prefix!r} line in {timeout} s: {''.join(seen)[-2000:]}")
        if seen[-1] is None:
            raise RuntimeError(f"the child exited before {prefix!r}: {''.join(seen[:-1])[-2000:]}")
    return seen


def _serve_cli_run(argv: list, requests: list, octet: dict) -> tuple:
    """`python -m bayesvlm_tpu_torch.serve_cli ARGV` from this script's
    directory: seconds until it prints "serving on", its log to then, and
    its answers to `requests` (uint8 crops, sent one at a time to
    /predict). The child is killed before this returns."""
    import queue
    import threading

    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "bayesvlm_tpu_torch.serve_cli", *argv],
                            cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = queue.Queue()

    def pump():
        for x in proc.stdout:
            lines.put(x)
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    try:
        seen = _read_until(lines, "serving on", 600)
        ready_s = time.perf_counter() - t0
        port = int(seen[-1].split(":")[1].split()[0])
        answers = []
        for img in requests:
            status, out = _http(port, "/predict", img.tobytes(), octet)
            check(status == 200, f"serve_cli answered {status}: {out}")
            answers.append(out["probs"])
    finally:
        proc.kill()
        proc.communicate(timeout=60)
    return ready_s, "".join(seen), answers


def phase_multiserve(torch, counters, hessian_dirs: dict, work: Path,
                     logp_tol: float) -> dict:
    """Phase 6c: MULTI_MODELS resident on one card. Each built by
    from_pretrained (seeded bf16 towers, the synthetic factors, 100
    prompts) and its uint8 pow2 ladder captured (#1's launches counted at
    each capture, each replay equal to eager predict bit for bit);
    MultiModelServer with SERVE_CLIENTS closed-loop clients alternating
    models at pipeline_depth 0 and 2 (every row within `logp_tol` of its
    model's eager predict, no eager call, per-model img/s, fill, latency,
    hbm_footprint beside torch.cuda.memory_allocated); save_serving and
    from_serving_cache per model (the restart timed against the build it
    replaces, the restored replays bit-equal to the saved VLM's); the HTTP
    app of serve_cli --models_json --aot_cache over those files (each
    route; a same-count prompt swap of one lane leaves the other lane's
    rows unchanged); and serve_cli --aot_cache run twice as a child
    process, the second restoring without its Hessian directory and
    answering with the first run's bits."""
    import contextlib
    import io
    import shutil
    import threading
    from http.server import ThreadingHTTPServer

    from bayesvlm_tpu_torch import serve_cli
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME
    from bayesvlm_tpu_torch.multiserve import MultiModelServer
    from bayesvlm_tpu_torch.pipeline import ProbabilisticVLM

    t_phase = time.perf_counter()
    names = list(MULTI_MODELS)
    models = {n: m for n, (m, _) in MULTI_MODELS.items()}
    batch = {n: b for n, (_, b) in MULTI_MODELS.items()}
    ladders = {n: [1 << k for k in range(b.bit_length())] for n, b in batch.items()}
    layers = {n: CONFIGS_BY_NAME[m].vision.num_layers for n, m in models.items()}
    size = {n: CONFIGS_BY_NAME[m].vision.image_size for n, m in models.items()}
    classes = {n: [f"{n} class {i}" for i in range(NUM_PROMPTS)] for n in names}
    prompts = {n: [MULTI_TEXT_PROMPT.format(class_name=c) for c in classes[n]]
               for n in names}
    n_images = SERVE_CLIENTS * SERVE_REQUESTS
    u8 = {n: np.random.default_rng(SEED + 6 + k).integers(
        0, 256, (n_images, size[n], size[n], 3), dtype=np.uint8)
        for k, n in enumerate(names)}
    octet = {n: {"Content-Type": "application/octet-stream",
                 "X-Image-Shape": f"{size[n]},{size[n]},3", "X-Image-Dtype": "uint8"}
             for n in names}
    out = {"from_pretrained_s": {}, "set_class_prompts_s": {}, "compile_s": {},
           "graph_launches": {}, "server": {}, "restart": {}}
    for c in counters.values():
        c.launches = 0

    # the full build of each model: from_pretrained, prompts, ladder
    vlms = {}
    for n in names:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vlms[n] = ProbabilisticVLM.from_pretrained(models[n], str(hessian_dirs[models[n]]),
                                                   dtype="bf16", device="cuda", seed=SEED,
                                                   mesh=None)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        vlms[n].set_class_prompts(prompts[n])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with _CaptureLog(torch, counters) as log:
            vlms[n].compile_serving(ladders[n], input_dtype=torch.uint8)
        torch.cuda.synchronize()
        out["from_pretrained_s"][n], out["set_class_prompts_s"][n] = t1 - t0, t2 - t1
        out["compile_s"][n] = time.perf_counter() - t2
        sizes = sorted(ladders[n], reverse=True)  # captured largest first
        graph = {b: launches for b, (_, launches) in zip(sizes, log.captures)}
        out["graph_launches"][models[n]] = graph
        check(len(log.captures) == len(ladders[n]), f"{n}: {len(log.captures)} captures")
        check(all(g == {"attention": layers[n]} for g in graph.values()),
              f"{n}: #1 launches per captured program {graph}")
        equal = {}
        for b in ladders[n]:
            with torch.no_grad():
                ref = vlms[n].logits(u8[n][:b]).softmax(num_samples=0)
            equal[b] = bool(torch.equal(vlms[n].predict(u8[n][:b]), ref))
        print(f"6c {models[n]} (bf16, uint8, pow2 to {batch[n]}, {NUM_PROMPTS} prompts): "
              f"from_pretrained {out['from_pretrained_s'][n]:.2f} s, set_class_prompts "
              f"{t2 - t1:.2f} s, ladder {out['compile_s'][n]:.2f} s; launches per "
              f"captured program {graph}; replay vs eager predict bit for bit {equal}")
        check(all(equal.values()), f"{n}: a replay differs from eager predict")
    torch.cuda.synchronize()
    with torch.no_grad():
        eager = {n: torch.cat([vlms[n].logits(u8[n][i:i + batch[n]]).softmax(
            num_samples=0).float().cpu() for i in range(0, n_images, batch[n])])
            for n in names}

    # both ladders behind one dispatcher, inline and pipelined
    ladder_dicts = {n: vlms[n]._serving for n in names}
    for depth in (0, 2):
        eager_calls = {n: vlms[n].eager_calls for n in names}
        with MultiModelServer(vlms, batch_size=batch, max_wait_ms=SERVE_WAIT_MS,
                              input_dtype=torch.uint8, buckets="pow2",
                              pipeline_depth=depth) as ms:
            check(all(vlms[n]._serving is ladder_dicts[n] for n in names),
                  "MultiModelServer captured a ladder again")
            rows, wall, errors = _multi_clients(
                lambda n, img: ms.predict(n, img, timeout=120), names, u8)
            stats = ms.stats()
            hbm = ms.hbm_footprint()
            allocated = torch.cuda.memory_allocated() / 2**30
            reserved = torch.cuda.memory_reserved() / 2**30
        check(not errors, f"MultiModelServer depth {depth}: {errors[:1]}")
        result = {"wall_s": wall, "img_s": n_images / wall, "hbm_gib": hbm,
                  "memory_allocated_gib": allocated, "memory_reserved_gib": reserved}
        for n in names:
            idx = sorted(rows[n])
            check(len(idx) == n_images // 2, f"{n}: {len(idx)} rows")
            logp = _max_logp_diff(torch, [rows[n][i] for i in idx], eager[n][idx])
            s = stats[n]
            result[n] = dict(vars(s), img_s=len(idx) / wall, max_abs_logp_diff=logp,
                             eager_calls=vlms[n].eager_calls - eager_calls[n])
            print(f"6c MultiModelServer pipeline_depth={depth} {models[n]}: {len(idx)} "
                  f"requests in {wall:.3f} s ({len(idx) / wall:.1f} img/s), batches="
                  f"{s.batches} fill={s.fill:.3f} padded_rows={s.padded_rows} latency_ms "
                  f"p50={s.latency_ms_p50:.3f} p95={s.latency_ms_p95:.3f} max="
                  f"{s.latency_ms_max:.3f} errors={s.errors} eager_calls="
                  f"{result[n]['eager_calls']}; rows vs eager predict: max_abs_logp_diff="
                  f"{logp:.3e} (tol {logp_tol:.3e})")
            check(result[n]["eager_calls"] == 0, f"{n}: the server ran the eager path")
            check(s.requests == len(idx) and s.errors == 0, f"{n}: stats {s}")
            check(logp <= logp_tol, f"{n}: served rows stray from eager predict")
        print(f"6c MultiModelServer pipeline_depth={depth}: {n_images} requests from "
              f"{SERVE_CLIENTS} clients alternating models in {wall:.3f} s ("
              f"{n_images / wall:.1f} img/s); hbm_footprint {hbm} GiB; "
              f"torch.cuda.memory_allocated {allocated:.3f} GiB, reserved {reserved:.3f} "
              f"GiB ({DEVICE['card']})")
        check(set(hbm) == {*names, "total"} and all(hbm[n] > 0 for n in names),
              f"hbm_footprint {hbm}")
        out["server"][depth] = result
    del ms, ladder_dicts

    # restart: save_serving, then from_serving_cache, against the full build
    for n in names:
        path = work / f"{n}.aotserv"
        t0 = time.perf_counter()
        vlms[n].save_serving(path)
        save_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _CaptureLog(torch, counters) as log:
            restored = ProbabilisticVLM.from_serving_cache(models[n], path, dtype="bf16",
                                                           device="cuda", seed=SEED,
                                                           mesh=None)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(all(launches == {"attention": layers[n]} for _, launches in log.captures)
              and len(log.captures) == len(ladders[n]),
              f"{n}: restored captures {[launches for _, launches in log.captures]}")
        saved_eager = vlms[n].eager_calls
        equal = {b: bool(torch.equal(restored.predict(u8[n][:b]), vlms[n].predict(u8[n][:b])))
                 for b in ladders[n]}
        build_s = (out["from_pretrained_s"][n] + out["set_class_prompts_s"][n]
                   + out["compile_s"][n])
        out["restart"][models[n]] = {
            "save_s": save_s, "file_mb": path.stat().st_size / 1e6,
            "from_serving_cache_s": restore_s, "full_build_s": build_s,
            "from_pretrained_s": out["from_pretrained_s"][n], "bit_equal": equal}
        print(f"6c restart {models[n]}: save_serving {save_s:.3f} s "
              f"({path.stat().st_size / 1e6:.2f} MB); from_serving_cache {restore_s:.2f} s "
              f"(ladder captured again, {len(log.captures)} sizes, #1 24 a capture) vs "
              f"from_pretrained {out['from_pretrained_s'][n]:.2f} s + set_class_prompts + "
              f"ladder = {build_s:.2f} s (wall, the card synchronised; {DEVICE['card']}); "
              f"replays vs the saved VLM's, bit for bit {equal}")
        check(all(equal.values()), f"{n}: a restored replay differs from the saved VLM's")
        check(restored.eager_calls == 0 and vlms[n].eager_calls == saved_eager,
              f"{n}: the restart ran the eager path")
        del restored

    # the HTTP front end: serve_cli --models_json naming both, restored from
    # the files just saved (--aot_cache)
    manifest = {}
    for n in names:
        (work / f"{n}_classes.json").write_text(json.dumps(classes[n]))
        manifest[n] = {"model_str": models[n], "hessian_dir": str(hessian_dirs[models[n]]),
                       "classes_json": str(work / f"{n}_classes.json"),
                       "text_prompt": MULTI_TEXT_PROMPT, "batch_size": batch[n],
                       "buckets": "pow2", "input_dtype": "uint8", "dtype": "bf16"}
    (work / "fleet.json").write_text(json.dumps(manifest))
    del vlms
    log = io.StringIO()
    args = serve_cli.parse_args(["--models_json", str(work / "fleet.json"), "--aot_cache",
                                 str(work), "--max_wait_ms", str(SERVE_WAIT_MS),
                                 "--verbose"])
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        app = serve_cli.build_app(args)
    app_s = time.perf_counter() - t0
    app.verbose = False  # --verbose was for the [aot_cache] lines, not each request
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve_cli.make_handler(app))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]
    http = {"build_app_s": app_s}
    try:
        check(log.getvalue().count("[aot_cache] restored the serving state") == 2
              and "saved" not in log.getvalue(), f"build_app log: {log.getvalue()}")

        def http_rows(n, lo, hi):
            replies = [_http(port, f"/predict/{n}", u8[n][i].tobytes(), octet[n])
                       for i in range(lo, hi)]
            check(all(st == 200 for st, _ in replies), f"/predict/{n}: {replies[:1]}")
            return [r["probs"] for _, r in replies]

        for n in names:
            with torch.no_grad():
                want = app.vlms[n].logits(u8[n][:8]).softmax(num_samples=0)
            http[n] = _max_logp_diff(torch, http_rows(n, 0, 8), want)
            check(http[n] <= logp_tol, f"HTTP /predict/{n} rows stray from eager predict")
        status, err = _http(port, "/predict", u8[names[0]][0].tobytes(), octet[names[0]])
        check(status == 400 and "model name required" in err["error"], f"/predict {status}")
        status, health = _http(port, "/healthz", None, {})
        check(status == 200 and set(health["models"]) == set(names)
              and set(health["hbm_gib"]) == {*names, "total"}, f"/healthz {health}")
        check(all(health["models"][n]["buckets"] == ladders[n] for n in names),
              f"/healthz ladders {health['models']}")
        status, stats = _http(port, "/stats", None, {})
        check(status == 200 and all(stats[n]["requests"] == 8 for n in names),
              f"/stats {stats}")
        other = http_rows(names[1], 8, 12)
        swapped = [f"a picture of thing {i}" for i in range(NUM_PROMPTS)]
        labels = app.vlms[names[0]]._label_features
        t0 = time.perf_counter()
        status, res = _http(port, f"/class_prompts/{names[0]}",
                            json.dumps({"prompts": swapped}).encode(),
                            {"Content-Type": "application/json"})
        http["swap_s"] = time.perf_counter() - t0
        check(status == 200 and res["num_classes"] == NUM_PROMPTS, f"swap {status} {res}")
        with torch.no_grad():
            want = app.vlms[names[0]].logits(u8[names[0]][:4], class_prompts=swapped).softmax(
                num_samples=0)
        http["swapped"] = _max_logp_diff(torch, http_rows(names[0], 0, 4), want)
        http["other_unchanged"] = http_rows(names[1], 8, 12) == other
        print(f"6c HTTP serve_cli --models_json --aot_cache: build_app {app_s:.2f} s "
              f"(both restored: {log.getvalue().count('restored the serving state')}); "
              f"/predict/<model> rows vs eager predict max_abs_logp_diff "
              + " ".join(f"{n}={http[n]:.3e}" for n in names)
              + f"; /healthz hbm_gib {health['hbm_gib']}; /class_prompts/{names[0]} swap "
              f"(same count) {http['swap_s']:.3f} s, labels in place="
              f"{app.vlms[names[0]]._label_features is labels}, rows vs eager under the new "
              f"prompts {http['swapped']:.3e}, {names[1]} rows unchanged="
              f"{http['other_unchanged']}")
        check(http["swapped"] <= logp_tol, "rows after the swap stray")
        check(http["other_unchanged"], f"the {names[1]} lane's rows changed in the swap")
        check(all(v.eager_calls == 0 for v in app.vlms.values()),
              "the HTTP path ran the eager path")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
        app.server.stop(drain=False, timeout=60)
    del app
    out["http"] = http
    check(counters["attention"].launches > 0
          and all(c.launches == 0 for name, c in counters.items() if name != "attention"),
          f"6c launches {({n: c.launches for n, c in counters.items() if c.launches})}")
    out["launches"] = {n: c.launches for n, c in counters.items()}

    # serve_cli --aot_cache as a child process, twice on one directory; the
    # second run without its Hessian directory
    torch.cuda.empty_cache()
    name = names[0]
    cli = work / "cli"
    shutil.copytree(hessian_dirs[models[name]], cli / "hessians")
    argv = ["--model_str", models[name], "--hessian_dir", str(cli / "hessians"),
            "--classes_json", str(work / f"{name}_classes.json"), "--text_prompt",
            MULTI_TEXT_PROMPT, "--input_dtype", "uint8", "--buckets", "pow2",
            "--batch_size", str(batch[name]), "--max_wait_ms", str(SERVE_WAIT_MS),
            "--port", "0", "--verbose", "--aot_cache", str(cli / "aot")]
    runs = []
    for run in range(2):
        runs.append(_serve_cli_run(argv, list(u8[name][:MULTI_CLI_REQUESTS]), octet[name]))
        if run == 0:
            shutil.rmtree(cli / "hessians")  # the restart must not need it
    (first_s, first_log, first), (second_s, second_log, second) = runs
    out["cli"] = {"build_s": first_s, "restart_s": second_s, "equal": second == first}
    print(f"6c serve_cli --aot_cache ({models[name]}), as a child process: first run "
          f"{first_s:.2f} s to 'serving on' (full build, saved: "
          f"{'[aot_cache] saved serving ladder' in first_log}); second run {second_s:.2f} s "
          f"with its Hessian directory deleted (restored: "
          f"{'[aot_cache] restored the serving state' in second_log}); answers to "
          f"{MULTI_CLI_REQUESTS} requests equal bit for bit: {second == first}")
    check("[aot_cache] saved serving ladder" in first_log, f"first run: {first_log[-2000:]}")
    check("[aot_cache] restored the serving state" in second_log,
          f"second run: {second_log[-2000:]}")
    check(second == first, "the restored server answers otherwise than the first run")
    print(f"multi-model serving phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def _smith_operands(torch, B: int, C: int, D: int, seed: int):
    """Embeddings and positive diagonal covariances, seeded on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(B, D, generator=gen, device="cuda"),
            0.01 + 0.49 * torch.rand(B, D, generator=gen, device="cuda"),
            torch.randn(C, D, generator=gen, device="cuda"),
            0.01 + 0.49 * torch.rand(C, D, generator=gen, device="cuda"))


def _smith_check(torch, pk, label: str, ops, logit_scale, ref=None) -> dict:
    """The fused head vs `ref` (default: its plain version) on `ops`:
    |d| <= atol + rtol |ref| everywhere, rows summing to 1."""
    out = pk.fused_probit_probs(*ops, logit_scale)
    if ref is None:
        ref = pk.smith_probit_probs_reference(*ops, logit_scale)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    worst = float((err / (SMITH_ATOL + SMITH_RTOL * ref.abs())).max())
    row_err = float((out.sum(-1) - 1.0).abs().max())
    r = {"max_abs_err": float(err.max()), "row_sum_err": row_err}
    print(f"  {label}: max_abs_err={r['max_abs_err']:.3e} (rtol {SMITH_RTOL} atol "
          f"{SMITH_ATOL}, worst/bound={worst:.3f}) row_sum_err={row_err:.2e}")
    check(worst <= 1.0, f"{label}: the fused head disagrees (max_abs_err "
                        f"{r['max_abs_err']})")
    check(row_err <= SMITH_ROW_TOL, f"{label}: rows sum to 1 within {row_err:.2e}")
    return r


def _smith_bound(B: int, C: int, D: int) -> dict:
    """The least time at the accuracy the head is held to: three TF32
    passes of the three products, 18 B C D operations at the TF32 tensor
    rate, against the four fp32 operands read and the [B, C] output written
    once; beside it (fp32_bound_ms) the old yardstick, 6 B C D fp32
    operations on the CUDA cores."""
    nbytes = 4 * (2 * B * D + 2 * C * D + B * C)
    fp32 = bound(nbytes, 6 * B * C * D, "fp32")
    return {**bound(nbytes, 18 * B * C * D, "tf32"), "fp32_bound_ms": fp32["bound_ms"],
            "fp32_bound_by": fp32["bound_by"]}


def phase_smith_vs_plain(torch, pk) -> dict:
    """The fused probit head kernel vs plain, fp32, at the CLI's and
    predict's shapes and a ragged one; a C past the limit must raise."""
    logit_scale = 4.7651  # SigLIP's (models/encoders.DEFAULT_LOGIT_SCALE)
    print("fused probit head (csrc/smith_head.cu: 3xTF32 wgmma, split-k clusters) vs "
          "plain, fp32:")
    results = {}
    for i, (label, (B, C, D)) in enumerate(SMITH_SHAPES.items()):
        ops = _smith_operands(torch, B, C, D, SEED + 10 + i)
        r = _smith_check(torch, pk, f"{label} B={B} C={C} D={D}", ops, logit_scale)
        res = pk.kernel_resources(B, C, D)
        print(f"    resources: {res['registers']} registers, {res['smem_bytes']} B shared "
              f"memory, {res['local_bytes']} B local a thread; clusters of "
              f"{res['cluster']} (k split), {res['max_active_clusters']} at once; column "
              f"tile {res['nt']} x {res['tiles']}, {res['stages']} stages")
        r.update(registers=res["registers"], smem_bytes=res["smem_bytes"],
                 local_bytes=res["local_bytes"], cluster=res["cluster"])
        if label == "ragged":
            continue
        r["ms"] = cuda_ms(torch, lambda: pk.fused_probit_probs(*ops, logit_scale))
        r["plain_ms"] = cuda_ms(torch, lambda: pk.smith_probit_probs_reference(
            *ops, logit_scale))
        r.update(_smith_bound(B, C, D))
        print(f"    kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} (the eager "
              f"cuBLAS fp32 chain) bound_ms={r['bound_ms']:.4f} ({r['bound_by']}, 3xTF32 "
              f"on the tensor cores) fp32_bound_ms={r['fp32_bound_ms']:.4f} "
              f"({r['fp32_bound_by']}, fp32 on the CUDA cores)")
        results[label] = r
    limit = pk.max_classes()
    ops = _smith_operands(torch, 4, limit + 1, 16, SEED + 20)
    try:
        pk.fused_probit_probs(*ops, logit_scale)
    except ValueError as e:
        print(f"  C={limit + 1} (past the limit of {limit}) raises: {e}")
    else:
        check(False, f"C={limit + 1} past the shared-memory limit did not raise")
    return results


def phase_zeroshot(torch, counters, hessian_dir: str) -> dict:
    """Stage-2 zero-shot evaluation at siglip-large width through the
    port's CLI (`zeroshot.run`, the steps under `main`), then the fused
    head on the run's features, every count set to 0 just before and read
    just after."""
    from bayesvlm_tpu_torch import zeroshot
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME
    from bayesvlm_tpu_torch.probforward import kernels as pk
    from bayesvlm_tpu_torch.probforward.smith import activation_diag_covariance

    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = zeroshot.run(
        "synthetic", hessian_dir, ZS_MODEL, pseudo_data_count=10,
        batch_size=ZS_BATCH, dtype="bf16", device="cuda",
        dataset_overrides=dict(image_size=ZS_IMAGE_SIZE, num_test=ZS_IMAGES,
                               num_classes=ZS_CLASSES))
    wall = time.perf_counter() - t0
    (acc, nlpd, ece), info = run["metrics"], run["info"]
    head, img, lab = run["head"], run["image_outputs"], run["label_outputs"]

    def sigmas():
        return (activation_diag_covariance(img.activations, head.source_covariance,
                                           head.source_projection_has_bias),
                activation_diag_covariance(lab.activations, head.target_covariance,
                                           head.target_projection_has_bias))

    sig_s, sig_t = sigmas()
    ops = (img.embeds, sig_s, lab.embeds, sig_t)
    fused = _smith_check(torch, pk, f"fused head on the run's features vs the CLI's "
                         f"probabilities B={len(img)} C={len(lab)}", ops,
                         head.logit_scale, ref=run["probs"])
    launches = {n: c.launches for n, c in counters.items()}

    L = CONFIGS_BY_NAME[ZS_MODEL].vision.num_layers
    forwards = -(-ZS_IMAGES // ZS_BATCH)
    expected = {n: 0 for n in counters}
    expected.update(attention=L * forwards, smith_head=1)
    sec = run["seconds"]
    img_s = ZS_IMAGES / sec["[2] image features"]
    print(f"zero-shot path ({ZS_MODEL}, bf16, synthetic {ZS_IMAGES} images of "
          f"{ZS_IMAGE_SIZE} px, {ZS_CLASSES} classes, batch {ZS_BATCH}): ACC={acc!r} "
          f"NLPD={nlpd!r} ECE={ece!r} lambda_img={info['lambda_img']!r} "
          f"lambda_txt={info['lambda_txt']!r} wall_s={wall:.2f} launches={launches}")
    for step, seconds in sec.items():
        print(f"  zero-shot step {step}: {seconds:.3f} s")
    print(f"  precompute_image_features: {img_s:.1f} img/s")
    check(all(np.isfinite(v) for v in (acc, nlpd, ece)), "non-finite metrics")
    check(0.0 <= ece <= 1.0, f"ECE {ece} outside [0, 1]")
    check(info["lambda_img"] != 300.0 and info["lambda_txt"] != 300.0,
          "lambda did not move from its initial 300")
    check(launches == expected, f"zero-shot path launches: expected {expected}, "
                                f"got {launches}")

    # the head at the run's shape: the kernel (given sigma), its plain
    # version, sigma alone, and the CLI's eager chain from the features
    # (make_predictions in one batch, then the probit softmax)
    from bayesvlm_tpu_torch.inference.predictions import make_predictions

    def cli_chain():
        pl = make_predictions(head, img, lab, batch_size=len(img))
        return torch.softmax(pl.mean / torch.sqrt(1.0 + np.pi / 8 * pl.var), dim=-1)

    B, C, D = len(img), len(lab), img.embeds.shape[1]
    fused["ms"] = cuda_ms(torch, lambda: pk.fused_probit_probs(*ops, head.logit_scale))
    fused["plain_ms"] = cuda_ms(torch, lambda: pk.smith_probit_probs_reference(
        *ops, head.logit_scale))
    fused["sigma_ms"] = cuda_ms(torch, sigmas)
    fused["cli_chain_ms"] = cuda_ms(torch, cli_chain)
    fused.update(_smith_bound(B, C, D))
    print(f"  fused head B={B} C={C} D={D}: kernel_ms={fused['ms']:.4f} "
          f"plain_ms={fused['plain_ms']:.4f} bound_ms={fused['bound_ms']:.4f} "
          f"({fused['bound_by']}, 3xTF32) fp32_bound_ms={fused['fp32_bound_ms']:.4f}; "
          f"sigma (both sides) {fused['sigma_ms']:.4f} ms; "
          f"yardstick (reference only) the CLI's eager chain from the features, "
          f"sigma included: {fused['cli_chain_ms']:.4f} ms")
    return {"launches": launches, "head": fused, "seconds": sec, "img_s": img_s}


def phase_stage1(torch, counters, pixels, prompts) -> dict:
    """Stage 1 through the port's CLI (`hessian_estimation.main`) at
    clip-large width: S1_PAIRS synthetic pairs of S1_IMAGE_SIZE px with
    distinct captions, one class batch, every count set to 0 just before
    and read just after; then the artifact directory's contract and
    from_pretrained -> predict on it."""
    from bayesvlm_tpu_torch import hessian_estimation
    from bayesvlm_tpu_torch.bayes.kfac import regularize_kfac_factor
    from bayesvlm_tpu_torch.io.artifacts import load_hessians
    from bayesvlm_tpu_torch.kernels import BUILD_DIR
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME
    from bayesvlm_tpu_torch.pipeline import ProbabilisticVLM

    config = CONFIGS_BY_NAME[S1_MODEL]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as hdir:
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = hessian_estimation.main(
            dataset="synthetic", model_str=S1_MODEL, precompute_batch_size=S1_BATCH,
            la_num_classes=S1_PAIRS, la_batch_size=S1_LA_BATCH, num_workers=8,
            hessian_dir=hdir, num_steps=S1_LAMBDA_STEPS, device="cuda",
            dataset_overrides=dict(image_size=S1_IMAGE_SIZE, num_test=S1_PAIRS,
                                   num_classes=S1_PAIRS))
        wall = time.perf_counter() - t0
        launches = {n: c.launches for n, c in counters.items()}
        expected = dict.fromkeys(counters, 0)
        expected["attention"] = config.vision.num_layers * (S1_PAIRS // S1_BATCH)
        sec = run["seconds"]
        feature_s = sec["img features"] + sec["txt features"]
        ggn_s = sec["GGN img"] + sec["GGN txt"]
        print(f"Stage-1 path ({S1_MODEL}, bf16 towers, synthetic {S1_PAIRS} pairs of "
              f"{S1_IMAGE_SIZE} px, batch {S1_BATCH}, one class batch of {S1_PAIRS}, "
              f"GGN block {S1_LA_BATCH}, {S1_LAMBDA_STEPS} lambda steps): "
              f"lambda_img={run['lambda_img']!r} lambda_txt={run['lambda_txt']!r} "
              f"wall_s={wall:.3f} launches={launches}")
        for step, seconds in sec.items():
            print(f"  Stage-1 step {step}: {seconds:.3f} s")
        print(f"  feature pass: {S1_PAIRS / feature_s:.1f} pairs/s (images "
              f"{S1_PAIRS / sec['img features']:.1f}/s, captions "
              f"{S1_PAIRS / sec['txt features']:.1f}/s; the text pass redraws the "
              f"images, as in JAX); GGN share of the wall {ggn_s / wall:.4f}")
        check(launches == expected, f"Stage-1 launches: expected {expected}, got {launches}")

        names = [f"{k}_{t}.pt" for k in ("activations", "embeddings") for t in ("img", "txt")]
        names += [f"{f}_{t}_analytic.pt" for f in "AB" for t in ("img", "txt")]
        names.append("prior_precision_analytic.json")
        missing = [n for n in names if not (Path(hdir) / n).exists()]
        check(not missing, f"missing artifacts {missing}")
        dims = {"img": (config.vision.hidden_size, config.vision.projection_dim),
                "txt": (config.text.hidden_size, config.text.projection_dim)}
        for tag in ("img", "txt"):
            A, B, info = load_hessians(hdir, tag, return_info=True)
            check((tuple(A.shape), tuple(B.shape)) == tuple((d, d) for d in dims[tag]),
                  f"{tag} factor shapes {tuple(A.shape)}, {tuple(B.shape)}")
            for name, F in (("A", A), ("B", B)):
                F = F.cuda()
                asym = float((F - F.T).abs().max() / F.abs().max())
                chol = torch.linalg.cholesky_ex(regularize_kfac_factor(
                    F, info[f"n_{tag}"], info[f"lambda_{tag}"])).info
                print(f"  {name}_{tag} {tuple(F.shape)}: max |F - F^T| / max |F| = "
                      f"{asym:.2e}, Cholesky of F sqrt(n) + sqrt(lambda) I info={int(chol)}")
                check(bool(torch.isfinite(F).all()), f"{name}_{tag} not finite")
                check(asym <= 1e-6, f"{name}_{tag} not symmetric ({asym:.2e})")
                check(int(chol) == 0, f"{name}_{tag}: regularized factor not SPD")

        vlm = ProbabilisticVLM.from_pretrained(S1_MODEL, hdir, device="cuda", seed=SEED,
                                               mesh=None)
        vlm.set_class_prompts(prompts)
        probs = vlm.predict(pixels)
        row_err = float((probs.sum(-1) - 1.0).abs().max())
        print(f"  from_pretrained on the Stage-1 directory -> predict: shape "
              f"{tuple(probs.shape)}, row_sum_err={row_err:.2e}, lambda_img="
              f"{vlm.info['lambda_img']!r}")
        check(tuple(probs.shape) == (BATCH, NUM_PROMPTS), f"shape {tuple(probs.shape)}")
        check(bool(torch.isfinite(probs).all()), "non-finite probabilities")
        check(row_err <= 1e-5, f"rows sum to 1 within {row_err:.2e}")
        del vlm
    return {"launches": launches, "seconds": sec, "wall_s": wall,
            "pairs_s": S1_PAIRS / feature_s, "ggn_share": ggn_s / wall}


def _native_tar(path: Path) -> list:
    """One LAION-style shard of NATIVE_SAMPLES samples ({key}.jpg +
    {key}.txt) cycling through the fixtures; returns the JPEGs in order."""
    import io
    import tarfile

    names = list(np.load(NATIVE_FIXTURES / "goldens.npz")["names"])
    data = [(NATIVE_FIXTURES / n).read_bytes() for n in names]
    jpegs = []
    with tarfile.open(path, "w") as tf:
        for i in range(NATIVE_SAMPLES):
            jpeg = data[i % len(data)]
            jpegs.append(jpeg)
            for name, payload in ((f"{i:09d}.jpg", jpeg),
                                  (f"{i:09d}.txt", f"a photo number {i} of a thing".encode())):
                info = tarfile.TarInfo(name=name)
                info.size = len(payload)
                tf.addfile(info, io.BytesIO(payload))
    return jpegs


def _native_fixtures(torch, nio) -> None:
    """(b) nvJPEG on the fixtures: statuses against the goldens, the RGB
    against libjpeg's by chroma subsampling, each crop's difference."""
    gold = np.load(NATIVE_FIXTURES / "goldens.npz")
    names = list(gold["names"])
    jpegs = [(NATIVE_FIXTURES / n).read_bytes() for n in names]
    rgbs, status = nio.decode_rgb(jpegs, "cuda")
    torch.cuda.synchronize()
    print(f"  nvJPEG statuses {dict(zip(names, status.tolist()))}")
    check(status.tolist() == gold["status"].tolist(),
          f"nvJPEG statuses {status.tolist()} != libjpeg's {gold['status'].tolist()}")
    for chroma, (max_ok, mean_ok) in NATIVE_RGB_BOUND.items():
        stem = {"4:2:0": "smooth_420", "4:4:4": "smooth_444", "4:2:2": "smooth_422"}[chroma]
        ref = torch.from_numpy(gold[f"rgb_{stem}"]).cuda().int()
        d = (rgbs[names.index(f"{stem}.jpg")].int() - ref).abs()
        dmax, dmean = int(d.max()), float(d.float().mean())
        print(f"  nvJPEG vs libjpeg RGB {chroma} ({stem}.jpg {tuple(ref.shape)}): max |d| "
              f"{dmax}, mean |d| {dmean:.4f}, exact {float((d == 0).float().mean()):.4f} "
              f"(bound {max_ok} / {mean_ok})")
        check(dmax <= max_ok and dmean <= mean_ok, f"{chroma} RGB past its bound")
    cut = nio.decode_planes([jpegs[names.index("truncated.jpg")]], "cuda")[0][0]
    sha = hashlib.sha256(b"".join(t.cpu().numpy().tobytes()
                                  for t in (cut.y, cut.cb, cut.cr))).hexdigest()
    print(f"  nvJPEG planes of truncated.jpg (Y {tuple(cut.y.shape)}, Cb / Cr "
          f"{tuple(cut.cb.shape)}): sha256 {sha}")
    check(sha == NATIVE_TRUNCATED_SHA256, f"truncated.jpg decodes to other bits than "
          f"NATIVE_TRUNCATED_SHA256 ({sha}): nvJPEG's fill past the cut changed")
    crops = nio.resize_crop(rgbs, 224, out_uint8=True).int()
    ref = torch.from_numpy(gold["u8_crop224"]).cuda().int()
    for i, name in enumerate(names):
        d = (crops[i] - ref[i]).abs()
        print(f"  224 crop vs the golden {name}: max |d| {int(d.max())}, mean |d| "
              f"{float(d.float().mean()):.4f}, exact {float((d == 0).float().mean()):.4f}")


def _footprint_bytes(torch, nio, rgbs: list, S: int, square: bool) -> int:
    """The source bytes the crops need: for each decoded image, the rows and
    the columns its S x S grid samples (both neighbours; sample_grid, the
    plain version's and the kernel's), 3 bytes a pixel where they cross."""
    total = 0
    for r in rgbs:
        if r is None:
            continue
        (y0, y1, _), (x0, x1, _) = nio.sample_grid(int(r.shape[0]), int(r.shape[1]), S,
                                                   square, "cpu")
        total += (torch.unique(torch.cat([y0, y1])).numel()
                  * torch.unique(torch.cat([x0, x1])).numel() * 3)
    return total


def _graph_ms(torch, launch) -> float:
    """A kernel's device time alone: NATIVE_GRAPH_LAUNCHES bare launches
    captured in one CUDA graph, the replay timed by CUDA events."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(NATIVE_GRAPH_LAUNCHES):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    return cuda_ms(torch, graph.replay, iters=5, warmup=1) / NATIVE_GRAPH_LAUNCHES


def _native_colour(torch, nio, jpegs: list) -> dict:
    """(c) ycc_to_rgb vs its plain version on the same nvJPEG planes at the
    path's batch (B=NATIVE_BATCH), bit for bit, directly and in a CUDA
    graph; the kernel's device time (_graph_ms), the wrapper's (each call
    prepares its metadata and output) and the plain version's; the bound
    on the planes read once and the RGB written once. No PyTorch call
    computes the same function (library_ms null)."""
    planes, status = nio.decode_planes(jpegs[:NATIVE_BATCH], "cuda")
    ref = nio.ycc_to_rgb_reference(planes)
    present = [i for i, r in enumerate(ref) if r is not None]

    def same(out):
        return all(torch.equal(out[i], ref[i]) for i in present)

    out = nio.ycc_to_rgb(planes)
    torch.cuda.synchronize()
    err = max(float((out[i].int() - ref[i].int()).abs().max()) for i in present)
    check(same(out), f"ycc_to_rgb != plain (max |d| {err})")
    wrapper_ms = cuda_ms(torch, lambda: nio.ycc_to_rgb(planes))
    launch, graph_out = nio.ycc_to_rgb_launcher(
        planes, torch.device("cuda", torch.cuda.current_device()))
    launch()
    ms = _graph_ms(torch, launch)
    check(same(graph_out), "ycc_to_rgb in a CUDA graph != plain")
    plain_ms = cuda_ms(torch, lambda: nio.ycc_to_rgb_reference(planes), iters=3, warmup=1)
    src = sum(pl.y.numel() + (2 * pl.cb.numel() if pl.hf else 0)
              for pl in planes if pl is not None)
    dst = sum(3 * pl.y.numel() for pl in planes if pl is not None)
    # ~30 integer operations an output pixel (upsampling and the fixed-point
    # conversion), at the CUDA cores' rate
    r = dict(max_abs_err=err, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
             **bound(src + dst, 30.0 * dst / 3, "fp32"), src_bytes=src, dst_bytes=dst,
             library_ms=None)
    print(f"  ycc_to_rgb at B={len(planes)} ({len(present)} decoded, {src / 1e6:.4f} MB "
          f"of planes -> {dst / 1e6:.4f} MB of RGB): bit-equal to plain, device "
          f"{ms:.4f} ms (a CUDA graph of {NATIVE_GRAPH_LAUNCHES} launches), through the "
          f"wrapper {wrapper_ms:.4f} ms (plain {plain_ms:.2f} ms, bound "
          f"{r['bound_ms']:.4f} ms by {r['bound_by']}) on {DEVICE['card']}")
    return r


def _native_kernel(torch, nio, jpegs: list) -> dict:
    """(c) resize_crop vs its plain version on the same nvJPEG RGB at the
    path's shape (B=NATIVE_BATCH, 224 crops), bit for bit, u8 and fp32;
    the kernel's device time (_graph_ms), the wrapper's (each call
    prepares its metadata and output), the bound on the bytes the crops
    need, and
    F.interpolate (+ the crop slice) as the yardstick."""
    import torch.nn.functional as F

    from bayesvlm_tpu_torch.data.transforms import DEFAULT_MEAN, DEFAULT_STD
    from bayesvlm_tpu_torch.utils import get_image_size

    S = get_image_size(S1_MODEL)
    rgbs, status = nio.decode_rgb(jpegs[:NATIVE_BATCH], "cuda")
    src = _footprint_bytes(torch, nio, rgbs, S, False)
    decoded = sum(int(r.numel()) for r in rgbs if r is not None)
    out = {}
    for u8 in (True, False):
        args = (rgbs, S, False, DEFAULT_MEAN, DEFAULT_STD, u8)
        k = nio.resize_crop(*args)
        p = nio.resize_crop_reference(*args)
        torch.cuda.synchronize()
        err = float((k.float() - p.float()).abs().max())
        check(torch.equal(k, p), f"resize_crop {'u8' if u8 else 'fp32'} != plain "
              f"(max |d| {err})")
        wrapper_ms = cuda_ms(torch, lambda: nio.resize_crop(*args))
        launch, graph_out = nio.resize_crop_launcher(
            *args, torch.device("cuda", torch.cuda.current_device()))
        launch()
        ms = _graph_ms(torch, launch)
        check(torch.equal(graph_out, p), "resize_crop in a CUDA graph != plain")
        plain_ms = cuda_ms(torch, lambda: nio.resize_crop_reference(*args), iters=3, warmup=1)
        dst = len(rgbs) * S * S * 3
        # ~20 fp32 operations an output value: three lerps and the quantise
        # or normalise; each needed source byte read once, each output
        # written once
        b = bound(src + dst * (1 if u8 else 4), 20.0 * dst, "fp32")
        out["u8" if u8 else "fp32"] = dict(max_abs_err=err, ms=ms, wrapper_ms=wrapper_ms,
                                           plain_ms=plain_ms, **b, src_bytes=src,
                                           decoded_bytes=decoded)
    present = [r for r in rgbs if r is not None]

    def library():
        for r in present:  # shorter side to S, then the centre crop
            h, w = r.shape[:2]
            nh, nw = (max(S, round(h * S / w)), S) if w <= h else (S, max(S, round(w * S / h)))
            x = F.interpolate(r.permute(2, 0, 1)[None].float(), size=(nh, nw),
                              mode="bilinear", antialias=False, align_corners=False)
            x[..., (nh - S) // 2:(nh - S) // 2 + S, (nw - S) // 2:(nw - S) // 2 + S]

    library_ms = cuda_ms(torch, library, iters=5)
    for lane, r in out.items():
        r["library_ms"] = library_ms
        print(f"  resize_crop {lane} at B={len(rgbs)} ({len(present)} decoded, "
              f"{decoded / 1e6:.4f} MB of RGB, {src / 1e6:.4f} MB of it under the crops' "
              f"grids) -> {S} crops: bit-equal to plain, device {r['ms']:.4f} ms (a CUDA "
              f"graph of {NATIVE_GRAPH_LAUNCHES} launches), through the wrapper "
              f"{r['wrapper_ms']:.4f} ms (plain {r['plain_ms']:.2f} ms, F.interpolate + "
              f"crop a image {library_ms:.4f} ms, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}) on {DEVICE['card']}")
    return out


def _native_cli(torch, counters, work: Path) -> dict:
    """(d) the Stage-1 CLI with --native_decode --u8_pipeline over the tar,
    every count set to 0 just before and read just after; the decode rate
    of the loader alone and of nvJPEG alone."""
    from bayesvlm_tpu_torch import hessian_estimation
    from bayesvlm_tpu_torch.data import native_io as nio
    from bayesvlm_tpu_torch.data.prefetch import PrefetchLoader
    from bayesvlm_tpu_torch.data.transforms import DEFAULT_MEAN, DEFAULT_STD
    from bayesvlm_tpu_torch.data.wds import NativeDecodeLoader, WebDataset
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME
    from bayesvlm_tpu_torch.utils import get_image_size

    tar = work / "laion400m" / "00000.tar"
    S = get_image_size(S1_MODEL)
    good = 0
    for b in PrefetchLoader(NativeDecodeLoader(WebDataset([tar]), NATIVE_BATCH, S,
                                               DEFAULT_MEAN, DEFAULT_STD, out_uint8=True)):
        good += len(b["image_id"])  # a warm-up pass, which also counts the kept
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batches = 0
    for b in PrefetchLoader(NativeDecodeLoader(WebDataset([tar]), NATIVE_BATCH, S,
                                               DEFAULT_MEAN, DEFAULT_STD, out_uint8=True)):
        batches += 1
    torch.cuda.synchronize()
    loader_s = time.perf_counter() - t0
    jpegs = [(NATIVE_FIXTURES / n).read_bytes()
             for n in np.load(NATIVE_FIXTURES / "goldens.npz")["names"]]
    batch = [jpegs[i % len(jpegs)] for i in range(NATIVE_BATCH)]
    rate = {}
    for label, decode in (("nvjpeg", nio.decode_planes), ("rgb", nio.decode_rgb)):
        decode(batch, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            decode(batch, "cuda")
        torch.cuda.synchronize()
        rate[label] = 5 * NATIVE_BATCH / (time.perf_counter() - t0)
    nvjpeg_img_s = rate["nvjpeg"]
    print(f"  decode: nvJPEG alone {nvjpeg_img_s:.1f} img/s, with ycc_to_rgb "
          f"{rate['rgb']:.1f} img/s (B={NATIVE_BATCH} of the fixtures, failures "
          f"included); the loader (tar index + pread + nvJPEG + ycc_to_rgb + "
          f"resize_crop, prefetch depth 2) {NATIVE_SAMPLES / loader_s:.1f} samples/s, "
          f"{good} of {NATIVE_SAMPLES} kept in {batches} batches, on {DEVICE['card']}")

    config = CONFIGS_BY_NAME[S1_MODEL]
    old = os.environ.get("DATA_BASE_DIR")
    os.environ["DATA_BASE_DIR"] = str(work)
    try:
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = hessian_estimation.main(
            dataset="laion400m", model_str=S1_MODEL, precompute_batch_size=NATIVE_BATCH,
            la_num_classes=NATIVE_CLASSES, la_batch_size=NATIVE_CLASSES, num_workers=8,
            hessian_dir=str(work / "hessians"), num_steps=NATIVE_LAMBDA_STEPS,
            native_decode=True, u8_pipeline=True, device="cuda")
        wall = time.perf_counter() - t0
        launches = {n: c.launches for n, c in counters.items()}
    finally:
        if old is None:
            os.environ.pop("DATA_BASE_DIR")
        else:
            os.environ["DATA_BASE_DIR"] = old
    expected = dict.fromkeys(counters, 0)
    expected["attention"] = config.vision.num_layers * batches
    # the text pass decodes again, as in JAX
    expected["ycc_to_rgb"] = expected["resize_crop"] = 2 * batches
    sec = run["seconds"]
    print(f"  Stage-1 CLI --native_decode --u8_pipeline ({S1_MODEL}, bf16 towers, "
          f"{NATIVE_SAMPLES} samples, {good} decoded): lambda_img={run['lambda_img']!r} "
          f"lambda_txt={run['lambda_txt']!r} wall_s={wall:.3f} launches="
          f"{ {k: v for k, v in launches.items() if v} }")
    for step, seconds in sec.items():
        print(f"    step {step}: {seconds:.3f} s")
    img_s = good / sec["img features"]
    print(f"  feature pass on the native lane: {img_s:.1f} img/s (the image pass, "
          f"decode included) on {DEVICE['card']}")
    check(launches == expected, f"native Stage-1 launches: expected {expected}, got {launches}")
    hdir = work / "hessians"
    names = [f"{k}_{t}.pt" for k in ("activations", "embeddings") for t in ("img", "txt")]
    names += [f"{f}_{t}_analytic.pt" for f in "AB" for t in ("img", "txt")]
    names.append("prior_precision_analytic.json")
    missing = [n for n in names if not (hdir / n).exists()]
    check(not missing, f"missing artifacts {missing}")
    act = torch.load(hdir / "activations_img.pt", weights_only=True)
    check(act.shape[0] == good, f"{act.shape[0]} image rows, {good} decoded")
    for f in ("A_img", "B_img", "A_txt", "B_txt"):
        F_ = torch.load(hdir / f"{f}_analytic.pt", weights_only=True)
        check(bool(torch.isfinite(F_).all()), f"{f} not finite")
    return {"launches": launches, "seconds": sec, "img_s": img_s,
            "loader_samples_s": NATIVE_SAMPLES / loader_s, "nvjpeg_img_s": nvjpeg_img_s,
            "rgb_img_s": rate["rgb"]}


def _native_cosine(torch, nio) -> float:
    """(e) clip-large image embeddings (bf16, seeded) on nvJPEG's 224 crops
    against those on the goldens' (libjpeg's) crops, per decoded fixture."""
    from bayesvlm_tpu_torch.models.encoders import load_model

    gold = np.load(NATIVE_FIXTURES / "goldens.npz")
    names = list(gold["names"])
    ok = [i for i, s in enumerate(gold["status"]) if s == 0]
    jpegs = [(NATIVE_FIXTURES / names[i]).read_bytes() for i in ok]
    crops, _ = nio.decode_batch_u8(jpegs, 224, device="cuda")
    image_encoder, _, _ = load_model(S1_MODEL, device="cuda", seed=SEED)
    with torch.no_grad():
        ours = image_encoder(crops).embeds.float()
        theirs = image_encoder(torch.from_numpy(gold["u8_crop224"][ok]).cuda()).embeds.float()
    cos = dict(zip((names[i] for i in ok),
                   torch.nn.functional.cosine_similarity(ours, theirs, dim=-1).tolist()))
    del image_encoder
    for name, c in cos.items():
        (lo, hi), reason = NATIVE_COS_APART.get(name, ((NATIVE_COS_MIN, 1.0), ""))
        print(f"  embedding cosine, nvJPEG vs golden crop, {name}: {c:.6f} (range "
              f"[{lo}, {hi}]{'; ' + reason if reason else ''})")
        check(lo <= c <= hi + 1e-6, f"{name}: embedding cosine {c} outside [{lo}, {hi}]")
    return min(c for name, c in cos.items() if name not in NATIVE_COS_APART)


def phase_native_decode(torch, counters, synthetic_img_s: float) -> dict:
    """The native decode lane: (a) built in phase 2 (csrc/jpeg_decode.cu by
    nvcc, csrc/host_io.cc by g++); (b) nvJPEG on the fixtures; (c) the
    resize_crop kernel vs plain; (d) the Stage-1 CLI with --native_decode
    over a tar of real JPEGs, beside phase 7c's feature pass on synthetic
    pixels (`synthetic_img_s`); (e) embeddings on nvJPEG crops vs the
    goldens'. The loader's warnings (one a failed decode) are counted."""
    import warnings

    from bayesvlm_tpu_torch.data import native_io as nio
    from bayesvlm_tpu_torch.kernels import BUILD_DIR

    _native_fixtures(torch, nio)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work, \
            warnings.catch_warnings(record=True) as dropped:
        warnings.simplefilter("always")
        work = Path(work)
        (work / "laion400m").mkdir()
        jpegs = _native_tar(work / "laion400m" / "00000.tar")
        colour = _native_colour(torch, nio, jpegs)
        kernel = _native_kernel(torch, nio, jpegs)
        cli = _native_cli(torch, counters, work)
    print(f"  {len(dropped)} warnings (samples dropped, each pass); the feature pass "
          f"{cli['img_s']:.1f} img/s on real JPEGs against {synthetic_img_s:.1f} img/s "
          f"on synthetic pixels (phase 7c)")
    cos_min = _native_cosine(torch, nio)
    print(f"  embedding cosine min {cos_min:.6f} over the other decoded fixtures "
          f"(limit {NATIVE_COS_MIN})")
    return {"colour": colour, "kernel": kernel, "cli": cli, "cos_min": cos_min}


def _ggn_bound(likelihood: str, N: int, D: int, P: int) -> dict:
    """fp32 bound of one class batch of kfac_ggn, counted from
    bayes/hessians.py: the [N, C] x [C, D]-shaped products (InfoNCE three:
    U Y^T, P Y, (P*Z) Y; SigLIP two: U Y^T, (C*Z) Y), the w products, the
    D x D Grams of the block statistics (InfoNCE four, SigLIP three), the
    assembly's sqrt(w) Y Gram and the activation Gram (P + 1 wide for
    SigLIP's bias); bytes: the three inputs read once, both factors
    written once."""
    C = N
    if likelihood == "info_nce":
        ops = 6 * N * C * D + 2 * N * C + 8 * N * D * D
    else:
        P += 1
        ops = 4 * N * C * D + 2 * N * C + 6 * N * D * D
    ops += 2 * C * D * D + 2 * N * P * P
    nbytes = 4 * (2 * N * D + N * P + D * D + P * P)
    return {**bound(nbytes, ops, "fp32"), "tflop": ops / 1e12}


def phase_ggn(torch) -> dict:
    """kfac_ggn alone at one class batch of GGN_PAIRS seeded pairs (block
    GGN_BLOCK; SigLIP's targets in chunks of GGN_CHUNK_J), InfoNCE at
    clip-large's dims and SigLIP at siglip-large's, at both precisions:
    B held against a float64 evaluation of the same formula, times beside
    the fp32 bound."""
    from bayesvlm_tpu_torch.bayes import estimation, hessians

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    N = GGN_PAIRS
    results = {}
    for lik, (model, D, P, scale, bias) in GGN_CASES.items():
        src, tgt = (torch.randn(N, D, generator=gen, device="cuda") for _ in range(2))
        act = torch.randn(N, P, generator=gen, device="cuda")
        chunk = GGN_CHUNK_J if lik == "siglip" else None
        f64 = {"dtype": torch.float64, "device": "cuda"}
        if lik == "info_nce":
            ref = hessians._hessian_infonce(src.double(), tgt.double(),
                                            torch.tensor(scale, **f64), GGN_BLOCK)
        else:
            ref = hessians._hessian_siglip(
                src.double(), torch.arange(N, device="cuda"), tgt.double(),
                torch.tensor(scale, **f64), torch.tensor(bias, **f64), GGN_BLOCK, chunk)
        ref = ref / math.sqrt(N)
        r = _ggn_bound(lik, N, D, P)
        for precision in ("highest", "high"):
            def call():
                return estimation.kfac_ggn(scale, bias, N, src, act, tgt, lik,
                                           block_size=GGN_BLOCK, chunk_size_j=chunk,
                                           precision=precision, device="cuda")
            A, B = call()
            err = float((B.double() - ref).abs().max() / ref.abs().max())
            ms = cuda_ms(torch, call, iters=3, warmup=1)
            parts = _launch_parts(torch, call, GGN_PARTS, calls=1)
            r[precision] = {"ms": ms, "pairs_s": N / ms * 1e3, "max_rel_err": err,
                            "parts_ms": parts}
            print(f"kfac_ggn {lik} ({model} dims: embeddings {D}, activations {P}"
                  f"{' + bias' if lik == 'siglip' else ''}), {N} pairs in one class batch, "
                  f"block {GGN_BLOCK}{f', chunk_j {chunk}' if chunk else ''}, precision "
                  f"{precision}: {ms:.3f} ms, {N / ms * 1e3:.1f} pairs/s; fp32 bound "
                  f"{r['bound_ms']:.3f} ms ({r['tflop']:.3f} TFLOP at 67 TFLOP/s, "
                  f"{r['bound_by']}); max |B - B_fp64| / max |B_fp64| = {err:.3e} "
                  f"(tol {GGN_TOL[precision]})")
            _print_parts(f"kfac_ggn {lik} {precision}", parts)
            check(bool(torch.isfinite(A).all() and torch.isfinite(B).all()),
                  f"kfac_ggn {lik} {precision}: non-finite factors")
            check(err <= GGN_TOL[precision],
                  f"kfac_ggn {lik} {precision}: B strays from float64 ({err:.3e})")
        results[lik] = r
        del src, tgt, act, ref, A, B
        torch.cuda.empty_cache()
    return results


# 8c: the HF checkpoint path at full width. Each model's seeded towers are
# written as an HF snapshot (fp16 model.safetensors by the writer below,
# fp32 pytorch_model.bin by torch.save) with a trained-looking head;
# from_pretrained runs SNAPSHOT_PRIOR_STEPS lambda steps (the same in
# both of the runs whose probabilities are compared bit for bit)
SNAPSHOT_MODELS = ("clip-large", "siglip-large")
SNAPSHOT_HEAD = {"clip": (4.25, None), "siglip": (4.5, -12.0)}
SNAPSHOT_PRIOR_STEPS = 100


def to_hf_state_dict(family: str, vision_sd: dict, text_sd: dict,
                     num_vision_layers: int, num_text_layers: int,
                     logit_scale=None, logit_bias=None) -> dict:
    """The port's two tower state dicts under the HF model's names (the
    inverse of models/convert.py's `convert_*`; CLIP's pre-LN under HF's
    `pre_layrnorm`, SigLIP's q/k/v packed into `in_proj`), with the head's
    `logit_scale` and `logit_bias` as 0-d tensors where given: an HF
    snapshot's layout."""
    import torch

    from bayesvlm_tpu_torch.models.convert import _key_map

    out = {}
    for tower, sd, n in (("vision", vision_sd, num_vision_layers),
                         ("text", text_sd, num_text_layers)):
        out.update({hf: sd[port] for hf, port in _key_map(family, tower, n)})
    if family == "siglip":
        for p in ("weight", "bias"):
            out[f"vision_model.head.attention.in_proj_{p}"] = torch.cat(
                [vision_sd[f"head_attention.{n}.{p}"] for n in ("q_proj", "k_proj", "v_proj")])
    for name, value in (("logit_scale", logit_scale), ("logit_bias", logit_bias)):
        if value is not None:
            out[name] = torch.tensor(value, dtype=torch.float32)
    return out


def write_safetensors_f16(path, sd: dict) -> int:
    """`sd` as one fp16 `.safetensors` file: an 8-byte little-endian header
    length, the JSON header (padded with spaces to 8 bytes), then the
    tensors' little-endian bytes in order. Returns the file's size."""
    import struct

    header, blobs, offset = {"__metadata__": {"format": "pt"}}, [], 0
    for name, t in sd.items():
        blob = t.detach().cpu().half().contiguous().numpy().tobytes()
        header[name] = {"dtype": "F16", "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for blob in blobs:
            f.write(blob)
    return 8 + len(raw) + offset


def _timed_load(torch, model: str, weights_dir, device):
    """load_model in fp32 from `weights_dir`: (the towers' state dicts, the
    head's (scale, bias), seconds, the card synchronised)."""
    from bayesvlm_tpu_torch.models.encoders import load_model

    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, txt, head = load_model(model, weights_dir=weights_dir, dtype=torch.float32,
                                device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return ({"vision": img.module.state_dict(), "text": txt.module.state_dict()},
            (float(head.logit_scale), float(head.logit_bias)), seconds)


def _check_same(torch, label: str, got: dict, want: dict, round_f16: bool) -> None:
    """Every tensor of both towers bit for bit (after fp16 rounding of the
    source for a fp16 snapshot)."""
    for tower in ("vision", "text"):
        check(set(got[tower]) == set(want[tower]), f"{label}: {tower} keys")
        for k, v in want[tower].items():
            ref = v.half().float() if round_f16 else v
            check(torch.equal(got[tower][k], ref.to(got[tower][k].device)),
                  f"{label}: {tower} {k} differs from the source")


def snapshot_case(torch, model: str, hessian_dir: str, pixels, prompts, root,
                  device, counters=None, per_forward=None) -> dict:
    """One model through the HF checkpoint path: seeded towers -> HF
    snapshots (fp16 safetensors, fp32 bin) -> load_model bit for bit ->
    convert_weights -> load_model bit for bit -> from_pretrained on the
    snapshot -> predict, with every count set to 0 just before the predict
    and read just after (`per_forward`: the launches expected)."""
    from bayesvlm_tpu_torch import convert_weights
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME
    from bayesvlm_tpu_torch.models.encoders import load_model
    from bayesvlm_tpu_torch.pipeline import ProbabilisticVLM

    cfg = CONFIGS_BY_NAME[model]
    img, txt, _ = load_model(model, dtype=torch.float32, device=device, seed=SEED)
    source = {"vision": {k: v.cpu() for k, v in img.module.state_dict().items()},
              "text": {k: v.cpu() for k, v in txt.module.state_dict().items()}}
    del img, txt
    scale, bias = SNAPSHOT_HEAD[cfg.family]
    hf = to_hf_state_dict(cfg.family, source["vision"], source["text"],
                          cfg.vision.num_layers, cfg.text.num_layers,
                          logit_scale=scale, logit_bias=bias)
    want_head = (float(np.float32(scale)), float(np.float32(bias or 0.0)))
    out = {"params": sum(v.numel() for v in hf.values())}

    binary = Path(root) / "bin"
    binary.mkdir()
    t0 = time.perf_counter()
    torch.save(hf, binary / "pytorch_model.bin")
    out["bin_write_s"] = time.perf_counter() - t0
    out["bin_mb"] = (binary / "pytorch_model.bin").stat().st_size / 1e6
    got, head, out["bin_load_s"] = _timed_load(torch, model, binary, device)
    _check_same(torch, f"{model} pytorch_model.bin", got, source, round_f16=False)
    check(head == want_head, f"{model} bin head {head} != {want_head}")
    del got
    (binary / "pytorch_model.bin").unlink()

    snap = Path(root) / "snapshot"
    snap.mkdir()
    t0 = time.perf_counter()
    write_safetensors_f16(snap / "model.safetensors", hf)
    out["st_write_s"] = time.perf_counter() - t0
    out["st_mb"] = (snap / "model.safetensors").stat().st_size / 1e6
    del hf
    got, head, out["st_load_s"] = _timed_load(torch, model, snap, device)
    _check_same(torch, f"{model} fp16 model.safetensors", got, source, round_f16=True)
    check(head == want_head, f"{model} safetensors head {head} != {want_head}")

    t0 = time.perf_counter()
    conv = convert_weights.main(model, str(snap), str(Path(root) / "converted"))
    out["convert_s"] = time.perf_counter() - t0
    out["converted_mb"] = sum(p.stat().st_size for p in conv.iterdir()) / 1e6
    got2, head2, out["converted_load_s"] = _timed_load(torch, model, conv, device)
    _check_same(torch, f"{model} convert_weights", got2, got, round_f16=False)
    check(head2 == head, f"{model} convert_weights head {head2} != {head}")
    del got, got2, source

    # the converted directory's towers are the snapshot's bit for bit
    # (_check_same above), so one predict, from the snapshot, covers both
    vlm = ProbabilisticVLM.from_pretrained(
        model, hessian_dir, weights_dir=str(snap), dtype="bf16", device=device,
        prior_num_steps=SNAPSHOT_PRIOR_STEPS, mesh=None)
    vlm.set_class_prompts(prompts)
    for c in (counters or {}).values():
        c.launches = 0
    p = vlm.predict(pixels)
    if device.type == "cuda":
        torch.cuda.synchronize()
    if counters is not None:
        out["launches"] = {n: c.launches for n, c in counters.items()}
        expected = {**dict.fromkeys(counters, 0), **per_forward}
        check(out["launches"] == expected, f"{model} snapshot predict launches: "
                                           f"expected {expected}, got {out['launches']}")
    del vlm
    check(tuple(p.shape) == (len(pixels), len(prompts)) and bool(torch.isfinite(p).all()),
          f"{model} snapshot predict: shape {tuple(p.shape)} or non-finite")
    return out


def phase_snapshot(torch, counters, hessian_dirs: dict, prompts) -> dict:
    """8c: the HF checkpoint path at clip-large and siglip-large width."""
    from bayesvlm_tpu_torch import kernels
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME
    from bayesvlm_tpu_torch.utils import get_image_size

    t_phase = time.perf_counter()
    results = {}
    for model in SNAPSHOT_MODELS:
        size = get_image_size(model)
        pixels = np.random.default_rng(SEED + 3).normal(
            size=(BATCH, size, size, 3)).astype(np.float32)
        with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as root:
            r = snapshot_case(torch, model, hessian_dirs[model], pixels, prompts, root,
                              torch.device("cuda"), counters,
                              {"attention": CONFIGS_BY_NAME[model].vision.num_layers})
        results[model] = r
        print(f"HF snapshot {model} ({DEVICE['card']}): {r['params'] / 1e6:.1f}M params; "
              f"fp16 model.safetensors {r['st_mb']:.1f} MB written in "
              f"{r['st_write_s']:.2f} s, load_model {r['st_load_s']:.2f} s "
              f"({r['st_mb'] / r['st_load_s']:.0f} MB/s); fp32 pytorch_model.bin "
              f"{r['bin_mb']:.1f} MB, load_model {r['bin_load_s']:.2f} s "
              f"({r['bin_mb'] / r['bin_load_s']:.0f} MB/s); convert_weights "
              f"{r['convert_s']:.2f} s, its {r['converted_mb']:.1f} MB read by "
              f"load_model in {r['converted_load_s']:.2f} s "
              f"({r['converted_mb'] / r['converted_load_s']:.0f} MB/s); bit-equal "
              f"towers and predict (B={BATCH}, bf16), launches "
              f"{ {n: v for n, v in r['launches'].items() if v} }")
    print(f"HF snapshot phase: {time.perf_counter() - t_phase:.1f} s")
    return results


def phase_tiny_reference(torch, attention, hessian_dir: str,
                         model: str = "tiny-clip",
                         lanes=("default", "block")) -> None:
    """A tiny model in fp32 through the kernels on the card vs the plain
    path on the CPU, with the same weights and Hessian factors, in the
    default lane and (tiny-clip) in the block lane."""
    from pathlib import Path

    from bayesvlm_tpu_torch.models.encoders import rebuild_image_encoder
    from bayesvlm_tpu_torch.pipeline import ProbabilisticVLM

    cpu = ProbabilisticVLM.from_pretrained(model, hessian_dir,
                                           dtype="fp32", device="cpu",
                                           prior_num_steps=50)
    wd = Path(hessian_dir)
    torch.save(cpu.image_encoder.module.state_dict(), wd / "vision.pt")
    torch.save(cpu.text_encoder.module.state_dict(), wd / "text.pt")
    gpu = ProbabilisticVLM.from_pretrained(model, hessian_dir,
                                           weights_dir=hessian_dir,
                                           dtype="fp32", device="cuda",
                                           prior_num_steps=50, mesh=None)
    prompts = ["a cat", "a dog", "a bird"]
    pixels = np.random.default_rng(SEED + 2).normal(
        size=(8, 32, 32, 3)).astype(np.float32)
    for lane in lanes:
        if lane == "block":
            for vlm in (cpu, gpu):
                vlm.image_encoder = rebuild_image_encoder(vlm.image_encoder,
                                                          attn_pallas_block=True)
        ref = cpu.set_class_prompts(prompts).predict(pixels)
        before = attention.fused_attention_block.launches
        out = gpu.set_class_prompts(prompts).predict(pixels).cpu()
        blocks = attention.fused_attention_block.launches - before
        diff = float((out - ref).abs().max())
        print(f"{model} {lane} lane card vs CPU (fp32): max_abs_diff={diff:.3e} "
              f"(tol {TINY_TOL}) attention_block launches={blocks}")
        check(diff <= TINY_TOL, f"{model} {lane} lane on the card disagrees "
                                f"with the CPU")
        check(blocks == (0 if lane == "default" else 2), f"{model} {lane} lane "
                                                          f"block launches {blocks}")


class _Count:
    """One kernel's launch count, read and set as `.launches`."""

    def __init__(self, obj, attr: str):
        self.obj, self.attr = obj, attr

    @property
    def launches(self) -> int:
        return getattr(self.obj, self.attr)

    @launches.setter
    def launches(self, value: int) -> None:
        setattr(self.obj, self.attr, value)


def _top_overlap(torch, a, b, k: int = 50) -> int:
    k = min(k, a.numel())
    ta = set(torch.topk(a, k).indices.tolist())
    return len(ta & set(torch.topk(b, k).indices.tolist()))


def _rowsum_check(torch, ej, label: str, pool, targ, k: int, use_int8: bool):
    """Kernel vs plain row sums and EPIG scores on the same operands."""
    n_p, n_t = pool.shape[0] // EPIG_C, targ.shape[0] // EPIG_C
    out = ej.joint_xlogy_rowsums(pool, targ, k, use_int8=use_int8)
    ref = ej.joint_xlogy_rowsums_reference(pool, targ, k, use_int8=use_int8)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    row_ok = bool((err <= ROWSUM_RTOL * ref.abs()).all())
    s_k = ej.scores_from_rowsums(pool, targ, out, n_p, n_t, EPIG_C)
    s_p = ej.scores_from_rowsums(pool, targ, ref, n_p, n_t, EPIG_C)
    score_tol = ROWSUM_RTOL * ref.abs().reshape(n_p, EPIG_C).sum(1) / n_t
    score_err = (s_k - s_p).abs()
    r = {"max_abs_err": float(err.max()), "max_rel_err": float((err / ref.abs()).max()),
         "max_score_err": float(score_err.max()), "scores": s_k, "plain_scores": s_p}
    print(f"  {label}: max |d rowsum|={r['max_abs_err']:.3e} (max rel "
          f"{r['max_rel_err']:.3e}, tol {ROWSUM_RTOL:.0e} rel) max |d EPIG|="
          f"{r['max_score_err']:.3e} (tol {float(score_tol.min()):.3e}.."
          f"{float(score_tol.max()):.3e}, per row)")
    check(row_ok, f"{label}: row sums disagree with the plain version")
    check(bool((score_err <= score_tol).all()),
          f"{label}: EPIG scores disagree with the plain version")
    return r


def _resources_line(r: dict) -> str:
    """The EPIG kernel instantiation's resources, as kernel_resources reads
    them."""
    kind = "streamed" if r["streamed"] else "resident"
    return (f"body {r['body']} ({kind}, K padded to {r['k_pad']}): {r['smem_bytes']} B "
            f"shared memory (limit {r['smem_limit']}), {r['threads']} threads of "
            f"{r['registers']} registers at launch, {r['local_bytes']} B local memory, "
            f"{r['blocks_per_sm']} blocks/SM")


def phase_epig_vs_plain(torch, ej, counters) -> dict:
    """The joint-entropy kernel, bf16 and int8, at the operating point."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)

    def probs(n, k=EPIG_K):
        return torch.softmax(torch.randn(n, k, EPIG_C, generator=gen, device="cuda"), -1)

    probs_pool, probs_targ = probs(EPIG_POOL), probs(EPIG_TARG)
    pool, targ = ej._flatten(probs_pool), ej._flatten(probs_targ)
    M, N, K = pool.shape[0], targ.shape[0], EPIG_K
    print(f"EPIG joint-entropy kernel vs plain (pool {EPIG_POOL}, targets "
          f"{EPIG_TARG}, C={EPIG_C}, K={K}: M={M}, N={N}):")
    results = {}
    for name, use_int8, op_type in (("bf16", False, "bf16"), ("int8", True, "int8")):
        r = _rowsum_check(torch, ej, f"{name} M={M} N={N} K={K}", pool, targ, K,
                          use_int8)
        r["top50_overlap"] = _top_overlap(torch, r["scores"], r["plain_scores"])
        r["ms"] = cuda_ms(torch, lambda: ej.joint_xlogy_rowsums(
            pool, targ, K, use_int8=use_int8), iters=10, warmup=2)
        r["plain_ms"] = cuda_ms(torch, lambda: ej.joint_xlogy_rowsums_reference(
            pool, targ, K, use_int8=use_int8), iters=3, warmup=1)
        # the function's bytes: the fp32 operands read once, the row sums
        # written; its operations: the product at the unpadded K; one log
        # per joint element
        r.update(bound((M + N) * K * 4 + M * 4, 2 * M * N * K, op_type,
                       transcendentals=M * N))
        r.update(ej.kernel_resources(use_int8, K))
        print(f"  {name}: kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) top50 overlap with "
              f"plain={r['top50_overlap']}/50\n  {_resources_line(r)}")
        # the streamed instantiation forced at the operating point: what
        # the resident one saves there (the wrapper takes it only past the
        # resident block's shared memory)
        ref = ej.joint_xlogy_rowsums_reference(pool, targ, K, use_int8=use_int8)
        err = (ej._launch(pool, targ, K, use_int8, streamed=True) - ref).abs()
        r["streamed_ms"] = cuda_ms(torch, lambda: ej._launch(
            pool, targ, K, use_int8, streamed=True), iters=10, warmup=2)
        r["streamed_max_rel_err"] = float((err / ref.abs()).max())
        print(f"  {name} streamed instantiation forced at K={K}: kernel_ms="
              f"{r['streamed_ms']:.4f} (resident {r['ms']:.4f}) max rel err "
              f"{r['streamed_max_rel_err']:.3e}")
        check(bool((err <= ROWSUM_RTOL * ref.abs()).all()),
              f"{name} streamed at K={K} disagrees with the plain version")
        results[name] = r

    # yardstick (reference only: no single PyTorch call computes the
    # function): the cuBLAS bf16 product of the same shape, in the plain
    # version's pool chunks, writing the joint chunk by chunk
    a16, b16 = pool.bfloat16(), targ.bfloat16()
    rows = ej._CHUNK_ELEMS // N

    def cublas():
        for i in range(0, M, rows):
            torch.matmul(a16[i:i + rows], b16.T)

    yard = cuda_ms(torch, cublas, iters=5, warmup=1)
    results["bf16"]["cublas_bf16_ms"] = yard
    print(f"  yardstick (reference only): cuBLAS bf16 joint product in "
          f"{-(-M // rows)} chunks of {rows} rows: {yard:.4f} ms")

    s16, s8 = results["bf16"]["scores"], results["int8"]["scores"]
    print(f"  int8 vs bf16 EPIG scores (printed only; the JAX package measured "
          f"int8 ranking-destroying): max |d|={float((s8 - s16).abs().max()):.3e} "
          f"score spread={float(s16.max() - s16.min()):.3e} top50 overlap="
          f"{_top_overlap(torch, s8, s16)}/50")

    # the int8 kernel's path (the JAX package's epig_from_probs_pallas with
    # use_int8=True), counts set to 0 just before and read just after
    for c in counters.values():
        c.launches = 0
    scores = ej.epig_from_probs_fused(probs_pool, probs_targ, use_int8=True)
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    expected = {n: int(n == "xlogy_rowsum_int8") for n in counters}
    print(f"  int8 scoring path epig_from_probs_fused(use_int8=True): "
          f"launches={launches}")
    check(launches == expected, f"int8 scoring path launches {launches}")
    check(bool(torch.isfinite(scores).all()), "non-finite int8 EPIG scores")
    check(torch.equal(scores, s8), "the int8 scoring path disagrees with its kernel")
    results["int8"]["launches"] = launches["xlogy_rowsum_int8"]

    # a ragged small shape: M, N no multiple of the 128-row tiles, K = 9
    gen.manual_seed(SEED + 6)
    small_p, small_t = ej._flatten(probs(37, 9)), ej._flatten(probs(29, 9))
    for name, use_int8 in (("bf16", False), ("int8", True)):
        _rowsum_check(torch, ej, f"{name} ragged M={small_p.shape[0]} "
                      f"N={small_t.shape[0]} K=9", small_p, small_t, 9, use_int8)

    # K past the resident block's shared memory: the streamed instantiation
    K = EPIG_LONG_K
    gen.manual_seed(SEED + 11)
    long_p = ej._flatten(probs(EPIG_LONG_POOL, K))
    long_t = ej._flatten(probs(EPIG_LONG_TARG, K))
    Ml, Nl = long_p.shape[0], long_t.shape[0]
    for name, use_int8, op_type in (("bf16", False, "bf16"), ("int8", True, "int8")):
        r = _rowsum_check(torch, ej, f"{name} streamed M={Ml} N={Nl} K={K}", long_p,
                          long_t, K, use_int8)
        r["ms"] = cuda_ms(torch, lambda: ej.joint_xlogy_rowsums(
            long_p, long_t, K, use_int8=use_int8), iters=5, warmup=1)
        r.update(bound((Ml + Nl) * K * 4 + Ml * 4, 2 * Ml * Nl * K, op_type,
                       transcendentals=Ml * Nl))
        r.update(ej.kernel_resources(use_int8, K))
        print(f"  {name} streamed K={K}: kernel_ms={r['ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']})\n  {_resources_line(r)}")
        results[name][f"k{K}"] = {k: r[k] for k in (
            "max_abs_err", "max_rel_err", "ms", "bound_ms", "bound_by", "smem_bytes",
            "registers", "blocks_per_sm", "local_bytes")}
    for r in results.values():
        del r["scores"], r["plain_scores"]
    return results


def phase_epig_path(torch, counters, hessian_dir: str) -> dict:
    """Stage 3 at clip-large width: features from the port's bf16 towers
    on seeded pixels, then select_epig_online as the active-learning
    script runs it."""
    from bayesvlm_tpu_torch.io.artifacts import load_hessians
    from bayesvlm_tpu_torch.pipeline import ProbabilisticVLM
    from bayesvlm_tpu_torch.probforward import smith
    from bayesvlm_tpu_torch.select import epig as epig_mod
    from bayesvlm_tpu_torch.types import EncoderResult
    from bayesvlm_tpu_torch.utils import get_image_size

    t0 = time.perf_counter()
    vlm = ProbabilisticVLM.from_pretrained(MODEL, hessian_dir, dtype="bf16",
                                           device="cuda", seed=SEED, mesh=None)
    size = get_image_size(MODEL)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)

    def encode(n: int, batch: int = 250) -> EncoderResult:
        parts = []
        for i in range(0, n, batch):
            pixels = torch.randn(min(batch, n - i), size, size, 3, generator=gen,
                                 device="cuda")
            parts.append(vlm.encode_images(pixels))
        r = EncoderResult.concatenate(parts)
        return EncoderResult(r.embeds.float(), r.activations.float(),
                             r.residuals.float())

    pool, targ = encode(EPIG_POOL_IMAGES), encode(EPIG_TARGET_IMAGES)
    labels = vlm.encode_texts([f"a photo of a thing of class {i}"
                               for i in range(EPIG_CLASSES)])
    labels = EncoderResult(labels.embeds.float(), labels.activations.float(),
                           labels.residuals.float())
    torch.cuda.synchronize()
    t_feat = time.perf_counter() - t0
    A_img, B_img = load_hessians(hessian_dir, "img")
    A_txt, B_txt = load_hessians(hessian_dir, "txt")
    kernel = vlm.image_encoder.projection_weight().detach().float().T.contiguous()
    class_ids = np.random.default_rng(SEED + 7).integers(
        0, EPIG_CLASSES, size=EPIG_POOL_IMAGES)
    kwargs = dict(
        label_features=labels, pool_features=pool, target_features=targ,
        pool_class_ids=class_ids, projection_kernel=kernel, projection_bias=None,
        head=vlm.head, A_img=A_img, A_txt=A_txt, B_img=B_img, B_txt=B_txt,
        cov_info=vlm.info, budget=EPIG_BUDGET, lr=1e-4, hessian_update_scale=10.0,
        num_samples=EPIG_K, seed=0,
        projection_l2=vlm.image_encoder.projection_l2(),
        projection_num_params=vlm.image_encoder.projection_num_params(),
        chunk_size=EPIG_CHUNK, pool_subsampling="knn_wasserstein",
        k_nearest_neighbors=1, device="cuda")
    print(f"EPIG path (clip-large, bf16 towers): projection {tuple(kernel.shape)}, "
          f"{EPIG_POOL_IMAGES} pool + {EPIG_TARGET_IMAGES} target images and "
          f"{EPIG_CLASSES} prompts encoded; from_pretrained + features "
          f"{t_feat:.2f} s; lambda_img={vlm.info['lambda_img']!r}")

    # the main run: every count set to 0 just before, read just after
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    selected, scores = epig_mod.select_epig_online(**kwargs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items()}

    # a second run with each part timed (synchronised wrappers) for the
    # split of a step; it also reads the pool subsample and lambda
    spans: dict = {}
    seen: dict = {"n_pool": [], "lambda": []}

    def timed(module, name, span, note=None):
        fn = getattr(module, name)

        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spans[span] = spans.get(span, 0.0) + time.perf_counter() - t
            if note:
                note(args, kw, out)
            return out
        return fn, wrapper

    notes = {
        "epig_from_logits_using_matmul":
            lambda a, kw, out: seen["n_pool"].append(len(a[0])),
        "optimize_prior_precision":
            lambda a, kw, out: seen["lambda"].append(float(out)),
    }
    patches = [(epig_mod, "epig_from_logits_using_matmul", "scoring"),
               (smith, "probabilistic_logits", "scoring"),
               (epig_mod, "_epig_sgd_step", "sgd step + re-embed"),
               (epig_mod, "update_embeddings", "sgd step + re-embed"),
               (epig_mod, "hessian_infonce", "hessian update"),
               (epig_mod, "optimize_prior_precision", "lambda re-opt"),
               (epig_mod, "compute_covariances", "covariances")]
    originals = []
    for module, name, span in patches:
        fn, wrapper = timed(module, name, span, notes.get(name))
        originals.append((module, name, fn))
        setattr(module, name, wrapper)
    try:
        t0 = time.perf_counter()
        selected2, scores2 = epig_mod.select_epig_online(**kwargs)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    finally:
        for module, name, fn in originals:
            setattr(module, name, fn)

    n_pool = seen["n_pool"][0]
    expected = {n: 0 for n in counters}
    expected["xlogy_rowsum"] = EPIG_BUDGET * -(-n_pool // EPIG_CHUNK)
    for span in ("scoring", "sgd step + re-embed", "hessian update",
                 "lambda re-opt", "covariances"):
        ms = spans.get(span, 0.0) / EPIG_BUDGET * 1e3
        print(f"  EPIG step split: {span}: {ms:.2f} ms per step")
    rest = (wall2 - sum(spans.values())) / EPIG_BUDGET * 1e3
    print(f"  EPIG step split: rest (subsampling, argsort, host loop): "
          f"{rest:.2f} ms per step")
    ms_step = wall / EPIG_BUDGET * 1e3
    print(f"EPIG path: selected={selected} scores={scores} pool_subsample={n_pool} "
          f"launches={launches} ms_per_step={ms_step:.2f} "
          f"(timed run {wall2 / EPIG_BUDGET * 1e3:.2f}) lambda_img "
          f"{vlm.info['lambda_img']!r} -> {seen['lambda']}")
    check(len(set(selected)) == EPIG_BUDGET, f"selected {selected}")
    check(all(np.isfinite(s) for s in scores), f"scores {scores}")
    check(launches == expected, f"EPIG path launches: expected {expected}, "
                                f"got {launches}")
    check(seen["lambda"][-1] != vlm.info["lambda_img"], "lambda_img did not move")
    check(selected2 == selected, "a second run selected other indices")
    del vlm
    return {"launches": launches, "ms_per_step": ms_step, "n_pool": n_pool}


def _al_checks(torch, label: str, run: dict, encoder, strategies: int) -> None:
    """The strategies' subsets, their checkpoints and the best metrics of
    one active-learning run."""
    from bayesvlm_tpu_torch.select.knn import extract_test_train_indices

    subsets = run["subsets"]
    check(len(subsets) == strategies, f"{label}: {len(subsets)} strategies")
    capped = {}
    for name, by_test in subsets.items():
        n = len(extract_test_train_indices(by_test)["train"])
        if "kmeans_knn" in name:
            # one neighbour kept a test sample (ref:bayesvlm/knn_kmeans.py:205-211):
            # two test samples may keep the same representative
            capped[name] = n
            check(1 <= n <= AL_SUBSET, f"{label} {name}: {n} unique train indices")
        else:
            check(n == AL_SUBSET, f"{label} {name}: {n} unique train indices")
        scores = [v["score"] for v in by_test.values()]
        check(all(math.isfinite(x) for x in scores), f"{label} {name}: a score not finite")
        encoder.load_projection_weights(run["subset_dir"] / name / "img_projection.pt")
    if capped:
        print(f"  {label}: unique train indices of the capped kNN strategies {capped}")
    for name, m in run["results"].items():
        for k in ("accuracy", "ece"):
            check(math.isfinite(m[k]) and 0.0 <= m[k] <= 1.0, f"{label} {name} {k} {m[k]}")
    best = max(run["results"].values(), key=lambda m: m["accuracy"])
    ft = run["finetune"]
    ft_s = sum(t["seconds"] for t in ft.values())
    steps = sum(t["steps"] for t in ft.values())
    each = [t["seconds"] for t in ft.values()]
    for step, sec in run["seconds"].items():
        print(f"  {label} step {step}: {sec:.3f} s")
    for name, sec in run["strategy_seconds"].items():
        print(f"  {label} strategy {name}: {sec:.3f} s")
    print(f"  {label}: {len(ft)} subsets fine-tuned, {ft_s / len(ft):.3f} s a subset, "
          f"{steps / ft_s:.1f} steps/s ({steps} steps, "
          f"{sum(t['epochs'] for t in ft.values())} epochs; the first subset "
          f"{each[0]:.3f} s, the others' median {float(np.median(each[1:])):.3f} s); "
          f"best test accuracy "
          f"{best['accuracy']!r}, its ECE {best['ece']!r}; {len(subsets)} "
          f"img_projection.pt loaded (strict keys)")


class _StubLLM:
    """A deterministic stand-in for the LLM of activelearning_llm: a 1-5
    score from the prompt's crc32 (never `hash`, which is salted per
    process); it counts its calls and reaches no network."""

    def __init__(self):
        self.calls = 0

    def __call__(self, prompt: str) -> str:
        import zlib

        self.calls += 1
        return f"Score: {1 + zlib.crc32(prompt.encode()) % 9 * 0.5}"


def _egl_alone_ms(torch) -> float:
    """expected_gradient_length alone at 8d's test pool (2000 candidates,
    65 classes, clip-large's 768-dim embeddings and 1024-dim activations),
    seeded features, CUDA events."""
    from bayesvlm_tpu_torch.select.egl import expected_gradient_length
    from bayesvlm_tpu_torch.types import EncoderResult, ProbabilisticLogits

    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    n, c = AL_SPLITS["num_test"], AL_SPLITS["num_classes"]
    rand = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    img = EncoderResult.create(rand(n, 768), rand(n, 1024))
    txt = EncoderResult.create(rand(c, 768), rand(c, 1024))
    logits = ProbabilisticLogits(mean=rand(n, c), var=rand(n, c).abs())
    out = expected_gradient_length(img, txt, logits, 4.6052)
    check(bool(torch.isfinite(out).all()), "EGL scores not finite")
    return cuda_ms(torch, lambda: expected_gradient_length(img, txt, logits, 4.6052))


def phase_active_learning(torch, counters, hessian_dir: str) -> dict:
    """Phase 8d: the active-learning CLIs at clip-large width, each run
    with every count set to 0 just before and read just after."""
    from bayesvlm_tpu_torch import (
        activelearning,
        activelearning_elg,
        activelearning_kmeans,
        activelearning_llm,
    )
    from bayesvlm_tpu_torch.kernels import BUILD_DIR
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME
    from bayesvlm_tpu_torch.models.encoders import load_model
    from bayesvlm_tpu_torch.utils import get_image_size

    L = CONFIGS_BY_NAME[MODEL].vision.num_layers
    forwards = sum(-(-AL_SPLITS[k] // AL_PRECOMPUTE_BATCH)
                   for k in ("num_train", "num_val", "num_test"))
    # the kNN pool subsample is at most one neighbour a target, so EPIG
    # scores it in one chunk a step
    epig_chunks = -(-min(AL_SPLITS["num_test"], AL_SPLITS["num_train"]) // EPIG_CHUNK)
    overrides = dict(AL_SPLITS, image_size=get_image_size(MODEL))
    # the fine-tune's logger uses wandb where it imports; here it must
    # stay offline and start no process
    os.environ["WANDB_MODE"] = "disabled"
    t_phase = time.perf_counter()
    encoder = load_model(MODEL, device="cuda", seed=SEED + 11)[0]
    llm = _StubLLM()
    features = {"attention": L * forwards, "xlogy_rowsum": AL_SUBSET * epig_chunks}
    epig_only = {"xlogy_rowsum": AL_SUBSET * epig_chunks}
    out = {}
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as exp, \
            tempfile.TemporaryDirectory(dir=BUILD_DIR) as exp_elg:
        kw = dict(model_str=MODEL, dataset="synthetic", hessian_dir=hessian_dir,
                  experiment_dir=exp, project_name="active-finetuning",
                  hessian_scale=10.0, subset_size=AL_SUBSET, finetune_epochs=AL_EPOCHS,
                  precompute_batch_size=AL_PRECOMPUTE_BATCH, device="cuda",
                  dataset_overrides=overrides)
        # the EGL CLI on a directory of its own (its own feature pass), the
        # LLM CLI after it on that directory (features from the cache): both
        # LLM strategies, the stub client, no pacing (2 x 2000 calls at the
        # CLI's 1.1 s would take over an hour)
        elg_kw = dict(kw, experiment_dir=exp_elg)
        llm_kw = dict(elg_kw, run_llm_difficulty=True, run_llm_value=True,
                      llm_client=llm, llm_rate_limit_delay=0.0)
        cases = (("main", activelearning, kw, features, 14),
                 ("kmeans", activelearning_kmeans, kw, epig_only, 14),
                 ("resume", activelearning, kw, {}, None),
                 ("elg", activelearning_elg, elg_kw, features, 15),
                 ("llm", activelearning_llm, llm_kw, epig_only, 16))
        for label, cli, cli_kw, per_run, strategies in cases:
            expected = {**dict.fromkeys(counters, 0), **per_run}
            for c in counters.values():
                c.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run = cli.run(**cli_kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {n: c.launches for n, c in counters.items()}
            print(f"active learning {label} ({MODEL}, bf16, synthetic {AL_SPLITS} at "
                  f"{overrides['image_size']} px, {AL_EPOCHS} epochs): wall_s={wall:.3f} "
                  f"launches={launches}")
            check(launches == expected,
                  f"active learning {label} launches: expected {expected}, got {launches}")
            if label == "resume":
                check(run["strategy_seconds"] == {} and run["finetune"] == {},
                      f"the resume redid {list(run['strategy_seconds'])} "
                      f"{list(run['finetune'])}")
                for step, sec in run["seconds"].items():
                    print(f"  resume step {step}: {sec:.3f} s")
            else:
                _al_checks(torch, f"active learning {label}", run, encoder, strategies)
            out[label] = dict(launches=launches, seconds=run["seconds"], wall_s=wall,
                              strategy_seconds=run["strategy_seconds"])
            if label == "main":
                # the dist phase's two-rank run is held to these
                out[label].update(
                    subsets=json.loads(json.dumps(run["subsets"])),
                    results=json.loads(json.dumps(run["results"])),
                    files=sorted(str(f.relative_to(exp)) for f in Path(exp).rglob("*")
                                 if f.is_file()))
    n_test = AL_SPLITS["num_test"]
    check(llm.calls == 2 * n_test, f"the stub LLM took {llm.calls} calls, not {2 * n_test}")
    main = out["main"]
    n_img = sum(AL_SPLITS[k] for k in ("num_train", "num_val", "num_test"))
    epig_ms = main["strategy_seconds"]["epig_knn"] / AL_SUBSET * 1e3
    egl_ms = _egl_alone_ms(torch)
    print(f"  active learning: feature pass {n_img / main['seconds']['[1] features']:.1f} "
          f"img/s ({n_img} images and {AL_SPLITS['num_classes']} prompts, synthetic "
          f"images drawn on the host), epig_knn {epig_ms:.2f} ms a step, "
          f"epig_direct {out['kmeans']['strategy_seconds']['epig_direct'] / AL_SUBSET * 1e3:.2f}"
          f" ms a step; EGL CLI feature pass "
          f"{n_img / out['elg']['seconds']['[1] features']:.1f} img/s, egl_test "
          f"{out['elg']['strategy_seconds']['egl_test'] * 1e3:.2f} ms (EGL + kNN), "
          f"expected_gradient_length alone {egl_ms:.4f} ms ({n_test} x "
          f"{AL_SPLITS['num_classes']}); LLM CLI {llm.calls} stub calls, "
          f"llm_difficulty_test {out['llm']['strategy_seconds']['llm_difficulty_test']:.3f} s,"
          f" llm_value_test {out['llm']['strategy_seconds']['llm_value_test']:.3f} s; "
          f"card {DEVICE['card']}; phase {time.perf_counter() - t_phase:.1f} s")
    out["egl_ms"] = egl_ms
    del encoder
    return out


@contextlib.contextmanager
def _plain_attention():
    """Route the towers' attention through the kernel's plain version
    (`fused_attention_reference`, differentiated by autograd) instead of the
    kernel, for as long as the context lasts."""
    from bayesvlm_tpu_torch.models import attention, layers

    kernel = layers.fused_attention
    layers.fused_attention = (lambda q, k, v, num_heads, **kw:
                              attention.fused_attention_reference(q, k, v, num_heads))
    try:
        yield
    finally:
        layers.fused_attention = kernel


def _backbone_run(torch, counters, dtype, steps: int, remat: bool = False,
                  plain: bool = False) -> dict:
    """`steps` backbone steps on a fresh seeded clip-large vision tower, with
    every count set to 0 just before and read just after: the losses, the
    trained parameters' gradients of step 1, the parameters before and
    after, the launches and the peak device memory the steps add."""
    from bayesvlm_tpu_torch.models.encoders import load_model
    from bayesvlm_tpu_torch.train.backbone import make_backbone_train_step

    module = load_model(MODEL, dtype=dtype, seed=SEED + 13, device="cuda",
                        remat=remat)[0].module
    rng = np.random.default_rng(SEED + 14)
    size = module.config.image_size
    images = torch.from_numpy(rng.normal(size=(BB_BATCH, size, size, 3)).astype(
        np.float32)).cuda()
    labels = torch.from_numpy(rng.integers(0, BB_CLASSES, size=BB_BATCH)).cuda()
    targets = torch.from_numpy(rng.normal(size=(BB_CLASSES, module.config.projection_dim))
                               .astype(np.float32)).cuda()
    t = targets / torch.linalg.norm(targets, dim=-1, keepdim=True)

    def loss_fn(m, batch):
        # tests/test_backbone_finetune.py's loss: CE of cosine logits x 10
        embeds, _ = m(batch[0])
        e = embeds / torch.linalg.norm(embeds, dim=-1, keepdim=True)
        return torch.nn.functional.cross_entropy(e @ t.T * 10.0, batch[1])

    init_state, step = make_backbone_train_step(
        module, loss_fn, num_layers=module.config.num_layers, k_last_layers=BB_K,
        projection_names=("visual_projection",), learning_rate=BB_LR,
        weight_decay=BB_WD)
    init_state()
    before = {n: p.detach().clone() for n, p in module.named_parameters()}
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # what the steps add (activations, gradients, AdamW's moments) over
    # what is held before them (the tower, the copies above, other runs')
    held = torch.cuda.memory_allocated()
    losses, grads, ms = [], None, []
    with (_plain_attention() if plain else contextlib.nullcontext()):
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(float(step((images, labels))))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if grads is None:
                grads = {n: p.grad.detach().clone() for n, p in module.named_parameters()
                         if p.grad is not None}
    launches = {n: c.launches for n, c in counters.items()}
    return dict(module=module, before=before, losses=losses, grads=grads, ms=ms,
                launches=launches, max_allocated_mib=torch.cuda.max_memory_allocated() / 2**20,
                peak_mib=(torch.cuda.max_memory_allocated() - held) / 2**20)


def _rel(a: dict, b: dict, names) -> float:
    """|a - b| / |b| over the named tensors together (fp32)."""
    num = sum(float((a[n].float() - b[n].float()).square().sum()) for n in names)
    den = sum(float(b[n].float().square().sum()) for n in names)
    return math.sqrt(num / den)


def phase_backbone(torch, counters) -> dict:
    """Phase 8e: the partial-backbone fine-tune at clip-large width."""
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME

    t_phase = time.perf_counter()
    L = CONFIGS_BY_NAME[MODEL].vision.num_layers
    trained_layers = {f"encoder.layers.{i}." for i in range(L - BB_K, L)}
    zero = dict.fromkeys(counters, 0)
    base = _backbone_run(torch, counters, torch.float32, BB_STEPS)
    losses = base["losses"]
    print(f"backbone step ({MODEL} vision, fp32, B={BB_BATCH}, k_last_layers={BB_K} + "
          f"projection, lr {BB_LR}, wd {BB_WD}): losses {losses}, ms a step "
          f"{[round(x, 3) for x in base['ms']]}, the steps add {base['peak_mib']:.1f} MiB "
          f"at their peak, launches {base['launches']}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"backbone losses {losses} not finite or not falling")
    check(base["launches"] == {**zero, "attention": L * BB_STEPS},
          f"backbone launches {base['launches']}: expected {L} attention a forward")
    module, before = base["module"], base["before"]
    trained = set(base["grads"])
    expected = {n for n in before if n.startswith("visual_projection.")
                or ".".join(n.split(".")[:3]) + "." in trained_layers}
    check(trained == expected, f"trained {sorted(trained ^ expected)[:4]}")
    for name, p in module.named_parameters():
        same = torch.equal(p.detach(), before[name])
        if name not in trained:
            check(same, f"frozen {name} moved")
        elif not name.endswith("k_proj.bias"):
            check(not same, f"trained {name} did not move")
    kbias = [n for n in trained if n.endswith("k_proj.bias")]
    names = sorted(trained - set(kbias))
    # the key bias's gradient is 0 in exact arithmetic (a softmax row does
    # not move when one term is added to all its scores): rounding-sized
    kb = max(float(base["grads"][n].norm()) / float(
        base["grads"][n.replace("k_proj", "q_proj")].norm()) for n in kbias)
    check(kb < 1e-4, f"key bias gradient {kb} of the query bias's")

    plain = _backbone_run(torch, counters, torch.float32, 1, plain=True)
    check(plain["launches"] == zero, f"plain backbone launches {plain['launches']}")
    check(math.isclose(plain["losses"][0], losses[0], rel_tol=BB_GRAD_TOL["fp32"]),
          f"plain step 1 loss {plain['losses'][0]} vs {losses[0]}")
    rel = _rel(base["grads"], plain["grads"], names)
    worst = max((_rel(base["grads"], plain["grads"], [n]), n) for n in names)
    print(f"  step 1 gradients, kernel vs plain attention: relative norm {rel:.3e} "
          f"(worst tensor {worst[1]} {worst[0]:.3e}; tolerance {BB_GRAD_TOL['fp32']:.3e}); "
          f"loss {losses[0]!r} vs {plain['losses'][0]!r}; key bias |g| / |g_q| {kb:.2e}")
    check(worst[0] <= BB_GRAD_TOL["fp32"], f"fp32 gradients {worst} off the plain version's")
    del plain

    remat = _backbone_run(torch, counters, torch.float32, BB_STEPS, remat=True)
    per_step = L + BB_K  # the forward, then the trained blocks recomputed
    check(remat["launches"] == {**zero, "attention": per_step * BB_STEPS},
          f"remat launches {remat['launches']}: expected {per_step} a step")
    check(remat["losses"] == losses, f"remat losses {remat['losses']} vs {losses}")
    check(all(torch.equal(remat["grads"][n], base["grads"][n]) for n in trained),
          "remat step 1 gradients differ from the run without remat")
    after = dict(module.named_parameters())
    check(all(torch.equal(p.detach(), after[n].detach())
              for n, p in remat["module"].named_parameters()),
          "remat parameters after the steps differ")
    print(f"  remat: gradients and parameters bit-equal, launches "
          f"{remat['launches']['attention']} ({per_step} a step), ms a step "
          f"{[round(x, 3) for x in remat['ms']]}; the steps add {remat['peak_mib']:.1f} "
          f"MiB at their peak, without remat {base['peak_mib']:.1f} "
          f"(torch.cuda.max_memory_allocated {remat['max_allocated_mib']:.1f} / "
          f"{base['max_allocated_mib']:.1f} MiB, other runs' tensors included)")
    base_peak = base["peak_mib"]
    del base, remat, module, before, after

    bf16 = _backbone_run(torch, counters, torch.bfloat16, 1)
    bf16_plain = _backbone_run(torch, counters, torch.bfloat16, 1, plain=True)
    check(bf16["launches"] == {**zero, "attention": L}, f"bf16 launches {bf16['launches']}")
    finite = all(bool(torch.isfinite(g).all()) for g in bf16["grads"].values())
    check(finite and math.isfinite(bf16["losses"][0]), "bf16 gradients not finite")
    rel16 = _rel(bf16["grads"], bf16_plain["grads"], names)
    worst16 = max((_rel(bf16["grads"], bf16_plain["grads"], [n]), n) for n in names)
    print(f"  bf16 step: loss {bf16['losses'][0]!r} (plain {bf16_plain['losses'][0]!r}), "
          f"gradients vs plain attention: relative norm {rel16:.3e} (worst {worst16[1]} "
          f"{worst16[0]:.3e}; tolerance {BB_GRAD_TOL['bf16']:.3e}); ms {bf16['ms'][0]:.3f}, "
          f"the step adds {bf16['peak_mib']:.1f} MiB; card {DEVICE['card']}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    check(worst16[0] <= BB_GRAD_TOL["bf16"], f"bf16 gradients {worst16} off the plain "
                                             f"version's")
    return dict(launches_forward=L, launches_remat_step=per_step, grad_rel=rel,
                grad_rel_bf16=rel16, peak_mib=base_peak)


def phase_probes_vs_plain(torch, attention, av) -> None:
    """Each probe kernel vs its plain version at the probes' shape and a
    ragged one, bf16 and fp32, and v2 and v3 in bf16 at T=1024 (Dh 64 and
    80, where the rounding of q * scale is real), each with the body its
    launch took (bf16 the tensor-core body, fp32 a CUDA-core one); v4's
    scores are bf16 in both dtypes: the bf16 tolerance for the max; the
    kernels of av.MEAN_TOL also within its mean (v4's, which #1's
    function, v4 without its rounding, must exceed); the group kernels
    (v5, v6) also equal to #1 in the same dtype bit for bit."""
    shapes = {"probe": (80, 257, 16, 64), "ragged": (BATCH, 50, 12, 64),
              "t1024": (4, 1024, 16, 64), "t1024 dh80": (4, 1024, 16, 80)}
    print("attention-schedule probe kernels (csrc/attention_variants.cu) vs plain:")
    for label, (B, T, H, Dh) in shapes.items():
        long = label.startswith("t1024")
        for dname in ("bf16",) if long else ("bf16", "fp32"):
            dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dname]
            gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
            q, k, v = (torch.randn(B, T, H * Dh, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            base = None if long else attention.fused_attention(q, k, v, H)
            for name, (fn, plain) in av.KERNELS.items():
                if long and name not in ("attention_v2", "attention_v3"):
                    continue
                out, ref = fn(q, k, v, H), plain(q, k, v, H)
                torch.cuda.synchronize()
                res = av.block_resources(name, B, T, H, Dh, dtype)
                check(res["body"] == ("mma" if dname == "bf16" else "simt"),
                      f"{name} {dname} took the {res['body']} body")
                print(f"  {name} {label} T={T} H={H} {dname}: body {res['body']} "
                      f"({res['smem_bytes']} B, {res['registers']} registers, "
                      f"{res['blocks_per_sm']} blocks/SM)")
                if av.VARIANTS[name] == av.GROUP:
                    same = torch.equal(out, base)
                    print(f"  {name} {label} {dname}: equal to #1 bit for bit: {same}")
                    check(same, f"{name} {label} {dname} differs from #1")
                tol = KERNEL_TOL["bf16" if name in av.BF16_SCORES else dname]
                err = (out.float() - ref.float()).abs()
                worst = float((err / (tol + tol * ref.float().abs())).max())
                where = f"{name} {label} B={B} T={T} H={H} Dh={Dh} {dname}"
                print(f"  {where}: max_abs_err={float(err.max()):.3e} (tol {tol:.3e} "
                      f"abs + rel, worst/bound={worst:.3f}) mean_abs_err="
                      f"{float(err.mean()):.3e}")
                check(worst <= 1.0, f"{where} disagrees with plain")
                if name not in av.MEAN_TOL:
                    continue
                mean_tol = av.MEAN_TOL[name]
                check(float(err.mean()) <= mean_tol, f"{where} strays from plain "
                      f"(mean tol {mean_tol:.0e})")
                if name not in av.BF16_SCORES:
                    continue
                # the same function without its rounding: #1's
                unrounded = (attention.fused_attention_reference(q, k, v, H).float()
                             - ref.float()).abs()
                print(f"  {where}: mean |d| kernel {float(err.mean()):.3e}, #1's "
                      f"function (no score rounding) {float(unrounded.mean()):.3e} "
                      f"max {float(unrounded.max()):.3e}; mean tol {mean_tol:.0e}")
                check(float(unrounded.mean()) > mean_tol,
                      f"{where}: the mean tolerance does not pin the score rounding")


def phase_packed_heads_vs_plain(torch, ph) -> dict:
    """qk and pv, per head and packed, vs plain: qk at 1e-4; pv within one
    bf16 ulp (ph.PV_TOL) and a mean |d| limit (ph.PV_MEAN_RTOL of the
    mean |plain|), which a single bf16 rounding of p must exceed. Prints
    each kernel's resources and, at the probe's shape, its CUDA-event time
    beside its device time a call by torch.profiler (the difference is the
    host's share of back-to-back calls); returns those device times."""
    print("packed-head probe kernels (csrc/packed_heads.cu) vs plain:")
    for name in ph.KERNELS:
        r = ph.kernel_resources(name)
        print(f"  {name} resources: {r['threads']} threads of {r['registers']} registers, "
              f"{r['smem_bytes']} B shared memory, {r['blocks_per_sm']} blocks/SM, "
              f"{r['local_bytes']} B local")
    parts = {}
    for label, (B, T, H) in PACKED_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
        q, k, v = (torch.randn(B, T, H * 64, generator=gen, device="cuda").bfloat16()
                   for _ in range(3))
        p = torch.randn(B, H, T, T, generator=gen, device="cuda")
        operands = {"qk_scores": (q, k), "qk_scores_packed": (q, k), "pv": (p, v),
                    "pv_packed": (ph.pack_pairs(p).contiguous(), v)}
        for name, (fn, plain, _, _) in ph.KERNELS.items():
            x, y = operands[name]
            out, ref = fn(x, y, H), plain(x, y, H)
            torch.cuda.synchronize()
            where = f"{name} {label} B={B} T={T} H={H}"
            if name.startswith("qk"):
                err = (out - ref).abs()
                worst = float((err / (1e-4 + 1e-4 * ref.abs())).max())
                print(f"  {where}: max_abs_err={float(err.max()):.3e} (rtol = atol = "
                      f"1e-4, worst/bound={worst:.3f})")
                check(worst <= 1.0, f"{where} disagrees with plain")
                continue
            r = ph.pv_check(out, ref)
            # the same product from p rounded once to bf16
            rounded = plain(x.to(torch.bfloat16).float(), y, H)
            mean_rounded = float((rounded.float() - ref.float()).abs().mean())
            print(f"  {where}: max_abs_err={r['max_abs_err']:.3e} (tol {ph.PV_TOL:.3e} abs "
                  f"+ rel, worst/bound={r['worst']:.3f}); mean |d| kernel "
                  f"{r['mean_abs_err']:.3e}, one bf16 rounding of p {mean_rounded:.3e}; "
                  f"mean tol {r['mean_tol']:.3e}")
            check(mean_rounded > r["mean_tol"],
                  f"{where}: the mean tolerance does not pin the fp32 products")
        plans = {packed: ph.qk_plan(T, packed) for packed in (False, True)}
        print(f"  qk staging at T={T}: per head {plans[False]}, packed {plans[True]}")
        if label != "probe":
            continue
        for name, (fn, _, _, _) in ph.KERNELS.items():
            x, y = operands[name]
            ms = cuda_ms(torch, lambda: fn(x, y, H))
            parts[name] = _launch_parts(torch, lambda: fn(x, y, H), PACKED_PARTS, calls=20)
            _print_parts(f"{name} {label} (CUDA events {ms:.4f} ms a call back to back)",
                         parts[name])
    return parts


# the launches inside one s4-kind GEMM call (csrc/tile_gemm.cu)
GEMM_S4_PARTS = (("prepass (unpack_s4_kernel)", r"unpack_s4_kernel"),
                 ("s8 GEMM (wgmma_gemm_kernel)", r"wgmma_gemm_kernel"))


def phase_gemm_vs_plain(torch, tg) -> dict:
    """The GEMM kinds vs plain, bf16 and s8 at every tile of the sweep, s4
    x s4 and s8 x s4 at tile 0 after their prepass (which is held alone to
    the plain unpacking, `unpack_s4`, bit for bit): s8, s4 x s4 and s8 x s4
    exact, bf16 within tg.BF16_TOL of max |ref|. Returns each s4 kind's
    launches at the probes' shape timed apart by torch.profiler."""
    print("GEMM probe kernels (csrc/tile_gemm.cu) vs plain:")
    parts = {}
    for label, (Mr, Kr, Nr) in GEMM_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(SEED + 14)

        def ints(lo, hi, *shape):
            return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                                 dtype=torch.int8)

        a8, b8 = ints(-127, 127, Mr, Kr), ints(-127, 127, Kr, Nr)
        a4, b4 = ints(-8, 8, Mr, Kr), ints(-8, 8, Kr, Nr)
        a16 = torch.randn(Mr, Kr, generator=gen, device="cuda").bfloat16()
        b16 = torch.randn(Kr, Nr, generator=gen, device="cuda").bfloat16()
        ref8, ref16 = tg.matmul_reference(a8, b8), tg.matmul_reference(a16, b16)
        where = f"{label} M={Mr} K={Kr} N={Nr}"
        for tile in tg.TILES:
            tg.check_exact(f"s8 {where} tile {tile}", tg.matmul(a8, b8, tile), ref8)
            r = tg.check_bf16(f"bf16 {where} tile {tile}", tg.matmul(a16, b16, tile),
                              ref16)
            print(f"  s8 and bf16 {where} tile {tile}: s8 exact, bf16 max_abs_err="
                  f"{r['max_abs_err']:.3e} (tol {tg.BF16_TOL} x {r['max_abs_ref']:.3e})")
        a4p, b4p = tg.pack_s4(a4, 1), tg.pack_s4(b4, 0)
        a_un, bt = tg.unpack_prepass(a4p, b4p)
        check(torch.equal(a_un, a4) and torch.equal(bt, b4.t()),
              f"the s4 prepass {where} differs from the plain unpacking")
        check(torch.equal(tg.unpack_prepass(None, b4p)[1], bt),
              f"the s4 prepass {where} without A differs")
        tg.check_exact(f"s4 x s4 {where}", tg.matmul_s4(a4p, b4p),
                       tg.matmul_reference(a4, b4))
        tg.check_exact(f"s8 x s4 {where}", tg.matmul_s4(a8, b4p),
                       tg.matmul_reference(a8, b4))
        print(f"  s4 x s4 and s8 x s4 {where}: prepass equal to the plain unpacking, "
              f"products exact ({tg.MMA[tg.S4]}; {tg.MMA[tg.S8S4]})")
        if label == "probe":
            for name, a in (("tile_gemm_s4", a4p), ("tile_gemm_s8s4", a8)):
                parts[name] = _launch_parts(torch, lambda a=a: tg.matmul_s4(a, b4p),
                                            GEMM_S4_PARTS, calls=20)
                _print_parts(f"{name} {where}", parts[name])
    return parts


def phase_probes(torch, counters) -> dict:
    """The probes' entry point: each probe's main logic (its module's run
    at the scripts' shape, then its report), every count set to 0 just
    before and read just after."""
    import importlib

    for c in counters.values():
        c.launches = 0
    results = {}
    for name in PROBES:
        mod = importlib.import_module(f"bayesvlm_tpu_torch.probes.{name}")
        print(f"probe {name}:")
        results[name] = mod.run(mod.parse_args([]))
        mod.report(results[name])
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    print(f"probes path launches={launches}")
    # probe_packed_heads times #1 and #3 as its yardsticks
    ran = ("attention", "attention_split", "attention_packed", *PROBE_KERNELS)
    check(all(launches[n] > 0 for n in ran), f"a probe kernel did not run: {launches}")
    check(all(launches[n] == 0 for n in launches if n not in ran),
          f"the probes launched another kernel: {launches}")
    return {"launches": launches, "results": results}


# 12: distribution (dist/), run last in child processes: (a) NCCL at world
# size 1, (b) two gloo ranks on cuda:0 (NCCL takes one rank a card)


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _counted(counters) -> dict:
    return {n: c.launches for n, c in counters.items()}


def _dist_counters():
    from bayesvlm_tpu_torch.models import attention
    from bayesvlm_tpu_torch.select import epig_joint

    return {"attention": attention.fused_attention,
            "xlogy_rowsum": epig_joint.joint_xlogy_rowsums}


def _rel_err(torch, got, ref) -> float:
    return float((got.double() - ref.double()).abs().max() / ref.double().abs().max())


def _dist_nccl(torch, spec: dict) -> dict:
    """(a): the NCCL backend at world size 1 through initialize_distributed's
    tcp:// rendezvous: kfac_ggn(mesh=world) and the sharded GGN (its
    all_reduce over NCCL) at the Stage-1 phase's shapes against one
    device's kfac_ggn; epig_from_probs_sharded (its all_gather) at
    EPIG_POOL x EPIG_TARG against the dense scores."""
    import torch.distributed as dist

    from bayesvlm_tpu_torch.bayes import estimation
    from bayesvlm_tpu_torch.dist import hessian_allreduce as sharded
    from bayesvlm_tpu_torch.dist.init import initialize_distributed
    from bayesvlm_tpu_torch.select import epig as epig_mod

    out, steps = {}, {}
    clock = [time.perf_counter()]

    def step(name):
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - clock[0]
        clock[0] = time.perf_counter()

    ctx = initialize_distributed(coordinator_address=f"127.0.0.1:{spec['port']}",
                                 num_processes=1, process_id=0, device="cuda")
    try:
        out["backend"] = dist.get_backend()
        out["world"] = ctx.num_hosts
        step("init")
        gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
        N, D, P = S1_PAIRS, 768, 1024  # clip-large: embeddings, activations
        src, tgt = (torch.randn(N, D, generator=gen, device="cuda") for _ in range(2))
        act = torch.randn(N, P, generator=gen, device="cuda")
        scale = 4.6052
        A1, B1 = estimation.kfac_ggn(scale, 0.0, N, src, act, tgt, "info_nce",
                                     block_size=S1_LA_BATCH, device="cuda")
        step("kfac_ggn one device")
        Aw, Bw = estimation.kfac_ggn(scale, 0.0, N, src, act, tgt, "info_nce",
                                     block_size=S1_LA_BATCH, mesh=ctx.mesh,
                                     device="cuda")
        step("kfac_ggn(mesh=world)")
        root = math.sqrt(N)
        Bs = sharded.sharded_hessian_infonce(src, tgt, scale, ctx.mesh,
                                             block_size=S1_LA_BATCH) / root
        As = sharded.sharded_activation_gram(act, ctx.mesh) / root
        step("sharded GGN (NCCL all_reduce)")
        out["ggn"] = {"A_world": _rel_err(torch, Aw, A1), "B_world": _rel_err(torch, Bw, B1),
                      "A_sharded": _rel_err(torch, As, A1),
                      "B_sharded": _rel_err(torch, Bs, B1)}
        del src, tgt, act
        gen.manual_seed(SEED + 21)
        pool = torch.softmax(torch.randn(EPIG_POOL, EPIG_K, EPIG_C, generator=gen,
                                         device="cuda"), -1)
        targ = torch.softmax(torch.randn(EPIG_TARG, EPIG_K, EPIG_C, generator=gen,
                                         device="cuda"), -1)
        counters = _dist_counters()
        for c in counters.values():
            c.launches = 0
        dense = epig_mod.epig_from_probs_using_matmul(pool, targ)
        step("EPIG dense")
        launches_dense = _counted(counters)
        sharded_scores = epig_mod.epig_from_probs_sharded(pool, targ, ctx.mesh)
        step("EPIG sharded (NCCL all_gather)")
        out["epig"] = {"bit_equal": bool(torch.equal(sharded_scores, dense)),
                       "max_abs_diff": float((sharded_scores - dense).abs().max()),
                       "max_abs_score": float(dense.abs().max()),
                       "launches_dense": launches_dense,
                       "launches": {n: _counted(counters)[n] - launches_dense[n]
                                    for n in counters}}
    finally:
        dist.destroy_process_group()
    out["steps"] = steps
    return out


def _record_writes() -> list:
    """The factor and prior-precision writes of this process, in order."""
    from bayesvlm_tpu_torch.io import artifacts

    writes = []
    for name in ("save_hessians", "save_prior_precision"):
        fn = getattr(artifacts, name)
        setattr(artifacts, name, lambda *a, _fn=fn, _n=name, **k: (writes.append(_n),
                                                                   _fn(*a, **k))[1])
    return writes


def _dist_stage1(torch, ctx, spec: dict, counters, step) -> dict:
    """(b) Stage 1: this rank's stripe of DIST_S1_PAIRS synthetic pairs
    encoded on the card into its per-host caches (#1 counted), then the
    Stage-1 CLI in both modes on LAION-style tar names (one tar a rank; the
    caches make the CLI skip its feature pass, as its file-gated resume
    does), then (rank 0) the factors against a replay on the card: kfac_ggn
    on each rank's shard and the allreduce_factors arithmetic in float64,
    or kfac_ggn on the gathered rows."""
    import contextlib
    import io
    import shutil

    import torch.distributed as dist

    from bayesvlm_tpu_torch import hessian_estimation
    from bayesvlm_tpu_torch.bayes.estimation import kfac_ggn
    from bayesvlm_tpu_torch.bayes.hessians import _hessian_infonce
    from bayesvlm_tpu_torch.data.factory import DataModuleFactory
    from bayesvlm_tpu_torch.data.tokenizer import make_tokenizer
    from bayesvlm_tpu_torch.data.transforms import get_transform
    from bayesvlm_tpu_torch.inference.precompute import compute_features
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME
    from bayesvlm_tpu_torch.models.encoders import load_model
    from bayesvlm_tpu_torch.train.al_common import _stripe_batches
    from bayesvlm_tpu_torch.utils import get_image_size

    r, H = ctx.host_id, ctx.num_hosts
    out = {}
    config = CONFIGS_BY_NAME[S1_MODEL]
    img_enc, txt_enc, head = load_model(S1_MODEL, dtype=torch.bfloat16, device=ctx.device)
    txt_enc.tokenizer = make_tokenizer(config.text, None)
    transform = get_transform(config.family, get_image_size(S1_MODEL))
    dm = DataModuleFactory(batch_size=S1_BATCH, num_workers=8, shuffle_train=False,
                           train_transform=transform, test_transform=transform).create(
        "synthetic", image_size=S1_IMAGE_SIZE, num_test=DIST_S1_PAIRS,
        num_classes=DIST_S1_PAIRS)
    dm.setup()
    feats = Path(spec["work"]) / "features"
    for c in counters.values():
        c.launches = 0
    for tag, enc, modality in (("img", img_enc, "image"), ("txt", txt_enc, "text")):
        compute_features(enc, _stripe_batches(dm.test_dataloader(), r, H, []),
                         tag=f"{tag}_host{r}", cache_dir=feats, modality=modality)
    out["feature_launches"] = _counted(counters)
    del img_enc, txt_enc
    step("stage1 feature pass (this rank's stripe)")
    writes = _record_writes()
    modes = {"per_host": False, "global_batch": True}
    for mode, global_batch in modes.items():
        hdir = Path(spec["work"]) / f"stage1_{mode}"
        hdir.mkdir(parents=True, exist_ok=True)
        for name in ("activations", "embeddings"):
            for tag in ("img", "txt"):
                shutil.copy(feats / f"{name}_{tag}_host{r}.pt", hdir)
        for c in counters.values():
            c.launches = 0
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            run = hessian_estimation.main(
                dataset="laion400m", model_str=S1_MODEL, precompute_batch_size=S1_BATCH,
                la_num_classes=DIST_S1_CLASSES, la_batch_size=S1_LA_BATCH,
                num_workers=0, hessian_dir=str(hdir), num_steps=DIST_S1_LAMBDA_STEPS,
                device="cuda", dist_global_batch=global_batch)
        out[mode] = {"launches": _counted(counters), "printed": printed.getvalue(),
                     "lambdas": [run["lambda_img"], run["lambda_txt"]],
                     "seconds": run["seconds"]}
        step(f"stage1 CLI {mode}")
    out["writes"] = writes
    dist.barrier()
    if r == 0:
        load = lambda p: torch.load(p, map_location=ctx.device, weights_only=True)
        scale = torch.as_tensor(head.logit_scale, device=ctx.device)
        C = DIST_S1_CLASSES

        def factors64(emb, act, tgt):
            """kfac_ggn's sums in float64 (the GGN's formula in the
            operands' dtype), divided by sqrt(n)."""
            n = (len(emb) // C) * C
            A = sum(act[i:i + C].double().T @ act[i:i + C].double()
                    for i in range(0, n, C))
            B = sum(_hessian_infonce(emb[i:i + C].double(), tgt[i:i + C].double(),
                                     scale.double(), S1_LA_BATCH) for i in range(0, n, C))
            return A / math.sqrt(n), B / math.sqrt(n), n

        for mode, global_batch in modes.items():
            hdir = Path(spec["work"]) / f"stage1_{mode}"
            errs = {}
            for tag, other in (("img", "txt"), ("txt", "img")):
                shards = [[load(hdir / f"{n}_host{h}.pt") for n in (
                    f"embeddings_{tag}", f"activations_{tag}", f"embeddings_{other}")]
                    for h in range(H)]
                if global_batch:
                    shards = [[torch.cat(x) for x in zip(*shards)]]
                # one device's fp32 kfac_ggn on each shard and float64,
                # combined by the allreduce_factors arithmetic in float64
                parts32, parts64 = [], []
                for emb, act, tgt in shards:
                    A_h, B_h = kfac_ggn(head.logit_scale, head.logit_bias, C, emb, act,
                                        tgt, "info_nce", block_size=S1_LA_BATCH,
                                        device=ctx.device)
                    A64, B64, n = factors64(emb, act, tgt)
                    parts32.append((A_h.double() * math.sqrt(n), B_h.double() * math.sqrt(n)))
                    parts64.append((A64 * math.sqrt(n), B64 * math.sqrt(n)))
                root = math.sqrt(sum((len(e) // C) * C for e, _, _ in shards))
                for i, name in enumerate("AB"):
                    got = load(hdir / f"{name}_{tag}_analytic.pt")
                    ref32 = sum(p[i] for p in parts32) / root
                    ref64 = sum(p[i] for p in parts64) / root
                    errs[f"{name}_{tag}"] = {"vs_fp32_replay": _rel_err(torch, got, ref32),
                                             "vs_float64": _rel_err(torch, got, ref64),
                                             "fp32_replay_vs_float64":
                                                 _rel_err(torch, ref32, ref64)}
            out[mode]["replay_rel_err"] = errs
        step("stage1 replay (rank 0)")
    del head
    torch.cuda.empty_cache()
    return out


def _dist_epig(torch, ctx, spec: dict, counters, step) -> dict:
    """(b) select_epig_online over the explicit world mesh (#8 counted on
    this rank) and with mesh=None, at the EPIG path's sizes on seeded
    clip-large-wide features and the synthetic factors."""
    from bayesvlm_tpu_torch.io.artifacts import load_hessians, load_info
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME
    from bayesvlm_tpu_torch.probforward.smith import ProbabilisticHead
    from bayesvlm_tpu_torch.select.epig import select_epig_online
    from bayesvlm_tpu_torch.types import EncoderResult

    config = CONFIGS_BY_NAME[MODEL]
    P, Pt, D = config.vision.hidden_size, config.text.hidden_size, config.vision.projection_dim
    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    kernel = torch.randn(P, D, generator=gen, device=dev) / math.sqrt(P)
    kernel_txt = torch.randn(Pt, D, generator=gen, device=dev) / math.sqrt(Pt)

    def features(n, w, p):
        act = torch.randn(n, p, generator=gen, device=dev)
        return EncoderResult.create(act @ w, act)

    pool, targ = features(EPIG_POOL_IMAGES, kernel, P), features(EPIG_TARGET_IMAGES, kernel, P)
    labels = features(EPIG_CLASSES, kernel_txt, Pt)
    A_img, B_img = load_hessians(spec["hessian_dir"], "img")
    A_txt, B_txt = load_hessians(spec["hessian_dir"], "txt")
    info = load_info(spec["hessian_dir"])
    class_ids = np.random.default_rng(SEED + 7).integers(0, EPIG_CLASSES,
                                                          size=EPIG_POOL_IMAGES)
    kw = dict(label_features=labels, pool_features=pool, target_features=targ,
              pool_class_ids=class_ids, projection_kernel=kernel, projection_bias=None,
              head=ProbabilisticHead.create(4.6052, 0.0, device=dev), A_img=A_img,
              A_txt=A_txt, B_img=B_img, B_txt=B_txt,
              cov_info={k: info[k] for k in ("lambda_img", "lambda_txt", "n_img", "n_txt")},
              budget=EPIG_BUDGET, lr=1e-4, hessian_update_scale=10.0, num_samples=EPIG_K,
              seed=0, projection_l2=float((kernel**2).sum()),
              projection_num_params=kernel.numel(), chunk_size=EPIG_CHUNK,
              pool_subsampling="knn_wasserstein", k_nearest_neighbors=1, device=dev)
    for c in counters.values():
        c.launches = 0
    sharded = select_epig_online(**kw, mesh=ctx.mesh)
    launches = _counted(counters)
    step("select_epig_online over the world mesh")
    dense = select_epig_online(**kw, mesh=None)
    step("select_epig_online on one device")
    return {"sharded": sharded, "dense": dense, "launches": launches}


def _dist_al(torch, ctx, spec: dict, counters, step) -> dict:
    """(b) the activelearning CLI as one of two ranks, in phase 8d's
    configuration (8d's main run is its reference)."""
    from bayesvlm_tpu_torch import activelearning
    from bayesvlm_tpu_torch.utils import get_image_size

    overrides = dict(AL_SPLITS, image_size=get_image_size(MODEL))
    for c in counters.values():
        c.launches = 0
    run = activelearning.run(
        model_str=MODEL, dataset="synthetic", hessian_dir=spec["hessian_dir"],
        experiment_dir=spec["al_dir"], project_name="active-finetuning",
        hessian_scale=10.0, subset_size=AL_SUBSET, finetune_epochs=AL_EPOCHS,
        precompute_batch_size=AL_PRECOMPUTE_BATCH, device="cuda",
        dataset_overrides=overrides)
    launches = _counted(counters)
    step("activelearning CLI")
    return {"launches": launches, "seconds": run["seconds"],
            "subsets": json.loads(json.dumps(run["subsets"])),
            "results": json.loads(json.dumps(run["results"]))}


def _dist_gloo(torch, spec: dict) -> dict:
    """(b): one of two gloo ranks on cuda:0, joined through the
    environment as a launch names them (COORDINATOR_ADDRESS, NUM_PROCESSES,
    PROCESS_ID), then Stage 1, select_epig_online and the activelearning
    CLI."""
    import torch.distributed as dist

    from bayesvlm_tpu_torch.dist.init import initialize_distributed

    steps = {}
    clock = [time.perf_counter()]

    def step(name):
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - clock[0]
        clock[0] = time.perf_counter()

    os.environ["WANDB_MODE"] = "disabled"
    ctx = initialize_distributed(backend="gloo", device="cuda")
    out = {"rank": ctx.host_id, "world": ctx.num_hosts, "device": str(ctx.device),
           "backend": dist.get_backend()}
    counters = _dist_counters()
    try:
        step("init")
        out["stage1"] = _dist_stage1(torch, ctx, spec, counters, step)
        out["epig"] = _dist_epig(torch, ctx, spec, counters, step)
        out["al"] = _dist_al(torch, ctx, spec, counters, step)
    finally:
        dist.destroy_process_group()
    out["steps"] = steps
    return out


def dist_worker(role: str, spec_path: str) -> int:
    """A child of phase 12 ("nccl" or "gloo") or of phase 13 ("tp"): runs
    `role` and writes its outcome as JSON to the spec's `out`."""
    import torch

    torch.backends.cudnn.allow_tf32 = False  # as phase 1 sets it in the parent
    spec = json.loads(Path(spec_path).read_text())
    out = {"nccl": _dist_nccl, "gloo": _dist_gloo, "tp": _tp_worker}[role](torch, spec)
    Path(spec["out"]).write_text(json.dumps(out))
    return 0


def _run_children(cmds, envs, logs, timeout: float) -> None:
    """Start the children together, wait for all (killing them all past
    `timeout`) and fail with each failing child's log tail."""
    procs = []
    for cmd, env, log in zip(cmds, envs, logs):
        with open(log, "w") as fh:
            procs.append(subprocess.Popen(cmd, env=env, stdout=fh,
                                          stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            tail = Path(log).read_text()[-4000:]
            raise RuntimeError(f"check failed: dist child {log} exit {p.returncode}:\n{tail}")


def phase_dist(torch, al_main: dict) -> dict:
    """Phase 12: distribution in child processes (module docstring)."""
    import tarfile

    from bayesvlm_tpu_torch.io.artifacts import save_synthetic_hessians
    from bayesvlm_tpu_torch.kernels import BUILD_DIR
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the children allocate on the same card
    script = str(Path(__file__).resolve())
    env = dict(os.environ)
    # NCCL bootstraps over the loopback interface: one host, no network
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    out = {}
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        work = Path(work)
        # (a) NCCL, world size 1
        spec = {"port": _free_port(), "out": str(work / "nccl.json")}
        (work / "nccl_spec.json").write_text(json.dumps(spec))
        t0 = time.perf_counter()
        _run_children([[sys.executable, script, "--dist-worker", "nccl",
                        str(work / "nccl_spec.json")]], [env], [str(work / "nccl.log")],
                      DIST_TIMEOUT_S)
        a = json.loads((work / "nccl.json").read_text())
        a_wall = time.perf_counter() - t0
        print(f"dist (a): backend {a['backend']}, world {a['world']}, {S1_MODEL} widths, "
              f"{S1_PAIRS} pairs in one class batch: max |F - F_one_device| / max "
              f"|F_one_device| {a['ggn']} (tol {DIST_FACTOR_TOL}); EPIG {EPIG_POOL} x "
              f"{EPIG_TARG} (C={EPIG_C}, K={EPIG_K}) sharded vs dense: bit_equal="
              f"{a['epig']['bit_equal']} max |d|={a['epig']['max_abs_diff']!r} "
              f"launches {a['epig']['launches']}; child wall {a_wall:.1f} s")
        for name, sec in a["steps"].items():
            print(f"  dist (a) step {name}: {sec:.3f} s")
        check(a["backend"] == "nccl" and a["world"] == 1, f"(a) ran {a['backend']}")
        for name, err in a["ggn"].items():
            check(err <= DIST_FACTOR_TOL, f"(a) {name} strays ({err:.3e})")
        # a score differs from the dense one only through its C row sums,
        # the kernel's at another M (summation order); held to the
        # kernel's ROWSUM_RTOL of the largest score
        check(a["epig"]["max_abs_diff"] <= ROWSUM_RTOL * a["epig"]["max_abs_score"],
              f"(a) sharded EPIG strays ({a['epig']['max_abs_diff']!r})")
        check(a["epig"]["launches"] == {"attention": 0, "xlogy_rowsum": 1},
              f"(a) sharded EPIG launches {a['epig']['launches']}")
        out["a"] = a

        # (b) two gloo ranks on cuda:0
        hdir = save_synthetic_hessians(work / "hessians", CONFIGS_BY_NAME[MODEL], SEED)
        laion = work / "data" / "laion400m"
        laion.mkdir(parents=True)
        for i in range(2):  # tar names for shard_for_host; the caches are hits
            tarfile.open(laion / f"{i:05d}.tar", "w").close()
        port = _free_port()
        cmds, envs, logs = [], [], []
        for rank in range(2):
            spec = {"work": str(work), "hessian_dir": str(hdir),
                    "al_dir": str(work / "al"), "out": str(work / f"gloo{rank}.json")}
            (work / f"gloo{rank}_spec.json").write_text(json.dumps(spec))
            cmds.append([sys.executable, script, "--dist-worker", "gloo",
                         str(work / f"gloo{rank}_spec.json")])
            envs.append(dict(env, COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                             NUM_PROCESSES="2", PROCESS_ID=str(rank),
                             DATA_BASE_DIR=str(work / "data")))
            logs.append(str(work / f"gloo{rank}.log"))
        t0 = time.perf_counter()
        _run_children(cmds, envs, logs, DIST_TIMEOUT_S)
        b_wall = time.perf_counter() - t0
        ranks = [json.loads((work / f"gloo{r}.json").read_text()) for r in range(2)]
        out["b"] = _dist_gloo_checks(ranks, al_main, work)
        al_files = sorted(str(f.relative_to(work / "al")) for f in (work / "al").rglob("*")
                          if f.is_file())
    replica = [f for f in al_files if "_replica_host1" in Path(f).parts]
    outside = [f for f in al_files if f not in replica]
    print(f"dist (b): activelearning files outside _replica_host1 {len(outside)} "
          f"(8d's main run {len(al_main['files'])}), under it {len(replica)}; "
          f"children wall {b_wall:.1f} s")
    check(outside == al_main["files"], "(b) the two-rank run wrote other files than 8d's "
          f"main run: {sorted(set(outside) ^ set(al_main['files']))[:10]}")
    check(replica and all(Path(f).name == "metrics.jsonl" for f in replica),
          f"(b) rank 1 wrote {replica[:5]} under _replica_host1")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"dist phase: {out['wall_s']:.1f} s (a {a_wall:.1f} s, b {b_wall:.1f} s); "
          f"card {DEVICE['card']}")
    return out


def _dist_gloo_checks(ranks: list, al_main: dict, work: Path) -> dict:
    """(b)'s checks on the two ranks' outcomes; returns each rank's
    launches."""
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME

    L = CONFIGS_BY_NAME[S1_MODEL].vision.num_layers
    s1_batches = DIST_S1_PAIRS // S1_BATCH
    al_forwards = [sum(len(range(r, -(-AL_SPLITS[k] // AL_PRECOMPUTE_BATCH), 2))
                   for k in ("num_train", "num_val", "num_test")) for r in range(2)]
    epig_chunks = -(-min(AL_SPLITS["num_test"], AL_SPLITS["num_train"]) // EPIG_CHUNK)
    launches = {}
    for r, o in enumerate(ranks):
        check((o["rank"], o["world"], o["device"], o["backend"]) == (r, 2, "cuda:0", "gloo"),
              f"(b) rank {r}: {o['rank']}/{o['world']} on {o['device']} {o['backend']}")
        s1 = o["stage1"]
        mine = len(range(r, s1_batches, 2))
        check(s1["feature_launches"] == {"attention": L * mine, "xlogy_rowsum": 0},
              f"(b) rank {r} stage-1 feature pass launches {s1['feature_launches']}")
        for mode in ("per_host", "global_batch"):
            check(s1[mode]["launches"] == {"attention": 0, "xlogy_rowsum": 0},
                  f"(b) rank {r} stage-1 CLI {mode} launches {s1[mode]['launches']}")
            check(f"[dist] host {r}/2 takes 1 tar shards" in s1[mode]["printed"],
                  f"(b) rank {r} {mode}: no tar-shard line")
            last = s1[mode]["printed"].strip().splitlines()[-1]
            check(last.startswith('{"lambda_img"') == (r == 0),
                  f"(b) rank {r} {mode}: last line {last!r}")
            check(s1[mode]["lambdas"] == ranks[0]["stage1"][mode]["lambdas"],
                  f"(b) {mode}: the ranks' lambdas differ")
        check(s1["writes"] == ([] if r else ["save_hessians", "save_hessians",
                                             "save_prior_precision"] * 2),
              f"(b) rank {r} wrote {s1['writes']}")
        ep = o["epig"]
        check(ep["sharded"] == ep["dense"],
              f"(b) rank {r}: sharded EPIG selected {ep['sharded']}, one device {ep['dense']}")
        check(ep["launches"] == {"attention": 0, "xlogy_rowsum": EPIG_BUDGET},
              f"(b) rank {r} select_epig_online launches {ep['launches']}")
        al = o["al"]
        want = {"attention": L * al_forwards[r], "xlogy_rowsum": AL_SUBSET * epig_chunks}
        check(al["launches"] == want, f"(b) rank {r} AL launches {al['launches']} != {want}")
        launches[r] = {"smoke_feature_pass": s1["feature_launches"]["attention"],
                       "al_attention": al["launches"]["attention"],
                       "epig_xlogy": ep["launches"]["xlogy_rowsum"],
                       "al_xlogy": al["launches"]["xlogy_rowsum"]}
    s1 = ranks[0]["stage1"]
    for mode in ("per_host", "global_batch"):
        errs = s1[mode]["replay_rel_err"]
        print(f"dist (b) stage-1 {mode}: max |F - F_replay| / max |F_replay| {errs} "
              f"(tol {DIST_FACTOR_TOL}); lambdas {s1[mode]['lambdas']}")
        for name, e in errs.items():
            if mode == "per_host":
                # each rank's kfac_ggn is the replay's own call on the same
                # shard: only the factor combination differs
                check(e["vs_fp32_replay"] <= DIST_FACTOR_TOL,
                      f"(b) stage-1 {mode} {name} strays ({e})")
            else:
                # the class batches' sums over the ranks come in another
                # order than one device's: B at CLIP's scale is a
                # difference of far larger terms, so the reassociation
                # shows as fp32's own error does; held to float64 at
                # 4x one device's fp32 error (or the tolerance)
                bound = max(DIST_FACTOR_TOL, 4 * e["fp32_replay_vs_float64"])
                check(e["vs_float64"] <= bound, f"(b) stage-1 {mode} {name} strays ({e})")
    check("[dist] global class batches over 2048 gathered pairs"
          in s1["global_batch"]["printed"], "(b) no global-batch line")
    ep = ranks[0]["epig"]
    print(f"dist (b) select_epig_online: sharded {ep['sharded']}, one device "
          f"{ep['dense']}")
    al0, al1 = ranks[0]["al"], ranks[1]["al"]
    check(al0["subsets"] == al1["subsets"] and al0["results"] == al1["results"],
          "(b) the AL ranks differ")
    subsets_equal = al0["subsets"] == al_main["subsets"]
    for name, by_test in al_main["subsets"].items():
        got = al0["subsets"].get(name, {})
        check(list(got) == list(by_test), f"(b) AL {name}: other test keys")
        for key, entry in by_test.items():
            check(got[key]["indices"] == entry["indices"],
                  f"(b) AL {name}[{key}]: indices differ from 8d's")
            # a rank computes its train columns' similarities in a GEMM of
            # another width than one device's, rounded otherwise: -wdist2
            # is a difference of squared norms of its own size
            np.testing.assert_allclose(got[key]["similarities"], entry["similarities"],
                                       rtol=DIST_SIM_RTOL, atol=0,
                                       err_msg=f"(b) AL {name}")
    check(al0["results"] == al_main["results"],
          f"(b) AL test metrics differ from 8d's: {al0['results']} vs {al_main['results']}")
    print(f"dist (b) activelearning: {len(al0['subsets'])} strategies, indices equal to "
          f"8d's, subsets JSON bit-equal {subsets_equal}, test metrics equal; launches "
          f"per rank {launches}")
    for r, o in enumerate(ranks):
        for name, sec in o["steps"].items():
            print(f"  dist (b) rank {r} step {name}: {sec:.3f} s")
    return {"launches": launches}


# 13: the serving mesh, tensor parallelism, the DCP lane, profiling and
# the preflight (the last modules of the port), in one phase
PAR_MESH = ("cuda:0", "cuda:0")  # two replicas on the one card
PAR_LADDER = [2, BATCH]
PAR_PRIOR_STEPS = SNAPSHOT_PRIOR_STEPS
PAR_TIMER_STEPS = 5  # StepTimer steps (its first 2 discarded)
PAR_REQUESTS = 8  # single-image requests to the BatchingServer on the mesh
PAR_THROUGHPUT_CALLS = 10
PAR_TP_BATCH = 8
PAR_TP_CALLS = 5
PAR_TP_TIMEOUT_S = 300
PAR_PREFLIGHT = dict(dataset="synthetic", batch_size=32, num_workers=2, num_test=128)
# TP vs the unsplit tower of the same bf16 weights: a split column
# product (q, k, v, fc1) sums the same terms per output as the unsplit
# one; a split row product (out_proj, fc2) rounds each rank's partial sum
# to bf16 (2^-9 relative) before the fp32 sum and the bias, one more
# rounding per sublayer than the unsplit product. That is the block
# lane's kind of error against the bf16 lane (BLOCK_EMBED_COS_MIN's
# argument: a value moved by an ulp at a few points a layer, a random
# walk over 24 layers, a cosine above 0.9999), so the embeddings and
# activations are held to the same cosine; a wrong slice, head count or
# reduction gives one far below it. The largest element error, relative
# to the tensor's largest magnitude, is bounded too: the H100 run
# (NVIDIA H100 80GB HBM3, 700.00 W) read embed / act cosines 0.999914 /
# 0.999913 and max rel 1.199e-02 / 1.948e-02 at B=8 on both ranks;
# TP_MAX_REL is 2.5x the larger, and a wrong slice moves it by O(1).
TP_COS_MIN = BLOCK_EMBED_COS_MIN
TP_MAX_REL = 0.05


def _mesh_lane(torch, counters, vlm, u8, label: str, per_forward: dict,
               **vision) -> dict:
    """A kernel lane of the bf16 VLM's weights on the serving mesh: the
    eager sharded predict (each replica's launches), its B=BATCH graphs
    (launches at capture, one a replica) and the replay equal to it bit
    for bit; each replica's int8 cache on its own device and storage."""
    from bayesvlm_tpu_torch.models.encoders import rebuild_image_encoder
    from bayesvlm_tpu_torch.pipeline import ProbabilisticVLM

    enc = rebuild_image_encoder(vlm.image_encoder, **vision)
    lane = ProbabilisticVLM(enc, vlm.text_encoder, vlm.head, vlm.info, mesh=PAR_MESH)
    lane._label_features = vlm._label_features
    reps = lane._replicas()
    caches = [[t for n, t in r.encoder.module.named_buffers() if n.endswith("w1q")]
              for r in reps]
    check(all(t.device == reps[0].device for c in caches for t in c)
          and not {t.data_ptr() for t in caches[0]} & {t.data_ptr() for t in caches[1]},
          f"{label}: the replicas' int8 caches must be their own, on their device")
    for c in counters.values():
        c.launches = 0
    eager = lane.predict(u8)
    torch.cuda.synchronize()
    launches = _counted(counters)
    want = {**dict.fromkeys(counters, 0), **{n: 2 * v for n, v in per_forward.items()}}
    check(launches == want, f"{label} mesh predict launches {launches} != {want}")
    with _CaptureLog(torch, counters) as log:
        lane.compile_serving([BATCH], input_dtype=torch.uint8)
    check([n for _, n in log.captures] == [per_forward] * 2,
          f"{label} mesh graph launches {[n for _, n in log.captures]}")
    out = lane.predict(u8)
    check(lane.replays == 1 and torch.equal(out, eager),
          f"{label}: the mesh replay differs from the eager sharded predict")
    print(f"mesh {label} lane: eager launches {_nonzero(launches)}, graph B={BATCH} "
          f"captures {[round(s, 3) for s, _ in log.captures]} s with "
          f"{[n for _, n in log.captures]}; replay bit-equal to the eager sharded predict")
    return {"eager": _nonzero(launches), "graph": [n for _, n in log.captures]}


def _nonzero(launches: dict) -> dict:
    return {n: v for n, v in launches.items() if v}


def _parallel_profiling(torch, vlm, u8, work: Path) -> dict:
    """(d): trace, debug_nans and StepTimer over the mesh VLM's eager
    predict (run first: no graph is captured in this process yet)."""
    from bayesvlm_tpu_torch.profiling import StepTimer, debug_nans, trace

    L = vlm.image_encoder.config.vision.num_layers
    vlm.predict(u8)
    with trace(str(work / "trace")):
        vlm.predict(u8)
    files = list((work / "trace").glob("*.json"))
    check(len(files) == 1, f"trace wrote {files}")
    events = json.loads(files[0].read_text())["traceEvents"]
    mma = sum("mha_mma_kernel" in str(e.get("name", "")) for e in events)
    print(f"profiling.trace over one mesh predict: {files[0].stat().st_size / 1e6:.1f} MB "
          f"Chrome trace, {len(events)} events, mha_mma_kernel {mma} (the predict "
          f"launches #1 {2 * L} times)")
    check(mma > 0, "the trace lists no mha_mma_kernel")
    try:
        with debug_nans():
            torch.log(torch.tensor(-1.0, device="cuda"))
        raised = False
    except FloatingPointError:
        raised = True
    check(raised, "debug_nans did not raise on log(-1)")
    with debug_nans():
        clean = vlm.predict(u8[:2])
    check(bool(torch.isfinite(clean).all()), "debug_nans: the predict went non-finite")
    timer = StepTimer()
    for _ in range(PAR_TIMER_STEPS):
        with timer.step() as s:
            s["result"] = vlm.predict(u8)
    summary = timer.summary(items_per_step=BATCH)
    check(summary["steps"] == PAR_TIMER_STEPS - timer.warmup, f"StepTimer {summary}")
    print(f"debug_nans: FloatingPointError on log(-1) on the card; a predict of 2 under "
          f"it clean. StepTimer over {PAR_TIMER_STEPS} mesh predicts (B={BATCH} uint8, "
          f"eager sharded, host clock, result synchronised; {DEVICE['card']}): {summary}")
    return {"trace_mha_mma_events": mma, "timer": summary}


def _parallel_mesh(torch, counters, vlm, u8, logp_tol: float, work: Path) -> dict:
    """(a): the serving mesh at full width: eager sharded predict, the
    uint8 ladder a replica, replays, the mesh-less predict, img/s against
    one replica, the BatchingServer, the saved serving state and the
    kernel lanes."""
    from bayesvlm_tpu_torch.pipeline import ProbabilisticVLM
    from bayesvlm_tpu_torch.serve import BatchingServer

    L = vlm.image_encoder.config.vision.num_layers
    out = {}
    reps = vlm._replicas()
    check(len(reps) == 2 and all(str(r.device) == "cuda:0" for r in reps)
          and reps[1].encoder.projection_weight().data_ptr()
          != reps[0].encoder.projection_weight().data_ptr(),
          "the mesh must hold two replicas of their own on cuda:0")
    eager = {}
    for b in PAR_LADDER:
        for c in counters.values():
            c.launches = 0
        eager[b] = vlm.predict(u8[:b])
        torch.cuda.synchronize()
        got = _nonzero(_counted(counters))
        check(got == {"attention": 2 * L}, f"mesh predict B={b} launches {got}")
        out.setdefault("eager", {})[b] = got
    single = ProbabilisticVLM(vlm.image_encoder, vlm.text_encoder, vlm.head, vlm.info,
                              transform=vlm.transform, mesh=None)
    single._label_features = vlm._label_features
    ref = single.predict(u8)
    logp = float((eager[BATCH].float().log() - ref.float().log()).abs().max())
    print(f"mesh {list(PAR_MESH)} eager sharded predict B={BATCH} uint8 vs the mesh-less "
          f"predict: max |log p| diff {logp:.3e} (tol {logp_tol:.3e}, phase 6's bf16-vs-"
          f"fp32); #1 launches {L} a replica a forward")
    check(logp <= logp_tol, "the mesh predict strays from the mesh-less predict")

    with _CaptureLog(torch, counters) as log:
        t0 = time.perf_counter()
        vlm.compile_serving(PAR_LADDER, input_dtype=torch.uint8)
        out["compile_s"] = time.perf_counter() - t0
    out["captures"] = [(round(s, 4), n) for s, n in log.captures]
    check([n for _, n in log.captures] == [{"attention": L}] * (2 * len(PAR_LADDER)),
          f"mesh ladder capture launches {out['captures']}")
    for b in PAR_LADDER:
        replays = vlm.replays
        got = vlm.predict(u8[:b])
        check(vlm.replays == replays + 1, f"mesh B={b}: predict did not replay")
        check(torch.equal(got, eager[b]), f"mesh B={b}: the replay differs from the eager "
                                           "sharded predict")
    single.compile_serving([BATCH], input_dtype=torch.uint8)
    times = {"mesh": _host_ms(torch, lambda: vlm.predict(u8), PAR_THROUGHPUT_CALLS),
             "one_replica": _host_ms(torch, lambda: single.predict(u8), PAR_THROUGHPUT_CALLS)}
    out["img_s"] = {n: BATCH * len(t) / sum(t) * 1e3 for n, t in times.items()}
    print(f"mesh ladder {PAR_LADDER} uint8: compile_serving {out['compile_s']:.2f} s, "
          f"captures (s, launches) {out['captures']}; each replay bit-equal to the eager "
          f"sharded predict. B={BATCH} img/s over {PAR_THROUGHPUT_CALLS} calls (host "
          f"clock, card synchronised; two replicas on one card: the logic, not the "
          f"scaling; {DEVICE['card']}): mesh {out['img_s']['mesh']:.1f}, one replica "
          f"{out['img_s']['one_replica']:.1f}")

    programs = dict(vlm._serving["programs"])
    with BatchingServer(vlm, batch_size=BATCH, buckets=PAR_LADDER, max_wait_ms=2.0,
                        input_dtype=torch.uint8) as srv:
        check(srv._buckets == PAR_LADDER, f"BatchingServer ladder {srv._buckets}")
        rows = np.stack([f.result(timeout=120) for f in
                         [srv.submit(u8[i]) for i in range(PAR_REQUESTS)]])
        stats = srv.stats()
    logp = _max_logp_diff(torch, rows, eager[BATCH][:PAR_REQUESTS])
    print(f"BatchingServer on the mesh: {PAR_REQUESTS} requests in {stats.batches} "
          f"batches, rows vs eager predict max |log p| diff {logp:.3e} (tol "
          f"{logp_tol:.3e}); the mesh ladder reused")
    check(logp <= logp_tol, "BatchingServer rows on the mesh stray")
    check(vlm._serving["programs"] == programs, "the BatchingServer captured again")

    path = vlm.save_serving(work / "mesh.aotserv")
    from bayesvlm_tpu_torch.pipeline import _read_serving_file

    layout = _read_serving_file(path)["mesh"]
    check(layout == {"axis": "data", "size": 2}, f"saved mesh layout {layout}")
    t0 = time.perf_counter()
    restored = ProbabilisticVLM.from_serving_cache(MODEL, path, dtype="bf16",
                                                   device="cuda", seed=SEED, mesh=PAR_MESH)
    out["restore_s"] = time.perf_counter() - t0
    check(torch.equal(restored.predict(u8), vlm.predict(u8)) and restored.replays == 1,
          "from_serving_cache on the mesh: its replay differs from the saved VLM's")
    del restored
    other = ProbabilisticVLM(vlm.image_encoder, vlm.text_encoder, vlm.head, vlm.info,
                             mesh=["cuda:0"] * 3)
    other._label_features = vlm._label_features
    try:
        other.load_serving(path)
        refused = ""
    except ValueError as exc:
        refused = str(exc)
    check(refused.startswith("AOT cache mesh mismatch"),
          f"a mesh of 3 took a file saved on a mesh of 2 ({refused!r})")
    print(f"save_serving -> from_serving_cache on the mesh: {out['restore_s']:.2f} s, "
          f"replay bit-equal; a mesh of 3 refused: {refused}")
    del other, single
    vlm._serving = None
    torch.cuda.empty_cache()
    out["lanes"] = {
        "int8": _mesh_lane(torch, counters, vlm, u8, "int8",
                           {"attention": L, "mlp_int8": L, "linear_int8": 2 * L},
                           mlp_int8=True, attn_int8=True),
        "block": _mesh_lane(torch, counters, vlm, u8, "block", {"attention_block": L},
                            attn_pallas_block=True)}
    return out


def _tp_worker(torch, spec: dict) -> dict:
    """(b), one of two gloo ranks on cuda:0: the clip-large vision tower
    unsplit, then split over the ("data", "model") = (1, 2) mesh, on the
    same seeded pixels."""
    from datetime import timedelta

    import torch.distributed as dist

    from bayesvlm_tpu_torch.dist.mesh import make_mesh
    from bayesvlm_tpu_torch.dist.tp import shard_tower_params
    from bayesvlm_tpu_torch.models import attention
    from bayesvlm_tpu_torch.models.encoders import load_model

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{spec['port']}",
                            world_size=2, rank=spec["rank"],
                            timeout=timedelta(seconds=PAR_TP_TIMEOUT_S))
    try:
        mesh = make_mesh(("data", "model"), (1, 2))
        img, _, _ = load_model(MODEL, dtype=torch.bfloat16, device=torch.device("cuda"),
                               seed=SEED)
        size = img.config.vision.image_size
        x = torch.from_numpy(np.random.default_rng(SEED + 6).normal(
            size=(PAR_TP_BATCH, size, size, 3)).astype(np.float32)).cuda()

        def forward_ms():
            times, res = [], None
            for _ in range(PAR_TP_CALLS + 1):
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                res = img(x)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return res, times[1:]

        ref, ref_ms = forward_ms()
        shard_tower_params(img.module, mesh)
        attention.fused_attention.launches = 0
        got = img(x)
        torch.cuda.synchronize()
        launches = attention.fused_attention.launches
        _, tp_ms = forward_ms()
        attn = img.module.encoder.layers[0].self_attn

        def cos_min(a, b):
            return float(torch.nn.functional.cosine_similarity(
                a.float(), b.float(), dim=-1).min())

        return {"rank": spec["rank"], "launches": launches, "heads": attn.num_heads,
                "q_rows": attn.q_proj.weight.shape[0],
                "embed_cos_min": cos_min(got.embeds, ref.embeds),
                "act_cos_min": cos_min(got.activations, ref.activations),
                "embed_max_rel": _rel_err(torch, got.embeds, ref.embeds),
                "act_max_rel": _rel_err(torch, got.activations, ref.activations),
                "unsplit_ms": ref_ms, "tp_ms": tp_ms}
    finally:
        dist.destroy_process_group()


def _parallel_tp(torch, work: Path) -> dict:
    """(b): tensor parallelism over two gloo ranks on the one card (child
    processes, as phase 12 starts them)."""
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME

    vcfg = CONFIGS_BY_NAME[MODEL].vision
    torch.cuda.empty_cache()  # the children allocate on the same card
    script = str(Path(__file__).resolve())
    port = _free_port()
    cmds, logs = [], []
    for rank in range(2):
        spec = {"port": port, "rank": rank, "out": str(work / f"tp{rank}.json")}
        (work / f"tp{rank}_spec.json").write_text(json.dumps(spec))
        cmds.append([sys.executable, script, "--dist-worker", "tp",
                     str(work / f"tp{rank}_spec.json")])
        logs.append(str(work / f"tp{rank}.log"))
    t0 = time.perf_counter()
    _run_children(cmds, [dict(os.environ)] * 2, logs, PAR_TP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    ranks = [json.loads((work / f"tp{r}.json").read_text()) for r in range(2)]
    for r in ranks:
        print(f"TP rank {r['rank']} of 2 (gloo, cuda:0; {MODEL} vision, B={PAR_TP_BATCH}, "
              f"bf16): #1 launches {r['launches']} with {r['heads']} heads, q_proj rows "
              f"{r['q_rows']}; vs the unsplit tower: embed cos min {r['embed_cos_min']:.6f}, "
              f"act cos min {r['act_cos_min']:.6f} (min {TP_COS_MIN}), max rel "
              f"{r['embed_max_rel']:.3e} / {r['act_max_rel']:.3e} (max {TP_MAX_REL}); "
              f"forward ms (host clock, "
              f"synchronised, {PAR_TP_CALLS} calls; {DEVICE['card']}): TP "
              f"{[round(t, 3) for t in r['tp_ms']]} unsplit "
              f"{[round(t, 3) for t in r['unsplit_ms']]}")
        check(r["launches"] == vcfg.num_layers, f"TP rank {r['rank']}: #1 launches "
                                                f"{r['launches']} != {vcfg.num_layers}")
        check(r["heads"] == vcfg.num_heads // 2 and r["q_rows"] == vcfg.hidden_size // 2,
              f"TP rank {r['rank']} is not split in two")
        check(min(r["embed_cos_min"], r["act_cos_min"]) >= TP_COS_MIN
              and max(r["embed_max_rel"], r["act_max_rel"]) <= TP_MAX_REL,
              f"TP rank {r['rank']} strays from the unsplit tower")
    print(f"TP children wall {wall:.1f} s")
    return {"ranks": ranks, "wall_s": wall}


def _parallel_dcp(torch, work: Path) -> dict:
    """(c): clip-large-sized factors .pt -> factors_dcp -> .pt bit for bit,
    then an async save of them from the card, waited on and read back."""
    from bayesvlm_tpu_torch.io import artifacts, dcp_ckpt
    from bayesvlm_tpu_torch.io.artifacts import save_synthetic_hessians
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME

    hdir = save_synthetic_hessians(work / "dcp_pt", CONFIGS_BY_NAME[MODEL], SEED)
    want = {tag: artifacts.load_hessians(hdir, tag) for tag in ("img", "txt")}
    out = {"mb": sum(F.numel() * 4 for pair in want.values() for F in pair) / 1e6}
    t0 = time.perf_counter()
    dcp_ckpt.hessians_to_dcp(hdir)
    out["to_dcp_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dcp_ckpt.dcp_to_hessians(hdir, work / "dcp_back")
    out["to_pt_s"] = time.perf_counter() - t0
    for tag, (A, B) in want.items():
        back = artifacts.load_hessians(work / "dcp_back", tag)
        lane = dcp_ckpt.load_hessians_dcp(hdir, tag)
        check(all(torch.equal(a, b) for a, b in zip((A, B), back))
              and all(torch.equal(a, b) for a, b in zip((A, B), lane)),
              f"DCP round trip of the {tag} factors is not bit-equal")
    tree = {f"{n}_{tag}": F.cuda() for tag, pair in want.items() for n, F in zip("AB", pair)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handle = dcp_ckpt.async_save_pytree(work / "dcp_async", tree)
    out["async_return_s"] = time.perf_counter() - t0
    handle.wait()
    out["async_total_s"] = time.perf_counter() - t0
    got = dcp_ckpt.load_pytree(work / "dcp_async")
    check(all(torch.equal(got[k], v.cpu()) for k, v in tree.items()),
          "the async save from the card read back differently")
    print(f"DCP lane ({MODEL} factors, {out['mb']:.1f} MB fp32): .pt -> factors_dcp "
          f"{out['to_dcp_s']:.3f} s, -> .pt {out['to_pt_s']:.3f} s, bit-equal; "
          f"async_save_pytree from the card returned in {out['async_return_s']:.3f} s, "
          f"done in {out['async_total_s']:.3f} s, read back bit-equal (host clock; "
          f"{DEVICE['card']})")
    return out


def _hf_clip_config(cfg) -> dict:
    """An HF snapshot's config.json for a CLIP model of `cfg`'s widths (what
    `transformers.CLIPModel.from_pretrained` reads beside the weights)."""
    v, t = cfg.vision, cfg.text
    return {"model_type": "clip", "architectures": ["CLIPModel"],
            "projection_dim": v.projection_dim,
            "vision_config": {"model_type": "clip_vision_model", "hidden_size": v.hidden_size,
                              "intermediate_size": v.mlp_dim,
                              "num_hidden_layers": v.num_layers,
                              "num_attention_heads": v.num_heads, "image_size": v.image_size,
                              "patch_size": v.patch_size, "hidden_act": v.hidden_act,
                              "layer_norm_eps": v.layer_norm_eps,
                              "projection_dim": v.projection_dim, "num_channels": 3},
            "text_config": {"model_type": "clip_text_model", "vocab_size": t.vocab_size,
                            "hidden_size": t.hidden_size, "intermediate_size": t.mlp_dim,
                            "num_hidden_layers": t.num_layers,
                            "num_attention_heads": t.num_heads,
                            "max_position_embeddings": t.max_length,
                            "hidden_act": t.hidden_act, "layer_norm_eps": t.layer_norm_eps,
                            "projection_dim": t.projection_dim,
                            "eos_token_id": t.eos_token_id, "bos_token_id": t.eos_token_id - 1,
                            "pad_token_id": 1}}


def _parallel_preflight(torch, counters, hessian_dir: str, work: Path) -> dict:
    """(e): the preflight on phase 8c's seeded clip-large snapshot (fp16
    safetensors under HF's names, with its config.json), synthetic data,
    with --skip_parity: its parity step, both models in fp32 on the CPU,
    is held by the CPU tests on tiny towers; at this width its elementwise
    tolerance is reached by fp32 summation order alone (preflight.py,
    `step_parity`)."""
    from bayesvlm_tpu_torch import preflight
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME
    from bayesvlm_tpu_torch.models.encoders import load_model
    from bayesvlm_tpu_torch.utils import get_image_size

    cfg = CONFIGS_BY_NAME[MODEL]
    img, txt, _ = load_model(MODEL, dtype=torch.float32, device=torch.device("cuda"),
                             seed=SEED)
    scale, bias = SNAPSHOT_HEAD[cfg.family]
    snap = work / "snapshot"
    snap.mkdir()
    write_safetensors_f16(snap / "model.safetensors", to_hf_state_dict(
        cfg.family, img.module.state_dict(), txt.module.state_dict(),
        cfg.vision.num_layers, cfg.text.num_layers, logit_scale=scale, logit_bias=bias))
    (snap / "config.json").write_text(json.dumps(_hf_clip_config(cfg)))
    del img, txt
    kw = dict(PAR_PREFLIGHT)
    overrides = {"image_size": get_image_size(MODEL), "num_test": kw.pop("num_test")}
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    summary = preflight.main(model_str=MODEL, snapshot=str(snap), hessian_dir=hessian_dir,
                             dtype="bf16", use_mesh=False, device="cuda", skip_parity=True,
                             dataset_overrides=overrides, **kw)
    seconds = time.perf_counter() - t0
    launches = _nonzero(_counted(counters))
    forwards = -(-overrides["num_test"] // kw["batch_size"])
    check(summary["parity"] is None, f"parity {summary['parity']}")
    check(0.0 <= summary["acc"] <= 1.0 and math.isfinite(summary["nlpd"])
          and math.isfinite(summary["ece"]), f"preflight summary {summary}")
    check(launches == {"attention": cfg.vision.num_layers * forwards},
          f"preflight launches {launches}")
    print(f"preflight on the seeded {MODEL} snapshot ({overrides['num_test']} synthetic "
          f"images; --skip_parity): {seconds:.1f} s, #1 launches {launches['attention']}, "
          f"summary {summary}")
    return {"seconds": seconds, "launches": launches, "summary": summary}


def phase_parallel(torch, counters, hessian_dir: str, prompts, logp_tol: float) -> dict:
    """13: (d) profiling, (a) the serving mesh, (b) tensor parallelism, (c)
    the DCP lane, (e) the preflight (module docstring)."""
    from bayesvlm_tpu_torch import kernels
    from bayesvlm_tpu_torch.pipeline import ProbabilisticVLM
    from bayesvlm_tpu_torch.utils import get_image_size

    size = get_image_size(MODEL)
    u8 = np.random.default_rng(SEED + 5).integers(0, 256, (BATCH, size, size, 3),
                                                  dtype=np.uint8)
    out, seconds = {}, {}
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as work:
        work = Path(work)
        t0 = time.perf_counter()
        vlm = ProbabilisticVLM.from_pretrained(
            MODEL, hessian_dir, dtype="bf16", device="cuda", seed=SEED,
            prior_num_steps=PAR_PRIOR_STEPS, mesh=list(PAR_MESH)).set_class_prompts(prompts)
        seconds["build"] = time.perf_counter() - t0
        for name, fn, args in (
                ("profiling", _parallel_profiling, (torch, vlm, u8, work)),
                ("mesh", _parallel_mesh, (torch, counters, vlm, u8, logp_tol, work))):
            t0 = time.perf_counter()
            out[name] = fn(*args)
            seconds[name] = time.perf_counter() - t0
        del vlm
        torch.cuda.empty_cache()
        for name, fn, args in (
                ("tp", _parallel_tp, (torch, work)),
                ("dcp", _parallel_dcp, (torch, work)),
                ("preflight", _parallel_preflight, (torch, counters, hessian_dir, work))):
            t0 = time.perf_counter()
            out[name] = fn(*args)
            seconds[name] = time.perf_counter() - t0
    out["seconds"] = seconds
    print(f"parallel phase parts (s): { {k: round(v, 2) for k, v in seconds.items()} }")
    return out


MESH_CARDS_CALLS, MESH_CARDS_ROUNDS = 20, 3


def mesh_cards() -> int:
    """`chip_smoke.py --mesh-cards` (a host of more than one card; not in
    the default run): the serving mesh over every visible card
    (`mesh="auto"`). tiny-clip fp32: each ladder size's replay equal to
    the eager sharded predict and to each card's row block, bit for bit;
    clip-large bf16 at B=64 uint8: the replay equal to the eager sharded
    predict, the eager sharded predict against one card's, and the graph's
    img/s on the mesh against one card's, in turns (host clock, the cards
    synchronised)."""
    import torch

    phase_device(torch)
    from bayesvlm_tpu_torch import kernels
    from bayesvlm_tpu_torch.data import native_io
    from bayesvlm_tpu_torch.io.artifacts import save_synthetic_hessians
    from bayesvlm_tpu_torch.models import attention
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME, TINY_CLIP_CONFIG
    from bayesvlm_tpu_torch.pipeline import ProbabilisticVLM

    n = torch.cuda.device_count()
    check(n > 1, f"--mesh-cards needs more than one card, found {n}")
    phase_build(kernels, (attention,))
    prompts = [f"a photo of a thing of class {i}" for i in range(NUM_PROMPTS)]
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as work:
        hdir = save_synthetic_hessians(Path(work) / "tiny", TINY_CLIP_CONFIG, SEED)
        vlm = ProbabilisticVLM.from_pretrained("tiny-clip", str(hdir), dtype="fp32",
                                               prior_num_steps=20, device="cuda")
        vlm.set_class_prompts(prompts[:4])
        reps = vlm._replicas()
        check([r.device.index for r in reps] == list(range(n)), f"mesh {vlm.mesh}")
        u8 = np.random.default_rng(SEED + 7).integers(0, 256, (2 * n, 32, 32, 3),
                                                      dtype=np.uint8)
        eager = {b: vlm.predict(u8[:b]) for b in (n, 2 * n)}
        vlm.compile_serving([n, 2 * n], input_dtype=torch.uint8)
        for b in (n, 2 * n):
            rows = b // n
            blocks = torch.cat([vlm._serve_forward(
                torch.as_tensor(u8[i * rows:(i + 1) * rows]).to(r.device), r).to(reps[0].device)
                for i, r in enumerate(reps)])
            out = vlm.predict(u8[:b])
            check(torch.equal(out, eager[b]) and torch.equal(out, blocks),
                  f"tiny-clip B={b}: the mesh replay differs")
        print(f"tiny-clip on {vlm.mesh}: each replay bit-equal to the eager sharded "
              f"predict and to each card's row block")
        del vlm
        hdir = save_synthetic_hessians(Path(work) / "large", CONFIGS_BY_NAME[MODEL], SEED)
        vlm = ProbabilisticVLM.from_pretrained(MODEL, str(hdir), dtype="bf16", device="cuda",
                                               seed=SEED, prior_num_steps=PAR_PRIOR_STEPS)
        vlm.set_class_prompts(prompts)
        one = ProbabilisticVLM(vlm.image_encoder, vlm.text_encoder, vlm.head, vlm.info,
                               mesh=None)
        one._label_features = vlm._label_features
        size = vlm.image_encoder.config.vision.image_size
        x = np.random.default_rng(SEED + 5).integers(0, 256, (BATCH, size, size, 3),
                                                     dtype=np.uint8)
        eager, ref = vlm.predict(x), one.predict(x)
        logp = float((eager.float().log() - ref.float().log()).abs().max())
        vlm.compile_serving([BATCH], input_dtype=torch.uint8)
        one.compile_serving([BATCH], input_dtype=torch.uint8)
        check(torch.equal(vlm.predict(x), eager), f"{MODEL}: the mesh replay differs")
        print(f"{MODEL} bf16 on {n} cards: replay bit-equal to the eager sharded "
              f"predict; eager sharded vs one card max |log p| {logp:.3e}")
        for rnd in range(MESH_CARDS_ROUNDS):
            t = {name: _host_ms(torch, lambda v=v: v.predict(x), MESH_CARDS_CALLS)
                 for name, v in (("mesh", vlm), ("one card", one))}
            print(f"round {rnd}: B={BATCH} uint8 graph img/s ({MESH_CARDS_CALLS} calls, host "
                  f"clock, synchronised; {DEVICE['card']} x{n}): " + ", ".join(
                      f"{name} {BATCH * len(v) / sum(v) * 1e3:.1f} (median "
                      f"{_pct(v, 0.5):.3f} ms)" for name, v in t.items()))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": n}}))
    return 0


def _probe_entries(probe_path: dict, parts: dict) -> list:
    """Each probe kernel's line, from its probe's numbers; the GEMMs that
    the sweep also runs carry its tiles, the s4 kinds and the packed-head
    kernels their launches timed apart (`parts_ms`)."""
    results = probe_path["results"]
    swept = results["bench_int8_sweep"]["kernels"]
    entries = []
    for name, (probe, source, replaces) in PROBE_KERNELS.items():
        r = results[probe]["kernels"][name]
        e = _entry(name, f"bayesvlm_tpu_torch/csrc/{source}", f"scripts/dev/{replaces}",
                   probe_path["launches"][name], r, r["library_ms"])
        e.update((k, r[k]) for k in PROBE_EXTRAS if k in r)
        if name in swept:
            e.update(swept[name], also_replaces="scripts/dev/bench_int8_sweep.py:53")
        if name in parts:
            e["parts_ms"] = parts[name]
        entries.append(e)
    return entries


def _entry(name, source, replaces, launches, r, library_ms):
    """A kernel's entry of the kernels line: its times, error, bound and
    launches, and the body it launched (the attention kernel's from
    kernel_resources and the attention probes' from block_resources, with
    their shared memory, registers and blocks an SM; the other sources'
    from SOURCE_BODY)."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    e = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches, **{k: r[k] for k in keys},
         "library_ms": library_ms,
         "body": r.get("body") or SOURCE_BODY[source.rsplit("/", 1)[-1]]}
    e.update((k, r[k]) for k in ("smem_bytes", "registers", "blocks_per_sm", "local_bytes")
             if k in r)
    return e


def _timed(label: str, fn, *args, **kwargs):
    """Run one phase and print its wall seconds (host clock)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    print(f"[phase {label}] {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    import torch

    kind = phase_device(torch)
    from bayesvlm_tpu_torch import kernels
    from bayesvlm_tpu_torch.data import native_io
    from bayesvlm_tpu_torch.io.artifacts import save_synthetic_hessians
    from bayesvlm_tpu_torch.models import attention, linear_int8, mlp_int8
    from bayesvlm_tpu_torch.models.configs import (
        CONFIGS_BY_NAME,
        TINY_CLIP_CONFIG,
        TINY_SIGLIP_CONFIG,
    )
    from bayesvlm_tpu_torch.probes import attention_variants as av
    from bayesvlm_tpu_torch.probes import packed_heads as ph
    from bayesvlm_tpu_torch.probes import tile_gemm as tg
    from bayesvlm_tpu_torch.probforward import kernels as smith_head
    from bayesvlm_tpu_torch.select import epig_joint
    from bayesvlm_tpu_torch.utils import get_image_size

    _timed("build", phase_build, kernels, (attention, av, ph, tg, mlp_int8, linear_int8,
                                            epig_joint, smith_head))
    attention._block_library()
    fa = attention.fused_attention
    counters = {"attention": fa,
                "attention_split": _Count(fa, "launches_split"),
                "attention_packed": _Count(fa, "launches_packed"),
                "attention_block": attention.fused_attention_block,
                "mlp_int8": mlp_int8.mlp_int8,
                "linear_int8": linear_int8.linear_int8,
                "smith_head": smith_head.fused_probit_probs,
                "attention_v2": av.attention_v2,
                "attention_v3": _Count(av.attention_v2, "launches_v3"),
                "attention_v4": av.attention_v4,
                "attention_group_heads": av.attention_group_heads,
                "attention_group_rows": av.attention_group_rows,
                "qk_scores": ph.qk_scores,
                "qk_scores_packed": _Count(ph.qk_scores, "launches_packed"),
                "pv": ph.pv,
                "pv_packed": _Count(ph.pv, "launches_packed"),
                "tile_gemm_bf16": tg.matmul,
                "tile_gemm_s8": _Count(tg.matmul, "launches_s8"),
                "tile_gemm_s4": tg.matmul_s4,
                "tile_gemm_s8s4": _Count(tg.matmul_s4, "launches_s8s4")}
    attn = _timed("attention_vs_plain", phase_attention_vs_plain, torch, attention)
    pair_designs = _timed("packed_pair_designs", phase_packed_pair_designs, torch,
                          attention, av)
    sched_launches = _timed("schedule_paths", phase_schedule_paths, torch, attention,
                            counters)
    block = _timed("block_vs_plain", phase_block_vs_plain, torch, attention)
    int8 = _timed("int8_vs_plain", phase_int8_vs_plain, torch, mlp_int8, linear_int8)
    smith = _timed("smith_vs_plain", phase_smith_vs_plain, torch, smith_head)

    all_counters = {
        **counters,
        "xlogy_rowsum": _Count(epig_joint.joint_xlogy_rowsums, "launches"),
        "xlogy_rowsum_int8": _Count(epig_joint.joint_xlogy_rowsums, "launches_int8"),
        "ycc_to_rgb": native_io.ycc_to_rgb,
        "resize_crop": native_io.resize_crop,
    }
    epig = _timed("epig_vs_plain", phase_epig_vs_plain, torch, epig_joint, all_counters)
    # the probes (10, 10b) run before the paths: 10b reads torch.profiler
    # sessions, which lose their kernel records in a process that has run
    # the later phases' graph captures, child processes and training steps
    _timed("probes_vs_plain", phase_probes_vs_plain, torch, attention, av)
    packed_parts = _timed("packed_heads_vs_plain", phase_packed_heads_vs_plain, torch,
                          ph)
    gemm_parts = _timed("gemm_vs_plain", phase_gemm_vs_plain, torch, tg)
    probe_path = _timed("probes", phase_probes, torch, all_counters)
    size = get_image_size(MODEL)
    prompts = [f"a photo of a thing of class {i}" for i in range(NUM_PROMPTS)]
    pixels = np.random.default_rng(SEED + 1).normal(
        size=(BATCH, size, size, 3)).astype(np.float32)
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as big, \
            tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as zs, \
            tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tiny, \
            tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tiny_siglip:
        hdir = save_synthetic_hessians(big, CONFIGS_BY_NAME[MODEL], SEED)
        (bf16_vlm, bf16_launches, bf16_img_s, bf16_embeds, bf16_probs,
         bf16_logp_diff) = _timed("main_path", phase_main_path, torch, counters, hdir,
                                  pixels, prompts)
        # 13 runs here, before any graph capture or child process of this
        # process: its trace reads torch.profiler's kernel records
        parallel = _timed("parallel", phase_parallel, torch, counters, str(hdir), prompts,
                          bf16_logp_diff)
        serving = _timed("serving", phase_serving, torch, counters, bf16_vlm, prompts,
                         bf16_logp_diff)
        del bf16_vlm
        int8_launches, _, int8_graph = _timed(
            "int8_path", phase_int8_path, torch, counters, hdir, pixels, prompts,
            bf16_embeds, bf16_probs, bf16_img_s)
        block_launches, _, block_graph = _timed(
            "block_path", phase_block_path, torch, counters, hdir, pixels, prompts,
            bf16_embeds, bf16_probs, bf16_img_s)
        stage1 = _timed("stage1", phase_stage1, torch, all_counters, pixels, prompts)
        native = _timed("native_decode", phase_native_decode, torch, all_counters,
                        S1_PAIRS / stage1["seconds"]["img features"])
        _timed("ggn", phase_ggn, torch)
        epig_path = _timed("epig_path", phase_epig_path, torch, all_counters, hdir)
        al_path = _timed("active_learning", phase_active_learning, torch, all_counters,
                         hdir)
        backbone = _timed("backbone", phase_backbone, torch, all_counters)
        zs_hdir = str(save_synthetic_hessians(zs, CONFIGS_BY_NAME[ZS_MODEL], SEED))
        zs_path = _timed("zeroshot", phase_zeroshot, torch, all_counters, zs_hdir)
        snapshots = _timed("snapshot", phase_snapshot, torch, all_counters,
                           {MODEL: hdir, ZS_MODEL: zs_hdir}, prompts)
        _timed("tiny_reference", phase_tiny_reference, torch, attention,
               str(save_synthetic_hessians(tiny, TINY_CLIP_CONFIG, SEED)))
        _timed("tiny_reference", phase_tiny_reference, torch, attention,
               str(save_synthetic_hessians(tiny_siglip, TINY_SIGLIP_CONFIG, SEED)),
               "tiny-siglip", ("default",))
    # 6c runs last: after its ladder captures and child processes, the
    # torch.profiler sessions of this process lose kernel records, and 6c
    # reads none
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as multi_dir:
        multi_hdirs = {m: save_synthetic_hessians(Path(multi_dir) / m, CONFIGS_BY_NAME[m],
                                                  SEED) for m in (MODEL, ZS_MODEL)}
        multi = _timed("multiserve", phase_multiserve, torch, counters, multi_hdirs,
                       Path(multi_dir), bf16_logp_diff)
    # 12 runs after 6c: its child processes leave nothing in this process
    dist_path = _timed("dist", phase_dist, torch, al_path["main"])

    qkv, out_proj = int8["linear_int8 qkv"], int8["linear_int8 out_proj"]
    linear_entry = _entry(
        "linear_int8", "bayesvlm_tpu_torch/csrc/linear_int8.cu",
        "bayesvlm_tpu/models/linear_int8.py:53", int8_launches["linear_int8"],
        qkv, None)
    # the row above is the fused QKV shape; the out-projection's numbers
    linear_entry["out_proj"] = {k: out_proj[k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "parts_ms")}
    linear_entry["parts_ms"] = qkv["parts_ms"]
    linear_entry["graph_launches"] = {BATCH: int8_graph["linear_int8"]}
    linear_entry["mesh_launches"] = {
        k: [n["linear_int8"] for n in v] if k == "graph" else v["linear_int8"]
        for k, v in parallel["mesh"]["lanes"]["int8"].items()}
    fused = int8["mlp_int8 fused-LN"]
    mlp_entry = _entry("mlp_int8", "bayesvlm_tpu_torch/csrc/mlp_int8.cu",
                       "bayesvlm_tpu/models/mlp_int8.py:101",
                       int8_launches["mlp_int8"], fused, None)
    mlp_entry["yardsticks"] = int8["mlp_int8 yardsticks"]
    mlp_entry.update(registers_gemm=fused["registers_gemm"], parts_ms=fused["parts_ms"],
                     graph_launches={BATCH: int8_graph["mlp_int8"]},
                     mesh_launches={k: [n["mlp_int8"] for n in v] if k == "graph"
                                    else v["mlp_int8"]
                                    for k, v in parallel["mesh"]["lanes"]["int8"].items()})
    split, packed = attn[("vit-l/14", "bf16", "split_key")], attn[
        ("vit-l/14", "bf16", "packed_heads")]
    # #1's row is the main path's shape (ViT-L/14, bf16); its other bf16
    # shapes beside it
    one_block = _entry("fused_attention", "bayesvlm_tpu_torch/csrc/attention.cu",
                       "bayesvlm_tpu/models/attention_pallas.py:199",
                       bf16_launches["attention"], attn[("vit-l/14", "bf16")],
                       attn[("vit-l/14", "bf16")]["library_ms"])
    shape_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                  "body", "smem_bytes", "registers", "blocks_per_sm")
    one_block["shapes"] = {shape: {k: attn[(shape, "bf16")][k] for k in shape_keys}
                           for shape in ("siglip-l/16", "vit-b/32", "vit-l/14-336")}
    # its launches in the Stage-1 CLI's feature pass
    one_block["stage1_launches"] = stage1["launches"]["attention"]
    # and in the active-learning CLI's feature pass (phase 8d), the EGL
    # CLI's (its own) and the LLM CLI's (from the cache)
    one_block["al_launches"] = al_path["main"]["launches"]["attention"]
    one_block["al_elg_launches"] = al_path["elg"]["launches"]["attention"]
    one_block["al_llm_launches"] = al_path["llm"]["launches"]["attention"]
    # and in a backbone step (phase 8e): each forward, and each step with
    # remat (the trained blocks recomputed in the backward)
    one_block["backbone_launches"] = {"forward": backbone["launches_forward"],
                                      "remat_step": backbone["launches_remat_step"]}
    # and in one predict of each HF snapshot (phase 8c)
    one_block["snapshot_launches"] = {m: r["launches"]["attention"]
                                      for m, r in snapshots.items()}
    # and in each captured serving program (counted at capture): the bf16
    # ladder's sizes, and B=64 of the int8 lane
    one_block["graph_launches"] = {b: n["attention"]
                                   for b, n in serving["graph_launches"].items()}
    one_block["graph_launches_int8"] = {BATCH: int8_graph["attention"]}
    # and in each ladder of the two resident models (phase 6c), counted at
    # capture
    one_block["multi_graph_launches"] = multi["graph_launches"]
    # and in each rank of the two-rank run (phase 12b): this script's own
    # feature pass that writes the Stage-1 CLI's per-host caches
    # (compute_features with the CLI's host tags over the rank's batch
    # stripe; the CLI's shard_for_host pass reads LAION tars, which the
    # card's machine cannot decode), and the activelearning CLI's own
    # striped feature pass
    dist_b = dist_path["b"]["launches"]
    one_block["dist_launches"] = {
        f"rank{r}": {"smoke_feature_pass": n["smoke_feature_pass"],
                     "al": n["al_attention"]}
        for r, n in dist_b.items()}
    # and in phase 13: the serving mesh (an eager sharded predict, both
    # replicas together, and each ladder size's graph a replica, counted at
    # capture), each TP rank's forward on its H/2 heads, and the
    # preflight's zero-shot run
    mesh = parallel["mesh"]
    one_block["parallel_launches"] = {
        # both replicas' launches in one eager sharded predict, by batch size
        "mesh_eager_per_predict": {str(b): n["attention"] for b, n in mesh["eager"].items()},
        "mesh_graph_captures": [n.get("attention", 0) for _, n in mesh["captures"]],
        "mesh_int8_graph_captures": [n["attention"] for n in mesh["lanes"]["int8"]["graph"]],
        "tp_ranks": [r["launches"] for r in parallel["tp"]["ranks"]],
        "preflight": parallel["preflight"]["launches"]["attention"]}
    print(json.dumps({"kernels": [
        one_block,
        _entry("fused_attention_split", "bayesvlm_tpu_torch/csrc/attention.cu",
               "bayesvlm_tpu/models/attention_pallas.py:53",
               sched_launches["attention_split"], split, split["library_ms"]),
        # beside it: #1 in the same phase, and the in-turn design timed in
        # turns with the shipped one and #1
        dict(_entry("fused_attention_packed", "bayesvlm_tpu_torch/csrc/attention.cu",
                    "bayesvlm_tpu/models/attention_pallas.py:132",
                    sched_launches["attention_packed"], packed, packed["library_ms"]),
             base_ms=attn[("vit-l/14", "bf16")]["ms"], designs_ms=pair_designs,
             shapes={shape: {k: attn[(shape, "bf16", "packed_heads")][k]
                             for k in shape_keys}
                     for shape in ("vit-b/32", "vit-l/14-336", "t1024")}),
        dict(_entry("fused_attention_block", "bayesvlm_tpu_torch/csrc/attention_block.cu",
                    "bayesvlm_tpu/models/attention_pallas.py:225",
                    block_launches["attention_block"], block["bf16"], None),
             chain_ms=block["bf16"]["chain_ms"], core=block["bf16"]["core"],
             gemms=block["bf16"]["gemms"], parts_ms=block["bf16"]["parts_ms"],
             projections_ms=block["bf16"]["projections_ms"],
             graph_launches={BATCH: block_graph["attention_block"]},
             mesh_launches=parallel["mesh"]["lanes"]["block"]),
        mlp_entry,
        linear_entry,
        dict(_entry("xlogy_rowsum", "bayesvlm_tpu_torch/csrc/xlogy_rowsum.cu",
                    "bayesvlm_tpu/select/epig_pallas.py:43",
                    epig_path["launches"]["xlogy_rowsum"], epig["bf16"], None),
             cublas_bf16_ms=epig["bf16"]["cublas_bf16_ms"],
             al_launches={k: al_path[k]["launches"]["xlogy_rowsum"]
                          for k in ("main", "kmeans", "elg", "llm")},
             # phase 12: (a) epig_from_probs_sharded over NCCL at world 1;
             # (b) each rank's rows in select_epig_online and in the
             # activelearning CLI's epig_knn
             dist_launches={"nccl_world1": dist_path["a"]["epig"]["launches"]["xlogy_rowsum"],
                            **{f"rank{r}": {"epig_online": n["epig_xlogy"],
                                            "al": n["al_xlogy"]}
                               for r, n in dist_b.items()}},
             **{f"k{EPIG_LONG_K}": epig["bf16"][f"k{EPIG_LONG_K}"]}),
        dict(_entry("xlogy_rowsum_int8", "bayesvlm_tpu_torch/csrc/xlogy_rowsum.cu",
                    "bayesvlm_tpu/select/epig_pallas.py:77", epig["int8"]["launches"],
                    epig["int8"], None),
             **{f"k{EPIG_LONG_K}": epig["int8"][f"k{EPIG_LONG_K}"]}),
        # the row is the zero-shot run's shape (B=2048, C=100, D=1024); the
        # other shapes beside it
        dict(_entry("smith_head", "bayesvlm_tpu_torch/csrc/smith_head.cu",
                    "bayesvlm_tpu/probforward/kernels/smith_pallas.py:40",
                    zs_path["launches"]["smith_head"], zs_path["head"], None),
             cli_chain_ms=zs_path["head"]["cli_chain_ms"],
             sigma_ms=zs_path["head"]["sigma_ms"],
             fp32_bound_ms=zs_path["head"]["fp32_bound_ms"],
             shapes={label: {k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                               "bound_ms", "bound_by", "fp32_bound_ms",
                                               "registers", "smem_bytes", "local_bytes",
                                               "cluster")}
                     for label, r in smith.items()}),
        # no pallas_call behind these two: libjpeg's colour stage and host
        # C++ in JAX (process_one); the rows are the native Stage-1 run's,
        # resize_crop's its uint8 lane, fp32 beside it
        dict(_entry("ycc_to_rgb", "bayesvlm_tpu_torch/csrc/jpeg_decode.cu",
                    "native/bvt_io.cc:171", native["cli"]["launches"]["ycc_to_rgb"],
                    native["colour"], None),
             replaces_kind="libjpeg's colour stage inside jpeg_read_scanlines "
                           "(no pallas_call)",
             wrapper_ms=native["colour"]["wrapper_ms"],
             src_bytes=native["colour"]["src_bytes"],
             rgb_img_s=native["cli"]["rgb_img_s"]),
        dict(_entry("resize_crop", "bayesvlm_tpu_torch/csrc/jpeg_decode.cu",
                    "native/bvt_io.cc:196", native["cli"]["launches"]["resize_crop"],
                    native["kernel"]["u8"], native["kernel"]["u8"]["library_ms"]),
             replaces_kind="host C++ process_one (no pallas_call)",
             # ms: the kernel alone (a CUDA graph's replay); wrapper_ms: a
             # call, its metadata copy and output allocation included
             wrapper_ms=native["kernel"]["u8"]["wrapper_ms"],
             src_bytes=native["kernel"]["u8"]["src_bytes"],
             fp32={k: native["kernel"]["fp32"][k] for k in (
                 "max_abs_err", "ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by")},
             nvjpeg_img_s=native["cli"]["nvjpeg_img_s"],
             stage1_img_s=native["cli"]["img_s"], embed_cos_min=native["cos_min"]),
        *_probe_entries(probe_path, {**gemm_parts, **packed_parts}),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--dist-worker":
        sys.exit(dist_worker(sys.argv[2], sys.argv[3]))
    if sys.argv[1:] == ["--mesh-cards"]:
        sys.exit(mesh_cards())
    sys.exit(main())
